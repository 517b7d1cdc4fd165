"""ADMM options, state, adaptive rho and the generic driver (counterpart
of ``sporco_tpu.solvers.admm``).

The loop runs on the device, as the JAX package's ``lax.while_loop``
does (:mod:`sporco_tpu_torch.ops.device_loop`): X, Y and U, the scalars
of the state (rho, the residuals and tolerances, k and k0, 0-d tensors
of the problem's real type, ``float32`` or ``float64`` for a float64 or
complex128 problem) and the float32 stats rows stay on the solve's
device, and the host reads the stopping flag once a block of iterations
and the final state once.  The scalar arithmetic (``rsf_t``,
``norm_residuals_t``, ``sqrt_t``) is the JAX package's in its order,
correctly rounded, so that the AutoRho decisions and the stopping test
match it; the host forms (``_rsf``, ``norm_residuals``) stay as the
tests' oracle.  On the card one iteration is a CUDA graph, replayed; a
problem whose iteration synchronises with the host declares
``route="eager"`` and runs the same blocks without a graph: only
``PPP`` with a ``host_prior`` does (Robust PCA's SVD, ``ops/svd.py``,
reads nothing on the host).  The
returned :class:`ADMMState` holds host scalars and a numpy ``stats``
from the one final read.

X, Y and U are each a tensor or a tuple of tensors (a problem with more
than one constraint block, such as ``MinL1InL2Ball``): the driver's
arithmetic maps over the tuple's entries, as the JAX package's tree
helpers do, and its norms sum over them.
"""

import math
from dataclasses import dataclass, field, replace
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sporco_tpu_torch._device import fp32_precision
from sporco_tpu_torch.ops import device_loop
from sporco_tpu_torch.ops import fft as sf
from sporco_tpu_torch.ops import fft2_planar

__all__ = ["AutoRhoOpts", "ADMMOpts", "ADMMProblem", "ADMMState",
           "IterStats", "admm_solve", "init_state", "iterstats",
           "stat_names", "tree_norm"]

f32 = np.float32


@dataclass(frozen=True)
class AutoRhoOpts:
    """Adaptive-rho policy options (same fields and defaults as the JAX
    package)."""
    enabled: bool = False
    period: int = 10
    scaling: float = 2.0        # tau (max multiplier if auto_scaling)
    rsdl_ratio: float = 10.0    # mu
    rsdl_target: Optional[float] = None   # xi; None -> model default
    auto_scaling: bool = False
    std_residuals: bool = False


@dataclass(frozen=True)
class ADMMOpts:
    """Generic ADMM options (same fields and defaults as the JAX
    package)."""
    max_iter: int = 1000
    abs_stop_tol: float = 0.0
    rel_stop_tol: float = 1e-3
    relax_param: float = 1.0
    rho: Optional[float] = None
    auto_rho: AutoRhoOpts = field(default_factory=AutoRhoOpts)
    fast_solve: bool = False
    verbose: bool = False
    dtype: Any = torch.float32

    def replace(self, **kw):
        return replace(self, **kw)


class ADMMState(NamedTuple):
    """Full ADMM solver state.  ``X``/``Y``/``U`` are tensors (or tuples
    of tensors) on the solve's device; the rest are host scalars and the
    host stats buffer of shape ``(max_iter, nstat)`` (inside the device
    loop the problem's functions see 0-d tensors for the scalars)."""
    X: Any
    Y: Any
    U: Any
    rho: np.float32
    rho_xi: np.float32
    k: np.int32
    r: np.float32
    s: np.float32
    epri: np.float32
    edua: np.float32
    stats: np.ndarray
    extra: Any = ()


def stat_names(obj_names):
    """Column names of the stats buffer for objective terms
    ``obj_names``."""
    return (("Iter",) + tuple(obj_names)
            + ("PrimalRsdl", "DualRsdl", "EPrimal", "EDual", "Rho"))


def scalar_type(dtype):
    """The numpy type of the host scalars of a problem of ``dtype``:
    float64 for float64 and complex128, else float32."""
    return np.float64 if dtype in (torch.float64, torch.complex128) \
        else np.float32


def _rsf(ar, k, r, s, xi, ft=f32):
    """The AutoRho scale factor (``sporco/admm/admm.py:549-575``), in
    the scalar type ``ft``."""
    if not ar.enabled:
        return ft(1.0)
    tau = ft(ar.scaling)
    mu = ft(ar.rsdl_ratio)
    on_period = bool(k != 0 and (int(k) + 1) % ar.period == 0)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        if ar.auto_scaling:
            sxi = s * xi
            ratio = r / sxi if r > sxi else sxi / r
            rhomlt = np.minimum(np.sqrt(ratio), tau)
            if s == 0.0 or r == 0.0:
                rhomlt = tau
        else:
            rhomlt = tau
        if r > xi * mu * s:
            rsf = rhomlt
        elif s > (mu / xi) * r:
            rsf = ft(1.0) / rhomlt
        else:
            rsf = ft(1.0)
    return ft(rsf) if on_period else ft(1.0)


def _update_rho(ar, k, r, s, rho, xi, U):
    """Adaptive rho: returns the new rho and ``U / rsf`` for a float32
    scalar ``U`` (the fused driver defers the dual rescale to its factor
    ``us``)."""
    if not ar.enabled:
        return rho, U
    rsf = _rsf(ar, k, r, s, xi)
    return f32(rho * rsf), f32(U / rsf)


def norm_residuals(ar, opts, nc, nx, rnrm, snrm, rn, sn, ft=f32):
    """Normalised (or standard) residuals and their tolerances
    (``sporco/admm/admm.py:462-486``), in the scalar type ``ft``."""
    atol_c = ft(nc * opts.abs_stop_tol)
    atol_x = ft(nx * opts.abs_stop_tol)
    rtol = ft(opts.rel_stop_tol)
    with np.errstate(divide="ignore", invalid="ignore"):
        if ar.std_residuals:
            return (rnrm, snrm, atol_c + rn * rtol, atol_x + sn * rtol)
        rn_ = ft(1.0) if rn == 0.0 else rn
        sn_ = ft(1.0) if sn == 0.0 else sn
        return (rnrm / rn_, snrm / sn_, atol_c / rn_ + rtol,
                atol_x / sn_ + rtol)


# ---------------------------------------------------------------------------
# The same scalar arithmetic on 0-d tensors of the problem's real type
# (float32 or float64), for the on-device loops (``ops/device_loop.py``):
# the JAX package's operations in its order, ``torch.where`` in place of
# the branches, so a stats row computed on the device equals the one the
# host forms above compute.  Constants are numbers of that type, and a
# number is never divided by a tensor (torch computes ``number / t`` as
# ``reciprocal(t) * number``, two roundings).

def _num(x, dtype):
    """The number ``x`` rounded to the real type ``dtype``."""
    return float(f32(x)) if dtype == torch.float32 else float(x)


def _sqrt64_cpu(x):
    """The correctly rounded square root of a float64 CPU tensor.

    torch's CPU square root is faithful, not correctly rounded (about
    one float64 input in 150 parts from numpy's).  Of its result and the
    two neighbours the one whose exact residual ``x - c*c`` is least in
    magnitude is the correctly rounded root (no float64 ``x`` lies
    between the square of a midpoint and that plus a quarter of the
    neighbours' spacing squared).  The residual is exact: ``c*c = p + e``
    by Veltkamp's split (Dekker's product), ``x - p`` by Sterbenz, and
    the remainder of a faithful root is a float64.  Inputs outside
    [2**-900, 2**900] are scaled by an even power of two first, so
    that no product of the split overflows or leaves the normal range.
    Zero, inf, nan and negative inputs take ``torch.sqrt`` as it is."""
    one = torch.ones_like(x)
    big, small = x > 2.0 ** 900, x < 2.0 ** -900
    xs = x * torch.where(big, one * 2.0 ** -600,
                         torch.where(small, one * 2.0 ** 600, one))
    y = torch.sqrt(xs)
    inf = torch.full_like(y, math.inf)

    def resid(c):
        p = c * c
        t = c * 134217729.0             # 2**27 + 1
        ch = t - (t - c)
        cl = c - ch
        e = ((ch * ch - p) + 2.0 * ch * cl) + cl * cl
        return ((xs - p) - e).abs()

    best, rb = y, resid(y)
    for c in (torch.nextafter(y, -inf), torch.nextafter(y, inf)):
        rc = resid(c)
        take = rc < rb
        best = torch.where(take, c, best)
        rb = torch.where(take, rc, rb)
    out = best * torch.where(big, one * 2.0 ** 300,
                             torch.where(small, one * 2.0 ** -300, one))
    return torch.where((x > 0) & torch.isfinite(x), out, torch.sqrt(x))


def sqrt_t(x):
    """The correctly rounded square root of a float32 or float64 tensor:
    CUDA's is; on the CPU float32 goes through float64 (the root of a
    float32 lies farther from a float32 rounding midpoint than torch's
    float64 root errs) and float64 through :func:`_sqrt64_cpu`."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    if x.dtype == torch.float64:
        return _sqrt64_cpu(x)
    return torch.sqrt(x.double()).to(x.dtype)


def rsf_t(ar, k, r, s, xi):
    """:func:`_rsf` on 0-d tensors: ``k`` the iteration counter as a
    tensor (an integer, or a real holding one), ``r``, ``s`` and ``xi``
    of the problem's real type (``sporco_tpu/solvers/admm.py``
    ``_update_rho``)."""
    if not ar.enabled:
        return torch.ones_like(r)
    tau = _num(ar.scaling, r.dtype)
    mu = _num(ar.rsdl_ratio, r.dtype)
    if ar.auto_scaling:
        sxi = s * xi
        ratio = torch.where(r > sxi, r / sxi, sxi / r)
        rhomlt = torch.clamp(sqrt_t(ratio), max=tau)
        rhomlt = torch.where((s == 0.0) | (r == 0.0), tau, rhomlt)
    else:
        rhomlt = torch.full_like(r, tau)
    rsf = torch.where(r > xi * mu * s, rhomlt,
                      torch.where(s > (torch.full_like(xi, mu) / xi) * r,
                                  torch.reciprocal(rhomlt), 1.0))
    on_period = (k != 0) & ((k + 1) % ar.period == 0)
    return torch.where(on_period, rsf, 1.0)


def update_rho_t(ar, k, r, s, rho, xi):
    """:func:`_update_rho` of the fused driver on 0-d tensors: the new
    rho and the deferred dual factor ``1 / rsf``."""
    rsf = rsf_t(ar, k, r, s, xi)
    return rho * rsf, torch.reciprocal(rsf)


def norm_residuals_t(ar, opts, nc, nx, rnrm, snrm, rn, sn):
    """:func:`norm_residuals` on 0-d tensors of the problem's real type
    (``nc``, ``nx`` numbers); the four results are views of one
    tensor."""
    dt = rn.dtype
    atol_c = _num(nc * opts.abs_stop_tol, dt)
    atol_x = _num(nx * opts.abs_stop_tol, dt)
    rtol = _num(opts.rel_stop_tol, dt)
    norms = torch.stack([rn, sn])
    if ar.std_residuals:
        tol = norms * rtol + torch.stack([torch.full_like(rn, atol_c),
                                          torch.full_like(sn, atol_x)])
        return (rnrm, snrm, tol[0], tol[1])
    norms = torch.where(norms == 0.0, 1.0, norms)
    atol = torch.full_like(norms, atol_c) if atol_c == atol_x \
        else torch.stack([torch.full_like(rn, atol_c),
                          torch.full_like(sn, atol_x)])
    out = torch.cat([torch.stack([rnrm, snrm]) / norms,
                     atol / norms + rtol])
    return tuple(out)


def const_div(a, t):
    """``a / t`` for a number ``a`` and a tensor ``t``, rounded once (as
    the JAX package's ``a / t``): the number as a tensor of ``t``'s
    type."""
    return torch.full_like(t, float(a)) / t


# ---------------------------------------------------------------------------
# Arithmetic over a tensor or a tuple of tensors (the JAX package's tree
# helpers, ``sporco_tpu/solvers/admm.py:181-222``)

def _tmap(f, *trees):
    """``f`` applied entry by entry over congruent tuples, or to the
    tensors themselves."""
    if isinstance(trees[0], tuple):
        return tuple(_tmap(f, *ls) for ls in zip(*trees))
    return f(*trees)


def _tleaves(t):
    return [v for e in t for v in _tleaves(e)] if isinstance(t, tuple) \
        else [t]


def _tree_size(t):
    return sum(v.numel() for v in _tleaves(t))


def _sumsq(x):
    """``sum |x|^2`` as a real 0-d tensor."""
    return torch.sum(x.abs() ** 2 if x.is_complex() else x * x)


def tree_sumsq(t):
    """``sum |x|^2`` over every tensor of ``t``, a real 0-d tensor."""
    leaves = _tleaves(t)
    out = _sumsq(leaves[0])
    for v in leaves[1:]:
        out = out + _sumsq(v)
    return out


def tree_norm(t):
    """Frobenius norm over every tensor of ``t`` (complex-aware)."""
    return torch.sqrt(tree_sumsq(t))


def _with_c(f, c, *trees):
    """``f(c_entry, *entries)`` mapped over ``trees``, where ``c`` is a
    number or tensor (the same for every entry) or a congruent tuple."""
    if isinstance(c, tuple):
        return _tmap(f, c, *trees)
    return _tmap(lambda *ls: f(c, *ls), *trees)


# ---------------------------------------------------------------------------
# The problem protocol and the generic driver

def _identity(cfg, aux, params, v):
    return v


def _neg(cfg, aux, params, v):
    return _tmap(lambda a: -a, v)


def _zero_c(cfg, aux, params):
    return 0.0


@dataclass(frozen=True)
class ADMMProblem:
    """One ADMM problem as plain functions (``sporco/admm/admm.py:
    672-775``).  ``cnst_a/cnst_at/cnst_b/cnst_c`` default to the
    ``ADMMEqual`` constraint ``X - Y = 0``; ``rsdl_*``, where set,
    replace the generic residuals and their normalisers (as the
    consensus problems do).  Signatures::

        setup(cfg, params) -> aux
        xstep(cfg, aux, params, state) -> (X, xaux)
        ystep(cfg, aux, params, state, AXU) -> Y
        obfn(cfg, aux, params, state, xaux) -> tuple of 0-d tensors
        cnst_a(cfg, aux, params, X) -> AX        (and cnst_at, cnst_b)
        cnst_c(cfg, aux, params) -> number or tensor
        rsdl_r(cfg, aux, params, state, AXnr) -> primal residual tensor
        rsdl_s(cfg, aux, params, state, Yprev) -> dual residual tensor
        rsdl_rn(cfg, aux, params, state, AXnr) -> 0-d tensor
        rsdl_sn(cfg, aux, params, state) -> 0-d tensor
        yinit/uinit/xinit(cfg, params) -> tensor
        extra_init(cfg, params) -> extra carry (kept in the state)
        update_extra(cfg, aux, params, state, xaux) -> new extra carry,
            after the u-step, before the residuals and the objective

    The functions run inside the device loop: ``state.rho`` (and the
    other scalars) are 0-d tensors, and nothing may be read on the host.
    ``route`` is ``"graph"`` (on the card an iteration is captured once
    as a CUDA graph) or ``"eager"`` for a problem whose iteration
    synchronises with the host by nature (a host callable).
    """
    setup: Callable
    xstep: Callable
    ystep: Callable
    obfn: Optional[Callable] = None
    cnst_a: Callable = _identity
    cnst_at: Callable = _identity
    cnst_b: Callable = _neg
    cnst_c: Callable = _zero_c
    rsdl_r: Optional[Callable] = None
    rsdl_s: Optional[Callable] = None
    rsdl_rn: Optional[Callable] = None
    rsdl_sn: Optional[Callable] = None
    yinit: Optional[Callable] = None
    uinit: Optional[Callable] = None
    xinit: Optional[Callable] = None
    extra_init: Optional[Callable] = None
    update_extra: Optional[Callable] = None
    stat_names: Tuple[str, ...] = ("Obj", "F", "G")
    route: str = "graph"


def init_state(prob, cfg, params, opts, rho0, rho_xi=1.0, Y0=None,
               U0=None):
    """A fresh :class:`ADMMState` (``sporco_tpu.solvers.admm.init_state``):
    ``Y0``/``U0`` warm-start the solve, else the problem's
    ``yinit``/``uinit`` give them; X starts at ``xinit`` or zeros."""
    if Y0 is None and prob.yinit is not None:
        Y0 = prob.yinit(cfg, params)
    if U0 is None and prob.uinit is not None:
        U0 = prob.uinit(cfg, params)
    if Y0 is None or U0 is None:
        raise ValueError("problem must provide yinit/uinit or caller "
                         "must pass Y0/U0")
    ft = scalar_type(opts.dtype)
    X0 = prob.xinit(cfg, params) if prob.xinit \
        else _tmap(torch.zeros_like, Y0)
    nstat = 1 + len(prob.stat_names) + 5
    return ADMMState(
        X=X0, Y=Y0, U=U0, rho=ft(rho0), rho_xi=ft(rho_xi), k=np.int32(0),
        r=ft(np.inf), s=ft(np.inf), epri=ft(0.0), edua=ft(0.0),
        stats=np.full((opts.max_iter, nstat), np.nan, np.float32),
        extra=prob.extra_init(cfg, params) if prob.extra_init else ())


def _loop_key(kind, prob, cfg, opts, trees):
    """What a captured iteration of a generic driver bakes in beside the
    values of its static tensors: the problem, configuration and options,
    the structure of its trees (``device_loop.flatten``), the matmul and
    FFT modes."""
    from sporco_tpu_torch.ops import fused_csc
    return (kind, prob, repr(cfg), repr(opts), trees,
            fused_csc.get_matmul_precision(), sf.get_precision(),
            sf._PLANAR_MODE)


def _stats_tensor(stats, max_iter, ncol, device):
    """The stats buffer of a solve call on ``device`` (float32): the
    state's, or NaN when its shape is not ``(max_iter, ncol)``."""
    stats = np.asarray(stats, np.float32)
    if stats.shape != (max_iter, ncol):
        stats = np.full((max_iter, ncol), np.nan, np.float32)
    return torch.tensor(stats, device=device)


def _row_index(k, k0, max_iter):
    """The stats row of iteration ``k`` of a solve call from ``k0`` as a
    one-element int64 tensor (clamped: a dead iteration after
    ``max_iter`` rewrites the last row with itself)."""
    return (k - k0).clamp(0, max_iter - 1).to(torch.int64).reshape(1)


def write_row(stats, k, k0, live, row):
    """Row ``k - k0`` of ``stats`` becomes ``row`` (float32) where
    ``live``, else stays."""
    idx = _row_index(k, k0, stats.shape[0])
    old = stats.index_select(0, idx)[0]
    stats.index_copy_(0, idx, torch.where(live, row, old)[None])


def _as_reals(vals, dtype, device):
    """0-d tensors of any real or integer type, or numbers, as 0-d tensors
    of ``dtype`` (the type the host forms took them in)."""
    return [v.reshape(()).to(dtype) if isinstance(v, torch.Tensor)
            else torch.full((), float(v), dtype=dtype, device=device)
            for v in vals]


def as_row(vals, dtype, device):
    """The entries of a stats row as one float32 tensor, each through
    ``dtype`` (:func:`_as_reals`)."""
    return torch.stack(_as_reals(vals, dtype, device)).to(torch.float32)


def guarded_update(live, olds, news):
    """Write each tensor of ``news`` into its static counterpart in
    ``olds`` where ``live`` (``torch.where``).  A new value that is its
    own counterpart is left; one that is another static tensor (FISTA's
    Xprv, the old X) is written before that tensor is, or copied first
    where that order cannot hold."""
    if len(news) != len(olds):
        raise ValueError(f"the iteration gave {len(news)} state arrays for "
                         f"the loop's {len(olds)}")

    def mem(t):
        return t.untyped_storage().data_ptr()
    slot = {mem(o): j for j, o in enumerate(olds)}
    reads = {i: slot[mem(n)] for i, n in enumerate(news)
             if n is not olds[i] and mem(n) in slot}
    first = [i for i in reads if i not in reads.values()]
    news = list(news)
    for i in reads:
        if i not in first:
            news[i] = news[i].clone()
    for i in first + [i for i in range(len(olds)) if i not in first]:
        if news[i] is not olds[i]:
            torch.where(live, news[i], olds[i], out=olds[i])


def _admm_run(prob, cfg, params, opts, state):
    """Run up to ``opts.max_iter`` iterations from ``state``, stopping
    when both normalised residuals pass their tolerances, on the device
    (:mod:`sporco_tpu_torch.ops.device_loop`): one host read a block of
    iterations and one of the final state."""
    aux = prob.setup(cfg, params)
    rdt = sf.real_dtype(opts.dtype)
    ft = scalar_type(opts.dtype)
    k0 = int(state.k)
    nobj = len(prob.stat_names)
    dev = _tleaves(state.Y)[0].device
    arrays = (state.X, state.Y, state.U, state.extra)
    p_leaves, p_spec, p_key = device_loop.flatten((params, aux))
    s_leaves, s_spec, s_key = device_loop.flatten(arrays, shared=False)
    key = _loop_key("admm", prob, cfg, opts, (p_key, s_key))
    kind = ("admm_generic", prob, str(dev))
    fresh = {f"p{i}": v for i, v in enumerate(p_leaves)}
    fresh.update({f"s{i}": v for i, v in enumerate(s_leaves)})
    fresh["sc"] = torch.tensor(
        [state.rho, state.rho_xi, k0, k0, state.r, state.s, state.epri,
         state.edua], dtype=rdt, device=dev)
    fresh["stats"] = _stats_tensor(state.stats, opts.max_iter,
                                   1 + nobj + 5, dev)
    fresh["fcnt"] = torch.zeros(2, dtype=torch.int32, device=dev)
    fresh["inner"] = torch.zeros((), dtype=torch.int64, device=dev)
    fresh["enable"] = torch.ones((), dtype=torch.bool, device=dev)
    loop = device_loop.kept(kind, key)
    if loop is None:
        # the loop's own copies (a later call refills them in place)
        T = {n: v.clone() for n, v in fresh.items()}
        loop = device_loop.keep(kind, key, _admm_loop(
            prob, cfg, opts, T, p_spec, len(p_leaves), s_spec,
            len(s_leaves), prob.route == "graph"))
    else:
        loop.refill(fresh)
    host = device_loop.run(
        loop, opts.max_iter,
        bool(ft(state.r) <= ft(state.epri) and ft(state.s) <= ft(state.edua)),
        dev, verbose=opts.verbose, graph=prob.route == "graph")
    T = loop.t
    if dev.type == "cuda":
        # the FFT kernels' live launches in the loop, counted on the device
        fft2_planar.LAUNCHES["rfft2_planar"] += int(host[8])
        fft2_planar.LAUNCHES["irfft2_planar"] += int(host[9])
    rho, rho_xi, k, _, r, s, epri, edua = (ft(v) for v in host[:8])
    # new tensors: the loop's are refilled by its next call
    X, Y, U, extra = device_loop.unflatten(
        s_spec, [T[f"s{i}"].clone() for i in range(len(s_leaves))])
    return ADMMState(
        X=X, Y=Y, U=U, rho=rho, rho_xi=rho_xi, k=np.int32(k), r=r, s=s,
        epri=epri, edua=edua,
        stats=host[11:].reshape(opts.max_iter, 1 + nobj + 5)
        .astype(np.float32), extra=extra)


def _admm_loop(prob, cfg, opts, T, p_spec, n_p, s_spec, n_s, graph):
    """The generic ADMM iteration (``sporco_tpu/solvers/admm.py``
    ``body``) over the static tensors ``T`` (see :func:`_admm_run`), as
    a :class:`~sporco_tpu_torch.ops.device_loop.Loop`.

    An iteration is the stopping test (``head``), the problem's steps
    with the residual norms and objective terms gathered in one static
    vector, the scalar tail (``tail``: residuals, tolerances, the stats
    row, AutoRho) and the guarded writes of the state.  On the eager
    route on the card, ``head`` and ``tail`` are CUDA graphs of their
    own (:class:`~sporco_tpu_torch.ops.device_loop.Piece`): dozens of
    small launches that would each pay the host's dispatch."""
    params, aux = device_loop.unflatten(p_spec, [T[f"p{i}"]
                                                 for i in range(n_p)])
    olds = [T[f"s{i}"] for i in range(n_s)]
    Xs, Ys, Us, Es = device_loop.unflatten(s_spec, olds)
    sc, stats, fcnt, enable = T["sc"], T["stats"], T["fcnt"], T["enable"]
    passes = T["inner"]
    rho, rho_xi, k, k0, r, s, epri, edua = sc
    rdt = sc.dtype
    dev = sc.device
    ar = opts.auto_rho
    rlx = opts.relax_param
    nobj = len(prob.stat_names)
    nc = math.sqrt(_tree_size(Ys))
    nx = math.sqrt(_tree_size(Xs))
    # the static vector the steps fill: the squared norms of the primal
    # and dual residuals, the primal normalisers (the generic ones
    # squared: A x, B y and a tensor c; or rsdl_rn's norm), the dual
    # normaliser (squared, or rsdl_sn's), then the objective terms
    c0 = prob.cnst_c(cfg, aux, params)
    n_rn = 1 if prob.rsdl_rn is not None else (
        3 if isinstance(c0, (torch.Tensor, tuple)) else 2)
    nsq = 2 + n_rn + 1
    T["tin"] = tin = torch.zeros(nsq + nobj, dtype=rdt, device=dev)
    T["live"] = live = torch.zeros((), dtype=torch.bool, device=dev)
    T["rsf"] = rsf = torch.ones((), dtype=rdt, device=dev)
    # the entries of tin that are squared norms
    squared = [True, True] + [prob.rsdl_rn is None] * n_rn + [
        prob.rsdl_sn is None] + [False] * nobj
    squared = torch.tensor(squared, device=dev)
    whole = dev.type == "cuda" and graph    # the iteration is one graph

    def converged():
        return ((r <= epri) & (s <= edua)) | (k - k0 >= opts.max_iter)

    def head(out=live):
        torch.logical_and(enable, ~converged(), out=out)

    def tail():
        q = torch.where(squared, sqrt_t(tin), tin)
        rnrm = q[0]
        snrm = q[1] if prob.rsdl_s is not None else rho * q[1]
        rn = torch.amax(q[2:2 + n_rn])
        sn = q[nsq - 1] if prob.rsdl_sn is not None else rho * q[nsq - 1]
        r_, s_, epri_, edua_ = norm_residuals_t(ar, opts, nc, nx, rnrm,
                                                snrm, rn, sn)
        write_row(stats, k, k0, live,
                  as_row((k,) + tuple(q[nsq:]) + (r_, s_, epri_, edua_,
                                                  rho), rdt, dev))
        # adaptive rho (sporco/admm/admm.py:549-575)
        rsf.copy_(rsf_t(ar, k, r_, s_, rho_xi))
        torch.where(live, torch.stack(
            [rho * rsf, rho_xi, k + 1.0, k0, r_, s_, epri_, edua_]), sc,
            out=sc)

    # iterating eagerly (the CPU, the eager route), the scalar tail ends
    # with the next iteration's test, into ``nxt``: on the card the two
    # are one graph of their own (a Piece)
    T["next"] = nxt = torch.zeros((), dtype=torch.bool, device=dev)

    def tail_next():
        tail()
        head(nxt)
    if whole:
        tail_p = tail
    elif dev.type == "cuda":
        tail_p = device_loop.Piece(tail_next, dev, quiet=live)
    else:
        tail_p = tail_next

    def step():
        """One iteration, guarded by ``live`` (the JAX ``lax.cond``); the
        FFT kernels read it through their gate, the inner loops (CG)
        through ``device_loop.inner``."""
        device_loop.stage("stopping test")
        if whole:
            head()
        with fft2_planar.gate(live.to(torch.float32), fcnt), \
                device_loop.inner(live, passes):
            body()
        if not whole:
            live.copy_(nxt)
        return live

    def body():
        st = ADMMState(X=Xs, Y=Ys, U=Us, rho=rho, rho_xi=rho_xi, k=k, r=r,
                       s=s, epri=epri, edua=edua, stats=None, extra=Es)
        device_loop.stage("x-step")
        X, xaux = prob.xstep(cfg, aux, params, st)
        AXnr = prob.cnst_a(cfg, aux, params, X)
        c = prob.cnst_c(cfg, aux, params)
        if rlx == 1.0:
            AX = AXnr
        else:
            BY = prob.cnst_b(cfg, aux, params, Ys)
            AX = _with_c(lambda cl, a, b: rlx * a - (1 - rlx) * (b - cl),
                         c, AXnr, BY)
        device_loop.stage("y-step")
        Y = prob.ystep(cfg, aux, params, st._replace(X=X),
                       _tmap(lambda a, u: a + u, AX, Us))
        BY = prob.cnst_b(cfg, aux, params, Y)
        U = _with_c(lambda cl, u, a, b: u + a + b - cl, c, Us, AX, BY)
        st2 = st._replace(X=X, Y=Y, U=U)
        if prob.update_extra is not None:
            st2 = st2._replace(
                extra=prob.update_extra(cfg, aux, params, st2, xaux))
        # residuals (sporco/admm/admm.py:462-486) on the device; a
        # problem's rsdl_* hooks replace the generic ones
        device_loop.stage("residuals and objective")
        if prob.rsdl_r is not None:
            rv = prob.rsdl_r(cfg, aux, params, st2, AXnr)
        else:
            rv = _with_c(lambda cl, a, b: a + b - cl, c, AXnr, BY)
        if prob.rsdl_s is not None:     # rho included
            sv = prob.rsdl_s(cfg, aux, params, st2, Ys)
        else:
            sv = prob.cnst_at(cfg, aux, params, prob.cnst_b(
                cfg, aux, params, _tmap(lambda a, b: a - b, Y, Ys)))
        vals = [tree_sumsq(rv), tree_sumsq(sv)]
        if prob.rsdl_rn is not None:
            vals.append(prob.rsdl_rn(cfg, aux, params, st2, AXnr))
        else:
            vals += [tree_sumsq(AXnr), tree_sumsq(BY)]
            if n_rn == 3:
                vals.append(tree_sumsq(c))
        if prob.rsdl_sn is not None:
            vals.append(prob.rsdl_sn(cfg, aux, params, st2))
        else:
            vals.append(tree_sumsq(prob.cnst_at(cfg, aux, params, U)))
        if opts.fast_solve or prob.obfn is None:
            vals += [math.nan] * nobj
        else:
            vals += list(prob.obfn(cfg, aux, params, st2, xaux))
        torch.stack(_as_reals(vals, rdt, dev), out=tin)
        device_loop.stage("scalar tail")
        tail_p()
        # U / rsf on every iteration, as the JAX package (a division by 1
        # is exact)
        device_loop.stage("state")
        if ar.enabled:
            U = _tmap(lambda u: u / rsf, U)
        guarded_update(live, olds, device_loop.flatten(
            (X, Y, U, st2.extra), shared=False)[0])

    def status():
        return torch.stack([converged().to(rdt), k - k0])

    def show(row):
        print(f"it {int(row[0])}  obj {row[1]:.4e}  r {row[1 + nobj]:.3e}  "
              f"s {row[2 + nobj]:.3e}  rho {row[-1]:.3e}")

    return device_loop.Loop(
        T, step, status,
        # the state, the FFT pair's and the inner loops' (CG) passes
        # counted on the device, the stats rows
        lambda: torch.cat([sc, fcnt.to(rdt), passes.to(rdt)[None],
                           stats.reshape(-1).to(rdt)]),
        lambda i, n: stats[i:i + n], show,
        start=None if whole else head, inner_at=10)


def admm_solve(prob, cfg, params, opts, state):
    """Run one (re-entrant) generic solve call with fp32 contractions
    pinned; returns the final state."""
    with fp32_precision(), torch.no_grad():
        return _admm_run(prob, cfg, params, opts, state)


class IterStats:
    """Host-side view of the stats buffer; column access by name."""

    def __init__(self, names, buf, nvalid):
        self._names = tuple(names)
        arr = np.asarray(buf)[:int(nvalid)]
        self._arr = arr
        for i, n in enumerate(self._names):
            setattr(self, n, arr[:, i])

    def __len__(self):
        return self._arr.shape[0]

    def __repr__(self):
        return f"IterStats({self._names}, n={len(self)})"


def iterstats(names, state, k_start=0):
    """An :class:`IterStats` view of the rows of the most recent solve
    call."""
    return IterStats(names, state.stats, int(state.k) - int(k_start))
