"""ADMM options, state, adaptive rho and the generic driver (counterpart
of ``sporco_tpu.solvers.admm``).

The JAX package runs the whole loop on the device.  Here the loop runs
on the host in Python: the large arrays (X, Y, U) are tensors on the
solve's device, while the scalars of the state (rho, residuals,
tolerances, the iteration counter) and the per-iteration stats buffer
are host numpy values (``float32``, or ``float64`` for a float64 or
complex128 problem).  All scalar arithmetic is done in that type, in
the same order as the JAX package, so that the AutoRho decisions and
the stopping test match it.  The generic driver :func:`admm_solve`
reads one small vector back from the device per iteration.  The fused
drivers (``ops/fused_csc.py``) keep these scalars on the device instead,
through the tensor forms ``rsf_t``, ``update_rho_t`` and
``norm_residuals_t``.

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
    host stats buffer of shape ``(max_iter, nstat)``."""
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
# The same scalar arithmetic on 0-d float32 tensors, for the fused
# drivers' on-device loop (``ops/device_loop.py``): the JAX package's
# operations in its order, ``torch.where`` in place of the branches, so
# a stats row computed on the device equals the one the host forms
# above compute.  The host forms stay numpy: torch's CPU square root is
# not correctly rounded (MKL's vector math; about one float32 input in
# 100 and float64 input in 150 parts from numpy's), and the generic
# drivers' float64 rows must match the JAX package's bit for bit.

def sqrt_t(x):
    """The correctly rounded square root of a float32 tensor: CUDA's is,
    torch's CPU one is not, so there it goes through float64."""
    if x.device.type == "cuda":
        return torch.sqrt(x)
    return torch.sqrt(x.double()).to(x.dtype)


def rsf_t(ar, k, r, s, xi):
    """:func:`_rsf` on 0-d float32 tensors: ``k`` the iteration counter
    as a tensor (an integer, or a float32 holding one), ``r``, ``s`` and
    ``xi`` float32 (``sporco_tpu/solvers/admm.py`` ``_update_rho``)."""
    if not ar.enabled:
        return torch.ones_like(r)
    tau = float(f32(ar.scaling))
    mu = float(f32(ar.rsdl_ratio))
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
    """:func:`_update_rho` of the fused driver on 0-d float32 tensors:
    the new rho and the deferred dual factor ``1 / rsf``."""
    rsf = rsf_t(ar, k, r, s, xi)
    return rho * rsf, torch.reciprocal(rsf)


def norm_residuals_t(ar, opts, nc, nx, rnrm, snrm, rn, sn):
    """:func:`norm_residuals` on 0-d float32 tensors (``nc``, ``nx``
    numbers); the four results are views of one tensor."""
    atol_c = float(f32(nc * opts.abs_stop_tol))
    atol_x = float(f32(nx * opts.abs_stop_tol))
    rtol = float(f32(opts.rel_stop_tol))
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


def _admm_run(prob, cfg, params, opts, state):
    """Run up to ``opts.max_iter`` iterations from ``state``, stopping
    when both normalised residuals pass their tolerances; one host read
    per iteration (the squared norms and the objective terms)."""
    aux = prob.setup(cfg, params)
    ar = opts.auto_rho
    rlx = opts.relax_param
    ft = scalar_type(opts.dtype)
    st = state
    k0 = int(st.k)
    nc = math.sqrt(_tree_size(st.Y))
    nx = math.sqrt(_tree_size(st.X))
    nobj = len(prob.stat_names)
    stats = np.array(st.stats, np.float32, copy=True)
    if stats.shape[0] != opts.max_iter:
        stats = np.full((opts.max_iter, 1 + nobj + 5), np.nan, np.float32)

    def converged(st):
        return (int(st.k) - k0 >= opts.max_iter
                or (st.r <= st.epri and st.s <= st.edua))

    while not converged(st):
        rho = st.rho
        Yprev = st.Y
        X, xaux = prob.xstep(cfg, aux, params, st)
        AXnr = prob.cnst_a(cfg, aux, params, X)
        c = prob.cnst_c(cfg, aux, params)
        if rlx == 1.0:
            AX = AXnr
        else:
            BY = prob.cnst_b(cfg, aux, params, st.Y)
            AX = _with_c(lambda cl, a, b: rlx * a - (1 - rlx) * (b - cl),
                         c, AXnr, BY)
        Y = prob.ystep(cfg, aux, params, st._replace(X=X),
                       _tmap(lambda a, u: a + u, AX, st.U))
        BY = prob.cnst_b(cfg, aux, params, Y)
        U = _with_c(lambda cl, u, a, b: u + a + b - cl, c, st.U, AX, BY)
        st2 = st._replace(X=X, Y=Y, U=U)
        if prob.update_extra is not None:
            st2 = st2._replace(
                extra=prob.update_extra(cfg, aux, params, st2, xaux))
        # residuals (sporco/admm/admm.py:462-486), squared, on the device;
        # a problem's rsdl_* hooks replace the generic ones
        if prob.rsdl_r is not None:
            rv = prob.rsdl_r(cfg, aux, params, st2, AXnr)
        else:
            rv = _with_c(lambda cl, a, b: a + b - cl, c, AXnr, BY)
        if prob.rsdl_s is not None:     # rho included
            sv = prob.rsdl_s(cfg, aux, params, st2, Yprev)
        else:
            sv = prob.cnst_at(cfg, aux, params, prob.cnst_b(
                cfg, aux, params, _tmap(lambda a, b: a - b, Y, Yprev)))
        c_tensor = isinstance(c, (torch.Tensor, tuple))
        sq = [tree_sumsq(rv), tree_sumsq(sv)]
        if prob.rsdl_rn is not None:
            sq.append(prob.rsdl_rn(cfg, aux, params, st2, AXnr))
        else:
            sq += [tree_sumsq(AXnr), tree_sumsq(BY)]
            if c_tensor:
                sq.append(tree_sumsq(c))
        if prob.rsdl_sn is not None:
            sq.append(prob.rsdl_sn(cfg, aux, params, st2))
        else:
            sq.append(tree_sumsq(prob.cnst_at(cfg, aux, params, U)))
        nsq = len(sq)
        rtype = sq[0].dtype
        sq = [v.reshape(()).to(rtype) for v in sq]
        if not (opts.fast_solve or prob.obfn is None):
            sq += [torch.as_tensor(o, dtype=rtype, device=sq[0].device)
                   for o in prob.obfn(cfg, aux, params, st2, xaux)]
        # the one host read of the iteration
        host = torch.stack(sq).cpu().numpy().astype(ft)
        rnrm = np.sqrt(host[0])
        snrm = np.sqrt(host[1])
        if prob.rsdl_s is None:
            snrm = rho * snrm
        if prob.rsdl_rn is not None:
            rn = host[2]
        else:
            rn = np.maximum(np.sqrt(host[2]), np.sqrt(host[3]))
            if c_tensor:
                rn = np.maximum(rn, np.sqrt(host[4]))
        if prob.rsdl_sn is not None:
            sn = host[nsq - 1]
        else:
            sn = rho * np.sqrt(host[nsq - 1])
        r, s, epri, edua = norm_residuals(ar, opts, nc, nx, rnrm, snrm, rn,
                                          sn, ft)
        objv = tuple(host[nsq:]) if len(host) > nsq else (np.nan,) * nobj
        k = int(st.k)
        stats[k - k0] = (k,) + objv + (r, s, epri, edua, rho)
        if opts.verbose:
            print(f"it {k}  obj {stats[k - k0, 1]:.4e}  r {r:.3e}  "
                  f"s {s:.3e}  rho {rho:.3e}")
        rsf = _rsf(ar, k, r, s, st.rho_xi, ft)
        if rsf != 1.0:
            U = _tmap(lambda u: u / float(rsf), U)
        st = st2._replace(U=U, rho=ft(rho * rsf), k=np.int32(k + 1), r=r,
                          s=s, epri=epri, edua=edua)
    return st._replace(stats=stats)


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
