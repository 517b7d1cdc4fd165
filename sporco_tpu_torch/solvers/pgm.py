"""PGM / accelerated proximal-gradient (FISTA) options, state and loop
(counterpart of ``sporco_tpu.solvers.pgm``).

The iteration (gradient step, prox, momentum extrapolation), the
momentum strategies (Nesterov / linear / generalised-linear,
``sporco/pgm/momentum.py:47-130``), the step-size policies (Cauchy,
Barzilai-Borwein, ``sporco/pgm/stepsize.py:49-130``), the monotone
variant and both backtracking line searches (standard and robust,
``sporco/pgm/backtrack.py:49-180``) run on the device, as the JAX
package's ``lax.while_loop`` does (:mod:`sporco_tpu_torch.ops.device_loop`):
the arrays of the state (X, Y, Xprv, Gprv, Zrb), its scalars (t, Tk, L,
rsdl, objprv, k and k0 as 0-d tensors of the problem's real type,
``float32``, or ``float64`` for a float64 problem, as the JAX package's
``rdt``) and the float32 stats rows stay on the solve's device, and the
host reads the stopping flag once a block of iterations and the final
state once.  Every scalar is computed in that type in the JAX package's
order, correctly rounded, so that the momentum ``beta`` and the
stopping test match it to the last bit; the host forms
(``_momentum_update``, ``stop_tol``) stay as the tests' oracle.  A
backtracking search (:func:`bt_chain`) is a first trial and an inner
loop of trials while ``F > Q`` and fewer than ``bt_maxiter`` have run:
on the card, a WHILE node of the iteration's graph that tests it on the
device (the graph route, for any ``bt_maxiter``); eagerly, one host read
a trial.
The returned :class:`PGMState` holds host scalars and a numpy ``stats``
from the one final read.
"""

import math
from dataclasses import dataclass, replace
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sporco_tpu_torch._device import fp32_precision
from sporco_tpu_torch.ops import device_loop
from sporco_tpu_torch.ops import fft as sf
from sporco_tpu_torch.ops import fft2_planar
from sporco_tpu_torch.solvers.admm import (IterStats, _as_reals, _loop_key,
                                           _num, _stats_tensor, as_row,
                                           guarded_update, scalar_type,
                                           sqrt_t, write_row)

__all__ = ["PGMOpts", "PGMProblem", "PGMState", "pgm_solve", "pgm_route",
           "pgm_init_state", "pgm_iterstats", "stat_names",
           "momentum_update_t", "stop_tol_t", "bt_chain"]

f32 = np.float32


@dataclass(frozen=True)
class PGMOpts:
    """PGM options (same fields and defaults as the JAX package;
    semantics of ``sporco/pgm/pgm.py:160-163``)."""
    max_iter: int = 1000
    rel_stop_tol: float = 1e-3
    L: Optional[float] = None           # None -> problem default
    monotone: bool = False
    momentum: str = "nesterov"          # nesterov | linear | genlinear
    momentum_a: float = 50.0
    momentum_b: float = 2.0
    stepsize: str = "none"              # none | cauchy | bb
    backtrack: str = "none"             # none | standard | robust
    bt_gamma_u: float = 1.2
    bt_gamma_d: float = 0.9
    bt_maxiter: int = 50
    auto_stop: bool = False             # adaptive tolerance tau0/(1+k)
    auto_stop_tau0: float = 1e-2
    fast_solve: bool = False
    verbose: bool = False
    dtype: Any = torch.float32

    def replace(self, **kw):
        return replace(self, **kw)


@dataclass(frozen=True)
class PGMProblem:
    """A PGM problem ``argmin_x f(x) + g(x)`` as plain functions::

        setup(cfg, params) -> aux
        grad_f(cfg, aux, params, Y) -> tensor
        prox_g(cfg, aux, params, V, L) -> tensor
        obfn_f(cfg, aux, params, X) -> 0-d tensor (data term)
        obfn_g(cfg, aux, params, X) -> 0-d tensor (regulariser)
        hessian_f(cfg, aux, params, V) -> tensor (Cauchy policy only)
        xinit(cfg, params) -> X0
        obfn(cfg, aux, params, X) -> tuple of 0-d tensors (stats columns)

    The functions run inside the device loop (``L`` a 0-d tensor, nothing
    read on the host); ``route`` is ``"graph"`` or ``"eager"`` as for
    :class:`~sporco_tpu_torch.solvers.admm.ADMMProblem`.
    """
    setup: Callable
    grad_f: Callable
    prox_g: Callable
    obfn_f: Callable
    obfn_g: Callable
    xinit: Callable
    hessian_f: Optional[Callable] = None
    obfn: Optional[Callable] = None
    stat_names: Tuple[str, ...] = ("Obj", "F", "G")
    route: str = "graph"


class PGMState(NamedTuple):
    """Full PGM solver state: tensors X, Y, Xprv, Gprv (previous
    gradient, BB policy), Zrb (robust-backtrack Z sequence); host
    scalars of the problem's real type t, Tk (robust-backtrack T
    sequence), L, rsdl, objprv (monotone variant); the counter k; the
    host float32 stats buffer of shape ``(max_iter, nstat)``."""
    X: Any
    Y: Any
    Xprv: Any
    Gprv: Any
    Zrb: Any
    t: np.float32
    Tk: np.float32
    L: np.float32
    k: np.int32
    rsdl: np.float32
    objprv: np.float32
    stats: np.ndarray


def stat_names(obj_names):
    """Column names of the stats buffer for objective terms
    ``obj_names``."""
    return (("Iter",) + tuple(obj_names)
            + ("Rsdl", "F_Btrack", "Q_Btrack", "IterBTrack", "L"))


def pgm_init_state(X0, opts, L0, nobj):
    """A fresh :class:`PGMState` starting at ``X0`` whose stats rows hold
    ``nobj`` objective terms, its scalars in the real type of
    ``opts.dtype``.  X, Y, Xprv and Zrb are distinct buffers (the fused
    driver updates its packed copies in place)."""
    ft = scalar_type(opts.dtype)
    return PGMState(
        X=X0, Y=X0.clone(), Xprv=X0.clone(), Gprv=torch.zeros_like(X0),
        Zrb=X0.clone(), t=ft(1.0), Tk=ft(0.0), L=ft(L0),
        k=np.int32(0), rsdl=ft(np.inf), objprv=ft(np.inf),
        stats=np.full((opts.max_iter, len(stat_names(range(nobj)))),
                      np.nan, np.float32))


def _momentum_update(opts, t, k):
    """New momentum parameter (``sporco/pgm/momentum.py``), in the type
    of ``t``."""
    ft = type(t)
    if opts.momentum == "nesterov":
        return ft(0.5) * (ft(1.0) + np.sqrt(ft(1.0) + ft(4.0) * (t * t)))
    kf = ft(k)
    if opts.momentum == "linear":
        return (kf + ft(opts.momentum_b)) / ft(opts.momentum_b)
    if opts.momentum == "genlinear":
        return (kf + ft(opts.momentum_a)) / ft(opts.momentum_b)
    raise ValueError(f"unknown momentum {opts.momentum!r}")


def stop_tol(opts, k, ft=f32):
    """The stopping tolerance at iteration ``k`` (adaptive under
    ``auto_stop``), in the scalar type ``ft``."""
    if opts.auto_stop:
        return ft(opts.auto_stop_tau0) / (ft(1.0) + ft(k))
    return ft(opts.rel_stop_tol)


def momentum_update_t(opts, t, k):
    """:func:`_momentum_update` on a 0-d tensor ``t`` of the problem's
    real type and a tensor ``k`` (an integer, or a real holding one), for
    the on-device loops; the square root correctly rounded
    (:func:`sporco_tpu_torch.solvers.admm.sqrt_t`)."""
    if opts.momentum == "nesterov":
        return 0.5 * (1.0 + sqrt_t(1.0 + 4.0 * (t * t)))
    kf = k.to(t.dtype)
    b = torch.full_like(t, _num(opts.momentum_b, t.dtype))
    if opts.momentum == "linear":
        return (kf + b) / b
    if opts.momentum == "genlinear":
        return (kf + _num(opts.momentum_a, t.dtype)) / b
    raise ValueError(f"unknown momentum {opts.momentum!r}")


def stop_tol_t(opts, k, dtype=torch.float32):
    """:func:`stop_tol` in ``dtype`` for a tensor ``k`` (an integer, or a
    real holding one): a 0-d tensor under ``auto_stop``, else the fixed
    tolerance as a number of that type."""
    if opts.auto_stop:
        kf = k.to(dtype)
        return torch.full_like(kf, _num(opts.auto_stop_tau0, dtype)) / (
            1.0 + kf)
    return _num(opts.rel_stop_tol, dtype)


def pgm_route(prob, opts):
    """The route of a solve of ``prob`` under ``opts``: the problem's
    (``prob.route``), whatever its line search."""
    return prob.route


def _pgm_run(prob, cfg, params, opts, state):
    """Run (or resume) the loop from ``state`` on the device; returns the
    final state.  Stats row: ``[k, objective terms..., Rsdl, F_Btrack,
    Q_Btrack, IterBTrack, L]``."""
    aux = prob.setup(cfg, params)
    rdt = sf.real_dtype(opts.dtype)
    ft = scalar_type(opts.dtype)
    k0 = int(state.k)
    dev = state.X.device
    ncol = len(stat_names(prob.stat_names))
    arrays = (state.X, state.Y, state.Xprv, state.Gprv, state.Zrb)
    p_leaves, p_spec, p_key = device_loop.flatten((params, aux))
    s_leaves, s_spec, s_key = device_loop.flatten(arrays, shared=False)
    key = _loop_key("pgm", prob, cfg, opts, (p_key, s_key))
    kind = ("pgm_generic", prob, str(dev))
    fresh = {f"p{i}": v for i, v in enumerate(p_leaves)}
    fresh.update({f"s{i}": v for i, v in enumerate(s_leaves)})
    fresh["sc"] = torch.tensor(
        [state.t, state.Tk, state.L, k0, k0, state.rsdl, state.objprv],
        dtype=rdt, device=dev)
    fresh["stats"] = _stats_tensor(state.stats, opts.max_iter, ncol, dev)
    fresh["fcnt"] = torch.zeros(2, dtype=torch.int32, device=dev)
    fresh["enable"] = torch.ones((), dtype=torch.bool, device=dev)
    eager = pgm_route(prob, opts) == "eager"
    loop = device_loop.kept(kind, key)
    if loop is None:
        # the loop's own copies (a later call refills them in place)
        T = {n: v.clone() for n, v in fresh.items()}
        loop = device_loop.keep(kind, key, _pgm_loop(
            prob, cfg, opts, T, p_spec, len(p_leaves), s_spec,
            len(s_leaves), not eager))
    else:
        loop.refill(fresh)
    host = device_loop.run(
        loop, opts.max_iter, not bool(ft(state.rsdl) >= stop_tol(
            opts, k0, ft)), dev, verbose=opts.verbose, graph=not eager)
    T = loop.t
    if dev.type == "cuda":
        # the FFT kernels' live launches in the loop, counted on the device
        fft2_planar.LAUNCHES["rfft2_planar"] += int(host[7])
        fft2_planar.LAUNCHES["irfft2_planar"] += int(host[8])
    t, Tk, L, k, _, rsdl, objprv = (ft(v) for v in host[:7])
    # new tensors: the loop's are refilled by its next call
    X, Y, Xprv, Gprv, Zrb = device_loop.unflatten(
        s_spec, [T[f"s{i}"].clone() for i in range(len(s_leaves))])
    return PGMState(
        X=X, Y=Y, Xprv=Xprv, Gprv=Gprv, Zrb=Zrb, t=t, Tk=Tk, L=L,
        k=np.int32(k), rsdl=rsdl, objprv=objprv,
        stats=host[9:].reshape(opts.max_iter, ncol).astype(np.float32))


def bt_chain(live, trial, L0, opts, T=None):
    """A backtracking line search (``sporco/pgm/backtrack.py``; the JAX
    package's inner ``while_loop``, ``sporco_tpu/solvers/pgm.py``
    ``bt_cond``/``bt_body``).  The first trial, ``trial(L0)``, runs
    unconditionally and its results (..., F, Q) become the search's
    buffers; then :func:`~sporco_tpu_torch.ops.device_loop.while_` runs
    a trial while ``searching = live & (F > Q) & (trials <
    bt_maxiter)``: it multiplies L by ``bt_gamma_u``, runs the trial,
    copies its results into the buffers, adds one to the trial count
    and updates ``searching``.

    Captured, the loop is one WHILE node that tests ``searching`` on the
    device, whatever ``bt_maxiter``; eagerly, each pass reads it on the
    host, n + 1 reads for a live search of n trials after the first (n
    = 0 where the first satisfies the test).  A result that shares
    memory with a tensor of ``T`` (the loop's) or with another result is
    copied first, so that the trials never write into a problem's
    tensors.  Returns the buffers, L and the trial count (0-d tensors of
    L0's type)."""
    out = list(trial(L0))
    seen = set() if T is None else {
        v.untyped_storage().data_ptr() for v in T.values()}
    for i, v in enumerate(out):
        m = v.untyped_storage().data_ptr()
        if m in seen:
            out[i] = v = v.clone()
            m = v.untyped_storage().data_ptr()
        seen.add(m)
    L = L0.clone()
    ibt = torch.ones_like(L)
    n = opts.bt_maxiter
    searching = live & (out[-2] > out[-1]) & (ibt < n)
    gamma_u = _num(opts.bt_gamma_u, L.dtype)

    def more():
        device_loop.stage("line search trial")
        L.mul_(gamma_u)
        for dst, v in zip(out, trial(L)):
            dst.copy_(v)
        ibt.add_(1.0)
        torch.logical_and(live, out[-2] > out[-1], out=searching)
        searching.logical_and_(ibt < n)
    device_loop.while_(searching, more)
    return tuple(out), L, ibt


def _pgm_loop(prob, cfg, opts, T, p_spec, n_p, s_spec, n_s, graph):
    """The generic PGM iteration (``sporco_tpu/solvers/pgm.py`` ``body``)
    over the static tensors ``T`` (see :func:`_pgm_run`), as a
    :class:`~sporco_tpu_torch.ops.device_loop.Loop`."""
    params, aux = device_loop.unflatten(p_spec, [T[f"p{i}"]
                                                 for i in range(n_p)])
    olds = [T[f"s{i}"] for i in range(n_s)]
    Xs, Ys, Xprvs, Gprvs, Zrbs = device_loop.unflatten(s_spec, olds)
    sc, stats, fcnt, enable = T["sc"], T["stats"], T["fcnt"], T["enable"]
    t, Tk, Ls, k, k0, rsdl, objprv = sc
    rdt = sc.dtype
    dev = sc.device
    nobj = len(prob.stat_names)
    nanv = torch.full((), math.nan, dtype=rdt, device=dev)

    def dotp(a, b):
        return torch.sum(a * b).to(rdt)

    def norm(a):
        return sqrt_t(torch.sum(a * a).to(rdt))

    def eval_obj(X):
        if prob.obfn is not None:
            return tuple(prob.obfn(cfg, aux, params, X))
        f = prob.obfn_f(cfg, aux, params, X)
        g = prob.obfn_g(cfg, aux, params, X)
        return (f + g, f, g)

    def step_to(Y, grad, L):
        return prob.prox_g(cfg, aux, params, Y - grad / L, L)

    def plain_step(live):
        grad = prob.grad_f(cfg, aux, params, Ys)
        L = Ls
        if opts.stepsize == "cauchy":
            den = dotp(grad, grad)
            num = dotp(grad, prob.hessian_f(cfg, aux, params, grad))
            L = torch.where(k > 1, num / den, L)
        elif opts.stepsize == "bb":
            Lbb = dotp(grad - Gprvs, grad - Gprvs) / dotp(
                Xs - Xprvs, grad - Gprvs)
            L = torch.where((k > 1) & (Lbb >= 0.0), Lbb, L)
        X = step_to(Ys, grad, L)
        obj_prv = objprv
        if opts.monotone:
            obj = torch.as_tensor(eval_obj(X)[0]).to(rdt)
            revert = (k > 0) & (objprv < obj)
            ZZ = X
            X = torch.where(revert, Xs, X)
            obj_prv = torch.where(revert, objprv, obj)
        tn = momentum_update_t(opts, t, k)
        if opts.monotone:
            Y = X + (t / tn) * (ZZ - X) + ((t - 1.0) / tn) * (X - Xs)
        else:
            Y = X + ((t - 1.0) / tn) * (X - Xs)
        return (X, Y, grad, Zrbs), (tn, Tk, L, obj_prv), (nanv, nanv, 0)

    def majorant(fY, X, Y, grad, L):
        Dxy = X - Y
        n = norm(Dxy)
        return fY + dotp(Dxy, grad) + (L / 2.0) * (n * n)

    def bt_standard_step(live):
        grad = prob.grad_f(cfg, aux, params, Ys)
        fY = prob.obfn_f(cfg, aux, params, Ys).to(rdt)

        def trial(L):
            X = step_to(Ys, grad, L)
            F = prob.obfn_f(cfg, aux, params, X).to(rdt)
            return X, F, majorant(fY, X, Ys, grad, L)

        (X, F, Q), L, ibt = bt_chain(live, trial, Ls, opts, T)
        tn = momentum_update_t(opts, t, k)
        Y = X + ((t - 1.0) / tn) * (X - Xs)
        return (X, Y, grad, Zrbs), (tn, Tk, L, objprv), (F, Q, ibt)

    def bt_robust_step(live):
        def trial(L):
            tt = (1.0 + sqrt_t(1.0 + 4.0 * L * Tk)) / (2.0 * L)
            TT = Tk + tt
            y = (Tk * Xs + tt * Zrbs) / TT
            grad = prob.grad_f(cfg, aux, params, y)
            X = step_to(y, grad, L)
            F = prob.obfn_f(cfg, aux, params, X).to(rdt)
            fy = prob.obfn_f(cfg, aux, params, y).to(rdt)
            return X, y, grad, tt, TT, F, majorant(fy, X, y, grad, L)

        (X, y, grad, tt, TT, F, Q), L, ibt = bt_chain(
            live, trial, Ls * _num(opts.bt_gamma_d, rdt), opts, T)
        Zrb = Zrbs + (tt * L) * (X - y)
        return (X, y, grad, Zrb), (tt, TT, L, objprv), (F, Q, ibt)

    take = {"standard": bt_standard_step,
            "robust": bt_robust_step}.get(opts.backtrack, plain_step)
    # the static vector the step fills: ||X - Y||^2, the objective terms,
    # the line search's F, Q and trials, and the new t, Tk, L, objprv
    T["tin"] = tin = torch.zeros(1 + nobj + 7, dtype=rdt, device=dev)
    T["live"] = live = torch.zeros((), dtype=torch.bool, device=dev)
    whole = dev.type == "cuda" and graph    # the iteration is one graph

    def live_now():
        return (enable & (k - k0 < opts.max_iter)
                & (rsdl >= stop_tol_t(opts, k, rdt)))

    def head(out=live):
        out.copy_(live_now())

    def tail():
        rs = sqrt_t(tin[0])
        F, Q, ibt, tn, TTn, L, obj_prv = tin[1 + nobj:]
        write_row(stats, k, k0, live,
                  as_row((k,) + tuple(tin[1:1 + nobj]) + (rs, F, Q, ibt, L),
                         rdt, dev))
        torch.where(live, torch.stack([tn, TTn, L, k + 1.0, k0, rs,
                                       obj_prv]), sc, out=sc)

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
        FFT kernels read it through their gate."""
        device_loop.stage("stopping test")
        if whole:
            head()
        with fft2_planar.gate(live.to(torch.float32), fcnt):
            body()
        if not whole:
            live.copy_(nxt)
        return live

    def body():
        device_loop.stage("step")
        (X, Y, grad, Zrb), (tn, TTn, L, obj_prv), (F, Q, ibt) = take(live)
        # fixed-point residual (sporco/pgm/pgm.py:696-702)
        device_loop.stage("objective")
        D = X - (Y if opts.monotone else Ys)
        objv = ((math.nan,) * nobj if opts.fast_solve else eval_obj(X))
        torch.stack(_as_reals([torch.sum(D * D)] + list(objv)
                              + [F, Q, ibt, tn, TTn, L, obj_prv], rdt, dev),
                    out=tin)
        device_loop.stage("scalar tail")
        tail_p()
        device_loop.stage("state")
        guarded_update(live, olds, [X, Y, Xs, grad, Zrb])

    def status():
        return torch.stack([(~live_now()).to(rdt), k - k0])

    def show(row):
        print(f"it {int(row[0])}  obj {row[1]:.4e}  rsdl {row[1 + nobj]:.3e}"
              f"  L {row[-1]:.3e}")

    return device_loop.Loop(
        T, step, status,
        lambda: torch.cat([sc, fcnt.to(rdt), stats.reshape(-1).to(rdt)]),
        lambda i, n: stats[i:i + n], show,
        start=None if whole else head)


def pgm_solve(prob, cfg, params, opts, state):
    """Run one (re-entrant) PGM solve call with fp32 contractions
    pinned; returns the final state."""
    with fp32_precision(), torch.no_grad():
        return _pgm_run(prob, cfg, params, opts, state)


def pgm_iterstats(names, state, k_start=0):
    """An :class:`IterStats` view of the rows of the most recent solve
    call, for objective columns ``names``."""
    return IterStats(stat_names(names), state.stats,
                     int(state.k) - int(k_start))
