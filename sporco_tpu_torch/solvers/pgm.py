"""PGM / accelerated proximal-gradient (FISTA) options, state and loop
(counterpart of ``sporco_tpu.solvers.pgm``).

The iteration (gradient step, prox, momentum extrapolation), the
momentum strategies (Nesterov / linear / generalised-linear,
``sporco/pgm/momentum.py:47-130``), the step-size policies (Cauchy,
Barzilai-Borwein, ``sporco/pgm/stepsize.py:49-130``), the monotone
variant and both backtracking line searches (standard and robust,
``sporco/pgm/backtrack.py:49-180``) run as a loop on the host.  The
arrays of the state (X, Y, Xprv, Gprv, Zrb) are tensors on the solve's
device; its scalars (t, Tk, L, rsdl, objprv) are host numpy values of
the problem's real type (``float32``, or ``float64`` for a float64
problem, as the JAX package's ``rdt``), the counter an ``int32`` and the
stats buffer ``float32``.  Every scalar is computed in that type in the
JAX package's order, so that the momentum ``beta`` and the stopping test
match it to the last bit.
"""

from dataclasses import dataclass, replace
from typing import Any, Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from sporco_tpu_torch._device import fp32_precision
from sporco_tpu_torch.solvers.admm import IterStats, scalar_type

__all__ = ["PGMOpts", "PGMProblem", "PGMState", "pgm_solve",
           "pgm_init_state", "pgm_iterstats", "stat_names"]

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
        obfn(cfg, aux, params, X) -> tuple of float32 (stats columns)
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


def _host(x, ft=f32):
    """A 0-d tensor (or number) as a host scalar of type ``ft``."""
    return ft(x.item() if isinstance(x, torch.Tensor) else x)


def stop_tol(opts, k, ft=f32):
    """The stopping tolerance at iteration ``k`` (adaptive under
    ``auto_stop``), in the scalar type ``ft``."""
    if opts.auto_stop:
        return ft(opts.auto_stop_tau0) / (ft(1.0) + ft(k))
    return ft(opts.rel_stop_tol)


def _pgm_run(prob, cfg, params, opts, state):
    """Run (or resume) the loop from ``state``; returns the final
    state.  Stats row: ``[k, objective terms..., Rsdl, F_Btrack,
    Q_Btrack, IterBTrack, L]``."""
    aux = prob.setup(cfg, params)
    k0 = int(state.k)
    ft = scalar_type(opts.dtype)
    nanv = ft(np.nan)

    def host(x):
        return _host(x, ft)

    def dotp(a, b):
        return host(torch.sum(a * b))

    def norm(a):
        return ft(np.sqrt(host(torch.sum(a * a))))

    def eval_obj(X):
        if prob.obfn is not None:
            return tuple(host(v) for v in prob.obfn(cfg, aux, params, X))
        f = host(prob.obfn_f(cfg, aux, params, X))
        g = host(prob.obfn_g(cfg, aux, params, X))
        return (f + g, f, g)

    def step_to(Y, grad, L):
        return prob.prox_g(cfg, aux, params, Y - grad / float(L), L)

    def plain_step(st):
        grad = prob.grad_f(cfg, aux, params, st.Y)
        L = st.L
        if opts.stepsize == "cauchy":
            den = dotp(grad, grad)
            num = dotp(grad, prob.hessian_f(cfg, aux, params, grad))
            if st.k > 1:
                L = num / den
        elif opts.stepsize == "bb":
            dx = st.X - st.Xprv
            dg = grad - st.Gprv
            with np.errstate(divide="ignore", invalid="ignore"):
                Lbb = dotp(dg, dg) / dotp(dx, dg)
            if st.k > 1 and Lbb >= 0.0:
                L = Lbb
        X = step_to(st.Y, grad, L)
        objprv = st.objprv
        if opts.monotone:
            obj = eval_obj(X)[0]
            ZZ = X
            if st.k > 0 and objprv < obj:
                X, obj = st.X, objprv
            objprv = obj
        tprv = st.t
        t = _momentum_update(opts, st.t, st.k)
        c = float((tprv - ft(1.0)) / t)
        if opts.monotone:
            Y = X + float(tprv / t) * (ZZ - X) + c * (X - st.X)
        else:
            Y = X + c * (X - st.X)
        return st._replace(X=X, Y=Y, Xprv=st.X, Gprv=grad, t=t, L=ft(L),
                           objprv=objprv), (nanv, nanv, 0)

    def majorant(fY, X, Y, grad, L):
        Dxy = X - Y
        n = norm(Dxy)
        return fY + dotp(Dxy, grad) + (L / ft(2.0)) * (n * n)

    def bt_standard_step(st):
        grad = prob.grad_f(cfg, aux, params, st.Y)
        fY = host(prob.obfn_f(cfg, aux, params, st.Y))

        def trial(L):
            X = step_to(st.Y, grad, L)
            F = host(prob.obfn_f(cfg, aux, params, X))
            return X, F, majorant(fY, X, st.Y, grad, L)

        L = st.L
        X, F, Q = trial(L)
        ibt = 1
        while F > Q and ibt < opts.bt_maxiter:
            L = L * ft(opts.bt_gamma_u)
            X, F, Q = trial(L)
            ibt += 1
        tprv = st.t
        t = _momentum_update(opts, st.t, st.k)
        Y = X + float((tprv - ft(1.0)) / t) * (X - st.X)
        return st._replace(X=X, Y=Y, Xprv=st.X, Gprv=grad, t=t,
                           L=L), (F, Q, ibt)

    def bt_robust_step(st):
        def trial(L):
            t = (ft(1.0) + np.sqrt(ft(1.0) + ft(4.0) * L * st.Tk)) \
                / (ft(2.0) * L)
            T = st.Tk + t
            y = (float(st.Tk) * st.X + float(t) * st.Zrb) / float(T)
            grad = prob.grad_f(cfg, aux, params, y)
            X = step_to(y, grad, L)
            F = host(prob.obfn_f(cfg, aux, params, X))
            fy = host(prob.obfn_f(cfg, aux, params, y))
            return X, y, grad, F, majorant(fy, X, y, grad, L), t, T

        L = st.L * ft(opts.bt_gamma_d)
        X, y, grad, F, Q, t, T = trial(L)
        ibt = 1
        while F > Q and ibt < opts.bt_maxiter:
            L = L * ft(opts.bt_gamma_u)
            X, y, grad, F, Q, t, T = trial(L)
            ibt += 1
        Zrb = st.Zrb + float(t * L) * (X - y)
        return st._replace(X=X, Y=y, Xprv=st.X, Gprv=grad, Zrb=Zrb, t=t,
                           Tk=T, L=L), (F, Q, ibt)

    step = {"standard": bt_standard_step,
            "robust": bt_robust_step}.get(opts.backtrack, plain_step)
    st = state
    stats = np.array(st.stats, np.float32, copy=True)
    if stats.shape[0] != opts.max_iter:
        stats = np.full((opts.max_iter, stats.shape[1]), np.nan, np.float32)
    while int(st.k) - k0 < opts.max_iter and st.rsdl >= stop_tol(opts, st.k,
                                                                  ft):
        Yprv = st.Y
        st2, (F, Q, ibt) = step(st)
        rsdl = norm(st2.X - (st2.Y if opts.monotone else Yprv))
        objv = ((np.nan,) * len(prob.stat_names) if opts.fast_solve
                else eval_obj(st2.X))
        stats[int(st.k) - k0] = ((st.k,) + tuple(objv)
                                 + (rsdl, F, Q, ibt, st2.L))
        if opts.verbose:
            print(f"it {int(st.k)}  obj {stats[int(st.k) - k0, 1]:.4e}  "
                  f"rsdl {rsdl:.3e}  L {st2.L:.3e}")
        st = st2._replace(k=np.int32(st.k + 1), rsdl=rsdl)
    return st._replace(stats=stats)


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
