"""ADMM options, state and adaptive rho (counterpart of
``sporco_tpu.solvers.admm``).

The JAX package runs the whole loop on the device.  Here the loop runs
on the host in Python: the large arrays (X, Y, U) are tensors on the
solve's device, while the scalars of the state (rho, residuals,
tolerances, the iteration counter) and the per-iteration stats buffer
are host ``numpy.float32``/``int32`` values.  All scalar arithmetic is
done in float32, in the same order as the JAX package, so that the
AutoRho decisions and the stopping test match it.
"""

from dataclasses import dataclass, field, replace
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["AutoRhoOpts", "ADMMOpts", "ADMMState", "IterStats",
           "init_state", "iterstats", "stat_names"]

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
    """Full ADMM solver state.  ``X``/``Y``/``U`` are tensors on the
    solve's device; the rest are host scalars and the host stats buffer
    of shape ``(max_iter, nstat)``."""
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


def init_state(shpX, opts, rho0, rho_xi, device, nobj, Y0=None, U0=None):
    """A fresh :class:`ADMMState` for a problem whose X, Y and U have
    shape ``shpX`` (zeros unless ``Y0``/``U0`` are given) and whose
    stats rows hold ``nobj`` objective terms."""
    def zeros():
        return torch.zeros(shpX, dtype=opts.dtype, device=device)
    Y = zeros() if Y0 is None else Y0.to(device, opts.dtype)
    U = zeros() if U0 is None else U0.to(device, opts.dtype)
    nstat = 1 + nobj + 5
    return ADMMState(
        X=zeros(), Y=Y, U=U, rho=f32(rho0), rho_xi=f32(rho_xi),
        k=np.int32(0), r=f32(np.inf), s=f32(np.inf), epri=f32(0.0),
        edua=f32(0.0),
        stats=np.full((opts.max_iter, nstat), np.nan, np.float32))


def _update_rho(ar, k, r, s, rho, xi, U):
    """Adaptive rho (``sporco/admm/admm.py:549-575``): returns the new
    rho and ``U / rsf`` for a float32 scalar ``U`` (the fused driver
    defers the dual rescale to its factor ``us``)."""
    if not ar.enabled:
        return rho, U
    tau = f32(ar.scaling)
    mu = f32(ar.rsdl_ratio)
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
            rsf = f32(1.0) / rhomlt
        else:
            rsf = f32(1.0)
    if not on_period:
        rsf = f32(1.0)
    rsf = f32(rsf)
    return f32(rho * rsf), f32(U / rsf)


def norm_residuals(ar, opts, nc, nx, rnrm, snrm, rn, sn):
    """Normalised (or standard) residuals and their tolerances
    (``sporco/admm/admm.py:462-486``), in float32."""
    atol_c = f32(nc * opts.abs_stop_tol)
    atol_x = f32(nx * opts.abs_stop_tol)
    rtol = f32(opts.rel_stop_tol)
    with np.errstate(divide="ignore", invalid="ignore"):
        if ar.std_residuals:
            return (rnrm, snrm, atol_c + rn * rtol, atol_x + sn * rtol)
        rn_ = f32(1.0) if rn == 0.0 else rn
        sn_ = f32(1.0) if sn == 0.0 else sn
        return (rnrm / rn_, snrm / sn_, atol_c / rn_ + rtol,
                atol_x / sn_ + rtol)


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
