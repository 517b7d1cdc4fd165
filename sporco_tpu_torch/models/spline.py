"""l1 spline fitting by ADMM, ``SplineL1`` (counterpart of
``sporco_tpu.models.spline``, ``sporco/admm/spline.py:24``):
``argmin_x ||W(x - s)||_1 + (lmbda/2)||D x||_2^2``, ``D`` the discrete
Laplacian on the chosen axes.  The x-step is an exact pointwise solve in
the DCT domain (garcia-2010-robust) through
:func:`sporco_tpu_torch.ops.fft.dctii`/``idctii``, its scaling recomputed
from rho every iteration (the reference's ``rhochange`` hook disappears).
"""

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from sporco_tpu_torch._device import resolve_device
from sporco_tpu_torch.models.common import (ADMMModel, user_tensor,
                                            warm_start)
from sporco_tpu_torch.ops import fft as sf
from sporco_tpu_torch.ops import linalg as sl
from sporco_tpu_torch.ops import prox as sp
from sporco_tpu_torch.solvers.admm import (ADMMOpts, ADMMProblem,
                                           AutoRhoOpts, const_div,
                                           init_state, scalar_type)

__all__ = ["SplineL1", "SplineConfig"]


@dataclass(frozen=True)
class SplineConfig:
    axes: Tuple[int, ...]
    sndim: int
    lin_check: bool = False
    g_eval_y: bool = True     # the reference's gEvalY


def _setup(cfg, params):
    S = params["S"]
    alpha = torch.zeros((1,) * cfg.sndim, dtype=S.dtype, device=S.device)
    for ax in cfg.axes:
        shp = [1] * cfg.sndim
        shp[ax] = S.shape[ax]
        axn = torch.arange(shp[ax], dtype=S.dtype,
                           device=S.device).reshape(shp)
        alpha = alpha + (-2.0 + 2.0 * torch.cos(axn * np.pi / shp[ax]))
    return {"alpha": alpha, "lmbda": scalar_type(S.dtype)(params["lmbda"])}


def _xstep(cfg, aux, params, state):
    lr = const_div(aux["lmbda"], state.rho)
    gamma = 1.0 / (1.0 + lr * aux["alpha"] ** 2)
    V = state.Y + params["S"] - state.U
    X = sf.idctii(gamma * sf.dctii(V, axes=cfg.axes), axes=cfg.axes)
    xaux = {}
    if cfg.lin_check:
        lhs = X + lr * sf.idctii(aux["alpha"] ** 2
                                 * sf.dctii(X, axes=cfg.axes), axes=cfg.axes)
        xaux["xrrs"] = sl.rrs(lhs, V)
    return X, xaux


def _ystep(cfg, aux, params, state, AXU):
    return sp.prox_l1(AXU - params["S"], params["Wdf"] / state.rho)


def _cnst_c(cfg, aux, params):
    return params["S"]


def _obfn(cfg, aux, params, state, xaux):
    gv = state.Y if cfg.g_eval_y else state.X - params["S"]
    dfd = torch.sum(torch.abs(params["Wdf"] * gv))
    reg = 0.5 * torch.sum((aux["alpha"] * sf.dctii(state.X, axes=cfg.axes))
                          ** 2)
    xr = xaux["xrrs"] if cfg.lin_check else np.nan
    return (dfd + float(aux["lmbda"]) * reg, dfd, reg, xr)


def _yinit(cfg, params):
    return torch.zeros_like(params["S"])


_STATS = ("ObjFun", "DFid", "Reg", "XSlvRelRes")

_SPLINE = ADMMProblem(setup=_setup, xstep=_xstep, ystep=_ystep,
                      obfn=_obfn, cnst_c=_cnst_c, yinit=_yinit,
                      uinit=_yinit, stat_names=_STATS)


class SplineL1(ADMMModel):
    r"""l1 spline: robust smoothing of ``S`` under a Laplacian penalty on
    ``axes``, the data term weighted by ``Wdf`` (the DFidWeight, e.g. 0
    where samples are known to be outliers).  Arguments are numpy arrays
    (or tensors); ``device=None`` means the CUDA device and raises
    without one, ``device="cpu"`` runs on the CPU.  Defaults as the
    reference: RelaxParam 1.8, rho = 2 lmbda + 0.1, AutoRho on with
    Period 1, AutoScaling, scaling 1000, RsdlRatio 1.2 and RsdlTarget 1.
    """

    STAT_NAMES = _STATS

    REF_OPT_EXTRA = {
        "gEvalY": ("k", "g_eval_y"),
        "DFidWeight": ("k", "Wdf"),
        "LinSolveCheck": ("k", "lin_check"),
    }

    @staticmethod
    def options(**kw):
        ar = kw.pop("auto_rho", AutoRhoOpts(enabled=True, period=1,
                                            auto_scaling=True,
                                            scaling=1000.0,
                                            rsdl_ratio=1.2,
                                            rsdl_target=1.0))
        base = dict(relax_param=1.8, auto_rho=ar)
        base.update(kw)
        return ADMMOpts(**base)

    def __init__(self, S, lmbda, opt=None, axes=(0, 1), Wdf=1.0,
                 lin_check=False, dtype=torch.float32, Y0=None, U0=None,
                 g_eval_y=True, device=None):
        super().__init__()
        self.device = dev = resolve_device(device)
        if opt is None:
            opt = self.options()
        dtype = sf.torch_dtype(dtype)
        S = user_tensor(S, dtype, dev)
        self.lmbda = lmbda
        self.cfg = SplineConfig(axes=tuple(axes), sndim=S.ndim,
                                lin_check=lin_check, g_eval_y=g_eval_y)
        self.opts = opt.replace(dtype=dtype)
        self.params = {"S": S, "lmbda": float(lmbda),
                       "Wdf": user_tensor(Wdf, dtype, dev)}
        self.problem = _SPLINE
        rho0 = opt.rho if opt.rho is not None else 2.0 * lmbda + 0.1
        rho_xi = (opt.auto_rho.rsdl_target
                  if opt.auto_rho.rsdl_target is not None else 1.0)
        self.state = init_state(
            self.problem, self.cfg, self.params, self.opts, rho0, rho_xi,
            Y0=warm_start(Y0, dtype, dev), U0=warm_start(U0, dtype, dev))
        self._init_done()

    def getmin(self):
        return self.state.X
