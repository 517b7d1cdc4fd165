"""CSC with lateral and self inhibition, ``ConvBPDNInhib`` (counterpart of
``sporco_tpu.models.cbpdnin``, ``sporco/admm/cbpdnin.py:28``).

ConvBPDN plus the weighted l1 terms ``mu sum_m w_m^T |y_m|`` (lateral
inhibition within groups of filters) and ``gamma sum_m z_m^T |y_m|``
(self inhibition), whose weights are windowed convolutions of ``|X|``,
recomputed and exponentially smoothed every iteration
(``cbpdnin.py:294-345``).  The smoothed weights are the generic
driver's extra carry: its ``update_extra`` hook recomputes them after
the u-step, before the residuals and the objective, whose ``RegLat`` and
``RegSelf`` rows read the new weights.  An iteration transforms
``Y - U`` and ``|X|`` forward and ``X`` and the windowed activity
(lateral and self, as enabled) back: 2-D float32 transforms at the
sizes :mod:`sporco_tpu_torch.ops.fft` dispatches run
``rfft2_planar``/``irfft2_planar``.
"""

from dataclasses import dataclass

import numpy as np
import torch

from sporco_tpu_torch import cnvrep as cr
from sporco_tpu_torch import refopts
from sporco_tpu_torch._device import fp32_precision, resolve_device
from sporco_tpu_torch.models.cbpdn import (CSCConfig, _apply_masks,
                                           _max_abs_dhs, host_array)
from sporco_tpu_torch.models.common import (ADMMModel, default_rho_xi,
                                            warm_start)
from sporco_tpu_torch.ops import fft as sf
from sporco_tpu_torch.ops import linalg as sl
from sporco_tpu_torch.ops import prox as sp
from sporco_tpu_torch.solvers.admm import (ADMMOpts, ADMMProblem,
                                           AutoRhoOpts, init_state,
                                           scalar_type)

__all__ = ["ConvBPDNInhib", "InhibConfig"]


@dataclass(frozen=True)
class InhibConfig:
    cri: cr.CSCIndex
    non_neg: bool = False
    no_bndry: bool = False
    use_lat: bool = True
    use_self: bool = False
    smooth: float = 0.9


def _fftaxes(cri):
    return tuple(range(-cri.dimN, 0))


def _setup(cfg, params):
    cri = cfg.cri
    axes = _fftaxes(cri)
    Df = sf.rfftn(params["D"], s=cri.Nv, axes=axes)
    Sf = sf.rfftn(params["S"], axes=axes)
    DSf = Df.conj() * Sf
    if cri.Cd > 1:
        DSf = torch.sum(DSf, dim=1, keepdim=True)
    ft = scalar_type(params["D"].dtype)
    return {"Df": Df, "Sf": Sf, "DSf": DSf,
            **{k: ft(params[k]) for k in ("lmbda", "mu", "gamma")}}


def _xstep(cfg, aux, params, state):
    cri = cfg.cri
    axes = _fftaxes(cri)
    rho = state.rho
    b = aux["DSf"] + rho * sf.rfftn(state.Y - state.U, axes=axes)
    if cri.Cd == 1:
        Xf = sl.solvedbi_sm(aux["Df"], rho, b, axis=2)
    else:
        Xf = sl.solvemdbi_ism(aux["Df"], rho, b, axisM=2, axisK=1)
    return sf.irfftn(Xf, s=cri.Nv, axes=axes), {"Xf": Xf}


def _ystep(cfg, aux, params, state, AXU):
    wml, wms = state.extra
    thresh = (float(aux["lmbda"]) * params["wl1"] + float(aux["mu"]) * wml
              + float(aux["gamma"]) * wms) / state.rho
    Y = sp.prox_l1(AXU, thresh)
    return _apply_masks(CSCConfig(cri=cfg.cri, non_neg=cfg.non_neg,
                                  no_bndry=cfg.no_bndry), Y)


def _group_sum(v, Wg):
    """``sum_m Wg[g, m] v[:, :, m]`` on the filter axis 2, over the
    groups ``g`` of ``Wg`` (Ng, M): ``(K, C, Ng, ...)``."""
    return torch.movedim(torch.tensordot(v, Wg, dims=([2], [1])), -1, 2)


def _update_extra(cfg, aux, params, state, xaux):
    """The smoothed inhibition weights from ``|X|``
    (``sporco/admm/cbpdnin.py:310-340``): lateral, the windowed activity
    of the other members of each filter's groups; self, its own."""
    cri = cfg.cri
    axes = _fftaxes(cri)
    wml, wms = state.extra
    Xaf = sf.rfftn(torch.abs(state.X), axes=axes)
    sm = cfg.smooth
    if cfg.use_lat:
        WhXal = sf.irfftn(params["Whfl"] * Xaf, s=cri.Nv, axes=axes)
        Wg = params["Wg"]
        grp = _group_sum(WhXal, Wg)                     # (K, C, Ng, ...)
        wml_new = _group_sum(grp, Wg.T) - torch.sum(Wg, dim=0).reshape(
            (1, 1, -1) + (1,) * cri.dimN) * WhXal
        wml = sm * wml + (1 - sm) * wml_new
    if cfg.use_self:
        wms_new = sf.irfftn(params["Whfs"] * Xaf, s=cri.Nv, axes=axes)
        wms = sm * wms + (1 - sm) * wms_new
    return (wml, wms)


def _obfn(cfg, aux, params, state, xaux):
    cri = cfg.cri
    dfd = 0.5 * sf.rfl2norm2(
        torch.sum(aux["Df"] * xaux["Xf"], dim=2, keepdim=True) - aux["Sf"],
        cri.Nv, axis=_fftaxes(cri))
    gv = state.X
    wml, wms = state.extra
    rl1 = torch.sum(torch.abs(params["wl1"] * gv))
    rlat = torch.sum(wml * torch.abs(gv))
    rself = torch.sum(wms * torch.abs(gv))
    return (dfd + float(aux["lmbda"]) * rl1 + float(aux["mu"]) * rlat
            + float(aux["gamma"]) * rself, dfd, rl1, rlat, rself)


def _yinit(cfg, params):
    S = params["S"]
    return torch.zeros(cfg.cri.shpX, dtype=S.dtype, device=S.device)


def _extra_init(cfg, params):
    return (_yinit(cfg, params), _yinit(cfg, params))


_STATS = ("ObjFun", "DFid", "RegL1", "RegLat", "RegSelf")

_INHIB = ADMMProblem(setup=_setup, xstep=_xstep, ystep=_ystep, obfn=_obfn,
                     yinit=_yinit, uinit=_yinit, extra_init=_extra_init,
                     update_extra=_update_extra, stat_names=_STATS)


def _make_window(Nv, dimN, Whn, win_args, dtype, device):
    """The spectra of the inhibition window (a Tukey window by default)
    centred at the origin with diameter ``Whn`` (made odd), and of its
    variant with a zero centre (``sporco/admm/cbpdnin.py:150-175``), as
    complex tensors of the complex type of ``dtype`` on ``device``."""
    from scipy.signal import get_window
    Whn += int(not Whn % 2)
    w1 = np.asarray(get_window(win_args, Whn))
    grids = np.meshgrid(*([w1] * dimN))
    wnd = np.power(np.prod(np.stack(grids, 0), axis=0), 1.0 / dimN)
    Whl = np.zeros(Nv)
    Whl[tuple(slice(0, Whn) for _ in range(dimN))] = wnd
    for i in range(dimN):
        Whl = np.roll(Whl, -Whn // 2 + 1, axis=i)
    Whs = Whl.copy()
    Whs[(0,) * dimN] = 0.0
    cdt = sf.complex_dtype(dtype)

    def spec(w):
        wf = np.fft.rfftn(w, axes=tuple(range(dimN)))
        return torch.as_tensor(wf.astype(sf.numpy_dtype(cdt))).to(device)
    return spec(Whl), spec(Whs)


class ConvBPDNInhib(ADMMModel):
    r"""CSC with lateral and/or self inhibition
    (``sporco/admm/cbpdnin.py:28``).  ``Wg`` is the (Ng, M) matrix of the
    filter groups (lateral inhibition is on where it is given and ``mu``
    is not 0); ``Whn`` the window's diameter (the filters' first size by
    default) and ``win_args`` its ``scipy.signal.get_window`` argument
    (Tukey 0.5 by default); ``mu`` and ``gamma`` the lateral and self
    inhibition weights (``10 lmbda`` and 0 by default, self inhibition on
    where ``gamma`` is not 0).  Arguments are numpy arrays (or tensors);
    ``device=None`` means the CUDA device and raises without one,
    ``device="cpu"`` runs on the CPU.  Defaults as the reference:
    RelaxParam 1.8, AutoRho with Period 1 and AutoScaling, rho = 50
    lmbda + 1, lmbda = 0.1 max|D^H S|, SmoothWeight 0.9."""

    STAT_NAMES = _STATS

    REF_OPT_EXTRA = {
        **refopts._ADMM_EQUAL,
        "AuxVarObj": refopts.IGNORE,
        "HighMemSolve": refopts.IGNORE,
        "LinSolveCheck": refopts.WARN,
        "NonNegCoef": ("k", "non_neg"),
        "NoBndryCross": ("k", "no_bndry"),
        "L1Weight": ("k", "wl1"),
        "SmoothWeight": ("k", "smooth"),
    }

    @staticmethod
    def options(**kw):
        ar = kw.pop("auto_rho", AutoRhoOpts(enabled=True, period=1,
                                            auto_scaling=True,
                                            scaling=1000.0,
                                            rsdl_ratio=1.2))
        base = dict(relax_param=1.8, auto_rho=ar)
        base.update(kw)
        return ADMMOpts(**base)

    def __init__(self, D, S, Wg=None, Whn=None, win_args=None,
                 lmbda=None, mu=None, gamma=None, opt=None, dimK=None,
                 dimN=2, wl1=1.0, non_neg=False, no_bndry=False,
                 smooth=0.9, dtype=torch.float32, Y0=None, U0=None,
                 device=None):
        super().__init__()
        self.device = dev = resolve_device(device)
        if opt is None:
            opt = self.options()
        dtype = sf.torch_dtype(dtype)
        npdt = sf.numpy_dtype(dtype)
        D = host_array(D).astype(npdt)
        S = host_array(S).astype(npdt)
        cri = cr.csc_index(D.shape, S.shape, dimK=dimK, dimN=dimN)
        self.cri = cri
        Di = cr.to_internal_D(torch.as_tensor(D), cri).contiguous().to(dev)
        Si = cr.to_internal_S(torch.as_tensor(S), cri).contiguous().to(dev)
        if lmbda is None:
            with fp32_precision():
                lmbda = 0.1 * _max_abs_dhs(Di, Si, cri.Nv)
        if mu is None:
            mu = 10.0 * lmbda
        if gamma is None:
            gamma = 0.0
        self.lmbda = lmbda
        self.cfg = InhibConfig(cri=cri, non_neg=non_neg, no_bndry=no_bndry,
                               use_lat=Wg is not None and mu != 0,
                               use_self=gamma != 0, smooth=smooth)
        self.opts = opt.replace(dtype=dtype)
        if Whn is None:
            Whn = D.shape[0]
        if win_args is None:
            win_args = ("tukey", 0.5)
        Whfl, Whfs = _make_window(cri.Nv, dimN, int(Whn), win_args,
                                  dtype, dev)
        wl1a = torch.as_tensor(np.asarray(wl1, npdt))
        if wl1a.ndim > 0:
            wl1a = cr.l1_weight(wl1a, cri)
        Wg = np.zeros((1, cri.M), npdt) if Wg is None \
            else host_array(Wg).astype(npdt)
        self.params = {"D": Di, "S": Si, "lmbda": float(lmbda),
                       "mu": float(mu), "gamma": float(gamma),
                       "wl1": wl1a.to(dev),
                       "Wg": torch.as_tensor(Wg).to(dev),
                       "Whfl": Whfl, "Whfs": Whfs}
        self.problem = _INHIB
        rho0 = opt.rho if opt.rho is not None else 50.0 * lmbda + 1.0
        rho_xi = (opt.auto_rho.rsdl_target
                  if opt.auto_rho.rsdl_target is not None
                  else default_rho_xi(lmbda))
        self.state = init_state(self.problem, self.cfg, self.params,
                                self.opts, rho0, rho_xi,
                                Y0=warm_start(Y0, dtype, dev),
                                U0=warm_start(U0, dtype, dev))
        self._init_done()

    def getmin(self):
        return cr.from_internal_X(self.state.Y, self.cri)

    def getcoef(self):
        return self.getmin()
