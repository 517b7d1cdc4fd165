"""Convolutional sparse coding via ADMM: ``ConvBPDN`` (counterpart of
``sporco_tpu.models.cbpdn``).

This slice ports the ``l1`` variant on the fused spatial-Woodbury driver
(:mod:`sporco_tpu_torch.ops.fused_csc`): real single-channel 2-D
problems with a scalar or per-filter ``L1Weight``.  Every other
configuration raises :class:`NotImplementedError` naming the ROADMAP
item that will port it; there is no silent generic path.
"""

from dataclasses import dataclass

import numpy as np
import torch

from sporco_tpu_torch import cnvrep as cr
from sporco_tpu_torch import refopts
from sporco_tpu_torch._device import fp32_precision, resolve_device
from sporco_tpu_torch.models.common import ADMMModel, default_rho_xi
from sporco_tpu_torch.ops import fft as sf
from sporco_tpu_torch.ops import fused_csc
from sporco_tpu_torch.solvers.admm import ADMMOpts, AutoRhoOpts, init_state

__all__ = ["ConvBPDN", "CSCConfig", "params_from_numpy", "reconstruct"]


@dataclass(frozen=True)
class CSCConfig:
    cri: cr.CSCIndex
    variant: str = "l1"
    non_neg: bool = False
    no_bndry: bool = False
    obj_from_x: bool = True
    lin_check: bool = False
    real: bool = True


def _max_abs_dhs(Di, Si, Nv):
    """``max |D^H S|`` for the default lmbda heuristic
    (``sporco/admm/cbpdn.py:573-578``)."""
    axes = tuple(range(-len(Nv), 0))
    Df = sf.rfftn(Di, s=Nv, axes=axes)
    Sf = sf.rfftn(Si, axes=axes)
    return float(torch.max(torch.abs(Df.conj() * Sf)))


def params_from_numpy(D, S, lmbda=None, wl1=1.0, dimK=None, dimN=2,
                      device="cpu", dtype=torch.float32):
    """The port's problem from the same user-shaped arrays the JAX
    constructor takes.  Returns ``(cri, params, real)``: ``params`` holds
    the internal-layout ``D``/``S`` and ``wl1`` as float32 tensors on
    ``device``, and ``lmbda`` as a number (defaulting to
    ``0.1 max|D^H S|``)."""
    D = np.asarray(D)
    S = np.asarray(S)
    real = not (np.iscomplexobj(D) or np.iscomplexobj(S))
    cri = cr.csc_index(D.shape, S.shape, dimK=dimK, dimN=dimN)
    if not real:
        return cri, None, False
    dev = torch.device(device)
    Di = cr.to_internal_D(torch.as_tensor(D.astype(np.float32)),
                          cri).contiguous().to(dev, dtype)
    Si = cr.to_internal_S(torch.as_tensor(S.astype(np.float32)),
                          cri).contiguous().to(dev, dtype)
    if lmbda is None:
        with fp32_precision():
            lmbda = 0.1 * _max_abs_dhs(Di, Si, cri.Nv)
    wl1a = torch.as_tensor(np.asarray(wl1, np.float32))
    if wl1a.ndim > 0:
        wl1a = cr.l1_weight(wl1a, cri)
    params = {"D": Di, "S": Si, "lmbda": float(lmbda), "wl1": wl1a.to(dev)}
    return cri, params, True


class ConvBPDN(ADMMModel):
    r"""ADMM CSC solver: ``argmin_x (1/2)||sum_m d_m * x_m - s||_2^2
    + lmbda sum_m ||x_m||_1`` (``sporco/admm/cbpdn.py:386``).

    ``D`` has user shape ``dsz + (M,)``, ``S`` has ``Nv + [K]``; the
    returned coefficient array has the reference's layout
    ``Nv + (1, K, M)``.  Arguments are numpy arrays (or anything
    ``numpy.asarray`` takes).  ``device=None`` means the CUDA device and
    raises if there is none; pass ``device="cpu"`` for the CPU, where the
    kernel runs as its plain PyTorch version.

    Defaults mirror the reference: RelaxParam 1.8, AutoRho enabled with
    Period 1 + AutoScaling, rho = 50 lmbda + 1, lmbda = 0.1 max|D^H S|.
    """

    VARIANT = "l1"
    STAT_NAMES = ("ObjFun", "DFid", "RegL1", "XSlvRelRes")

    REF_OPT_EXTRA = {
        **refopts._ADMM_EQUAL,
        "AuxVarObj": ("k", "obj_from_x", refopts._not),
        "HighMemSolve": refopts.IGNORE,
        "LinSolveCheck": ("k", "lin_check"),
        "NonNegCoef": ("k", "non_neg"),
        "NoBndryCross": ("k", "no_bndry"),
        "L1Weight": ("k", "wl1"),
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

    def __init__(self, D, S, lmbda=None, opt=None, dimK=None, dimN=2,
                 wl1=1.0, non_neg=False, no_bndry=False, lin_check=False,
                 dtype=torch.float32, Y0=None, U0=None, fused="auto",
                 obj_from_x=True, device=None):
        super().__init__()
        self.device = resolve_device(device)
        if opt is None:
            opt = self.options()
        if fused is False:
            raise NotImplementedError(
                "fused=False selects the generic ConvBPDN path, which is "
                "not ported yet (ROADMAP queue 1, item 7)")
        if not isinstance(dtype, torch.dtype):
            dtype = getattr(torch, np.dtype(dtype).name)
        self.opts = opt.replace(dtype=dtype)
        cri, params, real = params_from_numpy(D, S, lmbda, wl1, dimK, dimN,
                                              self.device)
        self.cri = cri
        self.cfg = CSCConfig(cri=cri, variant=self.VARIANT,
                             non_neg=non_neg, no_bndry=no_bndry,
                             lin_check=lin_check, real=real,
                             obj_from_x=obj_from_x)
        if not real:
            raise NotImplementedError(fused_csc.unsupported_reason(
                self.cfg, {}, self.opts))
        reason = fused_csc.unsupported_reason(self.cfg, params, self.opts,
                                              force=fused is True)
        if reason is not None:
            raise NotImplementedError(reason)
        self.params = params
        self.lmbda = lm = params["lmbda"]
        rho0 = opt.rho if opt.rho is not None else 50.0 * lm + 1.0
        rho_xi = (opt.auto_rho.rsdl_target
                  if opt.auto_rho.rsdl_target is not None
                  else default_rho_xi(lm))

        def internal_x(A):
            if A is None:
                return None
            return cr.to_internal_X(torch.as_tensor(
                np.asarray(A, np.float32)), cri).contiguous()
        self.state = init_state(cri.shpX, self.opts, rho0, rho_xi,
                                self.device, len(self.STAT_NAMES),
                                Y0=internal_x(Y0), U0=internal_x(U0))
        self._init_done()

    def _solve_state(self):
        return fused_csc.cbpdn_solve(self.cfg, self.params, self.opts,
                                     self.state)

    def getmin(self):
        return cr.from_internal_X(self.state.Y, self.cri)

    def reconstruct(self, X=None):
        """Reconstruct ``sum_m d_m * x_m`` in the user S layout
        ``Nv + [K]``."""
        return reconstruct(self.params["D"], self.state.Y, self.cri, X)


def reconstruct(Di, Xi, cri, X=None):
    """``sum_m d_m * x_m`` in the user S layout ``Nv + [K]`` for the
    internal dictionary ``Di`` and coefficients ``Xi``, or the
    reference-layout coefficients ``X`` when given."""
    if X is not None:
        Xi = cr.to_internal_X(torch.as_tensor(np.asarray(X, np.float32)),
                              cri).to(Di.device)
    axes = (-2, -1)
    with fp32_precision():
        Df = sf.rfftn(Di, s=cri.Nv, axes=axes)
        Xf = sf.rfftn(Xi, axes=axes)
        Si = sf.irfftn(torch.sum(Df * Xf, dim=2, keepdim=True), s=cri.Nv,
                       axes=axes)
    S = Si[:, 0, 0].permute(1, 2, 0)              # Nv + (K,)
    return S[..., 0] if cri.dimK == 0 else S
