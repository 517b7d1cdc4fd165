"""Convolutional sparse coding via ADMM: ``ConvBPDN``, ``ConvElasticNet``
and ``ConvBPDNGradReg`` (counterpart of ``sporco_tpu.models.cbpdn``).

Each variant (``l1``, ``elastic``, ``gradreg``) runs two ways, routed as
the JAX package routes them:

- the fused spatial-Woodbury driver (:mod:`sporco_tpu_torch.ops.fused_csc`)
  for real single-channel 2-D float32 problems: ``l1`` and ``elastic``
  with a scalar or per-filter ``L1Weight`` through the CUDA kernel
  ``csc_iter``; ``gradreg``, and any variant with a spatially varying
  ``L1Weight``, through the driver's ``body`` (a per-bin x-step for
  ``gradreg``, whose transforms run ``rfft2_planar``/``irfft2_planar``,
  then the tail kernel ``admm_tail`` or its torch ops);
- the generic DFT-domain ADMM problem (``_csc_*`` below) on the generic
  driver :func:`sporco_tpu_torch.solvers.admm.admm_solve` for every other
  single-channel-dictionary configuration (``fused=False``,
  ``no_bndry``, ``lin_check``, ``obj_from_x=False``, float64, complex
  inputs, other sizes, large supports, any K and C, 1-3 spatial dims).
  Its x-step is one forward and one inverse 2-D FFT per iteration, which
  run the CUDA kernels ``rfft2_planar``/``irfft2_planar`` where
  :mod:`sporco_tpu_torch.ops.fft` dispatches them.

Colour dictionaries and channel folding on the fused driver raise
:class:`NotImplementedError` naming the ROADMAP item that will port
them; there is no silent fallback.
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
from sporco_tpu_torch.ops import linalg as sl
from sporco_tpu_torch.ops import prox as sp
from sporco_tpu_torch.solvers.admm import (ADMMOpts, ADMMProblem,
                                           AutoRhoOpts, init_state,
                                           scalar_type)
from sporco_tpu_torch.utils.signal import gradient_filters

__all__ = ["ConvBPDN", "ConvElasticNet", "ConvBPDNGradReg", "CSCConfig",
           "params_from_numpy", "reconstruct"]


@dataclass(frozen=True)
class CSCConfig:
    cri: cr.CSCIndex
    variant: str = "l1"       # l1 | elastic | gradreg
    non_neg: bool = False
    no_bndry: bool = False
    obj_from_x: bool = True
    lin_check: bool = False
    real: bool = True


# ---------------------------------------------------------------------------
# The generic DFT-domain problem (``sporco/admm/cbpdn.py:267-311``)

def _fftaxes(cri):
    return tuple(range(-cri.dimN, 0))


def _fwd(cfg):
    return sf.rfftn if cfg.real else sf.fftn


def _inv(cfg, xf, Nv, axes):
    if cfg.real:
        return sf.irfftn(xf, s=Nv, axes=axes)
    return sf.ifftn(xf, s=Nv, axes=axes)


def _pnorm2(cfg, xf, Nv, axes):
    """Parseval norm matching the bound transform family."""
    if cfg.real:
        return sf.rfl2norm2(xf, Nv, axis=axes)
    return sf.fl2norm2(xf, axis=axes)


def _csc_setup(cfg, params):
    cri = cfg.cri
    axes = _fftaxes(cri)
    Df = _fwd(cfg)(params["D"], s=cri.Nv, axes=axes)
    Sf = _fwd(cfg)(params["S"], axes=axes)
    # rho-independent per-bin dictionary energy for the SM solve
    DHD = torch.sum((Df * Df.conj()).real, dim=2, keepdim=True)
    ft = scalar_type(params["D"].dtype)
    aux = {"Df": Df, "Sf": Sf, "DSf": Df.conj() * Sf, "DHD": DHD,
           "lmbda": ft(params["lmbda"]), "mu": ft(params["mu"])}
    if cfg.variant == "gradreg":
        _, GHGf = gradient_filters(cri.dimN, cri.Nv,
                                   dtype=params["D"].dtype,
                                   device=params["D"].device)
        aux["GHGfW"] = params["wgrd"] * GHGf
    return aux


def _sm_solve(cfg, aux, rho, b):
    """Per-bin solve of ``(rho I + D^H D) x = b`` over the filter axis
    (single-channel dictionary, ``sporco/admm/cbpdn.py:275-293``)."""
    return sl.solvedbi_sm(aux["Df"], rho, b, axis=2, aah=aux["DHD"])


def _xrrs(cfg, aux, Xf, b, diag):
    """Inner linear-solve relative residual (LinSolveCheck,
    ``sporco/admm/cbpdn.py:283-293``) of ``(diag + D^H D) Xf = b``."""
    Df = aux["Df"]
    DXf = torch.sum(Df * Xf, dim=2, keepdim=True)
    return sl.rrs(Df.conj() * DXf + diag * Xf, b)


def _csc_xstep(cfg, aux, params, state):
    cri = cfg.cri
    axes = _fftaxes(cri)
    rho = state.rho
    b = aux["DSf"] + float(rho) * _fwd(cfg)(state.Y - state.U, axes=axes)
    if cfg.variant == "elastic":
        # (rho + mu) I + D^H D (sporco/admm/cbpdn.py:948-975)
        diag = float(rho + aux["mu"])
        Xf = _sm_solve(cfg, aux, diag, b)
    elif cfg.variant == "gradreg":
        # the diagonal mu GHGfW + rho (sporco/admm/cbpdn.py:1173-1201)
        diag = float(aux["mu"]) * aux["GHGfW"] + float(rho)
        Xf = sl.solvedbd_sm(aux["Df"], diag, b, axis=2)
    else:
        diag = float(rho)
        Xf = _sm_solve(cfg, aux, diag, b)
    X = _inv(cfg, Xf, cri.Nv, axes)
    xaux = {"Xf": Xf}
    if cfg.lin_check:
        xaux["xrrs"] = _xrrs(cfg, aux, Xf, b, diag)
    return X, xaux


def _apply_masks(cfg, Y):
    """NonNegCoef and NoBndryCross on the coefficient maps."""
    if cfg.non_neg:
        if Y.is_complex():      # jnp.maximum(Y, 0): lexicographic order
            pos = (Y.real > 0) | ((Y.real == 0) & (Y.imag > 0))
            Y = torch.where(pos, Y, 0)
        else:
            Y = torch.clamp(Y, min=0.0)
    if cfg.no_bndry:
        Y = Y.clone()
        for n in range(cfg.cri.dimN):
            end = cfg.cri.dsz[n] - 1
            if end > 0:
                ax = Y.ndim - cfg.cri.dimN + n
                Y.narrow(ax, Y.shape[ax] - end, end).zero_()
    return Y


def _csc_ystep(cfg, aux, params, state, AXU):
    thr = float(aux["lmbda"] / state.rho)
    return _apply_masks(cfg, sp.prox_l1(AXU, thr * params["wl1"]))


def _csc_dfd(cfg, aux, fvarf):
    """Data fidelity ``(1/2)||sum_m d_m * x_m - s||^2`` in the DFT domain
    with Parseval correction (``sporco/admm/cbpdn.py:337``)."""
    DXf = torch.sum(aux["Df"] * fvarf, dim=2, keepdim=True)
    return 0.5 * _pnorm2(cfg, DXf - aux["Sf"], cfg.cri.Nv,
                         _fftaxes(cfg.cri))


def _csc_obfn(cfg, aux, params, state, xaux):
    if cfg.obj_from_x:
        fvarf, gvar = xaux["Xf"], state.X
    else:
        fvarf = _fwd(cfg)(state.Y, axes=_fftaxes(cfg.cri))
        gvar = state.Y
    dfd = _csc_dfd(cfg, aux, fvarf)
    rl1 = torch.sum(torch.abs(params["wl1"] * gvar))
    xr = xaux["xrrs"] if cfg.lin_check else np.nan
    lmbda, mu = float(aux["lmbda"]), float(aux["mu"])
    if cfg.variant == "elastic":
        rl2 = 0.5 * torch.sum(gvar ** 2)
        return (dfd + lmbda * rl1 + mu * rl2, dfd, rl1, rl2, xr)
    if cfg.variant == "gradreg":
        rgr = 0.5 * sf.rfl2norm2(torch.sqrt(aux["GHGfW"]) * fvarf,
                                 cfg.cri.Nv, axis=_fftaxes(cfg.cri))
        return (dfd + lmbda * rl1 + mu * rgr, dfd, rl1, rgr, xr)
    return (dfd + lmbda * rl1, dfd, rl1, xr)


def _csc_yinit(cfg, params):
    return torch.zeros(cfg.cri.shpX, dtype=params["S"].dtype,
                       device=params["S"].device)


_STATS = {
    "l1": ("ObjFun", "DFid", "RegL1", "XSlvRelRes"),
    "elastic": ("ObjFun", "DFid", "RegL1", "RegL2", "XSlvRelRes"),
    "gradreg": ("ObjFun", "DFid", "RegL1", "RegGrad", "XSlvRelRes"),
}

_CSC_PROBLEMS = {
    v: ADMMProblem(setup=_csc_setup, xstep=_csc_xstep, ystep=_csc_ystep,
                   obfn=_csc_obfn, yinit=_csc_yinit, uinit=_csc_yinit,
                   stat_names=names)
    for v, names in _STATS.items()
}


def _max_abs_dhs(Di, Si, Nv):
    """``max |D^H S|`` for the default lmbda heuristic
    (``sporco/admm/cbpdn.py:573-578``)."""
    axes = tuple(range(-len(Nv), 0))
    if Di.is_complex() or Si.is_complex():
        Df = sf.fftn(Di, s=Nv, axes=axes)
        Sf = sf.fftn(Si, axes=axes)
    else:
        Df = sf.rfftn(Di, s=Nv, axes=axes)
        Sf = sf.rfftn(Si, axes=axes)
    return float(torch.max(torch.abs(Df.conj() * Sf)))


def _np_dtype(dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def _wgrd_internal(wgrd, cri, npdt):
    """GradWeight as a real array; a per-filter vector broadcasts on the
    M axis."""
    w = torch.as_tensor(np.asarray(wgrd, npdt))
    if w.ndim == 1:
        w = w.reshape((1, 1, w.shape[0]) + (1,) * cri.dimN)
    return w


def params_from_numpy(D, S, lmbda=None, wl1=1.0, dimK=None, dimN=2,
                      device=None, dtype=torch.float32, mu=0.0, wgrd=1.0):
    """The port's problem from the same user-shaped arrays the JAX
    constructor takes.  Returns ``(cri, params, real)``: ``params`` holds
    the internal-layout ``D``/``S`` in ``dtype`` (its complex counterpart
    when ``D`` or ``S`` is complex) and ``wl1`` and ``wgrd`` (GradWeight)
    in the real type, as tensors on ``device`` (``None``: the CUDA
    device, as for the models), and ``lmbda`` and ``mu`` as numbers
    (``lmbda`` defaulting to ``0.1 max|D^H S|``)."""
    D = np.asarray(D)
    S = np.asarray(S)
    real = not (np.iscomplexobj(D) or np.iscomplexobj(S))
    if not real:
        dtype = sf.complex_dtype(dtype)
    npdt = _np_dtype(dtype)
    cri = cr.csc_index(D.shape, S.shape, dimK=dimK, dimN=dimN)
    dev = resolve_device(device)
    Di = cr.to_internal_D(torch.as_tensor(D.astype(npdt)),
                          cri).contiguous().to(dev)
    Si = cr.to_internal_S(torch.as_tensor(S.astype(npdt)),
                          cri).contiguous().to(dev)
    if lmbda is None:
        with fp32_precision():
            lmbda = 0.1 * _max_abs_dhs(Di, Si, cri.Nv)
    rdt = sf.real_dtype(dtype)
    wl1a = torch.as_tensor(np.asarray(wl1, _np_dtype(rdt)))
    if wl1a.ndim > 0:
        wl1a = cr.l1_weight(wl1a, cri)
    params = {"D": Di, "S": Si, "lmbda": float(lmbda), "wl1": wl1a.to(dev),
              "mu": float(mu),
              "wgrd": _wgrd_internal(wgrd, cri, _np_dtype(rdt)).to(dev)}
    return cri, params, real


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
    STAT_NAMES = _STATS["l1"]

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
                 wl1=1.0, mu=0.0, wgrd=1.0, non_neg=False, no_bndry=False,
                 lin_check=False, dtype=torch.float32, Y0=None, U0=None,
                 fused="auto", obj_from_x=True, device=None):
        super().__init__()
        self.device = resolve_device(device)
        if opt is None:
            opt = self.options()
        if not isinstance(dtype, torch.dtype):
            dtype = getattr(torch, np.dtype(dtype).name)
        cri, params, real = params_from_numpy(D, S, lmbda, wl1, dimK, dimN,
                                              self.device, dtype, mu=mu,
                                              wgrd=wgrd)
        dtype = params["S"].dtype
        self.opts = opt.replace(dtype=dtype)
        self.cri = cri
        self.cfg = CSCConfig(cri=cri, variant=self.VARIANT,
                             non_neg=non_neg, no_bndry=no_bndry,
                             lin_check=lin_check, real=real,
                             obj_from_x=obj_from_x)
        self.params = params
        self.lmbda = lm = params["lmbda"]
        self.problem = _CSC_PROBLEMS[self.VARIANT]
        self._fused_solve = self._route(fused)
        rho0 = opt.rho if opt.rho is not None else 50.0 * lm + 1.0
        rho_xi = (opt.auto_rho.rsdl_target
                  if opt.auto_rho.rsdl_target is not None
                  else default_rho_xi(lm))

        def internal_x(A):
            if A is None:
                return None
            return cr.to_internal_X(torch.as_tensor(
                np.asarray(A).astype(_np_dtype(dtype))), cri) \
                .contiguous().to(self.device)
        self.state = init_state(self.problem, self.cfg, self.params,
                                self.opts, rho0, rho_xi, Y0=internal_x(Y0),
                                U0=internal_x(U0))
        self._init_done()

    def _route(self, fused):
        """The fused driver's solve function, or None for the generic
        path, chosen as ``sporco_tpu.models.cbpdn.ConvBPDN.solve`` chooses:
        the fused driver for what ``eligible`` takes (directly or by
        channel folding), the generic path otherwise and always under
        ``fused=False``; ``fused=True`` on any other configuration raises
        :class:`ValueError`.  What neither port path has yet raises
        :class:`NotImplementedError`."""
        cfg, params, opts = self.cfg, self.params, self.opts
        if fused is not False:
            force = fused is True
            if (fused_csc.eligible(cfg, params, opts,
                                   force=force and self.cri.C <= 1)
                    or fused_csc.cfold_eligible(cfg, params, opts,
                                                force=force)):
                reason = fused_csc.unsupported_reason(cfg, params, opts)
                if reason is not None:
                    raise NotImplementedError(reason)
                return fused_csc.cbpdn_solve
            if force:
                raise ValueError(
                    "fused=True requested, but this configuration is not "
                    "supported by the fused driver (directly or via "
                    "channel folding)")
        if self.cri.Cd > 1:
            raise NotImplementedError(
                "the generic path's multi-channel dictionary solve "
                "(solvemdbi_ism) is not ported yet (ROADMAP queue 1, "
                "item 11)")
        return None

    def _solve_state(self):
        if self._fused_solve is None:
            return super()._solve_state()
        return self._fused_solve(self.cfg, self.params, self.opts,
                                 self.state)

    def getmin(self):
        return cr.from_internal_X(self.state.Y, self.cri)

    def reconstruct(self, X=None):
        """Reconstruct ``sum_m d_m * x_m`` in the user S layout
        ``Nv + [C] + [K]``."""
        return reconstruct(self.params["D"], self.state.Y, self.cri, X)


class ConvElasticNet(ConvBPDN):
    r"""CSC elastic net: adds ``(mu/2)||x||_2^2``; the per-bin solve uses
    ``mu + rho`` (``sporco/admm/cbpdn.py:813,948-975``)."""
    VARIANT = "elastic"
    STAT_NAMES = _STATS["elastic"]

    def __init__(self, D, S, lmbda=None, mu=0.0, opt=None, **kw):
        super().__init__(D, S, lmbda=lmbda, mu=mu, opt=opt, **kw)


class ConvBPDNGradReg(ConvBPDN):
    r"""CSC with gradient penalty ``(mu/2) sum_i ||G_i x||_2^2``; the
    per-bin solve has the diagonal term ``mu GHGf + rho`` via
    ``solvedbd_sm`` (``sporco/admm/cbpdn.py:992,1173-1201``).  ``wgrd``
    is the per-filter GradWeight array (or a scalar)."""
    VARIANT = "gradreg"
    STAT_NAMES = _STATS["gradreg"]
    REF_OPT_EXTRA = {"GradWeight": ("k", "wgrd")}

    def __init__(self, D, S, lmbda=None, mu=0.0, opt=None, wgrd=1.0, **kw):
        super().__init__(D, S, lmbda=lmbda, mu=mu, opt=opt, wgrd=wgrd,
                         **kw)


def reconstruct(Di, Xi, cri, X=None):
    """``sum_m d_m * x_m`` in the user S layout ``Nv + [C] + [K]`` for the
    internal dictionary ``Di`` and coefficients ``Xi``, or the
    reference-layout coefficients ``X`` when given."""
    if X is not None:
        Xi = cr.to_internal_X(torch.as_tensor(np.asarray(X)), cri) \
            .to(Di.device)
    axes = _fftaxes(cri)
    with fp32_precision():
        if Di.is_complex() or Xi.is_complex():
            DXf = torch.sum(sf.fftn(Di, s=cri.Nv, axes=axes)
                            * sf.fftn(Xi, axes=axes), dim=2, keepdim=True)
            Si = sf.ifftn(DXf, s=cri.Nv, axes=axes)
        else:
            DXf = torch.sum(sf.rfftn(Di, s=cri.Nv, axes=axes)
                            * sf.rfftn(Xi, axes=axes), dim=2, keepdim=True)
            Si = sf.irfftn(DXf, s=cri.Nv, axes=axes)
    # internal (K, C, 1, Nv...) -> Nv + [C] + [K]
    S = Si[:, :, 0].permute(tuple(range(2, 2 + cri.dimN)) + (1, 0))
    if cri.dimK == 0:
        S = S.squeeze(-1)
        if cri.dimC == 0:
            S = S.squeeze(-1)
    elif cri.dimC == 0:
        S = S.squeeze(-2)
    return S
