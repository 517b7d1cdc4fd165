"""Convolutional sparse coding via ADMM: ``ConvBPDN``, ``ConvBPDNJoint``,
``ConvElasticNet``, ``ConvBPDNGradReg`` and ``ConvBPDNProjL1``, masked CSC
over any of them by Additive Mask Simulation, ``AddMaskSim``, joint
coding against several dictionaries, ``MultiDictConvBPDN``, and the
two-block models ``ConvBPDNMaskDcpl``, ``ConvL1L1Grd`` and
``ConvMinL1InL2Ball`` (counterpart of ``sporco_tpu.models.cbpdn``).

Each variant (``l1``, ``elastic``, ``gradreg``) runs two ways, routed as
the JAX package routes them:

- the fused spatial-Woodbury driver (:mod:`sporco_tpu_torch.ops.fused_csc`)
  for real 2-D float32 problems with a single-channel dictionary and
  signal, a colour dictionary (``l1``/``elastic``, C = Cd in {2, 3},
  shared coefficient maps: the rank-C Woodbury x-step) or, by channel
  folding, a multi-channel signal with a single-channel dictionary:
  ``l1`` and ``elastic`` with a scalar or per-filter ``L1Weight`` through
  the CUDA kernel ``csc_iter``; ``gradreg``, and any variant with a
  spatially varying ``L1Weight``, through the driver's ``body`` (a
  per-bin x-step for ``gradreg``, whose transforms run
  ``rfft2_planar``/``irfft2_planar``, then the tail kernel ``admm_tail``
  or its torch ops);
- the generic DFT-domain ADMM problem (``_csc_*`` below) on the generic
  driver :func:`sporco_tpu_torch.solvers.admm.admm_solve` for every other
  configuration (the ``joint`` and ``projl1`` variants, ``fused=False``, ``no_bndry``, ``lin_check``,
  ``obj_from_x=False``, float64, complex inputs, other sizes, large
  supports, any K and C, 1-3 spatial dims).  Its x-step is one forward
  and one inverse FFT per iteration (2-D ones run the CUDA kernels
  ``rfft2_planar``/``irfft2_planar`` where
  :mod:`sporco_tpu_torch.ops.fft` dispatches them) around a per-bin
  Sherman-Morrison solve, iterated over the channels for a colour
  dictionary (``solvemdbi_ism``).

The two-block models split ``(D; I) x = (y0 + s; y1)`` (``CSC2Config``
and the ``_csc2_*`` functions) on the generic driver, whose tuple state
carries the pairs; their x-step is 2 forward and 2 inverse FFTs an
iteration and their dual residual 1 and 1 more, on the FFT kernels at
the sizes :mod:`sporco_tpu_torch.ops.fft` dispatches.

Under AMS (``CSCConfig.ams_nimp > 0``) the last ``ams_nimp`` filters are
impulses whose maps take the unshrunk ``(1 - Wams) (AX + U)`` in the
y-step; the fused driver takes a single-channel problem with one
impulse (its ``body`` and the AMS form of ``admm_tail``), the generic
path every other (a colour dictionary, a grey dictionary on a colour
image, ``fused=False``).
"""

import dataclasses
import warnings
from dataclasses import dataclass

import numpy as np
import torch

from sporco_tpu_torch import cnvrep as cr
from sporco_tpu_torch import refopts
from sporco_tpu_torch._device import fp32_precision, resolve_device
from sporco_tpu_torch.models.common import (ADMMModel, default_rho_xi,
                                            user_tensor)
from sporco_tpu_torch.ops import fft as sf
from sporco_tpu_torch.ops import fused_csc
from sporco_tpu_torch.ops import linalg as sl
from sporco_tpu_torch.ops import prox as sp
from sporco_tpu_torch.solvers.admm import (ADMMOpts, ADMMProblem,
                                           AutoRhoOpts, const_div,
                                           init_state, scalar_type,
                                           tree_norm)
from sporco_tpu_torch.utils.signal import gradient_filters

__all__ = ["ConvBPDN", "ConvBPDNJoint", "ConvElasticNet", "ConvBPDNGradReg",
           "ConvBPDNProjL1", "ConvBPDNMaskDcpl", "ConvL1L1Grd",
           "ConvMinL1InL2Ball", "AddMaskSim", "MultiDictConvBPDN",
           "CSCConfig", "CSC2Config", "params_from_numpy", "reconstruct"]


@dataclass(frozen=True)
class CSCConfig:
    cri: cr.CSCIndex
    variant: str = "l1"       # l1 | joint | elastic | gradreg | projl1
    non_neg: bool = False
    no_bndry: bool = False
    obj_from_x: bool = True
    lin_check: bool = False
    ams_nimp: int = 0         # > 0: the last ams_nimp filters are AMS impulses
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
    DSf = Df.conj() * Sf
    ft = scalar_type(params["D"].dtype)
    aux = {"Df": Df, "Sf": Sf, "lmbda": ft(params["lmbda"]),
           "mu": ft(params["mu"])}
    if cri.Cd > 1:
        aux["DSf"] = torch.sum(DSf, dim=1, keepdim=True)
    else:
        # rho-independent per-bin dictionary energy for the SM solve
        aux["DSf"] = DSf
        aux["DHD"] = torch.sum((Df * Df.conj()).real, dim=2, keepdim=True)
    if cfg.variant == "gradreg":
        _, GHGf = gradient_filters(cri.dimN, cri.Nv,
                                   dtype=params["D"].dtype,
                                   device=params["D"].device)
        aux["GHGfW"] = params["wgrd"] * GHGf
    return aux


def _sm_solve(cfg, aux, d_or_rho, b, diagonal=False):
    """Per-bin solve of ``(rho I + D^H D) x = b`` over the filter axis
    (or with a diagonal term), dispatching on the dictionary's channels
    as ``sporco/admm/cbpdn.py:275-293``."""
    Df = aux["Df"]
    if cfg.cri.Cd == 1:
        if diagonal:
            return sl.solvedbd_sm(Df, d_or_rho, b, axis=2)
        return sl.solvedbi_sm(Df, d_or_rho, b, axis=2, aah=aux["DHD"])
    return sl.solvemdbi_ism(Df, d_or_rho, b, axisM=2, axisK=1)


def _xrrs(cfg, aux, Xf, b, diag):
    """Inner linear-solve relative residual (LinSolveCheck,
    ``sporco/admm/cbpdn.py:283-293``) of ``(diag + D^H D) Xf = b``."""
    Df = aux["Df"]
    DHDXf = Df.conj() * torch.sum(Df * Xf, dim=2, keepdim=True)
    if cfg.cri.Cd > 1:
        DHDXf = torch.sum(DHDXf, dim=1, keepdim=True)
    return sl.rrs(DHDXf + diag * Xf, b)


def _csc_xstep(cfg, aux, params, state):
    cri = cfg.cri
    axes = _fftaxes(cri)
    rho = state.rho
    b = aux["DSf"] + rho * _fwd(cfg)(state.Y - state.U, axes=axes)
    if cfg.variant == "elastic":
        # (rho + mu) I + D^H D (sporco/admm/cbpdn.py:948-975)
        diag = rho + aux["mu"]
        Xf = _sm_solve(cfg, aux, diag, b)
    elif cfg.variant == "gradreg":
        # the diagonal mu GHGfW + rho (sporco/admm/cbpdn.py:1173-1201)
        diag = float(aux["mu"]) * aux["GHGfW"] + rho
        Xf = _sm_solve(cfg, aux, diag, b, diagonal=True)
    else:
        diag = rho
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


def _projl1_axes(cfg):
    """The axes of ``projl1``'s l1 ball: the filters and the spatial
    axes, per signal and channel (``sporco/admm/cbpdn.py:1373``)."""
    return (2,) + tuple(range(3, 3 + cfg.cri.dimN))


def _csc_ystep(cfg, aux, params, state, AXU):
    thr = const_div(aux["lmbda"], state.rho)
    if cfg.variant == "projl1":
        Y = sp.proj_l1(AXU, params["gamma"], axis=_projl1_axes(cfg))
    elif cfg.variant == "joint":
        # l1 and l2,1 over the channels (sporco/admm/cbpdn.py:760)
        Y = sp.prox_sl1l2(AXU, thr * params["wl1"],
                          const_div(aux["mu"], state.rho) * params["wl21"],
                          axis=1)
    else:
        Y = sp.prox_l1(AXU, thr * params["wl1"])
    Y = _apply_masks(cfg, Y)
    if cfg.ams_nimp:
        # Additive Mask Simulation: the impulse maps take the unshrunk
        # (1 - W)(AX + U), absorbing the residual where the mask is zero
        # (sporco/admm/cbpdn.py:2392-2404)
        ni = cfg.ams_nimp
        Yams = (1.0 - params["Wams"]) * AXU[:, :, -ni:]
        Y = torch.cat([Y[:, :, :-ni], Yams], dim=2)
    return Y


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
    xr = xaux["xrrs"] if cfg.lin_check else np.nan
    if cfg.variant == "projl1":
        prj = sp.proj_l1(gvar, params["gamma"], axis=_projl1_axes(cfg))
        return (dfd, torch.linalg.vector_norm((prj - gvar).reshape(-1)), xr)
    rl1 = torch.sum(torch.abs(params["wl1"] * gvar))
    lmbda, mu = float(aux["lmbda"]), float(aux["mu"])
    if cfg.variant == "joint":
        rl21 = torch.sum(params["wl21"] * torch.sqrt(
            torch.sum(torch.abs(gvar) ** 2, dim=1)))
        return (dfd + lmbda * rl1 + mu * rl21, dfd, rl1, rl21, xr)
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
    "joint": ("ObjFun", "DFid", "RegL1", "RegL21", "XSlvRelRes"),
    "elastic": ("ObjFun", "DFid", "RegL1", "RegL2", "XSlvRelRes"),
    "gradreg": ("ObjFun", "DFid", "RegL1", "RegGrad", "XSlvRelRes"),
    "projl1": ("DFid", "Cnstr", "XSlvRelRes"),
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


def _wgrd_internal(wgrd, cri, npdt):
    """GradWeight as a real array; a per-filter vector broadcasts on the
    M axis."""
    w = torch.as_tensor(np.asarray(wgrd, npdt))
    if w.ndim == 1:
        w = w.reshape((1, 1, w.shape[0]) + (1,) * cri.dimN)
    return w


def host_array(a):
    """A caller's array as a numpy array: a tensor (on any device) through
    the host, anything else through ``numpy.asarray``."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def params_from_numpy(D, S, lmbda=None, wl1=1.0, dimK=None, dimN=2,
                      device=None, dtype=torch.float32, mu=0.0, wgrd=1.0):
    """The port's problem from the same user-shaped arrays the JAX
    constructor takes (numpy arrays or tensors).  Returns ``(cri, params, real)``: ``params`` holds
    the internal-layout ``D``/``S`` in ``dtype`` (its complex counterpart
    when ``D`` or ``S`` is complex) and ``wl1`` and ``wgrd`` (GradWeight)
    in the real type, as tensors on ``device`` (``None``: the CUDA
    device, as for the models), and ``lmbda`` and ``mu`` as numbers
    (``lmbda`` defaulting to ``0.1 max|D^H S|``)."""
    D = host_array(D)
    S = host_array(S)
    real = not (np.iscomplexobj(D) or np.iscomplexobj(S))
    if not real:
        dtype = sf.complex_dtype(dtype)
    npdt = sf.numpy_dtype(dtype)
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
    wl1a = torch.as_tensor(np.asarray(wl1, sf.numpy_dtype(rdt)))
    if wl1a.ndim > 0:
        wl1a = cr.l1_weight(wl1a, cri)
    params = {"D": Di, "S": Si, "lmbda": float(lmbda), "wl1": wl1a.to(dev),
              "mu": float(mu),
              "wgrd": _wgrd_internal(wgrd, cri, sf.numpy_dtype(rdt)).to(dev)}
    return cri, params, real


class ConvBPDN(ADMMModel):
    r"""ADMM CSC solver: ``argmin_x (1/2)||sum_m d_m * x_m - s||_2^2
    + lmbda sum_m ||x_m||_1`` (``sporco/admm/cbpdn.py:386``).

    ``D`` has user shape ``dsz + [Cd] + (M,)``, ``S`` has
    ``Nv + [C] + [K]``; the returned coefficient array has the
    reference's layout ``Nv + (Cx, K, M)``.  Arguments are numpy arrays
    (or anything ``numpy.asarray`` takes).  ``device=None`` means the
    CUDA device and raises if there is none; pass ``device="cpu"`` for
    the CPU, where the kernel runs as its plain PyTorch version.

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
                 wl1=1.0, mu=0.0, wl21=1.0, wgrd=1.0, gamma=None,
                 non_neg=False, no_bndry=False, lin_check=False,
                 dtype=torch.float32, Y0=None, U0=None, fused="auto",
                 obj_from_x=True, device=None):
        super().__init__()
        self.device = resolve_device(device)
        if opt is None:
            opt = self.options()
        dtype = sf.torch_dtype(dtype)
        cri, params, real = params_from_numpy(D, S, lmbda, wl1, dimK, dimN,
                                              self.device, dtype, mu=mu,
                                              wgrd=wgrd)
        dtype = params["S"].dtype
        rnp = sf.numpy_dtype(sf.real_dtype(dtype))
        params["wl21"] = torch.as_tensor(np.asarray(wl21, rnp)).to(
            self.device)
        params["gamma"] = scalar_type(dtype)(0.0 if gamma is None
                                             else gamma)
        self.opts = opt.replace(dtype=dtype)
        self.cri = cri
        self.cfg = CSCConfig(cri=cri, variant=self.VARIANT,
                             non_neg=non_neg, no_bndry=no_bndry,
                             lin_check=lin_check, real=real,
                             obj_from_x=obj_from_x)
        self.params = params
        self.lmbda = lm = params["lmbda"]
        self.problem = _CSC_PROBLEMS[self.VARIANT]
        self._fused = fused
        self._fused_solve = self._route(fused)
        rho0 = opt.rho if opt.rho is not None else 50.0 * lm + 1.0
        rho_xi = (opt.auto_rho.rsdl_target
                  if opt.auto_rho.rsdl_target is not None
                  else default_rho_xi(lm))

        def internal_x(A):
            if A is None:
                return None
            return cr.to_internal_X(torch.as_tensor(
                np.asarray(A).astype(sf.numpy_dtype(dtype))), cri) \
                .contiguous().to(self.device)
        self.state = init_state(self.problem, self.cfg, self.params,
                                self.opts, rho0, rho_xi, Y0=internal_x(Y0),
                                U0=internal_x(U0))
        self._init_done()

    def _route(self, fused):
        """The fused driver's solve function, or None for the generic
        path, chosen as ``sporco_tpu.models.cbpdn.ConvBPDN.solve`` chooses:
        the fused driver for what ``eligible`` takes, channel folding
        for what ``cfold_eligible`` takes, the generic path otherwise and
        always under ``fused=False``; ``fused=True`` on any other
        configuration raises :class:`ValueError`."""
        cfg, params, opts = self.cfg, self.params, self.opts
        if fused is not False:
            force = fused is True
            if fused_csc.eligible(cfg, params, opts,
                                  force=force and self.cri.C <= 1):
                return fused_csc.cbpdn_solve
            if fused_csc.cfold_eligible(cfg, params, opts, force=force):
                return fused_csc.cbpdn_solve_cfold
            if force:
                raise ValueError(
                    "fused=True requested, but this configuration is not "
                    "supported by the fused driver (directly or via "
                    "channel folding)")
        return None

    def set_ams(self, nimp, Wams):
        """Make the last ``nimp`` filters AMS impulses with the internal
        fidelity mask ``Wams`` and route the solve again (AddMaskSim)."""
        self.cfg = dataclasses.replace(self.cfg, ams_nimp=nimp)
        self.params = {**self.params, "Wams": Wams.to(self.device,
                                                      self.opts.dtype)}
        self._fused_solve = self._route(self._fused)

    def _solve_state(self):
        if self._fused_solve is None:
            return super()._solve_state()
        return self._fused_solve(self.cfg, self.params, self.opts,
                                 self.state)

    def getmin(self):
        return cr.from_internal_X(self.state.Y, self.cri)

    def getcoef(self):
        return self.getmin()

    def getcoef_internal(self):
        """The coefficients in the internal layout (the dictionary
        learning loop)."""
        return self.state.Y

    def setdict(self, D=None, internal=None):
        """Replace the dictionary between ``solve()`` calls: user-shaped
        ``D``, or ``internal`` in the internal layout ``(1, Cd, M,
        dsz...)``; a tensor (on any device) is taken as it is.  The state
        (Y, U, rho) is kept; the next solve derives everything it needs
        from the new dictionary (the fused driver its polyphase weights,
        their split and ``D^H D``)."""
        if internal is None:
            internal = cr.to_internal_D(
                user_tensor(D, self.opts.dtype, self.device), self.cri)
        self.params = {**self.params,
                       "D": internal.contiguous().to(self.device,
                                                     self.opts.dtype)}

    def reconstruct(self, X=None):
        """Reconstruct ``sum_m d_m * x_m`` in the user S layout
        ``Nv + [C] + [K]``."""
        return reconstruct(self.params["D"], self.state.Y, self.cri, X)


class ConvBPDNJoint(ConvBPDN):
    r"""CSC with joint sparsity over the channels: adds ``mu ||X||_{2,1}``
    with the l2 norm over the channel axis of the coefficient maps
    (``sporco/admm/cbpdn.py:636``); its y-step is the l1 shrinkage
    followed by the group shrinkage over the channels.  ``wl21`` is the
    L21Weight (a scalar, or an array broadcast against the coefficient
    maps without their channel axis)."""
    VARIANT = "joint"
    STAT_NAMES = _STATS["joint"]
    REF_OPT_EXTRA = {"L21Weight": ("k", "wl21")}

    def __init__(self, D, S, lmbda=None, mu=0.0, opt=None, **kw):
        super().__init__(D, S, lmbda=lmbda, mu=mu, opt=opt, **kw)


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


class ConvBPDNProjL1(ConvBPDN):
    r"""CSC with an l1-ball constraint: ``argmin_x (1/2)||sum_m d_m * x_m
    - s||_2^2`` subject to ``||x||_1 <= gamma`` per signal and channel
    (``sporco/admm/cbpdn.py:1220,1373``); its y-step is the projection
    onto the ball over the filter and spatial axes.  Defaults as the
    reference: RelaxParam 1.8, rho 1, AutoRho on with Period 1,
    AutoScaling, scaling 1000, RsdlRatio 1.2 and RsdlTarget 1."""
    VARIANT = "projl1"
    STAT_NAMES = _STATS["projl1"]

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

    def __init__(self, D, S, gamma, opt=None, **kw):
        if opt is None:
            opt = self.options()
        if opt.rho is None:
            opt = opt.replace(rho=1.0)
        super().__init__(D, S, lmbda=1.0, gamma=gamma, opt=opt, **kw)


# ---------------------------------------------------------------------------
# Two-block constrained CSC: (D; I) x = (y0 + s; y1), the blocks a pair
# (signal-shaped y0, coefficient-shaped y1) that the generic driver maps
# over (``sporco_tpu.models.cbpdn``, ``sporco/admm/cbpdn.py:1401``)

@dataclass(frozen=True)
class CSC2Config:
    cri: cr.CSCIndex
    variant: str = "maskdcpl"   # maskdcpl | l1l1grd | minl2ball
    non_neg: bool = False
    no_bndry: bool = False


def _csc2_setup(cfg, params):
    cri = cfg.cri
    Df = sf.rfftn(params["D"], s=cri.Nv, axes=_fftaxes(cri))
    ft = scalar_type(params["D"].dtype)
    aux = {"Df": Df, "lmbda": ft(params["lmbda"]), "mu": ft(params["mu"])}
    if cri.Cd == 1:
        aux["DHD"] = torch.sum((Df * Df.conj()).real, dim=2, keepdim=True)
    if cfg.variant == "l1l1grd":
        _, GHGf = gradient_filters(cri.dimN, cri.Nv,
                                   dtype=params["D"].dtype,
                                   device=params["D"].device)
        aux["GHGfW"] = params["wgrd"] * GHGf
    return aux


def _dh(cfg, aux, Vf):
    """``D^H`` of a signal-shaped spectrum, summed over the channels of a
    multi-channel dictionary."""
    DhV = aux["Df"].conj() * Vf
    if cfg.cri.Cd > 1:
        DhV = torch.sum(DhV, dim=1, keepdim=True)
    return DhV


def _csc2_xstep(cfg, aux, params, state):
    cri = cfg.cri
    axes = _fftaxes(cri)
    Y0, Y1 = state.Y
    U0, U1 = state.U
    Df = aux["Df"]
    YU0f = sf.rfftn(Y0 - U0 + params["S"], axes=axes)
    YU1f = sf.rfftn(Y1 - U1, axes=axes)
    b = _dh(cfg, aux, YU0f) + YU1f
    if cfg.variant == "l1l1grd":
        d = const_div(aux["mu"], state.rho) * aux["GHGfW"] + 1.0
        Xf = _sm_solve(cfg, aux, d, b, diagonal=(cri.Cd == 1))
    else:
        Xf = _sm_solve(cfg, aux, 1.0, b)
    X = sf.irfftn(Xf, s=cri.Nv, axes=axes)
    DX = sf.irfftn(torch.sum(Df * Xf, dim=2, keepdim=True), s=cri.Nv,
                   axes=axes)
    # the primal variable carries (X, DX), so cnst_a needs no transform
    return (X, DX), {"Xf": Xf}


def _csc2_cnst_a(cfg, aux, params, XDX):
    X, DX = XDX
    return (DX, X)


def _csc2_cnst_at(cfg, aux, params, V):
    cri = cfg.cri
    axes = _fftaxes(cri)
    V0, V1 = V
    DTV0 = sf.irfftn(_dh(cfg, aux, sf.rfftn(V0, axes=axes)), s=cri.Nv,
                     axes=axes)
    return DTV0 + V1


def _csc2_cnst_b(cfg, aux, params, Y):
    return (-Y[0], -Y[1])


def _csc2_cnst_c(cfg, aux, params):
    # a zero that broadcasts over the coefficient block (the JAX
    # package's 0 S[..., :1, :1] takes S's channel axis, which a
    # multi-channel dictionary's single-channel maps do not have)
    S = params["S"]
    return (S, S.new_zeros((1,) * S.ndim))


def _csc2_ball_axes(cfg):
    """The axes of ``minl2ball``'s ball: the spatial ones, per signal and
    channel (``sporco/admm/cbpdn.py:2019-2021``)."""
    return tuple(range(3, 3 + cfg.cri.dimN))


def _csc2_ystep(cfg, aux, params, state, AXU):
    rho = state.rho
    A0, A1 = AXU
    v0 = A0 - params["S"]
    if cfg.variant == "minl2ball":
        Y0 = sp.proj_l2(v0, params["epsilon"], axis=_csc2_ball_axes(cfg))
    elif cfg.variant == "l1l1grd":
        Y0 = sp.prox_l1(v0, params["W"] / rho)
    else:       # the prox of (1/2)||W y0||^2
        Y0 = rho * v0 / (params["W"] ** 2 + rho)
    Y1 = sp.prox_l1(A1, const_div(aux["lmbda"], rho) * params["wl1"])
    Y1 = _apply_masks(CSCConfig(cri=cfg.cri, non_neg=cfg.non_neg,
                                no_bndry=cfg.no_bndry), Y1)
    return (Y0, Y1)


def _csc2_obfn(cfg, aux, params, state, xaux):
    X, DX = state.X
    err = DX - params["S"]
    rl1 = torch.sum(torch.abs(params["wl1"] * X))
    if cfg.variant == "minl2ball":
        prj = sp.proj_l2(err, params["epsilon"], axis=_csc2_ball_axes(cfg))
        return (rl1, torch.linalg.vector_norm((prj - err).reshape(-1)))
    lmbda = float(aux["lmbda"])
    if cfg.variant == "l1l1grd":
        dfd = torch.sum(torch.abs(params["W"] * err))
        rgr = 0.5 * sf.rfl2norm2(torch.sqrt(aux["GHGfW"]) * xaux["Xf"],
                                 cfg.cri.Nv, axis=_fftaxes(cfg.cri))
        return (dfd + lmbda * rl1 + float(aux["mu"]) * rgr, dfd, rl1, rgr)
    dfd = 0.5 * torch.sum((params["W"] * err) ** 2)
    return (dfd + lmbda * rl1, dfd, rl1)


def _csc2_zeros(cfg, params, *shapes):
    S = params["S"]
    return tuple(torch.zeros(shp, dtype=S.dtype, device=S.device)
                 for shp in shapes)


def _csc2_yinit(cfg, params):
    return _csc2_zeros(cfg, params, cfg.cri.shpS, cfg.cri.shpX)


def _csc2_xinit(cfg, params):
    return _csc2_zeros(cfg, params, cfg.cri.shpX, cfg.cri.shpS)


def _csc2_rsdl_s(cfg, aux, params, state, Yprev):
    """The reference's two-block dual residual ``rho A^T U``
    (``sporco/admm/cbpdn.py:1814``), not the standard ``rho A^T B(Y -
    Yprev)``; ``l1l1grd`` keeps the standard form
    (``sporco/admm/cbpdn.py:2753``)."""
    return state.rho * _csc2_cnst_at(cfg, aux, params, state.U)


def _csc2_rsdl_sn(cfg, aux, params, state):
    return state.rho * tree_norm(state.U)


_CSC2_STATS = {
    "maskdcpl": ("ObjFun", "DFid", "RegL1"),
    "l1l1grd": ("ObjFun", "DFid", "RegL1", "RegGrad"),
    "minl2ball": ("ObjFun", "Cnstr"),
}

_CSC2_PROBLEMS = {
    v: ADMMProblem(setup=_csc2_setup, xstep=_csc2_xstep,
                   ystep=_csc2_ystep, obfn=_csc2_obfn,
                   cnst_a=_csc2_cnst_a, cnst_at=_csc2_cnst_at,
                   cnst_b=_csc2_cnst_b, cnst_c=_csc2_cnst_c,
                   yinit=_csc2_yinit, uinit=_csc2_yinit,
                   xinit=_csc2_xinit, stat_names=names,
                   rsdl_s=None if v == "l1l1grd" else _csc2_rsdl_s,
                   rsdl_sn=None if v == "l1l1grd" else _csc2_rsdl_sn)
    for v, names in _CSC2_STATS.items()
}


class ConvBPDNMaskDcpl(ADMMModel):
    r"""CSC with a spatial mask by mask decoupling:
    ``argmin_x (1/2)||W(sum_m d_m * x_m - s)||_2^2 + lmbda ||x||_1``
    (``sporco/admm/cbpdn.py:2066``), the two-block splitting ``(D; I) x
    = (y0 + s; y1)`` on the generic driver.  ``W`` is the fidelity mask
    in the layout of ``S`` (``Nv + [C] + [K]``, singleton axes
    broadcast).  Arguments are numpy arrays or tensors; ``device=None``
    means the CUDA device and raises without one, ``device="cpu"`` runs
    on the CPU.  ``Y0``/``U0`` warm starts are pairs in the internal
    layout (signal-shaped, coefficient-shaped).

    Defaults as the reference: RelaxParam 1.8, rho 1, AutoRho off,
    lmbda ``0.1 max|D^H S|``.  ``solve()`` returns the thresholded
    coefficients ``Y1``; :meth:`reconstruct` by default the carried
    ``D X`` (``sporco/admm/cbpdn.py:1770``)."""

    VARIANT = "maskdcpl"
    STAT_NAMES = _CSC2_STATS["maskdcpl"]

    # reference ConvTwoBlockCnstrnt/ConvBPDNMaskDcpl option keys
    # (sporco/admm/cbpdn.py:1493-1516,2131-2136)
    REF_OPT_EXTRA = {
        **refopts._ADMM_EQUAL,
        "AuxVarObj": refopts.IGNORE,
        "HighMemSolve": refopts.IGNORE,
        "LinSolveCheck": refopts.WARN,
        "NonNegCoef": ("k", "non_neg"),
        "NoBndryCross": ("k", "no_bndry"),
        "L1Weight": ("k", "wl1"),
    }

    @staticmethod
    def options(**kw):
        ar = kw.pop("auto_rho", AutoRhoOpts(enabled=False))
        base = dict(relax_param=1.8, auto_rho=ar, rho=1.0)
        base.update(kw)
        return ADMMOpts(**base)

    def __init__(self, D, S, lmbda=None, W=None, opt=None, dimK=None,
                 dimN=2, wl1=1.0, mu=0.0, wgrd=1.0, epsilon=None,
                 non_neg=False, no_bndry=False, dtype=torch.float32,
                 Y0=None, U0=None, device=None):
        super().__init__()
        self.device = resolve_device(device)
        if opt is None:
            opt = self.options()
        dtype = sf.torch_dtype(dtype)
        npdt = sf.numpy_dtype(dtype)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", np.exceptions.ComplexWarning)
            D = host_array(D).astype(npdt)
            S = host_array(S).astype(npdt)
        cri, params, _ = params_from_numpy(D, S, lmbda, wl1, dimK, dimN,
                                           self.device, dtype, mu=mu,
                                           wgrd=wgrd)
        self.cri = cri
        Wm = torch.ones((1,) * (3 + cri.dimN), dtype=dtype) if W is None \
            else cr.fidelity_mask(torch.as_tensor(
                host_array(W).astype(npdt)), cri)
        ft = scalar_type(dtype)
        params["W"] = Wm.contiguous().to(self.device)
        params["epsilon"] = ft(0.0 if epsilon is None else epsilon)
        self.params = params
        self.lmbda = params["lmbda"]
        self.cfg = CSC2Config(cri=cri, variant=self.VARIANT,
                              non_neg=non_neg, no_bndry=no_bndry)
        self.opts = opt.replace(dtype=dtype)
        self.problem = _CSC2_PROBLEMS[self.VARIANT]
        rho0 = opt.rho if opt.rho is not None else 1.0
        rho_xi = (opt.auto_rho.rsdl_target
                  if opt.auto_rho.rsdl_target is not None else 1.0)

        def pair(A):
            return None if A is None else tuple(
                user_tensor(a, dtype, self.device) for a in A)
        self.state = init_state(self.problem, self.cfg, self.params,
                                self.opts, rho0, rho_xi, Y0=pair(Y0),
                                U0=pair(U0))
        self._init_done()

    def getmin(self):
        return cr.from_internal_X(self.state.Y[1], self.cri)

    def getcoef(self):
        return self.getmin()

    def getcoef_internal(self):
        """The coefficient block ``Y1`` in the internal layout (the
        dictionary learning loops)."""
        return self.state.Y[1]

    def reconstruct(self, X=None):
        """``sum_m d_m * x_m`` in the user S layout ``Nv + [C] + [K]``:
        by default the ``D X`` the state carries, else from the
        reference-layout coefficients ``X``."""
        if X is None:
            return internal_S_to_user(self.state.X[1], self.cri)
        return reconstruct(self.params["D"], None, self.cri, X)


class ConvL1L1Grd(ConvBPDNMaskDcpl):
    r"""CSC with an l1 data term, l1 sparsity and a gradient penalty:
    ``||W(Dx - s)||_1 + lmbda ||x||_1 + (mu/2) sum_i ||G_i x||_2^2``
    (``sporco/admm/cbpdn.py:2488``); its x-step is the diagonal solve
    ``solvedbd_sm`` with ``(mu / rho) GHGfW + 1``."""

    VARIANT = "l1l1grd"
    STAT_NAMES = _CSC2_STATS["l1l1grd"]
    REF_OPT_EXTRA = {"GradWeight": ("k", "wgrd")}

    def __init__(self, D, S, lmbda, mu=0.0, W=None, opt=None, **kw):
        super().__init__(D, S, lmbda=lmbda, mu=mu, W=W, opt=opt, **kw)


class ConvMinL1InL2Ball(ConvBPDNMaskDcpl):
    r"""Minimise ``||x||_1`` subject to ``||Dx - s||_2 <= epsilon``
    (``sporco/admm/cbpdn.py:1830``); the ball is taken per signal and
    channel over the spatial axes.  Defaults as the reference: rho 1,
    AutoRho on with Period 10."""

    VARIANT = "minl2ball"
    STAT_NAMES = _CSC2_STATS["minl2ball"]

    @staticmethod
    def options(**kw):
        ar = kw.pop("auto_rho", AutoRhoOpts(enabled=True, period=10,
                                            auto_scaling=True,
                                            scaling=1000.0,
                                            rsdl_ratio=1.2,
                                            rsdl_target=1.0))
        base = dict(relax_param=1.8, auto_rho=ar, rho=1.0)
        base.update(kw)
        return ADMMOpts(**base)

    def __init__(self, D, S, epsilon, opt=None, **kw):
        if opt is None:
            opt = self.options()
        if opt.rho is None:
            opt = opt.replace(rho=1.0)
        super().__init__(D, S, lmbda=1.0, epsilon=epsilon, opt=opt, **kw)


class AddMaskSim:
    """Additive Mask Simulation (wohlberg-2016-boundary): a masked CSC
    problem solved by any class of this module with one impulse filter
    per dictionary channel appended; the impulse maps absorb the
    residual where the mask is zero (``sporco/admm/cbpdn.py:2287-2483``;
    ``sporco_tpu.models.cbpdn.AddMaskSim``).

    Usage: ``AddMaskSim(ConvBPDN, D, S, W, lmbda, opt=..., device=...)``;
    the remaining arguments go to the inner class.  ``W`` is the fidelity
    mask in the layout of ``S`` (``Nv + [C] + [K]``, singleton axes
    broadcast).  ``L1Weight`` in a reference-style option dict is lifted
    out, so that the impulse maps can be given weight 0; a per-filter
    weight of length M is padded.
    """

    def __init__(self, cbpdnclass, D, S, W, *args, dtype=torch.float32,
                 **kwargs):
        opt = kwargs.get("opt")
        if isinstance(opt, dict) and "L1Weight" in opt:
            opt = dict(opt)
            # an explicit wl1 wins over the dict key, as in refopts
            kwargs.setdefault("wl1", opt.pop("L1Weight"))
            kwargs["opt"] = opt
        npdt = sf.numpy_dtype(sf.torch_dtype(dtype))
        D = np.asarray(D).astype(npdt)
        S = np.asarray(S).astype(npdt)
        W = np.asarray(W).astype(npdt)
        dimN = kwargs.get("dimN", 2)
        cri = cr.csc_index(D.shape, S.shape, dimK=kwargs.get("dimK"),
                           dimN=dimN)
        self.cri = cri
        nimp = cri.Cd
        if cri.dimCd == 0:
            imp = np.zeros(D.shape[:dimN] + (1,), npdt)
            imp[(0,) * dimN + (0,)] = 1.0
        else:
            imp = np.zeros(D.shape[:dimN] + (cri.Cd, cri.Cd), npdt)
            for c in range(cri.Cd):
                imp[(0,) * dimN + (c, c)] = 1.0
        self.M = D.shape[-1]
        # the mask in the internal layout (K|1, C|1, 1, Nv); a
        # multi-channel mask addresses the per-channel impulse maps of a
        # colour dictionary, so its C axis moves to the M slot
        # (sporco/admm/cbpdn.py:2347-2353)
        Wi = cr.fidelity_mask(torch.as_tensor(W), cri)
        if cri.Cd > 1 and Wi.shape[1] > 1:
            Wi = Wi.transpose(1, 2)              # (K|1, 1, Cd, Nv)
        # the l1 weight zeroed on the impulse maps, in the user layout
        # Nv + (C, K, M + nimp); a per-filter array of length M is padded
        user_wl1 = np.asarray(kwargs.pop("wl1", 1.0), npdt)
        if user_wl1.ndim and user_wl1.shape[-1] == self.M:
            user_wl1 = np.concatenate(
                [user_wl1, np.ones(user_wl1.shape[:-1] + (nimp,), npdt)],
                axis=-1)
        wl1 = np.ones((1,) * (dimN + 2) + (self.M + nimp,), npdt) * user_wl1
        wl1[..., self.M:] = 0.0
        self.cbpdn = cbpdnclass(np.concatenate([D, imp], axis=-1), S, *args,
                                wl1=wl1, dtype=dtype, **kwargs)
        self.cbpdn.set_ams(nimp, Wi.contiguous())
        self.Wams = self.cbpdn.params["Wams"]
        self.timer = self.cbpdn.timer

    def solve(self):
        """Solve; returns the coefficients of the M dictionary filters
        (the impulse maps dropped) in the reference's layout."""
        return self.cbpdn.solve()[..., :self.M]

    def getcoef(self):
        return self.cbpdn.getcoef()[..., :self.M]

    def getitstat(self):
        return self.cbpdn.getitstat()

    @property
    def itstat(self):
        return self.cbpdn.itstat

    def reconstruct(self, X=None):
        """The reconstruction from the dictionary filters' maps alone
        (the impulse maps zeroed), in the user S layout."""
        if X is None:
            X = self.getcoef()
        X = X if isinstance(X, torch.Tensor) else torch.as_tensor(
            np.asarray(X))
        full = torch.cat([X, X.new_zeros(X.shape[:-1] + (self.cri.Cd,))],
                         dim=-1)
        return self.cbpdn.reconstruct(full)


class MultiDictConvBPDN:
    """Joint sparse coding of several signals against several
    dictionaries with shared coefficient maps
    (``sporco/admm/cbpdn.py:2779``): the dictionaries are stacked on the
    channel axis (each zero-padded to the largest support), so that
    ``argmin_x sum_b (1/2)||D_b x - s_b||^2 + lmbda ||x||_1`` is one
    multi-channel problem of ``cbpdnclass``, routed as that class routes
    it (two single-channel dictionaries: a colour dictionary with
    C = Cd = 2, which the fused driver takes).

    Usage: ``MultiDictConvBPDN(ConvBPDN, [D0, D1], [S0, S1], lmbda,
    opt=..., device=...)``; the dictionaries and signals are numpy
    arrays (or tensors) in the reference's layouts.
    """

    def __init__(self, cbpdnclass, D, S, *args, dtype=torch.float32,
                 **kwargs):
        D = [host_array(d) for d in D]
        S = [host_array(v) for v in S]
        dimN = kwargs.get("dimN", 2)
        dimC = D[0].ndim - dimN - 1
        M = D[0].shape[-1]
        chn = [1] * len(D) if dimC == 0 else [d.shape[dimN] for d in D]
        C = int(np.sum(chn))
        dsz = np.zeros(dimN, dtype=int)
        for d in D:
            dsz = np.maximum(dsz, d.shape[:dimN])
        Dm = np.zeros(tuple(dsz.tolist()) + (C, M))
        chncs = np.cumsum(np.asarray([0] + chn))
        slc0 = (slice(None),) * dimN + (np.newaxis,) * (1 - dimC)
        for b, d in enumerate(D):
            slc1 = tuple([slice(0, n) for n in d.shape[:dimN]]
                         + [slice(chncs[b], chncs[b + 1])])
            Dm[slc1] = d[slc0]
        Sm = np.concatenate([v[slc0] for v in S], axis=dimN + dimC)
        self.cbpdn = cbpdnclass(Dm, Sm, *args, dtype=dtype, **kwargs)
        self.dimN = dimN
        self.chn = chn
        self.chncs = chncs
        self.C = C
        self.timer = self.cbpdn.timer

    def solve(self):
        return self.cbpdn.solve()

    def getcoef(self):
        return self.cbpdn.getcoef()

    def getitstat(self):
        return self.cbpdn.getitstat()

    @property
    def itstat(self):
        return self.cbpdn.itstat

    def reconstruct(self, b=None, X=None):
        """The reconstruction against dictionary ``b``, or against all of
        them, stacked on the channel axis, when ``b`` is None."""
        full = self.cbpdn.reconstruct(X)
        if b is None:
            return full
        sl_ = (slice(None),) * self.dimN + \
            (slice(int(self.chncs[b]), int(self.chncs[b + 1])),)
        return full[sl_]


def reconstruct(Di, Xi, cri, X=None):
    """``sum_m d_m * x_m`` in the user S layout ``Nv + [C] + [K]`` for the
    internal dictionary ``Di`` and coefficients ``Xi``, or the
    reference-layout coefficients ``X`` when given."""
    if X is not None:
        if not isinstance(X, torch.Tensor):
            X = torch.as_tensor(np.asarray(X))
        Xi = cr.to_internal_X(X.to(Di.device), cri)
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
    return internal_S_to_user(Si, cri)


def internal_S_to_user(Si, cri):
    """Internal ``(K, C, 1, Nv...)`` -> the user layout ``Nv + [C] +
    [K]``."""
    S = Si[:, :, 0].permute(tuple(range(2, 2 + cri.dimN)) + (1, 0))
    if cri.dimK == 0:
        S = S.squeeze(-1)
        if cri.dimC == 0:
            S = S.squeeze(-1)
    elif cri.dimC == 0:
        S = S.squeeze(-2)
    return S
