"""Sparse coding and dictionary updates via PGM (FISTA), counterpart of
``sporco_tpu.models.pgm``: convolutional ``ConvBPDN`` and
``ConvBPDNMask``, the FISTA dictionary update ``ConvCnstrMOD`` and
``ConvCnstrMODMask``, and the dense ``BPDN``, ``WeightedBPDN``,
``CnstrMOD`` and ``WeightedCnstrMOD`` (products on cuBLAS in full fp32
on the generic PGM loop).

Routed as the JAX package routes them:

- the fused packed-layout problem (:mod:`sporco_tpu_torch.ops.fused_csc`)
  for 2-D float32 problems with PS-aligned even sizes, supports up to 24
  and no NoBndryCross, masked or not, with a single-channel dictionary
  and signal, a colour dictionary (C = Cd in {2, 3}, shared coefficient
  maps) or, by channel folding, a multi-channel signal with a
  single-channel dictionary: the plain FISTA configuration runs the CUDA
  kernel ``pgm_iter`` once per iteration, backtracking, the step-size
  policies, the monotone variant and a spatially varying ``L1Weight``
  the generic PGM loop on the packed problem;
- the generic FFT problem (``_pcb_*`` below) on the generic PGM loop
  for every other configuration (``fused=False``, ``no_bndry``,
  float64, other sizes, large supports, 1-3 spatial dims).  Its
  gradient is one forward and one inverse FFT (three of each when
  masked); 2-D ones run the CUDA kernels
  ``rfft2_planar``/``irfft2_planar`` where :mod:`sporco_tpu_torch.ops.fft`
  dispatches them.

As in the JAX package, complex ``D``/``S`` are cast to the real
``dtype`` (their imaginary part is dropped).

The dictionary update ``argmin_D (1/2) sum_k ||sum_m x_km * d_m -
s_k||^2`` over unit-norm filters of the ``dsz`` support
(``sporco/pgm/ccmod.py:28,408``) runs on the generic PGM loop in the DFT
domain: its gradient is one forward and one inverse FFT (three of each
when masked), its prox the projection ``Pcn``.
"""

import warnings
from dataclasses import dataclass

import numpy as np
import torch

from sporco_tpu_torch import cnvrep as cr
from sporco_tpu_torch._device import fp32_precision, resolve_device
from sporco_tpu_torch.models import cbpdn as _cbpdn
from sporco_tpu_torch.models.cmod import random_dict
from sporco_tpu_torch.models.common import PGMModel, user_tensor
from sporco_tpu_torch.ops import fft as sf
from sporco_tpu_torch.ops import fused_csc
from sporco_tpu_torch.ops import prox as sp
from sporco_tpu_torch.solvers.admm import const_div, scalar_type
from sporco_tpu_torch.solvers.pgm import (PGMOpts, PGMProblem, pgm_init_state,
                                          pgm_solve)

__all__ = ["BPDN", "WeightedBPDN", "ConvBPDN", "ConvBPDNMask", "CnstrMOD",
           "WeightedCnstrMOD", "ConvCnstrMOD", "ConvCnstrMODMask",
           "PGMBPDNConfig", "PGMCMODConfig", "PGMCSCConfig",
           "PGMCCMODConfig", "params_from_numpy", "DEFAULT_L"]

DEFAULT_L = 500.0     # sporco/pgm/cbpdn.py:98


@dataclass(frozen=True)
class PGMCSCConfig:
    cri: cr.CSCIndex
    non_neg: bool = False
    no_bndry: bool = False
    masked: bool = False


def params_from_numpy(D, S, lmbda=None, wl1=1.0, W=None, dimK=None, dimN=2,
                      device=None, dtype=torch.float32):
    """The port's PGM problem from the same user-shaped arrays the JAX
    constructor takes.  Returns ``(cri, params, real)``: ``params`` holds
    the internal-layout ``D``, ``S``, ``wl1`` and the fidelity mask ``W``
    as tensors of ``dtype`` on ``device`` (``None``: the CUDA device, as
    for the models), and ``lmbda`` as a number (defaulting to
    ``0.1 max|D^H S|``).  Complex ``D``/``S`` lose their imaginary part,
    as ``jnp.asarray(D, dtype)`` drops it, so ``real`` is always True."""
    npdt = sf.numpy_dtype(dtype)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", np.exceptions.ComplexWarning)
        D = _cbpdn.host_array(D).astype(npdt)
        S = _cbpdn.host_array(S).astype(npdt)
    cri, params, _ = _cbpdn.params_from_numpy(D, S, lmbda, wl1, dimK, dimN,
                                              device, dtype)
    Wm = torch.ones((1,) * (3 + cri.dimN), dtype=dtype) if W is None \
        else cr.fidelity_mask(torch.as_tensor(np.asarray(W).astype(npdt)),
                              cri)
    params["W"] = Wm.to(params["D"].device, dtype)
    return cri, params, True


# ---------------------------------------------------------------------------
# The generic FFT problem (``sporco/pgm/cbpdn.py:29,387``)

def _pcb_setup(cfg, params):
    axes = _cbpdn._fftaxes(cfg.cri)
    return {"Df": sf.rfftn(params["D"], s=cfg.cri.Nv, axes=axes),
            "Sf": sf.rfftn(params["S"], axes=axes),
            "lmbda": scalar_type(params["D"].dtype)(params["lmbda"])}


def _pcb_Rf(cfg, aux, Vf):
    return torch.sum(aux["Df"] * Vf, dim=2, keepdim=True) - aux["Sf"]


def _pcb_grad(cfg, aux, params, Y):
    cri = cfg.cri
    axes = _cbpdn._fftaxes(cri)
    Ryf = _pcb_Rf(cfg, aux, sf.rfftn(Y, axes=axes))
    if cfg.masked:
        Ry = sf.irfftn(Ryf, s=cri.Nv, axes=axes)
        Ryf = sf.rfftn(params["W"] ** 2 * Ry, axes=axes)
    gradf = aux["Df"].conj() * Ryf
    if cri.Cd > 1:
        gradf = torch.sum(gradf, dim=1, keepdim=True)
    return sf.irfftn(gradf, s=cri.Nv, axes=axes)


def _pcb_prox(cfg, aux, params, V, L):
    U = sp.prox_l1(V, const_div(aux["lmbda"], L) * params["wl1"])
    return _cbpdn._apply_masks(_cbpdn.CSCConfig(
        cri=cfg.cri, non_neg=cfg.non_neg, no_bndry=cfg.no_bndry), U)


def _pcb_f(cfg, aux, params, X):
    cri = cfg.cri
    axes = _cbpdn._fftaxes(cri)
    Rf = _pcb_Rf(cfg, aux, sf.rfftn(X, axes=axes))
    if cfg.masked:
        R = sf.irfftn(Rf, s=cri.Nv, axes=axes)
        return 0.5 * torch.sum((params["W"] * R) ** 2)
    return 0.5 * sf.rfl2norm2(Rf, cri.Nv, axis=axes)


def _pcb_reg(params, X):
    return torch.sum(torch.abs(params["wl1"] * X))


def _pcb_g(cfg, aux, params, X):
    return float(aux["lmbda"]) * _pcb_reg(params, X)


def _pcb_obfn(cfg, aux, params, X):
    # RegL1 reported unscaled (sporco/pgm/cbpdn.py:355-366)
    f = _pcb_f(cfg, aux, params, X)
    reg = _pcb_reg(params, X)
    return (f + float(aux["lmbda"]) * reg, f, reg)


def _pcb_hess(cfg, aux, params, V):
    cri = cfg.cri
    axes = _cbpdn._fftaxes(cri)
    Vf = sf.rfftn(V, axes=axes)
    h = aux["Df"].conj() * torch.sum(aux["Df"] * Vf, dim=2, keepdim=True)
    if cri.Cd > 1:
        h = torch.sum(h, dim=1, keepdim=True)
    return sf.irfftn(h, s=cri.Nv, axes=axes)


def _pcb_xinit(cfg, params):
    return torch.zeros(cfg.cri.shpX, dtype=params["S"].dtype,
                       device=params["S"].device)


_CBPDN_PGM = PGMProblem(setup=_pcb_setup, grad_f=_pcb_grad,
                        prox_g=_pcb_prox, obfn_f=_pcb_f, obfn_g=_pcb_g,
                        hessian_f=_pcb_hess, xinit=_pcb_xinit,
                        obfn=_pcb_obfn,
                        stat_names=("ObjFun", "DFid", "RegL1"))


class ConvBPDN(PGMModel):
    r"""CSC via PGM/FISTA: ``argmin_x (1/2)||sum_m d_m * x_m - s||_2^2
    + lmbda sum_m ||x_m||_1`` (``sporco/pgm/cbpdn.py:29``).

    ``D`` has user shape ``dsz + [Cd] + (M,)``, ``S`` has
    ``Nv + [C] + [K]``; the returned coefficient array has the
    reference's layout ``Nv + (Cx, K, M)``.  Arguments are numpy arrays
    (or anything ``numpy.asarray`` takes).  ``device=None`` means the
    CUDA device and raises if there is none; pass ``device="cpu"`` for
    the CPU, where the kernel runs as its plain PyTorch version.
    Defaults: ``L = 500``, ``lmbda = 0.1 max|D^H S|``."""

    # reference pgm.ConvBPDN option keys (sporco/pgm/cbpdn.py:95-98)
    REF_OPT_EXTRA = {
        "NonNegCoef": ("k", "non_neg"),
        "NoBndryCross": ("k", "no_bndry"),
        "L1Weight": ("k", "wl1"),
    }

    MASKED = False
    STAT_NAMES = ("ObjFun", "DFid", "RegL1")

    @staticmethod
    def options(**kw):
        return PGMOpts(**kw)

    def __init__(self, D, S, lmbda=None, opt=None, dimK=None, dimN=2,
                 wl1=1.0, W=None, non_neg=False, no_bndry=False,
                 dtype=torch.float32, fused="auto", device=None):
        super().__init__()
        self.device = resolve_device(device)
        if opt is None:
            opt = self.options()
        dtype = sf.torch_dtype(dtype)
        self.opts = opt.replace(dtype=dtype)
        cri, params, _ = params_from_numpy(D, S, lmbda, wl1, W, dimK,
                                           dimN, self.device, dtype)
        self.cri = cri
        self.cfg = PGMCSCConfig(cri=cri, non_neg=non_neg,
                                no_bndry=no_bndry, masked=self.MASKED)
        self.params = params
        self.lmbda = params["lmbda"]
        self.problem = _CBPDN_PGM
        self._fused_solve = self._route(fused)
        L0 = opt.L if opt.L is not None else DEFAULT_L
        self.state = pgm_init_state(_pcb_xinit(self.cfg, params), self.opts,
                                    L0, len(self.STAT_NAMES))
        self._init_done()

    def _route(self, fused):
        """The fused problem's solve function, or None for the generic
        FFT problem, chosen as ``sporco_tpu.models.pgm.ConvBPDN.solve``
        chooses: the fused problem for what ``pgm_eligible`` takes,
        channel folding for what ``pgm_cfold_eligible`` takes, the
        generic problem otherwise and always under ``fused=False``."""
        cfg, opts = self.cfg, self.opts
        if fused is not False:
            if fused_csc.pgm_eligible(cfg, opts):
                return fused_csc.pgm_cbpdn_solve
            if fused_csc.pgm_cfold_eligible(cfg, self.params, opts):
                return fused_csc.pgm_cbpdn_solve_cfold
        return None

    def _solve_state(self):
        if self._fused_solve is not None:
            return self._fused_solve(self.cfg, self.params, self.opts,
                                     self.state)
        return pgm_solve(self.problem, self.cfg, self.params, self.opts,
                         self.state)

    def getmin(self):
        return cr.from_internal_X(self.state.X, self.cri)

    def getcoef(self):
        return self.getmin()

    def getcoef_internal(self):
        return self.state.X

    def setdict(self, D=None, internal=None):
        """Replace the dictionary: user-shaped ``D``, or ``internal`` in
        the internal layout ``(1, Cd, M, dsz...)``; a tensor (on any
        device) is taken as it is, and D takes the model's dtype."""
        if internal is None:
            internal = cr.to_internal_D(
                user_tensor(D, self.opts.dtype, self.device), self.cri)
        self.params = {**self.params,
                       "D": internal.contiguous().to(self.device,
                                                     self.opts.dtype)}

    def reconstruct(self, X=None):
        """Reconstruct ``sum_m d_m * x_m`` in the user S layout
        ``Nv + [C] + [K]``."""
        return _cbpdn.reconstruct(self.params["D"], self.state.X, self.cri,
                                  X)


class ConvBPDNMask(ConvBPDN):
    r"""CSC with a masked data fidelity term via PGM
    (``sporco/pgm/cbpdn.py:387``)."""
    MASKED = True

    def __init__(self, D, S, lmbda=None, W=None, opt=None, **kw):
        super().__init__(D, S, lmbda=lmbda, W=W, opt=opt, **kw)


# ---------------------------------------------------------------------------
# The convolutional dictionary update by FISTA (``sporco/pgm/ccmod.py``)

@dataclass(frozen=True)
class PGMCCMODConfig:
    cri: cr.CDUIndex
    zero_mean: bool = False
    masked: bool = False


def _ccm_axes(cfg):
    return _cbpdn._fftaxes(cfg.cri)


def _ccm_setup(cfg, params):
    axes = _ccm_axes(cfg)
    return {"Zf": sf.rfftn(params["Z"], axes=axes),
            "Sf": sf.rfftn(params["S"], axes=axes)}


def _ccm_Rf(cfg, aux, Df):
    """``sum_m z_km * d_m - s_k`` in the DFT domain, per signal."""
    return torch.sum(aux["Zf"] * Df, dim=2, keepdim=True) - aux["Sf"]


def _ccm_grad(cfg, aux, params, Y):
    cri = cfg.cri
    axes = _ccm_axes(cfg)
    Ryf = _ccm_Rf(cfg, aux, sf.rfftn(Y, axes=axes))
    if cfg.masked:
        Ry = sf.irfftn(Ryf, s=cri.Nv, axes=axes)
        Ryf = sf.rfftn(params["W"] ** 2 * Ry, axes=axes)
    gradf = torch.sum(aux["Zf"].conj() * Ryf, dim=0, keepdim=True)
    return sf.irfftn(gradf, s=cri.Nv, axes=axes)


def _ccm_pcn(cfg, V):
    return cr.Pcn(V, cfg.cri.dsz, cfg.cri.Nv, dimN=cfg.cri.dimN,
                  zm=cfg.zero_mean)


def _ccm_prox(cfg, aux, params, V, L):
    return _ccm_pcn(cfg, V)


def _ccm_f(cfg, aux, params, X):
    cri = cfg.cri
    axes = _ccm_axes(cfg)
    Rf = _ccm_Rf(cfg, aux, sf.rfftn(X, axes=axes))
    if cfg.masked:
        R = sf.irfftn(Rf, s=cri.Nv, axes=axes)
        return 0.5 * torch.sum((params["W"] * R) ** 2)
    return 0.5 * sf.rfl2norm2(Rf, cri.Nv, axis=axes)


def _ccm_g(cfg, aux, params, X):
    return torch.linalg.vector_norm((_ccm_pcn(cfg, X) - X).reshape(-1))


def _ccm_obfn(cfg, aux, params, X):
    return (_ccm_f(cfg, aux, params, X), _ccm_g(cfg, aux, params, X))


def _ccm_xinit(cfg, params):
    return params["D0"]


_CCMOD_PGM = PGMProblem(setup=_ccm_setup, grad_f=_ccm_grad,
                        prox_g=_ccm_prox, obfn_f=_ccm_f, obfn_g=_ccm_g,
                        obfn=_ccm_obfn, xinit=_ccm_xinit,
                        stat_names=("DFid", "Cnstr"))


class ConvCnstrMOD(PGMModel):
    r"""Convolutional constrained MOD via PGM (``sporco/pgm/ccmod.py:28``):
    the dictionary update ``argmin_D (1/2) sum_k ||sum_m x_km * d_m -
    s_k||^2`` with ``d_m`` in the unit-norm set of support ``dsz``.
    ``Z`` is in the reference's coefficient layout ``Nv + (Cx, K, M)``
    (or None: zeros until :meth:`setcoef`), ``S`` in ``Nv + [C] + [K]``,
    ``D0`` in the dictionary layout.  ``solve()`` returns the
    full-support dictionary in the internal layout, as the JAX package's
    does; :meth:`getdict` the user layout.  Default ``L = 14 K``
    (``sporco/pgm/ccmod.py:221``).  ``device=None`` means the CUDA
    device and raises without one; ``device="cpu"`` runs on the CPU."""

    # reference pgm.ConvCnstrMOD option keys (sporco/pgm/ccmod.py:93)
    REF_OPT_EXTRA = {"ZeroMean": ("k", "zero_mean")}

    MASKED = False
    STAT_NAMES = ("DFid", "Cnstr")

    @staticmethod
    def options(**kw):
        return PGMOpts(**kw)

    def __init__(self, Z, S, dsz, opt=None, dimK=None, dimN=2, D0=None,
                 W=None, zero_mean=False, dtype=torch.float32, device=None):
        super().__init__()
        self.device = resolve_device(device)
        if opt is None:
            opt = self.options()
        dtype = sf.torch_dtype(dtype)
        npdt = sf.numpy_dtype(dtype)
        S = np.asarray(S).astype(npdt)
        cri = cr.cdu_index(dsz, S.shape, dimK=dimK, dimN=dimN)
        self.cri = cri
        csc_like = cri.csc_like()
        Si = cr.to_internal_S(torch.as_tensor(S), cri)
        Zi = cr.to_internal_X(torch.as_tensor(np.asarray(Z).astype(npdt)),
                              csc_like) if Z is not None \
            else torch.zeros(cri.shpX, dtype=dtype)
        D0i = torch.zeros(cri.shpD, dtype=dtype) if D0 is None \
            else cr.zpad(cr.to_internal_D(torch.as_tensor(
                np.asarray(D0).astype(npdt)), csc_like), cri.Nv)
        Wm = torch.ones((1,) * (3 + cri.dimN), dtype=dtype) if W is None \
            else cr.fidelity_mask(torch.as_tensor(np.asarray(W).astype(
                npdt)), cri)
        self.cfg = PGMCCMODConfig(cri=cri, zero_mean=zero_mean,
                                  masked=self.MASKED)
        self.opts = opt.replace(dtype=dtype)

        def dev(t):
            return t.contiguous().to(self.device, dtype)
        self.params = {"Z": dev(Zi), "S": dev(Si), "D0": dev(D0i),
                       "W": dev(Wm)}
        self.problem = _CCMOD_PGM
        L0 = opt.L if opt.L is not None else 14.0 * cri.K
        self.state = pgm_init_state(self.params["D0"], self.opts, L0,
                                    len(self.STAT_NAMES))
        self._init_done()

    def _solve_state(self):
        return pgm_solve(self.problem, self.cfg, self.params, self.opts,
                         self.state)

    def getdict(self, crop=True):
        """The dictionary in the user layout ``dsz + [Cd] + (M,)``, cropped
        to the filter support unless ``crop`` is False."""
        D = self.state.X
        if crop:
            D = cr.bcrop(D, self.cri.dsz, self.cri.dimN)
        return cr.from_internal_D(D, self.cri)

    def getdict_internal(self):
        """The full-support dictionary in the internal layout (the
        dictionary learning loop)."""
        return self.state.X

    def setcoef(self, Z, internal=False):
        """Replace the coefficients: reference layout ``Nv + (Cx, K, M)``,
        or with ``internal`` the internal ``(K, Cx, M, Nv...)``; a tensor
        (on any device) is taken as it is."""
        if not internal:
            Z = cr.to_internal_X(user_tensor(Z, self.opts.dtype,
                                             self.device),
                                 self.cri.csc_like())
        self.params = {**self.params,
                       "Z": Z.contiguous().to(self.device, self.opts.dtype)}


class ConvCnstrMODMask(ConvCnstrMOD):
    r"""Masked convolutional MOD via PGM (``sporco/pgm/ccmod.py:408``):
    the data term is ``(1/2) ||W (sum_m x_m * d_m - s)||^2``."""
    MASKED = True

    def __init__(self, Z, S, dsz, W=None, **kw):
        super().__init__(Z, S, dsz, W=W, **kw)


# ---------------------------------------------------------------------------
# Dense BPDN by FISTA: argmin_x (1/2)||Dx - s||_2^2 + lmbda ||x||_1, with a
# weighted l2 data term in WeightedBPDN (``sporco/pgm/bpdn.py:26,248``)

@dataclass(frozen=True)
class PGMBPDNConfig:
    non_neg: bool = False
    weighted: bool = False


def _mm_setup(cfg, params):
    return {}


def _bp_residual(cfg, params, X):
    R = params["D"] @ X - params["S"]
    return params["W"] * R if cfg.weighted else R


def _bp_grad(cfg, aux, params, Y):
    return params["D"].T @ _bp_residual(cfg, params, Y)


def _bp_prox(cfg, aux, params, V, L):
    U = sp.prox_l1(V, const_div(params["lmbda"], L) * params["wl1"])
    return torch.clamp(U, min=0.0) if cfg.non_neg else U


def _bp_f(cfg, aux, params, X):
    R = params["D"] @ X - params["S"]
    if cfg.weighted:
        return 0.5 * torch.sum(params["W"] * R ** 2)
    return 0.5 * torch.sum(R ** 2)


def _bp_reg(params, X):
    return torch.sum(torch.abs(params["wl1"] * X))


def _bp_g(cfg, aux, params, X):
    return float(params["lmbda"]) * _bp_reg(params, X)


def _bp_hess(cfg, aux, params, V):
    DV = params["D"] @ V
    return params["D"].T @ (params["W"] * DV if cfg.weighted else DV)


def _bp_xinit(cfg, params):
    return torch.zeros((params["D"].shape[1], params["S"].shape[1]),
                       dtype=params["S"].dtype, device=params["S"].device)


def _bp_obfn(cfg, aux, params, X):
    # RegL1 reported unscaled (sporco/pgm/bpdn.py:214-220)
    f = _bp_f(cfg, aux, params, X)
    reg = _bp_reg(params, X)
    return (f + float(params["lmbda"]) * reg, f, reg)


_BPDN_PGM = PGMProblem(setup=_mm_setup, grad_f=_bp_grad, prox_g=_bp_prox,
                       obfn_f=_bp_f, obfn_g=_bp_g, hessian_f=_bp_hess,
                       xinit=_bp_xinit, obfn=_bp_obfn,
                       stat_names=("ObjFun", "DFid", "RegL1"))


def _dense_weight(W, dtype, device, column=False):
    """A weight (None: 1) as a tensor; with ``column`` a vector becomes a
    column, weighting the rows of every signal."""
    W = user_tensor(1.0 if W is None else W, dtype, device)
    return W[:, None] if column and W.ndim == 1 else W


class BPDN(PGMModel):
    r"""Dense BPDN by PGM/FISTA (``sporco/pgm/bpdn.py:26``).  ``D`` is
    (N, M) and ``S`` (N, K) or (N,): numpy arrays or tensors; the
    solution ``X`` is (M, K), a tensor on the model's device.  Defaults:
    ``L = 500`` (``sporco/pgm/bpdn.py:88``), lmbda ``0.1 max|D^T S|``.
    ``device=None`` means the CUDA device and raises without one;
    ``device="cpu"`` runs on the CPU."""

    # reference pgm.BPDN option keys (sporco/pgm/bpdn.py:87-88)
    REF_OPT_EXTRA = {
        "NonNegCoef": ("k", "non_neg"),
        "L1Weight": ("k", "wl1"),
    }

    WEIGHTED = False
    STAT_NAMES = ("ObjFun", "DFid", "RegL1")

    @staticmethod
    def options(**kw):
        return PGMOpts(**kw)

    def __init__(self, D, S, lmbda=None, opt=None, wl1=1.0, W=None,
                 non_neg=False, dtype=torch.float32, device=None):
        super().__init__()
        self.device = resolve_device(device)
        if opt is None:
            opt = self.options()
        dtype = sf.torch_dtype(dtype)
        D = user_tensor(D, dtype, self.device)
        S = user_tensor(S, dtype, self.device)
        if S.ndim == 1:
            S = S[:, None]
        if lmbda is None:
            with fp32_precision():
                lmbda = 0.1 * float(torch.max(torch.abs(D.T @ S)))
        self.lmbda = lmbda
        self.cfg = PGMBPDNConfig(non_neg=non_neg, weighted=self.WEIGHTED)
        self.opts = opt.replace(dtype=dtype)
        self.params = {"D": D, "S": S, "lmbda": scalar_type(dtype)(lmbda),
                       "wl1": user_tensor(wl1, dtype, self.device),
                       "W": _dense_weight(W, dtype, self.device, True)}
        self.problem = _BPDN_PGM
        L0 = opt.L if opt.L is not None else DEFAULT_L
        self.state = pgm_init_state(_bp_xinit(self.cfg, self.params),
                                    self.opts, L0, len(self.STAT_NAMES))
        self._init_done()

    def _solve_state(self):
        return pgm_solve(self.problem, self.cfg, self.params, self.opts,
                         self.state)

    def getcoef(self):
        return self.state.X

    def reconstruct(self, X=None):
        """``D X``, with the model's coefficients by default."""
        if X is None:
            X = self.state.X
        with fp32_precision():
            return self.params["D"] @ user_tensor(X, self.opts.dtype,
                                                  self.device)


class WeightedBPDN(BPDN):
    r"""BPDN with a weighted l2 data term ``(1/2)||W^(1/2) (Dx - s)||^2``
    (``sporco/pgm/bpdn.py:248``)."""
    WEIGHTED = True

    def __init__(self, D, S, lmbda=None, W=None, opt=None, **kw):
        super().__init__(D, S, lmbda=lmbda, W=W, opt=opt, **kw)


# ---------------------------------------------------------------------------
# The dense dictionary update by FISTA (``sporco/pgm/cmod.py:24,238``)

@dataclass(frozen=True)
class PGMCMODConfig:
    zero_mean: bool = False
    non_neg: bool = False
    weighted: bool = False


def _cm_proj(cfg, D):
    """The unit-column-norm projection (``sporco/admm/cmod.py:286-339``),
    after the column means (``zero_mean``) and the negative entries
    (``non_neg``) are taken out."""
    if cfg.zero_mean:
        D = D - torch.mean(D, dim=0, keepdim=True)
    if cfg.non_neg:
        D = torch.clamp(D, min=0.0)
    n = torch.sqrt(torch.sum(D ** 2, dim=0, keepdim=True))
    return D / torch.where(n == 0.0, torch.ones_like(n), n)


def _cm_residual(cfg, params, X):
    R = X @ params["Z"] - params["S"]
    return params["W"] * R if cfg.weighted else R


def _cm_grad(cfg, aux, params, Y):
    return _cm_residual(cfg, params, Y) @ params["Z"].T


def _cm_prox(cfg, aux, params, V, L):
    return _cm_proj(cfg, V)


def _cm_f(cfg, aux, params, X):
    R = X @ params["Z"] - params["S"]
    if cfg.weighted:
        return 0.5 * torch.sum(params["W"] * R ** 2)
    return 0.5 * torch.sum(R ** 2)


def _cm_g(cfg, aux, params, X):
    return torch.linalg.vector_norm((_cm_proj(cfg, X) - X).reshape(-1))


def _cm_hess(cfg, aux, params, V):
    VZ = V @ params["Z"]
    return (params["W"] * VZ if cfg.weighted else VZ) @ params["Z"].T


def _cm_obfn(cfg, aux, params, X):
    return (_cm_f(cfg, aux, params, X), _cm_g(cfg, aux, params, X))


_CMOD_PGM = PGMProblem(setup=_mm_setup, grad_f=_cm_grad, prox_g=_cm_prox,
                       obfn_f=_cm_f, obfn_g=_cm_g, hessian_f=_cm_hess,
                       obfn=_cm_obfn, xinit=lambda cfg, params: params["D0"],
                       stat_names=("DFid", "Cnstr"))


class CnstrMOD(PGMModel):
    r"""The constrained MOD dictionary update by PGM
    (``sporco/pgm/cmod.py:24``): ``argmin_D (1/2)||D Z - S||_2^2`` over
    unit-norm columns.  ``Z`` is (M, K), ``S`` (N, K); ``D0=None`` draws
    the initial dictionary with
    :func:`sporco_tpu_torch.models.cmod.random_dict` (the JAX package's
    draw from ``PRNGKey(0)`` cannot be reproduced: pass it as ``D0``).
    Default ``L = 500``.  ``device=None`` means the CUDA device and
    raises without one; ``device="cpu"`` runs on the CPU."""

    # reference pgm.CnstrMOD option keys (sporco/pgm/cmod.py:86-87)
    REF_OPT_EXTRA = {
        "ZeroMean": ("k", "zero_mean"),
        "NonNegCoef": ("k", "non_neg"),
    }

    WEIGHTED = False
    STAT_NAMES = ("DFid", "Cnstr")

    @staticmethod
    def options(**kw):
        return PGMOpts(**kw)

    def __init__(self, Z, S, dsz=None, opt=None, D0=None, W=None,
                 zero_mean=False, non_neg=False, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.device = resolve_device(device)
        if opt is None:
            opt = self.options()
        dtype = sf.torch_dtype(dtype)
        Z = user_tensor(Z, dtype, self.device)
        S = user_tensor(S, dtype, self.device)
        M = Z.shape[0] if dsz is None else dsz[-1]
        D0 = random_dict(S.shape[0], M, dtype, self.device) if D0 is None \
            else user_tensor(D0, dtype, self.device)
        self.cfg = PGMCMODConfig(zero_mean=zero_mean, non_neg=non_neg,
                                 weighted=self.WEIGHTED)
        self.opts = opt.replace(dtype=dtype)
        self.params = {"Z": Z, "S": S, "D0": D0,
                       "W": _dense_weight(W, dtype, self.device)}
        self.problem = _CMOD_PGM
        L0 = opt.L if opt.L is not None else DEFAULT_L
        self.state = pgm_init_state(D0, self.opts, L0,
                                    len(self.STAT_NAMES))
        self._init_done()

    def _solve_state(self):
        return pgm_solve(self.problem, self.cfg, self.params, self.opts,
                         self.state)

    def getdict(self):
        return self.state.X

    def setcoef(self, Z):
        """Replace the coefficients; a tensor (on any device) is taken as
        it is."""
        self.params = {**self.params,
                       "Z": user_tensor(Z, self.opts.dtype, self.device)}


class WeightedCnstrMOD(CnstrMOD):
    r"""The constrained MOD update with a weighted l2 data term
    (``sporco/pgm/cmod.py:238``)."""
    WEIGHTED = True

    def __init__(self, Z, S, W=None, **kw):
        super().__init__(Z, S, W=W, **kw)
