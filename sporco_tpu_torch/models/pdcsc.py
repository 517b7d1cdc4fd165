"""CSC with product dictionaries, a convolutional dictionary ``D`` acting
spatially and a standard dictionary ``B`` acting on the channel axis:
``ConvProdDictBPDN``, ``ConvProdDictBPDNJoint``, ``ConvProdDictL1L1Grd``
and ``ConvProdDictL1L1GrdJoint`` (counterpart of
``sporco_tpu.models.pdcsc``, ``sporco/admm/pdcsc.py:28,198,293,584``),
for ``argmin_X (1/2)||D X B^T - S||^2 + ...``.

The x-step diagonalises ``B`` by the eigendecomposition ``B^T B = Q
Gamma Q^T`` (garcia-2018-convolutional2): in its eigenbasis each
eigen-channel is an independent scaled rank-1 DFT-domain system, solved
by Sherman-Morrison (``pdcsc.py:137-146,509-525``).  The products with
``B``, ``B Q`` and ``Q`` contract the channel axis (:func:`_dotc`).

All four run on the generic driver; their 2-D float32 transforms (of
``(K, R, M, N0, N1)`` coefficient arrays, the leading axes flattened)
run ``rfft2_planar``/``irfft2_planar`` where
:mod:`sporco_tpu_torch.ops.fft` dispatches them: the plain and joint
forms one forward and one inverse an iteration, the two-block l1
fidelity forms (blocks ``D X B^T - S`` and ``X``, the reference's dual
residual ``rho A^T U``) three and three.
"""

from dataclasses import dataclass

import numpy as np
import torch

from sporco_tpu_torch import cnvrep as cr
from sporco_tpu_torch import refopts
from sporco_tpu_torch._device import fp32_precision, resolve_device
from sporco_tpu_torch.models.cbpdn import host_array
from sporco_tpu_torch.models.common import (ADMMModel, default_rho_xi,
                                            user_tensor, warm_start)
from sporco_tpu_torch.ops import fft as sf
from sporco_tpu_torch.ops import linalg as sl
from sporco_tpu_torch.ops import prox as sp
from sporco_tpu_torch.solvers.admm import (ADMMOpts, ADMMProblem,
                                           AutoRhoOpts, const_div,
                                           init_state, scalar_type,
                                           tree_norm)
from sporco_tpu_torch.utils.signal import gradient_filters

__all__ = ["ConvProdDictBPDN", "ConvProdDictBPDNJoint",
           "ConvProdDictL1L1Grd", "ConvProdDictL1L1GrdJoint",
           "PDCSCConfig"]


@dataclass(frozen=True)
class PDCSCConfig:
    cri: cr.CSCIndex          # C: the signal's channels
    R: int                    # the columns of B
    variant: str = "l1"       # l1 | joint | l1l1grd | l1l1grdjoint


def _fftaxes(cri):
    return tuple(range(-cri.dimN, 0))


def _dotc(mat, x):
    """The matrix ``mat`` against the channel axis (1) of ``x``, the
    result on that axis (``sporco_tpu.models.pdcsc._dotc``)."""
    if x.is_complex() and not mat.is_complex():
        mat = mat.to(x.dtype)
    return sl.dot(mat, x, axis=1)


def _setup(cfg, params):
    cri = cfg.cri
    axes = _fftaxes(cri)
    B = params["B"]
    with fp32_precision():
        Gamma, Q = torch.linalg.eigh(B.T @ B)
        BQ = B @ Q
    Gamma = torch.abs(Gamma)
    Df = sf.rfftn(params["D"], s=cri.Nv, axes=axes)      # (1, 1, M, f)
    ft = scalar_type(B.dtype)
    aux = {"B": B, "Q": Q, "BQ": BQ, "Df": Df,
           "gDf": torch.sqrt(Gamma).reshape(
               (1, cfg.R, 1) + (1,) * cri.dimN) * Df,       # (1, R, M, f)
           **{k: ft(params[k]) for k in ("lmbda", "mu", "mu2")}}
    if cfg.variant.startswith("l1l1grd"):
        _, GHGf = gradient_filters(cri.dimN, cri.Nv, dtype=B.dtype,
                                   device=B.device)
        aux["GHGfW"] = params["wgrd"] * GHGf
    else:
        aux["Sf"] = sf.rfftn(params["S"], axes=axes)       # (K, C, 1, f)
        aux["DSfBQ"] = _dotc(BQ.T, Df.conj() * aux["Sf"])  # (K, R, M, f)
    return aux


# --- the plain and joint forms ---------------------------------------------

def _xstep(cfg, aux, params, state):
    cri = cfg.cri
    axes = _fftaxes(cri)
    rho = state.rho
    Zf = sf.rfftn(state.Y - state.U, axes=axes)          # (K, R, M, f)
    b = aux["DSfBQ"] + rho * _dotc(aux["Q"].T, Zf)
    Xf = _dotc(aux["Q"], sl.solvedbi_sm(aux["gDf"], rho, b, axis=2))
    return sf.irfftn(Xf, s=cri.Nv, axes=axes), {"Xf": Xf}


def _y_coef(cfg, aux, params, rho, A, mu):
    """The coefficient block's prox: the l1 shrinkage, followed for the
    joint forms by the group shrinkage over the B-basis axis."""
    thr = const_div(aux["lmbda"], rho) * params["wl1"]
    if cfg.variant.endswith("joint"):
        return sp.prox_sl1l2(A, thr, const_div(mu, rho) * params["wl21"],
                             axis=1)
    return sp.prox_l1(A, thr)


def _ystep(cfg, aux, params, state, AXU):
    return _y_coef(cfg, aux, params, state.rho, AXU, aux["mu"])


def _rl21(params, X):
    return torch.sum(params["wl21"] * torch.sqrt(torch.sum(X ** 2, dim=1)))


def _obfn(cfg, aux, params, state, xaux):
    cri = cfg.cri
    DXf = torch.sum(aux["Df"] * xaux["Xf"], dim=2, keepdim=True)
    dfd = 0.5 * sf.rfl2norm2(_dotc(aux["B"], DXf) - aux["Sf"], cri.Nv,
                             axis=_fftaxes(cri))
    gv = state.X
    rl1 = torch.sum(torch.abs(params["wl1"] * gv))
    lmbda = float(aux["lmbda"])
    if cfg.variant == "joint":
        rl21 = _rl21(params, gv)
        return (dfd + lmbda * rl1 + float(aux["mu"]) * rl21, dfd, rl1,
                rl21)
    return (dfd + lmbda * rl1, dfd, rl1)


def _coef_shape(cfg):
    cri = cfg.cri
    return (cri.K, cfg.R, cri.M) + tuple(cri.Nv)


def _yinit(cfg, params):
    S = params["S"]
    return torch.zeros(_coef_shape(cfg), dtype=S.dtype, device=S.device)


_PD_STATS = {"l1": ("ObjFun", "DFid", "RegL1"),
             "joint": ("ObjFun", "DFid", "RegL1", "RegL21"),
             "l1l1grd": ("ObjFun", "DFid", "RegL1", "RegGrad"),
             "l1l1grdjoint": ("ObjFun", "DFid", "RegL1", "RegGrad",
                              "RegL21")}


# --- the l1 fidelity and gradient forms: blocks y0 = D X B^T - S (signal
# shaped) and y1 = X -----------------------------------------------------

def _g_xstep(cfg, aux, params, state):
    cri = cfg.cri
    axes = _fftaxes(cri)
    (Y0, Y1), (U0, U1) = state.Y, state.U
    Z0f = sf.rfftn(Y0 - U0 + params["S"], axes=axes)     # (K, C, 1, f)
    Z1f = sf.rfftn(Y1 - U1, axes=axes)                   # (K, R, M, f)
    b = _dotc(aux["BQ"].T, aux["Df"].conj() * Z0f) + _dotc(aux["Q"].T, Z1f)
    d = const_div(aux["mu"], state.rho) * aux["GHGfW"] + 1.0
    Xf = _dotc(aux["Q"], sl.solvedbd_sm(aux["gDf"], d, b, axis=2))
    X = sf.irfftn(Xf, s=cri.Nv, axes=axes)
    DXf = torch.sum(aux["Df"] * Xf, dim=2, keepdim=True)
    DXB = sf.irfftn(_dotc(aux["B"], DXf), s=cri.Nv, axes=axes)
    return (X, DXB), {"Xf": Xf}


def _g_cnst_a(cfg, aux, params, XD):
    X, DXB = XD
    return (DXB, X)


def _g_cnst_at(cfg, aux, params, V):
    cri = cfg.cri
    axes = _fftaxes(cri)
    V0, V1 = V
    At = _dotc(aux["B"].T, aux["Df"].conj() * sf.rfftn(V0, axes=axes))
    return sf.irfftn(At, s=cri.Nv, axes=axes) + V1


def _g_cnst_c(cfg, aux, params):
    # a zero that broadcasts over the coefficient block
    S = params["S"]
    return (S, S.new_zeros((1,) * S.ndim))


def _g_ystep(cfg, aux, params, state, AXU):
    rho = state.rho
    A0, A1 = AXU
    Y0 = sp.prox_l1(A0 - params["S"], params["W"] / rho)
    return (Y0, _y_coef(cfg, aux, params, rho, A1, aux["mu2"]))


def _g_obfn(cfg, aux, params, state, xaux):
    cri = cfg.cri
    X, DXB = state.X
    dfd = torch.sum(torch.abs(params["W"] * (DXB - params["S"])))
    rl1 = torch.sum(torch.abs(params["wl1"] * X))
    rgr = 0.5 * sf.rfl2norm2(torch.sqrt(aux["GHGfW"]) * xaux["Xf"],
                             cri.Nv, axis=_fftaxes(cri))
    obj = dfd + float(aux["lmbda"]) * rl1 + float(aux["mu"]) * rgr
    if cfg.variant == "l1l1grdjoint":
        rl21 = _rl21(params, X)
        return (obj + float(aux["mu2"]) * rl21, dfd, rl1, rgr, rl21)
    return (obj, dfd, rl1, rgr)


def _g_rsdl_s(cfg, aux, params, state, Yprev):
    return state.rho * _g_cnst_at(cfg, aux, params, state.U)


def _g_rsdl_sn(cfg, aux, params, state):
    return state.rho * tree_norm(state.U)


def _g_yinit(cfg, params):
    return (torch.zeros_like(params["S"]), _yinit(cfg, params))


def _g_xinit(cfg, params):
    return (_yinit(cfg, params), torch.zeros_like(params["S"]))


_PD_PROBLEMS = {
    v: ADMMProblem(setup=_setup, xstep=_xstep, ystep=_ystep, obfn=_obfn,
                   yinit=_yinit, uinit=_yinit, stat_names=_PD_STATS[v])
    for v in ("l1", "joint")}
_PD_PROBLEMS.update({
    v: ADMMProblem(setup=_setup, xstep=_g_xstep, ystep=_g_ystep,
                   obfn=_g_obfn, cnst_a=_g_cnst_a, cnst_at=_g_cnst_at,
                   cnst_c=_g_cnst_c, rsdl_s=_g_rsdl_s, rsdl_sn=_g_rsdl_sn,
                   yinit=_g_yinit, uinit=_g_yinit, xinit=_g_xinit,
                   stat_names=_PD_STATS[v])
    for v in ("l1l1grd", "l1l1grdjoint")})


def _pd_l1_weight(wl1, dimN, npdt):
    """An l1 weight in the layout ``(K, R, M, n0, n1)``: a scalar as it
    is; a per-filter vector, or a reference-layout array with a trailing
    filter axis (``sporco/cnvrep.py:492``, e.g. ``(1, 1, 1, 1, M)``), on
    the M axis."""
    w = np.asarray(wl1, npdt)
    if w.ndim > 1 and all(s == 1 for s in w.shape[:-1]):
        w = w.reshape(-1)
    if w.ndim == 1:
        w = w.reshape((1, 1, w.shape[0]) + (1,) * dimN)
    return torch.as_tensor(w)


def _pd_reconstruct(Di, B, Xi, cri):
    """``D X B^T`` in the internal signal layout ``(K, C, 1, Nv...)`` for
    the internal dictionary ``Di``, the standard dictionary ``B`` and the
    internal coefficients ``Xi`` ``(K, R, M, Nv...)``."""
    axes = _fftaxes(cri)
    with fp32_precision():
        DXf = torch.sum(sf.rfftn(Di, s=cri.Nv, axes=axes)
                        * sf.rfftn(Xi, axes=axes), dim=2, keepdim=True)
        return sf.irfftn(_dotc(B, DXf), s=cri.Nv, axes=axes)


class ConvProdDictBPDN(ADMMModel):
    r"""CSC with a product dictionary: ``argmin_X (1/2)||D X B^T - S||^2
    + lmbda ||X||_1`` (``sporco/admm/pdcsc.py:28``).  ``D`` is a
    single-channel convolutional dictionary, ``B`` (C x R) a standard
    dictionary on the channel axis.  Arguments are numpy arrays (or
    tensors); ``device=None`` means the CUDA device and raises without
    one, ``device="cpu"`` runs on the CPU; ``Y0``/``U0`` warm starts are
    in the internal layout.  Defaults as the reference: RelaxParam 1.8,
    AutoRho on with Period 1 and AutoScaling, rho = 50 lmbda + 1."""

    REF_OPT_EXTRA = {
        **refopts._ADMM_EQUAL,
        "AuxVarObj": refopts.IGNORE,
        "HighMemSolve": refopts.IGNORE,
        "LinSolveCheck": refopts.WARN,
        "NonNegCoef": refopts.WARN,
        "NoBndryCross": refopts.WARN,
        "L1Weight": ("k", "wl1"),
    }

    VARIANT = "l1"
    STAT_NAMES = _PD_STATS["l1"]

    @staticmethod
    def options(**kw):
        ar = kw.pop("auto_rho", AutoRhoOpts(enabled=True, period=1,
                                            auto_scaling=True,
                                            scaling=1000.0,
                                            rsdl_ratio=1.2))
        base = dict(relax_param=1.8, auto_rho=ar)
        base.update(kw)
        return ADMMOpts(**base)

    def __init__(self, D, B, S, lmbda, opt=None, dimK=None, dimN=2,
                 wl1=1.0, mu=0.0, wl21=1.0, dtype=torch.float32, Y0=None,
                 U0=None, device=None):
        super().__init__()
        if opt is None:
            opt = self.options()
        D, B, S, dtype = self._arrays(D, B, S, dtype, device)
        cri = cr.csc_index(D.shape, S.shape, dimK=dimK, dimN=dimN)
        self._init_problem(cri, D, B, S, None, lmbda, opt, dtype, wl1=wl1,
                           mu=mu, wl21=wl21)
        rho0 = opt.rho if opt.rho is not None else 50.0 * lmbda + 1.0
        rho_xi = (opt.auto_rho.rsdl_target
                  if opt.auto_rho.rsdl_target is not None
                  else default_rho_xi(lmbda))
        self._init_state(rho0, rho_xi, Y0, U0)

    def _arrays(self, D, B, S, dtype, device):
        self.device = resolve_device(device)
        dtype = sf.torch_dtype(dtype)
        npdt = sf.numpy_dtype(dtype)
        return (host_array(D).astype(npdt), host_array(B).astype(npdt),
                host_array(S).astype(npdt), dtype)

    def _init_problem(self, cri, D, B, S, W, lmbda, opt, dtype, wl1, mu,
                      wl21, mu2=0.0, wgrd=1.0):
        if cri.Cd > 1:
            raise ValueError("Only single-channel convolutional "
                             "dictionaries are supported")
        dev = self.device
        npdt = sf.numpy_dtype(dtype)
        self.cri = cri
        self.R = B.shape[1]
        self.lmbda = lmbda
        self.cfg = PDCSCConfig(cri=cri, R=self.R, variant=self.VARIANT)
        self.opts = opt.replace(dtype=dtype)
        wgrda = torch.as_tensor(np.asarray(wgrd, npdt))
        if wgrda.ndim == 1:
            wgrda = wgrda.reshape((1, 1, wgrda.shape[0]) + (1,) * cri.dimN)
        self.params = {
            "D": cr.to_internal_D(torch.as_tensor(D), cri).contiguous()
            .to(dev),
            "B": torch.as_tensor(B).to(dev),
            "S": cr.to_internal_S(torch.as_tensor(S), cri).contiguous()
            .to(dev),
            "lmbda": float(lmbda), "mu": float(mu), "mu2": float(mu2),
            "wl1": _pd_l1_weight(wl1, cri.dimN, npdt).to(dev),
            "wl21": torch.as_tensor(np.asarray(wl21, npdt)).to(dev),
            "wgrd": wgrda.to(dev)}
        if W is not None:
            self.params["W"] = W.contiguous().to(dev)
        self.problem = _PD_PROBLEMS[self.VARIANT]

    def _init_state(self, rho0, rho_xi, Y0, U0):
        dtype, dev = self.opts.dtype, self.device
        self.state = init_state(self.problem, self.cfg, self.params,
                                self.opts, rho0, rho_xi,
                                Y0=warm_start(Y0, dtype, dev),
                                U0=warm_start(U0, dtype, dev))
        self._init_done()

    def _xcri(self):
        """The index of the coefficients: R channels, one map each."""
        cri = self.cri
        return cr.CSCIndex(dimN=cri.dimN, dimC=1, dimK=cri.dimK,
                           dimCd=cri.dimCd, C=self.R, Cd=cri.Cd, Cx=self.R,
                           K=cri.K, M=cri.M, Nv=cri.Nv, dsz=cri.dsz)

    def getmin(self):
        return cr.from_internal_X(self.state.Y, self._xcri())

    def getcoef(self):
        return self.getmin()

    def reconstruct(self, X=None):
        """``D X B^T`` in the internal signal layout ``(K, C, 1,
        Nv...)``, from ``Y`` or the reference-layout coefficients
        ``X``."""
        Xi = self.state.Y if X is None else cr.to_internal_X(
            user_tensor(X, self.opts.dtype, self.device), self._xcri())
        return _pd_reconstruct(self.params["D"], self.params["B"], Xi,
                              self.cri)


class ConvProdDictBPDNJoint(ConvProdDictBPDN):
    r"""Product-dictionary CSC with joint sparsity, ``mu ||X||_{2,1}``
    over the B-basis axis (``sporco/admm/pdcsc.py:198``)."""

    REF_OPT_EXTRA = {"L21Weight": ("k", "wl21")}
    VARIANT = "joint"
    STAT_NAMES = _PD_STATS["joint"]

    def __init__(self, D, B, S, lmbda, mu=0.0, opt=None, **kw):
        super().__init__(D, B, S, lmbda, mu=mu, opt=opt, **kw)


class ConvProdDictL1L1Grd(ConvProdDictBPDN):
    r"""Product-dictionary CSC with an l1 data term under an optional
    mask ``W`` and a gradient penalty, ``||W(D X B^T - S)||_1 + lmbda
    ||X||_1 + (mu/2) sum_i ||G_i X||_2^2`` (``sporco/admm/pdcsc.py:293``),
    a two-block problem.  Defaults as the reference: RelaxParam 1.8, rho
    1, AutoRho off."""

    REF_OPT_EXTRA = {"GradWeight": ("k", "wgrd")}
    VARIANT = "l1l1grd"
    STAT_NAMES = _PD_STATS["l1l1grd"]

    @staticmethod
    def options(**kw):
        ar = kw.pop("auto_rho", AutoRhoOpts(enabled=False))
        base = dict(relax_param=1.8, auto_rho=ar, rho=1.0)
        base.update(kw)
        return ADMMOpts(**base)

    def __init__(self, D, B, S, lmbda, mu=0.0, W=None, opt=None, dimK=0,
                 dimN=2, wl1=1.0, wl21=1.0, mu2=0.0, wgrd=1.0,
                 dtype=torch.float32, Y0=None, U0=None, device=None):
        ADMMModel.__init__(self)
        if opt is None:
            opt = self.options()
        D, B, S, dtype = self._arrays(D, B, S, dtype, device)
        # the index of the B-transformed signal B^T S, as the reference
        # infers it, with S's channel count
        scidx = (-2 if dimK == 1 else -1) % S.ndim
        SBshape = S.shape[:scidx] + (B.shape[1],) + S.shape[scidx + 1:]
        cri = cr.csc_index(D.shape, SBshape, dimK=dimK, dimN=dimN)
        cri = cr.CSCIndex(dimN=cri.dimN, dimC=cri.dimC, dimK=cri.dimK,
                          dimCd=cri.dimCd, C=S.shape[scidx], Cd=cri.Cd,
                          Cx=cri.Cx, K=cri.K, M=cri.M, Nv=cri.Nv,
                          dsz=cri.dsz)
        npdt = sf.numpy_dtype(dtype)
        Wm = torch.ones((1,) * (3 + dimN), dtype=dtype) if W is None \
            else cr.fidelity_mask(torch.as_tensor(
                host_array(W).astype(npdt)), cri)
        self._init_problem(cri, D, B, S, Wm, lmbda, opt, dtype, wl1=wl1,
                           mu=mu, wl21=wl21, mu2=mu2, wgrd=wgrd)
        self._init_state(opt.rho if opt.rho is not None else 1.0, 1.0, Y0,
                         U0)

    def getmin(self):
        return cr.from_internal_X(self.state.Y[1], self._xcri())

    def reconstruct(self, X=None):
        """``D X B^T`` in the internal signal layout: by default the one
        the state carries."""
        if X is None:
            return self.state.X[1]
        return super().reconstruct(X)


class ConvProdDictL1L1GrdJoint(ConvProdDictL1L1Grd):
    r"""Adds joint sparsity, ``mu2 ||X||_{2,1}`` over the B-basis axis
    (``sporco/admm/pdcsc.py:584``)."""
    VARIANT = "l1l1grdjoint"
    STAT_NAMES = _PD_STATS["l1l1grdjoint"]

    def __init__(self, D, B, S, lmbda, mu=0.0, mu2=0.0, W=None, opt=None,
                 **kw):
        super().__init__(D, B, S, lmbda, mu=mu, mu2=mu2, W=W, opt=opt,
                         **kw)
