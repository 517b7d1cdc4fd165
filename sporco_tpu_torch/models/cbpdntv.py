"""CSC with total variation regularisation of the coefficient maps:
``ConvBPDNScalarTV``, ``ConvBPDNVectorTV`` and ``ConvBPDNRecTV``
(counterpart of ``sporco_tpu.models.cbpdntv``,
``sporco/admm/cbpdntv.py:31,577,733``).

Layout, as in the JAX package: the constraint blocks (the gradient
operators and the identity) stack on a new leading axis, spatial axes
trailing.  The primal variable carries ``(X, AX)``, so that the
constraint costs no transform outside the x-step.  All three run on the
generic driver with the problem's ``cnst_a``/``cnst_at`` hooks; their
2-D float32 transforms (of arrays up to ``(J + 1, K, C, M, N0, N1)``, the
leading axes flattened) run ``rfft2_planar``/``irfft2_planar`` where
:mod:`sporco_tpu_torch.ops.fft` dispatches them.

- scalar and vector TV: blocks ``(G_1 x, ..., G_J x, x)``, weighted by
  ``wtv``; the x-step is the diagonal solve ``solvedbd_sm`` with ``rho
  wtv^2 GHGf + rho`` (``solvemdbi_ism`` for a multi-channel dictionary).
  Per iteration: 1 forward and 2 inverse transforms in the x-step, and 1
  and 1 in the dual residual ``A^T B (Y - Yprev)`` and again in its
  normaliser ``A^T U``.
- reconstruction TV: blocks ``(x, G_i D x)``; the x-step is an iterated
  Sherman-Morrison solve over the dictionary's rows augmented with the
  weighted gradient rows (``cbpdntv.py:1024-1106``).  Per iteration: 2
  forward and 2 inverse in the x-step, 1 and 1 in the dual residual and
  1 and 1 in its normaliser.
"""

from dataclasses import dataclass

import numpy as np
import torch

from sporco_tpu_torch import cnvrep as cr
from sporco_tpu_torch import refopts
from sporco_tpu_torch._device import resolve_device
from sporco_tpu_torch.models.cbpdn import host_array, reconstruct
from sporco_tpu_torch.models.common import ADMMModel, warm_start
from sporco_tpu_torch.ops import fft as sf
from sporco_tpu_torch.ops import linalg as sl
from sporco_tpu_torch.ops import prox as sp
from sporco_tpu_torch.solvers.admm import (ADMMOpts, ADMMProblem,
                                           AutoRhoOpts, const_div,
                                           init_state, scalar_type,
                                           sqrt_t)
from sporco_tpu_torch.utils.signal import gradient_filters

__all__ = ["ConvBPDNScalarTV", "ConvBPDNVectorTV", "ConvBPDNRecTV",
           "CSCTVConfig"]


@dataclass(frozen=True)
class CSCTVConfig:
    cri: cr.CSCIndex
    variant: str = "scalar"    # scalar | vector | rec
    lin_check: bool = False


def _fftaxes(cri):
    return tuple(range(-cri.dimN, 0))


def _tv_setup(cfg, params):
    cri = cfg.cri
    axes = _fftaxes(cri)
    D, S = params["D"], params["S"]
    Df = sf.rfftn(D, s=cri.Nv, axes=axes)
    Sf = sf.rfftn(S, axes=axes)
    DSf = Df.conj() * Sf
    if cri.Cd > 1:
        DSf = torch.sum(DSf, dim=1, keepdim=True)
    Gf, GHGf = gradient_filters(cri.dimN, cri.Nv, dtype=S.dtype,
                                device=S.device)
    Gf = Gf.reshape((cri.dimN, 1, 1, 1) + tuple(Gf.shape[1:]))
    ft = scalar_type(S.dtype)
    aux = {"Df": Df, "Sf": Sf, "DSf": DSf, "Gf": Gf,
           "lmbda": ft(params["lmbda"]), "mu": ft(params["mu"])}
    if cfg.variant == "rec":
        # the weighted gradients of the atoms: (J, 1, Cd, M, freq...)
        aux["GDf"] = params["wtv"] * Gf * Df[None]
    else:
        aux["GHGfW"] = params["wtv"] ** 2 * GHGf
    return aux


def _dfid(cfg, aux, Xf):
    return 0.5 * sf.rfl2norm2(
        torch.sum(aux["Df"] * Xf, dim=2, keepdim=True) - aux["Sf"],
        cfg.cri.Nv, axis=_fftaxes(cfg.cri))


# --- scalar and vector TV: Y/U (J + 1, K, Cx, M, Nv...) -------------------

def _sv_xstep(cfg, aux, params, state):
    cri = cfg.cri
    axes = _fftaxes(cri)
    rho = state.rho
    YUf = sf.rfftn(state.Y - state.U, axes=axes)
    b = aux["DSf"] + rho * (YUf[-1] + params["wtv"] * torch.sum(
        aux["Gf"].conj() * YUf[:-1], dim=0))
    d = rho * aux["GHGfW"] + rho
    if cri.Cd == 1:
        Xf = sl.solvedbd_sm(aux["Df"], d, b, axis=2)
    else:
        Xf = sl.solvemdbi_ism(aux["Df"], d, b, axisM=2, axisK=1)
    X = sf.irfftn(Xf, s=cri.Nv, axes=axes)
    # A x = (wtv G_1 x, ..., wtv G_J x, x), blocks leading
    GX = sf.irfftn(params["wtv"] * aux["Gf"] * Xf[None], s=cri.Nv,
                   axes=axes)
    AX = torch.cat([GX, X[None]], dim=0)
    xaux = {"Xf": Xf}
    if cfg.lin_check:
        DHDXf = aux["Df"].conj() * torch.sum(aux["Df"] * Xf, dim=2,
                                             keepdim=True)
        if cri.Cd > 1:
            DHDXf = torch.sum(DHDXf, dim=1, keepdim=True)
        xaux["xrrs"] = sl.rrs(DHDXf + d * Xf, b)
    return (X, AX), xaux


def _sv_cnst_a(cfg, aux, params, XAX):
    return XAX[1]


def _sv_cnst_at(cfg, aux, params, V):
    cri = cfg.cri
    axes = _fftaxes(cri)
    Vf = sf.rfftn(V[:-1], axes=axes)
    G = sf.irfftn(params["wtv"] * torch.sum(aux["Gf"].conj() * Vf, dim=0),
                  s=cri.Nv, axes=axes)
    return G + V[-1]


def _sv_ystep(cfg, aux, params, state, AXU):
    rho = state.rho
    mu = const_div(aux["mu"], rho)
    if cfg.variant == "vector":
        # jointly over the filters and the gradient index
        # (sporco/admm/cbpdntv.py:136-137)
        Yg = sp.prox_l2(AXU[:-1], mu, axis=(0, 3))
    else:
        # the reference's scalar TV shrinks the whole gradient stack by
        # its global norm (cbpdntv.py:404, axis=None), as the JAX package
        Yg = sp.prox_l2(AXU[:-1], mu, axis=None)
    Yl = sp.prox_l1(AXU[-1], const_div(aux["lmbda"], rho) * params["wl1"])
    return torch.cat([Yg, Yl[None]], dim=0)


def _sv_obfn(cfg, aux, params, state, xaux):
    dfd = _dfid(cfg, aux, xaux["Xf"])
    # the regularisers on the unrelaxed A x the primal carries (gEvalY
    # False, the reference's default)
    AXnr = state.X[1]
    rl1 = torch.sum(torch.abs(params["wl1"] * AXnr[-1]))
    dims = (0, 3) if cfg.variant == "vector" else (0,)
    rtv = torch.sum(torch.sqrt(torch.sum(AXnr[:-1] ** 2, dim=dims)))
    xr = xaux["xrrs"] if cfg.lin_check else np.nan
    return (dfd + float(aux["lmbda"]) * rl1 + float(aux["mu"]) * rtv,
            dfd, rl1, rtv, xr)


def _zeros(params, shape):
    S = params["S"]
    return torch.zeros(shape, dtype=S.dtype, device=S.device)


def _sv_yinit(cfg, params):
    return _zeros(params, (cfg.cri.dimN + 1,) + cfg.cri.shpX)


def _sv_xinit(cfg, params):
    return (_zeros(params, cfg.cri.shpX), _sv_yinit(cfg, params))


_STATS = ("ObjFun", "DFid", "RegL1", "RegTV", "XSlvRelRes")

_SV_PROBLEM = ADMMProblem(
    setup=_tv_setup, xstep=_sv_xstep, ystep=_sv_ystep, obfn=_sv_obfn,
    cnst_a=_sv_cnst_a, cnst_at=_sv_cnst_at, yinit=_sv_yinit,
    uinit=_sv_yinit, xinit=_sv_xinit, stat_names=_STATS)


# --- reconstruction TV: y0 = x (shpX), y1 the gradients of the
# reconstruction, (J, K, C, 1, Nv...) -------------------------------------

def _rec_at_grad(cfg, aux, V1f):
    """``sum_j (G_j D)^H`` of the gradient blocks' spectra, summed over
    the channels of a multi-channel dictionary."""
    At = torch.sum(aux["GDf"].conj() * V1f, dim=0)
    if cfg.cri.Cd > 1:
        At = torch.sum(At, dim=1, keepdim=True)
    return At


def _rec_xstep(cfg, aux, params, state):
    cri = cfg.cri
    axes = _fftaxes(cri)
    rho = state.rho
    (Y0, Y1), (U0, U1) = state.Y, state.U
    YU0f = sf.rfftn(Y0 - U0, axes=axes)
    YU1f = sf.rfftn(Y1 - U1, axes=axes)          # (J, K, C, 1, f)
    GDf = aux["GDf"]                             # (J, 1, Cd, M, f)
    b = aux["DSf"] + rho * YU0f + rho * _rec_at_grad(cfg, aux, YU1f)
    # the rank terms on the channel axis: the dictionary's rows and the
    # sqrt(rho) (G_j D) rows (sporco/admm/cbpdntv.py:1038-1051)
    ah = torch.cat([aux["Df"]] + [sqrt_t(rho) * GDf[j]
                                  for j in range(GDf.shape[0])], dim=1)
    Xf = sl.solvemdbi_ism(ah, rho, b, axisM=2, axisK=1)
    X = sf.irfftn(Xf, s=cri.Nv, axes=axes)
    GDX = sf.irfftn(torch.sum(GDf * Xf[None], dim=3, keepdim=True),
                    s=cri.Nv, axes=axes)         # (J, K, C, 1, Nv)
    return (X, GDX), {"Xf": Xf}


def _rec_cnst_a(cfg, aux, params, XG):
    return XG


def _rec_cnst_at(cfg, aux, params, V):
    cri = cfg.cri
    axes = _fftaxes(cri)
    V0, V1 = V
    return V0 + sf.irfftn(_rec_at_grad(cfg, aux, sf.rfftn(V1, axes=axes)),
                          s=cri.Nv, axes=axes)


def _rec_ystep(cfg, aux, params, state, AXU):
    rho = state.rho
    A0, A1 = AXU
    Y0 = sp.prox_l1(A0, const_div(aux["lmbda"], rho) * params["wl1"])
    # jointly over the channels and the gradient index
    Y1 = sp.prox_l2(A1, const_div(aux["mu"], rho), axis=(0, 2))
    return (Y0, Y1)


def _rec_obfn(cfg, aux, params, state, xaux):
    dfd = _dfid(cfg, aux, xaux["Xf"])
    X0_, GDX = state.X
    rl1 = torch.sum(torch.abs(params["wl1"] * X0_))
    rtv = torch.sum(torch.sqrt(torch.sum(GDX ** 2, dim=(0, 2))))
    return (dfd + float(aux["lmbda"]) * rl1 + float(aux["mu"]) * rtv,
            dfd, rl1, rtv, np.nan)


def _rec_yinit(cfg, params):
    cri = cfg.cri
    return (_zeros(params, cri.shpX),
            _zeros(params, (cri.dimN, cri.K, cri.C, 1) + tuple(cri.Nv)))


_REC_PROBLEM = ADMMProblem(
    setup=_tv_setup, xstep=_rec_xstep, ystep=_rec_ystep, obfn=_rec_obfn,
    cnst_a=_rec_cnst_a, cnst_at=_rec_cnst_at,
    yinit=_rec_yinit, uinit=_rec_yinit, xinit=_rec_yinit,
    stat_names=_STATS)


class ConvBPDNScalarTV(ADMMModel):
    r"""CSC with a scalar TV term on each coefficient map:
    ``argmin_x (1/2)||sum_m d_m * x_m - s||^2 + lmbda ||x||_1 + mu sum_m
    || sqrt(sum_i (G_i x_m)^2) ||_1`` (``sporco/admm/cbpdntv.py:31``).
    ``wl1`` and ``wtv`` are the L1Weight and TVWeight (a scalar or a
    per-filter vector).  Arguments are numpy arrays (or tensors);
    ``device=None`` means the CUDA device and raises without one,
    ``device="cpu"`` runs on the CPU; ``Y0``/``U0`` warm starts are in
    the internal layout.  Defaults as the reference: RelaxParam 1.8,
    rho 1, AutoRho on with Period 1, AutoScaling, scaling 1000,
    RsdlRatio 1.2 and RsdlTarget 1."""

    REF_OPT_EXTRA = {
        **refopts._ADMM_EQUAL,
        "AuxVarObj": refopts.IGNORE,
        "HighMemSolve": refopts.IGNORE,
        "LinSolveCheck": ("k", "lin_check"),
        "NonNegCoef": refopts.WARN,
        "NoBndryCross": refopts.WARN,
        "L1Weight": ("k", "wl1"),
        "TVWeight": ("k", "wtv"),
    }

    VARIANT = "scalar"
    STAT_NAMES = _STATS

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

    def __init__(self, D, S, lmbda, mu=0.0, opt=None, dimK=None, dimN=2,
                 wl1=1.0, wtv=1.0, lin_check=False, dtype=torch.float32,
                 Y0=None, U0=None, device=None):
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
        self.lmbda = lmbda
        self.cfg = CSCTVConfig(cri=cri, variant=self.VARIANT,
                               lin_check=lin_check)
        self.opts = opt.replace(dtype=dtype)
        wl1a = torch.as_tensor(np.asarray(wl1, npdt))
        if wl1a.ndim > 0:
            wl1a = cr.l1_weight(wl1a, cri)
        wtva = torch.as_tensor(np.asarray(wtv, npdt))
        if wtva.ndim == 1:
            wtva = wtva.reshape((1, 1, wtva.shape[0]) + (1,) * dimN)
        self.params = {
            "D": cr.to_internal_D(torch.as_tensor(D), cri).contiguous()
            .to(dev),
            "S": cr.to_internal_S(torch.as_tensor(S), cri).contiguous()
            .to(dev),
            "lmbda": float(lmbda), "mu": float(mu), "wl1": wl1a.to(dev),
            "wtv": wtva.to(dev)}
        self.problem = _REC_PROBLEM if self.VARIANT == "rec" \
            else _SV_PROBLEM
        # the reference's 50 lmbda + 1 is dead code: rho is 1 unless set
        # (sporco/admm/cbpdntv.py:204,221)
        rho0 = opt.rho if opt.rho is not None else 1.0
        rho_xi = (opt.auto_rho.rsdl_target
                  if opt.auto_rho.rsdl_target is not None else 1.0)
        self.state = init_state(self.problem, self.cfg, self.params,
                                self.opts, rho0, rho_xi,
                                Y0=warm_start(Y0, dtype, dev),
                                U0=warm_start(U0, dtype, dev))
        self._init_done()

    def getmin(self):
        Y = self.state.Y[0] if self.VARIANT == "rec" else self.state.Y[-1]
        return cr.from_internal_X(Y, self.cri)

    def getcoef(self):
        return self.getmin()

    def reconstruct(self, X=None):
        """``sum_m d_m * x_m`` in the user S layout, from the primal
        coefficients by default."""
        return reconstruct(self.params["D"], self.state.X[0], self.cri, X)


class ConvBPDNVectorTV(ConvBPDNScalarTV):
    r"""CSC with a vector TV term jointly over the filters
    (``sporco/admm/cbpdntv.py:577``)."""
    VARIANT = "vector"


class ConvBPDNRecTV(ConvBPDNScalarTV):
    r"""CSC with a TV term on the reconstruction
    (``sporco/admm/cbpdntv.py:733``): the TV operator's rows are ``G_i
    D``, solved by an iterated Sherman-Morrison x-step over the augmented
    rank terms (``cbpdntv.py:1024-1106``)."""
    VARIANT = "rec"
