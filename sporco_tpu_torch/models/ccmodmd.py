"""The masked convolutional dictionary update by ADMM with mask
decoupling (counterpart of ``sporco_tpu.models.ccmodmd``):
``ConvCnstrMODMaskDcpl_IterSM`` (``sporco/admm/ccmodmd.py:573``),
``ConvCnstrMODMaskDcpl_CG`` (``:658``), ``ConvCnstrMODMaskDcpl_Consensus``
(``:766``) and the factory ``ConvCnstrMODMaskDcpl`` (``:1042``).

``argmin_D (1/2) sum_k ||W (sum_m z_km * d_m - s_k)||^2`` over unit-norm
filters of the ``dsz`` support, with the masked residual split off as a
block of its own.  The blocks are pairs, which the generic ADMM driver
(:func:`sporco_tpu_torch.solvers.admm.admm_solve`) maps over:

- ``ism``/``cg``: ``(Z-op; I) d = (y0 + s; y1)``, the x-step a solve over
  the signal axis by iterated Sherman-Morrison or conjugate gradient;
- ``cns``: each signal has its own copy of the dictionary, solved as one
  batched rank-1 Sherman-Morrison solve over the leading K axis; the
  y-step projects their mean onto the constraint set and the residuals
  are taken on the dictionary blocks only.

Every transform is a 2-D ``rfftn``/``irfftn`` of :mod:`sporco_tpu_torch.ops.fft`,
so float32 problems of the sizes the FFT kernels take run
``rfft2_planar``/``irfft2_planar``.  A single-channel dictionary with a
multi-channel signal folds the channels onto the signal axis, the mask
with them.
"""

import math

import torch

from sporco_tpu_torch import cnvrep as cr
from sporco_tpu_torch.models.cbpdn import host_array
from sporco_tpu_torch.models.ccmod import (ConvCnstrMODBase, _fftaxes, _norm,
                                           _pcn)
from sporco_tpu_torch.ops import fft as sf
from sporco_tpu_torch.ops import linalg as sl
from sporco_tpu_torch.solvers.admm import (ADMMOpts, ADMMProblem,
                                           AutoRhoOpts, init_state,
                                           tree_norm)

__all__ = ["ConvCnstrMODMaskDcpl_IterSM", "ConvCnstrMODMaskDcpl_CG",
           "ConvCnstrMODMaskDcpl_Consensus", "ConvCnstrMODMaskDcpl",
           "ConvCnstrMODMaskDcplOptions"]


def _setup(cfg, params):
    axes = _fftaxes(cfg.cri)
    Zf = sf.rfftn(params["Z"], axes=axes)
    return {"Zf": Zf, "Sf": sf.rfftn(params["S"], axes=axes),
            "ZHZ": torch.sum((Zf * Zf.conj()).real, dim=2, keepdim=True)}


def _irfft(cfg, Xf):
    return sf.irfftn(Xf, s=cfg.cri.Nv, axes=_fftaxes(cfg.cri))


def _zop(cfg, aux, Xf):
    """``sum_m z_km * d_m`` of a dictionary spectrum, per signal, back in
    the signal domain."""
    return _irfft(cfg, torch.sum(aux["Zf"] * Xf, dim=2, keepdim=True))


def _zero(params):
    """A zero that broadcasts over either block (the constant of the
    block without one)."""
    S = params["S"]
    return S.new_zeros((1,) * S.ndim)


def _masked_y(params, rho, V):
    """The prox of ``(1/2)||W y||^2`` at ``V - S``."""
    return rho * (V - params["S"]) / (params["W"] ** 2 + rho)


def _dfid(params, ZD):
    return 0.5 * torch.sum((params["W"] * (ZD - params["S"])) ** 2)


def _neg_pair(cfg, aux, params, Y):
    return (-Y[0], -Y[1])


# --- ism / cg: two blocks (Z-op; I), Y = (signal-shaped, dictionary) ------

def _xstep_2b(cfg, aux, params, state):
    axes = _fftaxes(cfg.cri)
    Y0, Y1 = state.Y
    U0, U1 = state.U
    Zf = aux["Zf"]
    YU0f = sf.rfftn(Y0 - U0 + params["S"], axes=axes)
    YU1f = sf.rfftn(Y1 - U1, axes=axes)
    b = torch.sum(Zf.conj() * YU0f, dim=0, keepdim=True) + YU1f
    if cfg.method == "ism":
        Xf = sl.solvemdbi_ism(Zf, 1.0, b, axisM=2, axisK=0)
    else:
        Xf, _ = sl.solvemdbi_cg(Zf, 1.0, b, axisM=2, axisK=0,
                                tol=cfg.cg_tol, max_iter=cfg.cg_max_iter)
    D = _irfft(cfg, Xf)
    ZDf = torch.sum(Zf * Xf, dim=2, keepdim=True)
    xaux = {"Xf": Xf}
    if cfg.lin_check:
        ZHZD = torch.sum(Zf.conj() * ZDf, dim=0, keepdim=True)
        xaux["xrrs"] = sl.rrs(ZHZD + Xf, b)
    return (D, _irfft(cfg, ZDf)), xaux


def _cnst_a_2b(cfg, aux, params, X):
    D, ZD = X
    return (ZD, D)


def _cnst_at_2b(cfg, aux, params, V):
    V0, V1 = V
    V0f = sf.rfftn(V0, axes=_fftaxes(cfg.cri))
    return _irfft(cfg, torch.sum(aux["Zf"].conj() * V0f, dim=0,
                                 keepdim=True)) + V1


def _cnst_c_2b(cfg, aux, params):
    return (params["S"], _zero(params))


def _ystep_2b(cfg, aux, params, state, AXU):
    A0, A1 = AXU
    return (_masked_y(params, state.rho, A0), _pcn(cfg, A1))


def _obfn_2b(cfg, aux, params, state, xaux):
    D1 = state.Y[1]
    xr = xaux["xrrs"] if cfg.lin_check else float("nan")
    return (_dfid(params, state.X[1]), _norm(_pcn(cfg, D1) - D1), xr)


def _yinit_2b(cfg, params):
    return (torch.zeros_like(params["S"]), params["D0"])


def _uinit_2b(cfg, params):
    return (torch.zeros_like(params["S"]), torch.zeros_like(params["D0"]))


def _xinit_2b(cfg, params):
    return (params["D0"], torch.zeros_like(params["S"]))


_STATS = ("DFid", "Cnstr", "XSlvRelRes")

_CCMODMD_2B = {
    m: ADMMProblem(setup=_setup, xstep=_xstep_2b, ystep=_ystep_2b,
                   obfn=_obfn_2b, cnst_a=_cnst_a_2b, cnst_at=_cnst_at_2b,
                   cnst_b=_neg_pair, cnst_c=_cnst_c_2b, yinit=_yinit_2b,
                   uinit=_uinit_2b, xinit=_xinit_2b, stat_names=_STATS)
    for m in ("ism", "cg")
}


# --- consensus with mask decoupling: Y = (the dictionary (1, Cd, M, Nv),
# the masked block (K, C, 1, Nv)); X and U carry one dictionary a signal

def _nb(params):
    return params["Z"].shape[0]


def _xstep_cnsm(cfg, aux, params, state):
    axes = _fftaxes(cfg.cri)
    DY, Y1 = state.Y
    DU, U1 = state.U
    Zf = aux["Zf"]
    # the x-step at unit penalty, its right-hand side from the mask block
    # (sporco/admm/ccmodmd.py:927-944)
    b = (Zf.conj() * (aux["Sf"] + sf.rfftn(Y1 - U1, axes=axes))
         + sf.rfftn(DY - DU, axes=axes))
    DXf = sl.solvedbi_sm(Zf, 1.0, b, axis=2, aah=aux["ZHZ"])
    return (_irfft(cfg, DXf), _zop(cfg, aux, DXf)), {"Xf": DXf}


def _cnst_c_cnsm(cfg, aux, params):
    return (_zero(params), params["S"])


def _ystep_cnsm(cfg, aux, params, state, AXU):
    A0, A1 = AXU
    return (_pcn(cfg, torch.mean(A0, dim=0, keepdim=True)),
            _masked_y(params, state.rho, A1))


def _sqrt_nb(params):
    """``sqrt(Nb)``, a number (rounded to the scalar type where it meets
    a tensor)."""
    return math.sqrt(float(_nb(params)))


def _cnsm_rsdl_r(cfg, aux, params, state, AXnr):
    # the residuals of the dictionary blocks only (the reference inherits
    # the consensus residuals, sporco/admm/ccmodmd.py:766)
    return AXnr[0] - state.Y[0]


def _cnsm_rsdl_s(cfg, aux, params, state, Yprev):
    w = state.rho * _sqrt_nb(params)
    return w * (Yprev[0] - state.Y[0])


def _cnsm_rsdl_rn(cfg, aux, params, state, AXnr):
    return torch.maximum(tree_norm(AXnr[0]),
                         _sqrt_nb(params) * tree_norm(state.Y[0]))


def _cnsm_rsdl_sn(cfg, aux, params, state):
    return state.rho * tree_norm(state.U[0])


def _obfn_cnsm(cfg, aux, params, state, xaux):
    DY = state.Y[0]
    return (_dfid(params, state.X[1]), _norm(_pcn(cfg, DY) - DY),
            float("nan"))


def _yinit_cnsm(cfg, params):
    return (params["D0"], torch.zeros_like(params["S"]))


def _uinit_cnsm(cfg, params):
    D0 = params["D0"]
    return (torch.zeros((_nb(params),) + tuple(D0.shape[1:]),
                        dtype=D0.dtype, device=D0.device),
            torch.zeros_like(params["S"]))


_CCMODMD_CNS = ADMMProblem(
    setup=_setup, xstep=_xstep_cnsm, ystep=_ystep_cnsm, obfn=_obfn_cnsm,
    cnst_b=_neg_pair, cnst_c=_cnst_c_cnsm, rsdl_r=_cnsm_rsdl_r,
    rsdl_s=_cnsm_rsdl_s, rsdl_rn=_cnsm_rsdl_rn, rsdl_sn=_cnsm_rsdl_sn,
    yinit=_yinit_cnsm, uinit=_uinit_cnsm, xinit=_uinit_cnsm,
    stat_names=_STATS)


class _MaskedCCMODBase(ConvCnstrMODBase):
    """The masked CCMOD solvers: :class:`ConvCnstrMODBase`'s construction
    and the fidelity mask ``W`` in the layout of ``S`` (``Nv + [C] +
    [K]``, singleton axes broadcast; None: no mask).  ``rho`` defaults to
    K for ``cns`` and 1 for ``ism``/``cg``; the state is made after the
    base constructor, whose ``Y0``/``U0`` it does not take, as in the JAX
    package."""

    @classmethod
    def options(cls, **kw):
        if cls.METHOD == "cns":
            return ConvCnstrMODBase.options(**kw)
        # the two-block defaults: rho 1, AutoRho off
        # (sporco/admm/ccmodmd.py:165-169)
        ar = kw.pop("auto_rho", AutoRhoOpts(enabled=False))
        base = dict(relax_param=1.8, auto_rho=ar, rho=1.0)
        base.update(kw)
        return ADMMOpts(**base)

    def __init__(self, Z, S, W, dsz, opt=None, **kw):
        if opt is None:
            opt = self.options()
        super().__init__(Z, S, dsz, opt=opt, **kw)
        cri, dtype = self.cri, self.opts.dtype
        if W is None:
            Wm = torch.ones((1,) * (3 + cri.dimN), dtype=dtype)
        else:
            Wm = cr.fidelity_mask(torch.as_tensor(host_array(W)).to(dtype),
                                  cri)
            if cri.Cd == 1 and cri.C > 1 and (Wm.shape[0] > 1
                                              or Wm.shape[1] > 1):
                # C folded onto K in S (sporco/admm/ccmodmd.py:283-300):
                # the mask folds alike
                Wm = Wm.expand((cri.K, cri.C, 1) + tuple(Wm.shape[3:]))
                Wm = Wm.reshape((cri.C * cri.K, 1, 1) + tuple(Wm.shape[3:]))
        self.params = {**self.params,
                       "W": Wm.contiguous().to(self.device)}
        self.problem = _CCMODMD_CNS if self.METHOD == "cns" \
            else _CCMODMD_2B[self.METHOD]
        if self.opts.rho is not None:
            rho0 = self.opts.rho
        else:
            rho0 = float(cri.K) if self.METHOD == "cns" else 1.0
        self.state = init_state(self.problem, self.cfg, self.params,
                                self.opts, rho0, float(self.state.rho_xi))

    def getdict_internal(self):
        return self.state.Y[0] if self.METHOD == "cns" else self.state.Y[1]

    def getdict(self, crop=True):
        D = self.getdict_internal()
        if crop:
            D = cr.bcrop(D, self.cri.dsz, self.cri.dimN)
        return cr.from_internal_D(D, self.cri)


class ConvCnstrMODMaskDcpl_IterSM(_MaskedCCMODBase):
    r"""Masked CCMOD with the iterated Sherman-Morrison x-step."""
    METHOD = "ism"


class ConvCnstrMODMaskDcpl_CG(_MaskedCCMODBase):
    r"""Masked CCMOD with the conjugate-gradient x-step."""
    METHOD = "cg"


class ConvCnstrMODMaskDcpl_Consensus(_MaskedCCMODBase):
    r"""Masked CCMOD by consensus: per-signal rank-1 solves batched over
    the K axis."""
    METHOD = "cns"


_METHODS = {"ism": ConvCnstrMODMaskDcpl_IterSM,
            "cg": ConvCnstrMODMaskDcpl_CG,
            "cns": ConvCnstrMODMaskDcpl_Consensus}


def ConvCnstrMODMaskDcpl(Z, S, W, dsz, opt=None, method="cns", **kw):
    """The masked CCMOD solver of ``method`` in {'ism', 'cg', 'cns'}
    (``sporco/admm/ccmodmd.py:1042``; default 'cns')."""
    return _METHODS[method](Z, S, W, dsz, opt=opt, **kw)


def ConvCnstrMODMaskDcplOptions(opt=None, method="cns", **kw):
    """The options of ``method``'s solver (``sporco/admm/ccmodmd.py:1101``):
    ``opt`` if given, else its defaults updated by ``kw``."""
    if opt is not None:
        return opt
    return _METHODS[method].options(**kw)
