"""Convolutional constrained MOD, the dictionary update of convolutional
dictionary learning, by ADMM (counterpart of ``sporco_tpu.models.ccmod``).

The x-step runs three ways (``sporco/admm/ccmod.py``): iterated
Sherman-Morrison over the signal axis (``ism``, ``:433``), conjugate
gradient (``cg``, ``:511``), or the consensus formulation (``cns``,
``:613``), where each signal has its own copy of the dictionary, the
copies are solved as one batched rank-1 Sherman-Morrison solve over the
leading K axis and the y-step projects their mean onto the constraint
set.  All three run on the generic ADMM driver
(:func:`sporco_tpu_torch.solvers.admm.admm_solve`); the consensus
problem replaces its residuals and their normalisers through the
driver's ``rsdl_*`` hooks, as the JAX package does.

Layouts are internal: coefficients ``Z`` (K, Cx, M, N0, N1...), signals
``S`` (K, C, 1, N0, N1...) and the dictionary (1, Cd, M, N0, N1...)
zero-padded to the signal size.  A single-channel dictionary with a
multi-channel signal folds the channels into the signal axis
(``sporco/admm/ccmod.py:270-280``).
"""

import math
from dataclasses import dataclass

import numpy as np
import torch

from sporco_tpu_torch import cnvrep as cr
from sporco_tpu_torch import refopts
from sporco_tpu_torch._device import resolve_device
from sporco_tpu_torch.models.common import ADMMModel, user_tensor
from sporco_tpu_torch.ops import fft as sf
from sporco_tpu_torch.ops import linalg as sl
from sporco_tpu_torch.solvers.admm import (ADMMOpts, ADMMProblem,
                                           AutoRhoOpts, init_state)

__all__ = ["CCMODConfig", "ConvCnstrMODBase", "ConvCnstrMOD_IterSM",
           "ConvCnstrMOD_CG", "ConvCnstrMOD_Consensus", "ConvCnstrMOD",
           "ConvCnstrMODOptions"]


@dataclass(frozen=True)
class CCMODConfig:
    cri: cr.CDUIndex
    method: str = "cns"        # ism | cg | cns
    zero_mean: bool = False
    cg_tol: float = 1e-3
    cg_max_iter: int = 1000
    lin_check: bool = False
    real: bool = True


def _fftaxes(cri):
    return tuple(range(-cri.dimN, 0))


def _cfwd(cfg, x, axes):
    return sf.rfftn(x, axes=axes) if cfg.real else sf.fftn(x, axes=axes)


def _cinv(cfg, xf, Nv, axes):
    if cfg.real:
        return sf.irfftn(xf, s=Nv, axes=axes)
    return sf.ifftn(xf, s=Nv, axes=axes)


def _cpn2(cfg, xf, Nv, axes):
    if cfg.real:
        return sf.rfl2norm2(xf, Nv, axis=axes)
    return sf.fl2norm2(xf, axis=axes)


def _pcn(cfg, V):
    return cr.Pcn(V, cfg.cri.dsz, cfg.cri.Nv, dimN=cfg.cri.dimN,
                  zm=cfg.zero_mean)


def _norm(x):
    return torch.linalg.vector_norm(x.reshape(-1))


def _nblocks(cri):
    """Number of consensus blocks: the signals, times the channels when a
    single-channel dictionary meets a multi-channel signal."""
    return cri.K * (1 if cri.C == cri.Cd else cri.C)


def _setup(cfg, params):
    axes = _fftaxes(cfg.cri)
    Zf = _cfwd(cfg, params["Z"], axes)
    Sf = _cfwd(cfg, params["S"], axes)
    ZSf = Zf.conj() * Sf                     # per signal (K kept)
    aux = {"Zf": Zf, "Sf": Sf}
    if cfg.method != "cns":
        ZSf = torch.sum(ZSf, dim=0, keepdim=True)
    else:
        # rho-independent per-bin coefficient energy of the batched
        # rank-1 solves
        aux["ZHZ"] = torch.sum((Zf * Zf.conj()).real, dim=2, keepdim=True)
    aux["ZSf"] = ZSf
    return aux


def _dfd(cfg, aux, Xf):
    Ef = torch.sum(aux["Zf"] * Xf, dim=2, keepdim=True) - aux["Sf"]
    return 0.5 * _cpn2(cfg, Ef, cfg.cri.Nv, _fftaxes(cfg.cri))


def _obfn(cfg, aux, params, state, xaux):
    # fEvalX (sporco/admm/ccmod.py:138): DFid from Xf, Cnstr from Y
    cns = _norm(_pcn(cfg, state.Y) - state.Y)
    xr = xaux["xrrs"] if cfg.lin_check else np.nan
    return (_dfd(cfg, aux, xaux["Xf"]), cns, xr)


def _yinit(cfg, params):
    return params["D0"]


# --- single-variable methods (ism / cg) ------------------------------------

def _xstep_single(cfg, aux, params, state):
    axes = _fftaxes(cfg.cri)
    rho = state.rho
    b = aux["ZSf"] + rho * _cfwd(cfg, state.Y - state.U, axes)
    if cfg.method == "ism":
        Xf = sl.solvemdbi_ism(aux["Zf"], rho, b, axisM=2, axisK=0)
    else:
        Xf, _ = sl.solvemdbi_cg(aux["Zf"], rho, b, axisM=2, axisK=0,
                                tol=cfg.cg_tol, max_iter=cfg.cg_max_iter)
    X = _cinv(cfg, Xf, cfg.cri.Nv, axes)
    xaux = {"Xf": Xf}
    if cfg.lin_check:
        Zop = torch.sum(aux["Zf"] * Xf, dim=2, keepdim=True)
        ZHZX = torch.sum(aux["Zf"].conj() * Zop, dim=0, keepdim=True)
        xaux["xrrs"] = sl.rrs(ZHZX + rho * Xf, b)
    return X, xaux


def _ystep_single(cfg, aux, params, state, AXU):
    return _pcn(cfg, AXU)


def _uinit_single(cfg, params):
    return torch.zeros_like(params["D0"])


_CCMOD_SINGLE = {
    m: ADMMProblem(setup=_setup, xstep=_xstep_single, ystep=_ystep_single,
                   obfn=_obfn, yinit=_yinit, uinit=_uinit_single,
                   stat_names=("DFid", "Cnstr", "XSlvRelRes"))
    for m in ("ism", "cg")
}


# --- the consensus method --------------------------------------------------
# blocks = signals on the leading K axis: X/U are (K, Cd, M, Nv...), Y is
# (1, Cd, M, Nv...); broadcasting over axis 0 replicates Y per block.

def _xstep_cns(cfg, aux, params, state):
    axes = _fftaxes(cfg.cri)
    rho = state.rho
    YU = state.Y - state.U
    b = aux["ZSf"] + rho * _cfwd(cfg, YU, axes)
    Xf = sl.solvedbi_sm(aux["Zf"], rho, b, axis=2, aah=aux["ZHZ"])
    X = _cinv(cfg, Xf, cfg.cri.Nv, axes)
    xaux = {"Xf": Xf}
    if cfg.lin_check:
        ZSfs = torch.sum(aux["ZSf"], dim=0, keepdim=True)
        YUs = torch.sum(YU, dim=0, keepdim=True)
        bs = ZSfs + rho * _cfwd(cfg, YUs, axes)
        Zop = torch.sum(aux["Zf"] * Xf, dim=2, keepdim=True)
        ax = torch.sum(aux["Zf"].conj() * Zop + rho * Xf, dim=0,
                       keepdim=True)
        xaux["xrrs"] = sl.rrs(ax, bs)
    return X, xaux


def _ystep_cns(cfg, aux, params, state, AXU):
    return _pcn(cfg, torch.mean(AXU, dim=0, keepdim=True))


def _cns_rsdl_s(cfg, aux, params, state, Yprev):
    w = state.rho * math.sqrt(float(_nblocks(cfg.cri)))
    return w * (Yprev - state.Y)


def _cns_rsdl_sn(cfg, aux, params, state):
    return state.rho * _norm(state.U)


def _cns_rsdl_rn(cfg, aux, params, state, AXnr):
    return torch.maximum(
        _norm(AXnr), math.sqrt(float(_nblocks(cfg.cri))) * _norm(state.Y))


def _cns_cnst_b(cfg, aux, params, Y):
    return -Y        # broadcasts over the block (K) axis


def _uinit_cns(cfg, params):
    Nb = params["Z"].shape[0]
    D0 = params["D0"]
    return torch.zeros((Nb,) + tuple(D0.shape[1:]), dtype=D0.dtype,
                       device=D0.device)


_CCMOD_CNS = ADMMProblem(
    setup=_setup, xstep=_xstep_cns, ystep=_ystep_cns, obfn=_obfn,
    cnst_b=_cns_cnst_b, rsdl_s=_cns_rsdl_s, rsdl_sn=_cns_rsdl_sn,
    rsdl_rn=_cns_rsdl_rn, yinit=_yinit, uinit=_uinit_cns,
    xinit=_uinit_cns, stat_names=("DFid", "Cnstr", "XSlvRelRes"))


class ConvCnstrMODBase(ADMMModel):
    r"""The CCMOD solvers: ``argmin_d (1/2) sum_k ||sum_m d_m * z_{k,m} -
    s_k||^2`` over unit-norm filters of the ``dsz`` support.  ``Z`` is in
    the reference's coefficient layout ``Nv + (Cx, K, M)``, ``S`` in
    ``Nv + [C] + [K]``; ``dsz`` is a dictionary size spec (single- or
    multi-scale).  Arguments are numpy arrays; ``device=None`` means the
    CUDA device and raises without one, ``device="cpu"`` runs on the CPU.

    Defaults mirror the reference (``sporco/admm/ccmod.py:138-146,264``):
    RelaxParam 1.8, AutoRho enabled with Period 1, AutoScaling, Scaling
    1000, RsdlRatio 1.2 and RsdlTarget 1, rho = K."""

    # reference ConvCnstrMOD option keys (sporco/admm/ccmod.py:131-147)
    REF_OPT_EXTRA = {
        **refopts._ADMM_EQUAL,
        "AuxVarObj": refopts.IGNORE,
        "ZeroMean": ("k", "zero_mean"),
        "LinSolveCheck": ("k", "lin_check"),
        "CG": ("sub", {"StopTol": ("k", "cg_tol"),
                       "MaxIter": ("k", "cg_max_iter")}),
    }

    METHOD = "ism"
    STAT_NAMES = ("DFid", "Cnstr", "XSlvRelRes")

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

    def __init__(self, Z, S, dsz, opt=None, dimK=None, dimN=2, D0=None,
                 zero_mean=False, cg_tol=1e-3, cg_max_iter=1000,
                 lin_check=False, dtype=torch.float32, Y0=None, U0=None,
                 device=None):
        super().__init__()
        self.device = resolve_device(device)
        if opt is None:
            opt = self.options()
        dtype = sf.torch_dtype(dtype)
        S = np.asarray(S)
        real = not (np.iscomplexobj(S)
                    or (Z is not None and np.iscomplexobj(np.asarray(Z))))
        if not real:
            dtype = sf.complex_dtype(dtype)
        npdt = sf.numpy_dtype(dtype)
        cri = cr.cdu_index(dsz, S.shape, dimK=dimK, dimN=dimN)
        self.cri = cri
        csc_like = cri.csc_like()
        Si = cr.to_internal_S(torch.as_tensor(S.astype(npdt)), cri)
        if Z is not None:
            Zi = cr.to_internal_X(torch.as_tensor(
                np.asarray(Z).astype(npdt)), csc_like)
        else:
            Zi = torch.zeros(cri.shpX, dtype=dtype)
        # single-channel dictionary, multi-channel signal: fold C onto K
        if cri.Cd == 1 and cri.C > 1:
            K2 = cri.C * cri.K
            Zi = Zi.reshape((K2, 1) + tuple(Zi.shape[2:]))
            Si = Si.reshape((K2, 1, 1) + tuple(cri.Nv))
        if D0 is None:
            D0i = torch.zeros(cri.shpD, dtype=dtype)
        else:
            D0i = cr.zpad(cr.to_internal_D(torch.as_tensor(
                np.asarray(D0).astype(npdt)), csc_like), cri.Nv)
        self.cfg = CCMODConfig(cri=cri, method=self.METHOD,
                               zero_mean=zero_mean, cg_tol=cg_tol,
                               cg_max_iter=cg_max_iter,
                               lin_check=lin_check, real=real)
        self.opts = opt.replace(dtype=dtype)

        def dev(t):
            return t.contiguous().to(self.device)
        self.params = {"Z": dev(Zi), "S": dev(Si), "D0": dev(D0i)}
        self.problem = _CCMOD_CNS if self.METHOD == "cns" \
            else _CCMOD_SINGLE[self.METHOD]
        rho0 = opt.rho if opt.rho is not None else float(cri.K)
        rho_xi = (opt.auto_rho.rsdl_target
                  if opt.auto_rho.rsdl_target is not None else 1.0)

        def state_arg(A):
            return None if A is None else self._tensor(A, dtype)
        self.state = init_state(self.problem, self.cfg, self.params,
                                self.opts, rho0, rho_xi, Y0=state_arg(Y0),
                                U0=state_arg(U0))
        self._init_done()

    def getmin(self):
        return self.getdict()

    def getdict(self, crop=True):
        """The dictionary in the user layout ``dsz + [Cd] + (M,)``, cropped
        to the filter support unless ``crop`` is False."""
        D = self.state.Y
        if crop:
            D = cr.bcrop(D, self.cri.dsz, self.cri.dimN)
        return cr.from_internal_D(D, self.cri)

    def getdict_internal(self):
        """The full-support dictionary in the internal layout (the
        dictionary learning loop)."""
        return self.state.Y

    def setcoef(self, Z, internal=False):
        """Replace the coefficients (the dictionary learning loop):
        reference layout ``Nv + (Cx, K, M)``, or with ``internal`` the
        internal ``(K, Cx, M, Nv...)``; a tensor (on any device) is taken
        as it is."""
        cri = self.cri
        if not internal:
            Z = cr.to_internal_X(user_tensor(Z, self.opts.dtype,
                                             self.device), cri.csc_like())
        if cri.Cd == 1 and cri.C > 1:
            Z = Z.reshape((cri.C * cri.K, 1) + tuple(Z.shape[2:]))
        self.params = {**self.params,
                       "Z": Z.contiguous().to(self.device, self.opts.dtype)}


class ConvCnstrMOD_IterSM(ConvCnstrMODBase):
    r"""CCMOD with the iterated Sherman-Morrison x-step (O(K^2): for small
    K)."""
    METHOD = "ism"


class ConvCnstrMOD_CG(ConvCnstrMODBase):
    r"""CCMOD with the conjugate-gradient x-step."""
    METHOD = "cg"


class ConvCnstrMOD_Consensus(ConvCnstrMODBase):
    r"""CCMOD by consensus ADMM: per-signal rank-1 solves batched over the
    K axis, the dictionary consensus a mean."""
    METHOD = "cns"


_METHODS = {"ism": ConvCnstrMOD_IterSM, "cg": ConvCnstrMOD_CG,
            "cns": ConvCnstrMOD_Consensus}


def ConvCnstrMOD(Z, S, dsz, opt=None, method="cns", **kwargs):
    """The CCMOD solver of ``method`` in {'ism', 'cg', 'cns'}
    (``sporco/admm/ccmod.py:914-1001``; default 'cns')."""
    return _METHODS[method](Z, S, dsz, opt=opt, **kwargs)


def ConvCnstrMODOptions(opt=None, method="cns", **kw):
    """The options of ``method``'s solver (``sporco/admm/ccmod.py:970``):
    ``opt`` if given, else its defaults updated by ``kw``."""
    cls = _METHODS[method]
    if opt is not None:
        return opt
    return cls.options(**kw)
