"""Basis pursuit denoising and its relatives via ADMM (counterpart of
``sporco_tpu.models.bpdn``): ``BPDN``, ``BPDNJoint``, ``ElasticNet``,
``BPDNProjL1`` and the two-block ``MinL1InL2Ball``
(``sporco/admm/bpdn.py:271-920``).

The x-step solves ``(D^T D + rho I) x = D^T s + rho v`` with an
eigendecomposition of the Gram matrix made once at set-up
(:func:`sporco_tpu_torch.ops.linalg.gram_eig_factor`), so a change of
rho by AutoRho costs no new factorisation: two products a solve, on
cuBLAS in full fp32.  ``MinL1InL2Ball`` carries Y and U as pairs, which
the generic driver maps over.
"""

from dataclasses import dataclass

import torch

from sporco_tpu_torch import refopts
from sporco_tpu_torch._device import fp32_precision, resolve_device
from sporco_tpu_torch.models.common import (ADMMModel, default_rho_xi,
                                            user_tensor, warm_start)
from sporco_tpu_torch.ops import fft as sf
from sporco_tpu_torch.ops import linalg as sl
from sporco_tpu_torch.ops import prox as sp
from sporco_tpu_torch.solvers.admm import (ADMMOpts, ADMMProblem,
                                           AutoRhoOpts, const_div,
                                           init_state, scalar_type,
                                           tree_norm)

__all__ = ["BPDN", "BPDNJoint", "ElasticNet", "BPDNProjL1",
           "MinL1InL2Ball"]


@dataclass(frozen=True)
class BPDNConfig:
    variant: str = "l1"       # l1 | joint | elastic | projl1
    non_neg: bool = False
    obj_from_y: bool = True   # AuxVarObj (sporco/admm/bpdn.py:105)


def _ft(params):
    return scalar_type(params["D"].dtype)


def _setup(cfg, params):
    return {}


def _xstep(cfg, aux, params, state):
    # (D^T D + rho_eff I) x = D^T S + rho (Y - U), in split form
    rho = state.rho
    rho_eff = rho + _ft(params)(params["mu"]) if cfg.variant == "elastic" \
        else rho
    v = (rho / rho_eff) * (state.Y - state.U)
    return sl.gram_solve_atai_split(params["factor"], rho_eff, params["S"],
                                    v), None


def _ystep(cfg, aux, params, state, AXU):
    ft = _ft(params)
    rho = state.rho
    if cfg.variant == "projl1":
        Y = sp.proj_l1(AXU, params["gamma"], axis=0)
    elif cfg.variant == "joint":
        Y = sp.prox_sl1l2(AXU, const_div(ft(params["lmbda"]), rho)
                          * params["wl1"], const_div(ft(params["mu"]), rho),
                          axis=-1)
    else:
        Y = sp.prox_l1(AXU, const_div(ft(params["lmbda"]), rho)
                       * params["wl1"])
    if cfg.non_neg:
        Y = torch.clamp(Y, min=0.0)
    return Y


def _obfn(cfg, aux, params, state, xaux):
    V = state.Y if cfg.obj_from_y else state.X
    with fp32_precision():
        dfd = 0.5 * torch.sum((params["D"] @ V - params["S"]) ** 2)
    if cfg.variant == "projl1":
        prj = sp.proj_l1(V, params["gamma"], axis=0)
        return (dfd, torch.linalg.vector_norm(prj - V))
    lmbda, mu = params["lmbda"], params["mu"]
    rl1 = torch.sum(torch.abs(params["wl1"] * V))
    if cfg.variant == "joint":
        rl21 = torch.sum(torch.sqrt(torch.sum(V ** 2, dim=-1)))
        return (dfd + lmbda * rl1 + mu * rl21, dfd, rl1, rl21)
    if cfg.variant == "elastic":
        rl2 = 0.5 * torch.sum(V ** 2)
        return (dfd + lmbda * rl1 + mu * rl2, dfd, rl1, rl2)
    return (dfd + lmbda * rl1, dfd, rl1)


def _zeros_y(cfg, params):
    return torch.zeros_like(params["Y0"])


_STATS = {"l1": ("ObjFun", "DFid", "RegL1"),
          "joint": ("ObjFun", "DFid", "RegL1", "RegL21"),
          "elastic": ("ObjFun", "DFid", "RegL1", "RegL2"),
          "projl1": ("DFid", "Cnstr")}

_PROBLEMS = {
    v: ADMMProblem(setup=_setup, xstep=_xstep, ystep=_ystep, obfn=_obfn,
                   yinit=_zeros_y, uinit=_zeros_y, stat_names=names)
    for v, names in _STATS.items()}


def _dense(D, S, dtype, device):
    """D (N, M) and S (N, K) (or (N,)) as tensors of ``dtype`` on
    ``device``."""
    D = user_tensor(D, dtype, device)
    S = user_tensor(S, dtype, device)
    if S.ndim == 1:
        S = S[:, None]
    return D, S


def _bpdn_options(rsdl_target=None, **kw):
    """ADMM options with the BPDN family's defaults: RelaxParam 1.8,
    AutoRho enabled with AutoScaling, Scaling 1000, RsdlRatio 1.2,
    Period 10 (``sporco/admm/bpdn.py:106-111``)."""
    ar = kw.pop("auto_rho", AutoRhoOpts(enabled=True, period=10,
                                        auto_scaling=True, scaling=1000.0,
                                        rsdl_ratio=1.2,
                                        rsdl_target=rsdl_target))
    base = dict(relax_param=1.8, auto_rho=ar)
    base.update(kw)
    return ADMMOpts(**base)


class BPDN(ADMMModel):
    r"""ADMM solver for BPDN, ``argmin_x (1/2)||Dx - s||_2^2 +
    lmbda ||x||_1`` (``sporco/admm/bpdn.py:271``).

    ``D`` is (N, M) and ``S`` (N, K) or (N,): numpy arrays or tensors.
    The solution ``X`` is (M, K), a tensor on the model's device.
    ``device=None`` means the CUDA device and raises without one; pass
    ``device="cpu"`` for the CPU.  Defaults as the reference: rho
    ``50 lmbda + 1``, lmbda ``0.1 max|D^T s|``
    (``sporco/admm/bpdn.py:406,419``).
    """

    VARIANT = "l1"
    STAT_NAMES = _STATS["l1"]

    REF_OPT_EXTRA = {
        **refopts._ADMM_EQUAL,
        "AuxVarObj": ("k", "obj_from_y"),
        "LinSolveCheck": refopts.WARN,
        "NonNegCoef": ("k", "non_neg"),
        "L1Weight": ("k", "wl1"),
    }

    @staticmethod
    def options(**kw):
        """:class:`ADMMOpts` with this model's defaults."""
        return _bpdn_options(**kw)

    def __init__(self, D, S, lmbda=None, opt=None, wl1=1.0, mu=0.0,
                 gamma=None, non_neg=False, dtype=torch.float32, Y0=None,
                 U0=None, obj_from_y=True, device=None):
        super().__init__()
        self.device = resolve_device(device)
        if opt is None:
            opt = self.options()
        dtype = sf.torch_dtype(dtype)
        D, S = _dense(D, S, dtype, self.device)
        if lmbda is None:
            with fp32_precision():
                lmbda = 0.1 * float(torch.max(torch.abs(D.T @ S)))
        self.lmbda = lmbda
        self.cfg = BPDNConfig(variant=self.VARIANT, non_neg=non_neg,
                              obj_from_y=obj_from_y)
        self.opts = opt.replace(dtype=dtype)
        ft = scalar_type(dtype)
        M, K = D.shape[1], S.shape[1]
        self.params = {
            "D": D, "S": S, "factor": sl.gram_eig_factor(D),
            "lmbda": ft(lmbda), "mu": ft(mu),
            "wl1": user_tensor(wl1, dtype, self.device),
            "gamma": ft(0.0 if gamma is None else gamma),
            "Y0": torch.zeros((M, K), dtype=dtype, device=self.device),
        }
        self.problem = _PROBLEMS[self.VARIANT]
        rho0 = opt.rho if opt.rho is not None else 50.0 * lmbda + 1.0
        rho_xi = (opt.auto_rho.rsdl_target
                  if opt.auto_rho.rsdl_target is not None
                  else default_rho_xi(lmbda))
        self.state = init_state(self.problem, self.cfg, self.params,
                                self.opts, rho0, rho_xi,
                                Y0=warm_start(Y0, dtype, self.device),
                                U0=warm_start(U0, dtype, self.device))
        self._init_done()

    def getmin(self):
        return self.state.Y

    def getcoef(self):
        return self.state.Y

    def reconstruct(self, X=None):
        """``D X``, with the model's coefficients by default."""
        if X is None:
            X = self.getcoef()
        with fp32_precision():
            return self.params["D"] @ user_tensor(X, self.opts.dtype,
                                                  self.device)


class BPDNJoint(BPDN):
    r"""BPDN with joint sparsity: adds ``mu ||X||_{2,1}``, the l2 norm
    over the signal axis (``sporco/admm/bpdn.py:469``)."""

    VARIANT = "joint"
    STAT_NAMES = _STATS["joint"]

    def __init__(self, D, S, lmbda=None, mu=0.0, opt=None, **kw):
        super().__init__(D, S, lmbda=lmbda, mu=mu, opt=opt, **kw)


class ElasticNet(BPDN):
    r"""Elastic net, ``(1/2)||Dx - s||^2 + lmbda ||x||_1 +
    (mu/2) ||x||_2^2`` (``sporco/admm/bpdn.py:592``): the x-step solves
    with ``mu + rho`` on the same Gram factor."""

    VARIANT = "elastic"
    STAT_NAMES = _STATS["elastic"]

    def __init__(self, D, S, lmbda=None, mu=0.0, opt=None, **kw):
        super().__init__(D, S, lmbda=lmbda, mu=mu, opt=opt, **kw)


class BPDNProjL1(BPDN):
    r"""Minimise the data fidelity subject to ``||x||_1 <= gamma`` per
    signal column (``sporco/admm/bpdn.py:750``)."""

    VARIANT = "projl1"
    STAT_NAMES = _STATS["projl1"]

    @staticmethod
    def options(**kw):
        return _bpdn_options(rsdl_target=1.0, **kw)

    def __init__(self, D, S, gamma, opt=None, **kw):
        if opt is None:
            opt = self.options()
        if opt.rho is None:
            opt = opt.replace(rho=1.0)
        super().__init__(D, S, lmbda=1.0, gamma=gamma, opt=opt, **kw)


# ---------------------------------------------------------------------------
# MinL1InL2Ball: two constraint blocks, (I; D) x = (y0; y1)

@dataclass(frozen=True)
class MinL1Config:
    non_neg: bool = False


def _ml1_xstep(cfg, aux, params, state):
    # (I + D^T D) x = (Y0 - U0) + D^T (Y1 - U1): exactly the split form
    Y0, Y1 = state.Y
    U0, U1 = state.U
    return sl.gram_solve_atai_split(params["factor"], 1.0, Y1 - U1,
                                    Y0 - U0), None


def _ml1_ystep(cfg, aux, params, state, AXU):
    A0, A1 = AXU
    Y0 = sp.prox_l1(A0, params["wl1"] / state.rho)
    if cfg.non_neg:
        Y0 = torch.clamp(Y0, min=0.0)
    S = params["S"]
    return (Y0, S + sp.proj_l2(A1 - S, params["epsilon"], axis=0))


def _ml1_cnst_a(cfg, aux, params, X):
    with fp32_precision():
        return (X, params["D"] @ X)


def _ml1_cnst_at(cfg, aux, params, V):
    with fp32_precision():
        return V[0] + params["D"].T @ V[1]


def _ml1_obfn(cfg, aux, params, state, xaux):
    Y0, Y1 = state.Y
    S = params["S"]
    prj = S + sp.proj_l2(Y1 - S, params["epsilon"], axis=0)
    return (torch.sum(torch.abs(params["wl1"] * Y0)),
            torch.linalg.vector_norm(prj - Y1))


def _ml1_zeros(cfg, params):
    return (torch.zeros_like(params["Y0"]), torch.zeros_like(params["S"]))


def _ml1_xinit(cfg, params):
    return torch.zeros_like(params["Y0"])


def _ml1_rsdl_s(cfg, aux, params, state, Yprev):
    """Two-block dual residual ``rho A^T U``
    (``sporco/admm/bpdn.py:1160-1168``)."""
    return state.rho * _ml1_cnst_at(cfg, aux, params, state.U)


def _ml1_rsdl_sn(cfg, aux, params, state):
    return state.rho * tree_norm(state.U)


_ML1_PROBLEM = ADMMProblem(
    setup=_setup, xstep=_ml1_xstep, ystep=_ml1_ystep, obfn=_ml1_obfn,
    cnst_a=_ml1_cnst_a, cnst_at=_ml1_cnst_at, yinit=_ml1_zeros,
    uinit=_ml1_zeros, xinit=_ml1_xinit, rsdl_s=_ml1_rsdl_s,
    rsdl_sn=_ml1_rsdl_sn, stat_names=("ObjFun", "Cnstr"))


class MinL1InL2Ball(ADMMModel):
    r"""Minimise ``||x||_1`` subject to ``||Dx - s||_2 <= epsilon``
    (``sporco/admm/bpdn.py:920``) as the two-block splitting
    ``(I; D) x = (y0; y1)``: an l1 prox on ``y0`` and a projection on
    the l2 ball about ``s`` on ``y1``.  ``Y0``/``U0`` warm starts are
    pairs ``((M, K), (N, K))``."""

    STAT_NAMES = ("ObjFun", "Cnstr")

    REF_OPT_EXTRA = {
        **refopts._ADMM_EQUAL,
        "AuxVarObj": refopts.IGNORE,
        "NonNegCoef": ("k", "non_neg"),
        "L1Weight": ("k", "wl1"),
    }

    @staticmethod
    def options(**kw):
        return _bpdn_options(rsdl_target=1.0, **kw)

    def __init__(self, D, S, epsilon, opt=None, wl1=1.0, non_neg=False,
                 dtype=torch.float32, Y0=None, U0=None, device=None):
        super().__init__()
        self.device = resolve_device(device)
        if opt is None:
            opt = self.options()
        dtype = sf.torch_dtype(dtype)
        D, S = _dense(D, S, dtype, self.device)
        self.cfg = MinL1Config(non_neg=non_neg)
        self.opts = opt.replace(dtype=dtype)
        ft = scalar_type(dtype)
        M, K = D.shape[1], S.shape[1]
        self.params = {
            "D": D, "S": S, "factor": sl.gram_eig_factor(D),
            "epsilon": ft(epsilon),
            "wl1": user_tensor(wl1, dtype, self.device),
            "Y0": torch.zeros((M, K), dtype=dtype, device=self.device),
        }
        self.problem = _ML1_PROBLEM

        def pair(A):
            return None if A is None else tuple(
                user_tensor(a, dtype, self.device) for a in A)
        rho0 = opt.rho if opt.rho is not None else 1.0
        self.state = init_state(self.problem, self.cfg, self.params,
                                self.opts, rho0, 1.0, Y0=pair(Y0),
                                U0=pair(U0))
        self._init_done()

    def getmin(self):
        return self.state.X

    def getcoef(self):
        return self.state.X

    def reconstruct(self, X=None):
        """``D X``, with the model's coefficients by default."""
        if X is None:
            X = self.getcoef()
        with fp32_precision():
            return self.params["D"] @ user_tensor(X, self.opts.dtype,
                                                  self.device)
