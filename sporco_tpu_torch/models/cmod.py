"""The constrained MOD dictionary update by ADMM (counterpart of
``sporco_tpu.models.cmod``; ``sporco/admm/cmod.py:21``).

``argmin_D (1/2)||D Z - S||_2^2`` subject to unit-norm columns of ``D``:
the x-step solves ``D (Z Z^T + rho I) = S Z^T + rho (Y - U)`` in split
form with an eigendecomposition of the Gram matrix of ``Z`` made when
``Z`` is set (:func:`sporco_tpu_torch.ops.linalg.gram_eig_factor`), so a
change of rho by AutoRho costs no new factorisation; the y-step projects
the columns onto the constraint set.
"""

from dataclasses import dataclass

import torch

from sporco_tpu_torch import refopts
from sporco_tpu_torch._device import fp32_precision, resolve_device
from sporco_tpu_torch.models.common import ADMMModel, user_tensor
from sporco_tpu_torch.ops import fft as sf
from sporco_tpu_torch.ops import linalg as sl
from sporco_tpu_torch.solvers.admm import (ADMMOpts, ADMMProblem,
                                           AutoRhoOpts, init_state)

__all__ = ["CnstrMOD", "getPcn", "zeromean", "normalise", "random_dict"]


def zeromean(v):
    """Subtract the column means (``sporco/admm/cmod.py:286``)."""
    return v - torch.mean(v, dim=0, keepdim=True)


def normalise(v):
    """Columns of unit l2 norm; a zero column stays zero
    (``sporco/admm/cmod.py:339``)."""
    n = torch.sqrt(torch.sum(v ** 2, dim=0, keepdim=True))
    return v / torch.where(n == 0.0, torch.ones_like(n), n)


def getPcn(zm):
    """The column constraint-set projection (``sporco/admm/cmod.py:286``),
    with the column means removed first under ``zm``."""
    if zm:
        return lambda x: normalise(zeromean(x))
    return normalise


def random_dict(N, M, dtype, device):
    """The default initial dictionary: an (N, M) draw from a
    ``torch.Generator`` seeded 0 on ``device``, its columns normalised.
    The JAX package draws from ``PRNGKey(0)``, which cannot be
    reproduced here: pass its draw as ``D0`` to run the same problem."""
    g = torch.Generator(device=device).manual_seed(0)
    return normalise(torch.randn((N, M), generator=g, dtype=dtype,
                                 device=device))


@dataclass(frozen=True)
class CMODConfig:
    zero_mean: bool = False


def _setup(cfg, params):
    return {}


def _xstep(cfg, aux, params, state):
    # D (Z Z^T + rho I) = S Z^T + rho (Y - U), in split form
    return sl.gram_solve_aati_split(params["factor"], state.rho,
                                    params["S"], state.Y - state.U), None


def _ystep(cfg, aux, params, state, AXU):
    return getPcn(cfg.zero_mean)(AXU)


def _obfn(cfg, aux, params, state, xaux):
    # AuxVarObj: the objective at Y (sporco/admm/cmod.py:101)
    Y = state.Y
    with fp32_precision():
        dfd = 0.5 * torch.sum((Y @ params["Z"] - params["S"]) ** 2)
    return (dfd, torch.linalg.vector_norm(getPcn(cfg.zero_mean)(Y) - Y))


def _yinit(cfg, params):
    return params["D0"]


def _uinit(cfg, params):
    return torch.zeros_like(params["D0"])


_CMOD = ADMMProblem(setup=_setup, xstep=_xstep, ystep=_ystep, obfn=_obfn,
                    yinit=_yinit, uinit=_uinit,
                    stat_names=("DFid", "Cnstr"))


class CnstrMOD(ADMMModel):
    r"""ADMM constrained MOD dictionary update.  ``Z`` is (M, K), ``S``
    (N, K): numpy arrays or tensors; the dictionary ``D`` is (N, M) with
    unit-norm columns, a tensor on the model's device.  ``D0=None``
    draws the initial dictionary with :func:`random_dict`.  Defaults as
    the reference: AutoRho on with Period 10, rho ``K / 500``
    (``sporco/admm/cmod.py:104,185``).  ``device=None`` means the CUDA
    device and raises without one; ``device="cpu"`` runs on the CPU."""

    STAT_NAMES = ("DFid", "Cnstr")

    # reference CnstrMOD option keys (sporco/admm/cmod.py:106-118)
    REF_OPT_EXTRA = {
        **refopts._ADMM_EQUAL,
        "AuxVarObj": refopts.IGNORE,
        "ZeroMean": ("k", "zero_mean"),
    }

    @staticmethod
    def options(**kw):
        ar = kw.pop("auto_rho", AutoRhoOpts(enabled=True, period=10,
                                            auto_scaling=True,
                                            scaling=1000.0,
                                            rsdl_ratio=1.2))
        base = dict(relax_param=1.8, auto_rho=ar)
        base.update(kw)
        return ADMMOpts(**base)

    def __init__(self, Z, S, dsz=None, opt=None, D0=None, zero_mean=False,
                 dtype=torch.float32, Y0=None, U0=None, device=None):
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
        self.cfg = CMODConfig(zero_mean=zero_mean)
        self.opts = opt.replace(dtype=dtype)
        self.params = {"Z": Z, "S": S, "factor": sl.gram_eig_factor(Z),
                       "D0": D0}
        self.problem = _CMOD
        rho0 = opt.rho if opt.rho is not None else S.shape[1] / 500.0
        rho_xi = (opt.auto_rho.rsdl_target
                  if opt.auto_rho.rsdl_target is not None else 1.0)

        def warm(A):
            return None if A is None else user_tensor(A, dtype, self.device)
        self.state = init_state(self.problem, self.cfg, self.params,
                                self.opts, rho0, rho_xi, Y0=warm(Y0),
                                U0=warm(U0))
        self._init_done()

    def getdict(self):
        return self.state.Y

    def setcoef(self, Z):
        """Replace the coefficients (the dictionary learning loop) and
        make the Gram eigendecomposition anew; a tensor (on any device) is
        taken as it is."""
        Z = user_tensor(Z, self.opts.dtype, self.device)
        self.params = {**self.params, "Z": Z,
                       "factor": sl.gram_eig_factor(Z)}
