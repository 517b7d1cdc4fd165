"""Robust PCA via ADMM (counterpart of ``sporco_tpu.models.rpca``;
``sporco/admm/rpca.py:23``): ``argmin_{X,Y} ||X||_* + lmbda ||Y||_1``
subject to ``X + Y = S``.  The x-step is singular-value soft
thresholding, by a full SVD or, with ``svd_rank``, by a randomized
subspace iteration; the y-step is elementwise shrinkage.  On the card
the SVD is ``ops/svd.py``'s Jacobi kernels, whose sweeps are a WHILE
node of the captured iteration: the problem takes the graph route, for
a real ``S`` and for a complex one (``dtype=torch.complex64`` or
``complex128``, the complex form of the kernels; the stats rows are
real).
"""

from dataclasses import dataclass
from typing import Optional

import torch

from sporco_tpu_torch import refopts
from sporco_tpu_torch._device import fp32_precision, resolve_device
from sporco_tpu_torch.models.common import ADMMModel, user_tensor
from sporco_tpu_torch.ops import fft as sf
from sporco_tpu_torch.ops import prox as sp
from sporco_tpu_torch.ops import svd as ssvd
from sporco_tpu_torch.solvers.admm import (ADMMOpts, ADMMProblem,
                                           AutoRhoOpts, const_div,
                                           init_state, scalar_type)

__all__ = ["RobustPCA"]


@dataclass(frozen=True)
class RPCAConfig:
    svd_rank: Optional[int] = None   # None: the full SVD
    svd_iters: int = 2


def _setup(cfg, params):
    # the x-step's SVD kernels, real and complex, built and loaded before
    # the loop captures
    ssvd.prepare(params["S"].device)
    return {}


def _xstep(cfg, aux, params, state):
    ft = scalar_type(params["S"].dtype)
    with fp32_precision():
        X, ss = sp.prox_nuclear(params["S"] - state.Y - state.U,
                                const_div(ft(1.0), state.rho),
                                rank=cfg.svd_rank,
                                n_iter=cfg.svd_iters,
                                sketch=params.get("sketch"))
    return X, {"ss": ss}


def _ystep(cfg, aux, params, state, AXU):
    # AXU = AX + U; the reference's y-step is prox_l1(S - AX - U, ...)
    ft = scalar_type(params["S"].dtype)
    return sp.prox_l1(params["S"] - AXU,
                      const_div(ft(params["lmbda"]), state.rho))


def _cnst_b(cfg, aux, params, Y):
    return Y          # the constraint is X + Y = S


def _cnst_c(cfg, aux, params):
    return params["S"]


def _obfn(cfg, aux, params, state, xaux):
    rnn = torch.sum(xaux["ss"])
    rl1 = torch.sum(torch.abs(state.Y))
    cns = torch.linalg.vector_norm(state.X + state.Y - params["S"])
    return (rnn + params["lmbda"] * rl1, rnn, rl1, cns)


def _yinit(cfg, params):
    return torch.zeros_like(params["S"])


_STATS = ("ObjFun", "NrmNuc", "NrmL1", "Cnstr")

_RPCA = ADMMProblem(setup=_setup, xstep=_xstep, ystep=_ystep, obfn=_obfn,
                    cnst_b=_cnst_b, cnst_c=_cnst_c, yinit=_yinit,
                    uinit=_yinit, stat_names=_STATS)


class RobustPCA(ADMMModel):
    r"""Robust PCA: a low-rank plus sparse decomposition of ``S``.
    ``solve`` returns ``(X, Y)``, low-rank and sparse, as the reference
    (``sporco/admm/rpca.py:160``).

    With ``svd_rank=r`` the x-step's SVD is randomized, of rank
    ``r + 10``; its Gaussian sketch is ``params["sketch"]``, drawn once
    from a ``torch.Generator`` seeded 0 on the model's device, or
    ``sketch`` when given (an array of shape ``(n, r + 10)``
    for ``S`` of shape ``(m, n)``; the JAX package's is
    ``jax.random.normal(PRNGKey(0), (n, r + 10))``).  ``device=None``
    means the CUDA device and raises without one.
    """

    STAT_NAMES = _STATS

    REF_OPT_EXTRA = {"fEvalX": refopts.IGNORE, "gEvalY": refopts.IGNORE}

    @staticmethod
    def options(**kw):
        """Defaults as the reference (``sporco/admm/rpca.py:44-50``):
        RelaxParam 1.8, AutoRho on with Period 1 and AutoScaling."""
        ar = kw.pop("auto_rho", AutoRhoOpts(enabled=True, period=1,
                                            auto_scaling=True,
                                            scaling=1000.0,
                                            rsdl_ratio=1.2,
                                            rsdl_target=1.0))
        base = dict(relax_param=1.8, auto_rho=ar)
        base.update(kw)
        return ADMMOpts(**base)

    def __init__(self, S, lmbda=None, opt=None, dtype=torch.float32,
                 Y0=None, U0=None, svd_rank=None, svd_iters=2, sketch=None,
                 device=None):
        super().__init__()
        self.device = resolve_device(device)
        if opt is None:
            opt = self.options()
        dtype = sf.torch_dtype(dtype)
        S = user_tensor(S, dtype, self.device)
        if lmbda is None:
            lmbda = float(S.shape[0]) ** -0.5
        self.lmbda = lmbda
        self.cfg = RPCAConfig(svd_rank=svd_rank, svd_iters=svd_iters)
        self.opts = opt.replace(dtype=dtype)
        self.params = {"S": S, "lmbda": scalar_type(dtype)(lmbda)}
        if svd_rank is not None:
            rdt = sf.real_dtype(dtype)
            if sketch is None:
                sketch = sp.nuclear_sketch(S.shape, svd_rank, dtype=rdt,
                                           device=self.device)
            self.params["sketch"] = user_tensor(sketch, rdt, self.device)
        self.problem = _RPCA
        rho0 = opt.rho if opt.rho is not None else 2.0 * lmbda + 0.1
        rho_xi = (opt.auto_rho.rsdl_target
                  if opt.auto_rho.rsdl_target is not None else 1.0)

        def warm(A):
            return None if A is None else user_tensor(A, dtype, self.device)
        self.state = init_state(self.problem, self.cfg, self.params,
                                self.opts, rho0, rho_xi, Y0=warm(Y0),
                                U0=warm(U0))
        self._init_done()

    def solve(self):
        super().solve()
        return self.state.X, self.state.Y

    def getmin(self):
        return self.state.X
