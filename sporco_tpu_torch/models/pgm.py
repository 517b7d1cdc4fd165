"""Convolutional sparse coding via PGM (FISTA): ``ConvBPDN`` and
``ConvBPDNMask`` (counterpart of ``sporco_tpu.models.pgm``).

This slice ports the fused packed-layout problem
(:mod:`sporco_tpu_torch.ops.fused_csc`): real single-channel 2-D
float32 problems, masked or not.  The plain FISTA configuration runs
the hand-written ``pgm_iter`` kernel once per iteration; backtracking,
the step-size policies, the monotone variant and a spatially varying
``L1Weight`` run the generic PGM loop on the packed problem.  Every
other configuration raises :class:`NotImplementedError` naming the
ROADMAP item that will port it; there is no silent generic path.
"""

from dataclasses import dataclass

import numpy as np
import torch

from sporco_tpu_torch import cnvrep as cr
from sporco_tpu_torch._device import resolve_device
from sporco_tpu_torch.models import cbpdn as _cbpdn
from sporco_tpu_torch.models.common import PGMModel
from sporco_tpu_torch.ops import fused_csc
from sporco_tpu_torch.solvers.pgm import PGMOpts, pgm_init_state

__all__ = ["ConvBPDN", "ConvBPDNMask", "PGMCSCConfig", "params_from_numpy",
           "DEFAULT_L"]

DEFAULT_L = 500.0     # sporco/pgm/cbpdn.py:98


@dataclass(frozen=True)
class PGMCSCConfig:
    cri: cr.CSCIndex
    non_neg: bool = False
    no_bndry: bool = False
    masked: bool = False


def params_from_numpy(D, S, lmbda=None, wl1=1.0, W=None, dimK=None, dimN=2,
                      device="cpu", dtype=torch.float32):
    """The port's PGM problem from the same user-shaped arrays the JAX
    constructor takes.  Returns ``(cri, params, real)``: ``params`` holds
    the internal-layout ``D``, ``S``, ``wl1`` and the fidelity mask ``W``
    as float32 tensors on ``device``, and ``lmbda`` as a number
    (defaulting to ``0.1 max|D^H S|``)."""
    cri, params, real = _cbpdn.params_from_numpy(D, S, lmbda, wl1, dimK,
                                                 dimN, device, dtype)
    if not real:
        return cri, None, False
    Wm = torch.ones((1,) * (3 + cri.dimN), dtype=dtype) if W is None \
        else cr.fidelity_mask(torch.as_tensor(np.asarray(W, np.float32)),
                              cri)
    params["W"] = Wm.to(torch.device(device), dtype)
    return cri, params, True


class ConvBPDN(PGMModel):
    r"""CSC via PGM/FISTA: ``argmin_x (1/2)||sum_m d_m * x_m - s||_2^2
    + lmbda sum_m ||x_m||_1`` (``sporco/pgm/cbpdn.py:29``).

    ``D`` has user shape ``dsz + (M,)``, ``S`` has ``Nv + [K]``; the
    returned coefficient array has the reference's layout
    ``Nv + (1, K, M)``.  Arguments are numpy arrays (or anything
    ``numpy.asarray`` takes).  ``device=None`` means the CUDA device and
    raises if there is none; pass ``device="cpu"`` for the CPU, where the
    kernel runs as its plain PyTorch version.  Defaults: ``L = 500``,
    ``lmbda = 0.1 max|D^H S|``.
    """

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
        if fused is False:
            raise NotImplementedError(
                "fused=False selects the generic FFT PGM problem, which "
                "is not ported yet (ROADMAP queue 1, item 10)")
        if not isinstance(dtype, torch.dtype):
            dtype = getattr(torch, np.dtype(dtype).name)
        self.opts = opt.replace(dtype=dtype)
        cri, params, real = params_from_numpy(D, S, lmbda, wl1, W, dimK,
                                              dimN, self.device)
        if not real:
            raise NotImplementedError(
                "complex problems need the generic FFT PGM problem, which "
                "is not ported yet (ROADMAP queue 1, item 10)")
        self.cri = cri
        self.cfg = PGMCSCConfig(cri=cri, non_neg=non_neg,
                                no_bndry=no_bndry, masked=self.MASKED)
        reason = fused_csc.pgm_unsupported_reason(self.cfg, self.opts)
        if reason is not None:
            raise NotImplementedError(reason)
        self.params = params
        self.lmbda = params["lmbda"]
        L0 = opt.L if opt.L is not None else DEFAULT_L
        X0 = torch.zeros(cri.shpX, dtype=dtype, device=self.device)
        self.state = pgm_init_state(X0, self.opts, L0,
                                    len(self.STAT_NAMES))
        self._init_done()

    def _solve_state(self):
        return fused_csc.pgm_cbpdn_solve(self.cfg, self.params, self.opts,
                                         self.state)

    def getmin(self):
        return cr.from_internal_X(self.state.X, self.cri)

    def getcoef(self):
        return self.getmin()

    def getcoef_internal(self):
        return self.state.X

    def setdict(self, D=None, internal=None):
        """Replace the dictionary: user-shaped ``D``, or ``internal`` in
        the internal layout ``(1, Cd, M, dsz...)``."""
        if internal is None:
            internal = cr.to_internal_D(
                torch.as_tensor(np.asarray(D, np.float32)), self.cri)
        self.params = {**self.params,
                       "D": internal.contiguous().to(self.device,
                                                     self.opts.dtype)}

    def reconstruct(self, X=None):
        """Reconstruct ``sum_m d_m * x_m`` in the user S layout
        ``Nv + [K]``."""
        return _cbpdn.reconstruct(self.params["D"], self.state.X, self.cri,
                                  X)


class ConvBPDNMask(ConvBPDN):
    r"""CSC with a masked data fidelity term via PGM
    (``sporco/pgm/cbpdn.py:387``)."""
    MASKED = True

    def __init__(self, D, S, lmbda=None, W=None, opt=None, **kw):
        super().__init__(D, S, lmbda=lmbda, W=W, opt=opt, **kw)
