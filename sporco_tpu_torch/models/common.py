"""Shared machinery for model classes (counterpart of
``sporco_tpu.models.common``): a thin stateful shell holding
``(cfg, params, opts, state)`` around a functional solver core, for ADMM
and for PGM models."""

import math

import numpy as np
import torch

from sporco_tpu_torch import refopts
from sporco_tpu_torch.solvers import admm as _admm
from sporco_tpu_torch.solvers import pgm as _pgm
from sporco_tpu_torch.utils.timer import Timer

__all__ = ["ADMMModel", "PGMModel", "default_rho_xi"]


def _state_dict(state):
    """A solver state as numpy arrays (the layout of the JAX package's
    ``state_dict()``)."""
    out = {}
    for k, v in state._asdict().items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu().numpy()
        elif k == "extra":
            out[k] = v
        else:
            out[k] = np.array(v, copy=True)
    return out


class _Model:
    """The stateful shell shared by the ADMM and PGM model bases.
    Subclasses set ``cfg``, ``params``, ``opts``, ``state`` and
    ``device`` in ``__init__`` and implement :meth:`_solve_state`.
    Constructors accept a reference-style option dict as ``opt`` (see
    :mod:`sporco_tpu_torch.refopts`)."""

    STAT_NAMES = ()

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        refopts.wrap_init(cls)

    def __init__(self):
        self.timer = Timer(["init", "solve"])
        self.timer.start("init")
        self.k_start = 0

    def _init_done(self):
        self.timer.stop("init")

    def _solve_state(self):
        raise NotImplementedError

    def solve(self):
        """Run (or resume) the solve; returns the minimiser in the
        reference's output layout.  Re-entrant: the state carries the
        iteration counter."""
        self.k_start = int(self.state.k)
        self.timer.start("solve")
        self.state = self._solve_state()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timer.stop("solve")
        return self.getmin()

    @property
    def itstat(self):
        return self.getitstat()

    def state_dict(self):
        """Snapshot of the solver state as numpy arrays (the layout of
        the JAX package's ``state_dict()``)."""
        return _state_dict(self.state)

    def load_state(self, d):
        """Restore a snapshot written by :meth:`state_dict`."""
        self.load_state_dict_numpy(d)

    def _tensor(self, a, dtype=torch.float32):
        """A numpy array as a new tensor of ``dtype`` on the model's
        device."""
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)


class PGMModel(_Model):
    """Base for PGM-driven model classes (counterpart of the JAX
    package's ``PGMModel``)."""

    REF_OPT_EXTRA = refopts.PGM_BASE

    def getmin(self):
        return self.state.X

    def getitstat(self):
        """Per-iteration statistics of the most recent ``solve`` call."""
        return _pgm.pgm_iterstats(self.STAT_NAMES, self.state,
                                  self.k_start)

    def load_state_dict_numpy(self, d):
        """Load a PGM state given as numpy arrays: the port's own
        :meth:`state_dict`, or the JAX package's ``state_dict()`` after
        ``numpy.asarray`` of each entry.  Every array becomes a buffer of
        its own (the fused FISTA loop updates its packed copies in
        place)."""
        def s32(name):
            return np.float32(d[name])

        def arr(name):
            return self._tensor(d[name], self.opts.dtype)
        self.state = _pgm.PGMState(
            X=arr("X"), Y=arr("Y"), Xprv=arr("Xprv"), Gprv=arr("Gprv"),
            Zrb=arr("Zrb"), t=s32("t"), Tk=s32("Tk"),
            L=s32("L"), k=np.int32(d["k"]), rsdl=s32("rsdl"),
            objprv=s32("objprv"),
            stats=np.array(d["stats"], np.float32, copy=True))


class ADMMModel(_Model):
    """Base for ADMM-driven model classes.  Subclasses also set
    ``problem`` (an :class:`~sporco_tpu_torch.solvers.admm.ADMMProblem`),
    which the generic solve runs."""

    REF_OPT_EXTRA = refopts.ADMM_BASE

    def _solve_state(self):
        return _admm.admm_solve(self.problem, self.cfg, self.params,
                                self.opts, self.state)

    def getmin(self):
        return self.state.Y

    def getitstat(self):
        """Per-iteration statistics of the most recent ``solve`` call."""
        return _admm.iterstats(_admm.stat_names(self.STAT_NAMES),
                               self.state, self.k_start)

    def load_state_dict_numpy(self, d):
        """Load a solver state given as numpy arrays: the port's own
        :meth:`state_dict`, or the JAX package's ``state_dict()`` after
        ``numpy.asarray`` of each entry, from the fused or the generic
        path.  X, Y and U are in the internal ``(K, Cx, M, N0, N1)``
        layout in both packages and take the problem's dtype; the
        scalars take its scalar type."""
        ft = _admm.scalar_type(self.opts.dtype)
        dt = self.opts.dtype
        self.state = _admm.ADMMState(
            X=self._tensor(d["X"], dt), Y=self._tensor(d["Y"], dt),
            U=self._tensor(d["U"], dt),
            rho=ft(d["rho"]), rho_xi=ft(d["rho_xi"]), k=np.int32(d["k"]),
            r=ft(d["r"]), s=ft(d["s"]), epri=ft(d["epri"]),
            edua=ft(d["edua"]),
            stats=np.array(d["stats"], np.float32, copy=True),
            extra=d.get("extra", ()))


def default_rho_xi(lmbda):
    """Default AutoRho residual-ratio target xi as a function of lambda
    (Sec. VI.C of wohlberg-2015-adaptive; ``sporco/admm/bpdn.py:424``)."""
    if lmbda is None or lmbda == 0.0:
        return 1.0
    return float(1.0 + 18.3 ** (math.log10(float(lmbda)) + 1.0))
