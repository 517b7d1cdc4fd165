"""Plug-and-Play priors: ``PPP`` (ADMM), ``PPPConsensus`` (multi-agent
consensus equilibrium by weighted ADMM consensus) and ``PPPPGM`` (PGM),
with ``host_prior`` (counterpart of ``sporco_tpu.models.ppp``,
``sporco/admm/ppp.py:120,258`` and ``sporco/pgm/ppp.py:124``).

The caller gives the data fidelity and the prior ("denoiser") as
callables on tensors, which run on the solve's device inside the host
loop of the generic drivers; a denoiser written for numpy arrays is
wrapped by :func:`host_prior`.  Transforms that the callables make
through :mod:`sporco_tpu_torch.ops.fft` run ``rfft2_planar``/
``irfft2_planar`` on the card where that module dispatches them.
"""

import math
from dataclasses import dataclass
from typing import Callable, Sequence

import numpy as np
import torch

from sporco_tpu_torch._device import resolve_device
from sporco_tpu_torch.models.common import ADMMModel, PGMModel, warm_start
from sporco_tpu_torch.ops import fft as sf
from sporco_tpu_torch.solvers import pgm as _pgm
from sporco_tpu_torch.solvers.admm import (ADMMOpts, ADMMProblem,
                                           AutoRhoOpts, init_state,
                                           tree_norm)
from sporco_tpu_torch.solvers.pgm import PGMOpts, PGMProblem, pgm_init_state

__all__ = ["PPP", "PPPConsensus", "PPPPGM", "host_prior"]


def host_prior(fn):
    """Wrap a denoiser on numpy arrays, ``fn(x: np.ndarray) ->
    np.ndarray`` of the same shape, as a prior on tensors: the wrapped
    function copies its tensor to the host, which waits for the device
    (a synchronisation of the stream), calls ``fn`` and copies the result
    back to the tensor's device and dtype.  That round trip is the point:
    it plugs any host code into a solve on the card.  Further arguments
    (the penalty ``rho`` or step ``L``) are not passed on."""
    def wrapped(x, *a):
        return _host_call(fn, x)
    wrapped.on_host = True
    return wrapped


def _host_call(fn, x):
    """``fn`` of ``x`` through the host: the round trip of
    :func:`host_prior`."""
    out = np.asarray(fn(x.detach().cpu().numpy()))
    return torch.as_tensor(out).to(device=x.device, dtype=x.dtype)


def _route(*fns):
    """The solve loop's route for a problem made of the callables
    ``fns``: eager where one is a :func:`host_prior` (its round trip
    cannot be captured in a CUDA graph), else the graph."""
    return "eager" if any(getattr(f, "on_host", False) for f in fns) \
        else "graph"


@dataclass(frozen=True)
class _PPPConfig:
    pass


def _admm_options(kw):
    ar = kw.pop("auto_rho", AutoRhoOpts(enabled=False))
    base = dict(relax_param=1.0, auto_rho=ar, rho=1.0)
    base.update(kw)
    return ADMMOpts(**base)


class PPP(ADMMModel):
    r"""Plug-and-Play ADMM (``sporco/admm/ppp.py:120``): the x-step is
    ``proxf(Y - U, rho)``, the y-step the prior ``proxg(X + U, rho)``.
    ``xshape`` is the solution's shape, ``f(x)`` the data fidelity
    (a 0-d tensor, NaN if there is none).  ``device=None`` means the CUDA
    device and raises without one, ``device="cpu"`` runs on the CPU.
    Defaults as the reference: rho 1, RelaxParam 1, AutoRho off."""

    STAT_NAMES = ("FVal",)

    @staticmethod
    def options(**kw):
        return _admm_options(kw)

    def __init__(self, xshape, f, proxf, proxg, opt=None,
                 dtype=torch.float32, Y0=None, U0=None, device=None):
        super().__init__()
        self.device = dev = resolve_device(device)
        if opt is None:
            opt = self.options()
        dtype = sf.torch_dtype(dtype)
        self.cfg = _PPPConfig()
        self.opts = opt.replace(dtype=dtype)
        self.params = {"x0": torch.zeros(tuple(xshape), dtype=dtype,
                                         device=dev)}

        def _setup(cfg, params):
            return {}

        def _xstep(cfg, aux, params, state):
            return proxf(state.Y - state.U, state.rho), None

        def _ystep(cfg, aux, params, state, AXU):
            return proxg(AXU, state.rho)

        def _obfn(cfg, aux, params, state, xaux):
            return (f(state.X),)

        def _yinit(cfg, params):
            return torch.zeros_like(params["x0"])

        self.problem = ADMMProblem(
            setup=_setup, xstep=_xstep, ystep=_ystep, obfn=_obfn,
            yinit=_yinit, uinit=_yinit, stat_names=self.STAT_NAMES,
            route=_route(f, proxf, proxg))
        rho0 = opt.rho if opt.rho is not None else 1.0
        self.state = init_state(self.problem, self.cfg, self.params,
                                self.opts, rho0, 1.0,
                                Y0=warm_start(Y0, dtype, dev),
                                U0=warm_start(U0, dtype, dev))
        self._init_done()

    def getmin(self):
        return self.state.X


class PPPConsensus(ADMMModel):
    r"""Multi-agent consensus equilibrium by weighted ADMM consensus
    (buzzard-2018-plug; ``sporco/admm/ppp.py:156-318``): each agent's
    proximal operator ``proxfi[i](x, rho)`` acts on its own block (the
    blocks stacked on a new leading axis); the y-step is the weighted
    block mean (weights ``mu``, equal by default) followed by ``proxg``
    (none by default).  Defaults as the reference: rho 1, RelaxParam 1,
    AutoRho off."""

    STAT_NAMES = ()

    @staticmethod
    def options(**kw):
        return _admm_options(kw)

    def __init__(self, xshape, proxfi: Sequence[Callable], proxg=None,
                 mu=None, opt=None, dtype=torch.float32, Y0=None, U0=None,
                 device=None):
        super().__init__()
        self.device = dev = resolve_device(device)
        if opt is None:
            opt = self.options()
        dtype = sf.torch_dtype(dtype)
        xshape = tuple(xshape)
        Nb = len(proxfi)
        if mu is None:
            mu = np.ones((Nb,))
        mu = np.asarray(mu) / np.sum(mu)
        self.cfg = _PPPConfig()
        self.opts = opt.replace(dtype=dtype)
        self.params = {"mu": torch.as_tensor(mu.astype(sf.numpy_dtype(
            dtype))).reshape((Nb,) + (1,) * len(xshape)).to(dev)}
        sqnb = math.sqrt(float(Nb))

        def _setup(cfg, params):
            return {}

        def _xstep(cfg, aux, params, state):
            return torch.stack([proxfi[i](state.Y[0] - state.U[i],
                                          state.rho)
                                for i in range(Nb)], dim=0), None

        def _ystep(cfg, aux, params, state, AXU):
            m = torch.sum(params["mu"] * AXU, dim=0, keepdim=True)
            if proxg is not None:
                m = proxg(m[0], state.rho)[None]
            return m

        def _rsdl_s(cfg, aux, params, state, Yprev):
            return state.rho * sqnb * (Yprev - state.Y)

        def _rsdl_sn(cfg, aux, params, state):
            return state.rho * tree_norm(state.U)

        def _rsdl_rn(cfg, aux, params, state, AXnr):
            return torch.maximum(tree_norm(AXnr), sqnb * tree_norm(state.Y))

        def _zeros(n):
            return torch.zeros((n,) + xshape, dtype=dtype, device=dev)

        self.problem = ADMMProblem(
            setup=_setup, xstep=_xstep, ystep=_ystep, obfn=None,
            rsdl_s=_rsdl_s, rsdl_sn=_rsdl_sn, rsdl_rn=_rsdl_rn,
            yinit=lambda cfg, params: _zeros(1),
            uinit=lambda cfg, params: _zeros(Nb),
            xinit=lambda cfg, params: _zeros(Nb), stat_names=(),
            route=_route(proxg, *proxfi))
        rho0 = opt.rho if opt.rho is not None else 1.0
        self.state = init_state(self.problem, self.cfg, self.params,
                                self.opts, rho0, 1.0,
                                Y0=warm_start(Y0, dtype, dev),
                                U0=warm_start(U0, dtype, dev))
        self._init_done()

    def getmin(self):
        return self.state.Y[0]


class PPPPGM(PGMModel):
    r"""Plug-and-Play PGM (``sporco/pgm/ppp.py:124``): a gradient step on
    the data fidelity ``f`` (gradient ``gradf``), then the prior
    ``proxg(v, L)`` as the proximal step, on the port's PGM loop.  The
    stats rows' ``G`` is 0."""

    STAT_NAMES = ("ObjFun", "F", "G")

    @staticmethod
    def options(**kw):
        return PGMOpts(**kw)

    def __init__(self, xshape, f, gradf, proxg, opt=None,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.device = dev = resolve_device(device)
        if opt is None:
            opt = self.options()
        dtype = sf.torch_dtype(dtype)
        self.cfg = _PPPConfig()
        self.opts = opt.replace(dtype=dtype)
        self.params = {"x0": torch.zeros(tuple(xshape), dtype=dtype,
                                         device=dev)}
        self.problem = PGMProblem(
            setup=lambda cfg, params: {},
            grad_f=lambda cfg, aux, params, Y: gradf(Y),
            prox_g=lambda cfg, aux, params, V, L: proxg(V, L),
            obfn_f=lambda cfg, aux, params, X: f(X),
            obfn_g=lambda cfg, aux, params, X: X.new_zeros(()),
            xinit=lambda cfg, params: params["x0"],
            stat_names=self.STAT_NAMES, route=_route(f, gradf, proxg))
        L0 = opt.L if opt.L is not None else 1.0
        self.state = pgm_init_state(self.params["x0"].clone(), self.opts, L0,
                                    len(self.STAT_NAMES))
        self._init_done()

    def _solve_state(self):
        return _pgm.pgm_solve(self.problem, self.cfg, self.params,
                              self.opts, self.state)
