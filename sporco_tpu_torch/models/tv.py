"""Total variation denoising and deconvolution via ADMM (counterpart of
``sporco_tpu.models.tv``): ``TVL2Denoise``, ``TVL1Denoise``,
``TVL2Deconv`` and ``TVL1Deconv`` (``sporco/admm/tvl2.py:27,377``,
``sporco/admm/tvl1.py:27,403``), over any set of TV ``axes``, scalar or
vector TV (``caxis``), with data-fidelity and TV weights, for real and
complex S.

The denoisers' x-step is the reference's "Gauss-Seidel" step, which is a
Jacobi sweep (every neighbour read from the previous iterate,
``sporco/admm/tvl2.py:245-262,362``).  The JAX package runs it as an
inner while loop on ``r > gs_tol and k < gs_max_iter``; here every one
of the ``gs_max_iter`` sweeps runs, and a sweep after the test fails
leaves X, the residual and the count as they were (``torch.where``), so
the ``GSIter``/``GSRelRes`` rows are the JAX package's with no host
read.  The deconvolvers' x-step is a per-bin DFT-domain solve
(``sporco/admm/tvl2.py:594-610``, ``sporco/admm/tvl1.py:629-641``): on
the card the 2-D transforms of X (TV axes the trailing two, float32)
run the kernels ``rfft2_planar``/``irfft2_planar`` through
:mod:`sporco_tpu_torch.ops.fft`, the transforms of the gradient stacks
(a trailing block axis) ``torch.fft``.
"""

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from sporco_tpu_torch import refopts
from sporco_tpu_torch._device import resolve_device
from sporco_tpu_torch.models.common import ADMMModel, user_tensor
from sporco_tpu_torch.ops import fft as sf
from sporco_tpu_torch.ops import linalg as sl
from sporco_tpu_torch.ops import prox as sp
from sporco_tpu_torch.solvers.admm import (ADMMOpts, ADMMProblem,
                                           AutoRhoOpts, const_div,
                                           init_state, scalar_type,
                                           tree_norm)
from sporco_tpu_torch.utils.array import zpad
from sporco_tpu_torch.utils.signal import grad, gradT

__all__ = ["TVL2Denoise", "TVL2Deconv", "TVL1Denoise", "TVL1Deconv"]


@dataclass(frozen=True)
class TVConfig:
    axes: Tuple[int, ...]
    saxes: Tuple[int, ...]        # prox_l2 groups: (-1,) or (caxis, -1)
    sndim: int
    l1_fidelity: bool = False     # the TVL1 models
    deconv: bool = False
    gs_max_iter: int = 2
    gs_tol: float = 0.0
    real: bool = True
    g_eval_y: bool = True         # gEvalY: the TV term at Y, else at A(X)


def _sq(v):
    """``|v|^2``, complex-aware."""
    return v.abs() ** 2 if v.is_complex() else v ** 2


def _ft(params):
    return scalar_type(params["S"].dtype)


def _tv_cnst_a_grad(cfg, X):
    """The non-circular forward differences along the TV axes, stacked
    on a new trailing axis (``sporco/admm/tvl2.py:316``)."""
    return torch.stack([grad(X, ax) for ax in cfg.axes], dim=-1)


def _tv_cnst_at_grad(cfg, V):
    return sum(gradT(V[..., j], ax) for j, ax in enumerate(cfg.axes))


def _lcw(cfg, S):
    """Laplacian centre weights (``sporco/admm/tvl2.py:350``): 2 J in the
    interior, one less at each boundary face."""
    sz = [1] * cfg.sndim
    for ax in cfg.axes:
        sz[ax] = S.shape[ax]
    lcw = 2.0 * len(cfg.axes) * np.ones(sz, dtype=np.float64)
    for ax in cfg.axes:
        lcw[(slice(None),) * ax + ([0, -1],)] -= 1.0
    return torch.tensor(lcw, dtype=S.dtype, device=S.device)


def _jacobi_sweeps(cfg, S_eff, X0, ATYU, rho_eff, lcw, W2):
    """``gs_max_iter`` Jacobi sweeps; a sweep counts, and takes effect,
    only while the relative residual of the previous one exceeds
    ``gs_tol``, as in the JAX package's inner while loop
    (``sporco_tpu/models/tv.py:83-116``).  Returns X, the last relative
    residual and the number of sweeps that took effect, on the device."""
    def sweep(X):
        Xss = torch.zeros_like(S_eff)
        for ax in cfg.axes:
            n = X.shape[ax]
            Xss = Xss + zpad(X.narrow(ax, 0, n - 1), (1, 0), ax)
            Xss = Xss + zpad(X.narrow(ax, 1, n - 1), (0, 1), ax)
        return (rho_eff * (Xss + ATYU) + W2 * S_eff) / \
            (W2 + rho_eff * lcw)

    def resid(X):
        ax_ = rho_eff * _tv_cnst_at_grad(cfg, _tv_cnst_a_grad(cfg, X)) \
            + W2 * X
        return sl.rrs(ax_, W2 * S_eff + rho_eff * ATYU)

    X = X0
    rdt = X0.real.dtype if X0.is_complex() else X0.dtype
    r = torch.full((), float("inf"), dtype=rdt, device=X0.device)
    k = torch.zeros((), dtype=torch.int32, device=X0.device)
    for _ in range(cfg.gs_max_iter):
        active = r > cfg.gs_tol
        Xn = sweep(X)
        X = torch.where(active, Xn, X)
        r = torch.where(active, resid(Xn), r)
        k = k + active.to(torch.int32)
    return X, r, k


# --- TVL2 denoising --------------------------------------------------------

def _den_setup(cfg, params):
    return {"lcw": _lcw(cfg, params["S"])}


def _tvl2den_xstep(cfg, aux, params, state):
    ATYU = _tv_cnst_at_grad(cfg, state.Y - state.U)
    X, r, k = _jacobi_sweeps(cfg, params["S"], state.X, ATYU, state.rho,
                             aux["lcw"], params["Wdf"] ** 2)
    return X, {"gsit": k, "gsrrs": r}


def _tvl2den_ystep(cfg, aux, params, state, AXU):
    return sp.prox_l2(AXU, const_div(_ft(params)(params["lmbda"]),
                                     state.rho)
                      * params["Wtvna"], axis=cfg.saxes)


def _tv_cnst_a(cfg, aux, params, X):
    return _tv_cnst_a_grad(cfg, X)


def _tv_cnst_at(cfg, aux, params, V):
    return _tv_cnst_at_grad(cfg, V)


def _reg(cfg, params, gv):
    """The TV term ``sum W_tv sqrt(sum_saxes |gv|^2)``."""
    return torch.sum(params["Wtv"]
                     * torch.sqrt(torch.sum(_sq(gv), dim=cfg.saxes)))


def _tvl2den_obfn(cfg, aux, params, state, xaux):
    dfd = 0.5 * torch.sum(_sq(params["Wdf"] * (state.X - params["S"])))
    gv = state.Y if cfg.g_eval_y else _tv_cnst_a_grad(cfg, state.X)
    reg = _reg(cfg, params, gv)
    return (dfd + params["lmbda"] * reg, dfd, reg, xaux["gsit"],
            xaux["gsrrs"])


def _tvl2_yinit(cfg, params):
    S = params["S"]
    return torch.zeros(tuple(S.shape) + (len(cfg.axes),), dtype=S.dtype,
                       device=S.device)


def _xinit(cfg, params):
    return params["S"]


_DEN_STATS = ("ObjFun", "DFid", "RegTV", "GSIter", "GSRelRes")
_DCN_STATS = ("ObjFun", "DFid", "RegTV", "XSlvRelRes")

_TVL2DEN = ADMMProblem(
    setup=_den_setup, xstep=_tvl2den_xstep, ystep=_tvl2den_ystep,
    obfn=_tvl2den_obfn, cnst_a=_tv_cnst_a, cnst_at=_tv_cnst_at,
    yinit=_tvl2_yinit, uinit=_tvl2_yinit, xinit=_xinit,
    stat_names=_DEN_STATS)


# --- TVL1 denoising --------------------------------------------------------

def _tvl1_cnst_a(cfg, aux, params, X):
    """``(G_0; ...; G_{J-1}; I) x``, the blocks on the trailing axis
    (``sporco/admm/tvl1.py:316``)."""
    return torch.cat([_tv_cnst_a_grad(cfg, X), X[..., None]], dim=-1)


def _tvl1_cnst_at(cfg, aux, params, V):
    return _tv_cnst_at_grad(cfg, V[..., :-1]) + V[..., -1]


def _tvl1_cnst_c(cfg, aux, params):
    S = params["S"]
    c = torch.zeros(tuple(S.shape) + (len(cfg.axes) + 1,), dtype=S.dtype,
                    device=S.device)
    c[..., -1] = S
    return c


def _tvl1den_xstep(cfg, aux, params, state):
    YU = state.Y - state.U
    SYU = params["S"] + YU[..., -1]
    ATYU = _tv_cnst_at_grad(cfg, YU[..., :-1])
    X, r, k = _jacobi_sweeps(cfg, SYU, state.X, ATYU, 1.0, aux["lcw"], 1.0)
    return X, {"gsit": k, "gsrrs": r}


def _tvl1_ystep(cfg, aux, params, state, AXU):
    ft = _ft(params)
    rho = state.rho
    Yg = sp.prox_l2(AXU[..., :-1], const_div(ft(params["lmbda"]), rho)
                    * params["Wtvna"], axis=cfg.saxes)
    Yd = sp.prox_l1(AXU[..., -1] - params["S"], const_div(ft(1.0), rho)
                    * params["Wdf"])
    return torch.cat([Yg, Yd[..., None]], dim=-1)


def _tvl1_terms(cfg, params, gv):
    dfd = torch.sum(torch.abs(params["Wdf"] * gv[..., -1]))
    reg = _reg(cfg, params, gv[..., :-1])
    return dfd + params["lmbda"] * reg, dfd, reg


def _tvl1den_obfn(cfg, aux, params, state, xaux):
    gv = state.Y if cfg.g_eval_y else (
        _tvl1_cnst_a(cfg, aux, params, state.X)
        - _tvl1_cnst_c(cfg, aux, params))
    return _tvl1_terms(cfg, params, gv) + (xaux["gsit"], xaux["gsrrs"])


def _tvl1_rsdl_s(cfg, aux, params, state, Yprev):
    """Dual residual ``rho A^T U`` (``sporco/admm/tvl1.py:362``)."""
    return state.rho * _tvl1_cnst_at(cfg, aux, params, state.U)


def _tvl1_rsdl_sn(cfg, aux, params, state):
    return state.rho * tree_norm(state.U)


def _tvl1_yinit(cfg, params):
    S = params["S"]
    return torch.zeros(tuple(S.shape) + (len(cfg.axes) + 1,),
                       dtype=S.dtype, device=S.device)


_TVL1DEN = ADMMProblem(
    setup=_den_setup, xstep=_tvl1den_xstep, ystep=_tvl1_ystep,
    obfn=_tvl1den_obfn, cnst_a=_tvl1_cnst_a, cnst_at=_tvl1_cnst_at,
    cnst_c=_tvl1_cnst_c, rsdl_s=_tvl1_rsdl_s, rsdl_sn=_tvl1_rsdl_sn,
    yinit=_tvl1_yinit, uinit=_tvl1_yinit, xinit=_xinit,
    stat_names=_DEN_STATS)


# --- deconvolution: DFT-domain x-steps -------------------------------------

def _axshp(cfg, params):
    return tuple(params["S"].shape[ax] for ax in cfg.axes)


def _fwd(cfg, x, s=None):
    if cfg.real:
        return sf.rfftn(x, s=s, axes=cfg.axes)
    return sf.fftn(x, s=s, axes=cfg.axes)


def _inv(cfg, params, xf):
    if cfg.real:
        return sf.irfftn(xf, s=_axshp(cfg, params), axes=cfg.axes)
    return sf.ifftn(xf, s=_axshp(cfg, params), axes=cfg.axes)


def _dcn_setup(cfg, params):
    """The DFT-domain kernel, signal and gradient filters (trailing
    filter index) over the TV axes; ``GAf`` appends the kernel to the
    gradient filters (the TVL1 constraint's blocks)."""
    S, A = params["S"], params["A"]
    axshp = _axshp(cfg, params)
    Af = _fwd(cfg, A, axshp)
    Sf = _fwd(cfg, S, axshp)
    rdt = sf.real_dtype(S.dtype)
    Gfs = []
    for ax in cfg.axes:
        g = np.zeros([2 if a == ax else 1 for a in range(cfg.sndim)])
        g[tuple(slice(None) if a == ax else 0
                for a in range(cfg.sndim))] = [1.0, -1.0]
        Gfs.append(_fwd(cfg, torch.tensor(g, dtype=rdt, device=S.device),
                        axshp))
    Gf = torch.stack(Gfs, dim=-1)
    return {"Af": Af, "Sf": Sf, "AHAf": (Af.conj() * Af).real,
            "AHSf": Af.conj() * Sf, "Gf": Gf,
            "GHGf": torch.sum((Gf.conj() * Gf).real, dim=-1),
            "GAf": torch.cat([Gf, Af[..., None]], dim=-1)}


def _dcn_solve(cfg, aux, params, state, F, rho):
    """``Xf = b / (AHAf + rho GHGf)`` with ``b = AHSf + rho sum F^H
    (Y - U)_f`` for the filter stack F; X and the solve's relative
    residual."""
    YUf = _fwd(cfg, state.Y - state.U)
    b = aux["AHSf"] + rho * torch.sum(F.conj() * YUf, dim=-1)
    lhs = aux["AHAf"] + rho * aux["GHGf"]
    Xf = b / lhs
    return _inv(cfg, params, Xf), {"Xf": Xf, "xrrs": sl.rrs(lhs * Xf, b)}


def _tvl2dcn_xstep(cfg, aux, params, state):
    return _dcn_solve(cfg, aux, params, state, aux["Gf"], state.rho)


def _tvdcn_cnst_a(cfg, aux, params, X):
    """Circular gradients through the DFT filters."""
    return _inv(cfg, params, aux["Gf"] * _fwd(cfg, X)[..., None])


def _tvdcn_cnst_at(cfg, aux, params, V):
    return _inv(cfg, params,
                torch.sum(aux["Gf"].conj() * _fwd(cfg, V), dim=-1))


def _tvl2dcn_obfn(cfg, aux, params, state, xaux):
    rf = aux["Af"] * xaux["Xf"] - aux["Sf"]
    if cfg.real:
        dfd = 0.5 * sf.rfl2norm2(rf, _axshp(cfg, params), axis=cfg.axes)
    else:
        dfd = 0.5 * sf.fl2norm2(rf, axis=cfg.axes)
    gv = state.Y if cfg.g_eval_y else \
        _tvdcn_cnst_a(cfg, aux, params, state.X)
    reg = _reg(cfg, params, gv)
    return (dfd + params["lmbda"] * reg, dfd, reg, xaux["xrrs"])


_TVL2DCN = ADMMProblem(
    setup=_dcn_setup, xstep=_tvl2dcn_xstep, ystep=_tvl2den_ystep,
    obfn=_tvl2dcn_obfn, cnst_a=_tvdcn_cnst_a, cnst_at=_tvdcn_cnst_at,
    yinit=_tvl2_yinit, uinit=_tvl2_yinit, xinit=_xinit,
    stat_names=_DCN_STATS)


def _tvl1dcn_cnst_a(cfg, aux, params, X):
    """``(G; H) x``, the convolution block trailing
    (``sporco/admm/tvl1.py:700``)."""
    return _inv(cfg, params, aux["GAf"] * _fwd(cfg, X)[..., None])


def _tvl1dcn_cnst_at(cfg, aux, params, V):
    return _inv(cfg, params,
                torch.sum(aux["GAf"].conj() * _fwd(cfg, V), dim=-1))


def _tvl1dcn_xstep(cfg, aux, params, state):
    return _dcn_solve(cfg, aux, params, state, aux["GAf"], 1.0)


def _tvl1dcn_obfn(cfg, aux, params, state, xaux):
    gv = state.Y if cfg.g_eval_y else (
        _tvl1dcn_cnst_a(cfg, aux, params, state.X)
        - _tvl1_cnst_c(cfg, aux, params))
    return _tvl1_terms(cfg, params, gv) + (xaux["xrrs"],)


def _tvl1dcn_rsdl_s(cfg, aux, params, state, Yprev):
    return state.rho * _tvl1dcn_cnst_at(cfg, aux, params, state.U)


_TVL1DCN = ADMMProblem(
    setup=_dcn_setup, xstep=_tvl1dcn_xstep, ystep=_tvl1_ystep,
    obfn=_tvl1dcn_obfn, cnst_a=_tvl1dcn_cnst_a, cnst_at=_tvl1dcn_cnst_at,
    cnst_c=_tvl1_cnst_c, rsdl_s=_tvl1dcn_rsdl_s, rsdl_sn=_tvl1_rsdl_sn,
    yinit=_tvl1_yinit, uinit=_tvl1_yinit, xinit=_xinit,
    stat_names=_DCN_STATS)


# --- model classes ---------------------------------------------------------

def _is_complex(a):
    return a.is_complex() if isinstance(a, torch.Tensor) \
        else np.iscomplexobj(a)


def _tv_options(enabled, period, rsdl_target=None, **kw):
    """ADMM options with the TV models' defaults: RelaxParam 1.8,
    AutoScaling, Scaling 1000, RsdlRatio 1.2 (``sporco/admm/tvl2.py:
    117-124,465-470``, ``sporco/admm/tvl1.py:498``)."""
    ar = kw.pop("auto_rho", AutoRhoOpts(enabled=enabled, period=period,
                                        auto_scaling=True, scaling=1000.0,
                                        rsdl_ratio=1.2,
                                        rsdl_target=rsdl_target))
    base = dict(relax_param=1.8, auto_rho=ar)
    base.update(kw)
    return ADMMOpts(**base)


class _TVBase(ADMMModel):
    REF_OPT_EXTRA = {
        "gEvalY": ("k", "g_eval_y"),
        "fEvalX": refopts.IGNORE,
        "DFidWeight": ("k", "Wdf"),
        "TVWeight": ("k", "Wtv"),
    }

    def _setup(self, S, lmbda, opt, axes, caxis, Wdf, Wtv, dtype, Y0, U0,
               real, device, A=None, **cfg):
        """What the four models share: S of ``dtype`` (its complex type
        for complex data), the kernel ``A`` of a deconvolution, the
        weights, the configuration, rho (default ``2 lmbda + 0.1``) and
        the initial state."""
        self.device = resolve_device(device)
        if opt is None:
            opt = self.options()
        dtype = sf.torch_dtype(dtype)
        if not real:
            dtype = sf.complex_dtype(dtype)
        S = user_tensor(S, dtype, self.device)
        saxes = (-1,) if caxis is None else (caxis, -1)
        self.cfg = TVConfig(axes=tuple(axes), saxes=saxes, sndim=S.ndim,
                            real=real, **cfg)
        self.opts = opt.replace(dtype=dtype)
        rdt = sf.real_dtype(dtype)
        Wtv_ = user_tensor(Wtv, rdt, self.device)
        self.params = {
            "S": S, "lmbda": scalar_type(dtype)(lmbda),
            "Wdf": user_tensor(Wdf, rdt, self.device), "Wtv": Wtv_,
            "Wtvna": Wtv_[..., None] if Wtv_.ndim == S.ndim else Wtv_}
        if A is not None:
            A = user_tensor(A, dtype, self.device)
            self.params["A"] = A.reshape(tuple(A.shape)
                                         + (1,) * (S.ndim - A.ndim))
        self.lmbda = lmbda
        self.problem = self.PROBLEM
        rho0 = opt.rho if opt.rho is not None else 2.0 * lmbda + 0.1
        rho_xi = (opt.auto_rho.rsdl_target
                  if opt.auto_rho.rsdl_target is not None else 1.0)

        def warm(V):
            return None if V is None else user_tensor(V, dtype, self.device)
        self.state = init_state(self.problem, self.cfg, self.params,
                                self.opts, rho0, rho_xi, Y0=warm(Y0),
                                U0=warm(U0))
        self._init_done()

    def getmin(self):
        return self.state.X


class TVL2Denoise(_TVBase):
    r"""l2-TV denoising, ``argmin_x (1/2)||W_df (x - s)||_2^2 +
    lmbda ||W_tv sqrt(sum_i (G_i x)^2)||_1`` (``sporco/admm/tvl2.py:27``).
    ``axes`` are the TV axes; ``caxis`` makes the TV a vector TV over a
    channel axis.  ``S`` is a numpy array or a tensor; ``device=None``
    means the CUDA device and raises without one."""

    REF_OPT_EXTRA = {
        "GSTol": ("k", "gs_tol"),
        "MaxGSIter": ("k", "gs_max_iter"),
    }

    PROBLEM = _TVL2DEN
    L1_FID = False
    STAT_NAMES = _DEN_STATS

    @staticmethod
    def options(**kw):
        """Defaults: AutoRho off (``sporco/admm/tvl2.py:117-124``)."""
        return _tv_options(False, 1, **kw)

    def __init__(self, S, lmbda, opt=None, axes=(0, 1), caxis=None,
                 Wdf=1.0, Wtv=1.0, gs_max_iter=2, gs_tol=0.0,
                 dtype=torch.float32, Y0=None, U0=None, g_eval_y=True,
                 device=None):
        super().__init__()
        self._setup(S, lmbda, opt, axes, caxis, Wdf, Wtv, dtype, Y0, U0,
                    not _is_complex(S), device, l1_fidelity=self.L1_FID,
                    gs_max_iter=gs_max_iter, gs_tol=gs_tol,
                    g_eval_y=g_eval_y)


class TVL1Denoise(TVL2Denoise):
    r"""l1-TV denoising, ``argmin_x ||W_df (x - s)||_1 +
    lmbda ||W_tv sqrt(sum_i (G_i x)^2)||_1`` (``sporco/admm/tvl1.py:27``)."""

    PROBLEM = _TVL1DEN
    L1_FID = True

    def __init__(self, S, lmbda, opt=None, **kw):
        super().__init__(S, lmbda, opt=opt, **kw)


class TVL2Deconv(_TVBase):
    r"""l2-TV deconvolution, ``argmin_x (1/2)||H x - s||_2^2 +
    lmbda ||W_tv sqrt(sum_i (G_i x)^2)||_1`` with ``H`` the circular
    convolution by the kernel ``A`` (``sporco/admm/tvl2.py:377``)."""

    REF_OPT_EXTRA = {"LinSolveCheck": refopts.WARN}

    PROBLEM = _TVL2DCN
    STAT_NAMES = _DCN_STATS

    @staticmethod
    def options(**kw):
        """Defaults: AutoRho on, Period 1 (``sporco/admm/tvl2.py:
        465-470``)."""
        return _tv_options(True, 1, rsdl_target=1.0, **kw)

    def __init__(self, A, S, lmbda, opt=None, axes=(0, 1), caxis=None,
                 Wdf=1.0, Wtv=1.0, dtype=torch.float32, Y0=None, U0=None,
                 g_eval_y=True, device=None):
        super().__init__()
        real = not (_is_complex(S) or _is_complex(A))
        self._setup(S, lmbda, opt, axes, caxis, Wdf, Wtv, dtype, Y0, U0,
                    real, device, A=A, deconv=True, g_eval_y=g_eval_y)


class TVL1Deconv(TVL2Deconv):
    r"""l1-TV deconvolution (``sporco/admm/tvl1.py:403``)."""

    PROBLEM = _TVL1DCN

    @staticmethod
    def options(**kw):
        """Defaults: AutoRho off (``sporco/admm/tvl1.py:498``)."""
        return _tv_options(False, 1, **kw)
