"""The port's generic FFT ConvBPDN paths on the CPU against the JAX
package's generic paths on the same numpy problems: ADMM
(``models.cbpdn.ConvBPDN`` on ``solvers.admm.admm_solve``) and FISTA
(``models.pgm.ConvBPDN``/``ConvBPDNMask`` on the FFT PGM problem).

At 128x128 the 2-D transforms of both packages run their FFT kernels:
the JAX package's Pallas ``rfft2_planar``/``irfft2_planar`` in interpret
mode (``pallas_fft.interpret``, forced through ``use_mxu_fft("always")``
as ``tests/ops/test_mxufft.py`` does), the port's through
``use_planar_fft("always")``, which runs their plain versions on the
CPU.  At 64x64 (not a size the kernels take) both run their FFT
libraries.  Every test restores the global switches.

Tolerances are those of ``tests/test_torch_cbpdn.py`` and
``tests/test_torch_pgm.py``: X within 2e-4 of its scale, ObjFun, DFid,
RegL1 and Rho rtol 1e-4, residuals rtol 1e-3 / atol 1e-6; a solve to
1e-3 takes the same number of iterations within one.
"""

import jax
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from sporco_tpu.models import cbpdn as jcb
from sporco_tpu.models import pgm as jpgm
from sporco_tpu.ops import fft as jsf
from sporco_tpu.ops import pallas_fft
from sporco_tpu_torch.models import cbpdn as tcb
from sporco_tpu_torch.models import pgm as tpgm
from sporco_tpu_torch.ops import fft as tsf
from sporco_tpu_torch.ops import fft2_planar as tfp

torch.set_num_threads(2)

LMBDA = 0.05


def _problem(N=64, M=4, Nd=8, seed=0, K=None, C=None, dimN=2):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((Nd,) * dimN + (M,)).astype(np.float32)
    D /= np.sqrt((D ** 2).sum(axis=tuple(range(dimN)), keepdims=True))
    shape = (N,) * dimN + tuple(n for n in (C, K) if n is not None)
    S = gaussian_filter(rng.standard_normal(shape), 4.0,
                        axes=tuple(range(dimN))) * 5.0
    S += 0.1 * rng.standard_normal(shape)
    return D, S.astype(np.float32)


def _mask(shape, seed=7, missing=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) >= missing).astype(np.float32)


@pytest.fixture
def fft_kernels(monkeypatch):
    """Both packages' 2-D transforms through their FFT kernels, with the
    calls counted (the JAX ones at trace time); JAX's compiled solves
    are dropped before and after, so that none traced without the
    kernels is reused, nor one traced with them afterwards."""
    calls = {"jax": 0, "port": 0}

    def counted(fn, key):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper
    monkeypatch.setattr(pallas_fft, "interpret", True)
    monkeypatch.setattr(pallas_fft, "rfft2_planar",
                        counted(pallas_fft.rfft2_planar, "jax"))
    monkeypatch.setattr(pallas_fft, "irfft2_planar",
                        counted(pallas_fft.irfft2_planar, "jax"))
    monkeypatch.setattr(tfp, "rfft2_planar_plain",
                        counted(tfp.rfft2_planar_plain, "port"))
    monkeypatch.setattr(tfp, "irfft2_planar_plain",
                        counted(tfp.irfft2_planar_plain, "port"))
    jax.clear_caches()
    jsf.use_mxu_fft("always")
    tsf.use_planar_fft("always")
    try:
        yield calls
    finally:
        jsf.use_mxu_fft("auto")
        tsf.use_planar_fft("auto")
        jax.clear_caches()


def _obj_atol(S):
    """The data fidelity is a nearly cancelled difference of terms of
    the size of 0.5||S||^2; where the fit is close (overcomplete 1-D
    dictionaries, unnormalised filters) its fp32 rounding is a few
    millionths of that scale, not of its own value."""
    return 2e-6 * 0.5 * float(np.sum(np.abs(S) ** 2))


def _assert_admm_close(jb, jY, tb, tY, same_len=True, obj_atol=0.0):
    ja, ta = jb.getitstat(), tb.getitstat()
    if same_len:
        assert len(ja) == len(ta) > 0
    n = min(len(ja), len(ta))
    np.testing.assert_array_equal(ta.Iter[:n], ja.Iter[:n])
    assert tY.shape == jY.shape
    scale = max(np.abs(jY).max(), 1e-6)
    assert np.abs(tY - jY).max() < 2e-4 * scale
    jX, tX = np.asarray(jb.state.X), tb.state.X.cpu().numpy()
    assert np.abs(jX - tX).max() < 2e-4 * max(np.abs(jX).max(), 1e-6)
    for name in ("ObjFun", "DFid", "RegL1", "Rho"):
        np.testing.assert_allclose(
            getattr(ta, name)[:n], getattr(ja, name)[:n], rtol=1e-4,
            atol=obj_atol if name in ("ObjFun", "DFid") else 0.0,
            err_msg=name)
    for name in ("PrimalRsdl", "DualRsdl"):
        np.testing.assert_allclose(getattr(ta, name)[:n],
                                   getattr(ja, name)[:n], rtol=1e-3,
                                   atol=1e-6, err_msg=name)


def _admm_both(D, S, opt, jkw=None, **kw):
    jkw = dict(kw) if jkw is None else jkw
    jb = jcb.ConvBPDN(D, S, LMBDA, opt=jcb.ConvBPDN.options(**opt),
                      fused=False, **jkw)
    jY = np.asarray(jb.solve())
    tb = tcb.ConvBPDN(D, S, LMBDA, opt=tcb.ConvBPDN.options(**opt),
                      fused=False, device="cpu", **kw)
    tY = tb.solve().numpy()
    assert tb._fused_solve is None
    return jb, jY, tb, tY


# ---------------------------------------------------------------------------
# ADMM

def test_generic_admm_through_fft_kernels_matches_jax(fft_kernels):
    """The slice as a whole: 128x128 with 4 filters solved to 1e-3, the
    x-step's rfft2/irfft2 pair on both packages' FFT kernels."""
    D, S = _problem(N=128)
    jb, jY, tb, tY = _admm_both(D, S, dict(max_iter=200))
    kj, kt = int(jb.state.k), int(tb.state.k)
    assert kj < 200 and abs(kj - kt) <= 1
    _assert_admm_close(jb, jY, tb, tY, same_len=False)
    # setup (D, S), then one forward and one inverse per iteration
    assert fft_kernels["port"] == 2 * kt + 2
    assert fft_kernels["jax"] > 0


def _generic_case(kind):
    """(D, S, port keywords, JAX keywords, options) of a generic case
    at 64x64 (``torch.fft``/``jnp.fft``)."""
    D, S = _problem()
    opt = dict(max_iter=12, rel_stop_tol=0.0)
    rng = np.random.default_rng(5)
    kw = {}
    if kind == "lin_check":
        kw = dict(lin_check=True)
    elif kind == "aux_var_obj":
        kw = dict(obj_from_x=False)
    elif kind == "spatial_wl1_nonneg":
        kw = dict(wl1=(0.5 + rng.random((64, 64, 4))).astype(np.float32),
                  non_neg=True)
    elif kind == "two_signals":
        D, S = _problem(K=2)
    elif kind == "colour_signal":
        D, S = _problem(C=3)
        kw = dict(dimK=0)
    elif kind == "one_dim":
        D, S = _problem(N=96, Nd=9, dimN=1)
        kw = dict(dimN=1)
    elif kind == "three_dim":
        D, S = _problem(N=12, Nd=3, dimN=3)
        kw = dict(dimN=3)
    elif kind == "complex128":
        D = (D + 0.3j * _problem(seed=1)[0]).astype(np.complex128)
        kw = dict(dtype=torch.float64)
        return D, S, kw, dict(dtype=np.float64), opt
    elif kind == "fast_solve":
        opt = dict(opt, fast_solve=True)
    elif kind == "relax1_std_residuals":
        from sporco_tpu.solvers.admm import AutoRhoOpts as JAR
        from sporco_tpu_torch.solvers.admm import AutoRhoOpts as TAR
        ar = dict(enabled=True, period=3, std_residuals=True,
                  auto_scaling=False)
        opt = dict(opt, relax_param=1.0)
        return D, S, {"auto_rho": TAR(**ar)}, {"auto_rho": JAR(**ar)}, opt
    return D, S, kw, dict(kw), opt


@pytest.mark.parametrize("kind", ["lin_check", "aux_var_obj",
                                  "spatial_wl1_nonneg", "two_signals",
                                  "colour_signal", "one_dim", "three_dim",
                                  "complex128", "fast_solve",
                                  "relax1_std_residuals"])
def test_generic_admm_configurations_match_jax(kind):
    D, S, kw, jkw, opt = _generic_case(kind)
    ar = {}
    if "auto_rho" in kw:
        ar = {"t": kw.pop("auto_rho"), "j": jkw.pop("auto_rho")}
    jb = jcb.ConvBPDN(D, S, LMBDA, opt=jcb.ConvBPDN.options(
        **opt, **({"auto_rho": ar["j"]} if ar else {})), fused=False,
        **jkw)
    jY = np.asarray(jb.solve())
    tb = tcb.ConvBPDN(D, S, LMBDA, opt=tcb.ConvBPDN.options(
        **opt, **({"auto_rho": ar["t"]} if ar else {})), fused=False,
        device="cpu", **kw)
    tY = tb.solve().numpy()
    _assert_admm_close(jb, jY, tb, tY, obj_atol=_obj_atol(S))
    ta = tb.getitstat()
    if kind == "lin_check":
        # both tiny: the linear solve is exact to rounding
        assert np.all(ta.XSlvRelRes < 1e-5)
        assert np.all(jb.getitstat().XSlvRelRes < 1e-5)
    else:
        assert np.isnan(ta.XSlvRelRes).all()
    if kind == "spatial_wl1_nonneg":
        assert (tY >= 0).all()
    if kind == "complex128":
        assert tb.state.Y.dtype == torch.complex128
    if kind == "fast_solve":
        assert np.isnan(ta.ObjFun).all() and np.isnan(ta.DFid).all()


def test_generic_admm_warm_restart_from_jax_state():
    """A JAX generic ``state_dict()`` loaded into the port's generic solve
    continues as the JAX model continues."""
    D, S = _problem(seed=2)
    opt = dict(max_iter=10, rel_stop_tol=0.0)
    jb = jcb.ConvBPDN(D, S, LMBDA, opt=jcb.ConvBPDN.options(**opt),
                      fused=False)
    jb.solve()
    sd = {k: np.asarray(v) for k, v in jb.state_dict().items()
          if k != "extra"}
    jY2 = np.asarray(jb.solve())
    tb = tcb.ConvBPDN(D, S, LMBDA, opt=tcb.ConvBPDN.options(**opt),
                      fused=False, device="cpu")
    tb.load_state_dict_numpy(sd)
    tY2 = tb.solve().numpy()
    assert int(tb.state.k) == int(jb.state.k) == 20
    _assert_admm_close(jb, jY2, tb, tY2)
    # and the port's own state round trip continues alike
    tc = tcb.ConvBPDN(D, S, LMBDA, opt=tcb.ConvBPDN.options(**opt),
                      fused=False, device="cpu")
    tc.load_state(tb.state_dict())
    np.testing.assert_array_equal(tc.solve().numpy(), tb.solve().numpy())


def test_fused_true_on_generic_configuration_raises_as_jax():
    D, S = _problem(N=60)
    jb = jcb.ConvBPDN(D, S, LMBDA, fused=True)
    with pytest.raises(ValueError, match="fused=True"):
        jb.solve()
    with pytest.raises(ValueError, match="fused=True"):
        tcb.ConvBPDN(D, S, LMBDA, fused=True, device="cpu")
    # colour dictionaries: the same rule (the rank-C fused driver needs
    # PS-aligned sizes), and the generic path takes them
    Dc = np.random.default_rng(0).standard_normal((8, 8, 3, 4)) \
        .astype(np.float32)
    Sc = np.repeat(S[..., None], 3, axis=-1)
    jc = jcb.ConvBPDN(Dc, Sc, LMBDA, dimK=0, fused=True)
    with pytest.raises(ValueError, match="fused=True"):
        jc.solve()
    with pytest.raises(ValueError, match="fused=True"):
        tcb.ConvBPDN(Dc, Sc, LMBDA, dimK=0, fused=True, device="cpu")
    for fused in ("auto", False):
        tc = tcb.ConvBPDN(Dc, Sc, LMBDA, dimK=0, fused=fused, device="cpu")
        assert tc._fused_solve is None


# ---------------------------------------------------------------------------
# FISTA

def _pgm_both(D, S, masked, opt, **kw):
    jcls = jpgm.ConvBPDNMask if masked else jpgm.ConvBPDN
    tcls = tpgm.ConvBPDNMask if masked else tpgm.ConvBPDN
    jb = jcls(D, S, LMBDA, opt=jcls.options(**opt), fused=False, **kw)
    jX = np.asarray(jb.solve())
    tb = tcls(D, S, LMBDA, opt=tcls.options(**opt), fused=False,
              device="cpu", **kw)
    tX = tb.solve().numpy()
    assert tb._fused_solve is None
    return jb, jX, tb, tX


def _assert_pgm_close(jb, jX, tb, tX):
    ja, ta = jb.getitstat(), tb.getitstat()
    assert len(ja) == len(ta) > 0
    np.testing.assert_array_equal(ta.Iter, ja.Iter)
    assert tX.shape == jX.shape
    assert np.abs(tX - jX).max() < 2e-4 * max(np.abs(jX).max(), 1e-6)
    for name in ("Y", "Xprv"):
        a = getattr(tb.state, name).numpy()
        b = np.asarray(getattr(jb.state, name))
        assert np.abs(a - b).max() < 2e-4 * max(np.abs(b).max(), 1e-6)
    for name in ("ObjFun", "DFid", "RegL1", "L"):
        np.testing.assert_allclose(getattr(ta, name), getattr(ja, name),
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(ta.Rsdl, ja.Rsdl, rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(ta.IterBTrack, ja.IterBTrack)


@pytest.mark.parametrize("masked", [False, True])
def test_generic_fista_through_fft_kernels_matches_jax(fft_kernels,
                                                       masked):
    """128x128 with 4 filters, 30 FISTA iterations at L = 100, masked and
    not, every 2-D transform on both packages' FFT kernels."""
    D, S = _problem(N=128, seed=3)
    kw = dict(W=_mask((128, 128))) if masked else {}
    jb, jX, tb, tX = _pgm_both(D, S, masked,
                               dict(max_iter=30, rel_stop_tol=0.0,
                                    L=100.0), **kw)
    _assert_pgm_close(jb, jX, tb, tX)
    # per iteration: gradient (2 transforms, 4 masked) and objective
    # (1, 2 masked); the setup's D and S
    per = 6 if masked else 3
    assert fft_kernels["port"] == per * 30 + 2
    assert fft_kernels["jax"] > 0


@pytest.mark.parametrize("kind", ["standard", "robust", "cauchy", "bb",
                                  "monotone", "nonneg_no_bndry_K2"])
def test_generic_fista_options_match_jax(kind):
    """The generic FFT problem under each PGM option the loop has, at
    64x64 (``torch.fft``/``jnp.fft``)."""
    D, S = _problem(seed=4)
    opt = dict(max_iter=12, rel_stop_tol=0.0, L=20.0)
    kw = {}
    if kind in ("standard", "robust"):
        opt["backtrack"] = kind
    elif kind in ("cauchy", "bb"):
        opt["stepsize"] = kind
    elif kind == "monotone":
        opt["monotone"] = True
    else:
        D, S = _problem(seed=4, K=2)
        kw = dict(non_neg=True, no_bndry=True)
    _assert_pgm_close(*_pgm_both(D, S, False, opt, **kw))


def test_generic_fista_warm_restart_from_jax_state():
    D, S = _problem(seed=6)
    W = _mask((64, 64))
    opt = dict(max_iter=10, rel_stop_tol=0.0, L=50.0)
    jb = jpgm.ConvBPDNMask(D, S, LMBDA, W=W, opt=jpgm.ConvBPDN.options(
        **opt), fused=False)
    jb.solve()
    sd = {k: np.asarray(v) for k, v in jb.state_dict().items()}
    jX2 = np.asarray(jb.solve())
    tb = tpgm.ConvBPDNMask(D, S, LMBDA, W=W, opt=tpgm.ConvBPDN.options(
        **opt), fused=False, device="cpu")
    tb.load_state_dict_numpy(sd)
    tX2 = tb.solve().numpy()
    assert int(tb.state.k) == int(jb.state.k) == 20
    _assert_pgm_close(jb, jX2, tb, tX2)


def test_params_default_to_the_card(monkeypatch):
    """No entry point of the port defaults to the CPU: without a CUDA
    device the problem constructors raise unless asked for the CPU."""
    D, S = _problem(N=32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for build in (tcb.params_from_numpy, tpgm.params_from_numpy):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build(D, S, LMBDA)
        cri, params, real = build(D, S, LMBDA, device="cpu")
        assert real and params["D"].device.type == "cpu"
    for cls in (tcb.ConvBPDN, tpgm.ConvBPDN):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(D, S, LMBDA, fused=False)
