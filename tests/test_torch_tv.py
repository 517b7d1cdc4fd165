"""The port's ``models.tv`` (``TVL2Denoise``, ``TVL1Denoise``,
``TVL2Deconv``, ``TVL1Deconv``) on the CPU against the JAX package's on
the same seeded numpy problems: the square of ``bench.py``'s
``_bench_tvl2`` at 32x32 with noise (salt and pepper for the l1
fidelity), and ``examples/tv_deconv.py``'s 5x5 box blur.

Tolerances (PERF.md §2): the same iteration count; ObjFun, DFid, RegTV
and Rho rows to rtol 1e-4, the residuals and ``GSRelRes`` (a relative
residual) to rtol 1e-3, ``GSIter`` exactly; X and Y within 2e-4 of their
scale in float32 and complex64, 1e-8 in float64 and complex128.
``XSlvRelRes``, the relative residual of the per-bin solve, is rounding
noise in both packages (about 1e-7 in float32) and is held absolutely,
to 1e-5 (1e-13 in float64).
"""

import jax
import numpy as np
import pytest
import torch

from sporco_tpu.models import tv as jt
from sporco_tpu.ops import fft as jsf
from sporco_tpu.ops import pallas_fft
from sporco_tpu_torch.models import tv as tt
from sporco_tpu_torch.ops import fft as tsf
from sporco_tpu_torch.ops import fft2_planar as tfp

torch.set_num_threads(2)

MODELS = ["TVL2Denoise", "TVL1Denoise", "TVL2Deconv", "TVL1Deconv"]
LMBDA = {"TVL2Denoise": 0.05, "TVL1Denoise": 0.8, "TVL2Deconv": 5e-3,
         "TVL1Deconv": 5e-3}
RSDL = ("PrimalRsdl", "DualRsdl", "GSRelRes")
BLUR = np.ones((5, 5), np.float32) / 25.0


def _image(shape, seed=0, complex_=False, salt=False):
    """The square of ``bench.py``'s TV problem over the first two axes
    of ``shape``, with noise at 0.1, or salt and pepper at 5% each."""
    rng = np.random.default_rng(seed)
    N0, N1 = shape[:2]
    img = np.zeros(shape, np.float32)
    img[N0 // 4:3 * N0 // 4, N1 // 4:3 * N1 // 4] = 1.0
    if salt:
        m = rng.random(shape)
        S = img.copy()
        S[m < 0.05] = 0.0
        S[m > 0.95] = 1.0
    else:
        S = img + 0.1 * rng.standard_normal(shape).astype(np.float32)
    if complex_:
        S = S + 0.5j * rng.standard_normal(shape)
        return S.astype(np.complex64)
    return S.astype(np.float32)


def _args(name, S):
    if name.endswith("Deconv"):
        return (BLUR, S, LMBDA[name])
    return (S, LMBDA[name])


def _pair(name, S, dtype, max_iter=200, tol=1e-3, **kw):
    jc, tc = getattr(jt, name), getattr(tt, name)
    a = jc(*_args(name, S), opt=jc.options(max_iter=max_iter,
                                            rel_stop_tol=tol),
           dtype=dtype, **kw)
    a.solve()
    b = tc(*_args(name, S), opt=tc.options(max_iter=max_iter,
                                            rel_stop_tol=tol),
           dtype=dtype, device="cpu", **kw)
    b.solve()
    return a, b


def _assert_match(a, b, dtype):
    ja, ta = a.getitstat(), b.getitstat()
    assert ta._names == ja._names
    assert len(ta) == len(ja)
    f64 = dtype in ("float64", "complex128")
    for name in ja._names:
        jv, tv = getattr(ja, name), getattr(ta, name)
        if name == "XSlvRelRes":
            np.testing.assert_allclose(tv, jv, rtol=0,
                                       atol=1e-13 if f64 else 1e-5)
        elif name in ("Iter", "GSIter"):
            np.testing.assert_array_equal(tv, jv, err_msg=name)
        else:
            rtol = 1e-6 if f64 else (1e-3 if name in RSDL else 1e-4)
            np.testing.assert_allclose(tv, jv, rtol=rtol, err_msg=name)
    rel = 1e-8 if f64 else 2e-4
    for jx, tx in ((a.state.X, b.state.X), (a.state.Y, b.state.Y)):
        jx, tx = np.asarray(jx), tx.numpy()
        assert tx.shape == jx.shape and tx.dtype == jx.dtype
        assert np.abs(tx - jx).max() <= rel * np.abs(jx).max()


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64",
                                   "complex128"])
def test_2d_matches_jax(name, dtype):
    """2-D S, real and complex (the complex data carries an imaginary
    part of its own), to 1e-3 or 200 iterations."""
    S = _image((32, 32), complex_=dtype.startswith("complex"),
               salt=name == "TVL1Denoise")
    rdt = "float64" if dtype in ("float64", "complex128") else "float32"
    a, b = _pair(name, S, rdt)
    assert b.opts.dtype == getattr(torch, dtype)
    _assert_match(a, b, dtype)


@pytest.mark.parametrize("name", MODELS)
@pytest.mark.parametrize("axes,shape,caxis",
                         [((0, 1), (16, 16, 3), None),
                          ((0, 1, 2), (12, 12, 8), None),
                          ((0, 1), (16, 16, 3), 2)],
                         ids=["axes01", "axes012", "caxis"])
def test_3d_and_vector_tv_match_jax(name, axes, shape, caxis):
    """3-D S with TV over two of its axes and over all three, and vector
    TV over a channel axis (``caxis``); float32."""
    S = _image(shape, seed=1)
    a, b = _pair(name, S, "float32", axes=axes, caxis=caxis)
    _assert_match(a, b, "float32")


@pytest.mark.parametrize("name,gs_max_iter,gs_tol",
                         [("TVL2Denoise", 5, 1e-2), ("TVL2Denoise", 3, 0.0),
                          ("TVL2Denoise", 1, 0.0), ("TVL1Denoise", 5, 0.2),
                          ("TVL1Denoise", 3, 0.0)])
def test_jacobi_rows_match_jax(name, gs_max_iter, gs_tol):
    """``GSIter``/``GSRelRes``: with ``gs_tol`` > 0 the sweeps stop early
    (fewer than ``gs_max_iter`` in some iterations), in float64 so the
    early stops fall on the same iterations."""
    S = _image((32, 32), seed=2, salt=name == "TVL1Denoise")
    a, b = _pair(name, S, "float64", gs_max_iter=gs_max_iter,
                 gs_tol=gs_tol)
    _assert_match(a, b, "float64")
    gsit = b.getitstat().GSIter
    if gs_tol > 0:
        assert gsit.min() < gs_max_iter
    else:
        assert (gsit == gs_max_iter).all()


@pytest.mark.parametrize("name", MODELS)
def test_weights_and_g_eval_match_jax(name):
    """Spatial data-fidelity and TV weight arrays and ``g_eval_y=False``
    (the TV term at A(X))."""
    rng = np.random.default_rng(3)
    S = _image((32, 32), seed=3)
    kw = {"Wtv": rng.uniform(0.5, 1.5, (32, 32)).astype(np.float32),
          "g_eval_y": False}
    if name.endswith("Denoise"):
        kw["Wdf"] = rng.uniform(0.5, 1.5, (32, 32)).astype(np.float32)
    a, b = _pair(name, S, "float32", **kw)
    _assert_match(a, b, "float32")


@pytest.mark.parametrize("name", MODELS)
def test_reference_dict_and_reentrant_solve(name):
    """A reference-style option dict, then a second solve call that goes
    on from the first (float64)."""
    S = _image((32, 32), seed=4)
    opt = {"MaxMainIter": 12, "RelStopTol": 0.0, "gEvalY": False,
           "AutoRho": {"Enabled": True, "Period": 3},
           "DataType": "float64"}
    if name.endswith("Denoise"):
        opt.update({"MaxGSIter": 3, "DFidWeight": 0.8})
    a = getattr(jt, name)(*_args(name, S), opt=dict(opt))
    b = getattr(tt, name)(*_args(name, S), opt=dict(opt), device="cpu")
    assert b.opts.auto_rho.period == 3 and not b.cfg.g_eval_y
    for _ in range(2):
        a.solve()
        b.solve()
        _assert_match(a, b, "float64")
    assert int(b.state.k) == 24


@pytest.mark.parametrize("name", ["TVL2Deconv", "TVL1Deconv"])
def test_deconv_planar_route_matches_jax_and_counts(name, monkeypatch):
    """At 128x128 the port's transforms of X take the planar kernels'
    route (their plain versions here, ``use_planar_fft("always")``) and
    the JAX package's its Pallas kernels (``use_mxu_fft("always")``,
    interpret mode): 6 iterations agree, and the planar calls are the
    count ``chip_smoke.py`` holds the card to: 4 forward in the set-up,
    then per iteration 1 forward and 3 inverse (TVL2Deconv) or 2
    (TVL1Deconv)."""
    counts = {"rfft2_planar": 0, "irfft2_planar": 0}
    for label, attr in (("rfft2_planar", "rfft2_planar_plain"),
                        ("irfft2_planar", "irfft2_planar_plain")):
        fn = getattr(tfp, attr)

        def counted(*a, _fn=fn, _label=label, **k):
            counts[_label] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(tfp, attr, counted)
    prev_interp = pallas_fft.interpret
    pallas_fft.interpret = True
    jsf.use_mxu_fft("always")
    tsf.use_planar_fft("always")
    jax.clear_caches()
    try:
        S = _image((128, 128), seed=5)
        a, b = _pair(name, S, "float32", max_iter=6, tol=0.0)
    finally:
        jsf.use_mxu_fft("auto")
        tsf.use_planar_fft("auto")
        pallas_fft.interpret = prev_interp
        jax.clear_caches()
    _assert_match(a, b, "float32")
    k = 6
    inv = 3 if name == "TVL2Deconv" else 2
    assert counts == {"rfft2_planar": k + 4, "irfft2_planar": inv * k}


def test_card_default():
    """Without ``device`` the models run on the card and raise where
    there is none."""
    S = _image((16, 16))
    b = tt.TVL2Denoise(S, 0.05, device="cpu")
    assert b.getmin().device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tt.TVL2Denoise(S, 0.05)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tt.TVL1Deconv(BLUR, S, 0.05)
