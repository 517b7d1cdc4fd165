"""The port's ``ConvBPDNScalarTV``, ``ConvBPDNVectorTV`` and
``ConvBPDNRecTV`` on the CPU against the JAX package's on the same seeded
numpy problems (``examples/csc_tv.py``'s: a noisy image, lmbda 0.05, mu
0.02): a single-channel dictionary on a grey image and on a colour image
(maps per channel), a colour dictionary on a colour image, per-filter
weights and LinSolveCheck; and the FFT kernels' route.

Tolerances (those of ``tests/test_torch_maskdcpl.py``): float64 solved to
1e-3, the same iteration count, every row to rtol 1e-6 (``XSlvRelRes``,
rounding, within 1e-12), X and Y within 1e-8 of their scale; float32
over 10 iterations, the objective rows and Rho to rtol 1e-4, the
residuals to rtol 1e-3, X and Y within 2e-4; float32 solved to 1e-3, the
iteration count within one and the last objective to rtol 1e-3.
"""

import jax
import numpy as np
import pytest
import torch

from sporco_tpu.models import cbpdntv as jm
from sporco_tpu.ops import fft as jsf
from sporco_tpu.ops import pallas_fft
from sporco_tpu_torch.models import cbpdntv as tm
from sporco_tpu_torch.ops import fft as tsf
from sporco_tpu_torch.ops import fft2_planar as tfp

torch.set_num_threads(2)

N, ND, M = 32, 4, 6
LMBDA, MU = 0.05, 0.02
MODELS = ("ConvBPDNScalarTV", "ConvBPDNVectorTV", "ConvBPDNRecTV")
RSDL = ("PrimalRsdl", "DualRsdl")
SHAPES = ("grey", "colour_signal", "colour_dict")


def _problem(shape, n=N, seed=0):
    """A zero-mean piecewise smooth image (three channels for the colour
    shapes), standing for the high-pass part that CSC is given, with
    noise at 0.05, and a random dictionary of unit filters."""
    rng = np.random.default_rng(seed)
    Cd = 3 if shape == "colour_dict" else 1
    D = rng.standard_normal((ND, ND) + ((Cd,) if Cd > 1 else ()) + (M,))
    D /= np.sqrt((D ** 2).sum(axis=tuple(range(D.ndim - 1)),
                              keepdims=True))
    y, x = np.mgrid[:n, :n] / n
    img = 0.3 * (x > 0.5) - 0.15 + 0.2 * np.sin(6 * np.pi * y)
    if shape != "grey":
        img = np.stack([img, 0.8 * img, -img], axis=-1)
    S = img + 0.05 * rng.standard_normal(img.shape)
    kw = {} if shape == "grey" else {"dimK": 0}
    return D.astype(np.float32), S.astype(np.float32), kw


def _pair(name, shape, dtype, max_iter, tol, n=N, **extra):
    D, S, kw = _problem(shape, n=n)
    kw = {**kw, **extra}
    jcls, tcls = getattr(jm, name), getattr(tm, name)
    a = jcls(D, S, LMBDA, MU, dtype=dtype, opt=jcls.options(
        max_iter=max_iter, rel_stop_tol=tol), **kw)
    a.solve()
    b = tcls(D, S, LMBDA, MU, dtype=dtype, device="cpu", opt=tcls.options(
        max_iter=max_iter, rel_stop_tol=tol), **kw)
    b.solve()
    return a, b


def _assert_rows(a, b, rtol, rsdl_rtol):
    ja, ta = a.getitstat(), b.getitstat()
    assert ta._names == ja._names
    for name in ja._names:
        if name == "XSlvRelRes":
            np.testing.assert_allclose(getattr(ta, name),
                                       getattr(ja, name), rtol=0,
                                       atol=1e-12)
            continue
        np.testing.assert_allclose(
            getattr(ta, name), getattr(ja, name), err_msg=name, atol=1e-30,
            rtol=rsdl_rtol if name in RSDL else rtol)


def _leaves(v):
    return v if isinstance(v, tuple) else (v,)


def _assert_states(a, b, rel):
    for name in ("X", "Y", "U"):
        for i, (ja, ta) in enumerate(zip(_leaves(getattr(a.state, name)),
                                         _leaves(getattr(b.state, name)))):
            ja, ta = np.asarray(ja), ta.numpy()
            assert ta.shape == ja.shape and ta.dtype == ja.dtype, name
            assert np.abs(ta - ja).max() <= rel * max(np.abs(ja).max(),
                                                      1e-30), (name, i)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("name", MODELS)
def test_float64_solve_matches_jax(name, shape):
    a, b = _pair(name, shape, "float64", 300, 1e-3)
    assert len(a.getitstat()) == len(b.getitstat()) < 300
    _assert_rows(a, b, 1e-6, 1e-6)
    _assert_states(a, b, 1e-8)
    ja, tb = np.asarray(a.getmin()), b.getmin().numpy()
    assert np.abs(tb - ja).max() <= 1e-8 * np.abs(ja).max()
    ja, tb = np.asarray(a.reconstruct()), b.reconstruct().numpy()
    assert tb.shape == ja.shape
    assert np.abs(tb - ja).max() <= 1e-8 * np.abs(ja).max()


@pytest.mark.parametrize("name", MODELS)
def test_float32_iterations_match_jax(name):
    a, b = _pair(name, "colour_signal", "float32", 10, 0.0)
    assert len(a.getitstat()) == len(b.getitstat()) == 10
    _assert_rows(a, b, 1e-4, 1e-3)
    _assert_states(a, b, 2e-4)


@pytest.mark.parametrize("name", MODELS)
def test_float32_solve_matches_jax(name):
    a, b = _pair(name, "grey", "float32", 300, 1e-3)
    ja, ta = a.getitstat(), b.getitstat()
    assert abs(len(ja) - len(ta)) <= 1 and len(ta) < 300
    np.testing.assert_allclose(ta.ObjFun[-1], ja.ObjFun[-1], rtol=1e-3)


@pytest.mark.parametrize("name", ["ConvBPDNScalarTV", "ConvBPDNVectorTV"])
def test_weights_and_lin_check_match_jax(name):
    """Per-filter L1Weight and TVWeight, LinSolveCheck (its XSlvRelRes
    row, rounding: below 1e-10), float64, 40 iterations."""
    rng = np.random.default_rng(3)
    kw = {"wl1": rng.uniform(0.5, 1.5, (1, 1, M)),
          "wtv": rng.uniform(0.5, 1.5, M),
          "lin_check": True}
    a, b = _pair(name, "grey", "float64", 40, 0.0, **kw)
    _assert_rows(a, b, 1e-6, 1e-6)
    _assert_states(a, b, 1e-8)
    assert np.nanmax(b.getitstat().XSlvRelRes) < 1e-10


def test_options_and_defaults_match_jax():
    """The default options (rho 1, AutoRho with RsdlTarget 1), the
    reference's TVWeight key, and the card default."""
    D, S, _ = _problem("grey")
    for name in MODELS:
        ja, ta = getattr(jm, name).options(), getattr(tm, name).options()
        assert ta.auto_rho == type(ta.auto_rho)(**vars(ja.auto_rho))
        assert ta.relax_param == ja.relax_param
    b = tm.ConvBPDNScalarTV(D, S, LMBDA, MU, device="cpu",
                            opt={"TVWeight": 2.0, "MaxMainIter": 3})
    assert float(b.params["wtv"]) == 2.0 and float(b.state.rho) == 1.0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.ConvBPDNRecTV(D, S, LMBDA, MU)


@pytest.mark.parametrize("name", MODELS)
def test_planar_route_matches_jax_and_counts(name, monkeypatch):
    """At 128x128 (the colour signal: the transforms of ``(J + 1, 1, 3, M,
    N0, N1)`` and ``(J, 1, 3, 1, N0, N1)`` arrays, the leading axes
    flattened) every transform takes the FFT kernels' route: 5 float32
    iterations agree, and the planar calls are those ``chip_smoke.py``
    holds the card to: 3 forward in the set-up (D, S and the gradient
    filters), then an iteration 3 forward and 4 inverse (the scalar and
    vector models: 1 and 2 in the x-step, 1 and 1 in the dual residual,
    1 and 1 in its normaliser) or 4 and 4 (the reconstruction model: 2
    and 2 in the x-step)."""
    counts = {"rfft2_planar": 0, "irfft2_planar": 0}
    for label, attr in (("rfft2_planar", "rfft2_planar_plain"),
                        ("irfft2_planar", "irfft2_planar_plain")):
        fn = getattr(tfp, attr)

        def counted(*a, _fn=fn, _label=label, **k):
            counts[_label] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(tfp, attr, counted)
    prev = pallas_fft.interpret
    pallas_fft.interpret = True
    jsf.use_mxu_fft("always")
    tsf.use_planar_fft("always")
    jax.clear_caches()
    k = 5
    D, S, kw = _problem("colour_signal", n=128)
    try:
        a = getattr(jm, name)(D, S, LMBDA, MU, opt=jm.ConvBPDNScalarTV
                              .options(max_iter=k, rel_stop_tol=0.0), **kw)
        a.solve()
        b = getattr(tm, name)(D, S, LMBDA, MU, device="cpu",
                              opt=tm.ConvBPDNScalarTV.options(
                                  max_iter=k, rel_stop_tol=0.0), **kw)
        counts.update(rfft2_planar=0, irfft2_planar=0)
        b.solve()
    finally:
        jsf.use_mxu_fft("auto")
        tsf.use_planar_fft("auto")
        pallas_fft.interpret = prev
        jax.clear_caches()
    _assert_rows(a, b, 1e-4, 1e-3)
    _assert_states(a, b, 2e-4)
    fwd = 4 if name == "ConvBPDNRecTV" else 3
    assert counts == {"rfft2_planar": fwd * k + 3, "irfft2_planar": 4 * k}
