"""The port's Plug-and-Play models (``PPP``, ``PPPConsensus``, ``PPPPGM``)
and ``host_prior`` on the CPU against the JAX package's on the same
seeded numpy problem, ``examples/ppp_denoise.py``'s: a 5x5 box blur with
noise at 0.01, the data term's prox and gradient by the DFT, and a
Tikhonov gradient smoother as the prior.  The callables of each side are
written with that package's ``ops.fft``, so the port's run the FFT
kernels' route where the dispatch sends them.

Tolerances (those of ``tests/test_torch_maskdcpl.py``): float64, the same
iteration count, every row to rtol 1e-6 and the solution within 1e-8 of
its scale; float32 over 10 iterations, the rows to rtol 1e-4 (the
residuals 1e-3), the solution within 2e-4; whole float32 solves, the
iteration count within one and the last row of the first column to rtol
1e-3.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sporco_tpu.models import ppp as jp
from sporco_tpu.ops import fft as jsf
from sporco_tpu.ops import pallas_fft
from sporco_tpu_torch.models import ppp as tp
from sporco_tpu_torch.ops import fft as tsf
from sporco_tpu_torch.ops import fft2_planar as tfp

torch.set_num_threads(2)

N = 32
LAM = 0.02
RSDL = ("PrimalRsdl", "DualRsdl", "Rsdl")


def _problem(n=N, seed=0):
    """The blurred, noisy image and the DFT constants of the example."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:n, :n] / n
    img = 0.5 + 0.3 * (x > 0.4) * (y < 0.7) + 0.1 * np.sin(8 * x)
    krn = np.ones((5, 5)) / 25.0
    Af = np.fft.rfftn(krn, s=(n, n), axes=(0, 1))
    s = np.fft.irfftn(Af * np.fft.rfftn(img), s=(n, n), axes=(0, 1)) \
        + 0.01 * rng.standard_normal((n, n))
    gr = np.zeros((n, n))
    gr[0, 0], gr[1, 0] = -1, 1
    gc = np.zeros((n, n))
    gc[0, 0], gc[0, 1] = -1, 1
    ghg = np.abs(np.fft.rfftn(gr)) ** 2 + np.abs(np.fft.rfftn(gc)) ** 2
    return img, s, Af, np.fft.rfftn(s), ghg


def _callables(pkg, dtype, n=N):
    """(f, proxf, prior, gradf) written with ``pkg``'s arrays and FFT."""
    _, _, Af, Sf, ghg = _problem(n)
    cd = np.complex128 if dtype == "float64" else np.complex64
    if pkg == "jax":
        xp, fwd, inv = jnp.asarray, jsf.rfftn, jsf.irfftn
    else:
        xp, fwd, inv = torch.as_tensor, tsf.rfftn, tsf.irfftn
    A, S, G = xp(Af.astype(cd)), xp(Sf.astype(cd)), xp(ghg.astype(dtype))
    shape = (n, n)

    def f(x):
        return 0.5 * (abs(A * fwd(x) - S) ** 2).sum() / (n * n)

    def proxf(x, rho):
        return inv((A.conj() * S + rho * fwd(x)) / (abs(A) ** 2 + rho),
                   shape)

    def prior(x, rho):
        return inv(fwd(x) / (1.0 + (LAM / rho) * G), shape)

    def gradf(x):
        return inv(A.conj() * (A * fwd(x) - S), shape)
    return f, proxf, prior, gradf


def _make(pkg, name, dtype, max_iter, tol, n=N, prior=None):
    f, proxf, tik, gradf = _callables(pkg, dtype, n)
    prior = prior or tik
    mod = jp if pkg == "jax" else tp
    kw = {"dtype": dtype}
    if pkg == "port":
        kw["device"] = "cpu"
    if name == "PPP":
        return mod.PPP((n, n), f, proxf, prior, opt=mod.PPP.options(
            max_iter=max_iter, rel_stop_tol=tol, rho=0.05), **kw)
    if name == "PPPConsensus":
        return mod.PPPConsensus((n, n), [proxf, prior], mu=[2.0, 1.0],
                                opt=mod.PPPConsensus.options(
                                    max_iter=max_iter, rel_stop_tol=tol,
                                    rho=0.05),
                                **kw)
    return mod.PPPPGM((n, n), f, gradf, prior, opt=mod.PPPPGM.options(
        max_iter=max_iter, rel_stop_tol=tol, L=1.0), **kw)


def _pair(name, dtype, max_iter, tol, **kw):
    a = _make("jax", name, dtype, max_iter, tol, **kw)
    a.solve()
    b = _make("port", name, dtype, max_iter, tol, **kw)
    b.solve()
    return a, b


def _assert_match(a, b, rtol, rsdl_rtol, rel):
    ja, ta = a.getitstat(), b.getitstat()
    assert ta._names == ja._names and len(ta) == len(ja)
    for name in ja._names:
        np.testing.assert_allclose(
            getattr(ta, name), getattr(ja, name), err_msg=name, atol=1e-30,
            rtol=rsdl_rtol if name in RSDL else rtol)
    jx, tx = np.asarray(a.getmin()), b.getmin().numpy()
    assert tx.shape == jx.shape and tx.dtype == jx.dtype
    assert np.abs(tx - jx).max() <= rel * np.abs(jx).max()


MODELS = ("PPP", "PPPConsensus", "PPPPGM")


@pytest.mark.parametrize("name", MODELS)
def test_float64_solve_matches_jax(name):
    a, b = _pair(name, "float64", 200, 1e-3)
    assert len(b.getitstat()) < 200
    _assert_match(a, b, 1e-6, 1e-6, 1e-8)


@pytest.mark.parametrize("name", MODELS)
def test_float32_iterations_match_jax(name):
    a, b = _pair(name, "float32", 10, 0.0)
    _assert_match(a, b, 1e-4, 1e-3, 2e-4)


@pytest.mark.parametrize("name", MODELS)
def test_float32_solve_matches_jax(name):
    a, b = _pair(name, "float32", 200, 1e-3)
    ja, ta = a.getitstat(), b.getitstat()
    assert abs(len(ja) - len(ta)) <= 1 and len(ta) < 200
    col = ja._names[1]
    if col in RSDL:     # PPPConsensus has no objective: its residual
        np.testing.assert_allclose(getattr(ta, col)[-1],
                                   getattr(ja, col)[-1], rtol=1e-2)
    else:
        np.testing.assert_allclose(getattr(ta, col)[-1],
                                   getattr(ja, col)[-1], rtol=1e-3)


def test_ppp_restores_the_image():
    """The restored image is closer to the original than the blurred and
    noisy one (PSNR), in both packages alike."""
    img, s, _, _, _ = _problem()
    b = _make("port", "PPP", "float64", 30, 0.0)
    x = b.solve().numpy()
    mse = np.mean((x - img) ** 2)
    assert mse < np.mean((s - img) ** 2)


def _numpy_prior(x):
    """The Tikhonov smoother on a numpy array, with a fixed rho."""
    ghg = _problem()[4]
    return np.fft.irfftn(np.fft.rfftn(x) / (1.0 + (LAM / 0.05) * ghg),
                         s=x.shape, axes=(0, 1)).astype(x.dtype)


def test_host_prior_matches_jax():
    """A numpy denoiser through ``host_prior`` in both packages (the
    port's copies to the host and back, the JAX package's is a
    ``pure_callback``): the same rows, in float64; the wrapped function
    keeps the tensor's device and dtype."""
    a = _make("jax", "PPP", "float64", 20, 0.0,
              prior=jp.host_prior(_numpy_prior))
    a.solve()
    hp = tp.host_prior(_numpy_prior)
    b = _make("port", "PPP", "float64", 20, 0.0, prior=hp)
    b.solve()
    _assert_match(a, b, 1e-6, 1e-6, 1e-8)
    x = torch.ones((N, N), dtype=torch.float32)
    out = hp(x, 0.05)
    assert out.dtype == torch.float32 and out.device == x.device


def test_options_and_card_default():
    """The default options of each model (rho 1, RelaxParam 1, AutoRho
    off) as the JAX package's; without ``device`` they run on the card
    and raise where there is none."""
    for name in ("PPP", "PPPConsensus"):
        ja, ta = getattr(jp, name).options(), getattr(tp, name).options()
        assert (ta.rho, ta.relax_param, ta.auto_rho.enabled) == (
            ja.rho, ja.relax_param, ja.auto_rho.enabled)
    assert tp.PPPPGM.options().L is None
    if not torch.cuda.is_available():
        f, proxf, prior, gradf = _callables("port", "float32")
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tp.PPP((N, N), f, proxf, prior)


@pytest.mark.parametrize("name", MODELS)
def test_planar_route_matches_jax_and_counts(name, monkeypatch):
    """At 128x128 the callables' transforms take the FFT kernels' route
    (the port's plain versions, the JAX Pallas kernels in interpret
    mode): 5 float32 iterations agree, and the planar calls are those
    ``chip_smoke.py`` holds the card to, an iteration: ``PPP`` 3 forward
    and 2 inverse (the data prox, the prior and the objective's f),
    ``PPPConsensus`` 2 and 2 (the two agents), ``PPPPGM`` 3 and 2 (the
    gradient, the prior and f)."""
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
    try:
        a = _make("jax", name, "float32", k, 0.0, n=128)
        a.solve()
        b = _make("port", name, "float32", k, 0.0, n=128)
        counts.update(rfft2_planar=0, irfft2_planar=0)
        b.solve()
    finally:
        jsf.use_mxu_fft("auto")
        tsf.use_planar_fft("auto")
        pallas_fft.interpret = prev
        jax.clear_caches()
    _assert_match(a, b, 1e-4, 1e-3, 2e-4)
    fwd = 2 if name == "PPPConsensus" else 3
    assert counts == {"rfft2_planar": fwd * k, "irfft2_planar": 2 * k}
