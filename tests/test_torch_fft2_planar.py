"""The port's 2-D planar FFT (``sporco_tpu_torch.ops.fft2_planar``, its
plain PyTorch versions on the CPU) against the JAX package's Pallas
``rfft2_planar``/``irfft2_planar`` in interpret mode and against float64
numpy, and the port's ``ops.fft`` dispatch against ``mxufft``'s rule.

Tolerances are the JAX package's own (``tests/ops/test_pallas_fft.py``):
the forward transform within 1e-6 of the spectrum's largest magnitude,
the inverse within 3e-5 absolute on unit-normal data.  The port and the
JAX kernel run the same arithmetic in fp32; they agree within twice
that.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sporco_tpu.ops import fft as jsf
from sporco_tpu.ops import mxufft, pallas_fft
from sporco_tpu_torch.ops import fft as tsf
from sporco_tpu_torch.ops import fft2_planar as tfp

torch.set_num_threads(2)


@pytest.fixture
def interpret():
    prev = pallas_fft.interpret
    pallas_fft.interpret = True
    try:
        yield
    finally:
        pallas_fft.interpret = prev


@pytest.fixture
def planar_always():
    tsf.use_planar_fft("always")
    try:
        yield
    finally:
        tsf.use_planar_fft("auto")


@pytest.fixture
def mxu_always():
    """The JAX package's 2-D transforms through its Pallas kernels on the
    CPU (``use_mxu_fft("always")``, as ``tests/ops/test_mxufft.py``)."""
    prev = jsf._MXU_MODE
    jsf.use_mxu_fft("always")
    try:
        yield
    finally:
        jsf.use_mxu_fft(prev)


# (lead, N0, N1): the JAX test shapes, lead dimensions, N1 = 2 and 2048
SHAPES = [((2,), 128, 128), ((2,), 256, 64), ((2,), 512, 512),
          ((2,), 128, 16), ((2,), 256, 30), ((2, 3), 128, 32),
          ((), 128, 2), ((1,), 128, 2048)]


def _data(shape, seed=12345):
    lead, n0, n1 = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(lead + (n0, n1)).astype(np.float32)
    spec = lead + (n0, n1 // 2 + 1)
    zr = rng.standard_normal(spec).astype(np.float32)
    zi = rng.standard_normal(spec).astype(np.float32)
    return x, zr, zi


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_forward_matches_jax_kernel_and_numpy(interpret, shape):
    x, _, _ = _data(shape)
    ref = np.fft.rfftn(x.astype(np.float64), axes=(-2, -1))
    yr, yi = tfp.rfft2_planar(torch.tensor(x), precision="highest")
    got = yr.numpy() + 1j * yi.numpy()
    jr, ji = pallas_fft.rfft2_planar(jnp.asarray(x), precision="highest")
    jgot = np.asarray(jr) + 1j * np.asarray(ji)
    scale = np.abs(ref).max()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() < 1e-6 * scale
    assert np.abs(got - jgot).max() < 2e-6 * scale


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_inverse_matches_jax_kernel_and_numpy(interpret, shape):
    """A random half-spectrum, not Hermitian: the imaginary parts of the
    first and last columns must be dropped after the axis-0 transform,
    as numpy drops them."""
    x, zr, zi = _data(shape)
    n1 = shape[2]
    ref = np.fft.irfftn(zr.astype(np.float64) + 1j * zi, s=shape[1:],
                        axes=(-2, -1))
    got = tfp.irfft2_planar(torch.tensor(zr), torch.tensor(zi), n1,
                            precision="highest").numpy()
    jgot = np.asarray(pallas_fft.irfft2_planar(
        jnp.asarray(zr), jnp.asarray(zi), n1, precision="highest"))
    assert got.shape == x.shape
    assert np.abs(got - ref).max() < 3e-5
    assert np.abs(got - jgot).max() < 6e-5
    # the round trip of a real signal
    yr, yi = tfp.rfft2_planar(torch.tensor(x))
    assert np.abs(tfp.irfft2_planar(yr, yi, n1).numpy() - x).max() < 3e-5


def _spectrum_case(zr, zi, case):
    """The port's input to ``irfftn`` for ``case`` and the numpy array it
    stands for: a contiguous complex64 spectrum, a view with the
    conjugate bit set, a non-contiguous slice of a wider array, or a real
    spectrum."""
    spec = (zr + 1j * zi).astype(np.complex64)
    if case == "complex":
        return torch.tensor(spec), spec
    if case == "conj":
        t = torch.tensor(spec).conj()
        assert t.is_conj()
        return t, np.conj(spec)
    if case == "strided":
        wide = np.zeros(spec.shape[:-1] + (spec.shape[-1] + 3,),
                        np.complex64)
        wide[..., 1:-2] = spec
        t = torch.tensor(wide)[..., 1:-2]
        assert not t.is_contiguous()
        return t, spec
    return torch.tensor(zr), zr


@pytest.mark.parametrize("case", ["complex", "conj", "strided", "real"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_irfftn_routes_match_jax_kernel_and_numpy(interpret, planar_always,
                                                  mxu_always, monkeypatch,
                                                  shape, case):
    """``ops.fft.irfftn`` sends a complex64 spectrum, whatever its view,
    to ``irfft2_spectrum`` and a real one to ``irfft2_planar``; both
    against the JAX package's ``irfftn`` on its Pallas kernel and float64
    numpy, with the tolerances of
    :func:`test_inverse_matches_jax_kernel_and_numpy`."""
    _, zr, zi = _data(shape)
    n0, n1 = shape[1:]
    a, spec = _spectrum_case(zr, zi, case)
    calls = {"irfft2_spectrum": 0, "irfft2_planar": 0}
    for name in calls:
        def counted(*args, _fn=getattr(tfp, name), _name=name, **kw):
            calls[_name] += 1
            return _fn(*args, **kw)
        monkeypatch.setattr(tfp, name, counted)
    got = tsf.irfftn(a, s=(n0, n1), axes=(-2, -1)).numpy()
    want = "irfft2_planar" if case == "real" else "irfft2_spectrum"
    assert calls == {k: int(k == want) for k in calls}
    ref = np.fft.irfftn(spec.astype(np.complex128), s=(n0, n1),
                        axes=(-2, -1))
    jgot = np.asarray(jsf.irfftn(jnp.asarray(spec), s=(n0, n1),
                                 axes=(-2, -1)))
    assert got.shape == ref.shape == jgot.shape
    assert np.abs(got - ref).max() < 3e-5
    assert np.abs(got - jgot).max() < 6e-5


@pytest.mark.parametrize("case", ["complex", "conj", "strided"])
def test_spectrum_entry_equals_planar_call(case):
    """The complex64 entry gives the planar call on ``.real``/``.imag``
    bit for bit (on the CPU both are the plain version), a conj-bit view
    the conjugated spectrum's result, and an odd N1 (30) its direct
    sums; the dispatch hands a contiguous spectrum over as it is, with no
    copy before the entry."""
    _, zr, zi = _data(((2,), 128, 30))
    a, spec = _spectrum_case(zr, zi, case)
    got = tfp.irfft2_spectrum(a, 30)
    assert torch.equal(got, tfp.irfft2_planar(a.real, a.imag, 30))
    ref = np.fft.irfftn(spec.astype(np.complex128), s=(128, 30),
                        axes=(-2, -1))
    assert np.abs(got.numpy() - ref).max() < 3e-5
    seen = []

    def entry(y, n1, precision="high"):
        seen.append(y)
        return got
    tsf.use_planar_fft("always")
    try:
        orig, tfp.irfft2_spectrum = tfp.irfft2_spectrum, entry
        assert tsf.irfftn(a, s=(128, 30)) is got
    finally:
        tfp.irfft2_spectrum = orig
        tsf.use_planar_fft("auto")
    assert len(seen) == 1 and seen[0] is a


def test_spectrum_entry_rejects():
    y = torch.zeros(2, 128, 17, dtype=torch.complex64)
    with pytest.raises(TypeError):
        tfp.irfft2_spectrum(y.real, 32)
    with pytest.raises(TypeError):
        tfp.irfft2_spectrum(y.to(torch.complex128), 32)
    with pytest.raises(ValueError, match="does not match"):
        tfp.irfft2_spectrum(y, 34)
    with pytest.raises(ValueError, match="unsupported"):
        tfp.irfft2_spectrum(torch.zeros(2, 96, 17, dtype=torch.complex64),
                            32)
    tfp.reset_launches()
    assert tfp.irfft2_spectrum(y, 32).shape == (2, 128, 32)
    assert tfp.LAUNCHES == {"rfft2_planar": 0, "irfft2_planar": 0}


def test_plain_versions_take_both_precisions_and_reject():
    x = torch.randn(2, 128, 32)
    a = tfp.rfft2_planar(x, precision="high")
    b = tfp.rfft2_planar(x, precision="highest")
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    with pytest.raises(ValueError, match="precision"):
        tfp.rfft2_planar(x, precision="bogus")
    with pytest.raises(ValueError, match="unsupported"):
        tfp.rfft2_planar(torch.randn(2, 96, 32))
    with pytest.raises(ValueError, match="does not match"):
        tfp.irfft2_planar(*a, 34)
    with pytest.raises(TypeError):
        tfp.rfft2_planar(x.double())
    tfp.reset_launches()
    tfp.irfft2_planar(*a, 32)
    assert tfp.LAUNCHES == {"rfft2_planar": 0, "irfft2_planar": 0}


@pytest.mark.parametrize("n0,n1", list(itertools.product(
    (64, 96, 128, 256, 384, 512, 1024), (1, 2, 17, 30, 512, 2048, 2050))))
def test_supported_matches_jax(n0, n1):
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.float64, jnp.float64)):
        assert tfp.supported(n0, n1, dt) == \
            pallas_fft.supported(n0, n1, jdt)


def _jax_dispatch(ndim, s, axes, dtype, prec):
    prev = mxufft.get_precision()
    mxufft.set_precision(prec)
    try:
        return mxufft._pallas_2d_ok(ndim, s, axes, dtype)
    finally:
        mxufft.set_precision(prev)


@pytest.mark.parametrize("prec", ["highest", "high", "default"])
@pytest.mark.parametrize("dtype", ["float32", "complex64", "float64",
                                   "complex128"])
def test_dispatch_rule_matches_jax(interpret, planar_always, prec, dtype):
    """The port's ``_planar_ok`` against ``mxufft._pallas_2d_ok`` over a
    grid of ranks, sizes and transformed axes."""
    grid = [(3, (128, 64), (1, 2)), (3, (128, 64), (0, 1)),
            (4, (256, 30), (2, 3)), (2, (512, 2048), (0, 1)),
            (3, (96, 64), (1, 2)), (3, (128, 17), (1, 2)),
            (3, (128, 64, 8), (0, 1, 2)), (2, (128,), (1,)),
            (5, (128, 128), (3, 4))]
    prev = tsf.get_precision()
    tsf.set_precision(prec)
    try:
        for ndim, s, axes in grid:
            a = torch.zeros((1,) * ndim, dtype=getattr(torch, dtype))
            assert tsf._planar_ok(a, s, axes) == _jax_dispatch(
                ndim, s, axes, getattr(jnp, dtype), prec), (ndim, s, axes)
    finally:
        tsf.set_precision(prev)


def test_dispatch_modes_and_precision():
    a = torch.zeros(2, 128, 64)
    assert tsf.get_precision() == "highest"
    assert not tsf._planar_ok(a, (128, 64), (1, 2))        # auto: CPU
    tsf.use_planar_fft("always")
    try:
        assert tsf._planar_ok(a, (128, 64), (1, 2))
        tsf.set_precision("high")
        assert not tsf._planar_ok(a, (128, 64), (1, 2))
    finally:
        tsf.set_precision("highest")
        tsf.use_planar_fft("auto")
    tsf.use_planar_fft("never")
    tsf.use_planar_fft("auto")
    for bad in ("sometimes", True):
        with pytest.raises(ValueError):
            tsf.use_planar_fft(bad)
    with pytest.raises(ValueError):
        tsf.set_precision("bogus")


@pytest.mark.parametrize("case", ["pad", "crop", "lead", "odd", "complex"])
def test_rfftn_irfftn_dispatch_matches_numpy(planar_always, case):
    """The dispatched transforms, with ``s`` padding or cropping the
    input first, against numpy; ``odd`` falls back to ``torch.fft``."""
    rng = np.random.default_rng(3)
    shp, s = {"pad": ((2, 100, 60), (128, 64)),
              "crop": ((2, 130, 70), (128, 64)),
              "lead": ((2, 3, 128, 30), (128, 30)),
              "odd": ((2, 128, 31), (128, 31)),
              "complex": ((2, 128, 64), (128, 64))}[case]
    x = rng.standard_normal(shp).astype(np.float32)
    ref = np.fft.rfftn(x.astype(np.float64), s=s, axes=(-2, -1))
    got = tsf.rfftn(torch.tensor(x), s=s, axes=(-2, -1)).numpy()
    assert np.abs(got - ref).max() < 1e-6 * np.abs(ref).max()
    spec = got if case != "complex" else (
        rng.standard_normal(got.shape) + 1j * rng.standard_normal(
            got.shape)).astype(np.complex64)
    xr = np.fft.irfftn(spec.astype(np.complex128), s=s, axes=(-2, -1))
    back = tsf.irfftn(torch.tensor(spec), s=s, axes=(-2, -1)).numpy()
    assert np.abs(back - xr).max() < 3e-5 * max(1.0, np.abs(xr).max())


def test_fftconv_matches_numpy(planar_always):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((128, 64)).astype(np.float32)
    b = rng.standard_normal((5, 5)).astype(np.float32)
    ref = np.fft.irfft2(np.fft.rfft2(a) * np.fft.rfft2(b, s=a.shape),
                        s=a.shape)
    got = tsf.fftconv(torch.tensor(a), torch.tensor(b)).numpy()
    assert np.abs(got - ref).max() < 1e-4
    rolled = tsf.fftconv(torch.tensor(a), torch.tensor(b),
                         origin=(2, 2)).numpy()
    assert np.abs(rolled - np.roll(ref, (-2, -2), axis=(0, 1))).max() < 1e-4
