"""Tests of the port that need a CUDA card; each skips without one.

They import no JAX, so they also run where JAX is not installed, with
the suite's conftest (which imports JAX) left out:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import dataclasses

import numpy as np
import pytest
import torch

from sporco_tpu_torch.models import pgm as tpgm
from sporco_tpu_torch.models.cbpdn import (ConvBPDN, ConvBPDNGradReg,
                                           ConvElasticNet)
from sporco_tpu_torch.ops import csc_iter as tci
from sporco_tpu_torch.ops import csc_tail as tct
from sporco_tpu_torch.ops import fft2_planar as tfp
from sporco_tpu_torch.ops import pgm_iter as tpi
from tests._torch_svd import clusters  # noqa: F401

pytestmark = pytest.mark.cuda

torch.set_num_threads(2)

RLX, US, SCALE = 1.8, 0.7, 0.9


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _inputs(pos, C, T, vectors, dev, seed=0):
    g = torch.Generator().manual_seed(seed)
    G2 = 0.1 * torch.randn(pos, T, generator=g)
    Wa = 0.1 * torch.randn(T, C, generator=g)
    Wf = 0.1 * torch.randn(C, T, generator=g)
    Y = torch.randn(pos, C, generator=g) * (torch.rand(pos, C, generator=g)
                                           < 0.3)
    U = 0.1 * torch.randn(pos, C, generator=g)
    if vectors:
        thr = 0.01 + 0.09 * torch.rand(C, generator=g)
        wl1 = 0.5 + torch.rand(C, generator=g)
    else:
        thr, wl1 = 0.05, 1.0

    def to(t):
        return t.to(dev) if isinstance(t, torch.Tensor) else t
    return [to(t) for t in (G2, Y, U, Wa, Wf, thr, wl1)]


def _run(fn, args, nonneg, emit_px=True):
    G2, Y, U, Wa, Wf, thr, wl1 = args
    out = fn(G2, Y.clone(), U.clone(), Wa, Wf, thr, wl1, RLX, US, SCALE,
             nonneg=nonneg, emit_px=emit_px, wf_split=tci.split_weight(Wf))
    return [None if o is None else o.cpu() for o in out]


# (pos, C, T): the small slice geometry, then ragged edges of every tile
# size, a single element, the headline problem's packed geometry, and the
# colour geometries: a colour dictionary's 768 taps, and three image
# channels folded into 12288 rows
GEOMS = [(64, 256, 256), (100, 200, 60), (129, 131, 7), (1, 3, 1),
         (4096, 4096, 256), (4096, 4096, 768), (12288, 4096, 256)]


@pytest.mark.parametrize("geom", GEOMS, ids=str)
@pytest.mark.parametrize("vectors", [False, True])
@pytest.mark.parametrize("nonneg", [False, True])
def test_kernel_matches_plain(dev, geom, vectors, nonneg):
    """Both fp32 on the card, differing in summation order only: 1e-5 of
    each output's largest magnitude."""
    args = _inputs(*geom, vectors, dev)
    got = _run(tci.csc_iter, args, nonneg)
    ref = _run(tci.csc_iter_plain, args, nonneg)
    for name, a, b in zip(("PX", "Yn", "Un", "R1", "R2", "sums"), got,
                          ref):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-5 * scale, name


def test_unaligned_buffers_take_scalar_path(dev):
    """Contiguous views that start off a 16-byte boundary: the kernel
    must not use 16-byte accesses on them."""
    pos, C, T = 64, 256, 256
    G2, Y, U, Wa, Wf, thr, wl1 = _inputs(pos, C, T, False, dev)
    ref = _run(tci.csc_iter_plain, (G2, Y, U, Wa, Wf, thr, wl1), False)
    Yb = torch.empty(pos * C + 1, device=dev)
    Ub = torch.empty(pos * C + 1, device=dev)
    Yo, Uo = Yb[1:].view(pos, C), Ub[1:].view(pos, C)
    Yo.copy_(Y)
    Uo.copy_(U)
    out = tci.csc_iter(G2, Yo, Uo, Wa, Wf, thr, wl1, RLX, US, SCALE,
                       wf_split=tci.split_weight(Wf))
    for a, b in zip(out[1:], ref[1:]):
        assert float((a.cpu() - b).abs().max()) <= \
            1e-5 * float(b.abs().max())


def test_kernel_is_repeatable(dev):
    """Two launches from the same inputs give the same bits, sums
    included: no float atomics, fixed reduction orders."""
    G2, Y, U, Wa, Wf, thr, wl1 = _inputs(4096, 4096, 256, True, dev)
    wf3 = tci.split_weight(Wf)
    a, b = [tci.csc_iter(G2, Y.clone(), U.clone(), Wa, Wf, thr, wl1, RLX,
                         US, SCALE, wf_split=wf3) for _ in range(2)]
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_split_weight_on_card_matches_cpu(dev):
    """The card's split of a weight is the CPU's bit for bit, and its
    three terms add up to the weight in fp32."""
    _, _, _, Wa, Wf, _, _ = _inputs(100, 200, 60, False, dev)
    for W in (Wa, Wf):
        got = tci.split_weight(W)
        ref = tci.split_weight(W.cpu())
        assert torch.equal(got.cpu().view(torch.int16),
                           ref.view(torch.int16))
        K, N = W.shape
        back = (got[0].float() + got[1].float()) + got[2].float()
        assert torch.equal(back[:K, :N], W)


def test_counts_launches_and_updates_in_place(dev):
    args = _inputs(64, 256, 256, False, dev)
    G2, Y, U, Wa, Wf, thr, wl1 = args
    tci.reset_launches()
    _, yn, un, _, _, _ = tci.csc_iter(G2, Y, U, Wa, Wf, thr, wl1, RLX, US,
                                      SCALE, emit_px=False,
                                      wf_split=tci.split_weight(Wf))
    assert tci.LAUNCHES["csc_iter"] == 1
    assert yn is Y and un is U


def test_rejects_what_it_does_not_take(dev):
    G2, Y, U, Wa, Wf, thr, wl1 = _inputs(64, 256, 256, False, dev)
    kw = {"wf_split": tci.split_weight(Wf)}
    with pytest.raises(ValueError):
        tci.csc_iter(G2, Y, U, Wa.cpu(), Wf, thr, wl1, RLX, US, SCALE, **kw)
    with pytest.raises(TypeError):
        tci.csc_iter(G2.double(), Y, U, Wa, Wf, thr, wl1, RLX, US, SCALE,
                     **kw)
    with pytest.raises(ValueError):
        tci.csc_iter(G2, Y, Y, Wa, Wf, thr, wl1, RLX, US, SCALE, **kw)
    with pytest.raises(ValueError):
        tci.csc_iter(G2, Y.t(), U, Wa, Wf, thr, wl1, RLX, US, SCALE, **kw)
    with pytest.raises(ValueError):     # no split of Wf
        tci.csc_iter(G2, Y, U, Wa, Wf, thr, wl1, RLX, US, SCALE)
    with pytest.raises(ValueError):     # the split of Wa, not of Wf
        tci.csc_iter(G2, Y, U, Wa, Wf, thr, wl1, RLX, US, SCALE,
                     wf_split=tci.split_weight(Wa[:, :128]))
    with pytest.raises(TypeError):
        tci.csc_iter(G2, Y, U, Wa, Wf, thr, wl1, RLX, US, SCALE,
                     wf_split=tci.split_weight(Wf).float())


def test_solve_on_card_matches_cpu(dev):
    """The slice at 64x64 with 4 filters, 25 iterations: card (kernel)
    against CPU (plain version), with the tolerances of the CPU test
    against the JAX package."""
    rng = np.random.default_rng(0)
    D = rng.standard_normal((8, 8, 4)).astype(np.float32)
    D /= np.sqrt((D ** 2).sum(axis=(0, 1), keepdims=True))
    S = rng.standard_normal((64, 64)).astype(np.float32)
    opt = ConvBPDN.options(max_iter=25, rel_stop_tol=0.0)
    tci.reset_launches()
    a = ConvBPDN(D, S, 0.05, opt=opt)
    Ya = a.solve().cpu().numpy()
    assert a.device.type == "cuda"
    assert tci.LAUNCHES["csc_iter"] == 25
    b = ConvBPDN(D, S, 0.05, opt=opt, device="cpu")
    Yb = b.solve().numpy()
    assert np.abs(Ya - Yb).max() < 2e-4 * np.abs(Yb).max()
    ia, ib = a.getitstat(), b.getitstat()
    for name in ("ObjFun", "DFid", "RegL1", "Rho"):
        np.testing.assert_allclose(getattr(ia, name), getattr(ib, name),
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(ia.PrimalRsdl, ib.PrimalRsdl, rtol=1e-3,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# pgm_iter

RL, BETA = 0.05, 0.7


def _pgm_inputs(pos, C, T, vectors, dev, seed=1):
    G2, Y, Xprv, Wa, Wf, thr, wl1 = _inputs(pos, C, T, vectors, dev, seed)
    return G2, Y, 10.0 * Xprv, Wa, Wf, thr, wl1


def _pgm_run(fn, args, nonneg):
    G2, Y, Xprv, Wa, Wf, thr, wl1 = args
    out = fn(G2, Y.clone(), Xprv.clone(), Wa, Wf, thr, wl1, RL, BETA,
             nonneg=nonneg, wf_split=tci.split_weight(Wf))
    return [o.cpu() for o in out]


@pytest.mark.parametrize("geom", GEOMS, ids=str)
@pytest.mark.parametrize("vectors", [False, True])
@pytest.mark.parametrize("nonneg", [False, True])
def test_pgm_kernel_matches_plain(dev, geom, vectors, nonneg):
    """Both fp32 on the card, differing in summation order only: 1e-5 of
    each output's largest magnitude."""
    args = _pgm_inputs(*geom, vectors, dev)
    got = _pgm_run(tpi.pgm_iter, args, nonneg)
    ref = _pgm_run(tpi.pgm_iter_plain, args, nonneg)
    for name, a, b in zip(("X", "Yn", "R1", "RX", "sums"), got, ref):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-5 * scale, name


def test_pgm_unaligned_buffers_take_scalar_path(dev):
    pos, C, T = 64, 256, 256
    G2, Y, Xprv, Wa, Wf, thr, wl1 = _pgm_inputs(pos, C, T, True, dev)
    ref = _pgm_run(tpi.pgm_iter_plain, (G2, Y, Xprv, Wa, Wf, thr, wl1),
                   False)
    Yb = torch.empty(pos * C + 1, device=dev)
    Xb = torch.empty(pos * C + 1, device=dev)
    Yo, Xo = Yb[1:].view(pos, C), Xb[1:].view(pos, C)
    Yo.copy_(Y)
    Xo.copy_(Xprv)
    out = tpi.pgm_iter(G2, Yo, Xo, Wa, Wf, thr, wl1, RL, BETA,
                       wf_split=tci.split_weight(Wf))
    for a, b in zip(out, ref):
        assert float((a.cpu() - b).abs().max()) <= \
            1e-5 * float(b.abs().max())


def test_pgm_kernel_is_repeatable(dev):
    G2, Y, Xprv, Wa, Wf, thr, wl1 = _pgm_inputs(4096, 4096, 256, True, dev)
    wf3 = tci.split_weight(Wf)
    a, b = [tpi.pgm_iter(G2, Y.clone(), Xprv.clone(), Wa, Wf, thr, wl1, RL,
                         BETA, wf_split=wf3) for _ in range(2)]
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_pgm_counts_launches_and_updates_in_place(dev):
    G2, Y, Xprv, Wa, Wf, thr, wl1 = _pgm_inputs(64, 256, 256, False, dev)
    tpi.reset_launches()
    wf3 = tci.split_weight(Wf)
    x, yn, _, _, _ = tpi.pgm_iter(G2, Y, Xprv, Wa, Wf, thr, wl1, RL, BETA,
                                  wf_split=wf3)
    assert tpi.LAUNCHES["pgm_iter"] == 1
    assert x is Xprv and yn is Y
    tpi.pgm_iter_plain(G2, Y, Xprv, Wa, Wf, thr, wl1, RL, BETA)
    assert tpi.LAUNCHES["pgm_iter"] == 1
    with pytest.raises(ValueError):
        tpi.pgm_iter(G2, Y, Y, Wa, Wf, thr, wl1, RL, BETA, wf_split=wf3)
    with pytest.raises(ValueError):     # no split of Wf
        tpi.pgm_iter(G2, Y, Xprv, Wa, Wf, thr, wl1, RL, BETA)
    with pytest.raises(TypeError):
        tpi.pgm_iter(G2.double(), Y, Xprv, Wa, Wf, thr, wl1, RL, BETA,
                     wf_split=wf3)
    assert tpi.LAUNCHES["pgm_iter"] == 1


@pytest.mark.parametrize("masked", [False, True])
def test_pgm_solve_on_card_matches_cpu(dev, masked):
    """The FISTA slice at 64x64 with 4 filters, 25 iterations: card
    (kernel) against CPU (plain version), with the tolerances of the CPU
    test against the JAX package."""
    rng = np.random.default_rng(0)
    D = rng.standard_normal((8, 8, 4)).astype(np.float32)
    D /= np.sqrt((D ** 2).sum(axis=(0, 1), keepdims=True))
    S = rng.standard_normal((64, 64)).astype(np.float32)
    W = (rng.random((64, 64)) >= 0.3).astype(np.float32)
    cls = tpgm.ConvBPDNMask if masked else tpgm.ConvBPDN
    opt = cls.options(max_iter=25, rel_stop_tol=0.0, L=50.0)
    tpi.reset_launches()
    a = cls(D, S, 0.05, opt=opt, W=W)
    Xa = a.solve().cpu().numpy()
    assert a.device.type == "cuda"
    assert tpi.LAUNCHES["pgm_iter"] == 25
    b = cls(D, S, 0.05, opt=opt, W=W, device="cpu")
    Xb = b.solve().numpy()
    assert np.abs(Xa - Xb).max() < 2e-4 * np.abs(Xb).max()
    ia, ib = a.getitstat(), b.getitstat()
    for name in ("ObjFun", "DFid", "RegL1"):
        np.testing.assert_allclose(getattr(ia, name), getattr(ib, name),
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(ia.Rsdl, ib.Rsdl, rtol=1e-3, atol=1e-6)


# ---------------------------------------------------------------------------
# rfft2_planar / irfft2_planar

# (lead, N0, N1): the JAX test shapes, lead dimensions, every row-pass
# branch (power-of-two N1 by FFT, other even N1 by direct DFT), every
# template case of the register-FFT kernels (the row pass for each
# power-of-two N1 from 2 to 2048, the column pass for each N0 with a
# power-of-two N1 of at least 8), an odd number of planes, one plane, and
# the headline x-step (64 planes of 512 x 512)
FFT_SHAPES = [((2,), 128, 128), ((2,), 256, 64), ((2,), 512, 512),
              ((2,), 128, 16), ((2,), 256, 30), ((3,), 128, 30),
              ((2, 3), 128, 32), ((1,), 512, 2048), ((2,), 128, 2),
              ((1,), 256, 2046), ((), 512, 512), ((64,), 512, 512),
              ((2,), 128, 4), ((1,), 256, 8), ((3,), 256, 256),
              ((1,), 128, 1024)]


def _fft_refs(shape, seed):
    """Unit-normal data, its float64 numpy spectrum, a random
    (non-Hermitian) half-spectrum and its float64 numpy inverse."""
    lead, n0, n1 = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(lead + (n0, n1)).astype(np.float32)
    ref = np.fft.rfftn(x.astype(np.float64), axes=(-2, -1))
    zr = rng.standard_normal(ref.shape).astype(np.float32)
    zi = rng.standard_normal(ref.shape).astype(np.float32)
    xinv = np.fft.irfftn(zr.astype(np.float64) + 1j * zi, s=(n0, n1),
                         axes=(-2, -1))
    return x, ref, zr, zi, xinv


@pytest.mark.parametrize("shape", FFT_SHAPES, ids=str)
def test_fft_kernels_match_numpy_and_plain(dev, shape):
    """The JAX package's tolerances (tests/ops/test_pallas_fft.py):
    forward within 1e-6 of the largest magnitude of the float64 numpy
    spectrum, inverse within 3e-5 absolute on unit-normal data; the
    kernels and the plain versions, both fp32, within twice that of each
    other.  The inverse gets a non-Hermitian spectrum."""
    x, ref, zr, zi, xinv = _fft_refs(shape, 5)
    n1 = shape[2]
    xt = torch.tensor(x, device=dev)
    yr, yi = tfp.rfft2_planar(xt)
    pr, pi = tfp.rfft2_planar_plain(xt)
    got = yr.cpu().numpy() + 1j * yi.cpu().numpy()
    plain = pr.cpu().numpy() + 1j * pi.cpu().numpy()
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() < 1e-6 * scale
    assert np.abs(got - plain).max() < 2e-6 * scale
    zrt, zit = torch.tensor(zr, device=dev), torch.tensor(zi, device=dev)
    xb = tfp.irfft2_planar(zrt, zit, n1).cpu().numpy()
    xp = tfp.irfft2_planar_plain(zrt, zit, n1).cpu().numpy()
    assert xb.shape == x.shape
    assert np.abs(xb - xinv).max() < 3e-5
    assert np.abs(xb - xp).max() < 6e-5
    # the inputs are left as they were
    assert torch.equal(zrt.cpu(), torch.tensor(zr))
    # the round trip of a real signal
    xr = tfp.irfft2_planar(yr, yi, n1).cpu().numpy()
    assert np.abs(xr - x).max() < 3e-5


def test_fft_kernels_take_unaligned_and_strided_input(dev):
    """Views that start one float into their buffer (the forward row pass
    then takes its scalar-load path: the input is not 8-byte aligned), and
    a transposed (non-contiguous) input, which the wrapper makes
    contiguous."""
    x, ref, zr, zi, xinv = _fft_refs(((2,), 256, 64), 6)
    xb = torch.empty(x.size + 1, device=dev)
    xo = xb[1:].view(x.shape)
    xo.copy_(torch.tensor(x))
    assert xo.is_contiguous() and xo.data_ptr() % 8 == 4
    yr, yi = tfp.rfft2_planar(xo)
    got = yr.cpu().numpy() + 1j * yi.cpu().numpy()
    assert np.abs(got - ref).max() < 1e-6 * np.abs(ref).max()
    zb = torch.empty(2, zr.size + 1, device=dev)
    zro = zb[0, 1:].view(zr.shape)
    zio = zb[1, 1:].view(zi.shape)
    zro.copy_(torch.tensor(zr))
    zio.copy_(torch.tensor(zi))
    assert np.abs(tfp.irfft2_planar(zro, zio, 64).cpu().numpy()
                  - xinv).max() < 3e-5
    xt = torch.tensor(np.ascontiguousarray(np.swapaxes(x, -1, -2)),
                      device=dev).transpose(-1, -2)
    assert not xt.is_contiguous()
    yr2, yi2 = tfp.rfft2_planar(xt)
    assert torch.equal(yr2, yr) and torch.equal(yi2, yi)


def test_fft_kernels_count_launches_and_reject(dev):
    x = torch.randn(2, 128, 32, device=dev)
    tfp.reset_launches()
    yr, yi = tfp.rfft2_planar(x)
    tfp.irfft2_planar(yr, yi, 32)
    tfp.rfft2_planar_plain(x)
    tfp.irfft2_planar_plain(yr, yi, 32)
    assert tfp.LAUNCHES == {"rfft2_planar": 1, "irfft2_planar": 1}
    with pytest.raises(ValueError):
        tfp.rfft2_planar(torch.randn(2, 96, 32, device=dev))
    with pytest.raises(ValueError):
        tfp.rfft2_planar(torch.randn(2, 128, 31, device=dev))
    with pytest.raises(TypeError):
        tfp.rfft2_planar(x.double())
    with pytest.raises(ValueError):
        tfp.irfft2_planar(yr, yi, 34)
    with pytest.raises(ValueError):
        tfp.irfft2_planar(yr, yi.cpu(), 32)
    assert tfp.LAUNCHES == {"rfft2_planar": 1, "irfft2_planar": 1}


@pytest.mark.parametrize("case,n1", [("complex", 64), ("conj", 64),
                                     ("strided", 64), ("complex", 30),
                                     ("conj", 512)])
def test_spectrum_entry_equals_planar_call(dev, case, n1):
    """The complex64 entry reads the spectrum where it lies and equals
    the planar call on its ``.real``/``.imag`` bit for bit, one
    ``irfft2_planar`` launch per call: a contiguous spectrum, a view with
    the conjugate bit (the conjugated spectrum's result, as numpy), a
    non-contiguous slice and an odd N1 (direct sums)."""
    _, _, zr, zi, _ = _fft_refs(((2,), 256, n1), 7)
    spec = (zr + 1j * zi).astype(np.complex64)
    y = torch.tensor(spec, device=dev)
    if case == "conj":
        y, spec = y.conj(), np.conj(spec)
        assert y.is_conj()
    elif case == "strided":
        wide = torch.zeros(y.shape[:-1] + (y.shape[-1] + 3,),
                           dtype=y.dtype, device=dev)
        wide[..., 1:-2] = y
        y = wide[..., 1:-2]
        assert not y.is_contiguous()
    tfp.reset_launches()
    got = tfp.irfft2_spectrum(y, n1)
    assert tfp.LAUNCHES == {"rfft2_planar": 0, "irfft2_planar": 1}
    assert torch.equal(got, tfp.irfft2_planar(y.real, y.imag, n1))
    ref = np.fft.irfftn(spec.astype(np.complex128), s=(256, n1),
                        axes=(-2, -1))
    assert np.abs(got.cpu().numpy() - ref).max() < 3e-5


def test_irfftn_reads_complex_spectrum_without_copy(dev):
    """``ops.fft.irfftn`` on a contiguous complex64 spectrum runs the
    inverse's own two kernels and nothing else on the card: no copy or
    elementwise kernel splits the spectrum first."""
    from torch.profiler import ProfilerActivity, profile
    from sporco_tpu_torch.ops import fft as tsf
    g = torch.Generator(device=dev).manual_seed(8)
    spec = torch.randn((4, 256, 257), generator=g, dtype=torch.complex64,
                       device=dev)
    tsf.irfftn(spec, s=(256, 512))             # build, twiddle tables
    torch.cuda.synchronize()
    tfp.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        x = tsf.irfftn(spec, s=(256, 512))
        torch.cuda.synchronize()
    assert tfp.LAUNCHES == {"rfft2_planar": 0, "irfft2_planar": 1}
    names = [e.key for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert any("fft_cols_pow2" in n for n in names), names
    assert any("fft_rows_c2r_pow2" in n for n in names), names
    assert all("fft_cols_pow2" in n or "fft_rows_c2r_pow2" in n
               for n in names), names
    ref = torch.fft.irfft2(spec.cpu().to(torch.complex128), s=(256, 512))
    assert float((x.cpu().double() - ref).abs().max()) < 3e-5


# ---------------------------------------------------------------------------
# The generic FFT paths

def _generic_problem(N=128, seed=0):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((8, 8, 4)).astype(np.float32)
    D /= np.sqrt((D ** 2).sum(axis=(0, 1), keepdims=True))
    S = rng.standard_normal((N, N)).astype(np.float32)
    return D, S, (rng.random((N, N)) >= 0.3).astype(np.float32)


@pytest.fixture
def planar_on_cpu():
    """The CPU side through the FFT kernels' plain versions."""
    from sporco_tpu_torch.ops import fft as tsf
    tsf.use_planar_fft("always")
    try:
        yield
    finally:
        tsf.use_planar_fft("auto")


def test_generic_solve_on_card_matches_cpu(dev, planar_on_cpu):
    """The generic ADMM ConvBPDN at 128x128 with 4 filters, 25
    iterations: card (FFT kernels) against CPU (plain versions), with the
    tolerances of the CPU test against the JAX package; one forward
    transform per iteration and two in the setup, one inverse per
    iteration, and no csc_iter."""
    D, S, _ = _generic_problem()
    opt = ConvBPDN.options(max_iter=25, rel_stop_tol=0.0)
    tfp.reset_launches()
    tci.reset_launches()
    a = ConvBPDN(D, S, 0.05, opt=opt, fused=False)
    Ya = a.solve().cpu().numpy()
    assert tfp.LAUNCHES == {"rfft2_planar": 27, "irfft2_planar": 25}
    assert tci.LAUNCHES["csc_iter"] == 0
    b = ConvBPDN(D, S, 0.05, opt=opt, fused=False, device="cpu")
    Yb = b.solve().numpy()
    assert np.abs(Ya - Yb).max() < 2e-4 * np.abs(Yb).max()
    ia, ib = a.getitstat(), b.getitstat()
    for name in ("ObjFun", "DFid", "RegL1", "Rho"):
        np.testing.assert_allclose(getattr(ia, name), getattr(ib, name),
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(ia.PrimalRsdl, ib.PrimalRsdl, rtol=1e-3,
                               atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_generic_pgm_solve_on_card_matches_cpu(dev, planar_on_cpu, masked):
    """The generic FFT FISTA problem at 128x128, 25 iterations: card
    against CPU; per iteration two forward and one inverse transform
    (three of each masked), and two forward in the setup."""
    D, S, W = _generic_problem(seed=1)
    cls = tpgm.ConvBPDNMask if masked else tpgm.ConvBPDN
    opt = cls.options(max_iter=25, rel_stop_tol=0.0, L=50.0)
    tfp.reset_launches()
    a = cls(D, S, 0.05, opt=opt, W=W, fused=False)
    Xa = a.solve().cpu().numpy()
    per = (3, 3) if masked else (2, 1)
    assert tfp.LAUNCHES == {"rfft2_planar": 25 * per[0] + 2,
                            "irfft2_planar": 25 * per[1]}
    b = cls(D, S, 0.05, opt=opt, W=W, fused=False, device="cpu")
    Xb = b.solve().numpy()
    assert np.abs(Xa - Xb).max() < 2e-4 * np.abs(Xb).max()
    ia, ib = a.getitstat(), b.getitstat()
    for name in ("ObjFun", "DFid", "RegL1"):
        np.testing.assert_allclose(getattr(ia, name), getattr(ib, name),
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(ia.Rsdl, ib.Rsdl, rtol=1e-3, atol=1e-6)


def test_fused_glue_runs_fft_kernels_at_highest(dev):
    """At the default precision the fused ADMM driver's spectral glue
    (one plane) runs the FFT kernels; at "high" it stays on torch.fft,
    as the JAX package's at mxufft "high"."""
    from sporco_tpu_torch.ops import fft as tsf
    D, S, _ = _generic_problem()
    opt = ConvBPDN.options(max_iter=5, rel_stop_tol=0.0)
    tfp.reset_launches()
    ConvBPDN(D, S, 0.05, opt=opt).solve()
    # setup (D, S), per iteration one pair, the final x-step's pair
    assert tfp.LAUNCHES == {"rfft2_planar": 8, "irfft2_planar": 6}
    tsf.set_precision("high")
    try:
        tfp.reset_launches()
        ConvBPDN(D, S, 0.05, opt=opt).solve()
    finally:
        tsf.set_precision("highest")
    assert tfp.LAUNCHES == {"rfft2_planar": 0, "irfft2_planar": 0}


# ---------------------------------------------------------------------------
# admm_tail and the fused driver's body

# (R, C): the small slice layout, a C off a multiple of 4 and of 128, a
# ragged R, a single element
TAIL_GEOMS = [(64, 256), (37, 4100), (100, 192), (7, 3), (1, 1)]


def _tail_inputs(R, C, vectors, dev, seed=3):
    g = torch.Generator().manual_seed(seed)
    PX = torch.randn(R, C, generator=g)
    PY = torch.randn(R, C, generator=g) * (torch.rand(R, C, generator=g)
                                           < 0.3)
    PU = 0.1 * torch.randn(R, C, generator=g)
    if vectors:
        thr = (0.2 + 0.6 * torch.rand(C, generator=g)).to(dev)
        wl1 = (0.5 + torch.rand(C, generator=g)).to(dev)
    else:
        thr, wl1 = 0.45, 1.3
    return [t.to(dev) for t in (PX, PY, PU)] + [thr, wl1]


def _tail_run(fn, args, nonneg, us):
    PX, PY, PU, thr, wl1 = args
    out = fn(PX, PY.clone(), PU.clone(), thr, wl1, RLX, nonneg=nonneg,
             us=us)
    return [o.cpu() for o in out]


@pytest.mark.parametrize("geom", TAIL_GEOMS, ids=str)
@pytest.mark.parametrize("vectors", [False, True])
@pytest.mark.parametrize("nonneg", [False, True])
@pytest.mark.parametrize("us", [1.0, 0.7])
def test_tail_kernel_matches_plain(dev, geom, vectors, nonneg, us):
    """Both fp32 on the card: PYn and PUn within 1e-5 of their largest
    magnitude, the sums (double partials against torch's float sums)
    to 1e-5 relative."""
    args = _tail_inputs(*geom, vectors, dev)
    got = _tail_run(tct.admm_tail, args, nonneg, us)
    ref = _tail_run(tct.admm_tail_plain, args, nonneg, us)
    for name, a, b in zip(("PYn", "PUn"), got, ref):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-5 * scale, name
    np.testing.assert_allclose(got[2].numpy(), ref[2].numpy(), rtol=1e-5,
                               atol=1e-30)


def test_tail_unaligned_buffers_take_scalar_path(dev):
    R, C = 64, 256
    PX, PY, PU, thr, wl1 = _tail_inputs(R, C, True, dev)
    ref = _tail_run(tct.admm_tail_plain, (PX, PY, PU, thr, wl1), False, 0.9)
    bufs = [torch.empty(R * C + 1, device=dev) for _ in range(3)]
    views = [b[1:].view(R, C) for b in bufs]
    for v, t in zip(views, (PX, PY, PU)):
        v.copy_(t)
    out = tct.admm_tail(*views, thr, wl1, RLX, us=0.9)
    for a, b in zip(out, ref):
        assert float((a.cpu() - b).abs().max()) <= \
            1e-5 * float(b.abs().max())


def test_tail_counts_launches_updates_in_place_and_rejects(dev):
    PX, PY, PU, thr, wl1 = _tail_inputs(64, 256, False, dev)
    tct.reset_launches()
    yn, un, sums = tct.admm_tail(PX, PY, PU, thr, wl1, RLX)
    assert tct.LAUNCHES["admm_tail"] == 1
    assert yn is PY and un is PU and sums.shape == (6,)
    s1 = tct.admm_tail(PX, PY.clone(), PU.clone(), thr, wl1, RLX)[2]
    s2 = tct.admm_tail(PX, PY.clone(), PU.clone(), thr, wl1, RLX)[2]
    assert torch.equal(s1, s2)              # fixed-order sums
    with pytest.raises(ValueError):
        tct.admm_tail(PX, PY, PY, thr, wl1, RLX)
    with pytest.raises(TypeError):
        tct.admm_tail(PX.double(), PY, PU, thr, wl1, RLX)
    with pytest.raises(ValueError):
        tct.admm_tail(PX.cpu(), PY, PU, thr, wl1, RLX)
    with pytest.raises(ValueError):
        tct.admm_tail(PX, PY.t(), PU, thr, wl1, RLX)
    assert tct.LAUNCHES["admm_tail"] == 3


def _variant_problem(N=64, M=8, seed=0):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((8, 8, M)).astype(np.float32)
    D /= np.sqrt((D ** 2).sum(axis=(0, 1), keepdims=True))
    S = rng.standard_normal((N, N)).astype(np.float32)
    return D, S


@pytest.mark.parametrize("kind", ["gradreg", "elastic", "l1_spatial"])
def test_fused_variants_on_card_match_cpu(dev, kind):
    """ConvBPDNGradReg (the tail kernel, and the FFT kernels at 128x128),
    ConvElasticNet (csc_iter) and l1 with a spatial L1Weight (the torch
    tail), 15 iterations on the card against the CPU."""
    D, S = _variant_problem(N=128)
    M = D.shape[-1]
    opt = dict(max_iter=15, rel_stop_tol=0.0)
    if kind == "gradreg":
        cls = ConvBPDNGradReg
        w = np.ones(M, np.float32)
        w[-1] = 0.0
        kw = dict(mu=0.2, wgrd=w)
    elif kind == "elastic":
        cls, kw = ConvElasticNet, dict(mu=0.05)
    else:
        cls = ConvBPDN
        kw = dict(wl1=(0.5 + np.random.default_rng(1).random(
            (128, 128, M))).astype(np.float32))
    tci.reset_launches()
    tct.reset_launches()
    tfp.reset_launches()
    a = cls(D, S, 0.05, opt=cls.options(**opt), **kw)
    Ya = a.solve().cpu().numpy()
    want = {"gradreg": (0, 15), "elastic": (15, 0), "l1_spatial": (0, 0)}
    assert (tci.LAUNCHES["csc_iter"], tct.LAUNCHES["admm_tail"]) == \
        want[kind]
    if kind == "gradreg":
        # setup: D, S and the gradient filters; one pair per iteration
        assert tfp.LAUNCHES == {"rfft2_planar": 18, "irfft2_planar": 15}
    b = cls(D, S, 0.05, opt=cls.options(**opt), device="cpu", **kw)
    Yb = b.solve().numpy()
    assert np.abs(Ya - Yb).max() < 2e-4 * np.abs(Yb).max()
    ia, ib = a.getitstat(), b.getitstat()
    for name in ("ObjFun", "DFid", "RegL1", "Rho"):
        np.testing.assert_allclose(getattr(ia, name), getattr(ib, name),
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(ia.PrimalRsdl, ib.PrimalRsdl, rtol=1e-3,
                               atol=1e-6)


@pytest.mark.parametrize("kind", ["colour_admm", "colour_elastic",
                                  "colour_fista", "colour_fista_masked",
                                  "folded_admm", "folded_fista_masked"])
def test_colour_solves_on_card_match_cpu(dev, kind):
    """Colour CSC at 64x64x3 with 8 filters, 15 iterations on the card
    against the CPU: a colour dictionary (8x8x3) on fused ADMM (l1 and
    elastic, csc_iter at T = 768) and fused FISTA (pgm_iter, unmasked and
    with a per-channel mask), and a grey dictionary folded over the three
    channels; one kernel launch per iteration."""
    rng = np.random.default_rng(3)
    S = rng.standard_normal((64, 64, 3)).astype(np.float32)
    W = (rng.random((64, 64, 3)) >= 0.3).astype(np.float32)
    if kind.startswith("colour"):
        D = rng.standard_normal((8, 8, 3, 8)).astype(np.float32)
        D /= np.sqrt((D ** 2).sum(axis=(0, 1, 2), keepdims=True))
    else:
        D, _ = _variant_problem(N=64)
    kw = {"dimK": 0}
    if kind.endswith("fista") or kind.endswith("masked"):
        cls = tpgm.ConvBPDNMask if kind.endswith("masked") else \
            tpgm.ConvBPDN
        if kind.endswith("masked"):
            kw["W"] = W
        opt = cls.options(max_iter=15, rel_stop_tol=0.0, L=50.0)
        counter, names = tpi, ("ObjFun", "DFid", "RegL1")
    else:
        cls = ConvElasticNet if kind == "colour_elastic" else ConvBPDN
        if cls is ConvElasticNet:
            kw["mu"] = 0.05
        opt = cls.options(max_iter=15, rel_stop_tol=0.0)
        counter, names = tci, ("ObjFun", "DFid", "RegL1", "Rho")
    counter.reset_launches()
    a = cls(D, S, 0.05, opt=opt, **kw)
    Ya = a.solve().cpu().numpy()
    assert sum(counter.LAUNCHES.values()) == 15
    b = cls(D, S, 0.05, opt=opt, device="cpu", **kw)
    Yb = b.solve().numpy()
    assert np.abs(Ya - Yb).max() < 2e-4 * np.abs(Yb).max()
    ia, ib = a.getitstat(), b.getitstat()
    for name in names:
        np.testing.assert_allclose(getattr(ia, name), getattr(ib, name),
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("n,m", [(128, 63), (200, 8)], ids=str)
def test_fused_gradreg_runs_tail_kernel_at_any_layout(dev, n, m):
    """Packed layouts the JAX package's TPU block rule sends to its XLA
    tail (C = 4032, off a multiple of 128; 625 rows, off a multiple of
    8) still run the tail kernel once per iteration, and agree with the
    CPU."""
    D, S = _variant_problem(N=n, M=m)
    w = np.ones(m, np.float32)
    w[-1] = 0.0
    opt = ConvBPDNGradReg.options(max_iter=15, rel_stop_tol=0.0)
    tct.reset_launches()
    a = ConvBPDNGradReg(D, S, 0.05, mu=0.2, wgrd=w, opt=opt)
    Ya = a.solve().cpu().numpy()
    assert tct.LAUNCHES["admm_tail"] == 15
    b = ConvBPDNGradReg(D, S, 0.05, mu=0.2, wgrd=w, opt=opt, device="cpu")
    Yb = b.solve().numpy()
    assert np.abs(Ya - Yb).max() < 2e-4 * np.abs(Yb).max()
    np.testing.assert_allclose(a.getitstat().ObjFun, b.getitstat().ObjFun,
                               rtol=1e-4)


# ---------------------------------------------------------------------------
# Dictionary learning: csc_iter without its forward pair, the consensus
# loop and ConvBPDNDictLearn

@pytest.mark.parametrize("geom", [(64, 512, 256), (100, 200, 60),
                                  (10240, 2048, 256), (4096, 4096, 768)],
                         ids=str)
@pytest.mark.parametrize("vectors", [False, True])
def test_kernel_without_forward_pair_matches_plain(dev, geom, vectors):
    """emit_fwd=False: no R1/R2, PX/Yn/Un/sums within 1e-5 of the plain
    version's (the full form's gate), Yn/Un bit for bit the full
    form's."""
    args = _inputs(*geom, vectors, dev, seed=5)
    G2, Y, U, Wa, Wf, thr, wl1 = args
    wf3 = tci.split_weight(Wf)

    def run(fn, fwd, wf):
        out = fn(G2, Y.clone(), U.clone(), Wa, wf, thr, wl1, RLX, US,
                 SCALE, emit_px=True, wf_split=wf3 if fwd else None,
                 emit_fwd=fwd)
        return [None if o is None else o.cpu() for o in out]
    tci.reset_launches()
    got = run(tci.csc_iter, False, None)
    assert tci.LAUNCHES["csc_iter"] == 1
    full = run(tci.csc_iter, True, Wf)
    ref = run(tci.csc_iter_plain, False, None)
    assert got[3] is None and got[4] is None
    for name, i in (("PX", 0), ("Yn", 1), ("Un", 2), ("sums", 5)):
        scale = max(float(ref[i].abs().max()), 1e-30)
        err = float((got[i] - ref[i]).abs().max()) / scale
        assert err <= 1e-5, (name, err)
        assert torch.equal(got[i], full[i]), name


def _cns_problem(seed=0):
    rng = np.random.default_rng(seed)
    D0 = rng.standard_normal((5, 5, 8)).astype(np.float32)
    S = rng.standard_normal((32, 32, 4)).astype(np.float32)
    W = (rng.random(S.shape) < 0.8).astype(np.float32)
    return D0, S, W


@pytest.mark.parametrize("stage", ["kernel", "spatial", "dft", "masked"])
def test_consensus_on_card_matches_cpu(dev, stage):
    """5 outer iterations of each CSC stage, card against CPU: D and Z
    within 1e-4 of their scale, the objective 1e-4 relative; the kernel
    stage launches csc_iter once an iteration, the others never."""
    from sporco_tpu_torch.parallel import consensus as tcn
    D0, S, W = _cns_problem()
    cls, kw = tcn.ConvBPDNDictLearn_Consensus, {}
    if stage == "spatial":
        kw = {"wl1": np.ones((1, 1, 1, 1, 8), np.float32)}
    elif stage == "dft":
        kw = {"fused": False}
    elif stage == "masked":
        cls, kw = tcn.ConvBPDNMaskDcplDictLearn_Consensus, {"W": W}
    out = []
    for d in (dev, "cpu"):
        c = cls(D0, S, 0.1, max_iter=5, device=d, **kw)
        tci.reset_launches()
        c.solve()
        if d == dev:
            assert tci.LAUNCHES["csc_iter"] == (5 if stage == "kernel"
                                                else 0)
        out.append((c.getdict().cpu().numpy(), c.getcoef().cpu().numpy(),
                    c.evaluate()[0]))
    (Dg, Zg, og), (Dc, Zc, oc) = out
    assert np.abs(Dg - Dc).max() <= 1e-4
    assert np.abs(Zg - Zc).max() <= 1e-4 * np.abs(Zc).max()
    assert abs(og - oc) <= 1e-4 * abs(oc)


@pytest.mark.parametrize("xmethod", ["admm", "pgm"])
def test_dictlearn_on_card_matches_cpu(dev, xmethod):
    """ConvBPDNDictLearn on the fused x-step: one csc_iter (pgm_iter) per
    outer iteration on the card, 5 outer iterations against the CPU."""
    from sporco_tpu_torch.models import dictlrn as tdl
    D0, S, _ = _cns_problem(1)
    out = []
    for d in (dev, "cpu"):
        b = tdl.ConvBPDNDictLearn(D0, S, 0.1, xmethod=xmethod, max_iter=5,
                                  dtype=torch.float32, device=d)
        tci.reset_launches()
        tpi.reset_launches()
        b.solve()
        if d == dev:
            kern = tci if xmethod == "admm" else tpi
            name = "csc_iter" if xmethod == "admm" else "pgm_iter"
            assert kern.LAUNCHES[name] == 5
        out.append((b.getdict().cpu().numpy(), b.getitstat()))
    (Dg, ig), (Dc, ic) = out
    assert np.abs(Dg - Dc).max() <= 1e-4
    np.testing.assert_allclose(ig["XObjFun"], ic["XObjFun"], rtol=1e-4)


# ---------------------------------------------------------------------------
# The AMS form of the tail kernel, the "mixed" forward product, masked CSC,
# the accelerator API and the FISTA dictionary update

# (R, M, nimp): the headline packed layout with the impulse map (C = 64 *
# 65 = 4160, 16-byte path), a per-image mask's rows, a C off a multiple
# of 4 (scalar path), several impulse maps
AMS_GEOMS = [(4096, 65, 1), (2 * 64, 9, 1), (37, 65, 1), (25, 5, 2)]


def _ams_inputs(R, M, dev, seed=7):
    g = torch.Generator().manual_seed(seed)
    P = 64
    C = P * M
    PX = torch.randn(R, C, generator=g)
    PY = torch.randn(R, C, generator=g) * (torch.rand(R, C, generator=g)
                                           < 0.1)
    PU = 0.1 * torch.randn(R, C, generator=g)
    Wp = (torch.rand(R, P, generator=g) > 0.25).float()
    wl1 = torch.ones(M)
    wl1[-1] = 0.0
    wl1 = wl1.repeat(P)
    return [t.to(dev) for t in (PX, PY, PU, Wp, 0.3 * wl1, wl1)]


@pytest.mark.parametrize("geom", AMS_GEOMS, ids=str)
@pytest.mark.parametrize("nonneg", [False, True])
@pytest.mark.parametrize("us", [1.0, 0.7])
def test_tail_kernel_ams_matches_plain(dev, geom, nonneg, us):
    """The AMS form against its plain version: PYn and PUn bit for bit
    (every operation rounds on its own in both), the sums to 1e-5
    relative; the impulse maps hold (1 - w)(AX + U)."""
    R, M, nimp = geom
    PX, PY, PU, Wp, thr, wl1 = _ams_inputs(R, M, dev)
    out = []
    for fn in (tct.admm_tail, tct.admm_tail_plain):
        o = fn(PX, PY.clone(), PU.clone(), thr, wl1, RLX, nonneg=nonneg,
               us=us, ams=(Wp, nimp))
        out.append([t.cpu() for t in o])
    (yk, uk, sk), (yp, up, sp) = out
    assert torch.equal(yk, yp) and torch.equal(uk, up)
    np.testing.assert_allclose(sk.numpy(), sp.numpy(), rtol=1e-5)
    plain = tct.admm_tail_plain(PX, PY.clone(), PU.clone(), thr, wl1, RLX,
                                nonneg=nonneg, us=us)[0].cpu()
    imp = yk.reshape(R, 64, M)[:, :, M - nimp:]
    assert not torch.equal(imp, plain.reshape(R, 64, M)[:, :, M - nimp:])
    assert torch.equal(yk.reshape(R, 64, M)[:, :, :M - nimp],
                       plain.reshape(R, 64, M)[:, :, :M - nimp])


def test_tail_kernel_ams_off_is_unchanged(dev):
    """ams=None launches the plain form: the same bits as before."""
    PX, PY, PU, Wp, thr, wl1 = _ams_inputs(256, 8, dev)
    a = tct.admm_tail(PX, PY.clone(), PU.clone(), thr, wl1, RLX)
    b = tct.admm_tail_plain(PX, PY.clone(), PU.clone(), thr, wl1, RLX)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    with pytest.raises(ValueError):
        tct.admm_tail(PX, PY.clone(), PU.clone(), thr, wl1, RLX,
                      ams=(Wp[:, :5].contiguous(), 1))


@pytest.mark.parametrize("geom", [(64, 256, 256), (129, 131, 7),
                                  (4096, 4096, 256)], ids=str)
def test_mixed_forward_matches_plain(dev, geom):
    """``mixed=True``: R1 (csc_iter) and R1 (pgm_iter) as one bf16
    product: the kernel's and the plain version's R1 each within 1e-5 of
    the float64 product of their own bf16-rounded operands (the kernel's
    Yn/Un may differ from the plain version's by fp32 ulps where cuBLAS
    sums A in another order, and a bf16 rounding then flips); every
    other output the "high" launch's bits."""
    args = _inputs(*geom, False, dev)
    G2, Y, U, Wa, Wf, thr, wl1 = args
    wf3 = tci.split_weight(Wf)
    wb = Wf.to(torch.bfloat16).double().cpu()

    def csc(fn, mixed):
        o = fn(G2, Y.clone(), U.clone(), Wa, Wf, thr, wl1, RLX, US, SCALE,
               emit_px=True, wf_split=wf3, mixed=mixed)
        return [t.cpu() for t in o]

    def pgm(fn, mixed):
        o = fn(G2, Y.clone(), U.clone(), Wa, Wf, thr, wl1, 0.05, 0.3,
               wf_split=wf3, mixed=mixed)
        return [t.cpu() for t in o]
    for run, r1, operand in ((csc, 3, lambda o: o[1] - o[2]),
                             (pgm, 2, lambda o: o[1])):
        kern = tci.csc_iter if run is csc else tpi.pgm_iter
        plain = tci.csc_iter_plain if run is csc else tpi.pgm_iter_plain
        km, kh, pm = run(kern, True), run(kern, False), run(plain, True)
        for out in (km, pm):
            want = operand(out).to(torch.bfloat16).double() @ wb
            scale = float(want.abs().max())
            assert float((out[r1].double() - want).abs().max()) \
                <= 1e-5 * scale
        assert float((kh[r1] - km[r1]).abs().max()) > 1e-4 * scale
        for i, (a, b) in enumerate(zip(km, kh)):
            if i != r1:
                assert torch.equal(a, b), i


def _ams_problem(N=64, M=8, seed=0):
    D, S = _variant_problem(N=N, M=M, seed=seed)
    W = (np.random.default_rng(seed + 1).random((N, N)) > 0.25).astype(
        np.float32)
    return D, S, W


@pytest.mark.parametrize("cls", ["ConvBPDN", "ConvBPDNGradReg"])
def test_ams_solve_on_card_matches_cpu(dev, cls):
    """AddMaskSim fused, 15 iterations: one AMS tail launch an
    iteration, card against CPU at the fused variants' tolerances."""
    from sporco_tpu_torch.models import cbpdn as tcb
    D, S, W = _ams_problem()
    kcls = getattr(tcb, cls)
    kw = {"mu": 0.05} if cls == "ConvBPDNGradReg" else {}
    opt = kcls.options(max_iter=15, rel_stop_tol=0.0)
    out = []
    for d in (dev, "cpu"):
        tci.reset_launches()
        tct.reset_launches()
        b = tcb.AddMaskSim(kcls, D, S, W, 0.05, opt=opt, device=d, **kw)
        Y = b.solve().cpu().numpy()
        if d == dev:
            assert tct.LAUNCHES["admm_tail"] == 15
            assert tci.LAUNCHES["csc_iter"] == 0
        out.append((Y, b.getitstat()))
    (Ya, ia), (Yb, ib) = out
    assert np.abs(Ya - Yb).max() < 2e-4 * np.abs(Yb).max()
    for name in ("ObjFun", "DFid", "RegL1", "Rho"):
        np.testing.assert_allclose(getattr(ia, name), getattr(ib, name),
                                   rtol=1e-4, err_msg=name)


def test_device_helpers_with_card(dev):
    from sporco_tpu_torch import accel
    assert accel.device_count() == torch.cuda.device_count() >= 1
    assert accel.current_device() == torch.cuda.current_device()
    assert accel.current_device(0) == 0
    assert accel.device_name() == torch.cuda.get_device_name(0)
    free, total = accel.memory_info()
    assert 0 < free <= total


@pytest.mark.parametrize("name", ["cbpdn", "cbpdngrd", "cbpdnmsk",
                                  "cbpdngrdmsk"])
def test_accel_solvers_run_on_the_card_by_default(dev, name):
    """No device: the card; the result within 2e-4 of the CPU solve's
    scale."""
    from sporco_tpu_torch import accel
    D, S, W = _ams_problem()
    args = {"cbpdn": (D, S, 0.05), "cbpdngrd": (D, S, 0.05, 0.05),
            "cbpdnmsk": (D, S, W, 0.05),
            "cbpdngrdmsk": (D, S, W, 0.05, 0.05)}[name]
    opt = {"MaxMainIter": 12, "RelStopTol": 0.0}
    got = getattr(accel, name)(*args, opt=dict(opt))
    assert got.device.type == "cuda"
    want = getattr(accel, name)(*args, opt=dict(opt), device="cpu")
    assert float((got.cpu() - want).abs().max()) \
        <= 2e-4 * float(want.abs().max())


def test_dictlearn_pgm_dstep_on_card_matches_cpu(dev):
    """ConvBPDNDictLearn with the FISTA dictionary update (dmethod='pgm'),
    5 outer iterations, card against CPU."""
    from sporco_tpu_torch.models import dictlrn as tdl
    D0, S, _ = _cns_problem(1)
    out = []
    for d in (dev, "cpu"):
        b = tdl.ConvBPDNDictLearn(D0, S, 0.1, xmethod="pgm", dmethod="pgm",
                                  max_iter=5, dtype=torch.float32, device=d)
        b.solve()
        out.append((b.getdict().cpu().numpy(), b.getitstat()))
    (Dg, ig), (Dc, ic) = out
    assert np.abs(Dg - Dc).max() <= 1e-4
    np.testing.assert_allclose(ig["XObjFun"], ic["XObjFun"], rtol=1e-4)
    np.testing.assert_allclose(ig["DDFid"], ic["DDFid"], rtol=1e-4)


def test_reconstruct_takes_card_tensors(dev):
    """``reconstruct(X)`` with X a tensor on the card (as ``getcoef``
    returns it; ``numpy.asarray`` of a CUDA tensor raises), and the AMS
    reconstruction from the dictionary filters' maps, against the CPU."""
    from sporco_tpu_torch.models import cbpdn as tcb
    D, S, W = _ams_problem()
    out = []
    for d in (dev, "cpu"):
        a = tcb.AddMaskSim(tcb.ConvBPDN, D, S, W, 0.05, device=d,
                           opt=tcb.ConvBPDN.options(max_iter=5))
        a.solve()
        b = a.cbpdn
        out.append((a.reconstruct().cpu(), b.reconstruct(b.getcoef()).cpu()))
    for g, c in zip(*out):
        assert float((g - c).abs().max()) <= 2e-4 * float(c.abs().max())


def test_generic_dictlearn_on_card_matches_cpu(dev):
    """The generic ``DictLearn`` over port models on the card: its
    user-layout hand-overs (``setcoef``/``setdict``) take the models' own
    card tensors; 3 outer iterations against the CPU."""
    from sporco_tpu_torch.models import ccmod as tcc
    from sporco_tpu_torch.models import dictlrn as tdl
    D0, S = _variant_problem(N=64, M=8)
    out = []
    for d in (dev, "cpu"):
        x = ConvBPDN(D0, S, 0.05, opt=ConvBPDN.options(
            max_iter=5, rel_stop_tol=0.0), device=d)
        z0 = np.zeros(S.shape[:2] + (1, 1, D0.shape[-1]), np.float32)
        dstep = tcc.ConvCnstrMOD(z0, S, D0.shape, method="cns", device=d,
                                 opt=tcc.ConvCnstrMODBase.options(
                                     max_iter=5, rel_stop_tol=0.0))
        b = tdl.DictLearn(x, dstep, max_iter=3)
        Dl = b.solve()
        assert Dl.device.type == torch.device(d).type
        out.append((Dl.cpu().numpy(), b.getcoef().cpu().numpy()))
    (Dg, Xg), (Dc, Xc) = out
    assert np.abs(Dg - Dc).max() <= 2e-4 * np.abs(Dc).max()
    assert np.abs(Xg - Xc).max() <= 2e-4 * np.abs(Xc).max()


def _dense_cases():
    rng = np.random.default_rng(0)
    D = rng.standard_normal((64, 96)).astype(np.float32)
    x0 = np.zeros((96, 4), np.float32)
    for k in range(4):
        x0[rng.choice(96, 6, replace=False), k] = rng.standard_normal(6)
    Sb = D @ x0
    img = np.zeros((128, 128), np.float32)
    img[32:96, 32:96] = 1.0
    St = img + 0.1 * rng.standard_normal((128, 128)).astype(np.float32)
    L = rng.standard_normal((64, 3)) @ rng.standard_normal((3, 64))
    Sr = (L + (rng.random((64, 64)) > 0.9) * rng.standard_normal(
        (64, 64)) * 5).astype(np.float32)
    blur = np.ones((5, 5), np.float32) / 25
    return {
        "BPDN": ("bpdn", (D, Sb), {"lmbda": 1e-2}),
        "MinL1InL2Ball": ("bpdn", (D, Sb), {"epsilon": 0.05}),
        "TVL2Denoise": ("tv", (St, 0.05), {}),
        "TVL1Deconv": ("tv", (blur, St, 5e-3), {}),
        "RobustPCA": ("rpca", (Sr,), {"svd_rank": 6}),
    }


@pytest.mark.parametrize("name", ["BPDN", "MinL1InL2Ball", "TVL2Denoise",
                                  "TVL1Deconv", "RobustPCA"])
def test_dense_and_tv_models_on_card_match_cpu(dev, name):
    """10 iterations of the BPDN, TV and Robust PCA models on the card
    against the CPU (the CPU tests' float32 tolerances; RobustPCA with
    the same sketch on both sides)."""
    import importlib
    mod, args, kw = _dense_cases()[name]
    cls = getattr(importlib.import_module(
        f"sporco_tpu_torch.models.{mod}"), name)
    opt = cls.options(max_iter=10, rel_stop_tol=0.0)
    if name == "RobustPCA":
        kw = {**kw, "sketch": torch.randn(
            64, 16, generator=torch.Generator().manual_seed(0))}
    out = []
    for d in (dev, "cpu"):
        b = cls(*args, opt=opt, device=d, **kw)
        b.solve()
        out.append((b.state.X.cpu().numpy(), b.getitstat()))
    (Xg, ig), (Xc, ic) = out
    assert np.abs(Xg - Xc).max() <= 2e-4 * np.abs(Xc).max()
    for col in ig._names[1:]:
        rtol = 1e-3 if ("Rsdl" in col or "RelRes" in col
                        or col == "Cnstr") else 1e-4
        if col == "XSlvRelRes":
            np.testing.assert_allclose(getattr(ig, col), getattr(ic, col),
                                       rtol=0, atol=1e-5)
        elif col != "Cnstr" or name == "RobustPCA":
            np.testing.assert_allclose(getattr(ig, col), getattr(ic, col),
                                       rtol=rtol, err_msg=col)


@pytest.mark.parametrize("name,inverse", [("TVL2Deconv", 3),
                                          ("TVL1Deconv", 2)])
def test_tv_deconv_launches_fft_kernels(dev, name, inverse):
    """At 128x128 the deconvolution x-step's 2-D transforms of X launch
    the planar FFT kernels: 4 forward in the set-up, then per iteration
    1 forward and ``inverse`` inverse."""
    from sporco_tpu_torch.models import tv as ttv
    _, (blur, St, lm), _ = _dense_cases()["TVL1Deconv"]
    cls = getattr(ttv, name)
    b = cls(blur, St, lm, opt=cls.options(max_iter=7, rel_stop_tol=0.0),
            device=dev)
    tfp.reset_launches()
    b.solve()
    torch.cuda.synchronize()
    assert tfp.LAUNCHES == {"rfft2_planar": 7 + 4,
                            "irfft2_planar": inverse * 7}


def _new_model_cases():
    """name -> maker(device) of a float64 model of this slice (10
    iterations, or 3 outer iterations / 2 samples for the learners), on
    small seeded problems."""
    from sporco_tpu_torch.models import cbpdn as tcb
    from sporco_tpu_torch.models import ccmodmd as tmd
    from sporco_tpu_torch.models import cmod as tcm
    from sporco_tpu_torch.models import dictlrn as tdl
    rng = np.random.default_rng(11)
    D = rng.standard_normal((4, 4, 6))
    S = rng.standard_normal((32, 32, 2))
    W = (rng.random(S.shape) > 0.25).astype(np.float64)
    Z = rng.standard_normal((32, 32, 1, 2, 6)) * (rng.random(
        (32, 32, 1, 2, 6)) < 0.1)
    Dd = rng.standard_normal((16, 24))
    Xd = rng.standard_normal((24, 40)) * (rng.random((24, 40)) < 0.2)
    Sd = Dd @ Xd
    Wd = rng.uniform(0.5, 1.5, Sd.shape)
    f64 = {"dtype": torch.float64}

    def opt(cls, n=10):
        return {"opt": cls.options(max_iter=n, rel_stop_tol=0.0)}

    def md(method):
        o = tmd.ConvCnstrMODMaskDcplOptions(method=method, max_iter=10,
                                            rel_stop_tol=0.0)
        # CG at 1e-10: at its default 1e-3 both devices run the same CG
        # counts, but its 33-iteration iterate carries rounding up to
        # 1e-7..1e-6 of scale, a one-ulp move of S on the CPU alone
        # included (tools/ccmodmd_cg_counts.py;
        # test_ccmodmd_cg_default_tolerance_counts_equal_on_card)
        cg = {"cg_tol": 1e-10} if method == "cg" else {}
        return lambda d: tmd.ConvCnstrMODMaskDcpl(
            Z, S, W, D.shape, method=method, D0=D, opt=o, device=d, **cg,
            **f64)
    return {
        "ConvBPDNMaskDcpl": lambda d: tcb.ConvBPDNMaskDcpl(
            D, S, 0.1, W=W, device=d, **opt(tcb.ConvBPDNMaskDcpl), **f64),
        "ConvL1L1Grd": lambda d: tcb.ConvL1L1Grd(
            D, S, 0.1, mu=0.1, W=W, device=d, **opt(tcb.ConvL1L1Grd),
            **f64),
        "ConvMinL1InL2Ball": lambda d: tcb.ConvMinL1InL2Ball(
            D, S, 5.0, device=d, **opt(tcb.ConvMinL1InL2Ball), **f64),
        "ccmodmd cns": md("cns"), "ccmodmd ism": md("ism"),
        "ccmodmd cg": md("cg"),
        "cmod.CnstrMOD": lambda d: tcm.CnstrMOD(
            Xd, Sd, D0=Dd, device=d, **opt(tcm.CnstrMOD), **f64),
        "pgm.BPDN": lambda d: tpgm.BPDN(Dd, Sd, 0.1, device=d,
                                        **opt(tpgm.BPDN), **f64),
        "pgm.WeightedBPDN": lambda d: tpgm.WeightedBPDN(
            Dd, Sd, 0.1, W=Wd, device=d, **opt(tpgm.BPDN), **f64),
        "pgm.CnstrMOD": lambda d: tpgm.CnstrMOD(
            Xd, Sd, D0=Dd, device=d, **opt(tpgm.CnstrMOD), **f64),
        "pgm.WeightedCnstrMOD": lambda d: tpgm.WeightedCnstrMOD(
            Xd, Sd, W=Wd, D0=Dd, device=d, **opt(tpgm.CnstrMOD), **f64),
        "ConvBPDNMaskDictLearn admm": lambda d: tdl.ConvBPDNMaskDictLearn(
            D, S, 0.1, W=W, max_iter=3, device=d),
        "ConvBPDNMaskDictLearn pgm": lambda d: tdl.ConvBPDNMaskDictLearn(
            D, S, 0.1, W=W, xmethod="pgm", dmethod="pgm", max_iter=3,
            device=d),
        "OnlineConvBPDNDictLearn": lambda d: tdl.OnlineConvBPDNDictLearn(
            D, 0.1, device=d, **f64),
        "OnlineConvBPDNMaskDictLearn":
            lambda d: tdl.OnlineConvBPDNMaskDictLearn(D, 0.1, device=d,
                                                      **f64),
        "BPDNDictLearn": lambda d: tdl.BPDNDictLearn(
            Dd, Sd, 0.1, max_iter=3, device=d),
        "WeightedBPDNDictLearn": lambda d: tdl.WeightedBPDNDictLearn(
            Dd, Sd, 0.1, W=Wd, max_iter=3, device=d),
    }, S, W


def _arrays(b):
    """The solution arrays of a model or a learner, as numpy."""
    def np_(t):
        return t.detach().cpu().numpy()
    if hasattr(b, "getdict"):
        return [np_(b.getdict())]
    if isinstance(b.state.X, tuple):
        return [np_(t) for t in b.state.X + b.state.Y]
    return [np_(b.state.X)]


def _columns(b):
    its = b.getitstat()
    if isinstance(its, dict):
        return its
    return {n: getattr(its, n) for n in its._names}


SLICE_MODELS = ["ConvBPDNMaskDcpl", "ConvL1L1Grd", "ConvMinL1InL2Ball",
                "ccmodmd cns", "ccmodmd ism", "ccmodmd cg",
                "cmod.CnstrMOD", "pgm.BPDN", "pgm.WeightedBPDN",
                "pgm.CnstrMOD", "pgm.WeightedCnstrMOD",
                "ConvBPDNMaskDictLearn admm", "ConvBPDNMaskDictLearn pgm",
                "OnlineConvBPDNDictLearn", "OnlineConvBPDNMaskDictLearn",
                "BPDNDictLearn", "WeightedBPDNDictLearn"]


@pytest.mark.parametrize("name", SLICE_MODELS)
def test_slice_models_on_card_match_cpu(dev, name):
    """Each model of the masked, online and patch dictionary learning
    slice in float64 on the card against the CPU: every stats column
    rtol 1e-6 (a column at zero up to rounding, within 1e-12 of its
    largest value, counts as equal) and the solution within 1e-8 of its
    scale."""
    cases, S, W = _new_model_cases()
    out = []
    for d in (dev, "cpu"):
        b = cases[name](d)
        if name.startswith("Online"):
            for k in range(2):
                kw = {"W": W[..., k]} if "Mask" in name else {}
                b.solve(S[..., k], **kw)
        else:
            b.solve()
        out.append((_columns(b), _arrays(b)))
    (cg, ag), (cc, ac) = out
    assert sorted(cg) == sorted(cc)
    for col in cg:
        g, c = np.asarray(cg[col], np.float64), np.asarray(cc[col],
                                                           np.float64)
        if col.endswith("XSlvRelRes") or col.endswith("Cnstr"):
            np.testing.assert_allclose(g, c, rtol=0, atol=1e-10)
            continue
        floor = (1e-12 * np.nanmax(np.abs(c)) if np.isfinite(c).any()
                 else 0.0)
        near0 = np.maximum(np.abs(g), np.abs(c)) <= floor
        np.testing.assert_allclose(np.where(near0, 0, g),
                                   np.where(near0, 0, c), rtol=1e-6,
                                   equal_nan=True, err_msg=col)
    for g, c in zip(ag, ac):
        assert np.abs(g - c).max() <= 1e-8 * max(np.abs(c).max(), 1e-30)


def test_ccmodmd_cg_default_tolerance_counts_equal_on_card(dev):
    """At the default CG tolerance (1e-3) the masked CCMOD's CG d-step
    stops at the same iteration on the card and on the CPU in every
    x-step of the 10 iterations: the two parted by 1.1e-7 of scale there
    through rounding inside CG, not through its stopping test.  The
    card's counts a solve come from the problem declared eager (each CG
    solve a graph that reads its count); on the graph route, where the
    counts stay on the device, their sum is the loop's count of CG
    iterations."""
    from sporco_tpu_torch.models import ccmodmd as tmd
    from sporco_tpu_torch.ops import device_loop
    cases, _, _ = _new_model_cases()
    b = cases["ccmodmd cg"](dev)
    b.cfg = dataclasses.replace(b.cfg, cg_tol=1e-3)
    b.solve()
    assert device_loop.LAST["route"] == "graph"
    graph_total = device_loop.LAST["inner"]
    counts = []
    orig = tmd.sl.solvemdbi_cg
    for d in (dev, "cpu"):
        b = cases["ccmodmd cg"](d)
        b.cfg = dataclasses.replace(b.cfg, cg_tol=1e-3)
        b.problem = dataclasses.replace(b.problem, route="eager")
        seen = []

        def counted(*a, **k):
            x, n = orig(*a, **k)
            seen.append(int(n))
            return x, n
        tmd.sl.solvemdbi_cg = counted
        try:
            b.solve()
        finally:
            tmd.sl.solvemdbi_cg = orig
        counts.append(seen)
    assert len(counts[0]) == 10 and counts[0] == counts[1]
    assert sum(counts[0]) == graph_total


@pytest.mark.parametrize("name,per,setup", [("ConvBPDNMaskDcpl", 3, 1),
                                            ("ConvL1L1Grd", 4, 2),
                                            ("ConvMinL1InL2Ball", 3, 1)])
def test_two_block_csc_launches_fft_kernels(dev, name, per, setup):
    """At 128x128 in float32 the two-block x-step's transforms launch the
    planar FFT kernels: per iteration ``per`` forward and inverse, and
    ``setup`` forward in the set-up."""
    from sporco_tpu_torch.models import cbpdn as tcb
    rng = np.random.default_rng(12)
    D = rng.standard_normal((8, 8, 4)).astype(np.float32)
    S = rng.standard_normal((128, 128)).astype(np.float32)
    cls = getattr(tcb, name)
    arg = {"epsilon": 50.0} if name == "ConvMinL1InL2Ball" else {
        "lmbda": 0.1}
    b = cls(D, S, opt=cls.options(max_iter=7, rel_stop_tol=0.0),
            device=dev, **arg)
    tfp.reset_launches()
    b.solve()
    torch.cuda.synchronize()
    assert tfp.LAUNCHES == {"rfft2_planar": per * 7 + setup,
                            "irfft2_planar": per * 7}


def _csc_rest_cases(dt="float64", n=32):
    """Every model of the rest of the CSC models (of dtype ``dt``, 10
    iterations) as ``make(device)``, on small seeded n x n problems: the
    variants and MultiDict, inhibition, the three TV models, the four
    product dictionary models, the three Plug-and-Play models and the l1
    spline."""
    from sporco_tpu_torch.models import cbpdn as tcb
    from sporco_tpu_torch.models import cbpdnin, cbpdntv, pdcsc, ppp, spline
    from sporco_tpu_torch.ops import fft as tsf
    rng = np.random.default_rng(21)
    M = 6
    D = rng.standard_normal((4, 4, M))
    D /= np.sqrt((D ** 2).sum(axis=(0, 1)))
    S = rng.standard_normal((n, n))
    S3 = rng.standard_normal((n, n, 3))
    Wg = np.kron(np.eye(M // 2), np.ones((1, 2)))
    B = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    cdt = torch.complex128 if dt == "float64" else torch.complex64

    def o(cls, **kw):
        return cls.options(max_iter=10, rel_stop_tol=0.0, **kw)

    def tv(name):
        cls = getattr(cbpdntv, name)
        return lambda d: cls(D, S3, 0.05, 0.02, dimK=0, dtype=dt,
                             device=d, opt=o(cls))

    def pd(name, **kw):
        cls = getattr(pdcsc, name)
        return lambda d: cls(D, B, S3, 0.1, dimK=0, dtype=dt, device=d,
                             opt=o(cls), **kw)
    krn = np.ones((5, 5)) / 25.0
    Af = torch.as_tensor(np.fft.rfftn(krn, s=(n, n), axes=(0, 1))).to(cdt)
    Sf = torch.as_tensor(np.fft.rfftn(S)).to(cdt)

    def ppp_fns(d):
        A, F = Af.to(d), Sf.to(d)

        def f(x):
            return 0.5 * (abs(A * tsf.rfftn(x) - F) ** 2).sum() / x.numel()

        def proxf(x, rho):
            return tsf.irfftn((A.conj() * F + rho * tsf.rfftn(x))
                              / (abs(A) ** 2 + rho), (n, n))

        def prior(x, rho):
            return x / (1.0 + 0.1 / rho)

        def gradf(x):
            return tsf.irfftn(A.conj() * (A * tsf.rfftn(x) - F), (n, n))
        return f, proxf, prior, gradf

    def ppp_make(name):
        def make(d):
            f, proxf, prior, gradf = ppp_fns(d)
            if name == "PPP":
                return ppp.PPP((n, n), f, proxf, prior, dtype=dt, device=d,
                               opt=o(ppp.PPP))
            if name == "PPPConsensus":
                return ppp.PPPConsensus((n, n), [proxf, prior], dtype=dt,
                                        device=d, opt=o(ppp.PPPConsensus))
            return ppp.PPPPGM((n, n), f, gradf, prior, dtype=dt, device=d,
                              opt=o(ppp.PPPPGM, L=1.0))
        return make
    return {
        "ConvBPDNJoint": lambda d: tcb.ConvBPDNJoint(
            D, S3, 0.1, 0.05, dimK=0, dtype=dt, device=d,
            opt=o(tcb.ConvBPDNJoint)),
        "ConvBPDNProjL1": lambda d: tcb.ConvBPDNProjL1(
            D, S, 5.0, dtype=dt, device=d, opt=o(tcb.ConvBPDNProjL1)),
        "MultiDictConvBPDN": lambda d: tcb.MultiDictConvBPDN(
            tcb.ConvBPDN, [D, D[::-1]], [S, S3[..., 0]], 0.1, dtype=dt,
            device=d, opt=o(tcb.ConvBPDN)).cbpdn,
        "ConvBPDNInhib": lambda d: cbpdnin.ConvBPDNInhib(
            D, S, Wg=Wg, Whn=4, lmbda=0.05, mu=0.5, gamma=0.1, dtype=dt,
            device=d, opt=o(cbpdnin.ConvBPDNInhib)),
        **{name: tv(name) for name in ("ConvBPDNScalarTV",
                                       "ConvBPDNVectorTV",
                                       "ConvBPDNRecTV")},
        "ConvProdDictBPDN": pd("ConvProdDictBPDN"),
        "ConvProdDictBPDNJoint": pd("ConvProdDictBPDNJoint", mu=0.05),
        "ConvProdDictL1L1Grd": pd("ConvProdDictL1L1Grd", mu=0.5),
        "ConvProdDictL1L1GrdJoint": pd("ConvProdDictL1L1GrdJoint", mu=0.5,
                                       mu2=0.05),
        **{name: ppp_make(name) for name in ("PPP", "PPPConsensus",
                                             "PPPPGM")},
        "SplineL1": lambda d: spline.SplineL1(
            S, 0.1, Wdf=(np.abs(S) < 2).astype(float), dtype=dt, device=d,
            opt=o(spline.SplineL1)),
    }


CSC_REST_MODELS = ["ConvBPDNJoint", "ConvBPDNProjL1", "MultiDictConvBPDN",
                   "ConvBPDNInhib", "ConvBPDNScalarTV", "ConvBPDNVectorTV",
                   "ConvBPDNRecTV", "ConvProdDictBPDN",
                   "ConvProdDictBPDNJoint", "ConvProdDictL1L1Grd",
                   "ConvProdDictL1L1GrdJoint", "PPP", "PPPConsensus",
                   "PPPPGM", "SplineL1"]


@pytest.mark.parametrize("name", CSC_REST_MODELS)
def test_csc_rest_models_on_card_match_cpu(dev, name):
    """Each of the rest of the CSC models (one case per model of each
    family) in float64 on the card against the CPU over 10 iterations:
    every stats column rtol 1e-6 (a column at zero up to rounding, within
    1e-12 of its largest value, counts as equal) and the state within
    1e-8 of its scale."""
    make = _csc_rest_cases()[name]

    def leaves(v):
        return list(v) if isinstance(v, tuple) else [v]
    out = []
    for d in (dev, "cpu"):
        b = make(d)
        b.solve()
        out.append((_columns(b), [
            t.detach().cpu().numpy()
            for t in leaves(b.state.X) + leaves(b.state.Y)]))
    (cg, ag), (cc, ac) = out
    assert sorted(cg) == sorted(cc)
    for col in cg:
        g, c = np.asarray(cg[col], np.float64), np.asarray(cc[col],
                                                           np.float64)
        if col.endswith("XSlvRelRes"):
            np.testing.assert_allclose(g, c, rtol=0, atol=1e-10)
            continue
        floor = (1e-12 * np.nanmax(np.abs(c)) if np.isfinite(c).any()
                 else 0.0)
        near0 = np.maximum(np.abs(g), np.abs(c)) <= floor
        np.testing.assert_allclose(np.where(near0, 0, g),
                                   np.where(near0, 0, c), rtol=1e-6,
                                   equal_nan=True, err_msg=col)
    for g, c in zip(ag, ac):
        assert np.abs(g - c).max() <= 1e-8 * max(np.abs(c).max(), 1e-30)


# the stats columns held at 1e-3 in float32 (residuals), as the CPU tests
# of these models against the JAX package hold them
F32_RSDL = ("PrimalRsdl", "DualRsdl", "EPrimal", "EDual", "Cnstr", "Rsdl")


@pytest.mark.parametrize("name", [m for m in CSC_REST_MODELS
                                  if m != "SplineL1"])
def test_csc_rest_models_float32_through_kernels_match_cpu(dev, name):
    """Each of the rest of the CSC models but the spline (which runs no
    kernel) in float32 at 128x128, 10 iterations, on the card through
    the FFT kernels (and MultiDictConvBPDN's fused solve through
    ``csc_iter`` at Cd = 2) against the CPU's plain versions: the
    objective rows rtol 1e-4, the residuals 1e-3, the state within 2e-4
    of its scale (the float32 tolerances of the CPU tests against the
    JAX package)."""
    make = _csc_rest_cases("float32", 128)[name]

    def leaves(v):
        return list(v) if isinstance(v, tuple) else [v]
    out = []
    for d in (dev, "cpu"):
        b = make(d)
        tci.reset_launches()
        tfp.reset_launches()
        b.solve()
        if d is dev:
            assert tfp.LAUNCHES["rfft2_planar"] > 0
            assert tfp.LAUNCHES["irfft2_planar"] > 0
            assert tci.LAUNCHES["csc_iter"] == (
                10 if name == "MultiDictConvBPDN" else 0)
        out.append((_columns(b), [
            t.detach().cpu().numpy()
            for t in leaves(b.state.X) + leaves(b.state.Y)]))
    (cg, ag), (cc, ac) = out
    assert sorted(cg) == sorted(cc)
    for col in cg:
        if col.endswith("XSlvRelRes"):
            continue
        g, c = np.asarray(cg[col], np.float64), np.asarray(cc[col],
                                                           np.float64)
        rtol = 1e-3 if col in F32_RSDL else 1e-4
        np.testing.assert_allclose(g, c, rtol=rtol, atol=1e-30,
                                   equal_nan=True, err_msg=col)
    for g, c in zip(ag, ac):
        assert np.abs(g - c).max() <= 2e-4 * max(np.abs(c).max(), 1e-30)


# --- parallel/ and ParConvBPDN -------------------------------------------

@pytest.fixture
def nccl_mesh():
    """A world of one rank over NCCL in this process (``tcp://127.0.0.1``
    on a free port), its 1 x 1 mesh; destroyed after the test."""
    import socket
    import torch.distributed as dist
    from sporco_tpu_torch.parallel import launch
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    launch.initialize(f"tcp://127.0.0.1:{port}", 1, 0, local_rank=0)
    try:
        assert dist.get_backend() == "nccl"
        yield launch.global_mesh()
    finally:
        dist.destroy_process_group()


def _par_model(d, dtype, n, masked=False, mesh=None, iters=10):
    from sporco_tpu_torch.models.parcbpdn import ParConvBPDN
    rng = np.random.default_rng(13)
    npdt = np.float64 if dtype == torch.float64 else np.float32
    D = rng.standard_normal((5, 5, 8)).astype(npdt)
    S = rng.standard_normal((n, n)).astype(npdt)
    W = (rng.random((n, n)) > 0.3).astype(npdt) if masked else None
    return ParConvBPDN(D, S, 0.1, W=W, ngrp=4, dtype=dtype,
                       device=None if mesh is not None else d, mesh=mesh,
                       opt=ParConvBPDN.options(max_iter=iters,
                                               rel_stop_tol=0.0))


def _par_out(b):
    return b.getitstat()._arr.astype(np.float64), [
        b.state[i].detach().cpu().numpy() for i in (0, 2, 4, 5)]


@pytest.mark.parametrize("case", ["plain", "masked", "mesh"])
def test_parcbpdn_on_card_matches_cpu(dev, case, request):
    """ParConvBPDN in float64 at 32x32, 10 iterations, on the card (with
    ``mesh=``: its four groups on a world-size-1 NCCL mesh) against the
    CPU: every stats row rtol 1e-6, Y0, Y1, X and DX within 1e-8 of their
    scale."""
    mesh = request.getfixturevalue("nccl_mesh") if case == "mesh" else None
    out = []
    for d, m in ((dev, mesh), ("cpu", None)):
        b = _par_model(d, torch.float64, 32, case == "masked", m)
        b.solve()
        out.append(_par_out(b))
    (rg, ag), (rc, ac) = out
    np.testing.assert_allclose(rg, rc, rtol=1e-6, atol=1e-30)
    for g, c in zip(ag, ac):
        assert np.abs(g - c).max() <= 1e-8 * max(np.abs(c).max(), 1e-30)


def test_parcbpdn_float32_through_kernels_matches_cpu(dev):
    """ParConvBPDN in float32 at 128x128 (the FFT kernels' size), 10
    iterations: on the card ``rfft2_planar`` 2k + 1 and ``irfft2_planar``
    2k launches; against the CPU the objective rows rtol 1e-4, the
    residuals 1e-3, the state within 2e-4 of its scale."""
    out = []
    for d in (dev, "cpu"):
        b = _par_model(d, torch.float32, 128, masked=True)
        tfp.reset_launches()
        b.solve()
        if d is dev:
            torch.cuda.synchronize()
            assert tfp.LAUNCHES == {"rfft2_planar": 21, "irfft2_planar": 20}
        out.append(_par_out(b))
    (rg, ag), (rc, ac) = out
    for j in range(1, rg.shape[1]):
        rtol = 1e-3 if j in (4, 5, 6, 7) else 1e-4
        np.testing.assert_allclose(rg[:, j], rc[:, j], rtol=rtol, atol=1e-30)
    for g, c in zip(ag, ac):
        assert np.abs(g - c).max() <= 2e-4 * max(np.abs(c).max(), 1e-30)


@pytest.mark.parametrize("dtype,n", [(torch.float64, 32),
                                     (torch.float32, 128)])
def test_sharded_consensus_on_card_matches_cpu(dev, nccl_mesh, dtype, n):
    """The consensus loop on a world-size-1 NCCL mesh on the card (the
    consensus mean an NCCL all-reduce) against the unsharded loop on the
    CPU, 5 outer iterations: in float64 at 32x32 D within 1e-8 of its
    scale and the objective 1e-8 relative; in float32 at 128x128 through
    the kernels (``csc_iter`` once an outer iteration, the FFT kernels 4
    and 2) D and the objective within 1e-4."""
    from sporco_tpu_torch.parallel import consensus as tcn
    rng = np.random.default_rng(17)
    npdt = np.float64 if dtype == torch.float64 else np.float32
    D0 = rng.standard_normal((8, 8, 8)).astype(npdt)
    S = rng.standard_normal((n, n, 4)).astype(npdt)
    a = tcn.ConvBPDNDictLearn_Consensus(D0, S, 0.1, mesh=nccl_mesh,
                                        max_iter=5, dtype=dtype)
    c = tcn.ConvBPDNDictLearn_Consensus(D0, S, 0.1, max_iter=5, dtype=dtype,
                                        device="cpu")
    assert a.cfg.kernel_x == c.cfg.kernel_x == (dtype == torch.float32)
    tci.reset_launches()
    tfp.reset_launches()
    Da = a.solve().cpu().numpy()
    torch.cuda.synchronize()
    if dtype == torch.float32:
        assert tci.LAUNCHES["csc_iter"] == 5
        assert tfp.LAUNCHES == {"rfft2_planar": 20, "irfft2_planar": 10}
    Dc = c.solve().numpy()
    tol = 1e-8 if dtype == torch.float64 else 1e-4
    assert np.abs(Da - Dc).max() <= tol * np.abs(Dc).max()
    np.testing.assert_allclose(a.evaluate(), c.evaluate(), rtol=tol)


# ---------------------------------------------------------------------------
# The fused drivers' on-device loop: kernels that read their scalars and
# the flag live from device memory, dead launches, captured solves

def _bits(t):
    return t.detach().clone().view(torch.int32)


def _scalars(dev, *vals):
    return [torch.tensor(v, dtype=torch.float32, device=dev) for v in vals]


def _kernel_case(kernel, dev, geom, vectors):
    """(call, the buffers a launch may write): ``call(live, counter)``
    launches ``kernel`` with its changing scalars as 0-d device tensors,
    into buffers given by ``out``; ``call(None, None)`` with numbers."""
    if kernel == "admm_tail":
        R, C = geom
        PX, PY, PU, thr, wl1 = _tail_inputs(R, C, vectors, dev)
        sums = torch.full((6,), 3.0, device=dev)
        thr_t = thr if vectors else _scalars(dev, thr)[0]
        us_t, = _scalars(dev, 0.7)

        def call(live, cnt):
            if live is None:
                return tct.admm_tail(PX, PY, PU, thr, wl1, RLX, us=0.7,
                                     out=sums)
            return tct.admm_tail(PX, PY, PU, thr_t, wl1, RLX, us=us_t,
                                 live=live, counter=cnt, out=sums)
        return call, (PY, PU, sums)
    pos, C, T = geom
    G2, Y, U, Wa, Wf, thr, wl1 = _inputs(pos, C, T, vectors, dev)
    wf3 = tci.split_weight(Wf)
    R1 = torch.full((pos, T), 1.5, device=dev)
    R2 = torch.full((pos, T), float("nan"), device=dev)
    thr_t = thr if vectors else _scalars(dev, thr)[0]
    if kernel == "csc_iter":
        sums = torch.full((6,), 3.0, device=dev)
        a_t, b_t = _scalars(dev, US, SCALE)

        def call(live, cnt):
            if live is None:
                return tci.csc_iter(G2, Y, U, Wa, Wf, thr, wl1, RLX, US,
                                    SCALE, emit_px=False, wf_split=wf3,
                                    out=(R1, R2, sums))
            return tci.csc_iter(G2, Y, U, Wa, Wf, thr_t, wl1, RLX, a_t,
                                b_t, emit_px=False, wf_split=wf3,
                                live=live, counter=cnt, out=(R1, R2, sums))
        return call, (Y, U, R1, R2, sums)
    sums = torch.full((2,), 3.0, device=dev)
    a_t, b_t = _scalars(dev, RL, BETA)

    def call(live, cnt):
        if live is None:
            return tpi.pgm_iter(G2, Y, U, Wa, Wf, thr, wl1, RL, BETA,
                                wf_split=wf3, out=(R1, R2, sums))
        return tpi.pgm_iter(G2, Y, U, Wa, Wf, thr_t, wl1, a_t, b_t,
                            wf_split=wf3, live=live, counter=cnt,
                            out=(R1, R2, sums))
    return call, (Y, U, R1, R2, sums)


LOOP_KERNEL_CASES = [(k, g, v) for k, geoms in (
    ("csc_iter", [(64, 256, 256), (129, 131, 7), (4096, 4096, 256)]),
    ("pgm_iter", [(64, 256, 256), (129, 131, 7), (4096, 4096, 256)]),
    ("admm_tail", [(64, 256), (37, 4100), (4096, 4096)]))
    for g in geoms for v in (False, True)]


@pytest.mark.parametrize("kernel,geom,vectors", LOOP_KERNEL_CASES,
                         ids=[f"{k}-{g}-{'vec' if v else 'scalar'}"
                              for k, g, v in LOOP_KERNEL_CASES])
def test_dead_launch_writes_nothing_and_live_equals_numbers(dev, kernel,
                                                           geom, vectors):
    """With live = 0 the kernel writes nothing (every buffer's bits, the
    counter, the Python count unchanged); with live = 1 it gives the bits
    of a launch with the same scalars as numbers, and adds 1 to the
    counter only."""
    mod = {"csc_iter": tci, "pgm_iter": tpi, "admm_tail": tct}[kernel]
    call, bufs = _kernel_case(kernel, dev, geom, vectors)
    start = [b.clone() for b in bufs]
    before = [_bits(b) for b in bufs]
    cnt = torch.zeros(1, dtype=torch.int32, device=dev)
    mod.reset_launches()
    call(torch.tensor(False, device=dev), cnt)
    torch.cuda.synchronize()
    for a, b in zip(before, bufs):
        assert torch.equal(a, _bits(b))
    assert int(cnt.item()) == 0 and mod.LAUNCHES[kernel] == 0
    call(torch.tensor(True, device=dev), cnt)
    live = [b.clone() for b in bufs]
    assert int(cnt.item()) == 1 and mod.LAUNCHES[kernel] == 0
    for b, s in zip(bufs, start):
        b.copy_(s)
    call(None, None)
    assert mod.LAUNCHES[kernel] == 1
    for a, b in zip(live, bufs):
        assert torch.equal(_bits(a), _bits(b))


@pytest.mark.parametrize("kernel,geom,vectors", LOOP_KERNEL_CASES,
                         ids=[f"{k}-{g}-{'vec' if v else 'scalar'}"
                              for k, g, v in LOOP_KERNEL_CASES])
def test_live_launch_from_device_scalars_matches_plain(dev, kernel, geom,
                                                       vectors):
    """The kernel with its scalars and live = 1 from device memory
    against its plain version on the same tensors: 1e-5 of each
    output's largest magnitude (KERNEL_RTOL, as the cases above)."""
    call, bufs = _kernel_case(kernel, dev, geom, vectors)
    start = [b.clone() for b in bufs]
    call(torch.tensor(True, device=dev), None)
    got = [b.clone() for b in bufs]
    for b, s in zip(bufs, start):
        b.copy_(s)
    mod = {"csc_iter": (tci, "csc_iter_plain"),
           "pgm_iter": (tpi, "pgm_iter_plain"),
           "admm_tail": (tct, "admm_tail_plain")}[kernel]
    real = getattr(*mod)
    # the plain version on the same card tensors, through the wrapper's
    # own call (its arguments, its output buffers)
    wrapper = getattr(mod[0], kernel)

    def plain(*a, live=None, counter=None, wf_split=None, **k):
        return real(*a, live=live, **k)
    setattr(mod[0], kernel, plain)
    try:
        call(torch.tensor(True, device=dev), None)
    finally:
        setattr(mod[0], kernel, wrapper)
    for a, b in zip(got, bufs):
        scale = max(float(b.abs().max()), 1e-30)
        assert float((a - b).abs().max()) <= 1e-5 * scale


def _loop_problem(N=64, M=4, seed=0):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((8, 8, M)).astype(np.float32)
    D /= np.sqrt((D ** 2).sum(axis=(0, 1), keepdims=True))
    S = rng.standard_normal((N, N)).astype(np.float32)
    return D, S


def _loop_model(kind, dev, opt, N=64):
    D, S = _loop_problem(N)
    if kind == "fista":
        return tpgm.ConvBPDN(D, S, 0.05, device=dev,
                             opt=tpgm.ConvBPDN.options(L=50.0, **opt))
    if kind == "gradreg":
        return ConvBPDNGradReg(D, S, 0.05, mu=0.2, device=dev,
                               opt=ConvBPDNGradReg.options(**opt))
    return ConvBPDN(D, S, 0.05, device=dev, opt=ConvBPDN.options(**opt))


def _loop_tol(kind, k, N=64):
    """A stopping tolerance at which the CPU solve stops after k
    iterations, well away from every iteration's residual."""
    b = _loop_model(kind, "cpu", dict(max_iter=30, rel_stop_tol=0.0), N)
    b.solve()
    its = b.getitstat()
    m = (np.asarray(its.Rsdl) if kind == "fista"
         else np.maximum(its.PrimalRsdl, its.DualRsdl))
    lo, hi = m[k - 1], m[:k - 1].min()
    assert hi > 1.01 * lo
    return float(np.sqrt(lo * hi))


@pytest.mark.parametrize("kind", ["l1", "fista", "gradreg"])
def test_captured_solve_on_card_matches_cpu(dev, kind):
    """A fused solve that stops inside a block (19 iterations) as a
    captured CUDA graph on the card, against the same solve on the CPU:
    the same iterations, the rows at the CPU tests' tolerances, one host
    read a block and the final one, and the kernel's launch count equal
    to the live iterations."""
    from sporco_tpu_torch.ops import device_loop
    k = 19
    opt = dict(max_iter=50, rel_stop_tol=_loop_tol(kind, k))
    kernel = {"l1": (tci, "csc_iter"), "fista": (tpi, "pgm_iter"),
              "gradreg": (tct, "admm_tail")}[kind]
    kernel[0].reset_launches()
    a = _loop_model(kind, dev, opt)
    Xa = a.solve().cpu().numpy()
    assert int(a.state.k) == k
    assert kernel[0].LAUNCHES[kernel[1]] == k
    last = device_loop.LAST
    assert last["graph"] and last["live"] == k
    assert last["host_reads"] == -(-k // 8) + 1
    assert last["replays"] == 24
    b = _loop_model(kind, "cpu", opt)
    Xb = b.solve().numpy()
    assert int(b.state.k) == k
    assert np.abs(Xa - Xb).max() < 2e-4 * np.abs(Xb).max()
    ia, ib = a.getitstat(), b.getitstat()
    names = ("ObjFun", "DFid", "RegL1") + (() if kind == "fista"
                                           else ("Rho",))
    for name in names:
        np.testing.assert_allclose(getattr(ia, name), getattr(ib, name),
                                   rtol=1e-4, err_msg=name)
    for name in ("Rsdl",) if kind == "fista" else ("PrimalRsdl",
                                                   "DualRsdl"):
        np.testing.assert_allclose(getattr(ia, name), getattr(ib, name),
                                   rtol=1e-3, atol=1e-6, err_msg=name)


def _fft_launch(name, dev, ins, outs, b, n0, n1, live, cnt):
    """The FFT kernel ``name`` launched through its C interface on
    ``ins`` into ``outs`` (the outputs, then the scratch), with the gate
    ``live`` and the counter ``cnt`` (a one-element int32 tensor)."""
    key = tfp._dev_key(dev)
    err = getattr(tfp._lib(), f"{name}_launch")(
        *(t.data_ptr() for t in ins + outs),
        tfp._twiddles(n0, key).data_ptr(), tfp._twiddles(n1, key).data_ptr(),
        b, n0, n1, live.data_ptr(), cnt.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    assert err == 0


FFT_GATE_CASES = [(3, 128, 128), (2, 256, 126), (1, 512, 512)]


@pytest.mark.parametrize("b,n0,n1", FFT_GATE_CASES)
def test_fft_kernels_read_the_gate(dev, b, n0, n1):
    """Each FFT kernel with the device loop's gate: with live 0 it writes
    nothing (its outputs and its scratch keep their bits, the counter
    stays 0); with live 1 it gives the bits of the ungated wrapper's
    launch and adds 1 to the counter."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((b, n0, n1), generator=g, device=dev)
    k1 = n1 // 2 + 1
    yr, yi = tfp.rfft2_planar(x)
    xr = tfp.irfft2_planar(yr, yi, n1)
    y = torch.complex(yr, yi)
    xs = tfp.irfft2_spectrum(y, n1)

    def filled(*shape):
        return torch.full(shape, 7.0, device=dev)
    cases = {"rfft2_planar": ([x], [filled(*yr.shape), filled(*yi.shape)],
                              [yr, yi]),
             "irfft2_planar": ([yr, yi], [filled(*xr.shape),
                                          filled(2 * b * n0 * k1)], [xr]),
             "irfft2_spectrum": ([y], [filled(*xs.shape),
                                       filled(2 * b * n0 * k1)], [xs])}
    for name, (ins, outs, refs) in cases.items():
        cnt = torch.zeros(1, dtype=torch.int32, device=dev)
        before = [_bits(o) for o in outs]
        _fft_launch(name, dev, ins, outs, b, n0, n1,
                    torch.zeros((), device=dev), cnt)
        torch.cuda.synchronize()
        for a, o in zip(before, outs):
            assert torch.equal(a, _bits(o)), name
        assert int(cnt.item()) == 0, name
        _fft_launch(name, dev, ins, outs, b, n0, n1,
                    torch.ones((), device=dev), cnt)
        for r, o in zip(refs, outs):
            assert torch.equal(_bits(r), _bits(o)), name
        assert int(cnt.item()) == 1, name


def test_fft_gate_counts_on_the_device(dev):
    """Inside ``fft2_planar.gate`` the wrappers count their launches in
    the gate's counter, live ones only, and not in ``LAUNCHES``; the live
    launches give the ungated ones' bits."""
    g = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((2, 128, 128), generator=g, device=dev)
    tfp.reset_launches()
    yr0, yi0 = tfp.rfft2_planar(x)
    x0 = tfp.irfft2_planar(yr0, yi0, 128)
    xs0 = tfp.irfft2_spectrum(torch.complex(yr0, yi0), 128)
    assert tfp.LAUNCHES == {"rfft2_planar": 1, "irfft2_planar": 2}
    live = torch.ones((), device=dev)
    cnt = torch.zeros(2, dtype=torch.int32, device=dev)
    with tfp.gate(live, cnt):
        yr, yi = tfp.rfft2_planar(x)
        xb = tfp.irfft2_planar(yr, yi, 128)
        xs = tfp.irfft2_spectrum(torch.complex(yr, yi), 128)
        live.zero_()
        tfp.rfft2_planar(x)
        tfp.irfft2_planar(yr, yi, 128)
    assert tfp.LAUNCHES == {"rfft2_planar": 1, "irfft2_planar": 2}
    assert cnt.tolist() == [1, 2]
    for a, b in ((yr0, yr), (yi0, yi), (x0, xb), (xs0, xs)):
        assert torch.equal(_bits(a), _bits(b))
    with pytest.raises(ValueError):
        with tfp.gate(live, cnt[:1]):
            pass


@pytest.mark.parametrize("kind,fwd,inv", [("l1", 3, 1), ("gradreg", 3, 0)])
def test_captured_solve_counts_fft_launches_of_live_iterations(dev, kind,
                                                               fwd, inv):
    """A captured fused solve at a size the FFT kernels take (128 x 128)
    that stops inside a block: the FFT pair's launches are counted on the
    device, those of live iterations only (the set-up's, and l1's final
    x-step, by the wrappers), and the solve equals the CPU's."""
    from sporco_tpu_torch.ops import device_loop
    ks = [k for k in range(9, 16) if k % 8]
    b = _loop_model(kind, "cpu", dict(max_iter=30, rel_stop_tol=0.0), 128)
    b.solve()
    its = b.getitstat()
    m = np.maximum(its.PrimalRsdl, its.DualRsdl)
    k = next(k for k in ks if m[:k - 1].min() > 1.01 * m[k - 1])
    opt = dict(max_iter=50, rel_stop_tol=float(np.sqrt(
        m[k - 1] * m[:k - 1].min())))
    tfp.reset_launches()
    a = _loop_model(kind, dev, opt, 128)
    Xa = a.solve().cpu().numpy()
    assert int(a.state.k) == k
    last = device_loop.LAST
    assert last["graph"] and last["live"] == k and last["replays"] == 16
    assert tfp.LAUNCHES == {"rfft2_planar": k + fwd,
                            "irfft2_planar": k + inv}
    c = _loop_model(kind, "cpu", opt, 128)
    Xc = c.solve().numpy()
    assert int(c.state.k) == k
    assert np.abs(Xa - Xc).max() < 2e-4 * np.abs(Xc).max()
    np.testing.assert_allclose(a.getitstat().ObjFun, c.getitstat().ObjFun,
                               rtol=1e-4)


def test_eager_launches_with_numbers_wrap_the_pinned_ring(dev):
    """Eager launches that pass their scalars as numbers take slots of
    the pinned ring in turn: over more launches than it has slots, each
    with its own ``us``, each gives the bits of a launch with the same
    scalars as 0-d device tensors."""
    PX, PY, PU, thr, wl1 = _tail_inputs(64, 256, False, dev)
    start = (PY.clone(), PU.clone())
    n = 2 * tci._PinnedRing.SLOTS + 3
    got = []
    for i in range(n):
        PY.copy_(start[0])
        PU.copy_(start[1])
        got.append(torch.cat([t.clone().reshape(-1) for t in tct.admm_tail(
            PX, PY, PU, thr, wl1, RLX, us=0.5 + i / n)]))
    for i in range(n):
        PY.copy_(start[0])
        PU.copy_(start[1])
        us, thr_t = _scalars(dev, 0.5 + i / n, thr)
        want = torch.cat([t.reshape(-1) for t in tct.admm_tail(
            PX, PY, PU, thr_t, wl1, RLX, us=us,
            live=torch.tensor(True, device=dev))])
        assert torch.equal(_bits(got[i]), _bits(want)), i


# ---------------------------------------------------------------------------
# The generic ADMM and PGM drivers on the device loop

def _generic_data(seed=0, N=32):
    g = np.random.default_rng(seed)
    D = g.standard_normal((24, 40))
    x0 = np.zeros((40, 3))
    for k in range(3):
        x0[g.choice(40, 4, replace=False), k] = g.standard_normal(4)
    Sd = D @ x0 + 0.01 * g.standard_normal((24, 3))
    Dc = g.standard_normal((6, 6, 4))
    Dc /= np.sqrt((Dc ** 2).sum(axis=(0, 1), keepdims=True))
    Si = np.cumsum(np.cumsum(g.standard_normal((N, N)), 0), 1) / N
    Si += 0.1 * g.standard_normal((N, N))
    W = (g.random((N, N)) > 0.25).astype(np.float64)
    A = np.ones((3, 3)) / 9.0
    return D, Sd, Dc, Si, W, A


def _ppp_model(dev, dtype, opt):
    from sporco_tpu_torch.models import ppp
    _, _, _, Si, _, _ = _generic_data()
    s = torch.tensor(Si, dtype=dtype, device=dev)

    def f(x):
        return 0.5 * torch.sum((x - s) ** 2)

    def proxf(v, rho):
        return (s + rho * v) / (1.0 + rho)

    def proxg(v, rho):
        return torch.sign(v) * torch.clamp(v.abs() - 0.05 / rho, min=0.0)
    return ppp.PPP(Si.shape, f, proxf, proxg, dtype=dtype, device=dev,
                   opt=ppp.PPP.options(**opt))


def _generic_model(name, dev, dtype, opt):
    """A model of a generic driver's problem, ``name``, on ``dev``."""
    from sporco_tpu_torch.models import bpdn, cbpdn, pgm, rpca, tv
    D, Sd, Dc, Si, W, A = (a.astype(np.float32) if dtype == torch.float32
                           else a for a in _generic_data())
    kw = dict(dtype=dtype, device=dev)
    if name in ("BPDN", "BPDNJoint", "ElasticNet"):
        cls = getattr(bpdn, name)
        extra = {} if name == "BPDN" else {"mu": 0.05}
        return cls(D, Sd, 1e-2,
                   opt=cls.options(**opt), **extra, **kw)
    if name == "BPDNProjL1":
        return bpdn.BPDNProjL1(D, Sd, 2.0, opt=bpdn.BPDNProjL1.options(
            **opt), **kw)
    if name == "MinL1InL2Ball":
        return bpdn.MinL1InL2Ball(D, Sd, 0.05, opt=bpdn.MinL1InL2Ball
                                  .options(**opt), **kw)
    if name in ("TVL2Denoise", "TVL1Denoise"):
        cls = getattr(tv, name)
        return cls(Si, 0.2, opt=cls.options(**opt), **kw)
    if name in ("TVL2Deconv", "TVL1Deconv"):
        cls = getattr(tv, name)
        return cls(A, Si, 0.05, opt=cls.options(**opt), **kw)
    if name == "RobustPCA":
        return rpca.RobustPCA(Si, opt=rpca.RobustPCA.options(**opt), **kw)
    if name in ("ConvBPDN", "ConvElasticNet", "ConvBPDNGradReg"):
        cls = getattr(cbpdn, name)
        extra = {} if name == "ConvBPDN" else {"mu": 0.1}
        return cls(Dc, Si, 0.05, opt=cls.options(**opt), fused=False,
                   **extra, **kw)
    if name == "ConvBPDNMaskDcpl":
        return cbpdn.ConvBPDNMaskDcpl(Dc, Si, 0.05, W=W, opt=cbpdn
                                      .ConvBPDNMaskDcpl.options(**opt), **kw)
    if name == "FISTA":
        return pgm.ConvBPDN(Dc, Si, 0.05, fused=False, opt=pgm.ConvBPDN
                            .options(L=50.0, **opt), **kw)
    if name == "FISTAMask":
        return pgm.ConvBPDNMask(Dc, Si, 0.05, W=W, fused=False,
                                opt=pgm.ConvBPDNMask.options(L=50.0, **opt),
                                **kw)
    if name == "FISTABacktrack":
        return pgm.ConvBPDN(Dc, Si, 0.05, fused=False, opt=pgm.ConvBPDN
                            .options(L=0.5, backtrack="standard", **opt),
                            **kw)
    if name == "PGMBPDN":
        return pgm.BPDN(D, Sd, 1e-2, opt=pgm.BPDN.options(L=50.0, **opt),
                        **kw)
    if name == "PPP":
        return _ppp_model(dev, dtype, opt)
    raise ValueError(name)


GRAPH_PROBLEMS = ("BPDN", "BPDNJoint", "ElasticNet", "BPDNProjL1",
                  "MinL1InL2Ball", "TVL2Denoise", "TVL1Denoise",
                  "TVL2Deconv", "TVL1Deconv", "ConvBPDN", "ConvElasticNet",
                  "ConvBPDNGradReg", "ConvBPDNMaskDcpl", "FISTA",
                  "FISTAMask", "PGMBPDN", "PPP", "RobustPCA")


def _generic_arrays(b):
    out = []
    for n in ("X", "Y"):
        v = getattr(b.state, n)
        out += [t.cpu().numpy() for t in (v if isinstance(v, tuple)
                                          else (v,))]
    return out


@pytest.mark.parametrize("name", GRAPH_PROBLEMS)
def test_generic_graph_route_captures_and_matches_cpu(dev, name):
    """Each graph-route problem of the generic drivers, 12 iterations in
    float64: captured once as a CUDA graph and replayed in blocks (one
    host read a block and the final one), a second solve call replaying
    the kept loop; the rows equal the CPU's to 1e-6 and X and Y within
    1e-8 of their scale (``chip_smoke.py``'s float64 parity)."""
    from sporco_tpu_torch.ops import device_loop
    opt = dict(max_iter=12, rel_stop_tol=0.0)
    a = _generic_model(name, dev, torch.float64, opt)
    assert a.problem.route == "graph"
    a.solve()
    last = dict(device_loop.LAST)
    assert last["graph"] and last["route"] == "graph"
    assert last["live"] == 12 and last["host_reads"] == 3
    c = _generic_model(name, "cpu", torch.float64, opt)
    c.solve()
    ia, ic = a.getitstat(), c.getitstat()
    assert len(ia) == len(ic) == 12
    for n in ia._names:
        np.testing.assert_allclose(getattr(ia, n), getattr(ic, n),
                                   rtol=1e-6, atol=1e-12, err_msg=n)
    for x, y in zip(_generic_arrays(a), _generic_arrays(c)):
        assert np.abs(x - y).max() <= 1e-8 * max(np.abs(y).max(), 1e-12)
    # the next call of the same geometry replays the kept graph
    a.solve()
    assert device_loop.LAST["graph"] and not device_loop.LAST["captured"]
    assert int(a.state.k) == 24


def test_generic_convbpdn_float32_counts_fft_launches(dev):
    """The generic ConvBPDN in float32 at 128 x 128 (the FFT kernels'
    size) as a captured graph that stops inside a block: ``rfft2_planar``
    k + 2 and ``irfft2_planar`` k, counted on the device, and the rows
    equal the CPU's at the CPU tests' tolerances."""
    from sporco_tpu_torch.ops import device_loop
    D, S = _loop_problem(128)
    opt = dict(max_iter=13, rel_stop_tol=0.0)

    def make(d):
        return ConvBPDN(D, S, 0.05, fused=False, device=d,
                        opt=ConvBPDN.options(**opt))
    tfp.reset_launches()
    a = make(dev)
    a.solve()
    assert device_loop.LAST["graph"]
    assert tfp.LAUNCHES == {"rfft2_planar": 15, "irfft2_planar": 13}
    c = make("cpu")
    c.solve()
    ia, ic = a.getitstat(), c.getitstat()
    for n in ("ObjFun", "DFid", "RegL1", "Rho"):
        np.testing.assert_allclose(getattr(ia, n), getattr(ic, n),
                                   rtol=1e-4, err_msg=n)
    for n in ("PrimalRsdl", "DualRsdl"):
        np.testing.assert_allclose(getattr(ia, n), getattr(ic, n),
                                   rtol=1e-3, atol=1e-6, err_msg=n)


def _ccmod_cg(dev, max_iter=1):
    from sporco_tpu_torch.models import ccmod
    _, _, Dc, Si, _, _ = _generic_data()
    g = np.random.default_rng(4)
    X = g.standard_normal((32, 32, 1, 1, 4)) * (g.random((32, 32, 1, 1, 4))
                                                < 0.1)
    return ccmod.ConvCnstrMOD_CG(X, Si, (6, 6, 4), dimK=0,
                                 dtype=torch.float64, device=dev,
                                 opt=ccmod.ConvCnstrMOD_CG.options(
                                     max_iter=max_iter, rel_stop_tol=0.0))


def _eager_case(name, dev):
    """An eager-route model of ``name`` for one iteration and the named
    synchronising calls its route is declared for: (module, attribute)
    pairs."""
    from sporco_tpu_torch.models import ppp
    from sporco_tpu_torch.ops import device_loop
    from sporco_tpu_torch.ops import linalg as sl
    opt = dict(max_iter=1, rel_stop_tol=0.0)
    if name == "CCMOD-cg":
        # the CG d-step takes the graph route; declared eager, each CG
        # solve is a graph of its own that reads its iteration count
        b = _ccmod_cg(dev)
        b.problem = dataclasses.replace(b.problem, route="eager")
        return b, [(sl, "cg")]
    if name == "FISTABacktrack":
        # the line search is the graph route's; declared eager, each
        # trial's test is read through device_loop.while_
        b = _generic_model(name, dev, torch.float64, opt)
        b.problem = dataclasses.replace(b.problem, route="eager")
        return b, [(device_loop, "while_")]
    b = _ppp_model(dev, torch.float64, opt)
    prior = ppp.host_prior(lambda x: x)
    b2 = ppp.PPP(b.params["x0"].shape, lambda x: x.sum(),
                 lambda v, r: v, prior, dtype=torch.float64, device=dev,
                 opt=ppp.PPP.options(**opt))
    return b2, [(ppp, "_host_call")]


@pytest.mark.parametrize("name", ["CCMOD-cg", "FISTABacktrack",
                                  "PPP-host"])
def test_eager_route_syncs_only_in_its_named_call(dev, monkeypatch, name):
    """One iteration of each eager-route problem under
    ``torch.cuda.set_sync_debug_mode("error")``: nothing synchronises
    the device with the host but the named call that is the reason for
    its route (which runs with the mode off)."""
    from sporco_tpu_torch.ops import device_loop
    b, named = _eager_case(name, dev)
    assert b.problem.route == "eager"

    def quiet(fn):
        def call(*a, **k):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return fn(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
        return call
    for mod, attr in named:
        monkeypatch.setattr(mod, attr, quiet(getattr(mod, attr)))
    run = device_loop.run

    def strict_run(loop, *a, **k):
        step = loop.step

        def strict():
            torch.cuda.set_sync_debug_mode("error")
            try:
                return step()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        loop.step = strict
        try:
            return run(loop, *a, **k)
        finally:
            loop.step = step
    monkeypatch.setattr(device_loop, "run", strict_run)
    b.solve()
    assert device_loop.LAST["route"] == "eager"
    assert device_loop.LAST["live"] == 1 and not device_loop.LAST["graph"]


def test_rpca_eager_route_reason_svd_synchronises(dev):
    """Why the port's Robust PCA does not call ``torch.linalg.svd`` in its
    iteration (its SVD is ``ops/svd.py``'s Jacobi kernels), held on the
    card: ``torch.linalg.svd`` synchronises the device with the host to
    check its result, so under ``set_sync_debug_mode("error")`` it
    raises, and an iteration that called it could not be captured in a
    CUDA graph."""
    x = torch.randn(64, 48, device=dev)
    torch.linalg.svd(x, full_matrices=False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):
            torch.linalg.svd(x, full_matrices=False)
    finally:
        torch.cuda.set_sync_debug_mode(0)


# ---------------------------------------------------------------------------
# Robust PCA's x-step on the card: the Jacobi SVD (ops/svd.py,
# csrc/jacobi_svd.cu) and torch.linalg.qr, inside captures made under
# global mode (any synchronising call fails such a capture)

SVD_CASES = [((512, 512), torch.float32), ((512, 512), torch.float64),
             ((26, 512), torch.float32), ((26, 512), torch.float64),
             ((512, 26), torch.float64), ((48, 33), torch.float32),
             ((3, 7), torch.float64), ((2, 5, 9), torch.float32),
             ((4, 20000), torch.float64), ((30000, 8), torch.float32)]


@pytest.fixture
def global_capture(monkeypatch):
    """Every CUDA-graph capture begun in the test, the device loop's
    among them, under global mode: any synchronising call inside it, in
    any thread, fails the capture."""
    begin = torch.cuda.CUDAGraph.capture_begin

    def capture_begin(self, pool=None, capture_error_mode="global", **kw):
        return begin(self, pool=pool, capture_error_mode="global", **kw)
    monkeypatch.setattr(torch.cuda.CUDAGraph, "capture_begin",
                        capture_begin)


def _svd_within(a, u, s, vt, s_ref):
    """Singular values against ``s_ref`` of the largest, the product of
    ``a``'s norm and orthonormality (real or complex), each within 8 L
    eps (rows of length L; tests/test_torch_svd.py)."""
    lim = 8 * max(a.shape) * torch.finfo(a.dtype).eps
    k = min(a.shape)
    eye = torch.eye(k, dtype=a.dtype, device=a.device)
    assert float((s - s_ref).abs().max()) <= lim * float(s_ref[0])
    assert float(((u * s) @ vt - a).norm()) <= lim * float(a.norm())
    assert float((u.mH @ u - eye).abs().max()) <= lim
    assert float((vt @ vt.mH - eye).abs().max()) <= lim


@pytest.mark.parametrize("shape,dtype", SVD_CASES, ids=str)
def test_jacobi_svd_matches_plain_and_captures(dev, global_capture, shape,
                                               dtype):
    """The Jacobi SVD on the card against its plain version
    ``torch.linalg.svd`` and the kernels' own plain version
    ``jacobi_svd_plain`` on the card (8 L eps), rows too long for shared
    memory (4 x 20000 float64, 30000 x 8 float32) among the shapes; its
    "node" form captured under global mode inside
    ``device_loop._capture`` and replayed equals its "eager" form bit for
    bit; a batch is the stack of its matrices."""
    from sporco_tpu_torch.ops import device_loop
    from sporco_tpu_torch.ops import svd as tsvd
    a = torch.randn(shape, generator=torch.Generator().manual_seed(1),
                    dtype=dtype).to(dev)
    u, s, vt = tsvd.jacobi_svd(a)
    assert tsvd.LAST["form"] == "eager"
    ur, sr, vr = tsvd.svd_plain(a)
    _, sj, _ = tsvd.jacobi_svd_plain(a)
    for i in np.ndindex(*shape[:-2]):
        _svd_within(a[i], u[i], s[i], vt[i], sr[i])
        _svd_within(a[i], u[i], s[i], vt[i], sj[i])
    outs = [torch.empty_like(t) for t in (u, s, vt)]

    def step():
        for o, t in zip(outs, tsvd.jacobi_svd(a)):
            o.copy_(t)
    graph = device_loop._capture(step, dev)
    assert tsvd.LAST["form"] == "node"
    for o in outs:
        o.fill_(float("nan"))
    graph.replay()
    for o, t in zip(outs, (u, s, vt)):
        assert torch.equal(o, t)


def test_jacobi_svd_nan_gives_nan_without_a_host_read(dev, global_capture):
    """A NaN in the input gives NaN in every output, XLA's convention: in
    a replay of the "node" form with no synchronisation
    (``set_sync_debug_mode("error")``), and in the "eager" form; the next
    finite input is decomposed again."""
    from sporco_tpu_torch.ops import device_loop
    from sporco_tpu_torch.ops import svd as tsvd
    a = torch.randn(26, 512, generator=torch.Generator().manual_seed(2),
                    device="cpu").to(dev)
    ref = tsvd.jacobi_svd(a)
    bad = a.clone()
    bad[4, 9] = float("nan")
    x = a.clone()
    outs = [torch.empty_like(t) for t in ref]

    def step():
        for o, t in zip(outs, tsvd.jacobi_svd(x)):
            o.copy_(t)
    graph = device_loop._capture(step, dev)
    x.copy_(bad)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    for t in list(tsvd.jacobi_svd(bad)) + outs:
        assert bool(torch.isnan(t).all())
    x.copy_(a)
    graph.replay()
    for o, t in zip(outs, ref):
        assert torch.equal(o, t)


@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("shape", [(256, 256), (30000, 8)], ids=str)
def test_jacobi_svd_cluster_sizes_match_plain(dev, clusters, shape,
                                              cluster):
    """The kernels in clusters of every size the geometry may choose
    (``svd.geometry`` forced to that C by the ``clusters`` fixture; the
    route, shared or global, as ``shared_rows`` gives it) against
    ``torch.linalg.svd`` and the plain schedule at the same C, float64,
    within 8 L eps; the device's count of ``jac_round`` launches is the
    sweeps times the rounds a sweep."""
    from sporco_tpu_torch.ops import svd as tsvd
    clusters(cluster)
    a = torch.randn(shape, generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64).to(dev)
    tsvd.prepare(dev)
    torch.cuda.synchronize()
    tsvd.reset_launches()
    u, s, vt = tsvd.jacobi_svd(a)
    geo = tsvd.LAST["geometry"]
    sweeps = int(tsvd.LAST["status"][1])
    assert geo.C == cluster
    assert tsvd.launches(dev) == sweeps * (geo.Pp // geo.w - 1)
    _svd_within(a, u, s, vt, tsvd.svd_plain(a)[1])
    _svd_within(a, u, s, vt, tsvd.jacobi_svd_plain(a)[1])


def test_jacobi_svd_graded_rows_on_card(dev):
    """A float64 matrix whose row norms span 1e-6 to 1 (the rotations come
    from Gram matrices): the kernels within 8 L eps of
    ``torch.linalg.svd``, in as many sweeps as the plain schedule within
    one."""
    from sporco_tpu_torch.ops import svd as tsvd
    rng = np.random.default_rng(8)
    a = torch.tensor(rng.standard_normal((96, 300))
                     * np.logspace(-6, 0, 96)[:, None]).to(dev)
    u, s, vt = tsvd.jacobi_svd(a)
    sweeps = int(tsvd.LAST["status"][1])
    _svd_within(a, u, s, vt, tsvd.svd_plain(a)[1])
    tsvd.jacobi_svd_plain(a)
    assert abs(sweeps - tsvd.LAST["sweeps"]) <= 1


@pytest.mark.parametrize("rank", [None, 16], ids=["full", "randomized"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_prox_nuclear_captures_under_global_mode(dev, global_capture, rank,
                                                 dtype):
    """Robust PCA's x-step, ``prox_nuclear`` at 512 x 512 (full, or rank 16
    with its QRs), captured under global mode: its replay equals its
    eager call bit for bit, and a NaN input gives NaN with no
    synchronisation."""
    from sporco_tpu_torch.ops import device_loop
    from sporco_tpu_torch.ops import prox as tpx
    g = torch.Generator().manual_seed(4)
    v = torch.randn(512, 512, generator=g, dtype=dtype).to(dev)
    sk = (None if rank is None else
          torch.randn(512, rank + 10, generator=g, dtype=dtype).to(dev))
    ref = tpx.prox_nuclear(v, 20.0, rank=rank, sketch=sk)
    x = v.clone()
    outs = [torch.empty_like(t) for t in ref]

    def step():
        for o, t in zip(outs, tpx.prox_nuclear(x, 20.0, rank=rank,
                                               sketch=sk)):
            o.copy_(t)
    graph = device_loop._capture(step, dev)
    graph.replay()
    for o, t in zip(outs, ref):
        assert torch.equal(o, t)
    x[5, 6] = float("nan")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(bool(torch.isnan(o).all()) for o in outs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_qr_captures_under_global_mode(dev, dtype):
    """``torch.linalg.qr`` of the randomized form's 512 x 26 sketch
    (cuSOLVER's geqrf and orgqr, no status read on the host) captures
    under global mode; the replay equals the eager call bit for bit and
    a NaN input gives NaN."""
    y = torch.randn(512, 26, generator=torch.Generator().manual_seed(3),
                    dtype=dtype).to(dev)
    q_eager = torch.linalg.qr(y)[0]
    x = y.clone()
    q = torch.empty_like(q_eager)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="global"):
        q.copy_(torch.linalg.qr(x)[0])
    graph.replay()
    assert torch.equal(q, q_eager)
    x[7, 3] = float("nan")
    graph.replay()
    assert bool(torch.isnan(q).all())


def _rpca_case(d, dtype, rank):
    """The CPU tests' Robust PCA problem (tests/test_torch_rpca.py: 48 x 48,
    rank 3 plus 10% outliers) on device ``d``, to 1e-3; the randomized
    SVD of rank ``rank`` with a numpy sketch."""
    from sporco_tpu_torch.models import rpca
    rng = np.random.default_rng(0)
    L = rng.standard_normal((48, 3)) @ rng.standard_normal((3, 48))
    S = (L + (rng.random((48, 48)) > 0.9) * rng.standard_normal((48, 48))
         * 5).astype(np.float32)
    kw = {} if rank is None else {
        "svd_rank": rank,
        "sketch": np.random.default_rng(1).standard_normal((48, rank + 10))}
    return rpca.RobustPCA(S, dtype=dtype, device=d, **kw,
                          opt=rpca.RobustPCA.options(max_iter=200,
                                                     rel_stop_tol=1e-3))


@pytest.mark.parametrize("rank", [None, 6], ids=["full", "randomized"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_rpca_iteration_captures_under_global_mode(dev, global_capture,
                                                   rank, dtype):
    """Robust PCA on the graph route, its iteration captured under global
    mode (nothing in it synchronises with the host), exactly
    ``ceil(k / 8) + 1`` host reads and its SVD's sweeps counted on the
    device; against the CPU: float64 the same iterations, rows to 1e-6,
    X and Y within 1e-8 of their scale; float32 the iteration count
    within one and the last ObjFun to rtol 1e-4
    (tests/test_torch_rpca.py's tolerances)."""
    import math
    from sporco_tpu_torch.ops import device_loop
    device_loop.clear_cache()
    b = _rpca_case(dev, dtype, rank)
    assert b.problem.route == "graph"
    b.solve()
    last = dict(device_loop.LAST)
    k = int(b.state.k)
    assert last["graph"] and last["captured"] and last["route"] == "graph"
    assert last["host_reads"] == math.ceil(k / 8) + 1
    assert last["inner"] > 0
    c = _rpca_case("cpu", dtype, rank)
    c.solve()
    ib, ic = b.getitstat(), c.getitstat()
    if dtype == torch.float64:
        assert len(ib) == len(ic)
        for n in ib._names:
            np.testing.assert_allclose(getattr(ib, n), getattr(ic, n),
                                       rtol=1e-6, atol=1e-12, err_msg=n)
        for x, y in ((b.state.X, c.state.X), (b.state.Y, c.state.Y)):
            y = y.numpy()
            assert np.abs(x.cpu().numpy() - y).max() <= 1e-8 * np.abs(y).max()
    else:
        assert abs(len(ib) - len(ic)) <= 1
        np.testing.assert_allclose(ib.ObjFun[-1], ic.ObjFun[-1], rtol=1e-4)


# ---------------------------------------------------------------------------
# The complex form of the Jacobi SVD (csrc/jacobi_svd.cu jac_round_z) and
# complex Robust PCA on the graph route

CSVD_CASES = [((512, 512), torch.complex64), ((48, 33), torch.complex128),
              ((26, 512), torch.complex64), ((512, 26), torch.complex128),
              ((3, 7), torch.complex64), ((2, 5, 9), torch.complex128),
              ((100, 2000), torch.complex128), ((16, 12000), torch.complex64)]


def _crandn(shape, dtype, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.complex(torch.randn(shape, generator=g, dtype=torch.float64),
                         torch.randn(shape, generator=g,
                                     dtype=torch.float64)).to(dtype)


@pytest.mark.parametrize("shape,dtype", CSVD_CASES, ids=str)
def test_complex_jacobi_svd_matches_plain_and_captures(dev, global_capture,
                                                       shape, dtype):
    """The complex form on the card, in the clusters its geometry gives
    (C 3 at 512 x 512, 8 at 26 x 512, 13 at 100 x 2000; 16 x 12000 rows too
    long for any cluster's shared memory), against ``torch.linalg.svd``
    and the plain schedule on the card (8 L eps), the device's
    ``jac_round`` count the sweeps times the rounds; its "node" form
    captured under global mode and replayed equals its "eager" form bit
    for bit."""
    from sporco_tpu_torch.ops import device_loop
    from sporco_tpu_torch.ops import svd as tsvd
    a = _crandn(shape, dtype, 5).to(dev)
    tsvd.prepare(dev)
    torch.cuda.synchronize()
    tsvd.reset_launches()
    u, s, vt = tsvd.jacobi_svd(a)
    assert tsvd.LAST["form"] == "eager"
    geo = tsvd.LAST["geometry"]
    assert geo == tsvd.geometry(*shape[-2:], 16)
    assert geo.shared == (shape != (16, 12000))
    assert u.dtype == vt.dtype == dtype
    assert s.dtype == dtype.to_real()
    if len(shape) == 2:
        sweeps = int(tsvd.LAST["status"][1])
        assert tsvd.launches(dev) == sweeps * (geo.Pp // geo.w - 1)
    sr = tsvd.svd_plain(a)[1]
    sj = tsvd.jacobi_svd_plain(a)[1]
    lim = 8 * max(shape) * torch.finfo(dtype).eps
    for i in np.ndindex(*shape[:-2]):
        k = min(shape[-2:])
        eye = torch.eye(k, dtype=dtype, device=dev)
        for ref in (sr[i], sj[i]):
            assert float((s[i] - ref).abs().max()) <= lim * float(ref[0])
        rec = (u[i] * s[i]) @ vt[i] - a[i]
        assert float(rec.norm()) <= lim * float(a[i].norm())
        assert float((u[i].mH @ u[i] - eye).abs().max()) <= lim
        assert float((vt[i] @ vt[i].mH - eye).abs().max()) <= lim
    outs = [torch.empty_like(t) for t in (u, s, vt)]

    def step():
        for o, t in zip(outs, tsvd.jacobi_svd(a)):
            o.copy_(t)
    graph = device_loop._capture(step, dev)
    assert tsvd.LAST["form"] == "node"
    for o in outs:
        o.fill_(float("nan"))
    graph.replay()
    for o, t in zip(outs, (u, s, vt)):
        assert torch.equal(o, t)


@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 6, 8, 13, 16])
@pytest.mark.parametrize("shape", [(256, 192), (16, 12000)], ids=str)
def test_complex_jacobi_svd_cluster_sizes_match_plain(dev, clusters, shape,
                                                      cluster):
    """The complex form in clusters of sizes the geometry may choose, any
    from 1 to 16 (``svd.geometry`` forced to that C by the ``clusters``
    fixture; the route, shared or global, as ``shared_rows`` gives it at
    16-byte entries) against ``torch.linalg.svd`` and the plain schedule
    at the same C, complex128, within 8 L eps; the device's count of
    ``jac_round`` launches is the sweeps times the rounds a sweep."""
    from sporco_tpu_torch.ops import svd as tsvd
    clusters(cluster)
    a = _crandn(shape, torch.complex128, 3).to(dev)
    tsvd.prepare(dev)
    torch.cuda.synchronize()
    tsvd.reset_launches()
    u, s, vt = tsvd.jacobi_svd(a)
    geo = tsvd.LAST["geometry"]
    sweeps = int(tsvd.LAST["status"][1])
    assert geo.C == cluster
    assert geo.shared == tsvd.shared_rows(geo.L, geo.w, cluster, 16)
    assert tsvd.launches(dev) == sweeps * (geo.Pp // geo.w - 1)
    _svd_within(a, u, s, vt, tsvd.svd_plain(a)[1])
    _svd_within(a, u, s, vt, tsvd.jacobi_svd_plain(a)[1])


def test_complex_jacobi_svd_nan_gives_nan_without_a_host_read(
        dev, global_capture):
    """A NaN in either part of a complex input gives NaN in every output,
    in a replay of the "node" form with no synchronisation."""
    from sporco_tpu_torch.ops import device_loop
    from sporco_tpu_torch.ops import svd as tsvd
    a = _crandn((26, 512), torch.complex64, 6).to(dev)
    ref = tsvd.jacobi_svd(a)
    x = a.clone()
    outs = [torch.empty_like(t) for t in ref]

    def step():
        for o, t in zip(outs, tsvd.jacobi_svd(x)):
            o.copy_(t)
    graph = device_loop._capture(step, dev)
    x[4, 9] = complex(0.0, float("nan"))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert all(bool(torch.isnan(o).all()) for o in outs)
    x.copy_(a)
    graph.replay()
    for o, t in zip(outs, ref):
        assert torch.equal(o, t)


@pytest.mark.parametrize("rank", [None, 5], ids=["full", "randomized"])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
@pytest.mark.parametrize("shape", [(40, 24), (24, 40), (32, 32)],
                         ids=["tall", "wide", "square"])
def test_complex_prox_nuclear_on_card_matches_cpu(dev, global_capture,
                                                  shape, dtype, rank):
    """Complex ``prox_nuclear``, full and randomized (the same sketch), on
    the card against the CPU (``torch.linalg.svd`` there): X within 1e-10
    of its scale for complex128 and 1e-5 for complex64, the thresholded
    singular values likewise of the largest (the CPU tests' tolerances,
    ``tests/test_torch_rpca.py``); captured under global mode, its replay
    equals the eager call bit for bit."""
    from sporco_tpu_torch.ops import device_loop
    from sporco_tpu_torch.ops import prox as tpx
    rng = np.random.default_rng(3)
    m, n = shape
    v = sum(3.0 * rng.standard_normal((m, 4)) @ rng.standard_normal((4, n))
            * f + 0.3 * rng.standard_normal((m, n)) * f for f in (1, 1j))
    sv = np.linalg.svd(v, compute_uv=False)
    alpha = float(0.5 * (sv[5] + sv[6]))
    v = torch.tensor(v).to(dtype)
    sk = (None if rank is None else torch.tensor(
        rng.standard_normal((n, rank + 10))).to(dtype.to_real()))
    xc, sc = tpx.prox_nuclear(v, alpha, rank=rank, sketch=sk)
    xd, sd = tpx.prox_nuclear(v.to(dev), alpha, rank=rank,
                              sketch=None if sk is None else sk.to(dev))
    tol = 1e-10 if dtype == torch.complex128 else 1e-5
    assert xd.dtype == dtype and 0 < int((sc > 0).sum()) < sc.numel()
    assert float((xd.cpu() - xc).abs().max()) <= tol * float(xc.abs().max())
    assert float((sd.cpu() - sc).abs().max()) <= tol * float(sc[0])
    x = v.to(dev)
    skd = None if sk is None else sk.to(dev)
    outs = [torch.empty_like(t) for t in (xd, sd)]

    def step():
        for o, t in zip(outs, tpx.prox_nuclear(x, alpha, rank=rank,
                                               sketch=skd)):
            o.copy_(t)
    graph = device_loop._capture(step, dev)
    graph.replay()
    for o, t in zip(outs, (xd, sd)):
        assert torch.equal(o, t)


def _complex_rpca_case(d, dtype, rank):
    """A 48 x 40 complex matrix of rank 4 plus 10% complex outliers at
    scale 5 (``tests/test_torch_rpca.py``) on device ``d``, to 1e-3; the
    randomized SVD with a numpy sketch."""
    from sporco_tpu_torch.models import rpca
    rng = np.random.default_rng(5)

    def cn(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    S = cn(48, 4) @ cn(4, 40) + (rng.random((48, 40)) > 0.9) * cn(48, 40) * 5
    kw = {} if rank is None else {
        "svd_rank": rank,
        "sketch": np.random.default_rng(1).standard_normal((40, rank + 10))}
    return rpca.RobustPCA(S, dtype=dtype, device=d, **kw,
                          opt=rpca.RobustPCA.options(max_iter=200,
                                                     rel_stop_tol=1e-3))


@pytest.mark.parametrize("rank", [None, 6], ids=["full", "randomized"])
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128])
def test_complex_rpca_on_the_graph_route(dev, global_capture, rank, dtype):
    """Complex Robust PCA on the graph route, its iteration captured under
    global mode, exactly ``ceil(k / 8) + 1`` host reads, its SVD's sweeps
    counted on the device and the device's ``jac_round`` count a whole
    number of sweeps of its rounds; against the CPU: complex128 the same
    iterations, rows to 1e-6, X and Y within 1e-8 of their scale;
    complex64 the iteration count within one and the last ObjFun to
    rtol 1e-4; the stats rows real."""
    import math
    from sporco_tpu_torch.ops import device_loop
    from sporco_tpu_torch.ops import svd as tsvd
    device_loop.clear_cache()
    b = _complex_rpca_case(dev, dtype, rank)
    assert b.problem.route == "graph"
    torch.cuda.synchronize()
    tsvd.reset_launches()
    b.solve()
    last = dict(device_loop.LAST)
    k = int(b.state.k)
    assert last["graph"] and last["captured"] and last["route"] == "graph"
    assert last["host_reads"] == math.ceil(k / 8) + 1
    geo = tsvd.LAST["geometry"]
    rounds = geo.Pp // geo.w - 1
    assert last["inner"] > 0 and geo.C == 1
    assert tsvd.launches(dev) % rounds == 0
    assert tsvd.launches(dev) >= last["inner"] * rounds
    assert b.state.X.dtype == dtype
    c = _complex_rpca_case("cpu", dtype, rank)
    c.solve()
    ib, ic = b.getitstat(), c.getitstat()
    for n in ib._names:
        assert np.isrealobj(np.asarray(getattr(ib, n)))
    if dtype == torch.complex128:
        assert len(ib) == len(ic)
        for n in ib._names:
            np.testing.assert_allclose(getattr(ib, n), getattr(ic, n),
                                       rtol=1e-6, atol=1e-12, err_msg=n)
        for x, y in ((b.state.X, c.state.X), (b.state.Y, c.state.Y)):
            y = y.numpy()
            assert np.abs(x.cpu().numpy() - y).max() <= 1e-8 * np.abs(y).max()
    else:
        assert abs(len(ib) - len(ic)) <= 1
        np.testing.assert_allclose(ib.ObjFun[-1], ic.ObjFun[-1], rtol=1e-4)


def test_device_sync_synchronises_the_state_device(dev, monkeypatch):
    """``models.common.device_sync`` of a card model's state synchronises
    its device once."""
    from sporco_tpu_torch.models import common as tcm
    b = _complex_rpca_case(dev, torch.complex64, None)
    seen = []
    sync = torch.cuda.synchronize

    def record(d=None):
        seen.append(torch.device(d))
        sync(d)
    monkeypatch.setattr(torch.cuda, "synchronize", record)
    tcm.device_sync(b.state)
    assert len(seen) == 1 and seen[0].type == "cuda"


# ---------------------------------------------------------------------------
# The device loop's conditional blocks (IF nodes) and the loops on them

def test_if_node_skips_its_body(dev):
    """``device_loop.when`` inside a capture makes an IF node: at replay
    its body runs where the flag is true and not where it is false; a
    flat chain of nodes runs as many bodies as its flags allow."""
    from sporco_tpu_torch.ops import device_loop
    x = torch.zeros((), device=dev)
    pred = torch.zeros((), dtype=torch.bool, device=dev)
    g = device_loop._capture(
        lambda: device_loop.when(pred, lambda: x.add_(1.0)), dev)
    seen = []
    for flag in (True, False, False, True):
        pred.fill_(flag)
        g.replay()
        seen.append(float(x))
    assert seen == [1.0, 1.0, 1.0, 2.0]
    c = torch.zeros((), device=dev)
    lim = torch.zeros((), device=dev)
    go = torch.zeros((), dtype=torch.bool, device=dev)

    def body():
        c.add_(1.0)
        torch.lt(c, lim, out=go)

    def chain():
        body()
        for _ in range(9):
            device_loop.when(go, body)
    gc = device_loop._capture(chain, dev)
    for n, want in ((0, 1.0), (4, 4.0), (30, 10.0)):
        c.zero_()
        lim.fill_(n)
        gc.replay()
        assert float(c) == want


def _eager_run(monkeypatch):
    """Run every device loop of the test without a graph (the eager
    route, as a problem that declares it runs)."""
    from sporco_tpu_torch.ops import device_loop
    run = device_loop.run
    monkeypatch.setattr(device_loop, "run",
                        lambda *a, **k: run(*a, **{**k, "graph": False}))


@pytest.mark.parametrize("backtrack", ["standard", "robust"])
def test_backtracking_graph_route_matches_eager(dev, backtrack):
    """Generic FISTA with a line search in float64 at 32x32, 20
    iterations from L = 0.5: on the graph route (the search a WHILE node;
    no flag read, ceil(k / 8) + 1 host reads) against the same problem
    declared eager on the card: the same arithmetic, so the rows equal to
    the bit, ``IterBTrack`` equal."""
    from sporco_tpu_torch.models import pgm
    from sporco_tpu_torch.ops import device_loop
    _, _, Dc, Si, _, _ = _generic_data()
    runs = []
    for route in ("graph", "eager"):
        b = pgm.ConvBPDN(Dc, Si, 0.05, fused=False, dtype=torch.float64,
                         device=dev, opt=pgm.ConvBPDN.options(
                             L=0.5, backtrack=backtrack, max_iter=20,
                             rel_stop_tol=0.0))
        if route == "eager":
            b.problem = dataclasses.replace(b.problem, route="eager")
        b.solve()
        last = dict(device_loop.LAST)
        assert last["route"] == route and last["host_reads"] == 4
        assert (last["flag_reads"] == 0) == (route == "graph")
        runs.append(b.getitstat())
    g, e = runs
    assert g.IterBTrack.max() > 1
    np.testing.assert_array_equal(g.IterBTrack, e.IterBTrack)
    for n in g._names:
        np.testing.assert_array_equal(getattr(g, n), getattr(e, n),
                                      err_msg=n)


def _cg_problem(kind, dev):
    """``(solve, b)`` of a cg solve on ``dev``, ``solve(keyed)`` giving
    cg's ``(x, k)`` (with ``key`` where ``keyed``): the circulant
    operator of ``tests/test_torch_device_blocks.py`` (float64, 64
    points, tol 1e-10); the small ``solvemdbi_cg`` system of three
    signals (complex128, tol 1e-10, which passes its own key); or the CCMOD x-step's
    ``solvemdbi_cg`` operator at the consensus geometry (40 signals of
    128x128, 32 filters; complex64, as the float32 d-step solves it, tol
    1e-4)."""
    from sporco_tpu_torch.ops import linalg as tla
    g = np.random.default_rng(5)
    if kind == "circulant":
        d = torch.tensor(g.uniform(1.5, 3.0, 64), device=dev)
        b = torch.tensor(g.standard_normal(64), device=dev)

        def aop(u):
            return d * u - 0.5 * (u.roll(1) + u.roll(-1))
        key = ("circulant", d.data_ptr())
        return (lambda keyed: tla.cg(aop, b, tol=1e-10,
                                     key=key if keyed else None)), b
    if kind == "solvemdbi":
        shape = (3, 1, 4, 6, 4)
        ah = torch.tensor(g.standard_normal(shape) + 1j * g.standard_normal(
            shape), device=dev)
        b = torch.tensor(g.standard_normal((1, 3, 4, 6, 4)) + 1j
                         * g.standard_normal((1, 3, 4, 6, 4)), device=dev)
        return (lambda keyed: tla.solvemdbi_cg(ah, 1.5, b, 2, 0,
                                               tol=1e-10)), b
    shape = (40, 1, 32, 128, 65)
    ah = torch.tensor(g.standard_normal(shape) * (g.random(shape) < 0.3)
                      + 1j * g.standard_normal(shape), dtype=torch.complex64,
                      device=dev)
    b = torch.tensor(g.standard_normal(shape[1:]) + 1j * g.standard_normal(
        shape[1:]), dtype=torch.complex64, device=dev)[None]
    rho = torch.full((), 40.0, device=dev)
    a = ah.conj()

    def aop(u):
        return rho * u + torch.sum(a * tla.inner(ah, u, axis=2), dim=0,
                                   keepdim=True)
    key = ("ccmod", ah.data_ptr(), rho.data_ptr())
    return (lambda keyed: tla.cg(aop, b, tol=1e-4,
                                 key=key if keyed else None)), b


@pytest.mark.parametrize("kind", ["circulant", "solvemdbi", "ccmod"])
def test_cg_blocks_graph_matches_eager_on_card(dev, monkeypatch, kind):
    """``cg`` on the card in its three forms on the same operator: inside
    a capture (a WHILE node; k stays on the device), a graph of its own
    (one read, a second call replaying the kept graph) and the eager
    blocks of 8 (their tests read on the host, as on the CPU): the same
    arithmetic, so the same iteration count and x to the bit.  In
    float64 at tol 1e-10 the CPU gives the same count and x within 1e-10
    of its scale (the card's reductions sum in another order, which 40
    CG iterations carry to 2e-11 on an H100)."""
    from sporco_tpu_torch.ops import device_loop
    from sporco_tpu_torch.ops import linalg as tla
    solve, b = _cg_problem(kind, dev)
    out = {}
    x_node = torch.empty_like(b)
    k_node = torch.zeros((), dtype=torch.int64, device=dev)

    def captured():
        x, k = solve(False)
        x_node.copy_(x)
        k_node.copy_(k)
    graph = device_loop._capture(captured, dev)
    assert tla.CG_LAST["form"] == "node" and tla.CG_LAST["host_reads"] == 0
    graph.replay()
    out["node"] = (x_node.clone(), int(k_node))
    tla._CG_KEPT.clear()
    for _ in range(2):
        out["graph"] = solve(True)
        assert tla.CG_LAST["form"] == "graph"
        assert tla.CG_LAST["host_reads"] == 1
    assert tla.CG_LAST["kept"]
    monkeypatch.setattr(tla, "_cg_form", lambda b: "blocks")
    out["blocks"] = solve(False)
    k = out["blocks"][1]
    assert tla.CG_LAST["host_reads"] == max(1, -(-k // 8)) and k > 8
    for form in ("node", "graph"):
        assert out[form][1] == k, form
        assert torch.equal(out[form][0], out["blocks"][0]), form
    if kind == "ccmod":
        return
    monkeypatch.undo()
    solve_cpu, _ = _cg_problem(kind, "cpu")
    xc, kc = solve_cpu(False)
    assert tla.CG_LAST["form"] == "blocks" and kc == k
    xc, xg = xc.numpy(), out["blocks"][0].cpu().numpy()
    assert np.abs(xg - xc).max() <= 1e-10 * np.abs(xc).max()


@pytest.mark.parametrize("lim", [0, 1, 7, 1000])
def test_while_node_runs_its_body_n_times(dev, lim):
    """``device_loop.while_`` inside a capture makes a WHILE node: at each
    replay it runs its body as many times as the flag, set from a limit
    written before the replay, allows; one graph serves every limit."""
    from sporco_tpu_torch.ops import device_loop
    c = torch.zeros((), device=dev)
    n = torch.zeros((), device=dev)
    go = torch.zeros((), dtype=torch.bool, device=dev)

    def body():
        c.add_(1.0)
        torch.lt(c, n, out=go)

    def loop():
        torch.lt(c, n, out=go)
        device_loop.while_(go, body)
    graph = device_loop._capture(loop, dev)
    for m in (lim, 3, lim):
        c.zero_()
        n.fill_(m)
        graph.replay()
        assert float(c) == m


def test_while_node_nests_with_if_nodes(dev):
    """A WHILE node in an IF node's body and an IF node in a WHILE body
    both run as their flags say at replay."""
    from sporco_tpu_torch.ops import device_loop
    c = torch.zeros((), device=dev)
    odd = torch.zeros((), device=dev)
    n = torch.zeros((), device=dev)
    on = torch.zeros((), dtype=torch.bool, device=dev)
    go = torch.zeros((), dtype=torch.bool, device=dev)

    def body():
        c.add_(1.0)
        device_loop.when(torch.remainder(c, 2.0) == 1.0,
                         lambda: odd.add_(1.0))
        torch.lt(c, n, out=go)

    def outer():
        torch.lt(c, n, out=go)
        device_loop.while_(go, body)
    graph = device_loop._capture(lambda: device_loop.when(on, outer), dev)
    for flag, m, want in ((True, 5, (5, 3)), (False, 5, (0, 0)),
                          (True, 0, (0, 0)), (True, 8, (8, 4))):
        c.zero_()
        odd.zero_()
        on.fill_(flag)
        n.fill_(m)
        graph.replay()
        assert (float(c), float(odd)) == want


def test_line_search_of_200_trials_stays_on_the_graph_route(dev):
    """FISTA with ``bt_maxiter`` 200 (past the 64 that once sent it to
    the eager route) from L = 0.05 at 32x32 in float64: one capture, no
    flag read, ceil(k / 8) + 1 host reads; its rows, ``IterBTrack`` and
    launches equal the same problem's declared eager."""
    from sporco_tpu_torch.models import pgm
    from sporco_tpu_torch.ops import device_loop
    _, _, Dc, Si, _, _ = _generic_data()
    runs = []
    for route in ("graph", "eager"):
        b = pgm.ConvBPDN(Dc, Si, 0.05, fused=False, dtype=torch.float64,
                         device=dev, opt=pgm.ConvBPDN.options(
                             L=0.05, backtrack="standard", bt_maxiter=200,
                             max_iter=12, rel_stop_tol=0.0))
        if route == "eager":
            b.problem = dataclasses.replace(b.problem, route="eager")
        b.solve()
        last = dict(device_loop.LAST)
        assert last["route"] == route and last["host_reads"] == 3
        assert (last["flag_reads"] == 0) == (route == "graph")
        runs.append(b.getitstat())
    g, e = runs
    assert g.IterBTrack.max() > 1
    for n in g._names:
        np.testing.assert_array_equal(getattr(g, n), getattr(e, n),
                                      err_msg=n)


@pytest.mark.parametrize("kind", ["ccmod", "ccmodmd"])
def test_cg_d_step_graph_route_matches_eager_on_card(dev, kind):
    """The CG d-steps on the graph route (their ADMM iteration one
    captured graph with a WHILE node of CG iterations: no CG read,
    ceil(k / 8) + 1 host reads) against the same problems declared eager
    (a CG graph and one read a solve) in float64: the same arithmetic,
    so rows and D to the bit and the same count of CG iterations."""
    from sporco_tpu_torch.ops import device_loop
    from sporco_tpu_torch.ops import linalg as tla
    out = []
    for route in ("graph", "eager"):
        device_loop.clear_cache()
        if kind == "ccmod":
            b = _ccmod_cg(dev, 20)
        else:
            b = _new_model_cases()[0]["ccmodmd cg"](dev)
        if route == "eager":
            b.problem = dataclasses.replace(b.problem, route="eager")
        reads = []
        cg = tla.cg

        def counted(*a, **k):
            res = cg(*a, **k)
            reads.append(tla.CG_LAST["host_reads"])
            return res
        tla.cg = counted
        try:
            b.solve()
        finally:
            tla.cg = cg
        last = dict(device_loop.LAST)
        k = len(b.getitstat())
        assert last["route"] == route and last["inner"] > k
        assert last["host_reads"] == -(-k // 8) + 1
        assert set(reads) == ({0} if route == "graph" else {1})
        out.append((b.getitstat(), b.getdict().cpu().numpy(),
                    last["inner"]))
    (ig, dg, ng), (ie, de, ne) = out
    assert ng == ne
    np.testing.assert_array_equal(dg, de)
    for n in ig._names:
        np.testing.assert_array_equal(getattr(ig, n), getattr(ie, n),
                                      err_msg=n)


@pytest.mark.parametrize("masked", [False, True])
def test_parcbpdn_graph_matches_eager_on_card(dev, monkeypatch, masked):
    """ParConvBPDN in float64 at 32x32, 13 iterations: its captured loop
    (ceil(k / 8) + 1 host reads) against the same loop run eagerly on the
    card: every row to 1e-6, the arrays within 1e-12 of their scale."""
    from sporco_tpu_torch.ops import device_loop
    out = []
    for eager in (False, True):
        if eager:
            _eager_run(monkeypatch)
        b = _par_model(dev, torch.float64, 32, masked, iters=13)
        b.solve()
        assert device_loop.LAST["graph"] == (not eager)
        assert device_loop.LAST["host_reads"] == 3
        out.append(_par_out(b))
    (rg, ag), (re_, ae) = out
    np.testing.assert_allclose(rg, re_, rtol=1e-6, atol=1e-30)
    for g, e in zip(ag, ae):
        assert np.abs(g - e).max() <= 1e-12 * max(np.abs(e).max(), 1e-30)


def test_nsharded_graph_matches_eager_on_card(dev, nccl_mesh, monkeypatch):
    """The row-sharded solvers on a world-size-1 NCCL mesh in float64:
    their captured loops (the ``all_to_all_single`` and ``all_reduce`` in
    the graph; ceil(k / 8) + 1 host reads) against the same loops run
    eagerly: the same iterations, the CSC rows to 1e-6, X within 1e-12
    of its scale."""
    from sporco_tpu_torch.models.cbpdn import ConvBPDN as CB
    from sporco_tpu_torch.models.tv import TVL2Deconv
    from sporco_tpu_torch.ops import device_loop
    from sporco_tpu_torch.parallel import spatial
    _, _, Dc, Si, _, A = _generic_data()
    out = []
    for eager in (False, True):
        if eager:
            _eager_run(monkeypatch)
        Xt, kt, r, s = spatial.tvl2deconv_nsharded(
            A, Si, 0.05, nccl_mesh, dtype=torch.float64,
            opt=TVL2Deconv.options(max_iter=40, rel_stop_tol=1e-3))
        assert device_loop.LAST["graph"] == (not eager)
        assert device_loop.LAST["host_reads"] == -(-kt // 8) + 1
        Xc, stats, kc = spatial.cbpdn_nsharded(
            Dc, Si, 0.05, nccl_mesh, dtype=torch.float64,
            opt=CB.options(max_iter=40, rel_stop_tol=1e-3))
        assert device_loop.LAST["host_reads"] == -(-kc // 8) + 1
        out.append((Xt.cpu().numpy(), kt, Xc.cpu().numpy(), stats, kc))
    (xg, kg, cg, sg, lg), (xe, ke, ce, se, le) = out
    assert kg == ke and lg == le
    assert np.abs(xg - xe).max() <= 1e-12 * np.abs(xe).max()
    assert np.abs(cg - ce).max() <= 1e-12 * max(np.abs(ce).max(), 1e-30)
    np.testing.assert_allclose(sg, se, rtol=1e-6, atol=1e-30)
