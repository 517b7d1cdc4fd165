"""Tests of the port that need a CUDA card; each skips without one.

They import no JAX, so they also run where JAX is not installed, with
the suite's conftest (which imports JAX) left out:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

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
# size, a single element, and the headline problem's packed geometry
GEOMS = [(64, 256, 256), (100, 200, 60), (129, 131, 7), (1, 3, 1),
         (4096, 4096, 256)]


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
