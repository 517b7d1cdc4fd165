"""Tests of the port that need a CUDA card; each skips without one.

They import no JAX, so they also run where JAX is not installed, with
the suite's conftest (which imports JAX) left out:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import numpy as np
import pytest
import torch

from sporco_tpu_torch.models import pgm as tpgm
from sporco_tpu_torch.models.cbpdn import ConvBPDN
from sporco_tpu_torch.ops import csc_iter as tci
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
             nonneg=nonneg, emit_px=emit_px)
    return [None if o is None else o.cpu() for o in out]


# (pos, C, T): the small slice geometry, then ragged edges of every tile
# size and a single element
GEOMS = [(64, 256, 256), (100, 200, 60), (129, 131, 7), (1, 3, 1)]


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
    out = tci.csc_iter(G2, Yo, Uo, Wa, Wf, thr, wl1, RLX, US, SCALE)
    for a, b in zip(out[1:], ref[1:]):
        assert float((a.cpu() - b).abs().max()) <= \
            1e-5 * float(b.abs().max())


def test_counts_launches_and_updates_in_place(dev):
    args = _inputs(64, 256, 256, False, dev)
    G2, Y, U, Wa, Wf, thr, wl1 = args
    tci.reset_launches()
    _, yn, un, _, _, _ = tci.csc_iter(G2, Y, U, Wa, Wf, thr, wl1, RLX, US,
                                      SCALE, emit_px=False)
    assert tci.LAUNCHES["csc_iter"] == 1
    assert yn is Y and un is U


def test_rejects_what_it_does_not_take(dev):
    G2, Y, U, Wa, Wf, thr, wl1 = _inputs(64, 256, 256, False, dev)
    with pytest.raises(ValueError):
        tci.csc_iter(G2, Y, U, Wa.cpu(), Wf, thr, wl1, RLX, US, SCALE)
    with pytest.raises(TypeError):
        tci.csc_iter(G2.double(), Y, U, Wa, Wf, thr, wl1, RLX, US, SCALE)
    with pytest.raises(ValueError):
        tci.csc_iter(G2, Y, Y, Wa, Wf, thr, wl1, RLX, US, SCALE)
    with pytest.raises(ValueError):
        tci.csc_iter(G2, Y.t(), U, Wa, Wf, thr, wl1, RLX, US, SCALE)


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
             nonneg=nonneg)
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
    out = tpi.pgm_iter(G2, Yo, Xo, Wa, Wf, thr, wl1, RL, BETA)
    for a, b in zip(out, ref):
        assert float((a.cpu() - b).abs().max()) <= \
            1e-5 * float(b.abs().max())


def test_pgm_counts_launches_and_updates_in_place(dev):
    G2, Y, Xprv, Wa, Wf, thr, wl1 = _pgm_inputs(64, 256, 256, False, dev)
    tpi.reset_launches()
    x, yn, _, _, _ = tpi.pgm_iter(G2, Y, Xprv, Wa, Wf, thr, wl1, RL, BETA)
    assert tpi.LAUNCHES["pgm_iter"] == 1
    assert x is Xprv and yn is Y
    tpi.pgm_iter_plain(G2, Y, Xprv, Wa, Wf, thr, wl1, RL, BETA)
    assert tpi.LAUNCHES["pgm_iter"] == 1
    with pytest.raises(ValueError):
        tpi.pgm_iter(G2, Y, Y, Wa, Wf, thr, wl1, RL, BETA)
    with pytest.raises(TypeError):
        tpi.pgm_iter(G2.double(), Y, Xprv, Wa, Wf, thr, wl1, RL, BETA)
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
