"""The port's ADMM tail (``sporco_tpu_torch.ops.csc_tail``) on the CPU, as
its plain PyTorch version, against the JAX package's Pallas
``admm_tail`` in interpret mode on the same numpy inputs, and the
wrapper's device rules.

Tolerances: PYn and PUn within 1e-6 of their largest magnitude (both
compute the same float32 expression per element; only the contraction
of ``rlx*PX + (1-rlx)*PY`` may round differently), the six sums to 1e-5
relative (float32 sums in different orders over up to 131072
elements).
"""

import numpy as np
import pytest
import torch
import jax

from sporco_tpu.ops import pallas_csc_tail as ptail
from sporco_tpu_torch.ops import csc_tail as tct

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def interpret():
    prev = ptail.interpret
    ptail.interpret = True
    try:
        yield
    finally:
        ptail.interpret = prev
        jax.clear_caches()


def _inputs(R, C, seed=0):
    rng = np.random.default_rng(seed)
    PX = rng.standard_normal((R, C)).astype(np.float32)
    PY = (rng.standard_normal((R, C))
          * (rng.random((R, C)) < 0.3)).astype(np.float32)
    PU = (0.1 * rng.standard_normal((R, C))).astype(np.float32)
    thr_v = (0.2 + 0.6 * rng.random(C)).astype(np.float32)
    wl1_v = (0.5 + rng.random(C)).astype(np.float32)
    return PX, PY, PU, thr_v, wl1_v


@pytest.mark.parametrize("R,C", [(64, 128), (256, 512)])
@pytest.mark.parametrize("vectors", [False, True])
@pytest.mark.parametrize("nonneg", [False, True])
@pytest.mark.parametrize("us", [1.0, 0.7])
def test_plain_matches_jax_kernel(interpret, R, C, vectors, nonneg, us):
    PX, PY, PU, thr_v, wl1_v = _inputs(R, C, seed=R + C)
    thr, wl1 = (thr_v, wl1_v) if vectors else (np.float32(0.45),
                                                np.float32(1.3))
    rlx = 1.8
    jyn, jun, jsums = ptail.admm_tail(PX, PY, PU, thr, wl1, rlx,
                                      nonneg=nonneg, us=us)
    tPY, tPU = torch.tensor(PY), torch.tensor(PU)
    tthr, twl1 = ((torch.tensor(thr_v), torch.tensor(wl1_v)) if vectors
                  else (float(thr), float(wl1)))
    yn, un, sums = tct.admm_tail_plain(torch.tensor(PX), tPY, tPU, tthr,
                                       twl1, rlx, nonneg=nonneg, us=us)
    assert yn is tPY and un is tPU
    for got, ref in ((yn, jyn), (un, jun)):
        ref = np.asarray(ref)
        err = np.abs(got.numpy() - ref).max()
        assert err <= 1e-6 * np.abs(ref).max()
    assert (yn.numpy() == 0).mean() > 0.1       # the threshold bites
    if nonneg:
        assert (yn.numpy() >= 0).all()
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), rtol=1e-5)


def test_wrapper_runs_plain_version_on_cpu():
    PX, PY, PU, thr_v, wl1_v = _inputs(37, 192, seed=5)
    tct.reset_launches()
    a = [torch.tensor(v) for v in (PX, PY, PU)]
    b = [torch.tensor(v) for v in (PX, PY, PU)]
    out_w = tct.admm_tail(a[0], a[1], a[2], torch.tensor(thr_v),
                          torch.tensor(wl1_v), 1.8, us=0.9)
    out_p = tct.admm_tail_plain(b[0], b[1], b[2], torch.tensor(thr_v),
                                torch.tensor(wl1_v), 1.8, us=0.9)
    for g, r in zip(out_w, out_p):
        torch.testing.assert_close(g, r, rtol=0, atol=0)
    assert tct.LAUNCHES == {"admm_tail": 0}


def test_wrapper_takes_packed_shapes():
    """The packed state (K, p0, p1, C) is taken as (K*p0*p1, C)."""
    PX, PY, PU, thr_v, wl1_v = _inputs(32, 256, seed=6)
    shp = (2, 4, 4, 256)
    a = [torch.tensor(v).reshape(shp) for v in (PX, PY, PU)]
    b = [torch.tensor(v) for v in (PX, PY, PU)]
    yn, un, s = tct.admm_tail(*a, 0.3, torch.tensor(wl1_v), 1.5)
    yn2, un2, s2 = tct.admm_tail(*b, 0.3, torch.tensor(wl1_v), 1.5)
    assert yn.shape == shp
    torch.testing.assert_close(yn.reshape(32, 256), yn2, rtol=0, atol=0)
    torch.testing.assert_close(s, s2, rtol=0, atol=0)


def test_non_cpu_tensors_never_take_the_plain_version():
    m = torch.empty((8, 128), device="meta")
    tct.reset_launches()
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tct.admm_tail(m, m, m, 0.1, 1.0, 1.8)
    assert tct.LAUNCHES == {"admm_tail": 0}


def test_per_channel_vectors_must_match_C():
    PX, PY, PU, _, _ = _inputs(8, 128)
    t = [torch.tensor(v) for v in (PX, PY, PU)]
    with pytest.raises(ValueError, match=r"shape \(128,\)"):
        tct.admm_tail(*t, torch.ones(64), 1.0, 1.8)


def _tail_f64(PX, PY, PU, thr, wl1, rlx, nonneg, us):
    """The tail in float64 numpy, written from its definition."""
    PX, PY, PU = (np.asarray(a, np.float64) for a in (PX, PY, PU))
    ax = rlx * PX + (1.0 - rlx) * PY
    v = ax + us * PU
    yn = np.sign(v) * np.maximum(np.abs(v) - thr, 0.0)
    if nonneg:
        yn = np.maximum(yn, 0.0)
    un = us * PU + ax - yn
    sums = [((PX - yn) ** 2).sum(), ((yn - PY) ** 2).sum(), (PX ** 2).sum(),
            (yn ** 2).sum(), (un ** 2).sum(), np.abs(wl1 * PX).sum()]
    return yn, un, np.array(sums)


@pytest.mark.parametrize("R,C", [(37, 4100), (100, 192), (7, 3), (1, 1)])
@pytest.mark.parametrize("vectors", [False, True])
@pytest.mark.parametrize("nonneg", [False, True])
def test_plain_at_ragged_shapes_matches_float64(R, C, vectors, nonneg):
    """At the shapes the JAX kernel's TPU blocks do not take, and which
    the card's kernel is held against, the plain version against the tail
    in float64: PYn and PUn within 1e-6 of their largest magnitude (PUn
    cancels to the threshold's size from terms of PX's size, a few
    float32 rounding steps of it), the sums to 1e-5 relative."""
    PX, PY, PU, thr_v, wl1_v = _inputs(R, C, seed=R * C)
    thr, wl1 = (thr_v, wl1_v) if vectors else (np.float32(0.45),
                                                np.float32(1.3))
    rlx, us = np.float32(1.8), np.float32(0.7)
    ryn, run, rsums = _tail_f64(PX, PY, PU, np.asarray(thr, np.float64),
                                np.asarray(wl1, np.float64),
                                np.float64(rlx), nonneg, np.float64(us))
    args = [torch.tensor(v) for v in (PX, PY, PU)]
    tthr, twl1 = ((torch.tensor(thr_v), torch.tensor(wl1_v)) if vectors
                  else (float(thr), float(wl1)))
    yn, un, sums = tct.admm_tail_plain(*args, tthr, twl1, float(rlx),
                                       nonneg=nonneg, us=float(us))
    for got, ref in ((yn, ryn), (un, run)):
        assert np.abs(got.numpy() - ref).max() <= 1e-6 * max(
            np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(sums.numpy(), rsums, rtol=1e-5, atol=1e-30)
