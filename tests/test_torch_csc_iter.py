"""The port's ``csc_iter`` (plain PyTorch version, as the wrapper runs it
on CPU tensors) against the JAX package's Pallas ``csc_iter`` run in
interpret mode, on the same numpy inputs."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sporco_tpu.ops import pallas_csc_iter as pki
from sporco_tpu_torch.ops import csc_iter as tci

torch.set_num_threads(2)

POS, C, T = 64, 256, 256
RLX, US = 1.8, 0.7
# bf16 pass counts (forward, adjoint, R2) of the JAX kernel: "f32" is its
# f32-faithful 6-pass schedule, "driver" the 4/3/3 schedule the fused
# ConvBPDN driver runs
SCHEDULES = {"f32": (6, 6, 6), "driver": (4, 3, 3)}


@pytest.fixture
def interpret():
    prev = pki.interpret
    pki.interpret = True
    try:
        yield
    finally:
        pki.interpret = prev


def _inputs(per_channel, seed=3):
    rng = np.random.default_rng(seed)
    f = np.float32
    G2 = (0.1 * rng.standard_normal((POS, T))).astype(f)
    Wa = (0.1 * rng.standard_normal((T, C))).astype(f)
    Wf = (0.1 * rng.standard_normal((C, T))).astype(f)
    Y = (rng.standard_normal((POS, C))
         * (rng.random((POS, C)) < 0.3)).astype(f)
    U = (0.1 * rng.standard_normal((POS, C))).astype(f)
    if per_channel:
        thr = rng.uniform(0.01, 0.1, C).astype(f)
        wl1 = rng.uniform(0.5, 1.5, C).astype(f)
    else:
        thr, wl1 = f(0.05), f(1.0)
    return G2, Y, U, Wa, Wf, thr, wl1


def _port(G2, Y, U, Wa, Wf, thr, wl1, scale, nonneg, emit_px):
    def t(a):
        return torch.tensor(a) if isinstance(a, np.ndarray) and a.ndim \
            else float(a)
    out = tci.csc_iter(t(G2), t(Y), t(U), t(Wa), t(Wf), t(thr), t(wl1),
                       RLX, US, scale, nonneg=nonneg, emit_px=emit_px)
    return [None if o is None else o.numpy() for o in out]


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("nonneg", [False, True])
@pytest.mark.parametrize("emit_px", [True, False])
def test_matches_jax_kernel(interpret, schedule, per_channel, nonneg,
                            emit_px):
    G2, Y, U, Wa, Wf, thr, wl1 = _inputs(per_channel)
    scale = 0.9
    fp, ap, rp = SCHEDULES[schedule]
    ref = pki.csc_iter(jnp.asarray(G2), jnp.asarray(Y), jnp.asarray(U),
                       pki.split_bf16_3(jnp.asarray(Wa)),
                       pki.split_bf16_3(jnp.asarray(Wf)), thr, wl1, RLX,
                       US, scale, nonneg=nonneg, fwd_passes=fp,
                       adj_passes=ap, r2_passes=rp, emit_px=emit_px)
    ref = [None if o is None else np.asarray(o) for o in ref]
    got = _port(G2, Y, U, Wa, Wf, thr, wl1, scale, nonneg, emit_px)
    px, yn, un, r1, r2, sums = got
    assert (px is None) == (not emit_px)
    # Yn/Un: 1e-4 of the reference's scale.  At the driver schedule the
    # reference adjoint G2 @ Wa runs 3-pass bf16 (about 2e-5 relative to
    # |A|), and Un is bounded by the threshold, far below |A|; so the
    # scale there is max|PX| (which carries A), not max|Un|.
    ynun_scale = (max(np.abs(ref[1]).max(), np.abs(ref[2]).max())
                  if schedule == "f32" else
                  np.abs(_port(G2, Y, U, Wa, Wf, thr, wl1, scale, nonneg,
                               True)[0]).max())
    assert np.abs(yn - ref[1]).max() <= 1e-4 * ynun_scale
    assert np.abs(un - ref[2]).max() <= 1e-4 * ynun_scale
    if emit_px:
        assert _rel(px, ref[0]) <= 1e-4
    assert _rel(r1, ref[3]) <= 1e-5
    assert _rel(r2, ref[4]) <= 1e-4
    np.testing.assert_allclose(sums, ref[5], rtol=1e-4)


@pytest.mark.parametrize("per_channel", [False, True])
def test_plain_matches_float64(per_channel):
    """The plain version against the same formulas in float64 numpy."""
    G2, Y, U, Wa, Wf, thr, wl1 = _inputs(per_channel, seed=11)
    nonneg, scale = False, 1.0
    d = [a.astype(np.float64) for a in (G2, Y, U, Wa, Wf)]
    G2d, Yd, Ud, Wad, Wfd = d
    u = US * Ud
    pxd = scale * (Yd - u) + G2d @ Wad
    ax = RLX * pxd + (1 - RLX) * Yd
    axu = ax + u
    ynd = np.sign(axu) * np.maximum(np.abs(axu) - np.float64(thr), 0)
    und = u + ax - ynd
    sumsd = [((pxd - ynd) ** 2).sum(), ((ynd - Yd) ** 2).sum(),
             (pxd ** 2).sum(), (ynd ** 2).sum(), (und ** 2).sum(),
             (np.abs(pxd) * np.float64(wl1)).sum()]
    px, yn, un, r1, r2, sums = _port(G2, Y, U, Wa, Wf, thr, wl1, scale,
                                     nonneg, True)
    assert _rel(px, pxd) <= 1e-6
    assert np.abs(yn - ynd).max() <= 1e-6 * np.abs(pxd).max()
    assert np.abs(un - und).max() <= 1e-6 * np.abs(pxd).max()
    assert _rel(r1, (ynd - und) @ Wfd) <= 1e-5
    assert _rel(r2, und @ Wfd) <= 1e-5
    np.testing.assert_allclose(sums, sumsd, rtol=1e-5)


def test_updates_state_in_place():
    G2, Y, U, Wa, Wf, thr, wl1 = _inputs(False)
    Yt, Ut = torch.tensor(Y), torch.tensor(U)
    _, yn, un, _, _, _ = tci.csc_iter(
        torch.tensor(G2), Yt, Ut, torch.tensor(Wa), torch.tensor(Wf),
        0.05, 1.0, RLX, US, 1.0)
    assert yn is Yt and un is Ut
    assert not np.array_equal(Yt.numpy(), Y)


def test_cpu_call_does_not_count_as_launch():
    G2, Y, U, Wa, Wf, thr, wl1 = _inputs(False)
    tci.reset_launches()
    _port(G2, Y, U, Wa, Wf, thr, wl1, 1.0, False, False)
    assert tci.LAUNCHES["csc_iter"] == 0


def test_rejects_bad_vector_shape():
    G2, Y, U, Wa, Wf, thr, wl1 = _inputs(False)
    with pytest.raises(ValueError):
        tci.csc_iter(torch.tensor(G2), torch.tensor(Y), torch.tensor(U),
                     torch.tensor(Wa), torch.tensor(Wf),
                     torch.ones(C - 1), 1.0, RLX, US, 1.0)
