"""The port's ``pgm_iter`` (plain PyTorch version, as the wrapper runs it
on CPU tensors) against the JAX package's Pallas ``pgm_iter`` run in
interpret mode, on the same numpy inputs."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sporco_tpu.ops import pallas_csc_iter as pki
from sporco_tpu_torch.ops import pgm_iter as tpi

torch.set_num_threads(2)

POS, C, T = 64, 256, 256
RL = 0.05           # 1 / L


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
    G2 = rng.standard_normal((POS, T)).astype(f)
    Wa = (0.1 * rng.standard_normal((T, C))).astype(f)
    Wf = (0.1 * rng.standard_normal((C, T))).astype(f)
    Y = (rng.standard_normal((POS, C))
         * (rng.random((POS, C)) < 0.3)).astype(f)
    Xprv = (rng.standard_normal((POS, C))
            * (rng.random((POS, C)) < 0.3)).astype(f)
    if per_channel:
        thr = rng.uniform(0.01, 0.1, C).astype(f)
        wl1 = rng.uniform(0.5, 1.5, C).astype(f)
    else:
        thr, wl1 = f(0.05), f(1.0)
    return G2, Y, Xprv, Wa, Wf, thr, wl1


def _t(a):
    return torch.tensor(a) if isinstance(a, np.ndarray) and a.ndim \
        else float(a)


def _port(G2, Y, Xprv, Wa, Wf, thr, wl1, beta, nonneg):
    out = tpi.pgm_iter(_t(G2), _t(Y), _t(Xprv), _t(Wa), _t(Wf), _t(thr),
                       _t(wl1), RL, beta, nonneg=nonneg)
    return [o.numpy() for o in out]


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


@pytest.mark.parametrize("fwd_passes", [4, 6])
@pytest.mark.parametrize("beta", [0.0, 0.7])
@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("nonneg", [False, True])
def test_matches_jax_kernel(interpret, fwd_passes, beta, per_channel,
                            nonneg):
    """X and Yn within 1e-4 of the scale of V = Y - A/L (the JAX kernel's
    adjoint runs 3-pass bf16, about 2e-5 relative to |A|); R1 (4 or 6
    passes) to 1e-5 relative, RX (3 passes) to 1e-4, the sums to
    rtol 1e-4."""
    G2, Y, Xprv, Wa, Wf, thr, wl1 = _inputs(per_channel)
    ref = pki.pgm_iter(jnp.asarray(G2), jnp.asarray(Y), jnp.asarray(Xprv),
                       pki.split_bf16_3(jnp.asarray(Wa)),
                       pki.split_bf16_3(jnp.asarray(Wf)), thr, wl1, RL,
                       beta, nonneg=nonneg, fwd_passes=fwd_passes)
    ref = [np.asarray(o) for o in ref]
    x, yn, r1, rx, sums = _port(G2, Y, Xprv, Wa, Wf, thr, wl1, beta, nonneg)
    vscale = np.abs(Y - RL * (G2.astype(np.float64) @ Wa)).max()
    assert np.abs(x - ref[0]).max() <= 1e-4 * vscale
    assert np.abs(yn - ref[1]).max() <= 1e-4 * vscale
    if nonneg:
        assert (x >= 0).all()
    assert _rel(r1, ref[2]) <= 1e-5
    assert _rel(rx, ref[3]) <= 1e-4
    np.testing.assert_allclose(sums, ref[4], rtol=1e-4)


@pytest.mark.parametrize("per_channel", [False, True])
@pytest.mark.parametrize("nonneg", [False, True])
def test_plain_matches_float64(per_channel, nonneg):
    """The plain version against the same formulas in float64 numpy."""
    G2, Y, Xprv, Wa, Wf, thr, wl1 = _inputs(per_channel, seed=11)
    beta = 0.7
    G2d, Yd, Xpd, Wad, Wfd = (a.astype(np.float64)
                              for a in (G2, Y, Xprv, Wa, Wf))
    vd = Yd - RL * (G2d @ Wad)
    xd = np.sign(vd) * np.maximum(np.abs(vd) - np.float64(thr), 0)
    if nonneg:
        xd = np.maximum(xd, 0)
    ynd = xd + beta * (xd - Xpd)
    sumsd = [((xd - Yd) ** 2).sum(), (np.abs(xd) * np.float64(wl1)).sum()]
    x, yn, r1, rx, sums = _port(G2, Y, Xprv, Wa, Wf, thr, wl1, beta, nonneg)
    vscale = np.abs(vd).max()
    assert np.abs(x - xd).max() <= 1e-6 * vscale
    assert np.abs(yn - ynd).max() <= 2e-6 * vscale
    assert _rel(r1, ynd @ Wfd) <= 1e-5
    assert _rel(rx, xd @ Wfd) <= 1e-5
    np.testing.assert_allclose(sums, sumsd, rtol=1e-5)


def test_updates_state_in_place():
    """X goes into Xprv's buffer and Yn into Y's (the JAX kernel's
    aliasing {2: 0, 1: 1})."""
    G2, Y, Xprv, Wa, Wf, thr, wl1 = _inputs(False)
    Yt, Xt = torch.tensor(Y), torch.tensor(Xprv)
    x, yn, _, _, _ = tpi.pgm_iter(torch.tensor(G2), Yt, Xt,
                                  torch.tensor(Wa), torch.tensor(Wf), 0.05,
                                  1.0, RL, 0.7)
    assert x is Xt and yn is Yt
    assert not np.array_equal(Yt.numpy(), Y)
    assert not np.array_equal(Xt.numpy(), Xprv)


def test_cpu_call_does_not_count_as_launch():
    G2, Y, Xprv, Wa, Wf, thr, wl1 = _inputs(False)
    tpi.reset_launches()
    _port(G2, Y, Xprv, Wa, Wf, thr, wl1, 0.7, False)
    assert tpi.LAUNCHES["pgm_iter"] == 0


@pytest.mark.parametrize("which", ["thr", "wl1"])
def test_rejects_bad_vector_shape(which):
    G2, Y, Xprv, Wa, Wf, thr, wl1 = _inputs(False)
    vecs = {"thr": 0.05, "wl1": 1.0, which: torch.ones(C - 1)}
    with pytest.raises(ValueError):
        tpi.pgm_iter(torch.tensor(G2), torch.tensor(Y), torch.tensor(Xprv),
                     torch.tensor(Wa), torch.tensor(Wf), vecs["thr"],
                     vecs["wl1"], RL, 0.7)
