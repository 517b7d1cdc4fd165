"""The port's consensus dictionary learning on the CPU against the JAX
package's, stage by stage, on the same numpy problems over 10 outer
iterations: the DFT-domain stage (mono, a colour dictionary, a grey
dictionary on three-channel signals), the spatial stage (an array
``L1Weight``; mono and colour) and the masked stage (mono and colour),
and a ``load_state_numpy`` handover.  The kernel stage is in
``tests/test_torch_consensus_kernel.py``.

D, Z (of their scale) and ``evaluate()`` (relative): within 1e-8 in
float64 and 1e-4 in float32.
"""

import numpy as np
import pytest
import torch

from sporco_tpu.parallel import consensus as jcn
from sporco_tpu_torch.parallel import consensus as tcn

torch.set_num_threads(2)

N, ND, M, K = 16, 4, 4, 3
ITERS = 10
LMBDA = 0.1
TOL = {np.float64: 1e-8, np.float32: 1e-4}


def _problem(C=1, Cd=1, seed=0):
    rng = np.random.default_rng(seed)
    S = rng.standard_normal((N, N, C, K) if C > 1 else (N, N, K))
    D0 = rng.standard_normal((ND, ND, Cd, M) if Cd > 1 else (ND, ND, M))
    W = (rng.random(S.shape) < 0.8).astype(float)
    return D0, S, W


def _route(d):
    return ("kernel" if d.cfg.kernel_x else "spatial" if d.cfg.fused_x
            else "dft")


def compare(a, b, tol):
    Da, Db = np.asarray(a.getdict()), b.getdict().cpu().numpy()
    Za, Zb = np.asarray(a.getcoef()), b.getcoef().cpu().numpy()
    assert Da.shape == Db.shape and Za.shape == Zb.shape
    assert np.abs(Da - Db).max() <= tol * np.abs(Da).max()
    assert np.abs(Za - Zb).max() <= tol * max(np.abs(Za).max(), 1e-12)
    for x, y in zip(a.evaluate(), b.evaluate()):
        assert abs(x - y) <= tol * abs(x)


def _pair(D0, S, dt, masked=False, iters=ITERS, **kw):
    jcls = (jcn.ConvBPDNMaskDcplDictLearn_Consensus if masked
            else jcn.ConvBPDNDictLearn_Consensus)
    tcls = (tcn.ConvBPDNMaskDcplDictLearn_Consensus if masked
            else tcn.ConvBPDNDictLearn_Consensus)
    a = jcls(D0, S, LMBDA, max_iter=iters, dtype=dt, **kw)
    b = tcls(D0, S, LMBDA, max_iter=iters, dtype=dt, device="cpu", **kw)
    return a, b


CHANNELS = {"mono": (1, 1), "colour": (3, 3), "grey_on_colour": (3, 1)}


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(CHANNELS))
def test_dft_stage_matches_jax(case, dt):
    D0, S, _ = _problem(*CHANNELS[case])
    a, b = _pair(D0, S, dt, fused=False)
    assert _route(b) == _route(a) == "dft"
    a.solve()
    b.solve()
    compare(a, b, TOL[dt])
    D = b.getdict().numpy()
    axes = (0, 1, 2) if CHANNELS[case][1] > 1 else (0, 1)
    np.testing.assert_allclose(np.sqrt((D ** 2).sum(axis=axes)), 1.0,
                               rtol=1e-12 if dt == np.float64 else 1e-6)


@pytest.mark.parametrize("case", ["mono", "colour"])
def test_spatial_stage_matches_jax(case):
    """An array L1Weight keeps both packages off the kernel stage: the
    spatial x-step (rank-3 for the colour dictionary, fused=True)."""
    C, Cd = CHANNELS[case]
    D0, S, _ = _problem(C, Cd, seed=1)
    D0, S = D0.astype(np.float32), S.astype(np.float32)
    wl1 = np.linspace(0.5, 1.5, M, dtype=np.float32).reshape(1, 1, 1, 1, M)
    a, b = _pair(D0, S, np.float32, wl1=wl1, fused=True)
    assert _route(b) == _route(a) == "spatial"
    a.solve()
    b.solve()
    compare(a, b, TOL[np.float32])


def test_colour_auto_takes_the_dft_stage_as_jax():
    D0, S, _ = _problem(3, 3)
    a, b = _pair(D0.astype(np.float32), S.astype(np.float32), np.float32)
    assert _route(b) == _route(a) == "dft"


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("case", ["mono", "colour"])
def test_masked_stage_matches_jax(case, dt):
    D0, S, W = _problem(*CHANNELS[case], seed=2)
    a, b = _pair(D0, S, dt, masked=True, W=W)
    assert not b.cfg.fused_x and b.cfg.masked
    a.solve()
    b.solve()
    compare(a, b, TOL[dt])


@pytest.mark.parametrize("fused", [False, "auto"])
def test_load_state_numpy_handover(fused):
    """5 JAX iterations, the state handed over, 5 more in each package.
    With ``fused="auto"`` at a kernel-eligible geometry the JAX package
    (no TPU, no interpret mode) takes its spatial stage with the state
    unpacked and the port its kernel stage with the state packed: the
    handover converts."""
    rng = np.random.default_rng(3)
    if fused is False:
        D0, S, _ = _problem(seed=3)
        dt = np.float64
    else:
        D0 = rng.standard_normal((5, 5, 8)).astype(np.float32)
        S = rng.standard_normal((32, 32, 4)).astype(np.float32)
        dt = np.float32
    a = jcn.ConvBPDNDictLearn_Consensus(D0, S, LMBDA, max_iter=5, dtype=dt,
                                        fused=fused)
    a.solve()
    b = tcn.ConvBPDNDictLearn_Consensus(D0, S, LMBDA, max_iter=5, dtype=dt,
                                        fused=fused, device="cpu")
    assert b.cfg.kernel_x == (fused == "auto") and not a.cfg.kernel_x
    b.load_state_numpy(tuple(np.asarray(x) for x in a.state))
    back = b.state_numpy(packed=False)
    for x, y in zip(a.state, back):
        np.testing.assert_allclose(y, np.asarray(x), rtol=0,
                                   atol=1e-6 * max(np.abs(x).max(), 1e-30))
    a.step(5)
    b.step(5)
    compare(a, b, TOL[dt])
    assert b.j == 5
