"""The port's consensus kernel stage (``csc_iter`` with
``emit_fwd=False``, here its plain version) against the JAX package's
kernel stage (its Pallas ``csc_iter`` in interpret mode) over 10 outer
iterations, for a grey and for a colour dictionary at the smallest
geometry the JAX kernel takes: N = 32, 5x5 filters, M = 8, K = 4, packed
(pos, C, T) = (64, 512, 256), colour T = 768.

Tolerances are those the JAX package holds its own kernel stage to
against its XLA stage (``tests/parallel/test_consensus.py:219-222``),
which its 3-pass bf16 adjoint sets: D within 1e-3, Z within 1e-3 of its
scale, the objective within 1e-3 relative.  The port's stage is also
held to the JAX package's spatial stage at the float32 tolerance, 1e-4:
the same arithmetic without the bf16 adjoint.
"""

import numpy as np
import pytest
import torch

from sporco_tpu.ops import pallas_csc_iter as pki
from sporco_tpu.parallel import consensus as jcn
from sporco_tpu_torch.ops import csc_iter as tci
from sporco_tpu_torch.parallel import consensus as tcn

torch.set_num_threads(2)

N, ND, M, K = 32, 5, 8, 4
ITERS = 10
LMBDA = 0.1
KERNEL_TOL = 1e-3
F32_TOL = 1e-4


def _problem(Cd, seed=0):
    rng = np.random.default_rng(seed)
    S = rng.standard_normal((N, N, Cd, K) if Cd > 1 else (N, N, K))
    D0 = rng.standard_normal((ND, ND, Cd, M) if Cd > 1 else (ND, ND, M))
    return D0.astype(np.float32), S.astype(np.float32)


def _compare(a, b, tol):
    Da, Db = np.asarray(a.getdict()), b.getdict().numpy()
    Za, Zb = np.asarray(a.getcoef()), b.getcoef().numpy()
    assert np.abs(Da - Db).max() < tol
    assert np.abs(Za - Zb).max() < tol * max(np.abs(Za).max(), 1e-6)
    oa, ob = a.evaluate()[0], b.evaluate()[0]
    assert abs(oa - ob) < tol * abs(oa)


@pytest.fixture
def calls(monkeypatch):
    """The stage's csc_iter calls, by their keyword arguments."""
    seen = []

    def spy(*args, **kw):
        seen.append((args[4], kw))
        return tci.csc_iter(*args, **kw)
    monkeypatch.setattr(tcn, "csc_iter", spy)
    return seen


@pytest.mark.parametrize("Cd", [1, 3])
def test_kernel_stage_matches_jax_kernel_stage(Cd, calls):
    D0, S = _problem(Cd)
    fused = True if Cd > 1 else "auto"
    prev = pki.interpret
    pki.interpret = True
    try:
        a = jcn.ConvBPDNDictLearn_Consensus(D0, S, LMBDA, max_iter=ITERS,
                                            dtype=np.float32, fused=fused)
        assert a.cfg.kernel_x
        a.solve()
    finally:
        pki.interpret = prev
    b = tcn.ConvBPDNDictLearn_Consensus(D0, S, LMBDA, max_iter=ITERS,
                                        dtype=np.float32, fused=fused,
                                        device="cpu")
    assert b.cfg.kernel_x
    assert tuple(b.state[0].shape) == (K, N // 8, N // 8, 64 * M)
    b.solve()
    _compare(a, b, KERNEL_TOL)
    # one call a stage, without the forward pair and PX; CPU tensors run
    # the plain version, which counts no launch
    assert len(calls) == ITERS
    assert all(wf is None and kw == {"emit_px": False, "emit_fwd": False}
               for wf, kw in calls)
    assert tci.LAUNCHES["csc_iter"] == 0
    # the coefficients come back unpacked through unpack_state
    assert tuple(b.getcoef().shape) == (N, N, 1, K, M)


@pytest.mark.parametrize("Cd", [1, 3])
def test_kernel_stage_matches_jax_spatial_stage(Cd):
    D0, S = _problem(Cd, seed=1)
    a = jcn.ConvBPDNDictLearn_Consensus(D0, S, LMBDA, max_iter=ITERS,
                                        dtype=np.float32, fused=True)
    assert a.cfg.fused_x and not a.cfg.kernel_x
    a.solve()
    b = tcn.ConvBPDNDictLearn_Consensus(D0, S, LMBDA, max_iter=ITERS,
                                        dtype=np.float32, fused=True,
                                        device="cpu")
    assert b.cfg.kernel_x
    b.solve()
    _compare(a, b, F32_TOL)


def test_kernel_rule_routes_as_jax():
    """Geometries outside the JAX kernel rule (T = 256 but C = 64 M not a
    multiple of 128, or a row count no block divides) take the spatial
    stage in both packages; fused=False the DFT-domain stage."""
    rng = np.random.default_rng(2)
    S = rng.standard_normal((N, N, K)).astype(np.float32)
    for D0, want in ((rng.standard_normal((5, 5, 3)), "spatial"),
                     (rng.standard_normal((5, 5, 8)), "kernel")):
        D0 = D0.astype(np.float32)
        b = tcn.ConvBPDNDictLearn_Consensus(D0, S, LMBDA, device="cpu")
        got = "kernel" if b.cfg.kernel_x else "spatial"
        assert got == want
        prev = pki.interpret
        pki.interpret = True
        try:
            a = jcn.ConvBPDNDictLearn_Consensus(D0, S, LMBDA,
                                                dtype=np.float32)
        finally:
            pki.interpret = prev
        assert (a.cfg.kernel_x, a.cfg.fused_x) == (b.cfg.kernel_x,
                                                   b.cfg.fused_x)
        c = tcn.ConvBPDNDictLearn_Consensus(D0, S, LMBDA, fused=False,
                                            device="cpu")
        assert not (c.cfg.kernel_x or c.cfg.fused_x)


def test_sharding_options_raise():
    """A mesh must be a DeviceMesh (``parallel.mesh.make_mesh``); without
    a process group of several ranks ``process_local_batch`` changes
    nothing, as in the JAX package with one process.  The multi-rank
    raises are in ``tests/test_torch_parallel_consensus.py``."""
    D0, S = _problem(1)
    with pytest.raises(TypeError, match="make_mesh"):
        tcn.ConvBPDNDictLearn_Consensus(D0, S, LMBDA, device="cpu",
                                        mesh=object())
    a, b = (tcn.ConvBPDNDictLearn_Consensus(D0, S, LMBDA, device="cpu",
                                            max_iter=2,
                                            process_local_batch=pl)
            for pl in (False, True))
    assert torch.equal(a.solve(), b.solve())
