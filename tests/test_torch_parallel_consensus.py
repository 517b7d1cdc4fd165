"""The port's sharded consensus dictionary learning over gloo on the CPU
(``tests/_torch_dist.py``: 2 and 4 ranks) against the JAX package's
sharded run on a mesh of as many of the suite's virtual CPU devices.

Top-level imports are numpy, torch, pytest and the port: the ranks
import this module's helpers, never JAX."""

import numpy as np
import pytest
import torch

from sporco_tpu_torch.parallel import consensus as tcn
from tests._torch_dist import consensus_problem, kernel_problem, run_world

CASES2 = ["cns_mesh", "cns_local", "cns_masked", "cns_raises",
          "cns_kernel"]


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world(CASES2, 2, tmp_path_factory.mktemp("cns2"))


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return run_world(["cns_mesh"], 4, tmp_path_factory.mktemp("cns4"))


def _jax_sharded(P, masked):
    import jax
    import jax.numpy as jnp
    from sporco_tpu.parallel import consensus as jc
    from sporco_tpu.parallel.mesh import make_mesh
    D0, S, W = consensus_problem()
    mesh = make_mesh(devices=jax.devices()[:P])
    if masked:
        d = jc.ConvBPDNMaskDcplDictLearn_Consensus(
            D0, S, 0.05, W=W, mesh=mesh, max_iter=10, dtype=jnp.float64)
    else:
        d = jc.ConvBPDNDictLearn_Consensus(D0, S, 0.05, mesh=mesh,
                                           max_iter=10, dtype=jnp.float64)
    D = np.asarray(d.solve())
    return D, d.evaluate(), np.asarray(d.getcoef())


@pytest.mark.parametrize("case,P", [("cns_mesh", 2), ("cns_mesh", 4),
                                    ("cns_local", 2), ("cns_masked", 2)])
def test_sharded_consensus_matches_jax(request, case, P):
    """10 outer iterations in float64: D within 1e-8 of its scale and
    the objective within 1e-8 relative of the JAX sharded run,
    ``getdict()`` the same on every rank, each rank's coefficient block
    JAX's block of K, and the global K on every rank."""
    ranks = request.getfixturevalue("world%d" % P)[case]
    Dj, objj, Zj = _jax_sharded(P, case == "cns_masked")
    for r, out in enumerate(ranks):
        assert int(out["K"]) == 8
        assert np.array_equal(out["D"], ranks[0]["D"])
        Kl = 8 // P
        Zr = Zj[..., r * Kl:(r + 1) * Kl, :]
        assert out["coef"].shape == Zr.shape
        assert np.abs(out["coef"] - Zr).max() <= 1e-8 * np.abs(Zj).max()
    assert np.abs(ranks[0]["D"] - Dj).max() <= 1e-8 * np.abs(Dj).max()
    np.testing.assert_allclose(ranks[0]["obj"], np.array(objj), rtol=1e-8)


def test_process_local_batch_raises_as_jax(world2):
    """With several ranks, process-local batches need a mesh and an
    explicit K axis (``sporco_tpu/parallel/consensus.py:324-333``); a K
    that does not divide over the data ranks raises too."""
    out = world2["cns_raises"][0]
    assert "requires a global mesh" in str(out["no_mesh"])
    assert "explicit K axis" in str(out["no_k_axis"])
    assert "does not divide" in str(out["k_split"])


def test_kernel_stage_sharded_matches_unsharded(world2):
    """The kernel stage (``csc_iter_plain`` here) sharded over two ranks
    against the same loop on one process: the stage is chosen on each
    rank's block, ``csc_iter`` runs once an outer iteration on each rank,
    and D agrees within 1e-5 of its scale (float32; the consensus mean
    sums in another order)."""
    D0, S = kernel_problem()
    d = tcn.ConvBPDNDictLearn_Consensus(D0, S, 0.1, max_iter=10,
                                        device="cpu")
    assert d.cfg.kernel_x
    D1 = d.solve().numpy()
    for out in world2["cns_kernel"]:
        assert bool(out["kernel_x"]) and int(out["calls"]) == 10
        assert np.abs(out["D"] - D1).max() <= 1e-5 * np.abs(D1).max()
    obj1 = d.evaluate()
    np.testing.assert_allclose(world2["cns_kernel"][0]["obj"], obj1,
                               rtol=1e-5)


def test_unsharded_loop_unchanged_by_world_size_one_mean():
    """Without a mesh the consensus mean is ``torch.mean`` as before:
    two identical runs agree bit for bit (no collective is involved)."""
    D0, S, _ = consensus_problem()
    a, b = (tcn.ConvBPDNDictLearn_Consensus(D0, S, 0.05, max_iter=3,
                                            dtype=torch.float64,
                                            device="cpu")
            for _ in range(2))
    assert a.params["group"] is None
    assert torch.equal(a.solve(), b.solve())
