"""The port's row-sharded solvers and distributed FFT over gloo on the
CPU (``tests/_torch_dist.py``, 2 ranks) against numpy and against the
JAX package's ``spatial`` functions on a 2-device mesh of the suite's
virtual CPU devices.

Top-level imports are numpy, torch, pytest and the port: the ranks
import this module's helpers, never JAX."""

import numpy as np
import pytest
import torch

from tests._torch_dist import (CSC_OPT, TV_OPT, run_world,
                               spatial_problems)


@pytest.fixture(scope="module")
def world2(tmp_path_factory):
    return run_world(["spatial"], 2, tmp_path_factory.mktemp("sp2"))["spatial"]


def _jax_mesh(P):
    import jax
    from sporco_tpu.parallel.mesh import make_mesh
    return make_mesh(devices=jax.devices()[:P])


def test_dist_rfft2_matches_numpy(world2):
    """The two ranks' frequency-column blocks make numpy's ``rfft2``
    within 1e-10 of its scale, the pad column is exactly zero, and the
    inverse gives the rows back within 1e-12."""
    x = spatial_problems()[0]
    Xf = np.concatenate([o["xf"] for o in world2], axis=1)
    K1 = x.shape[1] // 2 + 1
    assert Xf.shape == (x.shape[0], 14)
    ref = np.fft.rfft2(x)
    assert np.abs(Xf[:, :K1] - ref).max() < 1e-10 * np.abs(ref).max()
    assert np.abs(Xf[:, K1:]).max() == 0.0
    xr = np.concatenate([o["xr"] for o in world2], axis=0)
    assert np.abs(xr - x).max() < 1e-12


def test_cbpdn_nsharded_matches_jax(world2):
    """``cbpdn_nsharded`` at P = 2 in float64 against the JAX function on
    a 2-device mesh: the same early stop, X within 1e-9, every stats row
    rtol 1e-6 (the padding column zero in both)."""
    from sporco_tpu.models import cbpdn as jcb
    from sporco_tpu.parallel import spatial as jsp
    _, _, (D, S) = spatial_problems()
    Xj, statsj, kj = jsp.cbpdn_nsharded(
        D, S, 0.1, _jax_mesh(2), opt=jcb.ConvBPDN.options(**CSC_OPT),
        dtype=np.float64)
    Xj = np.asarray(Xj)
    X = np.concatenate([o["Xc"] for o in world2], axis=0)
    for o in world2:
        assert int(o["kc"]) == kj
        np.testing.assert_array_equal(o["stats"], world2[0]["stats"])
    assert kj < CSC_OPT["max_iter"]
    assert X.shape == Xj.shape
    assert np.abs(X - Xj).max() < 1e-9
    np.testing.assert_allclose(world2[0]["stats"], statsj, rtol=1e-6)
    assert np.all(world2[0]["stats"][:, 9] == 0.0)


def test_tvl2deconv_nsharded_matches_jax(world2):
    """``tvl2deconv_nsharded`` at P = 2 in float64 against the JAX
    function: the same early stop, X within 1e-9, the final residuals
    rtol 1e-6."""
    from sporco_tpu.models import tv as jtv
    from sporco_tpu.parallel import spatial as jsp
    _, (h, S), _ = spatial_problems()
    Xj, kj, rj, sj = jsp.tvl2deconv_nsharded(
        h, S, 5e-3, _jax_mesh(2), opt=jtv.TVL2Deconv.options(**TV_OPT),
        dtype=np.float64)
    X = np.concatenate([o["Xt"] for o in world2], axis=0)
    assert int(world2[0]["kt"]) == kj < TV_OPT["max_iter"]
    assert np.abs(X - np.asarray(Xj)).max() < 1e-9
    np.testing.assert_allclose(world2[0]["rs"], [rj, sj], rtol=1e-6)


def test_nsharded_solvers_read_once_a_block(world2):
    """Each rank runs the row-sharded solvers on the device loop: the
    stopping flag read once a block of 8 iterations, the final state once,
    ``ceil(k / 8) + 1`` reads a solve (TV deconvolution, then CSC)."""
    import math
    for o in world2:
        k = (int(o["kt"]), int(o["kc"]))
        assert [int(v) for v in o["reads"]] == [math.ceil(n / 8) + 1
                                                 for n in k]


def test_nsharded_raise_where_jax_raises(world2):
    """Rows that do not divide over the ranks, and a signal that is not
    2-D, raise ValueError as in the JAX package."""
    assert "must divide" in str(world2[0]["odd_rows"])
    assert "2-D single-channel" in str(world2[0]["not_2d"])


def test_world_size_one_matches_single_device_models(tmp_path):
    """At one rank the row-sharded solvers are the single-device
    ``ConvBPDN(fused=False)`` and ``TVL2Deconv`` of the port, row for
    row (run in-process over a one-rank gloo group)."""
    import torch.distributed as dist
    from sporco_tpu_torch.models.cbpdn import ConvBPDN
    from sporco_tpu_torch.models.tv import TVL2Deconv
    from sporco_tpu_torch.parallel import launch, spatial
    from tests._torch_dist import free_port
    _, (h, S), (D, Sc) = spatial_problems()
    from sporco_tpu_torch.ops import device_loop
    launch.initialize(f"tcp://127.0.0.1:{free_port()}", 1, 0, device="cpu")
    try:
        mesh = launch.global_mesh()
        X2, k2, _, _ = spatial.tvl2deconv_nsharded(
            h, S, 5e-3, mesh, opt=TVL2Deconv.options(**TV_OPT),
            dtype=torch.float64)
        assert device_loop.LAST["host_reads"] == -(-k2 // 8) + 1
        Xc2, st2, kc2 = spatial.cbpdn_nsharded(
            D, Sc, 0.1, mesh, opt=ConvBPDN.options(**CSC_OPT),
            dtype=torch.float64)
    finally:
        dist.destroy_process_group()
    b = TVL2Deconv(h, S, 5e-3, opt=TVL2Deconv.options(**TV_OPT),
                   dtype=torch.float64, device="cpu")
    X1 = b.solve().numpy().squeeze()
    assert k2 == len(b.getitstat())
    assert np.abs(X2.numpy() - X1).max() < 1e-12
    c = ConvBPDN(D, Sc, 0.1, opt=ConvBPDN.options(**CSC_OPT),
                 dtype=torch.float64, fused=False, device="cpu")
    Xc1 = c.solve().numpy().squeeze()
    its = c.getitstat()
    assert kc2 == len(its)
    assert np.abs(Xc2.numpy() - Xc1).max() < 1e-12
    for j, name in enumerate(("Iter", "ObjFun", "DFid", "RegL1",
                              "PrimalRsdl", "DualRsdl", "EPrimal", "EDual",
                              "Rho")):
        np.testing.assert_allclose(st2[:, j], getattr(its, name),
                                   rtol=1e-6, err_msg=name)
