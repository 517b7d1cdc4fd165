"""The port's grid searches (``parallel/gridsearch.py`` serial and by
``torch.func.vmap``; ``parallel/launch.grid_search`` over gloo ranks)
and the mesh and launch helpers, against the JAX package's.

Top-level imports are numpy, torch, pytest and the port: the ranks
import this module's helpers, never JAX."""

import numpy as np
import pytest
import torch

from sporco_tpu_torch.parallel import gridsearch as tgs
from sporco_tpu_torch.parallel import launch as tln
from sporco_tpu_torch.parallel import mesh as tms
from tests._torch_dist import GRID, grid_fn, run_world

G2 = (np.linspace(-1.0, 1.0, 9), np.array([0.5, -0.25, 2.0, 0.0]))


def _f2(p):
    return (p[0] - 0.25) ** 2 + 3.0 * (p[1] + 0.25) ** 2


@pytest.mark.parametrize("fmin", [True, False])
def test_serial_matches_jax(fmin):
    from sporco_tpu.parallel import gridsearch as jgs
    a = jgs.grid_search(_f2, G2, fmin=fmin)
    b = tgs.grid_search(_f2, G2, fmin=fmin)
    assert b[0] == a[0] and b[1] == a[1] and b[3] == a[3]
    np.testing.assert_array_equal(b[2], a[2])


def test_serial_one_axis_list_matches_jax():
    """A grid given as one list of values is one axis, as in JAX."""
    from sporco_tpu.parallel import gridsearch as jgs
    g = [0.0, 1.0, 2.0, 3.0]
    a = jgs.grid_search(lambda p: (p[0] - 2.0) ** 2, g)
    b = tgs.grid_search(lambda p: (p[0] - 2.0) ** 2, g)
    assert b[0] == a[0] == (2.0,) and b[2].shape == a[2].shape == (4,)


@pytest.mark.parametrize("fmin", [True, False])
def test_vmap_matches_jax(fmin):
    """``mode="vmap"``: one vectorised call of a function of scalar
    tensors (``torch.func.vmap``) against the JAX ``vmap`` of the same
    function: values within 1e-12, the same optimum."""
    import jax.numpy as jnp
    from sporco_tpu.parallel import gridsearch as jgs

    def fj(a, b):
        return jnp.sin(3 * a) * jnp.exp(-b ** 2) + a * b

    def ft(a, b):
        return torch.sin(3 * a) * torch.exp(-b ** 2) + a * b
    a = jgs.grid_search(fj, G2, fmin=fmin, mode="vmap")
    b = tgs.grid_search(ft, G2, fmin=fmin, mode="vmap", device="cpu")
    np.testing.assert_allclose(b[2], a[2], rtol=0, atol=1e-12)
    assert b[3] == a[3] and b[0] == a[0]
    flat = tgs.grid_search_vmap(ft, G2, device="cpu")
    assert flat.shape == (9 * 4,) and flat.dtype == torch.float64


def test_launch_grid_search_two_ranks(tmp_path):
    """``launch.grid_search`` over two gloo ranks on the function of
    ``tests/parallel/_launch_child.py``: both ranks find (0.3, 0.0) with
    value 0 and return the JAX package's single-process values."""
    from sporco_tpu.parallel import launch as jln
    ranks = run_world(["grid"], 2, tmp_path)["grid"]
    prm, val, vals = jln.grid_search(grid_fn, GRID)
    for out in ranks:
        assert abs(out["prm"][0] - 0.3) < 1e-12 and out["prm"][1] == 0.0
        assert abs(float(out["val"])) < 1e-12
        np.testing.assert_array_equal(out["vals"], vals)
    assert np.allclose(ranks[0]["prm"], prm)


def test_launch_grid_search_single_process_matches_jax():
    """Without a process group it is the serial sweep of the JAX
    package's single-process run."""
    from sporco_tpu.parallel import launch as jln
    a = jln.grid_search(lambda p: (p[0] - 2.0) ** 2, (np.arange(5.0),))
    b = tln.grid_search(lambda p: (p[0] - 2.0) ** 2, (np.arange(5.0),))
    assert b[0] == a[0] == (2.0,) and b[1] == a[1] == 0.0
    np.testing.assert_array_equal(b[2], a[2])


def test_mesh_and_launch_helpers_in_one_rank_world():
    """A one-rank gloo world: ``make_mesh`` and ``global_mesh`` give a
    1 x 1 ``("data", "filter")`` mesh on the CPU, ``shard_batch`` and
    ``shard_local_batch`` the whole array as a tensor, and a mesh that
    does not cover the world raises."""
    import torch.distributed as dist
    from tests._torch_dist import free_port
    dev = tln.initialize(f"tcp://127.0.0.1:{free_port()}", 1, 0,
                         device="cpu")
    try:
        assert dev == torch.device("cpu") and dist.get_backend() == "gloo"
        m = tln.global_mesh()
        assert m.mesh_dim_names == ("data", "filter")
        assert tms.axis_size(m, "data") == tms.axis_size(m, "filter") == 1
        assert tms.mesh_device(m) == torch.device("cpu")
        x = np.arange(12.0).reshape(4, 3)
        assert torch.equal(tms.shard_batch(m, x), torch.as_tensor(x))
        assert torch.equal(tln.shard_local_batch(m, x), torch.as_tensor(x))
        with pytest.raises(ValueError, match="does not cover"):
            tms.make_mesh(n_data=2, device="cpu")
    finally:
        dist.destroy_process_group()


def test_entry_points_default_to_the_card(monkeypatch):
    """``initialize``, ``make_mesh`` and the vmap grid search take the
    card unless asked for the CPU, and raise without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tln.initialize("tcp://127.0.0.1:1", 1, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tms._device_type(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tgs.grid_search_vmap(lambda a: a, (np.arange(3.0),))
