"""Device mesh helpers (counterpart of ``sporco_tpu.parallel.mesh``).

The parallel axes are the JAX package's: training signals (K) shard on
the ``"data"`` axis (consensus dictionary learning, the row-sharded
solvers), dictionary filter groups on the ``"filter"`` axis
(``ParConvBPDN``).  A mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` with those two named
dimensions over the initialised process group, one rank per device.

Arrays are plain tensors: each rank holds its own block, and the
solvers reduce across ranks with explicit collectives over
``mesh.get_group("data")`` or ``mesh.get_group("filter")``.  The JAX
package's ``NamedSharding``/``PartitionSpec`` objects (``data_sharding``,
``replicated``) have no counterpart here: a rank's block is an ordinary
tensor on its device.
"""

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["make_mesh", "shard_batch", "mesh_device", "axis_size",
           "axis_rank", "all_reduce_sum"]


def _device_type(device):
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' for a "
                "mesh of CPU ranks (gloo)")
        return "cuda"
    dt = torch.device(device).type
    if dt not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dt


def make_mesh(n_data=None, n_filter=1, device=None):
    """A mesh with dimensions ``("data", "filter")`` over the initialised
    world (:func:`sporco_tpu_torch.parallel.launch.initialize`).

    ``n_data`` defaults to ``world_size // n_filter``; ``n_data *
    n_filter`` must be the world size.  Ranks are laid out data-major, so
    the ranks of one ``"data"`` coordinate are consecutive.
    ``device=None`` means the CUDA devices (NCCL) and raises without a
    card; ``device="cpu"`` a mesh of CPU ranks (gloo).
    """
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("torch.distributed is not initialised; call "
                           "parallel.launch.initialize first")
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_filter
    if n_data * n_filter != world:
        raise ValueError(f"a {n_data} x {n_filter} mesh does not cover "
                         f"the world of {world} ranks")
    return init_device_mesh(_device_type(device), (n_data, n_filter),
                            mesh_dim_names=("data", "filter"))


def mesh_device(mesh):
    """The torch device of this rank in ``mesh``."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh must be a DeviceMesh (see make_mesh), not "
                        f"{type(mesh).__name__}")
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def axis_size(mesh, name):
    """Number of ranks along the mesh dimension ``name`` (1 without a
    mesh)."""
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(name))


def axis_rank(mesh, name):
    """This rank's coordinate along the mesh dimension ``name``."""
    return 0 if mesh is None else mesh.get_local_rank(name)


def all_reduce_sum(x, group):
    """``x`` summed over ``group`` (a complex tensor as its real pairs);
    returns the sum, ``x`` itself where it was contiguous."""
    x = x.resolve_conj().contiguous()
    v = torch.view_as_real(x) if x.is_complex() else x
    dist.all_reduce(v, op=dist.ReduceOp.SUM, group=group)
    return x


def shard_batch(mesh, x, axis=0):
    """This rank's block of ``x`` (a numpy array or a tensor) along
    ``axis``, by its ``"data"`` coordinate, as a tensor on the rank's
    device.  The axis must divide evenly over the ``"data"`` ranks."""
    P = axis_size(mesh, "data")
    n = x.shape[axis]
    if n % P != 0:
        raise ValueError(f"axis {axis} of length {n} does not divide over "
                         f"{P} data ranks")
    b = n // P
    i = axis_rank(mesh, "data")
    t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(x))
    return t.narrow(axis, i * b, b).contiguous().to(mesh_device(mesh))
