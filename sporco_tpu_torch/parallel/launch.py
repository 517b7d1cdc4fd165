"""Multi-process launching for the sharded solvers (counterpart of
``sporco_tpu.parallel.launch``).

Reference analogue: ``sporco/mpiutil.py:65-175`` (an MPI ``Allgatherv``
grid search) and the multiprocessing consensus CDL
(``sporco/dictlrn/prlcnscdl.py``).  Here a run is one process per
device under ``torch.distributed``: every rank runs the same program,
holds its own block of the signal batch, and the consensus mean is an
``all_reduce`` over the mesh's ``"data"`` ranks.  The dictionary is
small (``Nd^2 * Cd * M`` values), so the exchange is latency-bound.

Typical use, one process per card (``torchrun --nproc-per-node 4``, or
any launcher that sets ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
``WORLD_SIZE``/``LOCAL_RANK``)::

    from sporco_tpu_torch.parallel import launch
    launch.initialize()
    mesh = launch.global_mesh()
    d = launch.consensus_cdl(D0, S_local, lmbda=0.1, mesh=mesh,
                             max_iter=100)
    d.solve()
"""

import itertools
import os

import numpy as np
import torch
import torch.distributed as dist

from sporco_tpu_torch.parallel.mesh import make_mesh, mesh_device

__all__ = ["initialize", "global_mesh", "shard_local_batch",
           "consensus_cdl", "grid_search"]


def initialize(init_method=None, world_size=None, rank=None,
               local_rank=None, device=None, timeout=None):
    """Initialise the default process group (the counterpart of
    ``jax.distributed.initialize``).

    ``init_method`` defaults to ``"env://"`` (the variables ``torchrun``
    sets); ``world_size`` and ``rank`` default to ``WORLD_SIZE`` and
    ``RANK``.  The backend follows the device: NCCL for the card
    (``device=None``, which raises without one; the rank's card is
    ``local_rank``, default ``LOCAL_RANK`` or ``rank`` modulo the cards
    present, and is made current before NCCL starts), gloo only when
    ``device="cpu"`` is asked for.  Returns this rank's device.
    """
    if device is None and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "for CPU ranks over gloo")
    cpu = device is not None and torch.device(device).type == "cpu"
    if init_method is None:
        init_method = "env://"
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    kw = {} if timeout is None else {"timeout": timeout}
    if cpu:
        dev = torch.device("cpu")
        backend = "gloo"
    else:
        if local_rank is None:
            local_rank = int(os.environ.get(
                "LOCAL_RANK", rank % torch.cuda.device_count()))
        torch.cuda.set_device(local_rank)
        dev = torch.device("cuda", local_rank)
        backend = "nccl"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank, **kw)
    return dev


def _backend_device():
    return "cpu" if dist.get_backend() == "gloo" else None


def global_mesh(n_filter=1, device=None):
    """A ``("data", "filter")`` mesh over every rank of the world; the
    device type follows the process group's backend unless given."""
    return make_mesh(n_filter=n_filter, device=device if device is not None
                     else _backend_device())


def shard_local_batch(mesh, local, axis=0):
    """This rank's own chunk ``local`` as a tensor on its device.  The
    global batch is the concatenation of the chunks over the ``"data"``
    ranks, as ``sporco_tpu.parallel.launch.shard_local_batch`` assembles
    it; with plain tensors nothing needs assembling."""
    t = local if isinstance(local, torch.Tensor) else torch.as_tensor(
        np.ascontiguousarray(local))
    return t.to(mesh_device(mesh))


def consensus_cdl(D0, S_local, lmbda, mesh=None, **kw):
    """A consensus-CDL solver whose signal batch is given per rank: each
    rank passes only its own ``S_local`` (user layout, K axis last); the
    global batch is their concatenation over the ``"data"`` ranks.  With
    one rank this is ``ConvBPDNDictLearn_Consensus(D0, S_local, lmbda,
    mesh=mesh)``."""
    from sporco_tpu_torch.parallel.consensus import \
        ConvBPDNDictLearn_Consensus
    if mesh is None:
        mesh = global_mesh()
    return ConvBPDNDictLearn_Consensus(
        D0, S_local, lmbda, mesh=mesh,
        process_local_batch=dist.get_world_size() > 1, **kw)


def _limits(rank, n, nproc):
    """The rank's chunk ``[lo, hi)`` of ``n`` points
    (``sporco/mpiutil.py:26-61``)."""
    return (rank * n) // nproc, ((rank + 1) * n) // nproc


def grid_search(fn, grid, fmin=True):
    """Multi-process grid search (``sporco/mpiutil.py:65-175``).

    The Cartesian product of ``grid`` (a tuple of 1-D arrays) is chunked
    over the ranks; each rank evaluates its chunk of ``fn`` serially on
    the host, pads it with NaN to a fixed slot, and one ``all_gather`` of
    a float64 tensor exchanges the slots.  Every rank returns the same
    ``(best_params, best_value, all_values)``.  Without an initialised
    process group it is a serial sweep.
    """
    prms = list(itertools.product(*[np.asarray(g).tolist() for g in grid]))
    multi = dist.is_initialized()
    nproc = dist.get_world_size() if multi else 1
    rank = dist.get_rank() if multi else 0
    n = len(prms)
    lo, hi = _limits(rank, n, nproc)
    local_vals = np.array([fn(p) for p in prms[lo:hi]], np.float64)
    if multi:
        sizes = [b - a for a, b in (_limits(r, n, nproc)
                                    for r in range(nproc))]
        dev = ("cpu" if dist.get_backend() == "gloo"
               else torch.device("cuda", torch.cuda.current_device()))
        pad = torch.full((max(sizes),), float("nan"), dtype=torch.float64)
        pad[:hi - lo] = torch.as_tensor(local_vals)
        pad = pad.to(dev)
        slots = [torch.empty_like(pad) for _ in range(nproc)]
        dist.all_gather(slots, pad)
        vals = np.concatenate([s.cpu().numpy()[:sz]
                               for s, sz in zip(slots, sizes)])
    else:
        vals = local_vals
    idx = int(np.nanargmin(vals) if fmin else np.nanargmax(vals))
    return prms[idx], float(vals[idx]), vals.reshape(
        tuple(len(np.asarray(g)) for g in grid))
