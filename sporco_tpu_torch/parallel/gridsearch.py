"""Hyperparameter grid search (counterpart of
``sporco_tpu.parallel.gridsearch``).

Capability of the reference's multiprocessing/MPI grid search
(``sporco/util.py:80-170``, ``sporco/mpiutil.py:65-175``): evaluate a
function over the Cartesian product of parameter ranges and return the
optimum.  ``mode="vmap"`` evaluates every point in one call of the
function vectorised by ``torch.func.vmap``; across processes see
:func:`sporco_tpu_torch.parallel.launch.grid_search`.
"""

import itertools

import numpy as np
import torch

from sporco_tpu_torch._device import resolve_device

__all__ = ["grid_search", "grid_search_vmap"]


def grid_search(fn, grid, fmin=True, mode="serial", device=None):
    """Evaluate ``fn`` over ``itertools.product(*grid)`` and locate the
    optimum (``sporco/util.py:80``).

    Returns ``(sprm, sfvl, fvmx, sidx)``: the optimal parameter tuple,
    the optimal value, the array of values shaped like the grid, and the
    optimal index tuple.

    ``mode="serial"`` calls ``fn`` per point (any Python);
    ``mode="vmap"`` needs a ``fn`` of scalar tensor arguments that
    ``torch.func.vmap`` can map, and evaluates all points at once on
    ``device`` (``None``: the CUDA device, raising without one).
    """
    if isinstance(grid, (list, tuple)) and not isinstance(
            grid[0], (list, tuple, np.ndarray, torch.Tensor)):
        grid = (grid,)
    shape = tuple(len(g) for g in grid)
    if mode == "vmap":
        fvmx = grid_search_vmap(fn, grid, device).detach().cpu().numpy() \
            .reshape(shape)
    else:
        fvmx = np.empty(shape)
        for idx, prm in zip(itertools.product(*(range(n) for n in shape)),
                            itertools.product(*grid)):
            fvmx[idx] = float(fn(prm))
    sidx = np.unravel_index(np.argmin(fvmx) if fmin else np.argmax(fvmx),
                            shape)
    sprm = tuple(grid[i][sidx[i]] for i in range(len(grid)))
    sfvl = fvmx[sidx]
    return sprm, sfvl, fvmx, sidx


def grid_search_vmap(fn, grid, device=None):
    """Evaluate ``fn(p0, p1, ...)`` of scalar tensors over the full
    Cartesian grid in one vectorised call on ``device``; returns the flat
    value tensor (row-major over the grid)."""
    dev = resolve_device(device)
    cols = torch.meshgrid(*[torch.as_tensor(np.asarray(g)).to(dev)
                            for g in grid], indexing="ij")
    return torch.func.vmap(fn)(*[c.reshape(-1) for c in cols])
