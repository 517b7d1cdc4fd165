"""Array helpers (counterpart of ``sporco_tpu.utils.array``): zero
padding along axes."""

import torch

__all__ = ["zpad"]


def zpad(x, pd, ax):
    """Zero-pad ``x`` with ``pd = (leading, trailing)`` zeros on axis
    ``ax``, or with one such pair per axis of a tuple ``ax``
    (``sporco/array.py:95``)."""
    if isinstance(ax, int):
        ax, pd = (ax,), (pd,)
    pad = [0, 0] * x.ndim
    for a, p in zip(ax, pd):
        # torch's pad list runs from the last axis backwards
        k = 2 * (x.ndim - 1 - a % x.ndim)
        pad[k], pad[k + 1] = p
    return torch.nn.functional.pad(x, pad)
