"""FFT glue on ``torch.fft`` (counterpart of ``sporco_tpu.ops.fft``).

The JAX package dispatches short axis transforms to DFT matmuls on the
TPU (``mxufft``) only to work around XLA's slow TPU FFT; here every
transform is ``torch.fft``.  Spatial axes are trailing, as in the JAX
package.
"""

import math

import torch

__all__ = ["fftn", "ifftn", "rfftn", "irfftn", "fl2norm2", "rfl2norm2"]


def _dims(axes):
    return None if axes is None else tuple(axes)


def fftn(a, s=None, axes=None):
    """n-dimensional complex DFT."""
    return torch.fft.fftn(a, s=s, dim=_dims(axes))


def ifftn(a, s=None, axes=None):
    """n-dimensional inverse complex DFT."""
    return torch.fft.ifftn(a, s=s, dim=_dims(axes))


def rfftn(a, s=None, axes=None):
    """n-dimensional real DFT (half-spectrum on the final axis)."""
    return torch.fft.rfftn(a, s=s, dim=_dims(axes))


def irfftn(a, s, axes=None):
    """n-dimensional inverse real DFT; ``s`` (the real-domain shape of
    the transformed axes) is required."""
    return torch.fft.irfftn(a, s=s, dim=_dims(axes))


def fl2norm2(xf, axis=None):
    """Squared l2 norm in the spatial domain from the full DFT ``xf``
    (Parseval)."""
    if axis is None:
        axis = tuple(range(xf.ndim))
    scl = 1.0 / math.prod(xf.shape[ax] for ax in axis)
    return scl * torch.sum(xf.abs() ** 2)


def rfl2norm2(xf, xs, axis=None):
    """Squared l2 norm in the spatial domain from the half-spectrum
    ``xf`` of a real array with spatial shape ``xs``: every bin counts
    twice except the DC plane of the last transformed axis and, for even
    length, the Nyquist plane."""
    if axis is None:
        axis = tuple(range(xf.ndim))
    axis = tuple(ax % xf.ndim for ax in axis)
    scl = 1.0 / math.prod(xs)
    last = axis[-1]
    sq = xf.abs() ** 2
    nrm0 = torch.sum(sq.narrow(last, 0, 1))
    nrm1 = (torch.sum(sq.narrow(last, sq.shape[last] - 1, 1))
            if xs[-1] % 2 == 0 else 0.0)
    return scl * (2.0 * torch.sum(sq) - nrm0 - nrm1)
