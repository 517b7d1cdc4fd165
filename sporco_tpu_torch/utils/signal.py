"""Signal-processing helpers (counterpart of ``sporco_tpu.utils.signal``):
the forward difference and its transpose, and the DFT-domain gradient
filters of the gradient-regularised CSC problems."""

import numpy as np
import torch

from sporco_tpu_torch.ops import fft as sf

__all__ = ["grad", "gradT", "gradient_filters"]


def grad(x, axis, zero_pad=False):
    """Forward difference along ``axis`` (``sporco/signal.py:115``): with
    ``zero_pad=False`` the circular difference with its last entry set to
    zero (R^N -> R^N), with ``zero_pad=True`` the difference of ``x``
    padded by a zero at each end (R^N -> R^{N+1})."""
    axis = axis % x.ndim
    if zero_pad:
        z = torch.zeros_like(x.narrow(axis, 0, 1))
        return torch.diff(x, dim=axis, prepend=z, append=z)
    xg = torch.roll(x, -1, dims=axis) - x
    xg.narrow(axis, x.shape[axis] - 1, 1).zero_()
    return xg


def gradT(x, axis, zero_pad=False):
    """Transpose of :func:`grad` (``sporco/signal.py:172``)."""
    axis = axis % x.ndim
    if zero_pad:
        return -torch.diff(x, dim=axis)
    n = x.shape[axis]
    xg = torch.roll(x, 1, dims=axis) - x
    xg.narrow(axis, 0, 1).copy_(-x.narrow(axis, 0, 1))
    xg.narrow(axis, n - 1, 1).copy_(x.narrow(axis, n - 2, 1))
    return xg


def gradient_filters(axes_ndim, axshp, dtype=torch.float32, real=True,
                     device=None):
    """DFT-domain forward-difference filter stack.

    ``axes_ndim`` is the number of (trailing) spatial axes, ``axshp``
    their shape.  Returns ``(Gf, GHGf)`` where ``Gf`` has shape
    ``(J, *freq_shape)`` with ``J = axes_ndim`` gradient filters indexed
    on the leading axis, and ``GHGf = sum_j conj(Gf_j) Gf_j`` (real,
    shape ``freq_shape``), on ``device`` (``None``: the CPU).  The 2-D
    real transform goes through the FFT dispatch of
    :mod:`sporco_tpu_torch.ops.fft` like every other.  Capability of
    ``sporco/signal.py:204`` re-oriented for the trailing-spatial
    layout.
    """
    J = axes_ndim
    g = np.zeros((J,) + (2,) * J, dtype=np.float64)
    for j in range(J):
        idx = (j,) + (0,) * j + (slice(None),) + (0,) * (J - j - 1)
        g[idx] = np.array([1.0, -1.0])
    g = torch.as_tensor(g, dtype=dtype, device=device)
    axes = tuple(range(1, J + 1))
    if real and not dtype.is_complex:
        Gf = sf.rfftn(g, s=tuple(axshp), axes=axes)
    else:
        Gf = sf.fftn(g, s=tuple(axshp), axes=axes)
    GHGf = torch.sum((Gf.conj() * Gf).real, dim=0)
    return Gf, GHGf
