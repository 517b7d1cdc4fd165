"""Signal-processing helpers (counterpart of ``sporco_tpu.utils.signal``):
the DFT-domain gradient filters of the gradient-regularised CSC
problems."""

import numpy as np
import torch

from sporco_tpu_torch.ops import fft as sf

__all__ = ["gradient_filters"]


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
