"""Signal-processing helpers (counterpart of ``sporco_tpu.utils.signal``):
the forward difference and its transpose, the DFT-domain gradient
filters of the gradient-regularised CSC problems, salt-and-pepper noise
and random masks, the luma transform, the Tikhonov low-pass split, the
sampled Gaussian and local contrast normalisation.

Where the JAX package draws from a ``jax.random`` key, these functions
take a ``torch.Generator`` (or the uniform draw itself, ``u``, so that
both packages can be given the same one)."""

import math

import numpy as np
import torch

from sporco_tpu_torch._device import resolve_device
from sporco_tpu_torch.ops import fft as sf

__all__ = ["complex_randn", "grad", "gradT", "gradient_filters", "spnoise",
           "rndmask",
           "rgb2gray", "tikhonov_filter", "gaussian",
           "local_contrast_normalise"]


def _as_tensor(x):
    """A tensor as it is, anything else through a copy to a numpy
    array."""
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.array(x))


def _uniform(shape, generator, u, device):
    if u is not None:
        return _as_tensor(u).to(device)
    return torch.rand(tuple(shape), generator=generator).to(device)


def complex_randn(generator, *shape):
    """Complex Gaussian samples of ``shape`` (``sporco/signal.py:23``):
    standard normal real and imaginary parts, drawn in that order from
    ``generator`` (a ``torch.Generator``, on its device; None, the global
    one), in torch's default float type (complex64 by default).  The JAX
    package draws from a ``jax.random`` key, which gives other numbers
    for the same seed."""
    device = None if generator is None else generator.device
    re = torch.randn(shape, generator=generator, device=device)
    im = torch.randn(shape, generator=generator, device=device)
    return torch.complex(re, im)


def spnoise(s, frc, smn=0.0, smx=1.0, generator=None, u=None):
    """Salt-and-pepper noise (``sporco/signal.py:42``): a share ``frc``
    of the samples of ``s`` set to ``smn`` or ``smx`` with equal
    probability, by a uniform draw ``u`` of ``s``'s shape (from
    ``generator`` when not given)."""
    s = _as_tensor(s)
    u = _uniform(s.shape, generator, u, s.device)
    x = torch.where(u < frc / 2.0, torch.as_tensor(smn, dtype=s.dtype), s)
    return torch.where(u > 1.0 - frc / 2.0,
                       torch.as_tensor(smx, dtype=s.dtype), x)


def rndmask(shp, frc, dtype=torch.float32, generator=None, u=None,
            device=None):
    """A random binary mask of shape ``shp`` with about a share ``frc``
    of zeros (``sporco/signal.py:70``), on ``device`` (the CUDA device
    unless ``"cpu"`` is asked for)."""
    return (_uniform(shp, generator, u, resolve_device(device))
            > frc).to(dtype)


def rgb2gray(rgb, axis=-1):
    """The ITU-R 601-2 luma transform over the channel axis ``axis``
    (the last by default, this package's layout;
    ``sporco/signal.py:95``)."""
    rgb = _as_tensor(rgb)
    shp = [1] * rgb.ndim
    shp[axis] = 3
    w = torch.tensor([0.299, 0.587, 0.114], dtype=rgb.dtype,
                     device=rgb.device).reshape(shp)
    return torch.sum(w * rgb, dim=axis)


def _pad_symmetric(x, pads):
    """``numpy.pad(..., mode="symmetric")`` over the trailing
    ``len(pads)`` axes, ``pads`` a ``(before, after)`` pair for each
    (each pad at most the axis's length)."""
    for i, (p0, p1) in enumerate(pads):
        ax = x.ndim - len(pads) + i
        n = x.shape[ax]
        idx = torch.cat([torch.arange(p0 - 1, -1, -1), torch.arange(n),
                         torch.arange(n - 1, n - 1 - p1, -1)]).to(x.device)
        x = torch.index_select(x, ax, idx)
    return x


def tikhonov_filter(s, lmbda, npd=16):
    """Split ``s`` into its low-pass and high-pass parts by Tikhonov
    regularisation with a gradient operator (``sporco/signal.py:244``),
    over the two trailing axes after a symmetric pad of ``npd``.
    Returns ``(lowpass, highpass)``."""
    s = _as_tensor(s)
    N0, N1 = s.shape[-2:]
    sp = _pad_symmetric(s, ((npd, npd), (npd, npd)))
    shape = (N0 + 2 * npd, N1 + 2 * npd)
    grv = torch.tensor([-1.0, 1.0], dtype=s.dtype,
                       device=s.device).reshape(2, 1)
    Gr = sf.rfftn(grv, s=shape, axes=(0, 1))
    Gc = sf.rfftn(grv.reshape(1, 2), s=shape, axes=(0, 1))
    A = 1.0 + lmbda * (Gr.conj() * Gr + Gc.conj() * Gc).real
    slp = sf.irfftn(sf.rfftn(sp, axes=(-2, -1)) / A, s=shape,
                    axes=(-2, -1))[..., npd:npd + N0, npd:npd + N1]
    return slp.to(s.dtype), (s - slp).to(s.dtype)


def gaussian(shape, sd=1.0, dtype=torch.float32, device=None):
    """A sampled Gaussian over ``[-3, 3]`` on each axis, scaled to unit
    sum (``sporco/signal.py:305``), on ``device`` (the CUDA device unless
    ``"cpu"`` is asked for)."""
    if isinstance(shape, int):
        shape = (shape,)
    device = resolve_device(device)
    gc = torch.ones((), dtype=dtype, device=device)
    for k, n in enumerate(shape):
        x = torch.linspace(-3.0, 3.0, n, dtype=dtype, device=device).reshape(
            (1,) * k + (n,) + (1,) * (len(shape) - k - 1))
        gc = gc * torch.exp(-(x ** 2) / (2.0 * sd ** 2)) \
            / (math.sqrt(2.0 * math.pi) * sd)
    return gc / torch.sum(gc)


def local_contrast_normalise(s, n=7, c=None):
    """Local contrast normalisation of the 2-D ``s`` (jarret-2009-what,
    ``sporco/signal.py:335``): the local mean under a Gaussian window of
    size ``2n + 1`` subtracted, then divided by the local norm (at least
    ``c``, 0.01 by default).  Returns ``(scn, smn, snrm)``, from which
    ``s = scn snrm + smn``."""
    s = _as_tensor(s)
    c = 0.01 if c is None else c
    w = gaussian((2 * n + 1, 2 * n + 1), sd=1.0, dtype=s.dtype,
                 device=s.device)
    pads = ((n, n), (n, n))
    sp = _pad_symmetric(s, pads)
    N0, N1 = s.shape[-2:]
    smn = sf.fftconv(w, sp, axes=(0, 1))[..., 2 * n:, 2 * n:][..., :N0, :N1]
    spd = _pad_symmetric(s - smn, pads)
    snrm = torch.sqrt(sf.fftconv(w, spd ** 2, axes=(0, 1))
                      [..., 2 * n:, 2 * n:][..., :N0, :N1])
    snrm = torch.clamp(snrm, min=c)
    return (s - smn) / snrm, smn, snrm


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
