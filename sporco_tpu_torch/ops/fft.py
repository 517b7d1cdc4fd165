"""FFT glue (counterpart of ``sporco_tpu.ops.fft`` and of the dispatch in
``sporco_tpu.ops.mxufft``).

Transforms run on ``torch.fft``, except the one the JAX package sends to
its Pallas kernels: at precision ``"highest"`` (the default, as
``mxufft``'s), a 2-D ``rfftn``/``irfftn`` over the last two axes of a
float32 (or complex64) array whose size the kernels take
(:func:`sporco_tpu_torch.ops.fft2_planar.supported`) runs
``rfft2_planar``/``irfft2_planar`` (the rule of ``mxufft._pallas_2d_ok``);
a complex64 spectrum goes to ``irfft2_spectrum``, which reads it without
splitting it into planes.  The orthonormal DCT-II of the spline solver
(:func:`dctii`/:func:`idctii`) is a product with the DCT matrix along
each axis.
:func:`use_planar_fft` chooses where: ``"auto"`` for CUDA tensors only,
``"always"`` also for CPU tensors (through the kernels' plain versions,
as the CPU tests do), ``"never"``.  Spatial axes are trailing, as in the
JAX package.
"""

import math

import numpy as np
import torch

from sporco_tpu_torch._device import fp32_precision
from sporco_tpu_torch.ops import fft2_planar

__all__ = ["fftn", "ifftn", "rfftn", "irfftn", "fl2norm2", "rfl2norm2",
           "fftconv", "dctii", "idctii", "complex_dtype", "real_dtype",
           "torch_dtype", "numpy_dtype", "set_precision", "get_precision",
           "use_planar_fft", "is_complex_dtype", "empty_aligned_func",
           "fftn_func", "ifftn_func", "fl2norm2_func"]

_PRECISION = "highest"
_PLANAR_MODE = "auto"


def set_precision(p):
    """Set the DFT precision: ``"highest"`` dispatches the planar
    kernels; ``"high"`` and ``"default"`` keep every transform on
    ``torch.fft`` (on the TPU they select bf16 splits)."""
    global _PRECISION
    if p not in ("default", "high", "highest"):
        raise ValueError(f"invalid precision {p!r}")
    _PRECISION = p


def get_precision():
    return _PRECISION


def use_planar_fft(mode):
    """Where the planar kernels run: ``"auto"`` (CUDA tensors only),
    ``"always"`` (CPU tensors too, through the plain versions) or
    ``"never"``."""
    global _PLANAR_MODE
    if mode not in ("auto", "always", "never"):
        raise ValueError(f"invalid mode {mode!r}")
    _PLANAR_MODE = mode


def complex_dtype(dtype):
    """Complex dtype corresponding to a real ``dtype``."""
    if dtype.is_complex:
        return dtype
    return torch.complex128 if dtype == torch.float64 else torch.complex64


def real_dtype(dtype):
    """Real dtype corresponding to a complex ``dtype``."""
    if not dtype.is_complex:
        return dtype
    return torch.float64 if dtype == torch.complex128 else torch.float32


def is_complex_dtype(dtype):
    """True if ``dtype`` (a torch dtype, a numpy dtype or its name) is
    complex."""
    return torch_dtype(dtype).is_complex


def torch_dtype(dtype):
    """``dtype`` (a torch dtype, a numpy dtype or its name) as a torch
    dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, np.dtype(dtype).name)


def numpy_dtype(dtype):
    """The numpy dtype of a torch ``dtype``."""
    return torch.empty((), dtype=dtype).numpy().dtype


def _norm_axes(a, s, axes):
    if axes is None:
        axes = tuple(range(a.ndim)) if s is None \
            else tuple(range(a.ndim - len(s), a.ndim))
    else:
        axes = tuple(ax % a.ndim for ax in axes)
    if s is None:
        s = tuple(a.shape[ax] for ax in axes)
    return tuple(s), axes


def _planar_ok(a, s, axes):
    """``mxufft._pallas_2d_ok``, with the device rule of
    :func:`use_planar_fft`."""
    if _PRECISION != "highest" or _PLANAR_MODE == "never":
        return False
    if _PLANAR_MODE == "auto" and a.device.type != "cuda":
        return False
    if len(axes) != 2 or tuple(axes) != (a.ndim - 2, a.ndim - 1):
        return False
    if a.dtype not in (torch.float32, torch.complex64):
        return False
    return fft2_planar.supported(s[0], s[1], torch.float32)


def _resize_axis(x, n, axis):
    """Zero-pad or truncate ``x`` to length ``n`` along ``axis``."""
    ln = x.shape[axis]
    if ln >= n:
        return x.narrow(axis, 0, n)
    pad = [0, 0] * (x.ndim - 1 - axis % x.ndim) + [0, n - ln]
    return torch.nn.functional.pad(x, pad)


def fftn(a, s=None, axes=None):
    """n-dimensional complex DFT."""
    return torch.fft.fftn(a, s=s, dim=axes)


def ifftn(a, s=None, axes=None):
    """n-dimensional inverse complex DFT."""
    return torch.fft.ifftn(a, s=s, dim=axes)


def rfftn(a, s=None, axes=None):
    """n-dimensional real DFT (half-spectrum on the final axis)."""
    s, axes = _norm_axes(a, s, axes)
    if _planar_ok(a, s, axes) and not a.is_complex():
        for n, ax in zip(s, axes):
            a = _resize_axis(a, n, ax)
        yr, yi = fft2_planar.rfft2_planar(a, precision=_PRECISION)
        return torch.complex(yr, yi)
    return torch.fft.rfftn(a, s=s, dim=axes)


def irfftn(a, s, axes=None):
    """n-dimensional inverse real DFT; ``s`` (the real-domain shape of
    the transformed axes) is required."""
    s = tuple(s)
    if axes is None:
        axes = tuple(range(a.ndim - len(s), a.ndim))
    else:
        axes = tuple(ax % a.ndim for ax in axes)
    if (_planar_ok(a, s, axes) and a.shape[axes[-1]] == s[-1] // 2 + 1
            and a.shape[axes[-2]] == s[-2]):
        if a.is_complex():
            return fft2_planar.irfft2_spectrum(a, s[-1],
                                               precision=_PRECISION)
        return fft2_planar.irfft2_planar(a, torch.zeros_like(a), s[-1],
                                         precision=_PRECISION)
    return torch.fft.irfftn(a, s=s, dim=axes)


def fftconv(a, b, axes=None, origin=None):
    """Multi-dimensional circular convolution of real arrays via the DFT
    (``sporco/fft.py:376-417``): the support per axis is the larger of
    the two operands'; ``origin`` rolls the filter origin to that
    index."""
    if axes is None:
        axes = tuple(range(a.ndim))
    axes = tuple(ax % max(a.ndim, b.ndim) for ax in axes)
    sn = tuple(max(a.shape[ax], b.shape[ax]) for ax in axes)
    ab = irfftn(rfftn(a, s=sn, axes=axes) * rfftn(b, s=sn, axes=axes),
                s=sn, axes=axes)
    if origin is not None:
        ab = torch.roll(ab, tuple(-o for o in origin), dims=axes)
    return ab


_DCT_MATRICES = {}


def _dct_matrix(n, dtype, device):
    """The orthonormal DCT-II matrix of length ``n``, ``C[k, j] =
    sqrt((2 - [k == 0]) / n) cos(pi (2 j + 1) k / (2 n))``, made in
    float64 and kept per (n, dtype, device)."""
    key = (n, dtype, str(device))
    if key not in _DCT_MATRICES:
        k = np.arange(n)[:, None]
        c = np.cos(np.pi * (2 * np.arange(n)[None, :] + 1) * k / (2 * n))
        c *= np.sqrt(2.0 / n)
        c[0] /= np.sqrt(2.0)
        _DCT_MATRICES[key] = torch.as_tensor(c, dtype=dtype).to(device)
    return _DCT_MATRICES[key]


def _dct_axes(x, axes, inverse):
    if axes is None:
        axes = tuple(range(x.ndim))
    with fp32_precision():
        for ax in axes:
            c = _dct_matrix(x.shape[ax], x.dtype, x.device)
            x = torch.movedim(torch.movedim(x, ax, -1)
                              @ (c if inverse else c.T), -1, ax)
    return x


def dctii(x, axes=None):
    """Orthonormal multi-dimensional DCT-II over ``axes`` (all by
    default), as ``scipy.fft.dctn(x, type=2, norm="ortho")``: the spline
    solver's transform."""
    return _dct_axes(x, axes, inverse=False)


def idctii(x, axes=None):
    """Orthonormal multi-dimensional inverse DCT-II (the DCT-III), the
    inverse of :func:`dctii`."""
    return _dct_axes(x, axes, inverse=True)


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


# ---------------------------------------------------------------------------
# Real/complex dispatch (``sporco/fft.py:488-588``): a solver that takes
# complex D or S binds the transform family at construction.

def empty_aligned_func(real=True):
    """Compatibility with the reference: alignment means nothing here, so
    ``torch.empty`` for either family."""
    del real
    return torch.empty


def _ifftn_s(a, s, axes=None):
    return ifftn(a, s=s, axes=axes)


def _fl2norm2_xs(xf, xs, axis=None):
    return fl2norm2(xf, axis=axis)


def fftn_func(real=True):
    """The forward transform of real (:func:`rfftn`) or complex
    (:func:`fftn`) problems."""
    return rfftn if real else fftn


def ifftn_func(real=True):
    """The inverse transform, ``f(a, s, axes=None)``: :func:`irfftn` for
    real problems (``s`` required), :func:`ifftn` for complex ones."""
    return irfftn if real else _ifftn_s


def fl2norm2_func(real=True):
    """The Parseval norm of the bound family, ``f(xf, xs, axis=None)``:
    :func:`rfl2norm2` for real problems, :func:`fl2norm2` (``xs``
    unused) for complex ones."""
    return rfl2norm2 if real else _fl2norm2_xs
