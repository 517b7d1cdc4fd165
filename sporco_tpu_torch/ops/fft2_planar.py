"""Batched 2-D real FFT and its inverse on planar float32 data: the CUDA
kernels ``csrc/fft2_planar.cu`` and their plain PyTorch versions.

Counterpart of ``rfft2_planar``/``irfft2_planar`` in
``sporco_tpu/ops/pallas_fft.py``::

    rfft2_planar(x)            x (..., N0, N1) -> (yr, yi) (..., N0, N1//2+1)
    irfft2_planar(yr, yi, n1)  -> x (..., N0, n1)
    irfft2_spectrum(y, n1)     complex64 y (..., N0, N1//2+1) -> x

The last is the port's own entry for a complex64 half-spectrum: the
kernel reads its real and imaginary parts where they lie, so the FFT
dispatch (``ops.fft.irfftn``) hands a spectrum over without splitting it
first.

``numpy.fft.rfftn``/``irfftn`` over the last two axes, for
``N0 = R*128`` with R in {1, 2, 4} and even ``2 <= N1 <= 2048``
(:func:`supported`).  The inverse drops the imaginary part of the first
and (even-length) last half-spectrum column after the axis-0 transform,
as numpy does, so its input need not be Hermitian.

Inside :func:`gate` (the fused drivers' device loop, whose iteration may
run after convergence, replayed from a CUDA graph) the kernels read the
loop's flag ``live`` from device memory and return before any write
where it is 0, and count their live launches on the device, in the
loop's counter, in place of :data:`LAUNCHES`; on CPU tensors a launch
with ``live`` 0 runs no plain version and returns zeros.

The wrappers launch the kernels for tensors on a CUDA device and run the
plain versions for tensors on the CPU; any other device raises.  The
plain versions compute what the TPU kernel computes
(``_fwd_kernel_exact``/``_inv_kernel_exact``): the r2c (c2r) factor
matmul on axis 1, and on axis 0 the radix-R butterflies, the twiddles
and the 128-point DFT factor applied with three real products
(Karatsuba), all in fp32.  ``precision`` is accepted for the JAX
signature; both values run full fp32 here (on the TPU ``"high"`` is a
3-pass bf16 split).
"""

import contextlib
import ctypes
import functools

import numpy as np
import torch

from sporco_tpu_torch._device import fp32_precision

__all__ = ["rfft2_planar", "irfft2_planar", "irfft2_spectrum",
           "rfft2_planar_plain", "irfft2_planar_plain", "supported",
           "gate", "LAUNCHES", "reset_launches"]

_L = 128                   # radix-128 sub-transform length of the TPU kernel
_RADICES = (1, 2, 4)       # N0 in {128, 256, 512}
_MAX_N1 = 2048
_PRECISIONS = ("default", "high", "highest")
# launches of the CUDA kernels (not of the plain versions), by kernel:
# irfft2_spectrum counts as irfft2_planar
LAUNCHES = {"rfft2_planar": 0, "irfft2_planar": 0}
# the slot of each kernel in a gate's counter
_SLOT = {"rfft2_planar": 0, "irfft2_planar": 1}
_GATES = []


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@contextlib.contextmanager
def gate(live, counter):
    """Gate the launches in the block by ``live``, a 0-d float32 tensor,
    and count them in ``counter``, an int32 tensor of two elements
    (``rfft2_planar``, ``irfft2_planar``), both on the device of the
    transforms: a kernel reads ``live`` on the device and writes nothing
    where it is 0, and adds 1 to its slot of ``counter`` where it is not
    (``irfft2_spectrum`` counts as ``irfft2_planar``).  On CPU tensors
    ``live`` is read on the host."""
    if (live.dtype != torch.float32 or live.numel() != 1
            or counter.dtype != torch.int32 or counter.numel() != 2
            or counter.device != live.device):
        raise ValueError("gate takes a one-element float32 flag and a "
                         "two-element int32 counter on one device")
    _GATES.append((live, counter))
    try:
        yield
    finally:
        _GATES.pop()


def _gate(dev):
    """The innermost gate's ``(live, counter)``, or None."""
    if not _GATES:
        return None
    g = _GATES[-1]
    if g[0].device != dev:
        raise ValueError(f"the gate is on {g[0].device}, the transform on "
                         f"{dev}")
    return g


def _dead_on_cpu(dev):
    """A launch on CPU tensors inside a gate whose ``live`` is 0."""
    g = _gate(dev)
    return g is not None and not bool(g[0])


def supported(n0, n1, dtype):
    """Whether the kernels take a ``(n0, n1)`` transform of ``dtype``
    (the rule of ``pallas_fft.supported``)."""
    if dtype != torch.float32:
        return False
    if n1 % 2 != 0 or n1 < 2 or n1 > _MAX_N1:
        return False
    return n0 % _L == 0 and n0 // _L in _RADICES


def _check_shape(n0, n1, precision):
    if precision not in _PRECISIONS:
        raise ValueError(f"invalid precision {precision!r}")
    if not supported(n0, n1, torch.float32):
        raise ValueError(f"unsupported 2-D transform size ({n0}, {n1}): "
                         "N0 must be 128, 256 or 512 and N1 even, 2..2048")


def _check_spectrum(yr, yi, n1, precision):
    """The ``(n0, k1)`` of a half-spectrum (planar ``yr``, ``yi``, or
    complex ``yr`` with ``yi`` None) for length ``n1``."""
    n0, k1 = yr.shape[-2:]
    _check_shape(n0, n1, precision)
    if k1 != n1 // 2 + 1 or (yi is not None and yi.shape != yr.shape):
        shapes = tuple(yr.shape) if yi is None else \
            f"{tuple(yr.shape)} / {tuple(yi.shape)}"
        raise ValueError(f"half-spectrum of shape {shapes} does not "
                         f"match n1 = {n1}")
    return n0, k1


# ---------------------------------------------------------------------------
# Host tables, built in float64 and cast to float32, cached per shape and
# device (the port's copy of pallas_fft._fwd_factors/_inv_factors, without
# the TPU's lane padding of the spectrum axis)

def _dev_key(device):
    return str(torch.device(device))


@functools.lru_cache(maxsize=None)
def _fwd_factors(n0, n1, device):
    k1 = n1 // 2 + 1
    ang = 2.0 * np.pi * np.outer(np.arange(n1), np.arange(k1)) / n1
    n2 = np.arange(_L)
    ang2 = 2.0 * np.pi * np.outer(n2, n2) / _L
    tw = 2.0 * np.pi * np.arange(n0 // _L)[:, None] * n2[None, :] / n0
    fac = {"Cr": np.cos(ang), "Ci": -np.sin(ang),          # (N1, K1)
           "Fr": np.cos(ang2), "Fi": -np.sin(ang2),        # DFT-128
           "Tr": np.cos(tw), "Ti": -np.sin(tw)}            # (R, 128)
    fac["Frpi"] = fac["Fr"].astype(np.float32) + fac["Fi"].astype(np.float32)
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in fac.items()}


@functools.lru_cache(maxsize=None)
def _inv_factors(n0, n1, device):
    k1 = n1 // 2 + 1
    w = np.full(k1, 2.0 / n1)
    w[0] = 1.0 / n1
    if n1 % 2 == 0:
        w[-1] = 1.0 / n1
    ang = 2.0 * np.pi * np.outer(np.arange(k1), np.arange(n1)) / n1
    n2 = np.arange(_L)
    ang2 = 2.0 * np.pi * np.outer(n2, n2) / _L
    tw = 2.0 * np.pi * np.arange(n0 // _L)[:, None] * n2[None, :] / n0
    fac = {"Ar": w[:, None] * np.cos(ang),                 # (K1, N1)
           "Ai": -w[:, None] * np.sin(ang),
           "Gr": np.cos(ang2) / n0, "Gi": np.sin(ang2) / n0,
           "Tr": np.cos(tw), "Ti": np.sin(tw)}
    fac["Grpi"] = fac["Gr"].astype(np.float32) + fac["Gi"].astype(np.float32)
    return {k: torch.tensor(np.asarray(v, np.float32), device=device)
            for k, v in fac.items()}


@functools.lru_cache(maxsize=None)
def _twiddles(n, device):
    """The kernels' table (2, n): cos and sin of 2 pi k / n."""
    ang = 2.0 * np.pi * np.arange(n) / n
    return torch.tensor(np.stack([np.cos(ang), np.sin(ang)]).astype(
        np.float32), device=device)


# ---------------------------------------------------------------------------
# The plain versions (the TPU kernel's arithmetic in PyTorch ops)

def _butterfly(ar, ai, r, dim, inverse):
    """Radix-r butterflies over ``dim`` (r in {1, 2, 4}); the radix-4
    twiddles W_4 are {1, -i, -1, i} forward and their conjugates
    inverse."""
    if r == 1:
        return ar, ai
    a = [t.select(dim, i) for t in (ar, ai) for i in range(r)]
    if r == 2:
        return (torch.stack([a[0] + a[1], a[0] - a[1]], dim),
                torch.stack([a[2] + a[3], a[2] - a[3]], dim))
    xr, xi = a[:4], a[4:]
    s02r, s02i = xr[0] + xr[2], xi[0] + xi[2]
    d02r, d02i = xr[0] - xr[2], xi[0] - xi[2]
    s13r, s13i = xr[1] + xr[3], xi[1] + xi[3]
    d13r, d13i = xr[1] - xr[3], xi[1] - xi[3]
    sg = -1.0 if inverse else 1.0
    br = torch.stack([s02r + s13r, d02r + sg * d13i, s02r - s13r,
                      d02r - sg * d13i], dim)
    bi = torch.stack([s02i + s13i, d02i - sg * d13r, s02i - s13i,
                      d02i + sg * d13r], dim)
    return br, bi


def rfft2_planar_plain(x, precision="high"):
    """The plain PyTorch version of :func:`rfft2_planar`."""
    n0, n1 = x.shape[-2:]
    _check_shape(n0, n1, precision)
    k1 = n1 // 2 + 1
    r = n0 // _L
    lead = tuple(x.shape[:-2])
    f = _fwd_factors(n0, n1, _dev_key(x.device))
    with fp32_precision():
        xb = x.reshape((-1, n0, n1)).to(torch.float32)
        b = xb.shape[0]
        # r2c along axis 1, then the radix-R split of axis 0
        ar = (xb @ f["Cr"]).reshape(b, r, _L, k1)
        ai = (xb @ f["Ci"]).reshape(b, r, _L, k1)
        br, bi = _butterfly(ar, ai, r, 1, inverse=False)
        tr, ti = f["Tr"][:, :, None], f["Ti"][:, :, None]
        cr = br * tr - bi * ti
        ci = br * ti + bi * tr
        crw = cr.permute(0, 2, 1, 3).reshape(b, _L, r * k1)
        ciw = ci.permute(0, 2, 1, 3).reshape(b, _L, r * k1)
        m1 = f["Fr"] @ crw
        m2 = f["Fi"] @ ciw
        m3 = f["Frpi"] @ (crw + ciw)
        yr = (m1 - m2).reshape(lead + (n0, k1))
        yi = (m3 - m1 - m2).reshape(lead + (n0, k1))
    return yr, yi


def irfft2_planar_plain(yr, yi, n1, precision="high"):
    """The plain PyTorch version of :func:`irfft2_planar`."""
    n0, k1 = _check_spectrum(yr, yi, n1, precision)
    r = n0 // _L
    lead = tuple(yr.shape[:-2])
    f = _inv_factors(n0, n1, _dev_key(yr.device))
    with fp32_precision():
        xr = yr.reshape((-1, _L, r * k1)).to(torch.float32)
        xi = yi.reshape((-1, _L, r * k1)).to(torch.float32)
        b = xr.shape[0]
        # inverse 128-point DFTs over k2 (Karatsuba), twiddles, butterflies
        m1 = f["Gr"] @ xr
        m2 = f["Gi"] @ xi
        m3 = f["Grpi"] @ (xr + xi)
        er = (m1 - m2).reshape(b, _L, r, k1)
        ei = (m3 - m1 - m2).reshape(b, _L, r, k1)
        tr, ti = f["Tr"].T[:, :, None], f["Ti"].T[:, :, None]
        cr = er * tr - ei * ti
        ci = er * ti + ei * tr
        br, bi = _butterfly(cr, ci, r, 2, inverse=True)
        vr = br.permute(0, 2, 1, 3).reshape(b, n0, k1)
        vi = bi.permute(0, 2, 1, 3).reshape(b, n0, k1)
        # c2r along axis 1 (Hermitian weights folded into the factors)
        x = vr @ f["Ar"] + vi @ f["Ai"]
    return x.reshape(lead + (n0, n1))


# ---------------------------------------------------------------------------
# The CUDA kernels

def _lib():
    from sporco_tpu_torch.ops import _nvcc
    lib = _nvcc.load("fft2_planar")
    if lib.rfft2_planar_launch.argtypes is None:
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        tail = [i64, i32, i32, vp, vp, vp]     # B, n0, n1, gate, cnt, st
        lib.rfft2_planar_launch.argtypes = [vp] * 5 + tail
        lib.rfft2_planar_launch.restype = ctypes.c_int
        lib.irfft2_planar_launch.argtypes = [vp] * 6 + tail
        lib.irfft2_planar_launch.restype = ctypes.c_int
        lib.irfft2_spectrum_launch.argtypes = [vp] * 5 + tail
        lib.irfft2_spectrum_launch.restype = ctypes.c_int
    return lib


def _device_of(name, *ts, dtype=torch.float32):
    for t in ts:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name}: inputs must be tensors")
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: inputs are on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: inputs must be {dtype}, got "
                            f"{t.dtype}")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on CUDA or CPU tensors, not "
                         f"{dev.type}")
    return dev


def _launch(lib, name, dev, *args, count=None):
    """Launch ``name`` on the current stream of ``dev`` with ``args`` and
    the innermost gate, and count it."""
    count = count or name
    g = _gate(dev)
    live, cnt = (None, None) if g is None else (
        g[0].data_ptr(), g[1].data_ptr() + 4 * _SLOT[count])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = getattr(lib, f"{name}_launch")(*args, live, cnt, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    if g is None:
        LAUNCHES[count] += 1


def rfft2_planar(x, precision="high"):
    """Forward 2-D real DFT of the last two axes of float32 ``x``;
    returns the planar halves ``(yr, yi)`` of shape
    ``x.shape[:-1] + (N1//2+1,)``."""
    dev = _device_of("rfft2_planar", x)
    if dev.type == "cpu":
        if _dead_on_cpu(dev):
            n0, n1 = x.shape[-2:]
            _check_shape(n0, n1, precision)
            y = x.new_zeros(x.shape[:-1] + (n1 // 2 + 1,))
            return y, y.clone()
        return rfft2_planar_plain(x, precision)
    n0, n1 = x.shape[-2:]
    _check_shape(n0, n1, precision)
    lib = _lib()
    lead = tuple(x.shape[:-2])
    x = x.resolve_neg().contiguous()
    yr = torch.empty(lead + (n0, n1 // 2 + 1), dtype=torch.float32,
                     device=dev)
    yi = torch.empty_like(yr)
    b = x.numel() // (n0 * n1)
    if b == 0:
        return yr, yi
    key = _dev_key(dev)
    _launch(lib, "rfft2_planar", dev, x.data_ptr(), yr.data_ptr(),
            yi.data_ptr(), _twiddles(n0, key).data_ptr(),
            _twiddles(n1, key).data_ptr(), b, n0, n1)
    return yr, yi


def irfft2_planar(yr, yi, n1, precision="high"):
    """Inverse of :func:`rfft2_planar`: the planar half-spectrum
    ``(yr, yi)`` with last axis ``n1//2+1`` -> real float32 array with
    last axis ``n1``."""
    dev = _device_of("irfft2_planar", yr, yi)
    if dev.type == "cpu":
        if _dead_on_cpu(dev):
            _check_spectrum(yr, yi, n1, precision)
            return yr.new_zeros(yr.shape[:-1] + (n1,))
        return irfft2_planar_plain(yr, yi, n1, precision)
    _check_spectrum(yr, yi, n1, precision)
    yr, yi = yr.resolve_neg().contiguous(), yi.resolve_neg().contiguous()
    return _irfft2_launch("irfft2_planar", (yr, yi), n1)


def irfft2_spectrum(y, n1, precision="high"):
    """:func:`irfft2_planar` of a complex64 half-spectrum ``y`` with last
    axis ``n1//2+1``: the kernel reads ``y`` as it lies in memory, so
    only a view it cannot read (conjugate or negative bit set, not
    contiguous) is copied first.  On the CPU it is the plain version of
    ``(y.real, y.imag)``."""
    dev = _device_of("irfft2_spectrum", y, dtype=torch.complex64)
    if dev.type == "cpu":
        if _dead_on_cpu(dev):
            _check_spectrum(y, None, n1, precision)
            return y.real.new_zeros(y.shape[:-1] + (n1,))
        return irfft2_planar_plain(y.real, y.imag, n1, precision)
    _check_spectrum(y, None, n1, precision)
    y = y.resolve_conj().resolve_neg().contiguous()
    return _irfft2_launch("irfft2_spectrum", (y,), n1)


def _irfft2_launch(name, inputs, n1):
    """Launch ``name`` on the contiguous CUDA half-spectrum ``inputs``
    (planar or complex), into a new real array through a scratch array
    of twice the spectrum's floats."""
    dev = inputs[0].device
    n0, k1 = inputs[0].shape[-2:]
    lead = tuple(inputs[0].shape[:-2])
    x = torch.empty(lead + (n0, n1), dtype=torch.float32, device=dev)
    b = x.numel() // (n0 * n1)
    if b == 0:
        return x
    lib = _lib()
    s = torch.empty(2 * b * n0 * k1, dtype=torch.float32, device=dev)
    key = _dev_key(dev)
    _launch(lib, name, dev, *(t.data_ptr() for t in inputs), x.data_ptr(),
            s.data_ptr(), _twiddles(n0, key).data_ptr(),
            _twiddles(n1, key).data_ptr(), b, n0, n1, count="irfft2_planar")
    return x
