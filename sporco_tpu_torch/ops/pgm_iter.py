"""One fused ConvBPDN FISTA iteration over the packed state: the CUDA
kernel ``csrc/pgm_iter.cu`` and its plain PyTorch version.

Counterpart of ``pgm_iter`` in ``sporco_tpu/ops/pallas_csc_iter.py``.
Given the rolled gradient operand ``G2`` (pos, T), the packed state
``Y`` (the extrapolation point) and ``Xprv`` (the previous iterate),
both (pos, C), and the polyphase weights ``Wa`` (T, C) and ``Wf``
(C, T)::

    A   = G2 @ Wa
    V   = Y - rL * A                    (rL = 1 / L)
    X   = soft(V, thr)                  (optionally >= 0)
    Yn  = X + beta * (X - Xprv)
    R1  = Yn @ Wf,   RX = X @ Wf
    sums = [||X - Y||^2, sum |wl1 * X|]

``X`` is written into ``Xprv`` and ``Yn`` into ``Y`` in place (the JAX
kernel's aliasing ``{2: 0, 1: 1}``).  The products run as in
``csc_iter``: ``A`` in fp32 FFMA, ``R1``/``RX`` on the tensor cores with
``Wf`` split by :func:`~sporco_tpu_torch.ops.csc_iter.split_weight`.
With ``mixed=True`` ``R1`` is one bf16 product, as in ``csc_iter``.

:func:`pgm_iter` launches the kernel for tensors on a CUDA device and
runs :func:`pgm_iter_plain` for tensors on the CPU; any other device
raises.
"""

import ctypes

import numpy as np
import torch

from sporco_tpu_torch._device import fp32_precision
from sporco_tpu_torch.ops.csc_iter import (_as_channels, _check,
                                           _check_split, bf16_product)

__all__ = ["pgm_iter", "pgm_iter_plain", "LAUNCHES", "reset_launches"]

NSUM = 2
# launches of the CUDA kernel (not of the plain version)
LAUNCHES = {"pgm_iter": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def pgm_iter_plain(G2, Y, Xprv, Wa, Wf, thr, wl1, rL, beta, nonneg=False,
                   wf_split=None, mixed=False):
    """The plain PyTorch version of the kernel (same arguments and
    results as :func:`pgm_iter`; ``wf_split`` is not read), with fp32
    contractions pinned."""
    C = Y.shape[1]
    thr = _as_channels(thr, C, Y.device)
    wl1 = _as_channels(wl1, C, Y.device)
    # the scalars in float32, as the kernel (and the TPU kernel) has them
    rL, beta = float(np.float32(rL)), float(np.float32(beta))
    with fp32_precision():
        a = G2 @ Wa
        v = Y - rL * a
        x = torch.sign(v) * torch.clamp(v.abs() - thr, min=0.0)
        if nonneg:
            x = torch.clamp(x, min=0.0)
        yn = x + beta * (x - Xprv)
        r1 = bf16_product(yn, Wf) if mixed else yn @ Wf
        rx = x @ Wf
        d = x - Y
        sums = torch.stack([(d * d).sum(), (x.abs() * wl1).sum()])
    Xprv.copy_(x)
    Y.copy_(yn)
    return Xprv, Y, r1, rx, sums


_ARGTYPES = ([ctypes.c_void_p] * 5                  # G2 Y Xprv Wa Wf3
             + [ctypes.c_void_p, ctypes.c_float,     # thr_v, thr_s
                ctypes.c_void_p, ctypes.c_float,     # wl1_v, wl1_s
                ctypes.c_float, ctypes.c_float,      # rL, beta
                ctypes.c_int, ctypes.c_int,          # nonneg, vec
                ctypes.c_int]                        # mixed
             + [ctypes.c_void_p] * 4                 # R1 RX part sums
             + [ctypes.c_int64] * 3 + [ctypes.c_void_p])


def _lib():
    from sporco_tpu_torch.ops import _nvcc
    lib = _nvcc.load("pgm_iter")
    if lib.pgm_iter_launch.argtypes is None:
        lib.pgm_iter_launch.argtypes = _ARGTYPES
        lib.pgm_iter_launch.restype = ctypes.c_int
        lib.pgm_iter_scratch_floats.argtypes = [ctypes.c_int64] * 2
        lib.pgm_iter_scratch_floats.restype = ctypes.c_int64
    return lib


def pgm_iter(G2, Y, Xprv, Wa, Wf, thr, wl1, rL, beta, nonneg=False,
             wf_split=None, mixed=False):
    """One fused FISTA iteration; returns ``(X, Yn, R1, RX, sums)`` with
    ``X is Xprv`` and ``Yn is Y`` (updated in place).  ``thr``/``wl1``
    are numbers or tensors of one element or of shape ``(C,)``.
    ``wf_split`` is ``split_weight(Wf)``, which the kernel reads in place
    of ``Wf`` (a solve makes it once); on CUDA tensors it is required.
    ``mixed``: ``R1`` as one bf16 product."""
    dev = Y.device
    if dev.type == "cpu":
        return pgm_iter_plain(G2, Y, Xprv, Wa, Wf, thr, wl1, rL, beta,
                              nonneg=nonneg, mixed=mixed)
    if dev.type != "cuda":
        raise ValueError(f"pgm_iter runs on CUDA or CPU tensors, not "
                         f"{dev.type}")
    if Y.ndim != 2 or G2.ndim != 2:
        raise ValueError("Y and G2 must be 2-D (pos, C) and (pos, T)")
    pos, C = Y.shape
    T = G2.shape[1]
    _check("G2", G2, (pos, T), dev)
    _check("Y", Y, (pos, C), dev)
    _check("Xprv", Xprv, (pos, C), dev)
    _check("Wa", Wa, (T, C), dev)
    _check("Wf", Wf, (C, T), dev)
    if Y.data_ptr() == Xprv.data_ptr():
        raise ValueError("Y and Xprv must be distinct buffers")
    Wf3 = _check_split(wf_split, Wf, dev)
    thr = _as_channels(thr, C, dev)
    wl1 = _as_channels(wl1, C, dev)
    vecs = [v.contiguous() if isinstance(v, torch.Tensor) else None
            for v in (thr, wl1)]
    lib = _lib()
    r1 = torch.empty((pos, T), dtype=torch.float32, device=dev)
    rx = torch.empty_like(r1)
    part = torch.empty(lib.pgm_iter_scratch_floats(pos, C),
                       dtype=torch.float32, device=dev)
    sums = torch.empty(NSUM, dtype=torch.float32, device=dev)
    ptrs = [G2, Y, Xprv, Wa, r1, rx] + [v for v in vecs if v is not None]
    vec = int(C % 4 == 0 and T % 4 == 0
              and all(t.data_ptr() % 16 == 0 for t in ptrs))

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pgm_iter_launch(
            ptr(G2), ptr(Y), ptr(Xprv), ptr(Wa), ptr(Wf3),
            ptr(vecs[0]), 0.0 if vecs[0] is not None else thr,
            ptr(vecs[1]), 0.0 if vecs[1] is not None else wl1,
            float(np.float32(rL)), float(np.float32(beta)),
            int(bool(nonneg)), vec, int(bool(mixed)), ptr(r1), ptr(rx),
            ptr(part), ptr(sums), pos, C, T, stream)
    if err != 0:
        raise RuntimeError(f"pgm_iter kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["pgm_iter"] += 1
    return Xprv, Y, r1, rx, sums
