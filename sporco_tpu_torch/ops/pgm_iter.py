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
The kernel reads ``thr``'s scalar, ``rL``, ``beta`` and the flag
``live`` from a float32 block in device memory, as ``csc_iter`` does.

:func:`pgm_iter` launches the kernel for tensors on a CUDA device and
runs :func:`pgm_iter_plain` for tensors on the CPU; any other device
raises.
"""

import ctypes

import torch

from sporco_tpu_torch._device import fp32_precision
from sporco_tpu_torch.ops.csc_iter import (_as_channels, _check,
                                           _check_split, bf16_product,
                                           check_counter, is_live,
                                           scalar_block, split_thr)

__all__ = ["pgm_iter", "pgm_iter_plain", "LAUNCHES", "reset_launches"]

NSUM = 2
# launches of the CUDA kernel (not of the plain version)
LAUNCHES = {"pgm_iter": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _outputs(out, Y, T):
    """The output buffers ``(R1, RX, sums)``: ``out`` given by the
    caller, which a dead launch leaves as they were, or new ones (of
    ``T`` columns, the width of ``Wf``)."""
    if out is not None:
        return out
    pos = Y.shape[0]
    r1 = torch.empty((pos, T), dtype=torch.float32, device=Y.device)
    return (r1, torch.empty_like(r1),
            torch.empty(NSUM, dtype=torch.float32, device=Y.device))


def pgm_iter_plain(G2, Y, Xprv, Wa, Wf, thr, wl1, rL, beta, nonneg=False,
                   wf_split=None, mixed=False, live=None, counter=None,
                   out=None):
    """The plain PyTorch version of the kernel (same arguments and
    results as :func:`pgm_iter`; ``wf_split`` and ``counter`` are not
    read), with fp32 contractions pinned.  It reads its scalars from the
    same float32 block as the kernel, and with ``live`` 0 it writes
    nothing."""
    C = Y.shape[1]
    thr_s, thr_v = split_thr(thr, C, Y.device)
    wl1 = _as_channels(wl1, C, Y.device)
    # the scalars in float32, as the kernel (and the TPU kernel) has them
    scal = scalar_block(Y.device, live, thr_s, rL, beta)
    r1, rx, sums = _outputs(out, Y, Wf.shape[1])
    if live is not None and not bool(scal[0]):
        return Xprv, Y, r1, rx, sums
    _, thr_s, rL, beta = scal
    thr = thr_s if thr_v is None else thr_v
    with fp32_precision():
        a = G2 @ Wa
        v = Y - rL * a
        x = torch.sign(v) * torch.clamp(v.abs() - thr, min=0.0)
        if nonneg:
            x = torch.clamp(x, min=0.0)
        yn = x + beta * (x - Xprv)
        r1.copy_(bf16_product(yn, Wf) if mixed else yn @ Wf)
        rx.copy_(x @ Wf)
        d = x - Y
        sums.copy_(torch.stack([(d * d).sum(), (x.abs() * wl1).sum()]))
    Xprv.copy_(x)
    Y.copy_(yn)
    return Xprv, Y, r1, rx, sums


_ARGTYPES = ([ctypes.c_void_p] * 5                  # G2 Y Xprv Wa Wf3
             + [ctypes.c_void_p, ctypes.c_void_p,    # thr_v, wl1_v
                ctypes.c_float, ctypes.c_void_p,     # wl1_s, scal
                ctypes.c_int, ctypes.c_int,          # nonneg, vec
                ctypes.c_int]                        # mixed
             + [ctypes.c_void_p] * 5                 # R1 RX part sums cnt
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
             wf_split=None, mixed=False, live=None, counter=None, out=None):
    """One fused FISTA iteration; returns ``(X, Yn, R1, RX, sums)`` with
    ``X is Xprv`` and ``Yn is Y`` (updated in place).  ``thr`` is a
    number, a one-element tensor or a ``(C,)`` tensor, ``wl1`` a number
    or a tensor of one element or of shape ``(C,)``; ``rL`` and ``beta``
    are numbers or 0-d tensors, read by the kernel from device memory as
    in :func:`~sporco_tpu_torch.ops.csc_iter.csc_iter`, where ``live``,
    ``counter`` and ``out`` = ``(R1, RX, sums)`` are as there.
    ``wf_split`` is ``split_weight(Wf)``, which the kernel reads in place
    of ``Wf`` (a solve makes it once); on CUDA tensors it is required.
    ``mixed``: ``R1`` as one bf16 product."""
    dev = Y.device
    if dev.type == "cpu":
        if not is_live(live):
            return (Xprv, Y) + tuple(_outputs(out, Y, Wf.shape[1]))
        return pgm_iter_plain(G2, Y, Xprv, Wa, Wf, thr, wl1, rL, beta,
                              nonneg=nonneg, mixed=mixed, out=out)
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
    check_counter(counter, dev)
    thr_s, thr_v = split_thr(thr, C, dev)
    wl1 = _as_channels(wl1, C, dev)
    scal = scalar_block(dev, live, thr_s, rL, beta)
    vecs = [v.contiguous() if isinstance(v, torch.Tensor) else None
            for v in (thr_v, wl1)]
    lib = _lib()
    r1, rx, sums = _outputs(out, Y, T)
    _check("R1", r1, (pos, T), dev)
    _check("RX", rx, (pos, T), dev)
    _check("sums", sums, (NSUM,), dev)
    part = torch.empty(lib.pgm_iter_scratch_floats(pos, C),
                       dtype=torch.float32, device=dev)
    ptrs = [G2, Y, Xprv, Wa, r1, rx] + [v for v in vecs if v is not None]
    vec = int(C % 4 == 0 and T % 4 == 0
              and all(t.data_ptr() % 16 == 0 for t in ptrs))

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.pgm_iter_launch(
            ptr(G2), ptr(Y), ptr(Xprv), ptr(Wa), ptr(Wf3), ptr(vecs[0]),
            ptr(vecs[1]), 0.0 if vecs[1] is not None else wl1, ptr(scal),
            int(bool(nonneg)), vec, int(bool(mixed)), ptr(r1), ptr(rx),
            ptr(part), ptr(sums), ptr(counter), pos, C, T, stream)
    if err != 0:
        raise RuntimeError(f"pgm_iter kernel launch failed: CUDA error "
                           f"{err}")
    if counter is None:
        LAUNCHES["pgm_iter"] += 1
    return Xprv, Y, r1, rx, sums
