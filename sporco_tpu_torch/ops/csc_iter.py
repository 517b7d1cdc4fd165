"""One fused ConvBPDN ADMM iteration over the packed state: the CUDA
kernel ``csrc/csc_iter.cu`` and its plain PyTorch version.

Counterpart of ``csc_iter`` in ``sporco_tpu/ops/pallas_csc_iter.py``.
Given the rolled adjoint operand ``G2`` (pos, T), the packed state
``Y``/``U`` (pos, C; the true dual is ``us * U``) and the polyphase
weights ``Wa`` (T, C) and ``Wf`` (C, T)::

    A   = G2 @ Wa
    PX  = scale * (Y - us*U) + A
    AX  = rlx * PX + (1 - rlx) * Y
    Yn  = soft(AX + us*U, thr)          (optionally >= 0)
    Un  = us*U + AX - Yn
    R1  = (Yn - Un) @ Wf,   R2 = Un @ Wf
    sums = [||PX-Yn||^2, ||Yn-Y||^2, ||PX||^2, ||Yn||^2, ||Un||^2,
            sum |wl1*PX|]

``Yn`` and ``Un`` are written into ``Y`` and ``U`` in place.  The kernel
computes ``A`` in fp32 FFMA, summed over k in order as cuBLAS does, and
runs the forward pair ``R1``/``R2`` on the tensor cores as six bf16
products of three-term splits of each operand, as accurate as fp32 sums
(see ``csrc/csc_tiles.cuh``): it splits the state while it loads it and
takes ``Wf`` also as its split from :func:`split_weight`, which a solve
makes once (the JAX package's ``Wf_split``).  With ``emit_fwd=False`` the
forward pair is skipped (its pass is not launched), ``R1``/``R2`` come
back ``None`` and ``Wf`` may be ``None``: the consensus dictionary
learning's CSC stage, whose dictionary changes before the next forward
product is needed.  With ``mixed=True`` (the fused drivers' opt-in
"mixed" precision) ``R1`` is one bf16 product of the operands rounded to
nearest, with fp32 sums (``fwd_passes=1`` of the JAX package); ``R2``
and ``A`` are as above.

:func:`csc_iter` launches the kernel for tensors on a CUDA device and
runs :func:`csc_iter_plain` for tensors on the CPU; any other device
raises.
"""

import ctypes

import numpy as np
import torch

from sporco_tpu_torch._device import fp32_precision

__all__ = ["csc_iter", "csc_iter_plain", "split_weight", "iter_supported",
           "bf16_product", "LAUNCHES", "reset_launches"]

NSUM = 6
# padding of the split weight, as csrc/csc_tiles.cuh reads it: rows to
# the forward pair's k-tile F_BK, columns to one 16-byte chunk of bf16
# (SPLIT_COLS)
SPLIT_ROWS = 32
SPLIT_COLS = 8
# launches of the CUDA kernel (not of the plain version), by wrapper
LAUNCHES = {"csc_iter": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def iter_supported(pos, C, T):
    """The JAX package's geometry rule for its TPU kernel
    (``iter_supported`` of ``pallas_csc_iter``): C and T multiples of 128
    and ``pos`` rows in blocks of 8 to 128 rows of at most 2 MB.  This
    kernel runs any geometry; the rule only routes as the JAX package
    routes (the consensus CSC stage)."""
    if C % 128 or T % 128:
        return False
    return any(pos % br == 0 and br * C * 4 <= 2 << 20
               for br in (128, 64, 32, 16, 8))


def _as_channels(v, C, device):
    """``thr``/``wl1`` as a float32 ``(C,)`` tensor or a Python float."""
    if isinstance(v, torch.Tensor):
        if v.numel() == 1:
            return v.reshape(1).to(device, torch.float32).expand(C)
        if v.shape != (C,):
            raise ValueError(f"per-channel vector must have shape ({C},), "
                             f"got {tuple(v.shape)}")
        return v.to(device, torch.float32)
    return float(v)


def _round_up(n, m):
    return -(-n // m) * m


def split_weight(W):
    """The bf16 split of a float32 ``(K, N)`` weight that the kernels
    take: ``(3, Kp, Np)`` bfloat16 whose ``[:, :K, :N]`` holds ``w1 =
    bf16(W)``, ``w2 = bf16(W - w1)``, ``w3 = bf16(W - w1 - w2)``, each
    rounded to nearest (``split_bf16_3`` of the JAX package; ``w1 + w2 +
    w3 == W`` for every normal float), zero elsewhere; ``Kp`` is ``K``
    rounded up to 32 and ``Np`` is ``N`` rounded up to 8."""
    if W.ndim != 2 or W.dtype != torch.float32:
        raise TypeError("split_weight takes a 2-D float32 tensor")
    K, N = W.shape
    out = torch.zeros((3, _round_up(K, SPLIT_ROWS), _round_up(N, SPLIT_COLS)),
                      dtype=torch.bfloat16, device=W.device)
    r = W
    for i in range(3):
        out[i, :K, :N] = r.to(torch.bfloat16)
        r = r - out[i, :K, :N].float()
    return out


def bf16_product(x, W):
    """``bf16(x) @ bf16(W)`` with float32 sums: the "mixed" forward
    product (each operand rounded to nearest bf16; the products of two
    bf16 values are exact in float32)."""
    return x.to(torch.bfloat16).float() @ W.to(torch.bfloat16).float()


def csc_iter_plain(G2, Y, U, Wa, Wf, thr, wl1, rlx, us, scale,
                   nonneg=False, emit_px=True, wf_split=None,
                   emit_fwd=True, mixed=False):
    """The plain PyTorch version of the kernel (same arguments and
    results as :func:`csc_iter`; ``wf_split`` is not read), with fp32
    contractions pinned."""
    C = Y.shape[1]
    thr = _as_channels(thr, C, Y.device)
    wl1 = _as_channels(wl1, C, Y.device)
    # the scalars in float32, as the kernel (and the TPU kernel) has them
    rlx, us, scale = (np.float32(v) for v in (rlx, us, scale))
    rlx1 = float(np.float32(1.0) - rlx)
    rlx, us, scale = float(rlx), float(us), float(scale)
    with fp32_precision():
        a = G2 @ Wa
        y = Y
        u = us * U
        px = scale * (y - u) + a
        ax = rlx * px + rlx1 * y
        axu = ax + u
        yn = torch.sign(axu) * torch.clamp(axu.abs() - thr, min=0.0)
        if nonneg:
            yn = torch.clamp(yn, min=0.0)
        un = u + ax - yn
        if not emit_fwd:
            r1 = None
        elif mixed:
            r1 = bf16_product(yn - un, Wf)
        else:
            r1 = (yn - un) @ Wf
        r2 = un @ Wf if emit_fwd else None
        d = px - yn
        e = yn - y
        sums = torch.stack([(d * d).sum(), (e * e).sum(), (px * px).sum(),
                            (yn * yn).sum(), (un * un).sum(),
                            (px.abs() * wl1).sum()])
    Y.copy_(yn)
    U.copy_(un)
    return (px if emit_px else None), Y, U, r1, r2, sums


_ARGTYPES = ([ctypes.c_void_p] * 5                  # G2 Y U Wa Wf3
             + [ctypes.c_void_p, ctypes.c_float,     # thr_v, thr_s
                ctypes.c_void_p, ctypes.c_float,     # wl1_v, wl1_s
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_int, ctypes.c_int,          # nonneg, vec
                ctypes.c_int]                        # mixed
             + [ctypes.c_void_p] * 5                 # PX R1 R2 part sums
             + [ctypes.c_int64] * 3 + [ctypes.c_void_p])


def _lib():
    from sporco_tpu_torch.ops import _nvcc
    lib = _nvcc.load("csc_iter")
    if lib.csc_iter_launch.argtypes is None:
        lib.csc_iter_launch.argtypes = _ARGTYPES
        lib.csc_iter_launch.restype = ctypes.c_int
        lib.csc_iter_scratch_floats.argtypes = [ctypes.c_int64] * 2
        lib.csc_iter_scratch_floats.restype = ctypes.c_int64
    return lib


def _check(name, t, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_split(wf_split, Wf, dev):
    """``wf_split`` checked against ``Wf``'s shape: the split the kernels
    read in place of ``Wf``."""
    if wf_split is None:
        raise ValueError("on CUDA tensors the kernel needs "
                         "wf_split=split_weight(Wf)")
    C, T = Wf.shape
    want = (3, _round_up(C, SPLIT_ROWS), _round_up(T, SPLIT_COLS))
    if not isinstance(wf_split, torch.Tensor) \
            or wf_split.dtype != torch.bfloat16:
        raise TypeError("wf_split must be a bfloat16 tensor (split_weight)")
    if wf_split.device != dev or tuple(wf_split.shape) != want \
            or not wf_split.is_contiguous():
        raise ValueError(f"wf_split must be a contiguous {want} tensor on "
                         f"{dev}, got {tuple(wf_split.shape)} on "
                         f"{wf_split.device}")
    return wf_split


def csc_iter(G2, Y, U, Wa, Wf, thr, wl1, rlx, us, scale, nonneg=False,
             emit_px=True, wf_split=None, emit_fwd=True, mixed=False):
    """One fused ADMM iteration; returns ``(PX, Yn, Un, R1, R2, sums)``
    with ``Yn is Y`` and ``Un is U`` (updated in place), ``PX`` None
    unless ``emit_px`` and ``R1``/``R2`` None unless ``emit_fwd``.
    ``thr``/``wl1`` are numbers or tensors of one element or of shape
    ``(C,)``.  ``wf_split`` is ``split_weight(Wf)``, which the kernel
    reads in place of ``Wf`` (a solve makes it once); on CUDA tensors it
    is required when ``emit_fwd``, and neither is read otherwise.
    ``mixed``: ``R1`` as one bf16 product."""
    dev = Y.device
    if dev.type == "cpu":
        return csc_iter_plain(G2, Y, U, Wa, Wf, thr, wl1, rlx, us, scale,
                              nonneg=nonneg, emit_px=emit_px,
                              emit_fwd=emit_fwd, mixed=mixed)
    if dev.type != "cuda":
        raise ValueError(f"csc_iter runs on CUDA or CPU tensors, not "
                         f"{dev.type}")
    if Y.ndim != 2 or G2.ndim != 2:
        raise ValueError("Y and G2 must be 2-D (pos, C) and (pos, T)")
    pos, C = Y.shape
    T = G2.shape[1]
    _check("G2", G2, (pos, T), dev)
    _check("Y", Y, (pos, C), dev)
    _check("U", U, (pos, C), dev)
    _check("Wa", Wa, (T, C), dev)
    if Y.data_ptr() == U.data_ptr():
        raise ValueError("Y and U must be distinct buffers")
    Wf3 = r1 = r2 = None
    if emit_fwd:
        _check("Wf", Wf, (C, T), dev)
        Wf3 = _check_split(wf_split, Wf, dev)
    thr = _as_channels(thr, C, dev)
    wl1 = _as_channels(wl1, C, dev)
    if isinstance(thr, torch.Tensor) != isinstance(wl1, torch.Tensor):
        # the kernel takes both as (C,) vectors or both as scalars
        thr, wl1 = (v if isinstance(v, torch.Tensor) else
                    torch.full((C,), v, dtype=torch.float32, device=dev)
                    for v in (thr, wl1))
    vecs = [v.contiguous() if isinstance(v, torch.Tensor) else None
            for v in (thr, wl1)]
    lib = _lib()
    px = torch.empty_like(Y) if emit_px else None
    if emit_fwd:
        r1 = torch.empty((pos, T), dtype=torch.float32, device=dev)
        r2 = torch.empty_like(r1)
    part = torch.empty(lib.csc_iter_scratch_floats(pos, C),
                       dtype=torch.float32, device=dev)
    sums = torch.empty(NSUM, dtype=torch.float32, device=dev)
    ptrs = [G2, Y, U, Wa, px, r1, r2] + [v for v in vecs if v is not None]
    vec = int(C % 4 == 0 and T % 4 == 0
              and all(t is None or t.data_ptr() % 16 == 0 for t in ptrs))

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.csc_iter_launch(
            ptr(G2), ptr(Y), ptr(U), ptr(Wa), ptr(Wf3),
            ptr(vecs[0]), 0.0 if vecs[0] is not None else thr,
            ptr(vecs[1]), 0.0 if vecs[1] is not None else wl1,
            float(rlx), float(us), float(scale), int(bool(nonneg)), vec,
            int(bool(mixed)), ptr(px), ptr(r1), ptr(r2), ptr(part), ptr(sums),
            pos, C, T, stream)
    if err != 0:
        raise RuntimeError(f"csc_iter kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["csc_iter"] += 1
    return px, Y, U, r1, r2, sums
