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

The scalars that change from one iteration to the next (``thr`` as a
scalar, ``us``, ``scale``) reach the kernel in a float32 block in device
memory (:func:`scalar_block`) with a flag ``live``, so that the fused
drivers' loop can run as a captured CUDA graph
(:mod:`sporco_tpu_torch.ops.device_loop`): where ``live`` is 0 the
kernel writes nothing (the state, the outputs given in ``out``, the
sums) and a ``counter`` on the device is not advanced.

:func:`csc_iter` launches the kernel for tensors on a CUDA device and
runs :func:`csc_iter_plain` for tensors on the CPU; any other device
raises.
"""

import ctypes

import numpy as np
import torch

from sporco_tpu_torch._device import fp32_precision

__all__ = ["csc_iter", "csc_iter_plain", "split_weight", "iter_supported",
           "bf16_product", "scalar_block", "LAUNCHES", "reset_launches"]

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


def split_thr(thr, C, device):
    """``thr`` as ``(thr_s, thr_v)``: a scalar (a number or a one-element
    tensor, which goes to the scalar block) and None, or 0.0 and the
    float32 ``(C,)`` vector."""
    if isinstance(thr, torch.Tensor) and thr.numel() != 1:
        return 0.0, _as_channels(thr, C, device)
    if isinstance(thr, torch.Tensor):
        return thr.reshape(()), None
    return float(thr), None


def scalar_block(device, live, *vals):
    """The kernels' float32 block ``[live, *vals]`` on ``device``
    (``live`` None means 1; at most four entries).  The values are
    numbers or 0-d tensors: from tensors (the fused drivers' device loop,
    under CUDA-graph capture) it is a stack on the device; from numbers on
    a CUDA device, a slot of :class:`_PinnedRing`, one copy that does not
    wait on the stream."""
    items = (1.0 if live is None else live,) + tuple(vals)
    if not any(isinstance(v, torch.Tensor) for v in items):
        vals32 = [float(np.float32(v)) for v in items]
        if device.type == "cpu":
            return torch.tensor(vals32, dtype=torch.float32)
        return _PinnedRing.of(device).put(vals32)
    return torch.stack([
        v.reshape(()).to(device, torch.float32)
        if isinstance(v, torch.Tensor)
        else torch.full((), float(np.float32(v)), dtype=torch.float32,
                        device=device) for v in items])


class _PinnedRing:
    """The scalar blocks of eager launches on one device and stream: a
    ring of ``SLOTS`` slots of four floats in pinned host memory and its
    twin on the device.  A launch writes its numbers into the next host
    slot and copies it to the device slot on the stream, without waiting;
    the host slot is written again only once the event recorded after
    its last copy has passed, and the device slot is overwritten by a
    copy queued on the same stream after every kernel that read it."""

    SLOTS = 64
    _rings = {}

    def __init__(self, device, stream):
        self.stream = stream
        self.host = torch.zeros((self.SLOTS, 4), dtype=torch.float32,
                                pin_memory=True)
        self.host_np = self.host.numpy()
        self.dev = torch.zeros((self.SLOTS, 4), dtype=torch.float32,
                               device=device)
        self.done = [None] * self.SLOTS
        self.i = 0

    @classmethod
    def of(cls, device):
        stream = torch.cuda.current_stream(device)
        key = (str(stream.device), stream.cuda_stream)
        ring = cls._rings.get(key)
        if ring is None:
            ring = cls._rings[key] = cls(stream.device, stream)
        return ring

    def put(self, vals):
        i, n = self.i, len(vals)
        self.i = (i + 1) % self.SLOTS
        if self.done[i] is not None:
            self.done[i].synchronize()
        self.host_np[i, :n] = vals
        out = self.dev[i, :n]
        out.copy_(self.host[i, :n], non_blocking=True)
        self.done[i] = torch.cuda.Event()
        self.done[i].record(self.stream)
        return out


def is_live(live):
    """Whether a launch on CPU tensors does its work: ``live`` is None or
    a nonzero 0-d CPU tensor (the plain versions' counterpart of the
    kernels' early return)."""
    return live is None or bool(live)


def _as_vectors(thr_s, thr_v, wl1, C, device):
    """Both weights as (C,) vectors when either is one: the kernel takes
    both as vectors or both as scalars."""
    if (thr_v is None) == (not isinstance(wl1, torch.Tensor)):
        return thr_s, thr_v, wl1
    if thr_v is None:
        thr_v = (thr_s.reshape(1).to(device, torch.float32).expand(C)
                 if isinstance(thr_s, torch.Tensor)
                 else torch.full((C,), thr_s, dtype=torch.float32,
                                 device=device))
        return 0.0, thr_v.contiguous(), wl1
    return thr_s, thr_v, torch.full((C,), wl1, dtype=torch.float32,
                                    device=device)


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


def _outputs(out, Y, pos, T, emit_px, emit_fwd):
    """The output buffers ``(PX, R1, R2, sums)``: ``out`` = ``(R1, R2,
    sums)`` given by the caller (R1/R2 None without ``emit_fwd``), which
    a dead launch leaves as they were, or new ones (R1/R2 of ``T``
    columns, the width of ``Wf``)."""
    px = torch.empty_like(Y) if emit_px else None
    if out is not None:
        r1, r2, sums = out
        return px, r1, r2, sums
    r1 = r2 = None
    if emit_fwd:
        r1 = torch.empty((pos, T), dtype=torch.float32, device=Y.device)
        r2 = torch.empty_like(r1)
    return px, r1, r2, torch.empty(NSUM, dtype=torch.float32,
                                   device=Y.device)


def csc_iter_plain(G2, Y, U, Wa, Wf, thr, wl1, rlx, us, scale,
                   nonneg=False, emit_px=True, wf_split=None,
                   emit_fwd=True, mixed=False, live=None, counter=None,
                   out=None):
    """The plain PyTorch version of the kernel (same arguments and
    results as :func:`csc_iter`; ``wf_split`` and ``counter`` are not
    read), with fp32 contractions pinned.  It reads its scalars from the
    same float32 block as the kernel, and with ``live`` 0 it writes
    nothing."""
    C = Y.shape[1]
    thr_s, thr_v = split_thr(thr, C, Y.device)
    wl1 = _as_channels(wl1, C, Y.device)
    # the scalars in float32, as the kernel (and the TPU kernel) has them
    scal = scalar_block(Y.device, live, thr_s, us, scale)
    px, r1, r2, sums = _outputs(out, Y, Y.shape[0],
                                Wf.shape[1] if emit_fwd else 0, emit_px,
                                emit_fwd)
    if live is not None and not bool(scal[0]):
        return px, Y, U, r1, r2, sums
    _, thr_s, us, scale = scal
    thr = thr_s if thr_v is None else thr_v
    rlx = np.float32(rlx)
    rlx1 = float(np.float32(1.0) - rlx)
    rlx = float(rlx)
    with fp32_precision():
        a = G2 @ Wa
        y = Y
        u = us * U
        pxv = scale * (y - u) + a
        ax = rlx * pxv + rlx1 * y
        axu = ax + u
        yn = torch.sign(axu) * torch.clamp(axu.abs() - thr, min=0.0)
        if nonneg:
            yn = torch.clamp(yn, min=0.0)
        un = u + ax - yn
        if emit_fwd:
            r1.copy_(bf16_product(yn - un, Wf) if mixed else (yn - un) @ Wf)
            r2.copy_(un @ Wf)
        d = pxv - yn
        e = yn - y
        sums.copy_(torch.stack([(d * d).sum(), (e * e).sum(),
                                (pxv * pxv).sum(), (yn * yn).sum(),
                                (un * un).sum(), (pxv.abs() * wl1).sum()]))
    if emit_px:
        px.copy_(pxv)
    Y.copy_(yn)
    U.copy_(un)
    return px, Y, U, r1, r2, sums


_ARGTYPES = ([ctypes.c_void_p] * 5                  # G2 Y U Wa Wf3
             + [ctypes.c_void_p, ctypes.c_void_p,    # thr_v, wl1_v
                ctypes.c_float, ctypes.c_void_p,     # wl1_s, scal
                ctypes.c_float,                      # rlx
                ctypes.c_int, ctypes.c_int,          # nonneg, vec
                ctypes.c_int]                        # mixed
             + [ctypes.c_void_p] * 6                 # PX R1 R2 part sums cnt
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


def check_counter(counter, dev):
    """``counter``: None or a one-element int32 tensor on ``dev``."""
    if counter is not None and (
            not isinstance(counter, torch.Tensor)
            or counter.dtype != torch.int32 or counter.numel() != 1
            or counter.device != dev):
        raise ValueError(f"counter must be a one-element int32 tensor on "
                         f"{dev}")


def csc_iter(G2, Y, U, Wa, Wf, thr, wl1, rlx, us, scale, nonneg=False,
             emit_px=True, wf_split=None, emit_fwd=True, mixed=False,
             live=None, counter=None, out=None):
    """One fused ADMM iteration; returns ``(PX, Yn, Un, R1, R2, sums)``
    with ``Yn is Y`` and ``Un is U`` (updated in place), ``PX`` None
    unless ``emit_px`` and ``R1``/``R2`` None unless ``emit_fwd``.
    ``thr`` is a number, a one-element tensor or a ``(C,)`` tensor,
    ``wl1`` a number or a tensor of one element or of shape ``(C,)``;
    ``us`` and ``scale`` are numbers or 0-d tensors.  The kernel reads
    the scalars that change over a solve from device memory
    (:func:`scalar_block`), so a launch with 0-d tensors there can be
    captured into a CUDA graph.  ``live`` (a 0-d tensor on the device, or
    None for 1): where it is 0 the launch writes nothing.  ``counter`` (a
    one-element int32 tensor on the device, or None): the kernel adds 1
    to it if ``live``, and the launch is then not counted in
    ``LAUNCHES``.  ``out`` = ``(R1, R2, sums)``: buffers for the outputs
    (R1/R2 None without ``emit_fwd``), else new ones.  ``wf_split`` is
    ``split_weight(Wf)``, which the kernel reads in place of ``Wf`` (a
    solve makes it once); on CUDA tensors it is required when
    ``emit_fwd``, and neither is read otherwise.  ``mixed``: ``R1`` as one
    bf16 product."""
    dev = Y.device
    if dev.type == "cpu":
        if not is_live(live):
            px, r1, r2, sums = _outputs(
                out, Y, Y.shape[0], Wf.shape[1] if emit_fwd else 0,
                emit_px, emit_fwd)
            return px, Y, U, r1, r2, sums
        return csc_iter_plain(G2, Y, U, Wa, Wf, thr, wl1, rlx, us, scale,
                              nonneg=nonneg, emit_px=emit_px,
                              emit_fwd=emit_fwd, mixed=mixed, out=out)
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
    Wf3 = None
    if emit_fwd:
        _check("Wf", Wf, (C, T), dev)
        Wf3 = _check_split(wf_split, Wf, dev)
    check_counter(counter, dev)
    thr_s, thr_v = split_thr(thr, C, dev)
    wl1 = _as_channels(wl1, C, dev)
    thr_s, thr_v, wl1 = _as_vectors(thr_s, thr_v, wl1, C, dev)
    scal = scalar_block(dev, live, thr_s, us, scale)
    vecs = [v.contiguous() if isinstance(v, torch.Tensor) else None
            for v in (thr_v, wl1)]
    lib = _lib()
    px, r1, r2, sums = _outputs(out, Y, pos, T, emit_px, emit_fwd)
    if emit_fwd:
        _check("R1", r1, (pos, T), dev)
        _check("R2", r2, (pos, T), dev)
    _check("sums", sums, (NSUM,), dev)
    part = torch.empty(lib.csc_iter_scratch_floats(pos, C),
                       dtype=torch.float32, device=dev)
    ptrs = [G2, Y, U, Wa, px, r1, r2] + [v for v in vecs if v is not None]
    vec = int(C % 4 == 0 and T % 4 == 0
              and all(t is None or t.data_ptr() % 16 == 0 for t in ptrs))

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.csc_iter_launch(
            ptr(G2), ptr(Y), ptr(U), ptr(Wa), ptr(Wf3), ptr(vecs[0]),
            ptr(vecs[1]), 0.0 if vecs[1] is not None else wl1, ptr(scal),
            float(np.float32(rlx)), int(bool(nonneg)), vec,
            int(bool(mixed)), ptr(px), ptr(r1), ptr(r2), ptr(part),
            ptr(sums), ptr(counter), pos, C, T, stream)
    if err != 0:
        raise RuntimeError(f"csc_iter kernel launch failed: CUDA error "
                           f"{err}")
    if counter is None:
        LAUNCHES["csc_iter"] += 1
    return px, Y, U, r1, r2, sums
