"""The ADMM iteration tail of the fused ConvBPDN driver in one pass: the
CUDA kernel ``csrc/csc_tail.cu`` and its plain PyTorch version.

Counterpart of ``admm_tail`` in ``sporco_tpu/ops/pallas_csc_tail.py``.
Given the x-step result ``PX``, the state ``PY`` and the dual ``PU`` in
the packed layout ``(..., C)`` (the true dual is ``us * PU``)::

    AX   = rlx * PX + (1 - rlx) * PY
    PYn  = soft(AX + us*PU, thr)        (optionally >= 0)
    PUn  = us*PU + AX - PYn
    sums = [||PX-PYn||^2, ||PYn-PY||^2, ||PX||^2, ||PYn||^2, ||PUn||^2,
            sum |wl1*PX|]

``PYn`` and ``PUn`` are written into ``PY`` and ``PU`` in place.

The JAX package ships its kernel switched off (``enabled = False``) and
sends it only the layouts of its TPU block rule (``tail_eligible``): on
its TPU, XLA's fusion of the same op chain was faster.  Eager PyTorch
fuses nothing, so the same chain as torch ops is some 25-30 launches and
about six times the kernel's traffic; the port's fused driver therefore
runs this kernel for every scalar or per-channel weight, at any packed
shape ``(R, C)``.

:func:`admm_tail` launches the kernel for tensors on a CUDA device and
runs :func:`admm_tail_plain` for tensors on the CPU; any other device
raises.
"""

import ctypes

import numpy as np
import torch

from sporco_tpu_torch.ops.csc_iter import _as_channels, _check

__all__ = ["admm_tail", "admm_tail_plain", "tail_ops", "LAUNCHES",
           "reset_launches"]

NSUM = 6
# launches of the CUDA kernel (not of the plain version)
LAUNCHES = {"admm_tail": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def tail_ops(PX, PY, PU, thr, wl1, rlx, nonneg=False):
    """The tail as torch ops on the true dual ``PU``: returns new
    ``(PYn, PUn, sums)``.  ``thr`` and ``wl1`` are numbers or tensors that
    broadcast against the packed arrays, a spatially varying weight field
    included.  The arithmetic of the kernel's plain version, and the
    fused driver's tail for a spatially varying weight, which the kernel
    does not take (the JAX package's XLA tail)."""
    # the scalars in float32, as the kernel (and the TPU kernel) has them
    rlx = np.float32(rlx)
    rlx1 = float(np.float32(1.0) - rlx)
    ax = float(rlx) * PX + rlx1 * PY
    axu = ax + PU
    yn = torch.sign(axu) * torch.clamp(axu.abs() - thr, min=0.0)
    if nonneg:
        yn = torch.clamp(yn, min=0.0)
    un = PU + ax - yn
    d = PX - yn
    e = yn - PY
    sums = torch.stack([(d * d).sum(), (e * e).sum(), (PX * PX).sum(),
                        (yn * yn).sum(), (un * un).sum(),
                        (PX.abs() * wl1).sum()])
    return yn, un, sums


def admm_tail_plain(PX, PY, PU, thr, wl1, rlx, nonneg=False, us=1.0):
    """The plain PyTorch version of the kernel (same arguments and
    results as :func:`admm_tail`)."""
    C = PX.shape[-1]
    thr = _as_channels(thr, C, PX.device)
    wl1 = _as_channels(wl1, C, PX.device)
    yn, un, sums = tail_ops(PX, PY, float(np.float32(us)) * PU, thr, wl1,
                            rlx, nonneg=nonneg)
    PY.copy_(yn)
    PU.copy_(un)
    return PY, PU, sums


_ARGTYPES = ([ctypes.c_void_p] * 3                    # PX PY PU
             + [ctypes.c_void_p, ctypes.c_float,      # thr_v, thr_s
                ctypes.c_void_p, ctypes.c_float,      # wl1_v, wl1_s
                ctypes.c_float, ctypes.c_float,       # rlx, us
                ctypes.c_int, ctypes.c_int]           # nonneg, vec
             + [ctypes.c_void_p] * 2                  # part sums
             + [ctypes.c_int64] * 2 + [ctypes.c_void_p])


def _lib():
    from sporco_tpu_torch.ops import _nvcc
    lib = _nvcc.load("csc_tail")
    if lib.csc_tail_launch.argtypes is None:
        lib.csc_tail_launch.argtypes = _ARGTYPES
        lib.csc_tail_launch.restype = ctypes.c_int
        lib.csc_tail_scratch_doubles.argtypes = [ctypes.c_int64]
        lib.csc_tail_scratch_doubles.restype = ctypes.c_int64
    return lib


def admm_tail(PX, PY, PU, thr, wl1, rlx, nonneg=False, us=1.0):
    """One pass of relaxation, l1 prox, dual update and the six sums.
    ``PX``, ``PY`` and ``PU`` share a packed shape ``(..., C)``;
    ``thr``/``wl1`` are numbers or tensors of one element or of shape
    ``(C,)``; ``us`` scales ``PU`` on load.  Returns ``(PYn, PUn, sums)``
    with ``PYn is PY`` and ``PUn is PU`` (updated in place)."""
    dev = PY.device
    if dev.type == "cpu":
        return admm_tail_plain(PX, PY, PU, thr, wl1, rlx, nonneg=nonneg,
                               us=us)
    if dev.type != "cuda":
        raise ValueError(f"admm_tail runs on CUDA or CPU tensors, not "
                         f"{dev.type}")
    shape = tuple(PY.shape)
    if len(shape) < 1 or PY.numel() == 0:
        raise ValueError("PY must have a packed shape (..., C) with at "
                         "least one element")
    for name, t in (("PX", PX), ("PY", PY), ("PU", PU)):
        _check(name, t, shape, dev)
    ptrs = {PX.data_ptr(), PY.data_ptr(), PU.data_ptr()}
    if len(ptrs) != 3:
        raise ValueError("PX, PY and PU must be distinct buffers")
    C = shape[-1]
    R = PY.numel() // C
    thr = _as_channels(thr, C, dev)
    wl1 = _as_channels(wl1, C, dev)
    vecs = [v.contiguous() if isinstance(v, torch.Tensor) else None
            for v in (thr, wl1)]
    lib = _lib()
    part = torch.empty(lib.csc_tail_scratch_doubles(R * C),
                       dtype=torch.float64, device=dev)
    sums = torch.empty(NSUM, dtype=torch.float32, device=dev)
    arrays = [PX, PY, PU] + [v for v in vecs if v is not None]
    vec = int(C % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in arrays))

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.csc_tail_launch(
            ptr(PX), ptr(PY), ptr(PU),
            ptr(vecs[0]), 0.0 if vecs[0] is not None else thr,
            ptr(vecs[1]), 0.0 if vecs[1] is not None else wl1,
            float(np.float32(rlx)), float(np.float32(us)),
            int(bool(nonneg)), vec, ptr(part), ptr(sums), R, C, stream)
    if err != 0:
        raise RuntimeError(f"admm_tail kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["admm_tail"] += 1
    return PY, PU, sums
