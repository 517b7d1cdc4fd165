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

``PYn`` and ``PUn`` are written into ``PY`` and ``PU`` in place.  The
kernel reads ``thr``'s scalar, ``us`` and the flag ``live`` from a
float32 block in device memory, as ``csc_iter`` does.

The AMS form (``ams=(Wp, nimp)``, Additive Mask Simulation; the select
of ``sporco_tpu/ops/fused_csc.py:816-817``): packed channel ``c`` holds
filter ``c mod M`` of polyphase phase ``c // M`` with ``M = C //
Wp.shape[-1]``, and on the last ``nimp`` filters, the impulse maps,
``PYn = (1 - Wp[row, c // M]) * (AX + us*PU)`` replaces the shrunk value
(after ``nonneg``).  ``Wp`` is the fidelity mask packed once per solve
as ``(R, PS^2)``; the sums run over every column.

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

from sporco_tpu_torch.ops.csc_iter import (_as_channels, _check,
                                           check_counter, is_live,
                                           scalar_block, split_thr)

__all__ = ["admm_tail", "admm_tail_plain", "tail_ops", "LAUNCHES",
           "reset_launches"]

NSUM = 6
# launches of the CUDA kernel (not of the plain version)
LAUNCHES = {"admm_tail": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _ams_select(yn, axu, Wp, nimp):
    """The AMS select: the last ``nimp`` of every ``M = C // P`` packed
    channels take ``(1 - Wp) * axu``, ``Wp`` of shape ``(R, P)``."""
    shape = yn.shape
    C = shape[-1]
    R, P = Wp.shape
    if C % P or yn.numel() != R * C:
        raise ValueError(f"AMS mask of shape {tuple(Wp.shape)} does not "
                         f"fit a packed state of shape {tuple(shape)}")
    M = C // P
    sel = torch.zeros(M, dtype=torch.bool, device=yn.device)
    sel[M - nimp:] = True
    imp = (1.0 - Wp)[:, :, None] * axu.reshape(R, P, M)
    return torch.where(sel, imp, yn.reshape(R, P, M)).reshape(shape)


def _check_ams(ams, R, C, dev):
    """``ams`` as ``(Wp, M, nimp)`` for the kernel, checked."""
    Wp, nimp = ams
    if not isinstance(Wp, torch.Tensor) or Wp.ndim != 2 \
            or Wp.shape[0] != R or Wp.shape[1] < 1 or C % Wp.shape[1]:
        raise ValueError(f"the AMS mask must be a ({R}, P) tensor with P "
                         f"dividing {C}")
    _check("Wp", Wp, (R, Wp.shape[1]), dev)
    M = C // Wp.shape[1]
    if not 0 < int(nimp) <= M:
        raise ValueError(f"nimp must be in 1..{M}, got {nimp}")
    return Wp, M, int(nimp)


def tail_ops(PX, PY, PU, thr, wl1, rlx, nonneg=False, ams=None):
    """The tail as torch ops on the true dual ``PU``: returns new
    ``(PYn, PUn, sums)``.  ``thr`` and ``wl1`` are numbers or tensors that
    broadcast against the packed arrays, a spatially varying weight field
    included; ``ams`` is ``None`` or ``(Wp, nimp)`` (the AMS form).  The
    arithmetic of the kernel's plain version, and the fused driver's
    tail for a spatially varying weight, which the kernel does not take
    (the JAX package's XLA tail)."""
    # the scalars in float32, as the kernel (and the TPU kernel) has them
    rlx = np.float32(rlx)
    rlx1 = float(np.float32(1.0) - rlx)
    ax = float(rlx) * PX + rlx1 * PY
    axu = ax + PU
    yn = torch.sign(axu) * torch.clamp(axu.abs() - thr, min=0.0)
    if nonneg:
        yn = torch.clamp(yn, min=0.0)
    if ams is not None:
        yn = _ams_select(yn, axu, *ams)
    un = PU + ax - yn
    d = PX - yn
    e = yn - PY
    sums = torch.stack([(d * d).sum(), (e * e).sum(), (PX * PX).sum(),
                        (yn * yn).sum(), (un * un).sum(),
                        (PX.abs() * wl1).sum()])
    return yn, un, sums


def admm_tail_plain(PX, PY, PU, thr, wl1, rlx, nonneg=False, us=1.0,
                    ams=None, live=None, counter=None, out=None):
    """The plain PyTorch version of the kernel (same arguments and
    results as :func:`admm_tail`; ``counter`` is not read).  It reads its
    scalars from the same float32 block as the kernel, and with ``live``
    0 it writes nothing."""
    C = PX.shape[-1]
    thr_s, thr_v = split_thr(thr, C, PX.device)
    wl1 = _as_channels(wl1, C, PX.device)
    scal = scalar_block(PX.device, live, thr_s, us, 0.0)
    sums = _sums_buffer(out, PX.device)
    if live is not None and not bool(scal[0]):
        return PY, PU, sums
    _, thr_s, us, _ = scal
    yn, un, s = tail_ops(PX, PY, us * PU, thr_s if thr_v is None else thr_v,
                         wl1, rlx, nonneg=nonneg, ams=ams)
    PY.copy_(yn)
    PU.copy_(un)
    sums.copy_(s)
    return PY, PU, sums


def _sums_buffer(out, device):
    """The sums' buffer: ``out`` given by the caller, which a dead
    launch leaves as it was, or a new one."""
    if out is not None:
        return out
    return torch.empty(NSUM, dtype=torch.float32, device=device)


_ARGTYPES = ([ctypes.c_void_p] * 3                    # PX PY PU
             + [ctypes.c_void_p, ctypes.c_void_p,     # thr_v, wl1_v
                ctypes.c_float, ctypes.c_void_p,      # wl1_s, scal
                ctypes.c_float,                       # rlx
                ctypes.c_int, ctypes.c_int]           # nonneg, vec
             + [ctypes.c_void_p, ctypes.c_int64,      # Wp, M, nimp
                ctypes.c_int64]
             + [ctypes.c_void_p] * 3                  # part sums cnt
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


def admm_tail(PX, PY, PU, thr, wl1, rlx, nonneg=False, us=1.0, ams=None,
              live=None, counter=None, out=None):
    """One pass of relaxation, l1 prox, dual update and the six sums.
    ``PX``, ``PY`` and ``PU`` share a packed shape ``(..., C)``;
    ``thr`` is a number, a one-element tensor or a ``(C,)`` tensor,
    ``wl1`` a number or a tensor of one element or of shape ``(C,)``;
    ``us`` (a number or a 0-d tensor) scales ``PU`` on load; ``ams`` is
    ``None`` or ``(Wp, nimp)`` with ``Wp`` a contiguous float32 ``(R, P)``
    mask, ``P`` dividing ``C`` (the AMS form).  The kernel reads ``thr``'s
    scalar and ``us`` from device memory, and ``live``, ``counter`` and
    ``out`` (the sums' buffer) are as in
    :func:`~sporco_tpu_torch.ops.csc_iter.csc_iter`.  Returns ``(PYn, PUn,
    sums)`` with ``PYn is PY`` and ``PUn is PU`` (updated in place)."""
    dev = PY.device
    if dev.type == "cpu":
        if not is_live(live):
            return PY, PU, _sums_buffer(out, dev)
        return admm_tail_plain(PX, PY, PU, thr, wl1, rlx, nonneg=nonneg,
                               us=us, ams=ams, out=out)
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
    Wp, Ma, nimp = (None, 0, 0) if ams is None \
        else _check_ams(ams, R, C, dev)
    check_counter(counter, dev)
    thr_s, thr_v = split_thr(thr, C, dev)
    wl1 = _as_channels(wl1, C, dev)
    scal = scalar_block(dev, live, thr_s, us, 0.0)
    vecs = [v.contiguous() if isinstance(v, torch.Tensor) else None
            for v in (thr_v, wl1)]
    lib = _lib()
    part = torch.empty(lib.csc_tail_scratch_doubles(R * C),
                       dtype=torch.float64, device=dev)
    sums = _sums_buffer(out, dev)
    _check("sums", sums, (NSUM,), dev)
    arrays = [PX, PY, PU] + [v for v in vecs if v is not None]
    vec = int(C % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in arrays))

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.csc_tail_launch(
            ptr(PX), ptr(PY), ptr(PU), ptr(vecs[0]), ptr(vecs[1]),
            0.0 if vecs[1] is not None else wl1, ptr(scal),
            float(np.float32(rlx)), int(bool(nonneg)), vec, ptr(Wp), Ma,
            nimp, ptr(part), ptr(sums), ptr(counter), R, C, stream)
    if err != 0:
        raise RuntimeError(f"admm_tail kernel launch failed: CUDA error "
                           f"{err}")
    if counter is None:
        LAUNCHES["admm_tail"] += 1
    return PY, PU, sums
