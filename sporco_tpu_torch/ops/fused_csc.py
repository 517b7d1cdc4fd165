"""Fused spatial-Woodbury ConvBPDN ADMM driver and fused packed-layout
FISTA problem (counterpart of ``sporco_tpu.ops.fused_csc``).

The x-step of single-channel 2-D ConvBPDN is solved in space by the
Woodbury identity::

    x = scale * yu + D^H irfft((Sf - scale * rfft(D yu)) / (DHD + beta))

with the whole ADMM state kept in a polyphase (space-to-depth) layout
folded by ``PS = 8`` per axis, which turns the convolutions with ``D``
into dense matmuls (``scale = rho / beta`` and ``beta = rho + mu`` give
the elastic net).  The driver has the JAX package's two iteration
bodies:

- ``body_pk`` (``l1`` and ``elastic`` with a scalar or per-filter
  ``L1Weight``): the small spectral glue (the rolls, one rfft2/irfft2
  pair and the per-bin division) in PyTorch and everything that touches
  the packed state arrays in one call of
  :func:`sporco_tpu_torch.ops.csc_iter.csc_iter`, which also produces
  the next iteration's forward product.  AutoRho's dual rescale is
  deferred through the factor ``us`` and folded into that product by
  linearity: ``(Y - us U) @ Wf = R1 + (1 - us) R2``.  X is rebuilt after
  the loop as the x-step at the final ``(Y, U, rho)``.
- ``body`` (``gradreg``, any variant with a spatially varying
  ``L1Weight``, and every AMS-masked solve): the x-step (the spatial
  one, or for ``gradreg`` a per-bin solve over the M-channel
  half-spectrum), then the tail of relaxation, l1 prox, dual update and
  the six sums in one call of :func:`sporco_tpu_torch.ops.csc_tail.admm_tail`
  for a scalar or per-filter weight, as torch ops for a spatially
  varying one.  Under Additive Mask Simulation (``cfg.ams_nimp``, the
  last filter an impulse) the tail takes its AMS form: the impulse map
  takes ``(1 - W) (AX + U)`` with the mask packed once per solve.

The matmul precision (:func:`set_matmul_precision`): "high", the
default, keeps every product fp32-faithful; the opt-in "mixed" computes
the kernels' forward product ``R1`` (``csc_iter`` and ``pgm_iter``) as
one bf16 product, as the JAX package's ``fwd_passes = 1``.  The XLA-side
products of the JAX package's ``body`` ignore "mixed" off the TPU (an
fp32 dot there is exact), and so do the port's torch products.

A colour dictionary (Cd = C in {2, 3} channels, coefficient maps shared
across them) keeps the state at the single-channel size; its products
grow by Cd (``xstep_kernels`` of a (C, M, nd0, nd1) block) and the
per-bin division becomes a Cd x Cd Hermitian solve (the rank-Cd
Woodbury identity, :func:`spatial_xstep_mc`).  A multi-channel signal
with a single-channel dictionary is C independent problems sharing D:
:func:`cbpdn_solve_cfold` and :func:`pgm_cbpdn_solve_cfold` fold its
channels into the batch axis, which is exact.

The loop runs on the device (:mod:`sporco_tpu_torch.ops.device_loop`):
the stopping test, AutoRho and the stats row of an iteration are
computed there from the kernel's six sums and the objective's spectral
terms, the iteration is captured as a CUDA graph and replayed in blocks
of 8 with one host read a block.  It reproduces the JAX driver's
iteration count, stats rows and returned ``U = us * U``.

The FISTA (PGM) form of the same problem keeps its state in the same
packed layout, where the gradient ``D^H(D y - s)`` is two dense products
and needs no FFT.  Its plain configuration runs one call of
:func:`sporco_tpu_torch.ops.pgm_iter.pgm_iter` per iteration (gradient
product, prox, momentum and the next forward product); backtracking,
the step-size policies, the monotone variant and a spatially varying
``L1Weight`` run the generic PGM loop of
:mod:`sporco_tpu_torch.solvers.pgm` on the packed problem.
"""

import dataclasses
import functools
import math

import numpy as np
import torch

from sporco_tpu_torch._device import fp32_precision
from sporco_tpu_torch.ops import csc_tail
from sporco_tpu_torch.ops import fft as sf
from sporco_tpu_torch.ops import fft2_planar
from sporco_tpu_torch.ops.csc_iter import LAUNCHES as CSC_ITER_LAUNCHES
from sporco_tpu_torch.ops.csc_iter import csc_iter, split_weight
from sporco_tpu_torch.ops.csc_tail import tail_ops
from sporco_tpu_torch.ops.pgm_iter import LAUNCHES as PGM_ITER_LAUNCHES
from sporco_tpu_torch.ops.pgm_iter import pgm_iter
from sporco_tpu_torch.solvers import pgm as _pgm
from sporco_tpu_torch.ops import device_loop
from sporco_tpu_torch.solvers.admm import (ADMMState, _stats_tensor,
                                           const_div, norm_residuals_t,
                                           sqrt_t, update_rho_t, write_row)
from sporco_tpu_torch.solvers.pgm import (PGMProblem, momentum_update_t,
                                          stop_tol, stop_tol_t)
from sporco_tpu_torch.utils.signal import gradient_filters

__all__ = ["cbpdn_solve", "cbpdn_solve_cfold", "eligible", "cfold_eligible",
           "set_matmul_precision", "get_matmul_precision", "ams_mask",
           "pgm_cbpdn_solve", "pgm_cbpdn_solve_cfold", "pgm_eligible",
           "pgm_cfold_eligible", "consensus_eligible", "xstep_kernels",
           "spatial_xstep", "spatial_xstep_mc", "poly_pack", "poly_unpack",
           "pack_state", "unpack_state", "PS", "MAX_SUPPORT"]

PS = 8            # polyphase factor (spatial fold per axis)
MAX_SUPPORT = 24  # largest filter support the spatial form beats FFT at

f32 = np.float32

# The matmul precision of the kernels' forward product R1: "high" (six
# bf16 products of three-term splits, as accurate as fp32 sums) or the
# opt-in "mixed" (one bf16 product; sporco_tpu/ops/fused_csc.py:60-86).
_MATMUL_PRECISION = "high"


def set_matmul_precision(mode):
    """Select the fused drivers' forward-product precision: "high"
    (default, fp32-faithful) or "mixed" (R1 as one bf16 product)."""
    global _MATMUL_PRECISION
    if mode not in ("high", "mixed"):
        raise ValueError("mode must be 'high' or 'mixed'")
    _MATMUL_PRECISION = mode


def get_matmul_precision():
    return _MATMUL_PRECISION


# ---------------------------------------------------------------------------
# Polyphase packing

def poly_pack(A, ps=PS):
    """(..., N0, N1) -> (..., N0/ps, N1/ps, ps*ps) with channel order
    (w0, w1): A[..., w0 + ps p, w1 + ps q] = P[..., p, q, w0*ps + w1]."""
    lead = tuple(A.shape[:-2])
    n0, n1 = A.shape[-2:]
    P = A.reshape(lead + (n0 // ps, ps, n1 // ps, ps))
    nl = len(lead)
    perm = tuple(range(nl)) + (nl, nl + 2, nl + 1, nl + 3)
    return P.permute(perm).reshape(lead + (n0 // ps, n1 // ps, ps * ps))


def poly_unpack(P, ps=PS):
    """Inverse of :func:`poly_pack`."""
    lead = tuple(P.shape[:-3])
    p0, p1 = P.shape[-3:-1]
    nl = len(lead)
    A = P.reshape(lead + (p0, p1, ps, ps))
    perm = tuple(range(nl)) + (nl, nl + 2, nl + 1, nl + 3)
    return A.permute(perm).reshape(lead + (p0 * ps, p1 * ps))


def pack_state(A, ps=PS, copy=True, out=None):
    """Internal CSC layout (K, 1, M, N0, N1) -> polyphase
    (K, N0/ps, N1/ps, ps*ps*M) with channel order (w0, w1, m); a new
    contiguous tensor, or with ``copy`` False a view of ``A`` where one
    is possible (a permuted view of a contiguous ``A``), or written into
    ``out`` (a contiguous tensor of that shape), which it returns."""
    K, _, M, n0, n1 = A.shape
    P = poly_pack(A.reshape(K, M, n0, n1), ps)     # (K, M, p0, p1, ps*ps)
    P = P.permute(0, 2, 3, 4, 1)                   # (K, p0, p1, ps*ps, M)
    shape = (K, n0 // ps, n1 // ps, ps * ps * M)
    if out is not None:
        if tuple(out.shape) != shape:
            raise ValueError(f"pack_state: out is {tuple(out.shape)}, "
                             f"not {shape}")
        out.view(P.shape).copy_(P)
        return out
    if not copy:
        return P.reshape(shape)
    return P.reshape(shape).contiguous()


def unpack_state(P, M, ps=PS):
    """Inverse of :func:`pack_state`."""
    K, p0, p1, _ = P.shape
    A = P.reshape(K, p0, p1, ps * ps, M).permute(0, 4, 1, 2, 3)
    return poly_unpack(A, ps).reshape(K, 1, M, p0 * ps, p1 * ps)


# ---------------------------------------------------------------------------
# Polyphase convolution weights built from the dictionary

def _sel_fwd(nd, ps):
    """Selector S[a, k, w, u] = 1 iff the forward tap ``yu[x - u]`` at
    output phase ``a`` reads input phase ``w = (a - u) mod ps`` at
    polyphase shift ``j``, mapped to padded-conv tap ``k = J - j``."""
    J = -(-(nd - 1) // ps)
    S = np.zeros((ps, J + 1, ps, nd), np.float64)
    for a in range(ps):
        for u in range(nd):
            w = (a - u) % ps
            j = (w - (a - u)) // ps
            S[a, J - j, w, u] = 1.0
    return S, J


def _sel_adj(nd, ps):
    """Selector for the adjoint (correlation) ``G[x + u]``: output phase
    ``a`` reads phase ``w = (a + u) mod ps`` at tap ``k = (a+u-w)/ps``."""
    J = -(-(nd - 1) // ps)
    S = np.zeros((ps, J + 1, ps, nd), np.float64)
    for a in range(ps):
        for u in range(nd):
            w = (a + u) % ps
            j = (a + u - w) // ps
            S[a, j, w, u] = 1.0
    return S, J


def _fwd_kernel(D, nd0, nd1, ps):
    """HWIO kernel of ``R_c = sum_m d_cm (*) yu_m`` in polyphase for a
    (C, M, nd0, nd1) dictionary: input channels (w0, w1, m), output
    channels (c, a0, a1).  The selectors are 0/1 with one nonzero term
    per output (and per output of either pairwise contraction, so the
    optimized einsum, in float64 on the host, only moves entries of
    ``D``; the naive one loops over every index for about a second)."""
    C, M = D.shape[:2]
    S0, J0 = _sel_fwd(nd0, ps)
    S1, J1 = _sel_fwd(nd1, ps)
    ker = np.einsum("cmuv,akwu,blzv->klwzmcab", D, S0, S1, optimize=True)
    return ker.reshape(J0 + 1, J1 + 1, ps * ps * M, C * ps * ps), J0, J1


def _adj_kernel(D, nd0, nd1, ps):
    """HWIO kernel of ``(D^H G)_m = sum_c corr(G_c, d_cm)`` in polyphase:
    input channels (c, w0, w1), output channels (a0, a1, m)."""
    C, M = D.shape[:2]
    S0, J0 = _sel_adj(nd0, ps)
    S1, J1 = _sel_adj(nd1, ps)
    ker = np.einsum("cmuv,akwu,blzv->klcwzabm", D, S0, S1, optimize=True)
    return ker.reshape(J0 + 1, J1 + 1, C * ps * ps, ps * ps * M), J0, J1


@functools.lru_cache(maxsize=None)
def _weight_index(C, M, nd0, nd1, ps):
    """Where each entry of the polyphase weights comes from: flat indices
    into ``(0, D.ravel())`` of a (C, M, nd0, nd1) dictionary, 0 for the
    zeros.  The selectors put one term of ``D`` in each entry, so the
    einsums of :func:`_fwd_kernel`/:func:`_adj_kernel` on the indices
    themselves (exact in float64) give the maps."""
    idx = np.arange(1, C * M * nd0 * nd1 + 1, dtype=np.float64).reshape(
        C, M, nd0, nd1)
    kf, jf0, jf1 = _fwd_kernel(idx, nd0, nd1, ps)
    ka, ja0, ja1 = _adj_kernel(idx, nd0, nd1, ps)
    Cs = ps * ps * M
    Wf = np.transpose(kf, (2, 0, 1, 3)).reshape(
        Cs, (jf0 + 1) * (jf1 + 1) * C * ps * ps)
    Wa = ka.reshape((ja0 + 1) * (ja1 + 1) * C * ps * ps, Cs)
    return (np.rint(Wf).astype(np.int64), np.rint(Wa).astype(np.int64),
            (jf0, jf1, ja0, ja1))


_WEIGHT_INDEX_ON = {}


def xstep_kernels(Dsm, nd0, nd1, ps=PS):
    """Packed single-matmul weights for the spatial-Woodbury x-step.

    ``Dsm`` is the spatial dictionary block ``(M, nd0, nd1)``, or
    ``(C, M, nd0, nd1)`` for a C-channel dictionary (``xstep_kernels_mc``
    of the JAX package; C = 1 gives the same weights as the 3-D block).
    Returns ``(Wf, Wa, (jf0, jf1, ja0, ja1))``: the forward/adjoint
    polyphase matmul weights, ``Wf`` (ps^2 M, (jf0+1)(jf1+1) C ps^2) and
    ``Wa`` ((ja0+1)(ja1+1) C ps^2, ps^2 M), as float32 tensors on
    ``Dsm``'s device, and their circular-roll tap radii.  The weights
    are gathered from ``Dsm`` on its device (no host read: the consensus
    loop builds them every iteration).
    """
    D = Dsm if Dsm.ndim == 4 else Dsm.unsqueeze(0)
    C, M = D.shape[:2]
    key = (C, M, nd0, nd1, ps, str(D.device))
    if key not in _WEIGHT_INDEX_ON:
        fi, ai, js = _weight_index(C, M, nd0, nd1, ps)
        _WEIGHT_INDEX_ON[key] = (torch.as_tensor(fi, device=D.device),
                                 torch.as_tensor(ai, device=D.device), js)
    fi, ai, js = _WEIGHT_INDEX_ON[key]
    flat = torch.cat([D.new_zeros(1), D.detach().reshape(-1)]).to(
        torch.float32)
    return flat[fi], flat[ai], js


def _fwd_combine(o, J0, J1, ps, C=1):
    """Epilogue of the forward polyphase conv: roll-and-sum the per-tap
    matmul outputs ``o`` of shape (K, p0, p1, T*C*ps*ps) into the
    channel-packed (K, p0, p1, C*ps*ps), channel order (c, w0, w1)
    (``_fwd_combine_ch`` of the JAX package)."""
    K, p0, p1, _ = o.shape
    T = (J0 + 1) * (J1 + 1)
    o = o.reshape(K, p0, p1, T, C * ps * ps)
    out = 0.0
    for kx in range(J0 + 1):
        for ky in range(J1 + 1):
            t = kx * (J1 + 1) + ky
            out = out + torch.roll(o[:, :, :, t], (J0 - kx, J1 - ky),
                                   dims=(1, 2))
    return out


def _conv_fwd_mm(Pyu, Wf, J0, J1, ps):
    """Forward polyphase conv as one dense matmul plus circular rolls of
    the small per-tap outputs."""
    return _fwd_combine(Pyu @ Wf, J0, J1, ps)


def _adj_rolls(Gp, J0, J1):
    """Prologue of the adjoint polyphase conv: concat of the rolled
    single-channel operand."""
    gs = [torch.roll(Gp, (-kx, -ky), dims=(1, 2))
          for kx in range(J0 + 1) for ky in range(J1 + 1)]
    return torch.cat(gs, dim=-1)


def _conv_adj_mm(Gp, Wa, J0, J1):
    """Adjoint polyphase conv as rolled-input concat plus one dense
    matmul."""
    return _adj_rolls(Gp, J0, J1) @ Wa


def _pack_ch(A, ps=PS):
    """(K, C, n0, n1) -> channel-packed (K, p0, p1, C*ps*ps), channel
    order (c, w0, w1)."""
    K, C, n0, n1 = A.shape
    P = poly_pack(A, ps)                           # (K, C, p0, p1, ps^2)
    return P.permute(0, 2, 3, 1, 4).reshape(K, n0 // ps, n1 // ps,
                                            C * ps * ps)


def _fwd_combine_mc(o, J0, J1, C, ps):
    """Forward epilogue to the C-channel image (K, C, n0, n1)."""
    K, p0, p1, _ = o.shape
    out = _fwd_combine(o, J0, J1, ps, C)
    out = out.reshape(K, p0, p1, C, ps * ps).permute(0, 3, 1, 2, 4)
    return poly_unpack(out, ps)


def _adj_rolls_mc(G, J0, J1, ps=PS):
    """Adjoint prologue of a C-channel (K, C, n0, n1) operand: the rolls
    of its channel-packed form, channel order (t, c, w0, w1) as the
    C-channel ``Wa`` has it."""
    return _adj_rolls(_pack_ch(G, ps), J0, J1)


def _num(v):
    """A scalar of the x-step: a 0-d tensor as it is (the device loop's
    rho), else a Python float."""
    return v if isinstance(v, torch.Tensor) else float(v)


def _scaled(s, x):
    """``s * x`` for a number or a 0-d tensor ``s`` (the device loop's
    rho and us) and a real or complex ``x``.  A 0-d CUDA tensor in an
    elementwise op makes PyTorch broadcast it through its strided
    kernel, slower on large arrays than the vectorised one it takes for a
    Python number; ``_foreach_mul`` reads the scalar from device memory
    in a vectorised kernel that can be captured (as the capturable
    optimizers use it), with the same products (a complex ``x`` as its
    real pairs)."""
    if not isinstance(s, torch.Tensor):
        return s * x
    if x.is_complex():
        return torch.view_as_complex(
            torch._foreach_mul([torch.view_as_real(x)], s)[0])
    return torch._foreach_mul([x], s)[0]


def _herm_solve(A, beta, B):
    """Solve ``(A + beta I) g = B`` per frequency bin for a Hermitian
    C x C ``A``, C in (1, 2, 3), by closed-form cofactors (the JAX
    package's operation count; no batched LU).  ``A`` is (C, C, n0, k1)
    complex, ``B`` (K, C, n0, k1) complex, ``beta`` a number or a 0-d
    tensor."""
    C = A.shape[0]
    if C == 1:
        return B / (A[0, 0] + beta)
    if C == 2:
        a, b = A[0, 0] + beta, A[0, 1]
        c, d = A[1, 0], A[1, 1] + beta
        det = a * d - b * c
        g0 = (d * B[:, 0] - b * B[:, 1]) / det
        g1 = (a * B[:, 1] - c * B[:, 0]) / det
        return torch.stack([g0, g1], dim=1)
    if C == 3:
        a, b, c = A[0, 0] + beta, A[0, 1], A[0, 2]
        d, e, f = A[1, 0], A[1, 1] + beta, A[1, 2]
        g, h, i = A[2, 0], A[2, 1], A[2, 2] + beta
        co00 = e * i - f * h
        co01 = c * h - b * i
        co02 = b * f - c * e
        co10 = f * g - d * i
        co11 = a * i - c * g
        co12 = c * d - a * f
        co20 = d * h - e * g
        co21 = b * g - a * h
        co22 = a * e - b * d
        det = a * co00 + b * co10 + c * co20
        B0, B1, B2 = B[:, 0], B[:, 1], B[:, 2]
        g0 = (co00 * B0 + co01 * B1 + co02 * B2) / det
        g1 = (co10 * B0 + co11 * B1 + co12 * B2) / det
        g2 = (co20 * B0 + co21 * B1 + co22 * B2) / det
        return torch.stack([g0, g1, g2], dim=1)
    raise ValueError(f"unsupported channel count {C}")


def _gram(Df):
    """The per-bin Hermitian Gram ``D D^H`` (C, C, n0, k1) of a C-channel
    dictionary spectrum (C, M, n0, k1), fp32 contractions pinned."""
    with fp32_precision():
        return torch.einsum("cmxy,dmxy->cdxy", Df, Df.conj())


def spatial_xstep(Pyu, Wf, Wa, js, DHD, sfr, sfi, beta, scale, Nv):
    """The spatial-Woodbury CSC x-step in the packed polyphase layout.

    Solves ``(beta I + D^H D) x = beta yu + D^H s`` as::

        x = scale * yu + D^H irfft((Sf - scale * rfft(D yu)) / (DHD + beta))

    ``beta`` and ``scale`` are numbers or 0-d tensors.  Returns ``(PX,
    rfr, rfi, gr, gi)``.
    """
    jf0, jf1, ja0, ja1 = js
    axes = (-2, -1)
    beta, scale = _num(beta), _num(scale)
    R = poly_unpack(_conv_fwd_mm(Pyu, Wf, jf0, jf1, PS))
    rf = sf.rfftn(R, axes=axes)
    rfr, rfi = scale * rf.real, scale * rf.imag
    den = 1.0 / (DHD[None] + beta)
    gr = (sfr - rfr) * den
    gi = (sfi - rfi) * den
    G = sf.irfftn(torch.complex(gr, gi), s=Nv, axes=axes)
    PX = _scaled(scale, Pyu) + _conv_adj_mm(poly_pack(G), Wa, ja0, ja1)
    return PX, rfr, rfi, gr, gi


def spatial_xstep_mc(Pyu, Wf, Wa, js, DDHf, Sf, beta, scale, Nv, C):
    """The rank-C spatial-Woodbury x-step of a C-channel dictionary with
    shared coefficient maps: ``x = scale * yu + D^H G`` with
    ``(beta I_C + D D^H) Gf = Sf - scale * rfft(D yu)`` per bin.
    ``DDHf`` is the per-bin Gram (C, C, n0, k1) and ``Sf`` the signal
    spectrum (K, C, n0, k1).  Returns ``(PX, rf, Gf)``."""
    jf0, jf1, ja0, ja1 = js
    axes = (-2, -1)
    R = _fwd_combine_mc(Pyu @ Wf, jf0, jf1, C, PS)     # (K, C, n0, n1)
    rf = sf.rfftn(R, axes=axes)
    Gf = _herm_solve(DDHf, _num(beta), Sf - _num(scale) * rf)
    G = sf.irfftn(Gf, s=Nv, axes=axes)
    PX = _scaled(_num(scale), Pyu) + _adj_rolls_mc(G, ja0, ja1) @ Wa
    return PX, rf, Gf


def _rfl2norm2_sq(sq, n1):
    """Parseval correction given per-bin squared magnitudes ``sq`` of an
    rfft half-spectrum: double all bins except the first (and, for even
    n1, the last) column, divide by n0*n1."""
    k1 = sq.shape[-1]
    total = 2.0 * torch.sum(sq)
    edge = torch.sum(sq[..., 0])
    if n1 % 2 == 0:
        edge = edge + torch.sum(sq[..., k1 - 1])
    return (total - edge) / (sq.shape[-2] * n1)


def _rfl2norm2_planar(er, ei, n1):
    """Parseval-corrected squared l2 norm of an rfft half-spectrum given
    planar real/imaginary parts."""
    return _rfl2norm2_sq(er * er + ei * ei, n1)


# ---------------------------------------------------------------------------
# Eligibility

def _layout_ok(cri, nd0, nd1, dtype, force=False, allow_mc=False):
    """Structural layout constraints (the JAX package's rule): 2-D,
    single-channel (or, with ``allow_mc``, a C-channel dictionary with
    shared coefficient maps, C <= 3), PS-aligned even spatial dims,
    float32; the small-support heuristic (``MAX_SUPPORT``) is a
    performance choice only and is bypassed with ``force``."""
    single = cri.Cd == 1 and cri.C == 1
    mc = (allow_mc and cri.Cd == cri.C and cri.Cd in (2, 3)
          and cri.Cx == 1)
    if not (cri.dimN == 2 and (single or mc)):
        return False
    if dtype != torch.float32:
        return False
    n0, n1 = cri.Nv
    if n0 % PS != 0 or n1 % PS != 0 or n1 % 2 != 0:
        return False
    return force or (nd0 <= MAX_SUPPORT and nd1 <= MAX_SUPPORT)


def consensus_eligible(cri, dsz, dtype, masked):
    """Whether the consensus dictionary learning loop may run its CSC
    stage on the spatial x-step (``consensus_eligible`` of the JAX
    package): unmasked, and a layout :func:`_layout_ok` takes, colour
    dictionaries (Cd = C <= 3, shared coefficient maps) included."""
    return not masked and _layout_ok(cri, dsz[0], dsz[1], dtype,
                                     allow_mc=True)


def _wl1_per_channel(wl1):
    return wl1.ndim == 0 or all(d == 1 for i, d in enumerate(wl1.shape)
                                if i != 2)


def eligible(cfg, params, opts, force=False):
    """Whether the JAX package sends this ConvBPDN configuration to its
    fused driver (``sporco_tpu.ops.fused_csc.eligible``): real
    single-channel (or colour-dictionary ``l1``/``elastic`` without AMS)
    2-D float32 ``l1``, ``elastic`` or ``gradreg`` problems with
    PS-aligned even sizes, no NoBndryCross, LinSolveCheck or
    ``AuxVarObj``, at most one AMS impulse filter, and a scalar or
    per-filter ``GradWeight``.  With ``force`` the support heuristic is
    lifted and a configuration outside the rule raises
    :class:`ValueError`."""
    cri = cfg.cri
    mc_ok = (cri.Cd > 1 and cfg.variant in ("l1", "elastic")
             and not cfg.ams_nimp)
    structural = (cfg.real and cfg.variant in ("l1", "elastic", "gradreg")
                  and not cfg.no_bndry and not cfg.lin_check
                  and cfg.obj_from_x and cfg.ams_nimp in (0, 1)
                  and (cri.Cd == 1 or mc_ok)
                  and _layout_ok(cri, cri.dsz[0], cri.dsz[1], opts.dtype,
                                 force=force, allow_mc=mc_ok))
    if structural and cfg.variant == "gradreg":
        # the per-bin solve takes a scalar or per-filter GradWeight only
        structural = _wl1_per_channel(params["wgrd"])
    if not structural and force:
        raise ValueError(
            "fused=True requested, but this ConvBPDN configuration is not "
            "supported by the fused spatial driver (needs real "
            "single-channel 2D l1/elastic/gradreg CSC, "
            f"PS={PS}-aligned even spatial dims, float32)")
    return structural


def _cfold(cfg, params):
    """Fold a multi-channel signal's channels into the batch axis (the
    JAX package's channel folding, exact for a single-channel
    dictionary)."""
    cri = cfg.cri
    K2 = cri.K * cri.C
    cri2 = dataclasses.replace(cri, K=K2, C=1, Cx=1)
    S2 = params["S"].reshape((K2, 1, 1) + tuple(cri.Nv))
    return dataclasses.replace(cfg, cri=cri2), {**params, "S": S2}


def _cfold_wl1_ok(cri, wl1):
    if cri.C <= 1 or cri.Cd != 1 or cri.Cx != cri.C:
        return False
    return wl1.ndim == 0 or (wl1.ndim == 5 and _wl1_per_channel(wl1))


def cfold_eligible(cfg, params, opts, force=False):
    """Whether the JAX package runs this multi-channel-signal
    configuration on its fused driver by channel folding
    (``sporco_tpu.ops.fused_csc.cfold_eligible``): never under AMS,
    whose mask addresses per-channel impulse maps."""
    if cfg.ams_nimp or not _cfold_wl1_ok(cfg.cri, params["wl1"]):
        return False
    cfg2, params2 = _cfold(cfg, params)
    return eligible(cfg2, params2, opts, force=force)


def _solve_folded(solve, cri, cfg2, params2, opts, state, names):
    """Run ``solve`` on the channel-folded problem ``(cfg2, params2)``:
    the state arrays ``names`` go from (K, C, M, ...) to (K*C, 1, M, ...)
    and back."""
    K2 = cri.K * cri.C

    def fold(a):
        return a.reshape((K2, 1) + tuple(a.shape[2:]))

    def unfold(a):
        return a.reshape((cri.K, cri.C) + tuple(a.shape[2:]))
    out = solve(cfg2, params2, opts, state._replace(
        **{n: fold(getattr(state, n)) for n in names}))
    return out._replace(**{n: unfold(getattr(out, n)) for n in names})


def cbpdn_solve_cfold(cfg, params, opts, state):
    """Fused solve of a configuration that :func:`cfold_eligible` takes:
    fold the channels into the batch axis, run :func:`cbpdn_solve`,
    unfold the state."""
    return _solve_folded(cbpdn_solve, cfg.cri, *_cfold(cfg, params), opts,
                         state, ("X", "Y", "U"))


# ---------------------------------------------------------------------------
# The fused driver

def cbpdn_solve(cfg, params, opts, state):
    """Run (or resume) one fused solve call from ``state``; returns the
    final :class:`ADMMState` in the internal layout."""
    eligible(cfg, params, opts, force=True)
    with fp32_precision(), torch.no_grad():
        return _cbpdn_fused_run(cfg, params, opts, state)


def _gradreg_xstep(Pyu, rho, mu, Df, Sf, GHGfW, K, M, Nv, copy=True):
    """The gradreg x-step: the per-bin solve of ``(rho I + mu GHGfW +
    D^H D) x = rho yu + D^H s`` over the M-channel half-spectrum (the
    rank-1 Woodbury identity with a bin-dependent diagonal, as
    ``solvedbd_sm``); ``rho`` and ``mu`` are numbers or 0-d tensors.
    Returns
    ``(PX, Xfg)``; with ``copy`` False ``PX`` may be a strided view, which
    the device loop writes into its state in the pass that guards it."""
    axes = (-2, -1)
    rho = _num(rho)
    yu = unpack_state(Pyu, M).reshape(K, M, *Nv)
    yuf = sf.rfftn(yu, axes=axes)                        # (K, M, n0, k1)
    Lam = rho + _scaled(_num(mu), GHGfW)
    e = 1.0 / Lam
    Dc = Df.conj()
    bg = _scaled(rho, yuf) + Dc[None] * Sf[:, None]
    tg = e * bg
    alpha = torch.sum(Df[None] * tg, dim=1)              # (K, n0, k1)
    betaS = torch.sum((Df * Dc).real * e, dim=-3)
    Xfg = tg - (alpha / (1.0 + betaS))[:, None] * (e * Dc[None])
    Xg = sf.irfftn(Xfg, s=Nv, axes=axes)
    return pack_state(Xg.reshape(K, 1, M, *Nv), copy=copy), Xfg


def _loop_key(kind, cfg, opts, consts, t):
    """What a captured iteration bakes in beside the values of its static
    tensors ``t``: the configuration and options, the Python constants of
    the iteration (``consts``; its tensors are in ``t``), the shapes and
    types of ``t``, the matmul precision and the FFT dispatch of the
    glue."""
    return (kind, repr(cfg), repr(opts),
            tuple((name, v) for name, v in consts.items()
                  if not isinstance(v, torch.Tensor)),
            tuple((name, tuple(v.shape), v.dtype, str(v.device))
                  for name, v in t.items()),
            _MATMUL_PRECISION, sf.get_precision(), sf._PLANAR_MODE)


def _cbpdn_fused_run(cfg, params, opts, state):
    cri = cfg.cri
    n0, n1 = cri.Nv
    K, M = cri.K, cri.M
    nd0, nd1 = cri.dsz[0], cri.dsz[1]
    axes = (-2, -1)
    gradreg = cfg.variant == "gradreg"
    elastic = cfg.variant in ("elastic", "gradreg")
    wl1p = _packed_l1_weight(params["wl1"], cri)
    spatial_w = isinstance(wl1p, torch.Tensor) and wl1p.ndim > 1
    dev = params["S"].device
    k0 = int(state.k)

    # this call's tensors, which the iteration reads from the loop's
    # static ones (the first call's are those)
    t = {}
    Cd = cri.Cd
    if Cd > 1:
        # colour dictionary (l1/elastic): the rank-Cd Woodbury x-step
        D = params["D"].reshape(Cd, M, nd0, nd1)
        t["Df"] = sf.rfftn(D, s=cri.Nv, axes=axes)      # (Cd, M, n0, k1)
        t["DDHf"] = _gram(t["Df"])
        t["Sf"] = sf.rfftn(params["S"].reshape(K, Cd, n0, n1), axes=axes)
    else:
        D = params["D"].reshape(M, nd0, nd1)
        t["Df"] = sf.rfftn(D, s=cri.Nv, axes=axes)
        t["DHD"] = torch.sum((t["Df"] * t["Df"].conj()).real, dim=0)
        t["Sf"] = sf.rfftn(params["S"].reshape(K, n0, n1), axes=axes)
        t["sfr"] = t["Sf"].real.contiguous()
        t["sfi"] = t["Sf"].imag.contiguous()
    js = None
    if gradreg:
        _, GHGf = gradient_filters(2, cri.Nv, dtype=t["Sf"].real.dtype,
                                   device=dev)
        wg = params["wgrd"]
        t["GHGfW"] = wg * GHGf if wg.ndim == 0 \
            else wg.reshape(-1, 1, 1) * GHGf
    else:
        t["Wf"], t["Wa"], js = xstep_kernels(D, nd0, nd1, PS)
    if isinstance(wl1p, torch.Tensor):
        t["wl1p"] = wl1p
    else:
        wl1p = float(wl1p)
    if cfg.ams_nimp:
        # AMS: the last filter is the impulse; its map takes (1 - W)(AX+U)
        t["Wams"] = ams_mask(params["Wams"], K, cri.Nv)
    # The JAX package's routing, except that the port runs csc_iter
    # whatever iter_supported says and runs the tail kernel at any layout
    # (ROADMAP "Kernel routing (deliberate)").
    use_pk = (cfg.variant in ("l1", "elastic") and not spatial_w
              and not cfg.ams_nimp)
    nobj = 5 if elastic else 4

    # The loop's state: the scalars [rho, us, r, s, epri, edua, k, k0]
    # (the true dual is us * PU; k and k0 float32, exact below 2**24),
    # lmbda and mu, the stats rows and the launch counters of the
    # kernels (csc_iter or admm_tail; the FFT pair).  The kernels update
    # PY/PU in place; body carries X, body_pk rebuilds it after the loop
    # from the forward pair R1/R2 of (PY - PU) and PU.
    t["sc"] = torch.tensor([state.rho, 1.0, state.r, state.s, state.epri,
                            state.edua, k0, k0], dtype=torch.float32,
                           device=dev)
    t["rho_xi"] = torch.full((), float(f32(state.rho_xi)), device=dev)
    t["lmbda"] = torch.full((), float(f32(params["lmbda"])), device=dev)
    if elastic:
        t["mu"] = torch.full((), float(f32(params["mu"])), device=dev)
    t["stats"] = _stats_tensor(state.stats, opts.max_iter, 1 + nobj + 5, dev)
    t["cnt"] = torch.zeros(1, dtype=torch.int32, device=dev)
    t["fcnt"] = torch.zeros(2, dtype=torch.int32, device=dev)
    t["enable"] = torch.ones((), dtype=torch.bool, device=dev)
    t["sums"] = torch.zeros(6, dtype=torch.float32, device=dev)
    if use_pk:
        t["wf_split"] = split_weight(t["Wf"])   # the kernel's, once a call
    consts = dict(wl1p=wl1p, use_pk=use_pk, js=js, nobj=nobj)
    key = _loop_key("admm", cfg, opts, consts, t)
    # the packed state, written straight into a kept loop's buffers
    loop = device_loop.kept("admm", key)
    into = {} if loop is None else loop.t
    t["PY"] = pack_state(state.Y, out=into.get("PY"))
    t["PU"] = pack_state(state.U, out=into.get("PU"))
    pos, C = K * (n0 // PS) * (n1 // PS), PS * PS * M
    if use_pk:
        t["R1"] = torch.matmul((t["PY"] - t["PU"]).reshape(pos, C),
                               t["Wf"], out=into.get("R1"))
        t["R2"] = torch.matmul(t["PU"].reshape(pos, C), t["Wf"],
                               out=into.get("R2"))
    else:
        t["PX"] = pack_state(state.X, out=into.get("PX"))
    if loop is None:
        loop = device_loop.keep("admm", key,
                                _admm_loop(cfg, opts, consts, t))
    loop.refill(t)
    host = device_loop.run(
        loop, opts.max_iter,
        bool(f32(state.r) <= f32(state.epri)
             and f32(state.s) <= f32(state.edua)),
        dev, verbose=opts.verbose)
    T = loop.t
    PX = loop.finish()
    if dev.type == "cuda":
        # the kernels' live launches, counted on the device
        CSC_ITER_LAUNCHES["csc_iter"] += int(host[8]) if use_pk else 0
        csc_tail.LAUNCHES["admm_tail"] += 0 if use_pk else int(host[8])
        fft2_planar.LAUNCHES["rfft2_planar"] += int(host[9])
        fft2_planar.LAUNCHES["irfft2_planar"] += int(host[10])
    rho_h, us_h, r_h, s_h, epri_h, edua_h = (f32(v) for v in host[:6])
    shp = state.Y.shape
    us = T["sc"][1]
    # new tensors: the loop's are refilled by its next call
    return ADMMState(
        X=unpack_state(PX, M).reshape(shp).clone(),
        Y=unpack_state(T["PY"], M).reshape(shp).clone(),
        U=(us * unpack_state(T["PU"], M)).reshape(shp),
        rho=rho_h, rho_xi=f32(state.rho_xi), k=np.int32(host[6]), r=r_h,
        s=s_h, epri=epri_h, edua=edua_h,
        stats=host[11:].reshape(opts.max_iter, 1 + nobj + 5).copy())


def _admm_loop(cfg, opts, consts, T):
    """The fused ADMM driver's iteration (``body_pk`` on ``csc_iter`` or
    ``body`` with ``admm_tail`` or the torch-op tail) over the static
    tensors ``T`` (see :func:`_cbpdn_fused_run`), as a
    :class:`~sporco_tpu_torch.ops.device_loop.Loop`."""
    cri = cfg.cri
    n0, n1 = cri.Nv
    K, M, Cd = cri.K, cri.M, cri.Cd
    axes = (-2, -1)
    ar = opts.auto_rho
    rlx = f32(opts.relax_param)
    nobj, use_pk = consts["nobj"], consts["use_pk"]
    gradreg = cfg.variant == "gradreg"
    wl1p = T.get("wl1p", consts["wl1p"])
    spatial_w = isinstance(wl1p, torch.Tensor) and wl1p.ndim > 1
    use_tail = not use_pk and not spatial_w
    ams = (T["Wams"], cfg.ams_nimp) if cfg.ams_nimp else None
    mixed = _MATMUL_PRECISION == "mixed"
    nc = math.sqrt(K * M * n0 * n1)    # sqrt of the size of X and of Y
    pos, C = K * (n0 // PS) * (n1 // PS), PS * PS * M
    js = consts["js"]
    if js is not None:
        jf0, jf1, ja0, ja1 = js
        Wf, Wa = T["Wf"], T["Wa"]
        Ta = Wa.shape[0]        # (ja0 + 1)(ja1 + 1) Cd PS^2
    Df, Sf = T["Df"], T["Sf"]
    DHD, sfr, sfi = T.get("DHD"), T.get("sfr"), T.get("sfi")
    DDHf, GHGfW = T.get("DDHf"), T.get("GHGfW")
    PY, PU, PX = T["PY"], T["PU"], T.get("PX")
    R1, R2, wf_split = T.get("R1"), T.get("R2"), T.get("wf_split")
    sc, stats, cnt, sums = T["sc"], T["stats"], T["cnt"], T["sums"]
    fcnt, enable, rho_xi = T["fcnt"], T["enable"], T["rho_xi"]
    lmbda, mu = T["lmbda"], T.get("mu")
    rho, us, r, s, epri, edua, k, k0 = sc
    nanv = torch.full((), float("nan"), device=sc.device)

    def beta_scale(rho):
        """The x-step's ``beta`` and ``scale``: the elastic net's
        ``(rho + mu) I + D^H D`` system is the l1 one with yu scaled by
        ``rho / beta``."""
        if mu is None:
            return rho, 1.0
        beta = rho + mu
        return beta, rho / beta

    def xstep(Pyu, beta, scale):
        """The spatial x-step (rank-1 or rank-Cd Woodbury): PX and the
        spectral intermediates that :func:`data_fidelity` reads."""
        if Cd > 1:
            PX, rf, Gf = spatial_xstep_mc(Pyu, Wf, Wa, js, DDHf, Sf, beta,
                                          scale, cri.Nv, Cd)
            return PX, (rf, Gf)
        PX, rfr, rfi, gr, gi = spatial_xstep(Pyu, Wf, Wa, js, DHD, sfr,
                                             sfi, beta, scale, cri.Nv)
        return PX, (rfr, rfi, gr, gi)

    def data_fidelity(spec, scale):
        """0.5 ||D x - s||^2 from the x-step's spectral intermediates:
        ``DXf - Sf = scale rf + DHD g - Sf`` (rank-Cd: ``scale rf +
        DDHf Gf - Sf``), no extra transform."""
        if Cd > 1:
            rf, Gf = spec
            er = (scale * rf
                  + torch.sum(DDHf[None] * Gf[:, None], dim=2) - Sf)
            return 0.5 * _rfl2norm2_sq((er * er.conj()).real, n1)
        rfr, rfi, gr, gi = spec
        er = rfr + DHD[None] * gr - sfr
        ei = rfi + DHD[None] * gi - sfi
        return 0.5 * _rfl2norm2_planar(er, ei, n1)

    def converged():
        return ((r <= epri) & (s <= edua)) | (k - k0 >= opts.max_iter)

    def step():
        """One iteration, guarded by ``live`` (the JAX ``lax.cond``); the
        FFT kernels read it through their gate."""
        device_loop.stage("stopping test")
        live = enable & ~converged()
        with fft2_planar.gate(live.to(torch.float32), fcnt):
            return body(live)

    def body(live):
        thr = (lmbda / rho) * wl1p
        extra = []
        if use_pk:
            device_loop.stage("x-step glue")
            # forward product, rescale-corrected by linearity:
            # (Y - us U) @ Wf = R1 + (1 - us) R2
            beta, scale = beta_scale(rho)
            o2 = R1 + _scaled(1.0 - us, R2)
            o4 = o2.reshape(K, n0 // PS, n1 // PS, -1)
            if Cd > 1:
                rf = sf.rfftn(_fwd_combine_mc(o4, jf0, jf1, Cd, PS),
                              axes=axes)
                Gf = _herm_solve(DDHf, beta, Sf - scale * rf)
                G2 = _adj_rolls_mc(sf.irfftn(Gf, s=cri.Nv, axes=axes),
                                   ja0, ja1)
                spec = (rf, Gf)
            else:
                R = poly_unpack(_fwd_combine(o4, jf0, jf1, PS))
                rf = sf.rfftn(R, axes=axes)
                rfr, rfi = rf.real, rf.imag
                if mu is not None:
                    rfr, rfi = scale * rfr, scale * rfi
                den = 1.0 / (DHD[None] + beta)
                gr = (sfr - rfr) * den
                gi = (sfi - rfi) * den
                G = sf.irfftn(torch.complex(gr, gi), s=cri.Nv, axes=axes)
                G2 = _adj_rolls(poly_pack(G), ja0, ja1)
                spec = (rfr, rfi, gr, gi)
            device_loop.stage("csc_iter")
            csc_iter(G2.reshape(pos, Ta), PY.view(pos, C), PU.view(pos, C),
                     Wa, Wf, thr, wl1p, rlx, us, scale, nonneg=cfg.non_neg,
                     emit_px=False, wf_split=wf_split, mixed=mixed,
                     live=live, counter=cnt, out=(R1, R2, sums))
        else:
            # the XLA body: the x-step, then the tail on the packed state
            device_loop.stage("x-step")
            PUt = _scaled(us, PU)
            Pyu = PY - PUt
            if gradreg:
                PXn, Xfg = _gradreg_xstep(Pyu, rho, mu, Df, Sf, GHGfW, K,
                                          M, cri.Nv, copy=False)
            else:
                beta, scale = beta_scale(rho)
                PXn, spec = xstep(Pyu, beta, scale)
            # X is carried: the x-step's result where live (for gradreg
            # the packing's own pass)
            torch.where(live, PXn, PX, out=PX)
            device_loop.stage("tail")
            if use_tail:
                csc_tail.admm_tail(PX, PY, PU, thr, wl1p, rlx,
                                   nonneg=cfg.non_neg, us=us, ams=ams,
                                   live=live, counter=cnt, out=sums)
            else:
                yn, un, s6 = tail_ops(PX, PY, PUt, thr, wl1p, rlx,
                                      nonneg=cfg.non_neg, ams=ams)
                torch.where(live, yn, PY, out=PY)
                torch.where(live, un, PU, out=PU)
                sums.copy_(s6)
            if gradreg and not opts.fast_solve:
                DXf = torch.sum(Df[None] * Xfg, dim=1)
                er = DXf.real - sfr
                ei = DXf.imag - sfi
                sqg = (Xfg * Xfg.conj()).real * GHGfW
                extra = [0.5 * _rfl2norm2_planar(er, ei, n1),
                         0.5 * _rfl2norm2_sq(sqg, n1)]
        device_loop.stage("residuals, stats row and AutoRho")
        if not (opts.fast_solve or gradreg):
            extra = [data_fidelity(spec, scale)]
        q = sqrt_t(torch.stack([sums[0], sums[1],
                                torch.maximum(sums[2], sums[3]), sums[4]]))
        r_, s_, epri_, edua_ = norm_residuals_t(ar, opts, nc, nc, q[0],
                                                rho * q[1], q[2],
                                                rho * q[3])
        if opts.fast_solve:
            objv = (nanv,) * nobj
        else:
            rl1, dfd = sums[5], extra[0]
            if mu is None:
                objv = (dfd + lmbda * rl1, dfd, rl1, nanv)
            else:
                # RegGrad from the spectrum, RegL2 from the tail's ||PX||^2
                reg = extra[1] if gradreg else 0.5 * sums[2]
                objv = (dfd + lmbda * rl1 + mu * reg, dfd, rl1, reg, nanv)
        row = torch.stack((k,) + objv + (r_, s_, epri_, edua_, rho))
        write_row(stats, k, k0, live, row)
        rho_new, us_new = update_rho_t(ar, k, r_, s_, rho, rho_xi)
        torch.where(live, torch.stack(
            [rho_new, us_new, r_, s_, epri_, edua_, k + 1.0, k0]), sc,
            out=sc)
        return live

    def status():
        return torch.stack([converged().to(torch.float32), k - k0])

    def show(row):
        print(f"it {int(row[0])}  obj {row[1]:.4e}  r {row[1 + nobj]:.3e}  "
              f"s {row[2 + nobj]:.3e}  rho {row[-1]:.3e}")

    def finish():
        """PX of the final state: the loop's (body), or the x-step at
        the final (Y, U, rho), which the next iteration (or a resumed
        solve) computes (body_pk: the kernel loop never stores X)."""
        if not use_pk:
            return PX
        return xstep(PY - _scaled(us, PU), *beta_scale(rho))[0]

    return device_loop.Loop(
        T, step, status,
        lambda: torch.cat([sc, cnt.to(torch.float32),
                           fcnt.to(torch.float32), stats.reshape(-1)]),
        lambda i, n: stats[i:i + n], show, finish)


# ---------------------------------------------------------------------------
# Fused PGM (FISTA) CSC problem: the same polyphase machinery applied to
# the proximal-gradient solver (``sporco/pgm/cbpdn.py:29,387``).  In the
# packed layout the gradient D^H(D y - s) is two dense products and the
# data term an elementwise norm, so a FISTA iteration (masked or not,
# backtracking included) needs no FFT.

def _pgm_aux(cfg, params, number=True):
    """The packed problem's constants: the weights of a Cd-channel
    dictionary (Cd = 1 or a colour dictionary), the signal and the
    squared mask in the channel-packed layout (K, p0, p1, Cd*PS^2) in
    which the residual lives; a scalar l1 weight as a number for the
    kernel's loop, as a 0-d tensor (``number`` False) for the generic
    loop, which reads nothing on the host."""
    cri = cfg.cri
    n0, n1 = cri.Nv
    M, K, Cd = cri.M, cri.K, cri.Cd
    nd0, nd1 = cri.dsz[0], cri.dsz[1]
    Wf, Wa, js = xstep_kernels(params["D"].reshape(Cd, M, nd0, nd1), nd0,
                               nd1, PS)
    aux = {"Wf": Wf, "Wa": Wa, "j": js, "Cd": Cd,
           "Sp": _pack_ch(params["S"].reshape(K, Cd, n0, n1)),
           "wl1p": _packed_l1_weight(params["wl1"], cri, number),
           "lmbda": f32(params["lmbda"])}
    if cfg.masked:
        W = params["W"]
        Wm = W.reshape(W.shape[0], W.shape[1], *W.shape[-2:]) \
            .expand(K, Cd, n0, n1)
        aux["Wp2"] = _pack_ch(Wm) ** 2
    return aux


def ams_mask(Wams, K, Nv):
    """The AMS fidelity mask of a single-channel problem, ``(K|1, 1, 1,
    N0, N1)`` in the internal layout, packed once per solve as the
    tail's ``(K * N0/PS * N1/PS, PS^2)``: the mask of each packed row and
    polyphase phase, the same for every filter (the JAX package's ``Wp``
    at ``sporco_tpu/ops/fused_csc.py:645-653`` repeats it over M)."""
    W = Wams.reshape(Wams.shape[0], *Nv).expand(K, *Nv)
    return poly_pack(W.to(torch.float32)).reshape(-1, PS * PS).contiguous()


def _packed_l1_weight(wl1, cri, number=True):
    """l1 weights in the packed layout: a float32 scalar (a 0-d float32
    tensor where ``number`` is False), the per-filter vector tiled over
    the ps*ps phases (C,), or a spatially varying weight packed like the
    state (K, N0/ps, N1/ps, C)."""
    if wl1.ndim == 0 or wl1.numel() == 1:
        if not number:
            return wl1.reshape(()).to(torch.float32)
        return f32(wl1.reshape(()).item())
    if _wl1_per_channel(wl1):
        return wl1.reshape(-1).to(torch.float32).repeat(PS * PS) \
            .contiguous()
    return pack_state(wl1.expand((cri.K, 1, cri.M) + tuple(cri.Nv)))


def _pgm_resid(cfg, aux, Yp):
    jf0, jf1, _, _ = aux["j"]
    return _fwd_combine(Yp @ aux["Wf"], jf0, jf1, PS, aux["Cd"]) - aux["Sp"]


def _pgm_grad(cfg, aux, params, Yp):
    _, _, ja0, ja1 = aux["j"]
    Rp = _pgm_resid(cfg, aux, Yp)
    if cfg.masked:
        Rp = aux["Wp2"] * Rp
    return _conv_adj_mm(Rp, aux["Wa"], ja0, ja1)


def _thr(aux, L):
    """The soft threshold (lmbda / L) * wl1p in float32 (``L`` a number
    or, in the generic loop, a 0-d tensor)."""
    if isinstance(L, torch.Tensor):
        return const_div(aux["lmbda"], L) * aux["wl1p"]
    lr = aux["lmbda"] / f32(L)
    wl1p = aux["wl1p"]
    return lr * wl1p if isinstance(wl1p, np.floating) else float(lr) * wl1p


def _pgm_prox(cfg, aux, params, Vp, L):
    U = torch.sign(Vp) * torch.clamp(Vp.abs() - _thr(aux, L), min=0.0)
    if cfg.non_neg:
        U = torch.clamp(U, min=0.0)
    return U


def _pgm_f(cfg, aux, params, Xp):
    Rp = _pgm_resid(cfg, aux, Xp)
    if cfg.masked:
        return 0.5 * torch.sum(aux["Wp2"] * Rp ** 2)
    return 0.5 * torch.sum(Rp ** 2)


def _pgm_reg(aux, Xp):
    return torch.sum(torch.abs(aux["wl1p"] * Xp))


def _pgm_g(cfg, aux, params, Xp):
    return aux["lmbda"] * _pgm_reg(aux, Xp)


def _pgm_obfn(cfg, aux, params, Xp):
    f = _pgm_f(cfg, aux, params, Xp)
    reg = _pgm_reg(aux, Xp)
    return (f + aux["lmbda"] * reg, f, reg)


def _pgm_hess(cfg, aux, params, Vp):
    jf0, jf1, ja0, ja1 = aux["j"]
    Rp = _fwd_combine(Vp @ aux["Wf"], jf0, jf1, PS, aux["Cd"])
    return _conv_adj_mm(Rp, aux["Wa"], ja0, ja1)


def _pgm_xinit(cfg, params):
    cri = cfg.cri
    return torch.zeros((cri.K, cri.Nv[0] // PS, cri.Nv[1] // PS,
                        PS * PS * cri.M), dtype=params["S"].dtype,
                       device=params["S"].device)


_CBPDN_PGM_FUSED = PGMProblem(
    setup=functools.partial(_pgm_aux, number=False), grad_f=_pgm_grad,
    prox_g=_pgm_prox, obfn_f=_pgm_f,
    obfn_g=_pgm_g, hessian_f=_pgm_hess, xinit=_pgm_xinit, obfn=_pgm_obfn,
    stat_names=("ObjFun", "DFid", "RegL1"))


def pgm_eligible(cfg, opts):
    """Whether the JAX package sends this (possibly masked) FISTA
    configuration to its fused packed-layout problem
    (``sporco_tpu.ops.fused_csc.pgm_eligible``): single-channel or
    colour-dictionary 2-D float32 problems with PS-aligned even sizes,
    supports up to 24 and no NoBndryCross."""
    cri = cfg.cri
    single = cri.Cd == 1 and cri.C == 1
    mc = cri.Cd == cri.C and cri.Cd in (2, 3) and cri.Cx == 1
    if not (cri.dimN == 2 and (single or mc) and not cfg.no_bndry):
        return False
    if opts.dtype != torch.float32:
        return False
    n0, n1 = cri.Nv
    if n0 % PS != 0 or n1 % PS != 0 or n1 % 2 != 0:
        return False
    return cri.dsz[0] <= MAX_SUPPORT and cri.dsz[1] <= MAX_SUPPORT


def pgm_cfold_eligible(cfg, params, opts):
    """Whether the JAX package runs this multi-channel-signal FISTA
    configuration on its fused problem by channel folding
    (``sporco_tpu.ops.fused_csc.pgm_cfold_eligible``)."""
    if not _cfold_wl1_ok(cfg.cri, params["wl1"]):
        return False
    return pgm_eligible(_cfold(cfg, params)[0], opts)


def _pgm_cfold(cfg, params):
    """Fold the channel axis into the batch axis for the FISTA problem
    (exact, as :func:`_cfold`); a mask with a batch or channel axis is
    broadcast to (K, C) and folded alongside the signal, a spatial one
    broadcasts as it is."""
    cfg2, params2 = _cfold(cfg, params)
    cri, Nv = cfg.cri, tuple(cfg.cri.Nv)
    W = params["W"]
    if W.shape[0] > 1 or W.shape[1] > 1:
        W = W.expand((cri.K, cri.C, 1) + Nv).reshape(
            (cri.K * cri.C, 1, 1) + Nv)
    return cfg2, {**params2, "W": W}


def pgm_cbpdn_solve_cfold(cfg, params, opts, state):
    """Fused FISTA solve of a configuration that
    :func:`pgm_cfold_eligible` takes: fold the channels into the batch
    axis, run :func:`pgm_cbpdn_solve`, unfold the state."""
    return _solve_folded(pgm_cbpdn_solve, cfg.cri,
                         *_pgm_cfold(cfg, params), opts, state,
                         ("X", "Y", "Xprv", "Gprv", "Zrb"))


def _pgm_kernel_eligible(cfg, params, opts):
    """Whether the FISTA loop around the ``pgm_iter`` kernel covers this
    configuration: the plain momentum step (no backtracking, step-size
    policy or monotone variant) and a scalar or per-filter L1Weight.
    The decision rests on the configuration alone; on CPU tensors the
    same route runs the kernel's plain version."""
    if (opts.backtrack != "none" or opts.stepsize != "none"
            or opts.monotone):
        return False
    return _wl1_per_channel(params["wl1"])


def _pgm_fused_kernel_run(cfg, params, opts, state):
    """FISTA loop around :func:`sporco_tpu_torch.ops.pgm_iter.pgm_iter`,
    on the device (:mod:`sporco_tpu_torch.ops.device_loop`): per
    iteration the small roll-combine of R1, the residual, the mask and
    the adjoint rolls in PyTorch, then one kernel call (gradient product,
    prox, momentum, the next forward product and RX), then the objective
    from RX, the stopping test and the stats row on the device."""
    M = cfg.cri.M
    aux = _pgm_aux(cfg, params)
    dev = aux["Sp"].device
    k0 = int(state.k)
    L = f32(state.L)            # fixed: no backtracking on this route
    ncol = state.stats.shape[1]
    # this call's tensors, which the iteration reads from the loop's
    # static ones (the first call's are those): the weights and signal,
    # the state [t, rsdl, k, k0] (k and k0 float32, exact below 2**24),
    # the stats rows, the kernel's launch counter and fresh, distinct
    # packed buffers (pgm_iter writes X over the previous iterate and Yn
    # over Y in place)
    t = {name: aux[name] for name in ("Wf", "Wa", "Sp", "Wp2")
         if name in aux}
    # the kernel's scalars fixed over the solve: thr = (lmbda / L) wl1
    # (0-d, or per filter) and rL = 1 / L in float32, with lmbda and L
    thr = _thr(aux, L)
    wl1p = aux["wl1p"]
    if isinstance(thr, torch.Tensor):
        t["thr"], t["wl1p"] = thr, wl1p
        wl1p = None
    else:
        t["thr"] = torch.full((), float(thr), device=dev)
        wl1p = float(wl1p)
    t["pc"] = torch.tensor([aux["lmbda"], L, f32(1.0) / L],
                           dtype=torch.float32, device=dev)
    t["sc"] = torch.tensor([state.t, state.rsdl, k0, k0],
                           dtype=torch.float32, device=dev)
    t["stats"] = _stats_tensor(state.stats, opts.max_iter, ncol, dev)
    t["cnt"] = torch.zeros(1, dtype=torch.int32, device=dev)
    t["enable"] = torch.ones((), dtype=torch.bool, device=dev)
    t["sums"] = torch.zeros(2, dtype=torch.float32, device=dev)
    t["wf_split"] = split_weight(t["Wf"])   # the kernel's, once a call
    consts = dict(wl1p=wl1p, j=aux["j"], Cd=aux["Cd"], ncol=ncol)
    key = _loop_key("pgm", cfg, opts, consts, t)
    # the packed state, written straight into a kept loop's buffers
    loop = device_loop.kept("pgm", key)
    into = {} if loop is None else loop.t
    t["PX"] = pack_state(state.X, out=into.get("PX"))
    t["PY"] = pack_state(state.Y, out=into.get("PY"))
    pos, C = t["PY"].shape[0] * t["PY"].shape[1] * t["PY"].shape[2], \
        t["PY"].shape[3]
    t["R1"] = torch.matmul(t["PY"].reshape(pos, C), t["Wf"],
                           out=into.get("R1"))
    # the kernel's output, which each live iteration writes before the
    # objective reads it
    t["RX"] = into["RX"] if "RX" in into else torch.empty_like(t["R1"])
    if loop is None:
        loop = device_loop.keep("pgm", key, _pgm_loop(cfg, opts, consts, t))
    loop.refill(t)
    host = device_loop.run(
        loop, opts.max_iter,
        not bool(f32(state.rsdl) >= stop_tol(opts, k0)), dev,
        verbose=opts.verbose)
    if dev.type == "cuda":
        # the kernel's live launches, counted on the device
        PGM_ITER_LAUNCHES["pgm_iter"] += int(host[4])
    T = loop.t
    shp = state.X.shape
    # new tensors: the loop's are refilled by its next call
    X = unpack_state(T["PX"], M).reshape(shp).clone()
    return state._replace(
        X=X, Y=unpack_state(T["PY"], M).reshape(shp).clone(),
        Xprv=X.clone(), t=f32(host[0]), L=L, k=np.int32(host[2]),
        rsdl=f32(host[1]), stats=host[5:].reshape(opts.max_iter,
                                                  ncol).copy())


def _pgm_loop(cfg, opts, consts, T):
    """The fused FISTA driver's iteration on ``pgm_iter`` over the static
    tensors ``T`` (see :func:`_pgm_fused_kernel_run`), as a
    :class:`~sporco_tpu_torch.ops.device_loop.Loop`."""
    cri = cfg.cri
    n0, n1 = cri.Nv
    K, M = cri.K, cri.M
    p0, p1 = n0 // PS, n1 // PS
    pos = K * p0 * p1
    C = PS * PS * M
    jf0, jf1, ja0, ja1 = consts["j"]
    Cd = consts["Cd"]
    Wf, Wa, Sp, Wp2 = T["Wf"], T["Wa"], T["Sp"], T.get("Wp2")
    thr = T["thr"]
    wl1p = T.get("wl1p", consts["wl1p"])
    Ta = Wa.shape[0]            # (ja0 + 1)(ja1 + 1) Cd PS^2
    PX, PY, R1, RX = T["PX"], T["PY"], T["R1"], T["RX"]
    sc, stats, cnt, sums = T["sc"], T["stats"], T["cnt"], T["sums"]
    enable, wf_split = T["enable"], T["wf_split"]
    mixed = _MATMUL_PRECISION == "mixed"
    t, rsdl, k, k0 = sc
    lmbda, L, rL = T["pc"]
    nanv = torch.full((), float("nan"), device=sc.device)
    zero = torch.zeros((), device=sc.device)

    def live_now():
        return (enable & (k - k0 < opts.max_iter)
                & (rsdl >= stop_tol_t(opts, k)))

    def step():
        """One iteration, guarded by ``live`` (the JAX ``cond``)."""
        device_loop.stage("stopping test")
        live = live_now()
        device_loop.stage("gradient glue")
        Rp = _fwd_combine(R1.reshape(K, p0, p1, -1), jf0, jf1, PS, Cd) - Sp
        if Wp2 is not None:
            Rp = Wp2 * Rp
        G2 = _adj_rolls(Rp, ja0, ja1)
        tn = momentum_update_t(opts, t, k)
        beta = (t - 1.0) / tn
        device_loop.stage("pgm_iter")
        pgm_iter(G2.reshape(pos, Ta), PY.view(pos, C), PX.view(pos, C), Wa,
                 Wf, thr, wl1p, rL, beta, nonneg=cfg.non_neg,
                 wf_split=wf_split, mixed=mixed, live=live, counter=cnt,
                 out=(R1, RX, sums))
        device_loop.stage("objective and stats row")
        rs = sqrt_t(sums[0])
        if opts.fast_solve:
            objv = (nanv,) * 3
        else:
            RpX = _fwd_combine(RX.reshape(K, p0, p1, -1), jf0, jf1, PS,
                               Cd) - Sp
            sq = RpX * RpX if Wp2 is None else Wp2 * RpX ** 2
            f = 0.5 * torch.sum(sq)
            objv = (f + lmbda * sums[1], f, sums[1])
        row = torch.stack((k,) + objv + (rs, nanv, nanv, zero, L))
        write_row(stats, k, k0, live, row)
        torch.where(live, torch.stack([tn, rs, k + 1.0, k0]), sc, out=sc)
        return live

    def status():
        return torch.stack([(~live_now()).to(torch.float32), k - k0])

    def show(row):
        print(f"it {int(row[0])}  obj {row[1]:.4e}  rsdl {row[4]:.3e}  "
              f"L {row[8]:.3e}")

    return device_loop.Loop(
        T, step, status,
        lambda: torch.cat([sc, cnt.to(torch.float32), stats.reshape(-1)]),
        lambda i, n: stats[i:i + n], show)


def pgm_cbpdn_solve(cfg, params, opts, state):
    """Run (or resume) one fused FISTA solve from ``state`` (internal
    layout): through the ``pgm_iter`` loop when the configuration allows
    it, else the generic PGM loop on the packed problem (backtracking,
    step-size policies, monotone, spatial L1Weight).  Returns the final
    :class:`PGMState` in the internal layout."""
    if not pgm_eligible(cfg, opts):
        raise ValueError("this configuration is not one of the fused "
                         "FISTA problem's (see pgm_eligible)")
    with fp32_precision(), torch.no_grad():
        if _pgm_kernel_eligible(cfg, params, opts):
            return _pgm_fused_kernel_run(cfg, params, opts, state)
        shp = state.X.shape
        M = cfg.cri.M
        packed = state._replace(
            X=pack_state(state.X), Y=pack_state(state.Y),
            Xprv=pack_state(state.Xprv), Gprv=pack_state(state.Gprv),
            Zrb=pack_state(state.Zrb))
        out = _pgm._pgm_run(_CBPDN_PGM_FUSED, cfg, params, opts, packed)

        def unp(P):
            return unpack_state(P, M).reshape(shp)
        return out._replace(X=unp(out.X), Y=unp(out.Y), Xprv=unp(out.Xprv),
                            Gprv=unp(out.Gprv), Zrb=unp(out.Zrb))
