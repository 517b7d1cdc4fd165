"""Fused spatial-Woodbury ConvBPDN ADMM driver and fused packed-layout
FISTA problem (counterpart of ``sporco_tpu.ops.fused_csc``,
single-channel part).

The x-step of single-channel 2-D ConvBPDN is solved in space by the
Woodbury identity::

    x = scale * yu + D^H irfft((Sf - scale * rfft(D yu)) / (DHD + beta))

with the whole ADMM state kept in a polyphase (space-to-depth) layout
folded by ``PS = 8`` per axis, which turns the convolutions with ``D``
into dense matmuls.  Every iteration runs the small spectral glue (the
rolls, one rfft2/irfft2 pair and the per-bin division) in PyTorch and
everything that touches the packed state arrays in one call of
:func:`sporco_tpu_torch.ops.csc_iter.csc_iter`, which also produces the
next iteration's forward product.  AutoRho's dual rescale is deferred
through the factor ``us`` and folded into that product by linearity:
``(Y - us U) @ Wf = R1 + (1 - us) R2``.

The loop runs on the host and reads back one small vector per
iteration (the kernel's six sums and the data-fidelity term) for the
stopping test and the stats row.  It reproduces the JAX driver's
iteration count, stats rows, returned ``U = us * U`` and the x-step
rebuilt after the loop at the final ``(Y, U, rho)``.

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
import math

import numpy as np
import torch

from sporco_tpu_torch._device import fp32_precision
from sporco_tpu_torch.ops import fft as sf
from sporco_tpu_torch.ops.csc_iter import csc_iter
from sporco_tpu_torch.ops.pgm_iter import pgm_iter
from sporco_tpu_torch.solvers import pgm as _pgm
from sporco_tpu_torch.solvers.admm import (ADMMState, _update_rho,
                                           norm_residuals)
from sporco_tpu_torch.solvers.pgm import (PGMProblem, _momentum_update,
                                          stop_tol)

__all__ = ["cbpdn_solve", "eligible", "cfold_eligible",
           "unsupported_reason", "pgm_cbpdn_solve", "pgm_eligible",
           "pgm_cfold_eligible", "pgm_unsupported_reason",
           "xstep_kernels", "spatial_xstep", "poly_pack", "poly_unpack",
           "pack_state", "unpack_state", "PS", "MAX_SUPPORT"]

PS = 8            # polyphase factor (spatial fold per axis)
MAX_SUPPORT = 24  # largest filter support the spatial form beats FFT at

f32 = np.float32


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


def pack_state(A, ps=PS):
    """Internal CSC layout (K, 1, M, N0, N1) -> polyphase
    (K, N0/ps, N1/ps, ps*ps*M) with channel order (w0, w1, m); always a
    new contiguous tensor."""
    K, _, M, n0, n1 = A.shape
    P = poly_pack(A.reshape(K, M, n0, n1), ps)     # (K, M, p0, p1, ps*ps)
    P = P.permute(0, 2, 3, 4, 1)                   # (K, p0, p1, ps*ps, M)
    return P.reshape(K, n0 // ps, n1 // ps, ps * ps * M).contiguous()


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
    """HWIO kernel of ``R = sum_m d_m (*) yu_m`` in polyphase: input
    channels (w0, w1, m), output channels (a0, a1).  The selectors are
    0/1 with one nonzero term per output, so the einsum (in float64 on
    the host) only moves entries of ``D``."""
    M = D.shape[0]
    S0, J0 = _sel_fwd(nd0, ps)
    S1, J1 = _sel_fwd(nd1, ps)
    ker = np.einsum("muv,akwu,blzv->klwzmab", D, S0, S1)
    return ker.reshape(J0 + 1, J1 + 1, ps * ps * M, ps * ps), J0, J1


def _adj_kernel(D, nd0, nd1, ps):
    """HWIO kernel of ``(D^H G)_m = corr(G, d_m)`` in polyphase: input
    channels (w0, w1), output channels (a0, a1, m)."""
    M = D.shape[0]
    S0, J0 = _sel_adj(nd0, ps)
    S1, J1 = _sel_adj(nd1, ps)
    ker = np.einsum("muv,akwu,blzv->klwzabm", D, S0, S1)
    return ker.reshape(J0 + 1, J1 + 1, ps * ps, ps * ps * M), J0, J1


def xstep_kernels(Dsm, nd0, nd1, ps=PS):
    """Packed single-matmul weights for the spatial-Woodbury x-step.

    ``Dsm`` is the spatial dictionary block ``(M, nd0, nd1)``.  Returns
    ``(Wf, Wa, (jf0, jf1, ja0, ja1))``: the forward/adjoint polyphase
    matmul weights (float32 tensors on ``Dsm``'s device) and their
    circular-roll tap radii.
    """
    D = Dsm.detach().cpu().double().numpy()
    M = D.shape[0]
    kf, jf0, jf1 = _fwd_kernel(D, nd0, nd1, ps)
    ka, ja0, ja1 = _adj_kernel(D, nd0, nd1, ps)
    C = ps * ps * M
    Wf = np.transpose(kf, (2, 0, 1, 3)).reshape(
        C, (jf0 + 1) * (jf1 + 1) * ps * ps)
    Wa = ka.reshape((ja0 + 1) * (ja1 + 1) * ps * ps, C)

    def dev(w):
        return torch.as_tensor(np.ascontiguousarray(w, np.float32),
                               device=Dsm.device)
    return dev(Wf), dev(Wa), (jf0, jf1, ja0, ja1)


def _fwd_combine(o, J0, J1, ps):
    """Epilogue of the forward polyphase conv: roll-and-sum the per-tap
    matmul outputs ``o`` of shape (K, p0, p1, T*ps*ps)."""
    K, p0, p1, _ = o.shape
    T = (J0 + 1) * (J1 + 1)
    o = o.reshape(K, p0, p1, T, ps * ps)
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


def spatial_xstep(Pyu, Wf, Wa, js, DHD, sfr, sfi, beta, scale, Nv):
    """The spatial-Woodbury CSC x-step in the packed polyphase layout.

    Solves ``(beta I + D^H D) x = beta yu + D^H s`` as::

        x = scale * yu + D^H irfft((Sf - scale * rfft(D yu)) / (DHD + beta))

    Returns ``(PX, rfr, rfi, gr, gi)``.
    """
    jf0, jf1, ja0, ja1 = js
    axes = (-2, -1)
    beta, scale = float(beta), float(scale)
    R = poly_unpack(_conv_fwd_mm(Pyu, Wf, jf0, jf1, PS))
    rf = sf.rfftn(R, axes=axes)
    rfr, rfi = scale * rf.real, scale * rf.imag
    den = 1.0 / (DHD[None] + beta)
    gr = (sfr - rfr) * den
    gi = (sfi - rfi) * den
    G = sf.irfftn(torch.complex(gr, gi), s=Nv, axes=axes)
    PX = scale * Pyu + _conv_adj_mm(poly_pack(G), Wa, ja0, ja1)
    return PX, rfr, rfi, gr, gi


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


def _wl1_per_channel(wl1):
    return wl1.ndim == 0 or all(d == 1 for i, d in enumerate(wl1.shape)
                                if i != 2)


def eligible(cfg, params, opts, force=False):
    """Whether the JAX package sends this ``l1`` ConvBPDN configuration to
    its fused driver (``sporco_tpu.ops.fused_csc.eligible``): real
    single-channel (or colour-dictionary) 2-D float32 problems with
    PS-aligned even sizes, no NoBndryCross, LinSolveCheck or
    ``AuxVarObj``.  With ``force`` the support heuristic is lifted and a
    configuration outside the rule raises :class:`ValueError`.  What the
    port's driver lacks of these is :func:`unsupported_reason`."""
    cri = cfg.cri
    mc_ok = cri.Cd > 1 and cfg.variant == "l1"
    structural = (cfg.real and cfg.variant == "l1" and not cfg.no_bndry
                  and not cfg.lin_check and cfg.obj_from_x
                  and (cri.Cd == 1 or mc_ok)
                  and _layout_ok(cri, cri.dsz[0], cri.dsz[1], opts.dtype,
                                 force=force, allow_mc=mc_ok))
    if not structural and force:
        raise ValueError(
            "fused=True requested, but this ConvBPDN configuration is not "
            "supported by the fused spatial driver (needs real "
            "single-channel 2D l1 CSC, "
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
    (``sporco_tpu.ops.fused_csc.cfold_eligible``)."""
    if not _cfold_wl1_ok(cfg.cri, params["wl1"]):
        return False
    cfg2, params2 = _cfold(cfg, params)
    return eligible(cfg2, params2, opts, force=force)


def unsupported_reason(cfg, params, opts):
    """None if the port's fused driver takes a configuration that
    :func:`eligible` (or :func:`cfold_eligible`) admits, else what it
    lacks and the ROADMAP item that ports it."""
    cri = cfg.cri
    if cri.Cd > 1 or cri.C > 1:
        return ("multi-channel (colour) CSC on the fused driver is not "
                "ported yet (ROADMAP queue 1, item 11)")
    if not _wl1_per_channel(params["wl1"]):
        return ("a spatially varying L1Weight needs the fused driver's "
                "XLA body, which is not ported yet (ROADMAP queue 1, "
                "item 8); pass fused=False for the generic path")
    return None


# ---------------------------------------------------------------------------
# The fused driver

def _packed_wl1(wl1):
    """l1 weights in the packed layout: a float32 scalar, or the
    per-filter vector tiled over the ps*ps phases."""
    if wl1.ndim == 0 or wl1.numel() == 1:
        return f32(wl1.reshape(()).item())
    return wl1.reshape(-1).to(torch.float32).repeat(PS * PS).contiguous()


def cbpdn_solve(cfg, params, opts, state):
    """Run (or resume) one fused solve call from ``state``; returns the
    final :class:`ADMMState` in the internal layout."""
    eligible(cfg, params, opts, force=True)
    reason = unsupported_reason(cfg, params, opts)
    if reason is not None:
        raise NotImplementedError(reason)
    with fp32_precision(), torch.no_grad():
        return _cbpdn_fused_run(cfg, params, opts, state)


def _cbpdn_fused_run(cfg, params, opts, state):
    cri = cfg.cri
    n0, n1 = cri.Nv
    K, M = cri.K, cri.M
    nd0, nd1 = cri.dsz[0], cri.dsz[1]
    axes = (-2, -1)
    ar = opts.auto_rho
    rlx = f32(opts.relax_param)
    lmbda = f32(params["lmbda"])
    wl1p = _packed_wl1(params["wl1"])

    D = params["D"].reshape(M, nd0, nd1)
    S = params["S"].reshape(K, n0, n1)
    Df = sf.rfftn(D, s=cri.Nv, axes=axes)
    DHD = torch.sum((Df * Df.conj()).real, dim=0)          # (n0, k1)
    Sf = sf.rfftn(S, axes=axes)                            # (K, n0, k1)
    sfr, sfi = Sf.real.contiguous(), Sf.imag.contiguous()
    Wf, Wa, js = xstep_kernels(D, nd0, nd1, PS)
    jf0, jf1, ja0, ja1 = js
    pos = K * (n0 // PS) * (n1 // PS)
    C = PS * PS * M
    Ta = (ja0 + 1) * (ja1 + 1) * PS * PS

    k0 = int(state.k)
    k = k0
    nc = math.sqrt(K * M * n0 * n1)    # sqrt of the size of X and of Y
    rho, rho_xi = f32(state.rho), f32(state.rho_xi)
    r, s = f32(state.r), f32(state.s)
    epri, edua = f32(state.epri), f32(state.edua)
    nobj = 4
    stats = np.array(state.stats, np.float32, copy=True)
    if stats.shape[0] != opts.max_iter:
        stats = np.full((opts.max_iter, 1 + nobj + 5), np.nan, np.float32)

    # fresh packed buffers: csc_iter updates PY/PU in place
    PY = pack_state(state.Y)
    PU = pack_state(state.U)        # true dual = us * PU
    us = f32(1.0)
    R1 = (PY - PU).reshape(pos, C) @ Wf
    R2 = PU.reshape(pos, C) @ Wf

    def converged():
        return (r <= epri and s <= edua) or k - k0 >= opts.max_iter

    while not converged():
        # the l1 x-step: beta = rho, scale = 1 (elastic net is not ported)
        # forward product, rescale-corrected by linearity
        o2 = R1 + float(f32(1.0) - us) * R2
        o4 = o2.reshape(K, n0 // PS, n1 // PS, -1)
        R = poly_unpack(_fwd_combine(o4, jf0, jf1, PS))
        rf = sf.rfftn(R, axes=axes)
        rfr, rfi = rf.real, rf.imag
        den = 1.0 / (DHD[None] + float(rho))
        gr = (sfr - rfr) * den
        gi = (sfi - rfi) * den
        G = sf.irfftn(torch.complex(gr, gi), s=cri.Nv, axes=axes)
        G2 = _adj_rolls(poly_pack(G), ja0, ja1)
        lr = f32(lmbda / rho)
        thr = lr * wl1p if isinstance(wl1p, np.floating) \
            else float(lr) * wl1p
        _, _, _, R1, R2, sums = csc_iter(
            G2.reshape(pos, Ta), PY.view(pos, C), PU.view(pos, C), Wa, Wf,
            thr, wl1p, rlx, us, 1.0, nonneg=cfg.non_neg, emit_px=False)
        if opts.fast_solve:
            host = sums.cpu().numpy()
        else:
            # DXf - Sf = rf + DHD*g - Sf (free spectral identity)
            er = rfr + DHD[None] * gr - sfr
            ei = rfi + DHD[None] * gi - sfi
            dfd = 0.5 * _rfl2norm2_planar(er, ei, n1)
            host = torch.cat([sums, dfd.reshape(1)]).cpu().numpy()
        # the one host read of the iteration
        rnrm = np.sqrt(host[0])
        snrm = rho * np.sqrt(host[1])
        rn = np.sqrt(np.maximum(host[2], host[3]))
        sn = rho * np.sqrt(host[4])
        r_, s_, epri_, edua_ = norm_residuals(ar, opts, nc, nc, rnrm, snrm,
                                              rn, sn)
        if opts.fast_solve:
            objv = (np.nan,) * nobj
        else:
            rl1, dfd_h = host[5], host[6]
            objv = (dfd_h + lmbda * rl1, dfd_h, rl1, np.nan)
        stats[k - k0] = (k,) + objv + (r_, s_, epri_, edua_, rho)
        if opts.verbose:
            print(f"it {k}  obj {stats[k - k0, 1]:.4e}  r {r_:.3e}  "
                  f"s {s_:.3e}  rho {rho:.3e}")
        rho_new, us = _update_rho(ar, k, r_, s_, rho, rho_xi, f32(1.0))
        rho, r, s, epri, edua = rho_new, r_, s_, epri_, edua_
        k += 1

    # The loop never stores X; it is the x-step at the final (Y, U, rho),
    # which is what the next iteration (or a resumed solve) computes.
    PXf = spatial_xstep(PY - float(us) * PU, Wf, Wa, js, DHD, sfr, sfi,
                        rho, f32(1.0), cri.Nv)[0]
    shp = state.Y.shape
    return ADMMState(
        X=unpack_state(PXf, M).reshape(shp),
        Y=unpack_state(PY, M).reshape(shp),
        U=(float(us) * unpack_state(PU, M)).reshape(shp),
        rho=rho, rho_xi=rho_xi, k=np.int32(k), r=r, s=s, epri=epri,
        edua=edua, stats=stats)


# ---------------------------------------------------------------------------
# Fused PGM (FISTA) CSC problem: the same polyphase machinery applied to
# the proximal-gradient solver (``sporco/pgm/cbpdn.py:29,387``).  In the
# packed layout the gradient D^H(D y - s) is two dense products and the
# data term an elementwise norm, so a FISTA iteration (masked or not,
# backtracking included) needs no FFT.

def _pgm_aux(cfg, params):
    cri = cfg.cri
    n0, n1 = cri.Nv
    M, K = cri.M, cri.K
    nd0, nd1 = cri.dsz[0], cri.dsz[1]
    Wf, Wa, js = xstep_kernels(params["D"].reshape(M, nd0, nd1), nd0, nd1,
                               PS)
    aux = {"Wf": Wf, "Wa": Wa, "j": js,
           "Sp": poly_pack(params["S"].reshape(K, n0, n1)),
           "wl1p": _packed_l1_weight(params["wl1"], cri),
           "lmbda": f32(params["lmbda"])}
    if cfg.masked:
        W = params["W"]
        Wm = W.reshape(W.shape[0], *W.shape[-2:]).expand(K, n0, n1)
        aux["Wp2"] = poly_pack(Wm) ** 2
    return aux


def _packed_l1_weight(wl1, cri):
    """l1 weights in the packed layout: a float32 scalar, the per-filter
    vector tiled over the ps*ps phases (C,), or a spatially varying
    weight packed like the state (K, N0/ps, N1/ps, C)."""
    if wl1.ndim == 0 or wl1.numel() == 1:
        return f32(wl1.reshape(()).item())
    if _wl1_per_channel(wl1):
        return wl1.reshape(-1).to(torch.float32).repeat(PS * PS) \
            .contiguous()
    return pack_state(wl1.expand((cri.K, 1, cri.M) + tuple(cri.Nv)))


def _pgm_resid(cfg, aux, Yp):
    jf0, jf1, _, _ = aux["j"]
    return _fwd_combine(Yp @ aux["Wf"], jf0, jf1, PS) - aux["Sp"]


def _pgm_grad(cfg, aux, params, Yp):
    _, _, ja0, ja1 = aux["j"]
    Rp = _pgm_resid(cfg, aux, Yp)
    if cfg.masked:
        Rp = aux["Wp2"] * Rp
    return _conv_adj_mm(Rp, aux["Wa"], ja0, ja1)


def _thr(aux, L):
    """The soft threshold (lmbda / L) * wl1p in float32."""
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
    return aux["lmbda"] * f32(_pgm_reg(aux, Xp).item())


def _pgm_obfn(cfg, aux, params, Xp):
    f = f32(_pgm_f(cfg, aux, params, Xp).item())
    reg = f32(_pgm_reg(aux, Xp).item())
    return (f + aux["lmbda"] * reg, f, reg)


def _pgm_hess(cfg, aux, params, Vp):
    jf0, jf1, ja0, ja1 = aux["j"]
    Rp = _fwd_combine(Vp @ aux["Wf"], jf0, jf1, PS)
    return _conv_adj_mm(Rp, aux["Wa"], ja0, ja1)


def _pgm_xinit(cfg, params):
    cri = cfg.cri
    return torch.zeros((cri.K, cri.Nv[0] // PS, cri.Nv[1] // PS,
                        PS * PS * cri.M), dtype=params["S"].dtype,
                       device=params["S"].device)


_CBPDN_PGM_FUSED = PGMProblem(
    setup=_pgm_aux, grad_f=_pgm_grad, prox_g=_pgm_prox, obfn_f=_pgm_f,
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
    cri = cfg.cri
    if not _cfold_wl1_ok(cri, params["wl1"]):
        return False
    cri2 = dataclasses.replace(cri, K=cri.K * cri.C, C=1, Cx=1)
    return pgm_eligible(dataclasses.replace(cfg, cri=cri2), opts)


def pgm_unsupported_reason(cfg, opts):
    """None if the port's fused FISTA problem takes a configuration that
    :func:`pgm_eligible` (or :func:`pgm_cfold_eligible`) admits, else
    what it lacks and the ROADMAP item that ports it."""
    cri = cfg.cri
    if cri.Cd > 1:
        return ("a colour dictionary needs the rank-C packed problem, "
                "which is not ported yet (ROADMAP queue 1, item 11)")
    if cri.C > 1:
        return ("a multi-channel signal needs channel folding (cfold), "
                "which is not ported yet (ROADMAP queue 1, item 10)")
    return None


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
    """FISTA loop around :func:`sporco_tpu_torch.ops.pgm_iter.pgm_iter`:
    per iteration the small roll-combine of R1, the residual, the mask
    and the adjoint rolls in PyTorch, then one kernel call (gradient
    product, prox, momentum, the next forward product and RX), then the
    objective from RX and one host read of three floats."""
    cri = cfg.cri
    n0, n1 = cri.Nv
    K, M = cri.K, cri.M
    p0, p1 = n0 // PS, n1 // PS
    pos = K * p0 * p1
    C = PS * PS * M
    aux = _pgm_aux(cfg, params)
    Wf, Wa, Sp, wl1p, lmbda = (aux[k] for k in ("Wf", "Wa", "Sp", "wl1p",
                                                "lmbda"))
    jf0, jf1, ja0, ja1 = aux["j"]
    Ta = (ja0 + 1) * (ja1 + 1) * PS * PS
    Wp2 = aux.get("Wp2")

    k0 = int(state.k)
    k = k0
    t, L, rsdl = f32(state.t), f32(state.L), f32(state.rsdl)
    stats = np.array(state.stats, np.float32, copy=True)
    if stats.shape[0] != opts.max_iter:
        stats = np.full((opts.max_iter, stats.shape[1]), np.nan, np.float32)
    # fresh, distinct packed buffers: pgm_iter writes X over the previous
    # iterate and Yn over Y in place
    PX = pack_state(state.X)
    PY = pack_state(state.Y)
    R1 = PY.reshape(pos, C) @ Wf
    nanv = f32(np.nan)

    while k - k0 < opts.max_iter and rsdl >= stop_tol(opts, k):
        Rp = _fwd_combine(R1.reshape(K, p0, p1, -1), jf0, jf1, PS) - Sp
        if Wp2 is not None:
            Rp = Wp2 * Rp
        G2 = _adj_rolls(Rp, ja0, ja1)
        tprv = t
        t = _momentum_update(opts, t, k)
        beta = (tprv - f32(1.0)) / t
        _, _, R1, RX, sums = pgm_iter(
            G2.reshape(pos, Ta), PY.view(pos, C), PX.view(pos, C), Wa, Wf,
            _thr(aux, L), wl1p, f32(1.0) / L, beta, nonneg=cfg.non_neg)
        if opts.fast_solve:
            host = sums.cpu().numpy()
            objv = (np.nan,) * 3
        else:
            RpX = _fwd_combine(RX.reshape(K, p0, p1, -1), jf0, jf1,
                               PS) - Sp
            sq = RpX * RpX if Wp2 is None else Wp2 * RpX ** 2
            f = 0.5 * torch.sum(sq)
            # the one host read of the iteration
            host = torch.cat([sums, f.reshape(1)]).cpu().numpy()
            objv = (host[2] + lmbda * host[1], host[2], host[1])
        rsdl = f32(np.sqrt(host[0]))
        stats[k - k0] = (k,) + objv + (rsdl, nanv, nanv, 0.0, L)
        if opts.verbose:
            print(f"it {k}  obj {stats[k - k0, 1]:.4e}  rsdl {rsdl:.3e}  "
                  f"L {L:.3e}")
        k += 1

    shp = state.X.shape
    X = unpack_state(PX, M).reshape(shp)
    return state._replace(
        X=X, Y=unpack_state(PY, M).reshape(shp), Xprv=X.clone(), t=t, L=L,
        k=np.int32(k), rsdl=rsdl, stats=stats)


def pgm_cbpdn_solve(cfg, params, opts, state):
    """Run (or resume) one fused FISTA solve from ``state`` (internal
    layout): through the ``pgm_iter`` loop when the configuration allows
    it, else the generic PGM loop on the packed problem (backtracking,
    step-size policies, monotone, spatial L1Weight).  Returns the final
    :class:`PGMState` in the internal layout."""
    if not pgm_eligible(cfg, opts):
        raise ValueError("this configuration is not one of the fused "
                         "FISTA problem's (see pgm_eligible)")
    reason = pgm_unsupported_reason(cfg, opts)
    if reason is not None:
        raise NotImplementedError(reason)
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
