"""Spatial (row) domain decomposition (counterpart of
``sporco_tpu.parallel.spatial``).

Every DFT-diagonalised solver is independent per frequency bin between
transforms (``sporco/linalg.py:232-273``), so an image larger than one
device decomposes by rows:

- real-space arrays are split by ROWS (axis -2) over the mesh
  ``"data"`` ranks;
- the 2-D real FFT is a local 1-D ``rfft`` along the rows' columns, one
  ``all_to_all_single`` over the ``"data"`` group (the complex blocks
  sent as real pairs), and a local 1-D ``fft`` along the now whole
  columns (the slab-decomposed FFT);
- the half-spectra are then split by FREQUENCY COLUMNS (axis -1,
  zero-padded to ``K1p``, a multiple of the number of ranks), where
  every per-bin solve is local;
- norms and inner products are ``all_reduce`` sums, one per iteration.

:func:`tvl2deconv_nsharded` and :func:`cbpdn_nsharded` keep the generic
ADMM driver's semantics (normalised residuals, AutoRho with the dual
rescale, early stopping), so their iterations follow the single-device
``TVL2Deconv`` and ``ConvBPDN(fused=False)`` to rounding.  They run on
the device loop (:mod:`sporco_tpu_torch.ops.device_loop`), as the JAX
package's ``lax.while_loop`` under ``shard_map`` does: rho, the
residuals, tolerances and stats rows are 0-d tensors of the solve's type
(``norm_residuals_t``, ``rsf_t``), the sums of an iteration one
``all_reduce`` with no read, and the host reads the stopping flag once a
block of 8 iterations and the final state once.  On NCCL an iteration,
its ``all_to_all_single`` and ``all_reduce`` included, is one CUDA
graph; ranks on gloo (the CPU) run the same blocks eagerly.  The
transforms are ``torch.fft``'s 1-D ones: no kernel of the port runs
here (the JAX package's functions use ``jnp.fft`` too).
"""

import math

import numpy as np
import torch
import torch.distributed as dist

from sporco_tpu_torch._device import fp32_precision
from sporco_tpu_torch.ops import device_loop
from sporco_tpu_torch.ops import fft as sf
from sporco_tpu_torch.ops import prox as sp
from sporco_tpu_torch.parallel.mesh import (all_reduce_sum, axis_rank,
                                            axis_size, mesh_device,
                                            shard_batch)
from sporco_tpu_torch.solvers.admm import (as_row, const_div, guarded_update,
                                           norm_residuals_t, rsf_t,
                                           scalar_type, sqrt_t, write_row)

__all__ = ["dist_rfft2", "dist_irfft2", "tvl2deconv_nsharded",
           "cbpdn_nsharded"]


def _a2a(x, group):
    """``all_to_all_single`` of the blocks along axis 0 of ``x`` over
    ``group``: block j goes to rank j, and block i of the result came
    from rank i.  A complex tensor travels as its real pairs."""
    x = x.contiguous()
    v = torch.view_as_real(x) if x.is_complex() else x
    out = torch.empty_like(v)
    dist.all_to_all_single(out, v, group=group)
    return torch.view_as_complex(out) if x.is_complex() else out


def dist_rfft2(x, n_shards, group=None):
    """Distributed 2-D real FFT over the LAST TWO axes: ``x`` is this
    rank's row block ``(..., N0/P, N1)``; returns its frequency-column
    block ``(..., N0, K1p/P)``, ``K1p = ceil((N1//2+1)/P)*P`` with the pad
    columns zero.  ``group`` is the ``"data"`` group of ``n_shards``
    ranks (``None``: the world)."""
    P = n_shards
    xf = torch.fft.rfft(x, dim=-1)
    lead, n0, K1 = xf.shape[:-2], xf.shape[-2], xf.shape[-1]
    K1p = -(-K1 // P) * P
    if K1p > K1:
        xf = torch.cat([xf, xf.new_zeros(xf.shape[:-1] + (K1p - K1,))],
                       dim=-1)
    c = K1p // P
    blocks = xf.reshape(lead + (n0, P, c)).movedim(-2, 0)
    v = _a2a(blocks, group).movedim(0, -3).reshape(lead + (P * n0, c))
    return torch.fft.fft(v, dim=-2)


def dist_irfft2(xf, n1, n_shards, group=None):
    """Inverse of :func:`dist_rfft2`: frequency-column block
    ``(..., N0, K1p/P)`` -> real row block ``(..., N0/P, n1)``."""
    P = n_shards
    K1 = n1 // 2 + 1
    v = torch.fft.ifft(xf, dim=-2)
    lead, N0, c = v.shape[:-2], v.shape[-2], v.shape[-1]
    n0 = N0 // P
    blocks = v.reshape(lead + (P, n0, c)).movedim(-3, 0)
    w = _a2a(blocks, group).movedim(0, -2).reshape(lead + (n0, P * c))
    return torch.fft.irfft(w[..., :K1], n=n1, dim=-1)


def _setup(S, mesh, dtype):
    """The row block of ``S`` and the geometry of a row-sharded solve."""
    dtype = torch.float32 if dtype is None else sf.torch_dtype(dtype)
    S = np.asarray(S)
    N0, N1 = S.shape[-2:]
    P = axis_size(mesh, "data")
    if N0 % P != 0:
        raise ValueError(f"N0 ({N0}) must divide the mesh data axis ({P})")
    K1 = N1 // 2 + 1
    K1p = -(-K1 // P) * P
    idx = axis_rank(mesh, "data")
    dev = mesh_device(mesh)
    cols = idx * (K1p // P) + torch.arange(K1p // P, device=dev)
    S_loc = shard_batch(mesh, S.astype(sf.numpy_dtype(dtype)), 0)
    return (dtype, N0, N1, P, K1, K1p, cols, dev, S_loc,
            mesh.get_group("data"))


def _col_block(af, K1, K1p, cols):
    """This rank's frequency-column block of a full half-spectrum, with
    the pad columns zero."""
    pad = af.new_zeros(af.shape[:-1] + (K1p - K1,))
    return torch.cat([af, pad], dim=-1)[..., cols]


def _sums(vals, group):
    """The 0-d tensors ``vals`` summed over ``group``: the one collective
    of an iteration."""
    return all_reduce_sum(torch.stack(vals), group)


def _loop(dtype, dev, arrays, rho0, max_iter, iteration, nstat=0):
    """A device loop over the state ``arrays`` (X, Y, U) and the scalars
    ``sc = [rho, k, r, s, epri, edua]`` (k from 0), with ``nstat``
    columns of stats rows: ``iteration()`` gives the new arrays, the new
    scalars and the row."""
    rdt = sf.real_dtype(dtype)
    inf = float("inf")
    T = {"sc": torch.tensor([rho0, 0.0, inf, inf, 0.0, 0.0], dtype=rdt,
                            device=dev),
         "stats": torch.full((max_iter, nstat), float("nan"),
                             dtype=torch.float32, device=dev),
         "enable": torch.ones((), dtype=torch.bool, device=dev),
         "live": torch.zeros((), dtype=torch.bool, device=dev)}
    sc, stats, live = T["sc"], T["stats"], T["live"]
    rho, k, r, s, epri, edua = sc
    zero = torch.zeros((), dtype=rdt, device=dev)

    def converged():
        return ((r <= epri) & (s <= edua)) | (k >= max_iter)

    def step():
        device_loop.stage("stopping test")
        torch.logical_and(T["enable"], ~converged(), out=live)
        device_loop.stage("iteration")
        news, scal, row = iteration()
        device_loop.stage("scalar tail")
        if nstat:
            write_row(stats, k, zero, live, row)
        torch.where(live, torch.stack(scal), sc, out=sc)
        guarded_update(live, arrays, news)
        return live

    def status():
        return torch.stack([converged().to(rdt), k])
    return device_loop.Loop(
        T, step, status, lambda: torch.cat([sc, stats.reshape(-1).to(rdt)]),
        lambda i, n: stats[i:i + n], lambda row: None)


def tvl2deconv_nsharded(A, S, lmbda, mesh, opt=None, Wtv=1.0, dtype=None):
    """l2-TV deconvolution with the image rows sharded over the mesh
    ``"data"`` ranks (see the module docstring).  Returns ``(X, k, r,
    s)``: this rank's row block of the deconvolved image, the iterations
    run and the final normalised residuals.  The same semantics as
    ``TVL2Deconv(A, S, lmbda, opt)`` with a scalar ``Wtv`` on a 2-D
    single-channel image; ``dtype=None`` means float32.
    """
    from sporco_tpu_torch.models.tv import TVL2Deconv
    if opt is None:
        opt = TVL2Deconv.options()
    if np.ndim(S) != 2:
        raise ValueError("prototype supports 2-D single-channel S")
    dtype, N0, N1, P, K1, K1p, cols, dev, S_loc, group = _setup(
        S, mesh, dtype)
    ft = scalar_type(dtype)
    ar = opt.auto_rho
    lmbda = float(lmbda)
    # the reference default (tvl2.py:484)
    rho = ft(opt.rho if opt.rho is not None else 2.0 * lmbda + 0.1)
    rlx = opt.relax_param
    Wtv = float(Wtv)
    nc = math.sqrt(N0 * N1 * 2)     # size of Y
    nx = math.sqrt(N0 * N1)
    with fp32_precision(), torch.no_grad():
        At = torch.as_tensor(np.asarray(A), dtype=dtype, device=dev)
        Af = _col_block(torch.fft.rfft2(At, s=(N0, N1)), K1, K1p, cols)
        g = torch.zeros((2, 2, 2), dtype=dtype, device=dev)
        g[0, :, 0] = torch.tensor([1.0, -1.0])
        g[1, 0, :] = torch.tensor([1.0, -1.0])
        Gf = _col_block(torch.fft.rfft2(g, s=(N0, N1)), K1, K1p, cols)
        mask = (cols < K1)[None, :]
        AHAf = (Af.conj() * Af).real
        GHGf = torch.sum((Gf.conj() * Gf).real, dim=0)
        AHSf = Af.conj() * dist_rfft2(S_loc, P, group)

        def irf(vf):
            return dist_irfft2(vf, N1, P, group)

        def cnst_at_f(Vf):
            return torch.sum(Gf.conj() * Vf, dim=0)

        X = torch.zeros_like(S_loc)
        Y = torch.zeros((2,) + S_loc.shape, dtype=dtype, device=dev)
        U = torch.zeros_like(Y)
        xi = torch.ones((), dtype=sf.real_dtype(dtype), device=dev)

        def iteration():
            rho, k = sc[0], sc[1]
            # x-step (tvl2.py:594-610): per bin in the column block
            b = AHSf + rho * cnst_at_f(dist_rfft2(Y - U, P, group))
            den = AHAf + rho * GHGf
            Xf = torch.where(mask, b / torch.where(mask, den, 1.0), 0.0)
            Xl = irf(Xf[None])[0]
            AXnr = irf(Gf * Xf[None])
            AX = rlx * AXnr + (1 - rlx) * Y
            Yn = sp.prox_l2(AX + U, const_div(lmbda, rho) * Wtv, axis=(0,))
            Un = U + AX - Yn
            # residuals (the generic driver's), reduced in one collective
            sv = irf(cnst_at_f(dist_rfft2(Yn - Y, P, group))[None])[0]
            atu = irf(cnst_at_f(dist_rfft2(Un, P, group))[None])[0]
            h = sqrt_t(_sums([torch.sum(v * v) for v in
                              (AXnr - Yn, sv, AXnr, Yn, atu)], group))
            r, s, epri, edua = norm_residuals_t(
                ar, opt, nc, nx, h[0], rho * h[1], torch.maximum(h[2], h[3]),
                rho * h[4])
            # adaptive rho with the dual rescale (admm.py:549-575)
            rsf = rsf_t(ar, k, r, s, xi)
            return [Xl, Yn, Un / rsf], [rho * rsf, k + 1.0, r, s, epri,
                                        edua], None

        loop = _loop(dtype, dev, [X, Y, U], rho, opt.max_iter, iteration)
        sc = loop.t["sc"]
        host = device_loop.run(loop, opt.max_iter, False, dev)
    return X, int(host[1]), float(ft(host[2])), float(ft(host[3]))


def cbpdn_nsharded(D, S, lmbda, mesh, opt=None, wl1=1.0, dtype=None):
    """ConvBPDN (single-channel 2-D l1 CSC) with the IMAGE ROWS sharded
    over the mesh ``"data"`` ranks.

    The state ``(M, N0/P, N1)`` is this rank's row block; each iteration
    is an M-channel distributed FFT pair, a per-bin rank-1
    Sherman-Morrison solve in the local frequency columns
    (``sporco/admm/cbpdn.py:267-293``), the prox tail, and one
    all-reduce of the residual and objective sums.  Semantics are those
    of ``ConvBPDN(D, S, lmbda, opt, fused=False)``: default rho and
    rho_xi, AutoRho with the dual rescale, normalised residuals, early
    stopping, a stats row per iteration.

    Returns ``(X_user, stats, k)``: this rank's row block of the
    coefficient maps in the user layout ``(N0/P, N1, M)``, the stats
    rows (columns ``Iter/ObjFun/DFid/RegL1/PrimalRsdl/DualRsdl/EPrimal/
    EDual/Rho`` and one always-zero padding column, as the JAX package
    writes them) and the iterations run.  ``dtype=None`` means float32.
    """
    from sporco_tpu_torch.models.cbpdn import ConvBPDN
    from sporco_tpu_torch.models.common import default_rho_xi
    if opt is None:
        opt = ConvBPDN.options()
    if np.ndim(S) != 2 or np.ndim(D) != 3:
        raise ValueError("prototype supports 2-D single-channel S and a "
                         "(Nd0, Nd1, M) dictionary")
    dtype, N0, N1, P, K1, K1p, cols, dev, S_loc, group = _setup(
        S, mesh, dtype)
    ft = scalar_type(dtype)
    M = np.shape(D)[-1]
    ar = opt.auto_rho
    lmbda = float(lmbda)
    rho = ft(opt.rho if opt.rho is not None else 50.0 * lmbda + 1.0)
    rho_xi = ft(ar.rsdl_target if ar.rsdl_target is not None
                else default_rho_xi(lmbda))
    rlx = opt.relax_param
    wl1 = float(wl1)
    nc = math.sqrt(M * N0 * N1)
    nx = nc
    stats = np.full((opt.max_iter, 10), np.nan, np.float32)
    with fp32_precision(), torch.no_grad():
        Dm = torch.as_tensor(np.moveaxis(np.asarray(D), -1, 0).copy(),
                             dtype=dtype, device=dev)   # (M, Nd0, Nd1)
        Df = _col_block(torch.fft.rfft2(Dm, s=(N0, N1)), K1, K1p, cols)
        mask = (cols < K1)[None, :]
        # Parseval weights of the half-spectrum (rfl2norm2): every bin
        # twice but the first column and, N1 even, the last
        pw = torch.where(mask, 2.0, 0.0).to(dtype)
        pw = torch.where((cols == 0)[None, :], 1.0, pw)
        if N1 % 2 == 0:
            pw = torch.where((cols == K1 - 1)[None, :], 1.0, pw)
        DHD = torch.sum((Df * Df.conj()).real, dim=0)
        Sf = dist_rfft2(S_loc, P, group)                   # (N0, K1p/P)
        DSf = Df.conj() * Sf[None]
        shp = (M,) + tuple(S_loc.shape)
        X = torch.zeros(shp, dtype=dtype, device=dev)
        Y, U = torch.zeros_like(X), torch.zeros_like(X)
        rdt = sf.real_dtype(dtype)
        xi = torch.full((), float(rho_xi), dtype=rdt, device=dev)
        NN = torch.full((), float(ft(N0 * N1)), dtype=rdt, device=dev)
        nan = torch.full((), float("nan"), dtype=rdt, device=dev)

        def iteration():
            rho, k = sc[0], sc[1]
            # x-step: per-bin rank-1 Sherman-Morrison in the column block
            b = DSf + rho * dist_rfft2(Y - U, P, group)
            ahb = torch.sum(Df * b, dim=0)
            Xf = (b - Df.conj() * (ahb / (rho + DHD))[None]) / rho
            Xl = dist_irfft2(Xf, N1, P, group)             # (M, N0/P, N1)
            AX = rlx * Xl + (1 - rlx) * Y
            AXU = AX + U
            thr = const_div(lmbda, rho) * wl1
            Yn = torch.sign(AXU) * torch.clamp(torch.abs(AXU) - thr, min=0.0)
            Un = U + AX - Yn
            sums = [torch.sum(v * v) for v in (Xl - Yn, Yn - Y, Xl, Yn, Un)]
            if not opt.fast_solve:
                Ef = torch.sum(Df * Xf, dim=0) - Sf
                sums += [torch.sum(pw * (Ef * Ef.conj()).real),
                         torch.sum(torch.abs(Xl))]
            h = _sums(sums, group)
            q = sqrt_t(h[:5])
            r, s, epri, edua = norm_residuals_t(
                ar, opt, nc, nx, q[0], rho * q[1],
                sqrt_t(torch.maximum(h[2], h[3])), rho * q[4])
            if opt.fast_solve:
                obj = dfd = rl1 = nan
            else:
                dfd = (h[5] * 0.5) / NN
                rl1 = h[6] * wl1
                obj = dfd + rl1 * lmbda
            row = as_row((k, obj, dfd, rl1, r, s, epri, edua, rho, 0.0),
                         rdt, dev)
            rsf = rsf_t(ar, k, r, s, xi)
            return [Xl, Yn, Un / rsf], [rho * rsf, k + 1.0, r, s, epri,
                                        edua], row

        loop = _loop(dtype, dev, [X, Y, U], rho, opt.max_iter, iteration,
                     nstat=10)
        sc = loop.t["sc"]
        host = device_loop.run(loop, opt.max_iter, False, dev)
    k = int(host[1])
    stats = host[6:].reshape(opt.max_iter, 10).astype(np.float32)
    return Y.movedim(0, -1), stats[:k], k
