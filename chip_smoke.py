#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one CUDA card and check it.

Run from the root of a checkout:  python3 chip_smoke.py [--profile]

The main paths are the headline problem of the repository, single-channel
2-D ConvBPDN on a 512x512 image with 64 filters of 8x8, lmbda = 0.05
(``bench.py``'s problem), solved two ways:

- by ADMM to relative residual 1e-3, through
  ``sporco_tpu_torch.models.cbpdn.ConvBPDN`` on the fused driver and its
  hand-written CUDA kernel ``csc_iter``;
- by FISTA at ``bench.py``'s PGM configuration (L = 100, 250 iterations,
  no stopping tolerance), through ``sporco_tpu_torch.models.pgm.ConvBPDN``
  on the fused packed problem and its hand-written CUDA kernel
  ``pgm_iter``.

Phases, each printing one JSON line on stdout:

1. ``device``: the card's name and power limit, torch and CUDA versions;
2. ``build``: the kernels' nvcc builds, one process per source, all
   started together (seconds, ptxas report);
3. ``kernel``: ``csc_iter`` against its plain PyTorch version on the card
   at the headline geometry over the flag grid, and both timed;
4. ``parity``: 10 ADMM iterations of the headline problem on the card
   against the port on the CPU (plain version), stats row by row;
5. ``solve``: the ADMM headline solve through ``ConvBPDN.solve()``; the
   ``csc_iter`` launch count must equal the iterations run;
6. ``pgm_kernel``: ``pgm_iter`` against its plain version on the card at
   the headline geometry over its flag grid, and both timed;
7. ``pgm_parity``: 10 FISTA iterations on the card against the CPU,
   unmasked and with about 30% of the pixels masked out;
8. ``pgm_solve``: the FISTA solve; the ``pgm_iter`` launch count must
   equal the iterations run.

Each solve sets every kernel's launch count to 0 just before it and
reads the counts just after.  Then the ``{"kernels": [...]}`` line, the
``nvidia-smi`` name and power limit line, and last ``{"ok": true,
"device": {...}}``.  Any failure exits non-zero without the ``ok`` line;
so does a run past the time budget, or a machine without a CUDA device.
``--profile`` adds phases that run each solve under ``torch.profiler``
and report the device's busy and idle share and its time by kernel.
"""

import json
import os
import signal
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

from sporco_tpu_torch._device import fp32_precision
from sporco_tpu_torch.models import pgm as tpgm
from sporco_tpu_torch.models.cbpdn import ConvBPDN
from sporco_tpu_torch.ops import _nvcc
from sporco_tpu_torch.ops import csc_iter as tci
from sporco_tpu_torch.ops import pgm_iter as tpi
from sporco_tpu_torch.ops.fused_csc import PS, xstep_kernels

BUDGET_S = 600          # hard limit for the whole script, build included

N, ND, M, LMBDA = 512, 8, 64, 0.05
MAX_ITER, REL_TOL = 500, 1e-3
PARITY_ITERS = 10
PGM_L, PGM_ITERS = 100.0, 250         # bench.py:_bench_pgm
MASK_MISSING = 0.3                    # share of pixels masked out
KERNELS = ("csc_iter", "pgm_iter")

# Kernel against plain version, both fp32 on the card: they differ only in
# summation order (k = 256 for G2 @ Wa, k = 4096 for R1/R2), about 1e-6
# relative; 1e-5 of each output's largest magnitude.
KERNEL_RTOL = 1e-5
# Card (kernel) against CPU (plain version) over 10 iterations: the
# tolerances of the CPU test of the port against the JAX package.
PARITY = {"X": 2e-4, "ObjFun": 1e-4, "DFid": 1e-4, "RegL1": 1e-4,
          "Rho": 1e-4, "PrimalRsdl": 1e-3, "DualRsdl": 1e-3}
PGM_PARITY = {"X": 2e-4, "ObjFun": 1e-4, "DFid": 1e-4, "RegL1": 1e-4,
              "Rsdl": 1e-4}

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES = 3.35e12
# float operations per state element in each kernel's epilogue, beside
# the 2*k of each product: csc_iter's update of Y and U and six sums;
# pgm_iter's step, prox, momentum and two sums
EPI_FLOPS = 29
PGM_EPI_FLOPS = 15

PHASE = {"name": "start"}


def emit(obj):
    print(json.dumps(obj), flush=True)


def _over_budget(signum, frame):
    print(f"chip_smoke: time budget of {BUDGET_S} s exceeded in phase "
          f"{PHASE['name']!r}", file=sys.stderr, flush=True)
    os._exit(3)


def headline_problem(seed=0):
    """The problem of ``bench.py``'s ``_headline_problem``."""
    from scipy.ndimage import gaussian_filter
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((ND, ND, M)).astype(np.float32)
    D /= np.sqrt((D ** 2).sum(axis=(0, 1), keepdims=True))
    S = gaussian_filter(rng.standard_normal((N, N)), 8.0) * 5.0
    S += 0.1 * rng.standard_normal((N, N))
    return D, S.astype(np.float32), LMBDA


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps=20, warmup=3):
    """Median time of ``fn()`` on the card in ms, from CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _bound_ms(flops, floats):
    """Least time on an H100 SXM for ``flops`` fp32 operations and
    ``floats`` float32 values moved (each input read once, each output
    written once): the larger of the operations over 67 TFLOP/s and the
    bytes over 3.35 TB/s, with which of the two bounds it."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = 4 * floats / PEAK_HBM_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def csc_iter_bound_ms(pos, C, T, emit_px, vectors):
    """Least time of one csc_iter call (see :func:`_bound_ms`)."""
    flops = 3 * 2 * pos * T * C + EPI_FLOPS * pos * C
    floats = (pos * T + 2 * pos * C + 2 * T * C            # G2 Y U Wa Wf
              + 2 * pos * C + 2 * pos * T + 6              # Yn Un R1 R2 sums
              + (pos * C if emit_px else 0) + (2 * C if vectors else 0))
    return _bound_ms(flops, floats)


def pgm_iter_bound_ms(pos, C, T, vectors):
    """Least time of one pgm_iter call (see :func:`_bound_ms`)."""
    flops = 3 * 2 * pos * T * C + PGM_EPI_FLOPS * pos * C
    floats = (pos * T + 2 * pos * C + 2 * T * C            # G2 Y Xprv Wa Wf
              + 2 * pos * C + 2 * pos * T + 2              # X Yn R1 RX sums
              + (2 * C if vectors else 0))
    return _bound_ms(flops, floats)


def reset_launches():
    tci.reset_launches()
    tpi.reset_launches()


def launches():
    return {**tci.LAUNCHES, **tpi.LAUNCHES}


def compare_outputs(kernel, names, got, ref, where):
    """Hold a kernel's outputs against its plain version's: each within
    KERNEL_RTOL of that output's largest magnitude.  Returns the relative
    error by output and the largest absolute error over the arrays (not
    the sums)."""
    torch.cuda.synchronize()
    errs, max_abs = {}, 0.0
    for name, k, p in zip(names, got, ref):
        if not bool(torch.isfinite(k).all()):
            raise AssertionError(f"{kernel} {name} not finite at {where}")
        ae = float((k - p).abs().max())
        errs[name] = ae / max(float(p.abs().max()), 1e-30)
        if name != "sums":
            max_abs = max(max_abs, ae)
        if errs[name] > KERNEL_RTOL:
            raise AssertionError(
                f"{kernel} {name} differs from the plain version by "
                f"{errs[name]:.3e} (tolerance {KERNEL_RTOL:.0e}) at "
                f"{where}")
    return errs, max_abs


def compare_runs(label, runs, stat_names, tolerance):
    """Hold a solve on the card against the same solve on the CPU: the
    stats columns ``stat_names`` row by row (relative), and each named
    array within its tolerance of its scale.  ``runs`` is
    ``[(itstat, {name: array}), ...]`` for the card, then the CPU."""
    (ig, ag), (ic, ac) = runs
    if len(ig) != PARITY_ITERS or len(ic) != PARITY_ITERS:
        raise AssertionError(f"{label}: runs did not take {PARITY_ITERS} "
                             "iterations")
    errs = {}
    for name in stat_names:
        a, b = getattr(ig, name), getattr(ic, name)
        errs[name] = float(np.max(np.abs(a - b) / np.abs(b)))
    for name in ag:
        a, b = ag[name], ac[name]
        errs[name] = float(np.abs(a - b).max() / max(np.abs(b).max(),
                                                      1e-6))
    for name, e in errs.items():
        tol = tolerance["X" if name in ag else name]
        if not e <= tol:
            raise AssertionError(f"{label}: {name} differs by {e:.3e} "
                                 f"(tolerance {tol:.0e})")
    return errs


def headline_weights(dev, D):
    """The polyphase weights of the headline dictionary on the card and
    the packed geometry (pos, C, T)."""
    Wf, Wa, _ = xstep_kernels(torch.as_tensor(D).permute(2, 0, 1)
                              .contiguous().to(dev), ND, ND, PS)
    return Wf, Wa, ((N // PS) ** 2, PS * PS * M, Wa.shape[0])


def phase_kernel(dev, D):
    Wf, Wa, (pos, C, T) = headline_weights(dev, D)
    g = torch.Generator(device=dev).manual_seed(1)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)
    G2 = 0.1 * randn(pos, T)
    Y0 = randn(pos, C) * (torch.rand((pos, C), generator=g, device=dev)
                          < 0.05)
    U0 = 0.01 * randn(pos, C)
    thr_v = 0.01 + 0.02 * torch.rand(C, generator=g, device=dev)
    wl1_v = 0.5 + torch.rand(C, generator=g, device=dev)
    rlx, us, scale = 1.8, 0.9, 1.0
    grid, max_abs = [], 0.0
    for emit_px in (False, True):
        for nonneg in (False, True):
            for vectors in (False, True):
                thr, wl1 = (thr_v, wl1_v) if vectors else (0.0143, 1.0)
                outs = []
                for fn in (tci.csc_iter, tci.csc_iter_plain):
                    Y, U = Y0.clone(), U0.clone()
                    o = fn(G2, Y, U, Wa, Wf, thr, wl1, rlx, us, scale,
                           nonneg=nonneg, emit_px=emit_px)
                    outs.append([t for t in o if t is not None])
                names = (["PX"] if emit_px else []) + ["Yn", "Un", "R1",
                                                       "R2", "sums"]
                errs, ae = compare_outputs(
                    "csc_iter", names, *outs,
                    f"emit_px={emit_px} nonneg={nonneg} vectors={vectors}")
                max_abs = max(max_abs, ae)
                grid.append({"emit_px": emit_px, "nonneg": nonneg,
                             "vectors": vectors, "rel_err": errs})
    # time the main path's configuration
    Y, U = Y0.clone(), U0.clone()

    def run(fn):
        return lambda: fn(G2, Y, U, Wa, Wf, 0.0143, 1.0, rlx, us, scale,
                          nonneg=False, emit_px=False)
    kernel_ms = cuda_ms(run(tci.csc_iter))
    plain_ms = cuda_ms(run(tci.csc_iter_plain))
    bound_ms, bound_by = csc_iter_bound_ms(pos, C, T, False, False)
    # the fp32 rate cuBLAS reaches on this card for the kernel's two
    # product shapes (TF32 off): a check of the 67 TFLOP/s in the bound
    with fp32_precision():
        adj_ms = cuda_ms(lambda: G2 @ Wa)
        fwd_ms = cuda_ms(lambda: Y @ Wf)
    gflop = 2 * pos * T * C / 1e9
    return {"geometry": {"pos": pos, "C": C, "T": T},
            "tolerance_rel": KERNEL_RTOL, "grid": grid,
            "max_abs_err": max_abs, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "kernel_tflops": 3 * gflop / kernel_ms,
            "cublas_fp32_tflops": {"G2@Wa": gflop / adj_ms,
                                   "Y@Wf": gflop / fwd_ms}}


def phase_parity(dev, D, S, lmbda):
    opt = ConvBPDN.options(max_iter=PARITY_ITERS, rel_stop_tol=0.0)
    runs = []
    for d in (dev, "cpu"):
        b = ConvBPDN(D, S, lmbda, opt=opt, device=d)
        Yd = b.solve()
        runs.append((b.getitstat(), {"Y": Yd.cpu().numpy(),
                                     "X": b.state.X.cpu().numpy()}))
    errs = compare_runs("parity", runs, ("ObjFun", "DFid", "RegL1", "Rho",
                                         "PrimalRsdl", "DualRsdl"), PARITY)
    return {"iterations": PARITY_ITERS, "rel_err": errs,
            "tolerance": PARITY}


def phase_solve(dev, D, S, lmbda):
    # warm-up: cuFFT plans, cuBLAS handles, allocator
    ConvBPDN(D, S, lmbda, opt=ConvBPDN.options(max_iter=3),
             device=dev).solve()
    b = ConvBPDN(D, S, lmbda, opt=ConvBPDN.options(
        max_iter=MAX_ITER, rel_stop_tol=REL_TOL), device=dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    X = b.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    its = b.getitstat()
    k = int(b.state.k)
    if counts != {"csc_iter": k, "pgm_iter": 0}:
        raise AssertionError(f"launches {counts} in an ADMM solve of {k} "
                             "iterations")
    if tuple(X.shape) != (N, N, 1, 1, M):
        raise AssertionError(f"coefficients have shape {tuple(X.shape)}")
    for name, t in (("Y", X), ("X", b.state.X), ("U", b.state.U)):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{name} is not finite")
    if not (k < MAX_ITER and its.PrimalRsdl[-1] <= its.EPrimal[-1]
            and its.DualRsdl[-1] <= its.EDual[-1]):
        raise AssertionError(f"not converged to {REL_TOL} in {k} "
                             "iterations")
    if not (np.all(np.isfinite(its.ObjFun))
            and its.ObjFun[-1] < its.ObjFun[0]):
        raise AssertionError("objective not finite or not decreasing")
    nnz = float((b.state.Y != 0).float().mean())
    return {"iterations": k, "wall_s": wall, "iters_per_s": k / wall,
            "ms_per_iter": 1e3 * wall / k,
            "final_objective": float(its.ObjFun[-1]),
            "final_dfid": float(its.DFid[-1]),
            "final_rho": float(its.Rho[-1]), "nonzero_fraction": nnz,
            "launches": counts}


def pgm_options(max_iter=PGM_ITERS):
    return tpgm.ConvBPDN.options(max_iter=max_iter, rel_stop_tol=0.0,
                                 L=PGM_L)


def phase_pgm_kernel(dev, D):
    Wf, Wa, (pos, C, T) = headline_weights(dev, D)
    g = torch.Generator(device=dev).manual_seed(2)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    def sparse(*shape):
        return randn(*shape) * (torch.rand(shape, generator=g, device=dev)
                                < 0.05)
    G2 = randn(pos, T)
    Y0, X0 = sparse(pos, C), sparse(pos, C)
    thr_v = 0.01 + 0.02 * torch.rand(C, generator=g, device=dev)
    wl1_v = 0.5 + torch.rand(C, generator=g, device=dev)
    rL = 1.0 / PGM_L
    grid, max_abs = [], 0.0
    for nonneg in (False, True):
        for vectors in (False, True):
            for beta in (0.0, 0.7):
                thr, wl1 = (thr_v, wl1_v) if vectors else (5e-4, 1.0)
                outs = []
                for fn in (tpi.pgm_iter, tpi.pgm_iter_plain):
                    Y, X = Y0.clone(), X0.clone()
                    outs.append(fn(G2, Y, X, Wa, Wf, thr, wl1, rL, beta,
                                   nonneg=nonneg))
                errs, ae = compare_outputs(
                    "pgm_iter", ("X", "Yn", "R1", "RX", "sums"), *outs,
                    f"nonneg={nonneg} vectors={vectors} beta={beta}")
                max_abs = max(max_abs, ae)
                nnz = float((outs[0][0] != 0).float().mean())
                grid.append({"nonneg": nonneg, "vectors": vectors,
                             "beta": beta, "x_nonzero": nnz,
                             "rel_err": errs})
    # time the main path's configuration (scalar thr and wl1)
    Y, X = Y0.clone(), X0.clone()

    def run(fn):
        return lambda: fn(G2, Y, X, Wa, Wf, 5e-4, 1.0, rL, 0.7)
    kernel_ms = cuda_ms(run(tpi.pgm_iter))
    plain_ms = cuda_ms(run(tpi.pgm_iter_plain))
    bound_ms, bound_by = pgm_iter_bound_ms(pos, C, T, False)
    gflop = 2 * pos * T * C / 1e9
    return {"geometry": {"pos": pos, "C": C, "T": T},
            "tolerance_rel": KERNEL_RTOL, "grid": grid,
            "max_abs_err": max_abs, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "kernel_tflops": 3 * gflop / kernel_ms}


def phase_pgm_parity(dev, D, S, lmbda):
    W = (np.random.default_rng(3).random((N, N))
         >= MASK_MISSING).astype(np.float32)
    out = {}
    for masked in (False, True):
        cls = tpgm.ConvBPDNMask if masked else tpgm.ConvBPDN
        kw = {"W": W} if masked else {}
        runs = []
        for d in (dev, "cpu"):
            b = cls(D, S, lmbda, opt=pgm_options(PARITY_ITERS), device=d,
                    **kw)
            X = b.solve()
            runs.append((b.getitstat(), {"X": X.cpu().numpy(),
                                         "Y": b.state.Y.cpu().numpy()}))
        label = "masked" if masked else "unmasked"
        out[label] = compare_runs(f"FISTA parity ({label})", runs,
                                  ("ObjFun", "DFid", "RegL1", "Rsdl"),
                                  PGM_PARITY)
    return {"iterations": PARITY_ITERS, "mask_missing": MASK_MISSING,
            "rel_err": out, "tolerance": PGM_PARITY}


def phase_pgm_solve(dev, D, S, lmbda):
    # warm-up: cuBLAS handles, allocator
    tpgm.ConvBPDN(D, S, lmbda, opt=pgm_options(3), device=dev).solve()
    b = tpgm.ConvBPDN(D, S, lmbda, opt=pgm_options(), device=dev)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    X = b.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launches()
    its = b.getitstat()
    k = int(b.state.k)
    if k != PGM_ITERS or counts != {"csc_iter": 0, "pgm_iter": k}:
        raise AssertionError(f"launches {counts} in a FISTA solve of {k} "
                             "iterations")
    if tuple(X.shape) != (N, N, 1, 1, M):
        raise AssertionError(f"coefficients have shape {tuple(X.shape)}")
    for name in ("X", "Y", "Xprv"):
        if not bool(torch.isfinite(getattr(b.state, name)).all()):
            raise AssertionError(f"{name} is not finite")
    if not (np.all(np.isfinite(its.ObjFun)) and np.all(its.Rsdl > 0)
            and its.ObjFun[-1] < its.ObjFun[0]):
        raise AssertionError("objective not finite or not decreasing")
    nnz = float((b.state.X != 0).float().mean())
    return {"iterations": k, "wall_ms": 1e3 * wall, "iters_per_s": k / wall,
            "ms_per_iter": 1e3 * wall / k,
            "final_objective": float(its.ObjFun[-1]),
            "final_dfid": float(its.DFid[-1]),
            "final_rsdl": float(its.Rsdl[-1]), "nonzero_fraction": nnz,
            "launches": counts}


def phase_profile(dev, make_model):
    """A solve under ``torch.profiler``: device busy time (the sum of
    every kernel's and copy's time on the card) against the solve's wall
    time, and the device time by kernel.  The profiler's own host
    overhead lengthens the wall time, so the idle share is an upper
    bound."""
    from torch.profiler import ProfilerActivity, profile as tprof
    b = make_model()
    torch.cuda.synchronize()
    with tprof(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        b.solve()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    # device-side entries only (kernels, copies): an operator's own row
    # repeats the device time of the kernels it launched
    on_dev = [e for e in events
              if e.device_type == torch.autograd.DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    busy_ms = sum(dev_us(e) for e in on_dev) / 1e3
    top = sorted(on_dev, key=dev_us, reverse=True)[:12]
    k = int(b.state.k)
    return {"iterations": k, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "device_ms_per_iter": busy_ms / k,
            "top": [{"name": e.key[:70], "device_ms": dev_us(e) / 1e3,
                     "count": e.count} for e in top]}


def kernel_entry(name, kern, solve, replaces):
    return {"name": name, "route": "cuda",
            "source": f"sporco_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": solve["launches"][name],
            "max_abs_err": kern["max_abs_err"], "ms": kern["kernel_ms"],
            "kernel_ms": kern["kernel_ms"], "plain_ms": kern["plain_ms"],
            "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
            "library_ms": None}


def main(argv):
    signal.signal(signal.SIGALRM, _over_budget)
    signal.alarm(BUDGET_S)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    summary = {}

    def run_phase(name, fn):
        PHASE["name"] = name
        t0 = time.perf_counter()
        out = fn()
        out = {"phase": name, "seconds": time.perf_counter() - t0, **out}
        emit(out)
        return out

    smi = nvidia_smi()
    run_phase("device", lambda: {
        "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    def build():
        _nvcc.build(KERNELS)
        out = {"nvcc": _nvcc.find_nvcc()}
        for name in KERNELS:
            info = _nvcc.BUILD_INFO[name]
            out[name] = {
                "build_s": info["seconds"], "cached": info["cached"],
                "ptxas": [ln for ln in info["log"].splitlines()
                          if "registers" in ln or "spill" in ln]}
        return out
    run_phase("build", build)

    D, S, lmbda = headline_problem()
    summary["kernel"] = run_phase("kernel", lambda: phase_kernel(dev, D))
    run_phase("parity", lambda: phase_parity(dev, D, S, lmbda))
    summary["solve"] = run_phase("solve",
                                 lambda: phase_solve(dev, D, S, lmbda))
    summary["pgm_kernel"] = run_phase("pgm_kernel",
                                      lambda: phase_pgm_kernel(dev, D))
    run_phase("pgm_parity", lambda: phase_pgm_parity(dev, D, S, lmbda))
    summary["pgm_solve"] = run_phase(
        "pgm_solve", lambda: phase_pgm_solve(dev, D, S, lmbda))
    if "--profile" in argv:
        run_phase("profile", lambda: phase_profile(dev, lambda: ConvBPDN(
            D, S, lmbda, opt=ConvBPDN.options(
                max_iter=MAX_ITER, rel_stop_tol=REL_TOL), device=dev)))
        run_phase("pgm_profile", lambda: phase_profile(
            dev, lambda: tpgm.ConvBPDN(D, S, lmbda, opt=pgm_options(),
                                       device=dev)))
    PHASE["name"] = "kernels"
    emit({"kernels": [
        kernel_entry("csc_iter", summary["kernel"], summary["solve"],
                     "sporco_tpu/ops/pallas_csc_iter.py:276"),
        kernel_entry("pgm_iter", summary["pgm_kernel"],
                     summary["pgm_solve"],
                     "sporco_tpu/ops/pallas_csc_iter.py:409")]})
    elapsed = time.perf_counter() - t_start
    if elapsed > BUDGET_S:
        raise RuntimeError(f"over the time budget: {elapsed:.0f} s")
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        rc = main(sys.argv[1:])
    except Exception:
        print(f"chip_smoke: phase {PHASE['name']!r} failed",
              file=sys.stderr)
        traceback.print_exc()
        rc = 1
    sys.stdout.flush()
    sys.exit(rc)
