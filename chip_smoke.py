#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one CUDA card and check them.

Run from the root of a checkout:  python3 chip_smoke.py [--profile]

The main paths are the headline problem of the repository, single-channel
2-D ConvBPDN on a 512x512 image with 64 filters of 8x8, lmbda = 0.05
(``bench.py``'s problem), solved three ways:

- by ADMM to relative residual 1e-3, through
  ``sporco_tpu_torch.models.cbpdn.ConvBPDN`` on the fused driver and its
  hand-written CUDA kernel ``csc_iter``;
- by FISTA at ``bench.py``'s PGM configuration (L = 100, 250 iterations,
  no stopping tolerance), through ``sporco_tpu_torch.models.pgm.ConvBPDN``
  on the fused packed problem and its hand-written CUDA kernel
  ``pgm_iter``;
- on the generic FFT path (``fused=False``): ADMM to 1e-3 and FISTA at
  L = 100, masked and not, whose 2-D transforms run the hand-written CUDA
  kernels ``rfft2_planar``/``irfft2_planar``;
- and its variants on the fused driver: gradient-regularised CSC
  (``ConvBPDNGradReg``, the last filter an impulse whose map carries the
  smooth part, as ``examples/csc_gradreg.py``) through the fused
  driver's ``body``, its per-bin x-step on the FFT kernels and the
  hand-written CUDA kernel ``admm_tail``; the elastic net
  (``ConvElasticNet``) through ``csc_iter``; and ``l1`` with a spatially
  varying ``L1Weight`` through ``body`` with the tail as torch ops.

Phases, each printing one JSON line on stdout:

1. ``device``: the card's name and power limit, torch and CUDA versions;
2. ``build``: the kernels' nvcc builds, one process per source, all
   started together (seconds, ptxas report); for ``csc_iter`` and
   ``pgm_iter`` their SASS by kernel (``cuobjdump``): it fails if ptxas
   reports a stack frame or spill, or if the forward pass has no HGMMA;
3. ``kernel``: ``csc_iter`` against its plain PyTorch version on the card
   at the headline geometry over the flag grid (with each output's error
   against a float64 run beside it), two launches bit for bit alike, the
   adjoint's A bit for bit cuBLAS's, kernel and plain version timed, the
   kernel also by pass (``torch.profiler``);
4. ``parity``: 10 ADMM iterations of the headline problem on the card
   against the port on the CPU (plain version), stats row by row;
5. ``solve``: the ADMM headline solve through ``ConvBPDN.solve()`` at FFT
   precision "high" (``bench.py``'s, the glue on ``torch.fft``); the
   ``csc_iter`` launch count must equal the iterations run;
6. ``pgm_kernel``: ``pgm_iter`` likewise, over its flag grid;
7. ``pgm_parity``: 10 FISTA iterations on the card against the CPU,
   unmasked and with about 30% of the pixels masked out;
8. ``pgm_solve``: the FISTA solve at precision "high"; the ``pgm_iter``
   launch count must equal the iterations run;
9. ``fft_kernel``: ``rfft2_planar``/``irfft2_planar`` against their plain
   versions and ``torch.fft`` at the x-step's 64 planes of 512x512, at
   one plane, and at ragged shapes covering each branch (the inverse
   also on a non-Hermitian spectrum); kernel, plain version and cuFFT
   timed at 64 planes and at one (``vs_library``: kernel ms over cuFFT
   ms), and so is the dispatch ``ops.fft.irfftn`` on a complex64
   spectrum (``irfft2_spectrum``, which must equal the planar call bit
   for bit at every shape); at 64 planes the device time of each
   kernel's row and column pass and their shares, and the kernels the
   dispatch runs, from ``torch.profiler``;
10. ``generic_parity``: 10 iterations of ``ConvBPDN(fused=False)`` on the
    card against the CPU (the FFT kernels' plain versions);
11. ``generic_solve``: ``ConvBPDN(fused=False)`` to 1e-3, its objective
    against the fused solve's, one ``rfft2_planar`` per iteration and
    two in the setup, one ``irfft2_planar`` per iteration; then the
    fused solve at the default precision "highest", whose glue runs the
    FFT kernels on one plane;
12. ``pgm_generic_solve``: ``pgm.ConvBPDN(fused=False)`` at L = 100 for
    250 iterations, unmasked and masked, with the launches its calls per
    iteration predict;
13. ``tail_kernel``: ``admm_tail`` against its plain version on the card
    at the headline layout (4096 x 4096) and at ragged ones (37 x 4100,
    4096 x 192) over its flag grid; kernel and plain version timed;
14. ``gradreg_parity``: 10 iterations of the gradreg problem on the card
    against the CPU;
15. ``gradreg_layout``: the same at packed layouts outside the JAX
    package's TPU block rule for its tail (128x128 with 63 filters,
    C = 4032; 200x200 with 8 filters, 625 packed rows): one
    ``admm_tail`` per iteration all the same;
16. ``gradreg_solve``: the gradreg problem to 1e-3 (or 500 iterations)
    on the fused driver: one ``admm_tail`` per iteration, one
    ``rfft2_planar``/``irfft2_planar`` pair on 64 planes per iteration
    and three forward transforms in the setup; its objective against the
    generic solve's (``fused=False``);
17. ``elastic_solve``: the elastic net (mu = 0.05) fused, one
    ``csc_iter`` per iteration and no ``admm_tail``, against the generic
    solve;
18. ``wl1_spatial_solve``: ``l1`` with a random positive spatial weight
    field on the fused ``body`` (torch-op tail: no ``csc_iter``, no
    ``admm_tail``), against the generic solve.

Each solve sets every kernel's launch count to 0 just before it and
reads the counts just after.  Then the ``{"kernels": [...]}`` line (the
inverse's ``ms`` is that of ``irfftn`` on a complex64 spectrum, the call
the solves make; ``planar_ms`` the planar entry's), the ``nvidia-smi``
name and power limit line, and last ``{"ok": true, "device": {...}}``.
Any failure exits non-zero without the ``ok`` line; so does a run past the
time budget, or a machine without a CUDA device.
``--profile`` adds phases that run the fused ADMM, fused FISTA, generic
ADMM and fused gradreg solves under ``torch.profiler`` and report the
device's busy and idle share and its time by kernel.
"""

import contextlib
import json
import math
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
from sporco_tpu_torch.models.cbpdn import (ConvBPDN, ConvBPDNGradReg,
                                           ConvElasticNet)
from sporco_tpu_torch.ops import _nvcc
from sporco_tpu_torch.ops import csc_iter as tci
from sporco_tpu_torch.ops import csc_tail as tct
from sporco_tpu_torch.ops import fft as tsf
from sporco_tpu_torch.ops import fft2_planar as tfp
from sporco_tpu_torch.ops import pgm_iter as tpi
from sporco_tpu_torch.ops.fused_csc import PS, xstep_kernels

BUDGET_S = 600          # hard limit for the whole script, build included

N, ND, M, LMBDA = 512, 8, 64, 0.05
MAX_ITER, REL_TOL = 500, 1e-3
PARITY_ITERS = 10
PGM_L, PGM_ITERS = 100.0, 250         # bench.py:_bench_pgm
MASK_MISSING = 0.3                    # share of pixels masked out
PGM_GENERIC_ITERS = 250
# (B, N0, N1) of the FFT kernel phase: the generic x-step's 64 planes,
# the fused glue's one plane, then each row-pass branch (direct DFT for
# N1 = 30, FFT for every power of two from 2 to 2048) and each column
# pass (N0 = 128, 256, 512) with a power-of-two N1 of at least 8
FFT_SHAPES = [(M, N, N), (1, N, N), (3, 128, 30), (2, 256, 64),
              (1, 512, 2048), (2, 128, 2), (3, 128, 256), (2, 256, 512),
              (2, 128, 4), (1, 256, 8), (2, 128, 16), (1, 512, 32),
              (2, 256, 128), (1, 128, 1024)]
# batch of calls per CUDA-event timing of the FFT kernels, their plain
# versions and torch.fft: a transform of 64 planes takes about as long as
# its wrapper's host time
FFT_BATCH = 10
# (R, C) of the tail kernel phase: the headline packed layout, then a C
# off a multiple of 4 with a ragged R, and a C off a multiple of 128
TAIL_SHAPES = [((N // PS) ** 2, PS * PS * M), (37, 4100),
               ((N // PS) ** 2, 192)]
GRAD_MU = 10.0          # gradient penalty of the gradreg problem
# (image side, filters) of the gradreg layout phase: C = 64 * 63 off a
# multiple of 128 (FFT kernels on), then 625 packed rows off a multiple
# of 8 (an image side the FFT kernels do not take: torch.fft)
GRAD_LAYOUTS = [(128, 63), (200, 8)]
ELASTIC_MU = 0.05       # l2 penalty of the elastic net

# Kernel against plain version on the card: A = G2 @ Wa is fp32 FFMA in
# both, summed over k = 256 in order (bit for bit alike); R1/R2 sum over
# k = 4096 on the tensor cores as split products against cuBLAS's fp32
# sums, about 1e-6 relative; 1e-5 of each output's largest magnitude.
KERNEL_RTOL = 1e-5
# Card (kernel) against CPU (plain version) over 10 iterations: the
# tolerances of the CPU test of the port against the JAX package.
PARITY = {"X": 2e-4, "ObjFun": 1e-4, "DFid": 1e-4, "RegL1": 1e-4,
          "Rho": 1e-4, "PrimalRsdl": 1e-3, "DualRsdl": 1e-3,
          "RegGrad": 1e-3}
PGM_PARITY = {"X": 2e-4, "ObjFun": 1e-4, "DFid": 1e-4, "RegL1": 1e-4,
              "Rsdl": 1e-4}
# The FFT kernels against float64 references on unit-normal data, the
# JAX package's tolerances (tests/ops/test_pallas_fft.py:36-41): forward
# 1e-6 of the spectrum's largest magnitude, inverse 3e-5 absolute; the
# kernel against its plain version and cuFFT (both fp32) within twice.
FFT_TOL = {"forward": 1e-6, "inverse": 3e-5}
# The generic solve against the fused solve of the same problem, both to
# relative residual 1e-3: final objectives within that tolerance.
OBJ_AGREE = 1e-3

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
# bf16 tensor-core products per fp32 product in the split products of
# csrc/csc_tiles.cuh (the six of order <= 2 of three-term splits)
SPLIT_PASSES = 6
PEAK_HBM_BYTES = 3.35e12
# float operations per state element in each kernel's epilogue, beside
# the 2*k of each product: csc_iter's update of Y and U and six sums;
# pgm_iter's step, prox, momentum and two sums
EPI_FLOPS = 29
PGM_EPI_FLOPS = 15
# float operations per element of admm_tail: the rescale, relaxation,
# threshold, sign, dual update, the two differences (14) and the six sums'
# products and adds (12)
TAIL_FLOPS = 26

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


def cuda_ms(fn, reps=20, warmup=3, batch=1):
    """Median time of ``fn()`` on the card in ms, from CUDA events around
    ``batch`` calls in a row (``batch > 1`` for a kernel shorter than its
    wrapper's host time, which would otherwise be timed too)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
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


def _split_bounds(pos, C, T, epi_flops, floats):
    """The bounds of csc_iter/pgm_iter.  ``bound_ms``: all three products
    as fp32-faithful splits on the tensor cores (SPLIT_PASSES bf16
    products each at 989 TFLOP/s) and the epilogue in fp32, against the
    bytes.  ``bound_as_built_ms``: the work as the kernel does it (the
    adjoint G2 @ Wa in fp32 FFMA, the forward pair split on the tensor
    cores; the forward needs the adjoint's output, so the two add).
    ``bound_fp32_ms``: all in fp32 FFMA (the bound of PRs 4-10)."""
    prod = 2 * pos * T * C
    t_epi = epi_flops * pos * C / PEAK_FP32_FLOPS * 1e3
    t_bytes = 4 * floats / PEAK_HBM_BYTES * 1e3
    t_tensor = SPLIT_PASSES * 3 * prod / PEAK_BF16_FLOPS * 1e3 + t_epi
    t_built = (prod / PEAK_FP32_FLOPS * 1e3 + t_epi
               + SPLIT_PASSES * 2 * prod / PEAK_BF16_FLOPS * 1e3)
    return {"bound_ms": max(t_tensor, t_bytes),
            "bound_by": "operations" if t_tensor >= t_bytes else "bytes",
            "bound_as_built_ms": max(t_built, t_bytes),
            "bound_fp32_ms": _bound_ms(3 * prod + epi_flops * pos * C,
                                       floats)[0]}


def csc_iter_bound_ms(pos, C, T, emit_px, vectors):
    """The bounds of one csc_iter call (see :func:`_split_bounds`)."""
    floats = (pos * T + 2 * pos * C + 2 * T * C            # G2 Y U Wa Wf
              + 2 * pos * C + 2 * pos * T + 6              # Yn Un R1 R2 sums
              + (pos * C if emit_px else 0) + (2 * C if vectors else 0))
    return _split_bounds(pos, C, T, EPI_FLOPS, floats)


def pgm_iter_bound_ms(pos, C, T, vectors):
    """The bounds of one pgm_iter call (see :func:`_split_bounds`)."""
    floats = (pos * T + 2 * pos * C + 2 * T * C            # G2 Y Xprv Wa Wf
              + 2 * pos * C + 2 * pos * T + 2              # X Yn R1 RX sums
              + (2 * C if vectors else 0))
    return _split_bounds(pos, C, T, PGM_EPI_FLOPS, floats)


def tail_bound_ms(R, C, vectors):
    """Least time of one admm_tail call: PX, PY and PU read once, PYn and
    PUn written once (see :func:`_bound_ms`)."""
    floats = 5 * R * C + 6 + (2 * C if vectors else 0)
    return _bound_ms(TAIL_FLOPS * R * C, floats)


def fft_bound_ms(B, n0, n1):
    """Least time of one 2-D real transform of B planes (either way): the
    planes in (out) and the planar half-spectrum out (in) once, and the
    2.5 N log2 N operations of a real FFT of N = n0 n1 points."""
    flops = 2.5 * B * n0 * n1 * math.log2(n0 * n1)
    floats = B * n0 * n1 + 2 * B * n0 * (n1 // 2 + 1)
    return _bound_ms(flops, floats)


def reset_launches():
    tci.reset_launches()
    tpi.reset_launches()
    tfp.reset_launches()
    tct.reset_launches()


def launches():
    return {**tci.LAUNCHES, **tpi.LAUNCHES, **tfp.LAUNCHES, **tct.LAUNCHES}


def expect_launches(label, counts, **want):
    """Fail unless the launch counts are ``want`` (every other kernel
    0)."""
    full = {name: want.get(name, 0) for name in counts}
    if counts != full:
        raise AssertionError(f"{label}: launches {counts}, expected {full}")


@contextlib.contextmanager
def fft_precision(p):
    prev = tsf.get_precision()
    tsf.set_precision(p)
    try:
        yield
    finally:
        tsf.set_precision(prev)


@contextlib.contextmanager
def planar_fft(mode):
    tsf.use_planar_fft(mode)
    try:
        yield
    finally:
        tsf.use_planar_fft("auto")


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


def float64_errors(names, got, ref, ref64):
    """Each output's largest difference from a float64 run of the plain
    version, relative to that output's largest magnitude there, for the
    kernel and the plain version (a report beside the gate, which is the
    plain version)."""
    out = {"kernel": {}, "plain": {}}
    for name, k, p, d in zip(names, got, ref, ref64):
        scale = max(float(d.abs().max()), 1e-300)
        out["kernel"][name] = float((k.double() - d).abs().max()) / scale
        out["plain"][name] = float((p.double() - d).abs().max()) / scale
    return out


def check_repeatable(kernel, run):
    """Two launches from the same inputs give the same bits, sums
    included."""
    a, b = run(), run()
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        if x is not None and not torch.equal(x, y):
            raise AssertionError(f"{kernel}: two launches from the same "
                                 "inputs differ")
    return True


def sass_counts(lib):
    """Instructions of interest by kernel in a built library, from
    ``cuobjdump -sass`` (beside nvcc)."""
    tool = os.path.join(os.path.dirname(_nvcc.find_nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", lib], capture_output=True,
                         text=True, timeout=120, check=True).stdout
    counts, fn = {}, None
    for ln in out.splitlines():
        if "Function :" in ln:
            fn = ln.split(":", 1)[1].strip()
            for short in ("iter_main", "iter_fwd", "pgm_main", "pgm_fwd",
                          "sums_kernel"):
                if short in fn:
                    fn = short
            counts[fn] = {"HGMMA": 0, "HMMA": 0, "FFMA": 0, "LDGSTS": 0}
        elif fn is not None:
            op = ln.split("*/", 1)[-1].strip().split(" ")[0].split(".")[0]
            if op in counts[fn]:
                counts[fn][op] += 1
    return counts


def check_split_build(name):
    """csc_iter/pgm_iter as built: no kernel spills or has a stack frame
    (ptxas, when this run built the library), and the forward pass runs
    its products on the tensor cores (HGMMA, wgmma, in its SASS)."""
    info = _nvcc.BUILD_INFO[name]
    for ln in info["log"].splitlines():
        if "stack frame" in ln and any(
                int(w) for w in ln.replace(",", " ").split() if w.isdigit()):
            raise AssertionError(f"{name}: ptxas reports {ln.strip()!r}")
    counts = sass_counts(info["path"])
    fwd = "iter_fwd" if name == "csc_iter" else "pgm_fwd"
    if not counts.get(fwd, {}).get("HGMMA"):
        raise AssertionError(f"{name}: no HGMMA in {fwd}: {counts}")
    return counts


def adjoint_rounding(G2, Y0, U0, Wa, Wf, wf3, rlx, us, scale):
    """Why csc_iter's adjoint is fp32 FFMA summed over k in order: the
    share of A = G2 @ Wa that the kernel gives bit for bit as cuBLAS does
    (read as PX at scale 0), and how far Un moves, relative to its scale,
    when the plain version gets the correctly rounded A (the float64
    product rounded once, fed as A @ I) in place of cuBLAS's: the most
    accurate A there is, yet not cuBLAS's bits."""
    def run(fn, g2, wa, sc, **kw):
        return fn(g2, Y0.clone(), U0.clone(), wa, Wf, 0.0143, 1.0, rlx, us,
                  sc, emit_px=True, **kw)
    a_kernel = run(tci.csc_iter, G2, Wa, 0.0, wf_split=wf3)[0]
    a_plain = run(tci.csc_iter_plain, G2, Wa, 0.0)[0]
    a_exact = (G2.double() @ Wa.double()).float()
    eye = torch.eye(a_exact.shape[1], device=G2.device)
    un_plain = run(tci.csc_iter_plain, G2, Wa, scale)[2]
    un_exact = run(tci.csc_iter_plain, a_exact, eye, scale)[2]
    ulp = torch.abs(torch.nextafter(a_exact, torch.full_like(a_exact,
                                                             math.inf))
                    - a_exact)
    return {"kernel_A_bits_as_cublas": float(
                (a_kernel == a_plain).float().mean()),
            "cublas_A_max_ulps": float(((a_plain - a_exact).abs()
                                        / ulp).max()),
            "un_rel_err_correctly_rounded_A": float(
                (un_exact - un_plain).abs().max()
                / un_plain.abs().max())}


def phase_kernel(dev, D):
    Wf, Wa, (pos, C, T) = headline_weights(dev, D)
    wf3 = tci.split_weight(Wf)
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

                def run(fn, dt=torch.float32):
                    Y, U = Y0.to(dt, copy=True), U0.to(dt, copy=True)
                    o = fn(G2.to(dt), Y, U, Wa.to(dt), Wf.to(dt), thr, wl1,
                           rlx, us, scale, nonneg=nonneg, emit_px=emit_px)
                    return [t for t in o if t is not None]
                got = run(lambda *a, **k: tci.csc_iter(*a, **k,
                                                       wf_split=wf3))
                ref = run(tci.csc_iter_plain)
                names = (["PX"] if emit_px else []) + ["Yn", "Un", "R1",
                                                       "R2", "sums"]
                where = f"emit_px={emit_px} nonneg={nonneg} vectors={vectors}"
                errs, ae = compare_outputs("csc_iter", names, got, ref,
                                           where)
                max_abs = max(max_abs, ae)
                grid.append({"emit_px": emit_px, "nonneg": nonneg,
                             "vectors": vectors, "rel_err": errs,
                             "vs_float64": float64_errors(
                                 names, got, ref,
                                 run(tci.csc_iter_plain, torch.float64))})
    adjoint = adjoint_rounding(G2, Y0, U0, Wa, Wf, wf3, rlx, us, scale)
    if adjoint["kernel_A_bits_as_cublas"] < 1.0:
        # the grid's Un gate holds only while A is cuBLAS's bit for bit
        raise AssertionError(
            "csc_iter: the adjoint's A is no longer cuBLAS's bit for bit "
            f"({adjoint}); cuBLAS changed its summation order, and Un's "
            f"{KERNEL_RTOL} gate against the plain version cannot hold")
    # the main path's configuration: repeatable, timed, and by pass
    Y, U = Y0.clone(), U0.clone()

    def run(fn):
        return lambda: fn(G2, Y, U, Wa, Wf, 0.0143, 1.0, rlx, us, scale,
                          nonneg=False, emit_px=False, wf_split=wf3)
    check_repeatable("csc_iter", lambda: tci.csc_iter(
        G2, Y0.clone(), U0.clone(), Wa, Wf, 0.0143, 1.0, rlx, us, scale,
        emit_px=True, wf_split=wf3))
    kernel_ms = cuda_ms(run(tci.csc_iter))
    pass_ms = device_ms_by_kernel(run(tci.csc_iter))
    plain_ms = cuda_ms(run(tci.csc_iter_plain))
    # the fp32 rate cuBLAS reaches on this card for the kernel's two
    # product shapes (TF32 off): a check of the 67 TFLOP/s in the bound
    with fp32_precision():
        adj_ms = cuda_ms(lambda: G2 @ Wa)
        fwd_ms = cuda_ms(lambda: Y @ Wf)
    gflop = 2 * pos * T * C / 1e9
    return {"geometry": {"pos": pos, "C": C, "T": T},
            "tolerance_rel": KERNEL_RTOL, "grid": grid,
            "repeatable": True, "adjoint": adjoint, "max_abs_err": max_abs,
            "kernel_ms": kernel_ms, "pass_ms": pass_ms,
            "plain_ms": plain_ms,
            **csc_iter_bound_ms(pos, C, T, False, False),
            "kernel_tflops": 3 * gflop / kernel_ms,
            "forward_bf16_tflops": SPLIT_PASSES * 2 * gflop / pass_ms.get(
                "iter_fwd", float("nan")),
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
    expect_launches(f"an ADMM solve of {k} iterations", counts,
                    csc_iter=k)
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
    wf3 = tci.split_weight(Wf)
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
    names = ("X", "Yn", "R1", "RX", "sums")
    grid, max_abs = [], 0.0
    for nonneg in (False, True):
        for vectors in (False, True):
            for beta in (0.0, 0.7):
                thr, wl1 = (thr_v, wl1_v) if vectors else (5e-4, 1.0)

                def run(fn, dt=torch.float32):
                    return fn(G2.to(dt), Y0.to(dt, copy=True),
                              X0.to(dt, copy=True), Wa.to(dt),
                              Wf.to(dt), thr, wl1, rL, beta, nonneg=nonneg)
                got = run(lambda *a, **k: tpi.pgm_iter(*a, **k,
                                                       wf_split=wf3))
                ref = run(tpi.pgm_iter_plain)
                errs, ae = compare_outputs(
                    "pgm_iter", names, got, ref,
                    f"nonneg={nonneg} vectors={vectors} beta={beta}")
                max_abs = max(max_abs, ae)
                nnz = float((got[0] != 0).float().mean())
                grid.append({"nonneg": nonneg, "vectors": vectors,
                             "beta": beta, "x_nonzero": nnz,
                             "rel_err": errs,
                             "vs_float64": float64_errors(
                                 names, got, ref,
                                 run(tpi.pgm_iter_plain, torch.float64))})
    # the main path's configuration (scalar thr and wl1): repeatable,
    # timed, and by pass
    Y, X = Y0.clone(), X0.clone()

    def run(fn):
        return lambda: fn(G2, Y, X, Wa, Wf, 5e-4, 1.0, rL, 0.7,
                          wf_split=wf3)
    check_repeatable("pgm_iter", lambda: tpi.pgm_iter(
        G2, Y0.clone(), X0.clone(), Wa, Wf, 5e-4, 1.0, rL, 0.7,
        wf_split=wf3))
    kernel_ms = cuda_ms(run(tpi.pgm_iter))
    pass_ms = device_ms_by_kernel(run(tpi.pgm_iter))
    plain_ms = cuda_ms(run(tpi.pgm_iter_plain))
    gflop = 2 * pos * T * C / 1e9
    return {"geometry": {"pos": pos, "C": C, "T": T},
            "tolerance_rel": KERNEL_RTOL, "grid": grid,
            "repeatable": True, "max_abs_err": max_abs,
            "kernel_ms": kernel_ms, "pass_ms": pass_ms,
            "plain_ms": plain_ms,
            **pgm_iter_bound_ms(pos, C, T, False),
            "kernel_tflops": 3 * gflop / kernel_ms,
            "forward_bf16_tflops": SPLIT_PASSES * 2 * gflop / pass_ms.get(
                "pgm_fwd", float("nan"))}


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
    if k != PGM_ITERS:
        raise AssertionError(f"a FISTA solve of {k} iterations")
    expect_launches(f"a FISTA solve of {k} iterations", counts,
                    pgm_iter=k)
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


def _rel_err(a, b, scale):
    return float((a - b).abs().max()) / scale


def device_ms_by_kernel(fn, reps=10, tries=3):
    """Device time per call of ``fn`` by kernel name, from
    ``torch.profiler`` over ``reps`` calls.  A profile that saw no device
    event at all (it happens now and then in a long run of profiles) is
    taken again, up to ``tries`` times."""
    from torch.profiler import ProfilerActivity, profile as tprof
    for _ in range(tries):
        torch.cuda.synchronize()
        with tprof(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            break
    out = {}
    for e in events:
        t = getattr(e, "self_device_time_total",
                    getattr(e, "self_cuda_time_total", 0.0))
        key = e.key.replace("(anonymous namespace)::", "")
        key = key.replace("void ", "").split("(")[0][:48]
        out[key] = out.get(key, 0.0) + t / 1e3 / reps
    return out


def fft_pass_split(x, yr, yi):
    """Device time per call of each pass of both FFT kernels, each pass's
    share of its transform, the device time of torch.fft's call on the
    same inputs, and the kernels that ``ops.fft.irfftn`` runs on the
    complex64 spectrum, with their device time."""
    n1 = x.shape[-1]
    spec = torch.complex(yr, yi)
    fwd = device_ms_by_kernel(lambda: tfp.rfft2_planar(x))
    inv = device_ms_by_kernel(lambda: tfp.irfft2_planar(yr, yi, n1))
    libs = {"rfft2_planar": device_ms_by_kernel(lambda: torch.fft.rfft2(x)),
            "irfft2_planar": device_ms_by_kernel(
                lambda: torch.fft.irfft2(spec, s=x.shape[-2:]))}
    dispatch = device_ms_by_kernel(
        lambda: tsf.irfftn(spec, s=x.shape[-2:]))
    out = {}
    for name, by_kernel, row_kernel in (
            ("rfft2_planar", fwd, "fft_rows_r2c_pow2"),
            ("irfft2_planar", inv, "fft_rows_c2r_pow2")):
        rows = sum(t for k, t in by_kernel.items() if row_kernel in k)
        cols = sum(t for k, t in by_kernel.items() if "fft_cols_pow2" in k)
        if not (rows > 0 and cols > 0):
            raise AssertionError(f"the profiler did not see both passes "
                                 f"of {name}: {by_kernel}")
        total = rows + cols
        out[name] = {"device_ms": total, "rows_ms": rows, "cols_ms": cols,
                     "rows_share": rows / total, "cols_share": cols / total,
                     "library_device_ms": sum(libs[name].values())}
    own = ("fft_cols_pow2", "fft_rows_c2r_pow2")
    if sorted(k.split("<")[0] for k in dispatch) != sorted(own):
        raise AssertionError(f"irfftn on a complex64 spectrum ran "
                             f"{dispatch}, not the inverse's kernels alone")
    out["irfft2_planar"]["irfftn_device_ms"] = sum(dispatch.values())
    out["irfft2_planar"]["irfftn_kernels"] = sorted(dispatch)
    return out


def phase_fft_kernel(dev):
    """Both FFT kernels against their plain versions, cuFFT and float64
    references at FFT_SHAPES; kernel, plain and cuFFT timed at the first
    two shapes, and the device time of each kernel's passes at the
    first."""
    g = torch.Generator(device=dev).manual_seed(3)
    rows, timing, max_abs = [], {}, {}
    for (B, n0, n1) in FFT_SHAPES:
        x = torch.randn((B, n0, n1), generator=g, device=dev)
        yr, yi = tfp.rfft2_planar(x)
        pr, pi = tfp.rfft2_planar_plain(x)
        lib = torch.fft.rfft2(x)
        ref = torch.fft.rfft2(x.double())
        sc = float(ref.abs().max())
        fwd = {"ref": max(_rel_err(yr, ref.real, sc),
                          _rel_err(yi, ref.imag, sc)),
               "plain": max(_rel_err(yr, pr, sc), _rel_err(yi, pi, sc)),
               "cufft": max(_rel_err(yr, lib.real, sc),
                            _rel_err(yi, lib.imag, sc))}
        # the inverse of a random half-spectrum (not Hermitian), against
        # numpy's semantics (torch.fft on the CPU, float64) ...
        zr = torch.randn(yr.shape, generator=g, device=dev)
        zi = torch.randn(yr.shape, generator=g, device=dev)
        xb = tfp.irfft2_planar(zr, zi, n1)
        if not torch.equal(tfp.irfft2_spectrum(torch.complex(zr, zi), n1),
                           xb):
            raise AssertionError(f"irfft2_spectrum differs from the planar "
                                 f"call at {(B, n0, n1)}")
        xp = tfp.irfft2_planar_plain(zr, zi, n1)
        xref = torch.fft.irfft2(torch.complex(zr.double(), zi.double())
                                .cpu(), s=(n0, n1)).to(dev)
        # ... and of the spectrum of a real signal, against cuFFT and the
        # signal itself
        xr = tfp.irfft2_planar(yr, yi, n1)
        xlib = torch.fft.irfft2(lib, s=(n0, n1))
        inv = {"ref": _rel_err(xb, xref, 1.0),
               "plain": _rel_err(xb, xp, 1.0),
               "cufft": _rel_err(xr, xlib, 1.0),
               "round_trip": _rel_err(xr, x, 1.0)}
        where = f"(B, N0, N1) = {(B, n0, n1)}"
        for label, errs, tol in (("rfft2_planar", fwd, FFT_TOL["forward"]),
                                 ("irfft2_planar", inv,
                                  FFT_TOL["inverse"])):
            for key, e in errs.items():
                lim = tol if key in ("ref", "round_trip") else 2 * tol
                if not e <= lim:
                    raise AssertionError(f"{label} differs from {key} by "
                                         f"{e:.3e} (tolerance {lim:.0e}) "
                                         f"at {where}")
        rows.append({"shape": [B, n0, n1], "forward_rel_err": fwd,
                     "inverse_abs_err": inv})
        if len(timing) < 2:
            # the main path's shapes: 64 planes (generic x-step), 1 (glue)
            if not timing:
                max_abs = {"rfft2_planar": max(
                    float((yr - pr).abs().max()),
                    float((yi - pi).abs().max())),
                    "irfft2_planar": float((xb - xp).abs().max())}
            bound, by = fft_bound_ms(B, n0, n1)

            def ms(fn):
                return cuda_ms(fn, batch=FFT_BATCH)
            timing[B] = {
                "rfft2_planar": {
                    "ms": ms(lambda: tfp.rfft2_planar(x)),
                    "plain_ms": ms(lambda: tfp.rfft2_planar_plain(x)),
                    "library_ms": ms(lambda: torch.fft.rfft2(x))},
                "irfft2_planar": {
                    "ms": ms(lambda: tfp.irfft2_planar(yr, yi, n1)),
                    "plain_ms": ms(
                        lambda: tfp.irfft2_planar_plain(yr, yi, n1)),
                    "library_ms": ms(
                        lambda: torch.fft.irfft2(lib, s=(n0, n1)))},
                # the dispatch on cuFFT's complex64 spectrum, as the
                # solvers call it
                "irfftn": {"ms": ms(lambda: tsf.irfftn(lib, s=(n0, n1)))},
                "bound_ms": bound, "bound_by": by}
            timing[B]["irfftn"]["library_ms"] = \
                timing[B]["irfft2_planar"]["library_ms"]
            for name in ("rfft2_planar", "irfft2_planar", "irfftn"):
                t = timing[B][name]
                t["vs_library"] = t["ms"] / t["library_ms"]
            if B == M:
                for name, split in fft_pass_split(x, yr, yi).items():
                    timing[B][name]["passes"] = split
    return {"tolerance": FFT_TOL, "shapes": rows,
            "timing": {f"B={b}": t for b, t in timing.items()},
            "max_abs_err": max_abs, "headline": timing[M]}


def phase_generic_parity(dev, D, S, lmbda):
    opt = ConvBPDN.options(max_iter=PARITY_ITERS, rel_stop_tol=0.0)
    runs = []
    for d in (dev, "cpu"):
        with planar_fft("auto" if d == dev else "always"):
            b = ConvBPDN(D, S, lmbda, opt=opt, device=d, fused=False)
            Yd = b.solve()
        runs.append((b.getitstat(), {"Y": Yd.cpu().numpy(),
                                     "X": b.state.X.cpu().numpy()}))
    errs = compare_runs("generic parity", runs,
                        ("ObjFun", "DFid", "RegL1", "Rho", "PrimalRsdl",
                         "DualRsdl"), PARITY)
    return {"iterations": PARITY_ITERS, "rel_err": errs,
            "tolerance": PARITY}


def _timed_solve(b):
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    X = b.solve()
    torch.cuda.synchronize()
    return X, time.perf_counter() - t0, launches()


def phase_generic_solve(dev, D, S, lmbda, fused):
    def model(**kw):
        return ConvBPDN(D, S, lmbda, opt=ConvBPDN.options(
            max_iter=MAX_ITER, rel_stop_tol=REL_TOL), device=dev, **kw)
    # warm-up: kernels, cuBLAS handles, allocator
    ConvBPDN(D, S, lmbda, opt=ConvBPDN.options(max_iter=3), device=dev,
             fused=False).solve()
    b = model(fused=False)
    X, wall, counts = _timed_solve(b)
    its = b.getitstat()
    k = int(b.state.k)
    expect_launches(f"a generic ADMM solve of {k} iterations", counts,
                    rfft2_planar=k + 2, irfft2_planar=k)
    if tuple(X.shape) != (N, N, 1, 1, M) or not all(
            bool(torch.isfinite(t).all()) for t in (X, b.state.X,
                                                   b.state.U)):
        raise AssertionError("generic solve: bad shape or not finite")
    if not (k < MAX_ITER and its.PrimalRsdl[-1] <= its.EPrimal[-1]
            and its.DualRsdl[-1] <= its.EDual[-1]):
        raise AssertionError(f"generic solve not converged to {REL_TOL} "
                             f"in {k} iterations")
    obj = float(its.ObjFun[-1])
    agree = abs(obj - fused["final_objective"]) / fused["final_objective"]
    if not (np.all(np.isfinite(its.ObjFun)) and agree <= OBJ_AGREE):
        raise AssertionError(f"generic objective {obj} against the fused "
                             f"solve's {fused['final_objective']}")
    # the fused solve at the default precision: its glue runs the FFT
    # kernels on one plane (setup 2, per iteration 1 + 1, final x-step
    # 1 + 1)
    bf = model()
    _, wall_f, counts_f = _timed_solve(bf)
    kf = int(bf.state.k)
    expect_launches(f"a fused ADMM solve of {kf} iterations at highest",
                    counts_f, csc_iter=kf, rfft2_planar=kf + 3,
                    irfft2_planar=kf + 1)
    return {"iterations": k, "wall_s": wall, "iters_per_s": k / wall,
            "ms_per_iter": 1e3 * wall / k, "final_objective": obj,
            "fused_final_objective": fused["final_objective"],
            "fused_iterations": fused["iterations"],
            "objective_rel_diff": agree, "final_dfid": float(its.DFid[-1]),
            "final_rho": float(its.Rho[-1]), "launches": counts,
            "fused_highest": {"iterations": kf, "wall_s": wall_f,
                              "final_objective": float(
                                  bf.getitstat().ObjFun[-1]),
                              "launches": counts_f}}


def phase_pgm_generic_solve(dev, D, S, lmbda):
    W = (np.random.default_rng(3).random((N, N))
         >= MASK_MISSING).astype(np.float32)
    out = {}
    for masked in (False, True):
        cls = tpgm.ConvBPDNMask if masked else tpgm.ConvBPDN
        kw = {"W": W} if masked else {}
        cls(D, S, lmbda, opt=pgm_options(3), device=dev, fused=False,
            **kw).solve()
        b = cls(D, S, lmbda, opt=pgm_options(PGM_GENERIC_ITERS), device=dev,
                fused=False, **kw)
        X, wall, counts = _timed_solve(b)
        its = b.getitstat()
        k = int(b.state.k)
        # per iteration: gradient 1 + 1 (2 + 2 masked), objective 1 + 0
        # (1 + 1 masked); the setup's D and S
        fwd, inv = (3, 3) if masked else (2, 1)
        label = "masked" if masked else "unmasked"
        if k != PGM_GENERIC_ITERS:
            raise AssertionError(f"generic FISTA ({label}) ran {k} "
                                 "iterations")
        expect_launches(f"a generic FISTA solve ({label})", counts,
                        rfft2_planar=fwd * k + 2, irfft2_planar=inv * k)
        if not (bool(torch.isfinite(X).all())
                and np.all(np.isfinite(its.ObjFun))
                and its.ObjFun[-1] < its.ObjFun[0]):
            raise AssertionError(f"generic FISTA ({label}): objective not "
                                 "finite or not decreasing")
        out[label] = {"iterations": k, "wall_s": wall,
                      "iters_per_s": k / wall, "ms_per_iter": 1e3 * wall / k,
                      "final_objective": float(its.ObjFun[-1]),
                      "final_rsdl": float(its.Rsdl[-1]),
                      "launches": counts,
                      "predicted": {"rfft2_planar": f"{fwd} k + 2",
                                    "irfft2_planar": f"{inv} k"}}
    return out


def phase_tail_kernel(dev):
    """admm_tail against its plain version at TAIL_SHAPES over the flag
    grid (per-channel or scalar thr/wl1, nonneg, us); kernel and plain
    version timed at the headline layout."""
    g = torch.Generator(device=dev).manual_seed(4)

    def arrays(R, C):
        PX = torch.randn((R, C), generator=g, device=dev)
        PY = torch.randn((R, C), generator=g, device=dev) * (
            torch.rand((R, C), generator=g, device=dev) < 0.05)
        PU = 0.01 * torch.randn((R, C), generator=g, device=dev)
        thr_v = 0.01 + 0.02 * torch.rand(C, generator=g, device=dev)
        wl1_v = 0.5 + torch.rand(C, generator=g, device=dev)
        return PX, PY, PU, thr_v, wl1_v
    grid, max_abs, sums_rel = [], 0.0, 0.0
    for R, C in TAIL_SHAPES:
        PX, PY0, PU0, thr_v, wl1_v = arrays(R, C)
        for vectors in (False, True):
            for nonneg in (False, True):
                for us in (1.0, 0.9):
                    thr, wl1 = (thr_v, wl1_v) if vectors else (0.0143, 1.0)
                    outs = []
                    for fn in (tct.admm_tail, tct.admm_tail_plain):
                        outs.append(fn(PX, PY0.clone(), PU0.clone(), thr,
                                       wl1, 1.8, nonneg=nonneg, us=us))
                    where = (f"(R, C) = {(R, C)} vectors={vectors} "
                             f"nonneg={nonneg} us={us}")
                    errs, ae = compare_outputs(
                        "admm_tail", ("PYn", "PUn", "sums"), *outs, where)
                    # each sum to KERNEL_RTOL of itself
                    srel = float(((outs[0][2] - outs[1][2]).abs()
                                  / outs[1][2].abs().clamp_min(1e-30))
                                 .max())
                    if srel > KERNEL_RTOL:
                        raise AssertionError(
                            f"admm_tail sums differ by {srel:.3e} relative "
                            f"at {where}")
                    max_abs = max(max_abs, ae)
                    sums_rel = max(sums_rel, srel)
                    grid.append({"shape": [R, C], "vectors": vectors,
                                 "nonneg": nonneg, "us": us,
                                 "rel_err": errs, "sums_rel_err": srel})
    # time the main path's configuration (per-filter weights, us != 1)
    R, C = TAIL_SHAPES[0]
    PX, PY, PU, thr_v, wl1_v = arrays(R, C)

    def run(fn):
        return lambda: fn(PX, PY, PU, thr_v, wl1_v, 1.8, us=0.9)
    kernel_ms = cuda_ms(run(tct.admm_tail), batch=10)
    plain_ms = cuda_ms(run(tct.admm_tail_plain), batch=10)
    bound_ms, bound_by = tail_bound_ms(R, C, True)
    return {"tolerance_rel": KERNEL_RTOL, "grid": grid,
            "max_abs_err": max_abs, "sums_max_rel_err": sums_rel,
            "geometry": {"R": R, "C": C}, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by,
            "achieved_gb_per_s": 5 * 4 * R * C / kernel_ms / 1e6}


def gradreg_problem(D):
    """The headline dictionary with its last filter made an impulse, whose
    map carries the smooth part of the image (``examples/csc_gradreg.py``):
    GradWeight 1 on it and 0 elsewhere, L1Weight 0 on it and 1
    elsewhere."""
    m = D.shape[-1]
    Dg = D.copy()
    Dg[..., -1] = 0.0
    Dg[0, 0, -1] = 1.0
    wgrd = np.zeros(m, np.float32)
    wgrd[-1] = 1.0
    wl1 = np.ones((1, 1, 1, 1, m), np.float32)
    wl1[..., -1] = 0.0
    return Dg, dict(mu=GRAD_MU, wgrd=wgrd, wl1=wl1)


def admm_options(cls, max_iter=MAX_ITER, rel_stop_tol=REL_TOL):
    return cls.options(max_iter=max_iter, rel_stop_tol=rel_stop_tol)


def phase_gradreg_parity(dev, Dg, S, kw):
    opt = admm_options(ConvBPDNGradReg, PARITY_ITERS, 0.0)
    runs = []
    for d in (dev, "cpu"):
        b = ConvBPDNGradReg(Dg, S, LMBDA, opt=opt, device=d, **kw)
        Yd = b.solve()
        runs.append((b.getitstat(), {"Y": Yd.cpu().numpy(),
                                     "X": b.state.X.cpu().numpy()}))
    errs = compare_runs("gradreg parity", runs,
                        ("ObjFun", "DFid", "RegL1", "RegGrad", "Rho",
                         "PrimalRsdl", "DualRsdl"), PARITY)
    return {"iterations": PARITY_ITERS, "rel_err": errs,
            "tolerance": PARITY}


def phase_gradreg_layout(dev, D, S):
    """The gradreg problem cut to each of GRAD_LAYOUTS: 10 iterations on
    the card, where the tail kernel must run once per iteration (the JAX
    package's tail_eligible rejects these layouts; the CUDA kernel takes
    any), against the CPU."""
    opt = admm_options(ConvBPDNGradReg, PARITY_ITERS, 0.0)
    out = {}
    for n, m in GRAD_LAYOUTS:
        Dg, kw = gradreg_problem(np.ascontiguousarray(D[..., :m]))
        Sn = np.ascontiguousarray(S[:n, :n])
        runs = []
        for d in (dev, "cpu"):
            b = ConvBPDNGradReg(Dg, Sn, LMBDA, opt=opt, device=d, **kw)
            if d is dev:
                _, _, counts = _timed_solve(b)
            else:
                b.solve()
            runs.append((b.getitstat(), {"Y": b.state.Y.cpu().numpy(),
                                         "X": b.state.X.cpu().numpy()}))
        label = f"gradreg at {n}x{n}, M = {m}"
        k = PARITY_ITERS
        planar = tfp.supported(n, n, torch.float32)
        expect_launches(label, counts, admm_tail=k,
                        rfft2_planar=k + 3 if planar else 0,
                        irfft2_planar=k if planar else 0)
        errs = compare_runs(label, runs,
                            ("ObjFun", "DFid", "RegL1", "RegGrad", "Rho",
                             "PrimalRsdl", "DualRsdl"), PARITY)
        out[f"{n}x{n}x{m}"] = {"rows": (n // PS) ** 2, "C": PS * PS * m,
                               "launches": counts, "rel_err": errs}
    return out


def _variant_solves(label, make, fused_want, generic_want):
    """A fused solve and the generic solve (``fused=False``) of the same
    problem, each timed after a 3-iteration warm-up; the launches of each
    must be ``fused_want(k)`` / ``generic_want(k)``, the final objectives
    must agree within OBJ_AGREE, and both must reach the stopping
    tolerance."""
    out = {}
    for route, want in (("fused", fused_want), ("generic", generic_want)):
        kw = {} if route == "fused" else {"fused": False}
        make(max_iter=3, **kw).solve()
        b = make(**kw)
        X, wall, counts = _timed_solve(b)
        its = b.getitstat()
        k = int(b.state.k)
        expect_launches(f"a {route} {label} solve of {k} iterations",
                        counts, **want(k))
        if tuple(X.shape) != (N, N, 1, 1, M) or not all(
                bool(torch.isfinite(t).all()) for t in (X, b.state.X,
                                                       b.state.U)):
            raise AssertionError(f"{route} {label}: bad shape or not "
                                 "finite")
        done = (its.PrimalRsdl[-1] <= its.EPrimal[-1]
                and its.DualRsdl[-1] <= its.EDual[-1])
        if not (k < MAX_ITER and done):
            raise AssertionError(f"{route} {label} not converged to "
                                 f"{REL_TOL} in {k} iterations")
        if not (np.all(np.isfinite(its.ObjFun))
                and its.ObjFun[-1] < its.ObjFun[0]):
            raise AssertionError(f"{route} {label}: objective not finite "
                                 "or not decreasing")
        out[route] = {"iterations": k, "converged": bool(done),
                      "wall_s": wall, "iters_per_s": k / wall,
                      "ms_per_iter": 1e3 * wall / k,
                      "final_objective": float(its.ObjFun[-1]),
                      "final_primal_rsdl": float(its.PrimalRsdl[-1]),
                      "final_rho": float(its.Rho[-1]),
                      "nonzero_fraction": float(
                          (b.state.Y != 0).float().mean()),
                      "launches": counts}
    fo, go = out["fused"]["final_objective"], out["generic"]["final_objective"]
    agree = abs(fo - go) / abs(go)
    if not agree <= OBJ_AGREE:
        raise AssertionError(f"{label}: fused objective {fo} against the "
                             f"generic solve's {go}")
    out["objective_rel_diff"] = agree
    out["launches"] = out["fused"]["launches"]
    return out


def phase_gradreg_solve(dev, Dg, S, kw):
    def make(max_iter=MAX_ITER, **extra):
        return ConvBPDNGradReg(Dg, S, LMBDA, device=dev, **kw, **extra,
                               opt=admm_options(ConvBPDNGradReg, max_iter))
    # fused: setup D, S and the gradient filters, then per iteration the
    # x-step's pair on 64 planes and one tail; the generic path the same
    # transforms
    out = _variant_solves(
        "gradreg", make,
        lambda k: dict(admm_tail=k, rfft2_planar=k + 3, irfft2_planar=k),
        lambda k: dict(rfft2_planar=k + 3, irfft2_planar=k))
    out["predicted"] = {"admm_tail": "k", "rfft2_planar": "k + 3",
                        "irfft2_planar": "k"}
    return out


def phase_elastic_solve(dev, D, S):
    def make(max_iter=MAX_ITER, **extra):
        return ConvElasticNet(D, S, LMBDA, mu=ELASTIC_MU, device=dev,
                              **extra,
                              opt=admm_options(ConvElasticNet, max_iter))
    # fused at "highest": the glue's pair on one plane per iteration,
    # setup D and S, the final x-step's pair
    return _variant_solves(
        "elastic", make,
        lambda k: dict(csc_iter=k, rfft2_planar=k + 3,
                       irfft2_planar=k + 1),
        lambda k: dict(rfft2_planar=k + 2, irfft2_planar=k))


def phase_wl1_spatial_solve(dev, D, S):
    W = (0.5 + np.random.default_rng(5).random((N, N, M))).astype(
        np.float32)

    def make(max_iter=MAX_ITER, **extra):
        return ConvBPDN(D, S, LMBDA, wl1=W, device=dev, **extra,
                        opt=admm_options(ConvBPDN, max_iter))
    # fused body: the spatial x-step's pair on one plane per iteration,
    # the torch-op tail, X carried (no final x-step)
    return _variant_solves(
        "spatial-L1Weight", make,
        lambda k: dict(rfft2_planar=k + 2, irfft2_planar=k),
        lambda k: dict(rfft2_planar=k + 2, irfft2_planar=k))


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
    top = sorted(on_dev, key=dev_us, reverse=True)[:16]
    k = int(b.state.k)
    return {"iterations": k, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "idle_share": 1.0 - busy_ms / wall_ms,
            "device_ms_per_iter": busy_ms / k,
            "top": [{"name": e.key[:70], "device_ms": dev_us(e) / 1e3,
                     "count": e.count} for e in top]}


def fft_entry(name, fft, generic, replaces, route=None):
    """A FFT kernel's entry, its time from the call the solves make:
    ``route`` names the timing of that call where it is not the planar
    entry's (the inverse's is ``irfftn`` on a complex64 spectrum, through
    ``irfft2_spectrum``), and the planar entry's time is kept beside."""
    t = fft["headline"]
    ms = t[route or name]["ms"]
    return {"name": name, "route": "cuda",
            "source": "sporco_tpu_torch/csrc/fft2_planar.cu",
            "replaces": replaces, "launches": generic["launches"][name],
            "max_abs_err": fft["max_abs_err"][name], "ms": ms,
            "kernel_ms": ms, "planar_ms": t[name]["ms"],
            "plain_ms": t[name]["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t[name]["library_ms"]}


def kernel_entry(name, kern, solve, replaces, source=None):
    out = {"name": name, "route": "cuda",
           "source": source or f"sporco_tpu_torch/csrc/{name}.cu",
           "replaces": replaces, "launches": solve["launches"][name],
           "max_abs_err": kern["max_abs_err"], "ms": kern["kernel_ms"],
           "kernel_ms": kern["kernel_ms"], "plain_ms": kern["plain_ms"],
           "bound_ms": kern["bound_ms"], "bound_by": kern["bound_by"],
           "library_ms": None}
    for key in ("pass_ms", "bound_as_built_ms", "bound_fp32_ms"):
        if key in kern:
            out[key] = kern[key]
    if "grid" in kern and "vs_float64" in kern["grid"][0]:
        # the largest error against float64 over the grid, by output
        out["vs_float64"] = {
            who: {o: max(g["vs_float64"][who][o] for g in kern["grid"]
                         if o in g["vs_float64"][who])
                  for o in kern["grid"][-1]["vs_float64"][who]}
            for who in ("kernel", "plain")}
    return out


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
        _nvcc.build(_nvcc.KERNELS)
        out = {"nvcc": _nvcc.find_nvcc()}
        for name in _nvcc.KERNELS:
            info = _nvcc.BUILD_INFO[name]
            out[name] = {
                "build_s": info["seconds"], "cached": info["cached"],
                "ptxas": [ln for ln in info["log"].splitlines()
                          if "registers" in ln or "spill" in ln]}
        for name in ("csc_iter", "pgm_iter"):
            out[name]["sass"] = check_split_build(name)
        return out
    run_phase("build", build)

    D, S, lmbda = headline_problem()
    summary["kernel"] = run_phase("kernel", lambda: phase_kernel(dev, D))
    run_phase("parity", lambda: phase_parity(dev, D, S, lmbda))
    # the fused solves at bench.py's FFT precision: glue on torch.fft
    with fft_precision("high"):
        summary["solve"] = run_phase("solve",
                                     lambda: phase_solve(dev, D, S, lmbda))
    summary["pgm_kernel"] = run_phase("pgm_kernel",
                                      lambda: phase_pgm_kernel(dev, D))
    run_phase("pgm_parity", lambda: phase_pgm_parity(dev, D, S, lmbda))
    with fft_precision("high"):
        summary["pgm_solve"] = run_phase(
            "pgm_solve", lambda: phase_pgm_solve(dev, D, S, lmbda))
    with fft_precision("highest"):
        summary["fft"] = run_phase("fft_kernel",
                                   lambda: phase_fft_kernel(dev))
    run_phase("generic_parity",
              lambda: phase_generic_parity(dev, D, S, lmbda))
    summary["generic"] = run_phase(
        "generic_solve",
        lambda: phase_generic_solve(dev, D, S, lmbda, summary["solve"]))
    run_phase("pgm_generic_solve",
              lambda: phase_pgm_generic_solve(dev, D, S, lmbda))
    summary["tail_kernel"] = run_phase("tail_kernel",
                                       lambda: phase_tail_kernel(dev))
    Dg, gkw = gradreg_problem(D)
    run_phase("gradreg_parity",
              lambda: phase_gradreg_parity(dev, Dg, S, gkw))
    run_phase("gradreg_layout", lambda: phase_gradreg_layout(dev, D, S))
    summary["gradreg"] = run_phase(
        "gradreg_solve", lambda: phase_gradreg_solve(dev, Dg, S, gkw))
    run_phase("elastic_solve", lambda: phase_elastic_solve(dev, D, S))
    run_phase("wl1_spatial_solve",
              lambda: phase_wl1_spatial_solve(dev, D, S))
    if "--profile" in argv:
        def admm(**kw):
            return lambda: ConvBPDN(D, S, lmbda, opt=ConvBPDN.options(
                max_iter=MAX_ITER, rel_stop_tol=REL_TOL), device=dev, **kw)
        with fft_precision("high"):
            run_phase("profile", lambda: phase_profile(dev, admm()))
            run_phase("pgm_profile", lambda: phase_profile(
                dev, lambda: tpgm.ConvBPDN(D, S, lmbda, opt=pgm_options(),
                                           device=dev)))
        run_phase("generic_profile",
                  lambda: phase_profile(dev, admm(fused=False)))
        run_phase("gradreg_profile", lambda: phase_profile(
            dev, lambda: ConvBPDNGradReg(
                Dg, S, LMBDA, device=dev, **gkw,
                opt=admm_options(ConvBPDNGradReg))))
    PHASE["name"] = "kernels"
    emit({"kernels": [
        kernel_entry("csc_iter", summary["kernel"], summary["solve"],
                     "sporco_tpu/ops/pallas_csc_iter.py:276"),
        kernel_entry("pgm_iter", summary["pgm_kernel"],
                     summary["pgm_solve"],
                     "sporco_tpu/ops/pallas_csc_iter.py:409"),
        fft_entry("rfft2_planar", summary["fft"], summary["generic"],
                  "sporco_tpu/ops/pallas_fft.py:402"),
        fft_entry("irfft2_planar", summary["fft"], summary["generic"],
                  "sporco_tpu/ops/pallas_fft.py:433", route="irfftn"),
        kernel_entry("admm_tail", summary["tail_kernel"],
                     summary["gradreg"],
                     "sporco_tpu/ops/pallas_csc_tail.py:105",
                     source="sporco_tpu_torch/csrc/csc_tail.cu")]})
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
