#!/usr/bin/env python3
"""Rehearse phases of ``chip_smoke.py`` on the CPU at a small size.

Run from the root of a checkout, on a machine with no CUDA card:

    python3 tools/chip_smoke_cpu.py [PHASE ...]

It imports ``chip_smoke.py``, cuts the headline problem to 64x64 with 8
filters, the consensus problem to 4 images of 32x32 with 8 filters, the
dense BPDN problem to a 64x96 dictionary (8 signals for the batch), the
TV images to 64x64 (denoising) and 128x128 (deconvolution) and Robust
PCA to 64x64 of rank 3 (sketch rank 6), and runs the named phases
(default: every phase it knows, in ``PHASES``'s order) with
``device="cpu"``: the kernels' wrappers then
run their plain versions, each call of which is counted as the launch
the card would make, so the phases' launch checks on ``csc_iter``,
``pgm_iter`` and ``admm_tail`` hold as on the card (the FFT kernels run
only on the card: their counts are not checked).  CUDA events,
synchronisation and the profiler are replaced by stubs: every kernel
time a phase reports is NaN, and its wall times are the CPU's.  The
rehearsal finds wrong paths, arguments, shapes and control flow before
a chip call, and measures nothing of a device.  Prints one JSON line
per phase.
"""

import json
import math
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402
from sporco_tpu_torch.ops import csc_iter as tci  # noqa: E402
from sporco_tpu_torch.ops import csc_tail as tct  # noqa: E402
from sporco_tpu_torch.ops import pgm_iter as tpi  # noqa: E402

# the phases it runs, in chip_smoke.py's order (mixed_solve compares
# with solve and pgm_solve, which run first whenever it runs)
PHASES = ("solve", "pgm_solve", "ams_tail_kernel", "ams_parity",
          "ams_solve", "mixed_kernel", "mixed_solve", "cdl_pgm_solve",
          "bpdn_parity", "bpdn_solve", "tv_parity", "tv_solve",
          "rpca_parity", "rpca_solve", "dictlrn_handover")
COUNTED = ((tci, "csc_iter", "csc_iter_plain"),
           (tpi, "pgm_iter", "pgm_iter_plain"),
           (tct, "admm_tail", "admm_tail_plain"))


def _counting(mod, name, plain):
    fn = getattr(mod, plain)

    def call(*a, **k):
        mod.LAUNCHES[name] += 1
        return fn(*a, **k)
    setattr(mod, plain, call)


def _expect(label, counts, **want):
    got = {name: counts[name] for _, name, _ in COUNTED}
    if got != {name: want.get(name, 0) for name in got}:
        raise AssertionError(f"{label}: launches {got}, expected {want}")


def setup():
    """Cut the problems and stub the device-only measurements."""
    cs.N, cs.M = 64, 8
    cs.CN, cs.CK, cs.CM = 32, 4, 8
    cs.BPDN_N, cs.BPDN_M, cs.BPDN_K, cs.BPDN_NNZ = 64, 96, 8, 6
    cs.TV_N, cs.TVD_N = 64, 128
    cs.RPCA_N, cs.RPCA_R, cs.RPCA_RANK = 64, 3, 6
    torch.cuda.synchronize = lambda *a, **k: None
    cs.cuda_ms = lambda fn, reps=20, warmup=3, batch=1: (fn(), math.nan)[1]
    cs.device_ms_by_kernel = lambda fn, reps=10, tries=3: {}
    cs.expect_launches = _expect
    cs.accel._device = lambda dev, device: "cpu"
    for args in COUNTED:
        _counting(*args)


def main(argv):
    names = argv or list(PHASES)
    unknown = set(names) - set(PHASES)
    if unknown:
        raise SystemExit(f"unknown phases {sorted(unknown)}; known: "
                         f"{', '.join(PHASES)}")
    setup()
    torch.set_num_threads(4)
    dev = torch.device("cpu")
    D, S, lmbda = cs.headline_problem()
    W, Sm = cs.ams_problem(S)
    D0c, Sc, lc = cs.cdl_problem()
    done = {}
    runs = {
        "solve": lambda: cs.phase_solve(dev, D, S, lmbda),
        "pgm_solve": lambda: cs.phase_pgm_solve(dev, D, S, lmbda),
        "ams_tail_kernel": lambda: cs.phase_ams_tail_kernel(dev, W),
        "ams_parity": lambda: cs.phase_ams_parity(dev, D, Sm, W),
        "ams_solve": lambda: cs.phase_ams_solve(dev, D, Sm, W),
        "mixed_kernel": lambda: cs.phase_mixed_kernel(dev, D),
        "mixed_solve": lambda: cs.phase_mixed_solve(
            dev, D, S, lmbda, done["solve"], done["pgm_solve"]),
        "cdl_pgm_solve": lambda: cs.phase_cdl_pgm_solve(dev, D0c, Sc, lc),
        "bpdn_parity": lambda: cs.phase_bpdn_parity(dev),
        "bpdn_solve": lambda: cs.phase_bpdn_solve(dev),
        "tv_parity": lambda: cs.phase_tv_parity(dev),
        "tv_solve": lambda: cs.phase_tv_solve(dev),
        "rpca_parity": lambda: cs.phase_rpca_parity(dev),
        "rpca_solve": lambda: cs.phase_rpca_solve(dev),
        "dictlrn_handover": lambda: cs.phase_dictlrn_handover(dev, D, S,
                                                              lmbda),
    }
    if "mixed_solve" in names:
        names = [n for n in PHASES
                 if n in names or n in ("solve", "pgm_solve")]
    for name in names:
        t0 = time.perf_counter()
        done[name] = runs[name]()
        print(json.dumps({"phase": name, "cpu_seconds":
                          time.perf_counter() - t0, **done[name]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
