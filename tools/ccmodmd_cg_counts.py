"""Conjugate-gradient iteration counts of the masked CCMOD's CG d-step,
card against CPU.

Runs the float64 ``ConvCnstrMODMaskDcpl(method="cg")`` problem of
``tests/test_torch_cuda.py::test_slice_models_on_card_match_cpu[ccmodmd cg]``
(10 iterations, the same seeded data) on the CUDA device and on the CPU,
records the CG iteration count of every x-step on each, then runs the
same problem at a fixed CG count (tolerance 0) and at CG tolerance 1e-10
on both.  Beside each card-against-CPU distance it gives the CPU's own
spread: the distance between two CPU runs whose S differs by one ulp.
Prints one JSON object: the counts, the first call whose count differs,
and the state's distances (of its scale).

    python3 tools/ccmodmd_cg_counts.py [--fixed N]
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from sporco_tpu_torch.models import ccmodmd as tmd  # noqa: E402


def problem(ulp=False):
    """The test's seeded data (``_new_model_cases`` draws D, S, W, Z in
    this order from ``default_rng(11)``); S moved by one ulp if
    ``ulp``."""
    rng = np.random.default_rng(11)
    D = rng.standard_normal((4, 4, 6))
    S = rng.standard_normal((32, 32, 2))
    W = (rng.random(S.shape) > 0.25).astype(np.float64)
    Z = rng.standard_normal((32, 32, 1, 2, 6)) * (rng.random(
        (32, 32, 1, 2, 6)) < 0.1)
    if ulp:
        S = S * (1 + 2.0 ** -52)
    return D, S, W, Z


def run(device, cg_tol=None, cg_max_iter=None, ulp=False):
    """Solve on ``device``; returns (the solution arrays, the CG count of
    every call)."""
    D, S, W, Z = problem(ulp)
    kw = {}
    if cg_tol is not None:
        kw = {"cg_tol": cg_tol, "cg_max_iter": cg_max_iter}
    o = tmd.ConvCnstrMODMaskDcplOptions(method="cg", max_iter=10,
                                        rel_stop_tol=0.0)
    b = tmd.ConvCnstrMODMaskDcpl(Z, S, W, D.shape, method="cg", D0=D,
                                 opt=o, device=device, dtype=torch.float64,
                                 **kw)
    counts = []
    orig = tmd.sl.solvemdbi_cg

    def counted(*a, **k):
        x, n = orig(*a, **k)
        counts.append(int(n))
        return x, n
    tmd.sl.solvemdbi_cg = counted
    try:
        b.solve()
    finally:
        tmd.sl.solvemdbi_cg = orig
    X = b.state.X
    return [t.detach().cpu().numpy() for t in X + b.state.Y], counts


def rel(a, b):
    return max(float(np.abs(x - y).max() / max(np.abs(y).max(), 1e-30))
               for x, y in zip(a, b))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--fixed", type=int, default=None,
                    help="CG iterations of the fixed-count run (default: "
                    "the largest count of the default runs)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    ag, cg_ = run("cuda")
    ac, cc = run("cpu")
    n = args.fixed or max(cg_ + cc)
    fg, fcg = run("cuda", 0.0, n)
    fc, fcc = run("cpu", 0.0, n)
    tg, tcg = run("cuda", 1e-10, 1000)
    tc, tcc = run("cpu", 1e-10, 1000)
    uc = run("cpu", ulp=True)[0]
    utc = run("cpu", 1e-10, 1000, ulp=True)[0]
    first = next((i for i, (x, y) in enumerate(zip(cg_, cc)) if x != y),
                 None)
    out = {"counts_card": cg_, "counts_cpu": cc, "first_differing_call":
           first, "rel_err_default": rel(ag, ac), "fixed_count": n,
           "fixed_counts_card": sorted(set(fcg)),
           "fixed_counts_cpu": sorted(set(fcc)),
           "rel_err_fixed": rel(fg, fc),
           "cpu_ulp_spread_default": rel(uc, ac),
           "tight_counts_card": tcg, "tight_counts_cpu": tcc,
           "rel_err_tight": rel(tg, tc),
           "cpu_ulp_spread_tight": rel(utc, tc), "tolerance": 1e-8}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
