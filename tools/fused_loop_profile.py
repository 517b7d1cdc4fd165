#!/usr/bin/env python3
"""Time the fused drivers' loops of one tree of the port on the card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 tools/fused_loop_profile.py [--tree DIR] [--label NAME]

It imports ``chip_smoke.py`` and the port from ``DIR`` (default: this
checkout; an unpacked ``git archive`` of another commit under ``build/``
to compare with it), builds that tree's kernels into ``DIR/build/kernels``
and runs its phases of the fused solves at the headline problem: the
kernel's ptxas report (``build``), ``solve`` (fused ADMM, FFT precision
"high"), ``pgm_solve`` (fused FISTA), ``gradreg_solve``, ``cdl_solve``
(dictionary learning, whose x-step is a fused ADMM solve an outer
iteration) and, under
``torch.profiler``, ``profile``, ``pgm_profile``, ``gradreg_profile``
and ``ams_profile``: wall time and device busy time an iteration, the
idle share and, where the tree has the device loop, its host reads.
Prints one JSON line per phase, each with the label, the card's name
and its power limit.  Run two trees in turns in one call (parent,
change, change, parent) to compare them on one card.
"""

import argparse
import contextlib
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=".")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    label = args.label or os.path.basename(tree)
    sys.path.insert(0, tree)
    os.environ.pop("SPORCO_TPU_TORCH_BUILD_DIR", None)
    import torch
    import chip_smoke as cs
    if not os.path.abspath(cs.__file__).startswith(tree):
        raise SystemExit(f"chip_smoke came from {cs.__file__}, not {tree}")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available")
    dev = torch.device("cuda", 0)
    smi = cs.nvidia_smi()

    def emit(name, fn):
        t0 = time.perf_counter()
        try:
            out = fn()
        except Exception as exc:        # report, and go on to the next
            out = {"error": f"{type(exc).__name__}: {exc}"[:2000]}
        print(json.dumps({"label": label, "phase": name,
                          "seconds": time.perf_counter() - t0,
                          "nvidia_smi": smi, **out}), flush=True)
        return out

    def build():
        cs._nvcc.build(cs._nvcc.KERNELS)
        out = {}
        for name in ("csc_iter", "pgm_iter", "csc_tail"):
            info = cs._nvcc.BUILD_INFO[name]
            out[name] = [ln.strip() for ln in info["log"].splitlines()
                         if "stack frame" in ln or "registers" in ln]
        for name in ("csc_iter", "pgm_iter"):
            out[f"{name}_sass"] = cs.check_split_build(name)
        return out
    emit("build", build)
    D, S, lmbda = cs.headline_problem()
    Dg, gkw = cs.gradreg_problem(D)
    W, Sm = cs.ams_problem(S)
    done = {}
    with cs.fft_precision("high"):
        done["solve"] = emit("solve", lambda: cs.phase_solve(dev, D, S,
                                                             lmbda))
        emit("pgm_solve", lambda: cs.phase_pgm_solve(dev, D, S, lmbda))
    emit("gradreg_solve", lambda: cs.phase_gradreg_solve(dev, Dg, S, gkw))
    D0c, Sc, lc = cs.cdl_problem()
    emit("cdl_solve", lambda: cs.phase_cdl_solve(dev, D0c, Sc, lc))

    def admm():
        return cs.ConvBPDN(D, S, lmbda, opt=cs.ConvBPDN.options(
            max_iter=cs.MAX_ITER, rel_stop_tol=cs.REL_TOL), device=dev)
    profiles = {
        "profile": (cs.fft_precision("high"), admm),
        "pgm_profile": (cs.fft_precision("high"), lambda: cs.tpgm.ConvBPDN(
            D, S, lmbda, opt=cs.pgm_options(), device=dev)),
        "gradreg_profile": (contextlib.nullcontext(),
                            lambda: cs.ConvBPDNGradReg(
                                Dg, S, cs.LMBDA, device=dev, **gkw,
                                opt=cs.admm_options(cs.ConvBPDNGradReg))),
        "ams_profile": (contextlib.nullcontext(), lambda: cs._ams_model(
            "l1", D, Sm, W, dev).cbpdn)}
    for name, (ctx, make) in profiles.items():
        with ctx:
            emit(name, lambda: cs.phase_profile(dev, make))
    return 0


if __name__ == "__main__":
    sys.exit(main())
