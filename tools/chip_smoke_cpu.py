#!/usr/bin/env python3
"""Rehearse phases of ``chip_smoke.py`` on the CPU at a small size.

Run from the root of a checkout, on a machine with no CUDA card:

    python3 tools/chip_smoke_cpu.py [PHASE ...]

It imports ``chip_smoke.py``, cuts the headline problem to 64x64 with 8
filters, the consensus problem to 4 images of 32x32 with 8 filters, the
dense BPDN problem to a 64x96 dictionary (8 signals for the batch), the
TV images to 64x64 (denoising) and 128x128 (deconvolution) and Robust
PCA, real and complex, to 64x64 of rank 3 (sketch rank 6; of
``rpca_complex`` its solves alone), the dictionary learning
phases' problems as ``at_cut`` says, the rest of the CSC models'
as ``at_rest_cut`` says and the parallel phases' as ``at_par`` says (in
a one-rank gloo world where the card runs NCCL), and runs the named
phases
(default: every phase it knows, in ``PHASES``'s order) with
``device="cpu"``: the kernels' wrappers then
run their plain versions, each call of which is counted as the launch
the card would make (inside the fused drivers' device loop, for live
iterations only, as on the card), so the phases' launch checks on
``csc_iter``, ``pgm_iter`` and ``admm_tail`` hold as on the card; the
fused solves' loop runs eagerly (no graph) and their host reads are
held to the card's limit.  The FFT kernels'
counts are checked in the phases of ``PLANAR_PHASES`` only, which run at
128x128 with the planar route on for CPU tensors.  CUDA events,
synchronisation and the profiler are replaced by stubs: every kernel
time a phase reports is NaN, and its wall times are the CPU's.  The
rehearsal finds wrong paths, arguments, shapes and control flow before
a chip call, and measures nothing of a device.  Prints one JSON line
per phase.
"""

import contextlib
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
from sporco_tpu_torch.ops import fft as tsf  # noqa: E402
from sporco_tpu_torch.ops import fft2_planar as tfp  # noqa: E402
from sporco_tpu_torch.ops import pgm_iter as tpi  # noqa: E402

# the parallel phases, in a one-rank gloo world (dist_world on the CPU)
PAR_PHASES = ("par_parity", "par_solve", "cns_sharded", "spatial",
              "grid_search")
# the phases it runs, in chip_smoke.py's order (mixed_solve compares
# with solve and pgm_solve, which run first whenever it runs)
PHASES = ("solve", "pgm_solve", "bt_solve", "gradreg_solve",
          "elastic_solve",
          "wl1_spatial_solve", "clr_solve", "clr_pgm_solve", "cfold_solve",
          "cdl_solve", "ams_tail_kernel", "ams_parity",
          "ams_solve", "mixed_kernel", "mixed_solve", "cdl_pgm_solve",
          "bpdn_parity", "bpdn_solve", "tv_parity", "tv_solve",
          "rpca_parity", "rpca_solve", "rpca_complex", "dictlrn_handover",
          "maskdcpl_parity", "maskdcpl_solve", "mdl_parity", "mdl_solve",
          "ccmod_cg_solve", "online_solve", "dense_dl_parity",
          "dense_dl_solve",
          *(f"{f}_{p}" for f in cs.REST_FAMILIES
            for p in ("parity", "solve")),
          *PAR_PHASES)
# the phases of the masked, online and patch dictionary learning slice,
# run at sizes the FFT kernels take (128x128) with the planar route on
# for CPU tensors, so that their FFT launch checks hold here too
PLANAR_PHASES = ("maskdcpl_parity", "maskdcpl_solve", "mdl_parity",
                 "mdl_solve", "ccmod_cg_solve", "online_solve",
                 *(f"{f}_solve" for f in cs.REST_FAMILIES),
                 "par_parity", "par_solve")
COUNTED = ((tci, "csc_iter", "csc_iter_plain"),
           (tpi, "pgm_iter", "pgm_iter_plain"),
           (tct, "admm_tail", "admm_tail_plain"))
FFT_COUNTED = ((tfp, "rfft2_planar", "rfft2_planar_plain"),
               (tfp, "irfft2_planar", "irfft2_planar_plain"))
CHECK_FFT = {"on": False}


def _counting(mod, name, plain):
    fn = getattr(mod, plain)

    def call(*a, **k):
        mod.LAUNCHES[name] += 1
        return fn(*a, **k)
    setattr(mod, plain, call)


def _expect(label, counts, **want):
    checked = COUNTED + (FFT_COUNTED if CHECK_FFT["on"] else ())
    got = {name: counts[name] for _, name, _ in checked}
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
    cs.device_ms_by_kernel = lambda fn, reps=10, tries=3, need=(): {}
    cs.expect_launches = _expect
    cs.LOOP_GRAPH = False
    cs.accel._device = lambda dev, device: "cpu"
    for args in COUNTED + FFT_COUNTED:
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
    Dc, S3 = cs.colour_problem()
    Dg, gkw = cs.gradreg_problem(D)
    done = {}
    runs = {
        "solve": lambda: cs.phase_solve(dev, D, S, lmbda),
        "pgm_solve": lambda: cs.phase_pgm_solve(dev, D, S, lmbda),
        "bt_solve": lambda: cs.phase_bt_solve(dev, D, S, lmbda),
        "gradreg_solve": lambda: cs.phase_gradreg_solve(
            dev, Dg, S, gkw),
        "elastic_solve": lambda: cs.phase_elastic_solve(dev, D, S),
        "wl1_spatial_solve": lambda: cs.phase_wl1_spatial_solve(dev, D, S),
        "clr_solve": lambda: cs.phase_clr_solve(dev, Dc, S3),
        "clr_pgm_solve": lambda: cs.phase_clr_pgm_solve(dev, Dc, S3),
        "cfold_solve": lambda: cs.phase_cfold_solve(dev, D, S3),
        "cdl_solve": lambda: cs.phase_cdl_solve(dev, D0c, Sc, lc),
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
        # its solves; the complex SVD's checks need the card
        "rpca_complex": lambda: cs.rpca_complex_solves(dev),
        "dictlrn_handover": lambda: cs.phase_dictlrn_handover(dev, D, S,
                                                              lmbda),
    }
    # the dictionary learning phases at 128x128: the headline cut to 4
    # filters, the consensus problem to 2 images of 128x128 with 4
    # filters, 2 online samples, the patch problem to a 32x32 image (625
    # patches) and 16 atoms; the sizes are set for these phases alone
    cut = {"N": 128, "M": 4, "CN": 128, "CK": 2, "CM": 4,
           "ONLINE_SAMPLES": 2, "DDL_IMG": 32, "DDL_ATOMS": 16}

    def at_cut(phase):
        def run():
            saved = {k: getattr(cs, k) for k in cut}
            for k, v in cut.items():
                setattr(cs, k, v)
            try:
                D2, S2, _ = cs.headline_problem()
                W2, Sm2 = cs.ams_problem(S2)
                D0c2, Sc2, lc2 = cs.cdl_problem()
                imgs, Wo = cs.online_samples()
                args = {"maskdcpl": (dev, D2, S2, W2, Sm2),
                        "mdl": (dev, D0c2, Sc2, lc2),
                        "ccmod": (dev, D0c2, Sc2),
                        "online": (dev, D2, imgs, Wo),
                        "dense": (dev,)}[phase.split("_")[0]]
                return getattr(cs, f"phase_{phase}")(*args)
            finally:
                for k, v in saved.items():
                    setattr(cs, k, v)
        return run
    runs.update({name: at_cut(name) for name in (
        "maskdcpl_parity", "maskdcpl_solve", "mdl_parity", "mdl_solve",
        "ccmod_cg_solve", "online_solve", "dense_dl_parity",
        "dense_dl_solve")})
    # the rest of the CSC models at 128x128 with 8 filters (one lateral
    # inhibition group), the float64 parity crop 64x64
    rest_cut = {"N": 128, "M": 8, "REST_PARITY_N": 64}

    def at_rest_cut(phase):
        family, kind = phase.rsplit("_", 1)

        def run():
            saved = {k: getattr(cs, k) for k in rest_cut}
            for k, v in rest_cut.items():
                setattr(cs, k, v)
            try:
                return getattr(cs, f"phase_rest_{kind}")(dev, family)
            finally:
                for k, v in saved.items():
                    setattr(cs, k, v)
        return run
    runs.update({f"{f}_{p}": at_rest_cut(f"{f}_{p}")
                 for f in cs.REST_FAMILIES for p in ("parity", "solve")})
    # the parallel phases: ParConvBPDN at 128x128 with 8 filters (so 8
    # groups), its float64 crop 64x64, the rest at the cut above; one
    # gloo world of one rank for all of them
    par_cut = {"N": 128, "M": 8, "REST_PARITY_N": 64}
    world = contextlib.ExitStack()
    mesh = {}

    def at_par(phase):
        def run():
            if "mesh" not in mesh:
                mesh["mesh"] = world.enter_context(cs.dist_world(dev))
            m = mesh["mesh"]
            saved = {k: getattr(cs, k) for k in par_cut}
            for k, v in par_cut.items():
                setattr(cs, k, v)
            try:
                D2, S2, l2 = cs.headline_problem()
                return {"par_parity": lambda: cs.phase_par_parity(dev, m),
                        "par_solve": lambda: cs.phase_par_solve(dev),
                        "cns_sharded": lambda: cs.phase_cns_sharded(
                            dev, m, D0c, Sc, lc),
                        "spatial": lambda: cs.phase_spatial(
                            dev, m, D2, S2, l2),
                        "grid_search": lambda: cs.phase_grid_search(m),
                        }[phase]()
            finally:
                for k, v in saved.items():
                    setattr(cs, k, v)
        return run
    runs.update({name: at_par(name) for name in PAR_PHASES})
    if "mixed_solve" in names:
        names = [n for n in PHASES
                 if n in names or n in ("solve", "pgm_solve")]
    for name in names:
        t0 = time.perf_counter()
        planar = name in PLANAR_PHASES
        CHECK_FFT["on"] = planar
        tsf.use_planar_fft("always" if planar else "auto")
        try:
            done[name] = runs[name]()
        finally:
            tsf.use_planar_fft("auto")
            CHECK_FFT["on"] = False
        print(json.dumps({"phase": name, "cpu_seconds":
                          time.perf_counter() - t0, **done[name]}),
              flush=True)
    world.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
