#!/usr/bin/env python3
"""Time the generic drivers' solves of one tree of the port on the card.

Run from the root of a checkout, on a machine with a CUDA card:

    python3 tools/generic_loop_profile.py [--tree DIR] [--label NAME]
        [--only NAME ...]

It imports ``chip_smoke.py`` and the port from ``DIR`` (default: this
checkout; an unpacked ``git archive`` of another commit under ``build/``
to compare with it), builds that tree's kernels into ``DIR/build/kernels``
and solves, in float32 at ``chip_smoke.py``'s sizes: BPDN with one and
with 256 signals, ``TVL2Denoise``, ``TVL2Deconv``, the randomized and the
full Robust PCA, the generic ConvBPDN by ADMM and by FISTA at the headline and
``PPP``; by name also FISTA with each line search at the headline (48
iterations from L = 1), ``ParConvBPDN`` on the headline to 1e-3, the
row-sharded ``cbpdn_nsharded`` there (a world of one rank over NCCL,
``chip_smoke.dist_world``) and ``ConvCnstrMOD(method="cg")`` at the
consensus geometry (``ccmod_cg``: 40 signals of 128x128, 32 filters,
coefficients drawn from ``default_rng(5)``, 5% non-zero; 50 iterations
to 1e-3).  For each, after one solve that warms it up (and keeps its
loop where the tree keeps one): the host reads of a solve (every
``item``, ``float``, ``bool`` and ``cpu`` of a CUDA tensor, counted by
monkeypatching, so both the per-iteration reads of an older tree and the
device loop's are seen), the synchronisations of a solve (the warnings of
``torch.cuda.set_sync_debug_mode("warn")``: also those inside torch's own
calls, such as ``torch.linalg.svd``'s check of its status), the wall
time an iteration of two more solves
with nothing patched (the least is ``wall_ms_per_iter``; the last one's
final objective, where the model keeps one) and, under
``torch.profiler``, the device busy time an iteration and the idle share
(with, where the tree counts them, the Jacobi SVD's ``jac_round``
launches in that solve as the device counted them, beside the
profiler's count in ``top``).
``--only cdl_solve mdl_solve dense_dl_solve`` runs those phases of
``chip_smoke.py`` instead, for the ms an outer iteration of each
dictionary learner.  ``--only svd`` times the Jacobi SVD at each shape
of :data:`SVD_CASES` (Robust PCA's full and randomized x-step in float32
and float64, rows too long for one block's shared memory, a video's
pixels by frames, a large square) on a Gaussian matrix drawn from
``torch.Generator().manual_seed(7)``, through the tree's
``chip_smoke._svd_case``: its checks, its captured replay (``ms``) and
``torch.linalg.svd`` (``plain_ms``), from CUDA events, the median of 5,
and ``sha256``, a digest of the bytes of ``u``, ``s`` and ``v^T`` from
one more call (equal digests in two trees: equal outputs bit for bit);
``--only csvd`` the complex form's at :data:`CSVD_CASES` the same way,
``--only svd.<case>`` one case of either.  ``rpca_complex`` and
``rpca_complex_full`` (by name) are ``chip_smoke.py``'s complex64 Robust
PCA solves (``rpca_complex_problem``).
Prints one JSON line per problem (per shape for ``svd``), each with the
label, the card's name and its power limit, and exits 1 if any failed.
Run two trees in turns in one call (parent, change, change, parent) to
compare them on one card.
"""

import argparse
import contextlib
import hashlib
import json
import os
import sys
import time
import warnings

PROBLEMS = ("bpdn_k1", "bpdn_k256", "tvl2den", "tvl2dcn", "rpca",
            "rpca_full", "cbpdn_admm", "cbpdn_fista", "ppp")
# the loops of the last slices, run by name (--only): complex64 Robust
# PCA (chip_smoke.py rpca_complex) among them
LOOPS = ("fista_bt_standard", "fista_bt_robust", "par_headline",
         "cbpdn_sharded", "ccmod_cg", "rpca_complex", "rpca_complex_full")
BT_ITERS, BT_L = 48, 1.0
# the dictionary-learning phases of chip_smoke.py (--only dl): ms an
# outer iteration, their x- and d-steps solved again each outer iteration
DL_PHASES = ("cdl_solve", "mdl_solve", "dense_dl_solve")
# the Jacobi SVD's shapes (--only svd): case -> shape, type
SVD_CASES = {
    "full32": ((512, 512), "float32"),
    "full64": ((512, 512), "float64"),
    "small32": ((26, 512), "float32"),
    "small64": ((26, 512), "float64"),
    "wide64": ((4, 20000), "float64"),
    "tall32": ((30000, 8), "float32"),
    "video32": ((76800, 100), "float32"),
    "large32": ((2048, 2048), "float32"),
}
# the complex form's (--only csvd): Robust PCA's complex x-step shapes,
# and rows too long for one block's shared memory (100 x 2000: the global
# route of a form without clusters, the shared route of one with them)
CSVD_CASES = {
    "cfull64": ((512, 512), "complex64"),
    "csmall64": ((26, 512), "complex64"),
    "cmid64": ((256, 192), "complex64"),
    "cfull128": ((512, 512), "complex128"),
    "clong64": ((100, 2000), "complex64"),
}
SVD_REPS = 5


def _cases(name):
    """The SVD cases of ``--only`` name ``name``: every real one
    (``svd``), every complex one (``csvd``), one (``svd.<case>``), or
    none (a problem)."""
    if name == "svd":
        return list(SVD_CASES)
    if name == "csvd":
        return list(CSVD_CASES)
    if name.startswith("svd."):
        return [name[4:]]
    return [None]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=".")
    ap.add_argument("--label", default=None)
    ap.add_argument("--only", nargs="*", default=None)
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
    cs._nvcc.build(cs._nvcc.KERNELS)
    names = args.only or PROBLEMS
    world = (cs.dist_world(dev) if "cbpdn_sharded" in names
             else contextlib.nullcontext())
    runs = [(name, case) for name in names for case in _cases(name)]
    failed = 0
    with world as mesh:
        makers = _makers(cs, dev, torch, mesh)
        for name, case in runs:
            t0 = time.perf_counter()
            try:
                out = (_svd(cs, torch, dev, case) if case
                       else _dl(cs, dev, name) if name in DL_PHASES
                       else _measure(cs, torch, makers[name]))
            except Exception as exc:    # report, go on, and fail at the end
                out = {"error": f"{type(exc).__name__}: {exc}"[:2000]}
                failed += 1
            head = {"label": label, "problem": name}
            if case:
                head["case"] = case
            print(json.dumps({**head, "seconds": time.perf_counter() - t0,
                              "nvidia_smi": smi, **out}), flush=True)
    return 1 if failed else 0


class _Run:
    """A solve that is no model (or keeps its count elsewhere), as
    ``_measure`` and ``chip_smoke.phase_profile`` take a model:
    ``solve()`` runs ``fn``, which returns the iterations, kept in
    ``j``."""

    def __init__(self, fn, dev):
        self.fn, self.device, self.j = fn, dev, 0

    def solve(self):
        self.j = self.fn()


def _makers(cs, dev, torch, mesh):
    """problem name -> a maker of its float32 model, as the tree's
    ``chip_smoke.py`` phases make it."""
    out = {}
    for K, name in ((1, "bpdn_k1"), (cs.BPDN_K, "bpdn_k256")):
        D, S, _ = cs.bpdn_problem(K)
        out[name] = (lambda D=D, S=S: cs.tbpdn.BPDN(
            D, S, cs.BPDN_LMBDA, device=dev, opt=cs.tbpdn.BPDN.options(
                max_iter=cs.BPDN_ITERS, rel_stop_tol=cs.DENSE_TOL)))
    tv = cs.tv_problems()
    for name, tvname in (("tvl2den", "TVL2Denoise"),
                         ("tvl2dcn", "TVL2Deconv")):
        cls, a, okw, _ = tv[tvname]
        out[name] = (lambda cls=cls, a=a, okw=okw: cls(
            *a, opt=cls.options(**okw), device=dev))
    Sr, _, _ = cs.rpca_problem()
    for name, kw in (("rpca", {"svd_rank": cs.RPCA_RANK}), ("rpca_full", {})):
        out[name] = (lambda kw=kw: cs.trpca.RobustPCA(
            Sr, device=dev, **kw, opt=cs.trpca.RobustPCA.options(
                max_iter=cs.RPCA_ITERS, rel_stop_tol=cs.DENSE_TOL)))
    if hasattr(cs, "rpca_complex_problem"):
        Sz, _, _ = cs.rpca_complex_problem()
        for name, kw in (("rpca_complex", {"svd_rank": cs.RPCA_RANK}),
                         ("rpca_complex_full", {})):
            out[name] = (lambda kw=kw: cs.trpca.RobustPCA(
                Sz, device=dev, dtype=torch.complex64, **kw,
                opt=cs.trpca.RobustPCA.options(max_iter=cs.RPCA_ITERS,
                                               rel_stop_tol=cs.DENSE_TOL)))
    D, S, lmbda = cs.headline_problem()
    out["cbpdn_admm"] = lambda: cs.ConvBPDN(
        D, S, lmbda, opt=cs.ConvBPDN.options(max_iter=cs.MAX_ITER,
                                             rel_stop_tol=cs.REL_TOL),
        device=dev, fused=False)
    out["cbpdn_fista"] = lambda: cs.tpgm.ConvBPDN(
        D, S, lmbda, opt=cs.pgm_options(cs.PGM_GENERIC_ITERS), device=dev,
        fused=False)
    pp = cs.ppp_problem(cs.N)
    out["ppp"] = lambda: pp["PPP"](dev, "float32", cs.PPP_ITERS, cs.REL_TOL)
    for bt in ("standard", "robust"):
        out[f"fista_bt_{bt}"] = (lambda bt=bt: cs.tpgm.ConvBPDN(
            D, S, lmbda, device=dev, fused=False, opt=cs.tpgm.ConvBPDN
            .options(max_iter=BT_ITERS, rel_stop_tol=0.0, L=BT_L,
                     backtrack=bt)))

    D0c, Sc, _ = cs.cdl_problem()
    g = cs.np.random.default_rng(5)
    shape = Sc.shape[:2] + (1, Sc.shape[2], D0c.shape[-1])
    Zc = (g.standard_normal(shape) * (g.random(shape) < 0.05)).astype(
        cs.np.float32)
    out["ccmod_cg"] = lambda: cs.tccmod.ConvCnstrMOD(
        Zc, Sc, D0c.shape, method="cg", D0=D0c, device=dev,
        opt=cs.tccmod.ConvCnstrMODBase.options(max_iter=50,
                                               rel_stop_tol=1e-3))

    def par():
        b = cs._par(D, S, None, lmbda, dev, cs.PAR_MAX_ITER)
        return _Run(lambda: (b.solve(), int(b.state[6]))[1], dev)
    out["par_headline"] = par
    if mesh is not None:
        from sporco_tpu_torch.parallel import spatial
        opt = cs.ConvBPDN.options(max_iter=cs.MAX_ITER,
                                  rel_stop_tol=cs.REL_TOL)
        out["cbpdn_sharded"] = lambda: _Run(lambda: spatial.cbpdn_nsharded(
            D, S, lmbda, mesh, opt=opt)[2], dev)
    return out


def _svd(cs, torch, dev, case):
    """The Jacobi SVD of a Gaussian matrix of ``SVD_CASES[case]`` (or
    ``CSVD_CASES[case]``), as ``chip_smoke._svd_case`` checks and times it
    (no prox, not against the plain version), and the digest of one more
    call's outputs."""
    shape, dt = {**SVD_CASES, **CSVD_CASES}[case]
    a = torch.randn(shape, generator=torch.Generator().manual_seed(7),
                    dtype=getattr(torch, dt)).to(dev)
    rec = cs._svd_case(a, case, False, reps=SVD_REPS, prox=False)
    rec["geometry"] = list(rec["geometry"])
    digest = hashlib.sha256()
    for t in cs.tsvd.jacobi_svd(a):
        digest.update(t.contiguous().cpu().numpy().tobytes())
    return {"dtype": dt, **rec, "sha256": digest.hexdigest()}


def _dl(cs, dev, name):
    """ms an outer iteration of each learner of the dictionary-learning
    phase ``name``, run twice: cold (the first phase of the process) and
    warm (its loops kept from the first run, as after
    ``chip_smoke.py``'s earlier phases)."""
    runs = []
    for _ in range(2):
        if name == "dense_dl_solve":
            out = cs.phase_dense_dl_solve(dev)
        else:
            D0, S, lmbda = cs.cdl_problem()
            out = getattr(cs, f"phase_{name}")(dev, D0, S, lmbda)
        if "ms_per_iter" in out:        # cdl_solve: one learner
            out = {"ConvBPDNDictLearn": {"ms_per_outer_iter":
                                         out["ms_per_iter"]}}
        runs.append({k: v["ms_per_outer_iter"] for k, v in out.items()
                     if "ms_per_outer_iter" in v})
    return {"ms_per_outer_iter": runs[1], "cold_ms_per_outer_iter": runs[0]}


def _measure(cs, torch, make):
    make().solve()                      # warm-up (and a kept loop)
    reads = {"n": 0}
    saved = {}
    for meth in ("item", "__float__", "__int__", "__bool__", "cpu",
                 "tolist"):
        orig = getattr(torch.Tensor, meth)
        saved[meth] = orig

        def counted(self, *a, _orig=orig, **k):
            if self.is_cuda:
                reads["n"] += 1
            return _orig(self, *a, **k)
        setattr(torch.Tensor, meth, counted)
    try:
        make().solve()                  # the host reads, counted
    finally:
        for meth, orig in saved.items():
            setattr(torch.Tensor, meth, orig)
    # every synchronisation torch sees in a solve, its own calls' too
    # (torch.linalg.svd's check of its status) beside the reads above
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            make().solve()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    walls = []
    for _ in range(2):                  # the wall, with nothing patched
        b = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        b.solve()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    k = b.j if hasattr(b, "j") else int(b.state.k)
    loop = dict(cs.device_loop.LAST) if cs.device_loop.LAST.get(
        "live") == k else {}
    # the last wall solve's final objective, where the model keeps one
    its = b.getitstat() if hasattr(b, "getitstat") else None
    obj = (float(its.ObjFun[-1]) if its is not None
           and len(getattr(its, "ObjFun", ())) else None)
    # the Jacobi SVD's jac_round launches in the profiled solve, counted
    # on the device, where the tree counts them (beside the profiler's
    # count of the kernel's events in "top")
    svd = getattr(cs, "tsvd", None)
    counted = svd is not None and hasattr(svd, "reset_launches")
    if counted:
        torch.cuda.synchronize()
        svd.reset_launches()
    prof = cs.phase_profile(b.device, make)
    jac = svd.launches() if counted else None
    # the profiler's count of jac_round events among the 16 kernels of
    # most device time (None where it is not among them)
    seen = [t["count"] for t in prof["top"] if "jac_round" in t["name"]]
    return {"iterations": k, "final_objective": obj,
            "jac_round_device_launches": jac,
            "jac_round_profiler_launches": sum(seen) if seen else None,
            "wall_ms_per_iter": 1e3 * min(walls) / k,
            "wall_ms_per_iter_runs": [1e3 * w / k for w in walls],
            "host_reads": reads["n"], "host_reads_per_iter": reads["n"] / k,
            "syncs": syncs, "syncs_per_iter": syncs / k,
            "loop_host_reads": loop.get("host_reads"),
            "route": loop.get("route"), "graph": loop.get("graph"),
            "flag_reads": loop.get("flag_reads"),
            "profiled_iterations": prof["iterations"],
            "profiled_wall_ms_per_iter": prof["wall_ms_per_iter"],
            "device_ms_per_iter": prof["device_ms_per_iter"],
            "idle_share": prof["idle_share"],
            "top": prof["top"][:6]}


if __name__ == "__main__":
    sys.exit(main())
