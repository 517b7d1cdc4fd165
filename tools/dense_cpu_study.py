#!/usr/bin/env python3
"""Float32 studies of ``chip_smoke.py``'s BASELINE 1-3 problems on the CPU,
at their full sizes.

Run from the root of a checkout:

    python3 tools/dense_cpu_study.py ulp [MODEL ...]
    python3 tools/dense_cpu_study.py tvl1 [LMBDA ...]
    python3 tools/dense_cpu_study.py mdl [jax]

``ulp`` solves each dense model of ``chip_smoke.py``'s ``bpdn_solve``,
``tv_solve`` and ``rpca_solve`` (randomized SVD) in float32 on the CPU,
as those phases do, seven times: on S, on S moved one ulp up and one ulp
down (``numpy.nextafter``), and on four draws of S with each element
moved one ulp up or down at random.  For each it prints the iteration
counts and the largest relative difference of the final objective
between the solve on S and any moved solve: the spread that float32 rounding
alone gives a whole solve, against which ``chip_smoke.py`` sets its
card-against-CPU limit.  For ``BPDNProjL1``, whose objective (DFid) goes
to 0, the difference is also given over ``||S||^2``.

``tvl1`` solves ``TVL1Deconv`` on ``chip_smoke.py``'s deconvolution
problem (512x512, 200 iterations at most, tolerance 1e-4, the model's
default rho and AutoRho off) for each lmbda (default: a sweep from 5e-3
to 0.5), with the objective taken at X (``g_eval_y=False``; at Y, the
default, it starts from Y = 0 and rises as Y fills), and prints the
iterations, the first, least and last objective, the largest rise of the
objective over the last 50 iterations, the first and last primal and
dual residuals and the PSNR against the clean image beside the
input's.

``mdl`` runs ``ConvBPDNMaskDictLearn`` as ``chip_smoke.py``'s
``mdl_solve`` does (the consensus geometry, the masked stage's mask, 50
outer iterations of each method pair, float32), then in float64 at 2
images of 128x128 with 4 filters, and prints the x-step objective's
first, least and last value, where the least falls, and the d-step's
rho (or FISTA's L) at the first and last outer iteration; with ``jax``
the JAX package runs each beside the port (it then needs the JAX
package; about 15 minutes).

Prints one JSON line per model, lmbda or learner.  Uses 4 CPU threads.
"""

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402

TVL1_SWEEP = (5e-3, 1e-2, 2e-2, 5e-2, 0.1, 0.2, 0.5, 1.0)
ULP_RANDOM = 4


def _moved(S):
    """S, S one ulp up, one ulp down, and four moves of every element
    one ulp up or down at random (seeded)."""
    S = np.asarray(S, np.float32)
    up = np.nextafter(S, np.float32(np.inf))
    down = np.nextafter(S, np.float32(-np.inf))
    out = [("S", S), ("S + ulp", up), ("S - ulp", down)]
    rng = np.random.default_rng(1)
    for i in range(ULP_RANDOM):
        out.append((f"S +- ulp {i}", np.where(rng.random(S.shape) < 0.5,
                                              up, down)))
    return out


def _dense_models():
    """name -> (make(S) -> model, S, ||S||^2): the float32 solves of
    ``bpdn_solve``, ``tv_solve`` and ``rpca_solve`` (randomized, the
    default sketch) on the CPU."""
    out = {}
    for K in (1, cs.BPDN_K):
        D, S, x0 = cs.bpdn_problem(K)
        for name, (cls, kw) in cs.bpdn_models(D, S, x0).items():
            if K > 1 and name != "BPDN":
                continue
            opt = cls.options(max_iter=cs.BPDN_ITERS,
                              rel_stop_tol=cs.DENSE_TOL)
            out[f"{name} K={K}"] = (
                lambda s, cls=cls, D=D, opt=opt, kw=kw: cls(
                    D, s, opt=opt, device="cpu", **kw), S)
    for name, (cls, args, okw, _) in cs.tv_problems().items():
        out[name] = (lambda s, cls=cls, args=args, okw=okw: cls(
            *args[:-2], s, args[-1], opt=cls.options(**okw),
            device="cpu"), args[-2])
    S, _, _ = cs.rpca_problem()
    opt = cs.trpca.RobustPCA.options(max_iter=cs.RPCA_ITERS,
                                     rel_stop_tol=cs.DENSE_TOL)
    out["RobustPCA randomized"] = (lambda s: cs.trpca.RobustPCA(
        s, opt=opt, svd_rank=cs.RPCA_RANK, device="cpu"), S)
    return out


def ulp(names):
    models = _dense_models()
    for name in names or list(models):
        make, S = models[name]
        runs = {}
        for label, s in _moved(S):
            b = make(s)
            b.solve()
            its = b.getitstat()
            runs[label] = (len(its), float(its._arr[-1, 1]))
        k0, f0 = runs["S"]
        diff = max(abs(f - f0) for _, f in runs.values())
        rec = {"model": name, "objective_name": its._names[1],
               "iterations": {k: v[0] for k, v in runs.items()},
               "objective": {k: v[1] for k, v in runs.items()},
               "rel_spread": diff / abs(f0)}
        if name.startswith("BPDNProjL1"):
            rec["spread_over_S2"] = diff / float(
                np.sum(np.asarray(S, np.float64) ** 2))
        print(json.dumps(rec), flush=True)


def tvl1(lmbdas):
    img, h, noisy, _ = cs.tv_example(cs.TVD_N)
    for lmbda in lmbdas or TVL1_SWEEP:
        lmbda = float(lmbda)
        b = cs.ttv.TVL1Deconv(h, noisy, lmbda, device="cpu",
                              g_eval_y=False,
                              opt=cs.ttv.TVL1Deconv.options(
                                  max_iter=cs.TVD_ITERS,
                                  rel_stop_tol=cs.TVD_TOL))
        b.solve()
        its = b.getitstat()
        f = np.asarray(its.ObjFun, np.float64)
        tail = np.diff(f[-50:])
        X = b.getmin().cpu().numpy()
        print(json.dumps({
            "lmbda": lmbda, "iterations": len(f),
            "objective_first": float(f[0]), "objective_min": float(f.min()),
            "objective_last": float(f[-1]),
            "largest_rise_last_50": float(max(tail.max(), 0.0)),
            "primal_rsdl_first_last": [float(its.PrimalRsdl[0]),
                                       float(its.PrimalRsdl[-1])],
            "dual_rsdl_first_last": [float(its.DualRsdl[0]),
                                     float(its.DualRsdl[-1])],
            "psnr_input_db": cs.psnr(img, noisy),
            "psnr_db": cs.psnr(img, X)}), flush=True)


def _mdl_record(pkg, dtype, xm, dm, its):
    f = np.asarray(its["XObjFun"], np.float64)
    rho = its.get("DRho", its.get("DL"))
    return {"package": pkg, "dtype": dtype, "pair": f"{xm}/{dm}",
            "outer_iterations": len(f), "objective_first": float(f[0]),
            "objective_least": float(f.min()),
            "least_at": int(np.argmin(f)), "objective_last": float(f[-1]),
            "d_rho_or_L_first_last": [float(rho[0]), float(rho[-1])]}


def mdl(args):
    """``ConvBPDNMaskDictLearn`` as ``chip_smoke.py``'s ``mdl_solve``
    runs it (float32, CNS_ITERS outer iterations, each pair of
    MDL_PAIRS), then in float64 at 2 images of 128x128 with 4 filters;
    with ``jax`` the JAX package on the same problems beside the port."""
    pkgs = ["port"] + (["jax"] if "jax" in args else [])
    if "jax" in pkgs:
        import jax
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        from sporco_tpu.models import dictlrn as jd
    for dtype, cut in (("float32", None), ("float64", (128, 2, 4))):
        if cut is not None:
            cs.CN, cs.CK, cs.CM = cut
        D0, S, lmbda = cs.cdl_problem()
        W = cs.mdl_mask(S)
        for xm, dm in cs.MDL_PAIRS:
            for pkg in pkgs:
                kw = dict(W=W, xmethod=xm, dmethod=dm,
                          max_iter=cs.CNS_ITERS, dtype=dtype)
                d = (jd.ConvBPDNMaskDictLearn(D0, S, lmbda, **kw)
                     if pkg == "jax" else
                     cs.tdl.ConvBPDNMaskDictLearn(D0, S, lmbda,
                                                  device="cpu", **kw))
                d.solve()
                print(json.dumps(_mdl_record(pkg, dtype, xm, dm,
                                             d.getitstat())), flush=True)


def main(argv):
    if not argv or argv[0] not in ("ulp", "tvl1", "mdl"):
        raise SystemExit(__doc__)
    torch.set_num_threads(4)
    {"ulp": ulp, "tvl1": tvl1, "mdl": mdl}[argv[0]](argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
