#!/usr/bin/env python3
"""Float32 studies of ``chip_smoke.py``'s BASELINE 1-3 problems on the CPU,
at their full sizes.

Run from the root of a checkout:

    python3 tools/dense_cpu_study.py ulp [MODEL ...]
    python3 tools/dense_cpu_study.py tvl1 [LMBDA ...]
    python3 tools/dense_cpu_study.py mdl [jax]
    python3 tools/dense_cpu_study.py svd

``ulp`` solves each dense model of ``chip_smoke.py``'s ``bpdn_solve``,
``tv_solve`` and ``rpca_solve`` (randomized and full SVD) in float32,
and ``rpca_complex``'s complex Robust PCA in complex64 (its parts each
moved), on the CPU,
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

``svd`` measures, at ``rpca_solve``'s S in float32, how far from
float64 LAPACK's the singular values (of the largest) and the sum of
those above a threshold (the nuclear prox's, at alpha between the 8th
and 9th value and at the 21st) fall for LAPACK's float32 SVD, the
port's Jacobi SVD (``ops/svd.py`` ``jacobi_svd_plain``, the card
kernels' schedule, in float64 for float32 input) and a control, a
one-sided Jacobi SVD whose rows, products and rotations stay in float32;
then solves Robust PCA in float32 (full and randomized) to 1e-3 with the
CPU's SVD and with a float64-accurate one (float64 LAPACK, rounded), and
prints the final objectives' relative difference.  About a minute.

Prints one JSON line per model, lmbda, learner or SVD.  Uses 4 CPU
threads.
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
    one ulp up or down at random (seeded); for a complex64 S, the real
    and the imaginary part of every element each so moved."""
    cplx = np.iscomplexobj(S)
    S = np.asarray(S, np.complex64 if cplx else np.float32)
    F = S.view(np.float32)
    up = np.nextafter(F, np.float32(np.inf))
    down = np.nextafter(F, np.float32(-np.inf))
    out = [("S", F), ("S + ulp", up), ("S - ulp", down)]
    rng = np.random.default_rng(1)
    for i in range(ULP_RANDOM):
        out.append((f"S +- ulp {i}", np.where(rng.random(F.shape) < 0.5,
                                              up, down)))
    return [(label, m.view(S.dtype)) for label, m in out]


def _dense_models():
    """name -> (make(S) -> model, S): the float32 solves of
    ``bpdn_solve``, ``tv_solve`` and ``rpca_solve`` (randomized, the
    default sketch, and full) and the complex64 ones of
    ``rpca_complex`` on the CPU."""
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
    out["RobustPCA full"] = (lambda s: cs.trpca.RobustPCA(
        s, opt=opt, device="cpu"), S)
    Sc, _, _ = cs.rpca_complex_problem()
    out["RobustPCA complex randomized"] = (lambda s: cs.trpca.RobustPCA(
        s, opt=opt, svd_rank=cs.RPCA_RANK, dtype=torch.complex64,
        device="cpu"), Sc)
    out["RobustPCA complex full"] = (lambda s: cs.trpca.RobustPCA(
        s, opt=opt, dtype=torch.complex64, device="cpu"), Sc)
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


def _jacobi_float32_values(a, cap=30):
    """The control of ``svd``: the singular values (descending) of a
    cyclic one-sided Jacobi SVD whose rows, products and rotations stay
    in float32, every disjoint pair of a round-robin round at once."""
    from sporco_tpu_torch.ops import svd as tsvd
    W = (a if a.shape[0] < a.shape[1] else a.mT).float().clone()
    P, L = W.shape
    if P % 2:
        W = torch.cat([W, torch.zeros(1, L)])
    n = W.shape[0]
    tol = L ** 0.5 * torch.finfo(torch.float32).eps
    for _ in range(cap):
        moved = False
        for r in range(n - 1):
            i, j = (torch.tensor(v) for v in zip(
                *[tsvd._rr_pair(n, r, k) for k in range(n // 2)]))
            x, y = W[i], W[j]
            al, be, ga = (x * x).sum(-1), (y * y).sum(-1), (x * y).sum(-1)
            do = ga.abs() > tol * al.sqrt() * be.sqrt()
            zeta = (be - al) / (2.0 * ga)
            t = torch.sign(zeta) / (zeta.abs() + torch.sqrt(1.0 + zeta * zeta))
            c = 1.0 / torch.sqrt(1.0 + t * t)
            sn = c * t
            keep = do[:, None]
            W[i] = torch.where(keep, c[:, None] * x - sn[:, None] * y, x)
            W[j] = torch.where(keep, sn[:, None] * x + c[:, None] * y, y)
            moved |= bool(do.any())
        if not moved:
            break
    return torch.sort(W[:P].norm(dim=-1), descending=True).values


def svd_study(args):
    from sporco_tpu_torch.ops import prox as tpx
    from sporco_tpu_torch.ops import svd as tsvd
    S, _, _ = cs.rpca_problem()
    a = torch.tensor(S)
    s64 = torch.linalg.svdvals(a.double())
    alphas = (0.5 * float(s64[7] + s64[8]), float(s64[20]))
    for name, fn in (("LAPACK float32", lambda x: tsvd.svd_plain(x)[1]),
                     ("port Jacobi", lambda x: tsvd.jacobi_svd_plain(x)[1]),
                     ("float32 Jacobi control", _jacobi_float32_values)):
        s = fn(a).double()
        rec = {"svd": name,
               "s_err_of_largest": float((s - s64).abs().max() / s64[0])}
        for al in alphas:
            ref = torch.clamp(s64 - al, min=0).sum()
            rec[f"sum_above_{al:.3f}_rel_err"] = float(
                (torch.clamp(s - al, min=0).sum() - ref) / ref)
        print(json.dumps(rec), flush=True)

    def svd64(x):
        return tuple(t.to(x.dtype) for t in
                     torch.linalg.svd(x.double(), full_matrices=False))
    opt = cs.trpca.RobustPCA.options(max_iter=cs.RPCA_ITERS,
                                     rel_stop_tol=cs.DENSE_TOL)
    for label, kw in (("full", {}), ("randomized",
                                     {"svd_rank": cs.RPCA_RANK})):
        runs = {}
        for name, fn in (("cpu", tsvd.svd_plain), ("float64-accurate",
                                                   svd64)):
            tpx.svd = fn
            try:
                b = cs.trpca.RobustPCA(S, opt=opt, device="cpu", **kw)
                b.solve()
            finally:
                tpx.svd = tsvd.svd
            its = b.getitstat()
            runs[name] = (len(its), float(its.ObjFun[-1]))
        print(json.dumps({
            "model": f"RobustPCA {label}", "runs": runs,
            "rel_diff": abs(runs["float64-accurate"][1] - runs["cpu"][1])
            / abs(runs["cpu"][1])}), flush=True)


def main(argv):
    if not argv or argv[0] not in ("ulp", "tvl1", "mdl", "svd"):
        raise SystemExit(__doc__)
    torch.set_num_threads(4)
    {"ulp": ulp, "tvl1": tvl1, "mdl": mdl, "svd": svd_study}[argv[0]](
        argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
