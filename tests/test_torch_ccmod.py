"""The port's ConvCnstrMOD (``ism``, ``cg``, ``cns``) against the JAX
package's on the same numpy problems, over 10 iterations: a single-channel
dictionary and signal, a colour dictionary (Cd = C = 3) and a
single-channel dictionary on three-channel signals (the channels folded
onto the signal axis).  Stats rows and the dictionary: rtol 1e-8 in
float64, 1e-4 in float32 (CG only in float64: its stopping test counts
iterations).  Both packages keep the stats rows in float32, so in
float64 a row value is held to two float32 roundings (2**-22) where
1e-8 is finer than the row can say.  ``Cnstr`` is the distance of Y
from the constraint set, zero up to rounding, so it is held to an
absolute 1e-12 (float64) or 1e-5 (float32) instead.

CG stops on a tolerance: where its residual lands within rounding of the
test, the two packages stop one iteration apart, and at the default
1e-3 that moves the colour case's dictionary by 3e-6 after one outer
iteration.  The colour CG case therefore solves to 1e-10, where one CG
iteration more or less moves nothing that 1e-8 can see (the mono and
folded cases stop alike at the default).
"""

import numpy as np
import pytest
import torch

from sporco_tpu.models import ccmod as jc
from sporco_tpu_torch import refopts as trefopts
from sporco_tpu_torch.models import ccmod as tc

torch.set_num_threads(2)

N, ND, M, K = 16, 4, 3, 3
ITERS = 10
TOL = {np.float64: 1e-8, np.float32: 1e-4}
ROW_TOL = {np.float64: 2.0 ** -22, np.float32: 1e-4}
CNSTR_ATOL = {np.float64: 1e-12, np.float32: 1e-5}
STATS = ("DFid", "PrimalRsdl", "DualRsdl", "EPrimal", "EDual", "Rho")


def _problem(C, Cd, seed=0):
    rng = np.random.default_rng(seed)
    S = rng.standard_normal((N, N, C, K) if C > 1 else (N, N, K))
    Cx = C - Cd + 1
    Z = rng.standard_normal((N, N, Cx, K, M))
    Z *= rng.random(Z.shape) < 0.2
    dsz = (ND, ND, Cd, M) if Cd > 1 else (ND, ND, M)
    return Z, S, dsz, rng.standard_normal(dsz)


def _compare(a, b, dt):
    ia, ib = a.getitstat(), b.getitstat()
    assert len(ia) == len(ib) == ITERS
    for name in STATS:
        np.testing.assert_allclose(getattr(ib, name), getattr(ia, name),
                                   rtol=ROW_TOL[dt], err_msg=name)
    np.testing.assert_allclose(ib.Cnstr, ia.Cnstr, rtol=0,
                               atol=CNSTR_ATOL[dt])
    Da, Db = np.asarray(a.getdict()), b.getdict().numpy()
    np.testing.assert_allclose(Db, Da, rtol=0,
                               atol=TOL[dt] * np.abs(Da).max())


def _run(method, Z, S, dsz, D0, dt, **kw):
    a = jc.ConvCnstrMOD(Z, S, dsz, method=method, D0=D0, dtype=dt,
                        opt=jc.ConvCnstrMODBase.options(max_iter=ITERS),
                        **kw)
    a.solve()
    b = tc.ConvCnstrMOD(Z, S, dsz, method=method, D0=D0, dtype=dt,
                        device="cpu",
                        opt=tc.ConvCnstrMODBase.options(max_iter=ITERS),
                        **kw)
    b.solve()
    return a, b


CASES = {"mono": (1, 1), "colour": (3, 3), "fold": (3, 1)}


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("method", ["ism", "cns"])
def test_ccmod_matches_jax(method, case, dt):
    Z, S, dsz, D0 = _problem(*CASES[case])
    a, b = _run(method, Z, S, dsz, D0, dt)
    _compare(a, b, dt)


@pytest.mark.parametrize("case", sorted(CASES))
def test_ccmod_cg_matches_jax(case):
    Z, S, dsz, D0 = _problem(*CASES[case])
    kw = {"cg_tol": 1e-10} if case == "colour" else {}
    a, b = _run("cg", Z, S, dsz, D0, np.float64, **kw)
    _compare(a, b, np.float64)


@pytest.mark.parametrize("method", ["ism", "cg", "cns"])
def test_ccmod_options_zero_mean_and_lin_check(method):
    """ZeroMean and LinSolveCheck through the reference option dict, the
    XSlvRelRes column included (the linear solve's relative residual:
    rounding for ism/cns, below the CG tolerance for cg)."""
    Z, S, dsz, D0 = _problem(1, 1, seed=3)
    opt = {"MaxMainIter": ITERS, "ZeroMean": True, "LinSolveCheck": True,
           "CG": {"StopTol": 1e-10}, "AutoRho": {"Period": 2}}
    a = jc.ConvCnstrMOD(Z, S, dsz, method=method, D0=D0, opt=opt,
                        dtype=np.float64)
    a.solve()
    b = tc.ConvCnstrMOD(Z, S, dsz, method=method, D0=D0, opt=opt,
                        dtype=np.float64, device="cpu")
    b.solve()
    assert b.cfg.zero_mean and b.cfg.lin_check and b.cfg.cg_tol == 1e-10
    assert b.opts.auto_rho.period == 2 and b.opts.max_iter == ITERS
    _compare(a, b, np.float64)
    ia, ib = a.getitstat(), b.getitstat()
    if method == "cg":
        # the residual CG stopped at: below its tolerance in both
        assert max(ia.XSlvRelRes.max(), ib.XSlvRelRes.max()) < 2e-10
    else:
        np.testing.assert_allclose(ib.XSlvRelRes, ia.XSlvRelRes, rtol=1e-6,
                                   atol=1e-12)
    D = b.getdict().numpy()
    np.testing.assert_allclose(D.sum(axis=(0, 1)), 0.0, atol=1e-12)


def test_ccmod_reference_keys_translate_as_in_jax():
    from sporco_tpu import refopts as jrefopts
    opt = {"MaxMainIter": 7, "rho": 2.5, "RelaxParam": 1.5,
           "AuxVarObj": True, "fEvalX": True, "ZeroMean": True,
           "LinSolveCheck": True, "CG": {"MaxIter": 30, "StopTol": 1e-4},
           ("AutoRho", "RsdlTarget"): 2.0}
    for cls_t, cls_j in ((tc.ConvCnstrMOD_IterSM, jc.ConvCnstrMOD_IterSM),
                         (tc.ConvCnstrMOD_Consensus,
                          jc.ConvCnstrMOD_Consensus)):
        ot, kt = trefopts.translate(cls_t, opt)
        oj, kj = jrefopts.translate(cls_j, opt)
        assert kt == kj
        for f in ("max_iter", "rho", "relax_param"):
            assert getattr(ot, f) == getattr(oj, f)
        assert ot.auto_rho.rsdl_target == oj.auto_rho.rsdl_target == 2.0
        with pytest.raises(trefopts.UnknownKeyError):
            trefopts.translate(cls_t, {"NoSuchKey": 1})
        with pytest.raises(trefopts.UnknownKeyError):
            trefopts.translate(cls_t, {"CG": {"Nope": 1}})
    assert tc.ConvCnstrMODOptions(method="cg").relax_param == 1.8
    given = tc.ConvCnstrMODBase.options(max_iter=3)
    assert tc.ConvCnstrMODOptions(given) is given


def test_ccmod_setcoef_and_getdict_layouts():
    """setcoef in the reference layout folds channels as the constructor
    does; getdict crops to the support unless asked not to."""
    Z, S, dsz, D0 = _problem(3, 1, seed=4)
    b = tc.ConvCnstrMOD(None, S, dsz, method="cns", D0=D0,
                        dtype=np.float64, device="cpu")
    assert b.params["Z"].abs().max() == 0
    b.setcoef(Z)
    ref = tc.ConvCnstrMOD(Z, S, dsz, method="cns", D0=D0,
                          dtype=np.float64, device="cpu")
    assert torch.equal(b.params["Z"], ref.params["Z"])
    assert tuple(b.getdict().shape) == dsz
    assert tuple(b.getdict(crop=False).shape) == (N, N, M)
    assert tuple(b.getdict_internal().shape) == (1, 1, M, N, N)
