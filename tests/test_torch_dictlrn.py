"""The port's ConvBPDNDictLearn against the JAX package's on the same
numpy problems, over 5 outer iterations: the ADMM x-step with the
``ism``, ``cg``, ``cns`` and FISTA (``pgm``) dictionary updates, the
FISTA x-step with ``cns`` and ``pgm``, the gradient-regularised x-step
(``mu > 0``), a multi-scale
``dsz`` and one float32 case at a geometry the fused drivers take (the
port's fused x-step on ``csc_iter``'s plain version against the JAX
fused driver with its Pallas kernel in interpret mode).

Every itstat column and the dictionary: rtol 1e-8 in float64 (a column
comes from a float32 stats row in both packages, so it is held to two
float32 roundings, 2**-22), 1e-4 in float32.  ``DCnstr`` (the
dictionary's distance from the constraint set, zero up to rounding) is
held absolutely (1e-12; float32 1e-5).  In the float32 case a column may
instead be as close to the JAX package's float64 run as the JAX float32
run is (within 1.5 times its distance): the d-step's ``DFid`` there is
a residual 2e-4 of the signal's energy, and the JAX float32 run itself
is 1e-4 of it away from float64.

The FISTA dictionary update on its own, ``pgm.ConvCnstrMOD`` and
``ConvCnstrMODMask`` (mirroring ``tests/models/test_pgm.py:240`` and
``tests/models/test_dictlrn.py:96``), is held to the same float64
tolerances over 30 iterations.
"""

import numpy as np
import pytest
import torch

from sporco_tpu import refopts as jrefopts
from sporco_tpu.models import dictlrn as jd
from sporco_tpu.models import pgm as jpgm
from sporco_tpu.ops import pallas_csc_iter as pki
from sporco_tpu_torch import refopts as trefopts
from sporco_tpu_torch.models import dictlrn as td
from sporco_tpu_torch.models import pgm as tpgm
from sporco_tpu_torch.ops import fused_csc as tfc

torch.set_num_threads(2)

ITERS = 5
LMBDA = 0.1
TOL = {np.float64: 1e-8, np.float32: 1e-4}
ROW_TOL = {np.float64: 2.0 ** -22, np.float32: 1e-4}
ZERO_ATOL = {np.float64: 1e-12, np.float32: 1e-5}


def _problem(N=16, Nd=4, M=4, K=3, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((Nd, Nd, M)),
            rng.standard_normal((N, N, K)))


def _compare(a, b, dt, ref64=None):
    ia, ib = a.getitstat(), b.getitstat()
    i64 = ref64.getitstat() if ref64 is not None else None
    assert sorted(ia) == sorted(ib)
    for k in ia:
        assert len(ib[k]) == ITERS
        if k == "DCnstr":
            np.testing.assert_allclose(ib[k], ia[k], rtol=0,
                                       atol=ZERO_ATOL[dt])
            continue
        if i64 is not None and not np.allclose(
                ib[k], ia[k], rtol=ROW_TOL[dt], atol=ZERO_ATOL[dt],
                equal_nan=True):
            d_port = np.abs(ib[k] - i64[k]).max()
            d_jax = np.abs(ia[k] - i64[k]).max()
            assert d_port <= 1.5 * d_jax, (k, d_port, d_jax)
            continue
        np.testing.assert_allclose(ib[k], ia[k], rtol=ROW_TOL[dt],
                                   atol=ZERO_ATOL[dt], err_msg=k)
    Da, Db = np.asarray(a.getdict()), b.getdict().numpy()
    assert Da.shape == Db.shape
    np.testing.assert_allclose(Db, Da, rtol=0,
                               atol=TOL[dt] * np.abs(Da).max())
    Za, Zb = np.asarray(a.getcoef()), b.getcoef().numpy()
    np.testing.assert_allclose(Zb, Za, rtol=0,
                               atol=TOL[dt] * max(np.abs(Za).max(), 1e-12))


def _pair(D0, S, dt, **kw):
    a = jd.ConvBPDNDictLearn(D0, S, LMBDA, max_iter=ITERS, dtype=dt, **kw)
    a.solve()
    b = td.ConvBPDNDictLearn(D0, S, LMBDA, max_iter=ITERS, dtype=dt,
                             device="cpu", **kw)
    b.solve()
    return a, b


@pytest.mark.parametrize("xmethod,dmethod,mu",
                         [("admm", "ism", 0.0), ("admm", "cg", 0.0),
                          ("admm", "cns", 0.0), ("pgm", "cns", 0.0),
                          ("admm", "cns", 0.1), ("admm", "pgm", 0.0),
                          ("pgm", "pgm", 0.0)])
def test_dictlearn_matches_jax(xmethod, dmethod, mu):
    D0, S = _problem()
    a, b = _pair(D0, S, np.float64, xmethod=xmethod, dmethod=dmethod, mu=mu)
    _compare(a, b, np.float64)
    assert b.xstep._fused_solve is None       # float64: generic paths
    if mu > 0:
        assert "XRegGrad" in b.getitstat()


def test_dictlearn_multiscale_dsz_matches_jax():
    rng = np.random.default_rng(1)
    D0 = rng.standard_normal((5, 5, 5))
    S = rng.standard_normal((16, 16, 3))
    dsz = ((3, 3, 2), (5, 5, 3))
    a, b = _pair(D0, S, np.float64, dsz=dsz, zero_mean=True)
    _compare(a, b, np.float64)
    D = b.getdict().numpy()
    assert np.all(D[3:, :, :2] == 0) and np.all(D[:, 3:, :2] == 0)


def test_dictlearn_fused_xstep_float32_matches_jax_fused_driver():
    """At (N, Nd, M, K) = (32, 5, 8, 4) both packages take their fused
    ADMM driver for the x-step, one iteration a solve: the port's runs
    csc_iter's plain version, the JAX one its Pallas kernel (interpret)."""
    D0, S = _problem(N=32, Nd=5, M=8, K=4, seed=2)
    D0, S = D0.astype(np.float32), S.astype(np.float32)
    prev = pki.interpret
    pki.interpret = True
    try:
        a = jd.ConvBPDNDictLearn(D0, S, LMBDA, max_iter=ITERS,
                                 dtype=np.float32)
        a.solve()
    finally:
        pki.interpret = prev
    b = td.ConvBPDNDictLearn(D0, S, LMBDA, max_iter=ITERS,
                             dtype=np.float32, device="cpu")
    assert b.xstep._fused_solve is tfc.cbpdn_solve
    b.solve()
    c = jd.ConvBPDNDictLearn(D0, S, LMBDA, max_iter=ITERS,
                             dtype=np.float64)
    c.solve()
    _compare(a, b, np.float32, ref64=c)


def test_dictlearn_setdict_rebuilds_the_fused_weights():
    """The fused x-step derives its weights from D at every solve: after
    setdict the next solve equals a fresh model's first iteration from
    the same state with the new dictionary."""
    from sporco_tpu_torch.models import cbpdn as tcb
    D0, S = _problem(N=32, Nd=5, M=8, K=2, seed=3)
    D0, S = D0.astype(np.float32), S.astype(np.float32)
    D1 = np.random.default_rng(4).standard_normal(D0.shape).astype(
        np.float32)
    opt = tcb.ConvBPDN.options(max_iter=1, rel_stop_tol=0.0)
    a = tcb.ConvBPDN(D0, S, LMBDA, opt=opt, device="cpu")
    a.solve()
    a.setdict(D1)
    b = tcb.ConvBPDN(D1, S, LMBDA, opt=opt, device="cpu")
    b.state = a.state
    assert a._fused_solve is tcb.fused_csc.cbpdn_solve
    a.solve()
    b.solve()
    assert torch.equal(a.getcoef(), b.getcoef())
    assert torch.equal(a.state.U, b.state.U)


def test_ref_dl_opt_matches_jax():
    opt = {"MaxMainIter": 3, "DictSize": (4, 4, 4), "Verbose": True,
           "CBPDN": {"MaxMainIter": 9, "rho": 2.0, "GradWeight": 0.5},
           "CCMOD": {"ZeroMean": True, ("AutoRho", "Period"): 3}}
    names = ("CBPDN", "CCMOD")
    assert td._ref_dl_opt(opt, names) == jd._ref_dl_opt(opt, names)
    for bad in ({"NoSuchKey": 1}, {"CBPDN": {}, "Extra": 2}):
        with pytest.raises(trefopts.UnknownKeyError):
            td._ref_dl_opt(bad, names)
        with pytest.raises(jrefopts.UnknownKeyError):
            jd._ref_dl_opt(bad, names)
    # the option tree drives the same run in both packages
    D0, S = _problem()
    a, b = _pair(D0, S, np.float64, opt=opt, mu=0.1)
    assert b.max_iter == 3
    assert b.dstep.cfg.zero_mean and b.dstep.opts.auto_rho.period == 3
    assert b.xstep.opts.rho == 2.0
    assert float(b.xstep.params["wgrd"]) == 0.5
    ia, ib = a.getitstat(), b.getitstat()
    np.testing.assert_allclose(ib["XObjFun"], ia["XObjFun"],
                               rtol=ROW_TOL[np.float64])
    # a model key that the coordinator cannot pass on raises in both
    with pytest.raises(trefopts.UnknownKeyError):
        td.ConvBPDNDictLearn(D0, S, LMBDA, opt={"CBPDN": {"L1Weight": 2.0}},
                             device="cpu")
    with pytest.raises(jrefopts.UnknownKeyError):
        jd.ConvBPDNDictLearn(D0, S, LMBDA, opt={"CBPDN": {"L1Weight": 2.0}})


def test_dmethod_pgm_raises():
    """``dmethod='pgm'`` no longer raises: it builds the FISTA dictionary
    update; an unknown ``dmethod`` raises, as in the JAX package."""
    D0, S = _problem()
    d = td.ConvBPDNDictLearn(D0, S, LMBDA, dmethod="pgm", device="cpu")
    assert isinstance(d.dstep, tpgm.ConvCnstrMOD)
    with pytest.raises(ValueError, match="dmethod"):
        td.ConvBPDNDictLearn(D0, S, LMBDA, dmethod="bogus", device="cpu")


def _ccmod_problem(seed=5, N=16, Nd=4, M=4, K=3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((N, N, 1, K, M)) * (rng.random(
        (N, N, 1, K, M)) < 0.1)
    S = rng.standard_normal((N, N, K))
    D0 = rng.standard_normal((Nd, Nd, M))
    return X, S, D0, (Nd, Nd, M)


@pytest.mark.parametrize("masked", [False, True])
def test_pgm_ccmod_matches_jax(masked):
    """``pgm.ConvCnstrMOD``/``ConvCnstrMODMask`` (float64, 30 iterations,
    default L = 14 K) against the JAX package's: stats rows and the
    dictionary, at the float64 tolerances above."""
    X, S, D0, dsz = _ccmod_problem()
    kw = dict(D0=D0, zero_mean=True)
    if masked:
        kw["W"] = (np.random.default_rng(6).random(S.shape) > 0.2
                   ).astype(np.float64)
    jcls = jpgm.ConvCnstrMODMask if masked else jpgm.ConvCnstrMOD
    tcls = tpgm.ConvCnstrMODMask if masked else tpgm.ConvCnstrMOD
    opt = dict(max_iter=30, rel_stop_tol=0.0)
    a = jcls(X, S, dsz, opt=jcls.options(**opt), dtype=np.float64, **kw)
    full = np.asarray(a.solve())
    b = tcls(X, S, dsz, opt=tcls.options(**opt), dtype=np.float64,
             device="cpu", **kw)
    np.testing.assert_allclose(b.solve().numpy(), full, rtol=0,
                               atol=TOL[np.float64] * np.abs(full).max())
    Da, Db = np.asarray(a.getdict()), b.getdict().numpy()
    assert Db.shape == Da.shape == D0.shape
    np.testing.assert_allclose(Db, Da, rtol=0,
                               atol=TOL[np.float64] * np.abs(Da).max())
    ia, ib = a.getitstat(), b.getitstat()
    assert ib._names == ia._names
    for name in ia._names:
        if name == "Cnstr":
            np.testing.assert_allclose(ib.Cnstr, ia.Cnstr, rtol=0,
                                       atol=ZERO_ATOL[np.float64])
            continue
        np.testing.assert_allclose(getattr(ib, name), getattr(ia, name),
                                   rtol=ROW_TOL[np.float64],
                                   atol=ZERO_ATOL[np.float64],
                                   equal_nan=True, err_msg=name)
    nrm = np.sqrt((Db ** 2).sum(axis=(0, 1)))
    np.testing.assert_allclose(nrm, 1.0, atol=1e-8)
    # setcoef in both layouts gives the same solve
    c = tcls(None, S, dsz, opt=tcls.options(**opt), dtype=np.float64,
             device="cpu", **kw)
    c.setcoef(b.params["Z"], internal=True)
    c.solve()
    np.testing.assert_array_equal(c.getdict().numpy(), Db)
