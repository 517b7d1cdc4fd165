"""The port's masked and online convolutional dictionary learning against
the JAX package's on the same numpy problems:

- ``ConvBPDNMaskDictLearn`` over 5 outer iterations with the ADMM x-step
  (``ConvBPDNMaskDcpl``) and the ``cns``, ``ism``, ``cg`` and FISTA
  (``pgm``) dictionary updates, and the FISTA x-step (``ConvBPDNMask``)
  with ``pgm`` and ``cns``; in float64, and in float32 with the FISTA
  x-step at a geometry both packages run on their fused FISTA problem
  (the port's ``pgm_iter`` plain version against the JAX Pallas kernel
  in interpret mode);
- ``OnlineConvBPDNDictLearn`` and ``OnlineConvBPDNMaskDictLearn`` over 3
  samples (50 x-step iterations each) in float64, 10 x-step iterations
  each in float32, and the plain form at a geometry where both packages'
  x-steps take their fused ADMM driver (``csc_iter``'s plain version
  here, once an x-step iteration);
- the reference-style option dicts of both coordinators.

Tolerances: every itstat column rtol 1e-6 and D and Z within 1e-8 of
their scale in float64 (the columns come from float32 stats rows in both
packages); in float32 rtol 1e-4 (residuals 1e-3), D and Z within 2e-4,
or, for a column or array, as close to the JAX package's float64 run as
the JAX float32 run is (within 1.5 times its distance), as
``tests/test_torch_dictlrn.py`` has it.  ``DCnstr`` (the distance of
the dictionary from the constraint set, zero up to rounding) is held
absolutely (1e-12; float32 1e-5).  The CG dictionary update solves to
1e-10 in both packages (``tests/test_torch_ccmodmd.py`` says why).
"""

import dataclasses

import numpy as np
import pytest
import torch

from sporco_tpu import refopts as jrefopts
from sporco_tpu.models import dictlrn as jd
from sporco_tpu.ops import pallas_csc_iter as pki
from sporco_tpu_torch import refopts as trefopts
from sporco_tpu_torch.models import dictlrn as td
from sporco_tpu_torch.models import pgm as tpgm
from sporco_tpu_torch.ops import csc_iter as tci
from sporco_tpu_torch.ops import fused_csc as tfc
from sporco_tpu_torch.ops import pgm_iter as tpi

torch.set_num_threads(2)

ITERS = 5
LMBDA = 0.1
TOL = {np.float64: 1e-8, np.float32: 2e-4}
ROW_TOL = {np.float64: 1e-6, np.float32: 1e-4}
RSDL_TOL = {np.float64: 1e-6, np.float32: 1e-3}
ZERO_ATOL = {np.float64: 1e-12, np.float32: 1e-5}


def _problem(N=16, Nd=4, M=4, K=3, seed=0):
    rng = np.random.default_rng(seed)
    D0 = rng.standard_normal((Nd, Nd, M))
    S = rng.standard_normal((N, N, K))
    W = (rng.random((N, N, K)) > 0.25).astype(np.float64)
    return D0, S, W


def _close(name, tv, jv, j64, dt):
    """A column within its tolerance, or as close to float64 as JAX's."""
    rsdl = name.endswith("Rsdl") or name.endswith("EPrimal") \
        or name.endswith("EDual")
    tol = RSDL_TOL[dt] if rsdl else ROW_TOL[dt]
    if np.allclose(tv, jv, rtol=tol, atol=0, equal_nan=True):
        return True
    if j64 is None:
        return False
    return np.nanmax(np.abs(tv - j64)) <= 1.5 * np.nanmax(np.abs(jv - j64))


def _array_close(tv, jv, j64, dt):
    err = np.abs(tv - jv).max()
    if err <= TOL[dt] * max(np.abs(jv).max(), 1e-12):
        return True
    return j64 is not None and np.abs(tv - j64).max() <= 1.5 * np.abs(
        jv - j64).max()


def _compare(a, b, dt, n, ref64=None, coef=True):
    ia, ib = a.getitstat(), b.getitstat()
    i64 = None if ref64 is None else ref64.getitstat()
    assert sorted(ia) == sorted(ib)
    for k in ia:
        assert len(ib[k]) == n, k
        if k.endswith("Cnstr"):
            np.testing.assert_allclose(ib[k], ia[k], rtol=0,
                                       atol=ZERO_ATOL[dt], err_msg=k)
        elif k.endswith("XSlvRelRes"):
            continue
        else:
            assert _close(k, ib[k], ia[k], None if i64 is None else i64[k],
                          dt), k
    D64 = None if ref64 is None else np.asarray(ref64.getdict())
    Da, Db = np.asarray(a.getdict()), b.getdict().numpy()
    assert Db.shape == Da.shape
    assert _array_close(Db, Da, D64, dt)
    if coef:
        Z64 = None if ref64 is None else np.asarray(ref64.getcoef())
        Za, Zb = np.asarray(a.getcoef()), b.getcoef().numpy()
        assert _array_close(Zb, Za, Z64, dt)


def _tight_cg(d):
    """The CG dictionary update at tolerance 1e-10 (either package)."""
    if d.dmethod == "cg":
        d.dstep.cfg = dataclasses.replace(d.dstep.cfg, cg_tol=1e-10)


def _mdl(pkg, D0, S, W, dt, **kw):
    if pkg == "jax":
        d = jd.ConvBPDNMaskDictLearn(D0, S, LMBDA, W=W, dtype=dt, **kw)
    else:
        d = td.ConvBPDNMaskDictLearn(D0, S, LMBDA, W=W, dtype=dt,
                                     device="cpu", **kw)
    _tight_cg(d)
    d.solve()
    return d


PAIRS = [("admm", "cns"), ("admm", "ism"), ("admm", "cg"), ("pgm", "pgm"),
         ("pgm", "cns"), ("admm", "pgm")]


@pytest.mark.parametrize("xmethod,dmethod", PAIRS)
def test_mask_dictlearn_matches_jax(xmethod, dmethod):
    D0, S, W = _problem()
    kw = dict(xmethod=xmethod, dmethod=dmethod, max_iter=ITERS)
    a = _mdl("jax", D0, S, W, np.float64, **kw)
    b = _mdl("port", D0, S, W, np.float64, **kw)
    _compare(a, b, np.float64, ITERS)
    if xmethod == "pgm":
        assert b.xstep._fused_solve is None     # float64: generic path
    D = b.getdict().numpy()
    nrm = np.sqrt((D ** 2).sum(axis=(0, 1)))
    np.testing.assert_allclose(nrm, 1.0, atol=1e-8)


@pytest.mark.parametrize("xmethod,dmethod", [("admm", "cns"),
                                             ("pgm", "pgm")])
def test_mask_dictlearn_float32_matches_jax(xmethod, dmethod):
    """float32 at (N, Nd, M, K) = (32, 5, 8, 4): the FISTA x-step takes
    both packages' fused FISTA problem (the port's ``pgm_iter`` plain
    version, once an outer iteration; the JAX Pallas kernel in
    interpret mode); the ADMM x-step is the generic two-block problem in
    both."""
    D0, S, W = _problem(N=32, Nd=5, M=8, K=4, seed=2)
    D0, S, W = (a.astype(np.float32) for a in (D0, S, W))
    kw = dict(xmethod=xmethod, dmethod=dmethod, max_iter=ITERS)
    prev = pki.interpret
    pki.interpret = True
    try:
        a = _mdl("jax", D0, S, W, np.float32, **kw)
    finally:
        pki.interpret = prev
    calls = []
    plain = tpi.pgm_iter_plain
    tpi.pgm_iter_plain = lambda *x, **k: calls.append(1) or plain(*x, **k)
    try:
        b = _mdl("port", D0, S, W, np.float32, **kw)
    finally:
        tpi.pgm_iter_plain = plain
    if xmethod == "pgm":
        assert b.xstep._fused_solve is tfc.pgm_cbpdn_solve
        assert len(calls) == ITERS
    c = _mdl("jax", D0, S, W, np.float64, **kw)
    _compare(a, b, np.float32, ITERS, ref64=c)


@pytest.mark.parametrize("xmethod,dmethod", [("admm", "cns"),
                                             ("pgm", "pgm")])
def test_mask_dictlearn_long_run_matches_jax(xmethod, dmethod):
    """50 outer iterations in float64 on 2 signals of 32x32: both packages
    agree in every column (rtol 1e-6), through what the learner does
    there: (admm, cns)'s d-step rho grows by more than 1e20 (AutoRho
    scales it up every outer iteration), and (pgm, pgm)'s x-step
    objective ends above its least value and its first."""
    D0, S, W = _problem(N=32, K=2)
    kw = dict(xmethod=xmethod, dmethod=dmethod, max_iter=50)
    a = _mdl("jax", D0, S, W, np.float64, **kw)
    b = _mdl("port", D0, S, W, np.float64, **kw)
    _compare(a, b, np.float64, 50)
    its = b.getitstat()
    if dmethod == "cns":
        assert its["DRho"][-1] > 1e20 * its["DRho"][0]
    else:
        obj = its["XObjFun"]
        assert obj[-1] > obj[0] > obj.min()


def test_mask_dictlearn_warm_start_and_handover():
    """The d-step starts from the padded, projected D0 in its dictionary
    block (``cns``: ``Y[0]``; ``ism``/``cg``: ``Y[1]``), and the ADMM
    x-step's coefficient block ``Y1`` is what the d-step receives."""
    D0, S, W = _problem()
    for dmethod, blk in (("cns", 0), ("ism", 1)):
        d = td.ConvBPDNMaskDictLearn(D0, S, LMBDA, W=W, dmethod=dmethod,
                                     max_iter=1, device="cpu")
        a = jd.ConvBPDNMaskDictLearn(D0, S, LMBDA, W=W, dmethod=dmethod,
                                     max_iter=1)
        np.testing.assert_allclose(d.dstep.state.Y[blk].numpy(),
                                   np.asarray(a.dstep.state.Y[blk]),
                                   rtol=0, atol=1e-12)
        d.xstep.solve()
        d.post_xstep()
        assert torch.equal(d.dstep.params["Z"], d.xstep.state.Y[1])


def test_mask_dictlearn_options_match_jax():
    """A reference-style option tree runs the same solve in both
    packages; an unknown key raises in both; an unknown method raises."""
    opt = {"MaxMainIter": 3, "Verbose": True,
           "CBPDN": {"rho": 2.0, "RelaxParam": 1.6},
           "CCMOD": {"ZeroMean": True, ("AutoRho", "Period"): 3}}
    D0, S, W = _problem()
    a = _mdl("jax", D0, S, W, np.float64, opt=opt)
    b = _mdl("port", D0, S, W, np.float64, opt=opt)
    assert b.max_iter == 3 and b.xstep.opts.rho == 2.0
    assert b.dstep.cfg.zero_mean and b.dstep.opts.auto_rho.period == 3
    _compare(a, b, np.float64, 3)
    with pytest.raises(trefopts.UnknownKeyError):
        td.ConvBPDNMaskDictLearn(D0, S, LMBDA, W=W, opt={"Bogus": 1},
                                 device="cpu")
    with pytest.raises(jrefopts.UnknownKeyError):
        jd.ConvBPDNMaskDictLearn(D0, S, LMBDA, W=W, opt={"Bogus": 1})
    with pytest.raises(ValueError, match="dmethod"):
        td.ConvBPDNMaskDictLearn(D0, S, LMBDA, dmethod="bogus",
                                 device="cpu")


# ---------------------------------------------------------------------------
# Online CDL

SAMPLES = 3


def _samples(N=16, seed=5, count=SAMPLES):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((N, N)),
             (rng.random((N, N)) > 0.25).astype(np.float64))
            for _ in range(count)]


def _online(pkg, cls, D0, samples, dt, **kw):
    if pkg == "jax":
        d = getattr(jd, cls)(D0, LMBDA, dtype=dt, **kw)
    else:
        d = getattr(td, cls)(D0, LMBDA, dtype=dt, device="cpu", **kw)
    for S, W in samples:
        S = S.astype(dt)
        if cls.startswith("OnlineConvBPDNMask"):
            d.solve(S, W=W.astype(dt))
        else:
            d.solve(S)
    return d


ONLINE = ["OnlineConvBPDNDictLearn", "OnlineConvBPDNMaskDictLearn"]


@pytest.mark.parametrize("cls", ONLINE)
def test_online_float64_matches_jax(cls):
    D0, _, _ = _problem()
    smp = _samples()
    a = _online("jax", cls, D0, smp, np.float64)
    b = _online("port", cls, D0, smp, np.float64)
    _compare(a, b, np.float64, SAMPLES, coef=False)
    its = b.getitstat()
    assert sorted(its) == sorted(a.getitstat())
    np.testing.assert_array_equal(its["Iter"], np.arange(SAMPLES))
    np.testing.assert_allclose(its["Eta"], 10.0 / (np.arange(SAMPLES)
                                                   + 5.0), rtol=1e-15)
    assert np.all(np.diff(its["Eta"]) < 0)
    D = b.getdict().numpy()
    np.testing.assert_allclose(np.sqrt((D ** 2).sum(axis=(0, 1))), 1.0,
                               atol=1e-12)


@pytest.mark.parametrize("cls", ONLINE)
def test_online_float32_iterations_match_jax(cls):
    """10 x-step iterations a sample, float32."""
    D0, _, _ = _problem()
    smp = _samples()
    cbo = {"cbpdn_opt": None}
    out = []
    for pkg, dt in (("jax", np.float32), ("port", np.float32),
                    ("jax", np.float64)):
        mod = jd if pkg == "jax" else td
        xcls = (mod._cbpdn.ConvBPDNMaskDcpl if "Mask" in cls
                else mod._cbpdn.ConvBPDN)
        cbo["cbpdn_opt"] = xcls.options(max_iter=10)
        out.append(_online(pkg, cls, D0, smp, dt, **cbo))
    a, b, c = out
    _compare(a, b, np.float32, SAMPLES, ref64=c, coef=False)


def test_online_fused_xstep_matches_jax_fused_driver():
    """At (N, Nd, M) = (32, 5, 8) in float32 both packages' x-steps take
    their fused ADMM driver: the port's runs ``csc_iter``'s plain version
    once an iteration, so its calls are the x-steps' iterations summed
    (the count ``chip_smoke.py`` holds the card's launches to); the JAX
    driver runs its Pallas kernel in interpret mode."""
    rng = np.random.default_rng(6)
    D0 = rng.standard_normal((5, 5, 8)).astype(np.float32)
    smp = [(rng.standard_normal((32, 32)).astype(np.float32), None)
           for _ in range(2)]
    prev = pki.interpret
    pki.interpret = True
    try:
        a = _online("jax", "OnlineConvBPDNDictLearn", D0, smp, np.float32)
    finally:
        pki.interpret = prev
    calls, iters = [], []
    plain = tci.csc_iter_plain
    tci.csc_iter_plain = lambda *x, **k: calls.append(1) or plain(*x, **k)
    try:
        b = td.OnlineConvBPDNDictLearn(D0, LMBDA, dtype=np.float32,
                                       device="cpu")
        for S, _ in smp:
            b.solve(S)
            assert b.xstep._fused_solve is tfc.cbpdn_solve
            iters.append(int(b.xstep.state.k))
    finally:
        tci.csc_iter_plain = plain
    c = _online("jax", "OnlineConvBPDNDictLearn", D0, smp, np.float64)
    _compare(a, b, np.float32, 2, ref64=c, coef=False)
    assert len(calls) == sum(iters) > 0


def test_online_options_match_jax():
    """The option dict drops ``Verbose``, ``StatusHeader``, ``IterTimer``
    and ``CUDA_CBPDN``, warns on ``DictSize``, takes ``eta_a``, ``eta_b``,
    ``ZeroMean``, ``DataType`` and the ``CBPDN`` subtree, and raises on
    anything else, in both packages."""
    D0, _, _ = _problem()
    opt = {"Verbose": True, "StatusHeader": False, "IterTimer": "x",
           "CUDA_CBPDN": False, "eta_a": 4.0, "eta_b": 2.0,
           "ZeroMean": True, "DataType": np.float64,
           "CBPDN": {"MaxMainIter": 7, "rho": 3.0}}
    a = jd.OnlineConvBPDNDictLearn(D0, LMBDA, opt=opt)
    b = td.OnlineConvBPDNDictLearn(D0, LMBDA, opt=opt, device="cpu")
    assert (b.eta_a, b.eta_b, b.zero_mean) == (a.eta_a, a.eta_b,
                                              a.zero_mean) == (4.0, 2.0,
                                                               True)
    assert b.dtype == torch.float64
    assert b.cbpdn_opt.max_iter == a.cbpdn_opt.max_iter == 7
    assert b.cbpdn_opt.rho == 3.0
    smp = _samples(count=2)
    for d in (a, b):
        for S, _ in smp:
            d.solve(S)
    ia, ib = a.getitstat(), b.getitstat()
    np.testing.assert_allclose(ib["XObjFun"], ia["XObjFun"], rtol=1e-6)
    np.testing.assert_allclose(ib["Eta"], 4.0 / (np.arange(2) + 2.0))
    with pytest.warns(UserWarning, match="DictSize"):
        td.OnlineConvBPDNMaskDictLearn(D0, LMBDA, opt={"DictSize": (4, 4)},
                                       device="cpu")
    with pytest.raises(trefopts.UnknownKeyError):
        td.OnlineConvBPDNDictLearn(D0, LMBDA, opt={"Bogus": 1},
                                   device="cpu")
    with pytest.raises(jrefopts.UnknownKeyError):
        jd.OnlineConvBPDNDictLearn(D0, LMBDA, opt={"Bogus": 1})


def test_card_default():
    """Without ``device`` the coordinators run on the card and raise where
    there is none."""
    D0, S, W = _problem()
    if not torch.cuda.is_available():
        for make in (lambda: td.ConvBPDNMaskDictLearn(D0, S, LMBDA, W=W),
                     lambda: td.OnlineConvBPDNDictLearn(D0, LMBDA),
                     lambda: td.OnlineConvBPDNMaskDictLearn(D0, LMBDA)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
    d = td.ConvBPDNMaskDictLearn(D0, S, LMBDA, W=W, dmethod="pgm",
                                 max_iter=1, device="cpu")
    assert isinstance(d.dstep, tpgm.ConvCnstrMODMask)
