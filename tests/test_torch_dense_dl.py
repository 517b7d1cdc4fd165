"""The port's dictionary learning on vectors against the JAX package's on
the same seeded numpy problems: the ADMM ``cmod.CnstrMOD``, the FISTA
models ``pgm.BPDN``, ``WeightedBPDN``, ``CnstrMOD`` and
``WeightedCnstrMOD``, and the learners ``BPDNDictLearn`` and
``WeightedBPDNDictLearn``.

Tolerances (those of ``tests/test_torch_bpdn.py``): float64 solves to
1e-3 with the same iteration count, every stats row rtol 1e-6 and X or D
within 1e-8 of its scale; float32 over 10 iterations the rows rtol 1e-4
(the residuals 1e-3) and X or D within 2e-4; float32 solves to 1e-3
with the iteration count within one and the last objective rtol 1e-3.
``Cnstr`` (the distance from the constraint set, zero up to rounding)
is held absolutely (1e-12; float32 1e-5).

Where the JAX package draws ``D0`` from ``PRNGKey(0)`` (``D0=None``),
the port draws from a ``torch.Generator`` seeded 0; the comparisons pass
the JAX draw in.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sporco_tpu import refopts as jrefopts
from sporco_tpu.models import cmod as jcm
from sporco_tpu.models import dictlrn as jd
from sporco_tpu.models import pgm as jp
from sporco_tpu_torch import refopts as trefopts
from sporco_tpu_torch.models import cmod as tcm
from sporco_tpu_torch.models import dictlrn as td
from sporco_tpu_torch.models import pgm as tp

torch.set_num_threads(2)

N, M, K = 16, 24, 40
LMBDA = 0.1
RSDL = ("PrimalRsdl", "DualRsdl", "Rsdl")
ZERO_ATOL = {"float64": 1e-12, "float32": 1e-5}


def _problem(seed=0, n=N, m=M, k=K):
    """A sparse code (about 20% nonzero) over a random (n, m) dictionary,
    noise at 0.01, and a positive weight of the data term."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((n, m))
    X0 = rng.standard_normal((m, k)) * (rng.random((m, k)) < 0.2)
    S = D @ X0 + 0.01 * rng.standard_normal((n, k))
    W = rng.uniform(0.5, 1.5, (n, k))
    D0 = rng.standard_normal((n, m))
    return D, X0, S, W, D0


def _rows(a, b, dt, rtol, rsdl_rtol, n=None):
    ja, ta = a.getitstat(), b.getitstat()
    assert ta._names == ja._names
    n = len(ja) if n is None else n
    assert len(ta) == n
    for name in ja._names:
        tv, jv = getattr(ta, name)[:n], getattr(ja, name)[:n]
        if name == "Cnstr":
            np.testing.assert_allclose(tv, jv, rtol=0, atol=ZERO_ATOL[dt])
        else:
            np.testing.assert_allclose(
                tv, jv, rtol=rsdl_rtol if name in RSDL else rtol,
                equal_nan=True, err_msg=name)


def _close(t, j, rel):
    j = np.asarray(j)
    t = t.numpy()
    assert t.shape == j.shape and t.dtype == j.dtype
    assert np.abs(t - j).max() <= rel * max(np.abs(j).max(), 1e-30)


# name -> (JAX maker, port maker, the array compared) of each model with
# a default tolerance; each maker takes (dtype, opt keywords, extra)
def _models(D, X0, S, W, D0):
    def bp(mod, cls, **kw):
        return lambda dt, o, **x: getattr(mod, cls)(
            D, S, LMBDA, opt=getattr(mod, cls).options(**o), dtype=dt,
            **kw, **x)

    def cm(mod, cls, **kw):
        return lambda dt, o, **x: getattr(mod, cls)(
            X0, S, opt=getattr(mod, cls).options(**o), D0=D0, dtype=dt,
            **kw, **x)
    return {
        "pgm.BPDN": (bp(jp, "BPDN"), bp(tp, "BPDN"), "getcoef"),
        "pgm.WeightedBPDN": (bp(jp, "WeightedBPDN", W=W),
                             bp(tp, "WeightedBPDN", W=W), "getcoef"),
        "pgm.CnstrMOD": (cm(jp, "CnstrMOD"), cm(tp, "CnstrMOD"),
                         "getdict"),
        "pgm.WeightedCnstrMOD": (cm(jp, "WeightedCnstrMOD", W=W),
                                 cm(tp, "WeightedCnstrMOD", W=W),
                                 "getdict"),
        "cmod.CnstrMOD": (cm(jcm, "CnstrMOD"), cm(tcm, "CnstrMOD"),
                          "getdict"),
        "cmod.CnstrMOD zero_mean": (cm(jcm, "CnstrMOD", zero_mean=True),
                                    cm(tcm, "CnstrMOD", zero_mean=True),
                                    "getdict"),
    }


NAMES = list(_models(*_problem()))


def _pair(name, dt, **opt):
    jmk, tmk, arr = _models(*_problem())[name]
    a = jmk(dt, opt)
    a.solve()
    b = tmk(dt, opt, device="cpu")
    b.solve()
    return a, b, arr


@pytest.mark.parametrize("name", NAMES)
def test_float64_solve_matches_jax(name):
    a, b, arr = _pair(name, "float64", max_iter=500, rel_stop_tol=1e-3)
    assert len(a.getitstat()) == len(b.getitstat()) < 500
    _rows(a, b, "float64", 1e-6, 1e-6)
    _close(getattr(b, arr)(), getattr(a, arr)(), 1e-8)


@pytest.mark.parametrize("name", NAMES)
def test_float32_iterations_match_jax(name):
    a, b, arr = _pair(name, "float32", max_iter=10, rel_stop_tol=0.0)
    _rows(a, b, "float32", 1e-4, 1e-3, n=10)
    _close(getattr(b, arr)(), getattr(a, arr)(), 2e-4)


@pytest.mark.parametrize("name", NAMES)
def test_float32_solve_matches_jax(name):
    a, b, arr = _pair(name, "float32", max_iter=500, rel_stop_tol=1e-3)
    ja, ta = a.getitstat(), b.getitstat()
    assert abs(len(ja) - len(ta)) <= 1 and len(ta) < 500
    first = ja._names[1]
    np.testing.assert_allclose(getattr(ta, first)[-1],
                               getattr(ja, first)[-1], rtol=1e-3)


@pytest.mark.parametrize("kw", [{"non_neg": True}, {"lmbda": None},
                                {"wl1": "array"}, {"vector": True}],
                         ids=["non_neg", "default_lmbda", "wl1", "vector"])
def test_pgm_bpdn_options_match_jax(kw):
    """NonNegCoef, the default lmbda (``0.1 max|D^T S|``), an L1Weight
    array and a vector signal, float64, 100 iterations."""
    D, _, S, _, _ = _problem()
    kw = dict(kw)
    lmbda = kw.pop("lmbda", LMBDA)
    if kw.pop("wl1", None):
        kw["wl1"] = np.random.default_rng(3).uniform(0.5, 1.5, (M, 1))
    if kw.pop("vector", False):
        S = S[:, 0]
    opt = dict(max_iter=100, rel_stop_tol=0.0)
    a = jp.BPDN(D, S, lmbda, opt=jp.BPDN.options(**opt), dtype="float64",
                **kw)
    a.solve()
    b = tp.BPDN(D, S, lmbda, opt=tp.BPDN.options(**opt), dtype="float64",
                device="cpu", **kw)
    b.solve()
    assert b.lmbda == pytest.approx(a.lmbda, rel=1e-12)
    _rows(a, b, "float64", 1e-6, 1e-6)
    _close(b.getcoef(), a.getcoef(), 1e-8)
    _close(b.reconstruct(), a.reconstruct(), 1e-8)
    if kw.get("non_neg"):
        assert float(b.getcoef().min()) >= 0.0


def test_cmod_defaults_and_setcoef():
    """The default rho ``K / 500`` and AutoRho (Period 10); ``setcoef``
    makes the Gram factor anew (the same solve as a fresh model); the
    default ``D0`` is the port's own seeded draw with unit columns, and
    the JAX draw passed as ``D0`` gives the JAX solve."""
    D, X0, S, _, _ = _problem()
    b = tcm.CnstrMOD(X0, S, device="cpu", dtype="float64")
    assert float(b.state.rho) == pytest.approx(K / 500.0)
    assert b.opts.auto_rho.enabled and b.opts.auto_rho.period == 10
    D0 = b.params["D0"]
    np.testing.assert_allclose(torch.sqrt((D0 ** 2).sum(0)).numpy(), 1.0,
                               atol=1e-12)
    c = tcm.CnstrMOD(X0, S, device="cpu", dtype="float64")
    assert torch.equal(c.params["D0"], D0)
    jdraw = np.asarray(jcm.normalise(jax.random.normal(
        jax.random.PRNGKey(0), (N, M), jnp.float64)))
    a = jcm.CnstrMOD(X0, S, dtype="float64")
    np.testing.assert_allclose(np.asarray(a.params["D0"]), jdraw)
    opt = tcm.CnstrMOD.options(max_iter=20, rel_stop_tol=0.0)
    a = jcm.CnstrMOD(X0, S, dtype="float64", opt=jcm.CnstrMOD.options(
        max_iter=20, rel_stop_tol=0.0))
    a.solve()
    b = tcm.CnstrMOD(X0, S, D0=jdraw, dtype="float64", device="cpu",
                     opt=opt)
    b.solve()
    _rows(a, b, "float64", 1e-6, 1e-6)
    Z1 = X0 * 0.5
    d = tcm.CnstrMOD(np.zeros_like(X0), S, D0=jdraw, dtype="float64",
                     device="cpu", opt=opt)
    d.setcoef(torch.as_tensor(Z1))
    d.solve()
    e = tcm.CnstrMOD(Z1, S, D0=jdraw, dtype="float64", device="cpu",
                     opt=opt)
    e.solve()
    assert torch.equal(d.getdict(), e.getdict())
    p = tp.CnstrMOD(X0, S, device="cpu", dtype="float64")
    np.testing.assert_allclose(torch.sqrt((p.state.X ** 2).sum(0))
                               .numpy(), 1.0, atol=1e-12)


ITERS = 10


@pytest.mark.parametrize("dt", ["float64", "float32"])
@pytest.mark.parametrize("cls", ["BPDNDictLearn", "WeightedBPDNDictLearn"])
def test_dictlearn_matches_jax(cls, dt):
    """10 outer iterations; every column (``DCnstr`` absolutely) and the
    dictionary."""
    D, _, S, W, D0 = _problem()
    kw = {"W": W} if cls.startswith("Weighted") else {}
    a = getattr(jd, cls)(D0, S, LMBDA, max_iter=ITERS, dtype=dt, **kw)
    a.solve()
    b = getattr(td, cls)(D0, S, LMBDA, max_iter=ITERS, dtype=dt,
                         device="cpu", **kw)
    b.solve()
    ia, ib = a.getitstat(), b.getitstat()
    assert sorted(ia) == sorted(ib)
    rtol = {"float64": 1e-6, "float32": 1e-4}[dt]
    for k in ia:
        assert len(ib[k]) == ITERS
        if k.endswith("Cnstr"):
            np.testing.assert_allclose(ib[k], ia[k], rtol=0,
                                       atol=ZERO_ATOL[dt], err_msg=k)
        else:
            tol = 10 * rtol if k.endswith("Rsdl") else rtol
            np.testing.assert_allclose(ib[k], ia[k], rtol=tol,
                                       equal_nan=True, err_msg=k)
    _close(b.getdict(), a.getdict(), {"float64": 1e-8,
                                      "float32": 2e-4}[dt])
    Db = b.getdict().numpy()
    np.testing.assert_allclose(np.sqrt((Db.astype(np.float64) ** 2)
                                       .sum(0)), 1.0, atol=1e-5)
    assert b.getdict().dtype == {"float64": torch.float64,
                                 "float32": torch.float32}[dt]


def test_bpdn_dictlearn_hands_over_the_gram_factor():
    """After each d-step the x-step's D and its Gram factor are the
    dictionary's: the next x-step equals a fresh BPDN's on that D."""
    D, _, S, _, D0 = _problem()
    b = td.BPDNDictLearn(D0, S, LMBDA, max_iter=2, device="cpu")
    b.solve()
    Dd = b.dstep.getdict()
    assert torch.equal(b.xstep.params["D"], Dd)
    f = b.xstep.params["factor"]
    G = Dd @ Dd.T if not f.of_ata else Dd.T @ Dd
    np.testing.assert_allclose(
        (f.evecs @ torch.diag(f.evals) @ f.evecs.T).numpy(), G.numpy(),
        atol=1e-10)


def test_bpdn_dictlearn_options_match_jax():
    """A reference-style option tree (``BPDN``/``CMOD`` subtrees) gives
    the same run; an unknown key raises in both."""
    D, _, S, _, D0 = _problem()
    opt = {"MaxMainIter": 4, "BPDN": {"rho": 2.0},
           "CMOD": {"RelaxParam": 1.5, ("AutoRho", "Period"): 3}}
    a = jd.BPDNDictLearn(D0, S, LMBDA, opt=opt)
    a.solve()
    b = td.BPDNDictLearn(D0, S, LMBDA, opt=opt, device="cpu")
    b.solve()
    assert b.max_iter == 4 and b.xstep.opts.rho == 2.0
    assert (b.dstep.opts.relax_param, b.dstep.opts.auto_rho.period) == (
        1.5, 3)
    np.testing.assert_allclose(b.getitstat()["XObjFun"],
                               a.getitstat()["XObjFun"], rtol=1e-6)
    # an unknown key, and a model key the coordinator cannot pass on
    for bad in ({"Bogus": 1}, {"CMOD": {"ZeroMean": True}}):
        with pytest.raises(trefopts.UnknownKeyError):
            td.BPDNDictLearn(D0, S, LMBDA, opt=bad, device="cpu")
        with pytest.raises(jrefopts.UnknownKeyError):
            jd.BPDNDictLearn(D0, S, LMBDA, opt=bad)


def test_card_default_and_tensors():
    """Without ``device`` the models raise where there is no card;
    tensors are taken as numpy arrays are."""
    D, X0, S, W, D0 = _problem()
    b = tp.BPDN(torch.as_tensor(D), torch.as_tensor(S), LMBDA,
                device="cpu", dtype="float64")
    c = tp.BPDN(D, S, LMBDA, device="cpu", dtype="float64")
    assert torch.equal(b.params["D"], c.params["D"])
    if not torch.cuda.is_available():
        for make in (lambda: tp.BPDN(D, S, LMBDA),
                     lambda: tp.CnstrMOD(X0, S),
                     lambda: tcm.CnstrMOD(X0, S),
                     lambda: td.BPDNDictLearn(D0, S, LMBDA),
                     lambda: td.WeightedBPDNDictLearn(D0, S, LMBDA, W=W)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                make()
