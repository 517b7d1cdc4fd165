"""The port's ``models.bpdn`` (``BPDN``, ``BPDNJoint``, ``ElasticNet``,
``BPDNProjL1``, ``MinL1InL2Ball``) on the CPU against the JAX package's
on the same seeded numpy problems: a sparse code of a few dozen atoms,
a wide and a tall dictionary.

Tolerances:

- float64, solved to 1e-3: the same iteration count, every stats row to
  rtol 1e-6 (the rows are float32 in both packages; they agree to the
  bit in practice) and X and Y within 1e-8 of their scale;
- float32, 10 iterations: ObjFun, DFid, Reg*, Rho rows to rtol 1e-4, the
  residuals to rtol 1e-3, X and Y within 2e-4 of their scale (PERF.md
  §2);
- float32, solved to 1e-3: the iteration count within one, X within
  2e-4 of its scale and the last objective to rtol 1e-3.  Over a whole
  float32 run the rows are not held at 1e-4: the JAX package against
  itself, with S moved by one ulp, parts by up to 9e-4 in DFid and
  3e-4 in Rho on ``_problem()`` (AutoRho's scaling follows the residual
  ratio, which carries float32 rounding).

``Cnstr`` (the distance of Y from its constraint set, zero up to
rounding) is held absolutely, to 1e-5 of the scale of S in float32 and
1e-10 in float64.
"""

import jax
import numpy as np
import pytest
import torch

from sporco_tpu.models import bpdn as jb
from sporco_tpu_torch.models import bpdn as tb

torch.set_num_threads(2)

# name -> constructor arguments beside D and S
CASES = {
    "BPDN": {"lmbda": 1e-2},
    "BPDNJoint": {"lmbda": 1e-2, "mu": 0.05},
    "ElasticNet": {"lmbda": 1e-2, "mu": 0.05},
    "BPDNProjL1": {"gamma": 2.0},
    "MinL1InL2Ball": {"epsilon": 0.05},
}
RSDL = ("PrimalRsdl", "DualRsdl")


def _problem(N=32, M=48, K=3, seed=0):
    """A sparse code of ``K`` signals over a random (N, M) dictionary,
    4 nonzeros each, with noise at 0.01."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((N, M)).astype(np.float32)
    x0 = np.zeros((M, K), np.float32)
    for k in range(K):
        x0[rng.choice(M, 4, replace=False), k] = rng.standard_normal(4)
    S = (D @ x0 + 0.01 * rng.standard_normal((N, K))).astype(np.float32)
    return D, S


def _make(name, pkg, D, S, dtype, max_iter, tol, **kw):
    kw = {**CASES[name], **kw}
    cls = getattr(jb if pkg == "jax" else tb, name)
    if pkg == "port":
        kw["device"] = "cpu"
    return cls(D, S, opt=cls.options(max_iter=max_iter, rel_stop_tol=tol),
               dtype=dtype, **kw)


def _solve(name, D, S, dtype, max_iter, tol, **kw):
    a = _make(name, "jax", D, S, dtype, max_iter, tol, **kw)
    a.solve()
    b = _make(name, "port", D, S, dtype, max_iter, tol, **kw)
    b.solve()
    return a, b


def _y(model):
    Y = model.state.Y
    return Y if isinstance(Y, tuple) else (Y,)


def _assert_states(a, b, rel):
    for ja, ta in zip((a.state.X,) + _y(a), (b.state.X,) + _y(b)):
        ja, ta = np.asarray(ja), ta.numpy()
        assert ta.shape == ja.shape and ta.dtype == ja.dtype
        assert np.abs(ta - ja).max() <= rel * max(np.abs(ja).max(), 1e-30)


def _assert_rows(a, b, S, rtol, rsdl_rtol, cnstr_atol, n=None):
    ja, ta = a.getitstat(), b.getitstat()
    n = len(ja) if n is None else n
    assert ta._names == ja._names
    for name in ja._names:
        jv, tv = getattr(ja, name)[:n], getattr(ta, name)[:n]
        if name == "Cnstr":
            np.testing.assert_allclose(tv, jv, rtol=0, err_msg=name,
                                       atol=cnstr_atol * np.abs(S).max())
        else:
            np.testing.assert_allclose(
                tv, jv, err_msg=name,
                rtol=rsdl_rtol if name in RSDL else rtol)


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("shape", [(32, 48), (48, 32)],
                         ids=["wide", "tall"])
def test_float64_solve_matches_jax(name, shape):
    D, S = _problem(*shape)
    a, b = _solve(name, D, S, "float64", 300, 1e-3)
    assert len(a.getitstat()) == len(b.getitstat()) < 300
    _assert_rows(a, b, S, 1e-6, 1e-6, 1e-10)
    _assert_states(a, b, 1e-8)


@pytest.mark.parametrize("name", list(CASES))
def test_float32_iterations_match_jax(name):
    D, S = _problem()
    a, b = _solve(name, D, S, "float32", 10, 0.0)
    assert len(a.getitstat()) == len(b.getitstat()) == 10
    _assert_rows(a, b, S, 1e-4, 1e-3, 1e-5)
    _assert_states(a, b, 2e-4)


@pytest.mark.parametrize("name", list(CASES))
def test_float32_solve_matches_jax(name):
    D, S = _problem()
    a, b = _solve(name, D, S, "float32", 300, 1e-3)
    ja, ta = a.getitstat(), b.getitstat()
    assert abs(len(ja) - len(ta)) <= 1 and len(ta) < 300
    first = ja._names[1]
    np.testing.assert_allclose(getattr(ta, first)[-1],
                               getattr(ja, first)[-1], rtol=1e-3)
    jX, tX = np.asarray(a.getmin()), b.getmin().numpy()
    assert np.abs(tX - jX).max() <= 2e-4 * np.abs(jX).max()


@pytest.mark.parametrize("kw", [{"non_neg": True}, {"lmbda": None},
                                {"wl1": "array"}, {"obj_from_y": False}],
                         ids=["non_neg", "default_lmbda", "wl1",
                              "obj_from_x"])
def test_bpdn_options_match_jax(kw):
    """NonNegCoef, the default lmbda and rho, an L1Weight array and
    AuxVarObj off, in float64."""
    D, S = _problem()
    if kw.get("wl1") == "array":
        kw = {"wl1": np.random.default_rng(3).uniform(
            0.5, 1.5, (48, 1)).astype(np.float32)}
    a, b = _solve("BPDN", D, S, "float64", 300, 1e-3, **kw)
    assert b.lmbda == pytest.approx(a.lmbda, rel=1e-12)
    assert float(b.state.rho) > 0
    _assert_rows(a, b, S, 1e-6, 1e-6, 1e-10)
    _assert_states(a, b, 1e-8)
    if kw.get("non_neg"):
        assert float(b.getmin().min()) >= 0.0


@pytest.mark.parametrize("name", ["BPDN", "MinL1InL2Ball"])
def test_minl1_non_neg_and_vector_signal(name):
    """A 1-D S is one signal (N, 1), in both packages; NonNegCoef."""
    D, S = _problem(K=1)
    a, b = _solve(name, D, S[:, 0], "float64", 300, 1e-3, non_neg=True)
    assert tuple(b.getmin().shape) == (48, 1)
    _assert_rows(a, b, S, 1e-6, 1e-6, 1e-10)
    _assert_states(a, b, 1e-8)


def test_fast_solve_matches_jax():
    """FastSolve: no objective rows (NaN in both), the same residuals."""
    D, S = _problem()
    kw = {"lmbda": 1e-2}
    a = jb.BPDN(D, S, opt=jb.BPDN.options(max_iter=300, fast_solve=True),
                dtype="float64", **kw)
    a.solve()
    b = tb.BPDN(D, S, opt=tb.BPDN.options(max_iter=300, fast_solve=True),
                dtype="float64", device="cpu", **kw)
    b.solve()
    ja, ta = a.getitstat(), b.getitstat()
    assert len(ja) == len(ta)
    assert np.isnan(ta.ObjFun).all() and np.isnan(ja.ObjFun).all()
    for name in RSDL + ("Rho",):
        np.testing.assert_allclose(getattr(ta, name), getattr(ja, name),
                                   rtol=1e-6)
    _assert_states(a, b, 1e-8)


@pytest.mark.parametrize("name", ["BPDN", "MinL1InL2Ball"])
def test_reference_option_dict_matches_jax(name):
    """A reference-style option dict: solver keys, an AutoRho sub-dict,
    a tuple key and model keys."""
    D, S = _problem()
    opt = {"MaxMainIter": 40, "RelStopTol": 1e-4, "RelaxParam": 1.5,
           "AutoRho": {"Period": 5}, ("AutoRho", "RsdlRatio"): 2.0,
           "NonNegCoef": True, "L1Weight": 0.5, "DataType": "float64"}
    kw = {k: v for k, v in CASES[name].items()}
    a = getattr(jb, name)(D, S, opt=dict(opt), **kw)
    a.solve()
    b = getattr(tb, name)(D, S, opt=dict(opt), device="cpu", **kw)
    b.solve()
    assert b.opts.max_iter == a.opts.max_iter == 40
    assert b.opts.auto_rho.period == 5 and b.opts.relax_param == 1.5
    assert b.opts.auto_rho.rsdl_ratio == 2.0
    assert b.cfg.non_neg and b.opts.dtype == torch.float64
    _assert_rows(a, b, S, 1e-6, 1e-6, 1e-10)
    _assert_states(a, b, 1e-8)


@pytest.mark.parametrize("name", ["BPDN", "MinL1InL2Ball"])
def test_reentrant_solve_matches_jax(name):
    """Two solve calls of 6 iterations continue as one run, in both
    packages: the second call's rows and the state after it."""
    D, S = _problem()
    a, b = _solve(name, D, S, "float64", 6, 0.0)
    a.solve()
    b.solve()
    assert int(b.state.k) == int(a.state.k) == 12
    assert len(b.getitstat()) == 6
    np.testing.assert_array_equal(b.getitstat().Iter, np.arange(6, 12))
    _assert_rows(a, b, S, 1e-6, 1e-6, 1e-10)
    _assert_states(a, b, 1e-8)


@pytest.mark.parametrize("name", ["BPDN", "ElasticNet", "MinL1InL2Ball"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(name, writer, tmp_path):
    """A state file written by one package after 8 iterations is resumed
    by the other for 8 more: the rows of the writer's own resume.  The
    file has the JAX pytree's leaves in order (X, Y and U pairs for
    ``MinL1InL2Ball``)."""
    D, S = _problem()
    a, b = _solve(name, D, S, "float64", 8, 0.0)
    path = str(tmp_path / "state.npz")
    (a if writer == "jax" else b).save_state(path)
    jleaves = jax.tree_util.tree_leaves(a.state)
    with np.load(path) as f:
        assert int(f["__n__"]) == len(jleaves)
        for i, leaf in enumerate(jleaves):
            assert f[f"leaf{i}"].shape == np.shape(leaf), i
            assert f[f"leaf{i}"].dtype == np.asarray(leaf).dtype, i
    reader = _make(name, "port" if writer == "jax" else "jax", D, S,
                   "float64", 8, 0.0)
    reader.load_state_file(path)
    assert int(reader.state.k) == 8
    if writer == "jax":
        a, b = a, reader
    else:
        a, b = reader, b
    a.solve()
    b.solve()
    assert int(a.state.k) == int(b.state.k) == 16
    _assert_rows(a, b, S, 1e-6, 1e-6, 1e-10)
    _assert_states(a, b, 1e-8)


def test_load_state_dict_of_jax_pairs():
    """``load_state`` takes the JAX package's ``state_dict()`` with its
    Y and U pairs, after ``numpy.asarray`` of each array."""
    D, S = _problem()
    a, b = _solve("MinL1InL2Ball", D, S, "float64", 8, 0.0)
    d = jax.tree_util.tree_map(np.asarray, a.state_dict())
    b.load_state(d)
    assert isinstance(b.state.Y, tuple) and len(b.state.U) == 2
    a.solve()
    b.solve()
    _assert_rows(a, b, S, 1e-6, 1e-6, 1e-10)
    _assert_states(a, b, 1e-8)


def test_reconstruct_and_card_default():
    """``reconstruct`` is D X; without ``device`` the port runs on the
    card, and raises where there is none."""
    D, S = _problem()
    b = tb.BPDN(D, S, 1e-2, opt=tb.BPDN.options(max_iter=20),
                device="cpu")
    X = b.solve()
    np.testing.assert_allclose(b.reconstruct().numpy(), D @ X.numpy(),
                               rtol=1e-5, atol=1e-6)
    if not torch.cuda.is_available():
        for cls, kw in ((tb.BPDN, {"lmbda": 1e-2}),
                        (tb.MinL1InL2Ball, {"epsilon": 0.1})):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                cls(D, S, **kw)


def test_float32_rows_part_in_jax_for_one_ulp():
    """Why whole float32 runs are not held row by row at 1e-4: the JAX
    package against itself, with S moved by one ulp, parts by more than
    1e-4 in DFid and Rho over a BPDN solve of ``_problem()`` to 1e-3
    (measured 9e-4 and 3e-4), while ObjFun stays within 1e-4."""
    D, S = _problem()
    S2 = np.nextafter(S, np.float32(np.inf))
    opt = jb.BPDN.options(max_iter=300, rel_stop_tol=1e-3)
    runs = []
    for s in (S, S2):
        a = jb.BPDN(D, s, lmbda=1e-2, opt=opt)
        a.solve()
        runs.append(a.getitstat())
    ja, jb_ = runs
    n = min(len(ja), len(jb_))

    def rel(name):
        a, b = getattr(ja, name)[:n], getattr(jb_, name)[:n]
        return float(np.max(np.abs(a - b) / np.abs(a)))
    assert rel("DFid") > 1e-4 and rel("Rho") > 1e-4
    assert rel("ObjFun") < 1e-4
