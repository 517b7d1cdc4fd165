"""Checkpoints, chunked solves and the stats table of the port's model
bases against the JAX package's (``sporco_tpu/models/common.py:111-181,
226-233``): a state file written by the JAX package's ``save_state`` is
resumed by the port to the stats rows of a JAX resume, and a file written
by the port is resumed by the JAX package to those of a port resume; the
files hold the same ``leaf{i}``/``__n__`` layout; ``solve_chunked`` stops
where its callback says; ``display`` prints the JAX package's text.

Both packages run their fused kernel routes (the JAX Pallas kernels in
interpret mode, the port's plain versions) or their generic paths.
Tolerances are those of ``tests/test_torch_cbpdn.py`` and
``tests/test_torch_pgm.py``: the same iteration count, X within 2e-4 of
its scale, ObjFun, DFid and RegL1 (and Rho, L) rtol 1e-4, the residuals
rtol 1e-3 (atol 1e-6).
"""

import io

import numpy as np
import pytest
import torch
import jax
from scipy.ndimage import gaussian_filter

from sporco_tpu.models import cbpdn as jm
from sporco_tpu.models import ccmodmd as jmd
from sporco_tpu.models import pgm as jpgm
from sporco_tpu.ops import pallas_csc_iter as pki
from sporco_tpu_torch.models import cbpdn as tm
from sporco_tpu_torch.models import ccmodmd as tmd
from sporco_tpu_torch.models import common as tcommon
from sporco_tpu_torch.models import pgm as tpgm

torch.set_num_threads(2)

LMBDA = 0.05
ITERS = 8


@pytest.fixture(scope="module", autouse=True)
def interpret():
    prev = pki.interpret
    pki.interpret = True
    jax.clear_caches()
    try:
        yield
    finally:
        pki.interpret = prev
        jax.clear_caches()


def _problem(N=32, M=4, Nd=8, seed=0):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((Nd, Nd, M)).astype(np.float32)
    D /= np.sqrt((D ** 2).sum(axis=(0, 1), keepdims=True))
    S = gaussian_filter(rng.standard_normal((N, N)), 4.0) * 5.0
    S += 0.1 * rng.standard_normal((N, N))
    return D, S.astype(np.float32)


# name -> (JAX class, port class, constructor arguments, stats compared
# at rtol 1e-4, residuals compared at rtol 1e-3)
CASES = {
    "admm_fused": (jm.ConvBPDN, tm.ConvBPDN, {"fused": True},
                   ("ObjFun", "DFid", "RegL1", "Rho"),
                   ("PrimalRsdl", "DualRsdl")),
    "admm_generic": (jm.ConvBPDN, tm.ConvBPDN, {"fused": False},
                     ("ObjFun", "DFid", "RegL1", "Rho"),
                     ("PrimalRsdl", "DualRsdl")),
    "gradreg_fused": (jm.ConvBPDNGradReg, tm.ConvBPDNGradReg,
                      {"fused": True, "mu": 0.1},
                      ("ObjFun", "DFid", "RegL1", "Rho"),
                      ("PrimalRsdl", "DualRsdl")),
    "fista_fused": (jpgm.ConvBPDN, tpgm.ConvBPDN, {},
                    ("ObjFun", "DFid", "RegL1", "L"), ("Rsdl",)),
    "fista_generic": (jpgm.ConvBPDN, tpgm.ConvBPDN, {"fused": False},
                      ("ObjFun", "DFid", "RegL1", "L"), ("Rsdl",)),
    # the two-block problem: X, Y and U are pairs, written in the JAX
    # leaf order
    "maskdcpl": (jm.ConvBPDNMaskDcpl, tm.ConvBPDNMaskDcpl,
                 {"W": (np.random.default_rng(3).random((32, 32))
                        > 0.25).astype(np.float32)},
                 ("ObjFun", "DFid", "RegL1", "Rho"),
                 ("PrimalRsdl", "DualRsdl")),
}


def _make(cls, kw, device=None):
    D, S = _problem()
    extra = {} if device is None else {"device": device}
    return cls(D, S, LMBDA, opt=cls.options(max_iter=ITERS,
                                            rel_stop_tol=0.0), **kw, **extra)


def _out(model):
    X = model.getmin()
    return np.asarray(X) if not isinstance(X, torch.Tensor) \
        else X.numpy()


def _assert_close(jits, jX, tits, tX, names, rsdl):
    assert len(jits) == len(tits) == ITERS
    np.testing.assert_array_equal(tits.Iter, jits.Iter)
    assert tX.shape == jX.shape
    assert np.abs(tX - jX).max() < 2e-4 * max(np.abs(jX).max(), 1e-6)
    for name in names:
        np.testing.assert_allclose(getattr(tits, name), getattr(jits, name),
                                   rtol=1e-4, err_msg=name)
    for name in rsdl:
        np.testing.assert_allclose(getattr(tits, name), getattr(jits, name),
                                   rtol=1e-3, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("name", list(CASES))
def test_jax_checkpoint_resumes_in_port(name, tmp_path):
    """JAX solves, saves; a JAX model and a port model load the file and
    solve on: the same rows."""
    jcls, tcls, kw, names, rsdl = CASES[name]
    a = _make(jcls, kw)
    a.solve()
    path = str(tmp_path / "jax_state.npz")
    a.save_state(path)
    ja = _make(jcls, kw)
    ja.load_state_file(path)
    ja.solve()
    tb = _make(tcls, kw, device="cpu")
    tb.load_state_file(path)
    assert int(tb.state.k) == ITERS
    tb.solve()
    assert int(tb.state.k) == int(ja.state.k) == 2 * ITERS
    _assert_close(ja.getitstat(), _out(ja), tb.getitstat(), _out(tb),
                  names, rsdl)


@pytest.mark.parametrize("name", list(CASES))
def test_port_checkpoint_resumes_in_jax(name, tmp_path):
    """The port solves, saves; a port model and a JAX model load the file
    and solve on: the same rows.  The file has the JAX layout."""
    jcls, tcls, kw, names, rsdl = CASES[name]
    b = _make(tcls, kw, device="cpu")
    b.solve()
    path = str(tmp_path / "port_state.npz")
    b.save_state(path)
    with np.load(path) as f:
        n = int(f["__n__"])
        assert sorted(f.files) == sorted(["__n__"] + [f"leaf{i}"
                                                      for i in range(n)])
        jleaves = jax.tree_util.tree_leaves(_make(jcls, kw).state)
        assert n == len(jleaves)
        for i, leaf in enumerate(jleaves):
            assert f[f"leaf{i}"].shape == np.shape(leaf), i
            assert f[f"leaf{i}"].dtype == np.asarray(leaf).dtype, i
    tb = _make(tcls, kw, device="cpu")
    tb.load_state_file(path)
    tb.solve()
    ja = _make(jcls, kw)
    ja.load_state_file(path)
    ja.solve()
    assert int(tb.state.k) == int(ja.state.k) == 2 * ITERS
    _assert_close(ja.getitstat(), _out(ja), tb.getitstat(), _out(tb),
                  names, rsdl)


def test_checkpoint_round_trip_is_exact(tmp_path):
    """A port file read back by the port gives the state bit for bit."""
    b = _make(tm.ConvBPDN, {}, device="cpu")
    b.solve()
    path = str(tmp_path / "s.npz")
    b.save_state(path)
    c = _make(tm.ConvBPDN, {}, device="cpu")
    c.load_state_file(path)
    for field in b.state._fields:
        x, y = getattr(b.state, field), getattr(c.state, field)
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y), field
        elif field != "extra":
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    with pytest.raises(ValueError, match="leaves"):
        _make(tpgm.ConvBPDN, {}, device="cpu").load_state_file(path)


@pytest.mark.parametrize("pkg", ["admm", "fista"])
def test_solve_chunked_stops_on_callback(pkg):
    """Chunks of 3 iterations; the callback stops after the second: 6
    iterations, as in the JAX package, whose callback sees the same
    counts."""
    jcls, tcls = ((jm.ConvBPDN, tm.ConvBPDN) if pkg == "admm"
                  else (jpgm.ConvBPDN, tpgm.ConvBPDN))
    seen = {"jax": [], "port": []}

    def stop_after_two(key):
        def cb(model):
            seen[key].append(int(model.state.k))
            return len(seen[key]) == 2
        return cb
    tb = _make(tcls, {}, device="cpu")
    X = tb.solve_chunked(stop_after_two("port"), chunk=3)
    assert seen["port"] == [3, 6] and int(tb.state.k) == 6
    assert tb.opts.max_iter == ITERS
    assert torch.equal(X, tb.getmin())
    ja = _make(jcls, {})
    if pkg == "admm":
        ja.solve_chunked(stop_after_two("jax"), chunk=3)
        assert seen["jax"] == seen["port"]
    # all chunks when the callback never stops: ceil(ITERS / 3) of them
    tc = _make(tcls, {}, device="cpu")
    tc.solve_chunked(lambda m: False, chunk=3)
    assert int(tc.state.k) == 3 * -(-ITERS // 3)


@pytest.mark.parametrize("name", ["admm_fused", "fista_fused"])
def test_display_prints_jax_text(name):
    """``display`` of the same stats rows prints the JAX package's
    table."""
    jcls, tcls, kw, _, _ = CASES[name]
    a = _make(jcls, kw)
    a.solve()
    tb = _make(tcls, kw, device="cpu")
    tb.load_state_dict_numpy({k: np.asarray(v) for k, v in
                              a.state_dict().items() if k != "extra"})
    tb.k_start = int(a.k_start)
    jtxt, ttxt = io.StringIO(), io.StringIO()
    a.display(file=jtxt)
    tb.display(file=ttxt)
    assert ttxt.getvalue() == jtxt.getvalue()
    assert len(ttxt.getvalue().splitlines()) == ITERS + 2


def test_leaves_follow_jax_pytree_order():
    """Tuples by position, dicts by sorted key, None no leaf."""
    x = (1, {"b": 2, "a": (3, None)}, [4])
    assert tcommon._leaves(x) == jax.tree_util.tree_leaves(x)
    back = tcommon._unflatten(x, iter([10, 30, 20, 40]))
    assert back == (10, {"a": (30, None), "b": 20}, [40])


def _ccmodmd(pkg, method):
    """A masked CCMOD model (float64) of ``method`` on a small seeded
    problem, ITERS iterations a solve."""
    rng = np.random.default_rng(7)
    S = rng.standard_normal((16, 16, 3))
    Z = rng.standard_normal((16, 16, 1, 3, 4)) * (rng.random(
        (16, 16, 1, 3, 4)) < 0.2)
    W = (rng.random(S.shape) > 0.25).astype(np.float64)
    D0 = rng.standard_normal((4, 4, 4))
    mod = jmd if pkg == "jax" else tmd
    kw = {} if pkg == "jax" else {"device": "cpu"}
    return mod.ConvCnstrMODMaskDcpl(
        Z, S, W, (4, 4, 4), method=method, D0=D0, dtype=np.float64,
        opt=mod.ConvCnstrMODMaskDcplOptions(method=method, max_iter=ITERS,
                                            rel_stop_tol=0.0), **kw)


@pytest.mark.parametrize("method", ["cns", "ism"])
def test_ccmodmd_checkpoint_across_packages(method, tmp_path):
    """A masked CCMOD state (pairs in X, Y and U) written by either
    package resumes in the other to the rows and dictionary of a resume
    in the writing package (float64: rows rtol 1e-6, D 1e-8)."""
    for writer, reader in (("jax", "port"), ("port", "jax")):
        w = _ccmodmd(writer, method)
        w.solve()
        path = str(tmp_path / f"{writer}_{method}.npz")
        w.save_state(path)
        runs = []
        for pkg in (writer, reader):
            m = _ccmodmd(pkg, method)
            m.load_state_file(path)
            assert int(m.state.k) == ITERS
            m.solve()
            D = m.getdict()
            runs.append((m.getitstat(), np.asarray(
                D.numpy() if isinstance(D, torch.Tensor) else D)))
        (iw, Dw), (ir, Dr) = runs
        assert len(iw) == len(ir) == ITERS
        for name in ("DFid", "PrimalRsdl", "DualRsdl", "Rho"):
            np.testing.assert_allclose(getattr(ir, name), getattr(iw, name),
                                       rtol=1e-6, err_msg=name)
        np.testing.assert_allclose(Dr, Dw, rtol=0, atol=1e-8)
