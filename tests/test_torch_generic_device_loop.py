"""The generic ADMM and PGM drivers on the device loop
(``sporco_tpu_torch/solvers/admm.py`` ``_admm_run``,
``sporco_tpu_torch/solvers/pgm.py`` ``_pgm_run``, over
``sporco_tpu_torch/ops/device_loop.py``) on the CPU, against the JAX
package's generic drivers on the same numpy problems.

The loop runs the problem's functions in blocks of ``UNROLL = 8``
iterations between host reads, each iteration guarded by a device flag
``live``: a solve that stops inside a block (k = 3, 11), at its end
(k = 8) or at ``max_iter`` = 9 runs dead iterations after it, which must
change nothing.  Each stop is held against the JAX solve at
``rel_stop_tol`` 0 (whose first k rows do not depend on the tolerance):
the same iteration count and its rows, with the tolerance of each stop
set between the largest residual of iteration k and the least of the
earlier ones (a wide gap, so that no rounding moves the stop).  The
arrays are held at ``max_iter`` = 9 against a JAX solve of 9 iterations.

Tolerances: float64, rows rtol 1e-6 (float32 rows in both packages) and
arrays within 1e-8 of their scale (``tests/test_torch_bpdn.py``);
float32, ObjFun, DFid, RegL1, RegTV, Rho rtol 1e-4, the residuals and
the rest rtol 1e-3 / atol 1e-6, arrays within 2e-4 of their scale
(``tests/test_torch_generic.py``, ``tests/test_torch_tv.py``).

The scalar arithmetic on the device is held bit for bit against the host
forms in float64 (the float32 forms are held in
``tests/test_torch_device_loop.py``), and the float64 ``sqrt_t`` against
``numpy.sqrt`` on 10**5 inputs over the whole exponent range, evaluated
in chunks of 10**4 (below torch's CPU parallel grain: a square root of
the loop is a 0-d tensor).
"""

import contextlib
import io
import math

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from sporco_tpu.models import bpdn as jbp
from sporco_tpu.models import cbpdn as jcb
from sporco_tpu.models import pgm as jpgm
from sporco_tpu.models import tv as jtv
from sporco_tpu_torch.models import bpdn as tbp
from sporco_tpu_torch.models import cbpdn as tcb
from sporco_tpu_torch.models import pgm as tpgm
from sporco_tpu_torch.models import ppp as tppp
from sporco_tpu_torch.models import tv as ttv
from sporco_tpu_torch.ops import device_loop
from sporco_tpu_torch.ops import fft as tsf
from sporco_tpu_torch.solvers import admm as tadmm
from sporco_tpu_torch.solvers import pgm as tspgm

torch.set_num_threads(2)

REF_ITERS = 12
STOPS = (3, 8, 11)
PROBLEMS = ("BPDN", "TVL2Denoise", "ConvBPDN", "FISTA")
DTYPES = ("float32", "float64")


def _data(name):
    rng = np.random.default_rng(0)
    if name == "BPDN":
        D = rng.standard_normal((32, 48)).astype(np.float32)
        x0 = np.zeros((48, 3), np.float32)
        for k in range(3):
            x0[rng.choice(48, 4, replace=False), k] = rng.standard_normal(4)
        S = (D @ x0 + 0.01 * rng.standard_normal((32, 3))).astype(
            np.float32)
        return D, S
    S = gaussian_filter(rng.standard_normal((32, 32)), 3.0) * 5.0
    S = (S + 0.1 * rng.standard_normal((32, 32))).astype(np.float32)
    if name == "TVL2Denoise":
        return None, S
    D = rng.standard_normal((6, 6, 4)).astype(np.float32)
    D /= np.sqrt((D ** 2).sum(axis=(0, 1), keepdims=True))
    return D, S


def _model(pkg, name, dtype, **opt):
    """The model of ``name`` in package ``pkg`` (``"jax"`` or
    ``"port"``), on the generic driver, in ``dtype``."""
    D, S = _data(name)
    port = pkg == "port"
    dt = getattr(torch if port else np, dtype)
    dev = {"device": "cpu"} if port else {}
    if name == "BPDN":
        cls = (tbp if port else jbp).BPDN
        return cls(D, S, 1e-2, opt=cls.options(**opt), dtype=dt, **dev)
    if name == "TVL2Denoise":
        cls = (ttv if port else jtv).TVL2Denoise
        return cls(S, 0.2, opt=cls.options(**opt), dtype=dt, **dev)
    if name == "ConvBPDN":
        cls = (tcb if port else jcb).ConvBPDN
        return cls(D, S, 0.05, opt=cls.options(**opt), dtype=dt,
                   fused=False, **dev)
    cls = (tpgm if port else jpgm).ConvBPDN
    return cls(D, S, 0.05, opt=cls.options(L=50.0, **opt), dtype=dt,
               fused=False, **dev)


_RUNS = {}


def _run(pkg, name, dtype, **opt):
    key = (pkg, name, dtype, tuple(sorted(opt.items())))
    if key not in _RUNS:
        b = _model(pkg, name, dtype, **opt)
        b.solve()
        arrays = {n: np.asarray(getattr(b.state, n)) for n in ("X", "Y")}
        _RUNS[key] = (b.getitstat(), arrays, int(b.state.k))
    return _RUNS[key]


def _measure(its, name):
    if name == "FISTA":
        return np.asarray(its.Rsdl)
    return np.maximum(its.PrimalRsdl, its.DualRsdl)


def _stop_tol(name, dtype, k):
    """A ``rel_stop_tol`` at which the JAX solve stops after k
    iterations, well away from every iteration's residual."""
    m = _measure(_run("jax", name, dtype, max_iter=REF_ITERS,
                      rel_stop_tol=0.0)[0], name)
    lo, hi = m[k - 1], m[:k - 1].min()
    assert hi > 1.01 * lo, (name, dtype, k, m)
    return float(math.sqrt(lo * hi))


EXACT = ("ObjFun", "DFid", "RegL1", "RegTV", "Rho", "L")


def _assert_rows(dtype, ja, ta, n, skip=()):
    assert len(ta) == n
    np.testing.assert_array_equal(ta.Iter, ja.Iter[:n])
    assert set(ta._names) == set(ja._names)
    for c in ta._names:
        if c in skip:
            continue
        a, b = getattr(ta, c), getattr(ja, c)[:n]
        if dtype == "float64":
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12,
                                       err_msg=c)
        elif c in EXACT:
            np.testing.assert_allclose(a, b, rtol=1e-4, err_msg=c)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-3, atol=1e-6,
                                       err_msg=c)


def _assert_arrays(dtype, jarr, tarr):
    tol = 1e-8 if dtype == "float64" else 2e-4
    for n, b in jarr.items():
        a = tarr[n]
        assert a.shape == b.shape, n
        assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-6), n


CASES = [(p, d, k) for p in PROBLEMS for d in DTYPES for k in STOPS]


@pytest.mark.parametrize("name,dtype,k", CASES,
                         ids=[f"{p}-{d}-k{k}" for p, d, k in CASES])
def test_stop_inside_and_at_block_boundaries_matches_jax(name, dtype, k):
    ref = _run("jax", name, dtype, max_iter=REF_ITERS, rel_stop_tol=0.0)
    t = _run("port", name, dtype, max_iter=50,
             rel_stop_tol=_stop_tol(name, dtype, k))
    assert t[2] == k
    # the tolerances are the stop's own (abs_stop_tol 0: rel_stop_tol)
    _assert_rows(dtype, ref[0], t[0], k, skip=("EPrimal", "EDual"))
    tol = _stop_tol(name, dtype, k)
    for c in ("EPrimal", "EDual") if name != "FISTA" else ():
        np.testing.assert_array_equal(
            getattr(t[0], c), np.float32(getattr(np, dtype)(tol)))


MAX_CASES = [(p, d) for p in PROBLEMS for d in DTYPES]


@pytest.mark.parametrize("name,dtype", MAX_CASES,
                         ids=[f"{p}-{d}" for p, d in MAX_CASES])
def test_max_iter_inside_a_block_matches_jax(name, dtype):
    """``max_iter`` = 9: a block of 8, then a block of 1."""
    j = _run("jax", name, dtype, max_iter=9, rel_stop_tol=0.0)
    t = _run("port", name, dtype, max_iter=9, rel_stop_tol=0.0)
    assert j[2] == t[2] == 9
    _assert_rows(dtype, j[0], t[0], 9)
    _assert_arrays(dtype, j[1], t[1])


@pytest.mark.parametrize("name,dtype", MAX_CASES,
                         ids=[f"{p}-{d}" for p, d in MAX_CASES])
def test_resume_from_k5_equals_one_solve(name, dtype):
    """A solve of 5 iterations resumed to 13 (k0 = 5, inside a block)
    gives the rows and the state of one solve of 13, bit for bit; a
    second model of the first's key replays its kept loop, refilled."""
    one = _model("port", name, dtype, max_iter=13, rel_stop_tol=0.0)
    one.solve()
    # another model of the same key refills and replays the kept loop
    loops = {id(v[1]) for v in device_loop._KEPT.values()}
    again = _model("port", name, dtype, max_iter=13, rel_stop_tol=0.0)
    again.solve()
    assert loops == {id(v[1]) for v in device_loop._KEPT.values()}
    assert torch.equal(again.state.X, one.state.X)
    two = _model("port", name, dtype, max_iter=5, rel_stop_tol=0.0)
    two.solve()
    assert int(two.state.k) == 5
    two.opts = two.opts.replace(max_iter=8)
    two.solve()
    assert device_loop.LAST["live"] == 8
    assert int(two.state.k) == int(one.state.k) == 13
    a, b = one.getitstat(), two.getitstat()
    assert len(b) == 8
    for n in a._names:
        np.testing.assert_array_equal(getattr(b, n), getattr(a, n)[5:],
                                      err_msg=n)
    for n in ("X", "Y"):
        assert torch.equal(getattr(one.state, n), getattr(two.state, n)), n


def _line(name, row, nobj):
    if name == "FISTA":
        return (f"it {int(row[0])}  obj {row[1]:.4e}  rsdl "
                f"{row[1 + nobj]:.3e}  L {row[-1]:.3e}")
    return (f"it {int(row[0])}  obj {row[1]:.4e}  r {row[1 + nobj]:.3e}  "
            f"s {row[2 + nobj]:.3e}  rho {row[-1]:.3e}")


@pytest.mark.parametrize("name", PROBLEMS)
def test_verbose_prints_one_line_per_iteration(name):
    b = _model("port", name, "float32", max_iter=50,
               rel_stop_tol=_stop_tol(name, "float32", 11), verbose=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        b.solve()
    k = int(b.state.k)
    assert k == 11
    rows = np.asarray(b.state.stats)[:k]
    nobj = len(b.STAT_NAMES)
    assert out.getvalue().splitlines() == [_line(name, r, nobj)
                                           for r in rows]


# ---------------------------------------------------------------------------
# No stray host reads: the iterations read nothing on the host; the loop
# reads once a block and once at the end, through device_loop.read

_CONVERSIONS = ("item", "__float__", "__int__", "__bool__", "__index__",
                "cpu", "numpy", "tolist", "__array__")


def _ppp(dtype):
    _, S = _data("TVL2Denoise")
    s = torch.tensor(S, dtype=getattr(torch, dtype))

    def f(x):
        return 0.5 * torch.sum((x - s) ** 2)

    def proxf(v, rho):
        return (s + rho * v) / (1.0 + rho)

    def proxg(v, rho):
        return torch.sign(v) * torch.clamp(v.abs() - 0.05 / rho, min=0.0)
    return tppp.PPP(S.shape, f, proxf, proxg, dtype=getattr(torch, dtype),
                    opt=tppp.PPP.options(max_iter=50, rel_stop_tol=1e-3),
                    device="cpu")


def _rpca(form, dtype):
    """Robust PCA on a 32 x 32 rank-3 matrix plus 10% outliers, with the
    full SVD or the randomized one of rank 3."""
    from sporco_tpu_torch.models import rpca as trpca
    rng = np.random.default_rng(0)
    S = rng.standard_normal((32, 3)) @ rng.standard_normal((3, 32)) \
        + (rng.random((32, 32)) > 0.9) * rng.standard_normal((32, 32)) * 5
    return trpca.RobustPCA(S.astype(np.float32), dtype=getattr(torch, dtype),
                           svd_rank=None if form == "full" else 3,
                           device="cpu", opt=trpca.RobustPCA.options(
                               max_iter=30, rel_stop_tol=1e-3))


READ_CASES = [(p, d) for p in PROBLEMS + ("TVL2Deconv", "PPP",
                                          "RobustPCA-full",
                                          "RobustPCA-randomized")
              for d in DTYPES]


@pytest.mark.parametrize("name,dtype", READ_CASES,
                         ids=[f"{p}-{d}" for p, d in READ_CASES])
def test_no_host_read_inside_the_iterations(monkeypatch, name, dtype):
    """Every conversion of a tensor to host data (``item``, ``float``,
    ``bool``, ``cpu``, ``numpy``, ...) is counted while an iteration
    runs: there is none, and the solve reads ``ceil(k / 8) + 1`` times
    through ``device_loop.read`` (the CPU stand-in for a failed CUDA-graph
    capture)."""
    counts = {"inside": 0, "reads": 0, "convert": []}
    for meth in _CONVERSIONS:
        orig = getattr(torch.Tensor, meth)

        def counted(self, *a, _orig=orig, _m=meth, **k):
            if counts["inside"]:
                counts["convert"].append(_m)
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, meth, counted)
    read = device_loop.read

    def counted_read(t):
        counts["reads"] += 1
        return read(t)
    monkeypatch.setattr(device_loop, "read", counted_read)
    run = device_loop.run

    def counted_run(loop, *a, **k):
        step = loop.step

        def inside():
            counts["inside"] += 1
            try:
                return step()
            finally:
                counts["inside"] -= 1
        loop.step = inside
        try:
            return run(loop, *a, **k)
        finally:
            loop.step = step
    monkeypatch.setattr(device_loop, "run", counted_run)
    if name == "PPP":
        b = _ppp(dtype)
    elif name.startswith("RobustPCA"):
        b = _rpca(name.split("-")[1], dtype)
    elif name == "TVL2Deconv":
        _, S = _data(name)
        A = np.ones((3, 3), np.float32) / 9.0
        dt = getattr(torch, dtype)
        b = ttv.TVL2Deconv(A, S, 0.05, dtype=dt, device="cpu",
                           opt=ttv.TVL2Deconv.options(max_iter=30))
    else:
        b = _model("port", name, dtype, max_iter=30, rel_stop_tol=1e-3)
    b.solve()
    k = int(b.state.k)
    assert 0 < k
    assert counts["convert"] == []
    assert counts["reads"] == math.ceil(k / 8) + 1
    assert device_loop.LAST["host_reads"] == counts["reads"]
    assert device_loop.LAST["route"] == "eager"      # the CPU has no graph
    assert not device_loop.LAST["graph"]


def test_declared_routes():
    """The problems that synchronise with the host by nature (a host
    callable) declare the eager route; the rest the graph (the CG d-steps
    too: their solves are inner loops, WHILE nodes on the card; Robust
    PCA too: its SVD's sweeps are a WHILE node)."""
    from sporco_tpu_torch.models import ccmod, ccmodmd, rpca
    assert rpca._RPCA.route == "graph"
    assert ccmod._CCMOD_SINGLE["cg"].route == "graph"
    assert ccmod._CCMOD_SINGLE["ism"].route == "graph"
    assert ccmodmd._CCMODMD_2B["cg"].route == "graph"
    for p in tbp._PROBLEMS.values():
        assert p.route == "graph"
    assert tcb._CSC_PROBLEMS["l1"].route == "graph"
    assert _ppp("float32").problem.route == "graph"
    host = tppp.host_prior(lambda x: x)
    assert tppp.PPP((4, 4), lambda x: x.sum(), lambda v, r: v, host,
                    device="cpu").problem.route == "eager"


@pytest.mark.parametrize("backtrack", ["standard", "robust"])
def test_backtracking_reads_one_flag_a_trial(backtrack):
    """Backtracking takes the graph route (its line search an inner loop,
    a WHILE node on the card); on the CPU each pass reads its test once,
    so a live iteration of n trials reads n flags (the last false); its
    rows match the JAX package's (float64)."""
    opt = dict(max_iter=9, rel_stop_tol=0.0, backtrack=backtrack)
    D, S = _data("FISTA")
    j = jpgm.ConvBPDN(D, S, 0.05, opt=jpgm.ConvBPDN.options(L=0.5, **opt),
                      dtype=np.float64, fused=False)
    j.solve()
    t = tpgm.ConvBPDN(D, S, 0.05, opt=tpgm.ConvBPDN.options(L=0.5, **opt),
                      dtype=torch.float64, fused=False, device="cpu")
    t.solve()
    _assert_rows("float64", j.getitstat(), t.getitstat(), 9)
    ibt = np.asarray(t.getitstat().IterBTrack).astype(int)
    np.testing.assert_array_equal(ibt, j.getitstat().IterBTrack)
    assert tspgm.pgm_route(t.problem, t.opts) == "graph"
    assert device_loop.LAST["route"] == "eager"      # the CPU has no graph
    assert device_loop.LAST["flag_reads"] == int(ibt.sum())
    assert device_loop.LAST["host_reads"] == 3


# ---------------------------------------------------------------------------
# Float64 scalar forms, bit for bit

def _sqrt_inputs():
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 0x7FF0000000000000, 60000, dtype=np.int64)
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -1.0, 5e-324,
                        2.2250738585072014e-308, 2.225073858507201e-308,
                        np.finfo(np.float64).max, 1.0, 4.0, 2.0 ** -1074 * 9,
                        2.0 ** 900, 2.0 ** -900, np.nextafter(2.0 ** 900, 0),
                        np.nextafter(2.0 ** -900, 1)])
    sq = np.arange(1.0, 10001.0) ** 2
    return {
        "random_bits": bits.view(np.float64),
        "subnormal": rng.integers(1, 2 ** 52, 10000,
                                  dtype=np.int64).view(np.float64),
        "squares": np.concatenate([sq, sq * 2.0 ** -1000, sq * 2.0 ** 960,
                                   np.nextafter(sq, 0),
                                   np.nextafter(sq, np.inf)]),
        "decades": 10.0 ** rng.uniform(-307, 308, 30000),
        "special": special,
    }


@pytest.mark.parametrize("kind", ["random_bits", "subnormal", "squares",
                                  "decades", "special"])
def test_sqrt_t_float64_equals_numpy(kind):
    x = _sqrt_inputs()[kind]
    with np.errstate(invalid="ignore"):
        want = np.sqrt(x)
    got = np.concatenate([
        tadmm.sqrt_t(torch.tensor(x[i:i + 10000])).numpy()
        for i in range(0, x.size, 10000)])
    same = (got.view(np.int64) == want.view(np.int64)) | (
        np.isnan(got) & np.isnan(want))
    assert same.all(), x[~same][:5]


def test_sqrt_t_float64_zero_dim_and_total_count():
    """0-d tensors, as the loop takes them; and the inputs above number
    at least 10**5."""
    inputs = _sqrt_inputs()
    assert sum(v.size for v in inputs.values()) >= 10 ** 5
    x = np.concatenate([v[:400] for v in inputs.values()])
    for v in x:
        g = tadmm.sqrt_t(torch.tensor(v)).item()
        with np.errstate(invalid="ignore"):
            w = float(np.sqrt(v))
        assert (np.float64(g).view(np.int64) == np.float64(w).view(
            np.int64)) or (math.isnan(g) and math.isnan(w)), v


AR = [tadmm.AutoRhoOpts(enabled=True, period=1, auto_scaling=True,
                        scaling=1000.0, rsdl_ratio=1.2),
      tadmm.AutoRhoOpts(enabled=True, period=3, auto_scaling=False,
                        scaling=2.0, rsdl_ratio=10.0),
      tadmm.AutoRhoOpts(enabled=False)]
f64 = np.float64


@pytest.mark.parametrize("ar", AR)
def test_rsf_t_float64_equals_host_form(ar):
    rng = np.random.default_rng(21)
    for i in range(300):
        k = int(rng.integers(0, 12))
        r, s = (f64(x) for x in 10.0 ** rng.uniform(-9, 3, 2))
        if i % 10 == 0:
            s = f64(0.0)
        if i % 10 == 5:
            r = f64(0.0)
        xi = f64(rng.uniform(1, 3))
        want = tadmm._rsf(ar, np.int32(k), r, s, xi, f64)
        for kt in (torch.tensor(k), torch.tensor(float(k),
                                                 dtype=torch.float64)):
            got = tadmm.rsf_t(ar, kt, torch.tensor(r), torch.tensor(s),
                              torch.tensor(xi))
            assert got.dtype == torch.float64
            assert f64(got.item()) == want


@pytest.mark.parametrize("std", [False, True])
def test_norm_residuals_t_float64_equals_host_form(std):
    rng = np.random.default_rng(22)
    ar = tadmm.AutoRhoOpts(std_residuals=std)
    opts = tadmm.ADMMOpts(abs_stop_tol=1e-4, rel_stop_tol=1e-3,
                          dtype=torch.float64)
    nc, nx = math.sqrt(4096.0 * 64), math.sqrt(777.0)
    for i in range(300):
        v = [f64(x) for x in 10.0 ** rng.uniform(-8, 5, 4)]
        if i % 7 == 0:
            v[2] = f64(0.0)
        if i % 7 == 3:
            v[3] = f64(0.0)
        want = tadmm.norm_residuals(ar, opts, nc, nx, *v, ft=f64)
        got = tadmm.norm_residuals_t(ar, opts, nc, nx,
                                     *(torch.tensor(x) for x in v))
        assert [f64(g.item()) for g in got] == [f64(w) for w in want]


@pytest.mark.parametrize("momentum", ["nesterov", "linear", "genlinear"])
def test_momentum_and_stop_tol_t_float64_equal_host_forms(momentum):
    opts = tspgm.PGMOpts(momentum=momentum, momentum_a=7.0,
                         momentum_b=3.0, auto_stop=True,
                         auto_stop_tau0=0.3, dtype=torch.float64)
    t, tt = f64(1.0), torch.tensor(1.0, dtype=torch.float64)
    for k in range(500):
        t = tspgm._momentum_update(opts, t, k)
        tt = tspgm.momentum_update_t(opts, tt, torch.tensor(k))
        assert tt.dtype == torch.float64 and f64(tt.item()) == t
        kt = torch.tensor(float(k), dtype=torch.float64)
        assert (f64(tspgm.stop_tol_t(opts, kt, torch.float64).item())
                == tspgm.stop_tol(opts, k, f64))


def test_const_div_rounds_once():
    """``const_div(a, t)`` is the division ``a / t`` (torch's ``a / t``
    for a number is ``reciprocal(t) * a``)."""
    rng = np.random.default_rng(23)
    for dt, nd in ((torch.float32, np.float32), (torch.float64, f64)):
        a = nd(0.37)
        x = rng.uniform(0.01, 100.0, 2000).astype(nd)
        got = tadmm.const_div(a, torch.tensor(x)).numpy()
        np.testing.assert_array_equal(got, a / x)


def test_kept_generic_loops_per_problem_and_refill():
    """Each generic problem keeps a loop of its own kind (dictionary
    learning's x- and d-steps both replay theirs); another model of the
    same geometry refills it and gives what it gives alone."""
    device_loop.clear_cache()
    a = _model("port", "BPDN", "float64", max_iter=6, rel_stop_tol=0.0)
    a.solve()
    _model("port", "TVL2Denoise", "float64", max_iter=6,
           rel_stop_tol=0.0).solve()
    kinds = {k[0] for k in device_loop._KEPT}
    assert kinds == {"admm_generic"} and len(device_loop._KEPT) == 2
    D, S = _data("BPDN")
    other = tbp.BPDN(D, 2.0 * S, 2e-2, dtype=torch.float64, device="cpu",
                     opt=tbp.BPDN.options(max_iter=6, rel_stop_tol=0.0))
    other.solve()
    assert len(device_loop._KEPT) == 2
    device_loop.clear_cache()
    alone = tbp.BPDN(D, 2.0 * S, 2e-2, dtype=torch.float64, device="cpu",
                     opt=tbp.BPDN.options(max_iter=6, rel_stop_tol=0.0))
    alone.solve()
    assert torch.equal(other.state.Y, alone.state.Y)
    for n in alone.getitstat()._names:
        np.testing.assert_array_equal(getattr(other.getitstat(), n),
                                      getattr(alone.getitstat(), n))
    # the first model's tensors were the loop's copies, never refilled
    assert not torch.equal(a.state.Y, other.state.Y)


def test_planar_route_counts_transforms_of_live_iterations(monkeypatch):
    """The generic ConvBPDN on the planar FFT route on the CPU (128 x
    128, the plain versions counted): ``rfft2_planar`` k + 2 (the set-up
    takes D and S), ``irfft2_planar`` k, whatever the dead iterations of
    the last block."""
    from sporco_tpu_torch.ops import fft2_planar as tfp
    calls = {"rfft2_planar_plain": 0, "irfft2_planar_plain": 0}
    for plain in calls:
        fn = getattr(tfp, plain)

        def counted(*a, _f=fn, _n=plain, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(tfp, plain, counted)
    rng = np.random.default_rng(1)
    D = rng.standard_normal((8, 8, 4)).astype(np.float32)
    S = gaussian_filter(rng.standard_normal((128, 128)), 3.0).astype(
        np.float32)
    tsf.use_planar_fft("always")
    try:
        b = tcb.ConvBPDN(D, S, 0.05, fused=False, device="cpu",
                         opt=tcb.ConvBPDN.options(max_iter=11,
                                                  rel_stop_tol=0.0))
        b.solve()
    finally:
        tsf.use_planar_fft("auto")
    k = int(b.state.k)
    assert k == 11 and device_loop.LAST["replays"] == 11
    assert calls == {"rfft2_planar_plain": k + 2,
                     "irfft2_planar_plain": k}
