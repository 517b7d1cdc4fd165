"""The fused drivers' on-device loop (``sporco_tpu_torch/ops/
device_loop.py``) on the CPU, against the JAX package's fused drivers on
the same numpy problems, their Pallas kernels in interpret mode.

The loop runs its iteration function in blocks of ``UNROLL = 8``
iterations between host reads, each iteration guarded by a device flag
``live`` (the JAX ``lax.cond``): solves that stop inside a block (k = 1,
7, 9, 13), at its end (k = 8) and at ``max_iter`` = 9 run dead
iterations after convergence, which must change nothing.  Each is held
against the JAX solve with the same options: the same iteration count,
every stats row and the final X/Y/U at the tolerances of
``tests/ops/test_fused_csc.py`` (PERF.md section 2): ObjFun, DFid, RegL1
and Rho rtol 1e-4; RegL2 and RegGrad rtol 1e-3; the residuals and their
tolerances rtol 1e-3; the arrays within 2e-4 of their largest magnitude.
The stopping tolerance of each solve is set between the largest
normalised residual of its last iteration and the least of the earlier
ones in the JAX run at ``rel_stop_tol`` 0 (and the gap is held to be
wide, so that a rounding of the residuals cannot move the stop).
"""

import contextlib
import io
import math

import jax
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from sporco_tpu.models import cbpdn as jm
from sporco_tpu.models import pgm as jpgm
from sporco_tpu.ops import pallas_csc_iter as pki
from sporco_tpu.ops import pallas_csc_tail as ptail
from sporco_tpu_torch.models import cbpdn as tm
from sporco_tpu_torch.models import pgm as tpgm
from sporco_tpu_torch.ops import csc_iter as tci
from sporco_tpu_torch.ops import csc_tail as tct
from sporco_tpu_torch.ops import device_loop
from sporco_tpu_torch.ops import fft as tsf
from sporco_tpu_torch.ops import fft2_planar as tfp
from sporco_tpu_torch.ops import pgm_iter as tpi
from sporco_tpu_torch.solvers import admm as tadmm
from sporco_tpu_torch.solvers import pgm as tspgm

torch.set_num_threads(2)

LMBDA = 0.05
REF_ITERS = 16
STOPS = (1, 7, 8, 9, 13)
f32 = np.float32


def _problem(N=32, M=4, Nd=8, seed=0):
    """A small version of the headline problem (``bench.py``) and a mask
    that drops about a quarter of the pixels."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((Nd, Nd, M)).astype(np.float32)
    D /= np.sqrt((D ** 2).sum(axis=(0, 1), keepdims=True))
    S = gaussian_filter(rng.standard_normal((N, N)), 4.0) * 5.0
    S += 0.1 * rng.standard_normal((N, N))
    W = (rng.random((N, N)) > 0.25).astype(np.float32)
    return D, S.astype(np.float32), W


@contextlib.contextmanager
def _jax_kernels():
    """The JAX fused drivers on their Pallas kernels in interpret mode
    (``body_pk`` and the FISTA kernel); ``body`` on its XLA tail."""
    prev = (pki.interpret, ptail.enabled)
    pki.interpret, ptail.enabled = True, False
    jax.clear_caches()
    try:
        yield
    finally:
        pki.interpret, ptail.enabled = prev
        jax.clear_caches()


# the model of case `name` in package `pkg`, on the signal times `scale`
def _model(pkg, name, opt, scale=1.0, lmbda=LMBDA):
    D, S, W = _problem()
    S = scale * S
    cls = {"jax": jm, "port": tm}[pkg]
    dev = {} if pkg == "jax" else {"device": "cpu"}
    fused = {"fused": True}
    if name == "l1":
        return cls.ConvBPDN(D, S, lmbda, opt=cls.ConvBPDN.options(**opt),
                            **fused, **dev)
    if name == "gradreg":
        return cls.ConvBPDNGradReg(
            D, S, lmbda, mu=0.2, opt=cls.ConvBPDNGradReg.options(**opt),
            **fused, **dev)
    if name == "ams":
        return cls.AddMaskSim(cls.ConvBPDN, D, S, W, lmbda,
                              opt=cls.ConvBPDN.options(**opt), **fused,
                              **dev)
    pcls = {"jax": jpgm, "port": tpgm}[pkg].ConvBPDN
    return pcls(D, S, lmbda, opt=pcls.options(
        L=50.0, fast_solve=name == "fista_fast", **opt), **fused, **dev)


CASES = ("l1", "gradreg", "ams", "fista", "fista_fast")
_RUNS = {}


def _run(pkg, name, **opt):
    key = (pkg, name, tuple(sorted(opt.items())))
    if key not in _RUNS:
        with _jax_kernels():
            b = _model(pkg, name, opt)
            Y = b.solve()
        inner = getattr(b, "cbpdn", b)
        arrays = {"out": Y}
        for n in ("X", "Y", "U") if name in ("l1", "gradreg", "ams") \
                else ("X", "Y"):
            arrays[n] = getattr(inner.state, n)
        _RUNS[key] = (b.getitstat(), {n: np.asarray(a) for n, a in
                                      arrays.items()},
                      int(inner.state.k))
    return _RUNS[key]


def _measure(its, name):
    """The quantity the stopping test compares with ``rel_stop_tol``
    (``abs_stop_tol`` 0): the larger normalised residual of an ADMM
    iteration, FISTA's Rsdl."""
    if name.startswith("fista"):
        return np.asarray(its.Rsdl)
    return np.maximum(its.PrimalRsdl, its.DualRsdl)


def _stop_tol(name, k):
    """A ``rel_stop_tol`` at which the JAX solve stops after k
    iterations, well away from every iteration's residual."""
    m = _measure(_run("jax", name, max_iter=REF_ITERS,
                      rel_stop_tol=0.0)[0], name)
    if k == 1:
        return float(2.0 * m[0])
    lo, hi = m[k - 1], m[:k - 1].min()
    assert hi > 1.01 * lo, (name, k, m)
    return float(math.sqrt(lo * hi))


def _assert_close(name, j, t):
    ja, jarr, jk = j
    ta, tarr, tk = t
    assert tk == jk and len(ta) == len(ja)
    np.testing.assert_array_equal(ta.Iter, ja.Iter)
    for n, b in jarr.items():
        a = tarr[n]
        assert a.shape == b.shape, n
        assert np.abs(a - b).max() <= 2e-4 * max(np.abs(b).max(), 1e-6), n
    names = set(ja._names)
    assert set(ta._names) == names
    for n in ("ObjFun", "DFid", "RegL1", "Rho"):
        if n in names:
            np.testing.assert_allclose(getattr(ta, n), getattr(ja, n),
                                       rtol=1e-4, err_msg=n)
    for n in ("RegL2", "RegGrad", "PrimalRsdl", "DualRsdl", "EPrimal",
              "EDual", "Rsdl"):
        if n in names:
            np.testing.assert_allclose(getattr(ta, n), getattr(ja, n),
                                       rtol=1e-3, atol=1e-6, err_msg=n)


STOP_CASES = [(n, k) for n in CASES for k in STOPS]


@pytest.mark.parametrize("name,k", STOP_CASES,
                         ids=[f"{n}-k{k}" for n, k in STOP_CASES])
def test_stop_inside_and_at_block_boundaries_matches_jax(name, k):
    tol = _stop_tol(name, k)
    opt = dict(max_iter=50, rel_stop_tol=tol)
    j = _run("jax", name, **opt)
    t = _run("port", name, **opt)
    assert j[2] == k
    _assert_close(name, j, t)


@pytest.mark.parametrize("name", CASES)
def test_max_iter_inside_a_block_matches_jax(name):
    """``max_iter`` = 9: one block of 8, then a block of 1 (the loop
    never runs past ``max_iter``)."""
    opt = dict(max_iter=9, rel_stop_tol=0.0)
    j, t = _run("jax", name, **opt), _run("port", name, **opt)
    assert j[2] == t[2] == 9
    _assert_close(name, j, t)


@pytest.mark.parametrize("name", ["l1", "gradreg", "fista"])
def test_resume_from_k5_equals_one_solve(name):
    """A solve of 5 iterations resumed to 13 (k0 = 5, inside a block)
    gives the rows and the state of one solve of 13."""
    one = _model("port", name, dict(max_iter=13, rel_stop_tol=0.0))
    one.solve()
    two = _model("port", name, dict(max_iter=5, rel_stop_tol=0.0))
    two.solve()
    assert int(two.state.k) == 5
    two.opts = two.opts.replace(max_iter=8)
    two.solve()
    assert int(two.state.k) == int(one.state.k) == 13
    a, b = one.getitstat(), two.getitstat()
    assert len(b) == 8
    for n in a._names:
        np.testing.assert_allclose(getattr(b, n), getattr(a, n)[5:],
                                   rtol=1e-4, atol=1e-6, err_msg=n)
    for n in ("X", "Y"):
        x, y = (getattr(m.state, n).numpy() for m in (one, two))
        assert np.abs(x - y).max() <= 2e-4 * np.abs(x).max(), n


@pytest.mark.parametrize("name,k", [("l1", 7), ("l1", 8), ("gradreg", 9),
                                    ("fista", 13), ("ams", 1)])
def test_one_host_read_per_block(monkeypatch, name, k):
    """``ceil(k / 8)`` reads in the loop (the flag and k) and the final
    one, counted through a monkeypatched read."""
    reads = []

    def counted(t):
        reads.append(tuple(t.shape))
        return t.detach().cpu().numpy()
    monkeypatch.setattr(device_loop, "read", counted)
    b = _model("port", name, dict(max_iter=50,
                                  rel_stop_tol=_stop_tol(name, k)))
    b.solve()
    assert int(getattr(b, "cbpdn", b).state.k) == k
    assert len(reads) == math.ceil(k / 8) + 1
    assert device_loop.LAST["host_reads"] == len(reads)
    assert device_loop.LAST["replays"] == min(8 * math.ceil(k / 8), 50)
    assert device_loop.LAST["live"] == k
    assert not device_loop.LAST["graph"]
    assert not device_loop.LAST["captured"]


@pytest.mark.parametrize("name", ["l1", "gradreg", "fista"])
def test_kept_loop_is_refilled_for_the_next_call(name):
    """A second solve call of the same geometry (here a resumed solve, as
    ``solve_chunked`` and dictionary learning's x-steps make them) reuses
    the loop kept from the first, refilled in place, and gives what a
    solve with no kept loop gives; another problem of the same geometry
    in between (another signal and lmbda, which are values of the loop's
    tensors) refills it too and gives what it gives alone; another
    geometry replaces the loop of its kind, and the other kind keeps a
    loop of its own."""
    kind = "pgm" if name == "fista" else "admm"

    def kept():
        return device_loop._KEPT[kind][1]
    device_loop.clear_cache()
    opt = dict(max_iter=6, rel_stop_tol=0.0)
    a = _model("port", name, opt)
    a.solve()
    loop = kept()
    other = _model("port", name, opt, scale=2.0, lmbda=2 * LMBDA)
    other.solve()
    assert kept() is loop
    a.solve()
    assert kept() is loop
    assert int(a.state.k) == 12
    rows, X = a.getitstat(), a.state.X.clone()
    device_loop.clear_cache()
    b = _model("port", name, opt)
    b.solve()
    b.solve()
    fresh = b.getitstat()
    for n in fresh._names:
        np.testing.assert_array_equal(getattr(rows, n), getattr(fresh, n),
                                      err_msg=n)
    assert torch.equal(X, b.state.X)
    device_loop.clear_cache()
    c = _model("port", name, opt, scale=2.0, lmbda=2 * LMBDA)
    c.solve()
    for n in fresh._names:
        np.testing.assert_array_equal(getattr(other.getitstat(), n),
                                      getattr(c.getitstat(), n), err_msg=n)
    assert torch.equal(other.state.X, c.state.X)
    assert not torch.equal(other.state.X, X)
    loop = kept()
    D, S, _ = _problem(N=40, seed=3)
    cls = tpgm.ConvBPDN if name == "fista" else tm.ConvBPDN
    cls(D, S, LMBDA, opt=cls.options(max_iter=3, L=50.0) if name == "fista"
        else cls.options(max_iter=3), device="cpu").solve()
    assert len(device_loop._KEPT) == 1 and kept() is not loop
    cls = tm.ConvBPDN if name == "fista" else tpgm.ConvBPDN
    cls(D, S, LMBDA, opt=cls.options(max_iter=3) if name == "fista"
        else cls.options(max_iter=3, L=50.0), device="cpu").solve()
    assert len(device_loop._KEPT) == 2


def _old_line(name, row, nobj):
    """The verbose line the host loop printed for a stats row."""
    if name.startswith("fista"):
        return (f"it {int(row[0])}  obj {row[1]:.4e}  rsdl {row[4]:.3e}  "
                f"L {row[8]:.3e}")
    return (f"it {int(row[0])}  obj {row[1]:.4e}  r {row[1 + nobj]:.3e}  "
            f"s {row[2 + nobj]:.3e}  rho {row[-1]:.3e}")


@pytest.mark.parametrize("name", ["l1", "gradreg", "fista"])
def test_verbose_prints_one_line_per_iteration(name):
    tol = _stop_tol(name, 9)
    b = _model("port", name, dict(max_iter=50, rel_stop_tol=tol,
                                  verbose=True))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        b.solve()
    k = int(b.state.k)
    assert k == 9
    rows = np.asarray(b.state.stats)[:k]
    nobj = 4 if name == "l1" else 5
    want = [_old_line(name, r, nobj) for r in rows]
    assert out.getvalue().splitlines() == want


# ---------------------------------------------------------------------------
# The plain versions with live = 0 write nothing

def _bits(t):
    return t.clone().view(torch.int32)


def _same_bits(before, after):
    for a, b in zip(before, after):
        assert torch.equal(a, _bits(b))


@pytest.mark.parametrize("via_wrapper", [False, True])
def test_dead_csc_iter_writes_nothing(via_wrapper):
    rng = np.random.default_rng(3)
    pos, C, T = 16, 64, 24
    t = [torch.tensor(rng.standard_normal(s).astype(np.float32))
         for s in ((pos, T), (pos, C), (pos, C), (T, C), (C, T))]
    G2, Y, U, Wa, Wf = t
    R1 = torch.full((pos, T), 3.0)
    R2 = torch.full((pos, T), float("nan"))
    sums = torch.arange(6, dtype=torch.float32)
    bufs = (Y, U, R1, R2, sums)
    before = [_bits(x) for x in bufs]
    fn = tci.csc_iter if via_wrapper else tci.csc_iter_plain
    out = fn(G2, Y, U, Wa, Wf, torch.tensor(0.1), 1.0, 1.8,
             torch.tensor(0.7), torch.tensor(1.0), emit_px=False,
             live=torch.tensor(False), out=(R1, R2, sums))
    _same_bits(before, bufs)
    assert out[3] is R1 and out[4] is R2 and out[5] is sums
    # live: the arithmetic of a call with Python numbers
    Y2, U2 = Y.clone(), U.clone()
    fn(G2, Y, U, Wa, Wf, torch.tensor(0.1), 1.0, 1.8, torch.tensor(0.7),
       torch.tensor(1.0), emit_px=False, live=torch.tensor(True),
       out=(R1, R2, sums))
    ref = tci.csc_iter_plain(G2, Y2, U2, Wa, Wf, 0.1, 1.0, 1.8, 0.7, 1.0,
                             emit_px=False)
    for a, b in zip((Y, U, R1, R2, sums), (ref[1], ref[2], ref[3], ref[4],
                                           ref[5])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("via_wrapper", [False, True])
def test_dead_pgm_iter_writes_nothing(via_wrapper):
    rng = np.random.default_rng(4)
    pos, C, T = 16, 64, 24
    t = [torch.tensor(rng.standard_normal(s).astype(np.float32))
         for s in ((pos, T), (pos, C), (pos, C), (T, C), (C, T))]
    G2, Y, Xprv, Wa, Wf = t
    R1, RX = torch.full((pos, T), 2.0), torch.full((pos, T), -1.0)
    sums = torch.tensor([5.0, 6.0])
    bufs = (Y, Xprv, R1, RX, sums)
    before = [_bits(x) for x in bufs]
    fn = tpi.pgm_iter if via_wrapper else tpi.pgm_iter_plain
    fn(G2, Y, Xprv, Wa, Wf, 0.05, 1.0, torch.tensor(0.02),
       torch.tensor(0.4), live=torch.tensor(False), out=(R1, RX, sums))
    _same_bits(before, bufs)
    Y2, X2 = Y.clone(), Xprv.clone()
    fn(G2, Y, Xprv, Wa, Wf, 0.05, 1.0, torch.tensor(0.02),
       torch.tensor(0.4), live=torch.tensor(True), out=(R1, RX, sums))
    ref = tpi.pgm_iter_plain(G2, Y2, X2, Wa, Wf, 0.05, 1.0, 0.02, 0.4)
    for a, b in zip((Xprv, Y, R1, RX, sums), ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("ams", [False, True])
@pytest.mark.parametrize("via_wrapper", [False, True])
def test_dead_admm_tail_writes_nothing(via_wrapper, ams):
    rng = np.random.default_rng(5)
    R, C = 12, 64
    PX, PY, PU = (torch.tensor(rng.standard_normal((R, C)).astype(
        np.float32)) for _ in range(3))
    Wp = torch.tensor(rng.random((R, 16)).astype(np.float32))
    kw = {"ams": (Wp, 1)} if ams else {}
    sums = torch.full((6,), 7.0)
    bufs = (PX, PY, PU, sums)
    before = [_bits(x) for x in bufs]
    fn = tct.admm_tail if via_wrapper else tct.admm_tail_plain
    fn(PX, PY, PU, torch.tensor(0.2), 1.0, 1.8, us=torch.tensor(0.5),
       live=torch.tensor(False), out=sums, **kw)
    _same_bits(before, bufs)
    Y2, U2 = PY.clone(), PU.clone()
    fn(PX, PY, PU, torch.tensor(0.2), 1.0, 1.8, us=torch.tensor(0.5),
       live=torch.tensor(True), out=sums, **kw)
    ref = tct.admm_tail_plain(PX, Y2, U2, 0.2, 1.0, 1.8, us=0.5, **kw)
    for a, b in zip((PY, PU, sums), ref):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The scalar arithmetic on the device equals the host forms bit for bit

AR = [tadmm.AutoRhoOpts(enabled=True, period=1, auto_scaling=True,
                        scaling=1000.0, rsdl_ratio=1.2),
      tadmm.AutoRhoOpts(enabled=True, period=3, auto_scaling=False,
                        scaling=2.0, rsdl_ratio=10.0),
      tadmm.AutoRhoOpts(enabled=False)]


@pytest.mark.parametrize("ar", AR)
def test_update_rho_t_equals_host_form(ar):
    rng = np.random.default_rng(11)
    for i in range(300):
        k = int(rng.integers(0, 12))
        r, s = (f32(x) for x in 10.0 ** rng.uniform(-5, 1, 2))
        if i % 10 == 0:
            s = f32(0.0)
        if i % 10 == 5:
            r = f32(0.0)
        rho, xi = f32(rng.uniform(0.01, 10)), f32(rng.uniform(1, 3))
        want = tadmm._update_rho(ar, np.int32(k), r, s, rho, xi, f32(1.0))
        for kt in (torch.tensor(k), torch.tensor(float(k))):
            got = tadmm.update_rho_t(ar, kt, torch.tensor(r),
                                     torch.tensor(s), torch.tensor(rho),
                                     torch.tensor(xi))
            assert f32(got[0].item()) == want[0]
            assert f32(got[1].item()) == want[1]


@pytest.mark.parametrize("std", [False, True])
def test_norm_residuals_t_equals_host_form(std):
    rng = np.random.default_rng(12)
    ar = tadmm.AutoRhoOpts(std_residuals=std)
    opts = tadmm.ADMMOpts(abs_stop_tol=1e-4, rel_stop_tol=1e-3)
    nc = math.sqrt(4096.0 * 64)
    for i in range(300):
        v = [f32(x) for x in 10.0 ** rng.uniform(-4, 3, 4)]
        if i % 7 == 0:
            v[2] = f32(0.0)
        if i % 7 == 3:
            v[3] = f32(0.0)
        want = tadmm.norm_residuals(ar, opts, nc, nc, *v)
        got = tadmm.norm_residuals_t(ar, opts, nc, nc,
                                     *(torch.tensor(x) for x in v))
        assert [f32(g.item()) for g in got] == [f32(w) for w in want]


@pytest.mark.parametrize("momentum", ["nesterov", "linear", "genlinear"])
def test_momentum_and_stop_tol_t_equal_host_forms(momentum):
    opts = tspgm.PGMOpts(momentum=momentum, momentum_a=7.0,
                         momentum_b=3.0, auto_stop=True,
                         auto_stop_tau0=0.3)
    t, tt = f32(1.0), torch.tensor(1.0)
    tt_prev = tt
    for k in range(300):
        t = tspgm._momentum_update(opts, t, k)
        tt = tspgm.momentum_update_t(opts, tt, torch.tensor(k))
        assert f32(tt.item()) == t
        assert f32(tspgm.momentum_update_t(
            opts, tt_prev, torch.tensor(float(k))).item()) == t
        tt_prev = tt
        assert (f32(tspgm.stop_tol_t(opts, torch.tensor(k)).item())
                == f32(tspgm.stop_tol_t(opts, torch.tensor(float(k)))
                       .item())
                == tspgm.stop_tol(opts, k))
    plain = opts.replace(auto_stop=False)
    assert (f32(tspgm.stop_tol_t(plain, torch.tensor(5.0)))
            == tspgm.stop_tol(plain, 5))


def test_fft_gate_on_cpu_runs_live_plain_versions_only(monkeypatch):
    """On CPU tensors inside ``fft2_planar.gate`` a transform with live 0
    runs no plain version and returns zeros of its output's shape; with
    live 1 it is the plain version; the CPU counts no launch."""
    calls = []
    for plain in ("rfft2_planar_plain", "irfft2_planar_plain"):
        fn = getattr(tfp, plain)
        monkeypatch.setattr(tfp, plain, lambda *a, _f=fn, _n=plain, **k: (
            calls.append(_n), _f(*a, **k))[1])
    x = torch.randn((2, 128, 126), generator=torch.Generator().manual_seed(0))
    yr0, yi0 = tfp.rfft2_planar_plain(x)
    x0 = tfp.irfft2_planar_plain(yr0, yi0, 126)
    calls.clear()
    tfp.reset_launches()
    live = torch.zeros(())
    cnt = torch.zeros(2, dtype=torch.int32)
    with tfp.gate(live, cnt):
        yr, yi = tfp.rfft2_planar(x)
        xb = tfp.irfft2_planar(yr0, yi0, 126)
        xs = tfp.irfft2_spectrum(torch.complex(yr0, yi0), 126)
        assert calls == []
        for t, ref in ((yr, yr0), (yi, yi0), (xb, x0), (xs, x0)):
            assert t.shape == ref.shape and not t.any()
        live.fill_(1.0)
        yr, yi = tfp.rfft2_planar(x)
        xb = tfp.irfft2_planar(yr0, yi0, 126)
    assert calls == ["rfft2_planar_plain", "irfft2_planar_plain"]
    assert torch.equal(yr, yr0) and torch.equal(yi, yi0)
    assert torch.equal(xb, x0)
    assert cnt.tolist() == [0, 0]
    assert tfp.LAUNCHES == {"rfft2_planar": 0, "irfft2_planar": 0}


@pytest.mark.parametrize("name,fwd,inv", [("l1", 3, 1), ("gradreg", 3, 0)])
def test_planar_route_transforms_of_live_iterations_only(monkeypatch, name,
                                                         fwd, inv):
    """A fused solve on the planar FFT route on the CPU (128 x 128, the
    plain versions counted) that converges after its first iteration:
    the seven dead iterations of its block run no transform, so the
    transforms are the set-up's, the live iteration's and (l1) the final
    x-step's."""
    calls = {"rfft2_planar_plain": 0, "irfft2_planar_plain": 0}
    for plain in calls:
        fn = getattr(tfp, plain)

        def counted(*a, _f=fn, _n=plain, **k):
            calls[_n] += 1
            return _f(*a, **k)
        monkeypatch.setattr(tfp, plain, counted)
    D, S, _ = _problem(N=128)
    opt = dict(max_iter=50, rel_stop_tol=1e3)
    tsf.use_planar_fft("always")
    try:
        if name == "l1":
            b = tm.ConvBPDN(D, S, LMBDA, opt=tm.ConvBPDN.options(**opt),
                            device="cpu")
        else:
            b = tm.ConvBPDNGradReg(D, S, LMBDA, mu=0.2, device="cpu",
                                   opt=tm.ConvBPDNGradReg.options(**opt))
        b.solve()
    finally:
        tsf.use_planar_fft("auto")
    assert int(b.state.k) == 1
    assert device_loop.LAST["replays"] == 8
    assert calls == {"rfft2_planar_plain": 1 + fwd,
                     "irfft2_planar_plain": 1 + inv}
