"""The device loop's conditional blocks on the CPU
(``sporco_tpu_torch/ops/device_loop.py`` ``when``) and the loops built on
them, against the JAX package on the same seeded numpy inputs:

- the backtracking line searches of the generic FISTA driver
  (``solvers/pgm.py`` ``bt_chain``), bit for bit against the host search
  they replace and, standard and robust, against
  ``sporco_tpu.models.pgm.ConvBPDN`` in float64 (every row rtol 1e-6,
  ``IterBTrack`` equal);
- conjugate gradient in device blocks (``ops/linalg.py`` ``cg``) against
  ``sporco_tpu.ops.linalg.cg``: the same iteration count, x within 1e-12
  of its scale, one host read a block of 8 iterations;
- ``ParConvBPDN`` and the CG d-step of ``ConvCnstrMOD`` on the device
  loop: ``ceil(k / 8) + 1`` host reads a solve, ``max(1, ceil(c / 8))``
  a CG solve of c iterations.

The row-sharded solvers' reads are held in
``tests/test_torch_parallel_spatial.py`` (two gloo ranks).  On the card,
where ``when`` makes IF nodes, ``tests/test_torch_cuda.py`` holds the
graph route against the eager route.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from sporco_tpu_torch.models import ccmod as tcm
from sporco_tpu_torch.models import parcbpdn as tpc
from sporco_tpu_torch.models import pgm as tpgm
from sporco_tpu_torch.ops import device_loop
from sporco_tpu_torch.ops import linalg as tla
from sporco_tpu_torch.solvers import pgm as tspgm
from tests._torch_dist import par_problem

torch.set_num_threads(2)


def _reads(k):
    return math.ceil(k / device_loop.UNROLL) + 1


# ---------------------------------------------------------------------------
# when

def test_when_runs_the_body_where_the_flag_reads_true():
    ran = []
    before = device_loop._FLAGS[0]
    assert device_loop.when(torch.tensor(True), lambda: ran.append(1))
    assert device_loop.when(torch.tensor(False),
                            lambda: ran.append(2)) is False
    assert ran == [1]
    assert device_loop._FLAGS[0] - before == 2


def test_when_skips_unread_while_a_capture_warms_up():
    ran = []
    before = device_loop._FLAGS[0]
    device_loop._WARM[0] = True
    try:
        assert device_loop.when(torch.tensor(True),
                                lambda: ran.append(1)) is False
    finally:
        device_loop._WARM[0] = False
    assert ran == [] and device_loop._FLAGS[0] == before


def test_when_makes_nodes_only_inside_the_loops_capture():
    for kind in ("if", "while"):
        with pytest.raises(RuntimeError, match="only inside"):
            device_loop._cond_node(torch.ones((), dtype=torch.bool),
                                   lambda: None, kind)
        with pytest.raises(ValueError, match="one-element bool"):
            device_loop._cond_node(torch.ones(()), lambda: None, kind)


# ---------------------------------------------------------------------------
# The line search chain, bit for bit against the host search it replaces

def _host_search(live, trial, L, opts):
    """The eager search before the chain: one host read a trial."""
    gamma_u = tspgm._num(opts.bt_gamma_u, L.dtype)
    out = trial(L)
    ibt = 1
    while ibt < opts.bt_maxiter and bool(live & (out[-2] > out[-1])):
        L = L * gamma_u
        out = trial(L)
        ibt += 1
    return out, L, ibt


def _lasso(dtype, robust):
    """A small l1 least-squares problem and its trial at step 1/L (the
    standard trial, or the robust one with its extrapolation point)."""
    rng = np.random.default_rng(3)
    A = torch.tensor(rng.standard_normal((40, 30)), dtype=dtype)
    b = torch.tensor(rng.standard_normal(40), dtype=dtype)
    Xp = torch.tensor(rng.standard_normal(30), dtype=dtype)
    Z = torch.tensor(rng.standard_normal(30), dtype=dtype)
    Tk = torch.tensor(0.7, dtype=dtype)

    def f(x):
        r = A @ x - b
        return 0.5 * torch.sum(r * r)

    def step(y, L):
        grad = A.T @ (A @ y - b)
        v = y - grad / L
        X = torch.sign(v) * torch.clamp(torch.abs(v) - 0.1 / L, min=0.0)
        D = X - y
        Q = f(y) + torch.sum(D * grad) + (L / 2.0) * torch.sum(D * D)
        return X, grad, f(X), Q

    def trial(L):
        if not robust:
            X, _, F, Q = step(Xp, L)
            return X, F, Q
        tt = (1.0 + torch.sqrt(1.0 + 4.0 * L * Tk)) / (2.0 * L)
        TT = Tk + tt
        y = (Tk * Xp + tt * Z) / TT
        X, grad, F, Q = step(y, L)
        return X, y, grad, tt, TT, F, Q
    return trial


@pytest.mark.parametrize("robust", [False, True])
@pytest.mark.parametrize("bt_maxiter", [1, 2, 4, 50, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("live", [True, False])
def test_bt_chain_equals_host_search(robust, bt_maxiter, dtype, live):
    """The chain gives the host search's results to the bit, its L and
    its trial count, from an L that needs several trials (or stops at
    ``bt_maxiter``); a dead iteration runs the first trial only."""
    opts = tspgm.PGMOpts(backtrack="robust" if robust else "standard",
                         bt_maxiter=bt_maxiter)
    trial = _lasso(dtype, robust)
    live = torch.tensor(live)
    L0 = torch.tensor(0.3, dtype=dtype)
    ref, Lr, nr = _host_search(live, trial, L0, opts)
    out, L, ibt = tspgm.bt_chain(live, trial, L0, opts)
    assert len(out) == len(ref)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    assert torch.equal(L, Lr)
    assert int(ibt) == nr
    if not bool(live):
        assert nr == 1
    elif bt_maxiter < 5:
        assert nr == bt_maxiter
    else:
        assert 5 < nr < bt_maxiter


def test_bt_chain_copies_a_result_that_is_a_loop_tensor():
    """A trial that returns a tensor of the loop (a problem's constant)
    gets a buffer of its own: the later trials never write into it."""
    const = torch.tensor(5.0, dtype=torch.float64)
    calls = []

    def trial(L):
        calls.append(float(L))
        return const, L * 2.0, torch.zeros((), dtype=torch.float64)
    opts = tspgm.PGMOpts(backtrack="standard", bt_maxiter=3)
    out, L, ibt = tspgm.bt_chain(torch.tensor(True), trial,
                                 torch.tensor(1.0, dtype=torch.float64),
                                 opts, T={"c": const})
    assert out[0] is not const and float(const) == 5.0
    assert int(ibt) == 3 and len(calls) == 3


# ---------------------------------------------------------------------------
# Backtracking FISTA against the JAX package, to convergence

def _fista_data():
    rng = np.random.default_rng(11)
    D = rng.standard_normal((6, 6, 6)).astype(np.float32)
    D /= np.sqrt((D ** 2).sum(axis=(0, 1), keepdims=True))
    S = gaussian_filter(rng.standard_normal((40, 40)), 3.0) * 5.0
    return D, (S + 0.1 * rng.standard_normal((40, 40))).astype(np.float32)


@pytest.mark.parametrize("backtrack", ["standard", "robust"])
def test_backtracking_fista_matches_jax_and_reads_once_a_block(backtrack):
    """The generic FISTA with each line search, float64, to its stopping
    tolerance: the JAX package's iterations, every row rtol 1e-6 and
    ``IterBTrack`` equal, X within 1e-8 of its scale; the graph route;
    ``ceil(k / 8) + 1`` host reads and one flag read a trial (a search
    of n trials reads its test n times: n - 1 passes and the false
    one)."""
    from sporco_tpu.models import pgm as jpgm
    D, S = _fista_data()
    opt = dict(max_iter=250, rel_stop_tol=1e-2, backtrack=backtrack)
    j = jpgm.ConvBPDN(D, S, 0.05, opt=jpgm.ConvBPDN.options(L=0.2, **opt),
                      dtype=np.float64, fused=False)
    jX = np.asarray(j.solve())
    t = tpgm.ConvBPDN(D, S, 0.05, opt=tpgm.ConvBPDN.options(L=0.2, **opt),
                      dtype=torch.float64, fused=False, device="cpu")
    tX = t.solve().numpy()
    ja, ta = j.getitstat(), t.getitstat()
    k = len(ta)
    assert k == len(ja) < opt["max_iter"]
    for name in ja._names:
        np.testing.assert_allclose(getattr(ta, name), getattr(ja, name),
                                   rtol=1e-6, err_msg=name)
    np.testing.assert_array_equal(ta.IterBTrack, ja.IterBTrack)
    assert ta.IterBTrack.max() > 1
    assert np.abs(tX - jX).max() <= 1e-8 * np.abs(jX).max()
    assert tspgm.pgm_route(t.problem, t.opts) == "graph"
    assert device_loop.LAST["host_reads"] == _reads(k)
    # the dead iterations of the last block read one false flag each
    dead = -k % device_loop.UNROLL
    ibt = ta.IterBTrack.astype(int)
    assert device_loop.LAST["flag_reads"] == int(ibt.sum()) + dead


@pytest.mark.parametrize("bt_maxiter", [64, 65, 200])
def test_long_line_search_takes_the_graph_route(bt_maxiter):
    """A line search of any length is one inner loop (a WHILE node on the
    card): the route is the problem's, the graph route, and a problem
    declared eager keeps its route."""
    D, S = _fista_data()
    t = tpgm.ConvBPDN(D, S, 0.05, opt=tpgm.ConvBPDN.options(
        backtrack="standard", bt_maxiter=bt_maxiter), fused=False,
        device="cpu")
    assert tspgm.pgm_route(t.problem, t.opts) == "graph"
    t.problem = dataclasses.replace(t.problem, route="eager")
    assert tspgm.pgm_route(t.problem, t.opts) == "eager"
    t = tpgm.ConvBPDN(D, S, 0.05, opt=tpgm.ConvBPDN.options(), fused=False,
                      device="cpu")
    assert tspgm.pgm_route(t.problem, t.opts) == "graph"


# ---------------------------------------------------------------------------
# Conjugate gradient in device blocks

def _circulant(n, seed):
    """A well-conditioned SPD operator of exact elementwise arithmetic
    (the same in both packages): a diagonal in [1.5, 3] less half the
    two neighbours, circularly; its diagonal preconditioner; a right-hand
    side."""
    rng = np.random.default_rng(seed)
    return rng.uniform(1.5, 3.0, n), rng.standard_normal(n)


@pytest.mark.parametrize("tol,max_iter", [(1e-2, 1000), (1e-8, 1000),
                                          (1e-12, 1000), (1e-12, 16),
                                          (1e-12, 9)])
@pytest.mark.parametrize("precond", [False, True])
def test_cg_blocks_match_jax(tol, max_iter, precond):
    """The iteration count of the JAX ``cg`` and x within 1e-12 of its
    scale, float64; one read a block of 8 iterations."""
    import jax.numpy as jnp
    from sporco_tpu.ops import linalg as jla
    d, b = _circulant(64, 2)

    def aop(xp, dd):
        return lambda u: dd * u - 0.5 * (xp.roll(u, 1) + xp.roll(u, -1))
    td, jd = torch.tensor(d), jnp.asarray(d)
    mt = (lambda r: r / td) if precond else None
    mj = (lambda r: r / jd) if precond else None
    xa, ka = tla.cg(aop(torch, td), torch.tensor(b), tol=tol,
                    max_iter=max_iter, m_inv=mt)
    xb, kb = jla.cg(aop(jnp, jd), jnp.asarray(b), tol=tol,
                    max_iter=max_iter, m_inv=mj)
    assert ka == int(kb) > 0
    xb = np.asarray(xb)
    assert np.abs(xa.numpy() - xb).max() <= 1e-12 * np.abs(xb).max()
    assert tla.CG_LAST["iterations"] == ka
    assert tla.CG_LAST["host_reads"] == tla.CG_LAST["blocks"] == max(
        1, math.ceil(ka / 8))
    assert not tla.CG_LAST["graph"]


def test_cg_solved_at_the_start_reads_once():
    x, k = tla.cg(lambda u: 2.0 * u, torch.zeros(10, dtype=torch.float64))
    assert k == 0 and torch.equal(x, torch.zeros(10, dtype=torch.float64))
    assert tla.CG_LAST["host_reads"] == 1


def test_ccmod_cg_d_step_reads_once_a_block(monkeypatch):
    """The CG method of ConvCnstrMOD (float64): every CG solve of c
    iterations reads max(1, ceil(c / 8)) times, and the result is the ISM
    method's within 1e-8."""
    rng = np.random.default_rng(8)
    Z = rng.standard_normal((24, 24, 1, 3, 4))
    Z *= rng.random(Z.shape) < 0.2
    S = rng.standard_normal((24, 24, 3))
    D0 = rng.standard_normal((5, 5, 4))
    seen = []
    cg = tla.cg

    def counted(*a, **k):
        out = cg(*a, **k)
        seen.append(dict(tla.CG_LAST))
        return out
    monkeypatch.setattr(tla, "cg", counted)
    res = {}
    for method in ("cg", "ism"):
        b = tcm.ConvCnstrMOD(
            Z, S, (5, 5, 4), method=method, D0=D0, dtype=torch.float64,
            device="cpu", cg_tol=1e-10,
            opt=tcm.ConvCnstrMODBase.options(max_iter=12, rel_stop_tol=0.0))
        b.solve()
        res[method] = b.getdict().numpy()
    assert len(seen) == 12
    assert max(c["iterations"] for c in seen) > 8
    for c in seen:
        assert c["host_reads"] == max(1, math.ceil(c["iterations"] / 8))
    assert np.abs(res["cg"] - res["ism"]).max() < 1e-8 * np.abs(
        res["ism"]).max()


# ---------------------------------------------------------------------------
# ParConvBPDN on the device loop

@pytest.mark.parametrize("masked", [False, True])
def test_parcbpdn_matches_jax_and_reads_once_a_block(masked):
    """ParConvBPDN to its stopping tolerance in float64 against the JAX
    model: the same iterations, every row rtol 1e-6, X within 1e-8 of its
    scale; ``ceil(k / 8) + 1`` host reads; a second solve of the same
    model resumes on the kept loop."""
    import jax.numpy as jnp
    from sporco_tpu.models import parcbpdn as jpc
    D, S, W = par_problem()
    D = D / np.sqrt((D ** 2).sum(axis=(0, 1), keepdims=True))
    kw = {"W": W} if masked else {}
    o = {"max_iter": 300, "rel_stop_tol": 1e-3, "abs_stop_tol": 1e-3}
    a = jpc.ParConvBPDN(D, S, 0.1, opt=jpc.ParConvBPDN.options(**o), ngrp=4,
                        dtype=jnp.float64, **kw)
    b = tpc.ParConvBPDN(D, S, 0.1, opt=tpc.ParConvBPDN.options(**o), ngrp=4,
                        dtype=torch.float64, device="cpu", **kw)
    a.solve()
    b.solve()
    ia, ib = a.getitstat(), b.getitstat()
    k = len(ib)
    assert k == len(ia) < o["max_iter"]
    for n in ia._names:
        np.testing.assert_allclose(getattr(ib, n), getattr(ia, n),
                                   rtol=1e-6, err_msg=n)
    Xa, Xb = np.asarray(a.getcoef()), b.getcoef().numpy()
    assert np.abs(Xb - Xa).max() <= 1e-8 * np.abs(Xa).max()
    assert device_loop.LAST["host_reads"] == _reads(k)
    assert device_loop.LAST["flag_reads"] == 0
    # converged: a second call runs no block and reads once
    b.solve()
    assert len(b.getitstat()) == 0
    assert device_loop.LAST["host_reads"] == 1
