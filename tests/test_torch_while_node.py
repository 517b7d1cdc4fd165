"""The device loop's inner loops on the CPU
(``sporco_tpu_torch/ops/device_loop.py`` ``while_``, ``inner``) and the
solves built on them, against the JAX package on the same seeded numpy
inputs:

- ``while_`` outside a capture: a host loop that reads its flag before
  each pass (counted in ``LAST["flag_reads"]``) and skips unread during
  a capture's warm-up;
- conjugate gradient in a loop iteration (``ops/linalg.py`` ``cg`` under
  ``device_loop.inner``): no iteration where the loop's iteration is
  dead, its iterations added into the loop's counter;
- the CG d-steps of ``ConvCnstrMOD`` (to its stopping tolerance) and
  the masked CCMOD (30 iterations) on the graph route in float64
  against the JAX package:
  the same ADMM iterations, every row rtol 1e-6 (``Cnstr``, zero up to
  rounding, within 1e-12), D within 1e-8 of its scale, and the loop's
  count of CG iterations the sum of its CG solves'.

On the card, where ``while_`` makes WHILE nodes, ``tests/test_torch_cuda.py``
holds the captured forms against the eager ones.
"""

import numpy as np
import pytest
import torch

from sporco_tpu.models import ccmod as jcm
from sporco_tpu.models import ccmodmd as jmd
from sporco_tpu_torch.models import ccmod as tcm
from sporco_tpu_torch.models import ccmodmd as tmd
from sporco_tpu_torch.ops import device_loop
from sporco_tpu_torch.ops import linalg as tla

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# while_

@pytest.mark.parametrize("n", [0, 1, 7, 30])
def test_while_runs_its_body_while_the_flag_holds(n):
    """``n`` passes for a limit of ``n``, one flag read before each pass
    and one for the false test that ends the loop."""
    c = torch.zeros((), dtype=torch.int64)
    go = torch.tensor(n > 0)

    def body():
        c.add_(1)
        torch.lt(c, n, out=go)
    before = device_loop._FLAGS[0]
    assert device_loop.while_(go, body) == n
    assert int(c) == n and not bool(go)
    assert device_loop._FLAGS[0] - before == n + 1


def test_while_skips_unread_while_a_capture_warms_up():
    ran = []
    before = device_loop._FLAGS[0]
    device_loop._WARM[0] = True
    try:
        assert device_loop.while_(torch.tensor(True),
                                  lambda: ran.append(1)) == 0
    finally:
        device_loop._WARM[0] = False
    assert ran == [] and device_loop._FLAGS[0] == before


def test_inner_contexts_nest():
    assert device_loop.outer() is None
    a = (torch.tensor(True), torch.zeros((), dtype=torch.int64))
    b = (torch.tensor(False), torch.zeros((), dtype=torch.int64))
    with device_loop.inner(*a):
        assert device_loop.outer() == a
        with device_loop.inner(*b):
            assert device_loop.outer() == b
        assert device_loop.outer() == a
    assert device_loop.outer() is None


# ---------------------------------------------------------------------------
# cg in a loop iteration

def _spd(n=48, seed=6):
    rng = np.random.default_rng(seed)
    d = torch.tensor(rng.uniform(1.5, 3.0, n))
    b = torch.tensor(rng.standard_normal(n))
    return (lambda u: d * u - 0.5 * (u.roll(1) + u.roll(-1))), b


@pytest.mark.parametrize("live", [True, False])
def test_cg_in_a_loop_iteration_runs_where_it_is_live(live):
    """Under ``device_loop.inner``, a live iteration's cg is the plain
    call's to the bit and adds its iterations into the counter; a dead
    iteration's runs none, returns x0 and adds nothing."""
    aop, b = _spd()
    x_ref, k_ref = tla.cg(aop, b, tol=1e-10)
    passes = torch.full((), 5, dtype=torch.int64)
    with device_loop.inner(torch.tensor(live), passes):
        x, k = tla.cg(aop, b, tol=1e-10)
    assert tla.CG_LAST["form"] == "blocks" and tla.CG_LAST["host_reads"] \
        == max(1, -(-k // device_loop.UNROLL))
    if live:
        assert k == k_ref > 8 and torch.equal(x, x_ref)
        assert int(passes) == 5 + k
    else:
        assert k == 0 and torch.equal(x, torch.zeros_like(b))
        assert int(passes) == 5


# ---------------------------------------------------------------------------
# The CG d-steps on the graph route against the JAX package

MAX_ITER = 200
MD_ITERS = 30


def _ccmod_problem():
    rng = np.random.default_rng(8)
    Z = rng.standard_normal((24, 24, 1, 3, 4))
    Z *= rng.random(Z.shape) < 0.2
    S = rng.standard_normal((24, 24, 3))
    return Z, S, (5, 5, 4), rng.standard_normal((5, 5, 4))


def _ccmodmd_problem():
    # tests/test_torch_ccmodmd.py's size: 16x16, 4x4 filters, 3 filters,
    # 2 signals, a mask per pixel and signal
    rng = np.random.default_rng(0)
    S = rng.standard_normal((16, 16, 2))
    Z = rng.standard_normal((16, 16, 1, 2, 3))
    Z *= rng.random(Z.shape) < 0.2
    W = (rng.random(S.shape) > 0.25).astype(float)
    return Z, S, W, (4, 4, 3), rng.standard_normal((4, 4, 3))


def _models(kind):
    opt = dict(max_iter=MAX_ITER, rel_stop_tol=1e-4)
    if kind == "ccmodmd":
        # its dual residual stalls near 1.2-1.8 at this size, masked or
        # not and at any rho (no tolerance stops it): a fixed count
        opt = dict(max_iter=MD_ITERS, rel_stop_tol=0.0)
    if kind == "ccmod":
        Z, S, dsz, D0 = _ccmod_problem()
        a = jcm.ConvCnstrMOD(Z, S, dsz, method="cg", D0=D0,
                             dtype=np.float64, cg_tol=1e-10,
                             opt=jcm.ConvCnstrMODBase.options(**opt))
        b = tcm.ConvCnstrMOD(Z, S, dsz, method="cg", D0=D0,
                             dtype=torch.float64, cg_tol=1e-10,
                             device="cpu",
                             opt=tcm.ConvCnstrMODBase.options(**opt))
        return a, b
    Z, S, W, dsz, D0 = _ccmodmd_problem()
    a = jmd.ConvCnstrMODMaskDcpl(
        Z, S, W, dsz, method="cg", D0=D0, dtype=np.float64, cg_tol=1e-10,
        opt=jmd.ConvCnstrMODMaskDcplOptions(method="cg", **opt))
    b = tmd.ConvCnstrMODMaskDcpl(
        Z, S, W, dsz, method="cg", D0=D0, dtype=torch.float64,
        cg_tol=1e-10, device="cpu",
        opt=tmd.ConvCnstrMODMaskDcplOptions(method="cg", **opt))
    return a, b


@pytest.mark.parametrize("kind", ["ccmod", "ccmodmd"])
def test_cg_d_step_graph_route_matches_jax(kind, monkeypatch):
    """The CG d-step declares the graph route; solved to its tolerance
    (the masked one for MD_ITERS) it takes the JAX package's ADMM
    iterations, its rows and D within the
    float64 tolerances; one CG solve an iteration, their iterations the
    loop's device count, and ``ceil(k / 8) + 1`` host reads besides the
    CG solves' own (the CPU's blocks); the dead iterations of the last
    block run no CG iteration."""
    a, b = _models(kind)
    assert b.problem.route == "graph"
    seen = []
    cg = tla.cg

    def counted(*args, **kw):
        out = cg(*args, **kw)
        seen.append(dict(tla.CG_LAST))
        return out
    monkeypatch.setattr(tla, "cg", counted)
    a.solve()
    b.solve()
    ia, ib = a.getitstat(), b.getitstat()
    k = len(ib)
    assert k == len(ia) == MD_ITERS if kind == "ccmodmd" else \
        k == len(ia) < MAX_ITER
    for name in ia._names:
        if name == "Cnstr":
            np.testing.assert_allclose(ib.Cnstr, ia.Cnstr, rtol=0,
                                       atol=1e-12)
        else:
            np.testing.assert_allclose(getattr(ib, name), getattr(ia, name),
                                       rtol=1e-6, err_msg=name)
    Da, Db = np.asarray(a.getdict()), b.getdict().numpy()
    assert np.abs(Db - Da).max() <= 1e-8 * np.abs(Da).max()
    # one CG solve a replay; the dead replays after convergence run none
    its = [c["iterations"] for c in seen]
    assert len(its) == device_loop.LAST["replays"] >= k
    assert min(its[:k]) > 0 and not any(its[k:])
    assert device_loop.LAST["inner"] == sum(its)
    assert device_loop.LAST["host_reads"] == -(-k // device_loop.UNROLL) + 1
