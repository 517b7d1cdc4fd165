"""The port's FISTA ``ConvBPDN``/``ConvBPDNMask`` on the CPU (the kernel
as its plain PyTorch version) against the JAX package's
``models.pgm`` on the same numpy problem: the slice as a whole, on the
kernel route (the JAX Pallas ``pgm_iter`` in interpret mode) and on the
generic packed route (backtracking, step-size policies, monotone,
spatial ``L1Weight``), with the PGM solver, model, layouts and option
keys piece by piece.

Tolerances are those of ``tests/ops/test_fused_csc.py:644-646``, which
holds the JAX kernel path against the JAX generic path: X within 2e-4
of its scale, ObjFun (and DFid, RegL1) rtol 1e-4, Rsdl rtol 1e-3 /
atol 1e-6.  The JAX kernel runs its products as bf16 splits (3-pass
adjoint, about 2e-5 relative), the port in fp32.
"""

import contextlib
import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy.ndimage import gaussian_filter

from sporco_tpu import cnvrep as jcr
from sporco_tpu import refopts as jrefopts
from sporco_tpu.models import pgm as jpgm
from sporco_tpu.ops import fused_csc as jfc
from sporco_tpu.ops import pallas_csc_iter as pki
from sporco_tpu.solvers import pgm as jspgm
from sporco_tpu_torch import cnvrep as tcr
from sporco_tpu_torch.models import pgm as tpgm
from sporco_tpu_torch.ops import fused_csc as tfc
from sporco_tpu_torch.ops import pgm_iter as tpi
from sporco_tpu_torch.solvers import pgm as tspgm

torch.set_num_threads(2)

LMBDA = 0.05
N, M = 64, 4


def _problem(N=N, M=M, Nd=8, seed=0, K=None):
    """A small version of the headline problem (``bench.py``)."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((Nd, Nd, M)).astype(np.float32)
    D /= np.sqrt((D ** 2).sum(axis=(0, 1), keepdims=True))
    shape = (N, N) if K is None else (N, N, K)
    S = gaussian_filter(rng.standard_normal(shape), 4.0,
                        axes=(0, 1)) * 5.0
    S += 0.1 * rng.standard_normal(shape)
    return D, S.astype(np.float32)


def _mask(shape, seed=7, missing=0.3):
    rng = np.random.default_rng(seed)
    return (rng.random(shape) >= missing).astype(np.float32)


@pytest.fixture(scope="module")
def interpret():
    prev = pki.interpret
    pki.interpret = True
    try:
        yield
    finally:
        pki.interpret = prev


def _solve_both(D, S, masked=False, **kw):
    """Solve with both packages; ``kw`` are constructor arguments, with
    ``opt`` given as a dict of PGMOpts fields."""
    opt = kw.pop("opt")
    jcls = jpgm.ConvBPDNMask if masked else jpgm.ConvBPDN
    tcls = tpgm.ConvBPDNMask if masked else tpgm.ConvBPDN
    jb = jcls(D, S, LMBDA, opt=jcls.options(**opt), **kw)
    jX = np.asarray(jb.solve())
    tb = tcls(D, S, LMBDA, opt=tcls.options(**opt), device="cpu", **kw)
    tX = tb.solve().numpy()
    return jb, jX, tb, tX


def _assert_close(jb, jX, tb, tX):
    ja, ta = jb.getitstat(), tb.getitstat()
    assert len(ja) == len(ta) > 0
    np.testing.assert_array_equal(ta.Iter, ja.Iter)
    assert tX.shape == jX.shape
    scale = max(np.abs(jX).max(), 1e-6)
    assert np.abs(tX - jX).max() < 2e-4 * scale
    for name in ("Y", "Xprv"):
        a = getattr(tb.state, name).numpy()
        b = np.asarray(getattr(jb.state, name))
        assert np.abs(a - b).max() < 2e-4 * max(np.abs(b).max(), 1e-6), \
            name
    for name in ("ObjFun", "DFid", "RegL1"):
        np.testing.assert_allclose(getattr(ta, name), getattr(ja, name),
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(ta.Rsdl, ja.Rsdl, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(ta.L, ja.L, rtol=1e-4)
    np.testing.assert_array_equal(ta.IterBTrack, ja.IterBTrack)
    for name in ("F_Btrack", "Q_Btrack"):
        np.testing.assert_allclose(getattr(ta, name), getattr(ja, name),
                                   rtol=1e-4, err_msg=name)
    assert float(tb.state.t) == pytest.approx(float(jb.state.t), rel=1e-6)
    assert int(tb.state.k) == int(jb.state.k)


# ---------------------------------------------------------------------------
# the kernel route

@pytest.fixture(scope="module")
def fixed_runs(interpret):
    """25 iterations at rel_stop_tol=0 in both packages (default L), the
    JAX state_dict() taken after them, then a JAX warm restart of 25
    more."""
    D, S = _problem()
    jb, jX, tb, tX = _solve_both(D, S, opt=dict(max_iter=25,
                                                rel_stop_tol=0.0))
    assert tfc._pgm_kernel_eligible(tb.cfg, tb.params, tb.opts)
    assert jfc._pgm_kernel_eligible(jb.cfg, jb.params, jb.opts)
    sd = {k: np.asarray(v) for k, v in jb.state_dict().items()}
    jits = jb.getitstat()
    jstate = jb.state
    jX2 = np.asarray(jb.solve())
    return dict(D=D, S=S, jb=jb, jX=jX, jits=jits, jstate=jstate, tb=tb,
                tX=tX, sd=sd, jX2=jX2)


def test_kernel_route_matches_jax(fixed_runs):
    r = fixed_runs
    tb, sd, ja = r["tb"], r["sd"], r["jits"]
    ta = tb.getitstat()
    assert int(tb.state.k) == int(sd["k"]) == 25
    assert r["tX"].shape == r["jX"].shape == (N, N, 1, 1, M)
    np.testing.assert_array_equal(ta.Iter, ja.Iter)
    for name in ("ObjFun", "DFid", "RegL1"):
        np.testing.assert_allclose(getattr(ta, name), getattr(ja, name),
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(ta.Rsdl, ja.Rsdl, rtol=1e-3, atol=1e-6)
    np.testing.assert_array_equal(ta.L, ja.L)
    np.testing.assert_array_equal(ta.IterBTrack, np.zeros(25))
    assert np.isnan(ta.F_Btrack).all() and np.isnan(ta.Q_Btrack).all()
    assert np.abs(r["tX"] - r["jX"]).max() < 2e-4 * np.abs(r["jX"]).max()
    for name in ("Y", "Xprv"):
        a, b = tb.state_dict()[name], sd[name]
        assert np.abs(a - b).max() < 2e-4 * np.abs(b).max(), name
    # the momentum scalar t is float32 in the JAX package's order
    assert np.float32(tb.state.t) == np.float32(sd["t"])
    assert np.float32(tb.state.L) == np.float32(sd["L"])
    np.testing.assert_array_equal(tb.state_dict()["Gprv"], sd["Gprv"])
    np.testing.assert_array_equal(tb.state_dict()["Zrb"], sd["Zrb"])


def test_warm_restart_from_jax_state(fixed_runs):
    """A JAX state_dict() loaded into the port continues as the JAX
    model continues."""
    r = fixed_runs
    tb = tpgm.ConvBPDN(r["D"], r["S"], LMBDA,
                       opt=tpgm.ConvBPDN.options(max_iter=25,
                                                 rel_stop_tol=0.0),
                       device="cpu")
    tb.load_state_dict_numpy(r["sd"])
    tX = tb.solve().numpy()
    assert int(tb.state.k) == int(r["jb"].state.k) == 50
    _assert_close(r["jb"], r["jX2"], tb, tX)


@pytest.mark.parametrize("momentum", ["nesterov", "linear", "genlinear"])
def test_momentum_matches_jax(interpret, momentum):
    D, S = _problem(seed=1)
    _assert_close(*_solve_both(D, S, opt=dict(max_iter=20, rel_stop_tol=0.0,
                                              L=50.0, momentum=momentum)))


def _kernel_case(kind):
    """(D, S, masked, constructor keywords) of a kernel-route case."""
    wl1 = np.array([1.0, 0.5, 2.0, 1.5], np.float32).reshape(1, 1, 1, 1, 4)
    if kind == "masked":
        D, S = _problem(seed=2)
        return D, S, True, dict(W=_mask((N, N)))
    if kind == "nonneg_wl1_K2":
        D, S = _problem(seed=3, K=2)
        return D, S, False, dict(wl1=wl1, non_neg=True)
    if kind == "masked_nonneg_wl1_K2":
        D, S = _problem(seed=4, K=2)
        return D, S, True, dict(W=_mask((N, N, 2)), wl1=wl1, non_neg=True)
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["masked", "nonneg_wl1_K2",
                                  "masked_nonneg_wl1_K2"])
def test_kernel_route_variants_match_jax(interpret, kind):
    """Masked input, non-negativity, per-filter L1 weights (the kernel's
    vector path) and two signals."""
    D, S, masked, kw = _kernel_case(kind)
    jb, jX, tb, tX = _solve_both(D, S, masked=masked,
                                 opt=dict(max_iter=20, rel_stop_tol=0.0,
                                          L=50.0), **kw)
    assert tfc._pgm_kernel_eligible(tb.cfg, tb.params, tb.opts)
    assert jfc._pgm_kernel_eligible(jb.cfg, jb.params, jb.opts)
    _assert_close(jb, jX, tb, tX)
    if kw.get("non_neg"):
        assert (tX >= 0).all()


def test_reaches_same_iteration_count(interpret):
    """At L = 50 and tolerance 0.03 on Rsdl the JAX solve stops at
    iteration 46 of 500; every Rsdl up to the crossing stays at least 1%
    away from the tolerance (the stated margin, ten times the Rsdl
    tolerance of the comparison), so the port must stop at the same
    iteration."""
    D, S = _problem()
    tol, margin = 0.03, 1e-2
    jb, jX, tb, tX = _solve_both(D, S, opt=dict(max_iter=500,
                                                rel_stop_tol=tol, L=50.0))
    rs = jb.getitstat().Rsdl
    assert 0 < int(jb.state.k) < 500
    assert rs[-1] < tol and (rs[:-1] >= tol).all()
    assert np.min(np.abs(rs / tol - 1.0)) >= margin
    _assert_close(jb, jX, tb, tX)
    # a converged state takes no further iteration in either package
    jb.solve()
    tb.solve()
    assert int(tb.state.k) == int(jb.state.k)


def test_fast_solve_and_auto_stop_match_jax(interpret):
    D, S = _problem(seed=5)
    jb, jX, tb, tX = _solve_both(D, S, opt=dict(
        max_iter=300, L=50.0, auto_stop=True, auto_stop_tau0=0.5,
        fast_solve=True))
    assert 0 < int(jb.state.k) < 300
    assert np.isnan(tb.getitstat().ObjFun).all()
    jits, tits = jb.getitstat(), tb.getitstat()
    assert len(jits) == len(tits)
    np.testing.assert_allclose(tits.Rsdl, jits.Rsdl, rtol=1e-3, atol=1e-6)
    assert np.abs(tX - jX).max() < 2e-4 * np.abs(jX).max()


# ---------------------------------------------------------------------------
# the generic packed route

def _generic_case(kind):
    """PGMOpts fields and constructor keywords of a generic-route case;
    the starting L of each is chosen so that its line search or policy
    has work to do."""
    rng = np.random.default_rng(8)
    base = dict(max_iter=20, rel_stop_tol=0.0)
    if kind == "standard":
        return dict(base, backtrack="standard", L=1.0), {}
    if kind == "robust":
        return dict(base, backtrack="robust", bt_gamma_u=2.0, L=50.0), {}
    if kind == "cauchy":
        return dict(base, stepsize="cauchy", L=50.0), {}
    if kind == "bb":
        return dict(base, stepsize="bb", L=50.0), {}
    if kind == "monotone":
        return dict(base, monotone=True, L=5.0), {}
    if kind == "spatial_wl1":
        wl1 = rng.uniform(0.5, 1.5, (N, N, M)).astype(np.float32)
        return dict(base, L=50.0), dict(wl1=wl1)
    if kind == "masked_standard":
        return (dict(base, backtrack="standard", L=1.0),
                dict(W=_mask((N, N))))
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["standard", "robust", "cauchy", "bb",
                                  "monotone", "spatial_wl1",
                                  "masked_standard"])
def test_generic_route_matches_jax(kind):
    D, S = _problem(seed=6)
    opt, kw = _generic_case(kind)
    masked = "W" in kw
    jb, jX, tb, tX = _solve_both(D, S, masked=masked, opt=opt, **kw)
    assert not tfc._pgm_kernel_eligible(tb.cfg, tb.params, tb.opts)
    assert not jfc._pgm_kernel_eligible(jb.cfg, jb.params, jb.opts)
    _assert_close(jb, jX, tb, tX)
    its = tb.getitstat()
    if "standard" in kind:
        assert its.IterBTrack.max() > 1      # the line search ran
    if kind in ("cauchy", "bb", "robust"):
        assert len(set(its.L.tolist())) > 1  # L moved


def test_generic_route_warm_restart_from_jax_state():
    """Robust backtracking carries Zrb, Tk and Gprv across calls."""
    D, S = _problem(seed=9)
    opt = dict(max_iter=10, rel_stop_tol=0.0, backtrack="robust", L=50.0)
    jb = jpgm.ConvBPDN(D, S, LMBDA, opt=jpgm.ConvBPDN.options(**opt))
    jb.solve()
    sd = {k: np.asarray(v) for k, v in jb.state_dict().items()}
    jX = np.asarray(jb.solve())
    tb = tpgm.ConvBPDN(D, S, LMBDA, opt=tpgm.ConvBPDN.options(**opt),
                       device="cpu")
    tb.load_state_dict_numpy(sd)
    tX = tb.solve().numpy()
    _assert_close(jb, jX, tb, tX)
    assert float(tb.state.Tk) == pytest.approx(float(jb.state.Tk),
                                               rel=1e-4)


# ---------------------------------------------------------------------------
# pieces: solver scalars, layouts, problem functions, options

@pytest.mark.parametrize("momentum", ["nesterov", "linear", "genlinear"])
def test_momentum_update_bit_identical(momentum):
    """t and beta = (t_prv - 1) / t in float32, exactly as the JAX
    package computes them, over 200 iterations."""
    jo = jspgm.PGMOpts(momentum=momentum, momentum_a=7.0, momentum_b=3.0)
    to = tspgm.PGMOpts(momentum=momentum, momentum_a=7.0, momentum_b=3.0)
    jt, tt = jnp.asarray(1.0, jnp.float32), np.float32(1.0)
    for k in range(200):
        jn = jspgm._momentum_update(jo, jt, jnp.asarray(k, jnp.int32))
        tn = tspgm._momentum_update(to, tt, k)
        assert np.float32(tn) == np.float32(jn)
        assert (np.float32((tt - np.float32(1.0)) / tn)
                == np.float32((jt - 1.0) / jn))
        jt, tt = jn, tn


@pytest.mark.parametrize("masked", [False, True])
def test_packed_problem_functions_match_jax(masked):
    """Gradient, data term, regulariser, prox and Hessian product of the
    fused packed problem on the same packed state."""
    D, S = _problem(N=32, K=2, seed=10)
    W = _mask((32, 32, 2)) if masked else None
    jcls = jpgm.ConvBPDNMask if masked else jpgm.ConvBPDN
    tcls = tpgm.ConvBPDNMask if masked else tpgm.ConvBPDN
    kw = dict(W=W) if masked else {}
    jb = jcls(D, S, LMBDA, **kw)
    tb = tcls(D, S, LMBDA, device="cpu", **kw)
    rng = np.random.default_rng(11)
    Xp = (rng.standard_normal((2, 4, 4, 64 * M))
          * (rng.random((2, 4, 4, 64 * M)) < 0.3)).astype(np.float32)
    jaux = jfc._pgm_aux(jb.cfg, jb.params)
    taux = tfc._pgm_aux(tb.cfg, tb.params)
    jX, tX = jnp.asarray(Xp), torch.tensor(Xp)
    L = np.float32(7.5)

    def rel(a, b):
        a, b = np.asarray(a), np.asarray(b)
        return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)
    g = tfc._pgm_grad(tb.cfg, taux, tb.params, tX)
    assert rel(g.numpy(), jfc._pgm_grad(jb.cfg, jaux, jb.params, jX)) \
        <= 1e-5
    assert rel(tfc._pgm_hess(tb.cfg, taux, tb.params, tX).numpy(),
               jfc._pgm_hess(jb.cfg, jaux, jb.params, jX)) <= 1e-5
    assert rel(tfc._pgm_prox(tb.cfg, taux, tb.params, tX, L).numpy(),
               jfc._pgm_prox(jb.cfg, jaux, jb.params, jX, L)) <= 1e-6
    for a, b in zip(tfc._pgm_obfn(tb.cfg, taux, tb.params, tX),
                    jfc._pgm_obfn(jb.cfg, jaux, jb.params, jX)):
        assert float(a) == pytest.approx(float(b), rel=1e-5)
    assert float(tfc._pgm_g(tb.cfg, taux, tb.params, tX)) == \
        pytest.approx(float(jfc._pgm_g(jb.cfg, jaux, jb.params, jX)),
                      rel=1e-5)


@pytest.mark.parametrize("kind", ["scalar", "per_filter", "spatial"])
def test_packed_l1_weight_matches_jax(kind):
    D, S = _problem(N=32, K=2)
    rng = np.random.default_rng(12)
    wl1 = {"scalar": np.float32(1.5),
           "per_filter": rng.uniform(0.5, 1.5, (1, 1, 1, 1, M)).astype(
               np.float32),
           "spatial": rng.uniform(0.5, 1.5, (32, 32, 2, M)).astype(
               np.float32)}[kind]
    jb = jpgm.ConvBPDN(D, S, LMBDA, wl1=wl1)
    tb = tpgm.ConvBPDN(D, S, LMBDA, wl1=wl1, device="cpu")
    np.testing.assert_array_equal(tb.params["wl1"].numpy(),
                                  np.asarray(jb.params["wl1"]))
    a = tfc._packed_l1_weight(tb.params["wl1"], tb.cri)
    b = np.asarray(jfc._packed_l1_weight(jb.params["wl1"], jb.cri))
    np.testing.assert_array_equal(np.asarray(a), b)


@pytest.mark.parametrize("wshape", [(), (32, 32), (32, 32, 2),
                                    (32, 32, 1, 2), (32, 32, 1, 2, 1)])
def test_fidelity_mask_matches_jax(wshape):
    D, S = _problem(N=32, K=2)
    cri = tcr.csc_index(D.shape, S.shape)
    W = _mask(wshape) if wshape else np.float32(0.5)
    got = tcr.fidelity_mask(torch.tensor(W), cri).numpy()
    ref = np.asarray(jcr.fidelity_mask(jnp.asarray(W),
                                       jcr.csc_index(D.shape, S.shape)))
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


def test_params_from_numpy_match_jax():
    D, S = _problem(N=32, K=2)
    W = _mask((32, 32))
    jb = jpgm.ConvBPDNMask(D, S, None, W=W)
    cri, params, real = tpgm.params_from_numpy(D, S, W=W, device="cpu")
    assert real and dataclasses.asdict(cri) == dataclasses.asdict(jb.cri)
    for name in ("D", "S", "wl1", "W"):
        np.testing.assert_array_equal(params[name].numpy(),
                                      np.asarray(jb.params[name]))
    assert np.float32(params["lmbda"]) == pytest.approx(
        float(jb.params["lmbda"]), rel=1e-6)
    tb = tpgm.ConvBPDNMask(D, S, None, W=W, device="cpu")
    assert tb.lmbda == pytest.approx(jb.lmbda, rel=1e-6)
    assert np.float32(tb.state.L) == np.float32(jb.state.L) == 500.0
    st_t, st_j = tb.state_dict(), jb.state_dict()
    assert set(st_t) == set(st_j)
    for k in st_j:
        np.testing.assert_array_equal(st_t[k], np.asarray(st_j[k]), k)


def test_state_buffers_are_distinct():
    """X, Y, Xprv and Zrb never share storage, fresh or loaded: the
    fused loop updates packed copies in place."""
    D, S = _problem(N=32)
    tb = tpgm.ConvBPDN(D, S, LMBDA, device="cpu")

    def ptrs():
        return {getattr(tb.state, n).data_ptr()
                for n in ("X", "Y", "Xprv", "Gprv", "Zrb")}
    assert len(ptrs()) == 5
    tb.load_state_dict_numpy(tb.state_dict())
    assert len(ptrs()) == 5
    tb.solve()
    assert tb.state.X.data_ptr() != tb.state.Xprv.data_ptr()


def test_state_dict_round_trip():
    D, S = _problem(N=32)
    opt = tpgm.ConvBPDN.options(max_iter=6, rel_stop_tol=0.0)
    a = tpgm.ConvBPDN(D, S, LMBDA, opt=opt, device="cpu")
    a.solve()
    b = tpgm.ConvBPDN(D, S, LMBDA, opt=opt, device="cpu")
    b.load_state(a.state_dict())
    a.solve()
    b.solve()
    np.testing.assert_array_equal(a.getitstat().ObjFun,
                                  b.getitstat().ObjFun)
    np.testing.assert_array_equal(a.getmin().numpy(), b.getmin().numpy())


def test_reconstruct_and_setdict_match_jax(interpret):
    D, S = _problem(N=32)
    opt = dict(max_iter=10, L=50.0)
    jb, jX, tb, tX = _solve_both(D, S, opt=opt)
    a = np.asarray(jb.reconstruct()).squeeze()
    b = tb.reconstruct().numpy()
    assert a.shape == b.shape == (32, 32)
    assert np.abs(a - b).max() < 2e-4 * np.abs(a).max()
    np.testing.assert_array_equal(tb.getcoef().numpy(), tX)
    assert tb.getcoef_internal() is tb.state.X
    D2 = np.ascontiguousarray(D[::-1])
    jb.setdict(D2)
    tb.setdict(D2)
    np.testing.assert_array_equal(tb.params["D"].numpy(),
                                  np.asarray(jb.params["D"]))
    tb2 = tpgm.ConvBPDN(D, S, LMBDA, device="cpu")
    tb2.setdict(internal=tb.params["D"])
    np.testing.assert_array_equal(tb2.params["D"].numpy(),
                                  tb.params["D"].numpy())


# Reference strategy objects are matched by class name (sporco/pgm/
# momentum.py, stepsize.py, backtrack.py); these stand in for them.
class MomentumGenLinear:
    def __init__(self, a, b):
        self.a, self.b = a, b


class MomentumLinear:
    def __init__(self, b):
        self.b = b


class StepSizePolicyBB:
    pass


class BacktrackRobust:
    def __init__(self, gamma_u, maxiter):
        self.gamma_u, self.maxiter = gamma_u, maxiter


@pytest.mark.parametrize("opt", [
    {"MaxMainIter": 7, "RelStopTol": 0.0, "L": 30.0, "Momentum": "linear",
     "Backtrack": "standard", "NonNegCoef": True, "StatusHeader": False},
    {"Momentum": MomentumGenLinear(20.0, 4.0),
     "StepSizePolicy": StepSizePolicyBB(), "Monotone": True,
     "AutoStop": {"Enabled": True, "Tau0": 0.2},
     "L1Weight": np.float32(0.5)},
    {"Backtrack": BacktrackRobust(2.0, 9), "FastSolve": True,
     ("AutoStop", "Enabled"): True, ("AutoStop", "Tau0"): 0.3},
], ids=["names", "objects", "tuple_keys"])
def test_options_dict_matches_jax(opt):
    D, S = _problem(N=32)
    tb = tpgm.ConvBPDN(D, S, LMBDA, opt=opt, device="cpu")
    jb = jpgm.ConvBPDN(D, S, LMBDA, opt=opt)
    ta, ja = dataclasses.asdict(tb.opts), dataclasses.asdict(jb.opts)
    ta.pop("dtype")
    ja.pop("dtype")
    assert ta == ja
    assert tb.cfg.non_neg == jb.cfg.non_neg
    np.testing.assert_array_equal(tb.params["wl1"].numpy(),
                                  np.asarray(jb.params["wl1"]))
    # the masked class takes model keys through its **kw
    tm = tpgm.ConvBPDNMask(D, S, LMBDA, W=_mask((32, 32)),
                           opt={"NonNegCoef": True}, device="cpu")
    assert tm.cfg.non_neg and tm.cfg.masked


def test_momentum_linear_object_matches_jax(interpret):
    """A ``MomentumLinear(b=5)`` object: the option translator of both
    packages reads only its ``a`` (``sporco_tpu/refopts.py:111-115``), so
    both run linear momentum with the default b = 2 (the fault on record
    in ROADMAP queue 3).  The port keeps the JAX package's result: the
    same options, the same t and beta = (t_prv - 1) / t sequence to the
    last bit, and the same stats rows."""
    D, S = _problem(N=32, seed=8)
    opt = {"Momentum": MomentumLinear(b=5.0), "MaxMainIter": 20,
           "RelStopTol": 0.0, "L": 50.0}
    jb = jpgm.ConvBPDN(D, S, LMBDA, opt=dict(opt))
    tb = tpgm.ConvBPDN(D, S, LMBDA, opt=dict(opt), device="cpu")
    assert tb.opts.momentum == jb.opts.momentum == "linear"
    assert tb.opts.momentum_b == jb.opts.momentum_b == 2.0
    jt, tt = jnp.asarray(1.0, jnp.float32), np.float32(1.0)
    for k in range(20):
        jn = jspgm._momentum_update(jb.opts, jt, jnp.asarray(k, jnp.int32))
        tn = tspgm._momentum_update(tb.opts, tt, k)
        assert np.float32(tn) == np.float32(jn)
        assert (np.float32((tt - np.float32(1.0)) / tn)
                == np.float32((jt - 1.0) / jn))
        jt, tt = jn, tn
    jX = np.asarray(jb.solve())
    tX = tb.solve().numpy()
    assert np.float32(tb.state.t) == np.float32(jb.state.t) == np.float32(tt)
    _assert_close(jb, jX, tb, tX)


def test_float64_scalars_follow_the_problem_type():
    """A float64 FISTA problem with backtracking keeps its host scalars in
    float64, as the JAX package's ``pgm_init_state`` (``rdt``) does: the
    final t, L and Rsdl and the stats' L column agree with the JAX
    package's to 1e-12 relative, which float32 scalars miss by about
    1e-8.  The problem is the float64 case of
    :func:`test_outside_fused_slice_solves_as_jax` (the generic FFT
    problem)."""
    D, S = _problem(N=32)
    opt = dict(max_iter=20, rel_stop_tol=0.0, backtrack="standard", L=1.0)
    jb = jpgm.ConvBPDN(D, S, LMBDA, opt=jpgm.ConvBPDN.options(**opt),
                       dtype=np.float64)
    jb.solve()
    tb = tpgm.ConvBPDN(D, S, LMBDA, opt=tpgm.ConvBPDN.options(**opt),
                       dtype=torch.float64, device="cpu")
    tb.solve()
    assert tb._fused_solve is None
    assert int(tb.state.k) == int(jb.state.k) == 20
    for name in ("t", "L", "rsdl", "Tk", "objprv"):
        v = getattr(tb.state, name)
        assert isinstance(v, np.float64), name
    for name in ("t", "L", "rsdl"):
        got, ref = float(getattr(tb.state, name)), float(getattr(jb.state,
                                                                 name))
        assert got == pytest.approx(ref, rel=1e-12, abs=0.0), name
    ja, ta = jb.getitstat(), tb.getitstat()
    assert ja.L.max() > 1.0          # the line search raised L
    np.testing.assert_allclose(ta.L, ja.L, rtol=1e-12, atol=0.0)
    np.testing.assert_array_equal(ta.IterBTrack, ja.IterBTrack)


def test_unknown_option_keys_raise():
    from sporco_tpu_torch import refopts
    D, S = _problem(N=32)
    for opt in ({"NoSuchKey": 1}, {"AutoStop": {"Nope": 1}},
                {"Momentum": object()}):
        with pytest.raises(refopts.UnknownKeyError):
            tpgm.ConvBPDN(D, S, LMBDA, opt=opt, device="cpu")
        with pytest.raises(jrefopts.UnknownKeyError):
            jpgm.ConvBPDN(D, S, LMBDA, opt=opt)


# ---------------------------------------------------------------------------
# what the slice does not take

@pytest.mark.parametrize("nd,n,no_bndry", [(8, 32, False), (26, 32, False),
                                           (8, 36, False), (8, 32, True)])
def test_eligible_matches_jax(nd, n, no_bndry):
    """The fused problem takes what the JAX one takes, for single-channel
    problems."""
    rng = np.random.default_rng(2)
    D = rng.standard_normal((nd, nd, 2)).astype(np.float32)
    S = rng.standard_normal((n, n)).astype(np.float32)
    jb = jpgm.ConvBPDN(D, S, LMBDA, no_bndry=no_bndry)
    cfg = tpgm.PGMCSCConfig(cri=tcr.csc_index(D.shape, S.shape),
                            no_bndry=no_bndry)
    assert tfc.pgm_eligible(cfg, tpgm.ConvBPDN.options()) == \
        jfc.pgm_eligible(jb.cfg, jb.params, jb.opts)


def _outside(kind):
    D, S = _problem(N=32)
    rng = np.random.default_rng(0)
    if kind == "colour_signal":
        return dict(D=D, S=np.repeat(S[..., None], 3, axis=-1), dimK=0)
    if kind == "colour_dict":
        Dc = rng.standard_normal((8, 8, 3, 4)).astype(np.float32)
        return dict(D=Dc, S=np.repeat(S[..., None], 3, axis=-1), dimK=0)
    if kind == "generic":
        return dict(D=D, S=S, fused=False)
    if kind == "odd_size":
        return dict(D=D, S=S[:30, :30])
    if kind == "no_bndry":
        return dict(D=D, S=S, no_bndry=True)
    if kind == "float64":
        return dict(D=D, S=S, dtype=torch.float64)
    if kind == "complex":
        return dict(D=D.astype(np.complex64), S=S)
    if kind == "large_support":
        Dl = rng.standard_normal((26, 26, 2)).astype(np.float32)
        return dict(D=Dl, S=S)
    if kind == "one_dim":
        return dict(D=D[:, 0], S=S[:, 0], dimN=1)
    raise ValueError(kind)


@pytest.mark.parametrize("cls", ["ConvBPDN", "ConvBPDNMask"])
@pytest.mark.parametrize("kind", ["colour_signal", "colour_dict"])
def test_outside_slice_raises(cls, kind):
    """What the JAX package runs on its fused problem by channel folding
    or with a colour dictionary, and the port's fused problem once
    refused, now takes the JAX package's route with nothing raised
    (``tests/test_torch_colour.py`` holds the solves against the JAX
    package)."""
    kw = _outside(kind)
    D, S = kw.pop("D"), kw.pop("S")
    jb = getattr(jpgm, cls)(D, S, LMBDA, **kw)
    tb = getattr(tpgm, cls)(D, S, LMBDA, device="cpu", **kw)
    folded = jfc.pgm_cfold_eligible(jb.cfg, jb.params, jb.opts)
    assert folded == (kind == "colour_signal")
    assert jfc.pgm_eligible(jb.cfg, jb.params, jb.opts) == (not folded)
    assert tb._fused_solve is (tfc.pgm_cbpdn_solve_cfold if folded
                               else tfc.pgm_cbpdn_solve)


@pytest.mark.parametrize("cls", ["ConvBPDN", "ConvBPDNMask"])
@pytest.mark.parametrize("kind", ["generic", "odd_size", "no_bndry",
                                  "float64", "complex", "large_support",
                                  "one_dim"])
def test_outside_fused_slice_solves_as_jax(cls, kind):
    """The configurations the fused problem refuses run the generic FFT
    problem in both packages (``torch.fft`` and ``jnp.fft`` on the CPU)
    and agree over 10 iterations; a complex ``D`` loses its imaginary
    part in both and runs the fused problem."""
    kw = _outside(kind)
    D, S = kw.pop("D"), kw.pop("S")
    jkw = {k: (np.float64 if v is torch.float64 else v)
           for k, v in kw.items()}
    if cls == "ConvBPDNMask":
        W = _mask(S.shape)
        jkw["W"] = kw["W"] = W
    opt = dict(max_iter=10, rel_stop_tol=0.0)
    jcls, tcls = getattr(jpgm, cls), getattr(tpgm, cls)
    with pytest.warns(np.exceptions.ComplexWarning) if kind == "complex" \
            else contextlib.nullcontext():
        jb = jcls(D, S, LMBDA, opt=jcls.options(**opt), **jkw)
    jX = np.asarray(jb.solve())
    tb = tcls(D, S, LMBDA, opt=tcls.options(**opt), device="cpu", **kw)
    tX = tb.solve().numpy()
    assert (tb._fused_solve is not None) == (kind == "complex")
    _assert_close(jb, jX, tb, tX)


def test_default_device_needs_gpu(monkeypatch):
    D, S = _problem(N=32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpgm.ConvBPDN(D, S, LMBDA)
    with pytest.raises(RuntimeError):
        tpgm.ConvBPDNMask(D, S, LMBDA, device="cuda")


def test_cpu_solve_launches_no_kernel():
    D, S = _problem(N=32)
    tpi.reset_launches()
    tpgm.ConvBPDN(D, S, LMBDA, opt=tpgm.ConvBPDN.options(max_iter=3),
                  device="cpu").solve()
    assert tpi.LAUNCHES["pgm_iter"] == 0
