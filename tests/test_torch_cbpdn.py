"""The port's ``ConvBPDN`` on the CPU (its kernel as the plain PyTorch
version) against the JAX package's ``ConvBPDN(fused=True)`` with the
Pallas ``csc_iter`` in interpret mode: the slice as a whole, on the same
numpy problem.

Tolerances are those of ``tests/ops/test_fused_csc.py``, which holds the
JAX kernel path against the JAX generic driver: X within 2e-4 of its
scale, ObjFun and Rho to rtol 1e-4, PrimalRsdl to rtol 1e-3.  The JAX
kernel runs its products as bf16 splits (3-pass adjoint, about 2e-5
relative), the port in fp32.
"""

import dataclasses

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from sporco_tpu import refopts as jrefopts
from sporco_tpu.models.cbpdn import ConvBPDN as JConvBPDN
from sporco_tpu.ops import pallas_csc_iter as pki
from sporco_tpu_torch import refopts
from sporco_tpu_torch.models.cbpdn import ConvBPDN, params_from_numpy

torch.set_num_threads(2)

LMBDA = 0.05


def _problem(N=64, M=4, Nd=8, seed=0, K=None):
    """A small version of the headline problem (``bench.py``)."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((Nd, Nd, M)).astype(np.float32)
    D /= np.sqrt((D ** 2).sum(axis=(0, 1), keepdims=True))
    shape = (N, N) if K is None else (N, N, K)
    S = gaussian_filter(rng.standard_normal(shape), 4.0,
                        axes=(0, 1)) * 5.0
    S += 0.1 * rng.standard_normal(shape)
    return D, S.astype(np.float32)


@pytest.fixture(scope="module")
def interpret():
    prev = pki.interpret
    pki.interpret = True
    try:
        yield
    finally:
        pki.interpret = prev


def _jax(D, S, opt, **kw):
    kw.setdefault("fused", True)
    b = JConvBPDN(D, S, LMBDA, opt=opt, **kw)
    Y = np.asarray(b.solve())
    return b, Y


def _port(D, S, opt, **kw):
    b = ConvBPDN(D, S, LMBDA, opt=opt, device="cpu", **kw)
    Y = b.solve().numpy()
    return b, Y


def _assert_close(jb, jY, tb, tY, obj_atol=0.0):
    ja, ta = jb.getitstat(), tb.getitstat()
    assert len(ja) == len(ta)
    np.testing.assert_array_equal(ja.Iter, ta.Iter)
    scale = max(np.abs(jY).max(), 1e-6)
    assert jY.shape == tY.shape
    assert np.abs(jY - tY).max() < 2e-4 * scale
    jX, tX = np.asarray(jb.state.X), tb.state.X.numpy()
    assert np.abs(jX - tX).max() < 2e-4 * max(np.abs(jX).max(), 1e-6)
    for name in ("ObjFun", "DFid", "RegL1", "Rho"):
        np.testing.assert_allclose(getattr(ta, name), getattr(ja, name),
                                   rtol=1e-4, err_msg=name,
                                   atol=obj_atol if name in (
                                       "ObjFun", "DFid") else 0.0)
    for name in ("PrimalRsdl", "DualRsdl"):
        np.testing.assert_allclose(getattr(ta, name), getattr(ja, name),
                                   rtol=1e-3, atol=1e-6, err_msg=name)
    assert np.isnan(ta.XSlvRelRes).all()


@pytest.fixture(scope="module")
def fixed_runs(interpret):
    """25 iterations at rel_stop_tol=0 in both packages, then a JAX
    warm restart of 25 more."""
    D, S = _problem()
    opt_j = JConvBPDN.options(max_iter=25, rel_stop_tol=0.0)
    opt_t = ConvBPDN.options(max_iter=25, rel_stop_tol=0.0)
    jb, jY = _jax(D, S, opt_j)
    sd = {k: np.asarray(v) for k, v in jb.state_dict().items()
          if k != "extra"}
    tb, tY = _port(D, S, opt_t)
    jY2 = np.asarray(jb.solve())
    return dict(D=D, S=S, opt_t=opt_t, jb=jb, jY=jY, tb=tb, tY=tY,
                sd=sd, jY2=jY2)


def test_fixed_iterations_match_jax(fixed_runs):
    r = fixed_runs
    # the JAX model has since been solved again; compare its first call
    # through the state dict taken after it
    tb = r["tb"]
    sd = r["sd"]
    assert int(tb.state.k) == int(sd["k"]) == 25
    its = tb.getitstat()
    ref = sd["stats"][:25]
    np.testing.assert_array_equal(its.Iter, ref[:, 0])
    np.testing.assert_allclose(its.ObjFun, ref[:, 1], rtol=1e-4)
    np.testing.assert_allclose(its.DFid, ref[:, 2], rtol=1e-4)
    np.testing.assert_allclose(its.RegL1, ref[:, 3], rtol=1e-4)
    np.testing.assert_allclose(its.PrimalRsdl, ref[:, 5], rtol=1e-3,
                               atol=1e-6)
    np.testing.assert_allclose(its.DualRsdl, ref[:, 6], rtol=1e-3,
                               atol=1e-6)
    np.testing.assert_allclose(its.Rho, ref[:, 9], rtol=1e-4)
    jY = r["jY"]
    scale = max(np.abs(jY).max(), 1e-6)
    assert r["tY"].shape == jY.shape == (64, 64, 1, 1, 4)
    assert np.abs(r["tY"] - jY).max() < 2e-4 * scale
    for name in ("X", "U"):
        a, b = tb.state_dict()[name], sd[name]
        assert np.abs(a - b).max() < 2e-4 * max(np.abs(b).max(), 1e-6)
    assert float(tb.state.rho) == pytest.approx(float(sd["rho"]),
                                                rel=1e-4)


def test_warm_restart_from_jax_state(fixed_runs):
    """A JAX state_dict() loaded into the port continues as the JAX
    model continues."""
    r = fixed_runs
    D, S = r["D"], r["S"]
    tb = ConvBPDN(D, S, LMBDA, opt=r["opt_t"], device="cpu")
    tb.load_state_dict_numpy(r["sd"])
    tY = tb.solve().numpy()
    assert int(tb.state.k) == int(r["jb"].state.k) == 50
    _assert_close(r["jb"], r["jY2"], tb, tY)


def test_reaches_same_iteration_count(interpret):
    D, S = _problem()
    jb, jY = _jax(D, S, JConvBPDN.options(max_iter=500,
                                          rel_stop_tol=1e-3))
    tb, tY = _port(D, S, ConvBPDN.options(max_iter=500, rel_stop_tol=1e-3))
    assert 0 < int(jb.state.k) < 500
    assert int(tb.state.k) == int(jb.state.k)
    _assert_close(jb, jY, tb, tY)
    # a converged state takes no further iteration in either package
    jb.solve()
    tb.solve()
    assert int(tb.state.k) == int(jb.state.k)


def test_per_filter_weights_nonneg_batch(interpret):
    """Per-filter L1 weights (the kernel's vector path), non-negativity
    and two signals."""
    D, S = _problem(N=32, K=2, seed=1)
    # reference-internal layout Nv + (C, K, M), broadcast over all but M
    wl1 = np.array([1.0, 0.5, 2.0, 1.5], np.float32).reshape(1, 1, 1, 1, 4)
    jb, jY = _jax(D, S, JConvBPDN.options(max_iter=15, rel_stop_tol=0.0),
                  wl1=wl1, non_neg=True)
    tb, tY = _port(D, S, ConvBPDN.options(max_iter=15, rel_stop_tol=0.0),
                   wl1=wl1, non_neg=True)
    _assert_close(jb, jY, tb, tY)
    assert (tY >= 0).all()


def test_params_from_numpy_match_jax():
    D, S = _problem(N=32)
    jb = JConvBPDN(D, S, None, fused=True)
    cri, params, real = params_from_numpy(D, S, device="cpu")
    assert real and dataclasses.asdict(cri) == dataclasses.asdict(jb.cri)
    for name in ("D", "S", "wl1"):
        np.testing.assert_array_equal(params[name].numpy(),
                                      np.asarray(jb.params[name]))
    assert np.float32(params["lmbda"]) == pytest.approx(
        float(jb.params["lmbda"]), rel=1e-6)
    tb = ConvBPDN(D, S, None, device="cpu")
    assert tb.lmbda == pytest.approx(jb.lmbda, rel=1e-6)
    assert float(tb.state.rho) == pytest.approx(float(jb.state.rho),
                                                rel=1e-6)
    assert float(tb.state.rho_xi) == pytest.approx(
        float(jb.state.rho_xi), rel=1e-6)


def test_state_dict_round_trip():
    D, S = _problem(N=32)
    opt = ConvBPDN.options(max_iter=6, rel_stop_tol=0.0)
    a = ConvBPDN(D, S, LMBDA, opt=opt, device="cpu")
    a.solve()
    b = ConvBPDN(D, S, LMBDA, opt=opt, device="cpu")
    b.load_state(a.state_dict())
    a.solve()
    b.solve()
    np.testing.assert_array_equal(a.getitstat().ObjFun,
                                  b.getitstat().ObjFun)
    np.testing.assert_array_equal(a.getmin().numpy(), b.getmin().numpy())


def test_reconstruct_matches_jax(interpret):
    D, S = _problem(N=32)
    jb, _ = _jax(D, S, JConvBPDN.options(max_iter=10))
    tb, _ = _port(D, S, ConvBPDN.options(max_iter=10))
    a = np.asarray(jb.reconstruct()).squeeze()
    b = tb.reconstruct().numpy()
    assert a.shape == b.shape == (32, 32)
    assert np.abs(a - b).max() < 2e-4 * np.abs(a).max()


def test_options_dict_matches_jax():
    D, S = _problem(N=32)
    opt = {"MaxMainIter": 7, "RelStopTol": 0.0, "RelaxParam": 1.5,
           "AutoRho": {"Period": 2, "RsdlRatio": 1.5},
           "NonNegCoef": True, "StatusHeader": False}
    tb = ConvBPDN(D, S, LMBDA, opt=opt, device="cpu")
    jb = JConvBPDN(D, S, LMBDA, opt=opt, fused=True)
    for f in ("max_iter", "rel_stop_tol", "relax_param", "abs_stop_tol"):
        assert getattr(tb.opts, f) == getattr(jb.opts, f)
    assert dataclasses.asdict(tb.opts.auto_rho) == \
        dataclasses.asdict(jb.opts.auto_rho)
    assert tb.cfg.non_neg and jb.cfg.non_neg
    with pytest.raises(refopts.UnknownKeyError):
        ConvBPDN(D, S, LMBDA, opt={"NoSuchKey": 1}, device="cpu")


@pytest.mark.parametrize("opt", [
    {("CBPDN", "AutoRho", "Enabled"): False,
     ("CBPDN", "AutoRho", "Period"): 7},
    {("AutoRho", "Enabled"): False, ("AutoRho", "Period"): 7},
], ids=["two_level_prefix", "one_level_prefix"])
def test_tuple_keys_expand_as_in_jax(opt):
    """Tuple keys expand as in the JAX package, whose merge is one level
    deep: of two keys sharing a two-level prefix only the later subtree
    survives (a defect of the reference that the port reproduces)."""
    assert refopts._expand_tuple_keys(opt) == \
        jrefopts._expand_tuple_keys(opt)
    if len(next(iter(opt))) == 3:
        assert refopts._expand_tuple_keys(opt) == {
            "CBPDN": {"AutoRho": {"Period": 7}}}
    else:
        assert refopts._expand_tuple_keys(opt) == {
            "AutoRho": {"Enabled": False, "Period": 7}}


def test_default_device_needs_gpu(monkeypatch):
    D, S = _problem(N=32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ConvBPDN(D, S, LMBDA)
    with pytest.raises(RuntimeError):
        ConvBPDN(D, S, LMBDA, device="cuda")


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
    raise ValueError(kind)


@pytest.mark.parametrize("kind", ["colour_signal", "colour_dict"])
def test_outside_slice_raises(kind):
    """What the JAX package runs on its fused driver by channel folding
    or with a colour dictionary, and the port's fused driver once
    refused, now takes the JAX package's route with nothing raised:
    channel folding, or the rank-C fused driver
    (``tests/test_torch_colour.py`` holds the solves against the JAX
    package)."""
    from sporco_tpu.ops import fused_csc as jfc
    from sporco_tpu_torch.ops import fused_csc as tfc
    kw = _outside(kind)
    D, S = kw.pop("D"), kw.pop("S")
    jb = JConvBPDN(D, S, LMBDA, **kw)
    tb = ConvBPDN(D, S, LMBDA, device="cpu", **kw)
    folded = jfc.cfold_eligible(jb.cfg, jb.params, jb.opts)
    assert folded == (kind == "colour_signal")
    assert jfc.eligible(jb.cfg, jb.params, jb.opts) == (not folded)
    assert tb._fused_solve is (tfc.cbpdn_solve_cfold if folded
                               else tfc.cbpdn_solve)


@pytest.mark.parametrize("kind", ["generic", "odd_size", "no_bndry",
                                  "float64", "complex", "large_support"])
def test_outside_fused_slice_solves_as_jax(kind):
    """The configurations the fused driver refuses run the generic path,
    in both packages (``torch.fft`` and ``jnp.fft`` on the CPU), and
    agree: 12 iterations at the tolerances of this file.  The data
    fidelity is a nearly cancelled difference of terms of the size of
    0.5||S||^2 (with the unnormalised 26x26 filters of ``large_support``
    it falls to 1e-4 of it), so ObjFun and DFid may also differ by 2e-6
    of that scale, a few fp32 roundings of it."""
    kw = _outside(kind)
    D, S = kw.pop("D"), kw.pop("S")
    jkw = {k: (np.float64 if v is torch.float64 else v)
           for k, v in kw.items()}
    opt = dict(max_iter=12, rel_stop_tol=0.0)
    jb, jY = _jax(D, S, JConvBPDN.options(**opt), **{"fused": "auto",
                                                     **jkw})
    tb, tY = _port(D, S, ConvBPDN.options(**opt), **kw)
    assert tb._fused_solve is None
    assert tb.state.Y.dtype == {"float64": torch.float64,
                                "complex": torch.complex64}.get(
                                    kind, torch.float32)
    _assert_close(jb, jY, tb, tY,
                  obj_atol=2e-6 * 0.5 * float(np.sum(np.abs(S) ** 2)))


@pytest.mark.parametrize("nd,force", [(8, False), (26, False), (26, True)])
def test_eligible_matches_jax(nd, force):
    """The fused driver takes what the JAX one takes, for single-channel
    problems (the support limit is a heuristic that ``force`` lifts)."""
    from sporco_tpu.ops import fused_csc as jfc
    from sporco_tpu_torch.ops import fused_csc as tfc
    rng = np.random.default_rng(2)
    D = rng.standard_normal((nd, nd, 2)).astype(np.float32)
    S = rng.standard_normal((32, 32)).astype(np.float32)
    jb = JConvBPDN(D, S, LMBDA, fused=True)
    tb = ConvBPDN(D, S, LMBDA, device="cpu", fused=True)
    assert tfc.eligible(tb.cfg, tb.params, tb.opts, force=force) == \
        jfc.eligible(jb.cfg, jb.params, jb.opts, force=force)


def test_warm_start_arrays_match_jax(interpret):
    """Y0/U0 in the reference layout start both packages alike."""
    D, S = _problem(N=32, seed=3)
    rng = np.random.default_rng(4)
    Y0 = (0.1 * rng.standard_normal((32, 32, 1, 1, 4))).astype(np.float32)
    U0 = (0.01 * rng.standard_normal((32, 32, 1, 1, 4))).astype(np.float32)
    jb, jY = _jax(D, S, JConvBPDN.options(max_iter=8, rel_stop_tol=0.0),
                  Y0=Y0, U0=U0)
    tb, tY = _port(D, S, ConvBPDN.options(max_iter=8, rel_stop_tol=0.0),
                   Y0=Y0, U0=U0)
    _assert_close(jb, jY, tb, tY)
