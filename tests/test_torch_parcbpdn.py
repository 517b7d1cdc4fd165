"""The port's ``ParConvBPDN`` (``sporco_tpu_torch/models/parcbpdn.py``)
against the JAX package's on the same seeded numpy inputs: single
process in float64 (every stats row rtol 1e-6, X within 1e-8 of its
scale), resumed from the JAX model's state, through state files either
way, filter-sharded over two gloo ranks (``tests/_torch_dist.py``), and
the planar FFT route's launches in float32.

Top-level imports are numpy, torch, pytest and the port: the ranks
import this module's helpers, never JAX."""

import numpy as np
import pytest
import torch

from sporco_tpu_torch.models import parcbpdn as tpc
from sporco_tpu_torch.ops import fft as tsf
from sporco_tpu_torch.ops import fft2_planar as tfp
from tests._torch_dist import par_problem, run_world


def _jax():
    import jax.numpy as jnp
    from sporco_tpu.models import parcbpdn as jpc
    return jpc, jnp


def _pair(kw, opt_kw=None, dt="float64", ref=None, S=None):
    """The JAX and the port model on the same problem; ``ref`` a
    reference-style option dict given to both instead of options."""
    jpc, jnp = _jax()
    D, S0, W = par_problem()
    S = S0 if S is None else S
    kw = dict(kw)
    if kw.pop("W", None) is not None:
        kw["W"] = W
    o = opt_kw or {"max_iter": 30}
    a = jpc.ParConvBPDN(D, S, 0.1, opt=ref or jpc.ParConvBPDN.options(**o),
                        ngrp=4, dtype=getattr(jnp, dt), **kw)
    b = tpc.ParConvBPDN(D, S, 0.1, opt=ref or tpc.ParConvBPDN.options(**o),
                        ngrp=4, dtype=getattr(torch, dt), device="cpu", **kw)
    return a, b


def _assert_match(a, b, rtol=1e-6, xtol=1e-8):
    ia, ib = a.getitstat(), b.getitstat()
    assert ia._names == ib._names and len(ia) == len(ib)
    for n in ia._names:
        np.testing.assert_allclose(getattr(ib, n), getattr(ia, n), rtol=rtol,
                                   err_msg=n)
    Xa, Xb = np.asarray(a.getcoef()), b.getcoef().numpy()
    assert Xb.shape == Xa.shape
    assert np.abs(Xb - Xa).max() <= xtol * np.abs(Xa).max()
    Ra, Rb = np.asarray(a.reconstruct()), b.reconstruct().numpy()
    assert np.abs(Rb - Ra).max() <= xtol * np.abs(Ra).max()


VARIANTS = {"plain": {}, "mask": {"W": True}, "non_neg": {"non_neg": True},
            "no_bndry": {"no_bndry": True}, "alpha": {"alpha": 2.0},
            "wl1": {"wl1": 0.5}}


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_matches_jax(name):
    """30 iterations of each option in float64."""
    a, b = _pair(VARIANTS[name])
    a.solve()
    b.solve()
    _assert_match(a, b)


def test_early_stop_matches_jax():
    """A solve with the mask to RelStopTol and AbsStopTol 1e-3 (unit-norm
    filters) stops at the JAX package's iteration, every row equal to
    rtol 1e-6."""
    jpc, jnp = _jax()
    D, S, W = par_problem()
    D = D / np.sqrt((D ** 2).sum(axis=(0, 1), keepdims=True))
    o = {"max_iter": 300, "rel_stop_tol": 1e-3, "abs_stop_tol": 1e-3}
    a = jpc.ParConvBPDN(D, S, 0.1, W=W, opt=jpc.ParConvBPDN.options(**o),
                        ngrp=4, dtype=jnp.float64)
    b = tpc.ParConvBPDN(D, S, 0.1, W=W, opt=tpc.ParConvBPDN.options(**o),
                        ngrp=4, dtype=torch.float64, device="cpu")
    a.solve()
    b.solve()
    assert len(b.getitstat()) < 300
    _assert_match(a, b)


def test_reference_option_dict_matches_jax():
    """The reference option keys of ``REF_OPT_EXTRA`` (``NonNegCoef``,
    ``NoBndryCross``, ``L1Weight``, ``alpha``) and the ADMM ones give the
    JAX package's run."""
    ref = {"MaxMainIter": 25, "RelStopTol": 1e-4, "NonNegCoef": True,
           "NoBndryCross": True, "L1Weight": 0.7, "alpha": 1.5,
           "RelaxParam": 1.6, "rho": 3.0, "AuxVarObj": False}
    a, b = _pair({}, ref=ref)
    assert b.cfg.non_neg and b.cfg.no_bndry and b.params["alpha"] == 1.5
    a.solve()
    b.solve()
    _assert_match(a, b)


def test_default_lmbda_and_groups_match_jax():
    """lmbda defaults to 0.1 max|D^H S|; ngrp to min(16, M), reduced to
    a divisor of M."""
    jpc, jnp = _jax()
    D, S, _ = par_problem()
    a = jpc.ParConvBPDN(D, S, ngrp=3, dtype=jnp.float64)
    b = tpc.ParConvBPDN(D, S, ngrp=3, dtype=torch.float64, device="cpu")
    assert b.ngrp == a.ngrp == 2
    np.testing.assert_allclose(b.lmbda, float(a.lmbda), rtol=1e-12)
    assert tpc.ParConvBPDN(D, S, dtype=torch.float64,
                           device="cpu").ngrp == 8


def test_resumes_jax_state():
    """The port loads the JAX model's state tuple after 10 iterations and
    runs 10 more: the same rows and X as the JAX model's second solve."""
    a, b = _pair({"W": True}, {"max_iter": 10})
    a.solve()
    b.load_state_dict_numpy([np.asarray(v) for v in a.state])
    assert int(b.state[6]) == 10
    a.solve()
    b.solve()
    assert b.k_start == 10
    _assert_match(a, b)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_state_files_across_packages(writer, tmp_path):
    """A state file written by one package after 10 iterations resumes in
    the other: 10 more iterations match the writer's own second solve."""
    a, b = _pair({}, {"max_iter": 10})
    a.solve()
    b.solve()
    path = str(tmp_path / "par.npz")
    (a if writer == "jax" else b).save_state(path)
    a2, b2 = _pair({}, {"max_iter": 10})
    if writer == "jax":
        b2.load_state_file(path)
        a.solve()
        b2.solve()
        _assert_match(a, b2)
    else:
        a2.load_state_file(path)
        b.solve()
        a2.solve()
        _assert_match(a2, b)


def test_colour_dictionary_raises():
    D = np.zeros((4, 4, 3, 8))
    S = np.zeros((16, 16, 3))
    with pytest.raises(NotImplementedError, match="multi-channel"):
        tpc.ParConvBPDN(D, S, 0.1, device="cpu")


def test_filter_sharded_matches_unsharded(tmp_path):
    """Two ranks of a 1 x 2 mesh each hold two of the four filter groups
    (float64, the mask on): every row rtol 1e-6 and X within 1e-10 of its
    scale against the unsharded run, the gathered coefficients the same
    on both ranks; each rank's device loop reads the host ceil(30 / 8) + 1
    times."""
    ranks = run_world(["par"], 2, tmp_path)["par"]
    D, S, W = par_problem()
    b = tpc.ParConvBPDN(D, S, 0.1, W=W, ngrp=4, dtype=torch.float64,
                        device="cpu", opt=tpc.ParConvBPDN.options(max_iter=30))
    X = b.solve().numpy()
    for r, out in enumerate(ranks):
        assert int(out["reads"]) == 5
        assert out["Y1"].shape[0] == 2
        np.testing.assert_array_equal(out["X"], ranks[0]["X"])
        np.testing.assert_allclose(out["rows"], b.getitstat()._arr,
                                   rtol=1e-6)
        assert np.abs(out["X"] - X).max() <= 1e-10 * np.abs(X).max()
        np.testing.assert_allclose(out["Y1"], b.state[2].numpy()[
            2 * r:2 * r + 2], rtol=0, atol=1e-10 * np.abs(X).max())
    R = b.reconstruct().numpy()
    assert np.abs(ranks[0]["recon"] - R).max() <= 1e-10 * np.abs(R).max()


def test_planar_route_matches_jax_and_counts(monkeypatch):
    """At 128x128 in float32 the port's transforms take the planar
    kernels' route (their plain versions, ``use_planar_fft("always")``):
    over k iterations ``rfft2_planar`` 2k + 1 (Y0 - U0 and Y1 - U1 an
    iteration, D once a solve) and ``irfft2_planar`` 2k (X and DX), the
    counts ``chip_smoke.py`` holds the card to; the rows match the JAX
    float32 run within 1e-4 (residuals 1e-3)."""
    counts = {"rfft2_planar": 0, "irfft2_planar": 0}
    for label, attr in (("rfft2_planar", "rfft2_planar_plain"),
                        ("irfft2_planar", "irfft2_planar_plain")):
        fn = getattr(tfp, attr)

        def counted(*a, _fn=fn, _label=label, **k):
            counts[_label] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(tfp, attr, counted)
    S = np.random.default_rng(4).standard_normal((128, 128))
    k = 5
    tsf.use_planar_fft("always")
    try:
        a, b = _pair({}, {"max_iter": k}, dt="float32", S=S)
        a.solve()
        b.solve()
    finally:
        tsf.use_planar_fft("auto")
    assert counts == {"rfft2_planar": 2 * k + 1, "irfft2_planar": 2 * k}
    ia, ib = a.getitstat(), b.getitstat()
    for n in ia._names:
        np.testing.assert_allclose(
            getattr(ib, n), getattr(ia, n),
            rtol=1e-3 if n in ("PrimalRsdl", "DualRsdl", "EPrimal",
                               "EDual") else 1e-4, err_msg=n)
