"""Masked CSC by Additive Mask Simulation in the port on the CPU (its
kernels as their plain PyTorch versions) against the JAX package on the
same numpy problems: ``AddMaskSim`` over ``ConvBPDN``,
``ConvElasticNet`` and ``ConvBPDNGradReg``, fused (the fused driver's
``body`` with the AMS form of the tail kernel ``admm_tail``) and
``fused=False`` (the generic y-step); a colour dictionary and a grey
dictionary on a colour image, which both packages send to the generic
path; a per-image mask; and ``admm_tail_plain`` in its AMS form against
the JAX fused driver's XLA tail.  These mirror
``tests/ops/test_fused_csc.py:288,336`` and
``tests/models/test_cbpdn.py:333``.

The JAX fused driver runs AMS on its ``body`` with the XLA tail whatever
its kernel switches say, so no switch is set here.  Tolerances are
those of ``tests/test_torch_fused_variants.py``: the same iteration
count; Y, X and U within 2e-4 of their largest magnitude; ObjFun, DFid,
RegL1 and Rho rtol 1e-4; RegL2 and RegGrad rtol 1e-3 (atol 1e-6); the
residuals rtol 1e-3 (atol 1e-6).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp
from scipy.ndimage import gaussian_filter

from sporco_tpu.models import cbpdn as jm
from sporco_tpu.ops import fused_csc as jfc
from sporco_tpu_torch.models import cbpdn as tm
from sporco_tpu_torch.ops import csc_tail as tct
from sporco_tpu_torch.ops import fused_csc as tfc

torch.set_num_threads(2)

LMBDA = 0.1
ITERS = 12


def _problem(N=32, M=4, Nd=8, seed=0, C=None, Cd=None, K=None):
    """A small version of the headline problem with a mask that drops
    about a quarter of the pixels; ``C`` image channels, ``Cd``
    dictionary channels, ``K`` images."""
    rng = np.random.default_rng(seed)
    dshape = (Nd, Nd) + ((Cd,) if Cd else ()) + (M,)
    D = rng.standard_normal(dshape).astype(np.float32)
    D /= np.sqrt((D ** 2).sum(axis=(0, 1), keepdims=True))
    extra = tuple(v for v in (C, K) if v)
    S = gaussian_filter(rng.standard_normal((N, N) + extra),
                        (4.0, 4.0) + (0.0,) * len(extra)) * 5.0
    S += 0.1 * rng.standard_normal(S.shape)
    W = (rng.random((N, N) + extra) > 0.25).astype(np.float32)
    return D, S.astype(np.float32), W


def _filter_w(w):
    """Per-filter weights in the user layout ``Nv + (C, K, M)``."""
    return np.array(w, np.float32).reshape(1, 1, 1, 1, -1)


# name -> (model class, problem arguments, constructor arguments)
VARIANTS = {
    "l1": ("ConvBPDN", {}, {}),
    "l1_nonneg_wl1": ("ConvBPDN", {}, dict(non_neg=True,
                                           wl1=_filter_w([1.0, 0.5, 2.0,
                                                          1.5]))),
    "elastic": ("ConvElasticNet", {}, dict(mu=0.05)),
    "gradreg": ("ConvBPDNGradReg", {}, dict(mu=0.2)),
    # GradWeight sized for the AMS-extended dictionary (M + 1), none on
    # the impulse map (examples/csc_ams_gradreg.py:41-52)
    "gradreg_wgrd": ("ConvBPDNGradReg", {},
                     dict(mu=0.2, wgrd=np.array([1.0, 0.5, 2.0, 0.2, 0.0],
                                                np.float32))),
    "l1_per_image": ("ConvBPDN", dict(K=2), dict(dimK=1)),
    "l1_spatial_wl1": ("ConvBPDN", {}, dict(
        wl1=(0.5 + np.random.default_rng(3).random((32, 32, 1, 1, 4))
             ).astype(np.float32))),
}

# the generic path only (both packages' eligibility excludes them)
GENERIC_ONLY = {
    "colour_dict": ("ConvBPDN", dict(C=3, Cd=3), {}),
    "colour_dict_spatial_mask": ("ConvBPDN", dict(C=3, Cd=3), {}),
    "grey_on_colour": ("ConvBPDN", dict(C=3), dict(dimK=0)),
    "elastic_grey_on_colour": ("ConvElasticNet", dict(C=3),
                               dict(mu=0.05, dimK=0)),
}


def _case(name):
    if name in VARIANTS:
        return VARIANTS[name]
    return GENERIC_ONLY[name]


def _mask(name, W):
    # a mask shared by the channels: the spatial (N, N) mask
    return W[..., 0] if name == "colour_dict_spatial_mask" else W


_RUNS = {}


def _jax_run(name, fused):
    key = ("jax", name, fused)
    if key not in _RUNS:
        cls, pkw, kw = _case(name)
        D, S, W = _problem(**pkw)
        jcls = getattr(jm, cls)
        jb = jm.AddMaskSim(jcls, D, S, _mask(name, W), LMBDA,
                           opt=jcls.options(max_iter=ITERS,
                                            rel_stop_tol=0.0),
                           fused=fused, **kw)
        Y = np.asarray(jb.solve())
        inner = jb.cbpdn
        _RUNS[key] = (jb.getitstat(), Y, np.asarray(inner.state.X),
                      np.asarray(inner.state.U), jb)
    return _RUNS[key]


def _port_run(name, fused):
    key = ("port", name, fused)
    if key not in _RUNS:
        cls, pkw, kw = _case(name)
        D, S, W = _problem(**pkw)
        tcls = getattr(tm, cls)
        calls = {"tail": 0, "tail_ams": 0, "tail_ops_ams": 0}

        def tail(*a, **k):
            calls["tail"] += 1
            calls["tail_ams"] += k.get("ams") is not None
            return admm_tail(*a, **k)

        def ops(*a, **k):
            calls["tail_ops_ams"] += k.get("ams") is not None
            return tail_ops(*a, **k)
        admm_tail, tail_ops = tct.admm_tail, tfc.tail_ops
        mp = pytest.MonkeyPatch()
        try:
            mp.setattr(tct, "admm_tail", tail)
            mp.setattr(tfc, "tail_ops", ops)
            tb = tm.AddMaskSim(tcls, D, S, _mask(name, W), LMBDA,
                               opt=tcls.options(max_iter=ITERS,
                                                rel_stop_tol=0.0),
                               fused=fused, device="cpu", **kw)
            Y = tb.solve().numpy()
        finally:
            mp.undo()
        inner = tb.cbpdn
        _RUNS[key] = (tb.getitstat(), Y, inner.state.X.numpy(),
                      inner.state.U.numpy(), tb, calls)
    return _RUNS[key]


def _assert_runs_close(j, t):
    ja, jY, jX, jU = j[:4]
    ta, tY, tX, tU = t[:4]
    assert len(ta) == len(ja) == ITERS
    np.testing.assert_array_equal(ta.Iter, ja.Iter)
    for name, a, b in (("Y", tY, jY), ("X", tX, jX), ("U", tU, jU)):
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 2e-4 * max(np.abs(b).max(), 1e-6), \
            name
    names = set(ja._names)
    assert set(ta._names) == names
    for name in ("ObjFun", "DFid", "RegL1", "Rho"):
        np.testing.assert_allclose(getattr(ta, name), getattr(ja, name),
                                   rtol=1e-4, err_msg=name)
    for name in ("RegL2", "RegGrad"):
        if name in names:
            np.testing.assert_allclose(getattr(ta, name),
                                       getattr(ja, name), rtol=1e-3,
                                       atol=1e-6, err_msg=name)
    for name in ("PrimalRsdl", "DualRsdl"):
        np.testing.assert_allclose(getattr(ta, name), getattr(ja, name),
                                   rtol=1e-3, atol=1e-6, err_msg=name)


@pytest.mark.parametrize("name", list(VARIANTS))
def test_fused_ams_matches_jax(name):
    """The fused AMS solve: the port's route is the fused driver with the
    AMS form of ``admm_tail`` once per iteration (the torch-op tail for a
    spatial weight), as the JAX package's is its fused driver."""
    j, t = _jax_run(name, True), _port_run(name, True)
    jb, tb, calls = j[4], t[4], t[5]
    assert jfc.eligible(jb.cbpdn.cfg, jb.cbpdn.params, jb.cbpdn.opts)
    assert tb.cbpdn.cfg.ams_nimp == 1
    assert tb.cbpdn._fused_solve is tfc.cbpdn_solve
    if name == "l1_spatial_wl1":
        assert calls == {"tail": 0, "tail_ams": 0, "tail_ops_ams": ITERS}
    else:
        assert calls == {"tail": ITERS, "tail_ams": ITERS,
                         "tail_ops_ams": 0}
    _assert_runs_close(j, t)


@pytest.mark.parametrize("name", list(VARIANTS) + list(GENERIC_ONLY))
def test_generic_ams_matches_jax(name):
    """``fused=False``, and the configurations both packages send to the
    generic path whatever ``fused`` says: the AMS y-step there."""
    fused = "auto" if name in GENERIC_ONLY else False
    j, t = _jax_run(name, fused), _port_run(name, fused)
    assert t[4].cbpdn._fused_solve is None
    assert t[5] == {"tail": 0, "tail_ams": 0, "tail_ops_ams": 0}
    _assert_runs_close(j, t)


@pytest.mark.parametrize("name", list(GENERIC_ONLY))
def test_ams_not_fused_where_jax_is_not(name):
    """A colour dictionary and a folded colour image never take the fused
    driver under AMS, in either package."""
    jb = _jax_run(name, "auto")[4]
    tb = _port_run(name, "auto")[4]
    cfg, params, opts = tb.cbpdn.cfg, tb.cbpdn.params, tb.cbpdn.opts
    assert not tfc.eligible(cfg, params, opts)
    assert not tfc.cfold_eligible(cfg, params, opts)
    assert not jfc.eligible(jb.cbpdn.cfg, jb.cbpdn.params, jb.cbpdn.opts)
    assert not jfc.cfold_eligible(jb.cbpdn.cfg, jb.cbpdn.params,
                                  jb.cbpdn.opts)
    with pytest.raises(ValueError, match="fused=True"):
        cls, pkw, kw = GENERIC_ONLY[name]
        D, S, W = _problem(**pkw)
        tm.AddMaskSim(getattr(tm, cls), D, S, _mask(name, W), LMBDA,
                      fused=True, device="cpu", **kw)


def test_addmasksim_layout_and_reconstruct():
    """The impulse maps are dropped from the coefficients, the mask and
    the l1 weight take the JAX package's internal layout, and the
    reconstruction uses the dictionary filters' maps alone."""
    D, S, W = _problem(C=3, Cd=3)
    opt = tm.ConvBPDN.options(max_iter=ITERS, rel_stop_tol=0.0)
    jb = jm.AddMaskSim(jm.ConvBPDN, D, S, W, LMBDA, opt=opt)
    tb = tm.AddMaskSim(tm.ConvBPDN, D, S, W, LMBDA, opt=opt,
                       device="cpu")
    np.testing.assert_array_equal(tb.Wams.numpy(), np.asarray(jb.Wams))
    np.testing.assert_array_equal(tb.cbpdn.params["wl1"].numpy(),
                                  np.asarray(jb.cbpdn.params["wl1"]))
    jX, tX = np.asarray(jb.solve()), tb.solve().numpy()
    assert tX.shape == jX.shape and tX.shape[-1] == D.shape[-1]
    assert np.abs(tX - jX).max() <= 2e-4 * np.abs(jX).max()
    jS, tS = np.asarray(jb.reconstruct()), tb.reconstruct().numpy()
    assert tS.shape == jS.shape == S.shape
    assert np.abs(tS - jS).max() <= 2e-4 * np.abs(jS).max()


def test_addmasksim_lifts_l1weight_from_dict():
    """A reference-style option dict's ``L1Weight`` of length M is lifted
    out and padded with the impulse map's 0, as the JAX package does."""
    D, S, W = _problem()
    w = np.array([1.0, 0.5, 2.0, 1.5], np.float32)
    opt = {"MaxMainIter": 5, "RelStopTol": 0.0, "L1Weight": w}
    jb = jm.AddMaskSim(jm.ConvBPDN, D, S, W, LMBDA, opt=dict(opt))
    tb = tm.AddMaskSim(tm.ConvBPDN, D, S, W, LMBDA, opt=dict(opt),
                       device="cpu")
    want = np.asarray(jb.cbpdn.params["wl1"])
    np.testing.assert_array_equal(tb.cbpdn.params["wl1"].numpy(), want)
    assert want.reshape(-1).tolist() == [1.0, 0.5, 2.0, 1.5, 0.0]
    jX, tX = np.asarray(jb.solve()), tb.solve().numpy()
    assert np.abs(tX - jX).max() <= 2e-4 * np.abs(jX).max()


def _jax_xla_tail(PX, PY, PU, thr, wl1p, rlx, nonneg, Wp, imp_sel):
    """The JAX fused driver's XLA tail with its AMS select
    (``sporco_tpu/ops/fused_csc.py:809-823``), on the true dual."""
    AX = rlx * PX + (1.0 - rlx) * PY
    AXU = AX + PU
    PYn = jnp.sign(AXU) * jnp.maximum(jnp.abs(AXU) - thr, 0.0)
    if nonneg:
        PYn = jnp.maximum(PYn, 0.0)
    PYn = jnp.where(imp_sel, (1.0 - Wp) * AXU, PYn)
    PUn = PU + AX - PYn
    return PYn, PUn, [jnp.sum((PX - PYn) ** 2), jnp.sum((PYn - PY) ** 2),
                      jnp.sum(PX ** 2), jnp.sum(PYn ** 2),
                      jnp.sum(PUn ** 2), jnp.sum(jnp.abs(wl1p * PX))]


@pytest.mark.parametrize("nonneg", [False, True])
@pytest.mark.parametrize("K,M", [(1, 5), (2, 3), (1, 65)])
def test_admm_tail_plain_ams_matches_jax_tail(K, M, nonneg):
    """``admm_tail_plain`` with ``ams=(Wp, 1)`` (the mask packed as
    ``(R, PS^2)`` by ``ams_mask``) against the JAX tail on the full
    packed mask ``Wp = pack_state(Wams)``: PYn and PUn bit for bit, the
    sums to 1e-6 relative (float64 against float32 sums)."""
    rng = np.random.default_rng(K * 100 + M)
    N = 16
    PS = tfc.PS
    R, C = K * (N // PS) ** 2, PS * PS * M
    PX = rng.standard_normal((R, C)).astype(np.float32)
    PY = (rng.standard_normal((R, C))
          * (rng.random((R, C)) < 0.1)).astype(np.float32)
    PU = (0.05 * rng.standard_normal((R, C))).astype(np.float32)
    W = (rng.random((K, 1, 1, N, N)) > 0.3).astype(np.float32)
    wl1 = np.ones(M, np.float32)
    wl1[-1] = 0.0
    wl1p = np.tile(wl1, PS * PS)
    thr = np.float32(0.05) * wl1p
    us, rlx = np.float32(0.9), np.float32(1.8)
    Wp_full = np.asarray(jfc.pack_state(jnp.broadcast_to(
        jnp.asarray(W), (K, 1, M, N, N)))).reshape(R, C)
    sel = np.zeros((PS * PS, M), bool)
    sel[:, -1] = True
    jY, jU, jsums = _jax_xla_tail(jnp.asarray(PX), jnp.asarray(PY),
                                  us * jnp.asarray(PU), jnp.asarray(thr),
                                  jnp.asarray(wl1p), rlx, nonneg,
                                  jnp.asarray(Wp_full),
                                  jnp.asarray(sel.reshape(-1)))
    Wp = tfc.ams_mask(torch.as_tensor(W), K, (N, N))
    assert tuple(Wp.shape) == (R, PS * PS)
    # copies: the tail writes PY and PU in place, and the JAX arrays may
    # share the numpy buffers and be computed after this call
    tY, tU, tsums = tct.admm_tail_plain(
        torch.as_tensor(PX), torch.tensor(PY), torch.tensor(PU),
        torch.as_tensor(thr), torch.as_tensor(wl1p), rlx, nonneg=nonneg,
        us=us, ams=(Wp, 1))
    np.testing.assert_array_equal(tY.numpy(), np.asarray(jY))
    np.testing.assert_array_equal(tU.numpy(), np.asarray(jU))
    np.testing.assert_allclose(tsums.numpy(),
                               np.array([float(v) for v in jsums]),
                               rtol=1e-5)


def test_admm_tail_ams_checks_its_mask():
    """The AMS form's mask must have a row per packed row and a column
    count that divides C; ``nimp`` must fit the filters."""
    PX = torch.zeros(4, 12)
    with pytest.raises(ValueError):
        tct.admm_tail_plain(PX, PX.clone(), PX.clone(), 0.1, 1.0, 1.8,
                            ams=(torch.zeros(4, 5), 1))
    with pytest.raises(ValueError):
        tct._check_ams((torch.zeros(4, 3), 5), 4, 12, PX.device)
    assert tct._check_ams((torch.zeros(4, 3), 1), 4, 12,
                          PX.device)[1:] == (4, 1)
