"""The fused driver's ``body`` and the elastic ``body_pk`` of the port on
the CPU (its kernels as their plain PyTorch versions) against the JAX
package on the same numpy problems: ``ConvBPDNGradReg`` (scalar and
per-filter GradWeight), ``ConvElasticNet`` and ``l1`` with a spatially
varying ``L1Weight``; the generic ``elastic`` and ``gradreg`` problems;
``gradient_filters``; and the fused driver's eligibility rule.

The JAX fused driver runs in each of its routes: ``body`` with its
Pallas tail in interpret mode (``pallas_csc_tail.enabled``) and with
its XLA tail, and, for the elastic net, ``body_pk`` with the Pallas
``csc_iter`` in interpret mode.  The port routes as it does on the
card: ``csc_iter`` for ``l1``/``elastic`` with a scalar or per-filter
weight, the tail kernel ``admm_tail`` for ``gradreg`` at any layout
(also where the JAX package's TPU block rule sends its own to the XLA
tail: an odd filter count, a packed row count that is not a multiple
of 8), the torch-op tail for a spatial weight.

Tolerances are those of ``tests/ops/test_fused_csc.py:275-335`` and
``:377-400``, which hold the JAX fused routes against the JAX generic
driver: the same iteration count; X (and Y, U) within 2e-4 of its
largest magnitude; ObjFun, DFid, RegL1 and Rho rtol 1e-4; RegL2 and
RegGrad rtol 1e-3 (atol 1e-6); the residuals rtol 1e-3 (atol 1e-6).
"""

import contextlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy.ndimage import gaussian_filter

from sporco_tpu.models import cbpdn as jm
from sporco_tpu.ops import fused_csc as jfc
from sporco_tpu.ops import pallas_csc_iter as pki
from sporco_tpu.ops import pallas_csc_tail as ptail
from sporco_tpu.utils import signal as jsig
from sporco_tpu_torch.models import cbpdn as tm
from sporco_tpu_torch.ops import csc_tail as tct
from sporco_tpu_torch.ops import fused_csc as tfc
from sporco_tpu_torch.utils import signal as tsig

torch.set_num_threads(2)

LMBDA = 0.1
ITERS = 12


def _problem(N=32, M=4, Nd=8, seed=0):
    """A small version of the headline problem (``bench.py``)."""
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((Nd, Nd, M)).astype(np.float32)
    D /= np.sqrt((D ** 2).sum(axis=(0, 1), keepdims=True))
    S = gaussian_filter(rng.standard_normal((N, N)), 4.0) * 5.0
    S += 0.1 * rng.standard_normal((N, N))
    return D, S.astype(np.float32)


def _spatial_wl1(N, M, seed=1):
    return (0.5 + np.random.default_rng(seed).random((N, N, M))
            ).astype(np.float32)


def _filter_w(w):
    """Per-filter weights in the user layout ``Nv + (C, K, M)``."""
    return np.array(w, np.float32).reshape(1, 1, 1, 1, -1)


# name -> (model class, N, M, constructor arguments, the port's route)
VARIANTS = {
    "gradreg": ("ConvBPDNGradReg", 32, 4, dict(mu=0.2), "tail"),
    "gradreg_wgrd": ("ConvBPDNGradReg", 64, 8,
                     dict(mu=0.2, wgrd=np.array(
                         [1.0, 0.5, 2.0, 0.0, 1.0, 1.5, 0.25, 1.0],
                         np.float32)), "tail"),
    "gradreg_wgrd_wl1_nonneg": ("ConvBPDNGradReg", 32, 4,
                                dict(mu=0.2, non_neg=True,
                                     wgrd=np.array([1.0, 1.0, 1.0, 0.0],
                                                   np.float32),
                                     wl1=_filter_w([1.0, 1.0, 1.0, 0.0])),
                                "tail"),
    # layouts outside the JAX package's tail_eligible: C = 192 (odd M),
    # and 25 packed rows
    "gradreg_odd_m": ("ConvBPDNGradReg", 32, 3, dict(mu=0.2), "tail"),
    "gradreg_wgrd_pos25": ("ConvBPDNGradReg", 40, 4,
                           dict(mu=0.2, wgrd=np.array([1.0, 0.5, 2.0, 0.0],
                                                      np.float32)),
                           "tail"),
    "elastic": ("ConvElasticNet", 32, 4, dict(mu=0.05), "csc_iter"),
    "elastic_wl1_nonneg": ("ConvElasticNet", 64, 4,
                           dict(mu=0.05, non_neg=True,
                                wl1=_filter_w([0.5, 1.0, 1.5, 2.0])),
                           "csc_iter"),
    "l1_spatial_wl1": ("ConvBPDN", 32, 4, dict(wl1=_spatial_wl1(32, 4)),
                       "tail_ops"),
    "elastic_spatial_wl1": ("ConvElasticNet", 32, 4,
                            dict(mu=0.05, wl1=_spatial_wl1(32, 4, 2)),
                            "tail_ops"),
    "gradreg_spatial_wl1": ("ConvBPDNGradReg", 32, 4,
                            dict(mu=0.2, wl1=_spatial_wl1(32, 4, 3)),
                            "tail_ops"),
}


@contextlib.contextmanager
def _jax_route(mode):
    """The JAX fused driver's route: ``body`` with the Pallas tail
    (``tail_on``) or the XLA tail (``tail_off``), or ``body_pk``."""
    prev = (ptail.enabled, ptail.interpret, pki.interpret)
    ptail.enabled = mode == "tail_on"
    ptail.interpret = True
    pki.interpret = mode == "body_pk"
    jax.clear_caches()
    try:
        yield
    finally:
        ptail.enabled, ptail.interpret, pki.interpret = prev
        jax.clear_caches()


_RUNS = {}


def _jax_run(name, mode, fused=True):
    key = ("jax", name, mode, fused)
    if key not in _RUNS:
        cls, N, M, kw, _ = VARIANTS[name]
        D, S = _problem(N, M)
        jcls = getattr(jm, cls)
        with _jax_route(mode):
            jb = jcls(D, S, LMBDA, opt=jcls.options(max_iter=ITERS,
                                                    rel_stop_tol=0.0),
                      fused=fused, **kw)
            Y = np.asarray(jb.solve())
        _RUNS[key] = (jb.getitstat(), Y, np.asarray(jb.state.X),
                      np.asarray(jb.state.U))
    return _RUNS[key]


def _port_run(name, fused="auto"):
    key = ("port", name, fused)
    if key not in _RUNS:
        cls, N, M, kw, _ = VARIANTS[name]
        D, S = _problem(N, M)
        tcls = getattr(tm, cls)
        calls = {"csc_iter": 0, "tail": 0, "tail_ops": 0}

        def counted(fn, key):
            def wrapper(*a, **k):
                calls[key] += 1
                return fn(*a, **k)
            return wrapper
        mp = pytest.MonkeyPatch()
        try:
            mp.setattr(tfc, "csc_iter", counted(tfc.csc_iter, "csc_iter"))
            mp.setattr(tct, "admm_tail", counted(tct.admm_tail, "tail"))
            mp.setattr(tfc, "tail_ops", counted(tfc.tail_ops, "tail_ops"))
            tb = tcls(D, S, LMBDA, opt=tcls.options(max_iter=ITERS,
                                                    rel_stop_tol=0.0),
                      fused=fused, device="cpu", **kw)
            Y = tb.solve().numpy()
        finally:
            mp.undo()
        _RUNS[key] = (tb.getitstat(), Y, tb.state.X.numpy(),
                      tb.state.U.numpy(), calls, tb)
    return _RUNS[key]


def _assert_runs_close(j, t, same_x=True):
    """``same_x`` False: the two runs define the returned X differently
    (``body`` returns the last iteration's x-step, ``body_pk`` the x-step
    at the final Y, U and rho), so X is not compared."""
    ja, jY, jX, jU = j
    ta, tY, tX, tU = t[:4]
    assert len(ta) == len(ja) == ITERS
    np.testing.assert_array_equal(ta.Iter, ja.Iter)
    assert tX.shape == jX.shape
    for name, a, b in (("Y", tY, jY), ("X", tX, jX), ("U", tU, jU)):
        if name == "X" and not same_x:
            continue
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
    for name in ("EPrimal", "EDual"):
        np.testing.assert_allclose(getattr(ta, name), getattr(ja, name),
                                   rtol=1e-3, err_msg=name)
    assert np.isnan(ta.XSlvRelRes).all() and np.isnan(ja.XSlvRelRes).all()


FUSED_CASES = ([(v, m) for v in VARIANTS for m in ("tail_on", "tail_off")]
               + [("elastic", "body_pk"), ("elastic_wl1_nonneg",
                                           "body_pk")])


@pytest.mark.parametrize("name,mode", FUSED_CASES,
                         ids=[f"{v}-{m}" for v, m in FUSED_CASES])
def test_fused_variant_matches_jax(name, mode):
    """The port's fused solve agrees with each route of the JAX fused
    driver, and took its own route: ``csc_iter``, the tail kernel's
    wrapper (its plain version on the CPU) or the torch-op tail, once
    per iteration."""
    t = _port_run(name)
    route = VARIANTS[name][4]
    assert t[5]._fused_solve is tfc.cbpdn_solve
    assert t[4] == {"csc_iter": 0, "tail": 0, "tail_ops": 0,
                    route: ITERS}
    _assert_runs_close(_jax_run(name, mode), t,
                       same_x=(route == "csc_iter") == (mode == "body_pk"))


@pytest.mark.parametrize("name", ["gradreg_odd_m", "gradreg_wgrd_pos25"])
def test_tail_kernel_takes_layouts_outside_the_jax_rule(name):
    """The JAX package's TPU block rule sends these packed layouts to its
    XLA tail; the port's fused driver still calls the tail kernel's
    wrapper once per iteration."""
    _, N, M, _, _ = VARIANTS[name]
    pos, C = (N // tfc.PS) ** 2, tfc.PS * tfc.PS * M
    assert not ptail.tail_eligible(pos, C)
    assert _port_run(name)[4] == {"csc_iter": 0, "tail": ITERS,
                                  "tail_ops": 0}


@pytest.mark.parametrize("name", ["gradreg", "gradreg_wgrd", "gradreg_odd_m",
                                  "gradreg_wgrd_pos25", "elastic",
                                  "elastic_wl1_nonneg", "l1_spatial_wl1"])
def test_generic_variant_matches_jax(name):
    """``fused=False``: the generic ``elastic`` and ``gradreg`` problems
    (and ``l1`` with a spatial weight) against the JAX package's generic
    problems."""
    t = _port_run(name, fused=False)
    assert t[5]._fused_solve is None
    assert t[4] == {"csc_iter": 0, "tail": 0, "tail_ops": 0}
    _assert_runs_close(_jax_run(name, "tail_off", fused=False), t)


@pytest.mark.parametrize("dtype", ["float64", "complex64"])
def test_generic_variants_other_types_match_jax(dtype):
    """The generic gradreg and elastic problems in float64 (off the fused
    driver's rule), and gradreg with complex data (the full-spectrum
    gradient filters)."""
    D, S = _problem(32, 4, seed=4)
    if dtype == "complex64":
        S = (S + 0.5j * np.roll(S, 3, axis=0)).astype(np.complex64)
        jdt, tdt, cases = np.float32, torch.float32, ["ConvBPDNGradReg"]
    else:
        jdt, tdt = np.float64, torch.float64
        cases = ["ConvBPDNGradReg", "ConvElasticNet"]
    for cls in cases:
        jcls, tcls = getattr(jm, cls), getattr(tm, cls)
        jb = jcls(D, S, LMBDA, mu=0.1, dtype=jdt,
                  opt=jcls.options(max_iter=ITERS, rel_stop_tol=0.0))
        jY = np.asarray(jb.solve())
        tb = tcls(D, S, LMBDA, mu=0.1, dtype=tdt, device="cpu",
                  opt=tcls.options(max_iter=ITERS, rel_stop_tol=0.0))
        tY = tb.solve().numpy()
        assert tb._fused_solve is None
        _assert_runs_close(
            (jb.getitstat(), jY, np.asarray(jb.state.X),
             np.asarray(jb.state.U)),
            (tb.getitstat(), tY, tb.state.X.numpy(), tb.state.U.numpy()))


@pytest.mark.parametrize("ndim,shape", [(2, (16, 16)), (2, (32, 24)),
                                        (1, (10,)), (3, (4, 6, 8))])
@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64"])
def test_gradient_filters_match_jax(ndim, shape, dtype):
    jGf, jG = jsig.gradient_filters(ndim, shape, dtype=getattr(jnp, dtype))
    tGf, tG = tsig.gradient_filters(ndim, shape,
                                    dtype=getattr(torch, dtype))
    assert tuple(tGf.shape) == jGf.shape and tuple(tG.shape) == jG.shape
    assert tG.dtype == (torch.float64 if dtype == "float64"
                        else torch.float32)
    np.testing.assert_allclose(tGf.numpy(), np.asarray(jGf), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tG.numpy(), np.asarray(jG), rtol=1e-6,
                               atol=1e-6)


def _eligibility_case(variant, wl1, wgrd, N):
    D, S = _problem(N, 4)
    M = 4
    wl1v = {"scalar": 1.0, "filter": _filter_w([1.0, 0.5, 2.0, 0.0]),
            "spatial": _spatial_wl1(N, M)}[wl1]
    wgrdv = {"scalar": 1.0,
             "filter": np.array([1.0, 0.5, 2.0, 0.0], np.float32),
             "spatial": np.ones((1, 1, M, N, N // 2 + 1), np.float32)}[wgrd]
    cls = {"l1": "ConvBPDN", "elastic": "ConvElasticNet",
           "gradreg": "ConvBPDNGradReg"}[variant]
    kw = dict(wl1=wl1v)
    if variant != "l1":
        kw["mu"] = 0.1
    if variant == "gradreg":
        kw["wgrd"] = wgrdv
    jb = getattr(jm, cls)(D, S, LMBDA, **kw)
    tb = getattr(tm, cls)(D, S, LMBDA, device="cpu", **kw)
    return jb, tb


# (variant, L1Weight, GradWeight, N); GradWeight applies to gradreg only
ELIGIBILITY_CASES = [
    (v, w, g, n) for v in ("l1", "elastic", "gradreg")
    for w in ("scalar", "filter", "spatial")
    for g, n in (("scalar", 32), ("filter", 32), ("spatial", 32),
                 ("scalar", 36))
    if v == "gradreg" or g == "scalar"]


@pytest.mark.parametrize("variant,wl1,wgrd,N", ELIGIBILITY_CASES,
                         ids=["-".join(map(str, c))
                              for c in ELIGIBILITY_CASES])
def test_eligible_matches_jax(variant, wl1, wgrd, N):
    """The port's fused driver takes what the JAX one takes, over
    variants, L1Weight and GradWeight shapes and sizes, and the model
    routes what it takes to it."""
    jb, tb = _eligibility_case(variant, wl1, wgrd, N)
    for force in (False, True):
        try:
            want = jfc.eligible(jb.cfg, jb.params, jb.opts, force=force)
        except ValueError:
            with pytest.raises(ValueError, match="fused=True"):
                tfc.eligible(tb.cfg, tb.params, tb.opts, force=force)
            continue
        assert tfc.eligible(tb.cfg, tb.params, tb.opts, force=force) == want
    got = tfc.eligible(tb.cfg, tb.params, tb.opts)
    assert (tb._fused_solve is tfc.cbpdn_solve) == got
