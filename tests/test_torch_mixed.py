"""The opt-in "mixed" matmul precision of the fused drivers: the port's
``csc_iter_plain``/``pgm_iter_plain`` with ``mixed=True`` (R1 as one bf16
product) against the JAX package's Pallas kernels at ``fwd_passes=1``
in interpret mode, and the fused ADMM and FISTA solves under
``set_matmul_precision("mixed")`` against the JAX package's with
``pki.interpret = True`` (its kernel route, the only one that rounds to
bf16 off the TPU); the mode switch mirrors
``tests/ops/test_fused_csc.py:357-375``.

Tolerances: R1 within 1e-5 of its scale (both sum exact products of the
same bf16 operands in float32, in another order), while it differs from
the "high" R1 by more than 1e-4 (so the rounding took place); the other
outputs as ``tests/test_torch_csc_iter.py`` and
``tests/test_torch_pgm_iter.py`` hold them; the FISTA solves as
``tests/test_torch_pgm.py`` holds them: the same iteration count, X
within 2e-4 of its scale, ObjFun, DFid and RegL1 rtol 1e-4, the
residual rtol 1e-3 (atol 1e-6); the ADMM solves at those tolerances over
their first four rows and within twice the JAX package's own "mixed"
to "high" drift over the run (see
:func:`test_fused_admm_mixed_matches_jax` for why).
"""

import contextlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from scipy.ndimage import gaussian_filter

from sporco_tpu.models import cbpdn as jm
from sporco_tpu.models import pgm as jpgm
from sporco_tpu.ops import fused_csc as jfc
from sporco_tpu.ops import pallas_csc_iter as pki
from sporco_tpu_torch.models import cbpdn as tm
from sporco_tpu_torch.models import pgm as tpgm
from sporco_tpu_torch.ops import csc_iter as tci
from sporco_tpu_torch.ops import fused_csc as tfc
from sporco_tpu_torch.ops import pgm_iter as tpi

torch.set_num_threads(2)

POS, C, T = 64, 256, 256
RLX, US = 1.8, 0.7
LMBDA = 0.05
ITERS = 15


@contextlib.contextmanager
def _mixed():
    """Both packages in "mixed", the JAX one on its kernel route; both
    restored after."""
    prev = pki.interpret
    pki.interpret = True
    jfc.set_matmul_precision("mixed")
    tfc.set_matmul_precision("mixed")
    jax.clear_caches()
    try:
        yield
    finally:
        jfc.set_matmul_precision("high")
        tfc.set_matmul_precision("high")
        pki.interpret = prev
        jax.clear_caches()


@pytest.fixture
def interpret():
    prev = pki.interpret
    pki.interpret = True
    try:
        yield
    finally:
        pki.interpret = prev


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    f = np.float32
    G2 = (0.1 * rng.standard_normal((POS, T))).astype(f)
    Wa = (0.1 * rng.standard_normal((T, C))).astype(f)
    Wf = (0.1 * rng.standard_normal((C, T))).astype(f)
    Y = (rng.standard_normal((POS, C))
         * (rng.random((POS, C)) < 0.3)).astype(f)
    U = (0.1 * rng.standard_normal((POS, C))).astype(f)
    return G2, Y, U, Wa, Wf


def _rel(a, b):
    return np.abs(a - b).max() / np.abs(b).max()


def _t(a):
    return torch.tensor(a)


@pytest.mark.parametrize("nonneg", [False, True])
def test_csc_iter_mixed_matches_jax_kernel(interpret, nonneg):
    G2, Y, U, Wa, Wf = _inputs()
    ref = pki.csc_iter(jnp.asarray(G2), jnp.asarray(Y), jnp.asarray(U),
                       pki.split_bf16_3(jnp.asarray(Wa)),
                       pki.split_bf16_3(jnp.asarray(Wf)), 0.05, 1.0, RLX,
                       US, 0.9, nonneg=nonneg, fwd_passes=1, adj_passes=6,
                       r2_passes=6, emit_px=True)
    ref = [np.asarray(o) for o in ref]

    def port(mixed):
        out = tci.csc_iter(_t(G2), _t(Y), _t(U), _t(Wa), _t(Wf), 0.05, 1.0,
                           RLX, US, 0.9, nonneg=nonneg, mixed=mixed)
        return [o.numpy() for o in out]
    got, high = port(True), port(False)
    assert _rel(got[3], ref[3]) <= 1e-5
    assert _rel(high[3], ref[3]) > 1e-4
    assert _rel(got[4], ref[4]) <= 1e-5
    np.testing.assert_array_equal(got[4], high[4])
    for i in (0, 1, 2):
        np.testing.assert_array_equal(got[i], high[i])
        scale = np.abs(ref[0]).max()
        assert np.abs(got[i] - ref[i]).max() <= 1e-4 * scale
    np.testing.assert_allclose(got[5], ref[5], rtol=1e-4)


@pytest.mark.parametrize("nonneg", [False, True])
def test_pgm_iter_mixed_matches_jax_kernel(interpret, nonneg):
    G2, Y, Xprv, Wa, Wf = _inputs(seed=5)
    ref = pki.pgm_iter(jnp.asarray(G2), jnp.asarray(Y), jnp.asarray(Xprv),
                       pki.split_bf16_3(jnp.asarray(Wa)),
                       pki.split_bf16_3(jnp.asarray(Wf)), 0.05, 1.0, 0.05,
                       0.3, nonneg=nonneg, fwd_passes=1)
    ref = [np.asarray(o) for o in ref]

    def port(mixed):
        out = tpi.pgm_iter(_t(G2), _t(Y), _t(Xprv), _t(Wa), _t(Wf), 0.05,
                           1.0, 0.05, 0.3, nonneg=nonneg, mixed=mixed)
        return [o.numpy() for o in out]
    got, high = port(True), port(False)
    assert _rel(got[2], ref[2]) <= 1e-5
    assert _rel(high[2], ref[2]) > 1e-4
    np.testing.assert_array_equal(got[3], high[3])
    for i in (0, 1):
        np.testing.assert_array_equal(got[i], high[i])
        assert _rel(got[i], ref[i]) <= 1e-4
    np.testing.assert_allclose(got[4], ref[4], rtol=1e-4)


def test_bf16_product_rounds_both_operands():
    """``bf16_product`` is the float64 product of the bf16-rounded
    operands to float32 accuracy."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((16, 64)).astype(np.float32)
    W = rng.standard_normal((64, 8)).astype(np.float32)
    xb = torch.tensor(x).to(torch.bfloat16).double()
    Wb = torch.tensor(W).to(torch.bfloat16).double()
    got = tci.bf16_product(torch.tensor(x), torch.tensor(W))
    assert got.dtype == torch.float32
    want = (xb @ Wb).numpy()
    assert _rel(got.numpy(), want) <= 1e-6
    assert _rel((torch.tensor(x) @ torch.tensor(W)).numpy(), want) > 1e-4


def _problem(N=64, M=4, Nd=8, seed=0):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((Nd, Nd, M)).astype(np.float32)
    D /= np.sqrt((D ** 2).sum(axis=(0, 1), keepdims=True))
    S = gaussian_filter(rng.standard_normal((N, N)), 4.0) * 5.0
    S += 0.1 * rng.standard_normal((N, N))
    return D, S.astype(np.float32)


def _assert_close(ja, jY, jX, ta, tY, tX, names, rsdl):
    assert len(ja) == len(ta) == ITERS
    np.testing.assert_array_equal(ja.Iter, ta.Iter)
    for a, b in ((tY, jY), (tX, jX)):
        assert a.shape == b.shape
        assert np.abs(a - b).max() < 2e-4 * max(np.abs(b).max(), 1e-6)
    for name in names:
        np.testing.assert_allclose(getattr(ta, name), getattr(ja, name),
                                   rtol=1e-4, err_msg=name)
    for name in rsdl:
        np.testing.assert_allclose(getattr(ta, name), getattr(ja, name),
                                   rtol=1e-3, atol=1e-6, err_msg=name)


def _rel_diffs(a, b):
    """Relative differences of two ADMM runs ``(itstat, Y, X)``: the
    largest over the rows of each stats column, and Y's and X's largest
    difference over the scale of ``b``."""
    (ia, Ya, Xa), (ib, Yb, Xb) = a, b
    out = {name: float(np.max(np.abs(getattr(ia, name) - getattr(ib, name))
                              / np.abs(getattr(ib, name))))
           for name in ("ObjFun", "DFid", "RegL1", "Rho")}
    out["Y"] = float(np.abs(Ya - Yb).max() / np.abs(Yb).max())
    out["X"] = float(np.abs(Xa - Xb).max() / np.abs(Xb).max())
    return out


@pytest.mark.parametrize("cls", ["ConvBPDN", "ConvElasticNet"])
def test_fused_admm_mixed_matches_jax(cls):
    """Fused ADMM under "mixed" against the JAX package's: the first four
    stats rows at the tolerances of "high" (rtol 1e-4), and the whole run
    within twice the JAX package's own drift from "mixed" to "high".

    Why not "high"'s tolerances throughout: in ADMM the x-step residual
    ``Sf - rfft(D yu)`` cancels, and a bf16-rounded operand flips to the
    next bf16 value wherever the two packages' Yn - Un differ by a few
    fp32 ulps (the JAX kernel's adjoint is a 3-pass bf16 product, the
    port's fp32).  Each flip moves R1 by a bf16 ulp, so the two runs part
    as "mixed" parts from "high" (measured at this size: 5e-7 to 5e-6 on
    ObjFun over the first four rows, 1e-4 after 15 iterations, against
    3.5e-4 from "high")."""
    D, S = _problem()
    kw = {"mu": 0.05} if cls == "ConvElasticNet" else {}
    jcls, tcls = getattr(jm, cls), getattr(tm, cls)

    def jax_run():
        jb = jcls(D, S, LMBDA, fused=True, **kw,
                  opt=jcls.options(max_iter=ITERS, rel_stop_tol=0.0))
        Y = np.asarray(jb.solve())
        return jb.getitstat(), Y, np.asarray(jb.state.X)
    with _mixed():
        jm_run = jax_run()
        tb = tcls(D, S, LMBDA, device="cpu", **kw,
                  opt=tcls.options(max_iter=ITERS, rel_stop_tol=0.0))
        t_run = (None, tb.solve().numpy(), tb.state.X.numpy())
    t_run = (tb.getitstat(),) + t_run[1:]
    prev = pki.interpret
    pki.interpret = True
    jax.clear_caches()
    try:
        jh_run = jax_run()
    finally:
        pki.interpret = prev
        jax.clear_caches()
    assert tb._fused_solve is tfc.cbpdn_solve
    ja, ta = jm_run[0], t_run[0]
    assert len(ja) == len(ta) == ITERS
    np.testing.assert_array_equal(ja.Iter, ta.Iter)
    for name in ("ObjFun", "DFid", "RegL1", "Rho"):
        np.testing.assert_allclose(getattr(ta, name)[:4],
                                   getattr(ja, name)[:4], rtol=1e-4,
                                   err_msg=name)
    drift = _rel_diffs(jm_run, jh_run)
    got = _rel_diffs(t_run, jm_run)
    for name, d in drift.items():
        assert 0 < d < 1e-2, (name, d)
        assert got[name] <= 2 * d, (name, got[name], d)


def test_fused_admm_mixed_differs_from_high():
    """"mixed" reaches the kernel's plain version: the objective moves,
    but by less than 1e-3."""
    D, S = _problem()
    opt = tm.ConvBPDN.options(max_iter=ITERS, rel_stop_tol=0.0)
    high = tm.ConvBPDN(D, S, LMBDA, opt=opt, device="cpu")
    high.solve()
    with _mixed():
        mixed = tm.ConvBPDN(D, S, LMBDA, opt=opt, device="cpu")
        mixed.solve()
    a, b = mixed.getitstat().ObjFun, high.getitstat().ObjFun
    assert not np.array_equal(a, b)
    np.testing.assert_allclose(a, b, rtol=1e-3)


@pytest.mark.parametrize("masked", [False, True])
def test_fused_fista_mixed_matches_jax(masked):
    D, S = _problem()
    kw = {}
    if masked:
        kw["W"] = (np.random.default_rng(2).random(S.shape) > 0.3).astype(
            np.float32)
    jcls = jpgm.ConvBPDNMask if masked else jpgm.ConvBPDN
    tcls = tpgm.ConvBPDNMask if masked else tpgm.ConvBPDN
    with _mixed():
        jb = jcls(D, S, LMBDA, **kw,
                  opt=jcls.options(max_iter=ITERS, rel_stop_tol=0.0))
        jX = np.asarray(jb.solve())
        tb = tcls(D, S, LMBDA, device="cpu", **kw,
                  opt=tcls.options(max_iter=ITERS, rel_stop_tol=0.0))
        tX = tb.solve().numpy()
    assert tfc._pgm_kernel_eligible(tb.cfg, tb.params, tb.opts)
    _assert_close(jb.getitstat(), jX, np.asarray(jb.state.Y),
                  tb.getitstat(), tX, tb.state.Y.numpy(),
                  ("ObjFun", "DFid", "RegL1"), ("Rsdl",))


def test_matmul_precision_mode():
    """The switch as the JAX package's: "high" by default, "mixed" on
    request, anything else a ValueError that leaves the mode alone."""
    assert tfc.get_matmul_precision() == "high"
    try:
        tfc.set_matmul_precision("mixed")
        assert tfc.get_matmul_precision() == "mixed"
        with pytest.raises(ValueError):
            tfc.set_matmul_precision("bogus")
        assert tfc.get_matmul_precision() == "mixed"
    finally:
        tfc.set_matmul_precision("high")
    with pytest.raises(ValueError):
        jfc.set_matmul_precision("bogus")
