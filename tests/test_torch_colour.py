"""Colour convolutional sparse coding in the port on the CPU (its kernels
as their plain PyTorch versions) against the JAX package on the same
numpy problems: a colour dictionary (Cd = C in {2, 3}, coefficient maps
shared across the channels) on the fused ADMM driver (``body_pk`` on
``csc_iter``, ``body`` for a spatial ``L1Weight``), on the fused FISTA
problem and on the generic ADMM and FFT PGM paths; a multi-channel
signal with a single-channel dictionary folded into the batch axis on
both fused drivers; and their building blocks (``solvemdbi_ism``, the
per-bin Hermitian solve, the C-channel polyphase weights, layouts and
x-step).

The cases mirror ``tests/ops/test_fused_csc.py:20-215``
(``TestChannelFolding``, ``TestMultiChannelDict``), with the JAX Pallas
kernel in interpret mode where the JAX test runs it.  Tolerances are
that file's: the same iteration count (within one for a solve to 1e-3),
ObjFun, DFid, RegL1 and Rho rtol 1e-4, the residuals rtol 1e-3 (atol
1e-6), X, Y and U within 2e-4 of their largest magnitude.
"""

import contextlib

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from sporco_tpu.models import cbpdn as jm
from sporco_tpu.models import pgm as jpgm
from sporco_tpu.ops import fft as jfft
from sporco_tpu.ops import fused_csc as jfc
from sporco_tpu.ops import linalg as jla
from sporco_tpu.ops import pallas_csc_iter as pki
from sporco_tpu_torch.models import cbpdn as tm
from sporco_tpu_torch.models import pgm as tpgm
from sporco_tpu_torch.ops import fft as tfft
from sporco_tpu_torch.ops import fused_csc as tfc
from sporco_tpu_torch.ops import linalg as tla

torch.set_num_threads(2)

LMBDA = 0.1
N, M = 32, 4
f32 = np.float32


def _rng(seed):
    return np.random.default_rng(seed)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def _colour_dict(C, seed=5):
    D = _rng(seed).standard_normal((8, 8, C, M)).astype(f32)
    return D / np.sqrt((D ** 2).sum(axis=(0, 1, 2), keepdims=True))


def _grey_dict(seed=7):
    D = _rng(seed).standard_normal((8, 8, M)).astype(f32)
    return D / np.sqrt((D ** 2).sum(axis=(0, 1), keepdims=True))


def _signal(C, K=None, seed=6):
    shape = (N, N, C) if K is None else (N, N, C, K)
    return _rng(seed).standard_normal(shape).astype(f32)


def _cplx(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


# ---------------------------------------------------------------------------
# building blocks

@pytest.mark.parametrize("Cd", [2, 3])
@pytest.mark.parametrize("diag", ["scalar", "array"])
def test_solvemdbi_ism_matches_jax(Cd, diag):
    """The iterated Sherman-Morrison solve over the channel axis, with a
    scalar rho (l1, elastic) and a bin-dependent diagonal (gradreg), on
    the generic path's shapes (K, Cd, M, n0, k1); and it solves the
    system."""
    rng = _rng(10 + Cd)
    ah = _cplx(rng, (1, Cd, 5, 6, 4))
    b = _cplx(rng, (2, 1, 5, 6, 4))
    rho = f32(1.7) if diag == "scalar" else \
        (1.0 + rng.random((1, 1, 5, 6, 4))).astype(f32)
    got = tla.solvemdbi_ism(torch.tensor(ah), torch.tensor(rho)
                            if diag == "array" else float(rho),
                            torch.tensor(b), axisM=2, axisK=1)
    ref = jla.solvemdbi_ism(jnp.asarray(ah), rho, jnp.asarray(b), axisM=2,
                            axisK=1)
    assert got.dtype == torch.complex64
    assert _rel(got, ref) <= 1e-5
    # (rho I + sum_c a_c a_c^H) x = b with a = conj(ah)
    x = _np(got).astype(np.complex128)
    a = ah.conj().astype(np.complex128)
    ax = rho * x + np.sum(a * np.sum(ah * x, axis=2, keepdims=True),
                          axis=1, keepdims=True)
    assert _rel(ax, b) <= 1e-4


@pytest.mark.parametrize("C", [1, 2, 3])
def test_herm_solve_matches_jax(C):
    """The closed-form per-bin solve of ``(A + beta I) g = B`` for a
    Hermitian Gram A, against the JAX package and numpy."""
    rng = _rng(20 + C)
    Df = _cplx(rng, (C, 4, 6, 5))
    A = np.einsum("cmxy,dmxy->cdxy", Df, Df.conj()).astype(np.complex64)
    B = _cplx(rng, (2, C, 6, 5))
    beta = f32(0.8)
    got = tfc._herm_solve(torch.tensor(A), float(beta), torch.tensor(B))
    ref = jfc._herm_solve(jnp.asarray(A), beta, jnp.asarray(B))
    assert got.dtype == torch.complex64 and tuple(got.shape) == B.shape
    assert _rel(got, ref) <= 1e-5
    Am = np.moveaxis(A.astype(np.complex128), (0, 1), (-2, -1)) \
        + beta * np.eye(C)
    want = np.linalg.solve(Am[None], np.moveaxis(B, 1, -1)[..., None])
    assert _rel(got, np.moveaxis(want[..., 0], -1, 1)) <= 1e-5


@pytest.mark.parametrize("C,dsz", [(2, (8, 8)), (3, (8, 8)), (3, (5, 7)),
                                   (3, (11, 11))])
def test_xstep_kernels_mc_matches_jax(C, dsz):
    """The C-channel polyphase weights are the JAX package's bit for bit
    (pure data movement), and at C = 1 they are the single-channel
    weights."""
    D = _rng(30).standard_normal((C, M) + dsz).astype(f32)
    Wf, Wa, js = tfc.xstep_kernels(torch.tensor(D), *dsz)
    jWf, jWa, jjs = jfc.xstep_kernels_mc(jnp.asarray(D), *dsz)
    assert js == tuple(jjs)
    np.testing.assert_array_equal(_np(Wf), np.asarray(jWf))
    np.testing.assert_array_equal(_np(Wa), np.asarray(jWa))
    one = tfc.xstep_kernels(torch.tensor(D[:1]), *dsz)
    grey = tfc.xstep_kernels(torch.tensor(D[0]), *dsz)
    for a, b in zip(one[:2], grey[:2]):
        np.testing.assert_array_equal(_np(a), _np(b))


@pytest.mark.parametrize("C", [2, 3])
def test_channel_layouts_match_jax(C):
    """The channel-packed layout, the C-channel forward epilogue (packed
    and as an image) and the C-channel adjoint rolls: data movement and
    sums of rolls, as the JAX package's."""
    rng = _rng(40 + C)
    J0, J1 = 1, 1
    T = (J0 + 1) * (J1 + 1)
    A = rng.standard_normal((2, C, 16, 24)).astype(f32)
    np.testing.assert_array_equal(_np(tfc._pack_ch(torch.tensor(A))),
                                  np.asarray(jfc._pack_ch(A)))
    o = rng.standard_normal((2, 2, 3, T * C * 64)).astype(f32)
    np.testing.assert_allclose(
        _np(tfc._fwd_combine(torch.tensor(o), J0, J1, 8, C)),
        np.asarray(jfc._fwd_combine_ch(jnp.asarray(o), J0, J1, C, 8)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        _np(tfc._fwd_combine_mc(torch.tensor(o), J0, J1, C, 8)),
        np.asarray(jfc._fwd_combine_mc(jnp.asarray(o), J0, J1, C, 8)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        _np(tfc._adj_rolls_mc(torch.tensor(A), J0, J1)),
        np.asarray(jfc._adj_rolls_mc(jnp.asarray(A), J0, J1)))


@pytest.mark.parametrize("beta,scale", [(3.5, 1.0), (0.7, 0.8)])
def test_spatial_xstep_mc_matches_jax(beta, scale):
    """The rank-C x-step and its spectral intermediates, and the per-bin
    Gram of the driver (``_gram``, fp32 contractions)."""
    C, K, Nv = 3, 2, (N, N)
    rng = _rng(50)
    D = _colour_dict(C).transpose(2, 3, 0, 1).copy()     # (C, M, 8, 8)
    S = rng.standard_normal((K, C, N, N)).astype(f32)
    Pyu = rng.standard_normal((K, N // 8, N // 8, 64 * M)).astype(f32)
    jD = jnp.asarray(D)
    jDf = jfft.rfftn(jD, s=Nv, axes=(-2, -1))
    jDDHf = jnp.einsum("cmxy,dmxy->cdxy", jDf, jnp.conj(jDf),
                       precision=jax.lax.Precision.HIGHEST)
    jSf = jfft.rfftn(jnp.asarray(S), axes=(-2, -1))
    jWf, jWa, jjs = jfc.xstep_kernels_mc(jD, 8, 8)
    ref = jfc.spatial_xstep_mc(jnp.asarray(Pyu), jWf, jWa, jjs, jDDHf, jSf,
                               f32(beta), f32(scale), Nv, C)
    tD = torch.tensor(D)
    DDHf = tfc._gram(tfft.rfftn(tD, s=Nv, axes=(-2, -1)))
    assert _rel(DDHf, jDDHf) <= 1e-6
    Wf, Wa, js = tfc.xstep_kernels(tD, 8, 8)
    got = tfc.spatial_xstep_mc(
        torch.tensor(Pyu), Wf, Wa, js, DDHf,
        tfft.rfftn(torch.tensor(S), axes=(-2, -1)), f32(beta), f32(scale),
        Nv, C)
    for g, r in zip(got, ref):
        assert tuple(g.shape) == r.shape
        assert _rel(g, r) <= 1e-5


# ---------------------------------------------------------------------------
# the solves

@contextlib.contextmanager
def _jax_kernel(on):
    """The JAX fused routes through the Pallas kernels in interpret mode
    (``on``) or through XLA (``body``, the generic packed loop)."""
    prev = (pki.enabled, pki.interpret)
    pki.enabled, pki.interpret = True, on
    if not on:
        pki.enabled = False
    jax.clear_caches()
    try:
        yield
    finally:
        pki.enabled, pki.interpret = prev
        jax.clear_caches()


def _cols(its, n):
    return {name: getattr(its, name)[:n] for name in its._names}


def _assert_admm_close(jb, jY, tb, tY, same_len=True, same_x=True):
    """The tolerances of the module docstring.  ``same_len`` False: a
    solve to 1e-3, whose iteration counts may differ by one; the rows
    they share and the final Y are compared.  ``same_x`` False: the two
    runs define the returned X differently (``body`` returns the last
    iteration's x-step, ``body_pk`` the x-step at the final Y, U and
    rho), so X is not compared."""
    ja, ta = jb.getitstat(), tb.getitstat()
    if same_len:
        assert len(ta) == len(ja)
    else:
        assert abs(len(ta) - len(ja)) <= 1
    n = min(len(ta), len(ja))
    ja, ta = _cols(ja, n), _cols(ta, n)
    assert set(ta) == set(ja)
    np.testing.assert_array_equal(ta["Iter"], ja["Iter"])
    assert tY.shape == jY.shape
    arrays = [("Y", tY, jY)]
    if same_len:
        arrays.append(("U", tb.state.U.numpy(), np.asarray(jb.state.U)))
    if same_len and same_x:
        arrays.append(("X", tb.state.X.numpy(), np.asarray(jb.state.X)))
    for name, a, b in arrays:
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() <= 2e-4 * max(np.abs(b).max(), 1e-6), \
            name
    for name in ("ObjFun", "DFid", "RegL1", "Rho"):
        np.testing.assert_allclose(ta[name], ja[name], rtol=1e-4,
                                   err_msg=name)
    for name in ("RegL2", "RegGrad", "PrimalRsdl", "DualRsdl"):
        if name in ta:
            np.testing.assert_allclose(ta[name], ja[name], rtol=1e-3,
                                       atol=1e-6, err_msg=name)


def _admm_case(kind):
    """(model class, D, S, constructor arguments, iterations, the JAX
    fused route through the kernel, the port's solve function)."""
    opt = 15
    if kind.startswith("colour_c2"):
        return "ConvBPDN", _colour_dict(2), _signal(2), {"dimK": 0}, 25, \
            False, tfc.cbpdn_solve
    if kind == "colour_c3":
        return "ConvBPDN", _colour_dict(3), _signal(3), {"dimK": 0}, 25, \
            False, tfc.cbpdn_solve
    if kind == "colour_multi_signal":
        return "ConvBPDN", _colour_dict(3), _signal(3, K=2), {}, opt, \
            False, tfc.cbpdn_solve
    if kind == "colour_elastic":
        return "ConvElasticNet", _colour_dict(3), _signal(3), \
            {"dimK": 0, "mu": 0.05}, opt, False, tfc.cbpdn_solve
    if kind == "colour_kernel":
        return "ConvBPDN", _colour_dict(3), _signal(3), {"dimK": 0}, opt, \
            True, tfc.cbpdn_solve
    if kind == "colour_elastic_kernel":
        return "ConvElasticNet", _colour_dict(3), _signal(3), \
            {"dimK": 0, "mu": 0.05}, opt, True, tfc.cbpdn_solve
    if kind == "colour_spatial_wl1":
        # the reference layout Nv + (Cx, K, M): a weight per coefficient
        wl1 = (0.5 + _rng(8).random((N, N, 1, 1, M))).astype(f32)
        return "ConvBPDN", _colour_dict(3), _signal(3), \
            {"dimK": 0, "wl1": wl1}, opt, False, tfc.cbpdn_solve
    if kind == "cfold":
        return "ConvBPDN", _grey_dict(), _signal(3), {"dimK": 0}, 25, \
            False, tfc.cbpdn_solve_cfold
    if kind == "cfold_multi_signal":
        return "ConvBPDN", _grey_dict(), _signal(3, K=2), {}, opt, \
            False, tfc.cbpdn_solve_cfold
    if kind == "cfold_elastic_kernel":
        return "ConvElasticNet", _grey_dict(), _signal(3), \
            {"dimK": 0, "mu": 0.05}, opt, True, tfc.cbpdn_solve_cfold
    raise ValueError(kind)


ADMM_CASES = ["colour_c2", "colour_c3", "colour_multi_signal",
              "colour_elastic", "colour_kernel", "colour_elastic_kernel",
              "colour_spatial_wl1", "cfold", "cfold_multi_signal",
              "cfold_elastic_kernel"]


@pytest.mark.parametrize("kind", ADMM_CASES)
def test_fused_admm_matches_jax(kind):
    """The port's default route (the fused driver: ``body_pk`` on
    ``csc_iter``, ``body`` with the torch-op tail for a spatial weight,
    or channel folding) against the JAX fused driver, through its Pallas
    ``csc_iter`` in interpret mode or its XLA ``body``; X where both
    took the same body."""
    cls, D, S, kw, iters, kernel, solve = _admm_case(kind)
    jcls, tcls = getattr(jm, cls), getattr(tm, cls)
    with _jax_kernel(kernel):
        jb = jcls(D, S, LMBDA, opt=jcls.options(max_iter=iters,
                                                rel_stop_tol=0.0), **kw)
        jY = np.asarray(jb.solve())
    tb = tcls(D, S, LMBDA, opt=tcls.options(max_iter=iters,
                                            rel_stop_tol=0.0),
              device="cpu", **kw)
    assert tb._fused_solve is solve
    assert jfc.eligible(jb.cfg, jb.params, jb.opts) == (
        solve is tfc.cbpdn_solve)
    assert jfc.cfold_eligible(jb.cfg, jb.params, jb.opts) == (
        solve is tfc.cbpdn_solve_cfold)
    _assert_admm_close(jb, jY, tb, tb.solve().numpy(),
                       same_x=kernel or kind == "colour_spatial_wl1")


def test_fused_admm_solve_to_tolerance_matches_jax():
    """A colour-dictionary solve to relative residual 1e-3 on the fused
    drivers of both packages: the iteration count within one, the rows
    both ran and the final Y."""
    D, S = _colour_dict(3), _signal(3)
    with _jax_kernel(False):
        jb = jm.ConvBPDN(D, S, LMBDA, dimK=0, opt=jm.ConvBPDN.options(
            max_iter=300, rel_stop_tol=1e-3))
        jY = np.asarray(jb.solve())
    tb = tm.ConvBPDN(D, S, LMBDA, dimK=0, device="cpu",
                     opt=tm.ConvBPDN.options(max_iter=300,
                                             rel_stop_tol=1e-3))
    tY = tb.solve().numpy()
    assert 10 < len(tb.getitstat()) < 300
    _assert_admm_close(jb, jY, tb, tY, same_len=False)


GENERIC_CASES = ["ConvBPDN", "ConvElasticNet", "ConvBPDNGradReg",
                 "lin_check", "multi_signal"]


@pytest.mark.parametrize("kind", GENERIC_CASES)
def test_generic_admm_colour_dict_matches_jax(kind):
    """``fused=False`` with a colour dictionary: the generic problem's
    channel sums and ``solvemdbi_ism`` (gradreg with its bin-dependent
    diagonal, which the fused driver does not take; LinSolveCheck's
    relative residual) against the JAX package's generic problem."""
    cls = kind if kind.startswith("Conv") else "ConvBPDN"
    kw = {"dimK": 0, "fused": False}
    S = _signal(3)
    if cls != "ConvBPDN":
        kw["mu"] = 0.05 if cls == "ConvElasticNet" else 0.2
    if kind == "lin_check":
        kw["lin_check"] = True
    if kind == "multi_signal":
        S = _signal(3, K=2)
        del kw["dimK"]
    jcls, tcls = getattr(jm, cls), getattr(tm, cls)
    opt = dict(max_iter=15, rel_stop_tol=0.0)
    jb = jcls(_colour_dict(3), S, LMBDA, opt=jcls.options(**opt), **kw)
    jY = np.asarray(jb.solve())
    tb = tcls(_colour_dict(3), S, LMBDA, opt=tcls.options(**opt),
              device="cpu", **kw)
    assert tb._fused_solve is None
    _assert_admm_close(jb, jY, tb, tb.solve().numpy())
    if kind == "lin_check":
        t, j = tb.getitstat().XSlvRelRes, jb.getitstat().XSlvRelRes
        assert np.all(np.isfinite(t)) and np.all(t < 1e-4)
        assert np.all(j < 1e-4)


def _mask(shape, seed=9):
    return (_rng(seed).random(shape) >= 0.3).astype(f32)


def _pgm_case(kind):
    """(D, S, mask or None, the JAX fused route through the kernel, the
    port's solve function)."""
    colour = kind.startswith("colour")
    D = _colour_dict(3, seed=21) if colour else _grey_dict(seed=11)
    S = _signal(3, seed=22)
    W = None
    if "masked" in kind:
        W = _mask((N, N, 1) if "spatial_mask" in kind else (N, N, 3))
    solve = tfc.pgm_cbpdn_solve if colour else tfc.pgm_cbpdn_solve_cfold
    return D, S, W, "kernel" in kind, solve


PGM_CASES = ["colour", "colour_masked", "colour_kernel",
             "colour_masked_kernel", "cfold", "cfold_masked",
             "cfold_spatial_mask", "cfold_masked_kernel"]


@pytest.mark.parametrize("kind", PGM_CASES)
def test_fused_fista_matches_jax(kind):
    """The port's fused FISTA problem (``pgm_iter``'s loop, or channel
    folding, whose per-channel mask folds with the signal) against the
    JAX fused problem, through its Pallas ``pgm_iter`` in interpret mode
    or its generic packed loop."""
    D, S, W, kernel, solve = _pgm_case(kind)
    cls = "ConvBPDNMask" if W is not None else "ConvBPDN"
    jcls, tcls = getattr(jpgm, cls), getattr(tpgm, cls)
    kw = {"dimK": 0} if W is None else {"dimK": 0, "W": W}
    opt = dict(max_iter=15, rel_stop_tol=0.0, L=20.0)
    with _jax_kernel(kernel):
        jb = jcls(D, S, LMBDA, opt=jcls.options(**opt), **kw)
        jX = np.asarray(jb.solve())
    tb = tcls(D, S, LMBDA, opt=tcls.options(**opt), device="cpu", **kw)
    assert tb._fused_solve is solve
    tX = tb.solve().numpy()
    _assert_fista_close(jb, jX, tb, tX)


def _assert_fista_close(jb, jX, tb, tX):
    ja, ta = jb.getitstat(), tb.getitstat()
    assert len(ta) == len(ja) > 0
    np.testing.assert_array_equal(ta.Iter, ja.Iter)
    assert tX.shape == jX.shape
    assert np.abs(tX - jX).max() <= 2e-4 * max(np.abs(jX).max(), 1e-6)
    tYs, jYs = tb.state.Y.numpy(), np.asarray(jb.state.Y)
    assert np.abs(tYs - jYs).max() <= 2e-4 * max(np.abs(jYs).max(), 1e-6)
    for name in ("ObjFun", "DFid", "RegL1"):
        np.testing.assert_allclose(getattr(ta, name), getattr(ja, name),
                                   rtol=1e-4, err_msg=name)
    np.testing.assert_allclose(ta.Rsdl, ja.Rsdl, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("masked", [False, True])
def test_generic_fista_colour_dict_matches_jax(masked):
    """``fused=False`` with a colour dictionary: the FFT PGM problem's
    channel sums in the gradient (and the Hessian's, through the
    Barzilai-Borwein step size) against the JAX package's."""
    D, S = _colour_dict(3, seed=21), _signal(3, seed=22)
    cls = "ConvBPDNMask" if masked else "ConvBPDN"
    kw = {"dimK": 0, "fused": False}
    if masked:
        kw["W"] = _mask((N, N, 3))
    jcls, tcls = getattr(jpgm, cls), getattr(tpgm, cls)
    for opt in (dict(max_iter=15, rel_stop_tol=0.0, L=20.0),
                dict(max_iter=15, rel_stop_tol=0.0, L=20.0,
                     stepsize="bb")):
        jb = jcls(D, S, LMBDA, opt=jcls.options(**opt), **kw)
        jX = np.asarray(jb.solve())
        tb = tcls(D, S, LMBDA, opt=tcls.options(**opt), device="cpu",
                  **kw)
        assert tb._fused_solve is None
        _assert_fista_close(jb, jX, tb, tb.solve().numpy())
