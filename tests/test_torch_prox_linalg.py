"""The port's ``ops.prox`` and ``ops.linalg`` against the JAX package's on
the same seeded numpy inputs, real and complex, float32 and float64.

Tolerances: 1e-6 relative in float32 and 1e-12 in float64, the rounding
of a few operations in different orders; elementwise operations agree
to the last bit in practice."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sporco_tpu.ops import linalg as jla
from sporco_tpu.ops import prox as jpx
from sporco_tpu_torch.ops import linalg as tla
from sporco_tpu_torch.ops import prox as tpx

DTYPES = ["float32", "float64", "complex64", "complex128"]


def _rand(rng, shape, dtype):
    a = rng.standard_normal(shape)
    if dtype.startswith("complex"):
        a = a + 1j * rng.standard_normal(shape)
    return a.astype(dtype)


def _close(t, j, dtype):
    rtol = 1e-6 if dtype in ("float32", "complex64") else 1e-12
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_allclose(t, j, rtol=rtol,
                               atol=rtol * max(np.abs(j).max(), 1e-30))


@pytest.mark.parametrize("dtype", DTYPES)
def test_prox_matches_jax(dtype):
    rng = np.random.default_rng(0)
    v = _rand(rng, (3, 4, 5), dtype)
    v[0, 0, :2] = 0
    rdt = "float64" if dtype in ("float64", "complex128") else "float32"
    alpha = np.abs(rng.standard_normal((1, 4, 1))).astype(rdt)
    tv = torch.tensor(v)
    _close(tpx.prox_l1(tv, torch.tensor(alpha)),
           jpx.prox_l1(jnp.asarray(v), jnp.asarray(alpha)), dtype)
    _close(tpx.prox_l1(tv, 0.3), jpx.prox_l1(jnp.asarray(v), 0.3), dtype)
    _close(tpx.norm_l1(tv), jpx.norm_l1(jnp.asarray(v)), dtype)
    _close(tpx.norm_l1(tv, axis=1), jpx.norm_l1(jnp.asarray(v), axis=1),
           dtype)
    d = _rand(rng, (3, 4, 5), dtype)
    d[1] = 0
    _close(tpx.zdivide(tv, torch.tensor(d)),
           jpx.zdivide(jnp.asarray(v), jnp.asarray(d)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_inner_dot_rrs_match_jax(dtype):
    rng = np.random.default_rng(1)
    x, y = _rand(rng, (2, 3, 4), dtype), _rand(rng, (2, 3, 4), dtype)
    for axis in (0, 1, -1):
        _close(tla.inner(torch.tensor(x), torch.tensor(y), axis),
               jla.inner(jnp.asarray(x), jnp.asarray(y), axis), dtype)
    a = _rand(rng, (5, 3), dtype)
    for axis in (1, -2):
        _close(tla.dot(torch.tensor(a), torch.tensor(x), axis),
               jla.dot(jnp.asarray(a), jnp.asarray(x), axis), dtype)
    _close(tla.rrs(torch.tensor(x), torch.tensor(y)),
           jla.rrs(jnp.asarray(x), jnp.asarray(y)), dtype)
    z = np.zeros_like(x)
    assert float(tla.rrs(torch.tensor(z), torch.tensor(z))) == 0.0
    assert float(tla.rrs(torch.tensor(z), torch.tensor(z))) == \
        float(jla.rrs(jnp.asarray(z), jnp.asarray(z)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_sherman_morrison_solves_match_jax(dtype):
    """The per-bin solves of single-channel CSC, shapes (K, C, M, N0, N1)
    with the filter axis 2, and their solutions of the systems."""
    rng = np.random.default_rng(2)
    ah = _rand(rng, (1, 1, 4, 6, 5), dtype)
    b = _rand(rng, (2, 1, 4, 6, 5), dtype)
    rdt = "float64" if dtype in ("float64", "complex128") else "float32"
    rho = np.asarray(0.7, rdt)
    t_ah, t_b = torch.tensor(ah), torch.tensor(b)
    j_ah, j_b = jnp.asarray(ah), jnp.asarray(b)
    x = tla.solvedbi_sm(t_ah, float(rho), t_b, axis=2)
    _close(x, jla.solvedbi_sm(j_ah, rho, j_b, axis=2), dtype)
    aah = tla.inner(t_ah, t_ah.conj(), axis=2).real
    _close(tla.solvedbi_sm(t_ah, float(rho), t_b, axis=2, aah=aah), x,
           dtype)
    c = tla.solvedbi_sm_c(t_ah, t_ah.conj(), float(rho), axis=2)
    _close(c, jla.solvedbi_sm_c(j_ah, jnp.conj(j_ah), rho, axis=2), dtype)
    _close(tla.solvedbi_sm(t_ah, float(rho), t_b, c=c, axis=2), x, dtype)
    # (rho I + a a^H) x = b with a = conj(ah)
    a = t_ah.conj()
    lhs = float(rho) * x + a * tla.inner(t_ah, x, axis=2)
    assert float((lhs - t_b).abs().max()) < 1e-4 * float(t_b.abs().max())
    d = np.abs(_rand(rng, (1, 1, 1, 6, 5), rdt)) + 0.5
    _close(tla.solvedbd_sm(t_ah, torch.tensor(d), t_b, axis=2),
           jla.solvedbd_sm(j_ah, jnp.asarray(d), j_b, axis=2), dtype)
    _close(tla.solvedbd_sm_c(t_ah, t_ah.conj(), torch.tensor(d), axis=2),
           jla.solvedbd_sm_c(j_ah, jnp.conj(j_ah), jnp.asarray(d), axis=2),
           dtype)


def _rdt(dtype):
    return "float64" if dtype in ("float64", "complex128") else "float32"


@pytest.mark.parametrize("dtype", DTYPES)
def test_norms_and_l0_l2_prox_match_jax(dtype):
    """``norm_l0``/``prox_l0``, ``norm_2l2``/``norm_l2``/``norm_l21`` and
    the group shrinkage and projection ``prox_l2``/``proj_l2``, over no
    axis, one axis and a tuple of axes, with scalar and array
    parameters."""
    rng = np.random.default_rng(3)
    v = _rand(rng, (3, 4, 5), dtype)
    v[1, 2] = 0
    tv, jv = torch.tensor(v), jnp.asarray(v)
    for axis in (None, 1, -1, (0, 2)):
        for eps in (0.0, 0.5):
            np.testing.assert_array_equal(
                tpx.norm_l0(tv, axis=axis, eps=eps).numpy(),
                np.asarray(jpx.norm_l0(jv, axis=axis, eps=eps)))
        _close(tpx.norm_2l2(tv, axis=axis), jpx.norm_2l2(jv, axis=axis),
               dtype)
        _close(tpx.norm_l2(tv, axis=axis), jpx.norm_l2(jv, axis=axis),
               dtype)
        for alpha in (0.7, np.abs(rng.standard_normal((1, 4, 1)))
                      .astype(_rdt(dtype))):
            ta = torch.tensor(alpha) if isinstance(alpha, np.ndarray) \
                else alpha
            ja = jnp.asarray(alpha) if isinstance(alpha, np.ndarray) \
                else alpha
            _close(tpx.prox_l2(tv, ta, axis=axis),
                   jpx.prox_l2(jv, ja, axis=axis), dtype)
            _close(tpx.proj_l2(tv, ta, axis=axis),
                   jpx.proj_l2(jv, ja, axis=axis), dtype)
    for axis in (-1, 0):
        _close(tpx.norm_l21(tv, axis=axis), jpx.norm_l21(jv, axis=axis),
               dtype)
    _close(tpx.prox_l0(tv, 0.3), jpx.prox_l0(jv, 0.3), dtype)
    alpha = np.abs(rng.standard_normal((3, 1, 5))).astype(_rdt(dtype))
    _close(tpx.prox_l0(tv, torch.tensor(alpha)),
           jpx.prox_l0(jv, jnp.asarray(alpha)), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_compound_shrinkages_match_jax(dtype):
    """``prox_sl1l2`` (l2 after l1 shrinkage) over one axis, a tuple and
    none; ``norm_dl1l2``."""
    rng = np.random.default_rng(4)
    v = _rand(rng, (4, 6), dtype)
    tv, jv = torch.tensor(v), jnp.asarray(v)
    for axis in (None, 0, -1, (0, 1)):
        _close(tpx.prox_sl1l2(tv, 0.3, 0.5, axis=axis),
               jpx.prox_sl1l2(jv, 0.3, 0.5, axis=axis), dtype)
    for axis in (None, 0, 1):
        _close(tpx.norm_dl1l2(tv, 0.7, axis=axis),
               jpx.norm_dl1l2(jv, 0.7, axis=axis), dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("alpha,beta", [(0.2, 0.5), (1.5, 0.5),
                                        (2.6, 0.9), (5.0, 0.3)],
                         ids=["u1", "spike", "spike_wide", "zero"])
def test_prox_dl1l2_matches_jax(dtype, alpha, beta):
    """The three branches of ``prox_dl1l2``: the scaled shrinkage where
    ``max|v| > alpha``, the one spike where ``alpha >= max|v| >
    (1 - beta) alpha``, and zero; per column, per row and whole."""
    rng = np.random.default_rng(5)
    v = (2.0 * rng.standard_normal((5, 7))).astype(dtype)
    v[:, 3] *= 0.05
    tv, jv = torch.tensor(v), jnp.asarray(v)
    for axis in (None, 0, 1, -1):
        _close(tpx.prox_dl1l2(tv, alpha, beta, axis=axis),
               jpx.prox_dl1l2(jv, alpha, beta, axis=axis), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_proj_l1_matches_jax(dtype):
    """The sort and cumulative sum projection on the l1 ball: over the
    whole array, one axis and a tuple of axes, inside and outside the
    ball; ``ndto2d``/``ndfrom2d`` round trip."""
    rng = np.random.default_rng(6)
    v = _rand(rng, (3, 4, 5), dtype)
    tv, jv = torch.tensor(v), jnp.asarray(v)
    for gamma in (0.5, 3.0, 1e3):
        for axis in (None, 0, -1, (0, 2), (1,)):
            _close(tpx.proj_l1(tv, gamma, axis=axis),
                   jpx.proj_l1(jv, gamma, axis=axis), dtype)
    for axis in (-1, 1, (0, 2)):
        t2, trsi = tpx.ndto2d(tv, axis)
        j2, jrsi = jpx.ndto2d(jv, axis)
        _close(t2, j2, dtype)
        assert trsi[0] == jrsi[0] and tuple(trsi[1]) == tuple(jrsi[1])
        np.testing.assert_array_equal(tpx.ndfrom2d(t2, trsi).numpy(), v)


@pytest.mark.parametrize("dtype", DTYPES)
def test_nuclear_norm_and_full_prox_match_jax(dtype):
    """``norm_nuclear`` and ``prox_nuclear``'s full SVD, batched over a
    leading axis: ``u diag(s) v^H`` does not depend on the SVD's sign
    conventions."""
    rng = np.random.default_rng(7)
    v = _rand(rng, (2, 6, 9), dtype)
    tv, jv = torch.tensor(v), jnp.asarray(v)
    _close(tpx.norm_nuclear(tv), jpx.norm_nuclear(jv), dtype)
    tx, ts = tpx.prox_nuclear(tv, 1.5)
    jx, js = jpx.prox_nuclear(jv, 1.5)
    rtol = 1e-5 if _rdt(dtype) == "float32" else 1e-12
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=rtol,
                               atol=rtol * np.abs(np.asarray(jx)).max())
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=rtol,
                               atol=rtol * np.abs(np.asarray(js)).max())


def _low_rank(dtype):
    """A 64x64 target of rank 6 with a tail below 0.05, as
    ``tests/ops/test_prox.py:120-134``."""
    rng = np.random.default_rng(7)
    U = np.linalg.qr(rng.standard_normal((64, 64)))[0]
    V = np.linalg.qr(rng.standard_normal((64, 64)))[0]
    sv = np.zeros(64)
    sv[:6] = [50, 40, 30, 20, 10, 5]
    sv[6:] = rng.uniform(0, 0.05, 58)
    return ((U * sv) @ V.T).astype(dtype), sv


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_prox_nuclear_randomized_matches_full_and_jax(dtype):
    """The randomized path on a low-rank target whose tail is below
    alpha: equal to the full path (the default sketch, drawn here), and
    to the JAX package's randomized path when given the JAX sketch."""
    A, sv = _low_rank(dtype)
    tA = torch.tensor(A)
    Xf, _ = tpx.prox_nuclear(tA, 0.1)
    Xr, sr = tpx.prox_nuclear(tA, 0.1, rank=6)
    assert sr.shape == (16,)
    assert float((Xf - Xr).abs().max()) < 1e-4
    np.testing.assert_allclose(sr.numpy()[:6], np.maximum(0, sv[:6] - 0.1),
                               rtol=1e-5)
    sketch = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (64, 16),
                                          jnp.dtype(dtype)))
    Xj, sj = jpx.prox_nuclear(jnp.asarray(A), 0.1, rank=6)
    Xs, ss = tpx.prox_nuclear(tA, 0.1, rank=6,
                              sketch=torch.tensor(sketch))
    rtol = 1e-5 if dtype == "float32" else 1e-12
    np.testing.assert_allclose(ss.numpy(), np.asarray(sj), rtol=rtol,
                               atol=rtol * 50)
    assert float(np.abs(Xs.numpy() - np.asarray(Xj)).max()) < rtol * 50
    with pytest.raises(ValueError, match="sketch of shape"):
        tpx.prox_nuclear(tA, 0.1, rank=6, sketch=torch.zeros(64, 15))
    # the default sketch is the same on every call: a generator seeded 0
    torch.testing.assert_close(tpx.nuclear_sketch((64, 64), 6),
                               tpx.nuclear_sketch((64, 64), 6), rtol=0,
                               atol=0)


def _low_rank_complex(dtype):
    """A complex 64x48 target of rank 6 with a tail below 0.05: the
    complex counterpart of :func:`_low_rank`."""
    rng = np.random.default_rng(17)
    U = np.linalg.qr(_rand(rng, (64, 48), "complex128"))[0]
    V = np.linalg.qr(_rand(rng, (48, 48), "complex128"))[0]
    sv = np.zeros(48)
    sv[:6] = [50, 40, 30, 20, 10, 5]
    sv[6:] = rng.uniform(0, 0.05, 42)
    return ((U * sv) @ V.conj().T).astype(dtype), sv


@pytest.mark.parametrize("svd", ["plain", "jacobi"])
@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_prox_nuclear_complex_both_forms_match_jax(monkeypatch, dtype, svd):
    """``prox_nuclear`` on a complex low-rank target whose tail is below
    alpha, its SVD ``torch.linalg.svd`` or the card's Jacobi schedule in
    PyTorch (``jacobi_svd_plain``): the full form against the JAX
    package's, the randomized form (rank 6, the JAX sketch, real and cast
    to the complex type on both sides) against the JAX package's and
    against the full form."""
    from sporco_tpu_torch.ops import svd as tsvd
    if svd == "jacobi":
        monkeypatch.setattr(tpx, "svd", tsvd.jacobi_svd_plain)
    A, sv = _low_rank_complex(dtype)
    tA, jA = torch.tensor(A), jnp.asarray(A)
    rtol = 1e-5 if dtype == "complex64" else 1e-12
    Xf, sf = tpx.prox_nuclear(tA, 0.1)
    Xj, sj = jpx.prox_nuclear(jA, 0.1)
    assert Xf.dtype == tA.dtype and sf.dtype == tA.real.dtype
    np.testing.assert_allclose(sf.numpy(), np.asarray(sj), rtol=rtol,
                               atol=rtol * 50)
    assert float(np.abs(Xf.numpy() - np.asarray(Xj)).max()) < rtol * 50
    rdt = "float32" if dtype == "complex64" else "float64"
    sketch = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (48, 16),
                                          jnp.dtype(rdt)))
    Xr, sr = tpx.prox_nuclear(tA, 0.1, rank=6, sketch=torch.tensor(sketch))
    Xjr, sjr = jpx.prox_nuclear(jA, 0.1, rank=6)
    assert sr.shape == (16,) and Xr.dtype == tA.dtype
    np.testing.assert_allclose(sr.numpy(), np.asarray(sjr), rtol=rtol,
                               atol=rtol * 50)
    assert float(np.abs(Xr.numpy() - np.asarray(Xjr)).max()) < rtol * 50
    np.testing.assert_allclose(sr.numpy()[:6], np.maximum(0, sv[:6] - 0.1),
                               rtol=1e-5)
    assert float((Xf - Xr).abs().max()) < 1e-4


def _gram_problem(shape, dtype, nb=3, right=False):
    rng = np.random.default_rng(8)
    A = rng.standard_normal(shape).astype(dtype)
    n, m = shape
    b = rng.standard_normal((nb, n) if right else (m, nb)).astype(dtype)
    return A, b


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(16, 8), (8, 16)], ids=["tall", "wide"])
def test_gram_eig_solves_match_jax(dtype, shape):
    """``gram_eig_factor`` and the four Gram solves, left and right, for
    two rho from one factor: against the JAX package and against a
    dense solve.  The eigenvectors differ in sign from LAPACK's as
    called by JAX; the solves do not."""
    A, b = _gram_problem(shape, dtype)
    _, bt = _gram_problem(shape, dtype, right=True)
    n, m = shape
    rng = np.random.default_rng(9)
    s = rng.standard_normal((n, 3)).astype(dtype)
    v = rng.standard_normal((m, 3)).astype(dtype)
    sr = rng.standard_normal((3, m)).astype(dtype)
    vr = rng.standard_normal((3, n)).astype(dtype)
    tf = tla.gram_eig_factor(torch.tensor(A))
    jf = jla.gram_eig_factor(jnp.asarray(A))
    assert tf.of_ata == jf.of_ata == (n >= m)
    _close(tf.evals, jf.evals, dtype)
    tol = 1e-5 if dtype == "float32" else 1e-11
    G = A.astype(np.float64)
    for rho in (0.3, 7.0):
        pairs = [
            (tla.gram_solve_atai(tf, rho, torch.tensor(b)),
             jla.gram_solve_atai(jf, rho, jnp.asarray(b)),
             np.linalg.solve(G.T @ G + rho * np.eye(m), b)),
            (tla.gram_solve_aati(tf, rho, torch.tensor(bt)),
             jla.gram_solve_aati(jf, rho, jnp.asarray(bt)),
             bt @ np.linalg.inv(G @ G.T + rho * np.eye(n))),
            (tla.gram_solve_atai_split(tf, rho, torch.tensor(s),
                                       torch.tensor(v)),
             jla.gram_solve_atai_split(jf, rho, jnp.asarray(s),
                                       jnp.asarray(v)),
             np.linalg.solve(G.T @ G + rho * np.eye(m),
                             G.T @ s + rho * v)),
            (tla.gram_solve_aati_split(tf, rho, torch.tensor(sr),
                                       torch.tensor(vr)),
             jla.gram_solve_aati_split(jf, rho, jnp.asarray(sr),
                                       jnp.asarray(vr)),
             (sr @ G.T + rho * vr) @ np.linalg.inv(G @ G.T
                                                   + rho * np.eye(n)))]
        for t, j, ref in pairs:
            t, j = t.numpy(), np.asarray(j)
            scale = np.abs(ref).max()
            assert np.abs(t - j).max() <= tol * scale
            assert np.abs(t - ref).max() <= 10 * tol * scale


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(16, 8), (8, 16)], ids=["tall", "wide"])
@pytest.mark.parametrize("lower", [False, True])
def test_cholesky_and_lu_solves_match_jax(dtype, shape, lower):
    """``cho_factor``/``cho_solve_ATAI``/``cho_solve_AATI`` (upper and
    lower) and ``lu_factor``/``lu_solve_ATAI``/``lu_solve_AATI`` against
    the JAX package's wrappers and a dense solve."""
    A, b = _gram_problem(shape, dtype, nb=2)
    _, bt = _gram_problem(shape, dtype, nb=2, right=True)
    n, m = shape
    rho = 0.5
    G = A.astype(np.float64)
    ref_l = np.linalg.solve(G.T @ G + rho * np.eye(m), b)
    ref_r = bt @ np.linalg.inv(G @ G.T + rho * np.eye(n))
    tA, jA = torch.tensor(A), jnp.asarray(A)
    tc, tl = tla.cho_factor(tA, rho, lower=lower)
    jc, jl = jla.cho_factor(jA, rho, lower=lower)
    assert tl == jl == lower
    tlu = tla.lu_factor(tA, rho)
    jlu = jla.lu_factor(jA, rho)
    tol = 1e-5 if dtype == "float32" else 1e-11
    got = [
        (tla.cho_solve_ATAI(tA, rho, torch.tensor(b), tc, lower),
         jla.cho_solve_ATAI(jA, rho, jnp.asarray(b), jc, lower), ref_l),
        (tla.cho_solve_AATI(tA, rho, torch.tensor(bt), tc, lower),
         jla.cho_solve_AATI(jA, rho, jnp.asarray(bt), jc, lower), ref_r),
        (tla.lu_solve_ATAI(tA, rho, torch.tensor(b), tlu),
         jla.lu_solve_ATAI(jA, rho, jnp.asarray(b), jlu), ref_l),
        (tla.lu_solve_AATI(tA, rho, torch.tensor(bt), tlu),
         jla.lu_solve_AATI(jA, rho, jnp.asarray(bt), jlu), ref_r)]
    for t, j, ref in got:
        t, j = t.numpy(), np.asarray(j)
        scale = np.abs(ref).max()
        assert np.abs(t - j).max() <= tol * scale
        assert np.abs(t - ref).max() <= 10 * tol * scale
