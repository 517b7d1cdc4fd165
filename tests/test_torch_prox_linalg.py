"""The port's ``ops.prox`` and ``ops.linalg`` against the JAX package's on
the same seeded numpy inputs, real and complex, float32 and float64.

Tolerances: 1e-6 relative in float32 and 1e-12 in float64, the rounding
of a few operations in different orders; elementwise operations agree
to the last bit in practice."""

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
