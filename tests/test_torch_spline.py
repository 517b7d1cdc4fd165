"""The port's ``SplineL1``, its orthonormal DCT-II (``ops.fft.dctii``/
``idctii``) and the rest of ``ops.linalg`` (``pca``, ``nkp``, ``kpsvd``,
``block_circulant``, ``solve_symmetric_sylvester``, ``solvemdbi_rsm``,
``valid_adjoint``, ``proj_l2ball``) on the CPU against the JAX package's
on the same seeded numpy inputs.

SplineL1 runs ``examples/misc_spline_demosaic.py``'s problem (a smooth
surface with 20 outliers, DFidWeight 0 on them, lmbda 0.1, to 5e-4) at
the tolerances of ``tests/test_torch_maskdcpl.py``: float64 the same
iteration count, every row to rtol 1e-6 and X within 1e-8 of its scale;
float32 over 10 iterations the rows to rtol 1e-4 (the residuals 1e-3)
and X within 2e-4; whole float32 solves the iteration count within one
and the last objective to rtol 1e-3.  The DCT (a product with the DCT
matrix along each axis here, ``jax.scipy.fft.dctn`` there) is held to
1e-12 of its input's scale in float64 and 1e-5 in float32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sporco_tpu.models import spline as js
from sporco_tpu.ops import fft as jsf
from sporco_tpu.ops import linalg as jla
from sporco_tpu_torch.models import spline as ts
from sporco_tpu_torch.ops import fft as tsf
from sporco_tpu_torch.ops import linalg as tla

torch.set_num_threads(2)

RSDL = ("PrimalRsdl", "DualRsdl")


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close(t, j, rel):
    t, j = (t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t),
            np.asarray(j))
    assert t.shape == j.shape
    assert np.abs(t - j).max() <= rel * max(np.abs(j).max(), 1e-30)


# ---------------------------------------------------------------------------
# dctii / idctii

@pytest.mark.parametrize("dtype,rel", [("float64", 1e-12), ("float32", 1e-5)])
@pytest.mark.parametrize("axes", [(0,), (1,), (0, 1), (0, 1, 2), None],
                         ids=str)
@pytest.mark.parametrize("shape", [(8, 6, 4), (7, 9, 5)], ids=str)
def test_dct_matches_jax(shape, axes, dtype, rel):
    """Even and odd lengths, on 1, 2 and 3 axes (None: all), forward and
    inverse, and the round trip."""
    x = _rng(1).standard_normal(shape).astype(dtype)
    jd = jsf.dctii(jnp.asarray(x), axes=axes)
    td = tsf.dctii(_t(x), axes=axes)
    assert td.dtype == getattr(torch, dtype)
    _close(td, jd, rel)
    _close(tsf.idctii(_t(x), axes=axes), jsf.idctii(jnp.asarray(x),
                                                     axes=axes), rel)
    _close(tsf.idctii(td, axes=axes), x, rel)


# ---------------------------------------------------------------------------
# the rest of linalg

def test_pca_matches_jax():
    """The basis (up to each column's sign), the eigenvalues and the
    mean, with and without centring."""
    u = _rng(2).standard_normal((5, 200)) * np.arange(1, 6)[:, None] + 0.3
    for centre in (False, True):
        jB, jS, jC = jla.pca(jnp.asarray(u), centre=centre)
        tB, tS, tC = tla.pca(_t(u), centre=centre)
        _close(tS, jS, 1e-12)
        sign = np.sign(np.sum(tB.numpy() * np.asarray(jB), axis=0))
        _close(tB.numpy() * sign, jB, 1e-10)
        if centre:
            _close(tC, jC, 1e-12)
        else:
            assert tC is None and jC is None


def test_nkp_and_kpsvd_match_jax():
    """The nearest Kronecker product (its factors up to a common sign)
    and the Kronecker SVD, whose terms sum back to A."""
    rng = _rng(3)
    B0, C0 = rng.standard_normal((3, 4)), rng.standard_normal((2, 5))
    A = np.kron(B0, C0) + 0.01 * rng.standard_normal((6, 20))
    jb, jc = jla.nkp(jnp.asarray(A), (3, 4), (2, 5))
    tb, tc = tla.nkp(_t(A), (3, 4), (2, 5))
    sgn = np.sign(np.sum(tb.numpy() * np.asarray(jb)))
    _close(tb.numpy() * sgn, jb, 1e-10)
    _close(tc.numpy() * sgn, jc, 1e-10)
    _close(torch.kron(tb, tc), np.kron(np.asarray(jb), np.asarray(jc)),
           1e-10)
    js_, jB, jC = jla.kpsvd(jnp.asarray(A), (3, 4), (2, 5))
    ts_, tB, tC = tla.kpsvd(_t(A), (3, 4), (2, 5))
    _close(ts_, js_, 1e-12)
    assert tB.shape == jB.shape and tC.shape == jC.shape
    rec = sum(float(ts_[k]) * np.kron(tB[..., k].numpy(), tC[..., k].numpy())
              for k in range(ts_.shape[0]))
    _close(rec, A, 1e-10)


def test_block_circulant_matches_jax():
    blocks = [_rng(k).standard_normal((2, 3)) for k in range(4)]
    _close(tla.block_circulant(blocks), jla.block_circulant(blocks), 0)
    _close(tla.block_circulant([_t(b) for b in blocks]),
           jla.block_circulant(blocks), 0)


@pytest.mark.parametrize("form", ["matrix", "eig", "diagonal"])
def test_solve_symmetric_sylvester_matches_jax(form):
    """``A X B + alpha X = C`` with ``A`` and ``B`` given as matrices,
    eigendecomposition pairs, or ``B`` as a diagonal vector."""
    rng = _rng(4)
    A = rng.standard_normal((5, 5))
    A = A @ A.T
    B = rng.standard_normal((4, 4))
    B = B @ B.T
    C = rng.standard_normal((5, 4))
    if form == "diagonal":
        B = np.abs(rng.standard_normal(4))
    jA, jB, tA, tB = jnp.asarray(A), jnp.asarray(B), _t(A), _t(B)
    if form == "eig":
        jA, tA = jnp.linalg.eigh(jA), torch.linalg.eigh(tA)
        tA = (tA.eigenvalues, tA.eigenvectors)
    X = tla.solve_symmetric_sylvester(tA, tB, _t(C), 0.5)
    _close(X, jla.solve_symmetric_sylvester(jA, jB, jnp.asarray(C), 0.5),
           1e-10)
    Bm = np.diag(B) if form == "diagonal" else B
    _close(A @ X.numpy() @ Bm + 0.5 * X.numpy(), C, 1e-10)


def test_solvemdbi_rsm_matches_jax():
    """The explicit-inverse solve of ``(rho I + sum_k a_k a_k^H) x = b``
    per pixel, complex, against the JAX one and a dense solve."""
    rng = _rng(5)
    ah = (rng.standard_normal((6, 3, 4)) + 1j * rng.standard_normal(
        (6, 3, 4)))
    b = rng.standard_normal((6, 4)) + 1j * rng.standard_normal((6, 4))
    x = tla.solvemdbi_rsm(_t(ah), 0.7, _t(b), 2)
    _close(x, jla.solvemdbi_rsm(jnp.asarray(ah), 0.7, jnp.asarray(b), 2),
           1e-12)
    for p in range(6):
        a = ah[p].conj()
        G = 0.7 * np.eye(4) + a.T @ ah[p]
        _close(x[p], np.linalg.solve(G, b[p]), 1e-10)


def test_valid_adjoint_and_proj_l2ball_match_jax():
    """The adjoint test passes for a pair and its transpose and fails for
    a wrong one, in both packages; the l2-ball projection about a
    centre."""
    rng = _rng(6)
    Am = rng.standard_normal((7, 5))
    assert tla.valid_adjoint(lambda u: _t(Am) @ u, lambda v: _t(Am).T @ v,
                             (5,), (7,), device="cpu")
    assert jla.valid_adjoint(lambda u: jnp.asarray(Am) @ u,
                             lambda v: jnp.asarray(Am).T @ v, (5,), (7,))
    wrong = Am.copy()
    wrong[0, 0] += 1.0
    err = tla.valid_adjoint(lambda u: _t(Am) @ u,
                            lambda v: _t(wrong).T @ v, (5,), (7,), eps=None,
                            device="cpu")
    jerr = jla.valid_adjoint(lambda u: jnp.asarray(Am) @ u,
                             lambda v: jnp.asarray(wrong).T @ v, (5,), (7,),
                             eps=None)
    assert err > 1e-3 and float(jerr) > 1e-3
    b, s = rng.standard_normal((4, 6)), rng.standard_normal((4, 6))
    for axes in (None, (1,)):
        _close(tla.proj_l2ball(_t(b), _t(s), 0.5, axes=axes),
               jla.proj_l2ball(jnp.asarray(b), jnp.asarray(s), 0.5,
                               axes=axes), 1e-12)


# ---------------------------------------------------------------------------
# SplineL1

def _spline_problem(n=32, seed=12345):
    """The example's surface ``cos x cos y`` with 20 outliers, its
    DFidWeight 0 on them."""
    rng = np.random.default_rng(seed)
    x = np.cos(np.linspace(0, np.pi, n))[np.newaxis, :]
    U = x * x.T
    V = rng.standard_normal((n, n))
    t = np.sort(np.abs(V).ravel())[V.size - 20]
    V[np.abs(V) < t] = 0
    return (U + V).astype(np.float32), U, (V == 0).astype(np.float32)


def _pair(dtype, max_iter, tol, **kw):
    S, _, W = _spline_problem()
    kw = {"Wdf": W, **kw}
    a = js.SplineL1(S, 0.1, dtype=dtype, opt=js.SplineL1.options(
        max_iter=max_iter, rel_stop_tol=tol), **kw)
    a.solve()
    b = ts.SplineL1(S, 0.1, dtype=dtype, device="cpu",
                    opt=ts.SplineL1.options(max_iter=max_iter,
                                            rel_stop_tol=tol), **kw)
    b.solve()
    return a, b


def _assert_rows(a, b, rtol, rsdl_rtol):
    ja, ta = a.getitstat(), b.getitstat()
    assert ta._names == ja._names
    for name in ja._names:
        if name == "XSlvRelRes":
            np.testing.assert_allclose(getattr(ta, name), getattr(ja, name),
                                       rtol=0, atol=1e-12)
            continue
        np.testing.assert_allclose(
            getattr(ta, name), getattr(ja, name), err_msg=name, atol=1e-30,
            rtol=rsdl_rtol if name in RSDL else rtol)


@pytest.mark.parametrize("kw", [{}, {"lin_check": True},
                                {"g_eval_y": False}, {"Wdf": 1.0}],
                         ids=["default", "lin_check", "g_eval_x", "no_wdf"])
def test_spline_float64_matches_jax(kw):
    a, b = _pair("float64", 500, 5e-4, **kw)
    assert len(a.getitstat()) == len(b.getitstat()) < 500
    _assert_rows(a, b, 1e-6, 1e-6)
    _close(b.getmin(), a.getmin(), 1e-8)
    if kw.get("lin_check"):
        assert np.nanmax(b.getitstat().XSlvRelRes) < 1e-12


def test_spline_float32_iterations_match_jax():
    a, b = _pair("float32", 10, 0.0)
    _assert_rows(a, b, 1e-4, 1e-3)
    _close(b.getmin(), a.getmin(), 2e-4)


def test_spline_float32_solve_matches_jax():
    a, b = _pair("float32", 500, 5e-4)
    ja, ta = a.getitstat(), b.getitstat()
    assert abs(len(ja) - len(ta)) <= 1 and len(ta) < 500
    np.testing.assert_allclose(ta.ObjFun[-1], ja.ObjFun[-1], rtol=1e-3)


def test_spline_fits_through_outliers():
    """The fit is closer to the clean surface than the corrupted data."""
    S, U, W = _spline_problem()
    b = ts.SplineL1(S, 0.1, Wdf=W, dtype="float64", device="cpu",
                    opt=ts.SplineL1.options(max_iter=250,
                                            rel_stop_tol=5e-4))
    X = b.solve().numpy()
    assert np.mean((X - U) ** 2) < 0.1 * np.mean((S - U) ** 2)


def test_spline_three_channels_and_options():
    """A three-channel signal smoothed over the two spatial axes, the
    reference's option keys, the card default."""
    S, _, W = _spline_problem()
    S3 = np.stack([S, 0.5 * S, -S], axis=-1)
    opt = {"MaxMainIter": 30, "gEvalY": False, "DFidWeight": W[..., None],
           "RelStopTol": 0.0}
    a = js.SplineL1(S3, 0.1, opt=opt, dtype=np.float64)
    a.solve()
    b = ts.SplineL1(S3, 0.1, opt=opt, dtype="float64", device="cpu")
    b.solve()
    assert not b.cfg.g_eval_y and b.opts.max_iter == 30
    _assert_rows(a, b, 1e-6, 1e-6)
    _close(b.getmin(), a.getmin(), 1e-8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ts.SplineL1(S, 0.1)
