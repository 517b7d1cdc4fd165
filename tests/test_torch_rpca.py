"""The port's ``models.rpca.RobustPCA`` on the CPU against the JAX
package's on the same seeded numpy problem: ``bench.py``'s
``_bench_rpca`` at 48x48, rank 3 plus 10% sparse outliers at scale 5.

The full SVD needs nothing more: ``u diag(s) v^T`` does not depend on
the SVD's sign conventions.  The randomized SVD is given the JAX
package's sketch (``jax.random.normal(PRNGKey(0), (n, r + 10))``, which
the port cannot draw), so both run the same subspace iteration.

Tolerances: float64, the same iteration count, every row to rtol 1e-6
(float32 rows, equal in practice), X and Y within 1e-8 of their scale;
float32, 10 iterations, ObjFun, NrmNuc, NrmL1 and Rho rows to rtol 1e-4,
the residuals and ``Cnstr`` (a residual norm) to rtol 1e-3, X and Y
within 2e-4; float32 solved to 1e-3, the iteration count within one, X
and Y within 2e-4 and the last ObjFun to rtol 1e-4 (over the whole run
Rho parts by up to 3e-4: AutoRho's scaling follows the float32 residual
ratio, as in ``tests/test_torch_bpdn.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sporco_tpu.models import rpca as jr
from sporco_tpu_torch.models import rpca as tr

torch.set_num_threads(2)

RANK = 6
RSDL = ("PrimalRsdl", "DualRsdl", "Cnstr")


def _problem(N=48, r=3, seed=0):
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((N, r)) @ rng.standard_normal((r, N))
    Ssp = (rng.random((N, N)) > 0.9) * rng.standard_normal((N, N)) * 5
    return (L + Ssp).astype(np.float32), L, Ssp


def _jax_sketch(S, rank, dtype):
    return np.asarray(jax.random.normal(
        jax.random.PRNGKey(0), (S.shape[1], rank + 10), jnp.dtype(dtype)))


def _pair(S, dtype, rank, max_iter, tol):
    a = jr.RobustPCA(S, opt=jr.RobustPCA.options(max_iter=max_iter,
                                                 rel_stop_tol=tol),
                     dtype=dtype, svd_rank=rank)
    a.solve()
    kw = {} if rank is None else {"sketch": _jax_sketch(S, rank, dtype)}
    b = tr.RobustPCA(S, opt=tr.RobustPCA.options(max_iter=max_iter,
                                                 rel_stop_tol=tol),
                     dtype=dtype, svd_rank=rank, device="cpu", **kw)
    X, Y = b.solve()
    assert X is b.state.X and Y is b.state.Y
    return a, b


def _assert_states(a, b, rel):
    for jx, tx in ((a.state.X, b.state.X), (a.state.Y, b.state.Y)):
        jx, tx = np.asarray(jx), tx.numpy()
        assert tx.shape == jx.shape and tx.dtype == jx.dtype
        assert np.abs(tx - jx).max() <= rel * np.abs(jx).max()


def _assert_rows(a, b, rtol, rsdl_rtol):
    ja, ta = a.getitstat(), b.getitstat()
    assert ta._names == ja._names and len(ta) == len(ja)
    for name in ja._names:
        np.testing.assert_allclose(getattr(ta, name), getattr(ja, name),
                                   err_msg=name,
                                   rtol=rsdl_rtol if name in RSDL else rtol)


@pytest.mark.parametrize("rank", [None, RANK], ids=["full", "randomized"])
def test_float64_solve_matches_jax(rank):
    S, L, Ssp = _problem()
    a, b = _pair(S, "float64", rank, 200, 1e-3)
    assert len(b.getitstat()) < 200
    _assert_rows(a, b, 1e-6, 1e-6)
    _assert_states(a, b, 1e-8)
    # the low-rank and the sparse part are recovered
    assert np.abs(b.state.X.numpy() - L).max() < 1e-2 * np.abs(L).max()
    assert np.abs(b.state.Y.numpy() - Ssp).max() < 1e-2 * np.abs(Ssp).max()


@pytest.mark.parametrize("rank", [None, RANK], ids=["full", "randomized"])
def test_float32_iterations_match_jax(rank):
    S, _, _ = _problem()
    a, b = _pair(S, "float32", rank, 10, 0.0)
    _assert_rows(a, b, 1e-4, 1e-3)
    _assert_states(a, b, 2e-4)


@pytest.mark.parametrize("rank", [None, RANK], ids=["full", "randomized"])
def test_float32_solve_matches_jax(rank):
    S, _, _ = _problem()
    a, b = _pair(S, "float32", rank, 200, 1e-3)
    ja, ta = a.getitstat(), b.getitstat()
    assert abs(len(ja) - len(ta)) <= 1 and len(ta) < 200
    np.testing.assert_allclose(ta.ObjFun[-1], ja.ObjFun[-1], rtol=1e-4)
    _assert_states(a, b, 2e-4)


def test_default_sketch_and_options():
    """Without ``sketch`` the model draws one from a generator seeded 0
    (the same for two models), and an explicit ``sketch`` is used as
    given; a reference option dict; the default lmbda."""
    S, L, _ = _problem()
    opt = {"MaxMainIter": 200, "RelStopTol": 1e-3, "fEvalX": True,
           "AutoRho": {"RsdlRatio": 1.5}}
    b = tr.RobustPCA(S, opt=dict(opt), svd_rank=RANK, device="cpu")
    c = tr.RobustPCA(S, opt=dict(opt), svd_rank=RANK, device="cpu")
    sk = np.random.default_rng(1).standard_normal((48, RANK + 10))
    d = tr.RobustPCA(S, opt=dict(opt), svd_rank=RANK, sketch=sk,
                     device="cpu")
    assert b.params["sketch"].shape == (48, RANK + 10)
    assert torch.equal(b.params["sketch"], c.params["sketch"])
    torch.testing.assert_close(d.params["sketch"],
                               torch.tensor(sk, dtype=torch.float32),
                               rtol=0, atol=0)
    assert b.lmbda == 48 ** -0.5 and b.opts.auto_rho.rsdl_ratio == 1.5
    X, _ = b.solve()
    assert np.abs(X.numpy() - L).max() < 1e-2 * np.abs(L).max()
    a = jr.RobustPCA(S, opt=dict(opt))
    assert a.opts.auto_rho.rsdl_ratio == b.opts.auto_rho.rsdl_ratio


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(writer, tmp_path):
    """A state file of either package resumes in the other: 6 iterations,
    then 6 more (float64, randomized SVD with the JAX sketch)."""
    S, _, _ = _problem()
    a, b = _pair(S, "float64", RANK, 6, 0.0)
    path = str(tmp_path / "state.npz")
    (a if writer == "jax" else b).save_state(path)
    if writer == "jax":
        b = tr.RobustPCA(S, opt=tr.RobustPCA.options(max_iter=6,
                                                     rel_stop_tol=0.0),
                         dtype="float64", svd_rank=RANK, device="cpu",
                         sketch=_jax_sketch(S, RANK, "float64"))
        b.load_state_file(path)
    else:
        a = jr.RobustPCA(S, opt=jr.RobustPCA.options(max_iter=6,
                                                     rel_stop_tol=0.0),
                         dtype="float64", svd_rank=RANK)
        a.load_state_file(path)
    a.solve()
    b.solve()
    assert int(a.state.k) == int(b.state.k) == 12
    _assert_rows(a, b, 1e-6, 1e-6)
    _assert_states(a, b, 1e-8)


PROX_SHAPES = [(40, 24), (24, 40), (32, 32)]
PROX_RANK = 5


def _prox_problem(shape, dtype, seed=3):
    """A rank-4 matrix plus noise and an ``alpha`` between its 6th and
    7th singular values: six are kept, the rest thresholded to 0; complex
    for a complex ``dtype`` (its imaginary parts drawn after the real
    ones)."""
    rng = np.random.default_rng(seed)
    m, n = shape
    v = 3.0 * rng.standard_normal((m, 4)) @ rng.standard_normal((4, n)) \
        + 0.3 * rng.standard_normal((m, n))
    if np.dtype(dtype).kind == "c":
        v = v + 1j * (3.0 * rng.standard_normal((m, 4))
                      @ rng.standard_normal((4, n))
                      + 0.3 * rng.standard_normal((m, n)))
    v = v.astype(dtype)
    s = np.linalg.svd(v.astype(np.complex128), compute_uv=False)
    return v, float(0.5 * (s[5] + s[6]))


@pytest.mark.parametrize("shape", PROX_SHAPES, ids=["tall", "wide",
                                                    "square"])
@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64",
                                   "complex128"])
@pytest.mark.parametrize("rank", [None, PROX_RANK],
                         ids=["full", "randomized"])
@pytest.mark.parametrize("svd", ["plain", "jacobi"])
def test_prox_nuclear_matches_jax(monkeypatch, shape, dtype, rank, svd):
    """The port's ``prox_nuclear`` (the algebra the card route takes)
    against ``sporco_tpu.ops.prox`` on m > n, m < n and square matrices,
    real and complex, with ``alpha`` set so that some singular values are
    zeroed; the randomized form with the JAX sketch (real, cast to the
    complex type on both sides).  Its SVD the CPU's
    (``torch.linalg.svd``) or the plain version of the card's Jacobi SVD
    (``ops/svd.py`` ``jacobi_svd_plain``).  X within 1e-10 of its scale
    in float64 and 1e-5 in float32, the thresholded singular values
    likewise of the largest."""
    from sporco_tpu.ops import prox as jpx
    from sporco_tpu_torch.ops import prox as tpx
    from sporco_tpu_torch.ops import svd as tsvd
    if svd == "jacobi":
        monkeypatch.setattr(tpx, "svd", tsvd.jacobi_svd_plain)
    v, alpha = _prox_problem(shape, dtype)
    kw = {}
    if rank is not None:
        # r = rank + 10 <= min(m, n): the JAX package's (n, r) draw
        kw["sketch"] = torch.tensor(_jax_sketch(v, rank,
                                                v.real.dtype.name))
    jx, js = jpx.prox_nuclear(jnp.asarray(v), alpha, rank=rank)
    tx, ts = tpx.prox_nuclear(torch.tensor(v), alpha, rank=rank, **kw)
    jx, js = np.asarray(jx), np.asarray(js)
    assert tx.dtype == torch.tensor(v).dtype and tx.shape == jx.shape
    assert ts.shape == js.shape
    # some values are zeroed, some kept
    assert 0 < np.count_nonzero(js) < js.size
    tol = 1e-10 if dtype in ("float64", "complex128") else 1e-5
    assert np.abs(tx.numpy() - jx).max() <= tol * np.abs(jx).max()
    assert np.abs(ts.numpy() - js).max() <= tol * js[0]


# ---------------------------------------------------------------------------
# Complex Robust PCA (the JAX package's dtype=complex64 or complex128):
# a 48 x 40 matrix of rank 4 plus 10% complex outliers at scale 5


def _complex_problem(m=48, n=40, r=4, seed=5):
    rng = np.random.default_rng(seed)

    def cn(*shape):
        return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)
    L = cn(m, r) @ cn(r, n)
    Ssp = (rng.random((m, n)) > 0.9) * cn(m, n) * 5
    return (L + Ssp).astype(np.complex128), L, Ssp


def _complex_pair(monkeypatch, dtype, rank, svd, max_iter, tol):
    """The JAX package's complex Robust PCA and the port's on the CPU, the
    port's prox SVD ``torch.linalg.svd`` ("plain") or the card's schedule
    in PyTorch (``jacobi_svd_plain``); the randomized form with the JAX
    sketch."""
    from sporco_tpu_torch.ops import prox as tpx
    from sporco_tpu_torch.ops import svd as tsvd
    if svd == "jacobi":
        monkeypatch.setattr(tpx, "svd", tsvd.jacobi_svd_plain)
    S, L, Ssp = _complex_problem()
    rdt = "float64" if dtype == "complex128" else "float32"
    a = jr.RobustPCA(S, opt=jr.RobustPCA.options(max_iter=max_iter,
                                                 rel_stop_tol=tol),
                     dtype=dtype, svd_rank=rank)
    a.solve()
    kw = {} if rank is None else {"sketch": _jax_sketch(S, rank, rdt)}
    b = tr.RobustPCA(S, opt=tr.RobustPCA.options(max_iter=max_iter,
                                                 rel_stop_tol=tol),
                     dtype=dtype, svd_rank=rank, device="cpu", **kw)
    b.solve()
    assert b.state.X.dtype == getattr(torch, dtype)
    return a, b, L, Ssp


@pytest.mark.parametrize("svd", ["plain", "jacobi"])
@pytest.mark.parametrize("rank", [None, RANK], ids=["full", "randomized"])
def test_complex128_solve_matches_jax(monkeypatch, rank, svd):
    """complex128 to 1e-3: the same iteration count, every row (real, as
    the JAX package's) to rtol 1e-6, X and Y within 1e-8 of their scale,
    and the low-rank and sparse parts recovered to 1% of their norms."""
    a, b, L, Ssp = _complex_pair(monkeypatch, "complex128", rank, svd, 200,
                                 1e-3)
    assert len(b.getitstat()) < 200
    for name in b.getitstat()._names:
        assert np.isrealobj(np.asarray(getattr(b.getitstat(), name)))
    _assert_rows(a, b, 1e-6, 1e-6)
    _assert_states(a, b, 1e-8)
    for got, want in ((b.state.X, L), (b.state.Y, Ssp)):
        assert np.linalg.norm(got.numpy() - want) < \
            1e-2 * np.linalg.norm(want)


@pytest.mark.parametrize("svd", ["plain", "jacobi"])
@pytest.mark.parametrize("rank", [None, RANK], ids=["full", "randomized"])
def test_complex64_iterations_match_jax(monkeypatch, rank, svd):
    """complex64 over 10 iterations: every row to rtol 1e-4, X and Y
    within 2e-4 of their scale (the float32 test's array tolerance)."""
    a, b, _, _ = _complex_pair(monkeypatch, "complex64", rank, svd, 10, 0.0)
    _assert_rows(a, b, 1e-4, 1e-4)
    _assert_states(a, b, 2e-4)
