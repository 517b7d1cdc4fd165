"""The thin SVD of the port's nuclear prox (``sporco_tpu_torch/ops/svd.py``)
on the CPU: ``svd`` is ``torch.linalg.svd`` there, and the plain version
of the card's one-sided Jacobi SVD (``jacobi_svd_plain``, the kernels'
schedule in PyTorch) against ``numpy.linalg.svd``.

Tolerances: ``8 L eps`` for rows of length ``L`` (float32 ``eps``
1.2e-7, float64 2.2e-16): the singular values of the largest, ``u
diag(s) v^T`` of ``a``'s norm, ``u`` and ``v`` orthonormal.  An entry
goes through some ``P`` rotations a sweep, each rounding it: at 200 x
200 in float64 (12 sweeps) the product parts from ``a`` by 2.4 L eps and
``v`` from orthonormal by 2.7 L eps, ten to thirty times LAPACK's
``gesdd``.  A float32 matrix is decomposed in float64 and the results
rounded.  The card's kernels are held against these in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sporco_tpu_torch.ops import svd as tsvd

torch.set_num_threads(2)

DTYPES = [torch.float32, torch.float64]


def _tol(a):
    return 8 * max(a.shape) * torch.finfo(a.dtype).eps


def _assert_svd(a, u, s, vt):
    m, n = a.shape
    k = min(m, n)
    assert u.shape == (m, k) and s.shape == (k,) and vt.shape == (k, n)
    assert u.dtype == s.dtype == vt.dtype == a.dtype
    tol = _tol(a)
    ref = np.linalg.svd(a.double().numpy(), compute_uv=False)
    scale = max(ref[0], 1e-300)
    assert np.abs(s.double().numpy() - ref).max() <= tol * scale
    assert bool((s[:-1] >= s[1:]).all())
    rec = (u * s) @ vt - a
    assert float(rec.norm()) <= tol * max(float(a.norm()), 1e-300)
    nz = (s > 0).numpy()
    uu = (u.mT @ u).numpy()[np.ix_(nz, nz)]
    vv = (vt @ vt.mT).numpy()[np.ix_(nz, nz)]
    eye = np.eye(int(nz.sum()))
    assert np.abs(uu - eye).max() <= tol
    assert np.abs(vv - eye).max() <= tol


@settings(max_examples=40, deadline=None, derandomize=True)
@given(m=st.integers(1, 40), n=st.integers(1, 40),
       f64=st.booleans(), seed=st.integers(0, 2 ** 31 - 1),
       scale=st.sampled_from([1e-20, 1.0, 1e20]))
def test_jacobi_plain_matches_numpy(m, n, f64, seed, scale):
    """Random shapes (tall, wide, square, single rows and columns) and
    scales far from 1."""
    dt = torch.float64 if f64 else torch.float32
    a = torch.tensor(np.random.default_rng(seed).standard_normal((m, n))
                     * scale, dtype=dt)
    _assert_svd(a, *tsvd.jacobi_svd_plain(a))
    assert tsvd.LAST["form"] == "plain"
    assert tsvd.LAST["sweeps"] < tsvd.SWEEP_CAP


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(60, 60), (26, 512), (512, 26)],
                         ids=["square", "wide", "tall"])
def test_jacobi_plain_at_the_prox_shapes(dtype, shape):
    """A 60 x 60 square and the randomized prox's small matrix and its
    transpose (rank 16 plus 10 over 512 columns)."""
    a = torch.tensor(np.random.default_rng(1).standard_normal(shape),
                     dtype=dtype)
    _assert_svd(a, *tsvd.jacobi_svd_plain(a))


@pytest.mark.parametrize("dtype", DTYPES)
def test_jacobi_plain_rank_deficient(dtype):
    """Rank 3 of 20 columns with a zero column, and a zero matrix: the
    product holds; a zero singular value's vector on the side of the
    rotated rows (``u`` for m >= n, ``v`` for m < n) is zero."""
    rng = np.random.default_rng(2)
    a = rng.standard_normal((30, 3)) @ rng.standard_normal((3, 20))
    a[:, 5] = 0.0
    a = torch.tensor(a, dtype=dtype)
    u, s, vt = tsvd.jacobi_svd_plain(a)
    _assert_svd(a, u, s, vt)
    assert float(s[3:].abs().max()) <= _tol(a) * float(s[0])
    for shape in ((4, 6), (6, 4)):
        z = torch.zeros(shape, dtype=dtype)
        u, s, vt = tsvd.jacobi_svd_plain(z)
        assert not bool(s.any())
        assert not bool((vt if shape[0] < shape[1] else u).any())
        q = u if shape[0] < shape[1] else vt
        assert torch.equal(q, torch.eye(4, dtype=dtype))


@pytest.mark.parametrize("dtype", DTYPES)
def test_jacobi_plain_failure_gives_nan(dtype):
    """A non-finite input, or sweeps stopped at the cap unconverged, give
    NaN in every output (XLA's convention for a failed SVD)."""
    a = torch.tensor(np.random.default_rng(3).standard_normal((12, 9)),
                     dtype=dtype)
    b = a.clone()
    b[2, 3] = math.inf
    c = a.clone()
    c[0, 0] = math.nan
    for bad in (b, c):
        for t in tsvd.jacobi_svd_plain(bad):
            assert bool(torch.isnan(t).all())
    for t in tsvd.jacobi_svd_plain(a, sweep_cap=1):
        assert bool(torch.isnan(t).all())


def test_geometry():
    """Blocks of at most 8 rows, no more than half the rows rounded up
    to a power of two, two blocks of rows in the shared memory; the rows
    padded to a multiple of two blocks.  Where even two rows do not fit,
    the blocks are as wide as the rows allow and lie in global memory."""
    assert tsvd.geometry(512, 512) == (512, 512, 8, 512)
    assert tsvd.geometry(26, 512) == (26, 512, 8, 32)
    assert tsvd.geometry(512, 26) == (26, 512, 8, 32)
    assert tsvd.geometry(3, 3) == (3, 3, 2, 4)
    assert tsvd.geometry(1, 7) == (1, 7, 1, 2)
    # long rows narrow the blocks: 2 w L 8 bytes within 200 KiB
    assert tsvd.geometry(64, 4000)[2] == 2
    assert tsvd.geometry(64, 1000)[2] == 8
    assert tsvd.shared_rows(12798, 1) and not tsvd.shared_rows(12799, 1)
    assert tsvd.geometry(4, 20000) == (4, 20000, 2, 4)
    assert tsvd.geometry(30000, 8) == (8, 30000, 4, 8)
    assert tsvd.geometry(76800, 100) == (100, 76800, 8, 112)


@pytest.mark.parametrize("shape,dtype", [((4, 20000), torch.float64),
                                         ((30000, 8), torch.float32)],
                         ids=["wide-float64", "tall-float32"])
def test_jacobi_plain_long_rows(shape, dtype):
    """Rows too long for a block's shared memory (the kernel's route in
    global memory, the same schedule) against numpy."""
    a = torch.tensor(np.random.default_rng(6).standard_normal(shape),
                     dtype=dtype)
    _assert_svd(a, *tsvd.jacobi_svd_plain(a))
    assert not tsvd.shared_rows(tsvd.LAST["geometry"][1], 1)


def test_svd_routes_on_the_cpu():
    """On CPU tensors ``svd`` is ``torch.linalg.svd`` (bit for bit) and
    ``jacobi_svd`` the plain version, batched over leading axes; the
    Jacobi SVD takes real float32 and float64 matrices only."""
    rng = np.random.default_rng(4)
    a = torch.tensor(rng.standard_normal((2, 3, 9, 7)))
    ref = torch.linalg.svd(a, full_matrices=False)
    for x, y in zip(tsvd.svd(a), ref):
        assert torch.equal(x, y)
    u, s, vt = tsvd.jacobi_svd(a)
    assert u.shape == (2, 3, 9, 7) and s.shape == (2, 3, 7)
    assert vt.shape == (2, 3, 7, 7)
    for i in range(2):
        for j in range(3):
            _assert_svd(a[i, j], u[i, j], s[i, j], vt[i, j])
    with pytest.raises(NotImplementedError, match="float32 or float64"):
        tsvd.jacobi_svd(a.to(torch.complex128))
    with pytest.raises(ValueError, match="matrices"):
        tsvd.jacobi_svd(torch.zeros(5))
    with pytest.raises(ValueError, match="no route"):
        tsvd.jacobi_svd(torch.zeros(3, 3, device="meta"))
    tsvd.prepare("cpu")         # nothing to build for the CPU


def test_jacobi_plain_float32_works_in_float64():
    """A float32 matrix is decomposed in float64 and the results rounded:
    at 128 x 128 (ten sweeps of 127 rotations a row) every output is the
    float64 decomposition of the same matrix rounded to float32, and the
    singular values lie within one float32 ulp of the largest of numpy's
    (float32 rotations: 0.1 L eps, sixteen times LAPACK's float32 SVD at
    Robust PCA's 512 x 512)."""
    g = np.random.default_rng(5).standard_normal((128, 128))
    a = torch.tensor(g, dtype=torch.float32)
    out = tsvd.jacobi_svd_plain(a)
    for x, y in zip(out, tsvd.jacobi_svd_plain(a.double())):
        assert x.dtype == torch.float32 and torch.equal(x, y.float())
    ref = np.linalg.svd(a.double().numpy(), compute_uv=False)
    assert np.abs(out[1].double().numpy() - ref).max() <= 2.0 ** -23 * ref[0]
