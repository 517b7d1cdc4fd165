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
rounded; a complex64 one in complex128, the same way.  Complex
matrices run the same schedule with Hermitian Gram matrices (``u^H u =
I``, ``vt = V^H``).  The card's kernels are held against these in
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from sporco_tpu_torch.ops import svd as tsvd
from tests._torch_svd import clusters  # noqa: F401

torch.set_num_threads(2)

DTYPES = [torch.float32, torch.float64]
CDTYPES = [torch.complex64, torch.complex128]


def _tol(a):
    return 8 * max(a.shape) * torch.finfo(a.dtype).eps


def _assert_svd(a, u, s, vt):
    """The singular values against numpy's, the product, ``u^H u`` and
    ``vt vt^H`` (real or complex ``a``)."""
    m, n = a.shape
    k = min(m, n)
    assert u.shape == (m, k) and s.shape == (k,) and vt.shape == (k, n)
    assert u.dtype == vt.dtype == a.dtype and s.dtype == a.real.dtype
    tol = _tol(a)
    wide = torch.complex128 if a.is_complex() else torch.float64
    ref = np.linalg.svd(a.to(wide).numpy(), compute_uv=False)
    scale = max(ref[0], 1e-300)
    assert np.abs(s.double().numpy() - ref).max() <= tol * scale
    assert bool((s[:-1] >= s[1:]).all())
    rec = (u * s) @ vt - a
    assert float(rec.norm()) <= tol * max(float(a.norm()), 1e-300)
    nz = (s > 0).numpy()
    uu = (u.mH @ u).numpy()[np.ix_(nz, nz)]
    vv = (vt @ vt.mH).numpy()[np.ix_(nz, nz)]
    eye = np.eye(int(nz.sum()))
    assert np.abs(uu - eye).max() <= tol
    assert np.abs(vv - eye).max() <= tol


def _complex(rng, shape, dtype):
    return torch.tensor(rng.standard_normal(shape)
                        + 1j * rng.standard_normal(shape), dtype=dtype)


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
    to a power of two, the rows padded to a multiple of two blocks;
    clusters of C blocks, the most whose blocks fit the card's 132 SMs
    with slices of at least 64 columns, raised (to 16 at most) where that
    lets a pair's slices fit shared memory; where no cluster's do, the
    rows stay in global memory.  Long rows keep wide blocks: a cluster
    holds them."""
    G = tsvd.Geometry
    assert tsvd.geometry(512, 512) == G(512, 512, 8, 512, 4, True)
    assert tsvd.geometry(26, 512) == G(26, 512, 8, 32, 8, True)
    assert tsvd.geometry(512, 26) == G(26, 512, 8, 32, 8, True)
    assert tsvd.geometry(3, 3) == G(3, 3, 2, 4, 1, True)
    assert tsvd.geometry(1, 7) == G(1, 7, 1, 2, 1, True)
    assert tsvd.geometry(64, 4000) == G(64, 4000, 8, 64, 16, True)
    assert tsvd.geometry(64, 1000) == G(64, 1000, 8, 64, 16, True)
    # two rows of a block: 14,048 doubles of a slice beside the block's
    # Gram buffers within 220 KiB; a cluster of 16 holds 16 slices
    assert tsvd.shared_rows(14048, 1) and not tsvd.shared_rows(14049, 1)
    assert tsvd.shared_rows(16 * 14048, 1, 16)
    assert not tsvd.shared_rows(16 * 14048 + 64, 1, 16)
    assert tsvd.geometry(4, 20000) == G(4, 20000, 2, 4, 16, True)
    assert tsvd.geometry(30000, 8) == G(8, 30000, 4, 8, 16, True)
    assert tsvd.geometry(76800, 100) == G(100, 76800, 8, 112, 16, False)
    assert tsvd.geometry(2048, 2048) == G(2048, 2048, 8, 2048, 2, True)
    # a wave of blocks where the rows allow it (at 2048 x 2048 the slices
    # need C = 2: 256 blocks)
    for m, n in ((512, 512), (26, 512), (30000, 8), (2048, 2048)):
        g = tsvd.geometry(m, n)
        assert g.Pp // (2 * g.w) * g.C <= tsvd.SMS or g.C == 2 == m / 1024


@pytest.mark.parametrize("shape,dtype", [((4, 20000), torch.float64),
                                         ((30000, 8), torch.float32)],
                         ids=["wide-float64", "tall-float32"])
def test_jacobi_plain_long_rows(shape, dtype):
    """Rows too long for one block's shared memory (slices over a
    cluster of 16, the same schedule) against numpy."""
    a = torch.tensor(np.random.default_rng(6).standard_normal(shape),
                     dtype=dtype)
    _assert_svd(a, *tsvd.jacobi_svd_plain(a))
    assert not tsvd.shared_rows(tsvd.LAST["geometry"][1], 1)


def test_svd_routes_on_the_cpu():
    """On CPU tensors ``svd`` is ``torch.linalg.svd`` (bit for bit) and
    ``jacobi_svd`` the plain version, batched over leading axes, for real
    and complex matrices; anything but a matrix raises, and so does an
    integer type."""
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
    z = a + 1j * torch.tensor(rng.standard_normal((2, 3, 9, 7)))
    u, s, vt = tsvd.jacobi_svd(z)
    assert u.dtype == vt.dtype == torch.complex128
    assert s.dtype == torch.float64 and vt.shape == (2, 3, 7, 7)
    for i in range(2):
        for j in range(3):
            _assert_svd(z[i, j], u[i, j], s[i, j], vt[i, j])
    with pytest.raises(NotImplementedError, match="complex128 matrices"):
        tsvd.jacobi_svd(torch.zeros(3, 3, dtype=torch.int32))
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


# the prox shapes and long rows, for the clusters' slices and their sums;
# the complex form's too (16 x 12000 rows too long for any cluster's
# shared memory at 16-byte entries)
CLUSTER_SHAPES = [((60, 60), torch.float64), ((26, 512), torch.float32),
                  ((512, 26), torch.float64), ((4, 20000), torch.float64),
                  ((30000, 8), torch.float32), ((26, 512), torch.complex64),
                  ((48, 40), torch.complex128),
                  ((16, 12000), torch.complex128)]


@pytest.mark.parametrize("cluster", [1, 2, 3, 4, 8])
@pytest.mark.parametrize("shape,dtype", CLUSTER_SHAPES,
                         ids=lambda v: "x".join(map(str, v))
                         if isinstance(v, tuple) else str(v).split(".")[-1])
def test_jacobi_plain_cluster_sizes(clusters, shape, dtype, cluster):
    """The plain schedule with the rows cut in ``cluster`` slices (their
    partial Gram matrices added in rank order, the last slice short where
    C does not divide the row) against numpy, at cluster sizes the
    geometry may choose, real and complex (the complex form takes any
    size, 3 among them)."""
    clusters(cluster)
    rng = np.random.default_rng(7)
    if dtype.is_complex:
        a = _complex(rng, shape, dtype)
    else:
        a = torch.tensor(rng.standard_normal(shape), dtype=dtype)
    _assert_svd(a, *tsvd.jacobi_svd_plain(a))
    assert tsvd.LAST["geometry"].C == cluster
    assert tsvd.LAST["sweeps"] < tsvd.SWEEP_CAP


@pytest.mark.parametrize("graded", ["rows", "columns", "both"])
def test_jacobi_plain_graded(graded):
    """Float64 matrices whose row (or column) norms span 1e-6 to 1, the
    case where rotations taken from a Gram matrix lose relative accuracy
    first: the decomposition holds at the same tolerance, in as many
    sweeps as the cap allows."""
    rng = np.random.default_rng(8)
    a = rng.standard_normal((48, 40))
    if graded in ("rows", "both"):
        a *= np.logspace(-6, 0, 48)[:, None]
    if graded in ("columns", "both"):
        a *= np.logspace(0, -6, 40)[None, :]
    a = torch.tensor(a)
    u, s, vt = tsvd.jacobi_svd_plain(a)
    _assert_svd(a, u, s, vt)
    assert tsvd.LAST["sweeps"] < tsvd.SWEEP_CAP


@pytest.mark.parametrize("cluster", [1, 4])
def test_jacobi_plain_rank_deficient_clusters(clusters, cluster):
    """Rank 5 of a 64 x 48 float64 matrix through the Gram path with the
    rows in ``cluster`` slices: the product holds and the 43 trailing
    singular values vanish to the tolerance."""
    clusters(cluster)
    rng = np.random.default_rng(9)
    a = torch.tensor(rng.standard_normal((64, 5))
                     @ rng.standard_normal((5, 48)))
    u, s, vt = tsvd.jacobi_svd_plain(a)
    _assert_svd(a, u, s, vt)
    assert float(s[5:].abs().max()) <= _tol(a) * float(s[0])


@pytest.mark.parametrize("scale", [1e-100, 1e100])
def test_jacobi_plain_scaled_gram(scale):
    """Entries of 1e-100 and 1e100, whose Gram matrices lie beyond
    2^-500 and 2^500: the rotations scale them by a power of two first,
    so that no square underflows or overflows."""
    a = torch.tensor(np.random.default_rng(10).standard_normal((20, 30))
                     * scale)
    _assert_svd(a, *tsvd.jacobi_svd_plain(a))


@pytest.mark.parametrize("w", [1, 2, 4, 8])
def test_sweep_visits_every_pair(w):
    """A sweep's first round pairs the 2w rows of each pair of blocks in
    a round-robin (2w - 1 inner rounds of w disjoint pairs), its other
    rounds each row of one block with each of the other (w inner rounds):
    over the outer round-robin every pair of rows meets, and in the
    rounds after the first each cross pair once."""
    n2 = 2 * w
    for cross in (False, True):
        rounds = tsvd._inner_pairs(n2, cross)
        assert len(rounds) == (w if cross else n2 - 1)
        seen = set()
        for ij in rounds:
            flat = [x for p in ij for x in p]
            assert len(ij) == w and sorted(flat) == list(range(n2))
            seen |= {tuple(sorted(p)) for p in ij}
        want = ({(i, j) for i in range(w) for j in range(w, n2)} if cross
                else {(i, j) for i in range(n2) for j in range(i + 1, n2)})
        assert seen == want
    Pp = 8 * w
    nb = Pp // w
    met = set()
    for rnd in range(nb - 1):
        for k in range(nb // 2):
            ba, bb = tsvd._rr_pair(nb, rnd, k)
            rows = [ba * w + l for l in range(w)] + \
                [bb * w + l for l in range(w)]
            for i, j in (p for ij in tsvd._inner_pairs(n2, rnd > 0)
                         for p in ij):
                met.add(tuple(sorted((rows[i], rows[j]))))
    assert met == {(i, j) for i in range(Pp) for j in range(i + 1, Pp)}


# ---------------------------------------------------------------------------
# The complex form: Hermitian Gram matrices, the real rotation of
# (g_ii, g_jj, |g_ij|) with the phase of g_ij (csrc/jacobi_svd.cu
# jac_round_z)

@settings(max_examples=30, deadline=None, derandomize=True)
@given(m=st.integers(1, 30), n=st.integers(1, 30),
       c128=st.booleans(), seed=st.integers(0, 2 ** 31 - 1),
       scale=st.sampled_from([1e-20, 1.0, 1e20]))
def test_jacobi_plain_complex_matches_numpy(m, n, c128, seed, scale):
    """Random complex shapes and scales against numpy: the singular
    values, ``u diag(s) vt`` rebuilds ``a``, ``u^H u = I`` and ``vt vt^H
    = I`` within 8 L eps."""
    dt = torch.complex128 if c128 else torch.complex64
    a = _complex(np.random.default_rng(seed), (m, n), dt) * scale
    _assert_svd(a, *tsvd.jacobi_svd_plain(a))
    assert tsvd.LAST["sweeps"] < tsvd.SWEEP_CAP
    assert tsvd.LAST["geometry"].C == 1


@pytest.mark.parametrize("dtype", CDTYPES)
@pytest.mark.parametrize("shape", [(48, 40), (26, 512), (512, 26), (3, 7)],
                         ids=["tall", "wide", "long", "small"])
def test_jacobi_plain_complex_against_linalg(dtype, shape):
    """Robust PCA's complex shapes (a 48 x 40 matrix, the randomized
    prox's 26 x 512 and its transpose): the singular values against
    ``torch.linalg.svd``'s, and the decomposition's own checks."""
    a = _complex(np.random.default_rng(11), shape, dtype)
    u, s, vt = tsvd.jacobi_svd_plain(a)
    _assert_svd(a, u, s, vt)
    ref = torch.linalg.svdvals(a.to(torch.complex128))
    assert float((s.double() - ref).abs().max()) <= _tol(a) * float(ref[0])


@pytest.mark.parametrize("dtype", CDTYPES)
def test_jacobi_plain_complex_rank_deficient(dtype):
    """Rank 3 of a complex 30 x 20 matrix with a zero column: the product
    holds and the trailing singular values vanish to the tolerance."""
    rng = np.random.default_rng(12)
    a = _complex(rng, (30, 3), torch.complex128) @ \
        _complex(rng, (3, 20), torch.complex128)
    a[:, 5] = 0.0
    a = a.to(dtype)
    u, s, vt = tsvd.jacobi_svd_plain(a)
    _assert_svd(a, u, s, vt)
    assert float(s[3:].abs().max()) <= _tol(a) * float(s[0])


def test_jacobi_plain_complex64_works_in_complex128():
    """A complex64 matrix is decomposed in complex128 and the results
    rounded: every output is the complex128 decomposition of the same
    matrix rounded (the singular values to float32)."""
    a = _complex(np.random.default_rng(13), (64, 48), torch.complex64)
    out = tsvd.jacobi_svd_plain(a)
    wide = tsvd.jacobi_svd_plain(a.to(torch.complex128))
    for x, y in zip(out, wide):
        want = torch.float32 if not y.is_complex() else torch.complex64
        assert x.dtype == want and torch.equal(x, y.to(want))


@pytest.mark.parametrize("dtype", CDTYPES)
def test_jacobi_plain_complex_failure_gives_nan(dtype):
    """A NaN or an infinite entry (in either part), or sweeps stopped at
    the cap unconverged, give NaN in every output."""
    a = _complex(np.random.default_rng(14), (12, 9), dtype)
    b = a.clone()
    b[2, 3] = complex(0.0, math.inf)
    c = a.clone()
    c[0, 0] = complex(math.nan, 0.0)
    for bad in (b, c):
        for t in tsvd.jacobi_svd_plain(bad):
            assert bool(torch.isnan(t).all())
    for t in tsvd.jacobi_svd_plain(a, sweep_cap=1):
        assert bool(torch.isnan(t).all())


def test_geometry_complex():
    """The complex form takes clusters of C blocks a pair, C of any size
    up to 16, as many as 96 SMs hold (``svd.CLUSTER_SMS``) with slices of
    at least 64 columns, raised one at a time where that lets the slices
    fit shared memory beside its Gram buffers (twice the real form's,
    for 16-byte entries): at w = 8 a block's slice holds up to 696
    entries of a row, so rows of up to 16 x 696 = 11136 entries take the
    shared route, longer ones the global route."""
    G = tsvd.Geometry
    assert tsvd.geometry(512, 512, 16) == G(512, 512, 8, 512, 3, True)
    assert tsvd.geometry(26, 512, 16) == G(26, 512, 8, 32, 8, True)
    assert tsvd.geometry(512, 26, 16) == G(26, 512, 8, 32, 8, True)
    assert tsvd.geometry(256, 192, 16) == G(192, 256, 8, 192, 4, True)
    assert tsvd.geometry(100, 2000, 16) == G(100, 2000, 8, 112, 13, True)
    # 128 pairs: C 1, raised to 3, the first whose slices fit
    assert tsvd.geometry(2048, 2048, 16) == G(2048, 2048, 8, 2048, 3, True)
    assert tsvd.geometry(48, 33, 16) == G(33, 48, 8, 48, 1, True)
    assert tsvd.geometry(16, 11136, 16) == G(16, 11136, 8, 16, 16, True)
    assert tsvd.geometry(16, 11137, 16) == G(16, 11137, 8, 16, 16, False)
    assert tsvd.shared_rows(696, 8, 1, 16)
    assert not tsvd.shared_rows(697, 8, 1, 16)
    assert tsvd.shared_rows(11136, 8, 16, 16)
    assert not tsvd.shared_rows(11137, 8, 16, 16)
    # the real form's geometry at the same shapes is unchanged
    assert tsvd.geometry(512, 512) == G(512, 512, 8, 512, 4, True)
    assert tsvd.geometry(512, 512, 8) == tsvd.geometry(512, 512)


def test_complex_sweep_zeroes_each_pair():
    """One inner round of the complex form on a Hermitian G, summed whole
    (C = 1) and from C = 2 and 3 slices of the columns in rank order (the
    last one short, as a cluster's): G is Hermitian with a real diagonal
    and within rounding of the whole sum; every pair rotated is left with
    g_ij = 0, R unitary, and R X gives the Gram matrix J G J^H of the
    rows."""
    rng = np.random.default_rng(15)
    X = _complex(rng, (3, 8, 20), torch.complex128)
    G1 = tsvd._gram(X, 1)
    eye = torch.eye(8, dtype=torch.complex128)
    for C in (1, 2, 3):
        G = tsvd._gram(X, C)
        assert torch.equal(G, G.mH)
        assert float(G.diagonal(dim1=-2, dim2=-1).imag.abs().max()) == 0.0
        assert float((G - G1).abs().max()) < 1e-14 * float(G1.abs().max())
        R, moved = tsvd._inner_rounds(G, tsvd._tol(20), cross=True)
        assert bool(moved.all())
        Y = R @ X
        assert float((R @ R.mH - eye).abs().max()) < 1e-14
        Gy = Y @ Y.mH
        # the last inner round's pairs are orthogonal to rounding
        for i, j in tsvd._inner_pairs(8, True)[-1]:
            assert float(Gy[:, i, j].abs().max()) < 1e-12 * float(
                Gy.diagonal(dim1=-2, dim2=-1).real.max())
