"""Building blocks of the port's fused ConvBPDN driver, FFT glue,
layouts and AutoRho against their JAX counterparts, on the same numpy
inputs."""

import dataclasses
import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sporco_tpu import cnvrep as jcr
from sporco_tpu.models.common import default_rho_xi as j_default_rho_xi
from sporco_tpu.ops import fft as jfft
from sporco_tpu.ops import fused_csc as jfc
from sporco_tpu.solvers import admm as jadmm
from sporco_tpu_torch import cnvrep as tcr
from sporco_tpu_torch.models.common import default_rho_xi
from sporco_tpu_torch.ops import fft as tfft
from sporco_tpu_torch.ops import fused_csc as tfc
from sporco_tpu_torch.solvers import admm as tadmm
from sporco_tpu_torch.utils.timer import Timer

torch.set_num_threads(2)

f32 = np.float32


def _rng(seed=0):
    return np.random.default_rng(seed)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


# ---------------------------------------------------------------------------
# polyphase layout and weights: pure data movement, so exact

@pytest.mark.parametrize("shape", [(32, 40), (2, 16, 24), (2, 3, 8, 8)])
def test_poly_pack_unpack(shape):
    A = _rng(1).standard_normal(shape).astype(f32)
    P = tfc.poly_pack(torch.tensor(A))
    np.testing.assert_array_equal(_np(P), np.asarray(jfc.poly_pack(A)))
    np.testing.assert_array_equal(_np(tfc.poly_unpack(P)), A)


def test_pack_unpack_state():
    A = _rng(2).standard_normal((2, 1, 3, 16, 24)).astype(f32)
    P = tfc.pack_state(torch.tensor(A))
    np.testing.assert_array_equal(_np(P), np.asarray(jfc.pack_state(A)))
    np.testing.assert_array_equal(_np(tfc.unpack_state(P, 3)), A)


@pytest.mark.parametrize("dsz", [(8, 8), (5, 7), (11, 11)])
def test_xstep_kernels(dsz):
    D = _rng(3).standard_normal((3,) + dsz).astype(f32)
    Wf, Wa, js = tfc.xstep_kernels(torch.tensor(D), *dsz)
    jWf, jWa, jjs = jfc.xstep_kernels(jnp.asarray(D), *dsz)
    assert js == tuple(jjs)
    np.testing.assert_array_equal(_np(Wf), np.asarray(jWf))
    np.testing.assert_array_equal(_np(Wa), np.asarray(jWa))


@pytest.mark.parametrize("J", [(1, 1), (2, 1)])
def test_fwd_combine_and_adj_rolls(J):
    J0, J1 = J
    T = (J0 + 1) * (J1 + 1)
    rng = _rng(4)
    o = rng.standard_normal((2, 4, 5, T * 64)).astype(f32)
    np.testing.assert_allclose(
        _np(tfc._fwd_combine(torch.tensor(o), J0, J1, 8)),
        np.asarray(jfc._fwd_combine(jnp.asarray(o), J0, J1, 8)),
        rtol=1e-6, atol=1e-6)
    g = rng.standard_normal((2, 4, 5, 64)).astype(f32)
    np.testing.assert_array_equal(
        _np(tfc._adj_rolls(torch.tensor(g), J0, J1)),
        np.asarray(jfc._adj_rolls(jnp.asarray(g), J0, J1)))


def _xstep_inputs(N=32, M=4, nd=8, K=2, seed=5):
    rng = _rng(seed)
    D = rng.standard_normal((M, nd, nd)).astype(f32)
    D /= np.sqrt((D ** 2).sum(axis=(1, 2), keepdims=True))
    S = rng.standard_normal((K, N, N)).astype(f32)
    Pyu = rng.standard_normal((K, N // 8, N // 8, 64 * M)).astype(f32)
    return D, S, Pyu


@pytest.mark.parametrize("beta,scale", [(3.5, 1.0), (0.7, 0.8)])
def test_spatial_xstep(beta, scale):
    D, S, Pyu = _xstep_inputs()
    N = S.shape[-1]
    Nv = (N, N)
    # JAX side
    jD = jnp.asarray(D)
    Df = jfft.rfftn(jD, s=Nv, axes=(-2, -1))
    DHD = jnp.sum((Df * jnp.conj(Df)).real, axis=0)
    Sf = jfft.rfftn(jnp.asarray(S), axes=(-2, -1))
    jWf, jWa, js = jfc.xstep_kernels(jD, 8, 8)
    ref = jfc.spatial_xstep(jnp.asarray(Pyu), jWf, jWa, js, DHD,
                            jnp.real(Sf), jnp.imag(Sf), f32(beta),
                            f32(scale), Nv)
    # port
    tD = torch.tensor(D)
    tDf = tfft.rfftn(tD, s=Nv, axes=(-2, -1))
    tDHD = torch.sum((tDf * tDf.conj()).real, dim=0)
    tSf = tfft.rfftn(torch.tensor(S), axes=(-2, -1))
    Wf, Wa, tjs = tfc.xstep_kernels(tD, 8, 8)
    got = tfc.spatial_xstep(torch.tensor(Pyu), Wf, Wa, tjs, tDHD,
                            tSf.real, tSf.imag, f32(beta), f32(scale), Nv)
    np.testing.assert_allclose(_np(tDHD), np.asarray(DHD), rtol=1e-6,
                               atol=1e-6 * float(np.abs(DHD).max()))
    for g, r in zip(got, ref):
        assert _rel(g, r) <= 1e-6


def test_rfl2norm2_planar():
    rng = _rng(6)
    er = rng.standard_normal((2, 16, 9)).astype(f32)
    ei = rng.standard_normal((2, 16, 9)).astype(f32)
    for n1 in (16, 17):
        got = float(tfc._rfl2norm2_planar(torch.tensor(er),
                                          torch.tensor(ei), n1))
        ref = float(jfc._rfl2norm2_planar(jnp.asarray(er),
                                          jnp.asarray(ei), n1))
        assert got == pytest.approx(ref, rel=1e-6)


# ---------------------------------------------------------------------------
# FFT glue

@pytest.mark.parametrize("shape,axes", [((3, 16, 24), (-2, -1)),
                                        ((4, 15), None),
                                        ((2, 8, 6, 10), (1, 3))])
def test_fft_transforms(shape, axes):
    a = _rng(7).standard_normal(shape).astype(f32)
    t = torch.tensor(a)
    rf = tfft.rfftn(t, axes=axes)
    assert _rel(rf, jfft.rfftn(jnp.asarray(a), axes=axes)) <= 1e-6
    s = tuple(shape[ax] for ax in (axes or range(len(shape))))
    back = tfft.irfftn(rf, s=s, axes=axes)
    assert _rel(back, jfft.irfftn(jnp.asarray(_np(rf)), s=s,
                                  axes=axes)) <= 1e-6
    assert _rel(back, a) <= 1e-6
    cf = tfft.fftn(t, axes=axes)
    assert _rel(cf, jfft.fftn(jnp.asarray(a), axes=axes)) <= 1e-6
    assert _rel(tfft.ifftn(cf, axes=axes),
                jfft.ifftn(jnp.asarray(_np(cf)), axes=axes)) <= 1e-6


@pytest.mark.parametrize("n1", [16, 15])
def test_parseval_norms(n1):
    a = _rng(8).standard_normal((3, 12, n1)).astype(f32)
    xf = tfft.rfftn(torch.tensor(a), axes=(-2, -1))
    got = float(tfft.rfl2norm2(xf, (12, n1), axis=(-2, -1)))
    ref = float(jfft.rfl2norm2(jnp.asarray(_np(xf)), (12, n1),
                               axis=(-2, -1)))
    assert got == pytest.approx(ref, rel=1e-6)
    assert got == pytest.approx(float((a.astype(np.float64) ** 2).sum()),
                                rel=1e-5)
    cf = tfft.fftn(torch.tensor(a), axes=(-2, -1))
    assert float(tfft.fl2norm2(cf, axis=(-2, -1))) == pytest.approx(
        float(jfft.fl2norm2(jnp.asarray(_np(cf)), axis=(-2, -1))),
        rel=1e-6)


# ---------------------------------------------------------------------------
# layouts

CASES = [((8, 8, 4), (32, 32), None), ((8, 8, 4), (32, 32, 3), None),
         ((8, 8, 4), (32, 32, 3), 0), ((8, 8, 3, 4), (32, 32, 3), None),
         ((6, 6, 5), (16, 20, 3, 2), None), ((8, 8, 4), (32, 32, 5), 1)]


@pytest.mark.parametrize("Dshape,Sshape,dimK", CASES)
def test_csc_index_and_layouts(Dshape, Sshape, dimK):
    cri = tcr.csc_index(Dshape, Sshape, dimK=dimK)
    jcri = jcr.csc_index(Dshape, Sshape, dimK=dimK)
    assert dataclasses.asdict(cri) == dataclasses.asdict(jcri)
    assert (cri.shpS, cri.shpD, cri.shpX, cri.N, cri.axisN) == \
        (jcri.shpS, jcri.shpD, jcri.shpX, jcri.N, jcri.axisN)
    rng = _rng(9)
    D = rng.standard_normal(Dshape).astype(f32)
    S = rng.standard_normal(Sshape).astype(f32)
    X = rng.standard_normal(tuple(cri.Nv) + (cri.Cx, cri.K, cri.M)
                            ).astype(f32)
    Di = tcr.to_internal_D(torch.tensor(D), cri)
    np.testing.assert_array_equal(_np(Di),
                                  np.asarray(jcr.to_internal_D(D, jcri)))
    np.testing.assert_array_equal(
        _np(tcr.to_internal_S(torch.tensor(S), cri)),
        np.asarray(jcr.to_internal_S(S, jcri)))
    Xi = tcr.to_internal_X(torch.tensor(X), cri)
    np.testing.assert_array_equal(_np(Xi),
                                  np.asarray(jcr.to_internal_X(X, jcri)))
    np.testing.assert_array_equal(_np(tcr.from_internal_X(Xi, cri)), X)
    np.testing.assert_array_equal(_np(tcr.from_internal_D(Di, cri)), D)


@pytest.mark.parametrize("kind", ["scalar", "S", "S+M", "full"])
def test_l1_weight(kind):
    cri = tcr.csc_index((8, 8, 4), (16, 16, 2))
    jcri = jcr.csc_index((8, 8, 4), (16, 16, 2))
    rng = _rng(10)
    shape = {"scalar": (), "S": (16, 16, 2), "S+M": (16, 16, 2, 4),
             "full": (16, 16, 1, 2, 4)}[kind]
    W = rng.random(shape).astype(f32)
    np.testing.assert_array_equal(
        _np(tcr.l1_weight(torch.tensor(W), cri)),
        np.asarray(jcr.l1_weight(W, jcri)))


@pytest.mark.parametrize("dsz", [(8, 8, 16), (8, 8, 3, 16),
                                 ((8, 8, 4), (12, 12, 8)),
                                 (((5, 5, 1, 2), (5, 5, 2, 2)),
                                  ((9, 9, 1, 3), (9, 9, 2, 3)))])
def test_dictionary_size(dsz):
    a, b = tcr.DictionarySize(dsz), jcr.DictionarySize(dsz)
    assert (a.ndim, a.nchn, a.nflt, a.mxsz) == \
        (b.ndim, b.nchn, b.nflt, b.mxsz)


# ---------------------------------------------------------------------------
# AutoRho and the small host pieces

AR = [tadmm.AutoRhoOpts(enabled=True, period=1, auto_scaling=True,
                        scaling=1000.0, rsdl_ratio=1.2),
      tadmm.AutoRhoOpts(enabled=True, period=3, auto_scaling=False,
                        scaling=2.0, rsdl_ratio=10.0),
      tadmm.AutoRhoOpts(enabled=False)]


@pytest.mark.parametrize("ar", AR)
def test_update_rho_matches_jax(ar):
    jar = jadmm.AutoRhoOpts(**dataclasses.asdict(ar))
    rng = _rng(11)
    for i in range(60):
        k = int(rng.integers(0, 8))
        r, s = (f32(x) for x in 10.0 ** rng.uniform(-4, 1, 2))
        if i % 10 == 0:
            s = f32(0.0)
        rho, xi = f32(rng.uniform(0.1, 10)), f32(rng.uniform(1, 3))
        got = tadmm._update_rho(ar, np.int32(k), r, s, rho, xi, f32(1.0))
        ref = jadmm._update_rho(jar, jnp.int32(k), jnp.float32(r),
                                jnp.float32(s), jnp.float32(rho),
                                jnp.float32(xi), jnp.float32(1.0))
        assert got[0] == np.float32(ref[0])
        assert got[1] == np.float32(ref[1])


@pytest.mark.parametrize("lmbda", [None, 0.0, 0.01, 0.05, 0.3])
def test_default_rho_xi(lmbda):
    assert default_rho_xi(lmbda) == j_default_rho_xi(lmbda)


def test_norm_residuals():
    opts = tadmm.ADMMOpts(abs_stop_tol=1e-4, rel_stop_tol=1e-3)
    nc = math.sqrt(1000.0)
    args = [f32(x) for x in (0.5, 0.25, 10.0, 4.0)]
    r, s, ep, ed = tadmm.norm_residuals(tadmm.AutoRhoOpts(), opts, nc, nc,
                                        *args)
    assert (r, s) == (f32(0.05), f32(0.0625))
    assert ep == f32(f32(nc * 1e-4) / f32(10.0) + f32(1e-3))
    r, s, ep, ed = tadmm.norm_residuals(
        tadmm.AutoRhoOpts(std_residuals=True), opts, nc, nc, *args)
    assert (r, s) == (args[0], args[1])
    assert ed == f32(f32(nc * 1e-4) + f32(4.0) * f32(1e-3))


def test_timer():
    t = Timer(["init", "solve"])
    t.start("solve")
    t.stop("solve")
    assert t.elapsed("solve") >= 0.0 and t.elapsed("init") == 0.0
    assert t.labels() == ["init", "solve"]
    t.reset()
    assert t.elapsed("solve") == 0.0
    with pytest.raises(KeyError):
        t.stop("nope")
