"""The building blocks of the port's dictionary learning against the JAX
package on the same numpy inputs: the dictionary-update index
``cdu_index``, the constraint set (``zeromean``, ``normalise``,
``zpad``, ``bcrop``, ``Pcn``, ``getPcn``) for single-size, multi-scale
and colour ``dsz`` specs, the conjugate-gradient solvers, the residual
hooks of the generic ADMM driver and the ``emit_fwd=False`` form of
``csc_iter``'s plain version.

The constraint set moves and scales values only: float64 results agree
to a few ulps (rtol 1e-13).  CG runs float64 (its stopping test counts
iterations, which float32 rounding can move by one): the same iteration
count and the solution within 1e-10.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sporco_tpu import cnvrep as jcr
from sporco_tpu.ops import linalg as jla
from sporco_tpu_torch import cnvrep as tcr
from sporco_tpu_torch.ops import csc_iter as tci
from sporco_tpu_torch.ops import linalg as tla
from sporco_tpu_torch.solvers import admm as tadmm

torch.set_num_threads(2)

RTOL = 1e-13
NV = (12, 10)

# dsz specs and the internal shape (1, Cd, M, max support) they describe
DSZ = {
    "single": ((5, 4, 6), (1, 1, 6, 5, 4)),
    "multiscale": (((3, 3, 2), (5, 4, 3)), (1, 1, 5, 5, 4)),
    "colour": ((4, 4, 3, 5), (1, 3, 5, 4, 4)),
    "colour_multiscale": ((((3, 3, 1, 2), (4, 4, 2, 2)),
                           ((5, 5, 1, 3), (2, 2, 2, 3))), (1, 3, 5, 5, 5)),
}


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, rtol=RTOL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=rtol,
                               atol=rtol * max(np.abs(b).max(), 1e-300))


@pytest.mark.parametrize("Sshape,dimK", [((16, 16), None),
                                         ((16, 16, 7), None),
                                         ((16, 16, 3), 0),
                                         ((16, 16, 3, 7), None)])
@pytest.mark.parametrize("kind", sorted(DSZ))
def test_cdu_index_matches_jax(kind, Sshape, dimK):
    dsz = DSZ[kind][0]
    if "colour" in kind and (len(Sshape) < 3 or Sshape[2] != 3):
        with pytest.raises(ValueError):
            tcr.cdu_index(dsz, Sshape, dimK=dimK)
        with pytest.raises(ValueError):
            jcr.cdu_index(dsz, Sshape, dimK=dimK)
        return
    a = tcr.cdu_index(dsz, Sshape, dimK=dimK)
    b = jcr.cdu_index(dsz, Sshape, dimK=dimK)
    for f in ("dimN", "dimC", "dimK", "dimCd", "C", "Cd", "Cx", "K", "M",
              "Nv", "dsz", "shpS", "shpD", "shpX", "axisN", "N"):
        assert getattr(a, f) == getattr(b, f), f
    assert a.csc_like().Nv == a.Nv


@pytest.mark.parametrize("zm", [False, True])
@pytest.mark.parametrize("crp", [False, True])
@pytest.mark.parametrize("kind", sorted(DSZ))
def test_pcn_matches_jax(kind, crp, zm):
    dsz, shape = DSZ[kind]
    v = np.random.default_rng(1).standard_normal(shape[:3] + NV)
    a = tcr.Pcn(torch.tensor(v), dsz, NV, crp=crp, zm=zm)
    b = jcr.Pcn(jnp.asarray(v), dsz, NV, crp=crp, zm=zm)
    _close(a, b)
    g = tcr.getPcn(dsz, NV, crp=crp, zm=zm)(torch.tensor(v))
    assert torch.equal(g, a)
    # unit norm over support and channels; crop keeps the largest support
    assert a.shape[-2:] == (shape[-2:] if crp else NV)
    nrm = np.sqrt((_np(a) ** 2).sum(axis=(1, 3, 4)))
    np.testing.assert_allclose(nrm, 1.0, rtol=1e-12)


def test_pcn_colour_normalises_jointly_over_channels():
    """A colour filter is scaled once over its three channels, not per
    channel: a channel-wise normalisation would give unit-norm channels."""
    dsz, shape = DSZ["colour"]
    v = np.random.default_rng(2).standard_normal(shape[:3] + NV)
    v[:, 0] *= 10.0
    a = _np(tcr.Pcn(torch.tensor(v), dsz, NV))
    per_chan = np.sqrt((a ** 2).sum(axis=(3, 4)))
    assert np.abs(per_chan - 1.0).max() > 0.1
    _close(a, jcr.Pcn(jnp.asarray(v), dsz, NV))


@pytest.mark.parametrize("kind", sorted(DSZ))
def test_zeromean_bcrop_zpad_match_jax(kind):
    dsz, shape = DSZ[kind]
    v = np.random.default_rng(3).standard_normal(shape[:3] + NV)
    tv, jv = torch.tensor(v), jnp.asarray(v)
    _close(tcr.zeromean(tv, dsz), jcr.zeromean(jv, dsz))
    c = tcr.bcrop(tv, dsz)
    _close(c, jcr.bcrop(jv, dsz))
    _close(tcr.zpad(c, NV), jcr.zpad(jcr.bcrop(jv, dsz), NV))
    # outside each block's support the crop is zero
    assert _np(tcr.zpad(c, NV))[..., shape[-2]:, :].max() == 0.0


def test_normalise_keeps_zero_filters_zero():
    v = np.random.default_rng(4).standard_normal((1, 1, 4, 5, 5))
    v[0, 0, 2] = 0.0
    for out in (tcr.normalise(torch.tensor(v)),
                jcr.normalise(jnp.asarray(v))):
        o = _np(out)
        assert np.all(np.isfinite(o)) and np.all(o[0, 0, 2] == 0.0)
    _close(tcr.normalise(torch.tensor(v)), jcr.normalise(jnp.asarray(v)))
    vc = v + 1j * np.random.default_rng(5).standard_normal(v.shape)
    _close(tcr.normalise(torch.tensor(vc)), jcr.normalise(jnp.asarray(vc)))


def _cplx(rng, shape):
    return rng.standard_normal(shape) + 1j * rng.standard_normal(shape)


@pytest.mark.parametrize("tol", [1e-3, 1e-6, 1e-10])
@pytest.mark.parametrize("axisK,shape_b", [(0, (1, 3, 4, 6, 4)),
                                           (1, (2, 1, 4, 6, 4))])
def test_solvemdbi_cg_matches_jax(axisK, shape_b, tol):
    rng = np.random.default_rng(6)
    shape_a = (3, 1, 4, 6, 4) if axisK == 0 else (1, 3, 4, 6, 4)
    ah, b = _cplx(rng, shape_a), _cplx(rng, shape_b)
    xa, ka = tla.solvemdbi_cg(torch.tensor(ah), 1.5, torch.tensor(b), 2,
                              axisK, tol=tol)
    xb, kb = jla.solvemdbi_cg(jnp.asarray(ah), 1.5, jnp.asarray(b), 2,
                              axisK, tol=tol)
    assert ka == int(kb) and ka > 0
    np.testing.assert_allclose(_np(xa), np.asarray(xb), rtol=0, atol=1e-10)


def test_cg_matches_jax_with_preconditioner_and_cap():
    rng = np.random.default_rng(7)
    A = rng.standard_normal((20, 20))
    A = A @ A.T + 0.5 * np.eye(20)
    d = 1.0 / np.diag(A)
    b = rng.standard_normal(20)
    tA, jA = torch.tensor(A), jnp.asarray(A)
    for kw in ({"tol": 1e-8}, {"tol": 1e-12, "max_iter": 5}):
        xa, ka = tla.cg(lambda u: tA @ u, torch.tensor(b),
                        m_inv=lambda r: torch.tensor(d) * r, **kw)
        xb, kb = jla.cg(lambda u: jA @ u, jnp.asarray(b),
                        m_inv=lambda r: jnp.asarray(d) * r, **kw)
        assert ka == int(kb)
        np.testing.assert_allclose(_np(xa), np.asarray(xb), atol=1e-10)
    # the cap stops it short of the solution
    assert ka == 5


def _hook_problem(**hooks):
    """A consensus-shaped toy: X (3, 4) blocks, Y their projected mean."""
    def setup(cfg, params):
        return {}

    def xstep(cfg, aux, params, st):
        rho = float(st.rho)
        return (params["B"] + rho * (st.Y - st.U)) / (1.0 + rho), {}

    def ystep(cfg, aux, params, st, AXU):
        m = torch.mean(AXU, dim=0, keepdim=True)
        return m / torch.clamp(torch.linalg.vector_norm(m), min=1.0)

    def yinit(cfg, params):
        return torch.zeros((1, 4), dtype=params["B"].dtype)

    def uinit(cfg, params):
        return torch.zeros_like(params["B"])
    return tadmm.ADMMProblem(setup=setup, xstep=xstep, ystep=ystep,
                             yinit=yinit, uinit=uinit, xinit=uinit,
                             cnst_b=lambda c, a, p, Y: -Y,
                             stat_names=(), **hooks)


def test_residual_hooks_replace_the_generic_residuals():
    """With hooks equal to the generic definitions the rows are the
    generic ones; with the consensus scaling every residual column moves
    by its factor and the run stays a different, consistent one."""
    rng = np.random.default_rng(8)
    params = {"B": torch.tensor(rng.standard_normal((3, 4)))}
    opts = tadmm.ADMMOpts(max_iter=6, rel_stop_tol=0.0, relax_param=1.8,
                          dtype=torch.float64)

    def run(prob):
        st = tadmm.init_state(prob, None, params, opts, 2.0)
        st = tadmm.admm_solve(prob, None, params, opts, st)
        return tadmm.iterstats(tadmm.stat_names(()), st)

    def norm(x):
        return torch.linalg.vector_norm(x.reshape(-1))
    generic = run(_hook_problem())
    same = run(_hook_problem(
        rsdl_r=lambda c, a, p, st, AX: AX - st.Y,
        rsdl_s=lambda c, a, p, st, Yp: float(st.rho) * (st.Y - Yp),
        rsdl_rn=lambda c, a, p, st, AX: torch.maximum(norm(AX),
                                                      norm(st.Y)),
        rsdl_sn=lambda c, a, p, st: float(st.rho) * norm(st.U)))
    # the stats rows are float32: one rounding apart at most
    for name in ("PrimalRsdl", "DualRsdl", "EPrimal", "EDual", "Rho"):
        np.testing.assert_allclose(getattr(same, name),
                                   getattr(generic, name), rtol=2e-7)
    scaled = run(_hook_problem(
        rsdl_s=lambda c, a, p, st, Yp: 3.0 * float(st.rho) * (Yp - st.Y)))
    np.testing.assert_allclose(scaled.DualRsdl[0], 3 * generic.DualRsdl[0],
                               rtol=2e-7)


@pytest.mark.parametrize("emit_px", [False, True])
@pytest.mark.parametrize("per_channel", [False, True])
def test_csc_iter_plain_without_forward_pair(per_channel, emit_px):
    """``emit_fwd=False`` returns no R1/R2 and the same PX, Yn, Un and sums
    bit for bit as the full form."""
    rng = np.random.default_rng(9)
    pos, C, T = 40, 96, 64
    G2 = torch.tensor(0.1 * rng.standard_normal((pos, T)), dtype=torch.float32)
    Wa = torch.tensor(0.1 * rng.standard_normal((T, C)), dtype=torch.float32)
    Wf = torch.tensor(0.1 * rng.standard_normal((C, T)), dtype=torch.float32)
    Y0 = torch.tensor(rng.standard_normal((pos, C))
                      * (rng.random((pos, C)) < 0.3), dtype=torch.float32)
    U0 = torch.tensor(0.1 * rng.standard_normal((pos, C)),
                      dtype=torch.float32)
    thr = (torch.tensor(rng.uniform(0.01, 0.1, C), dtype=torch.float32)
           if per_channel else 0.05)

    def run(fwd, Wf_arg):
        return tci.csc_iter(G2, Y0.clone(), U0.clone(), Wa, Wf_arg, thr,
                            1.0, 1.8, 0.9, 1.0, emit_px=emit_px,
                            emit_fwd=fwd)
    full = run(True, Wf)
    part = run(False, None)
    assert part[3] is None and part[4] is None
    assert full[3] is not None and full[4] is not None
    for a, b in zip(full[:3] + full[5:], part[:3] + part[5:]):
        if a is None:
            assert b is None
        else:
            assert torch.equal(a, b)
    assert tci.LAUNCHES["csc_iter"] == 0


@pytest.mark.parametrize("pos,C,T,ok", [(10240, 2048, 256, True),
                                         (64, 512, 768, True),
                                         (4096, 4096, 256, True),
                                         (64, 512, 200, False),
                                         (60, 512, 256, False),
                                         (8, 100, 128, False)])
def test_iter_supported_is_the_jax_rule(pos, C, T, ok):
    from sporco_tpu.ops import pallas_csc_iter as pki
    assert tci.iter_supported(pos, C, T) == ok == pki.iter_supported(pos, C,
                                                                     T)
