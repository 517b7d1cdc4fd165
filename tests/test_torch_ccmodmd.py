"""The port's masked dictionary update (``ccmodmd``: ``ism``, ``cg`` and
``cns``) against the JAX package's on the same numpy problems, over 10
iterations: a single-channel dictionary and signal, a colour dictionary
(Cd = C = 3) and a single-channel dictionary on three-channel signals,
whose channels fold onto the signal axis with the mask
(``sporco_tpu/models/ccmodmd.py:249-257``), with a mask per channel and
signal, a spatial mask and none.

Tolerances: the stats rows rtol 1e-6 and the dictionary within 1e-8 of
its scale in float64; in float32 the rows rtol 1e-4 (the residuals
1e-3) and the dictionary 2e-4, or, for a row or the dictionary, as close
to the JAX package's float64 run as the JAX float32 run is (within 1.5
times its distance), as ``tests/test_torch_dictlrn.py`` holds the
float32 d-step:
AutoRho's scaling follows the residual ratio, so the consensus solve's
rho, and with it DFid, carry float32 rounding (about 1.4e-4 of DFid
after 10 iterations of the colour case, in either package against its
own float64 run).  ``Cnstr`` (the distance from the constraint set, zero
up to rounding) is held absolutely (1e-12; float32 1e-5).  CG solves to
1e-10 in float64, where one CG iteration more or less moves nothing the
tolerances can see (at the default 1e-3 the packages may stop one
iteration apart, as ``tests/test_torch_ccmod.py`` explains).
"""

import numpy as np
import pytest
import torch

from sporco_tpu.models import ccmodmd as jm
from sporco_tpu_torch.models import ccmodmd as tm

torch.set_num_threads(2)

N, ND, M, K = 16, 4, 3, 2
ITERS = 10
TOL = {np.float64: 1e-8, np.float32: 2e-4}
ROW_TOL = {np.float64: 1e-6, np.float32: 1e-4}
RSDL_TOL = {np.float64: 1e-6, np.float32: 1e-3}
CNSTR_ATOL = {np.float64: 1e-12, np.float32: 1e-5}
RSDL = ("PrimalRsdl", "DualRsdl", "EPrimal", "EDual")
CASES = {"mono": (1, 1), "colour": (3, 3), "fold": (3, 1)}


def _problem(C, Cd, mask, seed=0):
    rng = np.random.default_rng(seed)
    S = rng.standard_normal((N, N, C, K) if C > 1 else (N, N, K))
    Cx = C - Cd + 1
    Z = rng.standard_normal((N, N, Cx, K, M))
    Z *= rng.random(Z.shape) < 0.2
    dsz = (ND, ND, Cd, M) if Cd > 1 else (ND, ND, M)
    W = {"full": (rng.random(S.shape) > 0.25).astype(float),
         "spatial": (rng.random((N, N)) > 0.25).astype(float),
         "none": None}[mask]
    return Z, S, W, dsz, rng.standard_normal(dsz)


def _run(pkg, method, Z, S, W, dsz, D0, dt, **kw):
    mod = jm if pkg == "jax" else tm
    if pkg == "port":
        kw["device"] = "cpu"
    if method == "cg" and dt == np.float64:
        kw["cg_tol"] = 1e-10
    opt = mod.ConvCnstrMODMaskDcplOptions(method=method, max_iter=ITERS)
    d = mod.ConvCnstrMODMaskDcpl(Z, S, W, dsz, opt=opt, method=method,
                                 D0=D0, dtype=dt, **kw)
    d.solve()
    return d


def _row_ok(name, tv, jv, j64, dt):
    tol = RSDL_TOL[dt] if name in RSDL else ROW_TOL[dt]
    if np.allclose(tv, jv, rtol=tol, atol=0, equal_nan=True):
        return True
    if j64 is None:
        return False
    return np.nanmax(np.abs(tv - j64)) <= 1.5 * np.nanmax(np.abs(jv - j64))


def _compare(a, b, dt, a64=None):
    ia, ib = a.getitstat(), b.getitstat()
    i64 = None if a64 is None else a64.getitstat()
    assert ib._names == ia._names and len(ia) == len(ib) == ITERS
    for name in ia._names:
        tv, jv = getattr(ib, name), getattr(ia, name)
        if name == "Cnstr":
            np.testing.assert_allclose(tv, jv, rtol=0, atol=CNSTR_ATOL[dt])
        elif name != "XSlvRelRes":
            assert _row_ok(name, tv, jv, None if i64 is None
                           else getattr(i64, name), dt), name
    Da, Db = np.asarray(a.getdict()), b.getdict().numpy()
    assert Db.shape == Da.shape
    err = np.abs(Db - Da).max()
    if a64 is not None and err > TOL[dt] * np.abs(Da).max():
        D64 = np.asarray(a64.getdict())
        assert np.abs(Db - D64).max() <= 1.5 * np.abs(Da - D64).max()
    else:
        assert err <= TOL[dt] * np.abs(Da).max()
    nrm = np.sqrt((Db.astype(np.float64) ** 2).sum(
        axis=(0, 1) if Db.ndim == 3 else (0, 1, 2)))
    assert np.all(nrm <= 1.0 + 10 * TOL[dt])


@pytest.mark.parametrize("dt", [np.float64, np.float32])
@pytest.mark.parametrize("mask", ["full", "spatial", "none"])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("method", ["ism", "cg", "cns"])
def test_ccmodmd_matches_jax(method, case, mask, dt):
    Z, S, W, dsz, D0 = _problem(*CASES[case], mask)
    kw = {"dimK": 1}
    a = _run("jax", method, Z, S, W, dsz, D0, dt, **kw)
    b = _run("port", method, Z, S, W, dsz, D0, dt, **kw)
    a64 = None if dt == np.float64 else _run(
        "jax", method, Z, S, W, dsz, D0, np.float64, **kw)
    _compare(a, b, dt, a64)
    assert type(b.problem).__name__ == "ADMMProblem"
    assert b.opts.rho == a.opts.rho
    if dt == np.float64:
        assert float(b.state.rho) == pytest.approx(float(a.state.rho),
                                                   rel=1e-6)


@pytest.mark.parametrize("mask", ["full", "spatial"])
def test_mask_folds_with_the_channels(mask):
    """A single-channel dictionary on three-channel signals: S folds to
    (C K, 1, 1, N, N), a mask with a channel or signal axis folds alike
    (its entry for channel c of signal k at row k C + c), a spatial one
    stays (1, 1, 1, N, N), as in the JAX package."""
    Z, S, W, dsz, D0 = _problem(3, 1, mask)
    b = tm.ConvCnstrMODMaskDcpl(Z, S, W, dsz, method="cns", D0=D0,
                                dimK=1, device="cpu", dtype=np.float64)
    a = jm.ConvCnstrMODMaskDcpl(Z, S, W, dsz, method="cns", D0=D0,
                                dimK=1, dtype=np.float64)
    Wb, Wa = b.params["W"].numpy(), np.asarray(a.params["W"])
    np.testing.assert_array_equal(Wb, Wa)
    assert b.params["S"].shape == (3 * K, 1, 1, N, N)
    if mask == "full":
        assert Wb.shape == (3 * K, 1, 1, N, N)
        np.testing.assert_array_equal(Wb[1 * 3 + 2, 0, 0], W[:, :, 2, 1])
    else:
        assert Wb.shape == (1, 1, 1, N, N)


@pytest.mark.parametrize("method", ["ism", "cg", "cns"])
def test_defaults_and_getdict_match_jax(method):
    """Default rho (K for ``cns``, 1 for ``ism``/``cg``), AutoRho
    (``cns`` on, the two-block forms off), ``lin_check``'s XSlvRelRes for
    the two-block forms (NaN for ``cns``, and otherwise NaN in both),
    and the dictionary block ``getdict`` reads (``Y[0]`` for ``cns``,
    ``Y[1]`` else)."""
    Z, S, W, dsz, D0 = _problem(1, 1, "full")
    kw = {"cg_tol": 1e-10} if method == "cg" else {}
    a = jm.ConvCnstrMODMaskDcpl(Z, S, W, dsz, method=method, D0=D0,
                                lin_check=True, dtype=np.float64, **kw,
                                opt=jm.ConvCnstrMODMaskDcplOptions(
                                    method=method, max_iter=3))
    b = tm.ConvCnstrMODMaskDcpl(Z, S, W, dsz, method=method, D0=D0,
                                lin_check=True, dtype=np.float64,
                                device="cpu", **kw,
                                opt=tm.ConvCnstrMODMaskDcplOptions(
                                    method=method, max_iter=3))
    assert float(b.state.rho) == float(a.state.rho) == (
        float(K) if method == "cns" else 1.0)
    assert b.opts.auto_rho.enabled == a.opts.auto_rho.enabled == (
        method == "cns")
    a.solve()
    b.solve()
    xa, xb = a.getitstat().XSlvRelRes, b.getitstat().XSlvRelRes
    if method == "cns":
        assert np.all(np.isnan(xa)) and np.all(np.isnan(xb))
    else:
        # ism exact to rounding, cg to its tolerance of 1e-10
        assert np.all(xb < 1e-9) and np.all(xa < 1e-9)
    blk = 0 if method == "cns" else 1
    assert b.getdict_internal() is b.state.Y[blk]
    np.testing.assert_allclose(b.getdict(crop=False).numpy(),
                               np.asarray(a.getdict(crop=False)), rtol=0,
                               atol=1e-8)


def test_options_factory_and_setcoef():
    """``ConvCnstrMODMaskDcplOptions`` returns ``opt`` when given; an
    unknown method raises; ``setcoef`` in either layout gives the same
    solve."""
    opt = tm.ConvCnstrMODMaskDcplOptions(method="ism", max_iter=4)
    assert tm.ConvCnstrMODMaskDcplOptions(opt, method="cns") is opt
    with pytest.raises(KeyError):
        tm.ConvCnstrMODMaskDcpl(None, np.zeros((N, N)), None, (ND, ND, M),
                                method="bogus", device="cpu")
    Z, S, W, dsz, D0 = _problem(1, 1, "full")
    b = tm.ConvCnstrMODMaskDcpl(Z, S, W, dsz, method="cns", D0=D0,
                                dimK=1, device="cpu", dtype=np.float64)
    c = tm.ConvCnstrMODMaskDcpl(None, S, W, dsz, method="cns", D0=D0,
                                dimK=1, device="cpu", dtype=np.float64)
    c.setcoef(Z)
    d = tm.ConvCnstrMODMaskDcpl(None, S, W, dsz, method="cns", D0=D0,
                                dimK=1, device="cpu", dtype=np.float64)
    d.setcoef(b.params["Z"], internal=True)
    for m in (b, c, d):
        m.opts = m.opts.replace(max_iter=3)
        m.solve()
    assert torch.equal(b.getdict(), c.getdict())
    assert torch.equal(b.getdict(), d.getdict())
