"""The port's two-block CSC models (``ConvBPDNMaskDcpl``, ``ConvL1L1Grd``,
``ConvMinL1InL2Ball``) on the CPU against the JAX package's on the same
seeded numpy problems: a single-channel dictionary on two signals with
no mask, a scalar, a spatial, a per-signal and a full mask, and a
single-channel dictionary on a three-channel signal (the mask per
channel).

Tolerances (those of ``tests/test_torch_bpdn.py``, for the reasons given
there):

- float64, solved to 1e-3: the same iteration count, every stats row to
  rtol 1e-6 (float32 rows in both packages) and X and Y within 1e-8 of
  their scale;
- float32, 10 iterations: ObjFun, DFid, RegL1, RegGrad and Rho rows to
  rtol 1e-4, the residuals (and ``Cnstr``, a residual of the ball
  constraint) to rtol 1e-3, X and Y within 2e-4 of their scale;
- float32, solved to 1e-3: the iteration count within one and the last
  objective to rtol 1e-3.

A colour dictionary on a colour signal (Cd = C = 3) stops the JAX
package with a ``while_loop`` carry error: its constant ``0 S[..., :1,
:1]`` of the coefficient block takes S's three channels, which the
shared coefficient maps do not have.  The port's constant broadcasts
over either block, and its solve is held against the minimum of the same
objective that the JAX package's FISTA ``ConvBPDNMask`` reaches.
"""

import jax
import numpy as np
import pytest
import torch

from sporco_tpu import refopts as jrefopts
from sporco_tpu.models import cbpdn as jc
from sporco_tpu.models import pgm as jpgm
from sporco_tpu.ops import fft as jsf
from sporco_tpu.ops import pallas_fft
from sporco_tpu_torch import refopts as trefopts
from sporco_tpu_torch.models import cbpdn as tc
from sporco_tpu_torch.ops import fft as tsf
from sporco_tpu_torch.ops import fft2_planar as tfp

torch.set_num_threads(2)

N, ND, M, K = 32, 4, 6, 2
LMBDA, MU = 0.1, 0.1
MODELS = ("ConvBPDNMaskDcpl", "ConvL1L1Grd", "ConvMinL1InL2Ball")
RSDL = ("PrimalRsdl", "DualRsdl", "Cnstr")
MASKS = ("none", "scalar", "spatial", "signal", "full")


def _problem(C=1, Cd=1, seed=0, n=N, k=K):
    """A sparse code over a random dictionary with noise at 0.05."""
    rng = np.random.default_rng(seed)
    dsz = (ND, ND, Cd, M) if Cd > 1 else (ND, ND, M)
    D = rng.standard_normal(dsz)
    D /= np.sqrt((D ** 2).sum(axis=(0, 1, 2) if Cd > 1 else (0, 1),
                              keepdims=True))
    shp = (n, n) + ((C,) if C > 1 else ()) + (k,)
    S = 0.05 * rng.standard_normal(shp)
    Dk = D if Cd > 1 else D[:, :, None, :]
    for i in range(k):
        X = rng.standard_normal((n, n, M)) * (rng.random((n, n, M)) < 0.02)
        for c in range(C):
            img = np.zeros((n, n))
            for m in range(M):
                img += np.real(np.fft.ifft2(np.fft.fft2(X[..., m]) * np.fft.fft2(
                    Dk[..., min(c, Dk.shape[2] - 1), m], s=(n, n))))
            S[(..., c, i) if C > 1 else (..., i)] += img
    return D.astype(np.float32), S.astype(np.float32)


def _mask(kind, S, seed=1):
    rng = np.random.default_rng(seed)
    if kind == "none":
        return None
    if kind == "scalar":
        return np.float32(0.7)
    if kind == "spatial":
        shp = S.shape[:2]
    elif kind == "signal":
        shp = S.shape[:2] + S.shape[-1:]
    else:
        shp = S.shape
    return (rng.random(shp) > 0.25).astype(np.float32)


def _kw(name, S):
    if name == "ConvBPDNMaskDcpl":
        return {"lmbda": LMBDA}
    if name == "ConvL1L1Grd":
        return {"lmbda": LMBDA, "mu": MU}
    return {"epsilon": 0.8 * 0.05 * np.sqrt(S[..., 0].size)}


def _make(name, pkg, D, S, dtype, max_iter, tol, W=None, **kw):
    cls = getattr(jc if pkg == "jax" else tc, name)
    kw = {**_kw(name, S), **kw}
    if W is not None:
        kw["W"] = W
    if pkg == "port":
        kw["device"] = "cpu"
    return cls(D, S, opt=cls.options(max_iter=max_iter, rel_stop_tol=tol),
               dtype=dtype, **kw)


def _pair(name, D, S, dtype, max_iter, tol, **kw):
    a = _make(name, "jax", D, S, dtype, max_iter, tol, **kw)
    a.solve()
    b = _make(name, "port", D, S, dtype, max_iter, tol, **kw)
    b.solve()
    return a, b


def _assert_states(a, b, rel):
    for ja, ta in zip(a.state.X + a.state.Y, b.state.X + b.state.Y):
        ja, ta = np.asarray(ja), ta.numpy()
        assert ta.shape == ja.shape and ta.dtype == ja.dtype
        assert np.abs(ta - ja).max() <= rel * max(np.abs(ja).max(), 1e-30)


def _assert_rows(a, b, rtol, rsdl_rtol):
    ja, ta = a.getitstat(), b.getitstat()
    assert ta._names == ja._names
    for name in ja._names:
        np.testing.assert_allclose(
            getattr(ta, name), getattr(ja, name), err_msg=name,
            rtol=rsdl_rtol if name in RSDL else rtol)


@pytest.mark.parametrize("mask", MASKS)
@pytest.mark.parametrize("name", MODELS)
def test_float64_solve_matches_jax(name, mask):
    D, S = _problem()
    a, b = _pair(name, D, S, "float64", 300, 1e-3, W=_mask(mask, S))
    assert len(a.getitstat()) == len(b.getitstat()) < 300
    _assert_rows(a, b, 1e-6, 1e-6)
    _assert_states(a, b, 1e-8)
    np.testing.assert_allclose(b.getmin().numpy(), np.asarray(a.getmin()),
                               rtol=0, atol=1e-8 * np.abs(
                                   np.asarray(a.getmin())).max())
    np.testing.assert_allclose(b.reconstruct().numpy(),
                               np.asarray(a.reconstruct()), rtol=0,
                               atol=1e-8 * np.abs(S).max())


@pytest.mark.parametrize("name", MODELS)
def test_multichannel_signal_matches_jax(name):
    """A single-channel dictionary on a three-channel signal (dimK=0):
    coefficient maps per channel, a mask per channel."""
    D, S = _problem(C=3, Cd=1, k=1)
    S = S[..., 0]
    W = (np.random.default_rng(2).random(S.shape) > 0.25).astype(
        np.float32)
    a, b = _pair(name, D, S, "float64", 300, 1e-3, W=W, dimK=0)
    assert b.cri.C == 3 and b.cri.Cd == 1 and b.state.Y[1].shape[1] == 3
    assert len(a.getitstat()) == len(b.getitstat()) < 300
    _assert_rows(a, b, 1e-6, 1e-6)
    _assert_states(a, b, 1e-8)


@pytest.mark.parametrize("name", MODELS)
def test_float32_iterations_match_jax(name):
    D, S = _problem()
    a, b = _pair(name, D, S, "float32", 10, 0.0, W=_mask("full", S))
    assert len(a.getitstat()) == len(b.getitstat()) == 10
    _assert_rows(a, b, 1e-4, 1e-3)
    _assert_states(a, b, 2e-4)


@pytest.mark.parametrize("name", MODELS)
def test_float32_solve_matches_jax(name):
    D, S = _problem()
    a, b = _pair(name, D, S, "float32", 300, 1e-3, W=_mask("spatial", S))
    ja, ta = a.getitstat(), b.getitstat()
    assert abs(len(ja) - len(ta)) <= 1 and len(ta) < 300
    np.testing.assert_allclose(ta.ObjFun[-1], ja.ObjFun[-1], rtol=1e-3)


def _pairs(a, b):
    return [(np.asarray(x), y.numpy()) for x, y in zip(a, b)]


@pytest.mark.parametrize("name", MODELS)
def test_dual_residual_forms(name):
    """After one iteration from Y = U = 0: ``ConvBPDNMaskDcpl`` and
    ``ConvMinL1InL2Ball`` report the reference's ``rho ||A^T U|| /
    (rho ||U||)``, ``ConvL1L1Grd`` the driver's standard ``rho ||A^T
    B (Y - 0)|| / (rho ||A^T U||)``; both from the state the port's
    iteration leaves, in float64, and the same in the JAX package."""
    D, S = _problem()
    a, b = _pair(name, D, S, "float64", 1, 0.0, W=_mask("full", S))
    rho = float(b.getitstat().Rho[0])

    def at(V):
        return tc._csc2_cnst_at(b.cfg, tc._csc2_setup(b.cfg, b.params),
                                b.params, V)

    def norm(t):
        return float(torch.linalg.vector_norm(t.reshape(-1)))
    U = b.state.U
    nu = np.sqrt(sum(norm(u) ** 2 for u in U))
    if name == "ConvL1L1Grd":
        want = norm(at(b.state.Y)) / norm(at(U))
    else:
        want = norm(at(U)) / nu
    got = float(b.getitstat().DualRsdl[0])
    assert got == pytest.approx(want, rel=1e-6)
    assert float(a.getitstat().DualRsdl[0]) == pytest.approx(got, rel=1e-6)
    assert rho == 1.0


@pytest.mark.parametrize("name", MODELS)
def test_planar_route_matches_jax_and_counts(name, monkeypatch):
    """At 128x128 every transform of the two-block x-step takes the FFT
    kernels' route (the port's plain versions, the JAX package's Pallas
    kernels in interpret mode): 5 float32 iterations agree, and the
    planar calls are those ``chip_smoke.py`` holds the card to: per
    iteration 2 forward and 2 inverse in the x-step, then 1 and 1 in
    the dual residual ``rho A^T U`` (``ConvL1L1Grd``: 2 and 2, its
    standard residual and its normaliser), and 1 forward in the set-up
    (the dictionary; ``ConvL1L1Grd`` 2: the gradient filters too)."""
    counts = {"rfft2_planar": 0, "irfft2_planar": 0}
    for label, attr in (("rfft2_planar", "rfft2_planar_plain"),
                        ("irfft2_planar", "irfft2_planar_plain")):
        fn = getattr(tfp, attr)

        def counted(*a, _fn=fn, _label=label, **k):
            counts[_label] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(tfp, attr, counted)
    D, S = _problem(n=128, k=1, seed=3)
    W = _mask("spatial", S)
    prev = pallas_fft.interpret
    pallas_fft.interpret = True
    jsf.use_mxu_fft("always")
    tsf.use_planar_fft("always")
    jax.clear_caches()
    try:
        a = _make(name, "jax", D, S, "float32", 5, 0.0, W=W)
        a.solve()
        b = _make(name, "port", D, S, "float32", 5, 0.0, W=W)
        counts.update(rfft2_planar=0, irfft2_planar=0)
        b.solve()
    finally:
        jsf.use_mxu_fft("auto")
        tsf.use_planar_fft("auto")
        pallas_fft.interpret = prev
        jax.clear_caches()
    _assert_rows(a, b, 1e-4, 1e-3)
    _assert_states(a, b, 2e-4)
    k = 5
    per, setup = (4, 2) if name == "ConvL1L1Grd" else (3, 1)
    assert counts == {"rfft2_planar": per * k + setup,
                      "irfft2_planar": per * k}


def test_colour_dictionary_solves_the_masked_problem():
    """Cd = C = 3 (which the JAX package cannot run, see the module
    docstring): the port's ADMM solve to 1e-5 reaches the objective and
    coefficients of the JAX package's FISTA ``ConvBPDNMask`` on the same
    masked problem (2000 iterations) within 1e-5 and 1e-3 of their
    scale."""
    D, S = _problem(C=3, Cd=3, k=1, n=16)
    S = S[..., 0]
    W = (np.random.default_rng(4).random(S.shape) > 0.25).astype(
        np.float32)
    b = tc.ConvBPDNMaskDcpl(D, S, LMBDA, W=W, dimK=0, dtype="float64",
                            device="cpu", opt=tc.ConvBPDNMaskDcpl.options(
                                max_iter=3000, rel_stop_tol=1e-6))
    b.solve()
    assert b.state.Y[1].shape[1] == 1 and len(b.getitstat()) < 3000
    f = jpgm.ConvBPDNMask(D, S, LMBDA, W=W, dimK=0, dtype=np.float64,
                          opt=jpgm.ConvBPDNMask.options(
                              max_iter=2000, rel_stop_tol=0.0, L=50.0))
    f.solve()
    with pytest.raises(TypeError, match="carry"):
        jc.ConvBPDNMaskDcpl(D, S, LMBDA, W=W, dimK=0, dtype=np.float64,
                            opt=jc.ConvBPDNMaskDcpl.options(
                                max_iter=2)).solve()
    Xb = b.getmin().numpy()
    Xf = np.asarray(f.getmin())
    # the port's objective at its coefficients, by the FISTA model's own
    # objective of the same problem
    obj_f = float(f.getitstat().ObjFun[-1])
    DX = b.reconstruct(Xb).numpy()
    obj_b = 0.5 * np.sum((W * (DX - S)) ** 2) + LMBDA * np.abs(Xb).sum()
    assert obj_b == pytest.approx(obj_f, rel=1e-5)
    assert np.abs(Xb - Xf).max() <= 1e-3 * np.abs(Xf).max()


@pytest.mark.parametrize("kw", [{"lmbda": None}, {"non_neg": True},
                                {"no_bndry": True}, {"wl1": "array"}],
                         ids=["default_lmbda", "non_neg", "no_bndry",
                              "wl1"])
def test_options_match_jax(kw):
    """The default lmbda (``0.1 max|D^H S|``), NonNegCoef, NoBndryCross
    and a per-filter L1Weight, float64, 40 iterations."""
    D, S = _problem()
    if kw.get("wl1") == "array":
        kw = {"wl1": np.random.default_rng(3).uniform(
            0.5, 1.5, (1, 1, 1, M)).astype(np.float32)}
    kw = {"lmbda": LMBDA, **kw}
    a = jc.ConvBPDNMaskDcpl(D, S, W=_mask("full", S), dtype=np.float64,
                            opt=jc.ConvBPDNMaskDcpl.options(max_iter=40),
                            **kw)
    a.solve()
    b = tc.ConvBPDNMaskDcpl(D, S, W=_mask("full", S), dtype=np.float64,
                            opt=tc.ConvBPDNMaskDcpl.options(max_iter=40),
                            device="cpu", **kw)
    b.solve()
    assert b.lmbda == pytest.approx(a.lmbda, rel=1e-12)
    _assert_rows(a, b, 1e-6, 1e-6)
    _assert_states(a, b, 1e-8)
    if kw.get("non_neg"):
        assert float(b.getmin().min()) >= 0.0


def test_ref_options_and_defaults_match_jax():
    """A reference-style option dict gives the same options; the default
    options (rho 1, AutoRho off; ``ConvMinL1InL2Ball``: AutoRho on,
    Period 10); an unknown key raises in both."""
    opt = {"MaxMainIter": 7, "RelStopTol": 1e-4, "rho": 2.0,
           "NonNegCoef": True, "L1Weight": 0.5}
    D, S = _problem()
    a = jc.ConvBPDNMaskDcpl(D, S, LMBDA, opt=opt)
    b = tc.ConvBPDNMaskDcpl(D, S, LMBDA, opt=opt, device="cpu")
    assert b.opts.max_iter == a.opts.max_iter == 7
    assert b.opts.rho == a.opts.rho == 2.0
    assert b.cfg.non_neg and float(b.params["wl1"]) == 0.5
    for name in MODELS:
        ja, ta = getattr(jc, name).options(), getattr(tc, name).options()
        assert (ta.rho, ta.relax_param, ta.auto_rho.enabled,
                ta.auto_rho.period) == (ja.rho, ja.relax_param,
                                        ja.auto_rho.enabled,
                                        ja.auto_rho.period)
    with pytest.raises(trefopts.UnknownKeyError):
        tc.ConvBPDNMaskDcpl(D, S, LMBDA, opt={"Bogus": 1}, device="cpu")
    with pytest.raises(jrefopts.UnknownKeyError):
        jc.ConvBPDNMaskDcpl(D, S, LMBDA, opt={"Bogus": 1})


def test_card_default_and_tensor_inputs():
    """Without ``device`` the models run on the card and raise where there
    is none; tensors are taken as numpy arrays are."""
    D, S = _problem()
    b = tc.ConvBPDNMaskDcpl(torch.as_tensor(D), torch.as_tensor(S), LMBDA,
                            device="cpu")
    c = tc.ConvBPDNMaskDcpl(D, S, LMBDA, device="cpu")
    assert torch.equal(b.params["D"], c.params["D"])
    if not torch.cuda.is_available():
        for name in MODELS:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                getattr(tc, name)(D, S, **_kw(name, S))
