"""The port's product-dictionary CSC models (``ConvProdDictBPDN``,
``ConvProdDictBPDNJoint``, ``ConvProdDictL1L1Grd``,
``ConvProdDictL1L1GrdJoint``) on the CPU against the JAX package's on the
same seeded numpy problems: a colour image, a single-channel dictionary
and ``B`` the channel DCT basis (``examples/csc_product_dict.py``) or a
PCA basis of the pixels (``examples/csc_impulse_pd_pca.py``, from the
port's ``pca``), the l1 fidelity forms on salt-and-pepper noise with an
impulse filter whose map carries the smooth part
(``examples/csc_impulse_pd_dct.py``); and the FFT kernels' route.

Tolerances (those of ``tests/test_torch_maskdcpl.py``): float64 solved to
1e-3, the same iteration count, every row to rtol 1e-6, X and Y within
1e-8 of their scale; float32 over 10 iterations, the objective rows and
Rho to rtol 1e-4, the residuals to rtol 1e-3, X and Y within 2e-4;
float32 solved to 1e-3, the iteration count within one and the last
objective to rtol 1e-3.  The l1 fidelity forms run a fixed number of
iterations, as ``examples/csc_impulse_pd_dct.py`` does: their dual
residual is the two-block form ``rho A^T U`` over ``rho ||U||``, which
does not vanish, so neither package stops them at a tolerance
(:func:`test_l1_fidelity_dual_residual_stalls_as_jax`).
"""

import jax
import numpy as np
import pytest
import torch

from sporco_tpu.models import pdcsc as jm
from sporco_tpu.ops import fft as jsf
from sporco_tpu.ops import pallas_fft
from sporco_tpu_torch.models import pdcsc as tm
from sporco_tpu_torch.ops import fft as tsf
from sporco_tpu_torch.ops import fft2_planar as tfp
from sporco_tpu_torch.ops import linalg as tla
from sporco_tpu_torch.utils import signal as tsig

torch.set_num_threads(2)

N, ND, M = 32, 4, 6
RSDL = ("PrimalRsdl", "DualRsdl")
MODELS = ("ConvProdDictBPDN", "ConvProdDictBPDNJoint",
          "ConvProdDictL1L1Grd", "ConvProdDictL1L1GrdJoint")


def _dct_basis(n):
    k = np.arange(n)
    B = np.cos(np.pi * (2 * k[None, :] + 1) * k[:, None] / (2 * n))
    B[0] /= np.sqrt(n)
    B[1:] *= np.sqrt(2.0 / n)
    return B.T.astype(np.float32)


def _image(n=N, seed=0):
    y, x = np.mgrid[:n, :n] / n
    r = np.sqrt((x - 0.4) ** 2 + (y - 0.6) ** 2)
    img = np.stack([0.5 + 0.4 * np.cos(6 * r), 0.5 + 0.3 * np.cos(6 * r + 0.4),
                    0.5 + 0.2 * np.cos(6 * r + 0.8)], axis=-1)
    return img.astype(np.float32)


def _dict(seed=1, impulse=False):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((ND, ND, M))
    D /= np.sqrt((D ** 2).sum(axis=(0, 1), keepdims=True))
    if impulse:
        imp = np.zeros((ND, ND, 1))
        imp[0, 0, 0] = 1.0
        D = np.concatenate([D, imp], axis=-1)
    return D.astype(np.float32)


def _basis(kind, S):
    if kind == "dct":
        return _dct_basis(3)
    pix = torch.as_tensor(S.reshape(-1, 3).T.astype(np.float64))
    B, _, _ = tla.pca(pix)
    return B[:, :2].numpy().astype(np.float32)


def _problem(name, basis="dct", n=N):
    """(D, B, S, arguments) of ``name``: the plain forms on the image's
    high-pass part (noise at 0.02), lmbda 0.05 (joint: mu 0.02); the l1
    fidelity forms on the image with 10% salt and pepper (``spnoise``
    from a seeded draw), the dictionary and an impulse filter, the
    impulse's map free of the l1 term and alone under the gradient
    penalty, lmbda 1.4 and mu 9 (joint: mu2 0.02), rho 10."""
    img = _image(n)
    rng = np.random.default_rng(2)
    if name.startswith("ConvProdDictL1L1Grd"):
        S = tsig.spnoise(img, 0.1, u=rng.random(img.shape)).numpy()
        D = _dict(impulse=True)
        wl1 = np.ones((1, 1, 1, 1, M + 1), np.float32)
        wl1[..., -1] = 0.0
        wgrd = np.zeros(M + 1, np.float32)
        wgrd[-1] = 1.0
        kw = {"lmbda": 1.4, "mu": 9.0, "wl1": wl1, "wgrd": wgrd}
        if name.endswith("Joint"):
            kw["mu2"] = 0.02
        W = (rng.random(img.shape) > 0.1).astype(np.float32)
        return D, _basis(basis, img), S.astype(np.float32), {**kw, "W": W}
    _, sh = tsig.tikhonov_filter(img.transpose(2, 0, 1), 5.0)
    S = sh.numpy().transpose(1, 2, 0) + 0.02 * rng.standard_normal(
        img.shape)
    kw = {"lmbda": 0.05}
    if name.endswith("Joint"):
        kw["mu"] = 0.02
    return _dict(), _basis(basis, img), S.astype(np.float32), kw


def _opt(cls, name, max_iter, tol):
    extra = {"rho": 10.0} if "L1L1" in name else {}
    return cls.options(max_iter=max_iter, rel_stop_tol=tol, **extra)


def _pair(name, dtype, max_iter, tol, basis="dct", n=N):
    D, B, S, kw = _problem(name, basis, n)
    jcls, tcls = getattr(jm, name), getattr(tm, name)
    a = jcls(D, B, S, dimK=0, dtype=dtype,
             opt=_opt(jcls, name, max_iter, tol), **kw)
    a.solve()
    b = tcls(D, B, S, dimK=0, dtype=dtype, device="cpu",
             opt=_opt(tcls, name, max_iter, tol), **kw)
    b.solve()
    return a, b


def _assert_rows(a, b, rtol, rsdl_rtol):
    ja, ta = a.getitstat(), b.getitstat()
    assert ta._names == ja._names
    for name in ja._names:
        np.testing.assert_allclose(
            getattr(ta, name), getattr(ja, name), err_msg=name, atol=1e-30,
            rtol=rsdl_rtol if name in RSDL else rtol)


def _leaves(v):
    return v if isinstance(v, tuple) else (v,)


def _assert_states(a, b, rel):
    for name in ("X", "Y", "U"):
        for ja, ta in zip(_leaves(getattr(a.state, name)),
                          _leaves(getattr(b.state, name))):
            ja, ta = np.asarray(ja), ta.numpy()
            assert ta.shape == ja.shape and ta.dtype == ja.dtype, name
            assert np.abs(ta - ja).max() <= rel * max(np.abs(ja).max(),
                                                      1e-30), name


FIXED = 60      # iterations of a whole run of the l1 fidelity forms


def _run(name):
    """(max_iter, rel_stop_tol) of a whole run."""
    return (FIXED, 0.0) if "L1L1" in name else (500, 1e-3)


@pytest.mark.parametrize("basis", ["dct", "pca"])
@pytest.mark.parametrize("name", MODELS)
def test_float64_solve_matches_jax(name, basis):
    a, b = _pair(name, "float64", *_run(name), basis=basis)
    assert len(a.getitstat()) == len(b.getitstat()) < 500
    _assert_rows(a, b, 1e-6, 1e-6)
    _assert_states(a, b, 1e-8)
    ja, tb = np.asarray(a.getmin()), b.getmin().numpy()
    assert tb.shape == ja.shape
    assert np.abs(tb - ja).max() <= 1e-8 * np.abs(ja).max()
    ja, tb = np.asarray(a.reconstruct()), b.reconstruct().numpy()
    assert tb.shape == ja.shape
    assert np.abs(tb - ja).max() <= 1e-8 * np.abs(ja).max()
    X = a.getmin()
    ja = np.asarray(a.reconstruct(X))
    assert np.abs(b.reconstruct(np.asarray(X)).numpy() - ja).max() <= \
        1e-8 * np.abs(ja).max()


@pytest.mark.parametrize("name", MODELS)
def test_float32_iterations_match_jax(name):
    a, b = _pair(name, "float32", 10, 0.0)
    assert len(a.getitstat()) == len(b.getitstat()) == 10
    _assert_rows(a, b, 1e-4, 1e-3)
    _assert_states(a, b, 2e-4)


@pytest.mark.parametrize("name", MODELS)
def test_float32_solve_matches_jax(name):
    a, b = _pair(name, "float32", *_run(name))
    ja, ta = a.getitstat(), b.getitstat()
    assert abs(len(ja) - len(ta)) <= 1 and len(ta) < 500
    np.testing.assert_allclose(ta.ObjFun[-1], ja.ObjFun[-1], rtol=1e-3)


@pytest.mark.parametrize("name", ["ConvProdDictL1L1Grd",
                                  "ConvProdDictL1L1GrdJoint"])
def test_l1_fidelity_dual_residual_stalls_as_jax(name):
    """The dual residual of the l1 fidelity forms, ``||A^T U|| / ||U||``,
    stays near 0.4 over 300 iterations in both packages while the primal
    residual vanishes: no tolerance stops them; the port follows the JAX
    package row for row over the first 100."""
    a, b = _pair(name, "float64", 300, 1e-3)
    ja, ta = a.getitstat(), b.getitstat()
    assert len(ja) == len(ta) == 300
    assert ta.DualRsdl[-1] > 0.1 and ta.PrimalRsdl[-1] < 1e-3
    for col in ja._names:
        np.testing.assert_allclose(getattr(ta, col)[:100],
                                   getattr(ja, col)[:100], rtol=1e-6,
                                   atol=1e-30, err_msg=col)


def test_options_and_weights_match_jax():
    """The default options (the l1 fidelity forms: rho 1, AutoRho off),
    an l1 weight in the reference layout (one per filter), the card
    default and the single-channel dictionary rule."""
    for name in MODELS:
        ja, ta = getattr(jm, name).options(), getattr(tm, name).options()
        assert ta.auto_rho == type(ta.auto_rho)(**vars(ja.auto_rho))
        assert (ta.relax_param, ta.rho) == (ja.relax_param, ja.rho)
    D, B, S, kw = _problem("ConvProdDictBPDN")
    kw["wl1"] = np.random.default_rng(3).uniform(0.5, 1.5, (1, 1, 1, 1, M))
    a = jm.ConvProdDictBPDN(D, B, S, dimK=0, dtype=np.float64,
                            opt=jm.ConvProdDictBPDN.options(max_iter=20),
                            **kw)
    a.solve()
    b = tm.ConvProdDictBPDN(D, B, S, dimK=0, dtype="float64", device="cpu",
                            opt=tm.ConvProdDictBPDN.options(max_iter=20),
                            **kw)
    b.solve()
    assert tuple(b.params["wl1"].shape) == (1, 1, M, 1, 1)
    _assert_rows(a, b, 1e-6, 1e-6)
    with pytest.raises(ValueError, match="single-channel"):
        tm.ConvProdDictBPDN(np.ones((ND, ND, 3, M)), B, S, 0.05, dimK=0,
                            device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.ConvProdDictBPDN(D, B, S, 0.05, dimK=0)


@pytest.mark.parametrize("name", MODELS)
def test_planar_route_matches_jax_and_counts(name, monkeypatch):
    """At 128x128 (the transforms of ``(1, R, M, N0, N1)`` coefficient
    arrays, the leading axes flattened) every transform takes the FFT
    kernels' route: 5 float32 iterations agree, and the planar calls are
    those ``chip_smoke.py`` holds the card to: 2 forward in the set-up
    (D, and S or the gradient filters), then an iteration 1 forward and 1
    inverse (the plain and joint forms) or 3 and 3 (the l1 fidelity
    forms: 2 and 2 in the x-step, 1 and 1 in the dual residual ``rho A^T
    U``)."""
    counts = {"rfft2_planar": 0, "irfft2_planar": 0}
    for label, attr in (("rfft2_planar", "rfft2_planar_plain"),
                        ("irfft2_planar", "irfft2_planar_plain")):
        fn = getattr(tfp, attr)

        def counted(*a, _fn=fn, _label=label, **k):
            counts[_label] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(tfp, attr, counted)
    prev = pallas_fft.interpret
    pallas_fft.interpret = True
    jsf.use_mxu_fft("always")
    tsf.use_planar_fft("always")
    jax.clear_caches()
    k = 5
    D, B, S, kw = _problem(name, n=128)
    try:
        a = getattr(jm, name)(D, B, S, dimK=0, opt=_opt(
            getattr(jm, name), name, k, 0.0), **kw)
        a.solve()
        b = getattr(tm, name)(D, B, S, dimK=0, device="cpu", opt=_opt(
            getattr(tm, name), name, k, 0.0), **kw)
        counts.update(rfft2_planar=0, irfft2_planar=0)
        b.solve()
    finally:
        jsf.use_mxu_fft("auto")
        tsf.use_planar_fft("auto")
        pallas_fft.interpret = prev
        jax.clear_caches()
    _assert_rows(a, b, 1e-4, 1e-3)
    _assert_states(a, b, 2e-4)
    per = 3 if "L1L1" in name else 1
    assert counts == {"rfft2_planar": per * k + 2, "irfft2_planar": per * k}
