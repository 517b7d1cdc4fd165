"""The user-layout hand-overs of the port's CSC models, ``setdict(D)`` and
``setcoef(Z)``, against the JAX package's: D and Z take the model's
dtype (``pgm.ConvBPDN.setdict`` in float64 agrees with the JAX package
to 1e-12 of D's scale, where a float32 round trip was 1.5e-8 off), a
tensor is taken as it is and gives what the same numpy array gives, and
the generic ``DictLearn`` over port models, whose hand-overs pass the
models' own tensors, follows the JAX package's ``DictLearn`` over JAX
models.

Tolerances: float64 within 1e-12 of D's scale after ``setdict`` (the
same array, cast once), a solve after it and the dictionary learning
within 1e-8 of their scale (PERF.md §2).
"""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from sporco_tpu.models import ccmod as jccmod
from sporco_tpu.models import cbpdn as jcbpdn
from sporco_tpu.models import dictlrn as jdl
from sporco_tpu.models import pgm as jpgm
from sporco_tpu_torch.models import ccmod as tccmod
from sporco_tpu_torch.models import cbpdn as tcbpdn
from sporco_tpu_torch.models import dictlrn as tdl
from sporco_tpu_torch.models import pgm as tpgm

torch.set_num_threads(2)

LMBDA = 0.05


def _problem(N=32, M=4, Nd=8, seed=0, K=None):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((Nd, Nd, M))
    D /= np.sqrt((D ** 2).sum(axis=(0, 1), keepdims=True))
    shape = (N, N) if K is None else (N, N, K)
    S = gaussian_filter(rng.standard_normal(shape), 4.0,
                        axes=(0, 1)) * 5.0
    S += 0.1 * rng.standard_normal(shape)
    return D, S


def test_pgm_setdict_float64_matches_jax():
    """``pgm.ConvBPDN.setdict`` keeps a float64 D in float64: the internal
    D is the JAX package's to 1e-12 of its scale, and 20 iterations after
    it agree to 1e-8."""
    D1, S = _problem()
    D2, _ = _problem(seed=1)
    opt = dict(max_iter=20)
    a = jpgm.ConvBPDN(D1, S, LMBDA, opt=jpgm.ConvBPDN.options(**opt),
                      dtype="float64", fused=False)
    b = tpgm.ConvBPDN(D1, S, LMBDA, opt=tpgm.ConvBPDN.options(**opt),
                      dtype="float64", fused=False, device="cpu")
    a.setdict(D2)
    b.setdict(D2)
    jD, tD = np.asarray(a.params["D"]), b.params["D"].numpy()
    assert tD.dtype == np.float64 and tD.shape == jD.shape
    assert np.abs(tD - jD).max() <= 1e-12 * np.abs(jD).max()
    a.solve()
    b.solve()
    jX, tX = np.asarray(a.getmin()), b.getmin().numpy()
    assert np.abs(tX - jX).max() <= 1e-8 * np.abs(jX).max()


def _dict_models(dtype):
    D, S = _problem()
    return [
        tcbpdn.ConvBPDN(D, S, LMBDA, dtype=dtype, device="cpu"),
        tpgm.ConvBPDN(D, S, LMBDA, dtype=dtype, device="cpu"),
    ]


def _coef_models(dtype):
    D, S = _problem()
    Z = np.random.default_rng(2).standard_normal((32, 32, 1, 1, 4))
    return [
        tccmod.ConvCnstrMOD(Z, S, D.shape, method=m, dtype=dtype,
                            device="cpu") for m in ("ism", "cg", "cns")
    ] + [tpgm.ConvCnstrMOD(Z, S, D.shape, dtype=dtype, device="cpu")], Z


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_setdict_takes_tensors(dtype):
    """``setdict`` of a numpy array, of a tensor of its dtype, of one
    that requires grad (which ``numpy.asarray`` refuses, as it refuses a
    card tensor) and of a tensor of another dtype: the same internal D,
    of the model's dtype."""
    D2, _ = _problem(seed=1)
    other = torch.float32 if dtype == "float64" else torch.float64
    for model in _dict_models(dtype):
        got = []
        for D in (D2, torch.tensor(D2), torch.tensor(D2, requires_grad=True),
                  torch.tensor(D2, dtype=other)):
            model.setdict(D)
            got.append(model.params["D"].clone())
        assert all(g.dtype == getattr(torch, dtype) for g in got)
        for g in got[1:3]:
            torch.testing.assert_close(g, got[0], rtol=0, atol=0)
        if dtype == "float32":
            torch.testing.assert_close(got[3], got[0], rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_setcoef_takes_tensors(dtype):
    """``setcoef`` of a numpy array, of a tensor and of one that requires
    grad: the same internal Z, of the model's dtype, for every CCMOD
    method and the FISTA CCMOD."""
    models, Z = _coef_models(dtype)
    for model in models:
        model.setcoef(Z)
        zn = model.params["Z"].clone()
        for Zt in (torch.tensor(Z), torch.tensor(Z, requires_grad=True)):
            model.setcoef(Zt)
            assert model.params["Z"].dtype == getattr(torch, dtype)
            assert not model.params["Z"].requires_grad
            torch.testing.assert_close(model.params["Z"], zn, rtol=0,
                                       atol=0)


def _generic(pkg, D0, S, dtype):
    xm, dm, dl = ((jcbpdn, jccmod, jdl) if pkg == "jax"
                  else (tcbpdn, tccmod, tdl))
    kw = {} if pkg == "jax" else {"device": "cpu"}
    xopt = xm.ConvBPDN.options(max_iter=5, rel_stop_tol=0.0)
    x = xm.ConvBPDN(D0, S, LMBDA, opt=xopt, dtype=dtype, fused=False, **kw)
    Z0 = np.zeros(S.shape[:2] + (1, 1, D0.shape[-1]))
    dopt = dm.ConvCnstrMODBase.options(max_iter=5, rel_stop_tol=0.0)
    d = dm.ConvCnstrMOD(Z0, S, D0.shape, opt=dopt, method="cns",
                        dtype=dtype, **kw)
    return dl.DictLearn(x, d, max_iter=3)


def test_generic_dictlearn_matches_jax():
    """The generic ``DictLearn`` alternation over port models (user-layout
    hand-overs: ``getcoef``/``setcoef`` and ``getdict``/``setdict``),
    3 outer iterations in float64, against the JAX package's over JAX
    models."""
    D0, S = _problem()
    a = _generic("jax", D0, S, "float64")
    b = _generic("port", D0, S, "float64")
    jD = np.asarray(a.solve())
    tD = b.solve().numpy()
    assert tD.shape == jD.shape
    assert np.abs(tD - jD).max() <= 1e-8 * np.abs(jD).max()
    jX, tX = np.asarray(a.getcoef()), b.getcoef().numpy()
    assert np.abs(tX - jX).max() <= 1e-8 * np.abs(jX).max()
    for key in ("XObjFun", "DDFid"):
        np.testing.assert_allclose(b.getitstat()[key], a.getitstat()[key],
                                   rtol=1e-6)
