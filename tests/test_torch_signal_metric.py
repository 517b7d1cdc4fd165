"""The rest of the port's ``utils.signal`` (``spnoise``, ``rndmask``,
``rgb2gray``, ``tikhonov_filter``, ``gaussian``,
``local_contrast_normalise``) and its ``utils.metric`` on the CPU
against the JAX package's on the same seeded numpy inputs.  Where the
JAX function draws from a ``jax.random`` key, the port is given the same
uniform draw (``u``).  Float64 results are held to 1e-12 of their scale,
float32 ones to 1e-5 (the FFTs of the two packages round differently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sporco_tpu.utils import metric as jmet
from sporco_tpu.utils import signal as jsig
from sporco_tpu_torch.ops import linalg as tla
from sporco_tpu_torch.utils import metric as tmet
from sporco_tpu_torch.utils import signal as tsig

torch.set_num_threads(2)


def _img(shape=(24, 20), seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[:shape[0], :shape[1]]
    base = 0.5 + 0.3 * np.sin(x / 3.0) * np.cos(y / 4.0)
    base = base.reshape(base.shape + (1,) * (len(shape) - 2))
    return (base + 0.05 * rng.standard_normal(shape)).astype(dtype)


def _close(t, j, rel):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    assert np.abs(t - j).max() <= rel * max(np.abs(j).max(), 1e-30)


def test_spnoise_and_rndmask_match_jax():
    """The same uniform draw gives the same noise and mask; without one
    the port draws from its generator."""
    s = _img()
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, s.shape))
    _close(tsig.spnoise(s, 0.2, u=u), jsig.spnoise(key, jnp.asarray(s), 0.2),
           0)
    _close(tsig.spnoise(s, 0.3, smn=-1.0, smx=2.0, u=u),
           jsig.spnoise(key, jnp.asarray(s), 0.3, smn=-1.0, smx=2.0), 0)
    _close(tsig.rndmask(s.shape, 0.4, u=u, dtype=torch.float64,
                        device="cpu"),
           jsig.rndmask(key, s.shape, 0.4, dtype=jnp.float64), 0)
    g = torch.Generator().manual_seed(0)
    m = tsig.rndmask((100, 100), 0.25, generator=g, device="cpu")
    assert m.dtype == torch.float32 and abs(float(1 - m.mean()) - 0.25) < 0.02
    n = tsig.spnoise(np.zeros((100, 100)), 0.1,
                     generator=torch.Generator().manual_seed(1))
    assert abs(float((n == 1.0).double().mean()) - 0.05) < 0.01


@pytest.mark.parametrize("axis", [-1, 0])
def test_rgb2gray_matches_jax(axis):
    rgb = np.moveaxis(_img((16, 12, 3)), -1, axis)
    _close(tsig.rgb2gray(rgb, axis=axis),
           jsig.rgb2gray(jnp.asarray(rgb), axis=axis), 1e-12)


@pytest.mark.parametrize("dtype,rel", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("shape,npd", [((24, 20), 16), ((3, 18, 22), 5)],
                         ids=str)
def test_tikhonov_filter_matches_jax(shape, npd, dtype, rel):
    """Both parts, a 2-D image and a stack of three (the two trailing
    axes spatial), with the default and a small pad."""
    s = _img(shape, dtype=dtype)
    tl, th = tsig.tikhonov_filter(s, 5.0, npd=npd)
    jl, jh = jsig.tikhonov_filter(jnp.asarray(s), 5.0, npd=npd)
    assert tl.dtype == getattr(torch, np.dtype(dtype).name)
    _close(tl, jl, rel)
    _close(th, jh, rel)


def test_gaussian_matches_jax():
    for shape, sd in ((7, 1.0), ((5, 9), 1.5), ((3, 4, 5), 0.7)):
        g = tsig.gaussian(shape, sd=sd, dtype=torch.float64,
                          device="cpu")
        _close(g, jsig.gaussian(shape, sd=sd), 1e-12)
        assert float(g.sum()) == pytest.approx(1.0)


@pytest.mark.parametrize("make", [
    lambda **kw: tsig.rndmask((8, 8), 0.5, **kw),
    lambda **kw: tsig.gaussian((5, 5), **kw),
    lambda **kw: tla.valid_adjoint(lambda u: u, lambda v: v, (4,), (4,),
                                   **kw)], ids=["rndmask", "gaussian",
                                                "valid_adjoint"])
def test_tensor_makers_default_to_the_card(make, monkeypatch):
    """The functions that make tensors from nothing run on the CUDA device
    unless the caller asks for the CPU: without a card they raise."""
    make(device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    with pytest.raises(RuntimeError):
        make(device="cuda")


def test_local_contrast_normalise_matches_jax():
    s = _img((30, 26))
    for n, c in ((7, None), (3, 0.2)):
        out = tsig.local_contrast_normalise(s, n=n, c=c)
        ref = jsig.local_contrast_normalise(jnp.asarray(s), n=n, c=c)
        for t, j in zip(out, ref):
            _close(t, j, 1e-12)
        scn, smn, snrm = out
        _close(scn * snrm + smn, s, 1e-12)


METRICS = {
    "mae": (2,), "mse": (2,), "snr": (2,), "psnr": (2,), "isnr": (3,),
    "bsnr": (2,), "pamse": (2,), "gmsd": (2,),
}


@pytest.mark.parametrize("dtype,rel", [(np.float64, 1e-12),
                                       (np.float32, 1e-5)])
@pytest.mark.parametrize("name", list(METRICS))
def test_metric_matches_jax(name, dtype, rel):
    """Each metric on a reference image and degraded copies; ``gmsd``
    runs in float32 in both packages (held to 1e-5)."""
    ref = _img((32, 28), seed=1, dtype=dtype)
    deg = _img((32, 28), seed=2, dtype=dtype)
    rst = (0.5 * ref + 0.5 * deg).astype(dtype)
    args = (ref, deg, rst)[:METRICS[name][0]]
    tv = getattr(tmet, name)(*args)
    jv = getattr(jmet, name)(*[jnp.asarray(a) for a in args])
    if name == "gmsd":
        rel = 1e-5
    _close(tv, jv, rel)
    assert isinstance(tv, torch.Tensor) and tv.ndim == 0


def test_psnr_range_and_gmsd_map_match_jax():
    ref, deg = _img((32, 28), seed=1), _img((32, 28), seed=2)
    _close(tmet.psnr(ref, deg, rng=2.0),
           jmet.psnr(jnp.asarray(ref), jnp.asarray(deg), rng=2.0), 1e-12)
    _close(tmet.pamse(ref, deg, rescale=False),
           jmet.pamse(jnp.asarray(ref), jnp.asarray(deg), rescale=False),
           1e-12)
    ts_, tmap = tmet.gmsd(ref, deg, rescale=False, returnMap=True)
    js_, jmap = jmet.gmsd(jnp.asarray(ref), jnp.asarray(deg),
                          rescale=False, returnMap=True)
    # the score is the spread of a map near 1 (5e-6 here): its float32
    # rounding is absolute, on the map's scale
    _close(tmap, jmap, 1e-5)
    assert abs(float(ts_) - float(js_)) <= 1e-5 * np.abs(jmap).max()
    _close(tmet.mse(torch.as_tensor(ref), torch.as_tensor(deg)),
           jmet.mse(jnp.asarray(ref), jnp.asarray(deg)), 1e-12)
