"""The rest of the port's ``utils`` (``array``, ``interp``, ``util``,
``timer.ContextTimer``, ``plot``) against the JAX package's on the same
seeded numpy inputs."""

import collections
import time

import numpy as np
import pytest
import torch

from sporco_tpu_torch.utils import array as ta
from sporco_tpu_torch.utils import interp as ti
from sporco_tpu_torch.utils import timer as tt
from sporco_tpu_torch.utils import util as tu


def _j(name):
    import importlib
    return importlib.import_module(f"sporco_tpu.utils.{name}")


def _eq(t, a, tol=0.0):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    a = np.asarray(a)
    assert t.shape == a.shape
    if tol == 0.0:
        np.testing.assert_array_equal(t, a)
    else:
        np.testing.assert_allclose(t, a, rtol=tol, atol=tol)


RNG = np.random.default_rng(21)
IMG = RNG.standard_normal((12, 10))
IMG3 = RNG.standard_normal((12, 10, 3))


def test_atleast_nd_split_subsample():
    ja = _j("array")
    x = RNG.standard_normal((4, 3))
    _eq(ta.atleast_nd(4, x), ja.atleast_nd(4, x))
    _eq(ta.atleast_nd(1, x), ja.atleast_nd(1, x))
    for ax in (0, 1):
        for t, a in zip(ta.split(x, ax), ja.split(x, ax)):
            _eq(t, a)
    _eq(ta.subsample_array(IMG, (2, 3)), ja.subsample_array(IMG, (2, 3)))
    _eq(ta.subsample_array(IMG, 2), ja.subsample_array(IMG, 2))


def test_promote16_matches_jax():
    ja = _j("array")
    x = RNG.standard_normal((5,)).astype(np.float16)
    t = ta.promote16(x)
    assert t.dtype == torch.float32
    _eq(t, ja.promote16(x))
    r = ta.promote16(x, lambda v: v * 2)
    assert r.dtype == torch.float16
    _eq(r, ja.promote16(x, lambda v: v * 2))
    p = ta.promote16(x, lambda v: (v + 1, v - 1))
    assert all(v.dtype == torch.float16 for v in p)
    y = RNG.standard_normal((3,))
    assert ta.promote16(y).dtype == torch.float64


@pytest.mark.parametrize("wnd,hop", [(3, None), ((3, 4), None),
                                     ((3, 4), (2, 3)), (5, 2)])
def test_rolling_window_matches_jax(wnd, hop):
    ja = _j("array")
    for x in (IMG, IMG3):
        _eq(ta.rolling_window(x, wnd, hop), ja.rolling_window(x, wnd, hop))


@pytest.mark.parametrize("stp", [None, (2, 3)])
def test_blocks_match_jax(stp):
    """``extract_blocks``, ``average_blocks`` and ``combine_blocks``
    (sum, mean, another reduction taken as the mean) on a grey and a
    colour image."""
    import jax.numpy as jnp
    ja = _j("array")
    for x in (IMG, IMG3):
        b = ta.extract_blocks(x, (4, 3), stp)
        jb = ja.extract_blocks(x, (4, 3), stp)
        _eq(b, jb)
        sz = x.shape[:2]
        _eq(ta.average_blocks(b, sz, stp), ja.average_blocks(jb, sz, stp),
            1e-12)
        _eq(ta.combine_blocks(b, sz, stp, fn=torch.sum),
            ja.combine_blocks(jb, sz, stp, fn=jnp.sum), 1e-12)
        _eq(ta.combine_blocks(b, sz, stp),
            ja.combine_blocks(jb, sz, stp), 1e-12)
        _eq(ta.combine_blocks(b, sz, stp, fn=torch.median),
            ja.combine_blocks(jb, sz, stp, fn=jnp.median), 1e-12)


def test_zdivide_and_transpose_ntpl():
    ja = _j("array")
    a = np.array([1.0, 2.0, 0.0])
    b = np.array([2.0, 0.0, 0.0])
    _eq(ta.zdivide(torch.as_tensor(a), torch.as_tensor(b)),
        ja.zdivide(a, b))
    T = collections.namedtuple("T", ["a", "b"])
    lst = [T(1, 2.0), T(3, 4.0)]
    r, j = ta.transpose_ntpl(lst), ja.transpose_ntpl(lst)
    _eq(r.a, j.a)
    _eq(r.b, j.b)
    assert ta.transpose_ntpl([]) is None
    assert ta.transpose_ntpl_list is ta.transpose_ntpl


def test_bilinear_demosaic_matches_jax():
    ji = _j("interp")
    img = RNG.random((16, 12))
    _eq(ti.bilinear_demosaic(torch.as_tensor(img)),
        ji.bilinear_demosaic(img))


def test_regressions_match_jax():
    """The LP regressions on the host; the IRLS one on tensors, within
    1e-8 of the JAX result."""
    ji = _j("interp")
    A = RNG.standard_normal((30, 3))
    b = A @ np.array([1.0, -2.0, 0.5]) + 0.1 * RNG.standard_normal(30)
    b[::7] += 5.0
    _eq(ti.lstabsdev(A, b), ji.lstabsdev(A, b))
    _eq(ti.lstmaxdev(torch.as_tensor(A), b), ji.lstmaxdev(A, b))
    _eq(ti.lstabsdev_irls(torch.as_tensor(A), torch.as_tensor(b)),
        ji.lstabsdev_irls(A, b), 1e-8)


@pytest.mark.parametrize("sz,collapse", [(4, True), ((3, 5), True),
                                         ((3, 5), False),
                                         ((np.array([0.0, 0.25]),), True)])
def test_lanczos_matches_jax(sz, collapse):
    ji = _j("interp")
    x = np.linspace(-4, 4, 33)
    _eq(ti.lanczos_kernel(torch.as_tensor(x)), ji.lanczos_kernel(x), 1e-15)
    _eq(ti.lanczos_kernel(torch.as_tensor(x), a=2),
        ji.lanczos_kernel(x, a=2), 1e-15)
    _eq(ti.lanczos_filters(sz, collapse_axes=collapse),
        ji.lanczos_filters(sz, collapse_axes=collapse), 1e-14)


def test_tiledict_matches_jax():
    ju = _j("util")
    for D in (RNG.standard_normal((6, 6, 7)),
              RNG.standard_normal((5, 5, 3, 4))):
        _eq(tu.tiledict(torch.as_tensor(D)), ju.tiledict(D))
    Dm = RNG.standard_normal((16, 5))
    _eq(tu.tiledict(Dm, (4, 4)), ju.tiledict(Dm, (4, 4)))
    D = RNG.standard_normal((6, 6, 5))
    sz = ((6, 6, 2), (4, 4, 3))
    _eq(tu.tiledict(D, sz), ju.tiledict(D, sz))


def test_data_access_matches_jax(tmp_path):
    """``convdicts`` and ``ExampleImages`` read the repository's data
    pack, by path, and give the JAX package's arrays; an empty directory
    gives both packages' synthetic images."""
    ju = _j("util")
    a, b = tu.convdicts(), ju.convdicts()
    assert sorted(a) == sorted(b)
    for k in a:
        _eq(a[k], b[k])
    e, je = tu.ExampleImages(), ju.ExampleImages()
    assert e.images() == je.images()
    name = e.images()[0]
    for kw in ({}, {"scaled": True, "gray": True},
               {"scaled": True, "zoom": 0.5, "idxexp": np.s_[10:50, 20:60]},
               {"dtype": np.float32, "scaled": True}):
        _eq(e.image(name, **kw), je.image(name, **kw))
    emp = str(tmp_path)
    e0, je0 = tu.ExampleImages(pth=emp), ju.ExampleImages(pth=emp)
    assert e0.images() == je0.images() == []
    _eq(e0.image("synthetic01.png", scaled=True),
        je0.image("synthetic01.png", scaled=True))


def test_cpu_count_and_netgetdata(tmp_path):
    """``idle_cpu_count`` is at least ``mincpu``; ``netgetdata`` reads a
    ``file://`` URL and raises on one that fails (no network used)."""
    import urllib.error
    assert tu.idle_cpu_count() >= 1
    assert tu.idle_cpu_count(mincpu=10 ** 6) == 10 ** 6
    p = tmp_path / "blob.bin"
    p.write_bytes(b"sporco")
    assert tu.netgetdata("file://" + str(p)).read() == b"sporco"
    with pytest.raises(urllib.error.URLError):
        tu.netgetdata("file://" + str(tmp_path / "missing.bin"))
    with pytest.raises(ValueError, match="maxtry"):
        tu.netgetdata("file://" + str(p), maxtry=0)
    assert tu.Timer is tt.Timer and tu.ContextTimer is tt.ContextTimer
    from sporco_tpu_torch.parallel.gridsearch import grid_search
    assert tu.grid_search is grid_search


def test_context_timer_as_jax():
    """``ContextTimer`` starts and stops the labelled timer around the
    block (``StartStop``) or stops and restarts it (``StopStart``), with
    the JAX package's labels and errors."""
    jt = _j("timer")
    for mod in (tt, jt):
        t = mod.Timer(["a", "b"])
        with mod.ContextTimer(t, "a"):
            time.sleep(0.002)
        assert t.elapsed("a") > 0.0 and t.elapsed("b") == 0.0
        t.start("b")
        with mod.ContextTimer(t, "b", action="StopStart"):
            inside = t.elapsed("b")
            assert t.t0["b"] is None
        assert t.t0["b"] is not None and t.elapsed("b") >= inside
        c = mod.ContextTimer()
        assert c.label == "main"
        with c:
            time.sleep(0.002)
        assert c.elapsed() > 0.0
        with pytest.raises(ValueError):
            mod.ContextTimer(t, "a", action="Other")


def test_plot_under_agg():
    """The plotting wrappers draw tensors under the Agg backend; the
    module imports without matplotlib (checked by the card's machine,
    which has none)."""
    pytest.importorskip("matplotlib")
    import matplotlib
    matplotlib.use("Agg")
    from sporco_tpu_torch.utils import plot as tp
    y = torch.linspace(0, 1, 10)
    fig, ax = tp.plot(y, x=torch.arange(10), title="t", xlbl="x",
                      ylbl="y", lgnd=["a"])
    assert len(ax.lines) == 1
    np.testing.assert_array_equal(ax.lines[0].get_ydata(), y.numpy())
    z = torch.as_tensor(RNG.standard_normal((8, 9)))
    tp.surf(z, title="s")
    tp.contour(z, title="c")
    fig, ax = tp.imview(z, fltscl=True, cbar=True, title="i")
    assert ax.get_images()[0].get_array().shape == (8, 9)
    tp.close()
    tp.close(fig)


def test_plot_without_matplotlib(monkeypatch):
    """Where matplotlib is not installed (the card's machine), the module
    still imports and a plotting call raises ImportError."""
    import importlib
    import sys
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, "sporco_tpu_torch.utils.plot",
                        raising=False)
    tp = importlib.import_module("sporco_tpu_torch.utils.plot")
    with pytest.raises(ImportError):
        tp.plot(torch.zeros(3))
