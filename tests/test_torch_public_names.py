"""The port's public names against the JAX package's.

Every name in the ``__all__`` of a module of ``sporco_tpu`` has a
counterpart of that name in the port's module of the same path, except
the deliberate gaps: ``ops/mxufft.py`` and ``ops.fft.use_mxu_fft`` (the
port keeps float32 ``torch.fft``), the Pallas modules (their kernels are
ported under their own names, ``sporco_tpu_torch/csrc/``) and the JAX
sharding types of ``parallel/mesh.py`` (the port's ``DeviceMesh`` takes
their place).  The names that were added last (the ``cnvrep`` axes, the
``ops.fft`` real/complex dispatch, ``ops.linalg.zdivide``,
``utils.signal.complex_randn``, ``models.common.device_sync``) are held
against the JAX package's on the same inputs where they are functions.
"""

import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sporco_tpu

torch.set_num_threads(2)

# the JAX package's modules, by path (a fixed list: the same in every
# worker)
MODULES = sorted(
    "sporco_tpu." + ".".join(p.with_suffix("").parts).replace(
        ".__init__", "")
    for p in (q.relative_to(Path(sporco_tpu.__file__).parent)
              for q in Path(sporco_tpu.__file__).parent.rglob("*.py"))
    if p.name != "__init__.py")
# modules with no counterpart, and names with none in a module that has
GAP_MODULES = {"sporco_tpu.ops.mxufft", "sporco_tpu.ops.pallas_csc_iter",
               "sporco_tpu.ops.pallas_csc_tail", "sporco_tpu.ops.pallas_fft"}
GAP_NAMES = {"sporco_tpu.ops.fft": {"use_mxu_fft"},
             "sporco_tpu.parallel.mesh": {"Mesh", "NamedSharding",
                                          "PartitionSpec", "data_sharding",
                                          "replicated"}}


def _port_name(name):
    return name.replace("sporco_tpu", "sporco_tpu_torch", 1)


@pytest.mark.parametrize("module", MODULES)
def test_every_public_name_has_a_counterpart(module):
    """The module's ``__all__`` names exist in the port's module, and are
    in its ``__all__``, but the listed gaps; a gap module has no
    counterpart."""
    jm = importlib.import_module(module)
    if module in GAP_MODULES:
        with pytest.raises(ModuleNotFoundError):
            importlib.import_module(_port_name(module))
        return
    tm = importlib.import_module(_port_name(module))
    gaps = GAP_NAMES.get(module, set())
    names = set(getattr(jm, "__all__", ()))
    assert gaps <= names
    port_all = set(getattr(tm, "__all__", ()))
    missing = sorted(n for n in names - gaps
                     if not hasattr(tm, n) or n not in port_all)
    assert not missing, f"{_port_name(module)} lacks {missing}"


def test_gap_modules_are_the_packages_own():
    """Every listed gap is a module of the JAX package."""
    assert GAP_MODULES <= set(MODULES)
    assert set(GAP_NAMES) <= set(MODULES)


def test_cnvrep_axes():
    from sporco_tpu import cnvrep as jc
    from sporco_tpu_torch import cnvrep as tc
    assert (tc.AXIS_K, tc.AXIS_C, tc.AXIS_M) == (jc.AXIS_K, jc.AXIS_C,
                                                 jc.AXIS_M) == (0, 1, 2)


@pytest.mark.parametrize("dtype", ["float32", "float64", "complex64",
                                   "complex128", "int32"])
def test_is_complex_dtype(dtype):
    """On a dtype's name, its numpy dtype and (port) its torch dtype."""
    from sporco_tpu.ops import fft as jf
    from sporco_tpu_torch.ops import fft as tf
    want = jf.is_complex_dtype(dtype)
    assert want == jf.is_complex_dtype(np.dtype(dtype))
    assert tf.is_complex_dtype(dtype) is want
    assert tf.is_complex_dtype(np.dtype(dtype)) is want
    assert tf.is_complex_dtype(getattr(torch, dtype)) is want


@pytest.mark.parametrize("real", [True, False], ids=["real", "complex"])
def test_transform_family_matches_jax(real):
    """``fftn_func``, ``ifftn_func`` and ``fl2norm2_func`` of either
    family against the JAX package's on the same 12 x 10 x 3 array
    (transformed over its first two axes), float64."""
    from sporco_tpu.ops import fft as jf
    from sporco_tpu_torch.ops import fft as tf
    rng = np.random.default_rng(0)
    x = rng.standard_normal((12, 10, 3))
    if not real:
        x = x + 1j * rng.standard_normal((12, 10, 3))
    s, axes = (12, 10), (0, 1)
    tx, jx = torch.tensor(x), jnp.asarray(x)
    tfx = tf.fftn_func(real)(tx, None, axes)
    jfx = jf.fftn_func(real)(jx, None, axes)
    np.testing.assert_allclose(tfx.numpy(), np.asarray(jfx), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(tf.ifftn_func(real)(tfx, s, axes).numpy(),
                               np.asarray(jf.ifftn_func(real)(jfx, s, axes)),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(tf.ifftn_func(real)(tfx, s, axes).numpy(), x,
                               rtol=1e-12, atol=1e-12)
    tn = tf.fl2norm2_func(real)(tfx, s, axes)
    jn = jf.fl2norm2_func(real)(jfx, s, axes)
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-12)
    np.testing.assert_allclose(float(tn), float(np.sum(np.abs(x) ** 2)),
                               rtol=1e-12)


def test_empty_aligned_func():
    """Alignment means nothing in either package: ``torch.empty`` for
    both families, as the JAX package gives ``jnp.empty``."""
    from sporco_tpu.ops import fft as jf
    from sporco_tpu_torch.ops import fft as tf
    for real in (True, False):
        assert tf.empty_aligned_func(real) is torch.empty
        assert jf.empty_aligned_func(real) is jnp.empty
    t = tf.empty_aligned_func(False)((3, 4), dtype=torch.complex64)
    assert t.shape == (3, 4) and t.dtype == torch.complex64


@pytest.mark.parametrize("dtype", ["float64", "complex128"])
def test_linalg_zdivide_is_the_prox_one(dtype):
    """``ops.linalg.zdivide`` is ``ops.prox.zdivide`` re-exported, as in
    the JAX package, and gives its values: 0 where the denominator is
    0."""
    from sporco_tpu.ops import linalg as jla
    from sporco_tpu_torch.ops import linalg as tla
    from sporco_tpu_torch.ops import prox as tpx
    assert tla.zdivide is tpx.zdivide
    rng = np.random.default_rng(1)
    a = rng.standard_normal((5, 6)).astype(dtype)
    b = rng.standard_normal((5, 6)).astype(dtype)
    b[1, 2] = b[3, 0] = 0.0
    got = tla.zdivide(torch.tensor(a), torch.tensor(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jla.zdivide(a, b)),
                               rtol=1e-15)
    assert got[1, 2] == 0 and got[3, 0] == 0


def test_complex_randn_draws():
    """``complex_randn(generator, *shape)``: of ``shape``, complex in
    torch's default float type (complex64), the same numbers from the
    same seed, standard normal real and imaginary parts; the JAX
    package's draws (from a key, other numbers, in JAX's default float
    type) have the same moments (each part's mean within 0.01 of 0 and
    variance within 0.02 of 1 over 2 x 10^5 samples)."""
    from sporco_tpu.utils import signal as js
    from sporco_tpu_torch.utils import signal as ts
    a = ts.complex_randn(torch.Generator().manual_seed(3), 400, 500)
    b = ts.complex_randn(torch.Generator().manual_seed(3), 400, 500)
    c = ts.complex_randn(torch.Generator().manual_seed(4), 400, 500)
    assert a.shape == (400, 500) and a.dtype == torch.complex64
    assert torch.equal(a, b) and not torch.equal(a, c)
    j = np.asarray(js.complex_randn(jax.random.PRNGKey(3), 400, 500))
    assert j.shape == (400, 500) and j.dtype == (
        np.complex128 if jax.config.jax_enable_x64 else np.complex64)
    for z in (a.numpy(), j):
        for part in (z.real, z.imag):
            assert abs(float(part.mean())) < 0.01
            assert abs(float(part.var()) - 1.0) < 0.02
        assert abs(float(np.mean(z.real * z.imag))) < 0.01


def test_device_sync_walks_the_state(monkeypatch):
    """``device_sync`` of a model's state, and of nested dicts, lists and
    tuples of tensors: the CUDA devices among them synchronised, none for
    CPU tensors (the card's case is in ``tests/test_torch_cuda.py``)."""
    from sporco_tpu.models import common as jcm
    from sporco_tpu_torch.models import common as tcm
    from sporco_tpu_torch.models import rpca as trpca
    called = []
    monkeypatch.setattr(torch.cuda, "synchronize", called.append)
    rng = np.random.default_rng(2)
    b = trpca.RobustPCA(rng.standard_normal((8, 6)), device="cpu",
                        opt=trpca.RobustPCA.options(max_iter=2))
    b.solve()
    assert tcm.device_sync(b.state) is None
    assert tcm.device_sync({"a": [torch.zeros(2), (torch.ones(()),)],
                            "b": 3}) is None
    assert tcm.device_sync([]) is None
    assert called == []
    assert callable(jcm.device_sync)
