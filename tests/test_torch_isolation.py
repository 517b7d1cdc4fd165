"""The port stands alone: ``sporco_tpu_torch`` and ``chip_smoke.py``
import neither JAX nor the JAX package, the kernel build never falls
back, and ``chip_smoke.py`` fails without a CUDA device."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest
import torch

from sporco_tpu_torch.ops import _nvcc
from sporco_tpu_torch.ops import csc_iter as tci
from sporco_tpu_torch.ops import csc_tail as tct
from sporco_tpu_torch.ops import fft2_planar as tfp
from sporco_tpu_torch.ops import pgm_iter as tpi

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "sporco_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _forbidden(mod):
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "sporco_tpu")


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    return env


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path.name}:{node.lineno} imports {bad}"


def test_importing_everything_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import sporco_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages("
        "sporco_tpu_torch.__path__, 'sporco_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'sporco_tpu')]\n"
        "print(len(mods), bad)\n"
        "sys.exit(1 if bad or len(mods) < 10 else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_nvcc, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_nvcc, "DEFAULT_NVCC", str(tmp_path / "nvcc"))
    monkeypatch.setattr(_nvcc, "_LIBS", {})
    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.delenv("CUDA_HOME", raising=False)
    assert _nvcc.find_nvcc() is None
    with pytest.raises(RuntimeError, match="nvcc was not found"):
        _nvcc.load("csc_iter")
    assert not (tmp_path / "kernels").exists()


def test_failed_build_raises_with_compiler_output(monkeypatch, tmp_path):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'error: no sm_90a here' >&2\n"
                    "exit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_nvcc, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_nvcc, "_LIBS", {})
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(shutil, "which", lambda name: str(fake))
    with pytest.raises(RuntimeError, match="no sm_90a here"):
        _nvcc.load("csc_iter")
    assert list((tmp_path / "kernels").iterdir()) == []


def test_build_flags_target_sm90a():
    flags = " ".join(_nvcc.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-O3" in flags
    assert "fast_math" not in flags and "fast-math" not in flags
    # the sources include nothing of PyTorch: the CUDA runtime, and the
    # tile header shared by the kernels
    hdr = (PKG / "csrc" / "csc_tiles.cuh").read_text()
    assert _includes(hdr) == ["<cuda_runtime.h>", "<stdint.h>"]
    assert "atomicAdd" not in hdr
    for name in ("csc_iter", "pgm_iter"):
        src = (PKG / "csrc" / f"{name}.cu").read_text()
        assert _includes(src) == ['"csc_tiles.cuh"'], name
        assert 'extern "C"' in src and "cudaGetLastError" in src, name
        assert f"{name}_launch" in src and "atomicAdd" not in src, name
    # the FFT kernels stand alone: the CUDA runtime only, twiddles from
    # the host's float64 tables (no fast-math or single-precision sin/cos)
    src = (PKG / "csrc" / "fft2_planar.cu").read_text()
    assert _includes(src) == ["<cuda_runtime.h>", "<stdint.h>"]
    assert 'extern "C"' in src and "cudaGetLastError" in src
    for name in ("rfft2_planar_launch", "irfft2_planar_launch"):
        assert name in src
    for bad in ("atomicAdd", "__sinf", "__cosf", "sinf(", "cosf(",
                "__sincosf", "sincosf("):
        assert bad not in src, bad
    # the tail kernel stands alone too, and its sums take no atomics
    src = (PKG / "csrc" / "csc_tail.cu").read_text()
    assert _includes(src) == ["<cuda_runtime.h>", "<stdint.h>"]
    assert 'extern "C"' in src and "cudaGetLastError" in src
    assert "csc_tail_launch" in src
    assert "atomicAdd" not in src and "atomicCAS" not in src
    # every kernel source is in the list the build phase compiles
    assert sorted(_nvcc.KERNELS) == sorted(
        p.stem for p in (PKG / "csrc").glob("*.cu"))


def _includes(src):
    return [ln.split()[1] for ln in src.splitlines()
            if ln.startswith("#include")]


def test_build_hash_covers_shared_header(monkeypatch, tmp_path):
    """A change to the shared tile header gives every kernel a new
    library name, so a stale build is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for f in (PKG / "csrc").iterdir():
        (csrc / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(_nvcc, "CSRC", csrc)
    before = [_nvcc._target(n)[1] for n in _nvcc.KERNELS]
    with open(csrc / "csc_tiles.cuh", "a") as f:
        f.write("// changed\n")
    after = [_nvcc._target(n)[1] for n in _nvcc.KERNELS]
    assert all(a != b for a, b in zip(before, after))
    # and a change to one source renames its library only
    with open(csrc / "fft2_planar.cu", "a") as f:
        f.write("// changed\n")
    again = [_nvcc._target(n)[1] for n in _nvcc.KERNELS]
    assert [a == b for a, b in zip(after, again)] == [
        n != "fft2_planar" for n in _nvcc.KERNELS]


def test_non_cpu_tensors_never_take_the_plain_version():
    m = torch.empty((8, 8), device="meta")
    tci.reset_launches()
    tpi.reset_launches()
    tct.reset_launches()
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tci.csc_iter(m, m, m, m, m, 0.1, 1.0, 1.8, 1.0, 1.0)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tpi.pgm_iter(m, m, m, m, m, 0.1, 1.0, 0.01, 0.5)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tct.admm_tail(m, m, m, 0.1, 1.0, 1.8)
    assert tci.LAUNCHES["csc_iter"] == 0
    assert tpi.LAUNCHES["pgm_iter"] == 0
    assert tct.LAUNCHES["admm_tail"] == 0
    mx = torch.empty((2, 128, 32), device="meta")
    my = torch.empty((2, 128, 17), device="meta")
    tfp.reset_launches()
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tfp.rfft2_planar(mx)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tfp.irfft2_planar(my, my, 32)
    assert tfp.LAUNCHES == {"rfft2_planar": 0, "irfft2_planar": 0}


def test_cuda_tensors_never_take_the_plain_fft(monkeypatch):
    """The FFT wrappers send a CUDA tensor to the kernel: with the plain
    versions made to fail and the build made to fail, a tensor that
    reports a CUDA device reaches the build (which raises) and never the
    plain version."""
    def boom(*a, **k):
        raise AssertionError("plain version taken")

    def no_build(name):
        raise RuntimeError(f"cannot build {name}")
    x = torch.zeros(2, 128, 32)
    y = torch.zeros(2, 128, 17)
    monkeypatch.setattr(tfp, "rfft2_planar_plain", boom)
    monkeypatch.setattr(tfp, "irfft2_planar_plain", boom)
    monkeypatch.setattr(tfp, "_device_of",
                        lambda name, *ts: torch.device("cuda", 0))
    monkeypatch.setattr(_nvcc, "load", no_build)
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d: _Null(cuda_stream=0))
    tfp.reset_launches()
    with pytest.raises(RuntimeError, match="cannot build fft2_planar"):
        tfp.rfft2_planar(x)
    with pytest.raises(RuntimeError, match="cannot build fft2_planar"):
        tfp.irfft2_planar(y, y, 32)
    assert tfp.LAUNCHES == {"rfft2_planar": 0, "irfft2_planar": 0}


class _Null:
    def __init__(self, **kw):
        self.__dict__.update(kw)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_cuda(alone, tmp_path):
    """Without a CUDA device (as here), and in a directory holding
    chip_smoke.py and nothing else of the repo, the script exits
    non-zero and prints no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cwd = ROOT
    env = dict(os.environ)
    if alone:
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
        env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "{" not in out.stdout
    if alone:
        assert "sporco_tpu_torch" in out.stderr


def test_build_dir_from_environment(monkeypatch, tmp_path):
    """The build directory is $SPORCO_TPU_TORCH_BUILD_DIR where set, else
    build/kernels/ in the checkout; resolving it builds nothing."""
    monkeypatch.delenv(_nvcc.BUILD_DIR_ENV, raising=False)
    assert _nvcc.build_dir() == ROOT / "build" / "kernels"
    monkeypatch.setenv(_nvcc.BUILD_DIR_ENV, "")
    assert _nvcc.build_dir() == ROOT / "build" / "kernels"
    target = tmp_path / "elsewhere" / "kernels"
    monkeypatch.setenv(_nvcc.BUILD_DIR_ENV, str(target))
    assert _nvcc.build_dir() == target
    # a fresh import takes it as its BUILD_DIR, and the libraries' paths
    # lie there
    code = ("from sporco_tpu_torch.ops import _nvcc\n"
            "print(_nvcc.BUILD_DIR)\n"
            "print(_nvcc._target('csc_iter')[1].parent)\n")
    env = _env()
    env[_nvcc.BUILD_DIR_ENV] = str(target)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(target)] * 2
    assert not target.exists()


def test_dictionary_learning_modules_are_covered():
    rel = {str(p.relative_to(ROOT)) for p in SOURCES}
    for path in ("sporco_tpu_torch/models/ccmod.py",
                 "sporco_tpu_torch/models/dictlrn.py",
                 "sporco_tpu_torch/parallel/__init__.py",
                 "sporco_tpu_torch/parallel/consensus.py"):
        assert path in rel


def test_dictionary_learning_entry_points_need_a_card(monkeypatch):
    """Without a CUDA device the entry points raise unless the caller
    asks for the CPU; they never fall back to it."""
    import numpy as np
    from sporco_tpu_torch.models import ccmod, dictlrn
    from sporco_tpu_torch.parallel import consensus
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    D0 = rng.standard_normal((4, 4, 3))
    S = rng.standard_normal((16, 16, 2))
    Z = np.zeros((16, 16, 1, 2, 3))
    makers = (
        lambda **kw: ccmod.ConvCnstrMOD(Z, S, D0.shape, **kw),
        lambda **kw: dictlrn.ConvBPDNDictLearn(D0, S, 0.1, **kw),
        lambda **kw: consensus.ConvBPDNDictLearn_Consensus(D0, S, 0.1,
                                                           **kw),
        lambda **kw: consensus.ConvBPDNMaskDcplDictLearn_Consensus(
            D0, S, 0.1, **kw))
    for make in makers:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
        assert make(device="cpu") is not None
