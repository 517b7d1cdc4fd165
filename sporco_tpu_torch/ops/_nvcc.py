"""Build the port's CUDA sources with ``nvcc`` into shared libraries
with a plain C interface, loaded through ``ctypes``.

Each source ``sporco_tpu_torch/csrc/<name>.cu`` is compiled on first use
by one ``nvcc`` call for ``sm_90a`` into ``build/kernels/`` at the root
of the checkout, named by a hash of the source, the shared headers
(``csrc/*.cuh``) and the flags, so an unchanged source is never
rebuilt.  A missing ``nvcc`` or a failed
build raises with the compiler's output; there is no fallback.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

__all__ = ["load", "build", "find_nvcc", "BUILD_INFO", "KERNELS"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
DEFAULT_NVCC = "/usr/local/cuda/bin/nvcc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# every source of csrc/ that holds kernels, as build() takes them
KERNELS = ("csc_iter", "pgm_iter", "fft2_planar", "csc_tail")

_LIBS = {}
# name -> {"path", "cached", "seconds", "log"} for every loaded library
BUILD_INFO = {}


def find_nvcc():
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default location; None if there is none."""
    home = os.environ.get("CUDA_HOME")
    for cand in ((home and os.path.join(home, "bin", "nvcc")),
                 shutil.which("nvcc"), DEFAULT_NVCC):
        if cand and os.path.isfile(cand):
            return cand
    return None


def _target(name):
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode() + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names):
    """Compile every source of ``names`` that has no current library,
    one ``nvcc`` process per source, all started together."""
    todo = []
    for name in names:
        src, out = _target(name)
        if out.exists():
            BUILD_INFO.setdefault(name, {"path": str(out), "cached": True,
                                         "seconds": 0.0, "log": ""})
        else:
            todo.append((name, src, out))
    if not todo:
        return
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "cannot build " + ", ".join(s.name for _, s, _ in todo)
            + ": nvcc was not found (set CUDA_HOME or put nvcc on PATH)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for name, src, out in todo:
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((name, src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)))
    errors = []
    for name, src, out, tmp, proc in procs:
        stdout, stderr = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            errors.append(f"nvcc failed to build {src.name} "
                          f"(exit {proc.returncode}):\n{stderr}{stdout}")
            continue
        os.replace(tmp, out)
        BUILD_INFO[name] = {"path": str(out), "cached": False,
                            "seconds": seconds, "log": stderr + stdout}
        print(f"built {out.name} with nvcc in {seconds:.1f} s",
              file=sys.stderr)
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name):
    """The ``ctypes`` library of source ``name``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)[1]))
        _LIBS[name] = lib
    return lib
