#!/usr/bin/env python3
"""Time builds of the port's planar FFT kernels against each other on one
CUDA card, in turns.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/fft_compare.py [--source NAME=PATH ...]
                                 [--variant NAME ...] [--rounds N]

The builds are ``sporco_tpu_torch/csrc/fft2_planar.cu`` as it stands
("change"), each ``--source`` (another version of that file with the same
C interface, e.g. the parent commit's, written out with ``git show``), and
each ``--variant``:
the current source with one design choice undone (see ``VARIANTS``).
Each is compiled with the port's nvcc flags into ``build/compare/<name>/``
and loaded through ctypes in place of the port's own library.  A round
times every build in order and then in reverse (parent, change, change,
parent), at the generic x-step's 64 planes of 512x512:

- ``rfft2_planar`` and ``irfft2_planar`` by CUDA events around 10 calls,
  and the inverse as the FFT dispatch calls it on a complex64 spectrum
  (``irfft2_spectrum``);
- the device time of each of their kernels per call (``torch.profiler``);
- ``torch.fft.rfft2``/``irfft2`` the same ways, and a device-to-device
  copy of the forward's input (the bytes of one pass) as the practical
  memory ceiling.

Prints the card's name and power limit, then one JSON line per build and
round.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (cuda_ms, device_ms_by_kernel,  # noqa: E402
                        nvidia_smi)
from sporco_tpu_torch.ops import _nvcc                  # noqa: E402
from sporco_tpu_torch.ops import fft2_planar as tfp     # noqa: E402

SRC = ROOT / "sporco_tpu_torch" / "csrc" / "fft2_planar.cu"
SHAPE = (64, 512, 512)
BATCH = 10
# one design choice of the current source undone: (text, replacement)
VARIANTS = {
    # the column pass's strips in ascending order (no L2 reuse of the
    # planes the row pass wrote last)
    "forward_order": [(
        "static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * CS + c;",
        "static_cast<int64_t>(blockIdx.x) * CS + c;")],
    # strips of 16 columns (64 bytes of a row) instead of 32
    "strips16": [("constexpr int CS = 32;", "constexpr int CS = 16;")],
    # 16 points per thread at N0 = 512 (16 x 16 x 2, two exchanges)
    "points16": [("static constexpr int R = L0 >= 9 ? 32 : 16;",
                  "static constexpr int R = 16;")],
    # the inverse's row pass in reverse block order (starting from the
    # planes the column pass wrote first)
    "rows_reverse": [(
        "row_twiddles<L, 1, 0>(twp, tw);\n"
        "  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * C::RB;",
        "row_twiddles<L, 1, 0>(twp, tw);\n"
        "  const int64_t row0 =\n"
        "      static_cast<int64_t>(gridDim.x - 1 - blockIdx.x) * C::RB;")],
}


def build(name, text):
    out_dir = ROOT / "build" / "compare" / name
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "fft2_planar.cu"
    src.write_text(text)
    lib = out_dir / "libfft2_planar.so"
    proc = subprocess.run([_nvcc.find_nvcc(), *_nvcc.NVCC_FLAGS, "-o",
                           str(lib), str(src)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    return name, lib


def load(path):
    lib = ctypes.CDLL(str(path))
    vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    lib.rfft2_planar_launch.argtypes = [vp] * 5 + [i64, i32, i32, vp]
    lib.rfft2_planar_launch.restype = ctypes.c_int
    lib.irfft2_planar_launch.argtypes = [vp] * 6 + [i64, i32, i32, vp]
    lib.irfft2_planar_launch.restype = ctypes.c_int
    lib.irfft2_spectrum_launch.argtypes = [vp] * 5 + [i64, i32, i32, vp]
    lib.irfft2_spectrum_launch.restype = ctypes.c_int
    return lib


def measure(name, lib, x, spec):
    tfp._lib = lambda: lib
    n1 = x.shape[-1]
    yr, yi = spec.real.contiguous(), spec.imag.contiguous()
    ref = torch.fft.rfft2(x.double())
    got_r, got_i = tfp.rfft2_planar(x)
    scale = float(ref.abs().max())
    err = max(float((got_r - ref.real).abs().max()),
              float((got_i - ref.imag).abs().max())) / scale
    fwd = lambda: tfp.rfft2_planar(x)                     # noqa: E731
    inv = lambda: tfp.irfft2_planar(yr, yi, n1)           # noqa: E731
    dispatch = lambda: tfp.irfft2_spectrum(spec, n1)      # noqa: E731
    xref = torch.fft.irfft2(spec.to(torch.complex128), s=SHAPE[-2:])
    return {"build": name, "forward_rel_err": err,
            "inverse_abs_err": float((inv() - xref).abs().max()),
            "dispatch_abs_err": float((dispatch() - xref).abs().max()),
            "rfft2_planar_ms": cuda_ms(fwd, batch=BATCH),
            "irfft2_planar_ms": cuda_ms(inv, batch=BATCH),
            "dispatch_ms": cuda_ms(dispatch, batch=BATCH),
            "rfft2_planar_kernels": device_ms_by_kernel(fwd),
            "irfft2_planar_kernels": device_ms_by_kernel(inv),
            "dispatch_kernels": device_ms_by_kernel(dispatch)}


def main(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--source", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--variant", action="append", default=[],
                    choices=sorted(VARIANTS))
    ap.add_argument("--rounds", type=int, default=1)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fft_compare: no CUDA device is available", file=sys.stderr)
        return 2
    current = SRC.read_text()
    texts = {}
    for item in args.source:
        name, path = item.split("=", 1)
        texts[name] = Path(path).read_text()
    texts["change"] = current
    for name in args.variant:
        text = current
        for old, new in VARIANTS[name]:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not found")
            text = text.replace(old, new)
        texts[name] = text
    with ThreadPoolExecutor(max(1, min(8, os.cpu_count() or 1))) as ex:
        libs = dict(ex.map(lambda kv: build(*kv), texts.items()))
    libs = {name: load(path) for name, path in libs.items()}
    print(nvidia_smi(), flush=True)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(SHAPE, generator=g, device=dev)
    spec = torch.fft.rfft2(x)
    y = torch.empty_like(x)
    order = list(libs)
    for rnd in range(args.rounds):
        for name in order + order[::-1]:
            row = measure(name, libs[name], x, spec)
            row["round"] = rnd
            print(json.dumps(row), flush=True)
        print(json.dumps({
            "round": rnd,
            "torch.fft.rfft2_ms": cuda_ms(lambda: torch.fft.rfft2(x),
                                          batch=BATCH),
            "torch.fft.irfft2_ms": cuda_ms(
                lambda: torch.fft.irfft2(spec, s=SHAPE[-2:]), batch=BATCH),
            "torch.fft.rfft2_kernels": device_ms_by_kernel(
                lambda: torch.fft.rfft2(x)),
            "copy_ms": cuda_ms(lambda: y.copy_(x), batch=BATCH),
            "copy_bytes": 2 * x.numel() * 4}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
