#!/usr/bin/env python3
"""Hold the packed-state kernels and the FFT pair of this checkout
against another checkout's, bit for bit, on one CUDA card.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/kernel_bits_compare.py --other DIR

``DIR`` is the root of another checkout (e.g. the parent commit unpacked
with ``git archive`` under ``build/``).  Each tree runs in a process of
its own, with its own package on ``PYTHONPATH`` and its own build
directory (``$SPORCO_TPU_TORCH_BUILD_DIR`` under ``build/bits/``), and
launches ``csc_iter`` (with and without PX, and without the forward
pair), ``pgm_iter`` and ``admm_tail`` in their default forms, through
the wrappers' common arguments, on the same inputs drawn from seeded
CUDA generators: the headline packed geometry (4096, 4096, 256) and a
ragged one (129, 131, 7); and ``rfft2_planar``, ``irfft2_planar`` and
``irfft2_spectrum`` at 64 planes of 512 x 512 (the gradreg x-step's) and
3 planes of 256 x 126 (the direct row DFT).  Prints one JSON line per launch with whether
each output equals the other tree's bit for bit, then the card's name
and power limit; exits 1 if any output differs.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMS = [(4096, 4096, 256), (129, 131, 7)]
FFT_GEOMS = [(64, 512, 512), (3, 256, 126)]


def _inputs(pos, C, T, seed):
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")
    sparse = randn(pos, C) * (torch.rand((pos, C), generator=g,
                                         device="cuda") < 0.05)
    return {"G2": 0.1 * randn(pos, T), "Y": sparse,
            "U": 0.01 * randn(pos, C), "Wa": 0.1 * randn(T, C),
            "Wf": 0.1 * randn(C, T)}


def run_tree(out):
    """In the child: every launch of this tree's package, saved to
    ``out``."""
    import torch
    from sporco_tpu_torch.ops import csc_iter as tci
    from sporco_tpu_torch.ops import csc_tail as tct
    from sporco_tpu_torch.ops import fft2_planar as tfp
    from sporco_tpu_torch.ops import pgm_iter as tpi
    res = {}
    for gi, (pos, C, T) in enumerate(GEOMS):
        a = _inputs(pos, C, T, 11 + gi)
        wf3 = tci.split_weight(a["Wf"])
        for emit_px, emit_fwd in ((True, True), (False, True),
                                  (False, False)):
            o = tci.csc_iter(a["G2"], a["Y"].clone(), a["U"].clone(),
                             a["Wa"], a["Wf"], 0.0143, 1.0, 1.8, 0.9, 1.0,
                             emit_px=emit_px, wf_split=wf3,
                             emit_fwd=emit_fwd)
            res[f"csc_iter {pos}x{C}x{T} px={emit_px} fwd={emit_fwd}"] = \
                [t for t in o if t is not None]
        o = tpi.pgm_iter(a["G2"], a["Y"].clone(), a["U"].clone(), a["Wa"],
                         a["Wf"], 5e-4, 1.0, 0.01, 0.7, wf_split=wf3)
        res[f"pgm_iter {pos}x{C}x{T}"] = list(o)
        o = tct.admm_tail(a["Y"] + a["U"], a["Y"].clone(), a["U"].clone(),
                          0.0143, 1.0, 1.8, us=0.9)
        res[f"admm_tail {pos}x{C}"] = list(o)
    g = torch.Generator(device="cuda").manual_seed(21)
    for b, n0, n1 in FFT_GEOMS:
        x = torch.randn((b, n0, n1), generator=g, device="cuda")
        yr, yi = tfp.rfft2_planar(x)
        res[f"rfft2_planar {b}x{n0}x{n1}"] = [yr, yi]
        res[f"irfft2_planar {b}x{n0}x{n1}"] = [tfp.irfft2_planar(yr, yi, n1)]
        res[f"irfft2_spectrum {b}x{n0}x{n1}"] = [
            tfp.irfft2_spectrum(torch.complex(yr, yi), n1)]
    torch.cuda.synchronize()
    torch.save({k: [t.cpu() for t in v] for k, v in res.items()}, out)


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", required=True)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        run_tree(args.child)
        return 0
    import torch
    work = os.path.join(ROOT, "build", "bits")
    outs = {}
    for name, tree in (("this", ROOT), ("other", os.path.abspath(
            args.other))):
        env = dict(os.environ, PYTHONPATH=tree,
                   SPORCO_TPU_TORCH_BUILD_DIR=os.path.join(work, name))
        outs[name] = os.path.join(work, f"{name}.pt")
        os.makedirs(os.path.join(work, name), exist_ok=True)
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--other", tree, "--child", outs[name]], env=env,
                       check=True)
    this, other = (torch.load(outs[n]) for n in ("this", "other"))
    differ = False
    for key in this:
        same = [torch.equal(a, b) for a, b in zip(this[key], other[key])]
        differ |= not all(same)
        print(json.dumps({"launch": key, "outputs_bit_for_bit": same}),
              flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
