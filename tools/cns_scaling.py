#!/usr/bin/env python3
"""Scaling of the sharded consensus dictionary learning over cards.

Runs ``parallel.launch.consensus_cdl`` at the consensus geometry of
``chip_smoke.py`` (``bench.py``'s ``_bench_cdlcns``: images of 128x128,
32 filters of 8x8, lmbda 0.1, float32) in worlds of 1, 2 and 4 ranks, one
process a card over NCCL (``tcp://127.0.0.1``), two ways:

- weak: 40 images a rank (the global batch grows with the ranks);
- strong: 40 images in all, split over the ranks.

Each rank runs 3 outer iterations, then ITERS timed ones after a
barrier; the time of a world is its slowest rank's.  It checks that every
rank holds the same dictionary, that ``csc_iter`` runs once an outer
iteration on each rank, and, for the strong runs, that the dictionary of
every world is within 1e-5 of its scale of the one-rank world's.  Prints
one JSON line a world, then the card's name and power limit.

    python3 tools/cns_scaling.py [--ranks 1,2,4] [--iters 50]
    python3 tools/cns_scaling.py --device cpu --side 32 --ranks 1,2,4

(``--device cpu`` rehearses on CPU ranks over gloo at a small size.)
"""

import argparse
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

K_RANK, ND, M, LMBDA, WARM = 40, 8, 32, 0.1, 3
D_AGREE = 1e-5


def problem(side, K, seed):
    rng = np.random.default_rng(seed)
    S = rng.standard_normal((side, side, K)).astype(np.float32)
    D0 = np.random.default_rng(0).standard_normal((ND, ND, M)).astype(
        np.float32)
    return D0, S


def rank_main(args):
    """One rank: both runs in this world; rank 0 writes the results."""
    import torch.distributed as dist
    from sporco_tpu_torch.ops import csc_iter as tci
    from sporco_tpu_torch.parallel import launch
    r, P = args.rank, args.world
    cpu = args.device == "cpu"
    if cpu:
        # the plain version's calls count as the card's launches
        torch.set_num_threads(1)
        plain = tci.csc_iter_plain

        def counted(*a, **k):
            tci.LAUNCHES["csc_iter"] += 1
            return plain(*a, **k)
        tci.csc_iter_plain = counted
    launch.initialize(f"tcp://127.0.0.1:{args.port}", P, r,
                      local_rank=None if cpu else r,
                      device="cpu" if cpu else None,
                      timeout=datetime.timedelta(seconds=120))
    dev = torch.device("cpu") if cpu else torch.device("cuda", r)
    out = {"world": P}
    try:
        mesh = launch.global_mesh()
        for kind in ("weak", "strong"):
            K = K_RANK * P if kind == "weak" else K_RANK
            D0, S = problem(args.side, K, seed=1)
            Kl = K // P
            d = launch.consensus_cdl(D0, S[..., r * Kl:(r + 1) * Kl], LMBDA,
                                     mesh=mesh, max_iter=args.iters)
            d.step(WARM)
            if not cpu:
                torch.cuda.synchronize(dev)
            dist.barrier()
            tci.reset_launches()
            t0 = time.perf_counter()
            d.step(args.iters)
            if not cpu:
                torch.cuda.synchronize(dev)
            wall = torch.tensor([time.perf_counter() - t0],
                                dtype=torch.float64, device=dev)
            dist.all_reduce(wall, op=dist.ReduceOp.MAX)
            D = d.getdict().contiguous()
            D0r = D.clone()
            dist.broadcast(D0r, 0)
            same = float((D - D0r).abs().max())
            calls = torch.tensor([tci.LAUNCHES["csc_iter"]], device=dev)
            dist.all_reduce(calls, op=dist.ReduceOp.MIN)
            if same != 0.0 or int(calls) != args.iters:
                raise AssertionError(f"{kind} P={P}: ranks part by {same}, "
                                     f"csc_iter {int(calls)}")
            out[kind] = {"images_per_rank": Kl, "images": K,
                         "kernel_stage": bool(d.cfg.kernel_x),
                         "ms_per_iter": 1e3 * float(wall) / args.iters,
                         "csc_iter_per_rank": int(calls),
                         "objective": d.evaluate()[0]}
            if r == 0:
                np.save(os.path.join(args.out, f"D_{kind}_{P}.npy"),
                        D.cpu().numpy())
    finally:
        dist.destroy_process_group()
    if r == 0:
        with open(os.path.join(args.out, f"world_{P}.json"), "w") as f:
            json.dump(out, f)
    return 0


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def main(args):
    ranks = [int(v) for v in args.ranks.split(",")]
    if args.device != "cpu":
        if not torch.cuda.is_available():
            print("no CUDA device", file=sys.stderr)
            return 1
        if torch.cuda.device_count() < max(ranks):
            print(f"{max(ranks)} ranks need as many cards; "
                  f"{torch.cuda.device_count()} present", file=sys.stderr)
            return 1
        from sporco_tpu_torch.ops import _nvcc
        _nvcc.build(_nvcc.KERNELS)       # once, before the ranks load it
    res = {}
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")
                                     if os.path.isdir(os.path.join(
                                         ROOT, "build")) else None) as out:
        for P in ranks:
            port = free_port()
            cmd = [sys.executable, os.path.abspath(__file__), "--rank",
                   "{r}", "--world", str(P), "--port", str(port), "--out",
                   out, "--iters", str(args.iters), "--side", str(args.side),
                   "--device", args.device]
            procs = [subprocess.Popen([c.format(r=r) for c in cmd], cwd=ROOT)
                     for r in range(P)]
            try:
                rcs = [p.wait(timeout=args.timeout) for p in procs]
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
            if any(rcs):
                print(f"world of {P}: ranks exited {rcs}", file=sys.stderr)
                return 1
            with open(os.path.join(out, f"world_{P}.json")) as f:
                res[P] = json.load(f)
        base = res[ranks[0]]
        D1 = np.load(os.path.join(out, f"D_strong_{ranks[0]}.npy"))
        for P in ranks:
            w, s = res[P]["weak"], res[P]["strong"]
            w["efficiency"] = base["weak"]["ms_per_iter"] / w["ms_per_iter"]
            s["speedup"] = base["strong"]["ms_per_iter"] / s["ms_per_iter"]
            s["efficiency"] = s["speedup"] * ranks[0] / P
            Dp = np.load(os.path.join(out, f"D_strong_{P}.npy"))
            s["D_rel_err"] = float(np.abs(Dp - D1).max() / np.abs(D1).max())
            if not s["D_rel_err"] <= D_AGREE:
                raise AssertionError(f"strong P={P}: D parts from the "
                                     f"{ranks[0]}-rank world's by "
                                     f"{s['D_rel_err']:.3e}")
            print(json.dumps(res[P]), flush=True)
    if args.device != "cpu":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", default="1,2,4")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--side", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=int, default=240)
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--out", default=None)
    a = ap.parse_args()
    sys.exit(rank_main(a) if a.rank is not None else main(a))
