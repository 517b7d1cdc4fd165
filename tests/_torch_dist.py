"""Multi-rank runs of the port over gloo on the CPU, for the
``tests/test_torch_parallel_*.py`` and ``test_torch_parcbpdn.py`` tests.

:func:`run_world` starts ``world`` processes of this module, each of
which initialises ``torch.distributed`` (gloo, ``tcp://127.0.0.1``, one
thread), runs the named cases of :data:`CASES` in order, writes each
case's arrays to ``<outdir>/<case>_<rank>.npz`` and destroys the process
group.  It imports numpy, torch and the port only, never JAX::

    python -m tests._torch_dist CASES RANK WORLD PORT OUTDIR
"""

import datetime
import os
import socket
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def run_world(cases, world, outdir):
    """Run ``cases`` (names of :data:`CASES`) on ``world`` ranks; returns
    ``{case: [arrays of rank 0, arrays of rank 1, ...]}``.  Each rank's
    join waits at most :data:`TIMEOUT` seconds; a rank that has not
    ended by then is killed with the others, and the test fails naming
    it."""
    port = free_port()
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "tests._torch_dist", ",".join(cases)]
    procs = [subprocess.Popen(cmd + [str(r), str(world), str(port),
                                     str(outdir)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    outs = []
    try:
        for r, p in enumerate(procs):
            try:
                outs.append(p.communicate(timeout=TIMEOUT)[0])
            except subprocess.TimeoutExpired:
                raise AssertionError(
                    f"rank {r} of {world} running {cases} did not end "
                    f"within {TIMEOUT} s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, \
            f"rank {r} of {world} running {cases} failed:\n{out[-4000:]}"
    res = {}
    for c in cases:
        res[c] = []
        for r in range(world):
            with np.load(os.path.join(outdir, f"{c}_{r}.npz")) as z:
                res[c].append(dict(z))
    return res


# ---------------------------------------------------------------------------
# Problems (the tests build the same ones for the JAX side)

def consensus_problem():
    """``tests/parallel/test_launch.py``'s consensus problem (float64,
    N=16, Nd=5, M=8, K=8) and a mask for the masked class."""
    rng = np.random.default_rng(12345)
    N, Nd, M, K = 16, 5, 8, 8
    D0 = rng.standard_normal((Nd, Nd, M))
    S = rng.standard_normal((N, N, K))
    W = (rng.random((N, N, K)) > 0.3).astype(np.float64)
    return D0, S, W


def kernel_problem():
    """A float32 consensus problem on which the kernel stage runs."""
    rng = np.random.default_rng(7)
    D0 = rng.standard_normal((5, 5, 8)).astype(np.float32)
    S = rng.standard_normal((32, 32, 4)).astype(np.float32)
    return D0, S


def spatial_problems():
    """The images of ``tests/parallel/test_spatial.py``: a 32x24 signal
    for the transforms, a blurred square for TV deconvolution, and a
    CSC problem for ``cbpdn_nsharded``."""
    rng = np.random.default_rng(12345)
    x = rng.standard_normal((32, 24))
    N = 64
    img = np.zeros((N, N))
    img[N // 4:3 * N // 4, N // 4:3 * N // 4] = 1.0
    h = np.ones((5, 5)) / 25.0
    S = np.fft.irfft2(np.fft.rfft2(img) * np.fft.rfft2(h, s=(N, N)),
                      s=(N, N)) + 0.02 * rng.standard_normal((N, N))
    D = rng.standard_normal((6, 6, 8))
    D /= np.sqrt((D ** 2).sum(axis=(0, 1), keepdims=True))
    Sc = rng.standard_normal((32, 24))
    return x, (h, S), (D, Sc)


TV_OPT = {"max_iter": 200, "rel_stop_tol": 1e-3}
CSC_OPT = {"max_iter": 200, "rel_stop_tol": 1e-3}


def par_problem():
    """A float64 ParConvBPDN problem with a mask (8 filters)."""
    rng = np.random.default_rng(3)
    D = rng.standard_normal((5, 5, 8))
    S = rng.standard_normal((32, 32))
    W = (rng.random((32, 32)) > 0.3).astype(np.float64)
    return D, S, W


def grid_fn(p):
    """``tests/parallel/_launch_child.py``'s grid-search function."""
    return (p[0] - 0.3) ** 2 + abs(p[1])


GRID = (np.linspace(0, 1, 11), np.array([-1.0, 0.0, 2.0]))


# ---------------------------------------------------------------------------
# Cases, run on every rank

def _mesh():
    from sporco_tpu_torch.parallel import launch
    return launch.global_mesh()


def _cns_out(d):
    D = d.solve().numpy()
    return {"D": D, "obj": np.array(d.evaluate()), "K": d.cri.K,
            "coef": d.getcoef().numpy(), "kernel_x": d.cfg.kernel_x}


def case_cns_mesh():
    from sporco_tpu_torch.parallel import consensus as tcn
    D0, S, _ = consensus_problem()
    return _cns_out(tcn.ConvBPDNDictLearn_Consensus(
        D0, S, 0.05, mesh=_mesh(), max_iter=10, dtype=torch.float64))


def case_cns_local():
    import torch.distributed as dist
    from sporco_tpu_torch.parallel import launch
    D0, S, _ = consensus_problem()
    P, r = dist.get_world_size(), dist.get_rank()
    Kl = S.shape[-1] // P
    return _cns_out(launch.consensus_cdl(
        D0, S[..., r * Kl:(r + 1) * Kl], 0.05, mesh=_mesh(), max_iter=10,
        dtype=torch.float64))


def case_cns_masked():
    from sporco_tpu_torch.parallel import consensus as tcn
    D0, S, W = consensus_problem()
    return _cns_out(tcn.ConvBPDNMaskDcplDictLearn_Consensus(
        D0, S, 0.05, W=W, mesh=_mesh(), max_iter=10, dtype=torch.float64))


def case_cns_raises():
    """Where the JAX package raises for process-local batches: no mesh,
    no K axis; and a K that does not divide over the ranks."""
    from sporco_tpu_torch.parallel import consensus as tcn
    D0, S, _ = consensus_problem()
    out = {}
    for name, kw in (("no_mesh", {"process_local_batch": True,
                                  "device": "cpu"}),
                     ("no_k_axis", {"process_local_batch": True,
                                    "mesh": _mesh(), "dimK": 0}),
                     ("k_split", {"mesh": _mesh()})):
        Sx = S[..., 0] if name == "no_k_axis" else (
            S[..., :3] if name == "k_split" else S)
        try:
            tcn.ConvBPDNDictLearn_Consensus(D0, Sx, 0.05, max_iter=1,
                                            dtype=torch.float64, **kw)
            out[name] = ""
        except ValueError as e:
            out[name] = str(e)
    return out


def case_cns_kernel():
    from sporco_tpu_torch.ops import csc_iter as tci
    from sporco_tpu_torch.parallel import consensus as tcn
    D0, S = kernel_problem()
    calls = [0]
    plain = tci.csc_iter_plain

    def counted(*a, **k):
        calls[0] += 1
        return plain(*a, **k)
    tci.csc_iter_plain = counted
    try:
        out = _cns_out(tcn.ConvBPDNDictLearn_Consensus(
            D0, S, 0.1, mesh=_mesh(), max_iter=10))
    finally:
        tci.csc_iter_plain = plain
    out["calls"] = calls[0]
    return out


def case_spatial():
    import torch.distributed as dist
    from sporco_tpu_torch.models.cbpdn import ConvBPDN
    from sporco_tpu_torch.models.tv import TVL2Deconv
    from sporco_tpu_torch.ops import device_loop
    from sporco_tpu_torch.parallel import spatial
    from sporco_tpu_torch.parallel.mesh import shard_batch
    mesh = _mesh()
    P = dist.get_world_size()
    g = mesh.get_group("data")
    x, (h, S), (D, Sc) = spatial_problems()
    xf = spatial.dist_rfft2(shard_batch(mesh, x), P, g)
    xr = spatial.dist_irfft2(xf, x.shape[1], P, g)
    Xt, kt, rt, st = spatial.tvl2deconv_nsharded(
        h, S, 5e-3, mesh, opt=TVL2Deconv.options(**TV_OPT),
        dtype=torch.float64)
    reads_t = device_loop.LAST["host_reads"]
    Xc, stats, kc = spatial.cbpdn_nsharded(
        D, Sc, 0.1, mesh, opt=ConvBPDN.options(**CSC_OPT),
        dtype=torch.float64)
    out = {"xf": xf.numpy(), "xr": xr.numpy(), "Xt": Xt.numpy(), "kt": kt,
           "rs": np.array([rt, st]), "Xc": Xc.numpy(), "stats": stats,
           "kc": kc, "reads": np.array([reads_t,
                                        device_loop.LAST["host_reads"]])}
    for name, args in (("odd_rows", (h, S[:-1])), ("not_2d", (h, S[None]))):
        try:
            spatial.tvl2deconv_nsharded(*args, 5e-3, mesh)
            out[name] = ""
        except ValueError as e:
            out[name] = str(e)
    return out


def case_par():
    import torch.distributed as dist
    from sporco_tpu_torch.models.parcbpdn import ParConvBPDN
    from sporco_tpu_torch.ops import device_loop
    from sporco_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh(n_data=1, n_filter=dist.get_world_size(), device="cpu")
    D, S, W = par_problem()
    b = ParConvBPDN(D, S, 0.1, W=W, ngrp=4, dtype=torch.float64, mesh=mesh,
                    opt=ParConvBPDN.options(max_iter=30))
    X = b.solve().numpy()
    its = b.getitstat()
    return {"X": X, "rows": its._arr, "Y1": b.state[2].numpy(),
            "recon": b.reconstruct().numpy(),
            "reads": device_loop.LAST["host_reads"]}


def case_grid():
    from sporco_tpu_torch.parallel import launch
    prm, val, vals = launch.grid_search(grid_fn, GRID)
    return {"prm": np.array(prm), "val": val, "vals": vals}


CASES = {"cns_mesh": case_cns_mesh, "cns_local": case_cns_local,
         "cns_masked": case_cns_masked, "cns_raises": case_cns_raises,
         "cns_kernel": case_cns_kernel, "spatial": case_spatial,
         "par": case_par, "grid": case_grid}


def main(argv):
    cases, rank, world, port, outdir = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    sys.path.insert(0, ROOT)
    import torch.distributed as dist
    from sporco_tpu_torch.parallel import launch
    launch.initialize(f"tcp://127.0.0.1:{port}", world, rank, device="cpu",
                      timeout=datetime.timedelta(seconds=TIMEOUT - 20))
    try:
        for c in cases.split(","):
            out = CASES[c]()
            np.savez(os.path.join(outdir, f"{c}_{rank}.npz"), **out)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
