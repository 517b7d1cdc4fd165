#!/usr/bin/env python3
"""Where a launch of the Jacobi SVD's round kernel spends its time on the
card, phase by phase.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 tools/jacobi_phase_probe.py [--cases NAME ...] [--cluster C]
        [--source LABEL=PATH ...] [--turns N]

It copies ``sporco_tpu_torch/csrc/jacobi_svd.cu`` (or each ``--source``,
a version of that file with its C interface, e.g. the parent commit's
or a variant under ``build/``) into ``build/phase_probe/`` and inserts,
at the round kernel's phase comments,
reads of ``clock64()`` by thread 0 of the first block of each launch:
its start, the slices in shared memory, (1) the partial Gram and its
warps' tree, (2) the cluster's sum, (3) the inner rounds and (4) the
application of R (to the end of the launch, or to its early return where
nothing rotated); and ``%globaltimer`` at the start and the end of the
same block, which turns cycles into microseconds.  It builds each copy
with ``ops/_nvcc.py``'s flags, loads it in place of the source's own
library (the sources in turns: in order, then in reverse, ``--turns``
times in all), and for each case (:data:`CASES`: the shapes of
``tools/generic_loop_profile.py``, a Gaussian matrix from
``torch.Generator().manual_seed(7)``) captures one SVD as ``ops/svd.py``
runs it inside a device loop's iteration, replays it once with the
counters at 0 and then times 5 replays with CUDA events.  Prints one
JSON line per case: the launches, each phase's mean microseconds a
launch in the first block, that block's whole launch, and over all the
blocks of a launch (``%globaltimer`` of each block's thread 0, the means
over the launches; with ``--spans``, which adds four atomics a block):
the spread of their starts, the span from the first start to the last
end, and a block's mean duration; the clusters of the
launch beside those the card can run at once at its shared memory
(``cudaOccupancyMaxActiveClusters``, the shared route at w = 8); the
replay's
microseconds a launch (``us_per_launch``: the launch's start and drain,
and the other blocks' lag, are the difference), the SM clock the timers
gave, the geometry, ``sha256``, a digest of the replay's ``u``, ``s``
and ``v^T`` (equal digests: equal outputs bit for bit), and the card's
name and power limit.  The timers add
a few instructions a phase to one thread; the replay's time is that of
the instrumented kernel.  ``--cluster C`` forces clusters of C blocks
(the route as ``svd.shared_rows`` gives it); ``--profile`` adds
``kernel_us``, the round kernel's mean device time a launch from
``torch.profiler`` over one eager SVD (the replay's ``us_per_launch``
less it is the gap between launches; it less ``block_us`` the other
blocks' lag behind the first).
"""

import argparse
import ctypes
import hashlib
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CASES = {
    "full32": ((512, 512), "float32"),
    "small32": ((26, 512), "float32"),
    "cfull64": ((512, 512), "complex64"),
    "csmall64": ((26, 512), "complex64"),
    "cmid64": ((256, 192), "complex64"),
    "clong64": ((100, 2000), "complex64"),
}
PHASES = ("load", "gram", "cluster_sum", "inner_rounds", "apply")

# (anchor in the source, what is inserted before it)
_MARKS = [
    ("  // the slices into shared memory, Q's arriving while the round runs",
     "  PROBE_AT(0);\n"),
    ("  // 1. the slice's partial Gram", "  PROBE_AT(1);\n"),
    ("  // 2. the cluster's G, the partials added in rank order",
     "  PROBE_AT(2);\n"),
    ("  // 3. the inner rounds on G.", "  PROBE_AT(3);\n"),
    ("  if (!any) {  // nothing moved", "  PROBE_AT(4);\n"),
]
_SLOTS = 8192
_HEADER = r'''
__device__ unsigned long long jac_probe[8];
// each launch's slot (the blocks' tickets, taken as they end, over the
// grid's blocks): its blocks' first start, last start and last end, and
// the sum of their durations, from %globaltimer
#define PROBE_SLOTS 8192
__device__ unsigned long long jac_ticket;
__device__ unsigned long long jac_span[PROBE_SLOTS][4];
__device__ __forceinline__ unsigned long long probe_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define PROBE_AT(k) \
  if ((k) == 0 && threadIdx.x == 0) probe_s0 = probe_ns(); \
  if (probe_on) { \
    probe_t[k] = clock64(); \
    if ((k) == 0) probe_g0 = probe_ns(); \
  }
#define PROBE_END() \
  if (PROBE_SPANS && threadIdx.x == 0) { \
    const unsigned long long e = probe_ns(); \
    const unsigned long long k = atomicAdd(&jac_ticket, 1ull) / gridDim.x; \
    if (k < PROBE_SLOTS) { \
      atomicMin(&jac_span[k][0], probe_s0); \
      atomicMax(&jac_span[k][1], probe_s0); \
      atomicMax(&jac_span[k][2], e); \
      atomicAdd(&jac_span[k][3], e - probe_s0); \
    } \
  } \
  if (probe_on) { \
    probe_t[5] = clock64(); \
    for (int q = 0; q < 5; ++q) \
      atomicAdd(&jac_probe[q], \
                (unsigned long long)(probe_t[q + 1] - probe_t[q])); \
    atomicAdd(&jac_probe[5], \
              (unsigned long long)(probe_t[5] - probe_t[0])); \
    atomicAdd(&jac_probe[6], probe_ns() - probe_g0); \
    atomicAdd(&jac_probe[7], 1ull); \
  }
'''
_TAIL = r'''
extern "C" int jac_probe_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, jac_probe, sizeof(jac_probe));
}
extern "C" int jac_probe_reset(void) {
  unsigned long long z[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  static unsigned long long span[PROBE_SLOTS][4];
  for (int k = 0; k < PROBE_SLOTS; ++k) {
    span[k][0] = ~0ull;
    span[k][1] = span[k][2] = span[k][3] = 0;
  }
  int err = (int)cudaMemcpyToSymbol(jac_probe, z, sizeof(z));
  if (!err) err = (int)cudaMemcpyToSymbol(jac_ticket, z, sizeof(z[0]));
  if (!err) err = (int)cudaMemcpyToSymbol(jac_span, span, sizeof(span));
  return err;
}
extern "C" int jac_probe_spans(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, jac_span, sizeof(jac_span));
}
// the clusters of C blocks of the shared route's kernel at w = 8 with
// `smem` bytes each that the card runs at once
extern "C" int jac_probe_clusters(int C, int smem, int complex_form,
                                  int* n) {
  return complex_form ? max_clusters<8, true, true>(C, smem, n)
                      : max_clusters<8, true, false>(C, smem, n);
}
'''


def instrument(src, spans=False):
    """The source with the timers inserted (fails if an anchor moved);
    ``spans``: every block's start and end too."""
    head = "namespace {\n"
    assert src.count(head) == 1
    src = src.replace(head, f"#define PROBE_SPANS {int(spans)}\n"
                      + _HEADER + head, 1)
    start = "  const int gr = lane >> 2, gc = lane & 3;\n"
    assert src.count(start) == 1
    src = src.replace(start, start + (
        "  const bool probe_on = blockIdx.x == 0 && threadIdx.x == 0;\n"
        "  long long probe_t[6];\n"
        "  unsigned long long probe_g0 = 0, probe_s0 = 0;\n"), 1)
    for anchor, ins in _MARKS:
        assert src.count(anchor) == 1, anchor
        src = src.replace(anchor, ins + anchor, 1)
    early = "    cp_async_wait<0>();\n    cluster_wait();\n    return;\n"
    assert src.count(early) == 1
    src = src.replace(early, "    PROBE_END();\n" + early, 1)
    end = "  cluster_wait();\n}\n\n// status = [rotations"
    assert src.count(end) == 1
    src = src.replace(end, "  PROBE_END();\n" + end, 1)
    return src + _TAIL


SOURCE = os.path.join("sporco_tpu_torch", "csrc", "jacobi_svd.cu")


def build(sources, spans=False):
    """Each source instrumented and built, one nvcc a source, all started
    together: label -> (library, registers ptxas reported)."""
    from sporco_tpu_torch.ops import _nvcc
    out_dir = os.path.join(ROOT, "build", "phase_probe")
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for label, path in sources.items():
        with open(os.path.join(ROOT, path)) as f:
            src = instrument(f.read(), spans)
        cu = os.path.join(out_dir, f"jacobi_svd_{label}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(out_dir, f"libjacobi_svd_{label}.so")
        procs[label] = (so, subprocess.Popen(
            [_nvcc.find_nvcc(), *_nvcc.NVCC_FLAGS, "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for label, (so, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {label}:\n{err[-8000:]}")
        lib = ctypes.CDLL(so)
        lib.jac_probe_read.argtypes = [ctypes.c_void_p]
        lib.jac_probe_spans.argtypes = [ctypes.c_void_p]
        lib.jac_probe_clusters.argtypes = [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
        libs[label] = (lib, re.findall(r"Used (\d+) registers", err))
    return libs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cases", nargs="*", default=list(CASES))
    ap.add_argument("--cluster", type=int, default=None)
    ap.add_argument("--source", nargs="*", default=[f"tree={SOURCE}"])
    ap.add_argument("--turns", type=int, default=1)
    ap.add_argument("--profile", action="store_true")
    ap.add_argument("--spans", action="store_true")
    args = ap.parse_args()
    sources = dict(s.split("=", 1) for s in args.source)
    import torch
    import chip_smoke as cs
    from sporco_tpu_torch.ops import _nvcc, device_loop
    from sporco_tpu_torch.ops import svd as tsvd
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available")
    dev = torch.device("cuda", 0)
    libs = build(sources, args.spans)
    current = {}
    load0 = _nvcc.load
    _nvcc.load = (lambda name: current["lib"] if name == "jacobi_svd"
                  else load0(name))
    if args.cluster:
        geo0 = tsvd.geometry

        def geometry(m, n, itemsize=8):
            g = geo0(m, n, itemsize)
            return g._replace(C=args.cluster, shared=tsvd.shared_rows(
                g.L, g.w, args.cluster, itemsize))
        tsvd.geometry = geometry
    smi = cs.nvidia_smi()
    order = list(sources)
    for turn in range(args.turns):
        for label in (order if turn % 2 == 0 else order[::-1]):
            # the next source's library in place of the last one's
            current["lib"], regs = libs[label]
            tsvd._LIB.clear()
            tsvd._COUNT.clear()
            for name in args.cases:
                rec = _case(cs, torch, tsvd, device_loop, dev,
                            current["lib"], name, args.profile)
                print(json.dumps({"source": label, "turn": turn, **rec,
                                  "registers": regs, "nvidia_smi": smi}),
                      flush=True)
    return 0


def _kernel_us(torch, tsvd, a):
    """The round kernel's mean device microseconds a launch under
    ``torch.profiler``, in one eager SVD of ``a`` (a capture's WHILE node
    shows the profiler one pass only), and its launches there."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        tsvd.jacobi_svd(a)
        torch.cuda.synchronize()
    us, n = 0.0, 0
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and "jac_round" in e.key):
            us += getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0.0))
            n += e.count
    return (us / n if n else None), n


def _case(cs, torch, tsvd, device_loop, dev, lib, name, profile=False):
    """One case's phases and times with the loaded library; with
    ``profile`` also the kernel's device time a launch."""
    buf = (ctypes.c_ulonglong * 8)()
    shape, dt = CASES[name]
    a = torch.randn(shape, generator=torch.Generator().manual_seed(7),
                    dtype=getattr(torch, dt)).to(dev)
    tsvd.jacobi_svd(a)
    geo = tsvd.LAST["geometry"]
    outs = [torch.empty_like(t) for t in tsvd.jacobi_svd(a)]

    def step():
        for o, t in zip(outs, tsvd.jacobi_svd(a)):
            o.copy_(t)
    graph = device_loop._capture(step, dev)
    torch.cuda.synchronize()
    tsvd.reset_launches()
    lib.jac_probe_reset()
    graph.replay()
    torch.cuda.synchronize()
    lib.jac_probe_read(buf)
    spans = (ctypes.c_ulonglong * (4 * _SLOTS))()
    lib.jac_probe_spans(spans)
    n = int(buf[7])
    launches = tsvd.launches(dev)
    ghz = buf[5] / buf[6]
    # the launches' spans: (first start, last start, last end, sum of the
    # blocks' durations) in ns
    sl = [spans[4 * k:4 * k + 4] for k in range(min(n, _SLOTS))] or [
        [0, 0, 0, 0]]
    blocks = geo.Pp // (2 * geo.w) * geo.C
    # the clusters the card runs at once at this case's shared memory (the
    # shared route at w = 8; None elsewhere) beside the launch's clusters
    active = None
    if geo.shared and geo.w == 8:
        e = 2 if a.is_complex() else 1
        smem = 8 * (tsvd._head(8, e) + 16 * tsvd._stride(
            e * tsvd._span(geo.L, geo.C)) + 16 * tsvd._stride(
            e * tsvd._span(geo.Pp, geo.C)))
        if smem > tsvd.SMEM_MAX:    # Q's slice read in global memory
            smem -= 8 * 16 * tsvd._stride(e * tsvd._span(geo.Pp, geo.C))
        cnt = ctypes.c_int(0)
        lib.jac_probe_clusters(geo.C, smem, e - 1, ctypes.byref(cnt))
        active = cnt.value
    digest = hashlib.sha256()
    for o in outs:
        digest.update(o.contiguous().cpu().numpy().tobytes())
    ms = cs.cuda_ms(graph.replay, reps=5, warmup=1)
    kernel_us, profiled = (_kernel_us(torch, tsvd, a) if profile
                           else (None, None))
    return {"kernel_us": kernel_us, "profiled_launches": profiled,
            "case": name, "shape": list(shape), "dtype": dt,
            "geometry": list(geo), "launches": launches,
            "probed_launches": n, "sm_ghz": ghz,
            "phases_us": {p: buf[i] / n / ghz / 1e3
                          for i, p in enumerate(PHASES)},
            "block_us": buf[6] / n / 1e3,
            "clusters": blocks // geo.C, "active_clusters": active,
            "start_spread_us": sum(x[1] - x[0] for x in sl) / len(sl) / 1e3,
            "launch_span_us": sum(x[2] - x[0] for x in sl) / len(sl) / 1e3,
            "mean_block_us": sum(x[3] for x in sl) / len(sl) / blocks / 1e3,
            "svd_ms": ms, "us_per_launch": 1e3 * ms / launches,
            "sha256": digest.hexdigest()}


if __name__ == "__main__":
    sys.exit(main())
