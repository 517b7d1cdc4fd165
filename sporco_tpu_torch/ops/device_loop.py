"""The fused drivers' on-device loop: one iteration function over static
device buffers, run in blocks of up to ``UNROLL`` iterations between
host reads.

Counterpart of the JAX package's ``lax.while_loop`` over blocks of
``UNROLL = 8`` iterations, each guarded by ``lax.cond``
(``sporco_tpu/ops/fused_csc.py:56``, ``:1024-1043``).  A driver writes
one iteration as a function ``step()`` (a :class:`Loop`) over static
device tensors: the state arrays, the scalars (rho, the deferred dual
factor, the residuals and tolerances, k, k0, t, L, ...), the stats rows,
written at ``k - k0`` through a device index, and the constants of the
problem.  ``step()`` computes the flag ``live`` (not converged, and
``enable`` set) and changes nothing where it is 0: its kernels return
before any write (``ops/csc_iter.py``, ``ops/pgm_iter.py``,
``ops/csc_tail.py``, and ``ops/fft2_planar.py`` under its ``gate``), and
every other update goes through ``torch.where(live, new, old)``.

:func:`run` then runs ``step`` in blocks of ``min(UNROLL, max_iter -
(k - k0))`` iterations and makes one device-to-host read after each
block (the flag and k, with the block's rows when ``verbose``), then
one read of the final state.  On CUDA tensors ``step`` is captured as a
CUDA graph and replayed, the replays of a block queued without a host
read between them; capture is the only route there, and a capture that
fails raises, naming the stage of ``step`` it was in.  Before the
capture ``step`` runs once eagerly with ``enable`` 0 (cuFFT plans, the
cuBLAS handle, the kernels' libraries, the allocator), which leaves the
state as it was.  One loop of each kind is kept with its graph
(:func:`kept`, :func:`keep`), with the key of everything the graph
bakes in: a later call with the same key writes its inputs into the
loop's static tensors and replays the same graph.  On CPU tensors
``step`` runs eagerly, in the same blocks.

Launch counts: every kernel of the iteration counts its live launches
on the device, in a counter of the loop that is read with the final
state (``counter=`` of ``csc_iter``, ``pgm_iter`` and ``admm_tail``, the
``gate`` of the FFT pair); a dead launch, the warm-up's included, counts
nothing.
"""

import torch

__all__ = ["UNROLL", "LAST", "Loop", "kept", "keep", "clear_cache", "run",
           "read", "stage"]

UNROLL = 8

# The last run: host reads (the loop's and the final one), blocks,
# replays (iterations run, live or dead), live iterations, whether it
# ran as a CUDA graph and whether it captured that graph (a kept loop
# replays the graph of an earlier call).
LAST = {}

_STAGE = ["start"]


def stage(name):
    """Name the part of the iteration function that runs next (for the
    error a failed capture raises)."""
    _STAGE[0] = name


def read(t):
    """The loop's device-to-host read of ``t``, as a numpy array."""
    return t.detach().cpu().numpy()


def _capture(step, device):
    """Warm ``step`` up once (``enable`` already 0) on a side stream,
    then capture it into a CUDA graph, which it returns."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        step()
    cur.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    side.wait_stream(cur)
    with torch.cuda.stream(side):
        # thread-local: another thread's CUDA calls (a profiler's, a
        # process group's watchdog) do not invalidate the capture
        graph.capture_begin(capture_error_mode="thread_local")
        try:
            step()
        except Exception as exc:
            try:
                graph.capture_end()
            except Exception:
                pass
            raise RuntimeError(
                "CUDA-graph capture of the fused loop's iteration failed "
                f"in {_STAGE[0]!r}: {exc}") from exc
        try:
            graph.capture_end()
        except Exception as exc:
            raise RuntimeError(
                "CUDA-graph capture of the fused loop's iteration failed "
                f"at its end (last stage {_STAGE[0]!r}): {exc}") from exc
    cur.wait_stream(side)
    return graph


class Loop:
    """One driver's iteration function over static device tensors.

    ``t`` maps names to the tensors that the functions read: a later call
    writes its values into them (:meth:`refill`), so a CUDA graph captured
    once reads each call's values.  ``step()`` runs one guarded iteration
    and returns its flag ``live``; ``t["enable"]`` is the 0-d bool tensor
    it ANDs into it.  ``status()`` gives a float32 tensor ``[done, k -
    k0]`` of the state after a block, ``final()`` the tensor read once at
    the end, ``rows(i, n)`` the stats rows ``[i, i + n)`` and
    ``show(row)`` prints one (verbose); ``finish()``, where given, gives
    what the driver derives on the device from the final state."""

    def __init__(self, t, step, status, final, rows, show, finish=None):
        self.t = t
        self.step, self.status, self.final = step, status, final
        self.rows, self.show, self.finish = rows, show, finish
        self.graph = None       # the captured iteration, once captured

    def refill(self, fresh):
        """Copy this call's tensors into the static ones, where the call
        did not write them there itself (the first call's are the static
        ones)."""
        for name, v in fresh.items():
            dst = self.t[name]
            if v is dst:
                continue
            if v.shape != dst.shape or v.dtype != dst.dtype:
                raise ValueError(f"the kept loop's {name!r} is "
                                 f"{tuple(dst.shape)} {dst.dtype}, this "
                                 f"call's {tuple(v.shape)} {v.dtype}")
            dst.copy_(v)


# The loop kept between solve calls, one of each kind (the fused ADMM
# and FISTA drivers), with the key of what its captured iteration bakes
# in (geometry, options, route, precisions): a model solved again with
# the same key, as dictionary learning's x-step or solve_chunked do,
# replays its graph instead of capturing anew.  A kept graph holds its
# own memory pool, so a new key replaces the loop of its kind.
_KEPT = {}


def kept(kind, key):
    """The loop of ``kind`` kept for ``key``, or None (and a loop of the
    kind kept for another key is dropped)."""
    entry = _KEPT.get(kind)
    if entry is not None and entry[0] == key:
        return entry[1]
    _KEPT.pop(kind, None)
    return None


def keep(kind, key, loop):
    """Keep ``loop`` as the loop of ``kind`` for ``key``; returns it."""
    _KEPT[kind] = (key, loop)
    return loop


def clear_cache():
    """Drop the kept loops (their graphs and static tensors)."""
    _KEPT.clear()


def run(loop, max_iter, done, device, verbose=False):
    """Run ``loop.step`` to convergence or ``max_iter`` iterations and
    return the final read (a numpy array).  ``done`` is the host's view
    of the initial state (a converged state runs no block)."""
    reads = blocks = replays = 0
    n_done = 0
    captured = False
    if not done and max_iter > 0:
        if device.type == "cuda":
            if loop.graph is None:
                loop.t["enable"].fill_(False)
                try:
                    loop.graph = _capture(loop.step, device)
                except Exception:
                    for kind in [k for k, (_, v) in _KEPT.items()
                                 if v is loop]:
                        del _KEPT[kind]
                    raise
                finally:
                    loop.t["enable"].fill_(True)
                captured = True
            replay = loop.graph.replay
        else:
            replay = loop.step
        while not done:
            n = min(UNROLL, max_iter - n_done)
            for _ in range(n):
                replay()
            parts = [loop.status()]
            if verbose:
                parts.append(loop.rows(n_done, n).reshape(-1))
            host = read(torch.cat(parts))
            reads += 1
            blocks += 1
            replays += n
            n_new = int(host[1])
            if verbose:
                ncol = (host.size - 2) // n
                for row in host[2:].reshape(n, ncol)[:n_new - n_done]:
                    loop.show(row)
            done = bool(host[0]) or n_new >= max_iter
            n_done = n_new
    out = read(loop.final())
    LAST.clear()
    LAST.update(host_reads=reads + 1, blocks=blocks, replays=replays,
                live=n_done, graph=device.type == "cuda" and blocks > 0,
                captured=captured)
    return out
