"""The drivers' on-device loop (the fused ones and the generic ADMM and
PGM drivers): one iteration function over static device buffers, run in
blocks of up to ``UNROLL`` iterations between host reads.

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
read between them; a capture that fails raises, naming the stage of
``step`` it was in (the eager route below is a problem's declaration,
never a fallback from a failed capture).  Before the
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

The generic ADMM and PGM drivers (``solvers/admm.py``,
``solvers/pgm.py``) run their problems' functions in the same loop: the
tensors of ``params``, of ``prob.setup``'s result and of the state are
leaves of trees (:func:`flatten`), copied once into static tensors of
the loop and refilled by a later call of the same key.  A problem whose
iteration synchronises with the host by nature (a host callable, as
``PPP``'s ``host_prior``) declares the eager route: on the card its
blocks run eagerly, with no graph, and the same single read a block.  An
unbounded inner loop is no such reason.

Conditional blocks inside an iteration (the JAX package's ``lax.cond``)
are :func:`when`: an IF node of the captured graph on the card, a host
test elsewhere.  Inner loops (its inner ``lax.while_loop``: conjugate
gradient, a line search's trials) are :func:`while_`: a WHILE node of
the captured graph on the card, whose body sets its own condition for
the next pass; a host loop elsewhere.  An inner loop finds the
iteration it runs in through :func:`outer` (the flag ``live``, so that a
dead iteration runs no pass, and a device counter of the loop that adds
up its passes, read with the final state into ``LAST["inner"]``).
"""

import contextlib
import dataclasses

import torch

__all__ = ["UNROLL", "LAST", "Loop", "Piece", "kept", "keep",
           "clear_cache", "run", "read", "when", "while_", "inner", "outer",
           "stage", "flatten", "unflatten"]

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


# eager reads of when()'s and while_()'s flags in the current run
# (LAST["flag_reads"])
_FLAGS = [0]


# while _capture warms its function up (eagerly, ``enable`` 0), and the
# memory pool of each capture under way (for the conditional nodes'
# bodies) with whether its recording follows the capturing thread yet
_WARM = [False]
_POOLS = []


def _capture(step, device):
    """Warm ``step`` up once (``enable`` already 0) on a side stream,
    then capture it into a CUDA graph, which it returns."""
    cur = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(cur)
    _WARM[0] = True
    try:
        with torch.cuda.stream(side):
            step()
    finally:
        _WARM[0] = False
    cur.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    pool = torch.cuda.graph_pool_handle()
    # what the conditional nodes need, made before the capture: the
    # library, its kernel loaded, the bodies' streams of the first two
    # depths
    for depth in (0, 1):
        _body_stream(device, depth)
    side.wait_stream(cur)
    _POOLS.append([pool, False])
    try:
        with torch.cuda.stream(side):
            # thread-local: another thread's CUDA calls (a profiler's, a
            # process group's watchdog) do not invalidate the capture
            graph.capture_begin(pool=pool, capture_error_mode="thread_local")
            try:
                step()
            except Exception as exc:
                try:
                    graph.capture_end()
                except Exception:
                    pass
                raise RuntimeError(
                    "CUDA-graph capture of the loop's iteration failed "
                    f"in {_STAGE[0]!r}: {exc}") from exc
            try:
                graph.capture_end()
            except Exception as exc:
                raise RuntimeError(
                    "CUDA-graph capture of the loop's iteration failed "
                    f"at its end (last stage {_STAGE[0]!r}): {exc}") from exc
    finally:
        _POOLS.pop()
    cur.wait_stream(side)
    return graph


def when(pred, body):
    """Run ``body()`` where the 0-d bool tensor ``pred`` is true (the JAX
    package's ``lax.cond`` with an empty other branch).

    While the device loop captures a CUDA graph, this adds an IF node to
    it (``csrc/cond_node.cu``): ``body``'s work is captured into the
    node's body graph and runs, when the graph is replayed, only where
    ``pred`` then holds; nothing is read on the host.  ``body`` gives its
    results by writing (``copy_``) into tensors made before the node: the
    graph after the node reads fixed addresses, whether the body ran or
    not.  A body may hold only what a conditional body may (kernels,
    device-memory copies and sets, graphs and further conditional nodes);
    anything else fails the capture, named by its ``stage``.  Outside a
    capture (the CPU, the eager route on the card) ``pred`` is read on
    the host, counted in ``LAST["flag_reads"]``; during the capture's
    eager warm-up (``enable`` 0, so every guarded ``pred`` is false) the
    body is skipped unread.  Returns None where it made a node, else
    whether the body ran."""
    if pred.device.type == "cuda" and \
            torch.cuda.is_current_stream_capturing():
        _cond_node(pred, body, "if")
        return None
    if _WARM[0]:
        return False
    _FLAGS[0] += 1
    if bool(read(pred)):
        body()
        return True
    return False


def while_(pred, body):
    """Run ``body()`` while the 0-d bool tensor ``pred`` holds (the JAX
    package's ``lax.while_loop`` on state held in tensors made before
    the call); ``body`` rewrites ``pred`` in place.

    While the device loop captures a CUDA graph, this adds a WHILE node
    to it (``csrc/cond_node.cu``): ``pred`` is its entry value and the
    body's last work sets its condition again from ``pred``, so the node
    runs the body as many times as ``pred`` allows at replay, with
    nothing read on the host.  ``body`` obeys :func:`when`'s rules.
    Outside a capture ``pred`` is read on the host before each pass,
    each read counted in ``LAST["flag_reads"]``; during the capture's
    eager warm-up the body is skipped unread.  Returns None where it
    made a node, else the passes run."""
    if pred.device.type == "cuda" and \
            torch.cuda.is_current_stream_capturing():
        _cond_node(pred, body, "while")
        return None
    if _WARM[0]:
        return 0
    n = 0
    while True:
        _FLAGS[0] += 1
        if not bool(read(pred)):
            return n
        body()
        n += 1


# the iterations under way (inner() contexts), innermost last
_OUTER = []


@contextlib.contextmanager
def inner(live, passes):
    """Within this context, inner loops (``ops/linalg.py`` ``cg``) belong
    to a loop iteration whose flag is ``live`` (a 0-d bool tensor): they
    run no pass where it is false, and add their passes into ``passes``
    (a 0-d int64 tensor of the loop, read with its final state)."""
    _OUTER.append((live, passes))
    try:
        yield
    finally:
        _OUTER.pop()


def outer():
    """``(live, passes)`` of the innermost :func:`inner` context under
    way, or None."""
    return _OUTER[-1] if _OUTER else None


_COND = {}


def _cond_lib():
    lib = _COND.get("lib")
    if lib is None:
        import ctypes
        from sporco_tpu_torch.ops import _nvcc
        lib = _nvcc.load("cond_node")
        lib.cond_if_begin.argtypes = [ctypes.c_void_p] * 3
        lib.cond_if_begin.restype = ctypes.c_int
        lib.cond_if_end.argtypes = [ctypes.c_void_p]
        lib.cond_if_end.restype = ctypes.c_int
        lib.cond_while_begin.argtypes = [ctypes.c_void_p] * 3
        lib.cond_while_begin.restype = ctypes.c_int
        lib.cond_while_end.argtypes = [ctypes.c_void_p] * 2
        lib.cond_while_end.restype = ctypes.c_int
        lib.cond_stream_create.argtypes = [ctypes.c_void_p]
        lib.cond_stream_create.restype = ctypes.c_int
        lib.cond_init.argtypes = []
        lib.cond_init.restype = ctypes.c_int
        err = lib.cond_init()
        if err != 0:
            raise RuntimeError(f"cond_node: CUDA error {err} at load")
        _COND["lib"] = lib
    return lib


def _body_stream(device, depth):
    """The stream that captures the bodies of conditional nodes ``depth``
    deep, one a depth and device for the process: the caching allocator
    reuses a block freed by a body only on its stream, so the bodies of a
    flat chain of nodes share one set of temporaries."""
    import ctypes
    key = (device.index, depth)
    s = _COND.get(key)
    if s is None:
        h = ctypes.c_void_p()
        err = _cond_lib().cond_stream_create(ctypes.byref(h))
        if err != 0:
            raise RuntimeError(f"conditional node's body stream: CUDA "
                               f"error {err}")
        s = _COND[key] = torch.cuda.ExternalStream(h.value, device=device)
    return s


_DEPTH = [0]


def _cond_node(pred, body, kind):
    """An IF (``kind`` "if") or WHILE ("while") node on ``pred`` whose
    body ``body()`` captures, in the capture under way."""
    name = {"if": "when", "while": "while_"}[kind]
    if pred.dtype != torch.bool or pred.numel() != 1:
        raise ValueError(f"{name}() takes a one-element bool tensor, not "
                         f"{pred.dtype} of shape {tuple(pred.shape)}")
    if not _POOLS:
        raise RuntimeError(f"{name}() makes a {kind.upper()} node only "
                           "inside the device loop's capture "
                           "(device_loop._capture)")
    dev = pred.device
    cap = _POOLS[-1]
    lib = _cond_lib()
    child = _body_stream(dev, _DEPTH[0])
    parent = torch.cuda.current_stream(dev)
    begin = lib.cond_if_begin if kind == "if" else lib.cond_while_begin
    err = begin(parent.cuda_stream, child.cuda_stream, pred.data_ptr())
    if err != 0:
        raise RuntimeError(f"{kind.upper()} node in {_STAGE[0]!r}: CUDA "
                           f"error {err}")
    _DEPTH[0] += 1
    try:
        if not cap[1]:
            # the graph's pool takes this thread's allocations from here
            # to the capture's end, the bodies' among them (its own
            # filter knows the parent stream's capture only, and a pool
            # records under one filter at a time); capture_end ends it
            torch._C._cuda_endAllocateToPool(dev.index, cap[0])
            torch._C._cuda_beginAllocateCurrentThreadToPool(dev.index,
                                                            cap[0])
            torch._C._cuda_releasePool(dev.index, cap[0])
            cap[1] = True
        with torch.cuda.stream(child):
            body()
    finally:
        _DEPTH[0] -= 1
        err = (lib.cond_if_end(child.cuda_stream) if kind == "if" else
               lib.cond_while_end(child.cuda_stream, pred.data_ptr()))
    if err != 0:
        raise RuntimeError(f"{kind.upper()} node's body in {_STAGE[0]!r}: "
                           f"CUDA error {err}")


class Piece:
    """A part of an iteration on the eager route that touches only static
    tensors (the stopping test, the scalar tail), captured as a CUDA
    graph of its own at its first call on the card and replayed after:
    one launch for a few dozen small ones, each of which would pay the
    host's dispatch.  ``quiet``, a 0-d bool tensor (the loop's ``live``),
    is 0 while the part is warmed up and captured, so that the warm-up
    writes nothing the part guards by it."""

    def __init__(self, fn, device, quiet=None):
        self.fn, self.device, self.quiet = fn, device, quiet
        self.graph = None

    def __call__(self):
        if self.graph is None:
            saved = None if self.quiet is None else self.quiet.clone()
            if saved is not None:
                self.quiet.fill_(False)
            try:
                self.graph = _capture(self.fn, self.device)
            finally:
                if saved is not None:
                    self.quiet.copy_(saved)
        self.graph.replay()


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
    what the driver derives on the device from the final state;
    ``start()``, where given, runs once before the first block of a call
    that is not captured (a loop whose eager iterations each compute the
    next one's test at their end computes the first's there); ``inner_at``,
    where given, is the index in ``final()``'s read of the loop's count
    of inner passes (:func:`inner`), recorded in ``LAST["inner"]``."""

    def __init__(self, t, step, status, final, rows, show, finish=None,
                 start=None, inner_at=None):
        self.t = t
        self.step, self.status, self.final = step, status, final
        self.rows, self.show, self.finish = rows, show, finish
        self.start, self.inner_at = start, inner_at
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
# and FISTA drivers; the generic drivers' kinds are one per problem and
# device),
# with the key of what its captured iteration bakes in (geometry,
# options, route, precisions): a model solved again with the same key,
# as dictionary learning's x- and d-steps or solve_chunked do, replays
# its graph instead of capturing anew.  A kept graph holds its own
# memory pool, so a new key replaces the loop of its kind, past MAX_KEPT
# kinds the least recently used one goes, and the blocks of the pools
# so freed go back to the card before the next capture.
_KEPT = {}
MAX_KEPT = 4


_DROPPED = [False]


def kept(kind, key):
    """The loop of ``kind`` kept for ``key``, or None (and a loop of the
    kind kept for another key is dropped)."""
    entry = _KEPT.pop(kind, None)
    if entry is not None and entry[0] == key:
        _KEPT[kind] = entry
        return entry[1]
    _DROPPED[0] |= entry is not None
    return None


def keep(kind, key, loop):
    """Keep ``loop`` as the loop of ``kind`` for ``key``; returns it."""
    _DROPPED[0] |= _KEPT.pop(kind, None) is not None
    while len(_KEPT) >= MAX_KEPT:
        del _KEPT[next(iter(_KEPT))]
        _DROPPED[0] = True
    _KEPT[kind] = (key, loop)
    if _DROPPED[0] and torch.cuda.is_available():
        # a dropped loop's graph pool is cached memory that no other
        # capture can take
        torch.cuda.empty_cache()
        _DROPPED[0] = False
    return loop


def clear_cache():
    """Drop the kept loops (their graphs and static tensors)."""
    _KEPT.clear()


def run(loop, max_iter, done, device, verbose=False, graph=True):
    """Run ``loop.step`` to convergence or ``max_iter`` iterations and
    return the final read (a numpy array).  ``done`` is the host's view
    of the initial state (a converged state runs no block).  ``graph``
    False is the eager route: the card runs ``step`` itself."""
    reads = blocks = replays = 0
    n_done = 0
    captured = False
    _FLAGS[0] = 0
    graph = graph and device.type == "cuda"
    if not done and max_iter > 0:
        if graph:
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
            if loop.start is not None:
                loop.start()
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
                live=n_done, graph=graph and blocks > 0, captured=captured,
                route="graph" if graph else "eager", flag_reads=_FLAGS[0])
    if loop.inner_at is not None:
        LAST["inner"] = int(out[loop.inner_at])
    return out


# ---------------------------------------------------------------------------
# Trees of tensors (the generic drivers' params, set-up results and state)

def _const_key(v):
    """A comparable stand-in for a non-tensor leaf, which a captured
    iteration bakes in: its value where it has one, else the object
    itself (kept alive by the loop, so its identity stays its own)."""
    if v is None or isinstance(v, (bool, int, float, complex, str)):
        return ("v", type(v).__name__, repr(v))
    if isinstance(v, torch.dtype):
        return ("v", "dtype", str(v))
    try:
        import numpy as np
        if isinstance(v, np.generic):
            return ("v", v.dtype.str, v.tobytes())
        if isinstance(v, np.ndarray):
            return ("a", v.shape, v.dtype.str, v.tobytes())
    except ImportError:         # pragma: no cover
        pass
    try:
        hash(v)
    except TypeError:
        return ("id", id(v))
    return ("h", v)


def _has_tensor(x):
    if isinstance(x, torch.Tensor):
        return True
    if isinstance(x, dict):
        return any(_has_tensor(v) for v in x.values())
    if isinstance(x, (tuple, list)):
        return any(_has_tensor(v) for v in x)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return any(_has_tensor(getattr(x, f.name))
                   for f in dataclasses.fields(x))
    return False


def flatten(tree, shared=True):
    """The tensor leaves of ``tree`` (nested dicts, tuples, lists, named
    tuples and dataclass instances), a spec that :func:`unflatten`
    rebuilds it from, and a hashable key of its structure: the shape,
    type and device of each tensor, which leaves are one tensor (with
    ``shared``; else each place is a leaf of its own, as the state
    arrays that the loop writes are), and the value (or identity) of
    every other leaf."""
    leaves = []
    spec, key = _walk(tree, leaves, {} if shared else None)
    return leaves, spec, key


def _walk(x, leaves, seen):
    """:func:`flatten`'s recursion (a module function: a nested one would
    hold the leaves in a reference cycle until the collector runs, and
    the card's memory with them)."""
    if isinstance(x, torch.Tensor):
        i = len(leaves) if seen is None else seen.setdefault(id(x),
                                                             len(leaves))
        if i == len(leaves):
            leaves.append(x)
        return ("T", i), ("T", i, tuple(x.shape), x.dtype, str(x.device))
    if isinstance(x, dict):
        parts = [(k, _walk(v, leaves, seen)) for k, v in x.items()]
        return (("d", type(x), tuple((k, p[0]) for k, p in parts)),
                ("d", tuple((repr(k), p[1]) for k, p in parts)))
    if isinstance(x, (tuple, list)) and _has_tensor(x):
        parts = [_walk(v, leaves, seen) for v in x]
        return ((type(x), tuple(p[0] for p in parts)),
                (type(x).__name__, tuple(p[1] for p in parts)))
    if (dataclasses.is_dataclass(x) and not isinstance(x, type)
            and _has_tensor(x)):
        parts = [(f.name, _walk(getattr(x, f.name), leaves, seen))
                 for f in dataclasses.fields(x)]
        return (("c", x, tuple((n, p[0]) for n, p in parts)),
                ("c", type(x).__name__, tuple((n, p[1]) for n, p in parts)))
    return ("K", x), ("K", _const_key(x))


def unflatten(spec, leaves):
    """The tree of :func:`flatten`'s ``spec`` with ``leaves`` for its
    tensors."""
    tag = spec[0]
    if tag == "T":
        return leaves[spec[1]]
    if tag == "K":
        return spec[1]
    if tag == "d":
        return spec[1]({k: unflatten(p, leaves) for k, p in spec[2]})
    if tag == "c":
        import copy
        obj = copy.copy(spec[1])
        for n, p in spec[2]:
            object.__setattr__(obj, n, unflatten(p, leaves))
        return obj
    typ, parts = spec
    vals = [unflatten(p, leaves) for p in parts]
    if typ is list:
        return vals
    if typ is tuple:
        return tuple(vals)
    return typ(*vals)           # a named tuple
