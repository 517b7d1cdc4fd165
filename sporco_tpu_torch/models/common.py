"""Shared machinery for model classes (counterpart of
``sporco_tpu.models.common``): a thin stateful shell holding
``(cfg, params, opts, state)`` around a functional solver core, for ADMM
and for PGM models, with checkpoints (``save_state``/``load_state_file``,
``.npz`` files in the JAX package's layout, so that either package
resumes the other's), a chunked solve with a callback and the stats
table."""

import dataclasses
import math

import numpy as np
import torch

from sporco_tpu_torch import refopts
from sporco_tpu_torch.ops import fft as sf
from sporco_tpu_torch.solvers import admm as _admm
from sporco_tpu_torch.solvers import pgm as _pgm
from sporco_tpu_torch.utils.timer import Timer

__all__ = ["ADMMModel", "PGMModel", "default_rho_xi", "user_tensor",
           "warm_start", "device_sync"]


def device_sync(state):
    """Wait for every device that holds a tensor of ``state`` (a tensor,
    or a dataclass, named tuple, tuple, list or dict of them, nested) to
    finish its work: ``torch.cuda.synchronize`` of each CUDA device among
    them, nothing for CPU tensors.  The JAX package's counterpart fetches
    one scalar of the state to the host as its barrier."""
    devices, todo = set(), [state]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            todo.extend(getattr(x, f.name) for f in dataclasses.fields(x))
        elif isinstance(x, dict):
            todo.extend(x.values())
        elif isinstance(x, (tuple, list)):
            todo.extend(x)
    for d in devices:
        torch.cuda.synchronize(d)


def user_tensor(a, dtype, device):
    """A caller's array as a new tensor of ``dtype`` on ``device``: a
    tensor as it is (on any device, the port's own card tensors too),
    anything else through ``numpy.asarray``.  A copy in either case, so
    the model never shares memory with the caller (a hand-over passes a
    view of another model's state)."""
    if isinstance(a, torch.Tensor):
        return a.detach().to(device=device, dtype=dtype, copy=True)
    return torch.as_tensor(
        np.asarray(a).astype(sf.numpy_dtype(dtype))).to(device)


def warm_start(A, dtype, device):
    """A warm start ``Y0``/``U0`` in the internal layout as
    :func:`user_tensor` copies, a tuple of them for a problem with
    several blocks; None stays None."""
    if A is None:
        return None
    if isinstance(A, (tuple, list)):
        return tuple(user_tensor(a, dtype, device) for a in A)
    return user_tensor(A, dtype, device)


def _state_dict(state):
    """A solver state as numpy arrays (the layout of the JAX package's
    ``state_dict()``)."""
    out = {}
    for k, v in state._asdict().items():
        if isinstance(v, torch.Tensor):
            out[k] = v.detach().cpu().numpy()
        elif k == "extra":
            out[k] = _unflatten(v, iter([_numpy(e) for e in _leaves(v)]))
        else:
            out[k] = np.array(v, copy=True)
    return out


def _leaves(x):
    """The leaves of ``x`` in JAX's pytree order: a tuple or list by
    position, a dict by sorted key, ``None`` none, anything else one."""
    if x is None:
        return []
    if isinstance(x, (tuple, list)):
        return [v for e in x for v in _leaves(e)]
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    return [x]


def _unflatten(like, it):
    """``like``'s structure filled from the iterator of leaves ``it``."""
    if like is None:
        return None
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(e, it) for e in like)
    if isinstance(like, dict):
        return {k: _unflatten(like[k], it) for k in sorted(like)}
    return next(it)


def _numpy(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _save_pytree(path, state):
    """Write a solver state to an ``.npz`` file as the JAX package's
    ``_save_pytree`` does: its leaves, in the state's field order, as
    ``leaf0``, ``leaf1``, ... beside their count ``__n__``."""
    leaves = _leaves(tuple(state))
    np.savez(path, __n__=len(leaves),
             **{f"leaf{i}": _numpy(v) for i, v in enumerate(leaves)})


def _load_pytree(path, like):
    """The fields of a state written by :func:`_save_pytree` (by either
    package) as a dict of numpy arrays, given a state ``like`` of the
    same structure."""
    with np.load(path) as npz:
        n = int(npz["__n__"])
        if n != len(_leaves(tuple(like))):
            raise ValueError(f"{path} holds {n} leaves; this model's state "
                             f"has {len(_leaves(tuple(like)))}")
        leaves = iter([npz[f"leaf{i}"] for i in range(n)])
        return dict(zip(like._fields, _unflatten(tuple(like), leaves)))


def _display_stats(its, file=None):
    """Print an :class:`IterStats` as a table, as the JAX package's
    ``_display_stats`` prints it."""
    names = list(its._names)
    widths = [max(9, len(n) + 1) for n in names]
    hdr = "".join(n.rjust(w) for n, w in zip(names, widths))
    print(hdr, file=file)
    print("-" * len(hdr), file=file)
    for i in range(len(its)):
        row = []
        for name, w in zip(names, widths):
            v = getattr(its, name)[i]
            row.append((str(int(v)) if name == "Iter" else f"{v:.2e}")
                       .rjust(w))
        print("".join(row), file=file)


class _Model:
    """The stateful shell shared by the ADMM and PGM model bases.
    Subclasses set ``cfg``, ``params``, ``opts``, ``state`` and
    ``device`` in ``__init__`` and implement :meth:`_solve_state`.
    Constructors accept a reference-style option dict as ``opt`` (see
    :mod:`sporco_tpu_torch.refopts`)."""

    STAT_NAMES = ()

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        refopts.wrap_init(cls)

    def __init__(self):
        self.timer = Timer(["init", "solve"])
        self.timer.start("init")
        self.k_start = 0

    def _init_done(self):
        self.timer.stop("init")

    def _solve_state(self):
        raise NotImplementedError

    def solve(self):
        """Run (or resume) the solve; returns the minimiser in the
        reference's output layout.  Re-entrant: the state carries the
        iteration counter."""
        self.k_start = int(self.state.k)
        self.timer.start("solve")
        self.state = self._solve_state()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timer.stop("solve")
        return self.getmin()

    @property
    def itstat(self):
        return self.getitstat()

    def state_dict(self):
        """Snapshot of the solver state as numpy arrays (the layout of
        the JAX package's ``state_dict()``)."""
        return _state_dict(self.state)

    def load_state(self, d):
        """Restore a snapshot written by :meth:`state_dict`."""
        self.load_state_dict_numpy(d)

    def save_state(self, path):
        """Checkpoint the solver state to an ``.npz`` file in the JAX
        package's layout (the state's fields in order, the arrays in the
        internal layout): the JAX package's ``load_state_file`` resumes
        it, and so does this one."""
        _save_pytree(path, self.state)

    def load_state_file(self, path):
        """Restore a checkpoint written by :meth:`save_state` of either
        package; the arrays go to the model's device."""
        self.load_state_dict_numpy(_load_pytree(path, self.state))

    def solve_chunked(self, callback, chunk=10, max_chunks=None):
        """Solve in chunks of ``chunk`` iterations, calling
        ``callback(model)`` after each (the reference's per-iteration
        ``Callback`` option, ``sporco/admm/admm.py:148``, at chunk
        granularity); a callback that returns True stops the solve.
        Returns the minimiser."""
        opts = self.opts
        nch = (-(-opts.max_iter // chunk) if max_chunks is None
               else max_chunks)
        self.opts = dataclasses.replace(opts, max_iter=chunk)
        try:
            for _ in range(nch):
                self.solve()
                if callback(self):
                    break
        finally:
            self.opts = opts
        return self.getmin()

    def display(self, file=None):
        """Print the stats of the most recent solve as a table (the
        reference's Verbose display, ``sporco/common.py:230``)."""
        _display_stats(self.getitstat(), file=file)

    def _tensor(self, a, dtype=torch.float32):
        """A numpy array (or a tuple of them) as a new tensor (a tuple of
        them) of ``dtype`` on the model's device."""
        if isinstance(a, (tuple, list)):
            return tuple(self._tensor(e, dtype) for e in a)
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)


class PGMModel(_Model):
    """Base for PGM-driven model classes (counterpart of the JAX
    package's ``PGMModel``)."""

    REF_OPT_EXTRA = refopts.PGM_BASE

    def getmin(self):
        return self.state.X

    def getitstat(self):
        """Per-iteration statistics of the most recent ``solve`` call."""
        return _pgm.pgm_iterstats(self.STAT_NAMES, self.state,
                                  self.k_start)

    def load_state_dict_numpy(self, d):
        """Load a PGM state given as numpy arrays: the port's own
        :meth:`state_dict`, or the JAX package's ``state_dict()`` after
        ``numpy.asarray`` of each entry.  Every array becomes a buffer of
        its own (the fused FISTA loop updates its packed copies in
        place); the scalars take the problem's scalar type."""
        ft = _admm.scalar_type(self.opts.dtype)

        def scalar(name):
            return ft(d[name])

        def arr(name):
            return self._tensor(d[name], self.opts.dtype)
        self.state = _pgm.PGMState(
            X=arr("X"), Y=arr("Y"), Xprv=arr("Xprv"), Gprv=arr("Gprv"),
            Zrb=arr("Zrb"), t=scalar("t"), Tk=scalar("Tk"),
            L=scalar("L"), k=np.int32(d["k"]), rsdl=scalar("rsdl"),
            objprv=scalar("objprv"),
            stats=np.array(d["stats"], np.float32, copy=True))


class ADMMModel(_Model):
    """Base for ADMM-driven model classes.  Subclasses also set
    ``problem`` (an :class:`~sporco_tpu_torch.solvers.admm.ADMMProblem`),
    which the generic solve runs."""

    REF_OPT_EXTRA = refopts.ADMM_BASE

    def _solve_state(self):
        return _admm.admm_solve(self.problem, self.cfg, self.params,
                                self.opts, self.state)

    def getmin(self):
        return self.state.Y

    def getitstat(self):
        """Per-iteration statistics of the most recent ``solve`` call."""
        return _admm.iterstats(_admm.stat_names(self.STAT_NAMES),
                               self.state, self.k_start)

    def load_state_dict_numpy(self, d):
        """Load a solver state given as numpy arrays: the port's own
        :meth:`state_dict`, or the JAX package's ``state_dict()`` after
        ``numpy.asarray`` of each entry, from the fused or the generic
        path.  X, Y and U are in the internal layout in both packages
        (a CSC model's ``(K, Cx, M, N0, N1)``; a tuple of arrays for a
        problem with two constraint blocks) and take the problem's
        dtype; the scalars take its scalar type."""
        ft = _admm.scalar_type(self.opts.dtype)
        dt = self.opts.dtype
        self.state = _admm.ADMMState(
            X=self._tensor(d["X"], dt), Y=self._tensor(d["Y"], dt),
            U=self._tensor(d["U"], dt),
            rho=ft(d["rho"]), rho_xi=ft(d["rho_xi"]), k=np.int32(d["k"]),
            r=ft(d["r"]), s=ft(d["s"]), epri=ft(d["epri"]),
            edua=ft(d["edua"]),
            stats=np.array(d["stats"], np.float32, copy=True),
            extra=self._extra_tensors(d.get("extra", ())))

    def _extra_tensors(self, extra):
        """A problem's extra carry (the inhibition weights of
        ``ConvBPDNInhib``) with each array as a tensor of the problem's
        dtype on the model's device, in the carry's structure."""
        return _unflatten(extra, iter([self._tensor(e, self.opts.dtype)
                                       for e in _leaves(extra)]))


def default_rho_xi(lmbda):
    """Default AutoRho residual-ratio target xi as a function of lambda
    (Sec. VI.C of wohlberg-2015-adaptive; ``sporco/admm/bpdn.py:424``)."""
    if lmbda is None or lmbda == 0.0:
        return 1.0
    return float(1.0 + 18.3 ** (math.log10(float(lmbda)) + 1.0))
