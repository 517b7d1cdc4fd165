"""The thin SVD of the nuclear prox (``ops/prox.py`` ``prox_nuclear``),
with no host synchronisation on the card.

:func:`svd` gives ``(u, s, vt)`` of ``a`` (``full_matrices=False``, the
singular values in descending order).  On CPU tensors it is
:func:`svd_plain`, ``torch.linalg.svd``; on CUDA tensors it is
:func:`jacobi_svd`, whose kernels (``csrc/jacobi_svd.cu``) leave their
status on the device: ``torch.linalg.svd`` reads cuSOLVER's ``info`` on
the host, so an iteration that calls it cannot be captured as a CUDA
graph, and cuSOLVER's ``gesvdj`` and ``gesvd`` called through a C
interface with device ``info`` do not capture either (PERF.md).
A decomposition that fails (a non-finite input, or sweeps that stop at
:data:`SWEEP_CAP` unconverged) gives NaN in every output, XLA's
convention for the JAX package's ``jnp.linalg.svd``.

:func:`jacobi_svd` is a one-sided (Hestenes) Jacobi SVD, as XLA's SVD on
the TPU is: the rows of ``a`` or of ``a^T``, whichever are the shorter,
are made orthogonal by plane rotations in sweeps over every pair, until
a sweep rotates none (``|x.y| <= tol |x| |y|``, ``tol = sqrt(L) eps`` for
rows of length ``L``) or :data:`SWEEP_CAP` sweeps have run.  It works in
float64 whatever the input's type, and rounds its outputs to that type:
a float32 Jacobi SVD's thousands of rotations a row leave its singular
values about 16 times further off than LAPACK's float32 SVD, enough to
move Robust PCA's float32 objective (PERF.md).  On CPU tensors it runs
:func:`jacobi_svd_plain`, the same schedule in PyTorch.  On the card it
has two forms, of the same kernels:

- "node": inside a CUDA-graph capture (the device loop's captured
  iteration) and its eager warm-up, the set-up kernels and a WHILE node
  (``device_loop.while_``) whose body is one sweep; nothing is read on the
  host.  In a device loop's iteration (``device_loop.outer``) no sweep
  runs where the iteration is dead, and the sweeps are added into the
  loop's counter of inner passes.
- "eager": elsewhere on the card, the same launches with each sweep's
  flag read on the host, as :func:`jacobi_svd_plain` reads it.

Where two blocks of rows do not fit a block's shared memory
(:func:`shared_rows`: rows longer than 12,798), the kernel rotates them
where they lie in global memory, with the same arithmetic: every shape
has a route.

The QR of the randomized form needs nothing of this kind:
``torch.linalg.qr`` on the card (cuSOLVER's ``geqrf`` and ``orgqr``)
checks no status on the host and captures as it is (PERF.md).

Real ``float32`` and ``float64`` matrices, batched over leading axes (a
loop over the batch); a complex CUDA tensor raises.
"""

import ctypes
import math

import torch

__all__ = ["svd", "svd_plain", "jacobi_svd", "jacobi_svd_plain",
           "prepare", "geometry", "shared_rows", "LAST", "SWEEP_CAP"]

# sweeps at most, as LAPACK's xGESVJ
SWEEP_CAP = 30
# rows of a block: a jac_round block takes two blocks of w rows (8 the
# fastest at 512 x 512 on an H100, PERF.md; the kernels take 1, 2, 4, 8)
MAX_W = 8
# dynamic shared memory of a jac_round block at most (csrc/jacobi_svd.cu
# kSmemMax)
SMEM_MAX = 200 * 1024

# the last call: its form, geometry and status tensor (int32 on the
# device: rotating blocks of the last sweep, sweeps, not converged)
LAST = {}


def svd_plain(a):
    """``torch.linalg.svd(a, full_matrices=False)``."""
    return torch.linalg.svd(a, full_matrices=False)


def svd(a):
    """``(u, s, vt)`` of ``a`` with ``full_matrices=False``:
    :func:`svd_plain` on the CPU, :func:`jacobi_svd` on the card."""
    if a.device.type == "cpu":
        return svd_plain(a)
    return jacobi_svd(a)


def _next_pow2(n):
    return 1 << max(0, int(n) - 1).bit_length()


def shared_rows(L, w):
    """Whether a ``jac_round`` block's two blocks of ``w`` float64 rows of
    length ``L`` fit :data:`SMEM_MAX` beside their rotations; where they
    do not, the kernel rotates the rows in global memory."""
    return (2 * w * L + 4 * w * w) * 8 <= SMEM_MAX


def geometry(m, n):
    """``(P, L, w, Pp)`` of the Jacobi SVD of an ``m x n`` matrix: ``P``
    rows of length ``L`` (the shorter side's), blocks of ``w`` rows (at
    most :data:`MAX_W` and no more than half the rows rounded up to a
    power of two; the largest such whose two blocks of rows fit
    :data:`SMEM_MAX`, or, where even two rows do not, the largest such,
    its rows in global memory), the rows padded to ``Pp``, a multiple of
    ``2 w``."""
    P, L = min(m, n), max(m, n)
    w = MAX_W
    while w > 1 and 2 * w > _next_pow2(P):
        w //= 2
    if shared_rows(L, 1):
        while not shared_rows(L, w):
            w //= 2
    Pp = -(-P // (2 * w)) * 2 * w
    return P, L, w, Pp


def _tol(L):
    return math.sqrt(L) * torch.finfo(torch.float64).eps


def _rr_pair(n, r, i):
    """Pair ``i`` of round ``r`` of a round-robin among ``n`` players
    (``csrc/jacobi_svd.cu`` ``rr_pair``)."""
    if i == 0:
        return r, n - 1
    return (r + i) % (n - 1), (r - i) % (n - 1)


def _check(a):
    if a.dtype not in (torch.float32, torch.float64):
        raise NotImplementedError(
            f"jacobi_svd takes float32 or float64 matrices, not {a.dtype}")
    if a.ndim < 2 or 0 in a.shape[-2:]:
        raise ValueError(f"jacobi_svd needs matrices, not shape "
                         f"{tuple(a.shape)}")


def _batched(fn, a):
    """``fn`` over the matrices of ``a``'s leading axes, stacked."""
    if a.ndim == 2:
        return fn(a)
    lead = a.shape[:-2]
    parts = [fn(x) for x in a.reshape((-1,) + tuple(a.shape[-2:]))]
    return tuple(torch.stack([p[i] for p in parts]).reshape(
        lead + parts[0][i].shape) for i in range(3))


def _outputs(m, n, S, Wout, Qout):
    """``(u, s, vt)`` from the sorted norms and rows: for ``m >= n`` the
    rows were those of ``a^T`` (``a = Wn^T diag(s) Q``), else those of
    ``a`` (``a = Q^T diag(s) Wn``)."""
    if m >= n:
        return Wout.mT, S, Qout
    return Qout.mT, S, Wout


# ---------------------------------------------------------------------------
# The plain version: the kernels' schedule in PyTorch

def _dots(x, y):
    """``|x|^2``, ``|y|^2`` and ``x.y`` over the last axis, as the kernel
    forms them: each of 32 lanes sums every 32nd product, then the lanes'
    parts are summed."""
    L = x.shape[-1]
    pad = -L % 32
    if pad:
        x = torch.nn.functional.pad(x, (0, pad))
        y = torch.nn.functional.pad(y, (0, pad))
    xs = x.reshape(x.shape[:-1] + (-1, 32))
    ys = y.reshape(y.shape[:-1] + (-1, 32))
    return tuple((u * v).sum(-2).sum(-1)
                 for u, v in ((xs, xs), (ys, ys), (xs, ys)))


def _rotation(a, b, g):
    """``(c, s)`` of the rotations of pairs with ``|x|^2 = a``, ``|y|^2 =
    b``, ``x.y = g`` (``csrc/jacobi_svd.cu`` ``rotation``)."""
    zeta = (b - a) / (2.0 * g)
    one = torch.ones_like(zeta)
    t = torch.where(zeta.abs() > 1e150, 0.5 / zeta,
                    torch.copysign(one, zeta)
                    / (zeta.abs() + torch.sqrt(1.0 + zeta * zeta)))
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, c * t


def jacobi_svd_plain(a, sweep_cap=SWEEP_CAP):
    """The Jacobi SVD of :func:`jacobi_svd` in PyTorch, round for round
    as the kernels run it (the same blocks, round-robins, rotations,
    threshold, sweep cap, order and NaN rule), on any device; it reads
    each sweep's flag on the host."""
    _check(a)
    return _batched(lambda x: _plain_2d(x, sweep_cap), a)


def _plain_2d(a, sweep_cap):
    m, n = a.shape
    dt, dev = a.dtype, a.device
    f64 = torch.float64
    P, L, w, Pp = geometry(m, n)
    tol = _tol(L)
    W = torch.zeros((Pp, L), dtype=f64, device=dev)
    W[:P] = a if m < n else a.mT
    Q = torch.eye(Pp, dtype=f64, device=dev)
    nb, n2 = Pp // w, 2 * w
    inner = [[_rr_pair(n2, r, k) for k in range(w)] for r in range(n2 - 1)]
    sweeps, unconverged = 0, False
    while True:
        moved = False
        for rnd in range(nb - 1):
            pairs = [_rr_pair(nb, rnd, k) for k in range(nb // 2)]
            rows = torch.tensor([[ba * w + l for l in range(w)]
                                 + [bb * w + l for l in range(w)]
                                 for ba, bb in pairs], device=dev)
            sw = W[rows]                            # (blocks, 2w, L)
            R = torch.eye(n2, dtype=f64, device=dev).expand(
                len(pairs), n2, n2).clone()
            any_ = torch.zeros(len(pairs), dtype=torch.bool, device=dev)
            for ij in inner:
                i = torch.tensor([p[0] for p in ij], device=dev)
                j = torch.tensor([p[1] for p in ij], device=dev)
                x, y = sw[:, i], sw[:, j]
                rx, ry = R[:, i], R[:, j]
                al, be, ga = _dots(x, y)
                do = ga.abs() > tol * al.sqrt() * be.sqrt()
                c, s = _rotation(al, be, ga)
                c, s = c[..., None], s[..., None]
                keep = do[..., None]
                sw[:, i] = torch.where(keep, c * x - s * y, x)
                sw[:, j] = torch.where(keep, s * x + c * y, y)
                R[:, i] = torch.where(keep, c * rx - s * ry, rx)
                R[:, j] = torch.where(keep, s * rx + c * ry, ry)
                any_ |= do.any(-1)
            if bool(any_.any()):
                moved = True
                rw = rows[any_]
                W[rw.reshape(-1)] = sw[any_].reshape(-1, L)
                Q[rw.reshape(-1)] = (R[any_] @ Q[rw]).reshape(-1, Pp)
        sweeps += 1
        if not moved:
            break
        if sweeps >= sweep_cap:
            unconverged = True
            break
    LAST.clear()
    LAST.update(form="plain", sweeps=sweeps, geometry=(P, L, w, Pp))
    sig = torch.sqrt((W[:P] ** 2).sum(-1))
    if unconverged or not bool(torch.isfinite(sig).all()):
        nan = torch.full((), math.nan, dtype=dt, device=dev)
        return _outputs(m, n, nan.expand(P).clone(), nan.expand(P, L).clone(),
                        nan.expand(P, P).clone())
    order = torch.sort(sig, descending=True, stable=True).indices
    S = sig[order]
    Wn = torch.where(S[:, None] > 0, W[order] / S[:, None],
                     torch.zeros((), dtype=f64, device=dev))
    return _outputs(m, n, *(t.to(dt) for t in (S, Wn, Q[order][:, :P])))


# ---------------------------------------------------------------------------
# The card

_LIB = {}


def _lib(device):
    """The kernels' library, with ``jac_init`` run on ``device``."""
    lib = _LIB.get("lib")
    if lib is None:
        from sporco_tpu_torch.ops import _nvcc
        lib = _nvcc.load("jacobi_svd")
        V, I = ctypes.c_void_p, ctypes.c_int
        lib.jac_init.argtypes = []
        lib.jac_init.restype = I
        lib.jac_smem_max.argtypes = []
        lib.jac_smem_max.restype = I
        lib.jac_round_launch.argtypes = [V, V, V, I, I, I, I,
                                         ctypes.c_double, V]
        lib.jac_round_launch.restype = I
        lib.jac_sweep_end_launch.argtypes = [V, V, V, I]
        lib.jac_sweep_end_launch.restype = I
        lib.jac_finish_launch.argtypes = [V, V, V, V, V, I, I, I, V, V, V]
        lib.jac_finish_launch.restype = I
        if lib.jac_smem_max() != SMEM_MAX:
            raise RuntimeError("jacobi_svd: the library's shared memory "
                               "limit is not ops/svd.py's SMEM_MAX")
        _LIB["lib"] = lib
    if device.index not in _LIB.setdefault("init", set()):
        with torch.cuda.device(device):
            err = lib.jac_init()
        if err != 0:
            raise RuntimeError(f"jacobi_svd: CUDA error {err} at set-up")
        _LIB["init"].add(device.index)
    return lib


def _ck(err, what):
    if err != 0:
        raise RuntimeError(f"jacobi_svd: CUDA error {err} in {what}")


def prepare(device):
    """Build and load the kernels for ``device`` (a CUDA device) before
    any capture: a model whose iteration calls :func:`jacobi_svd` does
    so at set-up.  Nothing on the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        _lib(device)


class _State:
    """The tensors of one SVD on the card and its launches."""

    def __init__(self, m, n, dtype, device):
        self.m, self.n, self.dtype, self.device = m, n, dtype, device
        self.P, self.L, self.w, self.Pp = geometry(m, n)
        P, L, Pp = self.P, self.L, self.Pp
        self.tol = _tol(L)
        self.lib = _lib(device)

        def E(*shape, dt=torch.float64):
            return torch.empty(shape, dtype=dt, device=device)
        self.W, self.Q = E(Pp, L), E(Pp, Pp)
        self.sig, self.S = E(P), E(P)
        self.Wout, self.Qout = E(P, L), E(P, P)
        self.status = E(3, dt=torch.int32)
        self.more = E(dt=torch.bool)

    def sweep(self):
        s = torch.cuda.current_stream(self.device).cuda_stream
        for rnd in range(self.Pp // self.w - 1):
            _ck(self.lib.jac_round_launch(
                s, self.W.data_ptr(), self.Q.data_ptr(), self.Pp,
                self.L, self.w, rnd, self.tol, self.status.data_ptr()),
                "jac_round")
        _ck(self.lib.jac_sweep_end_launch(s, self.status.data_ptr(),
                                          self.more.data_ptr(), SWEEP_CAP),
            "jac_sweep_end")

    def run(self, a):
        from sporco_tpu_torch.ops import device_loop
        device_loop.stage("jacobi_svd")
        gate = device_loop.outer()
        P = self.P
        self.W[:P].copy_(a if self.m < self.n else a.mT)
        if self.Pp > P:
            self.W[P:].zero_()
        self.Q.zero_()
        self.Q.diagonal().fill_(1.0)
        self.status.zero_()
        if gate is None:
            self.more.fill_(True)
        else:
            self.more.copy_(gate[0])
        device_loop.while_(self.more, self.sweep)
        _ck(self.lib.jac_finish_launch(
            torch.cuda.current_stream(self.device).cuda_stream,
            self.W.data_ptr(), self.Q.data_ptr(), self.sig.data_ptr(),
            self.status.data_ptr(), P, self.Pp, self.L, self.S.data_ptr(),
            self.Wout.data_ptr(), self.Qout.data_ptr()), "jac_finish")
        if gate is not None:
            gate[1].add_(self.status[1])

    def outputs(self):
        return _outputs(self.m, self.n, *(t.to(self.dtype) for t in
                                          (self.S, self.Wout, self.Qout)))


def jacobi_svd(a):
    """``(u, s, vt)`` of ``a`` by the one-sided Jacobi SVD: the kernels on
    a CUDA tensor (a ``float32`` or ``float64`` matrix, or a batch of
    them), :func:`jacobi_svd_plain` on the CPU (see the module's
    docstring).  A zero singular value's vector on the side of the
    rotated rows (``u`` for m >= n, ``v`` for m < n) is zero."""
    if a.device.type == "cpu":
        return jacobi_svd_plain(a)
    if a.device.type != "cuda":
        raise ValueError(f"jacobi_svd: no route for device {a.device}")
    _check(a)
    return _batched(_card_2d, a)


def _card_2d(a):
    from sporco_tpu_torch.ops import device_loop
    m, n = a.shape
    node = torch.cuda.is_current_stream_capturing() or device_loop._WARM[0]
    st = _State(m, n, a.dtype, a.device)
    st.run(a)
    LAST.clear()
    LAST.update(form="node" if node else "eager", status=st.status,
                geometry=(st.P, st.L, st.w, st.Pp))
    return st.outputs()
