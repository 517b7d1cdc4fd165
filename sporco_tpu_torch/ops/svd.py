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
rows of length ``L``) or :data:`SWEEP_CAP` sweeps have run.  A sweep is a
round-robin over blocks of ``w`` rows; a round gives each pair of blocks
to a cluster of ``C`` thread blocks, which sum the pair's Gram matrix
over their slices of the rows, rotate pairs of its ``2 w`` rows on it
(in a sweep's first round every pair of them, in the others each row of
one block with each row of the other, so that a sweep visits every pair
of rows once) and apply the product of the rotations to the rows
(``csrc/jacobi_svd.cu``; :func:`geometry` chooses ``w``, ``C`` and the
route from the shape).  It works in float64 whatever the input's type,
and rounds its outputs to that type: a float32 Jacobi SVD's thousands of
rotations a row leave its singular values about 16 times further off
than LAPACK's float32 SVD, enough to move Robust PCA's float32 objective
(PERF.md).  On CPU tensors it runs :func:`jacobi_svd_plain`, the same
schedule in PyTorch.  On the card it has two forms, of the same
kernels:

- "node": inside a CUDA-graph capture (the device loop's captured
  iteration) and its eager warm-up, the set-up kernels and a WHILE node
  (``device_loop.while_``) whose body is one sweep; nothing is read on the
  host.  In a device loop's iteration (``device_loop.outer``) no sweep
  runs where the iteration is dead, and the sweeps are added into the
  loop's counter of inner passes.
- "eager": elsewhere on the card, the same launches with each sweep's
  flag read on the host, as :func:`jacobi_svd_plain` reads it.

Where a cluster's slices of a pair of row blocks do not fit its blocks'
shared memory (:func:`shared_rows`), the kernel reads the rows where they
lie in global memory instead, with the same arithmetic: every shape has
a route.  Every launch of ``jac_round`` adds one to a counter on the
device (:func:`launches`).

The QR of the randomized form needs nothing of this kind:
``torch.linalg.qr`` on the card (cuSOLVER's ``geqrf`` and ``orgqr``)
checks no status on the host and captures as it is (PERF.md).

``float32``, ``float64``, ``complex64`` and ``complex128`` matrices,
batched over leading axes (a loop over the batch).  A complex matrix
takes the same schedule in complex double (``complex64`` results
rounded), through the kernels' complex form (``jac_round<w, SH, true>``,
launched by ``jac_round_z_launch``): its rows'
Gram matrices are Hermitian, ``G = X X^H``, a pair is tested on
``|g_ij|`` and rotated by the real rotation of ``(g_ii, g_jj, |g_ij|)``
with the phase of ``g_ij`` on the off-diagonal entries.  That form runs
the real form's clusters, slices and tensor-core tiles on the rows read
as rows of doubles (each entry's real and imaginary parts side by side),
in clusters of any size (:func:`geometry`).  ``vt`` is ``V^H``: ``u
diag(s) vt`` is ``a``.
"""

import collections
import ctypes
import math

import torch

__all__ = ["svd", "svd_plain", "jacobi_svd", "jacobi_svd_plain",
           "prepare", "geometry", "shared_rows", "Geometry",
           "launches", "reset_launches", "LAST", "SWEEP_CAP"]

# sweeps at most, as LAPACK's xGESVJ
SWEEP_CAP = 30
# rows of a block: a cluster takes two blocks of w rows (8 the fastest at
# 512 x 512 on an H100, PERF.md; the kernels take 1, 2, 4, 8)
MAX_W = 8
# blocks of a cluster at most (csrc/jacobi_svd.cu kMaxCluster; above 8 a
# non-portable cluster size, which the H100 runs)
MAX_C = 16
# the SMs a round's blocks should cover (an H100 SXM's 132)
SMS = 132
# the complex form's: clusters of any size up to MAX_C, on at most 96 SMs
# (the card places a cluster's blocks within one GPC, and holds 30
# clusters of 4 at one block an SM, not 33: where the blocks do not fit
# at one an SM, some SMs take two and the launch waits for them; PERF.md
# §6)
CLUSTER_SMS = 96
# columns of a block's slice of the rows at least, where C is chosen to
# cover the SMs
MIN_SPAN = 64
# dynamic shared memory of a jac_round block at most and its warps
# (csrc/jacobi_svd.cu kSmemMax, kWarps; a launch on the shared route
# whose slices exceed kSmemMax fails)
SMEM_MAX = 220 * 1024
WARPS = 8

# P rows of length L (the shorter side's), blocks of w rows padded to Pp,
# clusters of C blocks, the rows' slices in shared memory or not
Geometry = collections.namedtuple("Geometry", "P L w Pp C shared")

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


def _span(L, C):
    """Columns of a block's slice of rows of length ``L`` cut in ``C``, a
    multiple of 4 (``csrc/jacobi_svd.cu`` ``span_of``)."""
    return (-(-L // C) + 3) // 4 * 4


def _stride(span):
    """Doubles from one row of a slice to the next in a block's shared
    memory (``csrc/jacobi_svd.cu`` ``stride_of``)."""
    return (span + 15) // 16 * 16 + 4


def _head(w, e=1):
    """Doubles of a ``jac_round`` block's shared memory before its slices:
    its partial Gram, G, R, the inner round's rotations and the warps'
    partial Grams, for entries of ``e`` doubles (2 for the complex form)
    (``csrc/jacobi_svd.cu`` ``head_doubles``; on the shared route the
    slice of the pair's rows of Q follows W's where it fits)."""
    return (3 + WARPS) * e * 4 * w * w + 2 * (e + 1) * w


def shared_rows(L, w, C=1, itemsize=8):
    """Whether a block's slice of two blocks of ``w`` rows of length
    ``L``, cut in ``C``, fits :data:`SMEM_MAX` beside its Gram buffers;
    where it does not, the kernel reads the rows in global memory.  The
    rows' element is a float64 (``itemsize`` 8) or, for the complex form,
    a complex128 (16), two doubles."""
    e = itemsize // 8
    return (_head(w, e) + 2 * w * _stride(e * _span(L, C))) * 8 \
        <= SMEM_MAX


def geometry(m, n, itemsize=8):
    """The :class:`Geometry` of the Jacobi SVD of an ``m x n`` matrix,
    from its shape and the working element's size (8, float64; 16,
    complex128): ``P`` rows of length ``L`` (the shorter side's),
    blocks of ``w`` rows (at most :data:`MAX_W` and no more than half the
    rows rounded up to a power of two), the rows padded to ``Pp``, a
    multiple of ``2 w``; clusters of ``C`` blocks: the most whose blocks
    (``Pp / 2w`` pairs a round times ``C``) fit :data:`SMS` with slices
    of at least :data:`MIN_SPAN` columns, a power of two up to
    :data:`MAX_C`, raised (doubled) where that lets the slices fit shared
    memory (``shared``); where no cluster's slices fit, ``C`` stays and
    the rows are read in global memory.  The complex form (``itemsize``
    16) takes clusters of any size up to :data:`MAX_C` on at most
    :data:`CLUSTER_SMS` SMs, by the same rule otherwise, raised by one
    at a time."""
    P, L = min(m, n), max(m, n)
    w = MAX_W
    while w > 1 and 2 * w > _next_pow2(P):
        w //= 2
    Pp = -(-P // (2 * w)) * 2 * w
    pairs = Pp // (2 * w)
    if itemsize == 16:
        C = max(1, min(MAX_C, CLUSTER_SMS // pairs))
        while C > 1 and _span(L, C) < MIN_SPAN:
            C -= 1
    else:
        C = 1
        while (C < MAX_C and pairs * 2 * C <= SMS
               and _span(L, 2 * C) >= MIN_SPAN):
            C *= 2
    c = C
    while c < MAX_C and not shared_rows(L, w, c, itemsize):
        c = c + 1 if itemsize == 16 else 2 * c
    if shared_rows(L, w, c, itemsize):
        return Geometry(P, L, w, Pp, c, True)
    return Geometry(P, L, w, Pp, C, False)


def _tol(L):
    return math.sqrt(L) * torch.finfo(torch.float64).eps


def _rr_pair(n, r, i):
    """Pair ``i`` of round ``r`` of a round-robin among ``n`` players
    (``csrc/jacobi_svd.cu`` ``rr_pair``)."""
    if i == 0:
        return r, n - 1
    return (r + i) % (n - 1), (r - i) % (n - 1)


_WORK = {torch.float32: torch.float64, torch.float64: torch.float64,
         torch.complex64: torch.complex128,
         torch.complex128: torch.complex128}


def _check(a):
    if a.dtype not in _WORK:
        raise NotImplementedError(
            f"jacobi_svd takes float32, float64, complex64 or complex128 "
            f"matrices, not {a.dtype}")
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
    rows were those of ``a^H`` (``a = Wn^H diag(s) Q``), else those of
    ``a`` (``a = Q^H diag(s) Wn``)."""
    if m >= n:
        return Wout.mH, S, Qout
    return Qout.mH, S, Wout


def _rows_of(a):
    """The matrix whose rows are rotated: ``a`` if it is wide, else
    ``a^H``."""
    m, n = a.shape
    return a if m < n else a.mH


def _sq_norms(W):
    """The squared norms of the rows of ``W``, real or complex."""
    if W.is_complex():
        return (W.real ** 2 + W.imag ** 2).sum(-1)
    return (W ** 2).sum(-1)


# ---------------------------------------------------------------------------
# The plain version: the kernels' schedule in PyTorch

def _rotation(a, b, g, tol):
    """Whether pairs with ``|x|^2 = a``, ``|y|^2 = b``, ``x.y = g`` are
    rotated and their ``(c, s)`` (``csrc/jacobi_svd.cu`` ``rotation``: a,
    b and g scaled by the power of two that brings the larger of a and b
    into [1, 2); Rutishauser's ``t = s / c = e / D``, ``D = d + sign(d)
    sqrt(d^2 + e^2)``, ``d = b - a``, ``e = 2 g``; 1 and 0 where not
    rotated)."""
    m = torch.maximum(a, b)
    one = torch.ones_like(m)
    ex = torch.frexp(torch.where(m > 0, m, one)).exponent - 1
    a, b, g = (torch.ldexp(v, -ex) for v in (a, b, g))
    do = g.abs() > tol * a.sqrt() * b.sqrt()
    d, e = b - a, 2.0 * g
    D = d + torch.copysign(torch.sqrt(d * d + e * e), d)
    q = torch.rsqrt(D * D + e * e)
    c = torch.where(do, D.abs() * q, one)
    s = torch.where(do, torch.copysign(one, D) * e * q, torch.zeros_like(m))
    return do, c, s


def _gram(X, C):
    """The Gram matrices ``X X^H`` of the pairs' rows ``X`` (pairs, 2w,
    L) as the clusters form them: each of ``C`` blocks that of its slice
    of the columns, added in rank order, the upper triangle mirrored (the
    diagonal of a complex one real)."""
    L = X.shape[-1]
    span = _span(L, C)
    G = None
    for c in range(C):
        xs = X[..., c * span:(c + 1) * span]
        part = xs @ xs.mH
        G = part if G is None else G + part
    G = G.triu() + G.triu(1).mH
    if G.is_complex():
        G.diagonal(dim1=-2, dim2=-1).imag.zero_()
    return G


def _inner_pairs(n2, cross):
    """The inner rounds' pairs of rows among a pair of row blocks (``n2 =
    2 w`` rows): the round-robin of all of them (2w - 1 rounds), or,
    ``cross``, row p of the first block with row (p + r) mod w of the
    second (w rounds) (``csrc/jacobi_svd.cu`` ``inner_pair``)."""
    w = n2 // 2
    if cross:
        return [[(p, w + (p + r) % w) for p in range(w)] for r in range(w)]
    return [[_rr_pair(n2, r, p) for p in range(w)] for r in range(n2 - 1)]


_PLAIN_IDX = {}


def _round_index(n2, cross, device):
    """Per inner round, the pairs' rows ``i``, ``j`` as index tensors on
    ``device`` (made once)."""
    key = (n2, cross, str(device))
    out = _PLAIN_IDX.get(key)
    if out is None:
        out = [(torch.tensor([p[0] for p in ij], device=device),
                torch.tensor([p[1] for p in ij], device=device))
               for ij in _inner_pairs(n2, cross)]
        _PLAIN_IDX[key] = out
    return out


def _inner_rounds(G, tol, cross=False):
    """The inner rounds (:func:`_inner_pairs`) of the pairs' rows on their
    Gram matrices ``G`` (pairs, 2w, 2w), as every block of a cluster runs
    them: a pair (i, j) of rows is rotated where ``|g_ij| > tol
    sqrt(g_ii) sqrt(g_jj)``; G becomes J G J^H for the round's rotations
    J (the identity on the pairs not rotated), with ``x'.y'`` set to 0,
    and the rotations are gathered in R = J R.  A complex pair's rotation
    is the real one of ``(g_ii, g_jj, |g_ij|)`` with the phase ``u =
    g_ij / |g_ij|``: ``x' = c x - s u y``, ``y' = s conj(u) x + c y`` (the
    diagonal of G kept real).  Returns R and whether each pair of blocks
    rotated."""
    nb, n2 = G.shape[0], G.shape[-1]
    dev, cplx = G.device, G.is_complex()
    eye = torch.eye(n2, dtype=G.dtype, device=dev).expand(nb, n2, n2)
    R = eye.clone()
    any_ = torch.zeros(nb, dtype=torch.bool, device=dev)
    for i, j in _round_index(n2, cross, dev):
        g = G[:, i, j]
        if cplx:
            mag = g.abs()
            do, c, s = _rotation(G[:, i, i].real, G[:, j, j].real, mag, tol)
            u = torch.where(do, g / torch.where(do, mag, 1.0),
                            torch.ones_like(g))
            sij, sji = -s * u, s * u.conj()
        else:
            do, c, s = _rotation(G[:, i, i], G[:, j, j], g, tol)
            sij, sji = -s, s
        c = c.to(G.dtype)
        J = eye.clone()
        J[:, i, i] = c
        J[:, i, j] = sij
        J[:, j, i] = sji
        J[:, j, j] = c
        G = J @ G @ J.mH
        z = torch.where(do, torch.zeros_like(g), G[:, i, j])
        G[:, i, j] = z
        G[:, j, i] = z.conj() if cplx else z
        if cplx:
            G.diagonal(dim1=-2, dim2=-1).imag.zero_()
        R = J @ R
        any_ |= do.any(-1)
    return R, any_


def jacobi_svd_plain(a, sweep_cap=SWEEP_CAP):
    """The Jacobi SVD of :func:`jacobi_svd` in PyTorch, round for round
    as the kernels run it (the same blocks, round-robins, slices and
    their rank-order sums, Gram inner rounds of a sweep's first round and
    of the others, threshold, sweep cap, order and NaN rule), on any
    device; it reads each sweep's flag on the host."""
    _check(a)
    return _batched(lambda x: _plain_2d(x, sweep_cap), a)


def _plain_2d(a, sweep_cap):
    m, n = a.shape
    dt, dev = a.dtype, a.device
    f64 = _WORK[dt]
    geo = geometry(m, n, f64.itemsize)
    P, L, w, Pp, C = geo[:5]
    tol = _tol(L)
    W = torch.zeros((Pp, L), dtype=f64, device=dev)
    W[:P] = _rows_of(a)
    Q = torch.eye(Pp, dtype=f64, device=dev)
    nb = Pp // w
    rows_of = [torch.tensor([[ba * w + l for l in range(w)]
                             + [bb * w + l for l in range(w)]
                             for ba, bb in (_rr_pair(nb, rnd, k)
                                            for k in range(nb // 2))],
                            device=dev) for rnd in range(nb - 1)]
    sweeps, unconverged = 0, False
    while True:
        moved = torch.zeros((), dtype=torch.bool, device=dev)
        for rnd, rows in enumerate(rows_of):
            X = W[rows]                             # (pairs, 2w, L)
            R, any_ = _inner_rounds(_gram(X, C), tol, rnd > 0)
            # R is the identity for a pair of blocks that rotated nothing
            W[rows.reshape(-1)] = (R @ X).reshape(-1, L)
            Q[rows.reshape(-1)] = (R @ Q[rows]).reshape(-1, Pp)
            moved |= any_.any()
        sweeps += 1
        if not bool(moved):
            break
        if sweeps >= sweep_cap:
            unconverged = True
            break
    LAST.clear()
    LAST.update(form="plain", sweeps=sweeps, geometry=geo)
    sig = torch.sqrt(_sq_norms(W[:P]))
    if unconverged or not bool(torch.isfinite(sig).all()):
        nan = torch.full((), complex(math.nan, math.nan) if dt.is_complex
                         else math.nan, dtype=dt, device=dev)
        return _outputs(m, n, nan.real.expand(P).clone(),
                        nan.expand(P, L).clone(), nan.expand(P, P).clone())
    order = torch.sort(sig, descending=True, stable=True).indices
    S = sig[order]
    pos = S[:, None] > 0
    d = torch.where(pos, S[:, None], 1.0)
    Wo = W[order]
    if Wo.is_complex():
        Wn = torch.complex(Wo.real / d, Wo.imag / d)
    else:
        Wn = Wo / d
    Wn = torch.where(pos, Wn, torch.zeros((), dtype=f64, device=dev))
    return _outputs(m, n, S.to(dt.to_real()), Wn.to(dt),
                    Q[order][:, :P].to(dt))


# ---------------------------------------------------------------------------
# The card

_LIB = {}
# device index -> the int64 counter of jac_round launches on that device
_COUNT = {}


def _index(device):
    """The index of a CUDA ``device`` (the current device's where it has
    none)."""
    return device.index if device.index is not None \
        else torch.cuda.current_device()


def _lib(device):
    """The kernels' library, with ``jac_init`` run on ``device`` and its
    launch counter made there."""
    device = torch.device("cuda", _index(device))
    lib = _LIB.get("lib")
    if lib is None:
        from sporco_tpu_torch.ops import _nvcc
        lib = _nvcc.load("jacobi_svd")
        V, I = ctypes.c_void_p, ctypes.c_int
        lib.jac_init.argtypes = []
        lib.jac_init.restype = I
        lib.jac_round_launch.argtypes = [V, V, V, I, I, I, I, I, I, I,
                                         ctypes.c_double, V, V]
        lib.jac_round_launch.restype = I
        lib.jac_sweep_end_launch.argtypes = [V, V, V, I]
        lib.jac_sweep_end_launch.restype = I
        lib.jac_finish_launch.argtypes = [V, V, V, V, V, I, I, I, V, V, V]
        lib.jac_finish_launch.restype = I
        lib.jac_round_z_launch.argtypes = [V, V, V, I, I, I, I, I, I, I,
                                           ctypes.c_double, V, V]
        lib.jac_round_z_launch.restype = I
        lib.jac_finish_z_launch.argtypes = [V, V, V, V, V, I, I, I, V, V, V]
        lib.jac_finish_z_launch.restype = I
        _LIB["lib"] = lib
    if device.index not in _LIB.setdefault("init", set()):
        with torch.cuda.device(device):
            err = lib.jac_init()
        if err != 0:
            raise RuntimeError(f"jacobi_svd: CUDA error {err} at set-up")
        _COUNT[device.index] = torch.zeros((), dtype=torch.int64,
                                           device=device)
        _LIB["init"].add(device.index)
    return lib


def _ck(err, what):
    if err != 0:
        raise RuntimeError(f"jacobi_svd: CUDA error {err} in {what}")


def launches(device=None):
    """The ``jac_round`` launches on ``device`` (every card where None)
    since the last :func:`reset_launches`, read from the device's
    counter (0 where the kernels were never set up)."""
    if device is not None:
        device = torch.device(device)
    return sum(int(c) for i, c in _COUNT.items()
               if device is None or _index(device) == i)


def reset_launches():
    """Set every device's counter of ``jac_round`` launches to 0."""
    for c in _COUNT.values():
        c.zero_()


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
        work = _WORK[dtype]
        self.complex = work.is_complex
        self.geo = geometry(m, n, work.itemsize)
        self.P, self.L, self.w, self.Pp, self.C = self.geo[:5]
        P, L, Pp = self.P, self.L, self.Pp
        self.tol = _tol(L)
        self.lib = _lib(device)
        self.count = _COUNT[_index(device)]

        def E(*shape, dt=torch.float64):
            return torch.empty(shape, dtype=dt, device=device)
        self.W, self.Q = E(Pp, L, dt=work), E(Pp, Pp, dt=work)
        self.sig, self.S = E(P), E(P)
        self.Wout, self.Qout = E(P, L, dt=work), E(P, P, dt=work)
        self.status = E(3, dt=torch.int32)
        self.more = E(dt=torch.bool)

    def sweep(self):
        s = torch.cuda.current_stream(self.device).cuda_stream
        head = (s, self.W.data_ptr(), self.Q.data_ptr(), self.Pp, self.L,
                self.w, self.C, int(self.geo.shared))
        launch = (self.lib.jac_round_z_launch if self.complex
                  else self.lib.jac_round_launch)
        for rnd in range(self.Pp // self.w - 1):
            _ck(launch(*head, rnd, int(rnd > 0),
                       self.tol, self.status.data_ptr(),
                       self.count.data_ptr()), "jac_round")
        _ck(self.lib.jac_sweep_end_launch(s, self.status.data_ptr(),
                                          self.more.data_ptr(), SWEEP_CAP),
            "jac_sweep_end")

    def run(self, a):
        from sporco_tpu_torch.ops import device_loop
        device_loop.stage("jacobi_svd")
        gate = device_loop.outer()
        P = self.P
        self.W[:P].copy_(_rows_of(a))
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
        finish = (self.lib.jac_finish_z_launch if self.complex
                  else self.lib.jac_finish_launch)
        _ck(finish(
            torch.cuda.current_stream(self.device).cuda_stream,
            self.W.data_ptr(), self.Q.data_ptr(), self.sig.data_ptr(),
            self.status.data_ptr(), P, self.Pp, self.L, self.S.data_ptr(),
            self.Wout.data_ptr(), self.Qout.data_ptr()), "jac_finish")
        if gate is not None:
            gate[1].add_(self.status[1])

    def outputs(self):
        return _outputs(self.m, self.n, self.S.to(self.dtype.to_real()),
                        self.Wout.to(self.dtype), self.Qout.to(self.dtype))


def jacobi_svd(a):
    """``(u, s, vt)`` of ``a`` by the one-sided Jacobi SVD: the kernels on
    a CUDA tensor (a ``float32``, ``float64``, ``complex64`` or
    ``complex128`` matrix, or a batch of them), :func:`jacobi_svd_plain`
    on the CPU (see the module's docstring).  A zero singular value's
    vector on the side of the rotated rows (``u`` for m >= n, ``v`` for
    m < n) is zero."""
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
                geometry=st.geo)
    return st.outputs()
