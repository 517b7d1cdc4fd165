"""Linear-algebra helpers of the DFT-domain solvers (counterpart of
``sporco_tpu.ops.linalg``): broadcast inner products, the per-bin
Sherman-Morrison solves of single-channel CSC, the iterated
Sherman-Morrison solve of colour-dictionary CSC, conjugate gradient
for the dictionary update's x-step, the dense solves of ``A^T A + rho I``
and ``A A^T + rho I`` (by an eigendecomposition of the Gram matrix that
serves every rho, by Cholesky and by LU, all on ``torch.linalg``), the
relative residual ``rrs``, the explicit-inverse solve ``solvemdbi_rsm``
and the helpers of validation and of product dictionaries: ``valid_adjoint``,
``block_circulant``, ``solve_symmetric_sylvester``, ``pca``, ``nkp``,
``kpsvd`` and ``proj_l2ball``."""

from typing import NamedTuple

import numpy as np
import torch

from sporco_tpu_torch._device import fp32_precision, resolve_device
# re-exported, as the JAX package's ops.linalg does
from sporco_tpu_torch.ops.prox import zdivide

__all__ = ["inner", "dot", "solvedbi_sm", "solvedbi_sm_c", "solvedbd_sm",
           "solvedbd_sm_c", "solvemdbi_ism", "cg", "solvemdbi_cg",
           "GramEigFactor", "gram_eig_factor", "gram_solve_atai",
           "gram_solve_atai_split", "gram_solve_aati",
           "gram_solve_aati_split", "cho_factor", "cho_solve_ATAI",
           "cho_solve_AATI", "lu_factor", "lu_solve_ATAI", "lu_solve_AATI",
           "rrs", "solvemdbi_rsm", "valid_adjoint", "block_circulant",
           "solve_symmetric_sylvester", "pca", "nkp", "kpsvd",
           "proj_l2ball", "zdivide"]


def inner(x, y, axis=-1):
    """Broadcast inner product: ``sum(x * y)`` over one axis, keepdims
    (``sporco/linalg.py:41``)."""
    return torch.sum(x * y, dim=axis, keepdim=True)


def dot(a, b, axis=-2):
    """Matrix product of 2-D ``a`` against axis ``axis`` of ``b``,
    leaving the result in that axis position (``sporco/linalg.py:92``);
    fp32 contractions pinned."""
    with fp32_precision():
        return torch.movedim(torch.tensordot(a, b, dims=([1], [axis])), 0,
                             axis % b.ndim)


def solvedbi_sm_c(ah, a, rho, axis=-3):
    """Cacheable component of :func:`solvedbi_sm`
    (``sporco/linalg.py:277``)."""
    return ah / (inner(ah, a, axis=axis) + rho)


def solvedbi_sm(ah, rho, b, c=None, axis=-3, aah=None):
    """Solve ``(rho I + a a^H) x = b`` with ``a = conj(ah)``, per index
    of the axes other than ``axis``, by rank-1 Sherman-Morrison
    (``sporco/linalg.py:232``): the per-bin x-step of single-channel CSC
    with ``axis`` the filter axis.  ``aah`` optionally supplies the
    rho-independent ``sum |ah|^2``."""
    a = ah.conj()
    if c is not None:
        return (b - a * inner(c, b, axis=axis)) / rho
    if aah is None:
        aah = inner(ah, a, axis=axis).real
    t = inner(ah, b, axis=axis) / (aah + rho)
    return (b - a * t) / rho


def solvedbd_sm_c(ah, a, d, axis=-3):
    """Cacheable component of :func:`solvedbd_sm`
    (``sporco/linalg.py:346``)."""
    return (ah / d) / (inner(ah, a / d, axis=axis) + 1.0)


def solvedbd_sm(ah, d, b, c=None, axis=-3):
    """Solve ``(d + a a^H) x = b`` with a diagonal ``d`` (broadcastable)
    by Sherman-Morrison (``sporco/linalg.py:301``)."""
    a = ah.conj()
    if c is None:
        c = solvedbd_sm_c(ah, a, d, axis)
    return (b - a * inner(c, b, axis=axis)) / d


def solvemdbi_ism(ah, rho, b, axisM, axisK):
    """Solve ``(rho I + sum_k a_k a_k^H) x = b`` by iterated
    Sherman-Morrison over axis ``axisK`` (``sporco/linalg.py:370``):
    the per-bin x-step of colour-dictionary CSC, with ``axisM`` the
    filter axis and ``axisK`` the channel axis.  ``rho`` is a number or
    a broadcastable tensor (a bin-dependent diagonal).  The recursion is
    unrolled over the channels, O(K^2) inner products: for small K."""
    axisM = axisM % ah.ndim
    axisK = axisK % ah.ndim
    K = ah.shape[axisK]
    a = ah.conj()

    def slk(x, k):
        return x.narrow(axisK, k, 1)

    gamma, delta = [], []
    alpha = slk(a, 0) / rho
    beta = b / rho
    for k in range(K):
        gamma.append(alpha)
        delta.append(1.0 + inner(slk(ah, k), gamma[k], axis=axisM))
        d = gamma[k] * inner(slk(ah, k), beta, axis=axisM)
        beta = beta - d / delta[k]
        if k < K - 1:
            alpha = slk(a, k + 1) / rho
            for j in range(k + 1):
                d = gamma[j] * inner(slk(ah, j), alpha, axis=axisM)
                alpha = alpha - d / delta[j]
    return beta


# The last cg call: how it ran (``form``: "node", "graph" or "blocks",
# see cg; ``graph`` whether in a CUDA graph), its iterations (None for a
# node, whose count stays on the device), blocks, host reads and the
# eager reads of its loop's tests (the CPU's; none on the card), as
# ``device_loop.LAST`` records a loop's.
CG_LAST = {}

# the graphs of cg solves kept between calls, by the caller's key
_CG_KEPT = {}
CG_MAX_KEPT = 2


def _cg_form(b):
    """How :func:`cg` runs on ``b``'s device here: "node" inside a CUDA-
    graph capture (and its eager warm-up), "graph" elsewhere on the
    card, "blocks" on the CPU."""
    from sporco_tpu_torch.ops import device_loop
    if b.device.type != "cuda":
        return "blocks"
    if torch.cuda.is_current_stream_capturing() or device_loop._WARM[0]:
        return "node"
    return "graph"


def cg(aop, b, x0=None, tol=1e-5, max_iter=1000, m_inv=None, key=None):
    """Conjugate gradient for a Hermitian positive-definite operator
    ``aop`` on tensors (``sporco/linalg.py:515``; the same recurrence and
    stopping test as the JAX package's ``cg``, whose ``lax.while_loop``
    keeps the test on the device).

    The state (x, r, z, p, rz, k) lives in tensors of the call's own; an
    iteration runs where ``live = (k < max_iter) & (||r|| > thr)``,
    computed on the device at the end of the iteration before, and, in a
    device loop's iteration (``device_loop.outer``), where that
    iteration is live; its iterations are added into the loop's counter
    of inner passes.  Three forms (:data:`CG_LAST`):

    - "node": inside a capture (the ADMM iteration of a graph-route
      problem), the set-up and a WHILE node (``device_loop.while_``)
      whose body is one iteration; nothing is read on the host, and
      ``k`` is returned as a 0-d device tensor.
    - "graph": elsewhere on the card, the set-up and the WHILE node are a
      CUDA graph of their own, captured at the first call and, with
      ``key``, kept for the next call of that key (which the caller
      gives only where ``aop`` and ``m_inv`` read the same tensors every
      call: their addresses in the key); one host read, of k.
    - "blocks": on the CPU, blocks of ``device_loop.UNROLL`` iterations,
      each a conditional block (``device_loop.when``), one read of
      ``live`` and k a block: a solve of c iterations reads max(1,
      ceil(c / 8)) times.

    Returns ``(x, k)`` with ``k`` the number of iterations run (a Python
    int, but in the "node" form)."""
    from sporco_tpu_torch.ops import device_loop
    if x0 is None:
        x0 = torch.zeros_like(b)
    form = _cg_form(b)
    gate = device_loop.outer()
    CG_LAST.clear()
    if form == "node":
        st = _cg_state(aop, b, m_inv, tol, max_iter, gate, device_loop)
        st["run"](b, x0)
        CG_LAST.update(form=form, iterations=None, blocks=0, host_reads=0,
                       flag_reads=0, graph=True, kept=False)
        return st["x"], st["k"]
    if form == "graph":
        kkey = None if key is None else (
            key, tuple(b.shape), b.dtype, str(b.device), tol, max_iter,
            m_inv is not None, None if gate is None else tuple(
                t.data_ptr() for t in gate))
        st = _CG_KEPT.get(kkey)
        if st is None:
            st = _cg_state(aop, b, m_inv, tol, max_iter, gate, device_loop)
            st["b"], st["x0"] = b.clone(), x0.clone()
            st["graph"] = device_loop._capture(
                lambda: st["run"](st["b"], st["x0"]), b.device)
            if kkey is not None:
                while len(_CG_KEPT) >= CG_MAX_KEPT:
                    del _CG_KEPT[next(iter(_CG_KEPT))]
                _CG_KEPT[kkey] = st
        else:
            st["b"].copy_(b)
            st["x0"].copy_(x0)
        st["graph"].replay()
        k = int(device_loop.read(st["k"]))
        CG_LAST.update(form=form, iterations=k, blocks=0, host_reads=1,
                       flag_reads=0, graph=True, kept=kkey in _CG_KEPT)
        return st["x"].clone(), k
    st = _cg_state(aop, b, m_inv, tol, max_iter, gate, device_loop)
    st["setup"](b, x0)
    flags = device_loop._FLAGS[0]
    reads = 0
    while True:
        for _ in range(device_loop.UNROLL):
            if device_loop.when(st["live"], st["iteration"]) is False:
                break
        host = device_loop.read(torch.stack([st["live"].to(torch.int64),
                                             st["k"]]))
        reads += 1
        if not host[0]:
            break
    if gate is not None:
        gate[1].add_(st["k"])
    k = int(host[1])
    CG_LAST.update(form=form, iterations=k, blocks=reads, host_reads=reads,
                   flag_reads=device_loop._FLAGS[0] - flags, graph=False,
                   kept=False)
    return st["x"], k


def _cg_state(aop, b, m_inv, tol, max_iter, gate, device_loop):
    """The tensors of a cg solve and its functions (see :func:`cg`):
    ``setup(b, x0)``, ``iteration()`` and ``run(b, x0)`` (the set-up, a
    WHILE loop of iterations and the count into the loop's counter)."""
    rdt = b.real.dtype if b.is_complex() else b.dtype
    dev = b.device
    tiny = 1e-30
    st = {n: torch.empty_like(b) for n in ("x", "r", "p")}
    st["z"] = torch.empty_like(b) if m_inv is not None else st["r"]
    st["rz"] = torch.zeros((), dtype=rdt, device=dev)
    st["thr"] = torch.zeros((), dtype=rdt, device=dev)
    st["k"] = torch.zeros((), dtype=torch.int64, device=dev)
    st["live"] = live = torch.zeros((), dtype=torch.bool, device=dev)
    x, r, z, p, rz, k, thr = (st[n] for n in ("x", "r", "z", "p", "rz", "k",
                                              "thr"))

    def dotp(u, v):
        return torch.sum((u.conj() * v).real)

    def test():
        torch.logical_and(k < max_iter, torch.sqrt(dotp(r, r)) > thr,
                          out=live)
        if gate is not None:
            live.logical_and_(gate[0])

    def setup(b, x0):
        device_loop.stage("cg set-up")
        bn = torch.sqrt(dotp(b, b))
        x.copy_(x0)
        r.copy_(b - aop(x0))
        if m_inv is not None:
            z.copy_(m_inv(r))
        p.copy_(z)
        rz.copy_(dotp(r, z))
        k.zero_()
        thr.copy_(tol * torch.clamp(bn, min=tiny))
        test()

    def iteration():
        device_loop.stage("cg iteration")
        ap = aop(p)
        alpha = rz / torch.clamp(dotp(p, ap), min=tiny)
        x.copy_(x + alpha * p)
        r.copy_(r - alpha * ap)
        if m_inv is not None:
            z.copy_(m_inv(r))
        rz_new = dotp(r, z)
        beta = rz_new / torch.clamp(rz, min=tiny)
        p.copy_(z + beta * p)
        rz.copy_(rz_new)
        k.add_(1)
        test()

    def run(b, x0):
        setup(b, x0)
        device_loop.while_(live, iteration)
        if gate is not None:
            gate[1].add_(k)
    st.update(setup=setup, iteration=iteration, run=run)
    return st


def solvemdbi_cg(ah, rho, b, axisM, axisK, tol=1e-5, max_iter=1000,
                 x0=None):
    """Solve ``(rho I + sum_k a_k a_k^H) x = b`` by conjugate gradient
    (``sporco/linalg.py:515``), ``axisM`` the filter axis and ``axisK``
    the axis summed over.  Returns ``(x, cgit)``."""
    a = ah.conj()

    def aop(u):
        return rho * u + torch.sum(a * inner(ah, u, axis=axisM),
                                   dim=axisK, keepdim=True)

    # aop reads ah, a view of it and rho: the same tensors (by address)
    # give the same graph
    rkey = (("t", rho.data_ptr(), rho.dtype) if isinstance(rho, torch.Tensor)
            else ("v", float(rho)))
    key = ("solvemdbi_cg", ah.data_ptr(), tuple(ah.shape), ah.stride(),
           ah.dtype, rkey, axisM, axisK)
    with fp32_precision():
        return cg(aop, b, x0=x0, tol=tol, max_iter=max_iter, key=key)


# ---------------------------------------------------------------------------
# Dense solves of the BPDN x-step (``sporco/linalg.py:583-777``)

class GramEigFactor(NamedTuple):
    """Eigendecomposition of the Gram matrix ``A^T A`` (``of_ata``) or
    ``A A^T``: ``(G + rho I)^{-1}`` for any rho is two products, so
    AutoRho needs no new factorisation."""
    evecs: torch.Tensor     # eigenvectors, columns
    evals: torch.Tensor     # eigenvalues, ascending
    a: torch.Tensor         # the operator (n, m)
    of_ata: bool


def gram_eig_factor(a, of_ata=None):
    """Eigendecompose ``A^T A`` or ``A A^T``, whichever is smaller
    (``sporco/linalg.py:698``), in the operator's precision, as the JAX
    package does; the Gram product in full fp32.  On the card cuSOLVER
    orders and signs the eigenvectors otherwise than LAPACK; the solves
    do not depend on that."""
    n, m = a.shape
    if of_ata is None:
        of_ata = n >= m
    with fp32_precision():
        g = a.T @ a if of_ata else a @ a.T
    evals, evecs = torch.linalg.eigh(g)
    rdt = a.real.dtype if a.is_complex() else a.dtype
    return GramEigFactor(evecs.to(a.dtype), evals.to(rdt), a, of_ata)


def gram_solve_atai(f, rho, b):
    """Solve ``(A^T A + rho I) x = b`` with a :class:`GramEigFactor`, by
    the matrix inversion lemma where it is of ``A A^T``
    (``sporco/linalg.py:739``)."""
    with fp32_precision():
        if f.of_ata:
            w = f.evecs.T @ b
            return f.evecs @ (w / (f.evals[:, None] + rho))
        ab = f.a @ b
        w = f.evecs.T @ ab
        t = f.evecs @ (w / (f.evals[:, None] + rho))
        return (b - f.a.T @ t) / rho


def gram_solve_atai_split(f, rho, s, v):
    """Solve ``(A^T A + rho I) x = A^T s + rho v`` with the right-hand
    side in split form.  For a wide ``A`` (factor of ``A A^T``) it takes
    ``x = v + A^T (A A^T + rho I)^{-1} (s - A v)``, whose intermediates
    stay at the data's scale, where the inversion lemma's
    ``(b - A^T t) / rho`` cancels in float32."""
    with fp32_precision():
        if f.of_ata:
            b = f.a.T @ s + rho * v
            w = f.evecs.T @ b
            return f.evecs @ (w / (f.evals[:, None] + rho))
        r = s - f.a @ v
        t = f.evecs @ ((f.evecs.T @ r) / (f.evals[:, None] + rho))
        return v + f.a.T @ t


def gram_solve_aati_split(f, rho, s, v):
    """Solve ``x (A A^T + rho I) = s A^T + rho v`` (systems from the
    right) with the right-hand side in split form:
    ``x = v + ((s - v A) (A^T A + rho I)^{-1}) A^T`` for a factor of
    ``A^T A``."""
    with fp32_precision():
        if not f.of_ata:
            b = s @ f.a.T + rho * v
            w = b @ f.evecs
            return (w / (f.evals[None, :] + rho)) @ f.evecs.T
        r = s - v @ f.a
        t = ((r @ f.evecs) / (f.evals[None, :] + rho)) @ f.evecs.T
        return v + t @ f.a.T


def gram_solve_aati(f, rho, b):
    """Solve ``x (A A^T + rho I) = b`` (``sporco/linalg.py:777``)."""
    with fp32_precision():
        if not f.of_ata:
            w = b @ f.evecs
            return (w / (f.evals[None, :] + rho)) @ f.evecs.T
        ba = b @ f.a
        w = ba @ f.evecs
        t = (w / (f.evals[None, :] + rho)) @ f.evecs.T
        return (b - t @ f.a.T) / rho


def _gram_rho(a, rho):
    """``A^T A + rho I`` or ``A A^T + rho I``, whichever is smaller."""
    n, m = a.shape
    eye = torch.eye(min(n, m), dtype=a.dtype, device=a.device)
    with fp32_precision():
        return (a.T @ a if n >= m else a @ a.T) + rho * eye


def cho_factor(a, rho, lower=False):
    """Cholesky factor of ``A^T A + rho I`` or ``A A^T + rho I``,
    whichever is smaller (``sporco/linalg.py:698``): ``(c, lower)``, ``c``
    the lower or the upper triangular factor."""
    g = _gram_rho(a, rho)
    return torch.linalg.cholesky(g, upper=not lower), lower


def _cho_solve(c, lwr, b):
    return torch.cholesky_solve(b, c, upper=not lwr)


def cho_solve_ATAI(a, rho, b, c, lwr=False):
    """Solve ``(A^T A + rho I) x = b`` with :func:`cho_factor`'s ``c``
    (``sporco/linalg.py:739``)."""
    n, m = a.shape
    with fp32_precision():
        if n >= m:
            return _cho_solve(c, lwr, b)
        return (b - a.T @ _cho_solve(c, lwr, a @ b)) / rho


def cho_solve_AATI(a, rho, b, c, lwr=False):
    """Solve ``x (A A^T + rho I) = b`` with :func:`cho_factor`'s ``c``
    (``sporco/linalg.py:777``)."""
    n, m = a.shape
    with fp32_precision():
        if n < m:
            return _cho_solve(c, lwr, b.T).T
        return (b - _cho_solve(c, lwr, (b @ a).T).T @ a.T) / rho


def lu_factor(a, rho):
    """LU factorisation ``(LU, pivots)`` of ``A^T A + rho I`` or
    ``A A^T + rho I`` (``sporco/linalg.py:583``)."""
    return torch.linalg.lu_factor(_gram_rho(a, rho))


def lu_solve_ATAI(a, rho, b, lu_piv):
    """Solve ``(A^T A + rho I) x = b`` with :func:`lu_factor`'s output."""
    n, m = a.shape
    with fp32_precision():
        if n >= m:
            return torch.linalg.lu_solve(*lu_piv, b)
        return (b - a.T @ torch.linalg.lu_solve(*lu_piv, a @ b)) / rho


def lu_solve_AATI(a, rho, b, lu_piv):
    """Solve ``x (A A^T + rho I) = b`` with :func:`lu_factor`'s output."""
    n, m = a.shape
    with fp32_precision():
        if n < m:
            return torch.linalg.lu_solve(*lu_piv, b.T).T
        return (b - torch.linalg.lu_solve(*lu_piv, (b @ a).T).T @ a.T) \
            / rho


def rrs(ax, b):
    """Relative residual ``||b - Ax|| / max(||Ax||, ||b||)`` with a 0/0
    guard (``sporco/linalg.py:883``), as a 0-d tensor."""
    nrm = torch.maximum(torch.linalg.vector_norm(ax),
                        torch.linalg.vector_norm(b))
    dv = torch.linalg.vector_norm(ax - b)
    zero = nrm == 0.0
    return torch.where(zero, torch.where(dv == 0.0, 0.0, torch.inf),
                       dv / torch.where(zero, 1.0, nrm))


# ---------------------------------------------------------------------------
# The explicit-inverse solve, validation and product-dictionary helpers
# (``sporco/linalg.py:147-1037``)

def solvemdbi_rsm(ah, rho, b, axisK=None, dimN=2):
    """Solve ``(rho I + sum_k a_k a_k^H) x = b`` by building the per-pixel
    M x M inverse with K Sherman-Morrison updates
    (``sporco/linalg.py:448``).  ``ah`` has shape ``(..., K, M)`` (the
    rank terms on the second last axis, the system on the last, pixels
    on the leading axes, broadcast) and ``b`` ``(..., M)``; ``axisK`` and
    ``dimN`` are accepted for the reference's call surface only."""
    del axisK, dimN
    K, M = ah.shape[-2:]
    a = ah.conj()
    ainv = torch.eye(M, dtype=ah.dtype, device=ah.device) * (1.0 / rho)
    with fp32_precision():
        for k in range(K):
            ak, ahk = a[..., k, :], ah[..., k, :]
            aia = torch.einsum("...ij,...j->...i", ainv, ak)
            ahai = torch.einsum("...j,...ji->...i", ahk, ainv)
            denom = 1.0 + torch.sum(ahk * aia, dim=-1, keepdim=True)
            ainv = ainv - aia[..., :, None] * ahai[..., None, :] \
                / denom[..., None]
        return torch.einsum("...ij,...j->...i", ainv, b)


def valid_adjoint(aop, atop, ashape, atshape, eps=1e-7, seed=0,
                  dtype=torch.float64, device=None):
    """Random-vector adjoint test ``<y, A x> == <A^T y, x>``
    (``sporco/linalg.py:147``), the vectors standard normal from a
    ``torch.Generator`` seeded with ``seed`` and moved to ``device``
    (the CUDA device unless ``"cpu"`` is asked for).  Returns the
    relative error if ``eps`` is None, else whether it is below ``eps``."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    u = torch.randn(tuple(ashape), generator=g, dtype=dtype).to(device)
    v = torch.randn(tuple(atshape), generator=g, dtype=dtype).to(device)
    yax = torch.sum(v.conj() * aop(u)).real
    atyx = torch.sum(atop(v).conj() * u).real
    err = float(torch.abs(yax - atyx)
                / torch.maximum(torch.abs(yax), torch.abs(atyx)))
    return err if eps is None else err < eps


def block_circulant(a):
    """The dense block-circulant matrix of a sequence of equal blocks
    (``sporco/linalg.py:204``), for validation."""
    blocks = [torch.as_tensor(np.asarray(x)) if not isinstance(
        x, torch.Tensor) else x for x in a]
    r, c = blocks[0].shape
    nb = len(blocks)
    out = blocks[0].new_zeros((nb * r, nb * c))
    for k in range(nb):
        for j in range(nb):
            kl = (k + j) % nb
            out[r * kl:r * (kl + 1), c * k:c * (k + 1)] = blocks[j]
    return out


def solve_symmetric_sylvester(A, B, c, alpha):
    """Solve ``A X B + alpha X = C`` for symmetric ``A`` and ``B`` by
    their eigendecompositions (``sporco/linalg.py:815``).  ``A`` and
    ``B`` are each a matrix, an ``(evals, evecs)`` pair or a vector (a
    diagonal)."""
    def eig_of(m):
        if isinstance(m, tuple):
            return m
        if m.ndim == 1:
            return m, None
        return torch.linalg.eigh(m)

    with fp32_precision():
        wa, va = eig_of(A)
        wb, vb = eig_of(B)
        ct = c
        if va is not None:
            ct = va.T @ ct
        if vb is not None:
            ct = ct @ vb
        xt = ct / (wa[:, None] * wb[None, :] + alpha)
        if va is not None:
            xt = va @ xt
        if vb is not None:
            xt = xt @ vb.T
        return xt


def pca(u, centre=False):
    """PCA basis of the columns of ``u`` (``sporco/linalg.py:914``):
    ``(B, S, C)``, the basis vectors the columns of ``B`` in order of
    descending variance, ``S`` their eigenvalues and ``C`` the mean
    column (or None without ``centre``)."""
    c = None
    if centre:
        c = torch.mean(u, dim=1, keepdim=True)
        u = u - c
    with fp32_precision():
        w, v = torch.linalg.eigh(u @ u.T / u.shape[1])
    return torch.flip(v, dims=(1,)), torch.flip(w, dims=(0,)), c


def _kron_rearrange(a, bshape, cshape):
    """The Van Loan-Pitsianis rearrangement ``R(A)``, under which the
    nearest Kronecker product is a rank-1 approximation."""
    br, bc = bshape
    cr, cc = cshape
    return a.reshape(br, cr, bc, cc).permute(0, 2, 1, 3).reshape(
        br * bc, cr * cc)


def nkp(a, bshape, cshape):
    """The nearest Kronecker product ``(B, C)``, minimising ``||A - B
    kron C||_F`` (``sporco/linalg.py:949``)."""
    u, s, vt = torch.linalg.svd(_kron_rearrange(a, bshape, cshape),
                                full_matrices=False)
    sq = torch.sqrt(s[0])
    return sq * u[:, 0].reshape(bshape), sq * vt[0, :].reshape(cshape)


def kpsvd(a, bshape, cshape):
    """The Kronecker product SVD (``sporco/linalg.py:990``): ``(S, B,
    C)`` with ``A = sum_k S[k] B[..., k] kron C[..., k]``."""
    u, s, vt = torch.linalg.svd(_kron_rearrange(a, bshape, cshape),
                                full_matrices=False)
    return (s, u.T.reshape(-1, *bshape).permute(1, 2, 0),
            vt.reshape(-1, *cshape).permute(1, 2, 0))


def proj_l2ball(b, s, r, axes=None):
    """Projection of ``b`` onto the l2 ball of radius ``r`` about ``s``
    (``sporco/linalg.py:1037``)."""
    from sporco_tpu_torch.ops.prox import proj_l2
    return s + proj_l2(b - s, r, axis=axes)
