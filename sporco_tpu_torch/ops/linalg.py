"""Linear-algebra helpers of the DFT-domain solvers (counterpart of
``sporco_tpu.ops.linalg``): broadcast inner products, the per-bin
Sherman-Morrison solves of single-channel CSC, the iterated
Sherman-Morrison solve of colour-dictionary CSC, conjugate gradient
for the dictionary update's x-step and the relative residual ``rrs``."""

import torch

from sporco_tpu_torch._device import fp32_precision

__all__ = ["inner", "dot", "solvedbi_sm", "solvedbi_sm_c", "solvedbd_sm",
           "solvedbd_sm_c", "solvemdbi_ism", "cg", "solvemdbi_cg", "rrs"]


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


def cg(aop, b, x0=None, tol=1e-5, max_iter=1000, m_inv=None):
    """Conjugate gradient for a Hermitian positive-definite operator
    ``aop`` on tensors (``sporco/linalg.py:515``; the same recurrence and
    stopping test as the JAX package's ``cg``).  The test reads one
    scalar per iteration on the host.  Returns ``(x, k)`` with ``k`` the
    number of iterations run, a Python int."""
    if x0 is None:
        x0 = torch.zeros_like(b)

    def dotp(u, v):
        return torch.sum((u.conj() * v).real)

    tiny = 1e-30
    bn = torch.sqrt(dotp(b, b))
    r = b - aop(x0)
    z = m_inv(r) if m_inv is not None else r
    x, p, rz = x0, z, dotp(r, z)
    thr = tol * torch.clamp(bn, min=tiny)
    k = 0
    while k < max_iter and bool(torch.sqrt(dotp(r, r)) > thr):
        ap = aop(p)
        alpha = rz / torch.clamp(dotp(p, ap), min=tiny)
        x = x + alpha * p
        r = r - alpha * ap
        z = m_inv(r) if m_inv is not None else r
        rz_new = dotp(r, z)
        beta = rz_new / torch.clamp(rz, min=tiny)
        p = z + beta * p
        rz = rz_new
        k += 1
    return x, k


def solvemdbi_cg(ah, rho, b, axisM, axisK, tol=1e-5, max_iter=1000,
                 x0=None):
    """Solve ``(rho I + sum_k a_k a_k^H) x = b`` by conjugate gradient
    (``sporco/linalg.py:515``), ``axisM`` the filter axis and ``axisK``
    the axis summed over.  Returns ``(x, cgit)``."""
    a = ah.conj()

    def aop(u):
        return rho * u + torch.sum(a * inner(ah, u, axis=axisM),
                                   dim=axisK, keepdim=True)

    with fp32_precision():
        return cg(aop, b, x0=x0, tol=tol, max_iter=max_iter)


def rrs(ax, b):
    """Relative residual ``||b - Ax|| / max(||Ax||, ||b||)`` with a 0/0
    guard (``sporco/linalg.py:883``), as a 0-d tensor."""
    nrm = torch.maximum(torch.linalg.vector_norm(ax),
                        torch.linalg.vector_norm(b))
    dv = torch.linalg.vector_norm(ax - b)
    zero = nrm == 0.0
    return torch.where(zero, torch.where(dv == 0.0, 0.0, torch.inf),
                       dv / torch.where(zero, 1.0, nrm))
