"""Proximal and projection operators (counterpart of ``sporco_tpu.ops.prox``):
the l0, l1, l2 and l2,1 norms and their shrinkages, the l1- and l2-ball
projections, the compound and difference shrinkages and the nuclear norm
and its prox, complex-aware.  Reductions over ``axis`` keep their
dimensions, as in the JAX package."""

import math

import torch

from sporco_tpu_torch.ops.svd import svd

__all__ = ["zdivide", "norm_l0", "prox_l0", "norm_l1", "prox_l1",
           "norm_2l2", "norm_l2", "prox_l2", "proj_l2", "norm_l21",
           "prox_sl1l2", "norm_dl1l2", "prox_dl1l2", "proj_l1",
           "norm_nuclear", "prox_nuclear", "nuclear_sketch", "ndto2d",
           "ndfrom2d"]


def zdivide(a, b):
    """Element-wise division returning 0 where the denominator is 0
    (``sporco/array.py:119``)."""
    ok = b != 0
    return torch.where(ok, a, 0) / torch.where(ok, b, 1)


def _sign(v):
    """Sign for real input, unit phase ``v/|v|`` for complex input
    (``sporco/prox/_lp.py:144``)."""
    if v.is_complex():
        return zdivide(v, v.abs())
    return torch.sign(v)


def _dims(x, axis):
    """``axis`` (None, an int or a tuple) as a tuple of dimensions."""
    if axis is None:
        return tuple(range(x.ndim))
    return (axis,) if isinstance(axis, int) else tuple(axis)


def _sq(x):
    """``|x|^2``, complex-aware."""
    return x.abs() ** 2 if x.is_complex() else x ** 2


def norm_l0(x, axis=None, eps=0.0):
    """l0 "norm": the count of entries with ``|x| > eps``."""
    if axis is None:
        return torch.sum(x.abs() > eps)
    return torch.sum(x.abs() > eps, dim=_dims(x, axis), keepdim=True)


def prox_l0(v, alpha):
    """Hard thresholding: zero where ``|v| < sqrt(2 alpha)``."""
    thr = (torch.sqrt(2.0 * alpha) if isinstance(alpha, torch.Tensor)
           else math.sqrt(2.0 * alpha))
    return torch.where(v.abs() >= thr, v, 0)


def norm_l1(x, axis=None):
    """l1 norm, optionally per slice over ``axis``."""
    if axis is None:
        return torch.sum(x.abs())
    return torch.sum(x.abs(), dim=axis, keepdim=True)


def prox_l1(v, alpha):
    """Soft thresholding (scalar shrinkage); complex-aware."""
    return _sign(v) * torch.clamp(v.abs() - alpha, min=0)


def norm_2l2(x, axis=None):
    """Squared l2 norm, optionally per slice over ``axis``."""
    if axis is None:
        return torch.sum(_sq(x))
    return torch.sum(_sq(x), dim=_dims(x, axis), keepdim=True)


def norm_l2(x, axis=None):
    """l2 norm, optionally per slice over ``axis``."""
    return torch.sqrt(norm_2l2(x, axis=axis))


def _group_norm(v, axis):
    return torch.sqrt(torch.sum(_sq(v), dim=_dims(v, axis), keepdim=True))


def prox_l2(v, alpha, axis=None):
    """Vector (group) shrinkage; with ``axis`` the prox of the l2,1 norm
    over the remaining indices."""
    a = _group_norm(v, axis)
    b = torch.clamp(a - alpha, min=0)
    return (zdivide(b, a) * v).to(v.dtype)


def proj_l2(v, gamma, axis=None):
    """Projection onto the l2 ball of radius ``gamma`` (per group when
    ``axis`` is given)."""
    d = _group_norm(v, axis)
    return torch.where(d <= gamma, v, gamma * zdivide(v, d)).to(v.dtype)


def norm_l21(x, axis=-1):
    """l2,1 mixed norm: the sum of the per-group l2 norms."""
    return torch.sum(norm_l2(x, axis=axis))


def prox_sl1l2(v, alpha, beta, axis=None):
    """Prox of ``alpha ||x||_1 + beta ||x||_2``: the l2 shrinkage of the
    l1 shrinkage (``sporco/prox/_l21.py:51``)."""
    return prox_l2(prox_l1(v, alpha), beta, axis=axis)


def norm_dl1l2(x, beta=1.0, axis=None):
    """Difference of the l1 and the (scaled) l2 norm (nonconvex)."""
    return norm_l1(x, axis=axis) - beta * norm_l2(x, axis=axis)


def prox_dl1l2(v, alpha, beta=1.0, axis=None):
    """Prox of ``alpha (||x||_1 - beta ||x||_2)`` (lou-2018-fast,
    ``sporco/prox/_dl1l2.py:49``); ``axis`` is one int or None (the whole
    array as one vector)."""
    if axis is None:
        return prox_dl1l2(v.reshape(-1), alpha, beta, axis=0) \
            .reshape(v.shape)
    va = v.abs()
    vamx = torch.amax(va, dim=axis, keepdim=True)
    u1 = torch.clamp(va - alpha, min=0) * torch.sgn(v)
    u1l2 = norm_l2(u1, axis=axis)
    u1 = u1 * (1.0 + zdivide(torch.full_like(u1l2, alpha * beta), u1l2))
    # the one-spike solution where alpha >= max|v| > (1 - beta) alpha
    idx = torch.argmax(va, dim=axis, keepdim=True)
    vsgn = torch.sgn(torch.gather(v, axis, idx))
    spike = (vamx + (beta - 1.0) * alpha) * vsgn
    onehot = torch.zeros_like(v).scatter(axis, idx, 1.0)
    u2 = onehot * spike
    return torch.where(vamx > alpha, u1,
                       torch.where(vamx > (1.0 - beta) * alpha, u2, 0.0))


def proj_l1(v, gamma, axis=None):
    """Projection onto the l1 ball of radius ``gamma`` by the sort and
    cumulative sum method (duchi-2008-efficient,
    ``sporco/prox/_l1proj.py:110``), per slice over ``axis``: None (the
    whole array), an int or a tuple of ints."""
    if axis is None:
        return _proj_l1_sortsum(v.reshape(-1), gamma, 0).reshape(v.shape)
    if isinstance(axis, tuple):
        vtr, rsi = ndto2d(v, axis)
        return ndfrom2d(_proj_l1_sortsum(vtr, gamma, 1), rsi)
    return _proj_l1_sortsum(v, gamma, axis)


def _proj_l1_sortsum(v, gamma, axis):
    axis = axis % v.ndim
    av = v.abs()
    vs = torch.sort(av, dim=axis, descending=True).values
    N = v.shape[axis]
    ns = [N if k == axis else 1 for k in range(v.ndim)]
    c = (1.0 / torch.arange(1, N + 1, dtype=av.dtype, device=v.device)) \
        .reshape(ns)
    t = c * (torch.cumsum(vs, dim=axis) - gamma)
    keep = vs >= t
    K = torch.sum(keep, dim=axis, keepdim=True)
    t = (torch.sum(torch.where(keep, vs, 0), dim=axis, keepdim=True)
         - gamma) / K
    t = torch.clamp(t, min=0).to(av.dtype)
    return _sign(v) * torch.where(av > t, av - t, 0)


def norm_nuclear(x):
    """Nuclear norm (sum of singular values) of a matrix or a batch of
    matrices over the leading axes."""
    return torch.sum(torch.linalg.svdvals(x))


def nuclear_sketch(shape, rank, oversample=10, dtype=torch.float32,
                   device=None):
    """The Gaussian sketch of :func:`prox_nuclear`'s randomized path for
    ``v`` of shape ``shape``: ``shape[:-2] + (n, r)`` standard normals
    with ``r = min(rank + oversample, m, n)``, real, from a new generator
    on ``device`` seeded 0."""
    m, n = shape[-2], shape[-1]
    r = int(min(rank + oversample, min(m, n)))
    generator = torch.Generator(device=device).manual_seed(0)
    return torch.randn(tuple(shape[:-2]) + (n, r), generator=generator,
                       dtype=dtype, device=device)


def prox_nuclear(v, alpha, rank=None, n_iter=2, oversample=10,
                 sketch=None):
    """Singular-value soft thresholding (cai-2010-singular): returns
    ``(X, s)`` with ``s`` the thresholded singular values
    (``sporco/prox/_nuclear.py:45``); batched over leading axes.

    With ``rank`` set, a randomized subspace-iteration SVD of rank
    ``rank + oversample`` (halko-2011-finding, Alg. 4.4) replaces the
    full decomposition, and ``s`` has that length.  Its Gaussian
    ``sketch`` of shape ``v.shape[:-2] + (n, r)`` may be passed in (the
    JAX package draws its own from ``PRNGKey(0)``, which cannot be drawn
    here); by default :func:`nuclear_sketch` draws one.

    The SVD is ``ops/svd.py`` ``svd`` (``torch.linalg.svd`` on the CPU,
    the Jacobi kernels on the card, real or complex) and the QR
    ``torch.linalg.qr``: neither reads the host on the card (the complex
    QR no more than the real one, PERF.md), so a device loop captures
    the prox into its iteration's graph, for real and complex ``v``
    alike.  A complex ``v``'s sketch is real, cast to ``v``'s type, as
    the JAX package's is."""
    if rank is None:
        u, s, vt = svd(v)
        ss = torch.clamp(s - alpha, min=0)
        return (u * ss[..., None, :]) @ vt, ss
    if sketch is None:
        sketch = nuclear_sketch(v.shape, rank, oversample,
                                dtype=v.real.dtype if v.is_complex()
                                else v.dtype, device=v.device)
    m, n = v.shape[-2], v.shape[-1]
    r = int(min(rank + oversample, min(m, n)))
    if tuple(sketch.shape) != tuple(v.shape[:-2]) + (n, r):
        raise ValueError(f"sketch of shape {tuple(sketch.shape)}, expected "
                         f"{tuple(v.shape[:-2]) + (n, r)}")
    om = sketch.to(v.device, v.dtype)
    vh = v.transpose(-1, -2).conj()
    y = v @ om
    for _ in range(int(n_iter)):
        q = torch.linalg.qr(y)[0]
        z = torch.linalg.qr(vh @ q)[0]
        y = v @ z
    q = torch.linalg.qr(y)[0]
    b = q.transpose(-1, -2).conj() @ v
    ub, s, vt = svd(b)
    ss = torch.clamp(s - alpha, min=0)
    u = q @ ub
    return (u * ss[..., None, :]) @ vt, ss


def ndto2d(x, axis=-1):
    """Permute and reshape ``x`` so the axes in ``axis`` form the columns
    of a 2-D array; returns it and the information to undo it
    (``sporco/prox/_util.py:20``)."""
    if isinstance(axis, int):
        axis = (axis,)
    axis = tuple(k % x.ndim for k in axis)
    caxis = tuple(sorted(set(range(x.ndim)) - set(axis)))
    prm = caxis + axis
    xt = x.permute(prm)
    xts = tuple(xt.shape)
    nrows = math.prod(xts[:len(caxis)])
    return xt.reshape(nrows, -1), (xts, prm)


def ndfrom2d(xtr, rsi):
    """Inverse of :func:`ndto2d`."""
    xts, prm = rsi
    inv = sorted(range(len(prm)), key=lambda k: prm[k])
    return xtr.reshape(xts).permute(inv)
