"""Interpolation and regression (counterpart of
``sporco_tpu.utils.interp``; capability of ``sporco/interp.py``): Bayer
bilinear demosaicing, least absolute deviations and minimax linear
regression, and Lanczos kernels and filters.

The linear-programming regressions (``sporco/interp.py:106,152``) and
the demosaicing run on the host (scipy), as in the JAX package;
:func:`lstabsdev_irls`, :func:`lanczos_kernel` and
:func:`lanczos_filters` work on tensors.
"""

import warnings

import numpy as np
import torch

__all__ = ["bilinear_demosaic", "lstabsdev", "lstmaxdev",
           "lstabsdev_irls", "lanczos_kernel", "lanczos_filters"]


def _host(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def bilinear_demosaic(img):
    """Demosaic a BGGR Bayer-pattern image by bilinear interpolation
    (the pattern of ``sporco/interp.py:24``: B at [0::2, 0::2], R at
    [1::2, 1::2], G elsewhere).  Returns an RGB numpy image."""
    img = _host(img)
    H, W = img.shape
    from scipy.interpolate import RectBivariateSpline, griddata
    # red channel on the [1::2, 1::2] grid
    xr = np.arange(1, H, 2)
    yr = np.arange(1, W, 2)
    fr = RectBivariateSpline(xr, yr, img[1::2, 1::2], s=0,
                             kx=min(3, len(xr) - 1),
                             ky=min(3, len(yr) - 1))
    sr = fr(np.arange(H), np.arange(W))
    # blue channel on the [0::2, 0::2] grid
    xb = np.arange(0, H, 2)
    yb = np.arange(0, W, 2)
    fb = RectBivariateSpline(xb, yb, img[0::2, 0::2], s=0,
                             kx=min(3, len(xb) - 1),
                             ky=min(3, len(yb) - 1))
    sb = fb(np.arange(H), np.arange(W))
    # green channel on the union of two offset grids
    x0, y0 = np.mgrid[0:H:2, 1:W:2]
    x1, y1 = np.mgrid[1:H:2, 0:W:2]
    xy01 = np.vstack((np.hstack((x0.ravel(), x1.ravel())),
                      np.hstack((y0.ravel(), y1.ravel())))).T
    z = np.hstack((img[0::2, 1::2].ravel(), img[1::2, 0::2].ravel()))
    x2, y2 = np.mgrid[0:H, 0:W]
    xy2 = np.vstack((x2.ravel(), y2.ravel())).T
    sg = griddata(xy01, z, xy2, method="linear").reshape(H, W)
    for (i, j), nbrs in [((0, 0), [(0, 1), (1, 0)]),
                         ((0, W - 1), [(0, W - 2), (1, W - 1)]),
                         ((H - 1, 0), [(H - 2, 0), (H - 1, 1)]),
                         ((H - 1, W - 1), [(H - 2, W - 1),
                                           (H - 1, W - 2)])]:
        if np.isnan(sg[i, j]):
            sg[i, j] = np.mean([sg[a, b] for a, b in nbrs])
    return np.dstack((sr, sg, sb))


def _linprog(c, A_ub, b_ub):
    import scipy.optimize as sco
    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", category=sco.OptimizeWarning)
        res = sco.linprog(c, A_ub, b_ub, bounds=(None, None))
    if not res.success:
        raise ValueError("linprog failed with status %d" % res.status)
    return res.x


def lstabsdev(A, b):
    """Least absolute deviations regression ``argmin_x ||Ax - b||_1`` by
    linear programming (``sporco/interp.py:106``)."""
    A = _host(A)
    b = _host(b).ravel()
    M, N = A.shape
    c = np.zeros((M + N,))
    c[0:M] = 1.0
    I = np.identity(M)
    A_ub = np.hstack((np.vstack((-I, -I)), np.vstack((-A, A))))
    return _linprog(c, A_ub, np.hstack((-b, b)))[M:]


def lstmaxdev(A, b):
    """Minimax (Chebyshev) regression ``argmin_x ||Ax - b||_inf`` by
    linear programming (``sporco/interp.py:152``)."""
    A = _host(A)
    b = _host(b).ravel()
    M, N = A.shape
    c = np.zeros((N + 1,))
    c[0] = 1.0
    one = np.ones((M, 1))
    A_ub = np.hstack((np.vstack((-one, -one)), np.vstack((-A, A))))
    return _linprog(c, A_ub, np.hstack((-b, b)))[1:]


def lstabsdev_irls(A, b, n_iter=50, eps=1e-6):
    """Iteratively reweighted least squares approximation to least
    absolute deviations, on tensors (the device alternative to the
    LP)."""
    A = torch.as_tensor(A)
    b = torch.as_tensor(b, dtype=A.dtype, device=A.device).reshape(-1)
    eye = torch.eye(A.shape[1], dtype=A.dtype, device=A.device)
    x = torch.linalg.lstsq(A, b[:, None]).solution[:, 0]
    for _ in range(n_iter):
        w = 1.0 / torch.clamp(torch.abs(A @ x - b), min=eps)
        AW = A * w[:, None]
        x = torch.linalg.solve(A.T @ AW + 1e-10 * eye, AW.T @ b)
    return x


def lanczos_kernel(x, a=3):
    """Lanczos interpolation kernel (``sporco/interp.py:198``)."""
    x = torch.as_tensor(x)
    return torch.where(torch.abs(x) < a,
                       torch.sinc(x) * torch.sinc(x / a),
                       torch.zeros((), dtype=x.dtype, device=x.device))


def lanczos_filters(sz, a=3, collapse_axes=True):
    """Multi-dimensional Lanczos filter bank for a grid of fractional
    shifts (``sporco/interp.py:255``).

    ``sz`` is a tuple of per-axis shift counts (or arrays of shifts);
    returns a float64 tensor of shape ``(2a,)*ndim + shift_shape`` (the
    shift axes collapsed to one trailing axis if ``collapse_axes``).
    """
    if isinstance(sz, int):
        sz = (sz,)
    shifts = []
    for s in sz:
        if np.isscalar(s):
            shifts.append(np.linspace(0, 1, int(s), endpoint=False))
        else:
            shifts.append(_host(s))
    ndim = len(shifts)
    n = np.arange(-a + 1, a + 1)
    banks = []
    for sh in shifts:
        k = lanczos_kernel(torch.as_tensor(n[:, None] - sh[None, :],
                                           dtype=torch.float64), a=a)
        banks.append(k / k.sum(dim=0, keepdim=True))
    # outer product over the dimensions: (n0, s0, n1, s1, ...)
    out = banks[0]
    for d in range(1, ndim):
        out = torch.tensordot(out, banks[d], dims=0)
    # -> (n0, n1, ..., s0, s1, ...)
    perm = list(range(0, 2 * ndim, 2)) + list(range(1, 2 * ndim, 2))
    out = out.permute(perm)
    if collapse_axes and ndim > 1:
        out = out.reshape(tuple(out.shape[:ndim]) + (-1,))
    return out
