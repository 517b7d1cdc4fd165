"""Array helpers (counterpart of ``sporco_tpu.utils.array``; parity with
``sporco/array.py``): zero padding, dimension and split helpers, float16
promotion, sliding windows, subsampling, block extraction and
recombination.  Arguments are tensors (a numpy array is taken through
``torch.as_tensor``); shape arguments are Python values.
"""

import numpy as np
import torch

from sporco_tpu_torch.ops.prox import zdivide  # noqa: F401  (re-export)

__all__ = [
    "zpad", "zdivide", "atleast_nd", "split", "promote16",
    "rolling_window", "subsample_array", "extract_blocks",
    "average_blocks", "combine_blocks", "transpose_ntpl",
]


def _t(x):
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x))


def zpad(x, pd, ax):
    """Zero-pad ``x`` with ``pd = (leading, trailing)`` zeros on axis
    ``ax``, or with one such pair per axis of a tuple ``ax``
    (``sporco/array.py:95``)."""
    if isinstance(ax, int):
        ax, pd = (ax,), (pd,)
    pad = [0, 0] * x.ndim
    for a, p in zip(ax, pd):
        # torch's pad list runs from the last axis backwards
        k = 2 * (x.ndim - 1 - a % x.ndim)
        pad[k], pad[k + 1] = p
    return torch.nn.functional.pad(x, pad)


def atleast_nd(n, u):
    """Append singleton axes so ``u`` has at least ``n`` dims
    (``sporco/array.py:189``)."""
    u = _t(u)
    if u.ndim >= n:
        return u
    return u.reshape(tuple(u.shape) + (1,) * (n - u.ndim))


def split(u, axis=0):
    """Split a tensor into the list of its slices along ``axis``
    (``sporco/array.py:216``)."""
    return list(torch.unbind(_t(u), dim=axis))


def promote16(u, fn=None, *args, **kwargs):
    """Promote float16 input to float32 for computation
    (``sporco/array.py:140``).  With ``fn`` given, apply it to the
    promoted tensor and demote the result(s)."""
    u = _t(u)
    up = u.to(torch.float32) if u.dtype == torch.float16 else u
    if fn is None:
        return up
    v = fn(up, *args, **kwargs)
    if isinstance(v, tuple):
        return tuple(x.to(u.dtype) if isinstance(x, torch.Tensor) else x
                     for x in v)
    return v.to(u.dtype)


def rolling_window(x, wndsz, hopsz=None, pad="constant"):
    """Sliding windows of size ``wndsz`` (int or tuple over the leading
    axes) with hop ``hopsz``; the windows are stacked on new trailing
    axes (``sporco/array.py:247``)."""
    if isinstance(wndsz, int):
        wndsz = (wndsz,)
    if hopsz is None:
        hopsz = (1,) * len(wndsz)
    elif isinstance(hopsz, int):
        hopsz = (hopsz,)
    out = _t(x)
    nd = len(wndsz)
    nwin = tuple((out.shape[k] - wndsz[k]) // hopsz[k] + 1
                 for k in range(nd))
    for k in range(nd):
        # axis k sits at 2k after the k earlier takes; a (nwin_k, wnd_k)
        # index replaces it with that pair of axes
        idx = (np.arange(nwin[k])[:, None] * hopsz[k]
               + np.arange(wndsz[k])[None])
        sel = torch.as_tensor(idx.ravel(), device=out.device)
        shp = tuple(out.shape)
        out = out.index_select(2 * k, sel).reshape(
            shp[:2 * k] + idx.shape + shp[2 * k + 1:])
    # (nwin0, wnd0, nwin1, wnd1, ..., rest) -> (nwin..., rest, wnd...)
    perm = [2 * k for k in range(nd)] + \
        list(range(2 * nd, out.ndim)) + [2 * k + 1 for k in range(nd)]
    return out.permute(perm)


def subsample_array(x, step, pad=False):
    """Subsample with step ``step`` (tuple over the leading axes)
    (``sporco/array.py:293``)."""
    if isinstance(step, int):
        step = (step,)
    return _t(x)[tuple(slice(None, None, s) for s in step)]


def extract_blocks(img, blksz, stpsz=None):
    """Extract (possibly overlapping) blocks; returns a tensor of shape
    ``blksz + rest + (nblocks,)`` (``sporco/array.py:338``)."""
    if stpsz is None:
        stpsz = (1,) * len(blksz)
    w = rolling_window(img, blksz, stpsz)
    nd = len(blksz)
    nrest = w.ndim - 2 * nd
    w = w.reshape((int(np.prod(w.shape[:nd])),) + tuple(w.shape[nd:]))
    # (nblk, rest..., blk...) -> (blk..., rest..., nblk)
    perm = (tuple(range(1 + nrest, 1 + nrest + nd))
            + tuple(range(1, 1 + nrest)) + (0,))
    return w.permute(perm)


def average_blocks(blks, imgsz, stpsz=None):
    """Average overlapping blocks back into an image of shape ``imgsz``
    (``sporco/array.py:390``)."""
    blks = _t(blks)
    nd = len(imgsz)
    if stpsz is None:
        stpsz = (1,) * nd
    sums, cnt = _accumulate_blocks(blks, imgsz, tuple(blks.shape[:nd]),
                                   stpsz)
    return sums / cnt


def combine_blocks(blks, imgsz, stpsz=None, fn=torch.mean):
    """Combine overlapping blocks into an image with the reduction ``fn``
    (``sporco/array.py:421``): ``torch.sum`` gives the sums, any other
    reduction the mean, as in the JAX package (order statistics over
    ragged overlap sets do not vectorise)."""
    blks = _t(blks)
    nd = len(imgsz)
    if stpsz is None:
        stpsz = (1,) * nd
    sums, cnt = _accumulate_blocks(blks, imgsz, tuple(blks.shape[:nd]),
                                   stpsz)
    if fn is torch.sum:
        return sums
    return sums / cnt


def _accumulate_blocks(blks, imgsz, blksz, stpsz):
    nd = len(imgsz)
    imgsz = tuple(imgsz)
    nblk = blks.shape[-1]
    nwin = tuple((imgsz[k] - blksz[k]) // stpsz[k] + 1 for k in range(nd))
    # flat pixel index of every element of every block
    grids = np.meshgrid(*[np.arange(n) for n in nwin], indexing="ij")
    starts = [g.ravel() * stpsz[k] for k, g in enumerate(grids)]
    offs = np.meshgrid(*[np.arange(b) for b in blksz], indexing="ij")
    flat_idx = 0
    for k in range(nd):
        coord = starts[k][None, :] + offs[k].ravel()[:, None]
        flat_idx = flat_idx * imgsz[k] + coord
    rest = tuple(blks.shape[nd:-1])
    vals = blks.reshape((int(np.prod(blksz)),) + rest + (nblk,))
    vals = vals.movedim(-1, 1)        # (blkel, nblk, rest...)
    fi = torch.as_tensor(flat_idx.ravel(), device=blks.device)
    npix = int(np.prod(imgsz))
    flat = blks.new_zeros((npix,) + rest).index_add_(
        0, fi, vals.reshape((-1,) + rest))
    cnt = blks.new_zeros((npix,)).index_add_(
        0, fi, blks.new_ones(fi.shape))
    if rest:
        return (flat.reshape(imgsz + rest),
                cnt.reshape(imgsz + (1,) * len(rest)))
    return flat.reshape(imgsz), cnt.reshape(imgsz)


def transpose_ntpl(lst):
    """Transpose a list of namedtuples into a namedtuple of arrays
    (``sporco/array.py:69``)."""
    if not lst:
        return None
    cls = type(lst[0])
    return cls(*[np.asarray([getattr(t, f) for t in lst])
                 for f in cls._fields])


transpose_ntpl_list = transpose_ntpl    # reference alias (sporco/util.py:926)
