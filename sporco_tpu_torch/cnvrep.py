"""Convolutional representation layout (counterpart of
``sporco_tpu.cnvrep``).

The internal layout keeps the spatial axes trailing, exactly as the JAX
package does, so arrays of the two packages compare one to one::

            sig  chn  flt  sptl.
    S      (K,   C,   1,   N0, N1, ...)
    D      (1,   Cd,  M,   Nd0, Nd1, ...)
    X      (K,   Cx,  M,   N0, N1, ...)

User-facing arrays follow the reference's conventions: ``D`` is
``dsz + [Cd] + (M,)``, ``S`` is ``Nv + [C] + [K]`` and coefficients are
returned as ``Nv + (Cx, K, M)``.
"""

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

__all__ = ["CSCIndex", "csc_index", "CDUIndex", "cdu_index",
           "DictionarySize", "to_internal_S", "to_internal_D",
           "to_internal_X", "from_internal_X", "from_internal_D",
           "l1_weight", "fidelity_mask", "zeromean", "normalise", "zpad",
           "bcrop", "Pcn", "getPcn", "AXIS_K", "AXIS_C", "AXIS_M"]

# the axes of the internal CSC layout's leading dimensions: signals K,
# channels C, filters M (the JAX package's constants)
AXIS_K = 0
AXIS_C = 1
AXIS_M = 2


@dataclass(frozen=True)
class CSCIndex:
    """Problem dimensions for convolutional sparse coding."""
    dimN: int
    dimC: int     # number of channel dims in *user* S (0 or 1)
    dimK: int     # number of signal dims in *user* S (0 or 1)
    dimCd: int    # number of channel dims in *user* D (0 or 1)
    C: int
    Cd: int
    Cx: int
    K: int
    M: int
    Nv: Tuple[int, ...]
    dsz: Tuple[int, ...]

    @property
    def N(self):
        return int(np.prod(self.Nv))

    @property
    def axisN(self):
        return tuple(range(3, 3 + self.dimN))

    @property
    def shpS(self):
        return (self.K, self.C, 1) + tuple(self.Nv)

    @property
    def shpD(self):
        return (1, self.Cd, self.M) + tuple(self.dsz)

    @property
    def shpX(self):
        return (self.K, self.Cx, self.M) + tuple(self.Nv)


def _infer_dims(D_extra_dims, S_ndim, dimK, dimN):
    dimCd = D_extra_dims
    if dimK is None:
        rdim = S_ndim - dimN
        if rdim == 0:
            dimC, dimK = 0, 0
        elif rdim == 1:
            dimC = dimCd
            dimK = S_ndim - dimN - dimC
        else:
            dimC, dimK = 1, 1
    else:
        dimC = S_ndim - dimN - dimK
    return dimC, dimK, dimCd


def csc_index(Dshape, Sshape, dimK=None, dimN=2):
    """Infer a :class:`CSCIndex` from user-shaped ``D`` and ``S``
    shapes."""
    Dshape = tuple(int(d) for d in Dshape)
    Sshape = tuple(int(d) for d in Sshape)
    dimC, dimK_, dimCd = _infer_dims(len(Dshape) - (dimN + 1),
                                     len(Sshape), dimK, dimN)
    Cd = Dshape[-2] if dimCd == 1 else 1
    C = Sshape[dimN] if dimC == 1 else 1
    if Cd > 1 and C != Cd:
        raise ValueError("Multi-channel dictionary with mismatched signal "
                         f"channels (Cd={Cd}, C={C})")
    K = Sshape[dimN + dimC] if dimK_ == 1 else 1
    return CSCIndex(dimN=dimN, dimC=dimC, dimK=dimK_, dimCd=dimCd,
                    C=C, Cd=Cd, Cx=C - Cd + 1, K=K, M=Dshape[-1],
                    Nv=Sshape[:dimN], dsz=Dshape[:dimN])


class DictionarySize:
    """Parse a dictionary size specification ``dsz``: single-scale
    ``(N0.., [Cd,] M)`` or multi-scale ``((N0..,[Cd,]M0), ...)``,
    optionally with nested per-channel specs."""

    def __init__(self, dsz, dimN=2):
        self.dsz = dsz
        if isinstance(dsz[0], tuple):
            if isinstance(dsz[0][0], tuple):
                self.ndim = len(dsz[0][0])
                self.nchn = sum(dsz[0][c][-2] for c in range(len(dsz[0])))
            else:
                self.ndim = len(dsz[0])
                self.nchn = 1 if self.ndim == dimN + 1 else dsz[0][-2]
            mxsz = np.zeros((dimN,), dtype=int)
            self.nflt = 0
            for blk in dsz:
                if isinstance(blk[0], tuple):
                    for c in blk:
                        mxsz = np.maximum(mxsz, np.asarray(c[:dimN]))
                    self.nflt += blk[0][-1]
                else:
                    mxsz = np.maximum(mxsz, np.asarray(blk[:dimN]))
                    self.nflt += blk[-1]
            self.mxsz = tuple(int(x) for x in mxsz)
        else:
            self.ndim = len(dsz)
            self.mxsz = tuple(dsz[:dimN])
            self.nflt = dsz[-1]
            self.nchn = 1 if self.ndim == dimN + 1 else dsz[-2]


@dataclass(frozen=True)
class CDUIndex:
    """Problem dimensions for the convolutional dictionary update
    (``CDU_ConvRepIndexing``, ``sporco/cnvrep.py:277-455``), driven by a
    ``dsz`` spec rather than a dictionary array."""
    dimN: int
    dimC: int
    dimK: int
    dimCd: int
    C: int
    Cd: int
    Cx: int
    K: int
    M: int
    Nv: Tuple[int, ...]
    dsz: tuple

    @property
    def N(self):
        return int(np.prod(self.Nv))

    @property
    def axisN(self):
        return tuple(range(3, 3 + self.dimN))

    @property
    def shpS(self):
        return (self.K, self.C, 1) + tuple(self.Nv)

    @property
    def shpD(self):
        # D padded to the full spatial support of the DFT-domain update
        return (1, self.Cd, self.M) + tuple(self.Nv)

    @property
    def shpX(self):
        return (self.K, self.Cx, self.M) + tuple(self.Nv)

    def csc_like(self, dsz=None):
        """The :class:`CSCIndex` of the same problem, with filter support
        ``dsz`` (default: the signal size, as the layout conversions of
        a full-support dictionary need)."""
        return CSCIndex(dimN=self.dimN, dimC=self.dimC, dimK=self.dimK,
                        dimCd=self.dimCd, C=self.C, Cd=self.Cd,
                        Cx=self.Cx, K=self.K, M=self.M, Nv=self.Nv,
                        dsz=tuple(self.Nv if dsz is None else dsz))


def cdu_index(dsz, Sshape, dimK=None, dimN=2):
    """Infer a :class:`CDUIndex` from a ``dsz`` spec and the user ``S``
    shape."""
    ds = DictionarySize(dsz, dimN)
    Sshape = tuple(int(d) for d in Sshape)
    dimC, dimK_, dimCd = _infer_dims(ds.ndim - dimN - 1, len(Sshape),
                                     dimK, dimN)
    Cd = ds.nchn
    C = Sshape[dimN] if dimC == 1 else 1
    if Cd > 1 and C != Cd:
        raise ValueError("Multi-channel dictionary with mismatched signal "
                         f"channels (Cd={Cd}, C={C})")
    K = Sshape[dimN + dimC] if dimK_ == 1 else 1
    return CDUIndex(dimN=dimN, dimC=dimC, dimK=dimK_, dimCd=dimCd,
                    C=C, Cd=Cd, Cx=C - Cd + 1, K=K, M=ds.nflt,
                    Nv=Sshape[:dimN],
                    dsz=dsz if isinstance(dsz[0], tuple) else tuple(dsz))


def to_internal_S(S, cri):
    """User ``Nv + [C] + [K]`` -> internal ``(K, C, 1, Nv...)``."""
    S = torch.as_tensor(S)
    dimN = cri.dimN
    if cri.dimC == 0:
        S = S.unsqueeze(dimN)
    if cri.dimK == 0:
        S = S.unsqueeze(dimN + 1)
    perm = (dimN + 1, dimN) + tuple(range(dimN))
    return S.permute(perm).unsqueeze(2)


def to_internal_D(D, cri):
    """User ``dsz + [Cd] + (M,)`` -> internal ``(1, Cd, M, dsz...)``."""
    D = torch.as_tensor(D)
    dimN = cri.dimN
    if cri.dimCd == 0:
        D = D.unsqueeze(dimN)
    perm = (dimN, dimN + 1) + tuple(range(dimN))
    return D.permute(perm).unsqueeze(0)


def from_internal_D(D, cri, squeeze=True):
    """Internal ``(1, Cd, M, sz...)`` -> user ``sz + [Cd] + (M,)``."""
    D = torch.as_tensor(D)[0]
    dimN = D.ndim - 2
    D = D.permute(tuple(range(2, 2 + dimN)) + (0, 1))
    if squeeze and cri.dimCd == 0:
        D = D.squeeze(dimN)
    return D


def to_internal_X(X, cri):
    """Reference layout ``Nv + (Cx, K, M)`` -> internal
    ``(K, Cx, M, Nv...)``."""
    X = torch.as_tensor(X)
    dimN = cri.dimN
    return X.permute((dimN + 1, dimN, dimN + 2) + tuple(range(dimN)))


def from_internal_X(X, cri):
    """Internal ``(K, Cx, M, Nv...)`` -> reference layout
    ``Nv + (Cx, K, M)``."""
    X = torch.as_tensor(X)
    dimN = X.ndim - 3
    return X.permute(tuple(range(3, 3 + dimN)) + (1, 0, 2))


def l1_weight(W, cri):
    """Convert a user-shaped l1 weight array to an internal-broadcastable
    array: scalar; ``S.shape``; ``S.shape + (M,)``; or the full
    reference-internal ``Nv + (C, K, M)`` (same rules as the JAX
    package)."""
    W = torch.as_tensor(W)
    if W.ndim == 0 or W.numel() == 1:
        return W.reshape((1,) * (3 + cri.dimN))
    dimN = cri.dimN
    sdim = dimN + cri.dimC + cri.dimK
    if W.ndim == sdim:
        return to_internal_S(W, cri)
    if W.ndim == sdim + 1 and W.ndim < dimN + 3:
        Wx = W
        if cri.dimC == 0:
            Wx = Wx.unsqueeze(dimN)
        if cri.dimK == 0:
            Wx = Wx.unsqueeze(dimN + 1)
        return to_internal_X(Wx, cri)
    if W.ndim == dimN + 3:
        return to_internal_X(W, cri)
    raise ValueError(f"Cannot infer internal shape for weight array with "
                     f"shape {tuple(W.shape)}")


def fidelity_mask(W, cri):
    """Convert a user-shaped data-fidelity mask to the internal layout,
    broadcastable against ``(K, C, 1, Nv...)`` (capability of
    ``mskWshape``, ``sporco/cnvrep.py:554``; same rules as the JAX
    package): a scalar; a spatial mask ``Nv``; ``Nv`` plus one axis,
    which is the signal axis when S has one channel and several signals
    and the channel axis otherwise; or ``Nv + (C, K)`` (with an optional
    trailing axis, of which index 0 is taken)."""
    W = torch.as_tensor(W)
    if W.ndim == 0 or W.numel() == 1:
        return W.reshape((1,) * (3 + cri.dimN))
    dimN = cri.dimN
    ckdim = W.ndim - dimN
    if ckdim <= 0:
        return W.reshape((1, 1, 1) + tuple(W.shape))
    if ckdim >= 2:
        Wck = W if ckdim == 2 else W[..., 0]
        perm = (dimN + 1, dimN) + tuple(range(dimN))
        return Wck.permute(perm).unsqueeze(2)
    Wi = W.permute((dimN,) + tuple(range(dimN)))
    if cri.C == 1 and cri.K > 1:
        return Wi[:, None, None]              # (K, 1, 1, Nv...)
    return Wi[None, :, None]                  # (1, C, 1, Nv...)


# ---------------------------------------------------------------------------
# The dictionary constraint set (spatial axes trailing, the filter axis at
# ``-dimN-1`` and the channel axis at ``-dimN-2``)

def _iter_dsz_blocks(dsz, dimN):
    """Yield ``(m0, m1, c0, c1, support)`` for each block of a ``dsz``
    spec (``c0``/``c1`` None: all channels)."""
    if not isinstance(dsz[0], tuple):
        yield 0, dsz[-1], None, None, tuple(dsz[:dimN])
        return
    m0 = 0
    for blk in dsz:
        if isinstance(blk[0], tuple):
            m1 = m0 + blk[0][-1]
            c0 = 0
            for cblk in blk:
                c1 = c0 + cblk[-2]
                yield m0, m1, c0, c1, tuple(cblk[:dimN])
                c0 = c1
        else:
            m1 = m0 + blk[-1]
            yield m0, m1, None, None, tuple(blk[:dimN])
        m0 = m1


def _blk_slice(v, m0, m1, c0, c1, support, dimN):
    sl = [slice(None)] * v.ndim
    axM = v.ndim - dimN - 1
    axC = v.ndim - dimN - 2
    sl[axM] = slice(m0, m1)
    if c0 is not None and axC >= 0:
        sl[axC] = slice(c0, c1)
    for k in range(dimN):
        sl[v.ndim - dimN + k] = slice(0, support[k])
    return tuple(sl)


def zeromean(v, dsz, dimN=2):
    """Subtract each filter's mean over its own support, not over the
    zero-padded embedding (``sporco/cnvrep.py:609``)."""
    axisN = tuple(range(v.ndim - dimN, v.ndim))
    out = v.clone()
    for m0, m1, c0, c1, sup in _iter_dsz_blocks(dsz, dimN):
        sl = _blk_slice(v, m0, m1, c0, c1, sup, dimN)
        out[sl] = out[sl] - torch.mean(v[sl], dim=axisN, keepdim=True)
    return out


def _normalise_axes(v, axes):
    sq = v.abs() ** 2 if v.is_complex() else v * v
    vn = torch.sqrt(torch.sum(sq, dim=axes, keepdim=True))
    vn = torch.where(vn == 0.0, torch.ones_like(vn), vn)
    return (v / vn).to(v.dtype)


def normalise(v, dimN=2):
    """Unit l2 norm over the trailing ``dimN`` axes; a filter of norm 0
    stays 0 (``sporco/cnvrep.py:673``).  :func:`Pcn` folds the channel
    axis in."""
    return _normalise_axes(v, tuple(range(v.ndim - dimN, v.ndim)))


def _norm_axes(v, dimN):
    """The axes of the unit-norm constraint: the spatial ones and the
    channel axis where ``v`` has one (the reference normalises a colour
    filter jointly over its channels)."""
    axes = tuple(range(v.ndim - dimN, v.ndim))
    axC = v.ndim - dimN - 2
    if axC >= 0:
        axes = (axC,) + axes
    return axes


def zpad(v, Nv):
    """Zero-pad the trailing spatial axes to ``Nv`` on the high side
    (``sporco/cnvrep.py:704``)."""
    dimN = len(Nv)
    lead = tuple(v.shape[:v.ndim - dimN])
    out = torch.zeros(lead + tuple(Nv), dtype=v.dtype, device=v.device)
    out[(Ellipsis,) + tuple(slice(0, n) for n in v.shape[v.ndim - dimN:])] \
        = v
    return out


def bcrop(v, dsz, dimN=2):
    """Crop each filter to its support of the ``dsz`` spec
    (``sporco/cnvrep.py:729``); the spatial size of the result is the
    largest support."""
    ds = DictionarySize(dsz, dimN)
    out = torch.zeros(tuple(v.shape[:v.ndim - dimN]) + tuple(ds.mxsz),
                      dtype=v.dtype, device=v.device)
    for m0, m1, c0, c1, sup in _iter_dsz_blocks(dsz, dimN):
        sl = _blk_slice(out, m0, m1, c0, c1, sup, dimN)
        out[sl] = v[sl]
    return out


def Pcn(x, dsz, Nv, dimN=2, crp=False, zm=False):
    """Projection onto the dictionary constraint set
    (``sporco/cnvrep.py:868``): crop to each filter's support, zero-pad
    back to ``Nv`` (unless ``crp``), subtract each filter's mean (with
    ``zm``), then unit l2 norm over the support and channel axes."""
    x = bcrop(x, dsz, dimN)
    if not crp:
        x = zpad(x, Nv)
    if zm:
        x = zeromean(x, dsz, dimN)
    return _normalise_axes(x, _norm_axes(x, dimN))


def getPcn(dsz, Nv, dimN=2, crp=False, zm=False):
    """:func:`Pcn` with its flags bound (``sporco/cnvrep.py:916``)."""
    def pcn(x):
        return Pcn(x, dsz, Nv, dimN=dimN, crp=crp, zm=zm)
    return pcn
