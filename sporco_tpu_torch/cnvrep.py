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

__all__ = ["CSCIndex", "csc_index", "DictionarySize", "to_internal_S",
           "to_internal_D", "to_internal_X", "from_internal_X",
           "from_internal_D", "l1_weight", "fidelity_mask"]


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
