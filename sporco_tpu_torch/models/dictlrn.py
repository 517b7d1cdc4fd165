"""Dictionary learning by alternation (counterpart of
``sporco_tpu.models.dictlrn``): :class:`DictLearn`
(``sporco/dictlrn/dictlrn.py:187``) and :class:`ConvBPDNDictLearn`
(``sporco/dictlrn/cbpdndl.py:231``).

Each outer iteration runs one warm-started iteration of the sparse
coding solver (the x-step), hands its coefficients to the dictionary
update (the d-step), runs one iteration of that, and hands the
dictionary back, as the reference does (``dictlrn/cbpdndl.py:50-56``).
Transfers stay in the internal layout.  The x-step is ``ConvBPDN`` (or
``ConvBPDNGradReg`` with ``mu > 0``) by ADMM, or ``pgm.ConvBPDN`` by
FISTA; at a fused-eligible geometry it runs its fused driver and so one
launch of ``csc_iter`` (or ``pgm_iter``) per outer iteration.  The
d-step is ``ConvCnstrMOD`` by ADMM (``ism``, ``cg`` or ``cns``) or by
FISTA (``pgm``, :class:`sporco_tpu_torch.models.pgm.ConvCnstrMOD`).

The fused consensus loop lives in :mod:`sporco_tpu_torch.parallel.consensus`.
"""

import collections
import warnings

import numpy as np
import torch

from sporco_tpu_torch import cnvrep as cr
from sporco_tpu_torch import refopts
from sporco_tpu_torch._device import resolve_device
from sporco_tpu_torch.models import cbpdn as _cbpdn
from sporco_tpu_torch.models import ccmod as _ccmod
from sporco_tpu_torch.models import pgm as _pgm
from sporco_tpu_torch.ops import fft as sf
from sporco_tpu_torch.utils.timer import Timer

__all__ = ["DictLearn", "ConvBPDNDictLearn"]


def _ref_dl_opt(opt, subnames):
    """Split a reference-style DictLearn option dict
    (``sporco/dictlrn/dictlrn.py:213``, ``cbpdndl.py:270-290``) into the
    outer fields and the inner solvers' subtrees.  Unknown keys raise, as
    in ``cdict``; tuple keys address nested nodes."""
    d = dict(refopts._expand_tuple_keys(opt))
    outer = {"max_iter": d.pop("MaxMainIter", None),
             "dsz": d.pop("DictSize", None)}
    for k in ("Verbose", "StatusHeader", "IterTimer", "Callback"):
        d.pop(k, None)
    if d.pop("AccurateDFid", None):
        warnings.warn("AccurateDFid is not supported; DFid is reported "
                      "from the inner solver state", stacklevel=3)
    subs = {n: d.pop(n, None) for n in subnames}
    if d:
        raise refopts.UnknownKeyError(
            f"unknown DictLearn option keys {sorted(d)}")
    return outer, subs


def _sub_opts(cls, sub, current, known_kw_out=None):
    """Translate an inner solver's subtree to ``cls``'s native options
    (``current`` unchanged when ``sub`` is None or ``current`` was
    given).  Model keys named in ``known_kw_out`` are moved into it; any
    other model key raises."""
    if sub is None or current is not None:
        return current
    opts, kw = refopts.translate(cls, sub)
    if known_kw_out:
        for k in list(kw):
            if k in known_kw_out:
                known_kw_out[k] = kw.pop(k)
    if kw:
        raise refopts.UnknownKeyError(
            f"inner option keys mapping to constructor arguments "
            f"{sorted(kw)} are not configurable through the "
            f"coordinator; construct the inner solver directly")
    return opts


class DictLearn:
    """The dictionary learning alternation
    (``dictlrn/dictlrn.py:326-375``): each outer iteration runs
    ``xstep.solve()``, hands the coefficients over, runs
    ``dstep.solve()`` and hands the dictionary back.  Subclasses define
    the hand-overs."""

    def __init__(self, xstep, dstep, max_iter=100):
        self.xstep = xstep
        self.dstep = dstep
        self.max_iter = max_iter
        self.j = 0
        self.itstat = collections.defaultdict(list)
        self.timer = Timer(["init", "solve"])

    def post_xstep(self):
        self.dstep.setcoef(self.xstep.getcoef())

    def post_dstep(self):
        self.xstep.setdict(self.dstep.getdict())

    def _record(self):
        rec = {"Iter": self.j}
        for src, prefix in ((self.xstep.getitstat(), "X"),
                            (self.dstep.getitstat(), "D")):
            for name in src._names:
                if name == "Iter":
                    continue
                v = getattr(src, name)
                rec[f"{prefix}{name}"] = float(v[-1]) if len(v) else np.nan
        for k, v in rec.items():
            self.itstat[k].append(v)

    def solve(self):
        self.timer.start("solve")
        for self.j in range(self.j, self.j + self.max_iter):
            self.xstep.solve()
            self.post_xstep()
            self.dstep.solve()
            self.post_dstep()
            self._record()
        self.j += 1
        self.timer.stop("solve")
        return self.getdict()

    def getdict(self):
        return self.dstep.getdict()

    def getcoef(self):
        return self.xstep.getcoef()

    def getitstat(self):
        return {k: np.asarray(v) for k, v in self.itstat.items()}


class ConvBPDNDictLearn(DictLearn):
    r"""Convolutional dictionary learning: a CSC solver (``xmethod``
    ``'admm'`` or ``'pgm'``) alternating with a convolutional dictionary
    update (``dmethod`` ``'ism'``, ``'cg'``, ``'cns'`` or ``'pgm'``)
    (``dictlrn/cbpdndl.py:31-229,231``).  ``mu > 0`` makes the ADMM
    x-step ``ConvBPDNGradReg``.  ``dsz`` may be a multi-scale size spec,
    ``D0`` then the largest support zero-padded.  ``device=None`` means
    the CUDA device and raises without one; ``device="cpu"`` runs on the
    CPU."""

    def __init__(self, D0, S, lmbda=None, opt=None, xmethod="admm",
                 dmethod="cns", max_iter=100, dimK=None, dimN=2,
                 xopt=None, dopt=None, zero_mean=False,
                 dtype=torch.float64, dsz=None, mu=0.0, wgrd=1.0,
                 device=None):
        if dmethod not in ("ism", "cg", "cns", "pgm"):
            raise ValueError(f"unknown dmethod {dmethod!r}")
        if xmethod not in ("admm", "pgm"):
            raise ValueError(f"unknown xmethod {xmethod!r}")
        device = resolve_device(device)
        if isinstance(opt, dict):
            # reference-style option tree (sporco/dictlrn/cbpdndl.py:270)
            outer, subs = _ref_dl_opt(opt, ("CBPDN", "CCMOD"))
            if outer["max_iter"] is not None:
                max_iter = outer["max_iter"]
            if outer["dsz"] is not None and dsz is None:
                dsz = outer["dsz"]
            if xmethod != "admm":
                xcls = _pgm.ConvBPDN
            elif mu > 0.0:
                xcls = _cbpdn.ConvBPDNGradReg
            else:
                xcls = _cbpdn.ConvBPDN
            xkw = {"wgrd": None} if xcls is _cbpdn.ConvBPDNGradReg \
                else None
            xopt = _sub_opts(xcls, subs["CBPDN"], xopt, xkw)
            if xkw and xkw["wgrd"] is not None:
                wgrd = xkw["wgrd"]
            dcls = (_pgm.ConvCnstrMOD if dmethod == "pgm"
                    else _ccmod.ConvCnstrMODBase)
            zm = {"zero_mean": None}
            dopt = _sub_opts(dcls, subs["CCMOD"], dopt, zm)
            if zm["zero_mean"] is not None:
                zero_mean = zm["zero_mean"]
        # every inner solve runs its one iteration, even where the stale
        # residuals of the last outer iteration pass the tolerance: the
        # reference runs MaxMainIter=1 unconditionally
        if xopt is not None:
            xopt = xopt.replace(rel_stop_tol=0.0)
        if dopt is not None:
            dopt = dopt.replace(rel_stop_tol=0.0)
        dtype = sf.torch_dtype(dtype)
        npdt = sf.numpy_dtype(dtype)
        D0 = np.asarray(D0).astype(npdt)
        S = np.asarray(S).astype(npdt)
        self.xmethod = xmethod
        self.dmethod = dmethod
        if dsz is None:
            dsz = D0.shape
        # the initial dictionary projected on the constraint set
        # (dictlrn/cbpdndl.py:385)
        cri0 = cr.csc_index(D0.shape, S.shape, dimK=dimK, dimN=dimN)
        D0i = cr.Pcn(cr.to_internal_D(torch.as_tensor(D0), cri0),
                     tuple(dsz), D0.shape[:dimN], dimN=dimN, zm=zero_mean)
        D0u = cr.from_internal_D(D0i, cri0).numpy()

        if xmethod == "admm":
            xopt = (_cbpdn.ConvBPDN.options(max_iter=1, rel_stop_tol=0.0)
                    if xopt is None
                    else xopt.replace(max_iter=1, rel_stop_tol=0.0))
            if mu > 0.0:
                xstep = _cbpdn.ConvBPDNGradReg(
                    D0u, S, lmbda, mu=mu, wgrd=wgrd, opt=xopt, dimK=dimK,
                    dimN=dimN, dtype=dtype, device=device)
            else:
                xstep = _cbpdn.ConvBPDN(D0u, S, lmbda, opt=xopt, dimK=dimK,
                                        dimN=dimN, dtype=dtype,
                                        device=device)
        else:
            xopt = (_pgm.ConvBPDN.options(max_iter=1, rel_stop_tol=0.0)
                    if xopt is None else xopt.replace(max_iter=1))
            xstep = _pgm.ConvBPDN(D0u, S, lmbda, opt=xopt, dimK=dimK,
                                  dimN=dimN, dtype=dtype, device=device)

        if dmethod == "pgm":
            dopt_ = (_pgm.ConvCnstrMOD.options(max_iter=1, rel_stop_tol=0.0)
                     if dopt is None else dopt.replace(max_iter=1))
            dstep = _pgm.ConvCnstrMOD(None, S, dsz, opt=dopt_, dimK=dimK,
                                      dimN=dimN, D0=D0u,
                                      zero_mean=zero_mean, dtype=dtype,
                                      device=device)
            dstep.setcoef(torch.zeros(xstep.cri.shpX, dtype=dtype),
                          internal=True)
        else:
            dopt_ = (_ccmod.ConvCnstrMODBase.options(max_iter=1,
                                                     rel_stop_tol=0.0)
                     if dopt is None else dopt.replace(max_iter=1))
            dstep = _ccmod.ConvCnstrMOD(None, S, dsz, opt=dopt_,
                                        method=dmethod, dimK=dimK,
                                        dimN=dimN, D0=D0u,
                                        zero_mean=zero_mean, dtype=dtype,
                                        device=device)
            # warm start: Y0 = the padded D0 (dictlrn/cbpdndl.py:452-456)
            dstep.state = dstep.state._replace(
                Y=cr.zpad(D0i, dstep.cri.Nv).to(device))
        super().__init__(xstep, dstep, max_iter=max_iter)

    def post_xstep(self):
        self.dstep.setcoef(self.xstep.getcoef_internal(), internal=True)

    def post_dstep(self):
        Dfull = self.dstep.getdict_internal()     # (1, Cd, M, Nv)
        self.xstep.setdict(
            internal=cr.bcrop(Dfull, self.dstep.cri.dsz,
                              self.dstep.cri.dimN))

    def reconstruct(self, X=None):
        return self.xstep.reconstruct(X)
