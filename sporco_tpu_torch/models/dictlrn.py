"""Dictionary learning by alternation (counterpart of
``sporco_tpu.models.dictlrn``): :class:`DictLearn`
(``sporco/dictlrn/dictlrn.py:187``), :class:`BPDNDictLearn`
(``dictlrn/bpdndl.py:23``), :class:`WeightedBPDNDictLearn`
(``dictlrn/wbpdndl.py:24``), :class:`ConvBPDNDictLearn`
(``sporco/dictlrn/cbpdndl.py:231``), :class:`ConvBPDNMaskDictLearn`
(``dictlrn/cbpdndlmd.py:236``) and online (SGD) CDL,
:class:`OnlineConvBPDNDictLearn` and its masked form
(``dictlrn/onlinecdl.py:33,464``).

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

The masked learner takes ``ConvBPDNMaskDcpl`` (or the FISTA
``ConvBPDNMask``) and the masked update of
:mod:`sporco_tpu_torch.models.ccmodmd` (or the FISTA
``ConvCnstrMODMask``).  Online CDL sparse-codes each sample with a fresh
``ConvBPDN`` (fused where the geometry allows it) or
``ConvBPDNMaskDcpl``, then takes one DFT-domain SGD step on the
dictionary.  The learners on vectors alternate the dense ``BPDN`` and
``CnstrMOD`` models (ADMM, or FISTA for the weighted form).

The fused consensus loop lives in :mod:`sporco_tpu_torch.parallel.consensus`.
"""

import collections
import warnings

import numpy as np
import torch

from sporco_tpu_torch import cnvrep as cr
from sporco_tpu_torch import refopts
from sporco_tpu_torch._device import fp32_precision, resolve_device
from sporco_tpu_torch.models import bpdn as _bpdn
from sporco_tpu_torch.models import cbpdn as _cbpdn
from sporco_tpu_torch.models import ccmod as _ccmod
from sporco_tpu_torch.models import ccmodmd as _ccmodmd
from sporco_tpu_torch.models import cmod as _cmod
from sporco_tpu_torch.models import pgm as _pgm
from sporco_tpu_torch.models.common import user_tensor
from sporco_tpu_torch.ops import fft as sf
from sporco_tpu_torch.ops import linalg as sl
from sporco_tpu_torch.utils.timer import Timer

__all__ = ["DictLearn", "BPDNDictLearn", "WeightedBPDNDictLearn",
           "ConvBPDNDictLearn", "ConvBPDNMaskDictLearn",
           "OnlineConvBPDNDictLearn", "OnlineConvBPDNMaskDictLearn"]


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


class BPDNDictLearn(DictLearn):
    r"""Dictionary learning on vectors (``dictlrn/bpdndl.py:23``): the
    ADMM ``BPDN`` x-step and the ADMM ``CnstrMOD`` dictionary update,
    one iteration each an outer iteration.  ``D0`` is (N, M), ``S`` (N,
    K); ``D0``'s columns are normalised first.  Each hand-over of the
    dictionary makes the x-step's Gram eigendecomposition anew.
    ``device=None`` means the CUDA device and raises without one;
    ``device="cpu"`` runs on the CPU."""

    def __init__(self, D0, S, lmbda=None, opt=None, max_iter=100,
                 xopt=None, dopt=None, dtype=torch.float64, device=None):
        device = resolve_device(device)
        if isinstance(opt, dict):
            # reference-style option tree (sporco/dictlrn/bpdndl.py:48)
            outer, subs = _ref_dl_opt(opt, ("BPDN", "CMOD"))
            if outer["max_iter"] is not None:
                max_iter = outer["max_iter"]
            xopt = _sub_opts(_bpdn.BPDN, subs["BPDN"], xopt)
            dopt = _sub_opts(_cmod.CnstrMOD, subs["CMOD"], dopt)
        dtype = sf.torch_dtype(dtype)
        D0, S = _bpdn._dense(D0, S, dtype, device)
        D0 = _cmod.normalise(D0)
        # every inner solve runs its one iteration: the reference runs
        # its single inner iteration unconditionally
        xopt = (_bpdn.BPDN.options(max_iter=1, rel_stop_tol=0.0)
                if xopt is None
                else xopt.replace(max_iter=1, rel_stop_tol=0.0))
        dopt = (_cmod.CnstrMOD.options(max_iter=1, rel_stop_tol=0.0)
                if dopt is None
                else dopt.replace(max_iter=1, rel_stop_tol=0.0))
        xstep = _bpdn.BPDN(D0, S, lmbda, opt=xopt, dtype=dtype,
                           device=device)
        Z0 = torch.zeros((D0.shape[1], S.shape[1]), dtype=dtype)
        dstep = _cmod.CnstrMOD(Z0, S, opt=dopt, D0=D0, dtype=dtype,
                               device=device)
        super().__init__(xstep, dstep, max_iter=max_iter)

    def post_dstep(self):
        D = self.dstep.getdict()
        # the dictionary changed: the BPDN Gram factor is made anew
        self.xstep.params = {**self.xstep.params, "D": D,
                             "factor": sl.gram_eig_factor(D)}


class WeightedBPDNDictLearn(DictLearn):
    r"""Dictionary learning with a weighted l2 data term
    (``dictlrn/wbpdndl.py:24``): the PGM ``WeightedBPDN`` x-step and the
    PGM ``WeightedCnstrMOD`` dictionary update, one iteration each."""

    def __init__(self, D0, S, lmbda=None, W=None, opt=None, max_iter=100,
                 dtype=torch.float64, device=None):
        device = resolve_device(device)
        dtype = sf.torch_dtype(dtype)
        D0, S = _bpdn._dense(D0, S, dtype, device)
        D0 = _cmod.normalise(D0)
        xopt = _pgm.WeightedBPDN.options(max_iter=1, rel_stop_tol=0.0)
        dopt = _pgm.WeightedCnstrMOD.options(max_iter=1, rel_stop_tol=0.0)
        xstep = _pgm.WeightedBPDN(D0, S, lmbda, W=W, opt=xopt, dtype=dtype,
                                  device=device)
        Z0 = torch.zeros((D0.shape[1], S.shape[1]), dtype=dtype)
        dstep = _pgm.WeightedCnstrMOD(Z0, S, W=W, opt=dopt, D0=D0,
                                      dtype=dtype, device=device)
        super().__init__(xstep, dstep, max_iter=max_iter)

    def post_dstep(self):
        self.xstep.params = {**self.xstep.params,
                             "D": self.dstep.getdict()}


class ConvBPDNMaskDictLearn(ConvBPDNDictLearn):
    r"""Masked convolutional dictionary learning
    (``dictlrn/cbpdndlmd.py:236``): the mask-decoupled CSC x-step
    (``xmethod='admm'``: ``ConvBPDNMaskDcpl``; ``'pgm'``:
    ``pgm.ConvBPDNMask``) and the masked dictionary update
    (``dmethod`` ``'cns'``, ``'ism'`` or ``'cg'``: ``ccmodmd``; ``'pgm'``:
    ``pgm.ConvCnstrMODMask``), one iteration each an outer iteration.
    ``W`` is the fidelity mask in the layout of ``S``.  ``device=None``
    means the CUDA device and raises without one; ``device="cpu"`` runs
    on the CPU."""

    def __init__(self, D0, S, lmbda=None, W=None, opt=None,
                 xmethod="admm", dmethod="cns", max_iter=100, dimK=None,
                 dimN=2, zero_mean=False, dtype=torch.float64, xopt=None,
                 dopt=None, device=None):
        if dmethod not in ("ism", "cg", "cns", "pgm"):
            raise ValueError(f"unknown dmethod {dmethod!r}")
        if xmethod not in ("admm", "pgm"):
            raise ValueError(f"unknown xmethod {xmethod!r}")
        device = resolve_device(device)
        if isinstance(opt, dict):
            # reference-style option tree (sporco/dictlrn/cbpdndlmd.py)
            outer, subs = _ref_dl_opt(opt, ("CBPDN", "CCMOD"))
            if outer["max_iter"] is not None:
                max_iter = outer["max_iter"]
            xcls = (_cbpdn.ConvBPDNMaskDcpl if xmethod == "admm"
                    else _pgm.ConvBPDNMask)
            dcls = (_pgm.ConvCnstrMODMask if dmethod == "pgm"
                    else _ccmodmd.ConvCnstrMODMaskDcpl_Consensus)
            xopt = _sub_opts(xcls, subs["CBPDN"], xopt)
            zm = {"zero_mean": None}
            dopt = _sub_opts(dcls, subs["CCMOD"], dopt, zm)
            if zm["zero_mean"] is not None:
                zero_mean = zm["zero_mean"]
        if xopt is not None:
            xopt = xopt.replace(rel_stop_tol=0.0)
        if dopt is not None:
            dopt = dopt.replace(rel_stop_tol=0.0)
        dtype = sf.torch_dtype(dtype)
        npdt = sf.numpy_dtype(dtype)
        D0 = _cbpdn.host_array(D0).astype(npdt)
        S = _cbpdn.host_array(S).astype(npdt)
        self.xmethod = xmethod
        self.dmethod = dmethod
        dsz = D0.shape
        cri0 = cr.csc_index(D0.shape, S.shape, dimK=dimK, dimN=dimN)
        D0i = cr.Pcn(cr.to_internal_D(torch.as_tensor(D0), cri0),
                     tuple(dsz), dsz[:dimN], dimN=dimN, zm=zero_mean)
        D0u = cr.from_internal_D(D0i, cri0).numpy()
        common = dict(dimK=dimK, dimN=dimN, dtype=dtype, device=device)

        if xmethod == "admm":
            xopt = (_cbpdn.ConvBPDNMaskDcpl.options(rel_stop_tol=0.0)
                    if xopt is None else xopt).replace(max_iter=1)
            xstep = _cbpdn.ConvBPDNMaskDcpl(D0u, S, lmbda, W=W, opt=xopt,
                                            **common)
        else:
            xopt = (_pgm.ConvBPDNMask.options(rel_stop_tol=0.0)
                    if xopt is None else xopt).replace(max_iter=1)
            xstep = _pgm.ConvBPDNMask(D0u, S, lmbda, W=W, opt=xopt,
                                      **common)

        if dmethod == "pgm":
            dopt = (_pgm.ConvCnstrMODMask.options(rel_stop_tol=0.0)
                    if dopt is None else dopt).replace(max_iter=1)
            dstep = _pgm.ConvCnstrMODMask(None, S, dsz, W=W, opt=dopt,
                                          D0=D0u, zero_mean=zero_mean,
                                          **common)
            dstep.setcoef(torch.zeros(xstep.cri.shpX, dtype=dtype),
                          internal=True)
        else:
            dopt = (_ccmodmd.ConvCnstrMODMaskDcplOptions(
                method=dmethod, max_iter=1, rel_stop_tol=0.0)
                if dopt is None else dopt.replace(max_iter=1))
            dstep = _ccmodmd.ConvCnstrMODMaskDcpl(
                None, S, W, dsz, opt=dopt, method=dmethod, D0=D0u,
                zero_mean=zero_mean, **common)
            # warm start: the padded D0 in the dictionary block
            D0pad = cr.zpad(D0i, dstep.cri.Nv).to(device)
            Y0, Y1 = dstep.state.Y
            dstep.state = dstep.state._replace(
                Y=(D0pad, Y1) if dmethod == "cns" else (Y0, D0pad))
        DictLearn.__init__(self, xstep, dstep, max_iter=max_iter)

    def post_xstep(self):
        # the coefficient block Y1 of the ADMM x-step, X of the FISTA one
        self.dstep.setcoef(self.xstep.getcoef_internal(), internal=True)

    def post_dstep(self):
        Dfull = self.dstep.getdict_internal()
        Dcrop = cr.bcrop(Dfull, self.dstep.cri.dsz, self.dstep.cri.dimN)
        if self.xmethod == "admm":
            self.xstep.params = {**self.xstep.params, "D": Dcrop}
        else:
            self.xstep.setdict(internal=Dcrop)


# ---------------------------------------------------------------------------
# Online (SGD) convolutional dictionary learning

def _online_dstep(D, Z, S, eta, Nv):
    """One DFT-domain SGD step on the dictionary (liu-2018-first;
    ``dictlrn/onlinecdl.py:310-333``): ``Ghat = Dhat - eta Zhat^H (Zhat
    Dhat - Shat)``, the gradient of a multi-channel signal summed over
    its channels.  The projection on the constraint set follows."""
    axes = tuple(range(-len(Nv), 0))
    Df = sf.rfftn(D, axes=axes)
    Zf = sf.rfftn(Z, axes=axes)
    Ryf = torch.sum(Zf * Df, dim=2, keepdim=True) - sf.rfftn(S, axes=axes)
    gradf = torch.sum(Zf.conj() * Ryf, dim=0, keepdim=True)
    if gradf.shape[1] > D.shape[1]:     # C > Cd = 1
        gradf = torch.sum(gradf, dim=1, keepdim=True)
    return sf.irfftn(Df - eta * gradf, s=Nv, axes=axes)


class OnlineConvBPDNDictLearn:
    r"""Online convolutional dictionary learning (liu-2018-first;
    ``dictlrn/onlinecdl.py:33``): each ``solve(S)`` sparse-codes the
    sample ``S`` with a fresh ``ConvBPDN`` on the current dictionary (50
    iterations by default), then takes one projected SGD step on the
    dictionary with step size ``eta_a / (j + eta_b)``.  ``device=None``
    means the CUDA device and raises without one; ``device="cpu"`` runs
    on the CPU."""

    MASKED = False

    def __init__(self, D0, lmbda=None, opt=None, eta_a=10.0, eta_b=5.0,
                 zero_mean=False, dimN=2, cbpdn_opt=None,
                 dtype=torch.float32, device=None):
        self.device = resolve_device(device)
        if isinstance(opt, dict):
            # reference-style option tree (sporco/dictlrn/onlinecdl.py:80)
            d = dict(refopts._expand_tuple_keys(opt))
            for k in ("Verbose", "StatusHeader", "IterTimer",
                      "CUDA_CBPDN"):
                d.pop(k, None)
            if d.pop("DictSize", None) is not None:
                warnings.warn("DictSize is not supported by the online "
                              "coordinator; the dictionary size comes "
                              "from D0", stacklevel=2)
            if d.pop("DataType", None) is not None:
                dtype = opt["DataType"]
            eta_a = d.pop("eta_a", eta_a)
            eta_b = d.pop("eta_b", eta_b)
            zero_mean = d.pop("ZeroMean", zero_mean)
            sub = d.pop("CBPDN", None)
            if d:
                raise refopts.UnknownKeyError(
                    f"unknown online-CDL option keys {sorted(d)}")
            xcls = (_cbpdn.ConvBPDNMaskDcpl if self.MASKED
                    else _cbpdn.ConvBPDN)
            cbpdn_opt = _sub_opts(xcls, sub, cbpdn_opt)
        self.dtype = sf.torch_dtype(dtype)
        self.D0 = user_tensor(D0, self.dtype, self.device)
        self.dsz = tuple(self.D0.shape)
        self.lmbda = lmbda
        self.eta_a = eta_a
        self.eta_b = eta_b
        self.zero_mean = zero_mean
        self.dimN = dimN
        self.cbpdn_opt = cbpdn_opt
        self.j = 0
        self.cri = None
        self.xstep = None   # the last sample's sparse coding model
        self.D = None       # the full-size internal dictionary
        self.Dcrop = None
        self.itstat = collections.defaultdict(list)
        self.timer = Timer(["init", "solve"])

    def _xsolve(self, S, W=None, dimK=None):
        """The sparse coding model of one sample on the current
        dictionary."""
        opt = self.cbpdn_opt
        kw = dict(dimK=dimK, dimN=self.dimN, dtype=self.dtype,
                  device=self.device)
        if self.MASKED:
            if opt is None:
                opt = _cbpdn.ConvBPDNMaskDcpl.options(max_iter=50)
            return _cbpdn.ConvBPDNMaskDcpl(self.getdict(), S, self.lmbda,
                                           W=W, opt=opt, **kw)
        if opt is None:
            opt = _cbpdn.ConvBPDN.options(max_iter=50)
        return _cbpdn.ConvBPDN(self.getdict(), S, self.lmbda, opt=opt,
                               **kw)

    def solve(self, S, W=None, dimK=None):
        """Sparse-code the sample ``S`` (with the fidelity mask ``W`` in
        the masked form) on the current dictionary, then update the
        dictionary; returns it in the user layout."""
        self.timer.start("solve")
        self.xstep = xstep = self._xsolve(S, W=W, dimK=dimK)
        xstep.solve()
        cri = xstep.cri
        if self.cri is None:
            self.cri = cri
            self.D = cr.zpad(cr.to_internal_D(self.D0, cri), cri.Nv)
        eta = self.eta_a / (self.j + self.eta_b)
        with fp32_precision(), torch.no_grad():
            G = _online_dstep(self.D, xstep.getcoef_internal(),
                              xstep.params["S"],
                              float(sf.numpy_dtype(self.dtype).type(eta)),
                              cri.Nv)
            self.D = cr.Pcn(G, self.dsz, cri.Nv, dimN=self.dimN,
                            zm=self.zero_mean)
        self.Dcrop = cr.bcrop(self.D, self.dsz, self.dimN)
        xs = xstep.getitstat()
        self.itstat["Iter"].append(self.j)
        for n in xs._names:
            if n != "Iter":
                v = getattr(xs, n)
                self.itstat[f"X{n}"].append(float(v[-1]) if len(v)
                                            else np.nan)
        self.itstat["Eta"].append(eta)
        self.j += 1
        self.timer.stop("solve")
        return self.getdict()

    def getdict(self):
        if self.cri is None:
            return self.D0
        return cr.from_internal_D(self.Dcrop, self.cri)

    def getitstat(self):
        return {k: np.asarray(v) for k, v in self.itstat.items()}


class OnlineConvBPDNMaskDictLearn(OnlineConvBPDNDictLearn):
    r"""Masked online CDL (``dictlrn/onlinecdl.py:464``): the sparse coding
    step is ``ConvBPDNMaskDcpl`` with the sample's mask ``W``; the
    dictionary gradient takes the sample and its coefficient block
    ``Y1``, as the JAX package does."""
    MASKED = True
