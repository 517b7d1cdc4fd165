"""Consensus convolutional dictionary learning on one device (counterpart
of ``sporco_tpu.parallel.consensus``).

The reference's multiprocessing consensus CDL
(``ConvBPDNDictLearn_Consensus``, ``sporco/dictlrn/prlcnscdl.py:275-652``,
and its masked form ``:821-1218``) as one loop of fused outer
iterations.  Each outer iteration runs, over all K signals at once:

- a CSC stage (the coefficient maps' x, relaxation, y and u steps)
  against the current dictionary, one of four by configuration:

  * the kernel stage: the spatial-Woodbury x-step's spectral glue in
    PyTorch, then one launch of the CUDA kernel ``csc_iter`` with
    ``emit_fwd=False`` (adjoint product, relaxation, soft threshold and
    dual update over the packed polyphase state, which the loop carries
    packed);
  * the spatial stage: the same x-step through
    :func:`~sporco_tpu_torch.ops.fused_csc.spatial_xstep` (or its rank-C
    form for a colour dictionary) and the tail as torch ops, for an
    array ``L1Weight`` or a colour dictionary outside the kernel rule;
  * the DFT-domain stage: per-bin Sherman-Morrison (iterated over the
    channels for a colour dictionary);
  * the masked stage: the two-block mask-decoupled x-step;

- the dictionary update of every signal's copy in the DFT domain, where
  the dictionary dual lives (a complex tensor), its consensus mean over
  the signals and the projection ``Pcn`` onto the constraint set.

As in the reference there is no residual test and no adaptive rho
(``prlcnscdl.py:319-323``): ``step(n)`` runs ``n`` outer iterations and
reads nothing back from the device.  The JAX package carries the dual as
planar real/imaginary arrays; :meth:`load_state_numpy` and
:meth:`state_numpy` convert.

With a ``mesh`` (:mod:`sporco_tpu_torch.parallel.mesh`) the signals
shard over its ``"data"`` ranks: each rank holds its block of K of the
signals, of the state and (masked) of W, and runs the outer iteration
on it; the consensus mean over the signals becomes an ``all_reduce``
(sum) over the ``"data"`` group divided by the global number of
blocks, after which every rank holds the same dictionary.
"""

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch

from sporco_tpu_torch import cnvrep as cr
from sporco_tpu_torch._device import fp32_precision, resolve_device
from sporco_tpu_torch.ops import fft as sf
from sporco_tpu_torch.ops import fused_csc as fc
from sporco_tpu_torch.ops import linalg as sl
from sporco_tpu_torch.ops import prox as sp
from sporco_tpu_torch.ops.csc_iter import csc_iter, iter_supported
from sporco_tpu_torch.parallel.mesh import (all_reduce_sum, axis_size,
                                            mesh_device, shard_batch)
from sporco_tpu_torch.utils.timer import Timer

__all__ = ["ConvBPDNDictLearn_Consensus",
           "ConvBPDNMaskDcplDictLearn_Consensus"]


@dataclass(frozen=True)
class _CnsConfig:
    cri: cr.CDUIndex
    dsz: tuple
    zero_mean: bool = False
    masked: bool = False
    relax_x: float = 1.8
    relax_d: float = 1.8
    fused_x: bool = False    # spatial-Woodbury CSC x-step
    kernel_x: bool = False   # the csc_iter stage: ZY/ZU carried packed
    ndata: int = 1           # "data" ranks the signals shard over


def _fftaxes(cri):
    return tuple(range(-cri.dimN, 0))


def _spectral_glue(cfg, Df, DY, Sf):
    """What the spatial x-step needs of this iteration's dictionary: the
    polyphase weights, their tap radii and the per-bin Gram (``D^H D``,
    or the Cd x Cd ``D D^H`` of a colour dictionary)."""
    cri = cfg.cri
    nd0, nd1 = cfg.dsz[0], cfg.dsz[1]
    n0, n1 = cri.Nv
    M, Cd = cri.M, cri.Cd
    Dsm = DY.reshape(Cd, M, n0, n1)[:, :, :nd0, :nd1]
    Wf, Wa, js = fc.xstep_kernels(Dsm if Cd > 1 else Dsm[0], nd0, nd1)
    if Cd > 1:
        gram = fc._gram(Df.reshape(Cd, M, n0, -1))
    else:
        gram = torch.sum((Df * Df.conj()).real, dim=2).reshape(n0, -1)
    return Wf, Wa, js, gram


def _body(cfg, p, st):
    """One outer iteration (``prlcnscdl.py:496-513``) on the state
    ``(ZY, ZU, ZY0, ZU0, DY, DUf)``."""
    cri = cfg.cri
    axes = _fftaxes(cri)
    Nv = cri.Nv
    K, M, Cd = cri.K, cri.M, cri.Cd
    S, Sf, W = p["S"], p["Sf"], p.get("W")
    rho_x, rho_d = p["rho_x"], p["rho_d"]
    ax, ad = cfg.relax_x, cfg.relax_d
    ZY, ZU, ZY0, ZU0, DY, DUf = st
    # --- cbpdn_setdict (prlcnscdl.py:134-148) ---
    Df = sf.rfftn(DY, axes=axes)

    if cfg.masked:
        # mask decoupling (prlcnscdl.py:821-1218): two blocks, rho = 1
        YU0f = sf.rfftn(ZY0 - ZU0 + S, axes=axes)
        YU1f = sf.rfftn(ZY - ZU, axes=axes)
        if Cd == 1:
            b = Df.conj() * YU0f + YU1f
            Zxf = sl.solvedbi_sm(Df, 1.0, b, axis=2)
        else:
            b = torch.sum(Df.conj() * YU0f, dim=1, keepdim=True) + YU1f
            Zxf = sl.solvemdbi_ism(Df, 1.0, b, axisM=2, axisK=1)
        Zx = sf.irfftn(Zxf, s=Nv, axes=axes)
        DZx = sf.irfftn(torch.sum(Df * Zxf, dim=2, keepdim=True), s=Nv,
                        axes=axes)
        AX0 = ax * DZx - (1 - ax) * (-ZY0 - S)
        AX1 = ax * Zx + (1 - ax) * ZY
        ZY0n = rho_x * (AX0 + ZU0 - S) / (W ** 2 + rho_x)
        ZYn = sp.prox_l1(AX1 + ZU, p["thr"])
        ZU0 = ZU0 + AX0 - ZY0n - S
        ZU = ZU + AX1 - ZYn
        ZY0, ZY = ZY0n, ZYn
    elif cfg.kernel_x:
        # the spatial x-step's glue, then csc_iter over the packed state
        # without its forward pair: the next iteration's forward product
        # is against the next dictionary
        n0, n1 = Nv
        PS = fc.PS
        p0, p1 = n0 // PS, n1 // PS
        pos, C = K * p0 * p1, PS * PS * M
        Wf, Wa, (jf0, jf1, ja0, ja1), gram = _spectral_glue(cfg, Df, DY,
                                                            Sf)
        o = (ZY - ZU).reshape(K, p0, p1, C) @ Wf
        if Cd > 1:
            R = fc._fwd_combine_mc(o, jf0, jf1, Cd, PS)
            rf = sf.rfftn(R, axes=(-2, -1))
            Gf = fc._herm_solve(gram, rho_x,
                                Sf.reshape(K, Cd, n0, -1) - rf)
            G2 = fc._adj_rolls_mc(sf.irfftn(Gf, s=Nv, axes=(-2, -1)),
                                  ja0, ja1)
        else:
            R = fc.poly_unpack(fc._fwd_combine(o, jf0, jf1, PS))
            rf = sf.rfftn(R, axes=(-2, -1))
            Sf2 = Sf.reshape(K, n0, -1)
            den = 1.0 / (gram[None] + rho_x)
            gr = (Sf2.real - rf.real) * den
            gi = (Sf2.imag - rf.imag) * den
            G = sf.irfftn(torch.complex(gr, gi), s=Nv, axes=(-2, -1))
            G2 = fc._adj_rolls(fc.poly_pack(G), ja0, ja1)
        csc_iter(G2.reshape(pos, -1), ZY.view(pos, C), ZU.view(pos, C), Wa,
                 None, p["thr"], 1.0, ax, 1.0, 1.0, emit_px=False,
                 emit_fwd=False)
    elif cfg.fused_x:
        n0, n1 = Nv
        Wf, Wa, js, gram = _spectral_glue(cfg, Df, DY, Sf)
        Pyu = fc.pack_state((ZY - ZU).reshape(K, 1, M, n0, n1))
        if Cd > 1:
            Zxp = fc.spatial_xstep_mc(Pyu, Wf, Wa, js, gram,
                                      Sf.reshape(K, Cd, n0, -1), rho_x,
                                      1.0, Nv, Cd)[0]
        else:
            Sf2 = Sf.reshape(K, n0, -1)
            Zxp = fc.spatial_xstep(Pyu, Wf, Wa, js, gram,
                                   Sf2.real.contiguous(),
                                   Sf2.imag.contiguous(), rho_x, 1.0,
                                   Nv)[0]
        Zx = fc.unpack_state(Zxp, M).reshape(ZY.shape)
        AX = ax * Zx + (1 - ax) * ZY
        ZYn = sp.prox_l1(AX + ZU, p["thr"])
        ZU = ZU + AX - ZYn
        ZY = ZYn
    else:
        # --- cbpdn x/relax/y/u steps (prlcnscdl.py:152-196) ---
        DSf = Df.conj() * Sf
        if Cd > 1:
            DSf = torch.sum(DSf, dim=1, keepdim=True)
        b = DSf + rho_x * sf.rfftn(ZY - ZU, axes=axes)
        if Cd == 1:
            Zxf = sl.solvedbi_sm(Df, rho_x, b, axis=2)
        else:
            Zxf = sl.solvemdbi_ism(Df, rho_x, b, axisM=2, axisK=1)
        Zx = sf.irfftn(Zxf, s=Nv, axes=axes)
        AX = ax * Zx + (1 - ax) * ZY
        ZYn = sp.prox_l1(AX + ZU, p["thr"])
        ZU = ZU + AX - ZYn
        ZY = ZYn

    # --- ccmod setcoef (prlcnscdl.py:199-209) ---
    Z_int = fc.unpack_state(ZY, M) if cfg.kernel_x else ZY
    Zf = sf.rfftn(Z_int, axes=axes)
    if cfg.masked:
        # the dictionary step fits y0 + s, the mask-consistent signal
        ZSf = Zf.conj() * sf.rfftn(ZY0 + S, axes=axes)
    else:
        ZSf = Zf.conj() * Sf
    # --- ccmod x-step and relaxation per signal, in the DFT domain
    # (prlcnscdl.py:212-232) ---
    DXf = sl.solvedbi_sm(Zf, rho_d, ZSf + rho_d * (Df - DUf), axis=2)
    DAXf = ad * DXf + (1 - ad) * Df
    # --- consensus mean and projection (prlcnscdl.py:235-243): the mean
    # commutes with the DFT, so only the averaged dictionary goes back
    # to space.  A single-channel dictionary with multi-channel signals
    # has one block per signal and channel (ccmod.py:270-280) ---
    blk = (0, 1) if (Cd == 1 and cri.C > 1) else (0,)
    if p["group"] is None:
        Dsum = torch.mean(DAXf + DUf, dim=blk, keepdim=True)
    else:
        # sharded: the blocks of every "data" rank
        nblk = cfg.ndata * int(np.prod([DAXf.shape[a] for a in blk]))
        Dsum = all_reduce_sum(torch.sum(DAXf + DUf, dim=blk, keepdim=True),
                              p["group"]) / nblk
    Dmean = sf.irfftn(Dsum, s=Nv, axes=axes)
    DYn = cr.Pcn(Dmean, cfg.dsz, Nv, dimN=cri.dimN, zm=cfg.zero_mean)
    DUf = DUf + DAXf - sf.rfftn(DYn, axes=axes)
    return ZY, ZU, ZY0, ZU0, DYn, DUf


def _objective(D, Z, S, lmbda, wl1, dimN, group=None):
    """The functional over all signals (``prlcnscdl.py:623-652``):
    ``(obj, dfd, reg)`` as 0-d tensors; the two sums all-reduced over
    ``group`` where the signals are sharded."""
    axes = tuple(range(-dimN, 0))
    Nv = tuple(S.shape[-dimN:])
    Df = sf.rfftn(D, s=Nv, axes=axes)
    Ef = torch.sum(Df * sf.rfftn(Z, axes=axes), dim=2, keepdim=True) \
        - sf.rfftn(S, axes=axes)
    dfd = 0.5 * sf.rfl2norm2(Ef, Nv, axis=axes)
    reg = torch.sum(torch.abs(wl1 * Z))
    if group is not None:
        dfd, reg = all_reduce_sum(torch.stack([dfd, reg.to(dfd.dtype)]),
                                  group)
    return dfd + lmbda * reg, dfd, reg


class ConvBPDNDictLearn_Consensus:
    r"""Consensus convolutional dictionary learning
    (``sporco/dictlrn/prlcnscdl.py:275``), on one device or sharded.

    ``D0`` has user shape ``dsz + [Cd] + (M,)`` and ``S``
    ``Nv + [C] + [K]``, both numpy arrays.  ``solve()`` runs ``max_iter``
    outer iterations; ``step(n)`` runs ``n`` more.  ``device=None`` means
    the CUDA device and raises without one; ``device="cpu"`` runs on the
    CPU with the kernels' plain versions.  The CSC stage is chosen by
    configuration (see the module docstring): ``fused=False`` forces the
    DFT-domain stage, ``fused=True`` lets a colour dictionary take the
    spatial x-step, which ``"auto"`` keeps for single-channel ones.

    With a ``mesh`` the rank runs on its mesh device and holds the
    ``"data"`` block of K of ``S`` (given whole: each rank takes its
    block), ``W`` and a K-shaped ``wl1``.  With ``process_local_batch``
    and more than one rank, ``S`` (and ``W`` where it has a K axis) is
    this rank's own chunk, the global K is the chunk's times the
    ``"data"`` size, and ``S`` needs an explicit K axis.  ``rho_d``
    defaults to the global K.  ``getdict()`` is the same on every rank;
    ``getcoef()``, :meth:`state_numpy` and :meth:`load_state_numpy` are
    the rank's block; ``evaluate()`` is over all signals.  The kernel
    stage is chosen by the same rule on the rank's block.
    """

    MASKED = False

    def __init__(self, D0, S, lmbda, W=None, opt=None, max_iter=100,
                 dimK=None, dimN=2, zero_mean=False, rho_x=None,
                 rho_d=None, relax=1.8, wl1=1.0, mesh=None,
                 dtype=torch.float32, fused="auto",
                 process_local_batch=False, device=None):
        self.timer = Timer(["init", "solve"])
        self.timer.start("init")
        self.mesh = mesh
        self.device = (mesh_device(mesh) if mesh is not None
                       else resolve_device(device))
        P = axis_size(mesh, "data")
        dtype = sf.torch_dtype(dtype)
        npdt = sf.numpy_dtype(dtype)
        D0 = np.asarray(D0).astype(npdt)
        S = np.asarray(S).astype(npdt)
        dsz = D0.shape
        local = (process_local_batch and torch.distributed.is_initialized()
                 and torch.distributed.get_world_size() > 1)
        if local:
            # each rank passes its own chunk of the signals
            # (prlcnscdl.py:69-130): the global K is the chunks' sum
            if mesh is None:
                raise ValueError("process_local_batch requires a global "
                                 "mesh")
            cri_loc = cr.cdu_index(tuple(dsz), S.shape, dimK=dimK,
                                   dimN=dimN)
            if cri_loc.dimK == 0:
                raise ValueError("process-local batching requires an "
                                 "explicit K axis in S")
            cri = dataclasses.replace(cri_loc, K=cri_loc.K * P)
        else:
            cri = cr.cdu_index(tuple(dsz), S.shape, dimK=dimK, dimN=dimN)
            if cri.K % P != 0:
                raise ValueError(f"K ({cri.K}) does not divide over {P} "
                                 "data ranks")
            cri_loc = dataclasses.replace(cri, K=cri.K // P)
        self.cri = cri
        self.max_iter = max_iter
        self.dtype = dtype
        dev = self.device
        csc_like = cri.csc_like(dsz[:dimN])

        def block(t):
            # this rank's K block of an internal array given whole
            if mesh is None or local or t.shape[0] != cri.K or P == 1:
                return t.contiguous().to(dev)
            return shard_batch(mesh, t, 0)
        Si = block(cr.to_internal_S(torch.as_tensor(S),
                                    cri_loc if local else cri))
        D0i = cr.Pcn(cr.to_internal_D(torch.as_tensor(D0), csc_like),
                     tuple(dsz), cri.Nv, dimN=dimN, zm=zero_mean).to(dev)
        # the route, by configuration alone: a colour dictionary takes
        # the spatial x-step only when asked (fused=True)
        fx = (fc.consensus_eligible(cri_loc, dsz, dtype, self.MASKED)
              and (fused is True or (fused is not False and cri.Cd == 1)))
        PS = fc.PS
        kx = False
        if fx and np.ndim(wl1) == 0:
            pos = cri_loc.K * (cri.Nv[0] // PS) * (cri.Nv[1] // PS)
            T = ((-(-(dsz[0] - 1) // PS) + 1) * (-(-(dsz[1] - 1) // PS) + 1)
                 * cri.Cd * PS * PS)
            kx = iter_supported(pos, PS * PS * cri.M, T)
        self.cfg = _CnsConfig(cri=cri_loc, dsz=tuple(dsz),
                              zero_mean=zero_mean, masked=self.MASKED,
                              relax_x=relax, relax_d=relax, fused_x=fx,
                              kernel_x=kx, ndata=P)
        ft = np.float64 if dtype == torch.float64 else np.float32
        if np.ndim(wl1) > 0:
            wl1a = block(cr.l1_weight(torch.as_tensor(np.asarray(wl1, ft)),
                                      csc_like))
        else:
            wl1a = float(ft(wl1))
        if self.MASKED:
            rho_x = 1.0 if rho_x is None else rho_x
        elif rho_x is None:
            rho_x = 50.0 * lmbda + 1.0
        rho_d = float(cri.K) if rho_d is None else rho_d
        lm, rx = ft(lmbda), ft(rho_x)
        lr = ft(lm / rx)
        self.params = {
            "S": Si, "Sf": sf.rfftn(Si, axes=_fftaxes(cri)),
            "lmbda": float(lm), "wl1": wl1a, "rho_x": float(rx),
            "rho_d": float(ft(rho_d)),
            # the shrinkage threshold (lmbda / rho_x) wl1
            "thr": (float(ft(lr * ft(wl1a))) if not torch.is_tensor(wl1a)
                    else float(lr) * wl1a),
            "group": None if mesh is None else mesh.get_group("data"),
        }
        if self.MASKED:
            Wm = (torch.ones((1,) * (3 + dimN), dtype=dtype) if W is None
                  else cr.fidelity_mask(torch.as_tensor(
                      np.asarray(W).astype(npdt)),
                      cri_loc if local else cri))
            self.params["W"] = block(Wm)

        K, M = cri_loc.K, cri.M
        if kx:
            shpX = (K, cri.Nv[0] // PS, cri.Nv[1] // PS, PS * PS * M)
        else:
            shpX = (K, cri.Cx, M) + tuple(cri.Nv)
        shpS = (K, cri.C, 1) + tuple(cri.Nv)
        # dictionary consensus blocks: per signal, and per channel for a
        # single-channel dictionary with multi-channel signals
        Cb = cri.C if cri.Cd == 1 else cri.Cd
        shpDf = (K, Cb, M) + tuple(cri.Nv[:-1]) + (cri.Nv[-1] // 2 + 1,)

        def z(shp, dt=dtype):
            return torch.zeros(shp, dtype=dt, device=dev)
        self.state = (z(shpX), z(shpX), z(shpS), z(shpS), D0i,
                      z(shpDf, sf.complex_dtype(dtype)))
        self.j = 0
        self.timer.stop("init")

    def step(self, n=1):
        """Run ``n`` outer iterations; no read of the device."""
        with fp32_precision(), torch.no_grad():
            st = self.state
            for _ in range(n):
                st = _body(self.cfg, self.params, st)
            self.state = st
        self.j += n
        return self

    def solve(self):
        self.timer.start("solve")
        self.step(self.max_iter)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timer.stop("solve")
        return self.getdict()

    def getdict(self, crop=True):
        """The dictionary in the user layout ``dsz + [Cd] + (M,)``."""
        D = self.state[4]
        if crop:
            D = cr.bcrop(D, self.cfg.dsz, self.cri.dimN)
        return cr.from_internal_D(D, self.cri)

    def _coef_internal(self):
        Z = self.state[0]
        if self.cfg.kernel_x:
            Z = fc.unpack_state(Z, self.cri.M)
        return Z

    def getcoef(self):
        """The coefficient maps in the reference layout
        ``Nv + (Cx, K, M)``: this rank's K block where sharded."""
        return cr.from_internal_X(self._coef_internal(),
                                  self.cfg.cri.csc_like(self.cfg.dsz))

    def evaluate(self):
        """``(objective, data fidelity, l1 term)`` over all signals (an
        all-reduce where sharded), as floats."""
        p = self.params
        with fp32_precision(), torch.no_grad():
            out = _objective(self.state[4], self._coef_internal(), p["S"],
                             p["lmbda"], p["wl1"], self.cri.dimN,
                             p["group"])
        return tuple(float(v) for v in out)

    def load_state_numpy(self, state):
        """Set the state from the JAX object's ``state`` tuple ``(ZY, ZU,
        ZY0, ZU0, DY, DUfr, DUfi)`` as numpy arrays: the dual planar, and
        ZY/ZU packed (K, p0, p1, 64 M) where that object's kernel stage
        carried them so, else in the internal layout; either converts to
        this object's layout."""
        ZY, ZU, ZY0, ZU0, DY, DUfr, DUfi = (np.asarray(a) for a in state)

        def t(a):
            return torch.tensor(a, dtype=self.dtype, device=self.device)

        def coef(a):
            a = t(a)
            packed = a.ndim == 4
            if self.cfg.kernel_x and not packed:
                return fc.pack_state(a)
            if packed and not self.cfg.kernel_x:
                return fc.unpack_state(a, self.cri.M).reshape(
                    (self.cfg.cri.K, self.cri.Cx, self.cri.M)
                    + tuple(self.cri.Nv)).contiguous()
            return a.contiguous()
        self.state = (coef(ZY), coef(ZU), t(ZY0), t(ZU0), t(DY),
                      torch.complex(t(DUfr), t(DUfi)))

    def state_numpy(self, packed=None):
        """The state as the JAX object's ``state`` tuple of numpy arrays
        (the dual planar); ZY/ZU packed if ``packed`` (default: as this
        object carries them)."""
        ZY, ZU, ZY0, ZU0, DY, DUf = self.state
        if packed is None:
            packed = self.cfg.kernel_x
        if self.cfg.kernel_x and not packed:
            ZY, ZU = (fc.unpack_state(a, self.cri.M) for a in (ZY, ZU))
        elif packed and not self.cfg.kernel_x:
            ZY, ZU = (fc.pack_state(a) for a in (ZY, ZU))
        return tuple(a.detach().cpu().numpy() for a in
                     (ZY, ZU, ZY0, ZU0, DY, DUf.real, DUf.imag))


class ConvBPDNMaskDcplDictLearn_Consensus(ConvBPDNDictLearn_Consensus):
    r"""Masked consensus CDL (``sporco/dictlrn/prlcnscdl.py:821``): the
    CSC stage decouples the mask ``W`` (two blocks), in the same loop."""
    MASKED = True
