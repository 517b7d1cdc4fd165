"""Filter-parallel CSC: ParConvBPDN (counterpart of
``sporco_tpu.models.parcbpdn``; skau-2018-fast).

The M dictionary filters are split into L groups with the ADMM
constraint ``(D_G0; ...; D_G(L-1); alpha I) x = (y0_0; ...; y0_(L-1);
alpha y1)`` (``sporco/admm/parcbpdn.py:353``).  Every step is
independent per group except the coupled ``y0`` solve, a sum over the
groups with a cached inverse off-diagonal element
(``parcbpdn.py:182-205``).  The group axis is a leading tensor axis, so
each per-group step is one batched op.  The iteration runs on the device
loop (:mod:`sporco_tpu_torch.ops.device_loop`), as the JAX package's
``lax.while_loop`` does: the residuals, tolerances, stopping test and
stats row are 0-d tensors computed on the device in the model's type, in
the host forms' order, and the host reads the stopping flag once a block
of 8 iterations and the final state once (``ceil(k / 8) + 1`` reads a
solve).  On the card one iteration is a CUDA graph, kept with the loop
for the next solve of the same key.

With ``mesh=`` (:func:`sporco_tpu_torch.parallel.mesh.make_mesh`), each
rank holds L/F groups, F the mesh's ``"filter"`` size, and three sums of
an iteration become ``all_reduce`` over the ``"filter"`` group: the
``y0`` coupling (``:146`` of the JAX module), then the reconstruction
``DXsum`` (``:180``) together with the residual norms and the l1 term,
in one collective.  On NCCL both are captured in the iteration's graph;
a mesh of CPU ranks (gloo) runs the same blocks eagerly.

Residuals and stopping follow the reference (``parcbpdn.py:318-352,
783-819``): unnormalised ``r = sqrt(sum_g ||DX_g - Y0_g||^2 + alpha^2
||X - Y1||^2)``, ``s = sqrt(||Y0prev - Y0||^2 + alpha^2 ||Y1prev -
Y1||^2)`` against ``epri/edua`` from AbsStopTol/RelStopTol; no AutoRho.
The fidelity mask ``W`` is supported (``parcbpdn.py:365-385``).  Its
2-D float32 transforms go through :mod:`sporco_tpu_torch.ops.fft`, so on
the card they run ``rfft2_planar`` (two an iteration, one for D a solve)
and ``irfft2_planar`` (two an iteration).
"""

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from sporco_tpu_torch import cnvrep as cr
from sporco_tpu_torch import refopts
from sporco_tpu_torch._device import fp32_precision, resolve_device
from sporco_tpu_torch.models.cbpdn import (_max_abs_dhs, host_array,
                                           reconstruct)
from sporco_tpu_torch.models.common import ADMMModel
from sporco_tpu_torch.ops import device_loop
from sporco_tpu_torch.ops import fft as sf
from sporco_tpu_torch.ops import fft2_planar
from sporco_tpu_torch.ops import linalg as sl
from sporco_tpu_torch.ops import prox as sp
from sporco_tpu_torch.parallel.mesh import (all_reduce_sum, axis_rank,
                                            axis_size, mesh_device)
from sporco_tpu_torch.solvers.admm import (ADMMOpts, AutoRhoOpts,
                                           IterStats, _loop_key, as_row,
                                           guarded_update, scalar_type,
                                           sqrt_t, write_row)

__all__ = ["ParConvBPDN"]

_STAT_NAMES = ("Iter", "ObjFun", "DFid", "RegL1", "PrimalRsdl",
               "DualRsdl", "EPrimal", "EDual", "Rho")


@dataclass(frozen=True)
class ParCfg:
    cri: cr.CSCIndex
    ngrp: int
    non_neg: bool = False
    no_bndry: bool = False
    max_iter: int = 100
    rel_stop_tol: float = 1e-3
    abs_stop_tol: float = 0.0
    fast_solve: bool = False


def _iteration(cfg, p, st, aux):
    """One iteration (``parcbpdn.py:132-265``) on this rank's groups;
    returns the new arrays and a tensor of the iteration's sums (the
    eleven of the residuals, norms and l1 term, then the data term),
    reduced over the groups."""
    cri = cfg.cri
    axes = tuple(range(-cri.dimN, 0))
    Nv = cri.Nv
    Y0, U0, Y1, U1 = st[:4]
    group = p["group"]
    alpha, a2, rho = p["alpha"], p["alpha2"], p["rho"]
    Dfg, DHDg = aux
    # x-step per group (parcbpdn.py:132-161): the AL rho cancels,
    # leaving (D_g^H D_g + alpha^2 I)
    YU0f = sf.rfftn(Y0 - U0, axes=axes)
    YU1f = sf.rfftn(Y1 - U1 / alpha, axes=axes)
    b = Dfg.conj() * YU0f + a2 * YU1f
    Xf = sl.solvedbi_sm(Dfg, a2, b, axis=3, aah=DHDg)
    Xnr = sf.irfftn(Xf, s=Nv, axes=axes)                 # (L, K, 1, Mg, Nv)
    DXnr = sf.irfftn(torch.sum(Dfg * Xf, dim=3, keepdim=True), s=Nv,
                     axes=axes)                          # (L, K, C, 1, Nv)
    # relaxation (parcbpdn.py:164-179)
    rlx = p["rlx"]
    Xr = rlx * Xnr + (1 - rlx) * Y1
    DXr = rlx * DXnr + (1 - rlx) * Y0
    # the one serial merge: the coupled y0 solve (parcbpdn.py:182-205),
    # a sum over the groups
    csum = torch.sum(p["SW"] + rho * (DXr + U0), dim=0, keepdim=True)
    if group is not None:
        csum = all_reduce_sum(csum, group)
    Y0n = p["SW"] / rho + DXr + U0 + p["inv_off_diag"] * csum
    # y1 and u steps per group (parcbpdn.py:208-265)
    Y1n = sp.prox_l1(Xr + U1 / alpha, p["gamma"])
    if cfg.non_neg:
        Y1n = torch.clamp(Y1n, min=0.0)
    if cfg.no_bndry:
        Y1n = Y1n.clone()
        for n in range(cri.dimN):
            end = cri.dsz[n] - 1
            if end > 0:
                Y1n.narrow(n - cri.dimN, Nv[n] - end, end).zero_()
    U0n = U0 + DXr - Y0n
    U1n = U1 + alpha * (Xr - Y1n)

    def ss(v):
        return torch.sum(v * v)
    sums = [ss(DXnr - Y0n), ss(Xnr - Y1n), ss(Y0 - Y0n), ss(Y1 - Y1n),
            ss(DXnr), ss(Xnr), ss(Y0n), ss(Y1n), ss(U0n), ss(U1n),
            torch.sum(torch.abs(p["wl1"] * Y1n))]
    DXsum = torch.sum(DXnr, dim=0)
    if group is not None:
        red = all_reduce_sum(torch.cat([torch.stack(sums),
                                        DXsum.reshape(-1)]), group)
        sums, DXsum = red[:len(sums)], red[len(sums):].reshape(DXsum.shape)
    else:
        sums = torch.stack(sums)
    dfd = 0.5 * torch.sum((p["W"] * (DXsum - p["S"])) ** 2)
    return (Y0n, U0n, Y1n, U1n, Xnr, DXnr), torch.cat([sums,
                                                        dfd.reshape(1)])


def _par_loop(cfg, ft, T, p_spec, n_p, n_s):
    """The iteration over the static tensors ``T`` (the parameters and
    set-up result ``p*``, the arrays ``s*``, the scalars ``sc = [k, k0,
    r, s, epri, edua]``, the stats rows), as a
    :class:`~sporco_tpu_torch.ops.device_loop.Loop`: the residuals and
    tolerances of ``parcbpdn.py:783-819`` as the host forms took them, in
    the model's type, correctly rounded roots."""
    cri = cfg.cri
    p, aux = device_loop.unflatten(p_spec, [T[f"p{i}"] for i in range(n_p)])
    olds = [T[f"s{i}"] for i in range(n_s)]
    sc, stats, fcnt, enable = T["sc"], T["stats"], T["fcnt"], T["enable"]
    k, k0, r, s, epri, edua = sc
    rdt = sc.dtype
    dev = sc.device
    L = cfg.ngrp
    # constraint and dual space sizes for the AbsStopTol terms,
    # sqrt(Nc) and sqrt(Nx) of parcbpdn.py:790-795 (taken in float32
    # as the JAX package takes them)
    nY0 = L * cri.K * cri.C * int(np.prod(cri.Nv))
    nY1 = L * cri.K * (cri.M // L) * int(np.prod(cri.Nv))
    rtN = ft(np.sqrt(np.float32(nY0 + nY1)))
    atol = float(rtN * ft(cfg.abs_stop_tol))
    rtol = float(ft(cfg.rel_stop_tol))
    a2, rho, lm = (float(ft(v)) for v in (p["alpha2"], p["rho"],
                                           p["lmbda"]))
    T["live"] = live = torch.zeros((), dtype=torch.bool, device=dev)
    inf = torch.full((), np.inf, dtype=rdt, device=dev)
    zero = torch.zeros((), dtype=rdt, device=dev)
    nan = torch.full((), np.nan, dtype=rdt, device=dev)

    def converged():
        return ((r <= epri) & (s <= edua)) | (k - k0 >= cfg.max_iter)

    def step():
        device_loop.stage("stopping test")
        torch.logical_and(enable, ~converged(), out=live)
        with fft2_planar.gate(live.to(torch.float32), fcnt):
            device_loop.stage("iteration")
            news, h = _iteration(cfg, p, tuple(olds[:4]), aux)
        device_loop.stage("scalar tail")
        if cfg.fast_solve:
            r_, s_, epri_, edua_ = inf, inf, zero, zero
            obj = dfd = rl1 = nan
        else:
            r_ = sqrt_t(h[0] + h[1] * a2)
            s_ = sqrt_t(h[2] + h[3] * a2)
            nrmAx = sqrt_t(h[4] + h[5] * a2)
            nrmBy = sqrt_t(h[6] + h[7] * a2)
            nrmu = sqrt_t(h[8] + h[9])
            epri_ = torch.maximum(nrmAx, nrmBy) * rtol + atol
            edua_ = nrmu * rtol + atol
            dfd, rl1 = h[11], h[10]
            obj = dfd + rl1 * lm
        write_row(stats, k, k0, live, as_row(
            (k, obj, dfd, rl1, r_, s_, epri_, edua_, rho), rdt, dev))
        torch.where(live, torch.stack([k + 1.0, k0, r_, s_, epri_, edua_]),
                    sc, out=sc)
        device_loop.stage("state")
        guarded_update(live, olds, list(news))
        return live

    def status():
        return torch.stack([converged().to(rdt), k - k0])

    return device_loop.Loop(
        T, step, status,
        lambda: torch.cat([sc, fcnt.to(rdt), stats.reshape(-1).to(rdt)]),
        lambda i, n: stats[i:i + n], lambda row: None)


class ParConvBPDN(ADMMModel):
    r"""Filter-parallel CSC solver, with an optional fidelity mask
    (``sporco/admm/parcbpdn.py:353``).

    ``ngrp`` is the number of filter groups L (it must divide M and is
    reduced to the nearest divisor otherwise; default min(16, M)).
    ``device=None`` means the CUDA device and raises without one.  With
    ``mesh=`` the rank runs on its mesh device and holds L/F of the
    groups (F the mesh's ``"filter"`` size, which must divide L);
    ``getcoef()``, ``reconstruct()``, ``state_dict()`` and
    ``save_state()`` gather the groups and are the same on every rank.
    The state is the JAX model's tuple ``(Y0, U0, Y1, U1, X, DX, k, r, s,
    epri, edua, stats)``: the arrays tensors (this rank's groups), the
    scalars host values.
    """

    # reference ParConvBPDN option keys (sporco/admm/parcbpdn.py:418-427)
    REF_OPT_EXTRA = {
        **refopts._ADMM_EQUAL,
        "AuxVarObj": refopts.IGNORE,
        "HighMemSolve": refopts.IGNORE,
        "LinSolveCheck": refopts.WARN,
        "NonNegCoef": ("k", "non_neg"),
        "NoBndryCross": ("k", "no_bndry"),
        "L1Weight": ("k", "wl1"),
        "alpha": ("k", "alpha"),
        "Y1": refopts.WARN,
        "U1": refopts.WARN,
    }

    @staticmethod
    def options(**kw):
        return ADMMOpts(**{**dict(relax_param=1.8,
                                  auto_rho=AutoRhoOpts(enabled=False)),
                           **kw})

    def __init__(self, D, S, lmbda=None, W=None, opt=None, ngrp=None,
                 alpha=None, dimK=None, dimN=2, wl1=1.0, non_neg=False,
                 no_bndry=False, dtype=torch.float32, mesh=None,
                 device=None):
        super().__init__()
        if opt is None:
            opt = self.options()
        self.mesh = mesh
        self.device = (mesh_device(mesh) if mesh is not None
                       else resolve_device(device))
        dev = self.device
        dtype = sf.torch_dtype(dtype)
        npdt = sf.numpy_dtype(dtype)
        ft = scalar_type(dtype)
        D = host_array(D).astype(npdt)
        S = host_array(S).astype(npdt)
        cri = cr.csc_index(D.shape, S.shape, dimK=dimK, dimN=dimN)
        if cri.Cd > 1:
            raise NotImplementedError("multi-channel dictionaries not "
                                      "supported by ParConvBPDN")
        self.cri = cri
        Di = cr.to_internal_D(torch.as_tensor(D), cri).contiguous().to(dev)
        Si = cr.to_internal_S(torch.as_tensor(S), cri).contiguous().to(dev)
        if lmbda is None:
            with fp32_precision():
                lmbda = 0.1 * _max_abs_dhs(Di, Si, cri.Nv)
        self.lmbda = lmbda
        if ngrp is None:
            ngrp = min(16, cri.M)
        while cri.M % ngrp != 0:
            ngrp -= 1
        self.ngrp = L = ngrp
        Mg = cri.M // ngrp
        F = axis_size(mesh, "filter")
        if L % F != 0:
            raise ValueError(f"{L} filter groups do not divide over {F} "
                             "filter ranks")
        self._lo = axis_rank(mesh, "filter") * (L // F)
        self._Lloc = L // F
        self.cfg = ParCfg(cri=cri, ngrp=ngrp, non_neg=non_neg,
                          no_bndry=no_bndry, max_iter=opt.max_iter,
                          rel_stop_tol=opt.rel_stop_tol,
                          abs_stop_tol=opt.abs_stop_tol,
                          fast_solve=opt.fast_solve)
        self.opts = opt.replace(dtype=dtype)
        self._Di = Di
        # group the filter axis: (1, 1, M, dsz) -> (L, 1, 1, Mg, dsz)
        Dgrp = Di.reshape((1, 1, ngrp, Mg) + tuple(Di.shape[3:])) \
            .movedim(2, 0)
        if W is None:
            Wm = torch.ones((1,) * (3 + dimN), dtype=dtype)
        else:
            Wm = cr.fidelity_mask(torch.as_tensor(
                host_array(W).astype(npdt)), cri)
        Wm = Wm.contiguous().to(dev)
        rho = ft(opt.rho if opt.rho is not None else 50.0 * lmbda + 1.0)
        al = ft(1.0 if alpha is None else alpha)
        a2 = al ** 2
        lm = ft(lmbda)
        wl1a = (torch.as_tensor(np.asarray(wl1, npdt)).to(dev)
                if np.ndim(wl1) > 0 else float(ft(wl1)))
        # (lmbda / (alpha^2 rho)) wl1, the y1 threshold
        gfac = lm / (a2 * rho)
        W2 = Wm ** 2
        self.params = {
            "D": Dgrp[self._lo:self._lo + self._Lloc].contiguous(),
            "S": Si, "W": Wm, "SW": W2 * Si,
            "inv_off_diag": -W2 / (float(rho) * (float(rho) + W2 * L)),
            "lmbda": lm, "rho": float(rho), "alpha": float(al),
            "alpha2": float(a2), "rlx": float(ft(opt.relax_param)),
            "wl1": wl1a,
            "gamma": (float(gfac * ft(wl1a)) if not torch.is_tensor(wl1a)
                      else float(gfac) * wl1a),
            "group": None if mesh is None else mesh.get_group("filter"),
        }
        Ll = self._Lloc
        shp0 = (Ll, cri.K, cri.C, 1) + tuple(cri.Nv)
        shp1 = (Ll, cri.K, 1, Mg) + tuple(cri.Nv)

        def z(shp):
            return torch.zeros(shp, dtype=dtype, device=dev)
        self.k_start = 0
        self.state = (z(shp0), z(shp0), z(shp1), z(shp1), z(shp1), z(shp0),
                      np.int32(0), ft(np.inf), ft(np.inf), ft(0.0),
                      ft(0.0), self._fresh_stats())
        self._init_done()

    def _fresh_stats(self):
        return np.full((self.cfg.max_iter, len(_STAT_NAMES)), np.nan,
                       np.float32)

    def _solve_state(self):
        cfg, p = self.cfg, self.params
        cri = cfg.cri
        ft = scalar_type(self.opts.dtype)
        rdt = sf.real_dtype(self.opts.dtype)
        dev = self.device
        Y0, U0, Y1, U1, X, DX, k, r, s, epri, edua, _ = self.state
        k0 = int(k)
        with fp32_precision(), torch.no_grad():
            Dfg = sf.rfftn(p["D"], s=cri.Nv, axes=tuple(range(-cri.dimN,
                                                              0)))
            aux = (Dfg, torch.sum((Dfg * Dfg.conj()).real, dim=3,
                                  keepdim=True))
            p_leaves, p_spec, p_key = device_loop.flatten((p, aux))
            s_leaves, s_spec, s_key = device_loop.flatten(
                (Y0, U0, Y1, U1, X, DX), shared=False)
            key = _loop_key("parcbpdn", None, cfg, self.opts,
                            (p_key, s_key))
            kind = ("parcbpdn", str(dev))
            fresh = {f"p{i}": v for i, v in enumerate(p_leaves)}
            fresh.update({f"s{i}": v for i, v in enumerate(s_leaves)})
            fresh["sc"] = torch.tensor([k0, k0, r, s, epri, edua],
                                       dtype=rdt, device=dev)
            fresh["stats"] = torch.tensor(self._fresh_stats(), device=dev)
            fresh["fcnt"] = torch.zeros(2, dtype=torch.int32, device=dev)
            fresh["enable"] = torch.ones((), dtype=torch.bool, device=dev)
            loop = device_loop.kept(kind, key)
            if loop is None:
                T = {n: v.clone() for n, v in fresh.items()}
                loop = device_loop.keep(kind, key, _par_loop(
                    cfg, ft, T, p_spec, len(p_leaves), len(s_leaves)))
            else:
                loop.refill(fresh)
            host = device_loop.run(loop, cfg.max_iter,
                                   bool(r <= epri and s <= edua), dev)
            T = loop.t
            if dev.type == "cuda":
                # the FFT kernels' live launches in the loop
                fft2_planar.LAUNCHES["rfft2_planar"] += int(host[6])
                fft2_planar.LAUNCHES["irfft2_planar"] += int(host[7])
            k, _, r, s, epri, edua = (ft(v) for v in host[:6])
            # new tensors: the loop's are refilled by its next call
            arrays = tuple(T[f"s{i}"].clone() for i in range(len(s_leaves)))
        return arrays + (np.int32(k), r, s, epri, edua,
                         host[8:].reshape(cfg.max_iter, len(_STAT_NAMES))
                         .astype(np.float32))

    def solve(self):
        """Run (or resume) the solve; returns the coefficient maps in the
        reference layout.  Re-entrant: the state carries the iteration
        counter, and each call has its own stats rows."""
        self.timer.start("solve")
        self.k_start = int(self.state[6])
        self.state = self._solve_state()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.timer.stop("solve")
        return self.getmin()

    def getmin(self):
        return self.getcoef()

    def _gather(self, t):
        """All L groups of a tensor of this rank's groups (axis 0)."""
        group = self.params["group"]
        if group is None:
            return t
        parts = [torch.empty_like(t) for _ in range(axis_size(self.mesh,
                                                              "filter"))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim=0)

    def _coef_internal(self):
        # (L, K, 1, Mg, Nv) -> internal (K, 1, M, Nv)
        Y1 = self._gather(self.state[2])
        return Y1.movedim(0, 2).reshape((Y1.shape[1], 1, self.cri.M)
                                        + tuple(self.cri.Nv))

    def getcoef(self):
        """The coefficient maps ``Nv + (1, K, M)`` (all groups)."""
        return cr.from_internal_X(self._coef_internal(), self.cri)

    def getitstat(self):
        """Per-iteration statistics of the most recent ``solve`` call
        (``sporco/admm/parcbpdn.py:798-802``)."""
        return IterStats(_STAT_NAMES, self.state[11],
                         int(self.state[6]) - self.k_start)

    def reconstruct(self, X=None):
        """``sum_m d_m * x_m`` in the user S layout ``Nv + [C] + [K]``."""
        return reconstruct(self._Di, self._coef_internal(), self.cri, X)

    def state_dict(self):
        """The state as the JAX model's tuple of numpy arrays (all
        groups)."""
        return tuple(self._gather(v).detach().cpu().numpy()
                     if isinstance(v, torch.Tensor) else np.array(v)
                     for v in self.state)

    def load_state_dict_numpy(self, state):
        """Set the state from the JAX model's ``state`` tuple (or
        :meth:`state_dict`) as numpy arrays, all L groups: the port then
        resumes that solve.  A sharded model keeps its own groups."""
        state = tuple(np.asarray(v) for v in state)
        ft = scalar_type(self.opts.dtype)
        arrs = tuple(
            torch.tensor(a[self._lo:self._lo + self._Lloc],
                         dtype=self.opts.dtype, device=self.device)
            for a in state[:6])
        self.state = arrs + (np.int32(state[6]),) + tuple(
            ft(v) for v in state[7:11]) + (
            np.array(state[11], np.float32, copy=True),)

    def load_state(self, d):
        self.load_state_dict_numpy(d)

    def save_state(self, path):
        """Checkpoint the state (all groups) to an ``.npz`` file in the
        JAX package's layout: its 12 leaves in order, which the JAX
        model's ``load_state_file`` reads, and so does this one."""
        leaves = self.state_dict()
        np.savez(path, __n__=len(leaves),
                 **{f"leaf{i}": v for i, v in enumerate(leaves)})

    def load_state_file(self, path):
        """Restore a checkpoint written by ``save_state`` of either
        package."""
        with np.load(path) as npz:
            n = int(npz["__n__"])
            if n != 12:
                raise ValueError(f"{path} holds {n} leaves; ParConvBPDN's "
                                 "state has 12")
            self.load_state_dict_numpy([npz[f"leaf{i}"] for i in range(n)])
