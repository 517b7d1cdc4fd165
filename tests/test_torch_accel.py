"""The accelerator API ``sporco_tpu_torch.accel`` (the counterpart of the
reference's ``sporco.cuda`` and of ``sporco_tpu.accel``): each of the
four solvers equals its model class on the same problem (bit for bit,
the same code path), takes reference-style option dicts, and, for the
masked two, agrees with the JAX package's ``accel`` on the fused and the
generic path at the tolerances of ``tests/test_torch_fused_variants.py``
(coefficients within 2e-4 of their scale); the device helpers report
``torch.cuda`` and never stand in the CPU for a missing card.  The cases
that need a card are in ``tests/test_torch_cuda.py``, which imports no
JAX."""

import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from sporco_tpu import accel as jaccel
from sporco_tpu_torch import accel
from sporco_tpu_torch.models import cbpdn as tm
from sporco_tpu_torch.ops import csc_tail as tct
from sporco_tpu_torch.ops import fused_csc as tfc

torch.set_num_threads(2)

LMBDA, MU = 0.05, 0.05
OPT = {"MaxMainIter": 12, "RelStopTol": 0.0}


def _problem(N=32, M=4, Nd=8, seed=0):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((Nd, Nd, M)).astype(np.float32)
    D /= np.sqrt((D ** 2).sum(axis=(0, 1), keepdims=True))
    S = gaussian_filter(rng.standard_normal((N, N)), 4.0) * 5.0
    S += 0.1 * rng.standard_normal((N, N))
    W = (rng.random((N, N)) > 0.25).astype(np.float32)
    return D, S.astype(np.float32), W


def _solver_and_model(name, D, S, W):
    """The accel call and the model it stands for, as functions of
    ``(opt, **kw)``."""
    if name == "cbpdn":
        return (lambda opt, **kw: accel.cbpdn(D, S, LMBDA, opt=opt, **kw),
                lambda opt, **kw: tm.ConvBPDN(D, S, LMBDA, opt=opt, **kw))
    if name == "cbpdngrd":
        return (lambda opt, **kw: accel.cbpdngrd(D, S, LMBDA, MU, opt=opt,
                                                 **kw),
                lambda opt, **kw: tm.ConvBPDNGradReg(D, S, LMBDA, mu=MU,
                                                     opt=opt, **kw))
    if name == "cbpdnmsk":
        return (lambda opt, **kw: accel.cbpdnmsk(D, S, W, LMBDA, opt=opt,
                                                 **kw),
                lambda opt, **kw: tm.AddMaskSim(tm.ConvBPDN, D, S, W, LMBDA,
                                                opt=opt, **kw))
    return (lambda opt, **kw: accel.cbpdngrdmsk(D, S, W, LMBDA, MU, opt=opt,
                                                **kw),
            lambda opt, **kw: tm.AddMaskSim(tm.ConvBPDNGradReg, D, S, W,
                                            LMBDA, mu=MU, opt=opt, **kw))


SOLVERS = ["cbpdn", "cbpdngrd", "cbpdnmsk", "cbpdngrdmsk"]


@pytest.mark.parametrize("name", SOLVERS)
def test_solver_equals_model_class(name):
    D, S, W = _problem()
    solve, model = _solver_and_model(name, D, S, W)
    got = solve(dict(OPT), device="cpu")
    m = model(dict(OPT), device="cpu")
    want = m.solve()
    assert torch.equal(got, want)
    assert got.shape == (32, 32, 1, 1, 4)
    inner = m.cbpdn if hasattr(m, "cbpdn") else m
    assert inner._fused_solve is tfc.cbpdn_solve
    # an ADMMOpts works as well as the dict
    opts = tm.ConvBPDN.options(max_iter=12, rel_stop_tol=0.0)
    assert torch.equal(solve(opts, device="cpu"), want)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("name", ["cbpdnmsk", "cbpdngrdmsk"])
def test_masked_solvers_match_jax_accel(name, fused):
    D, S, W = _problem(seed=1)
    calls = {"ams": 0}
    tail = tct.admm_tail

    def counted(*a, **k):
        calls["ams"] += k.get("ams") is not None
        return tail(*a, **k)
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(tct, "admm_tail", counted)
        if name == "cbpdnmsk":
            got = accel.cbpdnmsk(D, S, W, LMBDA, opt=dict(OPT), fused=fused,
                                 device="cpu").numpy()
            want = np.asarray(jaccel.cbpdnmsk(D, S, W, LMBDA, opt=dict(OPT),
                                              fused=fused))
        else:
            got = accel.cbpdngrdmsk(D, S, W, LMBDA, MU, opt=dict(OPT),
                                    fused=fused, device="cpu").numpy()
            want = np.asarray(jaccel.cbpdngrdmsk(D, S, W, LMBDA, MU,
                                                 opt=dict(OPT), fused=fused))
    finally:
        mp.undo()
    assert calls["ams"] == (OPT["MaxMainIter"] if fused else 0)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 2e-4 * np.abs(want).max()


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)


def test_device_helpers_without_card(no_card):
    assert accel.device_count() == 0
    assert accel.memory_info() == (-1, -1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        accel.device_name()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        accel.current_device()


@pytest.mark.parametrize("name", SOLVERS)
def test_solvers_need_a_card_unless_asked_for_the_cpu(no_card, name):
    D, S, W = _problem()
    solve, _ = _solver_and_model(name, D, S, W)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve(dict(OPT))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve(dict(OPT), dev=1)
    assert solve(dict(OPT), device="cpu").device.type == "cpu"
