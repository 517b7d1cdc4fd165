"""The port's ``ConvBPDNInhib`` on the CPU against the JAX package's on
the same seeded numpy problems: lateral inhibition within groups of
filters (``examples/csc_inhibition.py``'s pairs), self inhibition, both,
a colour dictionary, NonNegCoef; the extra carry of the inhibition
weights through checkpoints in either direction; and the FFT kernels'
route.

Tolerances (those of ``tests/test_torch_maskdcpl.py``): float64, every
row to rtol 1e-6, X, Y, U and the weights within 1e-8 of their scale;
float32 over 10 iterations, the objective rows and Rho to rtol 1e-4, the
residuals to rtol 1e-3, the arrays within 2e-4; a whole float32 run, the
last objective to rtol 1e-3.  The solves run a fixed number of
iterations, as ``examples/csc_inhibition.py`` does: with the weights
moving every iteration neither package reaches a relative residual of
1e-3 on these problems (:func:`test_residuals_stall_as_jax`).
"""

import jax
import numpy as np
import pytest
import torch

from sporco_tpu.models import cbpdnin as jm
from sporco_tpu.ops import fft as jsf
from sporco_tpu.ops import pallas_fft
from sporco_tpu_torch.models import cbpdnin as tm
from sporco_tpu_torch.ops import fft as tsf
from sporco_tpu_torch.ops import fft2_planar as tfp

torch.set_num_threads(2)

N, ND, M = 32, 4, 8
LMBDA = 0.05
RSDL = ("PrimalRsdl", "DualRsdl")


def _problem(n=N, Cd=1, seed=0):
    """``examples/csc_inhibition.py``'s problem at n x n: S = D * X0 with
    X0 of 20 nonzeros uniform on [1, 2]; the filters grouped in pairs."""
    rng = np.random.default_rng(seed)
    dsz = (ND, ND) + ((Cd,) if Cd > 1 else ()) + (M,)
    D = rng.standard_normal(dsz)
    D /= np.sqrt((D ** 2).sum(axis=tuple(range(D.ndim - 1)),
                              keepdims=True))
    X0 = np.zeros((n, n, M))
    X0.ravel()[rng.choice(X0.size, 20, replace=False)] = rng.uniform(
        1.0, 2.0, 20)
    Df = np.fft.rfft2(D, s=(n, n), axes=(0, 1))
    Xf = np.fft.rfft2(X0, axes=(0, 1))
    if Cd > 1:
        S = np.fft.irfft2((Xf[:, :, None] * Df).sum(-1), s=(n, n),
                          axes=(0, 1))
    else:
        S = np.fft.irfft2((Xf * Df).sum(-1), s=(n, n), axes=(0, 1))
    S += 0.01 * rng.standard_normal(S.shape)
    Wg = np.zeros((M // 2, M))
    for g in range(M // 2):
        Wg[g, 2 * g:2 * g + 2] = 1.0
    return D.astype(np.float32), S.astype(np.float32), Wg.astype(np.float32)


CASES = {
    "lateral": {"mu": 0.5},
    "self": {"mu": 0.0, "gamma": 0.1},
    "both": {"mu": 0.5, "gamma": 0.1},
    "non_neg": {"mu": 0.5, "non_neg": True},
    "colour": {"mu": 0.5, "dimK": 0},
}


def _make(pkg, case, dtype, max_iter, tol, n=N, **extra):
    D, S, Wg = _problem(n=n, Cd=3 if case == "colour" else 1)
    cls = jm.ConvBPDNInhib if pkg == "jax" else tm.ConvBPDNInhib
    kw = {**CASES[case], **extra}
    if pkg == "port":
        kw["device"] = "cpu"
    return cls(D, S, Wg=Wg, Whn=4, lmbda=LMBDA, dtype=dtype,
               opt=cls.options(max_iter=max_iter, rel_stop_tol=tol), **kw)


def _pair(case, dtype, max_iter, tol, **kw):
    a = _make("jax", case, dtype, max_iter, tol, **kw)
    a.solve()
    b = _make("port", case, dtype, max_iter, tol, **kw)
    b.solve()
    return a, b


def _assert_rows(ja, ta, rtol, rsdl_rtol):
    assert ta._names == ja._names
    for name in ja._names:
        np.testing.assert_allclose(
            getattr(ta, name), getattr(ja, name), err_msg=name, atol=1e-30,
            rtol=rsdl_rtol if name in RSDL else rtol)


def _assert_states(a, b, rel):
    pairs = [(name, np.asarray(getattr(a.state, name)),
              getattr(b.state, name).numpy()) for name in ("X", "Y", "U")]
    pairs += [(f"extra{i}", np.asarray(x), y.numpy())
              for i, (x, y) in enumerate(zip(a.state.extra, b.state.extra))]
    for name, ja, ta in pairs:
        assert ta.shape == ja.shape and ta.dtype == ja.dtype, name
        assert np.abs(ta - ja).max() <= rel * max(np.abs(ja).max(), 1e-30), \
            name


FIXED = 60      # iterations of a whole run


@pytest.mark.parametrize("case", list(CASES))
def test_float64_solve_matches_jax(case):
    a, b = _pair(case, "float64", FIXED, 0.0)
    assert len(a.getitstat()) == len(b.getitstat()) == FIXED
    _assert_rows(a.getitstat(), b.getitstat(), 1e-6, 1e-6)
    _assert_states(a, b, 1e-8)
    assert b.cfg.use_lat == a.cfg.use_lat
    assert b.cfg.use_self == a.cfg.use_self


@pytest.mark.parametrize("case", ["lateral", "both", "colour"])
def test_float32_iterations_match_jax(case):
    a, b = _pair(case, "float32", 10, 0.0)
    assert len(a.getitstat()) == len(b.getitstat()) == 10
    _assert_rows(a.getitstat(), b.getitstat(), 1e-4, 1e-3)
    _assert_states(a, b, 2e-4)


@pytest.mark.parametrize("case", ["lateral", "both"])
def test_float32_solve_matches_jax(case):
    a, b = _pair(case, "float32", FIXED, 0.0)
    ja, ta = a.getitstat(), b.getitstat()
    assert len(ja) == len(ta) == FIXED
    np.testing.assert_allclose(ta.ObjFun[-1], ja.ObjFun[-1], rtol=1e-3)


def test_residuals_stall_as_jax():
    """With lateral inhibition at mu = 0.5 neither package reaches a
    relative residual of 1e-3 in 300 iterations on this 32x32 problem
    (the residuals stay near 0.2): the port follows the JAX package row
    for row over the first 100."""
    a, b = _pair("lateral", "float64", 300, 1e-3)
    ja, ta = a.getitstat(), b.getitstat()
    assert len(ja) == len(ta) == 300
    assert ta.PrimalRsdl[-1] > 0.05
    for name in ja._names:
        np.testing.assert_allclose(getattr(ta, name)[:100],
                                   getattr(ja, name)[:100], rtol=1e-6,
                                   atol=1e-30, err_msg=name)


def test_rows_read_the_weights_after_update():
    """``RegLat`` of each row is ``sum(wml |X|)`` with the weights that
    ``update_extra`` made from that iteration's X (the JAX order), not
    those the y-step used: after one iteration from zero weights it is
    not 0."""
    b = _make("port", "lateral", "float64", 1, 0.0)
    b.solve()
    wml = b.state.extra[0]
    want = float(torch.sum(wml * torch.abs(b.state.X)))
    assert want > 0
    assert b.getitstat().RegLat[0] == pytest.approx(want, rel=1e-6)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_extra_carry_survives_checkpoint(direction, tmp_path):
    """A state file with the inhibition weights written by one package
    resumes in the other: 8 iterations, save, 8 more on each side from
    the file, the rows and the weights alike (float64)."""
    first = _make("jax" if direction == "jax_to_port" else "port", "both",
                  "float64", 8, 0.0)
    first.solve()
    path = str(tmp_path / "state.npz")
    first.save_state(path)
    a = _make("jax", "both", "float64", 8, 0.0)
    a.load_state_file(path)
    a.solve()
    b = _make("port", "both", "float64", 8, 0.0)
    b.load_state_file(path)
    assert all(isinstance(e, torch.Tensor) for e in b.state.extra)
    assert float(torch.abs(b.state.extra[0]).max()) > 0
    b.solve()
    assert int(a.state.k) == int(b.state.k) == 16
    _assert_rows(a.getitstat(), b.getitstat(), 1e-6, 1e-6)
    _assert_states(a, b, 1e-8)
    # and the port's own snapshot round trip keeps the carry bit for bit
    d = b.state_dict()
    assert all(isinstance(e, np.ndarray) for e in d["extra"])
    c = _make("port", "both", "float64", 8, 0.0)
    c.load_state(d)
    assert all(torch.equal(x, y) for x, y in zip(c.state.extra,
                                                  b.state.extra))


def test_window_and_defaults_match_jax():
    """The window's spectra (complex here, a real/imaginary pair in the
    JAX package), the default mu (10 lmbda), Whn (the filters' size),
    lmbda and rho, and the reference option keys."""
    D, S, Wg = _problem()
    a = jm.ConvBPDNInhib(D, S, Wg=Wg, dtype=np.float64)
    b = tm.ConvBPDNInhib(D, S, Wg=Wg, dtype="float64", device="cpu")
    assert b.lmbda == pytest.approx(a.lmbda, rel=1e-12)
    assert b.params["mu"] == pytest.approx(float(a.params["mu"]), rel=1e-12)
    assert float(b.state.rho) == pytest.approx(float(a.state.rho))
    for key in ("Whfl", "Whfs"):
        w = np.asarray(a.params[key])
        np.testing.assert_array_equal(b.params[key].numpy(), w[0] + 1j * w[1])
    opt = {"MaxMainIter": 5, "SmoothWeight": 0.5, "NonNegCoef": True}
    b = tm.ConvBPDNInhib(D, S, Wg=Wg, opt=opt, device="cpu")
    assert b.cfg.smooth == 0.5 and b.cfg.non_neg and b.opts.max_iter == 5
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.ConvBPDNInhib(D, S, Wg=Wg)


def test_planar_route_matches_jax_and_counts(monkeypatch):
    """At 128x128 every transform takes the FFT kernels' route: 5 float32
    iterations with lateral and self inhibition agree, and the planar
    calls are those ``chip_smoke.py`` holds the card to: 2 forward in the
    set-up (D and S), then an iteration 2 forward (Y - U, |X|) and 3
    inverse (X, the lateral and the self activity)."""
    counts = {"rfft2_planar": 0, "irfft2_planar": 0}
    for label, attr in (("rfft2_planar", "rfft2_planar_plain"),
                        ("irfft2_planar", "irfft2_planar_plain")):
        fn = getattr(tfp, attr)

        def counted(*a, _fn=fn, _label=label, **k):
            counts[_label] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(tfp, attr, counted)
    prev = pallas_fft.interpret
    pallas_fft.interpret = True
    jsf.use_mxu_fft("always")
    tsf.use_planar_fft("always")
    jax.clear_caches()
    k = 5
    try:
        a = _make("jax", "both", "float32", k, 0.0, n=128)
        a.solve()
        b = _make("port", "both", "float32", k, 0.0, n=128)
        counts.update(rfft2_planar=0, irfft2_planar=0)
        b.solve()
    finally:
        jsf.use_mxu_fft("auto")
        tsf.use_planar_fft("auto")
        pallas_fft.interpret = prev
        jax.clear_caches()
    _assert_rows(a.getitstat(), b.getitstat(), 1e-4, 1e-3)
    _assert_states(a, b, 2e-4)
    assert counts == {"rfft2_planar": 2 * k + 2, "irfft2_planar": 3 * k}
