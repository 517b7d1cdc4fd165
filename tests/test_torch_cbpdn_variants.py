"""The port's ``ConvBPDNJoint``, ``ConvBPDNProjL1`` and
``MultiDictConvBPDN`` on the CPU against the JAX package's on the same
seeded numpy problems, and the route each takes.

Tolerances (those of ``tests/test_torch_maskdcpl.py``):

- float64, solved to 1e-3: the same iteration count, every stats row to
  rtol 1e-6 and X and Y within 1e-8 of their scale;
- float32, 10 iterations: the objective rows and Rho to rtol 1e-4, the
  residuals and ``Cnstr`` (a residual of the ball constraint) to rtol
  1e-3, X and Y within 2e-4 of their scale;
- float32, solved to 1e-3: the iteration count within one and the last
  objective to rtol 1e-3.

``MultiDictConvBPDN`` over two single-channel dictionaries is a colour
dictionary with C = Cd = 2, which both packages send to their fused
driver in float32 (the JAX Pallas ``csc_iter`` in interpret mode, the
port's plain version) and to the generic path in float64.
"""

import contextlib

import jax
import numpy as np
import pytest
import torch

from sporco_tpu import refopts as jrefopts
from sporco_tpu.models import cbpdn as jc
from sporco_tpu.ops import fft as jsf
from sporco_tpu.ops import fused_csc as jfc
from sporco_tpu.ops import pallas_csc_iter as pki
from sporco_tpu.ops import pallas_fft
from sporco_tpu_torch.models import cbpdn as tc
from sporco_tpu_torch.ops import csc_iter as tci
from sporco_tpu_torch.ops import fft as tsf
from sporco_tpu_torch.ops import fft2_planar as tfp
from sporco_tpu_torch.ops import fused_csc as tfc

torch.set_num_threads(2)

N, ND, M = 32, 4, 6
LMBDA, MU = 0.1, 0.05
RSDL = ("PrimalRsdl", "DualRsdl", "Cnstr")


def _dict(seed=0, Cd=1, m=M, nd=ND):
    rng = np.random.default_rng(seed)
    D = rng.standard_normal((nd, nd) + ((Cd,) if Cd > 1 else ()) + (m,))
    D /= np.sqrt((D ** 2).sum(axis=tuple(range(D.ndim - 1)),
                              keepdims=True))
    return D.astype(np.float32)


def _signal(shape, seed=1):
    """A smooth ramp down the rows plus noise at 0.1, of ``shape``."""
    rng = np.random.default_rng(seed)
    return (0.1 * rng.standard_normal(shape)
            + np.cos(np.linspace(0, 3, shape[0]))[:, None].repeat(
                shape[1], 1).reshape(shape[:2] + (1,) * (len(shape) - 2))
            ).astype(np.float32)


def _sparse_problem(D, n=N, seed=2, frac=0.5):
    """S = D * X0 with X0 of 20 nonzeros uniform on [1, 2] (the problem of
    ``examples/csc_constrained.py``) and ``gamma = frac ||X0||_1`` (the
    example's 0.9 makes both packages' AutoRho cycle at this size, see
    :func:`test_projl1_tight_budget_cycles_as_jax`)."""
    rng = np.random.default_rng(seed)
    X0 = np.zeros((n, n, D.shape[-1]))
    X0.ravel()[rng.choice(X0.size, 20, replace=False)] = rng.uniform(
        1.0, 2.0, 20)
    Df = np.fft.rfft2(D, s=(n, n), axes=(0, 1))
    S = np.fft.irfft2((np.fft.rfft2(X0, axes=(0, 1)) * Df).sum(-1),
                      s=(n, n), axes=(0, 1))
    return S.astype(np.float32), frac * np.abs(X0).sum()


def _case(name):
    """(JAX class, port class, D, S, arguments): the joint model on a
    three-channel signal with a single-channel dictionary (maps per
    channel) and on two signals; the constrained model on the sparse
    problem and on two signals."""
    D = _dict()
    if name == "joint_colour":
        return (jc.ConvBPDNJoint, tc.ConvBPDNJoint, D,
                _signal((N, N, 3)), {"lmbda": LMBDA, "mu": MU, "dimK": 0})
    if name == "joint_signals":
        return (jc.ConvBPDNJoint, tc.ConvBPDNJoint, D,
                _signal((N, N, 2)), {"lmbda": LMBDA, "mu": MU})
    if name == "projl1":
        S, gamma = _sparse_problem(D)
        return (jc.ConvBPDNProjL1, tc.ConvBPDNProjL1, D, S,
                {"gamma": gamma})
    if name == "projl1_signals":
        S0, g0 = _sparse_problem(D, seed=2)
        S1, _ = _sparse_problem(D, seed=3)
        return (jc.ConvBPDNProjL1, tc.ConvBPDNProjL1, D,
                np.stack([S0, S1], axis=-1), {"gamma": g0})
    raise ValueError(name)


CASES = ("joint_colour", "joint_signals", "projl1", "projl1_signals")


def _pair(name, dtype, max_iter, tol, **extra):
    jcls, tcls, D, S, kw = _case(name)
    kw = {**kw, **extra}
    a = jcls(D, S, opt=jcls.options(max_iter=max_iter, rel_stop_tol=tol),
             dtype=dtype, **kw)
    a.solve()
    b = tcls(D, S, opt=tcls.options(max_iter=max_iter, rel_stop_tol=tol),
             dtype=dtype, device="cpu", **kw)
    b.solve()
    return a, b


def _assert_rows(a, b, rtol, rsdl_rtol, n=None):
    ja, ta = a.getitstat(), b.getitstat()
    assert ta._names == ja._names
    for name in ja._names:
        np.testing.assert_allclose(
            getattr(ta, name)[:n], getattr(ja, name)[:n], err_msg=name,
            rtol=rsdl_rtol if name in RSDL else rtol, atol=1e-30)


def _assert_states(a, b, rel):
    for name in ("X", "Y", "U"):
        ja = np.asarray(getattr(a.state, name))
        ta = getattr(b.state, name).numpy()
        assert ta.shape == ja.shape and ta.dtype == ja.dtype, name
        assert np.abs(ta - ja).max() <= rel * max(np.abs(ja).max(), 1e-30), \
            name


@pytest.mark.parametrize("name", CASES)
def test_float64_solve_matches_jax(name):
    a, b = _pair(name, "float64", 300, 1e-3)
    assert len(a.getitstat()) == len(b.getitstat()) < 300
    _assert_rows(a, b, 1e-6, 1e-6)
    _assert_states(a, b, 1e-8)
    np.testing.assert_allclose(b.getmin().numpy(), np.asarray(a.getmin()),
                               rtol=0, atol=1e-8 * np.abs(
                                   np.asarray(a.getmin())).max())
    np.testing.assert_allclose(b.reconstruct().numpy(),
                               np.asarray(a.reconstruct()), rtol=0,
                               atol=1e-8 * np.abs(np.asarray(
                                   a.reconstruct())).max())


@pytest.mark.parametrize("name", CASES)
def test_float32_iterations_match_jax(name):
    a, b = _pair(name, "float32", 10, 0.0)
    assert len(a.getitstat()) == len(b.getitstat()) == 10
    _assert_rows(a, b, 1e-4, 1e-3)
    _assert_states(a, b, 2e-4)


@pytest.mark.parametrize("name", CASES)
def test_float32_solve_matches_jax(name):
    a, b = _pair(name, "float32", 300, 1e-3)
    ja, ta = a.getitstat(), b.getitstat()
    assert abs(len(ja) - len(ta)) <= 1 and len(ta) < 300
    np.testing.assert_allclose(getattr(ta, ta._names[1])[-1],
                               getattr(ja, ja._names[1])[-1], rtol=1e-3)


def test_projl1_meets_its_constraint():
    """The constrained solve keeps each signal's coefficients in the l1
    ball (the primal's distance to it, ``Cnstr``, falls below 1e-3 of
    gamma)."""
    _, _, D, S, kw = _case("projl1")
    b = tc.ConvBPDNProjL1(D, S, device="cpu", dtype="float64",
                          opt=tc.ConvBPDNProjL1.options(
                              max_iter=500, rel_stop_tol=1e-4), **kw)
    X = b.solve().numpy()
    assert len(b.getitstat()) < 500
    assert np.abs(X).sum() <= kw["gamma"] * (1 + 1e-6)
    assert b.getitstat().Cnstr[-1] <= 1e-3 * kw["gamma"]


def test_projl1_tight_budget_cycles_as_jax():
    """At the example's budget, 0.9 ||X0||_1, on this noise-free 32x32
    problem the default AutoRho (Period 1, AutoScaling) does not settle:
    neither package reaches 1e-3 in 300 iterations, and X stays about
    0.3 from the ball; the port follows the JAX package row for row.
    The returned Y is in the ball all the same."""
    jcls, tcls, D, _, _ = _case("projl1")
    S, gamma = _sparse_problem(D, frac=0.9)
    opt = dict(max_iter=300, rel_stop_tol=1e-3)
    a = jcls(D, S, gamma, opt=jcls.options(**opt), dtype="float64")
    a.solve()
    b = tcls(D, S, gamma, opt=tcls.options(**opt), dtype="float64",
             device="cpu")
    Y = b.solve().numpy()
    assert len(a.getitstat()) == len(b.getitstat()) == 300
    assert b.getitstat().Cnstr[-1] > 0.1
    assert np.abs(Y).sum() <= gamma * (1 + 1e-6)
    _assert_rows(a, b, 1e-6, 1e-6, n=50)


def test_options_and_ref_keys_match_jax():
    """The default options (ConvBPDNProjL1: rho 1, RsdlTarget 1), the
    stat names, the L21Weight key and an array L21Weight."""
    for name in ("ConvBPDNJoint", "ConvBPDNProjL1"):
        ja, ta = getattr(jc, name).options(), getattr(tc, name).options()
        assert ta.auto_rho == type(ta.auto_rho)(**vars(ja.auto_rho))
        assert (ta.relax_param, ta.rho) == (ja.relax_param, ja.rho)
    D, S = _dict(), _signal((N, N, 3))
    b = tc.ConvBPDNProjL1(D, S[..., 0], 2.0, device="cpu")
    a = jc.ConvBPDNProjL1(D, S[..., 0], 2.0)
    assert float(b.state.rho) == float(a.state.rho) == 1.0
    assert float(b.state.rho_xi) == float(a.state.rho_xi) == 1.0
    assert b.STAT_NAMES == ("DFid", "Cnstr", "XSlvRelRes")
    opt = {"MaxMainIter": 12, "L21Weight": 0.5, "RelStopTol": 0.0}
    a = jc.ConvBPDNJoint(D, S, LMBDA, MU, dimK=0, opt=opt,
                         dtype=np.float64)
    b = tc.ConvBPDNJoint(D, S, LMBDA, MU, dimK=0, opt=opt,
                         dtype="float64", device="cpu")
    assert float(b.params["wl21"]) == 0.5 and b.opts.max_iter == 12
    a.solve()
    b.solve()
    _assert_rows(a, b, 1e-6, 1e-6)
    w = np.random.default_rng(4).uniform(0.5, 1.5, (1, 1, M, 1, 1))
    a = jc.ConvBPDNJoint(D, S, LMBDA, MU, dimK=0, wl21=w, dtype=np.float64,
                         opt=jc.ConvBPDNJoint.options(max_iter=12))
    b = tc.ConvBPDNJoint(D, S, LMBDA, MU, dimK=0, wl21=w, dtype="float64",
                         device="cpu",
                         opt=tc.ConvBPDNJoint.options(max_iter=12))
    a.solve()
    b.solve()
    _assert_rows(a, b, 1e-6, 1e-6)
    with pytest.raises(jrefopts.UnknownKeyError):
        jc.ConvBPDNProjL1(D, S[..., 0], 2.0, opt={"Bogus": 1})


# ---------------------------------------------------------------------------
# MultiDictConvBPDN and the routes

def _multidict(n=N, nd=ND, m=M):
    D0, D1 = _dict(5, m=m, nd=nd), _dict(6, m=m, nd=nd)
    rng = np.random.default_rng(7)
    S0 = rng.standard_normal((n, n)).astype(np.float32)
    S1 = (0.5 * S0 + 0.5 * rng.standard_normal((n, n))).astype(np.float32)
    return [D0, D1], [S0, S1]


@contextlib.contextmanager
def _jax_kernel():
    """The JAX fused driver through its Pallas ``csc_iter`` in
    interpret mode."""
    prev = (pki.enabled, pki.interpret)
    pki.enabled, pki.interpret = True, True
    jax.clear_caches()
    try:
        yield
    finally:
        pki.enabled, pki.interpret = prev
        jax.clear_caches()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_multidict_matches_jax(dtype):
    """Two dictionaries, two signals, shared maps: in float32 both
    packages run the fused driver on the stacked colour dictionary (20
    iterations), in float64 the generic path (solved to 1e-3)."""
    D, S = _multidict(nd=8)
    iters, tol = (20, 0.0) if dtype == "float32" else (300, 1e-3)
    with _jax_kernel():
        a = jc.MultiDictConvBPDN(jc.ConvBPDN, D, S, LMBDA, dtype=dtype,
                                 opt=jc.ConvBPDN.options(
                                     max_iter=iters, rel_stop_tol=tol))
        ja = np.asarray(a.solve())
    b = tc.MultiDictConvBPDN(tc.ConvBPDN, D, S, LMBDA, dtype=dtype,
                             device="cpu", opt=tc.ConvBPDN.options(
                                 max_iter=iters, rel_stop_tol=tol))
    assert b.cbpdn.cri.C == b.cbpdn.cri.Cd == 2 and b.C == 2
    tb = b.solve().numpy()
    if dtype == "float32":
        assert b.cbpdn._fused_solve is tfc.cbpdn_solve
        _assert_rows(a.cbpdn, b.cbpdn, 1e-4, 1e-3)
        assert np.abs(tb - ja).max() <= 2e-4 * np.abs(ja).max()
    else:
        assert b.cbpdn._fused_solve is None
        assert len(a.getitstat()) == len(b.getitstat()) < 300
        _assert_rows(a.cbpdn, b.cbpdn, 1e-6, 1e-6)
        assert np.abs(tb - ja).max() <= 1e-8 * np.abs(ja).max()
        for k in (None, 0, 1):
            ra, rb = np.asarray(a.reconstruct(k)), b.reconstruct(k).numpy()
            assert rb.shape == ra.shape
            assert np.abs(rb - ra).max() <= 1e-8 * np.abs(ra).max()


def _route_cases():
    """(label, constructor, arguments): every variant of this slice, and
    MultiDict in the configurations that move its route."""
    D, S = _dict(), _signal((N, N, 3))
    Dm, Sm = _multidict(nd=8)
    Dm12, Sm12 = _multidict(nd=12)
    return [
        ("joint", "ConvBPDNJoint", (D, S, LMBDA, MU), {"dimK": 0}),
        ("joint_single", "ConvBPDNJoint", (D, S[..., 0], LMBDA, MU), {}),
        ("projl1", "ConvBPDNProjL1", (D, S[..., 0], 2.0), {}),
        ("multidict", "MultiDict", (Dm, Sm, LMBDA), {}),
        ("multidict_f64", "MultiDict", (Dm, Sm, LMBDA),
         {"dtype": "float64"}),
        ("multidict_large_support", "MultiDict", (Dm12, Sm12, LMBDA), {}),
        ("multidict_fused_false", "MultiDict", (Dm, Sm, LMBDA),
         {"fused": False}),
    ]


def _build(pkg, cls, args, kw):
    mod = jc if pkg == "jax" else tc
    kw = dict(kw)
    if pkg == "port":
        kw["device"] = "cpu"
    if cls == "MultiDict":
        return mod.MultiDictConvBPDN(mod.ConvBPDN, *args, **kw).cbpdn
    return getattr(mod, cls)(*args, **kw)


@pytest.mark.parametrize("label", [c[0] for c in _route_cases()])
def test_route_matches_jax_eligibility(label):
    """The port's route (fused, folded or generic) is the one the JAX
    package's ``eligible``/``cfold_eligible`` choose."""
    _, cls, args, kw = next(c for c in _route_cases() if c[0] == label)
    a = _build("jax", cls, args, kw)
    b = _build("port", cls, args, kw)
    fused = kw.get("fused", "auto") is not False
    want = None
    if fused and jfc.eligible(a.cfg, a.params, a.opts):
        want = tfc.cbpdn_solve
    elif fused and jfc.cfold_eligible(a.cfg, a.params, a.opts):
        want = tfc.cbpdn_solve_cfold
    assert b._fused_solve is want
    if label == "multidict":
        assert want is tfc.cbpdn_solve
    if label in ("joint", "projl1"):
        assert want is None


@pytest.mark.parametrize("name", ["joint", "projl1"])
def test_fused_true_raises_as_jax(name):
    _, cls, args, kw = next(c for c in _route_cases() if c[0] == name)
    with pytest.raises(ValueError, match="fused=True"):
        _build("port", cls, args, {**kw, "fused": True})
    a = _build("jax", cls, args, {**kw, "fused": True})
    with pytest.raises(ValueError, match="fused=True"):
        a.solve()


# ---------------------------------------------------------------------------
# the FFT kernels' route

@pytest.fixture
def planar(monkeypatch):
    """Both packages on their FFT kernels at 128x128 (the port's plain
    versions, counted; the JAX Pallas kernels in interpret mode)."""
    counts = {"rfft2_planar": 0, "irfft2_planar": 0, "csc_iter": 0}
    for label, mod, attr in (("rfft2_planar", tfp, "rfft2_planar_plain"),
                             ("irfft2_planar", tfp, "irfft2_planar_plain"),
                             ("csc_iter", tci, "csc_iter_plain")):
        fn = getattr(mod, attr)

        def counted(*a, _fn=fn, _label=label, **k):
            counts[_label] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, attr, counted)
    prev = (pallas_fft.interpret, pki.enabled, pki.interpret)
    pallas_fft.interpret = True
    pki.enabled, pki.interpret = True, True
    jsf.use_mxu_fft("always")
    tsf.use_planar_fft("always")
    jax.clear_caches()
    try:
        yield counts
    finally:
        jsf.use_mxu_fft("auto")
        tsf.use_planar_fft("auto")
        pallas_fft.interpret, pki.enabled, pki.interpret = prev
        jax.clear_caches()


@pytest.mark.parametrize("name", ["ConvBPDNJoint", "ConvBPDNProjL1"])
def test_planar_route_matches_jax_and_counts(name, planar):
    """At 128x128 every transform takes the FFT kernels' route: 5 float32
    iterations agree, and the planar calls are those ``chip_smoke.py``
    holds the card to: 2 forward in the set-up (D and S), then 1 forward
    and 1 inverse an iteration."""
    D = _dict()
    if name == "ConvBPDNJoint":
        S, kw = _signal((128, 128, 3)), {"lmbda": LMBDA, "mu": MU,
                                         "dimK": 0}
    else:
        S, gamma = _sparse_problem(D, n=128)
        kw = {"gamma": gamma}
    k = 5
    a = getattr(jc, name)(D, S, opt=getattr(jc, name).options(
        max_iter=k, rel_stop_tol=0.0), **kw)
    a.solve()
    b = getattr(tc, name)(D, S, opt=getattr(tc, name).options(
        max_iter=k, rel_stop_tol=0.0), device="cpu", **kw)
    planar.update(rfft2_planar=0, irfft2_planar=0)
    b.solve()
    _assert_rows(a, b, 1e-4, 1e-3)
    _assert_states(a, b, 2e-4)
    assert planar == {"rfft2_planar": k + 2, "irfft2_planar": k,
                      "csc_iter": 0}


def test_multidict_fused_route_counts(planar):
    """MultiDict at 128x128 on the fused driver: one ``csc_iter`` an
    iteration, and the FFT kernels of the colour solve's glue
    (``chip_smoke.py``'s ``clr_solve`` counts: k + 3 forward, k + 1
    inverse); 5 iterations agree with the JAX fused driver."""
    D, S = _multidict(n=128, nd=8)
    k = 5
    a = jc.MultiDictConvBPDN(jc.ConvBPDN, D, S, LMBDA,
                             opt=jc.ConvBPDN.options(max_iter=k,
                                                     rel_stop_tol=0.0))
    a.solve()
    b = tc.MultiDictConvBPDN(tc.ConvBPDN, D, S, LMBDA, device="cpu",
                             opt=tc.ConvBPDN.options(max_iter=k,
                                                     rel_stop_tol=0.0))
    planar.update(rfft2_planar=0, irfft2_planar=0, csc_iter=0)
    b.solve()
    _assert_rows(a.cbpdn, b.cbpdn, 1e-4, 1e-3)
    assert planar == {"rfft2_planar": k + 3, "irfft2_planar": k + 1,
                      "csc_iter": k}
