"""The split-product arithmetic of the port's tensor-core forward pair
(``csrc/csc_tiles.cuh`` ``fwd_pair``), emulated with plain ``torch`` on
the CPU: each operand split into three bf16 terms rounded to nearest,
the six products of order <= 2 summed smallest first into a chain that
starts from zero at every 16-deep k step and rounds each add toward zero
(the tensor core's accumulation truncates), each chain promoted into an
fp32 sum by a round-to-nearest add.  Held against float64 numpy (and a
chain never promoted shown to fail the same bound), and against the JAX
package's f32-faithful ``_dot3(..., passes=6)`` with its weights from
``split_bf16_3``; and the port's ``split_weight`` bit for bit against
``split_bf16_3``."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from sporco_tpu.ops import pallas_csc_iter as pki
from sporco_tpu_torch.ops import csc_iter as tci

torch.set_num_threads(2)

# (k, n) of the weight and the rows of the state: the kernel's k-step is
# 16 and its k-tile 32; 100 and 60 are ragged
SHAPES = [(256, 64, 48), (100, 60, 33)]
# the headline problem's depth of the forward pair (k = C = 4096)
DEEP = (4096, 16, 8)
# the order in which the kernel issues the six products: (state term,
# weight term), smallest first
ORDER = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))
# the depth of one tensor-core product, and of the kernel's chains between
# promotions (one k step)
STEP, DEPTH = 16, 16


def _split3(x):
    """Three bf16 terms of a float32 tensor, each rounded to nearest, as
    float32 values."""
    terms, r = [], x
    for _ in range(3):
        t = r.to(torch.bfloat16).float()
        terms.append(t)
        r = r - t
    return terms


def _truncate(x):
    """float64 to float32, rounded toward zero."""
    r = x.float()
    return torch.where(r.double().abs() > x.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def emulated_product(x, w3, n, chunk):
    """``x @ W`` as the kernel computes it, ``W`` (k, n) given by its
    split ``w3`` (``split_weight``): over each ``chunk``-deep stretch of
    k, one fp32 chain per output takes the six bf16 products of every
    16-deep k step in turn, and is then promoted into the output's fp32
    sum.  A product of bf16 terms is exact in fp32; the chain and a k
    step's dot of one term pair are summed in float64 and truncated to
    fp32 once, as the tensor core adds a step's products into its
    accumulator and truncates."""
    K = x.shape[1]
    xs = _split3(x)
    ws = [w3[i, :K, :n].float() for i in range(3)]
    acc = torch.zeros((x.shape[0], n), dtype=torch.float32)
    for k0 in range(0, K, chunk):
        c = torch.zeros_like(acc)
        for k1 in range(k0, min(k0 + chunk, K), STEP):
            ks = slice(k1, min(k1 + STEP, K))
            for i, j in ORDER:
                c = _truncate(c.double() + xs[i][:, ks].double()
                              @ ws[j][ks].double())
        acc = acc + c
    return acc


def _inputs(K, N, rows, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((rows, K))
         * (rng.random((rows, K)) < 0.3)).astype(np.float32)
    w = (0.1 * rng.standard_normal((K, N))).astype(np.float32)
    return x, w


def _bits(a):
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_split_weight_matches_jax_split_bf16_3(shape):
    """Bit for bit on the weight, zero in the padding to (32, 8)
    multiples."""
    K, N, _ = shape
    _, w = _inputs(K, N, 1, seed=0)
    # values from 1e-30 to 1e30 as well, to reach every exponent
    w[0, :N] = np.geomspace(1e-30, 1e30, N, dtype=np.float32)
    w3 = tci.split_weight(torch.tensor(w))
    assert w3.dtype == torch.bfloat16
    assert tuple(w3.shape) == (3, -(-K // 32) * 32, -(-N // 8) * 8)
    got = w3.view(torch.int16).numpy().view(np.uint16)
    for i, ref in enumerate(pki.split_bf16_3(jnp.asarray(w))):
        np.testing.assert_array_equal(got[i, :K, :N], _bits(ref))
    assert not got[:, K:, :].any() and not got[:, :, N:].any()


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_split_weight_reconstructs_the_weight(shape):
    """w1 + w2 + w3 == W exactly in fp32, for every normal float."""
    K, N, _ = shape
    _, w = _inputs(K, N, 1, seed=1)
    w[0, :N] = np.geomspace(1e-30, 1e30, N, dtype=np.float32)
    w[1, :N] = -w[0, :N]
    w3 = tci.split_weight(torch.tensor(w)).float()
    back = (w3[0] + w3[1]) + w3[2]
    np.testing.assert_array_equal(back[:K, :N].numpy(), w)


def _ulps_of_scale(shape, chunk, seed=2):
    """The emulated product's largest error against float64, in float32
    ulps of the sum of |terms| (the scale of an fp32 sum's rounding), and
    a plain fp32 product's largest error beside it."""
    K, N, rows = shape
    x, w = _inputs(K, N, rows, seed)
    got = emulated_product(torch.tensor(x), tci.split_weight(
        torch.tensor(w)), N, chunk).numpy()
    x64, w64 = x.astype(np.float64), w.astype(np.float64)
    ref = x64 @ w64
    scale = np.abs(x64) @ np.abs(w64) + 1e-30
    eps = np.finfo(np.float32).eps
    f32 = (torch.tensor(x) @ torch.tensor(w)).numpy().astype(np.float64)
    return (np.max(np.abs(got - ref) / (eps * scale)),
            np.abs(got - ref).max(), np.abs(f32 - ref).max())


@pytest.mark.parametrize("shape", SHAPES + [DEEP], ids=str)
def test_emulated_split_product_is_fp32_faithful(shape):
    """Against float64, chains promoted every 16-deep k step (the
    kernel's): within 4 ulps of float32 of the sum of |terms|, and no
    worse than twice a plain fp32 product of the same operands."""
    ulps, err, f32_err = _ulps_of_scale(shape, DEPTH)
    assert ulps <= 4
    assert err <= 2 * f32_err + 1e-30


@pytest.mark.parametrize("shape", SHAPES + [DEEP], ids=str)
def test_unpromoted_chain_is_not_fp32_faithful(shape):
    """One chain over the whole k (the tensor core's truncating
    accumulation carrying the sum) misses the bound the promoted chains
    hold on the same inputs: what promotion is for."""
    assert _ulps_of_scale(shape, shape[0])[0] > 4


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_emulated_split_product_matches_jax_dot3(shape):
    """Against the JAX package's f32-faithful six-pass product on the
    same split: both within 2 ulps of float32 of the sum of |terms| of
    each other (two fp32 summation orders of the same six products)."""
    K, N, rows = shape
    x, w = _inputs(K, N, rows, seed=4)
    got = emulated_product(torch.tensor(x), tci.split_weight(
        torch.tensor(w)), N, DEPTH).numpy()
    ref = np.asarray(pki._dot3(jnp.asarray(x), pki.split_bf16_3(
        jnp.asarray(w)), None, 6))
    scale = np.abs(x.astype(np.float64)) @ np.abs(w.astype(np.float64))
    eps = np.finfo(np.float32).eps
    assert np.all(np.abs(got - ref) <= 2 * eps * scale + 1e-30)
