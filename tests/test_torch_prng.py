"""The port's threefry key chain and samplers (core/prng.py) against
JAX's on the same keys, bit for bit.

The reference runs with `jax_threefry_partitionable` on (JAX 0.9's
default) and float32 / int32 defaults, so every reference draw here runs
with x64 off (the tests' conftest turns it on for gradient checks).

`normal` is bit-exact: test_normal_bit_exact draws 2^20 + 3 values at
seeds 0 and 7 and no draw differs (0 of 2,097,158; largest gap 0 ulp).
That takes the reference's own rounding: XLA's CPU backend contracts a
multiply feeding an add into a fused multiply-add, which `prng.fma`
reproduces from float64 operations, and torch's CPU sqrt is not
correctly rounded, which `prng._sqrt` corrects. Without the fma, more
than a tenth of 2^20 uniform draws on [-0.37, 0.81) miss the reference's
bits (test_uniform_needs_the_fused_multiply_add).
"""
import math
from fractions import Fraction

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rram_caffe_simulation_tpu_torch.core import prng

SEED = 7


def ref(fn, *args, **kw):
    """A reference draw with x64 off, copied out of JAX's buffer."""
    with jax.enable_x64(False):
        return np.array(fn(*args, **kw), copy=True)


def jkey(seed=SEED):
    with jax.enable_x64(False):
        return jax.random.PRNGKey(seed)


def test_reference_uses_partitionable_threefry():
    """The port mirrors the partitionable mode; a JAX that flips the
    default would draw other bits in the reference."""
    assert jax.config.jax_threefry_partitionable is True
    assert jax.__version__.split(".")[:2] == ["0", "9"]


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31 - 1, SEED])
def test_prng_key(seed):
    got = prng.PRNGKey(seed)
    assert got.dtype == np.uint32 and got.shape == (2,)
    np.testing.assert_array_equal(got, ref(jax.random.PRNGKey, seed))


@pytest.mark.parametrize("n", [2, 3, 512])
def test_split(n):
    np.testing.assert_array_equal(prng.split(prng.PRNGKey(SEED), n),
                                  ref(jax.random.split, jkey(), n))


@pytest.mark.parametrize("data", [0, 7, 0x4A7, 0xFA117, 2 ** 31 - 1])
def test_fold_in(data):
    np.testing.assert_array_equal(prng.fold_in(prng.PRNGKey(SEED), data),
                                  ref(jax.random.fold_in, jkey(), data))


def test_key_ops_vectorise_over_leading_axes():
    """A (C, 2) batch of keys folds, splits and draws as jax.vmap does,
    on the Python-int path (<= 8 counters) and the numpy path alike."""
    for c in (3, 40):
        keys = ref(jax.random.split, jkey(), c)
        data = np.arange(c) * 97
        with jax.enable_x64(False):
            jk = jnp.asarray(keys)
            want_f = np.array(jax.vmap(jax.random.fold_in)(
                jk, jnp.asarray(data, jnp.uint32)), copy=True)
            want_s = np.array(jax.vmap(lambda k: jax.random.split(k, 3))(
                jk), copy=True)
        np.testing.assert_array_equal(prng.fold_in(keys, data), want_f)
        np.testing.assert_array_equal(prng.split(keys, 3), want_s)


SHAPES = [(), (1,), (63,), (5, 7, 3), (2, 1, 9, 4), (2 ** 20 + 3,)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_random_bits(shape):
    got = prng.random_bits(prng.PRNGKey(SEED), shape)
    assert got.dtype == torch.int64 and tuple(got.shape) == shape
    want = ref(jax.random.bits, jkey(), shape, jnp.uint32)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-0.37, 0.81),
                                    (-0.0547, 0.0547)], ids=str)
def test_uniform(shape, bounds):
    got = prng.uniform(prng.PRNGKey(SEED), shape, *bounds)
    want = ref(jax.random.uniform, jkey(), shape, jnp.float32, *bounds)
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()


def test_uniform_needs_the_fused_multiply_add():
    """f * (hi - lo) + lo rounded twice misses the reference's bits."""
    key, n = prng.PRNGKey(SEED), 2 ** 20
    bits = prng.random_bits(key, (n,))
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = float(np.float32(-0.37))
    span = float(np.float32(0.81) - np.float32(-0.37))
    want = ref(jax.random.uniform, jkey(), (n,), jnp.float32, -0.37, 0.81)
    twice = torch.clamp_min(f * span + lo, lo).numpy()
    assert (twice != want).sum() > n // 10
    assert (prng.uniform(key, (n,), -0.37, 0.81).numpy() == want).all()


@pytest.mark.parametrize("shape", [(1000,), (3, 333)], ids=str)
def test_bernoulli(shape):
    got = prng.bernoulli(prng.PRNGKey(SEED), 0.3, shape)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(
        got.numpy(), ref(jax.random.bernoulli, jkey(), 0.3, shape))


@pytest.mark.parametrize("bounds", [(0, 2 ** 31 - 1), (5, 17), (-3, 3),
                                    (4, 4)], ids=str)
def test_randint(bounds):
    """The crossbar seed (0, 2^31 - 1) and other spans, 64 keys at once,
    each against jax.random.randint on its own key."""
    keys = ref(jax.random.split, jkey(), 64)
    got = prng.randint(keys, *bounds)
    assert got.dtype == np.int32 and got.shape == (64,)
    with jax.enable_x64(False):
        want = np.array(jax.vmap(lambda k: jax.random.randint(
            k, (), bounds[0], bounds[1]))(jnp.asarray(keys)), copy=True)
    np.testing.assert_array_equal(got, want)
    assert int(prng.randint(keys[5], *bounds)) == int(want[5])


@pytest.mark.parametrize("seed", [0, SEED])
def test_normal_bit_exact(seed):
    """2^20 + 3 draws, every one the reference's bits (including the
    w >= 5 tail of erf_inv, |u| > 0.9966, ~0.3% of draws)."""
    n = 2 ** 20 + 3
    got = prng.normal(prng.PRNGKey(seed), (n,))
    want = ref(jax.random.normal, jkey(seed), (n,), jnp.float32)
    assert got.dtype == torch.float32
    diff = np.nonzero(got.numpy().view(np.int32) != want.view(np.int32))[0]
    assert diff.size == 0, (diff.size, diff[:5])


def test_normal_batched_keys():
    keys = ref(jax.random.split, jkey(), 6)
    with jax.enable_x64(False):
        want = np.array(jax.vmap(lambda k: jax.random.normal(
            k, (5, 7)))(jnp.asarray(keys)), copy=True)
    got = prng.normal(keys, (5, 7))
    assert got.shape == (6, 5, 7)
    assert got.numpy().tobytes() == want.tobytes()


def test_normal_fma_is_the_jitted_scale_and_shift():
    """Inside a jitted step XLA folds sqrt(2) * sigma into one constant
    and fuses the add: 1 + sigma * normal there is normal_fma."""
    key, shape = prng.PRNGKey(SEED), (64, 257)
    with jax.enable_x64(False):
        want = np.array(jax.jit(lambda k: 1.0 + 0.05 * jax.random.normal(
            k, shape))(jkey()), copy=True)
    got = prng.normal_fma(key, shape, 0.05, 1.0)
    assert got.numpy().tobytes() == want.tobytes()


def test_small_draws_run_on_the_host_with_the_same_bits(monkeypatch):
    """Below SMALL_DRAW elements the draw runs on the host; forcing the
    other side of the threshold gives the same bits."""
    key = prng.PRNGKey(3)
    small = prng.normal(key, (10,))
    monkeypatch.setattr(prng, "SMALL_DRAW", 0)
    assert torch.equal(prng.normal(key, (10,)), small)
    assert prng._draw_device(key, (10,), "cpu")[3].type == "cpu"


def _exact_fma32(a, b, c):
    v = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    x = np.float32(float(v))
    near = [x, np.nextafter(x, np.float32(np.inf)),
            np.nextafter(x, np.float32(-np.inf))]
    return min(near, key=lambda y: (abs(Fraction(float(y)) - v),
                                    int(np.array(y).view(np.int32)) & 1))


def test_fma_is_correctly_rounded():
    """Random operands and hard cases (a product whose low bits meet
    the float64 sum's rounding) against exact rational arithmetic."""
    rng = np.random.RandomState(0)
    a = rng.randn(3000).astype(np.float32)
    b = (rng.randn(3000) * 10.0 ** rng.randint(-6, 6, 3000)).astype(
        np.float32)
    c = rng.randn(3000).astype(np.float32)
    # c = -round(a * b) makes the sum the product's rounding error
    c[:1000] = -(a[:1000].astype(np.float64) * b[:1000]).astype(np.float32)
    got = prng.fma(torch.from_numpy(a), torch.from_numpy(b),
                   torch.from_numpy(c)).numpy()
    want = np.array([_exact_fma32(*v) for v in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_sqrt_is_correctly_rounded():
    """torch's CPU sqrt misses the correct rounding on some inputs;
    prng._sqrt does not (numpy's float32 sqrt is correctly rounded)."""
    rng = np.random.RandomState(1)
    w = rng.uniform(0, 100, 1 << 20).astype(np.float32)
    w[:3] = (0.0, 5.0, float(np.float32(math.pi)))
    got = prng._sqrt(torch.from_numpy(w)).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.sqrt(w).view(np.int32))
