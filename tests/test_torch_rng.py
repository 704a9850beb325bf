"""clsim_tpu_torch.ops.rng against jax.random: the same keys, folded keys,
random bits, uniforms and permutations, bit for bit (threefry2x32 in the
partitionable layout, jax's default), including key words and fold-in data
with the high bit set."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from clsim_tpu.propagate.diff import make_uniform_stream as stream_j
from clsim_tpu_torch.ops import rng

HIGH_KEYS = [(0, 9), (0x80000001, 0xDEADBEEF), (0xFFFFFFFF, 0x7FFFFFFF),
             (12345, 0x80000000)]


def bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", [0, 9, 2 ** 31 - 1, 2 ** 31 + 5,
                                  2 ** 32 - 1, -1, -7])
def test_base_key_matches_prngkey(seed):
    np.testing.assert_array_equal(np.asarray(jax.random.PRNGKey(seed)),
                                  rng.base_key(seed).numpy())


@pytest.mark.parametrize("key", HIGH_KEYS)
def test_fold_in_matches_jax(key):
    kj = jnp.asarray(key, jnp.uint32)
    for data in (0, 1, 47, 0x62776673, 0x74776F, 0x80000000, 0xFFFFFFFF):
        np.testing.assert_array_equal(
            np.asarray(jax.random.fold_in(kj, data)),
            rng.fold_in(key, data).numpy())
        np.testing.assert_array_equal(
            np.asarray(jax.random.fold_in(kj, data)),
            rng.iter_key(torch.tensor(key, dtype=torch.int64), data).numpy())


@pytest.mark.parametrize("key", HIGH_KEYS)
@pytest.mark.parametrize("shape,n", [((1000,), 8), ((7, 13), 3), ((1,), 1)])
def test_uniforms_bit_exact(key, shape, n):
    uj = jax.random.uniform(jnp.asarray(key, jnp.uint32), (n,) + shape,
                            dtype=jnp.float32)
    ut = rng.uniforms(key, shape, n)
    assert tuple(ut.shape) == (n,) + shape and ut.dtype == torch.float32
    np.testing.assert_array_equal(bits(uj), bits(ut.numpy()))
    assert float(ut.min()) >= 0.0 and float(ut.max()) < 1.0
    np.testing.assert_array_equal(rng.uniform_oc(ut).numpy(), 1.0 - ut.numpy())


def test_random_bits_match_jax_bits():
    kj = jnp.asarray(HIGH_KEYS[1], jnp.uint32)
    np.testing.assert_array_equal(
        np.asarray(jax.random.bits(kj, (4096,), jnp.uint32)),
        rng.random_bits(HIGH_KEYS[1], 4096).numpy().astype(np.uint32))
    with pytest.raises(ValueError, match="2\\*\\*32"):
        rng.random_bits(HIGH_KEYS[1], 2 ** 32)


@pytest.mark.parametrize("n", [1, 100, 1000, 4097])
def test_permutation_matches_jax(n):
    for key in HIGH_KEYS[:2]:
        kf = rng.fold_in(key, 0x62776673)
        pj = jax.random.permutation(
            jax.random.fold_in(jnp.asarray(key, jnp.uint32), 0x62776673), n)
        np.testing.assert_array_equal(np.asarray(pj), rng.permutation(kf, n))


def test_uniform_stream_and_key_table():
    """make_uniform_stream is the JAX package's shared (T, 8, N) stream;
    key_table holds the T folded keys the kernel's threefry mode reads."""
    key = HIGH_KEYS[1]
    uj = stream_j(jnp.asarray(key, jnp.uint32), 5, 384)
    ut = rng.make_uniform_stream(key, 5, 384)
    np.testing.assert_array_equal(bits(uj), bits(ut.numpy()))
    tab = rng.key_table(key, 5)
    assert tab.dtype == torch.int64 and tuple(tab.shape) == (10,)
    for i in range(5):
        np.testing.assert_array_equal(tab[2 * i:2 * i + 2].numpy(),
                                      rng.iter_key(key, i).numpy())
        np.testing.assert_array_equal(
            bits(ut[i].numpy()), bits(rng.uniforms(tab[2 * i:2 * i + 2],
                                                   (384,), 8).numpy()))


def test_as_key_accepts_jax_numpy_and_tensors():
    want = [0x80000001, 0xDEADBEEF]
    for k in (jnp.asarray(want, jnp.uint32), np.asarray(want, np.uint32),
              want, torch.tensor(want, dtype=torch.int64)):
        assert rng.as_key(k).tolist() == want
    with pytest.raises(ValueError, match="two words"):
        rng.as_key([1, 2, 3])


@pytest.mark.cuda
def test_card_bits_equal_cpu_bits():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    key = HIGH_KEYS[1]
    a = rng.make_uniform_stream(key, 3, 4096)
    b = rng.make_uniform_stream(rng.as_key(key, "cuda"), 3, 4096).cpu()
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))
