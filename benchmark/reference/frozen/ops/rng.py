"""Counter-based threefry2x32 random numbers, bit-exact to jax.random.

PyTorch counterpart of clsim_tpu.ops.rng.  The JAX package draws every
random number of its propagation from jax.random (threefry2x32 in the
partitionable counter layout, the default of jax 0.9), so the same key gives
the same uniforms in the JAX engine, the JAX kernel, and here: in the port's
engine (`propagate(..., key=)`), in the CUDA kernel's threefry mode
(csrc/propagate.cu) and in the kernel's plain version.  That shared stream
is what makes the expected estimator a deterministic, differentiable
function of the ice parameters (propagate/diff.py).

A key is a (2,) int64 tensor holding two uint32 words (torch has no
general uint32 arithmetic; every value here is int64 masked to 32 bits).
fold_in, random_bits and uniforms also take a (..., 2) tensor of keys and
answer for each key at once, in one vectorised threefry call (the tabulator
draws a chunk of iterations so).  Everything runs on the key's device and
gives the same bits on the CPU and on a CUDA device:

  * base_key(seed): jax.random.PRNGKey(seed) as jax builds it in its
    default 32-bit mode, [0, seed mod 2**32];
  * fold_in(key, i) = iter_key(key, i): threefry2x32(key, (0, i)), both
    output words;
  * uniforms(key, shape, n): element j of the flattened (n,) + shape block
    draws xor(threefry2x32(key, (0, j))), and its float is
    ((bits >> 9) | 0x3F800000) as float32, minus 1;
  * permutation(key, n): jax.random.permutation's sort-based shuffle;
  * make_uniform_stream(key, T, N): the (T, 8, N) stream of T iterations;
  * key_table(key, T): the (2T,) folded per-iteration keys the kernel reads.
"""

from __future__ import annotations

import math

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def as_key(key, device=None) -> torch.Tensor:
    """A (2,) int64 key tensor from any (2,) integer array-like (a numpy or
    jax uint32 key, a list, a tensor), on `device` (default: where it
    is, or the CPU)."""
    if isinstance(key, torch.Tensor):
        k = key.to(torch.int64)
        return k if device is None else k.to(device)
    vals = [int(v) & MASK for v in list(key)]
    if len(vals) != 2:
        raise ValueError(f"a key has two words, got {len(vals)}")
    return torch.tensor(vals, dtype=torch.int64, device=device)


def threefry2x32(k0, k1, c0, c1):
    """The 20-round threefry2x32 block cipher on uint32 words held in int64
    tensors (or Python ints): returns the two output words."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (c0 + ks[0]) & MASK
    x1 = (c1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) & MASK) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def base_key(seed: int, device=None) -> torch.Tensor:
    """jax.random.PRNGKey(seed) in jax's default 32-bit mode: the high
    word is 0 and the low word is the seed modulo 2**32."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def fold_in(key, data) -> torch.Tensor:
    """jax.random.fold_in(key, data) for a 32-bit `data`: an int, or an
    int64 tensor broadcast against the keys of a (..., 2) key tensor.
    Returns the (..., 2) folded keys."""
    k = as_key(key)
    d = (int(data) & MASK if isinstance(data, int) else
         torch.as_tensor(data, dtype=torch.int64, device=k.device) & MASK)
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], 0, d)
    return torch.stack(torch.broadcast_tensors(y0, y1), -1)


def iter_key(key, iteration: int) -> torch.Tensor:
    """Key of one propagation-loop iteration (all lanes share it)."""
    return fold_in(key, iteration)


def random_bits(key, count: int) -> torch.Tensor:
    """jax.random's 32-bit random bits of a flat block of `count` elements
    (int64 tensor of uint32 values on the key's device), shaped
    (..., count) for a (..., 2) key tensor."""
    if count >= 2 ** 32:
        raise ValueError("a block of 2**32 or more elements needs the "
                         "64-bit counter, which is not ported")
    k = as_key(key)
    j = torch.arange(count, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[..., 0:1], k[..., 1:2], 0, j)
    return y0 ^ y1


def uniforms(key, shape, n: int) -> torch.Tensor:
    """n independent uniform [0, 1) float32 blocks of `shape` in one draw,
    shaped (n,) + shape: jax.random.uniform(key, (n,) + shape).  A (..., 2)
    key tensor gives (...,) + (n,) + shape, one draw per key."""
    shape = (int(n),) + tuple(int(s) for s in shape)
    bits = random_bits(key, math.prod(shape))
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return (f - 1.0).reshape(bits.shape[:-1] + shape)


def uniform_oc(u):
    """Map [0, 1) to (0, 1]: the reference's RNG_CALL_UNIFORM_OC."""
    return 1.0 - u


def permutation(key, n: int) -> torch.Tensor:
    """jax.random.permutation(key, n): rounds of a stable sort of
    arange(n) by fresh random bits, ceil(3 ln n / ln(2**32 - 1)) rounds,
    each keyed by the second half of a split."""
    k = as_key(key)
    x = torch.arange(n, dtype=torch.int64, device=k.device)
    rounds = int(math.ceil(3.0 * math.log(max(1, n)) / math.log(MASK)))
    for _ in range(rounds):
        k, sub = fold_in(k, 0), fold_in(k, 1)   # jax.random.split(k)
        order = torch.sort(random_bits(sub, n), stable=True).indices
        x = x[order]
    return x


def make_uniform_stream(key, n_iterations: int, n_slots: int):
    """The shared (T, 8, N) stream: iteration i's block is
    uniforms(iter_key(key, i), (N,), 8), as the engine's key mode and the
    kernel's threefry mode draw it."""
    return uniforms(_iteration_keys(key, n_iterations), (n_slots,), 8)


def _iteration_keys(key, n_iterations: int) -> torch.Tensor:
    """(T, 2) keys iter_key(key, i) of iterations 0 .. T - 1."""
    k = as_key(key)
    return fold_in(k, torch.arange(int(n_iterations), dtype=torch.int64,
                                   device=k.device))


def key_table(key, n_iterations: int) -> torch.Tensor:
    """(2T,) int64 table of the folded per-iteration keys (uint32 words):
    what the CUDA kernel's threefry mode reads for iteration i at
    [2i, 2i + 1]."""
    return _iteration_keys(key, n_iterations).reshape(-1)

