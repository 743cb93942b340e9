"""uint64 arithmetic on (hi, lo) uint32 pairs.

Everything 64-bit in this framework (k-mer codes, hashes, HLL bucket/rank
slicing) runs on explicit uint32 pairs: 32-bit integer lanes are native on
every accelerator JAX targets, while 64-bit integer support varies.  All
functions are shape-polymorphic and work under jit/vmap and inside Pallas
kernels.

A "u64" here is simply a tuple (hi, lo) of equal-shaped jnp.uint32 arrays.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

U64 = Tuple[jnp.ndarray, jnp.ndarray]

_U32 = jnp.uint32


def const(v: int) -> U64:
    """Scalar uint64 constant as a (hi, lo) pair."""
    v = int(v) & 0xFFFFFFFFFFFFFFFF
    return jnp.uint32(v >> 32), jnp.uint32(v & 0xFFFFFFFF)


def full(shape, v: int) -> U64:
    v = int(v) & 0xFFFFFFFFFFFFFFFF
    return (jnp.full(shape, v >> 32, _U32), jnp.full(shape, v & 0xFFFFFFFF, _U32))


def from_np(arr: np.ndarray) -> U64:
    """Host numpy uint64 array -> device (hi, lo)."""
    arr = np.asarray(arr, dtype=np.uint64)
    return (jnp.asarray((arr >> np.uint64(32)).astype(np.uint32)),
            jnp.asarray((arr & np.uint64(0xFFFFFFFF)).astype(np.uint32)))


def to_np(x: U64) -> np.ndarray:
    """Device (hi, lo) -> host numpy uint64 array."""
    hi = np.asarray(jax.device_get(x[0]), dtype=np.uint64)
    lo = np.asarray(jax.device_get(x[1]), dtype=np.uint64)
    return (hi << np.uint64(32)) | lo


def xor(a: U64, b: U64) -> U64:
    return a[0] ^ b[0], a[1] ^ b[1]


def or_(a: U64, b: U64) -> U64:
    return a[0] | b[0], a[1] | b[1]


def and_(a: U64, b: U64) -> U64:
    return a[0] & b[0], a[1] & b[1]


def not_(a: U64) -> U64:
    return ~a[0], ~a[1]


def add(a: U64, b: U64) -> U64:
    """64-bit wrapping add with carry propagation."""
    lo = a[1] + b[1]
    carry = (lo < a[1]).astype(_U32)
    hi = a[0] + b[0] + carry
    return hi, lo


def shl(a: U64, n: int) -> U64:
    """Logical shift left by a static amount 0..63."""
    n = int(n)
    if n == 0:
        return a
    if n >= 64:
        z = jnp.zeros_like(a[0])
        return z, z
    if n >= 32:
        return a[1] << (n - 32) if n > 32 else a[1], jnp.zeros_like(a[1])
    return (a[0] << n) | (a[1] >> (32 - n)), a[1] << n


def shr(a: U64, n: int) -> U64:
    """Logical shift right by a static amount 0..63."""
    n = int(n)
    if n == 0:
        return a
    if n >= 64:
        z = jnp.zeros_like(a[0])
        return z, z
    if n >= 32:
        return jnp.zeros_like(a[0]), a[0] >> (n - 32) if n > 32 else a[0]
    return a[0] >> n, (a[1] >> n) | (a[0] << (32 - n))


def add_const(a: U64, v: int) -> U64:
    return add(a, (jnp.uint32((int(v) >> 32) & 0xFFFFFFFF),
                   jnp.uint32(int(v) & 0xFFFFFFFF)))


def mul_const(a: U64, v: int) -> U64:
    """Multiply by a static 64-bit constant (schoolbook on 16-bit limbs).

    Used for multiplicative mixers (e.g. Murmur/XXH finalizers).  WangHash —
    the default hash in the reference sketch library — needs no multiplies,
    but other hash families do.
    """
    v = int(v) & 0xFFFFFFFFFFFFFFFF
    # Decompose a into 16-bit limbs to keep partial products exact in u32.
    a0 = a[1] & 0xFFFF
    a1 = a[1] >> 16
    a2 = a[0] & 0xFFFF
    a3 = a[0] >> 16
    limbs_a = (a0, a1, a2, a3)
    limbs_v = [(v >> (16 * i)) & 0xFFFF for i in range(4)]
    # Accumulate column sums; each partial product < 2^32, and at most 4 per
    # column, so a uint64 (pairwise-added) accumulator per column is safe.
    res = full(a[0].shape, 0)
    for i in range(4):
        for j in range(4):
            if limbs_v[j] == 0 or i + j >= 4:
                continue
            prod = limbs_a[i] * jnp.uint32(limbs_v[j])  # exact in u32
            res = add(res, shl((jnp.zeros_like(prod), prod), 16 * (i + j)))
    return res


def mul(a: U64, b: U64) -> U64:
    """Full 64x64 -> low-64 multiply of two dynamic u64s."""
    a0 = a[1] & 0xFFFF
    a1 = a[1] >> 16
    a2 = a[0] & 0xFFFF
    a3 = a[0] >> 16
    b0 = b[1] & 0xFFFF
    b1 = b[1] >> 16
    b2 = b[0] & 0xFFFF
    b3 = b[0] >> 16
    la = (a0, a1, a2, a3)
    lb = (b0, b1, b2, b3)
    res = full(a[0].shape, 0)
    for i in range(4):
        for j in range(4):
            if i + j >= 4:
                continue
            prod = la[i] * lb[j]
            res = add(res, shl((jnp.zeros_like(prod), prod), 16 * (i + j)))
    return res


def rotl(a: U64, n: int) -> U64:
    n = int(n) % 64
    if n == 0:
        return a
    return or_(shl(a, n), shr(a, 64 - n))


def eq(a: U64, b: U64) -> jnp.ndarray:
    return (a[0] == b[0]) & (a[1] == b[1])


def lt(a: U64, b: U64) -> jnp.ndarray:
    """Unsigned a < b."""
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))


def le(a: U64, b: U64) -> jnp.ndarray:
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] <= b[1]))


def min_(a: U64, b: U64) -> U64:
    c = lt(a, b)
    return jnp.where(c, a[0], b[0]), jnp.where(c, a[1], b[1])


def select(pred: jnp.ndarray, a: U64, b: U64) -> U64:
    return jnp.where(pred, a[0], b[0]), jnp.where(pred, a[1], b[1])


def clz(a: U64) -> jnp.ndarray:
    """Count leading zeros of the 64-bit value, as int32 in [0, 64]."""
    hi_z = a[0] == 0
    chi = jax.lax.clz(a[0].astype(jnp.int32)).astype(jnp.int32)
    clo = jax.lax.clz(a[1].astype(jnp.int32)).astype(jnp.int32)
    # lax.clz(0) == 32 for 32-bit inputs, so this saturates correctly at 64.
    return jnp.where(hi_z, 32 + clo, chi)
