"""64-bit hash functions on uint32 pairs.

The reference sketch library's default hasher is Thomas Wang's 64-bit integer
mixer (`sketch::WangHash`; see reference src/dashing.h:42 `BottomKHasher<
sketch::WangHash,...>` and src/dashing.h:123-128 `SeededHash`).  Wang's hash
is a public-domain bijective mixer built purely from shifts/adds/xors, which
makes it ideal on an accelerator: no 64-bit multiplies to emulate.

All functions operate elementwise on arbitrary-shaped (hi, lo) uint32 pairs.
"""
from __future__ import annotations

import numpy as np

from . import u64
from .u64 import U64


def wang_hash(x: U64) -> U64:
    """Thomas Wang's 64-bit mix; matches sketch::WangHash::operator()."""
    # key = (~key) + (key << 21)
    x = u64.add(u64.not_(x), u64.shl(x, 21))
    # key = key ^ (key >> 24)
    x = u64.xor(x, u64.shr(x, 24))
    # key = (key + (key << 3)) + (key << 8)   i.e. key * 265
    x = u64.add(u64.add(x, u64.shl(x, 3)), u64.shl(x, 8))
    # key = key ^ (key >> 14)
    x = u64.xor(x, u64.shr(x, 14))
    # key = (key + (key << 2)) + (key << 4)   i.e. key * 21
    x = u64.add(u64.add(x, u64.shl(x, 2)), u64.shl(x, 4))
    # key = key ^ (key >> 28)
    x = u64.xor(x, u64.shr(x, 28))
    # key = key + (key << 31)
    x = u64.add(x, u64.shl(x, 31))
    return x


def seeded_wang_hash(x: U64, seed: int) -> U64:
    """wang_hash(x ^ seed); mirrors SeededHash (reference src/dashing.h:123-128)."""
    return wang_hash(u64.xor(x, u64.const(seed)))


def wang_hash_np(x: np.ndarray) -> np.ndarray:
    """Host-side numpy reference of wang_hash (uint64 in/out)."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        x = (~x) + (x << np.uint64(21))
        x = x ^ (x >> np.uint64(24))
        x = (x + (x << np.uint64(3))) + (x << np.uint64(8))
        x = x ^ (x >> np.uint64(14))
        x = (x + (x << np.uint64(2))) + (x << np.uint64(4))
        x = x ^ (x >> np.uint64(28))
        x = x + (x << np.uint64(31))
    return x


def seeded_wang_hash_np(x: np.ndarray, seed: int) -> np.ndarray:
    return wang_hash_np(np.asarray(x, np.uint64) ^ np.uint64(seed))


# ---------------------------------------------------------------------------
# clhash: carry-less-multiplication hashing (Lemire & Kaser, "Faster 64-bit
# universal hashing using carry-less multiplications", 2015).
#
# The reference links clhash.o into every binary (reference Makefile:55,63)
# but never calls it from src/ — it is an alternative hasher inside the
# absent sketch submodule.  Provided here in the same spirit: available in
# the hash stack, unused by the default pipeline (WangHash remains the
# observable default).  The x86 original rides PCLMULQDQ; the accelerator has
# no carry-less multiplier, so the 32x32->64 CLMUL is built from 32
# mask-select/shift/XOR steps on uint32 lanes (unrolled, traced
# once under jit) and the 64x64 product composes four of them — carry-less
# multiplication splits exactly with XOR, no Karatsuba correction terms.
# Reduction is modulo the irreducible x^64 + x^4 + x^3 + x + 1.
# ---------------------------------------------------------------------------

def _clmul32(a, b):
    """Carry-less 32x32 -> 64-bit product on uint32 lanes -> (hi, lo)."""
    import jax.numpy as jnp
    zero = jnp.zeros_like(a)
    hi, lo = zero, zero
    for i in range(32):
        mask = jnp.uint32(0) - ((b >> jnp.uint32(i)) & jnp.uint32(1))
        lo = lo ^ ((a << jnp.uint32(i)) & mask)
        if i:
            hi = hi ^ ((a >> jnp.uint32(32 - i)) & mask)
    return hi, lo


def gf64_mul(a: U64, b: U64) -> U64:
    """GF(2^64) product modulo x^64 + x^4 + x^3 + x + 1.

    Jitted (decorated below): the 4x32 unrolled CLMUL is hundreds of
    traced ops, and an eager call would pay one device round-trip per
    op (repo rule: everything reachable from outside jit
    must be jitted).  Nested use under an enclosing jit inlines."""
    aH, aL = a
    bH, bL = b
    m0h, m0l = _clmul32(aL, bL)
    m2h, m2l = _clmul32(aH, bH)
    mAh, mAl = _clmul32(aH, bL)
    mBh, mBl = _clmul32(aL, bH)
    low = (m0h ^ mAl ^ mBl, m0l)
    high = (m2h, m2l ^ mAh ^ mBh)
    # high * x^64 == high * (x^4 + x^3 + x + 1); the <<4/<<3/<<1 overflow
    # (<= 4 bits) folds once more through the same polynomial
    t = u64.xor(u64.xor(u64.shl(high, 4), u64.shl(high, 3)),
                u64.xor(u64.shl(high, 1), high))
    top = ((high[0] >> 28) ^ (high[0] >> 29) ^ (high[0] >> 31))
    t2 = (top << 4) ^ (top << 3) ^ (top << 1) ^ top
    low = u64.xor(low, t)
    return (low[0], low[1] ^ t2)


def _jit_gf64_mul():
    import jax
    return jax.jit(gf64_mul)


gf64_mul = _jit_gf64_mul()


import functools as _functools


@_functools.lru_cache(maxsize=64)
def _clhash_compiled(s: int):
    # module scope: a function-local lru_cache was rebuilt every call, so
    # both it and the jit lambda missed their caches and each clhash()
    # call re-traced the full GF(2^64) multiply (a fresh device compile)
    import jax
    k1 = int(wang_hash_np(np.asarray([s ^ 0x2127599BF4325C37],
                                     np.uint64))[0])
    k2 = int(wang_hash_np(np.asarray([s ^ 0x9FB21C651E98DF25],
                                     np.uint64))[0]) | 1
    return jax.jit(lambda v: gf64_mul(u64.xor(v, u64.const(k1)),
                                      u64.full((), k2)))


def clhash(x: U64, seed: int = 0) -> U64:
    """Carry-less universal hash of a 64-bit key: (x ^ K1) * K2 in
    GF(2^64), keys derived from the seed by WangHash (the single-word
    case of the CLHASH family).  One jitted dispatch per call (the
    compiled multiply is cached per seed)."""
    return _clhash_compiled(int(seed))(x)


def gf64_mul_np(a: np.ndarray, b) -> np.ndarray:
    """Host numpy reference of gf64_mul (uint64 in/out)."""
    a = np.asarray(a, np.uint64)
    b = np.asarray(b, np.uint64)
    hi = np.zeros_like(a)
    lo = np.zeros_like(a)
    with np.errstate(over="ignore"):   # 0 - 1 wraps to all-ones on purpose
        for i in range(64):
            mask = np.uint64(0) - ((b >> np.uint64(i)) & np.uint64(1))
            lo = lo ^ ((a << np.uint64(i)) & mask)
            if i:
                hi = hi ^ ((a >> np.uint64(64 - i)) & mask)
    t = (hi << np.uint64(4)) ^ (hi << np.uint64(3)) \
        ^ (hi << np.uint64(1)) ^ hi
    top = (hi >> np.uint64(60)) ^ (hi >> np.uint64(61)) \
        ^ (hi >> np.uint64(63))
    lo = lo ^ t
    return lo ^ ((top << np.uint64(4)) ^ (top << np.uint64(3))
                 ^ (top << np.uint64(1)) ^ top)


def clhash_np(x: np.ndarray, seed: int = 0) -> np.ndarray:
    k1 = wang_hash_np(np.asarray([seed ^ 0x2127599BF4325C37], np.uint64))[0]
    k2 = wang_hash_np(np.asarray([seed ^ 0x9FB21C651E98DF25],
                                 np.uint64))[0] | np.uint64(1)
    return gf64_mul_np(np.asarray(x, np.uint64) ^ k1, k2)


def clz64_np(x: "np.ndarray") -> "np.ndarray":
    """Branchless leading-zero count of nonzero uint64s (log-doubling).

    Shared by the host HLL/WideHLL/HyperMinHash rank computations so the
    rank semantics cannot drift between structures.  Callers guarantee
    nonzero inputs (a guard bit is always planted)."""
    x = np.atleast_1d(np.asarray(x, np.uint64))
    cnt = np.zeros(len(x), np.int64)
    y = np.asarray(x, np.uint64).copy()
    for s in (32, 16, 8, 4, 2, 1):
        zt = (y >> np.uint64(64 - s)) == 0
        cnt += np.where(zt, s, 0)
        y = np.where(zt, y << np.uint64(s), y)
    return cnt


def poisson_min_cardinality(mins: "np.ndarray", m: int) -> float:
    """Invert E[min of uniforms per Poisson(lambda) bucket] = (1-e^-l)/l
    by log-space bisection; cardinality = lambda * m.  `mins` holds the
    FILLED buckets' minima as uint64; empty buckets count as min = 1.
    Shared by the minhash family cardinality estimators."""
    import math
    nfill = len(mins)
    if nfill == 0:
        return 0.0
    u = np.asarray(mins, np.uint64).astype(np.float64) / 2.0 ** 64
    u = np.concatenate([u, np.ones(m - nfill)])
    mean = min(max(float(u.mean()), 1e-18), 1.0 - 1e-12)
    lo, hi = 1e-9, 1e12
    for _ in range(100):
        lam = math.sqrt(lo * hi)
        if -math.expm1(-lam) / lam > mean:
            lo = lam
        else:
            hi = lam
    return math.sqrt(lo * hi) * m
