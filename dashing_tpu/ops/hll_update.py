"""HLL register updates: hashed k-mers -> 2^p registers, on device.

Replaces the reference's per-element `hll_t::addh` hot loop (call sites
reference src/sketch_and_cmp.h:500-512).  Register semantics replicated from
the reference (observable at src/readfilt.cpp:86-89):

    index = h >> (64 - p)                    (top p bits)
    rank  = clz( ((h << 1) | 1) << (p - 1) ) + 1
          = (leading zeros of the low 64-p bits) + 1, saturating at q+1
    reg[index] = max(reg[index], rank)

Merging registers is an elementwise max, which is what makes the whole
pipeline embarrassingly parallel: chunks, tiles, rows, and devices all
combine with jnp.maximum / a max all-reduce.

Two implementations:
  * `update_registers` — XLA scatter-max.  Always correct; the baseline.
  * `update_registers_matmul` — matmul path: one-hot bucket matrix against a
    rank>=level indicator matrix; a bucket's register is the number of
    levels with a nonzero hit count.  Turns the scatter into dense matmuls.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import u64
from ..u64 import U64


def bucket_rank(h: U64, p: int):
    """Split hashes into (bucket index, rank); invalid lanes handled by caller."""
    q = 64 - p
    if p > 31:
        # p == 32 would shift by 0 and the raw uint32 high word wraps
        # NEGATIVE in the int32 index, so scatter mode="drop" silently
        # discards every hash with the top bit set (~half of them)
        raise ValueError("p must be <= 31 on the device update path")
    idx = (h[0] >> (32 - p)).astype(jnp.int32)
    rest = u64.or_(u64.shl(h, p), u64.const(1 << (p - 1)))
    rank = (u64.clz(rest) + 1).astype(jnp.int32)  # in [1, q+1]
    del q
    return idx, rank


@functools.partial(jax.jit, static_argnames=("p",))
def update_registers(regs: jnp.ndarray, h: U64, valid: jnp.ndarray, p: int) -> jnp.ndarray:
    """Scatter-max a batch of hashes into (m,) int32 registers."""
    idx, rank = bucket_rank(h, p)
    rank = jnp.where(valid, rank, 0)
    return regs.at[idx.reshape(-1)].max(rank.reshape(-1), mode="drop")


# Compaction row width and default survivor capacity per row: chosen on
# the previous target; not tuned for the H100 (ROADMAP S2, S6).
_ROW = 2048
_CAPR = 64


def adaptive_cap(row: int, m: int, seen: int) -> int:
    """Base survivor capacity for the next chunk given `seen` k-mers
    already in the m registers.  top_k cost scales with the capacity, so
    shrink the cap as the stream fills the registers.  The expected
    survivor count per row is row * 2^-min(regs); min(regs) sits a few
    levels BELOW log2(seen/m) (minimum statistics over 2^p registers: a
    naive unadjusted seen-based cap overflows ~every slab), hence the 4x
    adjustment.  The schedule was chosen on the previous target; not
    tuned for the H100 (ROADMAP S2, S6).  Misestimates degrade
    gracefully: _update_slab escalates overflowing slabs to a 4x-cap
    top_k and only then to the exact full scatter."""
    if seen <= 0:
        return 128
    mean = 4.0 * row * m / seen
    target = 2.0 * mean + 10.0
    cap = 16
    while cap < target and cap < 128:
        cap *= 2
    return cap


@functools.partial(jax.jit, static_argnames=("p", "cap"))
def update_registers_filtered(regs: jnp.ndarray, h: U64, valid: jnp.ndarray,
                              p: int, cap: int = _CAPR) -> jnp.ndarray:
    """Threshold-filtered scatter-max: the fast path for streaming updates.

    Registers only grow, so a hash whose rank is <= min(regs) cannot change
    any register.  After the first chunk of a genome min(regs) is ~
    log2(n/m), so only a ~2^-min fraction of hashes can matter.  Survivors
    are compacted with a per-row lax.top_k over packed (rank, lane) keys,
    then scattered (a full scatter of every hash was several times slower
    on the previous target; not measured on the H100 yet).  Exactness: a
    row's dropped keys all have rank <= its smallest kept rank, so if every row's smallest kept rank is <= the
    threshold nothing filterable was lost; otherwise (e.g. a fresh sketch,
    min(regs)=0) fall back to the full scatter.
    """
    idx, rank = bucket_rank(h, p)
    rank = jnp.where(valid, rank, 0)
    return update_from_idx_rank(regs, idx, rank, cap=cap)


# Threshold-refresh granularity: within one update call, the filter
# threshold min(regs) is recomputed every _BLOCK_ROWS compaction rows
# (in-jit refresh gets the small-block threshold without extra
# dispatches).  Chosen on the previous target; not tuned for the H100
# (ROADMAP S2, S6).
_BLOCK_ROWS = 128


def _update_slab(regs: jnp.ndarray, idx2: jnp.ndarray, rank2: jnp.ndarray,
                 cap: int, shift: int) -> jnp.ndarray:
    """One threshold epoch: filter a (R, row) slab against min(regs).

    Cascaded compaction: top_k at `cap`; a slab whose smallest kept rank
    still beats the threshold (i.e. survivors may have been dropped)
    escalates to a 4x-cap top_k, and only a second overflow falls back to
    the exact full scatter.  Exactness is preserved at every tier —
    escalation is a perf ramp for underestimated caps, which minimum-
    statistics of the register threshold make routine near cap shrinks."""
    t = regs.min()
    key = (rank2 << shift) | jax.lax.broadcasted_iota(jnp.int32, rank2.shape, 1)
    row = rank2.shape[1]

    def compact(args, k):
        regs, idx2, rank2 = args
        vals, pos = jax.lax.top_k(key, k)
        kept_rank = vals >> shift
        keep = kept_rank > t
        sidx = jnp.where(keep, jnp.take_along_axis(idx2, pos, axis=1), 0)
        srank = jnp.where(keep, kept_rank, 0)
        overflow = (kept_rank[:, -1] > t).any()
        return overflow, sidx, srank

    def full(args):
        regs, idx2, rank2 = args
        return regs.at[idx2.reshape(-1)].max(rank2.reshape(-1), mode="drop")

    def scatter(regs, sidx, srank):
        return regs.at[sidx.reshape(-1)].max(srank.reshape(-1), mode="drop")

    def tier2(args):
        regs = args[0]
        if 4 * cap >= row:
            return full(args)
        ov2, sidx2, srank2 = compact(args, 4 * cap)
        return jax.lax.cond(
            ~ov2, lambda a: scatter(a[0], sidx2, srank2), full, args)

    args = (regs, idx2, rank2)
    ov1, sidx, srank = compact(args, cap)
    return jax.lax.cond(
        ~ov1, lambda a: scatter(a[0], sidx, srank), tier2, args)


@functools.partial(jax.jit, static_argnames=("row", "cap"))
def update_from_idx_rank(regs: jnp.ndarray, idx: jnp.ndarray,
                         rank: jnp.ndarray, row: int = _ROW,
                         cap: int = _CAPR) -> jnp.ndarray:
    """Core of the filtered update; idx/rank any shape (invalid: rank 0)."""
    shift = row.bit_length() - 1
    assert 1 << shift == row, row
    flat_idx = idx.reshape(-1)
    flat_rank = rank.reshape(-1)
    B = flat_idx.shape[0]
    if B % row != 0:
        pad = row - B % row
        flat_idx = jnp.pad(flat_idx, (0, pad))
        flat_rank = jnp.pad(flat_rank, (0, pad))
        B += pad
    R = B // row
    if R > _BLOCK_ROWS:
        # full blocks get the per-_BLOCK_ROWS threshold refresh; the
        # remainder runs as its own slab (previously any R not divisible
        # by 128 fell through to ONE whole-batch slab with a stale
        # min-register threshold — overflow/escalation territory).
        # Registers are bitwise-independent of the split: the filter
        # only ever skips updates that cannot change a register.
        nb = R // _BLOCK_ROWS
        main = nb * _BLOCK_ROWS
        idx3 = flat_idx[:main * row].reshape(nb, _BLOCK_ROWS, row)
        rank3 = flat_rank[:main * row].reshape(nb, _BLOCK_ROWS, row)

        def body(i, regs):
            return _update_slab(regs, idx3[i], rank3[i], cap, shift)

        regs = jax.lax.fori_loop(0, nb, body, regs)
        rem = R - main
        if rem == 0:
            return regs
        return _update_slab(regs, flat_idx[main * row:].reshape(rem, row),
                            flat_rank[main * row:].reshape(rem, row),
                            cap, shift)
    return _update_slab(regs, flat_idx.reshape(R, row),
                        flat_rank.reshape(R, row), cap, shift)


@functools.partial(jax.jit, static_argnames=("p", "max_rank"))
def update_registers_matmul(regs: jnp.ndarray, h: U64, valid: jnp.ndarray,
                            p: int, max_rank: int = 40) -> jnp.ndarray:
    """Matmul path.  counts[j, r] = #hashes in bucket j with rank >= r computed
    as onehot(idx)^T @ indicator(rank >= r); register = #levels with count>0.

    Ranks above `max_rank` occur with probability 2^-max_rank per k-mer; they
    are clamped, which for max_rank=40 changes an estimate only beyond ~1e12
    distinct elements per bucket.  Accuracy-critical callers use the scatter
    path; this one trades the scatter for dense matrix products.
    """
    m = regs.shape[0]
    idx, rank = bucket_rank(h, p)
    q1 = min(64 - p + 1, max_rank)
    rank = jnp.minimum(jnp.where(valid, rank, 0), q1)
    flat_idx = idx.reshape(-1)
    flat_rank = rank.reshape(-1)
    onehot = (flat_idx[:, None] == jnp.arange(m, dtype=jnp.int32)[None, :])
    ind = (flat_rank[:, None] >= jnp.arange(1, q1 + 1, dtype=jnp.int32)[None, :])
    counts = jax.lax.dot_general(
        onehot.astype(jnp.bfloat16), ind.astype(jnp.bfloat16),
        dimension_numbers=(((0,), (0,)), ((), ())),
        preferred_element_type=jnp.float32)          # (m, q1)
    new = (counts > 0).astype(jnp.int32).sum(-1)
    return jnp.maximum(regs, new)
