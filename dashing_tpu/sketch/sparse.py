"""Sparse HLL queries: tiny sketches vs a dense reference, without 2^p work.

Device rebuild of the reference's sparse read-filtering path
(sparse::SparseHLL + sparse::pair_query, used at reference
src/readfilt.cpp:68-76,102-110): a short read occupies only ~L of the
reference sketch's 2^p buckets, so its joint-MLE sufficient statistics can
be derived from the dense sketch's PRECOMPUTED register histogram plus a
correction at just the occupied buckets — O(L) per read instead of O(2^p).

The reference does this one read at a time with a std::map.  Here a batch of
reads is processed as fixed-shape arrays: per-read (bucket, rank) streams
are lexicographically sorted so each bucket's max rank sits at the end of
its run (the dedup the std::map did), the dense registers are gathered at
those buckets, and the five Ertl pair histograms are assembled as base
histograms + one-hot corrections.  The whole batch then runs the vectorized
joint MLE (sketch/estimators.py).

Derivation of the corrections: with the query register a_j = 0 everywhere,
the pair histograms against dense registers b are (bins = register values):

    gt_a = 0                 lt_a[0] = m - C_B[0]      gt_b[k>0] = C_B[k]
    lt_b = 0                 eq[0]   = C_B[0]          hist_a[0] = m
    hist_u = C_B

An occupied bucket (a > 0, b) replaces its a=0 contribution with the true
one; the delta depends only on (a, b), so a one-hot contraction over the
<= q+2 bins accumulates all corrections in one pass.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import estimators as est
from .hll import HLL


# ---------------------------------------------------------------------------
# Batched sparse pair statistics (device)
# ---------------------------------------------------------------------------

def _onehot_accum(bins: jnp.ndarray, delta: jnp.ndarray, nbins: int
                  ) -> jnp.ndarray:
    """(B, L) bins x (B, L) deltas -> (B, nbins) sums as one einsum.  The
    operands are 0/1 and 0/+-1, exact even where an f32 matmul runs in
    TF32, and the sums accumulate in f32 (exact below 2^24)."""
    oh = (bins[..., None] == jnp.arange(nbins, dtype=bins.dtype))
    return jnp.einsum("blc,bl->bc", oh.astype(jnp.float32),
                      delta.astype(jnp.float32))


def _onehot_accum_multi(bins: jnp.ndarray, deltas, nbins: int) -> jnp.ndarray:
    """(B, L) bins x D delta planes -> (B, D, nbins): ONE one-hot
    materialization serves every plane (the per-plane form re-read the
    (B, L, nbins) one-hot per statistic — the readfilt engine's dominant
    HBM traffic)."""
    oh = (bins[..., None] == jnp.arange(nbins, dtype=bins.dtype))
    d = jnp.stack([x.astype(jnp.float32) for x in deltas], axis=-1)
    return jnp.einsum("blc,bld->bdc", oh.astype(jnp.float32), d)


@functools.partial(jax.jit, static_argnames=("p", "kbins"))
def sparse_pair_stats(idx: jnp.ndarray, rank: jnp.ndarray,
                      ref_regs: jnp.ndarray, ref_hist: jnp.ndarray,
                      p: int, kbins: int = 0) -> Dict[str, jnp.ndarray]:
    """Joint-MLE sufficient statistics for a batch of sparse queries.

    idx:  (B, L) int32 bucket indices of each query's k-mers
    rank: (B, L) int32 ranks; 0 marks padding/invalid slots
    ref_regs: (2^p,) int32 dense reference registers
    ref_hist: (kbins,) float32 histogram of ref_regs (precomputed once)

    `kbins` windows the level axis to [0, kbins) — EXACT when every
    query rank and reference register is < kbins (real registers occupy
    ~log2(cardinality) levels, so kbins ~ half of q+2 and the Newton cost
    halves; the caller picks it from the observed maxima).  kbins=0 means
    the full q+2 bins.

    Returns the stats dict consumed by estimators.joint_mle, all (B, kbins).
    """
    m = 1 << p
    q = 64 - p
    nbins = kbins if kbins else q + 2
    B, L = idx.shape

    # Sort each row by (idx, rank); invalid slots get idx=m so they sort last.
    sidx = jnp.where(rank > 0, idx, m)
    sidx, srank = jax.lax.sort((sidx, rank), num_keys=2)
    # A bucket's max rank is the last slot of its run.
    nxt = jnp.concatenate([sidx[:, 1:], jnp.full((B, 1), -1, sidx.dtype)],
                          axis=1)
    keep = (srank > 0) & (sidx != nxt)

    a = jnp.where(keep, srank, 0)
    b = jnp.where(keep, ref_regs[jnp.clip(sidx, 0, m - 1)], 0)
    kf = keep.astype(jnp.float32)

    zeros = jnp.zeros((B, nbins), jnp.float32)
    base_hist_b = jnp.broadcast_to(ref_hist, (B, nbins))
    base_lt_a = zeros.at[:, 0].set(m - ref_hist[0])
    base_gt_b = jnp.broadcast_to(ref_hist, (B, nbins)).at[:, 0].set(0.0)
    base_eq = zeros.at[:, 0].set(ref_hist[0])
    base_hist_a = zeros.at[:, 0].set(float(m))

    agtb = (a > b) & keep
    altb = (a < b) & keep
    aeqb = (a == b) & keep
    b_pos = (b > 0) & keep
    b_zero = (b == 0) & keep

    f = lambda c: c.astype(jnp.float32)
    # grouped by bin array: one one-hot materialization per array (the
    # per-statistic form cost 7 full (B, L, nbins) passes); the
    # zeros_like-binned corrections are just bin-0 row sums
    A = _onehot_accum_multi(a, (agtb, altb, aeqb, kf), nbins)
    Bm = _onehot_accum_multi(b, (agtb, f(altb) - f(b_pos)), nbins)
    U = _onehot_accum(jnp.maximum(a, b), f(agtb), nbins)
    at0 = lambda base, corr: base.at[:, 0].add(-corr.astype(jnp.float32
                                                           ).sum(-1))
    gt_a = A[:, 0]
    lt_b = Bm[:, 0]
    lt_a = at0(base_lt_a + A[:, 1], b_pos)
    gt_b = base_gt_b + Bm[:, 1]
    eq = at0(base_eq + A[:, 2], b_zero)
    hist_a = at0(base_hist_a + A[:, 3], kf)
    hist_u = base_hist_b + U - Bm[:, 0]

    return dict(gt_a=gt_a, lt_a=lt_a, gt_b=gt_b, lt_b=lt_b, eq=eq,
                hist_a=hist_a, hist_b=base_hist_b, hist_u=hist_u)


@functools.partial(jax.jit, static_argnames=("p", "kbins"))
def sparse_joint_triples(idx: jnp.ndarray, rank: jnp.ndarray,
                         ref_regs: jnp.ndarray, ref_hist: jnp.ndarray,
                         p: int, kbins: int = 0) -> jnp.ndarray:
    """(B, 3) joint-MLE triples (onlyQ, onlyRef, shared) for a sparse batch.

    The batched replacement for the reference's per-read
    `sparse::pair_query(rmap, hll, &hllhist)` (readfilt.cpp:103).
    `kbins` as in sparse_pair_stats (level window [0, kbins))."""
    stats = sparse_pair_stats(idx, rank, ref_regs, ref_hist, p, kbins)
    # the reference histogram is the SAME for every read of the batch:
    # solve its cardinality once and broadcast, instead of B identical
    # 12-iteration windowed-MLE solves inside the vmap (the same
    # per-pair-recomputation redundancy the all-pairs engine avoids via
    # joint_mle's cards parameter)
    c_b = est.mle_estimate_windowed(stats["hist_b"][0], p, 0)

    def one(s):
        cards = (est.mle_estimate_windowed(s["hist_a"], p, 0), c_b,
                 est.mle_estimate_windowed(s["hist_u"], p, 0))
        return est.joint_mle(s, p, cards=cards)

    return jax.vmap(one)(stats)


def level_window_bins(max_rank: int, q: int) -> int:
    """Static bin count for a sparse batch: the observed max level + slack,
    rounded up to a multiple of 8 (bounds the jit-variant count), capped
    at the full q+2."""
    return min(((max_rank + 2 + 7) // 8) * 8, q + 2)


# ---------------------------------------------------------------------------
# SparseHLL: the host-side object (parity with sketch/sparse.h's SparseHLL)
# ---------------------------------------------------------------------------

class SparseHLL:
    """An HLL stored as sorted (bucket, rank) pairs — only occupied buckets.

    Useful when the element count is far below 2^p (short reads queried
    against genome sketches).  Comparisons against a dense HLL run in
    O(occupied) via the histogram-correction trick above.
    """

    def __init__(self, p: int, idx: Optional[np.ndarray] = None,
                 rank: Optional[np.ndarray] = None):
        if not (4 <= p <= 26):
            # same guard as the reference (readfilt.cpp:70)
            raise ValueError("sparse representation supports p in [4, 26]")
        self.p = int(p)
        self.idx = np.zeros(0, np.int32) if idx is None else idx
        self.rank = np.zeros(0, np.int32) if rank is None else rank

    @classmethod
    def from_hashes(cls, hashes: np.ndarray, p: int) -> "SparseHLL":
        """Pre-hashed u64 values -> sparse sketch (host)."""
        hashes = np.asarray(hashes, np.uint64)
        tmp = HLL(p)
        tmp.add_np(hashes)
        occ = np.nonzero(tmp.regs)[0]
        return cls(p, occ.astype(np.int32),
                   tmp.regs[occ].astype(np.int32))

    @property
    def m(self) -> int:
        return 1 << self.p

    def to_dense(self) -> HLL:
        out = HLL(self.p)
        out.regs[self.idx] = np.asarray(self.rank, np.uint8)
        return out

    def pair_query(self, ref: HLL,
                   ref_hist: Optional[np.ndarray] = None
                   ) -> Tuple[float, float, float]:
        """(onlySelf, onlyRef, shared) joint-MLE triple vs a dense HLL."""
        if ref.p != self.p:
            raise ValueError("precision mismatch")
        hist = ref.histogram() if ref_hist is None else ref_hist
        # pad to the next power of two: sparse_joint_triples is shape-jitted
        # and device compiles are expensive, so bound the compiled-shape count
        L = 8
        while L < len(self.idx):
            L *= 2
        idx = np.zeros((1, L), np.int32)
        rank = np.zeros((1, L), np.int32)
        idx[0, :len(self.idx)] = self.idx
        rank[0, :len(self.rank)] = self.rank
        kb = level_window_bins(
            max(int(np.max(self.rank, initial=0)),
                int(np.max(ref.regs, initial=0))), 64 - self.p)
        tri = sparse_joint_triples(jnp.asarray(idx), jnp.asarray(rank),
                                   jnp.asarray(ref.regs.astype(np.int32)),
                                   jnp.asarray(np.asarray(hist,
                                                          np.float32)[:kb]),
                                   self.p, kb)
        a, b, x = np.asarray(tri)[0]
        return float(a), float(b), float(x)
