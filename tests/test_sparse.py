"""SparseHLL: sparse-vs-dense queries must match the dense joint MLE.

Covers the device rebuild of sparse::pair_query (reference
src/readfilt.cpp:68-76,102-110): the histogram-correction statistics must
equal the ones computed from materialized dense registers, bin for bin.
"""
import numpy as np
import jax.numpy as jnp
import pytest

from dashing_tpu.sketch import estimators as est
from dashing_tpu.sketch.hll import HLL, ertl_joint
from dashing_tpu.sketch.sparse import (SparseHLL, sparse_pair_stats,
                                       sparse_joint_triples)


def _random_hashes(rng, n):
    return rng.integers(0, 2 ** 63, size=n, dtype=np.uint64) << np.uint64(1)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _idx_rank(hashes, p):
    h = np.asarray(hashes, np.uint64)
    idx = (h >> np.uint64(64 - p)).astype(np.int32)
    # per-hash rank (not deduped): rebuild via single-element inserts
    ranks = np.zeros(len(h), np.int32)
    for i, v in enumerate(h):
        one = HLL(p)
        one.add_np(np.array([v], np.uint64))
        ranks[i] = one.regs[idx[i]]
    return idx, ranks


def test_sparse_stats_match_dense(rng):
    p = 10
    q = 64 - p
    ref = HLL(p)
    ref.add_np(_random_hashes(rng, 4000))
    ref_hist = ref.histogram()

    B, L = 4, 64
    idxs = np.zeros((B, L), np.int32)
    ranks = np.zeros((B, L), np.int32)
    dense_stats = []
    for r in range(B):
        # row 0 exercises FULL capacity (no rank-0 padding at all)
        hs = _random_hashes(rng, L if r == 0 else int(rng.integers(3, L + 1)))
        idx, rank = _idx_rank(hs, p)
        idxs[r, :len(idx)] = idx
        ranks[r, :len(rank)] = rank
        qd = HLL(p)
        qd.add_np(hs)
        dense_stats.append(est.pair_statistics(
            jnp.asarray(qd.regs.astype(np.int32)),
            jnp.asarray(ref.regs.astype(np.int32)), q))

    sp = sparse_pair_stats(jnp.asarray(idxs), jnp.asarray(ranks),
                           jnp.asarray(ref.regs.astype(np.int32)),
                           jnp.asarray(ref_hist), p)
    for key in ("gt_a", "lt_a", "gt_b", "lt_b", "eq",
                "hist_a", "hist_b", "hist_u"):
        got = np.asarray(sp[key])
        for r in range(B):
            want = np.asarray(dense_stats[r][key])
            np.testing.assert_array_equal(
                got[r], want, err_msg=f"{key} row {r}")


def test_sparse_triples_match_ertl_joint(rng):
    p = 12
    ref = HLL(p)
    ref.add_np(_random_hashes(rng, 20000))
    hs = _random_hashes(rng, 40)
    qd = HLL(p)
    qd.add_np(hs)
    want = np.asarray(ertl_joint(qd, ref))

    s = SparseHLL.from_hashes(hs, p)
    got = np.asarray(s.pair_query(ref))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_sparse_from_hashes_to_dense(rng):
    p = 8
    hs = _random_hashes(rng, 100)
    dense = HLL(p)
    dense.add_np(hs)
    s = SparseHLL.from_hashes(hs, p)
    np.testing.assert_array_equal(s.to_dense().regs, dense.regs)
    assert len(s.idx) == int((dense.regs > 0).sum())


def test_sparse_empty_query(rng):
    p = 8
    ref = HLL(p)
    ref.add_np(_random_hashes(rng, 500))
    s = SparseHLL(p)
    a, b, x = s.pair_query(ref)
    assert a == 0.0 and x == 0.0
    assert b > 0


def test_sparse_p_guard():
    with pytest.raises(ValueError):
        SparseHLL(30)


def test_windowed_sparse_matches_full(rng):
    """The level-windowed sparse JMLE must equal the full-bin result when
    the window covers every observed level (it always does — kbins comes
    from the observed maxima)."""
    import jax.numpy as jnp
    from dashing_tpu.sketch.hll import HLL
    from dashing_tpu.sketch.sparse import (level_window_bins,
                                           sparse_joint_triples)
    p = 12
    ref = HLL(p)
    ref.addh_np(rng.integers(0, 2**62, 200_000, dtype=np.uint64))
    hist = ref.histogram()
    B, L = 16, 128
    idx = rng.integers(0, 1 << p, (B, L)).astype(np.int32)
    rank = np.minimum(1 + rng.geometric(0.5, (B, L)), 30).astype(np.int32)
    rank[:, -7:] = 0                     # some padding
    regs = jnp.asarray(ref.regs.astype(np.int32))
    full = np.asarray(sparse_joint_triples(
        jnp.asarray(idx), jnp.asarray(rank), regs, jnp.asarray(hist), p))
    kb = level_window_bins(max(int(rank.max()), int(ref.regs.max())), 64 - p)
    assert kb < 64 - p + 2
    win = np.asarray(sparse_joint_triples(
        jnp.asarray(idx), jnp.asarray(rank), regs,
        jnp.asarray(hist[:kb].astype(np.float32)), p, kb))
    # identical sufficient statistics (asserted exactly below); the tiny
    # residual is f32 reduction-tree rounding — different sum lengths
    # reassociate — so tolerance is absolute at the lambda magnitude scale
    from dashing_tpu.sketch.sparse import sparse_pair_stats
    sf = sparse_pair_stats(jnp.asarray(idx), jnp.asarray(rank), regs,
                           jnp.asarray(hist), p)
    sw = sparse_pair_stats(jnp.asarray(idx), jnp.asarray(rank), regs,
                           jnp.asarray(hist[:kb].astype(np.float32)), p, kb)
    for key in sf:
        np.testing.assert_array_equal(np.asarray(sf[key])[:, :kb],
                                      np.asarray(sw[key]), err_msg=key)
        assert np.abs(np.asarray(sf[key])[:, kb:]).max() == 0.0
    scale = np.abs(full).max()
    np.testing.assert_allclose(win, full, rtol=1e-4, atol=2e-6 * scale)
