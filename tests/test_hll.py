import gzip
import io

import numpy as np
import jax.numpy as jnp
import pytest

from dashing_tpu import u64
from dashing_tpu.hashes import wang_hash_np
from dashing_tpu.ops import hll_update
from dashing_tpu.sketch import estimators as est
from dashing_tpu.sketch.hll import HLL, ertl_joint


def _rand_hashes(rng, n):
    return rng.integers(0, 2 ** 63, size=n, dtype=np.uint64) << np.uint64(1)


def _fill(p, values, estim=est.ERTL_MLE, jestim=est.ERTL_MLE):
    h = HLL(p, estim, jestim)
    h.addh_np(np.asarray(values, np.uint64))
    return h


def test_device_scatter_matches_host(rng):
    p = 12
    vals = rng.integers(0, 2**63, 20000, dtype=np.uint64)
    hashes = wang_hash_np(vals)
    host = HLL(p)
    host.add_np(hashes)
    dev = HLL(p)
    hh = u64.from_np(hashes)
    dev.add_device(hh, jnp.ones(hashes.shape, bool), backend="scatter")
    assert (host.regs == dev.regs).all()


def test_device_matmul_matches_host(rng):
    p = 10
    vals = rng.integers(0, 2**63, 4096, dtype=np.uint64)
    hashes = wang_hash_np(vals)
    host = HLL(p)
    host.add_np(hashes)
    dev = HLL(p)
    dev.add_device(u64.from_np(hashes), jnp.ones(hashes.shape, bool),
                   backend="matmul")
    assert (host.regs == dev.regs).all()


def test_invalid_lanes_ignored(rng):
    p = 10
    hashes = wang_hash_np(rng.integers(0, 2**63, 1000, dtype=np.uint64))
    valid = np.zeros(1000, bool)
    valid[:500] = True
    dev = HLL(p)
    dev.add_device(u64.from_np(hashes), jnp.asarray(valid))
    host = HLL(p)
    host.add_np(hashes[:500])
    assert (host.regs == dev.regs).all()


@pytest.mark.parametrize("method", [est.ORIGINAL, est.ERTL_IMPROVED, est.ERTL_MLE])
@pytest.mark.parametrize("n", [100, 10_000, 1_000_000])
def test_cardinality_accuracy(rng, method, n):
    p = 14
    h = _fill(p, rng.integers(0, 2**63, n, dtype=np.uint64), estim=method)
    got = h.report()
    # expected relative error ~ 1.04/sqrt(2^14) ~ 0.8%; allow 5 sigma
    rel = abs(got - n) / n
    assert rel < 0.05, (method, n, got)


def test_mle_matches_numpy_reference(rng):
    p = 12
    for n in [50, 5000, 200_000]:
        h = _fill(p, rng.integers(0, 2**63, n, dtype=np.uint64))
        want = est.mle_estimate_np(h.histogram(), p)
        got = float(est.mle_estimate(jnp.asarray(h.histogram()), p))
        assert abs(got - want) / want < 1e-3, (n, got, want)


def test_empty_and_degenerate():
    h = HLL(10)
    assert h.report() == 0.0
    h2 = HLL(10)
    h2.addh_np(np.arange(5, dtype=np.uint64))
    assert 1 <= h2.report() <= 10


def test_merge_is_union(rng):
    p = 12
    a_vals = rng.integers(0, 2**62, 30000, dtype=np.uint64)
    b_vals = rng.integers(0, 2**62, 30000, dtype=np.uint64)
    a = _fill(p, a_vals)
    b = _fill(p, b_vals)
    ab = _fill(p, np.concatenate([a_vals, b_vals]))
    a += b
    assert (a.regs == ab.regs).all()


def test_fold_matches_direct(rng):
    vals = rng.integers(0, 2**63, 50000, dtype=np.uint64)
    big = _fill(14, vals)
    small_direct = _fill(11, vals)
    folded = big.compress(11)
    assert (folded.regs == small_direct.regs).all()


def test_jaccard_vs_truth(rng):
    p = 14
    n = 40000
    shared = rng.integers(0, 2**62, n, dtype=np.uint64)
    only_a = rng.integers(2**62, 2**63, n, dtype=np.uint64)
    only_b = rng.integers(2**63, 2**64 - 1, n, dtype=np.uint64)
    a = _fill(p, np.concatenate([shared, only_a]))
    b = _fill(p, np.concatenate([shared, only_b]))
    true_ji = n / (3 * n)
    ji = a.jaccard_index(b)
    assert abs(ji - true_ji) / true_ji < 0.08, ji


def test_joint_mle_triple(rng):
    p = 14
    n = 30000
    shared = rng.integers(0, 2**62, n, dtype=np.uint64)
    only_a = rng.integers(2**62, 2**63, 2 * n, dtype=np.uint64)
    only_b = rng.integers(2**63, 2**64 - 1, n // 2, dtype=np.uint64)
    a = _fill(p, np.concatenate([shared, only_a]), jestim=est.ERTL_JOINT_MLE)
    b = _fill(p, np.concatenate([shared, only_b]), jestim=est.ERTL_JOINT_MLE)
    oa, ob, x = a.full_set_comparison(b)
    assert abs(x - n) / n < 0.1, (oa, ob, x)
    assert abs(oa - 2 * n) / (2 * n) < 0.1, (oa, ob, x)
    assert abs(ob - n / 2) / (n / 2) < 0.15, (oa, ob, x)


def test_joint_mle_disjoint(rng):
    p = 12
    a = _fill(p, rng.integers(0, 2**61, 20000, dtype=np.uint64),
              jestim=est.ERTL_JOINT_MLE)
    b = _fill(p, rng.integers(2**63, 2**64 - 1, 20000, dtype=np.uint64),
              jestim=est.ERTL_JOINT_MLE)
    _, _, x = a.full_set_comparison(b)
    # disjoint sets: shared should be a small fraction of either set
    assert x < 2000, x
    assert a.jaccard_index(b) < 0.05


def test_joint_mle_identical(rng):
    p = 12
    vals = rng.integers(0, 2**63, 20000, dtype=np.uint64)
    a = _fill(p, vals, jestim=est.ERTL_JOINT_MLE)
    b = _fill(p, vals, jestim=est.ERTL_JOINT_MLE)
    assert a.jaccard_index(b) > 0.95
    tri = ertl_joint(a, b)
    assert tri[2] > 0.9 * 20000


def test_serialization_roundtrip(rng, tmp_path):
    h = _fill(12, rng.integers(0, 2**63, 5000, dtype=np.uint64))
    path = str(tmp_path / "x.hll")
    h.write(path)
    back = HLL.read(path)
    assert back.p == h.p and (back.regs == h.regs).all()
    # streamed records in one gz stream
    buf = io.BytesIO()
    with gzip.GzipFile(fileobj=buf, mode="wb") as fp:
        h.write_record(fp)
        h.compress(10).write_record(fp)
    buf.seek(0)
    with gzip.GzipFile(fileobj=buf, mode="rb") as fp:
        r1 = HLL.read_record(fp)
        r2 = HLL.read_record(fp)
        with pytest.raises(EOFError):
            HLL.read_record(fp)
    assert r1.p == 12 and r2.p == 10


def test_truncated_file_raises(tmp_path):
    path = str(tmp_path / "t.hll")
    h = HLL(10)
    h.write(path)
    raw = gzip.open(path, "rb").read()
    with gzip.open(path, "wb") as fp:
        fp.write(raw[:100])
    with pytest.raises(EOFError):
        HLL.read(path)


def test_union_size_consistency(rng):
    p = 13
    va = rng.integers(0, 2**62, 25000, dtype=np.uint64)
    vb = rng.integers(2**61, 2**63, 25000, dtype=np.uint64)
    a, b = _fill(p, va), _fill(p, vb)
    u = a.union_size(b)
    direct = _fill(p, np.concatenate([va, vb])).report()
    assert abs(u - direct) / direct < 1e-6


def test_filtered_update_matches_plain(rng):
    import jax.numpy as jnp
    from dashing_tpu.ops.hll_update import (update_registers,
                                            update_registers_filtered)
    p = 10
    regs_a = jnp.zeros(1 << p, jnp.int32)
    regs_b = jnp.zeros(1 << p, jnp.int32)
    # several chunks: first hits the full-scatter fallback (min reg = 0),
    # later chunks exercise the filtered path
    for chunk in range(4):
        hashes = wang_hash_np(
            rng.integers(0, 2**63, 50000, dtype=np.uint64))
        valid = rng.random(50000) < 0.9
        hh = u64.from_np(hashes)
        vv = jnp.asarray(valid)
        regs_a = update_registers(regs_a, hh, vv, p)
        regs_b = update_registers_filtered(regs_b, hh, vv, p)
    assert (np.asarray(regs_a) == np.asarray(regs_b)).all()


def test_filtered_update_fresh_and_ragged(rng):
    import jax.numpy as jnp
    from dashing_tpu.ops.hll_update import (update_registers,
                                            update_registers_filtered)
    # fresh sketch (threshold 0 -> overflow fallback) + non-multiple-of-row
    # batch size exercising the padding path
    p = 8
    hashes = wang_hash_np(rng.integers(0, 2**63, 5001, dtype=np.uint64))
    hh = u64.from_np(hashes)
    vv = jnp.ones(5001, bool)
    a = update_registers(jnp.zeros(1 << p, jnp.int32), hh, vv, p)
    b = update_registers_filtered(jnp.zeros(1 << p, jnp.int32), hh, vv, p)
    assert (np.asarray(a) == np.asarray(b)).all()


def test_joint_grad_hess_match_finite_differences(rng):
    """The hand-derived gradient/Hessian must match float64 central
    differences of the likelihood (autodiff of _joint_logl is nan-poisoned
    by the z_{-1}=inf sentinel lane, so this is THE correctness check)."""
    import jax
    import jax.numpy as jnp
    p = 10
    q = 64 - p
    m = float(1 << p)
    common = _rand_hashes(rng, 5000)
    a, b = HLL(p), HLL(p)
    a.add_np(np.concatenate([common, _rand_hashes(rng, 3000)]))
    b.add_np(np.concatenate([common, _rand_hashes(rng, 1500)]))
    stats = est.pair_statistics(jnp.asarray(a.regs.astype(np.int32)),
                                jnp.asarray(b.regs.astype(np.int32)), q)
    th32 = np.log(np.array([3000.0, 1500.0, 5000.0], np.float32))
    v, g, H = est._joint_val_grad_hess(jnp.asarray(th32), stats, m, q)
    assert np.isfinite(float(v))
    assert np.isfinite(np.asarray(g)).all()
    assert np.isfinite(np.asarray(H)).all()
    # f32 finite differences are noisy; check gradient loosely and the
    # Hessian's diagonal sign/scale
    eps = 1e-2
    for i in range(3):
        e = np.zeros(3, np.float32)
        e[i] = eps
        v1, _, _ = est._joint_val_grad_hess(jnp.asarray(th32 + e), stats, m, q)
        v0, _, _ = est._joint_val_grad_hess(jnp.asarray(th32 - e), stats, m, q)
        g_num = (float(v1) - float(v0)) / (2 * eps)
        assert abs(float(g[i]) - g_num) < max(0.05 * abs(g_num), 2.0), (i, float(g[i]), g_num)
    assert (np.diag(np.asarray(H)) < 0).all()


def test_joint_mle_improves_likelihood(rng):
    """The Newton loop must genuinely move uphill from the inclusion-
    exclusion init (it silently failed to move before the analytic
    grad/Hessian fix)."""
    import jax.numpy as jnp
    p = 10
    q = 64 - p
    m = float(1 << p)
    common = _rand_hashes(rng, 8000)
    a, b = HLL(p), HLL(p)
    a.add_np(np.concatenate([common, _rand_hashes(rng, 6000)]))
    b.add_np(np.concatenate([common, _rand_hashes(rng, 2000)]))
    stats = est.pair_statistics(jnp.asarray(a.regs.astype(np.int32)),
                                jnp.asarray(b.regs.astype(np.int32)), q)
    c_a = float(est.mle_estimate(stats["hist_a"], p))
    c_b = float(est.mle_estimate(stats["hist_b"], p))
    c_u = float(est.mle_estimate(stats["hist_u"], p))
    init = np.log(np.maximum([c_u - c_b, c_u - c_a, c_a + c_b - c_u], 1e-3))
    v_init = float(est._joint_logl(jnp.asarray(init, jnp.float32), stats, m, q))
    tri = np.asarray(est.joint_mle(stats, p))
    v_opt = float(est._joint_logl(jnp.asarray(np.log(np.maximum(tri, 1e-9)),
                                              jnp.float32), stats, m, q))
    assert np.isfinite(v_init) and np.isfinite(v_opt)
    assert v_opt >= v_init - 1e-3      # moved uphill (or started optimal)
    # it must move WHEN the init is demonstrably suboptimal (nonzero
    # gradient); a near-optimal init is legitimately allowed to stay put
    import jax.numpy as _j
    _, g, _ = est._joint_val_grad_hess(
        _j.asarray(init, _j.float32), stats, m, 64 - p)
    moved = np.abs(np.log(np.maximum(tri, 1e-9)) - init).max() > 1e-5
    assert moved or float(np.abs(np.asarray(g)).max()) < 1.0


def test_filtered_update_cascade_tiers(rng):
    """The cascaded compaction (cap -> 4x cap -> full scatter) must be
    bitwise exact in every tier: drive slabs whose survivor counts sit
    below cap, between cap and 4x cap, and above 4x cap."""
    import jax.numpy as jnp
    from dashing_tpu.ops.hll_update import update_from_idx_rank
    m = 1 << 10
    n = 4096
    idx = rng.integers(0, m, n).astype(np.int32)
    for base, cap in [(0, 16),      # cold registers: full-scatter tier
                      (6, 16),      # mid: escalation tier
                      (12, 16)]:    # warm: small tier
        regs0 = (base + rng.integers(0, 3, m)).astype(np.int32)
        rank = np.minimum(1 + rng.geometric(0.5, n), 40).astype(np.int32)
        got = np.asarray(update_from_idx_rank(
            jnp.asarray(regs0), jnp.asarray(idx), jnp.asarray(rank),
            row=512, cap=cap))
        want = regs0.copy()
        np.maximum.at(want, idx, rank)
        np.testing.assert_array_equal(got, want, err_msg=f"base={base}")


def test_grad_hess_twins_agree(rng):
    """The XLA Newton loop runs the value-FREE _joint_grad_hess; the
    float64 finite-difference oracle validates the val-bearing twin.
    Pin them together bitwise so an edit to the load-bearing analytic
    Hessian applied to one twin fails loudly."""
    import jax.numpy as jnp
    from dashing_tpu.sketch import estimators as est
    p = 12
    q = 64 - p
    a = HLL(p)
    a.addh_np(rng.integers(0, 2**62, 40_000, dtype=np.uint64))
    b = HLL(p)
    b.addh_np(rng.integers(0, 2**62, 25_000, dtype=np.uint64))
    stats32 = est.pair_statistics(jnp.asarray(a.regs.astype(np.int32)),
                                  jnp.asarray(b.regs.astype(np.int32)), q)
    m = float(1 << p)
    for theta in ([10.0, 9.5, 8.0], [2.0, 12.0, 1.0], [7.7, 7.7, 7.7]):
        th = jnp.asarray(theta, jnp.float32)
        _, g_val, H_val = est._joint_val_grad_hess(th, stats32, m, q)
        g, H = est._joint_grad_hess(th, stats32, m, q)
        np.testing.assert_array_equal(np.asarray(g), np.asarray(g_val))
        np.testing.assert_array_equal(np.asarray(H), np.asarray(H_val))


