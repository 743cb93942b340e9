import numpy as np
import pytest

from dashing_tpu.ops import pairwise as pw
from dashing_tpu.sketch import estimators as est
from dashing_tpu.sketch.hll import HLL


def _mk_sketches(rng, n=6, p=10, pool=20000, per=6000, jestim=est.ERTL_MLE):
    pool_vals = rng.integers(0, 2**63, pool, dtype=np.uint64)
    sketches, sets = [], []
    for _ in range(n):
        take = rng.choice(pool, size=per, replace=False)
        vals = pool_vals[take]
        h = HLL(p, jestim=jestim)
        h.addh_np(vals)
        sketches.append(h)
        sets.append(set(vals.tolist()))
    return sketches, sets


@pytest.mark.parametrize("jestim", [est.ERTL_MLE, est.ERTL_JOINT_MLE])
def test_tile_matches_per_pair(rng, jestim):
    sketches, _ = _mk_sketches(rng, n=5, jestim=jestim)
    regs = np.stack([s.regs for s in sketches]).astype(np.int32)
    block = pw.compare_tile(regs, regs, sketches[0].p, pw.JI, 1 / 21,
                            est.ERTL_MLE, jestim)
    for i in range(5):
        for j in range(5):
            want = sketches[i].jaccard_index(sketches[j])
            assert abs(block[i, j] - want) < 2e-3, (i, j, block[i, j], want)


def test_condensed_layout(rng):
    sketches, _ = _mk_sketches(rng, n=7)
    cond = pw.all_pairs_condensed(sketches, pw.JI, 21, est.ERTL_MLE,
                                  est.ERTL_MLE, tile=3)
    n = len(sketches)
    idx = 0
    for i in range(n):
        for j in range(i + 1, n):
            want = sketches[i].jaccard_index(sketches[j])
            assert abs(cond[idx] - want) < 2e-3, (i, j)
            idx += 1
    assert idx == cond.size


def test_windowed_retries_transient_pull_failure(rng, monkeypatch):
    """A transient JaxRuntimeError pulling one tile must re-dispatch that
    tile (pure compute, idempotent) and produce the identical matrix —
    failure mode: a FAILED_PRECONDITION backend error killing a dist run
    after the sketch phase (SURVEY.md sec 5.3)."""
    import jax
    sketches, _ = _mk_sketches(rng, n=7)
    want = pw.all_pairs_condensed(sketches, pw.JI, 21, est.ERTL_MLE,
                                  est.ERTL_MLE, tile=3)

    real_asarray = np.asarray
    fails = {"n": 2}

    def flaky_asarray(x, *a, **kw):
        if fails["n"] > 0 and hasattr(x, "addressable_shards"):
            fails["n"] -= 1
            raise jax.errors.JaxRuntimeError(
                "FAILED_PRECONDITION: backend error (injected)")
        return real_asarray(x, *a, **kw)

    monkeypatch.setattr("time.sleep", lambda s: None)
    monkeypatch.setattr(pw.np, "asarray", flaky_asarray)
    got = pw.all_pairs_condensed(sketches, pw.JI, 21, est.ERTL_MLE,
                                 est.ERTL_MLE, tile=3)
    monkeypatch.setattr(pw.np, "asarray", real_asarray)
    assert fails["n"] == 0, "failure injection never fired"
    np.testing.assert_array_equal(got, want)


def test_windowed_permanent_failure_raises(monkeypatch):
    """Bounded attempts: a persistent backend error propagates instead of
    looping forever or silently dropping a tile."""
    import jax

    calls = {"n": 0}

    class Boom:
        addressable_shards = ()

    def redo(key):
        calls["n"] += 1
        return Boom()

    real_asarray = np.asarray

    def flaky_asarray(x, *a, **kw):
        if isinstance(x, Boom):
            raise jax.errors.JaxRuntimeError("injected permanent failure")
        return real_asarray(x, *a, **kw)

    monkeypatch.setattr("time.sleep", lambda s: None)
    monkeypatch.setattr(pw.np, "asarray", flaky_asarray)
    with pytest.raises(jax.errors.JaxRuntimeError):
        pw._windowed(iter([((0, 0), Boom())]), lambda k, b: None,
                     redo=redo)
    monkeypatch.setattr(pw.np, "asarray", real_asarray)
    assert calls["n"] == 3


def test_ji_close_to_exact(rng):
    sketches, sets = _mk_sketches(rng, n=4, p=14, pool=30000, per=12000)
    cond = pw.all_pairs_condensed(sketches, pw.JI, 21, est.ERTL_MLE, est.ERTL_MLE)
    idx = 0
    for i in range(4):
        for j in range(i + 1, 4):
            true = len(sets[i] & sets[j]) / len(sets[i] | sets[j])
            assert abs(cond[idx] - true) < 0.05, (i, j, cond[idx], true)
            idx += 1


def test_jmle_close_to_exact(rng):
    sketches, sets = _mk_sketches(rng, n=3, p=14, pool=30000, per=12000,
                                  jestim=est.ERTL_JOINT_MLE)
    cond = pw.all_pairs_condensed(sketches, pw.JI, 21, est.ERTL_MLE,
                                  est.ERTL_JOINT_MLE)
    idx = 0
    for i in range(3):
        for j in range(i + 1, 3):
            true = len(sets[i] & sets[j]) / len(sets[i] | sets[j])
            assert abs(cond[idx] - true) < 0.05, (i, j, cond[idx], true)
            idx += 1


def test_measures_formulas():
    import jax.numpy as jnp
    tri = jnp.asarray([[100.0, 50.0, 50.0]])
    ksinv = 1 / 21
    ji = 50.0 / 200.0
    got_ji = float(pw.measure_from_triples(tri, pw.JI, ksinv)[0])
    assert abs(got_ji - ji) < 1e-6
    mash = -np.log(2 * ji / (1 + ji)) * ksinv
    assert abs(float(pw.measure_from_triples(tri, pw.MASH_DIST, ksinv)[0]) - mash) < 1e-6
    fmash = 1 - (2 * ji / (1 + ji)) ** ksinv
    assert abs(float(pw.measure_from_triples(tri, pw.FULL_MASH_DIST, ksinv)[0]) - fmash) < 1e-6
    assert abs(float(pw.measure_from_triples(tri, pw.SIZES, ksinv)[0]) - 50.0) < 1e-6
    sci = 50.0 / (50.0 + 50.0)
    assert abs(float(pw.measure_from_triples(tri, pw.SYMMETRIC_CONTAINMENT_INDEX, ksinv)[0]) - sci) < 1e-6
    # reference quirk: containment-index == jaccard in dist mode
    assert abs(float(pw.measure_from_triples(tri, pw.CONTAINMENT_INDEX, ksinv)[0]) - ji) < 1e-6
    # zero-ji edge: mash dist = 1.
    tri0 = jnp.asarray([[10.0, 10.0, 0.0]])
    assert float(pw.measure_from_triples(tri0, pw.MASH_DIST, ksinv)[0]) == 1.0


def test_rect_pairs_orientation(rng):
    refs, _ = _mk_sketches(rng, n=4)
    queries, _ = _mk_sketches(rng, n=3)
    out = pw.rect_pairs(refs, queries, pw.JI, 21, est.ERTL_MLE, est.ERTL_MLE)
    assert out.shape == (3, 4)
    for qi in range(3):
        for rj in range(4):
            want = refs[rj].jaccard_index(queries[qi])
            assert abs(out[qi, rj] - want) < 2e-3


def test_full_square(rng):
    sketches, _ = _mk_sketches(rng, n=4)
    sq = pw.full_square(sketches, pw.JI, 21, est.ERTL_MLE, est.ERTL_MLE)
    assert sq.shape == (4, 4)
    assert (np.diag(sq) == 0).all()
    assert np.allclose(sq, sq.T, atol=2e-3)


def test_symmetry_helpers():
    assert pw.is_symmetric(pw.JI) and pw.is_symmetric(pw.MASH_DIST)
    assert not pw.is_symmetric(pw.CONTAINMENT_DIST)
    assert pw.is_similarity(pw.JI) and not pw.is_similarity(pw.MASH_DIST)


@pytest.mark.parametrize("method", [est.ORIGINAL, est.ERTL_IMPROVED,
                                    est.ERTL_MLE])
@pytest.mark.parametrize("kmin,kmax", [(0, 53), (3, 20), (1, 53), (0, 18)])
def test_windowed_estimators_match_full(rng, method, kmin, kmax):
    """estimate_windowed on the [kmin, kmax] slice must equal estimate on
    the full zero-padded histogram whenever all registers fit the window."""
    import jax.numpy as jnp
    p = 12
    q = 64 - p
    vals = rng.integers(max(kmin, 0), kmax + 1, size=(8, 1 << p))
    C = np.stack([np.bincount(v, minlength=q + 2).astype(np.float32)
                  for v in vals])
    full = np.asarray(est.estimate(jnp.asarray(C), p, method))
    win = np.asarray(est.estimate_windowed(
        jnp.asarray(C[:, kmin:kmax + 1]), p, kmin, method))
    np.testing.assert_allclose(win, full, rtol=2e-6)


def test_nn_topk_matches_dense(rng):
    """Streaming top-k (bounded memory, tiled) must reproduce the dense
    full-matrix argsort exactly, incl. tie-break-by-index and the self-
    exclusion sentinel, across similarity and distance measures."""
    from dashing_tpu.sketch.hll import HLL
    p = 10
    n, nn, tile = 50, 5, 16          # multiple tiles + ragged tail
    base = rng.integers(0, 2**62, 3000, dtype=np.uint64)
    sketches = []
    for i in range(n):
        h = HLL(p)
        mix = np.concatenate([base[: 1500 + 17 * i],
                              rng.integers(0, 2**62, 400 + 3 * i,
                                           dtype=np.uint64)])
        h.addh_np(mix)
        sketches.append(h)
    for result_type in (pw.JI, pw.MASH_DIST):
        sim = pw.is_similarity(result_type)
        mat = core_rect(sketches, sketches, result_type)
        for i in range(n):
            mat[i, i] = -np.inf if sim else np.inf
        order = np.argsort(-mat if sim else mat, axis=1,
                           kind="stable")[:, :nn]
        vals = np.take_along_axis(mat, order, axis=1)
        # single tile covering all refs: BITWISE identical to the dense path
        sv, si = pw.nn_topk(sketches, sketches, result_type, 21,
                            est.ERTL_MLE, est.ERTL_MLE, nn,
                            exclude_self=True, tile=256)
        np.testing.assert_array_equal(si, order)
        np.testing.assert_array_equal(sv, vals)
        # multi-tile streaming: values agree to f32 tile-reassociation noise
        # and every picked neighbor is as good as the dense pick
        sv, si = pw.nn_topk(sketches, sketches, result_type, 21,
                            est.ERTL_MLE, est.ERTL_MLE, nn,
                            exclude_self=True, tile=tile)
        np.testing.assert_allclose(sv, vals, atol=2e-6, rtol=1e-5)
        picked = np.take_along_axis(mat, si, axis=1)
        np.testing.assert_allclose(picked, vals, atol=2e-6, rtol=1e-5)
        assert (si != np.arange(n)[:, None]).all()   # self excluded
    # Q x R mode: no self-exclusion; single tile -> exact
    refs, queries = sketches[:30], sketches[30:]
    mat = core_rect(refs, queries, pw.JI)
    order = np.argsort(-mat, axis=1, kind="stable")[:, :nn]
    vals = np.take_along_axis(mat, order, axis=1)
    sv, si = pw.nn_topk(refs, queries, pw.JI, 21, est.ERTL_MLE,
                        est.ERTL_MLE, nn, exclude_self=False, tile=64)
    np.testing.assert_array_equal(si, order)
    np.testing.assert_array_equal(sv, vals)


def core_rect(refs, queries, result_type):
    return pw.rect_pairs(refs, queries, result_type, 21,
                         est.ERTL_MLE, est.ERTL_MLE)


def test_tile_window_invariants():
    """Bucketed windows must always COVER the requested exact window and
    stay within [0, q+1]."""
    q = 50
    for tmin in range(0, q + 2):
        for tmax1 in range(tmin, q + 2):
            kmax, kmin = pw._pair_window((tmin, tmax1), (tmin, tmax1), q)
            assert 0 <= kmin <= tmin
            assert tmax1 <= kmax <= q + 1 or (kmax == q + 1 and tmax1 > q + 1)
            assert (kmax - kmin + 1) in pw._K_BUCKETS or kmax == q + 1


@pytest.mark.parametrize("jestim", [est.ERTL_MLE, est.ERTL_JOINT_MLE])
def test_per_tile_windows_match_full_window(rng, jestim):
    """Tiles whose rows sit at very different register levels (tiny vs huge
    cardinalities) must produce the same measures through the per-tile
    bucketed windows as through the full [0, q+1] window."""
    p = 10
    q = 64 - p
    sketches = []
    for i, per in enumerate([50, 80, 60000, 90000, 300, 70000]):
        h = HLL(p, jestim=jestim)
        h.addh_np(rng.integers(0, 2**63, per, dtype=np.uint64))
        sketches.append(h)
    # tile=2 -> 3 row blocks with wildly different level spans
    cond = pw.all_pairs_condensed(sketches, pw.JI, 21, est.ERTL_MLE,
                                  jestim, tile=2)
    regs = np.stack([s.regs for s in sketches]).astype(np.int32)
    idx = 0
    for i in range(len(sketches)):
        for j in range(i + 1, len(sketches)):
            want = pw.compare_tile(regs[i:i + 1], regs[j:j + 1],
                                   p, pw.JI, 1 / 21, est.ERTL_MLE, jestim,
                                   kmax=q + 1, kmin=0)[0, 0]
            np.testing.assert_allclose(cond[idx], want, rtol=1e-5,
                                       atol=1e-6, err_msg=str((i, j)))
            idx += 1


def test_tile_window_kmin_is_live(rng):
    """Review finding: np.min(initial=0) pinned every per-tile window to
    kmin=0 (min(0, data) == 0 for non-negative registers), silently
    disabling the kmin half of the round-3 window optimization.  The
    block minima must be the TRUE minima, and windowed outputs must match
    full-window outputs to float tolerance."""
    from dashing_tpu.sketch.hll import HLL
    from dashing_tpu.sketch import estimators as est
    regs = rng.integers(5, 17, size=(8, 1 << 10)).astype(np.uint8)
    assert pw._auto_kmin(regs) == int(regs.min()) >= 5
    mm = pw._block_minmax(regs, 8, 4)
    for i0, (lo, hi1) in mm.items():
        blk = regs[i0:i0 + 4]
        assert lo == int(blk.min()) and hi1 == int(blk.max()) + 1
    sketches = [HLL(10, regs=r) for r in regs]
    got = np.asarray(pw.all_pairs_condensed(
        sketches, pw.JI, 21, est.ERTL_MLE, est.ERTL_JOINT_MLE))
    try:
        orig_kmin, orig_bm = pw._auto_kmin, pw._block_minmax
        pw._auto_kmin = lambda r: 0
        pw._block_minmax = lambda r, n, t: {
            i0: (0, int(r[i0:i0 + t].max(initial=0)) + 1)
            for i0 in range(0, n, t)}
        want = np.asarray(pw.all_pairs_condensed(
            sketches, pw.JI, 21, est.ERTL_MLE, est.ERTL_JOINT_MLE))
    finally:
        pw._auto_kmin, pw._block_minmax = orig_kmin, orig_bm
    # widening only adds empty bins; differences are reduction-order float
    # noise, bounded well below any emitted precision (%.6g)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
