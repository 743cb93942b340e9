"""All-pairs sketch comparison as integer matmuls: the flagship kernel.

The reference compares sketches pair-at-a-time in OpenMP loops
(`perform_core_op`, reference src/sketch_and_cmp.h:699-710; `dist_loop`
:786-880; `partdist_loop` src/dashing.h:660-712), each pair running a scalar
Ertl estimator over 2^p registers.  That shape is hostile to an
accelerator, which wants large dense products.

Key identity: every pairwise register statistic the estimators need has the
form  S[i,j] = sum_r f(a[i,r]) * g(b[j,r])  for indicator functions f,g of
the register value — i.e. a DOT PRODUCT over the register axis.  Stacking
the indicator thresholds k = 0..K-1 turns the entire n x n statistics
computation into K batched (n,m)x(m,n) int8 matmuls with int32
accumulation — the dense products accelerators are built for:

    cum_union[i,j,k] = #(max(a,b) <= k) = [a<=k] . [b<=k]
    eq[i,j,k]        = #(a=k & b=k)     = [a==k] . [b==k]
    gt_a[i,j,k]      = #(a=k & a>b)     = [a==k] . [b<=k-1]
    gt_b[i,j,k]      = #(b=k & b>a)     = [b==k] . [a<=k-1]
    (lt_a, lt_b follow by complement against the marginal histograms)

These are the sufficient statistics for union cardinality, inclusion-
exclusion Jaccard, AND the joint MLE (sketch/estimators.py), so one pass
serves every emission type.  The 0/1 indicators are exact in int8 and
the counts accumulate exactly in int32, whatever route XLA picks for the
product.
"""
from __future__ import annotations

import functools
import os
from typing import Dict, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..sketch import estimators as est

# ---------------------------------------------------------------------------
# Statistics kernels
# ---------------------------------------------------------------------------


def _dot(x: jnp.ndarray, y: jnp.ndarray) -> jnp.ndarray:
    """(na, m) . (nb, m)^T indicator contraction.

    int8 inputs with int32 accumulation: exact for 0/1 indicators.  On
    the GPU XLA hands it to cuBLAS (benchmarks/hlo_routes.py)."""
    return jax.lax.dot_general(
        x.astype(jnp.int8), y.astype(jnp.int8),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.int32).astype(jnp.float32)


@functools.partial(jax.jit,
                   static_argnames=("kmin", "kmax", "joint", "same"))
def pair_stats(a: jnp.ndarray, b: jnp.ndarray, kmax: int, joint: bool,
               kmin: int = 0, same: bool = False) -> Dict[str, jnp.ndarray]:
    """Pairwise register statistics for all (i, j).

    a: (na, m) int32 registers; b: (nb, m).  Levels kmin..kmax are resolved;
    exact when kmin <= min register and kmax >= max register (register
    values cluster in ~a dozen levels, so a tight [kmin, kmax] cuts the
    matmul count several-fold).  Returns dict of (na, nb, kmax-kmin+1)
    float32 stacks (+ marginals), tagged with kmin for padding.

    same=True asserts a and b are the SAME register bank (diagonal tiles
    of the all-pairs grid): then Z[k] = Y[k]^T exactly (Z[k][i,j] =
    #(a_i<=k-1 & a_j<=k) = Y[k][j,i]), so the joint statistics need 2
    matmul families per level instead of 3 — a 1/3 cut in the dominant
    -J cost for the common n <= tile production case.
    """
    levels = jnp.arange(kmin, kmax + 1, dtype=a.dtype)
    # All five joint statistics are differences of THREE cumulative matmul
    # families (fewer matmuls and half the materialized indicators of the
    # naive one-matmul-per-stat formulation; exact — integer counts in f32):
    #   X[k] = #(a<=k & b<=k),  Y[k] = #(a<=k & b<=k-1),  Z[k] = #(a<=k-1 & b<=k)
    #   eq[k]   = X[k] - Y[k] - Z[k] + X[k-1]
    #   gt_a[k] = Y[k] - X[k-1]          (a = k, b < k)
    #   gt_b[k] = Z[k] - X[k-1]          (b = k, a < k)
    # At k = kmin, a<=kmin-1 / b<=kmin-1 may be nonempty only for padded
    # zero-register rows (mesh path), whose output rows the caller trims.
    cums, eqs, gtas, gtbs = [], [], [], []
    ca_prev = a <= jnp.asarray(kmin - 1, a.dtype)
    cb_prev = b <= jnp.asarray(kmin - 1, b.dtype)
    x_prev = _dot(ca_prev, cb_prev) if joint else None
    for k in range(kmin, kmax + 1):
        lev = jnp.asarray(k, a.dtype)
        ca = a <= lev
        cb = b <= lev
        x = _dot(ca, cb)
        cums.append(x)
        if joint:
            y = _dot(ca, cb_prev)
            z = y.T if same else _dot(ca_prev, cb)
            eqs.append(x - y - z + x_prev)
            gtas.append(y - x_prev)
            # note operand order: _dot's FIRST arg indexes the output's
            # rows (the A side), so the B-side indicator goes second
            gtbs.append(z - x_prev)
            x_prev = x
        ca_prev, cb_prev = ca, cb
    out = {"cum_union": jnp.stack(cums, axis=-1)}
    if joint:
        out["eq"] = jnp.stack(eqs, axis=-1)
        out["gt_a"] = jnp.stack(gtas, axis=-1)
        out["gt_b"] = jnp.stack(gtbs, axis=-1)
    if same:
        # diagonal of X[k] IS the per-row cumulative histogram
        # (#(a_i <= k)); differencing gives the marginal histogram
        # exactly (integer counts in f32), skipping both one-hot passes
        # over the (n, m) register matrix
        d = jnp.diagonal(out["cum_union"], axis1=0, axis2=1).T  # (na, K)
        out["hist_a"] = jnp.concatenate(
            [d[..., :1], d[..., 1:] - d[..., :-1]], axis=-1)
        out["hist_b"] = out["hist_a"]
    else:
        out["hist_a"] = (a[..., :, None] == levels).astype(
            jnp.float32).sum(-2)
        out["hist_b"] = (b[..., :, None] == levels).astype(
            jnp.float32).sum(-2)
    return out


@functools.partial(jax.jit, static_argnames=("p", "estim", "jestim", "kmin"))
def triples_from_stats(stats: Dict[str, jnp.ndarray], p: int,
                       estim: int, jestim: int, kmin: int = 0) -> jnp.ndarray:
    """(na, nb, 3) set triples (onlyA, onlyB, shared) for every pair."""
    if jestim == est.ERTL_JOINT_MLE:
        # joint MLE consumes the level window directly (no zero-padding)
        return _xla_jmle_triples(stats, p, kmin)
    # windowed estimators skip the zero bins AND (window permitting) the
    # sigma/tau series — the dominant n^2 estimator cost
    c_a = est.estimate_windowed(stats["hist_a"], p, kmin, estim)
    c_b = est.estimate_windowed(stats["hist_b"], p, kmin, estim)
    cum = stats["cum_union"]
    hist_u_w = jnp.concatenate([cum[..., :1], cum[..., 1:] - cum[..., :-1]],
                               axis=-1)
    c_u = est.estimate_windowed(hist_u_w, p, kmin, estim)
    shared = jnp.maximum(0.0, c_a[:, None] + c_b[None, :] - c_u)
    only_a = jnp.maximum(c_a[:, None] - shared, 0.0)
    only_b = jnp.maximum(c_b[None, :] - shared, 0.0)
    return jnp.stack([only_a, only_b, shared], axis=-1)


def _xla_jmle_triples(stats, p: int, kmin: int) -> jnp.ndarray:
    """Joint-MLE triples: the Newton solve vmapped over pairs."""
    eq = stats["eq"]
    na, nb = eq.shape[0], eq.shape[1]
    cum = stats["cum_union"]
    hist_u_w = jnp.concatenate([cum[..., :1], cum[..., 1:] - cum[..., :-1]],
                               axis=-1)
    gt_a = stats["gt_a"]
    gt_b = stats["gt_b"]
    ha = jnp.broadcast_to(stats["hist_a"][:, None, :], eq.shape)
    hb = jnp.broadcast_to(stats["hist_b"][None, :, :], eq.shape)
    lt_a = ha - eq - gt_a
    lt_b = hb - eq - gt_b
    # Inclusion-exclusion init cardinalities: c_a/c_b depend only on the
    # row/column MARGINALS, so estimate n of them instead of n^2 (the
    # per-pair recomputation was the dominant -J init cost); the pair-
    # dependent c_u only seeds the Newton neighborhood, so the cheap
    # improved estimator (no inner Newton loop) suffices there.
    c_a = est.mle_estimate_windowed(stats["hist_a"], p, kmin)
    c_b = est.mle_estimate_windowed(stats["hist_b"], p, kmin)
    c_u = est.improved_estimate_windowed(hist_u_w, p, kmin)
    flat = lambda x: x.reshape(-1, x.shape[-1])
    sdict = dict(eq=flat(eq), gt_a=flat(gt_a), gt_b=flat(gt_b),
                 lt_a=flat(lt_a), lt_b=flat(lt_b))
    cards = (jnp.broadcast_to(c_a[:, None], (na, nb)).reshape(-1),
             jnp.broadcast_to(c_b[None, :], (na, nb)).reshape(-1),
             c_u.reshape(-1))
    tri = jax.vmap(lambda s, c: est.joint_mle(s, p, kmin=kmin, cards=c))(
        sdict, cards)
    return tri.reshape(na, nb, 3)


# ---------------------------------------------------------------------------
# Measures: the batched rewrite of result_cmp (reference src/dashing.h:568-592).
# Emission-type codes match reference src/enums.h:13-23.
# ---------------------------------------------------------------------------

MASH_DIST = 0
JI = 1
SIZES = 2
FULL_MASH_DIST = 3
FULL_CONTAINMENT_DIST = 4
CONTAINMENT_INDEX = 5
CONTAINMENT_DIST = 6
SYMMETRIC_CONTAINMENT_INDEX = 7
SYMMETRIC_CONTAINMENT_DIST = 8

_SYMMETRIC = {MASH_DIST, JI, SIZES, FULL_MASH_DIST,
              SYMMETRIC_CONTAINMENT_INDEX, SYMMETRIC_CONTAINMENT_DIST}
_SIMILARITY = {JI, SIZES, CONTAINMENT_INDEX, SYMMETRIC_CONTAINMENT_INDEX}


def is_symmetric(result_type: int) -> bool:
    """reference src/dashing.h:393-404."""
    return result_type in _SYMMETRIC


def is_similarity(result_type: int) -> bool:
    """emt2nntype, reference src/dashing.h:267-280."""
    return result_type in _SIMILARITY


@functools.partial(jax.jit, static_argnames=("result_type",))
def measure_from_triples(tri: jnp.ndarray, result_type: int, ksinv: float
                         ) -> jnp.ndarray:
    """(..., 3) triples -> (...) float32 measure.

    Formula-for-formula replication of result_cmp (reference
    src/dashing.h:568-592) — including the reference's quirk that
    --containment-index in dist mode divides by the UNION (t0+t1+t2),
    i.e. equals Jaccard, rather than by |A| as the usage text says.
    """
    t0, t1, t2 = tri[..., 0], tri[..., 1], tri[..., 2]
    if result_type in (MASH_DIST, FULL_MASH_DIST, JI):
        denom = t0 + t1 + t2
        ji = jnp.where(denom > 0, t2 / jnp.maximum(denom, 1e-30), 0.0)
        if result_type == JI:
            return ji.astype(jnp.float32)
        ratio = 2.0 * ji / (1.0 + ji)
        if result_type == MASH_DIST:
            return jnp.where(ji > 0, -jnp.log(jnp.maximum(ratio, 1e-38)) * ksinv,
                             1.0).astype(jnp.float32)
        return (1.0 - ratio ** ksinv).astype(jnp.float32)
    if result_type == SIZES:
        return t2.astype(jnp.float32)
    if result_type in (SYMMETRIC_CONTAINMENT_INDEX, SYMMETRIC_CONTAINMENT_DIST):
        c = t2 / jnp.maximum(jnp.minimum(t0, t1) + t2, 1e-30)
        if result_type == SYMMETRIC_CONTAINMENT_INDEX:
            return c.astype(jnp.float32)
        return jnp.where(c > 0, -jnp.log(jnp.maximum(c, 1e-38)) * ksinv,
                         1.0).astype(jnp.float32)
    # CONTAINMENT_{INDEX,DIST}, FULL_CONTAINMENT_DIST
    c = t2 / jnp.maximum(t0 + t1 + t2, 1e-30)
    if result_type == CONTAINMENT_INDEX:
        return c.astype(jnp.float32)
    if result_type == CONTAINMENT_DIST:
        return jnp.where(c > 0, -jnp.log(jnp.maximum(c, 1e-38)) * ksinv,
                         1.0).astype(jnp.float32)
    return (1.0 - c ** ksinv).astype(jnp.float32)


# ---------------------------------------------------------------------------
# Host orchestration: tiled all-pairs / rectangular comparison.
# ---------------------------------------------------------------------------

def _stack_regs(sketches) -> np.ndarray:
    return np.stack([s.regs for s in sketches]).astype(np.int32)


def _compare_mesh():
    from ..parallel.mesh import local_mesh
    return local_mesh()


def _device_regs(regs: np.ndarray) -> jnp.ndarray:
    """Upload the full register matrix ONCE as int8 (values <= 64 always
    fit) and slice tiles on device, instead of re-uploading register
    slices per tile.  Clamp before the cast: legitimate
    registers are <= 64, but a corrupt presketched file could carry values
    >= 128 which would WRAP negative in int8 and satisfy every a<=lev
    indicator instead of staying above the window.

    With >1 local device the matrix is replicated across the mesh, so
    each tile's rows are already on whichever device computes it."""
    arr = np.minimum(regs, 127).astype(np.int8)
    mesh = _compare_mesh()
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        return jax.device_put(arr, NamedSharding(mesh, P()))
    return jnp.asarray(arr)


def _device_regs_for(sketches, regs: np.ndarray) -> jnp.ndarray:
    """Device register bank for a sketch list: when EVERY sketch carries a
    device-resident row (sk.dev_regs, parked by the mkdist fused
    presketch), stack them on device — zero host->device bank transfer;
    otherwise upload the host stack (_device_regs).  Rows are int8-clamped
    identically on both paths, so results are bitwise-equal."""
    devs = [getattr(s, "dev_regs", None) for s in sketches]
    if not devs or any(d is None for d in devs):
        return _device_regs(regs)
    # chunked stack: one 1000-operand concatenate is hard on the compiler
    parts = [jnp.stack(devs[i:i + 128]) for i in range(0, len(devs), 128)]
    arr = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
    mesh = _compare_mesh()
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P
        return jax.device_put(arr, NamedSharding(mesh, P()))
    return arr


def _auto_kmax(regs: np.ndarray, q: int) -> int:
    return int(min(int(regs.max(initial=0)) + 1, q + 1))


def _auto_kmin(regs: np.ndarray) -> int:
    # initial=255, NOT 0: np.min(initial=x) is min(x, data) and registers
    # are non-negative, so initial=0 pinned every window to kmin=0 and
    # silently disabled the kmin half of the per-tile windows (review
    # finding; warm banks sit at min register ~log2(n/m) - 3)
    return int(regs.min(initial=255))


# Bucketed window widths: each distinct (kmin, kmax) pair is a separate jit
# variant (kmin/kmax are static), so the per-tile windows round kmin DOWN to
# even and the width UP to one of these — a handful of compile variants
# instead of one per tile pair, while still cutting the matmul count to
# roughly the tile's own level span (the global window pays for the union
# of ALL levels in the bank, ~25 at p=14, on every tile).
_K_BUCKETS = (8, 16, 24, 32, 44, 58, 66)


def _tile_window(tmin: int, tmax1: int, q: int):
    """Bucket a tile pair's exact level window [tmin, tmax1] for jit reuse.

    tmin must be <= every register in the tile pair and tmax1 >= the
    engine's kmax for it (tile max + 1, clamped to q+1) — the bucketing
    only ever WIDENS the window (down-rounded kmin, up-rounded width, with
    top overflow past q+1 folded into a lower kmin), and widening is exact:
    the extra levels hold empty histogram bins that contribute exact zeros
    to every windowed estimator sum."""
    # kmin rounds DOWN to a multiple of 4: now that block minima are live
    # (not constant 0), each distinct (kmin, kmax) is a separate jit
    # compile variant — /4 bucketing bounds the variant count at <= 3
    # levels of extra (exactly-zero) work per tile
    kmin = max(0, tmin - (tmin & 3))
    K = tmax1 - kmin + 1
    for b in _K_BUCKETS:
        if b >= K:
            K = b
            break
    kmax = kmin + K - 1
    if kmax > q + 1:
        kmin = max(0, kmin - (kmax - (q + 1)))
        kmax = q + 1
    return kmin, kmax


def _block_minmax(regs: np.ndarray, n: int, tile: int):
    """Per-row-block register (min, max+1-clamped) for per-tile windows."""
    return {i0: (int(regs[i0:i0 + tile].min(initial=255)),
                 int(regs[i0:i0 + tile].max(initial=0)) + 1)
            for i0 in range(0, n, tile)}


def _pair_window(mm_a, mm_b, q: int):
    """(kmax, kmin) for a tile pair — ordered for compare_tile_async."""
    lo = min(mm_a[0], mm_b[0])
    hi = min(max(mm_a[1], mm_b[1]), q + 1)
    kmin, kmax = _tile_window(lo, hi, q)
    return kmax, kmin


def compare_tile_async(regs_a: np.ndarray, regs_b: np.ndarray, p: int,
                       result_type: int, ksinv: float, estim: int,
                       jestim: int, kmax: int, kmin: int,
                       same: bool = False, slot: int = 0) -> jnp.ndarray:
    """One (na, nb) tile of the measure matrix, left on device.

    jax dispatch is asynchronous, so callers can enqueue a window of tiles
    and gather finished ones while the device works on the next — the
    compute/transfer overlap the reference gets from its double-buffered
    row writers (src/sketch_and_cmp.h:802-836).

    With >1 local device, whole tiles go round robin to the mesh devices
    by `slot` (the multi-device replacement for dm::parallel_fill's row
    batches, reference distmat/distmat.h:459-512).  Each tile is then
    the same computation at the same shapes as on one device, so the
    output is bitwise equal to a single-device run.  (Splitting a tile's
    rows over the devices changes the shapes each device compiles, and
    XLA's f32 estimator code may then round differently.)"""
    from .. import metrics
    with metrics.accum("compare.dispatch"):
        mesh = _compare_mesh()
        if mesh is not None:
            dev = mesh.devices.flat[slot % mesh.size]
            regs_a = jax.device_put(regs_a, dev)
            regs_b = jax.device_put(regs_b, dev)
        stats = pair_stats(jnp.asarray(regs_a), jnp.asarray(regs_b), kmax,
                           jestim == est.ERTL_JOINT_MLE, kmin, same)
        tri = triples_from_stats(stats, p, estim, jestim, kmin)
        return measure_from_triples(tri, result_type, ksinv)


def compare_tile(regs_a: np.ndarray, regs_b: np.ndarray, p: int,
                 result_type: int, ksinv: float, estim: int, jestim: int,
                 kmax: Optional[int] = None, kmin: int = 0) -> np.ndarray:
    """One (na, nb) tile of the measure matrix."""
    q = 64 - p
    if kmax is None:
        kmax = max(_auto_kmax(regs_a, q), _auto_kmax(regs_b, q))
        kmin = min(_auto_kmin(regs_a), _auto_kmin(regs_b))
    return np.asarray(compare_tile_async(regs_a, regs_b, p, result_type,
                                         ksinv, estim, jestim, kmax, kmin))


# Async tiles in flight during all-pairs loops.  Chosen on the previous
# target; not tuned for the H100 (ROADMAP S2, S6).
_TILE_WINDOW = 4

# Tile-row width of every compare loop.  The multi-host stripe split
# computes block ownership from the same value, so every process of a
# distributed run must see the same setting.  Env-tunable mostly so the
# 2-process tests can exercise REAL multi-rank stripes with tiny inputs.
# The 1024 default was chosen on the previous target; not tuned for the
# H100 (ROADMAP S2, S6).
DEFAULT_TILE = int(os.environ.get("DASHING_TPU_COMPARE_TILE", "1024"))


def _windowed(tiles, writeback, window: int = _TILE_WINDOW, redo=None):
    """Drive (key, device_future) pairs keeping `window` tiles in flight;
    `writeback(key, np_block)` lands each finished tile.  Tuple payloads
    (e.g. top-k (vals, idx)) convert per element, keeping each dtype.

    redo(key) -> device_future, when given, rebuilds a tile whose pull hit
    a transient backend error (JaxRuntimeError): tile compute is pure, so
    re-dispatch is idempotent, and a hiccup no longer loses a whole matrix
    after the sketch phase (SURVEY.md sec 5.3).  Bounded attempts,
    fail-loud after the last.

    Pull coalescing (DASHING_TPU_COALESCE_PULLS=1, default OFF): finished
    same-shape tiles are stacked into ONE device buffer and pulled with a
    single transfer per window instead of one per tile; the flush point
    is held at 2*window in-flight tiles so the device keeps computing the
    next window while the previous one lands.  It pays off only where
    per-pull latency, not link bandwidth, dominates; not measured on the
    H100 yet."""
    import time as _time
    from collections import deque
    import jax

    coalesce = os.environ.get("DASHING_TPU_COALESCE_PULLS", "0") != "0"

    def to_np(d):
        # elementwise for tuples: np.asarray on the tuple itself would
        # stack mixed dtypes into one promoted float64 array
        from .. import metrics
        with metrics.accum("compare.pull"):
            return (tuple(np.asarray(x) for x in d) if isinstance(d, tuple)
                    else np.asarray(d))

    def pull(k, d):
        try:
            return to_np(d)
        except jax.errors.JaxRuntimeError:
            if redo is None:
                raise
        for attempt in range(3):
            try:
                return to_np(redo(k))
            except jax.errors.JaxRuntimeError:
                if attempt == 2:
                    raise
                _time.sleep(2.0 * (attempt + 1))

    def land(k, d):
        writeback(k, pull(k, d))

    def flush(batch):
        """Land a finished window: one stacked pull per same-shape group
        of plain-array tiles; tuples and odd shapes pull individually."""
        groups: dict = {}
        order = []
        for k, d in batch:
            if isinstance(d, tuple) or not hasattr(d, "shape"):
                order.append((k, d, None, None))
            else:
                sig = (d.shape, str(d.dtype))
                groups.setdefault(sig, []).append(len(order))
                order.append((k, d, sig, None))
        for sig, idxs in groups.items():
            if len(idxs) < 2:
                continue
            try:
                stacked = np.asarray(jnp.stack([order[i][1] for i in idxs]))
            except jax.errors.JaxRuntimeError:
                continue          # transient: fall through to per-tile pulls
            for pos, i in enumerate(idxs):
                k, d, s, _ = order[i]
                order[i] = (k, d, s, stacked[pos])
        for k, d, _, got in order:
            if got is not None:
                writeback(k, got)
            else:
                land(k, d)

    pending: deque = deque()
    if coalesce:
        for key, dev in tiles:
            pending.append((key, dev))
            if len(pending) >= 2 * window:
                batch = [pending.popleft() for _ in range(window)]
                flush(batch)
        while pending:
            flush([pending.popleft() for _ in range(min(window,
                                                        len(pending)))])
        return
    for key, dev in tiles:
        pending.append((key, dev))
        if len(pending) >= window:
            land(*pending.popleft())
    while pending:
        land(*pending.popleft())


def all_pairs_condensed(sketches, result_type: int, k: int,
                        estim: int, jestim: int, tile: int = DEFAULT_TILE,
                        out: Optional[np.ndarray] = None,
                        row_blocks: Optional[Sequence[int]] = None
                        ) -> np.ndarray:
    """Full symmetric comparison -> condensed upper-triangular vector of
    length n(n-1)/2, ordered like the reference's DistanceMatrix
    (reference distmat/distmat.h:260-264 row-major upper triangle).

    `out` may be a preallocated array — in particular an
    io.distmat.create_binary_mmap memmap, which streams finished tiles
    straight to the page cache while the device computes the next ones.

    `row_blocks` restricts the computation to tile-row starts i0 drawn
    from range(0, n, tile) — the multi-host stripe split (each process
    computes its own row blocks and writes disjoint condensed ranges,
    mirroring the reference's parallel_fill stripe discipline,
    distmat/distmat.h:459-512).  Entries outside the owned rows are left
    untouched."""
    regs = _stack_regs(sketches)
    n = regs.shape[0]
    p = sketches[0].p
    ksinv = 1.0 / k
    q = 64 - p
    # Per-tile level windows: each tile pair resolves only ITS rows' level
    # span (bucketed, _tile_window) instead of the whole bank's — the
    # stats matmul count per tile drops to the local span, the dominant
    # -J cost (the estimators are windowed and exact for any window that
    # covers the tile's registers).
    mm = _block_minmax(regs, n, tile)
    if out is None:
        out = np.empty(n * (n - 1) // 2, np.float32)
    assert out.shape == (n * (n - 1) // 2,)

    def put(i0, j0, block):
        # scatter block values for pairs (i, j) with global j > i — one
        # vectorized fancy-index store per tile (the per-row loop this
        # replaces cost ~1024 python iterations per tile, visible once
        # the device side runs at in-jit rates)
        bi, bj = block.shape
        gi = (i0 + np.arange(bi, dtype=np.int64))[:, None]
        gj = (j0 + np.arange(bj, dtype=np.int64))[None, :]
        idx = (gi * (2 * n - gi - 1)) // 2 + gj - gi - 1
        if j0 >= i0 + bi:         # strictly off-diagonal: all pairs valid
            out[idx.reshape(-1)] = block.reshape(-1)
        else:
            sel = gj > gi
            out[idx[sel]] = block[sel]

    regs_d = _device_regs_for(sketches, regs)

    def one(i0, j0):
        return compare_tile_async(
            regs_d[i0:i0 + tile], regs_d[j0:j0 + tile], p,
            result_type, ksinv, estim, jestim,
            *_pair_window(mm[i0], mm[j0], q), same=(i0 == j0),
            slot=(i0 + j0) // tile)

    rows = (range(0, n, tile) if row_blocks is None
            else sorted(row_blocks))
    _windowed((((i0, j0), one(i0, j0))
                for i0 in rows
                for j0 in range(i0, n, tile)),
               lambda key, block: put(key[0], key[1], block),
               redo=lambda key: one(*key))
    return out


def rect_pairs(ref_sketches, query_sketches, result_type: int, k: int,
               estim: int, jestim: int, tile: int = DEFAULT_TILE,
               ref_blocks: Optional[Sequence[int]] = None) -> np.ndarray:
    """Query x reference rectangular comparison -> (nq, nr) matrix.

    Matches partdist_loop's orientation: row = query, entry j =
    result_cmp(ref[j], query) (reference src/dashing.h:678-681).

    `ref_blocks` restricts to reference tile starts i0 (multi-host column
    stripes); columns outside the owned blocks stay uninitialized."""
    rr = _stack_regs(ref_sketches)
    qq = _stack_regs(query_sketches)
    p = ref_sketches[0].p
    ksinv = 1.0 / k
    q = 64 - p
    nq, nr = qq.shape[0], rr.shape[0]
    mm_r = _block_minmax(rr, nr, tile)
    mm_q = _block_minmax(qq, nq, tile)
    out = (np.zeros if ref_blocks is not None else np.empty)(
        (nq, nr), np.float32)   # zeros: unowned stripes must gather clean
    rr_d, qq_d = _device_regs(rr), _device_regs(qq)
    # triple order: lhs = reference, rhs = query (result_cmp(hlls[j], hq))
    def one(i0, j0):
        return compare_tile_async(
            rr_d[i0:i0 + tile], qq_d[j0:j0 + tile], p, result_type,
            ksinv, estim, jestim, *_pair_window(mm_r[i0], mm_q[j0], q),
            slot=(i0 + j0) // tile)

    ref_starts = (range(0, nr, tile) if ref_blocks is None
                  else sorted(ref_blocks))
    _windowed((((i0, j0), one(i0, j0))
                for i0 in ref_starts
                for j0 in range(0, nq, tile)),
               lambda key, block: out.__setitem__(
                   (slice(key[1], key[1] + tile),
                    slice(key[0], key[0] + tile)), block.T),
               redo=lambda key: one(*key))
    return out


def rect_triples(ref_sketches, query_sketches, estim: int, jestim: int,
                 tile: int = DEFAULT_TILE,
                 ref_blocks: Optional[Sequence[int]] = None) -> np.ndarray:
    """Query x reference set triples -> (nq, nr, 3) float32 (onlyREF,
    onlyQUERY, shared), same orientation as rect_pairs (lhs = reference).

    Feeds consumers that need several derived measures per pair at once
    (panel: containment AND Jaccard) from ONE tiled batched pass instead
    of one device dispatch per pair."""
    rr = _stack_regs(ref_sketches)
    qq = _stack_regs(query_sketches)
    p = ref_sketches[0].p
    q = 64 - p
    nq, nr = qq.shape[0], rr.shape[0]
    mm_r = _block_minmax(rr, nr, tile)
    mm_q = _block_minmax(qq, nq, tile)
    joint = jestim == est.ERTL_JOINT_MLE
    out = (np.zeros if ref_blocks is not None else np.empty)(
        (nq, nr, 3), np.float32)   # zeros: unowned stripes gather clean
    rr_d, qq_d = _device_regs(rr), _device_regs(qq)

    def one(i0, j0):
        kmax, kmin = _pair_window(mm_r[i0], mm_q[j0], q)
        stats = pair_stats(rr_d[i0:i0 + tile], qq_d[j0:j0 + tile],
                           kmax, joint, kmin)
        return triples_from_stats(stats, p, estim, jestim, kmin)

    ref_starts = (range(0, nr, tile) if ref_blocks is None
                  else sorted(ref_blocks))
    _windowed((((i0, j0), one(i0, j0))
               for i0 in ref_starts
               for j0 in range(0, nq, tile)),
              lambda key, block: out.__setitem__(
                  (slice(key[1], key[1] + tile),
                   slice(key[0], key[0] + tile)),
                  block.transpose(1, 0, 2)),
              redo=lambda key: one(*key))
    return out


@functools.partial(jax.jit, static_argnames=("nn", "sim", "exclude"))
def _device_tile_topk(block, q0, j0, nn: int, sim: bool, exclude: bool):
    """(bt, qt) measure block -> per-query top-nn (vals, GLOBAL ref idx),
    reduced on device so the host pulls (qt, nn) instead of (qt, bt).
    lax.top_k is stable (ties keep the lower index), matching the dense
    stable argsort's ascending-index tie-break."""
    m = block.T                                   # (qt, bt)
    qt, bt = m.shape
    if exclude:
        qi = q0 + jnp.arange(qt)[:, None]
        rj = j0 + jnp.arange(bt)[None, :]
        m = jnp.where(qi == rj, jnp.float32(-jnp.inf if sim else jnp.inf), m)
    key = m if sim else -m
    kk = min(nn, bt)
    vals, idx = jax.lax.top_k(key, kk)
    vals = vals if sim else -vals
    if kk < nn:
        # ragged final ref tile: pad with worst-sorting sentinels — they
        # can never reach the merged top-nn (earlier full tiles already
        # supplied >= nn real candidates, and stable sorts keep real
        # entries first at equal values).  Pad idx with -1, not 0: an
        # escaped sentinel then shows up as ref -1 instead of silently
        # aliasing ref 0 (ADVICE r2 item 3).
        worst = jnp.float32(-jnp.inf if sim else jnp.inf)
        vals = jnp.pad(vals, ((0, 0), (0, nn - kk)), constant_values=worst)
        return vals, jnp.pad(idx + j0, ((0, 0), (0, nn - kk)),
                             constant_values=-1)
    return vals, idx + j0


def nn_topk(ref_sketches, query_sketches, result_type: int, k: int,
            estim: int, jestim: int, nn: int, exclude_self: bool,
            tile: int = DEFAULT_TILE, ref_blocks: Optional[Sequence[int]] = None):
    """Streaming k-nearest-neighbors in O(n_q * (nn + tile)) HOST memory —
    the full n_q x n_r matrix is never materialized (the reference streams
    rows through bounded heaps, src/sketch_and_cmp.h:712-783; round-1
    materialized the whole matrix then argsorted).

    Both axes tile (a (tile, n_q) block at large n_q explodes the
    (bt, nq, K) statistics intermediates), and each (ref-tile, query-tile)
    block is top-k-reduced ON DEVICE before the pull: the host receives
    (qt, nn) candidates instead of (qt, bt) values (n=16384 otherwise
    pulls the entire 17 GB matrix to the host).

    query_sketches may be the same list as ref_sketches (all-pairs mode);
    exclude_self then masks the diagonal exactly like the dense path
    (-inf/+inf so self sorts last).  Tie-break matches the dense stable
    argsort: lax.top_k is stable and tiles scan ascending, so equal
    values order by ascending reference index.  Returns (vals, idx) each
    (n_q, nn).

    `ref_blocks` restricts the scan to reference tile starts j0 (the
    multi-host split): the result is then each query's top-nn over ONLY
    the owned references, with GLOBAL ref indices, padded with
    (worst, -1) sentinels when the owned refs supply fewer than nn
    candidates — ready for a cross-process candidate merge."""
    rr = _stack_regs(ref_sketches)
    same = query_sketches is ref_sketches
    qq = rr if same else _stack_regs(query_sketches)
    p = ref_sketches[0].p
    ksinv = 1.0 / k
    q = 64 - p
    sim = is_similarity(result_type)
    nq, nr = qq.shape[0], rr.shape[0]
    mm_r = _block_minmax(rr, nr, tile)
    mm_q = mm_r if same else _block_minmax(qq, nq, tile)
    nn = min(nn, nr)
    nn_eff = min(nn, tile)
    rr_d = _device_regs(rr)
    qq_d = rr_d if same else _device_regs(qq)
    worst = -np.inf if sim else np.inf
    best_v = np.full((nq, 0), worst, np.float32)
    best_i = np.zeros((nq, 0), np.int64)
    staged_v = np.empty((nq, nn_eff), np.float32)
    staged_i = np.empty((nq, nn_eff), np.int64)
    pending = [None]          # j0 whose candidates are currently staging

    def merge():
        nonlocal best_v, best_i
        cat_v = np.concatenate([best_v, staged_v], axis=1)
        cat_i = np.concatenate([best_i, staged_i], axis=1)
        order = np.argsort(-cat_v if sim else cat_v, axis=1,
                           kind="stable")[:, :nn]
        best_v = np.take_along_axis(cat_v, order, axis=1)
        best_i = np.take_along_axis(cat_i, order, axis=1)

    def one(j0, q0):
        block = compare_tile_async(
            rr_d[j0:j0 + tile], qq_d[q0:q0 + tile], p, result_type,
            ksinv, estim, jestim, *_pair_window(mm_r[j0], mm_q[q0], q),
            same=(same and j0 == q0), slot=(j0 + q0) // tile)
        return _device_tile_topk(block, q0, j0, nn_eff, sim, exclude_self)

    ref_starts = (range(0, nr, tile) if ref_blocks is None
                  else sorted(ref_blocks))

    def tiles():
        for j0 in ref_starts:
            for q0 in range(0, nq, tile):
                yield ((j0, q0), one(j0, q0))

    def land(key, vi):
        j0, q0 = key
        if pending[0] is not None and j0 != pending[0]:
            merge()               # previous ref tile fully staged
        pending[0] = j0
        v, i = vi
        qt = min(tile, nq - q0)
        staged_v[q0:q0 + qt] = np.asarray(v, np.float32)[:qt]
        staged_i[q0:q0 + qt] = np.asarray(i, np.int64)[:qt]

    _windowed(tiles(), land, redo=lambda key: one(*key))
    if pending[0] is not None:
        merge()
    return pad_nn_candidates(best_v, best_i, nn, worst)


def pad_nn_candidates(best_v: np.ndarray, best_i: np.ndarray, nn: int,
                      worst):
    """Pad a k-NN candidate list to a fixed (nq, nn) with (worst, -1)
    sentinels — a ref_blocks shard can own fewer than nn references (or
    none), and the cross-process gather in distributed.combine_nn needs
    ONE shape on every rank.  The sentinel contract (-1 id, worst-sorting
    value) is shared with combine_nn's merge; change them together."""
    if best_v.shape[1] < nn:
        padw = nn - best_v.shape[1]
        best_v = np.pad(best_v, ((0, 0), (0, padw)), constant_values=worst)
        best_i = np.pad(best_i, ((0, 0), (0, padw)), constant_values=-1)
    return best_v, best_i


def full_square(sketches, result_type: int, k: int, estim: int, jestim: int,
                tile: int = DEFAULT_TILE) -> np.ndarray:
    """(n, n) square matrix with 0 diagonal (FULL_TSV path,
    reference src/sketch_and_cmp.h:851-877).

    Symmetric measures compute only the upper-triangle tiles and mirror
    the transpose on the host — half the device work of the full grid."""
    regs = _stack_regs(sketches)
    n = regs.shape[0]
    p = sketches[0].p
    ksinv = 1.0 / k
    q = 64 - p
    sym = is_symmetric(result_type)
    mm = _block_minmax(regs, n, tile)
    out = np.empty((n, n), np.float32)
    regs_d = _device_regs_for(sketches, regs)

    def one(i0, j0):
        return compare_tile_async(
            regs_d[i0:i0 + tile], regs_d[j0:j0 + tile], p,
            result_type, ksinv, estim, jestim,
            *_pair_window(mm[i0], mm[j0], q), same=(i0 == j0),
            slot=(i0 + j0) // tile)

    def land(key, block):
        i0, j0 = key
        out[i0:i0 + tile, j0:j0 + tile] = block
        if sym and j0 > i0:
            out[j0:j0 + tile, i0:i0 + tile] = block.T

    _windowed((((i0, j0), one(i0, j0))
                for i0 in range(0, n, tile)
                for j0 in range(i0 if sym else 0, n, tile)),
               land, redo=lambda key: one(*key))
    np.fill_diagonal(out, 0.0)
    return out
