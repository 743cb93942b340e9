"""Multi-host orchestration (the distributed backend the reference lacks).

Single-controller-per-host model: `maybe_initialize()` wires up
jax.distributed from the standard env vars; work is split by genome across
processes (the reference's OMP-dynamic file loop, lifted to hosts), and
global sketch state merges with the register-max collective.

On a pod slice:
    DASHING_TPU_DISTRIBUTED=1 \
    JAX_COORDINATOR=host0:1234 JAX_NUM_PROCESSES=4 JAX_PROCESS_ID=$i \
    python -m dashing_tpu.cli sketch ...

Within-host chip parallelism is parallel/mesh.py; this file only adds the
process boundary.  Functions degrade to no-ops in single-process runs, so
the same CLI code path serves laptop and pod.
"""
from __future__ import annotations

import os
from typing import List, Sequence

import numpy as np


_INITIALIZED = False


def maybe_initialize() -> bool:
    """Initialize jax.distributed when DASHING_TPU_DISTRIBUTED is set —
    once per process, so several CLI commands can run in one process."""
    global _INITIALIZED
    if os.environ.get("DASHING_TPU_DISTRIBUTED", "") in ("", "0"):
        return False
    if _INITIALIZED:
        return True
    import jax
    coord = os.environ.get("JAX_COORDINATOR")
    nproc = os.environ.get("JAX_NUM_PROCESSES")
    pid = os.environ.get("JAX_PROCESS_ID")
    kwargs = {}
    if coord:
        if nproc is None or pid is None:
            raise SystemExit(
                "DASHING_TPU_DISTRIBUTED: JAX_COORDINATOR is set but "
                "JAX_NUM_PROCESSES/JAX_PROCESS_ID are missing")
        kwargs = dict(coordinator_address=coord,
                      num_processes=int(nproc), process_id=int(pid))
    jax.distributed.initialize(**kwargs)
    _INITIALIZED = True
    return True


def process_index() -> int:
    import jax
    return jax.process_index()


def process_count() -> int:
    import jax
    return jax.process_count()


def is_main() -> bool:
    return process_index() == 0


def my_shard(items: Sequence, strided: bool = True) -> List:
    """This process's share of a work list.

    Strided assignment preserves the size-descending load balance the
    reference gets from sort_paths_by_fsize (src/finalizers.cpp:6-22):
    after the global sort, process i takes items i, i+P, i+2P, ...
    """
    p, n = process_index(), process_count()
    if n == 1:
        return list(items)
    if strided:
        return list(items[p::n])
    chunk = -(-len(items) // n)
    return list(items[p * chunk:(p + 1) * chunk])


def global_register_max(regs: np.ndarray) -> np.ndarray:
    """Merge per-process registers with a cross-process max all-reduce
    (the multi-host extension of the mesh merge in parallel/mesh.py)."""
    import jax
    import jax.numpy as jnp
    if jax.process_count() == 1:
        return regs
    from jax.experimental import multihost_utils
    return np.asarray(
        multihost_utils.process_allgather(jnp.asarray(regs))).max(axis=0)


# ---------------------------------------------------------------------------
# Cross-host sharded COMPARE phase (SURVEY sec 2.4-P7 / 5.8: the 2-D
# sharded distance grid with per-host tile stripes, mirroring the
# reference's parallel_fill stripe writer, distmat/distmat.h:459-512).
# The sketch phase allgathers every register bank to every process; the
# compare phase then splits tile-ROW blocks across processes (strided, so
# the shrinking upper-triangle rows balance), each process computes its
# stripes, and the results land either by rank-local mmap stripe writes
# into a shared output file (binary) or by an allgather of stripe payloads
# to rank 0 (TSV and friends).
# ---------------------------------------------------------------------------


def barrier(name: str = "dashing_tpu_barrier") -> None:
    """Cross-process sync point (used around shared-file mmap stripes)."""
    import jax
    if jax.process_count() == 1:
        return
    from jax.experimental import multihost_utils
    multihost_utils.sync_global_devices(name)


def allgather_np(arr: np.ndarray) -> np.ndarray:
    """(P, *arr.shape) stack of every process's same-shaped array.

    64-bit dtypes ride as uint32 pairs: jnp.asarray under the default
    x64-disabled config silently NARROWS int64->int32 / float64->float32
    (combine_nn's int64 reference ids would wrap at 2^31)."""
    import jax.numpy as jnp
    from jax.experimental import multihost_utils
    arr = np.ascontiguousarray(arr)
    if arr.dtype.itemsize == 8:
        out = allgather_np(arr.view(np.uint32))
        return out.view(arr.dtype)
    return np.asarray(multihost_utils.process_allgather(jnp.asarray(arr)))


def owned_blocks(rank: int, nprocs: int, n: int, tile: int) -> List[int]:
    """Tile-row starts owned by `rank` — THE one definition of stripe
    ownership: owned_tile_rows (compute side) and the combine_* overlays
    (merge side) both call it, so the partition scheme cannot drift
    between them.  Strided: row block i0 carries ~(n - i0) columns of
    upper-triangle work, monotonically shrinking, so round-robin keeps
    per-process work within one block of even (the reference gets the
    same effect from OMP dynamic scheduling, src/sketch_and_cmp.h:
    704-706)."""
    return list(range(0, n, tile))[rank::nprocs]


def owned_tile_rows(n: int, tile: int) -> List[int]:
    """This process's share of tile-row starts (see owned_blocks)."""
    return owned_blocks(process_index(), process_count(), n, tile)


def _condensed_row_start(i: int, n: int) -> int:
    # first condensed index of row i (distmat.h:260-264 packing)
    return (i * (2 * n - i - 1)) // 2


def condensed_stripe(i0: int, n: int, tile: int) -> slice:
    """Condensed index range owned by tile-row block i0: rows
    [i0, min(i0+tile, n)) pack contiguously, so a block is one slice —
    this is what makes rank-local mmap stripe writes disjoint."""
    hi = min(i0 + tile, n)
    return slice(_condensed_row_start(i0, n), _condensed_row_start(hi, n))


def combine_condensed(local: np.ndarray, n: int, tile: int) -> np.ndarray:
    """Merge per-process condensed stripes into the full vector.

    Every process calls this with its locally-filled vector (entries
    outside its owned rows are garbage/zero); ownership is recomputed
    deterministically on every rank, so the overlay needs no index
    exchange.

    Bounded memory (VERDICT r4 weak #5): instead of allgathering P FULL
    condensed vectors (P * n(n-1)/2 * 4 B transient — ~P x 20 GB at
    n = 1e5), each rank packs ONLY its owned stripes into a contiguous
    payload and the payloads are gathered in fixed-size chunks
    (DASHING_TPU_GATHER_CHUNK_MB per rank per step, default 64).  Total
    bytes moved drop from P*total to ~total, and the per-step transient
    is P * chunk regardless of n.  Every rank computes the same
    deterministic payload layout, so no index exchange is needed and all
    ranks issue the same number of collectives."""
    p = process_count()
    if p == 1:
        return local
    slices = {r: [condensed_stripe(i0, n, tile)
                  for i0 in owned_blocks(r, p, n, tile)]
              for r in range(p)}
    lens = {r: sum(s.stop - s.start for s in ss)
            for r, ss in slices.items()}
    maxlen = max(lens.values())
    me = process_index()
    payload = np.zeros(maxlen, local.dtype)
    off = 0
    for s in slices[me]:
        seg = local[s]
        payload[off:off + seg.size] = seg
        off += seg.size
    itemsize = max(local.dtype.itemsize, 1)
    chunk = max(1, int(float(os.environ.get(
        "DASHING_TPU_GATHER_CHUNK_MB", "64")) * 1e6) // itemsize)
    out = np.empty_like(local)
    for start in range(0, maxlen, chunk):
        piece = allgather_np(payload[start:start + chunk])   # (P, c)
        c = piece.shape[1]
        for r in range(p):
            off_r = 0
            for s in slices[r]:
                ln = s.stop - s.start
                a = max(off_r, start)
                b = min(off_r + ln, start + c)
                if a < b:
                    out[s.start + (a - off_r):s.start + (b - off_r)] = \
                        piece[r, a - start:b - start]
                off_r += ln
    return out


def combine_columns(local: np.ndarray, nr: int, tile: int) -> np.ndarray:
    """Merge per-process column stripes of an (nq, nr) rectangle (the
    -Q query-vs-reference mode: reference tile columns are sharded).

    Bounded memory: gathered one owned block per rank per round
    ((P, nq, tile) transient) instead of P full (nq, nr) matrices —
    the same cliff removal as combine_condensed."""
    p = process_count()
    if p == 1:
        return local
    nq = local.shape[0]
    blocks = {r: owned_blocks(r, p, nr, tile) for r in range(p)}
    rounds = max(len(b) for b in blocks.values())
    me = process_index()
    out = np.empty_like(local)
    # trailing dims ride along (panel's (nq, nr, 3) set triples)
    buf = np.zeros((nq, tile) + local.shape[2:], local.dtype)
    for j in range(rounds):
        buf[:] = 0
        if j < len(blocks[me]):
            i0 = blocks[me][j]
            w = min(i0 + tile, nr) - i0
            buf[:, :w] = local[:, i0:i0 + w]
        piece = allgather_np(buf)        # (P, nq, tile)
        for r in range(p):
            if j < len(blocks[r]):
                i0 = blocks[r][j]
                w = min(i0 + tile, nr) - i0
                out[:, i0:i0 + w] = piece[r, :, :w]
    return out


def combine_nn(vals: np.ndarray, order: np.ndarray, nn: int, sim: bool):
    """Merge per-process k-NN candidate lists: one (P, nq, nn) gather of
    (vals, global ref ids), then a host top-nn over the P*nn candidates
    per query.  Sentinel candidates (id -1, worst value) from processes
    owning fewer than nn references sort last and survive only when the
    GLOBAL reference count is below nn.  Tie-break: equal values order by
    ascending reference index — the same rule as the single-process
    paths (lax.top_k stability + ascending tile scan), so the merged
    output is byte-identical to a single-process run."""
    p = process_count()
    if p == 1:
        return vals, order
    gv = allgather_np(vals.astype(np.float32, copy=False))
    gi = allgather_np(order.astype(np.int64, copy=False))
    nq = vals.shape[0]
    # (nq, P*nn) candidate pools
    cv = gv.transpose(1, 0, 2).reshape(nq, -1)
    ci = gi.transpose(1, 0, 2).reshape(nq, -1)
    worst = np.float32(-np.inf if sim else np.inf)
    cv = np.where(ci < 0, worst, cv)
    # primary: value (best first); secondary: ascending ref index; push
    # sentinels (-1) behind real entries at equal (worst) values
    sort_idx = np.lexsort((np.where(ci < 0, np.int64(2**62), ci),
                           -cv if sim else cv), axis=1)[:, :nn]
    return (np.take_along_axis(cv, sort_idx, 1),
            np.take_along_axis(ci, sort_idx, 1))
