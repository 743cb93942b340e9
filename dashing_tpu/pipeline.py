"""The sketching engine: files -> tiles -> device -> sketches.

Device replacement for the reference's per-file encode+addh hot loop
(sketch_core, reference src/sketch_and_cmp.h:446-538; the same guts back
dist_sketch_and_cmp :268-417).  A file's records are joined with invalid
separators, tiled into fixed-width overlapping rows, encoded and hashed on
device, and max-reduced into registers.  Shapes are bucketed so jit compiles
a handful of kernels total, independent of genome count.
"""
from __future__ import annotations

import dataclasses
import functools
import os
from collections import OrderedDict
from typing import Iterable, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from . import u64
from .hashes import wang_hash
from .ops import rolling
from .ops.encode import Spacer, encode_tile, join_records, parse_spacing, tile_sequence
from .ops.hll_update import bucket_rank, update_registers, update_registers_filtered
from .io import fasta
from .io.paths import split_subpaths

# Tile geometry: CONTENT bases of payload per row + halo overlap.  Rows per
# device batch bounded to keep device-memory pressure predictable.
CONTENT = 8192
MAX_ROWS = 256


@dataclasses.dataclass(frozen=True)
class SketchParams:
    k: int = 31
    w: int = 0                      # window size (-w); 0 -> k-mer span
    spacing: str = ""
    canon: bool = True
    encoding: str = "bonsai"        # bonsai | nthash | rk/cyclic
    rehash: bool = True             # apply WangHash to encoder output
    min_count: int = 1              # count threshold (--countmin / -c)
    use_counting_filter: bool = False
    entropy: bool = False           # -g/--by-entropy minimizer scoring
    cm_size_log2: int = 20          # count-min geometry (-t/--cm-sketch-size)
    cm_nhashes: int = 4             #   (-q/--nhashes when > 1)
    cm_seed: int = 1337             #   (-R/--seed)

    def spacer(self) -> Spacer:
        return Spacer(self.k, self.w, parse_spacing(self.spacing, self.k))


@functools.partial(jax.jit, static_argnames=("k", "w", "positions", "span",
                                             "canon", "encoding", "rehash",
                                             "p", "entropy", "ucap"))
def _tile_to_registers(tile: jnp.ndarray, regs: jnp.ndarray, *, k: int, w: int,
                       positions: Tuple[int, ...], span: int, canon: bool,
                       encoding: str, rehash: bool, p: int,
                       entropy: bool = False, ucap: int = 64) -> jnp.ndarray:
    """Fused device step: ASCII tile -> k-mers -> hashes -> register max."""
    if encoding == "bonsai":
        km, valid = encode_tile(tile, k=k, w=w, positions=positions, span=span,
                                canon=canon, entropy=entropy)
    else:
        km, valid = rolling.rolling_hash_tile(tile, k=k, kind=encoding,
                                              canon=canon, w=w)
    h = wang_hash(km) if rehash else km
    return update_registers_filtered(regs, h, valid, p, cap=ucap)


@functools.partial(jax.jit, static_argnames=("k", "w", "positions", "span",
                                             "canon", "encoding", "rehash",
                                             "entropy"))
def _tile_to_hashes(tile: jnp.ndarray, *, k, w, positions, span, canon,
                    encoding, rehash, entropy=False):
    if encoding == "bonsai":
        km, valid = encode_tile(tile, k=k, w=w, positions=positions, span=span,
                                canon=canon, entropy=entropy)
    else:
        km, valid = rolling.rolling_hash_tile(tile, k=k, kind=encoding,
                                              canon=canon, w=w)
    h = wang_hash(km) if rehash else km
    return h, valid


# Joined-bytes LRU: multi-k runs (mkdist) re-read every file once per k;
# record separators only need >= halo invalid bytes and LONGER is harmless
# (they stay invalid), so one cached join at _CACHE_SEP serves any
# sep_len <= _CACHE_SEP.  OPT-IN (mkdist enables it around its per-k loop;
# single-pass commands never re-read a path, so caching would only burn
# RSS).  Bounded by DASHING_TPU_JOIN_CACHE_MB; entries are keyed with the
# file's (mtime_ns, size) so a rewritten file is never served stale.
_CACHE_SEP = 63
_JOIN_CACHE: "OrderedDict[str, tuple]" = OrderedDict()
_JOIN_CACHE_LIMIT = int(float(os.environ.get(
    "DASHING_TPU_JOIN_CACHE_MB", "512")) * 1e6)
_JOIN_CACHE_ON = False


def set_join_cache(enabled: bool):
    """Toggle the joined-bytes cache (and drop it when disabling)."""
    global _JOIN_CACHE_ON
    _JOIN_CACHE_ON = enabled
    if not enabled:
        _JOIN_CACHE.clear()


def _path_stamp(path: str):
    try:
        return tuple((st.st_mtime_ns, st.st_size)
                     for st in (os.stat(sub) for sub in split_subpaths(path)))
    except OSError:
        return None


def _read_joined_uncached(path: str, sep_len: int) -> np.ndarray:
    from . import metrics
    with metrics.accum("host.parse"):
        return _read_joined_uncached_inner(path, sep_len)


def _read_joined_uncached_inner(path: str, sep_len: int) -> np.ndarray:
    from .io import native
    parts: List[np.ndarray] = []
    for sub in split_subpaths(path):
        nat = native.read_joined(sub, sep_len)
        if nat is not None:
            parts.append(nat[0])
        else:
            seqs = [seq for _, seq in fasta.read_records(sub)]
            parts.append(join_records(seqs, sep_len))
    if len(parts) == 1:
        return parts[0]
    sep = np.zeros(sep_len, np.uint8)
    glued: List[np.ndarray] = []
    for i, arr in enumerate(parts):
        if i:
            glued.append(sep)
        glued.append(arr)
    return np.concatenate(glued) if glued else np.zeros(0, np.uint8)


# File-level parse prefetch: while the device chews on file i, a worker
# thread parses+joins file i+1/i+2 (the reference gets this overlap from
# its OMP-dynamic file loop; ctypes/zlib release the GIL during the heavy
# parts).  Futures keyed by (path, sep_len); consumers pop-and-wait.
_PREFETCH: dict = {}
_PREFETCH_LOCK = __import__("threading").Lock()


def prefetch_join(executor, path: str, sep_len: int):
    """Schedule a background parse of `path` unless one is in flight.

    While the join cache is enabled (mkdist's per-k passes), cacheable
    files skip prefetch — the cache already holds their joined bytes at
    the wide _CACHE_SEP, and prefetched arrays carry the NARROW separator
    so they cannot enter the cache.  Files whose on-disk size exceeds the
    cache limit can never be cached, so they keep the prefetch overlap."""
    if _should_stream(path):
        return   # streaming files have their own in-stream read-ahead
    if _JOIN_CACHE_ON:
        try:
            total = sum(os.stat(s).st_size for s in split_subpaths(path))
        except OSError:
            return
        if total <= _JOIN_CACHE_LIMIT:
            return
    key = (path, sep_len)
    with _PREFETCH_LOCK:
        if key in _PREFETCH:
            return
        if len(_PREFETCH) > 8:       # bound leaks from never-consumed paths
            _PREFETCH.pop(next(iter(_PREFETCH)))[1].cancel()
        _PREFETCH[key] = (_path_stamp(path),
                          executor.submit(_read_joined_uncached, path,
                                          sep_len))


def clear_prefetch():
    """Drop every pending prefetch entry (end-of-phase cleanup).

    Abandoned futures can each pin a whole joined file in memory for the
    life of the process (cancel() is a no-op once running, but dropping
    the reference lets the array go as soon as the worker finishes)."""
    with _PREFETCH_LOCK:
        for _, fut in _PREFETCH.values():
            fut.cancel()
        _PREFETCH.clear()


def _prefetch_pop(path: str, sep_len: int):
    """Pop a prefetch future IF its file stamp still matches — a future
    abandoned by an earlier run must not serve stale bytes after the file
    was rewritten (long-lived library processes)."""
    with _PREFETCH_LOCK:
        hit = _PREFETCH.pop((path, sep_len), None)
    if hit is None:
        return None
    stamp, fut = hit
    if stamp is None or stamp != _path_stamp(path):
        fut.cancel()
        return None
    return fut


def _read_joined(path: str, sep_len: int) -> np.ndarray:
    """Logical path -> one separator-joined uint8 array.  Prefers the native
    C++ loader (io/native.py); falls back to the numpy parser."""
    if not _JOIN_CACHE_ON or sep_len > _CACHE_SEP or _JOIN_CACHE_LIMIT <= 0:
        fut = _prefetch_pop(path, sep_len)
        if fut is not None:
            return fut.result()
        return _read_joined_uncached(path, sep_len)
    stamp = _path_stamp(path)
    hit = _JOIN_CACHE.pop(path, None)          # pop+reinsert = LRU order
    if hit is not None and hit[0] == stamp and stamp is not None:
        arr = hit[1]
    else:
        # too-big-to-cache files may have an in-flight prefetch (narrow
        # separator; fine for THIS call, never inserted into the cache)
        fut = _prefetch_pop(path, sep_len)
        if fut is not None:
            return fut.result()
        arr = _read_joined_uncached(path, _CACHE_SEP)
        if stamp is None or arr.nbytes > _JOIN_CACHE_LIMIT:
            return arr
        # cached arrays are shared across callers (mkdist per-k passes):
        # freeze so an accidental in-place mutation raises instead of
        # corrupting every later pass served from the cache
        arr.setflags(write=False)
    _JOIN_CACHE[path] = (stamp, arr)
    total = sum(a[1].nbytes for a in _JOIN_CACHE.values())
    while total > _JOIN_CACHE_LIMIT and len(_JOIN_CACHE) > 1:
        _, old = _JOIN_CACHE.popitem(last=False)   # evict least-recent
        total -= old[1].nbytes
    return arr


def _encode_kw(params: SketchParams, sp: Spacer, rehash=None) -> dict:
    """THE encoder-kwargs builder: every sketch path derives its encode
    arguments here so a new encoder parameter cannot be missed at one of
    the (formerly 11) copy-pasted sites.  `rehash` overrides
    params.rehash where a path needs raw codes (wj labeling) or forced
    hashing (minhash families)."""
    return dict(k=sp.k, w=sp.w, positions=tuple(sp.positions), span=sp.c,
                canon=params.canon, encoding=params.encoding,
                rehash=params.rehash if rehash is None else rehash,
                entropy=params.entropy)


def _row_chunks(tiles: np.ndarray) -> Iterable[np.ndarray]:
    """Split (rows, C) tiles into MAX_ROWS chunks, padding each chunk's
    row count to the next power of two with all-'N' rows (invalid
    windows only) — a handful of jit shape variants instead of one per
    tail size."""
    for i in range(0, tiles.shape[0], MAX_ROWS):
        chunk = tiles[i:i + MAX_ROWS]
        rows = chunk.shape[0]
        target = 1 << max(rows - 1, 0).bit_length()
        if target != rows:
            pad = np.full((target - rows, chunk.shape[1]), ord("N"),
                          np.uint8)
            chunk = np.concatenate([chunk, pad])
        yield chunk


# ---------------------------------------------------------------------------
# Bounded-memory streaming ingest (VERDICT r4 weak #2).  Large files are
# parsed incrementally (native/fastx.cpp dtpu_stream_* or the Python
# _JoinStreamParser) and the joined stream cut into windows of exactly
# MAX_ROWS*CONTENT content bytes + halo, so window-wise tiling yields the
# SAME rows, in the same order and row-chunk alignment, as whole-file
# tiling — bitwise-identical sketches for every family, counting filters
# included.  Host peak memory ~O(window), matching the reference's
# O(record) kseq streaming (src/sketch_and_cmp.h:565-570).
# ---------------------------------------------------------------------------

_STREAM_THRESHOLD = int(float(os.environ.get(
    "DASHING_TPU_STREAM_THRESHOLD_MB", "128")) * 1e6)


def _should_stream(path: str) -> bool:
    mode = os.environ.get("DASHING_TPU_STREAM", "")
    if mode == "0":
        return False
    if mode in ("1", "force"):
        return True
    try:
        total = sum(os.stat(s).st_size for s in split_subpaths(path))
    except OSError:
        return False
    if _JOIN_CACHE_ON and total <= _JOIN_CACHE_LIMIT:
        # mkdist per-k passes reuse whole joined arrays from the cache;
        # only stream what the cache could never hold anyway
        return False
    return total > _STREAM_THRESHOLD


def _stream_joined_parts(path: str, sep_len: int) -> Iterable[np.ndarray]:
    """Incremental joined-byte stream for a logical path; concatenating
    the yields equals _read_joined_uncached(path, sep_len) exactly."""
    from . import metrics
    from .io import native
    sep = np.zeros(sep_len, np.uint8)
    for si, sub in enumerate(split_subpaths(path)):
        if si:
            yield sep
        gen = native.stream_joined(sub, sep_len)
        if gen is None:
            gen = fasta.stream_joined(sub, sep_len)
        while True:
            with metrics.accum("host.parse"):
                arr = next(gen, None)
            if arr is None:
                break
            yield arr


def _window_tiles(seg: np.ndarray, content: int, halo: int) -> np.ndarray:
    """Tile a FULL stream window (len == rows*content + halo exactly):
    row r covers seg[r*content : r*content + content + halo], no padding."""
    rows = (seg.size - halo) // content
    seq = np.ascontiguousarray(seg)
    stride = seq.strides[0]
    return np.lib.stride_tricks.as_strided(
        seq, shape=(rows, content + halo),
        strides=(content * stride, stride)).copy()


def _stream_windows(parts: Iterable[np.ndarray], W: int, halo: int):
    """Cut a byte stream into (window, is_full) pairs where full window s
    is joined[s*W : s*W + W + halo]; the final (partial) window is the
    remaining tail joined[f*W:]."""
    buf: List[np.ndarray] = []
    buflen = 0
    for arr in parts:
        if arr.size == 0:
            continue
        buf.append(arr)
        buflen += arr.size
        while buflen >= W + halo:
            seg = np.concatenate(buf) if len(buf) > 1 else buf[0]
            yield seg[:W + halo], True
            rest = seg[W:]
            buf = [rest]
            buflen = rest.size
    tail = (np.concatenate(buf) if len(buf) > 1
            else (buf[0] if buf else np.zeros(0, np.uint8)))
    yield tail, False


def _readahead(gen, depth: int = 2):
    """Run a generator in a producer thread with a bounded queue so parse/
    decompress overlaps device compute (the streaming analog of
    prefetch_join; the reference gets this from its OMP-dynamic file
    loop).  Exceptions propagate to the consumer; early consumer exit
    stops the producer promptly via the stop flag."""
    import queue
    import threading
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    SENT = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def work():
        try:
            for item in gen:
                if not put(item):
                    return
            put(SENT)
        except BaseException as exc:   # deliver parse errors to the consumer
            put(exc)

    t = threading.Thread(target=work, daemon=True,
                         name="dtpu-stream-readahead")
    t.start()
    try:
        while True:
            item = q.get()
            if item is SENT:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def _stream_file_tiles(path: str, sp: Spacer) -> Iterable[np.ndarray]:
    """Bounded-memory equivalent of the materializing _file_tiles body:
    same row chunks, bitwise, at ~O(window) host memory."""
    halo = sp.halo
    W = MAX_ROWS * CONTENT

    def chunks():
        for seg, full in _stream_windows(
                _stream_joined_parts(path, halo), W, halo):
            if full:
                # a full window is exactly MAX_ROWS (a power of two) rows:
                # one row chunk, no padding — same as _row_chunks would cut
                yield _window_tiles(seg, CONTENT, halo)
            elif seg.size:
                yield from _row_chunks(tile_sequence(seg, CONTENT, halo))

    yield from _readahead(chunks())


def _file_tiles(path: str, sp: Spacer) -> Iterable[np.ndarray]:
    """Yield (rows, CONTENT+halo) uint8 tiles covering a logical path.

    Files above DASHING_TPU_STREAM_THRESHOLD_MB (default 128, on-disk)
    stream through the incremental parser in O(window) host memory instead
    of materializing the whole decompressed file; the tiles are bitwise
    identical either way (DASHING_TPU_STREAM=0/1 forces the choice)."""
    if _should_stream(path):
        yield from _stream_file_tiles(path, sp)
        return
    joined = _read_joined(path, sp.halo)
    yield from _row_chunks(tile_sequence(joined, CONTENT, sp.halo))


def sketch_file_hll(path: str, params: SketchParams, p: int) -> np.ndarray:
    """Sketch one logical path into 2^p uint8 HLL registers (device fold)."""
    regs = sketch_file_hll_async(path, params, p)
    return np.clip(np.asarray(jax.device_get(regs)), 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Device register-row registry (mkdist compare-phase fuse, VERDICT r4 #4):
# the fused multi-k sketch step already holds every (path, k) register
# bank ON DEVICE; parking the rows here (keyed by the sketch-cache
# filename) lets the per-k compare passes slice a device-resident bank
# instead of re-uploading n*2^p bytes per k over a bandwidth-bound link.
# Rows are int8-clamped exactly like ops.pairwise._device_regs, so the
# compare path is bitwise-identical either way.  Bounded by
# DASHING_TPU_DEVICE_BANK_MB (default 1024); over budget, puts are
# dropped and the compare falls back to uploading.
# ---------------------------------------------------------------------------

_DEV_ROWS: dict = {}
_DEV_ROWS_BYTES = [0]
_DEV_ROWS_CAP = int(float(os.environ.get(
    "DASHING_TPU_DEVICE_BANK_MB", "1024")) * 1e6)


def device_rows_put(fname: str, dev) -> None:
    nbytes = int(np.prod(dev.shape))
    if _DEV_ROWS_BYTES[0] + nbytes > _DEV_ROWS_CAP:
        return
    _DEV_ROWS[fname] = dev
    _DEV_ROWS_BYTES[0] += nbytes


def device_rows_get(fname: str):
    return _DEV_ROWS.get(fname)


def device_rows_clear() -> None:
    _DEV_ROWS.clear()
    _DEV_ROWS_BYTES[0] = 0


def sketch_file_hll_multik(path: str, params_list: Sequence[SketchParams],
                           p: int, keep_device: bool = False):
    """Sketch one path at SEVERAL k values from ONE parse + ONE device
    upload per chunk (the mkdist --multik engine; the reference re-runs
    the whole tool per k, src/mkdistmain.cpp:106-114, and even our
    in-process per-k loop re-uploaded every tile per k — on a
    bandwidth-bound link the upload is the sketch phase's scarce
    resource, so K k-values for the price of one upload is a ~K-fold
    cut of it).

    Tiles are cut with the LARGEST k's halo; for smaller k the extra
    overlap duplicates a few windows at tile seams, which is exact for
    HLL registers (scatter-max is idempotent) — this function is
    therefore HLL-only by design.  Returns uint8 register arrays in
    params_list order, bitwise identical to per-k sketch_file_hll runs;
    with keep_device=True returns (host_list, device_int8_list) so the
    caller can park the rows in the device registry (device_rows_put)
    and spare the compare phase its per-k bank re-upload.
    """
    sps = [pa.spacer() for pa in params_list]
    sp_big = max(sps, key=lambda s: s.halo)
    regs = [jnp.zeros(1 << p, jnp.int32) for _ in params_list]
    from .ops.hll_update import _ROW, adaptive_cap
    seen = [0] * len(params_list)
    for tile in _file_tiles(path, sp_big):
        dev_tile = jnp.asarray(tile)
        for i, (pa, sp) in enumerate(zip(params_list, sps)):
            ucap = adaptive_cap(_ROW, 1 << p, seen[i])
            seen[i] += tile.shape[0] * (tile.shape[1] - sp.halo)
            regs[i] = _tile_to_registers(dev_tile, regs[i],
                                         **_encode_kw(pa, sp),
                                         p=p, ucap=ucap)
    host = [np.clip(np.asarray(jax.device_get(r)), 0, 255).astype(np.uint8)
            for r in regs]
    if keep_device:
        # int8-clamped exactly like ops.pairwise._device_regs (ranks are
        # <= 64, so min(.,127) never changes a legitimate value)
        dev = [jnp.minimum(r, 127).astype(jnp.int8) for r in regs]
        return host, dev
    return host


# ---------------------------------------------------------------------------
# Within-host multi-device sketching: the SAME tuned chunk steps, sharded
# by tile rows over the local device mesh with a register-max all-reduce
# per chunk (the multi-device form of the reference's OpenMP file/sequence
# parallelism, src/sketch_and_cmp.h:484-528).  Registers are bitwise
# identical to the single-device path: the threshold filter only ever
# SKIPS updates that cannot change a register, and max is associative.
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sharded_ascii_step(mesh, kw_items: tuple, p: int, ucap: int = 64):
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    kw = dict(kw_items)

    def local(tile, regs):
        # the replicated registers enter the per-shard update loops, whose
        # carries vary over 'd': mark them varying up front
        regs = jax.lax.pcast(regs, ("d",), to="varying")
        upd = _tile_to_registers(tile, regs, **kw, p=p, ucap=ucap)
        return jax.lax.pmax(upd, "d")

    return jax.jit(shard_map(local, mesh=mesh,
                             in_specs=(P("d", None), P()), out_specs=P()))


@functools.lru_cache(maxsize=None)
def _sharded_filtered_step(mesh, kw_items: tuple, p: int):
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    kw = dict(kw_items)

    def local(tile, mask, regs):
        regs = jax.lax.pcast(regs, ("d",), to="varying")
        h, valid = _tile_to_hashes(tile, **kw)
        upd = update_registers(regs, h, valid & mask, p)
        return jax.lax.pmax(upd, "d")

    return jax.jit(shard_map(local, mesh=mesh,
                             in_specs=(P("d", None), P("d", None), P()),
                             out_specs=P()))


def _sketch_mesh():
    from .parallel.mesh import local_mesh
    return local_mesh()


# ---------------------------------------------------------------------------
# pmax batching: with
# DASHING_TPU_PMAX_EVERY=N > 1, the per-chunk register all-reduce moves
# OUT of the chunk step — each device accumulates into its own (1, 2^p)
# bank row and a pmax merges every N chunks (and at stream end / on any
# fall-back to the unsharded path).  Register max is associative and
# commutative, so the final registers are bitwise identical for every N
# (pinned by tests/test_mesh_production.py); the collective count drops
# from one per chunk to one per N chunks.  Default 1 = merge per chunk
# (flip if pmax latency ever dominates on real hardware).
# ---------------------------------------------------------------------------


def _pmax_every() -> int:
    return max(1, int(os.environ.get("DASHING_TPU_PMAX_EVERY", "1")))


@functools.lru_cache(maxsize=None)
def _sharded_ascii_step_banks(mesh, kw_items: tuple, p: int, ucap: int = 64):
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    kw = dict(kw_items)

    def local(tile, banks):          # banks: (1, m) this device's partial
        upd = _tile_to_registers(tile, banks[0], **kw, p=p, ucap=ucap)
        return upd[None]

    return jax.jit(shard_map(local, mesh=mesh,
                             in_specs=(P("d", None), P("d", None)),
                             out_specs=P("d", None)))


@functools.lru_cache(maxsize=None)
def _banks_pmax(mesh):
    """All-reduce the per-device bank rows in place: every row becomes the
    elementwise max, so the banks stay in (D, m) form for the next chunk
    without a separate broadcast."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def local(banks):
        return jax.lax.pmax(banks, "d")

    return jax.jit(shard_map(local, mesh=mesh, in_specs=(P("d", None),),
                             out_specs=P("d", None)))


@functools.lru_cache(maxsize=None)
def _banks_merge(mesh):
    """(D, m) banks -> replicated merged (m,) registers."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def local(banks):
        return jax.lax.pmax(banks[0], "d")

    return jax.jit(shard_map(local, mesh=mesh, in_specs=(P("d", None),),
                             out_specs=P()))


@functools.lru_cache(maxsize=None)
def _banks_spread(mesh):
    """Replicated (m,) registers -> (D, m) banks (one copy per device)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    def local(regs):
        return regs[None]

    return jax.jit(shard_map(local, mesh=mesh, in_specs=(P(),),
                             out_specs=P("d", None)))


# ---------------------------------------------------------------------------
# Small-file batching: ONE dispatch sketches B single-chunk files at once
# into a (B, 2^p) register bank (bucket indices offset by file slot).  At
# 1k x 200 KB genomes per-file dispatch+pull round-trips dominate the
# sketch phase; a 64-file batch amortizes them 64x.  Fresh banks have min(regs)=0, so the threshold
# filter is useless here — a direct scatter-max is both simpler and faster.
# ---------------------------------------------------------------------------

def small_batch_size(p: int) -> int:
    """Files per batched dispatch: bounded by bank memory (4B * B * 2^p
    <= 64 MB), a multiple of 8.
    0 = batching off: at p >= 22 even 8 files blow the bound (a floor
    here once pinned multi-GiB banks at -S 24)."""
    b = min(64, (64 << 20) // (4 << p))
    return (b // 8) * 8


def _banks_from_idx_rank(idx, rank, file_id, p: int, B: int):
    """Scatter (rows, W) buckets/ranks into (B, 2^p) banks; file_id (rows,)
    partitions rows into files by index offset.  Fresh banks have
    min(regs)=0, so the threshold filter would be useless: direct scatter."""
    m = 1 << p
    flat_idx = (idx + file_id[:, None] * m).reshape(-1)
    regs = jnp.zeros(B * m, jnp.int32)
    regs = regs.at[flat_idx].max(rank.reshape(-1), mode="drop")
    return regs.reshape(B, m)


@functools.partial(jax.jit, static_argnames=("kw_items", "p", "B"))
def _batched_ascii_to_banks(tiles, file_id, *, kw_items: tuple, p: int,
                            B: int) -> jnp.ndarray:
    kw = dict(kw_items)
    h, valid = _tile_to_hashes(tiles, **kw)
    idx, rank = bucket_rank(h, p)
    rank = jnp.where(valid, rank, 0)
    return _banks_from_idx_rank(idx, rank, file_id, p, B)


@functools.lru_cache(maxsize=None)
def _sharded_batch_step(mesh, kw_items: tuple, p: int, B: int):
    """Row-sharded batched sketch: each device scatters its row stripe
    into its own bank copy; one pmax merges (file_id rides along sharded,
    so global file attribution is exact on every shard)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    kw = dict(kw_items)

    def local(tiles, file_id):
        h, valid = _tile_to_hashes(tiles, **kw)
        idx, rank = bucket_rank(h, p)
        rank = jnp.where(valid, rank, 0)
        banks = _banks_from_idx_rank(idx, rank, file_id, p, B)
        return jax.lax.pmax(banks, "d")

    return jax.jit(shard_map(local, mesh=mesh,
                             in_specs=(P("d", None), P("d")),
                             out_specs=P()))


def sketch_small_batch_async(chunks: np.ndarray, params: SketchParams,
                             p: int):
    """(B, R, C) stacked single-chunk tiles -> device (B, 2^p) banks."""
    sp = params.spacer()
    B, R, C = chunks.shape
    flat = chunks.reshape(B * R, C)
    file_id = np.repeat(np.arange(B, dtype=np.int32), R)
    mesh = _sketch_mesh()
    D = mesh.size if mesh is not None else 1
    sharded = D > 1 and (B * R) % D == 0
    kw = _encode_kw(params, sp)
    kw_key = tuple(sorted(kw.items()))
    if sharded:
        return _sharded_batch_step(mesh, kw_key, p, B)(flat, file_id)
    return _batched_ascii_to_banks(jnp.asarray(flat), jnp.asarray(file_id),
                                   kw_items=kw_key, p=p, B=B)


def sketch_chunks_async(chunks: Iterable[np.ndarray], params: SketchParams,
                        p: int):
    """Like sketch_file_hll_async but over an already-materialized chunk
    iterable (the small-file batcher peeks at the first chunks and hands
    the rest back here for multi-chunk files)."""
    return _sketch_chunk_stream(chunks, params, p)


def sketch_file_hll_async(path: str, params: SketchParams, p: int):
    """Like sketch_file_hll but returns the DEVICE registers without
    synchronizing, so callers can pipeline many files (jax dispatch is
    async; the transfer back is the only barrier).  With >1 local device,
    each chunk's tile rows are sharded over the mesh and partial registers
    merge with a max all-reduce (64 KB at p=14)."""
    sp = params.spacer()
    if params.use_counting_filter and params.min_count > 1:
        regs = jnp.zeros(1 << p, jnp.int32)
        kw = _encode_kw(params, sp)
        mesh = _sketch_mesh()
        D = mesh.size if mesh is not None else 1
        kw_key = tuple(sorted(kw.items()))
        for tile, mask in _count_filtered_tiles(path, params, sp):
            if D > 1 and tile.shape[0] % D == 0:
                # pass the mask as-is: the CM path yields a DEVICE array
                # and np.asarray here forced a synchronous pull + re-upload
                # per tile (the jitted shard_map reshards on device)
                regs = _sharded_filtered_step(mesh, kw_key, p)(
                    tile, mask, regs)
            else:
                h, valid = _tile_to_hashes(jnp.asarray(tile), **kw)
                regs = update_registers(regs, h, valid & mask, p)
        return regs
    return _sketch_chunk_stream(_file_tiles(path, sp), params, p)


def _sketch_chunk_stream(chunks: Iterable[np.ndarray],
                         params: SketchParams, p: int):
    """Fold a stream of (rows, C) tiles into device registers."""
    sp = params.spacer()
    regs = jnp.zeros(1 << p, jnp.int32)
    kw = _encode_kw(params, sp)
    mesh = _sketch_mesh()
    D = mesh.size if mesh is not None else 1
    kw_key = tuple(sorted(kw.items()))
    from .ops.hll_update import _ROW, adaptive_cap
    seen = 0
    # pmax batching state: banks != None means per-device partials are
    # pending a merge (DASHING_TPU_PMAX_EVERY chunks between collectives)
    every = _pmax_every() if D > 1 else 1
    banks = None
    pending = 0

    def merged():
        nonlocal regs, banks, pending
        if banks is not None:
            regs = _banks_merge(mesh)(banks)
            banks = None
        pending = 0
        return regs

    from . import metrics
    import time as _time
    mx_on = metrics.enabled()
    for tile in chunks:
        # shrink the top_k survivor capacity as the registers fill
        # (overflow only costs a full-scatter slab, never correctness)
        ucap = adaptive_cap(_ROW, 1 << p, seen)
        seen += tile.shape[0] * (tile.shape[1] - sp.halo)
        t_tile = _time.perf_counter() if mx_on else 0.0
        sharded = D > 1 and tile.shape[0] % D == 0
        use_banks = sharded and every > 1
        if use_banks and banks is None:
            banks = _banks_spread(mesh)(regs)
        if use_banks:
            banks = _sharded_ascii_step_banks(mesh, kw_key, p, ucap)(
                tile, banks)
        elif sharded:
            regs = _sharded_ascii_step(mesh, kw_key, p, ucap)(tile, regs)
        else:
            regs = _tile_to_registers(jnp.asarray(tile), merged(), **kw,
                                      p=p, ucap=ucap)
        if use_banks:
            pending += 1
            if pending >= every:
                # in-place all-reduce keeps the banks form for the next
                # chunk (no extra broadcast)
                banks = _banks_pmax(mesh)(banks)
                pending = 0
        if mx_on:
            metrics.add_time("sketch.dispatch",
                             _time.perf_counter() - t_tile, tile.nbytes)
    return merged()


@functools.partial(jax.jit, static_argnames=("p",))
def _wj_label_update(hi: jnp.ndarray, lo: jnp.ndarray, valid: jnp.ndarray,
                     p: int) -> jnp.ndarray:
    from .sketch.weighted import occurrence_labels_device
    from .ops.hll_update import update_from_idx_rank
    lab, sv = occurrence_labels_device((hi, lo), valid)
    idx, rank = bucket_rank(lab, p)
    rank = jnp.where(sv, rank, 0)
    return update_from_idx_rank(jnp.zeros(1 << p, jnp.int32), idx, rank)


# Largest k-mer stream sorted on device in one piece; bigger streams use
# the host path.  Chosen on the previous target; not measured on the H100.
WJ_DEVICE_MAX_KMERS = 16 * 1024 * 1024


def sketch_file_wj_hll(path: str, params: SketchParams, p: int
                       ) -> Optional[np.ndarray]:
    """Weighted (exact multiset) HLL registers, fully on device.

    The k-mer stream stays device-resident: one sort derives exact
    per-value occurrence indices (sketch/weighted.py) and the labeled
    elements scatter straight into registers — nothing is pulled to the
    host (the host path hauls every k-mer across the link).  Returns None
    when the file is too large for the device sort or the path is not
    enabled.  OPT-IN (DASHING_TPU_WJ_DEVICE=1): the labeling is verified
    bitwise against the host path, but whether the device sort's compile
    and run time beat the host path's transfer is not measured on the
    H100 yet (ROADMAP R4)."""
    if (os.environ.get("DASHING_TPU_WJ_DEVICE", "") in ("", "0")
            or params.use_counting_filter):
        # the counting filter's admit mask is host-side; fall back
        return None
    sp = params.spacer()
    kw = _encode_kw(params, sp, rehash=False)
    his, los, vs = [], [], []
    total = 0
    for tile in _file_tiles(path, sp):
        h, valid = _tile_to_hashes(jnp.asarray(tile), **kw)
        his.append(h[0].reshape(-1))
        los.append(h[1].reshape(-1))
        vs.append(valid.reshape(-1))
        total += his[-1].shape[0]
        if total > WJ_DEVICE_MAX_KMERS:
            return None
    if not his:
        return np.zeros(1 << p, np.uint8)
    hi = jnp.concatenate(his)
    lo = jnp.concatenate(los)
    v = jnp.concatenate(vs)
    n = hi.shape[0]
    N = 1 << max(n - 1, 0).bit_length()    # pow2 pad: bounded jit shapes
    if N != n:
        hi = jnp.pad(hi, (0, N - n))
        lo = jnp.pad(lo, (0, N - n))
        v = jnp.pad(v, (0, N - n))
    regs = _wj_label_update(hi, lo, v, p)
    return np.clip(np.asarray(jax.device_get(regs)), 0, 255).astype(np.uint8)


def sketch_file_bbmh_mins(path: str, params: SketchParams, p: int
                          ) -> Optional[np.ndarray]:
    """b-bit-MinHash bucket minima for one path, computed ON DEVICE.

    Exact unsigned-u64 scatter-min (ops/minhash_update.py) — bucket values
    identical to the host addh_np path bit for bit, but only the finished
    (2^p,) bank crosses the link instead of every k-mer (the per-kmer addh
    hot loop serves every sketch type in the reference,
    src/sketch_and_cmp.h:500-512).  None -> caller uses the host path
    (counting filter's admit mask is host-driven; p > 25 would overflow
    the int32 scatter index path)."""
    if (params.use_counting_filter and params.min_count > 1) or p > 25:
        return None
    from .ops.minhash_update import (empty_minhash_banks, minhash_banks_to_np,
                                     scatter_min_u64)
    sp = params.spacer()
    kw = _encode_kw(params, sp, rehash=True)
    mhi, mlo = empty_minhash_banks(1 << p)
    for tile in _file_tiles(path, sp):
        h, valid = _tile_to_hashes(jnp.asarray(tile), **kw)
        mhi, mlo = _bbmh_scatter_step(mhi, mlo, h, valid, p)
    return minhash_banks_to_np(mhi, mlo)


@functools.partial(jax.jit, static_argnames=("p",))
def _bbmh_scatter_step(mhi, mlo, h, valid, p: int):
    # one jitted step per tile: the idx/shift derivation ran eagerly
    # before, dispatching 2-3 extra device round-trips per chunk
    from .ops.minhash_update import scatter_min_u64
    idx = (h[0] >> (32 - p)).astype(jnp.int32)
    hv = u64.shl(h, p)
    return scatter_min_u64(mhi, mlo, idx, hv, valid)


_U64_MAX = np.uint64(0xFFFFFFFFFFFFFFFF)


def sketch_file_bottomk_values(path: str, params: SketchParams, kk: int
                               ) -> Optional[np.ndarray]:
    """kk smallest DISTINCT WangHash values of a path, device-reduced.

    Per chunk, lax.top_k keeps the 2*kk smallest-by-high-word ENTRIES;
    repeated k-mers consume slots, so the selection alone is duplicate-
    blind (a high-coverage read set could collapse 2*kk slots onto a
    handful of distinct values and silently miss true bottom-kk members).
    Coverage check per chunk: every entry whose high word is strictly
    below the selection cutoff H is guaranteed selected, so if >= kk
    distinct candidates sit below H (or the whole chunk fit in the
    slots), the true bottom-kk distinct values are all present; otherwise
    the chunk's full hash set is pulled and deduped exactly — slower but
    exact on pathological duplication.  The all-ones sentinel padding
    invalid lanes is filtered; a genuine all-ones hash value (P = 2^-64
    per element) would be dropped — the documented-negligible caveat of
    this path."""
    if params.use_counting_filter and params.min_count > 1:
        return None
    from .ops.minhash_update import bottomk_candidates
    sp = params.spacer()
    kw = _encode_kw(params, sp, rehash=True)
    vals = np.zeros(0, np.uint64)
    for tile in _file_tiles(path, sp):
        h, valid = _tile_to_hashes(jnp.asarray(tile), **kw)
        chi, clo, cnt = bottomk_candidates(h, valid, 2 * kk)
        # ONE device pull for candidates + count (each extra eager pull
        # costs a device round-trip per chunk)
        chi_np, clo_np, n_valid = jax.device_get((chi, clo, cnt))
        cand = ((np.asarray(chi_np, np.uint32).astype(np.uint64)
                 << np.uint64(32))
                | np.asarray(clo_np, np.uint32).astype(np.uint64))
        cand = cand[cand != _U64_MAX]
        distinct = np.unique(cand)
        n_valid = int(n_valid)
        if distinct.size and n_valid > cand.size:
            cutoff = np.uint64(cand.max()) >> np.uint64(32)
            n_below = int((distinct >> np.uint64(32) < cutoff).sum())
            if n_below < kk:
                distinct = np.unique(u64.to_np(h)[np.asarray(valid)])
        vals = np.union1d(vals, distinct)[:kk]
    return vals


def file_kmer_hashes(path: str, params: SketchParams) -> np.ndarray:
    """All (hashed or raw per params.rehash) k-mer values of a path, host u64.

    Feeds the exact-set backend and the minhash family.  Applies the count
    filter when configured.
    """
    sp = params.spacer()
    kw = _encode_kw(params, sp)
    outs = []
    if params.use_counting_filter and params.min_count > 1:
        for tile, mask in _count_filtered_tiles(path, params, sp):
            h, valid = _tile_to_hashes(jnp.asarray(tile), **kw)
            keep = np.asarray(valid & mask)
            outs.append(u64.to_np(h)[keep])
    else:
        for tile in _file_tiles(path, sp):
            h, valid = _tile_to_hashes(jnp.asarray(tile), **kw)
            outs.append(u64.to_np(h)[np.asarray(valid)])
    if not outs:
        return np.zeros(0, np.uint64)
    return np.concatenate(outs)


def file_raw_kmers(path: str, params: SketchParams) -> np.ndarray:
    """Encoded (unhashed) k-mer values — exact-set semantics (khset64_t
    stores raw k-mers: reference src/khset64.h:15 addh == insert)."""
    return file_kmer_hashes(path, dataclasses.replace(params, rehash=False))


# ---------------------------------------------------------------------------
# Count-min threshold filtering (--countmin / -y; reference
# src/sketch_and_cmp.h:347 `if(cm.addh(kmer) >= mincount) sketch.addh(kmer)`).
# Batched as two passes: count every k-mer of the file, then admit k-mers
# whose (over-)estimated multiplicity reaches min_count.  The admitted SET
# equals the reference's streaming semantics (an element enters the moment
# its count reaches the threshold; membership depends only on the final
# count), without the stream-order dependence.
# ---------------------------------------------------------------------------



def _cm_indices(h: u64.U64, nh: int, size_log2: int, seed: int):
    idxs = []
    for row in range(nh):
        hs = wang_hash(u64.xor(h, u64.const((seed + row * 0x9E3779B9) | 1)))
        idxs.append((hs[0] >> (32 - size_log2)).astype(jnp.int32))
    return jnp.stack(idxs)  # (nh, ...)


@functools.partial(jax.jit, static_argnames=("nh", "size_log2", "seed"))
def _cm_add(counts: jnp.ndarray, h: u64.U64, valid: jnp.ndarray,
            nh: int, size_log2: int, seed: int) -> jnp.ndarray:
    idx = _cm_indices(h, nh, size_log2, seed)
    ones = jnp.where(valid, 1, 0).reshape(-1).astype(jnp.int32)
    for row in range(nh):
        counts = counts.at[row].add(
            jnp.zeros_like(counts[row]).at[idx[row].reshape(-1)].add(ones))
    return counts


@functools.partial(jax.jit, static_argnames=("nh", "size_log2", "seed"))
def _cm_query(counts: jnp.ndarray, h: u64.U64, nh: int, size_log2: int,
              seed: int) -> jnp.ndarray:
    idx = _cm_indices(h, nh, size_log2, seed)
    est = None
    for row in range(nh):
        v = counts[row][idx[row]]
        est = v if est is None else jnp.minimum(est, v)
    return est


def _count_filtered_tiles(path: str, params: SketchParams, sp: Spacer):
    """Two-pass CM filter; yields (tile, admit-mask) per tile.

    DASHING_TPU_USE_HK=1 swaps the device count-min for the native
    HeavyKeeper (the runtime analog of the reference's compile-time
    -DDASHING_USE_HK CountingSketch switch, src/dashing.h:131-136)."""
    kw = _encode_kw(params, sp)
    if os.environ.get("DASHING_TPU_USE_HK", "") not in ("", "0"):
        yield from _hk_filtered_tiles(path, params, sp, kw)
        return
    nh, sz, seed = params.cm_nhashes, params.cm_size_log2, params.cm_seed
    counts = jnp.zeros((nh, 1 << sz), jnp.int32)
    # Bounded hash cache between the two passes: caching EVERY tile's
    # (h, valid) pinned ~9 B per window position in HBM for the whole
    # file (a 2 GB read set -> ~18 GB, device OOM); tiles past the
    # budget recompute their hashes in pass 2 instead — hashing is pure,
    # so the masks are identical, and the recompute costs far less than
    # the unbounded pin (the reference streams in bounded memory too).
    cached_h = {}
    budget = _CM_HASH_CACHE_BYTES
    for i, tile in enumerate(_file_tiles(path, sp)):
        h, valid = _tile_to_hashes(jnp.asarray(tile), **kw)
        counts = _cm_add(counts, h, valid, nh, sz, seed)
        cost = tile.size * 9       # 2x u32 hash words + 1 B validity
        if budget >= cost:
            cached_h[i] = (h, valid)
            budget -= cost
    for i, tile in enumerate(_file_tiles(path, sp)):
        if i in cached_h:
            h, valid = cached_h.pop(i)
        else:
            h, valid = _tile_to_hashes(jnp.asarray(tile), **kw)
        est = _cm_query(counts, h, nh, sz, seed)
        yield tile, (est >= params.min_count) & valid


_CM_HASH_CACHE_BYTES = 256 << 20   # two-pass filter hash-cache budget


def _hk_filtered_tiles(path: str, params: SketchParams, sp: Spacer, kw):
    """HeavyKeeper two-pass prefilter (sketch/heavykeeper.py).

    HK insertion is inherently stream-sequential (each probabilistic decay
    decision reads the running slot state), so the structure lives on the
    host — the same placement the reference gives its CountingSketch —
    and each tile's hashes cross the link once (up to the same bounded
    cache as the count-min path; past it pass 2 recomputes).  Geometry
    comes from the same -q/-t/-R knobs as the count-min path (the
    reference constructs either type from cmsize/nhashes,
    src/dashing.h:471-477)."""
    from .sketch.heavykeeper import HeavyKeeper
    hk = HeavyKeeper(params.cm_nhashes, params.cm_size_log2, params.cm_seed)
    cached = {}
    budget = _CM_HASH_CACHE_BYTES
    for i, tile in enumerate(_file_tiles(path, sp)):
        h, valid = _tile_to_hashes(jnp.asarray(tile), **kw)
        hv = u64.to_np(h)
        vm = np.asarray(valid)
        hk.add_np(hv[vm])
        cost = tile.size * 9
        if budget >= cost:
            cached[i] = (hv, vm)
            budget -= cost
    for i, tile in enumerate(_file_tiles(path, sp)):
        if i in cached:
            hv, vm = cached.pop(i)
        else:
            h, valid = _tile_to_hashes(jnp.asarray(tile), **kw)
            hv, vm = u64.to_np(h), np.asarray(valid)
        est = hk.query_np(hv.reshape(-1)).reshape(vm.shape)
        yield tile, (est >= params.min_count) & vm


# ---------------------------------------------------------------------------
# Batched per-record sketching: one sketch per sequence record, vectorized
# over a batch of records (replaces the reference's single-threaded
# per-record loop, sketch_by_seq_core src/sketch_and_cmp.h:540-602, and
# feeds readfilt-style per-read queries).
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("k", "w", "positions", "span",
                                             "canon", "encoding", "rehash",
                                             "p", "entropy"))
def _records_to_registers(tiles: jnp.ndarray, *, k, w, positions, span, canon,
                          encoding, rehash, p, entropy=False) -> jnp.ndarray:
    """(G, C) one row per record -> (G, 2^p) int32 registers."""
    h, valid = _tile_to_hashes(tiles, k=k, w=w, positions=positions, span=span,
                               canon=canon, encoding=encoding, rehash=rehash,
                               entropy=entropy)
    idx, rank = bucket_rank(h, p)
    rank = jnp.where(valid, rank, 0)

    def one(regs_row, idx_row, rank_row):
        return regs_row.at[idx_row].max(rank_row, mode="drop")

    regs = jnp.zeros((tiles.shape[0], 1 << p), jnp.int32)
    return jax.vmap(one)(regs, idx, rank)


MAX_RECORD_WIDTH = 65536


def _record_batches(seqs: List[bytes], halo: int, batch: int):
    """Group records into fixed-shape device batches.

    Yields (take, tiles): `take` indexes into seqs; `tiles` is a
    (rows_pow2, width_pow2) N-padded uint8 array, or None for batches of
    huge records (width would exceed MAX_RECORD_WIDTH) that callers should
    stream individually.  Length-sorting keeps the padded widths tight.
    """
    order = np.argsort([len(s) for s in seqs], kind="stable")
    pos = 0
    n = len(seqs)
    while pos < n:
        take = order[pos:pos + batch]
        pos += len(take)
        maxlen = max(len(seqs[i]) for i in take)
        width = 128
        while width < maxlen + halo:
            width *= 2
        if width > MAX_RECORD_WIDTH:
            yield take, None
            continue
        gpad = 8
        while gpad < len(take):
            gpad *= 2
        tiles = np.full((gpad, width), ord("N"), np.uint8)
        for row, i in enumerate(take):
            s = seqs[i]
            tiles[row, :len(s)] = np.frombuffer(s, np.uint8)
        yield take, tiles


def sketch_records_hll(seqs: List[bytes], params: SketchParams, p: int,
                       batch: int = 2048) -> np.ndarray:
    """Per-record HLL registers for a list of sequences -> (n, 2^p) uint8.

    Records are padded to a shared bucketed width; records longer than the
    width fall back to the streaming single-sketch path.
    """
    sp = params.spacer()
    kw = _encode_kw(params, sp)
    out = np.zeros((len(seqs), 1 << p), np.uint8)
    for take, tiles in _record_batches(seqs, sp.halo, batch):
        if tiles is None:
            for i in take:
                out[i] = sketch_file_seq(seqs[i], params, p)
            continue
        regs = _records_to_registers(jnp.asarray(tiles), **kw, p=p)
        out[take] = np.clip(np.asarray(regs)[:len(take)], 0, 255
                            ).astype(np.uint8)
    return out


@functools.partial(jax.jit, static_argnames=("p",))
def _idx_rank_masked(h, valid, p: int):
    # one jitted step: the eager bucket_rank + where dispatched several
    # extra device round-trips per record batch
    idx, rank = bucket_rank(h, p)
    return idx, jnp.where(valid, rank, 0)


def records_joint_triples(seqs: List[bytes], params: SketchParams,
                          ref_regs: np.ndarray, ref_hist: np.ndarray,
                          p: int, batch: int = 1024) -> np.ndarray:
    """Per-record joint-MLE triples vs ONE dense reference sketch -> (n, 3).

    The batched, sparse-query engine behind readfilt (reference
    src/readfilt.cpp:102-110): each record touches only ~len(record)
    buckets of the 2^p-register reference, so its statistics come from the
    reference histogram + corrections at the occupied buckets
    (sketch/sparse.py) — never materializing per-read dense registers.
    """
    from .sketch.sparse import level_window_bins, sparse_joint_triples
    from .sketch.hll import HLL, ertl_joint

    sp = params.spacer()
    kw = _encode_kw(params, sp)
    ref_regs_d = jnp.asarray(np.asarray(ref_regs, np.int32))
    ref_hist_np = np.asarray(ref_hist, np.float32)
    hist_slices: dict = {}
    ref_max = int(np.asarray(ref_regs).max(initial=0))
    qq = 64 - p
    out = np.zeros((len(seqs), 3), np.float64)
    for take, tiles in _record_batches(seqs, sp.halo, batch):
        if tiles is None:
            # huge records: dense per-record path
            ref_hll = HLL(p, regs=np.clip(np.asarray(ref_regs), 0, 255
                                          ).astype(np.uint8))
            for i in take:
                q = HLL(p, regs=sketch_file_seq(seqs[i], params, p))
                out[i] = ertl_joint(q, ref_hll)
            continue
        h, valid = _tile_to_hashes(jnp.asarray(tiles), **kw)
        idx, rank = _idx_rank_masked(h, valid, p)
        # level-window the joint MLE: bins above max(query rank, ref
        # register) carry no mass, and the Newton cost is linear in the
        # bin count (~halves it).  Costs one scalar pull per batch — the
        # per-batch tri pull already syncs, so the added latency is one
        # RTT against a larger in-jit saving.
        rank_max = int(jax.device_get(rank.max()))
        kb = level_window_bins(max(rank_max, ref_max), qq)
        if kb not in hist_slices:
            hist_slices[kb] = jnp.asarray(ref_hist_np[:kb])
        tri = sparse_joint_triples(idx, rank, ref_regs_d, hist_slices[kb],
                                   p, kb)
        out[take] = np.asarray(tri)[:len(take)]
    return out


def records_kmer_hashes(seqs: Sequence[bytes], params: SketchParams,
                        batch: int = 512) -> List[np.ndarray]:
    """Per-record (hashed or raw per params.rehash) k-mer values, batched
    on device like sketch_records_hll (per-record dispatches cost one
    device round-trip each).  Feeds the per-record counting filter of
    sketch_by_seq (reference src/sketch_and_cmp.h:568: the CM is CLEARED
    after every record, so multiplicity is within-record)."""
    sp = params.spacer()
    kw = _encode_kw(params, sp)
    out: List = [None] * len(seqs)
    for take, tiles in _record_batches(seqs, sp.halo, batch):
        if tiles is None:
            for i in take:
                out[i] = seq_kmer_hashes(seqs[i], params)
            continue
        h, valid = _tile_to_hashes(jnp.asarray(tiles), **kw)
        hv = u64.to_np(h)
        vv = np.asarray(valid)
        for slot, i in enumerate(take):
            out[i] = hv[slot][vv[slot]]
    return out


def seq_kmer_hashes(seq: bytes, params: SketchParams) -> np.ndarray:
    """All k-mer values of ONE long sequence (streamed tiles)."""
    sp = params.spacer()
    kw = _encode_kw(params, sp)
    outs = []
    tiles = tile_sequence(np.frombuffer(seq, np.uint8), CONTENT, sp.halo)
    for chunk in _row_chunks(tiles):
        h, valid = _tile_to_hashes(jnp.asarray(chunk), **kw)
        outs.append(u64.to_np(h)[np.asarray(valid)])
    return np.concatenate(outs) if outs else np.zeros(0, np.uint64)


def sketch_file_seq(seq: bytes, params: SketchParams, p: int) -> np.ndarray:
    """One long sequence -> 2^p uint8 registers (streamed tiles)."""
    sp = params.spacer()
    kw = _encode_kw(params, sp)
    regs = jnp.zeros(1 << p, jnp.int32)
    tiles = tile_sequence(np.frombuffer(seq, np.uint8), CONTENT, sp.halo)
    for chunk in _row_chunks(tiles):
        regs = _tile_to_registers(jnp.asarray(chunk), regs, **kw, p=p)
    return np.clip(np.asarray(jax.device_get(regs)), 0, 255).astype(np.uint8)
