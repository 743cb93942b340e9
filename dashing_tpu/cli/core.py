"""Shared CLI machinery: option tables, sketch-or-load, comparison driver.

Flag names, defaults and output formats mirror the reference CLI
(src/distmain.cpp:28-204, src/dashing.cpp:294-409, src/dashing.h:44-104).
"""
from __future__ import annotations

import dataclasses
import getopt
import gzip
import os
import sys
from typing import List, Optional, Sequence

import numpy as np

from .. import pipeline
from ..io import cache, distmat, fasta, paths
from ..ops import pairwise as pw
from ..sketch import estimators as est
from ..sketch.hll import HLL
from ..sketch.khset import KSet

# Sketch-type registry.  `arg` mirrors bytesl2_to_arg (reference
# src/sketch_and_cmp.h:40-74): one -S log2-bytes knob mapped per structure.
SKETCH_EXTS = {"hll": ".hll", "khset": ".khs", "bf": ".bf", "rmh": ".rmh",
               "bbmh": ".bmh", "crmh": ".crmh", "superminhash": ".bbs",
               "hmh": ".hmh", "wide_hll": ".whll", "cbbmh": ".cbmh"}

# block width of the host-side (batched numpy) compare engines; the
# multi-host stripe split for these families keys on the same value, so
# every process of a distributed run must see the same setting
# (env-tunable mostly so tests can split real work with tiny inputs)
HOST_COMPARE_TILE = int(os.environ.get("DASHING_TPU_HOST_COMPARE_TILE",
                                       "512"))


def eprint(*a, **kw):
    print(*a, file=sys.stderr, **kw)


@dataclasses.dataclass
class CommonOpts:
    k: int = 31
    wsz: int = 0
    spacing: str = ""
    sketch_size: int = 10          # -S, log2 bytes
    canon: bool = True
    encoding: str = "bonsai"
    estim: int = est.ERTL_MLE
    jestim: int = est.ERTL_MLE
    sketch_type: str = "hll"
    sketch_type_explicit: bool = False   # user passed a --use-* type flag
    nthreads: int = 1
    paths_file: str = ""
    prefix: str = ""
    suffix: str = ""
    cache_sketch: bool = False
    presketched: bool = False
    avoid_sorting: bool = False
    entropy_min: bool = False
    mincount: int = 5
    nhashes: int = 1
    cmsketchsize: int = -1
    use_counting_filter: bool = False
    sketch_by_fname: bool = False
    seed: int = 1337
    weighted_jaccard: bool = False
    exact_weighted: bool = False
    wj_cmsize: int = 22            # GlobalArgs weighted_jaccard_cmsize
    wj_nhashes: int = 10           # GlobalArgs weighted_jaccard_nhashes
    bbnbits: int = 16
    number_neighbors: int = 0
    nperbatch: int = 16


def hll_p_from_S(S: int) -> int:
    """HLL: p == -S (log2 bytes, 1 byte/register)."""
    return S


def parse_common(opts: CommonOpts, flag: str, val: str) -> bool:
    """Apply one long/short option shared across subcommands.  Returns True
    if consumed."""
    m = {
        "-k": ("k", int), "--kmer-length": ("k", int),
        "-w": ("wsz", int), "--window-size": ("wsz", int),
        "-s": ("spacing", str), "--spacing": ("spacing", str),
        "-S": ("sketch_size", int), "--sketch-size": ("sketch_size", int),
        "-p": ("nthreads", int), "--nthreads": ("nthreads", int),
        "-F": ("paths_file", str), "--paths": ("paths_file", str),
        "-P": ("prefix", str), "--prefix": ("prefix", str),
        "-x": ("suffix", str), "--suffix": ("suffix", str),
        "-c": ("mincount", int), "--min-count": ("mincount", int),
        "-q": ("nhashes", int), "--nhashes": ("nhashes", int),
        "-t": ("cmsketchsize", int), "--cm-sketch-size": ("cmsketchsize", int),
        "-R": ("seed", int), "--seed": ("seed", int),
        "-B": ("bbnbits", int), "--bbits": ("bbnbits", int),
    }
    if flag in m:
        name, conv = m[flag]
        setattr(opts, name, conv(val))
        return True
    flags = {
        "-C": ("canon", False), "--no-canon": ("canon", False),
        "-W": ("cache_sketch", True), "--cache-sketches": ("cache_sketch", True),
        "-H": ("presketched", True), "--presketched": ("presketched", True),
        "-n": ("avoid_sorting", True), "--avoid-sorting": ("avoid_sorting", True),
        "-g": ("entropy_min", True), "--by-entropy": ("entropy_min", True),
        "-y": ("use_counting_filter", True), "--countmin": ("use_counting_filter", True),
        "-N": ("sketch_by_fname", True), "--sketch-by-fname": ("sketch_by_fname", True),
        "--use-nthash": ("encoding", "nthash"),
        "--use-cyclic-hash": ("encoding", "cyclic"),
        "--wj": ("weighted_jaccard", True),
        "--wj-exact": ("exact_weighted", True),
        "--use-bb-minhash": ("sketch_type", "bbmh"), "-8": ("sketch_type", "bbmh"),
        "--use-range-minhash": ("sketch_type", "rmh"),
        # the reference declares this flag but ships it commented out
        # (src/dashing.cpp:282); ours works
        "--use-counting-range-minhash": ("sketch_type", "crmh"),
        # the reference registers COUNTING_BB_MINHASH (enum, .cbmh suffix,
        # FinalSketch overloads, src/dashing.h:218,231,315,358) but never
        # dispatches it (src/sketchcorecbbmh.cpp is a commented-out stub);
        # ours is live
        "--use-counting-bb-minhash": ("sketch_type", "cbbmh"),
        "--use-bloom-filter": ("sketch_type", "bf"),
        "--use-full-khash-sets": ("sketch_type", "khset"),
        "--use-full-hash-sets": ("sketch_type", "khset"),
        "--use-hash-sets": ("sketch_type", "khset"),
        "--hash-sets": ("sketch_type", "khset"),
        "--use-full-sets": ("sketch_type", "khset"),
        "--use-wide-hll": ("sketch_type", "wide_hll"),
        "--use-superminhash": ("sketch_type", "superminhash"),
        "--use-hyperminhash": ("sketch_type", "hmh"),
        "-E": ("estim", est.ORIGINAL), "--original": ("estim", est.ORIGINAL),
        "-I": ("estim", est.ERTL_IMPROVED), "--improved": ("estim", est.ERTL_IMPROVED),
        "-m": ("estim", est.ERTL_MLE), "--ertl-mle": ("estim", est.ERTL_MLE),
    }
    if flag in flags:
        name, v = flags[flag]
        setattr(opts, name, v)
        if name == "estim":
            opts.jestim = v
        elif name == "sketch_type":
            opts.sketch_type_explicit = True
        return True
    if flag in ("-J", "--ertl-joint-mle"):
        opts.jestim = est.ERTL_JOINT_MLE
        return True
    if flag == "--wj-cm-sketch-size":
        # setting the size implies weighted mode (reference distmain.cpp:84)
        opts.wj_cmsize = int(val)
        opts.weighted_jaccard = True
        return True
    if flag == "--wj-cm-nhashes":
        opts.wj_nhashes = int(val)
        opts.weighted_jaccard = True
        return True
    if flag == "--nearest-neighbors":
        opts.number_neighbors = int(val)
        return True
    if flag == "--nperbatch":
        # ACCEPTED-NO-OP (like -p): the reference's knob batches
        # parallel_fill rows for CPU cache locality (reference
        # distmat/distmat.h:481-509); the device engine's analog is the
        # compare tile width and the async tile window — neither
        # benefits from a per-run row-batch knob, so the flag parses and
        # is ignored.
        opts.nperbatch = max(int(val), 1)
        return True
    return False


def validate_k(opts: CommonOpts):
    if opts.k > 32 and opts.encoding == "bonsai":
        raise SystemExit("k must be <= 32 for non-rolling hashes.")
    if opts.k > 32 and opts.spacing:
        raise SystemExit("kmers must be unspaced for k > 32")
    if opts.encoding != "bonsai":
        # the rolling hashes consume contiguous windows; minimizer windows
        # (-w) apply to their hash stream, but spaced seeds and entropy
        # scoring are exact-encoder features — reject rather than silently
        # ignore (reference guard: src/distmain.cpp:101-104)
        if opts.spacing:
            raise SystemExit("spaced seeds require the exact (bonsai) "
                             "encoder; rolling hashes are contiguous")
        if opts.entropy_min:
            raise SystemExit("--by-entropy requires the exact (bonsai) "
                             "encoder; rolling windows minimize by hash")


def sketch_params(opts: CommonOpts, rehash: bool = True) -> pipeline.SketchParams:
    return pipeline.SketchParams(
        k=opts.k, w=opts.wsz, spacing=opts.spacing, canon=opts.canon,
        encoding=opts.encoding, rehash=rehash,
        min_count=opts.mincount,
        use_counting_filter=opts.use_counting_filter,
        entropy=opts.entropy_min,
        cm_size_log2=(opts.cmsketchsize if opts.cmsketchsize > 0 else 20),
        cm_nhashes=(opts.nhashes if opts.nhashes > 1 else 4),
        cm_seed=opts.seed)


def gather_inpaths(opts: CommonOpts, positional: List[str]) -> List[str]:
    inp = (paths.get_paths(opts.paths_file) if opts.paths_file
           else list(positional))
    return inp


# file magic -> sketch type, for -H convenience (the reference requires
# the matching type flag; we sniff and auto-correct with a warning)
_MAGIC_TYPES = {b"DTPUHLL1": "hll", b"DTPUBF01": "bf", b"DTPURMH1": "rmh",
                b"DTPUCRM1": "crmh", b"DTPUBBM1": "bbmh",
                b"DTPUCBB1": "cbbmh",
                b"DTPUWHL1": "wide_hll", b"DTPUHMH1": "hmh",
                b"DTPUSMH1": "superminhash", b"DTPUSMH2": "superminhash"}


def _sniff_sketch_type(path: str) -> Optional[str]:
    try:
        with gzip.open(path, "rb") as fp:
            t = _MAGIC_TYPES.get(fp.read(8))
    except OSError:
        return None
    if t is None and path.endswith(".khs"):
        return "khset"    # reference-compatible khset files carry no magic
    return t


def read_sketch_auto(path: str, sketch_type: str, explicit: bool = False):
    """Load a sketch file, sniffing its type from the magic.  When the
    sniffed type contradicts an EXPLICITLY requested one (a --use-* flag),
    fail loudly like the reference does on a type mismatch; auto-correct
    with a note only for the default type (ADVICE round 1)."""
    sniffed = _sniff_sketch_type(path) if isinstance(path, str) else None
    if sniffed and sniffed != sketch_type:
        if explicit:
            raise SystemExit(
                f"{path} is a {sniffed} sketch but {sketch_type} was "
                f"explicitly requested; drop the type flag to auto-detect "
                f"or re-sketch the input")
        eprint(f"Note: {path} is a .{SKETCH_EXTS[sniffed].lstrip('.')} "
               f"sketch; loading as {sniffed} (requested {sketch_type})")
        sketch_type = sniffed
    if sketch_type == "hll":
        return HLL.read(path)
    if sketch_type == "khset":
        return KSet.read(path)
    from ..sketch.setsketches import read_typed
    return read_typed(path, sketch_type)


def _cache_fname(path: str, opts: CommonOpts) -> str:
    """-W cache filename for a path (make_fname incl. the `.w.` quirk;
    weighted sketches get the .wj / .wj.exact extension prefix, reference
    src/dashing.h:347-350 SSS macro)."""
    sp = sketch_params(opts).spacer()
    ext = SKETCH_EXTS[opts.sketch_type]
    if opts.exact_weighted:
        ext = ".wj.exact" + ext
    elif opts.weighted_jaccard:
        ext = ".wj" + ext
    return cache.make_fname(path, hll_p_from_S(opts.sketch_size), sp.w,
                            opts.k, sp.c, opts.spacing, opts.suffix,
                            opts.prefix, opts.encoding, ext)


def sketch_or_load(path: str, opts: CommonOpts, use_filter: bool = False):
    """One logical path -> a sketch, honoring --presketched and -W cache."""
    params = sketch_params(opts)
    if use_filter or opts.use_counting_filter:
        params = dataclasses.replace(
            params, use_counting_filter=True,
            min_count=opts.mincount if opts.mincount > 1 else 2)
    if opts.presketched:
        return read_sketch_auto(path, opts.sketch_type,
                                opts.sketch_type_explicit)
    fname = _cache_fname(path, opts)
    if opts.cache_sketch and os.path.isfile(fname):
        sk = read_sketch_auto(fname, opts.sketch_type,
                              opts.sketch_type_explicit)
        from ..sketch.extra import DensifiedMinHash
        if not (opts.sketch_type == "superminhash"
                and isinstance(sk, DensifiedMinHash)):
            return sk
        # stale round-1 cache (DTPUSMH1 densified stand-in): silently
        # mixing it with fresh real-SuperMinHash sketches would abort in
        # check_compatible with an unhelpful 'mixed sketch types' —
        # rebuild and overwrite in the current format instead (ADVICE r2)
        eprint(f"Note: rebuilding stale DTPUSMH1 cache {fname} in the "
               "SuperMinHash (DTPUSMH2) format")
    sk = build_sketch(path, opts, params)
    if opts.cache_sketch:
        atomic_write_sketch(sk, fname)
    return sk


def atomic_write_sketch(sk, fname: str):
    """Write-then-rename: concurrent writers of the same cache file (other
    jobs, or other ranks in a multi-host run) each produce a complete file
    and the last rename wins, instead of interleaving into a corrupt one."""
    tmp = f"{fname}.tmp.{os.getpid()}"
    sk.write(tmp)
    os.replace(tmp, fname)


def sketch_jobs(indexed_paths, params, p: int, ex, lookahead: int = 2):
    """Yield (file_indices, device_handle_or_None) HLL sketch dispatch jobs.

    Consecutive SINGLE-chunk files of identical tile shape group into one
    batched dispatch (a (B, 2^p) register bank) — at 1k small genomes
    per-file dispatch+pull round-trips dominate the sketch phase.
    Multi-chunk files keep the
    per-file streaming path; empty files yield a None handle (zero
    registers).  `ex` drives the parse-prefetch worker."""
    import itertools
    sp = params.spacer()
    batch = pipeline.small_batch_size(p)
    group_idx: List[int] = []
    group_chunks: List[np.ndarray] = []

    def flush():
        if not group_idx:
            return None
        # pad partial groups UP to a power-of-two size (>=8) with all-'N'
        # dummy chunks (rank-0 everywhere: a no-op scatter): the batch
        # size is a static jit argument, so arbitrary tail sizes would
        # each compile a fresh executable; padding bounds the variants to
        # {8, 16, 32, 64} per tile shape
        b = 8
        while b < len(group_idx):
            b *= 2
        while len(group_chunks) < b:
            group_chunks.append(np.full(group_chunks[0].shape, ord("N"),
                                        np.uint8))
        job = (tuple(group_idx),
               pipeline.sketch_small_batch_async(
                   np.stack(group_chunks), params, p))
        group_idx.clear()
        group_chunks.clear()
        return job

    for pos, (i, path) in enumerate(indexed_paths):
        for _, nxt in indexed_paths[pos + 1:pos + 1 + lookahead]:
            pipeline.prefetch_join(ex, nxt, sp.halo)
        it = pipeline._file_tiles(path, sp)
        first = next(it, None)
        second = next(it, None)
        if first is None:
            j = flush()
            if j:
                yield j
            yield ((i,), None)
        elif second is None and batch >= 8:
            if group_chunks and group_chunks[0].shape != first.shape:
                j = flush()
                if j:
                    yield j
            group_idx.append(i)
            group_chunks.append(first)
            if len(group_idx) >= batch:
                j = flush()
                if j:
                    yield j
        else:
            # multi-chunk file, or batching off (large p: even 8 banks
            # would pin multi-GiB device buffers)
            j = flush()
            if j:
                yield j
            chunks = [first] if second is None else [first, second]
            yield ((i,), pipeline.sketch_chunks_async(
                itertools.chain(chunks, it), params, p))
    j = flush()
    if j:
        yield j


def filtered_jobs(indexed_paths, params, p: int, ex, lookahead: int = 2):
    """Per-file async HLL dispatch jobs for countmin-filtered files.

    The two-pass CM filter carries per-file counter state, so these can't
    join the batched banks — but they still prefetch the next files' parses
    and keep a bounded window of device work in flight."""
    sp = params.spacer()
    for pos, (i, path) in enumerate(indexed_paths):
        for _, nxt in indexed_paths[pos + 1:pos + 1 + lookahead]:
            pipeline.prefetch_join(ex, nxt, sp.halo)
        yield ((i,), pipeline.sketch_file_hll_async(path, params, p))


def _sketch_with_retry(path: str, params, p: int, attempts: int = 3):
    """Synchronously rebuild one file's HLL registers, retrying transient
    backend errors with a short backoff.  Used when an async handle's pull
    fails mid-drain: sketching is pure, so recomputation cannot change the
    result.  Raises the last error once attempts are exhausted (fail-loud,
    SURVEY.md sec 5.3)."""
    import time as _time
    import jax
    for attempt in range(attempts):
        try:
            return pipeline.sketch_file_hll(path, params, p)
        except jax.errors.JaxRuntimeError:
            if attempt == attempts - 1:
                raise
            _time.sleep(2.0 * (attempt + 1))


def device_hll_run(indexed_paths, opts: CommonOpts, put, filter_idx=None,
                   filt_min_count: Optional[int] = None):
    """The tuned HLL sketch engine over (index, path) pairs: parse
    prefetch, small-file batched banks, bounded async dispatch window,
    -W cache read/write — calling put(index, regs_uint8) as results land.

    One engine serves every HLL variant (plain, cached, countmin-filtered)
    the way the reference's single OMP-dynamic file loop serves all types
    (reference src/sketch_and_cmp.h:484-528).

    filter_idx: indices whose file gets the countmin filter (None -> all
    iff opts.use_counting_filter).  filt_min_count: admission threshold
    for filtered files (None -> opts.mincount floored at 2, the dist-mode
    rule mirroring sketch_or_load)."""
    import itertools
    import jax
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor
    p = hll_p_from_S(opts.sketch_size)
    if filt_min_count is None:
        filt_min_count = opts.mincount if opts.mincount > 1 else 2
    params_plain = dataclasses.replace(sketch_params(opts),
                                       use_counting_filter=False)
    params_filt = dataclasses.replace(sketch_params(opts),
                                      use_counting_filter=True,
                                      min_count=filt_min_count)
    if filter_idx is None:
        filter_idx = ({i for i, _ in indexed_paths}
                      if opts.use_counting_filter else frozenset())
    if filt_min_count <= 1:
        filter_idx = frozenset()    # threshold 1 admits everything: plain
    # Bounded dispatch window (the hll_main pattern): each in-flight handle
    # pins a 4*2^p-byte int32 register buffer on device PER FILE, so cap
    # the total at ~256 MiB instead of holding every file's buffer at once
    # (at p=20 and 1k genomes an unbounded list is ~4 GB of device int32).
    window_cap = max(4, min(64, (256 << 20) // (4 << p)))
    use_cache = opts.cache_sketch
    fnames = ({i: _cache_fname(path, opts) for i, path in indexed_paths}
              if use_cache else {})

    # file-level parse prefetch: a worker thread joins the NEXT files'
    # bytes while this thread packs/uploads the current one (the
    # reference's OMP-dynamic file loop overlap, host-side)
    ex = ThreadPoolExecutor(max_workers=2)
    try:
        plain, filt = [], []
        for i, path in indexed_paths:
            if use_cache and os.path.isfile(fnames[i]):
                put(i, read_sketch_auto(fnames[i], "hll",
                                        opts.sketch_type_explicit).regs)
                continue
            (filt if i in filter_idx else plain).append((i, path))
        # index -> (path, params) for transient-failure re-dispatch
        redo = {i: (path, params_plain) for i, path in plain}
        redo.update({i: (path, params_filt) for i, path in filt})

        def land(i, regs):
            if use_cache:
                atomic_write_sketch(HLL(p, opts.estim, opts.jestim, regs),
                                    fnames[i])
            put(i, regs)

        dq: deque = deque()
        inflight = [0]

        def drain():
            ids, h = dq.popleft()
            inflight[0] -= len(ids)
            if h is None:
                land(ids[0], np.zeros(1 << p, np.uint8))
                return
            try:
                from .. import metrics
                with metrics.accum("sketch.pull"):
                    arr = np.clip(np.asarray(jax.device_get(h)), 0, 255
                                  ).astype(np.uint8)
            except jax.errors.JaxRuntimeError as e:
                # Transient backend failure (an interrupted transfer or a
                # device-side FAILED_PRECONDITION) poisons only this
                # handle; the pipeline is
                # functional, so rebuilding the affected files is
                # idempotent (SURVEY.md sec 5.3 failure detection).
                eprint(f"Warning: device pull failed for {len(ids)} "
                       f"sketch(es) ({type(e).__name__}); re-dispatching")
                for i in ids:
                    pth, prm = redo[i]
                    land(i, _sketch_with_retry(pth, prm, p))
                return
            if len(ids) == 1 and arr.ndim == 1:
                land(ids[0], arr)
            else:
                for slot, i in enumerate(ids):
                    land(i, arr[slot].copy())

        for job in itertools.chain(
                sketch_jobs(plain, params_plain, p, ex),
                filtered_jobs(filt, params_filt, p, ex)):
            dq.append(job)
            inflight[0] += len(job[0])
            # strictly-greater: at `>=`, a full batch (batch == window_cap)
            # drained the job just dispatched, serializing host parse with
            # device compute; `>` keeps >= one job in flight (device
            # memory bound becomes window_cap + one batch)
            while inflight[0] > window_cap and dq:
                drain()
        while dq:
            drain()
    finally:
        ex.shutdown(wait=False)
        pipeline.clear_prefetch()


def _sketch_paths_generic(paths_list: List[str], opts: CommonOpts):
    """Weighted / non-HLL sketch-or-load with file-level parse prefetch:
    the host builders (weighted elements, minhash constructors) consume
    joined bytes, so overlapping the NEXT files' parse with this file's
    build recovers the pipeline overlap the device path gets for free."""
    if opts.presketched:
        return [sketch_or_load(p, opts) for p in paths_list]
    from concurrent.futures import ThreadPoolExecutor
    sp = sketch_params(opts).spacer()
    ex = ThreadPoolExecutor(max_workers=2)
    try:
        out = []
        for pos, path in enumerate(paths_list):
            for nxt in paths_list[pos + 1:pos + 3]:
                if not (opts.cache_sketch
                        and os.path.isfile(_cache_fname(nxt, opts))):
                    pipeline.prefetch_join(ex, nxt, sp.halo)
            out.append(sketch_or_load(path, opts))
        return out
    finally:
        ex.shutdown(wait=False)
        pipeline.clear_prefetch()


def sketch_paths(paths_list: List[str], opts: CommonOpts):
    """Sketch many logical paths, overlapping host parsing with device
    compute (the device analog of the reference's OMP-dynamic file loop +
    async writers, SURVEY.md sec 2.4 P1/P6).  EVERY HLL variant — plain,
    -W cached, countmin-filtered — flows through the tuned device engine;
    weighted and non-HLL types get parse prefetch around their builders."""
    device_hll = (opts.sketch_type == "hll" and not opts.presketched
                  and not opts.weighted_jaccard and not opts.exact_weighted)
    if not device_hll:
        return _sketch_paths_generic(paths_list, opts)
    from ..parallel import distributed
    p = hll_p_from_S(opts.sketch_size)
    nproc = distributed.process_count()
    if nproc > 1:
        # Multi-host sketch phase: each process sketches a stride of
        # the genome list, then ONE allgather-max rebuilds every sketch
        # on every process (rows this process didn't compute stay zero
        # and the elementwise max fills them in).
        n = len(paths_list)
        all_regs = np.zeros((n, 1 << p), np.uint8)
        mine = distributed.my_shard(list(enumerate(paths_list)))
        device_hll_run(mine, opts,
                       lambda i, regs: all_regs.__setitem__(i, regs))
        all_regs = distributed.global_register_max(all_regs).astype(np.uint8)
        return [HLL(p, opts.estim, opts.jestim, all_regs[i])
                for i in range(n)]
    out: List = [None] * len(paths_list)
    device_hll_run(list(enumerate(paths_list)), opts,
                   lambda i, regs: out.__setitem__(
                       i, HLL(p, opts.estim, opts.jestim, regs)))
    if opts.cache_sketch:
        # mkdist fuse: the fused presketch parked each (path, k) register
        # row on device keyed by its cache filename; attaching it here
        # lets the compare engines slice a device-resident bank instead
        # of re-uploading it (ops.pairwise._device_regs_for)
        for path, sk in zip(paths_list, out):
            dev = pipeline.device_rows_get(_cache_fname(path, opts))
            if dev is not None:
                sk.dev_regs = dev
    return out


def build_sketch(path: str, opts: CommonOpts, params: pipeline.SketchParams):
    if opts.weighted_jaccard or opts.exact_weighted:
        return _build_weighted(path, opts, params)
    if opts.sketch_type == "hll":
        p = hll_p_from_S(opts.sketch_size)
        regs = pipeline.sketch_file_hll(path, params, p)
        h = HLL(p, opts.estim, opts.jestim, regs)
        return h
    if opts.sketch_type == "khset":
        kmers = pipeline.file_raw_kmers(path, params)
        return KSet.from_values(kmers)
    from ..sketch.setsketches import build_typed
    return build_typed(opts.sketch_type, path, opts, params)


def _build_weighted(path: str, opts: CommonOpts, params: pipeline.SketchParams):
    """wj::WeightedSketcher equivalent: occurrence-labeled multiset elements
    fed into the base sketch (see sketch/weighted.py).

    --wj-exact HLL targets may run fully on device (opt-in,
    DASHING_TPU_WJ_DEVICE=1): exact counts match the host exact path
    bitwise, so caches stay interchangeable.  The CM-approximate --wj mode
    always uses the host path (its estimates are methodology, not just
    speed, so substituting exact counts would silently mix semantics)."""
    import dataclasses as _dc
    from ..sketch.weighted import weighted_elements
    if opts.sketch_type == "hll" and opts.exact_weighted:
        p = hll_p_from_S(opts.sketch_size)
        regs = pipeline.sketch_file_wj_hll(path, params, p)
        if regs is not None:
            return HLL(p, opts.estim, opts.jestim, regs)
    raw = pipeline.file_raw_kmers(path, _dc.replace(params, rehash=False))
    elements = weighted_elements(raw, exact=opts.exact_weighted,
                                 cmsize_log2=opts.wj_cmsize,
                                 nhashes=opts.wj_nhashes, seed=opts.seed)
    if opts.sketch_type == "hll":
        p = hll_p_from_S(opts.sketch_size)
        h = HLL(p, opts.estim, opts.jestim)
        h.add_np(elements)  # elements are already well-mixed hashes
        return h
    if opts.sketch_type == "khset":
        return KSet.from_values(elements)
    from ..sketch.setsketches import make_typed
    sk = make_typed(opts.sketch_type, opts)
    sk.addh_np(elements)
    sk.finalize()
    return sk


def check_compatible(sketches):
    """Fail cleanly on mixed sketch parameters (e.g. different -S among
    presketched inputs) instead of a shape error deep in the engine."""
    ps = {getattr(s, "p", None) for s in sketches}
    ps.discard(None)
    if len(ps) > 1:
        raise SystemExit(
            f"sketches have mixed precisions p={sorted(ps)}; re-sketch with "
            "a common -S or fold the larger ones down (dashing_tpu fold)")
    # family-specific geometry must match too — mixed values either
    # compare garbage silently (b-bit widths) or blow up with a shape
    # error deep in the batched engines (bloom bitset sizes):
    #   kk   bottom-k size      b        b-bit width / superminhash b
    #   nbits_log2, nhashes     bloom    regwidth  hyperminhash
    for attr, what in (("kk", "minhash sizes"), ("b", "register widths"),
                       ("nbits_log2", "bloom filter sizes"),
                       ("nhashes", "bloom hash counts"),
                       ("regwidth", "hyperminhash register widths")):
        vals = {getattr(s, attr, None) for s in sketches}
        vals.discard(None)
        if len(vals) > 1:
            raise SystemExit(
                f"sketches have mixed {what} {attr}={sorted(vals)}; "
                "re-sketch with common parameters")
    types = {type(s).__name__ for s in sketches}
    if len(types) > 1:
        raise SystemExit(f"mixed sketch types {sorted(types)} cannot be "
                         "compared")


def compare_condensed(sketches, result_type: int, k: int, estim: int,
                      jestim: int, out: Optional[np.ndarray] = None,
                      row_blocks=None) -> np.ndarray:
    """Symmetric all-pairs condensed vector; matmul engine for HLL-register
    types, batched numpy engines for the minhash/bloom families, per-pair
    loop only as a last resort.  `out` may be a memmap for out-of-core
    emission.  `row_blocks` (register families only) restricts to this
    process's tile-row stripes in the multi-host split."""
    from ..sketch.extra import WideHLL
    check_compatible(sketches)
    if isinstance(sketches[0], (HLL, WideHLL)):
        # WideHLL shares HLL register semantics (uint16 registers hold the
        # same rank values), so the matmul engine applies unchanged
        return pw.all_pairs_condensed(sketches, result_type, k, estim,
                                      jestim, out=out,
                                      row_blocks=row_blocks)
    n = len(sketches)
    ksinv = 1.0 / k
    if out is None:
        out = ((np.zeros if row_blocks is not None else np.empty)
               (n * (n - 1) // 2, np.float32))
    from ..sketch import batch_compare
    if batch_compare.supports(sketches):
        # row-blocked upper triangle: a full (n, n, 3) rectangle doubled
        # the comparisons and transiently held 24*n^2 bytes.  A block's
        # rows pack CONTIGUOUSLY in the condensed vector, so each block
        # lands with one device measure call and one slice store — and
        # `row_blocks` (the multi-host split, HOST_COMPARE_TILE-wide)
        # computes only this process's stripes.
        T = HOST_COMPARE_TILE
        blocks = (range(0, n, T) if row_blocks is None
                  else sorted(row_blocks))
        for i0 in blocks:
            rect = batch_compare.batch_triples(sketches[i0:i0 + T],
                                               sketches[i0:])
            rows = [rect[ii, ii + 1:] for ii in range(rect.shape[0])]
            tri_blk = np.concatenate(rows, axis=0)
            npairs = tri_blk.shape[0]
            if npairs == 0:
                continue              # final single-row block has no pairs
            # pad to a power of two: every block's pair count is distinct,
            # and measure_from_triples is jit — unpadded, each block would
            # trace+compile its own variant; pow2 bucketing bounds the
            # variants to ~log2(n^2)
            cap = 1
            while cap < npairs:
                cap *= 2
            if cap != npairs:
                tri_blk = np.concatenate(
                    [tri_blk, np.zeros((cap - npairs, 3), tri_blk.dtype)])
            start = (i0 * (2 * n - i0 - 1)) // 2
            out[start:start + npairs] = host_measure(
                tri_blk, result_type, ksinv)[:npairs]
        return out
    assert row_blocks is None, \
        "multi-host stripes need a batched or register-family engine"
    # batch ALL pair triples into one device call: a per-pair
    # measure_from_triples dispatch costs a device round trip
    tris = np.empty((n * (n - 1) // 2, 3), np.float64)
    pos = 0
    for i in range(n):
        for j in range(i + 1, n):
            tris[pos] = sketches[i].full_set_comparison(sketches[j])
            pos += 1
    out[:] = host_measure(tris, result_type, ksinv)
    return out


def compare_rect(refs, queries, result_type: int, k: int, estim: int,
                 jestim: int, ref_blocks=None) -> np.ndarray:
    from ..sketch.extra import WideHLL
    if isinstance(refs[0], (HLL, WideHLL)):
        return pw.rect_pairs(refs, queries, result_type, k, estim, jestim,
                             ref_blocks=ref_blocks)
    ksinv = 1.0 / k
    nq, nr = len(queries), len(refs)
    from ..sketch import batch_compare
    if ref_blocks is not None:
        # multi-host column stripes for the batched host engines: each
        # owned HOST_COMPARE_TILE-wide reference block fills its columns
        assert batch_compare.supports(refs), \
            "multi-host stripes need a batched engine"
        out = np.zeros((nq, nr), np.float32)
        for i0 in sorted(ref_blocks):
            sub = refs[i0:i0 + HOST_COMPARE_TILE]
            tris = batch_compare.batch_triples(sub, queries).transpose(
                1, 0, 2)
            out[:, i0:i0 + len(sub)] = np.asarray(
                host_measure(tris.reshape(-1, 3), result_type, ksinv),
                np.float32).reshape(nq, len(sub))
        return out
    # triple orientation matches partdist_loop: lhs = reference
    # (result_cmp(hlls[j], hq), reference src/dashing.h:678-681)
    rect = batch_compare.batch_triples(refs, queries)
    if rect is not None:
        tris = rect.transpose(1, 0, 2)
    else:
        tris = np.empty((nq, nr, 3), np.float64)
        for qi, qs in enumerate(queries):
            for rj, rs in enumerate(refs):
                tris[qi, rj] = rs.full_set_comparison(qs)
    # .copy(): np.asarray over a jax array is read-only, and NN mode
    # writes the diagonal
    out = np.asarray(host_measure(tris.reshape(-1, 3), result_type, ksinv),
                     np.float32).reshape(nq, nr).copy()
    return out


def host_nn_topk(refs, queries, result_type: int, k: int, estim: int,
                 jestim: int, nn: int, exclude_self: bool,
                 tile: int = HOST_COMPARE_TILE, ref_blocks=None):
    """Streaming k-NN for host-side sketch types (minhash/bloom/khset):
    ref-axis tiles through the batched triple engines + a stable host
    top-k merge — O(n_q * (nn + tile)) memory, never the full matrix
    (HLL-register types take pw.nn_topk on device; reference bounded
    heaps: src/sketch_and_cmp.h:712-783).

    Matches the dense argsort exactly including tie-break: within-tile
    stable argsort orders equal values by ascending ref index, and the
    cross-tile merge concatenates earlier tiles first, so stable sorting
    the catenation preserves ascending-index order at ties."""
    sim = pw.is_similarity(result_type)
    nq, nr = len(queries), len(refs)
    nn = min(nn, nr)
    worst = -np.inf if sim else np.inf
    best_v = np.full((nq, 0), worst, np.float32)
    best_i = np.zeros((nq, 0), np.int64)
    ref_starts = (range(0, nr, tile) if ref_blocks is None
                  else sorted(ref_blocks))
    for j0 in ref_starts:
        block = compare_rect(refs[j0:j0 + tile], queries, result_type, k,
                             estim, jestim)
        rt = block.shape[1]
        if exclude_self:
            for qi in range(max(j0, 0), min(j0 + rt, nq)):
                block[qi, qi - j0] = worst
        idx = np.argsort(-block if sim else block, axis=1,
                         kind="stable")[:, :nn]
        cat_v = np.concatenate(
            [best_v, np.take_along_axis(block, idx, 1)], axis=1)
        cat_i = np.concatenate([best_i, idx + j0], axis=1)
        order = np.argsort(-cat_v if sim else cat_v, axis=1,
                           kind="stable")[:, :nn]
        best_v = np.take_along_axis(cat_v, order, 1)
        best_i = np.take_along_axis(cat_i, order, 1)
    return pw.pad_nn_candidates(best_v, best_i, nn, worst)


def host_measure(tri: np.ndarray, result_type: int, ksinv: float) -> np.ndarray:
    """numpy mirror of pw.measure_from_triples for host-side sketch types."""
    import jax.numpy as jnp
    return np.asarray(pw.measure_from_triples(jnp.asarray(tri, jnp.float32),
                                              result_type, ksinv))


def batch_hll_reports(sketches) -> None:
    """Prime every HLL's cached cardinality with ONE device call over the
    stacked histograms (a per-sketch report() loop costs a device dispatch
    each)."""
    import jax.numpy as jnp
    groups = {}
    for i, sk in enumerate(sketches):
        if isinstance(sk, HLL) and sk._card is None:
            groups.setdefault((sk.p, sk.estim), []).append(i)
    for (p, method), idxs in groups.items():
        hists = np.stack([sketches[i].histogram() for i in idxs])
        cards = np.asarray(est.estimate(jnp.asarray(hists), p, method))
        for i, c in zip(idxs, cards):
            sketches[i]._card = float(c)


def emit_cardinalities(fp, names: Sequence[str], sketches, integer: bool = True,
                       use_scientific: bool = False):
    """dist-phase cardinality TSV: '#Path\\tSize (est.)' then '%s\\t%zu'
    (reference src/sketch_and_cmp.h:372-385; card uses float formats)."""
    batch_hll_reports(sketches)
    fp.write("#Path\tSize (est.)\n")
    import math
    for name, sk in zip(names, sketches):
        card = sk.report()
        if integer:
            # a saturated sketch (e.g. an overfull bloom filter) reports
            # inf; int(inf) would abort the run AFTER all sketching
            val = "inf" if not math.isfinite(card) else str(int(card))
            fp.write(f"{name}\t{val}\n")
        elif use_scientific:
            fp.write(f"{name}\t{card:0.12g}\n")
        else:
            fp.write(f"{name}\t{card:0.8f}\n")


def open_output(path: Optional[str], binary: bool = False):
    if not path or path == "-" or path == "/dev/stdout":
        return (sys.stdout.buffer if binary else sys.stdout), False
    return open(path, "wb" if binary else "w"), True
