"""dashing_tpu command-line interface.

Subcommand surface mirrors the reference binary (reference src/main.cpp:22-39):
sketch, dist/cmp/setdist, hll, union, view, fold, panel, card, printmat,
dist_by_seq/cmp_by_seq, sketch_by_seq/sbs — plus mkdist (--multik) and
flatten, and the readfilt side tool as a subcommand.

Run:  python -m dashing_tpu.cli <subcommand> [options...]
"""
from __future__ import annotations

import getopt
import gzip
import os
import sys
from typing import List, Optional

import numpy as np

from .. import __version__, compile_cache, metrics, pipeline
from ..io import cache, distmat, fasta, paths
from ..ops import pairwise as pw
from ..sketch import estimators as est
from ..sketch.hll import HLL
from ..sketch.khset import KSet
from . import core
from .core import CommonOpts, eprint

def _process_age_s() -> float:
    """Seconds since this PROCESS started (Linux /proc) — captures the
    interpreter+import+backend-init overhead that no in-module timestamp
    can see.  Returns -1 where /proc is unavailable."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        return -1.0

RESULT_TYPES = {
    "mash": pw.MASH_DIST, "ji": pw.JI, "sizes": pw.SIZES,
    "full_mash": pw.FULL_MASH_DIST,
    "full_containment_dist": pw.FULL_CONTAINMENT_DIST,
    "containment_index": pw.CONTAINMENT_INDEX,
    "containment_dist": pw.CONTAINMENT_DIST,
    "sym_containment_index": pw.SYMMETRIC_CONTAINMENT_INDEX,
    "sym_containment_dist": pw.SYMMETRIC_CONTAINMENT_DIST,
}

UT_TSV, BINARY, PHYLIP, FULL_TSV = 0, 1, 2, 3

DIST_LONG = [
    "avoid-sorting", "by-entropy", "cache-sketches", "countmin",
    "emit-binary", "full-mash-dist", "full-tsv", "no-canon", "phylip",
    "presketched", "sizes", "sketch-by-fname", "use-bb-minhash",
    "use-scientific", "bbits=", "cm-sketch-size=", "ertl-joint-mle",
    "ertl-mle", "improved", "kmer-length=", "min-count=", "nhashes=",
    "nthreads=", "original", "out-dists=", "out-sizes=", "paths=",
    "prefix=", "query-paths=", "seed=", "sketch-size=", "spacing=",
    "suffix=", "window-size=", "help", "use-range-minhash",
    "use-full-khash-sets", "use-full-hash-sets", "use-hash-sets",
    "hash-sets", "use-full-sets", "full-containment-dist",
    "use-bloom-filter", "use-nthash", "containment-index",
    "use-counting-range-minhash", "use-counting-bb-minhash",
    "containment-dist", "mash-dist", "symmetric-containment-index",
    "symmetric-containment-dist", "use-cyclic-hash", "wj-cm-sketch-size=",
    "wj-cm-nhashes=", "wj", "nearest-neighbors=", "wj-exact",
    "use-wide-hll", "use-superminhash", "use-hyperminhash",
    "defer-hll", "nperbatch=", "multik=",
]

DIST_SHORT = "n"  # no-arg -n (avoid-sorting) per DIST_LONG_OPTS
DIST_SHORT_OPTS = "Q:P:x:F:c:p:o:s:w:O:S:k:t:R:q:B:8TglICbMEeHJhZNyUmW?hn"


def _getopts(argv, short, long_):
    try:
        return getopt.gnu_getopt(argv, short, long_)
    except getopt.GetoptError as e:
        raise SystemExit(f"option error: {e}")


# ===========================================================================
# dist / cmp
# ===========================================================================

def dist_main(argv: List[str]) -> int:
    o = CommonOpts()
    result_type = pw.JI
    emit_fmt = UT_TSV
    use_scientific = False
    out_sizes: Optional[str] = None
    out_dists: Optional[str] = None
    querypaths: List[str] = []
    if not argv:
        _dist_usage()
    optlist, positional = _getopts(argv, DIST_SHORT_OPTS, DIST_LONG)
    for flag, val in optlist:
        if core.parse_common(o, flag, val):
            continue
        if flag in ("-M", "--mash-dist"):
            result_type = pw.MASH_DIST
        elif flag in ("-l", "--full-mash-dist"):
            result_type = pw.FULL_MASH_DIST
        elif flag in ("-Z", "--sizes"):
            result_type = pw.SIZES
        elif flag == "--containment-index":
            result_type = pw.CONTAINMENT_INDEX
        elif flag == "--containment-dist":
            result_type = pw.CONTAINMENT_DIST
        elif flag == "--full-containment-dist":
            result_type = pw.FULL_CONTAINMENT_DIST
        elif flag == "--symmetric-containment-index":
            result_type = pw.SYMMETRIC_CONTAINMENT_INDEX
        elif flag == "--symmetric-containment-dist":
            result_type = pw.SYMMETRIC_CONTAINMENT_DIST
        elif flag in ("-b", "--emit-binary"):
            emit_fmt = BINARY
        elif flag in ("-U", "--phylip"):
            emit_fmt = PHYLIP
        elif flag in ("-T", "--full-tsv"):
            emit_fmt = FULL_TSV
        elif flag in ("-e", "--use-scientific"):
            use_scientific = True
        elif flag == "-o":
            out_sizes = val
        elif flag == "-O":
            out_dists = val
        elif flag in ("-Q", "--query-paths"):
            querypaths = paths.get_paths(val)
        elif flag in ("-n", "--avoid-sorting"):
            o.avoid_sorting = True
        elif flag in ("-h", "-?", "--help"):
            _dist_usage()
    core.validate_k(o)
    inpaths = core.gather_inpaths(o, positional)
    if not inpaths:
        eprint("No paths. See usage.")
        _dist_usage()
    nq = len(querypaths)
    if nq == 0 and not pw.is_symmetric(result_type):
        eprint("Note: No query files provided, but an asymmetric distance was "
               "requested. Switching to a query/reference format with all "
               "references as queries.")
        querypaths = list(inpaths)
        nq = len(querypaths)
    if not o.presketched and not o.avoid_sorting:
        inpaths = paths.sort_paths_by_fsize(inpaths)
        querypaths = paths.sort_paths_by_fsize(querypaths)
    # the asymmetric auto-switch duplicates the path list; alias the
    # sketch OBJECTS instead of sketching every file twice (the sketch
    # phase is the dominant cost and the copies are identical)
    mirror_queries = bool(querypaths) and querypaths == inpaths \
        and not o.presketched
    allpaths = inpaths + ([] if mirror_queries else querypaths)

    # special case: one presketched file may be a stream of many sketches
    # (reference src/sketch_and_cmp.h:298-309)
    sketches = []
    names = list(allpaths)
    if o.presketched and len(allpaths) == 1:
        with gzip.open(allpaths[0], "rb") as fp:
            idx = 0
            while True:
                try:
                    sketches.append(core.read_sketch_auto(fp, o.sketch_type))
                except EOFError:
                    break
                idx += 1
        names = [str(i) for i in range(len(sketches))]
    else:
        with metrics.phase("sketch", items=len(allpaths), unit="files"):
            sketches = core.sketch_paths(allpaths, o)
    if mirror_queries:
        sketches = sketches + sketches       # aliased query half
        names = names + names
    for sk in sketches:
        if hasattr(sk, "estim"):
            sk.estim = o.estim
        if hasattr(sk, "jestim"):
            sk.jestim = o.jestim

    # Multi-host: the sketch phase above sharded+allgathered.  The
    # COMPARE phase is sharded too — every process computes a strided
    # set of tile-row stripes (SURVEY sec 2.4-P7 / 5.8, mirroring the
    # reference's parallel_fill stripe writer, distmat/distmat.h:459-512)
    # — while every output file stays rank 0's job (other ranks writing
    # the same -O/-o paths would race).  Register families stripe the
    # device engine (DEFAULT_TILE rows); the batched host engines
    # (minhash/bloom/...) stripe their own HOST_COMPARE_TILE blocks;
    # only the per-pair fallback (khset) keeps the compare on rank 0.
    from ..parallel import distributed
    from ..sketch import batch_compare
    from ..sketch.extra import WideHLL
    reg_family = bool(sketches) and isinstance(sketches[0], (HLL, WideHLL))
    shard_compare = (distributed.process_count() > 1 and bool(sketches)
                     and (reg_family or batch_compare.supports(sketches)))
    shard_tile = pw.DEFAULT_TILE if reg_family else core.HOST_COMPARE_TILE
    if not distributed.is_main() and not shard_compare:
        return 0

    if distributed.is_main():
        fp_sizes, close_sizes = core.open_output(out_sizes)
        core.emit_cardinalities(fp_sizes, names, sketches)
        if close_sizes:
            fp_sizes.close()

    if o.number_neighbors > 0:
        return _nn_emit(sketches, names, o, result_type, emit_fmt, out_dists,
                        nq, shard_compare)

    ref_sketches = sketches[:len(sketches) - nq] if nq else sketches
    ref_names = names[:len(names) - nq] if nq else names

    if nq:
        ref_blocks = (distributed.owned_tile_rows(len(ref_sketches),
                                                  shard_tile)
                      if shard_compare else None)
        mat = core.compare_rect(ref_sketches, sketches[len(sketches) - nq:],
                                result_type, o.k, o.estim, o.jestim,
                                ref_blocks=ref_blocks)
        if shard_compare:
            mat = distributed.combine_columns(mat, len(ref_sketches),
                                              shard_tile)
            if not distributed.is_main():
                return 0
        q_names = names[len(names) - nq:]
        if emit_fmt == BINARY:
            fp, close = core.open_output(out_dists, binary=True)
            fp.write(np.ascontiguousarray(mat, np.float32).tobytes())
            if close:
                fp.close()
            _write_labels(out_dists, names)
        else:
            fp, close = core.open_output(out_dists)
            distmat.emit_rect_tsv(fp, q_names, mat, use_scientific)
            if close:
                fp.close()
        return 0

    n = len(sketches)
    # Binary to a real file: stream tiles through an mmap-backed matrix
    # (the reference's ftruncate+mmap parallel_fill path,
    # distmat/distmat.h:193-243,459-512) instead of buffering in RAM.
    use_mmap = (emit_fmt == BINARY
                and out_dists not in (None, "-", "/dev/stdout"))
    row_blocks = (distributed.owned_tile_rows(n, shard_tile)
                  if shard_compare else None)
    if use_mmap and shard_compare:
        # rank-local stripe writes into ONE shared output file: rank 0
        # lays the file out, a barrier orders that before attaches, and
        # each rank's owned tile rows map to disjoint condensed ranges.
        # Stripe boundaries fall at arbitrary byte offsets, so distinct
        # PAGE CACHES (i.e. distinct machines) can clobber each other's
        # boundary pages on write-back — NFS gives no byte-range
        # coherence.  Shared-mmap stripes therefore require every rank
        # on ONE host (one page cache) unless DASHING_TPU_SHARED_MMAP=1
        # asserts a coherent parallel FS (Lustre/GPFS); otherwise fall
        # back to the stripe gather.  attach_binary_mmap additionally
        # validates the in-progress header so a stale same-sized file on
        # a rank-local filesystem cannot be silently striped into.
        import socket
        host = np.frombuffer(
            socket.gethostname().encode()[:64].ljust(64), np.uint8)
        hosts = distributed.allgather_np(host)
        one_host = bool((hosts == hosts[0]).all())
        forced = os.environ.get("DASHING_TPU_SHARED_MMAP", "") not in ("",
                                                                       "0")
        if one_host or forced:
            if distributed.is_main():
                mm = distmat.create_binary_mmap(out_dists, n)
            distributed.barrier("dashing_tpu_distmat_create")
            if not distributed.is_main():
                mm = distmat.attach_binary_mmap(out_dists, n)
        else:
            if distributed.is_main():
                eprint(f"note: ranks span multiple hosts; landing "
                       f"{out_dists} by stripe gather to rank 0 (set "
                       "DASHING_TPU_SHARED_MMAP=1 on a coherent "
                       "parallel filesystem for rank-local writes)")
            mm = None
            use_mmap = False
    else:
        mm = distmat.create_binary_mmap(out_dists, n) if use_mmap else None
    with metrics.phase("all-pairs compare", items=n * (n - 1) / 2,
                       unit="pairs"):
        cond = core.compare_condensed(sketches, result_type, o.k, o.estim,
                                      o.jestim, out=mm,
                                      row_blocks=row_blocks)
    if shard_compare:
        if use_mmap:
            mm.flush()
            distributed.barrier("dashing_tpu_distmat_fill")
        else:
            cond = distributed.combine_condensed(cond, n, shard_tile)
        if not distributed.is_main():
            return 0
    if emit_fmt == BINARY:
        if mm is not None:
            mm.flush()
            distmat.finalize_binary_mmap(out_dists)
        else:
            fp, close = core.open_output(out_dists, binary=True)
            distmat.write_binary(fp, cond, n)
            if close:
                fp.close()
        _write_labels(out_dists, names)
    elif emit_fmt == PHYLIP:
        fp, close = core.open_output(out_dists)
        distmat.emit_phylip(fp, names, cond, use_scientific)
        if close:
            fp.close()
    elif emit_fmt == FULL_TSV:
        fp, close = core.open_output(out_dists)
        distmat.emit_full_tsv(fp, names,
                              distmat.condensed_to_square(cond, n),
                              use_scientific)
        if close:
            fp.close()
    else:
        fp, close = core.open_output(out_dists)
        distmat.emit_ut_tsv(fp, names, cond, use_scientific)
        if close:
            fp.close()
    return 0


def _write_labels(out_dists: Optional[str], names):
    """Binary emission writes a .labels sidecar (reference
    src/distmain.cpp:191-202)."""
    label_path = (out_dists + ".labels") if out_dists else "unspecified"
    try:
        with open(label_path, "w") as fp:
            for nm in names:
                fp.write(nm + "\n")
    except OSError as e:
        eprint(f"warning: could not write labels file {label_path}: {e}")


def _nn_emit(sketches, names, o: CommonOpts, result_type: int, emit_fmt: int,
             out_dists: Optional[str], nq: int,
             shard_compare: bool = False) -> int:
    """k-NN mode (reference nndist_loop, src/sketch_and_cmp.h:712-783).
    TSV rows 'name\\tid:dist...' or binary (u32 n, u32 k, (f32,u32)[n*k])."""
    from ..parallel import distributed
    nn = o.number_neighbors
    n = len(sketches)
    nref = n - nq if nq else n
    possible = nref if nq else n
    npairs = nq if nq else n
    if nn > possible:
        eprint(f"Only reporting {possible} rather than {nn} neighbors due to "
               "their being only that many sets.")
        nn = possible
    refs = sketches if not nq else sketches[:nref]
    queries = sketches[nref:] if nq else sketches
    if isinstance(sketches[0], HLL):
        # streaming top-k: O(n_q * (nn + tile)) memory, never the full
        # matrix (reference's bounded heaps, sketch_and_cmp.h:712-783).
        # Multi-host: each process scans only its strided share of
        # reference tile columns, then one (nq, nn) candidate gather
        # merges the per-process lists on rank 0.
        ref_blocks = (distributed.owned_tile_rows(nref, pw.DEFAULT_TILE)
                      if shard_compare else None)
        vals, order = pw.nn_topk(refs, queries, result_type, o.k, o.estim,
                                 o.jestim, nn, exclude_self=not nq,
                                 ref_blocks=ref_blocks)
        if shard_compare:
            vals, order = distributed.combine_nn(
                vals, order, nn, pw.is_similarity(result_type))
            if not distributed.is_main():
                return 0
    else:
        # host-side sketch families stream ref-axis tiles through the
        # batched triple engines with the same bounded-memory merge
        # (WideHLL lands here too).  Multi-host: each process scans its
        # strided share of HOST_COMPARE_TILE ref blocks, then the same
        # candidate gather as the device path merges on rank 0 —
        # host_nn_topk's per-block compare_rect works for every family,
        # so any sharded run can split here.
        ref_blocks = (distributed.owned_tile_rows(nref,
                                                  core.HOST_COMPARE_TILE)
                      if shard_compare else None)
        vals, order = core.host_nn_topk(refs, queries, result_type, o.k,
                                        o.estim, o.jestim, nn,
                                        exclude_self=not nq,
                                        ref_blocks=ref_blocks)
        if shard_compare:
            vals, order = distributed.combine_nn(
                vals, order, nn, pw.is_similarity(result_type))
            if not distributed.is_main():
                return 0
    if emit_fmt == BINARY:
        fp, close = core.open_output(out_dists, binary=True)
        fp.write(np.uint32(npairs).tobytes())   # rows actually written
        fp.write(np.uint32(nn).tobytes())
        rec = np.zeros(npairs * nn, dtype=[("v", "<f4"), ("i", "<u4")])
        rec["v"] = vals.reshape(-1)
        rec["i"] = order.reshape(-1).astype(np.uint32)
        fp.write(rec.tobytes())
        if close:
            fp.close()
    else:
        fp, close = core.open_output(out_dists)
        fp.write("#File\tNeighbor ID:distance\t...\n")
        qoff = nref if nq else 0
        distmat.emit_nn_tsv(fp, names[qoff:qoff + npairs], vals, order)
        if close:
            fp.close()
    return 0


# ===========================================================================
# sketch
# ===========================================================================

SKETCH_LONG = [
    "countmin", "sketch-by-fname", "no-canon", "skip-cached", "by-entropy",
    "use-bb-minhash", "bbits=", "paths=", "prefix=", "nhashes=", "original",
    "improved", "ertl-joint-mle", "seed=", "sketch-size=", "kmer-length=",
    "min-count=", "nthreads=", "cm-sketch-size=", "spacing=", "window-size=",
    "suffix=", "wj-cm-sketch-size=", "wj-cm-nhashes=", "use-range-minhash",
    "use-full-khash-sets", "use-bloom-filter", "use-nthash",
    "use-cyclic-hash", "avoid-sorting", "wj", "wj-exact", "use-wide-hll",
    "use-counting-range-minhash", "use-counting-bb-minhash",
    "use-superminhash", "use-hyperminhash", "defer-hll", "help",
]


def sketch_main(argv: List[str]) -> int:
    o = CommonOpts()
    o.mincount = 1
    skip_cached = False
    output_file = ""
    optlist, positional = _getopts(
        argv, "n:P:F:o:p:x:R:s:S:k:w:H:q:B:8JbfjEIcCeh?", SKETCH_LONG)
    for flag, val in optlist:
        # sketch_main's short letters differ from dist_main's
        # (reference src/dashing.cpp:253-291): -b=countmin, -f=by-fname,
        # -c=skip-cached, -n=min-count, -q=cm size, -H=nhashes, -o=output.
        if flag == "-b":
            o.use_counting_filter = True
            continue
        if flag == "-f":
            o.sketch_by_fname = True
            continue
        if flag in ("-c", "--skip-cached"):
            skip_cached = True
            continue
        if flag == "-n":
            o.mincount = int(val)
            continue
        if flag == "-q":
            o.cmsketchsize = int(val)
            continue
        if flag == "-H":
            o.nhashes = int(val)
            continue
        if flag == "-o":
            output_file = val
            continue
        if flag == "--countmin":
            o.use_counting_filter = True
            continue
        if flag == "--sketch-by-fname":
            o.sketch_by_fname = True
            continue
        if flag == "--min-count":
            o.mincount = int(val)
            continue
        if core.parse_common(o, flag, val):
            continue
        if flag in ("-h", "-?", "--help"):
            _sketch_usage()
    core.validate_k(o)
    inpaths = core.gather_inpaths(o, positional)
    if not inpaths:
        eprint("No paths. See usage.")
        _sketch_usage()
    if not o.avoid_sorting:
        inpaths = paths.sort_paths_by_fsize(inpaths)
    params = core.sketch_params(o)
    sp = params.spacer()
    ext = core.SKETCH_EXTS[o.sketch_type]

    use_filter = [o.use_counting_filter or
                  (o.sketch_by_fname and fasta.fname_is_fq(p))
                  for p in inpaths]

    work = list(enumerate(inpaths))
    from ..parallel import distributed
    if distributed.process_count() > 1:
        if output_file:
            # single-stream output: one writer; other ranks would race on
            # the same gzip file
            if not distributed.is_main():
                return 0
        else:
            # per-file outputs: processes write disjoint strides of the
            # list (the reference's OMP-dynamic file loop, lifted to hosts)
            work = distributed.my_shard(work)

    fnames = {i: cache.make_fname(path, core.hll_p_from_S(o.sketch_size),
                                  sp.w, o.k, sp.c, o.spacing, o.suffix,
                                  o.prefix, o.encoding, ext)
              for i, path in work}
    results: dict = {}
    todo = []
    for i, path in work:
        if skip_cached and os.path.isfile(fnames[i]):
            if output_file:
                results[i] = core.read_sketch_auto(
                    fnames[i], o.sketch_type, o.sketch_type_explicit)
            continue
        todo.append((i, path))
    hll_fast = (o.sketch_type == "hll" and not o.weighted_jaccard
                and not o.exact_weighted)
    if hll_fast:
        # the tuned batched/prefetch/async device engine (one loop serves
        # plain and countmin-filtered files alike)
        p = core.hll_p_from_S(o.sketch_size)

        def put(i, regs):
            sk = HLL(p, o.estim, o.jestim, regs)
            if output_file:
                results[i] = sk
            else:
                core.atomic_write_sketch(sk, fnames[i])

        core.device_hll_run(
            todo, o, put,
            filter_idx={i for i, _ in todo if use_filter[i]},
            filt_min_count=o.mincount)
    else:
        import dataclasses as _dc
        for i, path in todo:
            pp = _dc.replace(params, use_counting_filter=use_filter[i],
                             min_count=o.mincount)
            sk = core.build_sketch(path, o, pp)
            if output_file:
                results[i] = sk
            else:
                core.atomic_write_sketch(sk, fnames[i])
    sketches = [results[i] for i in sorted(results)]
    if output_file:
        with gzip.open(output_file + ".labels.gz", "wt") as fp:
            for path in inpaths:
                fp.write(path + "\n")
        with gzip.open(output_file, "wb") as fp:
            for sk in sketches:
                sk.write_record(fp)
    eprint(f"Successfully finished sketching from {len(inpaths)} files")
    return 0


# ===========================================================================
# card / hll / union / view / fold / printmat / flatten
# ===========================================================================

def card_main(argv: List[str]) -> int:
    o = CommonOpts()
    use_scientific = False
    emit_binary = False
    out: Optional[str] = None
    querypaths: List[str] = []
    optlist, positional = _getopts(argv, DIST_SHORT_OPTS, DIST_LONG)
    for flag, val in optlist:
        if core.parse_common(o, flag, val):
            continue
        if flag in ("-b", "--emit-binary"):
            emit_binary = True
        elif flag in ("-e", "--use-scientific"):
            use_scientific = True
        elif flag == "-o":
            out = val
        elif flag in ("-Q", "--query-paths"):
            querypaths = paths.get_paths(val)
        elif flag in ("-n", "--avoid-sorting"):
            o.avoid_sorting = True
        elif flag in ("-h", "-?", "--help"):
            _dist_usage()
    core.validate_k(o)
    inpaths = core.gather_inpaths(o, positional)
    if not inpaths:
        eprint("No paths. See usage.")
        return 1
    if not o.presketched and not o.avoid_sorting:
        inpaths = paths.sort_paths_by_fsize(inpaths)
        querypaths = paths.sort_paths_by_fsize(querypaths)
    inpaths += querypaths
    sketches = core.sketch_paths(inpaths, o)
    from ..parallel import distributed
    if not distributed.is_main():
        return 0
    if emit_binary:
        fp, close = core.open_output(out, binary=True)
        core.batch_hll_reports(sketches)
        cards = np.asarray([s.report() for s in sketches], np.float32)
        fp.write(cards.tobytes())
        if close:
            fp.close()
    else:
        fp, close = core.open_output(out)
        core.emit_cardinalities(fp, inpaths, sketches, integer=False,
                                use_scientific=use_scientific)
        if close:
            fp.close()
    return 0


def hll_main(argv: List[str]) -> int:
    """One merged HLL over ALL inputs -> single cardinality
    (reference src/hllmain.cpp:4-39; default -S 24)."""
    o = CommonOpts()
    o.sketch_size = 24
    optlist, positional = _getopts(argv, "Cw:s:S:p:k:F:tfh?", ["help"])
    for flag, val in optlist:
        if flag in ("-t", "-f"):
            continue    # no-arg here (the reference declares but ignores them)
        if core.parse_common(o, flag, val):
            continue
        if flag in ("-h", "-?", "--help"):
            eprint("usage: hll [-k k] [-S p] [-F paths] files...")
            return 1
    inpaths = core.gather_inpaths(o, positional)
    if not inpaths:
        eprint("usage: hll [-k k] [-S p] [-F paths] files...")
        return 1
    core.validate_k(o)
    params = core.sketch_params(o)
    p = core.hll_p_from_S(o.sketch_size)
    regs = np.zeros(1 << p, np.uint8)
    # Multi-host: each process folds its stride of the file list, then one
    # register-max all-reduce merges the partials (the distributed form of
    # the reference's per-thread clone + merge, src/dashing.h:630-639).
    from ..parallel import distributed
    import jax
    from collections import deque
    # bounded dispatch window: hll defaults to -S 24, so each in-flight
    # handle pins a 64 MiB device register buffer — overlap host parsing
    # with device compute without holding every file's buffer at once
    window: deque = deque()
    WINDOW = 4
    mine = list(enumerate(distributed.my_shard(inpaths)))
    path_of = dict(mine)

    def drain_one():
        ids, h = window.popleft()
        if h is None:            # empty file
            return
        try:
            dev = np.clip(np.asarray(jax.device_get(h)), 0, 255
                          ).astype(np.uint8)
        except jax.errors.JaxRuntimeError as e:
            # transient backend failure: rebuild the affected files
            # synchronously (pure pipeline, idempotent; SURVEY.md 5.3)
            eprint(f"Warning: device pull failed for {len(ids)} file(s) "
                   f"({type(e).__name__}); re-dispatching")
            for i in ids:
                np.maximum(regs, core._sketch_with_retry(
                    path_of[i], params, p), out=regs)
            return
        if dev.ndim == 2:        # batched (B, m) bank: fold the files in
            dev = dev.max(axis=0)
        np.maximum(regs, dev, out=regs)

    from concurrent.futures import ThreadPoolExecutor
    ex = ThreadPoolExecutor(max_workers=2)
    try:
        # shared job generator: small files batch into (B, 2^p) banks —
        # the bank max-reduces into the single merged register set
        for ids, h in core.sketch_jobs(mine, params, p, ex):
            window.append((ids, h))
            if len(window) >= WINDOW:
                drain_one()
        while window:
            drain_one()
    finally:
        ex.shutdown(wait=False)
        pipeline.clear_prefetch()
    regs = distributed.global_register_max(regs).astype(np.uint8)
    h = HLL(p, o.estim, o.jestim, regs)
    if distributed.is_main():
        print(f"Estimated number of unique exact matches: {h.report():f}")
    return 0


def union_main(argv: List[str]) -> int:
    opath = "/dev/stdout"
    plist: List[str] = []
    sketch_type = "hll"
    type_explicit = False
    compression_level = 6
    optlist, positional = _getopts(argv, "p:b:o:F:zZ:rHh?", ["help"])
    for flag, val in optlist:
        if flag in ("-h", "--help", "-?"):
            _union_usage()
        elif flag == "-Z":
            compression_level = int(val)
        elif flag == "-o":
            opath = val
        elif flag == "-F":
            plist = paths.get_paths(val)
        elif flag == "-r":
            sketch_type, type_explicit = "rmh", True
        elif flag == "-H":
            sketch_type, type_explicit = "khset", True
        elif flag == "-b":
            # NB: reference -b takes the sketch path arg
            sketch_type, type_explicit = "bf", True
    plist += positional
    if not plist:
        _union_usage()
    from ..parallel import distributed
    if sketch_type == "hll" and distributed.process_count() > 1:
        # Each process merges its stride; one register-max all-reduce
        # replaces the reference's log2-depth OpenMP tree (union.cpp:11-24).
        mine = distributed.my_shard(plist)
        first = core.read_sketch_auto(plist[0], sketch_type, type_explicit)
        regs = np.zeros_like(first.regs)
        for path in mine:
            np.maximum(regs,
                       core.read_sketch_auto(path, sketch_type,
                                             type_explicit).regs,
                       out=regs)
        merged = HLL(first.p, first.estim, first.jestim,
                     distributed.global_register_max(regs).astype(np.uint8))
        if not distributed.is_main():
            return 0
    else:
        merged = core.read_sketch_auto(plist[0], sketch_type, type_explicit)
        from ..parallel.mesh import local_mesh, sharded_union, shard_rows
        mesh = local_mesh()
        if isinstance(merged, HLL) and mesh is not None and len(plist) > 1:
            # within-host mesh union: sketches sharded over 'd', one
            # register-max all-reduce (the reference's log2-depth OpenMP
            # tree, src/union.cpp:11-24, as one collective); rows pad
            # with zero registers (neutral under max) to the mesh width
            import jax.numpy as jnp
            regs = np.stack(
                [merged.regs] +
                [core.read_sketch_auto(path, sketch_type, type_explicit).regs
                 for path in plist[1:]]).astype(np.int32)
            pad = (-regs.shape[0]) % mesh.size
            if pad:
                regs = np.concatenate(
                    [regs, np.zeros((pad, regs.shape[1]), np.int32)])
            out = sharded_union(mesh)(shard_rows(mesh, jnp.asarray(regs)))
            merged.regs = np.clip(np.asarray(out), 0, 255).astype(np.uint8)
            merged._card = None
        else:
            for path in plist[1:]:
                merged += core.read_sketch_auto(path, sketch_type,
                                                type_explicit)
    if opath in ("-", "/dev/stdout"):
        # reference union gzopens stdout ("wb6"): the stream must be gzipped
        # or no other subcommand can read it back
        with gzip.GzipFile(fileobj=sys.stdout.buffer, mode="wb",
                           compresslevel=compression_level) as fp:
            merged.write_record(fp)
    else:
        # honor -Z gzip level (reference union.cpp compression flag)
        with gzip.open(opath, "wb", compresslevel=compression_level) as fp:
            merged.write_record(fp)
    return 0


def _view_dump(sk, fp) -> None:
    """Human-readable dump for any sketch family: native printf when the
    type has one (HLL/WideHLL register dumps, the reference surface —
    src/dashing.cpp:559-563), a generic parameter + array listing for the
    rest (the reference view is hll-only; every rebuild type is
    viewable)."""
    if hasattr(sk, "printf"):
        sk.printf(fp)
        return
    fp.write(type(sk).__name__)
    for name, val in sorted(vars(sk).items()):
        if name.startswith("_"):
            continue
        if isinstance(val, (int, float, bool, str)):
            fp.write(f" {name}={val}")
    fp.write("\n")
    for name, val in sorted(vars(sk).items()):
        if name.startswith("_") or not isinstance(val, np.ndarray):
            continue
        flat = val.reshape(-1)
        fp.write(f"{name} n={flat.size} dtype={flat.dtype}\n")
        for i in range(0, flat.size, 16):
            row = " ".join(str(v) for v in flat[i:i + 16])
            fp.write(f"{i}\t{row}\n")


# DTPU container header field names, by magic (spec: PARITY.md "DTPU
# sketch container spec").  Every container is a gzip member holding the
# 8-byte magic (7 family chars + 1 version digit) then LITTLE-ENDIAN
# fields; all but HLL use two u32s.
_HDR_FIELDS = {
    b"DTPUHLL1": ("p", "estim", "jestim", "flags"),          # BBBB + u32 rsvd
    b"DTPUBF01": ("nbits_log2", "nhashes"),
    b"DTPURMH1": ("k", "n_values"),
    b"DTPUCRM1": ("k", "n_values"),
    b"DTPUBBM1": ("p", "b"),
    b"DTPUCBB1": ("p", "b"),
    b"DTPUWHL1": ("p", "estim_jestim_packed"),
    b"DTPUHMH1": ("p", "regwidth"),
    b"DTPUSMH1": ("p", "b"),
    b"DTPUSMH2": ("p", "b"),
}


def _view_header(path: str, fp) -> None:
    """Dump the raw container header (magic, family, version, endianness,
    header fields, payload bytes) without parsing the payload — the
    self-description surface of the DTPU container spec."""
    import struct
    try:
        g = gzip.open(path, "rb")
        head = g.read(16)
    except OSError:
        # reference-compatible .khs files are gzipped too but carry no
        # magic; anything unreadable lands here
        raise SystemExit(f"view --header: {path} is not a gzip container")
    with g:
        magic = head[:8]
        fields = _HDR_FIELDS.get(magic)
        if fields is None and not path.endswith(".khs") and len(head) < 16:
            raise SystemExit(f"view --header: {path}: truncated container "
                             f"({len(head)} bytes)")
        if fields is not None and len(head) < 16:
            raise SystemExit(f"view --header: {path}: truncated "
                             f"{magic.decode(errors='replace')} header "
                             f"({len(head)} bytes)")
        if fields is None:
            if path.endswith(".khs"):
                if len(head) < 8:
                    raise SystemExit(f"view --header: {path}: truncated "
                                     ".khs header")
                n = struct.unpack("<Q", head[:8])[0]
                rest = len(head) - 8 + sum(
                    len(c) for c in iter(lambda: g.read(1 << 20), b""))
                fp.write(f"{path}\tformat=khs (reference khset64, no magic)"
                         f"\tendian=little\tn_keys={n}"
                         f"\tpayload_bytes={rest}\n")
                return
            raise SystemExit(
                f"view --header: {path}: unknown magic {head[:8]!r}")
        family = core._MAGIC_TYPES.get(magic, "khset")
        version = chr(magic[7])
        if magic == b"DTPUHLL1":
            vals = struct.unpack("<BBBBI", head[8:16])[:4]
            hdr_len = 16
        else:
            vals = struct.unpack("<II", head[8:16])
            hdr_len = 16
        rest = len(head) - hdr_len + sum(
            len(c) for c in iter(lambda: g.read(1 << 20), b""))
        kv = "\t".join(f"{k}={v}" for k, v in zip(fields, vals))
        fp.write(f"{path}\tmagic={magic.decode()}\tfamily={family}"
                 f"\tversion={version}\tendian=little\t{kv}"
                 f"\tpayload_bytes={rest}\n")


def view_main(argv: List[str]) -> int:
    # single-writer tool: under jax.distributed only rank 0 runs it
    # (no sharded phase here; extra ranks would duplicate the output)
    from ..parallel import distributed
    if not distributed.is_main():
        return 0
    header_only = False
    paths_ = []
    for a in argv:
        if a in ("--header", "-H"):
            header_only = True
        else:
            paths_.append(a)
    if not paths_:
        raise SystemExit("Usage: view [--header] f1.hll [f2.bf ...] "
                         "(type auto-detected from the file magic)")
    for path in paths_:
        if header_only:
            _view_header(path, sys.stdout)
        else:
            _view_dump(core.read_sketch_auto(path, "hll"), sys.stdout)
    return 0


def fold_main(argv: List[str]) -> int:
    # single-writer tool: under jax.distributed only rank 0 runs it
    # (no sharded phase here; extra ranks would duplicate the output)
    from ..parallel import distributed
    if not distributed.is_main():
        return 0
    out, inp, destp = "/dev/stdout", "/dev/stdin", -1
    optlist, positional = _getopts(argv, "p:o:h?", ["help"])
    for flag, val in optlist:
        if flag == "-o":
            out = val
        elif flag == "-p":
            destp = int(val)
        else:
            eprint("Usage: fold [-o out] [-p destp] in.hll")
            return 1
    if positional:
        inp = positional[0]
    # register-precision fold is defined for the HLL-register family
    # (hll + wide_hll); other families fail with a type message instead
    # of a bad-magic traceback.  Streams (/dev/stdin) skip the sniff —
    # it would consume the magic bytes — and parse as plain hll.
    h = (core.read_sketch_auto(inp, "hll") if os.path.isfile(inp)
         else HLL.read(inp))
    if not hasattr(h, "compress"):
        raise SystemExit(f"fold: {type(h).__name__} sketches have no "
                         "precision fold (only hll/wide_hll registers do)")
    if destp <= 0:
        destp = h.p - 1
    h.compress(destp).write(out if out != "-" else "/dev/stdout")
    return 0


def printmat_main(argv: List[str]) -> int:
    # single-writer tool: under jax.distributed only rank 0 runs it
    # (no sharded phase here; extra ranks would duplicate the output)
    from ..parallel import distributed
    if not distributed.is_main():
        return 0
    use_scientific = False
    outpath = ""
    optlist, positional = _getopts(argv, "o:sh?", ["help"])
    for flag, val in optlist:
        if flag == "-o":
            outpath = val
        elif flag == "-s":
            use_scientific = True
        else:
            eprint("printmat <binary matrix> [-o out] [-s]")
            return 1
    if not positional:
        eprint("printmat <binary matrix> [-o out] [-s]")
        return 1
    fp, close = core.open_output(outpath or None)
    distmat.print_binary(positional[0], fp, use_scientific)
    if close:
        fp.close()
    return 0


def flatten_main(argv: List[str]) -> int:
    # single-writer tool: under jax.distributed only rank 0 runs it
    # (no sharded phase here; extra ranks would duplicate the output)
    from ..parallel import distributed
    if not distributed.is_main():
        return 0
    optlist, positional = _getopts(argv, "o:k:h?", ["help"])
    out = "flattened.bin"
    ks: List[int] = []
    for flag, val in optlist:
        if flag == "-o":
            out = val
        elif flag == "-k":
            ks = [int(x) for x in val.split(",")]
    if not positional or len(ks) != len(positional):
        eprint("flatten -o out -k k1,k2,... mat1 mat2 ...")
        return 1
    return distmat.flatten_all(positional, out, ks)


# ===========================================================================
# mkdist (--multik): per-k matrices + flatten, in-process (the reference
# shells out to itself per k, reference src/mkdistmain.cpp:106-114).
# ===========================================================================

def _mkdist_presketch(rest: List[str], ks: List[int]):
    """Fused multi-k sketch pre-seed for mkdist.

    Sketches every input at every missing k via
    pipeline.sketch_file_hll_multik (one parse + one device upload per
    chunk for ALL ks) and writes the results into the sketch cache the
    subsequent per-k dist passes read.  Returns (extra_dist_args,
    cleanup_fn); (None, None) when the configuration is not fusable —
    the per-k loop then behaves exactly as before.  Eligibility is the
    plain-HLL bonsai path only: the seam-duplication trick is exact for
    register max, not for counting structures, and k>32 uses the rolling
    encoders with different tiling."""
    import dataclasses
    import shutil
    import tempfile
    from ..parallel import distributed
    if os.environ.get("DASHING_TPU_NO_MULTIK_FUSE", "") not in ("", "0"):
        return None, None          # explicit opt-out (A/B + escape hatch)
    if distributed.process_count() > 1:
        return None, None          # per-k dist passes handle sharding
    o = CommonOpts()
    try:
        optlist, positional = _getopts(list(rest), DIST_SHORT_OPTS,
                                       DIST_LONG)
    except SystemExit:
        return None, None
    for flag, val in optlist:
        if core.parse_common(o, flag, val):
            continue
        if flag in ("-Q", "--query-paths"):
            return None, None      # query set would need seeding too
    if (o.sketch_type != "hll" or o.weighted_jaccard or o.exact_weighted
            or o.use_counting_filter or o.presketched or o.sketch_by_fname
            or o.encoding != "bonsai" or o.entropy_min):
        return None, None
    if not ks or not all(4 <= k <= 32 for k in ks):
        return None, None
    inpaths = core.gather_inpaths(o, positional)
    if not inpaths:
        return None, None
    extra: List[str] = []
    cleanup = None
    if not o.cache_sketch:
        # the user did not ask for -W: seed a private cache dir and
        # thread it through the per-k dist calls, then remove it
        tmpdir = tempfile.mkdtemp(prefix="dashing_tpu_mkdist_")
        o.prefix = tmpdir
        o.cache_sketch = True
        extra = ["-W", "-P", tmpdir]
        cleanup = lambda: shutil.rmtree(tmpdir, ignore_errors=True)
    p = core.hll_p_from_S(o.sketch_size)
    try:
        for path in inpaths:
            todo = []
            for k in ks:
                o_k = dataclasses.replace(o, k=k)
                fname = core._cache_fname(path, o_k)
                if os.path.isfile(fname):
                    continue       # an existing user cache entry wins
                todo.append((core.sketch_params(o_k), fname))
            if not todo:
                continue
            regs_list, dev_list = pipeline.sketch_file_hll_multik(
                path, [t[0] for t in todo], p, keep_device=True)
            for (_, fname), regs, dev in zip(todo, regs_list, dev_list):
                core.atomic_write_sketch(HLL(p, o.estim, o.jestim, regs),
                                         fname)
                # park the device row: the per-k compare passes then slice
                # a device-resident bank instead of re-uploading n*2^p
                # bytes per k (VERDICT r4 #4)
                pipeline.device_rows_put(fname, dev)
    except Exception as exc:       # pre-seed is an optimization only
        eprint(f"note: fused multi-k presketch failed ({exc}); "
               "falling back to per-k sketching")
        pipeline.device_rows_clear()
        if cleanup:
            cleanup()
        return None, None
    return extra, cleanup


def mkdist_main(argv: List[str]) -> int:
    multik = None
    jukes_cantor = False
    rest = []
    i = 0
    while i < len(argv):
        a = argv[i]
        if a == "--multik":
            multik = argv[i + 1]
            i += 2
            continue
        if a.startswith("--multik="):
            multik = a.split("=", 1)[1]
            i += 1
            continue
        if a == "--jukes-cantor":
            jukes_cantor = True
            i += 1
            continue
        rest.append(a)
        i += 1
    if not multik:
        eprint("mkdist: --multik <outpref>,<start>,<end>[,<step>] plus dist "
               "options")
        return 1
    parts = multik.split(",")
    outpref, s, e = parts[0], int(parts[1]), int(parts[2])
    step = int(parts[3]) if len(parts) > 3 else (1 if e > s else -1)
    if (e > s) != (step > 0):
        step = -step
    ks = list(range(s, e, step))
    fpaths = []
    # per-k passes re-read every input: cache the joined bytes across ks
    pipeline.set_join_cache(True)
    # fused multi-k sketching: ONE parse + ONE device upload serves every
    # k (exact for HLL registers); pre-seeds the sketch cache the per-k
    # dist passes then hit.  extra = cache flags to thread through; None
    # when the configuration is not fusable (non-HLL type, filters, ...)
    extra, cleanup = _mkdist_presketch(rest, ks)
    try:
        for k in ks:
            outp = f"_{outpref}_{k}"
            # injected flags AFTER rest: getopt is last-wins, so the
            # per-k '-k' and the forced binary '-O' must not be
            # overridden by a stray -k/-O in the user's dist options
            # (previously 'mkdist --multik mk,15,31,4 -k 21' silently
            # computed every pass at k=21); the presketch's cache flags
            # go last so its seeded tmpdir wins over a user -P too
            args = rest + ["-b", "-O", outp, "-k", str(k)] + (extra or [])
            if jukes_cantor:
                # JC needs intersection SIZES and a stable genome order;
                # inject each INDEPENDENTLY (a user-passed --sizes used
                # to suppress --avoid-sorting too, so the dist passes
                # sorted by fsize while mkmat2jcdistmat paired the
                # matrix with the unsorted path list — every JC distance
                # silently misassigned)
                if "--sizes" not in args and "-Z" not in args:
                    args = ["--sizes"] + args
                if "--avoid-sorting" not in args and "-n" not in args:
                    args = ["--avoid-sorting"] + args
            rc = dist_main(args)
            if rc != 0:
                return rc
            fpaths.append(outp)
    finally:
        # ALWAYS drop the parked device rows and joined-bytes cache — an
        # exception escaping dist_main must not leave stale device
        # registers keyed by cache filenames (a later in-process mkdist
        # whose inputs changed would silently compare round-1 banks) or
        # pin up to the bank cap of HBM for the process lifetime
        pipeline.set_join_cache(False)
        pipeline.device_rows_clear()
        if cleanup:
            cleanup()
    # multi-host: the per-k dist passes sharded their compare stripes and
    # every non-main rank returned 0 from each; flattening (and the JC
    # writer below) is single-writer work — extra ranks racing open('wb')
    # on the same outputs would corrupt them
    from ..parallel import distributed
    if not distributed.is_main():
        return 0
    eprint("Finished distance matrix calculations. Now flattening")
    rc = distmat.flatten_all(fpaths, outpref + ".bin", ks)
    if rc != 0 or not jukes_cantor:
        return rc
    # Jukes-Cantor post-processing (the reference's dormant background
    # module, mkdistmain.cpp:120-140 '#if 0' block — live here).
    from ..background import mkmat2jcdistmat
    optlist, gpaths = _getopts(rest, DIST_SHORT_OPTS, DIST_LONG)
    for flag, val in optlist:
        if flag in ("-F", "--paths"):
            gpaths = paths.get_paths(val)
    jc = mkmat2jcdistmat(outpref + ".bin", gpaths)
    distmat.write_binary(outpref + ".jcd", jc, len(gpaths))
    eprint(f"Wrote Jukes-Cantor distances to {outpref}.jcd")
    return 0


# ===========================================================================
# sketch_by_seq / dist_by_seq
# ===========================================================================

def sketch_by_seq_main(argv: List[str]) -> int:
    """One sketch per FASTA/FASTQ record, streamed into a single gz output
    plus a .names sidecar with '#k=<k>:' header (reference
    src/sketch_and_cmp.h:540-602)."""
    # single-writer tool: under jax.distributed only rank 0 runs it
    # (no sharded phase here; extra ranks would duplicate the output)
    from ..parallel import distributed
    if not distributed.is_main():
        return 0
    o = CommonOpts()
    o.mincount = 1
    outpath = "/dev/stdout"
    optlist, positional = _getopts(
        argv, "o:n:P:p:x:R:s:S:k:w:H:q:B:8JbfjEIcCeh?", SKETCH_LONG)
    for flag, val in optlist:
        if flag == "-o":
            outpath = val
            continue
        if flag == "-b":
            o.use_counting_filter = True
            continue
        if flag == "-n":
            o.mincount = int(val)
            continue
        if flag == "-q":
            o.cmsketchsize = int(val)
            continue
        if flag == "-H":
            o.nhashes = int(val)
            continue
        if core.parse_common(o, flag, val):
            continue
        if flag in ("-h", "-?", "--help"):
            eprint("sketch_by_seq [opts] input.fa")
            return 1
    core.validate_k(o)
    inpath = positional[0] if positional else "/dev/stdin"
    params = core.sketch_params(o)
    sp = params.spacer()
    namepath = ("stdout.names" if outpath == "/dev/stdout"
                else outpath + ".names")
    p = core.hll_p_from_S(o.sketch_size)
    # Streaming: records flow through in bounded batches, so a multi-GB
    # input never materializes (names and sketches land incrementally;
    # per-record registers are independent of the batching, so output
    # bytes are identical to the old whole-file path).
    import dataclasses as _dc
    import itertools
    rec_iter = fasta.iter_records_full(inpath)
    # THE encoder-kwargs builder (a hand-built dict here once dropped
    # the entropy flag for the non-HLL families)
    kw = pipeline._encode_kw(_dc.replace(params, rehash=True), sp)
    use_filter = o.use_counting_filter and o.mincount > 1
    with open(namepath, "w") as namefp, gzip.open(outpath, "wb") as ofp:
        namefp.write(f"#k={o.k}:Names for sequences sketched\n")
        while True:
            batch = list(itertools.islice(rec_iter, 2048))
            if not batch:
                break
            for name, _, _, _ in batch:
                namefp.write(name.decode() + "\n")
            seqs = [seq for _, _, seq, _ in batch]
            if use_filter:
                # reference sketch_by_seq_core clears its CM after EVERY
                # record (src/sketch_and_cmp.h:568-579): multiplicity is
                # within-record.  Records are small, so we count EXACTLY
                # (np.unique on the RAW k-mer codes; WangHash is a
                # bijection, so raw and hashed multiplicities agree)
                # instead of approximating with a CM — deliberate
                # divergence recorded in PARITY.md.
                raw_params = _dc.replace(params, rehash=False)
                for raw in pipeline.records_kmer_hashes(seqs, raw_params):
                    vals, cnts = np.unique(raw, return_counts=True)
                    admitted = vals[cnts >= o.mincount]
                    sk = _sketch_from_kmers(admitted, o, p)
                    sk.write_record(ofp)
            elif o.sketch_type == "hll":
                # batched per-record device sketching
                regs = pipeline.sketch_records_hll(seqs, params, p)
                for row in regs:
                    HLL(p, o.estim, o.jestim, row).write_record(ofp)
            else:
                for seq in seqs:
                    sk = _sketch_one_seq(seq, o, sp, kw, p)
                    sk.write_record(ofp)
    return 0


def _sketch_from_kmers(kmers: np.ndarray, o: CommonOpts, p: int):
    """Build one sketch of the requested family from RAW k-mer codes
    (the per-record filtered path; each family applies its own hashing
    exactly as the unfiltered _sketch_one_seq path does)."""
    if o.sketch_type == "hll":
        h = HLL(p, o.estim, o.jestim)
        h.addh_np(kmers)
        return h
    if o.sketch_type == "khset":
        return KSet.from_values(kmers)
    from ..sketch.setsketches import make_typed
    sk = make_typed(o.sketch_type, o)
    sk.addh_np(kmers)
    sk.finalize()
    return sk


def _sketch_one_seq(seq: bytes, o: CommonOpts, sp, kw, p: int):
    import jax.numpy as jnp
    from ..ops.encode import tile_sequence
    from ..pipeline import _tile_to_hashes
    from ..ops.hll_update import update_registers
    from .. import u64 as _u
    tiles = tile_sequence(np.frombuffer(seq, np.uint8), 8192, sp.halo)
    if o.sketch_type == "hll":
        regs = jnp.zeros(1 << p, jnp.int32)
        for i in range(0, tiles.shape[0], 64):
            h, valid = _tile_to_hashes(jnp.asarray(tiles[i:i + 64]), **kw)
            regs = update_registers(regs, h, valid, p)
        return HLL(p, o.estim, o.jestim,
                   np.clip(np.asarray(regs), 0, 255).astype(np.uint8))
    # other structures build from the raw (unhashed) k-mer stream
    vals = []
    kw_raw = dict(kw, rehash=False)
    for i in range(0, tiles.shape[0], 64):
        h, valid = _tile_to_hashes(jnp.asarray(tiles[i:i + 64]), **kw_raw)
        vals.append(_u.to_np(h)[np.asarray(valid)])
    kmers = np.concatenate(vals) if vals else np.zeros(0, np.uint64)
    if o.sketch_type == "khset":
        return KSet.from_values(kmers)
    from ..sketch.setsketches import make_typed
    sk = make_typed(o.sketch_type, o)
    sk.addh_np(kmers)
    sk.finalize()
    return sk


def dist_by_seq_main(argv: List[str]) -> int:
    """Compare pre-made per-sequence sketches (reference
    src/distbyseq.cpp:53-130).  Multi-host: every rank reads the (one)
    sketch stream, the compare phase stripes like dist's, and rank 0
    emits."""
    from ..parallel import distributed
    o = CommonOpts()
    outpath = "/dev/stdout"
    namefile = ""
    otherpath = ""
    emit_fmt = UT_TSV
    result_type = pw.JI
    k = -1
    long_opts = ["containment-index", "containment-dist", "mash-dist",
                 "symmetric-containment-index", "symmetric-containment-dist",
                 "sizes", "help"]
    optlist, positional = _getopts(argv, "q:o:k:n:p:EIJMBbS8KCTrUh?", long_opts)
    for flag, val in optlist:
        if flag == "-B":
            o.sketch_type = "bf"
        elif flag in ("-S", "-8"):
            o.sketch_type = "bbmh"
        elif flag == "-K":
            o.sketch_type = "khset"
        elif flag == "-r":
            o.sketch_type = "rmh"
        elif flag == "-p":
            o.nthreads = int(val)
        elif flag == "-o":
            outpath = val
        elif flag == "-E":
            o.estim = o.jestim = est.ORIGINAL
        elif flag == "-I":
            o.estim = o.jestim = est.ERTL_IMPROVED
        elif flag == "-J":
            o.jestim = est.ERTL_JOINT_MLE
        elif flag in ("-M", "--mash-dist"):
            result_type = pw.MASH_DIST
        elif flag == "--containment-index":
            result_type = pw.CONTAINMENT_INDEX
        elif flag == "--containment-dist":
            result_type = pw.CONTAINMENT_DIST
        elif flag == "--symmetric-containment-index":
            result_type = pw.SYMMETRIC_CONTAINMENT_INDEX
        elif flag == "--symmetric-containment-dist":
            result_type = pw.SYMMETRIC_CONTAINMENT_DIST
        elif flag in ("-Z", "--sizes"):
            result_type = pw.SIZES
        elif flag == "-k":
            k = int(val)
        elif flag == "-n":
            namefile = val
        elif flag == "-q":
            otherpath = val
        elif flag == "-b":
            emit_fmt = BINARY
        elif flag == "-T":
            emit_fmt = FULL_TSV
        elif flag == "-U":
            emit_fmt = PHYLIP
        elif flag in ("-h", "-?", "--help"):
            _dbs_usage()
    if len(positional) != 1 or not namefile:
        _dbs_usage()
    labels = paths.get_paths(namefile)
    if labels and labels[0].startswith("#k="):
        if k <= 0:
            try:
                k = int(labels[0][3:].split(":")[0])
            except ValueError:
                k = 31
        labels = labels[1:]
    if k <= 0:
        k = 31
    sketches = []
    with gzip.open(positional[0], "rb") as fp:
        for _ in labels:
            sketches.append(core.read_sketch_auto(fp, o.sketch_type))
        if otherpath:
            qnames = paths.get_paths(otherpath + ".names")
            qnames = [q for q in qnames if not q.startswith("#k=")]
            with gzip.open(otherpath, "rb") as qfp:
                qsketches = [core.read_sketch_auto(qfp, o.sketch_type)
                             for _ in qnames]
    for sk in sketches:
        if hasattr(sk, "estim"):
            sk.estim = o.estim
        if hasattr(sk, "jestim"):
            sk.jestim = o.jestim
    # same stripe split as dist's compare phase (per-seq collections can
    # be very large — the compare is the dominant cost here too)
    from ..sketch import batch_compare
    from ..sketch.extra import WideHLL
    reg_family = bool(sketches) and isinstance(sketches[0], (HLL, WideHLL))
    shard_compare = (distributed.process_count() > 1 and bool(sketches)
                     and (reg_family or batch_compare.supports(sketches)))
    shard_tile = pw.DEFAULT_TILE if reg_family else core.HOST_COMPARE_TILE
    if not distributed.is_main() and not shard_compare:
        return 0
    nq = 0
    if otherpath:
        ref_blocks = (distributed.owned_tile_rows(len(sketches), shard_tile)
                      if shard_compare else None)
        mat = core.compare_rect(sketches, qsketches, result_type, k,
                                o.estim, o.jestim, ref_blocks=ref_blocks)
        if shard_compare:
            mat = distributed.combine_columns(mat, len(sketches),
                                              shard_tile)
            if not distributed.is_main():
                return 0
        fp, close = core.open_output(outpath, binary=(emit_fmt == BINARY))
        if emit_fmt == BINARY:
            fp.write(np.ascontiguousarray(mat, np.float32).tobytes())
        else:
            distmat.emit_rect_tsv(fp, qnames, mat)
    else:
        if not pw.is_symmetric(result_type):
            raise SystemExit("Can't perform asymmetric comparison without "
                             "query paths")
        row_blocks = (distributed.owned_tile_rows(len(sketches), shard_tile)
                      if shard_compare else None)
        cond = core.compare_condensed(sketches, result_type, k, o.estim,
                                      o.jestim, row_blocks=row_blocks)
        if shard_compare:
            cond = distributed.combine_condensed(cond, len(labels),
                                                 shard_tile)
            if not distributed.is_main():
                return 0
        fp, close = core.open_output(outpath, binary=(emit_fmt == BINARY))
        if emit_fmt == BINARY:
            distmat.write_binary(fp, cond, len(labels))
        elif emit_fmt == PHYLIP:
            distmat.emit_phylip(fp, labels, cond)
        elif emit_fmt == FULL_TSV:
            distmat.emit_full_tsv(
                fp, labels, distmat.condensed_to_square(cond, len(labels)))
        else:
            distmat.emit_ut_tsv(fp, labels, cond)
    if close:
        fp.close()
    return 0


# ===========================================================================
# panel: query FASTAs against a sketch database (the reference's panel is an
# unimplemented stub, src/panel.cpp:4-7; this one works).
# ===========================================================================

def panel_main(argv: List[str]) -> int:
    # multi-host: the tiled rect-JMLE pass against the DB stripes over
    # ref blocks per process (sketching the queries is replicated — it
    # is the small side of a panel screen); rank 0 emits
    from ..parallel import distributed
    o = CommonOpts()
    outpath = "/dev/stdout"
    filesinfile = False
    optlist, positional = _getopts(argv, "p:o:k:S:Fh?", ["help"])
    for flag, val in optlist:
        if flag == "-o":
            outpath = val
        elif flag == "-F":
            filesinfile = True
        elif core.parse_common(o, flag, val):
            pass
    if len(positional) != 2:
        eprint("panel <sketch-db> <query> [-F: query is a file of paths] "
               "[-o out]")
        return 1
    dbpath, inpath = positional
    labels_path = (dbpath + ".labels" if os.path.exists(dbpath + ".labels")
                   else dbpath + ".labels.gz")
    if labels_path.endswith(".gz"):
        with gzip.open(labels_path, "rt") as lf:
            labels = [l.strip() for l in lf if l.strip()]
    else:
        labels = [l for l in paths.get_paths(labels_path) if l]
    refs = []
    with gzip.open(dbpath, "rb") as fp:
        for _ in labels:
            refs.append(HLL.read_record(fp))
    if len(refs) != len(labels):
        raise SystemExit(f"Read {len(refs)} sketches but {len(labels)} labels")
    qpaths = paths.get_paths(inpath) if filesinfile else [inpath]
    o.sketch_size = refs[0].p
    core.validate_k(o)
    p = refs[0].p
    # batched production path: the tuned device engine sketches every
    # query, then ONE tiled rect JMLE pass against the whole DB (the
    # per-pair ertl_joint loop cost one device round trip per DB entry)
    queries: List = [None] * len(qpaths)
    core.device_hll_run(
        list(enumerate(qpaths)), o,
        lambda i, regs: queries.__setitem__(
            i, HLL(p, o.estim, est.ERTL_JOINT_MLE, regs)))
    shard = distributed.process_count() > 1
    ref_blocks = (distributed.owned_tile_rows(len(refs), pw.DEFAULT_TILE)
                  if shard else None)
    tri = pw.rect_triples(refs, queries, o.estim, est.ERTL_JOINT_MLE,
                          ref_blocks=ref_blocks)
    if shard:
        tri = distributed.combine_columns(tri, len(refs), pw.DEFAULT_TILE)
        if not distributed.is_main():
            return 0
    # orientation: lhs = ref, so t1 = only-QUERY mass
    shared = tri[..., 2]
    cont = np.where(tri[..., 1] + shared > 0,
                    shared / np.maximum(tri[..., 1] + shared, 1e-30), 0.0)
    union = tri.sum(-1)
    ji = np.where(union > 0, shared / np.maximum(union, 1e-30), 0.0)
    fp, close = core.open_output(outpath)
    fp.write("#Query\tBestMatch\tContainment\tJaccard\n")
    for qi, qp in enumerate(qpaths):
        best = int(np.argmax(cont[qi]))   # first max, like the scan loop
        fp.write(f"{qp}\t{labels[best]}\t{cont[qi, best]:.6g}"
                 f"\t{ji[qi, best]:.6g}\n")
    if close:
        fp.close()
    return 0


# ===========================================================================
# readfilt: stream reads, emit those contained in a reference sketch
# (side tool, reference src/readfilt.cpp:36-139).
# ===========================================================================

def readfilt_main(argv: List[str]) -> int:
    # single-writer tool: under jax.distributed only rank 0 runs it
    # (no sharded phase here; extra ranks would duplicate the output)
    from ..parallel import distributed
    if not distributed.is_main():
        return 0
    o = CommonOpts()
    o.k = 21
    hllpath = ""
    frac_cutoff = 0.5
    opath = None
    optlist, positional = _getopts(argv, "Chk:s:f:o:?", ["help"])
    for flag, val in optlist:
        if flag == "-s":
            hllpath = val
        elif flag == "-f":
            frac_cutoff = float(val)
        elif flag == "-k":
            o.k = int(val)
        elif flag == "-o":
            opath = val
        elif flag == "-C":
            o.canon = False
        elif flag in ("-h", "-?", "--help"):
            eprint("readfilt -s ref.hll [-k 21] [-f 0.5] reads.fq "
                   "[mates.fq]")
            return 1
    if not positional or not hllpath:
        eprint("readfilt -s ref.hll [-k 21] [-f 0.5] reads.fq [mates.fq]")
        return 1
    core.validate_k(o)
    import itertools
    ref = HLL.read(hllpath)
    fp, close = core.open_output(opath)
    params = core.sketch_params(o)
    sp = params.spacer()
    # Paired mates join with an invalid separator so k-mers never span them
    # (same per-read k-mer set as the reference's two for_each calls,
    # readfilt.cpp:96-103).
    sepN = b"N" * sp.halo
    ref_regs = ref.regs.astype(np.int32)
    ref_hist = ref.histogram()
    CHUNK = 4096      # stream in bounded batches: read sets can be huge
    # lazy record streams: a multi-GB read set never materializes
    # (fasta.iter_records_full == read_records_full record-for-record)
    iters = [fasta.iter_records_full(pth) for pth in positional[:2]]
    _end = object()
    if len(iters) == 2:
        pairs_iter = itertools.zip_longest(*iters, fillvalue=_end)
    else:
        pairs_iter = ((r,) for r in iters[0])
    truncated = False
    while True:
        batch = []
        for recs in pairs_iter:
            if _end in recs:
                if not truncated:
                    eprint("Warning: mismatched numbers of reads between "
                           "paired-end files")
                    truncated = True
                break
            batch.append(recs)
            if len(batch) >= CHUNK:
                break
        if not batch:
            break
        seqs = [sepN.join(r[2] for r in recs) for recs in batch]
        tri = pipeline.records_joint_triples(seqs, params, ref_regs,
                                             ref_hist, ref.p)
        denom = tri[:, 0] + tri[:, 2]
        ci = np.where(denom > 0, tri[:, 2] / np.maximum(denom, 1e-300), 0.0)
        # output records mirror the reference emit() byte for byte
        # (src/readfilt.cpp:17-33): the first FASTQ mate carries the full
        # 'CI:%lf|onlyq|onlyref|shared|' annotation, later mates and
        # FASTA records append '|%lf' (printf %lf = 6 fixed decimals)
        for recs, c, tr in zip(batch, ci, tri):
            if c < frac_cutoff:
                continue
            # the reference branches on MATE 1's quality for BOTH records
            # (src/readfilt.cpp:17-33): a quality-less first mate demotes
            # the pair to FASTA even when mate 2 carries quality.  (The
            # inverse corner — FASTQ mate 1, FASTA mate 2 — hits
            # fprintf("%s", NULL) in the reference; we emit an empty
            # quality string instead of replicating that UB.)
            fastq = recs[0][3] is not None
            for mate, (name, comment, seq, qual) in enumerate(recs):
                nm, cm = name.decode(), comment.decode()
                if fastq:
                    q = qual.decode() if qual is not None else ""
                    if mate == 0:
                        fp.write(f"@{nm} {cm}|CI:{c:.6f}|{tr[0]:.6f}"
                                 f"|{tr[1]:.6f}|{tr[2]:.6f}|\n"
                                 f"{seq.decode()}\n+\n{q}\n")
                    else:
                        fp.write(f"@{nm} {cm}|{c:.6f}\n{seq.decode()}"
                                 f"\n+\n{q}\n")
                else:
                    fp.write(f">{nm} {cm}|{c:.6f}\n{seq.decode()}\n")
        if truncated or len(batch) < CHUNK:
            break
    if close:
        fp.close()
    return 0


# ===========================================================================
# usage + dispatcher
# ===========================================================================

def _dist_usage():
    raise SystemExit(
        "Usage: dist <opts> [genomes... or -F paths.txt]\n"
        "  -k/--kmer-length INT    k-mer size [31], max 32 (rolling hashes "
        "unbounded)\n"
        "  -S/--sketch-size INT    log2 bytes per sketch [10]\n"
        "  -F/--paths FILE         one input path per line\n"
        "  -Q/--query-paths FILE   queries for rectangular comparison\n"
        "  -o/-O FILE              cardinality / distance outputs\n"
        "  -M/--mash-dist, --full-mash-dist, --sizes, --containment-*, "
        "--symmetric-containment-*\n"
        "  -b binary, -U phylip, -T full TSV (default upper-triangular TSV)\n"
        "  -E/-I/-m/-J             estimator: original/improved/MLE/joint "
        "MLE\n"
        "  -C no canonicalization, -w window, -s spacing, --use-nthash, "
        "--use-cyclic-hash\n"
        "  --use-bb-minhash/-8, --use-bloom-filter, --use-range-minhash, "
        "--use-full-khash-sets\n"
        "  -y/--countmin -c mincount   count-threshold filtering\n"
        "  --nearest-neighbors N   k-NN mode\n"
        "  -W cache sketches, -H presketched inputs, -p threads (accepted; "
        "device-parallel)\n")


def _sketch_usage():
    raise SystemExit("Usage: sketch <opts> [genomes...]; see dist for shared "
                     "options; -o writes all sketches to one stream")


def _union_usage():
    raise SystemExit("Usage: union [-o out] [-F paths] sketch1 sketch2...\n"
                     "  -r bottom-k, -H hash sets, -b bloom filters "
                     "(default HLL)")


def _dbs_usage():
    raise SystemExit("Usage: dist_by_seq -n namefile [opts] sketchstream.gz")


SUBCOMMANDS = {
    "sketch": sketch_main,
    "union": union_main,
    "setdist": dist_main,
    "dist": dist_main,
    "cmp": dist_main,
    "hll": hll_main,
    "view": view_main,
    "fold": fold_main,
    "panel": panel_main,
    "card": card_main,
    # the reference ships cardcmp as a standalone binary wrapping card_main
    # (src/cardcmp.cpp); here it is an alias subcommand
    "cardcmp": card_main,
    "printmat": printmat_main,
    "mkdist": mkdist_main,
    "flatten": flatten_main,
    "dist_by_seq": dist_by_seq_main,
    "cmp_by_seq": dist_by_seq_main,
    "sketch_by_seq": sketch_by_seq_main,
    "sbs": sketch_by_seq_main,
    "readfilt": readfilt_main,
}


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    # Platform override: DASHING_TPU_PLATFORM=cpu forces host execution
    # (the tests use it; also useful for tiny inputs where device dispatch
    # latency dominates).
    plat = os.environ.get("DASHING_TPU_PLATFORM")
    if plat:
        import jax
        jax.config.update("jax_platforms", plat)
    # Persistent XLA compilation cache: cached reruns skip the compiles
    # that dominate cold-start wall time (dashing_tpu/compile_cache.py).
    compile_cache.enable()
    # Multi-host: wires up jax.distributed when DASHING_TPU_DISTRIBUTED is
    # set (parallel/distributed.py); a no-op in single-process runs.
    from ..parallel import distributed
    distributed.maybe_initialize()
    eprint(f"dashing_tpu version: {__version__}")
    if not argv:
        _main_usage()
    cmd = argv[0]
    fn = SUBCOMMANDS.get(cmd)
    if fn is not None:
        try:
            with metrics.maybe_trace(), metrics.accum("run.subcommand"):
                rc = fn(argv[1:])
        except (FileNotFoundError, IsADirectoryError) as e:
            raise SystemExit(f"{cmd}: {e}")
        except (EOFError, ValueError, gzip.BadGzipFile, OSError) as e:
            if os.environ.get("DASHING_TPU_DEBUG"):
                raise
            raise SystemExit(f"{cmd}: {type(e).__name__}: {e}")
        # process-start -> now: run.total - run.subcommand is the fixed
        # per-process overhead (interpreter, imports, backend init)
        age = _process_age_s()
        if age > 0:
            metrics.add_time("run.total", age)
        metrics.summary()
        return rc
    if fn is None:
        for a in argv:
            if a.lower() in ("-h", "--help"):
                _main_usage()
            if a.lower() in ("-v", "--version"):
                raise SystemExit(f"dashing_tpu version: {__version__}")
        raise SystemExit(f"Invalid subcommand {cmd} provided.")


def _main_usage():
    raise SystemExit(
        "Usage: dashing_tpu <subcommand> [options...]\n"
        "Subcommands: sketch, dist/cmp, hll, union, view, fold, card, "
        "printmat, mkdist, flatten,\n"
        "             dist_by_seq/cmp_by_seq, sketch_by_seq/sbs, panel, "
        "readfilt\n")


def readfilt_entry() -> int:
    """Standalone readfilt invocation (console script), mirroring the
    reference's separately-built side binary (reference Makefile:128-129,
    src/readfilt.cpp has its own main)."""
    return main(["readfilt"] + sys.argv[1:])


def cardcmp_entry() -> int:
    """Standalone cardcmp (reference src/cardcmp.cpp wraps card_main)."""
    return main(["cardcmp"] + sys.argv[1:])


if __name__ == "__main__":
    sys.exit(main())
