"""Per-read containment-query throughput (the readfilt hot path).

Batched sparse joint-MLE queries of short reads against one dense genome
sketch (sketch/sparse.py; reference src/readfilt.cpp:102-110 does this one
read at a time with a std::map).

    python benchmarks/readfilt_bench.py [n_reads] [read_len] [p]
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

import _common
_common.setup()



def main(n_reads: int = 16384, read_len: int = 150, p: int = 14, k: int = 21):
    import jax
    import jax.numpy as jnp
    from dashing_tpu.pipeline import (_tile_to_hashes, SketchParams)
    from dashing_tpu.ops.hll_update import bucket_rank
    from dashing_tpu.sketch.sparse import sparse_joint_triples
    from dashing_tpu.sketch.hll import HLL

    rng = np.random.default_rng(0)
    # reference sketch of a 5 Mb genome
    ref = HLL(p)
    ref.addh_np(rng.integers(0, 2 ** 63, 5_000_000, dtype=np.uint64) << np.uint64(1))
    ref_regs = jnp.asarray(ref.regs.astype(np.int32))
    ref_hist = jnp.asarray(ref.histogram())

    width = 256
    assert read_len + k <= width
    tiles = rng.choice(np.frombuffer(b"ACGT", np.uint8),
                       size=(n_reads, width))
    tiles[:, read_len:] = ord("N")
    tiles = jnp.asarray(tiles)
    params = SketchParams(k=k)
    sp = params.spacer()
    kw = dict(k=sp.k, w=sp.w, positions=tuple(sp.positions), span=sp.c,
              canon=True, encoding="bonsai", rehash=True)

    from dashing_tpu.sketch.sparse import level_window_bins
    import functools

    # mirror the CLI's records_joint_triples encode step
    @jax.jit
    def encode(tiles):
        h, valid = _tile_to_hashes(tiles, **kw)
        idx, rank = bucket_rank(h, p)
        return idx, jnp.where(valid, rank, 0)

    @functools.partial(jax.jit, static_argnames=("kb",))
    def query(tiles, kb):
        idx, rank = encode(tiles)
        tri = sparse_joint_triples(idx, rank, ref_regs, ref_hist[:kb],
                                   p, kb)
        denom = tri[:, 0] + tri[:, 2]
        return jnp.where(denom > 0, tri[:, 2] / jnp.maximum(denom, 1e-30), 0.0)

    # production picks the level window from one scalar rank-max pull per
    # batch; the bench precomputes it (same data each rep)
    _idx, _rank = encode(tiles)
    kb = level_window_bins(max(int(jax.device_get(_rank.max())),
                               int(ref.regs.max())), 64 - p)
    _ = jax.device_get(query(tiles, kb))
    best = best_enc = 1e9
    for _i in range(3):
        t0 = time.perf_counter()
        _ = jax.device_get(encode(tiles)[1].max())
        best_enc = min(best_enc, time.perf_counter() - t0)
        t0 = time.perf_counter()
        _ = jax.device_get(query(tiles, kb))
        best = min(best, time.perf_counter() - t0)
    print(f"readfilt sparse query: {n_reads} reads x {read_len} bp, p={p}, "
          f"kb={kb}: {best * 1e3:.1f} ms (encode alone {best_enc*1e3:.1f}) "
          f"-> {n_reads / best:,.0f} reads/s")


if __name__ == "__main__":
    args = [int(a) for a in sys.argv[1:]]
    main(*args)
