"""Host-tiled all-pairs throughput at scale (the production compare path).

Unlike allpairs_bench.py (single in-jit tile, on-device truth), this runs
the REAL orchestration: registers uploaded once as int8, device-side tile
slices, async dispatch window, condensed writeback — everything `dist`
does, so host<->device transfer is included.

    python benchmarks/tiled_scale.py [n] [p] [tile] [-J] [--hetero]

-J routes through the joint-MLE estimator (the `dist -J` production
path), exercising the per-tile level windows + fused joint-MLE Newton
kernel end-to-end including transfers.

--hetero draws per-sketch cardinalities log-uniform in [1e4, 1e7] and
size-sorts them (exactly what the CLI's sort_paths_by_fsize produces on
real collections): tiles become cardinality-homogeneous, so the
per-tile level windows resolve narrow local spans instead of the whole
bank's — the homogeneous default (all rows at 5e6) is the window
lever's worst case.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

import _common
_common.setup()



def main(n: int = 4096, p: int = 14, tile: int = 1024,
         joint: bool = False, hetero: bool = False):
    from dashing_tpu.ops import pairwise as pw
    from dashing_tpu.sketch import estimators as est
    from dashing_tpu.sketch.hll import HLL

    jestim = est.ERTL_JOINT_MLE if joint else est.ERTL_MLE
    rng = np.random.default_rng(0)
    m = 1 << p
    if hetero:
        # size-sorted log-uniform cardinalities (the CLI sorts inputs by
        # file size, so production tiles are cardinality-homogeneous)
        cards = np.sort(10 ** rng.uniform(4, 7, size=n))[::-1]
        shift = np.maximum(np.log2(cards / m), 0).astype(np.int64)[:, None]
    else:
        shift = int(np.maximum(np.log2(5e6 / m), 0))
    regs = np.minimum(
        rng.geometric(0.5, size=(n, m)) - 1 + shift,
        64 - p + 1).astype(np.uint8)
    sketches = [HLL(p, regs=regs[i]) for i in range(n)]
    # compile/warm: a FULL pass, not a tile prefix — hetero banks spread
    # tiles over several window buckets, each its own jit variant, and a
    # prefix warm would leave cold compiles inside the timed run
    _ = pw.all_pairs_condensed(sketches, pw.JI, 21,
                               est.ERTL_MLE, jestim, tile=tile)
    t0 = time.perf_counter()
    _ = pw.all_pairs_condensed(sketches, pw.JI, 21, est.ERTL_MLE,
                               jestim, tile=tile)
    dt = time.perf_counter() - t0
    pairs = n * (n - 1) / 2
    print(f"tiled all-pairs{' -J' if joint else ''}"
          f"{' hetero' if hetero else ''} n={n} p={p} "
          f"tile={tile}: {dt:.2f} s -> "
          f"{pairs / dt / 1e6:.2f} M pairs/s (incl. transfers)")


if __name__ == "__main__":
    ints = [int(a) for a in sys.argv[1:] if a.lstrip("-").isdigit()]
    main(*ints, joint=any(a in ("-J", "J", "jmle") for a in sys.argv[1:]),
         hetero=any(a == "--hetero" for a in sys.argv[1:]))
