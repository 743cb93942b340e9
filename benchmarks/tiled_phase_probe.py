"""Per-tile phase split of the production tiled compare path: dispatch
(enqueue) vs device wait vs 4 MB block pull vs host condensed scatter.
Localizes where tiled -J wall time goes when it diverges from the
in-jit tile rate (allpairs_bench.py).

Run on the GPU:  python benchmarks/tiled_phase_probe.py [n] [p] [tile] [-J]
"""
from __future__ import annotations

import sys
import time

import numpy as np

import _common
_common.setup()


def main(n: int = 2048, p: int = 14, tile: int = 1024,
         joint: bool = True):
    import jax
    from dashing_tpu.ops import pairwise as pw
    from dashing_tpu.sketch import estimators as est

    jestim = est.ERTL_JOINT_MLE if joint else est.ERTL_MLE
    rng = np.random.default_rng(0)
    m = 1 << p
    lam = 5e6 / m
    regs = np.minimum(
        rng.geometric(0.5, size=(n, m)) - 1 +
        np.maximum(np.log2(lam), 0).astype(np.int64),
        64 - p + 1).astype(np.uint8)
    q = 64 - p
    mm = pw._block_minmax(regs, n, tile)
    regs_d = pw._device_regs(regs)

    def one(i0, j0):
        return pw.compare_tile_async(
            regs_d[i0:i0 + tile], regs_d[j0:j0 + tile], p, pw.JI,
            1.0 / 21, est.ERTL_MLE, jestim,
            *pw._pair_window(mm[i0], mm[j0], q), same=(i0 == j0))

    keys = [(i0, j0) for i0 in range(0, n, tile)
            for j0 in range(i0, n, tile)]
    # warm every variant
    for k in keys:
        _ = np.asarray(one(*k))

    for k in keys:
        t0 = time.perf_counter()
        d = one(*k)
        t1 = time.perf_counter()
        d.block_until_ready()   # no-op on this backend, timed anyway
        t2 = time.perf_counter()
        blk = np.asarray(d)
        t3 = time.perf_counter()
        print(f"tile {k}: dispatch {1e3*(t1-t0):7.1f} ms   "
              f"block_until_ready {1e3*(t2-t1):7.1f} ms   "
              f"pull {1e3*(t3-t2):7.1f} ms   ({blk.nbytes >> 20} MB)")


if __name__ == "__main__":
    ints = [int(a) for a in sys.argv[1:] if a.lstrip("-").isdigit()]
    main(*ints, joint=any(a in ("-J", "J") for a in sys.argv[1:]))
