"""Quantify the per-tile level-window lever IN-JIT (no transfer noise):
time the full -J tile (stats + triples + measure) on one bank at a
sweep of forced [kmin, kmax] windows.  The tiled e2e path cannot
resolve this (per-tile transfer variance is 10x the effect); this is
the measurement that records what the live per-tile kmin buys a warm
warm bank whose tiles sit at different cardinalities.

Run on the GPU:  python benchmarks/window_probe.py [n] [p]
"""
from __future__ import annotations

import sys
import time

import numpy as np

import _common
_common.setup()


def main(n: int = 1024, p: int = 14):
    import jax
    import jax.numpy as jnp
    from dashing_tpu.ops import pairwise as pw
    from dashing_tpu.sketch import estimators as est

    rng = np.random.default_rng(0)
    lam = 5e6 / (1 << p)
    regs = np.minimum(
        rng.geometric(0.5, size=(n, 1 << p)) - 1 +
        np.maximum(np.log2(lam), 0).astype(np.int64), 64 - p + 1
    ).astype(np.int32)
    true_kmin, kmax = int(regs.min()), int(regs.max()) + 1
    a = jnp.asarray(regs)
    REPS = 8

    def timed(kmin, kmax):
        @jax.jit
        def loop(a):
            def body(i, acc):
                bump = (acc - jnp.floor(acc) > 2.0).astype(a.dtype)
                aa = a.at[0, 0].add(bump)
                stats = pw.pair_stats(aa, aa, kmax, True, kmin, same=True)
                tri = pw.triples_from_stats(stats, p, est.ERTL_MLE,
                                            est.ERTL_JOINT_MLE, kmin)
                out = pw.measure_from_triples(tri, pw.JI, 1.0 / 21)
                return acc + out.sum()
            return jax.lax.fori_loop(0, REPS, body, jnp.float32(0.0))

        _ = jax.device_get(loop(a))
        dt = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            _ = jax.device_get(loop(a))
            dt = min(dt, (time.perf_counter() - t0) / REPS)
        return dt

    print(f"n={n} p={p} true window [{true_kmin}, {kmax}]", file=sys.stderr)
    for kmin in (0, true_kmin // 2, true_kmin):
        dt = timed(kmin, kmax)
        K = kmax - kmin + 1
        print(f"window [{kmin:2d}, {kmax}] (K={K:2d}): {dt*1e3:6.1f} ms"
              f"  -> {n*n/dt/1e6:6.1f} M pairs/s")


if __name__ == "__main__":
    args = [int(x) for x in sys.argv[1:]]
    main(*args)
