"""All-pairs distance throughput at the 1k-genome configuration
(BASELINE.json configs[1]/[3] scale): n sketches, p=16/14, JI via ERTL_MLE.

Run on the GPU:  python benchmarks/allpairs_bench.py [n] [p]
Prints pairs/s and the per-phase split.  Not the driver headline bench
(that's /root/repo/bench.py); this records the compare-phase numbers for
PERF.md.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

import _common
_common.setup()



def main(n: int = 1024, p: int = 14, joint: bool = False):
    import jax
    import jax.numpy as jnp
    from dashing_tpu.ops import pairwise as pw
    from dashing_tpu.sketch import estimators as est

    rng = np.random.default_rng(0)
    # realistic register values for ~5e6-element sets at 2^p buckets
    lam = 5e6 / (1 << p)
    regs = np.minimum(
        rng.geometric(0.5, size=(n, 1 << p)) - 1 +
        np.maximum(np.log2(lam), 0).astype(np.int64), 64 - p + 1
    ).astype(np.int32)
    kmin, kmax = int(regs.min()), int(regs.max()) + 1
    jestim = est.ERTL_JOINT_MLE if joint else est.ERTL_MLE
    print(f"n={n} p={p} levels [{kmin}, {kmax}] "
          f"{'JMLE' if joint else 'MLE'}", file=sys.stderr)

    a = jnp.asarray(regs)

    REPS = 8

    @jax.jit
    def compare_loop(a):
        # The timing loop lives inside jit and returns one scalar (the
        # pull ends the timed region): per-rep cost =
        # (t(REPS) amortized), transfer = 4 bytes.
        def body(i, acc):
            # thread the carry into the input: a genuine cross-iteration
            # data dependence, so XLA cannot hoist the body out of the loop
            bump = (acc - jnp.floor(acc) > 2.0).astype(a.dtype)  # always 0
            aa = a.at[0, 0].add(bump)
            # same=True: the production all-pairs path marks diagonal
            # tiles (Z = Y^T, 2 matmul families per level instead of 3)
            stats = pw.pair_stats(aa, aa, kmax, joint, kmin, same=True)
            tri = pw.triples_from_stats(stats, p, est.ERTL_MLE,
                                        jestim, kmin)
            out = pw.measure_from_triples(tri, pw.JI, 1.0 / 21)
            return acc + out.sum()
        return jax.lax.fori_loop(0, REPS, body, jnp.float32(0.0))

    _ = jax.device_get(compare_loop(a))      # compile + warm
    dt = 1e9
    for _ in range(3):
        t0 = time.perf_counter()
        _ = jax.device_get(compare_loop(a))
        dt = min(dt, (time.perf_counter() - t0) / REPS)
    pairs = n * n
    flops = 2.0 * (kmax - kmin + 1) * n * n * (1 << p)
    print(f"all-pairs {'JMLE' if joint else 'JI'}: {dt*1000:.1f} ms for "
          f"{pairs} pairs -> {pairs/dt:,.0f} pairs/s  ({flops/dt/1e12:.1f} "
          f"Teff-ops/s in the indicator matmuls)")


if __name__ == "__main__":
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 1024
    p = int(sys.argv[2]) if len(sys.argv) > 2 else 14
    joint = any(a in ("-J", "J", "jmle") for a in sys.argv[3:])
    main(n, p, joint)
