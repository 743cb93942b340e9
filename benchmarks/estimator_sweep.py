"""Estimator accuracy sweep (BASELINE.json configs[4]).

ORIGINAL vs ERTL_IMPROVED vs ERTL_MLE cardinality RMSE, and
inclusion-exclusion vs JOINT_MLE Jaccard RMSE, at p in {10, 14, 18},
against exact ground truth.  Runs on the CPU or the GPU.

    python benchmarks/estimator_sweep.py [trials]
"""
from __future__ import annotations

import os
import sys

import numpy as np

import _common
_common.setup()



def main(trials: int = 20):
    import jax.numpy as jnp
    from dashing_tpu.sketch import estimators as est
    from dashing_tpu.sketch.hll import HLL

    rng = np.random.default_rng(42)
    print("== cardinality relative RMSE (n=100k) ==")
    print(f"{'p':>4} {'expected':>9} {'ORIG':>8} {'IMPR':>8} {'MLE':>8}")
    for p in (10, 14, 18):
        errs = {m: [] for m in (est.ORIGINAL, est.ERTL_IMPROVED, est.ERTL_MLE)}
        for _ in range(trials):
            n = 100_000
            h = HLL(p)
            h.addh_np(rng.integers(0, 2**63, n, dtype=np.uint64))
            C = jnp.asarray(h.histogram())
            for m in errs:
                errs[m].append(float(est.estimate(C, p, m)) / n - 1.0)
        rmse = {m: np.sqrt(np.mean(np.square(v))) for m, v in errs.items()}
        expected = 1.04 / np.sqrt(2.0 ** p)
        print(f"{p:>4} {expected:>9.4f} {rmse[est.ORIGINAL]:>8.4f} "
              f"{rmse[est.ERTL_IMPROVED]:>8.4f} {rmse[est.ERTL_MLE]:>8.4f}")

    print("== Jaccard RMSE vs exact (true JI = 1/3) ==")
    print(f"{'p':>4} {'incl-excl':>10} {'joint MLE':>10}")
    for p in (10, 14, 18):
        e_ie, e_jm = [], []
        for _ in range(trials):
            n = 30_000
            shared = rng.integers(0, 2**62, n, dtype=np.uint64)
            a = HLL(p)
            b = HLL(p, jestim=est.ERTL_JOINT_MLE)
            a.addh_np(np.concatenate(
                [shared, rng.integers(2**62, 2**63, n, dtype=np.uint64)]))
            b.addh_np(np.concatenate(
                [shared, rng.integers(2**63, 2**64 - 1, n, dtype=np.uint64)]))
            true = n / (3 * n)
            a.jestim = est.ERTL_MLE
            e_ie.append(a.jaccard_index(b) - true)
            a.jestim = est.ERTL_JOINT_MLE
            e_jm.append(a.jaccard_index(b) - true)
        print(f"{p:>4} {np.sqrt(np.mean(np.square(e_ie))):>10.4f} "
              f"{np.sqrt(np.mean(np.square(e_jm))):>10.4f}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 20)
