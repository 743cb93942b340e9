"""A/B: update_registers_matmul (one-hot matmul path) vs the
production filtered-scatter update at production geometry (VERDICT r4
item 6; bears on SURVEY hard-part #3).

Isolates the UPDATE stage: pre-generated WangHash streams fold into 2^p
registers through (A) update_registers_filtered — the production path —
and (B) update_registers_matmul, sub-chunked so the (B, 2^p) one-hot
operand stays HBM-resident at a sane size.  Timing loop threads the
register carry through chunks (loop-invariant bodies get hoisted; only
data pulls sync — see CLAUDE.md).

Run on the GPU from the repo root:  python benchmarks/update_matmul_ab.py
"""
from __future__ import annotations

import os
import time

import numpy as np

import _common
_common.setup()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dashing_tpu.hashes import wang_hash           # noqa: E402
from dashing_tpu.ops.hll_update import (           # noqa: E402
    _ROW, adaptive_cap, bucket_rank, update_registers_filtered,
    update_registers_matmul)

ITERS = int(os.environ.get("DTPU_AB_ITERS", 16))
KMERS = 1 << int(os.environ.get("DTPU_AB_KMERS_LOG2", 21))
# 2M hashes per chunk (the 256x8192 tile budget)


def bench(fn, chunks_hi, chunks_lo, regs, label):
    @jax.jit
    def run(chi, clo, regs):
        def body(i, regs):
            return fn((chi[i], clo[i]), regs)
        return jax.lax.fori_loop(0, chi.shape[0], body, regs)

    out = jax.device_get(run(chunks_hi, chunks_lo, regs))   # compile+warm
    kmers = chunks_hi.shape[0] * chunks_hi.shape[1]
    best = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        r = run(chunks_hi, chunks_lo, regs)
        jax.device_get(r)
        best = max(best, kmers / (time.perf_counter() - t0))
    print(f"{label}: {best/1e6:.1f} M kmers/s")
    return best, out


def main():
    rng = np.random.default_rng(0)
    for p in (10, 14):
        print(f"--- p={p} ---", flush=True)
        chi = jnp.asarray(rng.integers(0, 2**32, (ITERS, KMERS),
                                       dtype=np.uint32))
        clo = jnp.asarray(rng.integers(0, 2**32, (ITERS, KMERS),
                                       dtype=np.uint32))
        regs = jnp.zeros(1 << p, jnp.int32)
        valid = jnp.ones(KMERS, bool)

        cap = adaptive_cap(_ROW, 1 << p, 0)

        def filt(h, regs, p=p, cap=cap):
            return update_registers_filtered(regs, h, valid, p, cap=cap)

        bench(filt, chi, clo, regs, f"scatter-filtered p={p}")

        for sub_log2 in (11, 12, 13):
            sub = 1 << sub_log2

            def mm(h, regs, p=p, sub=sub):
                hi = h[0].reshape(-1, sub)
                lo = h[1].reshape(-1, sub)

                def body(i, regs):
                    return update_registers_matmul(
                        regs, (hi[i], lo[i]), jnp.ones(sub, bool), p)
                return jax.lax.fori_loop(0, hi.shape[0], body, regs)

            try:
                bench(mm, chi, clo, regs,
                      f"matmul one-hot p={p} sub={sub}")
            except Exception as e:
                print(f"matmul p={p} sub={sub} failed: "
                      f"{type(e).__name__}: {e}", flush=True)


if __name__ == "__main__":
    main()
