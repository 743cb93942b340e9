"""Register-update strategy sweep (VERDICT r1 item 2: 578M -> >=1G kmers/s).

Benchmarks the HLL register-update stage in isolation on realistic
mid-stream conditions (registers pre-warmed so min(regs) ~ log2(n/m)),
then the full pipeline (encode+hash -> update) for the most promising
variants.

Timing rules (CLAUDE.md): loop inside jit with the register carry as the
cross-iteration dependence; device_get only the final registers.

Run on the GPU:  python benchmarks/update_sweep.py [mode]
  mode = "update" (default): isolated update variants
  mode = "fused":  full pipeline at the best (row, cap) candidates
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np

import _common
_common.setup()


P = 14
ROWS = 256
CONTENT = 8192
ITERS = 30
K = 31


def _stream(rng, n_chunks: int, chunk: int):
    """Realistic (idx, rank) stream: idx uniform, rank geometric."""
    idx = rng.integers(0, 1 << P, size=(n_chunks, chunk), dtype=np.int64)
    u = rng.random(size=(n_chunks, chunk))
    rank = np.minimum(1 + np.floor(-np.log2(np.maximum(u, 1e-18))),
                      64 - P + 1).astype(np.int64)
    return idx.astype(np.int32), rank.astype(np.int32)


def _warm_regs(rng):
    """Registers after ~5M elements: min ~ 8 at p=14."""
    lam = 5e6 / (1 << P)
    base = int(np.floor(np.log2(lam)))
    regs = (base + rng.geometric(0.5, size=1 << P)).astype(np.int32)
    return np.minimum(regs, 64 - P + 1)


def bench_update(update_fn, idx, rank, regs0, label: str):
    import jax
    import jax.numpy as jnp
    idx_d, rank_d = jnp.asarray(idx), jnp.asarray(rank)
    regs_d = jnp.asarray(regs0)

    @jax.jit
    def run(idx_d, rank_d, regs):
        def body(i, regs):
            return update_fn(regs, idx_d[i], rank_d[i])
        return jax.lax.fori_loop(0, idx_d.shape[0], body, regs)

    _ = jax.device_get(run(idx_d, rank_d, regs_d))
    n = idx.size
    best = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        _ = jax.device_get(run(idx_d, rank_d, regs_d))
        best = max(best, n / (time.perf_counter() - t0))
    print(f"{label:42s} {best/1e6:9.1f} M elem/s", flush=True)
    return best


def main_update():
    import jax.numpy as jnp
    from dashing_tpu.ops.hll_update import update_from_idx_rank

    rng = np.random.default_rng(0)
    idx, rank = _stream(rng, ITERS, ROWS * CONTENT)
    regs0 = _warm_regs(rng)

    # current default
    for row, cap in [(2048, 64), (2048, 32), (1024, 64), (1024, 32),
                     (1024, 16), (512, 32), (512, 16), (512, 8),
                     (256, 16), (256, 8), (128, 8), (4096, 128)]:
        bench_update(
            lambda regs, i, r, row=row, cap=cap:
                update_from_idx_rank(regs, i, r, row=row, cap=cap),
            idx, rank, regs0, f"top_k row={row} cap={cap}")

    # full scatter baseline
    def full_scatter(regs, i, r):
        return regs.at[i.reshape(-1)].max(r.reshape(-1), mode="drop")
    bench_update(full_scatter, idx, rank, regs0, "full scatter")

    # banked full scatter: B register copies, scatter a stripe into each,
    # max-merge at the end of the whole stream (here: per chunk, amortized
    # by keeping banks as the carry would need a different harness; this
    # measures the per-chunk cost incl. merge)
    for B in (8, 32):
        def banked(regs, i, r, B=B):
            m = regs.shape[0]
            banks = jnp.zeros((B, m), jnp.int32)
            i2 = i.reshape(B, -1)
            r2 = r.reshape(B, -1)
            banks = banks.at[
                jnp.arange(B, dtype=jnp.int32)[:, None], i2].max(r2,
                                                                 mode="drop")
            return jnp.maximum(regs, banks.max(0))
        bench_update(banked, idx, rank, regs0, f"banked scatter B={B}")


def _idx_rank(chunk):
    """ASCII tile -> (bucket idx, rank): the packed sketch path's encode."""
    from dashing_tpu.ops.encode import base_codes, idx_rank_from_codes
    code, valid = base_codes(chunk)
    return idx_rank_from_codes(code, valid, k=K, p=P, canon=True)


def main_fused():
    import jax
    import jax.numpy as jnp
    from dashing_tpu.ops.hll_update import update_from_idx_rank

    rng = np.random.default_rng(0)
    C = CONTENT + K - 1
    chunks = jnp.asarray(rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                    size=(ITERS, ROWS, C)))
    kmers = ROWS * CONTENT * ITERS
    for row, cap in [(2048, 64), (1024, 32), (512, 16), (512, 32),
                     (256, 16), (256, 8)]:
        @jax.jit
        def run(chunks, regs, row=row, cap=cap):
            def body(i, regs):
                idx, rank = _idx_rank(chunks[i])
                return update_from_idx_rank(regs, idx, rank, row=row,
                                            cap=cap)
            return jax.lax.fori_loop(0, chunks.shape[0], body, regs)
        regs = jnp.zeros(1 << P, jnp.int32)
        _ = jax.device_get(run(chunks, regs))
        best = 0.0
        for _ in range(3):
            t0 = time.perf_counter()
            _ = jax.device_get(run(chunks, regs))
            best = max(best, kmers / (time.perf_counter() - t0))
        print(f"fused row={row} cap={cap}: {best/1e6:9.1f} M kmers/s",
              flush=True)



def main_int16():
    """int16 top_k probe: row 512 keys pack (rank 6b | lane 9b) = 15 bits."""
    import jax
    import jax.numpy as jnp
    rng = np.random.default_rng(0)
    idx, rank = _stream(rng, ITERS, ROWS * CONTENT)
    regs0 = _warm_regs(rng)

    def mk(dtype, row, cap):
        shift = row.bit_length() - 1

        def upd(regs, i, r):
            i2 = i.reshape(-1, row)
            r2 = r.reshape(-1, row)
            t = regs.min()
            lane = jax.lax.broadcasted_iota(jnp.int32, r2.shape, 1)
            key = ((r2 << shift) | lane).astype(dtype)
            vals, pos = jax.lax.top_k(key, cap)
            kept = (vals.astype(jnp.int32)) >> shift
            keep = kept > t
            sidx = jnp.where(keep, jnp.take_along_axis(i2, pos, axis=1), 0)
            srank = jnp.where(keep, kept, 0)
            return regs.at[sidx.reshape(-1)].max(srank.reshape(-1),
                                                 mode="drop")
        return upd

    for dtype, row, cap in [(jnp.int32, 512, 8), (jnp.int16, 512, 8),
                            (jnp.int32, 512, 16), (jnp.int16, 512, 16),
                            (jnp.int16, 256, 8)]:
        try:
            bench_update(mk(dtype, row, cap), idx, rank, regs0,
                         f"topk {dtype.__name__} row={row} cap={cap}")
        except Exception as e:
            print(f"{dtype.__name__} row={row}: FAIL {str(e)[:120]}",
                  flush=True)


def main_roofline():
    """Phase roofline for the sketch-update pipeline (VERDICT r3 item 7):
    encode+hash alone, compaction+scatter alone (warm registers, the
    adaptive-cap production config), and the fused pipeline — plus the
    serial composition bound 1/(1/enc + 1/upd) the fused number should
    approach (phases share the chip; there is no second core to overlap
    into, so the bound is additive, not max)."""
    import jax
    import jax.numpy as jnp
    from dashing_tpu.ops.hll_update import update_from_idx_rank, adaptive_cap, _ROW

    rng = np.random.default_rng(0)
    C = CONTENT + K - 1
    chunks = jnp.asarray(rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                    size=(ITERS, ROWS, C)))
    kmers = ROWS * CONTENT * ITERS

    @jax.jit
    def enc_only(chunks):
        def body(i, acc):
            idx, rank = _idx_rank(chunks[i])
            return acc + idx.sum() + rank.sum()
        return jax.lax.fori_loop(0, chunks.shape[0], body, jnp.int32(0))

    _ = jax.device_get(enc_only(chunks))
    enc = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        _ = jax.device_get(enc_only(chunks))
        enc = max(enc, kmers / (time.perf_counter() - t0))
    print(f"encode+hash only:      {enc/1e6:9.1f} M kmers/s", flush=True)

    idx, rank = _stream(rng, ITERS, ROWS * CONTENT)
    regs0 = _warm_regs(rng)
    # production mid-stream config: warm registers -> adaptive cap 16
    cap = adaptive_cap(_ROW, 1 << P, 5_000_000)
    upd = bench_update(
        lambda regs, i, r: update_from_idx_rank(regs, i, r, cap=cap),
        idx, rank, regs0, f"update only (warm, cap={cap})")

    bound = 1.0 / (1.0 / enc + 1.0 / upd)
    print(f"serial composition bound: {bound/1e6:9.1f} M kmers/s",
          flush=True)

    @jax.jit
    def fused(chunks, regs):
        def body(i, regs):
            idx, rank = _idx_rank(chunks[i])
            return update_from_idx_rank(regs, idx, rank, cap=cap)
        return jax.lax.fori_loop(0, chunks.shape[0], body, regs)

    regs_w = jnp.asarray(regs0)
    _ = jax.device_get(fused(chunks, regs_w))
    best = 0.0
    for _ in range(3):
        t0 = time.perf_counter()
        _ = jax.device_get(fused(chunks, regs_w))
        best = max(best, kmers / (time.perf_counter() - t0))
    print(f"fused (warm, cap={cap}):  {best/1e6:9.1f} M kmers/s "
          f"({100*best/bound:.0f}% of bound)", flush=True)


if __name__ == "__main__":
    mode = sys.argv[1] if len(sys.argv) > 1 else "update"
    {"fused": main_fused, "int16": main_int16,
     "roofline": main_roofline}.get(mode, main_update)()
