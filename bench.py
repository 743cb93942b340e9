"""Headline benchmark: k-mers sketched per second per device.

Measures the device sketch pipeline (2-bit canonical encode -> WangHash ->
HLL register scatter-max) on device-resident tiles — the hot loop that
dominates `dashing sketch` (reference src/sketch_and_cmp.h:484-528).

Prints the device (JAX platform, device kind, count, and the card's
`nvidia-smi` name and power limit) on stderr, then ONE JSON line:
  {"metric": ..., "value": N, "unit": "kmers/s", "vs_baseline": N, ...}

vs_baseline divides by a single-thread numpy host implementation of the
identical pipeline, measured in the same run on the same host (the
reference binary is not buildable here: its bonsai submodule is absent;
SURVEY.md sec 0/6).

Run on a GPU: `python bench.py`.  Without a GPU it fails, unless
DASHING_TPU_PLATFORM=cpu asks for a CPU run (whose rate is not a device
number).
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

K = 31
P = 14
ROWS = 256
CONTENT = 8192             # matches the pipeline tile geometry
ITERS = 30


def setup_device() -> dict:
    """Select the platform, enable the compile cache and describe the
    device.  Raises unless a GPU is present or DASHING_TPU_PLATFORM=cpu."""
    import jax
    from dashing_tpu import compile_cache
    plat = os.environ.get("DASHING_TPU_PLATFORM", "")
    if plat:
        jax.config.update("jax_platforms", plat)
    compile_cache.enable()
    devs = jax.devices()
    info = {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}
    if info["platform"] != "gpu" and plat != "cpu":
        raise SystemExit(f"bench: no GPU found (platform "
                         f"{info['platform']!r}); set DASHING_TPU_PLATFORM"
                         f"=cpu for a CPU run")
    return info


def card_name_and_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` output, or why not."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=30)
        return r.stdout.strip() or r.stderr.strip()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def device_rate() -> float:
    import jax
    import jax.numpy as jnp
    from dashing_tpu.ops.encode import encode_tile
    from dashing_tpu.ops.hll_update import (_ROW, adaptive_cap,
                                            update_registers_filtered)
    from dashing_tpu.hashes import wang_hash

    positions = tuple(range(K))
    # chunk i -> survivor capacity, mirroring production's per-chunk choice
    # (ops/hll_update.adaptive_cap); the schedule is static at trace time
    # and selected in-jit by lax.switch, so the whole stream stays ONE
    # dispatch.
    per_chunk = ROWS * CONTENT
    caps = sorted({adaptive_cap(_ROW, 1 << P, i * per_chunk)
                   for i in range(ITERS)})
    cap_idx = np.array([caps.index(adaptive_cap(_ROW, 1 << P, i * per_chunk))
                        for i in range(ITERS)], np.int32)

    @jax.jit
    def run(chunks, regs, cap_idx):
        def update(cap, chunk, regs):
            km, valid = encode_tile(chunk, k=K, w=K, positions=positions,
                                    span=K, canon=True)
            return update_registers_filtered(regs, wang_hash(km), valid, P,
                                             cap=cap)

        def body(i, regs):
            branches = [functools.partial(update, cap) for cap in caps]
            return jax.lax.switch(cap_idx[i], branches, chunks[i], regs)
        return jax.lax.fori_loop(0, chunks.shape[0], body, regs)

    rng = np.random.default_rng(0)
    C = CONTENT + K - 1
    chunks = jnp.asarray(rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                    size=(ITERS, ROWS, C)))
    regs = jnp.zeros(1 << P, jnp.int32)
    ci = jnp.asarray(cap_idx)
    _ = jax.device_get(run(chunks, regs, ci))     # compile + warm
    kmers = ROWS * CONTENT * ITERS
    best = 0.0
    for _rep in range(3):
        t0 = time.perf_counter()
        out = run(chunks, regs, ci)
        _ = jax.device_get(out)                   # forces real completion
        best = max(best, kmers / (time.perf_counter() - t0))
    return best


def host_baseline_rate(n: int = 1 << 20) -> float:
    """Single-thread numpy version of the same pipeline, measured in this
    run (best of 3: single-shot host timings vary with machine load)."""
    from dashing_tpu.hashes import wang_hash_np

    rng = np.random.default_rng(0)
    seq = rng.integers(0, 4, n + K - 1, dtype=np.uint64)
    best = 0.0
    for _rep in range(3):
        t0 = time.perf_counter()
        # shift-or encode (fwd + rc + canonical), hash, bucket/rank, scatter
        fwd = np.zeros(n, np.uint64)
        rc = np.zeros(n, np.uint64)
        for t in range(K):
            fwd = (fwd << np.uint64(2)) | seq[t:t + n]
            rc |= (np.uint64(3) - seq[t:t + n]) << np.uint64(2 * t)
        km = np.minimum(fwd, rc)
        h = wang_hash_np(km)
        idx = (h >> np.uint64(64 - P)).astype(np.int64)
        rest = (h << np.uint64(P)) | np.uint64(1 << (P - 1))
        cnt = np.zeros(n, np.int64)
        y = rest.copy()
        for sh in (32, 16, 8, 4, 2, 1):
            zt = (y >> np.uint64(64 - sh)) == 0
            cnt += np.where(zt, sh, 0)
            y = np.where(zt, y << np.uint64(sh), y)
        regs = np.zeros(1 << P, np.uint8)
        np.maximum.at(regs, idx, (cnt + 1).astype(np.uint8))
        dt = time.perf_counter() - t0
        best = max(best, n / dt)
    return best


def main() -> int:
    info = setup_device()
    print(f"device: {info}", file=sys.stderr)
    print(f"card: {card_name_and_power()}", file=sys.stderr)
    dev = device_rate()
    base = host_baseline_rate()
    print(json.dumps({
        "metric": "kmers_sketched_per_sec_per_device",
        "value": dev,
        "unit": "kmers/s",
        "vs_baseline": dev / base,
        "host_baseline": base,
        "device": info,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
