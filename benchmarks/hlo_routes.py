"""What XLA makes of three hot-path pieces on this device, from the
compiled HLO:

  * the register contraction `_dot` (ops/pairwise.py) — which library
    call or generated kernel the int8 x int8 -> int32 product became;
  * the sketch step's encode -> hash -> register update
    (pipeline._tile_to_registers) — how many fusions it compiles to;
  * the survivor compaction's lax.top_k at every capacity the sketch
    path uses (16 .. 512 over rows of 2048) — that each compiles.

    python benchmarks/hlo_routes.py
"""
from __future__ import annotations

import re
import sys

import _common
_common.setup()


def main() -> int:
    import jax
    import jax.numpy as jnp
    from dashing_tpu import pipeline
    from dashing_tpu.ops import pairwise as pw
    from dashing_tpu.ops.hll_update import _ROW

    d = jax.devices()[0]
    print(f"device: {d.platform} {d.device_kind}")
    a = jnp.zeros((1024, 1 << 14), jnp.int8)
    txt = pw.pair_stats.lower(a, a, 31, True, 8).compile().as_text()
    calls = sorted(set(re.findall(r'custom_call_target="([^"]+)"', txt)))
    kinds = sorted(set(re.findall(r'"kind":"(__[a-z_]+)"', txt)))
    dots = len(re.findall(r" dot\(", txt))
    print(f"pair_stats(1024 x 16384 int8, 24 levels, joint): custom calls "
          f"{calls}; generated-kernel kinds {kinds}; plain dot ops {dots}")
    params = pipeline.SketchParams(k=31)
    kw = pipeline._encode_kw(params, params.spacer())
    tile = jnp.zeros((256, 8192 + 30 + 2), jnp.uint8)
    txt = pipeline._tile_to_registers.lower(
        tile, jnp.zeros(1 << 14, jnp.int32), **kw, p=14).compile().as_text()
    entry = txt[txt.index("ENTRY"):]
    print(f"sketch step (256 x {tile.shape[1]}, k=31, p=14): "
          f"{len(re.findall(r' fusion\(', entry))} fusions in the entry "
          f"computation")
    keys = jnp.zeros((64, _ROW), jnp.int32)
    for k in (16, 32, 64, 128, 256, 512):
        jax.jit(lambda x, k=k: jax.lax.top_k(x, k)).lower(keys).compile()
        print(f"lax.top_k k={k} over rows of {_ROW}: compiled")
    return 0


if __name__ == "__main__":
    sys.exit(main())
