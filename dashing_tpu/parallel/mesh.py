"""Device-mesh sharding: the distributed layer the reference never had.

The reference is single-node OpenMP (SURVEY.md sec 2.4); its parallel
structures map onto a jax.sharding.Mesh as:

  P1 file-level OMP loop        -> data-parallel rows over mesh axis 'd'
  P4 union merge tree           -> elementwise-max all-reduce (lax.pmax)
     (reference src/union.cpp:11-24)  — register max is associative
  P3 pairwise OMP loops         -> 2-D sharded tile grid ('i' rows, 'j' cols)
     (reference src/sketch_and_cmp.h:704-706)

Because every sketch merge is an elementwise max and the distance grid is
embarrassingly tileable, no other collective is needed.  The mesh follows
the algorithm: every device of a host reaches every other at the same rate.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from ..ops import pairwise as pw
from ..ops.encode import encode_tile
from ..ops.hll_update import bucket_rank
from ..hashes import wang_hash
from ..sketch import estimators as est

# ---------------------------------------------------------------------------
# Production within-host mesh (VERDICT r1 item 1): the CLI sketch/compare
# paths detect >1 local device and run the TUNED pipeline sharded over this
# mesh.  The reference's analog is the OpenMP loops
# (src/sketch_and_cmp.h:484-528, distmat/distmat.h:459-512).
# ---------------------------------------------------------------------------

_LOCAL_MESH: Optional[Mesh] = None
_LOCAL_MESH_SET = False


def local_mesh() -> Optional[Mesh]:
    """1-D ('d',) mesh over the largest power-of-2 count of local devices;
    None when <2 devices or DASHING_TPU_NO_MESH=1.  Cached: the device
    topology cannot change within a process."""
    global _LOCAL_MESH, _LOCAL_MESH_SET
    if not _LOCAL_MESH_SET:
        _LOCAL_MESH_SET = True
        if os.environ.get("DASHING_TPU_NO_MESH", "") not in ("", "0"):
            _LOCAL_MESH = None
        else:
            devs = jax.local_devices()
            n = 1 << (len(devs).bit_length() - 1)
            _LOCAL_MESH = Mesh(np.asarray(devs[:n]), ("d",)) if n > 1 else None
    return _LOCAL_MESH


def _set_local_mesh_for_tests(mesh: Optional[Mesh], frozen: bool = True):
    """Test hook: pin (or clear with frozen=False) the cached local mesh."""
    global _LOCAL_MESH, _LOCAL_MESH_SET
    _LOCAL_MESH = mesh
    _LOCAL_MESH_SET = frozen


def replicate(arr, mesh: Mesh):
    """Put an array on every mesh device (so later sharded ops reshard
    locally instead of pulling from one device)."""
    return jax.device_put(arr, NamedSharding(mesh, P()))


def make_mesh(n_devices: int = 0, axes: Tuple[str, ...] = ("d",)) -> Mesh:
    devs = jax.devices()
    n = n_devices or len(devs)
    if n > len(devs):
        raise ValueError(f"requested {n} devices, have {len(devs)}")
    if len(axes) == 1:
        return Mesh(np.asarray(devs[:n]), axes)
    # 2-D grid: factor n as close to square as possible
    rows = 1
    for r in range(int(n ** 0.5), 0, -1):
        if n % r == 0:
            rows = r
            break
    grid = np.asarray(devs[:n]).reshape(rows, n // rows)
    return Mesh(grid, axes)


def sharded_sketch_step(mesh: Mesh, *, k: int, p: int, canon: bool = True):
    """Build a jitted step: (rows, C) tiles sharded over 'd' -> replicated
    (m,) int32 registers (per-device partial update + max all-reduce).

    This is the 'sequence parallel' analog for sketching: one genome's tiles
    spread across devices, merged by a register-max collective.
    """
    sp_positions = tuple(range(k))

    def local(tiles, regs):
        km, valid = encode_tile(tiles, k=k, w=k, positions=sp_positions,
                                span=k, canon=canon)
        h = wang_hash(km)
        idx, rank = bucket_rank(h, p)
        rank = jnp.where(valid, rank, 0)
        upd = regs.at[idx.reshape(-1)].max(rank.reshape(-1), mode="drop")
        return jax.lax.pmax(upd, "d")

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P("d", None), P()),
                   out_specs=P())
    return jax.jit(fn)


def sharded_pair_tile(mesh: Mesh, *, p: int, kmax: int, result_type: int,
                      ksinv: float, estim: int, jestim: int):
    """Build a jitted 2-D-sharded all-pairs step: registers (n, m) sharded
    by rows on 'i' for A and on 'j' for B; output (n, n) sharded ('i', 'j').

    Each device computes its (n/i_dev, n/j_dev) block of the measure matrix
    locally — the multi-device replacement for dm::parallel_fill
    (reference distmat/distmat.h:459-512).
    """
    def local(a_regs, b_regs):
        stats = pw.pair_stats(a_regs, b_regs, kmax,
                              jestim == est.ERTL_JOINT_MLE)
        tri = pw.triples_from_stats(stats, p, estim, jestim)
        return pw.measure_from_triples(tri, result_type, ksinv)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P("i", None), P("j", None)),
                   out_specs=P("i", "j"))
    return jax.jit(fn)


def sharded_union(mesh: Mesh):
    """(n_sketches, m) registers sharded over 'd' -> replicated merged (m,).
    The reference's log2-depth OpenMP merge tree (src/union.cpp:11-24) as a
    single max all-reduce."""
    def local(regs):
        return jax.lax.pmax(regs.max(axis=0), "d")

    fn = shard_map(local, mesh=mesh, in_specs=(P("d", None),),
                   out_specs=P())
    return jax.jit(fn)


def shard_rows(mesh: Mesh, arr: jnp.ndarray, axis_name: str = "d"):
    return jax.device_put(arr, NamedSharding(mesh, P(axis_name, None)))
