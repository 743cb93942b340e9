"""Rolling DNA hashes for unbounded k: ntHash and a cyclic-polynomial hash.

The reference selects these with --use-nthash / --use-cyclic-hash
(EncodingType NTHASH / RK / CYCLIC, reference src/enums.h:42-47) to allow
k > 32 (guard at src/distmain.cpp:101-104).  Its implementations live in the
missing bonsai submodule; both are linear over GF(2):

    hash(window) = XOR_t  rotl64( table[base_t], (k-1-t) mod 64 )

so instead of rolling state base-by-base (sequential, accelerator-hostile), each
window's hash is a windowed XOR of position-rotated per-base constants —
the same shift-or structure as the exact encoder, fully vectorized.

ntHash uses the published per-base seeds (Mohamadi et al., 2016); canonical
mode takes min(forward, reverse-complement) like NTC64.  The cyclic hash
uses a WangHash-derived 4-entry table (the reference's exact table is inside
the missing submodule, so bit-compatibility is not claimed — semantics and
distribution match).
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import u64
from ..hashes import wang_hash_np
from .encode import base_codes

# ntHash per-base seeds (public constants from the ntHash paper/repo).
NT_SEEDS = np.array([0x3c8bfbb395c60474,   # A
                     0x3193c18562a02b4c,   # C
                     0x20323ed082572324,   # G
                     0x295549f54be24456],  # T
                    dtype=np.uint64)

# Cyclic-polynomial per-base table: fixed, derived from WangHash.
CYCLIC_SEEDS = wang_hash_np(np.arange(1, 5, dtype=np.uint64) * np.uint64(0x2545F4914F6CDD1D))

_COMP = np.array([3, 2, 1, 0], dtype=np.int64)  # A<->T, C<->G


def _rotl_np(x: np.ndarray, n: int) -> np.ndarray:
    n = int(n) % 64
    if n == 0:
        return x
    with np.errstate(over="ignore"):
        return (x << np.uint64(n)) | (x >> np.uint64(64 - n))


def _tables(k: int, kind: str) -> Tuple[np.ndarray, np.ndarray]:
    """(k, 4) uint64 rotated-constant tables for forward and rc hashes."""
    seeds = NT_SEEDS if kind == "nthash" else CYCLIC_SEEDS
    fwd = np.zeros((k, 4), np.uint64)
    rc = np.zeros((k, 4), np.uint64)
    for t in range(k):
        fwd[t] = _rotl_np(seeds, (k - 1 - t) % 64)
        rc[t] = _rotl_np(seeds[_COMP], t % 64)
    return fwd, rc


def _gather4(code: jnp.ndarray, consts: np.ndarray) -> u64.U64:
    """Select one of 4 uint64 constants per lane by 2-bit code."""
    hi = np.uint32(consts >> np.uint64(32))
    lo = np.uint32(consts & np.uint64(0xFFFFFFFF))
    out_hi = jnp.where(code == 0, jnp.uint32(hi[0]),
              jnp.where(code == 1, jnp.uint32(hi[1]),
               jnp.where(code == 2, jnp.uint32(hi[2]), jnp.uint32(hi[3]))))
    out_lo = jnp.where(code == 0, jnp.uint32(lo[0]),
              jnp.where(code == 1, jnp.uint32(lo[1]),
               jnp.where(code == 2, jnp.uint32(lo[2]), jnp.uint32(lo[3]))))
    return out_hi, out_lo


@functools.partial(jax.jit, static_argnames=("k", "kind", "canon", "w"))
def rolling_hash_tile(tile: jnp.ndarray, *, k: int, kind: str, canon: bool,
                      w: int = 0):
    """ASCII tile (R, C) -> ((hi, lo), valid) of shape (R, C - max(w,k) + 1).

    w > k applies minimizer-window selection to the rolling-hash stream:
    each w-window emits its minimum hash value (the reference applies the
    same Spacer window machinery to every encoding, for_each_hash included
    — reference src/sketch_and_cmp.h:296-297,338-352).  Windows touching
    an invalid k-mer (ambiguous base / record edge) are dropped whole,
    matching the bonsai encoder's full-window emission (ops/encode.py)."""
    code, valid = base_codes(tile)
    C = tile.shape[-1]
    W = C - k + 1
    ftab, rtab = _tables(k, kind)
    zeros = jnp.zeros(code.shape[:-1] + (W,), jnp.uint32)
    fh: u64.U64 = (zeros, zeros)
    rh: u64.U64 = (zeros, zeros)
    wvalid = jnp.ones(code.shape[:-1] + (W,), bool)
    for t in range(k):
        c_t = code[..., t:t + W]
        wvalid = wvalid & valid[..., t:t + W]
        fh = u64.xor(fh, _gather4(c_t, ftab[t]))
        if canon:
            rh = u64.xor(rh, _gather4(c_t, rtab[t]))
    h = u64.min_(fh, rh) if canon else fh
    if w > k:
        from .encode import _SENTINEL, full_window_valid, sliding_min
        win = w - k + 1
        sent = u64.full(h[0].shape, _SENTINEL)
        h = u64.select(wvalid, h, sent)
        h = sliding_min(h, win)
        wvalid = full_window_valid(wvalid, win)
    return h, wvalid


def rolling_hash_oracle(seq: bytes, k: int, kind: str, canon: bool,
                        w: int = 0) -> np.ndarray:
    """Slow host reference for tests.  w > k emits the minimum hash of
    each w-window whose k-mers are ALL valid (full-window emission)."""
    from .encode import _CODE_LUT
    codes = _CODE_LUT[np.frombuffer(seq, np.uint8)]
    ftab, rtab = _tables(k, kind)
    hashes, valid = [], []
    for i in range(len(codes) - k + 1):
        win = codes[i:i + k]
        if (win == 255).any():
            hashes.append(np.uint64(0))
            valid.append(False)
            continue
        fh = np.uint64(0)
        rh = np.uint64(0)
        for t in range(k):
            fh ^= ftab[t][win[t]]
            rh ^= rtab[t][win[t]]
        hashes.append(min(fh, rh) if canon else fh)
        valid.append(True)
    if w <= k:
        return np.asarray(
            [h for h, v in zip(hashes, valid) if v], np.uint64)
    win = w - k + 1
    out = []
    for i in range(len(hashes) - win + 1):
        if all(valid[i:i + win]):
            out.append(min(hashes[i:i + win]))
    return np.asarray(out, np.uint64)
