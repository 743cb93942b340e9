"""Vectorized k-mer encoding: the device replacement for bonsai's Encoder.

The reference encoder (bonsai/encoder.h, missing submodule; call sites at
reference src/sketch_and_cmp.h:180-206,296-297,338-352) streams one base at a
time through a rolling 2-bit window and fires a callback per k-mer.  Here a
whole tile of sequence is encoded at once:

    bases  (R, C) uint8 ASCII   ->   k-mer codes (R, C-k+1) as u64 pairs
                                     + validity mask

Semantics replicated from the reference ("BONSAI" encoding, exact k<=32):
  * 2-bit codes A=0, C=1, G=2, T=3 (case-insensitive); any other byte
    (N, IUPAC, gaps) invalidates every k-mer window containing it.
  * k-mer integer = first base in the most-significant bits
    (kmer = (kmer << 2) | code, the universal convention).
  * canonical k-mer = min(kmer, revcomp(kmer)) when canonicalization is on
    (reference default; `-C/--no-canon` disables, src/dashing.h:52).
  * window minimization (w > k): emit only the minimum-valued k-mer of each
    w-base window (bonsai's score::Lex minimizer; flag -w).
  * spaced seeds: only pattern-selected positions contribute 2 bits each
    (bonsai Spacer; flag -s, parsed by `parse_spacing`).

Tiling contract: callers pass rows that OVERLAP by (span-1) bases (the halo),
so every k-mer of the original sequence appears in exactly one row's output.
Record boundaries are handled by joining records with (span-1) invalid bytes.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .. import u64
from ..u64 import U64

# ---------------------------------------------------------------------------
# Base -> 2-bit code lookup.
# ---------------------------------------------------------------------------

_A, _C, _G, _T = 65, 67, 71, 84  # ASCII, uppercase


def base_codes(tile: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """ASCII bases (any integer dtype) -> (code in {0..3}, valid bool).

    Codes come back in the input's dtype.
    """
    up = tile & 0xDF  # cheap uppercase for ASCII letters
    dt = tile.dtype
    code = jnp.zeros(tile.shape, dt)
    code = jnp.where(up == _C, jnp.asarray(1, dt), code)
    code = jnp.where(up == _G, jnp.asarray(2, dt), code)
    code = jnp.where(up == _T, jnp.asarray(3, dt), code)
    valid = (up == _A) | (up == _C) | (up == _G) | (up == _T)
    return code, valid


# ---------------------------------------------------------------------------
# Spacing (spaced seeds).  Mirrors bonsai's Spacer / parse_spacing:
# the CLI string "<skip>x<times>,<skip>x<times>,..." lists gaps inserted
# after successive k-mer positions (reference src/dashing.cpp:58-60 usage;
# src/distmain.cpp:121 `Spacer sp(k, wsz, parse_spacing(spacing, k))`).
# ---------------------------------------------------------------------------

def parse_spacing(spacing: str, k: int) -> List[int]:
    """Parse the -s spacing string into a list of k-1 inter-position gaps."""
    if not spacing:
        return [0] * (k - 1)
    gaps: List[int] = []
    for part in spacing.split(","):
        if not part:
            continue
        if "x" in part:
            skip, times = part.split("x")
            gaps.extend([int(skip)] * int(times))
        else:
            gaps.append(int(part))
    if any(g < 0 for g in gaps):
        # negative gaps would sample non-monotonic/duplicate positions
        # (silently degenerate sketches) or drive the span to zero
        raise ValueError(f"spacing gaps must be >= 0, got {gaps}")
    if len(gaps) > k - 1:
        raise ValueError(f"spacing defines {len(gaps)} gaps but k={k} allows {k - 1}")
    gaps.extend([0] * (k - 1 - len(gaps)))
    return gaps


class Spacer:
    """k-mer shape: k sampled positions over a span of c bases, window w.

    Mirrors bonsai's Spacer(k, w, spvec): span c = k + sum(gaps); the
    effective window w is max(w, c) (reference src/dashing.cpp:370
    `if(wsz < sp.c_) wsz = sp.c_`).
    """

    def __init__(self, k: int, w: int = 0, gaps: Optional[List[int]] = None):
        # k > 32 is legal for the rolling encoders (reference
        # src/enums.h:42-47: NTHASH/CYCLIC are unbounded); the BONSAI
        # 2-bit-exact limit is enforced where that encoding is actually
        # used (encode_tile / cli validate_k).
        if k < 1:
            raise ValueError("k must be >= 1")
        gaps = gaps if gaps is not None else [0] * (k - 1)
        self.k = k
        self.positions = [0]
        for g in gaps:
            self.positions.append(self.positions[-1] + 1 + g)
        self.c = self.positions[-1] + 1  # span in bases
        self.w = max(w, self.c)
        self.spaced = any(g for g in gaps)

    @property
    def halo(self) -> int:
        """Bases of overlap adjacent tiles need so no k-mer is missed."""
        return self.w - 1


# ---------------------------------------------------------------------------
# Core tile encoder.
# ---------------------------------------------------------------------------

def _pack_doubling(vals: jnp.ndarray, k: int, W: int, reverse: bool) -> U64:
    """Pack runs of k 2-bit codes into u64 via log-doubling.

    F_j[i] = codes i..i+2^j-1 (MSB-first); doubling combines two adjacent
    blocks, so k codes pack in ceil(log2 k) vector passes instead of k
    (a ~5-10x VPU saving at k=21..31).  reverse=True packs back-to-front
    (for the reverse-complement strand).
    """
    C = vals.shape[-1]
    f: U64 = (jnp.zeros(vals.shape, jnp.uint32), vals.astype(jnp.uint32))
    length = 1
    while length * 2 <= k:
        off = length
        avail = C - (length * 2 - 1)
        if reverse:
            hi_part = (f[0][..., off:off + avail], f[1][..., off:off + avail])
            lo_part = (f[0][..., :avail], f[1][..., :avail])
        else:
            hi_part = (f[0][..., :avail], f[1][..., :avail])
            lo_part = (f[0][..., off:off + avail], f[1][..., off:off + avail])
        f = u64.or_(u64.shl(hi_part, 2 * length), lo_part)
        length *= 2
    if length == k:
        return f[0][..., :W], f[1][..., :W]
    # combine the big block with an overlapping copy covering the tail
    r = k - length
    if reverse:
        # reverse pack of window [i, i+k): big block covers the LAST `length`
        # codes (positions i+r..i+k-1) in reverse; the low 2r bits come from
        # the reverse pack of the first r... by symmetry use the overlap at
        # offset 0 for the tail and shift the big block.
        big = (f[0][..., r:r + W], f[1][..., r:r + W])
        tail = (f[0][..., :W], f[1][..., :W])
    else:
        big = (f[0][..., :W], f[1][..., :W])
        tail = (f[0][..., r:r + W], f[1][..., r:r + W])
    mask_lo = (1 << (2 * r)) - 1
    tail_masked = u64.and_(tail, u64.full(tail[0].shape, mask_lo))
    return u64.or_(u64.shl(big, 2 * r), tail_masked)


def _window_all(valid: jnp.ndarray, k: int, W: int) -> jnp.ndarray:
    """AND over k-windows by log-doubling (cumsum-free: doubling is the
    same pass count as a prefix sum and lowers anywhere)."""
    v = valid
    length = 1
    C = valid.shape[-1]
    while length * 2 <= k:
        avail = C - (length * 2 - 1)
        v = v[..., :avail] & v[..., length:length + avail]
        length *= 2
    if length == k:
        return v[..., :W]
    r = k - length
    return v[..., :W] & v[..., r:r + W]


def _shift_or_kmers_contiguous(code: jnp.ndarray, valid: jnp.ndarray, k: int
                               ) -> Tuple[U64, U64, jnp.ndarray]:
    """Fast path for contiguous k-mers: log-doubling packs + windowed
    validity, all in O(log k) vector passes."""
    C = code.shape[-1]
    W = C - k + 1
    fwd = _pack_doubling(code, k, W, reverse=False)
    rc = _pack_doubling((3 - code.astype(jnp.int32)).astype(jnp.uint32) & 3,
                        k, W, reverse=True)
    wvalid = _window_all(valid, k, W)
    return fwd, rc, wvalid


def _shift_or_kmers(code: jnp.ndarray, valid: jnp.ndarray, positions: Tuple[int, ...],
                    span: int) -> Tuple[U64, U64, jnp.ndarray]:
    """Build forward and reverse-complement k-mer codes for every window.

    code/valid: (R, C).  Output arrays have width W = C - span + 1; window i
    covers bases [i, i+span).  Returns (fwd, rc, window_valid).
    """
    C = code.shape[-1]
    W = C - span + 1
    k = len(positions)
    zeros = jnp.zeros(code.shape[:-1] + (W,), jnp.uint32)
    fwd: U64 = (zeros, zeros)
    rc: U64 = (zeros, zeros)
    wvalid = jnp.ones(code.shape[:-1] + (W,), bool)
    for t in range(k):
        p = positions[t]
        c_t = code[..., p:p + W].astype(jnp.uint32)
        v_t = valid[..., p:p + W]
        wvalid = wvalid & v_t
        # forward: position t lands at bit offset 2*(k-1-t)
        fwd = u64.or_(fwd, u64.shl((jnp.zeros_like(c_t), c_t), 2 * (k - 1 - t)))
        # reverse complement OF THE PACKED k-mer (complement each sampled
        # base, reverse their order): slot t samples positions[k-1-t].
        # This matches encode_oracle / bonsai's canonical_representation on
        # the packed value — for contiguous k-mers it coincides with
        # sampling the rc strand; for asymmetric spaced seeds it does not,
        # and the packed-value convention is the one the exact-set oracle
        # (and the reference) uses.
        p_rc = positions[k - 1 - t]
        c_rc = (3 - code[..., p_rc:p_rc + W]).astype(jnp.uint32)
        rc = u64.or_(rc, u64.shl((jnp.zeros_like(c_rc), c_rc), 2 * (k - 1 - t)))
    return fwd, rc, wvalid


_SENTINEL = 0xFFFFFFFFFFFFFFFF  # larger than any 2k-bit k-mer code (k<=32 ok
# because canonical codes use at most 64 bits; invalid windows get this so
# they never win a minimizer comparison and are filterable afterwards)


@functools.partial(jax.jit, static_argnames=("k", "w", "positions", "span",
                                             "canon", "entropy"))
def encode_tile(tile: jnp.ndarray, *, k: int, w: int, positions: Tuple[int, ...],
                span: int, canon: bool, entropy: bool = False
                ) -> Tuple[U64, jnp.ndarray]:
    """Encode one (R, C) uint8 ASCII tile into k-mer codes.

    Returns ((hi, lo), valid) of shape (R, C - w + 1): one output per
    w-window (for w == span this is one per k-mer position).  Invalid
    entries carry the sentinel value 2^64-1.

    entropy=True scores minimizer windows by Shannon entropy of the k-mer's
    base composition instead of the lexicographic value (the reference's
    -g/--by-entropy, bonsai score::Entropy; src/distmain.cpp:68).
    """
    if k > 32:
        raise ValueError("BONSAI exact encoding requires k <= 32 "
                         "(use the nthash/cyclic rolling encoders)")
    code, valid = base_codes(tile)
    contiguous = span == k and positions == tuple(range(k))
    if contiguous:
        fwd, rc, wvalid = _shift_or_kmers_contiguous(code, valid, k)
    else:
        fwd, rc, wvalid = _shift_or_kmers(code, valid, positions, span)
    if canon:
        km = u64.min_(fwd, rc)
    else:
        km = fwd
    sent = u64.full(km[0].shape, _SENTINEL)
    km = u64.select(wvalid, km, sent)
    if w > span:
        win = w - span + 1
        if entropy:
            km = _entropy_sliding_min(km, wvalid, code, positions, win)
        else:
            km = sliding_min(km, win)
        # A w-window emits only when every k-mer inside it is valid (fully
        # in-record, no ambiguous bases).  This matches the reference's
        # full-window minimizer emission for clean sequence; windows touching
        # Ns or record edges are dropped rather than emitting subset minima.
        wvalid = full_window_valid(wvalid, win)
    return km, wvalid


def full_window_valid(wvalid: jnp.ndarray, win: int) -> jnp.ndarray:
    """A w-window emits only when every k-mer inside it is valid — THE
    single source of the full-window emission mask (the bonsai encoder
    above and ops/rolling.py both use it; the semantics are byte-compat
    load-bearing, so the padded-cumsum trick must not fork)."""
    inv = (~wvalid).astype(jnp.int32)
    csum = jnp.cumsum(inv, axis=-1)
    pad = jnp.zeros(csum.shape[:-1] + (1,), jnp.int32)
    csum = jnp.concatenate([pad, csum], axis=-1)
    return (csum[..., win:] - csum[..., :-win]) == 0


def _entropy_sliding_min(km: U64, wvalid: jnp.ndarray, code: jnp.ndarray,
                         positions, win: int) -> U64:
    """Minimizer selection by base-composition entropy.

    Key per k-mer = u64(hi=quantized entropy (capped at 2^20-1),
    lo=in-row offset), so a sliding u64-min picks the lowest-entropy
    k-mer (ties to the leftmost), whose value is then gathered by
    offset.  Invalid k-mers get the sentinel.
    """
    k = len(positions)
    W = km[0].shape[-1]
    # per-position base counts over the k sampled positions
    counts = [jnp.zeros(km[0].shape, jnp.float32) for _ in range(4)]
    for t in range(k):
        c_t = code[..., positions[t]:positions[t] + W]
        for b in range(4):
            counts[b] = counts[b] + (c_t == b).astype(jnp.float32)
    ent = jnp.zeros(km[0].shape, jnp.float32)
    for b in range(4):
        pr = counts[b] / float(k)
        ent = ent - jnp.where(pr > 0, pr * jnp.log2(jnp.maximum(pr, 1e-9)), 0.0)
    entq = jnp.minimum((ent * (2.0 ** 18)).astype(jnp.uint32), (1 << 20) - 1)
    offs = jax.lax.broadcasted_iota(jnp.uint32, km[0].shape, km[0].ndim - 1)
    # validity comes from the caller's window mask, NOT a sentinel-value
    # compare: a legitimate all-T 32-mer (canon off) aliases the sentinel
    # and must still be selectable
    # pack: hi = quantized entropy (invalid -> max), lo = in-row offset
    key_hi = jnp.where(wvalid, entq, jnp.uint32(0xFFFFFFFF))
    key_lo = offs
    best = sliding_min((key_hi, key_lo), win)
    Wout = best[0].shape[-1]
    sel = best[1].astype(jnp.int32)                 # chosen in-row offset
    km_hi = jnp.take_along_axis(km[0], sel, axis=-1)
    km_lo = jnp.take_along_axis(km[1], sel, axis=-1)
    chosen_invalid = best[0] == jnp.uint32(0xFFFFFFFF)
    sent = u64.full((km_hi.shape), _SENTINEL)
    return (jnp.where(chosen_invalid, sent[0], km_hi),
            jnp.where(chosen_invalid, sent[1], km_lo))


def sliding_min(x: U64, win: int) -> U64:
    """Sliding-window minimum over the last axis, output width W-win+1.

    Log-doubling: combine shifted copies to cover the window with
    O(log2 win) min ops instead of win-1.
    """
    if win <= 1:
        return x
    # Build mins over power-of-two spans, then combine two overlapping spans.
    spans = [x]  # spans[j] = min over [i, i+2^j)
    length = x[0].shape[-1]
    j = 1
    while (1 << j) <= win:
        prev = spans[-1]
        off = 1 << (j - 1)
        cur = u64.min_((prev[0][..., :length - off], prev[1][..., :length - off]),
                       (prev[0][..., off:], prev[1][..., off:]))
        spans.append(cur)
        length -= off
        j += 1
    p = j - 1
    big = spans[p]  # covers 2^p <= win
    rem = win - (1 << p)
    W = x[0].shape[-1] - win + 1
    lo_part = (big[0][..., :W], big[1][..., :W])
    hi_part = (big[0][..., rem:rem + W], big[1][..., rem:rem + W])
    return u64.min_(lo_part, hi_part)


# ---------------------------------------------------------------------------
# Host-side tiling helpers.
# ---------------------------------------------------------------------------

def tile_sequence(seq: np.ndarray, content: int, halo: int,
                  pad_byte: int = ord("N")) -> np.ndarray:
    """Chop a flat uint8 sequence into overlapping rows.

    Row r covers seq[r*content : r*content + content + halo]; trailing
    positions are padded with an invalid byte so windows there are masked.
    """
    seq = np.ascontiguousarray(seq, dtype=np.uint8)
    n = seq.shape[0]
    if n == 0:
        return np.zeros((0, content + halo), np.uint8)
    rows = max(1, -(-n // content))
    padded = np.full(rows * content + halo, pad_byte, np.uint8)
    padded[:n] = seq
    stride = padded.strides[0]
    return np.lib.stride_tricks.as_strided(
        padded, shape=(rows, content + halo),
        strides=(content * stride, stride)).copy()


def join_records(seqs: List[bytes], sep_len: int) -> np.ndarray:
    """Concatenate sequence records with `sep_len` invalid bytes between them
    so no k-mer window spans a record boundary (replaces the reference's
    per-record kseq streaming)."""
    if not seqs:
        return np.zeros(0, np.uint8)
    sep = b"\x00" * sep_len
    return np.frombuffer(sep.join(seqs), dtype=np.uint8).copy()


# ---------------------------------------------------------------------------
# Oracle (slow, host) — used by tests and the exact-set backend.
# ---------------------------------------------------------------------------

_CODE_LUT = np.full(256, 255, np.uint8)
for i, b in enumerate(b"ACGT"):
    _CODE_LUT[b] = i
    _CODE_LUT[ord(chr(b).lower())] = i


def encode_oracle(seq: bytes, sp: Spacer, canon: bool = True) -> np.ndarray:
    """Reference-semantics python/numpy k-mer extraction (one record)."""
    arr = _CODE_LUT[np.frombuffer(seq, np.uint8)]
    n = arr.shape[0]
    out = []
    k = sp.k
    for i in range(n - sp.c + 1):
        window = arr[i:i + sp.c]
        picks = window[np.array(sp.positions)]
        if (picks == 255).any():
            out.append(None)
            continue
        fwd = 0
        for v in picks:
            fwd = (fwd << 2) | int(v)
        rcv = 0
        for v in picks[::-1]:
            rcv = (rcv << 2) | (3 - int(v))
        out.append(min(fwd, rcv) if canon else fwd)
    # windowed minimization: emit only fully-valid windows (see encode_tile)
    if sp.w > sp.c:
        wlen = sp.w - sp.c + 1
        mins = []
        for i in range(max(0, len(out) - wlen + 1)):
            vals = out[i:i + wlen]
            mins.append(min(vals) if None not in vals else None)
        out = mins
    return np.array([v for v in out if v is not None], dtype=np.uint64)
