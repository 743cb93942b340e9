"""The HyperLogLog sketch object: dashing_tpu's flagship structure.

Host-side wrapper around a 2^p uint8 register array with the full surface the
reference's hll::hll_t exposes to dashing (reconstructed interface documented
in SURVEY.md sec 2.3; call sites reference src/dashing.h:138-196,488-495,
528-560):

    addh/add, report/creport (cardinality), jaccard_index, union_size,
    full_set_comparison -> (onlyA, onlyB, shared), containment_index,
    += merge (elementwise max), compress(p') fold, read/write, clear, p().

On-disk format (ours; the reference's exact byte format lives in a missing
submodule and is not recoverable from the mount — see SURVEY.md sec 0):
gzip member containing:  magic b"DTPUHLL1" | u8 p | u8 estim | u8 jestim |
u8 flags | u32 reserved | 2^p register bytes.  Streams of sketches are
concatenated records inside one gzip stream (like the reference's -o mode,
reference src/sketch_and_cmp.h:529-536).
"""
from __future__ import annotations

import gzip
import struct
from typing import IO, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .. import u64
from ..hashes import wang_hash_np, clz64_np
from ..ops import hll_update
from . import estimators as est

MAGIC = b"DTPUHLL1"
_HEADER = struct.Struct("<8sBBBBI")


class HLL:
    """HyperLogLog sketch with Ertl estimators.

    Registers live as a host numpy uint8 array; device ops take/return
    int32 register arrays.
    """

    def __init__(self, p: int, estim: int = est.ERTL_MLE,
                 jestim: int = est.ERTL_MLE,
                 regs: Optional[np.ndarray] = None):
        if not (4 <= p <= 32):
            raise ValueError(f"p={p} out of range [4, 32]")
        self.p = int(p)
        self.estim = int(estim)
        self.jestim = int(jestim)
        self.regs = (np.zeros(1 << p, np.uint8) if regs is None
                     else np.asarray(regs, np.uint8))
        assert self.regs.shape == (1 << p,)
        self._card: Optional[float] = None

    # -- properties ---------------------------------------------------------
    @property
    def m(self) -> int:
        return 1 << self.p

    @property
    def q(self) -> int:
        return 64 - self.p

    def clone_empty(self) -> "HLL":
        return HLL(self.p, self.estim, self.jestim)

    def clear(self):
        self.regs[:] = 0
        self._card = None

    # -- updates ------------------------------------------------------------
    def addh_np(self, values: np.ndarray):
        """Hash raw 64-bit values (WangHash) and insert.  Host path."""
        self.add_np(wang_hash_np(values))

    def add_np(self, hashes: np.ndarray):
        """Insert pre-hashed 64-bit values.  Host path (numpy)."""
        hashes = np.asarray(hashes, np.uint64)
        idx = (hashes >> np.uint64(64 - self.p)).astype(np.int64)
        rest = (hashes << np.uint64(self.p)) | np.uint64(1 << (self.p - 1))
        # rest is never zero (a bit is planted), so clz is well-defined
        rank = clz64_np(rest) + 1
        np.maximum.at(self.regs, idx, rank.astype(np.uint8))
        self._card = None

    def add_device(self, h: u64.U64, valid, backend: str = "scatter"):
        """Insert a device batch of hashes; returns nothing, updates host regs."""
        regs_dev = jnp.asarray(self.regs.astype(np.int32))
        if backend == "matmul":
            out = hll_update.update_registers_matmul(regs_dev, h, valid, self.p)
        else:
            out = hll_update.update_registers(regs_dev, h, valid, self.p)
        self.absorb_device(out)

    def absorb_device(self, regs_dev: jnp.ndarray):
        """Merge device-computed int32 registers into the host sketch."""
        new = np.asarray(jax.device_get(regs_dev), np.int64)
        np.maximum(self.regs, np.clip(new, 0, 255).astype(np.uint8), out=self.regs)
        self._card = None

    # -- merge / fold ---------------------------------------------------------
    def __iadd__(self, other: "HLL") -> "HLL":
        if other.p != self.p:
            raise ValueError("can't merge HLLs of different p")
        np.maximum(self.regs, other.regs, out=self.regs)
        self._card = None
        return self

    def union(self, other: "HLL") -> "HLL":
        out = HLL(self.p, self.estim, self.jestim,
                  np.maximum(self.regs, other.regs))
        return out

    def compress(self, new_p: int) -> "HLL":
        """Fold to a smaller precision (the reference `fold` subcommand,
        reference src/dashing.cpp:564-590).  Exact: when the leading index
        bit moves into the rank field, a register from the upper half
        contributes rank 1 if nonempty; from the lower half rank+1."""
        if new_p >= self.p:
            raise ValueError("compress requires new_p < p")
        regs = self.regs.astype(np.int32)
        p = self.p
        while p > new_p:
            # The dropped bit is the LOWEST index bit, so buckets 2j and 2j+1
            # merge into new bucket j: the even bucket's suffix gains a
            # leading 0 (rank+1), the odd bucket's a leading 1 (rank 1).
            lo, hi = regs[0::2], regs[1::2]
            lo_adj = np.where(lo > 0, lo + 1, 0)
            hi_adj = (hi > 0).astype(np.int32)
            regs = np.maximum(lo_adj, hi_adj)
            p -= 1
        return HLL(new_p, self.estim, self.jestim, regs.astype(np.uint8))

    # -- estimates ------------------------------------------------------------
    def histogram(self) -> np.ndarray:
        return np.bincount(self.regs, minlength=self.q + 2).astype(np.float32)

    def report(self) -> float:
        """Cardinality estimate with this sketch's estimator (cached)."""
        if self._card is None:
            C = jnp.asarray(self.histogram())
            self._card = float(est.estimate(C, self.p, self.estim))
        return self._card

    creport = report
    cardinality_estimate = report

    def _check_same_p(self, other):
        if self.p != other.p:
            raise ValueError(
                f"can't compare HLLs of different p ({self.p} vs "
                f"{other.p}); fold the larger one down first")

    def union_size(self, other: "HLL") -> float:
        self._check_same_p(other)
        u = np.maximum(self.regs, other.regs)
        C = jnp.asarray(np.bincount(u, minlength=self.q + 2).astype(np.float32))
        return float(est.estimate(C, self.p, self.estim))

    def full_set_comparison(self, other: "HLL") -> Tuple[float, float, float]:
        """(|A\\B|, |B\\A|, |A&B|); joint-MLE when jestim selects it, else
        inclusion-exclusion (mirrors hll_t behavior described in SURVEY)."""
        self._check_same_p(other)
        if self.jestim == est.ERTL_JOINT_MLE:
            a = jnp.asarray(self.regs.astype(np.int32))
            b = jnp.asarray(other.regs.astype(np.int32))
            stats = est.pair_statistics(a, b, self.q)
            tri = est.joint_mle(stats, self.p)
            return tuple(float(x) for x in np.asarray(tri))
        ha = jnp.asarray(self.histogram())
        hb = jnp.asarray(other.histogram())
        hu = jnp.asarray(np.bincount(np.maximum(self.regs, other.regs),
                                     minlength=self.q + 2).astype(np.float32))
        tri = est.union_triple_incl_excl(ha, hb, hu, self.p, self.estim)
        return tuple(float(x) for x in np.asarray(tri))

    def jaccard_index(self, other: "HLL") -> float:
        a, b, x = self.full_set_comparison(other)
        denom = a + b + x
        return x / denom if denom > 0 else 0.0

    def containment_index(self, other: "HLL") -> float:
        a, _, x = self.full_set_comparison(other)
        denom = a + x
        return x / denom if denom > 0 else 0.0

    def intersection_size(self, other: "HLL") -> float:
        return self.full_set_comparison(other)[2]

    # -- io -------------------------------------------------------------------
    def write_record(self, fp: IO[bytes]):
        fp.write(_HEADER.pack(MAGIC, self.p, self.estim, self.jestim, 0, 0))
        fp.write(self.regs.tobytes())

    def write(self, path_or_fp: Union[str, IO[bytes]]):
        if isinstance(path_or_fp, str):
            with gzip.open(path_or_fp, "wb") as fp:
                self.write_record(fp)
        else:
            self.write_record(path_or_fp)

    @classmethod
    def read_record(cls, fp: IO[bytes]) -> "HLL":
        hdr = fp.read(_HEADER.size)
        if len(hdr) < _HEADER.size:
            raise EOFError("truncated or missing HLL record")
        magic, p, estim, jestim, _flags, _res = _HEADER.unpack(hdr)
        if magic != MAGIC:
            raise ValueError(f"bad HLL magic {magic!r}")
        data = fp.read(1 << p)
        if len(data) != 1 << p:
            raise EOFError("truncated HLL registers")
        return cls(p, estim, jestim, np.frombuffer(data, np.uint8).copy())

    @classmethod
    def read(cls, path_or_fp: Union[str, IO[bytes]]) -> "HLL":
        if isinstance(path_or_fp, str):
            with gzip.open(path_or_fp, "rb") as fp:
                return cls.read_record(fp)
        return cls.read_record(path_or_fp)

    def printf(self, fp=None):
        """Human-readable register dump (the reference `view` subcommand)."""
        import sys
        fp = fp or sys.stdout
        fp.write(f"HLL p={self.p} m={self.m} estim={self.estim} "
                 f"jestim={self.jestim}\n")
        for i in range(0, self.m, 32):
            row = " ".join(str(int(v)) for v in self.regs[i:i + 32])
            fp.write(f"{i}\t{row}\n")


def ertl_joint(a: HLL, b: HLL) -> Tuple[float, float, float]:
    """Free-function joint comparison (reference readfilt.cpp:118)."""
    old = a.jestim
    try:
        a.jestim = est.ERTL_JOINT_MLE
        return a.full_set_comparison(b)
    finally:
        a.jestim = old
