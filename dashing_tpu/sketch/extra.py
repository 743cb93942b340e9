"""Remaining sketch-type matrix entries: WideHLL, HyperMinHash, and the
SuperMinHash slot (reference src/dashing.h:223-247 Sketch enum).

* WideHLL (reference whll::wh119_t, --use-wide-hll): an HLL variant with
  wider registers.  Ours stores 16-bit registers (never saturates for any
  realistic cardinality) over the same bucket/rank semantics, so it shares
  the HLL estimator stack.  Suffix .whll.

* HyperMinHash (Yu & Weissman; reference sketch/hmh.h, enum HYPERMINHASH):
  per bucket keeps (HLL rank, sub-hash of the minimizing element).  The
  rank part gives an HLL cardinality; register equality (rank AND sub-hash)
  gives a MinHash-quality Jaccard with collision correction
  2^-rbits conditioned on rank agreement.  bbnbits sets the register width
  (reference src/sketch_and_cmp.h:52-66).

* SuperMinHash (--use-superminhash / BB_SUPERMINHASH): the REAL Ertl 2017
  algorithm (class SuperMinHash below) — generation-counter lazy
  Fisher-Yates permutation per element, exact early stop, Gamma/Beta-law
  cardinality MLE.  Round 1 shipped a one-permutation-with-densification
  stand-in (class DensifiedMinHash), kept only so its DTPUSMH1 files stay
  readable; new sketches are always SuperMinHash (DTPUSMH2).
"""
from __future__ import annotations

import gzip
import struct
from typing import IO, Tuple

import numpy as np

from ..hashes import wang_hash_np, clz64_np, poisson_min_cardinality
from . import estimators as est
from .setsketches import _read_exact

_HDR = struct.Struct("<8sII")


class WideHLL:
    """HLL with uint16 registers; same bucket/rank semantics as HLL."""
    MAGIC = b"DTPUWHL1"

    def __init__(self, p: int, estim: int = est.ERTL_MLE,
                 jestim: int = est.ERTL_MLE, regs: np.ndarray = None):
        self.p = int(p)
        self.estim = int(estim)
        self.jestim = int(jestim)
        self.regs = (np.zeros(1 << p, np.uint16) if regs is None
                     else np.asarray(regs, np.uint16))
        self._card_cache = None

    @property
    def q(self) -> int:
        return 64 - self.p

    def addh_np(self, values: np.ndarray):
        self.add_np(wang_hash_np(np.asarray(values, np.uint64)))

    def add_np(self, hashes: np.ndarray):
        hashes = np.asarray(hashes, np.uint64)
        idx = (hashes >> np.uint64(64 - self.p)).astype(np.int64)
        rest = (hashes << np.uint64(self.p)) | np.uint64(1 << (self.p - 1))
        rank = clz64_np(rest) + 1
        np.maximum.at(self.regs, idx, rank.astype(np.uint16))
        self._card_cache = None

    def finalize(self):
        pass

    def histogram(self) -> np.ndarray:
        return np.bincount(self.regs, minlength=self.q + 2).astype(np.float32)

    def report(self) -> float:
        # cached: est.estimate is a device dispatch (a round trip),
        # and the batched compare engines re-request cards per row block
        if self._card_cache is None:
            import jax.numpy as jnp
            self._card_cache = float(est.estimate(
                jnp.asarray(self.histogram()), self.p, self.estim))
        return self._card_cache

    cardinality_estimate = report

    def full_set_comparison(self, other: "WideHLL"):
        import jax.numpy as jnp
        if self.jestim == est.ERTL_JOINT_MLE:
            # same register semantics as HLL, so the joint pair MLE applies
            stats = est.pair_statistics(
                jnp.asarray(self.regs.astype(np.int32)),
                jnp.asarray(other.regs.astype(np.int32)), self.q)
            tri = est.joint_mle(stats, self.p)
            return tuple(float(x) for x in np.asarray(tri))
        ha = jnp.asarray(self.histogram())
        hb = jnp.asarray(other.histogram())
        hu = jnp.asarray(np.bincount(np.maximum(self.regs, other.regs),
                                     minlength=self.q + 2).astype(np.float32))
        tri = est.union_triple_incl_excl(ha, hb, hu, self.p, self.estim)
        return tuple(float(x) for x in np.asarray(tri))

    def jaccard_index(self, other: "WideHLL") -> float:
        a, b, x = self.full_set_comparison(other)
        s = a + b + x
        return x / s if s else 0.0

    def union_size(self, other: "WideHLL") -> float:
        import jax.numpy as jnp
        hu = jnp.asarray(np.bincount(np.maximum(self.regs, other.regs),
                                     minlength=self.q + 2).astype(np.float32))
        return float(est.estimate(hu, self.p, self.estim))

    def __iadd__(self, other: "WideHLL") -> "WideHLL":
        np.maximum(self.regs, other.regs, out=self.regs)
        self._card_cache = None
        return self

    def compress(self, new_p: int) -> "WideHLL":
        """Fold to a smaller precision — identical register math to
        HLL.compress (the registers share HLL rank semantics; the
        reference's fold is hll-only, src/dashing.cpp:564-590, so this is
        a rebuild extension for the wide type)."""
        if new_p >= self.p:
            raise ValueError("compress requires new_p < p")
        regs = self.regs.astype(np.int32)
        p = self.p
        while p > new_p:
            lo, hi = regs[0::2], regs[1::2]
            lo_adj = np.where(lo > 0, lo + 1, 0)
            hi_adj = (hi > 0).astype(np.int32)
            regs = np.maximum(lo_adj, hi_adj)
            p -= 1
        return WideHLL(new_p, self.estim, self.jestim,
                       regs.astype(np.uint16))

    def printf(self, fp=None):
        """Human-readable register dump (`view` over a .whll)."""
        import sys
        fp = fp or sys.stdout
        fp.write(f"WideHLL p={self.p} m={1 << self.p} estim={self.estim} "
                 f"jestim={self.jestim}\n")
        for i in range(0, 1 << self.p, 32):
            row = " ".join(str(int(v)) for v in self.regs[i:i + 32])
            fp.write(f"{i}\t{row}\n")

    def write_record(self, fp: IO[bytes]):
        fp.write(_HDR.pack(self.MAGIC, self.p, (self.estim << 8) | self.jestim))
        fp.write(self.regs.astype("<u2").tobytes())

    def write(self, pf):
        if isinstance(pf, str):
            with gzip.open(pf, "wb") as fp:
                self.write_record(fp)
        else:
            self.write_record(pf)

    @classmethod
    def read_record(cls, fp) -> "WideHLL":
        hdr = fp.read(_HDR.size)
        if len(hdr) < _HDR.size:
            raise EOFError("truncated WideHLL record")
        magic, p, ej = _HDR.unpack(hdr)
        if magic != cls.MAGIC:
            raise ValueError(f"bad WideHLL magic {magic!r}")
        regs = np.frombuffer(_read_exact(fp, 2 << p, "WideHLL registers"),
                             "<u2").astype(np.uint16)
        return cls(p, ej >> 8, ej & 0xFF, regs)

    @classmethod
    def read(cls, pf) -> "WideHLL":
        if isinstance(pf, str):
            with gzip.open(pf, "rb") as fp:
                return cls.read_record(fp)
        return cls.read_record(pf)


class HyperMinHash:
    """m = 2^p buckets of (rank, subhash) packed uint32 registers.

    Packing: key = rank << rbits | (mask - subhash), so numpy maximum keeps
    the max rank and, within it, the MIN subhash — mergeable like HLL.
    """
    MAGIC = b"DTPUHMH1"

    def __init__(self, p: int, regwidth: int = 16, regs: np.ndarray = None):
        self.p = int(p)
        # registers are packed (rank:6 | subhash:rbits) in uint32, so the
        # usable width caps at 32; a requested 64 would shift the rank out
        # of the register entirely
        self.regwidth = min(int(regwidth), 32)  # total bits (bbnbits)
        self.rbits = max(self.regwidth - 6, 2)  # sub-hash bits
        self.regs = (np.zeros(1 << p, np.uint32) if regs is None
                     else np.asarray(regs, np.uint32))
        self._card_cache = None

    @property
    def q(self) -> int:
        return 64 - self.p

    def _rank_sub(self, hashes: np.ndarray):
        idx = (hashes >> np.uint64(64 - self.p)).astype(np.int64)
        rest = (hashes << np.uint64(self.p)) | np.uint64(1 << (self.p - 1))
        rank = clz64_np(rest) + 1
        sub = (hashes & np.uint64((1 << self.rbits) - 1)).astype(np.int64)
        return idx, rank, sub

    def addh_np(self, values: np.ndarray):
        self.add_np(wang_hash_np(np.asarray(values, np.uint64)))

    def add_np(self, hashes: np.ndarray):
        hashes = np.asarray(hashes, np.uint64)
        idx, rank, sub = self._rank_sub(hashes)
        mask = (1 << self.rbits) - 1
        key = (rank << self.rbits | (mask - sub)).astype(np.uint32)
        np.maximum.at(self.regs, idx, key)
        self._card_cache = None

    def finalize(self):
        pass

    def _ranks(self) -> np.ndarray:
        return (self.regs >> np.uint32(self.rbits)).astype(np.uint8)

    def histogram(self) -> np.ndarray:
        return np.bincount(self._ranks(), minlength=self.q + 2).astype(np.float32)

    def getcard(self) -> float:
        # cached like WideHLL.report: one device dispatch per call, and
        # the batched compare engines re-request cards per row block
        if self._card_cache is None:
            import jax.numpy as jnp
            self._card_cache = float(est.estimate(
                jnp.asarray(self.histogram()), self.p, est.ERTL_MLE))
        return self._card_cache

    report = getcard
    cardinality_estimate = getcard

    def jaccard_index(self, other: "HyperMinHash") -> float:
        both = (self.regs == other.regs) & (self.regs != 0)
        filled = (self.regs != 0) | (other.regs != 0)
        nf = int(filled.sum())
        if nf == 0:
            return 0.0
        f = float(both.sum()) / nf
        c = 2.0 ** -self.rbits  # collision prob given equal ranks (approx)
        return max(0.0, (f - c) / (1.0 - c))

    def full_set_comparison(self, other: "HyperMinHash"):
        ji = self.jaccard_index(other)
        ca, cb = self.getcard(), other.getcard()
        cu = (ca + cb) / (1.0 + ji)
        x = ji * cu
        return (max(ca - x, 0.0), max(cb - x, 0.0), x)

    def union_size(self, other: "HyperMinHash") -> float:
        a, b, x = self.full_set_comparison(other)
        return a + b + x

    def intersection_size(self, other: "HyperMinHash") -> float:
        return self.full_set_comparison(other)[2]

    def __iadd__(self, other: "HyperMinHash") -> "HyperMinHash":
        np.maximum(self.regs, other.regs, out=self.regs)
        self._card_cache = None
        return self

    def write_record(self, fp: IO[bytes]):
        fp.write(_HDR.pack(self.MAGIC, self.p, self.regwidth))
        fp.write(self.regs.astype("<u4").tobytes())

    def write(self, pf):
        if isinstance(pf, str):
            with gzip.open(pf, "wb") as fp:
                self.write_record(fp)
        else:
            self.write_record(pf)

    @classmethod
    def read_record(cls, fp) -> "HyperMinHash":
        hdr = fp.read(_HDR.size)
        if len(hdr) < _HDR.size:
            raise EOFError("truncated HMH record")
        magic, p, w = _HDR.unpack(hdr)
        if magic != cls.MAGIC:
            raise ValueError(f"bad HMH magic {magic!r}")
        regs = np.frombuffer(_read_exact(fp, 4 << p, "HMH registers"),
                             "<u4").astype(np.uint32)
        return cls(p, w, regs)

    @classmethod
    def read(cls, pf) -> "HyperMinHash":
        if isinstance(pf, str):
            with gzip.open(pf, "rb") as fp:
                return cls.read_record(fp)
        return cls.read_record(pf)


class SuperMinHash:
    """SuperMinHash (Ertl 2017, arXiv:1706.05698): the --use-superminhash /
    BB_SUPERMINHASH slot (reference enum src/dashing.h:223-247; algorithm
    unavailable in the mount — implemented from the paper).

    Each element d drives a per-element PRNG producing, at round j, a
    uniform r_j in [0,1) and one Fisher-Yates swap step of a permutation of
    the m registers; register p_d[j] takes min(h, j + r_j).  Register
    values are therefore in [0, m) with P(h_i >= x) = (1 - x/m)^n — a
    Beta(1, n)-scaled law that gives the clean cardinality MLE
    n_hat = (m - 1) / sum_i(-ln(1 - h_i/m)) — while equal registers across
    sketches identify the same minimizing element, which is what buys
    SuperMinHash its lower JI variance than one-permutation hashing.

    Vectorized over elements with a generation-counter lazy permutation
    (the paper's q[] trick, batched): rounds run in lockstep for a chunk
    and stop once j > floor(max h) — every skipped update has
    v = j + r > max(h), so the final registers equal the full-m-round
    result EXACTLY, independent of chunking or element order (tested)."""
    MAGIC = b"DTPUSMH2"
    _CHUNK = 1 << 16

    def __init__(self, p: int, b: int = 16, h: np.ndarray = None):
        self.p = int(p)
        self.b = int(b)
        self.h = (np.full(1 << p, np.inf, np.float64) if h is None
                  else np.asarray(h, np.float64))
        self._gen_state = None

    @property
    def m(self) -> int:
        return 1 << self.p

    def addh_np(self, values: np.ndarray):
        self.add_np(wang_hash_np(np.asarray(values, np.uint64)))

    def add_np(self, hashes: np.ndarray):
        d = np.unique(np.asarray(hashes, np.uint64))
        m = self.m
        if d.size == 0:
            return
        if self._gen_state is None:
            # bound the (chunk, m) permutation+generation state to ~256 MB
            # (8 B/cell) — a fixed chunk OOMed at -S 16 (25 GB); no floor
            # (a max(64, ...) floor re-created the blow-up at large m)
            ch = max(1, min(self._CHUNK, (256 << 20) // (8 * m),
                            max(d.size, 1)))
            self._gen_state = (np.zeros((ch, m), np.int32),
                               np.full((ch, m), -1, np.int32), [0])
        perm, gen, counter = self._gen_state
        ch = perm.shape[0]
        for c0 in range(0, d.size, ch):
            dd = d[c0:c0 + ch]
            nr = dd.size
            rows = np.arange(nr)
            cur = counter[0]
            counter[0] += 1
            j = 0
            hmax = np.inf
            while j < m:
                # refresh the stop bound every 16 rounds: h only decreases,
                # so a stale (higher) max only DELAYS stopping — exactness
                # unaffected, and the O(m) scan stops being per-round
                # (per-round scans were O(m^2) for small inputs at big m)
                if j % 16 == 0:
                    hmax = self.h.max()
                if j > hmax:          # v = j + r > max(h): cannot change h
                    break
                # per-(element, round) uniforms from the element hash
                s1 = wang_hash_np(dd ^ np.uint64(2 * j * 0x9E3779B97F4A7C15
                                                 & 0xFFFFFFFFFFFFFFFF))
                s2 = wang_hash_np(dd ^ np.uint64((2 * j + 1)
                                                 * 0x9E3779B97F4A7C15
                                                 & 0xFFFFFFFFFFFFFFFF))
                r = s1.astype(np.float64) * (2.0 ** -64)
                k = j + np.minimum((s2.astype(np.float64) * (2.0 ** -64)
                                    * (m - j)).astype(np.int64), m - 1 - j)
                pj = np.where(gen[rows, j] == cur, perm[rows, j], j)
                pk = np.where(gen[rows, k] == cur, perm[rows, k], k)
                perm[rows, j] = pk
                gen[rows, j] = cur
                perm[rows, k] = pj
                gen[rows, k] = cur
                np.minimum.at(self.h, pk, j + r)
                j += 1

    def finalize(self):
        pass

    def report(self) -> float:
        if not np.isfinite(self.h).any():
            return 0.0
        m = float(self.m)
        y = -np.log1p(-self.h / m).sum()
        return (m - 1.0) / y if y > 0 else 0.0

    cardinality_estimate = report

    def _regs_b(self) -> np.ndarray:
        mask = (1 << self.b) - 1
        safe = np.where(np.isfinite(self.h), self.h, 0.0)
        return (safe * (1 << self.b)).astype(np.int64) & mask

    def jaccard_index(self, other: "SuperMinHash") -> float:
        if not (np.isfinite(self.h).any() and np.isfinite(other.h).any()):
            return 0.0
        f = float((self._regs_b() == other._regs_b()).mean())
        c = 2.0 ** -self.b
        return max(0.0, (f - c) / (1.0 - c))

    def full_set_comparison(self, other: "SuperMinHash"):
        ji = self.jaccard_index(other)
        ca, cb = self.report(), other.report()
        cu = (ca + cb) / (1.0 + ji)
        x = ji * cu
        return (max(ca - x, 0.0), max(cb - x, 0.0), x)

    def union_size(self, other: "SuperMinHash") -> float:
        a, b, x = self.full_set_comparison(other)
        return a + b + x

    def __iadd__(self, other: "SuperMinHash") -> "SuperMinHash":
        np.minimum(self.h, other.h, out=self.h)
        return self

    def write_record(self, fp: IO[bytes]):
        fp.write(_HDR.pack(self.MAGIC, self.p, self.b))
        fp.write(np.where(np.isfinite(self.h), self.h, np.inf
                          ).astype("<f8").tobytes())

    def write(self, pf):
        if isinstance(pf, str):
            with gzip.open(pf, "wb") as fp:
                self.write_record(fp)
        else:
            self.write_record(pf)

    @classmethod
    def read_record(cls, fp) -> "SuperMinHash":
        hdr = fp.read(_HDR.size)
        if len(hdr) < _HDR.size:
            raise EOFError("truncated SuperMinHash record")
        magic, p, b = _HDR.unpack(hdr)
        if magic != cls.MAGIC:
            raise ValueError(f"bad SuperMinHash magic {magic!r}")
        h = np.frombuffer(_read_exact(fp, 8 << p, "SMH registers"),
                          "<f8").astype(np.float64)
        return cls(p, b, h)

    @classmethod
    def read(cls, pf) -> "SuperMinHash":
        if isinstance(pf, str):
            with gzip.open(pf, "rb") as fp:
                return cls.read_record(fp)
        return cls.read_record(pf)


class DensifiedMinHash:
    """One-permutation MinHash with rotation densification (the
    --use-superminhash slot; b-bit comparable registers)."""
    MAGIC = b"DTPUSMH1"
    EMPTY = np.uint64(0xFFFFFFFFFFFFFFFF)

    def __init__(self, p: int, b: int = 16, mins: np.ndarray = None):
        self.p = int(p)
        self.b = int(b)
        self.mins = (np.full(1 << p, self.EMPTY, np.uint64) if mins is None
                     else np.asarray(mins, np.uint64))
        self._dense = None
        self._card = None

    @property
    def m(self) -> int:
        return 1 << self.p

    def addh_np(self, values: np.ndarray):
        self.add_np(wang_hash_np(np.asarray(values, np.uint64)))

    def add_np(self, hashes: np.ndarray):
        hashes = np.asarray(hashes, np.uint64)
        idx = (hashes >> np.uint64(64 - self.p)).astype(np.int64)
        val = hashes << np.uint64(self.p)
        np.minimum.at(self.mins, idx, val)
        self._dense = None
        self._card = None

    def finalize(self):
        self._densified()

    def _densified(self) -> np.ndarray:
        if self._dense is not None:
            return self._dense
        dense = self.mins.copy()
        empty = dense == self.EMPTY
        if empty.all():
            self._dense = dense
            return dense
        # rotation densification: empty bucket j borrows from the nearest
        # filled bucket to its right (cyclically) — deterministic, so two
        # sketches of overlapping sets densify consistently.
        n = self.m
        filled_idx = np.flatnonzero(~empty)
        pos = np.arange(n)
        nxt = np.searchsorted(filled_idx, pos)
        src = filled_idx[nxt % filled_idx.size]
        dense = dense[src]
        self._dense = dense
        return dense

    def report(self) -> float:
        if self._card is None:
            filled = self.mins != self.EMPTY
            self._card = poisson_min_cardinality(self.mins[filled], self.m)
        return self._card

    cardinality_estimate = report

    def _regs_b(self) -> np.ndarray:
        return self._densified() >> np.uint64(64 - self.b)

    def jaccard_index(self, other: "DensifiedMinHash") -> float:
        f = float((self._regs_b() == other._regs_b()).mean())
        c = 2.0 ** -self.b
        return max(0.0, (f - c) / (1.0 - c))

    def full_set_comparison(self, other: "DensifiedMinHash"):
        ji = self.jaccard_index(other)
        ca, cb = self.report(), other.report()
        cu = (ca + cb) / (1.0 + ji)
        x = ji * cu
        return (max(ca - x, 0.0), max(cb - x, 0.0), x)

    def __iadd__(self, other: "DensifiedMinHash") -> "DensifiedMinHash":
        np.minimum(self.mins, other.mins, out=self.mins)
        self._dense = None
        self._card = None
        return self

    def write_record(self, fp: IO[bytes]):
        fp.write(_HDR.pack(self.MAGIC, self.p, self.b))
        fp.write(self.mins.astype("<u8").tobytes())

    def write(self, pf):
        if isinstance(pf, str):
            with gzip.open(pf, "wb") as fp:
                self.write_record(fp)
        else:
            self.write_record(pf)

    @classmethod
    def read_record(cls, fp) -> "DensifiedMinHash":
        hdr = fp.read(_HDR.size)
        if len(hdr) < _HDR.size:
            raise EOFError("truncated SMH record")
        magic, p, b = _HDR.unpack(hdr)
        if magic != cls.MAGIC:
            raise ValueError(f"bad SMH magic {magic!r}")
        mins = np.frombuffer(_read_exact(fp, 8 << p, "SMH buckets"),
                             "<u8").astype(np.uint64)
        return cls(p, b, mins)

    @classmethod
    def read(cls, pf) -> "DensifiedMinHash":
        if isinstance(pf, str):
            with gzip.open(pf, "rb") as fp:
                return cls.read_record(fp)
        return cls.read_record(pf)
