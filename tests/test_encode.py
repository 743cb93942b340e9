import numpy as np
import pytest

from dashing_tpu import u64
from dashing_tpu.ops import encode
from dashing_tpu.ops.encode import Spacer, encode_tile, parse_spacing


def _extract(tile_np, sp, canon=True):
    km, valid = encode_tile(
        tile_np, k=sp.k, w=sp.w, positions=tuple(sp.positions), span=sp.c,
        canon=canon)
    vals = u64.to_np(km)
    mask = np.asarray(valid)
    return vals, mask


def _device_kmers(seq: bytes, sp, canon=True, content=64):
    seq_arr = np.frombuffer(seq, np.uint8)
    tile = encode.tile_sequence(seq_arr, content, sp.halo)
    vals, mask = _extract(tile, sp, canon)
    return vals[mask]


@pytest.mark.parametrize("k", [4, 15, 16, 17, 31, 32])
@pytest.mark.parametrize("canon", [True, False])
def test_matches_oracle(rng, k, canon):
    bases = rng.choice(list(b"ACGT"), size=500).astype(np.uint8)
    seq = bases.tobytes()
    sp = Spacer(k)
    got = np.sort(_device_kmers(seq, sp, canon))
    want = np.sort(encode.encode_oracle(seq, sp, canon))
    assert got.shape == want.shape
    assert (got == want).all()


def test_n_masking(rng):
    seq = b"ACGTACGTNNACGTACGTACGT" * 10
    sp = Spacer(7)
    got = np.sort(_device_kmers(seq, sp))
    want = np.sort(encode.encode_oracle(seq, sp))
    assert (got == want).all()


def test_lowercase_and_iupac():
    seq = b"acgtACGTrymkACGTacgt"
    sp = Spacer(5)
    got = np.sort(_device_kmers(seq, sp))
    want = np.sort(encode.encode_oracle(seq, sp))
    assert (got == want).all()


def test_canonical_is_strand_independent(rng):
    bases = rng.choice(list(b"ACGT"), size=300).astype(np.uint8)
    seq = bases.tobytes()
    comp = {65: 84, 67: 71, 71: 67, 84: 65}
    rc = bytes(comp[b] for b in seq[::-1])
    sp = Spacer(21)
    a = np.sort(_device_kmers(seq, sp, canon=True))
    b = np.sort(_device_kmers(rc, sp, canon=True))
    assert (a == b).all()


def test_minimizers_match_oracle(rng):
    bases = rng.choice(list(b"ACGT"), size=400).astype(np.uint8)
    seq = bases.tobytes()
    sp = Spacer(11, w=19)
    got = np.sort(_device_kmers(seq, sp))
    want = np.sort(encode.encode_oracle(seq, sp))
    assert got.shape == want.shape
    assert (got == want).all()


def test_spaced_seed_matches_oracle(rng):
    bases = rng.choice(list(b"ACGT"), size=300).astype(np.uint8)
    seq = bases.tobytes()
    gaps = parse_spacing("1x2", 9)  # two single-base gaps
    sp = Spacer(9, gaps=gaps)
    got = np.sort(_device_kmers(seq, sp, canon=False))
    want = np.sort(encode.encode_oracle(seq, sp, canon=False))
    assert (got == want).all()


def test_parse_spacing():
    assert parse_spacing("", 5) == [0, 0, 0, 0]
    assert parse_spacing("1x2", 5) == [1, 1, 0, 0]
    assert parse_spacing("2,1x3", 7) == [2, 1, 1, 1, 0, 0]


def test_tile_halo_covers_every_kmer(rng):
    # With tiny content width, every k-mer must still appear exactly once.
    bases = rng.choice(list(b"ACGT"), size=257).astype(np.uint8)
    seq = bases.tobytes()
    sp = Spacer(13)
    got = np.sort(_device_kmers(seq, sp, content=32))
    want = np.sort(encode.encode_oracle(seq, sp))
    assert got.shape == want.shape
    assert (got == want).all()


def test_join_records_blocks_spanning_kmers():
    recs = [b"ACGTACGTACGT", b"TTTTGGGG"]
    sp = Spacer(6)
    joined = encode.join_records(recs, sp.halo)
    got = np.sort(_device_kmers(joined.tobytes(), sp))
    want = np.sort(np.concatenate([encode.encode_oracle(r, sp) for r in recs]))
    assert (got == want).all()


def test_entropy_minimizer(rng):
    # low-entropy homopolymer-ish k-mers must win their windows
    seq = (b"ACGTGCTAGCTA" + b"AAAAAAA" + b"GCTAGCTAGCAT" * 3)
    sp = Spacer(7, w=13)
    seq_arr = np.frombuffer(seq, np.uint8)
    tile = encode.tile_sequence(seq_arr, 64, sp.halo)
    km, valid = encode_tile(tile, k=sp.k, w=sp.w,
                            positions=tuple(sp.positions), span=sp.c,
                            canon=False, entropy=True)
    got = set(u64.to_np(km)[np.asarray(valid)].tolist())
    assert 0 in got  # AAAAAAA (all-zero code) has entropy 0 -> selected
    # sanity: same call without entropy yields lexicographic minimizers
    km2, valid2 = encode_tile(tile, k=sp.k, w=sp.w,
                              positions=tuple(sp.positions), span=sp.c,
                              canon=False, entropy=False)
    want = encode.encode_oracle(seq, sp, canon=False)
    got2 = np.sort(u64.to_np(km2)[np.asarray(valid2)])
    assert (got2 == np.sort(want)).all()


def test_entropy_minimizer_count(rng):
    # one emission per fully-valid window, same as lexicographic mode
    bases = rng.choice(list(b"ACGT"), size=300).astype(np.uint8)
    sp = Spacer(9, w=17)
    tile = encode.tile_sequence(bases, 64, sp.halo)
    km, valid = encode_tile(tile, k=sp.k, w=sp.w,
                            positions=tuple(sp.positions), span=sp.c,
                            canon=True, entropy=True)
    n_windows = 300 - sp.w + 1
    assert int(np.asarray(valid).sum()) == n_windows


def test_spaced_canonical_matches_oracle(rng):
    """Asymmetric spaced seed + canonicalization: the device path must use
    the revcomp of the PACKED sampled k-mer (like encode_oracle / the
    exact-set backend), not re-sample the pattern on the rc strand."""
    import jax.numpy as jnp
    from dashing_tpu import u64
    seq = "".join(rng.choice(list("ACGT"), size=400)).encode()
    sp = encode.Spacer(5, 0, encode.parse_spacing("2", 5))  # asymmetric
    tile = encode.tile_sequence(np.frombuffer(seq, np.uint8), 128, sp.halo)
    km, valid = encode.encode_tile(jnp.asarray(tile), k=5, w=sp.w,
                                   positions=tuple(sp.positions), span=sp.c,
                                   canon=True)
    got = np.sort(u64.to_np(km)[np.asarray(valid)])
    want = np.sort(encode.encode_oracle(seq, sp, True))
    assert got.shape == want.shape and (got == want).all()


def test_entropy_minimizer_allT_not_sentinel_aliased():
    """A valid all-T 32-mer (canon off) packs to 0xFF..FF, aliasing the
    invalid sentinel; the entropy minimizer must still be able to pick it
    (validity is a mask, not a value compare)."""
    import jax.numpy as jnp
    from dashing_tpu import u64
    seq = (b"ACGT" * 10 + b"T" * 40 + b"ACGT" * 10)
    sp = encode.Spacer(32, 40)
    tile = encode.tile_sequence(np.frombuffer(seq, np.uint8), 128, sp.halo)
    km, valid = encode.encode_tile(jnp.asarray(tile), k=32, w=40,
                                   positions=tuple(sp.positions), span=32,
                                   canon=False, entropy=True)
    vals = u64.to_np(km)[np.asarray(valid)]
    # the poly-T region's windows must select the all-T k-mer (entropy 0)
    assert np.uint64(0xFFFFFFFFFFFFFFFF) in vals


def test_spaced_window_matches_oracle(rng):
    """spacing x minimizer-window combo (VERDICT r3 item 9): windowed
    minimization over SPACED seed values must match the host oracle."""
    bases = rng.choice(list(b"ACGTACGTN"), size=350).astype(np.uint8)
    seq = bases.tobytes()
    gaps = parse_spacing("1x2", 9)
    sp = Spacer(9, w=16, gaps=gaps)
    got = np.sort(_device_kmers(seq, sp))
    want = np.sort(encode.encode_oracle(seq, sp))
    assert got.shape == want.shape
    assert (got == want).all()


def test_spaced_entropy_window_matches_oracle(rng):
    """spacing x entropy x window combo: the quantized-entropy minimizer
    key ((ent * 2^18) << offset packing, ties leftmost) mirrored by an
    inline host oracle."""
    bases = rng.choice(list(b"ACGT"), size=200).astype(np.uint8)
    seq = bases.tobytes()
    gaps = parse_spacing("1x2", 7)
    sp = Spacer(7, w=12, gaps=gaps)
    seq_arr = np.frombuffer(seq, np.uint8)
    tile = encode.tile_sequence(seq_arr, 256, sp.halo)   # single row
    km, valid = encode_tile(tile, k=sp.k, w=sp.w,
                            positions=tuple(sp.positions), span=sp.c,
                            canon=False, entropy=True)
    got = np.sort(u64.to_np(km)[np.asarray(valid)])
    # host oracle
    codes = encode._CODE_LUT[seq_arr]
    pos = np.array(sp.positions)
    vals, ents = [], []
    for i in range(len(codes) - sp.c + 1):
        picks = codes[i:i + sp.c][pos]
        v = 0
        for b in picks:
            v = (v << 2) | int(b)
        vals.append(v)
        cnt = np.bincount(picks, minlength=4) / float(sp.k)
        ent = -(cnt[cnt > 0] * np.log2(cnt[cnt > 0])).sum()
        ents.append(min(int(ent * 2.0 ** 18), (1 << 20) - 1))
    wlen = sp.w - sp.c + 1
    want = []
    for i in range(len(vals) - wlen + 1):
        j = i + int(np.argmin(ents[i:i + wlen]))   # ties leftmost
        want.append(vals[j])
    want = np.sort(np.array(want, np.uint64))
    assert got.shape == want.shape
    assert (got == want).all()


@pytest.mark.parametrize("p", [10, 14])
@pytest.mark.parametrize("k", [15, 21, 31])
def test_sketch_file_registers_match_host_pipeline(tmp_path, k, p):
    """End-to-end device sketch of a FASTA file (one record, N runs,
    lowercase, a width that is not a tile multiple) equals an independent
    host numpy encode -> wang_hash_np -> HLL.addh_np bitwise."""
    import os
    import sys
    from dashing_tpu import pipeline
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import chip_smoke
    rng = np.random.default_rng(k * 100 + p)
    seq = rng.choice(np.frombuffer(b"ACGT" * 8 + b"acgtN", np.uint8),
                     size=50_000 + k)
    path = str(tmp_path / "g.fa")
    chip_smoke.write_fasta(path, "g", seq)
    got = pipeline.sketch_file_hll(path, pipeline.SketchParams(k=k), p)
    np.testing.assert_array_equal(got, chip_smoke.host_registers(path, k, p))
