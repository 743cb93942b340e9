import numpy as np
import pytest

from dashing_tpu.cli import main as climain
from dashing_tpu.sketch import weighted


def test_occurrence_expand_counts(rng):
    vals = np.array([7, 7, 7, 9, 9, 11], np.uint64)
    out = weighted.occurrence_expand(vals)
    assert out.size == 6
    assert np.unique(out).size == 6  # all labeled occurrences distinct
    # deterministic
    assert (weighted.occurrence_expand(vals) == out).all()
    # first occurrences match regardless of multiplicities elsewhere
    out2 = weighted.occurrence_expand(np.array([7, 9, 11], np.uint64))
    assert set(out2.tolist()) <= set(out.tolist())


def test_multiset_jaccard_math(rng):
    # A has value v x3, B has v x1: multiset JI = min/max = 1/3 over that value
    a = weighted.occurrence_expand(np.array([5, 5, 5], np.uint64))
    b = weighted.occurrence_expand(np.array([5], np.uint64))
    inter = np.intersect1d(a, b).size
    union = np.union1d(a, b).size
    assert inter == 1 and union == 3


def test_cm_estimated_counts(rng):
    stream = np.repeat(rng.integers(0, 2**62, 500, dtype=np.uint64),
                       rng.integers(1, 6, 500))
    uniq, est = weighted.cm_estimated_counts(stream)
    true = np.unique(stream, return_counts=True)[1]
    # CM never underestimates; with 2^22 x 10 tables on 2k keys, exact
    assert (est >= true).all()
    assert (est == true).mean() > 0.99


def test_wj_cli(tmp_path, rng, capsys):
    # genome B = genome A repeated twice: plain JI ~ 1, weighted JI ~ 0.5
    seq = "".join(rng.choice(list("ACGT"), size=3000))
    a = tmp_path / "a.fa"
    b = tmp_path / "b.fa"
    a.write_text(f">a\n{seq}\n")
    b.write_text(f">b\n{seq}\n>b2\n{seq}\n")
    rc = climain.main(["dist", "-k", "21", "--use-full-khash-sets",
                       "--avoid-sorting", str(a), str(b)])
    assert rc == 0
    plain = capsys.readouterr().out
    ji_plain = float(plain.splitlines()[-2].split("\t")[-1])
    rc = climain.main(["dist", "-k", "21", "--use-full-khash-sets",
                       "--wj-exact", "--avoid-sorting", str(a), str(b)])
    assert rc == 0
    wj = capsys.readouterr().out
    ji_wj = float(wj.splitlines()[-2].split("\t")[-1])
    assert ji_plain > 0.98
    assert abs(ji_wj - 0.5) < 0.02, ji_wj


def test_wj_hll_cli(tmp_path, rng, capsys):
    seq = "".join(rng.choice(list("ACGT"), size=5000))
    a = tmp_path / "a.fa"
    b = tmp_path / "b.fa"
    a.write_text(f">a\n{seq}\n")
    b.write_text(f">b\n{seq}\n>b2\n{seq}\n")
    rc = climain.main(["dist", "-k", "21", "-S", "14", "--wj",
                       "--avoid-sorting", str(a), str(b)])
    assert rc == 0
    out = capsys.readouterr().out
    ji = float(out.splitlines()[-2].split("\t")[-1])
    assert abs(ji - 0.5) < 0.08, ji


def test_occurrence_labels_device_matches_host(rng):
    """Device labeling must equal the host expansion — including a valid
    all-ones k-mer value (which previously merged into the invalid run)."""
    import jax.numpy as jnp
    from dashing_tpu import u64
    from dashing_tpu.sketch.weighted import (occurrence_labels_device,
                                             occurrence_expand)
    vals = np.concatenate([
        rng.integers(0, 50, size=500).astype(np.uint64),
        np.full(5, np.uint64(0xFFFFFFFFFFFFFFFF)),   # sentinel-valued k-mer
    ])
    rng.shuffle(vals)
    valid = np.ones(vals.size, bool)
    valid[rng.choice(vals.size, 60, replace=False)] = False
    lab, sv = occurrence_labels_device(u64.from_np(vals),
                                       jnp.asarray(valid))
    got = np.sort(u64.to_np(lab)[np.asarray(sv)])
    want = np.sort(occurrence_expand(vals[valid]))
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_sketch_file_wj_hll_matches_host(tmp_path, rng, monkeypatch):
    """The opt-in device wj-exact path must produce the host path's
    registers bitwise."""
    import dashing_tpu.pipeline as pl
    from dashing_tpu.sketch.hll import HLL
    seq = "".join(rng.choice(list("ACGT"), size=4000))
    fa = tmp_path / "g.fa"
    fa.write_text(f">a\n{seq}\n>b\n{seq}\n")   # every k-mer count >= 2
    params = pl.SketchParams(k=17)
    # host reference
    from dashing_tpu.sketch.weighted import occurrence_expand
    raw = pl.file_raw_kmers(str(fa), pl.SketchParams(k=17, rehash=False))
    want = HLL(12)
    want.add_np(occurrence_expand(raw))
    # device path (CPU jax works; open the opt-in gate)
    monkeypatch.setenv("DASHING_TPU_WJ_DEVICE", "1")
    got = pl.sketch_file_wj_hll(str(fa), params, 12)
    assert got is not None
    np.testing.assert_array_equal(got, want.regs)


@pytest.mark.parametrize("stype", ["hll", "khset", "bf", "rmh", "crmh",
                                   "bbmh", "cbbmh", "superminhash", "hmh",
                                   "wide_hll"])
def test_weighted_every_type_tracks_exact(tmp_path, rng, stype):
    """--wj-exact x EVERY sketch type (VERDICT r3 item 9): at generous -S
    the estimated Jaccard over occurrence-labeled multisets must track the
    exact multiset weighted Jaccard."""
    from collections import Counter
    from dashing_tpu import pipeline
    from dashing_tpu.cli import core
    from dashing_tpu.ops import pairwise as pw
    from dashing_tpu.sketch import estimators as est
    import dataclasses

    shared = "".join(rng.choice(list("ACGT"), size=1500))
    ua = "".join(rng.choice(list("ACGT"), size=800))
    ub = "".join(rng.choice(list("ACGT"), size=800))
    fa = tmp_path / "wa.fa"
    fb = tmp_path / "wb.fa"
    # duplicated records create real multiplicities
    fa.write_text(f">s\n{shared}\n>s2\n{shared}\n>u\n{ua}\n")
    fb.write_text(f">s\n{shared}\n>u\n{ub}\n>u2\n{ub}\n")

    o = core.CommonOpts()
    o.k, o.sketch_size = 17, 14
    o.sketch_type = stype
    o.weighted_jaccard = True
    o.exact_weighted = True
    ska = core.sketch_or_load(str(fa), o)
    skb = core.sketch_or_load(str(fb), o)
    got = core.compare_rect([ska], [skb], pw.JI, o.k, est.ERTL_MLE,
                            est.ERTL_MLE)[0, 0]

    params = dataclasses.replace(core.sketch_params(o), rehash=False)
    ca = Counter(pipeline.file_raw_kmers(str(fa), params).tolist())
    cb = Counter(pipeline.file_raw_kmers(str(fb), params).tolist())
    keys = set(ca) | set(cb)
    num = sum(min(ca.get(x, 0), cb.get(x, 0)) for x in keys)
    den = sum(max(ca.get(x, 0), cb.get(x, 0)) for x in keys)
    want = num / den
    assert abs(got - want) < 0.08, (stype, got, want)
