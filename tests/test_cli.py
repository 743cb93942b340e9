import gzip
import io
import os
import struct
import sys

import numpy as np
import pytest

from dashing_tpu import pipeline
from dashing_tpu.cli import main as climain
from dashing_tpu.io import distmat
from dashing_tpu.sketch.hll import HLL


@pytest.fixture()
def genomes(tmp_path, rng):
    base = "".join(rng.choice(list("ACGT"), size=4000))

    def mutate(s, rate):
        s = list(s)
        idx = rng.choice(len(s), size=int(rate * len(s)), replace=False)
        for i in idx:
            s[i] = rng.choice([c for c in "ACGT" if c != s[i]])
        return "".join(s)

    ps = []
    for i, r in enumerate([0, 0.02, 0.10]):
        p = tmp_path / f"g{i}.fa"
        p.write_text(f">genome{i}\n{mutate(base, r)}\n")
        ps.append(str(p))
    return ps


def run_cli(args):
    assert climain.main(args) == 0


def test_dist_tsv(genomes, capsys):
    run_cli(["dist", "-k", "21", "-S", "12", "--avoid-sorting"] + genomes)
    out = capsys.readouterr().out
    lines = out.splitlines()
    assert lines[0] == "#Path\tSize (est.)"
    assert lines[4].startswith("##Names\t")
    row0 = lines[5].split("\t")
    assert row0[0].endswith("g0.fa") and row0[1] == "-"
    ji_01 = float(row0[2])
    assert 0.2 < ji_01 < 0.9  # 2% mutated neighbor


def test_dist_mash_binary_and_printmat(genomes, tmp_path, capsys):
    out = str(tmp_path / "d.bin")
    run_cli(["dist", "-k", "21", "-S", "12", "-M", "-b", "-O", out,
             "--avoid-sorting"] + genomes)
    capsys.readouterr()
    n, cond = distmat.read_binary(out)
    assert n == 3 and cond.size == 3
    assert os.path.exists(out + ".labels")
    labels = open(out + ".labels").read().splitlines()
    assert len(labels) == 3
    # printmat dumps a square TSV
    run_cli(["printmat", out])
    out_txt = capsys.readouterr().out
    rows = out_txt.strip().splitlines()
    assert len(rows) == 3 and len(rows[0].split("\t")) == 3
    # mash distances increase with mutation rate
    assert cond[0] < cond[1]


def test_dist_phylip_and_full_tsv(genomes, capsys):
    run_cli(["dist", "-k", "21", "-S", "12", "-U", "--avoid-sorting"] + genomes)
    out = capsys.readouterr().out
    # PHYLIP: count line, then name padded to >= 9 chars + values
    lines = out.splitlines()
    hdr = lines.index("3")
    assert lines[hdr + 1].split("\t")[0].endswith("g0.fa")
    assert len(lines[hdr + 1].split("\t")) == 3   # two values for row 0
    run_cli(["dist", "-k", "21", "-S", "12", "-T", "--avoid-sorting"] + genomes)
    out = capsys.readouterr().out
    full = [l for l in out.splitlines() if l.startswith("#Names")]
    assert full


def test_sketch_cache_and_presketched(genomes, tmp_path, capsys):
    run_cli(["sketch", "-k", "17", "-S", "11"] + genomes)
    capsys.readouterr()
    sk_path = genomes[0] + ".w.17.spacing.11.hll"
    assert os.path.exists(sk_path)
    h = HLL.read(sk_path)
    assert h.p == 11
    # presketched dist over the cached sketches
    sks = [g + ".w.17.spacing.11.hll" for g in genomes]
    run_cli(["dist", "-H", "-k", "17", "--avoid-sorting"] + sks)
    out = capsys.readouterr().out
    assert "##Names" in out


def test_sketch_single_stream_output(genomes, tmp_path, capsys):
    out = str(tmp_path / "all.sketches.gz")
    run_cli(["sketch", "-k", "17", "-S", "11", "-o", out, "--avoid-sorting"]
            + genomes)
    capsys.readouterr()
    assert os.path.exists(out) and os.path.exists(out + ".labels.gz")
    with gzip.open(out, "rb") as fp:
        hs = [HLL.read_record(fp) for _ in range(3)]
    assert all(h.p == 11 for h in hs)
    # single presketched stream file -> dist (reference stream mode)
    run_cli(["dist", "-H", "-k", "17", "--avoid-sorting", out])
    out_txt = capsys.readouterr().out
    assert "##Names" in out_txt


def test_union_and_card_and_hll(genomes, tmp_path, capsys):
    sks = []
    for g in genomes:
        run_cli(["sketch", "-k", "17", "-S", "11", g])
        sks.append(g + ".w.17.spacing.11.hll")
    capsys.readouterr()
    merged = str(tmp_path / "merged.hll")
    run_cli(["union", "-o", merged] + sks)
    m = HLL.read(merged)
    want = HLL.read(sks[0])
    for s in sks[1:]:
        want += HLL.read(s)
    assert (m.regs == want.regs).all()
    run_cli(["card", "-k", "17", "-S", "11", "--avoid-sorting"] + genomes)
    out = capsys.readouterr().out
    assert out.startswith("#Path\tSize (est.)")
    assert len(out.splitlines()) == 4
    run_cli(["hll", "-k", "17", "-S", "12"] + genomes)
    out = capsys.readouterr().out
    assert "Estimated number of unique exact matches:" in out


def test_fold_and_view(genomes, tmp_path, capsys):
    run_cli(["sketch", "-k", "17", "-S", "12", genomes[0]])
    sk = genomes[0] + ".w.17.spacing.12.hll"
    folded = str(tmp_path / "folded.hll")
    run_cli(["fold", "-p", "10", "-o", folded, sk])
    f = HLL.read(folded)
    assert f.p == 10
    capsys.readouterr()
    run_cli(["view", folded])
    out = capsys.readouterr().out
    assert out.startswith("HLL p=10")


def test_qr_mode(genomes, tmp_path, capsys):
    qfile = tmp_path / "q.txt"
    qfile.write_text(genomes[2] + "\n")
    run_cli(["dist", "-k", "21", "-S", "12", "--avoid-sorting",
             "-Q", str(qfile), genomes[0], genomes[1]])
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines() if l]
    qrow = [l for l in lines if "g2.fa" in l and "\t" in l and "Size" not in l]
    assert qrow, out
    vals = qrow[-1].split("\t")[1:]
    assert len(vals) == 2


def test_containment_qr(genomes, tmp_path, capsys):
    # containment without -Q: all refs become queries (warning path)
    run_cli(["dist", "-k", "21", "-S", "12", "--containment-index",
             "--avoid-sorting", genomes[0], genomes[1]])
    out = capsys.readouterr().out
    assert out  # rectangular rows emitted


def test_nn_mode(genomes, capsys):
    run_cli(["dist", "-k", "21", "-S", "12", "--nearest-neighbors", "1",
             "--avoid-sorting"] + genomes)
    out = capsys.readouterr().out
    nn_lines = [l for l in out.splitlines() if ":" in l and "\t" in l]
    assert len(nn_lines) >= 3
    # g0's nearest neighbor must be g1 (2% mutations) not g2 (10%)
    g0_line = [l for l in nn_lines if l.split("\t")[0].endswith("g0.fa")][0]
    assert g0_line.split("\t")[1].startswith("1:")


def test_sketch_by_seq_and_dist_by_seq(tmp_path, rng, capsys):
    seqs = ["".join(rng.choice(list("ACGT"), size=900)) for _ in range(4)]
    fa = tmp_path / "multi.fa"
    fa.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))
    out = str(tmp_path / "bysq.gz")
    run_cli(["sketch_by_seq", "-k", "15", "-S", "11", "-o", out, str(fa)])
    capsys.readouterr()
    names = open(out + ".names").read().splitlines()
    assert names[0].startswith("#k=15:")
    assert names[1:] == [f"s{i}" for i in range(4)]
    run_cli(["dist_by_seq", "-n", out + ".names", out])
    got = capsys.readouterr().out
    assert "##Names\ts0\ts1\ts2\ts3" in got


def test_mkdist_multik(genomes, tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    run_cli(["mkdist", "--multik", "mk,15,19,2", "-S", "11",
             "--avoid-sorting"] + genomes)
    capsys.readouterr()
    nsets, ks, data = distmat.read_flattened("mk.bin")
    assert nsets == 3 and list(ks) == [15, 17]
    assert data.shape == (3, 2)


def test_mkdist_fused_presketch_bitwise_and_engaged(genomes, tmp_path,
                                                    capsys, monkeypatch):
    """The fused multi-k engine (one parse + one upload per chunk for all
    ks) must ENGAGE for the plain-HLL config and produce byte-identical
    flattened output to a run with fusion disabled."""
    calls = {"n": 0}
    orig = pipeline.sketch_file_hll_multik

    def spy(path, params_list, p, **kw):
        calls["n"] += 1
        return orig(path, params_list, p, **kw)

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(pipeline, "sketch_file_hll_multik", spy)
    run_cli(["mkdist", "--multik", "fz,15,21,2", "-S", "11",
             "--avoid-sorting"] + genomes)
    capsys.readouterr()
    assert calls["n"] == len(genomes)      # engaged once per input
    # disable fusion (spy raising -> graceful fallback to per-k loop)
    monkeypatch.setattr(pipeline, "sketch_file_hll_multik",
                        lambda *a: (_ for _ in ()).throw(RuntimeError("x")))
    run_cli(["mkdist", "--multik", "uf,15,21,2", "-S", "11",
             "--avoid-sorting"] + genomes)
    capsys.readouterr()
    assert (tmp_path / "fz.bin").read_bytes() == \
        (tmp_path / "uf.bin").read_bytes()


def test_mkdist_device_bank_engaged(genomes, tmp_path, capsys, monkeypatch):
    """The mkdist compare-phase fuse: per-k compare passes must slice the
    DEVICE-RESIDENT register rows parked by the fused presketch instead
    of re-uploading the bank (zero _device_regs uploads), and the
    registry must be emptied when mkdist returns."""
    from dashing_tpu.ops import pairwise as pw
    uploads = {"n": 0}
    orig = pw._device_regs

    def spy(regs):
        uploads["n"] += 1
        return orig(regs)

    monkeypatch.setattr(pw, "_device_regs", spy)
    monkeypatch.chdir(tmp_path)
    run_cli(["mkdist", "--multik", "db,15,21,2", "-S", "11",
             "--avoid-sorting"] + genomes)
    capsys.readouterr()
    assert uploads["n"] == 0, "compare phase re-uploaded a register bank"
    assert not pipeline._DEV_ROWS, "device-row registry leaked past mkdist"
    # and the fused-bank output must equal the uploading path's bitwise
    monkeypatch.setenv("DASHING_TPU_NO_MULTIK_FUSE", "1")
    run_cli(["mkdist", "--multik", "nf,15,21,2", "-S", "11",
             "--avoid-sorting"] + genomes)
    capsys.readouterr()
    assert (tmp_path / "db.bin").read_bytes() == \
        (tmp_path / "nf.bin").read_bytes()


def test_sketch_multik_matches_per_k(genomes, tmp_path):
    """pipeline.sketch_file_hll_multik registers == per-k
    sketch_file_hll, bitwise, including the seam-duplication cases
    (different halos force different tile boundaries)."""
    import numpy as np
    for path in genomes[:2]:
        params = [pipeline.SketchParams(k=k) for k in (13, 19, 31)]
        fused = pipeline.sketch_file_hll_multik(path, params, 11)
        for pa, regs in zip(params, fused):
            single = pipeline.sketch_file_hll(path, pa, 11)
            assert np.array_equal(regs, single), pa.k


def test_sketch_multik_windows_and_spacing_match(genomes):
    """Seam duplication must stay exact for MINIMIZER windows and spaced
    seeds too: a duplicated window at a tile boundary has identical
    content in both tiles, so the selected minimizer / spaced k-mer is
    identical and dedups under register max."""
    import numpy as np
    path = genomes[0]
    # minimizer windows (w > k)
    params_w = [pipeline.SketchParams(k=k, w=k + 6) for k in (13, 21)]
    for pa, regs in zip(params_w,
                        pipeline.sketch_file_hll_multik(path, params_w, 11)):
        assert np.array_equal(regs, pipeline.sketch_file_hll(path, pa, 11)), \
            ("w", pa.k)
    # spaced seeds
    params_s = [pipeline.SketchParams(k=k, spacing="1x2") for k in (13, 17)]
    for pa, regs in zip(params_s,
                        pipeline.sketch_file_hll_multik(path, params_s, 11)):
        assert np.array_equal(regs, pipeline.sketch_file_hll(path, pa, 11)), \
            ("spacing", pa.k)


def test_khset_exact_backend(genomes, capsys):
    run_cli(["dist", "-k", "17", "--use-full-khash-sets", "--avoid-sorting"]
            + genomes[:2])
    out = capsys.readouterr().out
    assert "##Names" in out


def test_bad_subcommand():
    with pytest.raises(SystemExit):
        climain.main(["frobnicate"])


def test_k_too_large(genomes):
    with pytest.raises(SystemExit):
        climain.main(["dist", "-k", "40"] + genomes)


def test_mkdist_jukes_cantor(tmp_path, rng, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    base = "".join(rng.choice(list("ACGT"), size=6000))

    def mutate(s, rate):
        s = list(s)
        idx = rng.choice(len(s), size=int(rate * len(s)), replace=False)
        for i in idx:
            s[i] = rng.choice([c for c in "ACGT" if c != s[i]])
        return "".join(s)

    ps = []
    for i, r in enumerate([0.0, 0.03]):
        p = tmp_path / f"j{i}.fa"
        p.write_text(f">j{i}\n{mutate(base, r)}\n")
        ps.append(str(p))
    run_cli(["mkdist", "--multik", "jc,15,27,4", "--jukes-cantor", "-S", "14"]
            + ps)
    capsys.readouterr()
    n, jc = distmat.read_binary("jc.jcd")
    assert n == 2 and jc.size == 1
    # JC distance should recover roughly the 3% mutation rate
    assert 0.01 < jc[0] < 0.08, jc


def test_panel(tmp_path, rng, capsys):
    base = "".join(rng.choice(list("ACGT"), size=4000))
    other = "".join(rng.choice(list("ACGT"), size=4000))
    fa_a = tmp_path / "refA.fa"
    fa_b = tmp_path / "refB.fa"
    fa_a.write_text(f">A\n{base}\n")
    fa_b.write_text(f">B\n{other}\n")
    db = str(tmp_path / "panel.db")
    run_cli(["sketch", "-k", "17", "-S", "12", "-o", db, "--avoid-sorting",
             str(fa_a), str(fa_b)])
    # panel wants a plain .labels file; sketch -o writes .labels.gz
    import gzip as _gz
    with _gz.open(db + ".labels.gz", "rt") as f, open(db + ".labels", "w") as g:
        g.write(f.read())
    q = tmp_path / "query.fa"
    q.write_text(f">q\n{base[:2000]}\n")
    capsys.readouterr()
    run_cli(["panel", "-k", "17", db, str(q)])
    out = capsys.readouterr().out
    lines = out.strip().splitlines()
    assert lines[0].startswith("#Query")
    assert "refA.fa" in lines[1]


def test_readfilt(tmp_path, rng, capsys):
    ref = "".join(rng.choice(list("ACGT"), size=5000))
    fa = tmp_path / "ref.fa"
    fa.write_text(f">r\n{ref}\n")
    run_cli(["sketch", "-k", "15", "-S", "12", str(fa)])
    hll_path = str(fa) + ".w.15.spacing.12.hll"
    reads = tmp_path / "reads.fq"
    with open(reads, "w") as fp:
        # read 0: from the reference; read 1: random (should be filtered)
        fp.write(f"@in_ref\n{ref[100:200]}\n+\n{'I' * 100}\n")
        junk = "".join(rng.choice(list("ACGT"), size=100))
        fp.write(f"@junk\n{junk}\n+\n{'I' * 100}\n")
    capsys.readouterr()
    run_cli(["readfilt", "-k", "15", "-s", hll_path, "-f", "0.5", str(reads)])
    out = capsys.readouterr().out
    assert "in_ref" in out and "junk" not in out


def test_readfilt_paired_end(tmp_path, rng, capsys):
    ref = "".join(rng.choice(list("ACGT"), size=5000))
    fa = tmp_path / "ref.fa"
    fa.write_text(f">r\n{ref}\n")
    run_cli(["sketch", "-k", "15", "-S", "12", str(fa)])
    hll_path = str(fa) + ".w.15.spacing.12.hll"
    r1, r2 = tmp_path / "r1.fq", tmp_path / "r2.fq"
    junk1 = "".join(rng.choice(list("ACGT"), size=100))
    junk2 = "".join(rng.choice(list("ACGT"), size=100))
    with open(r1, "w") as f1, open(r2, "w") as f2:
        f1.write(f"@pair_ref/1\n{ref[100:200]}\n+\n{'I' * 100}\n")
        f2.write(f"@pair_ref/2\n{ref[300:400]}\n+\n{'I' * 100}\n")
        f1.write(f"@pair_junk/1\n{junk1}\n+\n{'I' * 100}\n")
        f2.write(f"@pair_junk/2\n{junk2}\n+\n{'I' * 100}\n")
    capsys.readouterr()
    run_cli(["readfilt", "-k", "15", "-s", hll_path, "-f", "0.5",
             str(r1), str(r2)])
    out = capsys.readouterr().out
    # both mates of the matching pair emitted; junk pair filtered out
    assert "pair_ref/1" in out and "pair_ref/2" in out
    assert "pair_junk" not in out


def test_nn_binary_format(genomes, tmp_path, capsys):
    out = str(tmp_path / "nn.bin")
    run_cli(["dist", "-k", "21", "-S", "12", "--nearest-neighbors", "2",
             "-b", "-O", out, "--avoid-sorting"] + genomes)
    capsys.readouterr()
    raw = open(out, "rb").read()
    n = int.from_bytes(raw[0:4], "little")
    k = int.from_bytes(raw[4:8], "little")
    assert n == 3 and k == 2
    rec = np.frombuffer(raw[8:], dtype=[("v", "<f4"), ("i", "<u4")])
    assert rec.shape == (6,)
    assert set(rec["i"]) <= {0, 1, 2}


def test_card_binary(genomes, tmp_path, capsys):
    out = str(tmp_path / "cards.bin")
    run_cli(["card", "-k", "21", "-S", "12", "-b", "-o", out,
             "--avoid-sorting"] + genomes)
    capsys.readouterr()
    cards = np.fromfile(out, np.float32)
    assert cards.shape == (3,)
    assert (cards > 1000).all()


def test_qr_binary_raw_rows(genomes, tmp_path, capsys):
    qfile = tmp_path / "q.txt"
    qfile.write_text(genomes[2] + "\n")
    out = str(tmp_path / "qr.bin")
    run_cli(["dist", "-k", "21", "-S", "12", "-b", "-O", out,
             "--avoid-sorting", "-Q", str(qfile), genomes[0], genomes[1]])
    capsys.readouterr()
    data = np.fromfile(out, np.float32)
    # raw f32 rows, no header (reference partdist_loop binary mode)
    assert data.shape == (2,)
    assert os.path.exists(out + ".labels")


@pytest.mark.parametrize("flag", ["--use-nthash", "--use-cyclic-hash"])
def test_dist_rolling_k_above_32(genomes, tmp_path, capsys, flag):
    """k > 32 must work with the rolling encoders (reference src/enums.h:
    42-47 NTHASH/CYCLIC are unbounded; only BONSAI is k<=32).  Regression:
    the Spacer constructor used to reject k>32 for every encoding."""
    capsys.readouterr()
    run_cli(["dist", flag, "-k", "40", "-S", "12", "--avoid-sorting"]
            + genomes)
    out = capsys.readouterr().out
    assert "##Names" in out
    # self-similarity sanity: values parse as floats in [0, 1]
    row = out.splitlines()[-2].split("\t")
    vals = [float(v) for v in row[2:] if v != "-"]
    assert all(0.0 <= v <= 1.0 for v in vals)


def test_dist_bonsai_k_above_32_rejected(genomes, capsys):
    with pytest.raises(SystemExit, match="k must be <= 32"):
        run_cli(["dist", "-k", "40", "-S", "12"] + genomes)


def test_multifile_logical_path(genomes, tmp_path, capsys):
    """One -F line with space-separated files = ONE logical genome
    (for_each_substr, reference src/substrs.h:7-26): its sketch must equal
    the union of the parts' sketches."""
    pf = tmp_path / "paths.txt"
    pf.write_text(f"{genomes[0]} {genomes[1]}\n{genomes[2]}\n")
    run_cli(["sketch", "-k", "17", "-S", "11", "--avoid-sorting",
             "-F", str(pf)])
    # cache name drops everything before the first space, like the
    # reference's make_fname (dashing.h:505: strchr(path, FNAME_SEP))
    combo = HLL.read(genomes[1] + ".w.17.spacing.11.hll")
    run_cli(["sketch", "-k", "17", "-S", "11", genomes[0], genomes[1]])
    a = HLL.read(genomes[0] + ".w.17.spacing.11.hll")
    b = HLL.read(genomes[1] + ".w.17.spacing.11.hll")
    np.testing.assert_array_equal(combo.regs, np.maximum(a.regs, b.regs))


def test_union_stdout_gzipped(genomes, tmp_path, capsysbinary):
    """union to stdout must be gzip (reference gzopens stdout), so other
    subcommands can read it back."""
    for g in genomes[:2]:
        run_cli(["sketch", "-k", "17", "-S", "11", g])
    sks = [g + ".w.17.spacing.11.hll" for g in genomes[:2]]
    capsysbinary.readouterr()
    run_cli(["union"] + sks)
    blob = capsysbinary.readouterr().out
    assert blob[:2] == b"\x1f\x8b"
    import io as _io
    m = HLL.read(gzip.GzipFile(fileobj=_io.BytesIO(blob)))
    want = HLL.read(sks[0])
    want += HLL.read(sks[1])
    np.testing.assert_array_equal(m.regs, want.regs)


def test_dist_scientific_format(genomes, capsys):
    run_cli(["dist", "-e", "-k", "17", "-S", "11", "--avoid-sorting"]
            + genomes[:2])
    out = capsys.readouterr().out
    row = [l for l in out.splitlines()
           if not l.endswith("-") and ("e-" in l or "e+" in l)]
    assert row, out   # at least one scientific-notation value emitted


def test_sketch_by_seq_typed(tmp_path, rng, capsys):
    seqs = ["".join(rng.choice(list("ACGT"), size=600)) for _ in range(3)]
    fa = tmp_path / "m.fa"
    fa.write_text("".join(f">s{i}\n{s}\n" for i, s in enumerate(seqs)))
    out = str(tmp_path / "db8.gz")
    run_cli(["sketch_by_seq", "-8", "-k", "15", "-S", "11", "-o", out,
             str(fa)])
    from dashing_tpu.sketch.setsketches import BBitMinHash
    with gzip.open(out, "rb") as fp:
        recs = [BBitMinHash.read_record(fp) for _ in range(3)]
    assert all(isinstance(r, BBitMinHash) for r in recs)
    capsys.readouterr()
    run_cli(["dist_by_seq", "-8", "-n", out + ".names", out])
    got = capsys.readouterr().out
    assert "##Names\ts0\ts1\ts2" in got


@pytest.mark.parametrize("flag", ["--use-bloom-filter",
                                  "--use-full-khash-sets"])
def test_nn_mode_non_hll(genomes, capsys, flag):
    """NN mode must work for host-side sketch types (regression: the
    batched compare returned a read-only array and the diagonal write
    crashed)."""
    run_cli(["dist", flag, "-k", "17", "-S", "12", "--nearest-neighbors",
             "1", "--avoid-sorting"] + genomes)
    out = capsys.readouterr().out
    nn_lines = [l for l in out.splitlines() if ":" in l and "\t" in l]
    assert len(nn_lines) >= 3


def test_mkdist_jukes_cantor_orders_by_divergence(genomes, tmp_path,
                                                  capsys, monkeypatch):
    """JC distances from the multi-k regression must increase with the
    mutation rate (g0 vs g1 = 2%, g0 vs g2 = 10%)."""
    monkeypatch.chdir(tmp_path)
    run_cli(["mkdist", "--multik", "jc,15,22,2", "--jukes-cantor", "-S",
             "12", "--avoid-sorting"] + genomes)
    n, cond = distmat.read_binary("jc.jcd")
    assert n == 3
    d01, d02, d12 = cond
    assert np.isfinite(d01) and np.isfinite(d02)
    assert 0 < d01 < d02, (d01, d02)


def test_sketch_paths_batched_mixed_sizes(tmp_path, rng):
    """The small-file batched dispatch must produce registers identical to
    the per-file path across mixed file sizes (grouped single-chunk files,
    a multi-chunk file, an empty file, differing tile shapes)."""
    from dashing_tpu import pipeline
    from dashing_tpu.cli import core
    paths = []
    sizes = [5_000, 5_000, 5_000, 700_000, 0, 9_000, 120_000, 5_000]
    for i, n in enumerate(sizes):
        p = tmp_path / f"m{i}.fa"
        if n == 0:
            p.write_text(">empty\n\n")
        else:
            p.write_text(f">m{i}\n" + "".join(rng.choice(list("ACGT"),
                                                         size=n)) + "\n")
        paths.append(str(p))
    o = core.CommonOpts(k=21, sketch_size=11)
    sketches = core.sketch_paths(paths, o)
    params = core.sketch_params(o)
    for path, sk in zip(paths, sketches):
        want = pipeline.sketch_file_hll(path, params, 11)
        np.testing.assert_array_equal(sk.regs, want, err_msg=path)


def test_device_hll_run_retries_transient_pull_failure(tmp_path, rng,
                                                       monkeypatch, capsys):
    """A transient backend error on a device pull (e.g. a
    FAILED_PRECONDITION JaxRuntimeError) must not kill the run: the
    affected files are re-dispatched synchronously and the registers come
    out identical to a clean run (SURVEY.md sec 5.3)."""
    import jax
    from dashing_tpu.cli import core
    paths = []
    for i in range(6):
        p = tmp_path / f"r{i}.fa"
        p.write_text(f">r{i}\n" + "".join(rng.choice(list("ACGT"),
                                                     size=4_000)) + "\n")
        paths.append(str(p))
    o = core.CommonOpts(k=21, sketch_size=11)
    clean = {}
    core.device_hll_run(list(enumerate(paths)), o,
                        lambda i, r: clean.__setitem__(i, r))
    assert len(clean) == 6

    real_get = jax.device_get
    fails = {"n": 2}

    def flaky_get(h):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise jax.errors.JaxRuntimeError(
                "FAILED_PRECONDITION: backend error (injected)")
        return real_get(h)

    monkeypatch.setattr(jax, "device_get", flaky_get)
    got = {}
    core.device_hll_run(list(enumerate(paths)), o,
                        lambda i, r: got.__setitem__(i, r))
    assert fails["n"] == 0, "failure injection never fired"
    assert "re-dispatching" in capsys.readouterr().err
    for i in range(6):
        np.testing.assert_array_equal(got[i], clean[i])


def test_hll_main_retries_transient_pull_failure(tmp_path, rng,
                                                 monkeypatch, capsys):
    """The hll subcommand's merge drain must survive a transient pull
    failure and produce the identical merged cardinality."""
    import jax
    paths = []
    for i in range(4):
        p = tmp_path / f"h{i}.fa"
        p.write_text(f">h{i}\n" + "".join(rng.choice(list("ACGT"),
                                                     size=3_000)) + "\n")
        paths.append(str(p))
    args = ["hll", "-k", "21", "-S", "12"] + paths
    run_cli(args)
    clean = capsys.readouterr().out

    real_get = jax.device_get
    fails = {"n": 1}

    def flaky_get(h):
        if fails["n"] > 0:
            fails["n"] -= 1
            raise jax.errors.JaxRuntimeError(
                "FAILED_PRECONDITION: backend error (injected)")
        return real_get(h)

    monkeypatch.setattr(jax, "device_get", flaky_get)
    run_cli(args)
    cap = capsys.readouterr()
    assert fails["n"] == 0, "failure injection never fired"
    assert "re-dispatching" in cap.err
    assert cap.out == clean


def test_sketch_with_retry_exhausts_and_raises(tmp_path, rng, monkeypatch):
    """Persistent backend failure stays fail-loud: after bounded retries
    the original error propagates instead of silently degrading."""
    import jax
    from dashing_tpu import pipeline
    from dashing_tpu.cli import core
    p = tmp_path / "x.fa"
    p.write_text(">x\n" + "".join(rng.choice(list("ACGT"), size=2_000))
                 + "\n")

    calls = {"n": 0}

    def always_fail(path, params, pp):
        calls["n"] += 1
        raise jax.errors.JaxRuntimeError("injected permanent failure")

    monkeypatch.setattr(pipeline, "sketch_file_hll", always_fail)
    monkeypatch.setattr("time.sleep", lambda s: None)
    o = core.CommonOpts(k=21, sketch_size=11)
    params = core.sketch_params(o)
    with pytest.raises(jax.errors.JaxRuntimeError):
        core._sketch_with_retry(str(p), params, 11, attempts=3)
    assert calls["n"] == 3


def test_small_batch_size_bounds():
    """Bank memory bound must hold at every p — no floor (review r2: a
    max(8,...) floor pinned multi-GiB banks at -S 24)."""
    from dashing_tpu.pipeline import small_batch_size
    for p in range(10, 27):
        b = small_batch_size(p)
        assert b * (4 << p) <= (64 << 20), p
        assert b % 8 == 0
    assert small_batch_size(14) == 64
    assert small_batch_size(24) == 0        # batching off at huge p


def test_flatten_subcommand(genomes, tmp_path, capsys):
    """Standalone `flatten` combines per-k binary matrices into the
    reference container (reference src/flatten_all.cpp:39-43)."""
    mats = []
    for k in (15, 17):
        out = str(tmp_path / f"d{k}.bin")
        run_cli(["dist", "-k", str(k), "-S", "11", "-b", "-O", out,
                 "--avoid-sorting"] + genomes)
        mats.append(out)
    capsys.readouterr()
    flat = str(tmp_path / "flat.bin")
    run_cli(["flatten", "-o", flat, "-k", "15,17"] + mats)
    nsets, ks, data = distmat.read_flattened(flat)
    assert nsets == 3 and list(ks) == [15, 17]
    # entry-major interleave: values must match the per-k matrices
    for ki, mat in enumerate(mats):
        _, cond = distmat.read_binary(mat)
        np.testing.assert_array_equal(data[:, ki], cond)


def test_dist_W_cache_through_device_engine(genomes, tmp_path, capsys):
    """-W routes through the tuned device engine now: first run writes
    cache files, second run reads them, outputs identical; countmin (-y)
    also flows through the engine and matches the per-file builder."""
    from dashing_tpu.cli import core as c
    out1 = str(tmp_path / "a.bin")
    run_cli(["dist", "-k", "17", "-S", "11", "-W", "--avoid-sorting",
             "-b", "-O", out1] + genomes)
    capsys.readouterr()
    cached = [g + ".w.17.spacing.11.hll" for g in genomes]
    assert all(os.path.exists(f) for f in cached)
    out2 = str(tmp_path / "b.bin")
    run_cli(["dist", "-k", "17", "-S", "11", "-W", "--avoid-sorting",
             "-b", "-O", out2] + genomes)
    capsys.readouterr()
    with open(out1, "rb") as f1, open(out2, "rb") as f2:
        assert f1.read() == f2.read()
    # engine cache file contents equal the serial builder's
    o = c.CommonOpts()
    o.k, o.sketch_size, o.cache_sketch = 17, 11, False
    sk = c.sketch_or_load(genomes[0], o)
    np.testing.assert_array_equal(sk.regs, HLL.read(cached[0]).regs)
    for f in cached:
        os.unlink(f)
    # countmin-filtered engine vs per-file two-pass builder
    run_cli(["dist", "-k", "17", "-S", "11", "-y", "-c", "2",
             "--avoid-sorting", "-O", str(tmp_path / "cm.bin")] + genomes)
    capsys.readouterr()
    o2 = c.CommonOpts()
    o2.k, o2.sketch_size = 17, 11
    o2.use_counting_filter, o2.mincount = True, 2
    got = c.sketch_paths(genomes, o2)
    want = [c.sketch_or_load(g, o2) for g in genomes]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.regs, w.regs)


def _parse_ut_tsv(path):
    lines = open(path).read().splitlines()
    assert lines[0].startswith("##Names\t")
    names = lines[0].split("\t")[1:]
    n = len(names)
    vals = []
    for i, line in enumerate(lines[1:]):
        fields = line.split("\t")
        assert fields[0] == names[i]
        assert fields[1:i + 2] == ["-"] * (i + 1)
        vals.extend(float(v) for v in fields[i + 2:])
    assert len(vals) == n * (n - 1) // 2
    return names, np.array(vals, np.float64)


def _parse_phylip(path):
    lines = open(path).read().splitlines()
    n = int(lines[0])
    vals = []
    for i in range(n):
        fields = lines[1 + i].split("\t")
        assert len(fields) == n - i  # padded name + upper-tri values
        vals.extend(float(v) for v in fields[1:])
    return np.array(vals, np.float64)


def _parse_full_tsv(path):
    lines = open(path).read().splitlines()
    assert lines[0].startswith("#Names")
    names = ("\t" + lines[0][len("#Names"):]).split("\t")[1:]
    n = len(names)
    sq = np.zeros((n, n), np.float64)
    for i in range(n):
        fields = lines[1 + i].split("\t")
        assert fields[0] == names[i]
        sq[i] = [float(v) for v in fields[1:]]
    return sq


SYMMETRIC_EMISSIONS = {
    "ji": [],
    "mash": ["-M"],
    "sizes": ["-Z"],
    "full-mash": ["-l"],
    "sym-ci": ["--symmetric-containment-index"],
    "sym-cd": ["--symmetric-containment-dist"],
}


@pytest.mark.parametrize("emission", sorted(SYMMETRIC_EMISSIONS))
def test_emission_format_matrix_symmetric(genomes, tmp_path, capsys,
                                          emission):
    """Every symmetric emission type must agree across all four output
    formats (reference emitters src/sketch_and_cmp.h:786-880: UT_TSV,
    PHYLIP, FULL_TSV, binary all consume the same result_cmp values)."""
    eflags = SYMMETRIC_EMISSIONS[emission]
    base = ["dist", "-k", "21", "-S", "12", "--avoid-sorting"]
    outs = {fmt: str(tmp_path / f"d{emission}.{fmt}")
            for fmt in ("tsv", "phylip", "full", "bin")}
    run_cli(base + eflags + ["-O", outs["tsv"]] + genomes)
    run_cli(base + eflags + ["-U", "-O", outs["phylip"]] + genomes)
    run_cli(base + eflags + ["-T", "-O", outs["full"]] + genomes)
    run_cli(base + eflags + ["-b", "-O", outs["bin"]] + genomes)
    capsys.readouterr()
    names, ut = _parse_ut_tsv(outs["tsv"])
    n, cond = distmat.read_binary(outs["bin"])
    assert n == len(genomes)
    # binary float32 is the canonical precision; text is %.6g of float32
    np.testing.assert_allclose(ut, cond, rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(_parse_phylip(outs["phylip"]), cond,
                               rtol=2e-5, atol=1e-6)
    sq = _parse_full_tsv(outs["full"])
    np.testing.assert_array_equal(np.diag(sq), np.zeros(n))
    np.testing.assert_array_equal(sq, sq.T)
    np.testing.assert_allclose(sq[np.triu_indices(n, 1)], cond,
                               rtol=2e-5, atol=1e-6)
    labels = open(outs["bin"] + ".labels").read().splitlines()
    assert labels == names == genomes


ASYMMETRIC_EMISSIONS = {
    "ci": ["--containment-index"],
    "cd": ["--containment-dist"],
    "full-cd": ["--full-containment-dist"],
}


@pytest.mark.parametrize("emission", sorted(ASYMMETRIC_EMISSIONS))
def test_emission_format_matrix_asymmetric(genomes, tmp_path, capsys,
                                           emission):
    """Asymmetric emissions run rectangular Q x R; TSV and binary must
    carry the same values, and omitting -Q auto-promotes all references
    to queries (reference src/distmain.cpp:130-136 note)."""
    eflags = ASYMMETRIC_EMISSIONS[emission]
    base = ["dist", "-k", "21", "-S", "12", "--avoid-sorting"]
    qfile = tmp_path / "q.txt"
    qfile.write_text(genomes[1] + "\n")
    t_out = str(tmp_path / f"r{emission}.tsv")
    b_out = str(tmp_path / f"r{emission}.bin")
    run_cli(base + eflags + ["-Q", str(qfile), "-O", t_out] + genomes)
    run_cli(base + eflags + ["-Q", str(qfile), "-b", "-O", b_out] + genomes)
    capsys.readouterr()
    raw = np.fromfile(b_out, np.float32).reshape(1, len(genomes))
    lines = open(t_out).read().splitlines()
    assert len(lines) == 1 and lines[0].split("\t")[0] == genomes[1]
    tsv_vals = np.array([float(v) for v in lines[0].split("\t")[1:]])
    np.testing.assert_allclose(tsv_vals, raw[0], rtol=2e-5, atol=1e-6)
    # query==ref column: containment of a set in itself
    self_col = genomes.index(genomes[1])
    if emission == "ci":
        assert raw[0, self_col] == pytest.approx(1.0, abs=1e-5)
    # no -Q: every reference becomes a query -> square rectangular matrix
    sq_out = str(tmp_path / f"sq{emission}.bin")
    run_cli(base + eflags + ["-b", "-O", sq_out] + genomes)
    capsys.readouterr()
    sq = np.fromfile(sq_out, np.float32).reshape(len(genomes), len(genomes))
    np.testing.assert_allclose(sq[self_col], raw[0], rtol=1e-6)


def test_readfilt_emit_format(tmp_path, rng, capsys):
    """Output records mirror the reference emit() byte layout
    (src/readfilt.cpp:17-33): FASTQ mate 1 '@name comment|CI:%lf|a|b|x|',
    mate 2 '@name comment|%lf', FASTA '>name comment|%lf'; original
    comments preserved; quality re-emitted."""
    import re
    ref = "".join(rng.choice(list("ACGT"), size=5000))
    fa = tmp_path / "ref.fa"
    fa.write_text(f">r\n{ref}\n")
    run_cli(["sketch", "-k", "15", "-S", "12", str(fa)])
    hll_path = str(fa) + ".w.15.spacing.12.hll"
    r1, r2 = tmp_path / "f1.fq", tmp_path / "f2.fq"
    r1.write_text(f"@m1 some comment\n{ref[100:200]}\n+\n{'I' * 100}\n")
    r2.write_text(f"@m2 other\n{ref[300:400]}\n+\n{'J' * 100}\n")
    capsys.readouterr()
    run_cli(["readfilt", "-k", "15", "-s", hll_path, "-f", "0.3",
             str(r1), str(r2)])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 8
    m = re.fullmatch(
        r"@m1 some comment\|CI:(\d+\.\d{6})\|\d+\.\d{6}\|\d+\.\d{6}"
        r"\|\d+\.\d{6}\|", lines[0])
    assert m, lines[0]
    ci = m.group(1)
    assert lines[1] == ref[100:200] and lines[2] == "+"
    assert lines[3] == "I" * 100
    assert lines[4] == f"@m2 other|{ci}"
    assert lines[7] == "J" * 100
    # FASTA input: '>name comment|%lf', no quality lines
    fr = tmp_path / "r.fa"
    fr.write_text(f">fr a note\n{ref[500:650]}\n")
    capsys.readouterr()
    run_cli(["readfilt", "-k", "15", "-s", hll_path, "-f", "0.3", str(fr)])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2
    assert re.fullmatch(r">fr a note\|\d+\.\d{6}", lines[0]), lines[0]
    assert lines[1] == ref[500:650]


def test_readfilt_mate1_quality_governs_pair_format(tmp_path, rng, capsys):
    """Reference emit() branches on MATE 1's quality for both records
    (src/readfilt.cpp:17-33): a FASTA first mate demotes a FASTQ second
    mate to FASTA output."""
    ref = "".join(rng.choice(list("ACGT"), size=5000))
    fa = tmp_path / "ref2.fa"
    fa.write_text(f">r\n{ref}\n")
    run_cli(["sketch", "-k", "15", "-S", "12", str(fa)])
    hll_path = str(fa) + ".w.15.spacing.12.hll"
    r1 = tmp_path / "m1.fa"        # FASTA mate 1
    r2 = tmp_path / "m2.fq"        # FASTQ mate 2
    r1.write_text(f">m1 c1\n{ref[100:200]}\n")
    r2.write_text(f"@m2 c2\n{ref[300:400]}\n+\n{'I' * 100}\n")
    capsys.readouterr()
    run_cli(["readfilt", "-k", "15", "-s", hll_path, "-f", "0.3",
             str(r1), str(r2)])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 4                      # 2 FASTA records, no quality
    assert lines[0].startswith(">m1 c1|")
    assert lines[1] == ref[100:200]
    assert lines[2].startswith(">m2 c2|")
    assert lines[3] == ref[300:400]
