"""True multi-process integration: 2 jax.distributed processes on CPU.

Exercises the multi-host wiring the reference never had (SURVEY.md sec 2.4
P7): sharded sketching + cross-process register-max merge, driven through
the real CLI in subprocesses.
"""
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_procs(args, tmp_path, nprocs, timeout=240, extra_env=None):
    """Run the CLI as `nprocs` jax.distributed processes; returns the
    completed processes in rank order.  Child output goes to temp files
    (PIPEs could deadlock if one rank floods its buffer while the other
    waits on a collective); a timeout FAILS the test — a deadlock in the
    distributed merge is exactly what these tests exist to catch."""
    port = _free_port()
    procs = []
    for rank in range(nprocs):
        env = dict(os.environ)
        env.update(
            PYTHONPATH=REPO,
            DASHING_TPU_PLATFORM="cpu",
            DASHING_TPU_DISTRIBUTED="1",
            JAX_COORDINATOR=f"127.0.0.1:{port}",
            JAX_NUM_PROCESSES=str(nprocs),
            JAX_PROCESS_ID=str(rank),
        )
        env.update(extra_env or {})
        env.pop("XLA_FLAGS", None)
        of = open(tmp_path / f"rank{rank}.out", "w+")
        ef = open(tmp_path / f"rank{rank}.err", "w+")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "dashing_tpu.cli"] + args,
            stdout=of, stderr=ef, cwd=str(tmp_path), env=env, text=True),
            of, ef))
    outs = []
    for p, of, ef in procs:
        try:
            p.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q, _, _ in procs:
                q.kill()
            pytest.fail(f"jax.distributed {nprocs}-process run timed out "
                        "(possible deadlock in the distributed path)")
        of.seek(0)
        ef.seek(0)
        outs.append((p.returncode, of.read(), ef.read()))
        of.close()
        ef.close()
    return outs


def _run_pair(args, tmp_path, timeout=240, extra_env=None):
    return _run_procs(args, tmp_path, 2, timeout, extra_env)


def _run_single(args, tmp_path, timeout=240, extra_env=None):
    env = dict(os.environ)
    env.update(PYTHONPATH=REPO, DASHING_TPU_PLATFORM="cpu")
    env.update(extra_env or {})
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-m", "dashing_tpu.cli"] + args,
                       capture_output=True, cwd=str(tmp_path), env=env,
                       text=True, timeout=timeout)
    assert r.returncode == 0, r.stderr
    return r.stdout


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist2p")
    rng = np.random.default_rng(17)
    names = []
    for i in range(4):
        s = "".join(rng.choice(list("ACGT"), size=4000))
        (tmp / f"g{i}.fa").write_text(f">g{i}\n{s}\n")
        names.append(f"g{i}.fa")
    return tmp, names


def test_hll_two_process_matches_single(genomes):
    tmp, names = genomes
    args = ["hll", "-k", "17", "-S", "14"] + names
    single = _run_single(args, tmp)
    outs = _run_pair(args, tmp)
    assert outs[0][0] == 0 and outs[1][0] == 0, (outs[0][2], outs[1][2])
    line = [l for l in single.splitlines() if "Estimated" in l]
    line0 = [l for l in outs[0][1].splitlines() if "Estimated" in l]
    assert line and line0
    assert line[0] == line0[0]
    # non-main process stays silent
    assert "Estimated" not in outs[1][1]


def test_dist_two_process_matches_single(genomes):
    tmp, names = genomes
    args = ["dist", "-k", "17", "-S", "12", "--avoid-sorting"] + names
    single = _run_single(args, tmp)
    outs = _run_pair(args, tmp)
    assert outs[0][0] == 0 and outs[1][0] == 0, (outs[0][2], outs[1][2])

    def clean(s):  # gloo prints a connection banner to stdout
        return "\n".join(l for l in s.splitlines()
                         if not l.startswith("[Gloo]"))

    # rank 0 emits the identical full result (sketches allgathered);
    # rank 1 stays silent — it must not race rank 0 on output files
    assert clean(outs[0][1]) == clean(single)
    assert "##Names" not in outs[1][1]


def test_sketch_two_process_shards_files(genomes):
    tmp, names = genomes
    args = ["sketch", "-k", "17", "-S", "12", "--avoid-sorting"] + names
    outs = _run_pair(args, tmp)
    assert outs[0][0] == 0 and outs[1][0] == 0, (outs[0][2], outs[1][2])
    for n in names:
        assert (tmp / (n + ".w.17.spacing.12.hll")).exists()


def test_union_two_process_matches_single(genomes):
    tmp, names = genomes
    _run_single(["sketch", "-k", "17", "-S", "11", "--avoid-sorting"]
                + names, tmp)
    sks = [n + ".w.17.spacing.11.hll" for n in names]
    single = _run_single(["union", "-o", "single.hll"] + sks, tmp)
    outs = _run_pair(["union", "-o", "pair.hll"] + sks, tmp)
    assert outs[0][0] == 0 and outs[1][0] == 0, (outs[0][2], outs[1][2])
    import gzip
    a = gzip.open(str(tmp / "single.hll"), "rb").read()
    b = gzip.open(str(tmp / "pair.hll"), "rb").read()
    assert a == b


# ---------------------------------------------------------------------------
# Cross-host SHARDED COMPARE phase (SURVEY sec 2.4-P7 / 5.8): tile-row
# stripes split across processes, landed by rank-local mmap stripe writes
# (binary) or a stripe gather to rank 0 (TSV).  TILE=2 makes the 6-genome
# runs split real work: blocks {0, 4} vs {2} — both ranks compute tiles.
# ---------------------------------------------------------------------------

TILE_ENV = {"DASHING_TPU_COMPARE_TILE": "2",
            "DASHING_TPU_HOST_COMPARE_TILE": "2"}


@pytest.fixture(scope="module")
def genomes6(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dist2p6")
    rng = np.random.default_rng(23)
    names = []
    for i in range(6):
        s = "".join(rng.choice(list("ACGT"), size=3000))
        (tmp / f"s{i}.fa").write_text(f">s{i}\n{s}\n")
        names.append(f"s{i}.fa")
    return tmp, names


def _clean(s):  # gloo prints a connection banner to stdout
    return "\n".join(l for l in s.splitlines() if not l.startswith("[Gloo]"))


def test_dist_sharded_tsv_matches_single(genomes6):
    tmp, names = genomes6
    args = ["dist", "-k", "17", "-S", "12", "--avoid-sorting"] + names
    single = _run_single(args, tmp, extra_env=TILE_ENV)
    outs = _run_pair(args, tmp, extra_env=TILE_ENV)
    assert outs[0][0] == 0 and outs[1][0] == 0, (outs[0][2], outs[1][2])
    assert _clean(outs[0][1]) == _clean(single)
    assert "##Names" not in outs[1][1]


def test_dist_sharded_binary_stripe_writes(genomes6):
    tmp, names = genomes6
    base = ["dist", "-k", "17", "-S", "12", "--avoid-sorting", "-b"]
    _run_single(base + ["-O", "one.bin"] + names, tmp, extra_env=TILE_ENV)
    outs = _run_pair(base + ["-O", "two.bin"] + names, tmp,
                     extra_env=TILE_ENV)
    assert outs[0][0] == 0 and outs[1][0] == 0, (outs[0][2], outs[1][2])
    a = (tmp / "one.bin").read_bytes()
    b = (tmp / "two.bin").read_bytes()
    assert a == b                      # finalized magic + stripes identical
    assert ((tmp / "one.bin.labels").read_bytes()
            == (tmp / "two.bin.labels").read_bytes())


def test_dist_sharded_rect_matches_single(genomes6):
    tmp, names = genomes6
    qf = tmp / "queries.txt"
    qf.write_text("\n".join(names[:2]) + "\n")
    args = (["dist", "-k", "17", "-S", "12", "--avoid-sorting",
             "-Q", "queries.txt"] + names)
    single = _run_single(args, tmp, extra_env=TILE_ENV)
    outs = _run_pair(args, tmp, extra_env=TILE_ENV)
    assert outs[0][0] == 0 and outs[1][0] == 0, (outs[0][2], outs[1][2])
    assert _clean(outs[0][1]) == _clean(single)


def test_dist_sharded_nn_matches_single(genomes6):
    tmp, names = genomes6
    args = (["dist", "-k", "17", "-S", "12", "--avoid-sorting",
             "--nearest-neighbors", "2"] + names)
    single = _run_single(args, tmp, extra_env=TILE_ENV)
    outs = _run_pair(args, tmp, extra_env=TILE_ENV)
    assert outs[0][0] == 0 and outs[1][0] == 0, (outs[0][2], outs[1][2])
    assert _clean(outs[0][1]) == _clean(single)


def test_dist_sharded_phylip_matches_single(genomes6):
    tmp, names = genomes6
    args = (["dist", "-k", "17", "-S", "12", "--avoid-sorting", "-U",
             "-J"] + names)      # PHYLIP x joint-MLE through the stripes
    single = _run_single(args, tmp, extra_env=TILE_ENV)
    outs = _run_pair(args, tmp, extra_env=TILE_ENV)
    assert outs[0][0] == 0 and outs[1][0] == 0, (outs[0][2], outs[1][2])
    assert _clean(outs[0][1]) == _clean(single)


@pytest.mark.parametrize("mode", [[], ["-b", "-O", "host.bin"],
                                  ["--nearest-neighbors", "2"]])
def test_dist_sharded_host_family_matches_single(genomes6, mode):
    """The batched HOST engines (b-bit minhash here) shard the compare
    phase too: HOST_COMPARE_TILE row stripes with the same gather/mmap
    landing as the register families."""
    tmp, names = genomes6
    env = dict(TILE_ENV)
    args = (["dist", "-k", "17", "-S", "12", "--avoid-sorting", "-8"]
            + mode + names)
    if "-O" in mode:
        single_args = [a if a != "host.bin" else "host1.bin" for a in args]
        _run_single(single_args, tmp, extra_env=env)
        outs = _run_pair(args, tmp, extra_env=env)
        assert outs[0][0] == 0 and outs[1][0] == 0, (outs[0][2], outs[1][2])
        assert ((tmp / "host.bin").read_bytes()
                == (tmp / "host1.bin").read_bytes())
    else:
        single = _run_single(args, tmp, extra_env=env)
        outs = _run_pair(args, tmp, extra_env=env)
        assert outs[0][0] == 0 and outs[1][0] == 0, (outs[0][2], outs[1][2])
        assert _clean(outs[0][1]) == _clean(single)


def test_dist_by_seq_sharded_matches_single(genomes6):
    """dist_by_seq's compare phase stripes like dist's: rank 0 must emit
    the identical matrix and rank 1 stay silent."""
    tmp, names = genomes6
    # build the per-seq sketch stream once (single process)
    multi = tmp / "multi.fa"
    multi.write_text("".join(
        open(tmp / n).read() for n in names))
    _run_single(["sketch_by_seq", "-k", "17", "-S", "12", "-o", "bysq.gz",
                 "multi.fa"], tmp)
    args = ["dist_by_seq", "-n", "bysq.gz.names", "bysq.gz"]
    single = _run_single(args, tmp, extra_env=TILE_ENV)
    outs = _run_pair(args, tmp, extra_env=TILE_ENV)
    assert outs[0][0] == 0 and outs[1][0] == 0, (outs[0][2], outs[1][2])
    assert _clean(outs[0][1]) == _clean(single)
    assert "##Names" not in outs[1][1]


def test_panel_sharded_matches_single(genomes6):
    tmp, names = genomes6
    import gzip as _gzip
    _run_single(["sketch", "-k", "17", "-S", "12", "-o", "panel.db",
                 "--avoid-sorting"] + names, tmp)
    with _gzip.open(tmp / "panel.db.labels.gz", "rt") as f, \
            open(tmp / "panel.db.labels", "w") as g:
        g.write(f.read())
    q = tmp / "pq.fa"
    q.write_text(">pq\n" + (tmp / names[1]).read_text().splitlines()[1][:2000]
                 + "\n")
    args = ["panel", "-k", "17", "-o", "panel_out.tsv", "panel.db", "pq.fa"]
    _run_single(args, tmp, extra_env=TILE_ENV)
    single_out = (tmp / "panel_out.tsv").read_text()
    (tmp / "panel_out.tsv").unlink()
    outs = _run_pair(args, tmp, extra_env=TILE_ENV)
    assert outs[0][0] == 0 and outs[1][0] == 0, (outs[0][2], outs[1][2])
    assert (tmp / "panel_out.tsv").read_text() == single_out
    assert names[1] in single_out     # best match is the source genome


# ---------------------------------------------------------------------------
# P >= 3 (VERDICT r4 weak #1): the stripe/NN/column merges have off-by-one
# regimes that two ranks cannot reach — ragged round-robin ownership, a
# rank owning zero tile rows (n_tiles < P), NN merge where a rank holds
# fewer than nn references, rect column stripes with P not dividing the
# reference count.  Each case must match the single-process run
# byte-for-byte, for both the gather (TSV) and mmap (binary) landings.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def genomes8(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("distp8")
    rng = np.random.default_rng(31)
    names = []
    for i in range(8):
        s = "".join(rng.choice(list("ACGT"), size=3000))
        (tmp / f"p{i}.fa").write_text(f">p{i}\n{s}\n")
        names.append(f"p{i}.fa")
    return tmp, names


def test_dist_p3_ragged_tsv_and_binary(genomes8):
    """8 genomes at TILE=2 -> blocks {0,2,4,6} over 3 ranks: rank 0 owns
    two blocks, ranks 1/2 one each (ragged round-robin)."""
    tmp, names = genomes8
    args = ["dist", "-k", "17", "-S", "12", "--avoid-sorting"] + names
    single = _run_single(args, tmp, extra_env=TILE_ENV)
    outs = _run_procs(args, tmp, 3, extra_env=TILE_ENV)
    assert all(o[0] == 0 for o in outs), [o[2][-800:] for o in outs]
    assert _clean(outs[0][1]) == _clean(single)
    assert "##Names" not in outs[1][1] and "##Names" not in outs[2][1]

    base = ["dist", "-k", "17", "-S", "12", "--avoid-sorting", "-b"]
    _run_single(base + ["-O", "p3_one.bin"] + names, tmp, extra_env=TILE_ENV)
    outs = _run_procs(base + ["-O", "p3_three.bin"] + names, tmp, 3,
                      extra_env=TILE_ENV)
    assert all(o[0] == 0 for o in outs), [o[2][-800:] for o in outs]
    assert ((tmp / "p3_one.bin").read_bytes()
            == (tmp / "p3_three.bin").read_bytes())


def test_dist_p3_rank_owns_zero_blocks(genomes6):
    """4 genomes at TILE=2 -> blocks {0,2} over 3 ranks: rank 2 owns no
    tile rows and must still participate in every collective."""
    tmp, names = genomes6
    sub = names[:4]
    args = ["dist", "-k", "17", "-S", "12", "--avoid-sorting"] + sub
    single = _run_single(args, tmp, extra_env=TILE_ENV)
    outs = _run_procs(args, tmp, 3, extra_env=TILE_ENV)
    assert all(o[0] == 0 for o in outs), [o[2][-800:] for o in outs]
    assert _clean(outs[0][1]) == _clean(single)

    base = ["dist", "-k", "17", "-S", "12", "--avoid-sorting", "-b"]
    _run_single(base + ["-O", "z_one.bin"] + sub, tmp, extra_env=TILE_ENV)
    outs = _run_procs(base + ["-O", "z_three.bin"] + sub, tmp, 3,
                      extra_env=TILE_ENV)
    assert all(o[0] == 0 for o in outs), [o[2][-800:] for o in outs]
    assert ((tmp / "z_one.bin").read_bytes()
            == (tmp / "z_three.bin").read_bytes())


def test_dist_p4_more_ranks_than_blocks(genomes6):
    """6 genomes at TILE=2 -> 3 blocks over 4 ranks: one rank idle."""
    tmp, names = genomes6
    args = ["dist", "-k", "17", "-S", "12", "--avoid-sorting"] + names
    single = _run_single(args, tmp, extra_env=TILE_ENV)
    outs = _run_procs(args, tmp, 4, extra_env=TILE_ENV, timeout=360)
    assert all(o[0] == 0 for o in outs), [o[2][-800:] for o in outs]
    assert _clean(outs[0][1]) == _clean(single)


def test_dist_p3_nn_rank_below_nn(genomes8):
    """NN merge where each rank's stripe holds fewer references than nn:
    8 refs at TILE=2 over 3 ranks gives ranks 1/2 only 2 owned ref rows,
    below nn=3 -> their candidate lists carry sentinels that must sort
    behind real entries."""
    tmp, names = genomes8
    args = (["dist", "-k", "17", "-S", "12", "--avoid-sorting",
             "--nearest-neighbors", "3"] + names)
    single = _run_single(args, tmp, extra_env=TILE_ENV)
    outs = _run_procs(args, tmp, 3, extra_env=TILE_ENV)
    assert all(o[0] == 0 for o in outs), [o[2][-800:] for o in outs]
    assert _clean(outs[0][1]) == _clean(single)


def test_dist_p3_rect_ragged_columns(genomes8):
    """Rect Q x R with P not dividing the reference count: 7 refs at
    TILE=2 -> column blocks {0,2,4,6} (last ragged) over 3 ranks."""
    tmp, names = genomes8
    qf = tmp / "q3.txt"
    qf.write_text("\n".join(names[:2]) + "\n")
    refs = names[:7]
    args = (["dist", "-k", "17", "-S", "12", "--avoid-sorting",
             "-Q", "q3.txt"] + refs)
    single = _run_single(args, tmp, extra_env=TILE_ENV)
    outs = _run_procs(args, tmp, 3, extra_env=TILE_ENV)
    assert all(o[0] == 0 for o in outs), [o[2][-800:] for o in outs]
    assert _clean(outs[0][1]) == _clean(single)


def test_dist_p3_tiny_gather_chunks(genomes8):
    """Force the chunked stripe gather through many steps (a few floats
    per collective): output must still match single-process byte-for-byte
    for both the condensed (all-pairs TSV) and column (rect) merges."""
    tmp, names = genomes8
    env = dict(TILE_ENV, DASHING_TPU_GATHER_CHUNK_MB="0.00002")
    args = ["dist", "-k", "17", "-S", "12", "--avoid-sorting"] + names
    single = _run_single(args, tmp, extra_env=env)
    outs = _run_procs(args, tmp, 3, extra_env=env)
    assert all(o[0] == 0 for o in outs), [o[2][-800:] for o in outs]
    assert _clean(outs[0][1]) == _clean(single)


def test_owned_blocks_partition_properties():
    """owned_blocks must partition the tile-row starts exactly (disjoint,
    complete) for every (P, n, tile) regime the subprocess tests cannot
    afford to sweep."""
    from dashing_tpu.parallel.distributed import owned_blocks
    for n in (1, 2, 5, 7, 16, 33, 100):
        for tile in (1, 2, 3, 8, 64):
            want = list(range(0, n, tile))
            for p in (1, 2, 3, 4, 5, 7):
                got = []
                for rank in range(p):
                    blocks = owned_blocks(rank, p, n, tile)
                    assert len(set(blocks)) == len(blocks)
                    got += blocks
                assert sorted(got) == want, (n, tile, p)


def test_card_two_process_matches_single(genomes):
    tmp, names = genomes
    args = ["card", "-k", "17", "-S", "12", "--avoid-sorting"] + names
    single = _run_single(args, tmp)
    outs = _run_pair(args, tmp)
    assert outs[0][0] == 0 and outs[1][0] == 0, (outs[0][2], outs[1][2])

    def clean(s):
        return "\n".join(l for l in s.splitlines()
                         if not l.startswith("[Gloo]"))

    assert clean(outs[0][1]) == clean(single)
    assert "#Path" not in outs[1][1]   # non-main rank silent
