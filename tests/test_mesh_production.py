"""Production within-host multi-device paths (VERDICT r1 item 1).

The suite runs on an 8-device virtual CPU mesh (conftest), so the CLI's
sketch and compare paths take the sharded branches by DEFAULT here.  These
tests pin the contract: output BYTE-IDENTICAL to the single-device path,
and the work actually sharded (asserted on sharding specs).
"""
import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dashing_tpu import pipeline
from dashing_tpu.cli import main as climain
from dashing_tpu.ops import pairwise as pw
from dashing_tpu.parallel import mesh as pmesh
from dashing_tpu.sketch import estimators as est
from dashing_tpu.sketch.hll import HLL


@contextlib.contextmanager
def mesh_disabled():
    """Force the single-device paths, restoring the real mesh after."""
    saved = pmesh.local_mesh()
    pmesh._set_local_mesh_for_tests(None)
    try:
        yield
    finally:
        pmesh._set_local_mesh_for_tests(saved)


def _write_genome(tmp_path, rng, name, n):
    seq = "".join(rng.choice(list("ACGT"), size=n))
    p = tmp_path / name
    p.write_text(f">{name}\n{seq}\n")
    return str(p)


def test_local_mesh_exists_here():
    mesh = pmesh.local_mesh()
    assert mesh is not None and mesh.size == 8


def test_sharded_sketch_bitwise_identical(tmp_path, rng):
    # long genome -> multiple chunks incl. a non-full tail; tiny genome ->
    # rows < 8 exercises the unsharded fallback chunk after sharded ones
    params = pipeline.SketchParams(k=21)
    for n in (700_000, 3_000, 150):
        path = _write_genome(tmp_path, rng, f"g{n}.fa", n)
        sharded = pipeline.sketch_file_hll(path, params, 12)
        with mesh_disabled():
            single = pipeline.sketch_file_hll(path, params, 12)
        assert (sharded == single).all(), n


@pytest.mark.parametrize("every", [4, 16])
def test_pmax_batching_bitwise_identical(tmp_path, rng, monkeypatch, every):
    """DASHING_TPU_PMAX_EVERY=N hoists the register all-reduce out of the
    chunk loop, merging per-device banks every N chunks (SCALING.md
    falsifier-1 mitigation).  max is associative+commutative, so the
    registers must be BITWISE identical to the per-chunk-merge default
    for every N — including streams whose chunk count is not a multiple
    of N and streams that fall back to the unsharded tail path."""
    params = pipeline.SketchParams(k=21)
    # 700k bases -> multiple sharded chunks + a ragged tail; 3k -> the
    # single-chunk unsharded fallback interleaves with banked state
    for n in (700_000, 3_000):
        path = _write_genome(tmp_path, rng, f"pe{every}_{n}.fa", n)
        base = pipeline.sketch_file_hll(path, params, 12)
        monkeypatch.setenv("DASHING_TPU_PMAX_EVERY", str(every))
        batched = pipeline.sketch_file_hll(path, params, 12)
        monkeypatch.delenv("DASHING_TPU_PMAX_EVERY")
        assert (np.asarray(base) == np.asarray(batched)).all(), (every, n)


def test_pmax_batching_reduces_collectives(tmp_path, rng, monkeypatch):
    """The whole point: N=4 must cut merge-collective dispatches ~4x
    (counted at the python call sites; each _banks_pmax/_banks_merge call
    is one all-reduce where the default pays one per chunk)."""
    params = pipeline.SketchParams(k=21)
    # 9 synthetic (64, C) tiles fed straight to the chunk stream: rows
    # divisible by D, so every tile takes the sharded banks path
    bases = np.frombuffer(b"ACGT", np.uint8)
    tiles = [rng.choice(bases, size=(64, 2048 + 20)) for _ in range(9)]
    counts = {"merge": 0, "chunks": 0}
    orig_pmax, orig_merge = pipeline._banks_pmax, pipeline._banks_merge

    def count_calls(orig, key):
        def outer(*a, **kw):
            fn = orig(*a, **kw)

            def wrapped(*args):
                counts[key] += 1
                return fn(*args)
            return wrapped
        return outer

    monkeypatch.setattr(pipeline, "_banks_pmax",
                        count_calls(orig_pmax, "merge"))
    monkeypatch.setattr(pipeline, "_banks_merge",
                        count_calls(orig_merge, "merge"))
    monkeypatch.setattr(pipeline, "_sharded_ascii_step_banks",
                        count_calls(pipeline._sharded_ascii_step_banks,
                                    "chunks"))
    monkeypatch.setenv("DASHING_TPU_PMAX_EVERY", "4")
    pipeline._sketch_chunk_stream(tiles, params, 12)
    assert counts["chunks"] == 9
    # one all-reduce per 4 chunks + the final drain merge = 3, where the
    # per-chunk default would have paid 9
    assert counts["merge"] <= 3


def test_sharded_sketch_is_actually_sharded(tmp_path, rng, monkeypatch):
    """The sharded chunk step must see tile rows split over 'd'."""
    calls = {}

    def spy(orig):
        def make(mesh, *a, **kw):
            fn = orig(mesh, *a, **kw)

            def wrapped(*args):
                out = fn(*args)
                calls["n"] = calls.get("n", 0) + 1
                calls["sharding"] = out.sharding
                return out
            return wrapped
        return make

    # lru_cache on the originals: patch the lookup sites instead
    monkeypatch.setattr(pipeline, "_sharded_ascii_step",
                        spy(pipeline._sharded_ascii_step))
    path = _write_genome(tmp_path, rng, "g.fa", 400_000)
    params = pipeline.SketchParams(k=21, rehash=True)
    _ = pipeline.sketch_file_hll(path, params, 12)
    assert calls.get("n", 0) >= 1
    # replicated output spec, over all 8 mesh devices
    assert len(calls["sharding"].device_set) == 8


@pytest.mark.parametrize("jestim", [est.ERTL_MLE, est.ERTL_JOINT_MLE])
def test_sharded_compare_bitwise_and_sharded(rng, jestim):
    """Compare tiles spread round robin over the mesh devices, each tile
    bitwise equal to the single-device result."""
    p = 11
    n = 37
    sketches = []
    for i in range(n):
        h = HLL(p)
        h.addh_np(rng.integers(0, 2**62, 3000 + 37 * i, dtype=np.uint64))
        sketches.append(h)
    regs = np.stack([s.regs for s in sketches]).astype(np.int32)
    kmin, kmax = int(regs.min()), int(regs.max()) + 1
    devs = [pw.compare_tile_async(regs, regs, p, pw.JI, 1.0 / 21,
                                  est.ERTL_MLE, jestim, kmax, kmin, slot=s)
            for s in range(3)]
    placed = [next(iter(d.sharding.device_set)) for d in devs]
    mesh = pmesh.local_mesh()
    assert placed == list(mesh.devices.flat[:3])
    with mesh_disabled():
        want = np.asarray(pw.compare_tile_async(
            regs, regs, p, pw.JI, 1.0 / 21, est.ERTL_MLE, jestim,
            kmax, kmin))
    assert want.shape == (n, n)
    for d in devs:
        np.testing.assert_array_equal(np.asarray(d), want)


def test_cli_dist_output_bytes_identical(tmp_path, rng, capsys):
    paths = [_write_genome(tmp_path, rng, f"c{i}.fa", 20_000 + 777 * i)
             for i in range(5)]
    out_m = str(tmp_path / "mesh.bin")
    out_s = str(tmp_path / "single.bin")
    assert climain.main(["dist", "-k", "21", "-S", "12", "-b", "-O", out_m,
                         "--avoid-sorting"] + paths) == 0
    with mesh_disabled():
        assert climain.main(["dist", "-k", "21", "-S", "12", "-b", "-O",
                             out_s, "--avoid-sorting"] + paths) == 0
    capsys.readouterr()
    assert open(out_m, "rb").read() == open(out_s, "rb").read()


def test_cli_dist_jmle_output_bytes_identical(tmp_path, rng, capsys):
    paths = [_write_genome(tmp_path, rng, f"j{i}.fa", 15_000) for i in range(3)]
    out_m = str(tmp_path / "mesh.bin")
    out_s = str(tmp_path / "single.bin")
    assert climain.main(["dist", "-k", "21", "-S", "12", "-J", "-b", "-O",
                         out_m, "--avoid-sorting"] + paths) == 0
    with mesh_disabled():
        assert climain.main(["dist", "-k", "21", "-S", "12", "-J", "-b",
                             "-O", out_s, "--avoid-sorting"] + paths) == 0
    capsys.readouterr()
    assert open(out_m, "rb").read() == open(out_s, "rb").read()


def test_counting_filter_sharded_identical(tmp_path, rng):
    params = pipeline.SketchParams(k=15, min_count=2,
                                   use_counting_filter=True)
    path = _write_genome(tmp_path, rng, "cf.fa", 120_000)
    sharded = pipeline.sketch_file_hll(path, params, 11)
    with mesh_disabled():
        single = pipeline.sketch_file_hll(path, params, 11)
    assert (sharded == single).all()


def test_cli_union_mesh_identical(tmp_path, rng, capsys):
    """union over the mesh must produce the same merged sketch as the
    sequential += path (odd file count exercises the zero-row padding)."""
    from dashing_tpu.sketch.hll import HLL
    paths = []
    for i in range(5):
        h = HLL(10)
        h.addh_np(rng.integers(0, 2**62, 2000 + 37 * i, dtype=np.uint64))
        p = str(tmp_path / f"u{i}.hll")
        h.write(p)
        paths.append(p)
    out_m = str(tmp_path / "mesh.hll")
    out_s = str(tmp_path / "seq.hll")
    assert climain.main(["union", "-o", out_m] + paths) == 0
    with mesh_disabled():
        assert climain.main(["union", "-o", out_s] + paths) == 0
    capsys.readouterr()
    a = HLL.read(out_m)
    b = HLL.read(out_s)
    np.testing.assert_array_equal(a.regs, b.regs)


def test_cli_panel_mesh_identical(tmp_path, rng, capsys):
    """The round-3 batched panel path (device_hll_run queries + one tiled
    rect JMLE pass) must emit identical output on the mesh and off it."""
    import gzip
    refs = [_write_genome(tmp_path, rng, f"p{i}.fa", 12_000 + 531 * i)
            for i in range(3)]
    db = str(tmp_path / "panel.db")
    assert climain.main(["sketch", "-k", "17", "-S", "12", "-o", db,
                         "--avoid-sorting"] + refs) == 0
    with gzip.open(db + ".labels.gz", "rt") as f, \
            open(db + ".labels", "w") as g:
        g.write(f.read())
    qpath = tmp_path / "q.fa"
    qpath.write_text(">q\n" + open(refs[1]).read().splitlines()[1][:6000]
                     + "\n")
    out_m = str(tmp_path / "panel_mesh.tsv")
    out_s = str(tmp_path / "panel_single.tsv")
    capsys.readouterr()
    assert climain.main(["panel", "-k", "17", "-o", out_m, db,
                         str(qpath)]) == 0
    with mesh_disabled():
        assert climain.main(["panel", "-k", "17", "-o", out_s, db,
                             str(qpath)]) == 0
    capsys.readouterr()
    m = open(out_m).read()
    assert open(out_s).read() == m
    assert "p1.fa" in m          # best match is the source genome
