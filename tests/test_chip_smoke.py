"""chip_smoke.py's own helpers, on the CPU: deterministic data, the host
reference registers against the device sketch path, the shape of the
result line, and refusal to run off the GPU."""
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import chip_smoke  # noqa: E402


def test_generation_deterministic(tmp_path):
    a, fam_a, rates_a = chip_smoke.make_genomes(str(tmp_path / "a"), 6, 5000,
                                                2, 99, "G")
    b, fam_b, rates_b = chip_smoke.make_genomes(str(tmp_path / "b"), 6, 5000,
                                                2, 99, "G")
    for x, y in zip(a, b):
        assert open(x, "rb").read() == open(y, "rb").read()
    np.testing.assert_array_equal(fam_a, fam_b)
    np.testing.assert_array_equal(rates_a, rates_b)
    c, _, _ = chip_smoke.make_genomes(str(tmp_path / "c"), 6, 5000, 2, 100,
                                      "G")
    assert open(a[0], "rb").read() != open(c[0], "rb").read()
    seq = chip_smoke.read_fasta_seq(a[0])
    assert len(seq) == 5000 and (seq == ord("N")).any()
    # relatives share most k-mers; other families share none
    k0, k2, k1 = (set(chip_smoke.host_kmers(chip_smoke.read_fasta_seq(a[i]),
                                            21).tolist()) for i in (0, 2, 1))
    assert len(k0 & k2) / len(k0 | k2) > 0.05
    assert len(k0 & k1) / len(k0 | k1) < 0.01


def test_host_registers_equal_device_sketch(tmp_path, capsys):
    """The independent host pipeline and the CLI's device sketch (here on
    the CPU backend) give bitwise-equal registers."""
    from dashing_tpu.sketch.hll import HLL
    paths, _, _ = chip_smoke.make_genomes(str(tmp_path / "fa"), 3, 30_000, 2,
                                          5, "R")
    out = str(tmp_path / "hll")
    os.makedirs(out)
    chip_smoke.cli("sketch", "-k", 21, "-S", 12, "-P", out, *paths)
    capsys.readouterr()
    for path in paths:
        from dashing_tpu.io.cache import make_fname
        got = HLL.read(make_fname(path, 12, 0, 21, 21, "", "", out, "bonsai",
                                  ".hll")).regs
        np.testing.assert_array_equal(got, chip_smoke.host_registers(path, 21,
                                                                     12))


def test_last_line_shape():
    line = chip_smoke.last_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}


def test_refuses_non_gpu(tmp_path):
    """Off the GPU the script exits non-zero and prints no result line —
    in the checkout and as a lone copy of the script."""
    lone = tmp_path / "lone"
    lone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), lone / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    for cwd in (REPO, str(lone)):
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                           env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout


@pytest.mark.parametrize("canon", [True, False], ids=["canon", "fwd"])
@pytest.mark.parametrize("k", [5, 21, 31])
def test_host_kmers_match_encode_oracle(k, canon):
    """The smoke's host encoder against the repo's scalar oracle."""
    from dashing_tpu.ops.encode import Spacer, encode_oracle
    rng = np.random.default_rng(k)
    seq = rng.choice(np.frombuffer(b"ACGTACGTN", np.uint8), size=3000)
    want = encode_oracle(seq.tobytes(), Spacer(k), canon)
    np.testing.assert_array_equal(chip_smoke.host_kmers(seq, k, canon), want)


@pytest.mark.parametrize("length", [1, 80, 1001])
def test_fasta_round_trip(tmp_path, length):
    seq = np.random.default_rng(length).choice(
        np.frombuffer(b"ACGTN", np.uint8), size=length)
    path = str(tmp_path / "x.fa")
    chip_smoke.write_fasta(path, "x", seq)
    lines = open(path, "rb").read().split(b"\n")
    assert lines[0] == b">x" and all(len(ln) <= 80 for ln in lines)
    np.testing.assert_array_equal(chip_smoke.read_fasta_seq(path), seq)


def test_read_condensed_orders_by_labels(tmp_path):
    """A -b matrix is read through its .labels sidecar into the caller's
    path order."""
    labels = ["c", "a", "b"]
    vals = np.array([0.1, 0.2, 0.3], np.float32)   # (c,a) (c,b) (a,b)
    path = str(tmp_path / "m.bin")
    with open(path, "wb") as f:
        f.write(bytes([0]) + np.uint64(3).tobytes() + vals.tobytes())
    with open(path + ".labels", "w") as f:
        f.write("\n".join(labels) + "\n")
    m = chip_smoke.read_condensed(path, ["a", "b", "c"])
    assert m[0, 1] == m[1, 0] == np.float32(0.3)
    assert m[0, 2] == np.float32(0.1) and m[1, 2] == np.float32(0.2)


def test_host_mash_matches_device_estimator():
    """The f64 host oracle and the device MLE agree on one pair."""
    import jax.numpy as jnp
    from dashing_tpu.sketch import estimators as est
    from dashing_tpu.sketch.hll import HLL
    rng = np.random.default_rng(9)
    shared = rng.integers(0, 2**62, 20_000, dtype=np.uint64)
    a, b = HLL(12), HLL(12)
    a.addh_np(np.concatenate([shared, rng.integers(0, 2**62, 5000,
                                                   dtype=np.uint64)]))
    b.addh_np(shared)
    ji, mash = chip_smoke.host_mash(a.regs, b.regs, 12, 21)
    q = 64 - 12
    h = lambda r: est.register_histogram(jnp.asarray(r.astype(np.int32)), q)
    ca, cb, cu = (float(est.mle_estimate(h(r), 12))
                  for r in (a.regs, b.regs, np.maximum(a.regs, b.regs)))
    want = (ca + cb - cu) / cu
    assert abs(ji - want) < 1e-4 and 0.7 < ji < 0.9
    assert mash == pytest.approx(-np.log(2 * ji / (1 + ji)) / 21)
