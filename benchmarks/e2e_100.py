"""End-to-end CLI benchmark: 100 x 2 Mbp genomes, k=31, p=16, full Mash
matrix, binary emission (BASELINE.json config[1] shape).  Fresh process per
run (round-1 methodology); genomes are generated once and reused.

Run on the GPU from the repo root:
    python benchmarks/e2e_100.py [reps]
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

# DTPU_REPO pins the child CLI's cwd (hence the imported package) to a
# worktree, so benchmark code can be frozen against ongoing edits
REPO = os.environ.get("DTPU_REPO", "/root/repo")

# config[1] default: 100 x 2 Mbp, -S16 -k31.  config[3] shape:
#   DTPU_E2E_N=1000 DTPU_E2E_LEN=200000 DTPU_E2E_S=14 DTPU_E2E_K=21
N = int(os.environ.get("DTPU_E2E_N", 100))
LEN = int(os.environ.get("DTPU_E2E_LEN", 2_000_000))
S = os.environ.get("DTPU_E2E_S", "16")
KK = os.environ.get("DTPU_E2E_K", "31")
GEN_DIR = f"/tmp/dtpu_e2e_{N}x{LEN}"


def ensure_genomes() -> str:
    fofn = os.path.join(GEN_DIR, "fofn.txt")
    marker = os.path.join(GEN_DIR, ".complete")
    if os.path.exists(marker):
        return fofn
    os.makedirs(GEN_DIR, exist_ok=True)
    rng = np.random.default_rng(7)
    base = rng.integers(0, 4, LEN, dtype=np.int8)
    lut = np.frombuffer(b"ACGT", np.uint8)
    paths = []
    for i in range(N):
        g = base.copy()
        nmut = int(0.002 * (i + 1) * LEN / N * 10)
        pos = rng.integers(0, LEN, nmut)
        g[pos] = (g[pos] + rng.integers(1, 4, nmut)) % 4
        seq = lut[g]
        p = os.path.join(GEN_DIR, f"g{i:03d}.fa")
        with open(p, "wb") as fp:
            fp.write(b">g%d\n" % i)
            fp.write(seq.tobytes())
            fp.write(b"\n")
        paths.append(p)
        print(f"\rgen {i+1}/{N}", end="", file=sys.stderr, flush=True)
    print(file=sys.stderr)
    with open(fofn, "w") as fp:
        fp.write("\n".join(paths) + "\n")
    open(marker, "w").write("ok\n")
    return fofn


def main(reps: int = 3):
    fofn = ensure_genomes()
    out = os.path.join(GEN_DIR, "dist.bin")
    # DTPU_E2E_FLAGS appends extra dist flags (e.g. "-W" to measure the
    # cached-sketch path, "-J" for joint MLE)
    extra = os.environ.get("DTPU_E2E_FLAGS", "").split()
    times = []
    for r in range(reps):
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", "dashing_tpu.cli", "dist", "-k", KK,
             "-S", S, "-M", "-b", "-O", out, "-F", fofn,
             "--avoid-sorting"] + extra,
            cwd=REPO, capture_output=True)
        dt = time.perf_counter() - t0
        ok = res.returncode == 0 and os.path.getsize(out) > 4
        times.append(dt)
        print(f"run {r}: {dt:.1f} s ok={ok}", flush=True)
        if not ok:
            print(res.stderr.decode()[-2000:], flush=True)
            return 1
    print(f"E2E config[1]: best {min(times):.1f} s, "
          f"all {[round(t,1) for t in times]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 3))
