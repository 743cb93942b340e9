"""mkdist compare-phase fuse A/B (VERDICT r4 item 4): wall time at the
4 x 2 Mbp configuration, K=4 k-values, three modes:

  fused        — device-resident register banks (round-5 default)
  bank-off     — fused sketching, but compare re-uploads the bank per k
                 (DASHING_TPU_DEVICE_BANK_MB=0)
  unfused      — per-k sketching AND uploads (DASHING_TPU_NO_MULTIK_FUSE=1)

Run on the GPU from the repo root:  python benchmarks/mkdist_bank_ab.py [reps]
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.environ.get("DTPU_REPO", "/root/repo")

N, LEN, KS = 4, 2_000_000, "mk,17,31,4"     # k in {17, 21, 25, 29}
GEN_DIR = f"/tmp/dtpu_mkab_{N}x{LEN}"


def ensure_genomes():
    marker = os.path.join(GEN_DIR, ".complete")
    paths = [os.path.join(GEN_DIR, f"g{i}.fa") for i in range(N)]
    if os.path.exists(marker):
        return paths
    os.makedirs(GEN_DIR, exist_ok=True)
    rng = np.random.default_rng(3)
    lut = np.frombuffer(b"ACGT", np.uint8)
    base = rng.integers(0, 4, LEN, dtype=np.int8)
    for i, p in enumerate(paths):
        g = base.copy()
        pos = rng.integers(0, LEN, 2000 * (i + 1))
        g[pos] = (g[pos] + rng.integers(1, 4, pos.size)) % 4
        with open(p, "wb") as fp:
            fp.write(b">g%d\n" % i)
            fp.write(lut[g].tobytes())
            fp.write(b"\n")
    open(marker, "w").write("ok\n")
    return paths


def run_mode(paths, label, env_extra):
    env = dict(os.environ, **env_extra)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "dashing_tpu.cli", "mkdist", "--multik",
         KS, "-S", "14", "--avoid-sorting"] + paths,
        cwd=REPO, capture_output=True, env=env)
    dt = time.perf_counter() - t0
    ok = res.returncode == 0
    if not ok:
        print(res.stderr.decode()[-1500:], flush=True)
    # the per-k matrices land in cwd: collect them AND the flattened
    # container so a per-k-only divergence between modes cannot hide
    outs = {}
    for k in (17, 21, 25, 29):
        f = os.path.join(REPO, f"_mk_{k}")
        if os.path.exists(f):
            outs[k] = open(f, "rb").read()
            os.remove(f)
    flat = os.path.join(REPO, "mk.bin")
    outs["flat"] = open(flat, "rb").read() if os.path.exists(flat) else b""
    if os.path.exists(flat):
        os.remove(flat)
    return dt, ok, outs


def main(reps: int = 3) -> int:
    paths = ensure_genomes()
    modes = [
        ("fused", {}),
        ("bank-off", {"DASHING_TPU_DEVICE_BANK_MB": "0"}),
        ("unfused", {"DASHING_TPU_NO_MULTIK_FUSE": "1"}),
    ]
    blobs = {}
    for label, env_extra in modes:
        times = []
        for r in range(reps):
            dt, ok, outs = run_mode(paths, label, env_extra)
            if not ok:
                return 1
            times.append(dt)
            blobs[label] = outs
            print(f"{label} run {r}: {dt:.1f} s", flush=True)
        print(f"{label}: best {min(times):.1f} s  "
              f"all {[round(t, 1) for t in times]}", flush=True)
    same = (blobs["fused"] == blobs["bank-off"] == blobs["unfused"])
    print(f"per-k + flatten outputs identical across modes: {same}",
          flush=True)
    return 0 if same else 2


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 3))
