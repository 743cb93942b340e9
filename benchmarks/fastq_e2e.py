"""config[2] E2E: FASTQ streaming — sketch 1M short reads (plain and
count-min-filtered) and report the union cardinality error (VERDICT r4
item 5; reference workload src/readfilt.cpp:78-100).  Round-1 anchor:
79 s plain / 64 s filtered, before the native loader, prefetch, fused
pipeline, and the round-5 streaming ingest.

Run on the GPU from the repo root:  python benchmarks/fastq_e2e.py [reps]
Env: DTPU_FQ_READS (default 1_000_000), DTPU_FQ_LEN (default 100),
     DTPU_FQ_STREAM=1 forces the streaming ingest path.
"""
from __future__ import annotations

import os
import subprocess
import sys
import time

import numpy as np

REPO = os.environ.get("DTPU_REPO", "/root/repo")

READS = int(os.environ.get("DTPU_FQ_READS", 1_000_000))
LEN = int(os.environ.get("DTPU_FQ_LEN", 100))
GEN_DIR = f"/tmp/dtpu_fq_{READS}x{LEN}"


def ensure_reads() -> str:
    fq = os.path.join(GEN_DIR, "reads.fq")
    marker = os.path.join(GEN_DIR, ".complete")
    if os.path.exists(marker):
        return fq
    os.makedirs(GEN_DIR, exist_ok=True)
    rng = np.random.default_rng(11)
    lut = np.frombuffer(b"ACGT", np.uint8)
    # reads drawn from a 5 Mbp genome => realistic duplicate k-mer mass
    genome = lut[rng.integers(0, 4, 5_000_000)]
    qual = b"I" * LEN
    with open(fq, "wb") as fp:
        batch = 20_000
        for b0 in range(0, READS, batch):
            nb = min(batch, READS - b0)
            starts = rng.integers(0, genome.size - LEN, nb)
            rows = []
            for i, s in enumerate(starts):
                rows.append(b"@r%d\n" % (b0 + i))
                rows.append(genome[s:s + LEN].tobytes())
                rows.append(b"\n+\n")
                rows.append(qual)
                rows.append(b"\n")
            fp.write(b"".join(rows))
            print(f"\rgen {b0 + nb}/{READS}", end="", file=sys.stderr,
                  flush=True)
    print(file=sys.stderr)
    open(marker, "w").write("ok\n")
    return fq


def run_once(fq: str, extra, env_extra=None) -> float:
    env = dict(os.environ, **(env_extra or {}))
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "dashing_tpu.cli", "sketch", "-k", "31",
         "-S", "14"] + extra + [fq],
        cwd=REPO, capture_output=True, env=env)
    dt = time.perf_counter() - t0
    if res.returncode != 0:
        print(res.stderr.decode()[-2000:], flush=True)
        return -1.0
    return dt


def exact_genome_kmers(k: int = 31) -> int:
    """Exact distinct canonical k-mer count of the source genome (reads
    at ~20x coverage see essentially all of them), vectorized numpy."""
    rng = np.random.default_rng(11)            # same stream as ensure_reads
    g = rng.integers(0, 4, 5_000_000).astype(np.uint64)
    n = g.size - k + 1
    fwd = np.zeros(n, np.uint64)
    rc = np.zeros(n, np.uint64)
    for t in range(k):
        fwd = (fwd << np.uint64(2)) | g[t:t + n]
        rc |= (np.uint64(3) - g[t:t + n]) << np.uint64(2 * t)
    return int(np.unique(np.minimum(fwd, rc)).size)


def check_accuracy(fq: str) -> bool:
    """Sketch cardinality vs the exact distinct-kmer count: the guard
    that a streaming-ingest regression corrupting registers cannot pass
    the E2E campaign silently.  p=14 -> sigma ~0.8%; allow 3%."""
    sketch_file = fq + ".w.31.spacing.14.hll"
    if not os.path.exists(sketch_file):
        print("accuracy: no cached sketch found, skipping", flush=True)
        return True
    if READS * (LEN - 30) < 3 * 5_000_000:
        # below ~3x k-mer coverage the reads genuinely miss genome
        # k-mers, so est < exact by design — the check only means
        # something at the production 1M-read coverage
        print("accuracy: coverage too low to check, skipping", flush=True)
        return True
    sys.path.insert(0, REPO)
    # the one report() jit runs on the CPU: this parent must not take a
    # share of the card from the CLI children it times
    import jax
    jax.config.update("jax_platforms", "cpu")
    from dashing_tpu.sketch.hll import HLL
    est = HLL.read(sketch_file).report()
    exact = exact_genome_kmers()
    rel = est / exact - 1.0
    # reads only MISS boundary k-mers, so est <= exact + estimator noise
    ok = abs(rel) < 0.03
    print(f"accuracy: est {est:,.0f} vs exact-genome {exact:,} "
          f"({rel:+.3%}) -> {'OK' if ok else 'FAIL'}", flush=True)
    return ok


def main(reps: int = 2) -> int:
    fq = ensure_reads()
    force_stream = ({"DASHING_TPU_STREAM": "1"}
                    if os.environ.get("DTPU_FQ_STREAM") else None)
    for label, extra in (("plain", []),
                         ("countmin>=2", ["--countmin", "--min-count", "2"])):
        times = []
        for r in range(reps):
            dt = run_once(fq, extra, force_stream)
            if dt < 0:
                return 1
            times.append(dt)
            print(f"{label} run {r}: {dt:.1f} s "
                  f"({READS / dt:,.0f} reads/s)", flush=True)
        print(f"config[2] {label}: best {min(times):.1f} s = "
              f"{READS / min(times):,.0f} reads/s", flush=True)
    # `sketch` always writes the per-file .hll (that IS the subcommand's
    # output); the last plain run was countmin-free, but the countmin run
    # overwrote it — re-run plain once, untimed, for the accuracy check
    if run_once(fq, [], force_stream) < 0:
        return 1
    return 0 if check_accuracy(fq) else 2


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 2))
