#!/usr/bin/env python3
"""End-to-end smoke run of dashing_tpu on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]
    python3 chip_smoke.py --four-cards      # needs 4 GPUs; only that phase

Drives the CLI in process (dashing_tpu.cli.main.main) at a size users run
and checks what comes out against plain host references:

  1. device   a GPU is required; prints its kind, count, and the card's
              name and power limit (nvidia-smi).
  2. set A    128 genomes of 2 Mbp: `sketch -k 31 -S 14`, `dist -M -b`
              (default MLE) and `dist -J -b`.
     set B    2,048 genomes of 200 kbp, k=21: the same three commands
              (the 64-file batched sketch path; several 1024-wide compare
              tiles).
     Each set: registers of 8 genomes equal a host numpy encode ->
     wang_hash_np -> HLL.addh_np pipeline bitwise; 256 sampled -M
     entries match the float64 host MLE (mle_estimate_np) on the CLI's
     own registers; 16 -J estimates lie within 3 * 1.04 / sqrt(m) of the
     exact `--use-full-khash-sets` Jaccard.
  (No hand-written kernel survived the bring-up — see PERF.md — so there
  is no kernel-vs-XLA phase.)

Genomes are generated from --seed: several random ancestors, each with
relatives carrying point substitutions at log-uniform rates, so pairwise
Jaccard spans roughly 0.05 to 0.99 within a family.

Any failed check raises, and the run exits non-zero.  Only a run in
which every phase passed prints, as its last line,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.

--four-cards runs Set A's `sketch` and `dist -J -b` three ways: (a) one
process over 4 visible cards (the within-host mesh), (b) 4 processes
with one card each under DASHING_TPU_DISTRIBUTED, (c) one process on
one card.  This parent never touches a GPU; each run is a child process,
one at a time, and (a) and (b) must be byte-identical to (c).
"""
from __future__ import annotations

import argparse
import gzip
import json
import math
import os
import shutil
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(REPO, ".smoke_data")
P_BITS = 14                      # -S 14 in both sets
SETS = {
    # name: (genomes, length, families, k)
    "A": (128, 2_000_000, 8, 31),
    "B": (2048, 200_000, 64, 21),
}
RATE_RANGE = (1e-4, 4e-2)        # per-genome substitution rates
N_REG_CHECK = 8                  # genomes whose registers are checked
N_DIST_CHECK = 256               # sampled -M entries
N_EXACT_CHECK = 16               # -J entries against exact Jaccard
# f32 damped Newton (12 iterations, windowed histogram) on the device
# against f64 bisection on the full histogram on the host: cardinalities
# agree to ~1e-6 relative, and the shared part c_a + c_b - c_u amplifies
# that by up to 1/J — 20x at the smallest Jaccard sampled here.
MASH_RTOL = 1e-3


def log(msg: str) -> None:
    print(msg, flush=True)


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    log(f"  {'PASS' if ok else 'FAIL'}: {what}")
    if not ok:
        raise SmokeFailure(what)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------

def write_fasta(path: str, name: str, seq: np.ndarray, width: int = 80):
    full = len(seq) // width * width
    lines = np.full((full // width, width + 1), ord("\n"), np.uint8)
    lines[:, :width] = seq[:full].reshape(-1, width)
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        f.write(lines.tobytes())
        if full < len(seq):
            f.write(seq[full:].tobytes() + b"\n")


def make_genomes(out_dir: str, n: int, length: int, families: int,
                 seed: int, prefix: str):
    """Write n FASTA genomes; genome i descends from ancestor i % families
    with point substitutions at a log-uniform rate and one short N run.
    Returns (paths, family of each genome, rate of each genome)."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)
    ancestors = rng.integers(0, 4, size=(families, length), dtype=np.uint8)
    lo, hi = np.log(RATE_RANGE[0]), np.log(RATE_RANGE[1])
    rates = np.exp(rng.uniform(lo, hi, size=n))
    acgt = np.frombuffer(b"ACGT", np.uint8)
    paths = []
    for i in range(n):
        g = ancestors[i % families].copy()
        pos = rng.integers(0, length, rng.binomial(length, rates[i]))
        g[pos] = (g[pos] + rng.integers(1, 4, len(pos), dtype=np.uint8)) & 3
        seq = acgt[g]
        n0 = int(rng.integers(0, length - 64))
        seq[n0:n0 + int(rng.integers(1, 64))] = ord("N")
        name = f"{prefix}{i:04d}"
        path = os.path.join(out_dir, name + ".fa")
        write_fasta(path, name, seq)
        paths.append(path)
    return paths, np.arange(n) % families, rates


# ---------------------------------------------------------------------------
# Host references (numpy only, independent of the device code)
# ---------------------------------------------------------------------------

def read_fasta_seq(path: str) -> np.ndarray:
    """One-record FASTA -> uint8 bases."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    return np.frombuffer(b"".join(lines[1:]), np.uint8)


def host_kmers(seq: np.ndarray, k: int, canon: bool = True) -> np.ndarray:
    """Every valid k-mer of seq as a 2-bit integer, first base in the high
    bits; canonical = min(forward, reverse complement); windows holding a
    non-ACGT base are skipped."""
    lut = np.full(256, 4, np.uint8)
    for i, ch in enumerate(b"ACGT"):
        lut[ch] = i
        lut[ch + 32] = i
    code = lut[seq]
    bad = np.concatenate([[0], np.cumsum(code == 4)])
    n = len(seq) - k + 1
    ok = bad[k:] - bad[:n] == 0
    c = np.where(code == 4, 0, code).astype(np.uint64)
    fwd = np.zeros(n, np.uint64)
    rc = np.zeros(n, np.uint64)
    for t in range(k):
        fwd = (fwd << np.uint64(2)) | c[t:t + n]
        rc |= (np.uint64(3) - c[t:t + n]) << np.uint64(2 * t)
    km = np.minimum(fwd, rc) if canon else fwd
    return km[ok]


def host_registers(path: str, k: int, p: int) -> np.ndarray:
    from dashing_tpu.sketch.hll import HLL
    h = HLL(p)
    h.addh_np(host_kmers(read_fasta_seq(path), k))
    return h.regs


def host_mash(ra: np.ndarray, rb: np.ndarray, p: int, k: int):
    """(Jaccard, Mash distance) by f64 MLE inclusion-exclusion."""
    from dashing_tpu.sketch.estimators import mle_estimate_np
    q = 64 - p
    hist = lambda r: np.bincount(r.astype(np.int64), minlength=q + 2)
    ca = mle_estimate_np(hist(ra), p)
    cb = mle_estimate_np(hist(rb), p)
    cu = mle_estimate_np(hist(np.maximum(ra, rb)), p)
    ji = max(0.0, ca + cb - cu) / cu
    if ji <= 0:
        return ji, 1.0
    return ji, -math.log(2.0 * ji / (1.0 + ji)) / k


def last_line(platform: str, kind: str, count: int) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


# ---------------------------------------------------------------------------
# Driving the CLI
# ---------------------------------------------------------------------------

def cli(*argv) -> float:
    """Run one dashing_tpu command in this process; its wall seconds."""
    from dashing_tpu.cli.main import main
    t0 = time.perf_counter()
    rc = main([str(a) for a in argv])
    if rc != 0:
        raise SmokeFailure(f"dashing_tpu {argv[0]} exited {rc}")
    return time.perf_counter() - t0


def read_condensed(path: str, paths):
    """A -b matrix (1 byte dtype code 0 = float32, u64 n, then the
    condensed upper triangle row-major) -> (n, n) with rows in the order
    of `paths`, via its .labels sidecar."""
    raw = np.fromfile(path, np.uint8)
    n = int(raw[1:9].view("<u8")[0])
    vals = raw[9:].view("<f4")
    with open(path + ".labels") as f:
        labels = f.read().split("\n")[:-1]
    check(raw[0] == 0 and vals.size == n * (n - 1) // 2
          and n == len(labels) == len(paths),
          f"{os.path.basename(path)} holds {n} x {n} float32 entries")
    full = np.zeros((n, n), np.float32)
    iu = np.triu_indices(n, 1)
    full[iu] = vals
    full.T[iu] = vals
    order = [labels.index(p) for p in paths]
    return full[np.ix_(order, order)]


def sketch_file(path: str, prefix: str, k: int) -> str:
    from dashing_tpu.io.cache import make_fname
    return make_fname(path, P_BITS, 0, k, k, "", "", prefix, "bonsai", ".hll")


def device_info():
    import jax
    devs = jax.devices()
    return devs[0].platform, devs[0].device_kind, len(devs)


def nvidia_smi() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise SmokeFailure(f"nvidia-smi failed: {e}")
    if r.returncode != 0:
        raise SmokeFailure(f"nvidia-smi exited {r.returncode}: {r.stderr}")
    return r.stdout.strip()


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device():
    log("phase device")
    plat_env = os.environ.get("DASHING_TPU_PLATFORM", "")
    if plat_env not in ("", "cuda", "gpu"):
        raise SmokeFailure(f"DASHING_TPU_PLATFORM={plat_env} would move "
                           "the run off the GPU")
    platform, kind, count = device_info()
    log(f"  jax platform={platform} device_kind={kind} count={count}")
    check(platform == "gpu", f"JAX platform is gpu (got {platform})")
    log(f"  nvidia-smi: {nvidia_smi()}")
    return platform, kind, count


def check_set(name: str, seed: int):
    n, length, families, k = SETS[name]
    log(f"phase set {name}: {n} genomes x {length} bp, k={k}, "
        f"-S {P_BITS}")
    m = 1 << P_BITS
    d = os.path.join(WORK, f"set{name}")
    shutil.rmtree(d, ignore_errors=True)
    t0 = time.perf_counter()
    paths, fam, _ = make_genomes(os.path.join(d, "fa"), n, length, families,
                                 seed, name)
    log(f"  generated in {time.perf_counter() - t0:.2f} s")
    sk_dir = os.path.join(d, "hll")
    os.makedirs(sk_dir)

    dt = cli("sketch", "-k", k, "-S", P_BITS, "-P", sk_dir, *paths)
    log(f"  sketch: {dt:.2f} s ({n * length / dt / 1e6:.1f} Mbp/s)")
    from dashing_tpu.sketch.hll import HLL
    regs = np.stack([HLL.read(sketch_file(p, sk_dir, k)).regs
                     for p in paths])

    # registers: 4 genomes from each of two families
    pick = ([i for i in range(n) if fam[i] == 0][:N_REG_CHECK // 2]
            + [i for i in range(n) if fam[i] == 1][:N_REG_CHECK // 2])
    t0 = time.perf_counter()
    same = sum(np.array_equal(host_registers(paths[i], k, P_BITS), regs[i])
               for i in pick)
    log(f"  host reference registers in {time.perf_counter() - t0:.2f} s")
    check(same == len(pick),
          f"registers bitwise equal to the host numpy pipeline: "
          f"{same}/{len(pick)}")

    out_m = os.path.join(d, "mash.bin")
    sizes = os.path.join(d, "sizes.tsv")
    dt = cli("dist", "-k", k, "-S", P_BITS, "-M", "-b", "-O", out_m,
             "-o", sizes, *paths)
    log(f"  dist -M -b: {dt:.2f} s ({n * (n - 1) // 2 / dt / 1e6:.3f} "
        f"M pairs/s incl. sketch)")
    mash = read_condensed(out_m, paths)
    rng = np.random.default_rng(seed + 1)
    within = [(i, j) for i in range(n) for j in range(i + 1, n)
              if fam[i] == fam[j]]
    sample = [within[t] for t in rng.choice(len(within), N_DIST_CHECK,
                                            replace=False)]
    worst, jis = 0.0, []
    for i, j in sample:
        ji, want = host_mash(regs[i], regs[j], P_BITS, k)
        jis.append(ji)
        worst = max(worst, abs(float(mash[i, j]) - want) / want)
    log(f"  sampled Jaccard span {min(jis):.4f} .. {max(jis):.4f}")
    check(worst <= MASH_RTOL,
          f"-M vs f64 host MLE over {len(sample)} pairs: max rel err "
          f"{worst:.3e} <= {MASH_RTOL:.0e}")

    out_j = os.path.join(d, "jmle.bin")
    dt = cli("dist", "-k", k, "-S", P_BITS, "-J", "-b", "-O", out_j,
             "-o", sizes, *paths)
    log(f"  dist -J -b: {dt:.2f} s ({n * (n - 1) // 2 / dt / 1e6:.3f} "
        f"M pairs/s incl. sketch)")
    jm = read_condensed(out_j, paths)
    out_x = os.path.join(d, "exact.bin")
    sub = [paths[i] for i in pick]
    cli("dist", "-k", k, "--use-full-khash-sets", "-b", "-O", out_x,
        "-o", sizes, *sub)
    exact = read_condensed(out_x, sub)
    pairs = [(a, b) for a in range(len(pick)) for b in range(a + 1, len(pick))]
    pairs = ([pr for pr in pairs if fam[pick[pr[0]]] == fam[pick[pr[1]]]]
             + [pr for pr in pairs if fam[pick[pr[0]]] != fam[pick[pr[1]]]]
             )[:N_EXACT_CHECK]
    bound = 3 * 1.04 / math.sqrt(m)
    dev = max(abs(float(jm[pick[a], pick[b]]) - float(exact[a, b]))
              for a, b in pairs)
    log(f"  exact Jaccard of the checked pairs: "
        f"{min(exact[a, b] for a, b in pairs):.4f} .. "
        f"{max(exact[a, b] for a, b in pairs):.4f}")
    check(dev <= bound, f"-J vs exact Jaccard over {len(pairs)} pairs: "
          f"max abs dev {dev:.4f} <= {bound:.4f}")
    shutil.rmtree(d, ignore_errors=True)


# ---------------------------------------------------------------------------
# Four cards
# ---------------------------------------------------------------------------

def _child_env(visible: str, **extra) -> dict:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES=visible, PYTHONPATH=REPO)
    env.update(extra)
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def four_cards_child(out_dir: str, fa_dir: str) -> int:
    """One run of (a), (b) or (c): Set A's sketch and dist -J -b."""
    from dashing_tpu.parallel import distributed
    distributed.maybe_initialize()        # before anything touches a device
    platform, kind, count = device_info()
    if platform != "gpu":
        raise SmokeFailure(f"child sees platform {platform}")
    paths = sorted(os.path.join(fa_dir, f) for f in os.listdir(fa_dir))
    k = SETS["A"][3]
    os.makedirs(out_dir, exist_ok=True)
    t_sk = cli("sketch", "-k", k, "-S", P_BITS, "-P", out_dir, *paths)
    t_d = cli("dist", "-k", k, "-S", P_BITS, "-J", "-b", "-O",
              os.path.join(out_dir, "jmle.bin"), "-o",
              os.path.join(out_dir, "sizes.tsv"), *paths)
    print(json.dumps({"device": [platform, kind, count], "sketch_s": t_sk,
                      "dist_s": t_d}), flush=True)
    return 0


def _run_children(label: str, cmds) -> list:
    """Start the children of one configuration together, wait for all."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for argv, env in cmds]
    outs = []
    for pr in procs:
        try:
            out, err = pr.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for other in procs:
                other.kill()
            raise SmokeFailure(f"{label}: child timed out")
        if pr.returncode != 0:
            log(err[-4000:])
            raise SmokeFailure(f"{label}: child exited {pr.returncode}")
        outs.append(json.loads(out.strip().split("\n")[-1]))
    log(f"  {label}: {time.perf_counter() - t0:.2f} s wall; " + "; ".join(
        f"sketch {o['sketch_s']:.2f} s, dist -J {o['dist_s']:.2f} s"
        for o in outs))
    return outs


def phase_four_cards(seed: int):
    log("phase four cards: Set A sketch + dist -J -b, three ways")
    log(f"  nvidia-smi: {nvidia_smi()}")
    n, length, families, _ = SETS["A"]
    fa_dir = os.path.join(WORK, "four", "fa")
    shutil.rmtree(os.path.join(WORK, "four"), ignore_errors=True)
    make_genomes(fa_dir, n, length, families, seed, "A")
    me = [sys.executable, os.path.abspath(__file__), "--child"]
    runs = {
        "c": [(me + [os.path.join(WORK, "four", "c"), fa_dir],
               _child_env("0"))],
        "a": [(me + [os.path.join(WORK, "four", "a"), fa_dir],
               _child_env("0,1,2,3"))],
    }
    port = _free_port()
    runs["b"] = [(me + [os.path.join(WORK, "four", "b"), fa_dir],
                  _child_env(str(i), DASHING_TPU_DISTRIBUTED="1",
                             JAX_COORDINATOR=f"localhost:{port}",
                             JAX_NUM_PROCESSES="4", JAX_PROCESS_ID=str(i)))
                 for i in range(4)]
    info = {}
    for label, title in (("c", "(c) one process, one card"),
                         ("a", "(a) one process, 4-card mesh"),
                         ("b", "(b) 4 processes, one card each")):
        info[label] = _run_children(title, runs[label])
    kind = info["a"][0]["device"][1]
    check(info["a"][0]["device"][2] == 4, "(a) sees 4 devices")
    ref = os.path.join(WORK, "four", "c")
    files = sorted(os.listdir(ref))

    def content(path):
        # a .hll file is a gzip stream whose header carries a file name
        # and time: compare the sketch record it holds
        with open(path, "rb") as f:
            raw = f.read()
        return gzip.decompress(raw) if path.endswith(".hll") else raw

    failed = []
    for label in ("a", "b"):
        d = os.path.join(WORK, "four", label)
        differ = [f for f in files
                  if not os.path.exists(os.path.join(d, f))
                  or content(os.path.join(d, f))
                  != content(os.path.join(ref, f))]
        ok = sorted(os.listdir(d)) == files and not differ
        log(f"  {'PASS' if ok else 'FAIL'}: ({label}) byte-identical to (c): "
            f"{len(files) - len(differ)}/{len(files)} files (.hll sketch "
            f"records, jmle.bin + labels, sizes.tsv); differing: "
            f"{differ[:5]}")
        if not ok:
            failed.append(label)
    if failed:
        raise SmokeFailure(f"four cards: {failed} differ from one card")
    shutil.rmtree(os.path.join(WORK, "four"), ignore_errors=True)
    return "gpu", kind, 4


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-card phase (needs 4 GPUs)")
    ap.add_argument("--child", nargs=2, metavar=("OUT", "FASTA_DIR"),
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import dashing_tpu  # noqa: F401  (fail at once outside a checkout)
    if args.child:
        return four_cards_child(*args.child)
    t_start = time.perf_counter()
    try:
        if args.four_cards:
            platform, kind, count = phase_four_cards(args.seed)
        else:
            platform, kind, count = phase_device()
            for name in SETS:
                check_set(name, args.seed + ord(name))
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(last_line(platform, kind, count), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
