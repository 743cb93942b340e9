"""The compile-cache location rule, bench.py's device gate and in-run
denominator, and the once-per-process distributed initialization."""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_honours_env(monkeypatch, tmp_path):
    from dashing_tpu import compile_cache
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.cache_dir() == str(tmp_path)


def test_cache_dir_default_is_fixed_in_checkout(monkeypatch):
    from dashing_tpu import compile_cache
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = compile_cache.cache_dir()
    assert d == os.path.join(REPO, ".jax_cache") == compile_cache.DEFAULT_DIR
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_enable_sets_no_path_when_env_is_set(tmp_path):
    """With the variable set, JAX reads it itself: enable() must not point
    the cache anywhere else (run in a fresh process: jax.config is
    process-global)."""
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu')\n"
        "from dashing_tpu import compile_cache\n"
        "compile_cache.enable()\n"
        "print(jax.config.jax_compilation_cache_dir)\n")
    env = dict(os.environ, PYTHONPATH=REPO,
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "c"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == str(tmp_path / "c")


@pytest.fixture()
def bench_mod():
    sys.path.insert(0, REPO)
    try:
        import bench
        yield bench
    finally:
        sys.path.remove(REPO)


def test_bench_refuses_cpu_without_opt_in(bench_mod, monkeypatch):
    monkeypatch.delenv("DASHING_TPU_PLATFORM", raising=False)
    with pytest.raises(SystemExit, match="no GPU"):
        bench_mod.setup_device()


def test_bench_denominator_measured_in_run(bench_mod, monkeypatch, capsys):
    """vs_baseline divides the device rate by the host rate measured in
    the same run, and the line names the device it ran on."""
    monkeypatch.setenv("DASHING_TPU_PLATFORM", "cpu")
    monkeypatch.setattr(bench_mod, "device_rate", lambda: 6.0e8)
    monkeypatch.setattr(bench_mod, "host_baseline_rate", lambda: 2.0e6)
    monkeypatch.setattr(bench_mod, "card_name_and_power", lambda: "none")
    assert bench_mod.main() == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["vs_baseline"] == pytest.approx(300.0)
    assert out["host_baseline"] == 2.0e6
    assert out["device"]["platform"] == "cpu"
    assert out["device"]["count"] >= 1


def test_bench_host_baseline_runs(bench_mod):
    assert bench_mod.host_baseline_rate(n=1 << 12) > 0


def test_distributed_off_without_env(monkeypatch):
    from dashing_tpu.parallel import distributed
    monkeypatch.delenv("DASHING_TPU_DISTRIBUTED", raising=False)
    assert distributed.maybe_initialize() is False


def test_distributed_initializes_once_per_process(monkeypatch):
    """Several CLI commands in one process (chip_smoke drives them so)
    must not initialize jax.distributed twice."""
    import jax
    from dashing_tpu.parallel import distributed
    calls = []
    monkeypatch.setattr(jax.distributed, "initialize",
                        lambda **kw: calls.append(kw))
    monkeypatch.setattr(distributed, "_INITIALIZED", False)
    monkeypatch.setenv("DASHING_TPU_DISTRIBUTED", "1")
    monkeypatch.setenv("JAX_COORDINATOR", "localhost:1234")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "2")
    monkeypatch.setenv("JAX_PROCESS_ID", "1")
    assert distributed.maybe_initialize() is True
    assert distributed.maybe_initialize() is True
    assert calls == [dict(coordinator_address="localhost:1234",
                          num_processes=2, process_id=1)]
