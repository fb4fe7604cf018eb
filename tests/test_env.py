"""Environment contracts: compile-cache placement, the hardware smoke's
refusal to run without a GPU, and benchmark results that name the device."""

import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_probe(env_dir):
    """Run enable_compile_cache in a fresh process; return (returned dir,
    jax's configured cache dir)."""
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    code = ("import json, jax\n"
            "from hga_tpu.utils.compile_cache import enable_compile_cache\n"
            "d = enable_compile_cache()\n"
            "print(json.dumps([d, jax.config.jax_compilation_cache_dir]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_compile_cache_honours_env(tmp_path):
    d = str(tmp_path / "cache")
    got, configured = _cache_probe(d)
    assert got == d
    assert configured == d          # read by JAX itself, not set in code


def test_compile_cache_defaults_inside_checkout():
    got, configured = _cache_probe(None)
    assert got == configured == os.path.join(REPO, ".jax_cache")
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()


def _smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_refuses_the_cpu():
    out = _smoke(REPO)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "not 'gpu'" in out.stderr


def test_chip_smoke_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    out = _smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_bench_names_device_and_engine():
    from hga_tpu.utils.benchmarks import run_benchmark

    out = run_benchmark("myers", n_pairs=64)
    assert out["platform"] == "cpu" and out["impl"] == "xla"
    assert out["device_count"] >= 1 and out["device_kind"]
    assert out["gcups"] > 0 and out["cells"] == 64 * 112 * 192


@pytest.mark.parametrize("pid,smi,want", [
    (0, "GPU 0: H100\nGPU 1: H100\nGPU 2: H100\nGPU 3: H100\n", [0]),
    (5, "GPU 0: H100\nGPU 1: H100\nGPU 2: H100\nGPU 3: H100\n", [1]),
    (2, "", None),                      # nvidia-smi lists no card
    (1, None, None),                    # no nvidia-smi at all
])
def test_each_process_binds_one_card(monkeypatch, pid, smi, want):
    from hga_tpu.parallel import mesh

    monkeypatch.setenv("JAX_PLATFORMS", "")
    monkeypatch.setattr(mesh.shutil, "which",
                        lambda name: None if smi is None else "/bin/true")
    monkeypatch.setattr(
        mesh.subprocess, "run",
        lambda *a, **k: subprocess.CompletedProcess(a, 0, stdout=smi or ""))
    assert mesh.local_card(pid) == want


def test_cpu_processes_keep_their_devices(monkeypatch):
    from hga_tpu.parallel import mesh

    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert mesh.local_card(3) is None
