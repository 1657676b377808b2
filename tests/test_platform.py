"""Device policy (cdk/core/platform.py): a measurement path that finds no
GPU is an error, never a CPU run; the compile cache goes where the
environment says, else to a fixed path in the repository; dense recasts
are capped by the device's memory."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from cdk.core import platform

ROOT = Path(__file__).resolve().parents[1]


def test_require_gpu_raises_on_cpu():
    with pytest.raises(platform.NoGpuError, match="no GPU found"):
        platform.require_gpu()


@pytest.mark.parametrize("kind", ["neuron", "rocm", "METAL"])
def test_unknown_device_is_an_error(monkeypatch, kind):
    """Any first device that is not a GPU is refused, whatever it is."""

    class Dev:
        platform = kind
        device_kind = f"some {kind} device"

    monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
    with pytest.raises(platform.NoGpuError, match=kind):
        platform.require_gpu()


def test_backend_failure_is_no_gpu(monkeypatch):
    def boom(*a):
        raise RuntimeError("Unable to initialize backend 'cuda'")

    monkeypatch.setattr(jax, "devices", boom)
    with pytest.raises(platform.NoGpuError, match="initialize backend"):
        platform.require_gpu()


def test_device_record_names_the_device():
    rec = platform.device_record()
    assert rec["platform"] == "cpu"
    assert rec["count"] == len(jax.devices())
    assert rec["kind"] == jax.devices()[0].device_kind
    assert isinstance(rec["card"], str) and rec["card"]


def test_cache_dir_follows_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert platform.compilation_cache_dir() == tmp_path / "c"


def test_cache_dir_default_is_gitignored_repo_path(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = platform.compilation_cache_dir()
    assert path == ROOT / ".jax_cache"
    ignored = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


@pytest.mark.parametrize("env_set", [True, False])
def test_enable_cache_sets_a_dir_only_without_env(monkeypatch, tmp_path,
                                                  env_set):
    """With JAX_COMPILATION_CACHE_DIR set, JAX reads it itself and the
    program sets no other directory; without it, the fixed repo path."""
    calls = {}
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(platform, "REPO_ROOT", tmp_path)
    path = platform.enable_compilation_cache()
    if env_set:
        assert "jax_compilation_cache_dir" not in calls
        assert path == tmp_path
    else:
        assert calls["jax_compilation_cache_dir"] == str(
            tmp_path / ".jax_cache")
        assert (tmp_path / ".jax_cache").is_dir()


def test_dense_budget_on_host_and_on_device(monkeypatch):
    assert platform.dense_operand_budget() == platform.HOST_DENSE_BUDGET

    class Dev:
        def memory_stats(self):
            return {"bytes_limit": 100 * 2**30}

    monkeypatch.setattr(jax, "devices", lambda *a: [Dev()])
    assert platform.dense_operand_budget() == 25 * 2**30


def _run(args, cwd=ROOT):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_bench_refuses_without_gpu():
    r = _run(["bench.py"])
    assert r.returncode == 2
    assert "no GPU found" in r.stderr
    assert r.stdout == ""


def test_chip_smoke_refuses_without_gpu():
    r = _run(["chip_smoke.py"])
    assert r.returncode != 0
    assert "no GPU found" in r.stderr
    assert '"ok"' not in r.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    the script fails without printing a result."""
    (tmp_path / "chip_smoke.py").write_text(
        (ROOT / "chip_smoke.py").read_text())
    r = _run(["chip_smoke.py"], cwd=tmp_path)
    assert r.returncode != 0
    assert r.stdout == ""


@pytest.mark.gpu
def test_gpu_is_found_on_the_card(gpu_device):
    assert platform.require_gpu().platform == "gpu"
    rec = platform.device_record()
    assert rec["platform"] == "gpu" and rec["count"] >= 1
    json.dumps(rec)
