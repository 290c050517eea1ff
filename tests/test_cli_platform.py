"""Platform and compile-cache decisions (utils/backend.py), and the
removed Pallas backend: one function decides "on an accelerator", an
explicit `--platform gpu` with no GPU fails cleanly instead of falling
back to the CPU, and the cache directory follows
JAX_COMPILATION_CACHE_DIR or sits at <checkout>/.jax_cache."""

import os
import subprocess
import sys

import numpy as np
import pytest

from csv_simd_tpu import create_from_bytes
from csv_simd_tpu.index import build_index, stage1_words
from csv_simd_tpu.streaming import StreamingIndexBuilder
from csv_simd_tpu.utils import backend

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSV = b"sym,qty\nAAPL,3\nMSFT,5\n"


class _Dev:
    def __init__(self, platform):
        self.platform = platform


def test_on_accelerator_false_on_cpu():
    assert backend.on_accelerator() is False


@pytest.mark.parametrize("platform,want", [("gpu", True), ("cpu", False)])
def test_on_accelerator_reads_default_device(monkeypatch, platform, want):
    import jax

    monkeypatch.setattr(jax, "devices", lambda *a: [_Dev(platform)])
    assert backend.on_accelerator() is want


def _run_cli(tmp_path, args):
    f = tmp_path / "t.csv"
    f.write_bytes(CSV)
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    env["PYTHONPATH"] = REPO
    # a test process may hold the card already: allocate on demand
    env["XLA_PYTHON_CLIENT_PREALLOCATE"] = "false"
    return subprocess.run(
        [sys.executable, "-m", "csv_simd_tpu", *args, str(f)],
        capture_output=True, text=True, env=env, timeout=120, cwd=tmp_path,
    )


def test_cli_platform_gpu_fails_without_gpu(tmp_path):
    r = _run_cli(tmp_path, ["--platform", "gpu", "info"])
    assert r.returncode != 0
    assert "--platform gpu: no gpu device" in r.stderr
    assert "Traceback" not in r.stderr
    assert "data records" not in r.stdout


@pytest.mark.gpu
def test_cli_platform_gpu_runs_on_gpu(gpu, tmp_path):
    r = _run_cli(tmp_path, ["--platform", "gpu", "info"])
    assert r.returncode == 0, r.stderr
    assert "data records: 2" in r.stdout


def test_cli_platform_cpu_runs(tmp_path):
    r = _run_cli(tmp_path, ["--platform", "cpu", "info"])
    assert r.returncode == 0, r.stderr
    assert "data records: 2" in r.stdout


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    import jax

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert backend.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # untouched


def test_compile_cache_default_in_checkout(monkeypatch):
    import jax

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = backend.enable_compile_cache()
        assert got == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.parametrize("call", [
    lambda: build_index(CSV, backend="pallas"),
    lambda: create_from_bytes(CSV, backend="pallas"),
    lambda: stage1_words(CSV, backend="pallas"),
    lambda: StreamingIndexBuilder(backend="pallas").feed(CSV),
], ids=["build_index", "create_from_bytes", "stage1_words", "streaming"])
def test_pallas_backend_removed(call):
    with pytest.raises(ValueError, match="'pallas' was removed"):
        call()


def test_auto_backend_is_the_xla_scan():
    np.testing.assert_array_equal(
        build_index(CSV, backend="auto"), build_index(CSV, backend="jnp"))
