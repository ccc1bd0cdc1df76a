"""Bring-up surfaces: the compile-cache helper, the scripts that must
refuse to run without an accelerator, and (on a GPU host only) the
compiled kernels against their plain references."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from gguf_tpu.utils import paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_dir_honors_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert paths.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert paths.compile_cache_dir() == os.path.join(ROOT, ".jax_cache")


def test_enable_compile_cache_sets_no_other_dir(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper leaves JAX's own
    setting alone; without it, the fixed checkout path is configured."""
    import jax

    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", "untouched")
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert paths.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == "untouched"
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        assert paths.enable_compile_cache() == os.path.join(ROOT,
                                                            ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == os.path.join(
            ROOT, ".jax_cache")
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_generated_path_is_in_the_checkout():
    p = paths.generated_path("x.gguf")
    assert p == os.path.join(ROOT, ".generated", "x.gguf")
    assert os.path.isdir(os.path.dirname(p))


@pytest.mark.parametrize("spans,want_ns", [
    ([], 0),
    ([(0, 10)], 10),
    ([(0, 10), (5, 20)], 20),          # overlap counts once
    ([(30, 40), (0, 10)], 20),         # order does not matter
    ([(0, 100), (10, 20), (50, 60)], 100),   # nested
])
def test_busy_seconds_is_the_union(spans, want_ns):
    from gguf_tpu.utils.benchmark import busy_seconds

    assert busy_seconds(spans) == pytest.approx(want_ns * 1e-9)


def _run(args, cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(proc):
    lines = proc.stdout.strip().splitlines()
    return not lines or not lines[-1].startswith("{")


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_to_run_on_cpu(script):
    """No accelerator: exit non-zero and print no result."""
    proc = _run([script], ROOT)
    assert proc.returncode != 0
    assert _no_result(proc), proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """chip_smoke.py without the rest of the repository cannot pass."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], str(tmp_path))
    assert proc.returncode != 0
    assert _no_result(proc), proc.stdout


@pytest.fixture
def gpu_host():
    """Skips unless this host has an NVIDIA GPU (decided here, at test
    time, never while the module is imported)."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True,
                                     timeout=60).returncode != 0:
        pytest.skip("needs an NVIDIA GPU; the CPU runs the kernels in "
                    "interpret mode (test_mmq_triton.py)")


@pytest.mark.gpu
def test_compiled_kernels_on_gpu(gpu_host):
    """The compiled Triton kernels against their plain references at a few
    real shapes, in a child process that is free to use the GPU."""
    code = (
        "import chip_smoke as cs\n"
        "c = cs.Checks()\n"
        "cs.phase_kernels(c, shapes=[(2560, 2048), (4096, 4096)],"
        " widths=(1, 16), attn_cases=[(64, 16, 32, 4)], spans=(512,),"
        " other_shape=(512, 4096))\n"
        "print(json.dumps(c.failed))\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run([sys.executable, "-c", "import json\n" + code],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []
