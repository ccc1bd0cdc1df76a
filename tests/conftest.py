"""Test configuration: force JAX onto a virtual 8-device CPU mesh.

The tests run on the CPU: sharding logic is validated on host-platform
virtual devices (the standard JAX pattern for testing N-device code without
a cluster), and the Pallas kernels run in interpret mode. The compiled
kernels are compared on the card by `python chip_smoke.py`. The platform is
pinned through jax.config after import as well as through JAX_PLATFORMS.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

# Persistent compilation cache: the suite is compile-bound on CPU (every
# test jits its own forward); warm re-runs skip straight to execution.
# Keyed by program hash + compiler version, so stale entries cannot match.
from gguf_tpu.utils.paths import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def toy_spm_metadata(vocab_size: int) -> dict:
    """Minimal SPM tokenizer metadata (3 specials + byte fallback +
    padding) shared by server/stress tests."""
    from gguf_tpu.models.loader import synthetic_spm_metadata

    return synthetic_spm_metadata(vocab_size)
