"""Multi-process bootstrap: jax.distributed + a health check.

One process can drive all the cards of a host (NVLink joins them all to
all). Several processes — several hosts, or one process per card — join
through `jax.distributed.initialize`, after which `jax.devices()` spans
every card and the pjit/shard_map code in parallel/tp.py runs unchanged;
XLA hands the psum/all-gather collectives to NCCL.

Usage (same program in every process):

    from gguf_tpu.parallel import init_distributed, make_mesh
    init_distributed("localhost:12345", num_processes=2, process_id=rank)
    mesh = make_mesh(tp=jax.device_count())  # or tp x dp of your choice

Nothing in the environment names a cluster here: pass
coordinator_address/num_processes/process_id explicitly (or set
COORDINATOR_ADDRESS); called without them this is a single-process no-op.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     health_check: bool = True,
                     initialization_timeout: int = 300) -> dict:
    """Initialize the multi-process runtime and (optionally) run a
    health check over every device. Returns a summary dict. Safe to call
    single-process (no-op when no coordinator is given).

    initialization_timeout bounds how long ranks wait for missing peers at
    bring-up (passed through to jax.distributed.initialize); a dead host is
    a RuntimeError here, not an indefinite hang at the first collective."""
    # env check first: jax.process_count() would initialize the XLA backend
    # and make jax.distributed.initialize() unusable afterwards
    import os

    coordinator_address = (coordinator_address
                           or os.environ.get("COORDINATOR_ADDRESS"))
    if coordinator_address or num_processes:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            initialization_timeout=initialization_timeout)

    info = {
        "process_id": jax.process_index(),
        "num_processes": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
        "platform": jax.devices()[0].platform,
    }
    if health_check and info["global_devices"] > 1:
        info["psum_ok"] = _psum_health_check()
    return info


def _psum_health_check() -> bool:
    """One tiny psum across every device: catches a dead link or wedged
    process before a model load is attempted. The input is built
    per-process from process-local data (a plain host array cannot be fed
    to a mesh containing other processes' non-addressable devices)."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    devs = np.asarray(jax.devices())
    mesh = Mesh(devs, ("all",))

    def f(x):
        return jax.lax.psum(x, "all")

    sharding = NamedSharding(mesh, P("all"))
    if jax.process_count() > 1:
        x = jax.make_array_from_process_local_data(
            sharding, np.ones(len(jax.local_devices()), np.int32),
            (len(devs),))
    else:
        x = jax.device_put(jnp.ones(len(devs), jnp.int32), sharding)
    got = jax.jit(jax.shard_map(f, mesh=mesh, in_specs=P("all"),
                                out_specs=P()))(x)
    return int(np.asarray(got)[0]) == len(devs)
