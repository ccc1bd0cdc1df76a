"""Device timing and identification for measurements on the accelerator.

Times come from the host clock around work that ends in
`block_until_ready` (JAX dispatches asynchronously, so a timing without it
measures the enqueue), after a warm-up call that compiles every shape the
timed calls use. `time_loop` runs many iterations inside one jitted
program, so that the host's per-call dispatch does not hide a short
operation. Every reported number names the device it ran on
(`device_info`), including the card's name and power limit as
`nvidia-smi` reports them: a card set below its maximum power runs slower
under load.
"""

from __future__ import annotations

import subprocess
import time

import numpy as np


def nvidia_smi_name_power() -> str:
    """The card's `name, power.limit` line from `nvidia-smi`, read by a child
    process that does not import JAX ("unavailable" where there is none)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return "unavailable"
    return out.strip().splitlines()[0] if out.strip() else "unavailable"


def device_info() -> dict:
    """Platform, device kind and count as JAX reports them, plus the card's
    name and power limit."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices()), "nvidia_smi": nvidia_smi_name_power()}


def time_call(fn, *args, iters: int = 20, warmup: int = 2) -> float:
    """Median seconds of `fn(*args)` over `iters` calls, each timed on the
    host clock up to `block_until_ready` of its result. The first `warmup`
    calls (compilation included) are not timed."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def device_kernel_time(fn, *args, trace_dir: str) -> tuple[float, dict]:
    """Profile one call of `fn(*args)` (already compiled and warmed up) and
    read the trace back: returns (seconds during which some kernel ran on
    the first GPU — the union of its stream events —, {kernel name: summed
    device seconds}). Fails where the trace holds no GPU stream."""
    import glob
    import os

    import jax
    from jax.profiler import ProfileData

    with jax.profiler.trace(trace_dir):
        jax.block_until_ready(fn(*args))
    path = max(glob.glob(os.path.join(trace_dir, "plugins", "profile", "*",
                                      "*.xplane.pb")), key=os.path.getmtime)
    planes = list(ProfileData.from_file(path).planes)
    plane = next((p for p in planes if p.name == "/device:GPU:0"), None)
    if plane is None:
        raise RuntimeError(f"no /device:GPU:0 plane in {path}: "
                           f"{[p.name for p in planes]}")
    spans, per_kernel = [], {}
    for line in plane.lines:
        if not line.name.startswith("Stream"):
            continue    # "XLA Modules"/"XLA Ops" summarize the same kernels
        for e in line.events:
            spans.append((e.start_ns, e.start_ns + e.duration_ns))
            per_kernel[e.name] = per_kernel.get(e.name, 0.0) \
                + e.duration_ns * 1e-9
    if not spans:
        raise RuntimeError(f"no GPU stream events in {path}: "
                           f"{[line.name for line in plane.lines]}")
    return busy_seconds(spans), per_kernel


def busy_seconds(spans) -> float:
    """Length of the union of (start_ns, end_ns) intervals, in seconds."""
    total, end = 0.0, float("-inf")
    for lo, hi in sorted(spans):
        if hi > end:
            total += hi - max(lo, end)
            end = hi
    return total * 1e-9


def time_loop(body, carry, iters: int = 20, reps: int = 5) -> float:
    """Median seconds per iteration of `carry = body(carry)`, run `iters`
    times unrolled inside one jitted program (a device loop would add a
    host round trip per iteration) and timed on the host clock up to
    `block_until_ready` (after one untimed warm-up call). The caller makes
    each iteration depend on the last and consume its full output, so that
    XLA can neither hoist nor slice the work."""
    import jax

    run = jax.jit(lambda c: jax.lax.fori_loop(
        0, iters, lambda i, c: body(c), c, unroll=True))
    jax.block_until_ready(run(carry))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(carry))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) / iters
