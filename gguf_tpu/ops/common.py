"""Shared helpers for the compute ops and their Pallas kernels."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

__all__ = [
    "running_interpreted", "on_gpu", "pad_rows", "pad_cols", "round_up",
    "next_pow2",
]


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def next_pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


@functools.cache
def _platform() -> str:
    return jax.devices()[0].platform


def running_interpreted() -> bool:
    """Pallas kernels compile for the GPU (Triton route); on a CPU backend
    (the test suite, virtual meshes) they run in interpret mode."""
    return _platform() == "cpu"


def on_gpu() -> bool:
    """True when the default backend is a GPU: the hand-written kernels are
    dispatched only there (the CPU takes the plain XLA forms, and the
    kernels are tested directly in interpret mode)."""
    return _platform() == "gpu"


def pad_rows(a: jax.Array, rows: int) -> jax.Array:
    """Zero-pad axis 0 of `a` up to `rows`."""
    if a.shape[0] == rows:
        return a
    pad = [(0, rows - a.shape[0])] + [(0, 0)] * (a.ndim - 1)
    return jnp.pad(a, pad)


def pad_cols(a: jax.Array, cols: int) -> jax.Array:
    """Zero-pad the last axis of `a` up to `cols`."""
    if a.shape[-1] == cols:
        return a
    pad = [(0, 0)] * (a.ndim - 1) + [(0, cols - a.shape[-1])]
    return jnp.pad(a, pad)
