"""Reference-compatible kernel entry points.

The reference exposes `mmq_q8_0(A, B, M, N, K)` / `mmq_q4_k` / `mmq_q6_k`
taking raw GGUF weight bytes and (N, K) activations and returning
C = (A @ B.T).T of shape (N, M) (/root/reference/kernels/mmq_q8_0.py:102,
mmq_q4_k.py:240, mmq_q6_k.py:197). A user porting code from the reference
can keep that exact calling convention through this module; each call
transforms the bytes to the SoA device layout and dispatches to the MMQ
op.

For anything beyond a one-off call, transform once with
`quant.layouts.to_soa` and hold the `QuantTensor` — the byte->SoA transform
is host-side numpy and would otherwise run per call.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .ops import MMQ
from .quant.layouts import to_soa


def _mmq(fmt: str, a_bytes, b, m: int, n: int, k: int, **kw) -> jax.Array:
    w = to_soa(fmt, np.asarray(a_bytes), m, k)
    b = jnp.asarray(np.asarray(b, dtype=np.float32)).reshape(n, k)
    return MMQ[fmt](w, b, **kw)


def mmq_q8_0(a, b, m: int, n: int, k: int, **kw) -> jax.Array:
    """Q8_0 weight bytes (M rows x K cols) x float (N, K) -> (N, M)."""
    return _mmq("q8_0", a, b, m, n, k, **kw)


def mmq_q2_k(a, b, m: int, n: int, k: int, **kw) -> jax.Array:
    """Q2_K weight bytes x float (N, K) -> (N, M). K % 256 == 0."""
    return _mmq("q2_k", a, b, m, n, k, **kw)


def mmq_q3_k(a, b, m: int, n: int, k: int, **kw) -> jax.Array:
    """Q3_K weight bytes x float (N, K) -> (N, M). K % 256 == 0."""
    return _mmq("q3_k", a, b, m, n, k, **kw)


def mmq_q4_k(a, b, m: int, n: int, k: int, **kw) -> jax.Array:
    """Q4_K weight bytes x float (N, K) -> (N, M). K % 256 == 0."""
    return _mmq("q4_k", a, b, m, n, k, **kw)


def mmq_q5_k(a, b, m: int, n: int, k: int, **kw) -> jax.Array:
    """Q5_K weight bytes x float (N, K) -> (N, M). K % 256 == 0."""
    return _mmq("q5_k", a, b, m, n, k, **kw)


def mmq_q6_k(a, b, m: int, n: int, k: int, **kw) -> jax.Array:
    """Q6_K weight bytes x float (N, K) -> (N, M). K % 256 == 0."""
    return _mmq("q6_k", a, b, m, n, k, **kw)
