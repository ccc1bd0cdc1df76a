"""Activation quantization (Q8_1 semantics) as JAX ops.

The reference's GPU kernels re-quantize the activation tile to int8 inside
every kernel launch (absmax/127 per 32 elements + round-to-nearest-even,
/root/reference/kernels/mmq_q8_0.py:75-78). Here the quantization is
hoisted out of the matmul: activations are tiny next to the weights (N <= 32
rows in decode), and quantizing once lets every M tile reuse the result.

jnp.rint is round-half-to-even, the same contract as the reference's
magic-number `round_to_nearest_int` (mmq_q8_0.py:7-10) and GGML's
`nearest_int`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

BLOCK = 32


def quantize_q8_1_act(x: jax.Array):
    """(..., K) float -> (q: int8 (..., K), d: f32 (..., K/32), s: f32 (..., K/32)).

    d = absmax/127 per 32-block; s = d * sum(q) (the Q4_K min-term helper).
    All arithmetic runs in float32 with explicit fp16 rounding points
    (fp16_round: integer-op RNE, quant/layouts.py), which matches numpy's
    fp16 semantics (compute in f32, round back) bit for bit, so the emitted
    codes are identical to the Q8_1 codec (quant/q8_1.py). Neither float16
    jnp arithmetic nor astype(f16) round-trips survive jit: XLA contracts
    fused f16 chains at higher intermediate precision and elides lossy
    convert pairs, so the same expression quantizes differently eager vs
    jitted (codes shift by +-1 near .5 boundaries).
    """
    from ..quant.layouts import fp16_round as _f16

    *lead, k = x.shape
    g = _f16(x.astype(jnp.float32)).reshape(*lead, k // BLOCK, BLOCK)
    amax = jnp.max(jnp.abs(g), axis=-1)          # exact in f32 (f16 inputs)
    d = _f16(amax / 127.0)
    d_safe = jnp.where(d == 0.0, 1.0, d)
    q = jnp.clip(jnp.rint(_f16(g / d_safe[..., None])), -127, 127).astype(jnp.int8)
    sum_q = jnp.sum(q, axis=-1, dtype=jnp.int32).astype(jnp.float32)  # exact
    s = _f16(d * sum_q)
    return q.reshape(*lead, k), d, s


def fake_quantize_q8_1(x: jax.Array) -> jax.Array:
    """Round-trip x through Q8_1 (float in, float out). Feeding the MMQ
    ops fake-quantized activations reproduces the reference correctness
    contract (the CPU golden consumes pre-quantized Q8_1 activations,
    /root/reference/test/test_mmq_q4_k.py:31-34). XLA fuses the chain into
    one elementwise kernel."""
    *lead, k = x.shape
    q, d, _ = quantize_q8_1_act(x)
    g = q.reshape(*lead, k // BLOCK, BLOCK).astype(jnp.float32)
    return (g * d[..., None]).reshape(*lead, k)


def quantize_q8_1_codes(x: jax.Array):
    """Q8_1-quantize an activation, returning the CODES: (q: int8 (..., K),
    d: f32 (..., K/32), s: f32 (..., K/32) — the fp16-rounded d*sum(q)
    field), the operands an integer-dot MMQ consumes."""
    *lead, k = x.shape
    q, d, s = quantize_q8_1_act(x.reshape(-1, k))
    return (q.reshape(*lead, k), d.reshape(*lead, k // BLOCK),
            s.reshape(*lead, k // BLOCK))
