"""Decode attention over the INT8 KV cache, in plain XLA.

The cache holds int8 K/V rows with one f32 scale per (token, kv head)
(models/llama.py:init_kv_cache). Three entry points:

* `kv_cache_insert` quantizes the step's new K/V rows (absmax/127 per
  (token, head)) and scatters them into the cache at pos..pos+t-1. Under
  jit with a donated cache XLA updates the buffers in place, so a step
  writes only its new rows. Rows outside [0, S) are dropped: finished
  continuous-batching slots (pos >= S) and rows owned by another
  sequence-parallel shard (local pos < 0) are both no-ops.
* `decode_attention` attends over the first `span` cache rows (every
  pos + t <= span). The cache scales fold into the scores and the
  probabilities, so K/V enter the dots as int8 codes and no dequantized
  copy of the cache is written. A flash-decoding Pallas kernel (Triton
  route) that read the int8 cache directly was measured against this form
  in the decode step on the H200 and did not beat it (PERF.md, "Kernel
  decisions"), so none is kept.
* `decode_attention_update` composes the two.

The causal mask follows the per-slot-position contract of
models/llama.py:attention: query token j of sequence b sits at
pos[b] + j and sees cache rows <= that position (and > it - window for
sliding-window layers).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


def quantize_kv(x: jax.Array):
    """(..., hd) -> int8 codes + per-row f32 scales (absmax/127)."""
    amax = jnp.max(jnp.abs(x), axis=-1)
    scale = (amax / 127.0).astype(jnp.float32)
    safe = jnp.where(scale == 0, 1.0, scale)
    q = jnp.clip(jnp.rint(x.astype(jnp.float32) / safe[..., None]), -127, 127)
    return q.astype(jnp.int8), scale


# ------------------------------------------------------------ cache insert ---


@functools.partial(jax.jit, static_argnames=("t",))
def kv_cache_insert(
    k_new: jax.Array,    # (B, KVH, t, hd) f32 — rope applied
    v_new: jax.Array,
    k: jax.Array,        # (B, KVH, S, hd) int8 cache
    k_scale: jax.Array,  # (B, KVH, S) f32
    v: jax.Array,
    v_scale: jax.Array,
    pos: jax.Array,      # (B,) int32 insert position per sequence
    *,
    t: int,
):
    """Quantize t new K/V rows per sequence to int8 and write them into the
    cache at pos..pos+t-1. Returns (k, k_scale, v, v_scale). Rows outside
    [0, S) are dropped."""
    b, kvh, s, hd = k.shape
    assert k_new.shape == (b, kvh, t, hd), (k_new.shape, (b, kvh, t, hd))
    rows = pos.astype(jnp.int32)[:, None] + jnp.arange(t, dtype=jnp.int32)
    rows = jnp.where((rows >= 0) & (rows < s), rows, s)   # s = dropped
    bi = jnp.arange(b)[:, None, None]
    hi = jnp.arange(kvh)[None, :, None]
    ri = rows[:, None, :]                                 # (B, 1, t)

    def put(cache, cache_scale, new):
        q, sc = quantize_kv(new)
        return (cache.at[bi, hi, ri].set(q, mode="drop"),
                cache_scale.at[bi, hi, ri].set(sc, mode="drop"))

    k, k_scale = put(k, k_scale, k_new)
    v, v_scale = put(v, v_scale, v_new)
    return k, k_scale, v, v_scale


# ------------------------------------------------------------- XLA form ---


def attention_xla(q, k, k_scale, v, v_scale, pos, *, precision, span,
                  window=0, softcap=0.0):
    """Plain XLA GQA attention over the span prefix of the int8 cache. The
    cache scales fold into the scores and the probabilities, so K/V enter
    the dots as int8 codes (exact in bf16). Returns (B, H, t, hd) f32."""
    b, h, t, hd = q.shape
    kvh = k.shape[1]
    g = h // kvh
    if precision == "fast":
        dt, prec = jnp.bfloat16, None
    else:
        dt, prec = jnp.float32, jax.lax.Precision.HIGHEST
    kq, ks = k[:, :, :span].astype(dt), k_scale[:, :, :span]
    vq, vs = v[:, :, :span].astype(dt), v_scale[:, :, :span]
    qg = q.reshape(b, kvh, g * t, hd).astype(dt)
    scores = jnp.einsum("bgqd,bgsd->bgqs", qg, kq, precision=prec,
                        preferred_element_type=jnp.float32)
    scores = scores * (ks[:, :, None, :] / jnp.sqrt(jnp.float32(hd)))
    if softcap:   # gemma2: cap * tanh(score / cap), pre-mask
        scores = softcap * jnp.tanh(scores / softcap)
    tok = pos[:, None] + (jnp.arange(g * t) % t)[None, :]      # (B, g*t)
    col = jnp.arange(span)
    live = col[None, None, :] <= tok[:, :, None]
    if window:    # sliding-window layers: keys older than window drop out
        live &= col[None, None, :] > tok[:, :, None] - window
    scores = jnp.where(live[:, None], scores, -jnp.inf)
    probs = jax.nn.softmax(scores, axis=-1) * vs[:, :, None, :]
    out = jnp.einsum("bgqs,bgsd->bgqd", probs.astype(dt), vq,
                     precision=prec, preferred_element_type=jnp.float32)
    return out.reshape(b, h, t, hd)


# ---------------------------------------------------------- entry points ---


def decode_attention(
    q: jax.Array,        # (B, H, t, hd) — rope already applied
    k: jax.Array,        # (B, KVH, S, hd) int8 cache
    k_scale: jax.Array,  # (B, KVH, S) f32
    v: jax.Array,
    v_scale: jax.Array,
    pos: jax.Array,      # (B,) int32 position of the first of the t tokens
    *,
    t: int,
    precision: str = "fast",
    span: int | None = None,
    window: int = 0,
    softcap: float = 0.0,
) -> jax.Array:
    """GQA decode attention; returns (B, H, t, hd) f32. The t new tokens'
    K/V must already be in the cache at pos..pos+t-1, and every pos + t
    must be <= span: only the first `span` cache rows are read.
    `window` > 0 restricts each query to its last `window` key positions;
    `softcap` > 0 applies cap*tanh(score/cap) before the mask
    (gemma2-family)."""
    assert q.shape[2] == t, (q.shape, t)
    s = k.shape[2]
    span = s if span is None else min(span, s)
    return _attention_xla_jit(q, k, k_scale, v, v_scale, pos,
                              precision=precision, span=span, window=window,
                              softcap=softcap)


_attention_xla_jit = jax.jit(
    attention_xla, static_argnames=("precision", "span", "window", "softcap"))


def decode_attention_tiled(q, k, k_scale, v, v_scale, pos, *,
                           precision: str = "fast", span: int | None = None,
                           window: int = 0, softcap: float = 0.0):
    """Single-token `decode_attention` (one form serves every span)."""
    return decode_attention(q, k, k_scale, v, v_scale, pos, t=1,
                            precision=precision, span=span, window=window,
                            softcap=softcap)


def decode_attention_update(
    q: jax.Array,        # (B, H, t, hd) — rope applied
    k_new: jax.Array,    # (B, KVH, t, hd) f32 — rope applied
    v_new: jax.Array,    # (B, KVH, t, hd) f32
    k: jax.Array,        # (B, KVH, S, hd) int8 cache
    k_scale: jax.Array,  # (B, KVH, S) f32
    v: jax.Array,
    v_scale: jax.Array,
    pos: jax.Array,      # (B,) int32
    *,
    t: int,
    precision: str = "fast",
    span: int | None = None,
    window: int = 0,
    softcap: float = 0.0,
):
    """Cache insert + decode attention over the updated cache. Returns
    (out (B, H, t, hd) f32, k, k_scale, v, v_scale)."""
    k, k_scale, v, v_scale = kv_cache_insert(
        k_new, v_new, k, k_scale, v, v_scale, pos, t=t)
    out = decode_attention(q, k, k_scale, v, v_scale, pos, t=t,
                           precision=precision, span=span, window=window,
                           softcap=softcap)
    return out, k, k_scale, v, v_scale
