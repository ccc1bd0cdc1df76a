"""Llama-family decoder built on the MMQ ops.

The reference stops at single GEMM kernels (SURVEY.md §0: "no model, no
serving loop, no KV cache"); this module is the end-to-end consumer the
north star requires: RMSNorm -> GQA attention with RoPE and an INT8 KV
cache -> SwiGLU, with every linear layer running the MMQ op (a fused
dequant+matmul kernel or dequantize-then-dot) on GGUF-quantized weights.

Everything is functional and pytree-based: `forward(params, cfg, tokens,
pos, cache)` jits, shards (parallel/), and differentiates like any JAX
program. Weights may be QuantTensors (quantized, SoA device layout) or plain
float arrays — `linear()` dispatches.

RoPE follows llama.cpp's per-architecture convention: llama/mistral GGUFs
carry Q/K permuted for consecutive-pair rotation (ROPE_TYPE_NORM), while
qwen/gemma/phi-family GGUFs keep the HF dimension order and rotate
half-vs-half (ROPE_TYPE_NEOX) — cfg.rope_neox selects, so loading any
family's GGUF reproduces llama.cpp logits.
"""

from __future__ import annotations

import functools
import math
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp

from ..ops import MMQ
from ..ops.attention import (decode_attention_update, kv_cache_insert,
                             quantize_kv as _quantize_kv)
from ..quant.layouts import QuantTensor
from .config import LlamaConfig


class MMOpts(NamedTuple):
    """Static knobs threaded to every MMQ call. `axis_name` names the
    tensor-parallel mesh axis when the forward runs inside shard_map: the
    attention/MLP output projections are row-parallel (input dim sharded)
    and psum their partial results over it, and the LM head all-gathers its
    vocab shard."""
    precision: str = "fast"
    act_quant: bool = False
    axis_name: str | None = None
    # context parallelism: mesh axis the KV cache's sequence dim is sharded
    # over (contiguous shards). attention() then inserts only shard-owned
    # rows and combines per-shard flash partials with a log-sum-exp psum.
    seq_axis: str | None = None
    # expert parallelism: mesh axis the MoE expert stacks' leading E dim is
    # sharded over. moe_mlp() evaluates only the shard-local experts and the
    # weighted partial outputs join in one psum (folded into the tp psum).
    ep_axis: str | None = None


def linear(w, x: jax.Array, opts: MMOpts = MMOpts()) -> jax.Array:
    """y = x @ W^T for W (out, in): the MMQ op for QuantTensors (which
    picks the fused kernel or dequantize-then-dot by format and width),
    a plain dot for float weights."""
    if isinstance(w, QuantTensor):
        return MMQ[w.fmt](
            w, x, act_quant=opts.act_quant, precision=opts.precision,
        ).astype(x.dtype)
    if opts.precision == "high":   # f32 operands, no TF32 on the GPU
        return jax.lax.dot_general(
            x.astype(jnp.float32), w.astype(jnp.float32),
            (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST).astype(x.dtype)
    return jax.lax.dot_general(
        x, w.astype(x.dtype), (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    ).astype(x.dtype)


def embed(table, ids: jax.Array) -> jax.Array:
    """Token embedding lookup; dequantizes just the selected rows."""
    flat = ids.reshape(-1)
    if isinstance(table, QuantTensor):
        out = table.take_rows(flat).dequantize()
    else:
        out = table[flat].astype(jnp.float32)
    return out.reshape(*ids.shape, -1)


def layer_norm(x: jax.Array, weight: jax.Array, bias, eps: float) -> jax.Array:
    """Mean-subtracting LayerNorm with optional bias (phi2-family)."""
    xf = x.astype(jnp.float32)
    mu = jnp.mean(xf, axis=-1, keepdims=True)
    xc = xf - mu
    var = jnp.mean(xc * xc, axis=-1, keepdims=True)
    out = xc * jax.lax.rsqrt(var + eps) * weight
    if bias is not None:
        out = out + bias
    return out.astype(x.dtype)


def _rms_norm_global(x: jax.Array, weight: jax.Array, eps: float,
                     axis_name) -> jax.Array:
    """RMSNorm whose mean square spans the tp shards of the last axis
    (olmo2's whole-q/k-vector norms, where heads and the norm weight are
    column-sharded). axis_name None = plain rms_norm."""
    xf = x.astype(jnp.float32)
    ss = jnp.sum(xf * xf, axis=-1, keepdims=True)
    n = x.shape[-1]
    if axis_name:
        ss = jax.lax.psum(ss, axis_name)
        n = n * jax.lax.psum(1, axis_name)
    return (xf * jax.lax.rsqrt(ss / n + eps) * weight).astype(x.dtype)


def _norm(x, layer_or_params, name: str, cfg: LlamaConfig) -> jax.Array:
    """Dispatch rms/layer norm for the weight at `name` (+ optional
    `name`_bias) in a layer or params dict. A missing weight passes x
    through — olmo2 is post-norm-only (no attn_norm/ffn_norm tensors;
    its post_attention_norm/post_ffw_norm are applied by the caller)."""
    w = layer_or_params.get(name)
    if w is None:
        return x
    if cfg.norm_type == "layer":
        return layer_norm(x, w, layer_or_params.get(name + "_bias"),
                          cfg.norm_eps)
    return rms_norm(x, w, cfg.norm_eps)


def rms_norm(x: jax.Array, weight: jax.Array, eps: float) -> jax.Array:
    # gemma's (1 + w) convention needs no switch here: llama.cpp's GGUF
    # converter bakes the +1 into the stored norm weights at convert time.
    xf = x.astype(jnp.float32)
    var = jnp.mean(xf * xf, axis=-1, keepdims=True)
    return (xf * jax.lax.rsqrt(var + eps) * weight).astype(x.dtype)


def yarn_corr_dims(head_dim: int, orig_ctx: int, theta: float,
                   beta_fast: float = 32.0, beta_slow: float = 1.0):
    """YaRN NTK-by-parts correction range: the (fractional) dimension
    indices whose rotary wavelength crosses beta_fast / beta_slow turns of
    the original context (the llama.cpp ggml_rope_yarn_corr_dims contract).
    Dims below `low` rotate fast (many full turns in orig_ctx: safe to
    extrapolate); dims above `high` rotate slow (must be interpolated)."""

    def corr(n_rot):
        return (head_dim * math.log(orig_ctx / (n_rot * 2 * math.pi))
                / (2 * math.log(theta)))

    low = max(0.0, math.floor(corr(beta_fast)))
    high = min(head_dim - 1.0, math.ceil(corr(beta_slow)))
    return low, high


def rope_cos_sin(positions: jax.Array, head_dim: int, theta: float,
                 scale: float = 1.0, *, kind: str = "linear",
                 orig_ctx: int = 0, attn_factor: float = 1.0,
                 freq_factors: tuple | None = None):
    """(..., ) int positions -> cos/sin of shape (..., head_dim/2), f32.

    kind "linear"/"none": `scale` > 1 is linear position interpolation
    (GGUF rope.scaling.factor for linearly rope-scaled checkpoints).
    kind "yarn": NTK-by-parts — per-dimension mix of interpolated
    (angle/scale) and extrapolated (unchanged) angles over the
    yarn_corr_dims ramp, times the sqrt-attention-magnitude factor
    mscale = attn_factor * (1 + 0.1*ln(scale)) baked into cos/sin
    (llama.cpp rope_yarn with ext_factor=1).
    `freq_factors` (head_dim/2 floats): per-dimension frequency divisors
    from a rope_freqs.weight tensor (llama-3.1-style GGUFs); composes with
    either kind."""
    freqs = theta ** (-jnp.arange(0, head_dim, 2, dtype=jnp.float32) / head_dim)
    if freq_factors is not None:
        freqs = freqs / jnp.asarray(freq_factors, jnp.float32)
    pos = positions.astype(jnp.float32)
    if kind == "longrope":
        # phi3 LongRoPE: the per-dim factors carry ALL the position
        # scaling; the converter's precomputed attention-magnitude factor
        # (sqrt(1 + ln(s)/ln(orig))) rides on cos/sin like yarn's mscale
        angles = pos[..., None] * freqs
        m = jnp.float32(attn_factor)
        return jnp.cos(angles) * m, jnp.sin(angles) * m
    if kind != "yarn":
        angles = (pos / scale)[..., None] * freqs
        return jnp.cos(angles), jnp.sin(angles)

    extrap = pos[..., None] * freqs
    interp = extrap / scale
    low, high = yarn_corr_dims(head_dim, orig_ctx, theta)
    i_half = jnp.arange(head_dim // 2, dtype=jnp.float32)
    ramp = 1.0 - jnp.clip((i_half - low) / max(1e-3, high - low), 0.0, 1.0)
    angles = interp * (1.0 - ramp) + extrap * ramp
    mscale = jnp.float32(attn_factor * (1.0 + 0.1 * math.log(scale)))
    return jnp.cos(angles) * mscale, jnp.sin(angles) * mscale


def rope_for_cfg(positions: jax.Array, cfg, theta: float | None = None):
    """cos/sin for a model config — dispatches linear/yarn/longrope
    scaling and threads the optional per-dim frequency factors.

    `theta` (gemma3's sliding layers at rope_theta_swa) switches to a
    PLAIN rotation at that base: llama.cpp gives SWA layers
    freq_scale_train_swa = 1 and no factors, so the global layers' rope
    scaling (gemma3 ships linear factor 8) must not leak onto them."""
    rd = cfg.rope_dim or cfg.head_dim
    if theta is not None:
        return rope_cos_sin(positions, rd, theta)
    attn_factor = cfg.rope_attn_factor
    if cfg.rope_yarn_log_mul and cfg.rope_scaling_kind == "yarn":
        # DeepSeek yarn convention: cos/sin carry NO magnitude factor —
        # the whole mscale^2 rides on the attention score scale instead
        # (mla_attention). Cancel rope_cos_sin's internal
        # mscale = attn_factor * (1 + 0.1 ln s), llama.cpp's
        # attn_factor_scaled trick in build_deepseek2.
        attn_factor = 1.0 / (1.0 + 0.1 * math.log(cfg.rope_scale))
    return rope_cos_sin(
        positions, rd, cfg.rope_theta, cfg.rope_scale,
        kind=cfg.rope_scaling_kind, orig_ctx=cfg.rope_orig_ctx or cfg.max_seq_len,
        attn_factor=attn_factor, freq_factors=cfg.rope_freq_factors)


@functools.lru_cache(maxsize=8)
def _rope_swap_matrix_np(hd: int, neox: bool):
    """(hd, hd) +-1/0 numpy matrix P with (x @ P)[j] = the signed partner
    value the rotation needs: -x[j+1]/+x[j-1] for NORM pairs,
    -x[j+h]/+x[j-h] for NEOX rotate-half. Cached as NUMPY — a cached jnp
    constant would leak tracers across jit scopes."""
    import numpy as np

    p = np.zeros((hd, hd), np.float32)
    if neox:
        h = hd // 2
        p[np.arange(h) + h, np.arange(h)] = -1.0
        p[np.arange(h), np.arange(h) + h] = 1.0
    else:
        ev = np.arange(0, hd, 2)
        p[ev + 1, ev] = -1.0
        p[ev, ev + 1] = 1.0
    return p


def _rope_swap_matrix(hd: int, neox: bool):
    return jnp.asarray(_rope_swap_matrix_np(hd, neox))


def apply_rope(x: jax.Array, cos: jax.Array, sin: jax.Array,
               neox: bool = False) -> jax.Array:
    """Rotary embedding. x: (..., H, head_dim), cos/sin broadcastable to
    (..., 1, head_dim/2).

    neox=False: consecutive-pair rotation (llama.cpp ROPE_TYPE_NORM) —
    dim pair (2j, 2j+1) rotates by angle j. The llama-family contract:
    their GGUF converters permute q/k rows into this order.
    neox=True: rotate-half (ROPE_TYPE_NEOX) — dims (j, j+hd/2) rotate by
    angle j, the unpermuted HF order that qwen/gemma/phi GGUFs keep.

    The signed partner value comes from ONE tiny exact matmul against a
    +-1 permutation matrix (HIGHEST precision: each output is a single
    exact product) and cos/sin are expanded to head_dim on their (tiny)
    side: out = x*cos2 + (x @ P)*sin2 — the same products and sums as the
    textbook even/odd form without its lane deinterleave. On the H200
    this form has not been measured against the plain one."""
    xf = x.astype(jnp.float32)
    hd = xf.shape[-1]
    if neox:
        cos2 = jnp.concatenate([cos, cos], axis=-1)
        sin2 = jnp.concatenate([sin, sin], axis=-1)
    else:
        # interleave on the SMALL cos/sin side: (..., hd/2) -> (..., hd)
        cos2 = jnp.stack([cos, cos], axis=-1).reshape(*cos.shape[:-1], hd)
        sin2 = jnp.stack([sin, sin], axis=-1).reshape(*sin.shape[:-1], hd)
    partner = jax.lax.dot_general(
        xf, _rope_swap_matrix(hd, neox), (((xf.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST)
    return (xf * cos2 + partner * sin2).astype(x.dtype)


# --------------------------------------------------------- INT8 KV cache ---


def init_kv_cache(cfg: LlamaConfig, batch: int, max_seq: int | None = None):
    """Per-layer INT8 K/V caches with per-(token, head) f32 scales —
    8x smaller than an f32 cache, 2x smaller than bf16. A LIST of per-layer
    dicts, not one stacked array: stacking would force a slice of the whole
    cache into every layer and a re-stack every step (~2x the cache bytes of
    pure copy traffic per decode step at 22 layers)."""
    if cfg.ssm_inner:   # mamba: recurrent state, not KV rows
        from .ssm import init_ssm_cache

        return init_ssm_cache(cfg, batch)
    s = max_seq or cfg.max_seq_len
    # MLA (deepseek2): one shared latent+rope row per token (kvh=1)
    shape = (batch, cfg.kv_cache_heads, s, cfg.kv_cache_dim)
    return [{
        "k": jnp.zeros(shape, jnp.int8),
        "v": jnp.zeros(shape, jnp.int8),
        "k_scale": jnp.zeros(shape[:-1], jnp.float32),
        "v_scale": jnp.zeros(shape[:-1], jnp.float32),
    } for _ in range(cfg.n_layers)]


def _attend(cache_l, q, k_new, v_new, pos, opts: MMOpts, span, window=0,
            softcap=0.0):
    """Insert the T new K/V rows (B, KVH, T, hd) into the int8 cache and
    attend q (B, H, T, hd) over its first `span` rows
    (ops/attention.py). Returns (out (B, H, T, hd) f32, cache_l)."""
    t = q.shape[2]
    out, ck, cks, cv, cvs = decode_attention_update(
        q, k_new.astype(jnp.float32), v_new.astype(jnp.float32),
        cache_l["k"], cache_l["k_scale"], cache_l["v"], cache_l["v_scale"],
        pos, t=t, precision=opts.precision, span=span, window=window,
        softcap=softcap)
    return out, {"k": ck, "k_scale": cks, "v": cv, "v_scale": cvs}


def _unit_rope_cos_sin(positions: jax.Array, cfg):
    """cos/sin with NO magnitude factor (pure rotation) for relative
    re-rotation: yarn/longrope bake an mscale into rope_for_cfg's
    output, which must not apply twice when rotating existing keys."""
    attn_factor = 1.0
    if cfg.rope_scaling_kind == "yarn":
        # cancel rope_cos_sin's internal mscale = af * (1 + 0.1 ln s)
        attn_factor = 1.0 / (1.0 + 0.1 * math.log(cfg.rope_scale)) \
            if cfg.rope_scale > 0 else 1.0
    return rope_cos_sin(
        positions, cfg.rope_dim or cfg.head_dim, cfg.rope_theta,
        cfg.rope_scale, kind=cfg.rope_scaling_kind,
        orig_ctx=cfg.rope_orig_ctx or cfg.max_seq_len,
        attn_factor=attn_factor, freq_factors=cfg.rope_freq_factors)


def shift_kv_cache(cache: list, cfg: LlamaConfig, slot, keep, drop) -> list:
    """Context shift (llama.cpp --ctx-shift): drop `drop` cache rows
    starting at row `keep` in one slot; every later row moves down by
    `drop`, and moved K rows are re-rotated by -drop positions. Rope is
    a pure per-dimension rotation linear in position — for every
    scaling scheme K(p-d) = R(-d)·K(p), the magnitude factors cancel —
    so shifted keys are exactly what a fresh prefill at the new
    positions would produce, modulo one extra int8 requant round trip
    on the moved K rows (V moves bit-exactly).

    slot/keep/drop are dynamic scalars; the row remap is a clip-mode
    take, so ONE compiled program serves every shift geometry."""
    keep = jnp.asarray(keep, jnp.int32)
    drop = jnp.asarray(drop, jnp.int32)
    out = []
    hd = cfg.head_dim
    rd = cfg.rope_dim or hd
    for cl in cache:
        S = cl["k"].shape[2]
        ar = jnp.arange(S)
        idx = jnp.minimum(jnp.where(ar < keep, ar, ar + drop), S - 1)
        moved = ar >= keep                                # rows that slid
        delta = jnp.where(moved, -drop, 0).astype(jnp.float32)
        cos, sin = _unit_rope_cos_sin(delta, cfg)         # (S, rd/2)

        ksl = jnp.take(cl["k"][slot], idx, axis=1)        # (H, S, hd)
        ks = jnp.take(cl["k_scale"][slot], idx, axis=1)   # (H, S)
        kf = ksl.astype(jnp.float32) * ks[..., None]
        rot = apply_rope(kf[..., :rd], cos[None], sin[None], cfg.rope_neox)
        kf = jnp.concatenate([rot, kf[..., rd:]], -1) if rd < hd else rot
        kq, kqs = _quantize_kv(kf)

        out.append({
            "k": cl["k"].at[slot].set(kq),
            "k_scale": cl["k_scale"].at[slot].set(kqs),
            "v": cl["v"].at[slot].set(jnp.take(cl["v"][slot], idx, axis=1)),
            "v_scale": cl["v_scale"].at[slot].set(
                jnp.take(cl["v_scale"][slot], idx, axis=1)),
        })
    return out


# ----------------------------------------------------------- transformer ---


def attention(layer, x, cfg: LlamaConfig, cache_l, pos, opts: MMOpts,
              rope=None, span: int | None = None, window: int = 0,
              return_pre_proj: bool = False):
    """GQA attention over the INT8 cache. x: (B, T, dim); pos: (B,) start
    positions of the T new tokens per sequence; rope: optional precomputed
    (cos, sin) shared across layers (forward() hoists it out of the layer
    loop — the trig is position-only); span: static bound on how many cache
    rows are live (every pos + T <= span) — attention reads only that
    prefix, so HBM traffic scales with actual sequence depth instead of
    cache capacity; window > 0 (static) restricts each query to the last
    `window` key positions (gemma2-family sliding-window layers)."""
    b, t, _ = x.shape
    hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    xf = x.reshape(b * t, -1)

    if "wqkv" in layer:  # fused projection (see fuse_llama_params)
        qkv = linear(layer["wqkv"], xf, opts)
        if "bqkv" in layer:  # fused QKV bias (qwen2-family)
            qkv = qkv + layer["bqkv"].astype(qkv.dtype)
        q = qkv[:, :h * hd].reshape(b, t, h, hd)
        k = qkv[:, h * hd:(h + kvh) * hd].reshape(b, t, kvh, hd)
        v = qkv[:, (h + kvh) * hd:].reshape(b, t, kvh, hd)
    else:
        q = linear(layer["wq"], xf, opts)
        k = linear(layer["wk"], xf, opts)
        v = linear(layer["wv"], xf, opts)
        if "bq" in layer:  # per-projection biases (qwen2-family)
            q = q + layer["bq"].astype(q.dtype)
            k = k + layer["bk"].astype(k.dtype)
            v = v + layer["bv"].astype(v.dtype)
        q = q.reshape(b, t, h, hd)
        k = k.reshape(b, t, kvh, hd)
        v = v.reshape(b, t, kvh, hd)

    if "q_norm" in layer:   # qwen3-family: per-head RMSNorm on q/k, pre-RoPE
        q = rms_norm(q, layer["q_norm"], cfg.norm_eps)
        k = rms_norm(k, layer["k_norm"], cfg.norm_eps)
    elif "q_norm_full" in layer:
        # olmo2: RMSNorm over the WHOLE q/k projection vector (h*hd,) —
        # the denominator spans all heads, so under tp (heads + norm
        # weight column-sharded) the mean square needs a psum
        q = _rms_norm_global(q.reshape(b, t, -1), layer["q_norm_full"],
                             cfg.norm_eps, opts.axis_name
                             ).reshape(b, t, h, hd)
        k = _rms_norm_global(k.reshape(b, t, -1), layer["k_norm_full"],
                             cfg.norm_eps, opts.axis_name
                             ).reshape(b, t, kvh, hd)

    if cfg.attn_scale:
        # granite attention.scale replaces the attention path's baked-in
        # 1/sqrt(head_dim) score scale: pre-multiply q by the ratio
        q = q * jnp.float32(cfg.attn_scale * float(hd) ** 0.5).astype(q.dtype)

    tok_pos = pos[:, None] + jnp.arange(t)[None, :]            # (B, T)
    rd = cfg.rope_dim or hd
    cos, sin = rope if rope is not None else rope_for_cfg(
        tok_pos, cfg,
        theta=cfg.rope_theta_swa if (window and cfg.rope_theta_swa) else None)
    # (B, T, rd/2)
    if cfg.learned_pos:   # gpt2: absolute positions already in the embeds
        pass
    elif rd < hd:   # partial rotary (phi2): rotate the leading rd dims only
        q = jnp.concatenate([apply_rope(q[..., :rd], cos[:, :, None, :],
                                        sin[:, :, None, :], cfg.rope_neox),
                             q[..., rd:]], -1)
        k = jnp.concatenate([apply_rope(k[..., :rd], cos[:, :, None, :],
                                        sin[:, :, None, :], cfg.rope_neox),
                             k[..., rd:]], -1)
    else:
        q = apply_rope(q, cos[:, :, None, :], sin[:, :, None, :],
                       cfg.rope_neox)
        k = apply_rope(k, cos[:, :, None, :], sin[:, :, None, :],
                       cfg.rope_neox)

    if opts.seq_axis:
        assert not return_pre_proj, "imatrix collection is single-chip"
        return _cp_attention(layer, x, cfg, cache_l, q, k, v, tok_pos, pos,
                             opts, window=window)

    out, cache_l = _attend(
        cache_l, q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
        v.transpose(0, 2, 1, 3), pos, opts, span, window=window,
        softcap=cfg.attn_softcap)
    out = out.transpose(0, 2, 1, 3).reshape(b * t, h * hd)
    proj = linear(layer["wo"], out.astype(x.dtype), opts)
    if opts.axis_name:  # row-parallel wo: sum partial products over tp
        proj = jax.lax.psum(proj, opts.axis_name)
    if "bo" in layer:   # phi2-family output-projection bias
        proj = proj + layer["bo"].astype(proj.dtype)
    if return_pre_proj:  # imatrix collection: attn_output's input
        return proj.reshape(b, t, -1), cache_l, out.reshape(b, t, -1)
    return proj.reshape(b, t, -1), cache_l


def mla_attention(layer, x, cfg: LlamaConfig, cache_l, pos, opts: MMOpts,
                  rope=None, span: int | None = None,
                  return_pre_proj: bool = False):
    """DeepSeek-V2 multi-head latent attention, ABSORBED form. The KV
    cache stores ONE row per token — [compressed latent c_kv
    (kv_lora_rank) | shared rope key (qk_rope)], zero-padded to a
    128-multiple row — instead of per-head K/V: the
    attn_kv_b up-projection's K half is folded into the query
    (q_eff = q_nope @ W_uk, per head) and its V half applied after the
    probability-weighted latent sum. Attention itself is then plain MQA
    with head_dim = kv_lora_rank + qk_rope over the EXISTING int8 cache
    ops; scores are equivalent to naive MLA because
    (W_uk q)·c == q·(W_uk^T c). Cache bytes drop ~9x vs naive MLA
    (DeepSeek-V2-Lite: 576 vs 16 heads x 320).
    Reference lineage: llama.cpp build_deepseek2 / LLM_ARCH_DEEPSEEK2."""
    b, t, _ = x.shape
    h = cfg.n_heads
    nope, rdim, r = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
    hd_c = cfg.kv_cache_dim
    xf = x.reshape(b * t, -1)

    if "wq_a" in layer:   # low-rank query path (V2/V3)
        qa = rms_norm(linear(layer["wq_a"], xf, opts).astype(jnp.float32),
                      layer["q_a_norm"], cfg.norm_eps)
        q = linear(layer["wq_b"], qa.astype(x.dtype), opts)
    else:                 # V2-Lite: direct q projection
        q = linear(layer["wq"], xf, opts)
    q = q.reshape(b, t, h, nope + rdim)
    q_nope, q_pe = q[..., :nope], q[..., nope:]

    kv = linear(layer["wkv_a"], xf, opts).reshape(b, t, r + rdim)
    c_kv = rms_norm(kv[..., :r].astype(jnp.float32), layer["kv_a_norm"],
                    cfg.norm_eps)
    k_pe = kv[..., None, r:]                     # (B, T, 1, rdim) MQA key

    tok_pos = pos[:, None] + jnp.arange(t)[None, :]
    cos, sin = rope if rope is not None else rope_for_cfg(tok_pos, cfg)
    q_pe = apply_rope(q_pe, cos[:, :, None, :], sin[:, :, None, :],
                      cfg.rope_neox)
    k_pe = apply_rope(k_pe.astype(jnp.float32), cos[:, :, None, :],
                      sin[:, :, None, :], cfg.rope_neox)

    # absorb W_uk into the query; pad to the tiled cache row. Attention
    # scale scores by 1/sqrt(row width), so fold in sqrt(hd_c / qk_dim)
    # to recover the true 1/sqrt(qk_nope + qk_rope).
    q_eff = jnp.einsum("bthd,hdr->bthr", q_nope.astype(jnp.float32),
                       layer["w_uk"].astype(jnp.float32))
    pad = hd_c - r - rdim
    qs = float(hd_c) ** 0.5 / float(nope + rdim) ** 0.5
    if cfg.rope_yarn_log_mul and cfg.rope_scaling_kind == "yarn":
        # DeepSeek yarn: score scale gains mscale^2 with
        # mscale = 1 + yarn_log_mul * ln(factor) (llama.cpp kq_scale)
        mscale = 1.0 + cfg.rope_yarn_log_mul * math.log(cfg.rope_scale)
        qs *= mscale * mscale
    q_full = jnp.concatenate(
        [q_eff, q_pe.astype(jnp.float32),
         jnp.zeros((b, t, h, pad), jnp.float32)], -1) * qs
    k_row = jnp.concatenate(
        [c_kv[:, :, None, :], k_pe,
         jnp.zeros((b, t, 1, pad), jnp.float32)], -1)
    v_row = jnp.concatenate(
        [c_kv[:, :, None, :], jnp.zeros((b, t, 1, rdim + pad),
                                        jnp.float32)], -1)

    # one kv head of width hd_c: plain MQA over the int8 cache
    out, cache_l = _attend(
        cache_l, q_full.transpose(0, 2, 1, 3), k_row.transpose(0, 2, 1, 3),
        v_row.transpose(0, 2, 1, 3), pos, opts, span)
    out_lat = out.transpose(0, 2, 1, 3)          # (B, T, H, hd_c)

    # output path: W_uv maps the attended latent back to per-head values
    out = jnp.einsum("bthr,hvr->bthv", out_lat[..., :r],
                     layer["w_uv"].astype(jnp.float32))
    out = out.reshape(b * t, h * cfg.v_head_dim)
    proj = linear(layer["wo"], out.astype(x.dtype), opts)
    if opts.axis_name:
        proj = jax.lax.psum(proj, opts.axis_name)
    if return_pre_proj:
        return proj.reshape(b, t, -1), cache_l, out.reshape(b, t, -1)
    return proj.reshape(b, t, -1), cache_l


def _cp_attention(layer, x, cfg: LlamaConfig, cache_l, q, k, v, tok_pos,
                  pos, opts: MMOpts, window: int = 0):
    """Sequence-parallel (context-parallel) attention: the cache's sequence
    dim is sharded contiguously over mesh axis `opts.seq_axis`, so each
    device holds S/sp rows of every sequence and the full query.
    Per-shard flash partials (max, sum-exp, unnormalized output) are
    joined by one pmax + two psums — the collective payload is
    O(B·H·T·hd), independent of sequence length.
    No ring is needed for a cache that is already resident: ring attention
    (ppermute of KV blocks) only pays off when KV lives with the queries;
    here KV lives where it was inserted and the small partials move instead.

    Inserts write only shard-owned rows: local position = pos - lo may be
    negative (earlier shard) or >= S_loc (later shard), and the insert
    drops those rows (ops/attention.py:kv_cache_insert). `span` bounding
    is skipped — each shard attends its whole (already 1/sp-sized) slice
    and the global causal mask zeroes the rest.

    Sliding-window layers (gemma2/3) compose naturally with CP: the window
    is one extra global-row compare in the mask — shards holding only
    out-of-window rows contribute zero probability mass and drop out of
    the psums (their m_loc is -inf but the pmax stays finite because the
    shard holding the query's own position always has a valid row).
    Softcap is the same pre-mask cap*tanh as the single-card path."""
    b, t, _ = x.shape
    hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    sp = opts.seq_axis
    s_loc = cache_l["k"].shape[2]
    lo = jax.lax.axis_index(sp) * s_loc    # first global row this shard owns

    # rows owned by another shard (local position < 0 or >= S_loc) drop
    local_pos = (pos - lo).astype(jnp.int32)
    ck, cks, cv, cvs = kv_cache_insert(
        k.transpose(0, 2, 1, 3).astype(jnp.float32),
        v.transpose(0, 2, 1, 3).astype(jnp.float32),
        cache_l["k"], cache_l["k_scale"], cache_l["v"], cache_l["v_scale"],
        local_pos, t=t)
    cache_l = {"k": ck, "k_scale": cks, "v": cv, "v_scale": cvs}

    k_all = ck.astype(jnp.float32) * cks[..., None]        # (B, KVH, S_loc, hd)
    v_all = cv.astype(jnp.float32) * cvs[..., None]
    prec = (jax.lax.Precision.HIGHEST if opts.precision == "high" else None)
    g = h // kvh
    qg = q.transpose(0, 2, 1, 3).reshape(b, kvh, g * t, hd)
    scores = jnp.einsum("bgqd,bgsd->bgqs", qg.astype(jnp.float32), k_all,
                        precision=prec)
    scores = scores.reshape(b, kvh, g, t, s_loc) / jnp.sqrt(hd).astype(jnp.float32)
    if cfg.attn_softcap:   # gemma2: cap * tanh(score / cap), pre-mask
        cap = jnp.float32(cfg.attn_softcap)
        scores = cap * jnp.tanh(scores / cap)
    rows = lo + jnp.arange(s_loc)                          # global row ids
    valid = rows[None, None, :] <= tok_pos[:, :, None]     # (B, T, S_loc)
    if window:   # sliding-window: keys older than the window drop out
        valid &= rows[None, None, :] > tok_pos[:, :, None] - window
    scores = jnp.where(valid[:, None, None, :, :], scores, -jnp.inf)

    # flash combine: m = global max, l = global sum-exp, o = Σ p·V
    m_loc = jnp.max(scores, axis=-1)                       # (B, KVH, G, T)
    m = jax.lax.pmax(m_loc, sp)      # finite: a token attends to itself
    p = jnp.exp(scores - m[..., None])
    p = jnp.where(valid[:, None, None, :, :], p, 0.0)      # exp(-inf-m)=0; guard anyway
    l = jax.lax.psum(jnp.sum(p, axis=-1), sp)
    o = jax.lax.psum(jnp.einsum("bghqs,bgsd->bghqd", p, v_all,
                                precision=prec), sp)
    out = (o / l[..., None]).reshape(b, h, t, hd)
    out = out.transpose(0, 2, 1, 3).reshape(b * t, h * hd)

    proj = linear(layer["wo"], out.astype(x.dtype), opts)
    if opts.axis_name:               # row-parallel wo under tp x sp meshes
        proj = jax.lax.psum(proj, opts.axis_name)
    return proj.reshape(b, t, -1), cache_l


def mlp(layer, x, opts: MMOpts, act_fn: str = "silu",
        return_mid: bool = False):
    b, t, _ = x.shape
    xf = x.reshape(b * t, -1)
    if "gate_up" in layer:  # fused projection (see fuse_llama_params)
        gu = linear(layer["gate_up"], xf, opts)
        g, u = jnp.split(gu, 2, axis=-1)
    elif "gate" in layer:
        g = linear(layer["gate"], xf, opts)
        u = linear(layer["up"], xf, opts)
    else:                   # gateless MLP (phi2): act(up(x)) @ down
        g = None
        u = linear(layer["up"], xf, opts)
    if "bup" in layer:
        u = u + layer["bup"].astype(u.dtype)
    if g is None:
        uf = u.astype(jnp.float32)
        act = (jax.nn.silu(uf) if act_fn == "silu"
               else jax.nn.gelu(uf, approximate=True)).astype(x.dtype)
    else:
        gf = g.astype(jnp.float32)
        act = (jax.nn.silu(gf) if act_fn == "silu"
               else jax.nn.gelu(gf, approximate=True)).astype(x.dtype) * u
    down = linear(layer["down"], act, opts)
    if opts.axis_name:  # row-parallel down: sum partial products over tp
        down = jax.lax.psum(down, opts.axis_name)
    if "bdown" in layer:
        down = down + layer["bdown"].astype(down.dtype)
    if return_mid:   # imatrix collection: ffn_down's input activations
        return down.reshape(b, t, -1), act.reshape(b, t, -1)
    return down.reshape(b, t, -1)


def moe_mlp(layer, x, cfg: LlamaConfig, opts: MMOpts):
    """Mixture-of-experts FFN (mixtral-family). Router math follows
    llama.cpp/HF Mixtral: softmax over ALL experts, top-k selection, selected
    weights renormalized to sum 1, weighted sum of per-expert SwiGLU outputs.

    Evaluation is dense-per-expert: every (shard-local) expert runs over all
    tokens and the combine multiplies by the zero-masked routing weights.
    Expert GEMMs at decode are weight-bytes-bound and with B*T*k
    assignments spread over E experts nearly every expert is hit every
    step, so a capacity-style dispatch would stream the same weight bytes
    plus token-row gathers. At long-prefill shapes the extra FLOPs (E/k x)
    are the documented trade (DESIGN.md §MoE).

    The top-k mask is built by comparing indices against an iota.

    Expert parallelism: the expert stacks' leading E dim is sharded over
    mesh axis `opts.ep_axis`; each device evaluates its local experts
    against the GLOBAL routing-weight columns (offset by axis_index * E_loc)
    and one psum over (ep, tp) both sums expert partials and completes the
    row-parallel down projections — a single collective per MoE layer.
    """
    from ..quant.layouts import take_expert

    b, t, _ = x.shape
    xf = x.reshape(b * t, -1)
    router = layer["gate_inp"]  # (E_global, dim), replicated float
    logits = xf.astype(jnp.float32) @ router.T.astype(jnp.float32)
    if cfg.moe_gating == "sigmoid":      # deepseek-V3 scoring
        probs = jax.nn.sigmoid(logits)
    else:
        probs = jax.nn.softmax(logits, axis=-1)            # (N, E_global)
    # deepseek-V3: selection uses bias-adjusted scores, weights stay raw
    sel_scores = (probs + layer["gate_inp_b"][None, :]
                  if "gate_inp_b" in layer else probs)
    _, topi = jax.lax.top_k(sel_scores, cfg.n_experts_used)  # (N, k)
    sel = (topi[..., None] == jnp.arange(cfg.n_experts)[None, None, :]).any(1)
    w = jnp.where(sel, probs, 0.0)
    if cfg.moe_renorm:                                     # norm_topk_prob
        w = w / jnp.sum(w, axis=-1, keepdims=True)
    if cfg.routed_scale != 1.0:          # deepseek2 expert_weights_scale
        w = w * jnp.float32(cfg.routed_scale)

    gate, up, down = layer["gate_exps"], layer["up_exps"], layer["down_exps"]
    # shard-local expert count = leading dim of any stacked field
    e_loc = (gate.d_bits if isinstance(gate, QuantTensor) else gate).shape[0]
    off = (jax.lax.axis_index(opts.ep_axis) * e_loc if opts.ep_axis
           else 0)
    acc = jnp.zeros((b * t, x.shape[-1]), jnp.float32)
    for e in range(e_loc):
        g = linear(take_expert(gate, e), xf, opts)
        u = linear(take_expert(up, e), xf, opts)
        gf = g.astype(jnp.float32)
        act = (jax.nn.silu(gf) if cfg.act_fn == "silu"
               else jax.nn.gelu(gf, approximate=True)).astype(x.dtype) * u
        d = linear(take_expert(down, e), act, opts)
        we = jax.lax.dynamic_slice_in_dim(w, off + e, 1, axis=1)  # (N, 1)
        acc = acc + we * d.astype(jnp.float32)
    axes = tuple(a for a in (opts.axis_name, opts.ep_axis) if a)
    if axes:  # one psum finishes row-parallel down AND the expert partials
        acc = jax.lax.psum(acc, axes)
    if "gate_shexp" in layer:   # deepseek2/qwen2moe shared experts
        shared = mlp({"gate": layer["gate_shexp"], "up": layer["up_shexp"],
                      "down": layer["down_shexp"]}, x, opts, cfg.act_fn)
        shared = shared.reshape(b * t, -1).astype(jnp.float32)
        if "gate_inp_shexp" in layer:
            # qwen2moe: the shared expert is gated by a per-token sigmoid
            sg = jax.nn.sigmoid(
                x.reshape(b * t, -1).astype(jnp.float32)
                @ layer["gate_inp_shexp"][:, None])
            shared = shared * sg
        acc = acc + shared
    return acc.astype(x.dtype).reshape(b, t, -1)


def fuse_llama_params(params: dict, tp: int = 1) -> dict:
    """Fuse per-layer QKV and gate+up projections along M (one MMQ launch
    instead of three/two — per-kernel fixed cost dominates small decode
    GEMMs). Only same-format quantized groups fuse; mixed-format layers
    (e.g. Q4_K_M checkpoints that keep attn_v at Q6_K) keep those weights
    separate.

    tp > 1 fuses INTERLEAVED per tensor-parallel shard — the fused matrix
    is laid out [q_0 k_0 v_0 | q_1 k_1 v_1 | ...] so a uniform
    P(None, "tp") column shard hands each device a locally contiguous
    [q_d k_d v_d], and the per-device split by LOCAL head counts in
    attention() stays correct."""
    from ..quant.layouts import concat_m

    def fusable(ws):
        return (all(isinstance(w, QuantTensor) for w in ws)
                and len({w.fmt for w in ws}) == 1
                and all(w.shape[0] % tp == 0 for w in ws))

    def slice_m(t, lo, hi):
        return jax.tree_util.tree_map(lambda a: a[..., lo:hi], t)

    def fuse(ws):
        if tp == 1:
            return concat_m(ws)
        parts = []
        for d in range(tp):
            for w in ws:
                step = w.shape[0] // tp
                parts.append(slice_m(w, d * step, (d + 1) * step))
        return concat_m(parts)

    def fuse_bias(bs):
        if tp == 1:
            return jnp.concatenate(bs)
        parts = []
        for d in range(tp):
            for b in bs:
                step = b.shape[0] // tp
                parts.append(b[d * step:(d + 1) * step])
        return jnp.concatenate(parts)

    layers = []
    for layer in params["layers"]:
        layer = dict(layer)
        if ("wq" in layer and "wk" in layer
                and fusable([layer["wq"], layer["wk"], layer["wv"]])):
            layer["wqkv"] = fuse([layer.pop("wq"), layer.pop("wk"),
                                  layer.pop("wv")])
            if "bq" in layer:
                layer["bqkv"] = fuse_bias(
                    [layer.pop("bq"), layer.pop("bk"), layer.pop("bv")])
        if "gate" in layer and fusable([layer["gate"], layer["up"]]):
            layer["gate_up"] = fuse([layer.pop("gate"), layer.pop("up")])
        layers.append(layer)
    out = {**params, "layers": layers}
    # The embedding table's K-major SoA makes a decode-step embed a gather
    # along the vocab (last) axis of every field. For untied checkpoints,
    # materialize the table dequantized (f32 — bit-identical values to the row-wise
    # dequant path, so fused-vs-unfused equivalence holds exactly) and
    # let embed() take contiguous rows instead. Gated on table size so
    # HBM-starved configs (13B) keep the compact form; tied checkpoints
    # keep the QuantTensor (it doubles as the lm_head MMQ weight).
    emb = out.get("token_embd")
    if (tp == 1
            and isinstance(emb, QuantTensor)
            and out.get("output") is not emb
            and emb.shape[0] * emb.shape[1] * 4 <= 600 * 2**20):
        # tp > 1 keeps the compact QuantTensor: the f32 table would be
        # REPLICATED per card (hundreds of MB each) while the sharded
        # weight budget shrinks. The 600 MiB gate has not been measured
        # on the H200.
        out["token_embd"] = emb.dequantize()
    return out


def forward(
    params: dict,
    cfg: LlamaConfig,
    tokens: jax.Array,        # (B, T) int32
    pos: jax.Array,           # (B,) start position of tokens[:, 0]
    cache: dict,
    opts: MMOpts = MMOpts(),
    span: int | None = None,
    return_hidden: bool = False,
    collect_sq: bool = False,
    embeds: jax.Array | None = None,
    t_real=None,
):
    """Run T tokens through the decoder; returns (logits (B, T, vocab), cache).

    `t_real` (dynamic scalar): real timestep count when the caller padded
    T to a bucket — only recurrent (mamba) layers need it; attention's
    causal mask already hides trailing pads.

    `embeds` (B, T, dim): pre-computed input embeddings replace the token
    lookup — the multimodal path, where a prompt mixes text-token
    embeddings with projected vision embeddings (`tokens` is then only
    read for its shape).

    T=1 is the decode step; T>1 is chunked prefill. Per-sequence positions
    support continuous batching (sequences at different depths in one batch).
    `span` (static) promises every pos + T <= span so attention reads only
    the first span cache rows; None reads the whole cache.
    `return_hidden` skips the LM head and returns the final-norm hidden
    states (B, T, dim) f32 instead of logits — the embedding surface.
    `collect_sq` (imatrix calibration) additionally returns per-layer
    sums of squared input activations for every quantized projection:
    (logits, cache, stats) with stats = [{name: (in_dim,) f32}, ...] per
    layer plus a trailing {"output": ...} entry for the LM head.
    """
    if embeds is not None:
        # caller-prepared embeddings (text rows already embed_scale'd)
        x = embeds.astype(jnp.float32)
    else:
        x = embed(params["token_embd"], tokens)
        if cfg.embed_scale != 1.0:   # gemma: sqrt(dim), through bf16
            x = x * jnp.bfloat16(cfg.embed_scale).astype(jnp.float32)
        if "position_embd" in params:   # gpt2: learned absolute positions
            pidx = pos[:, None] + jnp.arange(tokens.shape[1])[None, :]
            x = x + params["position_embd"][pidx]
    x = x.astype(jnp.bfloat16)
    tok_pos = pos[:, None] + jnp.arange(tokens.shape[1])[None, :]
    rope = rope_for_cfg(tok_pos, cfg)
    # gemma3: sliding layers rotate at their own (short-context) base —
    # computed once here, like the global pair
    rope_swa = (rope_for_cfg(tok_pos, cfg, theta=cfg.rope_theta_swa)
                if cfg.rope_theta_swa and cfg.swa_pattern > 1 else rope)

    def sumsq(v):
        return jnp.sum(v.astype(jnp.float32) ** 2, axis=(0, 1))

    stats = [] if collect_sq else None
    new_layers = []
    for i, layer in enumerate(params["layers"]):
        # gemma2/3-family: all but every swa_pattern-th layer slide
        window = (cfg.sliding_window
                  if cfg.swa_pattern > 1
                  and i % cfg.swa_pattern != cfg.swa_pattern - 1 else 0)
        h = _norm(x, layer, "attn_norm", cfg)
        ls = {}
        if "ssm_in" in layer:   # mamba: the mixer IS the whole block
            from .ssm import mamba_block

            if collect_sq:
                ls["ssm_in"] = sumsq(h)
            out, cache_l = mamba_block(layer, h, cfg, cache[i], pos, opts,
                                       t_real=t_real)
            x = x + out
            if collect_sq:
                stats.append(ls)
            new_layers.append(cache_l)
            continue
        if "wkv_a" in layer:   # deepseek2 multi-head latent attention
            if collect_sq:
                ls["attn_qkv"] = sumsq(h)
                attn_out, cache_l, pre = mla_attention(
                    layer, h, cfg, cache[i], pos, opts, rope=rope,
                    span=span, return_pre_proj=True)
                ls["attn_output"] = sumsq(pre)
            else:
                attn_out, cache_l = mla_attention(
                    layer, h, cfg, cache[i], pos, opts, rope=rope,
                    span=span)
        elif collect_sq:
            ls["attn_qkv"] = sumsq(h)
            attn_out, cache_l, pre = attention(
                layer, h, cfg, cache[i], pos, opts,
                rope=rope_swa if window else rope, span=span, window=window,
                return_pre_proj=True)
            ls["attn_output"] = sumsq(pre)
        else:
            attn_out, cache_l = attention(layer, h, cfg, cache[i], pos, opts,
                                          rope=rope_swa if window else rope,
                                          span=span, window=window)
        if "post_attn_norm" in layer:   # gemma2: norm the branch output
            attn_out = rms_norm(attn_out, layer["post_attn_norm"],
                                cfg.norm_eps)
        if cfg.residual_scale != 1.0:   # granite: scaled branch outputs
            attn_out = attn_out * jnp.float32(
                cfg.residual_scale).astype(attn_out.dtype)
        if cfg.parallel_residual:
            # phi2/command-r: one shared pre-norm feeds both branches;
            # falcon-40b-style blocks carry a SEPARATE mlp pre-norm
            hm = (_norm(x, layer, "ffn_norm", cfg)
                  if "ffn_norm" in layer else h)
            if collect_sq:
                ls["ffn_gate_up"] = (sumsq(hm) if "ffn_norm" in layer
                                     else ls["attn_qkv"])
                mlp_out, mid = mlp(layer, hm, opts, cfg.act_fn,
                                   return_mid=True)
                ls["ffn_down"] = sumsq(mid)
                x = x + attn_out + mlp_out
            else:
                x = x + attn_out + mlp(layer, hm, opts, cfg.act_fn)
        else:
            x = x + attn_out
            h = _norm(x, layer, "ffn_norm", cfg)
            if "gate_inp" in layer:   # MoE: per-expert stats not collected
                mlp_out = moe_mlp(layer, h, cfg, opts)
                if collect_sq:
                    ls["ffn_gate_up"] = sumsq(h)
            elif collect_sq:
                ls["ffn_gate_up"] = sumsq(h)
                mlp_out, mid = mlp(layer, h, opts, cfg.act_fn,
                                   return_mid=True)
                ls["ffn_down"] = sumsq(mid)
            else:
                mlp_out = mlp(layer, h, opts, cfg.act_fn)
            if "post_ffn_norm" in layer:
                mlp_out = rms_norm(mlp_out, layer["post_ffn_norm"],
                                   cfg.norm_eps)
            if cfg.residual_scale != 1.0:
                mlp_out = mlp_out * jnp.float32(
                    cfg.residual_scale).astype(mlp_out.dtype)
            x = x + mlp_out
        if collect_sq:
            stats.append(ls)
        new_layers.append(cache_l)
    cache = new_layers

    x = _norm(x, params, "output_norm", cfg)
    if collect_sq:
        stats.append({"output": sumsq(x)})
    if return_hidden:
        return x.astype(jnp.float32), cache
    b, t, _ = x.shape
    logits = linear(params["output"], x.reshape(b * t, -1), opts)
    if opts.axis_name:  # column-parallel LM head: gather the vocab shards
        logits = jax.lax.all_gather(logits, opts.axis_name, axis=-1, tiled=True)
    # the loader may have padded the vocab dim for tile alignment
    logits = logits[:, :cfg.vocab_size]
    if "output_bias" in params:   # phi2-family LM-head bias (unpadded)
        logits = logits + params["output_bias"].astype(logits.dtype)
    logits = logits.reshape(b, t, -1).astype(jnp.float32)
    if cfg.logit_scale:   # command-r multiplier / granite 1-over-divisor
        logits = logits * jnp.float32(cfg.logit_scale)
    if cfg.final_softcap:   # gemma2: cap * tanh(logits / cap)
        cap = jnp.float32(cfg.final_softcap)
        logits = cap * jnp.tanh(logits / cap)
    if collect_sq:
        return logits, cache, stats
    return logits, cache
