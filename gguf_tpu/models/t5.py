"""T5 encoder-decoder (llama.cpp arch "t5"): flan-t5 / madlad GGUFs.

Architecture (llama.cpp build_t5_enc/build_t5_dec, HF T5 semantics):
- RMS pre-norms everywhere (T5 LayerNorm is variance-only)
- attention scores are NOT scaled (no 1/sqrt(d_kv)) and use a LEARNED
  relative position bias — bucketed log-spaced distances, bidirectional
  buckets in the encoder, causal in the decoder, bias weights taken
  from layer 0 (T5 shares them across layers; llama.cpp stores
  attn_rel_b per layer but reads blk 0)
- d_kv (head width) is independent of d_model/heads; the attention
  output projection maps heads*d_kv -> d_model
- gated-GELU FFN (t5 v1.1 / flan) or ungated ReLU (t5 v1.0) — keyed on
  the ffn_gate tensor
- decoder blocks add cross-attention over the encoder output (no
  position bias); generation starts from decoder_start_token_id and
  feeds a per-layer f32 self-attention KV cache + once-computed cross
  K/V

Serving surface: the engine routes generate()/encode through
T5 helpers when the GGUF's architecture is t5 (batch loop with a jitted
decode step; the continuous-batching machinery is decoder-only-LM
specific).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class T5Config:
    vocab_size: int
    dim: int
    n_enc_layers: int
    n_dec_layers: int
    n_heads: int
    head_dim: int            # d_kv
    ffn_dim: int
    norm_eps: float
    rel_buckets: int         # attention.relative_buckets_count (32)
    rel_max_dist: int        # 128 (not in GGUF; T5's fixed default)
    decoder_start: int
    max_seq_len: int
    tied_head: bool = True   # tied LM head scales hidden by d_model^-0.5

    @classmethod
    def from_gguf_metadata(cls, md: dict) -> "T5Config":
        g = lambda k, d=None: md.get(f"t5.{k}", d)
        n_heads = int(g("attention.head_count"))
        dim = int(g("embedding_length"))
        key_len = g("attention.key_length")
        vocab = md.get("t5.vocab_size")
        if vocab is None:
            vocab = len(md["tokenizer.ggml.tokens"])
        return cls(
            vocab_size=int(vocab),
            dim=dim,
            n_enc_layers=int(g("block_count")),
            n_dec_layers=int(g("decoder_block_count",
                               g("block_count")) or g("block_count")),
            n_heads=n_heads,
            head_dim=int(key_len) if key_len else dim // n_heads,
            ffn_dim=int(g("feed_forward_length")),
            norm_eps=float(g("attention.layer_norm_rms_epsilon", 1e-6)
                           or 1e-6),
            rel_buckets=int(g("attention.relative_buckets_count", 32)
                            or 32),
            rel_max_dist=128,
            decoder_start=int(g("decoder_start_token_id", 0) or 0),
            max_seq_len=int(g("context_length", 512) or 512),
        )


def load_t5(reader):
    """t5 GGUF -> (T5Config, params). Projection weights load through
    the MMQ path (QuantTensor SoA for quantized checkpoints — madlad/
    flan GGUFs ship q4_k/q8_0 mixes; float tensors stay jnp arrays);
    norms and the relative-bias table stay f32."""
    from .loader import _load_weight

    cfg = T5Config.from_gguf_metadata(reader.metadata)
    t = lambda n: jnp.asarray(reader.dequantize(n), jnp.float32)
    w = lambda n: _load_weight(reader, n)
    has = lambda n: n in reader.tensors

    def blk(prefix, n_layers, cross):
        layers = []
        for i in range(n_layers):
            p = f"{prefix}.blk.{i}."
            layer = {
                "attn_norm": t(p + "attn_norm.weight"),
                "wq": w(p + "attn_q.weight"),
                "wk": w(p + "attn_k.weight"),
                "wv": w(p + "attn_v.weight"),
                "wo": w(p + "attn_o.weight"),
                "ffn_norm": t(p + "ffn_norm.weight"),
                "up": w(p + "ffn_up.weight"),
                "down": w(p + "ffn_down.weight"),
            }
            if has(p + "ffn_gate.weight"):
                layer["gate"] = w(p + "ffn_gate.weight")
            if has(p + "attn_rel_b.weight"):
                # normalized to (n_heads, n_buckets); llama.cpp GGUFs
                # store ne {n_head, n_buckets} -> numpy (buckets, heads)
                rb = t(p + "attn_rel_b.weight")
                if rb.shape[0] == cfg.rel_buckets and \
                        rb.shape[-1] == cfg.n_heads:
                    rb = rb.T
                layer["rel_b"] = rb
            if cross:
                layer.update({
                    "cross_norm": t(p + "cross_attn_norm.weight"),
                    "cq": w(p + "cross_attn_q.weight"),
                    "ck": w(p + "cross_attn_k.weight"),
                    "cv": w(p + "cross_attn_v.weight"),
                    "co": w(p + "cross_attn_o.weight"),
                })
            layers.append(layer)
        return layers

    params = {
        "token_embd": w("token_embd.weight"),
        "enc_layers": blk("enc", cfg.n_enc_layers, cross=False),
        "dec_layers": blk("dec", cfg.n_dec_layers, cross=True),
        "enc_norm": t("enc.output_norm.weight"),
        "dec_norm": t("dec.output_norm.weight"),
    }
    params["output"] = (w("output.weight") if has("output.weight")
                        else params["token_embd"])
    if has("output.weight"):
        import dataclasses

        cfg = dataclasses.replace(cfg, tied_head=False)
    return cfg, params


def _rmsn(x, w, eps):
    var = jnp.mean(x * x, axis=-1, keepdims=True)
    return x * jax.lax.rsqrt(var + eps) * w


def _rel_bucket(rel, bidirectional: bool, n_buckets: int, max_dist: int):
    """HF/llama.cpp relative_position_bucket: near distances get exact
    buckets, far ones log-spaced, symmetric halves when bidirectional."""
    rel = jnp.asarray(rel, jnp.int32)
    if bidirectional:
        half = n_buckets // 2
        bucket = jnp.where(rel > 0, half, 0)
        rel = jnp.abs(rel)
        n = half
    else:
        bucket = jnp.zeros_like(rel)
        rel = -jnp.minimum(rel, 0)
        n = n_buckets
    exact = n // 2
    is_small = rel < exact
    large = exact + (
        jnp.log(jnp.maximum(rel, 1).astype(jnp.float32) / exact)
        / np.log(max_dist / exact) * (n - exact)).astype(jnp.int32)
    large = jnp.minimum(large, n - 1)
    return bucket + jnp.where(is_small, rel, large)


def _attn_bias(q_pos, k_pos, rel_b, bidirectional, cfg: T5Config):
    """(H, Tq, Tk) additive score bias from the shared learned table."""
    rel = k_pos[None, :] - q_pos[:, None]            # (Tq, Tk) memory - query
    b = _rel_bucket(rel, bidirectional, cfg.rel_buckets, cfg.rel_max_dist)
    return rel_b[:, b]                               # (H, Tq, Tk)


def _lin(w, x):
    """x (..., K) @ W^T for float or MMQ QuantTensor weights."""
    from .llama import linear

    lead = x.shape[:-1]
    out = linear(w, x.reshape(-1, x.shape[-1]).astype(jnp.float32))
    return out.reshape(*lead, -1).astype(jnp.float32)


def _embed(table, ids):
    from .llama import embed

    return embed(table, ids)


def _mha(q, k, v, bias):
    """q (B,Tq,H,hd) k/v (B,Tk,H,hd) bias (B,H,Tq,Tk) -> (B,Tq,H*hd).
    T5: scores are UNSCALED."""
    sc = jnp.einsum("bqhd,bkhd->bhqk", q, k) + bias
    pr = jax.nn.softmax(sc, axis=-1)
    out = jnp.einsum("bhqk,bkhd->bqhd", pr, v)
    b, tq = out.shape[:2]
    return out.reshape(b, tq, -1)


def _ffn(layer, x, eps):
    h = _rmsn(x, layer["ffn_norm"], eps)
    u = _lin(layer["up"], h)
    if "gate" in layer:          # t5 v1.1: gated GELU
        act = jax.nn.gelu(_lin(layer["gate"], h), approximate=False) * u
    else:                        # t5 v1.0: ReLU
        act = jax.nn.relu(u)
    return x + _lin(layer["down"], act)


def t5_encode(params, cfg: T5Config, tokens, lengths):
    """(B, S) padded tokens -> encoder hidden states (B, S, dim)."""
    b, s = tokens.shape
    h, hd = cfg.n_heads, cfg.head_dim
    x = _embed(params["token_embd"], tokens)
    pos = jnp.arange(s)
    rel_b = params["enc_layers"][0]["rel_b"]         # shared across layers
    bias = _attn_bias(pos, pos, rel_b, True, cfg)[None]      # (1,H,S,S)
    valid = jnp.arange(s)[None, :] < lengths[:, None]
    bias = bias + jnp.where(valid, 0.0, -jnp.inf)[:, None, None, :]
    for lyr in params["enc_layers"]:
        r = _rmsn(x, lyr["attn_norm"], cfg.norm_eps)
        q = _lin(lyr["wq"], r).reshape(b, s, h, hd)
        k = _lin(lyr["wk"], r).reshape(b, s, h, hd)
        v = _lin(lyr["wv"], r).reshape(b, s, h, hd)
        x = x + _lin(lyr["wo"], _mha(q, k, v, bias))
        x = _ffn(lyr, x, cfg.norm_eps)
    return _rmsn(x, params["enc_norm"], cfg.norm_eps)


def t5_decode_step(params, cfg: T5Config, tokens, pos, cache, enc_out,
                   enc_lengths):
    """Decoder forward for T new tokens at positions pos..pos+T-1 (all
    sequences aligned — T5 serving decodes a batch in lockstep from
    decoder_start). Returns (logits (B,T,V), cache). cache: per-layer
    {"k","v"} (B, S_max, H, hd) f32 self-attention rows."""
    b, t = tokens.shape
    h, hd = cfg.n_heads, cfg.head_dim
    s_max = cache[0]["k"].shape[1]
    x = _embed(params["token_embd"], tokens)

    q_pos = pos + jnp.arange(t)
    k_pos = jnp.arange(s_max)
    rel_b = params["dec_layers"][0]["rel_b"]
    bias = _attn_bias(q_pos, k_pos, rel_b, False, cfg)[None]  # (1,H,T,S)
    causal = k_pos[None, :] <= q_pos[:, None]                 # (T, S)
    bias = bias + jnp.where(causal, 0.0, -jnp.inf)[None, None]

    se = enc_out.shape[1]
    evalid = jnp.arange(se)[None, :] < enc_lengths[:, None]
    cbias = jnp.where(evalid, 0.0, -jnp.inf)[:, None, None, :]

    new_cache = []
    for li, lyr in enumerate(params["dec_layers"]):
        r = _rmsn(x, lyr["attn_norm"], cfg.norm_eps)
        q = _lin(lyr["wq"], r).reshape(b, t, h, hd)
        k = _lin(lyr["wk"], r).reshape(b, t, h, hd)
        v = _lin(lyr["wv"], r).reshape(b, t, h, hd)
        ck = jax.lax.dynamic_update_slice(
            cache[li]["k"], k, (0, pos, 0, 0))
        cv = jax.lax.dynamic_update_slice(
            cache[li]["v"], v, (0, pos, 0, 0))
        new_cache.append({"k": ck, "v": cv})
        x = x + _lin(lyr["wo"], _mha(q, ck, cv, bias))

        r = _rmsn(x, lyr["cross_norm"], cfg.norm_eps)
        cq = _lin(lyr["cq"], r).reshape(b, t, h, hd)
        ek = _lin(lyr["ck"], enc_out).reshape(b, se, h, hd)
        ev = _lin(lyr["cv"], enc_out).reshape(b, se, h, hd)
        x = x + _lin(lyr["co"], _mha(cq, ek, ev, cbias))

        x = _ffn(lyr, x, cfg.norm_eps)

    x = _rmsn(x, params["dec_norm"], cfg.norm_eps)
    if cfg.tied_head:            # HF: tied head scales by d_model^-0.5
        x = x * (cfg.dim ** -0.5)
    logits = _lin(params["output"], x)
    return logits, new_cache


def write_random_t5_gguf(path: str, cfg: T5Config, seed: int = 0,
                         extra_metadata: dict | None = None,
                         gated: bool = True, tied: bool = True,
                         fmt=None) -> None:
    """Random llama.cpp-schema t5 GGUF (tests). `fmt` (a GGMLType)
    quantizes the projection weights like real madlad/flan files."""
    from ..gguf import GGMLType
    from ..gguf.writer import quantize_tensor, write_gguf

    rng = np.random.default_rng(seed)
    d, f, v = cfg.dim, cfg.ffn_dim, cfg.vocab_size
    h, hd, nb = cfg.n_heads, cfg.head_dim, cfg.rel_buckets
    s = 0.5 / np.sqrt(d)
    w = lambda *sh: (rng.standard_normal(sh) * s).astype(np.float32)
    nrm = lambda n: (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    f32 = lambda arr: (GGMLType.F32, arr.shape, arr)
    proj = (f32 if fmt is None else
            (lambda arr: (fmt, arr.shape, quantize_tensor(arr, fmt))))
    tensors = {
        "token_embd.weight": proj(w(v, d) * 4),
        "enc.output_norm.weight": f32(nrm(d)),
        "dec.output_norm.weight": f32(nrm(d)),
    }
    if not tied:
        tensors["output.weight"] = proj(w(v, d))

    def blk(prefix, n_layers, cross):
        for i in range(n_layers):
            p = f"{prefix}.blk.{i}."
            for name, shape in (("attn_q", (h * hd, d)),
                                ("attn_k", (h * hd, d)),
                                ("attn_v", (h * hd, d)),
                                ("attn_o", (d, h * hd)),
                                ("ffn_up", (f, d)), ("ffn_down", (d, f))):
                tensors[p + name + ".weight"] = proj(w(*shape))
            if gated:
                tensors[p + "ffn_gate.weight"] = proj(w(f, d))
            for name in ("attn_norm", "ffn_norm"):
                tensors[p + name + ".weight"] = f32(nrm(d))
            if i == 0:   # llama.cpp layout: (buckets, heads) on disk
                tensors[p + "attn_rel_b.weight"] = f32(
                    (rng.standard_normal((nb, h)) * 0.5).astype(np.float32))
            if cross:
                for name, shape in (("cross_attn_q", (h * hd, d)),
                                    ("cross_attn_k", (h * hd, d)),
                                    ("cross_attn_v", (h * hd, d)),
                                    ("cross_attn_o", (d, h * hd))):
                    tensors[p + name + ".weight"] = proj(w(*shape))
                tensors[p + "cross_attn_norm.weight"] = f32(nrm(d))

    blk("enc", cfg.n_enc_layers, cross=False)
    blk("dec", cfg.n_dec_layers, cross=True)
    md = {
        "general.architecture": "t5",
        "t5.vocab_size": v,
        "t5.embedding_length": d,
        "t5.block_count": cfg.n_enc_layers,
        "t5.decoder_block_count": cfg.n_dec_layers,
        "t5.attention.head_count": h,
        "t5.attention.key_length": hd,
        "t5.attention.value_length": hd,
        "t5.feed_forward_length": f,
        "t5.attention.layer_norm_rms_epsilon": cfg.norm_eps,
        "t5.attention.relative_buckets_count": nb,
        "t5.decoder_start_token_id": cfg.decoder_start,
        "t5.context_length": cfg.max_seq_len,
    }
    md.update(extra_metadata or {})
    write_gguf(path, md, tensors)


@functools.partial(jax.jit, static_argnums=(1, 8))
def _t5_chunk(params, cfg, cache, tok, pos, enc_out, lens, key, steps,
              temp):
    """`steps` decode iterations in one jit (lax.scan): one host sync
    per chunk instead of per token — the host round-trip otherwise
    dominates small-model decode. Returns (cache, next_tok, key, toks (steps, B))."""

    def step(carry, _):
        cache, tok, pos, key = carry
        logits, cache = t5_decode_step(params, cfg, tok, pos, cache,
                                       enc_out, lens)
        key, sub = jax.random.split(key)
        lg = logits[:, 0]
        sampled = jax.random.categorical(
            sub, lg / jnp.maximum(temp, 1e-6))
        nxt = jnp.where(temp > 0, sampled, jnp.argmax(lg, axis=-1))
        nxt = nxt.astype(jnp.int32)
        return (cache, nxt[:, None], pos + 1, key), nxt

    (cache, tok, pos, key), toks = jax.lax.scan(
        step, (cache, tok, jnp.asarray(pos, jnp.int32), key), None,
        length=steps)
    return cache, tok, key, toks


def t5_generate(params, cfg: T5Config, enc_tokens, lengths,
                max_new_tokens: int = 64, eos_id: int = 1,
                temperature: float = 0.0, seed: int = 0,
                chunk: int = 8, on_tokens=None):
    """Greedy/sampled decode for a padded batch (B, S) of encoder token
    ids with real `lengths`. Decodes in jitted chunks; `on_tokens(row,
    new_ids, finished)` streams per chunk — a truthy return marks the
    row done (the engine's stop-string/stop-id hook), ending decode as
    soon as every row is done. Returns (token lists without EOS,
    per-row ended-by-EOS flags)."""
    b = enc_tokens.shape[0]
    lens = jnp.asarray(lengths, jnp.int32)
    enc_out = jax.jit(t5_encode, static_argnums=(1,))(
        params, cfg, jnp.asarray(enc_tokens), lens)
    s_max = max_new_tokens + 1
    cache = [{"k": jnp.zeros((b, s_max, cfg.n_heads, cfg.head_dim),
                             jnp.float32),
              "v": jnp.zeros((b, s_max, cfg.n_heads, cfg.head_dim),
                             jnp.float32)}
             for _ in range(cfg.n_dec_layers)]

    key = jax.random.PRNGKey(seed)
    tok = jnp.full((b, 1), cfg.decoder_start, jnp.int32)
    out = [[] for _ in range(b)]
    hit_eos = [False] * b
    done = np.zeros(b, bool)
    notified_done: set = set()
    pos = 0
    while pos < max_new_tokens:
        steps = min(chunk, max_new_tokens - pos)
        cache, tok, key, toks = _t5_chunk(
            params, cfg, cache, tok, pos, enc_out, lens, key, steps,
            jnp.float32(temperature))
        toks = np.asarray(toks)                      # (steps, B)
        fresh = [[] for _ in range(b)]
        for t_i in range(steps):
            for j in range(b):
                if done[j]:
                    continue
                tk = int(toks[t_i, j])
                if tk == eos_id:
                    done[j] = hit_eos[j] = True
                else:
                    out[j].append(tk)
                    fresh[j].append(tk)
        pos += steps
        if on_tokens is not None:
            for j in range(b):
                if fresh[j] or (done[j] and j not in notified_done):
                    if on_tokens(j, fresh[j], bool(done[j])):
                        done[j] = True       # caller-side stop (string/id)
                    if done[j]:
                        notified_done.add(j)
        if done.all():
            break
    if on_tokens is not None:        # rows capped by length: one final
        for j in range(b):           # finished notification each
            if j not in notified_done:
                on_tokens(j, [], True)
    return out, hit_eos
