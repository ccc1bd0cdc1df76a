"""HF -> GGUF converter: safetensors parsing, rope permutation parity
against a rotate-half HF reference forward, tokenizer mapping."""

import json
import struct

import numpy as np
import pytest

import jax.numpy as jnp

from gguf_tpu.models import MMOpts, forward, init_kv_cache, load_llama
from gguf_tpu.tools.convert_hf import (convert_hf, permute_rope,
                                       read_safetensors)

DIM, HEADS, KV, FFN, LAYERS, VOCAB = 256, 4, 2, 512, 2, 64
HD = DIM // HEADS


def _write_safetensors(path, tensors):
    header = {}
    off = 0
    blobs = []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr, np.float32)
        b = arr.tobytes()
        header[name] = {"dtype": "F32", "shape": list(arr.shape),
                        "data_offsets": [off, off + len(b)]}
        off += len(b)
        blobs.append(b)
    hb = json.dumps(header).encode()
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for b in blobs:
            f.write(b)


def _toy_unigram_tokenizer():
    vocab = [["<unk>", 0.0], ["<s>", 0.0], ["</s>", 0.0]]
    vocab += [[f"<0x{b:02X}>", 0.0] for b in range(61)]
    return {"model": {"type": "Unigram", "vocab": vocab}}


def _make_hf_dir(tmp_path, *, qkv_bias=False, tied=False, model_type="llama",
                 seed=0):
    rng = np.random.default_rng(seed)
    d = tmp_path / "hf"
    d.mkdir(exist_ok=True)
    cfg = {"model_type": model_type, "vocab_size": VOCAB,
           "hidden_size": DIM, "num_hidden_layers": LAYERS,
           "num_attention_heads": HEADS, "num_key_value_heads": KV,
           "intermediate_size": FFN, "rms_norm_eps": 1e-5,
           "rope_theta": 10000.0, "max_position_embeddings": 64}
    (d / "config.json").write_text(json.dumps(cfg))
    (d / "tokenizer.json").write_text(json.dumps(_toy_unigram_tokenizer()))
    s = 0.5 / np.sqrt(DIM)
    w = lambda *shape: (rng.standard_normal(shape) * s).astype(np.float32)
    t = {"model.embed_tokens.weight": w(VOCAB, DIM),
         "model.norm.weight": 1 + 0.1 * w(DIM) * 10}
    if not tied:
        t["lm_head.weight"] = w(VOCAB, DIM)
    for i in range(LAYERS):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = 1 + 0.1 * w(DIM) * 10
        t[p + "post_attention_layernorm.weight"] = 1 + 0.1 * w(DIM) * 10
        t[p + "self_attn.q_proj.weight"] = w(HEADS * HD, DIM)
        t[p + "self_attn.k_proj.weight"] = w(KV * HD, DIM)
        t[p + "self_attn.v_proj.weight"] = w(KV * HD, DIM)
        t[p + "self_attn.o_proj.weight"] = w(DIM, HEADS * HD)
        if qkv_bias:
            t[p + "self_attn.q_proj.bias"] = w(HEADS * HD) * 5
            t[p + "self_attn.k_proj.bias"] = w(KV * HD) * 5
            t[p + "self_attn.v_proj.bias"] = w(KV * HD) * 5
        t[p + "mlp.gate_proj.weight"] = w(FFN, DIM)
        t[p + "mlp.up_proj.weight"] = w(FFN, DIM)
        t[p + "mlp.down_proj.weight"] = w(DIM, FFN)
    _write_safetensors(str(d / "model.safetensors"), t)
    return str(d), t


def _hf_reference(t, tokens, qkv_bias=False, tied=False):
    """Rotate-half-rope HF forward in numpy (the semantics the original
    checkpoint was trained with)."""
    b, T = tokens.shape
    x = t["model.embed_tokens.weight"][tokens.reshape(-1)].reshape(b, T, DIM)

    def rmsn(v, wt):
        return v / np.sqrt(np.mean(v * v, -1, keepdims=True) + 1e-5) * wt

    inv = 10000.0 ** (-np.arange(0, HD, 2) / HD)
    ang = np.arange(T)[:, None] * inv[None, :]
    cos = np.concatenate([np.cos(ang), np.cos(ang)], -1)   # (T, HD)
    sin = np.concatenate([np.sin(ang), np.sin(ang)], -1)

    def rope(v):                                           # (b, T, H, HD)
        half = HD // 2
        rot = np.concatenate([-v[..., half:], v[..., :half]], -1)
        return v * cos[None, :, None, :] + rot * sin[None, :, None, :]

    for i in range(LAYERS):
        p = f"model.layers.{i}."
        h = rmsn(x, t[p + "input_layernorm.weight"])
        q = h @ t[p + "self_attn.q_proj.weight"].T
        k = h @ t[p + "self_attn.k_proj.weight"].T
        v = h @ t[p + "self_attn.v_proj.weight"].T
        if qkv_bias:
            q = q + t[p + "self_attn.q_proj.bias"]
            k = k + t[p + "self_attn.k_proj.bias"]
            v = v + t[p + "self_attn.v_proj.bias"]
        q = rope(q.reshape(b, T, HEADS, HD))
        k = rope(k.reshape(b, T, KV, HD))
        v = v.reshape(b, T, KV, HD)
        rep = HEADS // KV
        k = np.repeat(k, rep, 2)
        v = np.repeat(v, rep, 2)
        sc = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(HD)
        mask = np.tril(np.ones((T, T), bool))
        sc = np.where(mask[None, None], sc, -np.inf)
        pr = np.exp(sc - sc.max(-1, keepdims=True))
        pr /= pr.sum(-1, keepdims=True)
        att = np.einsum("bhqk,bkhd->bqhd", pr, v).reshape(b, T, HEADS * HD)
        x = x + att @ t[p + "self_attn.o_proj.weight"].T
        h = rmsn(x, t[p + "post_attention_layernorm.weight"])
        g = h @ t[p + "mlp.gate_proj.weight"].T
        u = h @ t[p + "mlp.up_proj.weight"].T
        x = x + (g / (1 + np.exp(-g)) * u) @ t[p + "mlp.down_proj.weight"].T

    x = rmsn(x, t["model.norm.weight"])
    head = t["model.embed_tokens.weight"] if tied else t["lm_head.weight"]
    return x @ head.T


def test_safetensors_roundtrip(tmp_path):
    arrs = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": np.ones(5, np.float32)}
    p = str(tmp_path / "x.safetensors")
    _write_safetensors(p, arrs)
    back = read_safetensors(p)
    for k in arrs:
        np.testing.assert_array_equal(back[k], arrs[k])


def test_permute_rope_is_rotate_half_bridge():
    """permute(W) @ x followed by interleaved-pair rope must equal
    W @ x followed by rotate-half rope — the exact property the converter
    relies on."""
    rng = np.random.default_rng(0)
    heads, hd, dim = 2, 8, 16
    W = rng.standard_normal((heads * hd, dim)).astype(np.float64)
    x = rng.standard_normal(dim)
    theta = 0.7  # one angle per pair, same for the check
    inv = 10000.0 ** (-np.arange(0, hd, 2) / hd) * theta

    q_hf = (W @ x).reshape(heads, hd)
    half = hd // 2
    cos = np.concatenate([np.cos(inv), np.cos(inv)])
    sin = np.concatenate([np.sin(inv), np.sin(inv)])
    rot = np.concatenate([-q_hf[:, half:], q_hf[:, :half]], -1)
    out_hf = q_hf * cos + rot * sin

    q_gg = (permute_rope(W, heads) @ x).reshape(heads, hd // 2, 2)
    c, s = np.cos(inv), np.sin(inv)
    out_gg = np.stack([q_gg[..., 0] * c - q_gg[..., 1] * s,
                       q_gg[..., 0] * s + q_gg[..., 1] * c], -1)
    # GGUF interleaved pair j corresponds to HF dims (j, j+half)
    out_gg_dims = np.concatenate([out_gg[..., 0], out_gg[..., 1]], -1)
    np.testing.assert_allclose(out_gg_dims, out_hf, atol=1e-12)


@pytest.mark.parametrize("qkv_bias,tied,model_type", [
    (False, False, "llama"),
    (True, True, "qwen2"),
])
def test_convert_matches_hf_reference(tmp_path, qkv_bias, tied, model_type):
    """Converted GGUF served through the MMQ stack reproduces the HF
    rotate-half-rope reference forward (f16 conversion: only fp16 +
    serving bf16 noise)."""
    d, t = _make_hf_dir(tmp_path, qkv_bias=qkv_bias, tied=tied,
                        model_type=model_type, seed=3)
    out = str(tmp_path / "c.gguf")
    md = convert_hf(d, out, fmt="f16")
    arch = md["general.architecture"]
    assert arch == ("qwen2" if model_type == "qwen2" else "llama")

    cfg, params = load_llama(out)
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, VOCAB, (1, 6)).astype(np.int32)
    got, _ = forward(params, cfg, jnp.asarray(tokens),
                     jnp.zeros(1, jnp.int32), init_kv_cache(cfg, 1, 16),
                     MMOpts(precision="high"))
    ref = _hf_reference(t, tokens, qkv_bias=qkv_bias, tied=tied)
    denom = np.abs(ref).max()
    err = np.max(np.abs(np.asarray(got) - ref)) / denom
    assert err < 0.04, err


def test_convert_quantized_serves(tmp_path):
    d, _ = _make_hf_dir(tmp_path, seed=5)
    out = str(tmp_path / "q.gguf")
    from gguf_tpu.tools.cli import main
    main(["convert-hf", d, out, "--fmt", "q4_k"])
    from gguf_tpu.engine import LLM, SamplerConfig
    res = LLM(out, max_batch=1, max_seq=32).generate(
        [[1, 5, 9]], max_new_tokens=4,
        sampler=SamplerConfig(temperature=0.0), stop_at_eos=False)
    assert len(res[0].token_ids) == 4


def test_convert_gemma2_matches_hf_reference(tmp_path):
    """gemma2 conversion: (1+w) norms baked in, four-norm block layout,
    softcaps + sliding window metadata, sqrt(dim) embedding scale —
    against an HF-semantics numpy forward."""
    rng = np.random.default_rng(9)
    d = tmp_path / "hfg2"
    d.mkdir()
    cfg = {"model_type": "gemma2", "vocab_size": VOCAB,
           "hidden_size": DIM, "num_hidden_layers": 2,
           "num_attention_heads": HEADS, "num_key_value_heads": KV,
           "intermediate_size": FFN, "rms_norm_eps": 1e-5,
           "rope_theta": 10000.0, "max_position_embeddings": 64,
           "attn_logit_softcapping": 20.0,
           "final_logit_softcapping": 15.0, "sliding_window": 3}
    (d / "config.json").write_text(json.dumps(cfg))
    (d / "tokenizer.json").write_text(json.dumps(_toy_unigram_tokenizer()))
    s = 0.5 / np.sqrt(DIM)
    w = lambda *shape: (rng.standard_normal(shape) * s).astype(np.float32)
    t = {"model.embed_tokens.weight": w(VOCAB, DIM),
         "model.norm.weight": w(DIM)}
    for i in range(2):
        p = f"model.layers.{i}."
        for nm in ("input_layernorm", "post_attention_layernorm",
                   "pre_feedforward_layernorm", "post_feedforward_layernorm"):
            t[p + nm + ".weight"] = w(DIM)
        t[p + "self_attn.q_proj.weight"] = w(HEADS * HD, DIM)
        t[p + "self_attn.k_proj.weight"] = w(KV * HD, DIM)
        t[p + "self_attn.v_proj.weight"] = w(KV * HD, DIM)
        t[p + "self_attn.o_proj.weight"] = w(DIM, HEADS * HD)
        t[p + "mlp.gate_proj.weight"] = w(FFN, DIM)
        t[p + "mlp.up_proj.weight"] = w(FFN, DIM)
        t[p + "mlp.down_proj.weight"] = w(DIM, FFN)
    _write_safetensors(str(d / "model.safetensors"), t)

    out = str(tmp_path / "g2.gguf")
    md = convert_hf(str(d), out, fmt="f16")
    assert md["gemma2.attn_logit_softcapping"] == 20.0
    assert md["gemma2.attention.sliding_window"] == 3
    cfg2, params = load_llama(out)
    assert cfg2.swa_pattern == 2 and cfg2.rope_neox
    assert "post_attn_norm" in params["layers"][0]

    tokens = np.random.default_rng(2).integers(0, VOCAB, (1, 6)).astype(np.int32)
    got, _ = forward(params, cfg2, jnp.asarray(tokens),
                     jnp.zeros(1, jnp.int32), init_kv_cache(cfg2, 1, 16),
                     MMOpts(precision="high"))

    # HF-semantics reference: (1+w) norms, sqrt(dim) embed scale (bf16-
    # rounded like the served path), rotate-half rope, softcaps, SWA on
    # even layers
    def rmsn(v, wt):
        return (v / np.sqrt(np.mean(v * v, -1, keepdims=True) + 1e-5)
                * (1.0 + wt))

    b, T = tokens.shape
    x = t["model.embed_tokens.weight"][tokens.reshape(-1)].reshape(b, T, DIM)
    x = x * np.float32(jnp.bfloat16(np.sqrt(DIM)))
    inv = 10000.0 ** (-np.arange(0, HD, 2) / HD)
    ang = np.arange(T)[:, None] * inv[None, :]
    half = HD // 2

    def rope(v):
        c = np.cos(ang)[None, :, None, :]
        sn = np.sin(ang)[None, :, None, :]
        x1, x2 = v[..., :half], v[..., half:]
        return np.concatenate([x1 * c - x2 * sn, x1 * sn + x2 * c], -1)

    def gelu_tanh(v):
        return 0.5 * v * (1 + np.tanh(np.sqrt(2 / np.pi)
                                      * (v + 0.044715 * v ** 3)))

    for i in range(2):
        p = f"model.layers.{i}."
        h = rmsn(x, t[p + "input_layernorm.weight"])
        q = rope((h @ t[p + "self_attn.q_proj.weight"].T)
                 .reshape(b, T, HEADS, HD))
        k = rope((h @ t[p + "self_attn.k_proj.weight"].T)
                 .reshape(b, T, KV, HD))
        v = (h @ t[p + "self_attn.v_proj.weight"].T).reshape(b, T, KV, HD)
        rep = HEADS // KV
        k, v = np.repeat(k, rep, 2), np.repeat(v, rep, 2)
        sc = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(HD)
        sc = 20.0 * np.tanh(sc / 20.0)
        mask = np.tril(np.ones((T, T), bool))
        if i % 2 == 0:    # sliding layer
            qp, kp = np.arange(T)[:, None], np.arange(T)[None, :]
            mask = mask & (kp > qp - 3)
        sc = np.where(mask[None, None], sc, -np.inf)
        pr = np.exp(sc - sc.max(-1, keepdims=True))
        pr /= pr.sum(-1, keepdims=True)
        att = np.einsum("bhqk,bkhd->bqhd", pr, v).reshape(b, T, HEADS * HD)
        att = att @ t[p + "self_attn.o_proj.weight"].T
        att = rmsn(att, t[p + "post_attention_layernorm.weight"])
        x = x + att
        h = rmsn(x, t[p + "pre_feedforward_layernorm.weight"])
        g = h @ t[p + "mlp.gate_proj.weight"].T
        u = h @ t[p + "mlp.up_proj.weight"].T
        m = (gelu_tanh(g) * u) @ t[p + "mlp.down_proj.weight"].T
        m = rmsn(m, t[p + "post_feedforward_layernorm.weight"])
        x = x + m
    x = rmsn(x, t["model.norm.weight"])
    ref = x @ t["model.embed_tokens.weight"].T        # tied head
    ref = 15.0 * np.tanh(ref / 15.0)
    denom = np.abs(ref).max()
    err = np.max(np.abs(np.asarray(got) - ref)) / denom
    assert err < 0.05, err


def test_convert_phi3_longrope_serves(tmp_path):
    """phi3 conversion: fused qkv/gate_up pass-through, LongRoPE factor
    tensors + computed attn_factor; the converted file loads with the
    long factors active and serves."""
    rng = np.random.default_rng(11)
    d = tmp_path / "hfp3"
    d.mkdir()
    hd = DIM // HEADS
    cfg = {"model_type": "phi3", "vocab_size": VOCAB,
           "hidden_size": DIM, "num_hidden_layers": 1,
           "num_attention_heads": HEADS, "num_key_value_heads": KV,
           "intermediate_size": FFN, "rms_norm_eps": 1e-5,
           "rope_theta": 10000.0, "max_position_embeddings": 64,
           "original_max_position_embeddings": 16,
           "rope_scaling": {
               "type": "longrope",
               "long_factor": [1.0 + 0.5 * i for i in range(hd // 2)],
               "short_factor": [1.0] * (hd // 2),
               "original_max_position_embeddings": 16}}
    (d / "config.json").write_text(json.dumps(cfg))
    (d / "tokenizer.json").write_text(json.dumps(_toy_unigram_tokenizer()))
    s = 0.5 / np.sqrt(DIM)
    w = lambda *shape: (rng.standard_normal(shape) * s).astype(np.float32)
    t = {"model.embed_tokens.weight": w(VOCAB, DIM),
         "model.norm.weight": 1 + w(DIM),
         "lm_head.weight": w(VOCAB, DIM)}
    p = "model.layers.0."
    t[p + "input_layernorm.weight"] = 1 + w(DIM)
    t[p + "post_attention_layernorm.weight"] = 1 + w(DIM)
    t[p + "self_attn.qkv_proj.weight"] = w((HEADS + 2 * KV) * hd, DIM)
    t[p + "self_attn.o_proj.weight"] = w(DIM, HEADS * hd)
    t[p + "mlp.gate_up_proj.weight"] = w(2 * FFN, DIM)
    t[p + "mlp.down_proj.weight"] = w(DIM, FFN)
    _write_safetensors(str(d / "model.safetensors"), t)

    out = str(tmp_path / "p3.gguf")
    md = convert_hf(str(d), out, fmt="f16")
    assert md["phi3.rope.scaling.type"] == "longrope"
    assert md["phi3.rope.scaling.attn_factor"] > 1.0
    cfg2, params = load_llama(out)
    assert cfg2.rope_scaling_kind == "longrope" and cfg2.rope_neox
    # max_seq 64 > orig 16 -> the long factors apply
    np.testing.assert_allclose(
        cfg2.rope_freq_factors,
        [1.0 + 0.5 * i for i in range(hd // 2)], rtol=1e-6)
    assert "gate" in params["layers"][0]

    from gguf_tpu.engine import LLM, SamplerConfig
    res = LLM(out, max_batch=1, max_seq=32).generate(
        [[1, 5, 9]], max_new_tokens=4,
        sampler=SamplerConfig(temperature=0.0), stop_at_eos=False)
    assert len(res[0].token_ids) == 4


def _add_moe_tensors(t, rng, mixtral, n_exp=4):
    """Swap the dense FFN tensors for routed-expert stacks (HF naming)."""
    s = 0.5 / np.sqrt(DIM)
    w = lambda *shape: (rng.standard_normal(shape) * s).astype(np.float32)
    for i in range(LAYERS):
        p = f"model.layers.{i}."
        for k in ("mlp.gate_proj.weight", "mlp.up_proj.weight",
                  "mlp.down_proj.weight"):
            t.pop(p + k, None)
        if mixtral:
            t[p + "block_sparse_moe.gate.weight"] = w(n_exp, DIM) * 3
            for e in range(n_exp):
                ep = p + f"block_sparse_moe.experts.{e}."
                t[ep + "w1.weight"] = w(FFN, DIM)
                t[ep + "w3.weight"] = w(FFN, DIM)
                t[ep + "w2.weight"] = w(DIM, FFN)
        else:
            t[p + "mlp.gate.weight"] = w(n_exp, DIM) * 3
            for e in range(n_exp):
                ep = p + f"mlp.experts.{e}."
                t[ep + "gate_proj.weight"] = w(FFN, DIM)
                t[ep + "up_proj.weight"] = w(FFN, DIM)
                t[ep + "down_proj.weight"] = w(DIM, FFN)


@pytest.mark.parametrize("model_type", ["mixtral", "qwen3_moe"])
def test_convert_moe(tmp_path, model_type):
    """MoE conversion: HF per-expert tensors stack to the 3-D GGUF expert
    tensors (mixtral w1/w3/w2 and qwen3_moe gate/up/down naming), the
    router becomes ffn_gate_inp, and the converted checkpoint serves."""
    from gguf_tpu.gguf import GGUFReader

    mixtral = model_type == "mixtral"
    d, t = _make_hf_dir(tmp_path, model_type=model_type, seed=11)
    rng = np.random.default_rng(12)
    _add_moe_tensors(t, rng, mixtral)
    if not mixtral:   # qwen3 family: per-head qk-norm
        for i in range(LAYERS):
            p = f"model.layers.{i}."
            t[p + "self_attn.q_norm.weight"] = \
                (1 + 0.1 * rng.standard_normal(HD)).astype(np.float32)
            t[p + "self_attn.k_norm.weight"] = \
                (1 + 0.1 * rng.standard_normal(HD)).astype(np.float32)
    _write_safetensors(str(tmp_path / "hf" / "model.safetensors"), t)
    cfgp = json.loads((tmp_path / "hf" / "config.json").read_text())
    cfgp.update({"num_local_experts": 4, "num_experts_per_tok": 2,
                 "moe_intermediate_size": FFN})
    (tmp_path / "hf" / "config.json").write_text(json.dumps(cfgp))

    out = str(tmp_path / "moe.gguf")
    md = convert_hf(d, out, fmt="q8_0")
    arch = md["general.architecture"]
    assert arch == ("llama" if mixtral else "qwen3moe")
    assert md[f"{arch}.expert_count"] == 4
    assert md[f"{arch}.expert_used_count"] == 2

    # expert stacking fidelity: dequantized expert e == HF tensor (q8_0)
    r = GGUFReader(out)
    g3 = r.dequantize("blk.0.ffn_gate_exps.weight")
    hf_g = (t["model.layers.0.block_sparse_moe.experts.2.w1.weight"]
            if mixtral
            else t["model.layers.0.mlp.experts.2.gate_proj.weight"])
    assert np.max(np.abs(g3[2] - hf_g)) < 0.01 * np.abs(hf_g).max() + 2e-3
    router = r.load_array("blk.0.ffn_gate_inp.weight")
    hf_r = (t["model.layers.0.block_sparse_moe.gate.weight"] if mixtral
            else t["model.layers.0.mlp.gate.weight"])
    np.testing.assert_allclose(router, hf_r, rtol=0, atol=0)
    r.close()

    cfg, params = load_llama(out)
    assert cfg.n_experts == 4 and cfg.n_experts_used == 2
    assert cfg.rope_neox == (not mixtral)
    if not mixtral:
        assert "q_norm" in params["layers"][0]
    cache = init_kv_cache(cfg, batch=1, max_seq=16)
    logits, _ = forward(params, cfg, jnp.asarray([[1, 5, 9]], jnp.int32),
                        jnp.zeros(1, jnp.int32), cache,
                        opts=MMOpts(precision="high"))
    assert np.isfinite(np.asarray(logits)).all()


def _make_ds2_hf_dir(tmp_path, *, lite=False, seed=21):
    """Tiny deepseek_v2/v3-shaped HF dir: MLA attention, first_k_dense=1,
    routed + shared experts (V3 adds sigmoid scoring + selection bias)."""
    rng = np.random.default_rng(seed)
    d = tmp_path / "hf"
    d.mkdir(exist_ok=True)
    nope, rd, vd, rank, qrank, n_exp = 16, 16, 32, 64, 96, 4
    cfg = {"model_type": "deepseek_v2" if lite else "deepseek_v3",
           "vocab_size": VOCAB, "hidden_size": DIM,
           "num_hidden_layers": LAYERS, "num_attention_heads": HEADS,
           "num_key_value_heads": HEADS, "intermediate_size": FFN,
           "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
           "max_position_embeddings": 64,
           "qk_nope_head_dim": nope, "qk_rope_head_dim": rd,
           "v_head_dim": vd, "kv_lora_rank": rank,
           "q_lora_rank": None if lite else qrank,
           "n_routed_experts": n_exp, "num_experts_per_tok": 2,
           "moe_intermediate_size": FFN, "first_k_dense_replace": 1,
           "n_shared_experts": 1, "routed_scaling_factor": 2.0,
           "norm_topk_prob": not lite,
           "scoring_func": "softmax" if lite else "sigmoid"}
    (d / "config.json").write_text(json.dumps(cfg))
    (d / "tokenizer.json").write_text(json.dumps(_toy_unigram_tokenizer()))
    s = 0.5 / np.sqrt(DIM)
    w = lambda *shape: (rng.standard_normal(shape) * s).astype(np.float32)
    nrm = lambda n: (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    t = {"model.embed_tokens.weight": w(VOCAB, DIM),
         "model.norm.weight": nrm(DIM), "lm_head.weight": w(VOCAB, DIM)}
    for i in range(LAYERS):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = nrm(DIM)
        t[p + "post_attention_layernorm.weight"] = nrm(DIM)
        if lite:
            t[p + "self_attn.q_proj.weight"] = w(HEADS * (nope + rd), DIM)
        else:
            t[p + "self_attn.q_a_proj.weight"] = w(qrank, DIM)
            t[p + "self_attn.q_a_layernorm.weight"] = nrm(qrank)
            t[p + "self_attn.q_b_proj.weight"] = w(HEADS * (nope + rd),
                                                   qrank)
        t[p + "self_attn.kv_a_proj_with_mqa.weight"] = w(rank + rd, DIM)
        t[p + "self_attn.kv_a_layernorm.weight"] = nrm(rank)
        t[p + "self_attn.kv_b_proj.weight"] = w(HEADS * (nope + vd), rank)
        t[p + "self_attn.o_proj.weight"] = w(DIM, HEADS * vd)
        if i == 0:   # leading dense layer
            t[p + "mlp.gate_proj.weight"] = w(FFN, DIM)
            t[p + "mlp.up_proj.weight"] = w(FFN, DIM)
            t[p + "mlp.down_proj.weight"] = w(DIM, FFN)
        else:
            t[p + "mlp.gate.weight"] = w(n_exp, DIM) * 3
            if not lite:
                t[p + "mlp.gate.e_score_correction_bias"] = \
                    (0.1 * rng.standard_normal(n_exp)).astype(np.float32)
            for e in range(n_exp):
                ep = p + f"mlp.experts.{e}."
                t[ep + "gate_proj.weight"] = w(FFN, DIM)
                t[ep + "up_proj.weight"] = w(FFN, DIM)
                t[ep + "down_proj.weight"] = w(DIM, FFN)
            sp = p + "mlp.shared_experts."
            t[sp + "gate_proj.weight"] = w(FFN, DIM)
            t[sp + "up_proj.weight"] = w(FFN, DIM)
            t[sp + "down_proj.weight"] = w(DIM, FFN)
    _write_safetensors(str(d / "model.safetensors"), t)
    return str(d), t, cfg


def _hf_ds2_reference(t, hf, tokens):
    """HF modeling_deepseek forward in numpy: naive MLA (per-head K/V
    from kv_b), HF rope = un-interleave THEN rotate-half — i.e. the
    stored layout is interleaved, which is what the converted GGUF must
    preserve for ROPE_TYPE_NORM serving."""
    b, T = tokens.shape
    nope, rd = hf["qk_nope_head_dim"], hf["qk_rope_head_dim"]
    vd, rank = hf["v_head_dim"], hf["kv_lora_rank"]
    n_exp, k_used = hf["n_routed_experts"], hf["num_experts_per_tok"]
    x = t["model.embed_tokens.weight"][tokens.reshape(-1)].reshape(
        b, T, DIM)

    def rmsn(v, wt):
        return v / np.sqrt(np.mean(v * v, -1, keepdims=True) + 1e-5) * wt

    inv = 10000.0 ** (-np.arange(0, rd, 2) / rd)
    ang = np.arange(T)[:, None] * inv[None, :]
    cos = np.concatenate([np.cos(ang), np.cos(ang)], -1)   # (T, rd)
    sin = np.concatenate([np.sin(ang), np.sin(ang)], -1)

    def rope(v):           # (b, T, H, rd), HF interleave trick
        d = v.shape[-1]
        v = np.concatenate([v[..., 0::2], v[..., 1::2]], -1)
        half = d // 2
        rot = np.concatenate([-v[..., half:], v[..., :half]], -1)
        return v * cos[None, :, None, :] + rot * sin[None, :, None, :]

    def silu_mlp(h, pfx):
        g = h @ t[pfx + "gate_proj.weight"].T
        u = h @ t[pfx + "up_proj.weight"].T
        return (g / (1 + np.exp(-g)) * u) @ t[pfx + "down_proj.weight"].T

    for i in range(LAYERS):
        p = f"model.layers.{i}."
        h = rmsn(x, t[p + "input_layernorm.weight"])
        if p + "self_attn.q_a_proj.weight" in t:
            qa = rmsn(h @ t[p + "self_attn.q_a_proj.weight"].T,
                      t[p + "self_attn.q_a_layernorm.weight"])
            q = qa @ t[p + "self_attn.q_b_proj.weight"].T
        else:
            q = h @ t[p + "self_attn.q_proj.weight"].T
        q = q.reshape(b, T, HEADS, nope + rd)
        q_nope, q_pe = q[..., :nope], rope(q[..., nope:])

        kv = h @ t[p + "self_attn.kv_a_proj_with_mqa.weight"].T
        c_kv = rmsn(kv[..., :rank],
                    t[p + "self_attn.kv_a_layernorm.weight"])
        k_pe = rope(kv[..., None, rank:])

        kvb = t[p + "self_attn.kv_b_proj.weight"].reshape(
            HEADS, nope + vd, rank)
        k_nope = np.einsum("btr,hdr->bthd", c_kv, kvb[:, :nope])
        v = np.einsum("btr,hdr->bthd", c_kv, kvb[:, nope:])
        kf = np.concatenate(
            [k_nope, np.broadcast_to(k_pe, (b, T, HEADS, rd))], -1)
        qf = np.concatenate([q_nope, q_pe], -1)
        sc = np.einsum("bqhd,bkhd->bhqk", qf, kf) / np.sqrt(nope + rd)
        mask = np.tril(np.ones((T, T), bool))
        sc = np.where(mask[None, None], sc, -np.inf)
        pr = np.exp(sc - sc.max(-1, keepdims=True))
        pr /= pr.sum(-1, keepdims=True)
        att = np.einsum("bhqk,bkhd->bqhd", pr, v).reshape(b, T, HEADS * vd)
        x = x + att @ t[p + "self_attn.o_proj.weight"].T

        h = rmsn(x, t[p + "post_attention_layernorm.weight"])
        if p + "mlp.gate.weight" in t:
            hf2 = h.reshape(b * T, DIM)
            logits = hf2 @ t[p + "mlp.gate.weight"].T
            if hf["scoring_func"] == "sigmoid":
                probs = 1 / (1 + np.exp(-logits))
            else:
                pe = np.exp(logits - logits.max(-1, keepdims=True))
                probs = pe / pe.sum(-1, keepdims=True)
            selsc = probs
            if p + "mlp.gate.e_score_correction_bias" in t:
                selsc = probs + t[p + "mlp.gate.e_score_correction_bias"]
            order = np.argsort(-selsc, -1)[:, :k_used]
            wts = np.zeros_like(probs)
            np.put_along_axis(wts, order,
                              np.take_along_axis(probs, order, -1), -1)
            if hf["norm_topk_prob"]:
                wts /= wts.sum(-1, keepdims=True)
            wts *= hf["routed_scaling_factor"]
            out = np.zeros_like(hf2)
            for e in range(n_exp):
                out += wts[:, e:e + 1] * silu_mlp(
                    hf2, p + f"mlp.experts.{e}.")
            out += silu_mlp(hf2, p + "mlp.shared_experts.")
            x = x + out.reshape(b, T, DIM)
        else:
            x = x + silu_mlp(h, p + "mlp.")

    x = rmsn(x, t["model.norm.weight"])
    return x @ t["lm_head.weight"].T


@pytest.mark.parametrize("lite", [True, False])
def test_convert_deepseek2_matches_hf_reference(tmp_path, lite):
    """deepseek_v2 (Lite: direct q, softmax router) and deepseek_v3
    (q_lora, sigmoid + bias routing) convert and serve to match the HF
    numpy forward — pins the MLA tensor mapping AND the interleaved
    (ROPE_TYPE_NORM) rope convention across conversion."""
    d, t, hf = _make_ds2_hf_dir(tmp_path, lite=lite)
    out = str(tmp_path / "ds2.gguf")
    md = convert_hf(d, out, fmt="q8_0")
    assert md["general.architecture"] == "deepseek2"
    assert md["deepseek2.attention.kv_lora_rank"] == 64
    assert md["deepseek2.rope.dimension_count"] == 16
    assert md["deepseek2.attention.key_length"] == 32
    assert md["deepseek2.expert_gating_func"] == (1 if lite else 2)

    cfg, params = load_llama(out)
    assert cfg.kv_lora_rank == 64 and cfg.qk_rope_dim == 16
    assert not cfg.rope_neox
    assert cfg.q_lora_rank == (0 if lite else 96)
    rng = np.random.default_rng(31)
    tokens = rng.integers(0, VOCAB, (1, 6)).astype(np.int32)
    cache = init_kv_cache(cfg, batch=1, max_seq=16)
    logits, _ = forward(params, cfg, jnp.asarray(tokens),
                        jnp.zeros(1, jnp.int32), cache,
                        opts=MMOpts(precision="high"))
    ref = _hf_ds2_reference(t, hf, tokens)
    got = np.asarray(logits)
    denom = np.abs(ref).max()
    # 3.5%: the budget is q8_0 quantization error vs the UNQUANTIZED HF
    # reference; the q8_0 plane layout's reordered K accumulation moved a
    # borderline 2.99% case to 3.01%, so the bound carries headroom for
    # benign f32 reassociation
    assert np.max(np.abs(got - ref)) / denom < 0.035, \
        np.max(np.abs(got - ref)) / denom


def _arch_hf_dir(tmp_path, model_type, seed=41):
    """Tiny HF dirs for cohere / olmo2 / starcoder2 / granite."""
    rng = np.random.default_rng(seed)
    d = tmp_path / "hf"
    d.mkdir(exist_ok=True)
    cfg = {"model_type": model_type, "vocab_size": VOCAB,
           "hidden_size": DIM, "num_hidden_layers": LAYERS,
           "num_attention_heads": HEADS, "num_key_value_heads": KV,
           "intermediate_size": FFN, "rope_theta": 10000.0,
           "max_position_embeddings": 64}
    s = 0.5 / np.sqrt(DIM)
    w = lambda *shape: (rng.standard_normal(shape) * s).astype(np.float32)
    nrm = lambda n: (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    t = {"model.embed_tokens.weight": w(VOCAB, DIM),
         "model.norm.weight": nrm(DIM), "lm_head.weight": w(VOCAB, DIM)}
    if model_type == "cohere":
        cfg.update({"layer_norm_eps": 1e-5, "logit_scale": 0.42})
    elif model_type == "olmo2":
        cfg["rms_norm_eps"] = 1e-5
    elif model_type == "starcoder2":
        cfg["norm_epsilon"] = 1e-5
        t["model.norm.bias"] = nrm(DIM) * 0.1
    elif model_type == "granite":
        cfg.update({"rms_norm_eps": 1e-5, "embedding_multiplier": 4.0,
                    "residual_multiplier": 0.5,
                    "attention_multiplier": 0.015625,
                    "logits_scaling": 8.0})
    for i in range(LAYERS):
        p = f"model.layers.{i}."
        t[p + "self_attn.q_proj.weight"] = w(HEADS * HD, DIM)
        t[p + "self_attn.k_proj.weight"] = w(KV * HD, DIM)
        t[p + "self_attn.v_proj.weight"] = w(KV * HD, DIM)
        t[p + "self_attn.o_proj.weight"] = w(DIM, HEADS * HD)
        if model_type == "cohere":
            t[p + "input_layernorm.weight"] = nrm(DIM)
        elif model_type == "olmo2":
            t[p + "post_attention_layernorm.weight"] = nrm(DIM)
            t[p + "post_feedforward_layernorm.weight"] = nrm(DIM)
            t[p + "self_attn.q_norm.weight"] = nrm(HEADS * HD)
            t[p + "self_attn.k_norm.weight"] = nrm(KV * HD)
        else:
            t[p + "input_layernorm.weight"] = nrm(DIM)
            t[p + "post_attention_layernorm.weight"] = nrm(DIM)
        if model_type == "starcoder2":
            t[p + "input_layernorm.bias"] = nrm(DIM) * 0.1
            t[p + "post_attention_layernorm.bias"] = nrm(DIM) * 0.1
            t[p + "self_attn.q_proj.bias"] = nrm(HEADS * HD) * 0.1
            t[p + "self_attn.k_proj.bias"] = nrm(KV * HD) * 0.1
            t[p + "self_attn.v_proj.bias"] = nrm(KV * HD) * 0.1
            t[p + "self_attn.o_proj.bias"] = nrm(DIM) * 0.1
            t[p + "mlp.c_fc.weight"] = w(FFN, DIM)
            t[p + "mlp.c_fc.bias"] = nrm(FFN) * 0.1
            t[p + "mlp.c_proj.weight"] = w(DIM, FFN)
            t[p + "mlp.c_proj.bias"] = nrm(DIM) * 0.1
        else:
            t[p + "mlp.gate_proj.weight"] = w(FFN, DIM)
            t[p + "mlp.up_proj.weight"] = w(FFN, DIM)
            t[p + "mlp.down_proj.weight"] = w(DIM, FFN)
    (d / "config.json").write_text(json.dumps(cfg))
    (d / "tokenizer.json").write_text(json.dumps(_toy_unigram_tokenizer()))
    _write_safetensors(str(d / "model.safetensors"), t)
    return str(d), t


@pytest.mark.parametrize("model_type,arch", [
    ("cohere", "command-r"), ("olmo2", "olmo2"),
    ("starcoder2", "starcoder2"), ("granite", "granite")])
def test_convert_arch_mapping(tmp_path, model_type, arch):
    """Tensor mapping + metadata for the round-2 arch additions: granite
    permutes q/k like llama (NORM rope on a rotate-half checkpoint),
    cohere does NOT (already interleaved), olmo2 maps post-norms +
    whole-vector qk-norms, starcoder2 carries every bias."""
    from gguf_tpu.gguf import GGUFReader

    d, t = _arch_hf_dir(tmp_path, model_type)
    out = str(tmp_path / "m.gguf")
    md = convert_hf(d, out, fmt="q8_0")
    assert md["general.architecture"] == arch

    r = GGUFReader(out)
    hf_q = t["model.layers.0.self_attn.q_proj.weight"]
    got_q = r.dequantize("blk.0.attn_q.weight")
    tol = 0.01 * np.abs(hf_q).max() + 2e-3
    if arch == "granite":   # permuted to interleaved order
        assert np.max(np.abs(got_q - permute_rope(hf_q, HEADS))) < tol
        assert md["granite.residual_scale"] == 0.5
        assert md["granite.attention.scale"] == 0.015625
        assert md["granite.logit_scale"] == 8.0
    else:                   # unpermuted
        assert np.max(np.abs(got_q - hf_q)) < tol
    if arch == "command-r":
        assert md["command-r.logit_scale"] == pytest.approx(0.42)
        assert "blk.0.ffn_norm.weight" not in r.tensors
    if arch == "olmo2":
        assert "blk.0.attn_norm.weight" not in r.tensors
        assert r.load_array("blk.0.attn_q_norm.weight").shape == \
            (HEADS * HD,)
        np.testing.assert_allclose(
            r.load_array("blk.0.post_attention_norm.weight"),
            t["model.layers.0.post_attention_layernorm.weight"])
    if arch == "starcoder2":
        np.testing.assert_allclose(
            r.load_array("blk.0.attn_norm.bias"),
            t["model.layers.0.input_layernorm.bias"])
        np.testing.assert_allclose(
            r.load_array("blk.0.ffn_up.bias"),
            t["model.layers.0.mlp.c_fc.bias"])
        assert "blk.0.ffn_gate.weight" not in r.tensors
    r.close()

    cfg, params = load_llama(out)
    cache = init_kv_cache(cfg, batch=1, max_seq=16)
    logits, _ = forward(params, cfg, jnp.asarray([[1, 5, 9]], jnp.int32),
                        jnp.zeros(1, jnp.int32), cache,
                        opts=MMOpts(precision="high"))
    assert np.isfinite(np.asarray(logits)).all()


def test_convert_mamba(tmp_path):
    """HF MambaForCausalLM (backbone.*) -> llama.cpp mamba schema: conv
    kernel reshapes (di,1,dc)->(di,dc), SSM tensors stay F32, in/out
    projections quantize, metadata carries the ssm geometry."""
    from gguf_tpu.gguf import GGUFReader

    rng = np.random.default_rng(51)
    d, di, ds, dc, layers = 64, 128, 16, 4, 2
    hf = {"model_type": "mamba", "vocab_size": VOCAB, "hidden_size": d,
          "num_hidden_layers": layers, "intermediate_size": di,
          "state_size": ds, "conv_kernel": dc, "time_step_rank": "auto",
          "layer_norm_epsilon": 1e-5}
    dr = 4   # ceil(64/16)
    s = 0.5 / np.sqrt(d)
    w = lambda *shape: (rng.standard_normal(shape) * s).astype(np.float32)
    nrm = lambda n: (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    t = {"backbone.embeddings.weight": w(VOCAB, d),
         "backbone.norm_f.weight": nrm(d),
         "lm_head.weight": w(VOCAB, d)}
    for i in range(layers):
        p = f"backbone.layers.{i}."
        t[p + "norm.weight"] = nrm(d)
        t[p + "mixer.in_proj.weight"] = w(2 * di, d)
        t[p + "mixer.conv1d.weight"] = w(di, 1, dc) * 3
        t[p + "mixer.conv1d.bias"] = nrm(di) * 0.1
        t[p + "mixer.x_proj.weight"] = w(dr + 2 * ds, di) * 2
        t[p + "mixer.dt_proj.weight"] = w(di, dr) * 4
        t[p + "mixer.dt_proj.bias"] = \
            rng.uniform(-4, -1, di).astype(np.float32)
        t[p + "mixer.A_log"] = \
            np.log(rng.uniform(0.5, 4.0, (di, ds))).astype(np.float32)
        t[p + "mixer.D"] = nrm(di)
        t[p + "mixer.out_proj.weight"] = w(d, di)
    hd_dir = tmp_path / "hf"
    hd_dir.mkdir()
    (hd_dir / "config.json").write_text(json.dumps(hf))
    (hd_dir / "tokenizer.json").write_text(
        json.dumps(_toy_unigram_tokenizer()))
    _write_safetensors(str(hd_dir / "model.safetensors"), t)

    out = str(tmp_path / "mamba.gguf")
    md = convert_hf(str(hd_dir), out, fmt="q8_0")
    assert md["general.architecture"] == "mamba"
    assert md["mamba.ssm.inner_size"] == di
    assert md["mamba.ssm.time_step_rank"] == dr
    assert md["mamba.attention.head_count"] == 0

    r = GGUFReader(out)
    np.testing.assert_allclose(
        r.load_array("blk.0.ssm_conv1d.weight"),
        t["backbone.layers.0.mixer.conv1d.weight"].reshape(di, dc))
    np.testing.assert_allclose(r.load_array("blk.0.ssm_a"),
                               t["backbone.layers.0.mixer.A_log"])
    r.close()

    cfg, params = load_llama(out)
    assert cfg.ssm_inner == di and cfg.ssm_dt_rank == dr
    cache = init_kv_cache(cfg, batch=1)
    logits, _ = forward(params, cfg, jnp.asarray([[1, 5, 9]], jnp.int32),
                        jnp.zeros(1, jnp.int32), cache,
                        opts=MMOpts(precision="high"))
    assert np.isfinite(np.asarray(logits)).all()


def test_convert_llama3_rope_freqs(tmp_path):
    """rope_scaling type 'llama3' bakes NTK-by-parts per-dim divisors
    into rope_freqs.weight (llama.cpp generate_extra_tensors math):
    fast dims stay 1.0, slow dims get the full factor, the crossover is
    smoothly interpolated — and the converted model serves with them."""
    import math

    d, t = _make_hf_dir(tmp_path, seed=61)
    cfgp = json.loads((tmp_path / "hf" / "config.json").read_text())
    cfgp["rope_scaling"] = {
        "rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
        "high_freq_factor": 4.0, "original_max_position_embeddings": 64}
    (tmp_path / "hf" / "config.json").write_text(json.dumps(cfgp))
    out = str(tmp_path / "l31.gguf")
    md = convert_hf(d, out, fmt="q8_0")
    assert "llama.rope.scaling.type" not in md   # factors carry it all

    from gguf_tpu.gguf import GGUFReader

    r = GGUFReader(out)
    facs = r.load_array("rope_freqs.weight")
    r.close()
    assert facs.shape == (HD // 2,)
    base, old_ctx = 10000.0, 64
    for i in range(0, HD, 2):
        wavelen = 2 * math.pi * base ** (i / HD)
        if wavelen < old_ctx / 4.0:
            assert facs[i // 2] == pytest.approx(1.0)
        elif wavelen > old_ctx / 1.0:
            assert facs[i // 2] == pytest.approx(8.0)
        else:
            assert 1.0 < facs[i // 2] < 8.0
    assert facs.max() == pytest.approx(8.0)   # slow dims hit the factor

    cfg, params = load_llama(out)
    assert cfg.rope_freq_factors is not None
    cache = init_kv_cache(cfg, batch=1, max_seq=16)
    logits, _ = forward(params, cfg, jnp.asarray([[1, 5, 9]], jnp.int32),
                        jnp.zeros(1, jnp.int32), cache,
                        opts=MMOpts(precision="high"))
    assert np.isfinite(np.asarray(logits)).all()


def test_convert_bert(tmp_path):
    """HF BertModel -> bert GGUF: WordPiece vocab mapping, LayerNorm/
    bias fidelity, causal=false + mean pooling metadata — and the result
    serves embeddings."""
    from gguf_tpu.engine import LLM

    rng = np.random.default_rng(71)
    d, f_, layers, vocab = 64, 128, 2, 48
    hf = {"model_type": "bert", "vocab_size": vocab, "hidden_size": d,
          "num_hidden_layers": layers, "num_attention_heads": 4,
          "intermediate_size": f_, "layer_norm_eps": 1e-12,
          "max_position_embeddings": 64}
    s = 0.5 / np.sqrt(d)
    w = lambda *sh: (rng.standard_normal(sh) * s).astype(np.float32)
    nrm = lambda n: (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    t = {"embeddings.word_embeddings.weight": w(vocab, d),
         "embeddings.token_type_embeddings.weight": w(2, d),
         "embeddings.position_embeddings.weight": w(64, d),
         "embeddings.LayerNorm.weight": nrm(d),
         "embeddings.LayerNorm.bias": w(d)}
    for i in range(layers):
        p = f"encoder.layer.{i}."
        for n_, shape in (("attention.self.query", (d, d)),
                          ("attention.self.key", (d, d)),
                          ("attention.self.value", (d, d)),
                          ("attention.output.dense", (d, d)),
                          ("intermediate.dense", (f_, d)),
                          ("output.dense", (d, f_))):
            t[p + n_ + ".weight"] = w(*shape)
            t[p + n_ + ".bias"] = w(shape[0])
        for n_ in ("attention.output.LayerNorm", "output.LayerNorm"):
            t[p + n_ + ".weight"] = nrm(d)
            t[p + n_ + ".bias"] = w(d)
    wp_vocab = {"[PAD]": 0, "[UNK]": 1, "[CLS]": 2, "[SEP]": 3,
                "hello": 4, "world": 5, "##ing": 6}
    for i in range(7, vocab):
        wp_vocab[f"tok{i}"] = i
    hd_dir = tmp_path / "hf"
    hd_dir.mkdir()
    (hd_dir / "config.json").write_text(json.dumps(hf))
    (hd_dir / "tokenizer.json").write_text(json.dumps(
        {"model": {"type": "WordPiece", "vocab": wp_vocab}}))
    _write_safetensors(str(hd_dir / "model.safetensors"), t)

    out = str(tmp_path / "bert.gguf")
    md = convert_hf(str(hd_dir), out, fmt="q8_0")
    assert md["bert.attention.causal"] is False
    assert md["bert.pooling_type"] == 1
    assert md["tokenizer.ggml.model"] == "bert"
    assert md["tokenizer.ggml.cls_token_id"] == 2

    from gguf_tpu.gguf import GGUFReader

    r = GGUFReader(out)
    np.testing.assert_allclose(
        r.load_array("blk.0.attn_output_norm.bias"),
        t["encoder.layer.0.attention.output.LayerNorm.bias"])
    r.close()

    llm = LLM(out, max_batch=2)
    assert not llm.cfg.causal and llm.cfg.pooling == "mean"
    emb = llm.embed(["hello world"])
    assert emb.shape == (1, d) and np.isfinite(emb).all()


def test_convert_t5(tmp_path):
    """HF T5 (gated v1.1 layout) -> t5 GGUF: enc/dec tensor tree,
    block-0 relative bias, untied head — and the result generates."""
    from gguf_tpu.engine import LLM, SamplerConfig

    rng = np.random.default_rng(81)
    d, dkv, h, f_, layers, vocab, nb = 64, 16, 4, 128, 2, 64, 8
    hf = {"model_type": "t5", "vocab_size": vocab, "d_model": d,
          "d_kv": dkv, "d_ff": f_, "num_layers": layers,
          "num_decoder_layers": layers, "num_heads": h,
          "relative_attention_num_buckets": nb,
          "layer_norm_epsilon": 1e-6, "decoder_start_token_id": 0,
          "n_positions": 64}
    s = 0.5 / np.sqrt(d)
    w = lambda *sh: (rng.standard_normal(sh) * s).astype(np.float32)
    nrm = lambda n: (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    t = {"shared.weight": w(vocab, d) * 4,
         "encoder.final_layer_norm.weight": nrm(d),
         "decoder.final_layer_norm.weight": nrm(d),
         "lm_head.weight": w(vocab, d)}
    for pre, n_l, cross in (("encoder", layers, False),
                            ("decoder", layers, True)):
        for i in range(n_l):
            p = f"{pre}.block.{i}."
            for hn in "qkv":
                t[p + f"layer.0.SelfAttention.{hn}.weight"] = w(h * dkv, d)
            t[p + "layer.0.SelfAttention.o.weight"] = w(d, h * dkv)
            t[p + "layer.0.layer_norm.weight"] = nrm(d)
            if i == 0:
                t[p + "layer.0.SelfAttention.relative_attention_bias"
                  ".weight"] = (rng.standard_normal((nb, h)) * 0.5
                                ).astype(np.float32)
            fl = "layer.2." if cross else "layer.1."
            if cross:
                for hn in "qkv":
                    t[p + f"layer.1.EncDecAttention.{hn}.weight"] = \
                        w(h * dkv, d)
                t[p + "layer.1.EncDecAttention.o.weight"] = w(d, h * dkv)
                t[p + "layer.1.layer_norm.weight"] = nrm(d)
            t[p + fl + "DenseReluDense.wi_0.weight"] = w(f_, d)
            t[p + fl + "DenseReluDense.wi_1.weight"] = w(f_, d)
            t[p + fl + "DenseReluDense.wo.weight"] = w(d, f_)
            t[p + fl + "layer_norm.weight"] = nrm(d)
    hd_dir = tmp_path / "hf"
    hd_dir.mkdir()
    (hd_dir / "config.json").write_text(json.dumps(hf))
    vocab_l = [["<pad>", 0.0], ["</s>", 0.0], ["<unk>", 0.0]]
    vocab_l += [[f"w{i}", -float(i)] for i in range(vocab - 3)]
    (hd_dir / "tokenizer.json").write_text(json.dumps(
        {"model": {"type": "Unigram", "vocab": vocab_l}}))
    _write_safetensors(str(hd_dir / "model.safetensors"), t)

    out = str(tmp_path / "t5.gguf")
    md = convert_hf(str(hd_dir), out, fmt="q8_0")
    assert md["general.architecture"] == "t5"
    assert md["t5.attention.key_length"] == dkv
    assert md["t5.attention.relative_buckets_count"] == nb

    from gguf_tpu.gguf import GGUFReader

    r = GGUFReader(out)
    np.testing.assert_allclose(
        r.load_array("enc.blk.0.attn_rel_b.weight"),
        t["encoder.block.0.layer.0.SelfAttention"
          ".relative_attention_bias.weight"])
    assert "dec.blk.0.cross_attn_q.weight" in r.tensors
    assert "enc.blk.0.ffn_gate.weight" in r.tensors
    r.close()

    llm = LLM(out, max_batch=2, max_seq=64)
    assert llm.t5 and not llm.cfg.tied_head
    outs = llm.generate([[5, 9, 3, 1]], max_new_tokens=4,
                        sampler=SamplerConfig(temperature=0.0),
                        stop_at_eos=False)
    assert len(outs[0].token_ids) == 4


def test_convert_gemma3(tmp_path):
    """gemma3 (text or nested multimodal config): four-norm blocks,
    qk-norms with the gemma +1 bake, dual rope bases, 5:1 SWA metadata —
    and the converted model serves."""
    rng = np.random.default_rng(91)
    hd = 32
    inner = {"model_type": "gemma3_text", "vocab_size": VOCAB,
             "hidden_size": DIM, "num_hidden_layers": LAYERS,
             "num_attention_heads": HEADS, "num_key_value_heads": KV,
             "intermediate_size": FFN, "rms_norm_eps": 1e-6,
             "head_dim": hd, "rope_theta": 1000000.0,
             "rope_local_base_freq": 10000.0, "sliding_window": 16,
             "max_position_embeddings": 64}
    cfgj = {"model_type": "gemma3", "text_config": inner}
    s = 0.5 / np.sqrt(DIM)
    w = lambda *sh: (rng.standard_normal(sh) * s).astype(np.float32)
    nrm = lambda n: (0.1 * rng.standard_normal(n)).astype(np.float32)
    t = {"model.embed_tokens.weight": w(VOCAB, DIM),
         "model.norm.weight": nrm(DIM)}
    for i in range(LAYERS):
        p = f"model.layers.{i}."
        for n_ in ("input_layernorm", "post_attention_layernorm",
                   "pre_feedforward_layernorm",
                   "post_feedforward_layernorm"):
            t[p + n_ + ".weight"] = nrm(DIM)
        t[p + "self_attn.q_proj.weight"] = w(HEADS * hd, DIM)
        t[p + "self_attn.k_proj.weight"] = w(KV * hd, DIM)
        t[p + "self_attn.v_proj.weight"] = w(KV * hd, DIM)
        t[p + "self_attn.o_proj.weight"] = w(DIM, HEADS * hd)
        t[p + "self_attn.q_norm.weight"] = nrm(hd)
        t[p + "self_attn.k_norm.weight"] = nrm(hd)
        t[p + "mlp.gate_proj.weight"] = w(FFN, DIM)
        t[p + "mlp.up_proj.weight"] = w(FFN, DIM)
        t[p + "mlp.down_proj.weight"] = w(DIM, FFN)
    d = tmp_path / "hf"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(cfgj))
    (d / "tokenizer.json").write_text(json.dumps(_toy_unigram_tokenizer()))
    _write_safetensors(str(d / "model.safetensors"), t)

    out = str(tmp_path / "g3.gguf")
    md = convert_hf(str(d), out, fmt="q8_0")
    assert md["general.architecture"] == "gemma3"
    assert md["gemma3.attention.sliding_window"] == 16
    assert md["gemma3.rope.freq_base_swa"] == 10000.0
    assert md["gemma3.rope.freq_base"] == 1000000.0

    from gguf_tpu.gguf import GGUFReader

    r = GGUFReader(out)
    # +1 baked into every gemma norm, qk-norms included
    np.testing.assert_allclose(
        r.load_array("blk.0.attn_q_norm.weight"),
        t["model.layers.0.self_attn.q_norm.weight"] + 1.0, rtol=1e-6)
    np.testing.assert_allclose(
        r.load_array("blk.0.post_ffw_norm.weight"),
        t["model.layers.0.post_feedforward_layernorm.weight"] + 1.0,
        rtol=1e-6)
    r.close()

    cfg, params = load_llama(out)
    assert cfg.swa_pattern == 6 and cfg.rope_theta_swa == 10000.0
    cache = init_kv_cache(cfg, batch=1, max_seq=16)
    logits, _ = forward(params, cfg, jnp.asarray([[1, 5, 9]], jnp.int32),
                        jnp.zeros(1, jnp.int32), cache,
                        opts=MMOpts(precision="high"))
    assert np.isfinite(np.asarray(logits)).all()


def test_convert_phi2(tmp_path):
    """HF phi (phi-2) -> arch phi2: q/k/v fuse into attn_qkv (+bias),
    dense/fc1/fc2 map with biases, biased LayerNorms, partial rotary
    dimension — and the converted model serves."""
    rng = np.random.default_rng(95)
    hf = {"model_type": "phi", "vocab_size": VOCAB, "hidden_size": DIM,
          "num_hidden_layers": LAYERS, "num_attention_heads": HEADS,
          "intermediate_size": FFN, "layer_norm_eps": 1e-5,
          "partial_rotary_factor": 0.5,
          "max_position_embeddings": 64}
    s = 0.5 / np.sqrt(DIM)
    w = lambda *sh: (rng.standard_normal(sh) * s).astype(np.float32)
    nrm = lambda n: (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    t = {"model.embed_tokens.weight": w(VOCAB, DIM),
         "model.final_layernorm.weight": nrm(DIM),
         "model.final_layernorm.bias": w(DIM),
         "lm_head.weight": w(VOCAB, DIM), "lm_head.bias": w(VOCAB)}
    for i in range(LAYERS):
        p = f"model.layers.{i}."
        t[p + "input_layernorm.weight"] = nrm(DIM)
        t[p + "input_layernorm.bias"] = w(DIM)
        for n_ in ("q_proj", "k_proj", "v_proj"):
            t[p + f"self_attn.{n_}.weight"] = w(DIM, DIM)
            t[p + f"self_attn.{n_}.bias"] = w(DIM)
        t[p + "self_attn.dense.weight"] = w(DIM, DIM)
        t[p + "self_attn.dense.bias"] = w(DIM)
        t[p + "mlp.fc1.weight"] = w(FFN, DIM)
        t[p + "mlp.fc1.bias"] = w(FFN)
        t[p + "mlp.fc2.weight"] = w(DIM, FFN)
        t[p + "mlp.fc2.bias"] = w(DIM)
    d = tmp_path / "hf"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(hf))
    (d / "tokenizer.json").write_text(json.dumps(_toy_unigram_tokenizer()))
    _write_safetensors(str(d / "model.safetensors"), t)

    out = str(tmp_path / "phi2.gguf")
    md = convert_hf(str(d), out, fmt="q8_0")
    assert md["general.architecture"] == "phi2"
    assert md["phi2.rope.dimension_count"] == HD // 2

    from gguf_tpu.gguf import GGUFReader

    r = GGUFReader(out)
    qkv_b = r.load_array("blk.0.attn_qkv.bias")
    np.testing.assert_allclose(
        qkv_b, np.concatenate([t["model.layers.0.self_attn.q_proj.bias"],
                               t["model.layers.0.self_attn.k_proj.bias"],
                               t["model.layers.0.self_attn.v_proj.bias"]]))
    r.close()

    cfg, params = load_llama(out)
    assert cfg.parallel_residual and cfg.norm_type == "layer"
    assert cfg.rope_dim == HD // 2
    cache = init_kv_cache(cfg, batch=1, max_seq=16)
    logits, _ = forward(params, cfg, jnp.asarray([[1, 5, 9]], jnp.int32),
                        jnp.zeros(1, jnp.int32), cache,
                        opts=MMOpts(precision="high"))
    assert np.isfinite(np.asarray(logits)).all()


def test_convert_gpt2(tmp_path):
    """HF gpt2 (Conv1D transposed weights, wte/wpe, h.N.* names) maps to
    arch gpt2: transposition applied, positions preserved, tied head —
    and the converted model serves."""
    rng = np.random.default_rng(99)
    n_embd, n_layer, n_head, n_inner = 64, 2, 4, 128
    hf = {"model_type": "gpt2", "vocab_size": VOCAB, "n_embd": n_embd,
          "n_layer": n_layer, "n_head": n_head, "n_inner": n_inner,
          "layer_norm_epsilon": 1e-5, "n_positions": 64}
    s = 0.5 / np.sqrt(n_embd)
    w = lambda *sh: (rng.standard_normal(sh) * s).astype(np.float32)
    nrm = lambda n: (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    t = {"transformer.wte.weight": w(VOCAB, n_embd),
         "transformer.wpe.weight": w(64, n_embd),
         "transformer.ln_f.weight": nrm(n_embd),
         "transformer.ln_f.bias": w(n_embd)}
    for i in range(n_layer):
        p = f"transformer.h.{i}."
        t[p + "ln_1.weight"] = nrm(n_embd)
        t[p + "ln_1.bias"] = w(n_embd)
        t[p + "ln_2.weight"] = nrm(n_embd)
        t[p + "ln_2.bias"] = w(n_embd)
        t[p + "attn.c_attn.weight"] = w(n_embd, 3 * n_embd)   # Conv1D!
        t[p + "attn.c_attn.bias"] = w(3 * n_embd)
        t[p + "attn.c_proj.weight"] = w(n_embd, n_embd)
        t[p + "attn.c_proj.bias"] = w(n_embd)
        t[p + "mlp.c_fc.weight"] = w(n_embd, n_inner)
        t[p + "mlp.c_fc.bias"] = w(n_inner)
        t[p + "mlp.c_proj.weight"] = w(n_inner, n_embd)
        t[p + "mlp.c_proj.bias"] = w(n_embd)
    d = tmp_path / "hf"
    d.mkdir()
    (d / "config.json").write_text(json.dumps(hf))
    (d / "tokenizer.json").write_text(json.dumps(_toy_unigram_tokenizer()))
    _write_safetensors(str(d / "model.safetensors"), t)

    out = str(tmp_path / "g2.gguf")
    md = convert_hf(str(d), out, fmt="q8_0")
    assert md["general.architecture"] == "gpt2"

    from gguf_tpu.gguf import GGUFReader

    r = GGUFReader(out)
    got = r.dequantize("blk.0.attn_qkv.weight")
    want = t["transformer.h.0.attn.c_attn.weight"].T
    assert np.max(np.abs(got - want)) < 0.01 * np.abs(want).max() + 2e-3
    np.testing.assert_allclose(r.load_array("position_embd.weight"),
                               t["transformer.wpe.weight"])
    assert "output.weight" not in r.tensors       # tied head
    r.close()

    cfg, params = load_llama(out)
    assert cfg.learned_pos
    cache = init_kv_cache(cfg, batch=1, max_seq=16)
    logits, _ = forward(params, cfg, jnp.asarray([[1, 5, 9]], jnp.int32),
                        jnp.zeros(1, jnp.int32), cache,
                        opts=MMOpts(precision="high"))
    assert np.isfinite(np.asarray(logits)).all()
