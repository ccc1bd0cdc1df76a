"""End-to-end model tests: GGUF checkpoint -> decoder forward on the MMQ
kernels, against a pure-numpy float reference built from the DEQUANTIZED
weights (so the only allowed divergence is kernel arithmetic, not
quantization noise)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gguf_tpu.gguf import GGMLType, GGUFReader
from gguf_tpu.models import (
    LlamaConfig, MMOpts, forward, init_kv_cache, load_llama,
    write_random_llama_gguf,
)

# dim/ffn must be multiples of 256 (the K-quant superblock spans a weight row)
CFG = LlamaConfig(
    vocab_size=256, dim=256, n_layers=2, n_heads=4, n_kv_heads=2,
    ffn_dim=512, max_seq_len=64,
)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("m") / "tiny.gguf")
    write_random_llama_gguf(path, CFG, fmt=GGMLType.Q4_K, seed=1)
    cfg, params = load_llama(path)
    return path, cfg, params


def _numpy_reference(path, cfg, tokens):
    """Float reference forward from dequantized weights, numpy only."""
    r = GGUFReader(path)
    deq = lambda n: r.dequantize(n)
    b, t = tokens.shape
    x = deq("token_embd.weight")[tokens.reshape(-1)].reshape(b, t, cfg.dim)

    def rmsn(x, w):
        return x / np.sqrt(np.mean(x * x, axis=-1, keepdims=True) + cfg.norm_eps) * w

    hd = cfg.head_dim
    pos = np.arange(t)
    freqs = cfg.rope_theta ** (-np.arange(0, hd, 2) / hd)
    ang = pos[:, None] * freqs[None, :]
    cos, sin = np.cos(ang), np.sin(ang)

    def rope(x):  # (B, T, H, hd), consecutive pairs
        x2 = x.reshape(*x.shape[:-1], -1, 2)
        e, o = x2[..., 0], x2[..., 1]
        c = cos[None, :, None, :]
        s = sin[None, :, None, :]
        return np.stack([e * c - o * s, e * s + o * c], axis=-1).reshape(x.shape)

    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        h = rmsn(x, r.load_array(p + "attn_norm.weight"))
        q = (h @ deq(p + "attn_q.weight").T).reshape(b, t, cfg.n_heads, hd)
        k = (h @ deq(p + "attn_k.weight").T).reshape(b, t, cfg.n_kv_heads, hd)
        v = (h @ deq(p + "attn_v.weight").T).reshape(b, t, cfg.n_kv_heads, hd)
        q, k = rope(q), rope(k)
        rep = cfg.n_heads // cfg.n_kv_heads
        k = np.repeat(k, rep, axis=2)
        v = np.repeat(v, rep, axis=2)
        scores = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
        mask = np.tril(np.ones((t, t), bool))
        scores = np.where(mask[None, None], scores, -np.inf)
        probs = np.exp(scores - scores.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        att = np.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, -1)
        x = x + att @ deq(p + "attn_output.weight").T
        h = rmsn(x, r.load_array(p + "ffn_norm.weight"))
        g = h @ deq(p + "ffn_gate.weight").T
        u = h @ deq(p + "ffn_up.weight").T
        x = x + (g / (1 + np.exp(-g)) * u) @ deq(p + "ffn_down.weight").T

    x = rmsn(x, r.load_array("output_norm.weight"))
    logits = x @ deq("output.weight").T
    r.close()
    return logits


def test_forward_matches_numpy_reference(model):
    path, cfg, params = model
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    cache = init_kv_cache(cfg, batch=2, max_seq=32)
    logits, _ = forward(params, cfg, jnp.asarray(tokens),
                        jnp.zeros(2, jnp.int32), cache,
                        opts=MMOpts(precision="high"))
    ref = _numpy_reference(path, cfg, tokens)
    got = np.asarray(logits)
    assert got.shape == ref.shape
    # bf16 activations + softmax in different orders: modest tolerance
    denom = np.abs(ref).max()
    assert np.max(np.abs(got - ref)) / denom < 0.03, np.max(np.abs(got - ref)) / denom


@pytest.mark.slow
def test_prefill_equals_stepwise_decode(model):
    """One T=4 prefill must produce the same final logits as 4 sequential
    T=1 steps through the INT8 KV cache."""
    _, cfg, params = model
    rng = np.random.default_rng(1)
    tokens = jnp.asarray(rng.integers(0, cfg.vocab_size, (1, 4)).astype(np.int32))
    opts = MMOpts(precision="high")

    cache = init_kv_cache(cfg, batch=1, max_seq=16)
    logits_pre, _ = forward(params, cfg, tokens, jnp.zeros(1, jnp.int32), cache, opts)

    cache = init_kv_cache(cfg, batch=1, max_seq=16)
    outs = []
    for t in range(4):
        lg, cache = forward(params, cfg, tokens[:, t:t + 1],
                            jnp.full(1, t, jnp.int32), cache, opts)
        outs.append(np.asarray(lg[:, 0]))
    np.testing.assert_allclose(
        np.asarray(logits_pre[0, -1]), outs[-1][0], rtol=0, atol=2e-2)


@pytest.mark.slow
def test_per_slot_positions(model):
    """Continuous batching: two sequences at different depths in one batch."""
    _, cfg, params = model
    rng = np.random.default_rng(2)
    opts = MMOpts(precision="high")
    cache = init_kv_cache(cfg, batch=2, max_seq=16)
    # both slots prefill 3 tokens, then slot 0 advances one extra step so the
    # joint decode below runs with different per-slot positions [4, 3]
    pre = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 3)).astype(np.int32))
    _, cache = forward(params, cfg, pre, jnp.zeros(2, jnp.int32), cache, opts)
    toks = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 1)).astype(np.int32))
    lg0, cache = forward(params, cfg, toks, jnp.asarray([3, 3], jnp.int32), cache, opts)
    logits, _ = forward(params, cfg, toks, jnp.asarray([4, 3], jnp.int32), cache, opts)
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert np.isfinite(np.asarray(logits)).all()


@pytest.mark.slow
def test_float_fallback_weights(model):
    """Float (non-quantized) weight path through the same forward."""
    path, cfg, params = model
    r = GGUFReader(path)
    fparams = {
        "token_embd": jnp.asarray(r.dequantize("token_embd.weight")),
        "output": jnp.asarray(r.dequantize("output.weight")),
        "output_norm": jnp.asarray(r.load_array("output_norm.weight")),
        "layers": [],
    }
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        fparams["layers"].append({
            "attn_norm": jnp.asarray(r.load_array(p + "attn_norm.weight")),
            "ffn_norm": jnp.asarray(r.load_array(p + "ffn_norm.weight")),
            **{k: jnp.asarray(r.dequantize(p + n)) for k, n in [
                ("wq", "attn_q.weight"), ("wk", "attn_k.weight"),
                ("wv", "attn_v.weight"), ("wo", "attn_output.weight"),
                ("gate", "ffn_gate.weight"), ("up", "ffn_up.weight"),
                ("down", "ffn_down.weight")]},
        })
    r.close()
    tokens = jnp.asarray([[1, 2, 3]], jnp.int32)
    cache = init_kv_cache(cfg, batch=1, max_seq=8)
    lq, _ = forward(params, cfg, tokens, jnp.zeros(1, jnp.int32),
                    init_kv_cache(cfg, 1, 8), MMOpts(precision="high"))
    lf, _ = forward(fparams, cfg, tokens, jnp.zeros(1, jnp.int32), cache,
                    MMOpts(precision="high"))
    denom = float(jnp.abs(lf).max())
    assert float(jnp.abs(lq - lf).max()) / denom < 0.02


def test_fused_projections_match(model):
    """fuse_llama_params (QKV + gate/up concat along M) must not change a
    single logit: concat_m is a pure last-axis relayout of the SoA fields."""
    from gguf_tpu.models import fuse_llama_params

    rng = np.random.default_rng(7)
    _, cfg, params = model
    fused = fuse_llama_params(params)
    assert "wqkv" in fused["layers"][0] and "gate_up" in fused["layers"][0]

    tokens = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 3)), jnp.int32)
    pos = jnp.zeros(2, jnp.int32)
    # exact relayout contract: the fused and unfused parameterizations
    # run the identical op sequence
    opts = MMOpts(precision="high")
    out_a, _ = forward(params, cfg, tokens, pos,
                       init_kv_cache(cfg, 2, 16), opts)
    out_b, _ = forward(fused, cfg, tokens, pos,
                       init_kv_cache(cfg, 2, 16), opts)
    np.testing.assert_allclose(np.asarray(out_a), np.asarray(out_b),
                               rtol=0, atol=1e-5)


@pytest.mark.slow
def test_q5_k_m_checkpoint_forward(tmp_path):
    """Q5_K_M recipe end to end: q5_k body + q6_k head loads and decodes."""
    cfg = LlamaConfig(vocab_size=128, dim=256, n_layers=1, n_heads=4,
                      n_kv_heads=2, ffn_dim=512, max_seq_len=32)
    path = str(tmp_path / "q5.gguf")
    write_random_llama_gguf(path, cfg, fmt=GGMLType.Q5_K, seed=13)
    cfg2, params = load_llama(path)
    assert params["layers"][0]["wq"].fmt == "q5_k"
    assert params["output"].fmt == "q6_k"
    tokens = jnp.arange(6, dtype=jnp.int32).reshape(1, 6)
    logits, _ = forward(params, cfg2, tokens, jnp.zeros(1, jnp.int32),
                        init_kv_cache(cfg2, 1, 16), MMOpts(precision="high"))
    assert bool(jnp.isfinite(logits).all())
    # quantized-vs-float drift stays small on the same bits
    from gguf_tpu.quant.layouts import QuantTensor
    fl = jax.tree_util.tree_map(
        lambda w: w.dequantize() if isinstance(w, QuantTensor) else w,
        params, is_leaf=lambda x: isinstance(x, QuantTensor))
    ref, _ = forward(fl, cfg2, tokens, jnp.zeros(1, jnp.int32),
                     init_kv_cache(cfg2, 1, 16), MMOpts(precision="high"))
    # the float twin is the LESS precise path (linear() casts float weights
    # to the activations' bf16; the MMQ kernel dequantizes to f32), so the
    # gate here is bf16-level agreement
    err = float(jnp.max(jnp.abs(logits - ref)) / jnp.max(jnp.abs(ref)))
    assert err < 2e-2, err


def test_qwen2_style_qkv_biases(tmp_path):
    """Optional attn_{q,k,v}.bias tensors (Qwen2-family GGUFs) load and are
    applied — and survive QKV fusion."""
    from gguf_tpu.gguf.writer import quantize_tensor, write_gguf
    from gguf_tpu.models import fuse_llama_params

    cfg = LlamaConfig(vocab_size=64, dim=256, n_layers=1, n_heads=4,
                      n_kv_heads=2, ffn_dim=512, max_seq_len=32)
    rng = np.random.default_rng(0)
    d, f, v = cfg.dim, cfg.ffn_dim, cfg.vocab_size
    kv_d = cfg.n_kv_heads * cfg.head_dim
    w = lambda shape: (rng.standard_normal(shape) * 0.05).astype(np.float32)
    q4 = lambda shape: (GGMLType.Q4_K, shape, quantize_tensor(w(shape), GGMLType.Q4_K))
    f32 = lambda arr: (GGMLType.F32, arr.shape, arr)
    tensors = {
        "token_embd.weight": q4((v, d)),
        "output.weight": q4((v, d)),
        "output_norm.weight": f32(np.ones(d, np.float32)),
        "blk.0.attn_norm.weight": f32(np.ones(d, np.float32)),
        "blk.0.ffn_norm.weight": f32(np.ones(d, np.float32)),
        "blk.0.attn_q.weight": q4((d, d)),
        "blk.0.attn_k.weight": q4((kv_d, d)),
        "blk.0.attn_v.weight": q4((kv_d, d)),
        "blk.0.attn_q.bias": f32(w((d,))),
        "blk.0.attn_k.bias": f32(w((kv_d,))),
        "blk.0.attn_v.bias": f32(w((kv_d,))),
        "blk.0.attn_output.weight": q4((d, d)),
        "blk.0.ffn_gate.weight": q4((f, d)),
        "blk.0.ffn_up.weight": q4((f, d)),
        "blk.0.ffn_down.weight": q4((d, f)),
    }
    path = str(tmp_path / "qwen.gguf")
    write_gguf(path, cfg.to_gguf_metadata("qwen2"), tensors)
    cfg2, params = load_llama(path)
    assert "bq" in params["layers"][0]

    tokens = jnp.arange(4, dtype=jnp.int32).reshape(1, 4)
    # the exact QKV-fusion relayout contract
    opts = MMOpts(precision="high")
    out_a, _ = forward(params, cfg2, tokens, jnp.zeros(1, jnp.int32),
                       init_kv_cache(cfg2, 1, 16), opts)
    # fused path keeps the biases
    fused = fuse_llama_params(params)
    assert "bqkv" in fused["layers"][0]
    out_b, _ = forward(fused, cfg2, tokens, jnp.zeros(1, jnp.int32),
                       init_kv_cache(cfg2, 1, 16), opts)
    np.testing.assert_allclose(np.asarray(out_a), np.asarray(out_b), atol=1e-5)
    # biases actually matter: zeroing them changes the logits
    nob = {**params, "layers": [{k: v for k, v in params["layers"][0].items()
                                 if k not in ("bq", "bk", "bv")}]}
    out_c, _ = forward(nob, cfg2, tokens, jnp.zeros(1, jnp.int32),
                       init_kv_cache(cfg2, 1, 16), MMOpts(precision="high"))
    assert float(jnp.max(jnp.abs(out_a - out_c))) > 1e-3


def test_linear_rope_scaling_metadata(tmp_path):
    """rope.scaling.factor round-trips through GGUF and divides positions."""
    import dataclasses

    from gguf_tpu.models.llama import rope_cos_sin

    cfg = LlamaConfig(vocab_size=64, dim=256, n_layers=1, n_heads=4,
                      n_kv_heads=2, ffn_dim=512, rope_scale=4.0)
    md = cfg.to_gguf_metadata()
    assert md["llama.rope.scaling.factor"] == 4.0
    cfg2 = LlamaConfig.from_gguf_metadata(md)
    assert cfg2.rope_scale == 4.0
    # scaled position p behaves like unscaled p/scale
    pos = jnp.asarray([8], jnp.int32)
    c1, s1 = rope_cos_sin(pos, 64, 10000.0, scale=4.0)
    c2, s2 = rope_cos_sin(jnp.asarray([2], jnp.int32), 64, 10000.0)
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c2), atol=1e-6)
    np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), atol=1e-6)


def test_yarn_rope_properties():
    """YaRN NTK-by-parts (llama.cpp rope_yarn contract): fast-rotating dims
    keep extrapolated angles, slow dims get fully interpolated ones, both
    times mscale = attn_factor*(1 + 0.1 ln s); scale 1 degenerates to the
    unscaled rotation."""
    import math

    from gguf_tpu.models.llama import rope_cos_sin, yarn_corr_dims

    hd, theta, s, octx = 128, 10000.0, 4.0, 2048
    pos = jnp.asarray([1000], jnp.int32)
    cy, sy = rope_cos_sin(pos, hd, theta, s, kind="yarn", orig_ctx=octx)
    mscale = 1.0 + 0.1 * math.log(s)
    low, high = yarn_corr_dims(hd, octx, theta)
    assert 0 < low < high < hd
    freqs = theta ** (-np.arange(0, hd, 2, dtype=np.float32) / hd)
    ext = 1000.0 * freqs
    # dims with ramp == 1 (index <= low): pure extrapolation
    # f32 angle resolution at |angle| ~ 1e3 rad bounds cos/sin to ~1e-4
    fast = np.arange(hd // 2) <= int(np.floor(low))
    np.testing.assert_allclose(np.asarray(cy)[0][fast],
                               np.cos(ext[fast]) * mscale, atol=3e-4)
    # dims with ramp == 0 (index >= high): pure interpolation (pos / s)
    slow = np.arange(hd // 2) >= int(np.ceil(high))
    assert slow.any()
    np.testing.assert_allclose(np.asarray(sy)[0][slow],
                               np.sin(ext[slow] / s) * mscale, atol=3e-4)
    # scale 1 == plain rope (mscale = 1, interp == extrap)
    c1, s1 = rope_cos_sin(pos, hd, theta, 1.0, kind="yarn", orig_ctx=octx)
    c0, s0 = rope_cos_sin(pos, hd, theta)
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c0), atol=1e-6)
    np.testing.assert_allclose(np.asarray(s1), np.asarray(s0), atol=1e-6)


def test_rope_freq_factors():
    """rope_freqs divisors: factor f on dim i == evaluating that dim at
    pos/f (llama-3.1-style per-dimension long-context stretching)."""
    from gguf_tpu.models.llama import rope_cos_sin

    hd = 64
    ff = tuple(2.0 for _ in range(hd // 2))
    c1, s1 = rope_cos_sin(jnp.asarray([8], jnp.int32), hd, 10000.0,
                          freq_factors=ff)
    c2, s2 = rope_cos_sin(jnp.asarray([4], jnp.int32), hd, 10000.0)
    np.testing.assert_allclose(np.asarray(c1), np.asarray(c2), atol=1e-6)
    np.testing.assert_allclose(np.asarray(s1), np.asarray(s2), atol=1e-6)


def test_yarn_gguf_roundtrip_and_serving(tmp_path):
    """A yarn-scaled checkpoint with a rope_freqs tensor round-trips through
    GGUF metadata and serves: config restores the scheme, the forward pass
    produces finite logits, and yarn actually changes them vs linear."""
    import dataclasses

    from gguf_tpu.engine import LLM

    cfg = LlamaConfig(vocab_size=256, dim=256, n_layers=1, n_heads=4,
                      n_kv_heads=2, ffn_dim=512, max_seq_len=64,
                      rope_scale=4.0, rope_scaling_kind="yarn",
                      rope_orig_ctx=32, rope_attn_factor=1.0,
                      rope_freq_factors=tuple(
                          1.0 + 0.1 * i for i in range(32)))
    path = str(tmp_path / "yarn.gguf")
    write_random_llama_gguf(path, cfg, seed=11)
    cfg2, _ = load_llama(path)
    assert cfg2.rope_scaling_kind == "yarn"
    assert cfg2.rope_scale == 4.0 and cfg2.rope_orig_ctx == 32
    np.testing.assert_allclose(cfg2.rope_freq_factors,
                               cfg.rope_freq_factors, rtol=1e-6)

    llm = LLM(path)
    out = llm.generate([[3, 1, 4, 1, 5]], max_new_tokens=4)
    assert len(out[0].token_ids) == 4

    # yarn vs linear at the same factor must differ (the per-dim ramp and
    # mscale are real): rebuild the same weights with linear scaling
    path_lin = str(tmp_path / "lin.gguf")
    write_random_llama_gguf(
        path_lin, dataclasses.replace(cfg, rope_scaling_kind="linear",
                                      rope_orig_ctx=0,
                                      rope_freq_factors=None), seed=11)
    # token ids may collide on a tiny model; compare one forward's logits
    from gguf_tpu.models import MMOpts, forward, init_kv_cache
    cfg_y, p_y = load_llama(path)
    cfg_l, p_l = load_llama(path_lin)
    toks = jnp.asarray([[3, 1, 4, 1, 5]], jnp.int32)
    zero = jnp.zeros(1, jnp.int32)
    ly, _ = forward(p_y, cfg_y, toks, zero, init_kv_cache(cfg_y, 1, 16),
                    MMOpts(precision="high"))
    ll, _ = forward(p_l, cfg_l, toks, zero, init_kv_cache(cfg_l, 1, 16),
                    MMOpts(precision="high"))
    assert float(jnp.max(jnp.abs(ly - ll))) > 1e-4


def test_yarn_accuracy_gate_golden_vs_served(tmp_path):
    """The golden numpy decoder and the served path must agree on yarn
    numerics too (same gate as test_perplexity's accuracy gate, small)."""
    from gguf_tpu.eval.golden_decoder import golden_perplexity
    from gguf_tpu.eval.perplexity import perplexity_of_gguf
    from gguf_tpu.models import MMOpts

    cfg = LlamaConfig(vocab_size=128, dim=256, n_layers=1, n_heads=4,
                      n_kv_heads=2, ffn_dim=512, max_seq_len=64,
                      rope_scale=2.0, rope_scaling_kind="yarn",
                      rope_orig_ctx=32)
    path = str(tmp_path / "yarn_gate.gguf")
    write_random_llama_gguf(path, cfg, seed=12)
    rng = np.random.default_rng(5)
    ids = rng.integers(0, cfg.vocab_size, 48)
    ppl_golden = golden_perplexity(path, ids, window=16)
    ppl = perplexity_of_gguf(path, ids, window=16,
                             opts=MMOpts(act_quant=True, precision="high"))
    assert np.isfinite(ppl_golden)
    assert abs(ppl - ppl_golden) < 1e-2 * ppl_golden, (ppl, ppl_golden)


@pytest.mark.slow
def test_span_bound_matches_full_cache(model):
    """forward(span=...) must equal forward(span=None) exactly whenever
    every pos + T <= span: rows beyond span are causally masked to exact
    zeros, so reading them cannot change the result."""
    _, cfg, params = model
    rng = np.random.default_rng(9)
    b = 3
    opts = MMOpts(precision="high")
    cache0 = init_kv_cache(cfg, batch=b, max_seq=256)
    # depth-staggered slots, decode step (t=1) and short chunk (t=4)
    for t in (1, 4):
        tokens = jnp.asarray(
            rng.integers(0, cfg.vocab_size, (b, t)).astype(np.int32))
        pos = jnp.asarray([0, 17, 100], jnp.int32)
        full, cache_f = forward(params, cfg, tokens, pos, cache0, opts,
                                span=None)
        part, cache_p = forward(params, cfg, tokens, pos, cache0, opts,
                                span=128)
        np.testing.assert_allclose(np.asarray(full), np.asarray(part),
                                   rtol=0, atol=1e-6)
        # the inserted cache rows must also be identical
        for lf, lp in zip(cache_f, cache_p):
            for key in ("k", "v", "k_scale", "v_scale"):
                np.testing.assert_array_equal(np.asarray(lf[key]),
                                              np.asarray(lp[key]))


def test_long_span_xla_fallback_matches_pallas(model):
    """A decode step that reads only the first 128 cache rows (span 128)
    gives the logits and cache rows of the step over the whole 256-row
    cache."""
    _, cfg, params = model
    rng = np.random.default_rng(21)
    b = 2
    opts = MMOpts(precision="high")
    cache0 = init_kv_cache(cfg, batch=b, max_seq=256)
    tokens = jnp.asarray(
        rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32))
    pos = jnp.asarray([3, 40], jnp.int32)

    whole, cache_w = forward(params, cfg, tokens, pos, cache0, opts)
    part, cache_p = forward(params, cfg, tokens, pos, cache0, opts, span=128)

    np.testing.assert_allclose(np.asarray(part), np.asarray(whole),
                               rtol=0, atol=5e-4)
    for lp, lw in zip(cache_p, cache_w):
        for key in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(np.asarray(lp[key]),
                                          np.asarray(lw[key]))


def test_long_span_tiled_path_matches_pallas(model):
    """The same at bf16 operands ("fast"): a step over a 256-row span of a
    512-row cache matches the whole-cache step, and writes the same cache
    rows."""
    _, cfg, params = model
    rng = np.random.default_rng(33)
    b = 2
    opts = MMOpts(precision="fast")
    cache0 = init_kv_cache(cfg, batch=b, max_seq=512)
    tokens = jnp.asarray(
        rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32))
    pos = jnp.asarray([3, 200], jnp.int32)

    whole, cache_w = forward(params, cfg, tokens, pos, cache0, opts)
    part, cache_p = forward(params, cfg, tokens, pos, cache0, opts, span=256)

    whole, part = np.asarray(whole), np.asarray(part)
    assert np.abs(part - whole).max() <= 1e-3 * np.abs(whole).max()
    for lp, lw in zip(cache_p, cache_w):
        for key in ("k", "v", "k_scale", "v_scale"):
            np.testing.assert_array_equal(np.asarray(lp[key]),
                                          np.asarray(lw[key]))


def test_tied_embeddings_checkpoint(tmp_path):
    """Checkpoints without output.weight tie the LM head to token_embd:
    the loader must share ONE object (no double load/pad) and forward must
    produce logits = x @ token_embd^T."""
    from gguf_tpu.gguf import GGUFReader
    from gguf_tpu.gguf.writer import write_gguf

    src = str(tmp_path / "untied.gguf")
    write_random_llama_gguf(src, CFG, fmt=GGMLType.Q4_K, seed=23)
    # rewrite without output.weight
    tied_path = str(tmp_path / "tied.gguf")
    with GGUFReader(src) as r:
        tensors = {n: (r.tensors[n].ggml_type, r.tensors[n].shape,
                       np.array(r.tensor_bytes(n)))
                   for n in r.tensors if n != "output.weight"}
        write_gguf(tied_path, dict(r.metadata), tensors,
                   metadata_types=dict(r.metadata_types))

    cfg, params = load_llama(tied_path)
    assert params["output"] is params["token_embd"], "must share one object"

    cache = init_kv_cache(cfg, batch=1, max_seq=16)
    toks = jnp.asarray([[1, 5, 9]], jnp.int32)
    logits, _ = forward(params, cfg, toks, jnp.zeros(1, jnp.int32), cache,
                        MMOpts(precision="high"))
    assert np.isfinite(np.asarray(logits)).all()
    assert logits.shape == (1, 3, cfg.vocab_size)


def test_gemma_arch_forward_matches_numpy(tmp_path):
    """Gemma family (beyond the reference's scope): GGUF-contract semantics —
    sqrt(dim)-scaled embeddings (bf16-rounded scale, as served), tanh-approx
    GELU FFN, head_dim decoupled from dim/n_heads via attention.key_length.
    The (1+w) norm needs no switch: llama.cpp's converter bakes +1 into the
    stored norm weights, so plain RMSNorm is correct on GGUF bytes."""
    cfg0 = LlamaConfig(vocab_size=64, dim=512, n_layers=2, n_heads=4,
                       n_kv_heads=2, ffn_dim=256, max_seq_len=32,
                       head_dim_override=64)   # 4*64 != 512: decoupled
    path = str(tmp_path / "gemma.gguf")
    write_random_llama_gguf(path, cfg0, fmt=GGMLType.Q4_K, seed=13,
                            arch="gemma")
    cfg, params = load_llama(path)
    assert cfg.act_fn == "gelu_tanh" and cfg.head_dim == 64
    assert abs(cfg.embed_scale - np.sqrt(512)) < 1e-6

    rng = np.random.default_rng(3)
    tokens = rng.integers(0, cfg.vocab_size, (1, 5)).astype(np.int32)
    cache = init_kv_cache(cfg, batch=1, max_seq=16)
    logits, _ = forward(params, cfg, jnp.asarray(tokens),
                        jnp.zeros(1, jnp.int32), cache,
                        opts=MMOpts(precision="high"))
    got = np.asarray(logits)

    # numpy reference with gemma semantics
    r = GGUFReader(path)
    deq = lambda n: r.dequantize(n)
    b, t = tokens.shape
    hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    x = deq("token_embd.weight")[tokens.reshape(-1)].reshape(b, t, cfg.dim)
    x = x * np.float32(jnp.bfloat16(cfg.embed_scale))

    def rmsn(x, w):
        return x / np.sqrt(np.mean(x * x, -1, keepdims=True) + cfg.norm_eps) * w

    posn = np.arange(t)
    freqs = cfg.rope_theta ** (-np.arange(0, hd, 2) / hd)
    ang = posn[:, None] * freqs[None, :]
    cos, sin = np.cos(ang), np.sin(ang)

    def rope(xh):  # rotate-half: gemma/phi GGUFs keep the HF dim order
        half = xh.shape[-1] // 2
        c, s = cos[None, :, None, :], sin[None, :, None, :]
        x1, x2 = xh[..., :half], xh[..., half:]
        return np.concatenate([x1 * c - x2 * s, x1 * s + x2 * c], -1)

    def gelu_tanh(v):
        return 0.5 * v * (1 + np.tanh(np.sqrt(2 / np.pi) * (v + 0.044715 * v**3)))

    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        hx = rmsn(x, r.load_array(p + "attn_norm.weight"))
        q = (hx @ deq(p + "attn_q.weight").T).reshape(b, t, h, hd)
        k = (hx @ deq(p + "attn_k.weight").T).reshape(b, t, kvh, hd)
        v = (hx @ deq(p + "attn_v.weight").T).reshape(b, t, kvh, hd)
        q, k = rope(q), rope(k)
        rep = h // kvh
        k = np.repeat(k, rep, axis=2)
        v = np.repeat(v, rep, axis=2)
        scores = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
        mask = np.tril(np.ones((t, t), bool))
        scores = np.where(mask[None, None], scores, -np.inf)
        probs = np.exp(scores - scores.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        att = np.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, h * hd)
        x = x + att @ deq(p + "attn_output.weight").T
        hx = rmsn(x, r.load_array(p + "ffn_norm.weight"))
        g = hx @ deq(p + "ffn_gate.weight").T
        u = hx @ deq(p + "ffn_up.weight").T
        x = x + (gelu_tanh(g) * u) @ deq(p + "ffn_down.weight").T
    x = rmsn(x, r.load_array("output_norm.weight"))
    ref = x @ deq("output.weight").T
    r.close()

    denom = np.abs(ref).max()
    assert np.max(np.abs(got - ref)) / denom < 0.03, \
        np.max(np.abs(got - ref)) / denom


def test_phi2_arch_forward_matches_numpy(tmp_path):
    """Phi-2 family (beyond the reference's scope): biased LayerNorm,
    parallel attention+FFN residual off one shared pre-norm, partial
    rotary (rope_dim < head_dim), gateless tanh-GELU MLP with biases,
    biased LM head — checked against an independent numpy forward."""
    cfg0 = LlamaConfig(vocab_size=64, dim=512, n_layers=2, n_heads=4,
                       n_kv_heads=4, ffn_dim=512, max_seq_len=32,
                       rope_dim=32)
    path = str(tmp_path / "phi2.gguf")
    write_random_llama_gguf(path, cfg0, fmt=GGMLType.Q4_K, seed=7,
                            arch="phi2")
    cfg, params = load_llama(path)
    assert cfg.norm_type == "layer" and cfg.parallel_residual
    assert cfg.rope_dim == 32 and cfg.act_fn == "gelu_tanh"

    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (1, 6)).astype(np.int32)
    cache = init_kv_cache(cfg, batch=1, max_seq=16)
    logits, _ = forward(params, cfg, jnp.asarray(tokens),
                        jnp.zeros(1, jnp.int32), cache,
                        opts=MMOpts(precision="high"))
    got = np.asarray(logits)

    r = GGUFReader(path)
    deq = lambda n: r.dequantize(n)
    arr = lambda n: r.load_array(n).astype(np.float32)
    b, t = tokens.shape
    hd, h = cfg.head_dim, cfg.n_heads
    rd = cfg.rope_dim
    x = deq("token_embd.weight")[tokens.reshape(-1)].reshape(b, t, cfg.dim)

    def ln(x, w, bias):
        mu = x.mean(-1, keepdims=True)
        xc = x - mu
        return xc / np.sqrt((xc * xc).mean(-1, keepdims=True)
                            + cfg.norm_eps) * w + bias

    posn = np.arange(t)
    freqs = cfg.rope_theta ** (-np.arange(0, rd, 2) / rd)
    ang = posn[:, None] * freqs[None, :]
    cos, sin = np.cos(ang), np.sin(ang)

    def rope(xh):  # rotate-half over only the first rd dims of each head
        rot, rest = xh[..., :rd], xh[..., rd:]
        half = rd // 2
        c, s = cos[None, :, None, :], sin[None, :, None, :]
        x1, x2 = rot[..., :half], rot[..., half:]
        out = np.concatenate([x1 * c - x2 * s, x1 * s + x2 * c], -1)
        return np.concatenate([out, rest], -1)

    def gelu_tanh(v):
        return 0.5 * v * (1 + np.tanh(np.sqrt(2 / np.pi)
                                      * (v + 0.044715 * v ** 3)))

    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        hx = ln(x, arr(p + "attn_norm.weight"), arr(p + "attn_norm.bias"))
        qkv = hx @ deq(p + "attn_qkv.weight").T + arr(p + "attn_qkv.bias")
        q = qkv[..., :h * hd].reshape(b, t, h, hd)
        k = qkv[..., h * hd:2 * h * hd].reshape(b, t, h, hd)
        v = qkv[..., 2 * h * hd:].reshape(b, t, h, hd)
        q, k = rope(q), rope(k)
        scores = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
        mask = np.tril(np.ones((t, t), bool))
        scores = np.where(mask[None, None], scores, -np.inf)
        probs = np.exp(scores - scores.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        att = np.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, h * hd)
        attn_out = att @ deq(p + "attn_output.weight").T \
            + arr(p + "attn_output.bias")
        u = hx @ deq(p + "ffn_up.weight").T + arr(p + "ffn_up.bias")
        mlp_out = gelu_tanh(u) @ deq(p + "ffn_down.weight").T \
            + arr(p + "ffn_down.bias")
        x = x + attn_out + mlp_out     # parallel residual
    x = ln(x, arr("output_norm.weight"), arr("output_norm.bias"))
    ref = x @ deq("output.weight").T + arr("output.bias")
    r.close()

    denom = np.abs(ref).max()
    assert np.max(np.abs(got - ref)) / denom < 0.03, \
        np.max(np.abs(got - ref)) / denom


def test_phi2_engine_generate(tmp_path):
    """Phi-2 through the serving engine: prefill + chunked decode over the
    INT8 cache with partial rotary must stay consistent with the one-shot
    forward (greedy prefix check)."""
    from gguf_tpu.engine import LLM, SamplerConfig

    cfg0 = LlamaConfig(vocab_size=64, dim=512, n_layers=2, n_heads=4,
                       n_kv_heads=4, ffn_dim=512, max_seq_len=64,
                       rope_dim=32)
    path = str(tmp_path / "phi2e.gguf")
    write_random_llama_gguf(path, cfg0, fmt=GGMLType.Q4_K, seed=8,
                            arch="phi2")
    llm = LLM(path, max_batch=2, max_seq=32)
    res = llm.generate([[1, 5, 9], [2, 7]], max_new_tokens=6,
                       sampler=SamplerConfig(temperature=0.0),
                       stop_at_eos=False)
    assert all(len(r.token_ids) == 6 for r in res)
    # greedy stepwise decode must equal the one-shot forward's argmax chain
    cfg, params = load_llama(path)
    from gguf_tpu.models import fuse_llama_params
    params = fuse_llama_params(params)
    ids = [1, 5, 9] + res[0].token_ids
    cache = init_kv_cache(cfg, batch=1, max_seq=32)
    logits, _ = forward(params, cfg, jnp.asarray([ids[:-1]], jnp.int32),
                        jnp.zeros(1, jnp.int32), cache,
                        opts=MMOpts(precision="fast"))
    want = np.asarray(logits[0, 2:]).argmax(-1)
    assert list(want[:3]) == res[0].token_ids[:3], (list(want), res[0].token_ids)


def test_qwen3_qk_norm(tmp_path):
    """qwen3-family: per-head q/k RMSNorm tensors load, apply pre-RoPE,
    and actually change the logits (vs the same weights without them)."""
    path = str(tmp_path / "q3.gguf")
    write_random_llama_gguf(path, CFG, seed=21, arch="qwen3")
    cfg, params = load_llama(path)
    assert "q_norm" in params["layers"][0]
    assert params["layers"][0]["q_norm"].shape == (cfg.head_dim,)

    toks = jnp.asarray([[1, 5, 9, 2]], jnp.int32)
    zero = jnp.zeros(1, jnp.int32)
    out, _ = forward(params, cfg, toks, zero, init_kv_cache(cfg, 1, 16),
                     MMOpts(precision="high"))
    assert bool(jnp.isfinite(out).all())
    # dropping the norms must change the result (they are not identity)
    stripped = {**params, "layers": [
        {k: v for k, v in l.items() if k not in ("q_norm", "k_norm")}
        for l in params["layers"]]}
    out2, _ = forward(stripped, cfg, toks, zero, init_kv_cache(cfg, 1, 16),
                      MMOpts(precision="high"))
    assert float(jnp.max(jnp.abs(out - out2))) > 1e-3


def test_qwen3_accuracy_gate_golden_vs_served(tmp_path):
    """The numpy golden decoder reproduces the served qwen3 numerics
    (QK-norm included) within the standard accuracy gate."""
    from gguf_tpu.eval.golden_decoder import golden_perplexity
    from gguf_tpu.eval.perplexity import perplexity_of_gguf

    path = str(tmp_path / "q3g.gguf")
    cfg = LlamaConfig(vocab_size=128, dim=256, n_layers=1, n_heads=4,
                      n_kv_heads=2, ffn_dim=512, max_seq_len=64)
    write_random_llama_gguf(path, cfg, seed=22, arch="qwen3")
    rng = np.random.default_rng(6)
    ids = rng.integers(0, cfg.vocab_size, 48)
    ppl_golden = golden_perplexity(path, ids, window=16)
    ppl = perplexity_of_gguf(path, ids, window=16,
                             opts=MMOpts(act_quant=True, precision="high"))
    assert np.isfinite(ppl_golden)
    assert abs(ppl - ppl_golden) < 1e-2 * ppl_golden, (ppl, ppl_golden)


def test_gemma2_arch_forward_matches_numpy(tmp_path):
    """Gemma2 family: alternating sliding-window layers (even layers slide,
    every 2nd stays global), attention + final logit soft-capping, and
    post-branch RMSNorms — all against a from-scratch numpy reference."""
    cfg0 = LlamaConfig(vocab_size=64, dim=512, n_layers=2, n_heads=4,
                       n_kv_heads=2, ffn_dim=256, max_seq_len=32,
                       head_dim_override=64, sliding_window=3,
                       swa_pattern=2, attn_softcap=20.0, final_softcap=15.0)
    path = str(tmp_path / "gemma2.gguf")
    write_random_llama_gguf(path, cfg0, fmt=GGMLType.Q4_K, seed=17,
                            arch="gemma2")
    cfg, params = load_llama(path)
    assert cfg.act_fn == "gelu_tanh" and cfg.swa_pattern == 2
    assert cfg.sliding_window == 3 and cfg.attn_softcap == 20.0
    assert "post_attn_norm" in params["layers"][0]

    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg.vocab_size, (1, 6)).astype(np.int32)
    cache = init_kv_cache(cfg, batch=1, max_seq=16)
    logits, _ = forward(params, cfg, jnp.asarray(tokens),
                        jnp.zeros(1, jnp.int32), cache,
                        opts=MMOpts(precision="high"))
    got = np.asarray(logits)

    r = GGUFReader(path)
    deq = lambda n: r.dequantize(n)
    b, t = tokens.shape
    hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    x = deq("token_embd.weight")[tokens.reshape(-1)].reshape(b, t, cfg.dim)
    x = x * np.float32(jnp.bfloat16(cfg.embed_scale))

    def rmsn(x, w):
        return x / np.sqrt(np.mean(x * x, -1, keepdims=True) + cfg.norm_eps) * w

    posn = np.arange(t)
    freqs = cfg.rope_theta ** (-np.arange(0, hd, 2) / hd)
    ang = posn[:, None] * freqs[None, :]
    cos, sin = np.cos(ang), np.sin(ang)

    def rope(xh):  # rotate-half: gemma/phi GGUFs keep the HF dim order
        half = xh.shape[-1] // 2
        c, s = cos[None, :, None, :], sin[None, :, None, :]
        x1, x2 = xh[..., :half], xh[..., half:]
        return np.concatenate([x1 * c - x2 * s, x1 * s + x2 * c], -1)

    def gelu_tanh(v):
        return 0.5 * v * (1 + np.tanh(np.sqrt(2 / np.pi) * (v + 0.044715 * v**3)))

    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        hx = rmsn(x, r.load_array(p + "attn_norm.weight"))
        q = (hx @ deq(p + "attn_q.weight").T).reshape(b, t, h, hd)
        k = (hx @ deq(p + "attn_k.weight").T).reshape(b, t, kvh, hd)
        v = (hx @ deq(p + "attn_v.weight").T).reshape(b, t, kvh, hd)
        q, k = rope(q), rope(k)
        rep = h // kvh
        k = np.repeat(k, rep, axis=2)
        v = np.repeat(v, rep, axis=2)
        scores = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
        scores = cfg.attn_softcap * np.tanh(scores / cfg.attn_softcap)
        mask = np.tril(np.ones((t, t), bool))
        if i % cfg.swa_pattern != cfg.swa_pattern - 1:   # sliding layer
            qpos = np.arange(t)[:, None]
            kpos = np.arange(t)[None, :]
            mask = mask & (kpos > qpos - cfg.sliding_window)
        scores = np.where(mask[None, None], scores, -np.inf)
        probs = np.exp(scores - scores.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        att = np.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, h * hd)
        att = att @ deq(p + "attn_output.weight").T
        att = rmsn(att, r.load_array(p + "post_attention_norm.weight"))
        x = x + att
        hx = rmsn(x, r.load_array(p + "ffn_norm.weight"))
        g = hx @ deq(p + "ffn_gate.weight").T
        u = hx @ deq(p + "ffn_up.weight").T
        m = (gelu_tanh(g) * u) @ deq(p + "ffn_down.weight").T
        m = rmsn(m, r.load_array(p + "post_ffw_norm.weight"))
        x = x + m

    x = rmsn(x, r.load_array("output_norm.weight"))
    ref = x @ deq("output.weight").T
    ref = cfg.final_softcap * np.tanh(ref / cfg.final_softcap)
    r.close()
    denom = np.abs(ref).max()
    assert np.max(np.abs(got - ref)) / denom < 0.04, \
        np.max(np.abs(got - ref)) / denom

    # the window actually bites: a config without SWA diverges on the
    # same weights once the prompt exceeds the window
    import dataclasses
    cfg_full = dataclasses.replace(cfg, sliding_window=0, swa_pattern=1)
    logits_full, _ = forward(params, cfg_full, jnp.asarray(tokens),
                             jnp.zeros(1, jnp.int32),
                             init_kv_cache(cfg, 1, 16),
                             opts=MMOpts(precision="high"))
    assert float(jnp.max(jnp.abs(logits - logits_full))) > 1e-3


def test_gemma2_decode_matches_prefill(tmp_path):
    """Sliding-window decode through the INT8 cache: stepwise T=1 decode
    must reproduce the one-shot prefill logits at every position."""
    cfg0 = LlamaConfig(vocab_size=64, dim=256, n_layers=2, n_heads=4,
                       n_kv_heads=2, ffn_dim=256, max_seq_len=32,
                       sliding_window=3, swa_pattern=2,
                       attn_softcap=20.0, final_softcap=15.0)
    path = str(tmp_path / "g2d.gguf")
    write_random_llama_gguf(path, cfg0, fmt=GGMLType.Q4_K, seed=18,
                            arch="gemma2")
    cfg, params = load_llama(path)
    rng = np.random.default_rng(5)
    toks = jnp.asarray(rng.integers(0, cfg.vocab_size, (1, 6)), jnp.int32)
    opts = MMOpts(precision="high")

    pre, _ = forward(params, cfg, toks, jnp.zeros(1, jnp.int32),
                     init_kv_cache(cfg, 1, 16), opts)
    cache = init_kv_cache(cfg, 1, 16)
    for t in range(6):
        lg, cache = forward(params, cfg, toks[:, t:t + 1],
                            jnp.full(1, t, jnp.int32), cache, opts)
        np.testing.assert_allclose(np.asarray(lg[0, 0]),
                                   np.asarray(pre[0, t]), atol=3e-2)


def test_gemma3_arch_serves(tmp_path):
    """Gemma3 family: 5:1 sliding pattern, QK-norm + post-branch norms,
    dual rope bases (local layers at rope_theta_swa). Config parses, the
    forward runs, and the local-theta rope actually differs from a config
    forced onto the global base."""
    import dataclasses

    cfg0 = LlamaConfig(vocab_size=64, dim=256, n_layers=2, n_heads=4,
                       n_kv_heads=2, ffn_dim=256, max_seq_len=32,
                       sliding_window=3, rope_theta=1_000_000.0)
    path = str(tmp_path / "g3.gguf")
    write_random_llama_gguf(path, cfg0, fmt=GGMLType.Q4_K, seed=19,
                            arch="gemma3")
    cfg, params = load_llama(path)
    assert cfg.swa_pattern == 6 and cfg.rope_theta_swa == 10000.0
    assert cfg.rope_theta == 1_000_000.0
    assert cfg.act_fn == "gelu_tanh"

    rng = np.random.default_rng(6)
    toks = jnp.asarray(rng.integers(0, cfg.vocab_size, (1, 6)), jnp.int32)
    opts = MMOpts(precision="high")
    out, _ = forward(params, cfg, toks, jnp.zeros(1, jnp.int32),
                     init_kv_cache(cfg, 1, 16), opts)
    assert bool(jnp.isfinite(out).all())
    # layer 0 and 1 both slide (pattern 6, 2 layers) -> forcing the global
    # base onto sliding layers changes the logits
    cfg_one = dataclasses.replace(cfg, rope_theta_swa=cfg.rope_theta)
    out2, _ = forward(params, cfg_one, toks, jnp.zeros(1, jnp.int32),
                      init_kv_cache(cfg, 1, 16), opts)
    assert float(jnp.max(jnp.abs(out - out2))) > 1e-4
    # and stepwise decode matches prefill through the cache
    cache = init_kv_cache(cfg, 1, 16)
    for t in range(6):
        lg, cache = forward(params, cfg, toks[:, t:t + 1],
                            jnp.full(1, t, jnp.int32), cache, opts)
    np.testing.assert_allclose(np.asarray(lg[0, 0]), np.asarray(out[0, -1]),
                               atol=3e-2)


def test_phi3_arch_forward_matches_numpy(tmp_path):
    """Phi-3 family: fused attn_qkv (RMSNorm, no biases), fused ffn_up
    holding [gate; up] (HF gate_up_proj order), and LongRoPE — per-dim
    factor tensors with the converter's attention-magnitude factor —
    against a from-scratch numpy reference on the raw GGUF tensors."""
    import dataclasses

    rd = 64
    cfg0 = LlamaConfig(vocab_size=64, dim=256, n_layers=2, n_heads=4,
                       n_kv_heads=2, ffn_dim=256, max_seq_len=64,
                       rope_scaling_kind="longrope", rope_orig_ctx=32,
                       rope_attn_factor=1.2,
                       rope_freq_factors=tuple(1.0 + 0.25 * i
                                               for i in range(rd // 2)))
    path = str(tmp_path / "phi3.gguf")
    write_random_llama_gguf(path, cfg0, fmt=GGMLType.Q4_K, seed=23,
                            arch="phi3")
    cfg, params = load_llama(path)
    assert cfg.rope_scaling_kind == "longrope"
    # max_seq 64 > orig 32 -> the long factor set applies
    np.testing.assert_allclose(cfg.rope_freq_factors,
                               cfg0.rope_freq_factors, rtol=1e-6)
    assert "gate" in params["layers"][0] and "wq" in params["layers"][0]

    rng = np.random.default_rng(7)
    tokens = rng.integers(0, cfg.vocab_size, (1, 5)).astype(np.int32)
    logits, _ = forward(params, cfg, jnp.asarray(tokens),
                        jnp.zeros(1, jnp.int32), init_kv_cache(cfg, 1, 16),
                        opts=MMOpts(precision="high"))
    got = np.asarray(logits)

    r = GGUFReader(path)
    deq = lambda n: r.dequantize(n)
    b, t = tokens.shape
    hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q_d, kv_d = h * hd, kvh * hd
    ff = cfg0.ffn_dim
    x = deq("token_embd.weight")[tokens.reshape(-1)].reshape(b, t, cfg.dim)

    def rmsn(x, w):
        return x / np.sqrt(np.mean(x * x, -1, keepdims=True) + cfg.norm_eps) * w

    posn = np.arange(t)
    freqs = (cfg.rope_theta ** (-np.arange(0, hd, 2) / hd)
             / np.asarray(cfg.rope_freq_factors))
    ang = posn[:, None] * freqs[None, :]
    m = cfg.rope_attn_factor
    cos, sin = np.cos(ang) * m, np.sin(ang) * m

    def rope(xh):  # rotate-half: gemma/phi GGUFs keep the HF dim order
        half = xh.shape[-1] // 2
        c, s = cos[None, :, None, :], sin[None, :, None, :]
        x1, x2 = xh[..., :half], xh[..., half:]
        return np.concatenate([x1 * c - x2 * s, x1 * s + x2 * c], -1)

    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        hx = rmsn(x, r.load_array(p + "attn_norm.weight"))
        qkv = hx @ deq(p + "attn_qkv.weight").T
        q = qkv[..., :q_d].reshape(b, t, h, hd)
        k = qkv[..., q_d:q_d + kv_d].reshape(b, t, kvh, hd)
        v = qkv[..., q_d + kv_d:].reshape(b, t, kvh, hd)
        q, k = rope(q), rope(k)
        rep = h // kvh
        k = np.repeat(k, rep, axis=2)
        v = np.repeat(v, rep, axis=2)
        scores = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
        mask = np.tril(np.ones((t, t), bool))
        scores = np.where(mask[None, None], scores, -np.inf)
        probs = np.exp(scores - scores.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        att = np.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, h * hd)
        x = x + att @ deq(p + "attn_output.weight").T
        hx = rmsn(x, r.load_array(p + "ffn_norm.weight"))
        gu = hx @ deq(p + "ffn_up.weight").T
        g, u = gu[..., :ff], gu[..., ff:]
        x = x + (g / (1 + np.exp(-g)) * u) @ deq(p + "ffn_down.weight").T

    x = rmsn(x, r.load_array("output_norm.weight"))
    ref = x @ deq("output.weight").T
    r.close()
    denom = np.abs(ref).max()
    assert np.max(np.abs(got - ref)) / denom < 0.04, \
        np.max(np.abs(got - ref)) / denom

    # short-context configs pick the unit short factors instead
    short_path = str(tmp_path / "phi3s.gguf")
    write_random_llama_gguf(
        short_path, dataclasses.replace(cfg0, max_seq_len=16,
                                        rope_orig_ctx=32), seed=23,
        arch="phi3")
    cfg_s, _ = load_llama(short_path)
    np.testing.assert_allclose(cfg_s.rope_freq_factors,
                               np.ones(rd // 2), rtol=1e-6)


def test_phi3_serves_and_decodes(tmp_path):
    cfg0 = LlamaConfig(vocab_size=64, dim=256, n_layers=1, n_heads=4,
                       n_kv_heads=2, ffn_dim=256, max_seq_len=32,
                       rope_scaling_kind="longrope", rope_orig_ctx=16,
                       rope_attn_factor=1.1)
    path = str(tmp_path / "phi3d.gguf")
    write_random_llama_gguf(path, cfg0, fmt=GGMLType.Q4_K, seed=24,
                            arch="phi3")
    from gguf_tpu.engine import LLM, SamplerConfig
    llm = LLM(path, max_batch=2, max_seq=32)
    out = llm.generate([[1, 5, 9]], max_new_tokens=6,
                       sampler=SamplerConfig(temperature=0.0),
                       stop_at_eos=False)
    assert len(out[0].token_ids) == 6


def test_gemma3_sliding_layers_ignore_global_rope_scaling(tmp_path):
    """Real gemma3 GGUFs ship rope.scaling.type=linear factor 8 for the
    GLOBAL layers; sliding layers rotate UNSCALED at rope_theta_swa
    (llama.cpp freq_scale_train_swa = 1). With every layer sliding
    (2 layers, pattern 6), changing the global factor must not change a
    single logit."""
    import dataclasses

    cfg0 = LlamaConfig(vocab_size=64, dim=256, n_layers=2, n_heads=4,
                       n_kv_heads=2, ffn_dim=256, max_seq_len=32,
                       sliding_window=3, rope_theta=1_000_000.0,
                       rope_scale=8.0, rope_scaling_kind="linear")
    path = str(tmp_path / "g3s.gguf")
    write_random_llama_gguf(path, cfg0, fmt=GGMLType.Q4_K, seed=25,
                            arch="gemma3")
    cfg, params = load_llama(path)
    assert cfg.rope_scale == 8.0 and cfg.swa_pattern == 6
    rng = np.random.default_rng(8)
    toks = jnp.asarray(rng.integers(0, cfg.vocab_size, (1, 6)), jnp.int32)
    opts = MMOpts(precision="high")
    a, _ = forward(params, cfg, toks, jnp.zeros(1, jnp.int32),
                   init_kv_cache(cfg, 1, 16), opts)
    b, _ = forward(params, dataclasses.replace(cfg, rope_scale=1.0,
                                               rope_scaling_kind="none"),
                   toks, jnp.zeros(1, jnp.int32),
                   init_kv_cache(cfg, 1, 16), opts)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-6)
