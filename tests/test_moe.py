"""Mixture-of-experts (mixtral-family): GGUF load, routed forward vs a
pure-numpy reference, and expert-parallel sharding parity on the virtual
mesh. Extends the reference's model-free kernel scope the same way the dense
llama tests do (SURVEY.md §0) — the MoE FFN consumes the same MMQ kernels.

Test design note: top-k routing is DISCONTINUOUS — a near-tied token flips
experts under any rounding difference (bf16 psum order, jit fusion), changing
its output by the expert disagreement, which no numeric tolerance absorbs.
So cross-compilation parity tests use a k == E checkpoint (softmax routing
weights, smooth everywhere), and the top-k selection math is pinned by a
dedicated unit test with a crafted router whose margins are decisive by
construction."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gguf_tpu.gguf import GGMLType, GGUFReader
from gguf_tpu.models import (
    LlamaConfig, MMOpts, forward, init_kv_cache, load_llama,
    write_random_llama_gguf,
)
from gguf_tpu.models.llama import moe_mlp
from gguf_tpu.parallel import (
    init_sharded_cache, make_mesh, make_tp_forward, shard_llama,
)

# dim 512: the ep x tp case needs dim % (256*tp) == 0 for row-parallel wo.
# k == E: smooth routing for cross-compilation parity (see module note).
CFG = LlamaConfig(
    vocab_size=128, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
    ffn_dim=512, max_seq_len=64, n_experts=4, n_experts_used=4,
)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("moe") / "moe.gguf")
    write_random_llama_gguf(path, CFG, fmt=GGMLType.Q4_K, seed=3)
    cfg, params = load_llama(path)
    return path, cfg, params


def _numpy_moe_reference(path, cfg, tokens):
    """Float reference forward from dequantized weights, numpy only.
    Routing follows llama.cpp/HF mixtral: softmax over all experts, top-k,
    renormalize the selected weights."""
    r = GGUFReader(path)
    deq = lambda n: r.dequantize(n)
    b, t = tokens.shape
    x = deq("token_embd.weight")[tokens.reshape(-1)].reshape(b, t, cfg.dim)

    def rmsn(x, w):
        return x / np.sqrt(np.mean(x * x, axis=-1, keepdims=True)
                           + cfg.norm_eps) * w

    hd = cfg.head_dim
    pos = np.arange(t)
    freqs = cfg.rope_theta ** (-np.arange(0, hd, 2) / hd)
    ang = pos[:, None] * freqs[None, :]
    cos, sin = np.cos(ang), np.sin(ang)

    def rope(x):
        c, s = cos[None, :, None, :], sin[None, :, None, :]
        if cfg.rope_neox:        # rotate-half pairing (qwen/gemma/phi GGUFs)
            e, o = x[..., :hd // 2], x[..., hd // 2:]
            return np.concatenate([e * c - o * s, e * s + o * c], -1)
        x2 = x.reshape(*x.shape[:-1], -1, 2)
        e, o = x2[..., 0], x2[..., 1]
        return np.stack([e * c - o * s, e * s + o * c], -1).reshape(x.shape)

    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        h = rmsn(x, r.load_array(p + "attn_norm.weight"))
        q = (h @ deq(p + "attn_q.weight").T).reshape(b, t, cfg.n_heads, hd)
        k = (h @ deq(p + "attn_k.weight").T).reshape(b, t, cfg.n_kv_heads, hd)
        v = (h @ deq(p + "attn_v.weight").T).reshape(b, t, cfg.n_kv_heads, hd)
        if p + "attn_q_norm.weight" in r.tensors:   # qwen3-family qk-norm
            q = rmsn(q, r.load_array(p + "attn_q_norm.weight"))
            k = rmsn(k, r.load_array(p + "attn_k_norm.weight"))
        q, k = rope(q), rope(k)
        rep = cfg.n_heads // cfg.n_kv_heads
        k, v = np.repeat(k, rep, axis=2), np.repeat(v, rep, axis=2)
        scores = np.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(hd)
        mask = np.tril(np.ones((t, t), bool))
        scores = np.where(mask[None, None], scores, -np.inf)
        probs = np.exp(scores - scores.max(-1, keepdims=True))
        probs /= probs.sum(-1, keepdims=True)
        att = np.einsum("bhqk,bkhd->bqhd", probs, v).reshape(b, t, -1)
        x = x + att @ deq(p + "attn_output.weight").T

        h = rmsn(x, r.load_array(p + "ffn_norm.weight"))
        hf = h.reshape(b * t, -1)
        x = x + _numpy_moe_ffn(r, f"blk.{i}.", cfg, hf).reshape(b, t, -1)

    x = rmsn(x, r.load_array("output_norm.weight"))
    logits = x @ deq("output.weight").T
    r.close()
    return logits


def _numpy_moe_ffn(r, p, cfg, hf, gate_inp=None):
    """The routed-FFN block alone: softmax -> top-k -> renorm -> SwiGLU."""
    deq = lambda n: r.dequantize(n)
    logits = hf @ (gate_inp if gate_inp is not None
                   else r.load_array(p + "ffn_gate_inp.weight")).T
    pe = np.exp(logits - logits.max(-1, keepdims=True))
    pe /= pe.sum(-1, keepdims=True)
    order = np.argsort(-pe, axis=-1)[:, :cfg.n_experts_used]
    w = np.zeros_like(pe)
    np.put_along_axis(w, order, np.take_along_axis(pe, order, -1), -1)
    if cfg.moe_renorm:
        w /= w.sum(-1, keepdims=True)
    gate = deq(p + "ffn_gate_exps.weight")   # (E, F, D)
    up = deq(p + "ffn_up_exps.weight")
    down = deq(p + "ffn_down_exps.weight")   # (E, D, F)
    out = np.zeros_like(hf)
    for e in range(cfg.n_experts):
        g = hf @ gate[e].T
        u = hf @ up[e].T
        out += w[:, e:e + 1] * ((g / (1 + np.exp(-g)) * u) @ down[e].T)
    if p + "ffn_gate_shexp.weight" in r.tensors:
        g = hf @ deq(p + "ffn_gate_shexp.weight").T
        u = hf @ deq(p + "ffn_up_shexp.weight").T
        sh = (g / (1 + np.exp(-g)) * u) @ deq(p + "ffn_down_shexp.weight").T
        if p + "ffn_gate_inp_shexp.weight" in r.tensors:
            # qwen2moe: per-token sigmoid gate on the shared expert
            sg = hf @ r.load_array(
                p + "ffn_gate_inp_shexp.weight").reshape(-1)[:, None]
            sh = sh * (1 / (1 + np.exp(-sg)))
        out += sh
    return out


def test_moe_config_from_gguf(model):
    _, cfg, params = model
    assert cfg.n_experts == 4 and cfg.n_experts_used == 4
    layer = params["layers"][0]
    assert "gate_inp" in layer and "gate_exps" in layer
    assert "gate" not in layer
    # stacked SoA: every field carries the leading E axis
    assert layer["gate_exps"].d_bits.shape[0] == 4


def test_moe_forward_matches_numpy_reference(model):
    path, cfg, params = model
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    cache = init_kv_cache(cfg, batch=2, max_seq=32)
    logits, _ = forward(params, cfg, jnp.asarray(tokens),
                        jnp.zeros(2, jnp.int32), cache,
                        opts=MMOpts(precision="high"))
    ref = _numpy_moe_reference(path, cfg, tokens)
    got = np.asarray(logits)
    assert got.shape == ref.shape
    denom = np.abs(ref).max()
    assert np.max(np.abs(got - ref)) / denom < 0.03, \
        np.max(np.abs(got - ref)) / denom


def test_moe_topk_selection_vs_numpy(model, tmp_path):
    """Top-2-of-4 routing pinned against numpy with a CRAFTED router whose
    margins are decisive by construction: x rows are 3*g_a + 2*g_b + noise
    for unit-norm router rows g, so logits ~ (3, 2, eps, eps) and the top-2
    set is stable under any rounding. Verifies selection, renormalization,
    and that non-selected experts contribute exactly nothing."""
    import dataclasses

    path, cfg, params = model
    cfg2 = dataclasses.replace(cfg, n_experts_used=2)
    rng = np.random.default_rng(9)
    g = rng.standard_normal((cfg.n_experts, cfg.dim)).astype(np.float32)
    g /= np.linalg.norm(g, axis=1, keepdims=True)
    n = 8
    a = rng.integers(0, cfg.n_experts, n)
    b = (a + 1 + rng.integers(0, cfg.n_experts - 1, n)) % cfg.n_experts
    x = (3 * g[a] + 2 * g[b]
         + 0.02 * rng.standard_normal((n, cfg.dim))).astype(np.float32)

    layer = dict(params["layers"][0])
    layer["gate_inp"] = jnp.asarray(g)
    got = np.asarray(moe_mlp(layer, jnp.asarray(x)[None], cfg2,
                             MMOpts(precision="high")))[0]

    r = GGUFReader(path)
    ref = _numpy_moe_ffn(r, "blk.0.", cfg2, x, gate_inp=g)
    r.close()
    denom = np.abs(ref).max()
    assert np.max(np.abs(got - ref)) / denom < 0.03, \
        np.max(np.abs(got - ref)) / denom
    # the crafted pairs really were selected: weights of (a, b) sum to 1
    logits = x @ g.T
    pe = np.exp(logits - logits.max(-1, keepdims=True))
    pe /= pe.sum(-1, keepdims=True)
    top2 = np.sort(pe, -1)[:, -2:].sum(-1)
    assert (top2 > 0.9).all()   # decisive margins, no near-ties


@pytest.mark.parametrize("ep,tp", [(2, 1), (2, 2), (4, 1)])
def test_moe_ep_sharding_matches_single_device(model, ep, tp):
    """Expert-parallel (x tensor-parallel) forward on the virtual mesh must
    reproduce the single-device MoE logits (k == E keeps routing smooth, so
    tolerance-level parity is well-defined)."""
    _, cfg, params = model
    mesh = make_mesh(tp=tp, ep=ep)
    sharded, cfg_pad = shard_llama(params, cfg, mesh)
    fwd = make_tp_forward(cfg_pad, mesh, MMOpts(precision="high"))

    rng = np.random.default_rng(1)
    tokens = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 4)).astype(np.int32))
    pos = jnp.zeros(2, jnp.int32)
    cache = init_sharded_cache(cfg_pad, mesh, batch=2, max_seq=16)
    logits, _ = fwd(sharded, tokens, pos, cache)

    ref_cache = init_kv_cache(cfg, batch=2, max_seq=16)
    ref, _ = forward(params, cfg, tokens, pos, ref_cache,
                     MMOpts(precision="high"))
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(logits), ref,
                               atol=2e-2 * np.abs(ref).max())


def test_moe_top2_forward_runs(tmp_path):
    """A sparse (top-2) model end to end: shapes + finiteness (parity is
    covered by the smooth checkpoint and the crafted-router unit test)."""
    import dataclasses

    cfg_t2 = dataclasses.replace(CFG, n_experts_used=2, n_layers=1)
    path = str(tmp_path / "moe_top2.gguf")
    write_random_llama_gguf(path, cfg_t2, fmt=GGMLType.Q4_K, seed=5)
    cfg, params = load_llama(path)
    assert cfg.n_experts_used == 2
    rng = np.random.default_rng(0)
    tokens = jnp.asarray(rng.integers(0, cfg.vocab_size, (2, 4)).astype(np.int32))
    cache = init_kv_cache(cfg, batch=2, max_seq=16)
    logits, _ = forward(params, cfg, tokens, jnp.zeros(2, jnp.int32), cache,
                        MMOpts(precision="high"))
    assert logits.shape == (2, 4, cfg.vocab_size)
    assert np.isfinite(np.asarray(logits)).all()


def test_moe_engine_serving(model):
    """The continuous-batching engine serves an MoE checkpoint: single-chip
    and ep x tp sharded greedy decode must produce identical tokens.
    precision='high' keeps the dots in f32 — at 'fast' the tp split of
    the K sum reorders bf16 accumulation enough to flip greedy near-ties
    on a random 128-vocab model, which is rounding noise, not a parity
    bug (the logits-level check is test_moe_ep_sharding_...)."""
    from gguf_tpu.engine import LLM

    path, _, _ = model
    opts = MMOpts(precision="high")
    llm1 = LLM(path, max_batch=2, max_seq=64, opts=opts)
    r1 = llm1.generate([[1, 5, 9]], max_new_tokens=6)
    llm = LLM(path, max_batch=2, max_seq=64, ep=2, tp=2, opts=opts)
    r = llm.generate([[1, 5, 9], [2, 7]], max_new_tokens=6)
    assert all(len(x.token_ids) == 6 for x in r)
    assert r[0].token_ids == r1[0].token_ids


@pytest.mark.slow
def test_moe_prefill_equals_stepwise_decode(model):
    """The routed FFN must be position-consistent through the INT8 cache:
    one T=4 prefill == 4 sequential T=1 decode steps."""
    _, cfg, params = model
    rng = np.random.default_rng(2)
    tokens = jnp.asarray(rng.integers(0, cfg.vocab_size, (1, 4)).astype(np.int32))
    opts = MMOpts(precision="high")

    cache = init_kv_cache(cfg, batch=1, max_seq=16)
    logits_pre, _ = forward(params, cfg, tokens, jnp.zeros(1, jnp.int32),
                            cache, opts)
    cache = init_kv_cache(cfg, batch=1, max_seq=16)
    last = None
    for t in range(4):
        last, cache = forward(params, cfg, tokens[:, t:t + 1],
                              jnp.full(1, t, jnp.int32), cache, opts)
    np.testing.assert_allclose(np.asarray(logits_pre[0, -1]),
                               np.asarray(last[0, 0]), rtol=0, atol=2e-2)


def test_qwen3moe_family(tmp_path):
    """Qwen3-MoE (arch qwen3moe): per-head q/k RMSNorm + NEOX rotate-half
    rope + routed experts together, vs the numpy reference. Covers e.g.
    Qwen3-30B-A3B GGUFs (llama.cpp LLM_ARCH_QWEN3MOE)."""
    cfg = LlamaConfig(
        vocab_size=128, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=512, max_seq_len=64, n_experts=4, n_experts_used=4,
    )
    path = str(tmp_path / "q3moe.gguf")
    write_random_llama_gguf(path, cfg, fmt=GGMLType.Q4_K, seed=7,
                            arch="qwen3moe")
    lcfg, params = load_llama(path)
    assert lcfg.rope_neox and lcfg.n_experts == 4
    assert "q_norm" in params["layers"][0]
    assert "gate_exps" in params["layers"][0]
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, lcfg.vocab_size, (2, 8)).astype(np.int32)
    cache = init_kv_cache(lcfg, batch=2, max_seq=32)
    logits, _ = forward(params, lcfg, jnp.asarray(tokens),
                        jnp.zeros(2, jnp.int32), cache,
                        opts=MMOpts(precision="high"))
    ref = _numpy_moe_reference(path, lcfg, tokens)
    got = np.asarray(logits)
    denom = np.abs(ref).max()
    assert np.max(np.abs(got - ref)) / denom < 0.03, \
        np.max(np.abs(got - ref)) / denom


def test_qwen2moe_family(tmp_path):
    """Qwen2-MoE (arch qwen2moe, Qwen1.5/2-MoE GGUFs): NO top-k weight
    renormalization (llama.cpp build_qwen2moe norm_w=false) plus a
    sigmoid-gated shared expert beside the routed sum."""
    cfg = LlamaConfig(
        vocab_size=128, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=512, max_seq_len=64, n_experts=4, n_experts_used=4,
        n_shared_experts=1, moe_renorm=False, rope_neox=True,
    )
    path = str(tmp_path / "q2moe.gguf")
    write_random_llama_gguf(path, cfg, fmt=GGMLType.Q8_0, seed=8,
                            arch="qwen2moe")
    lcfg, params = load_llama(path)
    assert lcfg.rope_neox and not lcfg.moe_renorm
    l0 = params["layers"][0]
    assert "gate_shexp" in l0 and "gate_inp_shexp" in l0
    assert l0["gate_inp_shexp"].shape == (512,)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, lcfg.vocab_size, (2, 8)).astype(np.int32)
    cache = init_kv_cache(lcfg, batch=2, max_seq=32)
    logits, _ = forward(params, lcfg, jnp.asarray(tokens),
                        jnp.zeros(2, jnp.int32), cache,
                        opts=MMOpts(precision="high"))
    ref = _numpy_moe_reference(path, lcfg, tokens)
    got = np.asarray(logits)
    denom = np.abs(ref).max()
    assert np.max(np.abs(got - ref)) / denom < 0.03, \
        np.max(np.abs(got - ref)) / denom


def test_heterogeneous_expert_ffn_width(tmp_path):
    """Checkpoints whose expert FFN width differs from the dense width
    (expert_feed_forward_length — DeepSeek-V2's 1408 vs 10944, Qwen-MoE)
    must load, pad each width independently, and still match the
    reference built from the UNPADDED GGUF bytes (zero-pad exactness)."""
    cfg = LlamaConfig(
        vocab_size=128, dim=512, n_layers=2, n_heads=4, n_kv_heads=2,
        ffn_dim=288, expert_ffn_dim=320, max_seq_len=64,
        n_experts=4, n_experts_used=4, n_shared_experts=1,
        moe_renorm=False, rope_neox=True,
    )
    path = str(tmp_path / "het.gguf")
    write_random_llama_gguf(path, cfg, fmt=GGMLType.Q8_0, seed=12,
                            arch="qwen2moe")
    lcfg, params = load_llama(path)
    assert lcfg.expert_ffn_dim >= 320          # padded independently
    l0 = params["layers"][0]
    # stacked SoA: lane (M) axis is last; E leads
    assert l0["gate_exps"].d_bits.shape[-1] == lcfg.expert_ffn_dim
    assert l0["up_shexp"].shape[0] >= 320

    rng = np.random.default_rng(5)
    tokens = rng.integers(0, lcfg.vocab_size, (2, 6)).astype(np.int32)
    cache = init_kv_cache(lcfg, batch=2, max_seq=32)
    logits, _ = forward(params, lcfg, jnp.asarray(tokens),
                        jnp.zeros(2, jnp.int32), cache,
                        opts=MMOpts(precision="high"))
    # reference reads the raw (unpadded) GGUF: padding must be invisible
    ref_cfg = LlamaConfig.from_gguf_metadata(GGUFReader(path).metadata)
    ref = _numpy_moe_reference(path, ref_cfg, tokens)
    got = np.asarray(logits)
    denom = np.abs(ref).max()
    assert np.max(np.abs(got - ref)) / denom < 0.03, \
        np.max(np.abs(got - ref)) / denom
