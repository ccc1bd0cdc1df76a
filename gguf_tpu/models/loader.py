"""GGUF checkpoint -> model params (llama.cpp tensor-name schema)."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

import dataclasses

import jax

from ..gguf import GGMLType, GGUFReader
from ..gguf.writer import (effective_quant_type, quantize_tensor, write_gguf)
from .config import LlamaConfig


def _pad_cols_to(t, m_target: int):
    """Zero-pad a weight's output dim (lane axis of every SoA array)."""
    from ..ops.common import pad_cols
    from ..quant.layouts import QuantTensor

    if isinstance(t, QuantTensor):
        return jax.tree_util.tree_map(
            lambda a: pad_cols(a, a.shape[-1] + (m_target - t.shape[0])), t)
    return jnp.pad(t, ((0, m_target - t.shape[0]), (0, 0)))


def _pad_k_to(t, k_target: int):
    """Zero-pad a weight's input dim with whole superblocks (zero scales
    dequantize to zero — exact)."""
    from ..quant.layouts import QuantTensor

    if isinstance(t, QuantTensor):
        m, k = t.shape

        def pad(a):
            # integer math: float-ratio truncation loses a row for many
            # (k, k_target) pairs (e.g. 6016 rows * 12288/12032 -> 6143)
            rows = a.shape[0] * k_target // k
            assert rows * k == a.shape[0] * k_target, (a.shape, k, k_target)
            return jnp.pad(a, ((0, rows - a.shape[0]), (0, 0)))

        return jax.tree_util.tree_map(pad, t)
    return jnp.pad(t, ((0, 0), (0, k_target - t.shape[1])))


def _m_pad_target(m: int) -> int:
    """Vocab matrices pad their output dim to a 128-multiple, so the MMQ
    kernel's power-of-two M tiles divide it without a per-call pad."""
    from ..ops.common import round_up

    return round_up(m, 128)


def _pad_vocab_weights(params: dict) -> dict:
    """Zero-pad token_embd/output along vocab (M) when needed; forward()
    slices logits back to cfg.vocab_size, and embedding ids never reach the
    pad columns. Tied embeddings are padded once and shared."""
    from ..quant.layouts import QuantTensor

    tied = params["output"] is params["token_embd"]
    new = {}
    for key in ("output", "token_embd"):
        t = params[key]
        if isinstance(t, QuantTensor):
            target = _m_pad_target(t.shape[0])
            t = _pad_cols_to(t, target) if target != t.shape[0] else t
        new[key] = t
    if tied:
        new["token_embd"] = new["output"]
    return {**params, **new}


def _ffn_pad_target(ffn: int, granule: int) -> int:
    """Smallest multiple of `granule` (256 * tp: whole superblocks per
    tensor-parallel shard) >= ffn."""
    from ..ops.common import round_up

    return round_up(ffn, granule)


def _pad_exps(t, ffn: int, ffn_pad: int, kind: str):
    """Pad a STACKED expert tensor (leading E axis) along the output dim
    (kind='m': gate/up) or the input dim (kind='k': down). QuantTensor SoA
    stacks carry (E, k_rows, M); float stacks carry (E, M, K)."""
    from ..quant.layouts import QuantTensor

    delta = ffn_pad - ffn
    if isinstance(t, QuantTensor):
        if kind == "m":
            return jax.tree_util.tree_map(
                lambda a: jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, delta)]),
                t)

        def pad(a):
            rows = a.shape[-2] * ffn_pad // ffn
            assert rows * ffn == a.shape[-2] * ffn_pad, (a.shape, ffn, ffn_pad)
            return jnp.pad(a, [(0, 0)] * (a.ndim - 2)
                           + [(0, rows - a.shape[-2]), (0, 0)])

        return jax.tree_util.tree_map(pad, t)
    if kind == "m":
        return jnp.pad(t, [(0, 0), (0, delta), (0, 0)])
    return jnp.pad(t, [(0, 0), (0, 0), (0, delta)])


def pad_ffn_for_tp(params: dict, cfg: LlamaConfig, tp: int):
    """Pad the FFN dimension so row shards land on superblock boundaries
    (multiple of 256*tp — e.g. Llama-2-7B's 11008 -> 12288 at tp=8). The
    single-chip loader applies this with tp=1.
    MoE expert stacks pad every expert the same way (the stacked arrays
    carry the per-expert axes after the leading E dim)."""
    granule = 256 * tp
    ffn = cfg.ffn_dim
    ffn_pad = _ffn_pad_target(ffn, granule) if ffn else 0
    # MoE checkpoints route through experts of their OWN width
    # (expert_feed_forward_length — DeepSeek-V2 1408 vs dense 10944,
    # Qwen1.5-MoE 1408 vs 5632); shared experts are n_shared stacked
    # expert-width FFNs
    e_ffn = cfg.expert_ffn_dim or ffn
    e_pad = _ffn_pad_target(e_ffn, granule) if e_ffn else 0
    if ffn_pad == ffn and e_pad == e_ffn:
        return params, cfg
    layers = []
    for layer in params["layers"]:
        layer = dict(layer)
        if "gate_exps" in layer:
            if e_pad != e_ffn:
                layer["gate_exps"] = _pad_exps(layer["gate_exps"],
                                               e_ffn, e_pad, "m")
                layer["up_exps"] = _pad_exps(layer["up_exps"],
                                             e_ffn, e_pad, "m")
                layer["down_exps"] = _pad_exps(layer["down_exps"],
                                               e_ffn, e_pad, "k")
            if "gate_shexp" in layer:
                s_ffn = layer["up_shexp"].shape[0]
                s_pad = _ffn_pad_target(s_ffn, granule)
                if s_pad != s_ffn:
                    layer["gate_shexp"] = _pad_cols_to(layer["gate_shexp"],
                                                       s_pad)
                    layer["up_shexp"] = _pad_cols_to(layer["up_shexp"],
                                                     s_pad)
                    layer["down_shexp"] = _pad_k_to(layer["down_shexp"],
                                                    s_pad)
            layers.append(layer)
            continue
        if ffn_pad == ffn or "up" not in layer:
            layers.append(layer)
            continue
        if "gate" in layer:
            layer["gate"] = _pad_cols_to(layer["gate"], ffn_pad)
        layer["up"] = _pad_cols_to(layer["up"], ffn_pad)
        layer["down"] = _pad_k_to(layer["down"], ffn_pad)
        if "bup" in layer:   # phi2 up-bias follows the padded M dim
            b = np.asarray(layer["bup"])
            layer["bup"] = jnp.asarray(
                np.pad(b, (0, ffn_pad - b.shape[0])))
        layers.append(layer)
    params = {**params, "layers": layers}
    return params, dataclasses.replace(
        cfg, ffn_dim=ffn_pad or cfg.ffn_dim,
        expert_ffn_dim=e_pad if cfg.expert_ffn_dim else cfg.expert_ffn_dim)


def _load_weight(reader: GGUFReader, name: str, rows: slice | None = None):
    """Quantized weights -> QuantTensor (SoA, device); float -> jnp array."""
    ti = reader.tensors[name]
    if ti.ggml_type in (GGMLType.F32, GGMLType.F16, GGMLType.BF16):
        arr = reader.load_array(name)
        if rows is not None:
            arr = arr[rows]
        return jnp.asarray(np.ascontiguousarray(arr))
    return reader.load_quant(name, rows=rows)


def _maybe_bias(reader: GGUFReader, name: str):
    """Optional bias vector (Qwen2-family GGUFs carry attn_{q,k,v}.bias)."""
    if name in reader.tensors:
        return jnp.asarray(reader.load_array(name), jnp.float32)
    return None


def _load_experts(reader: GGUFReader, name_3d: str, name_per: str,
                  n_experts: int):
    """Stacked expert weights (leading E axis on every SoA field).

    Two on-disk schemas: the current 3-D `ffn_*_exps.weight` (E, M, K)
    tensor — experts are row-contiguous, so expert e is rows [e*M, (e+1)*M)
    of the flattened quantized view — and the pre-2024 per-expert 2-D
    `ffn_*.{e}.weight` tensors. Float expert tensors stack to a plain
    (E, M, K) array (single-chip only; ep sharding requires quantized)."""
    from ..quant.layouts import stack_experts

    if name_3d in reader.tensors:
        ti = reader.tensors[name_3d]
        e, m, _k = ti.shape
        assert e == n_experts, (name_3d, ti.shape, n_experts)
        if ti.ggml_type in (GGMLType.F32, GGMLType.F16, GGMLType.BF16):
            return jnp.asarray(np.ascontiguousarray(
                reader.load_array(name_3d)))
        return stack_experts([
            reader.load_quant(name_3d, rows=slice(ex * m, (ex + 1) * m))
            for ex in range(n_experts)])
    parts = [_load_weight(reader, name_per.format(ex))
             for ex in range(n_experts)]
    if isinstance(parts[0], jnp.ndarray):
        return jnp.stack(parts)
    return stack_experts(parts)


def load_llama(path: str):
    """Load a llama-schema GGUF file (llama / mistral / tinyllama / qwen2 /
    gemma — qwen2's QKV biases load when present) or a phi2-schema file
    (fused attn_qkv + biases + LayerNorm, split back into the uniform
    layer dict here). Returns (cfg, params)."""
    reader = GGUFReader(path)
    cfg = LlamaConfig.from_gguf_metadata(reader.metadata)
    if "rope_freqs.weight" in reader.tensors:
        # llama-3.1-style per-dimension rope frequency divisors (the
        # converter bakes the "llama3" scaling scheme into this tensor);
        # a tuple keeps the config hashable for jit-static use
        import dataclasses
        cfg = dataclasses.replace(cfg, rope_freq_factors=tuple(
            float(x) for x in reader.load_array("rope_freqs.weight")))
    if reader.metadata.get("general.architecture") == "phi2":
        return _load_phi2(reader, cfg)
    if reader.metadata.get("general.architecture") == "phi3":
        return _load_phi3(reader, cfg)
    if cfg.ssm_inner:
        return _load_mamba(reader, cfg)
    if not cfg.causal:   # bert-family encoder (embedding models)
        from .bert import load_bert

        params = load_bert(reader, cfg)
        reader.close()
        return cfg, params

    params = {
        "token_embd": _load_weight(reader, "token_embd.weight"),
        "output_norm": jnp.asarray(reader.load_array("output_norm.weight"), jnp.float32),
        "layers": [],
    }
    # tied embeddings: some checkpoints omit output.weight — share the
    # already-loaded object instead of reading + converting the (largest)
    # tensor twice (_pad_vocab_weights pads shared objects once)
    params["output"] = (_load_weight(reader, "output.weight")
                        if "output.weight" in reader.tensors
                        else params["token_embd"])

    if "output_norm.bias" in reader.tensors:   # starcoder2/gpt2 LN bias
        params["output_norm_bias"] = jnp.asarray(
            reader.load_array("output_norm.bias"), jnp.float32)
    if "position_embd.weight" in reader.tensors:
        # gpt2-family learned absolute positions (added to embeddings;
        # attention skips rotation — cfg.learned_pos)
        params["position_embd"] = jnp.asarray(
            reader.load_array("position_embd.weight"), jnp.float32)

    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        # pre-norms are optional: olmo2 is post-norm-only (the forward's
        # _norm passes x through when the key is absent); starcoder2's
        # LayerNorms carry biases
        layer = {}
        for nk, tk in (("attn_norm", "attn_norm.weight"),
                       ("ffn_norm", "ffn_norm.weight"),
                       ("attn_norm_bias", "attn_norm.bias"),
                       ("ffn_norm_bias", "ffn_norm.bias")):
            if p + tk in reader.tensors:
                layer[nk] = jnp.asarray(reader.load_array(p + tk),
                                        jnp.float32)
        if p + "attn_kv_a_mqa.weight" in reader.tensors:
            # deepseek2 multi-head latent attention. The per-head KV
            # up-projection (attn_kv_b) is ABSORBED: its K half folds into
            # the query path and its V half into the output path, so
            # attention runs directly over the compressed latent and the
            # cache stores one (kv_lora + rope) row per token. Absorption
            # matrices are small per-head bf16 einsum operands, not MMQ
            # weights — dequantized once at load.
            if p + "attn_q_a.weight" in reader.tensors:
                layer["wq_a"] = _load_weight(reader, p + "attn_q_a.weight")
                layer["q_a_norm"] = jnp.asarray(
                    reader.load_array(p + "attn_q_a_norm.weight"),
                    jnp.float32)
                layer["wq_b"] = _load_weight(reader, p + "attn_q_b.weight")
            else:   # V2-Lite: q_lora_rank unset, direct q projection
                layer["wq"] = _load_weight(reader, p + "attn_q.weight")
            layer["wkv_a"] = _load_weight(reader,
                                          p + "attn_kv_a_mqa.weight")
            layer["kv_a_norm"] = jnp.asarray(
                reader.load_array(p + "attn_kv_a_norm.weight"), jnp.float32)
            kvb = reader.dequantize(p + "attn_kv_b.weight")
            nope, vdim = cfg.qk_nope_dim, cfg.v_head_dim
            kvb = kvb.reshape(cfg.n_heads, nope + vdim, cfg.kv_lora_rank)
            layer["w_uk"] = jnp.asarray(kvb[:, :nope], jnp.bfloat16)
            layer["w_uv"] = jnp.asarray(kvb[:, nope:], jnp.bfloat16)
            layer["wo"] = _load_weight(reader, p + "attn_output.weight")
        elif p + "attn_qkv.weight" in reader.tensors:
            # gpt2-family fused projection: slice the M dim back into
            # q/k/v (lane slices are free in the K-major SoA layout)
            q_d = cfg.n_heads * cfg.head_dim
            kv_d = cfg.n_kv_heads * cfg.head_dim
            wqkv = _load_weight(reader, p + "attn_qkv.weight")

            def _slice_m(t, lo, hi):
                if isinstance(t, jnp.ndarray):
                    return t[lo:hi]
                return jax.tree_util.tree_map(lambda a: a[..., lo:hi], t)

            layer["wq"] = _slice_m(wqkv, 0, q_d)
            layer["wk"] = _slice_m(wqkv, q_d, q_d + kv_d)
            layer["wv"] = _slice_m(wqkv, q_d + kv_d, q_d + 2 * kv_d)
            bqkv = _maybe_bias(reader, p + "attn_qkv.bias")
            if bqkv is not None:
                layer["bq"] = bqkv[:q_d]
                layer["bk"] = bqkv[q_d:q_d + kv_d]
                layer["bv"] = bqkv[q_d + kv_d:q_d + 2 * kv_d]
            layer["wo"] = _load_weight(reader, p + "attn_output.weight")
            bo = _maybe_bias(reader, p + "attn_output.bias")
            if bo is not None:
                layer["bo"] = bo
        else:
            layer.update({
                "wq": _load_weight(reader, p + "attn_q.weight"),
                "wk": _load_weight(reader, p + "attn_k.weight"),
                "wv": _load_weight(reader, p + "attn_v.weight"),
                **{k: v for k, v in [
                    ("bq", _maybe_bias(reader, p + "attn_q.bias")),
                    ("bk", _maybe_bias(reader, p + "attn_k.bias")),
                    ("bv", _maybe_bias(reader, p + "attn_v.bias")),
                    ("bo", _maybe_bias(reader, p + "attn_output.bias")),
                ] if v is not None},
                "wo": _load_weight(reader, p + "attn_output.weight"),
            })
        # qwen3-family per-head q/k RMSNorm vectors (head_dim,) — olmo2
        # stores WHOLE-projection-vector norms under the same tensor
        # names, kept as distinct param keys (different math under tp);
        # gemma2/olmo2 post-branch norms (dim,)
        for nk, tk in (("q_norm", "attn_q_norm.weight"),
                       ("k_norm", "attn_k_norm.weight"),
                       ("post_attn_norm", "post_attention_norm.weight"),
                       ("post_ffn_norm", "post_ffw_norm.weight")):
            if p + tk in reader.tensors:
                arr = jnp.asarray(reader.load_array(p + tk), jnp.float32)
                if nk in ("q_norm", "k_norm") and \
                        arr.shape[0] != cfg.head_dim:
                    nk += "_full"
                layer[nk] = arr
        if cfg.n_experts and p + "ffn_gate_inp.weight" in reader.tensors:
            # mixtral-family MoE layer: router + stacked expert FFNs
            layer["gate_inp"] = jnp.asarray(
                reader.load_array(p + "ffn_gate_inp.weight"), jnp.float32)
            layer["gate_exps"] = _load_experts(
                reader, p + "ffn_gate_exps.weight",
                p + "ffn_gate.{}.weight", cfg.n_experts)
            layer["up_exps"] = _load_experts(
                reader, p + "ffn_up_exps.weight",
                p + "ffn_up.{}.weight", cfg.n_experts)
            layer["down_exps"] = _load_experts(
                reader, p + "ffn_down_exps.weight",
                p + "ffn_down.{}.weight", cfg.n_experts)
            # deepseek2: shared experts run as a dense FFN beside the
            # routed sum; V3 routes on bias-adjusted sigmoid scores
            for nk, tk in (("gate_shexp", "ffn_gate_shexp.weight"),
                           ("up_shexp", "ffn_up_shexp.weight"),
                           ("down_shexp", "ffn_down_shexp.weight")):
                if p + tk in reader.tensors:
                    layer[nk] = _load_weight(reader, p + tk)
            if p + "ffn_gate_inp_shexp.weight" in reader.tensors:
                # qwen2moe: (1, dim) sigmoid gate on the shared expert
                layer["gate_inp_shexp"] = jnp.asarray(
                    reader.load_array(
                        p + "ffn_gate_inp_shexp.weight").reshape(-1),
                    jnp.float32)
            if p + "exp_probs_b.bias" in reader.tensors:
                layer["gate_inp_b"] = jnp.asarray(
                    reader.load_array(p + "exp_probs_b.bias"), jnp.float32)
        else:
            if p + "ffn_gate.weight" in reader.tensors:
                layer["gate"] = _load_weight(reader, p + "ffn_gate.weight")
            # else: gateless MLP (starcoder2-style act(up) @ down)
            layer["up"] = _load_weight(reader, p + "ffn_up.weight")
            layer["down"] = _load_weight(reader, p + "ffn_down.weight")
            for nk, tk in (("bup", "ffn_up.bias"), ("bdown", "ffn_down.bias")):
                b = _maybe_bias(reader, p + tk)
                if b is not None:
                    layer[nk] = b
        params["layers"].append(layer)
    reader.close()
    params, cfg = pad_ffn_for_tp(params, cfg, 1)
    params = _pad_vocab_weights(params)
    return cfg, params


def _load_mamba(reader: GGUFReader, cfg: LlamaConfig):
    """mamba tensor schema (llama.cpp LLM_ARCH_MAMBA): per block one
    selective-SSM mixer — ssm_in [x;z] projection, depthwise conv1d,
    ssm_x -> (dt_rank | B | C), ssm_dt, A_log/D, ssm_out. The big
    projections (ssm_in/ssm_out) load as MMQ weights; the small SSM
    tensors stay f32 (llama.cpp keeps them unquantized too)."""
    params = {
        "token_embd": _load_weight(reader, "token_embd.weight"),
        "output_norm": jnp.asarray(reader.load_array("output_norm.weight"),
                                   jnp.float32),
        "layers": [],
    }
    params["output"] = (_load_weight(reader, "output.weight")
                        if "output.weight" in reader.tensors
                        else params["token_embd"])
    f32 = lambda n: jnp.asarray(reader.load_array(n), jnp.float32)
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        conv_w = reader.dequantize(p + "ssm_conv1d.weight")
        params["layers"].append({
            "attn_norm": f32(p + "attn_norm.weight"),
            "ssm_in": _load_weight(reader, p + "ssm_in.weight"),
            "conv_w": jnp.asarray(
                conv_w.reshape(cfg.ssm_inner, cfg.ssm_conv), jnp.float32),
            "conv_b": f32(p + "ssm_conv1d.bias"),
            "ssm_x": _load_weight(reader, p + "ssm_x.weight"),
            "dt_w": _load_weight(reader, p + "ssm_dt.weight"),
            "dt_b": f32(p + "ssm_dt.bias"),
            "A_log": jnp.asarray(
                reader.dequantize(p + "ssm_a").reshape(
                    cfg.ssm_inner, cfg.ssm_state), jnp.float32),
            "ssm_d": f32(p + "ssm_d"),
            "ssm_out": _load_weight(reader, p + "ssm_out.weight"),
        })
    reader.close()
    params = _pad_vocab_weights(params)
    return cfg, params


def _load_phi3(reader: GGUFReader, cfg: LlamaConfig):
    """phi3 tensor schema: fused blk.i.attn_qkv (no biases, RMSNorm),
    fused ffn_up holding [gate; up] (2*ff rows, the HF gate_up_proj
    order), and model-level LongRoPE factor tensors
    rope_factors_long/short.weight — the long set applies when the
    serving context exceeds the original training context. Splits are
    M-dim lane slices (free in the K-major SoA layout); the rest of the
    stack sees the uniform llama layer dict."""
    import dataclasses

    hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q_d, kv_d = h * hd, kvh * hd
    ff = cfg.ffn_dim

    long_ctx = (cfg.rope_orig_ctx and cfg.max_seq_len > cfg.rope_orig_ctx)
    fname = ("rope_factors_long.weight" if long_ctx
             else "rope_factors_short.weight")
    if fname in reader.tensors:
        cfg = dataclasses.replace(cfg, rope_freq_factors=tuple(
            float(x) for x in reader.load_array(fname)))

    def slice_m(t, lo, hi):
        if isinstance(t, jnp.ndarray):
            return t[lo:hi]
        return jax.tree_util.tree_map(lambda a: a[..., lo:hi], t)

    params = {
        "token_embd": _load_weight(reader, "token_embd.weight"),
        "output_norm": jnp.asarray(
            reader.load_array("output_norm.weight"), jnp.float32),
        "layers": [],
    }
    params["output"] = (_load_weight(reader, "output.weight")
                        if "output.weight" in reader.tensors
                        else params["token_embd"])
    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        wqkv = _load_weight(reader, p + "attn_qkv.weight")
        up_fused = _load_weight(reader, p + "ffn_up.weight")
        params["layers"].append({
            "attn_norm": jnp.asarray(
                reader.load_array(p + "attn_norm.weight"), jnp.float32),
            "ffn_norm": jnp.asarray(
                reader.load_array(p + "ffn_norm.weight"), jnp.float32),
            "wq": slice_m(wqkv, 0, q_d),
            "wk": slice_m(wqkv, q_d, q_d + kv_d),
            "wv": slice_m(wqkv, q_d + kv_d, q_d + 2 * kv_d),
            "wo": _load_weight(reader, p + "attn_output.weight"),
            "gate": slice_m(up_fused, 0, ff),
            "up": slice_m(up_fused, ff, 2 * ff),
            "down": _load_weight(reader, p + "ffn_down.weight"),
        })
    reader.close()
    params, cfg = pad_ffn_for_tp(params, cfg, 1)
    params = _pad_vocab_weights(params)
    return cfg, params


def _load_phi2(reader: GGUFReader, cfg: LlamaConfig):
    """phi2 tensor schema: fused blk.i.attn_qkv(+bias), biased LayerNorms,
    gateless GELU MLP with biases, biased LM head. The fused QKV is split
    into wq/wk/wv at load (M-dim lane slices are free in the K-major SoA
    layout), so fuse_llama_params can re-fuse with tp interleaving and the
    rest of the stack sees the uniform layer dict."""
    import jax.tree_util

    hd, h, kvh = cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    q_d, kv_d = h * hd, kvh * hd

    params = {
        "token_embd": _load_weight(reader, "token_embd.weight"),
        "output_norm": jnp.asarray(
            reader.load_array("output_norm.weight"), jnp.float32),
        "layers": [],
    }
    if "output_norm.bias" in reader.tensors:
        params["output_norm_bias"] = jnp.asarray(
            reader.load_array("output_norm.bias"), jnp.float32)
    params["output"] = (_load_weight(reader, "output.weight")
                        if "output.weight" in reader.tensors
                        else params["token_embd"])
    if "output.bias" in reader.tensors:
        params["output_bias"] = jnp.asarray(
            reader.load_array("output.bias"), jnp.float32)

    def slice_m(t, lo, hi):
        if isinstance(t, jnp.ndarray):
            return t[lo:hi]
        return jax.tree_util.tree_map(lambda a: a[..., lo:hi], t)

    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        layer = {
            "attn_norm": jnp.asarray(
                reader.load_array(p + "attn_norm.weight"), jnp.float32),
        }
        if p + "attn_norm.bias" in reader.tensors:
            layer["attn_norm_bias"] = jnp.asarray(
                reader.load_array(p + "attn_norm.bias"), jnp.float32)
        wqkv = _load_weight(reader, p + "attn_qkv.weight")
        layer["wq"] = slice_m(wqkv, 0, q_d)
        layer["wk"] = slice_m(wqkv, q_d, q_d + kv_d)
        layer["wv"] = slice_m(wqkv, q_d + kv_d, q_d + 2 * kv_d)
        bqkv = _maybe_bias(reader, p + "attn_qkv.bias")
        if bqkv is not None:
            layer["bq"] = bqkv[:q_d]
            layer["bk"] = bqkv[q_d:q_d + kv_d]
            layer["bv"] = bqkv[q_d + kv_d:q_d + 2 * kv_d]
        layer["wo"] = _load_weight(reader, p + "attn_output.weight")
        bo = _maybe_bias(reader, p + "attn_output.bias")
        if bo is not None:
            layer["bo"] = bo
        layer["up"] = _load_weight(reader, p + "ffn_up.weight")
        layer["down"] = _load_weight(reader, p + "ffn_down.weight")
        bup = _maybe_bias(reader, p + "ffn_up.bias")
        if bup is not None:
            layer["bup"] = bup
        bdown = _maybe_bias(reader, p + "ffn_down.bias")
        if bdown is not None:
            layer["bdown"] = bdown
        params["layers"].append(layer)
    reader.close()
    params, cfg = pad_ffn_for_tp(params, cfg, 1)
    params = _pad_vocab_weights(params)
    return cfg, params


# ------------------------------------------------- synthetic checkpoints ---


def synthetic_spm_metadata(vocab_size: int) -> dict:
    """Minimal SPM tokenizer metadata for a random checkpoint: 3 specials
    (<unk>, <s>, </s>), the 256 byte-fallback tokens, then padding pieces.
    Any text encodes (byte fallback), so the serving path runs end to end."""
    tokens = ["<unk>", "<s>", "</s>"]
    tokens += [f"<0x{b:02X}>" for b in range(256)]
    tokens = (tokens + [f"<p{i}>" for i in range(vocab_size)])[:vocab_size]
    return {
        "tokenizer.ggml.tokens": tokens,
        "tokenizer.ggml.scores": np.zeros(vocab_size, np.float32),
        "tokenizer.ggml.bos_token_id": 1,
        "tokenizer.ggml.eos_token_id": 2,
    }


def write_random_llama_gguf(
    path: str,
    cfg: LlamaConfig,
    fmt: GGMLType = GGMLType.Q4_K,
    seed: int = 0,
    extra_metadata: dict | None = None,
    arch: str = "llama",
    weight_fn=None,
) -> None:
    """Create a random llama-schema GGUF checkpoint (tests / benchmarks).

    `weight_fn(rng, shape, scale) -> np.ndarray` overrides the gaussian
    projection-weight generator, e.g. to write heavy-tailed or
    outlier-channel checkpoints for accuracy probes.

    Projection weights are quantized to `fmt`; norms stay F32, the output
    head uses Q6_K when `fmt` is K-quant (mirroring llama.cpp's Q4_K_M
    recipe, where output.weight is kept at higher precision). arch="gemma"
    writes gemma metadata (explicit head_dim via attention.key_length);
    the tensor schema is shared.
    """
    rng = np.random.default_rng(seed)
    d, f, v = cfg.dim, cfg.ffn_dim, cfg.vocab_size
    q_d = cfg.n_heads * cfg.head_dim       # 0 for mamba (no attention)
    kv_d = cfg.n_kv_heads * cfg.head_dim
    scale = 0.5 / np.sqrt(d)

    def w(shape):
        if weight_fn is not None:
            return np.ascontiguousarray(
                weight_fn(rng, shape, scale).astype(np.float32))
        return (rng.standard_normal(shape) * scale).astype(np.float32)

    head_fmt = (GGMLType.Q6_K if fmt in (GGMLType.Q4_K, GGMLType.Q5_K,
                                         GGMLType.Q6_K) else fmt)

    def f32v(shape, fill=None):
        arr = (np.ones(shape, np.float32) if fill is None
               else (rng.standard_normal(shape) * 0.02).astype(np.float32))
        return (GGMLType.F32, shape, arr)

    tensors = {
        "token_embd.weight": (fmt, (v, d), quantize_tensor(w((v, d)), fmt)),
        "output.weight": (head_fmt, (v, d), quantize_tensor(w((v, d)), head_fmt)),
        "output_norm.weight": (GGMLType.F32, (d,), np.ones(d, np.float32)),
    }
    if arch == "phi2":
        tensors["output_norm.bias"] = f32v((d,), "r")
        tensors["output.bias"] = f32v((v,), "r")
    nrm = lambda n: (GGMLType.F32, (n,),
                     (1.0 + 0.1 * rng.standard_normal(n)).astype(np.float32))
    if arch == "starcoder2":
        tensors["output_norm.weight"] = nrm(d)
        tensors["output_norm.bias"] = f32v((d,), "r")
    if arch == "falcon":
        # parallel-residual LayerNorm blocks: fused unbiased qkv, GELU
        # no-gate FFN, NEOX rope; falcon-40b adds a separate mlp norm
        tensors["output_norm.weight"] = nrm(d)
        tensors["output_norm.bias"] = f32v((d,), "r")
        for i in range(cfg.n_layers):
            p = f"blk.{i}."
            tensors[p + "attn_norm.weight"] = nrm(d)
            tensors[p + "attn_norm.bias"] = f32v((d,), "r")
            tensors[p + "ffn_norm.weight"] = nrm(d)       # 40b-style
            tensors[p + "ffn_norm.bias"] = f32v((d,), "r")
            tensors[p + "attn_qkv.weight"] = (
                fmt, (q_d + 2 * kv_d, d),
                quantize_tensor(w((q_d + 2 * kv_d, d)), fmt))
            tensors[p + "attn_output.weight"] = (
                fmt, (d, q_d), quantize_tensor(w((d, q_d)), fmt))
            tensors[p + "ffn_up.weight"] = (
                fmt, (f, d), quantize_tensor(w((f, d)), fmt))
            tensors[p + "ffn_down.weight"] = (
                fmt, (d, f), quantize_tensor(w((d, f)), fmt))
        md = cfg.to_gguf_metadata(arch)
        md.update(extra_metadata or {})
        write_gguf(path, md, tensors)
        return

    if arch == "gpt2":
        # learned positions, fused biased qkv, biased LayerNorms,
        # gateless GELU FFN, tied head
        tensors["position_embd.weight"] = (
            GGMLType.F32, (cfg.max_seq_len, d),
            (rng.standard_normal((cfg.max_seq_len, d)) * scale
             ).astype(np.float32))
        tensors["output_norm.weight"] = nrm(d)
        tensors["output_norm.bias"] = f32v((d,), "r")
        del tensors["output.weight"]        # gpt2 ties the head
        for i in range(cfg.n_layers):
            p = f"blk.{i}."
            for name in ("attn_norm", "ffn_norm"):
                tensors[p + name + ".weight"] = nrm(d)
                tensors[p + name + ".bias"] = f32v((d,), "r")
            tensors[p + "attn_qkv.weight"] = (
                fmt, (q_d + 2 * kv_d, d),
                quantize_tensor(w((q_d + 2 * kv_d, d)), fmt))
            tensors[p + "attn_qkv.bias"] = f32v((q_d + 2 * kv_d,), "r")
            tensors[p + "attn_output.weight"] = (
                fmt, (d, q_d), quantize_tensor(w((d, q_d)), fmt))
            tensors[p + "attn_output.bias"] = f32v((d,), "r")
            tensors[p + "ffn_up.weight"] = (
                fmt, (f, d), quantize_tensor(w((f, d)), fmt))
            tensors[p + "ffn_up.bias"] = f32v((f,), "r")
            tensors[p + "ffn_down.weight"] = (
                fmt, (d, f), quantize_tensor(w((d, f)), fmt))
            tensors[p + "ffn_down.bias"] = f32v((d,), "r")
        md = cfg.to_gguf_metadata(arch)
        md.update(extra_metadata or {})
        write_gguf(path, md, tensors)
        return

    if arch == "gptneox":
        # Pythia/NeoX (llama.cpp LLM_ARCH_GPTNEOX): biased LayerNorms
        # everywhere, fused biased qkv, biased gateless GELU FFN, partial
        # NEOX rotary, untied head; use_parallel_residual picks the
        # block topology (metadata, written by to_gguf_metadata)
        tensors["output_norm.weight"] = nrm(d)
        tensors["output_norm.bias"] = f32v((d,), "r")
        for i in range(cfg.n_layers):
            p = f"blk.{i}."
            for name in ("attn_norm", "ffn_norm"):
                tensors[p + name + ".weight"] = nrm(d)
                tensors[p + name + ".bias"] = f32v((d,), "r")
            tensors[p + "attn_qkv.weight"] = (
                fmt, (q_d + 2 * kv_d, d),
                quantize_tensor(w((q_d + 2 * kv_d, d)), fmt))
            tensors[p + "attn_qkv.bias"] = f32v((q_d + 2 * kv_d,), "r")
            tensors[p + "attn_output.weight"] = (
                fmt, (d, q_d), quantize_tensor(w((d, q_d)), fmt))
            tensors[p + "attn_output.bias"] = f32v((d,), "r")
            tensors[p + "ffn_up.weight"] = (
                fmt, (f, d), quantize_tensor(w((f, d)), fmt))
            tensors[p + "ffn_up.bias"] = f32v((f,), "r")
            tensors[p + "ffn_down.weight"] = (
                fmt, (d, f), quantize_tensor(w((d, f)), fmt))
            tensors[p + "ffn_down.bias"] = f32v((d,), "r")
        md = cfg.to_gguf_metadata(arch)
        md.update(extra_metadata or {})
        write_gguf(path, md, tensors)
        return

    if arch == "mamba":
        di, ds = cfg.ssm_inner, cfg.ssm_state
        dr, dc = cfg.ssm_dt_rank, cfg.ssm_conv
        for i in range(cfg.n_layers):
            p = f"blk.{i}."
            tensors[p + "attn_norm.weight"] = nrm(d)
            tensors[p + "ssm_in.weight"] = (
                fmt, (2 * di, d), quantize_tensor(w((2 * di, d)), fmt))
            tensors[p + "ssm_conv1d.weight"] = (
                GGMLType.F32, (di, dc),
                (rng.standard_normal((di, dc)) * 0.3).astype(np.float32))
            tensors[p + "ssm_conv1d.bias"] = f32v((di,), "r")
            tensors[p + "ssm_x.weight"] = (
                GGMLType.F32, (dr + 2 * ds, di),
                w((dr + 2 * ds, di)) * 2)
            tensors[p + "ssm_dt.weight"] = (
                GGMLType.F32, (di, dr), w((di, dr)) * 4)
            tensors[p + "ssm_dt.bias"] = (
                GGMLType.F32, (di,),
                rng.uniform(-4.0, -1.0, di).astype(np.float32))
            tensors[p + "ssm_a"] = (
                GGMLType.F32, (di, ds),
                np.log(rng.uniform(0.5, 4.0, (di, ds))).astype(np.float32))
            tensors[p + "ssm_d"] = f32v((di,), "r")
            tensors[p + "ssm_out.weight"] = (
                fmt, (d, di), quantize_tensor(w((d, di)), fmt))
        md = cfg.to_gguf_metadata(arch)
        md.update(extra_metadata or {})
        write_gguf(path, md, tensors)
        return

    for i in range(cfg.n_layers):
        p = f"blk.{i}."
        if arch == "olmo2":
            pass   # post-norm-only: no attn_norm/ffn_norm tensors
        elif arch in ("command-r", "starcoder2", "stablelm"):
            tensors[p + "attn_norm.weight"] = nrm(d)   # LayerNorm weight
            if arch in ("starcoder2", "stablelm"):
                tensors[p + "attn_norm.bias"] = f32v((d,), "r")
        else:
            tensors[p + "attn_norm.weight"] = (GGMLType.F32, (d,),
                                               np.ones(d, np.float32))
        if arch == "phi2":
            tensors[p + "attn_norm.bias"] = f32v((d,), "r")
            for name, shape in [
                ("attn_qkv.weight", (q_d + 2 * kv_d, d)),
                ("attn_output.weight", (d, q_d)),
                ("ffn_up.weight", (f, d)), ("ffn_down.weight", (d, f)),
            ]:
                tensors[p + name] = (fmt, shape, quantize_tensor(w(shape), fmt))
            tensors[p + "attn_qkv.bias"] = f32v((q_d + 2 * kv_d,), "r")
            tensors[p + "attn_output.bias"] = f32v((d,), "r")
            tensors[p + "ffn_up.bias"] = f32v((f,), "r")
            tensors[p + "ffn_down.bias"] = f32v((d,), "r")
            continue
        if arch == "phi3":   # fused qkv + fused [gate; up], RMSNorms
            tensors[p + "ffn_norm.weight"] = (
                GGMLType.F32, (d,), np.ones(d, np.float32))
            for name, shape in [
                ("attn_qkv.weight", (q_d + 2 * kv_d, d)),
                ("attn_output.weight", (d, q_d)),
                ("ffn_up.weight", (2 * f, d)),
                ("ffn_down.weight", (d, f)),
            ]:
                tensors[p + name] = (fmt, shape, quantize_tensor(w(shape), fmt))
            continue
        if arch == "olmo2" or arch == "command-r":
            pass   # olmo2: post-norms only; command-r: one shared
            #        pre-norm feeds both parallel branches
        elif arch in ("starcoder2", "stablelm"):
            tensors[p + "ffn_norm.weight"] = nrm(d)
            tensors[p + "ffn_norm.bias"] = f32v((d,), "r")
        else:
            tensors[p + "ffn_norm.weight"] = (GGMLType.F32, (d,),
                                              np.ones(d, np.float32))
        if arch == "deepseek2":   # MLA attention + (shared-)expert FFN
            h, r, rd = cfg.n_heads, cfg.kv_lora_rank, cfg.qk_rope_dim
            nope, vd = cfg.qk_nope_dim, cfg.v_head_dim
            if cfg.q_lora_rank:
                ql = cfg.q_lora_rank
                tensors[p + "attn_q_a.weight"] = (
                    fmt, (ql, d), quantize_tensor(w((ql, d)), fmt))
                tensors[p + "attn_q_a_norm.weight"] = f32v((ql,), "r")
                # low-rank K (q_lora_rank) may not divide the superblock;
                # llama.cpp stores such tensors at the fallback type
                qb_fmt = effective_quant_type(fmt, ql)
                tensors[p + "attn_q_b.weight"] = (
                    qb_fmt, (h * (nope + rd), ql),
                    quantize_tensor(w((h * (nope + rd), ql)), qb_fmt))
            else:
                tensors[p + "attn_q.weight"] = (
                    fmt, (h * (nope + rd), d),
                    quantize_tensor(w((h * (nope + rd), d)), fmt))
            tensors[p + "attn_kv_a_mqa.weight"] = (
                fmt, (r + rd, d), quantize_tensor(w((r + rd, d)), fmt))
            tensors[p + "attn_kv_a_norm.weight"] = (
                GGMLType.F32, (r,),
                (1.0 + 0.1 * rng.standard_normal(r)).astype(np.float32))
            kvb_fmt = effective_quant_type(fmt, r)
            tensors[p + "attn_kv_b.weight"] = (
                kvb_fmt, (h * (nope + vd), r),
                quantize_tensor(w((h * (nope + vd), r)), kvb_fmt))
            tensors[p + "attn_output.weight"] = (
                fmt, (d, h * vd), quantize_tensor(w((d, h * vd)), fmt))
            if cfg.n_experts and i >= cfg.leading_dense_layers:
                e = cfg.n_experts
                ef = cfg.expert_ffn_dim or f
                tensors[p + "ffn_gate_inp.weight"] = (
                    GGMLType.F32, (e, d),
                    (rng.standard_normal((e, d)) * 0.15).astype(np.float32))
                for name, shape in [
                    ("ffn_gate_exps.weight", (e, ef, d)),
                    ("ffn_up_exps.weight", (e, ef, d)),
                    ("ffn_down_exps.weight", (e, d, ef)),
                ]:
                    tensors[p + name] = (fmt, shape,
                                         quantize_tensor(w(shape), fmt))
                if cfg.n_shared_experts:
                    sf = ef * cfg.n_shared_experts
                    for name, shape in [
                        ("ffn_gate_shexp.weight", (sf, d)),
                        ("ffn_up_shexp.weight", (sf, d)),
                        ("ffn_down_shexp.weight", (d, sf)),
                    ]:
                        tensors[p + name] = (fmt, shape,
                                             quantize_tensor(w(shape), fmt))
                if cfg.moe_gating == "sigmoid":   # V3 selection bias
                    tensors[p + "exp_probs_b.bias"] = (
                        GGMLType.F32, (e,),
                        (rng.standard_normal(e) * 0.1).astype(np.float32))
            else:
                for name, shape in [
                    ("ffn_gate.weight", (f, d)), ("ffn_up.weight", (f, d)),
                    ("ffn_down.weight", (d, f)),
                ]:
                    tensors[p + name] = (fmt, shape,
                                         quantize_tensor(w(shape), fmt))
            continue
        for name, shape in [
            ("attn_q.weight", (q_d, d)), ("attn_k.weight", (kv_d, d)),
            ("attn_v.weight", (kv_d, d)), ("attn_output.weight", (d, q_d)),
        ]:
            tensors[p + name] = (fmt, shape, quantize_tensor(w(shape), fmt))
        if arch == "starcoder2":   # biased projections
            tensors[p + "attn_q.bias"] = f32v((q_d,), "r")
            tensors[p + "attn_k.bias"] = f32v((kv_d,), "r")
            tensors[p + "attn_v.bias"] = f32v((kv_d,), "r")
            tensors[p + "attn_output.bias"] = f32v((d,), "r")
        # per-head q/k RMSNorm (random: exercised, not 1)
        if arch in ("qwen3", "qwen3moe"):
            hd = cfg.head_dim
            tensors[p + "attn_q_norm.weight"] = nrm(hd)
            tensors[p + "attn_k_norm.weight"] = nrm(hd)
        if arch == "olmo2":   # whole-vector q/k RMSNorms
            tensors[p + "attn_q_norm.weight"] = nrm(q_d)
            tensors[p + "attn_k_norm.weight"] = nrm(kv_d)
        if arch in ("gemma2", "olmo2"):
            # post-branch norms (random: exercised, not 1)
            tensors[p + "post_attention_norm.weight"] = nrm(d)
            tensors[p + "post_ffw_norm.weight"] = nrm(d)
        if cfg.n_experts:
            # mixtral-family MoE: random router (breaks routing ties so
            # tests exercise real top-k selection) + 3-D expert stacks
            e = cfg.n_experts
            # scale 0.15: sharp routing margins, so parity tests across
            # shardings/compilations don't hit top-k near-ties (a routing
            # flip from bf16 rounding changes a token's output by the
            # expert disagreement, which no numeric tolerance absorbs)
            ef = cfg.expert_ffn_dim or f
            tensors[p + "ffn_gate_inp.weight"] = (
                GGMLType.F32, (e, d),
                (rng.standard_normal((e, d)) * 0.15).astype(np.float32))
            for name, shape in [
                ("ffn_gate_exps.weight", (e, ef, d)),
                ("ffn_up_exps.weight", (e, ef, d)),
                ("ffn_down_exps.weight", (e, d, ef)),
            ]:
                tensors[p + name] = (fmt, shape,
                                     quantize_tensor(w(shape), fmt))
            if arch == "qwen2moe" and cfg.n_shared_experts:
                sf = ef * cfg.n_shared_experts
                for name, shape in [
                    ("ffn_gate_shexp.weight", (sf, d)),
                    ("ffn_up_shexp.weight", (sf, d)),
                    ("ffn_down_shexp.weight", (d, sf)),
                ]:
                    tensors[p + name] = (fmt, shape,
                                         quantize_tensor(w(shape), fmt))
                tensors[p + "ffn_gate_inp_shexp.weight"] = (
                    GGMLType.F32, (1, d),
                    (rng.standard_normal((1, d)) * 0.2).astype(np.float32))
        elif arch == "starcoder2":   # gateless biased GELU FFN
            for name, shape in [
                ("ffn_up.weight", (f, d)), ("ffn_down.weight", (d, f)),
            ]:
                tensors[p + name] = (fmt, shape,
                                     quantize_tensor(w(shape), fmt))
            tensors[p + "ffn_up.bias"] = f32v((f,), "r")
            tensors[p + "ffn_down.bias"] = f32v((d,), "r")
        else:
            for name, shape in [
                ("ffn_gate.weight", (f, d)), ("ffn_up.weight", (f, d)),
                ("ffn_down.weight", (d, f)),
            ]:
                tensors[p + name] = (fmt, shape,
                                     quantize_tensor(w(shape), fmt))

    if arch == "phi3":
        # LongRoPE factor tensors: cfg.rope_freq_factors as the long set,
        # a unit short set (the loader picks by max_seq vs orig ctx)
        rd = cfg.rope_dim or cfg.head_dim
        ff = (np.asarray(cfg.rope_freq_factors, np.float32)
              if cfg.rope_freq_factors is not None
              else np.ones(rd // 2, np.float32))
        tensors["rope_factors_long.weight"] = (GGMLType.F32, (rd // 2,), ff)
        tensors["rope_factors_short.weight"] = (
            GGMLType.F32, (rd // 2,), np.ones(rd // 2, np.float32))
    elif cfg.rope_freq_factors is not None:
        rd = cfg.rope_dim or cfg.head_dim
        ff = np.asarray(cfg.rope_freq_factors, np.float32)
        assert ff.shape == (rd // 2,), (ff.shape, rd)
        tensors["rope_freqs.weight"] = (GGMLType.F32, (rd // 2,), ff)

    md = cfg.to_gguf_metadata(arch)
    md.update(extra_metadata or {})
    write_gguf(path, md, tensors)
