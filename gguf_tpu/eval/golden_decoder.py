"""Byte-exact golden decoder — the end-to-end accuracy oracle.

BASELINE.md's accuracy target is "perplexity within 0.01 of llama.cpp at
the same bit-width". llama.cpp itself is not in this environment, but its
MMQ numeric contract is: every projection is an exact integer dot between
the GGUF weight bytes and Q8_1-quantized activations, scaled by the block
scales (the contract the CPU goldens implement byte-for-byte,
quant/golden.py; reference lineage /root/reference/kernels/cpu_impls/).

This module runs a WHOLE forward pass in that contract — pure numpy, no
JAX, no Pallas — so `perplexity_of_gguf(..., act_quant=True)` (the served
path) can be gated against an independently-computed number:

    served (MMQ ops, jit)               golden (this file, numpy)
    ---------------------------         --------------------------------
    fake_quantize_q8_1 -> MMQ Pallas    quantize_q8_1 bytes -> golden MMQ
    bf16 residual stream                ml_dtypes.bfloat16 residual stream
    INT8 KV cache round-trip            same quantizer, numpy
    f32 norms/rope/softmax              same, numpy

tests/test_perplexity.py asserts the two perplexities agree within the
BASELINE tolerance. Differences that remain are float associativity (XLA
reduces in different orders) — orders of magnitude below the 0.01 gate.

Only the scoring path is implemented (full-window prefill, the shape
llama.cpp's perplexity tool evaluates); this is an oracle, not a server.
"""

from __future__ import annotations

import numpy as np

try:
    import ml_dtypes

    BF16 = ml_dtypes.bfloat16
except ImportError:          # pragma: no cover - ml_dtypes ships with jax
    BF16 = np.float32

from ..gguf.constants import GGML_TO_FMT, GGMLType
from ..gguf.reader import GGUFReader
from ..quant import golden as G
from ..quant.q8_1 import quantize_q8_1

GOLDEN_MMQ = {
    "q8_0": G.mmq_q8_0_q8_1_golden,
    "q2_k": G.mmq_q2_k_q8_1_golden,
    "q3_k": G.mmq_q3_k_q8_1_golden,
    "q4_k": G.mmq_q4_k_q8_1_golden,
    "q5_k": G.mmq_q5_k_q8_1_golden,
    "q6_k": G.mmq_q6_k_q8_1_golden,
    "q4_0": G.mmq_q4_0_q8_1_golden,
    "q4_1": G.mmq_q4_1_q8_1_golden,
    "q5_0": G.mmq_q5_0_q8_1_golden,
    "q5_1": G.mmq_q5_1_q8_1_golden,
    "iq4_nl": G.mmq_iq4_nl_q8_1_golden,
    "iq4_xs": G.mmq_iq4_xs_q8_1_golden,
}


class _QuantWeight:
    """(M, K) quantized matrix held as raw GGUF bytes + format tag."""

    def __init__(self, fmt: str, qbytes: np.ndarray, m: int, k: int):
        self.fmt, self.qbytes, self.m, self.k = fmt, qbytes, m, k

    def matmul_q8_1(self, x: np.ndarray) -> np.ndarray:
        """x (N, K) float -> x @ W^T (N, M) f32 through the byte-exact
        golden: activations quantized to Q8_1 (fp16 scale semantics),
        integer dots per block."""
        n = x.shape[0]
        bq = quantize_q8_1(np.asarray(x, dtype=np.float16))
        return GOLDEN_MMQ[self.fmt](self.qbytes, bq, self.m, n, self.k)

    def dequantize(self) -> np.ndarray:
        import gguf_tpu.quant as Q

        deq = getattr(Q, f"dequantize_{self.fmt}")
        return np.asarray(deq(self.qbytes, (self.m, self.k)), np.float32)


def _load_golden(path: str):
    """GGUF -> (cfg, params) with quantized weights kept as raw bytes."""
    from ..models.config import LlamaConfig

    with GGUFReader(path) as r:
        cfg = LlamaConfig.from_gguf_metadata(r.metadata)

        def w(name):
            ti = r.tensors[name]
            fmt = GGML_TO_FMT.get(ti.ggml_type)
            if fmt is None:      # F16/F32 tensor: plain float matrix
                return np.asarray(r.load_array(name), np.float32)
            m, k = ti.shape
            return _QuantWeight(fmt, r.tensor_bytes(name).copy(), m, k)

        def f32(name):
            return np.asarray(r.load_array(name), np.float32)

        params = {
            "token_embd": w("token_embd.weight"),
            "output_norm": f32("output_norm.weight"),
            "output": (w("output.weight")
                       if "output.weight" in r.tensors
                       else w("token_embd.weight")),
            "layers": [],
        }
        for i in range(cfg.n_layers):
            p = f"blk.{i}."
            layer = {
                "attn_norm": f32(p + "attn_norm.weight"),
                "ffn_norm": f32(p + "ffn_norm.weight"),
                "wq": w(p + "attn_q.weight"),
                "wk": w(p + "attn_k.weight"),
                "wv": w(p + "attn_v.weight"),
                "wo": w(p + "attn_output.weight"),
                "gate": w(p + "ffn_gate.weight"),
                "up": w(p + "ffn_up.weight"),
                "down": w(p + "ffn_down.weight"),
            }
            for b, nm in (("bq", "attn_q.bias"), ("bk", "attn_k.bias"),
                          ("bv", "attn_v.bias"),
                          ("q_norm", "attn_q_norm.weight"),
                          ("k_norm", "attn_k_norm.weight")):
                if p + nm in r.tensors:
                    layer[b] = f32(p + nm)
            params["layers"].append(layer)
        return cfg, params


def _linear(wq, x_bf16: np.ndarray) -> np.ndarray:
    """Mirror of models/llama.py:linear — golden MMQ for quantized weights,
    float matmul otherwise; output rounded to the bf16 residual dtype."""
    x32 = x_bf16.astype(np.float32)
    if isinstance(wq, _QuantWeight):
        out = wq.matmul_q8_1(x32)
    else:
        out = x32 @ wq.T.astype(np.float32)
    return out.astype(BF16)


def _rms_norm(x_bf16, weight, eps):
    xf = x_bf16.astype(np.float32)
    var = np.mean(xf * xf, axis=-1, keepdims=True)
    return (xf / np.sqrt(var + eps) * weight).astype(BF16)


def _rope(x_bf16, positions, theta, scale, cfg=None):
    """Consecutive-pair rotation on (T, H, hd), f32 math, bf16 out.
    With a cfg, mirrors models/llama.py:rope_for_cfg (yarn per-dim
    interpolation ramp + mscale, optional rope_freqs divisors)."""
    t, h, hd = x_bf16.shape
    freqs = theta ** (-np.arange(0, hd, 2, dtype=np.float32) / hd)
    if cfg is not None and cfg.rope_freq_factors is not None:
        freqs = freqs / np.asarray(cfg.rope_freq_factors, np.float32)
    if cfg is not None and cfg.rope_scaling_kind == "longrope":
        # phi3: the per-dim factors carry all position scaling; the
        # converter's attention-magnitude factor rides on cos/sin
        ang = positions.astype(np.float32)[:, None] * freqs
        m = np.float32(cfg.rope_attn_factor)
        cos, sin = np.cos(ang) * m, np.sin(ang) * m
    elif cfg is not None and cfg.rope_scaling_kind == "yarn":
        import math

        from ..models.llama import yarn_corr_dims

        extrap = positions.astype(np.float32)[:, None] * freqs
        low, high = yarn_corr_dims(hd, cfg.rope_orig_ctx or cfg.max_seq_len,
                                   theta)
        i_half = np.arange(hd // 2, dtype=np.float32)
        ramp = 1.0 - np.clip((i_half - low) / max(1e-3, high - low), 0.0, 1.0)
        ang = (extrap / scale) * (1.0 - ramp) + extrap * ramp
        mscale = np.float32(cfg.rope_attn_factor
                            * (1.0 + 0.1 * math.log(scale)))
        cos, sin = np.cos(ang) * mscale, np.sin(ang) * mscale
    else:
        ang = (positions.astype(np.float32) / scale)[:, None] * freqs
        cos, sin = np.cos(ang), np.sin(ang)
    if cfg is not None and cfg.rope_neox:
        # rotate-half (ROPE_TYPE_NEOX): dims (j, j+hd/2) rotate by angle j
        xf = x_bf16.astype(np.float32)
        half = hd // 2
        x1, x2 = xf[..., :half], xf[..., half:]
        return np.concatenate(
            [x1 * cos[:, None] - x2 * sin[:, None],
             x1 * sin[:, None] + x2 * cos[:, None]], -1).astype(BF16)
    xf = x_bf16.astype(np.float32).reshape(t, h, hd // 2, 2)
    e, o = xf[..., 0], xf[..., 1]
    out = np.empty_like(xf)
    out[..., 0] = e * cos[:, None] - o * sin[:, None]
    out[..., 1] = e * sin[:, None] + o * cos[:, None]
    return out.reshape(t, h, hd).astype(BF16)


def _int8_kv_roundtrip(x_bf16):
    """Mirror of models/llama.py:_quantize_kv on (T, KVH, hd): per-(t, h)
    absmax/127 scale, rint codes, dequantized back to f32."""
    amax = np.max(np.abs(x_bf16), axis=-1)               # bf16 max
    scale = (amax / BF16(127.0)).astype(np.float32)      # bf16 div, f32 cast
    safe = np.where(scale == 0, 1.0, scale).astype(np.float32)
    q = np.clip(np.rint(x_bf16.astype(np.float32) / safe[..., None]),
                -127, 127).astype(np.int8)
    return q.astype(np.float32) * scale[..., None]


def golden_window_logits(cfg, params, tokens: np.ndarray) -> np.ndarray:
    """One full-window forward (T,) int tokens -> (T, vocab) f32 logits,
    entirely in the golden numeric contract."""
    t = len(tokens)
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = np.arange(t)

    emb = params["token_embd"]
    if isinstance(emb, _QuantWeight):
        table = emb.dequantize()
    else:
        table = emb
    x = table[tokens].astype(BF16)                       # (T, dim)

    for layer in params["layers"]:
        hn = _rms_norm(x, layer["attn_norm"], cfg.norm_eps)
        q = _linear(layer["wq"], hn)
        k = _linear(layer["wk"], hn)
        v = _linear(layer["wv"], hn)
        if "bq" in layer:
            q = (q.astype(np.float32) + layer["bq"]).astype(BF16)
            k = (k.astype(np.float32) + layer["bk"]).astype(BF16)
            v = (v.astype(np.float32) + layer["bv"]).astype(BF16)
        q = q.reshape(t, h, hd)
        k = k.reshape(t, kvh, hd)
        v = v.reshape(t, kvh, hd)
        if "q_norm" in layer:   # qwen3-family per-head q/k RMSNorm, pre-RoPE
            q = _rms_norm(q, layer["q_norm"], cfg.norm_eps)
            k = _rms_norm(k, layer["k_norm"], cfg.norm_eps)
        q = _rope(q, pos, cfg.rope_theta, cfg.rope_scale, cfg)
        k = _rope(k, pos, cfg.rope_theta, cfg.rope_scale, cfg)

        # the served full-window path round-trips K/V through the INT8 cache
        kf = _int8_kv_roundtrip(k.transpose(1, 0, 2))    # (KVH, T, hd) f32
        vf = _int8_kv_roundtrip(v.transpose(1, 0, 2))

        group = h // kvh
        qf = q.astype(np.float32).transpose(1, 0, 2)     # (H, T, hd)
        out = np.empty((h, t, hd), np.float32)
        causal = pos[None, :] <= pos[:, None]            # (Tq, Ts)
        for hh in range(h):
            g = hh // group
            scores = qf[hh] @ kf[g].T / np.sqrt(hd).astype(np.float32)
            scores = np.where(causal, scores, -np.inf)
            m = scores.max(axis=-1, keepdims=True)
            e = np.exp(scores - m)
            probs = e / e.sum(axis=-1, keepdims=True)
            out[hh] = probs @ vf[g]
        attn = out.transpose(1, 0, 2).reshape(t, h * hd).astype(BF16)
        x = (x.astype(np.float32)
             + _linear(layer["wo"], attn).astype(np.float32)).astype(BF16)

        hn = _rms_norm(x, layer["ffn_norm"], cfg.norm_eps)
        g32 = _linear(layer["gate"], hn).astype(np.float32)
        act = (g32 / (1.0 + np.exp(-g32))).astype(BF16)
        u = _linear(layer["up"], hn)
        prod = (act.astype(np.float32) * u.astype(np.float32)).astype(BF16)
        x = (x.astype(np.float32)
             + _linear(layer["down"], prod).astype(np.float32)).astype(BF16)

    x = _rms_norm(x, params["output_norm"], cfg.norm_eps)
    logits = _linear(params["output"], x).astype(np.float32)
    return logits[:, :cfg.vocab_size]


def golden_perplexity(path: str, token_ids, *, window: int = 512,
                      full_window: bool = False) -> float:
    """llama.cpp-accounting perplexity through the golden decoder — the
    independent number `perplexity_of_gguf(act_quant=True)` is gated
    against (same windowing as eval/perplexity.py:sequence_nll)."""
    cfg, params = _load_golden(path)
    ids = np.asarray(token_ids, dtype=np.int64).reshape(-1)
    window = min(window, cfg.max_seq_len)
    first = 1 if full_window else max(1, window // 2)

    total, count = 0.0, 0
    for lo in range(0, len(ids), window):
        chunk = ids[lo:lo + window]
        if len(chunk) < 2:
            continue
        logits = golden_window_logits(cfg, params, chunk)
        lse = _log_softmax(logits[:-1])
        nll = -lse[np.arange(len(chunk) - 1), chunk[1:]]
        idx = np.arange(1, len(chunk))
        valid = idx >= first
        total += float(nll[valid].sum())
        count += int(valid.sum())
    return float(np.exp(total / max(count, 1)))


def _log_softmax(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    e = x - m
    return e - np.log(np.exp(e).sum(axis=-1, keepdims=True))
