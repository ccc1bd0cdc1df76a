"""Compute ops: quantized matmul (MMQ, with a Pallas kernel through Triton
for q4_k/q6_k decode widths), int8-KV decode attention and Q8_1
activation quantization."""

from .mmq import MMQ, FORMATS
from .activation import quantize_q8_1_act, fake_quantize_q8_1
from .attention import (decode_attention, decode_attention_tiled,
                        decode_attention_update, kv_cache_insert)

mmq_q8_0, mmq_q2_k, mmq_q3_k, mmq_q4_k, mmq_q5_k, mmq_q6_k = (
    MMQ[f] for f in ("q8_0", "q2_k", "q3_k", "q4_k", "q5_k", "q6_k"))
mmq_q4_0, mmq_q4_1, mmq_q5_0, mmq_q5_1 = (
    MMQ[f] for f in ("q4_0", "q4_1", "q5_0", "q5_1"))
mmq_iq4_nl, mmq_iq4_xs = MMQ["iq4_nl"], MMQ["iq4_xs"]

__all__ = [
    "FORMATS",
    "mmq_q8_0", "mmq_q2_k", "mmq_q3_k", "mmq_q4_k", "mmq_q5_k", "mmq_q6_k",
    "mmq_q4_0", "mmq_q4_1", "mmq_q5_0", "mmq_q5_1",
    "mmq_iq4_nl", "mmq_iq4_xs",
    "MMQ",
    "quantize_q8_1_act", "fake_quantize_q8_1",
    "decode_attention", "decode_attention_tiled", "decode_attention_update",
    "kv_cache_insert",
]
