"""gguf_tpu — a GGUF quantized-inference framework in JAX.

From-scratch JAX/Pallas re-design of the capability set of
`PowerfulGhost/gguf-triton-kernel` (fused dequantize+matmul "MMQ" kernels for
GGUF block-quantized formats), extended into a serving stack:

- `gguf_tpu.quant`   — GGUF codecs (Q8_0/Q8_1/Q4_K/Q6_K), bit-exact native
                       quantizer cores (csrc/), SoA device layouts, CPU goldens
- `gguf_tpu.ops`     — MMQ ops (XLA and Pallas/Triton kernels) + attention
- `gguf_tpu.gguf`    — GGUF v2/v3 file reader/writer (mmap, sharded loads)
- `gguf_tpu.models`  — Llama-family decoder built on the MMQ kernels
- `gguf_tpu.parallel`— mesh / sharding / collectives (tensor parallel)
- `gguf_tpu.engine`  — serving engine: continuous batching, INT8 KV cache
- `gguf_tpu.utils`   — test tolerances, SNR analysis, timing and tracing
"""

__version__ = "0.1.0"
