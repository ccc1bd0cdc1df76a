"""Published model widths the smoke test and the benchmark build from.

Each preset is the model's published configuration (hidden size, layers,
heads, KV heads, FFN width, vocabulary). Weights are random from a seed
(`write_random_llama_gguf`); no checkpoint is downloaded.

- tinyllama-1.1b: TinyLlama/TinyLlama-1.1B-Chat-v1.0 config.json (22 layers,
  dim 2048, 32 heads, 4 KV heads, head_dim 64, FFN 5632, vocab 32000).
- llama2-7b: meta-llama/Llama-2-7b-hf config.json (32 layers, dim 4096,
  32 MHA heads, head_dim 128, FFN 11008, vocab 32000).
- llama2-13b: meta-llama/Llama-2-13b-hf config.json (40 layers, dim 5120,
  40 MHA heads, FFN 13824, vocab 32000).
"""

from __future__ import annotations

from .config import LlamaConfig

PRESETS: dict[str, LlamaConfig] = {
    "tinyllama-1.1b": LlamaConfig(
        vocab_size=32000, dim=2048, n_layers=22, n_heads=32, n_kv_heads=4,
        ffn_dim=5632, max_seq_len=2048),
    "llama2-7b": LlamaConfig(
        vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=32,
        ffn_dim=11008, max_seq_len=2048),
    "llama2-13b": LlamaConfig(
        vocab_size=32000, dim=5120, n_layers=40, n_heads=40, n_kv_heads=40,
        ffn_dim=13824, max_seq_len=2048),
}
