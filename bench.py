"""Quick benchmark: prints ONE JSON line on stdout.

Metric: effective weight bandwidth of `mmq_q4_k` on a 4096x4096 GEMM at 16
decode tokens — GGUF weight bytes read per second of call time.
`vs_baseline` is the speedup over the same GEMM from bf16 weights through
XLA's own dot on the same device (which reads 3.6x the bytes).

Extra fields:

- value_act_quant: the same GEMM under the reference numeric contract
  (Q8_1 activation fake-quant, f32 operands at HIGHEST, act_quant=True,
  precision="high").
- e2e_2layer_tokens_per_s: decode throughput of a 2-layer TinyLlama-shaped
  toy (vocab 4096, dim 2048 — not a real checkpoint) at batch 16 through
  forward().
- device: platform, device kind and count as JAX reports them, and the
  card's name and power limit from nvidia-smi.

Times are host-clock medians around `block_until_ready`, after a warm-up
call that compiles each shape (gguf_tpu/utils/benchmark.py). The run needs
an accelerator: on a CPU backend it exits non-zero and prints no result.
Any failure exits non-zero. `python chip_smoke.py` checks correctness end
to end on the card.
"""

import json
import sys

import numpy as np


def main() -> int:
    from gguf_tpu.utils.paths import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    from gguf_tpu.ops import mmq_q4_k
    from gguf_tpu.quant import quantize_q4_k
    from gguf_tpu.quant.layouts import to_soa
    from gguf_tpu.utils.benchmark import device_info, time_call

    info = device_info()
    if info["platform"] == "cpu":
        print("bench.py: no accelerator found (JAX platform 'cpu')",
              file=sys.stderr)
        return 2

    m = k = 4096
    n = 16
    rng = np.random.default_rng(0)
    a = rng.standard_normal((m, k)).astype(np.float32)
    w = to_soa("q4_k", quantize_q4_k(a), m, k)
    x = jnp.asarray(rng.standard_normal((n, k)).astype(np.float32))
    wbytes = m * k // 256 * 144

    fast = jax.jit(lambda w_, x_: mmq_q4_k(w_, x_, precision="fast",
                                           act_quant=False))
    t_mmq = time_call(fast, w, x)
    contract = jax.jit(lambda w_, x_: mmq_q4_k(w_, x_, precision="high",
                                               act_quant=True))
    t_aq = time_call(contract, w, x)
    wb16 = jnp.asarray(a, jnp.bfloat16)
    ref = jax.jit(lambda w_, x_: jax.lax.dot_general(
        x_.astype(jnp.bfloat16), w_, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32))
    t_ref = time_call(ref, wb16, x)

    from __graft_entry__ import _flagship
    from gguf_tpu.models import (MMOpts, forward, fuse_llama_params,
                                 init_kv_cache)

    cfg, params = _flagship()
    params = fuse_llama_params(params)
    batch = 16
    cache = init_kv_cache(cfg, batch=batch, max_seq=128)
    tokens = jnp.zeros((batch, 1), jnp.int32)
    pos = jnp.arange(batch, dtype=jnp.int32)
    step = jax.jit(lambda p, t, q, c: forward(
        p, cfg, t, q, c, MMOpts(precision="fast"), span=128)[0])
    t_step = time_call(step, params, tokens, pos, cache)

    print(json.dumps({
        "metric": "mmq_q4_k 4096x4096 GEMM @16 decode tokens, "
                  "effective weight bandwidth",
        "value": wbytes / t_mmq / 1e9,
        "unit": "GB/s",
        "vs_baseline": t_ref / t_mmq,
        "value_act_quant": wbytes / t_aq / 1e9,
        "e2e_2layer_tokens_per_s": batch / t_step,
        "device": info,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
