"""Kernel-versus-XLA timings on the card: the evidence behind the
hand-written MMQ kernel in gguf_tpu/ops (PERF.md, "Kernel decisions").

    python benchmarks/kernel_ab.py [--ops] [--e2e] [--out FILE]

--ops  the kernel alone against its plain XLA form: the q4_k/q6_k MMQ
       GEMMs at TinyLlama-1.1B and Llama-2-7B shapes and widths n in
       {1, 16, 32} (and XLA alone at 256), and the act_quant+high
       contract form.
--e2e  the decode step end to end, kernel on and off: TinyLlama-1.1B
       (22 layers, spans 512 and 2048) and a 2-layer model at Llama-2-7B
       widths (span 2048), batch 16, in turns (on, off, off, on) within
       the process. A step is timed inside an 8-step jitted scan, the
       engine's decode chunk; a profiler trace of one chunk per arm adds
       the device's busy time per step.

Op times come from many unrolled iterations inside one jitted program
(utils/benchmark.py:time_loop), so the host's dispatch does not hide a
short op; all are host-clock medians around block_until_ready after a
warm-up, each printed with the card's name and power limit. Needs a GPU;
results also go to --out as JSON lines.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _emit(out, rec: dict) -> None:
    print(json.dumps(rec), flush=True)
    if out:
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")


def _gemm_loop(op, w, b):
    """Seconds per call of op(w, b) -> (N, M) inside a jitted loop: the
    weight passes an optimization barrier each iteration (so XLA cannot
    hoist its dequantization out of the loop), the whole output is summed
    into the carry, and the next activation depends on it."""
    import jax
    import jax.numpy as jnp

    from gguf_tpu.utils.benchmark import time_loop

    def body(c):
        w, b, acc = c
        w = jax.lax.optimization_barrier(w)
        acc = acc + op(w, b)
        return w, b + acc[:, :1] * 1e-30, acc

    m = w.shape[0]
    return time_loop(body, (w, b, jnp.zeros((b.shape[0], m), jnp.float32)))


def bench_ops(out, smi: str) -> None:
    import jax

    import chip_smoke
    from gguf_tpu.ops import mmq as mmq_mod

    kern = mmq_mod.mmq_kernel
    xla = lambda w, b: mmq_mod.mmq_xla(w, b, precision="fast")
    contract = lambda w, b: mmq_mod.MMQ[w.fmt](w, b, act_quant=True,
                                               precision="high")
    key = jax.random.PRNGKey(0)
    for fmt in ("q4_k", "q6_k"):
        for m, k in chip_smoke.GEMM_SHAPES:
            key, kw = jax.random.split(key)
            w = chip_smoke.random_quant(kw, fmt, m, k)
            wbytes = m * k // 256 * (144 if fmt == "q4_k" else 210)
            for n in (1, 16, 32, 256):
                b = jax.random.normal(jax.random.fold_in(key, n), (n, k))
                rec = {"op": "mmq", "fmt": fmt, "m": m, "k": k, "n": n,
                       "xla_us": _gemm_loop(xla, w, b) * 1e6, "card": smi}
                # the kernel's shared memory caps it below prefill widths
                if n <= 32:
                    rec["kernel_us"] = _gemm_loop(kern, w, b) * 1e6
                    rec["kernel_GBps"] = wbytes / rec["kernel_us"] / 1e3
                rec["xla_GBps"] = wbytes / rec["xla_us"] / 1e3
                if n == 16 and (m, k) in ((4096, 4096), (2048, 5632)):
                    rec["contract_us"] = _gemm_loop(contract, w, b) * 1e6
                _emit(out, rec)
            del w


def _decode_chunk(cfg, span, steps: int = 8):
    """A jitted scan of `steps` greedy decode steps, the engine's decode
    chunk, traced (when first called) under the current kernel choice."""
    import jax
    import jax.numpy as jnp

    from gguf_tpu.models import MMOpts, forward

    def chunk(p, x, pos, c):
        def step(carry, _):
            x, c = carry
            logits, c = forward(p, cfg, x, pos, c, MMOpts(precision="fast"),
                                span=span)
            return (jnp.argmax(logits[:, -1], -1).astype(jnp.int32)[:, None],
                    c), None
        (x, c), _ = jax.lax.scan(step, (x, c), None, length=steps)
        return x

    return jax.jit(chunk)


def bench_e2e(out, smi: str, steps: int = 8) -> None:
    import jax
    import jax.numpy as jnp

    import chip_smoke
    from gguf_tpu.models import fuse_llama_params, init_kv_cache, load_llama
    from gguf_tpu.models.presets import PRESETS
    from gguf_tpu.ops import mmq as mmq_mod
    from gguf_tpu.utils.benchmark import device_kernel_time, time_call
    from gguf_tpu.utils.paths import generated_path

    kernel_use = mmq_mod.use_kernel
    arms = {"kernel": kernel_use, "xla": lambda *a: False}
    order = ["kernel", "xla", "xla", "kernel"]
    seven = PRESETS["llama2-7b"]
    models = [("tinyllama-1.1b", PRESETS["tinyllama-1.1b"],
               "tinyllama-1.1b-q4km.gguf", (512, 2048)),
              ("llama2-7b-widths-2L", dataclasses.replace(seven, n_layers=2),
               "llama2-7b-widths-2layers-q4km.gguf", (2048,))]
    batch = 16
    for label, cfg, fname, spans in models:
        path = chip_smoke.write_checkpoint(cfg, fname)
        cfg, params = load_llama(path)
        params = fuse_llama_params(params)
        for span in spans:
            args = (params, jnp.zeros((batch, 1), jnp.int32),
                    jnp.full((batch,), span - 1, jnp.int32),
                    init_kv_cache(cfg, batch, span))
            runs = {}
            for arm, use in arms.items():
                mmq_mod.use_kernel = use
                try:
                    runs[arm] = _decode_chunk(cfg, span, steps)
                    jax.block_until_ready(runs[arm](*args))   # compile
                finally:
                    mmq_mod.use_kernel = kernel_use
            rec = {"op": "decode_step", "model": label, "batch": batch,
                   "span": span, "card": smi}
            for arm in order:
                rec.setdefault(f"{arm}_ms", []).append(
                    time_call(runs[arm], *args, iters=10) / steps * 1e3)
            _emit(out, rec)
            trace = {"op": "decode_step_trace", "model": label,
                     "batch": batch, "span": span, "card": smi}
            for arm, run in runs.items():
                busy, per_kernel = device_kernel_time(
                    run, *args, trace_dir=generated_path(f"trace-{arm}"))
                trace[f"{arm}_device_busy_ms"] = busy / steps * 1e3
                top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:5]
                trace[f"{arm}_top_kernels_ms"] = {
                    k[:60]: v / steps * 1e3 for k, v in top}
            _emit(out, trace)
        del params


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ops", action="store_true")
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    from gguf_tpu.utils.benchmark import nvidia_smi_name_power
    from gguf_tpu.utils.paths import enable_compile_cache

    enable_compile_cache()
    import jax

    if jax.devices()[0].platform != "gpu":
        print("kernel_ab: needs a GPU", file=sys.stderr)
        return 2
    smi = nvidia_smi_name_power()
    print(f"device: {jax.devices()[0].device_kind}; nvidia-smi: {smi}",
          flush=True)
    if args.ops:
        bench_ops(args.out, smi)
    if args.e2e:
        bench_e2e(args.out, smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
