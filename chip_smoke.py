"""On-card smoke test of the GGUF serving path.

    python chip_smoke.py          # one card
    python chip_smoke.py --four   # four cards: the tensor/data-parallel path

One card, in one process:

  phase 0  the device: a GPU, or exit non-zero before any result.
  phase 1  kernel parity at real widths: every MMQ form of q4_k and q6_k at
           TinyLlama-1.1B and Llama-2-7B GEMM shapes and decode/prefill
           widths, the other ten formats once each, the int8-KV cache
           insert, and decode attention at head_dim 64 and 128 — each
           against the plain reference (`QuantTensor.dequantize()` in f32
           and a dot at Precision.HIGHEST; an f32 einsum over the
           dequantized span).
  phase 2  end to end at TinyLlama-1.1B's published width (22 layers,
           Q4_K_M recipe, random weights from seed 0): first-step logits of
           `forward()` against the same forward on f32-dequantized weights,
           `LLM(max_batch=16).generate`, and the HTTP server answering
           /v1/completions (one request streaming). Prints bring-up readings
           (decode step time, tokens/s, compile seconds, peak device
           memory) beside the card's name and power limit.

`--four` runs only the multi-card path and what it is compared with:
`LLM(tp=4)` and `LLM(dp=2, tp=2)` on the same checkpoint, their first-step
logits against the one-card forward.

The last line of stdout is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time
import urllib.request

import numpy as np

# GEMM shapes (M, K) at TinyLlama-1.1B and Llama-2-7B widths: fused qkv,
# fused gate_up, down, LM head / wo, gate_up, down, LM head
GEMM_SHAPES = [(2560, 2048), (11264, 2048), (2048, 5632), (32000, 2048),
               (4096, 4096), (22528, 4096), (4096, 11008), (32000, 4096)]
WIDTHS = (1, 16, 32, 512)
# (head_dim, batch, heads, kv heads): TinyLlama GQA, Llama-2-7B MHA
ATTN_CASES = [(64, 16, 32, 4), (128, 16, 32, 32)]
SPANS = (128, 512, 2048)
OTHER_SHAPE = (512, 4096)

# Tolerances, as max|got - ref| / max|ref|:
# - fast: bf16 operands (8 significant bits) summed in f32 over K <= 11008;
#   the rounding errors are independent, so the relative error of a dot
#   stays near 2^-9 and 1e-2 leaves a wide margin while still catching any
#   wrong scale, code or permutation (those give O(1) errors).
# - high: f32 operands at HIGHEST; only summation order differs from the
#   reference, far below 1e-4.
TOL = {"fast": 1e-2, "high": 1e-4}
# Model logits carry the bf16 hidden state of forward() through 22 layers
# on both sides; the reference differs in its f32 weights and dots.
LOGIT_TOL = 5e-2


class Checks:
    """Collects pass/fail lines; `failed` lists what exceeded tolerance."""

    def __init__(self):
        self.failed: list[str] = []

    def __call__(self, name: str, err: float, tol: float, precision: str,
                 path: str) -> None:
        ok = bool(np.isfinite(err)) and err <= tol
        print(f"  {'ok  ' if ok else 'FAIL'} {name:<44} path={path:<6} "
              f"precision={precision:<4} max_rel_err={err:.3e} tol={tol:.0e}",
              flush=True)
        if not ok:
            self.failed.append(name)


def _rel_err(got, ref) -> float:
    got = np.asarray(got, np.float64)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30))


def random_quant(key, fmt: str, m: int, k: int):
    """A random (M, K) q4_k/q6_k weight built directly in the SoA layout on
    the device: random codes, 6-bit or int8 sub-scales, fp16 scales in
    [2e-4, 2e-3]."""
    import jax
    import jax.numpy as jnp

    from gguf_tpu.quant.layouts import QuantTensor

    sb = k // 256
    ks = jax.random.split(key, 5)

    def u8(kk, shape, hi=256):
        return jax.random.randint(kk, shape, 0, hi,
                                  jnp.int32).astype(jnp.uint8)

    def f16bits(kk, shape):
        d = jax.random.uniform(kk, shape, jnp.float32, 2e-4, 2e-3)
        return jax.lax.bitcast_convert_type(d.astype(jnp.float16), jnp.uint16)

    if fmt == "q4_k":
        return QuantTensor("q4_k", d_bits=f16bits(ks[0], (sb, m)),
                           dmin_bits=f16bits(ks[1], (sb, m)),
                           sc=u8(ks[2], (sb * 8, m), 64),
                           mn=u8(ks[3], (sb * 8, m), 64),
                           qs=u8(ks[4], (k // 2, m)))
    assert fmt == "q6_k", fmt
    return QuantTensor("q6_k", d_bits=f16bits(ks[0], (sb, m)),
                       sc=jax.random.randint(ks[1], (sb * 16, m), -128, 128,
                                             jnp.int32).astype(jnp.int8),
                       ql=u8(ks[2], (k // 2, m)), qh=u8(ks[3], (k // 4, m)))


def phase_kernels(check: Checks, shapes=GEMM_SHAPES, widths=WIDTHS,
                  attn_cases=ATTN_CASES, spans=SPANS, cache_len=2048,
                  other_shape=OTHER_SHAPE) -> None:
    """Phase 1: every translated kernel against the plain reference."""
    import jax
    import jax.numpy as jnp

    from gguf_tpu.ops import FORMATS, MMQ, attention as attn, mmq as mmq_mod
    from gguf_tpu.ops.common import on_gpu
    from gguf_tpu.quant.layouts import quantize_to_soa

    hi = jax.lax.Precision.HIGHEST
    dims = (((1,), (1,)), ((), ()))
    ref_mm = jax.jit(lambda w, b: jax.lax.dot_general(
        b, w.dequantize(), dims, precision=hi,
        preferred_element_type=jnp.float32))
    gpu = on_gpu()
    key = jax.random.PRNGKey(0)

    print("phase 1: MMQ q4_k / q6_k at real widths", flush=True)
    for fmt in ("q4_k", "q6_k"):
        for m, k in shapes:
            key, kw, kb = jax.random.split(key, 3)
            w = random_quant(kw, fmt, m, k)
            for n in widths:
                b = jax.random.normal(jax.random.fold_in(kb, n), (n, k),
                                      jnp.float32)
                ref = ref_mm(w, b)
                got = MMQ[fmt](w, b, act_quant=False, precision="fast")
                path = ("kernel" if mmq_mod.use_kernel(fmt, n, "fast", gpu)
                        else "xla")
                check(f"{fmt} {m}x{k} n={n}", _rel_err(got, ref),
                      TOL["fast"], "fast", path)
                if n == 16:
                    got = MMQ[fmt](w, b, act_quant=False, precision="high")
                    check(f"{fmt} {m}x{k} n={n}", _rel_err(got, ref),
                          TOL["high"], "high", "xla")
            del w

    print("phase 1: the other formats through MMQ[fmt]", flush=True)
    m, k = other_shape
    rng = np.random.default_rng(0)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = jnp.asarray(rng.standard_normal((16, k)).astype(np.float32))
    for fmt in FORMATS:
        if fmt in ("q4_k", "q6_k"):
            continue
        w = quantize_to_soa(a, fmt)
        ref = ref_mm(w, b)
        for precision in ("fast", "high"):
            got = MMQ[fmt](w, b, act_quant=False, precision=precision)
            check(f"{fmt} {m}x{k} n=16", _rel_err(got, ref), TOL[precision],
                  precision, "xla")

    print("phase 1: int8 KV cache insert and decode attention", flush=True)
    for hd, bsz, h, kvh in attn_cases:
        key, *ks = jax.random.split(key, 7)
        k_c = jax.random.randint(ks[0], (bsz, kvh, cache_len, hd), -127, 128,
                                 jnp.int32).astype(jnp.int8)
        v_c = jax.random.randint(ks[1], (bsz, kvh, cache_len, hd), -127, 128,
                                 jnp.int32).astype(jnp.int8)
        k_s = jax.random.uniform(ks[2], (bsz, kvh, cache_len), jnp.float32,
                                 0.005, 0.02)
        v_s = jax.random.uniform(ks[3], (bsz, kvh, cache_len), jnp.float32,
                                 0.005, 0.02)
        q = jax.random.normal(ks[4], (bsz, h, 1, hd), jnp.float32)

        # insert: the new rows land exactly at pos, nothing else changes
        new = jax.random.normal(ks[5], (bsz, kvh, 1, hd), jnp.float32)
        pos = jnp.arange(bsz, dtype=jnp.int32) * 7 % cache_len
        k2, ks2, _, _ = attn.kv_cache_insert(new, new, k_c, k_s, v_c, v_s,
                                             pos, t=1)
        # codes within one step and scales within f32 rounding of the
        # eager quantizer (jit may turn /127 into a multiply)
        qn, sn = attn.quantize_kv(new[:, :, 0])
        bi = jnp.arange(bsz)
        codes_ok = bool((jnp.abs(k2[bi, :, pos].astype(jnp.int32)
                                 - qn.astype(jnp.int32)) <= 1).all())
        changed = (k2 != k_c).any(axis=(1, 3)) | (ks2 != k_s).any(axis=1)
        only_rows = bool((changed & (jnp.arange(cache_len)[None, :]
                                     != pos[:, None])).sum() == 0)
        err = _rel_err(ks2[bi, :, pos], sn)
        check(f"kv_cache_insert hd={hd} b={bsz}",
              err if codes_ok and only_rows else float("inf"), 1e-6, "int8",
              "xla")

        for span in spans:
            p = jax.random.randint(jax.random.fold_in(key, span), (bsz,), 0,
                                   span, jnp.int32).at[0].set(span - 1)
            ref = _attention_reference(q, k_c, k_s, v_c, v_s, p, span)
            for precision, window, softcap in (("fast", 0, 0.0),
                                               ("fast", 96, 30.0),
                                               ("high", 0, 0.0)):
                if window and span != spans[-1]:
                    continue
                got = attn.decode_attention(
                    q, k_c, k_s, v_c, v_s, p, t=1, precision=precision,
                    span=span, window=window, softcap=softcap)
                r = ref if not window else _attention_reference(
                    q, k_c, k_s, v_c, v_s, p, span, window, softcap)
                extra = f" window={window} softcap={softcap:g}" if window \
                    else ""
                check(f"attention hd={hd} b={bsz} span={span}{extra}",
                      _rel_err(got, r), TOL[precision], precision, "xla")


def _attention_reference(q, k, ks, v, vs, pos, span, window=0, softcap=0.0):
    """f32 einsum attention over the dequantized span prefix (HIGHEST)."""
    import jax
    import jax.numpy as jnp

    hi = jax.lax.Precision.HIGHEST
    b, h, _, hd = q.shape
    kvh = k.shape[1]
    kf = k[:, :, :span].astype(jnp.float32) * ks[:, :, :span, None]
    vf = v[:, :, :span].astype(jnp.float32) * vs[:, :, :span, None]
    qg = q.reshape(b, kvh, h // kvh, hd)
    s = jnp.einsum("bgqd,bgsd->bgqs", qg, kf, precision=hi) / jnp.sqrt(
        jnp.float32(hd))
    if softcap:
        s = softcap * jnp.tanh(s / softcap)
    col = jnp.arange(span)[None, None, None, :]
    live = col <= pos[:, None, None, None]
    if window:
        live &= col > pos[:, None, None, None] - window
    p = jax.nn.softmax(jnp.where(live, s, -jnp.inf), axis=-1)
    return jnp.einsum("bgqs,bgsd->bgqd", p, vf,
                      precision=hi).reshape(b, h, 1, hd)


def write_checkpoint(cfg, name: str, seed: int = 0) -> str:
    """The random-weight Q4_K_M checkpoint under .generated/, with a
    byte-fallback SPM vocabulary. Written once per checkout and
    configuration: the file name carries a digest of the configuration,
    so a file written for another one is never picked up."""
    import hashlib
    import os

    from gguf_tpu.models import write_random_llama_gguf
    from gguf_tpu.models.loader import synthetic_spm_metadata
    from gguf_tpu.utils.paths import generated_path

    digest = hashlib.sha256(repr((cfg, seed)).encode()).hexdigest()[:12]
    stem, ext = os.path.splitext(name)
    path = generated_path(f"{stem}-{digest}{ext}")
    if not os.path.exists(path):
        t0 = time.perf_counter()
        write_random_llama_gguf(
            path + ".part", cfg, seed=seed,
            extra_metadata=synthetic_spm_metadata(cfg.vocab_size))
        os.replace(path + ".part", path)
        print(f"  wrote {os.path.basename(path)} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    return path


def _first_step_logits(params, cfg, tokens, opts):
    """Prefill tokens[:, :-1] from position 0, then one decode step of the
    last column: returns (prefill logits, decode logits)."""
    import jax
    import jax.numpy as jnp

    from gguf_tpu.models import forward, init_kv_cache

    b, t = tokens.shape
    fwd = jax.jit(lambda p, x, pos, c: forward(p, cfg, x, pos, c, opts,
                                               span=128))
    cache = init_kv_cache(cfg, b, 128)
    l1, cache = fwd(params, tokens[:, :-1], jnp.zeros(b, jnp.int32), cache)
    l2, _ = fwd(params, tokens[:, -1:], jnp.full((b,), t - 1, jnp.int32),
                cache)
    return np.asarray(l1), np.asarray(l2)


def phase_model(check: Checks, cfg, name: str, max_batch: int = 16,
                new_tokens: int = 32, smi: str = "") -> None:
    """Phase 2: the full-width model end to end, on the card's defaults."""
    import jax
    import jax.numpy as jnp

    from gguf_tpu.engine import LLM, SamplerConfig
    from gguf_tpu.engine.server import make_server
    from gguf_tpu.models import (MMOpts, forward, fuse_llama_params,
                                 init_kv_cache, load_llama)
    from gguf_tpu.quant.layouts import QuantTensor
    from gguf_tpu.utils.benchmark import time_call

    print(f"phase 2: {name} end to end", flush=True)
    path = write_checkpoint(cfg, name)
    cfg, params = load_llama(path)
    rng = np.random.default_rng(1)
    tokens = jnp.asarray(rng.integers(3, cfg.vocab_size, (2, 9)), jnp.int32)

    fused = fuse_llama_params(params)
    got = _first_step_logits(fused, cfg, tokens, MMOpts(precision="fast"))
    del fused
    deq = jax.tree_util.tree_map(
        lambda x: x.dequantize() if isinstance(x, QuantTensor) else x,
        params, is_leaf=lambda x: isinstance(x, QuantTensor))
    with jax.default_matmul_precision("highest"):
        ref = _first_step_logits(deq, cfg, tokens, MMOpts(precision="high"))
    del deq, params
    for step, g, r in zip(("prefill", "decode"), got, ref):
        check(f"{name} logits {step} step", _rel_err(g, r), LOGIT_TOL,
              "fast", "model")
        print(f"    greedy tokens {step}: got {g[:, -1].argmax(-1).tolist()} "
              f"ref {r[:, -1].argmax(-1).tolist()}", flush=True)

    llm = LLM(path, max_batch=max_batch)
    prompts = [rng.integers(3, cfg.vocab_size, 5 + 3 * i).tolist()
               for i in range(max_batch)]
    greedy = SamplerConfig(temperature=0.0)
    t0 = time.perf_counter()
    res = llm.generate(prompts, max_new_tokens=new_tokens, sampler=greedy,
                       stop_at_eos=False)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = llm.generate(prompts, max_new_tokens=new_tokens, sampler=greedy,
                       stop_at_eos=False)
    t_second = time.perf_counter() - t0
    lens = [len(r.token_ids) for r in res]
    ok = lens == [new_tokens] * max_batch and all(
        0 <= t < cfg.vocab_size for r in res for t in r.token_ids)
    check(f"LLM.generate {max_batch} prompts x {new_tokens} tokens",
          0.0 if ok else float("inf"), 0.0, "fast", "engine")
    print(f"    generate: first call {t_first:.2f} s, second call "
          f"{t_second:.2f} s ({sum(lens) / t_second:.1f} generated tokens/s "
          f"incl. prefill) [{smi}]", flush=True)

    step = jax.jit(lambda p, x, pos, c: forward(
        p, cfg, x, pos, c, llm.opts, span=512)[0])
    cache = init_kv_cache(cfg, max_batch, 512)
    x = jnp.zeros((max_batch, 1), jnp.int32)
    pos = jnp.arange(max_batch, dtype=jnp.int32) * 16 + 200
    t0 = time.perf_counter()
    jax.block_until_ready(step(llm.params, x, pos, cache))
    t_compile = time.perf_counter() - t0
    t_step = time_call(step, llm.params, x, pos, cache)
    print(f"    decode step batch {max_batch} span 512: {t_step * 1e3:.3f} ms "
          f"({max_batch / t_step:.1f} tokens/s), first call (compile) "
          f"{t_compile:.1f} s [{smi}]", flush=True)

    httpd = make_server(llm, "127.0.0.1", 0)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}/v1/completions"
    try:
        out: dict = {}

        def call(i, payload):
            out[i] = _post(url, payload)

        reqs = {0: {"prompt": "The quick brown fox", "max_tokens": 12,
                    "temperature": 0.0},
                1: {"prompt": prompts[0], "max_tokens": 12,
                    "temperature": 0.0},
                2: {"prompt": "Streaming, please", "max_tokens": 12,
                    "temperature": 0.0, "stream": True}}
        threads = [threading.Thread(target=call, args=(i, p))
                   for i, p in reqs.items()]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        for i, payload in reqs.items():
            status, ids = out.get(i, (None, []))
            ok = status == 200 and 1 <= len(ids) <= payload["max_tokens"]
            check(f"/v1/completions request {i}"
                  + (" (stream)" if payload.get("stream") else ""),
                  0.0 if ok else float("inf"), 0.0, "fast", "server")
            print(f"    request {i}: status {status}, {len(ids)} tokens",
                  flush=True)
    finally:
        httpd.shutdown()
        server.join(timeout=60)
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use", 0) / 2**30
    print(f"    peak device memory: {peak:.2f} GiB [{smi}]", flush=True)


def _post(url: str, payload: dict):
    """POST a completion; returns (status, generated token ids). Streams
    are read to `data: [DONE]` and their deltas' ids concatenated."""
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        status = r.status
        if not payload.get("stream"):
            body = json.loads(r.read())
            ids = body["choices"][0]["token_ids"]
            assert body["usage"]["completion_tokens"] == len(ids), body
            return status, ids
        ids, done = [], False
        for line in r:
            line = line.decode().strip()
            if line == "data: [DONE]":
                done = True
            elif line.startswith("data: "):
                ids += json.loads(line[6:])["choices"][0]["token_ids"]
        return (status if done else None), ids


def phase_four(check: Checks, cfg, name: str) -> None:
    """--four: LLM(tp=4) and LLM(dp=2, tp=2) against one card."""
    import jax

    from gguf_tpu.engine import LLM

    print(f"phase four: {name} over {len(jax.devices())} cards", flush=True)
    path = write_checkpoint(cfg, name)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(3, cfg.vocab_size, 9 + i).tolist()
               for i in range(4)]   # one prefill bucket: one compile

    def run(**kw):
        llm = LLM(path, max_batch=4, max_seq=512, **kw)
        logits = np.stack([np.asarray(llm._prefill_chunks(p, slot=i))
                           for i, p in enumerate(prompts)])
        del llm
        return logits

    ref = run()
    print(f"    one card greedy next tokens: {ref.argmax(-1).tolist()}",
          flush=True)
    for kw in ({"tp": 4}, {"dp": 2, "tp": 2}):
        got = run(**kw)
        label = ", ".join(f"{k}={v}" for k, v in kw.items())
        check(f"LLM({label}) first-step logits", _rel_err(got, ref),
              LOGIT_TOL, "fast", "mesh")
        print(f"    LLM({label}) greedy next tokens: "
              f"{got.argmax(-1).tolist()}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path and its comparison")
    args = ap.parse_args(argv)
    try:
        from gguf_tpu.models.presets import PRESETS
        from gguf_tpu.utils.benchmark import nvidia_smi_name_power
        from gguf_tpu.utils.paths import enable_compile_cache
    except ImportError as e:
        print(f"chip_smoke: the gguf_tpu package is missing ({e}); run from "
              "the root of a checkout", file=sys.stderr)
        return 2
    enable_compile_cache()
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform "
              f"'{devs[0].platform}'); nothing was measured", file=sys.stderr)
        return 2
    if args.four and len(devs) < 4:
        print(f"chip_smoke: --four needs 4 GPUs, found {len(devs)}",
              file=sys.stderr)
        return 2
    smi = nvidia_smi_name_power()
    print(f"phase 0: {devs[0].device_kind} x{len(devs)}; "
          f"nvidia-smi: {smi}", flush=True)

    t0 = time.perf_counter()
    check = Checks()
    cfg = PRESETS["tinyllama-1.1b"]
    name = "tinyllama-1.1b-q4km.gguf"
    if args.four:
        phase_four(check, cfg, name)
    else:
        phase_kernels(check)
        phase_model(check, cfg, name, smi=smi)
    print(f"total {time.perf_counter() - t0:.1f} s", flush=True)
    if check.failed:
        print(f"chip_smoke: {len(check.failed)} check(s) failed: "
              f"{check.failed}", file=sys.stderr)
        return 1
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
