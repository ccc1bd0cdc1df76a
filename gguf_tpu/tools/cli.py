"""Command-line tools: inspect / requantize / generate / ppl / bench.

    python -m gguf_tpu.tools.cli inspect model.gguf
    python -m gguf_tpu.tools.cli requantize in.gguf out.gguf --fmt q4_k
    python -m gguf_tpu.tools.cli generate model.gguf --prompt "..." -n 64
    python -m gguf_tpu.tools.cli ppl model.gguf tokens.txt --window 512
    python -m gguf_tpu.tools.cli bench model.gguf --batch 16

The reference ships no tooling at all (test scripts only); these are the
operational entry points a serving deployment needs around the library.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def cmd_inspect(args):
    from ..gguf import GGMLType, GGUFReader

    with GGUFReader(args.model) as r:
        meta = {k: (v if not isinstance(v, list) or len(v) <= 8
                    else f"[{len(v)} items]")
                for k, v in r.metadata.items()}
        print(json.dumps(meta, indent=2, default=str))
        total = 0
        for name, ti in r.tensors.items():
            tname = (ti.ggml_type.name if isinstance(ti.ggml_type, GGMLType)
                     else f"?{ti.ggml_type}")
            nb = ti.nbytes or 0
            print(f"{name:44s} {tname:6s} {tuple(ti.shape)} {nb:>12,d}B")
            total += nb
        print(f"-- {len(r.tensors)} tensors, {total/1e6:,.1f} MB")


def cmd_requantize(args):
    """f16/f32/quantized GGUF -> target quantization (dequantize + requantize
    through the bit-exact GGML-compatible codecs; --imatrix switches to the
    activation-weighted quantizers for calibrated tensors)."""
    from ..gguf import GGMLType, GGUFReader
    from ..gguf.writer import quantize_tensor, write_gguf

    imx = None
    if getattr(args, "imatrix", None):
        from ..eval.imatrix import read_imatrix

        imx = read_imatrix(args.imatrix)
    target = GGMLType[args.fmt.upper()]
    granule = 256 if "_k" in args.fmt else 32
    tensors = {}
    weighted = 0
    with GGUFReader(args.model) as r:
        md = dict(r.metadata)
        md_types = dict(r.metadata_types)
        for name, ti in r.tensors.items():
            x = r.dequantize(name)
            # norms / biases / odd-width tensors stay float (llama.cpp recipe)
            if x.ndim < 2 or x.shape[-1] % granule:
                tensors[name] = (GGMLType.F32, x.shape, x.astype(np.float32))
            else:
                qw = None
                if imx is not None:
                    from ..eval.imatrix import imatrix_weights

                    qw = imatrix_weights(imx, name, x.shape[-1])
                    weighted += qw is not None
                tensors[name] = (target, x.shape,
                                 quantize_tensor(x, target, qw=qw))
    write_gguf(args.out, md, tensors, metadata_types=md_types)
    extra = f", {weighted} imatrix-weighted" if imx is not None else ""
    print(f"wrote {args.out} ({args.fmt}{extra})")


def cmd_convert_hf(args):
    from .convert_hf import convert_hf

    md = convert_hf(args.model_dir, args.out, fmt=args.fmt)
    print(f"wrote {args.out} ({md['general.architecture']}, {args.fmt}, "
          f"{md[md['general.architecture'] + '.block_count']} layers)")


def cmd_imatrix(args):
    """Collect an importance matrix over a calibration token stream."""
    from ..eval.imatrix import collect_imatrix, write_imatrix

    if args.tokens.endswith(".txt"):
        from ..engine import tokenizer_from_metadata
        from ..gguf import GGUFReader

        with open(args.tokens) as f:
            text = f.read()
        with GGUFReader(args.model) as r:
            tok = tokenizer_from_metadata(r.metadata)
        if tok is None:
            raise SystemExit("text calibration needs an embedded tokenizer")
        ids = tok.encode(text)
    else:
        with open(args.tokens) as f:
            ids = [int(x) for x in f.read().split()]
    entries = collect_imatrix(args.model, ids, window=args.window)
    write_imatrix(args.out, entries, input_name=args.tokens)
    print(f"wrote {args.out} ({len(entries)} tensors, "
          f"{len(ids)} calibration tokens)")


def cmd_merge_lora(args):
    from ..models.lora import merge_lora

    patched = merge_lora(args.model, args.lora, args.out, scale=args.scale)
    print(f"wrote {args.out} ({len(patched)} tensors patched: "
          f"{', '.join(patched[:6])}{'...' if len(patched) > 6 else ''})")


def cmd_tokenize(args):
    """llama.cpp-style tokenize tool: text -> ids (and pieces)."""
    from ..engine import encode_with_specials, tokenizer_from_metadata
    from ..gguf import GGUFReader

    with GGUFReader(args.model) as r:
        tok = tokenizer_from_metadata(r.metadata)
    if tok is None:
        raise SystemExit("model has no embedded tokenizer")
    ids = encode_with_specials(tok, args.text)
    print(" ".join(str(i) for i in ids))
    if args.decode:
        for i in ids:
            print(f"{i:>8} -> {tok.decode([i])!r}")


def cmd_generate(args):
    from ..engine import LLM
    from ..engine.sampler import SamplerConfig

    llm = LLM(args.model, max_batch=args.batch,
              draft=getattr(args, "draft", None))
    sampler = SamplerConfig(temperature=args.temperature, top_p=args.top_p)
    prompt = ([int(x) for x in args.ids.split()] if args.ids
              else args.prompt)
    grammar = None
    if getattr(args, "json", False):
        from ..engine.grammar import JSON_GBNF

        grammar = JSON_GBNF
    elif getattr(args, "grammar", None):
        with open(args.grammar) as f:
            grammar = f.read()
    prompts = [prompt] * max(args.batch, 1)
    res = llm.generate(prompts, max_new_tokens=args.n, sampler=sampler,
                       speculative=args.speculative,
                       seed=args.seed, grammar=grammar)
    for r in res:
        print(r.text if r.text else r.token_ids)


def cmd_ppl(args):
    from ..eval import perplexity_of_gguf

    if args.tokens.endswith(".txt"):
        with open(args.tokens) as f:
            text = f.read()
        from ..engine.bpe_tokenizer import tokenizer_from_metadata
        from ..gguf import GGUFReader
        with GGUFReader(args.model) as r:
            tok = tokenizer_from_metadata(r.metadata)
        if tok is None:
            raise SystemExit("model has no embedded tokenizer; pass token ids")
        ids = tok.encode(text)
    else:  # whitespace-separated token ids
        with open(args.tokens) as f:
            ids = [int(x) for x in f.read().split()]
    ppl = perplexity_of_gguf(args.model, ids, window=args.window,
                             act_quant=args.act_quant)
    print(json.dumps({"perplexity": round(ppl, 4), "tokens": len(ids),
                      "window": args.window,
                      "numerics": "q8_1-mmq" if args.act_quant else "bf16"}))


def cmd_chat(args):
    """Interactive chat REPL over a pinned-slot session (delta prefill)."""
    from ..engine import LLM, SamplerConfig

    import os

    llm = LLM(args.model, max_batch=2)
    sampler = SamplerConfig(temperature=args.temperature)
    use_template = bool(llm.chat_template)
    sess = llm.start_session()
    messages = []
    # llama.cpp --prompt-cache: resume the saved KV prefix, save on exit
    if args.prompt_cache and os.path.exists(args.prompt_cache):
        n = sess.restore(args.prompt_cache)
        print(f"(restored {n} cached rows from {args.prompt_cache})")
    print("(/exit to quit; conversation stays in the KV cache)")
    while True:
        try:
            line = input("you> ")
        except (EOFError, KeyboardInterrupt):
            break
        if line.strip() in ("/exit", "/quit"):
            break
        if use_template:
            from ..engine.engine import encode_with_specials

            messages.append({"role": "user", "content": line})
            # render only this turn's delta against the running template
            full = llm.apply_chat_template(messages)
            prev = llm.apply_chat_template(messages[:-1],
                                           add_generation_prompt=False) \
                if len(messages) > 1 else ""
            if not full.startswith(prev):   # unusual template: start over
                sess.close()
                sess = llm.start_session()
                prev = ""
            ids = encode_with_specials(llm.tokenizer, full[len(prev):])
        else:
            ids = line
        res = sess.send(ids, max_new_tokens=args.n, sampler=sampler)
        print(res.text)
        if use_template:
            messages.append({"role": "assistant", "content": res.text})
    if args.prompt_cache and sess.cached:
        print(f"(saving {sess.save(args.prompt_cache)} rows to "
              f"{args.prompt_cache})")
    sess.close()


def cmd_serve(args):
    from ..engine.server import serve

    serve(args.model, host=args.host, port=args.port,
          max_batch=args.max_batch, tp=args.tp, dp=args.dp, sp=args.sp,
          slot_save_path=args.slot_save_path, mmproj=args.mmproj,
          lora=args.lora, lora_scale=args.lora_scale)


def cmd_bench(args):
    """Decode-step time of a GGUF model at one batch: host-clock median
    around block_until_ready after a warm-up (utils/benchmark.py), with
    the device named beside it."""
    import jax
    import jax.numpy as jnp

    from ..models import (MMOpts, forward, fuse_llama_params, init_kv_cache,
                          load_llama)
    from ..utils.benchmark import device_info, time_call
    from ..utils.paths import enable_compile_cache

    enable_compile_cache()
    cfg, params = load_llama(args.model)
    params = fuse_llama_params(params)
    batch = args.batch
    cache = init_kv_cache(cfg, batch=batch, max_seq=args.seq)
    tokens = jnp.zeros((batch, 1), jnp.int32)
    pos = jnp.arange(batch, dtype=jnp.int32)
    span = 128 if args.seq >= 128 else None
    step = jax.jit(lambda p, t, q, c: forward(
        p, cfg, t, q, c, MMOpts(precision="fast"), span=span)[0])
    t = time_call(step, params, tokens, pos, cache)
    wbytes = sum(int(np.prod(a.shape)) * a.dtype.itemsize
                 for a in jax.tree_util.tree_leaves(params))
    print(json.dumps({
        "model": args.model, "batch": batch,
        "step_us": t * 1e6,
        "tokens_per_s": batch / t,
        "weight_stream_gbps": wbytes / t / 1e9,
        "device": device_info(),
    }))


def main(argv=None):
    p = argparse.ArgumentParser(prog="gguf_tpu", description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("inspect", help="print GGUF metadata and tensor table")
    s.add_argument("model")
    s.set_defaults(fn=cmd_inspect)

    s = sub.add_parser("requantize", help="convert a GGUF to another format")
    s.add_argument("model")
    s.add_argument("out")
    s.add_argument("--fmt", default="q4_k",
                   choices=["q2_k", "q3_k", "q4_k", "q5_k", "q6_k", "q8_0",
                            "q4_0", "q4_1", "q5_0", "q5_1",
                            "iq4_nl", "iq4_xs"])
    s.add_argument("--imatrix", default=None, metavar="FILE",
                   help="importance matrix (cli imatrix or llama.cpp "
                        "format): activation-weighted quantization")
    s.set_defaults(fn=cmd_requantize)

    s = sub.add_parser("convert-hf",
                       help="HuggingFace checkpoint dir -> GGUF")
    s.add_argument("model_dir")
    s.add_argument("out")
    s.add_argument("--fmt", default="q4_k",
                   choices=["f16", "q2_k", "q3_k", "q4_k", "q5_k", "q6_k",
                            "q8_0", "q4_0", "q4_1", "q5_0", "q5_1",
                            "iq4_nl", "iq4_xs"])
    s.set_defaults(fn=cmd_convert_hf)

    s = sub.add_parser("imatrix",
                       help="collect an importance matrix for --imatrix")
    s.add_argument("model")
    s.add_argument("tokens", help=".txt (tokenized here) or "
                                  "whitespace-separated token ids")
    s.add_argument("-o", "--out", default="imatrix.dat")
    s.add_argument("--window", type=int, default=512)
    s.set_defaults(fn=cmd_imatrix)

    s = sub.add_parser("merge-lora",
                       help="bake a GGUF LoRA adapter into a checkpoint")
    s.add_argument("model")
    s.add_argument("lora", help="adapter GGUF (llama.cpp convert_lora "
                                "format: .lora_a/.lora_b pairs)")
    s.add_argument("out")
    s.add_argument("--scale", type=float, default=1.0,
                   help="extra multiplier on top of alpha/rank")
    s.set_defaults(fn=cmd_merge_lora)

    s = sub.add_parser("tokenize",
                       help="encode text with the GGUF's tokenizer")
    s.add_argument("model")
    s.add_argument("text")
    s.add_argument("--decode", action="store_true",
                   help="also print each id's decoded piece")
    s.set_defaults(fn=cmd_tokenize)

    s = sub.add_parser("generate", help="generate completions")
    s.add_argument("model")
    s.add_argument("--prompt", help="text prompt (needs an embedded tokenizer)")
    s.add_argument("--ids", help="space-separated prompt token ids")
    s.add_argument("-n", type=int, default=64)
    s.add_argument("--batch", type=int, default=1)
    s.add_argument("--temperature", type=float, default=0.8)
    s.add_argument("--top-p", type=float, default=0.95)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--grammar", default=None, metavar="GBNF_FILE",
                   help="constrain output to a GBNF grammar (llama.cpp "
                        "dialect)")
    s.add_argument("--json", action="store_true",
                   help="constrain output to valid JSON")
    s.add_argument("--draft", default=None, metavar="GGUF",
                   help="smaller same-vocab GGUF for draft-model "
                        "speculative decoding (with --speculative K)")
    s.add_argument("--speculative", type=int, default=0, metavar="K",
                   help="prompt-lookup speculative decoding draft length "
                        "(greedy only; exact same output, faster on "
                        "repetitive text)")
    s.set_defaults(fn=cmd_generate)

    s = sub.add_parser("ppl", help="perplexity over a token stream")
    s.add_argument("model")
    s.add_argument("tokens", help=".txt (tokenized with the model's "
                   "tokenizer) or whitespace-separated token ids")
    s.add_argument("--window", type=int, default=512)
    s.add_argument("--act-quant", action="store_true",
                   help="score with Q8_1-quantized activations (llama.cpp "
                        "MMQ numerics — what BASELINE's ppl target is "
                        "defined against) instead of bf16 activations")
    s.set_defaults(fn=cmd_ppl)

    s = sub.add_parser("bench", help="decode throughput of a checkpoint")
    s.add_argument("model")
    s.add_argument("--batch", type=int, default=16)
    s.add_argument("--seq", type=int, default=256)
    s.set_defaults(fn=cmd_bench)

    s = sub.add_parser("chat", help="interactive chat REPL (KV-cached turns)")
    s.add_argument("model")
    s.add_argument("-n", type=int, default=256)
    s.add_argument("--temperature", type=float, default=0.7)
    s.add_argument("--prompt-cache", default=None,
                   help="session file: restore at start, save on exit "
                        "(llama.cpp --prompt-cache)")
    s.set_defaults(fn=cmd_chat)

    s = sub.add_parser("serve", help="OpenAI-style HTTP completions server")
    s.add_argument("model")
    s.add_argument("--host", default="0.0.0.0")
    s.add_argument("--port", type=int, default=8000)
    s.add_argument("--max-batch", type=int, default=8)
    s.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel ways (shards over the first N devices)")
    s.add_argument("--dp", type=int, default=1,
                   help="data-parallel replicas (shards the slot pool's batch)")
    s.add_argument("--sp", type=int, default=1,
                   help="context-parallel ways (shards each KV cache's sequence dim)")
    s.add_argument("--slot-save-path", default=None,
                   help="directory for /slots/{id}?action=save|restore files")
    s.add_argument("--mmproj", default=None,
                   help="mmproj GGUF (CLIP vision tower) for image chat")
    s.add_argument("--lora", default=None,
                   help="LoRA adapter GGUF baked in at load (llama.cpp --lora)")
    s.add_argument("--lora-scale", type=float, default=1.0)
    s.set_defaults(fn=cmd_serve)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
