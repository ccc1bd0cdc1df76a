"""Serving engine: GGUF model + continuous batching + INT8 KV cache.

The scheduler keeps a fixed pool of `max_batch` sequence slots over one
shared KV cache. New requests are admitted into free slots as soon as they
open (llama.cpp-style continuous batching — sequences at different depths
decode together in a single forward step, enabled by the per-slot positions
in models/llama.py). Prefill runs per request at power-of-two padded lengths
(bounded jit recompiles); right-padding is safe because the causal mask is
driven by real positions and later decode steps overwrite the padded cache
entries before attending to them.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from ..gguf import GGUFReader
from ..models import (MMOpts, forward, fuse_llama_params,
                      init_kv_cache, load_llama)
from .sampler import SamplerConfig, sample, sample_mirostat
from .bpe_tokenizer import tokenizer_from_metadata
from .tokenizer import fim_tokens_from_metadata


def _penalty_window(ids, n: int):
    """llama.cpp --repeat-last-n semantics: n > 0 keeps the last n
    context tokens, 0 DISABLES the penalties, negative = whole context."""
    if n == 0:
        return []
    return ids[-n:] if n > 0 else ids


def _decode_data_image(url: str):
    """data:image/...;base64,... -> HxWx3 uint8 array (PIL decode)."""
    import base64
    import io

    if not isinstance(url, str) or not url.startswith("data:"):
        raise ValueError("image_url must be a data: URI (base64 image); "
                         "remote URLs are not fetched")
    try:
        b64 = url.split(",", 1)[1]
        from PIL import Image

        img = Image.open(io.BytesIO(base64.b64decode(b64)))
        return np.asarray(img.convert("RGB"))
    except Exception as e:
        raise ValueError(f"could not decode image data URI: {e}") from e


def encode_with_specials(tokenizer, text: str) -> list[int]:
    """Encode text that may contain special/control token strings (chat
    template output): exact occurrences map to their single token ids,
    plain segments encode normally with no implicit BOS, and only the very
    first plain piece gets the SPM space prefix (llama.cpp parse_special
    semantics)."""
    import re

    specials = getattr(tokenizer, "specials", None)

    def enc(seg, first):
        try:
            return tokenizer.encode(seg, add_bos=False,
                                    add_space_prefix=None if first else False)
        except TypeError:  # BPE has no space-prefix concept
            return tokenizer.encode(seg, add_bos=False)

    if not specials:
        return enc(text, True)
    pat = re.compile("|".join(
        re.escape(t) for t in sorted(specials, key=len, reverse=True)))
    out: list[int] = []
    last = 0
    first = True
    for m in pat.finditer(text):
        if m.start() > last:
            out.extend(enc(text[last:m.start()], first))
            first = False
        out.append(specials[m.group(0)])
        first = False
        last = m.end()
    if last < len(text):
        out.extend(enc(text[last:], first))
    return out


@dataclass
class GenerationResult:
    prompt_ids: list
    token_ids: list = field(default_factory=list)
    text: str = ""
    finished: bool = False
    # why the sequence ended: "eos" | "stop" (string/id) | "length" | ""
    stop_reason: str = ""
    # batch-level serving stats, shared by every result of one generate()
    # call: wall_s, new_tokens, tokens_per_s — END-TO-END throughput (wall
    # time includes prefill and host scheduling, not just decode)
    stats: dict = field(default_factory=dict)
    # when generate(logprobs=k): one {"logprob": f, "top": [(id, lp), ...]}
    # entry per generated token
    logprobs: list | None = None


class ChatSession:
    """Multi-turn generation over a pinned cache slot: each send() prefills
    only its NEW tokens — the conversation so far (including the model's
    own replies, whose K/V were inserted while decoding) already lives in
    the slot's KV cache, so follow-up turns skip the history re-prefill
    entirely. Obtain via LLM.start_session(); not thread-safe with respect
    to concurrent generate() calls (the engine is single-threaded by
    design).

    State: `cached` tokens have K/V in the slot; `_pending` is the last
    generated token, which is part of the conversation but whose K/V is
    not yet inserted (it rides along with the next turn's prefill)."""

    def __init__(self, llm: "LLM", slot: int, n_keep: int = 0):
        self.llm = llm
        self.slot = slot
        self.cached = 0
        self.n_keep = n_keep            # ctx-shift: rows pinned at the front
        self._pending: int | None = None
        self._history: list[int] = []   # full context, for the penalties
        self.closed = False

    def _maybe_shift(self, incoming: int) -> None:
        """llama.cpp --ctx-shift: when the next turn would overflow the
        slot, drop the oldest half of the non-pinned context (KV rows
        slide down with rope re-rotation; history trims to match)."""
        llm = self.llm
        if not llm.ctx_shift or self.cached + incoming < llm.max_seq - 1:
            return
        keep = min(self.n_keep, self.cached)
        need = self.cached + incoming - (llm.max_seq - 2)
        drop = min(max((self.cached - keep) // 2, need),
                   self.cached - keep)
        if drop <= 0:
            return
        llm.shift_slot(self.slot, keep, drop)
        self.cached -= drop
        self._history = self._history[:keep] + self._history[keep + drop:]

    def send(self, prompt, max_new_tokens: int = 64,
             sampler: SamplerConfig = SamplerConfig(), seed: int = 0,
             stop_at_eos: bool = True,
             decode_chunk: int = 8,
             speculative: int = 0) -> GenerationResult:
        assert not self.closed, "session is closed"
        assert speculative == 0 or speculative + 1 <= 16, (
            f"speculative draft length {speculative} > 15 would route the "
            "verify forward off the windowed cache insert")
        llm = self.llm
        new_ids = llm._encode(prompt)
        ids = ([self._pending] if self._pending is not None else []) + new_ids
        self._pending = None
        n = len(ids)
        self._maybe_shift(n)
        assert self.cached + n < llm.max_seq, (
            f"conversation ({self.cached + n}) exceeds max_seq {llm.max_seq}"
            + ("" if llm.ctx_shift else
               " (LLM(ctx_shift=True) drops the oldest context instead)"))
        key = jax.random.PRNGKey(seed ^ (self.cached << 8))
        logits = llm._prefill_chunks(ids, self.slot, start=self.cached)
        self.cached += n
        # _pending (ids[0]) was already appended when it was generated
        self._history.extend(new_ids)

        def _counts_row():
            c = np.zeros((1, llm.cfg.vocab_size), np.int32)
            hist = _penalty_window(self._history, sampler.penalty_last_n)
            np.add.at(c[0], np.asarray(hist, np.int64), 1)
            return jnp.asarray(c)

        def _hist_row():
            h = np.zeros((1, llm.max_seq), np.int32)
            h[0, :len(self._history)] = self._history
            return (jnp.asarray(h),
                    jnp.asarray([len(self._history)], jnp.int32))

        key, sub = jax.random.split(key)
        dry1 = _hist_row() if sampler.uses_dry else (None, None)
        # mirostat v2 state: per-slot adaptive surprise threshold
        mu_state = np.full(llm.max_batch, 2.0 * sampler.mirostat_tau,
                           np.float32)
        if sampler.mirostat:
            f_tok, f_mu = sample_mirostat(
                logits[None, :], sub, sampler,
                jnp.asarray(mu_state[self.slot:self.slot + 1]),
                _counts_row() if sampler.uses_penalties else None, *dry1)
            tok = int(f_tok[0])
            mu_state[self.slot] = float(f_mu[0])
        else:
            tok = int(sample(logits[None, :], sub, sampler,
                             _counts_row() if sampler.uses_penalties
                             else None, *dry1)[0])
        self._history.append(tok)
        res = GenerationResult(prompt_ids=new_ids)
        res.token_ids.append(tok)
        eos = llm.tokenizer.eos_id if llm.tokenizer else -1
        budget = max_new_tokens - 1

        def finished(t):
            if llm.ctx_shift:   # shifting handles the boundary mid-decode
                return stop_at_eos and t == eos
            return (stop_at_eos and t == eos) or \
                self.cached + 1 >= llm.max_seq - 1

        while budget > 0 and not finished(tok):
            # llama.cpp shifts DURING generation too: free room before
            # the next chunk instead of truncating the turn
            self._maybe_shift(min(budget, decode_chunk) + 2)
            if llm.max_seq - self.cached - 2 < 1:
                break   # n_keep pins everything: nothing left to drop
            steps = 1
            room = min(budget, llm.max_seq - self.cached - 2)
            while steps * 2 <= min(decode_chunk, max(room, 1)):
                steps *= 2
            # each step inserts the pending token's K/V at `cached`
            pos_arr = np.full(llm.max_batch, llm.max_seq, np.int64)
            pos_arr[self.slot] = self.cached
            last = np.zeros(llm.max_batch, np.int64)
            last[self.slot] = tok
            use_spec = (speculative > 0 and sampler.temperature <= 0.0
                        and not sampler.uses_penalties
                        and not sampler.logit_bias and not sampler.mirostat
                        and not sampler.uses_dry
                        and room >= speculative + 1)
            if use_spec:
                k = speculative
                iters = max(1, min(decode_chunk, room // (k + 1)))
                span = llm._span_bucket(self.cached + iters * (k + 1))
                tokbuf = np.zeros((llm.max_batch, llm.max_seq), np.int32)
                ctx = self._history
                tokbuf[self.slot, :len(ctx)] = ctx
                (em, accs), llm.cache = llm._spec_decode(
                    llm.params, llm.cache, jnp.asarray(tokbuf),
                    jnp.asarray(pos_arr, jnp.int32),
                    jnp.asarray(last, jnp.int32), iters, k, span)
                em = np.asarray(em)[self.slot]
                accs = np.asarray(accs)[self.slot]
                stop_now = False
                for it in range(iters):
                    for tok in em[it, :int(accs[it]) + 1]:
                        self.cached += 1
                        tok = int(tok)
                        self._history.append(tok)
                        res.token_ids.append(tok)
                        budget -= 1
                        if finished(tok) or budget <= 0:
                            stop_now = True
                            break
                    if stop_now:
                        break
                continue
            key, sub = jax.random.split(key)
            span = llm._span_bucket(self.cached + steps)
            if sampler.uses_penalties:
                counts = np.zeros((llm.max_batch, llm.cfg.vocab_size), np.int32)
                hist = _penalty_window(self._history, sampler.penalty_last_n)
                np.add.at(counts[self.slot], np.asarray(hist, np.int64), 1)
                counts = jnp.asarray(counts)
            else:
                counts = jnp.zeros((llm.max_batch, 1), jnp.int32)
            if sampler.uses_dry:
                hist_np = np.zeros((llm.max_batch, llm.max_seq), np.int32)
                hist_np[self.slot, :len(self._history)] = self._history
                hlen_np = np.zeros(llm.max_batch, np.int32)
                hlen_np[self.slot] = len(self._history)
                hist, hlen = jnp.asarray(hist_np), jnp.asarray(hlen_np)
            else:
                hist = jnp.zeros((llm.max_batch, 1), jnp.int32)
                hlen = jnp.zeros(llm.max_batch, jnp.int32)
            (ids_o, _, _, _), llm.cache, mu_dev = llm._decode(
                llm.params, llm.cache, jnp.asarray(last, jnp.int32),
                jnp.asarray(pos_arr, jnp.int32), counts, hist, hlen,
                jnp.asarray(mu_state, jnp.float32), sub, sampler,
                steps, span, 0)
            if sampler.mirostat:
                mu_state = np.asarray(mu_dev)
            ids_o = np.asarray(ids_o)
            for j in range(steps):
                self.cached += 1       # previous pending token is now cached
                tok = int(ids_o[self.slot, j])
                self._history.append(tok)
                res.token_ids.append(tok)
                budget -= 1
                if finished(tok) or budget <= 0:
                    break
        if stop_at_eos and res.token_ids and res.token_ids[-1] == eos:
            res.token_ids.pop()        # EOS leaves the conversation entirely
            res.stop_reason = "eos"
            if self._history and self._history[-1] == eos:
                self._history.pop()
        else:
            self._pending = res.token_ids[-1] if res.token_ids else None
            res.stop_reason = "length"
        res.finished = True
        if llm.tokenizer is not None:
            res.text = llm.tokenizer.decode(res.token_ids)
        return res

    def save(self, path: str) -> int:
        """Persist this conversation's KV prefix + history (llama.cpp
        --prompt-cache). The still-pending last token rides along as the
        history entry beyond the cached rows."""
        return self.llm.save_state(path, slot=self.slot,
                                   tokens=self._history, rows=self.cached)

    def restore(self, path: str) -> int:
        """Resume a save()d conversation in this session's slot: the next
        send() prefills only the new turn. Returns the restored row count."""
        tokens, rows = self.llm.load_state(path, slot=self.slot)
        self._history = list(tokens)
        self.cached = rows
        # a token generated but not yet cache-inserted at save time
        self._pending = tokens[-1] if len(tokens) == rows + 1 else None
        return rows

    def close(self) -> None:
        self.llm._reserved.discard(self.slot)
        self.closed = True


class LLM:
    def __init__(
        self,
        path: str,
        *,
        max_batch: int = 8,
        max_seq: int | None = None,
        opts: MMOpts = MMOpts(),
        tp: int = 1,
        dp: int = 1,
        sp: int = 1,
        ep: int = 1,
        prefill_chunk: int = 512,
        draft: str | None = None,
        mmproj: str | None = None,
        prefix_cache: bool = True,
        ctx_shift: bool = False,
        lora: str | list | None = None,
        lora_scale: float = 1.0,
    ):
        """tp > 1 serves the model tensor-sharded (Megatron column/row
        sharding, psum across the cards — parallel/tp.py); dp > 1 additionally
        shards the slot pool's batch over data-parallel replicas (decode
        throughput scales with dp; each single-request prefill runs
        dp-replicated); sp > 1 additionally shards every slot's KV cache
        along the sequence dim (context parallelism — attention combines
        per-shard flash partials, models/llama._cp_attention), letting a
        context that exceeds one card's memory serve across the mesh; ep > 1
        shards an MoE model's expert stacks (mixtral-family — each device
        evaluates its local experts, models/llama.moe_mlp). Uses the first
        tp*dp*sp*ep devices; the continuous-batching scheduler below is
        unchanged.

        `draft`: path to a smaller same-vocabulary GGUF used for
        draft-MODEL speculative decoding — generate(speculative=k) then
        drafts k tokens with the draft model's own greedy decode loop and
        verifies them with one t=k+1 target forward (greedy-exact, like
        the prompt-lookup path but effective on non-repetitive text).
        Single-chip serving only for now.

        `prefix_cache`: reuse each slot's resident KV rows across
        generate() calls — a new prompt sharing a prefix with whatever
        that slot last served prefills only the suffix (vLLM-style
        automatic prefix caching, exact: the reused rows are the ones the
        identical recomputation would produce). `llm.prefix_cache_hits`
        counts reused tokens."""
        from ..utils.paths import enable_compile_cache

        enable_compile_cache()
        if lora:
            # llama.cpp --lora: bake the adapter(s) in at load so the hot
            # path stays pure MMQ (llama.cpp's runtime keeps A/B resident;
            # at fixed scale the merged math is identical). Chained
            # adapters merge in order through temp files.
            import os as _os
            import tempfile as _tempfile

            from ..models.lora import merge_lora

            tmps = []
            self._lora_tmp_paths = tmps   # removed after weights load
            try:
                for apath in ([lora] if isinstance(lora, str)
                              else list(lora)):
                    fd, tmp = _tempfile.mkstemp(suffix=".gguf",
                                                prefix="gguf_tpu_lora_")
                    _os.close(fd)
                    tmps.append(tmp)
                    merge_lora(path, apath, tmp, scale=lora_scale)
                    path = tmp
            except BaseException:
                self._drop_lora_tmps()
                raise

        try:
            _reader = GGUFReader(path)
            _arch = _reader.metadata.get("general.architecture", "llama")
        except BaseException:
            self._drop_lora_tmps()
            raise
        if _arch == "t5":
            # encoder-decoder serving: a dedicated lockstep decode loop
            # (the continuous-batching machinery is decoder-LM specific)
            from ..models.t5 import load_t5

            assert tp == dp == sp == ep == 1 and draft is None \
                and mmproj is None, "t5 serving is single-chip"
            with _reader as r:
                self.cfg, self.params = load_t5(r)
                md = r.metadata
            self._drop_lora_tmps()
            self.t5 = True
            self.tokenizer = tokenizer_from_metadata(md)
            self.chat_template = md.get("tokenizer.chat_template")
            self.fim = {}
            self.clip_cfg = self.clip_params = None
            self.max_batch = max_batch
            self.max_seq = max_seq or self.cfg.max_seq_len
            self.opts = opts
            self.mesh = None
            self.ctx_shift = False
            self.prefix_cache = False
            self.prefix_cache_hits = 0
            self._reserved = set()
            self._slot_history = {}
            self.prefill_chunk = max(8, prefill_chunk)
            self.draft = None
            self._draft_spec_decode = None
            return
        _reader.close()
        self.t5 = False
        try:
            self.cfg, self.params = load_llama(path)
        except BaseException:
            self._drop_lora_tmps()
            raise
        if self.cfg.ssm_inner:
            assert tp == dp == sp == ep == 1, (
                "mamba (recurrent-state) serving is single-chip for now")
        if not self.cfg.causal:
            # bert-family encoder: embedding serving only (embed() /
            # /v1/embeddings); no cache, no generation machinery
            assert tp == dp == sp == ep == 1 and draft is None \
                and mmproj is None, "encoder models are single-chip"
            with GGUFReader(path) as r:
                md = r.metadata
            self._drop_lora_tmps()
            self.tokenizer = tokenizer_from_metadata(md)
            self.chat_template = None
            self.fim = {}
            self.clip_cfg = self.clip_params = None
            self.max_batch = max_batch
            self.max_seq = max_seq or self.cfg.max_seq_len
            self.opts = opts
            self.mesh = None
            self.prefix_cache = False
            self.prefix_cache_hits = 0
            self._reserved = set()
            self._slot_history = {}
            self.prefill_chunk = max(8, prefill_chunk)
            self.draft = None
            self._draft_spec_decode = None
            return
        sharded = tp > 1 or dp > 1 or sp > 1 or ep > 1
        # single-chip fuses here; the sharded path fuses inside shard_llama
        # (interleaved per tp shard)
        self.params = self.params if sharded else fuse_llama_params(self.params)
        with GGUFReader(path) as r:
            md = r.metadata
        self._drop_lora_tmps()
        self.tokenizer = tokenizer_from_metadata(md)
        self.chat_template = md.get("tokenizer.chat_template")
        # fill-in-middle control tokens (infill()/POST /infill); empty
        # dict when the vocabulary has none
        self.fim = fim_tokens_from_metadata(md)
        # multimodal: mmproj GGUF (CLIP vision tower + projector) enables
        # image elements in prompts (llama.cpp libmtmd lineage)
        self.clip_cfg = self.clip_params = None
        if mmproj is not None:
            from ..models.clip import load_clip

            assert tp == 1 and dp == 1 and sp == 1 and ep == 1, \
                "multimodal serving is single-chip for now"
            assert not self.cfg.ssm_inner, "mmproj needs an attention LM"
            self.clip_cfg, self.clip_params = load_clip(mmproj)
            assert self.clip_cfg.proj_dim in (0, self.cfg.dim), (
                f"mmproj projects to {self.clip_cfg.proj_dim}, LM dim "
                f"is {self.cfg.dim}")
        self.max_batch = max_batch
        self.max_seq = max_seq or self.cfg.max_seq_len
        self._reserved: set[int] = set()   # slots pinned by ChatSessions
        # prompts longer than this prefill in fixed chunks (bounded
        # activation memory; attention still sees the whole prefix via the
        # KV cache + span)
        self.prefill_chunk = max(8, prefill_chunk)
        self.opts = opts
        # llama.cpp --ctx-shift: ChatSessions that would overflow drop
        # the oldest half of their context and keep going (see
        # shift_kv_cache; needs absolute-rope KV rows)
        self.ctx_shift = ctx_shift
        if ctx_shift:
            assert not (self.cfg.ssm_inner or self.cfg.kv_lora_rank
                        or self.cfg.sliding_window or self.cfg.learned_pos
                        or sp > 1), (
                "ctx_shift supports plain rope attention KV caches only "
                "(learned-position caches cannot be re-based by rotation)")
        if self.cfg.ssm_inner:
            # recurrent state is not row-addressable: prefix reuse, slot
            # save/restore, and speculative rollback all assume KV rows
            prefix_cache = False
        self.prefix_cache = prefix_cache
        self.prefix_cache_hits = 0
        # slot -> (token history whose KV is resident, written row count);
        # recorded when a slot is released, consumed at the next admit
        self._slot_history: dict[int, tuple[list, int]] = {}

        if sharded:
            from ..parallel import (
                init_sharded_cache, make_mesh, shard_llama, tp_forward_fn,
            )

            assert max_batch % dp == 0, (max_batch, dp)
            self.mesh = make_mesh(tp=tp, dp=dp, sp=sp, ep=ep)
            self.params, self.cfg = shard_llama(self.params, self.cfg, self.mesh)
            self.cache = init_sharded_cache(
                self.cfg, self.mesh, max_batch, self.max_seq)
            fwd = tp_forward_fn(self.cfg, self.mesh, self.opts)
        else:
            self.mesh = None
            self.cache = init_kv_cache(self.cfg, max_batch, self.max_seq)

            def fwd(params, tokens, pos, cache, span=None, batch_axis=None,
                    embeds=None, t_real=None, _cfg=self.cfg, _o=self.opts):
                return forward(params, _cfg, tokens, pos, cache, _o,
                               span=span, embeds=embeds, t_real=t_real)

        def _make_prefill(fwd_fn, pass_t_real: bool = False):
            @functools.partial(jax.jit, donate_argnums=(1,), static_argnums=(6,))
            def _prefill(params, cache, tokens, slot, start, last_idx, span):
                """Prefill one prompt chunk into cache slot `slot` at positions
                start..start+t-1; returns the logits of the chunk's token
                `last_idx` (only meaningful on the final chunk). `span` is the
                scheduler's static bound on start + t. `last_idx + 1` is also
                the chunk's REAL length — recurrent (mamba) layers must not
                run the bucket padding through their state."""
                extra = {"t_real": last_idx + 1} if pass_t_real else {}
                cache_1 = jax.tree_util.tree_map(
                    lambda c: jax.lax.dynamic_slice_in_dim(c, slot, 1, axis=0), cache)
                logits, cache_1 = fwd_fn(params, tokens,
                                         jnp.reshape(start, (1,)).astype(jnp.int32),
                                         cache_1, span=span, batch_axis=None,
                                         **extra)
                cache = jax.tree_util.tree_map(
                    lambda c, c1: jax.lax.dynamic_update_slice_in_dim(c, c1, slot, axis=0),
                    cache, cache_1)
                last = jax.lax.dynamic_slice_in_dim(logits, last_idx, 1, axis=1)
                return last[0, 0], cache

            return _prefill

        # mamba's recurrence must see the chunk's real length; the tp
        # forward fn takes no t_real kwarg (sharded mamba is guarded off)
        _prefill = _make_prefill(
            fwd, pass_t_real=bool(self.cfg.ssm_inner) and self.mesh is None)

        @functools.partial(jax.jit, donate_argnums=(1,), static_argnums=(6,))
        def _prefill_embeds(params, cache, emb, slot, start, last_idx, span):
            """_prefill over pre-built input embeddings (the multimodal
            path: text-token embeddings spliced with projected image
            embeddings). Single-chip only."""
            cache_1 = jax.tree_util.tree_map(
                lambda c: jax.lax.dynamic_slice_in_dim(c, slot, 1, axis=0),
                cache)
            tokens = jnp.zeros(emb.shape[:2], jnp.int32)
            logits, cache_1 = fwd(params, tokens,
                                  jnp.reshape(start, (1,)).astype(jnp.int32),
                                  cache_1, span=span, embeds=emb)
            cache = jax.tree_util.tree_map(
                lambda c, c1: jax.lax.dynamic_update_slice_in_dim(
                    c, c1, slot, axis=0),
                cache, cache_1)
            last = jax.lax.dynamic_slice_in_dim(logits, last_idx, 1, axis=1)
            return last[0, 0], cache

        self._prefill_embeds_fn = _prefill_embeds if self.mesh is None \
            else None

        @functools.partial(jax.jit, donate_argnums=(1, 4),
                           static_argnums=(9, 10, 11, 12))
        def _decode(params, cache, tokens, pos, counts, hist, hist_len, mu,
                    key, sampler_cfg, steps, span, logprobs):
            """`steps` decode iterations in one jit (lax.scan): one
            device->host sync per chunk instead of per token — the host
            round-trip otherwise dominates small-model decode. Returns the
            (B, steps) token block; the scheduler trims past EOS/budget
            (cache rows written past a finished slot's end are harmless:
            re-admission prefills from position 0 and the causal mask never
            reaches them). `span` (static, scheduler-computed bucket) bounds
            how deep attention reads into the cache this chunk. `logprobs`
            (static int) additionally returns each chosen token's logprob
            and the top-k alternatives per step (None-filled when 0)."""
            def step(carry, _):
                cache, toks, pos, counts, hist, hist_len, mu, key = carry
                logits, cache = fwd(params, toks[:, None], pos, cache,
                                    span=span)
                key, sub = jax.random.split(key)
                dry_args = ((hist, hist_len) if sampler_cfg.uses_dry
                            else (None, None))
                if sampler_cfg.mirostat:
                    nxt, mu = sample_mirostat(
                        logits[:, 0], sub, sampler_cfg, mu,
                        counts if sampler_cfg.uses_penalties else None,
                        *dry_args)
                else:
                    nxt = sample(logits[:, 0], sub, sampler_cfg,
                                 counts if sampler_cfg.uses_penalties
                                 else None, *dry_args)
                if sampler_cfg.uses_penalties:
                    counts = counts + jax.nn.one_hot(
                        nxt, counts.shape[1], dtype=counts.dtype)
                if sampler_cfg.uses_dry:   # append to the rolling history
                    rows = jnp.arange(hist.shape[0])
                    hist = hist.at[rows, hist_len].set(nxt, mode="drop")
                    hist_len = hist_len + 1
                if logprobs:
                    lp = jax.nn.log_softmax(logits[:, 0].astype(jnp.float32))
                    chosen = jnp.take_along_axis(lp, nxt[:, None], 1)[:, 0]
                    top_lp, top_id = jax.lax.top_k(lp, logprobs)
                    extras = (chosen, top_id.astype(jnp.int32), top_lp)
                else:
                    extras = (jnp.zeros(nxt.shape, jnp.float32),
                              jnp.zeros((*nxt.shape, 1), jnp.int32),
                              jnp.zeros((*nxt.shape, 1), jnp.float32))
                return ((cache, nxt, pos + 1, counts, hist, hist_len, mu,
                         key), (nxt, *extras))

            ((cache, _, _, _, _, _, mu, _),
             (ids, lps, tids, tlps)) = jax.lax.scan(
                step, (cache, tokens, pos, counts, hist, hist_len, mu, key),
                None, length=steps)
            # scan stacks on axis 0 (steps); put batch first
            return (ids.T, lps.T, tids.transpose(1, 0, 2),
                    tlps.transpose(1, 0, 2)), cache, mu

        @functools.partial(jax.jit, donate_argnums=(1,),
                           static_argnums=(5, 6, 7))
        def _spec_decode(params, cache, tokbuf, pos, last, iters, k, span):
            """Greedy speculative decoding via device-side prompt-lookup
            drafting (the ROADMAP's 'device-side drafting design': zero
            host round-trips — draft, verify and accept all live inside one
            jitted scan). Per iteration each sequence:

              1. drafts k tokens by finding the most recent earlier
                 occurrence of its trailing bigram in `tokbuf` (B, S) and
                 copying what followed it (any draft is CORRECT — bad
                 drafts just get rejected),
              2. verifies with ONE t=k+1 forward (the chunked-prefill
                 shape class), taking the greedy argmax at every position,
              3. accepts the matching draft prefix + the bonus token, so a
                 step emits 1..k+1 tokens — output is exactly the plain
                 greedy stream, only faster when text repeats.

            Stale cache rows past an accepted prefix are always rewritten
            by a later insert before any query can attend them (inserts
            cover pos'..pos'+k ⊇ the previous overshoot because pos
            advances by at most k+1). Returns per-iteration greedy tokens
            (B, iters, k+1) and accept counts (B, iters)."""
            b, s = tokbuf.shape
            idxs = jnp.arange(s)

            def step(carry, _):
                cache, tokbuf, pos, last = carry
                # trailing bigram (g0, last); g0 = token before `last`
                g0 = jnp.take_along_axis(
                    tokbuf, jnp.maximum(pos - 1, 0)[:, None], 1)[:, 0]
                t1 = jnp.concatenate(
                    [tokbuf[:, 1:], jnp.full((b, 1), -1, tokbuf.dtype)], 1)
                valid = idxs[None, :] + 1 < pos[:, None]
                m = ((tokbuf == g0[:, None]) & (t1 == last[:, None]) & valid)
                j = jnp.where(m.any(1), s - 1 - jnp.argmax(m[:, ::-1], 1), 0)
                offs = jnp.clip(j[:, None] + 2 + jnp.arange(k)[None, :],
                                0, s - 1)
                draft = jnp.take_along_axis(tokbuf, offs, 1)      # (B, k)

                toks = jnp.concatenate([last[:, None], draft], 1)  # (B, k+1)
                logits, cache = fwd(params, toks, pos, cache, span=span)
                g = jnp.argmax(logits, -1).astype(jnp.int32)       # (B, k+1)
                match = (draft == g[:, :k]).astype(jnp.int32)
                acc = jnp.sum(jnp.cumprod(match, 1), 1)            # (B,)
                nlast = jnp.take_along_axis(g, acc[:, None], 1)[:, 0]

                # record the emitted tokens in the lookup buffer: tokbuf[pos]
                # holds `last`, so the k+1 new tokens start at pos+1 (writing
                # at pos would clobber `last` and shift the searched bigram
                # off by one, collapsing drafting after the first iteration).
                # Rows past acc+1 are overwritten before the draft search can
                # reach them (search is bounded by pos).
                tokbuf = jax.vmap(
                    lambda buf, em, p: jax.lax.dynamic_update_slice(
                        buf, em, (p,)))(
                    tokbuf, g, jnp.minimum(pos + 1, s - (k + 1)))
                return (cache, tokbuf, pos + acc + 1, nlast), (g, acc)

            (cache, _, _, _), (em, accs) = jax.lax.scan(
                step, (cache, tokbuf, pos, last), None, length=iters)
            # scan stacks iters first; put batch first
            return (em.transpose(1, 0, 2), accs.T), cache

        @functools.partial(jax.jit, donate_argnums=(1,), static_argnums=(4,))
        def _decode_step_logits(params, cache, tokens, pos, span):
            """One t=1 decode forward returning the FULL logits row per
            slot — the host-stepping path for grammar-constrained
            sampling (the mask depends on per-sequence parser state the
            device cannot evaluate)."""
            logits, cache = fwd(params, tokens[:, None], pos, cache,
                                span=span)
            return logits[:, -1], cache

        self._spec_decode = _spec_decode
        self._prefill = _prefill
        self._decode = _decode
        self._decode_step_logits = _decode_step_logits

        # ------------------------------------------ draft-model drafting ---
        self.draft = draft
        self._draft_spec_decode = None
        if draft is not None:
            assert not sharded, (
                "draft-model speculation is single-chip for now (the draft "
                "cache would need its own sharding rules)")
            dcfg, dparams = load_llama(draft)
            assert dcfg.vocab_size == self.cfg.vocab_size, (
                "draft and target must share a vocabulary: "
                f"{dcfg.vocab_size} vs {self.cfg.vocab_size}")
            self.draft_cfg = dcfg
            self.draft_params = fuse_llama_params(dparams)
            self.draft_cache = init_kv_cache(dcfg, max_batch, self.max_seq)

            def dfwd(params, tokens, pos, cache, span=None, batch_axis=None,
                     _cfg=dcfg, _o=self.opts):
                return forward(params, _cfg, tokens, pos, cache, _o,
                               span=span)

            self._draft_prefill = _make_prefill(dfwd)

            @functools.partial(jax.jit, donate_argnums=(2, 3),
                               static_argnums=(6, 7, 8))
            def _draft_spec_decode(params, dparams, cache, dcache, pos, last,
                                   iters, k, span):
                """Greedy speculative decoding with a draft MODEL: per
                iteration each sequence

                  1. drafts k tokens by running the draft model's own
                     greedy t=1 decode k+1 times (the extra step inserts
                     the last draft token's KV so the draft cache always
                     covers the verified positions),
                  2. verifies with ONE t=k+1 target forward, greedy argmax
                     at every position,
                  3. accepts the matching prefix + the bonus token.

                Output is exactly the target's greedy stream. Both caches
                share the stale-row invariant of the prompt-lookup path:
                rows past an accepted prefix sit at positions > the next
                query position (causally masked) until the next inserts
                overwrite them. Returns (B, iters, k+1) emitted tokens and
                (B, iters) accept counts."""

                def step(carry, _):
                    cache, dcache, pos, last = carry

                    def dstep(c, _):
                        dcache, x, p = c
                        logits, dcache = dfwd(dparams, x[:, None], p, dcache,
                                              span=span)
                        nxt = jnp.argmax(
                            logits[:, -1], -1).astype(jnp.int32)
                        return (dcache, nxt, p + 1), nxt

                    (dcache, _, _), drafts_all = jax.lax.scan(
                        dstep, (dcache, last, pos), None, length=k + 1)
                    drafts = drafts_all[:k].T                      # (B, k)

                    toks = jnp.concatenate([last[:, None], drafts], 1)
                    logits, cache = fwd(params, toks, pos, cache, span=span)
                    g = jnp.argmax(logits, -1).astype(jnp.int32)   # (B, k+1)
                    match = (drafts == g[:, :k]).astype(jnp.int32)
                    acc = jnp.sum(jnp.cumprod(match, 1), 1)        # (B,)
                    nlast = jnp.take_along_axis(g, acc[:, None], 1)[:, 0]
                    return (cache, dcache, pos + acc + 1, nlast), (g, acc)

                (cache, dcache, _, _), (em, accs) = jax.lax.scan(
                    step, (cache, dcache, pos, last), None, length=iters)
                return (em.transpose(1, 0, 2), accs.T), cache, dcache

            self._draft_spec_decode = _draft_spec_decode

    # ------------------------------------------------------------- utils ---
    def start_session(self, n_keep: int = 0) -> ChatSession:
        """Pin a cache slot for multi-turn generation (see ChatSession).
        The slot is excluded from generate()'s pool until close().
        `n_keep`: with LLM(ctx_shift=True), rows pinned at the front
        (system prompt) that context shifts never drop."""
        assert self.cfg.causal, "encoder-only model: no chat sessions"
        free = [s for s in range(self.max_batch) if s not in self._reserved]
        if not free:
            raise RuntimeError("all slots reserved by sessions")
        self._reserved.add(free[0])
        # the session will overwrite this slot's rows; its recorded prefix
        # history (if any) is no longer the cache contents
        self._slot_history.pop(free[0], None)
        return ChatSession(self, free[0], n_keep=n_keep)

    def encode_chat(self, messages,
                    add_generation_prompt: bool = True,
                    tools: list | None = None) -> list[int]:
        """Render the chat template and encode it with special-token
        parsing: template-emitted control tokens (<s>, <|im_start|>, ...)
        become their single token ids, exactly as a chat-tuned checkpoint
        expects (no extra BOS is prepended — templates render their own)."""
        text = self.apply_chat_template(
            messages, add_generation_prompt=add_generation_prompt,
            tools=tools)
        if self.tokenizer is None:
            raise ValueError("model file has no embedded tokenizer")
        return encode_with_specials(self.tokenizer, text)

    _MEDIA_MARK = "\x00__media__\x00"

    def encode_chat_mm(self, messages,
                       add_generation_prompt: bool = True,
                       tools: list | None = None) -> list:
        """encode_chat for messages whose content may be OpenAI
        content-part lists ([{type: "text"}, {type: "image_url"}]):
        image parts become projected-embedding spans in the returned
        mixed prompt (token ids interleaved with image arrays, the
        generate() multimodal format). Images must be data: URIs —
        this server never fetches remote URLs."""
        imgs, flat = [], []
        for m in messages:
            c = m.get("content")
            if isinstance(c, list):
                parts = []
                for part in c:
                    if part.get("type") == "image_url":
                        u = part.get("image_url")
                        u = u.get("url") if isinstance(u, dict) else u
                        imgs.append(_decode_data_image(u))
                        parts.append(self._MEDIA_MARK)
                    else:
                        parts.append(str(part.get("text", "")))
                m = {**m, "content": "".join(parts)}
            flat.append(m)
        if not imgs:
            return self.encode_chat(flat, add_generation_prompt,
                                    tools=tools)
        if self.clip_cfg is None:
            raise ValueError("chat contains images but the server was "
                             "started without an mmproj model")
        text = self.apply_chat_template(
            flat, add_generation_prompt=add_generation_prompt,
            tools=tools)
        pieces = text.split(self._MEDIA_MARK)
        prompt: list = []
        for i, piece in enumerate(pieces):
            if piece:
                prompt.extend(encode_with_specials(self.tokenizer, piece))
            if i < len(pieces) - 1:
                prompt.append(imgs[i])
        return prompt

    # llama.cpp's fallback for template-less checkpoints: plain ChatML
    CHATML_TEMPLATE = (
        "{% for message in messages %}"
        "<|im_start|>{{ message.role }}\n{{ message.content }}<|im_end|>\n"
        "{% endfor %}"
        "{% if add_generation_prompt %}<|im_start|>assistant\n{% endif %}")

    def apply_chat_template(self, messages,
                            add_generation_prompt: bool = True,
                            tools: list | None = None) -> str:
        """Render the GGUF's embedded jinja chat template
        (tokenizer.chat_template) over OpenAI-style messages
        [{"role": ..., "content": ...}, ...]. Checkpoints without a
        template fall back to ChatML (llama.cpp's default). `tools`
        (OpenAI function specs) pass straight into the template for
        tool-calling checkpoints (hermes/qwen-style templates iterate
        them); parsing the model's tool-call output is the caller's
        job."""
        if not self.chat_template:
            self.chat_template = self.CHATML_TEMPLATE
        try:
            import jinja2
        except ImportError as e:  # optional extra: gguf_tpu[chat]
            raise ValueError(
                "chat templates need jinja2 (pip install jinja2)") from e

        env = jinja2.Environment(trim_blocks=True, lstrip_blocks=True)
        env.globals["raise_exception"] = lambda msg: (_ for _ in ()).throw(
            jinja2.TemplateError(msg))
        tok = self.tokenizer
        bos = tok.tokens[tok.bos_id] if tok is not None and getattr(
            tok, "bos_id", None) is not None else ""
        eos = tok.tokens[tok.eos_id] if tok is not None and getattr(
            tok, "eos_id", None) is not None else ""
        return env.from_string(self.chat_template).render(
            messages=messages, bos_token=bos, eos_token=eos,
            add_generation_prompt=add_generation_prompt,
            tools=tools or None)

    def _encode(self, prompt) -> list[int]:
        if isinstance(prompt, str):
            if self.tokenizer is None:
                raise ValueError("model file has no embedded tokenizer; pass token ids")
            return self.tokenizer.encode(prompt)
        return list(prompt)

    def _drop_lora_tmps(self):
        import os as _os

        for t in getattr(self, "_lora_tmp_paths", []):
            try:
                _os.remove(t)
            except OSError:
                pass
        self._lora_tmp_paths = []

    # ---------------------------------------------------------------- t5 ---
    def _t5_generate(self, prompts, max_new_tokens, sampler, seed,
                     stop_at_eos, stop=None, on_tokens=None,
                     stop_ids=None):
        """Encoder-decoder serving: encode the padded batch once, decode
        in lockstep jitted chunks from decoder_start_token_id (T5
        convention: encoder input is the raw text + EOS, no BOS).
        Supports temperature sampling, stop strings/ids, and streaming
        callbacks; finish_reason reflects EOS vs length."""
        from ..models.t5 import t5_generate

        t_start = time.perf_counter()
        ids = []
        for p in prompts:
            if isinstance(p, str):
                if self.tokenizer is None:
                    raise ValueError("model has no embedded tokenizer; "
                                     "pass token ids")
                e = self.tokenizer.encode(p, add_bos=False)
                e.append(self.tokenizer.eos_id)
            else:
                e = [int(x) for x in p]
            ids.append(e)
        lens = np.asarray([len(x) for x in ids])
        s = self._bucket(int(lens.max()))
        assert s <= self.max_seq, (s, self.max_seq)
        toks = np.zeros((len(ids), s), np.int32)
        for i, x in enumerate(ids):
            toks[i, :len(x)] = x
        eos = self.tokenizer.eos_id if self.tokenizer else 1
        stop_set = frozenset(int(t) for t in (stop_ids or ()))
        stopped: dict = {}

        def cb(row, new_ids, finished):
            """t5_generate hook: returns True once this row should stop
            (stop id seen, or a stop string completed in the decoded
            tail — overshoot tokens are trimmed so token_ids match the
            trimmed .text)."""
            if row in stopped:
                return True
            kept = []
            for t in new_ids:
                if t in stop_set:
                    stopped[row] = True
                    finished = True
                    break
                kept.append(t)
            results_ids[row].extend(kept)
            if stop and self.tokenizer is not None and kept:
                o = results_ids[row]
                prev = len(o) - len(kept)
                text = self.tokenizer.decode(o)
                cut = min((text.find(sp_) for sp_ in stop
                           if sp_ in text), default=-1)
                if cut >= 0:
                    # trim overshoot past the stop string so token_ids
                    # stay consistent with the trimmed .text
                    end = min(cut + len(sp_) for sp_ in stop
                              if text.find(sp_) == cut)
                    while o and len(self.tokenizer.decode(o)) > end:
                        o.pop()
                    kept = o[prev:]      # survivors of this chunk only
                    stopped[row] = True
                    finished = True
            if on_tokens is not None:
                on_tokens(row, kept, finished)
            return row in stopped

        results_ids = [[] for _ in ids]
        max_stop = max((len(x) for x in (stop or ())), default=0)
        outs, hit_eos = t5_generate(
            self.params, self.cfg, toks, lens,
            max_new_tokens=max_new_tokens,
            eos_id=eos if stop_at_eos else -1,
            temperature=sampler.temperature, seed=seed, on_tokens=cb)
        wall = time.perf_counter() - t_start
        results = []
        n_new = 0
        for i in range(len(ids)):
            o = results_ids[i]
            finished = bool(hit_eos[i]) or i in stopped
            reason = ("eos" if hit_eos[i]
                      else "stop" if i in stopped else "length")
            r = GenerationResult(prompt_ids=ids[i], token_ids=o,
                                 finished=finished, stop_reason=reason)
            n_new += len(o)
            if self.tokenizer is not None:
                r.text = self.tokenizer.decode(o)
                if stop:
                    cut = min((r.text.find(sp_) for sp_ in stop
                               if sp_ in r.text), default=-1)
                    if cut >= 0:
                        r.text = r.text[:cut]
            results.append(r)
        stats = {"wall_s": round(wall, 4), "new_tokens": n_new,
                 "tokens_per_s": round(n_new / max(wall, 1e-9), 2)}
        for r in results:
            r.stats = stats
        return results

    # ------------------------------------------------------ context shift ---
    def shift_slot(self, slot: int, keep: int, drop: int) -> None:
        """Drop `drop` cache rows at row `keep` in `slot`, sliding later
        rows down with rope re-rotation (llama.cpp --ctx-shift). The
        caller owns the position bookkeeping (ChatSession does it)."""
        from ..models.llama import shift_kv_cache

        if not hasattr(self, "_shift_jit"):
            self._shift_jit = jax.jit(functools.partial(
                shift_kv_cache, cfg=self.cfg), donate_argnums=(0,))
        self.cache = self._shift_jit(
            self.cache, slot=jnp.int32(slot), keep=jnp.int32(keep),
            drop=jnp.int32(drop))

    # ------------------------------------------------------- slot state ---
    def _state_meta(self) -> dict:
        """Geometry fingerprint a saved slot state must match to load."""
        c = self.cfg
        return {"dim": c.dim, "n_layers": c.n_layers,
                "kv_heads": c.kv_cache_heads, "cache_dim": c.kv_cache_dim,
                "vocab": c.vocab_size}

    def save_state(self, path: str, slot: int = 0, tokens=None,
                   rows: int | None = None) -> int:
        """Persist one cache slot — its resident INT8 KV rows plus the
        token history they encode — to an .npz file (llama.cpp slot-save /
        --prompt-cache lineage). Default source is the slot's release-time
        history (`_slot_history`, what the prefix cache would reuse);
        ChatSession.save passes its live history explicitly. Returns the
        number of rows saved."""
        if self.cfg.ssm_inner:
            raise ValueError("slot save/restore needs a KV cache; "
                             "recurrent (mamba) state is not supported")
        if tokens is None:
            tokens, rows = self._slot_history.get(slot, (None, None))
            if tokens is None:
                raise ValueError(
                    f"slot {slot} has no resident history to save")
        rows = int(rows)
        assert rows <= self.max_seq and rows <= len(tokens), (rows, len(tokens))
        import json as _json

        data = {"tokens": np.asarray(tokens, np.int32),
                "rows": np.int64(rows),
                "meta": np.frombuffer(
                    _json.dumps(self._state_meta()).encode(), np.uint8)}
        for i, cl in enumerate(self.cache):
            data[f"k{i}"] = np.asarray(cl["k"][slot, :, :rows])
            data[f"ks{i}"] = np.asarray(cl["k_scale"][slot, :, :rows])
            data[f"v{i}"] = np.asarray(cl["v"][slot, :, :rows])
            data[f"vs{i}"] = np.asarray(cl["v_scale"][slot, :, :rows])
        np.savez_compressed(path, **data)
        return rows

    def load_state(self, path: str, slot: int = 0):
        """Load a save_state() file into cache slot `slot` and register
        the history with the prefix cache, so the next prompt sharing the
        saved prefix prefills only its suffix. Returns (tokens, rows)."""
        import json as _json

        if self.cfg.ssm_inner:
            raise ValueError("slot save/restore needs a KV cache; "
                             "recurrent (mamba) state is not supported")
        z = np.load(path)
        meta = _json.loads(bytes(z["meta"]).decode())
        if meta != self._state_meta():
            raise ValueError(
                f"saved state geometry {meta} does not match this model "
                f"{self._state_meta()}")
        rows = int(z["rows"])
        if rows > self.max_seq:
            raise ValueError(
                f"saved state ({rows} rows) exceeds max_seq {self.max_seq}")
        tokens = [int(t) for t in z["tokens"]]
        for i in range(len(self.cache)):
            cl = self.cache[i]
            self.cache[i] = {
                "k": cl["k"].at[slot, :, :rows].set(z[f"k{i}"]),
                "k_scale": cl["k_scale"].at[slot, :, :rows].set(z[f"ks{i}"]),
                "v": cl["v"].at[slot, :, :rows].set(z[f"v{i}"]),
                "v_scale": cl["v_scale"].at[slot, :, :rows].set(z[f"vs{i}"]),
            }
        self._slot_history[slot] = (tokens, rows)
        return tokens, rows

    def erase_slot(self, slot: int) -> int:
        """Drop a slot's resident history (prefix cache will not reuse
        it). Returns the number of rows forgotten."""
        _, rows = self._slot_history.pop(slot, (None, 0))
        return int(rows)

    # ----------------------------------------------------------- infill ---
    def build_infill_tokens(self, prefix: str, suffix: str,
                            extra: list | None = None,
                            spm: bool = False) -> list[int]:
        """Fill-in-middle prompt tokens (llama.cpp /infill's
        format_infill): [BOS] FIM_PRE enc(prefix) FIM_SUF enc(suffix)
        FIM_MID — PSM order; `spm=True` swaps to suffix-prefix-middle,
        which codellama-style vocabularies were trained with.

        `extra`: repo-level context chunks [{"text": ..., "filename": ...}]
        — joined with FIM_REP/FIM_SEP when the vocabulary has them
        (qwen2.5-coder-style), otherwise prepended to the prefix as plain
        text."""
        fim = self.fim
        if not {"pre", "suf", "mid"} <= fim.keys():
            raise ValueError(
                "model vocabulary has no fill-in-middle tokens "
                "(tokenizer.ggml.fim_*_token_id / known FIM spellings)")
        tok = self.tokenizer
        enc = lambda s: tok.encode(s, add_bos=False)
        ids: list[int] = []
        if getattr(tok, "bos_id", None) is not None and tok.bos_id >= 0:
            ids.append(tok.bos_id)
        if extra:
            if "rep" in fim and "sep" in fim:
                for chunk in extra:
                    ids.append(fim["rep"] if not ids[1:] else fim["sep"])
                    name = chunk.get("filename")
                    ids += enc((name + "\n" if name else "")
                               + chunk.get("text", ""))
                ids.append(fim["sep"])
            else:
                prefix = "".join(c.get("text", "") for c in extra) + prefix
        a, b = ((fim["suf"], suffix), (fim["pre"], prefix)) if spm else \
            ((fim["pre"], prefix), (fim["suf"], suffix))
        ids += [a[0]] + enc(a[1]) + [b[0]] + enc(b[1]) + [fim["mid"]]
        return ids

    def infill(self, prefix: str, suffix: str, max_new_tokens: int = 64,
               sampler: SamplerConfig = SamplerConfig(), seed: int = 0,
               extra: list | None = None, spm: bool = False,
               **kw) -> GenerationResult:
        """Complete the span between `prefix` and `suffix` (FIM). Stops at
        EOS, EOT, or FIM_PAD; extra generate() kwargs pass through."""
        ids = self.build_infill_tokens(prefix, suffix, extra=extra, spm=spm)
        stop_ids = [self.fim[k] for k in ("eot", "pad") if k in self.fim]
        [res] = self.generate([ids], max_new_tokens=max_new_tokens,
                              sampler=sampler, seed=seed,
                              stop_ids=stop_ids, **kw)
        return res

    @staticmethod
    def _bucket(n: int) -> int:
        b = 8
        while b < n:
            b *= 2
        return b

    def _prefill_chunks(self, ids, slot: int, start: int = 0,
                        draft: bool = False):
        """Prefill `ids` into cache slot `slot` at positions
        start..start+len(ids)-1, in prefill_chunk-size pieces (bounded
        activation memory) with power-of-two tail buckets HALVED until the
        padded call fits the remaining cache rows — a bucket that overruns
        max_seq would clamp the t>16 dynamic_update_slice insert start and
        silently overwrite earlier history. Returns the logits of the last
        real token. `draft=True` targets the draft model's params/cache
        (same chunking, so both models see identical positions)."""
        n = len(ids)
        assert start + n < self.max_seq, (start, n, self.max_seq)
        ids = np.asarray(ids, np.int32)
        prefill = self._draft_prefill if draft else self._prefill
        params = self.draft_params if draft else self.params
        off = 0
        while True:
            tail = n - off
            tp = min(self._bucket(tail), self.prefill_chunk)
            while tp > self.max_seq - (start + off):
                tp //= 2
            take = min(tail, tp)
            toks = np.zeros((1, tp), np.int32)
            toks[0, :take] = ids[off:off + take]
            span = self._span_bucket(start + off + tp)
            logits, cache = prefill(
                params, self.draft_cache if draft else self.cache,
                jnp.asarray(toks), jnp.int32(slot), jnp.int32(start + off),
                jnp.int32(take - 1), span)
            if draft:
                self.draft_cache = cache
            else:
                self.cache = cache
            off += take
            if off >= n:
                return logits

    # ------------------------------------------------------- multimodal ---
    def embed_image(self, img) -> np.ndarray:
        """Image (HxWx3 array or PIL Image) -> (n_patches, dim) f32
        embeddings in the LM's space, via the mmproj CLIP tower +
        projector."""
        from ..models.clip import encode_image, preprocess_image

        assert self.clip_cfg is not None, "LLM(..., mmproj=...) not set"
        px = preprocess_image(img, self.clip_cfg)
        if not hasattr(self, "_clip_jit"):
            self._clip_jit = jax.jit(functools.partial(
                encode_image, self.clip_params, self.clip_cfg))
        return np.asarray(self._clip_jit(jnp.asarray(px))[0])

    def _prepare_prompt(self, prompt):
        """prompt -> (ids, embeds|None). Text-only prompts pass through;
        a list mixing token ids / text strings / images becomes a full
        (n, dim) embedding matrix (image spans carry token id 0 in `ids`
        for length bookkeeping — penalties/logprobs see the placeholder)."""
        if isinstance(prompt, str):
            return self._encode(prompt), None
        els = list(prompt)
        if all(isinstance(e, (int, np.integer)) for e in els):
            return [int(e) for e in els], None
        assert self.clip_cfg is not None, (
            "prompt contains images but the LLM was loaded without "
            "mmproj=")
        segs = []
        for el in els:
            if isinstance(el, (int, np.integer)):
                segs.append(("t", int(el)))
            elif isinstance(el, str):
                # BOS only at true position 0: an image- or id-led prompt
                # must not grow a BOS mid-sequence
                for tid in self.tokenizer.encode(el, add_bos=not segs):
                    segs.append(("t", tid))
            else:
                segs.append(("i", self.embed_image(el)))
        txt_ids = np.asarray([v for k, v in segs if k == "t"], np.int32)
        if not hasattr(self, "_tok_embed_jit"):
            from ..models.llama import embed as _embed

            def _te(params, ids, _cfg=self.cfg):
                e = _embed(params["token_embd"], ids)
                if _cfg.embed_scale != 1.0:
                    e = e * jnp.bfloat16(
                        _cfg.embed_scale).astype(jnp.float32)
                return e

            self._tok_embed_jit = jax.jit(_te)
        temb = (np.asarray(self._tok_embed_jit(self.params,
                                               jnp.asarray(txt_ids)))
                if len(txt_ids) else np.zeros((0, self.cfg.dim), np.float32))
        ids: list[int] = []
        rows = []
        ti = 0
        for k, v in segs:
            if k == "t":
                ids.append(v)
                rows.append(temb[ti:ti + 1])
                ti += 1
            else:
                ids.extend([0] * v.shape[0])
                rows.append(v)
        return ids, np.concatenate(rows, axis=0).astype(np.float32)

    def _prefill_chunks_embeds(self, emb, slot: int, start: int = 0):
        """_prefill_chunks over an (n, dim) embedding matrix."""
        n = emb.shape[0]
        assert start + n < self.max_seq, (start, n, self.max_seq)
        assert self._prefill_embeds_fn is not None, \
            "multimodal prefill is single-chip"
        off = 0
        while True:
            tail = n - off
            tp = min(self._bucket(tail), self.prefill_chunk)
            while tp > self.max_seq - (start + off):
                tp //= 2
            take = min(tail, tp)
            chunk = np.zeros((1, tp, emb.shape[1]), np.float32)
            chunk[0, :take] = emb[off:off + take]
            span = self._span_bucket(start + off + tp)
            logits, self.cache = self._prefill_embeds_fn(
                self.params, self.cache, jnp.asarray(chunk),
                jnp.int32(slot), jnp.int32(start + off),
                jnp.int32(take - 1), span)
            off += take
            if off >= n:
                return logits

    def _embed_encoder(self, prompts, pooling: str,
                       normalize: bool) -> np.ndarray:
        """bert-family path: one bidirectional pass + masked pooling."""
        from ..models.bert import bert_forward

        if not hasattr(self, "_bert_fwd"):
            self._bert_fwd = jax.jit(functools.partial(
                bert_forward, self.params, self.cfg))
        ids = [self._encode(p) for p in prompts]
        assert all(ids), "empty prompt"
        n = len(ids)
        lens = np.array([len(x) for x in ids])
        t = self._bucket(int(lens.max()))
        assert t <= self.max_seq, (t, self.max_seq)
        nb = self._bucket(n)
        toks = np.zeros((nb, t), np.int32)
        if getattr(self.tokenizer, "pad_id", None):
            toks += int(self.tokenizer.pad_id)
        for i, x in enumerate(ids):
            toks[i, :len(x)] = x
        lens_full = np.ones(nb, np.int64)
        lens_full[:n] = lens
        hidden = np.asarray(self._bert_fwd(
            jnp.asarray(toks), jnp.asarray(lens_full, jnp.int32)))[:n]
        if self.cfg.pooling != "none":   # the checkpoint's contract wins
            pooling = self.cfg.pooling
        if pooling == "rank":
            raise ValueError(
                "this checkpoint is a reranker (pooling_type rank): its "
                "cls head yields scores, not embeddings — use rerank()")
        out = np.zeros((n, hidden.shape[-1]), np.float32)
        for i in range(n):
            if pooling == "cls":
                out[i] = hidden[i, 0]
            elif pooling == "last":
                out[i] = hidden[i, lens[i] - 1]
            else:
                out[i] = hidden[i, :lens[i]].mean(axis=0)
        if normalize:
            out /= np.maximum(np.linalg.norm(out, axis=1, keepdims=True),
                              1e-12)
        return out

    def rerank(self, query: str, documents: list[str]) -> np.ndarray:
        """Relevance scores (N,) for (query, doc) pairs through a
        reranker checkpoint (bert arch, pooling_type rank, cls head) —
        each pair encodes as [CLS] query [SEP] doc [SEP] (llama.cpp
        /v1/rerank formatting)."""
        from ..models.bert import bert_forward, rank_scores

        assert not self.cfg.causal and "cls" in self.params, (
            "rerank() needs a reranker checkpoint "
            "(bert arch with a cls head)")
        tok = self.tokenizer
        ids = []
        for doc in documents:
            q = tok.encode(query)                      # [CLS] q [SEP]
            d = tok.encode(doc, add_bos=False) + [tok.sep_id]
            ids.append((q + d)[:self.max_seq])
        lens = np.array([len(x) for x in ids])
        t = self._bucket(int(lens.max()))
        nb = self._bucket(len(ids))
        toks = np.zeros((nb, t), np.int32)
        for i, x in enumerate(ids):
            toks[i, :len(x)] = x
        lens_full = np.ones(nb, np.int64)
        lens_full[:len(ids)] = lens
        if not hasattr(self, "_rank_fwd"):
            def _rfwd(params, toks, lens, _cfg=self.cfg):
                hidden = bert_forward(params, _cfg, toks, lens)
                return rank_scores(params, _cfg, hidden)

            self._rank_fwd = jax.jit(_rfwd)
        scores = np.asarray(self._rank_fwd(
            self.params, jnp.asarray(toks),
            jnp.asarray(lens_full, jnp.int32)))
        return scores[:len(ids)]

    def embed(self, prompts, pooling: str = "mean",
              normalize: bool = True) -> np.ndarray:
        """Sentence embeddings: one batched forward with the LM head
        skipped; the final-norm hidden states are pooled over each
        prompt's tokens ("mean" or "last") and L2-normalized by default
        (the OpenAI embeddings contract; llama.cpp --embedding). Accepts
        strings (tokenized here) or token-id lists. Returns (N, dim) f32.

        Pad tokens cannot leak into the result: they sit after the real
        tokens, so causal attention never lets a real position see them,
        and pooling masks them out.

        bert-family encoders route to the bidirectional forward; their
        GGUF pooling_type (mean/cls/last) overrides `pooling`."""
        if not self.cfg.causal:
            return self._embed_encoder(prompts, pooling, normalize)
        assert pooling in ("mean", "last"), pooling
        assert self.mesh is None, "embed() is single-chip for now"
        if not hasattr(self, "_embed_fwd"):
            def _efwd(params, toks, cache, _cfg=self.cfg, _o=self.opts):
                hidden, _ = forward(
                    params, _cfg, toks, jnp.zeros(toks.shape[0], jnp.int32),
                    cache, _o, return_hidden=True)
                return hidden
            self._embed_fwd = jax.jit(_efwd)
        ids = [self._encode(p) for p in prompts]
        assert all(ids), "empty prompt"
        n = len(ids)
        lens = np.array([len(x) for x in ids])
        t = self._bucket(int(lens.max()))
        assert t <= self.max_seq, (t, self.max_seq)
        nb = self._bucket(n)
        toks = np.zeros((nb, t), np.int32)
        for i, x in enumerate(ids):
            toks[i, :len(x)] = x
        cache = init_kv_cache(self.cfg, nb, t)
        hidden = np.asarray(self._embed_fwd(
            self.params, jnp.asarray(toks), cache))[:n]       # (n, t, dim)
        if pooling == "last":
            out = hidden[np.arange(n), lens - 1]
        else:
            mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
            out = (hidden * mask[:, :, None]).sum(1) / lens[:, None]
        if normalize:
            out = out / np.maximum(np.linalg.norm(out, axis=1, keepdims=True),
                                   1e-12)
        return out.astype(np.float32)

    def _span_bucket(self, need: int) -> int | None:
        """Smallest 128*2^j cache span covering `need` rows (None = whole
        cache). Power-of-two buckets keep the decode jit specializations
        bounded while attention HBM traffic tracks actual sequence depth."""
        if self.max_seq < 128:
            return None
        span = 128
        while span < need and span < self.max_seq:
            span *= 2
        return min(span, self.max_seq)

    # ---------------------------------------------------------- generate ---
    def generate(
        self,
        prompts,
        max_new_tokens: int = 64,
        sampler: SamplerConfig = SamplerConfig(),
        seed: int = 0,
        stop_at_eos: bool = True,
        stop: list[str] | None = None,
        decode_chunk: int = 8,
        on_tokens=None,
        logprobs: int = 0,
        speculative: int = 0,
        grammar: str | None = None,
        stop_ids=None,
    ) -> list[GenerationResult]:
        """Generate completions with continuous batching over the slot pool.

        `stop`: optional stop strings — a sequence finishes as soon as its
        decoded tail contains one (the stop string itself is trimmed from
        .text). Requires an embedded tokenizer.
        `stop_ids`: extra terminator token ids beyond EOS (infill's EOT /
        FIM_PAD, end-of-generation control tokens); the terminator is
        trimmed from .token_ids like EOS.
        `decode_chunk`: decode steps per device round-trip. Larger chunks
        amortize host sync/scheduler overhead; a finished sequence wastes at
        most chunk-1 speculative steps and new requests wait at most one
        chunk for a slot. Sampling key streams differ across chunk sizes
        (greedy output does not).
        `on_tokens(request_index, new_token_ids, finished)`: streaming
        callback, invoked from this thread after each prefill/decode chunk
        with that request's newly available raw token ids (stop-string
        trimming only applies to the final .text; a stream may overshoot
        by up to the stop string + one chunk).
        `logprobs`: when > 0, each result's .logprobs records the chosen
        token's logprob and the top-k alternatives per generated token.
        `speculative`: draft length k for device-side prompt-lookup
        speculative decoding (greedy only — requires temperature 0, no
        penalties, no logprobs). Output is token-for-token identical to
        plain greedy decoding; repetitive text decodes up to (k+1)x
        faster because each verify step can accept k drafts + 1 bonus
        token in one forward.
        `grammar`: GBNF text (llama.cpp dialect; engine/grammar.JSON_GBNF
        for JSON mode) — every emitted token is constrained to keep the
        output inside the grammar, via host-stepped decoding with exact
        masked sampling (a Gumbel-ordered candidate walk touches only a
        handful of tokens per step). Requires an embedded tokenizer;
        incompatible with speculative/logprobs."""
        if self.t5:
            assert speculative == 0 and grammar is None and logprobs == 0, \
                "t5 serving supports sampling/stop/streaming only"
            return self._t5_generate(prompts, max_new_tokens, sampler,
                                     seed, stop_at_eos, stop=stop,
                                     on_tokens=on_tokens,
                                     stop_ids=stop_ids)
        assert self.cfg.causal, (
            "encoder-only (bert-family) model: use embed(), not generate()")
        t_start = time.perf_counter()
        g_samplers: dict = {}
        g_rng = None
        if grammar is not None:
            from .grammar import GrammarSampler

            assert self.tokenizer is not None, "grammar needs a tokenizer"
            assert speculative == 0 and logprobs == 0, (
                "grammar-constrained decoding is host-stepped: no "
                "speculative drafts or logprobs")
            if (sampler.uses_penalties or sampler.logit_bias
                    or sampler.mirostat or sampler.uses_dry):
                raise ValueError(
                    "grammar-constrained decoding does not compose with "
                    "repetition penalties, logit_bias, mirostat or DRY "
                    "(top_k/top_p/min_p/typical_p/temperature are honored)")
            g_rng = np.random.default_rng(seed)
        # the t=k+1 verify forward must stay on the windowed Pallas insert
        # (t <= 16), whose out-of-range no-op protects reserved ChatSession
        # slots; the _cache_update fallback's clamped DUS would overwrite
        # their trailing KV rows at the pos=max_seq sentinel
        assert speculative == 0 or speculative + 1 <= 16, (
            f"speculative draft length {speculative} > 15 would route the "
            "verify forward off the windowed cache insert")
        assert speculative == 0 or not self.cfg.ssm_inner, (
            "speculative decoding needs rewindable KV rows; recurrent "
            "(mamba) state cannot roll back rejected drafts")
        # draft-model speculation only engages under the spec gate; don't
        # pay the draft prefill for calls that can never use it
        draft_active = (speculative > 0
                        and self._draft_spec_decode is not None
                        and grammar is None
                        and sampler.temperature <= 0.0
                        and not sampler.uses_penalties
                        and not sampler.logit_bias and not sampler.mirostat
                        and not sampler.uses_dry
                        and logprobs == 0)
        queue = [(i, *self._prepare_prompt(p)) for i, p in enumerate(prompts)]
        if any(emb is not None for _, _, emb in queue):
            assert speculative == 0, (
                "speculative decoding over multimodal prompts is not "
                "supported (the draft model cannot see image embeddings)")
        queue.reverse()  # pop() takes the earliest request
        results = {i: GenerationResult(prompt_ids=ids,
                                       logprobs=[] if logprobs else None)
                   for i, ids, _ in reversed(queue)}

        emitted = {i: 0 for i in results}
        done_emitted: set = set()

        def _flush():
            if on_tokens is None:
                return
            for rid, res in results.items():
                n = len(res.token_ids)
                if n > emitted[rid] or (res.finished
                                        and rid not in done_emitted):
                    on_tokens(rid, res.token_ids[emitted[rid]:n],
                              res.finished)
                    emitted[rid] = n
                    if res.finished:
                        done_emitted.add(rid)

        slots: list[int | None] = [None] * self.max_batch  # request id per slot
        # mirostat v2 state: per-slot adaptive surprise threshold (reset
        # when a slot admits a new request)
        mu_state = np.full(self.max_batch, 2.0 * sampler.mirostat_tau,
                           np.float32)
        pos = np.zeros(self.max_batch, np.int64)
        last_tok = np.zeros(self.max_batch, np.int64)
        budget = np.zeros(self.max_batch, np.int64)
        key = jax.random.PRNGKey(seed)
        eos = self.tokenizer.eos_id if self.tokenizer else -1
        stop_id_set = frozenset(int(t) for t in (stop_ids or ()))

        if queue and len(self._reserved) >= self.max_batch:
            raise RuntimeError(
                "every cache slot is reserved by ChatSessions; close one "
                "before calling generate()")

        def _ids_counts(rows_ids):
            """(slot -> context ids) -> (max_batch, V) int32 counts,
            windowed to the last penalty_last_n ids when set."""
            cnts = np.zeros((self.max_batch, self.cfg.vocab_size), np.int32)
            for s, ids in rows_ids.items():
                ids = _penalty_window(ids, sampler.penalty_last_n)
                np.add.at(cnts[s], np.asarray(ids, np.int64), 1)
            return jnp.asarray(cnts)

        def admit():
            nonlocal key
            for s in range(self.max_batch):
                if slots[s] is not None or s in self._reserved or not queue:
                    continue
                rid, ids, emb = queue.pop()
                n = len(ids)
                assert n < self.max_seq, f"prompt ({n}) exceeds max_seq {self.max_seq}"
                # prefix cache: reuse this slot's resident KV rows for the
                # longest shared prompt prefix (capped at n-1 so the last
                # token always runs — its logits seed sampling).
                # Multimodal prompts never match: image spans carry
                # placeholder ids that would alias unrelated content.
                hist, rows = self._slot_history.pop(s, (None, 0))
                common = 0
                if self.prefix_cache and hist and emb is None:
                    lim = min(len(hist), rows, n - 1)
                    while common < lim and hist[common] == ids[common]:
                        common += 1
                    if common < 8:   # below a prefill bucket: not worth a
                        common = 0   # distinct start-offset specialization
                    self.prefix_cache_hits += common
                logits = (self._prefill_chunks_embeds(emb, s)
                          if emb is not None else
                          self._prefill_chunks(ids[common:], s,
                                               start=common))
                if draft_active:
                    # the draft model drafts from its own cache: give it the
                    # same prompt at the same positions (no history is
                    # tracked for the draft cache — full prefill)
                    self._prefill_chunks(ids, s, draft=True)
                key, sub = jax.random.split(key)
                if grammar is not None:
                    from .grammar import GrammarSampler

                    gs = GrammarSampler(grammar, self.tokenizer, eos)
                    first = gs.pick(np.asarray(logits), sampler.temperature,
                                    g_rng, sampler=sampler)
                    gs.advance(first)
                    g_samplers[rid] = gs
                else:
                    cnt1 = (_ids_counts({0: ids})[:1]
                            if sampler.uses_penalties else None)
                    if sampler.uses_dry:
                        h1 = np.zeros((1, self.max_seq), np.int32)
                        h1[0, :len(ids)] = ids
                        dry1 = (jnp.asarray(h1),
                                jnp.asarray([len(ids)], jnp.int32))
                    else:
                        dry1 = (None, None)
                    if sampler.mirostat:
                        mu_state[s] = 2.0 * sampler.mirostat_tau
                        f_tok, f_mu = sample_mirostat(
                            logits[None, :], sub, sampler,
                            jnp.asarray(mu_state[s:s + 1]), cnt1, *dry1)
                        first = int(f_tok[0])
                        mu_state[s] = float(f_mu[0])
                    else:
                        first = int(sample(logits[None, :], sub, sampler,
                                           cnt1, *dry1)[0])
                if logprobs:
                    lp = np.asarray(jax.nn.log_softmax(
                        logits.astype(jnp.float32)))
                    order = np.argsort(-lp)[:logprobs]
                    results[rid].logprobs.append({
                        "logprob": float(lp[first]),
                        "top": [(int(t), float(lp[t])) for t in order]})
                slots[s] = rid
                pos[s] = n
                last_tok[s] = first
                budget[s] = max_new_tokens - 1
                results[rid].token_ids.append(first)
                _maybe_finish(s, first)

        max_stop = max((len(x) for x in stop), default=0) if stop else 0

        def _hit_stop(res) -> str | None:
            if not stop or self.tokenizer is None:
                return None
            # decode only a tail window long enough to contain any stop string
            # 4x: a multi-byte char can span several byte-fallback tokens
            tail_ids = res.token_ids[-(4 * max_stop + 8):]
            tail = self.tokenizer.decode(tail_ids)
            for sp in stop:
                if sp in tail:
                    return sp
            return None

        def _maybe_finish(s, tok):
            rid = slots[s]
            if rid is None:
                return
            hit = _hit_stop(results[rid])
            done = (stop_at_eos and tok == eos) or tok in stop_id_set or \
                budget[s] <= 0 or \
                pos[s] + 1 >= self.max_seq or hit is not None
            if done:
                res = results[rid]
                res.finished = True
                if stop_at_eos and tok == eos:
                    res.stop_reason = "eos"
                elif tok in stop_id_set or hit is not None:
                    res.stop_reason = "stop"
                else:
                    res.stop_reason = "length"
                if res.token_ids and (
                        (stop_at_eos and res.token_ids[-1] == eos)
                        or res.token_ids[-1] in stop_id_set):
                    res.token_ids.pop()
                    if res.logprobs:
                        res.logprobs.pop()
                if self.prefix_cache:
                    # rows 0..pos-1 hold prompt + emitted tokens in order
                    # (the newest token's KV is never inserted before the
                    # slot is released, hence the pos[s] cap)
                    self._slot_history[s] = (
                        list(res.prompt_ids) + list(res.token_ids),
                        int(pos[s]))
                slots[s] = None

        admit()
        _flush()
        while any(s is not None for s in slots) or queue:
            live = [s for s in range(self.max_batch) if slots[s] is not None]
            if not live:
                # every admitted request finished during admit() (e.g.
                # max_new_tokens=1 or first-token EOS) with more queued
                admit()
                _flush()
                continue
            key, sub = jax.random.split(key)
            # bound the chunk by the smallest live budget / remaining room so
            # jit specializations stay few (powers of two) and overshoot small
            room = min(min(int(budget[s]) + 1, self.max_seq - int(pos[s]) - 1)
                       for s in live)
            steps = 1
            while steps * 2 <= min(decode_chunk, max(room, 1)):
                steps *= 2
            # inactive slots run at pos=max_seq: attention output is garbage
            # (discarded) and the windowed cache insert clamps to a no-op,
            # so reserved ChatSession slots keep their KV intact
            pos_dev = np.where([slots[s] is not None
                                for s in range(self.max_batch)],
                               pos, self.max_seq)
            if grammar is not None:
                # host-stepped constrained decoding: one t=1 forward, the
                # per-sequence grammar parsers pick from the full logits
                span = self._span_bucket(max(int(pos[s]) for s in live) + 1)
                logits_all, self.cache = self._decode_step_logits(
                    self.params, self.cache,
                    jnp.asarray(last_tok, jnp.int32),
                    jnp.asarray(pos_dev, jnp.int32), span)
                la = np.asarray(logits_all)
                for s in range(self.max_batch):
                    if slots[s] is None:
                        continue
                    gs = g_samplers[slots[s]]
                    tok = gs.pick(la[s], sampler.temperature, g_rng,
                                  sampler=sampler)
                    gs.advance(tok)
                    results[slots[s]].token_ids.append(tok)
                    pos[s] += 1
                    last_tok[s] = tok
                    budget[s] -= 1
                    _maybe_finish(s, tok)
                admit()
                _flush()
                continue
            use_spec = (speculative > 0 and sampler.temperature <= 0.0
                        and not sampler.uses_penalties and logprobs == 0
                        and not sampler.logit_bias and not sampler.mirostat
                        and not sampler.uses_dry
                        and room >= speculative + 1)
            if use_spec:
                k = speculative
                iters = max(1, min(decode_chunk, room // (k + 1)))
                span = self._span_bucket(
                    max(int(pos[s]) for s in live) + iters * (k + 1))
                if self._draft_spec_decode is not None:
                    (em, accs), self.cache, self.draft_cache = \
                        self._draft_spec_decode(
                            self.params, self.draft_params, self.cache,
                            self.draft_cache, jnp.asarray(pos_dev, jnp.int32),
                            jnp.asarray(last_tok, jnp.int32), iters, k, span)
                else:
                    tokbuf = np.zeros((self.max_batch, self.max_seq), np.int32)
                    for s in live:
                        ctx = results[slots[s]].prompt_ids + \
                            results[slots[s]].token_ids
                        tokbuf[s, :len(ctx)] = ctx
                    (em, accs), self.cache = self._spec_decode(
                        self.params, self.cache, jnp.asarray(tokbuf),
                        jnp.asarray(pos_dev, jnp.int32),
                        jnp.asarray(last_tok, jnp.int32), iters, k, span)
                em, accs = np.asarray(em), np.asarray(accs)
                for it in range(iters):
                    for s in range(self.max_batch):
                        if slots[s] is None:
                            continue
                        for tok in em[s, it, :int(accs[s, it]) + 1]:
                            tok = int(tok)
                            results[slots[s]].token_ids.append(tok)
                            pos[s] += 1
                            last_tok[s] = tok
                            budget[s] -= 1
                            _maybe_finish(s, tok)
                            if slots[s] is None:
                                break
                admit()
                _flush()
                continue
            span = self._span_bucket(max(int(pos[s]) for s in live) + steps)
            if sampler.uses_penalties:
                counts = _ids_counts({
                    s: results[slots[s]].prompt_ids + results[slots[s]].token_ids
                    for s in live})
            else:
                counts = jnp.zeros((self.max_batch, 1), jnp.int32)
            if sampler.uses_dry:
                hist_np = np.zeros((self.max_batch, self.max_seq), np.int32)
                hlen_np = np.zeros(self.max_batch, np.int32)
                for s in live:
                    ctx = (results[slots[s]].prompt_ids
                           + results[slots[s]].token_ids)
                    hist_np[s, :len(ctx)] = ctx
                    hlen_np[s] = len(ctx)
                hist, hlen = jnp.asarray(hist_np), jnp.asarray(hlen_np)
            else:
                hist = jnp.zeros((self.max_batch, 1), jnp.int32)
                hlen = jnp.zeros(self.max_batch, jnp.int32)
            (ids, lps, tids, tlps), self.cache, mu_dev = self._decode(
                self.params, self.cache,
                jnp.asarray(last_tok, jnp.int32),
                jnp.asarray(pos_dev, jnp.int32),
                counts, hist, hlen,
                jnp.asarray(mu_state, jnp.float32), sub, sampler,
                steps, span, logprobs)
            if sampler.mirostat:
                mu_state = np.asarray(mu_dev)
            ids = np.asarray(ids)
            if logprobs:
                lps, tids, tlps = (np.asarray(lps), np.asarray(tids),
                                   np.asarray(tlps))
            for j in range(steps):
                for s in range(self.max_batch):
                    if slots[s] is None:
                        continue
                    tok = int(ids[s, j])
                    if logprobs:
                        results[slots[s]].logprobs.append({
                            "logprob": float(lps[s, j]),
                            "top": [(int(t), float(l)) for t, l in
                                    zip(tids[s, j], tlps[s, j])]})
                    results[slots[s]].token_ids.append(tok)
                    pos[s] += 1
                    last_tok[s] = tok
                    budget[s] -= 1
                    _maybe_finish(s, tok)
            admit()
            _flush()

        out = [results[i] for i in sorted(results)]
        _flush()
        wall = time.perf_counter() - t_start
        new_tokens = sum(len(r.token_ids) for r in out)
        stats = {"wall_s": round(wall, 4), "new_tokens": new_tokens,
                 "tokens_per_s": round(new_tokens / wall, 1) if wall else 0.0}
        for r in out:
            r.stats = stats
        if self.tokenizer is not None:
            for r in out:
                r.text = self.tokenizer.decode(r.token_ids)
                if stop:
                    # trim at the EARLIEST occurrence across all stop
                    # strings, not the first list entry that matches
                    cuts = [i for i in (r.text.find(sp) for sp in stop)
                            if i >= 0]
                    if cuts:
                        r.text = r.text[:min(cuts)]
        return out
