"""HTTP serving frontend — an OpenAI-style /v1/completions endpoint over the
continuous-batching engine, stdlib only (http.server + a request queue).

    python -m gguf_tpu.engine.server model.gguf --port 8000 [--tp N]

    curl localhost:8000/v1/completions -d '{
        "prompt": "The capital of France is",
        "max_tokens": 32, "temperature": 0.7}'

Requests are collected into micro-batches: an engine thread drains the queue
and runs one `generate` over everything waiting, so concurrent clients share
decode steps through the slot pool. (The reference has no serving surface at
all; this is the operational front of the north-star serving stack.)
"""

from __future__ import annotations

import argparse
import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .engine import LLM
from .sampler import SamplerConfig


class _Request:
    def __init__(self, prompt, max_tokens, sampler, seed, stop=None,
                 stream=False, logprobs=0, session=None, embed=False,
                 grammar=None, stop_ids=None):
        self.prompt = prompt
        self.max_tokens = max_tokens
        self.sampler = sampler
        self.seed = seed
        self.stop = stop
        self.stop_ids = stop_ids        # extra terminator ids (/infill EOT)
        self.slot_op = None             # ("save"|"restore"|"erase", slot, path)
        self.rerank = None              # (query, documents) for /v1/rerank
        self.stream = stream
        self.logprobs = logprobs
        self.session = session          # conversation id (chat sessions)
        self.embed = embed              # /v1/embeddings (prompt = inputs)
        self.grammar = grammar          # GBNF text (constrained decoding)
        self.fanout = 1                 # OpenAI "n": choices per prompt
        # streaming: (new_token_ids, finished) tuples, then a None sentinel
        self.events: queue.Queue = queue.Queue()
        self.done = threading.Event()
        self.result = None
        self.error = None


class EngineWorker:
    """Single engine thread: drains the request queue into micro-batches
    (JAX computations must stay on one thread)."""

    def __init__(self, llm: LLM, max_wait_s: float = 0.01):
        self.llm = llm
        self.queue: queue.Queue[_Request] = queue.Queue()
        self.max_wait_s = max_wait_s
        # serving counters (read by /metrics; single writer = this thread)
        self.metrics = {"requests_total": 0, "requests_failed": 0,
                        "prompt_tokens_total": 0,
                        "completion_tokens_total": 0,
                        "engine_busy_s_total": 0.0}
        # conversation id -> (ChatSession, last-used); LRU-evicted when the
        # slot pool runs dry (one slot always stays free for stateless
        # requests). Only the engine thread touches this.
        self.sessions: dict = {}
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, req: _Request) -> None:
        self.queue.put(req)

    def _drain_batch(self) -> list[_Request]:
        batch = [self.queue.get()]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.llm.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                batch.append(self.queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _fresh_session(self, sid: str):
        # keep >= 1 slot unreserved for stateless requests
        while len(self.llm._reserved) >= self.llm.max_batch - 1:
            if not self.sessions:
                # slots are reserved but none are ours to evict (max_batch=1,
                # or slots pinned outside the server): clear capacity error
                # instead of min() on an empty dict
                raise ValueError(
                    "no session capacity: all engine slots are reserved and "
                    "no server-owned session can be evicted "
                    f"(max_batch={self.llm.max_batch})")
            lru = min(self.sessions, key=lambda k: self.sessions[k]["ts"])
            self.sessions.pop(lru)["sess"].close()
        entry = {"sess": self.llm.start_session(), "covered": "",
                 "ts": time.monotonic()}
        self.sessions[sid] = entry
        return entry

    def _run_session(self, r: _Request) -> None:
        """Chat request bound to a conversation id: the session's pinned
        slot caches the conversation's K/V, and each request prefills only
        the rendered-template SUFFIX beyond what the cache covers
        (llama.cpp-style prompt-cache diffing — clients resend the full
        message list every turn). A history edit (covered text no longer a
        prefix) resets the session transparently."""
        from .engine import encode_with_specials

        t0 = time.monotonic()
        try:
            llm = self.llm
            rendered = llm.apply_chat_template(r.prompt)  # full conversation
            entry = self.sessions.get(r.session)
            if entry is None or not rendered.startswith(entry["covered"]):
                if entry is not None:            # history edited: reset
                    entry["sess"].close()
                    del self.sessions[r.session]
                entry = self._fresh_session(r.session)
            entry["ts"] = time.monotonic()
            delta = rendered[len(entry["covered"]):]
            ids = encode_with_specials(llm.tokenizer, delta)
            res = entry["sess"].send(ids, max_new_tokens=r.max_tokens,
                                     sampler=r.sampler, seed=r.seed)
            # the generated reply is cached too; the template's turn-closing
            # tokens arrive with the next request's rendered suffix
            entry["covered"] = rendered + res.text
            r.result = res
            self.metrics["prompt_tokens_total"] += len(res.prompt_ids)
            self.metrics["completion_tokens_total"] += len(res.token_ids)
            if r.stream:
                r.events.put((list(res.token_ids), True))
        except Exception as e:
            r.error = str(e)
            self.metrics["requests_failed"] += 1
            if r.stream:
                r.events.put(("error", r.error))
        self.metrics["requests_total"] += 1
        self.metrics["engine_busy_s_total"] += time.monotonic() - t0
        r.events.put(None)
        r.done.set()

    def _run_embed(self, r: _Request) -> None:
        t0 = time.monotonic()
        try:
            r.result = self.llm.embed(r.prompt)
            self.metrics["prompt_tokens_total"] += sum(
                len(p) if not isinstance(p, str) else 0 for p in r.prompt)
        except Exception as e:
            r.error = str(e)
            self.metrics["requests_failed"] += 1
        self.metrics["requests_total"] += 1
        self.metrics["engine_busy_s_total"] += time.monotonic() - t0
        r.done.set()

    def _run_slot_op(self, r: _Request) -> None:
        """Slot save/restore/erase — on the engine thread, so cache
        mutation never races a decode (llama.cpp /slots/{id}?action=...)."""
        try:
            action, slot, path = r.slot_op
            llm = self.llm
            if not 0 <= slot < llm.max_batch:
                raise ValueError(f"slot {slot} out of range "
                                 f"(max_batch={llm.max_batch})")
            # a ChatSession pinned to this slot carries the live history;
            # otherwise the slot's release-time history is the source
            sess = next((e["sess"] for e in self.sessions.values()
                         if e["sess"].slot == slot), None)
            if action == "save":
                n = sess.save(path) if sess else llm.save_state(path,
                                                                slot=slot)
                r.result = {"id_slot": slot, "filename": path, "n_saved": n}
            elif action == "restore":
                n = (sess.restore(path) if sess
                     else llm.load_state(path, slot=slot)[1])
                r.result = {"id_slot": slot, "filename": path,
                            "n_restored": n}
            elif action == "erase":
                r.result = {"id_slot": slot,
                            "n_erased": llm.erase_slot(slot)}
            else:
                raise ValueError(f"unknown slot action {action!r}")
        except Exception as e:
            r.error = str(e)
            self.metrics["requests_failed"] += 1
        self.metrics["requests_total"] += 1
        r.done.set()

    def _run_rerank(self, r: _Request) -> None:
        t0 = time.monotonic()
        try:
            query, docs = r.rerank
            scores = self.llm.rerank(query, docs)
            r.result = [{"index": i, "relevance_score": float(s)}
                        for i, s in enumerate(scores)]
        except Exception as e:
            r.error = str(e)
            self.metrics["requests_failed"] += 1
        self.metrics["requests_total"] += 1
        self.metrics["engine_busy_s_total"] += time.monotonic() - t0
        r.done.set()

    def _run(self) -> None:
        while True:
            batch = self._drain_batch()
            for r in [x for x in batch if x.slot_op is not None]:
                self._run_slot_op(r)
            for r in [x for x in batch if x.rerank is not None]:
                self._run_rerank(r)
            # session-bound requests run through their pinned slots, one at
            # a time (their KV prefix lives in a specific slot)
            for r in [x for x in batch if x.session is not None]:
                self._run_session(r)
            for r in [x for x in batch if x.embed]:
                self._run_embed(r)
            batch = [x for x in batch if x.session is None and not x.embed
                     and x.slot_op is None and x.rerank is None]
            if not batch:
                continue
            # group by sampler/max_tokens (static jit args); serve each group
            groups: dict = {}
            for r in batch:
                key = (r.sampler, r.max_tokens, r.seed,
                       tuple(r.stop) if r.stop else None, r.logprobs,
                       r.grammar, tuple(r.stop_ids) if r.stop_ids else None)
                groups.setdefault(key, []).append(r)
            for (sampler, max_tokens, seed, stop, lpk,
                 grammar, stop_ids), reqs in groups.items():
                streaming = any(r.stream for r in reqs)

                # fanout ("n"): duplicate the prompt inside ONE generate
                # call — per-row categorical draws are independent, and a
                # single batch avoids the identical-replay of re-seeded
                # calls. offsets maps batch rows back to requests.
                offsets = []
                prompts = []
                for r in reqs:
                    offsets.append(len(prompts))
                    prompts.extend([r.prompt] * r.fanout)

                def on_tokens(idx, ids, finished, _reqs=reqs,
                              _off=offsets):
                    import bisect

                    ri = bisect.bisect_right(_off, idx) - 1
                    r = _reqs[ri]
                    if r.stream:
                        r.events.put((list(ids), finished))

                t0 = time.monotonic()
                try:
                    results = self.llm.generate(
                        prompts, max_new_tokens=max_tokens,
                        sampler=sampler, seed=seed,
                        stop=list(stop) if stop else None,
                        on_tokens=on_tokens if streaming else None,
                        logprobs=lpk, grammar=grammar,
                        stop_ids=list(stop_ids) if stop_ids else None)
                    for r, off in zip(reqs, offsets):
                        group = results[off:off + r.fanout]
                        r.result = group[0] if r.fanout == 1 else group
                        for res in group:
                            self.metrics["prompt_tokens_total"] += \
                                len(res.prompt_ids)
                            self.metrics["completion_tokens_total"] += \
                                len(res.token_ids)
                except Exception as e:  # surface engine errors to the client
                    for r in reqs:
                        r.error = str(e)
                    self.metrics["requests_failed"] += len(reqs)
                self.metrics["requests_total"] += len(reqs)
                self.metrics["engine_busy_s_total"] += time.monotonic() - t0
                for r in reqs:
                    if r.error:
                        r.events.put(("error", r.error))
                    r.events.put(None)
                    r.done.set()


_BREAKER_CACHE: dict = {}


def _breaker_ids(llm, breakers) -> tuple:
    """Map DRY sequence-breaker STRINGS (llama.cpp --dry-sequence-breaker)
    to the token ids whose decoded piece contains any of them — those
    tokens cut repetition matching. Cached per (tokenizer, breakers);
    capped at 256 ids to bound the jit-static config size."""
    if not breakers:
        return ()
    tok = llm.tokenizer
    if tok is None:
        return ()
    key = (id(tok), tuple(breakers))
    hit = _BREAKER_CACHE.get(key)
    if hit is not None:
        return hit
    pats = [str(b) for b in breakers if b]
    ids = []
    for tid in range(len(tok.tokens)):
        piece = tok.decode_token(tid).decode("utf-8", "replace")
        if any(p in piece for p in pats):
            ids.append(tid)
            if len(ids) >= 256:
                break
    out = tuple(ids)
    _BREAKER_CACHE[key] = out
    return out


def make_handler(worker: EngineWorker, slot_save_dir: str | None = None):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # quiet
            pass

        def _do_slot_op(self) -> None:
            """POST /slots/{id}?action=save|restore|erase (llama.cpp slot
            persistence). save/restore need the server started with a
            slot-save directory; filenames are basename-sanitized into it."""
            import os
            from urllib.parse import parse_qs, urlparse

            try:
                u = urlparse(self.path)
                slot = int(u.path.split("/")[2])
                action = (parse_qs(u.query).get("action") or [""])[0]
                if action not in ("save", "restore", "erase"):
                    raise ValueError(
                        "action must be save, restore, or erase")
                path = None
                if action != "erase":
                    if slot_save_dir is None:
                        raise ValueError(
                            "server started without --slot-save-path")
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    fn = os.path.basename(
                        str(payload.get("filename", f"slot{slot}.npz")))
                    path = os.path.join(slot_save_dir, fn)
            except (ValueError, IndexError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
                return
            req = _Request(None, 0, None, 0)
            req.slot_op = (action, slot, path)
            worker.submit(req)
            req.done.wait()
            if req.error:
                self._reply(400, {"error": req.error})
                return
            self._reply(200, req.result)

        def _reply(self, code: int, obj) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _do_embeddings(self) -> None:
            """OpenAI-style /v1/embeddings: {"input": str | [str] |
            [[ids]]} -> {"data": [{"embedding": [...], "index": i}]}."""
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("request body must be a JSON object")
                inp = payload.get("input")
                if inp is None:
                    raise ValueError("missing 'input'")
                single = isinstance(inp, str) or (
                    isinstance(inp, list) and inp
                    and isinstance(inp[0], int))
                inputs = [inp] if single else list(inp)
                if not inputs:
                    raise ValueError("'input' is empty")
            except ValueError as e:
                self._reply(400, {"error": str(e)})
                return
            req = _Request(inputs, 0, None, 0, embed=True)
            worker.submit(req)
            req.done.wait()
            if req.error:
                self._reply(500, {"error": req.error})
                return
            self._reply(200, {
                "object": "list",
                "data": [{"object": "embedding", "index": i,
                          "embedding": row.tolist()}
                         for i, row in enumerate(req.result)],
                "model": "gguf_tpu",
            })

        def _stream_reply(self, req: _Request, chat: bool = False,
                          legacy: bool = False) -> None:
            """Server-sent events: one `data: {...}` line per token delta,
            then `data: [DONE]`. Deltas carry raw token ids and the
            incrementally decoded text. Decoding is byte-level: each token's
            raw bytes feed an incremental UTF-8 decoder that holds back an
            incomplete multi-byte tail until the next chunk completes it —
            slicing decoded strings by prefix length instead would garble a
            character whose bytes span two chunks (its U+FFFD-prefix decode
            has a different length than the final character).
            Chat requests stream OpenAI chat-style `delta` objects."""
            import codecs

            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Connection", "close")
            self.end_headers()
            tok = worker.llm.tokenizer
            utf8 = codecs.getincrementaldecoder("utf-8")("replace")
            skip = set()
            if tok is not None:
                for tid in (getattr(tok, "bos_id", None),
                            getattr(tok, "eos_id", None)):
                    if tid is not None:
                        skip.add(int(tid))
            first_text = True
            while True:
                ev = req.events.get()
                if ev is None:
                    break
                if ev[0] == "error":
                    try:
                        self.wfile.write(
                            b"data: " + json.dumps({"error": ev[1]}).encode()
                            + b"\n\n")
                        self.wfile.flush()
                    except (BrokenPipeError, ConnectionResetError):
                        return
                    continue
                ids, finished = ev
                raw = b"".join(tok.decode_token(int(t)) for t in ids
                               if int(t) not in skip) if tok is not None else b""
                delta = utf8.decode(raw, final=bool(finished))
                if first_text and delta:
                    # SPM synthetic leading space (add_space_prefix), matching
                    # what full decode() strips from non-streamed .text
                    if getattr(tok, "add_space_prefix", False) and \
                            delta.startswith(" "):
                        delta = delta[1:]
                    first_text = False
                fin = "stop" if finished else None
                if legacy:   # llama.cpp /completion stream chunk shape
                    chunk = {"content": delta, "stop": bool(finished),
                             "tokens": ids}
                else:
                    choice = ({"delta": {"content": delta},
                               "token_ids": ids,
                               "finish_reason": fin} if chat else
                              {"text": delta, "token_ids": ids,
                               "finish_reason": fin})
                    chunk = {"object": "chat.completion.chunk" if chat
                             else "text_completion.chunk",
                             "choices": [choice]}
                try:
                    self.wfile.write(b"data: " + json.dumps(chunk).encode()
                                     + b"\n\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    return  # client hung up; engine finishes on its own
            if not legacy:   # llama.cpp clients JSON-parse every line
                try:
                    self.wfile.write(b"data: [DONE]\n\n")
                    self.wfile.flush()
                except (BrokenPipeError, ConnectionResetError):
                    pass

        def do_GET(self):
            if self.path == "/health":
                self._reply(200, {"status": "ok",
                                  "model": worker.llm.cfg.__dict__})
            elif self.path.split("?", 1)[0] == "/metrics":
                from urllib.parse import parse_qs, urlparse

                m = dict(worker.metrics)
                m["queue_depth"] = worker.queue.qsize()
                m["prefix_cache_hit_tokens_total"] = worker.llm.prefix_cache_hits
                q = parse_qs(urlparse(self.path).query)
                if q.get("format", [""])[0] == "json":
                    self._reply(200, m)
                    return
                # llama.cpp serves Prometheus text exposition by default
                lines = []
                for k, v in sorted(m.items()):
                    kind = ("counter" if k.endswith("_total") else "gauge")
                    lines.append(f"# TYPE gguf_tpu:{k} {kind}")
                    lines.append(f"gguf_tpu:{k} {v}")
                body = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif self.path == "/props":
                # llama.cpp server /props: static server properties
                llm = worker.llm
                tok = llm.tokenizer
                self._reply(200, {
                    "total_slots": llm.max_batch,
                    "model": "gguf_tpu",
                    "chat_template": llm.chat_template or "",
                    "bos_token": (tok.tokens[tok.bos_id]
                                  if tok is not None
                                  and tok.bos_id is not None else None),
                    "eos_token": (tok.tokens[tok.eos_id]
                                  if tok is not None else None),
                    "default_generation_settings": {
                        "n_ctx": llm.max_seq,
                        "params": SamplerConfig().__dict__,
                    },
                })
            elif self.path == "/slots":
                # llama.cpp server /slots: per-slot occupancy. Sessions own
                # pinned slots; everything else serves stateless batches.
                llm = worker.llm
                by_slot = {e["sess"].slot: (sid, e)
                           for sid, e in worker.sessions.items()}
                slots = []
                for i in range(llm.max_batch):
                    if i in by_slot:
                        sid, e = by_slot[i]
                        slots.append({"id": i, "is_processing": False,
                                      "session": sid,
                                      "n_past": e["sess"].cached})
                    else:
                        slots.append({"id": i, "is_processing": False,
                                      "session": None,
                                      "reserved": i in llm._reserved})
                self._reply(200, slots)
            elif self.path in ("/v1/models", "/models"):
                # OpenAI client handshake: one model, named for the config
                self._reply(200, {"object": "list", "data": [{
                    "id": "gguf_tpu", "object": "model",
                    "owned_by": "gguf_tpu",
                    # T5Config carries enc/dec layer counts, not n_layers
                    "meta": {"n_layers": getattr(
                                 worker.llm.cfg, "n_layers",
                                 getattr(worker.llm.cfg, "n_enc_layers", 0)
                                 + getattr(worker.llm.cfg,
                                           "n_dec_layers", 0)),
                             "dim": worker.llm.cfg.dim,
                             "vocab_size": worker.llm.cfg.vocab_size,
                             "max_seq": worker.llm.max_seq}}]})
            else:
                self._reply(404, {"error": "not found"})

        def _do_tokenize(self, detok: bool) -> None:
            """llama.cpp server /tokenize + /detokenize: {"content": str,
            "add_special": bool, "with_pieces": bool} -> {"tokens": [...]}
            and {"tokens": [ids]} -> {"content": str}. Runs on the handler
            thread — pure host work, never touches the engine."""
            tok = worker.llm.tokenizer
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("request body must be a JSON object")
                if tok is None:
                    raise ValueError("model file has no embedded tokenizer")
                if detok:
                    ids = payload.get("tokens")
                    if not isinstance(ids, list):
                        raise ValueError("missing 'tokens' list")
                    self._reply(200, {"content": tok.decode(
                        [int(t) for t in ids])})
                    return
                content = payload.get("content")
                if not isinstance(content, str):
                    raise ValueError("missing 'content' string")
                ids = tok.encode(content,
                                 add_bos=bool(payload.get("add_special",
                                                          False)))
                if payload.get("with_pieces"):
                    out = [{"id": int(t),
                            "piece": tok.decode_token(int(t)).decode(
                                "utf-8", "replace")} for t in ids]
                else:
                    out = [int(t) for t in ids]
                self._reply(200, {"tokens": out})
            except ValueError as e:
                self._reply(400, {"error": str(e)})

        def do_POST(self):
            if self.path.startswith("/slots/"):
                self._do_slot_op()
                return
            if self.path in ("/v1/rerank", "/rerank", "/v1/reranking"):
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    payload = json.loads(self.rfile.read(n) or b"{}")
                    query = payload["query"]
                    docs = payload["documents"]
                    if not isinstance(docs, list) or not docs:
                        raise ValueError("'documents' must be a non-empty "
                                         "list of strings")
                except (KeyError, ValueError, json.JSONDecodeError) as e:
                    self._reply(400, {"error": str(e)})
                    return
                req = _Request(None, 0, None, 0)
                req.rerank = (str(query), [str(d) for d in docs])
                worker.submit(req)
                req.done.wait()
                if req.error:
                    self._reply(400, {"error": req.error})
                    return
                top_n = payload.get("top_n")
                results = sorted(req.result,
                                 key=lambda x: -x["relevance_score"])
                if top_n:
                    results = results[:int(top_n)]
                self._reply(200, {"model": payload.get("model", "default"),
                                  "results": results})
                return
            if self.path in ("/v1/embeddings", "/embeddings"):
                self._do_embeddings()
                return
            if self.path in ("/tokenize", "/detokenize"):
                self._do_tokenize(detok=self.path == "/detokenize")
                return
            chat = self.path in ("/v1/chat/completions", "/chat/completions")
            infill = self.path == "/infill"
            # llama.cpp's native endpoint: same engine path, legacy
            # request/response shape ({"prompt", "n_predict"} ->
            # {"content", "stop", ...})
            legacy = self.path == "/completion"
            if not chat and not infill and not legacy and self.path not in (
                    "/v1/completions", "/completions"):
                self._reply(404, {"error": "not found"})
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(n) or b"{}")
                if not isinstance(payload, dict):
                    raise ValueError("request body must be a JSON object")
                if infill:
                    # llama.cpp /infill: FIM prompt from the vocabulary's
                    # control tokens; input_extra = repo-level chunks
                    prompt = worker.llm.build_infill_tokens(
                        str(payload.get("input_prefix", "")),
                        str(payload.get("input_suffix", "")),
                        extra=payload.get("input_extra"),
                        spm=bool(payload.get("spm_infill", False)))
                elif chat:
                    messages = payload.get("messages")
                    if not isinstance(messages, list) or not messages:
                        raise ValueError("missing 'messages' list")
                    has_parts = any(isinstance(m.get("content"), list)
                                    for m in messages
                                    if isinstance(m, dict))
                    if payload.get("session"):
                        if has_parts:
                            raise ValueError(
                                "content-part messages (images) are not "
                                "supported in 'session' mode")
                        # session requests carry the raw messages; the
                        # engine thread renders + diffs against its cache
                        prompt = messages
                    else:
                        try:
                            # token ids with template specials parsed to
                            # single control-token ids (no double BOS);
                            # image_url parts become embedding spans
                            prompt = (worker.llm.encode_chat_mm(
                                          messages,
                                          tools=payload.get("tools"))
                                      if has_parts
                                      else worker.llm.encode_chat(
                                          messages,
                                          tools=payload.get("tools")))
                        except ValueError:
                            raise
                        except Exception as e:  # jinja render errors
                            raise ValueError(f"chat template failed: {e}")
                else:
                    prompt = payload.get("prompt")
                if prompt is None:
                    raise ValueError("missing 'prompt' (string or token id list)")
                lb = payload.get("logit_bias") or {}
                if not isinstance(lb, dict):
                    raise ValueError("'logit_bias' must be a {token_id: bias} object")
                sampler = SamplerConfig(
                    temperature=float(payload.get("temperature", 0.8)),
                    top_k=int(payload.get("top_k", 0)),
                    top_p=float(payload.get("top_p", 1.0)),
                    min_p=float(payload.get("min_p", 0.0)),
                    typical_p=float(payload.get("typical_p", 1.0)),
                    repeat_penalty=float(payload.get("repeat_penalty", 1.0)),
                    penalty_last_n=int(payload.get("repeat_last_n", -1)),
                    presence_penalty=float(payload.get("presence_penalty", 0.0)),
                    frequency_penalty=float(payload.get("frequency_penalty", 0.0)),
                    logit_bias=tuple(sorted(
                        (int(k), float(v)) for k, v in lb.items())),
                    mirostat=int(payload.get("mirostat", 0) or 0),
                    mirostat_tau=float(payload.get("mirostat_tau", 5.0)),
                    mirostat_eta=float(payload.get("mirostat_eta", 0.1)),
                    xtc_probability=float(
                        payload.get("xtc_probability", 0.0)),
                    xtc_threshold=float(payload.get("xtc_threshold", 0.1)),
                    top_n_sigma=float(payload.get("top_n_sigma", 0.0)),
                    dry_multiplier=float(payload.get("dry_multiplier", 0.0)),
                    dry_base=float(payload.get("dry_base", 1.75)),
                    dry_allowed_length=int(
                        payload.get("dry_allowed_length", 2)),
                    dry_penalty_last_n=int(
                        payload.get("dry_penalty_last_n", -1)),
                    dry_sequence_breakers=_breaker_ids(
                        worker.llm,
                        payload.get("dry_sequence_breakers",
                                    ("\n", ":", "\"", "*")))
                    if float(payload.get("dry_multiplier", 0.0)) > 0.0
                    else (),
                )
                stop = payload.get("stop")
                if isinstance(stop, str):
                    stop = [stop]
                session = payload.get("session")
                if session is not None and not chat:
                    raise ValueError("'session' requires /v1/chat/completions")
                grammar = payload.get("grammar")
                rf = payload.get("response_format")
                if rf is not None and not grammar:
                    if not (isinstance(rf, dict)
                            and rf.get("type") in ("json_object", "json")):
                        raise ValueError(
                            "response_format supports {'type': 'json_object'}")
                    from .grammar import JSON_GBNF

                    grammar = JSON_GBNF
                if grammar is not None and session is not None:
                    raise ValueError("'grammar' is stateless-request only")
                if grammar is not None and (
                        sampler.uses_penalties or sampler.logit_bias):
                    raise ValueError(
                        "'grammar' does not compose with repetition "
                        "penalties or logit_bias")
                fim = worker.llm.fim if infill else {}
                n_choices = int(payload.get("n", 1) or 1)
                if not 1 <= n_choices <= worker.llm.max_batch:
                    raise ValueError(
                        f"'n' must be between 1 and max_batch "
                        f"({worker.llm.max_batch}) — one engine batch "
                        "holds all choices")
                if n_choices > 1 and (payload.get("stream") or session
                                      or infill):
                    raise ValueError(
                        "'n' > 1 is non-streaming stateless only")
                mt = int(payload.get("max_tokens",
                                     payload.get("n_predict", 64)))
                if mt <= 0:   # llama.cpp n_predict=-1: decode until EOS
                    mt = worker.llm.max_seq
                req = _Request(prompt, mt,
                               sampler, int(payload.get("seed", 0)), stop,
                               stream=bool(payload.get("stream", False)),
                               logprobs=int(payload.get("logprobs", 0) or 0),
                               session=str(session) if session else None,
                               grammar=grammar,
                               stop_ids=[fim[k] for k in ("eot", "pad")
                                         if k in fim] or None)
                req.fanout = n_choices
            except (ValueError, json.JSONDecodeError) as e:
                self._reply(400, {"error": str(e)})
                return
            worker.submit(req)
            if req.stream:
                self._stream_reply(req, chat=chat, legacy=legacy)
                return
            req.done.wait()
            if req.error:
                self._reply(500, {"error": req.error})
                return
            res = (req.result[0] if isinstance(req.result, list)
                   else req.result)
            if legacy:   # llama.cpp /completion response shape
                self._reply(200, {
                    "content": res.text,
                    "stop": True,
                    "stopped_eos": res.stop_reason == "eos",
                    "stopped_word": res.stop_reason == "stop",
                    "stopped_limit": res.stop_reason == "length",
                    "tokens_predicted": len(res.token_ids),
                    "tokens_evaluated": len(res.prompt_ids),
                    "model": "gguf_tpu",
                    "stats": res.stats,
                })
                return
            if infill:   # llama.cpp /infill response shape
                self._reply(200, {
                    "content": res.text,
                    "tokens_predicted": len(res.token_ids),
                    "tokens_evaluated": len(res.prompt_ids),
                    "stop": res.finished,
                    "stats": res.stats,
                })
                return
            rlist = (req.result if isinstance(req.result, list)
                     else [req.result])
            choices = []
            for i, rr in enumerate(rlist):
                fin = "length" if rr.stop_reason == "length" else "stop"
                choice = ({"message": {"role": "assistant",
                                       "content": rr.text},
                           "token_ids": rr.token_ids,
                           "finish_reason": fin}
                          if chat else
                          {"text": rr.text,
                           "token_ids": rr.token_ids,
                           "finish_reason": fin})
                choice["index"] = i
                if req.logprobs:
                    choice["logprobs"] = rr.logprobs
                choices.append(choice)
            self._reply(200, {
                "object": "chat.completion" if chat else "text_completion",
                "choices": choices,
                "usage": {
                    "prompt_tokens": len(res.prompt_ids),
                    "completion_tokens": sum(
                        len(rr.token_ids) for rr in rlist),
                },
                "stats": res.stats,  # micro-batch wall_s / tokens_per_s
            })

    return Handler


def make_server(llm: LLM, host: str = "0.0.0.0", port: int = 8000,
                slot_save_path: str | None = None) -> ThreadingHTTPServer:
    """The HTTP server over a loaded LLM, not yet serving; port 0 picks a
    free port (`server_address[1]`). Call `serve_forever()` to serve."""
    return ThreadingHTTPServer((host, port),
                               make_handler(EngineWorker(llm),
                                            slot_save_path))


def serve(model: str, host: str = "0.0.0.0", port: int = 8000,
          max_batch: int = 8, tp: int = 1, dp: int = 1, sp: int = 1,
          slot_save_path: str | None = None, mmproj: str | None = None,
          lora: str | None = None, lora_scale: float = 1.0):
    llm = LLM(model, max_batch=max_batch, tp=tp, dp=dp, sp=sp,
              mmproj=mmproj, lora=lora,
              lora_scale=lora_scale)  # generate() chunks decode

    httpd = make_server(llm, host, port, slot_save_path)
    print(f"serving {model} on {host}:{httpd.server_address[1]} "
          f"(max_batch={max_batch}, tp={tp}, dp={dp}, sp={sp})")
    httpd.serve_forever()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model")
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--tp", type=int, default=1)
    args = p.parse_args(argv)
    serve(args.model, args.host, args.port, args.max_batch, args.tp)


if __name__ == "__main__":
    main()
