"""Pipeline parallelism: staggered decode over a pp (x tp) mesh.

Layer-sharding for models whose weights exceed one card's memory even after
tensor parallelism: stage s holds layers [s*L/pp, (s+1)*L/pp) — stacked into
single arrays with a leading pp axis so one P("pp", ...) spec shards them
(the same trick as the MoE expert stacks, quant/layouts.stack_experts).

Decode schedule — STAGGERED STEADY STATE, not GPipe: the batch splits into
pp microbatches, each resident at a different stage, each on its own token
index. Every tick every stage computes (no bubble):

  tick r, stage s  ->  microbatch (r - s) mod pp

- activations rotate one stage forward per tick (one `ppermute` ring,
  payload (B/pp, 1, dim) — tiny next to the weight stream);
- the last stage greedily samples its resident microbatch's next token and
  broadcasts it with a masked psum over "pp"; stage 0 consumes exactly that
  token on the next tick ((r+1) mod pp == resident mb of stage 0);
- per-microbatch positions advance only when the microbatch exits the last
  stage, so every stage inserts token k of a microbatch at the same cache
  row (KV caches are stage-local: stage s caches only its own layers).

Warm-up: for r < pp-1 later stages process zero activations; their cache
writes land at the same rows the first real pass overwrites (the insert is an
overwrite, ops/attention.py:kv_cache_insert), and the token
broadcast is gated on r >= pp-1, so the pipeline converges to exactly the
single-device decode. After warm-up one real token is emitted per tick
(each microbatch advances every pp ticks).

Why this shape: per tick each stage streams only ITS layer weights
for B/pp rows — at steady state the whole mesh streams each weight exactly
once per B-row token step, the same memory traffic as single-card decode, while
holding 1/pp of the model per card. Inter-stage traffic is O(B/pp * dim) per
tick. Composes with tp (stage-internal Megatron sharding, psum over
"tp" inside each stage).

Reference tie-in: the reference has no multi-device path at all
(SURVEY.md §5 lists distribution as absent); this module is part of the
serving stack built beyond it.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.config import LlamaConfig
from ..models.llama import (
    MMOpts, _norm, attention, embed, linear, mlp, moe_mlp,
)
from .tp import LAYER_KINDS, _leaf_specs, _qt_spec, local_cfg


def make_pp_mesh(pp: int, tp: int = 1, devices=None) -> Mesh:
    """pp x tp mesh: tp innermost (per-stage Megatron psums on the tightest
    ring), pp outermost (one ppermute hop per tick)."""
    devices = devices if devices is not None else jax.devices()
    assert len(devices) >= pp * tp, (len(devices), pp, tp)
    arr = np.asarray(devices[: pp * tp]).reshape(pp, tp)
    return Mesh(arr, ("pp", "tp"))


def stack_stages(params: dict, cfg: LlamaConfig, pp: int):
    """Group the layer list into pp equal stages and stack each in-stage
    layer slot across stages (leading pp axis on every leaf). Embedding,
    LM head and final norm are replicated (every stage embeds its resident
    microbatch; only the last stage's head output is used)."""
    n = cfg.n_layers
    assert n % pp == 0, f"n_layers ({n}) must divide pp ({pp})"
    l_loc = n // pp
    stacked = []
    for j in range(l_loc):
        group = [params["layers"][s * l_loc + j] for s in range(pp)]
        keys = set(group[0])
        assert all(set(g) == keys for g in group), (
            "stages must have structurally identical layers")
        stacked.append(jax.tree_util.tree_map(
            lambda *a: jnp.stack(a), *group))
    return {**params, "layers": stacked}


def pp_param_specs(params_pp: dict) -> dict:
    """PartitionSpecs: stage-stacked layer leaves get P("pp", <tp spec>);
    embedding/head/norms replicate over pp (head column-sharded over tp)."""
    def stage_spec(kind):
        if kind.startswith("ep_"):
            # MoE expert stacks under pp: experts stay stage-local (no ep
            # axis in a pp mesh) — leading (pp, E, ...) with E unsharded
            return P("pp", None, *_qt_spec(kind[3:]))
        return P("pp", *_qt_spec(kind))

    specs = {
        "token_embd": _leaf_specs(params_pp["token_embd"], "rep"),
        "output": _leaf_specs(params_pp["output"], "col"),
        "output_norm": P(),
        "layers": [
            {k: jax.tree_util.tree_map(
                lambda _: stage_spec(LAYER_KINDS[k]), layer[k])
             for k in layer}
            for layer in params_pp["layers"]
        ],
    }
    for extra in ("output_bias", "output_norm_bias"):   # phi2-family
        if extra in params_pp:
            specs[extra] = P()
    return specs


def shard_pp(params: dict, cfg: LlamaConfig, mesh: Mesh):
    """Stack stages + pad + device_put over the pp x tp mesh.
    Returns (params_pp, cfg)."""
    from ..models.loader import pad_ffn_for_tp

    pp, tp = mesh.shape["pp"], mesh.shape["tp"]
    assert cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0
    params, cfg = pad_ffn_for_tp(params, cfg, tp)
    params_pp = stack_stages(params, cfg, pp)
    specs = pp_param_specs(params_pp)
    sharded = jax.tree_util.tree_map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
        params_pp, specs, is_leaf=lambda x: isinstance(x, P))
    return sharded, cfg


def init_pp_cache(cfg: LlamaConfig, mesh: Mesh, batch: int, max_seq: int):
    """Stage-local KV caches: one per in-stage layer slot, leading pp axis
    (stage s's slice caches its own layers for ALL batch rows)."""
    pp, tp = mesh.shape["pp"], mesh.shape["tp"]
    l_loc = cfg.n_layers // pp
    shape = (pp, batch, cfg.n_kv_heads, max_seq, cfg.head_dim)
    spec = {
        "k": P("pp", None, "tp", None, None),
        "v": P("pp", None, "tp", None, None),
        "k_scale": P("pp", None, "tp", None),
        "v_scale": P("pp", None, "tp", None),
    }
    cache = [{
        "k": jnp.zeros(shape, jnp.int8),
        "v": jnp.zeros(shape, jnp.int8),
        "k_scale": jnp.zeros(shape[:-1], jnp.float32),
        "v_scale": jnp.zeros(shape[:-1], jnp.float32),
    } for _ in range(l_loc)]
    return jax.tree_util.tree_map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
        cache, [dict(spec) for _ in range(l_loc)],
        is_leaf=lambda x: isinstance(x, P))


def make_pp_decode(cfg: LlamaConfig, mesh: Mesh, opts: MMOpts = MMOpts()):
    """Build the jitted pipeline tick.

    tick(params_pp, x, tokens, pos, cache, r) ->
        (x, tokens, pos, cache, emitted)

    State (all device arrays):
      x      (pp, B/pp, 1, dim) bf16 — per-stage resident activation
      tokens (B,) int32 — last known token per row (stage 0 embeds its
             resident microbatch's rows each tick)
      pos    (B,) int32 — next cache position per row
      r      () int32 — global tick counter
      emitted (B,) int32 — the token broadcast this tick (-1 for rows whose
             microbatch was not at the last stage, or during warm-up)

    The caller loops ticks; rows still consuming a prompt can overwrite
    `tokens` between ticks (teacher forcing) — prefill then IS the same
    pipelined decode path.
    """
    pp, tp = mesh.shape["pp"], mesh.shape["tp"]
    cfg_l = local_cfg(cfg, tp)
    opts_l = opts._replace(axis_name="tp" if tp > 1 else None)

    def tick_local(params, x, tokens, pos, cache, r):
        s = jax.lax.axis_index("pp")
        x = x[0]                                   # (mbs, 1, dim) local
        b = tokens.shape[0]
        mbs = b // pp
        mb = (r - s) % pp
        rows = mb * mbs
        tok_mb = jax.lax.dynamic_slice_in_dim(tokens, rows, mbs)
        pos_mb = jax.lax.dynamic_slice_in_dim(pos, rows, mbs)

        # stage 0 embeds its resident microbatch; others use the rotated-in
        # activation (embed cost is negligible — no cond needed)
        emb = embed(params["token_embd"], tok_mb[:, None])
        if cfg.embed_scale != 1.0:
            emb = emb * jnp.bfloat16(cfg.embed_scale).astype(jnp.float32)
        x = jnp.where(s == 0, emb.astype(jnp.bfloat16), x)

        new_cache = []
        for j, layer in enumerate(params["layers"]):
            layer = jax.tree_util.tree_map(lambda a: a[0], layer)  # local
            cache_j = jax.tree_util.tree_map(lambda a: a[0], cache[j])
            cache_mb = jax.tree_util.tree_map(
                lambda a: jax.lax.dynamic_slice_in_dim(a, rows, mbs, axis=0),
                cache_j)
            h = _norm(x, layer, "attn_norm", cfg_l)
            attn_out, cache_mb = attention(layer, h, cfg_l, cache_mb,
                                           pos_mb, opts_l)
            if cfg.parallel_residual:
                # falcon-40b/gptneox blocks carry a SEPARATE mlp pre-norm;
                # phi2/command-r share the attn pre-norm (mirrors
                # models/llama.py parallel-residual handling)
                hm = (_norm(x, layer, "ffn_norm", cfg_l)
                      if "ffn_norm" in layer else h)
                x = x + attn_out + mlp(layer, hm, opts_l, cfg.act_fn)
            else:
                x = x + attn_out
                h = _norm(x, layer, "ffn_norm", cfg_l)
                x = x + (moe_mlp(layer, h, cfg_l, opts_l)
                         if "gate_inp" in layer
                         else mlp(layer, h, opts_l, cfg.act_fn))
            cache_j = jax.tree_util.tree_map(
                lambda a, u: jax.lax.dynamic_update_slice_in_dim(
                    a, u, rows, axis=0), cache_j, cache_mb)
            new_cache.append(jax.tree_util.tree_map(
                lambda a: a[None], cache_j))

        # head: only the last stage's result is consumed; the vocab GEMM is
        # the biggest weight stream, so skip it on other stages
        is_last = s == pp - 1

        def head(xx):
            h = _norm(xx, params, "output_norm", cfg)
            logits = linear(params["output"], h.reshape(mbs, -1), opts_l)
            if tp > 1:
                logits = jax.lax.all_gather(logits, "tp", axis=-1,
                                            tiled=True)
            return jnp.argmax(logits[:, :cfg.vocab_size], -1).astype(jnp.int32)

        new_tok = jax.lax.cond(
            is_last, head, lambda xx: jnp.zeros(mbs, jnp.int32), x)

        # broadcast the emitted token to every stage (masked psum): valid
        # only after warm-up (r >= pp-1), from the last stage
        valid = jnp.logical_and(is_last, r >= pp - 1)
        contrib = jnp.zeros(b, jnp.int32)
        contrib = jax.lax.dynamic_update_slice_in_dim(
            contrib, jnp.where(valid, new_tok + 1, 0), rows, axis=0)
        summed = jax.lax.psum(contrib, "pp")
        if tp > 1:   # tp replicas agree; normalize for exactness
            summed = jax.lax.pmax(summed, "tp")
        emitted = summed - 1                     # -1 where nothing emitted
        tokens = jnp.where(emitted >= 0, emitted, tokens)
        pos = jnp.where(emitted >= 0, pos + 1, pos)

        # rotate activations one stage forward
        x = jax.lax.ppermute(x, "pp", [(i, (i + 1) % pp) for i in range(pp)])
        return x[None], tokens, pos, new_cache, emitted

    cspec = [{
        "k": P("pp", None, "tp", None, None),
        "v": P("pp", None, "tp", None, None),
        "k_scale": P("pp", None, "tp", None),
        "v_scale": P("pp", None, "tp", None),
    } for _ in range(cfg.n_layers // pp)]

    def run(params_pp, x, tokens, pos, cache, r):
        return jax.shard_map(
            tick_local,
            mesh=mesh,
            in_specs=(pp_param_specs(params_pp), P("pp"), P(), P(), cspec,
                      P()),
            out_specs=(P("pp"), P(), P(), cspec, P()),
            check_vma=False,
        )(params_pp, x, tokens, pos, cache, r)

    return jax.jit(run, donate_argnums=(1, 4))


def pp_generate(params_pp, cfg: LlamaConfig, mesh: Mesh, prompts,
                max_new_tokens: int, max_seq: int,
                opts: MMOpts = MMOpts()):
    """Greedy pipelined generation (driver loop around make_pp_decode).

    prompts: list of B token lists (B % pp == 0). Prompt tokens are teacher-
    forced through the same pipeline (host overwrites `tokens` for rows
    still consuming their prompt between ticks). Returns (B, max_new_tokens)
    generated ids."""
    pp = mesh.shape["pp"]
    b = len(prompts)
    assert b % pp == 0, (b, pp)
    tick = make_pp_decode(cfg, mesh, opts)

    x = jnp.zeros((pp, b // pp, 1, cfg.dim), jnp.bfloat16)
    tokens = jnp.asarray([p[0] for p in prompts], jnp.int32)
    pos = jnp.zeros(b, jnp.int32)
    cache = init_pp_cache(cfg, mesh, b, max_seq)
    consumed = np.ones(b, np.int64)      # prompt tokens already fed
    out = [[] for _ in range(b)]

    total = pp - 1 + (max(len(p) for p in prompts) - 1 + max_new_tokens) * pp
    r = 0
    while any(len(o) < max_new_tokens for o in out) and r < total + pp:
        x, tokens, pos, cache, emitted = tick(
            params_pp, x, tokens, pos, cache, jnp.int32(r))
        em = np.asarray(emitted)
        # teacher-force rows still inside their prompt
        forced = np.full(b, -1, np.int64)
        for i in range(b):
            if em[i] >= 0:
                if consumed[i] < len(prompts[i]):
                    forced[i] = prompts[i][consumed[i]]
                    consumed[i] += 1
                elif len(out[i]) < max_new_tokens:
                    out[i].append(int(em[i]))
        if (forced >= 0).any():
            tokens = jnp.where(jnp.asarray(forced >= 0),
                               jnp.asarray(forced, jnp.int32), tokens)
        r += 1
    return out
