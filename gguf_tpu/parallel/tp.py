"""Tensor parallelism for the llama decoder: shard_map over a device mesh.

Megatron-style sharding, block-aligned for the GGUF superblock layout
(SURVEY.md §7 "block-aligned multi-host sharding"):

  column-parallel (output dim M sharded):  wq, wk, wv, gate, up, output head
  row-parallel   (input dim K sharded):    wo, down  (+psum of partials)
  replicated:                              norms, token embedding

In the K-major SoA layout every QuantTensor array carries M on its LAST axis
and K-blocks on its FIRST axis, so column-parallel is uniformly
P(None, "tp") and row-parallel P("tp", None) for every field — no per-field
case analysis. K shards land on superblock boundaries by construction
because the FFN dimension is zero-padded to a multiple of 256*tp at shard
time (zero superblocks dequantize to zero and contribute nothing, so the
result is exact).

Pallas kernels don't partition under GSPMD, so the whole forward runs inside
shard_map — each device executes the same program on its local weight shard
and the only cross-device traffic is one psum after each row-parallel
projection plus the final logits all-gather (NCCL over NVLink).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.config import LlamaConfig
from ..models.llama import MMOpts, forward
from ..quant.layouts import QuantTensor

COL = "col"   # shard M (output features)
ROW = "row"   # shard K (input features / superblocks)
REP = "rep"


def make_mesh(tp: int, dp: int = 1, sp: int = 1, ep: int = 1,
              devices=None) -> Mesh:
    """dp x sp x ep x tp device mesh. tp innermost (one psum per
    row-parallel projection every layer); ep (expert parallelism,
    one psum per MoE layer, folded into the tp psum) next; sp
    (sequence/context parallelism, one small LSE-combine per attention)
    above; dp outermost (no collectives at all). Every axis always exists so
    the same jitted program serves meshes with any of them at size 1."""
    devices = devices if devices is not None else jax.devices()
    assert len(devices) >= tp * dp * sp * ep, (len(devices), tp, dp, sp, ep)
    arr = np.asarray(devices[: tp * dp * sp * ep]).reshape(dp, sp, ep, tp)
    return Mesh(arr, ("dp", "sp", "ep", "tp"))


def _qt_spec(kind: str) -> P:
    return {COL: P(None, "tp"), ROW: P("tp", None), REP: P(),
            "col1d": P("tp"),
            # stacked MoE expert tensors: leading E dim over ep, then the
            # usual K-major SoA col/row sharding per expert
            "ep_col": P("ep", None, "tp"), "ep_row": P("ep", "tp", None),
            # deepseek2 MLA absorption matrices (H, d, r): heads over tp
            "heads0": P("tp", None, None),
            # mamba per-channel tensors (channels, ...): shard channels
            "ch0": P("tp", None)}[kind]


def _leaf_specs(tree, kind: str):
    """A pytree of PartitionSpecs matching `tree` (QuantTensor or array).

    QuantTensor SoA arrays are K-major (K-blocks first, M on the last
    axis); plain float matmul weights are (M, K) — so COL/ROW invert
    between the two layouts."""
    if isinstance(tree, QuantTensor):
        return jax.tree_util.tree_map(lambda _: _qt_spec(kind), tree)
    if kind == COL and getattr(tree, "ndim", 0) == 2:
        return P("tp", None)
    if kind == ROW and getattr(tree, "ndim", 0) == 2:
        return P(None, "tp")
    return _qt_spec(kind)


LAYER_KINDS = {
    "attn_norm": REP, "ffn_norm": REP,
    # qwen3-family per-head q/k norms: (head_dim,), same for every head
    "q_norm": REP, "k_norm": REP,
    # olmo2 whole-projection-vector q/k norms: sharded with the head
    # columns (the global mean square psums in _rms_norm_global)
    "q_norm_full": "col1d", "k_norm_full": "col1d",
    # gemma2-family post-branch norms: (dim,), replicated like attn_norm
    "post_attn_norm": REP, "post_ffn_norm": REP,
    "wq": COL, "wk": COL, "wv": COL, "wo": ROW,
    "gate": COL, "up": COL, "down": ROW,
    # fused projections (fuse_llama_params(tp=...) interleaves per-shard,
    # so a plain column shard hands each device contiguous local q/k/v)
    "wqkv": COL, "gate_up": COL,
    # qwen2-family QKV bias vectors: 1-D, sharded with their projections
    "bq": "col1d", "bk": "col1d", "bv": "col1d", "bqkv": "col1d",
    # phi2-family biases: bup rides the column-parallel up projection;
    # bo/bdown apply AFTER the row-parallel psum -> replicated, as are the
    # LayerNorm biases
    "bup": "col1d", "bo": REP, "bdown": REP,
    "attn_norm_bias": REP, "ffn_norm_bias": REP,
    # mixtral-family MoE: replicated router + ep-sharded expert stacks
    # (quantized SoA stacks only — see shard_llama's assert)
    "gate_inp": REP, "gate_exps": "ep_col", "up_exps": "ep_col",
    "down_exps": "ep_row",
    # deepseek2 MLA: the low-rank down-projections and the shared latent
    # path are tiny and replicated; per-head tensors shard over heads
    # (wq_b/wq columns, absorption matrices on their leading H axis).
    # The latent KV cache itself is REPLICATED over tp (see cache_specs
    # head_axis=None) — one (kv_lora + rope) row per token is ~9x smaller
    # than the per-head K/V it replaces, so replication costs less HBM
    # than a sharded naive-MLA cache.
    "wq_a": REP, "q_a_norm": REP, "wq_b": COL,
    "wkv_a": REP, "kv_a_norm": REP,
    "w_uk": "heads0", "w_uv": "heads0",
    # deepseek2 MoE extras: shared experts are a dense FFN (col/row),
    # the V3 selection bias rides the replicated router
    "gate_shexp": COL, "up_shexp": COL, "down_shexp": ROW,
    "gate_inp_b": REP, "gate_inp_shexp": REP,
    # mamba selective-SSM mixer (Megatron over the inner channel dim):
    # ssm_in column-parallel with per-shard-interleaved [x; z] halves
    # (_interleave_mamba_in), per-channel tensors (conv, A, D, dt bias)
    # sharded with their channels, ssm_x/ssm_out row-parallel (one psum
    # each per layer), dt_w column-parallel back to local channels
    "ssm_in": COL, "ssm_x": ROW, "dt_w": COL, "ssm_out": ROW,
    "conv_w": "ch0", "A_log": "ch0",
    "conv_b": "col1d", "dt_b": "col1d", "ssm_d": "col1d",
}


# FFN padding lives in models.loader (shared with the single-chip load
# path, which pads to plain 256-multiples for tile-aligned kernels)
from ..models.loader import _pad_cols_to, _pad_k_to, pad_ffn_for_tp  # noqa: F401,E402


def param_specs(params: dict) -> dict:
    """PartitionSpec pytree for a llama params pytree."""
    specs = {
        "token_embd": _leaf_specs(params["token_embd"], REP),
        "output": _leaf_specs(params["output"], COL),
        "output_norm": P(),
        "layers": [
            {k: _leaf_specs(layer[k], LAYER_KINDS[k]) for k in layer}
            for layer in params["layers"]
        ],
    }
    # phi2-family top-level extras: biases apply after the vocab
    # all-gather / the final norm -> replicated
    for extra in ("output_bias", "output_norm_bias"):
        if extra in params:
            specs[extra] = P()
    return specs


def cache_specs(n_layers: int, batch_axis: str | None = "dp",
                seq_axis: str | None = None,
                head_axis: str | None = "tp",
                mamba: bool = False) -> list:
    """KV cache sharding: kv heads over `head_axis` (None for MLA's
    single shared latent row, which replicates over tp), batch over
    `batch_axis`, and — for context parallelism — the sequence dim
    contiguously over `seq_axis` (a list of per-layer spec dicts,
    matching models.llama.init_kv_cache). batch_axis=None replicates the
    batch dim — used for single-request prefill, whose batch of 1 cannot
    shard over dp."""
    if mamba:   # recurrent state: conv tail (B, dc-1, di), ssm (B, di, ds)
        assert seq_axis is None, "mamba recurrence cannot sequence-shard"
        layer = {
            "conv": P(batch_axis, None, head_axis),
            "ssm": P(batch_axis, head_axis, None),
        }
        return [dict(layer) for _ in range(n_layers)]
    layer = {
        "k": P(batch_axis, head_axis, seq_axis, None),
        "v": P(batch_axis, head_axis, seq_axis, None),
        "k_scale": P(batch_axis, head_axis, seq_axis),
        "v_scale": P(batch_axis, head_axis, seq_axis),
    }
    return [dict(layer) for _ in range(n_layers)]


def shard_llama(params: dict, cfg: LlamaConfig, mesh: Mesh,
                fuse: bool = True):
    """Pad + device_put the params across the mesh. Returns (params, cfg).
    fuse=True applies the interleaved QKV / gate+up fusion so the sharded
    path gets the same one-launch projections as single-chip serving."""
    from ..models.llama import fuse_llama_params

    tp = mesh.shape["tp"]
    if cfg.ssm_inner:
        # mamba: conv/ssm state shards over batch (dp) and the inner
        # channel dim (tp); sequence parallelism is meaningless for a
        # recurrence
        assert mesh.shape.get("sp", 1) == 1, (
            "mamba recurrence cannot sequence-shard (sp must be 1)")
        assert cfg.ssm_inner % (256 * tp) == 0, (
            f"row-parallel ssm_x/ssm_out need ssm_inner ({cfg.ssm_inner}) "
            f"% 256*tp ({256 * tp}) == 0")
        if tp > 1:
            params = _interleave_mamba_in(params, cfg, tp)
        specs = param_specs(params)
        sharded = jax.tree_util.tree_map(
            lambda a, sp_: jax.device_put(a, NamedSharding(mesh, sp_)),
            params, specs, is_leaf=lambda x: isinstance(x, P))
        return sharded, cfg
    ep = mesh.shape.get("ep", 1)
    assert cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0, (
        f"heads ({cfg.n_heads}/{cfg.n_kv_heads}) must divide tp={tp}")
    assert cfg.dim % (256 * tp) == 0, (
        f"row-parallel wo needs dim ({cfg.dim}) % 256*tp ({256 * tp}) == 0")
    if ep > 1:
        assert cfg.n_experts and cfg.n_experts % ep == 0, (
            f"ep={ep} needs an MoE model with expert_count % ep == 0 "
            f"(got {cfg.n_experts})")
        from ..quant.layouts import QuantTensor
        assert all(isinstance(params["layers"][0].get(k), QuantTensor)
                   for k in ("gate_exps", "up_exps", "down_exps")), (
            "ep sharding expects quantized (SoA) expert stacks")
    params, cfg = pad_ffn_for_tp(params, cfg, tp)
    if fuse:
        params = fuse_llama_params(params, tp=tp)
    params = _unplane_row_sharded(params, tp)
    specs = param_specs(params)
    sharded = jax.tree_util.tree_map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)), params, specs,
        is_leaf=lambda x: isinstance(x, P))
    return sharded, cfg


def _unplane_row_sharded(params: dict, tp: int) -> dict:
    """q8_0 plane tensors are only K-shardable at 256-row plane-group
    granularity; a ROW-kind weight whose K/tp is not a 256-multiple (e.g.
    MLA wo with K = n_heads*v_head_dim = 256 at tp=2) is repacked to
    element order before sharding (quant/layouts.py q8_0_unplane)."""
    from ..quant.layouts import QuantTensor, q8_0_unplane

    if tp <= 1:
        return params

    def fix(t, kind):
        if (kind == ROW and isinstance(t, QuantTensor) and t.fmt == "q8_0"
                and t.q8_plane
                and (t.qs.shape[-2] // tp) % 256 != 0):
            return q8_0_unplane(t)
        return t

    layers = [{k: fix(v, LAYER_KINDS.get(k, REP)) for k, v in layer.items()}
              for layer in params["layers"]]
    return {**params, "layers": layers}


def _interleave_mamba_in(params: dict, cfg: LlamaConfig, tp: int) -> dict:
    """Reorder ssm_in's output columns [x(di); z(di)] to per-shard
    interleave [x_0 z_0 | x_1 z_1 | ...] so a plain P(None, "tp") column
    shard hands each device a locally contiguous [x_loc; z_loc] and the
    in-block split at the LOCAL di stays correct (the mamba analog of
    fuse_llama_params' tp interleave)."""
    di = cfg.ssm_inner
    dloc = di // tp
    ids = np.concatenate([
        np.r_[s * dloc:(s + 1) * dloc, di + s * dloc:di + (s + 1) * dloc]
        for s in range(tp)])
    layers = []
    for layer in params["layers"]:
        layer = dict(layer)
        layer["ssm_in"] = jax.tree_util.tree_map(
            lambda a: a[:, ids], layer["ssm_in"])
        layers.append(layer)
    return {**params, "layers": layers}


def local_cfg(cfg: LlamaConfig, tp: int) -> LlamaConfig:
    """The per-device view of the model inside shard_map."""
    return dataclasses.replace(
        cfg,
        n_heads=cfg.n_heads // tp,
        n_kv_heads=cfg.n_kv_heads // tp,
        head_dim_override=cfg.head_dim if cfg.n_heads else None,
        ssm_inner=cfg.ssm_inner // tp if cfg.ssm_inner else 0,
    )


def tp_forward_fn(cfg: LlamaConfig, mesh: Mesh, opts: MMOpts = MMOpts()):
    """The UNjitted shard_map forward: fn(params, tokens, pos, cache) ->
    (logits, cache). Composable inside larger jitted programs (the serving
    engine embeds it in its prefill/decode steps); jit it or use
    make_tp_forward for standalone stepping."""
    tp = mesh.shape["tp"]
    sp = mesh.shape.get("sp", 1)
    ep = mesh.shape.get("ep", 1)
    seq_axis = "sp" if sp > 1 else None
    cfg_local = local_cfg(cfg, tp)
    opts_tp = opts._replace(axis_name="tp", seq_axis=seq_axis,
                            ep_axis="ep" if ep > 1 else None)

    def wrapped(params, tokens, pos, cache, span=None, batch_axis="dp"):
        """batch_axis: "dp" shards the batch over the dp mesh axis (the
        decode steady state); None replicates it — every dp group runs the
        same program, which is how a single-request prefill executes on a
        dp>1 mesh (redundant but correct; tp still splits the weights).
        On an sp>1 mesh the cache's sequence dim is additionally sharded
        over sp; span bounding is per-shard (see llama._cp_attention)."""
        def fn(params, tokens, pos, cache):
            return forward(params, cfg_local, tokens, pos, cache, opts_tp,
                           span=None if seq_axis else span)

        cspecs = cache_specs(cfg.n_layers, batch_axis, seq_axis,
                             head_axis=None if cfg.kv_lora_rank else "tp",
                             mamba=bool(cfg.ssm_inner))
        return jax.shard_map(
            fn,
            mesh=mesh,
            in_specs=(param_specs(params), P(batch_axis), P(batch_axis),
                      cspecs),
            out_specs=(P(batch_axis), cspecs),
            check_vma=False,
        )(params, tokens, pos, cache)

    return wrapped


def make_tp_forward(cfg: LlamaConfig, mesh: Mesh, opts: MMOpts = MMOpts()):
    """Build the jitted sharded forward: fn(params, tokens, pos, cache) ->
    (logits, cache). Call with params from shard_llama and a cache made by
    init_sharded_cache."""
    return jax.jit(tp_forward_fn(cfg, mesh, opts),
                   static_argnames=("span", "batch_axis"))


def init_sharded_cache(cfg: LlamaConfig, mesh: Mesh, batch: int, max_seq: int):
    from ..models.llama import init_kv_cache

    sp = mesh.shape.get("sp", 1)
    assert max_seq % sp == 0, (
        f"sp={sp} must divide max_seq ({max_seq}) into equal shards")
    cache = init_kv_cache(cfg, batch, max_seq)
    return jax.tree_util.tree_map(
        lambda a, s: jax.device_put(a, NamedSharding(mesh, s)),
        cache, cache_specs(cfg.n_layers, seq_axis="sp" if sp > 1 else None,
                           head_axis=None if cfg.kv_lora_rank else "tp",
                           mamba=bool(cfg.ssm_inner)),
        is_leaf=lambda x: isinstance(x, P))
