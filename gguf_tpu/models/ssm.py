"""Mamba selective-SSM mixer (llama.cpp arch "mamba").

Replaces a decoder block's attention+FFN with the Mamba-1 recipe
(llama.cpp build_mamba / HF MambaMixer semantics):

    x, z = split(in_proj(h))
    x    = silu(causal_depthwise_conv(x))          # kernel d_conv
    dt, B, C = split(x_proj(x))
    dt   = softplus(dt_proj(dt))
    state = state * exp(dt*A) + (dt*x) outer B     # per-channel SSM
    y    = (state . C) + D * x
    out  = out_proj(y * silu(z))

Device mapping: the projections are MMQ matmuls over (B*T, ·); the
recurrence carries (B, d_inner, d_state) f32 state through a
`lax.scan` over time (T static — decode is one step, prefill chunks
scan). The depthwise conv is d_conv fused multiply-adds over shifted
slices — no gather, no conv primitive. The per-layer "cache" is the
conv tail (B, d_conv-1, d_inner) plus the SSM state: recurrent state
replaces KV rows entirely, so context length costs no memory.

A slot's state resets when its prefill starts at position 0 (a reused
slot must not inherit the previous sequence's state — attention models
get this for free from the causal mask; recurrence must zero
explicitly).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .config import LlamaConfig


def mamba_block(layer, h, cfg: LlamaConfig, cache_l, pos, opts,
                t_real=None):
    """One Mamba mixer. h: (B, T, dim) normed input; pos: (B,) start
    positions (0 resets the recurrent state). Returns (out, new_cache).

    `t_real` (dynamic scalar): number of REAL timesteps — the engine
    pads prefill chunks to bucket sizes, and unlike attention (whose
    causal mask makes trailing pads invisible) a recurrence would run
    the pad steps through the state. Steps >= t_real are masked to
    identity updates (dt -> 0 so exp(dt*A) = 1 and dt*x*B = 0) and the
    conv tail is sliced at the last real input."""
    from .llama import linear

    b, t, d = h.shape
    di, ds = cfg.ssm_inner, cfg.ssm_state
    dr, dc = cfg.ssm_dt_rank, cfg.ssm_conv

    fresh = (pos == 0)[:, None, None]
    conv_st = jnp.where(fresh, 0.0, cache_l["conv"])   # (B, dc-1, di)
    ssm_st = jnp.where(fresh, 0.0, cache_l["ssm"])     # (B, di, ds)

    xz = linear(layer["ssm_in"], h.reshape(b * t, d), opts)
    xz = xz.astype(jnp.float32).reshape(b, t, 2 * di)
    x, z = xz[..., :di], xz[..., di:]

    # causal depthwise conv: dc shifted slices, one fma each
    full = jnp.concatenate([conv_st, x], axis=1)       # (B, dc-1+T, di)
    w = layer["conv_w"].astype(jnp.float32)            # (di, dc)
    conv = layer["conv_b"].astype(jnp.float32)[None, None, :]
    for j in range(dc):
        conv = conv + full[:, j:j + t, :] * w[None, None, :, j]
    if t_real is None:
        new_conv_st = full[:, t:, :]
    else:
        # tail = the last dc-1 REAL inputs: full rows [t_real, t_real+dc-1)
        new_conv_st = jax.lax.dynamic_slice_in_dim(
            full, jnp.asarray(t_real, jnp.int32), dc - 1, axis=1)
    x = jax.nn.silu(conv)

    dbc = linear(layer["ssm_x"], x.reshape(b * t, di), opts)
    if opts.axis_name:   # row-parallel ssm_x over sharded channels
        dbc = jax.lax.psum(dbc, opts.axis_name)
    dbc = dbc.astype(jnp.float32)
    dt_lo, B_, C_ = dbc[:, :dr], dbc[:, dr:dr + ds], dbc[:, dr + ds:]
    dt = linear(layer["dt_w"], dt_lo, opts).astype(jnp.float32)
    dt = jax.nn.softplus(dt + layer["dt_b"].astype(jnp.float32))
    dt = dt.reshape(b, t, di)
    if t_real is not None:
        # pad steps become identity state updates
        valid = jnp.arange(t) < jnp.asarray(t_real, jnp.int32)
        dt = dt * valid[None, :, None]
    B_ = B_.reshape(b, t, ds)
    C_ = C_.reshape(b, t, ds)

    A = -jnp.exp(layer["A_log"].astype(jnp.float32))   # (di, ds)
    D = layer["ssm_d"].astype(jnp.float32)

    def step(state, inp):
        xt, dtt, Bt, Ct = inp                          # (B,di) (B,di) (B,ds)
        dA = jnp.exp(dtt[:, :, None] * A[None])        # (B, di, ds)
        state = state * dA + (dtt * xt)[:, :, None] * Bt[:, None, :]
        y = jnp.einsum("bis,bs->bi", state, Ct)
        return state, y

    xs = (x.transpose(1, 0, 2), dt.transpose(1, 0, 2),
          B_.transpose(1, 0, 2), C_.transpose(1, 0, 2))
    if t == 1:   # decode: no scan machinery for a single step
        ssm_st, y = step(ssm_st, tuple(v[0] for v in xs))
        y = y[None]
    else:
        ssm_st, y = jax.lax.scan(step, ssm_st, xs)
    y = y.transpose(1, 0, 2) + D[None, None, :] * x    # (B, T, di)
    y = y * jax.nn.silu(z)

    out = linear(layer["ssm_out"], y.astype(h.dtype).reshape(b * t, di),
                 opts)
    if opts.axis_name:
        out = jax.lax.psum(out, opts.axis_name)
    return out.reshape(b, t, d), {"conv": new_conv_st, "ssm": ssm_st}


def init_ssm_cache(cfg: LlamaConfig, batch: int) -> list:
    """Per-layer recurrent state: conv tail + SSM state, all f32 zeros."""
    return [{
        "conv": jnp.zeros((batch, cfg.ssm_conv - 1, cfg.ssm_inner),
                          jnp.float32),
        "ssm": jnp.zeros((batch, cfg.ssm_inner, cfg.ssm_state),
                         jnp.float32),
    } for _ in range(cfg.n_layers)]
