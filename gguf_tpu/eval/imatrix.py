"""Importance-matrix (imatrix) calibration — llama.cpp-compatible.

llama.cpp's `imatrix` tool accumulates the mean squared input activation
per weight column over a calibration stream; `quantize --imatrix` then
minimizes the ACTIVATION-weighted reconstruction error instead of the
plain RMSE, which is where most of the low-bit (q2/q3/iq) quality comes
from. This module reproduces both halves for this stack:

- `collect_imatrix(path, token_ids)` runs the served forward with
  `collect_sq=True` (models/llama.py) and returns {tensor_name:
  (ncall, values)} keyed by the on-disk GGUF tensor names.
- `read_imatrix` / `write_imatrix` speak llama.cpp's binary imatrix
  format (n_entries, [len name ncall nval values...], last_call,
  input-filename), so calibration data moves freely between llama.cpp
  and this framework in either direction.

Weighted quantization consumes `values / ncall` as per-column weights
(quantize_to_soa / cli requantize --imatrix).
"""

from __future__ import annotations

import struct

import numpy as np

# forward() stat key -> the GGUF tensor names that share that input
_STAT_TENSORS = {
    "attn_qkv": ("attn_q.weight", "attn_k.weight", "attn_v.weight"),
    "attn_output": ("attn_output.weight",),
    "ffn_gate_up": ("ffn_gate.weight", "ffn_up.weight"),
    "ffn_down": ("ffn_down.weight",),
}


def collect_imatrix(path: str, token_ids, *, window: int = 512,
                    batch: int = 1) -> dict:
    """Run a calibration stream through the model and accumulate per-column
    squared activations for every quantized projection. Returns
    {gguf_tensor_name: (ncall, values f64 (in_dim,))} with in_dim matching
    the ON-DISK tensor (loader padding stripped — padded columns carry
    exact zeros and are dropped)."""
    import jax
    import jax.numpy as jnp

    from ..gguf import GGUFReader
    from ..models import MMOpts, forward, init_kv_cache, load_llama

    cfg, params = load_llama(path)
    with GGUFReader(path) as r:
        disk_dims = {name: ti.shape[-1] for name, ti in r.tensors.items()
                     if len(ti.shape) == 2}

    ids = np.asarray(token_ids, np.int64).reshape(-1)
    window = min(window, cfg.max_seq_len - 1)
    opts = MMOpts(precision="high")

    import functools

    @functools.partial(jax.jit, static_argnames=("t",))
    def step(params, toks, t):
        cache = init_kv_cache(cfg, toks.shape[0], t)
        _, _, stats = forward(params, cfg, toks,
                              jnp.zeros(toks.shape[0], jnp.int32), cache,
                              opts, collect_sq=True)
        return stats

    acc: dict = {}
    ncall = 0
    for lo in range(0, len(ids) - 1, window):
        chunk = ids[lo:lo + window]
        if len(chunk) < 8:
            continue
        toks = jnp.asarray(chunk[None, :], jnp.int32)
        stats = jax.device_get(step(params, toks, len(chunk)))
        ncall += 1
        for i, ls in enumerate(stats[:-1]):
            p = f"blk.{i}."
            for key, names in _STAT_TENSORS.items():
                if key not in ls:
                    continue
                for name in names:
                    full = p + name
                    if full not in disk_dims:
                        continue
                    v = np.asarray(ls[key], np.float64)[:disk_dims[full]]
                    if full in acc:
                        acc[full] += v
                    else:
                        acc[full] = v.copy()
        out_sq = np.asarray(stats[-1]["output"], np.float64)
        if "output.weight" in disk_dims:
            k = disk_dims["output.weight"]
            acc["output.weight"] = acc.get("output.weight", 0.0) + out_sq[:k]
    if ncall == 0:
        raise ValueError("calibration stream too short")
    return {name: (ncall, v) for name, v in acc.items()}


def write_imatrix(path: str, entries: dict, input_name: str = "") -> None:
    """entries: {tensor_name: (ncall, values)} -> llama.cpp imatrix file."""
    with open(path, "wb") as f:
        f.write(struct.pack("<i", len(entries)))
        last_call = 0
        for name, (ncall, values) in entries.items():
            nb = name.encode()
            f.write(struct.pack("<i", len(nb)))
            f.write(nb)
            f.write(struct.pack("<ii", int(ncall), len(values)))
            f.write(np.asarray(values, np.float32).tobytes())
            last_call = max(last_call, int(ncall))
        f.write(struct.pack("<i", last_call))
        ib = input_name.encode()
        f.write(struct.pack("<i", len(ib)))
        f.write(ib)


def read_imatrix(path: str) -> dict:
    """llama.cpp imatrix file -> {tensor_name: (ncall, values f32)}."""
    with open(path, "rb") as f:
        data = f.read()
    off = 0

    def take(fmt):
        nonlocal off
        size = struct.calcsize(fmt)
        vals = struct.unpack_from(fmt, data, off)
        off += size
        return vals if len(vals) > 1 else vals[0]

    n = take("<i")
    out = {}
    for _ in range(n):
        ln = take("<i")
        name = data[off:off + ln].decode()
        off += ln
        ncall, nval = take("<ii")
        values = np.frombuffer(data, np.float32, nval, off).copy()
        off += 4 * nval
        out[name] = (ncall, values)
    return out


def imatrix_weights(entries: dict, tensor_name: str,
                    k: int) -> np.ndarray | None:
    """Per-column quantization weights for a tensor, or None if the
    imatrix has no (usable) entry. Zero/negative columns are floored to
    the smallest positive weight (llama.cpp guards the same way)."""
    e = entries.get(tensor_name)
    if e is None:
        return None
    ncall, values = e
    v = np.asarray(values, np.float64)
    if v.size < k:
        return None
    v = v[:k] / max(ncall, 1)
    pos = v[v > 0]
    if pos.size == 0:
        return None
    return np.maximum(v, pos.min() * 1e-3).astype(np.float32)
