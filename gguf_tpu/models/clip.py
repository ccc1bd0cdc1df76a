"""CLIP ViT vision encoder + LLaVA projector (llama.cpp mmproj GGUFs).

llama.cpp serves multimodal models from two files: the language GGUF and
an `mmproj` GGUF holding a CLIP vision tower (`v.*` tensors,
`clip.vision.*` metadata) plus a projector (`mm.*`) that maps vision
features into the LM's embedding space (clip.cpp / libmtmd lineage).
This module loads that schema and runs it on the device:

- patch embedding: the conv2d over non-overlapping P x P patches is an
  unfold + one (HW/P^2, 3P^2) x (3P^2, D) matmul — one GEMM, no conv
  primitive
- a pre-LN ViT stack (biased q/k/v/o + GELU MLP, LayerNorms with bias)
- llava MLP projector: drop the CLS row, mm.0 -> GELU -> mm.2

For LLaVA checkpoints llama.cpp's converter already drops the last ViT
block (the "-2 feature layer" selection happens at conversion), so
running every stored block is the correct semantics; the llava projector
path also skips the final post_ln, matching clip.cpp.

Image preprocessing follows CLIP: resize to `image_size` (bilinear),
scale to [0,1], normalize with clip.vision.image_mean/std.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


@dataclass(frozen=True)
class ClipVisionConfig:
    image_size: int
    patch_size: int
    dim: int            # hidden width of the vision tower
    n_layers: int
    n_heads: int
    ffn_dim: int
    norm_eps: float
    proj_dim: int       # LM embedding width the projector maps into
    image_mean: tuple
    image_std: tuple
    projector: str      # "mlp" (llava) | "linear" | "gemma3"
    proj_scale: int = 4  # gemma3: patch-grid pooling factor per side

    @property
    def n_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2

    @classmethod
    def from_gguf_metadata(cls, md: dict) -> "ClipVisionConfig":
        g = lambda k, d=None: md.get(f"clip.vision.{k}", d)
        return cls(
            image_size=int(g("image_size")),
            patch_size=int(g("patch_size")),
            dim=int(g("embedding_length")),
            n_layers=int(g("block_count")),
            n_heads=int(g("attention.head_count")),
            ffn_dim=int(g("feed_forward_length")),
            norm_eps=float(g("attention.layer_norm_epsilon", 1e-5) or 1e-5),
            proj_dim=int(g("projection_dim", 0) or 0),
            image_mean=tuple(float(x) for x in
                             g("image_mean", (0.48145466, 0.4578275,
                                              0.40821073))),
            image_std=tuple(float(x) for x in
                            g("image_std", (0.26862954, 0.26130258,
                                            0.27577711))),
            projector=str(md.get("clip.projector_type", "mlp")),
            proj_scale=int(md.get("clip.vision.projector.scale_factor", 4)
                           or 4),
        )


def load_clip(path: str):
    """Load an mmproj GGUF -> (ClipVisionConfig, params dict). Weights
    stay f32 jnp arrays (the vision tower is a tiny fraction of LM
    FLOPs; llama.cpp keeps mmproj f16/f32 too)."""
    from ..gguf import GGUFReader

    r = GGUFReader(path)
    cfg = ClipVisionConfig.from_gguf_metadata(r.metadata)
    t = lambda n: jnp.asarray(r.dequantize(n), jnp.float32)
    has = lambda n: n in r.tensors
    P, D = cfg.patch_size, cfg.dim
    patch = r.dequantize("v.patch_embd.weight")
    # GGUF stores the conv kernel (D, 3, P, P); flatten to a matmul
    # operand ordered [c*P*P] to match the unfold below
    patch = patch.reshape(D, 3 * P * P)
    params = {
        "patch": jnp.asarray(patch, jnp.float32),
        "patch_bias": t("v.patch_embd.bias")
        if has("v.patch_embd.bias") else None,   # SigLIP conv has a bias
        "class_embd": t("v.class_embd") if has("v.class_embd") else None,
        "pos": t("v.position_embd.weight"),
        "layers": [],
        "pre_ln": (t("v.pre_ln.weight"), t("v.pre_ln.bias"))
        if has("v.pre_ln.weight") else None,
        "post_ln": (t("v.post_ln.weight"), t("v.post_ln.bias"))
        if has("v.post_ln.weight") else None,
    }
    for i in range(cfg.n_layers):
        p = f"v.blk.{i}."
        params["layers"].append({
            k: (t(p + n + ".weight"), t(p + n + ".bias"))
            for k, n in (("ln1", "ln1"), ("ln2", "ln2"),
                         ("q", "attn_q"), ("k", "attn_k"),
                         ("v", "attn_v"), ("o", "attn_out"),
                         ("up", "ffn_up"), ("down", "ffn_down"))
        })
    proj = {}
    for i in (0, 1, 2, 3):
        if has(f"mm.{i}.weight"):
            proj[i] = (t(f"mm.{i}.weight"), t(f"mm.{i}.bias"))
    params["proj"] = proj
    # gemma3 (SigLIP tower): RMS-normed 4x4-pooled soft embeddings
    if has("mm.input_projection.weight"):
        params["g3_proj"] = t("mm.input_projection.weight")
        params["g3_norm"] = t("mm.soft_emb_norm.weight")
    r.close()
    return cfg, params


def preprocess_image(img, cfg: ClipVisionConfig) -> np.ndarray:
    """HxWx3 uint8/float array (or PIL Image) -> (S, S, 3) f32,
    CLIP-normalized. Bilinear resize, no aspect crop (llava-1.5's
    'square' mode)."""
    try:
        from PIL import Image

        if isinstance(img, Image.Image):
            img = np.asarray(img.convert("RGB"))
    except ImportError:
        pass
    img = np.asarray(img)
    if img.dtype == np.uint8:
        img = img.astype(np.float32) / 255.0
    img = img.astype(np.float32)
    S = cfg.image_size
    h, w = img.shape[:2]
    if (h, w) != (S, S):
        ys = (np.arange(S) + 0.5) * h / S - 0.5
        xs = (np.arange(S) + 0.5) * w / S - 0.5
        y0 = np.clip(np.floor(ys).astype(int), 0, h - 1)
        x0 = np.clip(np.floor(xs).astype(int), 0, w - 1)
        y1, x1 = np.minimum(y0 + 1, h - 1), np.minimum(x0 + 1, w - 1)
        fy = np.clip(ys - y0, 0, 1)[:, None, None]
        fx = np.clip(xs - x0, 0, 1)[None, :, None]
        img = ((img[y0][:, x0] * (1 - fy) + img[y1][:, x0] * fy) * (1 - fx)
               + (img[y0][:, x1] * (1 - fy) + img[y1][:, x1] * fy) * fx)
    mean = np.asarray(cfg.image_mean, np.float32)
    std = np.asarray(cfg.image_std, np.float32)
    return (img - mean) / std


from .bert import _ln  # shared (weight, bias)-tuple LayerNorm adapter


def encode_image(params, cfg: ClipVisionConfig, pixels) -> jax.Array:
    """(S, S, 3) or (B, S, S, 3) normalized pixels -> projected image
    embeddings (B, n_patches, proj_dim) ready to splice into the LM
    prompt."""
    x = jnp.asarray(pixels, jnp.float32)
    if x.ndim == 3:
        x = x[None]
    b = x.shape[0]
    P, D = cfg.patch_size, cfg.dim
    g = cfg.image_size // P
    # unfold into patches, channel-major within each patch to match the
    # (D, 3*P*P) conv kernel flatten: [c, py, px]
    x = x.reshape(b, g, P, g, P, 3).transpose(0, 1, 3, 5, 2, 4)
    x = x.reshape(b, g * g, 3 * P * P)
    x = x @ params["patch"].T                       # (B, N, D)
    if params.get("patch_bias") is not None:
        x = x + params["patch_bias"]
    if params["class_embd"] is not None:
        cls = jnp.broadcast_to(params["class_embd"], (b, 1, D))
        x = jnp.concatenate([cls, x], axis=1)
    x = x + params["pos"][None, :x.shape[1], :]
    if params["pre_ln"] is not None:
        x = _ln(x, params["pre_ln"], cfg.norm_eps)

    h, hd = cfg.n_heads, D // cfg.n_heads
    for lyr in params["layers"]:
        r = _ln(x, lyr["ln1"], cfg.norm_eps)
        q = (r @ lyr["q"][0].T + lyr["q"][1]).reshape(b, -1, h, hd)
        k = (r @ lyr["k"][0].T + lyr["k"][1]).reshape(b, -1, h, hd)
        v = (r @ lyr["v"][0].T + lyr["v"][1]).reshape(b, -1, h, hd)
        sc = jnp.einsum("bqhd,bkhd->bhqk", q, k) / jnp.sqrt(float(hd))
        pr = jax.nn.softmax(sc, axis=-1)
        att = jnp.einsum("bhqk,bkhd->bqhd", pr, v).reshape(b, -1, D)
        x = x + (att @ lyr["o"][0].T + lyr["o"][1])
        r = _ln(x, lyr["ln2"], cfg.norm_eps)
        r = r @ lyr["up"][0].T + lyr["up"][1]
        r = jax.nn.gelu(r, approximate=False)
        x = x + (r @ lyr["down"][0].T + lyr["down"][1])

    proj = params["proj"]
    if cfg.projector == "gemma3":
        # SigLIP tower (no CLS): post_ln, then average-pool the patch
        # grid 4x4 (64x64 -> 16x16 soft tokens for gemma3-4b+), RMS-norm
        # with soft_emb_norm, and project into the LM space
        # (llama.cpp clip.cpp PROJECTOR_TYPE_GEMMA3)
        if params["post_ln"] is not None:
            x = _ln(x, params["post_ln"], cfg.norm_eps)
        n = x.shape[1]
        side = int(round(float(np.sqrt(n))))
        pool = cfg.proj_scale if side % cfg.proj_scale == 0 else 1
        gs = side // pool
        x = x.reshape(b, gs, pool, gs, pool, D)
        x = x.mean(axis=(2, 4)).reshape(b, gs * gs, D)
        var = jnp.mean(x * x, axis=-1, keepdims=True)
        x = x * jax.lax.rsqrt(var + cfg.norm_eps) * params["g3_norm"]
        return x @ params["g3_proj"].T \
            if params["g3_proj"].shape[-1] == D else x @ params["g3_proj"]
    if cfg.projector == "mlp" and 0 in proj and 2 in proj:
        # llava: patch rows only (drop CLS), no post_ln, 2-layer MLP
        if params["class_embd"] is not None:
            x = x[:, 1:]
        x = x @ proj[0][0].T + proj[0][1]
        x = jax.nn.gelu(x, approximate=False)
        x = x @ proj[2][0].T + proj[2][1]
        return x
    if params["post_ln"] is not None:
        x = _ln(x, params["post_ln"], cfg.norm_eps)
    if 0 in proj:   # linear projector
        if params["class_embd"] is not None:
            x = x[:, 1:]
        x = x @ proj[0][0].T + proj[0][1]
    return x


def write_random_mmproj(path: str, cfg: ClipVisionConfig,
                        seed: int = 0) -> None:
    """Random llama.cpp-schema mmproj GGUF (tests)."""
    from ..gguf import GGMLType
    from ..gguf.writer import write_gguf

    rng = np.random.default_rng(seed)
    D, P, F = cfg.dim, cfg.patch_size, cfg.ffn_dim
    s = 0.5 / np.sqrt(D)
    w = lambda *sh: (rng.standard_normal(sh) * s).astype(np.float32)
    nrm = lambda n: (1 + 0.1 * rng.standard_normal(n)).astype(np.float32)
    f32 = lambda arr: (GGMLType.F32, arr.shape, arr)
    n_pos = cfg.n_patches + 1
    tensors = {
        "v.patch_embd.weight": f32(w(D, 3, P, P) * 2),
        "v.class_embd": f32(w(D)),
        "v.position_embd.weight": f32(w(n_pos, D)),
        "v.pre_ln.weight": f32(nrm(D)),
        "v.pre_ln.bias": f32(w(D)),
        "mm.0.weight": f32(w(cfg.proj_dim, D)),
        "mm.0.bias": f32(w(cfg.proj_dim)),
        "mm.2.weight": f32(w(cfg.proj_dim, cfg.proj_dim)),
        "mm.2.bias": f32(w(cfg.proj_dim)),
    }
    for i in range(cfg.n_layers):
        p = f"v.blk.{i}."
        for name, shape in (("attn_q", (D, D)), ("attn_k", (D, D)),
                            ("attn_v", (D, D)), ("attn_out", (D, D)),
                            ("ffn_up", (F, D)), ("ffn_down", (D, F))):
            tensors[p + name + ".weight"] = f32(w(*shape))
            tensors[p + name + ".bias"] = f32(w(shape[0]))
        for name in ("ln1", "ln2"):
            tensors[p + name + ".weight"] = f32(nrm(D))
            tensors[p + name + ".bias"] = f32(w(D))
    md = {
        "general.architecture": "clip",
        "clip.projector_type": cfg.projector,
        "clip.vision.image_size": cfg.image_size,
        "clip.vision.patch_size": cfg.patch_size,
        "clip.vision.embedding_length": cfg.dim,
        "clip.vision.block_count": cfg.n_layers,
        "clip.vision.attention.head_count": cfg.n_heads,
        "clip.vision.feed_forward_length": cfg.ffn_dim,
        "clip.vision.attention.layer_norm_epsilon": cfg.norm_eps,
        "clip.vision.projection_dim": cfg.proj_dim,
        "clip.vision.image_mean": list(cfg.image_mean),
        "clip.vision.image_std": list(cfg.image_std),
    }
    write_gguf(path, md, tensors)
