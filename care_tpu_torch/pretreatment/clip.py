"""CLIP image and text towers (pretreatment as batched inference, and the
in-model ``clip~ViT-B/32`` backbone).

Port of ``care_tpu/pretreatment/clip.py`` (reference
``pretreatment/clip_feats.py`` and ``clip_text_embs.py``): the ViT visual
tower, the CLIP text transformer, and a converter for OpenAI CLIP torch
state dicts (local files only; nothing is downloaded).

The modules keep the flax tree's names so that ``models/weights.py``
carries ``care_tpu``'s parameters in: each ``ResidualAttentionBlock``'s
``attn`` holds flax ``SelfAttention``'s ``query`` / ``key`` / ``value``
kernels as ``[width, heads, head_dim]`` with ``[heads, head_dim]`` biases
and ``out`` as ``[heads, head_dim, width]``; ``conv1`` is a bias-free
``Conv2d`` (torch's [out, in, kh, kw], flax's NHWC kernel relaid). Every
LayerNorm takes flax's default epsilon, 1e-6, as ``care_tpu`` does
(OpenAI's CLIP uses 1e-5). The vision tower takes NHWC normalized images
and its positional table fixes ``image_size``.
"""

import math
from typing import Dict

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from care_tpu_torch.models.common import (Dense, LayerNorm, encode_in_chunks,
                                          flax_init_, lecun_normal_)

LN_EPS = 1e-6


def _normal_param(shape, std: float, generator: torch.Generator):
    return nn.Parameter(torch.randn(shape, generator=generator) * std)


class QuickGELU(nn.Module):
    def forward(self, x):
        return x * torch.sigmoid(1.702 * x)


class _Projection(nn.Module):
    """One flax ``DenseGeneral`` of the attention, its kernel and bias
    under flax's shapes."""

    def __init__(self, kernel_shape, bias_shape, fan_in: int, generator):
        super().__init__()
        self.kernel = nn.Parameter(lecun_normal_(torch.empty(kernel_shape),
                                                 fan_in, generator))
        self.bias = nn.Parameter(torch.zeros(bias_shape))


class SelfAttention(nn.Module):
    """flax's ``nn.SelfAttention`` (no dropout): the query scaled by
    1/sqrt(head_dim) before its product with the keys, a boolean ``mask``
    (True keeps) filling the finfo minimum, softmax, then the output
    projection over (heads, head_dim)."""

    def __init__(self, width: int, heads: int, generator: torch.Generator):
        super().__init__()
        self.heads, self.head_dim = heads, width // heads
        for name in ("query", "key", "value"):
            self.add_module(name, _Projection(
                (width, heads, self.head_dim), (heads, self.head_dim), width,
                generator))
        self.out = _Projection((heads, self.head_dim, width), (width,),
                               width, generator)

    def _project(self, x, proj):
        kernel = proj.kernel.to(x.dtype)
        y = x @ kernel.reshape(kernel.shape[0], -1) + proj.bias.to(
            x.dtype).reshape(-1)
        return y.reshape(x.shape[:-1] + (self.heads, self.head_dim)
                         ).transpose(1, 2)

    def forward(self, x, mask=None):
        dtype = torch.promote_types(x.dtype, self.query.kernel.dtype)
        x = x.to(dtype)
        q = self._project(x, self.query) / math.sqrt(self.head_dim)
        k, v = self._project(x, self.key), self._project(x, self.value)
        scores = q @ k.transpose(-1, -2)
        if mask is not None:
            scores = scores.masked_fill(~mask, torch.finfo(dtype).min)
        ctx = torch.softmax(scores, dim=-1) @ v
        ctx = ctx.transpose(1, 2).reshape(x.shape[:-1] + (-1,))
        kernel = self.out.kernel.to(dtype)
        return ctx @ kernel.reshape(-1, kernel.shape[-1]) + self.out.bias.to(
            dtype)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, d_model: int, n_head: int,
                 generator: torch.Generator):
        super().__init__()
        self.ln_1 = LayerNorm(d_model, eps=LN_EPS)
        self.attn = SelfAttention(d_model, n_head, generator)
        self.ln_2 = LayerNorm(d_model, eps=LN_EPS)
        self.mlp_fc = flax_init_(Dense(d_model, d_model * 4), generator)
        self.gelu = QuickGELU()
        self.mlp_proj = flax_init_(Dense(d_model * 4, d_model), generator)

    def forward(self, x, attn_mask=None):
        x = x + self.attn(self.ln_1(x), attn_mask)
        return x + self.mlp_proj(self.gelu(self.mlp_fc(self.ln_2(x))))


def _same_padding(size: int, kernel: int, stride: int):
    """flax's ``SAME`` padding (low, high) of one spatial axis."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class CLIPVisionTransformer(nn.Module):
    """images [B, H, W, 3] float, normalized -> [B, output_dim]."""

    def __init__(self, image_size: int = 224, patch_size: int = 32,
                 width: int = 768, layers: int = 12, heads: int = 12,
                 output_dim: int = 512, generator: torch.Generator = None):
        super().__init__()
        if generator is None:
            raise ValueError("CLIPVisionTransformer needs a torch.Generator")
        self.patch_size, self.width, self.layers = patch_size, width, layers
        self.conv1 = flax_init_(nn.Conv2d(3, width, patch_size,
                                          stride=patch_size, bias=False),
                                generator)
        self.class_embedding = _normal_param((width,), 0.02, generator)
        n_pos = (image_size // patch_size) ** 2 + 1
        self.positional_embedding = _normal_param((n_pos, width), 0.02,
                                                  generator)
        self.ln_pre = LayerNorm(width, eps=LN_EPS)
        for i in range(layers):
            self.add_module(f"resblock_{i}",
                            ResidualAttentionBlock(width, heads, generator))
        self.ln_post = LayerNorm(width, eps=LN_EPS)
        self.proj = _normal_param((width, output_dim), 0.02, generator)

    def forward(self, images):
        b, h, w, _ = images.shape
        dtype = torch.promote_types(images.dtype, self.conv1.weight.dtype)
        x = images.to(dtype).permute(0, 3, 1, 2)
        ph = _same_padding(h, self.patch_size, self.patch_size)
        pw = _same_padding(w, self.patch_size, self.patch_size)
        if any(ph + pw):
            x = F.pad(x, pw + ph)
        x = F.conv2d(x, self.conv1.weight.to(dtype), stride=self.patch_size)
        x = x.flatten(2).transpose(1, 2)                 # [B, grid, width]
        cls = self.class_embedding.to(dtype).expand(b, 1, self.width)
        x = torch.cat([cls, x], dim=1) + self.positional_embedding.to(dtype)
        x = self.ln_pre(x)
        for i in range(self.layers):
            x = getattr(self, f"resblock_{i}")(x)
        x = self.ln_post(x[:, 0, :])
        return x @ self.proj.to(x.dtype)


class CLIPTextTransformer(nn.Module):
    """token_ids [B, context_length] (EOT at the argmax) -> [B, output_dim],
    causal self-attention."""

    def __init__(self, vocab_size: int = 49408, context_length: int = 77,
                 width: int = 512, layers: int = 12, heads: int = 8,
                 output_dim: int = 512, generator: torch.Generator = None):
        super().__init__()
        if generator is None:
            raise ValueError("CLIPTextTransformer needs a torch.Generator")
        self.layers = layers
        self.token_embedding = _normal_param((vocab_size, width), 0.02,
                                             generator)
        self.positional_embedding = _normal_param((context_length, width),
                                                  0.01, generator)
        for i in range(layers):
            self.add_module(f"resblock_{i}",
                            ResidualAttentionBlock(width, heads, generator))
        self.ln_final = LayerNorm(width, eps=LN_EPS)
        self.text_projection = _normal_param((width, output_dim), 0.02,
                                             generator)
        self.register_buffer("causal", torch.ones(
            context_length, context_length, dtype=torch.bool).tril(),
            persistent=False)

    def forward(self, token_ids):
        x = F.embedding(token_ids.long(), self.token_embedding)
        x = x + self.positional_embedding
        for i in range(self.layers):
            x = getattr(self, f"resblock_{i}")(x, self.causal)
        x = self.ln_final(x)
        eot = token_ids.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return pooled @ self.text_projection.to(pooled.dtype)


# ---------------------------------------------------------------------------
# OpenAI CLIP state-dict conversion
# ---------------------------------------------------------------------------

def _split_in_proj(w, b, n_head: int, width: int, prefix: str) -> dict:
    """torch's packed qkv (3*width, width) -> the port's ``query`` /
    ``key`` / ``value`` kernels [width, heads, head_dim] and biases."""
    head_dim = width // n_head
    out = {}
    for i, name in enumerate(("query", "key", "value")):
        rows = slice(i * width, (i + 1) * width)
        out[f"{prefix}{name}.kernel"] = w[rows].T.reshape(width, n_head,
                                                          head_dim)
        out[f"{prefix}{name}.bias"] = b[rows].reshape(n_head, head_dim)
    return out


def _convert_blocks(sd, prefix: str, layers: int, width: int,
                    heads: int) -> dict:
    out = {}
    for i in range(layers):
        p, q = f"{prefix}.resblocks.{i}.", f"resblock_{i}."
        out.update(_split_in_proj(sd[p + "attn.in_proj_weight"],
                                  sd[p + "attn.in_proj_bias"], heads, width,
                                  q + "attn."))
        out[q + "attn.out.kernel"] = sd[p + "attn.out_proj.weight"].T.reshape(
            heads, width // heads, width)
        out[q + "attn.out.bias"] = sd[p + "attn.out_proj.bias"]
        for ln in ("ln_1", "ln_2"):
            out[q + ln + ".weight"] = sd[p + ln + ".weight"]
            out[q + ln + ".bias"] = sd[p + ln + ".bias"]
        for port, torch_name in (("mlp_fc", "mlp.c_fc"),
                                 ("mlp_proj", "mlp.c_proj")):
            out[q + port + ".weight"] = sd[p + torch_name + ".weight"]
            out[q + port + ".bias"] = sd[p + torch_name + ".bias"]
    return out


def _tensors(tree: dict) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
            for k, v in tree.items()}


def convert_openai_clip_state_dict(sd: Dict[str, np.ndarray]):
    """An OpenAI CLIP (ViT) state dict (arrays or tensors) -> (the port's
    vision state dict, its text state dict, meta), the state dicts of
    ``CLIPVisionTransformer`` / ``CLIPTextTransformer`` (``meta``: width,
    patch, v_layers, t_width, t_layers, as ``care_tpu``'s)."""
    sd = {k: np.asarray(v, dtype=np.float32) for k, v in sd.items()}
    width = sd["visual.conv1.weight"].shape[0]
    patch = sd["visual.conv1.weight"].shape[-1]
    v_layers = len({k.split(".")[3] for k in sd
                    if k.startswith("visual.transformer.resblocks.")})
    vision = {
        "conv1.weight": sd["visual.conv1.weight"],
        "class_embedding": sd["visual.class_embedding"],
        "positional_embedding": sd["visual.positional_embedding"],
        "ln_pre.weight": sd["visual.ln_pre.weight"],
        "ln_pre.bias": sd["visual.ln_pre.bias"],
        "ln_post.weight": sd["visual.ln_post.weight"],
        "ln_post.bias": sd["visual.ln_post.bias"],
        "proj": sd["visual.proj"],
    }
    vision.update(_convert_blocks(sd, "visual.transformer", v_layers, width,
                                  width // 64))
    t_width = sd["ln_final.weight"].shape[0]
    t_layers = len({k.split(".")[2] for k in sd
                    if k.startswith("transformer.resblocks.")})
    text = {
        "token_embedding": sd["token_embedding.weight"],
        "positional_embedding": sd["positional_embedding"],
        "ln_final.weight": sd["ln_final.weight"],
        "ln_final.bias": sd["ln_final.bias"],
        "text_projection": sd["text_projection"],
    }
    text.update(_convert_blocks(sd, "transformer", t_layers, t_width,
                                t_width // 64))
    meta = {"width": width, "patch": patch, "v_layers": v_layers,
            "t_width": t_width, "t_layers": t_layers}
    return _tensors(vision), _tensors(text), meta


IMAGE_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
IMAGE_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def preprocess_images(images_uint8: np.ndarray) -> np.ndarray:
    """[B, H, W, 3] uint8 -> normalized float32 (resize and crop are done
    upstream)."""
    x = images_uint8.astype(np.float32) / 255.0
    return (x - IMAGE_MEAN) / IMAGE_STD


def encode_images(model: CLIPVisionTransformer, images: np.ndarray,
                  batch_size: int = 256) -> np.ndarray:
    """[N, H, W, 3] normalized images -> [N, output_dim] f32, in chunks on
    the model's device."""
    return encode_in_chunks(model, images, batch_size, torch.float32)


def encode_texts(model: CLIPTextTransformer, token_ids: np.ndarray,
                 batch_size: int = 1024) -> np.ndarray:
    """[N, context_length] token ids -> [N, output_dim] f32."""
    return encode_in_chunks(model, token_ids, batch_size, torch.long)

