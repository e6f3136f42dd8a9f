"""CLIP's towers, its state-dict converter and its tokenizer against the JAX
package (``care_tpu/pretreatment/{clip,bpe}.py``).

The vision and text towers take ``care_tpu``'s randomly initialised
parameters through ``params_from_jax`` and must give its outputs within
the CNN suite's bounds (2e-4 absolute, 1e-3 relative), at a small width
and at ViT-B/32's published shapes (patch 32, width 768, 12 layers, 12
heads, 224 x 224; the text tower's 49 408 words, 77 positions, width 512,
12 layers) on 2 images and 2 captions. The converter, fed an OpenAI-named
state dict the test builds, must give the state dict that
``params_from_jax`` makes of ``care_tpu``'s conversion of it, exactly. The
tokenizer must give ``care_tpu``'s ids on a merges file the test writes.
"""

import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from care_tpu.pretreatment import bpe as jax_bpe
from care_tpu.pretreatment import clip as jax_clip
from care_tpu_torch.models.weights import params_from_jax
from care_tpu_torch.pretreatment import bpe, clip

from test_torch_backbone_card import two_threads  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("two_threads")

SMALL_VISION = dict(image_size=64, patch_size=16, width=64, layers=2,
                    heads=4, output_dim=32)
SMALL_TEXT = dict(vocab_size=100, context_length=16, width=32, layers=2,
                  heads=4, output_dim=24)


def _jax_params(model, x, seed):
    return jax.tree.map(np.asarray, jax.jit(model.init)(
        jax.random.PRNGKey(seed), jnp.asarray(x))["params"])


def _jax_apply(model, params, x):
    return np.asarray(jax.jit(model.apply)({"params": params},
                                           jnp.asarray(x)))


@pytest.mark.parametrize("size", ["small", "ViT-B/32"])
def test_vision_tower_matches_jax(size):
    cfg = SMALL_VISION if size == "small" else {}
    side = cfg.get("image_size", 224)
    x = np.random.RandomState(0).randn(2, side, side, 3).astype(np.float32)
    jmodel = jax_clip.CLIPVisionTransformer(**cfg)
    params = _jax_params(jmodel, x, 0)
    port = clip.CLIPVisionTransformer(
        **cfg, generator=torch.Generator().manual_seed(0))
    params_from_jax(port, params)
    want = _jax_apply(jmodel, params, x)
    got = clip.encode_images(port.eval(), x)
    assert got.shape == want.shape == (2, cfg.get("output_dim", 512))
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("size", ["small", "ViT-B/32"])
def test_text_tower_matches_jax(size):
    cfg = SMALL_TEXT if size == "small" else {}
    vocab, ctx = cfg.get("vocab_size", 49408), cfg.get("context_length", 77)
    rs = np.random.RandomState(1)
    ids = np.zeros((2, ctx), np.int32)
    for row, length in enumerate((5, ctx)):
        ids[row, :length] = rs.randint(1, vocab - 2, length)
        ids[row, length - 1] = vocab - 1              # EOT: the largest id
    jmodel = jax_clip.CLIPTextTransformer(**cfg)
    params = _jax_params(jmodel, ids, 1)
    port = clip.CLIPTextTransformer(**cfg,
                                    generator=torch.Generator().manual_seed(0))
    params_from_jax(port, params)
    want = _jax_apply(jmodel, params, ids)
    got = clip.encode_texts(port.eval(), ids)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=2e-4)


def _openai_state_dict(seed, width=128, layers=2, patch=16, t_width=64,
                       t_layers=1, vocab=100, ctx=16, out=32, side=64):
    """An OpenAI CLIP ViT state dict (its key names and layouts) of random
    values at a small size."""
    rs = np.random.RandomState(seed)

    def r(*shape):
        return (0.1 * rs.randn(*shape)).astype(np.float32)

    sd = {"visual.conv1.weight": r(width, 3, patch, patch),
          "visual.class_embedding": r(width),
          "visual.positional_embedding": r((side // patch) ** 2 + 1, width),
          "visual.ln_pre.weight": 1 + r(width), "visual.ln_pre.bias": r(width),
          "visual.ln_post.weight": 1 + r(width),
          "visual.ln_post.bias": r(width), "visual.proj": r(width, out),
          "token_embedding.weight": r(vocab, t_width),
          "positional_embedding": r(ctx, t_width),
          "ln_final.weight": 1 + r(t_width), "ln_final.bias": r(t_width),
          "text_projection": r(t_width, out)}
    for prefix, w, n in (("visual.transformer", width, layers),
                         ("transformer", t_width, t_layers)):
        for i in range(n):
            p = f"{prefix}.resblocks.{i}."
            sd.update({p + "attn.in_proj_weight": r(3 * w, w),
                       p + "attn.in_proj_bias": r(3 * w),
                       p + "attn.out_proj.weight": r(w, w),
                       p + "attn.out_proj.bias": r(w),
                       p + "ln_1.weight": 1 + r(w), p + "ln_1.bias": r(w),
                       p + "ln_2.weight": 1 + r(w), p + "ln_2.bias": r(w),
                       p + "mlp.c_fc.weight": r(4 * w, w),
                       p + "mlp.c_fc.bias": r(4 * w),
                       p + "mlp.c_proj.weight": r(w, 4 * w),
                       p + "mlp.c_proj.bias": r(w)})
    return sd


def test_converter_matches_jax():
    sd = _openai_state_dict(2)
    vision, text, meta = clip.convert_openai_clip_state_dict(sd)
    jvision, jtext, jmeta = jax_clip.convert_openai_clip_state_dict(sd)
    assert meta == jmeta == {"width": 128, "patch": 16, "v_layers": 2,
                             "t_width": 64, "t_layers": 1}
    g = torch.Generator().manual_seed(0)
    vcfg = dict(image_size=64, patch_size=16, width=128, layers=2, heads=2,
                output_dim=32)
    tcfg = dict(vocab_size=100, context_length=16, width=64, layers=1,
                heads=1, output_dim=32)
    for port, ours, theirs in (
            (clip.CLIPVisionTransformer(**vcfg, generator=g), vision,
             jvision),
            (clip.CLIPTextTransformer(**tcfg, generator=g), text, jtext)):
        want = params_from_jax(port, theirs).state_dict()
        assert sorted(ours) == sorted(k for k in want if k != "causal")
        for k, v in ours.items():
            assert torch.equal(v, want[k]), k

    # the converted weights in both towers: the same features
    x = np.random.RandomState(3).randn(2, 64, 64, 3).astype(np.float32)
    port = clip.CLIPVisionTransformer(**vcfg, generator=g)
    port.load_state_dict(vision, strict=True)
    want = jax_clip.CLIPVisionTransformer(**vcfg).apply(
        {"params": jvision}, jnp.asarray(x))
    np.testing.assert_allclose(clip.encode_images(port.eval(), x),
                               np.asarray(want), rtol=1e-3, atol=2e-4)


def test_preprocess_matches_jax():
    imgs = (np.random.RandomState(4).rand(3, 8, 8, 3) * 255).astype(np.uint8)
    np.testing.assert_array_equal(clip.preprocess_images(imgs),
                                  jax_clip.preprocess_images(imgs))


MERGES = ["#version: 0.2", "a n", "t h", "th e</w>", "an d</w>", "i n",
          "in g</w>", "m an</w>", "r u", "ru n", "run n", "d o", "do g</w>",
          "c a", "ca t</w>", "p l", "pl a", "pla y"]
TEXTS = ["a man and a dog", "The cat is running!", "playing  games &amp; "
         "more", "a man's car 42", "<|startoftext|>x<|endoftext|>",
         "running " * 40]


def test_tokenizer_matches_jax(tmp_path):
    path = str(tmp_path / "merges.txt.gz")
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(MERGES) + "\n")
    port, ref = bpe.ClipTokenizer(path), jax_bpe.ClipTokenizer(path)
    for text in TEXTS:
        assert port.encode(text) == ref.encode(text), text
    np.testing.assert_array_equal(port.tokenize(TEXTS, truncate=True),
                                  ref.tokenize(TEXTS, truncate=True))
    with pytest.raises(RuntimeError, match="too long"):
        port.tokenize(TEXTS[-1])
