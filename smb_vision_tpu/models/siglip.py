"""SigLIP vision tower — 2D X-ray encoder.

The reference wraps the torch SiglipVisionModel with flash-attention-2 on
GPU for batch X-ray embedding (reference src/encoders/run_siglip.py:49-120).
Here the tower is a first-party model on this framework's compute path
(shared Block/Encoder and attention), so the encoder zoo's 2D path runs in
JAX instead of host torch. Architecture
matches transformers' SiglipVisionTransformer exactly (verified by golden
parity tests vs the torch implementation, tests/test_siglip.py):

- Conv2d patch embedding (stride == kernel -> exact conv-as-matmul,
  ops/patches.py::patch_embed_2d) + learned position embeddings, no CLS
- pre-LN transformer (qkv+out biases, gelu-tanh MLP)
- final post_layernorm
- MAP head: learned probe token cross-attends over the tokens
  (torch nn.MultiheadAttention semantics: packed qkv biases, out-proj
  bias), then LayerNorm + residual MLP; pooler output = probe position.

Checkpoint conversion: models/convert.py::convert_hf_siglip (torch
in_proj_weight split into q/k/v) and export_hf_siglip (inverse).
"""

from __future__ import annotations

from typing import Optional, Tuple

from smb_vision_tpu import nn
import jax.numpy as jnp

from smb_vision_tpu.models.configs import SiglipVisionConfig
from smb_vision_tpu.models.layers import (
    Attention,
    Encoder,
    Mlp,
    trunc_normal_init,
)
from smb_vision_tpu.ops.patches import patch_embed_2d

# HF activation-name alias: gelu_pytorch_tanh == jax.nn.gelu(approximate=True)
_ACT_ALIASES = {"gelu_pytorch_tanh": "gelu_new"}


def _act(name: str) -> str:
    return _ACT_ALIASES.get(name, name)


class SiglipMAPHead(nn.Module):
    """Multihead-attention-pooling head
    (transformers SiglipMultiheadAttentionPoolingHead): one learned probe
    query cross-attends over the token sequence, then LN + residual MLP.
    The probe attention is 1-query — XLA attention is optimal there (same
    call shape as the V-JEPA attentive pooler, models/vjepa.py)."""

    config: SiglipVisionConfig
    dtype: jnp.dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        cfg = self.config
        probe = self.param("probe", trunc_normal_init(0.02),
                           (1, 1, cfg.hidden_size), jnp.float32)
        probe = jnp.broadcast_to(probe, (x.shape[0],) + probe.shape[1:])
        h = Attention(cfg.hidden_size, cfg.num_attention_heads,
                      bias_mode="qkv", out_bias=True, dtype=self.dtype,
                      attn_impl="xla",
                      initializer_range=0.02,
                      name="attention")(probe.astype(self.dtype), kv=x)
        ln = nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=self.dtype,
                          param_dtype=jnp.float32, name="layernorm")
        h = h + Mlp(cfg.hidden_size, cfg.intermediate_size,
                    act=_act(cfg.hidden_act), dtype=self.dtype,
                    name="mlp")(ln(h))
        return h[:, 0]


class SiglipVisionModel(nn.Module):
    """Returns (last_hidden_state (B, N, D), pooler_output (B, D) | None).

    Input: (B, C, H, W) pixel values, HF convention (the Image2DDataset
    batch layout). Fixed-shape discipline: H and W must equal
    config.image_size (no position interpolation — one compiled geometry
    per program, the framework-wide contract)."""

    config: SiglipVisionConfig

    @nn.compact
    def __call__(self, pixel_values: jnp.ndarray
                 ) -> Tuple[jnp.ndarray, Optional[jnp.ndarray]]:
        cfg = self.config
        dtype = jnp.dtype(cfg.dtype)
        b, c, h, w = pixel_values.shape
        if (h, w) != (cfg.image_size, cfg.image_size):
            raise ValueError(
                f"input {h}x{w} != configured image_size {cfg.image_size} "
                "(fixed-shape contract; resize in the data pipeline)")

        kernel = self.param(
            "patch_embedding",
            nn.initializers.lecun_normal(batch_axis=(), in_axis=(1, 2, 3)),
            (cfg.hidden_size, cfg.num_channels, cfg.patch_size,
             cfg.patch_size), jnp.float32)
        bias = self.param("patch_bias", nn.initializers.zeros,
                          (cfg.hidden_size,), jnp.float32)
        x = patch_embed_2d(pixel_values, kernel, bias, dtype=dtype)

        pos = self.param("position_embedding",
                         trunc_normal_init(0.02),
                         (cfg.seq_len, cfg.hidden_size), jnp.float32)
        x = (x.astype(jnp.float32) + pos[None]).astype(dtype)

        x = Encoder(num_layers=cfg.num_hidden_layers,
                    hidden_size=cfg.hidden_size,
                    num_heads=cfg.num_attention_heads,
                    intermediate_size=cfg.intermediate_size,
                    act=_act(cfg.hidden_act), bias_mode="qkv",
                    layer_norm_eps=cfg.layer_norm_eps, dtype=dtype,
                    attn_impl=cfg.attn_impl,
                    remat=cfg.gradient_checkpointing,
                    initializer_range=0.02, name="encoder")(x)

        x = nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=dtype,
                         param_dtype=jnp.float32, name="post_layernorm")(x)

        pooled = None
        if cfg.vision_use_head:
            pooled = SiglipMAPHead(cfg, dtype=dtype, name="head")(x)
        return x, pooled
