"""DINOv2 adapted to 3D volumes (classification backbone).

Re-implements /root/reference/src/models/dinov2/modeling_dinov2.py in JAX:
Conv3d patch embed over (B, C, H, W, D) input (the dinov2 transform pipeline
does *not* permute, transforms.py:283-298), CLS token, learned 3D position
embeddings, layerscale/droppath blocks, optional SwiGLU FFN, and the
cat[CLS, mean(patches)] -> linear(2*hidden) classification head (:627-711).

Fixes carried over from the survey (SURVEY.md §2, item 5): the reference's
`interpolate_pos_encoding` hard-codes a (1,224,244,160,dim) reshape
(modeling_dinov2.py:85) — here position embeddings are sized from the config
grid, and resizing between grids is an explicit checkpoint-conversion utility
(`resize_position_embeddings_3d`) using trilinear jax.image.resize.
"""

from __future__ import annotations

from smb_vision_tpu import nn
import jax
import jax.numpy as jnp

from smb_vision_tpu.models.configs import Dinov2Config
from smb_vision_tpu.models.layers import Encoder, trunc_normal_init
from smb_vision_tpu.models.videomae import classification_loss


def _patchify_chw(pixel_values, patch: int):
    """(B, C, H, W, D) -> (B, N, C*p^3) with patch vector in (c, dh, dw, dd)
    order and sequence order h-major (matches Conv3d flatten)."""
    b, c, h, w, d = pixel_values.shape
    p = patch
    x = pixel_values.reshape(b, c, h // p, p, w // p, p, d // p, p)
    x = x.transpose(0, 2, 4, 6, 1, 3, 5, 7)
    return x.reshape(b, (h // p) * (w // p) * (d // p), c * p * p * p)


def resize_position_embeddings_3d(pos: jax.Array, old_grid, new_grid
                                  ) -> jax.Array:
    """Trilinear resize of (1, N+1, D) learned pos-emb between patch grids
    (CLS row passes through)."""
    cls_pos, patch_pos = pos[:, :1], pos[:, 1:]
    d = pos.shape[-1]
    vol = patch_pos.reshape(1, *old_grid, d).astype(jnp.float32)
    vol = jax.image.resize(vol, (1, *new_grid, d), method="trilinear")
    return jnp.concatenate([cls_pos, vol.reshape(1, -1, d).astype(pos.dtype)],
                           axis=1)


class Dinov2Model(nn.Module):
    config: Dinov2Config

    @nn.compact
    def __call__(self, pixel_values, bool_masked_pos=None,
                 deterministic: bool = True):
        cfg = self.config
        dt = jnp.dtype(cfg.dtype)
        p = cfg.patch_size
        gh, gw, gd = (cfg.image_size // p, cfg.image_size // p,
                      cfg.depth // p)
        n = gh * gw * gd

        kernel = self.param(
            "patch_embed_kernel", trunc_normal_init(cfg.initializer_range),
            (cfg.hidden_size, cfg.num_channels, p, p, p), jnp.float32)
        pbias = self.param("patch_embed_bias", nn.initializers.zeros,
                           (cfg.hidden_size,), jnp.float32)
        patches = _patchify_chw(pixel_values, p)
        wmat = kernel.reshape(cfg.hidden_size, -1).T
        x = (jnp.dot(patches.astype(dt), wmat.astype(dt),
                     preferred_element_type=jnp.float32)
             + pbias).astype(dt)

        if cfg.use_mask_token:
            # masked-embedding path (reference modeling_dinov2.py:99-118):
            # masked patch embeddings are replaced by the learned mask token
            # BEFORE the CLS concat and position add
            mask_token = self.param("mask_token", nn.initializers.zeros,
                                    (1, cfg.hidden_size), jnp.float32)
            if bool_masked_pos is not None:
                x = jnp.where(bool_masked_pos[..., None],
                              mask_token[None].astype(dt), x)
        elif bool_masked_pos is not None:
            raise ValueError("bool_masked_pos given but use_mask_token is "
                             "False in the config")

        cls = self.param("cls_token", nn.initializers.normal(1.0),
                         (1, 1, cfg.hidden_size), jnp.float32)
        b = x.shape[0]
        x = jnp.concatenate(
            [jnp.broadcast_to(cls.astype(dt), (b, 1, cfg.hidden_size)), x],
            axis=1)

        pos = self.param("position_embeddings_3d",
                         nn.initializers.normal(1.0),
                         (1, n + 1, cfg.hidden_size), jnp.float32)
        x = x + pos.astype(dt)

        if cfg.use_swiglu_ffn:
            # SwiGLU hidden sizing rule (reference modeling_dinov2.py:
            # 383-384): 2/3 of mlp hidden, rounded up to a multiple of 8
            inter = (int(cfg.hidden_size * cfg.mlp_ratio * 2 / 3) + 7) \
                // 8 * 8
        else:
            inter = cfg.hidden_size * cfg.mlp_ratio
        x = Encoder(
            num_layers=cfg.num_hidden_layers, hidden_size=cfg.hidden_size,
            num_heads=cfg.num_attention_heads,
            intermediate_size=inter,
            act=cfg.hidden_act,
            # all of q, k, v carry a bias in DINOv2 (reference
            # modeling_dinov2.py:210-212) — unlike VideoMAE's q/v-only trick
            bias_mode="qkv" if cfg.qkv_bias else "none",
            layer_norm_eps=cfg.layer_norm_eps,
            layerscale_value=cfg.layerscale_value,
            drop_path_rate=cfg.drop_path_rate,
            use_swiglu=cfg.use_swiglu_ffn, dtype=dt,
            attn_impl=cfg.attn_impl,
            fused_qkv=cfg.fused_qkv,
            remat=cfg.gradient_checkpointing,
            initializer_range=cfg.initializer_range,
            name="encoder")(x, deterministic=deterministic)

        return nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=dt,
                            param_dtype=jnp.float32, name="layernorm")(x)


class Dinov2ForImageClassification(nn.Module):
    config: Dinov2Config

    @nn.compact
    def __call__(self, pixel_values, labels=None, deterministic: bool = True):
        cfg = self.config
        seq = Dinov2Model(cfg, name="dinov2")(pixel_values,
                                              deterministic=deterministic)
        cls_token = seq[:, 0]
        patch_mean = jnp.mean(seq[:, 1:], axis=1)
        pooled = jnp.concatenate([cls_token, patch_mean], axis=-1)
        logits = nn.Dense(cfg.num_labels, dtype=jnp.float32,
                          param_dtype=jnp.float32,
                          kernel_init=trunc_normal_init(
                              cfg.initializer_range),
                          name="classifier")(pooled.astype(jnp.float32))
        out = {"logits": logits}
        if labels is not None:
            out["loss"] = classification_loss(logits, labels, cfg.num_labels,
                                              cfg.problem_type)
        return out
