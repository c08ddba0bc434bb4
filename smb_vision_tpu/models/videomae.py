"""VideoMAE-3D: masked-image-modeling pretraining + classification.

Re-implements the capability of the reference's vendored VideoMAE
(/root/reference/src/models/videomae/modeling_videomae.py) for static-shape
JAX:

- Conv3d tubelet embedding as reshape+matmul (ops/patches.py)
- fixed sincos position table computed once (modeling_videomae.py:95-106)
- masked-token dropping via a *static-count* stable argsort + gather
  (equivalent to `embeddings[~bool_masked_pos]`, :134-137, but fixed-shape
  under jit: the MIM mask generator guarantees an exact masked count)
- decoder re-inserts mask tokens with gathered position embeddings
  (:806-815) and reconstructs per-patch-normalised pixels with MSE on the
  masked patches only (:837-897)
- classification head: mean-pool -> fc_norm -> [concat tabular features]
  -> linear (:974-989), problem_type dispatch MSE/CE/BCE (:993-1012)
"""

from __future__ import annotations

from typing import Optional

from smb_vision_tpu import nn
import jax
import jax.numpy as jnp

from smb_vision_tpu.models.configs import VideoMAEConfig
from smb_vision_tpu.models.layers import Encoder, trunc_normal_init
from smb_vision_tpu.ops.patches import (
    extract_patches,
    normalize_pixel_targets,
    patch_embed,
    sincos_position_table,
)


def _dtype(cfg):
    return jnp.dtype(cfg.dtype)


class VideoMAEModel(nn.Module):
    """Encoder: patch embed + sincos pos + transformer stack.

    If ``bool_masked_pos``/``num_masked`` are given, only visible tokens are
    encoded (MIM pretraining); positions of visible tokens are returned for
    the decoder."""

    config: VideoMAEConfig

    @nn.compact
    def __call__(self, pixel_values, bool_masked_pos=None,
                 num_masked: int = 0, deterministic: bool = True):
        cfg = self.config
        dt = _dtype(cfg)
        kernel = self.param(
            "patch_embed_kernel", trunc_normal_init(cfg.initializer_range),
            (cfg.hidden_size, cfg.num_channels, cfg.tubelet_size,
             cfg.patch_size, cfg.patch_size), jnp.float32)
        bias = self.param("patch_embed_bias", nn.initializers.zeros,
                          (cfg.hidden_size,), jnp.float32)

        n = cfg.seq_len
        pos = sincos_position_table(n, cfg.hidden_size).astype(dt)

        order = None
        if bool_masked_pos is not None and num_masked > 0:
            # stable sort: visible tokens first, original order preserved —
            # identical to boolean indexing with ~mask (ref :134-137).
            # Gather PIXEL patches (non-differentiable input) before the
            # embed matmul: the backward then has no scatter-add, and the
            # projection runs on the visible ~35% only. Bitwise equal to
            # embed-then-gather (row-independent matmul).
            order = jnp.argsort(bool_masked_pos.astype(jnp.int32), axis=-1,
                                stable=True)
            vis_idx = order[:, : n - num_masked]
            patches = extract_patches(pixel_values, cfg.tubelet_size,
                                      cfg.patch_size, channel_major=True)
            patches = jnp.take_along_axis(
                jax.lax.stop_gradient(patches), vis_idx[..., None], axis=1)
            wmat = kernel.reshape(cfg.hidden_size, -1).T
            x = jnp.dot(patches.astype(dt), wmat.astype(dt),
                        preferred_element_type=jnp.float32)
            x = (x + bias.astype(jnp.float32)).astype(dt)
            pos_b = jnp.broadcast_to(pos, (x.shape[0], n, cfg.hidden_size))
            x = x + jnp.take_along_axis(pos_b, vis_idx[..., None], axis=1)
        else:
            x = patch_embed(pixel_values, kernel, bias, dtype=dt)
            x = x + pos

        x = Encoder(
            num_layers=cfg.num_hidden_layers, hidden_size=cfg.hidden_size,
            num_heads=cfg.num_attention_heads,
            intermediate_size=cfg.intermediate_size, act=cfg.hidden_act,
            bias_mode="qv" if cfg.qkv_bias else "none",
            layer_norm_eps=cfg.layer_norm_eps, dtype=dt,
            attn_impl=cfg.attn_impl,
            fused_qkv=cfg.fused_qkv,
            remat=cfg.gradient_checkpointing,
            initializer_range=cfg.initializer_range,
            sequence_parallel=cfg.sequence_parallel,
            sp_variant=cfg.sp_variant, quant8=cfg.quant8,
            name="encoder")(x, deterministic=deterministic)

        if not cfg.use_mean_pooling:
            x = nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=dt,
                             param_dtype=jnp.float32, name="layernorm")(x)
        return x, order


class VideoMAEForPreTraining(nn.Module):
    """SimMIM-style pretraining: encode visible tokens, decode the full
    sequence (visible + mask tokens), MSE on masked patches."""

    config: VideoMAEConfig

    @nn.compact
    def __call__(self, pixel_values, bool_masked_pos, num_masked: int,
                 deterministic: bool = True, valid=None):
        # valid: optional (B,) 0/1 row weights for the loss — eval-padding
        # rows must not enter the mean (classification_loss docstring)
        cfg = self.config
        dt = _dtype(cfg)
        b = pixel_values.shape[0]

        enc_out, order = VideoMAEModel(cfg, name="videomae")(
            pixel_values, bool_masked_pos, num_masked, deterministic)
        n = cfg.seq_len
        n_vis = n - num_masked

        x = nn.Dense(cfg.decoder_hidden_size, use_bias=False, dtype=dt,
                     param_dtype=jnp.float32,
                     kernel_init=trunc_normal_init(cfg.initializer_range),
                     name="encoder_to_decoder")(enc_out)

        mask_token = self.param("mask_token",
                                trunc_normal_init(cfg.initializer_range),
                                (1, 1, cfg.decoder_hidden_size), jnp.float32)
        pos_dec = sincos_position_table(n, cfg.decoder_hidden_size).astype(dt)
        pos_dec = jnp.broadcast_to(pos_dec, (b, n, cfg.decoder_hidden_size))
        vis_idx, mask_idx = order[:, :n_vis], order[:, n_vis:]
        pos_vis = jnp.take_along_axis(pos_dec, vis_idx[..., None], axis=1)
        pos_mask = jnp.take_along_axis(pos_dec, mask_idx[..., None], axis=1)

        x_full = jnp.concatenate(
            [x + pos_vis, mask_token.astype(dt) + pos_mask], axis=1)

        x_full = Encoder(
            num_layers=cfg.decoder_num_hidden_layers,
            hidden_size=cfg.decoder_hidden_size,
            num_heads=cfg.decoder_num_attention_heads,
            intermediate_size=cfg.decoder_intermediate_size,
            act=cfg.hidden_act, bias_mode="qv" if cfg.qkv_bias else "none",
            layer_norm_eps=cfg.layer_norm_eps, dtype=dt,
            attn_impl=cfg.attn_impl,
            fused_qkv=cfg.fused_qkv,
            remat=cfg.gradient_checkpointing,
            initializer_range=cfg.initializer_range,
            sequence_parallel=cfg.sequence_parallel,
            sp_variant=cfg.sp_variant, quant8=cfg.quant8,
            name="decoder")(x_full, deterministic=deterministic)

        h = x_full[:, -num_masked:]
        h = nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=dt,
                         param_dtype=jnp.float32, name="decoder_norm")(h)
        logits = nn.Dense(cfg.patch_dim, dtype=dt, param_dtype=jnp.float32,
                          kernel_init=trunc_normal_init(cfg.initializer_range),
                          name="decoder_head")(h)

        # labels: per-patch-normalised pixels of the masked patches; the
        # reference computes these under no_grad (:822) — stop_gradient here.
        # Gather BEFORE normalising (per-patch normalisation commutes with
        # the patch gather): processes num_masked rows instead of all N.
        # For num_channels == 1 the channel-major and channel-minor patch
        # layouts coincide, so the encoder's extraction is reused — the
        # 512^2x320 volume is tiled into patches ONCE per step, not twice
        # (extract_patches is pure data movement over 84M voxels).
        if cfg.num_channels == 1:
            patches = extract_patches(pixel_values, cfg.tubelet_size,
                                      cfg.patch_size, channel_major=True)
        else:
            patches = extract_patches(pixel_values, cfg.tubelet_size,
                                      cfg.patch_size, channel_major=False)
        labels = jnp.take_along_axis(patches, mask_idx[..., None], axis=1)
        if cfg.norm_pix_loss:
            labels = normalize_pixel_targets(labels)
        labels = jax.lax.stop_gradient(labels)

        sq = (logits.astype(jnp.float32) - labels.astype(jnp.float32)) ** 2
        loss = (jnp.mean(sq) if valid is None
                else row_weighted_mean(jnp.mean(sq, axis=(1, 2)), valid))
        return {"loss": loss, "logits": logits}


class VideoMAEForVideoClassification(nn.Module):
    """Mean-pool + fc_norm + (tabular feature fusion) + linear head."""

    config: VideoMAEConfig

    @nn.compact
    def __call__(self, pixel_values, additional_features=None, labels=None,
                 deterministic: bool = True):
        cfg = self.config
        dt = _dtype(cfg)
        enc_out, _ = VideoMAEModel(cfg, name="videomae")(
            pixel_values, deterministic=deterministic)

        if cfg.use_mean_pooling:
            pooled = nn.LayerNorm(epsilon=1e-5, dtype=dt,
                                  param_dtype=jnp.float32,
                                  name="fc_norm")(jnp.mean(enc_out, axis=1))
        else:
            pooled = enc_out[:, 0]

        if additional_features is not None:
            if cfg.additional_features_size != additional_features.shape[-1]:
                raise ValueError(
                    f"expected additional_features of size "
                    f"{cfg.additional_features_size}, got "
                    f"{additional_features.shape[-1]}")
            pooled = jnp.concatenate(
                [pooled, additional_features.astype(pooled.dtype)], axis=-1)

        logits = nn.Dense(cfg.num_labels, dtype=dt, param_dtype=jnp.float32,
                          kernel_init=trunc_normal_init(cfg.initializer_range),
                          name="classifier")(pooled)
        logits = logits.astype(jnp.float32)

        out = {"logits": logits}
        if labels is not None:
            out["loss"] = classification_loss(
                logits, labels, cfg.num_labels, cfg.problem_type)
        return out


def classification_loss(logits, labels, num_labels: int,
                        problem_type: Optional[str], valid=None):
    """problem_type dispatch matching modeling_videomae.py:993-1012.

    valid: optional (B,) 0/1 row weights — the Trainer's eval padding
    duplicates the final batch's last row to keep the compiled shape
    stable, and those rows must not enter the loss mean (train/trainer.py
    pad_batch). valid=None keeps the exact unweighted reduction."""
    if problem_type is None:
        problem_type = ("regression" if num_labels == 1 else
                        "single_label_classification"
                        if jnp.issubdtype(labels.dtype, jnp.integer)
                        else "multi_label_classification")
    logits = logits.astype(jnp.float32)
    if problem_type == "regression":
        labels = labels.astype(jnp.float32)
        if num_labels == 1:
            row = (logits.squeeze(-1) - labels.squeeze()) ** 2
        else:
            row = jnp.mean((logits - labels) ** 2, axis=-1)
    elif problem_type == "single_label_classification":
        logp = jax.nn.log_softmax(logits, axis=-1)
        row = -jnp.take_along_axis(
            logp, labels[:, None].astype(jnp.int32), axis=-1)[:, 0]
    elif problem_type == "multi_label_classification":
        labels = labels.astype(jnp.float32)
        # BCE-with-logits
        row = jnp.mean(jnp.maximum(logits, 0) - logits * labels +
                       jnp.log1p(jnp.exp(-jnp.abs(logits))), axis=-1)
    else:
        raise ValueError(f"unknown problem_type {problem_type}")
    return row_weighted_mean(row, valid)


def row_weighted_mean(row: jax.Array, valid) -> jax.Array:
    """Mean of per-row losses over the valid rows (valid=None: all)."""
    if valid is None:
        return jnp.mean(row)
    v = valid.astype(jnp.float32)
    return jnp.sum(row * v) / jnp.maximum(jnp.sum(v), 1.0)
