"""V-JEPA2 for 3D volumes: encoder + predictor + attentive pooler.

Re-implements /root/reference/src/models/vjepa/modeling_vjepa.py for
static-shape JAX.

Key redesign — the *dense* predictor path: in V-JEPA training the
context and target masks partition the patch grid (context = complement of
the target blocks, transforms.py:187-194), so the reference's
gather -> concat -> sort -> attention -> unsort pipeline (:658-746) processes
exactly N tokens anyway. Since attention is permutation-equivariant and RoPE
uses explicit position ids, the same computation is expressed here with zero
gathers: predictor input = where(is_target, mask_token, proj(enc_out)),
position ids = arange(N). Identical math, fully static shapes, no sort.

The reference-parity path (index-list context/target masks, including the
(B*num_masks) stacking semantics of apply_masks :542-556) is kept for API
compatibility and tests.

RoPE cos/sin tables are computed once per forward and shared by all layers
(the reference recomputes them per layer, :204-228).
"""

from __future__ import annotations

from typing import List, Optional

from smb_vision_tpu import nn
import jax
import jax.numpy as jnp

from smb_vision_tpu.models.configs import VJEPA2Config
from smb_vision_tpu.models.layers import (
    Attention,
    Encoder,
    Mlp,
    trunc_normal_init,
)
from smb_vision_tpu.ops.patches import patch_embed
from smb_vision_tpu.ops.rope3d import rope3d_cos_sin


def apply_masks(tensor: jax.Array, masks: List[jax.Array]) -> jax.Array:
    """Gather patch subsets: (B, N, D) + list of (B, L) index arrays ->
    (B*len(masks), L, D). Matches reference apply_masks (:542-556)."""
    outs = [jnp.take_along_axis(tensor, m[..., None], axis=1) for m in masks]
    return jnp.concatenate(outs, axis=0)


class VJEPA2Encoder(nn.Module):
    config: VJEPA2Config

    @nn.compact
    def __call__(self, pixel_values_videos, deterministic: bool = True):
        cfg = self.config
        dt = jnp.dtype(cfg.dtype)
        kernel = self.param(
            "patch_embed_kernel", trunc_normal_init(cfg.initializer_range),
            (cfg.hidden_size, cfg.in_chans, cfg.tubelet_size,
             cfg.patch_size, cfg.patch_size), jnp.float32)
        bias = self.param("patch_embed_bias", nn.initializers.zeros,
                          (cfg.hidden_size,), jnp.float32)
        x = patch_embed(pixel_values_videos, kernel, bias, dtype=dt)
        n = x.shape[1]

        grid_hw = cfg.crop_size // cfg.patch_size
        ids = jnp.arange(n)
        rope = rope3d_cos_sin(ids, grid_hw, cfg.head_dim, dtype=dt)

        x = Encoder(
            num_layers=cfg.num_hidden_layers, hidden_size=cfg.hidden_size,
            num_heads=cfg.num_attention_heads,
            intermediate_size=int(cfg.hidden_size * cfg.mlp_ratio),
            act=cfg.hidden_act,
            bias_mode="qkv" if cfg.qkv_bias else "none",
            layer_norm_eps=cfg.layer_norm_eps,
            drop_path_rate=cfg.drop_path_rate, dtype=dt,
            attn_impl=cfg.attn_impl,
            fused_qkv=cfg.fused_qkv,
            remat=cfg.gradient_checkpointing,
            initializer_range=cfg.initializer_range,
            sequence_parallel=cfg.sequence_parallel,
            sp_variant=cfg.sp_variant,
            name="encoder")(x, rope=rope, deterministic=deterministic)
        return nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=dt,
                            param_dtype=jnp.float32, name="layernorm")(x)


class VJEPA2Predictor(nn.Module):
    config: VJEPA2Config

    def _stack(self, cfg, dt):
        return Encoder(
            num_layers=cfg.pred_num_hidden_layers,
            hidden_size=cfg.pred_hidden_size,
            num_heads=cfg.pred_num_attention_heads,
            intermediate_size=int(cfg.pred_hidden_size * cfg.pred_mlp_ratio),
            act=cfg.hidden_act,
            bias_mode="qkv" if cfg.qkv_bias else "none",
            layer_norm_eps=cfg.layer_norm_eps,
            drop_path_rate=cfg.drop_path_rate, dtype=dt,
            attn_impl=cfg.attn_impl,
            fused_qkv=cfg.fused_qkv,
            remat=cfg.gradient_checkpointing,
            initializer_range=cfg.initializer_range, name="stack")

    @nn.compact
    def __call__(self, encoder_hidden_states, *,
                 target_bool: Optional[jax.Array] = None,
                 context_mask: Optional[List[jax.Array]] = None,
                 target_mask: Optional[List[jax.Array]] = None,
                 mask_index: int = 1, deterministic: bool = True):
        cfg = self.config
        dt = jnp.dtype(cfg.dtype)
        grid_hw = cfg.crop_size // cfg.patch_size

        embed = nn.Dense(cfg.pred_hidden_size, dtype=dt,
                         param_dtype=jnp.float32,
                         kernel_init=trunc_normal_init(cfg.initializer_range),
                         name="predictor_embeddings")
        mask_tokens = self.param(
            "mask_tokens",
            nn.initializers.zeros if cfg.pred_zero_init_mask_tokens
            else trunc_normal_init(cfg.initializer_range),
            (cfg.pred_num_mask_tokens, 1, 1, cfg.pred_hidden_size),
            jnp.float32)
        mtok = mask_tokens[mask_index % cfg.pred_num_mask_tokens].astype(dt)

        if target_bool is not None:
            # ---- dense path: context = ~target, natural token order
            x = embed(encoder_hidden_states)
            x = jnp.where(target_bool[..., None], mtok, x)
            n = x.shape[1]
            ids = jnp.arange(n)
            rope = rope3d_cos_sin(ids, grid_hw, cfg.pred_head_dim, dtype=dt)
            x = self._stack(cfg, dt)(x, rope=rope,
                                     deterministic=deterministic)
            x = nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=dt,
                             param_dtype=jnp.float32, name="layernorm")(x)
            # dense output over all N positions; loss masks to targets
            return nn.Dense(cfg.hidden_size, dtype=dt,
                            param_dtype=jnp.float32,
                            kernel_init=trunc_normal_init(
                                cfg.initializer_range), name="proj")(x)

        # ---- reference-parity path: index-list masks (shapes static per
        # provided arrays; no sort needed — RoPE ids come from the masks)
        ctx = embed(apply_masks(encoder_hidden_states, context_mask))
        n_ctx = ctx.shape[1]
        bm = ctx.shape[0]
        tm = jnp.concatenate(target_mask, axis=0)       # (B*M, Lt)
        cm = jnp.concatenate(context_mask, axis=0)      # (B*M, Lc)
        tgt = jnp.broadcast_to(mtok, (bm, tm.shape[1], cfg.pred_hidden_size))
        x = jnp.concatenate([ctx, tgt], axis=1)
        ids = jnp.concatenate([cm, tm], axis=1)         # (B*M, Lc+Lt)
        rope = rope3d_cos_sin(ids, grid_hw, cfg.pred_head_dim, dtype=dt)
        x = self._stack(cfg, dt)(x, rope=rope, deterministic=deterministic)
        x = nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=dt,
                         param_dtype=jnp.float32, name="layernorm")(x)
        x = x[:, n_ctx:]
        return nn.Dense(cfg.hidden_size, dtype=dt, param_dtype=jnp.float32,
                        kernel_init=trunc_normal_init(cfg.initializer_range),
                        name="proj")(x)


class VJEPA2Model(nn.Module):
    """Encoder (+ optional predictor). Outputs mirror the reference's
    VJEPA2WithMaskedInputModelOutput fields (:1154-1161)."""

    config: VJEPA2Config

    @nn.compact
    def __call__(self, pixel_values_videos, *,
                 target_bool: Optional[jax.Array] = None,
                 context_mask: Optional[List[jax.Array]] = None,
                 target_mask: Optional[List[jax.Array]] = None,
                 skip_predictor: bool = False,
                 mask_index: int = 1, deterministic: bool = True):
        cfg = self.config
        enc = VJEPA2Encoder(cfg, name="encoder")(
            pixel_values_videos, deterministic=deterministic)
        out = {"last_hidden_state": enc}

        if target_bool is not None:
            out["target_bool"] = target_bool
            if not skip_predictor:
                out["predictor_output"] = VJEPA2Predictor(
                    cfg, name="predictor")(
                        enc, target_bool=target_bool, mask_index=mask_index,
                        deterministic=deterministic)
            return out

        if context_mask is None and target_mask is None:
            b, n = enc.shape[0], enc.shape[1]
            full = jnp.broadcast_to(jnp.arange(n)[None], (b, n))
            context_mask = [full]
            target_mask = [full]

        out["masked_hidden_state"] = apply_masks(enc, context_mask)
        out["target_hidden_state"] = apply_masks(enc, target_mask)
        if not skip_predictor:
            out["predictor_output"] = VJEPA2Predictor(cfg, name="predictor")(
                enc, context_mask=context_mask, target_mask=target_mask,
                mask_index=mask_index, deterministic=deterministic)
        return out


class VJEPA2AttentivePooler(nn.Module):
    """3 self-attn layers over tokens + 1 cross-attn with a learned query
    (reference :981-997). The cross-attention has no output projection."""

    config: VJEPA2Config

    @nn.compact
    def __call__(self, hidden_state, deterministic: bool = True):
        cfg = self.config
        dt = jnp.dtype(cfg.dtype)
        ln = lambda name: nn.LayerNorm(  # noqa: E731
            epsilon=cfg.layer_norm_eps, dtype=dt, param_dtype=jnp.float32,
            name=name)

        for i in range(cfg.num_pooler_layers):
            # self-attn layer: LN1 -> attn -> res; LN2 -> mlp -> res
            res = hidden_state
            h = Attention(cfg.hidden_size, cfg.num_attention_heads,
                          bias_mode="qkv", out_bias=True, dtype=dt,
                          attn_impl=cfg.attn_impl,
                          initializer_range=cfg.initializer_range,
                          name=f"self_layer_{i}_attn")(
                              ln(f"self_layer_{i}_norm1")(hidden_state))
            hidden_state = res + h
            res = hidden_state
            h = Mlp(cfg.hidden_size, int(cfg.hidden_size * cfg.mlp_ratio),
                    act=cfg.hidden_act, dtype=dt,
                    initializer_range=cfg.initializer_range,
                    name=f"self_layer_{i}_mlp")(
                        ln(f"self_layer_{i}_norm2")(hidden_state))
            hidden_state = res + h

        queries = self.param("query_tokens",
                             trunc_normal_init(cfg.initializer_range),
                             (1, 1, cfg.hidden_size), jnp.float32)
        b = hidden_state.shape[0]
        queries = jnp.broadcast_to(queries.astype(dt),
                                   (b, 1, cfg.hidden_size))
        # cross-attn layer: kv gets LN1, residual is the *queries*
        res = queries
        kv = ln("cross_norm1")(hidden_state)
        h = Attention(cfg.hidden_size, cfg.num_attention_heads,
                      bias_mode="qkv", out_proj=False, dtype=dt,
                      attn_impl="xla",  # 1-query cross-attn: XLA is optimal
                      initializer_range=cfg.initializer_range,
                      name="cross_attn")(queries, kv=kv)
        h = res + h
        res = h
        h = res + Mlp(cfg.hidden_size, int(cfg.hidden_size * cfg.mlp_ratio),
                      act=cfg.hidden_act, dtype=dt,
                      initializer_range=cfg.initializer_range,
                        name="cross_mlp")(ln("cross_norm2")(h))
        return h[:, 0]


class VJEPA2ForVideoClassification(nn.Module):
    config: VJEPA2Config

    @nn.compact
    def __call__(self, pixel_values_videos, labels=None,
                 deterministic: bool = True):
        cfg = self.config
        out = VJEPA2Model(cfg, name="vjepa2")(
            pixel_values_videos, skip_predictor=True,
            deterministic=deterministic)
        pooled = VJEPA2AttentivePooler(cfg, name="pooler")(
            out["last_hidden_state"], deterministic=deterministic)
        logits = nn.Dense(cfg.num_labels, dtype=jnp.float32,
                          param_dtype=jnp.float32,
                          kernel_init=trunc_normal_init(
                              cfg.initializer_range),
                          name="classifier")(pooled.astype(jnp.float32))
        res = {"logits": logits}
        if labels is not None:
            from smb_vision_tpu.models.videomae import classification_loss
            res["loss"] = classification_loss(logits, labels, cfg.num_labels,
                                              None)
        return res


def vjepa_loss(predictor_dense: jax.Array, teacher_enc: jax.Array,
               target_bool: jax.Array, valid=None) -> jax.Array:
    """Masked L1: mean |pred - teacher| over target positions only.
    Equals the reference's L1 over gathered target tokens
    (run_vjepa.py:110-136) for the complement-partition masks used in
    training.

    valid: optional (B,) 0/1 row weights — eval-padding rows leave both
    the numerator and the target-count denominator (train/trainer.py
    pad_batch rationale)."""
    diff = jnp.abs(predictor_dense.astype(jnp.float32) -
                   teacher_enc.astype(jnp.float32))
    w = target_bool.astype(jnp.float32)
    if valid is not None:
        w = w * valid.astype(jnp.float32)[:, None]
    w = w[..., None]
    denom = jnp.maximum(jnp.sum(w) * diff.shape[-1], 1.0)
    return jnp.sum(diff * w) / denom
