"""Pipeline-parallel model application: run a trained checkpoint's
transformer stack through the GPipe schedule (parallel/pipeline.py)
without changing the parameter layout.

The reference scales depth only by replicating every layer on every GPU
(DeepSpeed ZeRO); here a model too large for one device's memory splits its
layer stack over a mesh "pipe" axis and streams microbatches through the
stage ring. Params stay in the HF-compatible per-layer dict layout on
host — `stack_layer_params` builds the stacked (pipe-sharded) view at
dispatch, so the same checkpoint serves dense, sequence-parallel, and
pipelined execution.

Inference/embedding path (deterministic=True): DropPath is identity, so
the per-layer stochastic-depth rates need no threading. Training with
drop_path_rate > 0 ships the per-layer rate schedule and per-layer RNG
keys as stacked leaves next to the layer params and folds the microbatch
index (pipeline_apply with_mb_index) into each DropPath draw — see
`pipelined_encoder(dp_rng=...)`.
"""

from __future__ import annotations

from typing import Any, Optional

from smb_vision_tpu import nn
import jax.numpy as jnp
from jax.sharding import Mesh

import jax

from smb_vision_tpu.models.layers import Block, Encoder
from smb_vision_tpu.ops.patches import (
    extract_patches,
    normalize_pixel_targets,
    patch_embed,
    sincos_position_table,
)
from smb_vision_tpu.ops.rope3d import rope3d_cos_sin
from smb_vision_tpu.parallel.pipeline import (
    pipeline_apply,
    stack_layer_params,
    unstack_layer_params,
)


def _cfg_block(cfg, hidden: int, heads: int, inter: int, dt, **over):
    """Block built from the shared config fields exactly as the dense
    models build theirs (videomae.py:89-101, vjepa.py:70-83) — a single
    construction site so a new Block knob (quant8, fused_qkv, ...) cannot
    silently drift between the dense and pipelined paths."""
    kw = dict(act=cfg.hidden_act,
              bias_mode="qkv" if cfg.qkv_bias else "none",
              layer_norm_eps=cfg.layer_norm_eps, dtype=dt,
              attn_impl=cfg.attn_impl,
              fused_qkv=cfg.fused_qkv,
              initializer_range=cfg.initializer_range)
    kw.update(over)
    return Block(hidden, heads, inter, **kw)


def _pipe_stack_droppath(block: Block, stacked, num_layers: int, x, rope,
                         *, drop_path_rate: float, dp_rng, mesh: Mesh,
                         axis: str, num_microbatches: int,
                         batch_axis: Optional[str], remat: bool):
    """Train-mode stack application with stochastic depth: the Encoder's
    linear per-layer rate schedule (layers.py:557) and per-layer base
    keys ride stacked leaves next to the layer params; each Block draws
    its DropPath masks from fold_in(key_layer, microbatch [, data-shard])
    so every (layer, microbatch, sample) gets an independent draw while
    the same microbatch sees the same key on every stage."""
    rates = jnp.asarray(
        [drop_path_rate * i / max(num_layers - 1, 1)
         for i in range(num_layers)], jnp.float32)
    keys = jax.random.split(dp_rng, num_layers)       # (L, 2) uint32

    def layer_fn(pk, h, rp, mb):
        key = jax.random.fold_in(pk["key"], mb)
        if batch_axis is not None:
            # decorrelate DropPath masks across data-parallel shards
            # (shard_map: each device draws its LOCAL rows' masks)
            key = jax.random.fold_in(key, jax.lax.axis_index(batch_axis))
        return block.apply({"params": pk["p"]}, h, rp, False, pk["rate"],
                           rngs={"droppath": key})

    return pipeline_apply(
        layer_fn, {"p": stacked, "rate": rates, "key": keys}, x,
        mesh=mesh, axis=axis, num_microbatches=num_microbatches,
        batch_axis=batch_axis, remat=remat, extra=rope,
        with_mb_index=True)


def pipelined_encoder(enc: Encoder, enc_params: dict, x, *, mesh: Mesh,
                      axis: str = "pipe", num_microbatches: int,
                      rope: Any = None, batch_axis: Optional[str] = None,
                      remat: bool = False,
                      deterministic: bool = True, dp_rng=None):
    """Apply an `Encoder` stack (its `{"layer_i": ...}` params) through the
    pipeline. Equivalent to `enc.apply({"params": enc_params}, x, rope,
    deterministic)` for the dense (non-sequence-parallel) configuration —
    asserted by tests/test_pipelined_models.py.

    Training with stochastic depth (drop_path_rate > 0, deterministic=
    False) needs `dp_rng`: the Encoder's per-layer linear rate schedule
    (layers.py:557) rides a stacked (L,) leaf next to the layer params,
    per-layer base keys ride a stacked (L, 2) leaf, and each Block draws
    its DropPath mask from fold_in(key_layer, microbatch [, data-shard])
    — so every (layer, sample) pair gets an independent draw. Parity with
    a per-layer dense loop over the identical key schedule is asserted by
    tests/test_pipelined_models.py::test_pipelined_encoder_droppath."""
    dp_active = (not deterministic) and enc.drop_path_rate > 0
    if dp_active and dp_rng is None:
        raise ValueError(
            "pipelined_encoder with drop_path_rate > 0 and "
            "deterministic=False needs dp_rng (the stochastic-depth "
            "PRNG key)")
    if enc.sequence_parallel:
        raise ValueError(
            "pipelined_encoder runs blocks inside shard_map; build the "
            "Encoder with sequence_parallel=False (pipe composes with "
            "the data axis, not the sequence axis)")
    stacked, n = stack_layer_params(enc_params)
    if n != enc.num_layers:
        raise ValueError(f"params carry {n} layers, Encoder declares "
                         f"{enc.num_layers}")
    block = Block(enc.hidden_size, enc.num_heads, enc.intermediate_size,
                  act=enc.act, bias_mode=enc.bias_mode,
                  layer_norm_eps=enc.layer_norm_eps,
                  layerscale_value=enc.layerscale_value,
                  use_swiglu=enc.use_swiglu, dtype=enc.dtype,
                  attn_impl=enc.attn_impl,
                  initializer_range=enc.initializer_range,
                  quant8=enc.quant8, fused_qkv=enc.fused_qkv)

    if dp_active:
        return _pipe_stack_droppath(
            block, stacked, enc.num_layers, x, rope,
            drop_path_rate=enc.drop_path_rate, dp_rng=dp_rng, mesh=mesh,
            axis=axis, num_microbatches=num_microbatches,
            batch_axis=batch_axis, remat=remat)

    if rope is None:
        layer_fn = lambda p, h: block.apply(  # noqa: E731
            {"params": p}, h, None, deterministic)
        return pipeline_apply(layer_fn, stacked, x, mesh=mesh, axis=axis,
                              num_microbatches=num_microbatches,
                              batch_axis=batch_axis, remat=remat)
    layer_fn = lambda p, h, rp: block.apply(  # noqa: E731
        {"params": p}, h, rp, deterministic)
    return pipeline_apply(layer_fn, stacked, x, mesh=mesh, axis=axis,
                          num_microbatches=num_microbatches,
                          batch_axis=batch_axis, remat=remat, extra=rope)


def videomae_pipeline_encode(config, params: dict, pixel_values, *,
                             mesh: Mesh, axis: str = "pipe",
                             num_microbatches: int,
                             batch_axis: Optional[str] = None,
                             remat: bool = False):
    """VideoMAEModel embedding forward (unmasked path, videomae.py:86-105)
    with the transformer stack pipelined: patch embed + sincos positions
    compute replicated (a fraction of one layer's FLOPs), the 12/24-layer
    stack streams through the pipe stages, final LayerNorm if the config
    keeps one. Matches `VideoMAEModel.apply(params, px)[0]`."""
    cfg = config
    p = params.get("params", params)
    dt = jnp.dtype(cfg.dtype) if isinstance(cfg.dtype, str) else cfg.dtype
    x = patch_embed(pixel_values, p["patch_embed_kernel"],
                    p["patch_embed_bias"], dtype=dt)
    x = x + sincos_position_table(cfg.seq_len, cfg.hidden_size).astype(dt)
    enc = Encoder(
        num_layers=cfg.num_hidden_layers, hidden_size=cfg.hidden_size,
        num_heads=cfg.num_attention_heads,
        intermediate_size=cfg.intermediate_size, act=cfg.hidden_act,
        bias_mode="qv" if cfg.qkv_bias else "none",
        layer_norm_eps=cfg.layer_norm_eps, dtype=dt,
        attn_impl=cfg.attn_impl, fused_qkv=cfg.fused_qkv,
        initializer_range=cfg.initializer_range,
        quant8=cfg.quant8)
    x = pipelined_encoder(enc, p["encoder"], x, mesh=mesh, axis=axis,
                          num_microbatches=num_microbatches,
                          batch_axis=batch_axis, remat=remat)
    if not cfg.use_mean_pooling:
        ln = nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=dt,
                          param_dtype=jnp.float32)
        x = ln.apply({"params": p["layernorm"]}, x)
    return x


def vjepa2_pipeline_encode(config, params: dict, pixel_values_videos, *,
                           mesh: Mesh, axis: str = "pipe",
                           num_microbatches: int,
                           batch_axis: Optional[str] = None,
                           remat: bool = False):
    """VJEPA2Encoder forward (vjepa.py:48-83) with the stack pipelined;
    the shared 3D-RoPE tables ship to every stage as the pipeline's
    layer-invariant extra operand. Matches `VJEPA2Encoder.apply`.
    Dense per-layer params; the stacked view is built at dispatch and the
    forward is shared with the pretraining path (`_vjepa_pipe_encode`)."""
    cfg = config
    p = params.get("params", params)
    stacked, n_layers = stack_layer_params(p["encoder"])
    if n_layers != cfg.num_hidden_layers:
        raise ValueError(f"params carry {n_layers} layers, config declares "
                         f"{cfg.num_hidden_layers}")
    sp = {**{k: v for k, v in p.items() if k != "encoder"},
          "encoder_stacked": stacked}
    return _vjepa_pipe_encode(cfg, sp, pixel_values_videos, mesh=mesh,
                              axis=axis, num_microbatches=num_microbatches,
                              batch_axis=batch_axis, remat=remat)


def dinov2_pipeline_encode(config, params: dict, pixel_values, *,
                           mesh: Mesh, axis: str = "pipe",
                           num_microbatches: int,
                           batch_axis: Optional[str] = None,
                           remat: bool = False):
    """Dinov2Model forward (dinov2.py:49-122: CHW patchify, CLS token,
    learned 3D positions, LayerScale/SwiGLU blocks) with the transformer
    stack pipelined. Matches `Dinov2Model.apply(params, px)`."""
    from smb_vision_tpu.models.dinov2 import _patchify_chw

    cfg = config
    dt = jnp.dtype(cfg.dtype)
    p = params.get("params", params)
    patches = _patchify_chw(pixel_values, cfg.patch_size)
    wmat = p["patch_embed_kernel"].reshape(cfg.hidden_size, -1).T
    x = (jnp.dot(patches.astype(dt), wmat.astype(dt),
                 preferred_element_type=jnp.float32)
         + p["patch_embed_bias"]).astype(dt)
    b = x.shape[0]
    x = jnp.concatenate(
        [jnp.broadcast_to(p["cls_token"].astype(dt),
                          (b, 1, cfg.hidden_size)), x], axis=1)
    x = x + p["position_embeddings_3d"].astype(dt)

    if cfg.use_swiglu_ffn:
        inter = (int(cfg.hidden_size * cfg.mlp_ratio * 2 / 3) + 7) // 8 * 8
    else:
        inter = cfg.hidden_size * cfg.mlp_ratio
    enc = Encoder(
        num_layers=cfg.num_hidden_layers, hidden_size=cfg.hidden_size,
        num_heads=cfg.num_attention_heads, intermediate_size=inter,
        act=cfg.hidden_act, bias_mode="qkv" if cfg.qkv_bias else "none",
        layer_norm_eps=cfg.layer_norm_eps,
        layerscale_value=cfg.layerscale_value,
        drop_path_rate=cfg.drop_path_rate,
        use_swiglu=cfg.use_swiglu_ffn, dtype=dt, attn_impl=cfg.attn_impl,
        fused_qkv=cfg.fused_qkv,
        initializer_range=cfg.initializer_range)
    x = pipelined_encoder(enc, p["encoder"], x, mesh=mesh, axis=axis,
                          num_microbatches=num_microbatches,
                          batch_axis=batch_axis, remat=remat)
    return nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=dt,
                        param_dtype=jnp.float32).apply(
        {"params": p["layernorm"]}, x)


# ---------------------------------------------------------------------------
# pipelined MIM pretraining: the full VideoMAEForPreTraining forward with
# BOTH transformer stacks (encoder + decoder) streamed through GPipe stages
# ---------------------------------------------------------------------------

def to_pipeline_pretrain_params(params: dict) -> dict:
    """VideoMAEForPreTraining param tree (per-layer `layer_i` dicts,
    models/videomae.py:107-184) -> the pipelined train-state layout: the
    encoder/decoder stacks become single stacked trees with a leading
    layer axis (shardable over the pipe/model mesh axis); everything else
    (patch embed, enc->dec projection, mask token, norms, head) is carried
    unchanged. Inverse: `from_pipeline_pretrain_params`."""
    wrapped = "params" in params
    p = dict(params["params"] if wrapped else params)
    vm = dict(p.pop("videomae"))
    enc_stacked, _ = stack_layer_params(vm.pop("encoder"))
    dec_stacked, _ = stack_layer_params(p.pop("decoder"))
    out = {"videomae": {**vm, "encoder_stacked": enc_stacked},
           "decoder_stacked": dec_stacked, **p}
    return {"params": out} if wrapped else out


def from_pipeline_pretrain_params(pparams: dict) -> dict:
    """Inverse of `to_pipeline_pretrain_params` — restores the dense
    HF-layout tree so checkpoints interoperate with the non-pipelined
    model, convert.py, and export_hf_videomae."""
    wrapped = "params" in pparams
    p = dict(pparams["params"] if wrapped else pparams)
    vm = dict(p.pop("videomae"))
    enc_stacked = vm.pop("encoder_stacked")
    dec_stacked = p.pop("decoder_stacked")
    n_enc = jax.tree_util.tree_leaves(enc_stacked)[0].shape[0]
    n_dec = jax.tree_util.tree_leaves(dec_stacked)[0].shape[0]
    out = {"videomae": {**vm,
                        "encoder": unstack_layer_params(enc_stacked, n_enc)},
           "decoder": unstack_layer_params(dec_stacked, n_dec), **p}
    return {"params": out} if wrapped else out


def videomae_pipeline_pretrain(config, params: dict, pixel_values,
                               bool_masked_pos, num_masked: int, *,
                               mesh: Mesh, axis: str = "model",
                               num_microbatches: int,
                               batch_axis: Optional[str] = None,
                               remat: bool = True, valid=None):
    """VideoMAEForPreTraining forward (videomae.py:107-184) with the
    encoder AND decoder stacks pipelined over `axis`; params in the
    stacked layout of `to_pipeline_pretrain_params` (each device holds
    layers/S of both stacks, so models deeper than one device's memory
    train).
    The non-stack glue (patch embed, gathers, enc->dec, norm, head, loss)
    replicates — a fraction of one layer's FLOPs. Matches the dense
    model's loss/logits (tests/test_pipelined_models.py)."""
    cfg = config
    dt = jnp.dtype(cfg.dtype) if isinstance(cfg.dtype, str) else cfg.dtype
    p = params.get("params", params)
    vm = p["videomae"]
    S = mesh.shape[axis]
    if cfg.num_hidden_layers % S or cfg.decoder_num_hidden_layers % S:
        raise ValueError(
            f"encoder ({cfg.num_hidden_layers}) and decoder "
            f"({cfg.decoder_num_hidden_layers}) layer counts must both "
            f"divide into {S} pipe stages")
    b = pixel_values.shape[0]
    n = cfg.seq_len
    n_vis = n - num_masked

    # --- visible-token embed (videomae.py:64-84: gather pixels before the
    # embed matmul — no scatter-add in the backward) ---
    order = jnp.argsort(bool_masked_pos.astype(jnp.int32), axis=-1,
                        stable=True)
    vis_idx, mask_idx = order[:, :n_vis], order[:, n_vis:]
    patches = extract_patches(pixel_values, cfg.tubelet_size,
                              cfg.patch_size, channel_major=True)
    patches_vis = jnp.take_along_axis(
        jax.lax.stop_gradient(patches), vis_idx[..., None], axis=1)
    wmat = vm["patch_embed_kernel"].reshape(cfg.hidden_size, -1).T
    x = jnp.dot(patches_vis.astype(dt), wmat.astype(dt),
                preferred_element_type=jnp.float32)
    x = (x + vm["patch_embed_bias"].astype(jnp.float32)).astype(dt)
    pos = sincos_position_table(n, cfg.hidden_size).astype(dt)
    pos_b = jnp.broadcast_to(pos, (b, n, cfg.hidden_size))
    x = x + jnp.take_along_axis(pos_b, vis_idx[..., None], axis=1)

    # --- encoder stack through the pipeline ---
    enc_block = _cfg_block(cfg, cfg.hidden_size, cfg.num_attention_heads,
                           cfg.intermediate_size, dt,
                           bias_mode="qv" if cfg.qkv_bias else "none",
                           quant8=cfg.quant8)
    layer_fn = lambda pp, h: enc_block.apply(  # noqa: E731
        {"params": pp}, h, None, True)
    x = pipeline_apply(layer_fn, vm["encoder_stacked"], x, mesh=mesh,
                       axis=axis, num_microbatches=num_microbatches,
                       batch_axis=batch_axis, remat=remat)
    if not cfg.use_mean_pooling:
        x = nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=dt,
                         param_dtype=jnp.float32).apply(
            {"params": vm["layernorm"]}, x)

    # --- decoder: re-insert mask tokens (videomae.py:125-153) ---
    x = nn.Dense(cfg.decoder_hidden_size, use_bias=False, dtype=dt,
                 param_dtype=jnp.float32).apply(
        {"params": p["encoder_to_decoder"]}, x)
    pos_dec = sincos_position_table(n, cfg.decoder_hidden_size).astype(dt)
    pos_dec = jnp.broadcast_to(pos_dec, (b, n, cfg.decoder_hidden_size))
    pos_vis = jnp.take_along_axis(pos_dec, vis_idx[..., None], axis=1)
    pos_mask = jnp.take_along_axis(pos_dec, mask_idx[..., None], axis=1)
    x_full = jnp.concatenate(
        [x + pos_vis, p["mask_token"].astype(dt) + pos_mask], axis=1)

    dec_block = _cfg_block(cfg, cfg.decoder_hidden_size,
                           cfg.decoder_num_attention_heads,
                           cfg.decoder_intermediate_size, dt,
                           bias_mode="qv" if cfg.qkv_bias else "none",
                           quant8=cfg.quant8)
    dec_fn = lambda pp, h: dec_block.apply(  # noqa: E731
        {"params": pp}, h, None, True)
    x_full = pipeline_apply(dec_fn, p["decoder_stacked"], x_full, mesh=mesh,
                            axis=axis, num_microbatches=num_microbatches,
                            batch_axis=batch_axis, remat=remat)

    # --- head + per-patch-normalised pixel MSE (videomae.py:155-184) ---
    h = x_full[:, -num_masked:]
    h = nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=dt,
                     param_dtype=jnp.float32).apply(
        {"params": p["decoder_norm"]}, h)
    logits = nn.Dense(cfg.patch_dim, dtype=dt,
                      param_dtype=jnp.float32).apply(
        {"params": p["decoder_head"]}, h)
    if cfg.num_channels != 1:
        patches = extract_patches(pixel_values, cfg.tubelet_size,
                                  cfg.patch_size, channel_major=False)
    labels = jnp.take_along_axis(patches, mask_idx[..., None], axis=1)
    if cfg.norm_pix_loss:
        labels = normalize_pixel_targets(labels)
    labels = jax.lax.stop_gradient(labels)
    sq = (logits.astype(jnp.float32) - labels.astype(jnp.float32)) ** 2
    if valid is None:
        loss = jnp.mean(sq)
    else:
        # trainer eval-padding rows leave the mean (videomae.py
        # classification_loss docstring)
        from smb_vision_tpu.models.videomae import row_weighted_mean

        loss = row_weighted_mean(jnp.mean(sq, axis=(1, 2)), valid)
    return {"loss": loss, "logits": logits}


# ---------------------------------------------------------------------------
# pipelined V-JEPA2 pretraining: student encoder, EMA-teacher encoder and
# predictor stacks all streamed through GPipe stages
# ---------------------------------------------------------------------------

def to_pipeline_vjepa_params(params: dict) -> dict:
    """VJEPA2Model param tree (models/vjepa.py:160-199) -> stacked layout:
    encoder/encoder and predictor/stack become stacked trees with a
    leading layer axis; glue (patch embed, norms, embeddings, mask tokens,
    proj) carries unchanged. Apply to the EMA teacher copy too — it is the
    same tree."""
    wrapped = "params" in params
    p = dict(params["params"] if wrapped else params)
    enc = dict(p.pop("encoder"))
    enc_stacked, _ = stack_layer_params(enc.pop("encoder"))
    out = {"encoder": {**enc, "encoder_stacked": enc_stacked}}
    if "predictor" in p:
        prd = dict(p.pop("predictor"))
        stack_stacked, _ = stack_layer_params(prd.pop("stack"))
        out["predictor"] = {**prd, "stack_stacked": stack_stacked}
    out.update(p)
    return {"params": out} if wrapped else out


def from_pipeline_vjepa_params(pparams: dict) -> dict:
    """Inverse of `to_pipeline_vjepa_params` (dense HF layout for
    export_hf_vjepa2 / the non-pipelined model)."""
    wrapped = "params" in pparams
    p = dict(pparams["params"] if wrapped else pparams)
    enc = dict(p.pop("encoder"))
    enc_stacked = enc.pop("encoder_stacked")
    n_enc = jax.tree_util.tree_leaves(enc_stacked)[0].shape[0]
    out = {"encoder": {**enc,
                       "encoder": unstack_layer_params(enc_stacked, n_enc)}}
    if "predictor" in p:
        prd = dict(p.pop("predictor"))
        stack_stacked = prd.pop("stack_stacked")
        n_prd = jax.tree_util.tree_leaves(stack_stacked)[0].shape[0]
        out["predictor"] = {
            **prd, "stack": unstack_layer_params(stack_stacked, n_prd)}
    out.update(p)
    return {"params": out} if wrapped else out


def _vjepa_pipe_encode(cfg, enc_params, pixel_values_videos, *, mesh, axis,
                       num_microbatches, batch_axis, remat, dp_rng=None):
    """VJEPA2Encoder forward (vjepa.py:48-82) over STACKED params.
    dp_rng: train-mode stochastic depth when cfg.drop_path_rate > 0
    (the student; the EMA teacher encodes without it)."""
    dt = jnp.dtype(cfg.dtype)
    x = patch_embed(pixel_values_videos, enc_params["patch_embed_kernel"],
                    enc_params["patch_embed_bias"], dtype=dt)
    n = x.shape[1]
    rope = rope3d_cos_sin(jnp.arange(n), cfg.crop_size // cfg.patch_size,
                          cfg.head_dim, dtype=dt)
    block = _cfg_block(cfg, cfg.hidden_size, cfg.num_attention_heads,
                       int(cfg.hidden_size * cfg.mlp_ratio), dt)
    if dp_rng is not None and cfg.drop_path_rate > 0:
        x = _pipe_stack_droppath(
            block, enc_params["encoder_stacked"], cfg.num_hidden_layers,
            x, rope, drop_path_rate=cfg.drop_path_rate, dp_rng=dp_rng,
            mesh=mesh, axis=axis, num_microbatches=num_microbatches,
            batch_axis=batch_axis, remat=remat)
    else:
        layer_fn = lambda pp, h, rp: block.apply(  # noqa: E731
            {"params": pp}, h, rp, True)
        x = pipeline_apply(layer_fn, enc_params["encoder_stacked"], x,
                           mesh=mesh, axis=axis,
                           num_microbatches=num_microbatches,
                           batch_axis=batch_axis, remat=remat, extra=rope)
    return nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=dt,
                        param_dtype=jnp.float32).apply(
        {"params": enc_params["layernorm"]}, x)


def vjepa2_pipeline_pretrain(config, params: dict, teacher: dict,
                             pixel_values_videos, target_bool, *,
                             mesh: Mesh, axis: str = "model",
                             num_microbatches: int,
                             batch_axis: Optional[str] = None,
                             remat: bool = True, mask_index: int = 1,
                             dp_rng=None, valid=None):
    """V-JEPA2 pretraining loss (train/vjepa.py loss_for, dense
    target_bool formulation of vjepa.py:123-138) with the student
    encoder, EMA-teacher encoder, and predictor stacks all pipelined
    over `axis`; params/teacher in the stacked layout of
    `to_pipeline_vjepa_params`. When config.drop_path_rate > 0, pass
    dp_rng: the student encoder and predictor run with stochastic depth
    (per-layer rates as stacked leaves, _pipe_stack_droppath) while the
    EMA teacher encodes deterministically; dp_rng=None is eval mode
    (DropPath off) — matching the dense workload (train/vjepa.py
    loss_for: student rngs={'droppath': ...} in train,
    deterministic=True in eval; teacher always eval-mode)."""
    from smb_vision_tpu.models.vjepa import vjepa_loss

    cfg = config
    dt = jnp.dtype(cfg.dtype)
    p = params.get("params", params)
    t = teacher.get("params", teacher)
    S = mesh.shape[axis]
    if cfg.num_hidden_layers % S or cfg.pred_num_hidden_layers % S:
        raise ValueError(
            f"encoder ({cfg.num_hidden_layers}) and predictor "
            f"({cfg.pred_num_hidden_layers}) layer counts must both "
            f"divide into {S} pipe stages")
    kw = dict(mesh=mesh, axis=axis, num_microbatches=num_microbatches,
              batch_axis=batch_axis, remat=remat)

    dp_enc = dp_prd = None
    if dp_rng is not None and cfg.drop_path_rate > 0:
        dp_enc, dp_prd = jax.random.split(dp_rng)
    enc = _vjepa_pipe_encode(cfg, p["encoder"], pixel_values_videos,
                             dp_rng=dp_enc, **kw)
    tgt = jax.lax.stop_gradient(
        _vjepa_pipe_encode(cfg, t["encoder"], pixel_values_videos, **kw))

    prd = p["predictor"]
    x = nn.Dense(cfg.pred_hidden_size, dtype=dt,
                 param_dtype=jnp.float32).apply(
        {"params": prd["predictor_embeddings"]}, enc)
    mtok = prd["mask_tokens"][mask_index % cfg.pred_num_mask_tokens]
    x = jnp.where(target_bool[..., None], mtok.astype(dt), x)
    n = x.shape[1]
    rope = rope3d_cos_sin(jnp.arange(n), cfg.crop_size // cfg.patch_size,
                          cfg.pred_head_dim, dtype=dt)
    pblock = _cfg_block(cfg, cfg.pred_hidden_size,
                        cfg.pred_num_attention_heads,
                        int(cfg.pred_hidden_size * cfg.pred_mlp_ratio), dt)
    if dp_prd is not None:
        x = _pipe_stack_droppath(
            pblock, prd["stack_stacked"], cfg.pred_num_hidden_layers,
            x, rope, drop_path_rate=cfg.drop_path_rate, dp_rng=dp_prd,
            **kw)
    else:
        pfn = lambda pp, h, rp: pblock.apply(  # noqa: E731
            {"params": pp}, h, rp, True)
        x = pipeline_apply(pfn, prd["stack_stacked"], x, extra=rope, **kw)
    x = nn.LayerNorm(epsilon=cfg.layer_norm_eps, dtype=dt,
                     param_dtype=jnp.float32).apply(
        {"params": prd["layernorm"]}, x)
    pred = nn.Dense(cfg.hidden_size, dtype=dt,
                    param_dtype=jnp.float32).apply(
        {"params": prd["proj"]}, x)
    return vjepa_loss(pred, tgt, target_bool, valid=valid)
