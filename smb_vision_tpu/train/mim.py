"""MIM (SimMIM-style) pretraining workload.

Builds the jitted train/eval step for VideoMAEForPreTraining. The
block mask is generated *inside* the compiled step from the RNG key
(per-sample; the reference generated masks in CPU DataLoader workers and
pickled them into the dataset cache, mim.py:161-185)."""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import optax

from smb_vision_tpu.models.configs import VideoMAEConfig
from smb_vision_tpu.models.videomae import VideoMAEForPreTraining
from smb_vision_tpu.ops.masking import mim_mask, num_masked_tokens
from smb_vision_tpu.train.trainer import accumulate_gradients, train_state


def make_mim_workload(config: VideoMAEConfig, *, mask_patch_size: int,
                      mask_ratio: float, tx: optax.GradientTransformation,
                      grad_accum: int = 1, accum_dtype=None):
    """Returns (model, init_fn, step_fn, eval_fn)."""
    if getattr(config, "quant8", False):
        raise ValueError(
            "quant8 is an inference-only fast path: the W8A8 rounding has "
            "zero gradient almost everywhere, so training with it would "
            "silently go nowhere. Unset config.quant8 for pretraining.")
    model = VideoMAEForPreTraining(config)
    num_masked = num_masked_tokens(
        config.image_size, config.num_frames, mask_patch_size,
        config.patch_size, mask_ratio)

    def gen_mask(key, batch):
        return mim_mask(key, batch, input_size=config.image_size,
                        depth=config.num_frames,
                        mask_patch_size=mask_patch_size,
                        model_patch_size=config.patch_size,
                        mask_ratio=mask_ratio)

    def init_fn(key) -> Tuple:
        from smb_vision_tpu.parallel.mesh import init_batch_size

        b = init_batch_size()  # data-axis rows when SP pins batch to it
        px = jnp.zeros((b, config.num_frames, config.num_channels,
                        config.image_size, config.image_size),
                       jnp.float32)
        mask = gen_mask(key, b)
        params = jax.jit(model.init, static_argnums=(3,))(
            key, px, mask, num_masked)
        return train_state(params, tx.init(params))

    def loss_fn(params, batch, key, deterministic=False):
        px = batch["pixel_values"]
        mask = gen_mask(key, px.shape[0])
        # valid_mask: trainer eval padding (rows excluded from the loss
        # mean); absent on train batches
        out = model.apply(params, px, mask, num_masked,
                          deterministic=deterministic,
                          valid=batch.get("valid_mask"))
        return out["loss"], None

    def step_fn(state, batch, key):
        loss, _, grads = accumulate_gradients(
            loss_fn, state["params"], batch, key, grad_accum,
            accum_dtype=accum_dtype)
        updates, opt_state = tx.update(grads, state["opt_state"],
                                       state["params"])
        params = optax.apply_updates(state["params"], updates)
        new_state = dict(state)
        new_state.update(params=params, opt_state=opt_state,
                         step=state["step"] + 1)
        return new_state, {"loss": loss}

    @jax.jit
    def eval_fn(state, batch):
        key = jax.random.PRNGKey(0)  # fixed eval mask for determinism
        # deterministic=True: eval must run the model in eval mode (today
        # the VideoMAE has no stochastic modules, but the contract
        # matches the vjepa/classification eval paths)
        loss, _ = loss_fn(state["params"], batch, key, deterministic=True)
        return {"loss": loss}

    return model, init_fn, step_fn, eval_fn


def make_pipelined_mim_workload(config: VideoMAEConfig, *,
                                mask_patch_size: int, mask_ratio: float,
                                tx: optax.GradientTransformation, mesh,
                                num_microbatches: int,
                                eval_microbatches: int = 0,
                                remat: bool = True):
    """MIM pretraining with the encoder AND decoder stacks pipelined
    (GPipe) over the mesh model axis: each device holds layers/S of both
    stacks plus the replicated glue, so models deeper than one device's memory
    pretrain. The train state keeps the STACKED param layout (shardable
    leading layer axis — pair with sharding_policy="pipeline"); convert
    with models/pipelined.from_pipeline_pretrain_params before exporting
    dense/HF checkpoints. Microbatching doubles as in-step gradient
    accumulation, so there is no separate grad_accum knob.

    Returns (model, init_fn, step_fn, eval_fn) like make_mim_workload."""
    from smb_vision_tpu.models.pipelined import (
        to_pipeline_pretrain_params,
        videomae_pipeline_pretrain,
    )
    from smb_vision_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS

    if getattr(config, "quant8", False):
        raise ValueError("quant8 is inference-only; unset it for "
                         "pretraining (see make_mim_workload)")
    if config.sequence_parallel:
        raise ValueError("pipeline parallelism composes with the data "
                         "axis, not sequence parallelism; unset "
                         "config.sequence_parallel")
    model = VideoMAEForPreTraining(config)
    num_masked = num_masked_tokens(
        config.image_size, config.num_frames, mask_patch_size,
        config.patch_size, mask_ratio)
    batch_axis = DATA_AXIS if mesh.shape[DATA_AXIS] > 1 else None

    def gen_mask(key, batch):
        return mim_mask(key, batch, input_size=config.image_size,
                        depth=config.num_frames,
                        mask_patch_size=mask_patch_size,
                        model_patch_size=config.patch_size,
                        mask_ratio=mask_ratio)

    def init_fn(key):
        from smb_vision_tpu.parallel.mesh import init_batch_size

        b = init_batch_size()  # data-axis rows when SP pins batch to it
        px = jnp.zeros((b, config.num_frames, config.num_channels,
                        config.image_size, config.image_size),
                       jnp.float32)
        mask = gen_mask(key, b)
        dense = jax.jit(VideoMAEForPreTraining(config).init,
                        static_argnums=(3,))(key, px, mask, num_masked)
        params = to_pipeline_pretrain_params(dense)
        return train_state(params, tx.init(params))

    def loss_for(params, batch, key, microbatches):
        px = batch["pixel_values"]
        mask = gen_mask(key, px.shape[0])
        out = videomae_pipeline_pretrain(
            config, params, px, mask, num_masked, mesh=mesh,
            axis=MODEL_AXIS, num_microbatches=microbatches,
            batch_axis=batch_axis, remat=remat,
            valid=batch.get("valid_mask"))
        return out["loss"]

    def loss_fn(params, batch, key):
        return loss_for(params, batch, key, num_microbatches)

    def step_fn(state, batch, key):
        loss, grads = jax.value_and_grad(loss_fn)(state["params"], batch,
                                                  key)
        updates, opt_state = tx.update(grads, state["opt_state"],
                                       state["params"])
        params = optax.apply_updates(state["params"], updates)
        new_state = dict(state)
        new_state.update(params=params, opt_state=opt_state,
                         step=state["step"] + 1)
        return new_state, {"loss": loss}

    @jax.jit
    def eval_fn(state, batch):
        key = jax.random.PRNGKey(0)  # fixed eval mask for determinism
        # eval batches may not factor like train batches (e.g. padded
        # ragged final batch); a smaller microbatch count keeps the
        # divisibility constraints satisfiable
        return {"loss": loss_for(state["params"], batch, key,
                                 eval_microbatches or num_microbatches)}

    return model, init_fn, step_fn, eval_fn
