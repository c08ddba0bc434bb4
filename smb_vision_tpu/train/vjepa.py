"""V-JEPA2 pretraining workload.

EMA teacher + predictor with masked-L1 loss (reference run_vjepa.py:87-141),
with the two reference bugs fixed by design (SURVEY §2 item 5):
- per-sample multi-block masks generated on device in the step (the
  reference's collate replicated ONE sample's mask over the batch)
- the EMA update runs exactly once per optimizer step, after the update
  (the reference ran it inside compute_loss — per micro-step and during
  eval)."""

from __future__ import annotations


import jax
import jax.numpy as jnp
import optax

from smb_vision_tpu.models.configs import VJEPA2Config
from smb_vision_tpu.models.vjepa import VJEPA2Model, vjepa_loss
from smb_vision_tpu.ops.masking import vjepa_target_mask
from smb_vision_tpu.train.optim import ema_update
from smb_vision_tpu.train.trainer import accumulate_gradients, train_state

EMA_MOMENTUM = 0.99925  # run_vjepa.py:107


def make_vjepa_workload(config: VJEPA2Config, *,
                        tx: optax.GradientTransformation,
                        grad_accum: int = 1, accum_dtype=None,
                        ema_momentum: float = EMA_MOMENTUM,
                        pred_mask_scale=(0.2, 0.8),
                        aspect_ratio=(0.3, 3.0), num_blocks: int = 3,
                        inv_block: bool = False):
    model = VJEPA2Model(config)

    def gen_mask(key, batch):
        return vjepa_target_mask(key, batch, grid=config.grid,
                                 pred_mask_scale=pred_mask_scale,
                                 aspect_ratio=aspect_ratio,
                                 num_blocks=num_blocks,
                                 inv_block=inv_block)

    def init_fn(key):
        from smb_vision_tpu.parallel.mesh import init_batch_size

        b = init_batch_size()  # data-axis rows when SP pins batch to it
        px = jnp.zeros((b, config.frames_per_clip, config.in_chans,
                        config.crop_size, config.crop_size), jnp.float32)
        tb = gen_mask(key, b)
        params = jax.jit(
            lambda k, x, t: model.init(k, x, target_bool=t))(key, px, tb)
        # teacher starts as a copy of the online encoder (deepcopy in the
        # reference, run_vjepa.py:104)
        teacher = jax.tree_util.tree_map(jnp.copy, params)
        return train_state(params, tx.init(params), teacher=teacher)

    def loss_for(params, teacher, px, key, deterministic=False,
                 valid=None):
        mask_key, dp_key = jax.random.split(key)
        tb = gen_mask(mask_key, px.shape[0])
        rngs = None if deterministic else {"droppath": dp_key}
        out = model.apply(params, px, target_bool=tb,
                          deterministic=deterministic, rngs=rngs)
        tgt = model.apply(teacher, px, target_bool=tb, skip_predictor=True)[
            "last_hidden_state"]
        return vjepa_loss(out["predictor_output"],
                          jax.lax.stop_gradient(tgt), tb, valid=valid)

    def step_fn(state, batch, key):
        teacher = state["teacher"]

        def loss_fn(params, b, k):
            return loss_for(params, teacher, b["pixel_values"], k), None

        loss, _, grads = accumulate_gradients(
            loss_fn, state["params"], batch, key, grad_accum,
            accum_dtype=accum_dtype)
        updates, opt_state = tx.update(grads, state["opt_state"],
                                       state["params"])
        params = optax.apply_updates(state["params"], updates)
        teacher = ema_update(teacher, params, ema_momentum)
        new_state = dict(state)
        new_state.update(params=params, opt_state=opt_state,
                         teacher=teacher, step=state["step"] + 1)
        return new_state, {"loss": loss}

    @jax.jit
    def eval_fn(state, batch):
        # deterministic=True disables DropPath — eval loss is the model's
        # eval-mode loss, not a stochastic-depth sample (the mask key stays
        # fixed so the eval task itself is reproducible). valid_mask:
        # trainer eval-padding rows leave the masked-L1 mean.
        loss = loss_for(state["params"], state["teacher"],
                        batch["pixel_values"], jax.random.PRNGKey(0),
                        deterministic=True,
                        valid=batch.get("valid_mask"))
        return {"loss": loss}

    return model, init_fn, step_fn, eval_fn


def make_pipelined_vjepa_workload(config: VJEPA2Config, *,
                                  tx: optax.GradientTransformation, mesh,
                                  num_microbatches: int,
                                  eval_microbatches: int = 0,
                                  remat: bool = True,
                                  ema_momentum: float = EMA_MOMENTUM,
                                  pred_mask_scale=(0.2, 0.8),
                                  aspect_ratio=(0.3, 3.0),
                                  num_blocks: int = 3,
                                  inv_block: bool = False):
    """V-JEPA2 pretraining with the student encoder, EMA-teacher encoder,
    and predictor stacks GPipe-pipelined over the mesh model axis
    (models/pipelined.vjepa2_pipeline_pretrain). The train state — online
    params AND the teacher copy — keeps the STACKED layout (pair with
    sharding_policy="pipeline"); convert with from_pipeline_vjepa_params
    for dense/HF exports. Microbatching replaces gradient accumulation.

    Returns (model, init_fn, step_fn, eval_fn) like make_vjepa_workload."""
    from smb_vision_tpu.models.pipelined import (
        to_pipeline_vjepa_params,
        vjepa2_pipeline_pretrain,
    )
    from smb_vision_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS

    if config.sequence_parallel:
        raise ValueError("pipeline parallelism composes with the data "
                         "axis, not sequence parallelism; unset "
                         "config.sequence_parallel")
    model = VJEPA2Model(config)
    batch_axis = DATA_AXIS if mesh.shape[DATA_AXIS] > 1 else None

    def gen_mask(key, batch):
        return vjepa_target_mask(key, batch, grid=config.grid,
                                 pred_mask_scale=pred_mask_scale,
                                 aspect_ratio=aspect_ratio,
                                 num_blocks=num_blocks,
                                 inv_block=inv_block)

    def init_fn(key):
        from smb_vision_tpu.parallel.mesh import init_batch_size

        b = init_batch_size()  # data-axis rows when SP pins batch to it
        px = jnp.zeros((b, config.frames_per_clip, config.in_chans,
                        config.crop_size, config.crop_size), jnp.float32)
        tb = gen_mask(key, b)
        dense = jax.jit(
            lambda k, x, t: model.init(k, x, target_bool=t))(key, px, tb)
        params = to_pipeline_vjepa_params(dense)
        teacher = jax.tree_util.tree_map(jnp.copy, params)
        return train_state(params, tx.init(params), teacher=teacher)

    def loss_for(params, teacher, px, key, microbatches,
                 deterministic=False, valid=None):
        # mask/droppath key split mirrors the dense loss_for above;
        # stochastic depth rides the pipeline as stacked per-layer
        # rates+keys (models/pipelined._pipe_stack_droppath)
        mask_key, dp_key = jax.random.split(key)
        tb = gen_mask(mask_key, px.shape[0])
        dp_rng = None if deterministic else dp_key
        return vjepa2_pipeline_pretrain(
            config, params, teacher, px, tb, mesh=mesh, axis=MODEL_AXIS,
            num_microbatches=microbatches, batch_axis=batch_axis,
            remat=remat, dp_rng=dp_rng, valid=valid)

    def step_fn(state, batch, key):
        teacher = state["teacher"]

        def loss_fn(p):
            return loss_for(p, teacher, batch["pixel_values"], key,
                            num_microbatches)

        loss, grads = jax.value_and_grad(loss_fn)(state["params"])
        updates, opt_state = tx.update(grads, state["opt_state"],
                                       state["params"])
        params = optax.apply_updates(state["params"], updates)
        teacher = ema_update(teacher, params, ema_momentum)
        new_state = dict(state)
        new_state.update(params=params, opt_state=opt_state,
                         teacher=teacher, step=state["step"] + 1)
        return new_state, {"loss": loss}

    @jax.jit
    def eval_fn(state, batch):
        loss = loss_for(state["params"], state["teacher"],
                        batch["pixel_values"], jax.random.PRNGKey(0),
                        eval_microbatches or num_microbatches,
                        deterministic=True,
                        valid=batch.get("valid_mask"))
        return {"loss": loss}

    return model, init_fn, step_fn, eval_fn
