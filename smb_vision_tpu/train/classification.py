"""Classification / multilabel / regression / survival (Cox) fine-tuning
workload (reference run_classification.py).

Task types and label plumbing match the reference collate_fn (:227-271):
- classification: int labels, CE
- multilabel_classification: (B, L) float multi-hot, BCE
- regression: float, MSE
- survival / cox_regression: {duration: 'os', event: 'os_event'} -> Cox
  partial likelihood (within-batch; batches stay on one data shard or the
  risk scores are implicitly all-gathered by GSPMD since the loss is over
  the global batch — both correct under jit)."""

from __future__ import annotations

from typing import Dict, List, Optional

import jax
import jax.numpy as jnp
import numpy as np
import optax

from smb_vision_tpu.train.losses import cox_loss
from smb_vision_tpu.train.trainer import train_state

TASK_TYPES = ("classification", "multilabel_classification", "regression",
              "survival", "cox_regression")


def init_model_params(model, config, key, example_batch):
    """Jitted model.init over a 1-sample slice of the example batch —
    params ONLY, no optimizer state. The LoRA path uses this to build the
    frozen base: calling the workload init there would materialise a full
    AdamW mu/nu (2x the model in f32) just to throw it away — exactly the
    transient that can OOM the configs LoRA exists for."""
    supports_features = config.model_type == "videomae"

    def init(k, b):
        kwargs = {}
        if supports_features and "additional_features" in b:
            kwargs["additional_features"] = b["additional_features"]
        return model.init(k, b["pixel_values"], labels=None, **kwargs)

    return jax.jit(init)(key, jax.tree_util.tree_map(
        lambda x: jnp.asarray(x)[:1], example_batch))


def problem_type_for(task_type: str, num_labels: int) -> Optional[str]:
    """config mutation logic of run_classification.py:452-476."""
    if task_type == "classification":
        return "single_label_classification"
    if task_type == "multilabel_classification":
        return "multi_label_classification"
    if task_type == "regression":
        return "regression"
    return None  # survival: loss handled by the workload, head is 1-logit


def collate_classification(examples: List[Dict], *, task_type: str,
                           label_columns: List[str],
                           additional_feature_columns: Optional[List[str]]
                           ) -> Dict[str, np.ndarray]:
    """Batch dict matching the reference collate (run_classification.py:
    227-271), numpy instead of torch."""
    out = {"pixel_values": np.stack([e["image"] for e in examples])}
    if "image_scale" in examples[0]:
        # uint8-shipped pixels (CTDataset out_dtype='uint8'): per-sample
        # affine decoded on device by quantization.dequantize_batch
        out["pixel_scale"] = np.asarray(
            [e["image_scale"] for e in examples], np.float32)
        out["pixel_offset"] = np.asarray(
            [e["image_offset"] for e in examples], np.float32)
    if additional_feature_columns:
        out["additional_features"] = np.asarray(
            [[float(e[c]) for c in additional_feature_columns]
             for e in examples], dtype=np.float32)
    if task_type == "multilabel_classification":
        out["labels"] = np.asarray(
            [[float(e[c]) for c in label_columns] for e in examples],
            dtype=np.float32)
    elif task_type in ("survival", "cox_regression"):
        out["duration"] = np.asarray([float(e["os"]) for e in examples],
                                     dtype=np.float32)
        out["event"] = np.asarray([float(e["os_event"]) for e in examples],
                                  dtype=np.float32)
    else:
        col = label_columns[0]
        vals = [e[col] for e in examples]
        if task_type == "regression":
            out["labels"] = np.asarray(vals, dtype=np.float32)
        else:
            out["labels"] = np.asarray(vals, dtype=np.int32)
    return out


def make_classification_workload(model, config, *, task_type: str,
                                 tx: optax.GradientTransformation,
                                 grad_accum: int = 1, accum_dtype=None):
    """model: VideoMAEForVideoClassification | Dinov2ForImageClassification
    (module, already built with problem_type set in its config).

    grad_accum > 1 splits the (global) batch into microbatches via
    accumulate_gradients — matching run_cls.sh recipes that rely on HF
    Trainer's gradient_accumulation_steps. Note survival/Cox partial
    likelihood is computed per-microbatch (within-microbatch risk sets),
    which is also the reference-under-accumulation behaviour."""
    from smb_vision_tpu.train.trainer import accumulate_gradients

    if getattr(config, "quant8", False):
        raise ValueError(
            "quant8 is an inference-only fast path: the W8A8 rounding has "
            "zero gradient almost everywhere. Unset config.quant8 for "
            "fine-tuning.")
    survival = task_type in ("survival", "cox_regression")
    # only the VideoMAE head fuses tabular features (ref :928-937)
    supports_features = config.model_type == "videomae"

    def _apply(params, batch, deterministic, key=None):
        kwargs = {}
        if supports_features and "additional_features" in batch:
            kwargs["additional_features"] = batch["additional_features"]
        labels = None if survival else batch.get("labels")
        if key is not None and not deterministic:
            # stochastic-depth rng (DropPath calls make_rng('droppath')
            # when drop_path_rate > 0; unused rngs are harmless)
            kwargs["rngs"] = {"droppath": key}
        return model.apply(params, batch["pixel_values"], labels=labels,
                           deterministic=deterministic, **kwargs)

    def init_fn(key, example_batch):
        params = init_model_params(model, config, key, example_batch)
        return train_state(params, tx.init(params))

    def loss_of(params, batch, deterministic=False, key=None):
        out = _apply(params, batch, deterministic, key)
        # valid_mask is injected by the trainer's eval padding (absent in
        # train batches): padded duplicate rows must leave the loss — the
        # Cox risk sets AND the per-row CE/MSE/BCE means (the final ragged
        # batch would otherwise over-weight its duplicated last row)
        valid = batch.get("valid_mask")
        if survival:
            risk = out["logits"].squeeze(-1)
            return cox_loss(risk, batch["duration"], batch["event"],
                            valid=valid), out
        if valid is None:
            return out["loss"], out
        from smb_vision_tpu.models.videomae import classification_loss

        return classification_loss(
            out["logits"], batch["labels"], config.num_labels,
            getattr(config, "problem_type", None), valid=valid), out

    def loss_fn(params, b, key):
        loss, _ = loss_of(params, b, key=key)
        return loss, None

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
    def _eval_logits(state, batch):
        loss, out = loss_of(state["params"], batch, deterministic=True)
        return loss, out["logits"]

    def eval_fn(state, batch):
        loss, logits = _eval_logits(state, batch)
        if survival:
            labels = {"duration": np.asarray(batch["duration"]),
                      "event": np.asarray(batch["event"])}
        else:
            labels = np.asarray(batch["labels"])
        return {"loss": loss, "logits": logits, "labels": labels}

    return init_fn, step_fn, eval_fn
