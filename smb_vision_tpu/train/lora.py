"""LoRA fine-tuning.

The reference defined LoRA-aware checkpointing (VisionTrainer._save_checkpoint
saving non_lora_state_dict.bin, /root/reference/src/train/trainer.py:171-222;
get_peft_state_* in train_utils.py:29-59) but never wired it — the
`lora_enable` flag existed nowhere (SURVEY §2 item 3). Here LoRA is
first-class and functional:

- `init_lora(params, rank, targets)` builds A/B adapter params for every
  kernel whose path matches the target regex (q/k/v/proj and MLP denses by
  default). A ~ N(0, 1/rank), B = 0 — so the adapted model starts exactly
  at the base model.
- `merge_lora(params, lora)` returns effective params with
  W' = W + (alpha/rank) * A @ B; used inside the loss so gradients flow to
  the adapters only (base params get stop_gradient).
- the train step optimises ONLY the adapter (+ head) params; checkpoints
  store adapters separately (the non-LoRA/LoRA split of the reference).
"""

from __future__ import annotations

import re
from typing import Any, Dict

import jax
import jax.numpy as jnp

DEFAULT_TARGETS = (r"attention/(query|key|value|proj)/kernel$"
                   r"|mlp/(fc1|fc2|weights_in|weights_out)/kernel$")
# weights_in/weights_out are the SwiGLU MLP kernels (models/layers.py) —
# the TP sharding rules in parallel/sharding.py name the same set


def _paths(params):
    return jax.tree_util.tree_flatten_with_path(params)[0]


def _path_str(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def init_lora(params, key, rank: int = 8,
              targets: str = DEFAULT_TARGETS) -> Dict:
    """Flat dict {path_str: {"a": (in, r), "b": (r, out)}}."""
    pat = re.compile(targets)
    lora: Dict[str, Dict[str, jax.Array]] = {}
    for path, leaf in _paths(params):
        name = _path_str(path)
        if pat.search(name) and leaf.ndim == 2:
            key, sub = jax.random.split(key)
            fan_in, fan_out = leaf.shape
            lora[name] = {
                "a": jax.random.normal(sub, (fan_in, rank),
                                       jnp.float32) / jnp.sqrt(rank),
                "b": jnp.zeros((rank, fan_out), jnp.float32),
            }
    if not lora:
        raise ValueError(
            f"no parameters matched LoRA targets {targets!r} — adapters "
            "would train nothing; check the target regex against the "
            "model's param paths")
    return lora


HEAD_REGEX = r"classifier|fc_norm|pooler"


def split_head(params, head_regex: str = HEAD_REGEX) -> Dict[str, Any]:
    """Flat dict of head params (trained directly alongside adapters).
    Copied, not aliased — the train step donates the whole state and a
    buffer shared between base params and trainable head would be donated
    twice."""
    pat = re.compile(head_regex)
    return {_path_str(p): jnp.array(leaf) for p, leaf in _paths(params)
            if pat.search(_path_str(p))}


def merge_lora(params, trainable: Dict, alpha: float = 16.0,
               rank: int = 8, train: bool = True):
    """Effective params from frozen base + trainable
    {"adapters": {name: {a, b}}, "head": {name: array}}:
    adapted kernels get W + (alpha/rank) A@B; head leaves are substituted;
    everything else is stop_gradient'ed base (when train=True)."""
    adapters = trainable.get("adapters", {})
    head = trainable.get("head", {})
    meta = trainable.get("meta")
    if meta is not None:
        # merge hyperparameters are configuration, not parameters: never let
        # gradients (or optimizer weight decay) reach them
        scale = jax.lax.stop_gradient(meta["alpha"] / meta["rank"])
    else:
        scale = alpha / rank
    flat, treedef = jax.tree_util.tree_flatten_with_path(params)
    out = []
    for path, leaf in flat:
        name = _path_str(path)
        if name in adapters:
            base = jax.lax.stop_gradient(leaf) if train else leaf
            delta = (adapters[name]["a"] @ adapters[name]["b"]) * scale
            out.append(base + delta.astype(leaf.dtype))
        elif name in head:
            out.append(head[name])
        else:
            out.append(jax.lax.stop_gradient(leaf) if train else leaf)
    return jax.tree_util.tree_unflatten(treedef, out)


def lora_size(trainable: Dict) -> int:
    adapters = trainable.get("adapters", trainable)
    return sum(v["a"].size + v["b"].size for v in adapters.values())


def make_lora_classification_workload(model, config, *, task_type: str, tx,
                                      rank: int = 8, alpha: float = 16.0,
                                      targets: str = DEFAULT_TARGETS,
                                      grad_accum: int = 1,
                                      accum_dtype=None):
    """Classification workload where only LoRA adapters + head train.
    State: {'params' (frozen base), 'lora', 'lora_meta', ...}."""
    import optax

    if getattr(config, "quant8", False):
        raise ValueError(
            "quant8 is an inference-only fast path: the W8A8 rounding has "
            "zero gradient almost everywhere, so LoRA adapters behind "
            "QuantDense would silently stop learning. Unset config.quant8 "
            "for fine-tuning.")

    from smb_vision_tpu.train.losses import cox_loss
    from smb_vision_tpu.train.trainer import accumulate_gradients, train_state

    survival = task_type in ("survival", "cox_regression")
    supports_features = config.model_type == "videomae"

    def _apply(params, batch, deterministic, key=None):
        kwargs = {}
        if supports_features and "additional_features" in batch:
            kwargs["additional_features"] = batch["additional_features"]
        labels = None if survival else batch.get("labels")
        if key is not None and not deterministic:
            kwargs["rngs"] = {"droppath": key}
        return model.apply(params, batch["pixel_values"], labels=labels,
                           deterministic=deterministic, **kwargs)

    def init_fn(key, example_batch, base_params):
        k1, _ = jax.random.split(key)
        # the optimized pytree holds ONLY adapters + head; merge hyperparams
        # live in a separate non-trained state extra (they previously sat
        # inside the trainable tree, where AdamW weight decay silently
        # drifted them every step)
        trainable = {
            "adapters": init_lora(base_params, k1, rank=rank,
                                  targets=targets),
            "head": split_head(base_params),
        }
        opt_state = tx.init(trainable)
        return train_state(base_params, opt_state, lora=trainable,
                           lora_meta={"alpha": jnp.float32(alpha),
                                      "rank": jnp.float32(rank)})

    def loss_of(state_params, trainable, batch, deterministic=False,
                key=None):
        eff = merge_lora(state_params, trainable, alpha=alpha, rank=rank,
                         train=not deterministic)
        out = _apply(eff, batch, deterministic, key)
        # valid_mask comes from the trainer's eval padding: padded rows
        # must not sit in the Cox risk sets nor the per-row loss means
        # (train batches lack the key)
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

    def step_fn(state, batch, key):
        def f(trainable, b, k):
            return loss_of(state["params"], trainable, b, key=k)[0], None

        loss, _, grads = accumulate_gradients(
            f, state["lora"], batch, key, grad_accum,
            accum_dtype=accum_dtype)
        updates, opt_state = tx.update(grads, state["opt_state"],
                                       state["lora"])
        trainable = optax.apply_updates(state["lora"], updates)
        new_state = dict(state)
        new_state.update(lora=trainable, opt_state=opt_state,
                         step=state["step"] + 1)
        return new_state, {"loss": loss}

    # jitted ONCE at factory time: building jax.jit(lambda ...) inside
    # eval_fn would retrace (and recompile) on every eval batch
    _eval_loss = jax.jit(
        lambda p, l, b: loss_of(p, l, b, deterministic=True))

    def eval_fn(state, batch):
        import numpy as np

        loss, out = _eval_loss(state["params"], state["lora"], batch)
        labels = ({"duration": np.asarray(batch["duration"]),
                   "event": np.asarray(batch["event"])} if survival
                  else np.asarray(batch["labels"]))
        return {"loss": loss, "logits": out["logits"], "labels": labels}

    return init_fn, step_fn, eval_fn
