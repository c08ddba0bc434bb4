"""Fine-tuning CLI: classification | multilabel_classification | regression
| survival | cox_regression — the JAX run_classification.py
(reference /root/reference/src/run_classification.py).

Parity points: task-type dispatch (:108-113), tabular additional_features
fused at the head (:239-247), two-tier LR vision_lr/merger_lr (:213-224 —
actually wired here, the reference's VisionTrainer was orphaned), model
dispatch 'dino' in name -> DINOv2 else VideoMAE (:481-504), metric suite
(C-index / micro-F1 / acc+AUC / MSE, :274-361)."""

from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import List, Optional

from smb_vision_tpu.utils.args import parse_args_into_dataclasses
from smb_vision_tpu.utils.logging import get_logger

logger = get_logger("run_classification")


@dataclass
class DataTrainingArguments:
    train_data_path: Optional[str] = None
    val_data_path: Optional[str] = None
    task_type: str = field(default="classification", metadata={"help":
        "classification | multilabel_classification | regression | "
        "survival | cox_regression"})
    num_labels: int = 2
    label_columns: List[str] = field(default_factory=lambda: ["label"])
    additional_feature_columns: List[str] = field(default_factory=list)
    max_train_samples: Optional[int] = None
    max_eval_samples: Optional[int] = None
    cache_data_dir: Optional[str] = None
    cache_dtype: str = "float32"
    num_workers: int = 8


@dataclass
class ModelArguments:
    model_name_or_path: Optional[str] = field(
        default=None, metadata={"help":
            "safetensors backbone checkpoint; 'dino'/'vjepa' in the name "
            "select those routes when model_type=auto"})
    model_type: str = field(default="auto", metadata={
        "help": "auto | videomae | dinov2 | vjepa2"})
    config_name_or_path: Optional[str] = None
    image_size: int = 224
    depth: int = 160
    patch_size: int = 16
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    dtype: str = "bfloat16"
    attn_impl: str = "auto"    # auto | xla
    gradient_checkpointing: bool = False
    # LoRA (the reference's latent lora_enable path, now functional)
    lora_enable: bool = False
    lora_rank: int = 8
    lora_alpha: float = 16.0



def _explicit_impl_args(model_args) -> dict:
    """Only-if-explicit CLI overrides for --config_name_or_path mode
    (see run_mim.build_config): a config file pinning attn_impl,
    dtype, or gradient_checkpointing must not be silently reverted by
    the CLI defaults (round-5 review)."""
    from dataclasses import fields as dc_fields
    defaults = {f.name: f.default for f in dc_fields(ModelArguments)}
    return {k: getattr(model_args, k)
            for k in ("dtype", "attn_impl", "gradient_checkpointing")
            if getattr(model_args, k) != defaults[k]}


def main(argv=None):
    import jax
    import numpy as np

    from smb_vision_tpu.data.dataset import BatchLoader, CTDataset
    from smb_vision_tpu.data.preprocess import CT_PIPELINES, PreprocessConfig
    from smb_vision_tpu.models.configs import Dinov2Config, VideoMAEConfig
    from smb_vision_tpu.models.dinov2 import Dinov2ForImageClassification
    from smb_vision_tpu.models.videomae import VideoMAEForVideoClassification
    from smb_vision_tpu.train.classification import (
        collate_classification,
        make_classification_workload,
        problem_type_for,
    )
    from smb_vision_tpu.train.metrics import compute_metrics
    from smb_vision_tpu.train.optim import make_optimizer
    from smb_vision_tpu.train.trainer import Trainer, TrainingArguments

    model_args, data_args, training_args = parse_args_into_dataclasses(
        (ModelArguments, DataTrainingArguments, TrainingArguments), argv)
    from smb_vision_tpu.parallel.mesh import maybe_initialize_distributed
    from smb_vision_tpu.utils.compile_cache import setup_compile_cache
    setup_compile_cache()
    maybe_initialize_distributed(training_args.multihost)
    if data_args.additional_feature_columns == [""]:
        data_args.additional_feature_columns = []

    cfg_file = None
    if model_args.config_name_or_path:
        import json as _json

        with open(model_args.config_name_or_path) as fh:
            cfg_file = _json.load(fh)

    mtype = model_args.model_type
    if mtype == "auto":
        if cfg_file and cfg_file.get("model_type") in (
                "videomae", "dinov2", "vjepa2"):
            mtype = cfg_file["model_type"]
        else:
            name = (model_args.model_name_or_path or "").lower()
            mtype = ("dinov2" if "dino" in name
                     else "vjepa2" if "vjepa" in name else "videomae")
    survival = data_args.task_type in ("survival", "cox_regression")
    num_labels = 1 if survival or data_args.task_type == "regression" \
        else (len(data_args.label_columns)
              if data_args.task_type == "multilabel_classification"
              else data_args.num_labels)

    common = dict(
        image_size=model_args.image_size, patch_size=model_args.patch_size,
        hidden_size=model_args.hidden_size,
        num_hidden_layers=model_args.num_hidden_layers,
        num_attention_heads=model_args.num_attention_heads,
        num_labels=num_labels,
        dtype=model_args.dtype, attn_impl=model_args.attn_impl,
        gradient_checkpointing=model_args.gradient_checkpointing)
    feat = dict(
        additional_features_size=len(data_args.additional_feature_columns),
        problem_type=problem_type_for(data_args.task_type, num_labels))
    if mtype != "videomae" and model_args.intermediate_size != 3072:
        logger.warning(
            "--intermediate_size is only consumed by the videomae route; "
            "the %s config sizes its MLP from mlp_ratio — use "
            "--config_name_or_path or that field instead", mtype)

    if mtype == "dinov2":
        if cfg_file is not None:
            config = Dinov2Config.from_dict(cfg_file)
            config.update({"num_labels": num_labels, **feat,
                           **_explicit_impl_args(model_args)})
        else:
            config = Dinov2Config(depth=model_args.depth, **common, **feat)
        model = Dinov2ForImageClassification(config)
        pipeline_key = "dinov2"
        img_size, vol_depth = config.image_size, config.depth
    elif mtype == "vjepa2":
        from smb_vision_tpu.models.configs import VJEPA2Config
        from smb_vision_tpu.models.vjepa import VJEPA2ForVideoClassification

        if cfg_file is not None:
            config = VJEPA2Config.from_dict(cfg_file)
            config.update({"num_labels": num_labels,
                           "problem_type": feat["problem_type"],
                           **_explicit_impl_args(model_args)})
        else:
            cm = dict(common)
            cm["crop_size"] = cm.pop("image_size")
            config = VJEPA2Config(
                frames_per_clip=model_args.depth, in_chans=1,
                tubelet_size=model_args.patch_size, **cm)
        model = VJEPA2ForVideoClassification(config)
        pipeline_key = "smb-vision"
        img_size, vol_depth = config.crop_size, config.frames_per_clip
        if data_args.additional_feature_columns:
            logger.warning("vjepa2 route pools with an attentive pooler and "
                           "does not fuse tabular features; ignoring "
                           "additional_feature_columns")
            data_args.additional_feature_columns = []
    else:
        if cfg_file is not None:
            config = VideoMAEConfig.from_dict(cfg_file)
            config.update({"num_labels": num_labels, **feat,
                           **_explicit_impl_args(model_args)})
        else:
            config = VideoMAEConfig(
                num_frames=model_args.depth, num_channels=1,
                tubelet_size=model_args.patch_size,
                intermediate_size=model_args.intermediate_size,
                **common, **feat)
        model = VideoMAEForVideoClassification(config)
        pipeline_key = "smb-vision"
        img_size, vol_depth = config.image_size, config.num_frames

    pipe = PreprocessConfig(
        target_spacing=CT_PIPELINES[pipeline_key].target_spacing,
        target_size=(img_size, img_size, vol_depth),
        layout=CT_PIPELINES[pipeline_key].layout)

    out_dt = training_args.input_dtype    # no host f16->f32->bf16 trip
    train_ds = None
    if training_args.do_train:
        if not data_args.train_data_path:
            raise SystemExit("--train_data_path is required with "
                             "--do_train")
        train_ds = CTDataset(data_args.train_data_path, split="train",
                             pipeline=pipe,
                             cache_dir=data_args.cache_data_dir,
                             cache_dtype=data_args.cache_dtype,
                             out_dtype=out_dt,
                             max_samples=data_args.max_train_samples)
    eval_ds = (CTDataset(data_args.val_data_path, split="validation",
                         pipeline=pipe, cache_dir=data_args.cache_data_dir,
                         cache_dtype=data_args.cache_dtype,
                         out_dtype=out_dt,
                         max_samples=data_args.max_eval_samples)
               if data_args.val_data_path else None)

    collate = functools.partial(
        collate_classification, task_type=data_args.task_type,
        label_columns=data_args.label_columns,
        additional_feature_columns=data_args.additional_feature_columns)
    if jax.process_count() > 1 and train_ds is not None:
        # multi-host data sharding (the reference's partition_dataset over
        # world size, mim.py:190-204)
        from smb_vision_tpu.data.dataset import partition_items

        train_ds.items = partition_items(
            train_ds.items, jax.process_count(), jax.process_index())

    n_data = jax.device_count() // max(training_args.model_parallel, 1)
    train_loader = BatchLoader(
        train_ds, training_args.per_device_train_batch_size
        * n_data * training_args.gradient_accumulation_steps,
        shuffle=True, seed=training_args.seed,
        num_workers=data_args.num_workers,
        collate=collate) if train_ds is not None else None
    eval_loader = (BatchLoader(eval_ds,
                               training_args.per_device_eval_batch_size
                               * n_data, collate=collate,
                               num_workers=data_args.num_workers,
                               drop_last=False)
                   if eval_ds and len(eval_ds) else None)

    total_steps = training_args.num_train_steps or int(
        (len(train_loader) if train_loader is not None else 1)
        * training_args.num_train_epochs) or 1
    tx = make_optimizer(
        learning_rate=training_args.learning_rate, total_steps=total_steps,
        weight_decay=training_args.weight_decay,
        warmup_ratio=training_args.warmup_ratio,
        warmup_steps=training_args.warmup_steps,
        schedule=training_args.lr_scheduler_type,
        optim=training_args.optim,
        min_lr=training_args.min_lr, grad_clip=training_args.max_grad_norm,
        vision_lr=training_args.vision_lr, merger_lr=training_args.merger_lr)

    if train_ds is not None:
        example = collate([train_ds[0]])
    elif eval_ds is not None and len(eval_ds):
        example = collate([eval_ds[0]])   # eval-only: init from val data
    else:
        raise SystemExit("nothing to do: need --train_data_path with "
                         "--do_train, or --val_data_path with --do_eval")
    key = jax.random.PRNGKey(training_args.seed)

    if model_args.lora_enable:
        from smb_vision_tpu.train.lora import (
            lora_size,
            make_lora_classification_workload,
        )

        # base params ONLY (+ optional backbone graft), then frozen — the
        # workload init would also materialise a full-model AdamW state
        # (2x the model in f32) just to discard it
        from smb_vision_tpu.train.classification import init_model_params

        base_params = init_model_params(model, config, key, example)
        if model_args.model_name_or_path:
            from smb_vision_tpu.models.convert import load_backbone_into

            base_params = load_backbone_into(
                base_params, model_args.model_name_or_path)
        init_fn, step_fn, eval_fn = make_lora_classification_workload(
            model, config, task_type=data_args.task_type, tx=tx,
            rank=model_args.lora_rank, alpha=model_args.lora_alpha,
            grad_accum=training_args.gradient_accumulation_steps,
            accum_dtype=training_args.grad_accum_dtype)
        state = init_fn(key, example, base_params)
        logger.info("LoRA rank %d: %d adapter params trainable",
                    model_args.lora_rank, lora_size(state["lora"]))
    else:
        init_fn, step_fn, eval_fn = make_classification_workload(
            model, config, task_type=data_args.task_type, tx=tx,
            grad_accum=training_args.gradient_accumulation_steps,
            accum_dtype=training_args.grad_accum_dtype)
        state = init_fn(key, example)
        if model_args.model_name_or_path:
            from smb_vision_tpu.models.convert import load_backbone_into

            state["params"] = load_backbone_into(
                state["params"], model_args.model_name_or_path)
            logger.info("backbone initialised from %s",
                        model_args.model_name_or_path)

    trainer = Trainer(
        args=training_args, state=state, step_fn=step_fn,
        train_loader=train_loader, eval_loader=eval_loader, eval_fn=eval_fn,
        compute_metrics=functools.partial(compute_metrics,
                                          data_args.task_type))
    if training_args.do_train:
        result = trainer.train()
        trainer.save_model()
        config.save_json(trainer.out_dir / "config.json")
        logger.info("train complete: %s", result)
    if training_args.do_eval:
        logger.info("eval: %s", trainer.evaluate())


if __name__ == "__main__":
    main()
