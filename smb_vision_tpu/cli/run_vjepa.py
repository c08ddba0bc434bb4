"""V-JEPA2 pretraining CLI — the JAX run_vjepa.py
(reference /root/reference/src/run_vjepa.py).

Recipe parity (run_vjepa.sh:16-42): 384^2x256 @ spacing (1.0,1.0,1.5),
in_chans=1, tubelet=patch, bf16, EMA momentum 0.99925, cosine LR.
Fixes vs reference (SURVEY §2 item 5): per-sample masks, EMA once per
optimizer step (see train/vjepa.py)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from smb_vision_tpu.utils.args import parse_args_into_dataclasses
from smb_vision_tpu.utils.logging import get_logger

logger = get_logger("run_vjepa")


@dataclass
class DataTrainingArguments:
    data_path: Optional[str] = field(
        default=None, metadata={"help": "The local data path."})
    train_split: str = "train"
    validation_split: str = "validation"
    max_train_samples: Optional[int] = None
    cache_data_dir: Optional[str] = None
    cache_dtype: str = "float32"
    num_workers: int = 8
    device_cache: bool = False    # pin volumes in device memory
    num_mask_blocks: int = 3
    inv_block: bool = False


@dataclass
class ModelArguments:
    model_name_or_path: Optional[str] = None
    config_name_or_path: Optional[str] = None
    config_overrides: Optional[str] = field(
        default=None,
        metadata={"help": "comma list key=value applied to the config "
                          "AFTER the only-if-explicit CLI merge (the "
                          "escape hatch to force a default over a "
                          "config-file pin)"})
    image_size: int = 384
    depth: int = 256
    patch_size: int = 16
    hidden_size: int = 1024
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    pred_hidden_size: int = 384
    pred_num_hidden_layers: int = 12
    pred_num_attention_heads: int = 12
    ema_momentum: float = 0.99925
    dtype: str = "bfloat16"
    attn_impl: str = field(
        default="auto",
        metadata={"help": "attention: auto (cuDNN fused attention on the "
                          "GPU where dtype and head dim allow, else XLA) "
                          "| xla"})
    gradient_checkpointing: bool = False
    sequence_parallel: bool = False
    export_hf: bool = False
    pipeline_stages: int = field(
        default=1,
        metadata={"help": "GPipe-pipeline the student encoder, EMA "
                          "teacher, and predictor stacks over this many "
                          "stages (the mesh model axis). Encoder and "
                          "predictor layer counts must divide by it; "
                          "microbatching replaces gradient accumulation"})
    pipeline_microbatches: int = field(
        default=0,
        metadata={"help": "microbatches per step through the pipeline "
                          "(0 = per_device_train_batch_size)"})


def build_config(model_args: ModelArguments):
    from smb_vision_tpu.models.configs import VJEPA2Config

    from dataclasses import fields as dc_fields

    from_file = bool(model_args.config_name_or_path)
    if from_file:
        config = VJEPA2Config.from_json(model_args.config_name_or_path)
    else:
        config = VJEPA2Config(
            hidden_size=model_args.hidden_size,
            num_hidden_layers=model_args.num_hidden_layers,
            num_attention_heads=model_args.num_attention_heads,
            pred_hidden_size=model_args.pred_hidden_size,
            pred_num_hidden_layers=model_args.pred_num_hidden_layers,
            pred_num_attention_heads=model_args.pred_num_attention_heads)
    # reference config mutation (run_vjepa.py:221-233). A config FILE's
    # geometry is authoritative — only explicitly-changed CLI flags
    # (values differing from the dataclass defaults) override it (see
    # run_mim.build_config).
    defaults = {f.name: f.default for f in dc_fields(type(model_args))}
    geometry = {
        "image_size": ("image_size", model_args.image_size),
        "crop_size": ("image_size", model_args.image_size),
        "patch_size": ("patch_size", model_args.patch_size),
        "frames_per_clip": ("depth", model_args.depth),
        "tubelet_size": ("patch_size", model_args.patch_size),
        # attention impl / dtype / remat get the same only-if-explicit
        # guard (see run_mim.build_config; --config_overrides forces a
        # default over a file pin)
        "attn_impl": ("attn_impl", model_args.attn_impl),
        "dtype": ("dtype", model_args.dtype),
        "gradient_checkpointing": ("gradient_checkpointing",
                                   model_args.gradient_checkpointing),
        "sequence_parallel": ("sequence_parallel",
                              model_args.sequence_parallel),
    }
    upd = {k: v for k, (arg, v) in geometry.items()
           if not from_file or v != defaults[arg]}
    if not from_file:
        upd["in_chans"] = 1
    config.update(upd)
    if model_args.config_overrides:
        import json as _json
        for kv in model_args.config_overrides.split(","):
            k, v = kv.split("=", 1)
            try:
                v = _json.loads(v)
            except _json.JSONDecodeError:
                pass
            config.update({k.strip(): v})
    return config


def main(argv=None):
    import jax

    from smb_vision_tpu.data.dataset import BatchLoader, CTDataset
    from smb_vision_tpu.data.preprocess import CT_PIPELINES, PreprocessConfig
    from smb_vision_tpu.train.optim import make_optimizer
    from smb_vision_tpu.train.trainer import Trainer, TrainingArguments
    from smb_vision_tpu.train.vjepa import make_vjepa_workload

    model_args, data_args, training_args = parse_args_into_dataclasses(
        (ModelArguments, DataTrainingArguments, TrainingArguments), argv)
    from smb_vision_tpu.parallel.mesh import maybe_initialize_distributed
    from smb_vision_tpu.utils.compile_cache import setup_compile_cache
    setup_compile_cache()
    maybe_initialize_distributed(training_args.multihost)
    config = build_config(model_args)
    logger.info("VJEPA config: %s tokens, grid %s", config.seq_len,
                config.grid)

    pipelined = model_args.pipeline_stages > 1
    eval_mb = 1
    if pipelined:
        if training_args.gradient_accumulation_steps > 1:
            raise SystemExit(
                "--pipeline_stages replaces gradient accumulation with "
                "microbatching (--pipeline_microbatches); set "
                "--gradient_accumulation_steps 1")
        training_args.model_parallel = model_args.pipeline_stages
        if "pipeline" not in training_args.sharding_policy:
            # composites like "pipeline+fsdp" pass through unchanged
            logger.info("pipeline_stages=%d: sharding_policy -> 'pipeline'",
                        model_args.pipeline_stages)
            training_args.sharding_policy = "pipeline"

    pipe = PreprocessConfig(
        target_spacing=CT_PIPELINES["vjepa"].target_spacing,
        target_size=(config.crop_size, config.crop_size,
                     config.frames_per_clip))
    out_dt = training_args.input_dtype    # no host f16->f32->bf16 trip
    train_ds = CTDataset(data_args.data_path, split=data_args.train_split,
                         pipeline=pipe, cache_dir=data_args.cache_data_dir,
                         cache_dtype=data_args.cache_dtype,
                         out_dtype=out_dt,
                         max_samples=data_args.max_train_samples)
    try:
        eval_ds = CTDataset(data_args.data_path,
                            split=data_args.validation_split,
                            pipeline=pipe,
                            cache_dir=data_args.cache_data_dir,
                            cache_dtype=data_args.cache_dtype,
                            out_dtype=out_dt)
    except (ValueError, FileNotFoundError):
        eval_ds = None

    if jax.process_count() > 1:
        # multi-host data sharding (the reference's partition_dataset over
        # world size, mim.py:190-204)
        from smb_vision_tpu.data.dataset import partition_items

        train_ds.items = partition_items(
            train_ds.items, jax.process_count(), jax.process_index())

    n_data = jax.device_count() // max(training_args.model_parallel, 1)
    if data_args.device_cache:
        from smb_vision_tpu.data.dataset import DeviceCachedBatchLoader

        train_loader = DeviceCachedBatchLoader(
            train_ds, training_args.per_device_train_batch_size
            * n_data * training_args.gradient_accumulation_steps,
            shuffle=True, seed=training_args.seed,
            input_dtype=training_args.input_dtype)
    else:
        train_loader = BatchLoader(
            train_ds, training_args.per_device_train_batch_size
            * n_data * training_args.gradient_accumulation_steps,
            shuffle=True, seed=training_args.seed,
            num_workers=data_args.num_workers)
    eval_loader = (BatchLoader(eval_ds,
                               training_args.per_device_eval_batch_size
                               * n_data,
                               num_workers=data_args.num_workers,
                               drop_last=False)
                   if eval_ds and len(eval_ds) else None)
    total_steps = training_args.num_train_steps or int(
        len(train_loader) * training_args.num_train_epochs)

    tx = make_optimizer(
        learning_rate=training_args.learning_rate, total_steps=total_steps,
        weight_decay=training_args.weight_decay,
        warmup_ratio=training_args.warmup_ratio,
        warmup_steps=training_args.warmup_steps,
        schedule=training_args.lr_scheduler_type,
        optim=training_args.optim,
        min_lr=training_args.min_lr, grad_clip=training_args.max_grad_norm)
    from smb_vision_tpu.parallel.mesh import create_mesh

    mesh = create_mesh(model=training_args.model_parallel)
    if pipelined:
        import math

        from smb_vision_tpu.train.vjepa import make_pipelined_vjepa_workload

        n_microbatches = (model_args.pipeline_microbatches
                          or training_args.per_device_train_batch_size)
        model, init_fn, step_fn, eval_fn = make_pipelined_vjepa_workload(
            config, tx=tx, mesh=mesh, num_microbatches=n_microbatches,
            eval_microbatches=(eval_mb := math.gcd(
                n_microbatches,
                training_args.per_device_eval_batch_size)),
            ema_momentum=model_args.ema_momentum,
            num_blocks=data_args.num_mask_blocks,
            inv_block=data_args.inv_block)
        logger.info("pipelined pretraining: %d stages x %d microbatches "
                    "(bubble %.0f%%)", model_args.pipeline_stages,
                    n_microbatches,
                    100 * (model_args.pipeline_stages - 1)
                    / (n_microbatches + model_args.pipeline_stages - 1))
    else:
        model, init_fn, step_fn, eval_fn = make_vjepa_workload(
            config, tx=tx,
            grad_accum=training_args.gradient_accumulation_steps,
            accum_dtype=training_args.grad_accum_dtype,
            ema_momentum=model_args.ema_momentum,
            num_blocks=data_args.num_mask_blocks,
            inv_block=data_args.inv_block)

    if training_args.model_flops_per_sample is None:
        from smb_vision_tpu.utils.profiling import vjepa_flops_per_sample

        training_args.model_flops_per_sample = vjepa_flops_per_sample(config)
    with jax.set_mesh(mesh):
        state = init_fn(jax.random.PRNGKey(training_args.seed))
    if model_args.model_name_or_path:
        # continued pretraining: graft matching weights (full V-JEPA state
        # or an encoder-only export) into the fresh init; the EMA teacher
        # restarts as a copy of the loaded online weights (the deepcopy
        # semantics of reference run_vjepa.py:104)
        import jax.numpy as jnp

        from smb_vision_tpu.utils.serialization import load_params_into

        if pipelined:
            # checkpoints are dense HF layout: graft through the dense
            # view, then re-stack for the pipelined train state
            from smb_vision_tpu.models.pipelined import (
                from_pipeline_vjepa_params,
                to_pipeline_vjepa_params,
            )
            dense = from_pipeline_vjepa_params(state["params"])
            dense, loaded, skipped = load_params_into(
                dense, model_args.model_name_or_path)
            state["params"] = to_pipeline_vjepa_params(dense)
        else:
            state["params"], loaded, skipped = load_params_into(
                state["params"], model_args.model_name_or_path)
        if not loaded:
            raise ValueError(
                f"no tensor in {model_args.model_name_or_path} matches the "
                "V-JEPA parameter tree (checked flat names + shapes) — "
                "wrong checkpoint for this architecture?")
        state["teacher"] = jax.tree_util.tree_map(jnp.copy, state["params"])
        logger.info("initialised %d tensors from %s (%d checkpoint tensors "
                    "unused)", len(loaded), model_args.model_name_or_path,
                    len(skipped))
    trainer = Trainer(args=training_args, state=state, step_fn=step_fn,
                      eval_batch_multiple=(eval_mb if pipelined
                                           else 1),
                      train_loader=train_loader, eval_loader=eval_loader,
                      eval_fn=eval_fn, mesh=mesh)
    if training_args.do_train:
        result = trainer.train()
        stacked_params = None
        if pipelined:
            # export dense HF layout (loads into the non-pipelined model /
            # export_hf_vjepa2); live state stays stacked for --do_eval
            from smb_vision_tpu.models.pipelined import (
                from_pipeline_vjepa_params)
            stacked_params = trainer.state["params"]
            trainer.state["params"] = from_pipeline_vjepa_params(
                stacked_params)
        trainer.save_model()
        config.save_json(trainer.out_dir / "config.json")
        if model_args.export_hf:
            from safetensors.numpy import save_file

            from smb_vision_tpu.models.convert import export_hf_vjepa2

            hf_state = export_hf_vjepa2(
                trainer.state["params"],
                num_layers=config.num_hidden_layers,
                pred_layers=config.pred_num_hidden_layers)
            save_file(hf_state,
                      str(trainer.out_dir / "hf_model.safetensors"))
            logger.info("HF export: %d tensors -> hf_model.safetensors",
                        len(hf_state))
        if stacked_params is not None:
            trainer.state["params"] = stacked_params
        logger.info("train complete: %s", result)
    if training_args.do_eval:
        logger.info("eval: %s", trainer.evaluate())


if __name__ == "__main__":
    main()
