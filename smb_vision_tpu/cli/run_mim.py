"""MIM pretraining CLI — the JAX run_mim.py
(reference /root/reference/src/run_mim.py).

Example:
    python -m smb_vision_tpu.cli.run_mim \
        --json_path data.json --output_dir out/mim --image_size 224 \
        --depth 160 --patch_size 16 --mask_patch_size 32 --mask_ratio 0.65 \
        --per_device_train_batch_size 2 --num_train_steps 1000

Differences from the reference, by design:
- masks are generated on device per step (not cached with the data)
- --config_overrides works (the reference ignored it, SURVEY §2 item 5)
- checkpoint/resume auto-detects the latest step in output_dir
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

from smb_vision_tpu.utils.args import parse_args_into_dataclasses
from smb_vision_tpu.utils.logging import get_logger

logger = get_logger("run_mim")


@dataclass
class DataTrainingArguments:
    json_path: Optional[str] = field(
        default=None, metadata={"help": "The local json data path."})
    train_split: str = "train"
    validation_split: str = "validation"
    train_val_split: float = 0.15
    mask_patch_size: int = field(
        default=16, metadata={"help": "size of square mask patches"})
    mask_ratio: float = field(
        default=0.5, metadata={"help": "fraction of patches to mask"})
    max_train_samples: Optional[int] = None
    max_eval_samples: Optional[int] = None
    cache_data_dir: Optional[str] = field(
        default=None, metadata={"help": "preprocessed-volume cache dir"})
    cache_dtype: str = field(
        default="float32",
        metadata={"help": "on-disk dtype for cached "
                          "volumes; float16 halves "
                          "disk/IO bytes (~1e-4 "
                          "rounding on [0,1] values)"})
    num_workers: int = 8
    device_cache: bool = field(
        default=False,
        metadata={"help": "pin volumes in DEVICE memory after first "
                          "load; later epochs assemble batches on "
                          "device (zero host pixel bytes/step). For "
                          "datasets that fit device memory next to the model "
                          "state; requires grad-accum 1"})


@dataclass
class ModelArguments:
    model_name_or_path: Optional[str] = field(
        default=None,
        metadata={"help": "safetensors checkpoint to initialise from"})
    config_name_or_path: Optional[str] = None
    config_overrides: Optional[str] = field(
        default=None,
        metadata={"help": "comma list key=value applied to the config"})
    image_size: int = 224
    depth: int = 160
    patch_size: int = 16
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    decoder_num_attention_heads: int = 6
    intermediate_size: int = 3072
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
        metadata={"help": "GPipe-pipeline the encoder+decoder stacks over "
                          "this many stages (the mesh model axis): each "
                          "device holds layers/S of both stacks, for "
                          "models deeper than one device's memory. Both layer "
                          "counts must divide by it; microbatching "
                          "replaces gradient accumulation"})
    pipeline_microbatches: int = field(
        default=0,
        metadata={"help": "microbatches per step through the pipeline "
                          "(0 = per_device_train_batch_size). Bubble is "
                          "(stages-1)/(microbatches+stages-1)"})


def build_config(model_args: ModelArguments):
    from smb_vision_tpu.models.configs import VideoMAEConfig

    from dataclasses import fields as dc_fields

    from_file = bool(model_args.config_name_or_path)
    if from_file:
        config = VideoMAEConfig.from_json(model_args.config_name_or_path)
    else:
        config = VideoMAEConfig(
            hidden_size=model_args.hidden_size,
            num_hidden_layers=model_args.num_hidden_layers,
            num_attention_heads=model_args.num_attention_heads,
            intermediate_size=model_args.intermediate_size)
    # 3D adaptation (reference run_mim.py:322-330): 1 channel,
    # depth-as-frames, cubic tubelets. When the config comes from a FILE,
    # its geometry is authoritative: a CLI default must not silently
    # rebuild a 384^2x256/p32 checkpointed model at 224/160/16 — only
    # explicitly-changed flags (values differing from the dataclass
    # defaults) override the file.
    defaults = {f.name: f.default for f in dc_fields(type(model_args))}
    geometry = {
        "image_size": ("image_size", model_args.image_size),
        "num_frames": ("depth", model_args.depth),
        "tubelet_size": ("patch_size", model_args.patch_size),
        "patch_size": ("patch_size", model_args.patch_size),
        "decoder_num_attention_heads": (
            "decoder_num_attention_heads",
            model_args.decoder_num_attention_heads),
        # attention impl / dtype / remat get the same only-if-explicit
        # guard: a config file pinning attn_impl='xla',
        # gradient_checkpointing=true or dtype='float32' must not be
        # silently reverted by CLI defaults. (Explicitly passing the
        # default value, e.g. `--attn_impl auto`, is indistinguishable
        # from unset — use --config_overrides to force a default over a
        # file pin.)
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
        upd["num_channels"] = 1
    config.update(upd)
    if model_args.config_overrides:
        for kv in model_args.config_overrides.split(","):
            k, v = kv.split("=", 1)
            try:
                v = json.loads(v)
            except json.JSONDecodeError:
                pass
            config.update({k.strip(): v})
    return config


def main(argv=None):
    from smb_vision_tpu.data.dataset import BatchLoader, CTDataset
    from smb_vision_tpu.data.preprocess import CT_PIPELINES, PreprocessConfig
    from smb_vision_tpu.train.mim import make_mim_workload
    from smb_vision_tpu.train.optim import make_optimizer
    from smb_vision_tpu.train.trainer import Trainer, TrainingArguments
    import jax

    model_args, data_args, training_args = parse_args_into_dataclasses(
        (ModelArguments, DataTrainingArguments, TrainingArguments), argv)
    from smb_vision_tpu.parallel.mesh import maybe_initialize_distributed
    from smb_vision_tpu.utils.compile_cache import setup_compile_cache
    setup_compile_cache()
    maybe_initialize_distributed(training_args.multihost)
    config = build_config(model_args)
    logger.info("MIM config: %s tokens, grid %s", config.seq_len, config.grid)

    pipelined = model_args.pipeline_stages > 1
    eval_mb = 1
    if pipelined:
        if training_args.gradient_accumulation_steps > 1:
            raise SystemExit(
                "--pipeline_stages replaces gradient accumulation with "
                "microbatching (--pipeline_microbatches); set "
                "--gradient_accumulation_steps 1")
        # stages ride the mesh model axis; stacked layer params shard
        # their leading layer axis over it (sharding policy "pipeline")
        training_args.model_parallel = model_args.pipeline_stages
        if "pipeline" not in training_args.sharding_policy:
            # composites like "pipeline+fsdp" pass through unchanged
            logger.info("pipeline_stages=%d: sharding_policy -> 'pipeline'",
                        model_args.pipeline_stages)
            training_args.sharding_policy = "pipeline"

    pipe = PreprocessConfig(
        target_spacing=CT_PIPELINES["mim"].target_spacing,
        target_size=(config.image_size, config.image_size,
                     config.num_frames))
    # carry half-precision straight from the cache to device_put: with
    # input_dtype != float32 the f16 cache would otherwise round-trip
    # through f32 on the host (three full-volume array ops per step)
    out_dt = training_args.input_dtype
    train_ds = CTDataset(data_args.json_path, split=data_args.train_split,
                         pipeline=pipe, cache_dir=data_args.cache_data_dir,
                         cache_dtype=data_args.cache_dtype,
                         out_dtype=out_dt,
                         max_samples=data_args.max_train_samples)
    try:
        eval_ds = CTDataset(data_args.json_path,
                            split=data_args.validation_split, pipeline=pipe,
                            cache_dir=data_args.cache_data_dir,
                            cache_dtype=data_args.cache_dtype,
                            out_dtype=out_dt,
                            max_samples=data_args.max_eval_samples)
    except (ValueError, FileNotFoundError):
        eval_ds = None

    if eval_ds is None and data_args.train_val_split and len(train_ds) > 1:
        # auto-split train when the spec has no validation split — the fix
        # SURVEY §2 item 5 demands (the reference declared this arg and
        # never read it, /root/reference/src/run_mim.py DataTrainingArguments)
        import random

        items = list(train_ds.items)
        random.Random(training_args.seed).shuffle(items)
        n_val = min(max(1, round(len(items) * data_args.train_val_split)),
                    len(items) - 1)
        val_items = items[:n_val]
        if data_args.max_eval_samples:
            val_items = val_items[:data_args.max_eval_samples]
        eval_ds = CTDataset(items=val_items, pipeline=pipe,
                            cache_dir=data_args.cache_data_dir,
                            cache_dtype=data_args.cache_dtype,
                            out_dtype=out_dt)
        train_ds.items = items[n_val:]
        logger.info("no '%s' split: auto-split %d/%d train/val "
                    "(train_val_split=%.2f)", data_args.validation_split,
                    len(train_ds), len(eval_ds), data_args.train_val_split)

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
                               * n_data, shuffle=False,
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
        from smb_vision_tpu.train.mim import make_pipelined_mim_workload

        import math

        n_microbatches = (model_args.pipeline_microbatches
                          or training_args.per_device_train_batch_size)
        model, init_fn, step_fn, eval_fn = make_pipelined_mim_workload(
            config, mask_patch_size=data_args.mask_patch_size,
            mask_ratio=data_args.mask_ratio, tx=tx, mesh=mesh,
            num_microbatches=n_microbatches,
            eval_microbatches=(eval_mb := math.gcd(
                n_microbatches,
                training_args.per_device_eval_batch_size)))
        logger.info("pipelined pretraining: %d stages x %d microbatches "
                    "(bubble %.0f%%)", model_args.pipeline_stages,
                    n_microbatches,
                    100 * (model_args.pipeline_stages - 1)
                    / (n_microbatches + model_args.pipeline_stages - 1))
    else:
        model, init_fn, step_fn, eval_fn = make_mim_workload(
            config, mask_patch_size=data_args.mask_patch_size,
            mask_ratio=data_args.mask_ratio, tx=tx,
            grad_accum=training_args.gradient_accumulation_steps,
            accum_dtype=training_args.grad_accum_dtype)

    if training_args.model_flops_per_sample is None:
        from smb_vision_tpu.utils.profiling import mim_flops_per_sample

        training_args.model_flops_per_sample = mim_flops_per_sample(
            config, data_args.mask_ratio)

    key = jax.random.PRNGKey(training_args.seed)
    with jax.set_mesh(mesh):
        state = init_fn(key)
    if model_args.model_name_or_path:
        # graft matching tensors (flat name + shape) instead of replacing
        # the whole tree: a wrong-architecture or encoder-only checkpoint
        # must fail loudly here, not as a pytree mismatch at the first
        # optimizer update (and grafting keeps the f32-params invariant —
        # a bf16 export must not become the train dtype)
        from smb_vision_tpu.utils.serialization import load_params_into

        if pipelined:
            from smb_vision_tpu.models.pipelined import (
                from_pipeline_pretrain_params,
                to_pipeline_pretrain_params,
            )
            dense = from_pipeline_pretrain_params(state["params"])
            dense, loaded, skipped = load_params_into(
                dense, model_args.model_name_or_path)
            state["params"] = to_pipeline_pretrain_params(dense)
        else:
            state["params"], loaded, skipped = load_params_into(
                state["params"], model_args.model_name_or_path)
        if not loaded:
            raise ValueError(
                f"no tensor in {model_args.model_name_or_path} matches "
                "the MIM parameter tree (checked flat names + shapes) — "
                "wrong checkpoint for this architecture?")
        logger.info("initialised %d tensors from %s (%d checkpoint "
                    "tensors unused)", len(loaded),
                    model_args.model_name_or_path, len(skipped))

    trainer = Trainer(args=training_args, state=state, step_fn=step_fn,
                      eval_batch_multiple=(eval_mb if pipelined
                                           else 1),
                      train_loader=train_loader, eval_loader=eval_loader,
                      eval_fn=eval_fn, mesh=mesh)
    if training_args.do_train:
        result = trainer.train()
        stacked_params = None
        if pipelined:
            # export in the dense HF layout so the checkpoint loads into
            # the non-pipelined model / run_inference / export_hf; the
            # live state stays stacked for a subsequent --do_eval
            from smb_vision_tpu.models.pipelined import (
                from_pipeline_pretrain_params)
            stacked_params = trainer.state["params"]
            trainer.state["params"] = from_pipeline_pretrain_params(
                stacked_params)
        trainer.save_model()
        config.save_json(trainer.out_dir / "config.json")
        if model_args.export_hf:
            # HF-torch-loadable weights next to the native export (the
            # reference publishes via push_to_hub, run_mim.py:464-467)
            from safetensors.numpy import save_file

            from smb_vision_tpu.models.convert import export_hf_videomae

            hf_state = export_hf_videomae(
                trainer.state["params"],
                num_layers=config.num_hidden_layers,
                decoder_layers=config.decoder_num_hidden_layers)
            save_file(hf_state,
                      str(trainer.out_dir / "hf_model.safetensors"))
            logger.info("HF export: %d tensors -> hf_model.safetensors",
                        len(hf_state))
        if stacked_params is not None:
            trainer.state["params"] = stacked_params
        logger.info("train complete: %s", result)
    if training_args.do_eval:
        metrics = trainer.evaluate()
        logger.info("eval: %s", metrics)


if __name__ == "__main__":
    main()
