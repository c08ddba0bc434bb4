"""Embedding-generation CLI — the working JAX run_inference.py.

The reference CLI (/root/reference/src/run_inference.py) imported a
CTDataset that never existed (:11, SURVEY §2 known-broken item 1); this one
runs. Outputs per-volume .npy + metadata.json (README contract) or the
run_inspect.py parquet schema {uid, embedding, embedding_shape, model_id}.

Example:
    python -m smb_vision_tpu.cli.run_inference \
        --data_dir /data/niftis --output_dir out/embeddings \
        --model_name_or_path out/mim/model.safetensors \
        --config_path out/mim/config.json --batch_size 2 --format npy
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

from smb_vision_tpu.utils.args import parse_args_into_dataclasses
from smb_vision_tpu.utils.logging import get_logger

logger = get_logger("run_inference")


@dataclass
class InferenceArguments:
    data_dir: Optional[str] = field(
        default=None, metadata={"help": "directory of *.nii[.gz] volumes"})
    data_json: Optional[str] = field(
        default=None, metadata={"help": "or: json list of {image: path}"})
    output_dir: str = "embeddings"
    model_name_or_path: Optional[str] = field(
        default=None, metadata={"help": "safetensors checkpoint"})
    config_path: Optional[str] = field(
        default=None, metadata={"help": "model config json"})
    model_id: str = "smb-vision-tpu-base"
    format: str = field(default="npy", metadata={"help": "npy | parquet"})
    batch_size: int = 1
    image_size: int = 224
    depth: int = 160
    patch_size: int = 16
    sliding_window: bool = field(
        default=False,
        metadata={"help": "use sliding-window embedding for volumes larger "
                          "than the model grid"})
    sw_overlap: float = 0.25
    resume: bool = True
    cache_data_dir: Optional[str] = None
    cache_dtype: str = "float32"
    num_workers: int = 8
    max_samples: Optional[int] = None
    dtype: str = "bfloat16"
    input_dtype: str = field(
        default="float32",
        metadata={"help": "dtype pixels are shipped to the device in; "
                          "bfloat16 halves host->device bytes (the model "
                          "computes in bf16 anyway; embeddings move by "
                          "~1e-3 — keep float32 for strict parity)"})
    attn_impl: str = "auto"    # auto | xla
    quant8: bool = field(
        default=False,
        metadata={"help": "run transformer projections as W8A8 int8 "
                          "matmuls (per-token activation scales, "
                          "per-channel weight scales); inference only"})
    # process-level fan-out (the reference's per-GPU mp.Pool chunking,
    # run_inspect.py:205-235): each process takes items[shard::num_shards];
    # resume-by-uid makes overlapping shards safe
    num_shards: int = 1
    shard_index: int = 0
    pipeline_parallel: int = field(
        default=1,
        metadata={"help": "split the encoder's layer stack over this many "
                          "pipeline stages (GPipe over a mesh 'pipe' axis); "
                          "remaining devices form the data axis. For models "
                          "whose weights/activations exceed one device's memory. "
                          "num_hidden_layers must divide by it"})
    pipeline_microbatches: int = field(
        default=0,
        metadata={"help": "microbatches streamed through the pipeline per "
                          "batch (0 = auto: batch_size / data-axis size). "
                          "Bubble fraction is (stages-1)/(microbatches+"
                          "stages-1) - larger batches pipeline better"})


def main(argv=None):
    import jax
    import jax.numpy as jnp

    from smb_vision_tpu.data.dataset import CTDataset
    from smb_vision_tpu.data.preprocess import CT_PIPELINES, PreprocessConfig
    from smb_vision_tpu.inference.embed import (
        EmbeddingWriter,
        build_json_from_nifti_files,
        run_embedding,
    )
    from smb_vision_tpu.models.configs import VideoMAEConfig
    from smb_vision_tpu.models.videomae import VideoMAEModel

    (args,) = parse_args_into_dataclasses((InferenceArguments,), argv)
    from smb_vision_tpu.utils.compile_cache import setup_compile_cache
    setup_compile_cache()

    if args.config_path:
        config = VideoMAEConfig.from_json(args.config_path)
        config.update({"attn_impl": args.attn_impl, "dtype": args.dtype,
                       "quant8": args.quant8})
    else:
        config = VideoMAEConfig(
            image_size=args.image_size, num_frames=args.depth,
            num_channels=1, patch_size=args.patch_size,
            tubelet_size=args.patch_size, dtype=args.dtype,
            attn_impl=args.attn_impl, quant8=args.quant8)

    if args.data_json:
        items = None
        dataset_kwargs = dict(data_path=args.data_json, split=None)
    elif args.data_dir:
        items = build_json_from_nifti_files(args.data_dir)
        dataset_kwargs = dict(items=items)
    else:
        raise SystemExit("one of --data_dir / --data_json is required")

    pipe = PreprocessConfig(
        target_spacing=CT_PIPELINES["smb-vision"].target_spacing,
        target_size=(config.image_size, config.image_size,
                     config.num_frames))
    ds = CTDataset(pipeline=pipe, cache_dir=args.cache_data_dir,
                   cache_dtype=args.cache_dtype,
                   # half-precision input shipping skips the host
                   # f16->f32->cast round trip (volumes leave the cache
                   # already in input_dtype; embed_fn's cast is a no-op)
                   out_dtype=args.input_dtype,
                   max_samples=args.max_samples, **dataset_kwargs)
    if args.num_shards > 1:
        ds.items = ds.items[args.shard_index::args.num_shards]
        logger.info("shard %d/%d", args.shard_index, args.num_shards)
    logger.info("%d volumes to embed", len(ds))

    # encoder-only forward (reference model.videomae(...), :82)
    model = VideoMAEModel(config)
    key = jax.random.PRNGKey(0)
    example = jnp.zeros((1, config.num_frames, 1, config.image_size,
                         config.image_size), jnp.float32)
    params = jax.jit(model.init)(key, example)
    if args.model_name_or_path:
        from smb_vision_tpu.models.convert import load_backbone_into

        params = load_backbone_into(params, args.model_name_or_path)

    # params are a jit ARGUMENT, not a closure capture: captured arrays
    # would be inlined into the compiled program as constants, copying the
    # weights into every executable (and every compile-cache entry)
    if args.pipeline_parallel > 1:
        import numpy as np
        from jax.sharding import Mesh

        from smb_vision_tpu.models.pipelined import videomae_pipeline_encode

        if args.sliding_window:
            raise SystemExit("--pipeline_parallel does not compose with "
                             "--sliding_window yet; drop one")
        S = args.pipeline_parallel
        devs = np.array(jax.devices())
        if len(devs) % S:
            raise SystemExit(f"{len(devs)} devices do not divide into "
                             f"{S} pipeline stages")
        if config.num_hidden_layers % S:
            raise SystemExit(f"{config.num_hidden_layers} layers do not "
                             f"divide into {S} pipeline stages")
        # data axis: the largest batch divisor that fits the devices left
        # after the pipe axis (spare devices stay idle rather than forcing
        # a batch constraint)
        n_data = max(d for d in range(1, len(devs) // S + 1)
                     if args.batch_size % d == 0)
        mesh = Mesh(devs[:n_data * S].reshape(n_data, S), ("data", "pipe"))
        M = args.pipeline_microbatches or max(args.batch_size // n_data, 1)
        logger.info("pipeline: %d stages x data %d, %d microbatches "
                    "(bubble %.0f%%)", S, n_data, M,
                    100 * (S - 1) / (M + S - 1))

        def _encode_px(params, px):
            return videomae_pipeline_encode(
                config, params, px, mesh=mesh, num_microbatches=M,
                batch_axis="data" if n_data > 1 else None,
            ).astype(jnp.float32)
    else:
        def _encode_px(params, px):
            out, _ = model.apply(params, px)
            return out.astype(jnp.float32)

    encode = jax.jit(_encode_px)

    # uint8-shipped pixels (--input_dtype uint8): decode to bf16 inside
    # the same compiled program, so the host->device wire carries one
    # byte per voxel (data/quantization.py)
    from smb_vision_tpu.data.quantization import dequantize_pixels

    encode_q = jax.jit(lambda params, q, s, o: _encode_px(
        params, dequantize_pixels(q, s, o, jnp.bfloat16)))

    writer = EmbeddingWriter(args.output_dir, fmt=args.format,
                             model_id=args.model_id)

    if args.sliding_window:
        # volumes larger than the model grid: resample-only preprocessing,
        # dense overlapping windows at the model's geometry, per-window
        # token embeddings (reference sliding_window_embed intent,
        # src/inference.py:325-438 — which was unwired there)
        from smb_vision_tpu.inference.sliding_window import (
            sliding_window_embed,
        )

        roi = (config.image_size, config.image_size, config.num_frames)

        def window_embedder(p, wins):
            # (N, C, h, w, d) -> model layout (N, d, C, h, w) -> (N, L, D)
            px = jnp.transpose(wins, (0, 4, 1, 2, 3))
            out, _ = model.apply(p, px)
            return out.astype(jnp.float32)

        def embed_one(item):
            from smb_vision_tpu.data.nifti import load_nifti
            from smb_vision_tpu.data.preprocess import preprocess_volume_full

            img = load_nifti(item["image"])
            vol = preprocess_volume_full(img.data, img.affine, pipe)
            v = jnp.asarray(vol)[None, None]          # (1, 1, H, W, D)
            emb, starts = sliding_window_embed(
                v, roi, window_embedder, overlap=args.sw_overlap,
                sw_batch_size=args.batch_size, state=params)
            return np.asarray(emb[0]), starts

        import numpy as np

        done = writer.existing_uids() if args.resume else set()
        errors, n_ok, n_skip = [], 0, 0
        for item in ds.items:
            if writer.uid_of(item) in done:
                n_skip += 1
                continue
            try:
                emb, starts = embed_one(item)
                writer.write(item, emb)
                n_ok += 1
            except Exception as e:  # noqa: BLE001
                errors.append({"item": item, "error": str(e)})
        writer.finalize(errors)
        stats = {"embedded": n_ok, "failed": len(errors),
                 "skipped": n_skip}
    else:
        in_dt = jnp.dtype(args.input_dtype)
        # the pipeline needs batch % microbatches == 0: pad a ragged final
        # batch with copies of its last row and slice the result back
        pad_to = args.batch_size if args.pipeline_parallel > 1 else 0

        def embed_fn(pixels, scale=None, offset=None):
            # cast on the HOST before device_put: the transfer is the
            # bottleneck on bandwidth-constrained hosts, not the cast
            import numpy as np

            pixels = np.asarray(pixels)
            if (scale is None and in_dt != jnp.float32
                    and pixels.dtype != in_dt):
                pixels = pixels.astype(in_dt)
            n = pixels.shape[0]
            if pad_to and n < pad_to:
                rep = pad_to - n
                pixels = np.concatenate(
                    [pixels, np.repeat(pixels[-1:], rep, axis=0)])
                if scale is not None:
                    scale = np.concatenate(
                        [scale, np.repeat(scale[-1:], rep)])
                    offset = np.concatenate(
                        [offset, np.repeat(offset[-1:], rep)])
            if scale is not None:
                out = encode_q(params, jnp.asarray(pixels),
                               jnp.asarray(scale), jnp.asarray(offset))
            else:
                out = encode(params, jnp.asarray(pixels))
            return np.asarray(out)[:n] if pad_to and n < pad_to else out

        stats = run_embedding(ds, embed_fn, writer,
                              batch_size=args.batch_size,
                              resume=args.resume,
                              num_workers=args.num_workers)
    logger.info("done: %s", stats)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
