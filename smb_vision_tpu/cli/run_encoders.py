"""Encoder-zoo CLI: batch embeddings via a named encoder
(reference src/encoders/run_siglip.py:167-181 main() pattern).

Usage:
    python -m smb_vision_tpu.cli.run_encoders \
        --encoder smb-vision --input_json manifest.json \
        --output_dir out/emb --checkpoint out/mim/model.safetensors \
        --config_path out/mim/config.json --batch_size 2

manifest.json: {"images": [{"uid": ..., "image_path": ...}, ...]}
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Optional

from smb_vision_tpu.utils.args import parse_args_into_dataclasses
from smb_vision_tpu.utils.logging import get_logger

logger = get_logger("run_encoders")


@dataclass
class EncoderArguments:
    encoder: str = field(default="smb-vision", metadata={
        "help": "smb-vision | siglip | merlin"})
    input_json: Optional[str] = None
    output_dir: str = "embeddings"
    checkpoint: Optional[str] = None
    config_path: Optional[str] = None
    model_id: Optional[str] = None
    format: str = "parquet"
    batch_size: int = 1
    num_workers: int = 8
    resume: bool = True
    # siglip only: "jax" runs the first-party tower on the accelerator
    # (models/siglip.py); "torch" runs the HF model on the host
    siglip_backend: str = field(default="jax", metadata={
        "help": "jax | torch"})
    # merlin only: "jax" runs the first-party inflated-3D resnet on the
    # accelerator
    # (models/resnet3d.py, needs --checkpoint); "torch" runs the external
    # `merlin` package on the host
    merlin_backend: str = field(default="jax", metadata={
        "help": "jax | torch"})
    # merlin only: override the CT pipeline's (a0, a1, a2) resample grid —
    # the I3D tower is fully convolutional, any grid runs; default keeps
    # the Merlin production geometry (224, 224, 160)
    target_size: Optional[str] = field(default=None, metadata={
        "help": "comma-separated 3 ints, e.g. 224,224,160"})


def main(argv=None):
    from smb_vision_tpu.inference.runner import (
        BaseEncoderRunner,
        SmbVisionEncoder,
    )

    (args,) = parse_args_into_dataclasses((EncoderArguments,), argv)
    if not args.input_json:
        raise SystemExit("--input_json is required")

    if args.encoder == "smb-vision":
        enc = SmbVisionEncoder(
            checkpoint=args.checkpoint, config_path=args.config_path,
            model_id=args.model_id or "smb-vision-tpu-base")
    elif args.encoder == "siglip":
        from smb_vision_tpu.inference.encoders import SiglipEncoder

        if not args.checkpoint:
            raise SystemExit(
                "--checkpoint is required for siglip: pass a local HF "
                "checkpoint directory (zero-egress environments cannot "
                "pull from the hub)")
        enc = SiglipEncoder(model_path=args.checkpoint,
                            model_id=args.model_id or "siglip",
                            backend=args.siglip_backend)
    elif args.encoder == "merlin":
        from smb_vision_tpu.inference.encoders import MerlinEncoder

        if args.merlin_backend == "jax" and not args.checkpoint:
            raise SystemExit(
                "--checkpoint is required for merlin with the jax "
                "backend: pass the local Merlin image-tower state dict "
                "(.pt/.safetensors); --merlin_backend torch uses the "
                "external `merlin` package instead")
        target_size = None
        if args.target_size:
            try:
                target_size = tuple(int(s) for s
                                    in args.target_size.split(","))
            except ValueError:
                target_size = ()
            if len(target_size) != 3:
                raise SystemExit(
                    f"--target_size needs 3 comma-separated ints, got "
                    f"{args.target_size!r}")
        enc = MerlinEncoder(model_id=args.model_id or "merlin",
                            checkpoint=args.checkpoint,
                            backend=args.merlin_backend,
                            target_size=target_size)
    else:
        raise SystemExit(f"unknown encoder {args.encoder}")

    runner = BaseEncoderRunner(enc, args.output_dir, fmt=args.format,
                               batch_size=args.batch_size,
                               num_workers=args.num_workers)
    items = runner.load_input_json(args.input_json)
    stats = runner.run(items, resume=args.resume)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
