"""External-model encoders for the zoo (reference src/encoders/run_merlin.py
and run_siglip.py). These wrap third-party checkpoints behind the
BaseEncoder interface; they are environment-gated (torch/transformers for
SigLIP, the external `merlin` package for Merlin) and fail with actionable
errors instead of the reference's broken imports (SURVEY §2 item 2)."""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from smb_vision_tpu.inference.runner import BaseEncoder
from smb_vision_tpu.utils.logging import get_logger

logger = get_logger(__name__)


class SiglipEncoder(BaseEncoder):
    """2D X-ray embeddings from a SigLIP vision tower
    (reference run_siglip.py:49-120). Requires a *local* checkpoint path
    (zero-egress environments cannot pull from the hub).

    backend="jax" (default) runs the first-party tower
    (models/siglip.py) on the JAX compute path — the reference ran the
    torch model with flash-attn-2 on GPU; the torch-on-host path remains
    available as backend="torch"."""

    def __init__(self, model_path: str, model_id: str = "siglip",
                 image_size: int = 384, batch_dtype: str = "float32",
                 backend: str = "jax", dtype: str = "bfloat16",
                 attn_impl: str = "auto"):
        if backend not in ("jax", "torch"):
            raise ValueError(f"unknown backend {backend!r}; "
                             "valid: 'jax', 'torch'")
        self.model_path = model_path
        self.model_id = model_id
        self.image_size = image_size
        self.backend = backend
        self.dtype = dtype
        self.attn_impl = attn_impl
        self._model = None
        self._encode = None

    def create_dataset(self, items: List[Dict]):
        from smb_vision_tpu.data.image2d import Image2DDataset

        return Image2DDataset(items, image_size=self.image_size)

    def _load_vision_config(self):
        """Parse the checkpoint's HF config.json — either a flat
        SiglipVisionConfig or a full SiglipConfig with nested
        vision_config."""
        import json
        import os

        from smb_vision_tpu.models.configs import SiglipVisionConfig

        path = os.path.join(self.model_path, "config.json")
        if not os.path.exists(path):
            raise FileNotFoundError(
                f"no config.json in {self.model_path}: SiglipEncoder needs "
                "a local HF checkpoint directory (zero-egress environments "
                "cannot pull from the hub)")
        with open(path) as fh:
            d = json.load(fh)
        d = d.get("vision_config", d)
        cfg = SiglipVisionConfig.from_dict(d)
        cfg.update({"dtype": self.dtype, "attn_impl": self.attn_impl})
        self.image_size = cfg.image_size
        return cfg

    def setup_model(self):
        # config first regardless of backend: image_size must come from the
        # checkpoint (the runner calls setup_model before create_dataset,
        # so this is what keeps both backends preprocessing identically)
        config = self._load_vision_config()
        if not config.vision_use_head:
            logger.warning(
                "%s has vision_use_head=False (no MAP pooling head): "
                "embeddings fall back to MEAN token pooling — a different "
                "embedding space from MAP-pooled checkpoints",
                self.model_path)

        if self.backend == "torch":
            try:
                import torch
                from transformers import AutoModel
            except ImportError as e:
                raise RuntimeError(
                    "SiglipEncoder(backend='torch') needs "
                    "torch+transformers installed") from e
            self._torch = torch
            self._model = AutoModel.from_pretrained(
                self.model_path, local_files_only=True).vision_model.eval()
            return

        import jax
        import jax.numpy as jnp

        from smb_vision_tpu.models.convert import (
            convert_hf_siglip,
            load_hf_checkpoint_numpy,
        )
        from smb_vision_tpu.models.siglip import SiglipVisionModel

        model = SiglipVisionModel(config)
        params = convert_hf_siglip(load_hf_checkpoint_numpy(self.model_path),
                                   config.num_hidden_layers)
        if not params:
            raise ValueError(
                f"no SigLIP vision tensors found in {self.model_path}")

        # params as a jit ARGUMENT (HLO-constant inlining would copy the
        # weights into the compiled program, runner.py:117-119);
        # device_put ONCE — numpy jit arguments re-transfer host->device
        # every call, which at tower size would dominate each batch
        @jax.jit
        def encode(p, px):
            tokens, pooled = model.apply(p, px)
            # vision_use_head=False checkpoints have no MAP head: fall
            # back to mean token pooling (HF returns pooler_output=None)
            out = pooled if pooled is not None else jnp.mean(tokens, axis=1)
            return out.astype(jnp.float32)

        self._params = jax.device_put(params)
        self._encode = encode

    def generate_embedding(self, batch: np.ndarray) -> np.ndarray:
        if self.backend == "torch":
            torch = self._torch
            with torch.inference_mode():
                out = self._model(torch.from_numpy(batch))
            if out.pooler_output is None:
                # head-less checkpoint: mirror the jax backend's mean-pool
                # fallback instead of crashing on None
                return out.last_hidden_state.mean(dim=1).numpy()
            return out.pooler_output.numpy()
        import jax.numpy as jnp

        return np.asarray(self._encode(self._params, jnp.asarray(batch)))


class MerlinEncoder(BaseEncoder):
    """Merlin CT foundation model (reference run_merlin.py — whose imports
    were broken in the reference repo; its forward returns (batch, tokens,
    dim) image embeddings, run_merlin.py:45-48).

    backend="jax" (default) runs the tower as the first-party
    inflated-3D ResNet (models/resnet3d.py) on the JAX compute path —
    pass `checkpoint` pointing at the Merlin image-encoder torch state
    dict (.pt/.safetensors; the `encode_image.i3_resnet.*` nesting is
    auto-detected and the architecture is derived from the weight shapes,
    models/convert.py::resnet3d_config_from_state_dict).
    backend="torch" keeps the external `merlin` package path on host.
    The dataset path reuses this framework's CT pipeline either way."""

    def __init__(self, model_id: str = "merlin",
                 checkpoint: Optional[str] = None,
                 backend: str = "jax", dtype: str = "bfloat16",
                 target_size=None):
        if backend not in ("jax", "torch"):
            raise ValueError(f"unknown backend {backend!r}; "
                             "valid: 'jax', 'torch'")
        self.model_id = model_id
        self.checkpoint = checkpoint
        self.backend = backend
        self.dtype = dtype
        # the tower is fully convolutional — any grid runs; None keeps the
        # merlin production geometry (224, 224, 160)
        self.target_size = target_size
        self._model = None
        self._encode = None

    def create_dataset(self, items: List[Dict],
                       out_dtype: str = "float32"):
        from smb_vision_tpu.data.dataset import CTDataset

        norm = [{"image": it.get("image_path", it.get("image")), **it}
                for it in items]
        pipe = "merlin"
        if self.target_size is not None:
            import dataclasses

            from smb_vision_tpu.data.preprocess import CT_PIPELINES

            # replace keeps every OTHER merlin-pipeline field (HU window,
            # output range, ...) — rebuilding field-by-field would reset
            # them to generic defaults silently
            pipe = dataclasses.replace(
                CT_PIPELINES["merlin"],
                target_size=tuple(self.target_size))
        return CTDataset(items=norm, pipeline=pipe, out_dtype=out_dtype)

    def setup_model(self):
        if self.backend == "torch":
            try:
                import merlin  # type: ignore
            except ImportError as e:
                raise RuntimeError(
                    "MerlinEncoder(backend='torch') needs the external "
                    "`merlin` package (https://github.com/StanfordMIMI/"
                    "Merlin); install it, or use backend='jax' with a "
                    "local image-encoder checkpoint") from e
            self._model = merlin.models.Merlin()
            self._model.eval()
            return

        if not self.checkpoint:
            raise ValueError(
                "MerlinEncoder(backend='jax') needs `checkpoint`: a local "
                "torch state dict (.pt/.safetensors) holding the Merlin "
                "image tower (i3d resnet); zero-egress environments "
                "cannot pull it from the hub")
        import jax
        import jax.numpy as jnp

        from smb_vision_tpu.models.convert import (
            convert_torch_resnet3d,
            load_hf_checkpoint_numpy,
            resnet3d_config_from_state_dict,
        )
        from smb_vision_tpu.models.resnet3d import ResNet3D

        flat = load_hf_checkpoint_numpy(self.checkpoint)
        # embedding surface: tower only, never the contrastive/classifier
        # head (reference ImageEmbedding=True skips it)
        cfg = resnet3d_config_from_state_dict(flat, num_labels=0,
                                              dtype=self.dtype)
        params = convert_torch_resnet3d(flat, cfg)
        model = ResNet3D(cfg)

        @jax.jit
        def encode(p, px):
            tokens, _ = model.apply(p, px)
            return tokens.astype(jnp.float32)

        # uint8-shipped pixels: one byte per voxel over the wire, decoded
        # to bf16 inside the same compiled program — identical to the ViT
        # encoder's path (inference/runner.py::SmbVisionEncoder)
        from smb_vision_tpu.data.quantization import dequantize_pixels

        @jax.jit
        def encode_q(p, q, s, o):
            tokens, _ = model.apply(
                p, dequantize_pixels(q, s, o, jnp.bfloat16))
            return tokens.astype(jnp.float32)

        self._params = jax.device_put(params)
        self._encode = encode
        self._encode_q = encode_q
        self._cfg = cfg          # introspection (cli/serve.py health)

    def generate_embedding(self, batch: np.ndarray, scale=None,
                           offset=None) -> np.ndarray:
        """batch (N, C, a0, a1, a2) float — or uint8 codes with
        per-volume (scale, offset) affine keys (jax backend only)."""
        if self.backend == "torch":
            if scale is not None:
                raise ValueError("uint8 affine shipping is a jax-backend "
                                 "feature; backend='torch' takes float "
                                 "pixels")
            import torch

            with torch.inference_mode():
                out = self._model(torch.from_numpy(batch))
            return out[0].numpy() if isinstance(out, tuple) \
                else out.numpy()
        import jax.numpy as jnp

        if scale is not None:
            return np.asarray(self._encode_q(
                self._params, jnp.asarray(batch),
                jnp.asarray(scale, jnp.float32),
                jnp.asarray(offset, jnp.float32)))
        return np.asarray(self._encode(self._params, jnp.asarray(batch)))
