"""Encoder zoo: pluggable batch-embedding runners.

Re-creates the reference's encoder framework
(/root/reference/src/encoders/base_encoder.py): an abstract encoder with
create_dataset / setup_model / generate_embedding / save_embedding hooks and
a runner that validates the input manifest, skips already-processed UIDs
(resume idempotency, :73-86), drives batches, and quarantines failures to
error_files.json (:118-167). External-model encoders (Merlin, SigLIP —
GPU-ecosystem specific, reference run_merlin.py / run_siglip.py) slot into
the same interface; first-party encoders wrap this framework's models.
"""

from __future__ import annotations

import abc
import json
import traceback
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional

import numpy as np

from smb_vision_tpu.inference.embed import EmbeddingWriter
from smb_vision_tpu.utils.logging import get_logger

logger = get_logger(__name__)


class BaseEncoder(abc.ABC):
    """One embedding model + its preprocessing."""

    model_id: str = "base-encoder"

    @abc.abstractmethod
    def create_dataset(self, items: List[Dict]) -> Any:
        """items: [{'uid': ..., 'image_path' | 'image': ...}] -> dataset"""

    @abc.abstractmethod
    def setup_model(self) -> None:
        """Load weights / jit the forward."""

    @abc.abstractmethod
    def generate_embedding(self, batch: np.ndarray) -> np.ndarray:
        """(N, ...) pixels -> (N, ...) embeddings."""

    def process_batch(self, batch_items: List[Dict],
                      pixels: np.ndarray) -> List[np.ndarray]:
        emb = np.asarray(self.generate_embedding(pixels))
        return [emb[i] for i in range(len(batch_items))]


class SmbVisionEncoder(BaseEncoder):
    """First-party CT encoder: VideoMAE backbone, encoder-only forward."""

    def __init__(self, checkpoint: Optional[str] = None,
                 config_path: Optional[str] = None,
                 model_id: str = "smb-vision-tpu-base",
                 pipeline: str = "smb-vision", dtype: str = "bfloat16",
                 attn_impl: str = "auto"):
        self.checkpoint = checkpoint
        self.config_path = config_path
        self.model_id = model_id
        self.pipeline = pipeline
        self.dtype = dtype
        self.attn_impl = attn_impl
        self._encode = None

    def _config(self):
        from smb_vision_tpu.models.configs import VideoMAEConfig

        if self.config_path:
            config = VideoMAEConfig.from_json(self.config_path)
            config.update({"dtype": self.dtype,
                           "attn_impl": self.attn_impl})
        else:
            config = VideoMAEConfig(num_channels=1, tubelet_size=16,
                                    dtype=self.dtype,
                                    attn_impl=self.attn_impl)
        return config

    def create_dataset(self, items: List[Dict], out_dtype: str = "float32"):
        from smb_vision_tpu.data.dataset import CTDataset
        from smb_vision_tpu.data.preprocess import (
            CT_PIPELINES,
            PreprocessConfig,
        )

        # preprocess to the model's own grid (not a fixed pipeline size):
        # the encoder tolerates any grid, but positions are only meaningful
        # at the geometry it was trained on
        cfg = self._config()
        base = CT_PIPELINES[self.pipeline]
        pipe = PreprocessConfig(
            target_spacing=base.target_spacing,
            target_size=(cfg.image_size, cfg.image_size, cfg.num_frames),
            layout=base.layout)
        norm = [{"image": it.get("image_path", it.get("image")), **it}
                for it in items]
        return CTDataset(items=norm, pipeline=pipe, out_dtype=out_dtype)

    def setup_model(self):
        import jax
        import jax.numpy as jnp

        from smb_vision_tpu.models.videomae import VideoMAEModel

        config = self._config()
        model = VideoMAEModel(config)
        px = jnp.zeros((1, config.num_frames, 1, config.image_size,
                        config.image_size), jnp.float32)
        params = jax.jit(model.init)(jax.random.PRNGKey(0), px)
        if self.checkpoint:
            from smb_vision_tpu.models.convert import load_backbone_into

            params = load_backbone_into(params, self.checkpoint)

        # params as a jit ARGUMENT — closure-captured arrays would be
        # inlined into the compiled program as constants, copying the
        # weights into every executable
        @jax.jit
        def encode(p, px):
            out, _ = model.apply(p, px)
            return out.astype(jnp.float32)

        # uint8-shipped pixels: one byte per voxel over the wire, decoded
        # to bf16 inside the same compiled program (data/quantization.py)
        from smb_vision_tpu.data.quantization import dequantize_pixels

        @jax.jit
        def encode_q(p, q, s, o):
            out, _ = model.apply(
                p, dequantize_pixels(q, s, o, jnp.bfloat16))
            return out.astype(jnp.float32)

        self._params = params
        self._encode = encode
        self._encode_q = encode_q

    def generate_embedding(self, batch: np.ndarray, scale=None,
                           offset=None) -> np.ndarray:
        """batch (N, D, C, H, W) float — or uint8 codes with per-volume
        (scale, offset) affine keys for on-device dequantize."""
        import jax.numpy as jnp

        if scale is not None:
            return np.asarray(self._encode_q(
                self._params, jnp.asarray(batch),
                jnp.asarray(scale, jnp.float32),
                jnp.asarray(offset, jnp.float32)))
        return np.asarray(self._encode(self._params, jnp.asarray(batch)))


class BaseEncoderRunner:
    """Validates the manifest, resumes, batches, collects errors."""

    def __init__(self, encoder: BaseEncoder, output_dir: str,
                 fmt: str = "parquet", batch_size: int = 1,
                 num_workers: int = 8):
        self.encoder = encoder
        self.writer = EmbeddingWriter(output_dir, fmt=fmt,
                                      model_id=encoder.model_id)
        self.batch_size = batch_size
        self.num_workers = num_workers

    @staticmethod
    def load_input_json(path: str) -> List[Dict]:
        """Manifest format {"images": [{uid, image_path}]} (reference
        base_encoder.py:55-71); a bare list is also accepted."""
        with open(path) as f:
            blob = json.load(f)
        items = blob["images"] if isinstance(blob, dict) else blob
        for it in items:
            if "uid" not in it or not (it.get("image_path")
                                       or it.get("image")):
                raise ValueError(
                    f"manifest items need uid + image_path: got {it}")
        return items

    def run(self, items: List[Dict], resume: bool = True) -> Dict:
        done = self.writer.existing_uids() if resume else set()
        todo = [it for it in items if str(it["uid"]) not in done]
        if done:
            logger.info("resume: skipping %d processed uids", len(done))
        self.encoder.setup_model()
        ds = self.encoder.create_dataset(todo)
        if hasattr(ds, "__len__") and len(ds) != len(todo):
            # the batch loop pairs todo[i] with ds[i]; a dataset that drops
            # items at construction would silently write embeddings under
            # shifted uids — refuse instead (datasets must defer per-item
            # failures to __getitem__, where they are quarantined per uid)
            raise ValueError(
                f"create_dataset returned {len(ds)} items for {len(todo)} "
                "manifest entries; datasets must preserve 1:1 index pairing")

        errors: List[Dict] = []
        n_ok = 0
        from concurrent.futures import ThreadPoolExecutor

        def load(i):
            try:
                return i, ds[i], None
            except Exception as e:  # noqa: BLE001
                return i, None, {"item": todo[i], "error": str(e),
                                 "trace": traceback.format_exc(limit=3)}

        with ThreadPoolExecutor(self.num_workers) as pool:
            batch_items, batch_px = [], []
            for i, ex, err in pool.map(load, range(len(todo))):
                if err:
                    errors.append(err)
                    continue
                batch_items.append(todo[i])
                batch_px.append(ex["image"])
                if len(batch_items) == self.batch_size:
                    n_ok += self._flush(batch_items, batch_px, errors)
                    batch_items, batch_px = [], []
            if batch_items:
                n_ok += self._flush(batch_items, batch_px, errors)

        self.writer.finalize(errors)
        stats = {"embedded": n_ok, "failed": len(errors),
                 "skipped": len(done)}
        logger.info("%s", stats)
        return stats

    def _flush(self, items, pixels, errors) -> int:
        px = np.stack(pixels)
        if len(items) < self.batch_size:
            # pad the ragged final batch to the compiled batch shape: a
            # smaller batch would re-trace and recompile the whole model.
            # process_batch slices
            # emb[:len(items)], so the pad rows are discarded.
            pad = np.repeat(px[-1:], self.batch_size - len(items), axis=0)
            px = np.concatenate([px, pad], axis=0)
        try:
            embs = self.encoder.process_batch(items, px)
        except Exception as e:  # noqa: BLE001
            errors.extend({"item": it, "error": str(e)} for it in items)
            return 0
        for it, emb in zip(items, embs):
            self.writer.write(it, emb)
        return len(items)
