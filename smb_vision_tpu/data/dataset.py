"""Datasets + batching for CT volumes.

`CTDataset` is the PersistentDataset equivalent
(/root/reference/src/dataloader/load.py:70-142): preprocessed volumes are
cached to disk, keyed by an md5 of (item spec, pipeline config), with
atomic tempfile+rename writes and corrupt-cache detect+recompute. Unlike the
reference we cache plain ``.npy`` (not pickled torch tensors) and masks are
NOT part of the cache — mask generation happens on device in the train step,
so caches are reusable across mask configs and steps stay replayable.

`BatchLoader` replaces torch DataLoader worker pools: a thread pool decodes/
loads cache entries ahead of time and an iterator yields stacked numpy
batches; `prefetch_to_device` double-buffers host->device transfers.
"""

from __future__ import annotations

import hashlib
import json
import os
import queue
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from smb_vision_tpu.data.load import load_data
from smb_vision_tpu.data.nifti import load_nifti
from smb_vision_tpu.data.preprocess import (
    CT_PIPELINES,
    PreprocessConfig,
    preprocess_volume,
)


def _pipeline_cfg(p) -> PreprocessConfig:
    return CT_PIPELINES[p] if isinstance(p, str) else p


def _float_dtype(name) -> np.dtype:
    """np.dtype for a float name, accepting "bfloat16" (ml_dtypes-backed,
    which numpy's dtype constructor does not resolve by string)."""
    try:
        return np.dtype(name)
    except TypeError:
        import ml_dtypes

        return np.dtype(getattr(ml_dtypes, str(name)))


class CTDataset:
    """Map-style dataset of preprocessed CT volumes (+ passthrough labels).

    Also fills the reference's missing-`CTDataset` hole (run_inference.py:11
    imports a class that never existed — SURVEY §2 known-broken item 1)."""

    def __init__(self, data_path=None, split: Optional[str] = "train",
                 pipeline="smb-vision", cache_dir: Optional[str] = None,
                 items: Optional[List[Dict]] = None,
                 image_key: str = "image", max_samples: Optional[int] = None,
                 backend: str = "auto", ram_cache: bool = False,
                 cache_dtype: str = "float32",
                 out_dtype: str = "float32"):
        """backend: "native" (C++ loader, GIL-free), "python", or "auto"
        (native when built, else python). ram_cache additionally memoises
        preprocessed volumes in memory (the reference's CacheDataset mode,
        mim.py:210-236) — use when the dataset fits in host RAM.
        cache_dtype: on-disk dtype for cached volumes; "float16" halves
        disk/IO/transfer bytes at ~1e-4 absolute rounding on the
        HU-windowed [0,1] values; "uint8" quarters them (per-volume
        affine codes + scale/offset in an npz, max abs err
        (max-min)/510). Participates in the cache key.
        out_dtype: dtype of returned volumes ("float32" default;
        "float16"/"bfloat16" carry a half-precision cache straight
        through to device_put with at most one host cast — on
        CPU/bandwidth-constrained hosts the f16->f32->bf16 round trip
        was the steady-state bottleneck, three full-volume array ops
        per step; "uint8" ships codes + per-sample affine keys for
        on-device decode — see data/quantization.py)."""
        if items is None:
            items = load_data(data_path, split=split)
        if max_samples:
            items = items[:max_samples]
        self.items = items
        self.image_key = image_key
        self.pipeline = _pipeline_cfg(pipeline)
        self.cache_dir = Path(cache_dir) if cache_dir else None
        if self.cache_dir:
            self.cache_dir.mkdir(parents=True, exist_ok=True)
        from smb_vision_tpu.data.preprocess import PREPROCESS_VERSION

        self.cache_dtype = np.dtype(cache_dtype)
        self.out_dtype = _float_dtype(out_dtype)
        # version participates in the key: numerics changes (e.g. the
        # anti-aliasing fix) must invalidate previously cached volumes;
        # so does the cache dtype (float16 files are not float32 files)
        dt_tag = "" if self.cache_dtype == np.float32 else str(
            self.cache_dtype)
        self._pipe_hash = hashlib.md5(
            (repr(self.pipeline) + PREPROCESS_VERSION + dt_tag).encode()
        ).hexdigest()[:12]
        if backend == "auto":
            from smb_vision_tpu.data.native import native_available

            backend = "native" if native_available() else "python"
        self.backend = backend
        self.ram_cache = ram_cache
        self._ram: Dict[int, np.ndarray] = {}

    def __len__(self) -> int:
        return len(self.items)

    def _cache_path(self, item: Dict) -> Optional[Path]:
        if self.cache_dir is None:
            return None
        # key on the IMAGE PATH only (plus the pipeline hash): the cached
        # pixels do not depend on labels/splits/metadata, so a training
        # item and an inference item naming the same volume share one
        # entry instead of preprocessing it twice
        key = hashlib.md5(
            (str(item[self.image_key]) + self._pipe_hash).encode()
        ).hexdigest()
        return self.cache_dir / f"{key}.npy"

    def _compute(self, item: Dict) -> np.ndarray:
        if self.backend == "native":
            from smb_vision_tpu.data.native import native_preprocess_volume

            return native_preprocess_volume(item[self.image_key],
                                            self.pipeline)
        img = load_nifti(item[self.image_key])
        # bucket=32 bounds jit recompiles over mixed CT geometries (one
        # compile per padded input bucket; numerics identical to exact)
        return preprocess_volume(img.data, img.affine, self.pipeline,
                                 bucket=32)

    def _load_entry(self, item: Dict):
        """-> (array, scale, offset): uint8 codes + affine when the cache
        stores uint8 (cache_dtype='uint8' writes an npz of q/scale/offset),
        else (float array in cache_dtype, None, None)."""
        from smb_vision_tpu.data.quantization import quantize_volume

        cache = self._cache_path(item)
        if cache is not None and cache.is_file():
            try:
                loaded = np.load(cache)
                if isinstance(loaded, np.lib.npyio.NpzFile):
                    with loaded:
                        return (loaded["q"], np.float32(loaded["scale"]),
                                np.float32(loaded["offset"]))
                return loaded, None, None
            except (ValueError, EOFError, OSError, KeyError):
                # corrupt cache: delete and recompute (ref load.py:107-112)
                try:
                    cache.unlink()
                except OSError:
                    pass
        vol = self._compute(item)
        q = s = o = None
        if self.cache_dtype == np.uint8:
            q, s, o = quantize_volume(vol)
        if cache is not None:
            # atomic write: tempfile in same dir + rename (ref :118-135)
            fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    if q is not None:
                        np.savez(f, q=q, scale=s, offset=o)
                    else:
                        np.save(f, vol.astype(self.cache_dtype, copy=False))
                os.replace(tmp, cache)
            except OSError:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
        if q is not None:
            # return the quantized values so epoch 1 matches later epochs
            return q, s, o
        if vol.dtype != self.cache_dtype:
            # first-epoch values must match what later epochs reload from
            # the cache, or the same sample drifts across epochs
            vol = vol.astype(self.cache_dtype)
        return vol, None, None

    def _example_pixels(self, item: Dict):
        """-> (image, scale, offset) in the out_dtype contract: uint8
        codes + per-volume affine when out_dtype='uint8' (decoded on
        device by quantization.dequantize_batch), else a float volume
        with scale/offset None."""
        if self.out_dtype == np.uint8:
            from smb_vision_tpu.data.quantization import quantize_volume

            arr, s, o = self._load_entry(item)
            if s is None:
                # float cache + uint8 shipping: quantize per load (the
                # zero-recompute config is cache_dtype='uint8')
                arr, s, o = quantize_volume(arr)
            return arr, s, o
        # float contract: load_volume is the (subclass-spied) hook
        return self.load_volume(item), None, None

    def load_volume(self, item: Dict) -> np.ndarray:
        """Float pixel volume (out_dtype, or f32 when out_dtype='uint8')."""
        from smb_vision_tpu.data.quantization import dequantize_volume

        dt = np.float32 if self.out_dtype == np.uint8 else self.out_dtype
        arr, s, o = self._load_entry(item)
        if s is not None:
            return dequantize_volume(arr, s, o, dt)
        return arr.astype(dt, copy=False)

    def __getitem__(self, idx: int) -> Dict:
        item = dict(self.items[idx])
        if self.ram_cache and idx in self._ram:
            vol, s, o = self._ram[idx]
        else:
            vol, s, o = self._example_pixels(item)
            if self.ram_cache:
                self._ram[idx] = (vol, s, o)
        out = {"image": vol}
        if s is not None:
            out["image_scale"] = s
            out["image_offset"] = o
        for k, v in item.items():
            if k != self.image_key:
                out[k] = v
        out["_item"] = item
        return out


def partition_items(items: Sequence, num_shards: int, shard: int,
                    even: bool = True) -> List:
    """Multi-host dataset sharding (the reference's partition_dataset over
    world size, mim.py:190-204), keyed on jax.process_index() by callers."""
    picked = list(items[shard::num_shards])
    if even and items:
        target = -(-len(items) // num_shards)
        i = 0
        while len(picked) < target:
            picked.append(items[(shard + i) % len(items)])
            i += 1
    return picked


class BatchLoader:
    """Threaded prefetching batch iterator over a CTDataset.

    collate: callable(list[dict]) -> dict of np arrays. Drops the last
    partial batch when drop_last (training needs static shapes)."""

    def __init__(self, dataset, batch_size: int, *, shuffle: bool = False,
                 seed: int = 0, num_workers: int = 8, drop_last: bool = True,
                 collate=None, prefetch: int = 2):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = num_workers
        self.drop_last = drop_last
        self.collate = collate or default_collate
        self.prefetch = prefetch
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        n = len(self.ds)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        order = np.arange(len(self.ds))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        nb = len(self)
        batches = [order[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]

        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        failure = []

        def _put(obj) -> bool:
            """Bounded put that gives up when the consumer stopped reading
            (mid-epoch break) — otherwise the producer thread would block
            forever on the full queue."""
            while not stop.is_set():
                try:
                    q.put(obj, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for idxs in batches:
                        if stop.is_set():
                            return
                        examples = list(pool.map(self.ds.__getitem__, idxs))
                        if not _put(self.collate(examples)):
                            return
            except Exception as e:  # noqa: BLE001 — re-raised in consumer
                failure.append(e)
            finally:
                _put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    if failure:
                        raise failure[0]
                    return
                yield batch
        finally:
            stop.set()


def default_collate(examples: List[Dict]) -> Dict[str, np.ndarray]:
    out = {"pixel_values": np.stack([e["image"] for e in examples])}
    if "image_scale" in examples[0]:
        # uint8-shipped pixels: per-sample affine rides along (decoded on
        # device by quantization.dequantize_batch inside the jitted step)
        out["pixel_scale"] = np.asarray(
            [e["image_scale"] for e in examples], np.float32)
        out["pixel_offset"] = np.asarray(
            [e["image_offset"] for e in examples], np.float32)
    return out


class DeviceCachedBatchLoader(BatchLoader):
    """BatchLoader that pins each volume's pixels in DEVICE memory after
    its first (host) load; from the second epoch on, batches are
    assembled on device and the host moves zero pixel bytes per step.

    Epoch caching for datasets that fit device memory alongside the
    model state (fine-tune cohorts, small/medium pretraining sets: a
    512**2 x 320 volume is 168 MB in bf16). Where bulk host memory ops
    or the host->device link bound the step, this removes them from the
    steady state.

    Restrictions: pixel-only batches (the pretraining workloads — MIM /
    V-JEPA mask generation happens on device from the PRNG key, so
    ``default_collate`` yields exactly {"pixel_values"}), and no
    host-side grad-accum pre-split (accum == 1). The trainer skips its
    host-side input cast for device batches; pass ``input_dtype`` here
    so cached pixels are stored pre-cast.
    """

    def __init__(self, *args, input_dtype=None, sharding=None, **kwargs):
        super().__init__(*args, **kwargs)
        if self.collate is not default_collate:
            raise ValueError(
                "DeviceCachedBatchLoader caches pixel-only batches "
                "(default_collate); fine-tune loaders with label columns "
                "should use the host BatchLoader")
        self.input_dtype = (_float_dtype(input_dtype)
                            if input_dtype is not None else None)
        self.sharding = sharding     # attached by the Trainer (batch spec)
        self._dev: Dict[int, object] = {}

    def attach_sharding(self, sharding):
        """Called by the Trainer once the mesh exists; volumes cached
        before that ship replicated and are resharded on first use."""
        self.sharding = sharding

    def _volume_on_device(self, idx: int):
        import jax

        entry = self._dev.get(int(idx))
        if entry is None:
            ex = self.ds[int(idx)]
            px = ex["image"][None]                     # (1, D, C, H, W)
            if ("image_scale" not in ex and self.input_dtype is not None
                    and px.dtype != self.input_dtype):
                px = px.astype(self.input_dtype)
            entry = (jax.device_put(px),)
            if "image_scale" in ex:
                # uint8 volumes pin at 1 byte/voxel — 2x the capacity
                # of the bf16 cache; decoded in-step by dequantize_batch
                entry += (jax.device_put(np.asarray([ex["image_scale"]],
                                                    np.float32)),
                          jax.device_put(np.asarray([ex["image_offset"]],
                                                    np.float32)))
            self._dev[int(idx)] = entry
        return entry

    def __iter__(self):
        import jax
        import jax.numpy as jnp

        order = np.arange(len(self.ds))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        nb = len(self)
        for i in range(nb):
            idxs = order[i * self.batch_size:(i + 1) * self.batch_size]
            vols = [self._volume_on_device(j) for j in idxs]
            parts = [vols[0][k] if len(vols) == 1
                     else jnp.concatenate([v[k] for v in vols], axis=0)
                     for k in range(len(vols[0]))]
            if self.sharding is not None:
                parts = [jax.device_put(p, self.sharding) for p in parts]
            batch = {"pixel_values": parts[0]}
            if len(parts) == 3:
                batch["pixel_scale"] = parts[1]
                batch["pixel_offset"] = parts[2]
            yield batch


def prefetch_to_device(iterator, sharding=None, size: int = 2,
                       sharding_fn=None):
    """Double-buffered host->device pipeline: keeps `size` batches in flight
    so H2D DMA overlaps the train step (replaces pinned-memory DataLoader
    prefetch, ref mim.py:265-299). `sharding_fn(batch)` overrides the static
    sharding per batch (e.g. partial eval batches replicate)."""
    import collections

    import jax

    buf = collections.deque()

    def put(batch):
        sh = sharding_fn(batch) if sharding_fn is not None else sharding
        if sh is not None:
            return jax.tree_util.tree_map(
                lambda x: jax.device_put(x, sh), batch)
        return jax.tree_util.tree_map(jax.device_put, batch)

    it = iter(iterator)
    try:
        for _ in range(size):
            buf.append(put(next(it)))
    except StopIteration:
        pass
    while buf:
        batch = buf.popleft()
        try:
            buf.append(put(next(it)))
        except StopIteration:
            pass
        yield batch
