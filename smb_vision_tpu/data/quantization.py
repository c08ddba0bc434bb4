"""Opt-in uint8 pixel shipping: per-volume affine quantization.

On hosts whose host->device link bounds the step (a full-res volume is
168 MB in bf16), the upload dominates steady-state training. Shipping pixels
as uint8 with a per-volume affine (x ~= q * scale + offset) halves the
bytes again relative to bf16 and quarters them relative to f32, at a
bounded absolute error of scale/2 = (max-min)/510 per voxel — for the
HU-windowed [0, 1] CT pipelines that is ~2e-3, the same order as bf16's
own rounding (relative eps ~4e-3).

The dequant runs ON DEVICE inside the jitted step (see
``dequantize_batch``; the Trainer and run_inference wrap their compiled
fns with it when ``input_dtype == "uint8"``), so the host never touches
float pixel arrays and the wire carries one byte per voxel. The affine
coefficients ride along as two f32 scalars per sample
(``pixel_scale`` / ``pixel_offset`` batch keys).

No reference counterpart: the reference ships f32 tensors through torch
DataLoader pin-memory (mim.py:265-299). Whether it pays over PCIe on the
GPU host has not been measured; correctness is bounded by the per-voxel
error above (tests/test_quantized_inputs.py).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

# keys a quantized batch carries alongside "pixel_values" (uint8)
SCALE_KEY = "pixel_scale"
OFFSET_KEY = "pixel_offset"

# chunk rows so the host math stays in small f32 blocks — this VM's CPU
# is pathologically slow on monolithic full-volume float ops but fine
# slice-wise (memory: round3-findings)
_CHUNK_ROWS = 16


def quantize_volume(vol: np.ndarray) -> Tuple[np.ndarray, np.float32,
                                              np.float32]:
    """(float volume) -> (uint8 codes, scale, offset) with
    vol ~= codes * scale + offset and |err| <= scale / 2 per voxel."""
    lo = float(vol.min())
    hi = float(vol.max())
    scale = (hi - lo) / 255.0
    if scale <= 0.0 or not np.isfinite(scale):
        # constant (or degenerate) volume: all-zero codes decode to lo
        return (np.zeros(vol.shape, np.uint8), np.float32(1.0),
                np.float32(lo))
    q = np.empty(vol.shape, np.uint8)
    inv = 1.0 / scale
    flat_in = vol.reshape(vol.shape[0], -1)
    flat_out = q.reshape(vol.shape[0], -1)
    for i in range(0, vol.shape[0], _CHUNK_ROWS):
        blk = flat_in[i:i + _CHUNK_ROWS].astype(np.float32)
        np.rint((blk - lo) * inv, out=blk)
        np.clip(blk, 0.0, 255.0, out=blk)
        flat_out[i:i + _CHUNK_ROWS] = blk.astype(np.uint8)
    return q, np.float32(scale), np.float32(lo)


def dequantize_volume(q: np.ndarray, scale, offset,
                      dtype=np.float32) -> np.ndarray:
    """Host-side inverse of quantize_volume (chunked, see _CHUNK_ROWS)."""
    out = np.empty(q.shape, dtype)
    s = float(scale)
    o = float(offset)
    flat_in = q.reshape(q.shape[0], -1)
    flat_out = out.reshape(q.shape[0], -1)
    for i in range(0, q.shape[0], _CHUNK_ROWS):
        flat_out[i:i + _CHUNK_ROWS] = (
            flat_in[i:i + _CHUNK_ROWS].astype(np.float32) * s + o)
    return out


def quantize_batch(batch: Dict) -> Dict:
    """Host fallback for loaders that yield float pixels when the run
    asked for uint8 shipping (the zero-cost path is CTDataset
    out_dtype='uint8', which quantizes once at cache-write time)."""
    px = np.asarray(batch["pixel_values"])
    if px.dtype == np.uint8:
        return batch
    qs, ss, os_ = [], [], []
    for b in range(px.shape[0]):
        q, s, o = quantize_volume(px[b])
        qs.append(q)
        ss.append(s)
        os_.append(o)
    out = dict(batch)
    out["pixel_values"] = np.stack(qs)
    out[SCALE_KEY] = np.asarray(ss, np.float32)
    out[OFFSET_KEY] = np.asarray(os_, np.float32)
    return out


def dequantize_pixels(q, scale, offset, dtype=None):
    """On-device affine decode with per-sample coefficients.

    q: (..., B, spatial...) uint8; scale/offset: any prefix shape of q
    (e.g. (B,) for a plain batch, (accum, micro) for a host-pre-split
    grad-accum batch) — broadcast over the trailing pixel dims."""
    import jax.numpy as jnp

    dtype = dtype or jnp.float32
    extra = q.ndim - scale.ndim
    shape = tuple(scale.shape) + (1,) * extra
    s = scale.reshape(shape).astype(dtype)
    o = offset.reshape(shape).astype(dtype)
    return q.astype(dtype) * s + o


def dequantize_batch(batch: Dict, dtype=None) -> Dict:
    """Decode a quantized batch inside a jitted fn; no-op on float
    batches (dtypes are static under trace, so this `if` is free)."""
    px = batch.get("pixel_values")
    if px is None or px.dtype != np.uint8:
        return batch
    if SCALE_KEY not in batch:
        raise ValueError(
            "uint8 pixel_values without pixel_scale/pixel_offset — "
            "quantized batches must come from CTDataset(out_dtype='uint8') "
            "or quantize_batch()")
    out = {k: v for k, v in batch.items()
           if k not in (SCALE_KEY, OFFSET_KEY)}
    out["pixel_values"] = dequantize_pixels(
        px, batch[SCALE_KEY], batch[OFFSET_KEY], dtype=dtype)
    return out
