"""CT preprocessing: the JAX/numpy equivalent of the reference's MONAI
transform chains (/root/reference/src/dataloader/transforms.py:220-314):

    LoadImaged -> EnsureChannelFirstd -> Orientationd(RAS) -> Spacingd
    -> ScaleIntensityRanged(-1000..1000 -> 0..1) -> SpatialPadd
    -> CenterSpatialCropd -> [PermuteImage]

Design: orientation is a cheap numpy transpose/flip on host; the heavy
trilinear resample + window + pad/crop is ONE jitted device function
(`device_preprocess`), compiled per input-shape bucket and fed from pinned
host arrays. On CPU-only paths everything still works (jit on CPU backend).

Named pipeline configs mirror ct_transforms keys: "mim", "vjepa",
"smb-vision", "dinov2", "merlin" (same spacings / HU window / target sizes).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

# bump when preprocessing numerics change — invalidates disk caches
PREPROCESS_VERSION = "3"

# ---------------------------------------------------------------------------
# Orientation (host, zero-copy views)
# ---------------------------------------------------------------------------

_RAS_CODES = ("R", "A", "S")


def io_orientation(affine: np.ndarray) -> list:
    """For each world axis (R, A, S) find the dominant input axis and its
    sign. Returns [(axis, flip), ...] such that transposing to `axis` order
    and flipping where flip<0 yields RAS orientation (nearest-axis logic,
    equivalent to nibabel/MONAI for orthogonal-ish affines)."""
    R = affine[:3, :3].copy()
    # normalise columns (voxel axes) to unit world directions
    norms = np.linalg.norm(R, axis=0)
    norms[norms == 0] = 1.0
    Q = R / norms
    out = []
    used = set()
    for world in range(3):
        best, best_ax = 0.0, None
        for ax in range(3):
            if ax in used:
                continue
            if abs(Q[world, ax]) >= best:
                best, best_ax = abs(Q[world, ax]), ax
        used.add(best_ax)
        out.append((best_ax, 1.0 if Q[world, best_ax] >= 0 else -1.0))
    return out


def to_ras(data: np.ndarray, affine: np.ndarray
           ) -> Tuple[np.ndarray, np.ndarray]:
    """Reorient (x,y,z) volume + affine to RAS axis order/direction."""
    ornt = io_orientation(affine)
    axes = [a for a, _ in ornt]
    data = np.transpose(data, axes)
    new_aff = np.eye(4)
    new_aff[:3, :3] = affine[:3, axes]
    new_aff[:3, 3] = affine[:3, 3]
    for i, (_, sign) in enumerate(ornt):
        if sign < 0:
            data = np.flip(data, axis=i)
            # translate origin to the other end of the axis
            new_aff[:3, 3] = (new_aff[:3, 3]
                              + new_aff[:3, i] * (data.shape[i] - 1))
            new_aff[:3, i] = -new_aff[:3, i]
    return np.ascontiguousarray(data), new_aff


# ---------------------------------------------------------------------------
# Device pipeline
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PreprocessConfig:
    """One named transform pipeline (a ct_transforms entry)."""

    target_spacing: Tuple[float, float, float]
    target_size: Tuple[int, int, int]      # (H, W, D) after pad+crop
    hu_window: Tuple[float, float] = (-1000.0, 1000.0)
    out_range: Tuple[float, float] = (0.0, 1.0)
    clip: bool = True
    layout: str = "DCHW"   # "DCHW" (PermuteImage: depth-as-frames) | "CHWD"


# mirrors ct_transforms (transforms.py:220-314)
CT_PIPELINES = {
    "mim": PreprocessConfig((1.5, 1.5, 3.0), (224, 224, 160)),
    "vjepa": PreprocessConfig((1.0, 1.0, 1.5), (384, 384, 256)),
    "smb-vision": PreprocessConfig((1.5, 1.5, 3.0), (224, 224, 160)),
    "dinov2": PreprocessConfig((1.5, 1.5, 3.0), (224, 224, 160),
                               layout="CHWD"),
    "merlin": PreprocessConfig((1.5, 1.5, 3.0), (224, 224, 160),
                               layout="CHWD"),
}


def resampled_shape(in_shape, in_spacing, out_spacing) -> Tuple[int, ...]:
    """New voxel grid preserving physical extent (MONAI Spacingd sizing:
    ceil(size * in_sp / out_sp), keeping end voxels in range)."""
    return tuple(
        max(int(np.ceil(s * si / so - 1e-4)), 1)
        for s, si, so in zip(in_shape, in_spacing, out_spacing))


def _trilinear_resize(vol: jax.Array, out_shape, scales) -> jax.Array:
    """Pure (non-anti-aliased) separable trilinear resampling with the
    MONAI Spacingd convention: src = dst * (out_spacing / in_spacing),
    origin-voxel-aligned, edges clamped (padding_mode='border').

    MONAI's Spacing builds dst->src as inv(src_affine) @ zoom_affine(...)
    — zoom_affine rescales the direction columns and KEEPS the translation
    (/root/reference/src/dataloader/transforms.py:222-312 chains Spacingd),
    so voxel 0 of the output lands exactly on voxel 0 of the input and the
    per-axis scale is the spacing ratio, not the shape ratio. Verified
    against torch grid_sample goldens in tests/test_data.py.

    NOT jax.image.resize: that anti-aliases on downscale (triangle filter
    widened by the scale factor), while MONAI/grid_sample point-sample.
    Matches csrc/ctloader.cpp exactly."""
    for axis, (out_n, scale) in enumerate(zip(out_shape, scales)):
        in_n = vol.shape[axis]
        if in_n == out_n and abs(scale - 1.0) < 1e-12:
            continue
        f = jnp.arange(out_n, dtype=jnp.float32) * scale
        f = jnp.clip(f, 0.0, in_n - 1)
        i0 = jnp.clip(jnp.floor(f).astype(jnp.int32), 0, in_n - 1)
        i1 = jnp.clip(i0 + 1, 0, in_n - 1)
        w = jnp.clip(f - jnp.floor(f), 0.0, 1.0)
        a = jnp.take(vol, i0, axis=axis)
        b = jnp.take(vol, i1, axis=axis)
        shape = [1, 1, 1]
        shape[axis] = out_n
        w = w.reshape(shape)
        vol = a * (1.0 - w) + b * w
    return vol


@functools.partial(jax.jit, static_argnames=("out_shape", "scales", "hu",
                                             "rng", "clip", "target"))
def _device_resample_window_fit(vol: jax.Array, out_shape, scales, hu, rng,
                                clip, target) -> jax.Array:
    """volume (H, W, D) float -> resample to out_shape -> window -> pad/crop
    to target. One fused compiled program per (in_shape, out_shape)."""
    vol = vol.astype(jnp.float32)
    vol = _trilinear_resize(vol, out_shape, scales)
    a_min, a_max = hu
    b_min, b_max = rng
    vol = (vol - a_min) / (a_max - a_min) * (b_max - b_min) + b_min
    if clip:
        vol = jnp.clip(vol, min(b_min, b_max), max(b_min, b_max))

    # SpatialPadd (symmetric, extra voxel at the end) then center crop —
    # MONAI conventions (Pad: half = (target-cur)//2; CenterSpatialCrop:
    # start = (cur-target)//2 about the centre)
    pads = []
    for cur, tgt in zip(vol.shape, target):
        extra = max(tgt - cur, 0)
        half = extra // 2
        pads.append((half, extra - half))
    vol = jnp.pad(vol, pads, constant_values=b_min)
    slices = []
    for cur, tgt in zip(vol.shape, target):
        start = max(cur // 2 - tgt // 2, 0)
        slices.append(slice(start, start + tgt))
    return vol[tuple(slices)]


@functools.partial(jax.jit, static_argnames=("out_shape", "scales", "hu",
                                             "rng", "clip"))
def _device_resample_window(vol: jax.Array, out_shape, scales, hu, rng,
                            clip) -> jax.Array:
    """Resample + window WITHOUT the fixed-size fit — used by the
    sliding-window path, which keeps the native (resampled) extent."""
    vol = vol.astype(jnp.float32)
    vol = _trilinear_resize(vol, out_shape, scales)
    a_min, a_max = hu
    b_min, b_max = rng
    vol = (vol - a_min) / (a_max - a_min) * (b_max - b_min) + b_min
    if clip:
        vol = jnp.clip(vol, min(b_min, b_max), max(b_min, b_max))
    return vol


def preprocess_volume_full(data: np.ndarray, affine: np.ndarray,
                           pipeline: str | PreprocessConfig,
                           pad_multiple: int = 32) -> np.ndarray:
    """RAS + resample + window, preserving the volume's full extent
    (padded up to `pad_multiple` per axis to bound jit recompiles).
    Returns (H, W, D) float32 — feed to sliding-window inference."""
    cfg = CT_PIPELINES[pipeline] if isinstance(pipeline, str) else pipeline
    if data.ndim == 4:
        data = data[..., 0]
    data, affine = to_ras(data, affine)
    spacing = tuple(float(np.linalg.norm(affine[:3, i])) for i in range(3))
    out_shape = resampled_shape(data.shape, spacing, cfg.target_spacing)
    scales = tuple(so / si for si, so in zip(spacing, cfg.target_spacing))
    vol = jnp.asarray(np.ascontiguousarray(data, dtype=np.float32))
    out = np.asarray(_device_resample_window(
        vol, out_shape, scales, cfg.hu_window, cfg.out_range, cfg.clip))
    # pad (after resampling — padding the resize target would change the
    # effective spacing) so window tiling sees round sizes
    pads = [(0, (-s) % pad_multiple) for s in out.shape]
    if any(p[1] for p in pads):
        out = np.pad(out, pads, constant_values=cfg.out_range[0])
    return out


@functools.partial(jax.jit, static_argnames=("hu", "rng", "clip", "target"))
def _device_fit_dynamic(vol: jax.Array, true_shape: jax.Array,
                        scales: jax.Array, hu, rng, clip,
                        target) -> jax.Array:
    """Bucketed variant of _device_resample_window_fit: ONE compiled
    program per padded input bucket, with the resample geometry (true
    input extent, spacing ratios, crop offsets) as runtime values.

    Fuses Spacingd + window + SpatialPadd + CenterSpatialCropd by mapping
    every target voxel directly to its source coordinate:
      r  = d + off          (off from MONAI center pad/crop arithmetic)
      src = r * scale        (origin-aligned Spacingd map)
      out-of-range r -> pad value.
    Numerically identical to the static path (same gather weights);
    verified in tests/test_data.py::test_preprocess_bucketed_matches_exact.
    """
    vol = vol.astype(jnp.float32)
    a_min, a_max = hu
    b_min, b_max = rng

    valids = []
    for axis, tgt in enumerate(target):
        in_n = true_shape[axis]
        scale = scales[axis]
        # resampled extent rs = ceil(in_n * si/so - 1e-4) = ceil(in_n/scale)
        rs = jnp.ceil(in_n.astype(jnp.float32) / scale - 1e-4).astype(
            jnp.int32)
        rs = jnp.maximum(rs, 1)
        # MONAI pad-then-crop offset: r = d + off
        off = jnp.where(rs >= tgt, rs // 2 - tgt // 2, -((tgt - rs) // 2))
        d = jnp.arange(tgt, dtype=jnp.int32)
        r = d + off
        valid = (r >= 0) & (r < rs)
        f = r.astype(jnp.float32) * scale.astype(jnp.float32)
        f = jnp.clip(f, 0.0, (in_n - 1).astype(jnp.float32))
        i0 = jnp.clip(jnp.floor(f).astype(jnp.int32), 0, in_n - 1)
        i1 = jnp.clip(i0 + 1, 0, in_n - 1)
        w = jnp.clip(f - jnp.floor(f), 0.0, 1.0)
        a = jnp.take(vol, i0, axis=axis)
        b = jnp.take(vol, i1, axis=axis)
        shape = [1, 1, 1]
        shape[axis] = tgt
        vol = a * (1.0 - w.reshape(shape)) + b * w.reshape(shape)
        valids.append(valid.reshape(shape))

    vol = (vol - a_min) / (a_max - a_min) * (b_max - b_min) + b_min
    if clip:
        vol = jnp.clip(vol, min(b_min, b_max), max(b_min, b_max))
    mask = valids[0] & valids[1] & valids[2]
    return jnp.where(mask, vol, b_min)


def preprocess_volume(data: np.ndarray, affine: np.ndarray,
                      pipeline: str | PreprocessConfig,
                      device: Optional[jax.Device] = None,
                      bucket: Optional[int] = None) -> np.ndarray:
    """Full chain for one volume: RAS reorient (host) + device
    resample/window/pad/crop. Returns the model-input array:

      layout "DCHW": (D, 1, H, W)  — depth-as-frames (PermuteImage,
                      transforms.py:84-93: (C,H,W,D) -> (D,C,H,W))
      layout "CHWD": (1, H, W, D)

    bucket: pad the input to a multiple of `bucket` per axis and use the
    dynamic-geometry kernel — bounds jit compiles to one per input-shape
    bucket over arbitrarily varied CT geometries (the round-1 path
    compiled once per distinct volume shape).
    """
    cfg = CT_PIPELINES[pipeline] if isinstance(pipeline, str) else pipeline
    if data.ndim == 4:  # drop trailing singleton (time) dims
        data = data[..., 0]
    data, affine = to_ras(data, affine)
    spacing = tuple(float(np.linalg.norm(affine[:3, i])) for i in range(3))
    out_shape = resampled_shape(data.shape, spacing, cfg.target_spacing)
    scales = tuple(so / si for si, so in zip(spacing, cfg.target_spacing))

    if bucket:
        true_shape = np.asarray(data.shape, np.int32)
        pads = [(0, (-s) % bucket) for s in data.shape]
        if any(p[1] for p in pads):
            data = np.pad(data, pads)
        vol = jnp.asarray(np.ascontiguousarray(data, dtype=np.float32))
        out = _device_fit_dynamic(
            vol, jnp.asarray(true_shape), jnp.asarray(scales, jnp.float32),
            cfg.hu_window, cfg.out_range, cfg.clip, cfg.target_size)
    else:
        vol = jnp.asarray(np.ascontiguousarray(data, dtype=np.float32))
        out = _device_resample_window_fit(
            vol, out_shape, scales, cfg.hu_window, cfg.out_range, cfg.clip,
            cfg.target_size)
    out = np.asarray(out)

    if cfg.layout == "DCHW":
        # (H, W, D) -> (D, C=1, H, W)
        return np.ascontiguousarray(out.transpose(2, 0, 1))[:, None]
    # (H, W, D) -> (C=1, H, W, D)
    return out[None]
