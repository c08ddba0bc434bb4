"""3D rotary position embeddings (V-JEPA2 style).

Numerically matches the reference's per-axis rotary split
(/root/reference/src/models/vjepa/modeling_vjepa.py:204-228,262-264,277-326):
the head dim is split into three equal even chunks (depth/height/width axes,
chunk = 2*((head_dim//3)//2)) plus an unrotated remainder. Within a chunk the
reference uses *concatenated* (not interleaved) sin/cos tiling combined with
*interleaved* pair rotation — we replicate that exact quirk so converted
facebook/vjepa2 checkpoints produce identical outputs.

Difference from the reference: it recomputes frequencies inside every
attention layer; here the cos/sin tables are computed once per forward pass
(they depend only on token positions) and passed down, saving 2*L transcendental
sweeps per step.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp


def rope_axis_dims(head_dim: int) -> Tuple[int, int, int, int]:
    """(d_dim, h_dim, w_dim, remainder) split of the head dim."""
    c = int(2 * ((head_dim // 3) // 2))
    return c, c, c, head_dim - 3 * c


def position_ids_3d(ids: jax.Array, grid_hw: int) -> Tuple[jax.Array, ...]:
    """Decompose flat token ids into (frame, height, width) coordinates.
    Matches reference get_position_ids (modeling_vjepa.py:290-309)."""
    tokens_per_frame = grid_hw * grid_hw
    frame = ids // tokens_per_frame
    rem = ids - frame * tokens_per_frame
    height = rem // grid_hw
    width = rem - height * grid_hw
    return frame, height, width


def _axis_cos_sin(pos: jax.Array, dim: int, dtype) -> Tuple[jax.Array, jax.Array]:
    """cos/sin table for one axis: pos (..., N) -> (..., N, dim).

    Reference tiling: freq = outer(pos, omega) with omega over dim/2, then
    sin/cos are *concatenated* twice along the feature dim
    (rotate_queries_or_keys: `.repeat(1, 1, 1, 2)` after squeeze)."""
    half = dim // 2
    omega = jnp.arange(half, dtype=jnp.float32) / float(half)
    omega = 1.0 / (10000.0 ** omega)                       # (half,)
    freq = pos[..., None].astype(jnp.float32) * omega      # (..., N, half)
    sin = jnp.sin(freq)
    cos = jnp.cos(freq)
    sin = jnp.concatenate([sin, sin], axis=-1).astype(dtype)
    cos = jnp.concatenate([cos, cos], axis=-1).astype(dtype)
    return cos, sin


def rope3d_cos_sin(ids: jax.Array, grid_hw: int, head_dim: int,
                   dtype=jnp.float32) -> Tuple[jax.Array, jax.Array]:
    """Full-head cos/sin tables: ids (..., N) -> each (..., N, head_dim).
    The unrotated remainder gets cos=1, sin=0."""
    d_dim, h_dim, w_dim, rem = rope_axis_dims(head_dim)
    f, h, w = position_ids_3d(ids, grid_hw)
    parts_cos, parts_sin = [], []
    for pos, dim in ((f, d_dim), (h, h_dim), (w, w_dim)):
        c, s = _axis_cos_sin(pos, dim, dtype)
        parts_cos.append(c)
        parts_sin.append(s)
    if rem:
        shape = ids.shape + (rem,)
        parts_cos.append(jnp.ones(shape, dtype))
        parts_sin.append(jnp.zeros(shape, dtype))
    return jnp.concatenate(parts_cos, axis=-1), jnp.concatenate(parts_sin, axis=-1)


def _rotate_pairs(x: jax.Array) -> jax.Array:
    """Interleaved pair rotation y[2i] = -x[2i+1], y[2i+1] = x[2i], applied
    independently inside each axis chunk (and identity on the remainder)."""
    head_dim = x.shape[-1]
    d_dim, h_dim, w_dim, rem = rope_axis_dims(head_dim)
    outs = []
    start = 0
    for dim in (d_dim, h_dim, w_dim):
        seg = x[..., start:start + dim]
        y = seg.reshape(seg.shape[:-1] + (dim // 2, 2))
        y = jnp.stack([-y[..., 1], y[..., 0]], axis=-1)
        outs.append(y.reshape(seg.shape))
        start += dim
    if rem:
        outs.append(jnp.zeros_like(x[..., start:]))
    return jnp.concatenate(outs, axis=-1)


def apply_rope3d(x: jax.Array, cos: jax.Array, sin: jax.Array) -> jax.Array:
    """Apply the 3D rotary embedding.

    x: (B, N, H, D); cos/sin: (N, D) or (B, N, D) — broadcast over heads."""
    if cos.ndim == 2:
        cos = cos[None, :, None, :]
        sin = sin[None, :, None, :]
    else:
        cos = cos[:, :, None, :]
        sin = sin[:, :, None, :]
    return (x * cos + _rotate_pairs(x) * sin).astype(x.dtype)
