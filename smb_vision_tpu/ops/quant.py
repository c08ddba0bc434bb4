"""W8A8 dynamic-quantization linear for inference.

Per-channel weight scales and per-row (per-token) activation scales,
symmetric int8, an int8 x int8 -> int32 dot, then one rescale. Per-row
scales are strictly tighter than per-tensor ones (each token gets its own
dynamic range). Replaces nothing in the reference (it has no quantized
inference). Whether it pays on the GPU has not been measured.

Accuracy: on LayerNormed ViT activations the end-to-end embed drift is of
the same order as bf16 round-off
(tests/test_models.py::test_videomae_quant8_embed_close_to_f32).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def w8a8_dot(x: jax.Array, kernel: jax.Array) -> jax.Array:
    """x @ kernel as an int8 matmul.

    x: (..., K) any float dtype; kernel: (K, M) float32.
    Returns (..., M) in x.dtype. Weights are quantized per out-channel,
    activations per row (per token) with dynamic abs-max scales.
    Symmetric, zero-point-free.
    """
    lead = x.shape[:-1]
    kdim = x.shape[-1]
    x2 = x.reshape(-1, kdim).astype(jnp.float32)

    sx = jnp.max(jnp.abs(x2), axis=1, keepdims=True) / 127.0   # (rows, 1)
    sx = jnp.where(sx == 0, 1.0, sx)
    x8 = jnp.clip(jnp.round(x2 / sx), -127, 127).astype(jnp.int8)

    kf = kernel.astype(jnp.float32)
    sw = jnp.max(jnp.abs(kf), axis=0, keepdims=True) / 127.0   # (1, M)
    sw = jnp.where(sw == 0, 1.0, sw)
    w8 = jnp.clip(jnp.round(kf / sw), -127, 127).astype(jnp.int8)

    y = jax.lax.dot_general(x8, w8, (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.int32)
    y = y.astype(jnp.float32) * (sx * sw)
    return y.reshape(*lead, kernel.shape[1]).astype(x.dtype)
