"""Patch embedding and pixel-target patchification as reshapes + one matmul
(no conv kernels needed: stride == kernel size makes Conv3d an exact
reshape/transpose/matmul, and the single big matmul runs on the tensor
cores).

Weight layout is kept HF-Conv3d-compatible: (out, in, kt, kh, kw), so
converted checkpoints (VideoMAEPatchEmbeddings.projection,
reference modeling_videomae.py:172-177; VJEPA2PatchEmbeddings3D.proj_3d,
modeling_vjepa.py:119-124) drop in unchanged.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp


def extract_patches(pixel_values: jnp.ndarray, tubelet_size: int,
                    patch_size: int, channel_major: bool) -> jnp.ndarray:
    """(B, T, C, H, W) -> (B, N, patch_dim).

    Sequence order: t-major then h then w (matches Conv3d output flatten).
    channel_major=True -> patch vector ordered (c, dt, dh, dw): the Conv3d
    weight contraction order (for patch *embedding*).
    channel_major=False -> (dt, dh, dw, c): the reference's pixel-label
    order (modeling_videomae.py:850 permute(0,1,4,6,2,5,7,3)).
    """
    b, t, c, h, w = pixel_values.shape
    ts, ps = tubelet_size, patch_size
    x = pixel_values.reshape(b, t // ts, ts, c, h // ps, ps, w // ps, ps)
    if channel_major:
        # -> (B, T', H', W', C, ts, ph, pw)
        x = x.transpose(0, 1, 4, 6, 3, 2, 5, 7)
    else:
        # -> (B, T', H', W', ts, ph, pw, C)
        x = x.transpose(0, 1, 4, 6, 2, 5, 7, 3)
    n = (t // ts) * (h // ps) * (w // ps)
    return x.reshape(b, n, ts * ps * ps * c)


def patch_embed(pixel_values: jnp.ndarray, kernel: jnp.ndarray,
                bias: jnp.ndarray | None, *, dtype=jnp.bfloat16
                ) -> jnp.ndarray:
    """Tubelet projection: (B, T, C, H, W) x (hidden, C, ts, ps, ps)
    -> (B, N, hidden)."""
    hidden, c, ts, ps, _ = kernel.shape
    patches = extract_patches(pixel_values, ts, ps, channel_major=True)
    wmat = kernel.reshape(hidden, c * ts * ps * ps).T
    out = jnp.dot(patches.astype(dtype), wmat.astype(dtype),
                  preferred_element_type=jnp.float32)
    if bias is not None:
        out = out + bias.astype(jnp.float32)
    return out.astype(dtype)


def patch_embed_2d(pixel_values: jnp.ndarray, kernel: jnp.ndarray,
                   bias: jnp.ndarray | None, *, dtype=jnp.bfloat16
                   ) -> jnp.ndarray:
    """2D patch projection for the SigLIP tower: (B, C, H, W) x
    (hidden, C, ps, ps) -> (B, N, hidden). Weight layout stays
    HF-Conv2d-compatible ((out, in, kh, kw),
    transformers SiglipVisionEmbeddings.patch_embedding) so converted
    checkpoints drop in unchanged. Sequence order row-major (h, then w),
    patch vector channel-major (c, dh, dw) — the Conv2d contraction order.

    Non-divisible image sizes (e.g. so400m-patch14-384: 384 % 14 == 6) crop
    the trailing rows/cols first — exactly HF Conv2d's valid padding, whose
    stride-ps windows never touch pixels past floor(H/ps)*ps.

    Implemented as `patch_embed` with a unit time axis: ts=1 collapses the
    (c, dt, dh, dw) patch-vector order to (c, dh, dw) and t-major sequence
    order to row-major, so the two are bit-identical."""
    hidden, c, ps, _ = kernel.shape
    b, c_in, h, w = pixel_values.shape
    if c_in != c:
        raise ValueError(f"input has {c_in} channels, kernel expects {c}")
    gh, gw = h // ps, w // ps
    if (gh * ps, gw * ps) != (h, w):
        pixel_values = pixel_values[:, :, :gh * ps, :gw * ps]
    return patch_embed(pixel_values[:, None], kernel[:, :, None], bias,
                       dtype=dtype)


def normalize_pixel_targets(patches: jnp.ndarray,
                            eps: float = 1e-6) -> jnp.ndarray:
    """Per-patch normalisation for norm_pix_loss
    (modeling_videomae.py:858-861): subtract the per-patch mean and divide by
    the *unbiased* (n-1) std + eps, computed over patch pixels per channel
    group — the reference normalises over the (ts*ps*ps) axis with channels
    separate, then flattens. For num_channels==1 (CT) normalising over the
    full patch vector is identical."""
    # stats in f32 regardless of the shipped pixel dtype (bf16/f16 input
    # shipping must not perturb the regression target)
    patches = patches.astype(jnp.float32)
    mean = jnp.mean(patches, axis=-1, keepdims=True)
    n = patches.shape[-1]
    var = jnp.sum((patches - mean) ** 2, axis=-1, keepdims=True) / (n - 1)
    return (patches - mean) / (jnp.sqrt(var) + eps)


def sincos_position_table(n_position: int, d_hid: int) -> jnp.ndarray:
    """Fixed sinusoid table, matching get_sinusoid_encoding_table
    (modeling_videomae.py:95-106): angle(pos, j) = pos/10000^(2*(j//2)/d),
    sin on even dims, cos on odd. Returns (1, n_position, d_hid) float32.

    Computed in float64 numpy then embedded as an f32 constant: on-device
    f32 computation loses ~2e-3 rad of argument precision at 20k positions
    (f32 sin range reduction), which breaks exact HF parity."""
    import numpy as np

    j = np.arange(d_hid)
    inv = np.power(10000.0, 2 * (j // 2) / d_hid)
    table = np.arange(n_position)[:, None] / inv[None, :]
    table[:, 0::2] = np.sin(table[:, 0::2])
    table[:, 1::2] = np.cos(table[:, 1::2])
    return jnp.asarray(table[None], dtype=jnp.float32)
