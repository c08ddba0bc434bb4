"""Inflated-3D (I3D) ResNet tower.

The Merlin CT foundation model's image encoder is an I3D-inflated
ResNet-152 behind the external `merlin` package; the reference embeds CT
volumes through it on GPU (src/encoders/run_merlin.py:24-48,
`Merlin(ImageEmbedding=True)` -> (batch, tokens, dim) embeddings). This
module is a first-party implementation of that tower family so the
Merlin zoo path runs on the JAX compute path like every other encoder
(inference/encoders.py::MerlinEncoder backend="jax") instead of host
torch.

Design:
- channels-last layout internally — input arrives torch-style
  (B, C, a0, a1, a2) to match the CT pipeline's "CHWD" output and is
  transposed ONCE at the boundary; all convs run NDHWC.
- torch-conv geometry: symmetric k//2 padding per axis (torch Conv3d
  default-style `padding=k//2`), stride on the bottleneck's 3x3 (ResNet
  v1.5 / torchvision placement — hassony2-style I3D inflation reads the
  spatial stride off conv2), so torch checkpoints convert
  weight-for-weight (models/convert.py::convert_torch_resnet3d) and the
  forward is golden-tested against a torch re-derivation
  (tests/test_resnet3d.py).
- frozen BatchNorm: running statistics are checkpoint parameters, applied
  as an affine (x - mean) * scale / sqrt(var + eps) + bias in f32 (the
  LayerNorm-stats-in-f32 invariant, CLAUDE.md); the zoo use is eval-only
  embedding, and head fine-tuning on frozen BN is the standard ResNet
  recipe. There is no train-mode batch-stats path.
- params f32, compute bf16 (conv operands cast, BN/pool stats f32).

Per-element axis-0 ("temporal") kernel sizes are read from checkpoint
weight shapes at conversion (resnet3d_config_from_state_dict); axis-0
strides are config fields with the standard I3D defaults
(ResNet3DConfig docstring).
"""

from __future__ import annotations

from typing import Optional, Tuple

from smb_vision_tpu import nn
import jax
import jax.numpy as jnp

from smb_vision_tpu.models.configs import ResNet3DConfig


def _pad3(k: Tuple[int, int, int]):
    """torch-style symmetric padding k//2 per axis, as explicit
    (lo, hi) pairs (XLA 'SAME' pads asymmetrically under even
    stride/size combinations — it would NOT match torch)."""
    return [(d // 2, d // 2) for d in k]


class FrozenBatchNorm(nn.Module):
    """Inference-form BatchNorm3d: checkpoint running stats applied as an
    affine. Stats and arithmetic in f32, output cast back to the compute
    dtype."""

    features: int
    eps: float = 1e-5
    dtype: jnp.dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        f = self.features
        scale = self.param("scale", nn.initializers.ones, (f,), jnp.float32)
        bias = self.param("bias", nn.initializers.zeros, (f,), jnp.float32)
        mean = self.param("mean", nn.initializers.zeros, (f,), jnp.float32)
        var = self.param("var", nn.initializers.ones, (f,), jnp.float32)
        # FROZEN means frozen: head fine-tuning must not receive gradients
        # into the affine or the running statistics (torchvision
        # FrozenBatchNorm semantics — a naive param registration would let
        # AdamW drift the checkpoint's statistics)
        scale, bias, mean, var = jax.lax.stop_gradient(
            (scale, bias, mean, var))
        # fold into one multiply-add (XLA fuses this into the producing
        # conv's epilogue)
        inv = scale / jnp.sqrt(var + self.eps)
        out = x.astype(jnp.float32) * inv + (bias - mean * inv)
        return out.astype(self.dtype)


class ConvBN(nn.Module):
    """conv3d (no bias, torch-padding) -> frozen BN."""

    features: int
    kernel: Tuple[int, int, int]
    stride: Tuple[int, int, int] = (1, 1, 1)
    eps: float = 1e-5
    dtype: jnp.dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        x = nn.Conv(self.features, self.kernel, strides=self.stride,
                    padding=_pad3(self.kernel), use_bias=False,
                    dtype=self.dtype, param_dtype=jnp.float32,
                    name="conv")(x)
        return FrozenBatchNorm(self.features, eps=self.eps,
                               dtype=self.dtype, name="bn")(x)


class Bottleneck3D(nn.Module):
    """torchvision-v1.5 bottleneck, I3D-inflated: 1x1x1 reduce ->
    (k_t,3,3) stride-carrying conv -> 1x1x1 expand, identity or
    downsample-projected residual, post-add ReLU."""

    width: int
    stride: Tuple[int, int, int]
    conv2_kernel_t: int
    expansion: int = 4
    eps: float = 1e-5
    dtype: jnp.dtype = jnp.bfloat16
    project: bool = False

    @nn.compact
    def __call__(self, x: jnp.ndarray) -> jnp.ndarray:
        out_f = self.width * self.expansion
        h = ConvBN(self.width, (1, 1, 1), eps=self.eps, dtype=self.dtype,
                   name="cb1")(x)
        h = nn.relu(h)
        h = ConvBN(self.width, (self.conv2_kernel_t, 3, 3),
                   stride=self.stride, eps=self.eps, dtype=self.dtype,
                   name="cb2")(h)
        h = nn.relu(h)
        h = ConvBN(out_f, (1, 1, 1), eps=self.eps, dtype=self.dtype,
                   name="cb3")(h)
        if self.project:
            x = ConvBN(out_f, (1, 1, 1), stride=self.stride, eps=self.eps,
                       dtype=self.dtype, name="downsample")(x)
        return nn.relu(h + x)


class ResNet3D(nn.Module):
    """The tower. Input (B, C, a0, a1, a2) (torch/CT-pipeline layout).

    Returns (tokens, pooled[, logits]):
    - tokens: (B, L, hidden) — the final stage's feature map flattened in
      (a0, a1, a2) row-major order; the Merlin ImageEmbedding surface
      (reference run_merlin.py:45-48 unpacks (bs, l, dim)).
    - pooled: (B, hidden) global average pool, f32.
    - logits only when config.num_labels > 0.
    """

    config: ResNet3DConfig

    @nn.compact
    def __call__(self, pixel_values: jnp.ndarray
                 ) -> Tuple[jnp.ndarray, ...]:
        cfg = self.config
        dtype = jnp.dtype(cfg.dtype)
        if pixel_values.ndim != 5:
            raise ValueError(
                f"expected (B, C, a0, a1, a2) pixels, got "
                f"{pixel_values.shape}")
        x = jnp.transpose(pixel_values, (0, 2, 3, 4, 1)).astype(dtype)

        ts = cfg.stem_stride_t
        x = ConvBN(cfg.base_width, (cfg.stem_kernel_t, 7, 7),
                   stride=(ts, 2, 2), eps=cfg.bn_eps, dtype=dtype,
                   name="stem")(x)
        x = nn.relu(x)
        pk, ps = cfg.pool_kernel_t, cfg.pool_stride_t
        x = nn.max_pool(x, (pk, 3, 3), strides=(ps, 2, 2),
                        padding=_pad3((pk, 3, 3)))

        for i, n_blocks in enumerate(cfg.stage_sizes):
            width = cfg.base_width * (2 ** i)
            sp = 1 if i == 0 else 2
            st = sp if cfg.temporal_downsample else 1
            for j in range(n_blocks):
                stride = (st, sp, sp) if j == 0 else (1, 1, 1)
                x = Bottleneck3D(width=width, stride=stride,
                                 conv2_kernel_t=cfg.conv2_kernel_t,
                                 expansion=cfg.expansion, eps=cfg.bn_eps,
                                 dtype=dtype, project=(j == 0),
                                 name=f"layer{i + 1}_{j}")(x)

        b = x.shape[0]
        hidden = cfg.hidden_size
        tokens = x.reshape(b, -1, hidden)
        pooled = jnp.mean(tokens.astype(jnp.float32), axis=1)
        if cfg.num_labels > 0:
            logits = nn.Dense(cfg.num_labels, dtype=jnp.float32,
                              param_dtype=jnp.float32,
                              name="head")(pooled)
            return tokens, pooled, logits
        return tokens, pooled
