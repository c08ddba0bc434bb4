"""Multi-head attention: cuDNN's fused attention on the GPU, XLA elsewhere.

The reference ran flash-attn 2 on NVIDIA cards (attn_implementation=
"flash_attention_2", reference run_vjepa.py:231). The closest thing on
Hopper through JAX is cuDNN's fused (flash) attention, forward and
backward, reached through `jax.nn.dot_product_attention(...,
implementation="cudnn")`. `attention_backend` picks it from what the call
can observe (platform, dtype, head dim, bias); every other call runs
`xla_attention`, the plain reference that materialises f32 scores.

Layout everywhere: q (B, Nq, H, D), k and v (B, Nk, H, D).
"""

from __future__ import annotations

import math
from typing import Optional

import jax
import jax.numpy as jnp

LOG2E = 1.4426950408889634
# cuDNN's fused attention on Hopper: bf16/fp16, head dim a multiple of 8 and
# at most 256 (jax/_src/cudnn/fused_attention_stablehlo.py
# check_is_flash_attention)
_FUSED_DTYPES = (jnp.bfloat16, jnp.float16)
_FUSED_MAX_HEAD_DIM = 256
# the implementation `jax.nn.dot_product_attention` is asked for when the
# resolver says "cudnn"; CPU tests substitute "xla" to run the same wrapper
_FUSED_IMPLEMENTATION = "cudnn"


def _platform() -> str:
    return jax.default_backend()


def attention_backend(q, k, bias=None) -> str:
    """"cudnn" when the fused kernel takes this call, else "xla"."""
    d = q.shape[-1]
    fused = (_platform() == "gpu" and bias is None
             and q.dtype == k.dtype
             and any(q.dtype == t for t in _FUSED_DTYPES)
             and d % 8 == 0 and d <= _FUSED_MAX_HEAD_DIM)
    return "cudnn" if fused else "xla"


def xla_attention(q, k, v, *, scale: Optional[float] = None,
                  bias: Optional[jax.Array] = None) -> jax.Array:
    """Reference O(N^2) attention: f32 scores and softmax, P cast to
    v.dtype for the P @ V product."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = jnp.einsum("...qhd,...khd->...hqk", q, k,
                   preferred_element_type=jnp.float32) * scale
    if bias is not None:
        s = s + bias
    p = jax.nn.softmax(s, axis=-1).astype(v.dtype)
    return jnp.einsum("...hqk,...khd->...qhd", p, v)


def attention(q, k, v, *, scale: Optional[float] = None,
              bias: Optional[jax.Array] = None,
              impl: str = "auto") -> jax.Array:
    """Multi-head attention.

    Args:
      q: (B, Nq, H, D); k, v: (B, Nk, H, D)
      scale: softmax scale, default 1/sqrt(D)
      bias: optional additive (B|1, H|1, Nq, Nk) bias (runs on XLA)
      impl: "auto" (cuDNN where `attention_backend` allows, else XLA) or
        "xla" (always the reference)
    Returns:
      (B, Nq, H, D)

    A cuDNN error on a call the resolver sent there propagates: it is not
    caught and re-routed.
    """
    if impl not in ("auto", "xla"):
        raise ValueError(f"unknown attention impl {impl!r}; "
                         "valid: 'auto', 'xla'")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if impl == "auto" and attention_backend(q, k, bias) == "cudnn":
        return jax.nn.dot_product_attention(
            q, k, v, scale=scale, implementation=_FUSED_IMPLEMENTATION)
    return xla_attention(q, k, v, scale=scale, bias=bias)


def attention_with_lse(q, k, v, *, scale: Optional[float] = None):
    """Attention that also returns the row logsumexp, for partial-softmax
    merging (ring attention).

    Returns (out, lse2):
      out:  (B, Nq, H, D)
      lse2: (B, H, Nq) f32 logsumexp in LOG2 units of the pre-scaled
            scores — softmax weights satisfy p = exp2(s*scale*LOG2E - lse2).
            Two partials (o_a, lse2_a), (o_b, lse2_b) over disjoint kv
            blocks merge exactly with w_x = exp2(lse2_x - m) / sum.

    XLA on every platform, differentiable through both outputs. cuDNN's
    residual is cast to the output dtype and takes no cotangent, so it
    cannot stand in here.
    """
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s2 = jnp.einsum("bqhd,bkhd->bhqk", q, k,
                    preferred_element_type=jnp.float32) * (scale * LOG2E)
    m = jnp.max(s2, axis=-1, keepdims=True)
    p = jnp.exp2(s2 - m)
    l = jnp.sum(p, axis=-1, keepdims=True)
    out = jnp.einsum("bhqk,bkhd->bqhd", (p / l).astype(v.dtype), v)
    return out, (m + jnp.log2(l))[..., 0]
