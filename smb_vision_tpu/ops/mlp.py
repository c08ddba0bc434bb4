"""Plain transformer MLP functions: the references the model's MLP is
checked against, and the chain the GPU benchmark times.

`Mlp`/`Block` in models/layers.py compute exactly these with nn.Dense and
nn.LayerNorm; on the GPU the matmuls run through cuBLAS and XLA fuses the
bias and activation into their epilogues.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


# HF activation names; `gelu` is the exact (erf) variant torch nn.GELU uses
ACT2FN = {
    "gelu": lambda x: jax.nn.gelu(x, approximate=False),
    "gelu_new": lambda x: jax.nn.gelu(x, approximate=True),
    "relu": jax.nn.relu,
    "selu": jax.nn.selu,
    "silu": jax.nn.silu,
}


def mlp_xla(x, w1, b1, w2, b2, act: str = "gelu"):
    """fc1 -> act -> fc2 in x.dtype (weights cast to it), as nn.Dense does."""
    dt = x.dtype
    h = x @ w1.astype(dt)
    if b1 is not None:
        h = h + b1.astype(dt)
    h = ACT2FN[act](h)
    y = h @ w2.astype(dt)
    if b2 is not None:
        y = y + b2.astype(dt)
    return y


def mlp_block_xla(x, lnw, lnb, w1, b1, w2, b2, act: str = "gelu",
                  eps: float = 1e-6):
    """x + mlp(LayerNorm(x)): LN statistics, scale and bias in f32 (as
    nn.LayerNorm), matmuls in x.dtype."""
    xf = x.astype(jnp.float32)
    mu = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.maximum(jnp.mean(xf * xf, axis=-1, keepdims=True) - mu * mu,
                      0.0)
    xn = (xf - mu) * (jax.lax.rsqrt(var + eps) * lnw) + lnb
    return x + mlp_xla(xn.astype(x.dtype), w1, b1, w2, b2, act)
