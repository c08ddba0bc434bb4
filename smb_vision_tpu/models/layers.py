"""Shared transformer building blocks.

One block implementation serves VideoMAE encoder/decoder, VJEPA2
encoder/predictor, and DINOv2 — they differ only in bias pattern, RoPE,
layerscale/droppath, and FFN flavour, all expressed as module options.

Conventions:
- params are float32; compute dtype configurable (bf16 on the GPU)
- LayerNorm statistics in float32
- attention goes through smb_vision_tpu.ops.attention, which picks cuDNN's
  fused attention on the GPU and plain XLA elsewhere
- `gelu` is the exact (erf) variant to match torch nn.GELU
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

from smb_vision_tpu import nn
from smb_vision_tpu.ops.attention import attention
from smb_vision_tpu.ops.mlp import ACT2FN
from smb_vision_tpu.ops.quant import w8a8_dot
from smb_vision_tpu.ops.rope3d import apply_rope3d


def trunc_normal_init(std: float):
    return nn.initializers.truncated_normal(stddev=std, lower=-2.0, upper=2.0)


class QuantDense(nn.Module):
    """Drop-in for nn.Dense that runs x@kernel as an int8 matmul (W8A8
    dynamic quantization, ops/quant.py). Identical param structure —
    checkpoints interchange freely with nn.Dense. Inference only: the
    quantization round is not differentiable."""

    features: int
    use_bias: bool = True
    dtype: jnp.dtype = jnp.bfloat16
    param_dtype: jnp.dtype = jnp.float32
    kernel_init: Callable = nn.initializers.lecun_normal()

    @nn.compact
    def __call__(self, x):
        kernel = self.param("kernel", self.kernel_init,
                            (x.shape[-1], self.features), self.param_dtype)
        y = w8a8_dot(x.astype(self.dtype), kernel)
        if self.use_bias:
            bias = self.param("bias", nn.initializers.zeros,
                              (self.features,), self.param_dtype)
            y = y + bias.astype(y.dtype)
        return y


class Attention(nn.Module):
    """Multi-head self-attention.

    bias_mode:
      "qkv"  — bias on q, k, v (VJEPA2, reference modeling_vjepa.py:251-253)
      "qv"   — bias on q and v only, k bias fixed at zero (the VideoMAE /
               DINOv2 q/v-bias trick, modeling_videomae.py:246-251)
      "none" — no qkv bias
    """

    hidden_size: int
    num_heads: int
    bias_mode: str = "qkv"
    out_bias: bool = True
    out_proj: bool = True   # pooler cross-attn has no o_proj (vjepa :820-823)
    dtype: jnp.dtype = jnp.bfloat16
    attn_impl: str = "auto"
    initializer_range: float = 0.02
    # sequence parallelism: tokens sharded over the mesh "model" axis; the
    # local shard runs attention (all-gather-kv CP or ring)
    sequence_parallel: bool = False
    sp_variant: str = "gather"   # "gather" (all-gather kv) | "ring"
    quant8: bool = False         # W8A8 projections (inference only)
    # one (h, 3h) QKV matmul instead of three (h, h) ones. XLA's
    # dot-merger already coalesces same-input narrow dots inside the
    # block, and the manual concat+slice adds copies; default OFF.
    fused_qkv: bool = False

    @nn.compact
    def __call__(self, x, rope: Optional[Tuple[jax.Array, jax.Array]] = None,
                 kv: Optional[jax.Array] = None):
        b, n, _ = x.shape
        h = self.hidden_size
        head_dim = h // self.num_heads
        kinit = trunc_normal_init(self.initializer_range)
        dense_cls = QuantDense if self.quant8 else nn.Dense
        dense = lambda name, use_bias: dense_cls(  # noqa: E731
            self.hidden_size, use_bias=use_bias, dtype=self.dtype,
            param_dtype=jnp.float32, kernel_init=kinit, name=name)

        qb = self.bias_mode in ("qkv", "qv")
        kb = self.bias_mode == "qkv"
        vb = self.bias_mode in ("qkv", "qv")
        src = x if kv is None else kv
        if self.fused_qkv and not self.quant8:
            dt = self.dtype
            wq, bq = _DenseParams(h, kinit, qb, name="query")(x.shape[-1])
            wk, bk = _DenseParams(h, kinit, kb, name="key")(src.shape[-1])
            wv, bv = _DenseParams(h, kinit, vb, name="value")(
                src.shape[-1])
            zeros = jnp.zeros((h,), jnp.float32)

            def fused(inp, ws, bs, flags):
                y = inp.astype(dt) @ jnp.concatenate(ws, 1).astype(dt)
                if any(flags):
                    y = y + jnp.concatenate(
                        [bb if f else zeros for bb, f in zip(bs, flags)]
                    ).astype(dt)
                return y

            if kv is None:
                qkv = fused(x, (wq, wk, wv), (bq, bk, bv), (qb, kb, vb))
                q, k, v = (qkv[..., :h], qkv[..., h:2 * h],
                           qkv[..., 2 * h:])
            else:
                q = fused(x, (wq,), (bq,), (qb,))
                kv_p = fused(kv, (wk, wv), (bk, bv), (kb, vb))
                k, v = kv_p[..., :h], kv_p[..., h:]
            q = q.reshape(b, n, self.num_heads, head_dim)
            k = k.reshape(b, src.shape[1], self.num_heads, head_dim)
            v = v.reshape(b, src.shape[1], self.num_heads, head_dim)
        else:
            q = dense("query", qb)(x).reshape(b, n, self.num_heads,
                                              head_dim)
            k = dense("key", kb)(src).reshape(b, src.shape[1],
                                              self.num_heads, head_dim)
            v = dense("value", vb)(src).reshape(b, src.shape[1],
                                                self.num_heads, head_dim)

        if rope is not None:
            cos, sin = rope
            q = apply_rope3d(q, cos, sin)
            k = apply_rope3d(k, cos, sin)

        out = self._attend(q, k, v, cross=kv is not None)
        out = out.reshape(b, n, self.hidden_size)
        if not self.out_proj:
            return out
        return dense("proj", self.out_bias)(out)

    def _attend(self, q, k, v, cross: bool = False):
        if self.sequence_parallel and not cross:
            from smb_vision_tpu.parallel.context import (
                context_parallel_attention,
                ring_attention,
            )
            from smb_vision_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS

            mesh = jax.sharding.get_abstract_mesh()
            if mesh.empty:
                raise ValueError(
                    "sequence_parallel=True needs an ambient mesh: wrap the "
                    "apply/jit in `with jax.set_mesh(mesh):`")
            if self.sp_variant == "ring":
                return ring_attention(q, k, v, mesh=mesh, axis=MODEL_AXIS,
                                      batch_axis=DATA_AXIS)
            return context_parallel_attention(
                q, k, v, mesh=mesh, axis=MODEL_AXIS, batch_axis=DATA_AXIS)
        return attention(q, k, v, impl=self.attn_impl)


class _DenseParams(nn.Module):
    """Parameter holder with nn.Dense's exact param structure
    (kernel/bias under the module name) for the fused-QKV path, which
    concatenates raw weights — checkpoints interchange with nn.Dense."""

    features: int
    kernel_init: Callable
    use_bias: bool = True

    @nn.compact
    def __call__(self, in_features: int):
        kernel = self.param("kernel", self.kernel_init,
                            (in_features, self.features), jnp.float32)
        bias = self.param("bias", nn.initializers.zeros,
                          (self.features,), jnp.float32) \
            if self.use_bias else None
        return kernel, bias


class Mlp(nn.Module):
    """fc1 -> act -> fc2. On the GPU the matmuls run through cuBLAS and
    XLA fuses the bias and activation into their epilogues."""

    hidden_size: int
    intermediate_size: int
    act: str = "gelu"
    dtype: jnp.dtype = jnp.bfloat16
    initializer_range: float = 0.02
    quant8: bool = False

    @nn.compact
    def __call__(self, x):
        kinit = trunc_normal_init(self.initializer_range)
        dense_cls = QuantDense if self.quant8 else nn.Dense
        x = dense_cls(self.intermediate_size, dtype=self.dtype,
                      param_dtype=jnp.float32, kernel_init=kinit,
                      name="fc1")(x)
        x = ACT2FN[self.act](x)
        x = dense_cls(self.hidden_size, dtype=self.dtype,
                      param_dtype=jnp.float32, kernel_init=kinit,
                      name="fc2")(x)
        return x


class SwiGLU(nn.Module):
    """SwiGLU FFN (DINOv2 use_swiglu_ffn path)."""

    hidden_size: int
    intermediate_size: int
    dtype: jnp.dtype = jnp.bfloat16
    initializer_range: float = 0.02

    @nn.compact
    def __call__(self, x):
        kinit = trunc_normal_init(self.initializer_range)
        h = nn.Dense(2 * self.intermediate_size, dtype=self.dtype,
                     param_dtype=jnp.float32, kernel_init=kinit,
                     name="weights_in")(x)
        x1, x2 = jnp.split(h, 2, axis=-1)
        return nn.Dense(self.hidden_size, dtype=self.dtype,
                        param_dtype=jnp.float32, kernel_init=kinit,
                        name="weights_out")(jax.nn.silu(x1) * x2)


class DropPath(nn.Module):
    """Stochastic depth per sample (modeling_vjepa.py:375-392).

    `rate` is the static per-layer rate; `rate_override` (a traced f32
    scalar) replaces it at call time so one shared Block can apply a
    per-layer schedule from a scanned operand (the pipelined layout,
    models/pipelined.py — per-layer rates ride a stacked leaf there)."""

    rate: float

    @nn.compact
    def __call__(self, x, deterministic: bool = True, rate_override=None):
        if deterministic or (rate_override is None and self.rate == 0.0):
            return x
        r = self.rate if rate_override is None else rate_override
        keep = 1.0 - jnp.asarray(r, x.dtype)
        rng = self.make_rng("droppath")
        shape = (x.shape[0],) + (1,) * (x.ndim - 1)
        mask = jnp.floor(keep + jax.random.uniform(rng, shape, x.dtype))
        return x / keep * mask


class Block(nn.Module):
    """Pre-LN transformer block:
    x += [droppath][layerscale] attn(LN(x)); x += [..] mlp(LN(x))."""

    hidden_size: int
    num_heads: int
    intermediate_size: int
    act: str = "gelu"
    bias_mode: str = "qkv"
    layer_norm_eps: float = 1e-6
    layerscale_value: Optional[float] = None
    drop_path_rate: float = 0.0
    use_swiglu: bool = False
    dtype: jnp.dtype = jnp.bfloat16
    attn_impl: str = "auto"
    initializer_range: float = 0.02
    sequence_parallel: bool = False
    sp_variant: str = "gather"
    quant8: bool = False
    fused_qkv: bool = False

    @nn.compact
    def __call__(self, x, rope=None, deterministic: bool = True,
                 dp_rate=None):
        # dp_rate: optional TRACED f32 scalar overriding the static
        # drop_path_rate — the pipelined layout ships the per-layer
        # stochastic-depth schedule as a stacked leaf (pipelined_encoder)
        ln = lambda name: nn.LayerNorm(  # noqa: E731
            epsilon=self.layer_norm_eps, dtype=self.dtype,
            param_dtype=jnp.float32, name=name)

        def scaled(name, h):
            if self.layerscale_value is None:
                return h
            lam = self.param(name, nn.initializers.constant(
                self.layerscale_value), (self.hidden_size,), jnp.float32)
            return h * lam.astype(h.dtype)

        base = DropPath(self.drop_path_rate)
        dp = lambda h, det: base(h, det, rate_override=dp_rate)  # noqa: E731
        h = Attention(self.hidden_size, self.num_heads,
                      bias_mode=self.bias_mode, dtype=self.dtype,
                      attn_impl=self.attn_impl,
                      initializer_range=self.initializer_range,
                      sequence_parallel=self.sequence_parallel,
                      sp_variant=self.sp_variant, quant8=self.quant8,
                      fused_qkv=self.fused_qkv,
                      name="attention")(ln("norm1")(x), rope=rope)
        x = x + dp(scaled("layerscale1", h), deterministic)

        if self.use_swiglu:
            h = SwiGLU(self.hidden_size, self.intermediate_size,
                       dtype=self.dtype,
                       initializer_range=self.initializer_range,
                       name="mlp")(ln("norm2")(x))
        else:
            h = Mlp(self.hidden_size, self.intermediate_size, act=self.act,
                    dtype=self.dtype,
                    initializer_range=self.initializer_range,
                    quant8=self.quant8, name="mlp")(ln("norm2")(x))
        x = x + dp(scaled("layerscale2", h), deterministic)
        return x


class Encoder(nn.Module):
    """Stack of Blocks with optional remat (gradient checkpointing — the
    reference enables this via --gradient_checkpointing, run_mim.sh:34) and
    optional sequence parallelism: tokens sharded over the mesh "model"
    axis. The norms/MLP partition via GSPMD sharding constraints while the
    attention runs per shard through shard_map
    (context_parallel_attention / ring_attention)."""

    num_layers: int
    hidden_size: int
    num_heads: int
    intermediate_size: int
    act: str = "gelu"
    bias_mode: str = "qkv"
    layer_norm_eps: float = 1e-6
    layerscale_value: Optional[float] = None
    drop_path_rate: float = 0.0
    use_swiglu: bool = False
    dtype: jnp.dtype = jnp.bfloat16
    attn_impl: str = "auto"
    remat: bool = False
    initializer_range: float = 0.02
    sequence_parallel: bool = False
    sp_variant: str = "gather"
    quant8: bool = False
    fused_qkv: bool = False

    @nn.compact
    def __call__(self, x, rope=None, deterministic: bool = True):
        constrain = lambda y: y  # noqa: E731
        if self.sequence_parallel:
            from jax.sharding import PartitionSpec as P

            constrain = lambda y: jax.lax.with_sharding_constraint(  # noqa: E731
                y, P("data", "model", None))
            x = constrain(x)
        block_cls = Block
        if self.remat:
            block_cls = nn.remat(Block, static_argnums=(3,),
                                 prevent_cse=False)
        for i in range(self.num_layers):
            rate = (self.drop_path_rate * i / max(self.num_layers - 1, 1))
            x = block_cls(
                self.hidden_size, self.num_heads, self.intermediate_size,
                act=self.act, bias_mode=self.bias_mode,
                layer_norm_eps=self.layer_norm_eps,
                layerscale_value=self.layerscale_value,
                drop_path_rate=rate, use_swiglu=self.use_swiglu,
                dtype=self.dtype, attn_impl=self.attn_impl,
                initializer_range=self.initializer_range,
                sequence_parallel=self.sequence_parallel,
                sp_variant=self.sp_variant, quant8=self.quant8,
                fused_qkv=self.fused_qkv,
                name=f"layer_{i}")(x, rope, deterministic)
            if self.sequence_parallel:
                x = constrain(x)
        return x
