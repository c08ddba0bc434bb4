"""Context (sequence) parallelism for full attention.

The reference has no sequence sharding (SURVEY §2c: "no ring attention /
Ulysses") — it survives long sequences with token dropping + flash-attn.
Here sequence parallelism is first-class for the full-res 512^2x320 config:
the token dimension is sharded over the mesh's "model" axis, each device
holds q for its shard, and attention runs on the local q shard. Outputs
stay sequence-sharded.

Two variants:
- `context_parallel_attention`: kv all-gathered over the device links
  (N*D at ViT scale is tens of MB — cheap relative to N^2 compute), one
  `attention` call (cuDNN on the GPU).
- `ring_attention`: kv blocks rotate via ppermute, `attention_with_lse`
  runs per block and partials merge by logsumexp — O(N/devices) kv
  memory for configs where the gathered kv no longer fits.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from smb_vision_tpu.ops.attention import attention, attention_with_lse


def shard_map(f, **kw):
    """jax.shard_map with varying-manual-axes checking off, so the body may
    call custom calls (cuDNN attention) that carry no vma annotation."""
    return jax.shard_map(f, check_vma=False, **kw)


def context_parallel_attention(q, k, v, *, mesh: Mesh, axis: str = "model",
                               scale: Optional[float] = None,
                               batch_axis: Optional[str] = None):
    """q, k, v: (B, N, H, D) with N sharded over `axis`. Returns (B, N, H, D)
    sequence-sharded the same way. Each per-device body runs `attention`
    on its local q shard against the gathered kv.

    batch_axis: mesh axis the batch dim is sharded over (usually "data"
    inside the models); None keeps the batch replicated per shard group."""

    def local(q_shard, k_shard, v_shard):
        k_full = jax.lax.all_gather(k_shard, axis, axis=1, tiled=True)
        v_full = jax.lax.all_gather(v_shard, axis, axis=1, tiled=True)
        return attention(q_shard, k_full, v_full, scale=scale)

    spec = P(batch_axis, axis, None, None)
    return shard_map(local, mesh=mesh, in_specs=(spec, spec, spec),
                     out_specs=spec)(q, k, v)


def ring_attention(q, k, v, *, mesh: Mesh, axis: str = "model",
                   scale: Optional[float] = None,
                   batch_axis: Optional[str] = None):
    """Ring attention with O(N/devices) kv memory: kv shards rotate
    around the ring via ppermute and every block runs `attention_with_lse`
    (XLA: one (N/dev)^2 score block per step), so no step holds a gathered
    kv.

    Per-block normalised partials (o_i, lse2_i) merge with the exact
    log-sum-exp combine (weights exp2(lse2_i - total), log2 units —
    matching `attention_with_lse`). The ring loop is unrolled over the
    static ring size: XLA overlaps each step's ppermute with the previous
    block's compute, and reverse-mode AD works through the unrolled merges
    because `attention_with_lse` is differentiable through both outputs.

    Use `context_parallel_attention` when the gathered kv fits (one
    all-gather beats n_dev-1 ppermute latencies); use the ring when it
    does not (full-res 20480-token configs at model>=2)."""
    n_dev = mesh.shape[axis]

    def local(q_shard, k_shard, v_shard):
        def block(ks, vs):
            out, lse2 = attention_with_lse(q_shard, ks, vs, scale=scale)
            return out.astype(jnp.float32), lse2

        def merge(a, b):
            """Combine two normalised partials over disjoint kv blocks:
            softmax weights are w_x = exp2(lse2_x - lse2_total)."""
            out_a, lse_a = a
            out_b, lse_b = b
            m = jnp.maximum(lse_a, lse_b)
            wa = jnp.exp2(lse_a - m)
            wb = jnp.exp2(lse_b - m)
            denom = wa + wb
            # weights are (B, H, Q) -> broadcast over (B, Q, H, D)
            bw = lambda w: jnp.swapaxes(  # noqa: E731
                (w / denom)[..., None], 1, 2)
            out = out_a * bw(wa) + out_b * bw(wb)
            return out, m + jnp.log2(denom)

        acc = block(k_shard, v_shard)
        ks, vs = k_shard, v_shard
        perm = [(j, (j + 1) % n_dev) for j in range(n_dev)]
        for _ in range(n_dev - 1):
            ks = jax.lax.ppermute(ks, axis, perm)
            vs = jax.lax.ppermute(vs, axis, perm)
            acc = merge(acc, block(ks, vs))
        return acc[0].astype(q_shard.dtype)

    spec = P(batch_axis, axis, None, None)
    return shard_map(local, mesh=mesh, in_specs=(spec, spec, spec),
                     out_specs=spec)(q, k, v)
