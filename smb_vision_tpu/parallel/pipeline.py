"""Pipeline parallelism (GPipe schedule) over a mesh "pipe" axis.

The reference scales depth-wise only through ZeRO sharding (DeepSpeed
stage-3, reference ds_configs/ds_z3_config.json) — every GPU still
executes every layer. Across devices the natural depth-wise scaling is
a collective-permute pipeline (the scaling book's pipelining recipe): the
layer stack is split into S contiguous stages, one per device along a
"pipe" mesh axis, and microbatches stream through the ring — each tick
every stage applies its layers to its current microbatch while the
device links carry activations to the next stage. XLA overlaps the ppermute with
the next tick's compute, so the steady-state cost is pure compute plus
an (S-1)/(M+S-1) bubble for M microbatches.

Implementation notes (all static-shape, scan-friendly):
- The whole schedule is ONE `lax.scan` over T = M + S - 1 ticks inside
  `shard_map`; stage identity comes from `lax.axis_index`, so the traced
  program is identical on every device (SPMD).
- Bubble ticks compute on don't-care data (a clamped copy of the last
  microbatch / zeros) and their results are dropped by writing to a
  scratch row of the output buffer — no data-dependent control flow.
- Reverse-mode AD works through the scan and ppermute (its transpose is
  the reverse permute), so `jax.grad` of a loss on the pipeline output
  trains all stages without bespoke backward plumbing; microbatching
  doubles as in-step gradient accumulation.
- `remat=True` checkpoints each stage application, bounding live
  activations to O(one microbatch per stage) like GPipe's re-forward.

Params are the "stacked" layout: every leaf carries a leading layer
axis L, sharded over the pipe axis (L/S layers resident per device).
`stack_layer_params` / `unstack_layer_params` convert the Encoder's
per-layer dicts ({"layer_0": ..., "layer_1": ...}) to and from it.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from smb_vision_tpu.parallel.context import shard_map


def stack_layer_params(layer_params: dict, prefix: str = "layer_"):
    """{"layer_0": tree, ..., "layer_{L-1}": tree} -> (stacked tree with a
    leading L axis on every leaf, L). All layers must share one treedef
    (true for Encoder: identical Block config per layer)."""
    names = sorted((k for k in layer_params if k.startswith(prefix)),
                   key=lambda k: int(k[len(prefix):]))
    if not names:
        raise ValueError(f"no '{prefix}*' entries in {list(layer_params)}")
    trees = [layer_params[n] for n in names]
    stacked = jax.tree_util.tree_map(
        lambda *leaves: jnp.stack(leaves, axis=0), *trees)
    return stacked, len(names)


def unstack_layer_params(stacked: Any, num_layers: int,
                         prefix: str = "layer_") -> dict:
    """Inverse of stack_layer_params."""
    return {
        f"{prefix}{i}": jax.tree_util.tree_map(lambda a, i=i: a[i], stacked)
        for i in range(num_layers)
    }


def pipeline_apply(layer_fn: Callable[..., jax.Array],
                   stacked_params: Any, x: jax.Array, *, mesh: Mesh,
                   axis: str = "pipe", num_microbatches: int,
                   batch_axis: Optional[str] = None,
                   remat: bool = False, extra: Any = None,
                   with_mb_index: bool = False) -> jax.Array:
    """Run L = leading-axis-of(stacked_params) layers over x through an
    S-stage GPipe pipeline, S = mesh.shape[axis].

    layer_fn(params_i, x) -> x applies ONE layer and must preserve x's
    shape and dtype (cast x to the model's activation dtype first).
    x: (B, ...) with B % num_microbatches == 0; batch optionally sharded
    over `batch_axis` (pipe composes with data parallelism on a
    ("data", "pipe") mesh). Returns layer-L output, (B, ...), replicated
    over the pipe axis.

    extra: optional pytree of layer-invariant operands (e.g. the shared
    RoPE cos/sin tables) shipped replicated to every stage; when given,
    layer_fn is called as layer_fn(params_i, x, extra).

    with_mb_index: when True, layer_fn is always called as
    layer_fn(params_i, x, extra, mb) — extra may be None — where mb is
    the traced int32 index of the microbatch currently flowing through
    the stage (t - stage, garbage on bubble ticks whose outputs are
    discarded anyway). Lets stochastic layers (DropPath) fold a
    per-microbatch value into their RNG so samples in different
    microbatches draw independent randomness.
    """
    S = mesh.shape[axis]
    leaves = jax.tree_util.tree_leaves(stacked_params)
    L = leaves[0].shape[0]
    if any(leaf.shape[0] != L for leaf in leaves):
        raise ValueError("stacked_params leaves disagree on the layer axis")
    if L % S != 0:
        raise ValueError(f"{L} layers do not divide into {S} pipe stages")
    M = num_microbatches
    B = x.shape[0]
    if not (1 <= M <= B and B % M == 0):
        raise ValueError(f"batch {B} not divisible into {M} microbatches")
    if batch_axis is not None and (B // M) % mesh.shape[batch_axis]:
        raise ValueError(
            f"microbatch rows {B // M} do not shard over "
            f"{batch_axis}={mesh.shape[batch_axis]}; pick num_microbatches "
            f"so batch/num_microbatches divides the {batch_axis} axis")
    x_mb = x.reshape((M, B // M) + x.shape[1:])
    mb_sds = jax.ShapeDtypeStruct(x_mb.shape[1:], x.dtype)

    def stage(local_layers, act, ex, mb):
        def one(carry, p):
            if with_mb_index:
                return layer_fn(p, carry, ex, mb), None
            if extra is None:
                return layer_fn(p, carry), None
            return layer_fn(p, carry, ex), None
        out, _ = jax.lax.scan(one, act, local_layers)
        return out

    if not (with_mb_index and batch_axis is not None):
        # early layer_fn signature check. Skipped only when a
        # with_mb_index layer_fn may call lax.axis_index(batch_axis),
        # which is unbound outside the shard_map below — XLA still
        # shape-checks inside.
        extra_sds = jax.tree_util.tree_map(
            lambda leaf: jax.ShapeDtypeStruct(jnp.shape(leaf),
                                              jnp.result_type(leaf)), extra)
        out_sds = jax.eval_shape(
            stage, jax.tree_util.tree_map(
                lambda leaf: jax.ShapeDtypeStruct(
                    (L // S,) + leaf.shape[1:], leaf.dtype),
                stacked_params),
            mb_sds, extra_sds, jax.ShapeDtypeStruct((), jnp.int32))
        if out_sds.shape != mb_sds.shape or out_sds.dtype != mb_sds.dtype:
            raise ValueError(
                f"layer_fn must preserve shape/dtype: {mb_sds.shape}/"
                f"{mb_sds.dtype} -> {out_sds.shape}/{out_sds.dtype}")

    stage_fn = jax.checkpoint(stage) if remat else stage
    perm = [(i, (i + 1) % S) for i in range(S)]
    T = M + S - 1

    def per_device(local_layers, x_loc, ex):
        s = jax.lax.axis_index(axis)
        mb_shape = x_loc.shape[1:]
        # slot M is the bubble scratch row: writes of not-yet-valid
        # outputs land there and are discarded
        out_buf = jnp.zeros((M + 1,) + mb_shape, x_loc.dtype)
        act0 = jnp.zeros(mb_shape, x_loc.dtype)

        def tick(carry, t):
            act, out = carry
            inject = jax.lax.dynamic_index_in_dim(
                x_loc, jnp.minimum(t, M - 1), axis=0, keepdims=False)
            act = jnp.where(s == 0, inject, act)
            # the microbatch flowing through stage s at tick t (negative
            # or stale on bubble ticks — those outputs are discarded)
            mb = jnp.asarray(t - s, jnp.int32)
            y = stage_fn(local_layers, act, ex, mb)
            widx = jnp.where(t - (S - 1) >= 0, t - (S - 1), M)
            out = jax.lax.dynamic_update_index_in_dim(out, y, widx, 0)
            if S > 1:
                y = jax.lax.ppermute(y, axis, perm)
            return (y, out), None

        (_, out_buf), _ = jax.lax.scan(tick, (act0, out_buf),
                                       jnp.arange(T))
        # only the last stage's buffer holds real outputs; a masked psum
        # replicates them over the (small) pipe axis
        out = jnp.where(s == S - 1, out_buf[:M],
                        jnp.zeros_like(out_buf[:M]))
        return jax.lax.psum(out, axis)

    mb_spec = P(None, batch_axis)
    return shard_map(
        per_device, mesh=mesh, in_specs=(P(axis), mb_spec, P()),
        out_specs=mb_spec)(stacked_params, x_mb, extra).reshape(x.shape)
