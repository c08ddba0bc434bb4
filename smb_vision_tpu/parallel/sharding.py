"""Parameter sharding policies (GSPMD).

Replaces the reference's DeepSpeed ZeRO stages (ds_configs/ds_z{0,2,3}*.json)
with sharding specs — XLA emits the reduce-scatter / all-gather schedule:

- "dp"   (== ZeRO-0/DDP): params replicated, batch sharded on "data"
- "fsdp" (== ZeRO-3):     every large param sharded along its largest
                           divisible dim over "data"; gathered on use
- "tp"   rules:           attention qkv/proj and MLP in/out matrices split
                           over "model" (Megatron-style column/row split),
                           composable with dp/fsdp

Policies return a pytree of NamedSharding matching the param pytree; apply
with jit(in_shardings=...)/device_put. Opt-state shardings mirror params.
"""

from __future__ import annotations

import re
from typing import Any, Optional

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from smb_vision_tpu.parallel.mesh import DATA_AXIS, MODEL_AXIS

# Megatron-style TP rules keyed on flattened param path (regexes).
# column-split (output dim, last axis) / row-split (input dim, first axis)
_TP_COL = re.compile(
    r"(attention/(query|key|value)|mlp/fc1|mlp/weights_in|"
    r"predictor_embeddings)/kernel$")
_TP_ROW = re.compile(r"(attention/proj|mlp/fc2|mlp/weights_out)/kernel$")
_TP_COL_BIAS = re.compile(
    r"(attention/(query|key|value)|mlp/fc1|mlp/weights_in|"
    r"predictor_embeddings)/bias$")


def _path_str(path) -> str:
    return "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                    for p in path)


def _fsdp_spec(shape, tp_spec, n_data: int):
    """Shard the largest not-yet-sharded dim divisible by n_data."""
    dims = sorted(range(len(shape)), key=lambda i: -shape[i])
    spec = list(tp_spec) + [None] * (len(shape) - len(tp_spec))
    for i in dims:
        if spec[i] is None and shape[i] % n_data == 0 and shape[i] >= n_data:
            spec[i] = DATA_AXIS
            break
    return P(*spec)


def param_shardings(params: Any, mesh: Mesh, policy: str = "dp",
                    min_fsdp_size: int = 2 ** 16) -> Any:
    """Pytree of NamedSharding for `params`.

    policy: "dp" | "fsdp" | "tp" | "fsdp+tp" | "pipeline"

    "pipeline": stacked layer trees (path contains a `*_stacked`
    component, the layout of parallel/pipeline.stack_layer_params) shard
    their leading layer axis over the model/pipe mesh axis — each device
    holds only its stage's layers; non-stack glue replicates. Composable
    with fsdp ("pipeline+fsdp") for the glue/embed tables.
    """
    use_pipe = "pipeline" in policy and mesh.shape[MODEL_AXIS] > 1
    use_tp = ("tp" in policy and "pipeline" not in policy
              and mesh.shape[MODEL_AXIS] > 1)
    use_fsdp = "fsdp" in policy and mesh.shape[DATA_AXIS] > 1
    n_data = mesh.shape[DATA_AXIS]
    n_model = mesh.shape[MODEL_AXIS]

    def one(path, leaf):
        name = _path_str(path)
        shape = leaf.shape
        if use_pipe and "_stacked/" in name + "/":
            if not (shape and shape[0] % n_model == 0):
                raise ValueError(
                    f"stacked leaf {name}: layer axis {shape[0] if shape else 0} "
                    f"does not divide over {MODEL_AXIS}={n_model}")
            return NamedSharding(mesh, P(MODEL_AXIS))
        tp = [None] * len(shape)
        if use_tp and len(shape) >= 1:
            if _TP_COL.search(name) and shape[-1] % mesh.shape[MODEL_AXIS] == 0:
                tp[-1] = MODEL_AXIS
            elif _TP_ROW.search(name) and shape[0] % mesh.shape[MODEL_AXIS] == 0:
                tp[0] = MODEL_AXIS
            elif _TP_COL_BIAS.search(name) and shape[-1] % mesh.shape[MODEL_AXIS] == 0:
                tp[-1] = MODEL_AXIS
        spec = P(*tp)
        if use_fsdp and leaf.size >= min_fsdp_size:
            spec = _fsdp_spec(shape, tp, n_data)
        return NamedSharding(mesh, spec)

    return jax.tree_util.tree_map_with_path(one, params)


def shard_params(params: Any, shardings: Any) -> Any:
    return jax.device_put(params, shardings)


def opt_state_shardings(opt_state: Any, params_sharding: Any,
                        mesh: Mesh, params: Any = None) -> Any:
    """Optimiser-state shardings: optax states embed copies of the params
    pytree (adam mu/nu, multi_transform partitions, masked wrappers) at
    arbitrary depths. Each opt-state leaf whose path ends with a param path
    *at a '/' boundary* (and, when `params` is given, matches its shape)
    inherits that param's sharding; every other leaf (step counters,
    schedule state) replicates.

    The boundary + shape checks guard against false suffix hits like
    'a/kernel' matching 'lora_a/kernel' (ADVICE r1)."""
    replicated = NamedSharding(mesh, P())
    by_suffix = {}
    for path, sh in jax.tree_util.tree_flatten_with_path(params_sharding)[0]:
        by_suffix[_path_str(path)] = sh
    shapes = {}
    if params is not None:
        for path, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            shapes[_path_str(path)] = leaf.shape

    def quantized_spec(cand, leaf):
        """int8 blockwise moments (train/quantized.py::_Quantized): codes
        (nb, block) / scales (nb, 1) are FLAT layouts — the param's own
        spec cannot apply. Shard the block axis (dim 0) over the same mesh
        axes the param is sharded over, so 8-bit state is distributed
        under fsdp instead of silently replicating (which would cost ~2x
        MORE per-device optimizer memory than sharded exact Adam)."""
        axes = []
        for entry in cand.spec:
            if entry is None:
                continue
            axes.extend(entry if isinstance(entry, (tuple, list))
                        else [entry])
        shape = getattr(leaf, "shape", ())
        if not axes or not shape:
            return replicated
        n = 1
        for a in axes:
            n *= mesh.shape[a]
        if shape[0] % n:
            return replicated
        return NamedSharding(mesh, P(tuple(axes)))

    flat, treedef = jax.tree_util.tree_flatten_with_path(opt_state)
    out = []
    for path, leaf in flat:
        ps = _path_str(path)
        base, quant = ps, False
        # NamedTuple fields stringify as attr keys ('/.codes', '/.scales')
        for tail in ("/.codes", "/.scales"):
            if ps.endswith(tail):
                base, quant = ps[:-len(tail)], True
                break
        sh = replicated
        for suffix, cand in by_suffix.items():
            if base == suffix or base.endswith("/" + suffix):
                if quant:
                    sh = quantized_spec(cand, leaf)
                    break
                if suffix in shapes and getattr(leaf, "shape", None) \
                        != shapes[suffix]:
                    continue
                sh = cand
                break
        out.append(sh)
    return jax.tree_util.tree_unflatten(treedef, out)
