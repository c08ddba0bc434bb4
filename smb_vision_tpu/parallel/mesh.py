"""Device mesh construction.

The reference scales with NCCL DDP + DeepSpeed ZeRO configured by accelerate
YAML / ds JSON (acc_configs/, ds_configs/). The JAX equivalent is a
single ``jax.sharding.Mesh`` with named axes and GSPMD-inserted collectives:

- axis "data":  batch (and ZeRO-style fully-sharded params/opt-state)
- axis "model": tensor parallelism (attention heads / MLP columns)

The GPUs of one host are connected all to all (NVLink), so the mesh is
just `jax.devices()` reshaped; several hosts join through
`maybe_initialize_distributed`.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"
MODEL_AXIS = "model"


def create_mesh(data: Optional[int] = None, model: int = 1,
                devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """Build a ("data", "model") mesh. ``data`` defaults to
    n_devices // model."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if data is None:
        if n % model:
            raise ValueError(f"{n} devices not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} devices")
    arr = np.asarray(devices).reshape(data, model)
    return Mesh(arr, (DATA_AXIS, MODEL_AXIS))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def init_batch_size() -> int:
    """Batch size for dummy inputs in workload init_fns: the ambient
    mesh's data-axis size when one is set, else 1. Parameter shapes never
    depend on batch, but under sequence_parallel the attention shard_map
    pins the batch dim to the "data" axis (parallel/context.py:61) — a
    batch-1 dummy then fails the divisibility check on any data>1 mesh,
    so init must trace with one row per data shard."""
    mesh = jax.sharding.get_abstract_mesh()
    if not mesh.empty and DATA_AXIS in mesh.shape:
        return mesh.shape[DATA_AXIS]
    return 1


def local_batch_slice(global_batch: int, mesh: Mesh) -> int:
    """Per-PROCESS batch share for multi-host feeding (the reference's
    partition_dataset equivalent, keyed on jax.process_index()). Each host
    feeds global_batch / process_count examples — NOT global_batch /
    data-device-count, which would be the per-DEVICE share (a process
    usually owns several data-parallel devices)."""
    n_proc = max(len({d.process_index for d in mesh.devices.flat}), 1)
    if global_batch % n_proc:
        raise ValueError(
            f"global batch {global_batch} does not divide over "
            f"{n_proc} host processes")
    return global_batch // n_proc


def maybe_initialize_distributed(enable=None) -> bool:
    """Multi-host bring-up: call jax.distributed.initialize() so
    jax.process_count()/process_index() see every host (the reference
    relies on torch.distributed init via DeepSpeed launchers;
    scripts/training/*.sh -> deepspeed). Without this, every host runs as
    its own single-process world and the CLIs' partition_items() data
    split degenerates to "everyone reads everything".

    The coordinator comes from the environment: JAX_COORDINATOR_ADDRESS
    (host:port), JAX_NUM_PROCESSES and JAX_PROCESS_ID, passed to
    initialize() explicitly. enable=None initializes when
    JAX_COORDINATOR_ADDRESS is set; False skips; True forces. Must run
    before the first device access. Returns True when a multi-process
    runtime is up. Safe to call twice; any other initialize() error
    propagates.
    """
    import os

    env = os.environ
    if enable is None:
        enable = bool(env.get("JAX_COORDINATOR_ADDRESS"))
    if not enable:
        return False
    kw = {}
    if env.get("JAX_COORDINATOR_ADDRESS"):
        kw["coordinator_address"] = env["JAX_COORDINATOR_ADDRESS"]
    if env.get("JAX_NUM_PROCESSES"):
        kw["num_processes"] = int(env["JAX_NUM_PROCESSES"])
    if env.get("JAX_PROCESS_ID"):
        kw["process_id"] = int(env["JAX_PROCESS_ID"])
    try:
        jax.distributed.initialize(**kw)
    except RuntimeError as e:
        # double-init is a no-op ("distributed.initialize should only be
        # called once.")
        if "only be called once" not in str(e).lower():
            raise
    return jax.process_count() > 1
