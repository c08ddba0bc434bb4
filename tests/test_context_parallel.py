"""Context parallelism: sequence-sharded attention on the CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from smb_vision_tpu.ops.attention import xla_attention
from smb_vision_tpu.parallel.context import (
    context_parallel_attention,
    ring_attention,
)
from smb_vision_tpu.parallel.mesh import create_mesh


@pytest.fixture(scope="module")
def qkv():
    key = jax.random.PRNGKey(0)
    B, N, H, D = 2, 64, 4, 32
    return [jax.random.normal(k, (B, N, H, D), jnp.float32) * 0.5
            for k in jax.random.split(key, 3)]


def test_context_parallel_matches_dense(eight_devices, qkv):
    mesh = create_mesh(model=4, devices=eight_devices)
    q, k, v = qkv
    spec = NamedSharding(mesh, P(None, "model", None, None))
    qs, ks, vs = (jax.device_put(x, spec) for x in (q, k, v))
    out = context_parallel_attention(qs, ks, vs, mesh=mesh)
    ref = xla_attention(q, k, v)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=2e-5, rtol=2e-5)


def test_ring_attention_matches_dense(eight_devices, qkv):
    mesh = create_mesh(model=4, devices=eight_devices)
    q, k, v = qkv
    spec = NamedSharding(mesh, P(None, "model", None, None))
    qs, ks, vs = (jax.device_put(x, spec) for x in (q, k, v))
    out = ring_attention(qs, ks, vs, mesh=mesh)
    ref = xla_attention(q, k, v)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref),
                               atol=3e-5, rtol=3e-5)


def test_ring_attention_grad_flows(eight_devices, qkv):
    mesh = create_mesh(model=4, devices=eight_devices)
    q, k, v = qkv
    spec = NamedSharding(mesh, P(None, "model", None, None))
    qs, ks, vs = (jax.device_put(x, spec) for x in (q, k, v))

    def loss(q, k, v):
        return jnp.sum(
            context_parallel_attention(q, k, v, mesh=mesh) ** 2)

    g = jax.grad(loss)(qs, ks, vs)
    ref = jax.grad(lambda q, k, v: jnp.sum(xla_attention(q, k, v) ** 2))(
        q, k, v)
    np.testing.assert_allclose(np.asarray(g), np.asarray(ref), atol=5e-5,
                               rtol=5e-5)


def test_ring_attention_grads_match_dense(eight_devices, qkv):
    """Ring attention must be differentiable (the sequence-parallel TRAIN
    path with sp_variant='ring' relies on it; fori_loop with static bounds
    differentiates as a scan)."""
    mesh = create_mesh(model=4, devices=eight_devices)
    q, k, v = qkv
    spec = NamedSharding(mesh, P(None, "model", None, None))
    qs, ks, vs = (jax.device_put(x, spec) for x in (q, k, v))

    def loss(q, k, v):
        return jnp.sum(ring_attention(q, k, v, mesh=mesh) ** 2)

    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(qs, ks, vs)
    ref = jax.grad(lambda q, k, v: jnp.sum(xla_attention(q, k, v) ** 2),
                   argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(g, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-4, rtol=1e-4)


def test_ring_attention_uses_flash_wrapper(eight_devices, qkv, monkeypatch):
    """Every ring block must go through attention_with_lse — n_dev calls
    per ring invocation."""
    import smb_vision_tpu.parallel.context as ctx_mod

    mesh = create_mesh(model=4, devices=eight_devices)
    q, k, v = qkv
    spec = NamedSharding(mesh, P(None, "model", None, None))
    qs, ks, vs = (jax.device_put(x, spec) for x in (q, k, v))

    calls = {"n": 0}
    real = ctx_mod.attention_with_lse

    def spy(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(ctx_mod, "attention_with_lse", spy)
    out = ring_attention(qs, ks, vs, mesh=mesh)
    jax.block_until_ready(out)
    assert calls["n"] == 4, calls  # one block per ring position
