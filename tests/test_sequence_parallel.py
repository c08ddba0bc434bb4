"""Sequence parallelism wired into the models: a full MIM train step with
the token dimension sharded over the mesh "model" axis."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from smb_vision_tpu.models.configs import VideoMAEConfig
from smb_vision_tpu.models.videomae import VideoMAEForPreTraining
from smb_vision_tpu.ops.masking import mim_mask, num_masked_tokens
from smb_vision_tpu.parallel.mesh import create_mesh

KEY = jax.random.PRNGKey(0)


def _cfg(sp):
    return VideoMAEConfig(
        image_size=32, num_frames=16, patch_size=8, tubelet_size=8,
        num_channels=1, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        decoder_hidden_size=32, decoder_num_hidden_layers=1,
        decoder_num_attention_heads=2, decoder_intermediate_size=64,
        dtype="float32", attn_impl="xla", sequence_parallel=sp)


def test_sequence_parallel_step_matches_dense(eight_devices):
    mesh = create_mesh(model=4, devices=eight_devices)
    B = 2
    px = jax.random.normal(KEY, (B, 16, 1, 32, 32))
    M = num_masked_tokens(32, 16, 8, 8, 0.5)
    mask = mim_mask(KEY, B, input_size=32, depth=16, mask_patch_size=8,
                    model_patch_size=8, mask_ratio=0.5)

    dense = VideoMAEForPreTraining(_cfg(False))
    params = dense.init(KEY, px, mask, M)
    loss_dense = float(dense.apply(params, px, mask, M)["loss"])

    sp_model = VideoMAEForPreTraining(_cfg(True))
    with jax.set_mesh(mesh):
        fwd = jax.jit(lambda p, x, m: sp_model.apply(p, x, m, M)["loss"])
        loss_sp = float(fwd(params, px, mask))
    np.testing.assert_allclose(loss_sp, loss_dense, rtol=2e-5)


def test_sequence_parallel_train_step(eight_devices):
    mesh = create_mesh(model=4, devices=eight_devices)
    model = VideoMAEForPreTraining(_cfg(True))
    B = 2
    px = jax.random.normal(KEY, (B, 16, 1, 32, 32))
    M = num_masked_tokens(32, 16, 8, 8, 0.5)
    mask = mim_mask(KEY, B, input_size=32, depth=16, mask_patch_size=8,
                    model_patch_size=8, mask_ratio=0.5)
    with jax.set_mesh(mesh):
        params = jax.jit(model.init, static_argnums=(3,))(KEY, px, mask, M)
        tx = optax.adamw(1e-3)
        opt = tx.init(params)

        @jax.jit
        def step(params, opt, px, mask):
            loss, grads = jax.value_and_grad(
                lambda p: model.apply(p, px, mask, M)["loss"])(params)
            up, opt = tx.update(grads, opt, params)
            return loss, optax.apply_updates(params, up), opt

        l0, params, opt = step(params, opt, px, mask)
        l1, params, opt = step(params, opt, px, mask)
    assert np.isfinite(float(l0)) and float(l1) < float(l0)


def test_sequence_parallel_uses_flash_wrapper(eight_devices, monkeypatch):
    """The SP model path must route attention through the shard_map CP
    wrapper (which runs `attention` per shard), not whole-sequence
    attention."""
    import smb_vision_tpu.models.layers as layers_mod
    import smb_vision_tpu.parallel.context as ctx_mod

    calls = {"cp": 0}
    real = ctx_mod.context_parallel_attention

    def spy(*a, **kw):
        calls["cp"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(ctx_mod, "context_parallel_attention", spy)

    mesh = create_mesh(model=4, devices=eight_devices)
    px = jax.random.normal(KEY, (2, 16, 1, 32, 32))
    M = num_masked_tokens(32, 16, 8, 8, 0.5)
    mask = mim_mask(KEY, 2, input_size=32, depth=16, mask_patch_size=8,
                    model_patch_size=8, mask_ratio=0.5)
    model = VideoMAEForPreTraining(_cfg(True))
    params = VideoMAEForPreTraining(_cfg(False)).init(KEY, px, mask, M)
    with jax.set_mesh(mesh):
        loss = float(model.apply(params, px, mask, M)["loss"])
    assert np.isfinite(loss)
    # encoder 2 layers + decoder 1 layer = 3 attention calls
    assert calls["cp"] == 3, calls


def test_sequence_parallel_ring_variant_matches_dense(eight_devices):
    mesh = create_mesh(model=4, devices=eight_devices)
    B = 2
    px = jax.random.normal(KEY, (B, 16, 1, 32, 32))
    M = num_masked_tokens(32, 16, 8, 8, 0.5)
    mask = mim_mask(KEY, B, input_size=32, depth=16, mask_patch_size=8,
                    model_patch_size=8, mask_ratio=0.5)

    dense = VideoMAEForPreTraining(_cfg(False))
    params = dense.init(KEY, px, mask, M)
    loss_dense = float(dense.apply(params, px, mask, M)["loss"])

    cfg = _cfg(True)
    import dataclasses
    cfg = dataclasses.replace(cfg, sp_variant="ring")
    ring_model = VideoMAEForPreTraining(cfg)
    with jax.set_mesh(mesh):
        fwd = jax.jit(lambda p, x, m: ring_model.apply(p, x, m, M)["loss"])
        loss_ring = float(fwd(params, px, mask))
    np.testing.assert_allclose(loss_ring, loss_dense, rtol=3e-5)
