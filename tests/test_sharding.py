"""Mesh/sharding tests on the 8-device CPU mesh (the reference had zero
distributed tests; its DDP/ZeRO correctness was inherited trust in
HF Trainer/DeepSpeed — SURVEY §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from smb_vision_tpu.models.configs import VideoMAEConfig
from smb_vision_tpu.models.videomae import VideoMAEForPreTraining
from smb_vision_tpu.ops.masking import mim_mask, num_masked_tokens
from smb_vision_tpu.parallel.mesh import batch_sharding, create_mesh
from smb_vision_tpu.parallel.sharding import (
    opt_state_shardings,
    param_shardings,
    shard_params,
)

KEY = jax.random.PRNGKey(0)


def _tiny_cfg():
    return VideoMAEConfig(
        image_size=32, num_frames=16, patch_size=8, tubelet_size=8,
        num_channels=1, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, intermediate_size=128,
        decoder_hidden_size=32, decoder_num_hidden_layers=1,
        decoder_num_attention_heads=2, decoder_intermediate_size=64,
        dtype="float32", attn_impl="xla")


def test_mesh_shapes(eight_devices):
    mesh = create_mesh(devices=eight_devices)
    assert mesh.shape["data"] == 8 and mesh.shape["model"] == 1
    mesh2 = create_mesh(model=2, devices=eight_devices)
    assert mesh2.shape["data"] == 4 and mesh2.shape["model"] == 2


def test_fsdp_param_shardings(eight_devices):
    mesh = create_mesh(devices=eight_devices)
    cfg = _tiny_cfg()
    px = jnp.zeros((1, 16, 1, 32, 32))
    M = num_masked_tokens(32, 16, 8, 8, 0.5)
    mask = mim_mask(KEY, 1, input_size=32, depth=16, mask_patch_size=8,
                    model_patch_size=8, mask_ratio=0.5)
    model = VideoMAEForPreTraining(cfg)
    params = model.init(KEY, px, mask, M)
    sh = param_shardings(params, mesh, policy="fsdp", min_fsdp_size=1024)
    flat = jax.tree_util.tree_leaves(sh)
    assert any(s.spec != P() for s in flat), "fsdp sharded nothing"
    sharded = shard_params(params, sh)
    # round-trips values
    a = jax.tree_util.tree_leaves(params)[0]
    b = jax.tree_util.tree_leaves(sharded)[0]
    np.testing.assert_allclose(np.asarray(a), np.asarray(b))


def test_tp_rules(eight_devices):
    mesh = create_mesh(model=2, devices=eight_devices)
    cfg = _tiny_cfg()
    px = jnp.zeros((1, 16, 1, 32, 32))
    M = num_masked_tokens(32, 16, 8, 8, 0.5)
    mask = mim_mask(KEY, 1, input_size=32, depth=16, mask_patch_size=8,
                    model_patch_size=8, mask_ratio=0.5)
    model = VideoMAEForPreTraining(cfg)
    params = model.init(KEY, px, mask, M)
    sh = param_shardings(params, mesh, policy="tp")

    flat = jax.tree_util.tree_flatten_with_path(sh)[0]
    qk = [s for p, s in flat if "query" in str(p) and "kernel" in str(p)]
    assert qk and all(s.spec == P(None, "model") for s in qk)
    fc2 = [s for p, s in flat if "fc2" in str(p) and "kernel" in str(p)]
    assert fc2 and all(s.spec == P("model", None) for s in fc2)


def test_sharded_train_step_runs(eight_devices):
    """Full jitted fsdp train step on the CPU mesh: grads + adamw update."""
    mesh = create_mesh(devices=eight_devices)
    cfg = _tiny_cfg()
    B = 8
    px = jax.random.normal(KEY, (B, 16, 1, 32, 32))
    M = num_masked_tokens(32, 16, 8, 8, 0.5)
    mask = mim_mask(KEY, B, input_size=32, depth=16, mask_patch_size=8,
                    model_patch_size=8, mask_ratio=0.5)
    model = VideoMAEForPreTraining(cfg)
    params = model.init(KEY, px, mask, M)

    p_sh = param_shardings(params, mesh, policy="fsdp", min_fsdp_size=1024)
    params = shard_params(params, p_sh)
    tx = optax.adamw(1e-3)
    opt_state = tx.init(params)
    o_sh = opt_state_shardings(opt_state, p_sh, mesh)
    opt_state = jax.device_put(opt_state, o_sh)
    b_sh = batch_sharding(mesh)
    px = jax.device_put(px, b_sh)
    mask = jax.device_put(mask, b_sh)

    @jax.jit
    def step(params, opt_state, px, mask):
        def loss_fn(p):
            return model.apply(p, px, mask, M)["loss"]
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return loss, optax.apply_updates(params, updates), opt_state

    loss0, params, opt_state = step(params, opt_state, px, mask)
    loss1, params, _ = step(params, opt_state, px, mask)
    assert np.isfinite(float(loss0)) and np.isfinite(float(loss1))
    assert float(loss1) < float(loss0) * 1.5


def test_opt_state_sharding_suffix_boundary(eight_devices):
    """'a/kernel' must NOT inherit 'lora_a/kernel' sharding (ADVICE r1):
    matches only at '/' boundaries and only when shapes agree."""
    mesh = create_mesh()
    params = {"lora_a": {"kernel": jnp.zeros((16, 8))},
              "a": {"kernel": jnp.zeros((4, 4))}}
    p_sh = {"lora_a": {"kernel": NamedSharding(mesh, P("data", None))},
            "a": {"kernel": NamedSharding(mesh, P())}}
    # fake opt state mirroring params (adam mu)
    opt = {"mu": params, "count": jnp.zeros(())}
    o_sh = opt_state_shardings(opt, p_sh, mesh, params=params)
    assert o_sh["mu"]["a"]["kernel"].spec == P()
    assert o_sh["mu"]["lora_a"]["kernel"].spec == P("data", None)
    assert o_sh["count"].spec == P()

    # shape mismatch at a matching path -> falls back to replicated
    opt2 = {"mu": {"a": {"kernel": jnp.zeros((2, 2))}}}
    o_sh2 = opt_state_shardings(opt2, p_sh, mesh, params=params)
    assert o_sh2["mu"]["a"]["kernel"].spec == P()


def test_pipeline_policy_shards_stacked_layer_axis(eight_devices):
    """sharding_policy='pipeline': leaves under a *_stacked component
    shard their leading layer axis over the model axis; glue replicates;
    'pipeline+fsdp' additionally fsdp-shards large glue leaves."""
    from smb_vision_tpu.parallel.sharding import param_shardings

    mesh = create_mesh(model=4, devices=eight_devices)
    params = {"params": {
        "videomae": {
            "encoder_stacked": {"attention": {
                "query": {"kernel": jnp.zeros((8, 64, 64))}}},
            "patch_embed_kernel": jnp.zeros((64, 1, 8, 8, 8)),
        },
        "decoder_stacked": {"mlp": {"fc1": {
            "kernel": jnp.zeros((4, 64, 128))}}},
        "mask_token": jnp.zeros((1, 1, 64)),
    }}
    sh = param_shardings(params, mesh, policy="pipeline")
    p = sh["params"]
    assert p["videomae"]["encoder_stacked"]["attention"]["query"][
        "kernel"].spec == P("model")
    assert p["decoder_stacked"]["mlp"]["fc1"]["kernel"].spec == P("model")
    # replicated glue: spec has no mesh axes (P() or all-None)
    assert not any(tuple(p["videomae"]["patch_embed_kernel"].spec))
    assert not any(tuple(p["mask_token"].spec))

    sh2 = param_shardings(params, mesh, policy="pipeline+fsdp",
                          min_fsdp_size=1024)
    p2 = sh2["params"]
    # stacked leaves keep the pipe spec; the big glue leaf fsdp-shards
    assert p2["decoder_stacked"]["mlp"]["fc1"]["kernel"].spec == P("model")
    assert "data" in tuple(p2["videomae"]["patch_embed_kernel"].spec)

    # a stacked layer axis that does not divide the model axis is an error
    bad = {"encoder_stacked": {"w": jnp.zeros((3, 8))}}
    with pytest.raises(ValueError, match="does not divide"):
        param_shardings(bad, mesh, policy="pipeline")


def test_fsdp_memory_analysis_vs_dp(eight_devices):
    """fsdp (the ZeRO-3 equivalent, reference ds_z3_config.json) must
    actually shrink per-device resident state: compiled memory_analysis
    of the SAME train step shows fsdp argument bytes well under the
    replicated-dp bytes."""
    from smb_vision_tpu.parallel.mesh import replicated
    from smb_vision_tpu.train.mim import make_mim_workload

    cfg = _tiny_cfg()
    mesh = create_mesh(devices=eight_devices)
    tx = optax.adamw(1e-3)
    _, init_fn, step_fn, _ = make_mim_workload(
        cfg, mask_patch_size=8, mask_ratio=0.5, tx=tx)
    batch = mesh.shape["data"]

    def analyzed(policy):
        with jax.set_mesh(mesh):
            state = jax.eval_shape(init_fn, KEY)
            if policy == "dp":
                p_sh = jax.tree.map(lambda _: replicated(mesh),
                                    state["params"])
            else:
                p_sh = param_shardings(state["params"], mesh,
                                       policy=policy, min_fsdp_size=64)
            state["params"] = jax.tree.map(
                lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype,
                                                   sharding=sh),
                state["params"], p_sh)
            o_sh = opt_state_shardings(state["opt_state"], p_sh, mesh,
                                       params=state["params"])
            state["opt_state"] = jax.tree.map(
                lambda s, sh: jax.ShapeDtypeStruct(s.shape, s.dtype,
                                                   sharding=sh),
                state["opt_state"], o_sh)
            state["step"] = jax.ShapeDtypeStruct(
                state["step"].shape, state["step"].dtype,
                sharding=replicated(mesh))
            b = jax.ShapeDtypeStruct(
                (batch, cfg.num_frames, 1, cfg.image_size,
                 cfg.image_size), jnp.float32,
                sharding=batch_sharding(mesh))
            kspec = jax.ShapeDtypeStruct((2,), jnp.uint32,
                                         sharding=replicated(mesh))
            return jax.jit(step_fn, donate_argnums=(0,)).lower(
                state, {"pixel_values": b}, kspec).compile() \
                .memory_analysis()

    dp = analyzed("dp")
    fsdp = analyzed("fsdp")
    # params+moments dominate args; 8-way sharding of everything above
    # min_fsdp_size must cut the resident bytes by at least 3x (the
    # ViT-L probe measures 8.0x — the tiny model has relatively more
    # unshardable small leaves and replicated batch)
    assert fsdp.argument_size_in_bytes * 3 < dp.argument_size_in_bytes, (
        fsdp.argument_size_in_bytes, dp.argument_size_in_bytes)
