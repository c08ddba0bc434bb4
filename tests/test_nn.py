"""The in-repo module layer (smb_vision_tpu/nn.py): layer numerics against
flax.linen where flax is installed, init/apply semantics, remat, RNG
streams, and the models' param trees key-for-key."""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smb_vision_tpu import nn

KEY = jax.random.PRNGKey(0)
TREES = json.loads((Path(__file__).parent / "data" /
                    "param_trees.json").read_text())


def _flax():
    return pytest.importorskip("flax.linen")


def _same(a, b):
    np.testing.assert_array_equal(np.asarray(a, np.float32),
                                  np.asarray(b, np.float32))


@pytest.mark.parametrize("dtype", [None, jnp.bfloat16, jnp.float32])
def test_dense_matches_flax(dtype):
    fnn = _flax()
    x = jax.random.normal(KEY, (2, 5, 16)).astype(jnp.bfloat16)
    ours = nn.Dense(8, dtype=dtype)
    theirs = fnn.Dense(8, dtype=dtype, param_dtype=jnp.float32)
    p = theirs.init(KEY, x)
    assert jax.tree_util.tree_structure(ours.init(KEY, x)) == \
        jax.tree_util.tree_structure(p)
    y = ours.apply(p, x)
    assert y.dtype == theirs.apply(p, x).dtype
    _same(y, theirs.apply(p, x))


@pytest.mark.parametrize("dtype", [None, jnp.bfloat16, jnp.float32])
def test_layernorm_matches_flax(dtype):
    fnn = _flax()
    x = (jax.random.normal(KEY, (2, 5, 16)) * 3 + 1).astype(jnp.bfloat16)
    theirs = fnn.LayerNorm(epsilon=1e-6, dtype=dtype,
                           param_dtype=jnp.float32)
    p = theirs.init(KEY, x)
    p = jax.tree_util.tree_map(lambda t: t + jax.random.normal(KEY, t.shape),
                               p)
    y = nn.LayerNorm(epsilon=1e-6, dtype=dtype).apply(p, x)
    assert y.dtype == theirs.apply(p, x).dtype
    _same(y, theirs.apply(p, x))


def test_conv_and_max_pool_match_flax():
    fnn = _flax()
    x = jax.random.normal(KEY, (2, 8, 9, 10, 3))
    kw = dict(strides=(2, 1, 2), padding=[(1, 1)] * 3, use_bias=False,
              dtype=jnp.float32)
    theirs = fnn.Conv(4, (3, 3, 3), **kw)
    p = theirs.init(KEY, x)
    assert p["params"]["kernel"].shape == (3, 3, 3, 3, 4)
    _same(nn.Conv(4, (3, 3, 3), **kw).apply(p, x), theirs.apply(p, x))
    pool = dict(strides=(2, 2, 2), padding=[(1, 1)] * 3)
    _same(nn.max_pool(x, (3, 3, 3), **pool),
          fnn.max_pool(x, (3, 3, 3), **pool))


class _Two(nn.Module):
    width: int

    @nn.compact
    def __call__(self, x, train: bool = False):
        x = nn.Dense(self.width, name="a")(x)
        x = nn.Dense(self.width)(x)              # auto-named Dense_0
        if train:
            x = x + jax.random.normal(self.make_rng("noise"), x.shape)
        return nn.Dense(self.width)(x)           # Dense_1


def test_init_apply_tree_and_auto_names():
    m = _Two(4)
    x = jnp.ones((2, 3))
    params = m.init(KEY, x)
    assert set(params) == {"params"}
    assert set(params["params"]) == {"a", "Dense_0", "Dense_1"}
    assert params["params"]["a"]["kernel"].shape == (3, 4)
    y = m.apply(params, x)
    assert y.shape == (2, 4)
    # init is deterministic in the key, and differs between keys
    _same(m.init(KEY, x)["params"]["a"]["kernel"],
          params["params"]["a"]["kernel"])
    assert not np.allclose(m.init(jax.random.PRNGKey(1), x)["params"]["a"]
                           ["kernel"], params["params"]["a"]["kernel"])


def test_make_rng_streams():
    m = _Two(4)
    x = jnp.ones((2, 3))
    params = m.init(KEY, x)
    with pytest.raises(ValueError, match="noise"):
        m.apply(params, x, True)
    a = m.apply(params, x, True, rngs={"noise": jax.random.PRNGKey(1)})
    b = m.apply(params, x, True, rngs={"noise": jax.random.PRNGKey(1)})
    c = m.apply(params, x, True, rngs={"noise": jax.random.PRNGKey(2)})
    _same(a, b)
    assert not np.allclose(a, c)


def test_missing_param_raises():
    m = _Two(4)
    params = m.init(KEY, jnp.ones((2, 3)))
    del params["params"]["Dense_1"]
    with pytest.raises(KeyError, match="Dense_1"):
        m.apply(params, jnp.ones((2, 3)))


def test_module_outside_init_apply_raises():
    with pytest.raises(RuntimeError, match="outside init/apply"):
        nn.Dense(3)(jnp.ones((1, 2)))


def test_remat_matches_plain_and_grads():
    from smb_vision_tpu.models.layers import Block, Encoder

    x = jax.random.normal(KEY, (2, 16, 32))
    kw = dict(num_layers=2, hidden_size=32, num_heads=2,
              intermediate_size=64, dtype=jnp.float32, drop_path_rate=0.2)
    plain, rem = Encoder(**kw), Encoder(**kw, remat=True)
    params = plain.init(KEY, x)
    assert jax.tree_util.tree_structure(rem.init(KEY, x)) == \
        jax.tree_util.tree_structure(params)
    _same(rem.apply(params, x), plain.apply(params, x))
    rngs = {"droppath": jax.random.PRNGKey(3)}

    def loss(m):
        return lambda p: jnp.sum(m.apply(p, x, None, False, rngs=rngs) ** 2)

    g1 = jax.grad(loss(plain))(params)
    g2 = jax.grad(loss(rem))(params)
    assert np.isfinite(float(loss(rem)(params)))
    for a, b in zip(jax.tree_util.tree_leaves(g1),
                    jax.tree_util.tree_leaves(g2)):
        assert a.shape == b.shape and np.all(np.isfinite(b))
    assert issubclass(nn.remat(Block), Block)


def _paths(params):
    return [f"{'/'.join(str(getattr(k, 'key', k)) for k in kp)} "
            f"{'x'.join(map(str, v.shape))}"
            for kp, v in jax.tree_util.tree_flatten_with_path(params)[0]]


def _tiny(name):
    from smb_vision_tpu.models.configs import (
        Dinov2Config,
        VideoMAEConfig,
        VJEPA2Config,
    )
    from smb_vision_tpu.models.dinov2 import Dinov2ForImageClassification
    from smb_vision_tpu.models.videomae import (
        VideoMAEForPreTraining,
        VideoMAEForVideoClassification,
    )
    from smb_vision_tpu.models.vjepa import (
        VJEPA2ForVideoClassification,
        VJEPA2Model,
    )
    from smb_vision_tpu.ops.masking import (
        mim_mask,
        num_masked_tokens,
        vjepa_target_mask,
    )

    vm = dict(image_size=32, num_frames=16, patch_size=8, tubelet_size=8,
              num_channels=1, hidden_size=64, num_hidden_layers=2,
              num_attention_heads=4, intermediate_size=128,
              decoder_hidden_size=32, decoder_num_hidden_layers=1,
              decoder_num_attention_heads=2, decoder_intermediate_size=64,
              dtype="float32", attn_impl="xla")
    vj = dict(crop_size=32, frames_per_clip=16, patch_size=8,
              tubelet_size=8, in_chans=1, hidden_size=64,
              num_hidden_layers=2, num_attention_heads=4,
              pred_hidden_size=32, pred_num_hidden_layers=2,
              pred_num_attention_heads=2, dtype="float32", attn_impl="xla")
    dn = dict(image_size=32, patch_size=8, depth=16, hidden_size=64,
              num_hidden_layers=2, num_attention_heads=4, dtype="float32",
              attn_impl="xla")
    px = jnp.zeros((2, 16, 1, 32, 32))
    if name == "VideoMAEForPreTraining":
        m = num_masked_tokens(32, 16, 8, 8, 0.5)
        mask = mim_mask(KEY, 2, input_size=32, depth=16, mask_patch_size=8,
                        model_patch_size=8, mask_ratio=0.5)
        return VideoMAEForPreTraining(VideoMAEConfig(**vm)), (px, mask, m), {}
    if name == "VideoMAEForVideoClassification":
        return VideoMAEForVideoClassification(VideoMAEConfig(**vm)), (px,), {}
    if name == "VJEPA2Model":
        cfg = VJEPA2Config(**vj)
        tb = vjepa_target_mask(KEY, 2, grid=cfg.grid, num_blocks=2)
        return VJEPA2Model(cfg), (px,), {"target_bool": tb}
    if name == "VJEPA2ForVideoClassification":
        return VJEPA2ForVideoClassification(VJEPA2Config(**vj)), (px,), {}
    swiglu = name == "Dinov2_swiglu"
    model = Dinov2ForImageClassification(
        Dinov2Config(**dn, use_swiglu_ffn=swiglu))
    return model, (jnp.zeros((2, 1, 32, 32, 16)),), {}


@pytest.mark.parametrize("name", sorted(TREES))
def test_param_tree_unchanged(name):
    """Every param key path and shape equals the tree recorded from the
    flax.linen implementation of the same model, so converters, saved
    checkpoints and export_hf keep working."""
    model, args, kw = _tiny(name)
    params = jax.eval_shape(lambda k: model.init(k, *args, **kw), KEY)
    assert _paths(params) == TREES[name]
