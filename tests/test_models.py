"""Model shape/numeric contracts.

Covers (and extends) the reference's model tests
(/root/reference/tests/test_vjepa_model.py): default full-mask forward,
custom index masks with (B*num_masks) stacking, skip_predictor — plus the
dense-vs-gather predictor equivalence the reference could not test, MIM
reconstruction loss behaviour, and head variants.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smb_vision_tpu.models.configs import (
    Dinov2Config,
    VideoMAEConfig,
    VJEPA2Config,
)
from smb_vision_tpu.models.dinov2 import Dinov2ForImageClassification
from smb_vision_tpu.models.videomae import (
    VideoMAEForPreTraining,
    VideoMAEForVideoClassification,
    VideoMAEModel,
)
from smb_vision_tpu.models.vjepa import (
    VJEPA2ForVideoClassification,
    VJEPA2Model,
    vjepa_loss,
)
from smb_vision_tpu.ops.masking import (
    mim_mask,
    num_masked_tokens,
    vjepa_target_mask,
)

KEY = jax.random.PRNGKey(0)


def tiny_vjepa():
    # mirrors reference create_dummy_config: hidden 64 / 2 layers / 32^3-ish
    return VJEPA2Config(
        crop_size=32, frames_per_clip=16, patch_size=8, tubelet_size=8,
        in_chans=1, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=4, pred_hidden_size=32,
        pred_num_hidden_layers=2, pred_num_attention_heads=2,
        dtype="float32", attn_impl="xla")


def tiny_videomae(**kw):
    base = dict(image_size=32, num_frames=16, patch_size=8, tubelet_size=8,
                num_channels=1, hidden_size=64, num_hidden_layers=2,
                num_attention_heads=4, intermediate_size=128,
                decoder_hidden_size=32, decoder_num_hidden_layers=1,
                decoder_num_attention_heads=2, decoder_intermediate_size=64,
                dtype="float32", attn_impl="xla")
    base.update(kw)
    return VideoMAEConfig(**base)


@pytest.fixture(scope="module")
def vjepa_setup():
    cfg = tiny_vjepa()
    px = jax.random.normal(KEY, (2, 16, 1, 32, 32))
    model = VJEPA2Model(cfg)
    tb = vjepa_target_mask(KEY, 2, grid=cfg.grid, num_blocks=2)
    params = model.init(KEY, px, target_bool=tb)
    return cfg, model, params, px, tb


def test_vjepa_default_full_mask(vjepa_setup):
    cfg, model, params, px, _ = vjepa_setup
    out = model.apply(params, px)
    n = cfg.seq_len
    assert out["last_hidden_state"].shape == (2, n, 64)
    assert out["masked_hidden_state"].shape == (2, n, 64)
    assert out["target_hidden_state"].shape == (2, n, 64)
    assert out["predictor_output"].shape == (2, n, 64)


def test_vjepa_custom_masks_stacking(vjepa_setup):
    # reference semantics: two masks -> (B*2, L, D)
    cfg, model, params, px, _ = vjepa_setup
    ctx = jnp.tile(jnp.arange(10)[None], (2, 1))
    tgt = jnp.tile(jnp.arange(10, 30)[None], (2, 1))
    out = model.apply(params, px, context_mask=[ctx, ctx],
                      target_mask=[tgt, tgt])
    assert out["masked_hidden_state"].shape == (4, 10, 64)
    assert out["target_hidden_state"].shape == (4, 20, 64)
    assert out["predictor_output"].shape == (4, 20, 64)


def test_vjepa_skip_predictor(vjepa_setup):
    cfg, model, params, px, tb = vjepa_setup
    out = model.apply(params, px, target_bool=tb, skip_predictor=True)
    assert "predictor_output" not in out
    assert out["last_hidden_state"].shape == (2, cfg.seq_len, 64)


def test_vjepa_dense_equals_gather_path(vjepa_setup):
    cfg, model, params, px, _ = vjepa_setup
    n = cfg.seq_len
    row = np.zeros(n, bool)
    row[[1, 2, 3, 9, 10, 17, 25, 30]] = True
    tb = jnp.asarray(np.tile(row, (2, 1)))
    dense = model.apply(params, px, target_bool=tb)["predictor_output"]
    ctx = jnp.asarray(np.tile(np.nonzero(~row)[0], (2, 1)))
    tgt = jnp.asarray(np.tile(np.nonzero(row)[0], (2, 1)))
    gathered = model.apply(params, px, context_mask=[ctx],
                           target_mask=[tgt])["predictor_output"]
    dense_at_tgt = jnp.take_along_axis(dense, tgt[..., None], axis=1)
    np.testing.assert_allclose(np.asarray(dense_at_tgt),
                               np.asarray(gathered), atol=2e-5, rtol=2e-5)


def test_vjepa_loss_masked_l1(vjepa_setup):
    cfg, model, params, px, tb = vjepa_setup
    out = model.apply(params, px, target_bool=tb)
    loss = vjepa_loss(out["predictor_output"], out["last_hidden_state"], tb)
    assert loss.shape == () and float(loss) > 0
    # loss must ignore non-target positions
    perturbed = out["predictor_output"].at[:, :, :].set(
        jnp.where(tb[..., None], out["predictor_output"], 1e6))
    loss2 = vjepa_loss(perturbed, out["last_hidden_state"], tb)
    np.testing.assert_allclose(float(loss2), float(loss), rtol=1e-6)


def test_vjepa_classification(vjepa_setup):
    cfg, _, _, px, _ = vjepa_setup
    m = VJEPA2ForVideoClassification(cfg)
    p = m.init(KEY, px)
    out = m.apply(p, px, labels=jnp.array([0, 1]))
    assert out["logits"].shape == (2, cfg.num_labels)
    assert float(out["loss"]) > 0


def test_videomae_pretrain_shapes_and_loss():
    cfg = tiny_videomae()
    px = jax.random.normal(KEEP := KEY, (2, 16, 1, 32, 32))
    M = num_masked_tokens(32, 16, 8, 8, 0.5)
    mask = mim_mask(KEY, 2, input_size=32, depth=16, mask_patch_size=8,
                    model_patch_size=8, mask_ratio=0.5)
    model = VideoMAEForPreTraining(cfg)
    params = model.init(KEY, px, mask, M)
    out = model.apply(params, px, mask, M)
    assert out["logits"].shape == (2, M, cfg.patch_dim)
    assert float(out["loss"]) > 0


def test_videomae_reconstruction_can_overfit_zero():
    # with constant input and norm_pix_loss off, predicting the patch mean
    # bias alone should reduce loss quickly under a few grad steps
    cfg = tiny_videomae(norm_pix_loss=False)
    px = jnp.ones((1, 16, 1, 32, 32)) * 0.5
    M = num_masked_tokens(32, 16, 8, 8, 0.5)
    mask = mim_mask(KEY, 1, input_size=32, depth=16, mask_patch_size=8,
                    model_patch_size=8, mask_ratio=0.5)
    model = VideoMAEForPreTraining(cfg)
    params = model.init(KEY, px, mask, M)

    def loss_fn(p):
        return model.apply(p, px, mask, M)["loss"]

    l0 = float(loss_fn(params))
    g = jax.grad(loss_fn)(params)
    params2 = jax.tree_util.tree_map(lambda p, gg: p - 0.5 * gg, params, g)
    l1 = float(loss_fn(params2))
    assert l1 < l0


def test_videomae_classification_heads():
    cfg = tiny_videomae(num_labels=3, additional_features_size=2,
                        problem_type="single_label_classification")
    px = jax.random.normal(KEY, (2, 16, 1, 32, 32))
    m = VideoMAEForVideoClassification(cfg)
    feats = jnp.ones((2, 2))
    p = m.init(KEY, px, feats, jnp.array([0, 2]))
    out = m.apply(p, px, feats, jnp.array([0, 2]))
    assert out["logits"].shape == (2, 3)

    # regression
    cfg_r = tiny_videomae(num_labels=1, problem_type="regression")
    mr = VideoMAEForVideoClassification(cfg_r)
    pr = mr.init(KEY, px, None, jnp.array([0.5, 1.5]))
    out_r = mr.apply(pr, px, None, jnp.array([0.5, 1.5]))
    assert out_r["logits"].shape == (2, 1)

    # multilabel
    cfg_m = tiny_videomae(num_labels=4,
                          problem_type="multi_label_classification")
    mm = VideoMAEForVideoClassification(cfg_m)
    lab = jnp.asarray([[1., 0., 1., 0.], [0., 1., 0., 0.]])
    pm = mm.init(KEY, px, None, lab)
    out_m = mm.apply(pm, px, None, lab)
    assert out_m["logits"].shape == (2, 4) and float(out_m["loss"]) > 0


def test_dinov2_classification():
    cfg = Dinov2Config(image_size=32, depth=16, patch_size=8, hidden_size=64,
                       num_hidden_layers=2, num_attention_heads=4,
                       mlp_ratio=2, dtype="float32", attn_impl="xla",
                       num_labels=2,
                       problem_type="single_label_classification")
    px = jax.random.normal(KEY, (2, 1, 32, 32, 16))
    m = Dinov2ForImageClassification(cfg)
    p = m.init(KEY, px)
    out = m.apply(p, px, labels=jnp.array([0, 1]))
    assert out["logits"].shape == (2, 2)
    assert float(out["loss"]) > 0


def test_dinov2_pos_embed_resize():
    from smb_vision_tpu.models.dinov2 import resize_position_embeddings_3d
    pos = jax.random.normal(KEY, (1, 2 * 2 * 2 + 1, 16))
    out = resize_position_embeddings_3d(pos, (2, 2, 2), (4, 4, 4))
    assert out.shape == (1, 65, 16)
    np.testing.assert_allclose(np.asarray(out[:, 0]), np.asarray(pos[:, 0]))


def test_videomae_quant8_embed_close_to_f32():
    """W8A8 projections (config.quant8): the embed path runs its QKV/MLP
    matmuls as int8 x int8 -> int32 dots. Param structure is unchanged (QuantDense
    mirrors nn.Dense), so the same checkpoint serves both paths; output
    drift stays within a few bf16-rounding units."""
    cfg = tiny_videomae()
    model = VideoMAEModel(cfg)
    px = jax.random.normal(KEY, (2, 16, 1, 32, 32))
    params = model.init(KEY, px)
    ref, _ = model.apply(params, px)

    qmodel = VideoMAEModel(tiny_videomae(quant8=True))
    out, _ = qmodel.apply(params, px)
    assert out.shape == ref.shape
    rel = float(jnp.abs(out - ref).max() / jnp.abs(ref).max())
    assert rel < 5e-2, rel
    # and it must not be trivially identical (the int8 path really ran)
    assert float(jnp.abs(out - ref).max()) > 0
