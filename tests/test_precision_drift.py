"""Production-precision trajectory drift.

Learning equivalence vs torch is proven on the f32/XLA path; production
trains in bf16. This hermetic check trains the same model from the same
init on identical batches in bf16 and in f32 (both through XLA on the
CPU) and bounds the per-step loss divergence — the tolerance a user
porting a reference recipe to the production precision can quote."""

import jax
import jax.numpy as jnp
import numpy as np
import optax

from smb_vision_tpu.models.configs import VideoMAEConfig
from smb_vision_tpu.train.mim import make_mim_workload

STEPS = 8
KW = dict(image_size=128, num_frames=64, patch_size=16, tubelet_size=16,
          num_channels=1, hidden_size=128, num_hidden_layers=1,
          num_attention_heads=2, intermediate_size=256,
          decoder_hidden_size=128, decoder_num_hidden_layers=1,
          decoder_num_attention_heads=2, decoder_intermediate_size=256)


def _run(dtype, px):
    cfg = VideoMAEConfig(dtype=dtype, attn_impl="xla", norm_pix_loss=True,
                         **KW)
    _, init_fn, step_fn, _ = make_mim_workload(
        cfg, mask_patch_size=16, mask_ratio=0.5, tx=optax.adamw(1e-3))
    state = init_fn(jax.random.PRNGKey(0))
    jstep = jax.jit(step_fn, donate_argnums=(0,))
    losses = []
    for s in range(STEPS):
        state, metrics = jstep(state, {"pixel_values": px[s % 2]},
                               jax.random.PRNGKey(s))
        losses.append(float(metrics["loss"]))
    return losses


def test_vjepa_preset_kernels_trajectory(rng):
    """The V-JEPA preset trains in bf16 (student, EMA teacher and
    predictor). Train the tiny V-JEPA from one init in bf16 and in f32;
    the loss trajectories must track. The bound is loose (2e-2): a
    2-head random-init teacher amplifies target rounding relative to a
    real model. This test exists to catch structural breakage (wrong
    targets, sign errors), not to certify the noise floor."""
    import optax

    from smb_vision_tpu.models.configs import VJEPA2Config
    from smb_vision_tpu.train.vjepa import make_vjepa_workload

    def run(dtype):
        cfg = VJEPA2Config(
            crop_size=64, frames_per_clip=128, patch_size=16,
            tubelet_size=16, in_chans=1, hidden_size=128,
            num_hidden_layers=2, num_attention_heads=2, mlp_ratio=2.0,
            pred_hidden_size=128, pred_num_hidden_layers=1,
            pred_num_attention_heads=2, pred_num_mask_tokens=16,
            dtype=dtype, attn_impl="xla")
        _, init_fn, step_fn, _ = make_vjepa_workload(
            cfg, tx=optax.adamw(1e-3))
        state = init_fn(jax.random.PRNGKey(0))
        js = jax.jit(step_fn, donate_argnums=(0,))
        px = [jnp.asarray(rng.normal(size=(2, 128, 1, 64, 64)),
                          jnp.float32) for _ in range(2)]
        losses = []
        for s in range(STEPS):
            state, m = js(state, {"pixel_values": px[s % 2]},
                          jax.random.PRNGKey(s))
            losses.append(float(m["loss"]))
        return losses

    ref = run("float32")
    preset = run("bfloat16")
    rel = max(abs(a - b) / max(abs(b), 1e-8)
              for a, b in zip(preset, ref))
    assert rel < 2e-2, (rel, ref, preset)
    assert ref[-1] < ref[1] and preset[-1] < preset[1], (ref, preset)


def test_bf16_pallas_trajectory_matches_f32_xla(rng):
    px = [jnp.asarray(rng.normal(size=(2, 64, 1, 128, 128)), jnp.float32)
          for _ in range(2)]
    ref = _run("float32", px)
    prod = _run("bfloat16", px)
    rel = max(abs(a - b) / max(abs(b), 1e-8) for a, b in zip(prod, ref))
    assert rel < 5e-4, (rel, ref, prod)
    # and the run actually optimizes on both paths
    assert ref[-1] < ref[0] and prod[-1] < prod[0], (ref, prod)
