"""Card-only checks: compiled cuDNN attention and the bf16 model forward
against their f32 references. They skip without a GPU; chip_smoke.py runs
the same comparisons at full width.

    SMB_VISION_TEST_GPU=1 python -m pytest -m gpu tests/
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smb_vision_tpu.ops.attention import (
    attention,
    attention_backend,
    xla_attention,
)


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 1024, 12, 64), (2, 1000, 12, 32),
                                   (1, 512, 16, 128)])
def test_cudnn_attention_matches_reference(gpu, shape):
    q, k, v, g = (jax.random.normal(kk, shape, jnp.bfloat16) for kk in
                  jax.random.split(jax.random.PRNGKey(0), 4))
    assert attention_backend(q, k) == "cudnn"
    f32 = lambda x: x.astype(jnp.float32)  # noqa: E731
    with jax.default_matmul_precision("highest"):
        ref, ref_vjp = jax.vjp(xla_attention, f32(q), f32(k), f32(v))
        ref_g = ref_vjp(f32(g))
    out, vjp = jax.vjp(attention, q, k, v)
    assert _rel(out, ref) < 2e-2
    for a, b in zip(vjp(g), ref_g):
        assert _rel(a, b) < 3e-2


@pytest.mark.gpu
def test_bf16_encoder_matches_f32(gpu):
    from smb_vision_tpu.models.configs import VideoMAEConfig
    from smb_vision_tpu.models.videomae import VideoMAEModel

    kw = dict(image_size=64, num_frames=64, patch_size=16, tubelet_size=16,
              num_channels=1, hidden_size=128, num_hidden_layers=2,
              num_attention_heads=2, intermediate_size=256)
    px = jax.random.normal(jax.random.PRNGKey(1), (2, 64, 1, 64, 64))
    m16 = VideoMAEModel(VideoMAEConfig(dtype="bfloat16", **kw))
    m32 = VideoMAEModel(VideoMAEConfig(dtype="float32", attn_impl="xla",
                                       **kw))
    params = m16.init(jax.random.PRNGKey(0), px)
    with jax.default_matmul_precision("highest"):
        ref, _ = m32.apply(params, px)
    out, _ = m16.apply(params, px)
    assert _rel(out.mean(1), ref.mean(1)) < 2e-2
