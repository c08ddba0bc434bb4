"""Transformer MLP: the Mlp/Block modules against the plain references in
ops/mlp.py (the chain the GPU runs through cuBLAS and XLA fusions), their
param trees, and their gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smb_vision_tpu.ops.mlp import mlp_block_xla, mlp_xla


def _mk(seed, shape, dtype=jnp.float32, s=0.5):
    x = jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32)
    return (x * s).astype(dtype)


def _mlp_params(params):
    p = params["params"]
    return (p["fc1"]["kernel"], p["fc1"]["bias"], p["fc2"]["kernel"],
            p["fc2"]["bias"])


def test_module_param_structure_unchanged():
    """Mlp keeps nn.Dense's param tree (fc1/fc2 kernel+bias) so existing
    and HF checkpoints load unchanged, and computes dense -> gelu ->
    dense."""
    from smb_vision_tpu.models.layers import ACT2FN, Mlp

    x = _mk(7, (2, 64, 128), jnp.float32)
    m = Mlp(128, 512, dtype=jnp.float32)
    params = m.init(jax.random.PRNGKey(0), x)
    p = params["params"]
    assert set(p.keys()) == {"fc1", "fc2"}
    assert p["fc1"]["kernel"].shape == (128, 512)
    assert p["fc1"]["bias"].shape == (512,)
    assert p["fc2"]["kernel"].shape == (512, 128)
    ref = (ACT2FN["gelu"](x @ p["fc1"]["kernel"] + p["fc1"]["bias"])
           @ p["fc2"]["kernel"] + p["fc2"]["bias"])
    assert jnp.allclose(m.apply(params, x), ref, atol=1e-5)


@pytest.mark.parametrize("act", ["gelu", "gelu_new"])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_module_matches_reference(act, dtype):
    """Mlp in f32 and bf16 is bit-identical to ops.mlp.mlp_xla."""
    from smb_vision_tpu.models.layers import Mlp

    x = _mk(1, (2, 48, 64), dtype)
    m = Mlp(64, 256, act=act, dtype=dtype)
    params = m.init(jax.random.PRNGKey(0), x)
    y = m.apply(params, x)
    ref = mlp_xla(x, *_mlp_params(params), act=act)
    assert y.dtype == dtype
    np.testing.assert_array_equal(np.asarray(y, np.float32),
                                  np.asarray(ref, np.float32))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_block_mlp_half_matches_reference(dtype):
    """Block's second half (LN2 -> Mlp -> residual) equals mlp_block_xla
    when the attention half contributes nothing (zero attention output
    projection)."""
    from smb_vision_tpu.models.layers import Block

    x = _mk(11, (2, 32, 64), dtype)
    blk = Block(64, 2, 256, dtype=dtype, attn_impl="xla")
    params = blk.init(jax.random.PRNGKey(0), x)
    p = jax.tree_util.tree_map(lambda a: a, params)
    att = p["params"]["attention"]["proj"]
    att["kernel"] = jnp.zeros_like(att["kernel"])
    att["bias"] = jnp.zeros_like(att["bias"])
    y = blk.apply(p, x)
    n2 = p["params"]["norm2"]
    ref = mlp_block_xla(x, n2["scale"], n2["bias"],
                        *_mlp_params({"params": p["params"]["mlp"]}),
                        eps=1e-6)
    tol = 0 if dtype == jnp.float32 else 2e-2
    scale = float(jnp.abs(ref.astype(jnp.float32)).max())
    err = float(jnp.abs(y.astype(jnp.float32)
                        - ref.astype(jnp.float32)).max())
    assert err <= tol * scale + 1e-6, err


def test_module_grads_match_reference():
    from smb_vision_tpu.models.layers import Mlp

    x = _mk(3, (2, 16, 32), jnp.float32)
    m = Mlp(32, 64, dtype=jnp.float32)
    params = m.init(jax.random.PRNGKey(0), x)

    g = jax.grad(lambda p: jnp.sum(m.apply(p, x) ** 2))(params)
    g_ref = jax.grad(lambda w: jnp.sum(mlp_xla(x, *w) ** 2))(
        _mlp_params(params))
    for a, b in zip(_mlp_params(g), g_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-5, rtol=1e-5)


def test_unknown_act_rejected():
    x = _mk(4, (2, 8))
    with pytest.raises(KeyError, match="swish"):
        mlp_xla(x, _mk(5, (8, 16)), None, _mk(6, (16, 8)), None, act="swish")


def test_mlp_block_reference_is_layernorm_then_mlp():
    x = _mk(5, (4, 32), jnp.float32)
    lnw, lnb = _mk(6, (32,)), _mk(7, (32,))
    w1, b1, w2, b2 = _mk(8, (32, 64)), _mk(9, (64,)), _mk(10, (64, 32)), \
        _mk(11, (32,))
    mu = x.mean(-1, keepdims=True)
    xn = (x - mu) / jnp.sqrt(x.var(-1, keepdims=True) + 1e-6) * lnw + lnb
    ref = x + jax.nn.gelu(xn @ w1 + b1, approximate=False) @ w2 + b2
    np.testing.assert_allclose(
        np.asarray(mlp_block_xla(x, lnw, lnb, w1, b1, w2, b2)),
        np.asarray(ref), atol=1e-5, rtol=1e-5)
