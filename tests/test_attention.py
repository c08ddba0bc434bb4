"""Attention: the resolver's choice of backend, the fused-attention wrapper's
plumbing, and the XLA reference and logsumexp path.

cuDNN cannot run here, so the wrapper tests pretend the platform is a GPU
and ask `jax.nn.dot_product_attention` for implementation="xla" in place of
"cudnn": the same call, layout and scale reach the library. The cuDNN
kernel itself is compared with the reference on the card (chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import smb_vision_tpu.ops.attention as attn_mod
from smb_vision_tpu.ops.attention import (
    attention,
    attention_backend,
    attention_with_lse,
    xla_attention,
)


def _qkv(key, b=2, n=192, h=3, d=48, nk=None, dtype=jnp.float32):
    kq, kk, kv = jax.random.split(key, 3)
    nk = n if nk is None else nk
    q = jax.random.normal(kq, (b, n, h, d), jnp.float32) * 0.4
    k = jax.random.normal(kk, (b, nk, h, d), jnp.float32) * 0.4
    v = jax.random.normal(kv, (b, nk, h, d), jnp.float32) * 0.4
    return [x.astype(dtype) for x in (q, k, v)]


@pytest.fixture
def fused_on_cpu(monkeypatch):
    """Route `attention` as on a GPU, with the library's XLA
    implementation standing in for cuDNN. Records each fused call."""
    calls = []
    real = jax.nn.dot_product_attention

    def spy(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(attn_mod, "_platform", lambda: "gpu")
    monkeypatch.setattr(attn_mod, "_FUSED_IMPLEMENTATION", "xla")
    monkeypatch.setattr(attn_mod.jax.nn, "dot_product_attention", spy)
    return calls


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-12))


def _ref(q, k, v, **kw):
    """f32 reference on the same (rounded) inputs."""
    f = lambda x: x.astype(jnp.float32)  # noqa: E731
    return xla_attention(f(q), f(k), f(v), **kw)


# ---------------------------------------------------------------------------
# resolver
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("platform", ["gpu", "cpu"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("head_dim", [32, 64, 128, 264, 36])
@pytest.mark.parametrize("with_bias", [False, True])
def test_resolver_choice(monkeypatch, platform, dtype, head_dim,
                         with_bias):
    """cuDNN exactly when the platform is a GPU, the inputs are bf16 or
    fp16, the head dim is a multiple of 8 and at most 256, and there is
    no bias; XLA otherwise."""
    monkeypatch.setattr(attn_mod, "_platform", lambda: platform)
    q = jnp.zeros((1, 4, 2, head_dim), dtype)
    bias = jnp.zeros((1, 1, 4, 4)) if with_bias else None
    want = ("cudnn" if platform == "gpu" and dtype != "float32"
            and head_dim in (32, 64, 128) and not with_bias else "xla")
    assert attention_backend(q, q, bias) == want


def test_resolver_mixed_dtypes_use_xla(monkeypatch):
    monkeypatch.setattr(attn_mod, "_platform", lambda: "gpu")
    q = jnp.zeros((1, 4, 2, 64), jnp.bfloat16)
    k = jnp.zeros((1, 4, 2, 64), jnp.float16)
    assert attention_backend(q, k) == "xla"


def test_resolver_reads_platform_by_default():
    q = jnp.zeros((1, 4, 2, 64), jnp.bfloat16)
    assert attention_backend(q, q) == "xla"     # the CPU test backend


# ---------------------------------------------------------------------------
# the fused wrapper's plumbing (XLA standing in for cuDNN)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["default_scale", "custom_scale", "cross",
                                  "ragged", "d32", "fp16"])
def test_fused_wrapper_matches_reference(fused_on_cpu, case):
    kw, shape = {}, dict(b=2, n=64, h=4, d=64)
    dtype = jnp.bfloat16
    if case == "custom_scale":
        kw["scale"] = 0.3
    elif case == "cross":
        shape["nk"] = 40                     # Nq != Nk
    elif case == "ragged":
        shape.update(n=37, nk=53)
    elif case == "d32":
        shape["d"] = 32
    elif case == "fp16":
        dtype = jnp.float16
    q, k, v = _qkv(jax.random.PRNGKey(0), dtype=dtype, **shape)
    out = attention(q, k, v, **kw)
    assert len(fused_on_cpu) == 1
    assert fused_on_cpu[0]["implementation"] == "xla"
    assert out.shape == q.shape and out.dtype == dtype
    assert _rel(out, _ref(q, k, v, **kw)) < 2e-2


def test_fused_wrapper_passes_scale(fused_on_cpu):
    q, k, v = _qkv(jax.random.PRNGKey(1), n=16, h=2, d=32,
                   dtype=jnp.bfloat16)
    attention(q, k, v)
    attention(q, k, v, scale=0.5)
    assert fused_on_cpu[0]["scale"] == pytest.approx(1 / np.sqrt(32))
    assert fused_on_cpu[1]["scale"] == 0.5


def test_fused_wrapper_grads_match_reference(fused_on_cpu):
    q, k, v = _qkv(jax.random.PRNGKey(2), n=48, h=2, d=64,
                   dtype=jnp.bfloat16)

    def loss(fn):
        return lambda q, k, v: jnp.sum(fn(q, k, v).astype(jnp.float32) ** 2)

    g = jax.grad(loss(attention), argnums=(0, 1, 2))(q, k, v)
    f = lambda x: x.astype(jnp.float32)  # noqa: E731
    g_ref = jax.grad(loss(xla_attention), argnums=(0, 1, 2))(f(q), f(k),
                                                             f(v))
    assert fused_on_cpu
    for a, b in zip(g, g_ref):
        assert _rel(a, b) < 3e-2


def test_fused_wrapper_skips_bias_and_f32(fused_on_cpu):
    q, k, v = _qkv(jax.random.PRNGKey(3), n=16, h=2, d=32)
    attention(q, k, v)                               # f32 -> XLA
    qb, kb, vb = (x.astype(jnp.bfloat16) for x in (q, k, v))
    attention(qb, kb, vb, bias=jnp.zeros((1, 1, 16, 16)))
    attention(qb, kb, vb, impl="xla")
    assert fused_on_cpu == []


def test_fused_error_surfaces(monkeypatch):
    """A failure of the fused kernel on a shape the resolver sent there
    propagates; it is not caught and re-routed to XLA."""
    def boom(*a, **kw):
        raise RuntimeError("cuDNN refused")

    monkeypatch.setattr(attn_mod, "_platform", lambda: "gpu")
    monkeypatch.setattr(attn_mod.jax.nn, "dot_product_attention", boom)
    q = jnp.zeros((1, 8, 2, 64), jnp.bfloat16)
    with pytest.raises(RuntimeError, match="cuDNN refused"):
        attention(q, q, q)


def test_model_attention_routes_through_fused_wrapper(fused_on_cpu):
    """A bf16 ViT block on a GPU sends every self-attention call to the
    fused kernel."""
    from smb_vision_tpu.models.layers import Block

    blk = Block(64, 4, 128, dtype=jnp.bfloat16)
    x = jnp.ones((2, 16, 64), jnp.bfloat16)
    params = blk.init(jax.random.PRNGKey(0), x)
    n_init = len(fused_on_cpu)
    blk.apply(params, x)
    assert n_init == 1 and len(fused_on_cpu) == 2


# ---------------------------------------------------------------------------
# the XLA reference and the lse path
# ---------------------------------------------------------------------------

def test_forward_matches_xla():
    """auto on the CPU is the reference itself."""
    q, k, v = _qkv(jax.random.PRNGKey(0))
    np.testing.assert_array_equal(np.asarray(attention(q, k, v)),
                                  np.asarray(xla_attention(q, k, v)))


def test_forward_unaligned_seq():
    """Ragged N through the reference: equals an explicit softmax."""
    q, k, v = _qkv(jax.random.PRNGKey(1), n=100)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    ref = jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, -1), v)
    np.testing.assert_allclose(np.asarray(attention(q, k, v, impl="xla")),
                               np.asarray(ref), atol=2e-5, rtol=2e-5)


def test_grads_match_xla():
    """Grads of the auto path equal the reference's (same code on CPU)."""
    q, k, v = _qkv(jax.random.PRNGKey(2), n=128)

    def loss(fn):
        return lambda q, k, v: jnp.sum(fn(q, k, v) ** 2)

    g_ref = jax.grad(loss(xla_attention), argnums=(0, 1, 2))(q, k, v)
    g = jax.grad(loss(attention), argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(g_ref, g):
        np.testing.assert_allclose(np.asarray(b), np.asarray(a),
                                   atol=5e-6, rtol=5e-6)


def test_bias_routes_to_xla():
    q, k, v = _qkv(jax.random.PRNGKey(3), n=64)
    bias = jnp.where(
        jax.random.bernoulli(jax.random.PRNGKey(4), 0.5, (1, 1, 64, 64)),
        0.0, -1e30)
    out = attention(q, k, v, bias=bias, impl="auto")
    np.testing.assert_allclose(np.asarray(out),
                               np.asarray(xla_attention(q, k, v, bias=bias)),
                               atol=1e-6)


def test_softmax_rows_sum_to_one_property():
    # attention of constant v must return v
    q, k, _ = _qkv(jax.random.PRNGKey(5), n=96)
    v = jnp.ones_like(q)
    np.testing.assert_allclose(np.asarray(attention(q, k, v)), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("impl", ["pallas", "pallas_int8", "cudnn", "flash"])
def test_unknown_impl_raises(impl):
    """Removed kernel names and typos error instead of silently running a
    different path."""
    q = jnp.zeros((1, 8, 1, 8))
    with pytest.raises(ValueError, match="unknown attention impl"):
        attention(q, q, q, impl=impl)


def test_attention_with_lse_matches_attention():
    q, k, v = _qkv(jax.random.PRNGKey(6))
    out, lse = attention_with_lse(q, k, v)
    np.testing.assert_allclose(np.asarray(out),
                               np.asarray(xla_attention(q, k, v)),
                               atol=2e-6, rtol=2e-6)
    s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
    lse2 = jax.nn.logsumexp(s, axis=-1) * attn_mod.LOG2E
    np.testing.assert_allclose(np.asarray(lse), np.asarray(lse2),
                               atol=1e-5, rtol=1e-5)


def test_attention_with_lse_partials_merge_to_dense():
    """(out, lse2) over disjoint kv blocks must merge exactly to the dense
    softmax — the invariant ring attention is built on."""
    q, k, v = _qkv(jax.random.PRNGKey(3))
    o1, l1 = attention_with_lse(q, k[:, :96], v[:, :96])
    o2, l2 = attention_with_lse(q, k[:, 96:], v[:, 96:])
    m = jnp.maximum(l1, l2)
    w1, w2 = jnp.exp2(l1 - m), jnp.exp2(l2 - m)
    den = w1 + w2
    bw = lambda w: jnp.swapaxes((w / den)[..., None], 1, 2)  # noqa: E731
    merged = o1.astype(jnp.float32) * bw(w1) + o2.astype(jnp.float32) * bw(w2)
    ref = xla_attention(q, k, v)
    np.testing.assert_allclose(np.asarray(merged), np.asarray(ref),
                               atol=2e-6, rtol=2e-6)


def test_attention_with_lse_grads_through_both_outputs():
    """A loss touching BOTH outputs differentiates through the lse: its
    grads match those of an explicit logsumexp formulation."""
    q, k, v = _qkv(jax.random.PRNGKey(4))

    def explicit(q, k, v):
        s = jnp.einsum("bqhd,bkhd->bhqk", q, k) / np.sqrt(q.shape[-1])
        out = jnp.einsum("bhqk,bkhd->bqhd", jax.nn.softmax(s, -1), v)
        return out, jax.nn.logsumexp(s, axis=-1) * attn_mod.LOG2E

    def loss(fn):
        def f(q, k, v):
            out, lse = fn(q, k, v)
            # weight the lse term so its cotangent is non-trivial
            return (jnp.sum(out.astype(jnp.float32) ** 2)
                    + jnp.sum(jnp.sin(lse) * lse))
        return f

    g = jax.grad(loss(attention_with_lse), argnums=(0, 1, 2))(q, k, v)
    g_ref = jax.grad(loss(explicit), argnums=(0, 1, 2))(q, k, v)
    for a, b in zip(g, g_ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=2e-5,
                                   rtol=2e-5)
