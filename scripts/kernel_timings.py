"""Time the attention and MLP paths on one GPU at the model's real widths.

Attention, bf16, at the shapes chip_smoke.py checks: cuDNN fused attention
(`jax.nn.dot_product_attention(implementation="cudnn")`), the plain
`xla_attention` that XLA compiles (f32 scores in device memory), and JAX's
library Pallas kernel `jax.experimental.pallas.ops.gpu.attention.mha`
(Triton route). Forward, and forward + backward (vjp with a random
cotangent). A variant that runs out of device memory is recorded as such.

MLP chain, bf16: LN -> fc1 -> erf-GELU -> fc2 -> residual
(ops/mlp.py::mlp_block_xla) at (81920 x 768 -> 3072) and
(18432 x 1024 -> 4096), beside a plain bf16 matmul of the same FLOPs.

Each time is the median of 10 warm calls, each ending in
block_until_ready. The card's name and power limit (nvidia-smi) head the
output; results also go to chiprun_out/kernel_timings.json.

    python scripts/kernel_timings.py
"""

from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

N_TIMED = 10
ATTN_SHAPES = [(1, 20480, 12, 64), (2, 7168, 12, 64), (1, 20480, 6, 64),
               (2, 9216, 16, 64), (2, 9216, 12, 32)]
MLP_SHAPES = [(81920, 768, 3072), (18432, 1024, 4096)]


def timed(fn, *args) -> float:
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(N_TIMED):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def attention_flops(b, n, h, d, bwd: bool) -> float:
    """4 N^2 D per head forward (QK^T and PV); backward 2.5x forward."""
    f = 4.0 * b * h * n * n * d
    return f * 3.5 if bwd else f


def main():
    from smb_vision_tpu.utils.device import nvidia_smi_name_power

    card = nvidia_smi_name_power()
    from smb_vision_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    import jax
    import jax.numpy as jnp
    from jax.experimental.pallas.ops.gpu import attention as pallas_gpu

    from smb_vision_tpu.ops.attention import xla_attention
    from smb_vision_tpu.ops.mlp import mlp_block_xla
    from smb_vision_tpu.utils.device import require_gpu

    dev = require_gpu()
    print(f"card: {card}; jax {jax.__version__}; {dev.device_kind}",
          flush=True)
    rows = []

    def cudnn(q, k, v):
        return jax.nn.dot_product_attention(q, k, v, implementation="cudnn")

    def mha(q, k, v):
        return pallas_gpu.mha(q, k, v, None,
                              sm_scale=1.0 / q.shape[-1] ** 0.5)

    impls = {"cudnn": cudnn, "xla": xla_attention, "pallas_mha": mha}
    for shape in ATTN_SHAPES:
        keys = jax.random.split(jax.random.PRNGKey(0), 4)
        q, k, v, g = (jax.random.normal(kk, shape, jnp.bfloat16)
                      for kk in keys)
        for name, fn in impls.items():
            for bwd in (False, True):
                if bwd:
                    run = jax.jit(lambda q, k, v, g, fn=fn:
                                  jax.vjp(fn, q, k, v)[1](g))
                    args = (q, k, v, g)
                else:
                    run, args = jax.jit(fn), (q, k, v)
                row = {"kind": "attention", "shape": list(shape),
                       "impl": name, "pass": "fwd+bwd" if bwd else "fwd"}
                try:
                    t = timed(run, *args)
                    row.update(ms=t * 1e3, tflops=attention_flops(
                        *shape, bwd) / t / 1e12)
                except Exception as e:  # noqa: BLE001 — recorded per row
                    msg = str(e).splitlines()[0][:160]
                    row["error"] = ("out of memory" if "RESOURCE_EXHAUSTED"
                                    in str(e) else msg)
                rows.append(row)
                print(json.dumps(row), flush=True)
                del run

    for m, kdim, f in MLP_SHAPES:
        keys = jax.random.split(jax.random.PRNGKey(1), 6)
        x = jax.random.normal(keys[0], (m, kdim), jnp.bfloat16)
        lnw = jnp.ones((kdim,), jnp.float32)
        lnb = jnp.zeros((kdim,), jnp.float32)
        w1 = jax.random.normal(keys[1], (kdim, f), jnp.float32) * 0.02
        b1 = jnp.zeros((f,), jnp.float32)
        w2 = jax.random.normal(keys[2], (f, kdim), jnp.float32) * 0.02
        b2 = jnp.zeros((kdim,), jnp.float32)
        flops = 4.0 * m * kdim * f
        t = timed(jax.jit(mlp_block_xla), x, lnw, lnb, w1, b1, w2, b2)
        row = {"kind": "mlp_chain", "shape": [m, kdim, f], "ms": t * 1e3,
               "tflops": flops / t / 1e12}
        rows.append(row)
        print(json.dumps(row), flush=True)
        wm = jax.random.normal(keys[3], (kdim, 2 * f), jnp.bfloat16)
        t = timed(jax.jit(lambda a, b: a @ b), x, wm)
        row = {"kind": "matmul_same_flops", "shape": [m, kdim, 2 * f],
               "ms": t * 1e3, "tflops": flops / t / 1e12}
        rows.append(row)
        print(json.dumps(row), flush=True)

    out = REPO / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "kernel_timings.json").write_text(json.dumps(
        {"card": card, "device_kind": dev.device_kind, "rows": rows},
        indent=1))


if __name__ == "__main__":
    main()
