"""Embedding throughput at the reference architecture on one GPU.

ViT-Base (12 heads x d64, the config of standardmodelbio/smb-vision-base)
encodes 512x512x320 volumes (20,480 tokens) in bf16 at batch 4 through the
default path (cuDNN fused attention, XLA/cuBLAS elsewhere). Weights are
random from a fixed seed. After a warm-up call, ten calls are timed, each
ending in block_until_ready; the median gives volumes/s.

Prints ONE json line with the value and the device it ran on:
platform, device_kind, device count and the card's power limit. Exits
non-zero without a line when JAX finds no GPU.

    python bench.py
"""

from __future__ import annotations

import json
import statistics
import time

BATCH = 4
N_TIMED = 10


def main():
    from smb_vision_tpu.utils.device import nvidia_smi_name_power

    card = nvidia_smi_name_power()          # before JAX touches the card

    from smb_vision_tpu.utils.compile_cache import setup_compile_cache

    setup_compile_cache()
    import jax
    import jax.numpy as jnp

    from smb_vision_tpu.models.configs import VideoMAEConfig
    from smb_vision_tpu.models.videomae import VideoMAEModel
    from smb_vision_tpu.utils.device import require_gpu

    dev = require_gpu()
    config = VideoMAEConfig(image_size=512, num_frames=320, patch_size=16,
                            tubelet_size=16, num_channels=1,
                            dtype="bfloat16")
    model = VideoMAEModel(config)
    key = jax.random.PRNGKey(0)
    px = jax.random.normal(key, (BATCH, 320, 1, 512, 512), jnp.bfloat16)
    params = jax.jit(model.init)(key, px)

    @jax.jit
    def encode(params, px):
        return model.apply(params, px)[0]

    jax.block_until_ready(encode(params, px))
    times = []
    for _ in range(N_TIMED):
        t0 = time.perf_counter()
        jax.block_until_ready(encode(params, px))
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    print(json.dumps({
        "metric": "volumes/s (512x512x320 ViT-Base d64 embed, bf16, bs4)",
        "value": BATCH / med,
        "unit": "volumes/s",
        "median_call_s": med,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": jax.device_count(),
        "nvidia_smi": card,
    }))


if __name__ == "__main__":
    main()
