"""What a measurement reports about the card it ran on."""

from __future__ import annotations

import subprocess


def nvidia_smi_name_power() -> str:
    """`name, power.limit` of the first GPU as nvidia-smi prints them
    (e.g. "NVIDIA H100 80GB HBM3, 700.00 W"). Raises if nvidia-smi is
    missing or fails: a measurement without its card is not reported."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=30).stdout
    return out.strip().splitlines()[0].strip()


def require_gpu():
    """The first JAX device, or SystemExit when it is not a GPU."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {dev.platform} devices; this "
                         "measurement runs on the card only")
    return dev
