"""smb-vision-tpu: a JAX 3D medical-imaging framework.

A from-scratch JAX/XLA rebuild of the capability surface of
``standardmodelbio/smb-vision`` (masked-image-modeling pretraining, V-JEPA2
pretraining, classification / survival fine-tuning, and batch embedding
generation for CT volumes), run on NVIDIA GPUs:

- compute path: jit-compiled functional models (smb_vision_tpu.nn) with
  cuDNN fused attention, static shapes, on-device mask generation
- scale-out: ``jax.sharding.Mesh`` + GSPMD (data / fsdp / tensor parallel)
- IO: host-side NIfTI decode feeding a double-buffered device pipeline
"""

__version__ = "0.1.0"

from smb_vision_tpu.models.configs import (  # noqa: F401
    Dinov2Config,
    SiglipVisionConfig,
    VideoMAEConfig,
    VJEPA2Config,
)
