# smb-vision-tpu container for NVIDIA GPUs (role of the reference's CUDA
# Dockerfile:1-48): JAX with its CUDA 12 plugin (cuDNN, cuBLAS, NCCL
# wheels) instead of torch+flash-attn wheels.
FROM nvidia/cuda:12.8.1-cudnn-runtime-ubuntu24.04

RUN apt-get update && apt-get install -y --no-install-recommends \
        python3 python3-pip python3-venv g++ make zlib1g-dev git \
    && rm -rf /var/lib/apt/lists/*
RUN python3 -m venv /opt/venv
ENV PATH=/opt/venv/bin:$PATH

WORKDIR /app
COPY pyproject.toml README.md ./
COPY smb_vision_tpu ./smb_vision_tpu
COPY csrc ./csrc
COPY scripts ./scripts
COPY configs ./configs
COPY chip_smoke.py bench.py ./

RUN pip install --no-cache-dir "jax[cuda12]" \
    && pip install --no-cache-dir -e ".[data]"

# native CT loader
RUN python scripts/build_native.py

ENTRYPOINT ["python", "-m"]
CMD ["smb_vision_tpu.cli.run_mim", "--help"]
