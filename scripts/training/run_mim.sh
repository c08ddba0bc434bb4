#!/usr/bin/env bash
# Canonical MIM pretraining recipe (parity with reference
# scripts/training/run_mim.sh:13-38: lr 5e-5 cosine, wd 0.01, warmup 0.01,
# bf16, grad checkpointing, masked 512^2x320 @ patch 16 / mask_patch 32).
# The launcher is just python — no accelerate/deepspeed process
# spawning; multi-GPU parallelism is --sharding_policy over the mesh.
set -euo pipefail

DATA_JSON=${1:?usage: run_mim.sh <data.json> [output_dir]}
OUTPUT_DIR=${2:-output/mim}

python -m smb_vision_tpu.cli.run_mim \
    --json_path "$DATA_JSON" \
    --output_dir "$OUTPUT_DIR" \
    --image_size 512 --depth 320 --patch_size 16 \
    --mask_patch_size 32 --mask_ratio 0.65 \
    --hidden_size 768 --num_hidden_layers 12 --num_attention_heads 12 \
    --intermediate_size 3072 \
    --dtype bfloat16 --gradient_checkpointing true \
    --per_device_train_batch_size 1 \
    --learning_rate 5e-5 --lr_scheduler_type cosine \
    --weight_decay 0.01 --warmup_ratio 0.01 \
    --num_train_epochs 100 \
    --logging_steps 10 --save_steps 500 --save_total_limit 3 \
    --sharding_policy fsdp \
    --cache_data_dir "$OUTPUT_DIR/data_cache" \
    "${@:3}"
