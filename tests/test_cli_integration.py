"""End-to-end CLI integration on the CPU mesh: tiny MIM pretrain ->
checkpoint -> resume -> embedding inference, exercising the full stack
(dummy NIfTI generation, preprocessing cache, training loop, step
checkpointing, safetensors export, backbone grafting, npy output)."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from smb_vision_tpu.data.nifti import save_nifti

ARGS_MODEL = ["--image_size", "32", "--depth", "32", "--patch_size", "16",
              "--hidden_size", "32", "--num_hidden_layers", "1",
              "--num_attention_heads", "2", "--intermediate_size", "64",
              "--dtype", "float32", "--attn_impl", "xla"]


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli_data")
    rng = np.random.default_rng(0)
    rows = []
    for i in range(12):
        vol = rng.normal(0, 300, (32, 32, 32)).astype(np.int16)
        p = root / f"case_{i}.nii.gz"
        save_nifti(p, vol, np.diag([1.5, 1.5, 3.0, 1.0]))
        rows.append({"image": str(p), "label": i % 2, "os": float(i + 1),
                     "os_event": i % 2, "age": 50.0 + i, "sex": i % 2})
    data = {"train": rows[:10], "validation": rows[10:]}
    path = root / "ds.json"
    path.write_text(json.dumps(data))
    return root, str(path)


def test_mim_train_resume_and_inference(dataset, tmp_path):
    from smb_vision_tpu.cli.run_inference import main as run_inference
    from smb_vision_tpu.cli.run_mim import main as run_mim

    root, ds_json = dataset
    out = tmp_path / "mim"
    common = [
        "--json_path", ds_json, "--output_dir", str(out), *ARGS_MODEL,
        "--mask_patch_size", "16", "--mask_ratio", "0.5",
        "--per_device_train_batch_size", "1",
        "--logging_steps", "1", "--save_steps", "2",
        "--cache_data_dir", str(tmp_path / "cache"),
    ]
    run_mim(common + ["--num_train_steps", "2"])
    assert (out / "model.safetensors").exists()
    assert (out / "config.json").exists()
    ckpts = list((out / "checkpoints").iterdir())
    assert ckpts, "no checkpoints saved"

    # resume: continues from step 2 to 3
    run_mim(common + ["--num_train_steps", "3"])
    metrics = [json.loads(line)
               for line in (out / "metrics.jsonl").read_text().splitlines()]
    steps = [m["step"] for m in metrics if "step" in m]
    assert 3 in steps and steps.count(1) == 1, steps

    # --overwrite_output_dir: the existing step-3 checkpoint is ignored
    # and training restarts from scratch (step 1 logged a second time)
    run_mim(common + ["--num_train_steps", "1", "--overwrite_output_dir"])
    metrics = [json.loads(line)
               for line in (out / "metrics.jsonl").read_text().splitlines()]
    steps = [m["step"] for m in metrics if "step" in m]
    assert steps.count(1) == 2, steps

    emb_out = tmp_path / "emb"
    run_inference([
        "--data_dir", str(root), "--output_dir", str(emb_out),
        "--model_name_or_path", str(out / "model.safetensors"),
        "--config_path", str(out / "config.json"),
        "--dtype", "float32", "--attn_impl", "xla",
        "--batch_size", "2", "--max_samples", "3",
    ])
    npys = list(emb_out.glob("*.npy"))
    assert len(npys) == 3
    emb = np.load(npys[0])
    assert emb.shape == (8, 32)  # 2*2*2 tokens, hidden 32
    assert (emb_out / "metadata.json").exists()

    # --quant8 W8A8 path + bf16 input shipping: same checkpoint,
    # embeddings close
    emb_q = tmp_path / "emb_q"
    run_inference([
        "--data_dir", str(root), "--output_dir", str(emb_q),
        "--model_name_or_path", str(out / "model.safetensors"),
        "--config_path", str(out / "config.json"),
        "--dtype", "float32", "--attn_impl", "xla", "--quant8",
        "--input_dtype", "bfloat16",
        "--batch_size", "2", "--max_samples", "3",
    ])
    q = np.load(emb_q / npys[0].name)
    assert np.abs(q - emb).max() / max(np.abs(emb).max(), 1e-6) < 0.05


def test_mim_pipeline_parallel_training(dataset, tmp_path):
    """--pipeline_stages 2: MIM pretraining with both stacks GPipe-
    pipelined over the mesh model axis — trains, evals, and exports a
    DENSE-layout checkpoint that run_inference loads unchanged."""
    from smb_vision_tpu.cli.run_inference import main as run_inference
    from smb_vision_tpu.cli.run_mim import main as run_mim

    root, ds_json = dataset
    out = tmp_path / "mim_pipe"
    run_mim([
        "--json_path", ds_json, "--output_dir", str(out), *ARGS_MODEL,
        "--num_hidden_layers", "2",
        "--config_overrides",
        "decoder_num_hidden_layers=2,decoder_hidden_size=32,"
        "decoder_intermediate_size=64,decoder_num_attention_heads=2",
        "--mask_patch_size", "16", "--mask_ratio", "0.5",
        "--per_device_train_batch_size", "2", "--pipeline_stages", "2",
        "--logging_steps", "1", "--save_steps", "10", "--do_eval",
        "--cache_data_dir", str(tmp_path / "cache"),
        "--num_train_steps", "2",
    ])
    metrics = [json.loads(line)
               for line in (out / "metrics.jsonl").read_text().splitlines()]
    losses = [m["loss"] for m in metrics if "step" in m]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert any("eval_loss" in m for m in metrics), metrics

    # the exported checkpoint is dense HF layout: per-layer keys, loadable
    # by the non-pipelined encoder
    from safetensors.numpy import safe_open

    with safe_open(out / "model.safetensors", framework="np") as f:
        keys = list(f.keys())
    assert any("encoder.layer_1." in k for k in keys), keys[:10]
    assert not any("stacked" in k for k in keys)

    emb_out = tmp_path / "emb_pipe"
    run_inference([
        "--data_dir", str(root), "--output_dir", str(emb_out),
        "--model_name_or_path", str(out / "model.safetensors"),
        "--config_path", str(out / "config.json"),
        "--dtype", "float32", "--attn_impl", "xla",
        "--batch_size", "2", "--max_samples", "2",
    ])
    assert len(list(emb_out.glob("*.npy"))) == 2

    # resume: the checkpoint restores the STACKED state and the trainer re-applies
    # the pipeline shardings (checkpoint saved at step 2, continue to 3)
    run_mim([
        "--json_path", ds_json, "--output_dir", str(out), *ARGS_MODEL,
        "--num_hidden_layers", "2",
        "--config_overrides",
        "decoder_num_hidden_layers=2,decoder_hidden_size=32,"
        "decoder_intermediate_size=64,decoder_num_attention_heads=2",
        "--mask_patch_size", "16", "--mask_ratio", "0.5",
        "--per_device_train_batch_size", "2", "--pipeline_stages", "2",
        "--logging_steps", "1", "--save_steps", "10",
        "--cache_data_dir", str(tmp_path / "cache"),
        "--num_train_steps", "3",
    ])
    metrics = [json.loads(line)
               for line in (out / "metrics.jsonl").read_text().splitlines()]
    steps = [m["step"] for m in metrics if "step" in m]
    assert 3 in steps and steps.count(1) == 1, steps


def test_classification_cli_metrics(dataset, tmp_path):
    from smb_vision_tpu.cli.run_classification import main as run_cls

    _, ds_json = dataset
    out = tmp_path / "cls"
    run_cls([
        "--train_data_path", ds_json, "--val_data_path", ds_json,
        "--output_dir", str(out), "--task_type", "classification",
        "--num_labels", "2", "--additional_feature_columns", "age", "sex",
        *ARGS_MODEL,
        "--per_device_train_batch_size", "1", "--num_train_steps", "1",
        "--logging_steps", "1", "--save_steps", "10",
        "--vision_lr", "1e-4", "--merger_lr", "1e-3",
        "--do_eval", "true",
        "--cache_data_dir", str(tmp_path / "cache"),
    ])
    metrics = [json.loads(line)
               for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert any("eval_accuracy" in m for m in metrics)


def test_vjepa_cli_smoke(dataset, tmp_path):
    from smb_vision_tpu.cli.run_vjepa import main as run_vjepa

    _, ds_json = dataset
    out = tmp_path / "vjepa"
    run_vjepa([
        "--data_path", ds_json, "--output_dir", str(out),
        "--image_size", "32", "--depth", "32", "--patch_size", "16",
        "--hidden_size", "32", "--num_hidden_layers", "1",
        "--num_attention_heads", "2",
        "--pred_hidden_size", "16", "--pred_num_hidden_layers", "1",
        "--pred_num_attention_heads", "2",
        "--dtype", "float32", "--attn_impl", "xla",
        "--per_device_train_batch_size", "1", "--num_train_steps", "2",
        "--logging_steps", "1", "--save_steps", "10",
        "--cache_data_dir", str(tmp_path / "cache"),
    ])
    assert (out / "model.safetensors").exists()
    metrics = [json.loads(line)
               for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert all(np.isfinite(m["loss"]) for m in metrics if "loss" in m)


def test_vjepa_pipeline_parallel_training(dataset, tmp_path):
    """run_vjepa --pipeline_stages 2: student/teacher/predictor stacks
    pipelined; dense-layout export."""
    from smb_vision_tpu.cli.run_vjepa import main as run_vjepa

    _, ds_json = dataset
    out = tmp_path / "vjepa_pipe"
    run_vjepa([
        "--data_path", ds_json, "--output_dir", str(out),
        "--image_size", "32", "--depth", "32", "--patch_size", "16",
        "--hidden_size", "32", "--num_hidden_layers", "2",
        "--num_attention_heads", "2",
        "--pred_hidden_size", "16", "--pred_num_hidden_layers", "2",
        "--pred_num_attention_heads", "2",
        "--dtype", "float32", "--attn_impl", "xla",
        "--per_device_train_batch_size", "2", "--pipeline_stages", "2",
        "--num_train_steps", "2", "--logging_steps", "1",
        "--save_steps", "10", "--do_eval",
        "--cache_data_dir", str(tmp_path / "cache"),
    ])
    metrics = [json.loads(line)
               for line in (out / "metrics.jsonl").read_text().splitlines()]
    losses = [m["loss"] for m in metrics if "step" in m]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert any("eval_loss" in m for m in metrics), metrics

    from safetensors.numpy import safe_open

    with safe_open(out / "model.safetensors", framework="np") as f:
        keys = list(f.keys())
    assert any("encoder.encoder.layer_1." in k for k in keys), keys[:10]
    assert not any("stacked" in k for k in keys)


def test_vjepa_cli_device_cache(dataset, tmp_path):
    """--device_cache wiring from the CLI: volumes pin in device memory,
    two epochs run, losses finite (trainer-level pinning behavior is
    covered in test_train/test_data; this asserts the CLI plumbs the
    flag and input_dtype through)."""
    from smb_vision_tpu.cli.run_vjepa import main as run_vjepa

    _, ds_json = dataset
    out = tmp_path / "vjepa_dc"
    run_vjepa([
        "--data_path", ds_json, "--output_dir", str(out),
        "--image_size", "32", "--depth", "32", "--patch_size", "16",
        "--hidden_size", "32", "--num_hidden_layers", "1",
        "--num_attention_heads", "2",
        "--pred_hidden_size", "16", "--pred_num_hidden_layers", "1",
        "--pred_num_attention_heads", "2",
        "--dtype", "float32", "--attn_impl", "xla",
        "--device_cache", "--input_dtype", "bfloat16",
        "--per_device_train_batch_size", "1", "--num_train_epochs", "2",
        "--logging_steps", "1", "--save_steps", "100",
        "--cache_data_dir", str(tmp_path / "cache_dc"),
    ])
    metrics = [json.loads(line)
               for line in (out / "metrics.jsonl").read_text().splitlines()]
    # global batch = 1 x 8 devices -> one full batch per epoch of 10 items
    losses = [m["loss"] for m in metrics if "loss" in m]
    assert len(losses) == 2 and all(np.isfinite(v) for v in losses)


def test_export_hf_script_vjepa2(tmp_path):
    """scripts/export_hf.py: saved checkpoint -> HF-loadable state dict ->
    convert back reproduces the pytree."""
    import jax
    import jax.numpy as jnp

    from smb_vision_tpu.models.configs import VJEPA2Config
    from smb_vision_tpu.models.convert import convert_hf_vjepa2
    from smb_vision_tpu.models.vjepa import VJEPA2Model
    from smb_vision_tpu.utils.serialization import (
        flatten_params,
        save_params_safetensors,
    )

    cfg = VJEPA2Config(crop_size=32, frames_per_clip=16, patch_size=16,
                       tubelet_size=16, in_chans=1, hidden_size=32,
                       num_hidden_layers=1, num_attention_heads=2,
                       pred_hidden_size=16, pred_num_hidden_layers=1,
                       pred_num_attention_heads=2, pred_num_mask_tokens=4,
                       dtype="float32", attn_impl="xla")
    model = VJEPA2Model(cfg)
    px = jnp.zeros((1, 16, 1, 32, 32))
    params = model.init(jax.random.PRNGKey(0), px, skip_predictor=True)

    model_dir = tmp_path / "trained"
    model_dir.mkdir()
    save_params_safetensors(params["params"],
                            model_dir / "model.safetensors")
    cfg.save_json(model_dir / "config.json")

    import sys
    sys.path.insert(0, "scripts")
    from export_hf import main as export_main

    out = tmp_path / "hf"
    export_main(["--model_dir", str(model_dir), "--out", str(out)])
    assert (out / "model.safetensors").exists()

    from safetensors.numpy import load_file

    state = load_file(str(out / "model.safetensors"))
    assert any(k.startswith("encoder.layer.0.") for k in state), list(state)
    back = convert_hf_vjepa2(state, num_layers=1, pred_layers=1)
    ours_flat = flatten_params(params)
    back_flat = flatten_params(back)
    assert set(back_flat) == set(ours_flat)
    for k in ours_flat:
        np.testing.assert_allclose(np.asarray(back_flat[k]),
                                   np.asarray(ours_flat[k]), atol=1e-7,
                                   err_msg=k)


def test_run_mim_train_val_split(dataset, tmp_path, monkeypatch):
    """--train_val_split must auto-split train when the spec has no
    validation split."""
    import smb_vision_tpu.train.trainer as trainer_mod
    from smb_vision_tpu.cli.run_mim import main as run_mim

    root, ds_json = dataset
    rows = json.loads(Path(ds_json).read_text())["train"]
    flat_json = tmp_path / "flat.json"
    flat_json.write_text(json.dumps({"train": rows}))  # no validation split

    seen = {}
    real_trainer = trainer_mod.Trainer

    class SpyTrainer(real_trainer):
        def __init__(self, **kw):
            seen["n_train"] = len(kw["train_loader"].ds)
            seen["n_eval"] = (len(kw["eval_loader"].ds)
                              if kw.get("eval_loader") else 0)
            super().__init__(**kw)

    monkeypatch.setattr(trainer_mod, "Trainer", SpyTrainer)
    run_mim([
        "--json_path", str(flat_json), "--output_dir", str(tmp_path / "o"),
        *ARGS_MODEL, "--mask_patch_size", "16", "--mask_ratio", "0.5",
        "--per_device_train_batch_size", "1",
        "--train_val_split", "0.2",
        "--do_train", "false",
        "--cache_data_dir", str(tmp_path / "cache"),
    ])
    assert seen["n_train"] == 8 and seen["n_eval"] == 2


def test_vjepa_continued_pretraining(dataset, tmp_path, monkeypatch):
    """--model_name_or_path grafts a checkpoint into the fresh V-JEPA init
    (round-2 VERDICT weak #7: the flag was declared and never consumed)."""
    import smb_vision_tpu.train.trainer as trainer_mod
    from smb_vision_tpu.cli.run_vjepa import main as run_vjepa

    _, ds_json = dataset
    args_small = [
        "--data_path", ds_json,
        "--image_size", "32", "--depth", "32", "--patch_size", "16",
        "--hidden_size", "32", "--num_hidden_layers", "1",
        "--num_attention_heads", "2",
        "--pred_hidden_size", "16", "--pred_num_hidden_layers", "1",
        "--pred_num_attention_heads", "2",
        "--dtype", "float32", "--attn_impl", "xla",
        "--per_device_train_batch_size", "1",
        "--logging_steps", "1", "--save_steps", "10",
        "--cache_data_dir", str(tmp_path / "cache"),
    ]
    out1 = tmp_path / "v1"
    run_vjepa(args_small + ["--output_dir", str(out1),
                            "--num_train_steps", "1"])
    ckpt = out1 / "model.safetensors"
    assert ckpt.exists()

    from safetensors.numpy import load_file

    trained = load_file(str(ckpt))
    seen = {}
    real_trainer = trainer_mod.Trainer

    class SpyTrainer(real_trainer):
        def __init__(self, **kw):
            seen["state"] = kw["state"]
            super().__init__(**kw)

    monkeypatch.setattr(trainer_mod, "Trainer", SpyTrainer)
    run_vjepa(args_small + ["--output_dir", str(tmp_path / "v2"),
                            "--model_name_or_path", str(ckpt),
                            "--do_train", "false"])
    from smb_vision_tpu.utils.serialization import flatten_params

    params = flatten_params(seen["state"]["params"])
    teacher = flatten_params(seen["state"]["teacher"])
    key = next(k for k in trained if "encoder" in k and k.endswith("kernel"))
    np.testing.assert_array_equal(params[key], trained[key])
    np.testing.assert_array_equal(teacher[key], trained[key])

    # a checkpoint that matches nothing must fail loudly
    import jax.numpy as jnp
    from safetensors.numpy import save_file

    bogus = tmp_path / "bogus.safetensors"
    save_file({"nothing.matches": np.zeros((2, 2), np.float32)}, str(bogus))
    with pytest.raises(ValueError, match="no tensor"):
        run_vjepa(args_small + ["--output_dir", str(tmp_path / "v3"),
                                "--model_name_or_path", str(bogus),
                                "--do_train", "false"])


def test_lora_cli_eval(dataset, tmp_path):
    """LoRA fine-tune with eval over multiple batches (round-2 VERDICT
    next-round item 4: the eval path must not recompile per batch)."""
    from smb_vision_tpu.cli.run_classification import main as run_cls

    _, ds_json = dataset
    out = tmp_path / "lora_cls"
    run_cls([
        "--train_data_path", ds_json, "--val_data_path", ds_json,
        "--output_dir", str(out), "--task_type", "classification",
        "--num_labels", "2", *ARGS_MODEL,
        "--lora_enable", "true", "--lora_rank", "2",
        "--per_device_train_batch_size", "1", "--num_train_steps", "1",
        "--logging_steps", "1", "--save_steps", "10",
        "--do_eval", "true",
        "--cache_data_dir", str(tmp_path / "cache"),
    ])
    metrics = [json.loads(line)
               for line in (out / "metrics.jsonl").read_text().splitlines()]
    assert any("eval_accuracy" in m for m in metrics)
    assert (out / "lora.safetensors").exists()


def test_inference_pipeline_parallel_matches_plain(dataset, tmp_path):
    """--pipeline_parallel splits the encoder stack over a pipe mesh axis;
    embeddings must match the plain single-program path (same PRNG init).
    batch 2 over 3 volumes also exercises the ragged-final-batch padding."""
    from smb_vision_tpu.cli.run_inference import main as run_inference

    from smb_vision_tpu.models.configs import VideoMAEConfig

    root, _ = dataset
    cfg = VideoMAEConfig(
        image_size=32, num_frames=32, patch_size=16, tubelet_size=16,
        num_channels=1, hidden_size=32, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=64,
        dtype="float32", attn_impl="xla")
    cfg_path = tmp_path / "config.json"
    cfg.save_json(str(cfg_path))
    common = [
        "--data_dir", str(root), "--config_path", str(cfg_path),
        "--dtype", "float32", "--attn_impl", "xla",
        "--batch_size", "2", "--max_samples", "3",
    ]
    plain, piped = tmp_path / "plain", tmp_path / "piped"
    run_inference(common + ["--output_dir", str(plain)])
    run_inference(common + ["--output_dir", str(piped),
                            "--pipeline_parallel", "2"])
    npys = sorted(plain.glob("*.npy"))
    assert len(npys) == 3
    for f in npys:
        a, b = np.load(f), np.load(piped / f.name)
        np.testing.assert_allclose(b, a, rtol=2e-5, atol=2e-5)


def test_build_config_file_geometry_is_authoritative(tmp_path):
    """--config_name_or_path geometry must survive CLI defaults: a
    384^2x256/p32 checkpointed config relaunched without re-passing
    --image_size/--depth/--patch_size must rebuild the SAME model;
    explicitly-changed flags still override."""
    from smb_vision_tpu.cli.run_mim import ModelArguments, build_config
    from smb_vision_tpu.models.configs import VideoMAEConfig

    saved = VideoMAEConfig(image_size=384, num_frames=256, patch_size=32,
                           tubelet_size=32, num_channels=1, hidden_size=64,
                           num_hidden_layers=2, num_attention_heads=2,
                           intermediate_size=128)
    cfg_path = tmp_path / "config.json"
    saved.save_json(cfg_path)

    cfg = build_config(ModelArguments(config_name_or_path=str(cfg_path)))
    assert (cfg.image_size, cfg.num_frames, cfg.patch_size,
            cfg.hidden_size) == (384, 256, 32, 64)

    cfg2 = build_config(ModelArguments(config_name_or_path=str(cfg_path),
                                       image_size=64))
    assert cfg2.image_size == 64 and cfg2.num_frames == 256

    # vjepa analog
    from smb_vision_tpu.cli.run_vjepa import (
        ModelArguments as VModelArguments,
        build_config as vjepa_build_config,
    )
    from smb_vision_tpu.models.configs import VJEPA2Config

    vsaved = VJEPA2Config(crop_size=384, frames_per_clip=128, patch_size=32,
                          tubelet_size=32, hidden_size=64,
                          num_hidden_layers=2, num_attention_heads=2)
    vpath = tmp_path / "vjepa.json"
    vsaved.save_json(vpath)
    vcfg = vjepa_build_config(VModelArguments(
        config_name_or_path=str(vpath)))
    assert (vcfg.crop_size, vcfg.frames_per_clip, vcfg.patch_size) == \
        (384, 128, 32)


def test_build_config_file_kernel_impls_survive_cli_defaults(tmp_path):
    """A config file pinning attn_impl='xla' must not be silently
    reverted to 'auto' by the CLI defaults in --config_name_or_path
    mode; --config_overrides still forces the default back."""
    from smb_vision_tpu.cli.run_mim import ModelArguments, build_config
    from smb_vision_tpu.models.configs import VideoMAEConfig

    saved = VideoMAEConfig(image_size=64, num_frames=64, patch_size=16,
                           tubelet_size=16, num_channels=1, hidden_size=64,
                           num_hidden_layers=1, num_attention_heads=2,
                           intermediate_size=128, attn_impl="xla")
    cfg_path = tmp_path / "config.json"
    saved.save_json(cfg_path)

    cfg = build_config(ModelArguments(config_name_or_path=str(cfg_path)))
    assert cfg.attn_impl == "xla"
    cfg2 = build_config(ModelArguments(config_name_or_path=str(cfg_path),
                                       config_overrides="attn_impl=auto"))
    assert cfg2.attn_impl == "auto"

    from smb_vision_tpu.cli.run_vjepa import (
        ModelArguments as VModelArguments,
        build_config as vjepa_build_config,
    )
    from smb_vision_tpu.models.configs import VJEPA2Config

    vsaved = VJEPA2Config(crop_size=64, frames_per_clip=32, patch_size=16,
                          tubelet_size=16, hidden_size=64,
                          num_hidden_layers=1, num_attention_heads=2,
                          attn_impl="xla")
    vpath = tmp_path / "vjepa.json"
    vsaved.save_json(vpath)
    vcfg = vjepa_build_config(VModelArguments(
        config_name_or_path=str(vpath)))
    assert vcfg.attn_impl == "xla"


def test_build_config_file_dtype_and_remat_survive_cli_defaults(tmp_path):
    """Same guard class for dtype / gradient_checkpointing (round-5
    review pass 3): a float32 or remat-pinned config file must not be
    silently rebuilt at the CLI defaults; --config_overrides remains
    the escape hatch (now also on run_vjepa)."""
    from smb_vision_tpu.cli.run_mim import ModelArguments, build_config
    from smb_vision_tpu.models.configs import VideoMAEConfig

    saved = VideoMAEConfig(image_size=64, num_frames=64, patch_size=16,
                           tubelet_size=16, num_channels=1, hidden_size=64,
                           num_hidden_layers=1, num_attention_heads=2,
                           intermediate_size=128, dtype="float32",
                           gradient_checkpointing=True)
    cfg_path = tmp_path / "config.json"
    saved.save_json(cfg_path)
    cfg = build_config(ModelArguments(config_name_or_path=str(cfg_path)))
    assert cfg.dtype == "float32"
    assert cfg.gradient_checkpointing is True
    # a non-default explicit flag still wins; forcing the DEFAULT value
    # over a file pin needs --config_overrides (explicit-default is
    # indistinguishable from unset — the documented guard limitation)
    cfg2 = build_config(ModelArguments(config_name_or_path=str(cfg_path),
                                       dtype="float16"))
    assert cfg2.dtype == "float16"
    cfg3 = build_config(ModelArguments(config_name_or_path=str(cfg_path),
                                       config_overrides="dtype=bfloat16"))
    assert cfg3.dtype == "bfloat16"

    from smb_vision_tpu.cli.run_vjepa import (
        ModelArguments as VModelArguments,
        build_config as vjepa_build_config,
    )
    from smb_vision_tpu.models.configs import VJEPA2Config

    vsaved = VJEPA2Config(crop_size=64, frames_per_clip=32, patch_size=16,
                          tubelet_size=16, hidden_size=64,
                          num_hidden_layers=1, num_attention_heads=2,
                          attn_impl="xla", gradient_checkpointing=True)
    vpath = tmp_path / "vjepa.json"
    vsaved.save_json(vpath)
    vcfg = vjepa_build_config(VModelArguments(
        config_name_or_path=str(vpath)))
    assert vcfg.gradient_checkpointing is True
    # run_vjepa's new --config_overrides forces a default over a pin
    vcfg2 = vjepa_build_config(VModelArguments(
        config_name_or_path=str(vpath), config_overrides="attn_impl=auto"))
    assert vcfg2.attn_impl == "auto"


def test_classification_explicit_impl_args_guard():
    """run_classification applies the same only-if-explicit merge in
    --config_name_or_path mode via _explicit_impl_args (round-5 review
    pass 3): CLI defaults produce NO overrides; changed flags do."""
    from smb_vision_tpu.cli.run_classification import (
        ModelArguments,
        _explicit_impl_args,
    )

    assert _explicit_impl_args(ModelArguments()) == {}
    out = _explicit_impl_args(ModelArguments(
        attn_impl="xla", gradient_checkpointing=True))
    assert out == {"attn_impl": "xla", "gradient_checkpointing": True}


def test_run_mim_rejects_mismatched_checkpoint(dataset, tmp_path):
    """--model_name_or_path with a wrong-architecture safetensors must fail
    loudly at load (it used to replace the whole tree and crash later as a
    pytree mismatch in the optimizer)."""
    from smb_vision_tpu.cli.run_mim import main as run_mim
    from smb_vision_tpu.utils.serialization import save_params_safetensors

    root, ds_json = dataset
    bogus = tmp_path / "bogus.safetensors"
    save_params_safetensors(
        {"params": {"something": {"kernel": np.zeros((3, 3), np.float32)}}},
        bogus)
    with pytest.raises(ValueError, match="no tensor"):
        run_mim(["--json_path", ds_json,
                 "--output_dir", str(tmp_path / "out"), *ARGS_MODEL,
                 "--mask_patch_size", "16",
                 "--model_name_or_path", str(bogus),
                 "--num_train_steps", "1"])


def test_classification_eval_only_with_saved_config(dataset, tmp_path):
    """Eval-only relaunch: --do_train false --do_eval with
    --config_name_or_path/--model_name_or_path from a previous fine-tune
    must evaluate the SAME architecture (config file authoritative) without
    touching train data."""
    from smb_vision_tpu.cli.run_classification import main as run_cls

    root, ds_json = dataset
    out = tmp_path / "cls"
    common = ["--task_type", "classification", "--num_labels", "2",
              "--image_size", "32", "--depth", "32", "--patch_size", "16",
              "--hidden_size", "32", "--num_hidden_layers", "1",
              "--num_attention_heads", "2", "--intermediate_size", "64",
              "--dtype", "float32", "--attn_impl", "xla",
              "--per_device_eval_batch_size", "2"]
    run_cls(["--train_data_path", ds_json, "--val_data_path", ds_json,
             "--output_dir", str(out), *common,
             "--per_device_train_batch_size", "1",
             "--num_train_steps", "2", "--logging_steps", "1",
             "--save_steps", "100", "--do_eval"])
    assert (out / "model.safetensors").exists()
    assert (out / "config.json").exists()

    out2 = tmp_path / "cls_eval"
    run_cls(["--val_data_path", ds_json, "--output_dir", str(out2),
             "--task_type", "classification",
             "--do_train", "false", "--do_eval",
             "--dtype", "float32", "--attn_impl", "xla",
             "--per_device_eval_batch_size", "2",
             "--config_name_or_path", str(out / "config.json"),
             "--model_name_or_path", str(out / "model.safetensors")])
    recs = [json.loads(line) for line in
            (out2 / "metrics.jsonl").read_text().splitlines()]
    assert any("eval_loss" in r for r in recs), recs


def test_str2bool_rejects_typos():
    import argparse

    from smb_vision_tpu.utils.args import _str2bool

    assert _str2bool("true") and not _str2bool("0")
    with pytest.raises(argparse.ArgumentTypeError):
        _str2bool("ture")


def test_lora_targets_cover_swiglu():
    import jax
    import jax.numpy as jnp

    from smb_vision_tpu.train.lora import init_lora

    params = {"params": {"encoder": {"layer_0": {"mlp": {
        "weights_in": {"kernel": jnp.zeros((8, 16))},
        "weights_out": {"kernel": jnp.zeros((8, 8))}}}}}}
    lora = init_lora(params, jax.random.PRNGKey(0), rank=2)
    assert len(lora) == 2

    with pytest.raises(ValueError, match="no parameters matched"):
        init_lora({"params": {"head": {"kernel": jnp.zeros((4, 4))}}},
                  jax.random.PRNGKey(0), rank=2)


def test_mim_pipeline_composite_policy_and_ragged_eval(dataset, tmp_path):
    """--sharding_policy pipeline+fsdp must survive the pipeline-stages
    override (it was reset to plain 'pipeline'), and eval must pad ragged
    validation splits to a microbatches x data-axis multiple (2 val items,
    eval batch 16, 2 microbatches over data=4 used to crash)."""
    from smb_vision_tpu.cli.run_mim import main as run_mim

    root, ds_json = dataset
    out = tmp_path / "mim_pipe_fsdp"
    run_mim([
        "--json_path", ds_json, "--output_dir", str(out), *ARGS_MODEL,
        "--num_hidden_layers", "2",
        "--config_overrides",
        "decoder_num_hidden_layers=2,decoder_hidden_size=32,"
        "decoder_intermediate_size=64,decoder_num_attention_heads=2",
        "--mask_patch_size", "16", "--mask_ratio", "0.5",
        "--per_device_train_batch_size", "2", "--pipeline_stages", "2",
        "--pipeline_microbatches", "2",
        "--sharding_policy", "pipeline+fsdp",
        "--per_device_eval_batch_size", "4",
        "--logging_steps", "1", "--save_steps", "10", "--do_eval",
        "--num_train_steps", "2",
    ])
    recs = [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines()]
    assert any("eval_loss" in r and np.isfinite(r["eval_loss"])
               for r in recs), recs
