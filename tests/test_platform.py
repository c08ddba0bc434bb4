"""What the GPU port decides from what it can observe: removed kernel
names in old configs, the MFU peak table, the compile-cache directory, and
the GPU-only scripts' refusal to run anywhere else."""

import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# removed kernel names
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("field,value,kept", [
    ("mlp_impl", "pallas_bwd", None),
    ("glue_impl", "pallas", None),
    ("teacher_attn_impl", "pallas_int8", None),
    ("attn_impl", "pallas", "auto"),
    ("attn_impl", "pallas_i8bwd", "auto"),
    ("attn_impl", "pallas_int8", "auto"),
])
def test_legacy_config_field_dropped_with_warning(tmp_path, field, value,
                                                  kept):
    from smb_vision_tpu.models.configs import VideoMAEConfig

    d = VideoMAEConfig(hidden_size=64).to_dict()
    d[field] = value
    p = tmp_path / "config.json"
    p.write_text(json.dumps(d))
    with pytest.warns(UserWarning, match=field) as rec:
        cfg = VideoMAEConfig.from_json(str(p))
    assert len([w for w in rec if field in str(w.message)]) == 1
    assert cfg.hidden_size == 64
    assert not hasattr(cfg, "mlp_impl") and not hasattr(cfg, "glue_impl")
    if kept is not None:
        assert getattr(cfg, field) == kept


def test_current_config_loads_without_warning(tmp_path):
    from smb_vision_tpu.models.configs import VJEPA2Config

    p = tmp_path / "config.json"
    VJEPA2Config(attn_impl="xla").save_json(str(p))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert VJEPA2Config.from_json(str(p)).attn_impl == "xla"


@pytest.mark.parametrize("value", ["pallas", "pallas_int8", "cudnn"])
def test_removed_attn_impl_rejected_in_code_and_cli(value):
    from smb_vision_tpu.cli.run_mim import ModelArguments, build_config
    from smb_vision_tpu.models.configs import VideoMAEConfig

    with pytest.raises(ValueError, match="unknown attention impl"):
        VideoMAEConfig(attn_impl=value)
    with pytest.raises(ValueError, match="unknown attention impl"):
        build_config(ModelArguments(attn_impl=value))


@pytest.mark.parametrize("flag", ["--mlp_impl", "--teacher_attn_impl",
                                  "--dcn_slices"])
def test_removed_cli_flags_rejected(flag):
    from smb_vision_tpu.cli.run_vjepa import main

    with pytest.raises(SystemExit):
        main([flag, "x", "--data_path", "none.json"])


def test_legacy_json_args_file_loads(tmp_path):
    """A CLI args file (configs/*.json style) naming removed kernels
    parses with those fields dropped."""
    from smb_vision_tpu.cli.run_mim import ModelArguments
    from smb_vision_tpu.train.trainer import TrainingArguments
    from smb_vision_tpu.utils.args import parse_args_into_dataclasses

    p = tmp_path / "args.json"
    p.write_text(json.dumps({"hidden_size": 96, "mlp_impl": "pallas_bwd",
                             "attn_impl": "pallas_i8bwd",
                             "output_dir": str(tmp_path)}))
    with pytest.warns(UserWarning):
        m, t = parse_args_into_dataclasses((ModelArguments,
                                            TrainingArguments), [str(p)])
    assert m.hidden_size == 96 and m.attn_impl == "auto"


@pytest.mark.parametrize("name", ["mim_base_512.json",
                                  "vjepa_large_384.json"])
def test_shipped_presets_name_no_removed_kernel(name):
    blob = json.loads((REPO / "configs" / name).read_text())
    assert not {"mlp_impl", "glue_impl", "teacher_attn_impl"} & set(blob)
    assert blob.get("attn_impl", "auto") in ("auto", "xla")
    assert blob["dtype"] == "bfloat16"


# ---------------------------------------------------------------------------
# MFU peak table
# ---------------------------------------------------------------------------

class _Dev:
    def __init__(self, kind):
        self.device_kind = kind


@pytest.mark.parametrize("kind,peak", [
    ("NVIDIA H100 80GB HBM3", 989e12),
    ("cpu", None),
    ("NVIDIA A100-SXM4-80GB", None),
    ("NVIDIA H100 PCIe", None),
])
def test_peak_table(monkeypatch, kind, peak):
    import smb_vision_tpu.train.trainer as tr

    monkeypatch.setattr(tr.jax, "devices", lambda: [_Dev(kind)])
    assert tr._device_peak_flops() == peak


def test_unknown_device_logs_no_mfu(tmp_path):
    """On a device outside the table the trainer logs no MFU at all
    (never one against an assumed peak)."""
    import jax.numpy as jnp

    from smb_vision_tpu.train.trainer import (
        Trainer,
        TrainingArguments,
        train_state,
    )

    class Loader:
        ds = [0, 1]

        def set_epoch(self, e):
            pass

        def __len__(self):
            return 1

        def __iter__(self):
            yield {"x": jnp.zeros((8, 2))}

    def step_fn(state, batch, key):
        return dict(state, step=state["step"] + 1), {"loss": jnp.ones(())}

    args = TrainingArguments(output_dir=str(tmp_path), num_train_steps=2,
                             logging_steps=1, save_steps=100,
                             model_flops_per_sample=1e12)
    Trainer(args=args, state=train_state({"w": jnp.zeros(2)}, ()),
            step_fn=step_fn, train_loader=Loader()).train()
    recs = [json.loads(line) for line in
            (tmp_path / "metrics.jsonl").read_text().splitlines()]
    assert recs and all("mfu" not in r for r in recs)


# ---------------------------------------------------------------------------
# compile cache
# ---------------------------------------------------------------------------

def _cache_dir_in_child(env):
    code = ("from smb_vision_tpu.utils.compile_cache import "
            "setup_compile_cache as s; d = s(); import jax; "
            "print(d); print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120, check=True)
    return out.stdout.split()


def test_compile_cache_default_is_fixed_dir_in_checkout(tmp_path):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    want = str(REPO / ".jax_cache")
    assert _cache_dir_in_child(env) == [want, want]
    assert _cache_dir_in_child(env) == [want, want]   # same path again


def test_compile_cache_env_var_wins(tmp_path):
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "c"))
    assert _cache_dir_in_child(env) == [str(tmp_path / "c")] * 2


def test_compile_cache_path_has_no_run_specific_part():
    from smb_vision_tpu.utils import compile_cache

    assert compile_cache.DEFAULT_DIR == REPO / ".jax_cache"
    ignored = (REPO / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored


# ---------------------------------------------------------------------------
# GPU-only scripts
# ---------------------------------------------------------------------------

def _run(args, cwd, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    return subprocess.run([sys.executable, *args], cwd=str(cwd), env=env,
                          capture_output=True, text=True, timeout=300)


def _fake_nvidia_smi(tmp_path):
    b = tmp_path / "bin"
    b.mkdir()
    exe = b / "nvidia-smi"
    exe.write_text("#!/bin/sh\necho 'NVIDIA H100 80GB HBM3, 400.00 W'\n")
    exe.chmod(0o755)
    return {"PATH": f"{b}{os.pathsep}{os.environ.get('PATH', '')}"}


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_script_refuses_cpu(tmp_path, script):
    """With a card name available but JAX on the CPU, the script exits
    non-zero and prints no JSON result line."""
    r = _run([str(REPO / script)], REPO, _fake_nvidia_smi(tmp_path))
    assert r.returncode != 0
    assert "no GPU" in r.stderr + r.stdout
    assert '"ok"' not in r.stdout and '"value"' not in r.stdout


def test_chip_smoke_alone_refuses(tmp_path):
    """Outside a checkout (only chip_smoke.py present) it fails."""
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                       env=dict(env, JAX_PLATFORMS="cpu"),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and '"ok"' not in r.stdout


def test_chip_smoke_last_line_format(monkeypatch, capsys):
    """The last stdout line is exactly the result object, with the device
    as JAX reports it."""
    sys.path.insert(0, str(REPO))
    import chip_smoke

    class Dev:
        platform, device_kind = "gpu", "NVIDIA H100 80GB HBM3"

    for name in ("phase_device", "phase_attention", "phase_vjepa",
                 "phase_embed"):
        monkeypatch.setattr(chip_smoke, name, lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "phase_mim", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "make_data", lambda *a, **k: None)
    monkeypatch.setattr(chip_smoke, "REPO", REPO)
    import smb_vision_tpu.utils.device as device

    monkeypatch.setattr(device, "nvidia_smi_name_power",
                        lambda: "NVIDIA H100 80GB HBM3, 400.00 W")
    monkeypatch.setattr(device, "require_gpu", lambda: Dev())
    monkeypatch.setattr(chip_smoke, "shutil",
                        type("S", (), {"rmtree": staticmethod(
                            lambda *a, **k: None)}))
    monkeypatch.setattr(Path, "mkdir", lambda *a, **k: None)
    chip_smoke.main([])
    last = capsys.readouterr().out.strip().splitlines()[-1]
    import jax

    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
        "count": jax.device_count()}}
