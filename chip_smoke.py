"""Smoke run of the main path on one NVIDIA GPU, through the user entry points.

    python chip_smoke.py            # one card: the five phases below
    python chip_smoke.py --four     # four cards: fsdp MIM training only

Phases on one card (weights random from fixed seeds, data generated):

1. device: the card's name and power limit (nvidia-smi, read before JAX
   touches the card), JAX / cuDNN / package versions, and which attention
   and MLP path the shipped configs resolve to.
2. attention at real widths: the fused (cuDNN) path against `xla_attention`
   in f32 on the same bf16-rounded inputs at matmul precision "highest";
   forward, and forward plus gradients where the workload trains.
3. MIM training through cli.run_mim.main at 512x512x320, ViT-Base with
   the reference heads, bf16, gradient checkpointing, per-device batch 2,
   5 steps with a checkpoint inside the run, then a second main() call that
   must auto-resume.
4. V-JEPA training through cli.run_vjepa.main at the
   configs/vjepa_large_384.json geometry, batch 2, 3 steps.
5. embedding through cli.run_inference.main at 512x512x320, batch 4, from
   phase 3's weights; one volume's mean-pooled embedding is compared with an
   f32 forward of the same params (attn_impl "xla", precision "highest").

--four runs `run_mim --sharding_policy fsdp` on four cards (global batch
4, 3 steps) and the same first batch, key and params on a one-device mesh
in the same process; the step-1 losses must agree within 1e-2.

Every phase prints its findings; any failed check raises, so the script
exits non-zero. The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It refuses to run (non-zero exit, no JSON line) when JAX finds no GPU or
when it stands outside a checkout of the repository. Work files go to
.smoke/ in the checkout and are removed first.
"""

from __future__ import annotations

import argparse
import gc
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent

# (B, N, H, d), where it occurs, and whether gradients are compared
ATTN_SHAPES = [
    ((1, 20480, 12, 64), "embed encoder", False),
    ((2, 7168, 12, 64), "MIM encoder, visible tokens", True),
    ((1, 20480, 6, 64), "MIM decoder", True),
    ((2, 9216, 16, 64), "V-JEPA ViT-L encoder", True),
    ((2, 9216, 12, 32), "V-JEPA predictor", True),
]
FWD_TOL, GRAD_TOL, EMBED_TOL, FSDP_TOL = 2e-2, 3e-2, 2e-2, 1e-2

MIM = dict(image_size=512, depth=320, steps=5, save_steps=3, batch=2)
VJEPA = dict(batch=2, steps=3)
EMBED = dict(batch=4)


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"FAILED: {what}")


def rel_err(a, b) -> float:
    import numpy as np

    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def make_data(out: Path, num: int, size: int, depth: int) -> Path:
    """Dummy CT volumes (scripts/create_dummy_data.py, fixed seed); all
    go to the train split. Returns the dataset JSON."""
    subprocess.run([sys.executable, str(REPO / "scripts" /
                                        "create_dummy_data.py"),
                    "--out", str(out), "--num", str(num), "--size",
                    str(size), "--depth", str(depth), "--seed", "0"],
                   check=True, capture_output=True)
    rows = json.loads((out / "dataset_flat.json").read_text())
    path = out / "train_only.json"
    path.write_text(json.dumps({"train": rows}))
    return path


def preset_argv(name: str, **over) -> list:
    """argv for a CLI from a configs/*.json preset, with overrides."""
    blob = json.loads((REPO / "configs" / name).read_text())
    blob.pop("_comment", None)
    blob.update(over)
    argv = []
    for k, v in blob.items():
        argv += [f"--{k}", json.dumps(v) if isinstance(v, bool)
                 else str(v)]
    return argv


def read_metrics(out: Path) -> list:
    return [json.loads(line) for line in
            (out / "metrics.jsonl").read_text().splitlines() if line]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(card: str) -> None:
    import jax
    import safetensors
    from jax._src.lib import cuda_versions

    from smb_vision_tpu.cli.run_mim import ModelArguments as MimArgs
    from smb_vision_tpu.cli.run_mim import build_config as mim_config
    from smb_vision_tpu.cli.run_vjepa import ModelArguments as VjArgs
    from smb_vision_tpu.cli.run_vjepa import build_config as vj_config
    from smb_vision_tpu.ops.attention import attention_backend

    log(f"[device] nvidia-smi: {card}")
    dev = jax.devices()[0]
    cudnn = cuda_versions.cudnn_get_version() if cuda_versions else None
    log(f"[device] jax {jax.__version__}, cudnn {cudnn}, {dev.platform} "
        f"{dev.device_kind} x{jax.device_count()}")
    log(f"[device] safetensors {safetensors.__version__}; module layer "
        "smb_vision_tpu.nn (flax not needed); checkpoints "
        "smb_vision_tpu.train.checkpoint (orbax not needed)")

    def fields(name, cls):
        blob = json.loads((REPO / "configs" / name).read_text())
        names = set(cls.__dataclass_fields__)
        return cls(**{k: v for k, v in blob.items() if k in names})

    import jax.numpy as jnp

    mim = mim_config(fields("mim_base_512.json", MimArgs))
    vj = vj_config(fields("vjepa_large_384.json", VjArgs))
    for label, hidden, heads, dtype in [
            ("mim_base_512 encoder", mim.hidden_size,
             mim.num_attention_heads, mim.dtype),
            ("mim_base_512 decoder", mim.decoder_hidden_size,
             mim.decoder_num_attention_heads, mim.dtype),
            ("vjepa_large_384 encoder", vj.hidden_size,
             vj.num_attention_heads, vj.dtype),
            ("vjepa_large_384 predictor", vj.pred_hidden_size,
             vj.pred_num_attention_heads, vj.dtype)]:
        q = jax.ShapeDtypeStruct((1, 8, heads, hidden // heads),
                                 jnp.dtype(dtype))
        backend = attention_backend(q, q)
        log(f"[device] {label}: {dtype} d{hidden // heads} attention -> "
            f"{backend}; MLP -> XLA (cuBLAS + fused epilogue)")
        check(backend == "cudnn", f"{label} resolves to cuDNN")


def phase_attention(shapes=ATTN_SHAPES) -> None:
    import jax
    import jax.numpy as jnp

    from smb_vision_tpu.ops.attention import (
        attention,
        attention_backend,
        xla_attention,
    )

    fused = jax.jit(attention)
    ref = jax.jit(xla_attention)

    def vjp_of(fn):
        return jax.jit(lambda q, k, v, g: jax.vjp(fn, q, k, v)[1](g))

    fused_vjp, ref_vjp = vjp_of(attention), vjp_of(xla_attention)
    f32 = lambda x: x.astype(jnp.float32)  # noqa: E731
    for i, (shape, where, grads) in enumerate(shapes):
        keys = jax.random.split(jax.random.PRNGKey(100 + i), 4)
        q, k, v, g = (jax.random.normal(kk, shape, jnp.bfloat16)
                      for kk in keys)
        check(attention_backend(q, k) == "cudnn", f"{shape} routes to cuDNN")
        out = fused(q, k, v)
        # reference one batch row at a time, so its f32 scores fit
        with jax.default_matmul_precision("highest"):
            r = jnp.concatenate([ref(f32(q[b:b + 1]), f32(k[b:b + 1]),
                                     f32(v[b:b + 1]))
                                 for b in range(shape[0])])
        e = rel_err(out, r)
        log(f"[attention] {shape} {where}: fwd max|err|/max|ref| = "
            f"{e:.3e} (limit {FWD_TOL})")
        check(e < FWD_TOL, f"attention fwd {shape}")
        del out, r
        if grads:
            gf = fused_vjp(q, k, v, g)
            with jax.default_matmul_precision("highest"):
                gr = [ref_vjp(f32(q[b:b + 1]), f32(k[b:b + 1]),
                              f32(v[b:b + 1]), f32(g[b:b + 1]))
                      for b in range(shape[0])]
            for j, name in enumerate(("dq", "dk", "dv")):
                r = jnp.concatenate([x[j] for x in gr])
                e = rel_err(gf[j], r)
                log(f"[attention] {shape} {where}: {name} max|err|/max|ref|"
                    f" = {e:.3e} (limit {GRAD_TOL})")
                check(e < GRAD_TOL, f"attention {name} {shape}")
            del gf, gr
        gc.collect()


def _losses(out: Path, n: int) -> list:
    recs = [r for r in read_metrics(out) if "loss" in r]
    losses = [r["loss"] for r in recs]
    check(len(losses) >= n, f"{n} logged losses in {out}")
    check(all(x == x and abs(x) != float("inf") for x in losses),
          f"finite losses {losses}")
    return recs


def phase_mim(work: Path, data: Path, mim=MIM, **over) -> Path:
    import jax

    from smb_vision_tpu.cli.run_mim import main as run_mim
    from smb_vision_tpu.train.checkpoint import CheckpointManager

    out = work / "mim"

    def argv(steps):
        return preset_argv(
            "mim_base_512.json", json_path=str(data), output_dir=str(out),
            image_size=mim["image_size"], depth=mim["depth"],
            per_device_train_batch_size=mim["batch"],
            num_train_steps=steps, save_steps=mim["save_steps"],
            logging_steps=1, train_val_split=0, num_workers=4,
            cache_data_dir=str(work / "cache_mim"), **over)

    run_mim(argv(mim["steps"]))
    recs = _losses(out, mim["steps"])
    for r in recs:
        log(f"[mim] step {r['step']}: loss {r['loss']:.6f}")
    steady = statistics.median(r["step_time_ms"] for r in recs[1:])
    peak = (jax.devices()[0].memory_stats() or {}).get("peak_bytes_in_use")
    log(f"[mim] smoke reading, not a benchmark: steady step "
        f"{steady:.1f} ms (median of steps 2-{mim['steps']}), "
        f"peak_bytes_in_use {peak}")
    mgr = CheckpointManager(out / "checkpoints")
    check(mgr.all_steps() == [mim["save_steps"], mim["steps"]],
          f"checkpoints at steps {mgr.all_steps()}")
    for f in ("model.safetensors", "config.json", "metrics.jsonl"):
        check((out / f).exists(), f"{f} written")
    # a second call with one more step must resume at the last step
    n_before = len(recs)
    run_mim(argv(mim["steps"] + 1))
    new = [r["step"] for r in _losses(out, n_before + 1)[n_before:]]
    check(new == [mim["steps"] + 1], f"resumed steps {new}")
    check(mgr.latest_step() == mim["steps"] + 1, "resumed checkpoint")
    log(f"[mim] checkpoint steps {mgr.all_steps()}; second main() resumed "
        f"at step {mim['steps']} and ran step {new[0]}")
    gc.collect()
    return out


def phase_vjepa(work: Path, data: Path, vj=VJEPA, **over) -> None:
    from smb_vision_tpu.cli.run_vjepa import main as run_vjepa

    out = work / "vjepa"
    run_vjepa(preset_argv(
        "vjepa_large_384.json", data_path=str(data), output_dir=str(out),
        per_device_train_batch_size=vj["batch"],
        gradient_accumulation_steps=1, num_train_steps=vj["steps"],
        save_steps=1000, logging_steps=1, num_workers=4,
        cache_data_dir=str(work / "cache_vjepa"), **over))
    for r in _losses(out, vj["steps"]):
        log(f"[vjepa] step {r['step']}: loss {r['loss']:.6f} "
            f"({r['step_time_ms']:.1f} ms, smoke reading)")
    gc.collect()


def phase_embed(work: Path, data: Path, mim_out: Path, emb=EMBED) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from smb_vision_tpu.cli.run_inference import main as run_inference
    from smb_vision_tpu.data.dataset import CTDataset
    from smb_vision_tpu.data.preprocess import CT_PIPELINES, PreprocessConfig
    from smb_vision_tpu.models.configs import VideoMAEConfig
    from smb_vision_tpu.models.convert import load_backbone_into
    from smb_vision_tpu.models.videomae import VideoMAEModel

    out = work / "embed"
    rows = json.loads(data.read_text())["train"][:emb["batch"]]
    subset = work / "embed_items.json"
    subset.write_text(json.dumps({"train": rows}))
    cache = work / "cache_embed"
    t0 = time.perf_counter()
    run_inference(["--data_json", str(subset), "--output_dir", str(out),
                   "--model_name_or_path",
                   str(mim_out / "model.safetensors"),
                   "--config_path", str(mim_out / "config.json"),
                   "--batch_size", str(emb["batch"]), "--format", "npy",
                   "--cache_data_dir", str(cache), "--num_workers", "4"])
    dt = time.perf_counter() - t0
    cfg = VideoMAEConfig.from_json(str(mim_out / "config.json"))
    embs = {r["uid"]: np.load(out / f"{r['uid']}.npy") for r in rows}
    for uid, e in embs.items():
        check(e.shape == (cfg.seq_len, cfg.hidden_size),
              f"{uid} embedding shape {e.shape}")
        check(bool(np.isfinite(e).all()), f"{uid} embedding finite")
    log(f"[embed] {len(embs)} volumes -> {next(iter(embs.values())).shape} "
        f"tokens each, all finite ({dt:.1f} s incl. compile, smoke "
        "reading)")

    # f32 reference of volume 0 from the same weights and pixels
    pipe = PreprocessConfig(
        target_spacing=CT_PIPELINES["smb-vision"].target_spacing,
        target_size=(cfg.image_size, cfg.image_size, cfg.num_frames))
    ds = CTDataset(data_path=str(subset), split=None, pipeline=pipe,
                   cache_dir=str(cache))
    px = jnp.asarray(ds[0]["image"][None], jnp.float32)
    ref_cfg = VideoMAEConfig.from_dict(
        {**cfg.to_dict(), "dtype": "float32", "attn_impl": "xla"})
    model = VideoMAEModel(ref_cfg)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), px)
    params = load_backbone_into(params, str(mim_out / "model.safetensors"))
    with jax.default_matmul_precision("highest"):
        tokens, _ = jax.jit(model.apply)(params, px)
    pooled_ref = np.asarray(tokens[0]).mean(0)
    pooled = embs[rows[0]["uid"]].mean(0)
    e = rel_err(pooled, pooled_ref)
    log(f"[embed] {rows[0]['uid']} pooled embedding vs f32 XLA reference: "
        f"max|err|/max|ref| = {e:.3e} (limit {EMBED_TOL})")
    check(e < EMBED_TOL, "pooled embedding vs f32 reference")


def phase_four(work: Path, data: Path, mim=MIM) -> None:
    """run_mim with fsdp on four cards vs the same first step on one."""
    import jax
    import numpy as np

    from smb_vision_tpu.cli.run_mim import main as run_mim
    from smb_vision_tpu.data.dataset import BatchLoader, CTDataset
    from smb_vision_tpu.data.preprocess import CT_PIPELINES, PreprocessConfig
    from smb_vision_tpu.models.configs import VideoMAEConfig
    from smb_vision_tpu.parallel.mesh import create_mesh
    from smb_vision_tpu.train.mim import make_mim_workload
    from smb_vision_tpu.train.optim import make_optimizer

    n = jax.device_count()
    check(n == 4, f"--four needs 4 GPUs, found {n}")
    out = work / "mim_fsdp"
    steps, seed, gbs = 3, 42, 4
    cache = work / "cache_mim"
    argv = preset_argv(
        "mim_base_512.json", json_path=str(data), output_dir=str(out),
        image_size=mim["image_size"], depth=mim["depth"],
        per_device_train_batch_size=gbs // n, num_train_steps=steps,
        save_steps=1000, logging_steps=1, train_val_split=0, seed=seed,
        num_workers=4, sharding_policy="fsdp", cache_data_dir=str(cache))
    run_mim(argv)
    recs = _losses(out, steps)
    for r in recs:
        log(f"[four] fsdp x{n} step {r['step']}: loss {r['loss']:.6f} "
            f"({r['step_time_ms']:.1f} ms, smoke reading)")
    gc.collect()

    # the same first batch, key and params on a one-device mesh
    cfg = VideoMAEConfig.from_json(str(out / "config.json"))
    preset = json.loads((REPO / "configs" / "mim_base_512.json").read_text())
    pipe = PreprocessConfig(
        target_spacing=CT_PIPELINES["mim"].target_spacing,
        target_size=(cfg.image_size, cfg.image_size, cfg.num_frames))
    ds = CTDataset(str(data), split="train", pipeline=pipe,
                   cache_dir=str(cache))
    loader = BatchLoader(ds, gbs, shuffle=True, seed=seed, num_workers=4)
    loader.set_epoch(0)
    batch = next(iter(loader))
    tx = make_optimizer(
        learning_rate=preset["learning_rate"], total_steps=steps,
        weight_decay=preset["weight_decay"],
        warmup_ratio=preset["warmup_ratio"],
        schedule=preset["lr_scheduler_type"])
    _, init_fn, step_fn, _ = make_mim_workload(
        cfg, mask_patch_size=preset["mask_patch_size"],
        mask_ratio=preset["mask_ratio"], tx=tx)
    mesh1 = create_mesh(devices=jax.devices()[:1])
    key = jax.random.PRNGKey(seed)
    with jax.set_mesh(mesh1):
        state = init_fn(key)
        batch = jax.device_put({k: np.asarray(v) for k, v in batch.items()},
                               jax.devices()[0])
        _, m = jax.jit(step_fn)(state, batch, jax.random.fold_in(key, 0))
    one = float(m["loss"])
    e = abs(recs[0]["loss"] - one) / abs(one)
    log(f"[four] step-1 loss: fsdp x{n} {recs[0]['loss']:.6f}, one device "
        f"{one:.6f}, relative difference {e:.3e} (limit {FSDP_TOL})")
    check(e < FSDP_TOL, "fsdp step-1 loss matches one device")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run fsdp MIM training on four GPUs only")
    args = ap.parse_args(argv)

    sys.path.insert(0, str(REPO))
    from smb_vision_tpu.utils.device import nvidia_smi_name_power

    card = nvidia_smi_name_power()       # before JAX touches the card
    from smb_vision_tpu.utils.compile_cache import setup_compile_cache

    cache = setup_compile_cache()
    import jax

    from smb_vision_tpu.utils.device import require_gpu

    dev = require_gpu()
    log(f"[device] compile cache: {cache}")
    work = REPO / ".smoke"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir()
    t0 = time.perf_counter()
    data = make_data(work / "data", num=4, size=128, depth=96)
    if args.four:
        log(f"[device] nvidia-smi: {card}")
        phase_four(work, data)
    else:
        phase_device(card)
        phase_attention()
        mim_out = phase_mim(work, data)
        phase_vjepa(work, data)
        phase_embed(work, data, mim_out)
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": jax.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
