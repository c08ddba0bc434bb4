"""Training loop: the JAX replacement for HF Trainer + accelerate +
DeepSpeed (the reference delegates everything to those, SURVEY §0).

Responsibilities mirrored from the reference surface:
- jitted train step over a Mesh (DDP/ZeRO -> GSPMD shardings)
- gradient accumulation (run_vjepa.sh: grad-accum 4) via lax.scan
- checkpointing (train/checkpoint.py) with save_steps / save_total_limit
  and auto-resume
  (HF get_last_checkpoint behaviour, run_mim.py:263-276,439-445)
- periodic eval + metric logging (console + jsonl + optional wandb)
- step-time / throughput / MFU meters (the reference had none — SURVEY §5)
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Optional

import jax
import jax.numpy as jnp
import numpy as np

from smb_vision_tpu.parallel.mesh import batch_sharding, create_mesh
from smb_vision_tpu.parallel.sharding import (
    opt_state_shardings,
    param_shardings,
    shard_params,
)
from smb_vision_tpu.utils.logging import MetricLogger, get_logger

logger = get_logger(__name__)


@dataclass
class TrainingArguments:
    """Subset of HF TrainingArguments the reference recipes actually use
    (scripts/training/*.sh), plus framework knobs."""

    output_dir: str = "output"
    do_train: bool = True
    do_eval: bool = False
    num_train_steps: Optional[int] = None
    num_train_epochs: float = 1.0
    per_device_train_batch_size: int = 1
    per_device_eval_batch_size: int = 1
    gradient_accumulation_steps: int = 1
    # dtype of the scan-carried gradient accumulator under accumulation:
    # float32 (exact) | bfloat16 (halves the carried state)
    grad_accum_dtype: str = "float32"
    # host-side dtype for float batch arrays shipped to the device:
    # bfloat16 halves host->device transfer bytes (the model's first matmul
    # casts to the compute dtype anyway, so the cost is one extra rounding
    # of the [0,1]-windowed inputs); "uint8" quarters them — pixels ship
    # as per-volume-affine codes and decode to bf16 inside the compiled
    # step (data/quantization.py; max abs err (max-min)/510 per voxel,
    # same order as bf16 rounding on [0,1] data); see run_inference
    # --input_dtype for the inference analog.
    input_dtype: str = "float32"
    learning_rate: float = 5e-5
    weight_decay: float = 0.01
    warmup_ratio: float = 0.0
    warmup_steps: int = 0
    lr_scheduler_type: str = "cosine"
    optim: str = "adamw"             # adamw | adamw8bit (bnb Adam8bit analog)
    min_lr: float = 0.0
    max_grad_norm: float = 1.0
    seed: int = 42
    logging_steps: int = 10
    save_steps: int = 500
    save_total_limit: Optional[int] = 3
    eval_steps: Optional[int] = None
    resume_from_checkpoint: Optional[str] = None
    overwrite_output_dir: bool = False
    report_to: str = "none"          # none | wandb
    run_name: Optional[str] = None
    # two-tier LR fine-tuning
    vision_lr: Optional[float] = None
    merger_lr: Optional[float] = None
    # parallelism
    sharding_policy: str = "dp"      # dp | fsdp | tp | fsdp+tp
    model_parallel: int = 1
    # multi-host: None auto-detects a coordinator in the env and calls
    # jax.distributed.initialize(); True forces, False skips
    multihost: Optional[bool] = None
    # perf accounting
    model_flops_per_sample: Optional[float] = None
    profile_steps: Optional[str] = None  # "A-B" (or "A"): capture a
    # jax.profiler device trace over global steps A..B inclusive into
    # output_dir/profile (view with xprof / tensorboard). Steps are
    # global, so a resumed run profiles the same window only if it
    # re-executes it.


# Train state is a plain dict pytree: {'params', 'opt_state', 'step',
# + workload extras (e.g. 'teacher' params for V-JEPA)} — dicts jit and
# round-trip through train/checkpoint.py losslessly.

def train_state(params, opt_state, step=0, **extras) -> dict:
    s = dict(params=params, opt_state=opt_state,
             step=jnp.asarray(step, jnp.int32))
    s.update(extras)
    return s


class Trainer:
    """Drives a jitted step function over a BatchLoader.

    step_fn(state, batch, key) -> (state, metrics_dict) — built by the
    workload module (train/mim.py, train/vjepa.py, train/classification.py)
    and jitted here with sharded in/out specs.
    """

    def __init__(self, *, args: TrainingArguments, state: dict,
                 step_fn: Callable, train_loader, eval_loader=None,
                 eval_fn: Optional[Callable] = None,
                 compute_metrics: Optional[Callable] = None,
                 mesh=None, donate: bool = True,
                 eval_batch_multiple: int = 1):
        self.args = args
        # eval batches pad up to a multiple of this (x the data axis):
        # pipelined eval_fns need the batch divisible into microbatches
        self.eval_batch_multiple = max(int(eval_batch_multiple), 1)
        self.mesh = mesh or create_mesh(model=args.model_parallel)
        self.train_loader = train_loader
        self.eval_loader = eval_loader
        self.eval_fn = eval_fn
        self.compute_metrics = compute_metrics
        self.out_dir = Path(args.output_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.mlog = MetricLogger(self.out_dir, report_to=args.report_to,
                                 run_name=args.run_name)

        self.state = self._apply_shardings(state)
        self.batch_sh = batch_sharding(self.mesh)

        if args.input_dtype == "uint8":
            # uint8 pixel shipping: batches arrive as u8 codes + per-sample
            # affine; decode on device INSIDE the compiled step (to bf16 —
            # the established half-precision input path) so the host and
            # the wire never see float pixels. data/quantization.py.
            from smb_vision_tpu.data.quantization import dequantize_batch

            inner_step, inner_eval = step_fn, eval_fn
            step_fn = lambda s, b, k: inner_step(  # noqa: E731
                s, dequantize_batch(b, jnp.bfloat16), k)
            if eval_fn is not None:
                # decode in its own small jit, THEN call eval_fn: the
                # classification/survival eval_fn is deliberately host
                # code (np.asarray on labels) and must not be traced
                _deq = jax.jit(
                    lambda b: dequantize_batch(b, jnp.bfloat16))
                self.eval_fn = lambda s, b: inner_eval(  # noqa: E731
                    s, _deq(b))
        self.step_fn = jax.jit(step_fn, donate_argnums=(0,) if donate else ())
        self._ckpt_mgr = self._make_ckpt_manager()

    def _apply_shardings(self, state: dict) -> dict:
        """Place every state leaf per the sharding policy (also re-applied
        after checkpoint restore, which materialises on one device)."""
        from smb_vision_tpu.parallel.mesh import replicated

        args = self.args
        p_sh = param_shardings(state["params"], self.mesh,
                               policy=args.sharding_policy)
        out = dict(state)
        out["params"] = shard_params(state["params"], p_sh)
        if "teacher" in state:
            t_sh = param_shardings(state["teacher"], self.mesh,
                                   policy=args.sharding_policy)
            out["teacher"] = shard_params(state["teacher"], t_sh)
        o_sh = opt_state_shardings(state["opt_state"], p_sh, self.mesh,
                                   params=state["params"])
        out["opt_state"] = jax.device_put(state["opt_state"], o_sh)
        repl = replicated(self.mesh)
        for k, v in state.items():
            if k not in ("params", "opt_state", "teacher"):
                out[k] = jax.device_put(v, repl)
        return out

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------
    def _make_ckpt_manager(self):
        from smb_vision_tpu.train.checkpoint import CheckpointManager

        return CheckpointManager(self.out_dir / "checkpoints",
                                 max_to_keep=self.args.save_total_limit)

    def save_checkpoint(self, step: int):
        self._ckpt_mgr.save(step, dict(self.state))

    def maybe_restore(self) -> int:
        """HF-style auto-resume: explicit path > latest in output_dir."""
        from smb_vision_tpu.train.checkpoint import CheckpointManager

        step = None
        if self.args.resume_from_checkpoint:
            mgr = CheckpointManager(self.args.resume_from_checkpoint)
            step = mgr.latest_step()
            if step is not None:
                self.state = self._apply_shardings(
                    mgr.restore(step, dict(self.state)))
        elif self.args.overwrite_output_dir:
            # HF semantic: start fresh even when output_dir already holds
            # checkpoints; the stale steps are deleted so the new run's
            # steps are the only ones a later resume can find
            step = self._ckpt_mgr.latest_step()
            if step is not None:
                logger.info("overwrite_output_dir: deleting existing "
                            "checkpoints (latest step %s), training from "
                            "scratch", step)
                self._ckpt_mgr.delete_all()
            step = None
        else:
            step = self._ckpt_mgr.latest_step()
            if step is not None:
                logger.info("checkpoint detected, resuming at step %s", step)
                self.state = self._apply_shardings(
                    self._ckpt_mgr.restore(step, dict(self.state)))
        return int(step or 0)

    def save_model(self):
        """Final weights as a flat safetensors file + config json (the
        HF-compatible export, cf. trainer.save_model + upload_model.py).
        LoRA runs additionally export adapters separately (the
        lora/non-lora split of reference trainer.py:171-222)."""
        from smb_vision_tpu.utils.serialization import save_params_safetensors

        save_params_safetensors(self.state["params"],
                                self.out_dir / "model.safetensors")
        if "lora" in self.state:
            from smb_vision_tpu.train.lora import merge_lora

            # adapters + the (non-trained) merge hyperparams export together
            lora = dict(self.state["lora"])
            if "lora_meta" in self.state:
                lora["meta"] = self.state["lora_meta"]
            save_params_safetensors(lora, self.out_dir / "lora.safetensors")
            merged = merge_lora(self.state["params"], lora, train=False)
            save_params_safetensors(merged,
                                    self.out_dir / "model_merged.safetensors")

    # ------------------------------------------------------------------
    # loops
    # ------------------------------------------------------------------
    def train(self) -> Dict[str, float]:
        with jax.set_mesh(self.mesh):
            return self._train()

    def _train(self) -> Dict[str, float]:
        args = self.args
        total = args.num_train_steps
        if total is None:
            total = int(len(self.train_loader) * args.num_train_epochs)
        start = self.maybe_restore()

        # preemption safety: SIGTERM/SIGINT requests a checkpoint at the
        # next step boundary instead of dying mid-update (the reference had
        # no elasticity, SURVEY §5)
        import signal

        stop_requested = {"flag": False}

        def _request_stop(signum, frame):
            logger.warning("signal %s received: checkpointing and stopping "
                           "at the next step boundary", signum)
            stop_requested["flag"] = True

        prev_handlers = {}
        for sig in (signal.SIGTERM, signal.SIGINT):
            try:
                prev_handlers[sig] = signal.signal(sig, _request_stop)
            except ValueError:   # not the main thread
                pass

        base_key = jax.random.PRNGKey(args.seed)
        step = start
        t_last = time.perf_counter()
        samples_per_step = (args.per_device_train_batch_size
                            * self.mesh.shape["data"]
                            * args.gradient_accumulation_steps)
        window_losses = []
        logger.info("training: %d -> %d steps, %d samples/step",
                    start, total, samples_per_step)

        if len(self.train_loader) == 0:
            raise ValueError(
                f"global batch size exceeds the dataset "
                f"({len(self.train_loader.ds)} items) — no full batch can "
                f"be formed; reduce per_device_train_batch_size / "
                f"grad-accum or add data")

        # resume at the right point in the DATA STREAM, not just the right
        # step count: restore the epoch, skip the batches this epoch
        # already consumed, and key each step's RNG by its global step
        # (fold_in) — otherwise a resumed run replays exactly the batches
        # and mask keys it already trained on (HF resume-with-skip
        # semantics)
        steps_per_epoch = len(self.train_loader)
        epoch = start // steps_per_epoch
        skip_batches = start % steps_per_epoch
        if skip_batches:
            logger.info("resume: fast-forwarding %d consumed batches of "
                        "epoch %d", skip_batches, epoch)

        # grad-accum batches are pre-split into (n_accum, micro, ...) on the
        # HOST and device_put with the data axis on the MICRO dim: splitting
        # a data-sharded global batch on device would otherwise reshard
        # (all-to-all) every step under GSPMD. accumulate_gradients detects
        # the sentinel and skips its in-jit reshape.
        accum = args.gradient_accumulation_steps
        accum_sh = None
        if accum > 1:
            from jax.sharding import NamedSharding, PartitionSpec as P

            from smb_vision_tpu.parallel.mesh import DATA_AXIS
            accum_sh = NamedSharding(self.mesh, P(None, DATA_AXIS))

        # device-cached loader: volumes live in device memory across
        # epochs; the host-side cast/pre-split must not pull them back
        dev_cached = hasattr(self.train_loader, "attach_sharding")
        if dev_cached:
            if accum > 1:
                raise ValueError(
                    "device-cached loading is incompatible with host-side "
                    "grad-accum pre-splitting; use "
                    "gradient_accumulation_steps=1 or the host BatchLoader")
            self.train_loader.attach_sharding(self.batch_sh)

        def _on_device(batch):
            return any(isinstance(v, jax.Array) for v in batch.values())

        def presplit(batch):
            if accum <= 1:
                return batch
            out = {k: np.asarray(v).reshape(
                (accum, v.shape[0] // accum) + v.shape[1:])
                for k, v in batch.items()}
            micro = next(iter(out.values())).shape[1]
            # sentinel shaped like a microbatched leaf so the shared
            # (None, "data") sharding applies to it too
            out[ACCUM_SPLIT_KEY] = np.zeros((accum, micro), np.bool_)
            return out

        def batch_sharding_fn(batch):
            return accum_sh if ACCUM_SPLIT_KEY in batch else self.batch_sh

        in_dt = jnp.dtype(args.input_dtype)
        # ONLY pixel columns re-cast to in_dt: label/duration/feature
        # columns ship unchanged (bf16 spacing at duration ~2048 days is
        # 16 — casting Cox durations would collapse distinct survival
        # times into ties and reorder the risk sets)
        _px_keys = ("pixel_values", "pixel_values_videos")

        def cast_inputs(batch):
            # cast float arrays on the HOST before device_put — on
            # bandwidth-constrained hosts the transfer, not the cast, is
            # the bottleneck; best is no cast at all (CTDataset
            # out_dtype == input_dtype), which this passes through
            if in_dt == jnp.float32 or _on_device(batch):
                return batch
            if in_dt == jnp.uint8:
                # fallback for float-yielding loaders; zero-cost config is
                # CTDataset(out_dtype="uint8") which ships codes directly
                from smb_vision_tpu.data.quantization import quantize_batch

                return quantize_batch(batch)
            return {k: (np.asarray(v).astype(in_dt)
                        if (k in _px_keys
                            and np.issubdtype(np.asarray(v).dtype,
                                              np.floating)
                            and np.asarray(v).dtype != in_dt) else v)
                    for k, v in batch.items()}

        prof_range = None
        if args.profile_steps:
            a, _, b = str(args.profile_steps).partition("-")
            prof_range = (int(a), int(b or a))
        prof_active = False

        while step < total:
            self.train_loader.set_epoch(epoch)
            from smb_vision_tpu.data.dataset import prefetch_to_device
            src = iter(self.train_loader)
            if skip_batches:
                import itertools

                src = itertools.islice(src, skip_batches, None)
                skip_batches = 0
            data_iter = map(presplit, map(cast_inputs, src))
            for batch in prefetch_to_device(data_iter,
                                            sharding_fn=batch_sharding_fn):
                if step >= total:
                    break
                if (prof_range and not prof_active
                        and step + 1 >= prof_range[0]):
                    jax.profiler.start_trace(str(self.out_dir / "profile"))
                    prof_active = True
                # step-keyed RNG: reproducible across resume (the split
                # chain would restart from the seed and replay mask keys)
                sub = jax.random.fold_in(base_key, step)
                self.state, metrics = self.step_fn(self.state, batch, sub)
                step += 1
                if prof_active and step >= prof_range[1]:
                    # async dispatch: the step must complete on device
                    # before the trace stops, or it captures nothing
                    jax.block_until_ready(metrics["loss"])
                    jax.profiler.stop_trace()
                    prof_active = False
                    prof_range = None
                window_losses.append(metrics["loss"])

                if step % args.logging_steps == 0:
                    losses = [float(x) for x in window_losses]
                    dt = time.perf_counter() - t_last
                    # the window can be shorter than logging_steps (first
                    # window after a resume at an unaligned step) — meter
                    # by the steps actually taken
                    n_win = max(len(losses), 1)
                    sps = n_win * samples_per_step / dt
                    rec = {"step": step,
                           "loss": float(np.mean(losses)),
                           "samples_per_sec": sps,
                           "step_time_ms": dt / n_win * 1e3}
                    if args.model_flops_per_sample:
                        peak = _device_peak_flops()
                        if peak:
                            rec["mfu"] = (args.model_flops_per_sample * sps
                                          / (peak * jax.device_count()))
                    self.mlog.log(rec)
                    window_losses.clear()
                    t_last = time.perf_counter()

                if step % args.save_steps == 0:
                    self.save_checkpoint(step)
                if (args.eval_steps and self.eval_loader is not None
                        and step % args.eval_steps == 0):
                    self.evaluate(step=step)
                if stop_requested["flag"]:
                    break
            if stop_requested["flag"]:
                break
            epoch += 1

        if prof_active:          # profile window ran past the last step
            jax.profiler.stop_trace()
        # final save unless this exact step is already on disk (a
        # save_steps-aligned stop, or a relaunch of a completed run)
        if self._ckpt_mgr.latest_step() != step:
            self.save_checkpoint(step)
        for sig, h in prev_handlers.items():
            signal.signal(sig, h)
        if stop_requested["flag"]:
            logger.warning("stopped early at step %d (checkpoint saved); "
                           "re-run to resume", step)
        return {"train_steps": step}

    def evaluate(self, step: Optional[int] = None) -> Dict[str, float]:
        with jax.set_mesh(self.mesh):
            return self._evaluate(step)

    def _evaluate(self, step: Optional[int] = None) -> Dict[str, float]:
        if self.eval_loader is None or self.eval_fn is None:
            return {}
        losses, preds, labels = [], [], []

        # Fixed eval batch: partial final batches are padded (repeating the
        # last row) to the first batch's size so eval_fn compiles exactly
        # once. Padded rows are sliced off logits/labels, so metrics are
        # exact; losses are exact too — every in-repo eval_fn consumes the
        # injected valid_mask (per-row weighting for CE/MSE/BCE/MIM/V-JEPA,
        # risk-set exclusion for Cox), and the batch loss is weighted by
        # the true count in the aggregate below.
        target_b = {"n": None}

        n_data = self.mesh.shape["data"]

        def pad_batch(batch):
            first = jax.tree_util.tree_leaves(batch)[0]
            n = first.shape[0]
            if target_b["n"] is None:
                # divisible by microbatches x data axis: a pipelined
                # eval_fn splits the batch into eval_batch_multiple
                # microbatches and EACH microbatch must still shard over
                # the data axis (lcm would not guarantee that)
                m = n_data * self.eval_batch_multiple
                target_b["n"] = -(-n // m) * m
            tb = target_b["n"]
            if n != tb:
                pad = tb - n
                batch = jax.tree_util.tree_map(
                    lambda x: np.concatenate(
                        [np.asarray(x)] + [np.asarray(x)[-1:]] * pad), batch)
            if isinstance(batch, dict):
                # mark real vs padded rows for batch-level nonlinear losses
                # (Cox partial likelihood: padded rows must leave the risk
                # sets — count weighting alone cannot correct that). Added
                # on EVERY batch so the eval_fn's jit signature is stable;
                # eval_fns that don't need it must tolerate the extra key
                # (all in-repo workloads pick keys explicitly).
                if "valid_mask" in batch:
                    raise ValueError(
                        "eval batches must not carry a 'valid_mask' "
                        "column: the Trainer injects its own padding mask "
                        "under that name (rename the dataset column)")
                batch = dict(batch)
                batch["valid_mask"] = np.concatenate(
                    [np.ones(n, np.float32), np.zeros(tb - n, np.float32)])
            return batch, n

        for raw in self.eval_loader:
            batch, n_true = pad_batch(raw)
            batch = jax.device_put(batch, self.batch_sh)
            out = self.eval_fn(self.state, batch)
            if "loss" in out:
                losses.append((float(out["loss"]), n_true))
            if "logits" in out:
                preds.append(np.asarray(out["logits"])[:n_true])
            if "labels" in out:
                lab = out["labels"]
                if isinstance(lab, dict):
                    lab = {k: np.asarray(v)[:n_true] for k, v in lab.items()}
                else:
                    lab = np.asarray(lab)[:n_true]
                labels.append(lab)
        rec: Dict[str, float] = {}
        if losses:
            tot = sum(w for _, w in losses)
            rec["eval_loss"] = float(
                sum(l * w for l, w in losses) / max(tot, 1))
        if preds and self.compute_metrics:
            preds_all = np.concatenate(preds)
            labels_all = _concat_labels(labels)
            rec.update({f"eval_{k}": v for k, v in
                        self.compute_metrics(preds_all, labels_all).items()})
        if step is not None:
            rec["step"] = step
        if rec:
            self.mlog.log(rec)
        return rec


def _concat_labels(labels_list):
    if not labels_list:
        return None
    first = labels_list[0]
    if isinstance(first, dict):
        return {k: np.concatenate([np.asarray(d[k]) for d in labels_list])
                for k in first}
    return np.concatenate([np.asarray(x) for x in labels_list])


# Dense bf16 tensor-core peak per device, keyed by jax's device_kind.
# Source: NVIDIA H100 Tensor Core GPU data sheet (SXM: 989 TFLOP/s bf16
# dense, without sparsity). A device not listed gets no MFU.
PEAK_BF16_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
}


def _device_peak_flops() -> Optional[float]:
    """Peak bf16 FLOP/s of this process's devices, or None if unknown."""
    return PEAK_BF16_FLOPS.get(jax.devices()[0].device_kind)


# sentinel key marking a batch whose leaves are already (n_accum, micro, ..)
# — set by the Trainer, which pre-splits on the host so the data axis lands
# on the micro dim without a device-side reshard
ACCUM_SPLIT_KEY = "_accum_presplit"


def accumulate_gradients(loss_fn, params, batch, key, n_accum: int,
                         accum_dtype=None):
    """Gradient accumulation via lax.scan over microbatches: batch leaves
    are reshaped (n_accum, micro, ...) — unless the Trainer pre-split them
    on the host (ACCUM_SPLIT_KEY present), which avoids an all-to-all under
    GSPMD data sharding. Returns (mean_loss, aux, grads).

    aux (the second element of loss_fn's return) must be a pytree of
    mean-reducible metric arrays (scalars per microbatch) or None; it is
    averaged over microbatches — so workloads keep their metrics under
    accumulation instead of getting None back (round-1 weakness).

    accum_dtype: dtype of the scan-carried gradient accumulator (default
    f32). bfloat16 halves the carried state. The mean over <=8
    microbatches in bf16 costs ~2-3 significant digits of gradient — well
    under SGD noise; the optimizer update itself stays f32."""
    pre_split = isinstance(batch, dict) and ACCUM_SPLIT_KEY in batch
    if pre_split:
        batch = {k: v for k, v in batch.items() if k != ACCUM_SPLIT_KEY}
    if n_accum == 1:
        (loss, aux), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, batch, key)
        return loss, aux, grads

    def micro(b):
        return jax.tree_util.tree_map(
            lambda x: x.reshape((n_accum, x.shape[0] // n_accum)
                                + x.shape[1:]), b)

    mb = batch if pre_split else micro(batch)
    keys = jax.random.split(key, n_accum)
    first = jax.tree_util.tree_map(lambda x: x[0], mb)
    aux_shape = jax.eval_shape(
        lambda p, b, k: loss_fn(p, b, k)[1], params, first, keys[0])
    zero_aux = jax.tree_util.tree_map(
        lambda s: jnp.zeros(s.shape, s.dtype), aux_shape)

    acc_dt = jnp.dtype(accum_dtype) if accum_dtype is not None \
        else jnp.float32

    def body(carry, xs):
        acc_loss, acc_aux, acc_grads = carry
        b, k = xs
        (loss, aux), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params, b, k)
        acc_grads = jax.tree_util.tree_map(
            lambda a, g: a + g.astype(acc_dt), acc_grads, grads)
        acc_aux = jax.tree_util.tree_map(jnp.add, acc_aux, aux)
        return (acc_loss + loss, acc_aux, acc_grads), None

    zero_grads = jax.tree_util.tree_map(
        lambda p: jnp.zeros(p.shape, acc_dt), params)
    (tot_loss, aux, grads), _ = jax.lax.scan(
        body, (0.0, zero_aux, zero_grads), (mb, keys))
    grads = jax.tree_util.tree_map(
        lambda g: g.astype(jnp.float32) / n_accum, grads)
    aux = jax.tree_util.tree_map(lambda a: a / n_accum, aux)
    return tot_loss / n_accum, aux, grads
