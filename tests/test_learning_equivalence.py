"""End-to-end learning equivalence against the reference stack.

The reference trains vendored-HF VideoMAE through torch + HF ``Trainer``
(/root/reference/src/run_mim.py:429-449, classification via
run_classification.py:75-97 with the recipe in
scripts/training/run_mim.sh:13-38). These tests export OUR init into
the stock torch model, train BOTH stacks for 10 optimizer steps on
identical batches in the HF Trainer's own sampling order with the
reference recipe knobs (AdamW + wd coupling, HF decay-parameter set,
cosine schedule with ceil'd warmup, global-norm clip), and require the
per-step loss trajectories to agree to f32-class tolerance.

This jointly validates what the unit goldens cannot: optimizer semantics,
the wd-exclusion set, clip ordering, schedule shape, and the masked-loss /
Cox path, composed over steps.

The V-JEPA case re-creates the reference's VJEPATrainer
(/root/reference/src/run_vjepa.py:87-141) on the torch side — EMA target
encoder at momentum 0.99925, predictor-vs-teacher L1, EMA updated inside
compute_loss with the pre-step student params — and mirrors that exact
ordering on the jax side, covering the cosine_with_min_lr schedule and
the EMA arithmetic the other cases don't touch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from smb_vision_tpu.models.configs import VideoMAEConfig
from smb_vision_tpu.models.convert import export_hf_videomae
from smb_vision_tpu.models.videomae import (
    VideoMAEForPreTraining,
    VideoMAEForVideoClassification,
)
from smb_vision_tpu.ops.masking import mim_mask, num_masked_tokens
from smb_vision_tpu.train.classification import (
    make_classification_workload,
    problem_type_for,
)
from smb_vision_tpu.train.optim import make_optimizer

KW = dict(image_size=16, patch_size=8, num_channels=1, num_frames=16,
          tubelet_size=8, hidden_size=24, num_hidden_layers=1,
          num_attention_heads=2, intermediate_size=48)
DEC = dict(decoder_hidden_size=16, decoder_num_hidden_layers=1,
           decoder_num_attention_heads=2, decoder_intermediate_size=32)
N, B, STEPS = 4, 2, 10
RECIPE = dict(learning_rate=1e-3, weight_decay=0.01, warmup_ratio=0.01,
              max_grad_norm=1.0)
# f32-class bound: both stacks run f32 (matmul precision "highest" via
# conftest); 1e-3 leaves slack for torch's 4-decimal loss logging and
# BLAS variation across hosts.
TOL = 1e-3


def _hf_args(out_dir, epochs):
    from transformers import TrainingArguments

    return TrainingArguments(
        output_dir=out_dir, per_device_train_batch_size=B,
        num_train_epochs=epochs, learning_rate=RECIPE["learning_rate"],
        lr_scheduler_type="cosine", weight_decay=RECIPE["weight_decay"],
        max_grad_norm=RECIPE["max_grad_norm"],
        warmup_ratio=RECIPE["warmup_ratio"], logging_steps=1,
        report_to=[], seed=0, dataloader_num_workers=0, use_cpu=True,
        remove_unused_columns=False, disable_tqdm=True, save_strategy="no")


def _our_tx(total_steps):
    return make_optimizer(
        learning_rate=RECIPE["learning_rate"], total_steps=total_steps,
        weight_decay=RECIPE["weight_decay"],
        warmup_ratio=RECIPE["warmup_ratio"],
        grad_clip=RECIPE["max_grad_norm"], schedule="cosine")


def _load_into_torch(hf, state_dict):
    missing, unexpected = hf.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in state_dict.items()}, strict=False)
    assert not unexpected, unexpected
    assert all("position_embeddings" in m for m in missing), missing
    return hf.float()


def test_mim_matches_hf_trainer(tmp_path):
    from transformers import Trainer
    from transformers import VideoMAEConfig as HFConfig
    from transformers import VideoMAEForPreTraining as HFModel

    rng = np.random.default_rng(0)
    px = rng.normal(size=(N, 16, 1, 16, 16)).astype(np.float32)
    masks = np.asarray(mim_mask(
        jax.random.PRNGKey(7), N, input_size=16, depth=16,
        mask_patch_size=8, model_patch_size=8, mask_ratio=0.5))
    n_masked = num_masked_tokens(16, 16, 8, 8, 0.5)

    cfg = VideoMAEConfig(norm_pix_loss=True, dtype="float32",
                         attn_impl="xla", **KW, **DEC)
    model = VideoMAEForPreTraining(cfg)
    params = jax.jit(model.init, static_argnums=(3,))(
        jax.random.PRNGKey(0), jnp.asarray(px[:1]), jnp.asarray(masks[:1]),
        n_masked)
    sd = export_hf_videomae(params, num_layers=KW["num_hidden_layers"],
                            decoder_layers=DEC["decoder_num_hidden_layers"])

    hf = _load_into_torch(HFModel(HFConfig(norm_pix_loss=True, **KW,
                                           **DEC)), sd)
    order = []

    class DS(torch.utils.data.Dataset):
        def __len__(self):
            return N

        def __getitem__(self, i):
            order.append(int(i))
            return {"pixel_values": torch.from_numpy(px[i]),
                    "bool_masked_pos": torch.from_numpy(masks[i])}

    epochs = STEPS // (N // B)
    trainer = Trainer(model=hf, args=_hf_args(str(tmp_path), epochs),
                      train_dataset=DS())
    trainer.train()
    t_losses = [h["loss"] for h in trainer.state.log_history if "loss" in h]

    tx = _our_tx(STEPS)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, bpx, bmask):
        def loss_fn(p):
            return model.apply(p, bpx, bmask, n_masked)["loss"]

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        import optax

        return optax.apply_updates(params, updates), opt_state, loss

    j_losses = []
    for s in range(STEPS):
        idx = order[s * B:(s + 1) * B]
        params, opt_state, loss = step(params, opt_state,
                                       jnp.asarray(px[idx]),
                                       jnp.asarray(masks[idx]))
        j_losses.append(float(loss))

    t, j = np.asarray(t_losses[:STEPS]), np.asarray(j_losses)
    # denominator floored at 1% of the trajectory scale: a no-event
    # Cox batch logs loss 0.0 on both sides and raw relative error
    # there is f32 dust divided by ~zero
    scale = max(float(np.abs(t).max()), 1e-8)
    rel = np.abs(t - j) / np.maximum(np.abs(t), 1e-2 * scale)
    assert rel.max() < TOL, (rel.max(), t.tolist(), j.tolist())


@pytest.mark.parametrize("task", ["ce", "cox"])
def test_classification_matches_hf_trainer(tmp_path, task):
    from transformers import Trainer
    from transformers import VideoMAEConfig as HFConfig
    from transformers import VideoMAEForVideoClassification as HFModel

    num_labels = 1 if task == "cox" else 2
    rng = np.random.default_rng(1)
    px = rng.normal(size=(N, 16, 1, 16, 16)).astype(np.float32)
    if task == "cox":
        lab = {"duration": rng.uniform(1, 60, N).astype(np.float32),
               "event": (rng.uniform(size=N) > 0.3).astype(np.float32)}
        lab["event"][:2] = 1.0
    else:
        lab = {"labels": rng.integers(0, num_labels, N).astype(np.int64)}

    task_type = "cox_regression" if task == "cox" else "classification"
    cfg = VideoMAEConfig(
        num_labels=num_labels, use_mean_pooling=True, dtype="float32",
        attn_impl="xla",
        problem_type=problem_type_for(task_type, num_labels), **KW)
    model = VideoMAEForVideoClassification(cfg)
    tx = _our_tx(STEPS)
    init_fn, step_fn, _ = make_classification_workload(
        model, cfg, task_type=task_type, tx=tx)
    b0 = {"pixel_values": px[:B]}
    for k, v in lab.items():
        b0[k] = v[:B]
    state = init_fn(jax.random.PRNGKey(0), b0)
    sd = export_hf_videomae(state["params"],
                            num_layers=KW["num_hidden_layers"])

    hf = _load_into_torch(
        HFModel(HFConfig(num_labels=num_labels, use_mean_pooling=True,
                         **KW)), sd)
    order = []

    class DS(torch.utils.data.Dataset):
        def __len__(self):
            return N

        def __getitem__(self, i):
            order.append(int(i))
            item = {"pixel_values": torch.from_numpy(px[i])}
            for k, v in lab.items():
                item[k] = torch.tensor(v[i])
            return item

    def torch_cox_loss(risk, durations, events, eps=1e-7):
        o = torch.argsort(-durations)
        log_h = risk[o].float().view(-1)
        ev = events[o].float().view(-1)
        gamma = log_h.max()
        log_cumsum = torch.log(
            torch.cumsum(torch.exp(log_h - gamma), 0) + eps) + gamma
        return -torch.sum((log_h - log_cumsum) * ev) / (ev.sum() + eps)

    class SurvivalTrainer(Trainer):
        """reference run_classification.py:75-97 semantics."""

        def compute_loss(self, model, inputs, return_outputs=False,
                         num_items_in_batch=None):
            durations = inputs.pop("duration")
            events = inputs.pop("event")
            outputs = model(**inputs)
            loss = torch_cox_loss(outputs.logits.squeeze(-1), durations,
                                  events)
            return (loss, outputs) if return_outputs else loss

    epochs = STEPS // (N // B)
    cls = SurvivalTrainer if task == "cox" else Trainer
    trainer = cls(model=hf, args=_hf_args(str(tmp_path), epochs),
                  train_dataset=DS())
    trainer.train()
    t_losses = [h["loss"] for h in trainer.state.log_history if "loss" in h]

    jstep = jax.jit(step_fn)
    j_losses = []
    for s in range(STEPS):
        idx = np.asarray(order[s * B:(s + 1) * B])
        b = {"pixel_values": px[idx]}
        for k, v in lab.items():
            b[k] = v[idx]
        state, aux = jstep(state, b, jax.random.PRNGKey(s))
        j_losses.append(float(aux["loss"]))

    t, j = np.asarray(t_losses[:STEPS]), np.asarray(j_losses)
    # denominator floored at 1% of the trajectory scale: a no-event
    # Cox batch logs loss 0.0 on both sides and raw relative error
    # there is f32 dust divided by ~zero
    scale = max(float(np.abs(t).max()), 1e-8)
    rel = np.abs(t - j) / np.maximum(np.abs(t), 1e-2 * scale)
    assert rel.max() < TOL, (rel.max(), t.tolist(), j.tolist())


def test_vjepa_matches_reference_trainer_semantics(tmp_path):
    import copy

    import optax
    from transformers import Trainer, TrainingArguments
    from transformers import VJEPA2Config as HFConfig
    from transformers import VJEPA2Model as HFModel

    from smb_vision_tpu.models.configs import VJEPA2Config
    from smb_vision_tpu.models.convert import export_hf_vjepa2
    from smb_vision_tpu.models.vjepa import VJEPA2Model
    from smb_vision_tpu.train.optim import ema_update

    # head_dim must stay >=24: HF's 3D rope splits head_dim across
    # (t, h, w) bands and a 12-wide head under-fills its band split
    kw = dict(patch_size=8, crop_size=16, frames_per_clip=16,
              tubelet_size=8, in_chans=1, hidden_size=48,
              num_attention_heads=2, num_hidden_layers=1,
              pred_hidden_size=24, pred_num_attention_heads=2,
              pred_num_hidden_layers=1, pred_num_mask_tokens=4)
    momentum = 0.99925  # run_vjepa.py:107
    min_lr = 1e-5       # run_vjepa.sh:21-22 (cosine_with_min_lr)
    n_tgt = 2

    cfg = VJEPA2Config(dtype="float32", attn_impl="xla", **kw)
    model = VJEPA2Model(cfg)
    rng = np.random.default_rng(3)
    px = rng.normal(size=(N, 16, 1, 16, 16)).astype(np.float32)
    perms = np.stack([rng.permutation(cfg.seq_len) for _ in range(N)])
    tgt = np.sort(perms[:, :n_tgt], axis=1).astype(np.int64)
    ctx = np.sort(perms[:, n_tgt:], axis=1).astype(np.int64)

    params = jax.jit(model.init)(
        jax.random.PRNGKey(0), jnp.asarray(px[:1]),
        context_mask=[jnp.asarray(ctx[:1])],
        target_mask=[jnp.asarray(tgt[:1])])
    sd = export_hf_vjepa2(params, num_layers=kw["num_hidden_layers"],
                          pred_layers=kw["pred_num_hidden_layers"])

    hf = HFModel(HFConfig(**kw))
    missing, unexpected = hf.load_state_dict(
        {k: torch.from_numpy(np.ascontiguousarray(v))
         for k, v in sd.items()}, strict=False)
    assert not unexpected and not missing, (missing, unexpected)
    hf = hf.float()
    order = []

    class DS(torch.utils.data.Dataset):
        def __len__(self):
            return N

        def __getitem__(self, i):
            order.append(int(i))
            return {"px": torch.from_numpy(px[i]),
                    "ctx": torch.from_numpy(ctx[i]),
                    "tgt": torch.from_numpy(tgt[i])}

    def collate(ex):
        return {"pixel_values_videos": torch.stack([e["px"] for e in ex]),
                "context_mask": [torch.stack([e["ctx"] for e in ex])],
                "target_mask": [torch.stack([e["tgt"] for e in ex])]}

    class VJEPATrainer(Trainer):
        """run_vjepa.py:101-141 semantics (upstream transformers keeps
        the gathered teacher tokens on the predictor output only, so the
        skip-predictor teacher pass gathers them here)."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.target_encoder = copy.deepcopy(self.model)
            for p in self.target_encoder.parameters():
                p.requires_grad = False

        def compute_loss(self, model, inputs, return_outputs=False,
                         num_items_in_batch=None):
            out = model(pixel_values_videos=inputs["pixel_values_videos"],
                        context_mask=inputs["context_mask"],
                        target_mask=inputs["target_mask"],
                        skip_predictor=False)
            with torch.no_grad():
                t_out = self.target_encoder(
                    pixel_values_videos=inputs["pixel_values_videos"],
                    context_mask=inputs["context_mask"],
                    target_mask=inputs["target_mask"], skip_predictor=True)
                tm = inputs["target_mask"][0]
                teacher_tokens = torch.take_along_dim(
                    t_out.last_hidden_state,
                    tm.unsqueeze(-1).expand(
                        -1, -1, t_out.last_hidden_state.shape[-1]), dim=1)
                for pt, ps in zip(self.target_encoder.parameters(),
                                  model.parameters()):
                    pt.data.mul_(momentum).add_(ps.data,
                                                alpha=1.0 - momentum)
            loss = torch.nn.functional.l1_loss(
                out.predictor_output.last_hidden_state, teacher_tokens)
            return (loss, out) if return_outputs else loss

    epochs = STEPS // (N // B)
    args = TrainingArguments(
        output_dir=str(tmp_path), per_device_train_batch_size=B,
        num_train_epochs=epochs, learning_rate=RECIPE["learning_rate"],
        lr_scheduler_type="cosine_with_min_lr",
        lr_scheduler_kwargs={"min_lr": min_lr},
        weight_decay=RECIPE["weight_decay"],
        max_grad_norm=RECIPE["max_grad_norm"],
        warmup_ratio=RECIPE["warmup_ratio"], logging_steps=1,
        report_to=[], seed=0, dataloader_num_workers=0, use_cpu=True,
        remove_unused_columns=False, disable_tqdm=True, save_strategy="no")
    trainer = VJEPATrainer(model=hf, args=args, train_dataset=DS(),
                           data_collator=collate)
    trainer.train()
    t_losses = [h["loss"] for h in trainer.state.log_history if "loss" in h]

    tx = make_optimizer(
        learning_rate=RECIPE["learning_rate"], total_steps=STEPS,
        weight_decay=RECIPE["weight_decay"],
        warmup_ratio=RECIPE["warmup_ratio"],
        grad_clip=RECIPE["max_grad_norm"], schedule="cosine",
        min_lr=min_lr)
    opt_state = tx.init(params)
    teacher = jax.tree_util.tree_map(jnp.copy, params)

    def loss_fn(p, teacher, bpx, bctx, btgt):
        out = model.apply(p, bpx, context_mask=[bctx], target_mask=[btgt])
        t = model.apply(teacher, bpx, context_mask=[bctx],
                        target_mask=[btgt], skip_predictor=True)
        return jnp.mean(jnp.abs(
            out["predictor_output"] -
            jax.lax.stop_gradient(t["target_hidden_state"])))

    @jax.jit
    def step(params, teacher, opt_state, bpx, bctx, btgt):
        loss, grads = jax.value_and_grad(loss_fn)(params, teacher, bpx,
                                                  bctx, btgt)
        # reference ordering: EMA mixes the PRE-step student params
        teacher = ema_update(teacher, params, momentum)
        updates, opt_state = tx.update(grads, opt_state, params)
        return (optax.apply_updates(params, updates), teacher, opt_state,
                loss)

    j_losses = []
    for s in range(STEPS):
        idx = order[s * B:(s + 1) * B]
        params, teacher, opt_state, loss = step(
            params, teacher, opt_state, jnp.asarray(px[idx]),
            jnp.asarray(ctx[idx]), jnp.asarray(tgt[idx]))
        j_losses.append(float(loss))

    t, j = np.asarray(t_losses[:STEPS]), np.asarray(j_losses)
    scale = max(float(np.abs(t).max()), 1e-8)
    rel = np.abs(t - j) / np.maximum(np.abs(t), 1e-2 * scale)
    assert rel.max() < TOL, (rel.max(), t.tolist(), j.tolist())


def test_two_tier_lr_matches_vision_trainer(tmp_path):
    """Two-tier LR equivalence vs the reference's
    VisionTrainer.create_optimizer grouping
    (/root/reference/src/train/trainer.py:39-169): six param groups —
    {default, visual, merger} x {decay, no-decay} — with per-group LRs
    (visual = names containing videomae/dinov2 minus classifier at
    vision_lr, merger = classifier at merger_lr, the rest — fc_norm —
    at args.learning_rate). All three LRs are DISTINCT here so a
    mis-grouped parameter trains at the wrong rate; the final-parameter
    comparison below then catches it even where the loss trajectory
    would not (a neck/head param's LR barely moves early losses)."""
    from transformers import Trainer
    from transformers import VideoMAEConfig as HFConfig
    from transformers import VideoMAEForVideoClassification as HFModel
    from transformers.pytorch_utils import ALL_LAYERNORM_LAYERS
    from transformers.trainer_pt_utils import get_parameter_names

    num_labels = 2
    lrs = dict(learning_rate=2e-3, vision_lr=5e-4, merger_lr=5e-3)
    rng = np.random.default_rng(5)
    px = rng.normal(size=(N, 16, 1, 16, 16)).astype(np.float32)
    lab = {"labels": rng.integers(0, num_labels, N).astype(np.int64)}

    cfg = VideoMAEConfig(
        num_labels=num_labels, use_mean_pooling=True, dtype="float32",
        attn_impl="xla",
        problem_type=problem_type_for("classification", num_labels), **KW)
    model = VideoMAEForVideoClassification(cfg)
    tx = make_optimizer(
        learning_rate=lrs["learning_rate"], vision_lr=lrs["vision_lr"],
        merger_lr=lrs["merger_lr"], total_steps=STEPS,
        weight_decay=RECIPE["weight_decay"],
        warmup_ratio=RECIPE["warmup_ratio"],
        grad_clip=RECIPE["max_grad_norm"], schedule="cosine")
    init_fn, step_fn, _ = make_classification_workload(
        model, cfg, task_type="classification", tx=tx)
    state = init_fn(jax.random.PRNGKey(0),
                    {"pixel_values": px[:B], "labels": lab["labels"][:B]})
    sd = export_hf_videomae(state["params"],
                            num_layers=KW["num_hidden_layers"])

    hf = _load_into_torch(
        HFModel(HFConfig(num_labels=num_labels, use_mean_pooling=True,
                         **KW)), sd)
    order = []

    class DS(torch.utils.data.Dataset):
        def __len__(self):
            return N

        def __getitem__(self, i):
            order.append(int(i))
            return {"pixel_values": torch.from_numpy(px[i]),
                    "labels": torch.tensor(lab["labels"][i])}

    class TwoTierTrainer(Trainer):
        """VisionTrainer.create_optimizer re-created (ref :54-131)."""

        def create_optimizer(self):
            m = self.model
            decay = [n for n in get_parameter_names(m, ALL_LAYERNORM_LAYERS)
                     if "bias" not in n]
            visual = [n for n, _ in m.named_parameters()
                      if ("videomae" in n or "dinov2" in n)
                      and "classifier" not in n]
            merger = [n for n, _ in m.named_parameters()
                      if "classifier" in n]
            special = merger + visual
            wd = self.args.weight_decay
            groups = [
                {"params": [p for n, p in m.named_parameters()
                            if n in decay and n not in special],
                 "weight_decay": wd},
                {"params": [p for n, p in m.named_parameters()
                            if n not in decay and n not in special],
                 "weight_decay": 0.0},
                {"params": [p for n, p in m.named_parameters()
                            if n in decay and n in visual],
                 "weight_decay": wd, "lr": lrs["vision_lr"]},
                {"params": [p for n, p in m.named_parameters()
                            if n not in decay and n in visual],
                 "weight_decay": 0.0, "lr": lrs["vision_lr"]},
                {"params": [p for n, p in m.named_parameters()
                            if n in decay and n in merger],
                 "weight_decay": wd, "lr": lrs["merger_lr"]},
                {"params": [p for n, p in m.named_parameters()
                            if n not in decay and n in merger],
                 "weight_decay": 0.0, "lr": lrs["merger_lr"]},
            ]
            _, kwargs = Trainer.get_optimizer_cls_and_kwargs(self.args)
            self.optimizer = torch.optim.AdamW(groups, **kwargs)
            return self.optimizer

    epochs = STEPS // (N // B)
    args = _hf_args(str(tmp_path), epochs)
    args.learning_rate = lrs["learning_rate"]
    trainer = TwoTierTrainer(model=hf, args=args, train_dataset=DS())
    trainer.train()
    t_losses = [h["loss"] for h in trainer.state.log_history if "loss" in h]

    jstep = jax.jit(step_fn)
    j_losses = []
    for s in range(STEPS):
        idx = np.asarray(order[s * B:(s + 1) * B])
        state, aux = jstep(state, {"pixel_values": px[idx],
                                   "labels": lab["labels"][idx]},
                           jax.random.PRNGKey(s))
        j_losses.append(float(aux["loss"]))

    t, j = np.asarray(t_losses[:STEPS]), np.asarray(j_losses)
    scale = max(float(np.abs(t).max()), 1e-8)
    rel = np.abs(t - j) / np.maximum(np.abs(t), 1e-2 * scale)
    assert rel.max() < TOL, (rel.max(), t.tolist(), j.tolist())

    # per-group effective updates: final params must agree PER TENSOR.
    # A param sorted into the wrong tier integrates the wrong LR for 10
    # steps and lands visibly off even when the loss curves overlap.
    final_sd = export_hf_videomae(state["params"],
                                  num_layers=KW["num_hidden_layers"])
    t_sd = {k: v.detach().numpy() for k, v in hf.state_dict().items()}
    groups_seen = set()
    for k, v in final_sd.items():
        if "position_embeddings" in k:
            continue                       # non-trainable sincos buffer
        group = ("merger" if "classifier" in k
                 else "visual" if "videomae" in k else "default")
        groups_seen.add(group)
        ref_v = t_sd[k]
        err = np.abs(ref_v - v).max()
        tol = 1e-5 * max(1.0, np.abs(ref_v).max())
        assert err < tol, (k, group, err)
    # the comparison must actually have exercised all three LR tiers
    assert groups_seen == {"default", "visual", "merger"}
