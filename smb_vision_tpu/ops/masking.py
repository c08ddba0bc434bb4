"""On-device mask generation (jit-compatible, static shapes).

On-device redesign of the reference's CPU/numpy mask generators:

- ``mim_mask`` matches MaskGenerator semantics
  (/root/reference/src/dataloader/mim.py:25-69, transforms.py:20-63):
  random coarse-grid mask with exactly ``ceil(token_count*ratio)`` masked
  cells, upsampled to the model-patch grid. The masked-token count is static,
  which keeps downstream gathers fixed-shape under jit.

- ``vjepa_target_mask`` matches VJEPAMaskGenerator semantics
  (transforms.py:96-217): sample one block size from pred_mask_scale +
  aspect-ratio, carve ``num_blocks`` random blocks out of the patch grid;
  the union of blocks is the *target*, its complement the *context*.
  Emitted as a dense (B, N) boolean instead of index lists — the
  predictor consumes the boolean directly (see models/vjepa.py), and unlike
  the reference's collate_fn (run_vjepa.py:156-158, which replicated a single
  sample's mask over the whole batch) masks here are per-sample.

Because these run inside the compiled train step from a jax.random key,
dataset disk caches stay mask-free and every step is replayable.
"""

from __future__ import annotations

import math
from typing import Tuple

import jax
import jax.numpy as jnp


def mim_mask_counts(input_size: int, depth: int, mask_patch_size: int,
                    model_patch_size: int, mask_ratio: float
                    ) -> Tuple[int, int, int]:
    """(token_count, mask_count, scale) on the coarse mask grid."""
    if input_size % mask_patch_size or depth % mask_patch_size:
        raise ValueError(
            f"input_size ({input_size}) and depth ({depth}) must be "
            f"divisible by mask_patch_size ({mask_patch_size})")
    if mask_patch_size % model_patch_size:
        raise ValueError(
            f"mask_patch_size ({mask_patch_size}) must be divisible by "
            f"model_patch_size ({model_patch_size})")
    if not 0.0 < mask_ratio <= 1.0:
        # >1 would over-report num_masked_tokens while mim_mask's argsort
        # slice clamps — desynchronising the mask from the model's
        # fixed-shape gathers with no error
        raise ValueError(f"mask_ratio must be in (0, 1], got {mask_ratio}")
    rs = input_size // mask_patch_size
    rd = depth // mask_patch_size
    scale = mask_patch_size // model_patch_size
    token_count = rd * rs * rs
    mask_count = int(math.ceil(token_count * mask_ratio))
    return token_count, mask_count, scale


def mim_mask(key: jax.Array, batch: int, *, input_size: int, depth: int,
             mask_patch_size: int, model_patch_size: int,
             mask_ratio: float) -> jax.Array:
    """Per-sample random block mask.

    Returns (batch, N) bool where N = (depth/mp)*(input_size/mp)^2 on the
    model-patch grid; True = masked. Exactly
    ceil(coarse_count*ratio)*scale^3 tokens are masked per sample.
    """
    rs = input_size // mask_patch_size
    rd = depth // mask_patch_size
    token_count, mask_count, scale = mim_mask_counts(
        input_size, depth, mask_patch_size, model_patch_size, mask_ratio)

    # per-row random choice of mask_count coarse tokens: one argsort + a
    # boolean scatter (bit-identical to an argsort(argsort) rank threshold
    # at half the sorts)
    u = jax.random.uniform(key, (batch, token_count))
    masked_idx = jnp.argsort(u, axis=-1)[:, :mask_count]
    coarse = jnp.zeros((batch, token_count), bool).at[
        jnp.arange(batch)[:, None], masked_idx].set(True)
    coarse = coarse.reshape(batch, rd, rs, rs)

    if scale > 1:
        coarse = jnp.repeat(coarse, scale, axis=1)
        coarse = jnp.repeat(coarse, scale, axis=2)
        coarse = jnp.repeat(coarse, scale, axis=3)
    return coarse.reshape(batch, -1)


def num_masked_tokens(input_size: int, depth: int, mask_patch_size: int,
                      model_patch_size: int, mask_ratio: float) -> int:
    """Static count of masked model-patch tokens (for fixed-shape gathers)."""
    _, mask_count, scale = mim_mask_counts(
        input_size, depth, mask_patch_size, model_patch_size, mask_ratio)
    return mask_count * scale ** 3


def _sample_block_dims(key: jax.Array, grid: Tuple[int, int, int],
                       pred_mask_scale: Tuple[float, float],
                       aspect_ratio: Tuple[float, float]):
    """Block (d, h, w) in patch units; traced values (data-dependent sizes
    never change array shapes — blocks are materialised as coordinate
    comparisons). Matches _sample_block_size (transforms.py:139-164):
    d = round(cbrt(num_keep)), h = round(d*ar), w = round(d/ar), clamped."""
    gd, gh, gw = grid
    n = gd * gh * gw
    k_s, k_a = jax.random.split(key)
    min_s, max_s = pred_mask_scale
    scale = jax.random.uniform(k_s, (), minval=min_s, maxval=max_s)
    num_keep = jnp.floor(n * scale)
    min_a, max_a = aspect_ratio
    ar = jax.random.uniform(k_a, (), minval=min_a, maxval=max_a)
    d = jnp.round(jnp.cbrt(num_keep))
    h = jnp.round(d * ar)
    w = jnp.round(d / ar)
    d = jnp.clip(d, 1, gd).astype(jnp.int32)
    h = jnp.clip(h, 1, gh).astype(jnp.int32)
    w = jnp.clip(w, 1, gw).astype(jnp.int32)
    return d, h, w


def vjepa_target_mask(key: jax.Array, batch: int, *,
                      grid: Tuple[int, int, int],
                      pred_mask_scale: Tuple[float, float] = (0.2, 0.8),
                      aspect_ratio: Tuple[float, float] = (0.3, 3.0),
                      num_blocks: int = 3,
                      inv_block: bool = False,
                      full_complement: bool = False,
                      pred_full_complement: bool = False,
                      max_keep: int | None = None) -> jax.Array:
    """Multi-block 3D mask. Returns (batch, N) bool, True = target (to be
    predicted); context = ~target. One block size per sample, ``num_blocks``
    random placements (union), exactly as the reference. inv_block swaps
    context and target (transforms.py:210-215).

    Option parity with VJEPAMaskGenerator (transforms.py:109-217):

    - ``full_complement`` / ``pred_full_complement`` ask for target =
      complement(context) / context = complement(target). In this dense
      boolean formulation both hold *by construction* (context is defined
      as ~target), so the flags are accepted as no-ops. (The reference's
      own branches at transforms.py:198-204 can never run: they call
      ``torch.tensor(set(...))``, which raises TypeError — and even as
      intended they recompute the complement that argwhere/nonzero at
      :194-196 already produced.)
    - ``max_keep`` truncates BOTH index lists to their first ``max_keep``
      entries (transforms.py:207-209), leaving tokens beyond the cut in a
      third 'dropped' state that a dense context=~target boolean cannot
      represent. It is therefore rejected here; use ``mask_to_indices``
      (the index-list parity form consumed by the predictor's
      context_mask/target_mask path) which implements it exactly.
    """
    if max_keep is not None:
        raise ValueError(
            "max_keep drops tokens from both the context and target index "
            "lists (reference transforms.py:207-209), which the dense "
            "boolean mask cannot represent (context is defined as ~target)."
            " Use mask_to_indices(mask_row, max_keep=...) and the model's "
            "context_mask/target_mask index-list path instead.")
    del full_complement, pred_full_complement  # no-ops: see docstring
    gd, gh, gw = grid

    def one(k):
        k_dims, k_pos = jax.random.split(k)
        d, h, w = _sample_block_dims(k_dims, grid, pred_mask_scale,
                                     aspect_ratio)
        di = jax.lax.broadcasted_iota(jnp.int32, (gd, gh, gw), 0)
        hi = jax.lax.broadcasted_iota(jnp.int32, (gd, gh, gw), 1)
        wi = jax.lax.broadcasted_iota(jnp.int32, (gd, gh, gw), 2)

        def block(kb):
            ks = jax.random.split(kb, 3)
            # randint(0, dim - size + 1) with traced bound
            sd = jnp.floor(jax.random.uniform(ks[0]) *
                           (gd - d + 1).astype(jnp.float32)).astype(jnp.int32)
            sh = jnp.floor(jax.random.uniform(ks[1]) *
                           (gh - h + 1).astype(jnp.float32)).astype(jnp.int32)
            sw = jnp.floor(jax.random.uniform(ks[2]) *
                           (gw - w + 1).astype(jnp.float32)).astype(jnp.int32)
            return ((di >= sd) & (di < sd + d) &
                    (hi >= sh) & (hi < sh + h) &
                    (wi >= sw) & (wi < sw + w))

        keys = jax.random.split(k_pos, num_blocks)
        covered = jnp.zeros((gd, gh, gw), bool)
        for i in range(num_blocks):
            covered = covered | block(keys[i])
        return covered.reshape(-1)

    out = jax.vmap(one)(jax.random.split(key, batch))
    return ~out if inv_block else out


def mask_to_indices(mask_bool, max_keep: int | None = None, *,
                    full_complement: bool = False,
                    pred_full_complement: bool = False,
                    max_len: int | None = None):
    """Host-side helper (NOT jit): convert a boolean mask row to the
    reference's index-list form (context_mask / target_mask index arrays,
    transforms.py:192-215). Used for API-parity paths and tests.

    ``max_keep`` matches VJEPAMaskGenerator exactly (transforms.py:207-209):
    both lists are truncated to their first ``max_keep`` entries, in
    ascending token order (argwhere/nonzero order). ``max_len`` is the
    pre-round-5 name for the same knob, kept as an alias.

    ``full_complement`` / ``pred_full_complement`` are accepted as no-ops:
    context and target here are exact complements by construction, which is
    what those flags request (the reference's own branches at
    transforms.py:198-204 raise TypeError via ``torch.tensor(set(...))``).
    """
    import numpy as np

    del full_complement, pred_full_complement  # no-ops: see docstring
    if max_keep is None:
        max_keep = max_len
    mask_bool = np.asarray(mask_bool)
    target = np.nonzero(mask_bool)[0]
    context = np.nonzero(~mask_bool)[0]
    if max_keep is not None:
        target = target[:max_keep]
        context = context[:max_keep]
    return context, target
