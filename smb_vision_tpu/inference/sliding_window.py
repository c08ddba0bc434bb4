"""Sliding-window inference/embedding over arbitrary-size volumes.

JAX rework of the reference's vendored MONAI engine
(/root/reference/src/inference.py:43-322 `sliding_window_inference`,
:325-438 `sliding_window_embed`):

- dense overlapping 3D windows with the same scan-interval math
  (interval = roi * (1-overlap), clipped; final window snapped inside)
- gaussian / constant importance-map blending
- every window has the SAME static shape -> one jit-compiled window batch
  function, windows processed in fixed-size batches via dynamic_slice

`sliding_window_embed` returns per-window embeddings (B, num_windows, L, D)
or mean-pooled (B, num_windows, D) plus window start coordinates. (The
reference's version was unwired and its importance-weighted accumulation
never ran with consistent shapes; this is the working equivalent of its
documented contract: "accumulates per-window embeddings weighted by
importance map, normalised by count map".)
"""

from __future__ import annotations

import functools
import itertools
import math
import weakref
from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


def scan_interval(image_size: Sequence[int], roi_size: Sequence[int],
                  overlap: Sequence[float] | float) -> Tuple[int, ...]:
    """interval = roi * (1 - overlap) per dim; 0 (single position) when the
    roi covers the whole dim (matches _get_scan_interval,
    reference inference.py:480-497)."""
    if not isinstance(overlap, (tuple, list)):
        overlap = [overlap] * len(roi_size)
    out = []
    for im, roi, ov in zip(image_size, roi_size, overlap):
        if roi == im:
            out.append(im)
        else:
            out.append(max(int(roi * (1 - ov)), 1))
    return tuple(out)


def dense_window_starts(image_size: Sequence[int], roi_size: Sequence[int],
                        interval: Sequence[int]) -> np.ndarray:
    """Start coordinates of all windows (num_windows, ndim); the last
    window of each dim is clamped so it stays inside the volume (MONAI
    dense_patch_slices semantics)."""
    per_dim = []
    for im, roi, iv in zip(image_size, roi_size, interval):
        n = max(int(math.ceil((im - roi) / iv)) + 1, 1) if iv else 1
        starts = [min(i * iv, im - roi) for i in range(n)]
        # dedupe while preserving order (clamping can collide)
        seen, uniq = set(), []
        for s in starts:
            if s not in seen:
                seen.add(s)
                uniq.append(s)
        per_dim.append(uniq)
    return np.array(list(itertools.product(*per_dim)), dtype=np.int32)


def importance_map(roi_size: Sequence[int], mode: str = "constant",
                   sigma_scale: float = 0.125) -> jnp.ndarray:
    """Blending weights per voxel of a window (constant ones or a centred
    gaussian, sigma = sigma_scale * dim)."""
    if mode == "constant":
        return jnp.ones(tuple(roi_size), jnp.float32)
    if mode != "gaussian":
        raise ValueError(f"unknown blend mode {mode}")
    grids = []
    for d in roi_size:
        center = (d - 1) / 2.0
        sigma = max(d * sigma_scale, 1e-3)
        x = (np.arange(d) - center) / sigma
        grids.append(np.exp(-0.5 * x * x))
    out = np.einsum("i,j,k->ijk", *grids).astype(np.float32)
    out = np.maximum(out, out.max() * 1e-3)
    return jnp.asarray(out)


def _pad_to_min(volume: jnp.ndarray, roi_size, cval: float):
    """Symmetric pad so every spatial dim >= roi (reference :377-384)."""
    spatial = volume.shape[2:]
    pads = [(0, 0), (0, 0)]
    for cur, roi in zip(spatial, roi_size):
        extra = max(roi - cur, 0)
        pads.append((extra // 2, extra - extra // 2))
    if any(p != (0, 0) for p in pads):
        volume = jnp.pad(volume, pads, constant_values=cval)
    return volume


def token_weights(roi_size: Sequence[int], num_tokens: int,
                  mode: str = "constant", sigma_scale: float = 0.125,
                  token_grid: Optional[Sequence[int]] = None) -> jnp.ndarray:
    """Per-token blending weights (L,): the voxel importance map average-
    pooled over each token's patch.

    The weight vector follows the MODEL token order — index
    t*H'*W' + h*W' + w (depth-major, models/configs grid convention) —
    while roi_size is spatial (H, W, D). token_grid is (T', H', W') as
    returned by config.grid; when omitted a cubic patch is inferred from
    num_tokens (only valid when every axis shares one patch size)."""
    if mode == "constant":
        return jnp.ones((num_tokens,), jnp.float32)
    if token_grid is None:
        # infer a cubic patch: p such that prod(roi/p) == num_tokens
        vox_per_token = int(np.prod(roi_size)) / num_tokens
        p = round(vox_per_token ** (1 / 3))
        if p <= 0 or any(r % p for r in roi_size):
            raise ValueError(
                f"cannot infer a regular token grid for roi {tuple(roi_size)}"
                f" with {num_tokens} tokens; pass token_grid=(T', H', W')")
        token_grid = (roi_size[2] // p, roi_size[0] // p, roi_size[1] // p)
    tt, th, tw = token_grid
    if tt * th * tw != num_tokens:
        raise ValueError(f"token grid {tuple(token_grid)} covers "
                         f"{tt * th * tw} tokens, not {num_tokens}")
    imap = np.asarray(importance_map(roi_size, mode, sigma_scale))
    ph, pw, pt = (roi_size[0] // th, roi_size[1] // tw, roi_size[2] // tt)
    # pool (H, W, D) voxels per token, then reorder to depth-major (t, h, w)
    w = imap.reshape(th, ph, tw, pw, tt, pt).mean(axis=(1, 3, 5))
    w = w.transpose(2, 0, 1)                     # (T', H', W')
    return jnp.asarray(w.reshape(-1), jnp.float32)


def sliding_window_embed(volume: jnp.ndarray, roi_size: Sequence[int],
                         embedder: Callable[[jnp.ndarray], jnp.ndarray],
                         *, overlap: float = 0.25, sw_batch_size: int = 1,
                         mode: str = "constant", sigma_scale: float = 0.125,
                         cval: float = 0.0, pool: bool = False,
                         token_grid: Optional[Sequence[int]] = None,
                         state=None):
    """volume: (B, C, H, W, D). embedder: (N, C, *roi) -> (N, L, D).

    state: optional pytree (typically model params) threaded through the
    internal jit as a real argument — `embedder(state, wins)` is called
    instead of `embedder(wins)`. Without it, params captured in the
    embedder closure are inlined into the compiled program as constants
    (hundreds of MB for ViT-Base, copied into every executable).

    Returns (embeddings, starts):
      embeddings: (B, num_windows, L, D)   [or (B, num_windows, D) if pool]
      starts:     (num_windows, 3) window start coords in the padded volume

    mode="gaussian" applies the reference's importance weighting
    (/root/reference/src/inference.py:325-438) at token granularity: each
    token is weighted by the mean gaussian weight of the voxels it covers
    (token_weights). With pool=True the window embedding becomes the
    weighted mean over tokens (centre tokens dominate); without pooling the
    tokens are scaled mean-preservingly (weights normalised to mean 1).
    mode="constant" is exact passthrough."""
    b = volume.shape[0]
    spatial_in = volume.shape[2:]
    padded = tuple(max(s, r) for s, r in zip(spatial_in, roi_size))
    interval = scan_interval(padded, roi_size, overlap)
    starts = dense_window_starts(padded, roi_size, interval)
    n_win = len(starts)

    # chunk starts on the HOST (numpy): the whole pipeline below runs as
    # ONE jit call — a host-side loop of jit calls pays dispatch per chunk
    n_chunks = -(-n_win // sw_batch_size)
    pad_n = n_chunks * sw_batch_size - n_win
    starts_np = np.concatenate(
        [starts, np.tile(starts[-1:], (pad_n, 1))]) if pad_n else starts
    chunked = jnp.asarray(starts_np.reshape(n_chunks, sw_batch_size, 3))

    # per-token weights: only the gaussian branch needs them. Token count
    # comes from token_grid when given; the eval_shape fallback re-traces
    # the whole model (seconds of host time per call), so avoid it when
    # possible.
    if mode == "constant":
        w = jnp.zeros((0,), jnp.float32)              # unused in run_all
    else:
        if token_grid is not None:
            num_tokens = int(np.prod(token_grid))
        else:
            probe = jax.ShapeDtypeStruct(
                (sw_batch_size * b, volume.shape[1], *roi_size),
                volume.dtype)
            eshape = (jax.eval_shape(embedder, probe) if state is None
                      else jax.eval_shape(embedder, state, probe))
            num_tokens = eshape.shape[1]
        w = token_weights(roi_size, num_tokens, mode, sigma_scale,
                          token_grid)

    run_all = _build_sw_runner(embedder, tuple(roi_size), n_chunks,
                               sw_batch_size, n_win, mode, pool,
                               float(cval))
    return run_all(state, volume, chunked, w), starts


# one jitted runner per (embedder, geometry): the outer map holds the
# embedder WEAKLY, so a short-lived closure's jitted executables (and any
# params it captured) are freed with it instead of pinning up to 32 entries
# the way a plain lru_cache would; the inner per-embedder dict is keyed on
# geometry. Callers that want cache hits across volumes must pass a
# LONG-LIVED embedder callable (as cli/run_inference.py does) — a fresh
# lambda per call compiles fresh every time.
_SW_RUNNERS = weakref.WeakKeyDictionary()


def _cached_runner(fn, geo, make):
    """Memoise a jitted runner per (callable, geometry) — weak on the
    callable (see _SW_RUNNERS note above)."""
    try:
        per_fn = _SW_RUNNERS.setdefault(fn, {})
    except TypeError:          # non-weakrefable callable: no caching
        return make()
    if geo not in per_fn:
        per_fn[geo] = make()
    return per_fn[geo]


def _build_sw_runner(embedder, roi_size, n_chunks, sw_batch_size, n_win,
                     mode, pool, cval):
    geo = ("swe", roi_size, n_chunks, sw_batch_size, n_win, mode, pool,
           cval)
    return _cached_runner(
        embedder, geo,
        lambda: _make_sw_runner(embedder, roi_size, n_chunks,
                                sw_batch_size, n_win, mode, pool, cval))


def _make_sw_runner(embedder, roi_size, n_chunks, sw_batch_size, n_win,
                    mode, pool, cval):

    def get_window(vol, s):
        return jax.lax.dynamic_slice(
            vol, (0, 0, s[0], s[1], s[2]),
            (vol.shape[0], vol.shape[1], *roi_size))

    @jax.jit
    def run_all(state, vol, chunked_starts, w):
        vol = _pad_to_min(vol, roi_size, cval)

        def body(batch_starts):
            wins = jax.vmap(lambda s: get_window(vol, s))(batch_starts)
            # (nw, B, C, *roi) -> (nw*B, C, *roi)
            nw = wins.shape[0]
            flat = wins.reshape((nw * vol.shape[0],) + wins.shape[2:])
            emb = embedder(flat) if state is None else embedder(state, flat)
            return emb.reshape(nw, vol.shape[0], *emb.shape[1:])

        emb = jax.lax.map(body, chunked_starts)   # (nc, nw, B, L, D)
        emb = emb.reshape(n_chunks * sw_batch_size, *emb.shape[2:])[:n_win]
        emb = jnp.swapaxes(emb, 0, 1)             # (B, n_win, L, D)
        if mode == "constant":
            return emb.mean(axis=2) if pool else emb
        if pool:
            return jnp.einsum("bwld,l->bwd", emb, w / jnp.sum(w))
        return emb * (w / jnp.mean(w))[None, None, :, None]

    return run_all


def sliding_window_inference(volume: jnp.ndarray, roi_size: Sequence[int],
                             predictor: Callable[[jnp.ndarray], jnp.ndarray],
                             *, overlap: float = 0.25,
                             sw_batch_size: int = 1,
                             mode: str = "constant",
                             sigma_scale: float = 0.125,
                             cval: float = 0.0,
                             state=None) -> jnp.ndarray:
    """Dense voxel-space variant: predictor maps (N, C, *roi) ->
    (N, C', *roi); overlapping windows are blended with the importance map
    and normalised by the accumulated count map, then cropped back to the
    input spatial size. `state` as in sliding_window_embed: an optional
    pytree passed through the jit so model params are real arguments
    (predictor(state, win)) rather than baked-in constants."""
    b, c_in = volume.shape[:2]
    orig_spatial = volume.shape[2:]
    padded = tuple(max(s, r) for s, r in zip(orig_spatial, roi_size))
    interval = scan_interval(padded, roi_size, overlap)
    starts = dense_window_starts(padded, roi_size, interval)
    n_win = len(starts)

    # output channel count without running the model (an eager probe call
    # would be a full device computation)
    zwin = jax.ShapeDtypeStruct((sw_batch_size * b, c_in, *roi_size),
                                volume.dtype)
    eshape = (jax.eval_shape(predictor, zwin) if state is None
              else jax.eval_shape(predictor, state, zwin))
    c_out = eshape.shape[1]

    n_chunks = -(-n_win // sw_batch_size)
    pad_n = n_chunks * sw_batch_size - n_win
    # padded entries repeat the last start but are masked out of the
    # accumulation (double-counting a window would bias the weighted
    # average wherever windows overlap)
    starts_np = np.concatenate(
        [starts, np.tile(starts[-1:], (pad_n, 1))]) if pad_n else starts
    chunked = jnp.asarray(starts_np.reshape(n_chunks, sw_batch_size, 3))
    valid_np = (np.arange(n_chunks * sw_batch_size) < n_win).astype(
        np.float32).reshape(n_chunks, sw_batch_size)
    valid = jnp.asarray(valid_np)
    imap = importance_map(roi_size, mode, sigma_scale)

    # the jitted runner is cached per (predictor, geometry) like the embed
    # path — a fresh @jax.jit closure per call would recompile for EVERY
    # volume
    geo = ("swi", tuple(roi_size), b, c_in, c_out, sw_batch_size,
           float(cval), tuple(orig_spatial))
    run = _cached_runner(
        predictor, geo,
        lambda: _make_swi_runner(predictor, tuple(roi_size), b, c_in,
                                 c_out, sw_batch_size, float(cval),
                                 tuple(orig_spatial)))
    return run(state, volume, chunked, valid, imap)


def _make_swi_runner(predictor, roi_size, b, c_in, c_out, sw_batch_size,
                     cval, orig_spatial):
    @jax.jit
    def run(st, vol, chunked_starts, valid, imap):
        vol = _pad_to_min(vol, roi_size, cval)
        spatial = vol.shape[2:]
        out0 = jnp.zeros((b, c_out, *spatial), jnp.float32)
        cnt0 = jnp.zeros((1, 1, *spatial), jnp.float32)

        def body(carry, xs):
            batch_starts, vmask = xs
            out, cnt = carry
            wins = jax.vmap(lambda s: jax.lax.dynamic_slice(
                vol, (0, 0, s[0], s[1], s[2]),
                (b, c_in, *roi_size)))(batch_starts)     # (nw, b, C, *roi)
            flat = wins.reshape((sw_batch_size * b, c_in) + tuple(roi_size))
            p = predictor(flat) if st is None else predictor(st, flat)
            p = p.reshape(sw_batch_size, b, c_out, *roi_size)
            p = p.astype(jnp.float32) * imap
            # scatter each window's contribution sequentially (windows in
            # a chunk may overlap, so the updates cannot be merged)
            for w in range(sw_batch_size):
                s = batch_starts[w]
                out = jax.lax.dynamic_update_slice(
                    out, jax.lax.dynamic_slice(
                        out, (0, 0, s[0], s[1], s[2]),
                        (b, c_out, *roi_size)) + p[w] * vmask[w],
                    (0, 0, s[0], s[1], s[2]))
                cnt = jax.lax.dynamic_update_slice(
                    cnt, jax.lax.dynamic_slice(
                        cnt, (0, 0, s[0], s[1], s[2]), (1, 1, *roi_size))
                    + imap[None, None] * vmask[w],
                    (0, 0, s[0], s[1], s[2]))
            return (out, cnt), None

        (out, cnt), _ = jax.lax.scan(body, (out0, cnt0),
                                     (chunked_starts, valid))
        out = out / (cnt + 1e-8)
        crops = []
        for cur, orig in zip(spatial, orig_spatial):
            start = (cur - orig) // 2
            crops.append(slice(start, start + orig))
        return out[(slice(None), slice(None), *crops)]

    return run
