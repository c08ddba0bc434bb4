"""Model configurations.

Field names deliberately mirror the HuggingFace configs used by the reference
(`/root/reference/src/models/videomae/modeling_videomae.py`,
`/root/reference/src/models/vjepa/configuration_vjepa.py:97-151`,
`/root/reference/src/models/dinov2/modeling_dinov2.py`) so that published
checkpoints (e.g. ``standardmodelbio/smb-vision-base``) can be converted
weight-for-weight, and so JSON config files round-trip.

These are plain dataclasses: everything downstream is functional JAX, and a
config is static metadata captured in the jit trace.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

# attention implementations a config may name; "auto" picks by platform,
# dtype and head dim (ops/attention.py::attention_backend)
ATTN_IMPLS = ("auto", "xla")
# kernel selectors of earlier releases; a saved config or a config file
# that still names them loads with the field dropped (see legacy_fields)
_REMOVED_FIELDS = ("mlp_impl", "glue_impl", "teacher_attn_impl")


def legacy_fields(d: dict, source: str = "config") -> dict:
    """Copy of `d` with removed kernel selectors dropped and a removed
    attention kernel (`attn_impl` "pallas*") reset to "auto",
    with one warning per field. Command-line values are not passed through
    here: there the removed values are rejected as unknown."""
    d = dict(d)
    for k in _REMOVED_FIELDS:
        if k in d:
            warnings.warn(f"{source}: dropping removed field {k}="
                          f"{d.pop(k)!r}", stacklevel=2)
    if str(d.get("attn_impl", "auto")).startswith("pallas"):
        warnings.warn(f"{source}: attn_impl={d['attn_impl']!r} was removed; "
                      "using 'auto'", stacklevel=2)
        d["attn_impl"] = "auto"
    return d


def _tuple3(v) -> Tuple[int, int, int]:
    if isinstance(v, (list, tuple)):
        if len(v) == 3:
            return tuple(int(x) for x in v)
        raise ValueError(f"expected 3 elements, got {v}")
    return (int(v),) * 3


def check_attn_impl(impl: str) -> str:
    if impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attention impl {impl!r}; valid: "
                         + ", ".join(repr(v) for v in ATTN_IMPLS))
    return impl


@dataclass
class BaseConfig:
    def __post_init__(self):
        check_attn_impl(getattr(self, "attn_impl", "auto"))

    def update(self, updates: dict) -> "BaseConfig":
        """HF-style in-place update; unknown keys are ignored with the same
        permissiveness as PretrainedConfig.update."""
        names = {f.name for f in dataclasses.fields(self)}
        for k, v in updates.items():
            if k in names:
                setattr(self, k, v)
        check_attn_impl(getattr(self, "attn_impl", "auto"))
        return self

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["model_type"] = getattr(self, "model_type", "")
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "BaseConfig":
        names = {f.name for f in dataclasses.fields(cls)}
        d = legacy_fields(d, cls.__name__)
        return cls(**{k: v for k, v in d.items() if k in names})

    @classmethod
    def from_json(cls, path: str) -> "BaseConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2, sort_keys=True)


@dataclass
class VideoMAEConfig(BaseConfig):
    """3D ViT used for SimMIM-style masked pretraining and classification.

    The reference reinterprets HF VideoMAE for CT volumes: depth-as-frames
    with ``tubelet_size == patch_size`` giving cubic 16^3 patches
    (reference run_mim.py:322-330).
    """

    model_type: str = "videomae"

    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 1
    num_frames: int = 160          # volume depth
    tubelet_size: int = 16

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    qkv_bias: bool = True
    use_mean_pooling: bool = True

    # decoder (pretraining)
    decoder_num_attention_heads: int = 6
    decoder_hidden_size: int = 384
    decoder_num_hidden_layers: int = 4
    decoder_intermediate_size: int = 1536
    norm_pix_loss: bool = True

    # classification head
    num_labels: int = 2
    problem_type: Optional[str] = None
    additional_features_size: int = 0

    # framework knobs (not in HF config)
    dtype: str = "bfloat16"         # compute dtype
    attn_impl: str = "auto"         # auto | xla
    # one wide QKV matmul instead of three narrow ones (A/B knob; XLA's
    # dot-merger already coalesces the narrow dots)
    fused_qkv: bool = False
    gradient_checkpointing: bool = False
    # shard the token dimension over the mesh "model" axis; attention runs
    # per shard (all-gather-kv CP or ring attention)
    sequence_parallel: bool = False
    sp_variant: str = "gather"      # gather (all-gather kv) | ring
    # W8A8 transformer projections as int8 matmuls (inference only: the
    # quantization round is not differentiable)
    quant8: bool = False

    @property
    def grid(self) -> Tuple[int, int, int]:
        """(T', H', W') patch-grid dims; sequence index = t*H'*W' + h*W' + w."""
        return (
            self.num_frames // self.tubelet_size,
            self.image_size // self.patch_size,
            self.image_size // self.patch_size,
        )

    @property
    def seq_len(self) -> int:
        t, h, w = self.grid
        return t * h * w

    @property
    def patch_dim(self) -> int:
        return self.num_channels * self.tubelet_size * self.patch_size**2


@dataclass
class VJEPA2Config(BaseConfig):
    """V-JEPA2 (encoder + predictor) for 3D volumes.

    Mirrors reference configuration_vjepa.py:97-151; run_vjepa.py:221-233 sets
    in_chans=1, crop_size=384, frames_per_clip=256, tubelet_size=patch_size.
    """

    model_type: str = "vjepa2"

    patch_size: int = 16
    crop_size: int = 256
    frames_per_clip: int = 64
    tubelet_size: int = 2
    in_chans: int = 3

    hidden_size: int = 1024
    num_attention_heads: int = 16
    num_hidden_layers: int = 24
    drop_path_rate: float = 0.0
    mlp_ratio: float = 4.0
    layer_norm_eps: float = 1e-6
    qkv_bias: bool = True
    attention_probs_dropout_prob: float = 0.0
    hidden_act: str = "gelu"
    initializer_range: float = 0.02
    attention_dropout: float = 0.0
    num_pooler_layers: int = 3

    # predictor
    pred_hidden_size: int = 384
    pred_num_attention_heads: int = 12
    pred_num_hidden_layers: int = 12
    pred_num_mask_tokens: int = 10
    pred_zero_init_mask_tokens: bool = True
    pred_mlp_ratio: float = 4.0

    # classification
    num_labels: int = 2

    # framework knobs
    dtype: str = "bfloat16"
    attn_impl: str = "auto"
    fused_qkv: bool = False         # A/B knob, see VideoMAEConfig
    gradient_checkpointing: bool = False
    sequence_parallel: bool = False
    sp_variant: str = "gather"      # gather (all-gather kv) | ring

    @property
    def grid(self) -> Tuple[int, int, int]:
        g = self.crop_size // self.patch_size
        return (self.frames_per_clip // self.tubelet_size, g, g)

    @property
    def seq_len(self) -> int:
        t, h, w = self.grid
        return t * h * w

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def pred_head_dim(self) -> int:
        return self.pred_hidden_size // self.pred_num_attention_heads


@dataclass
class SiglipVisionConfig(BaseConfig):
    """SigLIP vision tower (2D X-ray embeddings — the reference runs the
    torch SiglipVisionModel on GPU via run_siglip.py:49-56; here it is a
    first-party model on the JAX compute path). Field names mirror
    transformers.SiglipVisionConfig so local HF checkpoints convert
    weight-for-weight (models/convert.py::convert_hf_siglip)."""

    model_type: str = "siglip_vision_model"

    image_size: int = 384
    patch_size: int = 16
    num_channels: int = 3

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu_pytorch_tanh"
    layer_norm_eps: float = 1e-6
    attention_dropout: float = 0.0
    # MAP pooling head (probe cross-attn + MLP); pooler_output path
    vision_use_head: bool = True

    # framework knobs
    dtype: str = "bfloat16"
    attn_impl: str = "auto"
    gradient_checkpointing: bool = False

    @property
    def grid(self) -> Tuple[int, int]:
        g = self.image_size // self.patch_size
        return (g, g)

    @property
    def seq_len(self) -> int:
        h, w = self.grid
        return h * w


@dataclass
class Dinov2Config(BaseConfig):
    """DINOv2 adapted to 3D (Conv3d patch embed + learned 3D pos-emb),
    per reference modeling_dinov2.py:121-158. The reference's trilinear
    position-interpolation bug (hard-coded `(1,224,244,160)` shape at :85)
    is fixed here by deriving the grid from the config."""

    model_type: str = "dinov2"

    image_size: int = 224
    patch_size: int = 16
    num_channels: int = 1
    depth: int = 160                # volume depth

    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    mlp_ratio: int = 4
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.0
    attention_probs_dropout_prob: float = 0.0
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-6
    qkv_bias: bool = True
    layerscale_value: float = 1.0
    drop_path_rate: float = 0.0
    use_swiglu_ffn: bool = False
    use_mask_token: bool = True     # masked-embedding path (ref :99-118)

    num_labels: int = 2
    problem_type: Optional[str] = None
    additional_features_size: int = 0

    dtype: str = "bfloat16"
    attn_impl: str = "auto"
    fused_qkv: bool = False         # A/B knob, see VideoMAEConfig
    gradient_checkpointing: bool = False

    @property
    def grid(self) -> Tuple[int, int, int]:
        # DINOv2's token order is (h, w, d) — h-major, depth FASTEST
        # (models/dinov2.py::_patchify_chw; the dinov2 pipeline feeds
        # (B, C, H, W, D) unpermuted) — unlike the depth-major (t, h, w)
        # grids of VideoMAE/VJEPA2. Consumers that reorder by grid (e.g.
        # sliding-window token weights, pos-emb resize) must use THIS
        # order.
        return (
            self.image_size // self.patch_size,
            self.image_size // self.patch_size,
            self.depth // self.patch_size,
        )

    @property
    def seq_len(self) -> int:
        h, w, d = self.grid
        return h * w * d  # patches; +1 CLS handled by the model


@dataclass
class ResNet3DConfig(BaseConfig):
    """Inflated-3D (I3D) ResNet — the Merlin CT foundation model's image
    tower is an inflated ResNet-152 (reference src/encoders/run_merlin.py:24
    loads `Merlin(ImageEmbedding=True)`, whose forward returns a
    (batch, tokens, dim) embedding per run_merlin.py:45-48). The reference
    outsources the architecture to the external `merlin` package (its own
    import of it was broken, SURVEY §2 item 16); here the tower is a
    first-party model on the JAX compute path.

    Geometry convention (matches torch Conv3d semantics so torch
    checkpoints convert weight-for-weight): the three volume axes are
    (a0, a1, a2) in checkpoint order — for the merlin CT pipeline that is
    (H, W, D) = (224, 224, 160), layout "CHWD". Per-element temporal
    (axis-0) kernel sizes are NOT fixed here: they are read from the
    checkpoint weight shapes at conversion time
    (models/convert.py::resnet3d_config_from_state_dict). Axis-0 strides
    cannot be read from weights, so they are explicit config fields with
    the standard I3D-inflation defaults (stem/pool stride follows the
    spatial stride; bottleneck conv2 axis-0 stride mirrors its spatial
    stride)."""

    model_type: str = "resnet3d"

    num_channels: int = 1
    # bottleneck blocks per stage; (3, 8, 36, 3) == ResNet-152
    stage_sizes: Tuple[int, ...] = (3, 8, 36, 3)
    base_width: int = 64            # stem channels; stage c = base * 2**i
    expansion: int = 4              # bottleneck out = width * expansion

    # stem: conv (stem_kernel_t, 7, 7) stride (stem_stride_t, 2, 2),
    # torch-style symmetric padding (k//2 per axis), then max-pool
    # (pool_kernel_t, 3, 3) stride (pool_stride_t, 2, 2) pad (k_t//2, 1, 1)
    stem_kernel_t: int = 7
    stem_stride_t: int = 2
    pool_kernel_t: int = 3
    pool_stride_t: int = 2
    # bottleneck conv2 axis-0 kernel (the I3D "inflated" 3x3); read from
    # checkpoints on conversion, default 3
    conv2_kernel_t: int = 3
    # whether a stage's downsampling stride also applies to axis 0
    # (hassony2-style I3D inflation: time_stride = spatial_stride)
    temporal_downsample: bool = True

    bn_eps: float = 1e-5

    num_labels: int = 0             # 0 = no classifier head (encoder)

    dtype: str = "bfloat16"

    @property
    def hidden_size(self) -> int:
        return self.base_width * (2 ** (len(self.stage_sizes) - 1)) \
            * self.expansion
