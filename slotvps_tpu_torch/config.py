"""Typed configuration for the whole framework.

Collapses the reference's three config mechanisms — mmcv python configs
(reference configs/cityscapes/r50_fpn_slotvps.py), the legacy UPSNet
EasyDict+YAML singleton (reference tools/config/config.py:20-176,
configs/cityscapes/test_cityscapes_1gpu.yaml), and per-tool argparse — into
one tree of frozen dataclasses.  Knob names follow the reference so that a
reference user can map their settings 1:1.

Everything is hashable so configs can be passed as jit static args.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def _frozen(cls):
    return dataclasses.dataclass(frozen=True)(cls)


@_frozen
class ResNetConfig:
    """ResNet backbone (reference mmdet/models/backbones/resnet.py:338).

    ``norm_eval=True`` + ``frozen_stages=1`` in the reference mean all batch
    norms run with checkpoint statistics at test time; we fold them into
    per-channel scale/bias (see models/resnet.py).
    """

    depth: int = 50
    num_stages: int = 4
    out_indices: Tuple[int, ...] = (0, 1, 2, 3)
    frozen_stages: int = 1
    # 'pytorch' style: stride-2 lives on the 3x3 conv of each bottleneck
    # (reference resnet.py Bottleneck, style='pytorch').
    style: str = "pytorch"
    # per-stage plugins (reference resnet.py:152-211; both shipped configs
    # leave them off): DCN replaces each bottleneck's 3x3 conv, GCNet
    # context block runs after bn3
    dcn_stages: Tuple[bool, bool, bool, bool] = (False, False, False, False)
    gcb_stages: Tuple[bool, bool, bool, bool] = (False, False, False, False)
    gcb_ratio: float = 1.0 / 16
    # R52 stem variant (reference resnet.py:421-424 ``turn_into_r52`` +
    # :472-515 ``_make_stem_layer``): replaces the 7x7/2 stem conv with
    # three 3x3 convs (3->64 s2, 64->64, 64->128), each BN+ReLU, so
    # stage 1 sees 128 input channels. Config-off in both shipped
    # reference configs; provided for inventory parity.
    r52_stem: bool = False


@_frozen
class SwinConfig:
    """Swin Transformer backbone (reference
    mmdet/models/backbones/swin_transformer.py:449; Swin-L settings from
    configs/cityscapes/swinL_fpn_slotvps.py:6-20)."""

    embed_dim: int = 192
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    num_heads: Tuple[int, ...] = (6, 12, 24, 48)
    window_size: int = 7
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    patch_size: int = 4
    # no `ape` knob: both shipped configs set ape=False
    # (swinL_fpn_slotvps.py:17), so absolute position embeddings are
    # deliberately not implemented.
    patch_norm: bool = True
    out_indices: Tuple[int, ...] = (0, 1, 2, 3)
    # stochastic depth for training; applied only when apply_swin gets a
    # drop_path_key (swinL_fpn_slotvps.py:16 drop_path_rate=0.5)
    drop_path_rate: float = 0.5


@_frozen
class FPNConfig:
    """FPN neck (reference mmdet/models/necks/fpn.py:11)."""

    in_channels: Tuple[int, ...] = (256, 512, 1024, 2048)
    out_channels: int = 256
    num_outs: int = 5


@_frozen
class SemanticHeadConfig:
    """UPSNet-style FPN semantic head (reference
    mmdet/models/panoptic/upsnetFPN.py:11): a shared 3x(DCN+GN32+ReLU) tower
    applied to P2..P5, concat at 1/4 scale -> 1x1 conv -> num_classes logits,
    then x4 bilinear upsample (align_corners=True)."""

    in_channels: int = 256
    out_channels: int = 128
    num_levels: int = 4
    num_things_classes: int = 8
    num_classes: int = 19
    ignore_label: int = 255
    loss_weight: float = 0.5
    gn_groups: int = 32
    # 'jax' = the plain PyTorch DCN (ops/deform_conv.py, f32 sums);
    # 'pallas' = the bf16 Hopper kernel (csrc/deform_conv.cu, tensor cores,
    # f32 sums); 'pallas_f32' = the same kernel in f32.  The names are the
    # JAX package's.
    dcn_impl: str = "jax"
    # True: skip the x4 upsample and carry QUARTER-res fcn logits; the
    # fused postprocess upsamples+argmaxes them in one kernel
    # (csrc/postproc_v3.cu sseg_kernel) so the full-res [H, W, 19] tensor
    # never exists.  Exactness is preserved on every route:
    # non-fused/resized paths first upsample x4 then resize, matching the
    # reference staging.
    fused_sseg: bool = False
    # DCN sampling-halo radius in pixels: offsets beyond +-halo of a tap's
    # rigid position are clamped (the reference CUDA kernel is unbounded —
    # deform_conv_cuda_kernel.cu deformable_im2col).  0 = per-impl default
    # (8 for 'jax', 4 for the tuned 'pallas' kernel).  A per-level tuple
    # (P2..P5 order, len == num_levels) sets each pyramid level's halo
    # independently: fine levels need smaller sampling ranges than coarse
    # ones, and the halo bounds the window of input pixels a tap can reach
    # (the backward's dx pass in csrc/deform_conv.cu scans that window).
    # Checkpoint loading measures the max offset the converted conv_offset
    # heads emit on a calibration image PER LEVEL and auto-raises any level
    # that would clamp (utils/diagnostics.py).
    dcn_halo: "int | Tuple[int, ...]" = 0

    def level_halo(self, level: int) -> int:
        """Halo for pyramid level ``level`` (0 = P2 … num_levels-1 = P5)."""
        if isinstance(self.dcn_halo, tuple):
            return self.dcn_halo[level]
        return self.dcn_halo


@_frozen
class TemporalQueryAttentionConfig:
    """Video Retriever (reference TemporalSlotsHead,
    mmdet/models/detectors/dynamic_mask_head.py:465)."""

    d_model: int = 256
    dim_feedforward: int = 1024
    activation: str = "relu"
    softmax_dim: str = "slots"


@_frozen
class SlotHeadConfig:
    """Panoptic Retriever stack (reference MultiScaleDynamicMaskHead,
    mmdet/models/detectors/dynamic_mask_head.py:36)."""

    dh_dim: int = 256
    num_classes: int = 20  # 11 stuff + 8 things + 1 no-object
    dim_feedforward: int = 2048
    nhead: int = 8
    activation: str = "gelu"
    dh_num_heads: int = 7
    per_dh_num_heads: Tuple[int, ...] = (1, 2, 2, 2)
    feat_num_levels: int = 4
    merge_operation: str = "concat"
    trans_in_dim: int = 384
    use_focal: bool = True
    prior_prob: float = 0.01
    num_cls: int = 2
    num_reg: int = 2
    softmax_dim: str = "slots"
    temporal_query_attention: Optional[TemporalQueryAttentionConfig] = (
        TemporalQueryAttentionConfig()
    )
    apply_temporal_query_atten_stages: Tuple[int, ...] = (3, 4, 5, 6)
    # 'jax' = plain slot attention in the activations' dtype; 'pallas' =
    # the Hopper kernel (csrc/slot_attention.cu: bf16 in, f32 scores,
    # softmax and output).
    retriever_impl: str = "jax"


@_frozen
class TrackHeadConfig:
    """SimpleTrackHead (reference
    mmdet/models/detectors/simple_track_head.py:21)."""

    num_fcs_query: int = 2
    in_channels_query: int = 256
    query_matched_weight: float = 1.0


@_frozen
class PostprocessConfig:
    """Panoptic post-processing (reference PostProcessPanopticInstances,
    mmdet/models/detectors/vps_temporal_slots.py:528; values from
    configs/cityscapes/r50_fpn_slotvps.py:66-74)."""

    threshold: float = 0.85
    fraction_threshold: float = 0.03
    pixel_threshold: float = 0.4
    apply_mask_removal: bool = True
    apply_mask_removal_only_ins: bool = True
    use_mask_low_constant: bool = False
    filter_small_option: str = "4"  # '4' | '4_256' | '4096_256'
    num_classes: int = 20
    num_stuff: int = 11
    # 'jax' = the plain reference path; 'pallas' = the reference path with
    # its claim loop on the claim-scan kernel (csrc/claim_scan.cu); 'fused'
    # = the kernels of csrc/postproc_v3.cu (theta, claim, argmax, repair,
    # sseg), which never materialize the [H, W, K] upsampled mask stack
    impl: str = "jax"
    # dtype of the [H, W, K] upsampled mask stack: 'bfloat16' halves the
    # HBM traffic of every postproc pass (the stack is 800 MB in f32 at
    # 1024x2048x100); softmax accumulations stay f32.  Tuned/bench path
    # only — f32 for bit-parity work.
    stack_dtype: str = "float32"
    # Fused-impl detection capacity: the slot permutation puts every
    # valid (score>threshold, non-no-obj) slot in a contiguous prefix, so
    # when at most this many slots are valid the fixed full-resolution
    # passes (theta logsumexp, argmax/top-2, small-area recomputes) run
    # on a [detect_capacity, h, w] prefix instead of all
    # ``proposal_num`` slots — the postproc cost scales with detections
    # (at the production 0.85 threshold, typically 10-30 of 100 slots),
    # like the claim kernel already does.  EXACT: invalid slots
    # contribute nothing to any pass, and a ``lax.cond`` falls back to
    # the full-capacity pipeline whenever more slots are valid.
    # 0 disables.  Fused impl only.
    detect_capacity: int = 64


@_frozen
class ModelConfig:
    """Top-level model (reference VPS_Temporal_Slots,
    mmdet/models/detectors/vps_temporal_slots.py:39)."""

    backbone: str = "resnet"  # 'resnet' | 'swin'
    resnet: ResNetConfig = ResNetConfig()
    swin: SwinConfig = SwinConfig()
    fpn: FPNConfig = FPNConfig()
    semantic_head: SemanticHeadConfig = SemanticHeadConfig()
    slot_head: SlotHeadConfig = SlotHeadConfig()
    track_head: TrackHeadConfig = TrackHeadConfig()
    postprocess: PostprocessConfig = PostprocessConfig()
    # reference other_config (r50_fpn_slotvps.py:97-106)
    proposal_num: int = 100  # number of slot queries
    has_no_obj: bool = True
    # reference pos_config (r50_fpn_slotvps.py:99-102):
    # 'sine'|'v2' = PositionEmbeddingSine, 'learned'|'v3' = learned bins
    pos_embedding: str = "sine"
    pos_hidden_dim: int = 256
    test_forward_ref_img: bool = True
    # bfloat16 for backbone/decoder compute (params stay fp32).
    compute_dtype: str = "float32"

    def __post_init__(self):
        # the postprocessor's claim scan carries int8 pixel-ownership maps
        # (models/postprocess.py): silent corruption past 127 slots, so
        # fail at config time instead
        if self.proposal_num > 127 and self.postprocess.apply_mask_removal:
            raise ValueError(
                f"proposal_num={self.proposal_num} > 127 is not supported "
                "with apply_mask_removal (int8 ownership maps in the "
                "postprocessor claim scan)")
        if self.postprocess.detect_capacity < 0:
            raise ValueError(
                f"detect_capacity={self.postprocess.detect_capacity} must "
                "be >= 0 (0 disables the valid-prefix fast path)")

    @property
    def num_classes(self) -> int:
        return self.slot_head.num_classes

    @property
    def stuff_num(self) -> int:
        # reference vps_temporal_slots.py:62-74
        if self.num_classes <= 20:
            return 11  # Cityscapes
        if self.num_classes in (46, 47):
            return 34  # Mapillary Vistas
        if self.num_classes in (23, 24):
            return 13  # VIPER
        raise ValueError(f"unsupported num_classes: {self.num_classes}")

    def fpn_in_channels(self) -> Tuple[int, ...]:
        if self.backbone == "resnet":
            # BasicBlock (18/34) has expansion 1, Bottleneck (50+) 4
            expansion = 4 if self.resnet.depth >= 50 else 1
            return tuple(64 * expansion * 2 ** i for i in range(4))
        dim = self.swin.embed_dim
        return (dim, dim * 2, dim * 4, dim * 8)


@_frozen
class EvalConfig:
    """Evaluation-protocol constants (reference
    configs/cityscapes/test_cityscapes_1gpu.yaml + tools/dataset/*)."""

    num_classes: int = 9  # UPSNet-legacy count: 1 bg + 8 things
    num_seg_classes: int = 19
    panoptic_stuff_area_limit: int = 2048
    nframes_per_video: int = 6
    lambda_: int = 5
    labeled_fid: int = 20
    n_video: int = 50

    @property
    def id_last_stuff(self) -> int:
        # = 10 for Cityscapes (reference tools/dataset/base_dataset.py:253)
        return self.num_seg_classes - self.num_classes


@_frozen
class DataConfig:
    """Test-pipeline constants (reference r50_fpn_slotvps.py:121-161)."""

    img_scale: Tuple[int, int] = (2048, 1024)  # (w, h)
    keep_ratio: bool = True
    # mean/std applied after BGR->RGB conversion (to_rgb=True)
    mean: Tuple[float, float, float] = (123.675, 116.28, 103.53)
    std: Tuple[float, float, float] = (58.395, 57.12, 57.375)
    to_rgb: bool = True
    size_divisor: int = 32
    nframes_span_test: int = 30
    # iid = vid * iid_divisor + fid (reference cityscapes_vps.py:57-58;
    # VIPER uses 100000, vps_temporal_slots.py:220-224)
    iid_divisor: int = 10000


@_frozen
class Config:
    model: ModelConfig = ModelConfig()
    data: DataConfig = DataConfig()
    eval: EvalConfig = EvalConfig()


def r50_fpn_slotvps() -> Config:
    """Equivalent of reference configs/cityscapes/r50_fpn_slotvps.py."""
    return Config()


def swinl_fpn_slotvps() -> Config:
    """Equivalent of reference configs/cityscapes/swinL_fpn_slotvps.py."""
    return Config(model=ModelConfig(backbone="swin"))


def r50_fpn_slotvps_viper() -> Config:
    """VIPER dataset variant (reference vps_temporal_slots.py:68-70,220-224:
    num_classes 24 -> stuff_num 13, iid divisor 100000; 23 semantic classes
    with 10 things)."""
    return Config(
        model=ModelConfig(
            slot_head=SlotHeadConfig(num_classes=24),
            semantic_head=SemanticHeadConfig(num_classes=23,
                                             num_things_classes=10),
            postprocess=PostprocessConfig(num_classes=24, num_stuff=13),
        ),
        data=DataConfig(img_scale=(1920, 1080), iid_divisor=100000),
        eval=EvalConfig(num_classes=11, num_seg_classes=23),
    )


def r50_fpn_slotvps_mv() -> Config:
    """Mapillary Vistas variant (reference vps_temporal_slots.py:65-67:
    num_classes 46/47 -> stuff_num 34; 46 semantic classes, 12 things)."""
    return Config(
        model=ModelConfig(
            slot_head=SlotHeadConfig(num_classes=47),
            semantic_head=SemanticHeadConfig(num_classes=46,
                                             num_things_classes=12),
            postprocess=PostprocessConfig(num_classes=47, num_stuff=34),
        ),
        eval=EvalConfig(num_classes=13, num_seg_classes=46),
    )


_NAMED = {
    "r50_fpn_slotvps": r50_fpn_slotvps,
    "swinl_fpn_slotvps": swinl_fpn_slotvps,
    "r50_fpn_slotvps_viper": r50_fpn_slotvps_viper,
    "r50_fpn_slotvps_mv": r50_fpn_slotvps_mv,
}


def named_config(name: str) -> Config:
    try:
        return _NAMED[name]()
    except KeyError:
        raise KeyError(
            f"unknown config '{name}', available: {sorted(_NAMED)}"
        ) from None
