"""Configuration dataclasses for the V2CE pipeline and its training.

Same field names and defaults as `v2ce_toolbox_tpu/config.py`. Of the
stage-1 model's backend knobs the port runs conv_impl 'xla' (cuDNN) and
'pallas' (the K9 kernel), and the sub-pixel decoder's 'pallas' form (the
K10 kernel); the TPU-only XLA rewrites, layouts and remat are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

# DVS sensor geometry of the DAVIS346 the reference targets.
SENSOR_HEIGHT = 260
SENSOR_WIDTH = 346
NUM_TIME_BINS = 10          # voxel channels predicted by stage 1 (per polarity)
NUM_POLARITIES = 2
SEQ_LEN = 16                # frames per model window

# Frame normalization constants.
FRAME_MEAN = 0.153
FRAME_STD = 0.165

CONV_IMPLS = ("xla", "pallas")
UNPORTED_CONV_IMPLS = ("fold", "d2", "d2s", "wpack")
UNPORTED_SUBPIXEL_IMPLS = ("split", "wfold", "pfold")
UNPORTED = ("the TPU-only XLA rewrites fold, d2, d2s, wpack and ko:* of "
            "conv_impl, and split, wfold and pfold of subpixel_impl, stay in the "
            "JAX package (ROADMAP, 'Not ported'); the port runs conv_impl 'xla' or "
            "'pallas' and subpixel_impl 'pallas'")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Stage-1 3D-UNet hyperparameters."""

    in_channels: int = 2
    out_channels: int = NUM_POLARITIES * NUM_TIME_BINS
    num_encoders: int = 4
    base_num_channels: int = 32
    num_residual_blocks: int = 2
    skip_type: str = "concat"
    norm: Optional[str] = "BN"
    spectral_norm: bool = True
    final_activation: str = "relu"
    # conv inputs are cast to compute_dtype, conv outputs are f32, and the
    # BatchNorm outputs (the activations between layers) are compute_dtype
    compute_dtype: torch.dtype = torch.float32
    # 'pallas' routes every 3x3x3 stride-1 pad-1 conv with cin >= 16 to
    # the K9 kernel (ops/conv3d.py); 'xla' keeps every conv on F.conv3d
    conv_impl: str = "xla"
    # decoder conv1 + projection over concat(nearest_up2(x), skip) on the
    # coarse grid; only subpixel_impl 'pallas' (the K10 kernel,
    # ops/decoder.py) is ported
    subpixel_decoder: bool = False
    subpixel_impl: str = "pfold"
    subpixel_blocks: int = -1     # the last N decoder blocks; -1 = all

    def check_backends(self) -> None:
        """Raise on a backend the port does not run: NotImplementedError
        for the JAX package's TPU-only rewrites, ValueError for names it
        does not know either."""
        ci = self.conv_impl
        if ci in UNPORTED_CONV_IMPLS or ci.startswith("ko:"):
            raise NotImplementedError(
                f"conv_impl={ci!r} is not ported: {UNPORTED}")
        if ci not in CONV_IMPLS:
            raise ValueError(f"unknown conv_impl {ci!r}")
        if self.subpixel_decoder:
            if self.subpixel_impl in UNPORTED_SUBPIXEL_IMPLS:
                raise NotImplementedError(
                    f"subpixel_impl={self.subpixel_impl!r} is not ported: {UNPORTED}")
            if self.subpixel_impl != "pallas":
                raise ValueError(f"unknown subpixel_impl {self.subpixel_impl!r}")


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Stage-2 LDATI sampler settings. Every capacity loss (per-voxel cap,
    bin cap, multi pool, tiers, sort cap, frame capacity) is counted in
    `dropped`, never silently lost."""

    fps: int = 30
    additional_events_strategy: str = "slope"   # 'none' | 'random' | 'slope'
    pooling_type: str = "none"                   # 'none' | 'avg' | 'weighted'
    pooling_kernel_size: int = 3
    bidirectional: bool = False
    max_events_per_voxel: int = 32
    event_capacity: int = 1 << 19                # per-frame stream slots
    cap_bin: int = 1 << 14        # chain events kept per (frame, bin) row
    multi_cap: int = 4096         # multi-event voxel pool per row
    sort_cap: Optional[int] = 1 << 14  # pre-sort row compaction width
    use_gen_compact: bool = True  # fuse generation + chain compaction (K1)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end inference settings."""

    infer_type: str = "center"    # 'center' | 'pano'
    seq_len: int = SEQ_LEN
    height: int = SENSOR_HEIGHT
    width: int = SENSOR_WIDTH
    batch_size: int = 1
    fps: int = 30
    max_frame_num: int = 1800
    ceil: int = 10
    upper_bound_percentile: int = 98
    vis_keep_polarity: bool = True
    stage2_batch_size: int = 24
    write_event_frame_video: bool = True
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    sampler: SamplerConfig = dataclasses.field(default_factory=SamplerConfig)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (the JAX package's TrainConfig)."""

    lr: float = 1e-3
    weight_decay: float = 1e-5
    lr_scheduler: Optional[str] = "step"   # 'step' | 'cosine' | None
    lr_decay_steps: int = 20
    lr_decay_rate: float = 0.5
    lr_decay_min_lr: float = 1e-5
    batch_size: int = 2
    max_epochs: int = 100
    seed: int = 1234
    loss: str = "ef+pyramid"
    ef_type: str = "c+cl"            # 'only_c' | 'cl' | 'c+cl'
    add_base_loss: bool = False      # pyramid loss includes the unpooled MSE
    metrics: Tuple[str, ...] = (
        "BinaryMatch_raw",
        "BinaryMatch_sum_c",
        "BinaryMatch_sum_cp",
        "BinaryMatchF1_raw",
        "BinaryMatchF1_sum_c",
        "BinaryMatchF1_sum_cp",
        "PoolMSE_2",
        "PoolMSE_4",
    )
