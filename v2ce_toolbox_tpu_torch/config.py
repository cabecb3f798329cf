"""Configuration dataclasses for the V2CE pipeline and its training.

Same field names and defaults as `v2ce_toolbox_tpu/config.py`. The
stage-1 model's backend knobs are all ported: conv_impl 'xla' (cuDNN),
'pallas' (the K9 kernel) and the exact rewrites 'fold', 'd2', 'd2s',
'wpack' and the knockout 'ko:<pred>' (`ops/research.py`); the sub-pixel
decoder's 'split', 'wfold' and 'pfold' forms (`ops/subpixel.py`) and its
'pallas' form (the K10 kernel); decoder_split, out_layout and remat.
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

CONV_IMPLS = ("xla", "pallas", "fold", "d2", "d2s", "wpack")
# conv_impl 'ko:<pred>': the 3x3x3 convs the predicate picks run as their
# centre tap (`ops/research.knockout`)
KNOCKOUT_PREDICATES = ("all", "big", "head", "small", "strided")
SUBPIXEL_IMPLS = ("split", "wfold", "pfold", "pallas")
OUT_LAYOUTS = ("cl", "cm")


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
    # 'xla' keeps every conv on F.conv3d; 'pallas' routes every 3x3x3
    # stride-1 pad-1 conv with cin >= 16 to the K9 kernel (ops/conv3d.py);
    # 'fold', 'd2', 'd2s', 'wpack' and 'ko:<pred>' are the exact rewrites
    # and the knockout of ops/research.dispatch_conv
    conv_impl: str = "xla"
    # decoder conv1 + projection over concat(nearest_up2(x), skip) on the
    # coarse grid: subpixel_impl 'split', 'wfold' or 'pfold'
    # (ops/subpixel.py), or 'pallas' (the K10 kernel, ops/decoder.py)
    subpixel_decoder: bool = False
    subpixel_impl: str = "pfold"
    subpixel_blocks: int = -1     # the last N decoder blocks; -1 = all
    # decoder blocks take (upsampled, skip) as two tensors and slice the
    # conv1 and projection kernels across them: no concat is built
    decoder_split: bool = False
    # 'cm' returns the prediction channel-major, (B, L, 20, H, W)
    out_layout: str = "cl"
    # recompute the encoder, residual and decoder blocks' activations in
    # the backward pass (torch.utils.checkpoint): training memory
    remat: bool = False

    def check_backends(self) -> None:
        """Raise ValueError on a backend name the JAX package does not know
        (it raises on the conv_impl and the knockout predicate at the first
        conv that reads them); an out_layout other than 'cl' and 'cm' too,
        which the JAX model takes as 'cl'."""
        ci = self.conv_impl
        if ci.startswith("ko:"):
            if ci[3:] not in KNOCKOUT_PREDICATES:
                raise ValueError(f"unknown knockout predicate {ci[3:]!r}; "
                                 f"valid: {sorted(KNOCKOUT_PREDICATES)}")
        elif ci not in CONV_IMPLS:
            raise ValueError(f"unknown conv_impl {ci!r}")
        if self.subpixel_decoder and self.subpixel_impl not in SUBPIXEL_IMPLS:
            raise ValueError(f"unknown subpixel_impl {self.subpixel_impl!r}")
        if self.out_layout not in OUT_LAYOUTS:
            raise ValueError(f"unknown out_layout {self.out_layout!r}")


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
