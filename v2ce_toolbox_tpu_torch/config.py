"""Configuration dataclasses for the V2CE pipeline (product fields only).

Same field names and defaults as `v2ce_toolbox_tpu/config.py`, minus the
TPU-only knobs (conv backends, sub-pixel decoder, layouts, remat and the
fused-generation switch: the port has one generation kernel).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
    compute_dtype: torch.dtype = torch.float32


@dataclasses.dataclass(frozen=True)
class SamplerConfig:
    """Stage-2 LDATI sampler settings. Every capacity loss (per-voxel cap,
    bin cap, multi pool, tiers, sort cap, frame capacity) is counted in
    `dropped`, never silently lost."""

    fps: int = 30
    additional_events_strategy: str = "slope"   # only 'slope' is ported
    pooling_type: str = "none"                   # only 'none' is ported
    bidirectional: bool = False                  # only False is ported
    max_events_per_voxel: int = 32
    event_capacity: int = 1 << 19                # per-frame stream slots
    cap_bin: int = 1 << 14        # chain events kept per (frame, bin) row
    multi_cap: int = 4096         # multi-event voxel pool per row
    sort_cap: Optional[int] = 1 << 14  # pre-sort row compaction width


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """End-to-end inference settings."""

    infer_type: str = "center"    # only 'center' is ported
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
