"""Evaluation metrics of the port (`v2ce_toolbox_tpu/eval`)."""

from v2ce_toolbox_tpu_torch.eval.stage2_metrics import (  # noqa: F401
    event_count_ratio,
    roundtrip_voxel_consistency,
    ts_diff_metric,
)
