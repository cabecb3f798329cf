from v2ce_toolbox_tpu_torch.models.fastflownet import FastFlowNet, OpticalFlowCalculator
from v2ce_toolbox_tpu_torch.models.v2ce3d import V2ce3d

__all__ = ["FastFlowNet", "OpticalFlowCalculator", "V2ce3d"]
