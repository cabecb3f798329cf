from v2ce_toolbox_tpu_torch.models.fastflownet import FastFlowNet, OpticalFlowCalculator
from v2ce_toolbox_tpu_torch.models.resnet import ResNet, ResNetDiscriminator
from v2ce_toolbox_tpu_torch.models.unet2d import UNet2D, V2ce2d
from v2ce_toolbox_tpu_torch.models.unet3d import UNet3D
from v2ce_toolbox_tpu_torch.models.unet_plain import UNetPlain3D
from v2ce_toolbox_tpu_torch.models.v2ce3d import V2ce3d

__all__ = ["FastFlowNet", "OpticalFlowCalculator", "ResNet", "ResNetDiscriminator",
           "UNet2D", "UNet3D", "UNetPlain3D", "V2ce2d", "V2ce3d"]
