"""V2CE video -> DVS event stream, in PyTorch with hand-written CUDA kernels.

The PyTorch/CUDA port of `v2ce_toolbox_tpu`. Module names mirror the JAX
package so each counterpart is easy to find; public functions keep the JAX
package's tensor layouts. This package imports torch, numpy and cv2 and
never jax.

Covered so far: the inference CLI (decode, resize, the V2ce3d 3D-UNet,
window merge, the LDATI sampler through the wire format, the npz event
stream and the preview mp4) and the training-data path (the MVSEC
converter with FastFlowNet flows, the packet dataset and its loader).
"""
