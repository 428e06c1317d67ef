"""Neural-network models for block-wise inference (port of
``cluster_tools_tpu/models``): the U-Net as a PyTorch module with the JAX
package's arithmetic, and its checkpoint directory format, which both
packages read and write."""

from .unet import UNet3D, load_checkpoint, params_from_flax, params_to_flax, save_checkpoint

__all__ = ["UNet3D", "load_checkpoint", "params_from_flax", "params_to_flax", "save_checkpoint"]
