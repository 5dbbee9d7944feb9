"""PyTorch + CUDA port of auto_dynamic_deeplab_tpu for NVIDIA Hopper (H100).

The JAX package beside this one is the reference; module names and layout
follow it so each counterpart is easy to find. Activations are NCHW-shaped
tensors in ``torch.channels_last`` memory (cuDNN's bf16 convs then use the
tensor cores); the public boundary keeps the JAX layouts (NHWC images in,
NHWC or class-leading NCHW logits out).

This package never imports jax, flax or auto_dynamic_deeplab_tpu.
"""
from .runtime import resolve_device

__all__ = ["resolve_device"]
