"""PixelPick on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch counterpart of ``pixelpick_tpu``, module for module: each file
here mirrors the JAX module of the same name, so a reader finds each
counterpart by path. The JAX package stays the reference; this package
imports nothing of it (nor jax), and keeps its own copies of the pieces it
needs (the flag surface, the query codec, the stats aggregator).

What is ported is listed in ``ROADMAP.md`` (Queue 1): the active-learning
loop of ``main_al`` and its round modes, the four CLIs, checkpoints both
ways, CamVid, Cityscapes and VOC, the DeepLabv3+ / MobileNetV2 and the FPN
on a ResNet, and a hand-written Hopper kernel for each Pallas kernel of
the JAX package (``csrc/``).

Public functions keep the JAX layout (NHWC activations, ``(3, 3, C)``
depthwise weights, ``(B, H, W)`` maps). Entry points run on ``cuda`` unless
the caller asks for ``cpu``.
"""

__version__ = "0.1.0"
