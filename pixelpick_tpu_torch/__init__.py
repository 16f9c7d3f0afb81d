"""PixelPick on PyTorch and CUDA (NVIDIA Hopper).

The PyTorch counterpart of ``pixelpick_tpu``, module for module: each file
here mirrors the JAX module of the same name, so a reader finds each
counterpart by path. The JAX package stays the reference; this package
imports nothing of it (nor jax), and keeps its own copies of the pieces it
needs (the flag surface, the query codec, the stats aggregator).

Ported so far: the pool-scoring (query) path in eval mode, the DeepLabv3+ /
MobileNetV2 forward, the weight bridge from the JAX trees, and the
hand-written Hopper depthwise 3x3 kernel (``csrc/depthwise.cu``) behind
``--pallas_dw``. Training comes later (ROADMAP.md, Queue 1).

Public functions keep the JAX layout (NHWC activations, ``(3, 3, C)``
depthwise weights, ``(B, H, W)`` maps). Entry points run on ``cuda`` unless
the caller asks for ``cpu``.
"""

__version__ = "0.1.0"
