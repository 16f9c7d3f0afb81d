"""The fused inverted-residual block.

Counterpart of ``pixelpick_tpu/models/fused_block.py``. :class:`FusedIRBlock`
is an :class:`InvertedResidual` (same modules, so the same parameter and
buffer names, ``conv.{0,1,3,4,6,7}``; ``state_dict_from_jax`` and
``engine/checkpoint.py`` need nothing new) whose forward routes through
``ops/fused_ir.py`` when it can:

- train mode, stride 1, expand ratio != 1 (the caller builds it only for
  those blocks). The ghost-BN group is the effective ``_BNCore`` group for
  this batch (``fused_block.py:122-124``), and the kernel's per-group
  moments feed the running-stat EMA (``:149-155``). The JAX block's VMEM
  gate (``:125-130``) has no counterpart: the Hopper kernels take every
  shape (``ops/fused_ir.py``);
- eval mode takes the inline unfused math op for op (``:178-196``),
  including the library's grouped conv for the depthwise: the JAX package
  does not route ``FusedIRBlock``'s eval path through ``--pallas_dw``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from pixelpick_tpu_torch.models.layers import fixed_pad, relu6
from pixelpick_tpu_torch.models.mobilenet_v2 import InvertedResidual
from pixelpick_tpu_torch.ops import fused_ir


class FusedIRBlock(InvertedResidual):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return self._unfused(x)
        expand, bn1, _, dw, bn2, _, project, bn3 = self.conv
        b, g = x.shape[0], self.bn_groups
        group = g if 0 < g < b and b % g == 0 else b
        dt = self.dtype
        y, stats = fused_ir.fused_ir_block(
            x.permute(0, 2, 3, 1).to(dt),
            expand.weight[:, :, 0, 0].t().to(dt),
            dw.weight[:, 0].permute(1, 2, 0).to(dt),
            project.weight[:, :, 0, 0].t().to(dt),
            bn1.weight, bn1.bias, bn2.weight, bn2.bias, bn3.weight, bn3.bias,
            group, self.dilation, self.use_res)
        for bn, mu, var in ((bn1, stats[0], stats[1]), (bn2, stats[2], stats[3]),
                            (bn3, stats[4], stats[5])):
            bn.update_running_stats(mu, var)
        return y.permute(0, 3, 1, 2)

    def _unfused(self, x: torch.Tensor) -> torch.Tensor:
        """``InvertedResidual``'s math with the library's grouped conv for
        the depthwise, whatever ``--pallas_dw`` says; BatchNorm in the
        module's mode."""
        expand, bn1, _, dw, bn2, _, project, bn3 = self.conv
        h = expand(fixed_pad(x, 3, self.dilation))
        h = relu6(bn1(h))
        hidden = h.shape[1]
        h = F.conv2d(h.to(self.dtype), dw.weight.to(self.dtype), None,
                     self.stride, 0, self.dilation, hidden)
        h = relu6(bn2(h))
        h = bn3(project(h))
        return x + h if self.use_res else h
