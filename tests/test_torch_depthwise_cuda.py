"""The hand-written depthwise kernel (pixelpick_tpu_torch/csrc/depthwise.cu)
against its plain PyTorch version, on a CUDA card. Skips without one.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_depthwise_cuda.py

Tolerances: f32 1e-5 (the same 9 products in the same order; fused and
separate multiply-adds round differently). bf16: both sides are f32 sums
rounded once to bf16, so they may differ by one bf16 ulp (2**-7 relative).
"""

import numpy as np
import pytest
import torch

from pixelpick_tpu_torch.ops import depthwise as dw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dilation,hw,ch", [(1, (45, 60), 192),
                                            (2, (23, 30), 960),
                                            (1, (17, 23), 20),
                                            (2, (11, 13), 7)])
def test_kernel_matches_plain_version_on_card(dtype, dilation, hw, ch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, hw[0] + 2 * dilation, hw[1] + 2 * dilation,
                             ch)).astype(np.float32)
    w = rng.standard_normal((3, 3, ch)).astype(np.float32)
    xc = torch.from_numpy(x).to("cuda", dtype)
    wc = torch.from_numpy(w).to("cuda", dtype)
    dw.reset_launch_counts()
    got = dw.depthwise_conv3x3(xc, wc, 1, dilation, 0)
    torch.cuda.synchronize()
    assert dw.launch_counts["kernel"] == 1
    ref = dw.depthwise_reference_torch(xc.float(), wc.float(), dilation)
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    torch.testing.assert_close(got.float(), ref.to(dtype).float(), rtol=tol,
                               atol=tol)


@pytest.mark.cuda
def test_kernel_refuses_what_it_does_not_take():
    """A CUDA tensor reaches the kernel or an error, never the plain
    version: wrong dtype, non-contiguous input and a too-small image
    raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w = torch.ones((3, 3, 8), device="cuda")
    dw.reset_launch_counts()
    with pytest.raises(TypeError):
        dw.depthwise_conv3x3(torch.ones((1, 6, 6, 8), device="cuda",
                                        dtype=torch.float16),
                             w.half(), 1, 1, 0)
    with pytest.raises(ValueError, match="contiguous"):
        dw.depthwise_conv3x3(torch.ones((1, 8, 6, 6), device="cuda")
                             .permute(0, 2, 3, 1), w, 1, 1, 0)
    with pytest.raises(ValueError, match="too small"):
        dw.depthwise_conv3x3(torch.ones((1, 4, 4, 8), device="cuda"), w, 1,
                             2, 0)
    assert dw.launch_counts["kernel"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dilation", [1, 2])
def test_kernel_backward_matches_plain_version_on_card(dtype, dilation):
    """dx of the stride-1 path is the kernel again (counted on kernel_dx),
    on the gradient padded by 2d with the flipped taps; dw is plain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 15 + 2 * dilation, 17 + 2 * dilation, 24))
    w = rng.standard_normal((3, 3, 24))
    g = rng.standard_normal((2, 15, 17, 24))
    outs = {}
    for dev in ("cuda", "cpu"):
        xt = torch.tensor(x, dtype=dtype, device=dev, requires_grad=True)
        wt = torch.tensor(w, dtype=dtype, device=dev, requires_grad=True)
        dw.reset_launch_counts()
        y = dw.depthwise_conv3x3(xt, wt, 1, dilation, 0)
        y.backward(torch.tensor(g, dtype=dtype, device=dev))
        outs[dev] = (xt.grad.float().cpu(), wt.grad.float().cpu(),
                     dict(dw.launch_counts))
    assert outs["cuda"][2]["kernel"] == 1 and outs["cuda"][2]["kernel_dx"] == 1
    tol = 1e-5 if dtype == torch.float32 else 2 ** -7
    for a, r in zip(outs["cuda"][:2], outs["cpu"][:2]):
        torch.testing.assert_close(a, r, rtol=tol, atol=tol * float(r.abs().max()))
