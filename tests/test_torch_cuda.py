"""The port's CUDA kernel on the card: K1-fwd against its plain PyTorch
version at the serving path's shapes (B=1, N=12, H=64, causal, q/k/v as
strided views of one fused qkv projection).

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither jax nor the JAX package, so on the GPU machine it runs
without the repo's conftest (which imports jax):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.ops import attention as ta

torch.set_num_threads(2)

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", [8, 100, 128, 1024])
def test_kernel_matches_plain_version(T, dtype):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(T)
    qkv = torch.randn(1, T, 3 * 12 * 64, generator=g, device="cuda") \
        .to(dtype)
    q, k, v = (t.view(1, T, 12, 64) for t in qkv.split(12 * 64, dim=-1))
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, 0.125, causal=True)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = fa.flash_attention_ref(q, k, v, 0.125, causal=True)
    assert (got.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.cuda
def test_mha_on_cuda_launches_or_raises():
    _need_card()
    q = torch.randn(1, 16, 2, 64, device="cuda")
    before = ta.GATE_COUNTS["flash_cuda"]
    ta.mha(q, q, q, causal=True)
    assert ta.GATE_COUNTS["flash_cuda"] == before + 1
    with pytest.raises(ValueError, match="mask"):
        ta.mha(q, q, q, mask=torch.zeros(1, 1, 1, 16, device="cuda"))
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.randn(1, 16, 2, 32, device="cuda")
        ta.mha(x, x, x, causal=True)
