"""The port's attention against the JAX package's.

`flash_attention_ref` (the plain version of the K1-fwd CUDA kernel) and
the port's CPU `mha` are held against the JAX package's splash kernel
run in the Pallas interpreter and against its plain XLA path, on the
same numpy inputs. Tolerances: 1e-5 at f32 (two f32 softmax pipelines
that sum in different orders), 2e-2 at bf16 (the XLA path rounds its
logits to bf16; splash and the port's plain version keep them f32).
The kernel itself runs only on the card (tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import attention as pa

from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.ops import attention as ta

torch.set_num_threads(2)

TOL = {"float32": 1e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(T, dtype, seed, B=1, N=2, H=64):
    rs = np.random.RandomState(seed)
    arrs = [rs.randn(B, T, N, H).astype(np.float32) for _ in range(3)]
    jx = [jnp.asarray(a).astype(dtype) for a in arrs]
    tt = [torch.from_numpy(a).to(TORCH_DT[dtype]) for a in arrs]
    return jx, tt


def _err(jax_out, torch_out):
    return float(np.max(np.abs(np.asarray(jax_out, np.float32) -
                               torch_out.float().numpy())))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [128, 256])
def test_causal_attention_matches_splash_interpret(T, dtype):
    (q, k, v), (tq, tk, tv) = _qkv(T, dtype, seed=T)
    scale = 1.0 / np.sqrt(64)
    want = pa._splash_mha(q, k, v, scale, True, interpret=True)
    got_ref = fa.flash_attention_ref(tq, tk, tv, scale, causal=True)
    got_wrap = fa.flash_attention(tq, tk, tv, scale, causal=True)
    assert got_ref.dtype == TORCH_DT[dtype]
    assert _err(want, got_ref) <= TOL[dtype]
    assert torch.equal(got_wrap, got_ref)  # CPU tensor: the plain version
    assert _err(want, ta.mha(tq, tk, tv, causal=True)) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [128, 256])
def test_causal_attention_matches_xla_path(T, dtype):
    (q, k, v), (tq, tk, tv) = _qkv(T, dtype, seed=T + 1)
    scale = 1.0 / np.sqrt(64)
    want = pa._xla_mha(q, k, v, pa._merge_causal(None, T), scale) \
        .astype(q.dtype)
    before = ta.GATE_COUNTS["plain"]
    got = ta.mha(tq, tk, tv, causal=True)
    assert ta.GATE_COUNTS["plain"] == before + 1
    assert got.dtype == TORCH_DT[dtype]
    assert _err(want, got) <= TOL[dtype]
    assert _err(want, fa.flash_attention_ref(tq, tk, tv, scale)) \
        <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_attention_matches_xla_path(dtype):
    T = 24
    (q, k, v), (tq, tk, tv) = _qkv(T, dtype, seed=7, B=2)
    lens = np.array([T, 11])
    mask = np.where(np.arange(T)[None, :] < lens[:, None], 0.0,
                    -1e9).astype(np.float32)[:, None, None, :]
    want = pa.mha(q, k, v, mask=jnp.asarray(mask))
    got = ta.mha(tq, tk, tv, mask=torch.from_numpy(mask))
    assert _err(want, got) <= TOL[dtype]
    # mask and causal together merge like _merge_causal
    want = pa.mha(q, k, v, mask=jnp.asarray(mask), causal=True)
    got = ta.mha(tq, tk, tv, mask=torch.from_numpy(mask), causal=True)
    assert _err(want, got) <= TOL[dtype]


def test_ragged_t_and_full_mask_plain_version():
    """A ragged T (the kernel masks the edge itself) and the full
    (non-causal) mode of the plain version against the XLA path."""
    T = 100
    (q, k, v), (tq, tk, tv) = _qkv(T, "float32", seed=3)
    scale = 0.125
    for causal in (True, False):
        mask = pa._merge_causal(None, T) if causal else None
        want = pa._xla_mha(q, k, v, mask, scale)
        got = fa.flash_attention_ref(tq, tk, tv, scale, causal=causal)
        assert _err(want, got) <= 1e-5


def test_wrapper_rejects_what_the_kernel_cannot_take():
    q = torch.zeros(1, 8, 2, 32)
    with pytest.raises(ValueError, match="head_dim"):
        fa.flash_attention(q, q, q, 0.1)
    q = torch.zeros(1, 8, 2, 64, dtype=torch.float64)
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        fa.flash_attention(q, q, q, 0.1)
    q = torch.zeros(1, 8, 2, 128)[..., ::2]
    with pytest.raises(ValueError, match="stride"):
        fa.flash_attention(q, q, q, 0.1)
    # a CPU call never counts as a kernel launch
    before = fa.flash_attention.launches
    x = torch.zeros(1, 8, 2, 64)
    fa.flash_attention(x, x, x, 0.1)
    assert fa.flash_attention.launches == before


def test_strided_views_need_no_copy():
    """q/k/v split out of a fused qkv projection are strided views; the
    plain version (and the kernel) take them as they are."""
    rs = np.random.RandomState(5)
    qkv = torch.from_numpy(rs.randn(1, 40, 3 * 128).astype(np.float32))
    q, k, v = (t.view(1, 40, 2, 64) for t in qkv.split(128, dim=-1))
    assert not q.is_contiguous() and q.stride(-1) == 1
    got = fa.flash_attention(q, k, v, 0.125)
    want = fa.flash_attention_ref(q.contiguous(), k.contiguous(),
                                  v.contiguous(), 0.125)
    assert torch.equal(got, want)


# (device, head dim, masked) -> mha's route off the sp ring. The tiny
# configs' head dim 16 takes the plain path on CUDA, counted as "xla",
# as the JAX package's `_use_splash` sends hd % 64 != 0 to `_xla_mha`;
# a multiple of 64 goes to the kernels, whose wrappers take 64 and 128
# and raise on the rest (192, 256).
ROUTES = [("cpu", 64, False, "plain"), ("cpu", 16, True, "plain"),
          ("cuda", 16, False, "xla"), ("cuda", 16, True, "xla"),
          ("cuda", 32, False, "xla"), ("cuda", 96, True, "xla"),
          ("cuda", 64, False, "flash_cuda"),
          ("cuda", 128, False, "flash_cuda"),
          ("cuda", 64, True, "flash_bias_cuda"),
          ("cuda", 192, False, "flash_cuda"),
          ("cuda", 256, True, "flash_bias_cuda")]


@pytest.mark.parametrize("device,head_dim,masked,route", ROUTES)
def test_single_device_route_by_device_and_head_dim(device, head_dim, masked,
                                                    route):
    assert ta.single_device_route(device, head_dim, masked) == route


def test_single_device_route_refuses_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        ta.single_device_route("meta", 64, False)


def test_cpu_mha_at_head_dim_16_matches_xla_path():
    """The tiny configs' head dim on the CPU: the plain path, as the
    xla route runs it on CUDA."""
    (q, k, v), (tq, tk, tv) = _qkv(24, "float32", seed=9, B=2, H=16)
    want = pa._xla_mha(q, k, v, pa._merge_causal(None, 24), 0.25)
    before = ta.GATE_COUNTS["plain"]
    got = ta.mha(tq, tk, tv, causal=True)
    assert ta.GATE_COUNTS["plain"] == before + 1
    assert _err(want, got) <= TOL["float32"]


def test_tma_check_refuses_misaligned_views():
    """The bf16/f16 forwards read q, k and v with TMA, which needs a
    16-byte aligned base and strides of 16-byte multiples; a view that
    fails raises (no copy). Fused-qkv views and contiguous tensors pass;
    a dimension of size 1 has no stride that matters."""
    x = torch.zeros(2, 8, 2, 72, dtype=torch.bfloat16)
    fa.check_tma(x)
    qkv = torch.zeros(2, 8, 3 * 2 * 64, dtype=torch.bfloat16)
    fa.check_tma(*(t.view(2, 8, 2, 64) for t in qkv.split(128, dim=-1)))
    fa.check_tma(torch.zeros(1, 1, 1, 64, dtype=torch.float16)
                 .as_strided((1, 1, 1, 64), (3, 5, 7, 1)))
    with pytest.raises(ValueError, match="16-byte aligned base"):
        fa.check_tma(x[..., 1:65])
    with pytest.raises(ValueError, match="16-byte multiples"):
        fa.check_tma(torch.zeros(1, 8, 2, 68, dtype=torch.bfloat16)[..., :64])
    with pytest.raises(ValueError, match="16-byte multiples"):
        fa.check_tma(torch.zeros(2 * 1028, dtype=torch.float16)
                     .as_strided((2, 8, 2, 64), (1028, 128, 64, 1)))
    # on CPU tensors the wrappers take the plain version, any view
    q = x[..., 1:65]
    assert torch.equal(fa.flash_attention(q, q, q, 0.1),
                       fa.flash_attention_ref(q, q, q, 0.1))
