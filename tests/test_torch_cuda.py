"""The port's CUDA kernels on the card: K1-fwd against its plain PyTorch
version at the serving path's shapes (B=1, N=12, H=64, causal, q/k/v as
strided views of one fused qkv projection), and K1-fwd with its LSE
output and K1-bwd (delta, dkv and dq launches) against theirs at the
training path's shapes: the training runs' own (BERT-base 256 x 128
and 32 x 512, full; GPT-2-small 8 x 1024, causal) and batch 32 and 1
of the same models, all bf16, plus f32, f16 and a ragged T at one
shape each. K2 (the additive-bias kernels: forward, dkv, dq with its
bias gradient) against its plain versions at small shapes with key
masks and full biases; `chip_smoke.py` checks it at the main paths'
own shapes. A masked `mha` and a padded BERT `encode` run K2. K4, K5
and K6 (the fused matmul+BN kernels) against their plain versions at
one ResNet-50 shape of each stage group (bs 256 at 224 x 224), at f32,
f16 and f64, at a ragged shape and at one whose K and N TMA cannot read
in place (the padded route), with the ReLU on and off. K1-bwd's Hopper
dkv and dq at head_dim 128, f16, ragged T, causal and full, on strided
views of a fused projection and at T 4096. K3 (the
ring's block, `splash_block_with_lse`) against its plain version at
BERT-long's sp=4 block (8 x 1024, bf16) and at f32 and f16; and the
sp=4 in-process ring on the card against single-device K1: ring_splash
(K3 blocks) and causal ring_attention, out and gradients at f32. K2-bwd's
Hopper dkv and dq at bf16 (the key mask on fused kv views, causal with
Tk = 2 T, a full bias with its gradient, H 128 ragged), checked in the
profiler to run the Hopper kernels, and their refusal of a view TMA
cannot read. The bf16 and f16 backwards' two-launch form, whose dq
kernels compute delta from the forward's output: the folded delta, the
external-delta launch and the launch counts, for K1 and K2. The decode
engine's CUDA graphs: a warmed engine's tokens equal an unwarmed one's
bit for bit, every decode step a replay, the same for a KV-reuse engine
(chunked prefill, prefix cache, speculation with a draft), and a
capture that fails raises. Training under each recompute policy equals no recompute bit
for bit on a narrow BERT with K1 (K1-fwd run again in the recompute),
a TrainState checkpoint restores onto its template's device, cuda
or cpu, whichever device wrote it, the fluid path's LeNet rung
takes one Adam step on `CUDAPlace(0)` as on `CPUPlace()`, the int8
product (`ops/int8.py`, on `torch._int_mm`) is exact on the card, and
int8 weights are laid out at load and run under inference mode.

Tolerances of the training shapes hold every element:
|got - want| <= rtol |want| + atol rms(want), with rtol one rounding
step of the dtype (2^-7 at bf16, 2^-10 at f16, 1e-5 at f32: both sides
round the same f32 sums, taken in other orders, to the dtype) and atol
a share of the tensor's own RMS (2e-2 at bf16, 1e-3 at f16, 1e-5 at
f32) for a rounding of dS that falls the other way: one step of a large
dS times a q or k element, which lands on dq or dk elements of any
size. The limits are 2-5 times the largest readings on an H100
(`chip_smoke.py`'s kernels phase). So each gradient is held to its own
scale, and a result wrong on some rows fails however large the largest
value is. The delta rows are f32 and take the f32 limits.

Every test here needs an NVIDIA GPU and skips without one. The file
imports neither jax nor the JAX package, so on the GPU machine it runs
without the repo's conftest (which imports jax):

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import pytest
import torch

from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.kernels import flash_attention_bias as fb
from paddle_tpu_torch.kernels import fused_dense_bn as fdb
from paddle_tpu_torch.ops import attention as ta
from paddle_tpu_torch.ops import ring_attention as tra
from paddle_tpu_torch.parallel import mesh as tmesh

from chip_smoke import ATTN_F16_TOL

torch.set_num_threads(2)

TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
ELEM_TOL = {torch.bfloat16: (2 ** -7, 2e-2), torch.float16: (2 ** -10, 1e-3),
            torch.float32: (1e-5, 1e-5)}

# (B, T, causal, dtype): the training runs' attention calls (BERT-base
# 256 x 128 and 32 x 512, GPT-2-small 8 x 1024), the same models at
# batch 32 and 1, then one shape each at f32 and f16 and a ragged
# causal T
BWD_CASES = [(256, 128, False, torch.bfloat16),
             (32, 512, False, torch.bfloat16), (8, 1024, True, torch.bfloat16),
             (32, 128, False, torch.bfloat16), (1, 1024, True, torch.bfloat16),
             (2, 256, True, torch.float32), (4, 128, False, torch.float16),
             (2, 100, True, torch.float32)]


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
    """A CUDA mha launches K1-fwd without a mask and K2-fwd with one
    (never the plain version); a head dim that is not a multiple of 64
    takes the JAX package's XLA path, "xla", by shape before any
    launch; a multiple of 64 that the kernels do not take raises."""
    _need_card()
    q = torch.randn(1, 16, 2, 64, device="cuda")
    before = ta.GATE_COUNTS["flash_cuda"]
    ta.mha(q, q, q, causal=True)
    assert ta.GATE_COUNTS["flash_cuda"] == before + 1
    gates, k2 = dict(ta.GATE_COUNTS), fb.flash_attention_bias_fwd.launches
    ta.mha(q, q, q, mask=torch.zeros(1, 1, 1, 16, device="cuda"))
    assert fb.flash_attention_bias_fwd.launches == k2 + 1
    assert ta.GATE_COUNTS["flash_bias_cuda"] == \
        gates.get("flash_bias_cuda", 0) + 1
    assert ta.GATE_COUNTS["plain"] == gates.get("plain", 0)
    x = torch.randn(1, 16, 2, 32, device="cuda")
    xla, k1 = ta.GATE_COUNTS["xla"], fa.flash_attention.launches
    got = ta.mha(x, x, x, causal=True)
    assert ta.GATE_COUNTS["xla"] == xla + 1
    assert fa.flash_attention.launches == k1
    want = ta.mha(x.cpu(), x.cpu(), x.cpu(), causal=True)
    assert (got.cpu() - want).abs().max().item() <= 1e-5
    with pytest.raises(ValueError, match="head_dim"):
        x = torch.randn(1, 16, 2, 192, device="cuda")
        ta.mha(x, x, x, causal=True)


def _held(got, want, dtype, tol=None):
    """The worst element's error over its limit under ELEM_TOL[dtype] or
    `tol` (at most 1 passes), and the reference's RMS, its typical
    value."""
    rtol, atol = tol or ELEM_TOL[dtype]
    want = want.float()
    err = (got.float() - want).abs()
    rms = want.square().mean().sqrt().clamp(min=torch.finfo().tiny)
    return (err / (rtol * want.abs() + atol * rms)).max().item(), rms.item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,causal,dtype", BWD_CASES)
def test_backward_kernels_match_plain_version(B, T, causal, dtype):
    _need_card()
    N, H, scale = 12, 64, 0.125
    g = torch.Generator(device="cuda").manual_seed(T + B)
    # strided q/k/v, as a fused qkv projection's split views reach it
    qkv = torch.randn(B, T, 3 * N * H, generator=g, device="cuda").to(dtype)
    q, k, v = (t.view(B, T, N, H) for t in qkv.split(N * H, dim=-1))
    do = torch.randn(B, T, N, H, generator=g, device="cuda").to(dtype)

    before = fa.flash_attention_with_lse.launches
    out, lse = fa.flash_attention_with_lse(q, k, v, scale, causal)
    assert fa.flash_attention_with_lse.launches == before + 1
    ref_out, ref_lse = fa.flash_attention_ref(q, k, v, scale, causal,
                                              with_lse=True)
    assert _held(out, ref_out, dtype)[0] <= 1.0
    assert (lse - ref_lse).abs().max().item() <= 1e-4

    counts = _k1_bwd_counts()
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, scale, causal)
    torch.cuda.synchronize()
    # two launches at bf16 and f16 (dq folds the delta pass in), three
    # at f32 (the standalone delta launch, then dq and dkv)
    f32 = dtype == torch.float32
    assert _k1_bwd_counts() == [c + d for c, d in
                                zip(counts, (f32, 1, 1, not f32))]
    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, scale, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == (B, T, N, H)
        ratio, rms = _held(a, b, dtype)
        assert ratio <= 1.0, f"{name}: error / limit {ratio}, RMS {rms}"
    want_delta = fa.attention_delta_ref(out, do)
    for delta in (fa.attention_delta(out, do),
                  fa.flash_attention_bwd_dq(q, k, v, do, lse, None, scale,
                                            causal, o=out)[1]):
        ratio, rms = _held(delta, want_delta, torch.float32)
        assert ratio <= 1.0, f"delta: error / limit {ratio}, RMS {rms}"


def _k1_bwd_counts():
    """K1-bwd's counts: the standalone delta, dkv and dq launches, and the
    dq launches that folded the delta pass in."""
    return [fa.attention_delta.launches, fa.flash_attention_bwd_dkv.launches,
            fa.flash_attention_bwd_dq.launches,
            fa.flash_attention_bwd_dq.delta_folds]


def _k2_bwd_counts():
    """K2-bwd's counts, as `_k1_bwd_counts` (the standalone delta launch
    is K1's)."""
    return [fa.attention_delta.launches,
            fb.flash_attention_bias_bwd_dkv.launches,
            fb.flash_attention_bias_bwd_dq.launches,
            fb.flash_attention_bias_bwd_dq.delta_folds]


@pytest.mark.cuda
def test_mha_under_grad_runs_the_backward_kernel():
    """A CUDA mha call under grad is never cut off from autograd: its
    output's grad_fn is the Function's, and backward launches K1-bwd."""
    _need_card()
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(2, 128, 2, 64, device="cuda", dtype=dtype,
                        requires_grad=True)
        out = ta.mha(x, x * 2, x * 3, causal=True)
        assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
        before = _k1_bwd_counts()
        out.sum().backward()
        # bf16: dq folds the delta pass in; f32: the delta launch first
        f32 = dtype == torch.float32
        assert _k1_bwd_counts() == [c + d for c, d in
                                    zip(before, (f32, 1, 1, not f32))]
        assert x.grad is not None and torch.isfinite(x.grad).all()
    # no grad: K1-fwd alone, nothing saved
    with torch.inference_mode():
        assert ta.mha(x, x, x, causal=True).grad_fn is None


@pytest.mark.cuda
def test_mha_with_mask_under_grad_raises():
    """A masked CUDA mha under grad (it raised before K2 was ported) runs
    K2's autograd Function: K2-fwd, then K1's delta launch and K2's dkv
    and dq in backward, with finite gradients for q, k and v."""
    _need_card()
    mask = torch.zeros(1, 1, 1, 16, device="cuda")
    mask[..., 12:] = -1e9
    for dtype in (torch.float32, torch.bfloat16):
        x = torch.randn(1, 16, 2, 64, device="cuda", dtype=dtype,
                        requires_grad=True)
        before = [fb.flash_attention_bias_fwd.launches] + _k2_bwd_counts()
        out = ta.mha(x, x * 2, x * 3, mask=mask)
        assert type(out.grad_fn).__name__ == "FlashAttentionBiasBackward"
        out.sum().backward()
        # bf16: K2's dq folds the delta pass in; f32: K1's delta launch
        f32 = dtype == torch.float32
        assert [fb.flash_attention_bias_fwd.launches] + _k2_bwd_counts() == \
            [c + d for c, d in zip(before, (1, f32, 1, 1, not f32))]
        assert x.grad is not None and torch.isfinite(x.grad).all()


# K2 at small shapes: (B, T, Tk, N, H, causal, dtype, full bias). The
# encoder/cross shape with a key-padding mask, its causal form with
# Tk = 2 T, the beam search's 32 queries against 128 keys, a ragged
# pair with a full [B, N, T, Tk] bias, causal with a full bias, and
# head_dim 128.
K2_CASES = [(2, 128, 128, 4, 64, False, torch.bfloat16, False),
            (2, 128, 256, 4, 64, True, torch.bfloat16, False),
            (4, 32, 128, 4, 64, False, torch.float32, False),
            (2, 100, 164, 2, 64, False, torch.float16, True),
            (2, 256, 256, 2, 64, True, torch.float32, True),
            (2, 100, 192, 2, 128, True, torch.bfloat16, False)]


def _k2_inputs(B, T, Tk, N, H, dtype, full, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, do = (torch.randn(B, T, N, H, generator=g, device="cuda").to(dtype)
             for _ in range(2))
    # k and v as the views of one fused kv projection
    kv = torch.randn(B, Tk, 2 * N * H, generator=g, device="cuda").to(dtype)
    k, v = (t.view(B, Tk, N, H) for t in kv.split(N * H, dim=-1))
    if full:
        bias = torch.randn(B, N, T, Tk, generator=g, device="cuda")
    else:
        lens = torch.randint(Tk // 2, Tk + 1, (B,), generator=g,
                             device="cuda")
        keep = torch.arange(Tk, device="cuda")[None] < lens[:, None]
        bias = torch.where(keep, 0.0, -1e9)[:, None, None, :]
    return q, k, v, do, bias


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,Tk,N,H,causal,dtype,full", K2_CASES)
def test_k2_kernels_match_plain_version(B, T, Tk, N, H, causal, dtype, full):
    _need_card()
    q, k, v, do, bias = _k2_inputs(B, T, Tk, N, H, dtype, full, T + Tk)
    scale = 0.125
    counts = [f.launches for f in (fb.flash_attention_bias_fwd,
                                   fb.flash_attention_bias_bwd_dkv,
                                   fb.flash_attention_bias_bwd_dq)]
    out, l, m = fb.flash_attention_bias_fwd(q, k, v, bias, scale, causal)
    delta = fa.attention_delta(out, do)
    args = (q, k, v, bias, do, l, m, delta, scale, causal)
    dk, dv = fb.flash_attention_bias_bwd_dkv(*args)
    dq, dbias = fb.flash_attention_bias_bwd_dq(*args, with_dbias=True)
    torch.cuda.synchronize()
    assert [f.launches for f in (fb.flash_attention_bias_fwd,
                                 fb.flash_attention_bias_bwd_dkv,
                                 fb.flash_attention_bias_bwd_dq)] == \
        [c + 1 for c in counts]
    ref_out, ref_l, ref_m = fb.flash_attention_bias_ref(q, k, v, bias, scale,
                                                        causal)
    ratio, rms = _held(out, ref_out, dtype)
    assert ratio <= 1.0, f"out: error / limit {ratio}, RMS {rms}"
    assert torch.allclose(l, ref_l, rtol=1e-5, atol=0)
    assert torch.allclose(m, ref_m, rtol=1e-6, atol=1e-6)
    ref_dk, ref_dv = fb.flash_attention_bias_bwd_dkv_ref(*args)
    ref_dq, ref_ds = fb.flash_attention_bias_bwd_dq_ref(*args,
                                                        with_dbias=True)
    for name, a, b, dt in (("dq", dq, ref_dq, dtype), ("dk", dk, ref_dk, dtype),
                           ("dv", dv, ref_dv, dtype),
                           ("dbias", dbias, ref_ds, torch.float32)):
        ratio, rms = _held(a, b, dt)
        assert ratio <= 1.0, f"{name}: error / limit {ratio}, RMS {rms}"


@pytest.mark.cuda
def test_padded_bert_encode_on_cuda_equals_the_cpu():
    """BERT with an attention_mask: every layer's attention on K2 on the
    card, its plain mirror of _xla_mha on the CPU; f32, TF32 off, within
    1e-5 of the largest value (f32 sums in other orders)."""
    _need_card()
    from paddle_tpu_torch.models import bert

    # tiny's widths with head_dim 64, which the kernels take
    cfg = bert.BertConfig(vocab_size=1024, hidden=128, layers=2, heads=2,
                          mlp_dim=256, max_len=64, dropout=0.0,
                          dtype="float32")
    params, _ = bert.init(torch.Generator().manual_seed(0), cfg, device="cpu")
    g = torch.Generator().manual_seed(1)
    ids = torch.randint(0, cfg.vocab_size, (3, 64), generator=g)
    mask = (torch.arange(64)[None] < torch.tensor([64, 40, 17])[:, None]) \
        .long()
    want = bert.encode(params, cfg, ids, attention_mask=mask)
    k2 = fb.flash_attention_bias_fwd.launches
    got = bert.encode({k: t.cuda() for k, t in params.items()}, cfg,
                      ids.cuda(), attention_mask=mask.cuda())
    assert fb.flash_attention_bias_fwd.launches == k2 + cfg.layers
    err = (got.cpu() - want).abs().max() / want.abs().max().clamp(min=1)
    assert err <= 1e-5


# K4-K6: (kernel, M, K, N, dtype, relu). K4 is conv1 and K6 conv3 of a
# bottleneck at ResNet-50 bs 256 (one shape of each stage group, M =
# B*H*W), K5 the bottleneck slice's second product; then f32, f16 and
# f64 at one shape, a ragged shape at every dtype and the ReLU off.
FDB_CASES = ([("k4", 802816, 256, 64, torch.bfloat16, True),
              ("k4", 200704, 512, 128, torch.bfloat16, True),
              ("k4", 50176, 1024, 256, torch.bfloat16, True),
              ("k4", 12544, 2048, 512, torch.bfloat16, True),
              ("k6", 802816, 64, 256, torch.bfloat16, True),
              ("k6", 200704, 128, 512, torch.bfloat16, True),
              ("k6", 50176, 256, 1024, torch.bfloat16, True),
              ("k6", 12544, 512, 2048, torch.bfloat16, True),
              ("k5", 50176, 256, 1024, torch.bfloat16, True)] +
             [(k, 12544, 256, 256, dt, True) for k in ("k4", "k5", "k6")
              for dt in (torch.float32, torch.float16, torch.float64)] +
             [(k, 1000, 72, 40, dt, True) for k in ("k4", "k5", "k6")
              for dt in (torch.bfloat16, torch.float32, torch.float16,
                         torch.float64)] +
             [(k, 1000, 72, 40, torch.bfloat16, False) for k in ("k5", "k6")] +
             [(k, 1000, 70, 36, torch.bfloat16, True)
              for k in ("k4", "k5", "k6")])
FDB_FNS = {"k4": fdb.matmul_stats_fwd, "k5": fdb.bn_act_matmul_fwd,
           "k6": fdb.bn_act_matmul_stats_fwd}
FDB_REFS = {"k4": fdb.mm_stats_ref, "k5": fdb.bn_mm_ref,
            "k6": fdb.bn_mm_stats_ref}
# y per element under ELEM_TOL (f64: one step of 1e-12); mean and var
# against the scale of the summed values, E[y^2]: a sum of M terms in
# another order moves by a few steps of that scale, whatever the mean's
# own size (1e-5 for the f32 accumulator, 1e-12 for f64)
FDB_ELEM_TOL = {**ELEM_TOL, torch.float64: (1e-12, 1e-12)}


def _fdb_inputs(kernel, M, K, N, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    acc = torch.float64 if dtype == torch.float64 else torch.float32
    x = torch.randn(M, K, generator=g, device="cuda").to(dtype)
    w = (torch.randn(K, N, generator=g, device="cuda") / K ** 0.5).to(dtype)
    if kernel == "k4":
        return (x, w)
    scale = torch.rand(K, generator=g, device="cuda", dtype=acc) + 0.5
    shift = torch.randn(K, generator=g, device="cuda", dtype=acc) * 0.5
    return (x, scale, shift, w)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,M,K,N,dtype,relu", FDB_CASES)
def test_fused_dense_bn_kernels_match_plain_version(kernel, M, K, N, dtype,
                                                    relu):
    _need_card()
    args = _fdb_inputs(kernel, M, K, N, dtype, M + K + N)
    kw = {} if kernel == "k4" else {"relu": relu}
    fn = FDB_FNS[kernel]
    x, w = args[0], args[-1]
    route = fdb.kernel_route(K, N, dtype, x.data_ptr(), w.data_ptr())
    assert route == ("fma" if dtype in (torch.float32, torch.float64) else
                     "padded" if K % 8 or N % 8 else "tma")
    before = fn.launches
    got = fn(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    want = FDB_REFS[kernel](*args, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert got[0].dtype == dtype and got[0].shape == (M, N)
    rtol, atol = FDB_ELEM_TOL[dtype]
    err = (got[0].double() - want[0].double()).abs()
    rms = want[0].double().square().mean().sqrt()
    assert (err / (rtol * want[0].double().abs() + atol * rms)).max() <= 1.0
    if kernel == "k4" or kernel == "k6":
        tol = 1e-12 if dtype == torch.float64 else 1e-5
        mean, var = want[1].double(), want[2].double()
        ey2 = var + mean * mean
        assert ((got[1] - mean).abs() <= tol * (mean.abs() + ey2.sqrt())).all()
        assert ((got[2] - var).abs() <= tol * (var.abs() + ey2)).all()


@pytest.mark.cuda
def test_fused_dense_bn_autograd_on_cuda():
    """The public ops on CUDA tensors run their kernels forward and the
    plain version's autograd backward: gradients equal the plain
    version's own, launched once each."""
    _need_card()
    x, scale, shift, w = (t.double().requires_grad_() for t in
                          _fdb_inputs("k6", 1000, 72, 40, torch.float64, 3))
    before = fdb.bn_act_matmul_stats_fwd.launches
    y, mean, var = fdb.bn_act_matmul_stats(x, scale, shift, w)
    assert fdb.bn_act_matmul_stats_fwd.launches == before + 1
    loss = y.square().sum() + mean.sum() + var.sum()
    got = torch.autograd.grad(loss, (x, scale, shift, w))
    y, mean, var = fdb.bn_mm_stats_ref(x, scale, shift, w)
    want = torch.autograd.grad(y.square().sum() + mean.sum() + var.sum(),
                               (x, scale, shift, w))
    assert fdb.bn_act_matmul_stats_fwd.launches == before + 1
    for a, b in zip(got, want):
        assert torch.allclose(a, b, rtol=1e-10, atol=1e-10)
    with pytest.raises(ValueError, match="scale and shift"):
        fdb.bn_act_matmul_fwd(x.float(), scale, shift, w.float())


# K3: (B, T, dtype): BERT-long's ring block (T 4096 over sp=4), then one
# f32 and one f16 shape
K3_CASES = [(8, 1024, torch.bfloat16), (2, 512, torch.float32),
            (4, 1024, torch.float16)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,dtype", K3_CASES)
def test_k3_matches_plain_version(B, T, dtype):
    """splash_block_with_lse launches K1-fwd with its LSE at scale 1.0,
    full mask, on a pre-scaled q; per element against its plain version,
    LSE within 1e-4. Under grad it raises rather than detach."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(T + B)
    q, k, v = (torch.randn(B, T, 12, 64, generator=g, device="cuda")
               .to(dtype) for _ in range(3))
    q = q * torch.tensor(0.125, dtype=dtype)
    before = fa.splash_block_with_lse.launches
    out, lse = fa.splash_block_with_lse(q, k, v)
    torch.cuda.synchronize()
    assert fa.splash_block_with_lse.launches == before + 1
    want_out, want_lse = fa.splash_block_with_lse_ref(q, k, v)
    ratio, rms = _held(out, want_out, dtype)
    assert ratio <= 1.0, f"out: error / limit {ratio}, RMS {rms}"
    assert lse.dtype == torch.float32 and lse.shape == (B, 12, T)
    assert (lse - want_lse).abs().max().item() <= 1e-4
    with pytest.raises(RuntimeError, match="no backward"):
        fa.splash_block_with_lse(q.requires_grad_(), k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_sp4_ring_on_the_card_matches_k1(causal):
    """The in-process sp=4 ring on the card at f32: ring_splash (K3, 16
    launches) or causal ring_attention, out and the q/k/v gradients, per
    element against single-device K1 under ELEM_TOL[f32] (the same f32
    attention summed in other orders); ring_splash also against its
    plain version (K3's plain version in every block). Causal
    ring_attention's gradients take ten times the f32 atol: in the rows
    with few keys the exact dq is near 0, ds = p (dp - delta) cancels,
    and the ring rounds the logits at other points than K1 (q k^T, then
    the scale, as the JAX package's `_block_attn`), so the f32 noise
    there differs (measured 1.1e-5 of the RMS on an H100)."""
    _need_card()
    B, T, N, H, scale = 2, 1024, 12, 64, 0.125
    g = torch.Generator(device="cuda").manual_seed(20 + causal)
    q, k, v, ct = (torch.randn(B, T, N, H, generator=g, device="cuda")
                   for _ in range(4))
    mesh = tmesh.make_mesh(tmesh.MeshConfig(sp=4),
                           devices=[torch.device("cuda", 0)] * 4)

    def run(fn):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        out = fn(*leaves)
        return [out] + list(torch.autograd.grad((out * ct).sum(), leaves))

    before = fa.splash_block_with_lse.launches
    if causal:
        got = run(lambda a, b, c: tra.ring_attention(a, b, c, mesh,
                                                     causal=True,
                                                     scale=scale))
        wants = [run(lambda a, b, c: fa.flash_attention(a, b, c, scale,
                                                        True))]
    else:
        got = run(lambda a, b, c: tra.ring_splash(a, b, c, mesh,
                                                  scale=scale))
        assert fa.splash_block_with_lse.launches == before + 16
        wants = [run(lambda a, b, c: fa.flash_attention(a, b, c, scale,
                                                        False)),
                 run(lambda a, b, c: tra.ring_splash_ref(a, b, c, mesh,
                                                         scale=scale))]
    for want in wants:
        for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
            tol = (1e-5, 1e-4) if causal and name != "out" else None
            ratio, rms = _held(a, b, torch.float32, tol)
            assert ratio <= 1.0, f"{name}: error / limit {ratio}, RMS {rms}"



# The bf16/f16 Hopper forwards (wgmma, TMA) beyond the shapes above:
# (kernel, B, T, Tk, N, H, causal, dtype, layout). K1 at BERT-long's
# no-mesh shape cut in batch, at H 128 (ragged, causal and not), on the
# strided views of one fused [B, T, 3, N, H] projection, and at f16; K2
# at H 128, with a Tk that is not a multiple of 128, and with a full
# bias at f16.
HOPPER_CASES = [("k1", 1, 4096, 4096, 12, 64, False, torch.bfloat16, "plain"),
                ("k1", 2, 300, 300, 4, 128, True, torch.bfloat16, "plain"),
                ("k1", 2, 256, 200, 4, 128, False, torch.float16, "plain"),
                ("k1", 4, 384, 384, 12, 64, True, torch.bfloat16, "fused"),
                ("k1", 2, 130, 130, 12, 64, False, torch.float16, "fused"),
                ("k2", 2, 256, 256, 8, 128, False, torch.bfloat16, "mask"),
                ("k2", 4, 200, 300, 12, 64, False, torch.bfloat16, "mask"),
                ("k2", 2, 256, 300, 4, 64, True, torch.float16, "full")]


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,B,T,Tk,N,H,causal,dtype,layout",
                         HOPPER_CASES)
def test_hopper_forwards_match_plain_version(kernel, B, T, Tk, N, H, causal,
                                             dtype, layout):
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(T + Tk + H)
    if layout == "fused":
        qkv = torch.randn(B, T, 3, N, H, generator=g, device="cuda").to(dtype)
        q, k, v = qkv.unbind(2)
    else:
        q = torch.randn(B, T, N, H, generator=g, device="cuda").to(dtype)
        k, v = (torch.randn(B, Tk, N, H, generator=g, device="cuda")
                .to(dtype) for _ in range(2))
    if kernel == "k1":
        before = fa.flash_attention_with_lse.launches
        out, lse = fa.flash_attention_with_lse(q, k, v, 0.125, causal)
        torch.cuda.synchronize()
        assert fa.flash_attention_with_lse.launches == before + 1
        want, want_lse = fa.flash_attention_ref(q, k, v, 0.125, causal,
                                                with_lse=True)
        assert (lse - want_lse).abs().max().item() <= 1e-4
    else:
        if layout == "full":
            bias = torch.randn(B, N, T, Tk, generator=g, device="cuda")
        else:
            lens = torch.randint(Tk // 2, Tk + 1, (B,), generator=g,
                                 device="cuda")
            bias = torch.where(torch.arange(Tk, device="cuda")[None] <
                               lens[:, None], 0.0, -1e9)[:, None, None, :]
        out, l, m = fb.flash_attention_bias_fwd(q, k, v, bias, 0.125, causal)
        torch.cuda.synchronize()
        want, want_l, want_m = fb.flash_attention_bias_ref(q, k, v, bias,
                                                           0.125, causal)
        assert ((l - want_l).abs() / want_l).max().item() <= 1e-5
        assert (m - want_m).abs().max().item() <= 1e-4
    ratio, rms = _held(out, want, dtype)
    assert ratio <= 1.0, f"out: error / limit {ratio}, RMS {rms}"


# K1-bwd on the Hopper kernels beyond the training shapes: (B, T, N, H,
# causal, dtype, layout): H 128 (ragged and causal; strided views of one
# fused [B, T, 3, N, H] projection), f16 (ragged, fused views; causal),
# causal over several tiles on fused views, and BERT-long's no-mesh T
# 4096 cut to batch 1
HOPPER_BWD_CASES = [(2, 300, 4, 128, True, torch.bfloat16, "plain"),
                    (2, 256, 4, 128, False, torch.bfloat16, "fused"),
                    (2, 256, 4, 128, False, torch.float16, "fused"),
                    (2, 130, 12, 64, False, torch.float16, "fused"),
                    (2, 300, 4, 64, True, torch.float16, "plain"),
                    (4, 384, 12, 64, True, torch.bfloat16, "fused"),
                    (1, 4096, 12, 64, False, torch.bfloat16, "plain")]


# the Hopper backward's gradients at f16 under `chip_smoke.py`'s
# ATTN_F16_TOL: ELEM_TOL's f16 atol lies below the plain version's own
# f32 noise at these shapes (see there)
BWD_ELEM_TOL = {**ELEM_TOL, torch.float16: ATTN_F16_TOL}


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,N,H,causal,dtype,layout", HOPPER_BWD_CASES)
def test_hopper_backward_matches_plain_version(B, T, N, H, causal, dtype,
                                               layout):
    """dkv and dq (one launch each) against their plain versions, per
    element under BWD_ELEM_TOL, from the plain forward's residuals."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(T + H + causal)
    if layout == "fused":
        qkv = torch.randn(B, T, 3, N, H, generator=g, device="cuda").to(dtype)
        q, k, v = qkv.unbind(2)
    else:
        q, k, v = (torch.randn(B, T, N, H, generator=g, device="cuda")
                   .to(dtype) for _ in range(3))
    do = torch.randn(B, T, N, H, generator=g, device="cuda").to(dtype)
    scale = 1.0 / H ** 0.5
    out, lse = fa.flash_attention_ref(q, k, v, scale, causal, with_lse=True)
    delta = fa.attention_delta_ref(out, do)
    counts = (fa.flash_attention_bwd_dkv.launches,
              fa.flash_attention_bwd_dq.launches)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, scale,
                                        causal)
    dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, scale, causal)
    torch.cuda.synchronize()
    assert (fa.flash_attention_bwd_dkv.launches,
            fa.flash_attention_bwd_dq.launches) == (counts[0] + 1,
                                                    counts[1] + 1)
    want_dk, want_dv = fa.flash_attention_bwd_dkv_ref(q, k, v, do, lse,
                                                      delta, scale, causal)
    want_dq = fa.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, scale,
                                            causal)
    for name, a, b in (("dq", dq, want_dq), ("dk", dk, want_dk),
                       ("dv", dv, want_dv)):
        assert a.dtype == dtype and a.shape == (B, T, N, H)
        ratio, rms = _held(a, b, dtype, BWD_ELEM_TOL[dtype])
        assert ratio <= 1.0, f"{name}: error / limit {ratio}, RMS {rms}"


@pytest.mark.cuda
def test_backward_wrappers_raise_on_a_misaligned_view():
    """The bf16 backward kernels read q, k, v and dO through TMA: a view
    whose base is not 16-byte aligned raises, and launches nothing."""
    _need_card()
    x = torch.randn(1, 64, 2, 72, device="cuda").to(torch.bfloat16)
    q = x[..., 1:65]
    do = torch.randn(1, 64, 2, 64, device="cuda").to(torch.bfloat16)
    lse = torch.zeros(1, 2, 64, device="cuda")
    counts = (fa.flash_attention_bwd_dkv.launches,
              fa.flash_attention_bwd_dq.launches)
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_attention_bwd_dkv(q, q, q, do, lse, lse, 0.125)
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_attention_bwd_dq(q, q, q, do, lse, lse, 0.125)
    assert (fa.flash_attention_bwd_dkv.launches,
            fa.flash_attention_bwd_dq.launches) == counts


@pytest.mark.cuda
def test_forward_wrappers_raise_on_a_misaligned_view():
    """TMA reads q, k and v in place: a bf16 view whose base is not 16-
    byte aligned raises in both forwards, and launches nothing; f32 runs
    the FMA kernels, which take it."""
    _need_card()
    x = torch.randn(1, 64, 2, 72, device="cuda")
    q = x.to(torch.bfloat16)[..., 1:65]
    mask = torch.zeros(1, 1, 1, 64, device="cuda")
    counts = (fa.flash_attention.launches,
              fb.flash_attention_bias_fwd.launches)
    with pytest.raises(ValueError, match="TMA"):
        fa.flash_attention(q, q, q, 0.125)
    with pytest.raises(ValueError, match="TMA"):
        fb.flash_attention_bias_fwd(q, q, q, mask, 0.125)
    assert (fa.flash_attention.launches,
            fb.flash_attention_bias_fwd.launches) == counts
    f = x[..., 1:65]
    ratio, _ = _held(fa.flash_attention(f, f, f, 0.125),
                     fa.flash_attention_ref(f, f, f, 0.125), torch.float32)
    assert ratio <= 1.0


@pytest.mark.cuda
def test_tiny_bert_step_runs_through_the_xla_gate():
    """BertConfig.tiny() (head dim 16) trains a step on the card: every
    attention call takes the "xla" route, and no K1 kernel launches."""
    _need_card()
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel.train import make_train_step

    cfg = bert.BertConfig.tiny()
    params, _ = bert.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                          device="cuda")
    batch = bert.make_batch(torch.Generator(device="cuda").manual_seed(1),
                            cfg, 4, seq_len=64)
    k1 = (fa.flash_attention_with_lse, fa.flash_attention_bwd_dkv,
          fa.flash_attention_bwd_dq)
    before, xla = [f.launches for f in k1], ta.GATE_COUNTS["xla"]
    init, step = make_train_step(
        lambda p, b, g: bert.pretrain_loss(p, cfg, b, rng=g,
                                           deterministic=True),
        lambda ps: torch.optim.AdamW(ps, lr=1e-4), device="cuda",
        precision="mixed_bf16")
    state, loss = step(init(params), batch, 0)
    assert torch.isfinite(loss).item()
    assert ta.GATE_COUNTS["xla"] == xla + cfg.layers
    assert [f.launches for f in k1] == before


def _narrow_bert():
    """A 2-layer BERT of head dim 64 (so K1 runs), its params and a
    batch, all on the card."""
    from paddle_tpu_torch.models import bert

    cfg = bert.BertConfig(vocab_size=1024, hidden=128, layers=2, heads=2,
                          mlp_dim=256, max_len=128, dropout=0.0)
    params, _ = bert.init(torch.Generator(device="cuda").manual_seed(0),
                          cfg, device="cuda")
    batch = bert.make_batch(torch.Generator(device="cuda").manual_seed(1),
                            cfg, 8, seq_len=128)
    return cfg, params, batch


@pytest.mark.cuda
@pytest.mark.parametrize("policy", [None, "nothing", "dots",
                                    "dots_no_batch"], ids=str)
def test_recompute_policy_step_equals_no_recompute(policy):
    """Two mixed_bf16 AdamW steps under `policy` and without recompute
    from the same params: the same losses and params bit for bit, and
    K1-fwd (LSE) runs twice a layer a step under recompute, dq and dkv
    once."""
    _need_card()
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel.train import TrainStrategy, make_train_step

    cfg, params, batch = _narrow_bert()
    runs = []
    for strategy in (TrainStrategy(), TrainStrategy(
            recompute=True, recompute_policy=policy)):
        init, step = make_train_step(
            lambda p, b, g: bert.pretrain_loss(p, cfg, b, rng=g,
                                               deterministic=True),
            lambda ps: torch.optim.AdamW(ps, lr=1e-4, weight_decay=1e-4),
            device="cuda", precision="mixed_bf16", strategy=strategy)
        state = init(params)
        before = [f.launches for f in (fa.flash_attention_with_lse,
                                       fa.flash_attention_bwd_dq,
                                       fa.flash_attention_bwd_dkv)]
        losses = [step(state, batch, i)[1].item() for i in range(2)]
        after = [f.launches for f in (fa.flash_attention_with_lse,
                                      fa.flash_attention_bwd_dq,
                                      fa.flash_attention_bwd_dkv)]
        runs.append((losses, state.params,
                     [a - b for a, b in zip(after, before)]))
    (want, wparams, wn), (got, gparams, gn) = runs
    assert got == want
    for k, v in wparams.items():
        assert torch.equal(gparams[k], v), k
    L = cfg.layers
    assert wn == [2 * L, 2 * L, 2 * L] and gn == [4 * L, 2 * L, 2 * L]


@pytest.mark.cuda
def test_checkpoint_restores_onto_the_templates_device(tmp_path):
    """A checkpoint written from the card restores into a CPU template
    on the CPU, and one written on the CPU into a CUDA template on the
    card: params and optimizer state equal, each on its template's
    device."""
    _need_card()
    from paddle_tpu_torch.models import bert
    from paddle_tpu_torch.parallel.checkpoint import (restore_train_state,
                                                      save_train_state)
    from paddle_tpu_torch.parallel.train import make_train_step

    cfg, params, batch = _narrow_bert()

    def build(device):
        return make_train_step(
            lambda p, b, g: bert.pretrain_loss(p, cfg, b, rng=g,
                                               deterministic=True),
            lambda ps: torch.optim.AdamW(ps, lr=1e-4), device=device,
            precision="f32")

    init, step = build("cuda")
    state, _ = step(init(params), batch, 0)
    save_train_state(str(tmp_path / "cuda"), state)
    cpu_init, _ = build("cpu")
    got = restore_train_state(str(tmp_path / "cuda"), cpu_init(params))
    assert got.step == 1
    for k, v in got.params.items():
        assert v.device.type == "cpu" and torch.equal(v, state.params[k].cpu())
    for st in got.opt_state.state.values():
        assert st["exp_avg"].device.type == "cpu"
    save_train_state(str(tmp_path / "cpu"), got)
    back = restore_train_state(str(tmp_path / "cpu"), init(params))
    for k, v in back.params.items():
        assert v.device.type == "cuda" and torch.equal(v, state.params[k])
    for st in back.opt_state.state.values():
        assert st["exp_avg"].device.type == "cuda"


# K2-bwd on the Hopper kernels at bf16, beyond K2_CASES: (B, T, Tk, N, H,
# causal, full bias). Transformer-big's encoder call cut in batch (the
# stride-0 key mask, k and v the views of one fused kv projection),
# causal with Tk = 2 T, a full [B, N, T, Tk] bias with its gradient, and
# H 128 with a ragged Tk
HOPPER_K2_BWD_CASES = [(4, 128, 128, 16, 64, False, False),
                       (2, 128, 256, 4, 64, True, False),
                       (2, 128, 128, 4, 64, False, True),
                       (4, 256, 300, 8, 128, False, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,Tk,N,H,causal,full", HOPPER_K2_BWD_CASES)
def test_hopper_k2_backward_matches_plain_version(B, T, Tk, N, H, causal,
                                                  full):
    """dkv and dq (one launch each; dq with the bias gradient for a full
    bias) against their plain versions from the plain forward's
    residuals, per element under ELEM_TOL (dbias under f32's); the
    profiler shows the Hopper kernels and no FMA one."""
    _need_card()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    dtype = torch.bfloat16
    q, k, v, do, bias = _k2_inputs(B, T, Tk, N, H, dtype, full, T + Tk + H)
    out, l, m = fb.flash_attention_bias_ref(q, k, v, bias, 0.125, causal)
    delta = fa.attention_delta_ref(out, do)
    args = (q, k, v, bias, do, l, m, delta, 0.125, causal)
    counts = (fb.flash_attention_bias_bwd_dkv.launches,
              fb.flash_attention_bias_bwd_dq.launches)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        dk, dv = fb.flash_attention_bias_bwd_dkv(*args)
        dq = fb.flash_attention_bias_bwd_dq(*args, with_dbias=full)
        torch.cuda.synchronize()
    assert (fb.flash_attention_bias_bwd_dkv.launches,
            fb.flash_attention_bias_bwd_dq.launches) == (counts[0] + 1,
                                                         counts[1] + 1)
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA and "flash_bias" in e.name]
    assert len(kernels) == 2 and all("_sm90_kernel" in n for n in kernels), \
        kernels
    want_dk, want_dv = fb.flash_attention_bias_bwd_dkv_ref(*args)
    want_dq = fb.flash_attention_bias_bwd_dq_ref(*args, with_dbias=full)
    got = [("dk", dk, want_dk, dtype), ("dv", dv, want_dv, dtype)]
    if full:
        got += [("dq", dq[0], want_dq[0], dtype),
                ("dbias", dq[1], want_dq[1], torch.float32)]
    else:
        got += [("dq", dq, want_dq, dtype)]
    for name, a, b, dt in got:
        assert a.dtype == dt and a.shape == b.shape, name
        ratio, rms = _held(a, b, dt)
        assert ratio <= 1.0, f"{name}: error / limit {ratio}, RMS {rms}"


@pytest.mark.cuda
def test_k2_backward_wrappers_raise_on_a_misaligned_view():
    """K2-bwd's bf16 kernels read q, k, v and dO through TMA: a view whose
    base is not 16-byte aligned raises rather than running the FMA
    kernel, and launches nothing."""
    _need_card()
    x = torch.randn(1, 64, 2, 72, device="cuda").to(torch.bfloat16)
    q = x[..., 1:65]
    do = torch.randn(1, 64, 2, 64, device="cuda").to(torch.bfloat16)
    rows = torch.ones(1, 2, 64, device="cuda")
    mask = torch.zeros(1, 1, 1, 64, device="cuda")
    counts = (fb.flash_attention_bias_bwd_dkv.launches,
              fb.flash_attention_bias_bwd_dq.launches)
    with pytest.raises(ValueError, match="TMA"):
        fb.flash_attention_bias_bwd_dkv(q, q, q, mask, do, rows, rows, rows,
                                        0.125)
    with pytest.raises(ValueError, match="TMA"):
        fb.flash_attention_bias_bwd_dq(q, q, q, mask, do, rows, rows, rows,
                                       0.125, with_dbias=True)
    assert (fb.flash_attention_bias_bwd_dkv.launches,
            fb.flash_attention_bias_bwd_dq.launches) == counts


# The backwards' two-launch form at bf16 and f16: the dq kernel computes
# delta in its prologue from the forward's output and writes it for dkv.
# K1: (B, T, N, H, causal, dtype): a ragged T of 200 causal and full, H
# 128 full and causal, and BERT-base's 256 x 128. K2: (B, T, Tk, N, H,
# causal, dtype, full bias, its gradient): the ragged 200 with a key mask,
# and with a full bias and its gradient; causal with a full bias at Tk
# 300 and at H 128; f16 with a full bias (non-causal with its gradient,
# and causal under ATTN_F16_TOL, ROADMAP F4); and Transformer-big's
# encoder call cut in batch. The bias gradient is asked for where it
# holds f32's ELEM_TOL: at causal shapes with a full bias it reads more
# (3.2 and 3.7 of it at bf16 and f16, on an H100), from S summed on the
# tensor cores where p is near 1 (PERF.md).
K1_FOLD_CASES = [(2, 200, 4, 64, True, torch.bfloat16),
                 (2, 200, 4, 64, False, torch.float16),
                 (2, 200, 4, 128, False, torch.bfloat16),
                 (2, 256, 4, 128, True, torch.float16),
                 (256, 128, 12, 64, False, torch.bfloat16)]
K2_FOLD_CASES = [(2, 200, 200, 4, 64, False, torch.bfloat16, False, False),
                 (2, 200, 164, 4, 64, False, torch.bfloat16, True, True),
                 (2, 200, 300, 4, 64, True, torch.bfloat16, True, False),
                 (2, 128, 128, 4, 128, True, torch.bfloat16, True, False),
                 (2, 100, 164, 2, 64, False, torch.float16, True, True),
                 (4, 128, 128, 12, 64, True, torch.float16, True, False),
                 (4, 128, 128, 16, 64, False, torch.bfloat16, False, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,N,H,causal,dtype", K1_FOLD_CASES)
def test_k1_folded_delta_matches_plain_version(B, T, N, H, causal, dtype):
    """The dq kernel given the forward's output: its delta per element
    against `attention_delta_ref` under f32's ELEM_TOL, its dq bit for
    bit the external-delta launch's given that delta; the whole backward
    (dq, then dkv) against the plain version under BWD_ELEM_TOL, with no
    standalone delta launch and one fold a backward."""
    _need_card()
    g = torch.Generator(device="cuda").manual_seed(T + H + causal + B)
    q, k, v, do = (torch.randn(B, T, N, H, generator=g, device="cuda")
                   .to(dtype) for _ in range(4))
    scale = 1.0 / H ** 0.5
    out, lse = fa.flash_attention_ref(q, k, v, scale, causal, with_lse=True)
    out = out.contiguous()
    counts = _k1_bwd_counts()
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, do, lse, None, scale,
                                          causal, o=out)
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, scale, causal)
    torch.cuda.synchronize()
    assert _k1_bwd_counts() == [c + d for c, d in zip(counts, (0, 1, 2, 2))]
    ratio, rms = _held(delta, fa.attention_delta_ref(out, do), torch.float32)
    assert ratio <= 1.0, f"delta: error / limit {ratio}, RMS {rms}"
    assert torch.equal(dq, fa.flash_attention_bwd_dq(q, k, v, do, lse, delta,
                                                     scale, causal))
    assert torch.equal(dq, got[0])
    want = fa.flash_attention_bwd_ref(q, k, v, out, lse, do, scale, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == (B, T, N, H)
        ratio, rms = _held(a, b, dtype, BWD_ELEM_TOL[dtype])
        assert ratio <= 1.0, f"{name}: error / limit {ratio}, RMS {rms}"


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,Tk,N,H,causal,dtype,full,dbias",
                         K2_FOLD_CASES)
def test_k2_folded_delta_matches_plain_version(B, T, Tk, N, H, causal, dtype,
                                               full, dbias):
    """K2's dq kernel given the forward's output (with the bias gradient
    where asked): its delta per element against `attention_delta_ref`
    under f32's ELEM_TOL, its dq (and dbias) bit for bit the
    external-delta launch's given that delta; dq, dk, dv from the two
    launches against the plain versions under ELEM_TOL (ATTN_F16_TOL for
    the f16 causal case), dbias under f32's; no standalone delta launch,
    and the profiler shows the Hopper kernels alone."""
    _need_card()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    q, k, v, do, bias = _k2_inputs(B, T, Tk, N, H, dtype, full,
                                   T + Tk + H + causal)
    scale = 0.125
    out, l, m = fb.flash_attention_bias_ref(q, k, v, bias, scale, causal)
    out = out.contiguous()
    counts = _k2_bwd_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        *dq_ds, delta = fb.flash_attention_bias_bwd_dq(
            q, k, v, bias, do, l, m, None, scale, causal, with_dbias=dbias,
            o=out)
        dk, dv = fb.flash_attention_bias_bwd_dkv(q, k, v, bias, do, l, m,
                                                 delta, scale, causal)
        torch.cuda.synchronize()
    assert _k2_bwd_counts() == [c + d for c, d in zip(counts, (0, 1, 1, 1))]
    kernels = [e.name for e in prof.events()
               if e.device_type == DeviceType.CUDA and
               ("flash_" in e.name or "delta_kernel" in e.name)]
    assert len(kernels) == 2 and all("flash_bias_bwd" in n and
                                     "_sm90_kernel" in n for n in kernels), \
        kernels
    ratio, rms = _held(delta, fa.attention_delta_ref(out, do), torch.float32)
    assert ratio <= 1.0, f"delta: error / limit {ratio}, RMS {rms}"
    external = fb.flash_attention_bias_bwd_dq(q, k, v, bias, do, l, m, delta,
                                              scale, causal, with_dbias=dbias)
    for a, b in zip(dq_ds, external if dbias else (external,)):
        assert torch.equal(a, b)
    *want_dq_ds, want_delta = fb.flash_attention_bias_bwd_dq_ref(
        q, k, v, bias, do, l, m, None, scale, causal, with_dbias=dbias, o=out)
    want_dk, want_dv = fb.flash_attention_bias_bwd_dkv_ref(
        q, k, v, bias, do, l, m, want_delta, scale, causal)
    tol = ATTN_F16_TOL if dtype == torch.float16 and causal else None
    got = [("dq", dq_ds[0], want_dq_ds[0], dtype),
           ("dk", dk, want_dk, dtype), ("dv", dv, want_dv, dtype)]
    if dbias:
        got.append(("dbias", dq_ds[1], want_dq_ds[1], torch.float32))
    for name, a, b, dt in got:
        assert a.dtype == dt and a.shape == b.shape, name
        ratio, rms = _held(a, b, dt, tol if dt == dtype else None)
        assert ratio <= 1.0, f"{name}: error / limit {ratio}, RMS {rms}"


# The decode engine's captured steps. Every request is queued before the
# scheduler's first admission (the test holds the engine's lock while it
# submits), so the run is deterministic: 4 prompts of 28 tokens that fill
# a pool of 16 usable blocks (4 slots), then 8 of 3 tokens admitted as
# those finish (8 slots), growing past the pool (preemptions) and
# finishing at different lengths (back to 4 slots).
DECODE_POOL = dict(block_size=8, num_blocks=17, decode_slots=(4, 8),
                   prefill_buckets=(8, 16, 32, 64), max_len=64)


@pytest.mark.cuda
def test_fluid_lenet_step_on_the_card_matches_the_cpu():
    """bench.py's LeNet rung as a fluid Program (batch 32, f32, TF32
    off for cuBLAS and cuDNN): one Adam step on `CUDAPlace(0)` against `CPUPlace()` from the
    same numpy params: the loss, every parameter gradient and the
    updated params, at chip_smoke.py's FLUID_TOL."""
    _need_card()
    import numpy as np

    import paddle_tpu_torch as pt
    from chip_smoke import FLUID_TOL, fluid_adam_slack, lenet_rung_program
    from paddle_tpu_torch.convert import scope_from_numpy

    main, startup, loss = lenet_rung_program(pt)
    rng = np.random.RandomState(0)
    feed = {"x": rng.rand(32, 1, 28, 28).astype("float32"),
            "y": rng.randint(0, 10, (32, 1)).astype("int64")}
    s0 = pt.Scope()
    pt.Executor(pt.CPUPlace()).run(startup, scope=s0)
    init = {v.name: s0.get(v.name) for v in startup.list_vars()
            if v.persistable}
    params = [p.name for p in main.all_parameters()]
    out = {}
    conv_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False  # cuDNN's convs in f32
    try:
        for place in (pt.CUDAPlace(0), pt.CPUPlace()):
            scope = scope_from_numpy(pt.Scope(), init, place)
            fetched = pt.Executor(place).run(
                main, feed=feed,
                fetch_list=[loss] + [n + "@GRAD" for n in params],
                scope=scope)
            out[repr(place)] = (fetched, {n: scope.get(n) for n in params})
    finally:
        torch.backends.cudnn.allow_tf32 = conv_tf32
    (got, got_p), (want, want_p) = out["CUDAPlace(0)"], out["CPUPlace"]
    assert abs(got[0][0] - want[0][0]) <= FLUID_TOL["loss"] * abs(want[0][0])
    for n, a, b in zip(params, got[1:], want[1:]):
        assert np.abs(a - b).max() <= FLUID_TOL["grad"] * np.abs(b).max(), n
        err = np.abs(got_p[n] - want_p[n]) - fluid_adam_slack(2e-3, a, b)
        assert err.max() <= FLUID_TOL["param"] * max(
            1.0, np.abs(want_p[n]).max()), n


def _decode_traffic(vocab):
    g = torch.Generator().manual_seed(0)
    return [(torch.randint(0, vocab, (28,), generator=g).tolist(), n)
            for n in (2, 3, 4, 5)] + \
        [(torch.randint(0, vocab, (3,), generator=g).tolist(), n)
         for n in (30, 28, 26, 24, 22, 20, 18, 16)]


def _serve_traffic(params, cfg, precision, warm):
    """Tokens, status and the slot count of every decode step of one
    engine serving `_decode_traffic`, warmed (`warmup()`) or not."""
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    eng = DecodeEngine(params, cfg, DecodeConfig(precision=precision,
                                                 **DECODE_POOL),
                       device="cuda")
    slots = []
    dispatch = eng._dispatch

    def record(ids, C):
        slots.append(C)
        return dispatch(ids, C)

    eng._dispatch = record
    try:
        if warm:
            assert eng.warmup() == 6
        with eng._cv:
            handles = [eng.submit(p, max_new_tokens=n)
                       for p, n in _decode_traffic(cfg.vocab_size)]
        toks = [h.result(timeout_s=300) for h in handles]
        return toks, eng.status(), slots
    finally:
        eng.stop()


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_warmed_engine_tokens_equal_unwarmed(precision):
    """A warmed engine (every decode step a CUDA graph replay) emits the
    unwarmed engine's tokens bit for bit, through admission mid-decode,
    the slot-count switch 4 -> 8 -> 4 and preemptions; after warmup no
    decode step runs eagerly."""
    _need_card()
    from paddle_tpu_torch.models import gpt

    cfg = gpt.GPTConfig.tiny()
    cfg.dtype = "float32"
    params, _ = gpt.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                         device="cuda")
    eager, eager_st, eager_slots = _serve_traffic(params, cfg, precision,
                                                  False)
    graph, graph_st, graph_slots = _serve_traffic(params, cfg, precision,
                                                  True)
    assert graph == eager
    assert graph_slots == eager_slots
    runs = [c for i, c in enumerate(graph_slots)
            if i == 0 or graph_slots[i - 1] != c]
    assert runs[:3] == [4, 8, 4], runs
    assert graph_st["requests"]["preempted"] > 0
    assert graph_st["requests"] == eager_st["requests"]
    assert graph_st["decode_steps"] == {"replayed": len(graph_slots),
                                        "eager": 0}
    assert eager_st["decode_steps"] == {"replayed": 0,
                                        "eager": len(eager_slots)}


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_warmed_reuse_engine_tokens_equal_unwarmed(precision):
    """A KV-reuse engine (chunk 8, prefix cache, spec_k 2 with a 1-layer
    draft) warmed (chunk, draft_chunk, decode, draft_decode and verify
    CUDA graph replays) emits the unwarmed engine's tokens bit for bit
    through two waves of `_decode_traffic` on a pool of 31 usable blocks
    (the second wave hits the prefix cache, the LRU evicts); after
    warmup no phase runs eagerly."""
    _need_card()
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    cfg, dcfg = gpt.GPTConfig.tiny(), gpt.GPTConfig.tiny()
    cfg.dtype = dcfg.dtype = "float32"
    dcfg.layers = 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    params, _ = gpt.init(gen, cfg, device="cuda")
    dparams, _ = gpt.init(gen, dcfg, device="cuda")
    conf = dict(DECODE_POOL, num_blocks=32, precision=precision,
                prefill_chunk=8, prefix_cache=True, spec_k=2)
    out = {}
    for warm in (False, True):
        eng = DecodeEngine(params, cfg, DecodeConfig(**conf),
                           (dparams, dcfg), device="cuda")
        try:
            if warm:
                assert eng.warmup() == 8
            toks = []
            for _ in range(2):
                with eng._cv:
                    handles = [eng.submit(p, max_new_tokens=n)
                               for p, n in _decode_traffic(cfg.vocab_size)]
                toks.append([h.result(timeout_s=300) for h in handles])
            out[warm] = (toks, eng.status())
        finally:
            eng.stop()
    (eager, eager_st), (graph, graph_st) = out[False], out[True]
    assert graph == eager
    assert graph_st["requests"] == eager_st["requests"]
    assert graph_st["kv"]["prefix_hits_total"] > 0
    assert graph_st["kv"]["evictions_total"] > 0
    assert graph_st["kv"]["blocks_used"] == 0
    # no round nears max_len here, so the plain decode phase never runs
    for kind, runs in graph_st["phase_runs"].items():
        assert runs["eager"] == 0, kind
        assert (runs["replayed"] > 0) == (kind != "decode"), kind
        assert eager_st["phase_runs"][kind] == {
            "replayed": 0, "eager": runs["replayed"]}, kind


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(5, 27, 64), (196, 4608, 512),
                                   (12544, 147, 64), (50176, 27, 64)])
def test_int8_matmul_on_the_card_is_exact(M, K, N):
    """int8_matmul (torch._int_mm, zero-padded where its rules need it)
    equals the plain product exactly, at an M below 17 and at VGG-16's
    and ResNet-50's padded K 27 and 147; and an int8 conv with its
    weight operand kept on the weight equals it again."""
    _need_card()
    from paddle_tpu_torch.ops import int8

    g = torch.Generator(device="cuda").manual_seed(M + K + N)
    a = torch.randint(-127, 128, (M, K), generator=g, device="cuda",
                      dtype=torch.int8)
    b = torch.randint(-127, 128, (K, N), generator=g, device="cuda",
                      dtype=torch.int8)
    want = (a.double() @ b.double()).to(torch.int32)
    assert torch.equal(int8.int8_matmul(a, b), want)
    x = torch.randint(-127, 128, (2, 9, 9, 3), generator=g, device="cuda",
                      dtype=torch.int8)
    w = torch.randint(-127, 128, (3, 3, 3, 16), generator=g, device="cuda",
                      dtype=torch.int8)
    first = int8.conv2d_int8(x, w, 2, "SAME")
    assert torch.equal(int8.conv2d_int8(x, w, 2, "SAME"), first)
    assert getattr(w, "_int8_operands") is not None
    cpu = int8.conv2d_int8(x.cpu(), w.cpu(), 2, "SAME")
    assert torch.equal(first.cpu(), cpu)


@pytest.mark.cuda
def test_int8_weights_are_laid_out_at_load_under_inference_mode(tmp_path):
    """int8 weights made and run inside `torch.inference_mode()` (an
    inference tensor keeps no version count). `quantize_conv_weights_int8`
    lays out each weight's operand as it makes the weight, and the conv
    equals the CPU's bit for bit (the activation's scale and rounding
    are exact on both). The LeNet rung, trained and calibrated on the
    CPU: a Predictor on the card loads its state inside inference mode,
    lays out its int8 ops' weights there, keeps them through requests,
    and replies as the CPU Predictor does within 1e-3 of the largest
    logit (an activation on a rounding boundary may move one int8 step,
    as between the packages in tests/test_torch_predict.py)."""
    _need_card()
    import numpy as np

    import paddle_tpu_torch as pt
    from chip_smoke import (lenet_rung_logits, lenet_rung_program,
                            synthetic_mnist)
    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)
    from paddle_tpu_torch.models.common import (conv2d_nhwc_auto,
                                                quantize_conv_weights_int8)
    from paddle_tpu_torch.slim.quantization import calibrate_and_quantize

    kept = "_int8_operands"
    g = torch.Generator(device="cuda").manual_seed(15)
    with torch.inference_mode():
        w = torch.randn((3, 3, 16, 32), generator=g, device="cuda")
        x = torch.randn((2, 14, 14, 16), generator=g, device="cuda")
        q = quantize_conv_weights_int8({"c.w": w})
        assert q["c.w"].is_inference()
        laid = getattr(q["c.w"], kept)
        got = conv2d_nhwc_auto(q, "c", x, 2)
        assert getattr(q["c.w"], kept) is laid
    cpu = conv2d_nhwc_auto({k: v.cpu() for k, v in q.items()}, "c",
                           x.cpu(), 2)
    assert torch.equal(got.cpu(), cpu)

    main, startup, loss = lenet_rung_program(pt)
    exe = pt.Executor(pt.CPUPlace())
    xs, ys = synthetic_mnist(64, seed=1)
    src, dst = str(tmp_path / "f32"), str(tmp_path / "int8")
    with pt.scope_guard(pt.Scope()):
        exe.run(startup)
        for _ in range(3):
            exe.run(main, feed={"x": xs, "y": ys}, fetch_list=[loss])
        pt.io.save_inference_model(src, ["x"], [lenet_rung_logits(main)],
                                   exe, main_program=main)
    calibrate_and_quantize(
        src, lambda: iter([{"x": xs[i:i + 16]} for i in range(0, 64, 16)]),
        save_model_path=dst, place=pt.CPUPlace())
    cfg = AnalysisConfig(dst)
    cfg.disable_gpu()
    want = create_paddle_predictor(cfg).predict(x=xs[:8])
    conv_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        pred = create_paddle_predictor(AnalysisConfig(dst))
        with torch.inference_mode():
            state = pred._program_state()
            int8_w = {n: t for n, t in state.items()
                      if t.dtype == torch.int8}
            assert len(int8_w) >= 2
            laid = {n: getattr(t, kept) for n, t in int8_w.items()}
            got = pred.predict(x=xs[:8])
            got = pred.predict(x=xs[:8])
        assert all(getattr(t, kept) is laid[n] for n, t in int8_w.items())
    finally:
        torch.backends.cudnn.allow_tf32 = conv_tf32
    for name, v in want.items():
        assert np.abs(got[name] - v).max() <= 1e-3 * np.abs(v).max()


@pytest.mark.cuda
def test_profile_capture_records_kernels_of_another_thread(tmp_path):
    """capture_profile on this thread while another, whose first CUDA
    work is K1-fwd's launch (the launcher makes the device's context
    current there: ROADMAP F11), launches it: the merged trace holds
    the Hopper kernel's records, and perf.json's memory block counts a
    CUDA owner's tensors by storage (a view counted with its base)
    inside the allocator's total."""
    _need_card()
    import json
    import threading

    from paddle_tpu_torch import profiler
    from paddle_tpu_torch.observability import memwatch

    q = torch.randn(1, 256, 12, 64, device="cuda", dtype=torch.bfloat16)
    owned = [q, q[:, :128]]
    handle = memwatch.register_provider("cuda_test", lambda: owned)
    memwatch.sweep(force=True)      # status_block() sweeps once a second
    stop = threading.Event()

    def launch():
        while not stop.is_set():
            fa.flash_attention(q, q, q, 0.125, causal=True)
            torch.cuda.synchronize()

    t = threading.Thread(target=launch, daemon=True)
    try:
        t.start()
        out = profiler.capture_profile(0.5, out_dir=str(tmp_path))
    finally:
        stop.set()
        t.join(timeout=60)
        memwatch.unregister_provider(handle)
    with open(out["trace"]) as f:
        evs = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" and
               "flash_fwd_sm90_kernel" in e.get("name", "") for e in evs)
    with open(out["perf"]) as f:
        mem = json.load(f)["memory"]
    assert mem["owners"]["cuda_test"] == q.untyped_storage().nbytes()
    assert mem["owners"]["cuda_test"] <= mem["total_bytes"]


# GPT-2-small bf16 decoding on CUDA graphs in 6 streams while this
# thread takes short profile captures: argv out dir, capture count
_CAPTURES_DURING_REPLAYS = r"""
import sys
import threading

import torch

from paddle_tpu_torch import profiler
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

out, n = sys.argv[1], int(sys.argv[2])
cfg = gpt.GPTConfig()
params, _ = gpt.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                     device="cuda")
eng = DecodeEngine(params, cfg, DecodeConfig(
    block_size=16, num_blocks=512, decode_slots=(4, 8)), device="cuda")
eng.warmup()
eng.start()
stop = threading.Event()


def stream(i):
    while not stop.is_set():
        eng.submit([1 + i, 2, 3], max_new_tokens=64).result(timeout_s=120)


threads = [threading.Thread(target=stream, args=(i,), daemon=True)
           for i in range(6)]
for t in threads:
    t.start()
try:
    for i in range(n):
        profiler.capture_profile(0.05, out_dir=f"{out}/{i}")
finally:
    stop.set()
    for t in threads:
        t.join(120)
    eng.stop()
print("replayed", eng.status()["decode_steps"]["replayed"])
"""


@pytest.mark.cuda
def test_profile_captures_during_graph_replays_end(tmp_path):
    """ROADMAP F12: a capture's start or stop that overlapped a CUDA-graph
    replay on the decode thread hung the process. 30 captures while 6
    streams decode on graphs end, in a child process the limit kills."""
    _need_card()
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        r = subprocess.run([sys.executable, "-c", _CAPTURES_DURING_REPLAYS,
                            str(tmp_path), "30"], cwd=root, timeout=300,
                           capture_output=True, text=True)
    except subprocess.TimeoutExpired as e:
        pytest.fail(f"the captures hung: {e.stderr}")
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.split()[-1]) > 0
    assert len(os.listdir(tmp_path)) == 30


@pytest.mark.cuda
def test_a_capture_that_fails_raises(monkeypatch):
    """A decode step that syncs with the host cannot be captured: warmup
    raises and the engine refuses to serve (it never falls back to the
    eager step). Last in this file: the failed capture is the one CUDA
    error here on purpose."""
    _need_card()
    from paddle_tpu_torch.models import gpt
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine

    cfg = gpt.GPTConfig.tiny()
    params, _ = gpt.init(torch.Generator(device="cuda").manual_seed(0), cfg,
                         device="cuda")
    real = gpt.apply_decode_step

    def host_sync(params, cfg, ids, *a, **kw):
        int(ids.sum())          # a device-to-host read: illegal in capture
        return real(params, cfg, ids, *a, **kw)

    monkeypatch.setattr(gpt, "apply_decode_step", host_sync)
    eng = DecodeEngine(params, cfg, DecodeConfig(decode_slots=(4,),
                                                 prefill_buckets=(8,),
                                                 max_len=64), device="cuda")
    try:
        with pytest.raises(RuntimeError):
            eng.warmup()
        assert eng.analysis["errors"] == 1 and not eng.warmed
        with pytest.raises(RuntimeError, match="warmup failed"):
            eng.start()
    finally:
        eng.stop()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_device_prefetcher_puts_batches_on_the_card_in_order():
    """A DataLoader with the double buffer to `CUDAPlace(0)`: batches
    arrive as CUDA tensors, in order, equal to the host's, from pinned
    memory on the prefetch thread's side stream; the threads end with
    the loop."""
    _need_card()
    import threading

    import numpy as np

    import paddle_tpu_torch as pt

    batches = [{"x": np.full((64, 32), i, "float32"),
                "y": np.arange(64, dtype="int64") + i} for i in range(12)]
    loader = pt.DataLoader.from_generator(feed_list=[], capacity=4,
                                          use_double_buffer=True)
    loader.set_batch_generator(lambda: iter(batches),
                               places=pt.CUDAPlace(0))
    got = list(loader())
    assert len(got) == 12
    for want, b in zip(batches, got):
        assert b["x"].is_cuda and b["y"].dtype == torch.int64
        # read on the consumer's stream, after the copy's event
        assert torch.equal(b["x"].cpu(), torch.from_numpy(want["x"]))
        assert torch.equal(b["y"].cpu(), torch.from_numpy(want["y"]))
    assert not any(t.name.startswith("paddle-tpu-prefetch")
                   for t in threading.enumerate() if t.is_alive())


@pytest.mark.cuda
@pytest.mark.parametrize("opt", ["sgd", "adagrad", "adam"])
def test_sparse_embedding_equals_dense_on_the_card(opt):
    """chip_smoke.py's CTR program (ids repeating within a batch): the
    sparse table equals the dense one bit for bit after 3 steps, since
    both merge repeated ids in arrival order (`core/selected_rows.py`)."""
    _need_card()
    import numpy as np

    import paddle_tpu_torch as pt
    from chip_smoke import ctr_feeds, ctr_program

    tables = []
    for is_sparse in (True, False):
        main, startup, loss, table = ctr_program(pt, opt, is_sparse)
        exe = pt.Executor(pt.CUDAPlace(0))
        scope = pt.Scope()
        exe.run(startup, scope=scope)
        for f in ctr_feeds(3, seed=1):
            exe.run(main, feed=f, fetch_list=[loss], scope=scope)
        tables.append(scope.get(table))
    assert np.array_equal(tables[0], tables[1])
