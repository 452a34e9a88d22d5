"""The port's GPipe pipeline (`parallel/pipeline.py`) and GPT under
`pp` (dense and mixture-of-experts, with `ep` and `sp` beside it)
against the JAX package's on the CPU.

The JAX package runs on the conftest's virtual 8-device CPU mesh under
`jax.jit` inside `mesh_guard`; the port on in-process rings of CPU
ranks (`make_mesh(MeshConfig(pp=2, ep=2), devices=["cpu"] * 4)`).
Inputs are numpy from a seed, handed to both.

Tolerances, at f32: `pipeline_apply`'s outputs and gradients within
1e-6 absolute of a sequential loop and of the JAX package's (the JAX
package's own limit for its pipeline against a loop); the GPT losses
within 1e-6 relative and each gradient's RMS difference within 1e-5 of
its RMS (`test_torch_moe.check_loss_and_grads`). A pipelined MoE loss
is not the unpipelined one (the capacity C comes from a microbatch's
tokens), so its references are the JAX package's pipelined loss and
the port's own `apply` run microbatch by microbatch without a mesh.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.models import gpt as jgpt
from paddle_tpu.parallel import MeshConfig as JMeshConfig
from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel import mesh_guard as jmesh_guard
from paddle_tpu.parallel.pipeline import pipeline_apply as jpipeline_apply

from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.observability import telemetry
from paddle_tpu_torch.ops import attention as tattn
from paddle_tpu_torch.parallel import mesh as tmesh
from paddle_tpu_torch.parallel import pipeline as tpipe
from paddle_tpu_torch.parallel import sharding as tsharding
from paddle_tpu_torch.parallel.train import make_train_step

from test_torch_moe import check_loss_and_grads

torch.set_num_threads(2)


def _tmesh(**axes):
    n = int(np.prod(list(axes.values())))
    return tmesh.make_mesh(tmesh.MeshConfig(dp=1, **axes), devices=["cpu"] * n)


def _jmesh(**axes):
    n = int(np.prod(list(axes.values())))
    return jmake_mesh(JMeshConfig(dp=1, **axes), devices=jax.devices()[:n])


def _tanh_stage(p, x):
    return torch.tanh(x @ p["w"].to(x.dtype))


def _inputs(seed, S=4, n_micro=6):
    rs = np.random.RandomState(seed)
    return ((rs.rand(S, 8, 8) * 0.5).astype(np.float32),
            rs.rand(n_micro, 4, 8).astype(np.float32))


def test_pipeline_matches_sequential_and_the_jax_package():
    """tanh stages over pp=4, 6 microbatches: outputs and the gradients
    of the stage weights and the input against a sequential loop and
    against the JAX package's `pipeline_apply` on 4 CPU devices."""
    ws, x = _inputs(0)
    ct = np.random.RandomState(1).rand(*x.shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jpipeline_apply(
            lambda q, h: jnp.tanh(h @ q["w"]), p, xx, mesh) * ct)

    mesh = _jmesh(pp=4)
    with jmesh_guard(mesh):
        jout = jax.jit(lambda p, xx: jpipeline_apply(
            lambda q, h: jnp.tanh(h @ q["w"]), p, xx, mesh))(
            {"w": jnp.asarray(ws)}, jnp.asarray(x))
        jgw, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
            {"w": jnp.asarray(ws)}, jnp.asarray(x))
    w, xt = torch.from_numpy(ws).requires_grad_(), \
        torch.from_numpy(x).requires_grad_()
    out = tpipe.pipeline_apply(_tanh_stage, {"w": w}, xt, _tmesh(pp=4))
    gw, gx = torch.autograd.grad((out * torch.from_numpy(ct)).sum(), (w, xt))
    ref = xt
    for s in range(4):
        ref = torch.tanh(ref @ w[s])
    rgw, rgx = torch.autograd.grad((ref * torch.from_numpy(ct)).sum(),
                                   (w, xt))
    for got, want, jwant in ((out, ref, jout), (gw, rgw, jgw["w"]),
                             (gx, rgx, jgx)):
        np.testing.assert_allclose(got.detach().numpy(),
                                   want.detach().numpy(), atol=1e-6)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(jwant),
                                   atol=1e-6)


def test_pipeline_bf16_in_bf16_out():
    """A bf16 stream stays bf16 (the JAX package's CPU meshes stream f32
    for bf16, `cpu_f32_shim`; the port has no such shim) and equals the
    same stages run microbatch by microbatch, bit for bit; against the
    JAX package within its own test's limit for that detour (5e-2)."""
    ws, x = _inputs(4)
    xb = torch.from_numpy(x).bfloat16()
    out = tpipe.pipeline_apply(_tanh_stage, {"w": torch.from_numpy(ws)}, xb,
                               _tmesh(pp=4))
    assert out.dtype == torch.bfloat16
    assert tpipe.last_stream_info() == {"dtype": "bfloat16",
                                        "cpu_f32_shim": False}
    ref = []
    for m in range(x.shape[0]):
        h = xb[m]
        for s in range(4):
            h = _tanh_stage({"w": torch.from_numpy(ws[s])}, h)
        ref.append(h)
    assert torch.equal(out, torch.stack(ref))
    mesh = _jmesh(pp=4)
    with jmesh_guard(mesh):
        jout = jax.jit(lambda p, xx: jpipeline_apply(
            lambda q, h: jnp.tanh(h @ q["w"].astype(h.dtype)), p, xx, mesh))(
            {"w": jnp.asarray(ws)}, jnp.asarray(x).astype(jnp.bfloat16))
    assert jout.dtype == jnp.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(jout, np.float32), atol=5e-2)


def test_one_stage_runs_the_microbatches_in_turn():
    ws, x = _inputs(2, S=1, n_micro=3)
    mesh = _tmesh()
    assert mesh.shape["pp"] == 1 and "pp" not in mesh.rings
    seen = []

    def stage(p, h):
        seen.append(tsharding.in_manual_region())
        return _tanh_stage(p, h)

    out = tpipe.pipeline_apply(stage, {"w": torch.from_numpy(ws)},
                               torch.from_numpy(x), mesh)
    want = torch.tanh(torch.from_numpy(x) @ torch.from_numpy(ws[0]))
    assert torch.equal(out, want) and seen == [False] * 3


def test_stages_run_in_the_manual_region_and_skip_the_bubble():
    """Every stage call runs inside the manual region, where mha takes
    no sp ring; rank s runs microbatch t - s on tick t and nothing on
    the bubble's ticks, so each rank runs each microbatch once."""
    ws, x = _inputs(3, S=2, n_micro=3)
    calls = []

    def stage(p, h):
        calls.append((float(p["w"][0, 0]), tsharding.in_manual_region()))
        q = torch.zeros(1, 256, 2, 64)
        assert tattn._sp_route(q, q, None, True)[0] is None
        return _tanh_stage(p, h)

    mesh = _tmesh(pp=2, sp=2)
    with tmesh.mesh_guard(mesh):
        assert tattn._sp_route(torch.zeros(1, 256, 2, 64),
                               torch.zeros(1, 256, 2, 64), None,
                               True)[0] == "ring_xla"
        tpipe.pipeline_apply(stage, {"w": torch.from_numpy(ws)},
                             torch.from_numpy(x), mesh)
    w0, w1 = float(ws[0, 0, 0]), float(ws[1, 0, 0])
    # ticks 0..3: (rank 0), (0, 1), (0, 1), (1)
    assert calls == [(w, True) for w in (w0, w0, w1, w0, w1, w1)]
    assert not tsharding.in_manual_region()


def test_pipeline_telemetry():
    """The gauges follow every call, bubble (S - 1) / (n + S - 1);
    PIPELINE_TRACES ticks once per schedule signature (S, n_micro,
    microbatch shape, dtype), the counterpart of a retrace."""
    ws, x = _inputs(5, S=2, n_micro=6)
    p = {"w": torch.from_numpy(ws)}
    mesh = _tmesh(pp=2)
    shape = (3, 5, 8)      # a signature no other test uses

    def traces():
        return telemetry.PIPELINE_TRACES.value(axis="pp")

    before = traces()
    tpipe.pipeline_apply(_tanh_stage, p, torch.rand(*shape), mesh)
    assert traces() == before + 1
    assert telemetry.PIPELINE_STAGES.value(axis="pp") == 2
    assert telemetry.PIPELINE_MICROBATCHES.value(axis="pp") == 3
    assert telemetry.PIPELINE_BUBBLE_FRACTION.value(axis="pp") == 1 / 4
    tpipe.pipeline_apply(_tanh_stage, p, torch.from_numpy(x), mesh)
    assert telemetry.PIPELINE_MICROBATCHES.value(axis="pp") == 6
    assert telemetry.PIPELINE_BUBBLE_FRACTION.value(axis="pp") == 1 / 7
    n = traces()
    tpipe.pipeline_apply(_tanh_stage, p, torch.rand(*shape), mesh)
    assert traces() == n    # a signature seen before: no new trace
    assert telemetry.PIPELINE_MICROBATCHES.value(axis="pp") == 3
    assert telemetry.PIPELINE_BUBBLE_FRACTION.value(axis="pp") == 1 / 4
    tpipe.pipeline_apply(_tanh_stage, p, torch.rand(*shape).double(), mesh)
    assert traces() == n + 1


def _models(n_experts, dtype="float32"):
    jcfg = jgpt.GPTConfig.tiny(n_experts=n_experts)
    jcfg.dtype = dtype
    tcfg = tgpt.GPTConfig(**vars(jcfg))
    jparams, _ = jgpt.init(jax.random.key(0), jcfg)
    tparams = params_from_numpy({k: np.asarray(v) for k, v in
                                 jparams.items()}, "cpu",
                                expected=tgpt.param_shapes(tcfg))
    return jcfg, jparams, tcfg, tparams


IDS = np.random.RandomState(0).randint(0, 512, (8, 33))


def _jax_pipelined(jcfg, jparams, **axes):
    with jmesh_guard(_jmesh(**axes)):
        return jax.jit(jax.value_and_grad(lambda p: jgpt.lm_loss(
            p, jcfg, {"ids": jnp.asarray(IDS)}, n_microbatches=4)))(jparams)


def test_dense_gpt_under_pp2_matches_the_loop_and_the_jax_package():
    """The dense tiny GPT under pp=2 with 4 microbatches: its loss equals
    the port's loop over layers within f32 sum order (a dense block
    treats the rows independently), and the loss and every gradient
    match the JAX package's pipelined ones."""
    jcfg, jparams, tcfg, tparams = _models(0)
    for v in tparams.values():
        v.requires_grad_()
    batch = {"ids": torch.from_numpy(IDS)}
    loop = tgpt.lm_loss(tparams, tcfg, batch)
    with tmesh.mesh_guard(_tmesh(pp=2)):
        piped = tgpt.lm_loss(tparams, tcfg, batch, n_microbatches=4)
    assert abs(piped.item() - loop.item()) <= 1e-6 * loop.item()
    check_loss_and_grads(*_jax_pipelined(jcfg, jparams, pp=2), tparams,
                         piped)


@pytest.mark.parametrize("axes", [dict(pp=2, ep=2), dict(pp=2, ep=2, sp=2)],
                         ids=["pp2_ep2", "pp2_ep2_sp2"])
def test_gpt_moe_pipelined_matches_the_jax_package(axes):
    """The tiny MoE (4 experts) under pp=2 with 4 microbatches, the
    experts split over ep=2 (and with sp=2, whose ring the pipeline's
    manual region leaves unused): the loss and every gradient against
    the JAX package's pipelined `lm_loss` on the matching CPU mesh."""
    jcfg, jparams, tcfg, tparams = _models(4)
    for v in tparams.values():
        v.requires_grad_()
    tattn.GATE_COUNTS.clear()
    with tmesh.mesh_guard(_tmesh(**axes)):
        tloss = tgpt.lm_loss(tparams, tcfg, {"ids": torch.from_numpy(IDS)},
                             n_microbatches=4)
    # 4 layers x 4 microbatches, all on the single-device route
    assert dict(tattn.GATE_COUNTS) == {"plain": 16}
    check_loss_and_grads(*_jax_pipelined(jcfg, jparams, **axes), tparams,
                         tloss)


def test_gpt_moe_pipelined_equals_apply_per_microbatch():
    """Under pp=2, ep=2 the logits equal the port's `apply` run on each
    microbatch (2 contiguous rows of ids) with no mesh, within f32 sum
    order; the unpipelined full batch routes with another capacity."""
    _, _, tcfg, tparams = _models(4)
    ids = torch.from_numpy(IDS[:, :-1])
    with tmesh.mesh_guard(_tmesh(pp=2, ep=2)):
        piped = tgpt.apply(tparams, tcfg, ids, n_microbatches=4)
    per_mb = torch.cat([tgpt.apply(tparams, tcfg, ids[2 * m:2 * m + 2])
                        for m in range(4)])
    whole = tgpt.apply(tparams, tcfg, ids)
    np.testing.assert_allclose(piped.numpy(), per_mb.numpy(), atol=1e-5)
    assert (piped - whole).abs().max() > 1e-3


def test_gpt_moe_all_axes_trains():
    """The counterpart of the JAX package's test_gpt_moe_all_axes_trains:
    three AdamW(1e-3) steps of the tiny MoE under MeshConfig(pp=2, ep=2,
    sp=2), 4 microbatches, make_train_step (mixed_bf16: the policy the
    JAX test's default config computes in); the loss is finite and
    falls."""
    _, _, tcfg, tparams = _models(4, dtype="bfloat16")
    init, step = make_train_step(
        lambda p, b, g: tgpt.lm_loss(p, tcfg, b, n_microbatches=4),
        lambda ps: torch.optim.AdamW(ps, lr=1e-3), device="cpu",
        precision="mixed_bf16")
    batch = {"ids": torch.from_numpy(IDS)}
    state, losses = init(tparams), []
    with tmesh.mesh_guard(_tmesh(pp=2, ep=2, sp=2)):
        for i in range(3):
            state, loss = step(state, batch, i)
            losses.append(loss.item())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_pipeline_refusals():
    _, _, tcfg, tparams = _models(0)
    ids = torch.from_numpy(IDS[:, :-1])
    with tmesh.mesh_guard(_tmesh(pp=4)):
        with pytest.raises(ValueError, match="batch 8 not divisible"):
            tgpt.apply(tparams, tcfg, ids, n_microbatches=3)
    tcfg3 = tgpt.GPTConfig(**{**vars(tcfg), "layers": 3})
    p3 = {k: v[:3] if k.startswith("blk.") else v for k, v in tparams.items()}
    with tmesh.mesh_guard(_tmesh(pp=2)):
        with pytest.raises(ValueError, match="layers 3 not divisible"):
            tgpt.apply(p3, tcfg3, ids, n_microbatches=4)
        # n_microbatches=0 keeps the loop over layers
        assert torch.equal(tgpt.apply(p3, tcfg3, ids),
                           tgpt.apply(p3, tcfg3, ids, n_microbatches=0))
