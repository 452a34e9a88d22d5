"""The port's sequence-parallel slice against the JAX package's, on the
CPU: `ring_splash` (K3 blocks; on CPU tensors K3's plain version) and
`ring_attention`, `mha`'s sp route, and 2-layer BERT and GPT under an
sp mesh; then the process ring (one rank per process over gloo)
against the in-process ring (S virtual ranks in one process).

The JAX package runs on the virtual 8-device CPU mesh of the conftest,
splash in interpret mode (which `ring_splash` picks off the TPU), under
`jax.jit` inside `mesh_guard`; the port on an in-process ring of CPU
ranks (`make_mesh(MeshConfig(sp=S), devices=["cpu"] * S)`). Inputs are
numpy arrays from a seed, handed to both.

Tolerances. At f32 the JAX package's own limits for its ring against
plain attention (`tests/test_splash_multichip.py`): 2e-5 on out and
5e-4 on the gradients, absolute (measured: at most 4.2e-7); the models
as `test_torch_bert.py` holds them (loss 1e-5 relative, gradients 1e-4
of the largest value, at least 1). At bf16 every element is held to
|got - want| <= 2^-7 |want| + 1e-2 rms(want): one bf16 rounding step
of the element (both sides round f32 sums taken in other orders), plus
a hundredth of the tensor's RMS for a rounding that falls the other
way. The gap is the block's P: splash rounds the unnormalised P of its
whole key block (up to 1024 keys at once) to bf16 before the product
with v, while K3 (K1-fwd with its LSE) and its plain version keep P in
f32. Measured here: out at most 5.9e-3 of its RMS beyond one rounding
step at 1024 keys a block (T 2048 over sp 2), gradients at most 7.6e-5.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.core.flags import set_flags
from paddle_tpu.models import bert as jbert
from paddle_tpu.models import gpt as jgpt
from paddle_tpu.ops.pallas import attention as jattn
from paddle_tpu.ops.pallas import ring_attention as jra
from paddle_tpu.parallel import MeshConfig as JMeshConfig
from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel import mesh_guard as jmesh_guard

from paddle_tpu_torch.convert import params_from_numpy
from paddle_tpu_torch.kernels import flash_attention as fa
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.models import gpt as tgpt
from paddle_tpu_torch.ops import attention as tattn
from paddle_tpu_torch.ops import ring_attention as tra
from paddle_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BF16_TOL = (2 ** -7, 1e-2)


@pytest.fixture
def splash_flag():
    """The JAX package's multi-chip routes run off the TPU only under
    FLAGS_flash_attention=splash (interpret mode); restored after."""
    set_flags({"FLAGS_flash_attention": "splash"})
    jattn.GATE_COUNTS.clear()
    tattn.GATE_COUNTS.clear()
    try:
        yield
    finally:
        set_flags({"FLAGS_flash_attention": "auto"})


def _jmesh(sp):
    return jmake_mesh(JMeshConfig(sp=sp), devices=jax.devices()[:sp])


def _tmesh(sp):
    return tmesh.make_mesh(tmesh.MeshConfig(sp=sp), devices=["cpu"] * sp)


def _arrays(shape, n, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(*shape).astype(np.float32) for _ in range(n)]


def _held(want, got, rtol, atol):
    """Worst element's error over |want| rtol + rms(want) atol."""
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    rms = np.sqrt(np.mean(want ** 2))
    return float((np.abs(got - want) / (rtol * np.abs(want) + atol * rms))
                 .max())


def _max_abs(want, got):
    return float(np.abs(np.asarray(jnp.asarray(want, jnp.float32)) -
                        got.detach().float().numpy()).max())


def _jax_ring(fn, mesh, arrays, dtype):
    """out and the q/k/v gradients of sum(f32(out) * ct) of the JAX
    package's `fn(q, k, v, mesh)` under jit on `mesh`."""
    q, k, v, ct = (jnp.asarray(a, dtype) for a in arrays)
    with jmesh_guard(mesh):
        out = jax.jit(lambda a, b, c: fn(a, b, c, mesh))(q, k, v)
        grads = jax.jit(jax.grad(
            lambda a, b, c: (fn(a, b, c, mesh).astype(jnp.float32) *
                             ct.astype(jnp.float32)).sum(),
            argnums=(0, 1, 2)))(q, k, v)
    return out, grads


def _port_ring(fn, mesh, arrays, dtype):
    q, k, v = (torch.from_numpy(a).to(dtype).requires_grad_()
               for a in arrays[:3])
    ct = torch.from_numpy(arrays[3]).to(dtype)
    out = fn(q, k, v, mesh)
    grads = torch.autograd.grad((out.float() * ct.float()).sum(), (q, k, v))
    return out, grads


def _check_ring(want, got, dname):
    (wo, wg), (go, gg) = want, got
    if dname == "float32":
        assert _max_abs(wo, go) <= 2e-5
        for a, b in zip(wg, gg):
            assert _max_abs(a, b) <= 5e-4
    else:
        assert go.dtype == torch.bfloat16
        ratios = [_held(wo, go, *BF16_TOL)] + [_held(a, b, *BF16_TOL)
                                               for a, b in zip(wg, gg)]
        assert max(ratios) <= 1.0, ratios


# (B, T, N, H, sp, dtype): T 512 at sp 2 and 4 (256 and 128 keys a
# block), and T 2048 at sp 2, where a block holds the 1024 keys of
# BERT-long's ring blocks (T 4096 over sp 4)
RING_SPLASH_CASES = [(2, 512, 2, 64, 2, "float32"),
                     (2, 512, 2, 64, 4, "float32"),
                     (2, 512, 2, 64, 2, "bfloat16"),
                     (2, 512, 2, 64, 4, "bfloat16"),
                     (1, 2048, 2, 64, 2, "bfloat16"),
                     (1, 2048, 2, 64, 2, "float32")]


@pytest.mark.parametrize("B,T,N,H,sp,dname", RING_SPLASH_CASES)
def test_ring_splash_matches_the_jax_package(B, T, N, H, sp, dname):
    arrays = _arrays((B, T, N, H), 4, seed=sp + T)
    want = _jax_ring(lambda q, k, v, m: jra.ring_splash(q, k, v, m),
                     _jmesh(sp), arrays, getattr(jnp, dname))
    got = _port_ring(tra.ring_splash, _tmesh(sp), arrays,
                     getattr(torch, dname))
    _check_ring(want, got, dname)


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_ring_attention_matches_the_jax_package(sp, causal, dname):
    arrays = _arrays((2, 256, 2, 32), 4, seed=sp + 10 * causal)
    want = _jax_ring(lambda q, k, v, m: jra.ring_attention(
        q, k, v, m, causal=causal), _jmesh(sp), arrays, getattr(jnp, dname))
    got = _port_ring(lambda q, k, v, m: tra.ring_attention(
        q, k, v, m, causal=causal), _tmesh(sp), arrays,
        getattr(torch, dname))
    _check_ring(want, got, dname)


def test_ring_splash_equals_its_plain_version_on_the_cpu():
    """On CPU tensors K3 is its plain version, so the two rings are the
    same arithmetic; and both equal single-device attention."""
    arrays = _arrays((2, 512, 2, 64), 4, seed=5)
    mesh = _tmesh(4)
    a = _port_ring(tra.ring_splash, mesh, arrays, torch.float32)
    b = _port_ring(tra.ring_splash_ref, mesh, arrays, torch.float32)
    assert torch.equal(a[0], b[0])
    for x, y in zip(a[1], b[1]):
        assert torch.equal(x, y)
    q, k, v = (torch.from_numpy(x) for x in arrays[:3])
    ref = fa.flash_attention_ref(q, k, v, 1 / 8, causal=False)
    assert (a[0] - ref).abs().max().item() <= 2e-6


@pytest.mark.parametrize("causal", [False, True])
def test_mha_routes_under_sp_like_the_jax_package(splash_flag, causal):
    """Under an sp=2 mesh both packages' mha take the ring: ring_splash
    for a full mask, ring_xla for a causal call."""
    arrays = _arrays((2, 256, 2, 64), 4, seed=7)
    key = "ring_xla" if causal else "ring_splash"
    want = _jax_ring(lambda q, k, v, m: jattn.mha(q, k, v, causal=causal),
                     _jmesh(2), arrays, jnp.float32)
    assert jattn.GATE_COUNTS[key] >= 2, dict(jattn.GATE_COUNTS)
    assert jattn.GATE_COUNTS["xla"] == 0, dict(jattn.GATE_COUNTS)
    mesh = _tmesh(2)

    def port(q, k, v, m):
        with tmesh.mesh_guard(m):
            return tattn.mha(q, k, v, causal=causal)

    got = _port_ring(port, mesh, arrays, torch.float32)
    assert dict(tattn.GATE_COUNTS) == {key: 1}
    _check_ring(want, got, "float32")


def test_mha_under_sp_ring_xla_shapes_mask_and_refusals():
    mesh = _tmesh(2)
    rs = np.random.RandomState(8)

    def qkv(T, H=64, Tk=None):
        return (torch.from_numpy(rs.randn(1, n, 2, H).astype(np.float32))
                for n in (T, Tk or T, Tk or T))

    tattn.GATE_COUNTS.clear()
    with tmesh.mesh_guard(mesh):
        tattn.mha(*qkv(128))            # T/sp = 64: not a multiple of 128
        tattn.mha(*qkv(256, H=32))      # a head dim K1 does not take
        q, k, v = qkv(256)
        mask = torch.zeros(1, 1, 1, 256)
        masked = tattn.mha(q, k, v, mask=mask)   # single-device route
        with pytest.raises(ValueError, match="divisible"):
            tattn.mha(*qkv(255))
        with pytest.raises(ValueError, match="Tk=128"):
            tattn.mha(*qkv(256, Tk=128))
    assert dict(tattn.GATE_COUNTS) == {"ring_xla": 2, "plain": 1}
    assert torch.equal(masked, tattn.mha(q, k, v, mask=mask))


def _rel(want, got):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    return float(np.abs(want - got).max() / max(1.0, np.abs(want).max()))


def _carry(jparams, expected):
    return params_from_numpy({k: np.asarray(v) for k, v in jparams.items()},
                             "cpu", expected=expected)


def _check_model(jloss, jgrads, tparams, tloss):
    tgrads = torch.autograd.grad(tloss, list(tparams.values()),
                                 allow_unused=True)
    assert abs(float(jloss) - tloss.item()) <= 1e-5 * abs(float(jloss))
    for (name, p), g in zip(tparams.items(), tgrads):
        g = torch.zeros_like(p) if g is None else g
        assert _rel(jgrads[name], g) <= 1e-4, name


def test_bert_under_sp2_matches_the_jax_package(splash_flag):
    """A 2-layer BERT with head dim 64 at 2 x 256 under sp=2: every
    layer's attention on the ring (ring_splash) in both packages."""
    jcfg = jbert.BertConfig(vocab_size=512, hidden=128, layers=2, heads=2,
                            mlp_dim=256, max_len=256, dropout=0.0,
                            dtype="float32")
    tcfg = tbert.BertConfig(**vars(jcfg))
    jparams, _ = jbert.init(jax.random.key(3), jcfg)
    tb = tbert.make_batch(np.random.RandomState(3), tcfg, 2, 256,
                          device="cpu")
    jb = {k: jnp.asarray(v.numpy().astype(np.int32)) for k, v in tb.items()}
    # the conftest's x64 mode aborts XLA's SPMD partitioner on the
    # embedding gradient's scatter under this mesh (a check on a padding
    # constant's element type): the JAX side runs with x64 off, as its
    # f32 code declares
    with jax.enable_x64(False), jmesh_guard(_jmesh(2)):
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p: jbert.pretrain_loss(p, jcfg, jb, deterministic=True)))(
            jparams)
    assert jattn.GATE_COUNTS["ring_splash"] >= 1, dict(jattn.GATE_COUNTS)
    assert jattn.GATE_COUNTS["xla"] == 0, dict(jattn.GATE_COUNTS)
    tparams = _carry(jparams, tbert.param_shapes(tcfg))
    for v in tparams.values():
        v.requires_grad_()
    with tmesh.mesh_guard(_tmesh(2)):
        tloss = tbert.pretrain_loss(tparams, tcfg, tb, deterministic=True)
    assert dict(tattn.GATE_COUNTS) == {"ring_splash": jcfg.layers}
    _check_model(jloss, jgrads, tparams, tloss)


def test_gpt_under_sp2_matches_the_jax_package():
    """A 2-layer GPT `lm_loss` at 2 x 256 under sp=2: causal
    ring_attention in every block in both packages."""
    jcfg = jgpt.GPTConfig(vocab_size=512, hidden=128, layers=2, heads=2,
                          mlp_dim=256, max_len=256, dtype="float32")
    tcfg = tgpt.GPTConfig(**vars(jcfg))
    jparams, _ = jgpt.init(jax.random.key(4), jcfg)
    ids = np.random.RandomState(4).randint(0, 512, (2, 257))
    with jmesh_guard(_jmesh(2)):
        jloss, jgrads = jax.jit(jax.value_and_grad(
            lambda p: jgpt.lm_loss(p, jcfg, {"ids": jnp.asarray(ids)})))(
            jparams)
    tparams = _carry(jparams, tgpt.param_shapes(tcfg))
    for v in tparams.values():
        v.requires_grad_()
    tattn.GATE_COUNTS.clear()
    with tmesh.mesh_guard(_tmesh(2)):
        tloss = tgpt.lm_loss(tparams, tcfg, {"ids": torch.from_numpy(ids)})
    assert not tattn.GATE_COUNTS    # the blocks call the ring directly
    _check_model(jloss, jgrads, tparams, tloss)


# --- the process ring ------------------------------------------------------

# One rank of a gloo ring: loads the full inputs, runs ring_splash, mha
# (its sp route) and causal ring_attention on its own shard, forward
# and backward against its shard of the cotangent, and saves the
# results; then checks that a hop of a tensor gloo cannot carry raises.
_WORKER = r"""
import sys
import torch
import torch.distributed as dist

rank, world, rdv, inputs, out_path = sys.argv[1:]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + rdv,
                        world_size=world, rank=rank)
try:
    from paddle_tpu_torch.ops import attention as tattn
    from paddle_tpu_torch.ops import ring_attention as tra
    from paddle_tpu_torch.parallel import mesh as tmesh

    mesh = tmesh.make_mesh(tmesh.MeshConfig(sp=world))
    assert mesh.devices == (torch.device("cpu"),), mesh.devices
    full = torch.load(inputs)
    Tl = full["q"].shape[1] // world
    shard = {k: v[:, rank * Tl:(rank + 1) * Tl].contiguous()
             for k, v in full.items()}
    res = {}

    def run(name, fn):
        q, k, v = (shard[n].clone().requires_grad_() for n in "qkv")
        out = fn(q, k, v)
        (out * shard["ct"]).sum().backward()
        res.update({name + "_out": out.detach(), name + "_dq": q.grad,
                    name + "_dk": k.grad, name + "_dv": v.grad})

    run("splash", lambda q, k, v: tra.ring_splash(q, k, v, mesh))
    run("causal", lambda q, k, v: tra.ring_attention(q, k, v, mesh,
                                                     causal=True))
    with tmesh.mesh_guard(mesh):
        run("mha", lambda q, k, v: tattn.mha(q, k, v))
    res["gates"] = dict(tattn.GATE_COUNTS)
    try:
        mesh.rings["sp"].hop([torch.zeros(1, device="meta")])
        res["meta_hop"] = "no error"
    except ValueError as e:
        res["meta_hop"] = str(e)
    torch.save(res, out_path)
finally:
    dist.destroy_process_group()
"""


# One rank of a gloo ring under the process mesh: a masked mha and the
# models' forward calls (BERT encode, GPT apply, Transformer encode and
# decode) must raise on every rank rather than treat the shard as the
# whole sequence (ROADMAP item 20b); the unmasked mha stays on the ring.
_REFUSAL_WORKER = r"""
import sys
import torch
import torch.distributed as dist

rank, world, rdv, inputs, out_path = sys.argv[1:]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + rdv,
                        world_size=world, rank=rank)
try:
    from paddle_tpu_torch.models import bert, gpt, transformer
    from paddle_tpu_torch.ops import attention as tattn
    from paddle_tpu_torch.parallel import mesh as tmesh

    mesh = tmesh.make_mesh(tmesh.MeshConfig(sp=world))
    full = torch.load(inputs)
    Tl = full["q"].shape[1] // world
    q, k, v = (full[n][:, rank * Tl:(rank + 1) * Tl].contiguous()
               for n in "qkv")
    B = q.shape[0]
    ids = torch.zeros(B, Tl, dtype=torch.long)
    g = torch.Generator().manual_seed(0)
    bcfg, gcfg = bert.BertConfig.tiny(), gpt.GPTConfig.tiny()
    tcfg = transformer.TransformerConfig.tiny()
    bp, _ = bert.init(g, bcfg, device="cpu")
    gp, _ = gpt.init(g, gcfg, device="cpu")
    tp, _ = transformer.init(g, tcfg, device="cpu")
    memory = torch.zeros(B, Tl, tcfg.hidden)
    calls = {
        "masked_mha": lambda: tattn.mha(q, k, v,
                                        mask=torch.zeros(B, 1, 1, Tl)),
        "bert": lambda: bert.encode(bp, bcfg, ids),
        "gpt": lambda: gpt.apply(gp, gcfg, ids),
        "transformer_encode": lambda: transformer.encode(tp, tcfg, ids),
        "transformer_decode": lambda: transformer.decode(tp, tcfg, ids,
                                                         memory)}
    res = {}
    with tmesh.mesh_guard(mesh):
        res["mha"] = tattn.mha(q, k, v)
        for name, fn in calls.items():
            try:
                fn()
                res[name] = "no error"
            except NotImplementedError as e:
                res[name] = str(e)
    res["gates"] = dict(tattn.GATE_COUNTS)
    torch.save(res, out_path)
finally:
    dist.destroy_process_group()
"""


def _spawn_ring(tmp_path, world, timeout=120, worker=_WORKER):
    """Run `worker` on `world` gloo processes; every child is killed if
    any is still running at the deadline (a hang fails the test)."""
    path = os.pathsep.join(p for p in (_REPO, os.environ.get("PYTHONPATH"))
                           if p)
    env = dict(os.environ, PYTHONPATH=path, OMP_NUM_THREADS="1")
    rdv = tmp_path / "rendezvous"
    procs = [subprocess.Popen(
        [sys.executable, "-c", worker, str(r), str(world), str(rdv),
         str(tmp_path / "inputs.pt"), str(tmp_path / f"rank{r}.pt")],
        cwd=_REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(world)]
    logs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            logs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return [torch.load(tmp_path / f"rank{r}.pt") for r in range(world)]


@pytest.mark.parametrize("world", [2, 4])
def test_process_ring_equals_the_in_process_ring(tmp_path, world):
    """Each gloo rank's forward and gradients equal, to the last bit,
    its shard of the in-process ring's on the same inputs: every rank
    does the same arithmetic on the same values either way (the
    in-process ring's shards are contiguous copies, and both run on one
    thread)."""
    B, T, N, H = 2, 128 * world, 2, 64
    names = ("q", "k", "v", "ct")
    full = dict(zip(names, (torch.from_numpy(a) for a in
                            _arrays((B, T, N, H), 4, seed=world))))
    torch.save(full, tmp_path / "inputs.pt")
    ranks = _spawn_ring(tmp_path, world)

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        mesh = _tmesh(world)
        want = {}
        for name, fn in (
                ("splash", lambda q, k, v: tra.ring_splash(q, k, v, mesh)),
                ("causal", lambda q, k, v: tra.ring_attention(
                    q, k, v, mesh, causal=True))):
            q, k, v = (full[n].clone().requires_grad_() for n in "qkv")
            out = fn(q, k, v)
            (out * full["ct"]).sum().backward()
            want.update({name + "_out": out.detach(), name + "_dq": q.grad,
                         name + "_dk": k.grad, name + "_dv": v.grad})
    finally:
        torch.set_num_threads(threads)
    Tl = T // world
    for r, got in enumerate(ranks):
        assert got["gates"] == {"ring_splash": 1}, got["gates"]
        assert "gloo process group cannot carry meta" in got["meta_hop"]
        for key, full_value in want.items():
            mine = full_value[:, r * Tl:(r + 1) * Tl]
            assert torch.equal(got[key], mine), (r, key)
            if key.startswith("splash"):
                assert torch.equal(got["mha" + key[len("splash"):]], mine)


def test_process_ring_refuses_masked_and_model_calls(tmp_path):
    """Under a 2-rank gloo process ring each rank holds its shard: a
    masked mha and the BERT, GPT and Transformer forwards raise on both
    ranks, naming ROADMAP item 20b, and the unmasked mha (the ring)
    still equals the in-process ring's shard bit for bit."""
    world, B, T, N, H = 2, 2, 256, 2, 64
    full = dict(zip("qkv", (torch.from_numpy(a) for a in
                            _arrays((B, T, N, H), 3, seed=21))))
    torch.save(full, tmp_path / "inputs.pt")
    ranks = _spawn_ring(tmp_path, world, worker=_REFUSAL_WORKER)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with tmesh.mesh_guard(_tmesh(world)):
            want = tattn.mha(full["q"], full["k"], full["v"])
    finally:
        torch.set_num_threads(threads)
    Tl = T // world
    for r, got in enumerate(ranks):
        for name in ("masked_mha", "bert", "gpt", "transformer_encode",
                     "transformer_decode"):
            assert "process ring" in got[name] and "20b" in got[name], \
                (r, name, got[name])
        assert got["gates"] == {"ring_splash": 1}, got["gates"]
        assert torch.equal(got["mha"], want[:, r * Tl:(r + 1) * Tl])
