"""The port's fleet tier on the CPU: the router, the autoscaler, the
rendezvous membership and the replica supervisor.

- The JAX package's own fleet cases (tests/test_fleet.py: the router
  against scriptable fake replicas, the breaker under router
  concurrency, rendezvous membership, the RouterServer front, the
  autoscaler's control law, the supervisor's respawn budget and its rc
  0 rule) run unchanged against the port: the module is executed with
  `paddle_tpu.` read as `paddle_tpu_torch.`, and each case is one
  parametrised test here.
- A real router in front of two port Servers: its replies equal a
  single server's (predict within F32_REPLY_TOL relative to the largest
  |reply|; generate tokens exactly), and stopping one server in the
  middle of a burst loses no predict request.
- A supervised fleet of two `python -m paddle_tpu_torch.serving.replica
  --cpu --decode-tiny 0` processes that a `Router(rdzv_dir=...)`
  discovers: a SIGKILLed replica is respawned, a SIGTERMed one drains,
  exits with 0 and is not respawned. Every wait has its own deadline,
  and the supervisor stops every process it started.
"""

import inspect
import json
import os
import sys
import threading
import time
import types

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed.launch_serve import (ReplicaSpec,
                                                       ReplicaSupervisor)
from paddle_tpu_torch.models import gpt
from paddle_tpu_torch.observability import events as tevents
from paddle_tpu_torch.serving import (DecodeConfig, DecodeEngine, Router,
                                      RouterServer, Server, ServingConfig)

from chip_smoke import lenet_rung_logits, lenet_rung_program, synthetic_mnist

torch.set_num_threads(2)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F32_REPLY_TOL = 1e-5


def _jax_fleet_cases():
    """tests/test_fleet.py executed against this package: the same
    fake replicas and case bodies, with every `paddle_tpu.` import read
    as `paddle_tpu_torch.`."""
    path = os.path.join(_REPO, "tests", "test_fleet.py")
    with open(path) as f:
        src = f.read().replace("paddle_tpu.", "paddle_tpu_torch.")
    mod = types.ModuleType("jax_fleet_cases_on_the_port")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


CASES = _jax_fleet_cases()

# the cases of tests/test_fleet.py:194-661 (router), 735-803
# (autoscaler) and 825-849 (supervisor); its slow serve_bench smoke is
# the JAX package's tool and is not among them
FLEET_CASES = sorted(
    name for name, fn in vars(CASES).items()
    if name.startswith("test_") and inspect.isfunction(fn)
    and fn.__code__.co_firstlineno <= 849
    and not hasattr(fn, "pytestmark"))


@pytest.fixture
def fakes():
    made = []

    def make(tag="A", **cfg):
        rep = CASES.FakeReplica(tag, **cfg)
        made.append(rep)
        return rep

    yield make
    for rep in made:
        rep.close()


def test_every_jax_fleet_case_is_run():
    assert len(FLEET_CASES) == 31
    assert "test_serve_bench_fleet_smoke" not in FLEET_CASES
    assert CASES.Router is Router and CASES.RouterServer is RouterServer


@pytest.mark.parametrize("case", FLEET_CASES)
def test_jax_fleet_case_on_the_port(case, fakes, tmp_path, monkeypatch):
    fn = getattr(CASES, case)
    have = {"fakes": fakes, "tmp_path": tmp_path, "monkeypatch": monkeypatch}
    fn(**{name: have[name] for name in inspect.signature(fn).parameters})


# -- a real router in front of two port Servers ----------------------------

def _lenet_dir(root):
    import paddle_tpu_torch as pt

    main, startup, loss = lenet_rung_program(pt)
    exe = pt.Executor(pt.CPUPlace())
    scope = pt.Scope()
    x, y = synthetic_mnist(64, seed=1)
    d = os.path.join(root, "lenet")
    with pt.scope_guard(scope):
        exe.run(startup)
        exe.run(main, feed={"x": x, "y": y}, fetch_list=[loss])
        pt.io.save_inference_model(d, ["x"], [lenet_rung_logits(main)], exe,
                                   main_program=main)
    return d


def _server(model_dir):
    cfg = gpt.GPTConfig.tiny()
    cfg.dtype = "float32"
    params, _ = gpt.init(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    dec = DecodeEngine(params, cfg, DecodeConfig(
        block_size=8, num_blocks=64, decode_slots=(4,),
        prefill_buckets=(8, 16), precision="f32", max_len=64),
        device="cpu")
    return Server(ServingConfig(model_dir, use_tpu=False, buckets=(1, 2, 4)),
                  decode=dec)


def _gap(a, b):
    b = np.asarray(b, np.float64)
    return float(np.abs(np.asarray(a, np.float64) - b).max()
                 / np.abs(b).max())


def test_router_over_two_servers_equals_one_and_loses_nothing(tmp_path):
    d = _lenet_dir(str(tmp_path))
    servers = [_server(d) for _ in range(2)]
    eps = [f"127.0.0.1:{s.start(0)}" for s in servers]
    router = Router(eps, poll_interval_s=0.05, retries=2,
                    breaker_reset_s=0.2)
    pool = synthetic_mnist(32, seed=6)[0]
    prompts = [[3, 1, 4, 1, 5], list(range(2, 13))]
    try:
        router.poll_once()
        assert router.healthy_endpoints() == sorted(eps)
        for i in range(0, 12, 3):
            rows = pool[i:i + 3]
            got = router.predict({"x": rows.tolist()})["outputs"]
            want = servers[0].submit({"x": rows})
            for name in want:
                assert _gap(got[name], want[name]) <= F32_REPLY_TOL
        for p in prompts:
            recs = list(router.generate(p, max_new_tokens=6))
            toks = [r["token"] for r in recs if "token" in r]
            assert recs[-1].get("done") and len(toks) == 6
            assert toks == servers[1].decode.submit(
                p, max_new_tokens=6).result(timeout_s=60)
        # stop one server in the middle of a burst: every request is
        # answered by the survivor
        errors, done = [], []

        def client(seed):
            rs = np.random.RandomState(seed)
            for _ in range(12):
                rows = pool[rs.randint(0, 29):][:2]
                try:
                    router.predict({"x": rows.tolist()})
                    done.append(1)
                except Exception as e:  # counted, and must not happen
                    errors.append(repr(e))

        threads = [threading.Thread(target=client, args=(s,))
                   for s in range(4)]
        for t in threads:
            t.start()
        assert _wait(lambda: len(done) >= 8)
        # concurrent requests spread over both (p2c on load + in-flight)
        picks = {r["endpoint"]: r["picks"]
                 for r in router.status()["replicas"]}
        servers[0].stop()
        for t in threads:
            t.join(60)
        assert not errors and len(done) == 48
        assert all(n > 0 for n in picks.values()), picks
        assert router.predict({"x": pool[:1].tolist()})["outputs"]
    finally:
        router.stop()
        for s in servers:
            s.stop()


def _wait(pred, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.02)
    return False


# -- a supervised fleet of replica processes ------------------------------

def test_supervised_cpu_replicas_respawn_and_drain(tmp_path):
    rdzv = str(tmp_path / "rdzv")
    spec = ReplicaSpec("", cpu=True, drain_timeout_s=5.0,
                       extra_args=["--decode-tiny", "0",
                                   "--heartbeat-s", "0.2"])
    sup = ReplicaSupervisor(spec, rdzv, replicas=2, max_respawns=2,
                            backoff_s=0.1, log_dir=str(tmp_path / "logs"))
    router = Router(rdzv_dir=rdzv, poll_interval_s=0.1)
    tevents.clear()

    def healthy(n):
        router.poll_once()
        return len(router.healthy_endpoints()) == n

    try:
        sup.start()
        assert _wait(lambda: healthy(2), 120), sup.slot_info()
        toks = [r["token"] for r in router.generate([1, 2, 3],
                                                    max_new_tokens=4)
                if "token" in r]
        assert len(toks) == 4
        killed = sup.kill_slot(0)
        assert _wait(lambda: sup.slot_info()[0]["launches"] == 2, 30)
        assert _wait(lambda: healthy(2)
                     and sup.slot_info()[0]["alive"], 120)
        assert killed in router.endpoints()
        # SIGTERM: the replica leaves, drains and exits 0, unreplaced
        gone = sup.scale_in(endpoint=sup.slot_info()[1]["endpoint"])
        assert _wait(lambda: not sup.slot_info()[1]["alive"], 60)
        slots = sup.slot_info()
        assert slots[1]["retired"] and slots[1]["launches"] == 1
        assert sup._slots[1].proc.returncode == 0
        assert _wait(lambda: router.poll_once() is None
                     and gone not in router.endpoints(), 30)
        assert slots[0]["respawns"] == 1 and sup.replica_count() == 1
        actions = [e["action"] for e in tevents.recent(200, kind="fleet")]
        assert "respawn" in actions and "scale_in" in actions
        assert "respawn_exhausted" not in actions
    finally:
        router.stop()
        sup.stop(grace_s=15.0)
    assert all(not s["alive"] for s in sup.slot_info())


def test_replica_refuses_without_a_model(tmp_path):
    import subprocess

    r = subprocess.run([sys.executable, "-m",
                        "paddle_tpu_torch.serving.replica", "--cpu"],
                       cwd=_REPO, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 2
    assert json.loads(r.stdout.splitlines()[-1])["ready"] is False
