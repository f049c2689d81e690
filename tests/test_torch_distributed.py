"""The mesh schedules of the port (``repro_torch.core.distributed``) on 8
gloo ranks of the CPU, one client per rank, against the reference's
``shard_map`` rounds on an 8-device host mesh.

Inputs are numpy draws from a seed, the same arrays into both packages:
the reference's toy task (``tests/test_distributed_fl.py``) and the tanh
MLP of ``examples/distributed_fedx_pods.py``.  The reference runs in a
subprocess (its forced device count must not leak into other tests), at
the same time as the port's ranks, which ``run_ranks`` starts.

Tolerances: scores and params of FedX rounds within rtol 1e-4, atol 1e-4,
the tolerance ``tests/test_torch_client.py`` holds one client update to
(SGD steps and BWO generations compound float32 rounding; four rounds
here run free, each from its own package's winner); FedAvg within rtol
1e-4, atol 1e-5 of the reference's round and of the mean of the clients'
updates, as ``tests/test_distributed_fl.py``.
"""
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import tree  # noqa: E402
from repro_torch.core import comm  # noqa: E402
from repro_torch.core.client import (ClientHP, Task,  # noqa: E402
                                     make_client_update)
from repro_torch.core.distributed import (make_fedavg_round,  # noqa: E402
                                          make_fedx_round)
from repro_torch.launch.mesh import (RankError, make_host_mesh,  # noqa: E402
                                     make_production_mesh, run_ranks)
from repro_torch.metaheuristics import bwo  # noqa: E402

ROOT = os.path.join(os.path.dirname(__file__), "..")
N = 8
ROUNDS = 4
TIMEOUT = 300
TOL = dict(rtol=1e-4, atol=1e-4)
AVG_TOL = dict(rtol=1e-4, atol=1e-5)
TASKS = ("toy", "mlp")
MHS = ("composed", "kernel")
# the reference's hyper-parameters for each task
HP = {"toy": dict(local_epochs=2, mh_pop=4, mh_generations=2, lr=0.1),
      "mlp": dict(local_epochs=2, mh_pop=6, mh_generations=3, lr=0.1)}


def _toy_loss(params, batch):
    logits = batch["x"] @ params["w"] + params["b"]
    return _nll_acc(logits, batch["y"])


def _mlp_loss(params, batch):
    logits = torch.tanh(batch["x"] @ params["w1"]) @ params["w2"]
    return _nll_acc(logits, batch["y"])


def _nll_acc(logits, y):
    lp = torch.log_softmax(logits, -1)
    nll = -torch.take_along_dim(lp, y[:, None], -1).mean()
    return nll, (logits.argmax(-1) == y).float().mean()


LOSSES = {"toy": _toy_loss, "mlp": _mlp_loss}


def _inputs():
    """Per task: initial params, client data (N, batches, batch, d) and
    (N, 2) uint32 keys, from one numpy seed."""
    rng = np.random.default_rng(0)
    out = {}
    for name, d, c, b, s, hidden in (("toy", 6, 3, 4, 16, None),
                                     ("mlp", 16, 4, 8, 32, 32)):
        w_true = rng.standard_normal((d, c)).astype(np.float32)
        x = rng.standard_normal((N, b, s, d)).astype(np.float32)
        y = (x @ w_true).argmax(-1).astype(np.int32)
        if hidden is None:
            params = {"w": 0.1 * rng.standard_normal((d, c)),
                      "b": np.zeros((c,))}
        else:
            params = {"w1": 0.2 * rng.standard_normal((d, hidden)),
                      "w2": 0.2 * rng.standard_normal((hidden, c))}
        params = {k: v.astype(np.float32) for k, v in params.items()}
        keys = rng.integers(0, 2 ** 32, (N, 2), dtype=np.uint32)
        out[name] = (params, {"x": x, "y": y}, keys)
    return out


def _port_inputs(params, data, keys, rank):
    """A rank's shard: leading dims of 1; keys as the port's int64 words."""
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    d = {"x": torch.from_numpy(data["x"][rank:rank + 1]),
         "y": torch.from_numpy(data["y"][rank:rank + 1]).long()}
    return p, d, torch.from_numpy(keys[rank:rank + 1].astype(np.int64))


def _numpy(params):
    return {k: v.numpy().copy() for k, v in params.items()}


def _rank_rounds(rank, inputs):
    """In each rank: 4 FedX rounds per task and BWO route, one FedAvg
    round, the traffic, and a shard of two clients."""
    torch.set_num_threads(1)
    mesh = make_host_mesh(N, device_type="cpu")
    out = {"fedx": {}, "fedavg": {}, "traffic": {}}
    for name in TASKS:
        params, data, keys = inputs[name]
        task = Task(None, LOSSES[name])
        hp = ClientHP(**HP[name])
        p, d, k = _port_inputs(params, data, keys, rank)
        for mh in MHS:
            rnd = make_fedx_round(task, hp, bwo(use_kernel=mh == "kernel"),
                                  mesh)
            cur, log = p, []
            for _ in range(ROUNDS):
                cur, scores = rnd(cur, d, k)
                log.append((_numpy(cur), scores.numpy().copy()))
            out["fedx"][name, mh] = log
            out["traffic"][name, "fedx"] = dict(rnd.traffic)
        avg = make_fedavg_round(task, hp, mesh)
        new, scores = avg(p, d, k)
        out["fedavg"][name] = (_numpy(new), scores.numpy().copy())
        out["traffic"][name, "fedavg"] = dict(avg.traffic)
        # this rank's own update, for the manual mean
        _, mine = make_client_update(task, hp, None)(
            p, tree.map(lambda a: a[0], d), k[0])
        out["fedavg"][name, "mine"] = _numpy(mine)
    # a shard of two clients raises on every rank, before any collective
    p, d, k = _port_inputs(*inputs["toy"], rank)
    two = tree.map(lambda a: torch.cat([a, a]), d)
    try:
        make_fedx_round(Task(None, _toy_loss), ClientHP(**HP["toy"]), bwo(),
                        mesh)(p, two, k)
        out["two_clients"] = None
    except ValueError as e:
        out["two_clients"] = str(e)
    return out


REFERENCE = textwrap.dedent("""
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.core.client import ClientHP, Task, make_client_update
    from repro.core.distributed import make_fedavg_round, make_fedx_round
    from repro.launch.mesh import make_host_mesh
    from repro.metaheuristics import bwo

    def nll_acc(logits, y):
        lp = jax.nn.log_softmax(logits)
        nll = -jnp.take_along_axis(lp, y[:, None], -1).mean()
        return nll, (logits.argmax(-1) == y).mean()

    losses = {
        "toy": lambda p, b: nll_acc(b["x"] @ p["w"] + p["b"], b["y"]),
        "mlp": lambda p, b: nll_acc(jnp.tanh(b["x"] @ p["w1"]) @ p["w2"],
                                    b["y"])}
    src = np.load(sys.argv[1])
    hps = {"toy": dict(local_epochs=2, mh_pop=4, mh_generations=2, lr=0.1),
           "mlp": dict(local_epochs=2, mh_pop=6, mh_generations=3, lr=0.1)}
    mesh = make_host_mesh(8)
    out = {}
    for name in sys.argv[3:]:
        names = [k.split("/")[2] for k in src if k.startswith(name + "/p/")]
        p0 = {k: jnp.asarray(src[f"{name}/p/{k}"]) for k in names}
        data = {"x": jnp.asarray(src[name + "/x"]),
                "y": jnp.asarray(src[name + "/y"])}
        keys = jnp.asarray(src[name + "/keys"])
        task, hp = Task(None, losses[name]), ClientHP(**hps[name])
        for mh in ("composed", "kernel"):
            rnd = make_fedx_round(task, hp, bwo(use_pallas=mh == "kernel"),
                                  mesh)
            p = p0
            for r in range(4):
                p, scores = rnd(p, data, keys)
                out[f"fedx/{name}/{mh}/{r}/scores"] = np.asarray(scores)
                for k in names:
                    out[f"fedx/{name}/{mh}/{r}/p/{k}"] = np.asarray(p[k])
        pavg, scores = make_fedavg_round(task, hp, mesh)(p0, data, keys)
        out[f"fedavg/{name}/scores"] = np.asarray(scores)
        for k in names:
            out[f"fedavg/{name}/p/{k}"] = np.asarray(pavg[k])
    np.savez(sys.argv[2], **out)
    print("REFERENCE_OK")
""")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's rounds (a subprocess) and the port's (8 ranks),
    run at the same time."""
    inputs = _inputs()
    tmp = tmp_path_factory.mktemp("mesh")
    flat = {}
    for name, (params, data, keys) in inputs.items():
        flat.update({f"{name}/p/{k}": v for k, v in params.items()})
        flat.update({f"{name}/x": data["x"], f"{name}/y": data["y"],
                     f"{name}/keys": keys})
    np.savez(tmp / "in.npz", **flat)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    # one subprocess a task: most of the reference's time is compiling
    refs = [subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(tmp / "in.npz"),
         str(tmp / f"{name}.npz"), name], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for name in TASKS]
    try:
        port = run_ranks(N, _rank_rounds, inputs, timeout=TIMEOUT)
        for ref in refs:
            stdout, stderr = ref.communicate(timeout=TIMEOUT)
            assert ref.returncode == 0 and "REFERENCE_OK" in stdout, \
                stderr[-3000:]
    finally:
        for ref in refs:
            if ref.poll() is None:
                ref.kill()
                ref.communicate()
    ref = {}
    for name in TASKS:
        ref.update(np.load(tmp / f"{name}.npz"))
    return inputs, port, ref


def _ref_params(ref, prefix, like):
    return {k: ref[f"{prefix}/p/{k}"] for k in like}


@pytest.mark.parametrize("r", range(ROUNDS))
@pytest.mark.parametrize("mh", MHS)
@pytest.mark.parametrize("name", TASKS)
def test_fedx_round_picks_the_reference_winner(runs, name, mh, r):
    _, port, ref = runs
    params, scores = port[0]["fedx"][name, mh][r]
    want = ref[f"fedx/{name}/{mh}/{r}/scores"]
    assert scores.shape == (N,) and np.isfinite(scores).all()
    assert int(np.argmin(scores)) == int(np.argmin(want))
    np.testing.assert_allclose(scores, want, **TOL)
    for k, v in _ref_params(ref, f"fedx/{name}/{mh}/{r}", params).items():
        np.testing.assert_allclose(params[k], v, **TOL)


@pytest.mark.parametrize("mh", MHS)
@pytest.mark.parametrize("name", TASKS)
def test_every_rank_ends_the_round_with_the_winner(runs, name, mh):
    """The broadcast leaves every rank the same model and the same scores,
    bit for bit."""
    _, port, _ = runs
    first = port[0]["fedx"][name, mh]
    for rank in range(1, N):
        for (p, s), (q, t) in zip(first, port[rank]["fedx"][name, mh]):
            np.testing.assert_array_equal(s, t)
            for k in p:
                np.testing.assert_array_equal(p[k], q[k])


@pytest.mark.parametrize("name", TASKS)
def test_fedavg_round_matches_the_reference(runs, name):
    _, port, ref = runs
    params, scores = port[0]["fedavg"][name]
    np.testing.assert_allclose(scores, ref[f"fedavg/{name}/scores"],
                               **AVG_TOL)
    for k, v in _ref_params(ref, f"fedavg/{name}", params).items():
        np.testing.assert_allclose(params[k], v, **AVG_TOL)


@pytest.mark.parametrize("name", TASKS)
def test_fedavg_round_is_the_mean_of_the_updates(runs, name):
    _, port, _ = runs
    params, _ = port[0]["fedavg"][name]
    for k, v in params.items():
        mean = np.mean([port[r]["fedavg"][name, "mine"][k]
                        for r in range(N)], 0)
        np.testing.assert_allclose(v, mean, **AVG_TOL)
        for r in range(1, N):
            np.testing.assert_array_equal(port[r]["fedavg"][name][0][k], v)


@pytest.mark.parametrize("kind", ["fedx", "fedavg"])
@pytest.mark.parametrize("name", TASKS)
def test_collectives_carry_the_papers_bytes(runs, name, kind):
    """FedX: N scores and one model (Eq. 2); FedAvg: N models (Eq. 1)."""
    inputs, port, _ = runs
    m = sum(v.nbytes for v in inputs[name][0].values())
    traffic = port[0]["traffic"][name, kind]
    assert traffic["all_gather"] == N * comm.SCORE_BYTES
    if kind == "fedx":
        assert set(traffic) == {"all_gather", "broadcast"}
        assert sum(traffic.values()) == comm.fedx_round_bytes(N, m)
    else:
        assert set(traffic) == {"all_gather", "all_reduce"}
        assert traffic["all_reduce"] == comm.fedavg_round_bytes(1.0, N, m)


def test_a_shard_of_two_clients_raises(runs):
    _, port, _ = runs
    for rank in range(N):
        msg = port[rank]["two_clients"]
        assert msg is not None and "one client" in msg


def _raise_on_rank_one(rank):
    if rank == 1:
        raise ValueError("rank one fails")
    torch.distributed.barrier()         # rank 0 waits for rank 1 here


def _sleep_on_rank_one(rank):
    if rank == 1:
        time.sleep(3600)
    torch.distributed.barrier()


def test_a_rank_that_raises_fails_the_caller():
    t0 = time.monotonic()
    with pytest.raises(RankError, match="rank 1 of 2 raised") as err:
        run_ranks(2, _raise_on_rank_one, timeout=TIMEOUT)
    assert "rank one fails" in str(err.value)
    assert time.monotonic() - t0 < TIMEOUT / 2


def test_ranks_that_hang_fail_the_caller_at_the_timeout():
    t0 = time.monotonic()
    with pytest.raises(RankError, match="did not finish within 10"):
        run_ranks(2, _sleep_on_rank_one, timeout=10)
    assert time.monotonic() - t0 < 10 + 60


@pytest.mark.parametrize("multi_pod,ranks", [(False, 256), (True, 512)])
def test_production_mesh_needs_its_world(multi_pod, ranks):
    with pytest.raises(RuntimeError, match=f"world of {ranks} ranks"):
        make_production_mesh(multi_pod=multi_pod, device_type="cpu")


def test_host_mesh_needs_its_world():
    with pytest.raises(RuntimeError, match="world of 8 ranks"):
        make_host_mesh(8, device_type="cpu")
