"""The rollout gradient as one CUDA-graph replay
(``nbodyax_torch.autodiff.graphed_value_and_grad``), the port's form of
``jax.jit(jax.value_and_grad(make_loss(...)))``.

On the CPU the object runs its ``body`` (what a capture records) eagerly.
At tests/test_torch_autodiff.py's size (N = 16 overlapping bodies) for
euler over 4 steps and leapfrog over 2, in reference, momentum and elastic
mode, with respect to pos, vel and mass:

- the object's call equals ``make_loss`` + ``torch.autograd.grad`` bit for
  bit, value and gradients;
- it matches ``nbodyax``'s ``jax.jit(jax.value_and_grad(make_loss(...)))``
  on the same numpy inputs at ``ROLLOUT_GATE`` (momentum mode's mass
  gradient as ``test_rollout_grads_match_jax`` holds it);
- the call reads nothing back to the host: every host read of a tensor
  raises while it runs (a capture would refuse one).

The same three checks run over ``make_sharded_step`` on two gloo ranks
(one spawn for the module, each rank on one thread), each rank
differentiating its share of the loss; the gathered gradient is held to
``nbodyax``'s single-device one at the sharded gate (1e-5,
tests/test_autodiff.py:155), the same reference and gate as
tests/test_torch_sharding_grad.py's single-device comparison.

The card's cases (capture, replay bitwise the eager gradient, launch
counts by replay, a capture that fails, a one-rank NCCL group) need a
card and skip without one; JAX is imported only by the CPU cases:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_autodiff_graph.py
"""

import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from nbodyax_torch.autodiff import (graphed_value_and_grad,  # noqa: E402
                                    make_loss)
from nbodyax_torch.backends import build_accum_fn  # noqa: E402
from nbodyax_torch.config import SimConfig  # noqa: E402
from nbodyax_torch.graphs import GraphCaptureError  # noqa: E402
from nbodyax_torch.physics.kernels import tile_accumulators_raw  # noqa: E402
from nbodyax_torch.physics.kernels_bwd import raw_backward  # noqa: E402
from nbodyax_torch.physics.step import PhysicsParams, make_step  # noqa: E402
from nbodyax_torch.state import make_state  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 16
SCALE = 100.0
RANKS = 2
ROLLOUT_GATE = 5e-6    # tests/test_autodiff.py:235
SHARDED_GATE = 1e-5    # tests/test_autodiff.py:155
LEAVES = ("pos", "vel", "mass")
# (integrator, steps, force passes a step)
RUNS = [("euler", 4, 1), ("leapfrog", 2, 2)]
CASES = [(i, s, p, m) for i, s, p in RUNS
         for m in ("reference", "momentum", "elastic")]
IDS = [f"{i}-{m}" for i, _, _, m in CASES]
HOST_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__",
              "__float__", "__index__")


def small_arrays():
    """tests/test_torch_autodiff.py's ``small_arrays(2, overlapping=True)``:
    most bodies overlap and merge in the first step."""
    rng = np.random.RandomState(2)
    pos = rng.uniform(-SCALE, SCALE, (N, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, (N, 2)).astype(np.float32)
    mass = rng.uniform(0.5e12, 2e12, N).astype(np.float32)
    radius = rng.uniform(20, 60, N).astype(np.float32)
    return pos, vel, mass, radius


def config(mode, integrator):
    return SimConfig(particle_count=N, collision_mode=mode, softening=5.0,
                     integrator=integrator, field_width=10_000,
                     field_height=10_000)


def target_loss(s):
    return ((s.pos / SCALE) ** 2).sum() / N


def port_loss(mode, integrator, steps, dtype=torch.float32):
    """make_loss over B1 and B2's plain versions, or in float64 over the
    jnp engine."""
    p = PhysicsParams.from_config(config(mode, integrator))
    step = make_step(p, accum_fn=build_accum_fn(
        "jnp" if dtype == torch.float64 else "auto", p, "cpu"))
    return make_loss(step, steps, target_loss)


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@functools.lru_cache(maxsize=None)
def jax_value_and_grad(mode, integrator, steps):
    """``nbodyax``'s ``jax.jit(jax.value_and_grad(make_loss(...)))`` with
    respect to pos, vel and mass (the jnp oracle), as numpy."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from nbodyax import autodiff as jautodiff
    from nbodyax.config import SimConfig as JaxConfig
    from nbodyax.physics import pairwise as jpairwise
    from nbodyax.physics import step as jstep
    from nbodyax.state import make_state as jax_make_state
    cfg = JaxConfig(particle_count=N, collision_mode=mode, backend="jnp",
                    softening=5.0, integrator=integrator,
                    field_width=10_000, field_height=10_000)
    p = jstep.PhysicsParams.from_config(cfg)
    step = jstep.make_step(p, accum_fn=functools.partial(
        jpairwise.pair_accumulators, eps=p.eps, growth_rate=p.growth_rate,
        mode=mode))
    state = jax_make_state(*small_arrays())
    loss = jautodiff.make_loss(
        step, steps, lambda s: jnp.sum((s.pos / SCALE) ** 2) / N)
    vg = jax.jit(jax.value_and_grad(
        lambda x, v, m: loss(state._replace(pos=x, vel=v, mass=m)),
        argnums=(0, 1, 2)))
    value, grads = vg(state.pos, state.vel, state.mass)
    return float(value), tuple(np.asarray(g) for g in grads)


@functools.lru_cache(maxsize=None)
def float64_mass_grad(mode, integrator, steps):
    """The port's mass gradient in float64 (the jnp engine)."""
    st = make_state(*small_arrays(), device="cpu")
    st = st._replace(**{k: getattr(st, k).double() for k in
                        ("pos", "vel", "mass", "radius", "sim_time")})
    vg = graphed_value_and_grad(port_loss(mode, integrator, steps,
                                          dtype=torch.float64), wrt=("mass",))
    return vg(st)[1][0].numpy()


def assert_matches_jax(value, grads, case, gate):
    """``value`` and ``grads`` (pos, vel, mass) against nbodyax's jitted
    value_and_grad at ``gate``. Momentum mode's mass gradient is held as
    tests/test_torch_autodiff.py::test_rollout_grads_match_jax holds it:
    no noisier than nbodyax's against the port's float64 gradient, and
    within 2e-5 of nbodyax's."""
    integrator, steps, _, mode = case
    j_value, j_grads = jax_value_and_grad(mode, integrator, steps)
    assert abs(value - j_value) <= gate * abs(j_value), (value, j_value)
    for leaf, g, w in zip(LEAVES, grads, j_grads):
        assert np.abs(w).max() > 0 and np.all(np.isfinite(g)), leaf
        if mode == "momentum" and leaf == "mass":
            exact = float64_mass_grad(mode, integrator, steps)
            assert rel_err(g, exact) <= rel_err(w, exact), case
            assert rel_err(g, w) < 2e-5, (case, rel_err(g, w))
        else:
            assert rel_err(g, w) < gate, (case, leaf, rel_err(g, w))


class HostRead(AssertionError):
    pass


def refuse_host_reads(monkeypatch):
    """Every host read of a tensor raises ``HostRead`` from here on."""
    def refuse(name):
        def read(*a, **k):
            raise HostRead(f"host read {name} in the gradient's body")
        return read
    for name in HOST_READS:
        monkeypatch.setattr(torch.Tensor, name, refuse(name))


# ---------------------------------------------------------------------------
# One device, on the CPU
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def cpu_call(case):
    integrator, steps, _, mode = case
    st = make_state(*small_arrays(), device="cpu")
    with graphed_value_and_grad(port_loss(mode, integrator, steps)) as vg:
        return vg(st)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cpu_call_equals_make_loss_and_autograd(case):
    """Value and gradients bit for bit those of ``make_loss`` and
    ``torch.autograd.grad``."""
    integrator, steps, _, mode = case
    st = make_state(*small_arrays(), device="cpu")
    leaves = [t.clone().requires_grad_(True) for t in st[:3]]
    value = port_loss(mode, integrator, steps)(st._replace(
        pos=leaves[0], vel=leaves[1], mass=leaves[2]))
    grads = torch.autograd.grad(value, leaves)
    got_value, got_grads = cpu_call(case)
    assert torch.equal(got_value, value.detach())
    assert not got_value.requires_grad
    for a, b in zip(got_grads, grads):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cpu_call_matches_jax_jit_value_and_grad(case, spawned):
    value, grads = cpu_call(case)
    assert_matches_jax(float(value), [g.numpy() for g in grads], case,
                       ROLLOUT_GATE)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_cpu_call_reads_nothing_back(case, monkeypatch):
    """The body a capture records (forward, remat re-runs, backward) with
    every host read refused: it runs through, and gives the same value
    and gradients."""
    integrator, steps, _, mode = case
    st = make_state(*small_arrays(), device="cpu")
    vg = graphed_value_and_grad(port_loss(mode, integrator, steps))
    refuse_host_reads(monkeypatch)
    value, grads = vg(st)
    monkeypatch.undo()
    want_value, want_grads = cpu_call(case)
    assert torch.equal(value, want_value)
    assert all(torch.equal(a, b) for a, b in zip(grads, want_grads))


def test_the_refusal_catches_a_host_read(monkeypatch):
    """The check above would see a loss that reads the card."""
    st = make_state(*small_arrays(), device="cpu")
    loss = port_loss("reference", "euler", 1)
    vg = graphed_value_and_grad(
        lambda s: loss(s) * float(s.mass.sum() > 0))
    refuse_host_reads(monkeypatch)
    with pytest.raises(HostRead):
        vg(st)


def test_wrt_names_distinct_state_fields():
    loss = port_loss("reference", "euler", 1)
    for wrt in ((), ("pos", "pos"), ("step",), ("sim_time",)):
        with pytest.raises(ValueError):
            graphed_value_and_grad(loss, wrt=wrt)


def test_an_unread_field_has_a_zero_gradient():
    """As ``jax.value_and_grad``: in "none" mode with nothing touching the
    walls the radius is never read."""
    st = make_state(*small_arrays(), device="cpu")
    p = PhysicsParams.from_config(config("none", "euler"))
    loss = make_loss(make_step(p, accum_fn=build_accum_fn("auto", p, "cpu")),
                     2, target_loss)
    value, (g_pos, g_radius) = graphed_value_and_grad(
        loss, wrt=("pos", "radius"))(st)
    assert float(g_pos.abs().max()) > 0
    assert torch.equal(g_radius, torch.zeros_like(st.radius))


def test_bh_stays_forward_only():
    """``forceModel=bh`` has no gradient: the object raises as the eager
    gradient does."""
    from nbodyax_torch import driver
    cfg = SimConfig(particle_count=64, force_model="bh", bh_levels=2,
                    bh_near="rows", bh_neighbor_k=16, bh_pallas="off")
    step = driver.build_step(cfg, "cpu")
    st = make_state(*(np.resize(a, (64,) + a.shape[1:])
                      for a in small_arrays()), device="cpu")
    with pytest.raises(NotImplementedError):
        graphed_value_and_grad(make_loss(step, 1, target_loss))(st)


# ---------------------------------------------------------------------------
# Two gloo ranks
# ---------------------------------------------------------------------------

CHILD = r"""
import json, sys
import numpy as np, torch, torch.distributed as dist
rank, size, store, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method="file://" + store, rank=rank,
                        world_size=size)
from nbodyax_torch.autodiff import graphed_value_and_grad, make_loss
from nbodyax_torch.config import SimConfig
from nbodyax_torch.physics.step import PhysicsParams
from nbodyax_torch.sharding import (make_group, make_sharded_step,
                                    pad_to_shards, shard_state)
from nbodyax_torch.state import make_state
spec = json.loads(sys.argv[5])
g = make_group(size, "cpu")
arrays = [np.asarray(a, np.float32) for a in spec["arrays"]]
n, scale = len(arrays[2]), spec["scale"]
HOST_READS = spec["host_reads"]
out = {}


def share(s):
    return ((s.pos / scale) ** 2).sum() / n


for integ, steps, mode in spec["cases"]:
    cfg = SimConfig(shards=size, collision_mode=mode, integrator=integ,
                    **spec["base"])
    step = make_sharded_step(cfg, PhysicsParams.from_config(cfg), g)
    st = shard_state(pad_to_shards(make_state(*arrays, device="cpu"), size), g)
    loss = make_loss(step, steps, share)
    leaves = [t.clone().requires_grad_(True) for t in st[:3]]
    value = loss(st._replace(pos=leaves[0], vel=leaves[1], mass=leaves[2]))
    want = torch.autograd.grad(value, leaves)
    saved = {k: getattr(torch.Tensor, k) for k in HOST_READS}
    reads = []

    def refuse(name):
        def read(*a, **k):
            reads.append(name)
            raise AssertionError("host read " + name)
        return read
    for k in HOST_READS:
        setattr(torch.Tensor, k, refuse(k))
    try:
        with graphed_value_and_grad(loss) as vg:
            got_value, got = vg(st)
        error = None
    except AssertionError as e:
        error = str(e)
    finally:
        for k, f in saved.items():
            setattr(torch.Tensor, k, f)
    row = {"error": error, "host_reads": reads}
    if error is None:
        row["bitwise"] = (torch.equal(got_value, value.detach())
                          and all(torch.equal(a, b) for a, b in zip(got, want)))
        row["value"] = float(g.all_gather(got_value[None]).sum())
        row["grads"] = [g.all_gather(t)[:n].tolist() for t in got]
    out[f"{integ}-{mode}"] = row
with open(f"{work}/rank{rank}.json", "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """The two gloo ranks, started and not waited for: the first test that
    compiles nbodyax's gradient asks for them, so they run beside the
    compiles."""
    work = tmp_path_factory.mktemp("grad_graph")
    spec = json.dumps({
        "arrays": [a.tolist() for a in small_arrays()], "scale": SCALE,
        "cases": [[i, s, m] for i, s, _, m in CASES],
        "host_reads": HOST_READS,
        "base": dict(softening=5.0, field_width=10_000,
                     field_height=10_000)})
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(r), str(RANKS),
         str(work / "store"), str(work), spec], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(RANKS)]
    yield work, procs
    for p in procs:
        p.kill()


@pytest.fixture(scope="module")
def ranks(spawned):
    """Each rank's rows of results."""
    work, procs = spawned
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-3000:]
    return [json.loads((work / f"rank{r}.json").read_text())
            for r in range(RANKS)]


def sharded_row(ranks, case, rank=0):
    row = ranks[rank][f"{case[0]}-{case[3]}"]
    assert row["error"] is None, row["error"]
    return row


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sharded_call_equals_make_loss_and_autograd(ranks, case):
    """On every rank, value and gradients of its share bit for bit those
    of ``make_loss`` and ``torch.autograd.grad`` over the sharded step."""
    for rank in range(RANKS):
        assert sharded_row(ranks, case, rank)["bitwise"]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sharded_call_matches_jax_jit_value_and_grad(ranks, case):
    """The shares' sum and the gathered gradients of the whole loss."""
    row = sharded_row(ranks, case)
    assert_matches_jax(row["value"], [np.float32(g) for g in row["grads"]],
                       case, SHARDED_GATE)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sharded_call_reads_nothing_back(ranks, case):
    for rank in range(RANKS):
        assert sharded_row(ranks, case, rank)["host_reads"] == []


# ---------------------------------------------------------------------------
# On a card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def card_state(dev, n=2048):
    from nbodyax_torch.scenes import init_scene
    return init_scene(SimConfig(particle_count=n, field_width=3000,
                                field_height=3000), device=dev)


def launches_of(fn):
    """(B1, B2) launch counts ``fn`` adds, and its result."""
    tile_accumulators_raw.launches = raw_backward.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return (tile_accumulators_raw.launches, raw_backward.launches), out


def cloned(out):
    value, grads = out
    return value.clone(), [g.clone() for g in grads]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_graph_replays_the_eager_gradient(cuda, case):
    """Replays equal the eager gradient bit for bit, on the state it was
    captured from and on another one, and count the eager launches: B1
    twice a force pass (forward and remat), B2 two sides a pass the loss
    reads."""
    integrator, steps, passes, mode = case
    st = card_state(cuda)
    other = st._replace(pos=st.pos * 1.01)
    p = PhysicsParams.from_config(SimConfig(
        collision_mode=mode, integrator=integrator, softening=5.0))
    loss = make_loss(make_step(p, accum_fn=build_accum_fn("auto", p, cuda)),
                     steps, target_loss)
    want = (2 * steps * passes, 2 * (steps * passes - (passes - 1)))
    with graphed_value_and_grad(loss) as vg:
        for s in (st, other, st):
            eager_n, eager = launches_of(lambda: cloned(vg.eager(s)))
            graph_n, graph = launches_of(lambda: cloned(vg(s)))
            assert eager_n == graph_n == want, (eager_n, graph_n, want)
            assert torch.equal(graph[0], eager[0])
            for a, b in zip(graph[1], eager[1]):
                assert torch.equal(a, b)
                assert float(a.abs().max()) > 0
        assert vg.capture_seconds > 0


@pytest.mark.cuda
def test_a_capture_that_fails_raises(cuda):
    """A loss that reads the card from the host cannot be captured: the
    call raises ``GraphCaptureError``, with no eager fallback."""
    st = card_state(cuda, 256)
    p = PhysicsParams.from_config(SimConfig())
    loss = make_loss(make_step(p, accum_fn=build_accum_fn("auto", p, cuda)),
                     2, lambda s: target_loss(s) * float(s.mass.sum() > 0))
    before = (tile_accumulators_raw.launches, raw_backward.launches)
    with graphed_value_and_grad(loss) as vg, \
            pytest.raises(GraphCaptureError):
        vg(st)
    assert (tile_accumulators_raw.launches, raw_backward.launches) == before


@pytest.mark.cuda
def test_another_shape_or_step_raises(cuda):
    st = card_state(cuda, 256)
    p = PhysicsParams.from_config(SimConfig())
    loss = make_loss(make_step(p, accum_fn=build_accum_fn("auto", p, cuda)),
                     1, target_loss)
    with graphed_value_and_grad(loss) as vg:
        vg(st)
        for s in (card_state(cuda, 512), st._replace(step=st.step + 1)):
            with pytest.raises(ValueError):
                vg(s)


ONE_RANK_CHILD = r"""
import json, sys
import torch
sys.path.insert(0, sys.argv[1])
from nbodyax_torch.autodiff import graphed_value_and_grad, make_loss
from nbodyax_torch.backends import build_accum_fn
from nbodyax_torch.config import SimConfig
from nbodyax_torch.physics.step import PhysicsParams, make_step
from nbodyax_torch.scenes import init_scene
from nbodyax_torch.sharding import close_group, make_group, make_sharded_step
g = make_group(1, "cuda")
out = {}
ok = False
try:
    for integ, steps in (("euler", 4), ("leapfrog", 2)):
        for mode in ("reference", "momentum", "elastic"):
            cfg = SimConfig(particle_count=2048, collision_mode=mode,
                            integrator=integ, softening=5.0, field_width=3000,
                            field_height=3000, shards=1)
            p = PhysicsParams.from_config(cfg)
            st = init_scene(cfg, device=g.device)
            loss = lambda s: ((s.pos / 100.0) ** 2).sum() / 2048
            single = make_step(p, accum_fn=build_accum_fn("auto", p, g.device))
            with graphed_value_and_grad(make_loss(
                    make_sharded_step(cfg, p, g), steps, loss)) as vg:
                e_val, e_g = vg.eager(st)
                val, gr = vg(st)
                s_val, s_g = graphed_value_and_grad(
                    make_loss(single, steps, loss)).eager(st)
                out[f"{integ}-{mode}"] = {
                    "graph_eager": bool(torch.equal(val, e_val)) and all(
                        torch.equal(a, b) for a, b in zip(gr, e_g)),
                    "single": [float((a - b).abs().max() / b.abs().max())
                               for a, b in zip(gr, s_g)]}
    ok = True
finally:
    close_group(not ok)
print(json.dumps(out))
"""


@pytest.mark.cuda
def test_one_rank_nccl_gradient_graph(cuda, tmp_path):
    """On a card, a one-rank NCCL group: the sharded gradient graph equals
    the sharded eager gradient bit for bit, and the single-device one
    within the sharded gate; momentum mode's mass gradient, rounding in
    every float32 engine on this scene (chip_smoke.py's
    ``sharded_gradients``), is held by the bitwise check alone."""
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               LOCAL_WORLD_SIZE="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(29500 + os.getpid() % 1000))
    r = subprocess.run([sys.executable, "-c", ONE_RANK_CHILD, ROOT],
                       cwd=tmp_path, env=env, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert len(res) == len(CASES)
    for name, row in res.items():
        assert row["graph_eager"], name
        gated = row["single"][:2] if "momentum" in name else row["single"]
        assert max(gated) < SHARDED_GATE, (name, row)
