"""The port's benchmark runners, on the CPU at small sizes.

``nbodyax_torch.bench`` prints one JSON line with its keys (N = 4,096 on
the CPU). Each config of ``nbodyax_torch.bench_suite`` runs at a small size
(configs 5 and 6 under bh at 4,096 bodies) and prints the keys of
``bench/suite.py``'s line (config 4 less its TPU target, config 5 with the
ring stated as not ported). For configs 1-3 the checks are computed again
through ``nbodyax`` from the same states: its jnp oracle (``make_step``)
and ``build_step`` run from the port's starting state, and its
``conservation_scalars`` read the port's states. The card runs the full
sizes (``chip_smoke.py`` phase 35).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax import lax  # noqa: E402

from nbodyax import state as jstate  # noqa: E402
from nbodyax.config import SimConfig as JaxConfig  # noqa: E402
from nbodyax.driver import build_step as jax_build_step  # noqa: E402
from nbodyax.metrics import conservation_scalars  # noqa: E402
from nbodyax.physics.step import PhysicsParams as JaxParams  # noqa: E402
from nbodyax.physics.step import make_step as jax_make_step  # noqa: E402
from nbodyax_torch import bench, bench_suite  # noqa: E402
from nbodyax_torch.state import make_state  # noqa: E402

CPU = torch.device("cpu")
RATES = ("steps_per_sec", "pairs_per_sec")
KEYS = {
    1: {"config", "n", *RATES, "max_pos_drift_rel_field_100steps",
        "f32_noise_floor_rel_field_100steps", "oracle_match_f32"},
    2: {"config", "n", *RATES, "mass_rel_drift", "momentum_drift_rel",
        "alive"},
    3: {"config", "n", *RATES, "alive_after",
        "oracle_alive_agreement_2steps", "finite"},
    4: {"config", "n", *RATES},
    5: {"config", "n", "workload", "force_model", "steps_per_sec",
        "equivalent_exact_pairs_per_sec", "exact_steps_per_sec",
        "exact_pairs_per_sec", "finite", "ring_dryrun_8dev_ok",
        "ring_dryrun_wall_s"},
    6: {"config", "n", "steps_per_sec", "equivalent_exact_pairs_per_sec",
        "force_model", "finite"},
}
SMALL = {1: dict(n=256, steps=40), 2: dict(n=256, steps=10, chunk=5),
         3: dict(n=2048, steps=2, chunk=1, oracle_chunk=256),
         4: dict(n=512), 5: dict(n=4096, steps=2), 6: dict(n=4096, steps=2)}


@pytest.fixture
def one_thread():
    """Run torch on one thread: a CPU bh step is thousands of small ops,
    and beside the suite's other workers each op's thread pool contends
    with theirs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_jax(s):
    return jstate.make_state(*(t.numpy() for t in s[:4]), step=int(s.step),
                             sim_time=float(s.sim_time))


def jax_run(step, s, steps):
    return jax.jit(lambda x: lax.fori_loop(0, steps, lambda i, y: step(y),
                                           x))(s)


def test_bench_cpu_line(capsys):
    assert bench.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    line = json.loads(out[0])
    assert set(line) == {"metric", "value", "unit", "n", "reps",
                         "step_ms_median", "step_ms_min", "step_ms_max",
                         "spread", "launches", "device"}
    assert line["metric"] == ("pairwise_interactions_per_sec_per_chip_"
                              "collisions_on_N4096")
    assert (line["n"], line["reps"], line["unit"], line["device"]) == (
        4096, 2, "pairs/s", "cpu")
    assert line["step_ms_min"] <= line["step_ms_median"] <= line[
        "step_ms_max"]
    np.testing.assert_allclose(
        line["value"], 4096.0 ** 2 / (line["step_ms_median"] / 1e3),
        rtol=1e-9)
    assert line["spread"] >= 0
    # the CPU runs the kernels' plain versions, which count nothing
    assert line["launches"] == dict.fromkeys(bench.KERNELS, 0)


def test_bench_asks_for_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


@pytest.mark.parametrize("config", sorted(KEYS))
def test_suite_config_keys(config, one_thread):
    line, states = bench_suite.CONFIGS[config](CPU, **SMALL[config])
    assert KEYS[config] <= set(line)
    assert line["config"] == config
    assert json.loads(json.dumps(line)) == line
    for key in ("steps_per_sec", "pairs_per_sec",
                "equivalent_exact_pairs_per_sec", "exact_pairs_per_sec"):
        if key in line:
            assert line[key] > 0
    if "finite" in line:
        assert line["finite"] is True
    if config == 5:
        assert line["ring_dryrun_8dev_ok"] is True
        assert "v5e" not in line["workload"]
    assert "target_1e11" not in line


def test_suite_main_prints_a_line_a_config(capsys, monkeypatch, tmp_path):
    """``main`` runs the configs asked for, one line each with
    ``bench_wall_s`` and the device, and writes them to ``--out``."""
    for c in (1, 4):
        monkeypatch.setitem(
            bench_suite.CONFIGS, c,
            lambda dev, f=bench_suite.CONFIGS[c], c=c: f(dev, **SMALL[c]))
    out = tmp_path / "r.json"
    assert bench_suite.main(["--configs", "4,1", "--device", "cpu",
                             "--out", str(out)]) == 0
    lines = [json.loads(x) for x in
             capsys.readouterr().out.strip().splitlines()]
    assert [x["config"] for x in lines] == [4, 1]
    assert all(x["device"] == "cpu" and x["bench_wall_s"] >= 0
               and x["launches"] == dict.fromkeys(bench.KERNELS, 0)
               for x in lines)
    assert json.loads(out.read_text()) == lines


def test_config1_rule_against_nbodyax_oracle():
    """The kernel path's run stays within the rule of nbodyax's own jnp
    oracle from the same start, and both oracles keep the same bodies."""
    kw = SMALL[1]
    line, st = bench_suite.config1_oracle_match(CPU, **kw)
    assert line["oracle_match_f32"] is True
    p = JaxParams.from_config(JaxConfig(particle_count=kw["n"],
                                        softening=50.0, timestep=0.2))
    want = jax_run(jax_make_step(p), to_jax(st["start"]), kw["steps"])
    np.testing.assert_array_equal(np.asarray(want.mass) > 0,
                                  st["oracle"].mass.numpy() > 0)
    assert (line["max_pos_drift_rel_field_100steps"],
            line["f32_noise_floor_rel_field_100steps"]) == (
        bench_suite.drift_and_floor(st["kernel"], st["oracle"],
                                    st["permuted"], 100000))
    ref = make_state(*(np.asarray(x) for x in want[:4]), device="cpu")
    assert bench_suite.oracle_match(*bench_suite.drift_and_floor(
        st["kernel"], ref, st["permuted"], 100000))


def test_config2_conservation_against_nbodyax():
    """The drift keys from nbodyax's ``conservation_scalars`` of the same
    two states equal the port's, and nbodyax's ``build_step`` run from the
    same start for the same steps keeps the same bodies and mass."""
    kw = SMALL[2]
    line, st = bench_suite.config2_elastic_conservation(CPU, **kw)
    s0, s1 = (conservation_scalars(to_jax(st[k])) for k in ("start",
                                                             "final"))
    want = bench_suite.conservation_keys(s0, s1)
    assert want["alive"] == line["alive"] == kw["n"]
    assert want["mass_rel_drift"] == line["mass_rel_drift"] == 0.0
    # both are f32 rounding of momentum sums taken in different orders:
    # they agree within f32's epsilon of the momentum scale
    np.testing.assert_allclose(line["momentum_drift_rel"],
                               want["momentum_drift_rel"], rtol=0,
                               atol=float(np.finfo(np.float32).eps))
    cfg = JaxConfig(particle_count=kw["n"], collision_mode="elastic",
                    softening=100.0, timestep=0.2, backend="jnp")
    ran = kw["chunk"] + kw["steps"]   # the warm window, then the timed ones
    got = jax_run(jax_build_step(cfg, capacity=kw["n"]), to_jax(st["start"]),
                  ran)
    assert int(st["final"].step) == ran
    s2 = conservation_scalars(got)
    assert s2["alive"] == line["alive"]
    assert float(s2["total_mass"]) == float(s1["total_mass"])


def test_config3_alive_agreement_against_nbodyax():
    """nbodyax's chunked jnp oracle takes the same merge decisions over
    the 2 steps as the port's kernel path and oracle; ``alive_after`` is
    nbodyax's count of the final state."""
    kw = SMALL[3]
    line, st = bench_suite.config3_merging_long_horizon(CPU, **kw)
    assert line["oracle_alive_agreement_2steps"] == 1.0
    p = JaxParams.from_config(JaxConfig(particle_count=kw["n"],
                                        collision_mode="reference",
                                        timestep=0.2))
    want = jax_run(jax_make_step(p, chunk=kw["oracle_chunk"]),
                   to_jax(st["start"]), 2)
    alive = np.asarray(want.mass) > 0
    assert not alive.all()   # bodies merge in those 2 steps
    np.testing.assert_array_equal(alive, st["kernel_2"].mass.numpy() > 0)
    np.testing.assert_array_equal(alive, st["oracle_2"].mass.numpy() > 0)
    assert line["alive_after"] == conservation_scalars(
        to_jax(st["final"]))["alive"]
