"""The per-layer readers and the trace reduction, on synthetic records."""

from __future__ import annotations

import pytest

from perfbench import trace
from perfbench.spec import load_metric

MS = 1_000_000  # ns


def record(device, *, steps=4, shards=1, log=(), final=100, rows=None,
           window_s=None, busy_s=None, jobs=()):
    t0 = min((s for _, s, _ in device), default=0)
    t1 = max((e for _, _, e in device), default=0)
    win = window_s if window_s is not None else (t1 - t0) / 1e9
    return {"cell": "c", "params": {"dimensions": 2}, "shards": shards,
            "horizon": steps, "kind": "NVIDIA H100 80GB HBM3",
            "jobs": list(jobs),
            "trace": {"steps": steps, "window_s": win,
                      "busy_s": (busy_s if busy_s is not None
                                 else trace.busy_seconds(device, t0, t1)),
                      "device": device, "log": list(log),
                      "final_alive": final,
                      "rows_alive": final if rows is None else rows}}


def test_short_names_cut_return_type_namespace_template_and_arguments():
    assert trace.short_name("void (anonymous namespace)::pair_kernel<2, 0>"
                            "(float const*, int)") == "pair_kernel"
    assert trace.short_name("void (anonymous namespace)::pair_combine("
                            "float const*, int const*)") == "pair_combine"
    assert trace.short_name("void at::native::reduce_kernel<512, 1>(int)") \
        == "reduce_kernel"
    assert trace.short_name("ncclDevKernel_SendRecv(ncclDevKernelArgs"
                            "Storage<4096ul>)") == "ncclDevKernel_SendRecv"
    assert trace.family("pair_combine") == "B1"
    assert trace.family("pair_bwd_kernel") == "B2"
    assert trace.family("ncclDevKernel_AllGather_RING_LL") == "NCCL"
    assert trace.family("vectorized_elementwise_kernel") is None


def test_busy_time_is_the_union_and_idle_is_named_by_the_host():
    device = [("a", 0, 10 * MS), ("b", 5 * MS, 20 * MS),    # overlap
              ("c", 30 * MS, 40 * MS), ("d", 40 * MS + 5_000, 50 * MS)]
    assert trace.busy_seconds(device, 0, 60 * MS) == pytest.approx(
        (20 + 10 + 10 - 0.005) / 1e3)
    host = [("job", 0, 60 * MS), ("cudaStreamSynchronize", 19 * MS, 31 * MS),
            ("aten::copy_", 52 * MS, 53 * MS)]
    idle = dict(trace.idle_by_host(device, host, 0, 60 * MS))
    assert idle["cudaStreamSynchronize"] == pytest.approx(0.010)
    # the end gap: copy_ covers a tenth of it, the job span all of it
    assert idle["job"] == pytest.approx(0.010)
    assert idle["between kernels (gaps < 20 us)"] == pytest.approx(5e-6)


def test_b1_roofline_counts_live_pairs_from_the_next_log_point():
    # 4 steps, logs at 2 (alive 90) and 4 (alive 80), one warm-up launch;
    # every launch 1 ms
    device = [("pair_kernel", i * 2 * MS, (i * 2 + 1) * MS)
              for i in range(5)]
    rec = record(device, steps=4, log=[{"step": 2, "alive": 90},
                                       {"step": 4, "alive": 80}], final=80)
    pairs = 2 * 90 * 89 + 2 * 80 * 79 + 1 * 80 * 79
    want = 100 * pairs * 18 / 67e12 / 5e-3
    assert load_metric("b1_roofline").read(rec) == pytest.approx(want)


def test_b1_roofline_on_a_ring_counts_rank_0s_rows_against_all():
    # 2 shards, 2 steps, no log point: 2 launches a step, no warm-up
    device = [("pair_kernel", i * MS, i * MS + 500_000) for i in range(4)]
    device.append(("pair_combine", 10 * MS, 10 * MS + 100_000))
    rec = record(device, steps=2, shards=2, final=1000, rows=400)
    want = 100 * 2 * 400 * 999 * 18 / 67e12 / 2.1e-3
    assert load_metric("b1_roofline").read(rec) == pytest.approx(want)


def test_per_step_readers_divide_by_the_executed_steps():
    device = [("near_kernel", 0, 1 * MS), ("near_kernel", 2 * MS, 3 * MS),
              ("elementwise_kernel", 3 * MS, 7 * MS),
              ("ncclDevKernel_SendRecv", 7 * MS, 8 * MS)]
    rec = record(device, steps=2)
    assert trace.executed_steps(rec) == 2
    assert load_metric("b3_ms_per_step").read(rec) == pytest.approx(1.0)
    assert load_metric("other_device_ms_per_step").read(rec) == \
        pytest.approx(2.0)
    assert load_metric("nccl_ms_per_step").read(rec) == pytest.approx(0.5)
    ring = record([("pair_kernel", 0, MS)] * 8, steps=2, shards=4)
    assert trace.executed_steps(ring) == 2


def test_idle_share_and_window_readers():
    rec = record([("k", 0, 3 * MS)], window_s=0.004, busy_s=0.003,
                 jobs=[{"steps": 10, "steps_per_sec": 100.0,
                        "seconds": {"capture": 0.5}},
                       {"steps": 10, "steps_per_sec": 50.0,
                        "seconds": {"capture": 0.3}}])
    assert load_metric("device_idle_share").read(rec) == pytest.approx(25.0)
    assert load_metric("capture_s").read(rec) == pytest.approx(0.4)
    assert load_metric("window_steps_per_s").read(rec) == pytest.approx(
        20 / 0.3)
    assert load_metric("window_steps_per_s.host_heavy").read(rec) == \
        pytest.approx(20 / 0.3)


@pytest.mark.parametrize("name", ["b1_roofline", "b3_ms_per_step",
                                  "nccl_ms_per_step", "device_idle_share",
                                  "other_device_ms_per_step"])
def test_a_reader_with_nothing_to_read_returns_nothing(name):
    assert load_metric(name).read(record([], window_s=1.0)) is None
