#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``nbodyax_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. print the card's name and power limit; build the six CUDA sources of
   ``nbodyax_torch/csrc`` (one ``nvcc`` a source, in parallel; the fifth,
   ``graph_cond.cu``, sets the bh step's CUDA-graph IF nodes) and print the
   build time and ptxas's registers and spills of every kernel;
2. compare the all-pairs kernel with its plain PyTorch version on the card,
   in all four collision modes, at N = 300 (random, dense overlaps) and at
   N = 16,384 (the default scene), each with a dead slot, plus offset calls
   over split j halves, at the gates of tests/test_kernels.py and the force
   within 3e-7 of the largest, ids past 2^30 and two calls bitwise equal
   (at N = 16,384 the partners are split across blocks), and a momentum
   tie whose equal-mass candidates lie in different splits;
3. run the external C++-oracle golden ``tests/golden/ref_n1k.npz`` for 200
   steps through the kernel, at the gates of tests/test_golden.py, and 20
   steps of the default scene through the kernel against the plain path;
   then ``ref_n1k`` through the driver's graph windows (20 replays of a
   10-step CUDA graph), every window's end at the same gates and bitwise
   equal to the eager steps, B1 counted by replays;
4. run the main path: ``nbodyax_torch.cli`` with the built-in default
   config (N = 16,384, seed 1024) for 200 steps with a frame every 10, its
   windows as CUDA-graph replays, and check the 20 P5 frames, the log and
   that every step launched the kernel (counted by replays); the same
   config through the driver's eager runner gives the same final state,
   log values (timings aside) and frames, bit for bit;
4b. the full default run, nothing cut (2,000 steps, 200 frames): ``Time
   taken`` of graph windows and of the eager runner in turns (graph,
   eager, eager, graph), the window count, the graph runs' peak device
   memory and their host seconds by part (scene, captures, windows,
   frames, checkpoints), the kernel libraries' load in a fresh process,
   graph and eager bitwise equal; one graph run without frames;
5. time the kernel against its plain version at N = 16,384 and alone at
   N = 131,072, with the splits chosen, the CUDA launches a call, pairs/s,
   the share of the bound and the SM clock under load; its own device time
   by the profiler beside the wrapper call's CUDA-event time; profile one
   default-scene step; profile 5 replays of a 10-step graph window: device
   time a step, device idle share, peak device memory; the CLI's
   ``--profile DIR`` over 50 steps of graph windows;
6. compare the backward kernel with its plain version on the same inputs
   as phase 2, in all four modes at eps = 0 and in elastic mode at eps = 5,
   with a numpy-made cotangent, plus offset calls whose two j halves sum
   to the full call, at tests/test_autodiff.py's gate (3e-6), and two
   calls bitwise equal;
7. the differentiable path at full width: the gradient of a 4-step euler
   and a 2-step leapfrog rollout of the default scene (softening 100,
   bench/grad_step.py's terminal loss) with respect to the initial pos and
   mass, through the kernels and through autograd of the torch oracle,
   with the launch counts the rollout must make;
8. the shooting descent of tests/test_autodiff.py through the kernels;
9. ``nbodyax_torch.cli`` with ``integrator=leapfrog`` and with
   ``yoshida4`` for 20 steps, two and four forward launches a step, graph
   against eager as phase 4; the four collision modes under euler,
   leapfrog and yoshida4 for 50 steps of the default scene, graph windows
   against the eager runner, bitwise; ``adaptiveDt=1`` on the CLI for 200
   steps, graph against eager, every ``dt_mean`` within ``dt_bounds``;
   ``energyEvery=50`` through graph windows, the logged potential against
   the CPU's ``potential_energy`` of the same state at rtol 1e-5;
10. time the backward kernel against its plain version at N = 16,384 and
    alone at N = 131,072 (as phase 5, device time too); one gradient of a
    4-step euler rollout as one CUDA-graph replay
    (``autodiff.graphed_value_and_grad``) and eagerly, in turns, against
    one forward step (ms a call and a rollout step, grad_over_forward,
    capture seconds, peak memory) and profiled each way (device time,
    ops, idle share); one graphed gradient at suite config 3's N =
    131,072; then the gradient graph of phase 7's rollouts in reference,
    momentum and elastic mode against the eager gradient (bitwise where
    the eager gradient repeats, which is checked) and the oracle path,
    with B1's and B2's launches by replay equal to the eager call's;
11. ``forceModel=bh``'s slot-pack kernels (B5, and B4 without moments)
    against their plain versions on examples/million_bodies.txt's scene
    (N = 1,048,576) and on a crowded state: rows bitwise, moments at 2e-6;
12. the bh near-field kernel B3 against its plain version in all four
    modes at eps 0 and 100 on a crowded N = 65,536 state, and on the 1M
    scene, at tests/test_barneshut.py's gates;
13. bh through B3/B5 against the exact kernel B1 at N = 65,536: far-field
    error at ring 1, collision channels exact where every overlap is in
    the window, and the FMM table on the card equal to the CPU's (no TF32);
14. the bh main path: ``nbodyax_torch.cli`` on the 1M scene with
    ``forceModel=bh`` and default bh knobs for 20 steps through graph
    windows: the knobs it picked, ``bh_overflow`` 0, B3 and B5 once a step
    by replays;
15. ``bhFar=direct bhOrder=1`` on the CLI at N = 65,536: B4 once a step;
    ``adaptiveDt=1`` with the FMM: B3 and B5 once a step, ``bh_overflow``
    0, ``dt_mean`` within ``dt_bounds``; all through graph windows;
16. B3, B4 and B5 timed against their plain versions at N = 1M (B4 also
    against one gather), with bounds from the run's cell occupancy and
    each kernel's own device time; B4 and B5 by device time on the crowded
    N = 262,144 state and on a uniform state of the same N (the crowded
    cell's tail); one bh step (CUDA-event span, host wall of 5 steps) and
    the host wall a step of 10-step graph windows beside it, and one
    step's profiler breakdown and device idle share;
17. ``dimensions=3``: B1's 3-D form against its plain version at N = 300
    (random, dense overlaps, a dead slot) and on the 3-D default scene
    (N = 16,384), all four modes at eps 0 and reference and elastic at
    eps 25, at tests/test_3d.py's gates and the force within 3e-7 of the
    largest, bitwise repeats, ids past 2^30, offset calls over split j
    halves; then the planar check: a 3-D call on the z = 0 copy of the 2-D
    default scene takes the 2-D call's merge decisions, bit for bit where
    both forms split the partners alike;
18. B2's 3-D form against its plain version as phase 6;
19. the 3-D main path: ``nbodyax_torch.cli`` with ``--set dimensions=3``
    for 200 steps through graph windows, 20 P5 frames of the xy
    projection, ``momentum_z`` in every log line, one B1 launch a step by
    replays, and bitwise equal to the eager runner; then with
    ``adaptiveDt=1`` as in phase 9;
20. the 3-D gradient path: a 4-step euler rollout of the 3-D default
    scene through the kernels against autograd of the oracle, as phase 7;
21. B1 and B2 in 3-D timed beside their 2-D calls at N = 16,384 (device
    time too), B1 alone at N = 1,048,576 in 3-D and 2-D (pairs/s and
    their ratio, as bench/dim3.py records), one profiled 3-D step and a
    profiled 3-D graph window, as phase 5;
22. ``forceModel=bh`` with ``dimensions=3``: the slot-pack kernels' 3-D
    forms against their plain versions on examples/million_bodies.txt's
    scene in 3-D (N = 1,048,576 in a 1e6 cube, levels 5, S = 80) and on a
    crowded N = 262,144 state, with rows of 7 (B4, B5) and of 10 floats
    (elastic): rows bitwise, B5's 10 moments at 2e-6;
23. B3's 3-D form against its plain version: all four modes (rows of 7,
    and of 10 in elastic mode) at eps 0 and 100 and ring 1 and 2 on a
    crowded N = 65,536 state whose patch fills every slot of its cells,
    with dead slots mid-cell, two calls bitwise equal; and on the 1M 3-D
    scene's grid; float channels at 2e-5, flags and ids exact;
24. 3-D bh through B3/B5 against the exact 3-D kernel B1 at N = 16,384:
    far force within tests/test_3d.py:253-254's tolerances for (ring,
    order) = (1, 1), (1, 2), (2, 2), and collision channels exact where
    every overlap lies in the window (tests/test_3d.py:272-299);
25. the 3-D bh main path: ``nbodyax_torch.cli`` on the 1M scene with
    ``forceModel=bh dimensions=3`` and every bh knob auto for 20 steps: the
    knobs it picked, ``bh_overflow`` 0, B3 and B5 once a step, the peak
    device memory;
26. ``bhFar=direct bhOrder=1`` with ``dimensions=3`` on the CLI at
    N = 65,536 (B4 at L = 7 once a step), the same in elastic mode (B4 and
    B3 at L = 10), and elastic mode with the FMM (B5 at L = 10);
27. B3, B4 and B5 in 3-D timed against their plain versions at N = 1M
    (B4 also against one gather), bounds from the run's cell occupancy
    (23 flops a live 3-D pair; bytes with 10 moments), each kernel's own
    device time; one 3-D bh step (CUDA-event span, host wall) and the
    graph windows' host wall a step, its profiler breakdown, device idle
    share and peak memory;
27b. the bh annulus kernel against the plain ``fmm._annulus_force_cells``
    at the 1M 2-D and 3-D scenes' auto knobs, from the slot grid and from
    the sorted pack: ids equal, the force at every live slot within 1e-5
    of the largest, two launches bitwise equal; timed in turns plain,
    kernel, kernel, plain, with its own device time and its bound from
    the live slots and shell cells of mass (phases 14 and 25 count its
    launches, once a step by replays);
28. compaction through graph windows: the default scene with
    ``compactEvery=50 checkpointEvery=100 autoResume=true`` for 400 steps,
    the capacities it shrinks through, graph against eager bitwise (state,
    logs, frames, capacities), B1 once a step by replays across the
    re-captures, no segment of an old runner's graph pools left after its
    close (and the memory the allocator then holds), peak device
    memory allocated (within 16 MiB of the plain run's; the reserved peak
    is printed) and ``Time taken`` against the same run without compaction;
29. resume on the card: 200 graph steps straight against 100 steps and
    ``--resume auto`` to 200, state bitwise and the later log lines equal
    apart from the timings; the same with ``forceModel=bh`` (the
    checkpoint's knobs adopted); every run through graph windows;
30. autoResume with a fault raised between two replays at step 120: the
    run reloads the step-100 checkpoint, captures anew and ends on the
    unfaulted state, bitwise;
31. examples/galaxy_momentum.txt as shipped, cut to ``--steps 1000`` (N =
    65,536, momentum, 40 frames, checkpoints at 0, 500, 1,000): total
    mass conserved, the first 100 steps bitwise equal to the eager
    runner's, ``Time taken``, B1's device time a call, a checkpoint's
    seconds;
32. examples/million_bodies.txt as shipped (exact, N = 1,048,576), cut to
    ``--steps 20 --set checkpointEvery=10``: the C++ scene fill against
    the pure-Python draw (bitwise, seconds), a checkpoint's seconds,
    whether compaction fired, ``Time taken``; a resume from step 10 into a
    checkpoint directory of its own, bitwise equal to the straight run;
33. three_body, galaxy and plummer in 2-D and 3-D and uniform without
    parity, 50 steps each, graph against eager bitwise; every scene drawn
    on the card bitwise the CPU's; nbodyax's fingerprints of suite
    config 5's 4M galaxy and config 4's 1M uniform scene (mass and radius
    sums equal, |pos| within 1e-6) and the galaxy's set-up seconds; the
    default scene
    with ``forceModel=bh compactEvery=50`` for 200 steps: the capacities,
    the knobs re-resolved after each shrink, ``bh_overflow`` 0, B3 and B5
    once a step by replays across the re-captures;
34. ``forceModel=bh`` through graph windows: the bh million CLI in 2-D
    and 3-D for 20 steps, graph against eager in turns (graph, eager,
    eager, graph), state and logs bitwise, B3 and B5 once a step; the host
    wall a step, ``Time taken``, peak device memory, each capture's
    seconds and node count (IF nodes and the nodes in their bodies), the
    run length at which the graphs break even, and, in an eager run of
    its own, the completion tier and the qualifying giants of each step;
    the galaxy example with ``forceModel=bh compactEvery=50`` (in 2-D it
    merges and compacts, in 3-D bhAdapt retunes its knobs: each a new
    capture), 400 steps in 2-D and 50 in 3-D, graph against eager:
    ``Time taken``, captures and their seconds; in 2-D a crowded N =
    262,144 state (a quarter of the bodies in one patch: the full
    completion tier, then giants) graph against eager, and the giant
    pass's two tiers timed at N = 1M; a profiled 10-step window graph
    against eager: the device's idle share from the gaps between its
    kernels with the profiled span beside the step by CUDA events without
    the profiler (the profiler slows a graph of many small kernels), kernel
    time and kernels a step;
35. the benchmark runners at full size, each in its own process:
    ``python -m nbodyax_torch.bench`` (N = 1,048,576 through one-step graph
    replays, the median of 5 with its spread) and ``python -m
    nbodyax_torch.bench_suite``'s six configs (``bench/suite.py``'s sizes:
    the oracle match at N = 1,024, elastic conservation at 16,384, merges
    against the oracle at 131,072, 1M exact, the 4M galaxy under bh and
    exact, the 1M uniform scene under bh), each line printed and gated
    (oracle match, exact mass and every body kept, merge agreement 1.0,
    finite, positive rates, the path's kernels launched); config 6's
    scene in an untimed eager run: each step's tier and giants, and one
    step's heaviest kernels; then
    examples/shooting_gradient_torch.py through B1 and B2, each gradient
    a replay of its CUDA graph, miss^2 below 1% of its start, and its
    first gradient op by op, bitwise the graph's, one call timed each
    way; then ``--debug-nans``: an overflowing state exits
    non-zero with ``FloatingPointError`` at step 19, and the default scene
    for 20 steps with frames is bitwise the same with and without it;
36. B3's cell-slice form (the sharded bh step's): the 2-D million scene
    cut into P = 2, 4 and 8 slices and the 3-D one into 8, every slice
    against its plain version at B3's gates and the slices together
    bitwise equal to the full launch; the device time of one 1/8 slice
    beside the full launch's; a slice past the grid refused by the wrapper
    and by the C entry point;
37. ``bh_cellrange_accumulators`` of each of 8 ranks, one after another
    in this process, on suite config 5's N = 4,194,304 galaxy (bh knobs
    resolved from the state) and on the 3-D million scene: each body
    touched by one rank, the rebased sum against the single-device
    ``bh_accumulators`` at tests/test_sharded_bh.py:166-222's gates, each
    rank's time (one process on one card, not a multi-card time), B3's
    slice launches;
38. the exact ring's fold at P = 8 in this process: B1 over each rank's
    hops with the global offsets, folded in hop order, against the
    single-device accumulators at tests/test_ring.py:58-72's gates, on
    suite config 3's N = 131,072 scene (every rank) and on config 5's 4M
    galaxy (rank 0's rows);
39. the port's collectives on CUDA tensors: a one-rank NCCL group in a
    child process runs ``make_sharded_step`` (with all_gather and
    all_min) and ``make_sharded_bh_step`` (with all_gather and
    reduce_scatter) on the default scene, bitwise against the
    single-device steps; with two cards or more (``phase_multicard``) the
    default scene by a torchrun CLI on one card and over 2 and min(4,
    cards) ranks, each through graph windows and eagerly, ``Time taken``
    and the device's ms a step of each: bh for 50 steps, bitwise to one
    card at every 10th; exact for 200 steps, merges equal at every 20th
    and positions at tests/test_ring.py's gates at step 20 (the ring's
    sums round differently, and close encounters amplify that); sharded
    graph runs bitwise the sharded eager ones; suite config 5 on one card
    and sharded over each P, graph and eager; a rank raising between
    replays, which must end the launch within 150 s, through graph
    windows and through the eager sharded runner, and under autoResume
    its relaunch, bitwise the straight run; on one card the line
    ``sharded_multicard: not run (1 card)``. Then
    the gradient through the sharded ring: ``make_loss`` over
    ``make_sharded_step`` under a one-rank NCCL group (torchrun) on the
    default scene at phase 10's settings (4 euler steps, 2 leapfrog
    steps) in reference, momentum and elastic mode with remat, d/d(pos,
    vel, mass) against the single-device kernel path and the
    single-device oracle at 1e-5 of the largest |grad|; momentum mode's
    mass gradient, which float32 rounding swamps in every engine, in
    float64 through the oracle's ring against the single-device oracle
    in float64 (see ``sharded_gradients``); bitwise or not, and the
    gradient's host time sharded and single-device; with two cards or
    more the same over 2 and min(4, cards) ranks. Each of those gradients
    is also taken as one CUDA graph that holds the ring's NCCL collectives
    and their transposes: bitwise the eager sharded gradient on every rank
    (or within GRAD_GATE), replays repeating, B1's and B2's launches by
    replay equal to the eager call's, a replay's and an eager call's host
    ms, capture seconds and peak memory; with two cards or more, a rank
    raising between gradient replays must end the launch within 60 s.
    B2's launches on the last of those runs are
    the ``pair_bwd_kernel_ring`` row's: on one card a one-rank group's,
    every tile the whole array at offsets 0 and 0; with more cards the
    multi-rank run's, hops on other ranks' rows among them. Beside the
    NCCL child, autoResume
    under shards: two gloo ranks on the CPU under torchrun
    ``--max-restarts 1``, rank 1 failing at step 20 on the first attempt,
    bitwise equal to the straight run at step 40;
40. B2 around the ring in this process: the default scene at P = 8 in
    momentum mode with 64 overlapping pairs placed across tiles (winners
    in other ranks' tiles), and suite config 3's N = 131,072 at P = 8 in
    reference mode: every (rank, hop) against ``raw_backward_reference``
    at 3e-6 (the largest error over the largest value, and each channel
    over its own largest), the i sides summed per rank and the j sides
    summed onto their owners against one single-device B2 over all N;
    B2's device time on a 16,384 x 16,384 ring tile and rank 0's summed
    backward.
41. the sharded graph windows on one card: a one-rank NCCL group in a
    child process runs the CLI on the default scene (200 steps, a frame
    every 10, a checkpoint every 20) and on the 2-D bh million (20 steps,
    a checkpoint every 10) through ``_ShardedGraphWindows``, through
    ``_ShardedWindows`` (``_eager``) and through the single-device graph
    windows: every checkpoint bitwise, every frame byte for byte, B1, B3
    and B5's launches equal, ``Time taken`` and capture seconds of each
    (the communicator made before the runs); a step that reads the host
    makes the sharded runner raise ``GraphCaptureError``.
42. the counterparts of three ``bench/`` runners at small sizes, each
    through its ``main`` in this process (``phase_bench_counterparts``):
    ``bench_grad_step`` (N = 16,384, 2 steps), ``bench_modes`` (N =
    16,384) and ``bench_near_ab`` (N = 65,536, 2-D uniform), their records
    gated as phase 35 gates ``bench``'s, with their launches.
    Each of phases 28-42 prints its seconds.

The line before the last is a JSON object describing each kernel (the
wrapper call's CUDA-event time ``ms``, the kernel's own device time by
the profiler ``device_ms``, its plain version's time, its bound against
the H100's peak FP32 rate or memory rate, one PyTorch call's time where
there is one, and its largest error against its plain version, absolute
and relative to the largest magnitude of its channel); the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or outside
a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import io
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
STEPS = 200
FRAME_EVERY = 10
BWD_GATE = 3e-6     # tests/test_autodiff.py:201, of the largest component
GRAD_GATE = 1e-5    # rollout gradient, kernel path against the oracle path
FORCE_GATE = 3e-7   # B1's force against its plain version, of the largest
DV_GATE_3D = 2e-6   # tests/test_3d.py:76, of the largest component
# Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
# FP32 outside the tensor cores, HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# FP32 flops a pair (rsqrt counted as one), as the kernels' source notes
# count them: B1 and B3 18, B2 29 for each side.
B1_FLOPS_PER_PAIR = 18
B2_FLOPS_PER_PAIR_SIDE = 29
B3_FLOPS_PER_PAIR = 18
# The 3-D forms by the same rule: B1 (and B3) adds dz, dz*dz and its add
# into d2, w*dz and its add into the z sum (18 + 5); B2 adds on each side uz, uz*uz
# and its add, the z product and add of g.u, and the z gradient component
# (mj (tt uz - s gz), four flops) and its add (29 + 10).
B1_FLOPS_PER_PAIR_3D = 23
B2_FLOPS_PER_PAIR_SIDE_3D = 39
B3_FLOPS_PER_PAIR_3D = 23
# names of each kernel's own launches in a profiler trace
B1_TAGS = ("pair_kernel<", "pair_combine")
B2_TAGS = ("pair_bwd_kernel", "pair_bwd_combine")
B3_TAGS = ("near_kernel",)
PACK_TAGS = ("slot_pack",)
ANNULUS_TAGS = ("annulus_kernel",)
# the annulus: float32 ops of a live slot against a shell cell of mass, as
# csrc/annulus_kernel.cu counts them (rsqrt as one, none fused)
ANNULUS_FLOPS = {2: 43, 3: 67}
ANNULUS_GATE = 1e-5   # of the largest force: float32 reordering alone


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def random_state(n, seed, field=1000.0):
    """tests/test_kernels.py's random_state: dense overlaps, slot 7 dead."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-field, field, (n, 2)).astype(np.float32)
    vel = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    mass[7] = 0.0
    radius = rng.uniform(5, 40, n).astype(np.float32)
    return pos, vel, mass, radius


def equivalence_errors(a, b, mode, dv_gate=1e-5):
    """tests/test_kernels.py::assert_equivalent's gates: (errors, passed).
    tests/test_3d.py holds the 3-D dv to 2e-6 (``dv_gate``)."""
    def rel(x, y):
        return float((x - y).abs().max() / max(float(y.abs().max()), 1e-30))

    err = {"force_rel": rel(a.force, b.force)}
    ok = err["force_rel"] < 2e-6
    if mode == "reference":
        for k in ("gained_mass", "gained_radius"):
            x, y = getattr(a, k), getattr(b, k)
            ok &= bool(torch.all((x - y).abs() <= 1e-6 * y.abs()))
        err["died_equal"] = bool(torch.equal(a.died, b.died))
        ok &= err["died_equal"]
    if mode == "momentum":
        err["parent_equal"] = bool(torch.equal(a.parent, b.parent))
        ok &= err["parent_equal"]
    if mode == "elastic":
        err["dv_rel"] = rel(a.dv, b.dv)
        ok &= err["dv_rel"] < dv_gate
    return err, ok


def abs_rel_err(got, want):
    """(largest absolute error, largest relative error): the second is,
    for each channel (the last axis), the channel's largest absolute error
    over its largest magnitude in ``want``, the largest over channels."""
    c = got.shape[-1]
    d = (got - want).abs().reshape(-1, c).amax(0)
    scale = want.abs().reshape(-1, c).amax(0).clamp(min=1e-30)
    return float(d.max()), float((d / scale).max())


def bound_ms(flops=0.0, nbytes=0.0):
    """The least time the card could take: (ms, "operations" or "bytes")."""
    t_ops = flops / PEAK_FP32_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def cuda_launches(fn, tag="pair"):
    """CUDA launches one call of fn makes, by torch.profiler: the runtime's
    launch calls, and the traced kernels whose name holds ``tag`` (CUPTI
    has been seen to drop a long kernel's record after earlier profiles
    in one process, so the launch calls are the count reported)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = prof.key_averages()
    calls = sum(ev.count for ev in evs
                if ev.key.startswith("cudaLaunchKernel"))
    traced = sum(ev.count for ev in evs
                 if ev.device_type == DeviceType.CUDA and tag in ev.key)
    return f"{calls} CUDA launches a call ({traced} traced)"


def tie_state(n, chunk):
    """Body 0 overlapped by equal-mass bodies that beat it, on both sides
    of the partner-split boundaries at ``chunk`` and ``2 * chunk``, the
    rest spread far apart. Returns (arrays, tied ids)."""
    rng = np.random.RandomState(4)
    pos = rng.uniform(-1e6, 1e6, (n, 2)).astype(np.float32)
    vel = np.zeros((n, 2), np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    radius = np.full(n, 1.0, np.float32)
    ties = [c for c in (chunk - 1, chunk, 2 * chunk + 5) if 0 < c < n]
    pos[[0] + ties] = 0.0
    mass[0] = 50.0
    mass[ties] = 500.0
    return (pos, vel, mass, radius), ties


def split_chunk(n, splits):
    """Partners a split walks (csrc/pair_common.cuh's split_chunk)."""
    c = -(-n // splits)
    return -(-c // 32) * 32


def phase_tie_across_splits(dev, n):
    """Momentum ties whose equal-mass candidates lie in different partner
    splits: the lowest id must win, as in the plain version."""
    from nbodyax_torch.physics.kernels import (body_features, decode_raw,
                                               forward_splits,
                                               tile_accumulators_raw,
                                               tile_accumulators_raw_reference)
    splits = forward_splits(n, n, "momentum", dev)
    check(splits > 1, f"momentum at N={n}: the partners are not split")
    arrays, ties = tie_state(n, split_chunk(n, splits))
    pos, vel, mass, radius = (torch.from_numpy(x).to(dev) for x in arrays)
    feats = body_features(pos, vel, mass, radius)
    kw = dict(mode="momentum", eps=0.0, growth_rate=0.1)
    a = decode_raw(*tile_accumulators_raw(feats, feats, 0, 0, **kw), 0,
                   mass, "momentum")
    b = decode_raw(*tile_accumulators_raw_reference(feats, feats, 0, 0,
                                                    **kw), 0, mass,
                   "momentum")
    err, ok = equivalence_errors(a, b, "momentum")
    got = [int(a.parent[0]), int(a.parent[max(ties)])]
    print(f"momentum tie across splits N={n} ({splits} splits, ties at "
          f"{ties}): parents {got}, {json.dumps(err)}")
    check(ok and got == [min(ties)] * 2, f"momentum tie across splits: "
          f"parents {got}, want {min(ties)}; {err}")


def phase_kernel_vs_plain(dev, states, dims=2):
    """B1 against its plain version on ``states`` (the last is the main
    path's scene) in ``dims`` dimensions: all four modes at eps 0 (and
    reference and elastic at eps 25 in 3-D), the force within FORCE_GATE
    of the largest, two calls bitwise equal, ids past 2^30, offset calls
    over split j halves, and in 2-D a momentum tie across splits. Returns
    the largest absolute and relative errors (``abs_rel_err``) of channels
    0-5 on the main path's call."""
    from nbodyax_torch.physics.kernels import (MODES, body_features,
                                               decode_raw,
                                               tile_accumulators_raw,
                                               tile_accumulators_raw_reference)
    from nbodyax_torch.physics.pairwise import combine_accumulators

    errs = None
    label = "kernel" if dims == 2 else "3-D kernel"
    dv_gate = 1e-5 if dims == 2 else DV_GATE_3D
    cases = [(mode, 0.0) for mode in MODES]
    if dims == 3:
        cases += [("reference", 25.0), ("elastic", 25.0)]
    for arrays in states:
        pos, vel, mass, radius = (torch.from_numpy(x).to(dev) for x in arrays)
        n = pos.shape[0]
        feats = body_features(pos, vel, mass, radius)
        alive = mass > 0
        for mode, eps in cases:
            kw = dict(mode=mode, eps=eps, growth_rate=0.1, dim=dims)
            rk, pk = tile_accumulators_raw(feats, feats, 0, 0, **kw)
            rp, pp = tile_accumulators_raw_reference(feats, feats, 0, 0, **kw)
            a = decode_raw(rk, pk, 0, mass, mode, dim=dims)
            b = decode_raw(rp, pp, 0, mass, mode, dim=dims)
            err, ok = equivalence_errors(a, b, mode, dv_gate)
            print(f"{label} vs plain N={n} {mode} eps={eps}: "
                  f"{json.dumps(err)}")
            check(ok, f"{label} disagrees with its plain version at N={n} "
                      f"mode={mode} eps={eps}: {err}")
            check(err["force_rel"] < FORCE_GATE, f"force at N={n} {mode}: "
                  f"{err['force_rel']} of the largest (gate {FORCE_GATE})")
            # two calls, bit for bit (at N = 16,384 the partners are split)
            rk2, pk2 = tile_accumulators_raw(feats, feats, 0, 0, **kw)
            same = torch.equal(rk, rk2) and (
                pk is None or torch.equal(pk, pk2))
            print(f"{label} N={n} {mode} eps={eps}: two calls bitwise "
                  f"equal: {same}")
            check(same, f"{label} N={n} {mode}: two calls differ")
            if mode in ("reference", "momentum") and eps == 0.0:
                # ids past 2^24, where an f32 id would round: shifting
                # every id by one base changes only the parents, by it
                base = (1 << 30) + 3
                rb, pb = tile_accumulators_raw(feats, feats, base, base, **kw)
                kb = decode_raw(rb, pb, base, mass, mode, dim=dims)
                same = (torch.equal(rb, rk)
                        and torch.equal(kb.parent, a.parent + base))
                print(f"{label} N={n} {mode} at ids from {base}: channels "
                      f"and shifted parents exact: {same}")
                check(same, f"{label} N={n} {mode} with large ids differs")
            if arrays is states[-1] and (mode, eps) == ("reference", 0.0):
                # the main path's call: raw channels 0-5 of the live rows
                errs = abs_rel_err(rk[alive, :6], rp[alive, :6])
        # offset calls: an i range against the two j halves, combined,
        # equals the full pass (the building block of split and ring paths)
        i0, i1, half = n // 4, n // 2, n // 2
        for mode in ("momentum", "reference", "elastic"):
            kw = dict(mode=mode, eps=0.0, growth_rate=0.1, dim=dims)
            fi = feats[i0:i1]
            parts = []
            for j0, j1 in ((0, half), (half, n)):
                rk, pk = tile_accumulators_raw(fi, feats[j0:j1], i0, j0, **kw)
                rp, pp = tile_accumulators_raw_reference(
                    fi, feats[j0:j1], i0, j0, **kw)
                ka = decode_raw(rk, pk, i0, mass[i0:i1], mode, dim=dims)
                pa = decode_raw(rp, pp, i0, mass[i0:i1], mode, dim=dims)
                err, ok = equivalence_errors(ka, pa, mode, dv_gate)
                check(ok, f"offset call j[{j0}:{j1}] N={n} {mode}: {err}")
                parts.append(ka)
            combined = combine_accumulators(*parts)
            rf, pf = tile_accumulators_raw(feats, feats, 0, 0, **kw)
            full = decode_raw(rf, pf, 0, mass, mode, dim=dims)
            full = type(full)(*(x[i0:i1] for x in full))
            err, ok = equivalence_errors(combined, full, mode, dv_gate)
            print(f"{label} offset halves vs full N={n} {mode}: "
                  f"{json.dumps(err)}")
            check(ok, f"offset halves disagree with the full pass at N={n} "
                      f"mode={mode}: {err}")
    if dims == 2:
        phase_tie_across_splits(dev, states[-1][0].shape[0])
    return errs


def phase_golden(dev, default_cfg):
    from nbodyax_torch.backends import build_accum_fn
    from nbodyax_torch.config import SimConfig
    from nbodyax_torch.physics.step import PhysicsParams, make_step
    from nbodyax_torch.scenes import init_scene

    with np.load(os.path.join(HERE, "tests", "golden", "ref_n1k.npz")) as z:
        gpos, gvel, gmass, gradius = z["pos"], z["vel"], z["mass"], z["radius"]
    field = 100000
    cfg = SimConfig(particle_count=1024, field_width=field,
                    field_height=field, timestep=0.2, seed=1024)
    state = init_scene(cfg, device=dev)
    check(np.array_equal(state.pos.cpu().numpy(), gpos[0])
          and np.array_equal(state.mass.cpu().numpy(), gmass[0])
          and np.array_equal(state.radius.cpu().numpy(), gradius[0]),
          "ref_n1k record 0: the scene is not bit-exact")
    p = PhysicsParams.from_config(cfg)
    step = make_step(p, accum_fn=build_accum_fn("pallas", p, dev))
    worst = 0.0
    for s in range(1, 201):
        state = step(state)
        mass = state.mass.cpu().numpy()
        check(np.array_equal(mass > 0, gmass[s] > 0),
              f"ref_n1k: alive mask diverged at step {s}")
        check(np.allclose(mass, gmass[s], rtol=1e-6, atol=0),
              f"ref_n1k: mass at step {s}")
        check(np.allclose(state.radius.cpu().numpy(), gradius[s], rtol=1e-6,
                          atol=0), f"ref_n1k: radius at step {s}")
        a2 = (mass > 0)[:, None]
        for name, got, want in (("pos", state.pos, gpos[s]),
                                ("vel", state.vel, gvel[s])):
            d = np.abs(np.where(a2, got.cpu().numpy(), 0)
                       - np.where(a2, want, 0)).max()
            worst = max(worst, d / field)
            check(d <= 2e-4 * field, f"ref_n1k: {name} at step {s}: {d}")
    merges = int((gmass[0] > 0).sum() - (gmass[200] > 0).sum())
    print(f"golden ref_n1k: 200 steps through the kernel pass; {merges} "
          f"merges agree, worst pos/vel error {worst:.3e} of the field "
          f"(gate 2e-4)")

    # the default scene at full size: kernel path against the plain path
    p = PhysicsParams.from_config(default_cfg)
    kstep = make_step(p, accum_fn=build_accum_fn("pallas", p, dev))
    pstep = make_step(p, accum_fn=build_accum_fn("jnp", p, dev))
    a = b = init_scene(default_cfg, device=dev)
    field = float(default_cfg.field_width)
    for s in range(1, 21):
        a, b = kstep(a), pstep(b)
        ma, mb = a.mass.cpu().numpy(), b.mass.cpu().numpy()
        check(np.array_equal(ma > 0, mb > 0),
              f"default scene: kernel and plain alive masks differ at {s}")
        check(np.allclose(ma, mb, rtol=1e-6, atol=0),
              f"default scene: mass at step {s}")
        d = float(torch.where((a.mass > 0)[:, None], a.pos - b.pos, 0.0)
                  .abs().max())
        check(d <= 2e-4 * field, f"default scene: pos at step {s}: {d}")
    print(f"default scene N={default_cfg.particle_count}: 20 steps, kernel "
          f"path == plain path ({int((ma > 0).sum())} alive, pos diff "
          f"{d:.3e})")


TIMING_KEYS = ("wall_ms", "steps_per_sec", "pairs_per_sec",
               "equivalent_pairs_per_sec")


def cli_run(argv, eager=False, keep_frames=True, cfg_text=None,
            workdir=None, image_dir=None):
    """``nbodyax_torch.cli`` in a fresh temp dir (or in ``workdir``, which
    is kept, so a later run there can resume), on ``cfg_text`` written
    there as nbodyConfig.txt (without it the built-in default config, or
    the ``--config`` in ``argv``), its windows through CUDA graphs or, with
    ``eager``, through the driver's eager runner (its private ``_eager``
    switch; the CLI has no flag for it). The frames go to ``frames`` in the
    run's directory, or with ``image_dir`` to the config's own imagePath,
    that directory relative to the run's. Returns a dict: stdout, rc, the
    run's RunResult, B1's launches, the JSON log lines and the frames
    ({name: bytes}, or their sha256 digests without ``keep_frames``)."""
    from nbodyax_torch import cli, driver
    from nbodyax_torch.physics.kernels import tile_accumulators_raw
    results = []

    def run(*a, **k):
        results.append(driver.run_simulation(*a, _eager=eager, **k))
        return results[-1]

    with contextlib.ExitStack() as stack:
        tmp = workdir or stack.enter_context(tempfile.TemporaryDirectory())
        os.makedirs(tmp, exist_ok=True)
        frames_dir = os.path.join(tmp, image_dir or "frames")
        if cfg_text is not None:
            with open(os.path.join(tmp, "nbodyConfig.txt"), "w") as f:
                f.write(cfg_text)
        cwd, saved, buf = os.getcwd(), cli.run_simulation, io.StringIO()
        os.chdir(tmp)
        cli.run_simulation = run
        try:
            tile_accumulators_raw.launches = 0
            with contextlib.redirect_stdout(buf):
                rc = cli.main(argv + ([] if image_dir else
                                      ["--set", f"imagePath={frames_dir}"]))
            launches = tile_accumulators_raw.launches
            frames = read_frames(frames_dir, keep_frames)
        finally:
            cli.run_simulation = saved
            os.chdir(cwd)
    out = buf.getvalue()
    logs = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
    return {"out": out, "rc": rc, "result": results[-1] if results else None,
            "launches": launches, "logs": logs, "frames": frames}


def read_frames(frames_dir, keep=True):
    """{name: bytes} of the frames in ``frames_dir`` (none if it is
    missing), or their sha256 digests without ``keep``."""
    frames = {}
    for name in (os.listdir(frames_dir) if os.path.isdir(frames_dir)
                 else ()):
        with open(os.path.join(frames_dir, name), "rb") as f:
            raw = f.read()
        frames[name] = raw if keep else hashlib.sha256(raw).hexdigest()
    return frames


def same_run(a, b, label):
    """Final state, every log value but the timings, every frame and the
    window count of two runs: bit for bit, or fail."""
    ra, rb = a["result"], b["result"]
    check(ra is not None and rb is not None, f"{label}: a run did not end")
    same = all(torch.equal(x, y) for x, y in zip(ra.state[:4], rb.state[:4]))
    same &= torch.equal(ra.state.sim_time, rb.state.sim_time)
    check(same, f"{label}: final states differ")

    def strip(logs):
        return [{k: v for k, v in rec.items() if k not in TIMING_KEYS}
                for rec in logs]
    check(strip(a["logs"]) == strip(b["logs"]), f"{label}: log values differ")
    check(a["frames"] == b["frames"], f"{label}: frames differ")
    check(ra.windows == rb.windows, f"{label}: window counts differ")
    return (f"state, {len(a['logs'])} log lines and {len(a['frames'])} "
            f"frames bitwise equal")


def phase_main_path(steps=STEPS, integrator="euler", dims=2, sets=()):
    """The CLI on the default config (with ``--set dimensions=3`` when
    ``dims`` is 3), its windows through CUDA graphs: each step must launch
    the forward kernel once a force pass (euler 1, leapfrog 2, yoshida4
    4), counted by replays; in 3-D every log line carries ``momentum_z``.
    Then the same config through the eager runner: final state, logs
    (timings aside) and frames bitwise equal. Returns B1's launches in
    the graph run."""
    passes = {"euler": 1, "leapfrog": 2, "yoshida4": 4}[integrator]
    argv = ["--steps", str(steps), "--set", f"integrator={integrator}",
            "--set", f"dimensions={dims}"]
    for kv in sets:
        argv += ["--set", kv]
    g = cli_run(argv)
    e = cli_run(argv, eager=True)
    out, launches, logs = g["out"], g["launches"], g["logs"]
    check(g["rc"] == 0 and e["rc"] == 0, f"cli exited {g['rc']}, {e['rc']}")
    check(launches == passes * steps,
          f"kernel launched {launches} times in {steps} {integrator} "
          f"steps of graph windows")
    check(e["launches"] == passes * steps,
          f"kernel launched {e['launches']} times in {steps} eager steps")
    taken = time_taken(out)
    check(len(logs) == steps // 10 and logs[-1]["step"] == steps,
          f"expected {steps // 10} log lines, got {len(logs)}")
    last = logs[-1]
    check(all(np.isfinite(v) for v in last.values()
              if isinstance(v, float)), f"non-finite log values: {last}")
    check(0 < last["alive"] <= 16384, f"alive count {last['alive']}")
    if dims == 3:
        check(all("momentum_z" in rec for rec in logs),
              "a 3-D log line without momentum_z")
    want = [f"iteration_{j}.ppm" for j in range(0, steps, FRAME_EVERY)]
    check(sorted(g["frames"]) == sorted(want), f"frames {sorted(g['frames'])}")
    header = b"P5\n1024 1024\n255\n"
    for name in want:
        raw = g["frames"][name]
        check(raw.startswith(header)
              and len(raw) == len(header) + 1024 * 1024,
              f"{name} is not a 1024x1024 P5 frame")
        body = np.frombuffer(raw[len(header):], np.uint8)
        check((body == 0).any() and (body == 254).any(),
              f"{name} has no bodies or no background")
    same = same_run(g, e, f"main path {dims}-D {integrator} {sets}")
    extra = (f", momentum_z {last['momentum_z']:.6g} in every log line"
             if dims == 3 else "")
    label = f"{dims}-D, {integrator}" + (f", {' '.join(sets)}" if sets else "")
    print(f"main path ({label}): {steps} steps in {g['result'].windows} "
          f"graph windows, {len(want)} P5 frames, {launches} kernel launches "
          f"by replays, Time taken: {taken}, {last['alive']} alive{extra}; "
          f"eager runner: {same}")
    print(f"main path rates (device-timed): {last['steps_per_sec']:.6g} "
          f"steps/s, {last['pairs_per_sec']:.6g} pairs/s")
    return launches, g, e


def phase_full_default_run():
    """The reference default workload through the CLI with nothing cut:
    2,000 steps and 200 frames, graph windows and the eager runner in
    turns (graph, eager, eager, graph), each run's ``Time taken``, the
    windows, the peak device memory of the graph runs; final states, logs
    and frames (by digest) bitwise equal. Then one graph run with
    ``--no-images``, which leaves the frames' render and disk writes out."""
    runs = {"graph": [], "eager": []}
    peaks = []
    for kind in ("graph", "eager", "eager", "graph"):
        torch.cuda.reset_peak_memory_stats()
        r = cli_run([], eager=kind == "eager", keep_frames=False)
        check(r["rc"] == 0 and len(r["frames"]) == 200
              and r["logs"][-1]["step"] == 2000,
              f"full default run ({kind}): rc {r['rc']}, "
              f"{len(r['frames'])} frames")
        check(r["launches"] == 2000, f"full default run ({kind}): B1 "
              f"launched {r['launches']} times in 2,000 steps")
        r["taken"] = time_taken(r["out"])
        if kind == "graph":
            peaks.append(torch.cuda.max_memory_allocated())
        runs[kind].append(r)
    same = same_run(runs["graph"][0], runs["eager"][0], "full default run")
    bare = cli_run(["--no-images"])
    check(bare["rc"] == 0 and bare["launches"] == 2000,
          "full default run without frames")
    g = runs["graph"][0]["result"]
    for r in runs["graph"]:
        print(f"full default run, graph windows, Time taken {r['taken']} s: "
              f"host seconds {seconds_text(r['result'])}")
    # a fresh process loads the libraries the smoke's phase 1 built
    load = subprocess.run(
        [sys.executable, "-c", "import time, torch; t = time.perf_counter(); "
         "from nbodyax_torch.physics import _build; _build.load_library(); "
         "print(time.perf_counter() - t)"], cwd=HERE, capture_output=True,
        text=True, check=True).stdout.strip()
    print(f"full default run: kernel load in a fresh process (libraries "
          f"built) {float(load):.4f} s")
    print(f"full default run (N=16384, 2,000 steps, 200 frames): Time taken "
          f"graph {[r['taken'] for r in runs['graph']]} s, eager "
          f"{[r['taken'] for r in runs['eager']]} s (turns graph, eager, "
          f"eager, graph); {g.windows} windows; B1 2,000 launches each; "
          f"peak device memory of the graph runs "
          f"{[round(p / 2 ** 30, 4) for p in peaks]} GiB; graph vs eager: "
          f"{same}; graph without frames: Time taken "
          f"{time_taken(bare['out'])} s in {bare['result'].windows} windows")
    return runs


def time_taken(out):
    """The seconds of a CLI run's ``Time taken:`` line."""
    taken = [l for l in out.splitlines() if l.startswith("Time taken: ")]
    check(len(taken) == 1, "no 'Time taken:' line")
    return float(taken[0].split()[-1])


def phase_golden_graph(dev):
    """``ref_n1k`` through graph windows: the driver's graph runner on the
    pallas backend replays a 10-step graph 20 times, and every window's
    end state passes tests/test_golden.py's gates and equals the eager
    step's bit for bit."""
    from nbodyax_torch.backends import build_accum_fn
    from nbodyax_torch.config import SimConfig
    from nbodyax_torch.driver import _GraphWindows
    from nbodyax_torch.physics.kernels import tile_accumulators_raw
    from nbodyax_torch.physics.step import PhysicsParams, make_step
    from nbodyax_torch.scenes import init_scene

    with np.load(os.path.join(HERE, "tests", "golden", "ref_n1k.npz")) as z:
        gpos, gvel, gmass, gradius = z["pos"], z["vel"], z["mass"], z["radius"]
    field = 100000
    cfg = SimConfig(particle_count=1024, field_width=field,
                    field_height=field, timestep=0.2, seed=1024)
    p = PhysicsParams.from_config(cfg)
    step = make_step(p, accum_fn=build_accum_fn("pallas", p, dev))
    eager = init_scene(cfg, device=dev)
    runner = _GraphWindows(step, eager, cfg, 0, 10, None)
    tile_accumulators_raw.launches = 0
    worst = 0.0
    for w in range(1, 21):
        runner.advance(10, False)
        for _ in range(10):
            eager = step(eager)
        s, st = 10 * w, runner.state
        check(st.step == s and all(torch.equal(x, y) for x, y in
                                   zip(st[:4], eager[:4])),
              f"ref_n1k: graph window state differs from eager at step {s}")
        mass = st.mass.cpu().numpy()
        check(np.array_equal(mass > 0, gmass[s] > 0),
              f"ref_n1k (graph): alive mask diverged at step {s}")
        check(np.allclose(mass, gmass[s], rtol=1e-6, atol=0)
              and np.allclose(st.radius.cpu().numpy(), gradius[s],
                              rtol=1e-6, atol=0),
              f"ref_n1k (graph): mass or radius at step {s}")
        a2 = (mass > 0)[:, None]
        for name, got, want in (("pos", st.pos, gpos[s]),
                                ("vel", st.vel, gvel[s])):
            d = np.abs(np.where(a2, got.cpu().numpy(), 0)
                       - np.where(a2, want, 0)).max()
            worst = max(worst, d / field)
            check(d <= 2e-4 * field, f"ref_n1k (graph): {name} at step {s}")
    launches = tile_accumulators_raw.launches - 200     # the eager steps'
    check(launches == 200, f"ref_n1k graph windows: B1 counted {launches} "
          f"launches by replays in 200 steps")
    print(f"golden ref_n1k through graph windows: 20 replays of a 10-step "
          f"graph, every window end within the gates (worst pos/vel "
          f"{worst:.3e} of the field) and bitwise equal to the eager steps; "
          f"B1 {launches} launches by replays")


def run_pair(cfg, state):
    """``run_simulation`` on ``cfg`` from ``state`` through graph windows
    and through the eager runner; returns both dicts as ``cli_run``'s (no
    stdout)."""
    from nbodyax_torch import driver
    from nbodyax_torch.physics.kernels import tile_accumulators_raw
    out = []
    for eager in (False, True):
        with tempfile.TemporaryDirectory() as tmp:
            c = dataclasses.replace(cfg, image_path=os.path.join(tmp, "f"),
                                    log_path=os.path.join(tmp, "log.jsonl"))
            tile_accumulators_raw.launches = 0
            res = driver.run_simulation(c, device="cuda", quiet=True,
                                        state=state, _eager=eager)
            n = tile_accumulators_raw.launches
            with open(c.log_path) as f:
                logs = [json.loads(l) for l in f]
            frames = read_frames(c.image_path)
        out.append({"result": res, "launches": n, "logs": logs,
                    "frames": frames})
    return out


def phase_modes_graph(dev):
    """The four collision modes under euler, leapfrog and yoshida4 for 50
    steps of the default scene (N = 16,384, a frame every 10), graph
    windows against the eager runner, bitwise; B1 passes x 50 each."""
    from nbodyax_torch.config import SimConfig
    from nbodyax_torch.scenes import init_scene
    scene = init_scene(SimConfig(), device=dev)
    rows = []
    for mode in ("reference", "momentum", "elastic", "none"):
        for integrator, passes in (("euler", 1), ("leapfrog", 2),
                                   ("yoshida4", 4)):
            cfg = SimConfig(total_iterations=50, collision_mode=mode,
                            integrator=integrator)
            g, e = run_pair(cfg, scene)
            label = f"{mode} {integrator}"
            same_run(g, e, label)
            check(g["launches"] == e["launches"] == passes * 50,
                  f"{label}: B1 launched {g['launches']} (graph), "
                  f"{e['launches']} (eager) times in 50 steps")
            rows.append(f"{label} {g['logs'][-1]['alive']}")
    print(f"modes x integrators, 50 steps at N=16384, graph vs eager: state, "
          f"logs and frames bitwise equal, B1 passes x 50 launches; alive "
          f"at the end: {', '.join(rows)}")


def phase_adaptive(dims):
    """``adaptiveDt=1`` on the default scene for 200 steps (the CLI, graph
    windows against the eager runner, bitwise); every log line's dt_mean
    within dt_bounds and sim_time rising."""
    from nbodyax_torch.config import SimConfig
    from nbodyax_torch.physics.step import PhysicsParams
    _, g, _ = phase_main_path(dims=dims, sets=("adaptiveDt=1",))
    lo, hi = PhysicsParams.from_config(SimConfig(adaptive_dt=True)).dt_bounds
    t = 0.0
    for rec in g["logs"]:
        check(lo * (1 - 1e-5) <= rec["dt_mean"] <= hi * (1 + 1e-5)
              and rec["sim_time"] > t,
              f"adaptive {dims}-D: dt_mean {rec['dt_mean']} at step "
              f"{rec['step']} outside [{lo}, {hi}]")
        t = rec["sim_time"]
    dts = [r["dt_mean"] for r in g["logs"]]
    print(f"adaptive dt {dims}-D: dt_mean {min(dts):.6g}-{max(dts):.6g} "
          f"within [{lo:.6g}, {hi:.6g}], sim_time {t:.6g} after 200 steps")


def phase_energy(dev):
    """``energyEvery=50`` through graph windows on the default scene for
    100 steps: the logged potential at step 100 against the CPU's
    ``potential_energy`` of the same final state, rtol 1e-5."""
    from nbodyax_torch.metrics import potential_energy
    g = cli_run(["--steps", "100", "--no-images", "--set", "energyEvery=50"])
    check(g["rc"] == 0, f"energy run exited {g['rc']}")
    recs = {r["step"]: r for r in g["logs"]}
    check(all(("potential_energy" in recs[s]) == (s % 50 == 0)
              for s in recs), "potential_energy off its cadence")
    st = g["result"].state
    cpu = type(st)(*(t.cpu() for t in st[:4]), st.step, st.sim_time.cpu())
    want = float(potential_energy(cpu))
    got = recs[100]["potential_energy"]
    rel = abs(got - want) / abs(want)
    check(rel <= 1e-5, f"potential_energy on the card {got} vs CPU {want}")
    print(f"energy: potential_energy at step 100 {got:.9g} on the card, "
          f"{want:.9g} on the CPU (rel {rel:.3e}, gate 1e-5); total_energy "
          f"{recs[100]['total_energy']:.9g}")


def phase_profile_flag():
    """The CLI's ``--profile DIR`` over 50 steps of graph windows (no
    frames): the trace's kernel events hold B1's 50 replayed launches (and
    the capture's warm-up step); the device's busy share of the span the
    traced kernels cover."""
    with tempfile.TemporaryDirectory() as tmp:
        r = cli_run(["--steps", "50", "--no-images", "--profile", tmp])
        check(r["rc"] == 0, f"--profile run exited {r['rc']}")
        with open(os.path.join(tmp, "trace.json")) as f:
            events = json.load(f)["traceEvents"]
    kern = sorted((e for e in events if e.get("cat") == "kernel"),
                  key=lambda e: e["ts"])
    b1 = [e for e in kern if "pair_kernel<" in e.get("name", "")]
    check(len(b1) >= 50, f"--profile traced {len(b1)} B1 kernels in 50 "
          f"steps")
    # windows 2-5: from the B1 launch that opens window 2 (after the
    # capture's warm-up step and window 1) to the last kernel
    t0 = b1[-40]["ts"]
    late = [e for e in kern if e["ts"] >= t0]
    busy = sum(e["dur"] for e in late)
    span = max(e["ts"] + e["dur"] for e in late) - t0
    print(f"--profile, 50 steps of graph windows: {len(kern)} kernel events, "
          f"{len(b1)} of B1 (the capture's warm-up step included); windows "
          f"2-5: device busy {busy / 1e3:.4f} ms of {span / 1e3:.4f} ms "
          f"({100 * (1 - busy / span):.1f}% idle, log lines and fences "
          f"between windows included)")


def phase_graph_profile(dev, cfg, label):
    """torch.profiler over 5 replays of the 10-step graph window (no frame)
    on ``cfg``'s scene, captured beforehand: device time a step, device
    idle share and heaviest kernels; CUDA events over 20 replays without
    the profiler, the idle share inside a window from them; the peak
    device memory of the window (state, warm-up and the graph's private
    pool)."""
    from nbodyax_torch.backends import build_accum_fn
    from nbodyax_torch.driver import _GraphWindows
    from nbodyax_torch.physics.step import PhysicsParams, make_step
    from nbodyax_torch.scenes import init_scene
    p = PhysicsParams.from_config(cfg)
    step = make_step(p, accum_fn=build_accum_fn("pallas", p, dev))
    state = init_scene(cfg, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    runner = _GraphWindows(step, state, cfg, 0, 10, None)
    ms = profile_breakdown(lambda: runner.advance(10, False), 5,
                           f"{label}, a 10-step graph window")
    peak = torch.cuda.max_memory_allocated()
    # without the profiler: CUDA events around 20 back-to-back replays
    ev = time_ms(lambda: runner.advance(10, False), reps=20)
    print(f"graph windows, {label}: {ms / 10:.4f} ms of device time a step; "
          f"{ev / 10:.4f} ms a step by CUDA events over 20 replays without "
          f"the profiler, so the device idles {100 * (1 - ms / ev):.1f}% "
          f"inside a window; peak device memory {peak / 2 ** 30:.4f} GiB "
          f"({(peak - base) / 2 ** 20:.1f} MiB above the scene)")
    return ms / 10


def time_ms(fn, reps=20, warm=2):
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, tags, reps=20):
    """The kernels' own device time a call of fn, by torch.profiler: for
    each traced kernel whose name holds one of ``tags``, its mean duration
    a launch, summed over those kernels (each launches once a call: a pass
    and its combine, or B5's two). A mean a launch keeps the figure right
    if CUPTI drops a record; a trace without any of the kernels' records is
    taken again, three times at most. Returns (ms, "name: us, ..." text)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    per = {}
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        for ev in prof.key_averages():
            d = getattr(ev, "self_device_time_total",
                        getattr(ev, "self_cuda_time_total", 0))
            if (ev.device_type == DeviceType.CUDA and ev.count
                    and any(t in ev.key for t in tags)):
                name = ev.key.replace("(anonymous namespace)::", "").replace(
                    "void ", "", 1).split("(")[0]
                per[name] = per.get(name, 0.0) + d / ev.count
        if per:
            break
    check(per, f"the profiler traced no kernel named {tags}")
    ms = sum(per.values()) / 1e3
    return ms, ", ".join(f"{k} {v:.2f} us" for k, v in sorted(per.items()))


def profile_breakdown(fn, reps, label, top=12, detail=False):
    """torch.profiler over ``reps`` calls of fn: device time and device ops
    a call, the window's host wall, the device's idle share and the
    heaviest kernels. Returns device ms a call, with ``detail`` (device ms,
    device ops, host wall ms) a call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        win = (time.perf_counter() - t0) * 1e6
    rows = []
    for ev in prof.key_averages():
        d = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0))
        if d > 0 and ev.device_type == DeviceType.CUDA:   # kernels only
            rows.append((d, ev.key, ev.count))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    print(f"profiler, {label}: {total / reps / 1e3:.4f} ms device time a "
          f"call in {sum(r[2] for r in rows) // reps} device ops, window "
          f"{win / reps / 1e3:.4f} ms a call, device idle "
          f"{100 * (1 - total / win):.1f}%")
    for d, key, cnt in rows[:top]:
        print(f"  {d / reps / 1e3:9.4f} ms/call  {100 * d / total:5.1f}%  "
              f"x{cnt // reps:<4d} {key[:90]}")
    if detail:
        busy, span = kernel_timeline(prof)
        print(f"profiler, {label}, one timeline: kernels busy {busy:.4f} ms "
              f"of the {span:.4f} ms from the first kernel's start to the "
              f"last one's end, idle {100 * (1 - busy / span):.2f}%")
        return (total / reps / 1e3, sum(r[2] for r in rows) / reps,
                win / reps / 1e3, busy, span)
    return total / reps / 1e3


def kernel_timeline(prof):
    """The traced kernels on the device's own timeline: the union of their
    intervals (kernels that overlap count once) and the span from the
    first kernel's start to the last one's end, both in ms."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    iv = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                for e in events if e.get("cat") == "kernel")
    check(iv, "the profiler traced no kernel")
    busy, end = 0.0, iv[0][0]
    for a, b in iv:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3, (end - iv[0][0]) / 1e3


def scene_features(dev, n):
    """The default config's uniform scene at N = n, as body features."""
    from nbodyax_torch.config import SimConfig
    from nbodyax_torch.physics.kernels import body_features
    from nbodyax_torch.rng import scene_arrays
    cfg = SimConfig()
    arrays = scene_arrays(cfg.seed, n, cfg.field_width, cfg.field_height,
                          cfg.min_body_mass, cfg.max_body_mass,
                          cfg.min_radius, cfg.max_radius)
    return body_features(*(torch.from_numpy(x).to(dev) for x in arrays))


def b1_bound(n):
    """B1's bound for n rows against n partners: 18 flops a pair; each
    input row read once and each output row written once (32 B each)."""
    return bound_ms(n * n * B1_FLOPS_PER_PAIR, 3 * n * 32)


def clocks_under(fn, seconds=2.0, ms=1.0):
    """The SM clock (MHz) and power draw (W) that nvidia-smi samples every
    100 ms while fn, which takes about ``ms``, runs for ``seconds``: their
    medians and the clock's range, as text."""
    proc = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        for _ in range(max(1, int(seconds * 1e3 / ms))):
            fn()
        torch.cuda.synchronize()
    finally:
        proc.terminate()
        out, _ = proc.communicate(timeout=30)
    rows = []
    for line in out.splitlines():
        try:
            rows.append(tuple(float(v) for v in line.split(",")))
        except ValueError:
            continue
    if not rows:
        return "SM clock not read"
    clk, watt = (sorted(c) for c in zip(*rows))
    return (f"SM clock median {clk[len(clk) // 2]:.0f} MHz "
            f"({clk[0]:.0f}-{clk[-1]:.0f}) and power "
            f"{watt[len(watt) // 2]:.1f} W over {len(rows)} samples")


def report_device(name, n, fn, tags, event_ms, bound, reps=20):
    """Print a kernel's own device time (profiler) beside the CUDA-event
    time of its wrapper call, and its share of the bound by device time.
    Returns the device time in ms."""
    dms, detail = device_ms(fn, tags, reps)
    print(f"{name} N={n}: device time {dms:.4f} ms a call by the profiler "
          f"({detail}); wrapper call {event_ms:.4f} ms by CUDA events; "
          f"bound {bound[0]:.4f} ms ({bound[1]}), {100 * bound[0] / dms:.1f}%"
          f" of the bound by device time")
    return dms


def cold_share(fn):
    """One call of ``fn``'s B1 warp sub-tiles that took the kernel's cold
    path (the mode bookkeeping), of those it walked, as text."""
    from nbodyax_torch.physics.kernels import cold_counts, reset_cold_counts
    dev = torch.device("cuda", torch.cuda.current_device())
    reset_cold_counts(dev)
    fn()
    cold, walked = cold_counts(dev)
    return (f"cold path {cold} of {walked} warp sub-tiles "
            f"({100 * cold / max(walked, 1):.4f}%)")


def report_split_call(name, n, ms, splits, launches, bound, fn=None):
    print(f"{name} N={n}: {ms:.4f} ms, splits {splits}, {launches}, "
          f"{n * n / (ms / 1e3):.6g} pairs/s, bound "
          f"{bound[0]:.4f} ms ({bound[1]}), {100 * bound[0] / ms:.1f}% of "
          f"the bound" + (f", {cold_share(fn)}" if fn else ""))


def phase_timing(dev, default_scene, default_cfg):
    """B1 against its plain version at N = 16,384 (turns plain, kernel,
    kernel, plain), B1 alone at N = 131,072, and the profile of one forward
    step of the default scene. Returns (kernel ms, plain ms, bound)."""
    from nbodyax_torch.backends import build_accum_fn
    from nbodyax_torch.physics.kernels import (body_features,
                                               forward_splits,
                                               tile_accumulators_raw,
                                               tile_accumulators_raw_reference)
    from nbodyax_torch.physics.step import PhysicsParams, make_step
    from nbodyax_torch.scenes import init_scene
    feats = body_features(*(torch.from_numpy(x).to(dev)
                            for x in default_scene))
    kw = dict(mode="reference", eps=0.0, growth_rate=0.1)
    fns = {"plain": lambda: tile_accumulators_raw_reference(feats, feats, 0,
                                                            0, **kw),
           "kernel": lambda: tile_accumulators_raw(feats, feats, 0, 0, **kw)}
    times = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        times[name].append(time_ms(fns[name]))
    n = feats.shape[0]
    for name, ts in times.items():
        print(f"{name} N={n} reference mode: {ts} ms "
              f"({n * n / (np.mean(ts) / 1e3):.6g} pairs/s)")
    ms = float(np.mean(times["kernel"]))
    bound = b1_bound(n)
    report_split_call("B1", n, ms, forward_splits(n, n, "reference", dev),
                      cuda_launches(fns["kernel"]), bound, fns["kernel"])
    print(f"B1 N={n}: {clocks_under(fns['kernel'], ms=ms)}")
    dms = report_device("B1", n, fns["kernel"], B1_TAGS, ms, bound)
    big = scene_features(dev, 131072)
    nb = big.shape[0]

    def call():
        return tile_accumulators_raw(big, big, 0, 0, **kw)
    report_split_call("B1 alone", nb, time_ms(call, reps=5),
                      forward_splits(nb, nb, "reference", dev),
                      cuda_launches(call), b1_bound(nb), call)
    p = PhysicsParams.from_config(default_cfg)
    step = make_step(p, accum_fn=build_accum_fn("pallas", p, dev))
    state = init_scene(default_cfg, device=dev)
    profile_breakdown(lambda: step(state), 50,
                      f"default scene step N={n} (no frame)")
    return ms, dms, float(np.mean(times["plain"])), bound


def bwd_errors(got, want):
    """Largest error of each output over its own largest component."""
    return [float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))
            for a, b in zip(got, want)]


def cotangent(n, dev):
    g = np.random.RandomState(n).standard_normal((n, 8)).astype(np.float32)
    return torch.from_numpy(g).to(dev)


def phase_bwd_vs_plain(dev, states, dims=2):
    """B2 against its plain version on ``states`` (the last is the main
    path's scene) in ``dims`` dimensions. Returns the largest absolute and
    relative errors (``abs_rel_err``, both operands' gradients) on the main
    path's scene in reference mode."""
    from nbodyax_torch.physics.kernels import (MODES, body_features,
                                               tile_accumulators_raw)
    from nbodyax_torch.physics.kernels_bwd import (raw_backward,
                                                   raw_backward_reference)

    def both(fi, fj, i0, j0, gi, kw):
        _, par = tile_accumulators_raw(fi, fj, i0, j0, **kw)
        return (raw_backward(fi, fj, i0, j0, par, gi, **kw),
                raw_backward_reference(fi, fj, i0, j0, par, gi, **kw))

    errs = None
    cases = [(mode, 0.0) for mode in MODES] + [("elastic", 5.0)]
    label = "backward kernel" + (" (3-D)" if dims == 3 else "")
    for arrays in states:
        pos, vel, mass, radius = (torch.from_numpy(x).to(dev) for x in arrays)
        n = pos.shape[0]
        feats = body_features(pos, vel, mass, radius)
        g = cotangent(n, dev)
        for mode, eps in cases:
            kw = dict(mode=mode, eps=eps, growth_rate=0.1, dim=dims)
            got, want = both(feats, feats, 0, 0, g, kw)
            err = bwd_errors(got, want)
            print(f"{label} vs plain N={n} {mode} eps={eps}: "
                  f"d_feats_i {err[0]:.3e}, d_feats_j {err[1]:.3e}")
            check(all(bool(torch.isfinite(x).all()) for x in got),
                  f"backward kernel: non-finite gradient N={n} {mode}")
            check(max(err) < BWD_GATE, f"backward kernel disagrees with its "
                  f"plain version at N={n} mode={mode} eps={eps}: {err}")
            # two calls, bit for bit (at N = 16,384 the partners are split)
            again, _ = both(feats, feats, 0, 0, g, kw)
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            print(f"{label} N={n} {mode} eps={eps}: two calls "
                  f"bitwise equal: {same}")
            check(same, f"{label} N={n} {mode}: calls differ")
            if arrays is states[-1] and (mode, eps) == ("reference", 0.0):
                errs = abs_rel_err(torch.cat(got), torch.cat(want))
        # an i range against the two j halves: each call matches the plain
        # version, and the halves' d_feats_i sum to the full call's
        i0, i1, half = n // 4, n // 2, n // 2
        for mode in ("reference", "momentum"):
            kw = dict(mode=mode, eps=0.0, growth_rate=0.1, dim=dims)
            fi, gi = feats[i0:i1], g[i0:i1]
            d_fi = 0
            for j0, j1 in ((0, half), (half, n)):
                got, want = both(fi, feats[j0:j1], i0, j0, gi, kw)
                err = bwd_errors(got, want)
                check(max(err) < BWD_GATE,
                      f"backward offset call j[{j0}:{j1}] N={n} {mode}: {err}")
                d_fi = d_fi + got[0]
            full, _ = both(fi, feats, i0, 0, gi, kw)
            err = bwd_errors((d_fi,), (full[0],))[0]
            print(f"{label} offset halves vs full N={n} {mode}: "
                  f"{err:.3e}")
            check(err < BWD_GATE, f"backward halves disagree with the full "
                  f"call at N={n} mode={mode}: {err}")
    return errs


def grad_config(integrator, dims=2):
    """bench/grad_step.py's settings on the default scene."""
    from nbodyax_torch.config import SimConfig
    return SimConfig(collision_mode="reference", softening=100.0,
                     integrator=integrator, save_images=False,
                     dimensions=dims)


def terminal_loss(s):
    """bench/grad_step.py's terminal loss: the mean squared distance of the
    alive bodies to the origin."""
    w = (s.mass > 0).to(torch.float32)
    return (w * (s.pos * s.pos).sum(-1)).sum() / w.sum()


def rollout_grads(state, cfg, backend, steps):
    """d loss / d (initial pos, initial mass) of a remat'd rollout."""
    from nbodyax_torch.autodiff import make_loss
    from nbodyax_torch.backends import build_accum_fn
    from nbodyax_torch.physics.step import PhysicsParams, make_step

    p = PhysicsParams.from_config(cfg)
    step = make_step(p, accum_fn=build_accum_fn(backend, p,
                                                state.pos.device))
    pos = state.pos.detach().clone().requires_grad_(True)
    mass = state.mass.detach().clone().requires_grad_(True)
    loss = make_loss(step, steps, terminal_loss)(
        state._replace(pos=pos, mass=mass))
    return torch.autograd.grad(loss, (pos, mass))


def phase_grad_path(state, runs=(("euler", 4, 1), ("leapfrog", 2, 2))):
    """The differentiable path at full width, through the kernels and
    through autograd of the torch oracle, for each (integrator, steps,
    force passes a step) of ``runs``, in the state's dimensions. Returns
    the backward kernel's launch count in the euler run."""
    from nbodyax_torch.physics.kernels import tile_accumulators_raw
    from nbodyax_torch.physics.kernels_bwd import raw_backward

    b2_launches = None
    dims = state.pos.shape[-1]
    for integrator, steps, passes in runs:
        cfg = grad_config(integrator, dims)
        tile_accumulators_raw.launches = 0
        raw_backward.launches = 0
        gk = rollout_grads(state, cfg, "pallas", steps)
        torch.cuda.synchronize()
        b1, b2 = tile_accumulators_raw.launches, raw_backward.launches
        # forward: each pass once, and again when its checkpointed step is
        # re-run. backward: two launches (side i, side j) for each pass the
        # loss depends on; the last leapfrog step's second pass only kicks
        # the final velocity, which the terminal loss does not read, so
        # autograd never calls its backward
        want_b1 = 2 * steps * passes
        want_b2 = 2 * (steps * passes - (passes - 1))
        check(b1 == want_b1 and b2 == want_b2,
              f"{integrator} rollout gradient: {b1} forward and {b2} "
              f"backward launches, expected {want_b1} and {want_b2}")
        go = rollout_grads(state, cfg, "jnp", steps)
        for name, g in zip(("pos", "mass"), gk):
            check(bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0,
                  f"{integrator} rollout gradient w.r.t. {name}: zero or "
                  f"non-finite")
        errs = bwd_errors(gk, go)
        print(f"rollout gradient {dims}-D N={state.capacity}, {steps} "
              f"{integrator} steps, kernels vs oracle autograd: pos "
              f"{errs[0]:.3e}, mass "
              f"{errs[1]:.3e} of the largest component (gate {GRAD_GATE}); "
              f"{b1} forward, {b2} backward launches")
        check(max(errs) < GRAD_GATE, f"{integrator} rollout gradient: "
              f"kernel path and oracle path differ by {errs}")
        if integrator == "euler":
            b2_launches = b2
    return b2_launches


def phase_shooting(dev):
    """tests/test_autodiff.py's shooting descent, through the kernels."""
    from nbodyax_torch.autodiff import rollout
    from nbodyax_torch.backends import build_accum_fn
    from nbodyax_torch.config import SimConfig
    from nbodyax_torch.physics.kernels_bwd import raw_backward
    from nbodyax_torch.physics.step import PhysicsParams, make_step
    from nbodyax_torch.state import make_state

    n, scale = 16, 100.0
    rng = np.random.RandomState(5)
    pos = rng.uniform(-scale, scale, (n, 2)).astype(np.float32)
    vel = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    mass = rng.uniform(0.5e12, 2e12, n).astype(np.float32)
    radius = rng.uniform(0.5, 2.0, n).astype(np.float32)
    base = make_state(pos, vel, mass, radius, device=dev)
    cfg = SimConfig(particle_count=n, collision_mode="none", softening=5.0,
                    field_width=10_000, field_height=10_000)
    p = PhysicsParams.from_config(cfg)
    step = make_step(p, accum_fn=build_accum_fn("pallas", p, dev))
    target = torch.tensor([80.0, -40.0], device=dev)

    def value_and_grad(v0):
        v0 = v0.detach().requires_grad_(True)
        final, _ = rollout(step, base._replace(
            vel=torch.cat([v0[None], base.vel[1:]])), 5)
        val = (((final.pos[0] - target) / scale) ** 2).sum()
        return float(val.detach()), torch.autograd.grad(val, v0)[0]

    before = raw_backward.launches
    v0 = base.vel[0].clone()
    val, g = value_and_grad(v0)
    history = [val]
    for _ in range(8):
        v0 = v0 - 2e3 * g
        val, g = value_and_grad(v0)
        history.append(val)
    print(f"shooting descent through the kernels: miss^2 {history[0]:.6g} "
          f"-> {history[-1]:.6g} in 8 steps "
          f"({raw_backward.launches - before} backward launches)")
    check(raw_backward.launches > before, "shooting: no backward launch")
    check(history[-1] < 0.01 * history[0], f"shooting: {history}")


def b2_bound(n):
    """B2's bound for n i bodies against n j bodies, both sides: 29 flops
    a pair and side; features and cotangent read once, both gradients
    written once (32 B a row each)."""
    return bound_ms(2 * n * n * B2_FLOPS_PER_PAIR_SIDE, 5 * n * 32)


def phase_bwd_timing(dev, default_scene):
    """B2 against its plain version at N = 16,384 (turns plain, kernel,
    kernel, plain) and B2 alone at N = 131,072. Returns (kernel ms, plain
    ms, bound)."""
    from nbodyax_torch.physics.kernels import body_features
    from nbodyax_torch.physics.kernels_bwd import (backward_splits,
                                                   raw_backward,
                                                   raw_backward_reference)
    feats = body_features(*(torch.from_numpy(x).to(dev)
                            for x in default_scene))
    n = feats.shape[0]
    g = cotangent(n, dev)
    kw = dict(mode="reference", eps=0.0, growth_rate=0.1)
    fns = {"plain": lambda: raw_backward_reference(feats, feats, 0, 0, None,
                                                   g, **kw),
           "kernel": lambda: raw_backward(feats, feats, 0, 0, None, g, **kw)}
    times = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        times[name].append(time_ms(fns[name], reps=10))
    for name, ts in times.items():
        print(f"backward {name} N={n} reference mode, both sides: {ts} ms")
    ms = float(np.mean(times["kernel"]))
    bound = b2_bound(n)
    report_split_call("B2 (both sides)", n, ms,
                      backward_splits(n, n, "reference", dev),
                      cuda_launches(fns["kernel"]), bound)
    print(f"B2 N={n}: {clocks_under(fns['kernel'], ms=ms)}")
    dms = report_device("B2 (both sides)", n, fns["kernel"], B2_TAGS, ms,
                        bound, reps=10)
    big = scene_features(dev, 131072)
    nb = big.shape[0]
    gb = cotangent(nb, dev)

    def call():
        return raw_backward(big, big, 0, 0, None, gb, **kw)
    report_split_call("B2 alone (both sides)", nb, time_ms(call, reps=3),
                      backward_splits(nb, nb, "reference", dev),
                      cuda_launches(call), b2_bound(nb))
    return ms, dms, float(np.mean(times["plain"])), bound


def counted(fn):
    """fn's result, cloned off any static output, and the (B1, B2) launch
    counts it added."""
    from nbodyax_torch.physics.kernels import tile_accumulators_raw
    from nbodyax_torch.physics.kernels_bwd import raw_backward
    tile_accumulators_raw.launches = raw_backward.launches = 0
    value, grads = fn()
    out = value.clone(), [g.clone() for g in grads]
    torch.cuda.synchronize()
    return out, (tile_accumulators_raw.launches, raw_backward.launches)


def phase_grad_graph(state, runs=(("euler", 4, 1), ("leapfrog", 2, 2)),
                     modes=("reference", "momentum", "elastic")):
    """10. The gradient as one CUDA-graph replay
    (``autodiff.graphed_value_and_grad``): phase 7's rollouts of the
    default scene in each collision mode, d/d(pos, vel, mass). The eager
    gradient twice (does it repeat bit for bit?), the graph's first call
    (warm-up, capture, replay) and a second replay: the graph must repeat
    the eager gradient bit for bit where the eager one repeats, else lie
    within GRAD_GATE of it; both within GRAD_GATE of the oracle path
    (autograd of the torch oracle), but momentum mode's mass gradient,
    which float32 rounding swamps on this scene in every engine (phase 39,
    ``sharded_gradients``), and which the graph-against-eager check holds;
    B1's and B2's launches by a replay equal to the eager call's and to
    phase 7's count."""
    from nbodyax_torch.autodiff import graphed_value_and_grad, make_loss
    from nbodyax_torch.backends import build_accum_fn
    from nbodyax_torch.physics.step import PhysicsParams, make_step

    for (integrator, steps, passes), mode in itertools.product(runs, modes):
        cfg = dataclasses.replace(grad_config(integrator),
                                  collision_mode=mode)
        p = PhysicsParams.from_config(cfg)

        def loss(backend):
            return make_loss(make_step(p, accum_fn=build_accum_fn(
                backend, p, state.pos.device)), steps, terminal_loss)
        with graphed_value_and_grad(loss("pallas")) as vg:
            e1, n_eager = counted(lambda: vg.eager(state))
            e2, _ = counted(lambda: vg.eager(state))
            g1, n_first = counted(lambda: vg(state))
            g2, n_graph = counted(lambda: vg(state))
            capture = vg.capture_seconds
        oracle = graphed_value_and_grad(loss("jnp")).eager(state)[1]
        repeats = all(torch.equal(a, b) for a, b in zip(e1[1], e2[1]))
        bitwise = (torch.equal(g1[0], e1[0]) and all(
            torch.equal(a, b) for a, b in zip(g1[1], e1[1])))
        replays = all(torch.equal(a, b) for a, b in zip(g1[1], g2[1]))
        vs_eager = bwd_errors(g1[1], e1[1])
        vs_oracle = bwd_errors(g1[1], oracle)
        want = (2 * steps * passes, 2 * (steps * passes - (passes - 1)))
        print(f"gradient graph, default scene N={state.capacity}, {steps} "
              f"{integrator} steps, {mode}: capture {capture:.3f} s; eager "
              f"repeats bitwise {repeats}; graph bitwise eager {bitwise} "
              f"(d/d(pos, vel, mass) "
              f"{', '.join(f'{e:.3e}' for e in vs_eager)} of the largest), "
              f"replays repeat {replays}; against the oracle path "
              f"{', '.join(f'{e:.3e}' for e in vs_oracle)} (gate "
              f"{GRAD_GATE}); B1, B2 launches eager {n_eager}, first call "
              f"{n_first}, replay {n_graph} (expected {want})")
        gated = vs_oracle[:2] if mode == "momentum" else vs_oracle
        check((bitwise if repeats else max(vs_eager) < GRAD_GATE)
              and replays and max(gated) < GRAD_GATE,
              f"{integrator} {mode} gradient graph: off the eager gradient "
              f"or the oracle path")
        check(n_eager == n_first == n_graph == want,
              f"{integrator} {mode} gradient graph: launches {n_eager}, "
              f"{n_first}, {n_graph}, expected {want}")


def peak_of(fn):
    """fn's result and the peak device memory allocated while it ran."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated()


def phase_grad_over_forward(state):
    """bench/grad_step.py's grad_over_forward: one gradient of a 4-step
    euler rollout of the default scene through the kernels, graphed and
    eager in turns (graph, eager, eager, graph), against one forward step
    the same way (a CUDA-graph replay, and eagerly):
    ms a call and a rollout step, capture seconds and peak device memory
    of each; the profile of one gradient call each way (device time, ops,
    idle share); the eager call beside the parent's two eager forms (its
    checkpoints preserving the generator state, and its ``rollout_grads``
    timing), in turns. Then one graphed gradient at suite config 3's N =
    131,072 (capture seconds, peak memory, ms a call, one eager call
    beside it)."""
    from torch.utils.checkpoint import checkpoint

    from nbodyax_torch.autodiff import graphed_value_and_grad, make_loss
    from nbodyax_torch.backends import build_accum_fn
    from nbodyax_torch.graphs import capture
    from nbodyax_torch.physics.step import PhysicsParams, make_step

    cfg, steps = grad_config("euler"), 4
    p = PhysicsParams.from_config(cfg)
    step = make_step(p, accum_fn=build_accum_fn("pallas", p,
                                                state.pos.device))
    fwd_ms = {"eager": time_ms(lambda: step(state), reps=20)}
    # the forward step as one CUDA-graph replay, the graphed gradient's
    # counterpart (bench/grad_step.py jits both)
    with torch.no_grad():
        fwd_graph, _, _ = capture(lambda _: step(state), lambda: step(state),
                                  "the forward step")
    fwd_ms["graph"] = time_ms(fwd_graph.replay, reps=20)
    del fwd_graph
    loss = make_loss(step, steps, terminal_loss)
    label = f"{steps}-step euler rollout N={state.capacity}"
    with graphed_value_and_grad(loss, wrt=("pos", "mass")) as vg:
        _, eager_peak = peak_of(lambda: vg.eager(state))
        _, graph_peak = peak_of(lambda: vg(state))
        times = {"graph": [], "eager": []}
        for way in ("graph", "eager", "eager", "graph"):
            fn = vg if way == "graph" else vg.eager
            times[way].append(time_ms(lambda: fn(state), reps=5))
        peaks = {"graph": graph_peak, "eager": eager_peak}
        for way, ts in times.items():
            ms = float(np.mean(ts))
            print(f"gradient {way} ({label}, remat): {ts} ms a call, "
                  f"{ms / steps:.4f} ms a rollout step; forward step {way} "
                  f"{fwd_ms[way]:.4f} ms; grad_over_forward "
                  f"{ms / steps / fwd_ms[way]:.4f}; peak memory "
                  f"{peaks[way] / 2**20:.1f} MiB"
                  + (f"; capture {vg.capture_seconds:.3f} s"
                     if way == "graph" else ""))
        for way, fn in (("graph", vg), ("eager", vg.eager)):
            profile_breakdown(lambda: fn(state), 3,
                              f"gradient {way}, {label}", detail=True)

    # the eager baseline against the parent's forms: its rollout saved and
    # restored the card's generator state at each checkpoint
    # (preserve_rng_state=True, which a capture refuses), and its phase 10
    # timed rollout_grads, which builds the step on every call
    def parent_loss(s):
        for _ in range(steps):
            s = checkpoint(step, s, use_reentrant=False)
        return terminal_loss(s)
    forms = {"eager": graphed_value_and_grad(loss, wrt=("pos", "mass")).eager,
             "eager, preserve_rng_state=True": graphed_value_and_grad(
                 parent_loss, wrt=("pos", "mass")).eager,
             "rollout_grads (builds the step each call)":
                 lambda s: rollout_grads(s, cfg, "pallas", steps)}
    times = {k: [] for k in forms}
    for k in (*forms, *reversed(forms)):
        times[k].append(time_ms(lambda: forms[k](state), reps=5))
    print(f"gradient eager forms ({label}, ms a call, in turns there and "
          f"back): " + "; ".join(f"{k} {v}" for k, v in times.items()))

    big, _ = exact_scene(state.pos.device, particle_count=131072)
    step_big = make_step(p, accum_fn=build_accum_fn("pallas", p,
                                                    big.pos.device))
    with graphed_value_and_grad(make_loss(step_big, steps, terminal_loss),
                                wrt=("pos", "mass")) as vg:
        _, peak = peak_of(lambda: vg(big))
        ms = time_ms(lambda: vg(big), reps=3, warm=1)
        eager_ms = time_ms(lambda: vg.eager(big), reps=1, warm=1)
        print(f"gradient graph, {steps}-step euler rollout of suite config "
              f"3's scene N={big.capacity}: {ms:.3f} ms a call "
              f"({ms / steps:.3f} a rollout step), eager {eager_ms:.3f} ms; "
              f"capture "
              f"{vg.capture_seconds:.3f} s; peak memory {peak / 2**20:.1f} "
              f"MiB")


# ---------------------------------------------------------------------------
# forceModel=bh: the slot-pack kernels B4/B5 and the near-field kernel B3
# ---------------------------------------------------------------------------

NEAR_GATE = 2e-5    # tests/test_barneshut.py:385, of the channel's largest
MOM_GATE = 2e-6     # tests/test_barneshut.py:803, of max(channel scale, 1)


def million_config(**over):
    """examples/million_bodies.txt's scene with forceModel=bh, default bh
    knobs, cut to 20 steps without compaction or checkpoints."""
    from nbodyax_torch.config import SimConfig
    kw = dict(particle_count=1 << 20, total_iterations=20,
              field_width=1_000_000, field_height=1_000_000,
              collision_mode="reference", save_images=False, log_every=10,
              force_model="bh")
    kw.update(over)
    return SimConfig(**kw)


def million_scene(cfg):
    from nbodyax_torch.rng import scene_arrays
    t0 = time.perf_counter()
    arrays = scene_arrays(cfg.seed, cfg.particle_count, cfg.field_width,
                          cfg.field_height, cfg.min_body_mass,
                          cfg.max_body_mass, cfg.min_radius, cfg.max_radius)
    print(f"scene N={cfg.particle_count} seed {cfg.seed}: "
          f"{time.perf_counter() - t0:.1f} s (bit-exact RNG, host)")
    return arrays


def crowded_state(n, seed, field, dead=True, crowd=True, dims=2):
    """Uniform bodies over +-field, a quarter of them inside one small
    patch at the centre (unless not ``crowd``), body 7 dead."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-field, field, (n, dims)).astype(np.float32)
    patch = rng.uniform(-field / 3000, field / 3000, (n // 4, dims))
    if crowd:
        pos[: n // 4] = patch
    vel = rng.uniform(-3, 3, (n, dims)).astype(np.float32)
    mass = rng.uniform(1e4, 1e17, n).astype(np.float32)
    radius = rng.uniform(50, 200, n).astype(np.float32)
    if dead:
        mass[7] = 0.0
    return pos, vel, mass, radius


def bh_structure(arrays, dev, levels, need_vel):
    from nbodyax_torch.physics.bh_grid import _extent, _partner_structure
    t = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
              for x in arrays)
    ext = _extent(t[0], t[2] > 0)
    return t, ext, _partner_structure(*t, ext, 1 << levels, need_vel)


def phase_slotpack(dev, arrays_1m, levels=8, S=40, dims=2):
    """B5 (and B4) against their plain versions: rows bitwise, moments at
    2e-6 of max(per-channel scale, 1), on the N = 1M scene and on a
    crowded state; in 3-D with rows of 7 and, with velocities, of 10
    floats, and 10 moments. Returns the largest absolute and relative
    (``abs_rel_err``) moment errors (B5) and row errors (B4) seen."""
    from nbodyax_torch.physics.slotpack_kernel import (
        build_slot_grid_reference, finest_moments_reference, pack_slots)
    worst = worst_rows = (0.0, 0.0)
    tag = "" if dims == 2 else "3-D "
    cases = [(f"{tag}{name}", arrays, need_vel)
             for name, arrays in (("scene N=1M", arrays_1m),
                                  ("crowded N=262144",
                                   crowded_state(1 << 18, 4, 1e6, dims=dims)))
             for need_vel in ((False,) if dims == 2 else (False, True))]
    for name, arrays, need_vel in cases:
        (pos, _, mass, _), ext, st = bh_structure(arrays, dev, levels,
                                                  need_vel)
        n, ncells, L = pos.shape[0], 1 << (dims * levels), st[4].shape[1]
        rows_k, mom_k = pack_slots(st[4], st[2], st[3], S,
                                   moments=(pos, mass, ext, levels))
        rows_b4 = pack_slots(st[4], st[2], st[3], S)
        rows_p = build_slot_grid_reference(st[4], st[2], st[3], n, ncells, S)
        mom_p = finest_moments_reference(pos, mass, ext, levels)
        torch.cuda.synchronize()
        occ = int((st[3] - st[2]).max())
        check(torch.equal(rows_k, rows_p), f"B5 rows differ ({name} L={L})")
        check(torch.equal(rows_b4, rows_p), f"B4 rows differ ({name} L={L})")
        check(mom_k.shape == mom_p.shape == (ncells, 6 if dims == 2 else 10),
              f"B5 moments have shape {tuple(mom_k.shape)} ({name})")
        scale = mom_p.abs().amax(0).clamp(min=1.0)
        err = ((mom_k - mom_p).abs().amax(0) / scale).max().item()
        worst = tuple(map(max, worst, abs_rel_err(mom_k, mom_p)))
        worst_rows = tuple(map(max, worst_rows,
                               abs_rel_err(rows_b4, rows_p)))
        print(f"slot pack {name} L={L}: B4/B5 rows bitwise equal to the "
              f"gather (max cell occupancy {occ}); B5's {mom_k.shape[1]} "
              f"moments {err:.3e} of the per-channel scale (gate "
              f"{MOM_GATE})")
        check(err < MOM_GATE, f"B5 moments off by {err} ({name} L={L})")
    return worst, worst_rows


def near_compare(fslot, mode, eps2, g, ring, ci, dim=2, cell_base=0,
                 ncells_eval=0):
    """B3 against its plain version at every live i slot (of the cells
    from ``cell_base`` on, ``ncells_eval`` of them, or all): float channels
    relative to the channel's largest value, id and flag channels exact,
    and a second call bitwise equal to the first. Returns (errors, passed,
    the force's largest absolute and relative errors)."""
    from nbodyax_torch.physics.near_kernel import (slots_near,
                                                   slots_near_reference)
    kw = dict(mode=mode, eps2=eps2, growth=0.1, g=g, ring=ring, ci=ci,
              dim=dim, cell_base=cell_base, ncells_eval=ncells_eval)
    k = slots_near(fslot, **kw)
    repeats = bool(torch.equal(k, slots_near(fslot, **kw)))
    p = slots_near_reference(fslot, **kw)
    rest = 2 * dim if mode == "elastic" else dim
    rows = slice(cell_base, cell_base + (ncells_eval or fslot.shape[0]))
    live = fslot[rows, :ci, rest] > 0
    k, p = k[live], p[live]
    force = list(range(dim))
    floats = {"reference": force + [dim, dim + 1], "momentum": force,
              "elastic": list(range(2 * dim)), "none": force}[mode]
    exact = {"reference": [dim + 2],
             "momentum": [dim + 1, dim + 2]}.get(mode, [])
    err, ok = {"repeat_bitwise": repeats}, repeats
    for c in floats:
        e = float((k[:, c] - p[:, c]).abs().max()
                  / p[:, c].abs().max().clamp(min=1e-30))
        err[f"ch{c}"] = e
        ok &= e < NEAR_GATE
    if mode == "momentum":
        fin = torch.isfinite(p[:, dim])
        ok &= bool(torch.equal(fin, torch.isfinite(k[:, dim])))
        e = float((k[fin, dim] - p[fin, dim]).abs().max()
                  / p[fin, dim].abs().max().clamp(min=1e-30)) if fin.any() \
            else 0.0
        err["best_mass"] = e
        ok &= e < NEAR_GATE
    for c in exact:
        same = bool(torch.equal(k[:, c], p[:, c]))
        err[f"ch{c}_exact"] = same
        ok &= same
    fin = torch.isfinite(p[:, :dim]).all(1)
    return err, ok, abs_rel_err(k[fin, :dim], p[fin, :dim])


def phase_near(dev, arrays_1m):
    """B3 against its plain version in all four modes at eps 0 and 100 on
    a crowded N = 65,536 state (dead body, grid edges, a cell far past the
    slot budget), and on the N = 1M scene in the main path's mode. Returns
    the largest absolute and relative force errors on the 1M scene."""
    from nbodyax_torch.physics.barneshut import slot_cap
    from nbodyax_torch.physics.slotpack_kernel import pack_slots
    for mode in ("reference", "momentum", "elastic", "none"):
        arrays = crowded_state(65536, 12, 1e5)
        levels = 6
        g = 1 << levels
        _, _, st = bh_structure(arrays, dev, levels, mode == "elastic")
        ci = slot_cap(65536, g * g)
        fslot = pack_slots(st[4], st[2], st[3], 40)
        for eps in (0.0, 100.0):
            err, ok, _ = near_compare(fslot, mode, eps * eps, g, 1, ci)
            print(f"B3 vs plain N=65536 crowded {mode} eps={eps}: "
                  f"{json.dumps(err)}")
            check(ok, f"B3 disagrees with its plain version: {mode} "
                      f"eps={eps}: {err}")
    levels = 8
    _, _, st = bh_structure(arrays_1m, dev, levels, False)
    fslot = pack_slots(st[4], st[2], st[3], 40)
    err, ok, max_abs = near_compare(fslot, "reference", 0.0, 1 << levels, 1,
                                    32)
    print(f"B3 vs plain N=1M scene reference eps=0: {json.dumps(err)}")
    check(ok, f"B3 disagrees with its plain version on the 1M scene: {err}")
    return max_abs


def rel_force_err(a, b):
    """tests/test_barneshut.py:27-31."""
    fa, fb = a.double(), b.double()
    scale = fb.norm(dim=1)
    denom = torch.maximum(scale, scale.quantile(0.5))
    return float(((fa - fb).norm(dim=1) / denom).max())


def phase_bh_vs_exact(dev):
    """bh through B3/B5 against the exact all-pairs kernel B1 at
    N = 65,536: far-field accuracy at ring 1, and collision channels exact
    where every overlap lies inside the near window. The FMM local table
    on the card equals the CPU's to 1e-5, which TF32 in the M2L
    convolution (about 1e-3) would break."""
    from nbodyax_torch.physics import barneshut as bh
    from nbodyax_torch.physics.bh_grid import _extent
    from nbodyax_torch.physics.fmm import _fmm_local_table
    from nbodyax_torch.physics.kernels import pair_accumulators_kernel
    from nbodyax_torch.physics.near_kernel import slots_near

    n = 65536
    rng = np.random.RandomState(1)
    pos = rng.uniform(-1e5, 1e5, (n, 2)).astype(np.float32)
    vel = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    mass[5] = 0.0
    radius = rng.uniform(1, 8, n).astype(np.float32)
    t = [torch.from_numpy(x).to(dev) for x in (pos, vel, mass, radius)]
    launches = slots_near.launches
    got = bh.bh_accumulators(*t, eps=50.0, mode="none", ring=1, levels=6,
                             neighbor_k=0, near="slots")
    check(slots_near.launches > launches, "bh did not launch B3")
    ex = pair_accumulators_kernel(*t, eps=50.0, mode="none")
    err = rel_force_err(got.force, ex.force)
    print(f"bh (B3 + B5, fmm, ring 1) vs exact (B1) N={n}: rel_force_err "
          f"{err:.4e} (gate 0.05)")
    check(err < 0.05, f"bh far field off: rel_force_err {err}")

    ext = _extent(t[0], t[2] > 0)
    loc = _fmm_local_table(t[0], t[2], ext, 6, 2, 2500.0, 2)
    cpu = [x.cpu() for x in t]
    loc_cpu = _fmm_local_table(cpu[0], cpu[2], _extent(cpu[0], cpu[2] > 0),
                               6, 2, 2500.0, 2)
    terr = float(((loc.cpu() - loc_cpu).abs().amax(0)
                  / loc_cpu.abs().amax(0).clamp(min=1e-30)).max())
    print(f"FMM local table, card vs CPU: {terr:.3e} of the channel scale "
          f"(gate 1e-5; TF32 in the M2L conv would give ~1e-3)")
    check(terr < 1e-5, f"card FMM differs from the CPU's by {terr}")

    # all overlaps inside the window: cell 32000/64 = 500 > 2 r_max = 30
    pos = rng.uniform(-16000, 16000, (n, 2)).astype(np.float32)
    radius = rng.uniform(1, 15, n).astype(np.float32)
    t = [torch.from_numpy(x).to(dev) for x in (pos, vel, mass, radius)]
    lv, near, k, comp = bh.pick_levels(t[0], t[2], levels=6, near="slots")
    for mode in ("reference", "momentum", "elastic"):
        got = bh.bh_accumulators(*t, eps=10.0, mode=mode, levels=lv,
                                 neighbor_k=k, comp_cap=comp, near=near)
        ex = pair_accumulators_kernel(*t, eps=10.0, mode=mode)
        ok = True
        if mode == "reference":
            ok &= bool(torch.equal(got.died, ex.died))
            ok &= bool(torch.allclose(got.gained_mass, ex.gained_mass,
                                      rtol=1e-5, atol=0))
            detail = f"{int(ex.died.sum())} deaths"
        elif mode == "momentum":
            ok &= bool(torch.equal(got.parent, ex.parent))
            detail = f"{int((ex.best_mass > -np.inf).sum())} candidates"
        else:
            e = float((got.dv - ex.dv).abs().max()
                      / ex.dv.abs().max().clamp(min=1e-30))
            ok &= e < 2e-5
            detail = f"dv {e:.3e} of the largest"
        print(f"bh vs exact collision channels N={n} {mode} (levels {lv}, "
              f"K {k}): {'exact' if ok else 'DIFFER'}, {detail}")
        check(ok, f"bh collision channels differ from exact: {mode}")


def config_text(cfg):
    from nbodyax_torch.config import _KEYS
    out = []
    for key, (attr, _) in _KEYS.items():
        v = getattr(cfg, attr)
        out.append(f"{key}={str(v).lower() if isinstance(v, bool) else v}")
    return "\n".join(out) + "\n"


def phase_bh_main_path(cfg):
    """The CLI on the N = 1M bh configuration (2-D, or 3-D with
    ``dimensions=3``) for 20 steps through graph windows: the knobs it
    picked, bh_overflow 0, a finite state, B3, B5 and the annulus kernel
    once a step by replays, the run's peak device memory. Returns (B3
    launches, B5 launches, annulus launches)."""
    from nbodyax_torch.physics.annulus_kernel import annulus_cells
    from nbodyax_torch.physics.near_kernel import slots_near
    from nbodyax_torch.physics.slotpack_kernel import pack_slots
    torch.cuda.reset_peak_memory_stats()
    slots_near.launches = 0
    pack_slots.moment_launches = 0
    annulus_cells.launches = 0
    r = cli_run([], cfg_text=config_text(cfg))
    out, rc = r["out"], r["rc"]
    b3, b5 = slots_near.launches, pack_slots.moment_launches
    ann = annulus_cells.launches
    peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"bh cli exited {rc}")
    graph_windows_ran(r, f"bh main path {cfg.dimensions}-D")
    knobs = [l for l in out.splitlines() if l.startswith("bh auto-selected")]
    check(len(knobs) == 1, "no 'bh auto-selected' line")
    logs = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
    steps = cfg.total_iterations
    check(len(logs) == steps // cfg.log_every, f"log lines: {len(logs)}")
    for rec in logs:
        check(rec["bh_overflow"] == 0, f"bh_overflow {rec['bh_overflow']}")
        check(all(np.isfinite(v) for v in rec.values()
                  if isinstance(v, float)), f"non-finite log values: {rec}")
    check(b3 == steps and b5 == steps and ann == steps,
          f"B3 launched {b3}, B5 {b5} and the annulus {ann} times in "
          f"{steps} steps")
    taken = [l for l in out.splitlines() if l.startswith("Time taken: ")]
    check(len(taken) == 1, "no 'Time taken:' line")
    last = logs[-1]
    if cfg.dimensions == 3:
        check(all("momentum_z" in rec for rec in logs),
              "a 3-D bh log line without momentum_z")
    print(f"bh main path {cfg.dimensions}-D N={cfg.particle_count}: "
          f"{knobs[0]}; peak device memory {peak / 2 ** 30:.3f} GiB")
    print(f"bh main path {cfg.dimensions}-D: {steps} steps, B3 {b3}, B5 "
          f"{b5} and annulus {ann} launches, "
          f"bh_overflow {[r['bh_overflow'] for r in logs]}, "
          f"bh_giant_excess {last['bh_giant_excess']}, {last['alive']} "
          f"alive, {taken[0]}, {last['steps_per_sec']:.6g} steps/s "
          f"(device-timed, cumulative), last window {last['wall_ms']:.4f} "
          f"ms a step")
    return b3, b5, ann


def phase_bh_direct(dims=2, mode="reference", far="direct", order=1,
                    adaptive=False):
    """The CLI at N = 65,536 for 10 steps with ``bhNear=slots``. With
    ``bhFar=direct bhOrder=1`` the slots engine packs with B4 (no moments
    wanted) once a step, with the FMM with B5; B3 runs once a step either
    way, counted by graph replays. In 3-D the rows are 7 wide, 10 in
    elastic mode. ``adaptive``: ``adaptiveDt=1``, every log line's
    dt_mean within dt_bounds. Returns the launches of (B3, B4, B5)."""
    from nbodyax_torch.config import SimConfig
    from nbodyax_torch.physics.near_kernel import slots_near
    from nbodyax_torch.physics.slotpack_kernel import pack_slots
    from nbodyax_torch.physics.step import PhysicsParams
    cfg = SimConfig(particle_count=65536, total_iterations=10,
                    save_images=False, force_model="bh", bh_far=far,
                    bh_order=order, bh_near="slots", dimensions=dims,
                    collision_mode=mode, adaptive_dt=adaptive)
    slots_near.launches = 0
    pack_slots.launches = pack_slots.moment_launches = 0
    r = cli_run([], cfg_text=config_text(cfg))
    out, rc = r["out"], r["rc"]
    got = (slots_near.launches, pack_slots.launches,
           pack_slots.moment_launches)
    label = f"bh {far} order {order} {dims}-D {mode}" + (
        " adaptiveDt=1" if adaptive else "")
    check(rc == 0, f"{label}: cli exited {rc}")
    graph_windows_ran(r, label)
    logs = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
    check(logs and logs[-1]["bh_overflow"] == 0, f"{label}: logs {logs[-1:]}")
    want = (10, 10, 0) if (far, order) == ("direct", 1) else (10, 0, 10)
    check(got == want, f"{label}: B3, B4, B5 launched {got} times in 10 "
          f"steps, expected {want}")
    extra = ""
    if adaptive:
        lo, hi = PhysicsParams.from_config(cfg).dt_bounds
        dts = [r["dt_mean"] for r in logs]
        check(all(lo * (1 - 1e-5) <= d <= hi * (1 + 1e-5) for d in dts),
              f"{label}: dt_mean {dts} outside [{lo}, {hi}]")
        extra = f", dt_mean {dts} within [{lo:.6g}, {hi:.6g}]"
    print(f"{label} N=65536: 10 steps, B3 {got[0]}, B4 {got[1]}, B5 "
          f"{got[2]} launches, bh_overflow 0, {logs[-1]['alive']} alive"
          f"{extra}")
    return got


def phase_bh_timing(dev, arrays_1m, cfg, levels=8, S=40, ci=32):
    """B3, B4 and B5 against their plain versions at N = 1M in the
    dimensions of ``cfg`` (CUDA events, turns plain, kernel, kernel,
    plain), one bh step (device span and host wall), and one step's
    torch.profiler device ops, idle share and peak device memory. The
    defaults are the 2-D scene's auto knobs; the 3-D scene's are levels 5,
    S = 80, ci = 64."""
    from nbodyax_torch.driver import resolve_bh_config
    from nbodyax_torch.backends import build_accum_fn
    from nbodyax_torch.physics.near_kernel import (slots_near,
                                                   slots_near_reference)
    from nbodyax_torch.physics.slotpack_kernel import (
        build_slot_grid_reference, finest_moments_reference, pack_slots)
    from nbodyax_torch.physics.step import PhysicsParams, make_step
    from nbodyax_torch.state import make_state

    dims = cfg.dimensions
    tag = "1M scene" if dims == 2 else "3-D 1M scene"
    (pos, _, mass, _), ext, st = bh_structure(arrays_1m, dev, levels, False)
    g = 1 << levels
    n, ncells = pos.shape[0], g ** dims
    fslot = pack_slots(st[4], st[2], st[3], S)
    kw = dict(mode="reference", eps2=0.0, growth=0.1, g=g, ring=1, ci=ci,
              dim=dims)
    fns = {
        "B3": (lambda: slots_near(fslot, **kw),
               lambda: slots_near_reference(fslot, **kw)),
        "B4": (lambda: pack_slots(st[4], st[2], st[3], S),
               lambda: build_slot_grid_reference(st[4], st[2], st[3], n,
                                                 ncells, S)),
        "B5": (lambda: pack_slots(st[4], st[2], st[3], S,
                                  moments=(pos, mass, ext, levels)),
               lambda: (build_slot_grid_reference(st[4], st[2], st[3], n,
                                                  ncells, S),
                        finest_moments_reference(pos, mass, ext, levels))),
    }
    # the plain 3-D near field walks 27 cells a window: one call a turn
    plain_reps = {"B3": (5, 2) if dims == 2 else (1, 1)}
    times = {}
    for name, (kern, plain) in fns.items():
        t = {"kernel": [], "plain": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            if which == "kernel":
                t[which].append(time_ms(kern, reps=20))
            else:
                reps, warm = plain_reps.get(name, (5, 2))
                t[which].append(time_ms(plain, reps=reps, warm=warm))
        print(f"{name} {tag}: kernel {t['kernel']} ms, plain {t['plain']} ms")
        times[name] = {"ms": float(np.mean(t["kernel"])),
                       "plain_ms": float(np.mean(t["plain"])),
                       "library_ms": None}
    # B4's one PyTorch call: the gather by a precomputed slot index
    pslots = st[2][:, None] + torch.arange(S, device=dev)
    idx = torch.where(pslots < torch.minimum(st[3], st[2] + S)[:, None],
                      pslots, n)
    lib = [time_ms(lambda: st[4][idx], reps=20) for _ in range(2)]
    times["B4"]["library_ms"] = float(np.mean(lib))
    # bounds from this run's occupancy: live i slots against the live
    # slots of their 3^dims window (clipped at the grid's edge)
    occ = (st[3] - st[2]).to(torch.int64).view((g,) * dims)
    live_i = occ.clamp(max=ci)
    live_s = occ.clamp(max=S)
    pad = torch.nn.functional.pad(live_s, (1, 1) * dims)
    window = sum(pad[tuple(slice(1 + o, 1 + o + g) for o in off)]
                 for off in itertools.product((-1, 0, 1), repeat=dims))
    pairs = int((live_i * window).sum())
    L = st[4].shape[1]
    n_mom = 6 if dims == 2 else 10
    rows_moved = int(live_s.sum()) * L * 4
    grid_bytes = ncells * S * L * 4 + 2 * ncells * st[2].element_size()
    pair_flops = B3_FLOPS_PER_PAIR if dims == 2 else B3_FLOPS_PER_PAIR_3D
    times["B3"]["bound"] = bound_ms(pairs * pair_flops,
                                    fslot.numel() * 4 + ncells * ci * 8 * 4)
    times["B4"]["bound"] = bound_ms(0, rows_moved + grid_bytes)
    times["B5"]["bound"] = bound_ms(0, rows_moved + grid_bytes
                                    + n * (dims + 1) * 4
                                    + ncells * n_mom * 4)
    for name in ("B3", "B4", "B5"):
        b, by = times[name]["bound"]
        print(f"{name} {tag}: {times[name]['ms']:.4f} ms, bound {b:.4f} ms "
              f"({by}; {pairs} live near pairs at {pair_flops} flops), "
              f"{100 * b / times[name]['ms']:.1f}% of the bound; one "
              f"PyTorch call: {times[name]['library_ms']} ms")
        kern = fns[name][0]
        times[name]["device_ms"] = report_device(
            f"{name} ({tag})", n, kern,
            B3_TAGS if name == "B3" else PACK_TAGS, times[name]["ms"],
            times[name]["bound"])
    if dims == 2:
        slotpack_tail(dev, levels, S)
    del fslot, idx, pslots

    state = make_state(*arrays_1m, device=dev)
    rcfg = resolve_bh_config(cfg, state)
    p = PhysicsParams.from_config(rcfg)
    step = make_step(p, accum_fn=build_accum_fn(rcfg.backend, p, dev, rcfg))
    torch.cuda.reset_peak_memory_stats()
    step(state)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    dev_ms = time_ms(lambda: step(state), reps=5)
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step(state)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    walls.sort()
    print(f"bh step {dims}-D N=1M ({rcfg.bh_near}, levels {rcfg.bh_levels}, "
          f"K {rcfg.bh_neighbor_k}): {dev_ms:.4f} ms CUDA-event span, host "
          f"wall a step median {walls[2]:.4f} ms (5 steps, "
          f"{walls[0]:.4f}-{walls[-1]:.4f}), peak device memory of one step "
          f"{peak / 2 ** 30:.3f} GiB")
    # the same step through the driver's graph windows, beside the eager
    from nbodyax_torch import driver
    runner = driver._GraphWindows(step, state, rcfg, 0, 10, None)
    runner.advance(10, False)
    torch.cuda.synchronize()
    gwalls = []
    for _ in range(3):
        t0 = time.perf_counter()
        runner.advance(10, False)
        torch.cuda.synchronize()
        gwalls.append((time.perf_counter() - t0) * 1e2)
    runner.close()
    print(f"bh step {dims}-D N=1M through graph windows (10 steps a window): "
          f"host wall a step {[round(w, 4) for w in sorted(gwalls)]} ms over "
          f"3 windows, against the eager step's median {walls[2]:.4f} ms")

    profile_breakdown(lambda: step(state), 3, f"bh step {dims}-D N=1M")
    return times


def annulus_live_pairs(packed, st, levels, dims, ci, ring=1):
    """The annulus kernel's evaluations: each cell's live slots (its count
    up to ci) times the shell cells of mass around it, summed."""
    from nbodyax_torch.physics.fmm import _annulus_offsets
    g, w = 1 << levels, ring + 1
    live = (st[3] - st[2]).clamp(max=ci).view((g,) * dims)
    has = (packed[:, 0] > 0).to(torch.int64).view((g,) * dims)
    pad = torch.nn.functional.pad(has, (w, w) * dims)
    shell = torch.zeros_like(has)
    for off in _annulus_offsets(ring, ring + 1, dims):
        # off[0] is x, the grid's last axis
        shell += pad[tuple(slice(w + o, w + o + g) for o in reversed(off))]
    return int((live * shell).sum())


def phase_annulus(dev, arrays_1m, arrays3_1m):
    """The bh annulus kernel against the plain ``fmm._annulus_force_cells``
    at the 1M scenes' auto knobs (2-D: levels 8, ci 32, 16 shell cells;
    3-D: levels 5, ci 64, 98), from the slot grid and from the sorted pack;
    timed in turns plain, kernel, kernel, plain (CUDA events, the slot
    grid's form, as the bh step calls it), its own device time by the
    profiler, and its bound from the live slots and shell cells of mass.
    Returns {dims: ((max abs, max rel) error, times)}."""
    from nbodyax_torch.physics.annulus_kernel import annulus_cells
    from nbodyax_torch.physics.fmm import _annulus_force_cells, _level_grids
    from nbodyax_torch.physics.slotpack_kernel import pack_slots
    out = {}
    for dims, arrays, (levels, S, ci) in (
            (2, arrays_1m, (8, 40, 32)),
            (3, arrays3_1m, (BH3D_LEVELS, BH3D_S, BH3D_CI))):
        (pos, _, mass, _), ext, st = bh_structure(arrays, dev, levels, False)
        n = pos.shape[0]
        packed = torch.stack(_level_grids(pos, mass, ext, levels,
                                          order=2)[levels], 1)
        fslot = pack_slots(st[4], st[2], st[3], S)
        args = (packed, ext, levels, 1, 2, 0.0, 2, st, ci)
        count = (st[3] - st[2]).clamp(max=ci)
        live = (torch.arange(ci, device=dev)[None, :]
                < count[:, None]).reshape(-1)
        errs, first = [], None
        for source, fs in (("slot grid", fslot), ("sorted pack", None)):
            k, kid = annulus_cells(*args, fslot=fs)
            p, pid = _annulus_force_cells(*args, fslot=fs)
            first = k if first is None else first
            check(torch.equal(kid, pid), f"annulus {dims}-D ({source}): the "
                  f"ids differ from the plain version's")
            check(not bool(k[~live].any()), f"annulus {dims}-D ({source}): "
                  f"a slot past its cell's count has a force")
            rel = float((k[live] - p[live]).abs().max()
                        / p[live].abs().max())
            errs.append(abs_rel_err(k[live], p[live]))
            print(f"annulus {dims}-D vs plain N={n} ({source}, levels "
                  f"{levels}, ci {ci}): {int(live.sum())} live slots, "
                  f"largest error {rel:.3g} of the largest force, per "
                  f"channel {errs[-1]}")
            check(rel < ANNULUS_GATE, f"annulus {dims}-D ({source}) off its "
                  f"plain version by {rel} of the largest force")
        again, _ = annulus_cells(*args, fslot=fslot)
        check(torch.equal(again, first), f"annulus {dims}-D: two launches "
              f"differ")
        kern = lambda: annulus_cells(*args, fslot=fslot)          # noqa
        plain = lambda: _annulus_force_cells(*args, fslot=fslot)  # noqa
        t = {"kernel": [], "plain": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            t[which].append(time_ms(kern, reps=20) if which == "kernel"
                            else time_ms(plain, reps=3, warm=1))
        pairs = annulus_live_pairs(packed, st, levels, dims, ci)
        nbytes = (int(live.sum()) * (dims + 2) * 4 + live.numel()
                  * (dims * 4 + 8) + packed.numel() * 4 + 2 * 8
                  * packed.shape[0])
        times = {"ms": float(np.mean(t["kernel"])),
                 "plain_ms": float(np.mean(t["plain"])), "library_ms": None,
                 "bound": bound_ms(pairs * ANNULUS_FLOPS[dims], nbytes)}
        print(f"annulus {dims}-D N={n}: kernel {t['kernel']} ms, plain "
              f"{t['plain']} ms (CUDA events); {pairs} live slot-cell pairs "
              f"at {ANNULUS_FLOPS[dims]} flops, bound "
              f"{times['bound'][0]:.4f} ms ({times['bound'][1]})")
        times["device_ms"] = report_device(
            f"annulus ({dims}-D 1M scene)", n, kern, ANNULUS_TAGS,
            times["ms"], times["bound"])
        out[dims] = (tuple(max(e[i] for e in errs) for i in range(2)), times)
        del fslot, packed, st
    return out


def slotpack_tail(dev, levels, S):
    """B4 and B5 by device time on the crowded N = 262,144 state (one cell
    holds a quarter of the bodies) and on a uniform state of the same N and
    cells: the crowded cell's tail shows as the ratio of the two."""
    from nbodyax_torch.physics.slotpack_kernel import pack_slots
    got = {}
    for label, crowd in (("uniform", False), ("crowded", True)):
        (pos, _, mass, _), ext, st = bh_structure(
            crowded_state(1 << 18, 4, 1e6, crowd=crowd), dev, levels, False)
        occ = int((st[3] - st[2]).max())
        b4, _ = device_ms(lambda: pack_slots(st[4], st[2], st[3], S),
                          PACK_TAGS)
        b5, detail = device_ms(
            lambda: pack_slots(st[4], st[2], st[3], S,
                               moments=(pos, mass, ext, levels)), PACK_TAGS)
        got[label] = b5
        print(f"slot pack N=262144 {label} (levels {levels}, max cell "
              f"occupancy {occ}): B4 {b4:.4f} ms, B5 {b5:.4f} ms by device "
              f"time ({detail})")
    print(f"slot pack N=262144: B5 crowded / uniform device time "
          f"{got['crowded'] / got['uniform']:.3f}")


# ---------------------------------------------------------------------------
# dimensions=3 on the exact path: the 3-D forms of B1 and B2
# ---------------------------------------------------------------------------

def random_state_3d(n, seed, field=300.0):
    """tests/test_3d.py's random_state_3d, at a field of 300 so that the
    3-D overlaps are dense: slot 7 dead, radii 5-60."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-field, field, (n, 3)).astype(np.float32)
    vel = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    mass[7] = 0.0
    radius = rng.uniform(5, 60, n).astype(np.float32)
    return pos, vel, mass, radius


def default_scene_3d(n=None):
    """The built-in config with dimensions=3 (N = 16,384 unless ``n``):
    its config and its scene as numpy arrays (the port's 3-D uniform
    scene, nbodyax's jax.random draw)."""
    from nbodyax_torch.config import SimConfig
    from nbodyax_torch.scenes import init_scene
    cfg = SimConfig(dimensions=3)
    if n is not None:
        cfg.particle_count = n
    st = init_scene(cfg, device="cpu")
    return cfg, [x.numpy().copy() for x in st[:4]]


def phase_planar_3d(dev, scene2d):
    """A 3-D call on the z = 0 copy of the 2-D default scene: the same
    merge decisions as the 2-D call, xy force within FORCE_GATE, z exactly
    0; bit for bit where the two forms pick the same splits, which the
    second call of each mode (all rows against the first 300 partners,
    one split in either form) makes sure of."""
    from nbodyax_torch.physics.kernels import (MODES, body_features,
                                               decode_raw, forward_splits,
                                               tile_accumulators_raw)
    pos, vel, mass, radius = (torch.from_numpy(x).to(dev) for x in scene2d)
    n = pos.shape[0]
    z = torch.zeros((n, 1), device=dev)
    f2 = body_features(pos, vel, mass, radius)
    f3 = body_features(torch.cat([pos, z], 1), torch.cat([vel, z], 1), mass,
                       radius)
    for mode, nj in ((m, k) for m in MODES for k in (n, 300)):
        kw = dict(mode=mode, eps=0.0, growth_rate=0.1)
        a2 = decode_raw(*tile_accumulators_raw(f2, f2[:nj], 0, 0, **kw), 0,
                        mass, mode)
        a3 = decode_raw(*tile_accumulators_raw(f3, f3[:nj], 0, 0, dim=3,
                                               **kw), 0, mass, mode, dim=3)
        splits = (forward_splits(n, nj, mode, dev),
                  forward_splits(n, nj, mode, dev, dim=3))
        decisions = (torch.equal(a3.died, a2.died)
                     and torch.equal(a3.parent, a2.parent)
                     and torch.equal(a3.best_mass, a2.best_mass))
        zero_z = not (a3.force[:, 2].any() or a3.dv[:, 2].any())
        frel = float((a3.force[:, :2] - a2.force).abs().max()
                     / a2.force.abs().max())
        pairs = ((a3.force[:, :2], a2.force), (a3.dv[:, :2], a2.dv),
                 (a3.gained_mass, a2.gained_mass),
                 (a3.gained_radius, a2.gained_radius))
        bitwise = all(torch.equal(x, y) for x, y in pairs)
        print(f"planar 3-D vs 2-D {n} x {nj} {mode}: splits {splits}, "
              f"decisions "
              f"equal {decisions}, z zero {zero_z}, xy force {frel:.3e} of "
              f"the largest, bitwise {bitwise}")
        check(decisions and zero_z and frel < FORCE_GATE,
              f"planar 3-D call differs from the 2-D call in {mode}")
        check(bitwise or splits[0] != splits[1], f"planar 3-D call not "
              f"bitwise equal to the 2-D call at the same splits ({mode})")
        check(nj == n or splits == (1, 1), f"{n} x {nj}: splits {splits}")


def phase_timing_3d(dev, scene2d, scene3d, cfg3):
    """B1 and B2 in 3-D at N = 16,384 beside their 2-D calls and the 3-D
    plain versions (turns plain, 2-D, 3-D, 3-D, 2-D, plain), device time
    by the profiler; B1 alone at N = 1,048,576 in 3-D and 2-D; one
    profiled 3-D default-scene step. Returns the kernels-line entries of
    B1 and B2 in 3-D."""
    from nbodyax_torch.backends import build_accum_fn
    from nbodyax_torch.physics.kernels import (body_features,
                                               forward_splits,
                                               tile_accumulators_raw,
                                               tile_accumulators_raw_reference)
    from nbodyax_torch.physics.kernels_bwd import (backward_splits,
                                                   raw_backward,
                                                   raw_backward_reference)
    from nbodyax_torch.physics.step import PhysicsParams, make_step
    from nbodyax_torch.scenes import init_scene

    f2 = body_features(*(torch.from_numpy(x).to(dev) for x in scene2d))
    f3 = body_features(*(torch.from_numpy(x).to(dev) for x in scene3d))
    n = f3.shape[0]
    g = cotangent(n, dev)
    kw = dict(mode="reference", eps=0.0, growth_rate=0.1)
    fwd = {"plain": lambda: tile_accumulators_raw_reference(
               f3, f3, 0, 0, dim=3, **kw),
           "2-D": lambda: tile_accumulators_raw(f2, f2, 0, 0, **kw),
           "3-D": lambda: tile_accumulators_raw(f3, f3, 0, 0, dim=3, **kw)}
    bwd = {"plain": lambda: raw_backward_reference(f3, f3, 0, 0, None, g,
                                                   dim=3, **kw),
           "2-D": lambda: raw_backward(f2, f2, 0, 0, None, g, **kw),
           "3-D": lambda: raw_backward(f3, f3, 0, 0, None, g, dim=3, **kw)}
    out = {}
    for name, fns, reps, tags, flops, nbytes, splits in (
            ("B1", fwd, 20, B1_TAGS, n * n * B1_FLOPS_PER_PAIR_3D,
             3 * n * 32, forward_splits(n, n, "reference", dev, dim=3)),
            ("B2", bwd, 10, B2_TAGS, 2 * n * n * B2_FLOPS_PER_PAIR_SIDE_3D,
             5 * n * 32, backward_splits(n, n, "reference", dev, 3))):
        times = {k: [] for k in fns}
        for k in ("plain", "2-D", "3-D", "3-D", "2-D", "plain"):
            times[k].append(time_ms(fns[k], reps=reps))
        ms = {k: float(np.mean(v)) for k, v in times.items()}
        print(f"{name} N={n} reference mode, CUDA events: 3-D {times['3-D']}"
              f" ms, 2-D {times['2-D']} ms, 3-D plain {times['plain']} ms")
        bound = bound_ms(flops, nbytes)
        report_split_call(f"{name} 3-D", n, ms["3-D"], splits,
                          cuda_launches(fns["3-D"]), bound)
        dms3 = report_device(f"{name} 3-D", n, fns["3-D"], tags, ms["3-D"],
                             bound, reps=reps)
        dms2, _ = device_ms(fns["2-D"], tags, reps)
        print(f"{name} N={n}: device time 3-D {dms3:.4f} ms, 2-D "
              f"{dms2:.4f} ms in the same run, ratio 3-D / 2-D "
              f"{dms3 / dms2:.4f}")
        out[name] = {"ms": ms["3-D"], "device_ms": dms3,
                     "plain_ms": ms["plain"], "library_ms": None,
                     "bound": bound}

    # B1 alone at bench/dim3.py's size: the 3-D scene at N = 1M and its xy
    # projection, as bench/dim3.py records pairs/s and their ratio
    _, big = default_scene_3d(1 << 20)
    b3 = body_features(*(torch.from_numpy(x).to(dev) for x in big))
    b2 = body_features(*(torch.from_numpy(x[:, :2] if x.ndim == 2 else x)
                         .to(dev) for x in big))
    nb = b3.shape[0]
    pps = {}
    for label, feats, dim in (("2-D", b2, 2), ("3-D", b3, 3)):
        def call():
            return tile_accumulators_raw(feats, feats, 0, 0, dim=dim, **kw)
        ms = time_ms(call, reps=2)
        pps[label] = nb * nb / (ms / 1e3)
        flops = B1_FLOPS_PER_PAIR_3D if dim == 3 else B1_FLOPS_PER_PAIR
        report_split_call(f"B1 alone {label}", nb, ms,
                          forward_splits(nb, nb, "reference", dev, dim=dim),
                          "1 call", bound_ms(nb * nb * flops, 3 * nb * 32),
                          call)
    print(f"B1 N={nb}: pairs/s 3-D {pps['3-D']:.6g}, 2-D {pps['2-D']:.6g}, "
          f"ratio_3d_over_2d {pps['3-D'] / pps['2-D']:.4f}")
    del b2, b3

    p = PhysicsParams.from_config(cfg3)
    step = make_step(p, accum_fn=build_accum_fn("pallas", p, dev))
    state = init_scene(cfg3, device=dev)
    profile_breakdown(lambda: step(state), 50,
                      f"3-D default scene step N={n} (no frame)")
    return out


# ---------------------------------------------------------------------------
# forceModel=bh with dimensions=3: the 3-D forms of B3, B4 and B5
# ---------------------------------------------------------------------------

BH3D_LEVELS, BH3D_S, BH3D_CI = 5, 80, 64    # the 1M 3-D scene's auto knobs


def scene_arrays_of(cfg):
    """The scene of ``cfg`` as numpy arrays (pos, vel, mass, radius); the
    port's 3-D uniform scene is nbodyax's jax.random draw."""
    from nbodyax_torch.scenes import init_scene
    t0 = time.perf_counter()
    st = init_scene(cfg, device="cpu")
    print(f"scene {cfg.dimensions}-D N={cfg.particle_count} seed {cfg.seed}: "
          f"{time.perf_counter() - t0:.1f} s")
    return [x.numpy().copy() for x in st[:4]]


def phase_near_3d(dev, arrays_1m):
    """B3's 3-D form against its plain version: all four modes (rows of 7,
    of 10 in elastic mode) at eps 0 and 100 and ring 1 and 2 on a crowded
    N = 65,536 state at levels 3 (a patch that fills every slot of its
    cells, grid faces, a cell far past the slot budget) with every third
    cell's slot 1 made a dead body after the pack, so that dead slots sit
    between live ones; two calls bitwise equal; then the 1M 3-D scene's
    grid in the main path's mode. Returns the largest absolute and
    relative force errors on the 1M scene."""
    from nbodyax_torch.physics.slotpack_kernel import pack_slots
    levels, S, ci = 3, BH3D_S, BH3D_CI
    g = 1 << levels
    for mode in ("reference", "momentum", "elastic", "none"):
        arrays = crowded_state(65536, 12, 1e5, dims=3)
        _, _, st = bh_structure(arrays, dev, levels, mode == "elastic")
        fslot = pack_slots(st[4], st[2], st[3], S)
        rest = 6 if mode == "elastic" else 3
        fslot[::3, 1, rest] = 0.0            # dead bodies mid-cell
        full = int((fslot[:, :, rest] > 0).all(1).sum())
        check(full > 0, "3-D crowded state: no cell has every slot live")
        for ring in (1, 2):
            for eps in (0.0, 100.0):
                err, ok, _ = near_compare(fslot, mode, eps * eps, g, ring,
                                          ci, dim=3)
                print(f"B3 3-D vs plain N=65536 crowded L={fslot.shape[2]} "
                      f"{mode} ring={ring} eps={eps} ({full} cells with "
                      f"every slot live): {json.dumps(err)}")
                check(ok, f"B3 3-D disagrees with its plain version: {mode} "
                          f"ring={ring} eps={eps}: {err}")
    _, _, st = bh_structure(arrays_1m, dev, BH3D_LEVELS, False)
    fslot = pack_slots(st[4], st[2], st[3], S)
    err, ok, max_abs = near_compare(fslot, "reference", 0.0,
                                    1 << BH3D_LEVELS, 1, ci, dim=3)
    print(f"B3 3-D vs plain N=1M 3-D scene (levels {BH3D_LEVELS}, S {S}, ci "
          f"{ci}) reference eps=0: {json.dumps(err)}")
    check(ok, f"B3 3-D disagrees with its plain version on the 1M scene: "
              f"{err}")
    return max_abs


def phase_bh_vs_exact_3d(dev):
    """3-D bh through B3/B5 against the exact 3-D all-pairs kernel B1 at
    N = 16,384: the far force within tests/test_3d.py:253-254's tolerances
    for (ring, order), and collision channels exact where every overlap
    lies inside the near window (tests/test_3d.py:272-299's construction:
    cells of 500 against radii up to 60)."""
    from nbodyax_torch.physics import barneshut as bh
    from nbodyax_torch.physics.kernels import pair_accumulators_kernel
    from nbodyax_torch.physics.near_kernel import slots_near
    from nbodyax_torch.physics.slotpack_kernel import pack_slots

    n = 16384
    rng = np.random.RandomState(11)
    pos = rng.uniform(-5000, 5000, (n, 3)).astype(np.float32)
    vel = np.zeros((n, 3), np.float32)
    mass = rng.uniform(1, 100, n).astype(np.float32)
    mass[5] = 0.0
    radius = rng.uniform(1, 8, n).astype(np.float32)
    t = [torch.from_numpy(x).to(dev) for x in (pos, vel, mass, radius)]
    ex = pair_accumulators_kernel(*t, eps=50.0, mode="none")
    for ring, order, tol in ((1, 1, 0.08), (1, 2, 0.02), (2, 2, 0.01)):
        before = (slots_near.launches, pack_slots.moment_launches)
        got = bh.bh_accumulators(*t, eps=50.0, mode="none", ring=ring,
                                 levels=3, neighbor_k=0, order=order,
                                 near="slots")
        check((slots_near.launches, pack_slots.moment_launches)
              == (before[0] + 1, before[1] + 1),
              "3-D bh did not launch B3 and B5 once")
        err = rel_force_err(got.force, ex.force)
        print(f"3-D bh (B3 + B5, fmm, ring {ring}, order {order}) vs exact "
              f"(B1 3-D) N={n}: rel_force_err {err:.4e} (gate {tol})")
        check(err < tol, f"3-D bh far field off at ring {ring} order "
                         f"{order}: rel_force_err {err}")

    rng = np.random.RandomState(13)
    pos = rng.uniform(-2000, 2000, (n, 3)).astype(np.float32)
    vel = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    radius = rng.uniform(20, 60, n).astype(np.float32)
    t = [torch.from_numpy(x).to(dev) for x in (pos, vel, mass, radius)]
    lv, near, k, comp = bh.pick_levels(t[0], t[2], levels=3, near="slots")
    for mode in ("reference", "momentum", "elastic"):
        got = bh.bh_accumulators(*t, eps=10.0, mode=mode, levels=lv,
                                 neighbor_k=k, comp_cap=comp, near=near)
        ex = pair_accumulators_kernel(*t, eps=10.0, mode=mode)
        ok = True
        if mode == "reference":
            ok &= bool(torch.equal(got.died, ex.died))
            ok &= bool(torch.allclose(got.gained_mass, ex.gained_mass,
                                      rtol=1e-5, atol=0))
            detail = f"{int(ex.died.sum())} deaths"
        elif mode == "momentum":
            ok &= bool(torch.equal(got.parent, ex.parent))
            detail = f"{int((ex.best_mass > -np.inf).sum())} candidates"
        else:
            e = float((got.dv - ex.dv).abs().max()
                      / ex.dv.abs().max().clamp(min=1e-30))
            ok &= e < 2e-5
            detail = f"dv {e:.3e} of the largest"
        print(f"3-D bh vs exact collision channels N={n} {mode} (levels "
              f"{lv}, K {k}): {'exact' if ok else 'DIFFER'}, {detail}")
        check(ok, f"3-D bh collision channels differ from exact: {mode}")


# ---------------------------------------------------------------------------
# Long runs: compaction, checkpoints, resume, autoResume, the shipped
# examples and the other scenes
# ---------------------------------------------------------------------------

EXAMPLES = os.path.join(HERE, "examples")


def same_state(a, b):
    """Two states bit for bit (step included)."""
    return (all(torch.equal(x, y) for x, y in zip(a[:4], b[:4]))
            and torch.equal(a.sim_time, b.sim_time) and a.step == b.step)


def strip_timings(logs, after=0):
    return [{k: v for k, v in rec.items() if k not in TIMING_KEYS}
            for rec in logs if rec["step"] > after]


def seconds_text(res):
    return ", ".join(f"{k} {v:.4f}" for k, v in res.seconds.items())


# A compacting run's peak may exceed the plain run's by this much: two
# identical runs' peaks have differed by up to 0.9 MiB on the H100, while a
# graph pool kept across a re-capture adds the next capture's, over 100 MiB
# at 8,192 slots.
PEAK_MARGIN = 16 * 2 ** 20


def phase_compaction_graph():
    """The default scene with ``compactEvery=50 checkpointEvery=100
    autoResume=true`` for 400 steps: the capacities it shrinks through;
    graph windows against the eager runner bitwise (state, logs, frames,
    capacities); B1 once a step by replays across the re-captures; after
    each old runner's close no segment of its graphs' private pools is
    left (the memory the allocator then holds above the run's start is
    printed); peak device memory and ``Time taken`` against the same run
    without compaction, in turns (compacting, plain, plain, compacting)."""
    from nbodyax_torch import driver

    sets = ["--steps", "400", "--set", "checkpointEvery=100",
            "--set", "autoResume=true"]
    compact = sets + ["--set", "compactEvery=50"]
    runs = {"compact": [], "plain": []}
    peaks = {"compact": [], "plain": []}
    reserved = {"compact": [], "plain": []}
    after_close, kept = [], []
    real_close = driver._GraphWindows.close

    def close(self):
        pools = {tuple(g[0].pool()) for g in self.graphs.values()}
        real_close(self)
        after_close.append(torch.cuda.memory_reserved() - base_reserved)
        kept.extend({tuple(seg["segment_pool_id"])
                     for seg in torch.cuda.memory_snapshot()} & pools)

    driver._GraphWindows.close = close
    try:
        for kind in ("compact", "plain", "plain", "compact"):
            # above what is allocated at the start (earlier runs' states
            # live on)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            base_reserved = torch.cuda.memory_reserved()
            closes = len(after_close)
            r = cli_run(compact if kind == "compact" else sets,
                        keep_frames=False)
            peaks[kind].append(torch.cuda.max_memory_allocated() - base)
            reserved[kind].append(torch.cuda.max_memory_reserved()
                                  - base_reserved)
            check(r["rc"] == 0 and r["launches"] == 400
                  and len(r["frames"]) == 40,
                  f"compaction run ({kind}): rc {r['rc']}, B1 "
                  f"{r['launches']} launches in 400 steps, "
                  f"{len(r['frames'])} frames")
            check(len(after_close) - closes
                  == (len(r["result"].capacities) if kind == "compact"
                      else 0),
                  f"compaction run ({kind}): {len(after_close) - closes} "
                  f"runner closes for {r['result'].capacities}")
            runs[kind].append(r)
    finally:
        driver._GraphWindows.close = real_close
    g = runs["compact"][0]
    e = cli_run(compact, eager=True, keep_frames=False)
    same = same_run(g, e, "compaction through graph windows")
    caps = g["result"].capacities
    check(len(caps) >= 2, f"the capacity shrank {len(caps)} times: {caps}")
    check(caps == e["result"].capacities, f"capacities: graph {caps}, eager "
          f"{e['result'].capacities}")
    check(e["launches"] == 400, f"eager compaction run: B1 {e['launches']}")
    check(not kept, f"segments of closed graphs' private pools left on "
          f"the card: {kept}")
    check(max(peaks["compact"]) <= min(peaks["plain"]) + PEAK_MARGIN,
          f"peak device memory with compaction {peaks['compact']} above "
          f"the plain runs' {peaks['plain']} by more than {PEAK_MARGIN}")
    check(all(same_state(r["result"].state, g["result"].state)
              for r in runs["compact"]), "two compacting runs differ")
    mib = {k: [round(p / 2 ** 20, 3) for p in v]
           for k, v in (*peaks.items(),
                        *(("reserved_" + k, v) for k, v in reserved.items()),
                        ("after_close", after_close))}
    print(f"compaction through graph windows (default scene, 400 steps, "
          f"compactEvery=50 checkpointEvery=100 autoResume=true): capacity "
          f"16384 -> {' -> '.join(str(c) for _, c in caps)} at steps "
          f"{[s for s, _ in caps]}; graph vs eager: {same}, capacities "
          f"equal; B1 400 launches by replays across the re-captures")
    print(f"compaction: Time taken compacting "
          f"{[time_taken(r['out']) for r in runs['compact']]} s, without "
          f"compaction {[time_taken(r['out']) for r in runs['plain']]} s "
          f"(turns compacting, plain, plain, compacting); peak device memory "
          f"allocated above the start {mib['compact']} MiB compacting, "
          f"{mib['plain']} MiB plain; reserved {mib['reserved_compact']} MiB "
          f"compacting, {mib['reserved_plain']} MiB plain; reserved after "
          f"each runner's close {mib['after_close']} MiB; host seconds of "
          f"the first compacting run: {seconds_text(g['result'])}")


def phase_resume(bh=False):
    """A straight graph run of 200 steps of the default scene
    (``checkpointEvery=100``) against 100 steps and ``--resume auto`` to
    200 in the same directory: the state bitwise, the log lines after step
    100 equal apart from the timings. With ``bh`` the same for
    ``forceModel=bh`` (every knob auto; graph windows too), where the
    resumed run adopts the checkpoint's knobs. Returns the straight run."""
    sets = ["--set", "checkpointEvery=100", "--no-images"]
    if bh:
        sets += ["--set", "forceModel=bh"]
    straight = cli_run(["--steps", "200"] + sets)
    with tempfile.TemporaryDirectory() as work:
        first = cli_run(["--steps", "100"] + sets, workdir=work)
        resumed = cli_run(["--steps", "200", "--resume", "auto"] + sets,
                          workdir=work)
    for r in (straight, first, resumed):
        check(r["rc"] == 0, f"resume run exited {r['rc']}")
        graph_windows_ran(r, "resume")
    label = "bh" if bh else "exact, graph windows"
    check(same_state(straight["result"].state, resumed["result"].state),
          f"resume ({label}): the resumed state differs from the straight "
          f"run's")
    check(strip_timings(straight["logs"], 100) == strip_timings(
        resumed["logs"]), f"resume ({label}): log lines after step 100 "
          f"differ")
    knobs = [l for l in resumed["out"].splitlines()
             if l.startswith("resumed bh knobs")]
    check(not bh or len(knobs) == 1, "no 'resumed bh knobs' line")
    extra = f"; {knobs[0]}" if bh else (
        f"; B1 {resumed['launches']} launches in the 100 resumed steps")
    if bh:
        check(all(r["bh_overflow"] == 0 for r in straight["logs"]),
              "resume (bh): bh_overflow")
    print(f"resume ({label}, default scene): 200 steps straight against 100 "
          f"+ --resume auto to 200: state bitwise equal, "
          f"{len(resumed['logs'])} log lines after step 100 equal apart from "
          f"the timings{extra}; Time taken straight "
          f"{time_taken(straight['out'])} s, resumed part "
          f"{time_taken(resumed['out'])} s")
    return straight


def phase_auto_resume_fault(reference):
    """autoResume on the graph path with a fault raised once between two
    replays at step 120, past the step-100 checkpoint: the run reloads it,
    captures its graphs anew and ends on the unfaulted run's state
    (``reference``, phase 29's straight run), bitwise."""
    from nbodyax_torch import driver
    real = driver._GraphWindows._replay
    raised = []

    def flaky(self, k, frames):
        if self.buf.step == 120 and not raised:
            raised.append(self.buf.step)
            raise RuntimeError("injected fault between replays")
        return real(self, k, frames)

    driver._GraphWindows._replay = flaky
    try:
        r = cli_run(["--steps", "200", "--no-images", "--set",
                     "checkpointEvery=100", "--set", "autoResume=true"])
    finally:
        driver._GraphWindows._replay = real
    check(r["rc"] == 0 and raised == [120],
          f"autoResume run: rc {r['rc']}, faults {raised}")
    retry = [l for l in r["out"].splitlines() if l.startswith("Run failed")]
    check(len(retry) == 1, f"retries: {retry}")
    check(same_state(r["result"].state, reference["result"].state),
          "autoResume: the state differs from the unfaulted run's")
    print(f"autoResume, fault between replays at step 120: {retry[0]}; the "
          f"run ended at step {r['result'].state.step}, state bitwise equal "
          f"to the unfaulted run's; B1 {r['launches']} launches (200 steps "
          f"+ 20 redone)")


def checkpoints_in(work, sub="checkpoints"):
    d = os.path.join(work, sub)
    return sorted(int(n[5:14]) for n in os.listdir(d)
                  if n.startswith("step_") and n.endswith(".npz"))


def phase_galaxy_example(dev):
    """examples/galaxy_momentum.txt as shipped, cut to 1,000 steps:
    N = 65,536, momentum mode, B1 through graph windows, 40 frames,
    checkpoints at 0, 500 and 1,000; total mass conserved to f32
    rounding (rel 1e-6, from the states in float64); its first 100 steps
    (state, logs, frames) bitwise equal to the eager runner's; B1's device
    time a call at N = 65,536 on the scene, and the checkpoint seconds."""
    from nbodyax_torch.config import parse_config_file
    from nbodyax_torch.physics.kernels import (body_features,
                                               tile_accumulators_raw)
    from nbodyax_torch.scenes import init_scene
    cfg_path = os.path.join(EXAMPLES, "galaxy_momentum.txt")
    argv = ["--config", cfg_path]
    with tempfile.TemporaryDirectory() as work:
        r = cli_run(argv + ["--steps", "1000"], keep_frames=False,
                    workdir=work, image_dir="galaxy_img")
        cks = checkpoints_in(work)
    check(r["rc"] == 0 and r["launches"] == 1000 and len(r["frames"]) == 40,
          f"galaxy example: rc {r['rc']}, B1 {r['launches']}, "
          f"{len(r['frames'])} frames")
    check(cks == [0, 500, 1000], f"galaxy example checkpoints {cks}")
    cfg = parse_config_file(cfg_path)
    scene = init_scene(cfg, device=dev)
    m0 = float(scene.mass.double().sum())
    m1 = float(r["result"].state.mass.double().sum())
    rel = abs(m1 - m0) / m0
    check(rel <= 1e-6, f"galaxy example: total mass moved by {rel:.3e}")
    g = cli_run(argv + ["--steps", "100"], keep_frames=False,
                image_dir="galaxy_img")
    e = cli_run(argv + ["--steps", "100"], eager=True, keep_frames=False,
                image_dir="galaxy_img")
    same = same_run(g, e, "galaxy example, first 100 steps")
    check(strip_timings(r["logs"])[:4] == strip_timings(e["logs"]),
          "galaxy example: the 1,000-step run's first log lines differ from "
          "the eager runner's")
    feats = body_features(*scene[:4])
    kw = dict(mode="momentum", eps=cfg.softening, growth_rate=0.1)
    dms, detail = device_ms(
        lambda: tile_accumulators_raw(feats, feats, 0, 0, **kw), B1_TAGS)
    res = r["result"]
    print(f"galaxy example (N=65536, momentum, cut to --steps 1000): Time "
          f"taken {time_taken(r['out'])} s, {res.windows} windows, 40 frames,"
          f" checkpoints at {cks} ({res.seconds['checkpoints'] / 3:.4f} s a "
          f"save); alive {r['logs'][-1]['alive']}; total mass rel change "
          f"{rel:.3e} (gate 1e-6); first 100 steps vs eager: {same}; host "
          f"seconds {seconds_text(res)}")
    print(f"galaxy example: B1 momentum mode at N=65536 on the scene "
          f"{dms:.4f} ms a call by the profiler ({detail})")


def phase_million_example():
    """examples/million_bodies.txt as shipped (exact, N = 1,048,576, no
    frames, compactEvery=50 checkpointEvery=100 autoResume=true), cut to
    ``--steps 20 --set checkpointEvery=10``: the native scene fill against
    the pure-Python draw (bitwise, seconds of each), the seconds a
    checkpoint takes, whether compaction fired, ``Time taken``; then a
    resume from the step-10 checkpoint into a checkpoint directory of its
    own to step 20, bitwise equal to the straight run."""
    from nbodyax_torch import native
    from nbodyax_torch.config import parse_config_file
    from nbodyax_torch.rng import scene_arrays
    cfg_path = os.path.join(EXAMPLES, "million_bodies.txt")
    cfg = parse_config_file(cfg_path)
    check(native.available(), "the C++ scene fill did not build")
    args = (cfg.seed, cfg.particle_count, cfg.field_width, cfg.field_height,
            cfg.min_body_mass, cfg.max_body_mass, cfg.min_radius,
            cfg.max_radius)
    t0 = time.perf_counter()
    fast = scene_arrays(*args)
    t1 = time.perf_counter()
    slow = scene_arrays(*args, native=False)
    t2 = time.perf_counter()
    check(all(np.array_equal(a, b) for a, b in zip(fast, slow)),
          "the native 1M scene differs from the pure-Python draw")
    argv = ["--config", cfg_path, "--steps", "20", "--set",
            "checkpointEvery=10"]
    with tempfile.TemporaryDirectory() as work:
        r = cli_run(argv, workdir=work)
        cks = checkpoints_in(work)
        ck10 = os.path.join(work, "checkpoints", "step_000000010.npz")
        resumed = cli_run(argv + ["--resume", ck10, "--set",
                                  "checkpointPath=resumed_ck"], workdir=work)
        cks2 = checkpoints_in(work, "resumed_ck")
    res = r["result"]
    check(r["rc"] == 0 and resumed["rc"] == 0 and r["launches"] == 20
          and resumed["launches"] == 10,
          f"million example: rc {r['rc']}, {resumed['rc']}, B1 "
          f"{r['launches']}, {resumed['launches']} launches")
    check(cks == [0, 10, 20] and cks2 == [20],
          f"million example checkpoints {cks}, resumed {cks2}")
    check(same_state(res.state, resumed["result"].state),
          "million example: the resumed state differs from the straight "
          "run's")
    check(all(np.isfinite(v) for v in r["logs"][-1].values()
              if isinstance(v, float)), f"non-finite log: {r['logs'][-1]}")
    fired = (f"fired: {res.capacities}" if res.capacities
             else "did not fire")
    print(f"million example (exact, N=1048576; cuts: --steps 20, --set "
          f"checkpointEvery=10): Time taken {time_taken(r['out'])} s, "
          f"{r['logs'][-1]['alive']} alive, compaction {fired}"
          f" (a shrink needs fewer than 419,431 alive); checkpoints at {cks},"
          f" {res.seconds['checkpoints'] / 3:.4f} s a save; host seconds "
          f"{seconds_text(res)}")
    print(f"million example: scene N=1048576 seed {cfg.seed} native "
          f"{t1 - t0:.4f} s, pure Python {t2 - t1:.4f} s, bitwise equal; "
          f"resumed from step 10 into a checkpoint directory of its own: "
          f"state bitwise equal to the straight run's, Time taken "
          f"{time_taken(resumed['out'])} s")


def scene_fingerprint(arrays):
    """(mass, radius, |pos|) sums of a scene's numpy arrays, each exactly
    rounded (``math.fsum``), so any summation order gives the same."""
    return tuple(math.fsum(np.abs(arrays[k]).astype(np.float64).ravel()
                           .tolist()) for k in ("mass", "radius", "pos"))


# nbodyax's own draw of two full-size scenes (parity=False), as
# scene_fingerprint reads it, made on the CPU from the repo's root with
#   JAX_PLATFORMS=cpu python -c "import chip_smoke as c, nbodyax.config as f
#   import nbodyax.scenes as s, nbodyax.state as t
#   for kw in c.FINGERPRINT_SCENES.values(): print(repr(c.scene_fingerprint(
#       t.to_numpy(s.init_scene(f.SimConfig(**kw), parity=False)))))"
FINGERPRINT_SCENES = {
    "suite config 5 galaxy N=4194304": dict(particle_count=1 << 22,
                                            scene="galaxy"),
    "suite config 4 uniform N=1048576": dict(particle_count=1 << 20),
}
NBODYAX_FINGERPRINTS = {
    "suite config 5 galaxy N=4194304": (
        2.0972692261161995e+21, 4838882.816135585, 149746405737.98813),
    "suite config 4 uniform N=1048576": (
        5.240416690902343e+22, 131000241.76495361, 104860228068.0489),
}


def timed_scene(dev, kw):
    """(the ``parity=False`` scene of ``SimConfig(**kw)`` on ``dev``, its
    set-up seconds): ``init_scene`` as the driver times it for
    ``seconds["scene"]``, fenced."""
    from nbodyax_torch.config import SimConfig
    from nbodyax_torch.scenes import init_scene
    torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = init_scene(SimConfig(**kw), device=dev, parity=False)
    torch.cuda.synchronize()
    return st, time.perf_counter() - t0


def phase_scene_draws(dev):
    """Every scene at the default size drawn on the card is bitwise the
    CPU's; the full-size fingerprints equal nbodyax's (mass and radius
    sums exactly, |pos| within 1e-6: cos and sin may differ by an ulp)."""
    from nbodyax_torch.config import SimConfig
    from nbodyax_torch.scenes import init_scene
    from nbodyax_torch.state import to_numpy
    for scene in ("three_body", "galaxy", "plummer", "uniform"):
        for dims in (2, 3):
            cfg = SimConfig(scene=scene, dimensions=dims)
            a, b = (init_scene(cfg, device=d, parity=False)
                    for d in (dev, "cpu"))
            check(all(torch.equal(x.cpu(), y) for x, y in zip(a[:4], b[:4])),
                  f"{scene} {dims}-D: the card's draw is not the CPU's")
    print("scenes drawn on the card and on the CPU: bitwise equal "
          "(three_body, galaxy, plummer, uniform parity=False; 2-D, 3-D)")
    for label, kw in FINGERPRINT_SCENES.items():
        st, seconds = timed_scene(dev, kw)
        got = scene_fingerprint(to_numpy(st))
        want = NBODYAX_FINGERPRINTS[label]
        check(got[:2] == want[:2],
              f"{label}: mass, radius sums {got[:2]} != nbodyax's {want[:2]}")
        rel = abs(got[2] - want[2]) / want[2]
        check(rel <= 1e-6, f"{label}: |pos| sum {got[2]} against nbodyax's "
                           f"{want[2]}, {rel:.2e} relative")
        print(f"{label}: set-up {seconds:.3f} s on the card; mass "
              f"{got[0]!r}, radius {got[1]!r} (nbodyax's, equal), |pos| "
              f"{got[2]!r} ({rel:.2e} from nbodyax's)")


def phase_scenes(dev):
    """three_body, galaxy and plummer in 2-D and 3-D and uniform without
    parity (2-D) for 50 steps of the default config each (a frame every
    10), graph windows against the eager runner, bitwise; then the scenes'
    draws (``phase_scene_draws``)."""
    from nbodyax_torch.config import SimConfig
    from nbodyax_torch.scenes import init_scene
    rows = []
    cases = [(sc, d) for sc in ("three_body", "galaxy", "plummer")
             for d in (2, 3)] + [("uniform", 2)]
    for scene, dims in cases:
        cfg = SimConfig(total_iterations=50, scene=scene, dimensions=dims)
        state = init_scene(cfg, device=dev, parity=scene != "uniform")
        g, e = run_pair(cfg, state)
        label = f"{scene} {dims}-D" + (" parity=False" if scene == "uniform"
                                       else "")
        same_run(g, e, label)
        check(g["launches"] == e["launches"] == 50,
              f"{label}: B1 {g['launches']}, {e['launches']} launches")
        rows.append(f"{label} N={state.capacity} {g['logs'][-1]['alive']}")
    print(f"scenes, 50 steps, graph vs eager: state, logs and frames "
          f"bitwise equal, B1 50 launches each; alive at the end: "
          f"{', '.join(rows)}")
    phase_scene_draws(dev)


def phase_bh_compaction():
    """The default scene with ``forceModel=bh compactEvery=50`` for 200
    steps through graph windows: the capacities, the knobs re-resolved
    after each shrink, ``bh_overflow`` 0 at every log line, B3 and B5 once
    a step by replays across the re-captures."""
    from nbodyax_torch.physics.near_kernel import slots_near
    from nbodyax_torch.physics.slotpack_kernel import pack_slots
    slots_near.launches = pack_slots.moment_launches = 0
    r = cli_run(["--steps", "200", "--no-images", "--set", "forceModel=bh",
                 "--set", "compactEvery=50"])
    b3, b5 = slots_near.launches, pack_slots.moment_launches
    caps = r["result"].capacities if r["result"] else []
    knobs = [l for l in r["out"].splitlines() if l.startswith("bh auto")]
    check(r["rc"] == 0 and len(caps) >= 1, f"bh compaction: rc {r['rc']}, "
          f"capacities {caps}")
    graph_windows_ran(r, "bh compaction")
    check(len(knobs) == 1 + len(caps), f"bh knob lines {knobs}")
    check(all(rec["bh_overflow"] == 0 for rec in r["logs"]),
          f"bh_overflow {[rec['bh_overflow'] for rec in r['logs']]}")
    check(b3 == 200 and b5 == 200, f"bh compaction: B3 {b3}, B5 {b5} "
          f"launches in 200 steps")
    print(f"bh compaction (default scene, 200 steps, compactEvery=50): "
          f"capacity 16384 -> {' -> '.join(str(c) for _, c in caps)} at "
          f"steps {[s for s, _ in caps]}; knobs {knobs}; bh_overflow 0 at "
          f"{len(r['logs'])} log lines; B3 {b3} and B5 {b5} launches; Time "
          f"taken {time_taken(r['out'])} s")


def graph_windows_ran(r, label):
    """The run went through graph windows: it captured."""
    res = r["result"]
    check(res is not None and res.seconds["capture"] > 0,
          f"{label}: no CUDA graph was captured")


@contextlib.contextmanager
def recorded_captures():
    """Every graph capture of the driver while inside: [(window size,
    frames, seconds, (nodes with an IF node as one, IF nodes, nodes in
    their bodies))]."""
    from nbodyax_torch import driver
    real = driver._GraphWindows._capture
    got = []

    def capture(self, k, frames):
        t0 = time.perf_counter()
        out = real(self, k, frames)
        got.append((k, frames, time.perf_counter() - t0,
                    self.nodes[k, frames]))
        return out

    driver._GraphWindows._capture = capture
    try:
        yield got
    finally:
        driver._GraphWindows._capture = real


@contextlib.contextmanager
def recorded_tiers():
    """For an eager run, each step's completion tier (by its list's real
    entries) and its qualifying giants, read on the host: [(tier, real
    entries, list length)] and [qualifying giants]."""
    from nbodyax_torch.physics import barneshut as tbh
    real_init, real_key = tbh._Tiers.__init__, tbh._giant_key
    tiers, giants = [], []

    def init(self, ps, n):
        real_init(self, ps, n)
        k = int((ps < n).sum())
        tiers.append(("none" if k == 0 else "1024" if k <= min(
            tbh._COMP_TIER, ps.shape[0]) else "full", k, ps.shape[0]))

    def key(*a, **kw):
        out = real_key(*a, **kw)
        giants.append(int((out > 0).sum()))
        return out

    tbh._Tiers.__init__, tbh._giant_key = init, key
    try:
        yield tiers, giants
    finally:
        tbh._Tiers.__init__, tbh._giant_key = real_init, real_key


def bh_graph_runs(text, steps, label, arrays=None, argv=(),
                  turns=("graph", "eager", "eager", "graph"), gated=True,
                  tiers=True):
    """One config through graph windows and the eager runner in ``turns``,
    through the CLI (``text`` as its config file, or the ``--config`` in
    ``argv``) or, from the state ``arrays``, the driver; with ``tiers`` one
    eager run more, untimed, that reads each step's tiers on the host, so
    the timed runs are the plain A/B path. Every run's state and logs
    (timings aside) bitwise equal. ``gated``: B3 and B5 once a step and
    bh_overflow 0; else (a merging run, whose knobs move) B3 and B5 launched
    as often in every run. Returns {"graph": [...], "eager": [...],
    "tiers": [...]} of dicts with the host wall a step (ms, captures
    excluded), Time taken, the peak device memory, the captures, B3's and
    B5's launches and (the tiers run) the tiers a step."""
    from nbodyax_torch import driver
    from nbodyax_torch.config import parse_config_text
    from nbodyax_torch.physics.near_kernel import slots_near
    from nbodyax_torch.physics.slotpack_kernel import pack_slots
    from nbodyax_torch.state import make_state
    runs = {"graph": [], "eager": [], "tiers": []}
    for which in turns + (("tiers",) if tiers else ()):
        eager = which != "graph"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        slots_near.launches = pack_slots.moment_launches = 0
        with recorded_captures() as caps, (
                recorded_tiers() if which == "tiers" else
                contextlib.nullcontext(((), ()))) as (tier, giants):
            if arrays is None:
                r = cli_run(list(argv), cfg_text=text, eager=eager)
            else:
                with tempfile.TemporaryDirectory() as tmp:
                    cfg = dataclasses.replace(
                        parse_config_text(text),
                        log_path=os.path.join(tmp, "log.jsonl"))
                    res = driver.run_simulation(
                        cfg, device="cuda", quiet=True,
                        state=make_state(*arrays, device="cuda"),
                        _eager=eager)
                    with open(cfg.log_path) as f:
                        logs = [json.loads(x) for x in f]
                r = {"rc": 0, "result": res, "logs": logs,
                     "out": f"Time taken: {res.wall_seconds:.4f}"}
        b3, b5 = slots_near.launches, pack_slots.moment_launches
        check(r["rc"] == 0, f"{label} {which}: exited {r['rc']}")
        if gated:
            check(b3 == steps and b5 == steps, f"{label} {which}: B3 {b3} "
                  f"and B5 {b5} launches in {steps} steps")
            check(all(x["bh_overflow"] == 0 for x in r["logs"]),
                  f"{label} {which}: bh_overflow "
                  f"{[x['bh_overflow'] for x in r['logs']]}")
        if not eager:
            graph_windows_ran(r, f"{label} {which}")
        res = r["result"]
        runs[which].append({
            "r": r, "wall": res.seconds["windows"] / steps * 1e3,
            "taken": time_taken(r["out"]), "capture": res.seconds["capture"],
            "peak": torch.cuda.max_memory_allocated(), "caps": caps,
            "b3": b3, "b5": b5, "tiers": list(tier), "giants": list(giants)})
    first = runs["graph"][0]
    for run in runs["graph"][1:] + runs["eager"] + runs["tiers"]:
        check(same_state(first["r"]["result"].state, run["r"]["result"].state),
              f"{label}: graph and eager windows end on different states")
        check(strip_timings(first["r"]["logs"])
              == strip_timings(run["r"]["logs"]),
              f"{label}: graph and eager log lines differ")
        check((run["b3"], run["b5"]) == (first["b3"], first["b5"]),
              f"{label}: B3, B5 launched {run['b3']}, {run['b5']} times in "
              f"one run and {first['b3']}, {first['b5']} in another")
    return runs


def break_even(label, g, e):
    """The run length at which graph windows pay back their captures: a
    graph run's capture seconds over the host wall a step they save."""
    cap = sum(x["capture"] for x in g) / len(g)
    saved = (sum(x["wall"] for x in e) / len(e)
             - sum(x["wall"] for x in g) / len(g))
    print(f"{label}: graph windows break even after "
          + (f"{cap / saved * 1e3:.1f} steps" if saved > 0 else "no run "
             "length (no step saved)")
          + f" ({cap:.4f} s of capture a run against {saved:.4f} ms of host "
          f"wall saved a step)")


def giant_tier_costs(state, levels=8):
    """The giant pass's tiers at N = 1M (the 2-D bh million scene, its
    first 12 bodies grown to radius 5e4, far past half a level-8 cell):
    each tier's body by CUDA events, called eagerly and replayed as a CUDA
    graph of its own (what a bh graph window pays for it)."""
    from nbodyax_torch.physics import barneshut as tbh
    from nbodyax_torch.physics.bh_grid import _extent
    from nbodyax_torch.physics.pairwise import (PairAccumulators,
                                                empty_accumulators)
    pos, vel, mass, radius = (t.clone() for t in state[:4])
    n = pos.shape[0]
    radius[:12] = 5e4
    ext = _extent(pos, mass > 0)
    key = tbh._giant_key(mass, radius, ext, levels, 1)
    ids = torch.arange(n, dtype=torch.int32, device=pos.device)
    got = {}
    for count in (tbh._GIANT_TIER, 1024):
        into = PairAccumulators(*(t.clone() for t in empty_accumulators(
            ids)))

        def tier():
            tbh._giant_tier(pos, vel, mass, radius, key, count, ext=ext,
                            levels=levels, ring=1, growth_rate=0.1,
                            mode="reference", chunk=8192, into=into)

        eager = time_ms(tier, reps=3, warm=1)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            tier()
        got[count] = (eager, time_ms(graph.replay, reps=5, warm=1))
        del graph
    print(f"giant pass N={n}, {int((key > 0).sum())} qualifying (CUDA "
          f"events; a step with no qualifying body skips both tiers): the "
          f"{tbh._GIANT_TIER}-entry tier {got[tbh._GIANT_TIER][0]:.4f} ms "
          f"a call eagerly, {got[tbh._GIANT_TIER][1]:.4f} ms a graph "
          f"replay; the 1,024-entry tier {got[1024][0]:.4f} ms, "
          f"{got[1024][1]:.4f} ms")


def phase_bh_graphs(dev, dims):
    """Phase 34: the bh million CLI (examples/million_bodies.txt's scene,
    default bh knobs, 20 steps) through graph windows against the eager
    runner in turns, and the run length at which the graphs break even;
    examples/galaxy_momentum.txt with forceModel=bh and compactEvery=50
    (in 2-D it merges and compacts, in 3-D bhAdapt retunes its knobs: each
    a new capture), cut to 400 steps in 2-D and 50 in 3-D, graph against
    eager; in 2-D also a crowded N = 262,144 state (a
    quarter of the bodies in one patch) through the driver, graph against
    eager, and the giant tiers' cost; and a profiled 10-step graph window
    against 10 eager steps."""
    from nbodyax_torch import driver
    from nbodyax_torch.scenes import init_scene
    cfg = million_config(dimensions=dims)
    text = config_text(cfg)
    steps = cfg.total_iterations
    label = f"bh million {dims}-D"
    runs = bh_graph_runs(text, steps, label)
    g, e = runs["graph"], runs["eager"]
    print(f"{label}: {steps} steps, graph and eager bitwise equal (state, "
          f"logs), B3 and B5 once a step by replays; host wall a step graph "
          f"{[round(x['wall'], 4) for x in g]} ms, eager "
          f"{[round(x['wall'], 4) for x in e]} ms (turns graph, eager, "
          f"eager, graph); Time taken graph {[x['taken'] for x in g]} s, "
          f"eager {[x['taken'] for x in e]} s; peak device memory graph "
          f"{[round(x['peak'] / 2 ** 30, 3) for x in g]} GiB, eager "
          f"{[round(x['peak'] / 2 ** 30, 3) for x in e]} GiB")
    for x in g:
        print(f"{label}: captures (window, frames, seconds, (nodes, IF "
              f"nodes, nodes in IF bodies)) "
              f"{[(k, f, round(t, 3), nd) for k, f, t, nd in x['caps']]}; "
              f"capture seconds of the run {x['capture']:.3f}")
    break_even(label, g, e)
    print(f"{label}: completion tier a step (tier, real entries, list "
          f"length) {runs['tiers'][0]['tiers']}; qualifying giants a step "
          f"{runs['tiers'][0]['giants']}")

    mlabel = f"bh galaxy {dims}-D"
    merge_steps = 400 if dims == 2 else 50
    argv = ["--config", os.path.join(EXAMPLES, "galaxy_momentum.txt"),
            "--steps", str(merge_steps), "--no-images", "--set",
            "forceModel=bh", "--set", "compactEvery=50", "--set",
            f"dimensions={dims}"]
    mr = bh_graph_runs(None, merge_steps, mlabel, argv=argv,
                       turns=("graph", "eager"), gated=False, tiers=False)
    mg, me = mr["graph"][0], mr["eager"][0]
    logs = mg["r"]["logs"]
    print(f"{mlabel} (galaxy example with forceModel=bh compactEvery=50, "
          f"{merge_steps} steps, no frames): graph and eager bitwise equal (state, logs), "
          f"B3 {mg['b3']} and B5 {mg['b5']} launches in each; alive "
          f"{logs[0]['alive']} -> {logs[-1]['alive']}; capacities "
          f"{mg['r']['result'].capacities}; Time taken graph {mg['taken']} "
          f"s, eager {me['taken']} s; host wall a step (captures excluded) "
          f"graph {mg['wall']:.4f} ms, eager {me['wall']:.4f} ms; "
          f"{len(mg['caps'])} captures, {mg['capture']:.4f} s in all "
          f"({[round(t, 3) for _, _, t, _ in mg['caps']]}); bh_overflow at "
          f"the log lines {[x['bh_overflow'] for x in logs]}")

    if dims == 2:
        ctext = config_text(million_config(particle_count=1 << 18))
        cr = bh_graph_runs(ctext, steps, "bh crowded 2-D N=262144",
                           arrays=crowded_state(1 << 18, 4, 1e6))
        caps = cr["graph"][0]["caps"]
        print(f"bh crowded 2-D N=262144: graph and eager bitwise equal; "
              f"host wall a step graph "
              f"{[round(x['wall'], 4) for x in cr['graph']]} ms, eager "
              f"{[round(x['wall'], 4) for x in cr['eager']]} ms; completion "
              f"tier a step {cr['tiers'][0]['tiers']}; qualifying giants a "
              f"step {cr['tiers'][0]['giants']}; captures "
              f"{[(k, round(t, 3), nd) for k, _, t, nd in caps]}")

    state = init_scene(cfg, device=dev)
    if dims == 2:
        giant_tier_costs(state)
    rcfg = driver.resolve_bh_config(cfg, state)
    step = driver.build_step(rcfg, dev)
    runner = driver._GraphWindows(step, state, rcfg, 0, 10, None)
    eager = driver._EagerWindows(step, state, rcfg, 0)
    got = {}
    for name, r in (("graph", runner), ("eager", eager)):
        dms, ops, _, busy, span = profile_breakdown(
            lambda: r.advance(10, False), 1,
            f"{label}, a 10-step {name} window", detail=True)
        # without the profiler, which slows graph replays most: CUDA events
        ev = time_ms(lambda: r.advance(10, False), reps=3, warm=1)
        got[name] = (dms / 10, ops / 10, ev / 10, busy / span, span / 10)
    (gd, gk, gw, gb, gs), (ed, ek, ew, eb, es) = got["graph"], got["eager"]
    print(f"{label}: on the profiled window's timeline (the gaps between "
          f"its kernels) the device idles {100 * (1 - gb):.2f}% of a graph "
          f"window, whose span is {gs:.4f} ms a step under the profiler "
          f"against {gw:.4f} ms by CUDA events without it, and "
          f"{100 * (1 - eb):.2f}% of an eager one ({es:.4f} against "
          f"{ew:.4f} ms): the timeline holds only where the two spans agree; "
          f"a step's kernel time graph {gd:.4f} ms, eager {ed:.4f} ms (the "
          f"profiler's sum); kernels a step graph {gk:.1f}, eager {ek:.1f}; "
          f"1 - kernel sum / events without the profiler, signed (two "
          f"measures, which disagree where it is negative): graph "
          f"{100 * (1 - gd / gw):.1f}%, eager {100 * (1 - ed / ew):.1f}%")
    runner.close()


def runner_lines(module, timeout):
    """``python -m module`` from the checkout in a process of its own:
    (its JSON lines, its wall seconds). Fails on a non-zero exit."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", module], cwd=HERE,
                       capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    check(r.returncode == 0, f"{module} exited {r.returncode}: "
                             f"{r.stderr[-3000:]}")
    return [json.loads(l) for l in r.stdout.splitlines()
            if l.startswith("{")], wall


def phase_runners():
    """The benchmark runners at full size, each in its own process:
    ``nbodyax_torch.bench`` (N = 1,048,576, graph replays) and
    ``nbodyax_torch.bench_suite``'s six configs. Gates: config 1 matches
    the oracle, config 2 keeps its mass exactly and every body, config 3
    agrees with the oracle on every merge, every run is finite, every
    rate positive, and each path launched its kernels (B1 in bench and
    configs 1-5, B3 and B5 in configs 5-6)."""
    (bench,), wall = runner_lines("nbodyax_torch.bench", 600)
    print(json.dumps(bench))
    print(f"nbodyax_torch.bench: {wall:.1f} s of wall in its process")
    check(bench["n"] == 1 << 20 and bench["reps"] >= 5
          and bench["value"] > 0, f"bench line: {bench}")
    check(bench["launches"]["pair_kernel"] >= bench["reps"] + 1,
          f"bench: B1 launched {bench['launches']}")
    suite, wall = runner_lines("nbodyax_torch.bench_suite", 900)
    for line in suite:
        print(json.dumps(line))
    by = {line["config"]: line for line in suite}
    print(f"nbodyax_torch.bench_suite: {wall:.1f} s of wall in its process "
          f"against {sum(x['bench_wall_s'] for x in suite):.1f} s of "
          f"bench_wall_s")
    check(sorted(by) == [1, 2, 3, 4, 5, 6], f"suite configs {sorted(by)}")
    check(by[1]["oracle_match_f32"] is True, f"config 1: {by[1]}")
    check(by[2]["mass_rel_drift"] == 0 and by[2]["alive"] == by[2]["n"],
          f"config 2: {by[2]}")
    check(by[3]["oracle_alive_agreement_2steps"] == 1.0, f"config 3: {by[3]}")
    for line in suite:
        c = line["config"]
        check(line.get("finite", True) is True, f"config {c} not finite")
        rates = {k: v for k, v in line.items() if k.endswith("_per_sec")}
        check(rates and all(v > 0 for v in rates.values()),
              f"config {c} rates {rates}")
        want = (["pair_kernel"] * (c <= 5)
                + ["near_kernel", "slot_pack_moments_kernel"] * (c >= 5))
        check(all(line["launches"][k] > 0 for k in want),
              f"config {c} launches {line['launches']}")
    check(by[5]["ring_dryrun_8dev_ok"] is True,
          f"config 5's 8-rank ring dry run failed: {by[5]}")
    print(f"config 5's ring dry run: 8 gloo ranks on the host's CPU, "
          f"{by[5]['ring_dryrun_wall_s']:.1f} s of launch wall")


BENCH_COUNTERPARTS = (
    ("bench_grad_step", "--n", "16384", "--steps", "2"),
    ("bench_modes", "--n", "16384"),
    ("bench_near_ab", "uniform", "1", "2", "65536"))


def phase_bench_counterparts():
    """42: the counterparts of three ``bench/`` runners at small sizes,
    each through its ``main`` in this process, one after another (a
    process of its own would spend about 10 s reaching the card):
    ``nbodyax_torch.bench_grad_step`` (N = 16,384, 2 euler steps,
    reference mode), ``bench_modes`` (N = 16,384, reference, momentum and
    elastic) and ``bench_near_ab`` (N = 65,536, 2-D uniform, one round).
    Gates, as phase 35 gates ``bench``'s line: every rate and time
    positive, every state finite, a finite nonzero gradient, and each path
    launched its kernels: a gradient replay B1 twice a step (the forward
    and the backward's re-run) and B2 twice a step (its two counted
    sides), each mode B1 once a window, the slots engine B3 and B5 once a
    window and the rows engine neither. Their full sizes run as ``python
    -m`` processes of their own (README)."""
    import importlib
    runs = []
    for name, *args in BENCH_COUNTERPARTS:
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = importlib.import_module(f"nbodyax_torch.{name}").main(args)
        check(rc == 0, f"{name} returned {rc}")
        lines = [json.loads(l) for l in out.getvalue().splitlines()
                 if l.startswith("{")]
        for line in lines:
            print(json.dumps(line))
        print(f"{name} {' '.join(args)}: {time.perf_counter() - t0:.1f} s")
        runs.append(lines)
    (grad,), modes, (near,) = runs
    rep = grad["launches_a_replay"]
    check(grad["n"] == 16384 and grad["steps"] == 2
          and math.isfinite(grad["grad_abs_sum"]) and grad["grad_abs_sum"] > 0
          and grad["grad_wall_s"] > 0 and grad["forward_step_s"] > 0,
          f"bench_grad_step: {grad}")
    check(rep["pair_kernel"] == 4 and rep["pair_bwd_kernel"] == 4,
          f"bench_grad_step: a replay launched {rep}")
    check([m["mode"] for m in modes] == ["reference", "momentum", "elastic"],
          f"bench_modes: modes {[m['mode'] for m in modes]}")
    for m in modes:
        check(m["finite"] and m["steps_per_sec"] > 0
              and m["pairs_per_sec"] > 0
              and m["launches"]["pair_kernel"] == m["reps"] + 1,
              f"bench_modes: {m}")
    rows, slots = near["rows"], near["slots"]
    check(near["rows_step_s"] > 0 and near["slots_step_s"] > 0
          and rows["finite"] and slots["finite"]
          and rows["knobs"]["bh_near"] == "rows"
          and slots["knobs"]["bh_near"] == "slots", f"bench_near_ab: {near}")
    check(rows["launches"]["near_kernel"] == 0
          and slots["launches"]["near_kernel"] == near["reps"] + 1
          and slots["launches"]["slot_pack_moments_kernel"]
          == near["reps"] + 1, f"bench_near_ab launches: rows "
                               f"{rows['launches']}, slots "
                               f"{slots['launches']}")


def phase_dense_bh_tiers(dev, steps=4):
    """Where suite config 6's step goes (the uniform 1M scene in the
    default 1e5 field under bh, 100 times the million example's density):
    an eager run of its own, untimed, reads each step's completion tier
    and qualifying giants, and a profile of one more eager step gives its
    heaviest kernels."""
    from nbodyax_torch import bench_suite
    from nbodyax_torch.driver import build_step, resolve_bh_config
    cfg, _, state = bench_suite._setup(
        dev, force_model="bh", particle_count=1 << 20,
        collision_mode="reference", softening=100.0)
    cfg = resolve_bh_config(cfg, state)
    step = build_step(cfg, dev)
    with recorded_tiers() as (tiers, giants):
        for _ in range(steps):
            state = step(state)
    print(f"suite config 6's scene, eager: tiers {tiers}, qualifying "
          f"giants {giants} over {steps} steps")
    profile_breakdown(lambda: step(state), 1, "suite config 6, one eager "
                      f"step after {steps}", top=8)


def phase_shooting_example():
    """examples/shooting_gradient_torch.py on the card, each gradient a
    replay of its CUDA graph: miss^2 falls below 1% of its first value,
    through B1 forward and B2 backward (both counts set to 0 before the
    run and read after it); then the example's first gradient op by op
    (``problem(device, eager=True)``): value and gradient bitwise the
    graph's, and one call timed each way."""
    import runpy
    from nbodyax_torch.physics.kernels import tile_accumulators_raw
    from nbodyax_torch.physics.kernels_bwd import raw_backward
    example = runpy.run_path(os.path.join(HERE, "examples",
                                          "shooting_gradient_torch.py"))
    tile_accumulators_raw.launches = raw_backward.launches = 0
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = example["main"](["--device", "cuda"])
    wall = time.perf_counter() - t0
    b1, b2 = tile_accumulators_raw.launches, raw_backward.launches
    print(buf.getvalue().rstrip())
    miss = [float(v) for v in re.findall(r"miss\^2 = ([0-9.]+)",
                                         buf.getvalue())]
    print(f"shooting example, graph: {wall:.2f} s, {b1} B1 and {b2} B2 "
          f"launches, miss^2 {miss[0]} -> {miss[-1]}")
    check(rc == 0 and len(miss) == 6, f"shooting example: rc {rc}, {miss}")
    check(miss[-1] < 0.01 * miss[0], f"shooting example: miss^2 {miss}")
    check(b1 > 0 and b2 > 0, f"shooting example: {b1} B1, {b2} B2 launches")
    firsts, ms = [], []
    for eager in (False, True):
        v0, vg = example["problem"]("cuda", eager)
        val, g = vg(v0)
        firsts.append((val.clone(), g.clone()))
        ms.append(time_ms(lambda: vg(v0), reps=3, warm=0))
        vg.close()
    first_same = all(torch.equal(a, b) for a, b in zip(*firsts))
    print(f"shooting example: {wall:.2f} s graphed; one gradient "
          f"{ms[0]:.3f} ms graphed, {ms[1]:.3f} ms eager (CUDA events, "
          f"warm); first value and gradient bitwise {first_same}")
    check(first_same, "shooting example: the graphed gradient left the "
                      "eager one")


def phase_debug_nans():
    """``--debug-nans`` on the card: a state whose body 0 overflows f32
    (velocity 1e38, open boundaries) turns NaN after step 19, and the CLI
    exits non-zero with ``FloatingPointError`` naming that step, as
    ``nbodyax``'s flag does on the CPU (tests/test_torch_debug_nans.py); the
    default scene for 20 steps with frames gives the same final state, logs
    and frames with the flag as without it, bit for bit."""
    from nbodyax_torch.io.checkpoint import save_checkpoint
    from nbodyax_torch.state import make_state
    rng = np.random.RandomState(3)
    vel = np.zeros((16, 2), np.float32)
    vel[0, 0] = 1e38
    state = make_state(rng.uniform(-2000, 2000, (16, 2)).astype(np.float32),
                       vel, rng.uniform(1e4, 1e15, 16).astype(np.float32),
                       rng.uniform(5, 20, 16).astype(np.float32),
                       device="cpu")
    with tempfile.TemporaryDirectory() as tmp:
        save_checkpoint(os.path.join(tmp, "ck"), state, keep_last=0)
        ck = os.path.join(tmp, "ck", os.listdir(os.path.join(tmp, "ck"))[0])
        env = dict(os.environ, PYTHONPATH=HERE)
        r = subprocess.run(
            [sys.executable, "-m", "nbodyax_torch.cli", "--debug-nans",
             "--resume", ck, "--steps", "40", "--no-images", "--quiet",
             "--set", "logEvery=1", "--set", "boundaryMode=none",
             "--set", "particleCount=16"], cwd=tmp, env=env,
            capture_output=True, text=True, timeout=300)
    err = r.stderr.strip().splitlines()
    print(f"--debug-nans on an overflowing state: exit {r.returncode}, "
          f"{err[-1] if err else ''}")
    check(r.returncode != 0 and "FloatingPointError" in r.stderr
          and "after step 19 " in r.stderr,
          f"--debug-nans: exit {r.returncode}, {r.stderr[-2000:]}")
    argv = ["--steps", "20"]
    on, off = cli_run(argv + ["--debug-nans"]), cli_run(argv)
    check(on["rc"] == off["rc"] == 0, "--debug-nans: a clean run failed")
    print(f"--debug-nans on the default scene, 20 steps: "
          f"{same_run(on, off, '--debug-nans on and off')}")


# ---------------------------------------------------------------------------
# shards > 1: B3's cell slice, the cell-range bh evaluation, the ring fold
# and the port's collectives on CUDA tensors
# ---------------------------------------------------------------------------

def slice_pairs(st, g, dims, ci, S, base, ne):
    """Live near pairs of the cells [base, base + ne): each cell's live i
    slots against the live slots of its 3^dims window, clipped to the
    grid."""
    occ = (st[3] - st[2]).to(torch.int64).view((g,) * dims)
    pad = torch.nn.functional.pad(occ.clamp(max=S), (1, 1) * dims)
    window = sum(pad[tuple(slice(1 + o, 1 + o + g) for o in off)]
                 for off in itertools.product((-1, 0, 1), repeat=dims))
    return int((occ.clamp(max=ci) * window).reshape(-1)[base:base + ne].sum())


def phase_near_slice(dev, arrays_1m, arrays3_1m):
    """36. B3's cell-slice form: on the 2-D million scene (levels 8, S 40,
    ci 32) cut into P = 2, 4 and 8 slices and on the 3-D one (levels 5,
    S 80, ci 64) cut into 8, every slice against its plain version at B3's
    gates and the slices together bitwise equal to the full launch; the
    device time of one 1/8 slice beside the full launch's; a slice past
    the grid refused by the wrapper and by the C entry point. Returns the
    kernels-line row of the 2-D 1/8 slice (without launches)."""
    from nbodyax_torch.physics import _build
    from nbodyax_torch.physics.near_kernel import (slots_near,
                                                   slots_near_reference)
    from nbodyax_torch.physics.slotpack_kernel import pack_slots
    row = None
    worst = (0.0, 0.0)
    for dims, arrays, levels, S, ci, parts in (
            (2, arrays_1m, 8, 40, 32, (2, 4, 8)),
            (3, arrays3_1m, BH3D_LEVELS, BH3D_S, BH3D_CI, (8,))):
        _, _, st = bh_structure(arrays, dev, levels, False)
        g = 1 << levels
        ncells = g ** dims
        fslot = pack_slots(st[4], st[2], st[3], S)
        kw = dict(mode="reference", eps2=0.0, growth=0.1, g=g, ring=1,
                  ci=ci, dim=dims)
        full = slots_near(fslot, **kw)
        for P in parts:
            ne = ncells // P
            cat = []
            for r in range(P):
                err, ok, fe = near_compare(fslot, "reference", 0.0, g, 1, ci,
                                           dim=dims, cell_base=r * ne,
                                           ncells_eval=ne)
                check(ok, f"B3 slice {r}/{P} ({dims}-D) disagrees with its "
                          f"plain version: {err}")
                worst = tuple(map(max, worst, fe))
                cat.append(slots_near(fslot, cell_base=r * ne,
                                      ncells_eval=ne, **kw))
            same = bool(torch.equal(torch.cat(cat), full))
            print(f"B3 slices {dims}-D N=1M P={P}: every slice within "
                  f"{NEAR_GATE} of its plain version (worst force "
                  f"{worst[1]:.3e} of the largest), the {P} slices together "
                  f"bitwise equal to the full launch: {same}")
            check(same, f"B3's {P} slices ({dims}-D) differ from the full "
                        f"launch")
        ne = ncells // 8
        one = lambda: slots_near(fslot, cell_base=ne, ncells_eval=ne, **kw)
        whole = lambda: slots_near(fslot, **kw)
        d_slice, txt_s = device_ms(one, B3_TAGS)
        d_full, txt_f = device_ms(whole, B3_TAGS)
        print(f"B3 {dims}-D N=1M device time: 1/8 slice {d_slice:.4f} ms "
              f"({txt_s}), full launch {d_full:.4f} ms ({txt_f}); "
              f"slice/full {d_slice / d_full:.3f}")
        if dims == 2:
            t = {"kernel": [], "plain": []}
            plain = lambda: slots_near_reference(fslot, cell_base=ne,
                                                 ncells_eval=ne, **kw)
            for which in ("plain", "kernel", "kernel", "plain"):
                t[which].append(time_ms(one, reps=20) if which == "kernel"
                                else time_ms(plain, reps=5))
            reach = sum(g ** d for d in range(dims))
            nbytes = (min(ncells, ne + 2 * reach) * S * fslot.shape[2] * 4
                      + ne * ci * 8 * 4)
            pairs = slice_pairs(st, g, dims, ci, S, ne, ne)
            bound = bound_ms(pairs * B3_FLOPS_PER_PAIR, nbytes)
            row = {"ms": float(np.mean(t["kernel"])), "device_ms": d_slice,
                   "plain_ms": float(np.mean(t["plain"])),
                   "library_ms": None, "bound": bound}
            print(f"B3 1/8 slice 2-D N=1M: kernel {t['kernel']} ms, plain "
                  f"{t['plain']} ms, bound {bound[0]:.4f} ms ({bound[1]}; "
                  f"{pairs} live pairs), {100 * bound[0] / d_slice:.1f}% of "
                  f"the bound by device time")
        for base, cnt in ((ncells - ne + 1, ne), (-1, ne)):
            try:
                slots_near(fslot, cell_base=base, ncells_eval=cnt, **kw)
            except ValueError as e:
                refused = "leaves the grid" in str(e)
            else:
                refused = False
            check(refused, f"B3 took the slice [{base}, {base + cnt})")
        lib = _build.load_library()
        out = torch.empty((ne, ci, 8), dtype=torch.float32, device=dev)
        err = lib.nbodyax_slots_near(
            fslot.data_ptr(), g, 1, S, ci, fslot.shape[2], 256, 0, dims,
            0.0, 0.1, ncells - ne + 1, ne, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
        check(err == 1, f"the C entry point took a slice past the grid "
                        f"(returned {err}, want cudaErrorInvalidValue = 1)")
        print(f"B3 {dims}-D: a slice past the grid refused by the wrapper "
              f"(ValueError) and by nbodyax_slots_near "
              f"(cudaErrorInvalidValue)")
        del fslot, full, out
    return row, worst


def resolved(cfg, arrays, dev):
    """(``cfg`` with its bh knobs resolved from the state, the state)."""
    from nbodyax_torch.driver import resolve_bh_config
    from nbodyax_torch.state import make_state
    state = make_state(*arrays, device=dev)
    return resolve_bh_config(cfg, state), state


def exact_scene(dev, **kw):
    """(state, physics params) of a reference-mode exact config."""
    from nbodyax_torch.config import SimConfig
    from nbodyax_torch.physics.step import PhysicsParams
    from nbodyax_torch.scenes import init_scene
    cfg = SimConfig(collision_mode="reference", save_images=False, **kw)
    return (init_scene(cfg, device=dev, parity=False),
            PhysicsParams.from_config(cfg))


def galaxy_4m(dev):
    """Suite config 5's scene (``bench_suite.config5_galaxy_4m``): the
    N = 4,194,304 galaxy, bh knobs resolved from the state."""
    from nbodyax_torch.config import SimConfig
    from nbodyax_torch.driver import resolve_bh_config
    from nbodyax_torch.scenes import init_scene
    cfg = SimConfig(particle_count=1 << 22, scene="galaxy",
                    collision_mode="reference", softening=100.0,
                    force_model="bh", save_images=False)
    state = init_scene(cfg, device=dev, parity=False)
    return resolve_bh_config(cfg, state), state


def bh_knobs(cfg):
    return dict(eps=cfg.softening, growth_rate=cfg.growth_rate,
                mode=cfg.collision_mode, levels=cfg.bh_levels,
                ring=cfg.bh_ring, neighbor_k=cfg.bh_neighbor_k,
                order=cfg.bh_order, far=cfg.bh_far, near=cfg.bh_near,
                comp_cap=cfg.bh_comp_cap, near_kernel=cfg.bh_pallas,
                n_giants=cfg.bh_giants)


def phase_cellrange(dev, cfg, state, label, ranks=8):
    """37. ``bh_cellrange_accumulators`` of each of ``ranks`` ranks, one
    after the other in this process on one card, on ``state``: each body
    touched by exactly one rank, and the identity-rebased sum against the
    single-device ``bh_accumulators`` at tests/test_sharded_bh.py:166-222's
    gates (force within 1e-6 of itself and of the largest |force|, died and
    parent exact, gained mass rtol 1e-6, dv 1e-5). Returns B3's launches
    over the ranks' evaluations."""
    from nbodyax_torch.physics.barneshut import (bh_accumulators,
                                                 bh_cellrange_accumulators)
    from nbodyax_torch.physics.near_kernel import slots_near
    from nbodyax_torch.physics.slotpack_kernel import pack_slots
    kw = bh_knobs(cfg)
    n = state.capacity
    t = state[:4]
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    own = torch.zeros(n, dtype=torch.int32, device=dev)
    sums = None
    ms = []
    slots_near.launches = pack_slots.launches = 0
    pack_slots.moment_launches = 0
    for r in range(ranks):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        p = bh_cellrange_accumulators(*t, r, ranks, **kw)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        own += ((p.parent != idx) | p.died | (p.force.abs().sum(1) > 0)
                | (p.gained_mass > 0) | (p.gained_radius > 0)
                | (p.dv.abs().sum(1) > 0)).to(torch.int32)
        lanes = (p.force, p.gained_mass, p.gained_radius,
                 p.died.to(torch.int32), p.parent - idx, p.dv)
        sums = lanes if sums is None else tuple(a + b for a, b in
                                                zip(sums, lanes))
        del p
    b3 = slots_near.launches
    b5 = pack_slots.moment_launches
    full = bh_accumulators(*t, **kw)
    torch.cuda.synchronize()
    alive = state.mass > 0
    check(int(own.max()) <= 1, f"{label}: a body touched by two ranks")
    force, gm, gr, died, parent, dv = sums
    scale = float(full.force.abs().max())
    ferr = float(((force - full.force).abs()
                  - 1e-6 * full.force.abs()).max())
    ok_force = ferr <= 1e-6 * scale
    ok = (ok_force and torch.equal(died > 0, full.died)
          and torch.equal(parent + idx, full.parent)
          and bool(((gm - full.gained_mass).abs()
                    <= 1e-6 * full.gained_mass.abs()).all())
          and bool(((dv - full.dv).abs()
                    <= 1e-5 * full.dv.abs() + 1e-5 * max(
                        float(full.dv.abs().max()), 1e-30)).all()))
    print(f"cell-range bh {label} ({cfg.bh_near}, levels {cfg.bh_levels}, "
          f"K {cfg.bh_neighbor_k}, compCap {cfg.bh_comp_cap}), {ranks} "
          f"ranks one after another in one process on one card: each rank "
          f"{[round(x, 3) for x in ms]} ms (CUDA events; not a multi-card "
          f"time), bodies touched {int((own > 0).sum())} of "
          f"{int(alive.sum())} alive, rebased sum against the single-device "
          f"bh: force excess {ferr:.3e} against {1e-6 * scale:.3e}, died "
          f"and parent exact {ok}; B3 {b3} and B5 {b5} launches over the "
          f"ranks")
    check(ok, f"{label}: the ranks' rebased sum disagrees with "
              f"bh_accumulators")
    check(b3 == ranks, f"{label}: B3 launched {b3} times over {ranks} ranks")
    return b3


def phase_ring_fold(dev, state, p, ranks, rows_of=None, label=""):
    """38. The exact ring's fold of ``ranks`` ranks in this process: B1
    over each rank's hops with the global offsets, folded in hop order
    (``sharding.ring``'s accum_fn and ``combine_accumulators``), against
    the single-device accumulators at tests/test_ring.py:58-72's gates
    (force within 2e-6 of the largest, merges exact). ``rows_of``: fold
    only those ranks (their rows against the single-device pass over
    those rows and every body). Returns B1's launches."""
    from nbodyax_torch.physics.kernels import (body_features, decode_raw,
                                               tile_accumulators_raw)
    from nbodyax_torch.physics.pairwise import (combine_accumulators,
                                                empty_accumulators)
    from nbodyax_torch.sharding.ring import make_local_accum_fn
    accum = make_local_accum_fn("auto", p)
    n = state.capacity
    m = n // ranks
    pos, vel, mass, radius = state[:4]
    feats = body_features(pos, vel, mass, radius)
    worst = 0.0
    tile_accumulators_raw.launches = 0
    for r in (rows_of if rows_of is not None else range(ranks)):
        i = slice(r * m, (r + 1) * m)
        t0 = time.perf_counter()
        acc = empty_accumulators(r * m + torch.arange(
            m, dtype=torch.int32, device=dev))
        for hop in range(ranks):
            j0 = (r + hop) % ranks * m
            j = slice(j0, j0 + m)
            acc = combine_accumulators(acc, accum(
                pos[i], vel[i], mass[i], radius[i], r * m, pos[j], vel[j],
                mass[j], radius[j], j0))
        torch.cuda.synchronize()
        fold_s = time.perf_counter() - t0
        raw, par = tile_accumulators_raw(feats[i], feats, r * m, 0,
                                         mode=p.collision_mode, eps=p.eps,
                                         growth_rate=p.growth_rate)
        want = decode_raw(raw, par, r * m, mass[i], p.collision_mode)
        scale = float(want.force.abs().max())
        err = float((acc.force - want.force).abs().max()) / scale
        worst = max(worst, err)
        same = (torch.equal(acc.died, want.died)
                and torch.equal(acc.parent, want.parent))
        check(err < 2e-6 and same and bool(torch.allclose(
            acc.gained_mass, want.gained_mass, rtol=1e-6, atol=0)),
            f"ring fold {label} rank {r}: force {err:.3e}, merges {same}")
        if rows_of is not None or r == 0:
            print(f"ring fold {label} rank {r} of {ranks}: {ranks} hops of "
                  f"{m} x {m} in {fold_s:.3f} s (host wall, one process on "
                  f"one card; not a multi-card time), force {err:.3e} of "
                  f"the largest, died and parent exact")
    launches = tile_accumulators_raw.launches
    print(f"ring fold {label}: worst force {worst:.3e} of the largest (gate "
          f"2e-6), merges exact on every rank; B1 launches {launches}")
    return launches


PHASE39_CHILD = r"""
import json, os, sys
import torch
sys.path.insert(0, sys.argv[1])
from nbodyax_torch.config import SimConfig
from nbodyax_torch.driver import build_step, resolve_bh_config
from nbodyax_torch.scenes import init_scene
from nbodyax_torch.sharding import (make_group, make_sharded_bh_step,
                                    make_sharded_step, shard_state)
from nbodyax_torch.physics.step import PhysicsParams
group = make_group(1, "cuda")
dev = group.device
out = {"backend": torch.distributed.get_backend()}
for name, over in (("ring reference", {}),
                   ("ring momentum adaptive", dict(collision_mode="momentum",
                                                   adaptive_dt=True)),
                   ("bh reference", dict(force_model="bh"))):
    cfg = SimConfig(save_images=False, **over)
    state = init_scene(cfg, device=dev)
    cfg = resolve_bh_config(cfg, state)
    p = PhysicsParams.from_config(cfg)
    single = build_step(cfg, dev)
    sharded = (make_sharded_bh_step if cfg.force_model == "bh"
               else make_sharded_step)(cfg, p, group)
    a, b = shard_state(state, group), state
    for _ in range(3):
        a, b = sharded(a), single(b)
    torch.cuda.synchronize()
    out[name] = all(torch.equal(x, y) for x, y in zip(a[:4], b[:4])) and \
        bool(torch.equal(a.sim_time, b.sim_time))
torch.distributed.destroy_process_group()
print(json.dumps(out))
"""


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_collectives_on_cuda():
    """39. The port's collectives on CUDA tensors: a one-rank NCCL group in
    a child process runs ``make_sharded_step`` (reference, and momentum
    with adaptive dt: all_gather and all_min) and ``make_sharded_bh_step``
    (all_gather and reduce_scatter) for 3 steps of the default scene,
    bitwise against the single-device steps. With two cards or more, the
    default scene through a torchrun CLI over min(4, cards) ranks against
    one card: bh for 50 steps, bitwise at every 10th; exact for 200 steps,
    merges equal at every 20th and positions at tests/test_ring.py's
    trajectory gates at step 20. On one card it says that it did not
    run. Then the gradient through the ring (``sharded_gradients``) on
    one rank and, with two cards or more, on min(4, cards); beside the
    NCCL child, autoResume under shards on two gloo ranks. Returns the
    gradient run whose B2 launches the kernels line counts: the
    multi-rank one where there is one."""
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               LOCAL_WORLD_SIZE="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(free_port()))
    t0 = time.perf_counter()
    resume = start_auto_resume()     # on the CPU, beside the NCCL child
    try:
        r = subprocess.run([sys.executable, "-c", PHASE39_CHILD, HERE],
                           env=env, capture_output=True, text=True,
                           timeout=600)
        check(r.returncode == 0, f"one-rank NCCL child failed:\n"
                                 f"{r.stdout[-2000:]}{r.stderr[-3000:]}")
        res = json.loads(r.stdout.strip().splitlines()[-1])
        print(f"one-rank NCCL group ({time.perf_counter() - t0:.1f} s in "
              f"its process): {json.dumps(res)}")
        check(res.pop("backend") == "nccl" and all(res.values()),
              f"the sharded steps on a one-rank NCCL group differ from the "
              f"single-device steps: {res}")
        check_auto_resume(resume)
    finally:
        for _, proc in resume.values():
            if proc.poll() is None:
                finish(proc, 0)
    grads = sharded_gradients(1, "cuda")
    cards = torch.cuda.device_count()
    if cards < 2:
        print("sharded_multicard: not run (1 card)")
        return grads
    for ranks in sorted({2, min(4, cards)}):
        grads = sharded_gradients(ranks, "cuda")
    phase_multicard(cards)
    return grads


SHARDED_CLI_CHILD = r"""
import os, sys
from functools import partial
sys.path.insert(0, sys.argv[1])
from nbodyax_torch import cli, driver
argv = sys.argv[2:]
if "--eager" in argv:
    argv.remove("--eager")
    cli.run_simulation = partial(driver.run_simulation, _eager=True)
if "--fault" in argv:
    # on a launch's first attempt, rank 1 raises between two windows (graph
    # replays, or under --eager eager windows), from step 20 on
    argv.remove("--fault")
    first = os.environ.get("TORCHELASTIC_RESTART_COUNT", "0") == "0"

    def failing(advance):
        def at(self, k, frames):
            if (first and os.environ.get("RANK") == "1"
                    and self.state.step >= 20):
                raise RuntimeError("injected fault between replays at step "
                                   "%d" % self.state.step)
            return advance(self, k, frames)
        return at

    for runner in (driver._ShardedGraphWindows, driver._ShardedWindows):
        runner.advance = failing(runner.advance)
sys.exit(cli.main(argv))
"""


SUITE_CHILD = r"""
import sys
sys.path.insert(0, sys.argv[1])
from nbodyax_torch import bench, bench_suite, driver
argv = sys.argv[2:]
if "--eager" in argv:
    # the driver's eager runners in place of its graph runners
    argv.remove("--eager")

    def eager(step, state, cfg, window, group=None):
        if group is not None:
            return driver._ShardedWindows(step, state, cfg, 0, group)
        return driver._EagerWindows(step, state, cfg, 0)

    bench.window_runner = eager
sys.exit(bench_suite.main(argv))
"""


def phase_multicard(cards, suite=True):
    """39, with two cards or more: the default scene through the CLI on one
    card and over P = 2 and min(4, cards) ranks on as many cards, each
    through graph windows (sharded: ``_ShardedGraphWindows``) and eagerly
    (``_eager``), ``Time taken`` of each: bh for 50 steps, bitwise to one
    card at every 10th; exact for 200 steps, merges equal to one card's at
    every 20th and positions at tests/test_ring.py's trajectory gates at
    step 20 (the ring's sums round differently, and close encounters
    amplify that); the sharded graph run bitwise the sharded eager one at
    every checkpoint; beside ``Time taken``, each run's median log-line
    ``wall_ms`` after the first (the device's time a step, by CUDA events
    a window). Then (``suite``) suite config 5 (the 4M galaxy, bh and
    exact) on one card and sharded over each P (``bench_suite`` under
    torchrun), through graph windows and through the eager runners, and
    ``phase_multicard_fault``."""
    work = tempfile.mkdtemp(prefix="multicard_")
    child = os.path.join(work, "child.py")
    with open(child, "w") as f:
        f.write(SHARDED_CLI_CHILD)
    ranks_list = sorted({2, min(4, cards)})

    def launch(ranks):
        return [] if ranks == 1 else [
            "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", str(ranks)]

    def run(tag, ranks, sets, steps, every, eager):
        ck = os.path.join(work, tag)
        cmd = [sys.executable, *launch(ranks), child, HERE, "--steps",
               str(steps), "--no-images", "--set", f"checkpointEvery={every}",
               "--set", "checkpointKeep=0", "--set", f"checkpointPath={ck}"]
        for kv in sets + ([f"shards={ranks}"] if ranks > 1 else []):
            cmd += ["--set", kv]
        r = subprocess.run(cmd + (["--eager"] if eager else []), cwd=HERE,
                           capture_output=True, text=True, timeout=300)
        check(r.returncode == 0, f"{tag} run failed: {r.stderr[-3000:]}")
        walls = [json.loads(l)["wall_ms"] for l in r.stdout.splitlines()
                 if l.startswith("{")]
        return ck, (time_taken(r.stdout), float(np.median(walls[1:])))

    def same_cks(a, b):
        for f in sorted(os.listdir(b)):
            x, y = np.load(os.path.join(a, f)), np.load(os.path.join(b, f))
            if not all(np.array_equal(x[k], y[k]) for k in
                       ("pos", "vel", "mass", "radius", "sim_time")):
                return False
        return sorted(os.listdir(a)) == sorted(os.listdir(b))

    for name, sets, steps, every in (("exact", [], 200, 20),
                                     ("bh", ["forceModel=bh"], 50, 10)):
        taken = {}
        one, taken[1, "graph"] = run(f"{name}_one", 1, sets, steps, every,
                                     False)
        _, taken[1, "eager"] = run(f"{name}_one_eager", 1, sets, steps, every,
                                   True)
        for ranks in ranks_list:
            many, taken[ranks, "graph"] = run(f"{name}_{ranks}", ranks, sets,
                                              steps, every, False)
            eager, taken[ranks, "eager"] = run(f"{name}_{ranks}_eager", ranks,
                                               sets, steps, every, True)
            rows = []
            for f in sorted(os.listdir(one)):
                a = np.load(os.path.join(many, f))
                b = np.load(os.path.join(one, f))
                n = b["pos"].shape[0]
                rows.append((int(f[5:14]),
                             all(np.array_equal(a[k][:n], b[k]) for k in
                                 ("pos", "vel", "mass", "radius")),
                             np.array_equal(a["mass"][:n] > 0, b["mass"] > 0),
                             float(np.abs(a["pos"][:n] - b["pos"]).max()),
                             bool(np.allclose(a["pos"][:n], b["pos"],
                                              rtol=1e-4, atol=1e-3))))
            graph_eager = same_cks(many, eager)
            print(f"sharded_multicard {name}: {ranks} ranks on {ranks} cards "
                  f"against one card, default scene, {steps} steps: (step, "
                  f"bitwise, alive masks equal, largest position difference, "
                  f"within test_ring.py's gates) {rows}; sharded graph "
                  f"windows bitwise the sharded eager ones at every "
                  f"checkpoint: {graph_eager}")
            check(graph_eager, f"sharded {name} over {ranks} cards: graph "
                               f"windows differ from eager windows")
            if name == "bh":
                # the cell-range step sums one nonzero term a lane: bitwise
                check(all(r[1] for r in rows), "sharded bh across cards "
                                               "differs from one card")
            else:
                # the ring's hop-ordered sums round differently from one
                # launch; the merges must agree at every checkpoint and the
                # positions within test_ring.py's gates over its horizon
                # (step 20), after which close encounters amplify the
                # rounding
                check(all(r[2] for r in rows) and rows[0][4],
                      "the multi-card exact run's merges or its first 20 "
                      "steps left the single-card run")
        print(f"sharded_multicard {name}, default scene, {steps} steps, "
              f"(Time taken s, median wall ms a step), graph against eager: "
              + "; ".join(f"{p} card(s) {taken[p, 'graph']} against "
                          f"{taken[p, 'eager']}" for p in [1] + ranks_list))
    suite_py = os.path.join(work, "suite.py")
    with open(suite_py, "w") as f:
        f.write(SUITE_CHILD)
    for ranks, way in itertools.product([1] + ranks_list if suite else [],
                                        ("graph", "eager")):
        t0 = time.perf_counter()
        rc, out, err = finish(subprocess.Popen(
            [sys.executable, *launch(ranks), suite_py, HERE, "--configs",
             "5"]
            + (["--eager"] if way == "eager" else []), cwd=HERE,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True), 600)
        check(rc == 0, f"suite config 5 on {ranks} card(s), {way}, failed:"
                       f"\n{out[-2000:]}{err[-3000:]}")
        line = json.loads(out.strip().splitlines()[-1])
        print(f"sharded_multicard suite config 5 ({ranks} card(s), {way} "
              f"windows, {time.perf_counter() - t0:.1f} s in its launch): "
              f"{json.dumps(line)}")
        check(line["finite"] and line.get("shards", 1) == ranks
              and line["steps_per_sec"] > 0 and line["exact_steps_per_sec"] > 0,
              f"suite config 5 on {ranks} card(s), {way}: {line}")
    phase_multicard_fault(max(ranks_list), work, child)


GRAD_FAULT_CHILD = r"""
import os, sys
sys.path.insert(0, sys.argv[1])
from nbodyax_torch.autodiff import graphed_value_and_grad, make_loss
from nbodyax_torch.config import SimConfig
from nbodyax_torch.physics.step import PhysicsParams
from nbodyax_torch.scenes import init_scene
from nbodyax_torch.sharding import (close_group, make_group,
                                    make_sharded_step, pad_to_shards,
                                    shard_state)
world = int(os.environ["WORLD_SIZE"])
group = make_group(world, sys.argv[2])
cfg = SimConfig(softening=100.0, save_images=False, shards=world,
                particle_count=int(sys.argv[3]))
state = init_scene(cfg, device=group.device)
local = shard_state(pad_to_shards(state, world), group)
loss = make_loss(make_sharded_step(cfg, PhysicsParams.from_config(cfg),
                                   group), 4,
                 lambda s: ((s.pos / 1e3) ** 2).sum() / state.capacity)
failed = True
try:
    # the graph goes before the group does, on the failing rank too
    with graphed_value_and_grad(loss) as vg:
        for i in range(6):
            if i == 3 and group.rank == 1:
                raise RuntimeError("injected fault between gradient replays")
            float(vg(local)[0])
    failed = False
finally:
    close_group(failed)
"""


def phase_grad_fault(ranks, work, device="cuda", n=16384):
    """39, with two cards or more: the sharded gradient graph over
    ``ranks`` cards (the default scene, 4 euler steps), whose rank 1
    raises between its third and fourth replay: the launch must end,
    non-zero, within 60 s (F8's bound), the fault printed."""
    child = os.path.join(work, "grad_fault.py")
    with open(child, "w") as f:
        f.write(GRAD_FAULT_CHILD)
    t0 = time.perf_counter()
    rc, out, err = finish(torchrun(ranks, [child, HERE, device, str(n)]),
                          150)
    wall = time.perf_counter() - t0
    seen = "injected fault between gradient replays" in out + err
    print(f"sharded_multicard gradient fault: rank 1 of {ranks} raising "
          f"between gradient replays ended the launch in {wall:.1f} s (exit "
          f"code {rc}; the fault in its output: {seen})")
    check(wall < 60 and rc not in (0, None) and seen,
          f"a rank raising between gradient replays did not end the launch "
          f"within 60 s (exit code {rc} after {wall:.1f} s)")


def fault_ends(ranks, work, child, eager=False):
    """A sharded run over ``ranks`` cards (the default scene, 60 steps)
    whose rank 1 raises between two windows at step 20, through graph
    windows or (``eager``) the eager sharded runner: without autoResume
    the launch must end, non-zero, within 150 s, the fault printed."""
    way = "eager windows" if eager else "graph replays"
    base = [child, HERE, "--steps", "60", "--no-images", "--set",
            f"shards={ranks}"]
    t0 = time.perf_counter()
    rc, out, err = finish(torchrun(ranks, base + [
        "--fault", "--set",
        f"checkpointPath={os.path.join(work, 'fault_' + way[:5])}"]
        + (["--eager"] if eager else [])), 150)
    wall = time.perf_counter() - t0
    ended = wall < 150 and rc not in (0, None)
    seen = "injected fault between replays" in out + err
    print(f"sharded_multicard fault: rank 1 of {ranks} raising between "
          f"{way} at step 20 ended the launch: {ended} (exit code {rc}, "
          f"{wall:.1f} s; the fault in its output: {seen})")
    check(ended and seen, f"a rank raising between {way} did not end the "
                          f"launch (exit code {rc} after {wall:.1f} s)")


def phase_multicard_fault(ranks, work, child):
    """39, with two cards or more: a sharded run over ``ranks`` cards (the
    default scene, 60 steps) whose rank 1 raises between two windows at
    step 20, through graph windows and through the eager sharded runner
    (``fault_ends``). Without autoResume the launch must end, non-zero,
    within 150 s: NCCL's watchdog does not track a replay, so only the
    failing rank's exit (``close_group`` aborts its communicator) and
    torchrun's teardown of its peers end it. With autoResume, a checkpoint
    every 20 steps and ``--max-restarts 1``, torchrun must relaunch every
    rank, and the relaunched graph run must end on the straight run's
    state, bitwise.
    """
    fault_ends(ranks, work, child)
    fault_ends(ranks, work, child, eager=True)
    base = [child, HERE, "--steps", "60", "--no-images", "--set",
            f"shards={ranks}"]
    resume = ["--set", "autoResume=1", "--set", "maxRetries=1", "--set",
              "checkpointEvery=20", "--set", "checkpointKeep=0"]
    final, lines = [], []
    for tag in ("straight", "relaunched"):
        ck = os.path.join(work, tag)
        t0 = time.perf_counter()
        rc, out, err = finish(torchrun(
            ranks, base + resume + ["--set", f"checkpointPath={ck}"]
            + (["--fault"] if tag == "relaunched" else []), restarts=1), 300)
        check(rc == 0, f"sharded autoResume {tag} run over {ranks} cards "
                       f"failed (exit code {rc}):\n{out[-2000:]}{err[-3000:]}")
        final.append(np.load(os.path.join(ck, "step_000000060.npz")))
        lines.append(f"{tag} {time.perf_counter() - t0:.1f} s, Time taken "
                     f"{re.findall(r'Time taken: ([0-9.]+)', out)}, "
                     f"{[l for l in out.splitlines() if l.startswith('Relaunch')]}")
    same = all(np.array_equal(final[0][k], final[1][k])
               for k in ("pos", "vel", "mass", "radius", "sim_time"))
    print(f"sharded_multicard autoResume over {ranks} cards (a fault "
          f"between replays at step 20, torchrun --max-restarts 1): "
          f"{'; '.join(lines)}; final state bitwise the straight run's: "
          f"{same}")
    check(same and "Relaunch 1 of 1" in lines[1],
          "the relaunched sharded graph run left the straight run")
    phase_grad_fault(ranks, work)


PHASE39_GRAD_CHILD = r"""
import dataclasses, json, os, sys, time
import torch
sys.path.insert(0, sys.argv[1])
from nbodyax_torch.autodiff import graphed_value_and_grad, make_loss
from nbodyax_torch.backends import build_accum_fn
from nbodyax_torch.config import SimConfig
from nbodyax_torch.physics import _build
from nbodyax_torch.physics.kernels import tile_accumulators_raw
from nbodyax_torch.physics import kernels_bwd
from nbodyax_torch.physics.kernels_bwd import raw_backward
from nbodyax_torch.physics.step import PhysicsParams, make_step
from nbodyax_torch.scenes import init_scene
from nbodyax_torch.sharding import (close_group, make_group,
                                    make_sharded_step, pad_to_shards,
                                    shard_state)
world = int(os.environ["WORLD_SIZE"])
group = make_group(world, sys.argv[2])
dev = group.device
if dev.type == "cuda":
    _build.load_library()


def sync():
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def share_loss(step, n, steps):
    # this rank's share of phase 10's terminal loss (the alive bodies'
    # squared distance to the origin, over the capacity)
    def share(s):
        w = (s.mass > 0).to(torch.float32)
        return (w * (s.pos * s.pos).sum(-1)).sum() / n
    return make_loss(step, steps, share)


def grads(step, state, n, steps):
    # d/d(pos, vel, mass) of the share, op by op
    return graphed_value_and_grad(share_loss(step, n, steps)).eager(state)[1]


def timed(fn):
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, (time.perf_counter() - t0) * 1e3


def errs(got, want):
    return [float((a.double() - b.double()).abs().max() / b.abs().max())
            for a, b in zip(got, want)]


def hop_counted(fi, fj, i_offset, j_offset, *args, **kw):
    # B2's launches on tiles of another rank's rows (hop > 0); the wrapper
    # counts on its module's name, so that name is its own during the call
    kernels_bwd.raw_backward = raw_backward
    try:
        before = raw_backward.launches
        out = raw_backward(fi, fj, i_offset, j_offset, *args, **kw)
        if int(i_offset) != int(j_offset):
            launches["b2_ring_hops"] += raw_backward.launches - before
    finally:
        kernels_bwd.raw_backward = hop_counted
    return out


def double(state):
    return state._replace(**{k: getattr(state, k).double() for k in
                             ("pos", "vel", "mass", "radius", "sim_time")})


def replay_counted(vg, state):
    # the graph's gradient (cloned) and the B1, B2 launches of a replay
    tile_accumulators_raw.launches = raw_backward.launches = 0
    _, out = vg(state)
    return ([g.clone() for g in out],
            (tile_accumulators_raw.launches, raw_backward.launches))


def all_ranks(x):
    # the ranks' floats, in rank order
    return group.all_gather(torch.tensor([float(x)], device=dev)).tolist()


rows, launches = [], {"b1": 0, "b2": 0, "b2_ring_hops": 0}


def case(integ, steps, mode):
    cfg = SimConfig(collision_mode=mode, softening=100.0,
                    integrator=integ, save_images=False, shards=world,
                    particle_count=int(sys.argv[3]))
    p = PhysicsParams.from_config(cfg)
    state = init_scene(cfg, device=dev)
    n = state.capacity
    local = shard_state(pad_to_shards(state, world), group)
    sharded = make_sharded_step(cfg, p, group)
    tile_accumulators_raw.launches = raw_backward.launches = 0
    kernels_bwd.raw_backward = hop_counted
    gs, _ = timed(lambda: grads(sharded, local, n, steps))
    kernels_bwd.raw_backward = raw_backward
    eager_launches = (tile_accumulators_raw.launches, raw_backward.launches)
    launches["b1"] += tile_accumulators_raw.launches
    launches["b2"] += raw_backward.launches
    gs, ms = timed(lambda: grads(sharded, local, n, steps))
    # the same gradient as one CUDA-graph replay: warm-up, capture and a
    # replay, then a timed replay; closed before the group goes
    with graphed_value_and_grad(share_loss(sharded, n, steps)) as vg:
        (gg, graph_launches), first_ms = timed(lambda: replay_counted(
            vg, local))
        gg2, graph_ms = timed(lambda: vg(local)[1])
        replays = all(torch.equal(a, b) for a, b in zip(gg, gg2))
        capture = vg.capture_seconds
    graph = dict(
        bitwise=all_ranks(all(torch.equal(a, b) for a, b in zip(gg, gs))),
        err=all_ranks(max(errs(gg, gs))), replays=all_ranks(replays),
        launches_equal=all_ranks(graph_launches == eager_launches),
        launches=list(graph_launches), capture_s=capture,
        first_call_ms=first_ms, ms=graph_ms,
        peak_mib=(torch.cuda.max_memory_allocated(dev) / 2**20
                  if dev.type == "cuda" else None))
    gg = [group.all_gather(g)[:n] for g in gg]
    gs = [group.all_gather(g)[:n] for g in gs]
    g64 = None
    if mode == "momentum":
        # float64 through the torch oracle's ring: the mass gradient's
        # float32 rounding cannot hide a wrong ring there
        local64 = shard_state(pad_to_shards(double(state), world), group)
        g64 = grads(make_sharded_step(dataclasses.replace(
            cfg, backend="jnp"), p, group), local64, n, steps)
        g64 = [group.all_gather(g)[:n] for g in g64]
    if group.rank:
        return
    single = make_step(p, accum_fn=build_accum_fn("auto", p, dev))
    gl, _ = timed(lambda: grads(single, state, n, steps))
    gl, ms1 = timed(lambda: grads(single, state, n, steps))
    oracle = make_step(p, accum_fn=build_accum_fn("jnp", p, dev))
    go = grads(oracle, state, n, steps)
    graph.update(err_single=errs(gg, gl))
    row = dict(integrator=integ, steps=steps, mode=mode,
               err=errs(gs, gl), err_oracle=errs(gs, go),
               engines=errs(go, gl),
               nonzero=all(float(b.abs().max()) > 0 for b in gl),
               finite=all(bool(torch.isfinite(a).all()) for a in gs),
               bitwise=all(torch.equal(a, b) for a, b in zip(gs, gl)),
               sharded_ms=ms, single_ms=ms1, graph=graph)
    if g64 is not None:
        w64 = grads(oracle, double(state), n, steps)
        i = int((gl[2] - go[2]).abs().argmax())
        row.update(
            err64=errs(g64, w64),
            # each float32 mass gradient against the float64 one
            mass_vs_f64={k: errs(g[2:], w64[2:])[0] for k, g in
                         (("sharded", gs), ("kernel", gl),
                          ("oracle", go))},
            worst=dict(index=i, mass=float(state.mass[i]),
                       kernel=float(gl[2][i]), oracle=float(go[2][i]),
                       sharded=float(gs[2][i]), f64=float(w64[2][i]),
                       largest_f64=float(w64[2].abs().max())))
    rows.append(row)


failed = True
try:
    for integ, steps in (("euler", 4), ("leapfrog", 2)):
        for mode in ("reference", "momentum", "elastic"):
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            case(integ, steps, mode)
    failed = False
finally:
    close_group(failed)
if group.rank == 0:
    print(json.dumps({"backend": "nccl" if dev.type == "cuda" else "gloo",
                      "ranks": world, "launches": launches, "rows": rows}))
"""

RESUME_CHILD = r"""
import os, sys
sys.path.insert(0, sys.argv[1])
from nbodyax_torch import cli, driver
if (os.environ["TORCHELASTIC_RESTART_COUNT"] == "0"
        and os.environ["RANK"] == "1" and "--fault" in sys.argv):
    advance = driver._ShardedWindows.advance

    def failing(self, k, frames):
        if self.state.step >= 20:
            raise RuntimeError("injected fault at step %d" % self.state.step)
        return advance(self, k, frames)

    driver._ShardedWindows.advance = failing
sys.exit(cli.main([a for a in sys.argv[2:] if a != "--fault"]))
"""


def torchrun(nproc, args, restarts=None) -> subprocess.Popen:
    """Start ``python -m torch.distributed.run --standalone`` of ``args``
    over ``nproc`` ranks, from this checkout (``finish`` reads it)."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc)]
    if restarts is not None:
        cmd += ["--max-restarts", str(restarts)]
    return subprocess.Popen(cmd + args, cwd=HERE, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish(proc, timeout):
    """(exit code, stdout, stderr) of a started launch; past ``timeout``
    it is ended (torchrun ends its ranks on SIGTERM)."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.terminate()
        try:
            out, err = proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            out, err = proc.communicate()
    return proc.returncode, out, err


def sharded_gradients(ranks, device, n=16384):
    """PHASE39_GRAD_CHILD over ``ranks`` ranks on ``device`` for the
    default scene cut to ``n`` bodies: its JSON line, gated. Every
    gradient is finite and nonzero, and within GRAD_GATE of the largest
    |grad| of both single-device engines (the kernel path and the torch
    oracle), but one: momentum mode's with respect to mass. On this scene
    (masses 1e4 to 1e17) the centre of mass ``sum(m p) / sum(m)`` of each
    merge root differentiates into two terms that cancel far below their
    float32 rounding, so every float32 engine, the oracle too, lies from
    5% to several times the largest away from the float64 gradient, and
    which element is off depends on the order autograd sums a leaf's terms
    (the single-device kernel path packs both operands of its pair pass
    into one tensor, the ring and the oracle take two). So that gradient
    is held in float64: the oracle's ring against the single-device
    oracle, every leaf at GRAD_GATE. The float32 ones are printed against
    the float64 one, with every value at the element where the two
    single-device engines differ most. B2 must launch, and with more than
    one rank on tiles of other ranks' rows."""
    child = os.path.join(tempfile.mkdtemp(prefix="grad_child_"), "child.py")
    with open(child, "w") as f:
        f.write(PHASE39_GRAD_CHILD)
    t0 = time.perf_counter()
    rc, out, err = finish(torchrun(ranks, [child, HERE, device, str(n)]),
                          600)
    check(rc == 0, f"sharded gradient child ({ranks} ranks, {device}) "
                   f"failed:\n{out[-2000:]}{err[-3000:]}")
    res = json.loads(out.strip().splitlines()[-1])

    def fmt(xs):
        return ", ".join(f"{e:.3e}" for e in xs)

    for row in res["rows"]:
        momentum = row["mode"] == "momentum"
        print(f"sharded gradient, {ranks} rank(s) on {res['backend']}, "
              f"default scene N={n}, {row['steps']} {row['integrator']} "
              f"steps, {row['mode']}, remat: d/d(pos, vel, mass) "
              f"{fmt(row['err'])} of the largest |grad| against the "
              f"single-device kernel path, {fmt(row['err_oracle'])} against "
              f"the single-device oracle (gate {GRAD_GATE}), bitwise "
              f"{row['bitwise']}; the oracle against the kernel path "
              f"{fmt(row['engines'])}; gradient {row['sharded_ms']:.3f} ms "
              f"sharded against {row['single_ms']:.3f} ms single-device "
              f"(host wall, warm)")
        gated = row["err"][:2] + row["err_oracle"][:2]
        if momentum:
            vs = row["mass_vs_f64"]
            print(f"  float64, the oracle's ring against the single-device "
                  f"oracle: d/d(pos, vel, mass) {fmt(row['err64'])} (gate "
                  f"{GRAD_GATE}); float32 mass gradients against float64: "
                  f"sharded {vs['sharded']:.3e}, kernel path "
                  f"{vs['kernel']:.3e}, oracle {vs['oracle']:.3e} of the "
                  f"largest; where kernel path and oracle differ most: "
                  f"{json.dumps(row['worst'])}")
            gated += row["err64"]
        else:
            gated += row["err"][2:] + row["err_oracle"][2:]
        check(row["finite"] and row["nonzero"] and max(gated) < GRAD_GATE,
              f"sharded gradient {row}: off the single-device one")
        graph = row["graph"]
        print(f"  as one CUDA-graph replay: bitwise the eager sharded "
              f"gradient on each rank {graph['bitwise']} (largest error "
              f"{max(graph['err']):.3e}), replays repeat {graph['replays']}; "
              f"against the single-device kernel path "
              f"{fmt(graph['err_single'])}; {graph['ms']:.3f} ms a replay "
              f"against {row['sharded_ms']:.3f} ms eager (host wall, warm); "
              f"first call {graph['first_call_ms']:.1f} ms, capture "
              f"{graph['capture_s']:.3f} s, peak {graph['peak_mib']} MiB "
              f"on rank 0; B1, B2 launches a replay {graph['launches']}, "
              f"equal to the eager call's on each rank "
              f"{graph['launches_equal']}")
        single_gated = graph["err_single"][:2] if momentum else \
            graph["err_single"]
        check(all(graph["replays"]) and all(graph["launches_equal"])
              and (all(graph["bitwise"]) or max(graph["err"]) < GRAD_GATE)
              and max(single_gated) < GRAD_GATE,
              f"sharded gradient graph {row['mode']} {row['integrator']}: "
              f"{graph}")
    b2, hops = res["launches"]["b2"], res["launches"]["b2_ring_hops"]
    print(f"sharded gradients ({time.perf_counter() - t0:.1f} s in "
          f"{ranks} process(es)): B1 {res['launches']['b1']} and B2 {b2} "
          f"launches on rank 0, {hops} of B2's on tiles of other ranks' "
          f"rows" + ("" if ranks > 1 else " (one rank: every tile is the "
                     "whole array at offsets 0 and 0)"))
    check(b2 > 0 and (ranks == 1 or hops > 0),
          f"the sharded gradient launched B2 {b2} times, {hops} on ring hops")
    return res


def start_auto_resume():
    """39. autoResume under shards: the CLI as two gloo ranks on this
    machine's CPU (NCCL takes one rank a card, and shards must exceed 1)
    under ``torch.distributed.run --max-restarts 1``, 64 bodies for 40
    steps with a checkpoint every 10, straight and, at the same time, with
    a fault: the child script makes rank 1 raise at step 20 on the first
    attempt. Returns the two launches for ``check_auto_resume``."""
    work = tempfile.mkdtemp(prefix="resume_shards_")
    child = os.path.join(work, "child.py")
    with open(child, "w") as f:
        f.write(RESUME_CHILD)
    args = ["--device", "cpu", "--no-images", "--steps", "40", "--set",
            "particleCount=64", "--set", "fieldWidth=5000", "--set",
            "fieldHeight=5000", "--set", "shards=2", "--set",
            "autoResume=1", "--set", "maxRetries=1", "--set",
            "checkpointEvery=10", "--set", "checkpointKeep=0"]
    return {tag: (os.path.join(work, tag), torchrun(
        2, [child, HERE, *args, "--set",
            f"checkpointPath={os.path.join(work, tag)}"]
        + (["--fault"] if tag == "fault" else []), restarts=1))
        for tag in ("straight", "fault")}


def check_auto_resume(runs):
    """The relaunched run must end on the straight run's final state, bit
    for bit."""
    final = []
    for tag, (ck, proc) in runs.items():
        rc, out, err = finish(proc, 300)
        check(rc == 0, f"sharded autoResume {tag} run failed:\n"
                       f"{out[-2000:]}{err[-3000:]}")
        final.append(np.load(os.path.join(ck, "step_000000040.npz")))
    check("injected fault at step 20" in err
          and "Relaunch 1 of 1: resuming from" in out,
          f"the faulted run was not relaunched:\n{out[-2000:]}")
    same = all(np.array_equal(final[0][k], final[1][k])
               for k in ("pos", "vel", "mass", "radius", "sim_time"))
    relaunch = [ln for ln in out.splitlines() if ln.startswith("Relaunch")]
    print(f"sharded autoResume (2 gloo ranks on the CPU, torchrun "
          f"--max-restarts 1, a fault at step 20 on the first attempt): "
          f"{relaunch}; final state bitwise equal to the straight run's: "
          f"{same}")
    check(same, "the relaunched sharded run left the straight run")


def cross_tile_merges(scene, ranks, pairs=64, seed=40):
    """The default scene with ``pairs`` overlapping pairs whose bodies lie
    in different ranks' tiles (each body placed half a radius from its
    partner), so momentum-mode winners live in other ranks' tiles."""
    pos, vel, mass, radius = (np.array(x) for x in scene)
    m = len(mass) // ranks
    rng = np.random.RandomState(seed)
    for _ in range(pairs):
        a, b = rng.choice(ranks, 2, replace=False)
        i, j = a * m + rng.randint(m), b * m + rng.randint(m)
        pos[i] = pos[j] + np.float32([0.5 * radius[j], 0.0])
    return pos, vel, mass, radius


def phase_ring_backward(dev, arrays, mode, ranks, label, timing=False):
    """40. B2 around the ring in this process: for every (rank, hop), B2 on
    the rank's rows against the hop's tile with their global offsets,
    against ``raw_backward_reference`` at BWD_GATE; the i sides summed per
    rank and the j sides summed onto their owners against one B2 over all
    N. In momentum mode each row's best-mass cotangent goes to the hop
    whose candidate wins the fold (``combine_accumulators``'s rule), as
    autograd routes it. Returns (abs_rel_err over every tile, times or
    None)."""
    from nbodyax_torch.physics.kernels import (_NEG_INF, body_features,
                                               tile_accumulators_raw)
    from nbodyax_torch.physics.kernels_bwd import (raw_backward,
                                                   raw_backward_reference)
    feats = body_features(*(torch.as_tensor(x, device=dev) for x in arrays))
    n = feats.shape[0]
    m = n // ranks
    g = cotangent(n, dev)
    kw = dict(mode=mode, eps=0.0, growth_rate=0.1)
    momentum = mode == "momentum"

    def rows(r):
        return slice(r * m, (r + 1) * m)

    parents, wins, remote = {}, {}, 0
    if momentum:
        for r in range(ranks):
            ids = r * m + torch.arange(m, dtype=torch.int32, device=dev)
            best = torch.full((m,), -torch.inf, device=dev)
            par = ids.clone()
            win = torch.full((m,), -1, dtype=torch.int64, device=dev)
            for h in range(ranks):
                jr = (r + h) % ranks
                raw, pj = tile_accumulators_raw(feats[rows(r)],
                                                feats[rows(jr)], r * m,
                                                jr * m, **kw)
                parents[r, h] = pj
                cand = raw[:, 6] > _NEG_INF
                bm = torch.where(cand, raw[:, 6], -torch.inf)
                pc = torch.where(cand, pj, ids)
                b_wins = (bm > best) | ((bm == best) & (pc < par))
                best = torch.where(b_wins, bm, best)
                par = torch.where(b_wins, pc, par)
                win = torch.where(b_wins, h, win)
            wins[r] = win
            remote += int((win > 0).sum())
    sum_i, sum_j = torch.zeros_like(feats), torch.zeros_like(feats)
    worst, absrel = 0.0, (0.0, 0.0)
    for r in range(ranks):
        for h in range(ranks):
            jr = (r + h) % ranks
            gi = g[rows(r)]
            if momentum:
                gi = gi.clone()
                gi[:, 6] = torch.where(wins[r] == h, gi[:, 6], 0.0)
            args = (feats[rows(r)], feats[rows(jr)], r * m, jr * m,
                    parents.get((r, h)), gi)
            got = raw_backward(*args, **kw)
            want = raw_backward_reference(*args, **kw)
            err = bwd_errors(got, want)
            worst = max(worst, *err)
            check(max(err) < BWD_GATE and all(
                bool(torch.isfinite(x).all()) for x in got),
                f"B2 ring tile {label} rank {r} hop {h}: {err}")
            # each channel (the mass one too) over its own largest
            ar = abs_rel_err(torch.cat(got), torch.cat(want))
            check(ar[1] < BWD_GATE, f"B2 ring tile {label} rank {r} hop "
                                    f"{h}: a channel off by {ar[1]}")
            absrel = (max(absrel[0], ar[0]), max(absrel[1], ar[1]))
            sum_i[rows(r)] += got[0]
            sum_j[rows(jr)] += got[1]
    par_full = (tile_accumulators_raw(feats, feats, 0, 0, **kw)[1]
                if momentum else None)
    full = raw_backward(feats, feats, 0, 0, par_full, g, **kw)
    errs = bwd_errors((sum_i, sum_j), full)
    print(f"B2 around the ring {label}, {mode}, P={ranks} (tiles of "
          f"{m} x {m}): every (rank, hop) against its plain version, worst "
          f"{worst:.3e}, each channel over its own largest "
          f"{absrel[1]:.3e} (gate {BWD_GATE}); i sides summed per rank "
          f"{errs[0]:.3e}, j sides summed onto their owners {errs[1]:.3e} "
          f"of the single-device B2 over all N"
          + (f"; {remote} rows whose winning candidate lies in another "
             f"rank's tile" if momentum else ""))
    check(max(errs) < BWD_GATE, f"B2 ring sums {label}: {errs}")
    check(not momentum or remote > 0, f"{label}: no winner in another "
                                      f"rank's tile")
    if not timing:
        return absrel, None
    f0, f1, g0 = feats[rows(0)], feats[rows(1)], g[rows(0)]

    def tile():
        return raw_backward(f0, f1, 0, m, None, g0, **kw)

    def rank0():
        for h in range(ranks):
            raw_backward(f0, feats[rows(h)], 0, h * m, None, g0, **kw)
    ms = time_ms(tile, reps=10)
    bound = b2_bound(m)
    dms = report_device(f"B2 ring tile (hop 1, offsets 0 and {m})", m, tile,
                        B2_TAGS, ms, bound, reps=10)
    plain = time_ms(lambda: raw_backward_reference(f0, f1, 0, m, None, g0,
                                                   **kw), reps=2, warm=1)
    r0 = time_ms(rank0, reps=3)
    print(f"B2 ring tile {m} x {m}: wrapper call {ms:.4f} ms, device "
          f"{dms:.4f} ms, plain version {plain:.4f} ms; rank 0's summed "
          f"backward over its {ranks} hops {r0:.4f} ms (CUDA events; one "
          f"process on one card)")
    return absrel, {"ms": ms, "device_ms": dms, "plain_ms": plain,
                    "library_ms": None, "bound": bound}


PHASE41_CHILD = r"""
import contextlib, io, json, os, sys, tempfile, time
import numpy as np, torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[1])
from nbodyax_torch import cli, driver
from nbodyax_torch.graphs import read_counters
from nbodyax_torch.config import SimConfig
from nbodyax_torch.physics import _build
from nbodyax_torch.sharding import make_group, pad_to_shards
from nbodyax_torch.scenes import init_scene
_build.load_library()
group = make_group(1, "cuda")
# NCCL makes its communicator at the first collective: here, so that no
# way's run pays for it
t0 = time.perf_counter()
group.all_gather(torch.zeros(1, device=group.device))
torch.cuda.synchronize()
nccl_init = time.perf_counter() - t0
specs = json.loads(sys.argv[2])
WAYS = {"sharded graph": dict(_group=group),
        "sharded eager": dict(_group=group, _eager=True),
        "one card graph": {}}
FIELDS = ("pos", "vel", "mass", "radius", "sim_time", "step")


def cli_run(way, spec, work):
    # the CLI in work, its run_simulation given the way's switches; the
    # group lives across runs, so cli.main's teardown of it is held off
    os.makedirs(work)
    with open(os.path.join(work, "nbodyConfig.txt"), "w") as f:
        f.write(spec["config"])
    results, buf, cwd = [], io.StringIO(), os.getcwd()

    def run(*a, **k):
        results.append(driver.run_simulation(*a, **WAYS[way], **k))
        return results[-1]

    saved = cli.run_simulation, dist.destroy_process_group
    cli.run_simulation, dist.destroy_process_group = run, lambda *a: None
    before = read_counters()
    os.chdir(work)
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main(spec["argv"])
    finally:
        os.chdir(cwd)
        cli.run_simulation, dist.destroy_process_group = saved
    after = read_counters()
    out = buf.getvalue()
    taken = [l for l in out.splitlines() if l.startswith("Time taken: ")]
    res = results[-1]
    return {"rc": rc, "time_taken": float(taken[0].split()[-1]),
            "capture_s": res.seconds["capture"], "windows": res.windows,
            "launches": dict(zip(("B1", "B2", "B3", "B4", "B5"),
                                 (a - b for a, b in zip(after, before))))}


def files(d):
    return sorted(os.listdir(d)) if os.path.isdir(d) else []


out = {}
for name, spec in specs.items():
    base = tempfile.mkdtemp(prefix=f"phase41_{name}_")
    runs = {w: cli_run(w, spec, os.path.join(base, w.replace(" ", "_")))
            for w in WAYS}
    dirs = {w: os.path.join(base, w.replace(" ", "_")) for w in WAYS}
    ref = "one card graph"
    cks = files(os.path.join(dirs[ref], "checkpoints"))
    frames = files(os.path.join(dirs[ref], "frames"))
    for w in WAYS:
        ck_dir, fr_dir = (os.path.join(dirs[w], d) for d in
                          ("checkpoints", "frames"))
        same_ck = files(ck_dir) == cks and all(
            np.array_equal(np.load(os.path.join(ck_dir, f))[k],
                           np.load(os.path.join(dirs[ref], "checkpoints",
                                                f))[k])
            for f in cks for k in FIELDS)
        same_fr = files(fr_dir) == frames and all(
            open(os.path.join(fr_dir, f), "rb").read()
            == open(os.path.join(dirs[ref], "frames", f), "rb").read()
            for f in frames)
        runs[w].update(checkpoints_equal=same_ck, frames_equal=same_fr)
    out[name] = {"checkpoints": len(cks), "frames": len(frames),
                 "runs": runs}

# a step that reads the host: the sharded runner's capture raises
cfg = SimConfig(particle_count=1024, save_images=False, shards=1)
full = pad_to_shards(init_scene(cfg, device=group.device), 1)
inner = driver.build_step(cfg, group.device, group)


def reading(s):
    float(s.sim_time)
    return inner(s)


r = driver._ShardedGraphWindows(reading, full, cfg, 0, 1, None, group)
try:
    r.advance(1, False)
    raised = "no error"
except driver.GraphCaptureError as e:
    raised = "GraphCaptureError: " + str(e).splitlines()[0][:160]
except Exception as e:
    raised = type(e).__name__ + ": " + str(e)[:160]
r.close()
out["host_read"] = raised
out["backend"] = dist.get_backend()
out["nccl_init_s"] = nccl_init
dist.destroy_process_group()
print(json.dumps(out))
"""


def phase_sharded_graph_windows():
    """41. The sharded graph windows on one card: a one-rank NCCL group in
    a child process runs the CLI on the default scene (exact, 200 steps, a
    frame every 10 and a checkpoint every 20) and on the 2-D bh million
    (20 steps, a checkpoint every 10) three ways: through
    ``_ShardedGraphWindows`` (each window one replay of a graph that holds
    the NCCL gathers), through ``_ShardedWindows`` (``_eager``) and
    through the single-device graph windows. Every checkpoint bitwise
    equal, every frame byte for byte, B1, B3 and B5's launches equal;
    ``Time taken`` and the capture seconds of each. Then a step that reads
    the host must make the sharded runner raise ``GraphCaptureError``.
    One rank has no ring shift: NCCL's p2p inside a graph is exercised
    only across cards (phase 39's multi-card part)."""
    specs = {
        "exact": {"config": "", "argv": [
            "--steps", str(STEPS), "--set", "checkpointEvery=20", "--set",
            "checkpointKeep=0", "--set", "imagePath=frames"]},
        "bh_million": {"config": config_text(million_config(
            checkpoint_every=10, checkpoint_keep=0)), "argv": []}}
    env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               LOCAL_WORLD_SIZE="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(free_port()))
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", PHASE41_CHILD, HERE,
                        json.dumps(specs)], env=env, capture_output=True,
                       text=True, timeout=900)
    check(r.returncode == 0, f"phase 41's one-rank NCCL child failed:\n"
                             f"{r.stdout[-2000:]}{r.stderr[-3000:]}")
    res = json.loads(r.stdout.strip().splitlines()[-1])
    print(f"sharded graph windows, one-rank {res['backend']} group "
          f"({time.perf_counter() - t0:.1f} s in its process; the first "
          f"collective, which makes NCCL's communicator, "
          f"{res['nccl_init_s']:.3f} s before the runs):")
    for name in specs:
        row = res[name]
        for way, run in row["runs"].items():
            print(f"  {name} ({row['checkpoints']} checkpoints, "
                  f"{row['frames']} frames), {way}: Time taken "
                  f"{run['time_taken']} s, capture {run['capture_s']:.4f} s, "
                  f"{run['windows']} windows, launches {run['launches']}, "
                  f"checkpoints bitwise {run['checkpoints_equal']}, frames "
                  f"byte for byte {run['frames_equal']}")
        runs = list(row["runs"].values())
        check(all(x["rc"] == 0 and x["checkpoints_equal"]
                  and x["frames_equal"] for x in runs),
              f"phase 41 {name}: the three runs differ: {row}")
        check(row["checkpoints"] > 0 and (name != "exact"
                                          or row["frames"] == STEPS // 10),
              f"phase 41 {name}: {row['checkpoints']} checkpoints, "
              f"{row['frames']} frames")
        kinds = ("B1",) if name == "exact" else ("B3", "B5")
        check(all(x["launches"] == runs[0]["launches"] for x in runs)
              and all(runs[0]["launches"][k] > 0 for k in kinds),
              f"phase 41 {name}: launches differ: "
              f"{[x['launches'] for x in runs]}")
        check(runs[0]["capture_s"] > 0 and runs[1]["capture_s"] == 0
              and runs[2]["capture_s"] > 0,
              f"phase 41 {name}: capture seconds "
              f"{[x['capture_s'] for x in runs]} (graph, eager, graph)")
    print(f"  a step that reads the host, sharded runner: {res['host_read']}")
    check(res["host_read"].startswith("GraphCaptureError"),
          f"a host read in a sharded window: {res['host_read']}")


def kernel_name(mangled):
    """``name<template args>`` of a kernel in an anonymous namespace, from
    its mangled name (the mangled name itself otherwise)."""
    m = re.match(r"_ZN(\d+)", mangled)
    if not m or not mangled[m.end():].startswith("_GLOBAL__N"):
        return mangled
    rest = mangled[m.end() + int(m.group(1)):]      # past the namespace
    m = re.match(r"\d+", rest)
    if not m:
        return mangled
    rest = rest[m.end():]
    name = rest[:int(m.group(0))]
    t = re.match(r"I((?:L[ib]\d+E)+)E", rest[len(name):])
    args = re.findall(r"L[ib](\d+)E", t.group(1)) if t else []
    return name + (f"<{','.join(args)}>" if args else "")


def ptxas_report(log):
    """ptxas's registers and spills for each kernel of a build log, one
    line a kernel."""
    rows, name = [], None
    for line in (log or "").splitlines():
        if "Compiling entry function '" in line:
            name = kernel_name(line.split("'")[1])
        elif name and "spill stores" in line:
            rows.append(f"{name}: {line.strip()}")
        elif name and "Used" in line and rows:
            rows[-1] += "; " + line.split(":", 1)[-1].strip().split(",")[0]
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")
    if not os.path.isdir(os.path.join(HERE, "nbodyax_torch")):
        fail("nbodyax_torch/ not found beside this script: run it from a "
             "checkout of the repository")
    sys.path.insert(0, HERE)
    from nbodyax_torch.config import SimConfig
    from nbodyax_torch.physics import _build
    from nbodyax_torch.rng import scene_arrays
    from nbodyax_torch.scenes import init_scene

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load_library()
    print(f"kernel builds + load: {time.perf_counter() - t0:.3f} s "
          f"({', '.join(src.name for src in _build.SOURCES)})")
    for src in (s.name for s in _build.SOURCES):
        rows = ptxas_report(_build.build_log(src))
        print(f"ptxas, {src}:" + ("".join(f"\n  {r}" for r in rows) if rows
                                  else " no report (library built "
                                  "elsewhere)"))

    cfg = SimConfig()
    scene = list(scene_arrays(cfg.seed, cfg.particle_count, cfg.field_width,
                              cfg.field_height, cfg.min_body_mass,
                              cfg.max_body_mass, cfg.min_radius,
                              cfg.max_radius))
    scene[2] = scene[2].copy()
    scene[2][7] = 0.0   # one dead slot

    b1_err = phase_kernel_vs_plain(dev, (random_state(300, 300), scene))
    phase_golden(dev, cfg)
    phase_golden_graph(dev)
    launches, _, _ = phase_main_path()
    phase_full_default_run()
    ms, b1_dev_ms, plain_ms, b1_bound_ = phase_timing(dev, scene, cfg)
    phase_graph_profile(dev, cfg, f"default scene N={cfg.particle_count}")
    phase_profile_flag()
    b2_err = phase_bwd_vs_plain(dev, (random_state(300, 300),
                                                scene))
    default_state = init_scene(cfg, device=dev)
    bwd_launches = phase_grad_path(default_state)
    phase_shooting(dev)
    phase_main_path(steps=20, integrator="leapfrog")
    phase_main_path(steps=20, integrator="yoshida4")
    phase_modes_graph(dev)
    phase_adaptive(2)
    phase_energy(dev)
    bwd_ms, b2_dev_ms, bwd_plain_ms, b2_bound_ = phase_bwd_timing(dev, scene)
    phase_grad_over_forward(default_state)
    phase_grad_graph(default_state)
    bh_cfg = million_config()
    arrays_1m = million_scene(bh_cfg)
    b5_err, b4_err = phase_slotpack(dev, arrays_1m)
    b3_err = phase_near(dev, arrays_1m)
    phase_bh_vs_exact(dev)
    b3_launches, b5_launches, ann_launches = phase_bh_main_path(bh_cfg)
    _, b4_launches, _ = phase_bh_direct()
    phase_bh_direct(far="fmm", order=2, adaptive=True)
    bh_times = phase_bh_timing(dev, arrays_1m, bh_cfg)

    cfg3, scene3d = default_scene_3d()
    scene3d[2][7] = 0.0   # one dead slot
    b1_3d_err = phase_kernel_vs_plain(dev, (random_state_3d(300, 300),
                                            scene3d), dims=3)
    phase_planar_3d(dev, scene)
    b2_3d_err = phase_bwd_vs_plain(dev, (random_state_3d(300, 300), scene3d),
                                   dims=3)
    launches_3d, _, _ = phase_main_path(dims=3)
    phase_adaptive(3)
    bwd_launches_3d = phase_grad_path(init_scene(cfg3, device=dev),
                                      runs=(("euler", 4, 1),))
    times_3d = phase_timing_3d(dev, scene, scene3d, cfg3)
    phase_graph_profile(dev, cfg3, f"3-D default scene N={len(scene3d[0])}")

    bh3_cfg = million_config(dimensions=3)
    arrays3_1m = scene_arrays_of(bh3_cfg)
    b5_3d_err, b4_3d_err = phase_slotpack(dev, arrays3_1m, BH3D_LEVELS,
                                          BH3D_S, dims=3)
    b3_3d_err = phase_near_3d(dev, arrays3_1m)
    phase_bh_vs_exact_3d(dev)
    b3_3d_launches, b5_3d_launches, ann_3d_launches = phase_bh_main_path(
        bh3_cfg)
    _, b4_3d_launches, _ = phase_bh_direct(dims=3)
    phase_bh_direct(dims=3, mode="elastic")
    phase_bh_direct(dims=3, mode="elastic", far="fmm", order=2)
    bh3_times = phase_bh_timing(dev, arrays3_1m, bh3_cfg, BH3D_LEVELS,
                                BH3D_S, BH3D_CI)
    annulus = phase_annulus(dev, arrays_1m, arrays3_1m)
    resume_ref = []
    shard = {}

    for name, phase in (
            ("28 compaction through graph windows", phase_compaction_graph),
            ("29 resume, exact", lambda: resume_ref.append(phase_resume())),
            ("29 resume, bh", lambda: phase_resume(bh=True)),
            ("30 autoResume", lambda: phase_auto_resume_fault(resume_ref[0])),
            ("31 galaxy example", lambda: phase_galaxy_example(dev)),
            ("32 million example", phase_million_example),
            ("33 scenes", lambda: phase_scenes(dev)),
            ("33 bh compaction", phase_bh_compaction),
            ("34 bh graph windows, 2-D", lambda: phase_bh_graphs(dev, 2)),
            ("34 bh graph windows, 3-D", lambda: phase_bh_graphs(dev, 3)),
            ("35 benchmark runners", phase_runners),
            ("35 suite config 6's tiers", lambda: phase_dense_bh_tiers(dev)),
            ("35 shooting example", phase_shooting_example),
            ("35 --debug-nans", phase_debug_nans),
            ("36 B3's cell slice", lambda: shard.update(
                slice=phase_near_slice(dev, arrays_1m, arrays3_1m))),
            ("37 cell-range bh, suite config 5's galaxy", lambda: shard.update(
                launches=phase_cellrange(dev, *galaxy_4m(dev),
                                         "suite config 5 galaxy N=4M"))),
            ("37 cell-range bh, 3-D 1M scene", lambda: phase_cellrange(
                dev, *resolved(bh3_cfg, arrays3_1m, dev), "3-D N=1M scene")),
            ("38 ring fold, config 3's scene", lambda: phase_ring_fold(
                dev, *exact_scene(dev, particle_count=131072), 8,
                label="suite config 3 N=131072")),
            ("38 ring fold, config 5's 4M galaxy, rank 0",
             lambda: phase_ring_fold(
                dev, *exact_scene(dev, particle_count=1 << 22,
                                  scene="galaxy", softening=100.0), 8,
                rows_of=[0], label="suite config 5 galaxy N=4M exact")),
            ("39 the collectives on CUDA tensors", lambda: shard.update(
                grads=phase_collectives_on_cuda())),
            ("40 B2 around the ring, default scene",
             lambda: phase_ring_backward(
                 dev, cross_tile_merges(scene, 8), "momentum", 8,
                 "default scene N=16384 with cross-tile merges")),
            ("40 B2 around the ring, config 3's scene", lambda: shard.update(
                ring=phase_ring_backward(
                    dev, exact_scene(dev, particle_count=131072)[0][:4],
                    "reference", 8, "suite config 3 N=131072",
                    timing=True))),
            ("41 sharded graph windows, one-rank NCCL",
             phase_sharded_graph_windows),
            ("42 the bench/ runners' counterparts, small",
             phase_bench_counterparts)):
        t0 = time.perf_counter()
        phase()
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "nbodyax")]
    check(not loaded, f"the port loaded JAX or nbodyax: {loaded[:5]}")

    rows = [
        ("pair_kernel", "pair_kernel.cu", "nbodyax/physics/kernels.py:92",
         launches, b1_err,
         {"ms": ms, "device_ms": b1_dev_ms, "plain_ms": plain_ms,
          "library_ms": None, "bound": b1_bound_}),
        ("pair_bwd_kernel", "pair_bwd_kernel.cu",
         "nbodyax/physics/kernels_bwd.py:79", bwd_launches, b2_err,
         {"ms": bwd_ms, "device_ms": b2_dev_ms, "plain_ms": bwd_plain_ms,
          "library_ms": None, "bound": b2_bound_}),
        ("near_kernel", "near_kernel.cu", "nbodyax/physics/near_pallas.py:96",
         b3_launches, b3_err, bh_times["B3"]),
        ("slot_pack_kernel", "slotpack_kernel.cu",
         "nbodyax/physics/slotpack_pallas.py:99", b4_launches,
         b4_err, bh_times["B4"]),
        ("slot_pack_moments_kernel", "slotpack_kernel.cu",
         "nbodyax/physics/slotpack_pallas.py:123", b5_launches,
         b5_err, bh_times["B5"]),
        ("pair_kernel_3d", "pair_kernel.cu", "nbodyax/physics/kernels.py:92",
         launches_3d, b1_3d_err, times_3d["B1"]),
        ("pair_bwd_kernel_3d", "pair_bwd_kernel.cu",
         "nbodyax/physics/kernels_bwd.py:79", bwd_launches_3d, b2_3d_err,
         times_3d["B2"]),
        ("near_kernel_3d", "near_kernel.cu",
         "nbodyax/physics/near_pallas.py:96", b3_3d_launches, b3_3d_err,
         bh3_times["B3"]),
        ("slot_pack_kernel_3d", "slotpack_kernel.cu",
         "nbodyax/physics/slotpack_pallas.py:99", b4_3d_launches,
         b4_3d_err, bh3_times["B4"]),
        ("slot_pack_moments_kernel_3d", "slotpack_kernel.cu",
         "nbodyax/physics/slotpack_pallas.py:123", b5_3d_launches,
         b5_3d_err, bh3_times["B5"]),
        ("annulus_kernel", "annulus_kernel.cu",
         "none (nbodyax/physics/barneshut.py _annulus_force_cells, jnp)",
         ann_launches, *annulus[2]),
        ("annulus_kernel_3d", "annulus_kernel.cu",
         "none (nbodyax/physics/barneshut.py _annulus_force_cells, jnp)",
         ann_3d_launches, *annulus[3]),
        ("near_kernel_slice", "near_kernel.cu",
         "nbodyax/physics/near_pallas.py:116", shard["launches"],
         shard["slice"][1], shard["slice"][0]),
        ("pair_bwd_kernel_ring", "pair_bwd_kernel.cu",
         "nbodyax/physics/kernels_bwd.py:79",
         shard["grads"]["launches"]["b2"], shard["ring"][0],
         shard["ring"][1])]
    print(smi)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": f"nbodyax_torch/csrc/{src}",
        "replaces": replaces, "launches": n_launch, "max_abs_err": err[0],
        "max_rel_err": err[1],
        "ms": t["ms"], "device_ms": t["device_ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound"][0],
        "bound_by": t["bound"][1], "library_ms": t["library_ms"]}
        for name, src, replaces, n_launch, err, t in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
