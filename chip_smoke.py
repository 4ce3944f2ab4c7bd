#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``nbodyax_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. print the card's name and power limit; build the four CUDA sources of
   ``nbodyax_torch/csrc`` (one ``nvcc`` a source, in parallel) and print the
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
4. run the main path: ``nbodyax_torch.cli`` with the built-in default
   config (N = 16,384, seed 1024) for 200 steps with a frame every 10, and
   check the 20 P5 frames, the log and that every step launched the kernel;
5. time the kernel against its plain version at N = 16,384 and alone at
   N = 131,072, with the splits chosen, the CUDA launches a call, pairs/s,
   the share of the bound and the SM clock under load; its own device time
   by the profiler beside the wrapper call's CUDA-event time; profile one
   default-scene step;
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
9. ``nbodyax_torch.cli`` with ``integrator=leapfrog`` for 20 steps, two
   forward launches a step;
10. time the backward kernel against its plain version at N = 16,384 and
    alone at N = 131,072 (as phase 5, device time too), one gradient step
    against one forward step, and profile one gradient call;
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
    ``forceModel=bh`` and default bh knobs for 20 steps: the knobs it
    picked, ``bh_overflow`` 0, B3 and B5 once a step;
15. ``bhFar=direct bhOrder=1`` on the CLI at N = 65,536: B4 once a step;
16. B3, B4 and B5 timed against their plain versions at N = 1M (B4 also
    against one gather), with bounds from the run's cell occupancy and
    each kernel's own device time; B4 and B5 by device time on the crowded
    N = 262,144 state and on a uniform state of the same N (the crowded
    cell's tail); one bh step (CUDA-event span, host wall of 5 steps), and
    one step's profiler breakdown and device idle share;
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
    for 200 steps, 20 P5 frames of the xy projection, ``momentum_z`` in
    every log line, one B1 launch a step;
20. the 3-D gradient path: a 4-step euler rollout of the 3-D default
    scene through the kernels against autograd of the oracle, as phase 7;
21. B1 and B2 in 3-D timed beside their 2-D calls at N = 16,384 (device
    time too), B1 alone at N = 1,048,576 in 3-D and 2-D (pairs/s and
    their ratio, as bench/dim3.py records), and one profiled 3-D step;
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
    device time; one 3-D bh step (CUDA-event span, host wall), its
    profiler breakdown, device idle share and peak memory.

The line before the last is a JSON object describing each kernel (the
wrapper call's CUDA-event time ``ms``, the kernel's own device time by
the profiler ``device_ms``, its plain version's time, its bound against
the H100's peak FP32 rate or memory rate, and one PyTorch call's time
where there is one); the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or outside
a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
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
    the largest absolute error of channels 0-5 on the main path's call."""
    from nbodyax_torch.physics.kernels import (MODES, body_features,
                                               decode_raw,
                                               tile_accumulators_raw,
                                               tile_accumulators_raw_reference)
    from nbodyax_torch.physics.pairwise import combine_accumulators

    max_abs_err = None
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
                max_abs_err = float((rk[alive, :6] - rp[alive, :6])
                                    .abs().max())
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
    return max_abs_err


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


def phase_main_path(steps=STEPS, integrator="euler", dims=2):
    """The CLI on the default config (with ``--set dimensions=3`` when
    ``dims`` is 3); each step must launch the forward kernel once a force
    pass (euler 1, leapfrog 2), and in 3-D every log line carries
    ``momentum_z``."""
    from nbodyax_torch import cli
    from nbodyax_torch.physics.kernels import tile_accumulators_raw

    passes = {"euler": 1, "leapfrog": 2}[integrator]

    with tempfile.TemporaryDirectory() as tmp:
        frames_dir = os.path.join(tmp, "frames")
        cwd = os.getcwd()
        buf = io.StringIO()
        # no nbodyConfig.txt in the temp dir: the built-in default config
        os.chdir(tmp)
        try:
            tile_accumulators_raw.launches = 0
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["--steps", str(steps), "--set",
                               f"imagePath={frames_dir}", "--set",
                               f"integrator={integrator}", "--set",
                               f"dimensions={dims}"])
            launches = tile_accumulators_raw.launches
        finally:
            os.chdir(cwd)
        out = buf.getvalue()
        check(rc == 0, f"cli exited {rc}")
        check(launches == passes * steps,
              f"kernel launched {launches} times in {steps} {integrator} "
              f"steps")
        taken = [l for l in out.splitlines() if l.startswith("Time taken: ")]
        check(len(taken) == 1, "no 'Time taken:' line")
        logs = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
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
        got = sorted(os.listdir(frames_dir),
                     key=lambda s: int(s.split("_")[1].split(".")[0]))
        check(got == want, f"frames {got}")
        header = b"P5\n1024 1024\n255\n"
        for name in want:
            with open(os.path.join(frames_dir, name), "rb") as f:
                raw = f.read()
            check(raw.startswith(header)
                  and len(raw) == len(header) + 1024 * 1024,
                  f"{name} is not a 1024x1024 P5 frame")
            body = np.frombuffer(raw[len(header):], np.uint8)
            check((body == 0).any() and (body == 254).any(),
                  f"{name} has no bodies or no background")
    extra = (f", momentum_z {last['momentum_z']:.6g} in every log line"
             if dims == 3 else "")
    print(f"main path ({dims}-D, {integrator}): {steps} steps, {len(want)} "
          f"P5 frames, {launches} kernel launches, {taken[0]}, "
          f"{last['alive']} alive{extra}")
    print(f"main path rates (device-timed): {last['steps_per_sec']:.6g} "
          f"steps/s, {last['pairs_per_sec']:.6g} pairs/s")
    return launches


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


def profile_breakdown(fn, reps, label, top=12):
    """torch.profiler over ``reps`` calls of fn: device time and device ops
    a call, the window's host wall, the device's idle share and the
    heaviest kernels. Returns device ms a call."""
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
    return total / reps / 1e3


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


def report_split_call(name, n, ms, splits, launches, bound):
    print(f"{name} N={n}: {ms:.4f} ms, splits {splits}, {launches}, "
          f"{n * n / (ms / 1e3):.6g} pairs/s, bound "
          f"{bound[0]:.4f} ms ({bound[1]}), {100 * bound[0] / ms:.1f}% of "
          f"the bound")


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
                      cuda_launches(fns["kernel"]), bound)
    print(f"B1 N={n}: {clocks_under(fns['kernel'], ms=ms)}")
    dms = report_device("B1", n, fns["kernel"], B1_TAGS, ms, bound)
    big = scene_features(dev, 131072)
    nb = big.shape[0]

    def call():
        return tile_accumulators_raw(big, big, 0, 0, **kw)
    report_split_call("B1 alone", nb, time_ms(call, reps=5),
                      forward_splits(nb, nb, "reference", dev),
                      cuda_launches(call), b1_bound(nb))
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
    path's scene) in ``dims`` dimensions. Returns the largest absolute
    error on the main path's scene in reference mode."""
    from nbodyax_torch.physics.kernels import (MODES, body_features,
                                               tile_accumulators_raw)
    from nbodyax_torch.physics.kernels_bwd import (raw_backward,
                                                   raw_backward_reference)

    def both(fi, fj, i0, j0, gi, kw):
        _, par = tile_accumulators_raw(fi, fj, i0, j0, **kw)
        return (raw_backward(fi, fj, i0, j0, par, gi, **kw),
                raw_backward_reference(fi, fj, i0, j0, par, gi, **kw))

    max_abs_err = None
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
                max_abs_err = max(float((a - b).abs().max())
                                  for a, b in zip(got, want))
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
    return max_abs_err


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


def phase_grad_over_forward(state):
    """bench/grad_step.py's grad_over_forward: one gradient step of a
    4-step euler rollout through the kernels, against one forward step, and
    the profile of one gradient call."""
    from nbodyax_torch.backends import build_accum_fn
    from nbodyax_torch.physics.step import PhysicsParams, make_step

    cfg, steps = grad_config("euler"), 4
    p = PhysicsParams.from_config(cfg)
    step = make_step(p, accum_fn=build_accum_fn("pallas", p,
                                                state.pos.device))
    fwd_ms = time_ms(lambda: step(state), reps=20)
    grad_ms = time_ms(lambda: rollout_grads(state, cfg, "pallas", steps),
                      reps=5) / steps
    print(f"gradient step N={state.capacity} ({steps}-step euler rollout, "
          f"remat): {grad_ms:.4f} ms a step; forward step {fwd_ms:.4f} ms; "
          f"grad_over_forward {grad_ms / fwd_ms:.4f}")
    profile_breakdown(lambda: rollout_grads(state, cfg, "pallas", steps), 3,
                      f"gradient of a {steps}-step euler rollout "
                      f"N={state.capacity}")


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
    floats, and 10 moments. Returns the largest absolute moment error (B5)
    and row error (B4) seen."""
    from nbodyax_torch.physics.slotpack_kernel import (
        build_slot_grid_reference, finest_moments_reference, pack_slots)
    worst = worst_rows = 0.0
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
        worst = max(worst, float((mom_k - mom_p).abs().max()))
        worst_rows = max(worst_rows, float((rows_b4 - rows_p).abs().max()))
        print(f"slot pack {name} L={L}: B4/B5 rows bitwise equal to the "
              f"gather (max cell occupancy {occ}); B5's {mom_k.shape[1]} "
              f"moments {err:.3e} of the per-channel scale (gate "
              f"{MOM_GATE})")
        check(err < MOM_GATE, f"B5 moments off by {err} ({name} L={L})")
    return worst, worst_rows


def near_compare(fslot, mode, eps2, g, ring, ci, dim=2):
    """B3 against its plain version at every live i slot: float channels
    relative to the channel's largest value, id and flag channels exact,
    and a second call bitwise equal to the first. Returns (errors, passed,
    largest absolute error)."""
    from nbodyax_torch.physics.near_kernel import (slots_near,
                                                   slots_near_reference)
    kw = dict(mode=mode, eps2=eps2, growth=0.1, g=g, ring=ring, ci=ci,
              dim=dim)
    k = slots_near(fslot, **kw)
    repeats = bool(torch.equal(k, slots_near(fslot, **kw)))
    p = slots_near_reference(fslot, **kw)
    rest = 2 * dim if mode == "elastic" else dim
    live = fslot[:, :ci, rest] > 0
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
    return err, ok, float((k[fin, :dim] - p[fin, :dim]).abs().max())


def phase_near(dev, arrays_1m):
    """B3 against its plain version in all four modes at eps 0 and 100 on
    a crowded N = 65,536 state (dead body, grid edges, a cell far past the
    slot budget), and on the N = 1M scene in the main path's mode. Returns
    the largest absolute force error on the 1M scene."""
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


def run_cli(argv, cfg_text, tmp):
    """Run nbodyax_torch.cli on ``cfg_text``; returns (stdout, rc)."""
    from nbodyax_torch import cli
    path = os.path.join(tmp, "nbodyConfig.txt")
    with open(path, "w") as f:
        f.write(cfg_text)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--config", path] + argv)
    return buf.getvalue(), rc


def config_text(cfg):
    from nbodyax_torch.config import _KEYS
    out = []
    for key, (attr, _) in _KEYS.items():
        v = getattr(cfg, attr)
        out.append(f"{key}={str(v).lower() if isinstance(v, bool) else v}")
    return "\n".join(out) + "\n"


def phase_bh_main_path(cfg):
    """The CLI on the N = 1M bh configuration (2-D, or 3-D with
    ``dimensions=3``) for 20 steps: the knobs it picked, bh_overflow 0, a
    finite state, B3 and B5 once a step, the run's peak device memory.
    Returns (B3 launches, B5 launches)."""
    from nbodyax_torch.physics.near_kernel import slots_near
    from nbodyax_torch.physics.slotpack_kernel import pack_slots
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.reset_peak_memory_stats()
        slots_near.launches = 0
        pack_slots.moment_launches = 0
        out, rc = run_cli([], config_text(cfg), tmp)
        b3, b5 = slots_near.launches, pack_slots.moment_launches
        peak = torch.cuda.max_memory_allocated()
    check(rc == 0, f"bh cli exited {rc}")
    knobs = [l for l in out.splitlines() if l.startswith("bh auto-selected")]
    check(len(knobs) == 1, "no 'bh auto-selected' line")
    logs = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
    steps = cfg.total_iterations
    check(len(logs) == steps // cfg.log_every, f"log lines: {len(logs)}")
    for rec in logs:
        check(rec["bh_overflow"] == 0, f"bh_overflow {rec['bh_overflow']}")
        check(all(np.isfinite(v) for v in rec.values()
                  if isinstance(v, float)), f"non-finite log values: {rec}")
    check(b3 == steps and b5 == steps,
          f"B3 launched {b3} and B5 {b5} times in {steps} steps")
    taken = [l for l in out.splitlines() if l.startswith("Time taken: ")]
    check(len(taken) == 1, "no 'Time taken:' line")
    last = logs[-1]
    if cfg.dimensions == 3:
        check(all("momentum_z" in rec for rec in logs),
              "a 3-D bh log line without momentum_z")
    print(f"bh main path {cfg.dimensions}-D N={cfg.particle_count}: "
          f"{knobs[0]}; peak device memory {peak / 2 ** 30:.3f} GiB")
    print(f"bh main path {cfg.dimensions}-D: {steps} steps, B3 {b3} and B5 "
          f"{b5} launches, "
          f"bh_overflow {[r['bh_overflow'] for r in logs]}, "
          f"bh_giant_excess {last['bh_giant_excess']}, {last['alive']} "
          f"alive, {taken[0]}, {last['steps_per_sec']:.6g} steps/s "
          f"(device-timed, cumulative), last window {last['wall_ms']:.4f} "
          f"ms a step")
    return b3, b5


def phase_bh_direct(dims=2, mode="reference", far="direct", order=1):
    """The CLI at N = 65,536 for 10 steps with ``bhNear=slots``. With
    ``bhFar=direct bhOrder=1`` the slots engine packs with B4 (no moments
    wanted) once a step, with the FMM with B5; B3 runs once a step either
    way. In 3-D the rows are 7 wide, 10 in elastic mode. Returns the
    launches of (B3, B4, B5)."""
    from nbodyax_torch.config import SimConfig
    from nbodyax_torch.physics.near_kernel import slots_near
    from nbodyax_torch.physics.slotpack_kernel import pack_slots
    cfg = SimConfig(particle_count=65536, total_iterations=10,
                    save_images=False, force_model="bh", bh_far=far,
                    bh_order=order, bh_near="slots", dimensions=dims,
                    collision_mode=mode)
    with tempfile.TemporaryDirectory() as tmp:
        slots_near.launches = 0
        pack_slots.launches = pack_slots.moment_launches = 0
        out, rc = run_cli([], config_text(cfg), tmp)
        got = (slots_near.launches, pack_slots.launches,
               pack_slots.moment_launches)
    check(rc == 0, f"bh {far} {dims}-D {mode} cli exited {rc}")
    logs = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
    check(logs and logs[-1]["bh_overflow"] == 0, f"{far} logs {logs[-1:]}")
    want = (10, 10, 0) if (far, order) == ("direct", 1) else (10, 0, 10)
    check(got == want, f"bh {far} order {order} {dims}-D {mode}: B3, B4, B5 "
          f"launched {got} times in 10 steps, expected {want}")
    print(f"bhFar={far} bhOrder={order} {dims}-D {mode} N=65536: 10 steps, "
          f"B3 {got[0]}, B4 {got[1]}, B5 {got[2]} launches, "
          f"{logs[-1]['alive']} alive")
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

    profile_breakdown(lambda: step(state), 3, f"bh step {dims}-D N=1M")
    return times


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
    scene, a torch.Generator draw from the seed)."""
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
                          "1 call", bound_ms(nb * nb * flops, 3 * nb * 32))
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
    port's 3-D uniform scene is a torch.Generator draw from the seed."""
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
    grid in the main path's mode. Returns the largest absolute force error
    on the 1M scene."""
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

    max_abs_err = phase_kernel_vs_plain(dev, (random_state(300, 300), scene))
    phase_golden(dev, cfg)
    launches = phase_main_path()
    ms, b1_dev_ms, plain_ms, b1_bound_ = phase_timing(dev, scene, cfg)
    bwd_max_abs_err = phase_bwd_vs_plain(dev, (random_state(300, 300),
                                                scene))
    default_state = init_scene(cfg, device=dev)
    bwd_launches = phase_grad_path(default_state)
    phase_shooting(dev)
    phase_main_path(steps=20, integrator="leapfrog")
    bwd_ms, b2_dev_ms, bwd_plain_ms, b2_bound_ = phase_bwd_timing(dev, scene)
    phase_grad_over_forward(default_state)
    bh_cfg = million_config()
    arrays_1m = million_scene(bh_cfg)
    b5_max_abs_err, b4_max_abs_err = phase_slotpack(dev, arrays_1m)
    b3_max_abs_err = phase_near(dev, arrays_1m)
    phase_bh_vs_exact(dev)
    b3_launches, b5_launches = phase_bh_main_path(bh_cfg)
    _, b4_launches, _ = phase_bh_direct()
    bh_times = phase_bh_timing(dev, arrays_1m, bh_cfg)

    cfg3, scene3d = default_scene_3d()
    scene3d[2][7] = 0.0   # one dead slot
    b1_3d_err = phase_kernel_vs_plain(dev, (random_state_3d(300, 300),
                                            scene3d), dims=3)
    phase_planar_3d(dev, scene)
    b2_3d_err = phase_bwd_vs_plain(dev, (random_state_3d(300, 300), scene3d),
                                   dims=3)
    launches_3d = phase_main_path(dims=3)
    bwd_launches_3d = phase_grad_path(init_scene(cfg3, device=dev),
                                      runs=(("euler", 4, 1),))
    times_3d = phase_timing_3d(dev, scene, scene3d, cfg3)

    bh3_cfg = million_config(dimensions=3)
    arrays3_1m = scene_arrays_of(bh3_cfg)
    b5_3d_err, b4_3d_err = phase_slotpack(dev, arrays3_1m, BH3D_LEVELS,
                                          BH3D_S, dims=3)
    b3_3d_err = phase_near_3d(dev, arrays3_1m)
    phase_bh_vs_exact_3d(dev)
    b3_3d_launches, b5_3d_launches = phase_bh_main_path(bh3_cfg)
    _, b4_3d_launches, _ = phase_bh_direct(dims=3)
    phase_bh_direct(dims=3, mode="elastic")
    phase_bh_direct(dims=3, mode="elastic", far="fmm", order=2)
    bh3_times = phase_bh_timing(dev, arrays3_1m, bh3_cfg, BH3D_LEVELS,
                                BH3D_S, BH3D_CI)
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "nbodyax")]
    check(not loaded, f"the port loaded JAX or nbodyax: {loaded[:5]}")

    rows = [
        ("pair_kernel", "pair_kernel.cu", "nbodyax/physics/kernels.py:92",
         launches, max_abs_err,
         {"ms": ms, "device_ms": b1_dev_ms, "plain_ms": plain_ms,
          "library_ms": None, "bound": b1_bound_}),
        ("pair_bwd_kernel", "pair_bwd_kernel.cu",
         "nbodyax/physics/kernels_bwd.py:79", bwd_launches, bwd_max_abs_err,
         {"ms": bwd_ms, "device_ms": b2_dev_ms, "plain_ms": bwd_plain_ms,
          "library_ms": None, "bound": b2_bound_}),
        ("near_kernel", "near_kernel.cu", "nbodyax/physics/near_pallas.py:96",
         b3_launches, b3_max_abs_err, bh_times["B3"]),
        ("slot_pack_kernel", "slotpack_kernel.cu",
         "nbodyax/physics/slotpack_pallas.py:99", b4_launches,
         b4_max_abs_err, bh_times["B4"]),
        ("slot_pack_moments_kernel", "slotpack_kernel.cu",
         "nbodyax/physics/slotpack_pallas.py:123", b5_launches,
         b5_max_abs_err, bh_times["B5"]),
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
         b5_3d_err, bh3_times["B5"])]
    print(smi)
    print(json.dumps({"kernels": [{
        "name": name, "route": "cuda", "source": f"nbodyax_torch/csrc/{src}",
        "replaces": replaces, "launches": n_launch, "max_abs_err": err,
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
