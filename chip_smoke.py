#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``nbodyax_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. print the card's name and power limit; build the four CUDA sources of
   ``nbodyax_torch/csrc`` (one ``nvcc`` a source, in parallel) and print the
   build time;
2. compare the all-pairs kernel with its plain PyTorch version on the card,
   in all four collision modes, at N = 300 (random, dense overlaps) and at
   N = 16,384 (the default scene), each with a dead slot, plus offset calls
   over split j halves, at the gates of tests/test_kernels.py;
3. run the external C++-oracle golden ``tests/golden/ref_n1k.npz`` for 200
   steps through the kernel, at the gates of tests/test_golden.py, and 20
   steps of the default scene through the kernel against the plain path;
4. run the main path: ``nbodyax_torch.cli`` with the built-in default
   config (N = 16,384, seed 1024) for 200 steps with a frame every 10, and
   check the 20 P5 frames, the log and that every step launched the kernel;
5. time the kernel against its plain version at N = 16,384;
6. compare the backward kernel with its plain version on the same inputs
   as phase 2, in all four modes at eps = 0 and in elastic mode at eps = 5,
   with a numpy-made cotangent, plus offset calls whose two j halves sum
   to the full call, at tests/test_autodiff.py's gate (3e-6);
7. the differentiable path at full width: the gradient of a 4-step euler
   and a 2-step leapfrog rollout of the default scene (softening 100,
   bench/grad_step.py's terminal loss) with respect to the initial pos and
   mass, through the kernels and through autograd of the torch oracle,
   with the launch counts the rollout must make;
8. the shooting descent of tests/test_autodiff.py through the kernels;
9. ``nbodyax_torch.cli`` with ``integrator=leapfrog`` for 20 steps, two
   forward launches a step;
10. time the backward kernel against its plain version, and one gradient
    step against one forward step, at N = 16,384;
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
16. B3, B4 and B5 timed against their plain versions at N = 1M, one bh
    step, and one step's profiler breakdown and device idle share.

The line before the last is a JSON object describing each kernel; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or outside
a checkout, it exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
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


def equivalence_errors(a, b, mode):
    """tests/test_kernels.py::assert_equivalent's gates: (errors, passed)."""
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
        ok &= err["dv_rel"] < 1e-5
    return err, ok


def phase_kernel_vs_plain(dev, default_scene):
    from nbodyax_torch.physics.kernels import (MODES, body_features,
                                               decode_raw,
                                               tile_accumulators_raw,
                                               tile_accumulators_raw_reference)
    from nbodyax_torch.physics.pairwise import combine_accumulators

    max_abs_err = None
    for arrays in (random_state(300, 300), default_scene):
        pos, vel, mass, radius = (torch.from_numpy(x).to(dev) for x in arrays)
        n = pos.shape[0]
        feats = body_features(pos, vel, mass, radius)
        alive = mass > 0
        for mode in MODES:
            kw = dict(mode=mode, eps=0.0, growth_rate=0.1)
            rk, pk = tile_accumulators_raw(feats, feats, 0, 0, **kw)
            rp, pp = tile_accumulators_raw_reference(feats, feats, 0, 0, **kw)
            a = decode_raw(rk, pk, 0, mass, mode)
            b = decode_raw(rp, pp, 0, mass, mode)
            err, ok = equivalence_errors(a, b, mode)
            print(f"kernel vs plain N={n} {mode}: {json.dumps(err)}")
            check(ok, f"kernel disagrees with its plain version at N={n} "
                      f"mode={mode}: {err}")
            if arrays is default_scene and mode == "reference":
                # the main path's call: raw channels 0-5 of the live rows
                max_abs_err = float((rk[alive, :6] - rp[alive, :6])
                                    .abs().max())
        # offset calls: an i range against the two j halves, combined,
        # equals the full pass (the building block of split and ring paths)
        i0, i1, half = n // 4, n // 2, n // 2
        for mode in ("momentum", "reference"):
            kw = dict(mode=mode, eps=0.0, growth_rate=0.1)
            fi = feats[i0:i1]
            parts = []
            for j0, j1 in ((0, half), (half, n)):
                rk, pk = tile_accumulators_raw(fi, feats[j0:j1], i0, j0, **kw)
                rp, pp = tile_accumulators_raw_reference(
                    fi, feats[j0:j1], i0, j0, **kw)
                ka = decode_raw(rk, pk, i0, mass[i0:i1], mode)
                pa = decode_raw(rp, pp, i0, mass[i0:i1], mode)
                err, ok = equivalence_errors(ka, pa, mode)
                check(ok, f"offset call j[{j0}:{j1}] N={n} {mode}: {err}")
                parts.append(ka)
            combined = combine_accumulators(*parts)
            rf, pf = tile_accumulators_raw(feats, feats, 0, 0, **kw)
            full = decode_raw(rf, pf, 0, mass, mode)
            full = type(full)(*(x[i0:i1] for x in full))
            err, ok = equivalence_errors(combined, full, mode)
            print(f"offset halves vs full N={n} {mode}: {json.dumps(err)}")
            check(ok, f"offset halves disagree with the full pass at N={n} "
                      f"mode={mode}: {err}")
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


def phase_main_path(steps=STEPS, integrator="euler"):
    """The CLI on the default config; each step must launch the forward
    kernel once a force pass (euler 1, leapfrog 2)."""
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
                               f"integrator={integrator}"])
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
    print(f"main path ({integrator}): {steps} steps, {len(want)} P5 frames, "
          f"{launches} kernel launches, {taken[0]}, {last['alive']} alive")
    print(f"main path rates (device-timed): {last['steps_per_sec']:.6g} "
          f"steps/s, {last['pairs_per_sec']:.6g} pairs/s")
    return launches


def time_ms(fn, reps=20):
    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def phase_timing(dev, default_scene):
    from nbodyax_torch.physics.kernels import (body_features,
                                               tile_accumulators_raw,
                                               tile_accumulators_raw_reference)
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
    return float(np.mean(times["kernel"])), float(np.mean(times["plain"]))


def bwd_errors(got, want):
    """Largest error of each output over its own largest component."""
    return [float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))
            for a, b in zip(got, want)]


def cotangent(n, dev):
    g = np.random.RandomState(n).standard_normal((n, 8)).astype(np.float32)
    return torch.from_numpy(g).to(dev)


def phase_bwd_vs_plain(dev, default_scene):
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
    for arrays in (random_state(300, 300), default_scene):
        pos, vel, mass, radius = (torch.from_numpy(x).to(dev) for x in arrays)
        n = pos.shape[0]
        feats = body_features(pos, vel, mass, radius)
        g = cotangent(n, dev)
        for mode, eps in cases:
            kw = dict(mode=mode, eps=eps, growth_rate=0.1)
            got, want = both(feats, feats, 0, 0, g, kw)
            err = bwd_errors(got, want)
            print(f"backward kernel vs plain N={n} {mode} eps={eps}: "
                  f"d_feats_i {err[0]:.3e}, d_feats_j {err[1]:.3e}")
            check(all(bool(torch.isfinite(x).all()) for x in got),
                  f"backward kernel: non-finite gradient N={n} {mode}")
            check(max(err) < BWD_GATE, f"backward kernel disagrees with its "
                  f"plain version at N={n} mode={mode} eps={eps}: {err}")
            if arrays is default_scene and (mode, eps) == ("reference", 0.0):
                max_abs_err = max(float((a - b).abs().max())
                                  for a, b in zip(got, want))
        # an i range against the two j halves: each call matches the plain
        # version, and the halves' d_feats_i sum to the full call's
        i0, i1, half = n // 4, n // 2, n // 2
        for mode in ("reference", "momentum"):
            kw = dict(mode=mode, eps=0.0, growth_rate=0.1)
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
            print(f"backward offset halves vs full N={n} {mode}: {err:.3e}")
            check(err < BWD_GATE, f"backward halves disagree with the full "
                  f"call at N={n} mode={mode}: {err}")
    return max_abs_err


def grad_config(integrator):
    """bench/grad_step.py's settings on the default scene."""
    from nbodyax_torch.config import SimConfig
    return SimConfig(collision_mode="reference", softening=100.0,
                     integrator=integrator, save_images=False)


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


def phase_grad_path(state):
    """The differentiable path at full width, through the kernels and
    through autograd of the torch oracle. Returns the backward kernel's
    launch count in the euler run."""
    from nbodyax_torch.physics.kernels import tile_accumulators_raw
    from nbodyax_torch.physics.kernels_bwd import raw_backward

    b2_launches = None
    for integrator, steps, passes in (("euler", 4, 1), ("leapfrog", 2, 2)):
        cfg = grad_config(integrator)
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
        print(f"rollout gradient N={state.capacity}, {steps} {integrator} "
              f"steps, kernels vs oracle autograd: pos {errs[0]:.3e}, mass "
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


def phase_bwd_timing(dev, default_scene):
    from nbodyax_torch.physics.kernels import body_features
    from nbodyax_torch.physics.kernels_bwd import (raw_backward,
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
    return float(np.mean(times["kernel"])), float(np.mean(times["plain"]))


def phase_grad_over_forward(state):
    """bench/grad_step.py's grad_over_forward: one gradient step of a
    4-step euler rollout through the kernels, against one forward step."""
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


def crowded_state(n, seed, field, dead=True):
    """Uniform bodies over +-field, a quarter of them inside one small
    patch at the centre, body 7 dead."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-field, field, (n, 2)).astype(np.float32)
    pos[: n // 4] = rng.uniform(-field / 3000, field / 3000, (n // 4, 2))
    vel = rng.uniform(-3, 3, (n, 2)).astype(np.float32)
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


def phase_slotpack(dev, arrays_1m):
    """B5 (and B4) against their plain versions: rows bitwise, moments at
    2e-6 of max(per-channel scale, 1), on the N = 1M scene and on a
    crowded state. Returns the largest absolute moment error (B5) and row
    error (B4) seen."""
    from nbodyax_torch.physics.slotpack_kernel import (
        build_slot_grid_reference, finest_moments_reference, pack_slots)
    levels, S = 8, 40
    worst = worst_rows = 0.0
    for name, arrays in (("scene N=1M", arrays_1m),
                         ("crowded N=262144",
                          crowded_state(1 << 18, 4, 1e6))):
        (pos, _, mass, _), ext, st = bh_structure(arrays, dev, levels, False)
        n, ncells = pos.shape[0], 1 << (2 * levels)
        rows_k, mom_k = pack_slots(st[4], st[2], st[3], S,
                                   moments=(pos, mass, ext, levels))
        rows_b4 = pack_slots(st[4], st[2], st[3], S)
        rows_p = build_slot_grid_reference(st[4], st[2], st[3], n, ncells, S)
        mom_p = finest_moments_reference(pos, mass, ext, levels)
        torch.cuda.synchronize()
        occ = int((st[3] - st[2]).max())
        check(torch.equal(rows_k, rows_p), f"B5 rows differ ({name})")
        check(torch.equal(rows_b4, rows_p), f"B4 rows differ ({name})")
        scale = mom_p.abs().amax(0).clamp(min=1.0)
        err = ((mom_k - mom_p).abs().amax(0) / scale).max().item()
        worst = max(worst, float((mom_k - mom_p).abs().max()))
        worst_rows = max(worst_rows, float((rows_b4 - rows_p).abs().max()))
        print(f"slot pack {name}: B4/B5 rows bitwise equal to the gather "
              f"(max cell occupancy {occ}); B5 moments {err:.3e} of the "
              f"per-channel scale (gate {MOM_GATE})")
        check(err < MOM_GATE, f"B5 moments off by {err} ({name})")
    return worst, worst_rows


def near_compare(fslot, mode, eps2, g, ring, ci):
    """B3 against its plain version at every live i slot: float channels
    relative to the channel's largest value, id and flag channels exact.
    Returns (errors, passed, largest absolute error)."""
    from nbodyax_torch.physics.near_kernel import (slots_near,
                                                   slots_near_reference)
    kw = dict(mode=mode, eps2=eps2, growth=0.1, g=g, ring=ring, ci=ci)
    k = slots_near(fslot, **kw)
    p = slots_near_reference(fslot, **kw)
    rest = 4 if mode == "elastic" else 2
    live = fslot[:, :ci, rest] > 0
    k, p = k[live], p[live]
    floats = {"reference": [0, 1, 2, 3], "momentum": [0, 1],
              "elastic": [0, 1, 2, 3], "none": [0, 1]}[mode]
    exact = {"reference": [4], "momentum": [3, 4]}.get(mode, [])
    err, ok = {}, True
    for c in floats:
        e = float((k[:, c] - p[:, c]).abs().max()
                  / p[:, c].abs().max().clamp(min=1e-30))
        err[f"ch{c}"] = e
        ok &= e < NEAR_GATE
    if mode == "momentum":
        fin = torch.isfinite(p[:, 2])
        ok &= bool(torch.equal(fin, torch.isfinite(k[:, 2])))
        e = float((k[fin, 2] - p[fin, 2]).abs().max()
                  / p[fin, 2].abs().max().clamp(min=1e-30)) if fin.any() \
            else 0.0
        err["best_mass"] = e
        ok &= e < NEAR_GATE
    for c in exact:
        same = bool(torch.equal(k[:, c], p[:, c]))
        err[f"ch{c}_exact"] = same
        ok &= same
    fin = torch.isfinite(p[:, :2]).all(1)
    return err, ok, float((k[fin, :2] - p[fin, :2]).abs().max())


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
    """The CLI on the N = 1M bh configuration for 20 steps: the knobs it
    picked, bh_overflow 0, a finite state, B3 and B5 once a step. Returns
    (B3 launches, B5 launches)."""
    from nbodyax_torch.physics.near_kernel import slots_near
    from nbodyax_torch.physics.slotpack_kernel import pack_slots
    with tempfile.TemporaryDirectory() as tmp:
        slots_near.launches = 0
        pack_slots.moment_launches = 0
        out, rc = run_cli([], config_text(cfg), tmp)
        b3, b5 = slots_near.launches, pack_slots.moment_launches
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
    print(f"bh main path N={cfg.particle_count}: {knobs[0]}")
    print(f"bh main path: {steps} steps, B3 {b3} and B5 {b5} launches, "
          f"bh_overflow {[r['bh_overflow'] for r in logs]}, "
          f"bh_giant_excess {last['bh_giant_excess']}, {last['alive']} "
          f"alive, {taken[0]}, {last['steps_per_sec']:.6g} steps/s "
          f"(device-timed, cumulative), last window {last['wall_ms']:.4f} "
          f"ms a step")
    return b3, b5


def phase_bh_direct():
    """bhFar=direct bhOrder=1 on the CLI at N = 65,536 for 10 steps: the
    slots engine packs with B4 (no moments wanted) once a step."""
    from nbodyax_torch.config import SimConfig
    from nbodyax_torch.physics.slotpack_kernel import pack_slots
    cfg = SimConfig(particle_count=65536, total_iterations=10,
                    save_images=False, force_model="bh", bh_far="direct",
                    bh_order=1, bh_near="slots")
    with tempfile.TemporaryDirectory() as tmp:
        pack_slots.launches = 0
        out, rc = run_cli([], config_text(cfg), tmp)
        b4 = pack_slots.launches
    check(rc == 0, f"bh direct cli exited {rc}")
    logs = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
    check(logs and logs[-1]["bh_overflow"] == 0, f"direct logs {logs[-1:]}")
    check(b4 == 10, f"B4 launched {b4} times in 10 steps")
    print(f"bhFar=direct bhOrder=1 N=65536: 10 steps, B4 {b4} launches, "
          f"{logs[-1]['alive']} alive")
    return b4


def phase_bh_timing(dev, arrays_1m, cfg):
    """B3, B4 and B5 against their plain versions at N = 1M (CUDA events,
    turns plain, kernel, kernel, plain), one bh step (device span and host
    wall), and one step's torch.profiler device ops and idle share."""
    from nbodyax_torch.driver import resolve_bh_config
    from nbodyax_torch.backends import build_accum_fn
    from nbodyax_torch.physics.near_kernel import (slots_near,
                                                   slots_near_reference)
    from nbodyax_torch.physics.slotpack_kernel import (
        build_slot_grid_reference, finest_moments_reference, pack_slots)
    from nbodyax_torch.physics.step import PhysicsParams, make_step
    from nbodyax_torch.state import make_state

    levels, S, ci = 8, 40, 32
    (pos, _, mass, _), ext, st = bh_structure(arrays_1m, dev, levels, False)
    n, ncells = pos.shape[0], 1 << 16
    fslot = pack_slots(st[4], st[2], st[3], S)
    kw = dict(mode="reference", eps2=0.0, growth=0.1, g=1 << levels, ring=1,
              ci=ci)
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
    times = {}
    for name, (kern, plain) in fns.items():
        t = {"kernel": [], "plain": []}
        for which in ("plain", "kernel", "kernel", "plain"):
            fn = kern if which == "kernel" else plain
            t[which].append(time_ms(fn, reps=5 if which == "plain" else 20))
        print(f"{name} N=1M: kernel {t['kernel']} ms, plain {t['plain']} ms")
        times[name] = (float(np.mean(t["kernel"])),
                       float(np.mean(t["plain"])))

    state = make_state(*arrays_1m, device=dev)
    rcfg = resolve_bh_config(cfg, state)
    p = PhysicsParams.from_config(rcfg)
    step = make_step(p, accum_fn=build_accum_fn(rcfg.backend, p, dev, rcfg))
    step(state)
    torch.cuda.synchronize()
    dev_ms = time_ms(lambda: step(state), reps=5)
    t0 = time.perf_counter()
    for _ in range(5):
        step(state)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / 5 * 1e3
    print(f"bh step N=1M ({rcfg.bh_near}, levels {rcfg.bh_levels}, K "
          f"{rcfg.bh_neighbor_k}): {dev_ms:.4f} ms CUDA-event span, "
          f"{wall_ms:.4f} ms host wall a step")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            step(state)
        torch.cuda.synchronize()
        win = (time.perf_counter() - t0) * 1e6
    from torch.autograd import DeviceType
    rows = []
    for ev in prof.key_averages():
        d = getattr(ev, "self_device_time_total",
                    getattr(ev, "self_cuda_time_total", 0))
        if d > 0 and ev.device_type == DeviceType.CUDA:   # kernels only
            rows.append((d, ev.key, ev.count))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    print(f"profiler, 3 bh steps N=1M: {total / 3e3:.4f} ms device time a "
          f"step in {sum(r[2] for r in rows) // 3} device ops, window "
          f"{win / 3e3:.4f} ms a step, device idle "
          f"{100 * (1 - total / win):.1f}%")
    for d, key, cnt in rows[:12]:
        print(f"  {d / 3e3:9.4f} ms/step  {100 * d / total:5.1f}%  "
              f"x{cnt // 3:<4d} {key[:90]}")
    return times


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

    cfg = SimConfig()
    scene = list(scene_arrays(cfg.seed, cfg.particle_count, cfg.field_width,
                              cfg.field_height, cfg.min_body_mass,
                              cfg.max_body_mass, cfg.min_radius,
                              cfg.max_radius))
    scene[2] = scene[2].copy()
    scene[2][7] = 0.0   # one dead slot

    max_abs_err = phase_kernel_vs_plain(dev, scene)
    phase_golden(dev, cfg)
    launches = phase_main_path()
    ms, plain_ms = phase_timing(dev, scene)
    bwd_max_abs_err = phase_bwd_vs_plain(dev, scene)
    default_state = init_scene(cfg, device=dev)
    bwd_launches = phase_grad_path(default_state)
    phase_shooting(dev)
    phase_main_path(steps=20, integrator="leapfrog")
    bwd_ms, bwd_plain_ms = phase_bwd_timing(dev, scene)
    phase_grad_over_forward(default_state)
    bh_cfg = million_config()
    arrays_1m = million_scene(bh_cfg)
    b5_max_abs_err, b4_max_abs_err = phase_slotpack(dev, arrays_1m)
    b3_max_abs_err = phase_near(dev, arrays_1m)
    phase_bh_vs_exact(dev)
    b3_launches, b5_launches = phase_bh_main_path(bh_cfg)
    b4_launches = phase_bh_direct()
    bh_times = phase_bh_timing(dev, arrays_1m, bh_cfg)
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "nbodyax")]
    check(not loaded, f"the port loaded JAX or nbodyax: {loaded[:5]}")

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "pair_kernel", "route": "cuda",
        "source": "nbodyax_torch/csrc/pair_kernel.cu",
        "replaces": "nbodyax/physics/kernels.py:92",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": ms, "plain_ms": plain_ms}, {
        "name": "pair_bwd_kernel", "route": "cuda",
        "source": "nbodyax_torch/csrc/pair_bwd_kernel.cu",
        "replaces": "nbodyax/physics/kernels_bwd.py:79",
        "launches": bwd_launches, "max_abs_err": bwd_max_abs_err,
        "ms": bwd_ms, "plain_ms": bwd_plain_ms}, {
        "name": "near_kernel", "route": "cuda",
        "source": "nbodyax_torch/csrc/near_kernel.cu",
        "replaces": "nbodyax/physics/near_pallas.py:96",
        "launches": b3_launches, "max_abs_err": b3_max_abs_err,
        "ms": bh_times["B3"][0], "plain_ms": bh_times["B3"][1]}, {
        "name": "slot_pack_kernel", "route": "cuda",
        "source": "nbodyax_torch/csrc/slotpack_kernel.cu",
        "replaces": "nbodyax/physics/slotpack_pallas.py:99",
        "launches": b4_launches, "max_abs_err": b4_max_abs_err,
        "ms": bh_times["B4"][0], "plain_ms": bh_times["B4"][1]}, {
        "name": "slot_pack_moments_kernel", "route": "cuda",
        "source": "nbodyax_torch/csrc/slotpack_kernel.cu",
        "replaces": "nbodyax/physics/slotpack_pallas.py:123",
        "launches": b5_launches, "max_abs_err": b5_max_abs_err,
        "ms": bh_times["B5"][0], "plain_ms": bh_times["B5"][1]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
