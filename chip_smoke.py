#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``nbodyax_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. print the card's name and power limit; build both CUDA kernels from
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
    step against one forward step, at N = 16,384.

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
    print(f"kernel build + load: {time.perf_counter() - t0:.3f} s "
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
        "ms": bwd_ms, "plain_ms": bwd_plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
