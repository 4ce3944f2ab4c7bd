#!/usr/bin/env python3
"""On-card smoke test of the PyTorch + CUDA port (``nbodyax_torch``).

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:

1. print the card's name and power limit; build the CUDA kernel from
   ``nbodyax_torch/csrc`` and print the build time;
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
5. time the kernel against its plain version at N = 16,384.

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


def phase_main_path():
    from nbodyax_torch import cli
    from nbodyax_torch.physics.kernels import tile_accumulators_raw

    with tempfile.TemporaryDirectory() as tmp:
        frames_dir = os.path.join(tmp, "frames")
        cwd = os.getcwd()
        buf = io.StringIO()
        # no nbodyConfig.txt in the temp dir: the built-in default config
        os.chdir(tmp)
        try:
            tile_accumulators_raw.launches = 0
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["--steps", str(STEPS), "--set",
                               f"imagePath={frames_dir}"])
            launches = tile_accumulators_raw.launches
        finally:
            os.chdir(cwd)
        out = buf.getvalue()
        check(rc == 0, f"cli exited {rc}")
        check(launches == STEPS,
              f"kernel launched {launches} times in {STEPS} steps")
        taken = [l for l in out.splitlines() if l.startswith("Time taken: ")]
        check(len(taken) == 1, "no 'Time taken:' line")
        logs = [json.loads(l) for l in out.splitlines() if l.startswith("{")]
        check(len(logs) == STEPS // 10 and logs[-1]["step"] == STEPS,
              f"expected {STEPS // 10} log lines, got {len(logs)}")
        last = logs[-1]
        check(all(np.isfinite(v) for v in last.values()
                  if isinstance(v, float)), f"non-finite log values: {last}")
        check(0 < last["alive"] <= 16384, f"alive count {last['alive']}")
        want = [f"iteration_{j}.ppm" for j in range(0, STEPS, FRAME_EVERY)]
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
    print(f"main path: {STEPS} steps, {len(want)} P5 frames, {launches} "
          f"kernel launches, {taken[0]}, {last['alive']} alive")
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
          f"({_build.SOURCE.name})")

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
    loaded = [m for m in sys.modules
              if m.split(".")[0] in ("jax", "jaxlib", "nbodyax")]
    check(not loaded, f"the port loaded JAX or nbodyax: {loaded[:5]}")

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "pair_kernel", "route": "cuda",
        "source": "nbodyax_torch/csrc/pair_kernel.cu",
        "replaces": "nbodyax/physics/kernels.py:92",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
