"""A/B timing of the all-pairs kernels of two checkouts on one CUDA card.

    python -m nbodyax_torch.bench_pair OLD_ROOT [NEW_ROOT]

Each root is a checkout of the repository (NEW_ROOT defaults to this one).
The script runs one child process per turn, in the order old, new, new,
old, so that drift of the card and of its shared host falls on both sides.
A child imports ``nbodyax_torch`` from its root (building that root's
kernels) and times, with CUDA events, at the default scene (N = 16,384,
seed 1024, body 7 dead, reference mode, eps 0):

- the forward kernel B1 (``tile_accumulators_raw``), one call, and one
  call at N = 1,048,576 (uniform over 1e6, one split);
- the backward kernel B2 (``raw_backward``), one call, both sides;
- one gradient step of a 4-step euler rollout with remat (softening 100,
  the terminal loss of bench/grad_step.py) and one forward step;
- where the checkout has them, B1 and B2 in 3-D on the default config's
  3-D scene (``dimensions=3``, body 7 dead).

Each turn also hashes what the kernels return, in all four modes
(``digests``, one a case and mode), so the summary says whether the two
checkouts' kernels give the same results bit for bit, and which cases
differ: B1 and B2 in 2-D at N = 16,384 and on its first 300 rows; B1 alone
on numpy-made states in 2-D and 3-D at N = 16,384 (split) and 1,048,576
(one split), on a ring tile with ids past 2^30 on both sides, and on a
merged state whose giants sit on the dead slots they absorbed. Where the
checkout has B1's cold-path counter, ``b1_cold`` gives each B1 case's
warp sub-tiles that took the cold path and those walked.

It prints the card's name and power limit, one JSON line a turn and a
summary line with the mean of each side. Needs a CUDA card.
"""

from __future__ import annotations

import hashlib
import inspect
import json
import os
import subprocess
import sys

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _time_ms(fn, reps):
    import torch
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


MODES = ("reference", "momentum", "elastic", "none")


def _hash(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        if t is not None:
            h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def _digests(feats, g, forward, backward) -> dict:
    """sha256 of B1's raw channels and parents and B2's gradients in 2-D,
    each mode, eps 0, at every size of ``feats`` and its first 300 rows."""
    out = {}
    for mode in MODES:
        kw = dict(mode=mode, eps=0.0, growth_rate=0.1)
        outs = []
        for f, gf in ((feats, g), (feats[:300], g[:300])):
            raw, par = forward(f, f, 0, 0, **kw)
            outs += [raw, par, *backward(f, f, 0, 0, par, gf, **kw)]
        out[f"b1b2_2d/{mode}"] = _hash(outs)
    return out


def _uniform(n, dim, field, seed):
    """The reference scene's ranges (masses 1e4-1e17, radii 50-200) drawn
    by numpy over [-field, field]^dim, body 7 dead."""
    import numpy as np
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-field, field, (n, dim)).astype(np.float32)
    vel = rng.uniform(-3, 3, (n, dim)).astype(np.float32)
    mass = rng.uniform(1e4, 1e17, n).astype(np.float32)
    radius = rng.uniform(50, 200, n).astype(np.float32)
    mass[7] = 0.0
    return [pos, vel, mass, radius]


def _merged(n, dim, field, seed, giants=32, reach=4000.0):
    """A state that merged: ``giants`` bodies of radius ``reach``, each on
    the slots it absorbed, left dead where they were (two dead slots of
    each giant on one spot)."""
    import numpy as np
    pos, vel, mass, radius = _uniform(n, dim, field, seed)
    for gi in range(0, giants * (n // giants), n // giants):
        near = np.flatnonzero(((pos - pos[gi]) ** 2).sum(1) <= reach ** 2)
        near = near[(near != gi) & (mass[near] > 0)]
        if near.size >= 2:
            pos[near[1]] = pos[near[0]]
        mass[gi] += mass[near].sum()
        mass[near] = 0.0
        radius[gi] = reach
    return [pos, vel, mass, radius]


def _b1_cases(dev, body_features) -> dict:
    """The B1 inputs of the bitwise record: name -> (fi, fj, i0, j0, dim)."""
    import torch

    def feats(arrays):
        return body_features(*(torch.from_numpy(x).to(dev) for x in arrays))
    base = (1 << 30) + 3
    f16 = feats(_uniform(16384, 2, 1e5, 16))
    cases = {"2d_16k": (f16, f16, 0, 0, 2),
             "ring_tile_2d": (f16[4096:12288], f16[8192:], base + 4096,
                              base + 8192, 2),
             "giants_2d": (*[feats(_merged(16384, 2, 1e5, 18))] * 2, 0, 0,
                           2),
             "giants_3d": (*[feats(_merged(16384, 3, 2e4, 19))] * 2, 0, 0,
                           3)}
    for dim in (2, 3):
        f = feats(_uniform(16384, dim, 3e4, 20 + dim))
        cases[f"{dim}d_16k_dense"] = (f, f, 0, 0, dim)
        f = feats(_uniform(1 << 20, dim, 1e6, 30 + dim))
        cases[f"{dim}d_1m"] = (f, f, 0, 0, dim)
    return cases


def _b1_digests(dev, forward, body_features, cold) -> tuple[dict, dict]:
    """Digests of B1's raw channels and parents on ``_b1_cases``, each
    mode, eps 0; and, where ``cold`` (the module's ``(cold_counts,
    reset_cold_counts)``) is given, each call's cold-path counts."""
    digests, counts = {}, {}
    for case, (fi, fj, i0, j0, dim) in _b1_cases(dev, body_features).items():
        for mode in MODES:
            if cold:
                cold[1](dev)
            raw, par = forward(fi, fj, i0, j0, mode=mode, eps=0.0,
                               growth_rate=0.1, dim=dim)
            key = f"{case}/{mode}"
            digests[key] = _hash([raw, par])
            if cold:
                counts[key] = list(cold[0](dev))
    return digests, counts


def _one(root: str) -> dict:
    """Times of one checkout's kernels; imports nbodyax_torch from root."""
    # run as a file, this module's own directory leads sys.path and its
    # modules (config, state, ...) would shadow top-level names
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [os.path.abspath(root)] + [
        p for p in sys.path if os.path.abspath(p or os.curdir) != here]
    import numpy as np
    import torch
    from nbodyax_torch.autodiff import make_loss
    from nbodyax_torch.backends import build_accum_fn
    from nbodyax_torch.config import SimConfig
    from nbodyax_torch.physics import kernels
    from nbodyax_torch.physics.kernels import (body_features,
                                               tile_accumulators_raw)
    from nbodyax_torch.physics.kernels_bwd import raw_backward
    from nbodyax_torch.physics.step import PhysicsParams, make_step
    from nbodyax_torch.rng import scene_arrays
    from nbodyax_torch.scenes import init_scene

    import nbodyax_torch
    got = os.path.dirname(os.path.dirname(os.path.abspath(
        nbodyax_torch.__file__)))
    if got != os.path.abspath(root):
        raise RuntimeError(f"imported nbodyax_torch from {got}, not {root}")
    dev = torch.device("cuda", 0)
    cfg = SimConfig()
    arrays = list(scene_arrays(cfg.seed, cfg.particle_count, cfg.field_width,
                               cfg.field_height, cfg.min_body_mass,
                               cfg.max_body_mass, cfg.min_radius,
                               cfg.max_radius))
    arrays[2] = arrays[2].copy()
    arrays[2][7] = 0.0
    feats = body_features(*(torch.from_numpy(x).to(dev) for x in arrays))
    n = feats.shape[0]
    g = torch.from_numpy(np.random.RandomState(n).standard_normal((n, 8))
                         .astype(np.float32)).to(dev)
    kw = dict(mode="reference", eps=0.0, growth_rate=0.1)
    cold = (getattr(kernels, "cold_counts", None)
            and (kernels.cold_counts, kernels.reset_cold_counts))
    digests = _digests(feats, g, tile_accumulators_raw, raw_backward)
    b1, counts = _b1_digests(dev, tile_accumulators_raw, body_features, cold)
    digests.update(b1)
    whole = json.dumps(digests, sort_keys=True).encode()
    out = {"root": root, "n": n,
           "digest": hashlib.sha256(whole).hexdigest()[:16],
           "digests": digests}
    if counts:
        out["b1_cold"] = counts
    out["b1_ms"] = _time_ms(
        lambda: tile_accumulators_raw(feats, feats, 0, 0, **kw), 50)
    f1m = body_features(*(torch.from_numpy(x).to(dev)
                          for x in _uniform(1 << 20, 2, 1e6, 32)))
    out["b1_1m_ms"] = _time_ms(
        lambda: tile_accumulators_raw(f1m, f1m, 0, 0, **kw), 3)
    del f1m
    out["b2_ms"] = _time_ms(
        lambda: raw_backward(feats, feats, 0, 0, None, g, **kw), 20)

    gcfg = SimConfig(collision_mode="reference", softening=100.0,
                     integrator="euler", save_images=False)
    p = PhysicsParams.from_config(gcfg)
    step = make_step(p, accum_fn=build_accum_fn("pallas", p, dev))
    state = init_scene(gcfg, device=dev)

    def loss_fn(s):
        w = (s.mass > 0).to(torch.float32)
        return (w * (s.pos * s.pos).sum(-1)).sum() / w.sum()

    def grad():
        pos = state.pos.detach().clone().requires_grad_(True)
        mass = state.mass.detach().clone().requires_grad_(True)
        loss = make_loss(step, 4, loss_fn)(state._replace(pos=pos, mass=mass))
        return torch.autograd.grad(loss, (pos, mass))

    out["forward_step_ms"] = _time_ms(lambda: step(state), 20)
    out["grad_step_ms"] = _time_ms(grad, 5) / 4

    if "dim" in inspect.signature(tile_accumulators_raw).parameters:
        st3 = init_scene(SimConfig(dimensions=3), device=dev)
        mass3 = st3.mass.clone()
        mass3[7] = 0.0
        f3 = body_features(st3.pos, st3.vel, mass3, st3.radius)
        out["b1_3d_ms"] = _time_ms(
            lambda: tile_accumulators_raw(f3, f3, 0, 0, dim=3, **kw), 50)
        out["b2_3d_ms"] = _time_ms(
            lambda: raw_backward(f3, f3, 0, 0, None, g, dim=3, **kw), 20)
    return out


def run_turns(argv, script, one, doc, keys) -> int:
    """The A/B turn loop shared with bench_near: ``--one ROOT`` prints
    ``one(ROOT)`` as JSON; otherwise run ``script --one`` in a child for
    each turn, old, new, new, old, and print each turn and the mean of
    ``keys`` on each side."""
    if argv[:1] == ["--one"]:
        print(json.dumps(one(argv[1])))
        return 0
    if not argv or len(argv) > 2:
        print(doc, file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print(f"{os.path.basename(script)}: needs a CUDA card",
              file=sys.stderr)
        return 1
    roots = {"old": os.path.abspath(argv[0]),
             "new": os.path.abspath(argv[1] if len(argv) > 1 else _HERE)}
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    runs = {"old": [], "new": []}
    for side in ("old", "new", "new", "old"):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(script), "--one", roots[side]],
            capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        runs[side].append(rec)
        print(side, json.dumps(rec))
    print(json.dumps({side: {k: sum(r[k] for r in rs if k in r)
                             / sum(k in r for r in rs)
                             for k in keys if any(k in r for r in rs)}
                      for side, rs in runs.items()}))
    digests = {r.get("digest") for rs in runs.values() for r in rs}
    if digests != {None}:
        cases = {}
        for rs in runs.values():
            for r in rs:
                for case, d in r.get("digests", {}).items():
                    cases.setdefault(case, set()).add(d)
        print(json.dumps({"outputs_bitwise_equal": len(digests) == 1,
                          "cases_differing": sorted(
                              c for c, ds in cases.items() if len(ds) > 1)}))
    return 0


def main(argv=None) -> int:
    return run_turns(sys.argv[1:] if argv is None else argv, __file__, _one,
                     __doc__, ("b1_ms", "b1_1m_ms", "b2_ms",
                               "forward_step_ms", "grad_step_ms", "b1_3d_ms",
                               "b2_3d_ms"))


if __name__ == "__main__":
    sys.exit(main())
