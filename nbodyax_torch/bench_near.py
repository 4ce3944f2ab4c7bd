"""A/B timing of the bh kernels B3, B4 and B5 of two checkouts on one card.

    python -m nbodyax_torch.bench_near OLD_ROOT [NEW_ROOT]

Each root is a checkout of the repository (NEW_ROOT defaults to this one).
One child process a turn, in the order old, new, new, old (the turn loop
of ``bench_pair``). A child imports ``nbodyax_torch`` from its root, builds
that root's kernels and times each kernel by its own device time, the mean
duration of its launches in a ``torch.profiler`` trace, on states made with
numpy from fixed seeds (no pure-Python RNG):

- ``uniform_1m``: N = 1,048,576 uniform over a 1e6 x 1e6 field (the
  density of examples/million_bodies.txt), masses 1e4-1e17, radii 50-200;
  levels 8 (65,536 cells), S = 40: B3 (ci 32, ring 1, reference, eps 0),
  B4 and B5;
- ``crowded_64k``: N = 65,536, a quarter of the bodies in one patch,
  levels 6, S = 40, ci 32: B3 (reference, eps 0);
- ``crowded_256k`` and ``uniform_256k``: N = 262,144 with and without that
  patch, levels 8, S = 40: B4 and B5, with the largest cell occupancy;
- a uniform 3-D state (keys ``*_3d_uniform_1m_ms``), where the checkout's
  kernels take ``dim``:
  N = 1,048,576 uniform over a 1e6 cube, levels 5 (32,768 cells), S = 80,
  ci 64: B3 in 3-D (reference, and elastic with rows of 10), B4 and B5 with
  rows of 7 and 10 moments.

Each turn also hashes the kernels' 2-D outputs (``digest``): B4's rows and
B5's rows and moments on every state, B3's channels in reference mode on
``uniform_1m`` and in all four modes at eps 0 and 100 and ring 1 and 2 on
``crowded_64k``; the summary's ``outputs_bitwise_equal`` says whether the
two checkouts agree bit for bit.

It prints the card's name and power limit, one JSON line a turn and the mean
of each side. Needs a CUDA card.
"""

from __future__ import annotations

import hashlib
import os
import sys

KEYS = ("b3_uniform_1m_ms", "b3_crowded_64k_ms", "b4_uniform_1m_ms",
        "b5_uniform_1m_ms", "b4_crowded_256k_ms", "b5_crowded_256k_ms",
        "b4_uniform_256k_ms", "b5_uniform_256k_ms", "b3_3d_uniform_1m_ms",
        "b3_3d_elastic_uniform_1m_ms", "b4_3d_uniform_1m_ms",
        "b5_3d_uniform_1m_ms")


def _state(n, seed, field, crowd, dim=2):
    """Bodies over +-field, a quarter of them in a patch of +-field/3000
    at the centre when ``crowd``, body 7 dead."""
    import numpy as np
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-field, field, (n, dim)).astype(np.float32)
    patch = rng.uniform(-field / 3000, field / 3000, (n // 4, dim))
    if crowd:
        pos[: n // 4] = patch
    vel = rng.uniform(-3, 3, (n, dim)).astype(np.float32)
    mass = rng.uniform(1e4, 1e17, n).astype(np.float32)
    mass[7] = 0.0
    radius = rng.uniform(50, 200, n).astype(np.float32)
    return pos, vel, mass, radius


def _device_ms(fn, tag, reps=20):
    """Mean device time a launch of the traced kernels whose name holds
    ``tag``, summed over those kernels (each launches once a call). CUPTI
    now and then hands back a trace without the kernels' records: such a
    trace is taken again, three times at most."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        per = [getattr(ev, "self_device_time_total",
                       getattr(ev, "self_cuda_time_total", 0)) / ev.count
               for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and ev.count
               and tag in ev.key]
        if per:
            return sum(per) / 1e3
    raise RuntimeError(f"the profiler traced no kernel named {tag}")


def _one(root: str) -> dict:
    """Device times of one checkout's bh kernels; imports nbodyax_torch
    from root."""
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [os.path.abspath(root)] + [
        p for p in sys.path if os.path.abspath(p or os.curdir) != here]
    import inspect
    import torch
    import nbodyax_torch
    from nbodyax_torch.physics.bh_grid import _extent, _partner_structure
    from nbodyax_torch.physics.near_kernel import slots_near
    from nbodyax_torch.physics.slotpack_kernel import pack_slots

    got = os.path.dirname(os.path.dirname(os.path.abspath(
        nbodyax_torch.__file__)))
    if got != os.path.abspath(root):
        raise RuntimeError(f"imported nbodyax_torch from {got}, not {root}")
    dev = torch.device("cuda", 0)
    out = {"root": root}
    digest = hashlib.sha256()

    def add(*tensors):
        for x in tensors:
            digest.update(x.cpu().numpy().tobytes())
    cases = (("uniform_1m", 1 << 20, 1, 5e5, False, 8),
             ("crowded_64k", 1 << 16, 12, 1e5, True, 6),
             ("crowded_256k", 1 << 18, 4, 1e6, True, 8),
             ("uniform_256k", 1 << 18, 4, 1e6, False, 8))
    for name, n, seed, field, crowd, levels in cases:
        t = [torch.from_numpy(x).to(dev)
             for x in _state(n, seed, field, crowd)]
        ext = _extent(t[0], t[2] > 0)
        _, _, starts, ends, sf = _partner_structure(*t, ext, 1 << levels,
                                                    False)
        S = 40
        out[f"max_occupancy_{name}"] = int((ends - starts).max())
        fslot = pack_slots(sf, starts, ends, S)
        add(fslot, *pack_slots(sf, starts, ends, S,
                               moments=(t[0], t[2], ext, levels)))
        near_kw = dict(eps2=0.0, growth=0.1, g=1 << levels, ring=1, ci=32)
        if name == "uniform_1m":
            add(slots_near(fslot, mode="reference", **near_kw))
        if name == "crowded_64k":
            _, _, vstarts, vends, vsf = _partner_structure(
                *t, ext, 1 << levels, True)
            vslot = pack_slots(vsf, vstarts, vends, S)
            add(vslot)
            for mode in ("reference", "momentum", "elastic", "none"):
                for ring in (1, 2):
                    for eps in (0.0, 100.0):
                        add(slots_near(
                            vslot if mode == "elastic" else fslot, mode=mode,
                            **dict(near_kw, ring=ring, eps2=eps * eps)))
        if name in ("uniform_1m", "crowded_64k"):
            out[f"b3_{name}_ms"] = _device_ms(
                lambda: slots_near(fslot, mode="reference", eps2=0.0,
                                   growth=0.1, g=1 << levels, ring=1, ci=32),
                "near_kernel")
        if name != "crowded_64k":
            out[f"b4_{name}_ms"] = _device_ms(
                lambda: pack_slots(sf, starts, ends, S), "slot_pack")
            out[f"b5_{name}_ms"] = _device_ms(
                lambda: pack_slots(sf, starts, ends, S,
                                   moments=(t[0], t[2], ext, levels)),
                "slot_pack")
    out["digest"] = digest.hexdigest()[:16]
    if "dim" not in inspect.signature(slots_near).parameters:
        return out
    levels, S, name = 5, 80, "uniform_1m"
    t = [torch.from_numpy(x).to(dev)
         for x in _state(1 << 20, 1, 5e5, False, dim=3)]
    ext = _extent(t[0], t[2] > 0)
    for tag, vel in (("", False), ("_elastic", True)):
        _, _, starts, ends, sf = _partner_structure(*t, ext, 1 << levels, vel)
        fslot = pack_slots(sf, starts, ends, S)
        out[f"b3_3d{tag}_{name}_ms"] = _device_ms(
            lambda: slots_near(fslot, mode="elastic" if vel else "reference",
                               eps2=0.0, growth=0.1, g=1 << levels, ring=1,
                               ci=64, dim=3), "near_kernel", reps=10)
        if not vel:
            out[f"b4_3d_{name}_ms"] = _device_ms(
                lambda: pack_slots(sf, starts, ends, S), "slot_pack")
            out[f"b5_3d_{name}_ms"] = _device_ms(
                lambda: pack_slots(sf, starts, ends, S,
                                   moments=(t[0], t[2], ext, levels)),
                "slot_pack")
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--one"]:
        import json
        print(json.dumps(_one(argv[1])))
        return 0
    from nbodyax_torch.bench_pair import run_turns
    return run_turns(argv, __file__, _one, __doc__, KEYS)


if __name__ == "__main__":
    sys.exit(main())
