"""One simulation step in plain torch, for chosen rows: the benchmark's
reference for ``collisionMode=reference``, reflective walls, euler, 3-D.
A configuration names it by its ``reference`` key; ``step`` is the entry
every reference module has.

It is ``reference_euler_2d``'s step with a third axis: all-pairs gravity
``G m_j (p_j - p_i) / (d^2 + eps^2)^{3/2}`` over live partners that do
not overlap, with ``d^2 = dx*dx + dy*dy + dz*dz``; reference collisions
(on overlap, ``m_i >= m_j`` gains ``m_j`` and ``r_j * radiusGrowthRate``,
``m_i < m_j`` dies); reflective walls that flip a velocity component
where ``pos + accel * dt`` leaves ``[-(field - r), field - r]`` with the
step-start radius, on x (``fieldWidth``), y (``fieldHeight``) and z
(``fieldDepth``, or ``fieldWidth`` where that is 0: the program's z
interval, ``nbodyax_torch/physics/step.py``'s ``PhysicsParams``);
semi-implicit Euler; dead bodies frozen at rest. On a planar state (z = 0
everywhere) its rows are ``reference_euler_2d``'s, with z = 0.

Precision. ``reference`` sums the force, the gained mass and the gained
radius of each row over all partners in float64 and rounds each once to
float32, the state's type; the overlap test is the float32 test the
physics states (``d^2`` summed left to right from the subtract-first
``p_j - p_i``, each product rounded), and the walls, kick and drift run in
float32 from the rounded force, as a float32 program does. ``control``
does everything in bfloat16, the precision below the configuration's.
Both TF32 switches are off: nothing here multiplies matrices, and nothing
may.

Where it departs from the program's physics, by design:

- the force is every partner's, summed exactly; ``forceModel=bh`` sums
  the near field pair by pair in float32 (B3) and the far field by an FMM
  of the cells' moments, so the program's velocities differ by the FMM's
  error (the cell's ``dv`` limit) and its own float32 rounding;
- every pair is tested for overlap; the bh program tests the pairs inside
  its near window and those of the giant pass, which its probes keep
  wide enough (``bh_overflow`` 0), so the decisions agree;
- a fixed dt, euler and reference collisions only: other physics raises.

The rows' partners are every body, so a row's answer is exact whatever
the others' are; the cost is rows x N pairs, taken in chunks of rows.
It imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["Physics", "step", "step_rows", "PRECISIONS"]

GRAV_CONSTANT = float(np.float32(6.67408e-11))

# name -> (dtype of the sums, dtype of the state, decisions and tail)
PRECISIONS = {"reference": (torch.float64, torch.float32),
              "control": (torch.bfloat16, torch.bfloat16)}


@dataclass(frozen=True)
class Physics:
    dt: float
    field: tuple           # half-widths of x, y and z
    growth: float
    eps: float

    @classmethod
    def from_params(cls, p: dict) -> "Physics":
        """From ``nbodyConfig.txt`` keys; raises on physics this
        reference does not follow."""
        want = {"collisionMode": "reference", "boundaryMode": "reference",
                "integrator": "euler", "dimensions": 3}
        for k, v in want.items():
            if str(p.get(k, v)) != str(v):
                raise ValueError(f"the reference follows {k}={v}, not "
                                 f"{p[k]}")
        if str(p.get("adaptiveDt", "false")).lower() not in ("0", "false"):
            raise ValueError("the reference steps at a fixed dt")
        f32 = lambda x: float(np.float32(float(str(x).rstrip("f"))))
        width = float(p["fieldWidth"])
        return cls(dt=f32(p.get("timestep", 0.2)),
                   field=(width, float(p["fieldHeight"]),
                          float(p.get("fieldDepth", 0)) or width),
                   growth=f32(p.get("radiusGrowthRate", 0.1)),
                   eps=float(np.float32(float(p.get("softening", 0.0)))))


def step(pos, vel, mass, radius, rows, params: dict, *,
         precision: str = "reference"):
    """``step_rows`` of the physics that ``params`` (``nbodyConfig.txt``
    keys) states; raises on physics this reference does not follow."""
    return step_rows(pos, vel, mass, radius, rows,
                     Physics.from_params(params), precision=precision)


def step_rows(pos, vel, mass, radius, rows, phys: Physics, *,
              precision: str = "reference", chunk_elems: int = 1 << 25):
    """``(pos, vel, mass, radius)`` of bodies ``rows`` (int64) after one
    step of the whole state ``pos f32[N, 3], vel, mass, radius``, as
    float32 tensors on the state's device."""
    if pos.shape[-1] != 3:
        raise ValueError(f"the reference is 3-D, the state has "
                         f"{pos.shape[-1]} axes")
    sdt, xdt = PRECISIONS[precision]
    dev = pos.device
    n = pos.shape[0]
    P, V, M, R = (t.to(xdt) for t in (pos, vel, mass, radius))
    Ps, Ms = pos.to(sdt), mass.to(sdt)
    Rg = (R * phys.growth).to(sdt)     # each term rounded as the state's
    eps2 = float(np.float64(phys.eps) ** 2)
    ids = torch.arange(n, device=dev)
    alive = M > 0
    rows = rows.to(dev)
    chunk = max(1, chunk_elems // max(n, 1))
    out = []
    switches = (torch.backends.cuda.matmul, torch.backends.cudnn)
    before = [sw.allow_tf32 for sw in switches]
    with torch.no_grad():
        for sw in switches:
            sw.allow_tf32 = False
        try:
            for s in range(0, rows.shape[0], chunk):
                out.append(_chunk(rows[s:s + chunk], P, V, M, R, Ps, Ms, Rg,
                                  ids, alive, eps2, phys, sdt, xdt))
        finally:
            for sw, b in zip(switches, before):
                sw.allow_tf32 = b
    return tuple(torch.cat(x) for x in zip(*out))


def _squared(d):
    """dx*dx + dy*dy + dz*dz, each product rounded, left to right."""
    return d[0] * d[0] + d[1] * d[1] + d[2] * d[2]


def _chunk(ri, P, V, M, R, Ps, Ms, Rg, ids, alive, eps2, phys, sdt, xdt):
    pi, vi, mi, rad_i = P[ri], V[ri], M[ri], R[ri]
    # the overlap test in the state's type, subtract first
    d2 = _squared([P[None, :, k] - pi[:, None, k] for k in range(3)])
    rsum = rad_i[:, None] + R[None, :]
    valid = alive[ri][:, None] & alive[None, :] & (ri[:, None] != ids[None])
    overlap = (d2 <= rsum * rsum) & valid
    del d2, rsum
    # the force, in the sums' type
    psi = Ps[ri]
    ds = [Ps[None, :, k] - psi[:, None, k] for k in range(3)]
    d2s = _squared(ds) + eps2
    fmask = valid & ~overlap & (d2s > 0)
    inv = torch.rsqrt(torch.where(fmask, d2s, torch.ones_like(d2s)))
    w = torch.where(fmask, Ms[None, :] * (inv * inv * inv),
                    torch.zeros_like(inv))
    force = [(w * d).sum(1) for d in ds]
    del ds, d2s, inv, w
    heavier = mi[:, None] >= M[None, :]
    merge = overlap & heavier
    zero = torch.zeros((), dtype=sdt, device=P.device)
    gained_m = torch.where(merge, Ms[None, :], zero).sum(1)
    gained_r = torch.where(merge, Rg[None, :], zero).sum(1)
    died = (overlap & ~heavier).any(1)
    # the commit and the tail, in the state's type
    alive_i = mi > 0
    new_m = (mi.to(sdt) + gained_m).to(xdt)
    new_m = torch.where(died | ~alive_i, torch.zeros_like(new_m), new_m)
    new_r = (rad_i.to(sdt) + gained_r).to(xdt)
    accel = torch.stack(force, -1).to(xdt) * GRAV_CONSTANT
    limit = torch.stack([f - rad_i for f in phys.field], -1)
    pred = pi + accel * phys.dt
    flip = (pred > limit) | (pred < -limit)
    v2 = torch.where(flip, -vi, vi)
    new_v = v2 + accel * phys.dt
    new_p = pi + new_v * phys.dt
    live = (new_m > 0)[:, None]
    new_p = torch.where(live, new_p, pi)
    new_v = torch.where(live, new_v, torch.zeros_like(new_v))
    f32 = torch.float32
    return new_p.to(f32), new_v.to(f32), new_m.to(f32), new_r.to(f32)
