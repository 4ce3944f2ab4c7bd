"""One simulation step in plain torch, for chosen rows: the benchmark's
reference for ``collisionMode=reference``, reflective walls, euler, 2-D.
A configuration names it by its ``reference`` key; ``step`` is the entry
every reference module has.

It follows the reference program's step (``nbodyConfig.txt`` physics,
``forceModel`` aside): all-pairs gravity ``G m_j (p_j - p_i) / (d^2 +
eps^2)^{3/2}`` over live partners that do not overlap; reference
collisions (on overlap, ``m_i >= m_j`` gains ``m_j`` and ``r_j *
radiusGrowthRate``, ``m_i < m_j`` dies); reflective walls that flip a
velocity component where ``pos + accel * dt`` leaves ``[-(field - r),
field - r]`` with the step-start radius; semi-implicit Euler; dead bodies
frozen at rest.

Precision. ``reference`` sums the force, the gained mass and the gained
radius of each row over all partners in float64 and rounds each once to
float32, the state's type; the overlap test is the float32 test the
physics states (``d^2`` summed from the subtract-first ``p_j - p_i``), and
the walls, kick and drift run in float32 from the rounded force, as a
float32 program does. ``control`` does everything in bfloat16, the
precision below the configuration's. TF32 is switched off: nothing here
multiplies matrices, and nothing may.

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
    field_width: float
    field_height: float
    growth: float
    eps: float

    @classmethod
    def from_params(cls, p: dict) -> "Physics":
        """From ``nbodyConfig.txt`` keys; raises on physics this
        reference does not follow."""
        want = {"collisionMode": "reference", "boundaryMode": "reference",
                "integrator": "euler", "dimensions": 2}
        for k, v in want.items():
            if str(p.get(k, v)) != str(v):
                raise ValueError(f"the reference follows {k}={v}, not "
                                 f"{p[k]}")
        if str(p.get("adaptiveDt", "false")).lower() not in ("0", "false"):
            raise ValueError("the reference steps at a fixed dt")
        f32 = lambda x: float(np.float32(float(str(x).rstrip("f"))))
        return cls(dt=f32(p.get("timestep", 0.2)),
                   field_width=float(p["fieldWidth"]),
                   field_height=float(p["fieldHeight"]),
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
    step of the whole state ``pos f32[N, 2], vel, mass, radius``, as
    float32 tensors on the state's device."""
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
    with torch.no_grad():
        before = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for s in range(0, rows.shape[0], chunk):
                out.append(_chunk(rows[s:s + chunk], P, V, M, R, Ps, Ms, Rg,
                                  ids, alive, eps2, phys, sdt, xdt))
        finally:
            torch.backends.cuda.matmul.allow_tf32 = before
    return tuple(torch.cat(x) for x in zip(*out))


def _chunk(ri, P, V, M, R, Ps, Ms, Rg, ids, alive, eps2, phys, sdt, xdt):
    pi, vi, mi, rad_i = P[ri], V[ri], M[ri], R[ri]
    # the overlap test in the state's type, subtract first
    dx = P[None, :, 0] - pi[:, None, 0]
    dy = P[None, :, 1] - pi[:, None, 1]
    d2 = dx * dx + dy * dy
    rsum = rad_i[:, None] + R[None, :]
    valid = alive[ri][:, None] & alive[None, :] & (ri[:, None] != ids[None])
    overlap = (d2 <= rsum * rsum) & valid
    del dx, dy, d2, rsum
    # the force, in the sums' type
    psi = Ps[ri]
    dxs = Ps[None, :, 0] - psi[:, None, 0]
    dys = Ps[None, :, 1] - psi[:, None, 1]
    d2s = dxs * dxs + dys * dys + eps2
    fmask = valid & ~overlap & (d2s > 0)
    inv = torch.rsqrt(torch.where(fmask, d2s, torch.ones_like(d2s)))
    w = torch.where(fmask, Ms[None, :] * (inv * inv * inv),
                    torch.zeros_like(inv))
    fx, fy = (w * dxs).sum(1), (w * dys).sum(1)
    del dxs, dys, d2s, inv, w
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
    force = torch.stack([fx, fy], -1).to(xdt)
    accel = force * GRAV_CONSTANT
    limit = torch.stack([phys.field_width - rad_i,
                         phys.field_height - rad_i], -1)
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
