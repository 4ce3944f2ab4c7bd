"""Scene constructors.

Counterpart of ``nbodyax/scenes.py``, in 2-D and 3-D:

- ``uniform``: the reference's random scene. In 2-D with ``parity=True``
  it is the reference's own draw, bit for bit, through the RNG port.
- ``three_body``: the reference author's fixed debugging fixture, bit for
  bit ``nbodyax``'s.
- ``galaxy``: two rotating disks on a collision course.
- ``plummer``: a Plummer-sphere cluster (a "Plummer disk" in 2-D).

``nbodyax`` draws every other scene from ``jax.random``, whose bits torch
cannot reproduce. The port draws them from a ``torch.Generator`` on the
CPU seeded with ``cfg.seed``, in float32, with ``nbodyax``'s distributions
and formulas, and moves the result to the device: the same seed gives the
same scene on every device, but not ``nbodyax``'s bits. To run both
packages on one such scene, carry ``nbodyax``'s state across with
``state.from_numpy``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nbodyax_torch.config import SimConfig
from nbodyax_torch.rng import scene_arrays
from nbodyax_torch.state import SimState, make_state

__all__ = ["init_scene", "uniform_scene", "three_body_scene",
           "galaxy_scene", "plummer_scene", "G"]

G = 6.67408e-11  # the reference's GRAV_CONSTANT


class _Draw:
    """float32 draws from a CPU ``torch.Generator`` seeded with the
    config's seed."""

    def __init__(self, seed: int):
        self.gen = torch.Generator(device="cpu").manual_seed(int(seed))

    def uniform(self, shape, lo=0.0, hi=1.0) -> torch.Tensor:
        """float32 uniform over [lo, hi) per element (lo, hi broadcast)."""
        lo, hi = (torch.as_tensor(x, dtype=torch.float32) for x in (lo, hi))
        return torch.rand(shape, generator=self.gen) * (hi - lo) + lo


def _field_extents(cfg: SimConfig) -> list:
    ext = [float(cfg.field_width), float(cfg.field_height)]
    if cfg.dimensions == 3:
        ext.append(float(cfg.field_depth or cfg.field_width))
    return ext


def _packed_radius_scale(cfg: SimConfig, n: int, radius: float) -> float:
    """The factor on the radius range that caps the bodies' total area at
    1% of a disk of ``radius``, so a dense scene does not agglomerate in
    its first steps."""
    mean_r2 = (cfg.min_radius ** 2 + cfg.min_radius * cfg.max_radius
               + cfg.max_radius ** 2) / 3.0
    packing = n * np.pi * mean_r2 / (np.pi * radius ** 2)
    return float(min(1.0, np.sqrt(0.01 / max(packing, 1e-30))))


def uniform_scene(cfg: SimConfig, *, device: torch.device | str,
                  parity: bool = True) -> SimState:
    """The reference's random scene: positions uniform over the field,
    bodies at rest, mass and radius uniform over their ranges.

    2-D with ``parity=True`` is the reference's own draw, bit for bit (the
    reference is 2-D). Otherwise the draw is ``nbodyax``'s ``jax.random``
    one in distribution: positions uniform over [-ext, ext] on each axis,
    ext = (fieldWidth, fieldHeight, fieldDepth or fieldWidth), from the
    config's ``torch.Generator``.
    """
    if parity and cfg.dimensions == 2:
        pos, vel, mass, radius = scene_arrays(
            cfg.seed, cfg.particle_count, cfg.field_width, cfg.field_height,
            cfg.min_body_mass, cfg.max_body_mass, cfg.min_radius,
            cfg.max_radius)
        return make_state(pos, vel, mass, radius, device=device)
    n, d = cfg.particle_count, cfg.dimensions
    draw = _Draw(cfg.seed)
    ext = torch.tensor(_field_extents(cfg))
    pos = draw.uniform((n, d), -ext, ext)
    mass = draw.uniform((n,), cfg.min_body_mass, cfg.max_body_mass)
    radius = draw.uniform((n,), cfg.min_radius, cfg.max_radius)
    return make_state(pos, torch.zeros((n, d)), mass, radius, device=device)


def three_body_scene(cfg: SimConfig, *, device: torch.device | str
                     ) -> SimState:
    """The reference author's 3-body debugging fixture. Planar; in a
    ``dimensions=3`` run it gets z = 0 (and stays planar exactly)."""
    pos = np.array([[-500.0, 0.0], [500.0, 0.0], [-600.0, -150.0]],
                   np.float32)
    vel = np.array([[10.0, 0.0], [-10.0, 0.0], [0.0, 0.0]], np.float32)
    mass = np.array([1e10, 1e14, 1e3], np.float32)
    radius = np.array([10.0, 20.0, 7.0], np.float32)
    if cfg.dimensions == 3:
        z = np.zeros((3, 1), np.float32)
        pos = np.concatenate([pos, z], axis=1)
        vel = np.concatenate([vel, z], axis=1)
    return make_state(pos, vel, mass, radius, device=device)


def galaxy_scene(cfg: SimConfig, *, device: torch.device | str) -> SimState:
    """Two rotating disk galaxies on a collision course along x.

    Each disk is a heavy central body (mass maxRandBodyMass, radius
    maxRadius) plus light bodies at radii ``disk_r * sqrt(U(0.01, 1))``
    (area-uniform with a small hole) on circular orbits, speed
    ``sqrt(G * M_c / r)`` tangential, masses uniform over [minRandBodyMass,
    maxRandBodyMass / 100), radii scaled to a 1% area packing. The disks
    start ``fieldWidth / 2`` apart and approach each other at a quarter of
    the circular speed at that separation. In 3-D each disk is thin: z
    uniform over +-2% of the disk radius, vz = 0.
    """
    n = cfg.particle_count
    if n < 4:
        raise ValueError("galaxy scene needs particleCount >= 4 "
                         "(two disks, each a central body plus orbiters)")
    d = cfg.dimensions
    n1 = n // 2
    fw, fh = float(cfg.field_width), float(cfg.field_height)
    sep = 0.5 * fw
    disk_r = 0.25 * min(fw, fh)
    m_central = float(cfg.max_body_mass)
    approach_v = 0.25 * float(np.sqrt(G * m_central / sep))
    r_scale = _packed_radius_scale(cfg, n, disk_r)
    draw = _Draw(cfg.seed)
    f32 = torch.float32

    def disk(count, center, drift):
        m = count - 1
        r = disk_r * torch.sqrt(draw.uniform((m,), 0.01, 1.0))
        th = draw.uniform((m,), 0.0, 2 * math.pi)
        vc = torch.sqrt(G * m_central / r)
        pcols = [r * torch.cos(th), r * torch.sin(th)]
        vcols = [-vc * torch.sin(th), vc * torch.cos(th)]
        if d == 3:
            pcols.append(draw.uniform((m,), -0.02 * disk_r, 0.02 * disk_r))
            vcols.append(torch.zeros(m, dtype=f32))
        p = torch.stack(pcols, -1) + center
        v = torch.stack(vcols, -1) + drift
        mass = draw.uniform((m,), cfg.min_body_mass,
                            0.01 * cfg.max_body_mass)
        rad = draw.uniform((m,), cfg.min_radius * r_scale,
                           cfg.max_radius * r_scale)
        return (torch.cat([center[None], p]), torch.cat([drift[None], v]),
                torch.cat([torch.tensor([m_central], dtype=f32), mass]),
                torch.cat([torch.tensor([cfg.max_radius], dtype=f32), rad]))

    zpad = [0.0] * (d - 2)
    parts = [disk(n1, torch.tensor([-sep / 2, 0.0] + zpad, dtype=f32),
                  torch.tensor([approach_v, 0.0] + zpad, dtype=f32)),
             disk(n - n1, torch.tensor([sep / 2, 0.0] + zpad, dtype=f32),
                  torch.tensor([-approach_v, 0.0] + zpad, dtype=f32))]
    return make_state(*(torch.cat(x) for x in zip(*parts)), device=device)


def plummer_scene(cfg: SimConfig, *, device: torch.device | str
                  ) -> SimState:
    """A Plummer (1911) sphere, density (3M / 4 pi a^3) (1 + r^2/a^2)^-5/2,
    with ``nbodyax``'s sampling:

    - radii invert the cumulative mass exactly, r = a / sqrt(u^(-2/3) - 1)
      with u uniform over [1e-6, u_max), u_max truncating the tail at
      r_max = 5a;
    - speeds are q * v_esc(r), v_esc = sqrt(2 G M) (r^2 + a^2)^(-1/4), q
      drawn from Aarseth's g(q) ~ q^2 (1 - q^2)^(7/2) by inverse CDF on a
      2,049-point grid, linearly interpolated;
    - directions of position and velocity are isotropic (on the circle in
      2-D, a "Plummer disk"; on the sphere in 3-D).

    a = min(field) / 12; masses uniform over [minRandBodyMass,
    maxRandBodyMass), M = n (min + max) / 2; radii scaled to a 1% area
    packing of the half-mass disk.
    """
    n, dim = cfg.particle_count, cfg.dimensions
    a = float(min(_field_extents(cfg))) / 12.0
    r_max = 5.0 * a
    m_total = n * 0.5 * (float(cfg.min_body_mass) + float(cfg.max_body_mass))
    draw = _Draw(cfg.seed)

    def unit_vectors(count):
        if dim == 2:
            th = draw.uniform((count,), 0.0, 2 * math.pi)
            return torch.stack([torch.cos(th), torch.sin(th)], -1)
        z = draw.uniform((count,), -1.0, 1.0)
        th = draw.uniform((count,), 0.0, 2 * math.pi)
        s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        return torch.stack([s * torch.cos(th), s * torch.sin(th), z], -1)

    u_max = r_max ** 3 / (r_max ** 2 + a ** 2) ** 1.5
    u = draw.uniform((n,), 1e-6, u_max)
    r = a / torch.sqrt(u ** (-2.0 / 3.0) - 1.0)
    pos = r[:, None] * unit_vectors(n)

    qs = np.linspace(0.0, 1.0, 2049)
    pdf = qs ** 2 * (1.0 - qs ** 2) ** 3.5
    cdf = np.concatenate([[0.0], np.cumsum((pdf[1:] + pdf[:-1]) * 0.5)])
    cdf /= cdf[-1]
    q = _interp(draw.uniform((n,)), torch.tensor(cdf, dtype=torch.float32),
                torch.tensor(qs, dtype=torch.float32))
    v_esc = float(np.sqrt(2.0 * G * m_total)) * (r * r + a * a) ** -0.25
    vel = (q * v_esc)[:, None] * unit_vectors(n)

    mass = draw.uniform((n,), cfg.min_body_mass, cfg.max_body_mass)
    half_mass_r = a / np.sqrt(2.0 ** (2.0 / 3.0) - 1.0)
    r_scale = _packed_radius_scale(cfg, n, half_mass_r)
    radius = draw.uniform((n,), cfg.min_radius * r_scale,
                          cfg.max_radius * r_scale)
    return make_state(pos, vel, mass, radius, device=device)


def _interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor
            ) -> torch.Tensor:
    """``jnp.interp(x, xp, fp)`` for non-decreasing ``xp`` and x within
    [xp[0], xp[-1]]: linear between the neighbouring grid points, the
    lower one's value where a grid step is flat."""
    i = torch.searchsorted(xp, x, right=True).clamp(1, len(xp) - 1)
    x0, x1, f0, f1 = xp[i - 1], xp[i], fp[i - 1], fp[i]
    dx = x1 - x0
    flat = dx == 0
    return torch.where(flat, f0, f0 + (x - x0) / torch.where(flat, 1.0, dx)
                       * (f1 - f0))


def init_scene(cfg: SimConfig, *, device: torch.device | str,
               parity: bool = True) -> SimState:
    if cfg.scene == "uniform":
        return uniform_scene(cfg, device=device, parity=parity)
    if cfg.scene == "three_body":
        return three_body_scene(cfg, device=device)
    if cfg.scene == "galaxy":
        return galaxy_scene(cfg, device=device)
    if cfg.scene == "plummer":
        return plummer_scene(cfg, device=device)
    raise ValueError(f"unknown scene {cfg.scene!r}")
