"""Scene constructors.

Counterpart of ``nbodyax/scenes.py``, in 2-D and 3-D, each scene
``nbodyax``'s own bodies for the same config:

- ``uniform``: the reference's random scene. In 2-D with ``parity=True``
  it is the reference's own draw, bit for bit, through the RNG port.
- ``three_body``: the reference author's fixed debugging fixture, bit for
  bit ``nbodyax``'s.
- ``galaxy``: two rotating disks on a collision course.
- ``plummer``: a Plummer-sphere cluster (a "Plummer disk" in 2-D).

``nbodyax`` draws every other scene from ``jax.random``; the port draws it
from the same key tree, split for split, with the same bits
(``nbodyax_torch.prng``, threefry in plain torch), and keeps ``nbodyax``'s
formulas in their order of operations, float32 powers included (XLA's,
glibc's ``powf``, bit for bit). The draws themselves (masses, radii,
uniform positions, the galaxy's z scatter) are bitwise ``nbodyax``'s;
values through cos and sin differ by an ulp here and there (torch's and
XLA's functions), within 2e-7 of the largest value of their array. The
draws run on the scene's device and the formulas on the CPU, so a scene
is the same bits on every device.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from nbodyax_torch import prng
from nbodyax_torch.config import SimConfig
from nbodyax_torch.rng import scene_arrays
from nbodyax_torch.state import SimState, make_state

__all__ = ["init_scene", "uniform_scene", "three_body_scene",
           "galaxy_scene", "plummer_scene", "G"]

G = 6.67408e-11  # the reference's GRAV_CONSTANT


def _f32(x) -> torch.Tensor:
    """A float32 scalar tensor on the CPU: a Python number as ``nbodyax``'s
    jnp arithmetic takes it (``x / t`` in torch would multiply by the
    reciprocal)."""
    return torch.tensor(x, dtype=torch.float32)


# glibc's powf (Arm's optimized-routines, glibc 2.28 on), which XLA's CPU
# backend calls for a float32 power: log2 from a 16-entry table and a
# degree-5 polynomial, exp2 from a 32-entry table and a cubic, in float64.
_LOG2_TAB = (  # (1/c, log2 c) a subinterval
    ("0x1.661ec79f8f3bep+0", "-0x1.efec65b963019p-2"),
    ("0x1.571ed4aaf883dp+0", "-0x1.b0b6832d4fca4p-2"),
    ("0x1.49539f0f010b0p+0", "-0x1.7418b0a1fb77bp-2"),
    ("0x1.3c995b0b80385p+0", "-0x1.39de91a6dcf7bp-2"),
    ("0x1.30d190c8864a5p+0", "-0x1.01d9bf3f2b631p-2"),
    ("0x1.25e227b0b8ea0p+0", "-0x1.97c1d1b3b7af0p-3"),
    ("0x1.1bb4a4a1a343fp+0", "-0x1.2f9e393af3c9fp-3"),
    ("0x1.12358f08ae5bap+0", "-0x1.960cbbf788d5cp-4"),
    ("0x1.0953f419900a7p+0", "-0x1.a6f9db6475fcep-5"),
    ("0x1.0000000000000p+0", "0x0.0p+0"),
    ("0x1.e608cfd9a47acp-1", "0x1.338ca9f24f53dp-4"),
    ("0x1.ca4b31f026aa0p-1", "0x1.476a9543891bap-3"),
    ("0x1.b2036576afce6p-1", "0x1.e840b4ac4e4d2p-3"),
    ("0x1.9c2d163a1aa2dp-1", "0x1.40645f0c6651cp-2"),
    ("0x1.886e6037841edp-1", "0x1.88e9c2c1b9ff8p-2"),
    ("0x1.767dcf5534862p-1", "0x1.ce0a44eb17bccp-2"))
_LOG2_POLY = ("0x1.27616c9496e0bp-2", "-0x1.71969a075c67ap-2",
              "0x1.ec70a6ca7baddp-2", "-0x1.7154748bef6c8p-1",
              "0x1.71547652ab82bp+0")
_EXP2_TAB = (  # bits of 2^(i/32), less i << 47
    0x3FF0000000000000, 0x3FEFD9B0D3158574, 0x3FEFB5586CF9890F,
    0x3FEF9301D0125B51, 0x3FEF72B83C7D517B, 0x3FEF54873168B9AA,
    0x3FEF387A6E756238, 0x3FEF1E9DF51FDEE1, 0x3FEF06FE0A31B715,
    0x3FEEF1A7373AA9CB, 0x3FEEDEA64C123422, 0x3FEECE086061892D,
    0x3FEEBFDAD5362A27, 0x3FEEB42B569D4F82, 0x3FEEAB07DD485429,
    0x3FEEA47EB03A5585, 0x3FEEA09E667F3BCD, 0x3FEE9F75E8EC5F74,
    0x3FEEA11473EB0187, 0x3FEEA589994CCE13, 0x3FEEACE5422AA0DB,
    0x3FEEB737B0CDC5E5, 0x3FEEC49182A3F090, 0x3FEED503B23E255D,
    0x3FEEE89F995AD3AD, 0x3FEEFF76F2FB5E47, 0x3FEF199BDD85529C,
    0x3FEF3720DCEF9069, 0x3FEF5818DCFBA487, 0x3FEF7C97337B9B5F,
    0x3FEFA4AFA2A490DA, 0x3FEFD0765B6E4540)
_EXP2_POLY = ("0x1.c6af84b912394p-5", "0x1.ebfce50fac4f3p-3",
              "0x1.62e42ff0c52d6p-1")


def _powf(x: torch.Tensor, y: float) -> torch.Tensor:
    """float32 ``x ** y`` as ``nbodyax``'s jnp computes it on the CPU, for
    positive normal x and a normal result. torch's own pow differs by an
    ulp here and there, which r = a / sqrt(u^(-2/3) - 1) amplifies near
    the Plummer tail's cut."""
    f64 = torch.float64
    a0, a1, a2, a3, a4 = (float.fromhex(c) for c in _LOG2_POLY)
    c0, c1, c2 = (float.fromhex(c) for c in _EXP2_POLY)
    inv_c = torch.tensor([float.fromhex(c) for c, _ in _LOG2_TAB], dtype=f64)
    log_c = torch.tensor([float.fromhex(c) for _, c in _LOG2_TAB], dtype=f64)
    # log2 x = k + log2 c + log2(z / c), x = 2^k z, z in [0x1.66p-1, 0x1.66p0)
    ix = x.view(torch.int32).to(torch.int64)
    tmp = (ix - 0x3F330000) & 0xFFFFFFFF
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    k = torch.where(top >= 1 << 31, top - (1 << 32), top) >> 23
    z = ((ix - top) & 0xFFFFFFFF).to(torch.int32).view(torch.float32)
    r = z.double() * inv_c[i] - 1
    r2 = r * r
    q = (a2 * r + a3) * r2 + (a4 * r + (log_c[i] + k.double()))
    ylogx = float(np.float32(y)) * ((a0 * r + a1) * (r2 * r2) + q)
    # 2^ylogx = 2^(j/32) 2^t, |t| <= 1/64
    shift = float.fromhex("0x1.8p+47")
    kd = (ylogx + shift) - shift
    t = ylogx - kd
    j = (kd * 32).round().to(torch.int64)
    s = (torch.tensor(_EXP2_TAB, dtype=torch.int64)[j & 31]
         + j * (1 << 47)).view(f64)
    return (((c0 * t + c1) * (t * t) + (c2 * t + 1)) * s).float()


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
    reference is 2-D). Otherwise it is ``nbodyax``'s ``jax.random`` draw,
    bit for bit: positions uniform over [-ext, ext] on each axis, ext =
    (fieldWidth, fieldHeight, fieldDepth or fieldWidth).
    """
    if parity and cfg.dimensions == 2:
        pos, vel, mass, radius = scene_arrays(
            cfg.seed, cfg.particle_count, cfg.field_width, cfg.field_height,
            cfg.min_body_mass, cfg.max_body_mass, cfg.min_radius,
            cfg.max_radius)
        return make_state(pos, vel, mass, radius, device=device)
    n, d = cfg.particle_count, cfg.dimensions
    kp, km, kr = prng.split(prng.prng_key(cfg.seed), 3)
    ext = torch.tensor(_field_extents(cfg))
    pos = prng.uniform(kp, (n, d), -ext, ext, device=device)
    mass = prng.uniform(km, (n,), cfg.min_body_mass, cfg.max_body_mass,
                        device=device)
    radius = prng.uniform(kr, (n,), cfg.min_radius, cfg.max_radius,
                          device=device)
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
    f32 = torch.float32

    def draw(key, count, lo=0.0, hi=1.0):
        return prng.uniform(key, (count,), lo, hi, device=device).cpu()

    def disk(key, count, center, drift):
        k1, k2, k3, k4, k5 = prng.split(key, 5)
        m = count - 1
        r = disk_r * torch.sqrt(draw(k1, m, 0.01))
        th = draw(k2, m, hi=2 * math.pi)
        pcols = [r * torch.cos(th), r * torch.sin(th)]
        vc = torch.sqrt(_f32(G * m_central) / r)
        vcols = [-vc * torch.sin(th), vc * torch.cos(th)]
        if d == 3:
            pcols.append(draw(k5, m, -0.02 * disk_r, 0.02 * disk_r))
            vcols.append(torch.zeros(m, dtype=f32))
        p = torch.stack(pcols, -1) + center
        v = torch.stack(vcols, -1) + drift
        mass = draw(k3, m, cfg.min_body_mass, 0.01 * cfg.max_body_mass)
        rad = draw(k4, m, cfg.min_radius * r_scale, cfg.max_radius * r_scale)
        return (torch.cat([center[None], p]), torch.cat([drift[None], v]),
                torch.cat([torch.tensor([m_central], dtype=f32), mass]),
                torch.cat([torch.tensor([cfg.max_radius], dtype=f32), rad]))

    ka, kb = prng.split(prng.prng_key(cfg.seed))
    zpad = [0.0] * (d - 2)
    parts = [disk(ka, n1, torch.tensor([-sep / 2, 0.0] + zpad, dtype=f32),
                  torch.tensor([approach_v, 0.0] + zpad, dtype=f32)),
             disk(kb, n - n1, torch.tensor([sep / 2, 0.0] + zpad, dtype=f32),
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
    k_r, k_dir, k_q, k_vdir, k_m, k_rad = prng.split(
        prng.prng_key(cfg.seed), 6)

    def draw(key, lo=0.0, hi=1.0):
        return prng.uniform(key, (n,), lo, hi, device=device).cpu()

    def unit_vectors(key):
        if dim == 2:
            th = draw(key, hi=2 * math.pi)
            return torch.stack([torch.cos(th), torch.sin(th)], -1)
        k1, k2 = prng.split(key)
        z = draw(k1, -1.0, 1.0)
        th = draw(k2, hi=2 * math.pi)
        s = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
        return torch.stack([s * torch.cos(th), s * torch.sin(th), z], -1)

    u_max = r_max ** 3 / (r_max ** 2 + a ** 2) ** 1.5
    u = draw(k_r, 1e-6, u_max)
    r = _f32(a) / torch.sqrt(_powf(u, -2.0 / 3.0) - 1.0)
    pos = r[:, None] * unit_vectors(k_dir)

    qs = np.linspace(0.0, 1.0, 2049)
    pdf = qs ** 2 * (1.0 - qs ** 2) ** 3.5
    cdf = np.concatenate([[0.0], np.cumsum((pdf[1:] + pdf[:-1]) * 0.5)])
    cdf /= cdf[-1]
    q = _interp(draw(k_q), torch.tensor(cdf, dtype=torch.float32),
                torch.tensor(qs, dtype=torch.float32))
    v_esc = torch.sqrt(_f32(2.0 * G * m_total)) * _powf(r * r + a * a,
                                                          -0.25)
    vel = (q * v_esc)[:, None] * unit_vectors(k_vdir)

    mass = draw(k_m, cfg.min_body_mass, cfg.max_body_mass)
    half_mass_r = a / np.sqrt(2.0 ** (2.0 / 3.0) - 1.0)
    r_scale = _packed_radius_scale(cfg, n, half_mass_r)
    radius = draw(k_rad, cfg.min_radius * r_scale, cfg.max_radius * r_scale)
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
