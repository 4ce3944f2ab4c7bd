"""Configuration: ``SimConfig`` and the ``nbodyConfig.txt`` parser.

A JAX-free copy of ``nbodyax/config.py`` with the same fields, defaults and
behaviour: one ``key=value`` per line, values parsed with C++
``std::stoi`` / ``std::stof`` semantics (the longest numeric prefix, so
``0.2f`` reads as 0.2), a hard error on an unparseable value, and
warn-and-ignore on an unknown key, as the reference's parser does.
"""

from __future__ import annotations

import dataclasses
import re
import sys
from typing import Optional

__all__ = ["SimConfig", "ConfigError", "parse_config_file", "parse_config_text"]


class ConfigError(ValueError):
    """Raised where the reference would print an error and exit(1)
    (``nbodyConfig.h:41-44`` and siblings)."""


# C++ std::stoi: optional ws, optional sign, decimal digits; ignores trailing junk.
_STOI_RE = re.compile(r"\s*([+-]?\d+)")
# C++ std::stof: optional ws, then a float literal (fixed/scientific/hex omitted),
# ignores trailing junk (which is how '0.2f' parses as 0.2).
_STOF_RE = re.compile(r"\s*([+-]?(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?)")


def _stoi(text: str, key: str) -> int:
    m = _STOI_RE.match(text)
    if not m:
        raise ConfigError(f"{key} invalid value: {text!r}")
    return int(m.group(1))


def _stof(text: str, key: str) -> float:
    m = _STOF_RE.match(text)
    if not m:
        raise ConfigError(f"{key} invalid value: {text!r}")
    return float(m.group(1))


def _bool(text: str, key: str) -> bool:
    v = text.strip().lower()
    if v in ("1", "true", "yes", "on"):
        return True
    if v in ("0", "false", "no", "off"):
        return False
    raise ConfigError(f"{key} invalid value: {text!r} (expected true/false)")


@dataclasses.dataclass
class SimConfig:
    """All simulation settings.

    The first block mirrors ``struct ConfigData``
    (the reference's ``nbodyConfig.h``) with identical defaults to the shipped
    ``nbodyConfig.txt`` scene. The second block holds the framework
    extensions. The port accepts every field; its driver raises on the
    values it does not run yet.
    """

    # --- reference-compatible fields (nbodyConfig.h:4-19) ---
    particle_count: int = 16384
    total_iterations: int = 2000
    save_image_every: int = 10            # save_Image_Every_Xth_Iteration
    timestep: float = 0.2
    min_body_mass: float = 1e4            # minRandBodyMass
    max_body_mass: float = 1e17           # maxRandBodyMass
    min_radius: float = 50.0
    max_radius: float = 200.0
    growth_rate: float = 0.1              # radiusGrowthRate
    img_width: int = 1024
    img_height: int = 1024
    field_width: int = 100000
    field_height: int = 100000
    image_path: str = "iter_img"

    # --- framework extensions (warn-ignored by the reference parser) ---
    dimensions: int = 2                   # 2 (reference) | 3 (extension: full
                                          # 3-D pair physics, frames render
                                          # the xy projection)
    field_depth: int = 0                  # z half-extent for dimensions=3
                                          # (0 = use fieldWidth)
    seed: int = 1024                      # reference hardcodes 1024 (nbody.cu:403)
    softening: float = 0.0                # eps in 1/(d^2+eps^2)^{3/2}; 0 = reference (Q4)
    collision_mode: str = "reference"     # reference | momentum | elastic | none
    restitution: float = 1.0              # elastic-mode coefficient of
                                          # restitution e in [0,1]: pair
                                          # impulse scaled by (1+e)/2 (e=1 =
                                          # perfectly elastic, the mode's
                                          # original behavior; e<1 = partially
                                          # inelastic bounce). Body-body only;
                                          # wall bounces stay sign-flips.
    boundary_mode: str = "reference"      # reference (Q6 accel*dt flip) | clamp | none
    wall_restitution: float = 1.0         # clamp-mode wall coefficient of
                                          # restitution: bounce scales the
                                          # flipped velocity component by e_w
                                          # in [0,1] (1 = specular, the
                                          # original behavior; reference mode
                                          # ignores it — Q6 stays exact)
    integrator: str = "euler"             # euler (semi-implicit, reference)
                                          # | leapfrog (2nd-order symplectic
                                          # KDK) | yoshida4 (4th-order
                                          # symplectic composition; 4 force
                                          # passes/step — accuracy runs)
    adaptive_dt: bool = False             # global stability-bounded dt per
                                          # step (lockstep; beyond-reference —
                                          # the reference is fixed-dt). dt =
                                          # clip(min_i min(eta*sqrt(r/|a|),
                                          # eta*r/|v|), dtMin, dtMax)
    dt_eta: float = 0.25                  # adaptive safety factor
    dt_min: float = 0.0                   # adaptive floor (0 = dtMax/1024)
    dt_max: float = 0.0                   # adaptive ceiling (0 = timestep)
    backend: str = "auto"                 # auto | jnp | pallas
    force_model: str = "exact"            # exact (all-pairs, reference) | bh
                                          # (hierarchical far field + exact
                                          # grid-neighbor near field)
    bh_levels: int = 0                    # finest quadtree level (0 = auto)
    bh_ring: int = 1                      # near-window ring; 2 = ~10x better
                                          # far-field accuracy, more near work
    bh_neighbor_k: int = 0                # near-field partner cap (0=auto);
                                          # caps a window ROW of 2*bhRing+1
                                          # cells (bhNear=rows) or the slots
                                          # per window CELL (bhNear=slots)
    bh_near: str = "auto"                 # near-field engine: rows (gathered
                                          # per-row windows, fastest on
                                          # near-uniform scenes) | slots
                                          # (sliced per-cell slot grid,
                                          # absorbs clustering without grid
                                          # refinement) | auto (pick by
                                          # measured overflow at startup)
    bh_order: int = 2                     # far-field expansion: 1=monopole,
                                          # 2=+quadrupole (default: ~5x less
                                          # error, measured no slower on v5e)
    bh_far: str = "fmm"                   # far-field engine: fmm (dense
                                          # local expansions, zero window
                                          # gathers + exact-target annulus)
                                          # | direct (gathered per-cell
                                          # windows, exact target)
    bh_pallas: str = "auto"               # near-field and slot-pack
                                          # kernels for bhNear=slots, and
                                          # the annulus kernel: auto
                                          # (the CUDA kernels on a CUDA
                                          # device) | on (the kernels; an
                                          # error without a card) | off
                                          # (the plain torch engine)
    bh_comp_cap: int = 0                  # completion-pass budget: bodies
                                          # past their cell's fast-pass slot
                                          # cap finished exactly per-body
                                          # (0 = auto: ~n/16, raised
                                          # count-aware by pick_levels /
                                          # bhAdapt when a scene's crowded
                                          # cells would otherwise drop
                                          # bodies past it)
    bh_giants: int = 1024                 # largest-radius bodies given
                                          # EXACT any-distance collisions
                                          # (the near window only covers
                                          # r_i+r_j <= ring*cell; merged
                                          # giants outgrow it) — O(N*B)
                                          # collision-only pass; 0 = off
    bh_adapt: bool = True                 # driver self-tuning between log
                                          # windows: widen bhNeighborK when
                                          # bh_overflow is logged, coarsen
                                          # bhLevels when grown radii
                                          # threaten the near-window
                                          # collision range AND bhGiants=0
                                          # (the giant pass covers it
                                          # exactly; bounded recompiles;
                                          # 0 = pin the knobs)
    shards: int = 1                       # devices to shard bodies over
    scene: str = "uniform"                # uniform (reference) | galaxy |
                                          # plummer | three_body
    # NOTE deliberately no bf16 knob: bf16's 8-bit mantissa quantizes default-
    # scene positions (~1e5) to ~512-unit steps, far coarser than collision
    # radii — pair math must stay f32 on this workload
    compact_every: int = 0                # shrink capacity to live count every
                                          # k steps (0 = off); reference analog
                                          # of per-step host compaction
    checkpoint_every: int = 0             # 0 = disabled
    checkpoint_path: str = "checkpoints"
    checkpoint_keep: int = 3              # retention: keep the newest k
                                          # snapshots (0 = keep all); long
                                          # runs otherwise accumulate ~100 MB
                                          # per save (io/checkpoint.py)
    checkpoint_milestone_every: int = 0   # snapshots at step multiples of m
                                          # survive pruning (0 = none)
    auto_resume: bool = False             # on runtime failure, reload the
                                          # latest checkpoint and continue
    max_retries: int = 3                  # attempts when autoResume is on
    resume_from: str = ""                 # checkpoint file to resume from
    log_every: int = 10                   # JSONL cadence; also bounds the
                                          # driver's fused dispatch window
                                          # (1 = per-step dispatches: slow on
                                          # high-latency transports)
    energy_every: int = 0                 # also log O(N^2) pair potential +
                                          # total energy every k steps (0=off;
                                          # must be a multiple of logEvery)
    log_path: str = ""                    # JSONL metrics path ("" = stdout only)
    render_patch: int = 32                # static rasterizer patch edge (pixels)
    save_images: bool = True

    def validate(self) -> "SimConfig":
        if self.particle_count <= 0:
            raise ConfigError("particleCount must be positive")
        if self.dimensions not in (2, 3):
            raise ConfigError(f"dimensions must be 2 or 3 "
                              f"(got {self.dimensions})")
        if self.collision_mode not in ("reference", "momentum", "elastic", "none"):
            raise ConfigError(f"unknown collisionMode {self.collision_mode!r}")
        if not 0.0 <= self.restitution <= 1.0:
            raise ConfigError(
                f"restitution must be in [0, 1] (got {self.restitution})")
        if not 0.0 <= self.wall_restitution <= 1.0:
            raise ConfigError(f"wallRestitution must be in [0, 1] "
                              f"(got {self.wall_restitution})")
        if self.boundary_mode not in ("reference", "clamp", "none"):
            raise ConfigError(f"unknown boundaryMode {self.boundary_mode!r}")
        if self.integrator not in ("euler", "leapfrog", "yoshida4"):
            raise ConfigError(f"unknown integrator {self.integrator!r}")
        if self.adaptive_dt:
            if self.dt_eta <= 0:
                raise ConfigError("dtEta must be > 0")
            if self.dt_min < 0 or self.dt_max < 0:
                raise ConfigError("dtMin/dtMax must be >= 0 (0 = auto)")
            hi = self.dt_max or self.timestep
            if self.dt_min and self.dt_min > hi:
                raise ConfigError(
                    f"dtMin ({self.dt_min}) exceeds the effective dtMax "
                    f"({hi})")
        if self.checkpoint_keep < 0 or self.checkpoint_milestone_every < 0:
            raise ConfigError("checkpointKeep / checkpointMilestoneEvery "
                              "must be >= 0")
        if self.energy_every:
            # the energy block only fires on log boundaries; enforce the
            # documented contract instead of silently logging nothing
            if not self.log_every or self.energy_every % self.log_every:
                raise ConfigError(
                    "energyEvery must be a (nonzero) multiple of logEvery "
                    f"(got energyEvery={self.energy_every}, "
                    f"logEvery={self.log_every})")
        if self.backend not in ("auto", "jnp", "pallas"):
            raise ConfigError(f"unknown backend {self.backend!r}")
        if self.force_model not in ("exact", "bh"):
            raise ConfigError(f"unknown forceModel {self.force_model!r}")
        if self.force_model == "bh":
            if self.bh_ring not in (1, 2, 3):
                raise ConfigError("bhRing must be 1, 2 or 3")
            # 3-D caps at 7: the octree's finest dense grid holds 2^(3*lv)
            # cells (2 M at 7; an order-2 grid stack is ~100 MB there)
            max_lv = 7 if self.dimensions == 3 else 12
            if self.bh_levels != 0 and not 2 <= self.bh_levels <= max_lv:
                raise ConfigError(
                    f"bhLevels must be 0 (auto) or in [2, {max_lv}]")
            if self.bh_neighbor_k < 0:
                raise ConfigError("bhNeighborK must be >= 0 (0 = auto)")
            if self.bh_comp_cap < 0:
                raise ConfigError("bhCompCap must be >= 0 (0 = auto)")
            if self.bh_giants < 0:
                raise ConfigError("bhGiants must be >= 0 (0 = off)")
            if self.bh_order not in (1, 2):
                raise ConfigError("bhOrder must be 1 or 2")
            if self.bh_far not in ("fmm", "direct"):
                raise ConfigError("bhFar must be fmm or direct")
            if self.bh_near not in ("auto", "rows", "slots"):
                raise ConfigError("bhNear must be auto, rows or slots")
            if self.bh_pallas not in ("auto", "on", "off"):
                raise ConfigError("bhPallas must be auto, on or off")
        return self


# key -> (attribute, parser). Parsers emulate the per-key stoi/stof try blocks
# of nbodyConfig.h:36-221.
_KEYS = {
    "particleCount": ("particle_count", _stoi),
    "totalIterations": ("total_iterations", _stoi),
    "save_Image_Every_Xth_Iteration": ("save_image_every", _stoi),
    "timestep": ("timestep", _stof),
    "minRandBodyMass": ("min_body_mass", _stof),
    "maxRandBodyMass": ("max_body_mass", _stof),
    "minRadius": ("min_radius", _stof),
    "maxRadius": ("max_radius", _stof),
    "radiusGrowthRate": ("growth_rate", _stof),
    "imgWidth": ("img_width", _stoi),
    "imgHeight": ("img_height", _stoi),
    "fieldWidth": ("field_width", _stoi),
    "fieldHeight": ("field_height", _stoi),
    "imagePath": ("image_path", lambda s, k: s),
    # framework extensions
    "dimensions": ("dimensions", _stoi),
    "fieldDepth": ("field_depth", _stoi),
    "seed": ("seed", _stoi),
    "softening": ("softening", _stof),
    "collisionMode": ("collision_mode", lambda s, k: s.strip()),
    "restitution": ("restitution", _stof),
    "wallRestitution": ("wall_restitution", _stof),
    "boundaryMode": ("boundary_mode", lambda s, k: s.strip()),
    "integrator": ("integrator", lambda s, k: s.strip()),
    "adaptiveDt": ("adaptive_dt", _bool),
    "dtEta": ("dt_eta", _stof),
    "dtMin": ("dt_min", _stof),
    "dtMax": ("dt_max", _stof),
    "backend": ("backend", lambda s, k: s.strip()),
    "forceModel": ("force_model", lambda s, k: s.strip()),
    "bhLevels": ("bh_levels", _stoi),
    "bhRing": ("bh_ring", _stoi),
    "bhNeighborK": ("bh_neighbor_k", _stoi),
    "bhCompCap": ("bh_comp_cap", _stoi),
    "bhGiants": ("bh_giants", _stoi),
    "bhPallas": ("bh_pallas", lambda s, k: s.strip()),
    "bhOrder": ("bh_order", _stoi),
    # (bhFar once used bare ``str`` here, which explodes under the
    # parser(value, key) call convention — keep the two-arg lambda form)
    "bhFar": ("bh_far", lambda s, k: s.strip()),
    "bhNear": ("bh_near", lambda s, k: s.strip()),
    "bhAdapt": ("bh_adapt", _bool),
    "shards": ("shards", _stoi),
    "scene": ("scene", lambda s, k: s.strip()),
    "compactEvery": ("compact_every", _stoi),
    "checkpointEvery": ("checkpoint_every", _stoi),
    "checkpointPath": ("checkpoint_path", lambda s, k: s.strip()),
    "checkpointKeep": ("checkpoint_keep", _stoi),
    "checkpointMilestoneEvery": ("checkpoint_milestone_every", _stoi),
    "autoResume": ("auto_resume", _bool),
    "maxRetries": ("max_retries", _stoi),
    "resumeFrom": ("resume_from", lambda s, k: s.strip()),
    "logEvery": ("log_every", _stoi),
    "energyEvery": ("energy_every", _stoi),
    "logPath": ("log_path", lambda s, k: s.strip()),
    "renderPatch": ("render_patch", _stoi),
    "saveImages": ("save_images", _bool),
}


def parse_config_text(text: str, *, verbose: bool = False,
                      base: Optional[SimConfig] = None) -> SimConfig:
    """Parse config file contents.

    Line handling matches the reference parser loop (``nbodyConfig.h:33-225``):
    split at the first ``=``; a line without ``=`` makes the whole line the
    (unknown) key name, which is warn-ignored. Empty lines have empty key names
    and are likewise warn-ignored by the reference; we silently skip fully
    blank lines and ``#`` comments as a quality-of-life extension.
    """
    cfg = dataclasses.replace(base) if base is not None else SimConfig()
    for raw in text.splitlines():
        line = raw.rstrip("\r")
        if not line.strip() or line.lstrip().startswith("#"):
            continue
        pos = line.find("=")
        if pos < 0:
            name, value = line, line  # substr(npos+1) == whole line in the reference
        else:
            name, value = line[:pos], line[pos + 1:]
        entry = _KEYS.get(name)
        if entry is None:
            # nbodyConfig.h:222-224 — warn and ignore.
            print(f"Invalid variable: {name}", file=sys.stderr)
            continue
        attr, parser = entry
        setattr(cfg, attr, parser(value, name))
        if verbose:
            print(f"{name}={getattr(cfg, attr)}")
    return cfg.validate()


def parse_config_file(path: str, *, verbose: bool = False,
                      base: Optional[SimConfig] = None) -> SimConfig:
    """Parse a ``nbodyConfig.txt``-format file (``nbodyConfig.h:22-227``)."""
    try:
        with open(path, "r") as f:
            text = f.read()
    except OSError as e:
        raise ConfigError(f"Error opening config file! ({path}): {e}") from e
    return parse_config_text(text, verbose=verbose, base=base)


def apply_overrides(cfg: SimConfig, overrides: list[str]) -> SimConfig:
    """Apply ``--set key=value`` CLI overrides using the same key table."""
    for item in overrides:
        pos = item.find("=")
        if pos < 0:
            raise ConfigError(f"override {item!r} is not key=value")
        name, value = item[:pos], item[pos + 1:]
        entry = _KEYS.get(name)
        if entry is None:
            raise ConfigError(f"unknown config key {name!r}")
        attr, parser = entry
        setattr(cfg, attr, parser(value, name))
    return cfg.validate()
