"""The fused all-pairs kernel: wrapper, plain version and decode.

Counterpart of ``nbodyax/physics/kernels.py``. The TPU kernel there
(``_pair_kernel``) becomes the hand-written CUDA kernel in
``nbodyax_torch/csrc/pair_kernel.cu``, built by ``physics/_build.py`` and
called through ``ctypes``. The layouts are the TPU kernel's:

- features, f32[N, 8] per body: x, y, vx, vy, mass, radius, 0, 0, with the
  radius of a dead body (mass <= 0) clamped to 0 (``body_features``);
- raw output, f32[N, 8]: ch0-1 force, ch2-4 gained mass / gained radius /
  died count (reference) or the halved dv (elastic), ch5 0, ch6 best mass
  (momentum; ``-FLT_MAX`` when there is no candidate), ch7 0;
- momentum parent, i32[N]: global id of the best candidate, ``INT32_MAX``
  when there is none. (The TPU kernel pads this to an [N, 8] block.)

Rows of dead i bodies carry junk in the raw output; ``decode_raw`` zeroes
them. The kernel is 2-D only.

``tile_accumulators_raw`` launches the kernel for CUDA tensors and runs
``tile_accumulators_raw_reference`` for CPU tensors. ``launches`` counts
kernel launches, so a run can show it went through the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from nbodyax_torch.physics.pairwise import PairAccumulators, squared_distance

__all__ = ["body_features", "tile_accumulators_raw",
           "tile_accumulators_raw_reference", "decode_raw",
           "pair_accumulators_kernel", "NUM_FEATS", "NUM_CH", "MODES"]

NUM_FEATS = 8
NUM_CH = 8
MODES = ("reference", "momentum", "elastic", "none")
_NEG_INF = float(np.finfo(np.float32).min)   # "no candidate" best mass
_I32_MAX = int(np.iinfo(np.int32).max)       # "no candidate" parent


def body_features(pos, vel, mass, radius) -> torch.Tensor:
    """Pack state into f32[N, 8] rows: pos, vel, mass, radius, zero pad.

    Dead bodies get radius 0, so every contribution of a dead j body
    vanishes without alive masks: force, merge gain and impulse carry an
    ``m_j`` factor, dying needs ``m_j > m_i >= 0``, and the gained radius
    is ``r_j * growth``.
    """
    n, d = pos.shape
    if d != 2:
        raise NotImplementedError(
            "the pair kernel is 2-D only (3-D is ROADMAP item A5's "
            "remainder)")
    out = torch.zeros((n, NUM_FEATS), dtype=torch.float32, device=pos.device)
    out[:, 0:2] = pos
    out[:, 2:4] = vel
    out[:, 4] = mass
    out[:, 5] = torch.where(mass > 0, radius, torch.zeros_like(radius))
    return out


def _float32(x: float) -> float:
    return float(np.float32(x))


def _check_inputs(feats_i, feats_j, mode):
    if mode not in MODES:
        raise ValueError(f"unknown collision mode {mode!r}")
    for name, t in (("feats_i", feats_i), ("feats_j", feats_j)):
        if t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != NUM_FEATS:
            raise ValueError(f"{name} must be f32[N, {NUM_FEATS}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    if feats_i.device != feats_j.device:
        raise ValueError("feats_i and feats_j lie on different devices")


def tile_accumulators_raw(feats_i: torch.Tensor, feats_j: torch.Tensor,
                          i_offset: int, j_offset: int, *, mode: str,
                          eps: float, growth_rate: float):
    """Raw channel accumulators of i bodies against j bodies.

    ``feats_i`` f32[Ni, 8] and ``feats_j`` f32[Nj, 8] are body_features rows;
    ``i_offset`` / ``j_offset`` are the global ids of their first rows.
    Returns ``(raw f32[Ni, 8], parent i32[Ni] or None)``; the parent is
    returned in momentum mode only.

    A CUDA tensor goes to the hand-written kernel (built at first use); a
    CPU tensor goes to ``tile_accumulators_raw_reference``.
    """
    _check_inputs(feats_i, feats_j, mode)
    if feats_i.device.type == "cpu":
        return tile_accumulators_raw_reference(
            feats_i, feats_j, i_offset, j_offset, mode=mode, eps=eps,
            growth_rate=growth_rate)
    if feats_i.device.type != "cuda":
        raise ValueError(f"no pair kernel for device {feats_i.device}")
    from nbodyax_torch.physics._build import load_library
    lib = load_library()
    fi, fj = feats_i.contiguous(), feats_j.contiguous()
    ni, nj = fi.shape[0], fj.shape[0]
    i_offset, j_offset = int(i_offset), int(j_offset)
    if min(i_offset, j_offset) < 0 or max(i_offset + ni,
                                          j_offset + nj) > _I32_MAX:
        raise ValueError("body ids must be non-negative and fit in int32")
    raw = torch.empty((ni, NUM_CH), dtype=torch.float32, device=fi.device)
    parent = (torch.empty((ni,), dtype=torch.int32, device=fi.device)
              if mode == "momentum" else None)
    eps32 = np.float32(eps)
    with torch.cuda.device(fi.device):
        stream = torch.cuda.current_stream(fi.device).cuda_stream
        err = lib.nbodyax_pair_accumulators(
            fi.data_ptr(), ni, fj.data_ptr(), nj, i_offset, j_offset,
            MODES.index(mode), float(eps32 * eps32), _float32(growth_rate),
            raw.data_ptr(),
            parent.data_ptr() if parent is not None else None, stream)
    if err != 0:
        raise RuntimeError(f"pair kernel launch failed: CUDA error {err}")
    tile_accumulators_raw.launches += 1
    return raw, parent


tile_accumulators_raw.launches = 0


def tile_accumulators_raw_reference(feats_i: torch.Tensor,
                                    feats_j: torch.Tensor, i_offset: int,
                                    j_offset: int, *, mode: str, eps: float,
                                    growth_rate: float, chunk=None):
    """Plain PyTorch version of the kernel: same inputs, same raw layout,
    same per-pair rules (self pairs and pairs with dead bodies drop out
    through the overlap test and the clamped radius, as in the kernel).
    Chunked over i so the pair temporaries stay near 2^22 elements."""
    _check_inputs(feats_i, feats_j, mode)
    dev = feats_i.device
    ni, nj = feats_i.shape[0], feats_j.shape[0]
    if chunk is None:
        chunk = max(1, min(ni, (1 << 22) // max(nj, 1)))
    eps32 = np.float32(eps)
    eps2 = float(eps32 * eps32)
    growth = _float32(growth_rate)
    pj, vj = feats_j[:, 0:2], feats_j[:, 2:4]
    mj, rj = feats_j[None, :, 4], feats_j[None, :, 5]
    gj = (int(j_offset)
          + torch.arange(nj, dtype=torch.int32, device=dev))[None, :]
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    raw = torch.zeros((ni, NUM_CH), dtype=torch.float32, device=dev)
    raw[:, 6] = _NEG_INF
    parent = (torch.full((ni,), _I32_MAX, dtype=torch.int32, device=dev)
              if mode == "momentum" else None)
    for s in range(0, ni, chunk):
        f = feats_i[s:s + chunk]
        c = f.shape[0]
        mi, ri = f[:, 4:5], f[:, 5:6]
        gi = (int(i_offset) + s
              + torch.arange(c, dtype=torch.int32, device=dev))[:, None]
        dp = pj[None, :, :] - f[:, None, 0:2]
        d2 = squared_distance(dp)
        rsum = ri + rj
        overlap = d2 <= rsum * rsum                     # includes self pairs
        inv = torch.rsqrt(d2 + eps2)
        wm = mj * (inv * inv * inv)
        if mode == "elastic":
            w = wm if eps2 > 0.0 else torch.where(d2 > 0, wm, zero)
        else:
            w = torch.where(overlap, zero, wm)
        out = raw[s:s + c]
        out[:, 0] = (w * dp[..., 0]).sum(1)
        out[:, 1] = (w * dp[..., 1]).sum(1)
        if mode == "reference":
            hit = overlap & (gj != gi)
            heavier = mi >= mj
            merge = hit & heavier
            out[:, 2] = torch.where(merge, mj, zero).sum(1)
            out[:, 3] = torch.where(merge, rj * growth, zero).sum(1)
            out[:, 4] = (hit & ~heavier).sum(1).to(torch.float32)
        elif mode == "momentum":
            beats = (mj > mi) | ((mj == mi) & (gj < gi))
            cand = overlap & beats
            key = torch.where(cand, mj, torch.full_like(d2, _NEG_INF))
            bm = key.max(1, keepdim=True).values
            # lowest id among the best; -INT32_MAX when there is none
            order = torch.where(cand & (key == bm), -gj,
                                torch.full_like(d2, -_I32_MAX,
                                                dtype=torch.int32))
            out[:, 6] = bm[:, 0]
            parent[s:s + c] = -order.max(1).values
        elif mode == "elastic":
            vdotp = ((vj[None, :, 0] - f[:, None, 2]) * dp[..., 0]
                     + (vj[None, :, 1] - f[:, None, 3]) * dp[..., 1])
            approaching = overlap & (vdotp < 0)
            coef = torch.where(approaching, vdotp * mj / ((mi + mj) * d2),
                               zero)
            out[:, 2] = (coef * dp[..., 0]).sum(1)
            out[:, 3] = (coef * dp[..., 1]).sum(1)
    return raw, parent


def decode_raw(raw, parent_raw, i_offset: int, mass_i,
               mode: str) -> PairAccumulators:
    """Unpack the raw channels into PairAccumulators, zeroing dead i rows
    (the kernel carries no alive-i masks)."""
    n, dev = raw.shape[0], raw.device
    alive = mass_i > 0
    ids = int(i_offset) + torch.arange(n, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    z = torch.zeros((n,), dtype=torch.float32, device=dev)
    force = torch.where(alive[:, None], raw[:, 0:2], zero)
    gm = gr = z
    died = torch.zeros((n,), dtype=torch.bool, device=dev)
    best_mass = torch.full((n,), -torch.inf, dtype=torch.float32, device=dev)
    parent = ids
    dv = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    if mode == "reference":
        gm = torch.where(alive, raw[:, 2], zero)
        gr = torch.where(alive, raw[:, 3], zero)
        died = (raw[:, 4] > 0) & alive
    elif mode == "momentum":
        any_cand = (raw[:, 6] > _NEG_INF) & alive
        best_mass = torch.where(any_cand, raw[:, 6], best_mass)
        parent = torch.where(any_cand, parent_raw, ids)
    elif mode == "elastic":
        # the kernel sums m_j/(m_i+m_j) * vdotp/d2 * dp; the impulse's
        # factor 2 is applied here, once per i body
        dv = torch.where(alive[:, None], 2.0 * raw[:, 2:4], zero)
    return PairAccumulators(force=force, gained_mass=gm, gained_radius=gr,
                            died=died, best_mass=best_mass, parent=parent,
                            dv=dv)


def pair_accumulators_kernel(pos, vel, mass, radius, *, eps: float = 0.0,
                             growth_rate: float = 0.1,
                             mode: str = "reference") -> PairAccumulators:
    """All-pairs accumulators through ``tile_accumulators_raw``: the
    counterpart of ``pallas_pair_accumulators``, a drop-in for
    ``physics.pairwise.pair_accumulators``."""
    feats = body_features(pos, vel, mass, radius)
    raw, par = tile_accumulators_raw(feats, feats, 0, 0, mode=mode, eps=eps,
                                     growth_rate=growth_rate)
    return decode_raw(raw, par, 0, mass, mode)
