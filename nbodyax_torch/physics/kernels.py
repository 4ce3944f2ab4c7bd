"""The fused all-pairs kernel: wrapper, plain version and decode.

Counterpart of ``nbodyax/physics/kernels.py``. The TPU kernel there
(``_pair_kernel``) becomes the hand-written CUDA kernel in
``nbodyax_torch/csrc/pair_kernel.cu``, built by ``physics/_build.py`` and
called through ``ctypes``. The layouts are the TPU kernel's, a function of
the dimension D (2 or 3):

- features, f32[N, 8] per body: pos[0:D], vel[D:2D], mass at 2D, radius
  at 2D+1, zero padding, with the radius of a dead body (mass <= 0)
  clamped to 0 (``body_features``);
- raw output, f32[N, 8]: ch0..D-1 force; chD, D+1, D+2 gained mass /
  gained radius / died count (reference) or the halved dv (elastic, D
  channels); ch6 best mass (momentum; ``-FLT_MAX`` when there is no
  candidate); the rest 0;
- momentum parent, i32[N]: global id of the best candidate, ``INT32_MAX``
  when there is none. (The TPU kernel pads this to an [N, 8] block.)

The rows do not encode D, so every function that reads them takes ``dim``
(2 by default), as nbodyax's do. Rows of dead i bodies carry junk in the
raw output; ``decode_raw`` zeroes them.

``tile_accumulators_raw`` launches the kernel for CUDA tensors and runs
``tile_accumulators_raw_reference`` for CPU tensors. ``launches`` counts
kernel calls, one a forward call, so a run can show it went through the
kernel. The kernel splits the partners across blocks when the rows alone
would not fill the card (``choose_splits``); a call is then two CUDA
launches, the pass and the combine of its partials.

Reverse mode: ``tile_accumulators_raw`` is a ``torch.autograd.Function``
(the counterpart of the ``jax.custom_vjp`` of ``nbodyax``'s kernel). Its
backward is the analytic VJP of ``physics/kernels_bwd.py``: the backward
kernel on a CUDA tensor, its plain version on a CPU tensor. Neither forward
engine is differentiated itself: the kernel writes through ``ctypes``,
which autograd cannot see, and the plain forward's ungated ``rsqrt`` of
self pairs and its ``m_j = 0`` shortcut for dead bodies give non-finite or
non-zero derivatives where the oracle's are finite or zero.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from nbodyax_torch.physics.pairwise import PairAccumulators, squared_distance

__all__ = ["body_features", "tile_accumulators_raw",
           "tile_accumulators_raw_reference", "decode_raw",
           "pair_accumulators_kernel", "choose_splits", "forward_splits",
           "NUM_FEATS", "NUM_CH", "MODES"]

NUM_FEATS = 8
NUM_CH = 8
MODES = ("reference", "momentum", "elastic", "none")
_NEG_INF = float(np.finfo(np.float32).min)   # "no candidate" best mass
_I32_MAX = int(np.iinfo(np.int32).max)       # "no candidate" parent
MIN_SPLIT_PARTNERS = 256   # one shared-memory tile of partners (kTile)


def body_features(pos, vel, mass, radius) -> torch.Tensor:
    """Pack state into f32[N, 8] rows: pos[0:D], vel[D:2D], mass at 2D,
    radius at 2D+1, zero pad (D = pos.shape[-1], 2 or 3).

    Dead bodies get radius 0, so every contribution of a dead j body
    vanishes without alive masks: force, merge gain and impulse carry an
    ``m_j`` factor, dying needs ``m_j > m_i >= 0``, and the gained radius
    is ``r_j * growth``.
    """
    n, d = pos.shape
    _check_dim(d)
    out = torch.zeros((n, NUM_FEATS), dtype=torch.float32, device=pos.device)
    out[:, 0:d] = pos
    out[:, d:2 * d] = vel
    out[:, 2 * d] = mass
    out[:, 2 * d + 1] = torch.where(mass > 0, radius,
                                    torch.zeros_like(radius))
    return out


def _check_dim(dim: int) -> None:
    if dim not in (2, 3):
        raise ValueError(f"the pair kernel takes 2 or 3 dimensions, not {dim}")


def _float32(x: float) -> float:
    return float(np.float32(x))


def _eps2(eps: float) -> float:
    """The float32 eps, squared in float32: the forward and the backward
    square the same value."""
    eps32 = np.float32(eps)
    return float(eps32 * eps32)


def _check_inputs(feats_i, feats_j, mode, dim=2):
    _check_dim(dim)
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
                          eps: float, growth_rate: float, dim: int = 2):
    """Raw channel accumulators of i bodies against j bodies.

    ``feats_i`` f32[Ni, 8] and ``feats_j`` f32[Nj, 8] are body_features rows
    packed in ``dim`` dimensions; ``i_offset`` / ``j_offset`` are the global
    ids of their first rows. Returns ``(raw f32[Ni, 8], parent i32[Ni] or
    None)``; the parent is returned in momentum mode only.

    A CUDA tensor goes to the hand-written kernel (built at first use); a
    CPU tensor goes to ``tile_accumulators_raw_reference``. Differentiable
    with respect to both feature operands (see the module docstring).
    """
    _check_inputs(feats_i, feats_j, mode, dim)
    if feats_i.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no pair kernel for device {feats_i.device}")
    return _PairRaw.apply(feats_i, feats_j, int(i_offset), int(j_offset),
                          mode, float(eps), float(growth_rate), int(dim))


tile_accumulators_raw.launches = 0


class _PairRaw(torch.autograd.Function):
    """The forward engines with the analytic backward as their VJP. Saves
    only the inputs and the momentum parent: the backward recomputes every
    pair quantity. The backward is not itself differentiable, so a second
    derivative raises."""

    @staticmethod
    def forward(ctx, feats_i, feats_j, i_offset, j_offset, mode, eps,
                growth_rate, dim):
        kw = dict(mode=mode, eps=eps, growth_rate=growth_rate, dim=dim)
        if feats_i.device.type == "cpu":
            raw, parent = tile_accumulators_raw_reference(
                feats_i, feats_j, i_offset, j_offset, **kw)
        else:
            raw, parent = _launch(feats_i, feats_j, i_offset, j_offset, **kw)
        ctx.save_for_backward(feats_i, feats_j, parent)
        ctx.args = (i_offset, j_offset, kw)
        if parent is not None:
            ctx.mark_non_differentiable(parent)
        return raw, parent

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g_raw, _g_parent):
        from nbodyax_torch.physics.kernels_bwd import raw_backward
        feats_i, feats_j, parent = ctx.saved_tensors
        i_offset, j_offset, kw = ctx.args
        d_fi, d_fj = raw_backward(feats_i, feats_j, i_offset, j_offset,
                                  parent, g_raw, **kw)
        return d_fi, d_fj, None, None, None, None, None, None


def choose_splits(row_blocks: int, partners: int, slots: int) -> int:
    """How many blocks to split the partners of each row block across.

    ``row_blocks`` is the number of row blocks of the call (over both
    sides for the backward pass), ``partners`` the partners a row walks and
    ``slots`` the blocks the card holds at once (SMs times blocks an SM).
    The splits fill one wave of the card, each keeps at least
    ``MIN_SPLIT_PARTNERS`` partners, and rows that fill the card alone get
    one split.
    """
    if row_blocks <= 0 or partners <= 0:
        return 1
    return max(1, min(slots // row_blocks, partners // MIN_SPLIT_PARTNERS))


@functools.lru_cache(maxsize=None)
def launch_shape(kernel: str, mode: str, index: int,
                 dim: int = 2) -> tuple[int, int]:
    """``(slots, block_rows)`` of the pass kernel ``kernel`` ("forward" or
    "backward") in ``mode`` and ``dim`` dimensions on CUDA card ``index``:
    how many of its blocks the card holds at once (SMs times the occupancy
    API's blocks an SM) and how many rows a block owns."""
    from nbodyax_torch.physics._build import load_library
    lib = load_library()
    fn = {"forward": lib.nbodyax_pair_launch_shape,
          "backward": lib.nbodyax_pair_backward_launch_shape}[kernel]
    blocks, rows = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(index):
        err = fn(MODES.index(mode), dim, ctypes.byref(blocks),
                 ctypes.byref(rows))
    if err != 0 or blocks.value < 1:
        raise RuntimeError(f"{kernel} pair kernel: no launch shape for mode "
                           f"{mode} in {dim}-D (CUDA error {err}, "
                           f"{blocks.value} blocks an SM)")
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    return sms * blocks.value, rows.value


def _index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def forward_splits(ni: int, nj: int, mode: str, dev, dim: int = 2) -> int:
    """The partner splits the forward kernel uses for Ni rows against Nj
    partners in ``dim`` dimensions on CUDA device ``dev``."""
    slots, rows = launch_shape("forward", mode, _index(torch.device(dev)),
                               dim)
    return choose_splits(-(-ni // rows), nj, slots)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and 16-byte aligned, as the kernels' float4 loads need."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(feats_i, feats_j, i_offset: int, j_offset: int, *, mode: str,
            eps: float, growth_rate: float, dim: int):
    """Launch the CUDA kernel on CUDA tensors; counts the call."""
    from nbodyax_torch.physics._build import load_library
    lib = load_library()
    fi, fj = _aligned(feats_i), _aligned(feats_j)
    ni, nj = fi.shape[0], fj.shape[0]
    i_offset, j_offset = int(i_offset), int(j_offset)
    if min(i_offset, j_offset) < 0 or max(i_offset + ni,
                                          j_offset + nj) > _I32_MAX:
        raise ValueError("body ids must be non-negative and fit in int32")
    dev = fi.device
    raw = torch.empty((ni, NUM_CH), dtype=torch.float32, device=dev)
    parent = (torch.empty((ni,), dtype=torch.int32, device=dev)
              if mode == "momentum" else None)
    splits = forward_splits(ni, nj, mode, dev, dim)
    part = ppart = None
    if splits > 1:
        part = torch.empty((splits, ni, NUM_CH), dtype=torch.float32,
                           device=dev)
        if mode == "momentum":
            ppart = torch.empty((splits, ni), dtype=torch.int32, device=dev)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nbodyax_pair_accumulators(
            fi.data_ptr(), ni, fj.data_ptr(), nj, i_offset, j_offset,
            MODES.index(mode), dim, _eps2(eps), _float32(growth_rate),
            splits, ptr(part), ptr(ppart), raw.data_ptr(), ptr(parent),
            stream)
    if err != 0:
        raise RuntimeError(f"pair kernel launch failed: CUDA error {err}")
    tile_accumulators_raw.launches += 1
    return raw, parent


def tile_accumulators_raw_reference(feats_i: torch.Tensor,
                                    feats_j: torch.Tensor, i_offset: int,
                                    j_offset: int, *, mode: str, eps: float,
                                    growth_rate: float, dim: int = 2,
                                    chunk=None):
    """Plain PyTorch version of the kernel: same inputs, same raw layout,
    same per-pair rules (self pairs and pairs with dead bodies drop out
    through the overlap test and the clamped radius, as in the kernel).
    Chunked over i so the pair temporaries stay near 2^22 elements."""
    _check_inputs(feats_i, feats_j, mode, dim)
    dev = feats_i.device
    d = dim
    ni, nj = feats_i.shape[0], feats_j.shape[0]
    if chunk is None:
        chunk = max(1, min(ni, (1 << 22) // max(nj, 1)))
    eps2 = _eps2(eps)
    growth = _float32(growth_rate)
    pj, vj = feats_j[:, 0:d], feats_j[:, d:2 * d]
    mj, rj = feats_j[None, :, 2 * d], feats_j[None, :, 2 * d + 1]
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
        mi, ri = f[:, 2 * d:2 * d + 1], f[:, 2 * d + 1:2 * d + 2]
        gi = (int(i_offset) + s
              + torch.arange(c, dtype=torch.int32, device=dev))[:, None]
        dp = pj[None, :, :] - f[:, None, 0:d]
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
        for k in range(d):
            out[:, k] = (w * dp[..., k]).sum(1)
        if mode == "reference":
            hit = overlap & (gj != gi)
            heavier = mi >= mj
            merge = hit & heavier
            out[:, d] = torch.where(merge, mj, zero).sum(1)
            out[:, d + 1] = torch.where(merge, rj * growth, zero).sum(1)
            out[:, d + 2] = (hit & ~heavier).sum(1).to(torch.float32)
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
            # (v_j - v_i).dp, summed over the axes left to right
            vdotp = (vj[None, :, 0] - f[:, None, d]) * dp[..., 0]
            for k in range(1, d):
                vdotp = vdotp + (vj[None, :, k] - f[:, None, d + k]) \
                    * dp[..., k]
            approaching = overlap & (vdotp < 0)
            coef = torch.where(approaching, vdotp * mj / ((mi + mj) * d2),
                               zero)
            for k in range(d):
                out[:, d + k] = (coef * dp[..., k]).sum(1)
    return raw, parent


def decode_raw(raw, parent_raw, i_offset: int, mass_i, mode: str,
               dim: int = 2) -> PairAccumulators:
    """Unpack the raw channels into PairAccumulators, zeroing dead i rows
    (the kernel carries no alive-i masks). ``dim`` places the channels, as
    in ``nbodyax.physics.kernels.decode_raw``."""
    _check_dim(dim)
    d = dim
    n, dev = raw.shape[0], raw.device
    alive = mass_i > 0
    ids = int(i_offset) + torch.arange(n, dtype=torch.int32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    z = torch.zeros((n,), dtype=torch.float32, device=dev)
    force = torch.where(alive[:, None], raw[:, 0:d], zero)
    gm = gr = z
    died = torch.zeros((n,), dtype=torch.bool, device=dev)
    best_mass = torch.full((n,), -torch.inf, dtype=torch.float32, device=dev)
    parent = ids
    dv = torch.zeros((n, d), dtype=torch.float32, device=dev)
    if mode == "reference":
        gm = torch.where(alive, raw[:, d], zero)
        gr = torch.where(alive, raw[:, d + 1], zero)
        died = (raw[:, d + 2] > 0) & alive
    elif mode == "momentum":
        any_cand = (raw[:, 6] > _NEG_INF) & alive
        best_mass = torch.where(any_cand, raw[:, 6], best_mass)
        parent = torch.where(any_cand, parent_raw, ids)
    elif mode == "elastic":
        # the kernel sums m_j/(m_i+m_j) * vdotp/d2 * dp; the impulse's
        # factor 2 is applied here, once per i body
        dv = torch.where(alive[:, None], 2.0 * raw[:, d:2 * d], zero)
    return PairAccumulators(force=force, gained_mass=gm, gained_radius=gr,
                            died=died, best_mass=best_mass, parent=parent,
                            dv=dv)


def pair_accumulators_kernel(pos, vel, mass, radius, *, eps: float = 0.0,
                             growth_rate: float = 0.1,
                             mode: str = "reference") -> PairAccumulators:
    """All-pairs accumulators through ``tile_accumulators_raw``: the
    counterpart of ``pallas_pair_accumulators``, a drop-in for
    ``physics.pairwise.pair_accumulators`` in 2 or 3 dimensions."""
    dim = pos.shape[-1]
    feats = body_features(pos, vel, mass, radius)
    raw, par = tile_accumulators_raw(feats, feats, 0, 0, mode=mode, eps=eps,
                                     growth_rate=growth_rate, dim=dim)
    return decode_raw(raw, par, 0, mass, mode, dim=dim)
