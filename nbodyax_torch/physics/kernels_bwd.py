"""Analytic backward pass (VJP) of the fused all-pairs kernel.

Counterpart of ``nbodyax/physics/kernels_bwd.py``. The TPU kernel there
(``_bwd_kernel``) becomes the hand-written CUDA kernel in
``nbodyax_torch/csrc/pair_bwd_kernel.cu``; ``physics/kernels.py`` pairs it
with the forward kernel in a ``torch.autograd.Function``.

Gradient semantics are those of autograd through the torch oracle
(``physics/pairwise.py``), which is what the JAX package pins its own
backward kernel to:

- overlap tests, merge winners, death marks and boundary flips are events:
  their masks are constants, and gradients flow only through the selected
  branch;
- every pair is gated on ``m_j > 0`` and not-self by global id, even where
  the forward relies on ``m_j = 0`` to zero the value: a zero value still
  has a nonzero derivative with respect to ``m_j``;
- the force gate is the forward's: overlapping pairs are left out except in
  elastic mode, and ``d2 + eps2 > 0``.

Per pair, with u = p_j - p_i, d2e = |u|^2 + eps2, s = d2e^{-3/2}, the force
cotangent g of body i and the gate c:

  dL/dp_i += c m_j (3 s (g.u)/d2e u - s g)       dL/dp_j = -(that)
  dL/dm_j += c s (g.u)

and for the elastic impulse sum_j a m_j q u, q = vdotp / ((m_i + m_j) d2),
vdotp = (v_j - v_i).u, gate a (overlapping and approaching), cotangent h:

  dL/dv_j += a m_j (h.u) / ((m_i + m_j) d2) u                (v_i: negated)
  dL/dp_j += a m_j [(h.u) (dv - 2 vdotp u / d2) / ((m_i + m_j) d2) + q h]
                                                             (p_i: negated)
  dL/dm_j += a (h.u) q m_i / (m_i + m_j)
  dL/dm_i -= a (h.u) q m_j / (m_i + m_j)

In reference mode the gained mass and radius of body i flow to the j body
of each merge: dL/dm_j += g_gm_i, dL/dr_j += growth g_gr_i. The died count
and the momentum parent carry no gradient. The momentum best-mass
cotangent goes to the mass of the saved parent, outside the kernel.

Every sum over the axes runs over D = 2 or 3 (``dim``), in the layouts of
``physics/kernels.py``: the cotangent's force channels are 0..D-1, gained
mass and radius D and D+1, dv D..2D-1, and best mass 6; the feature
gradients are pos[0:D], vel[D:2D], mass at 2D, radius at 2D+1.

``raw_backward`` runs the kernel for CUDA tensors, both sides (the i
bodies as output rows, and the j bodies) in one grid, and
``raw_backward_reference`` for CPU tensors. ``raw_backward.launches``
counts one a side computed, two a call. A side whose rows alone would not
fill the card splits its partners across blocks (``backward_splits``); the
call is then two CUDA launches, the pass and the combine of the partials.
"""

from __future__ import annotations

import torch

from nbodyax_torch.physics.kernels import (_I32_MAX, MODES, _aligned,
                                           _check_inputs, _eps2, _float32,
                                           _index, choose_splits,
                                           launch_shape)

__all__ = ["raw_backward", "raw_backward_reference", "backward_splits"]


def _check(feats_i, feats_j, g_raw, mode, dim):
    _check_inputs(feats_i, feats_j, mode, dim)
    if (g_raw.dtype != torch.float32 or g_raw.shape != feats_i.shape
            or g_raw.device != feats_i.device):
        raise ValueError(f"g_raw must be f32{tuple(feats_i.shape)} on "
                         f"{feats_i.device}, got {g_raw.dtype} "
                         f"{tuple(g_raw.shape)} on {g_raw.device}")


def _route_best_mass(d_fj, parent, g_raw, j_offset: int, dim: int) -> None:
    """Momentum mode: d best_mass_i / d m_parent(i) = 1. Adds the best-mass
    cotangent (channel 6 in either dimension) onto the parent's mass
    feature (column 2 * dim), in place; parents that are
    ``INT32_MAX`` (no candidate) or outside this j range are dropped, by
    sending them to a spare slot past the end (no host sync). ``index_put_``
    with ``accumulate`` sums by sorted index on the card, so the result
    repeats bit for bit."""
    nj = d_fj.shape[0]
    tgt = parent.long() - int(j_offset)
    keep = (parent != _I32_MAX) & (tgt >= 0) & (tgt < nj)
    tgt = torch.where(keep, tgt, torch.full_like(tgt, nj))
    dm = torch.zeros((nj + 1,), dtype=torch.float32, device=d_fj.device)
    dm.index_put_((tgt,), g_raw[:, 6], accumulate=True)
    d_fj[:, 2 * dim] += dm[:nj]


def raw_backward_reference(feats_i: torch.Tensor, feats_j: torch.Tensor,
                           i_offset: int, j_offset: int, parent, g_raw, *,
                           mode: str, eps: float, growth_rate: float,
                           dim: int = 2, chunk=None):
    """Plain PyTorch version of the backward kernel: the per-pair formulas
    of the module docstring as explicit tensor expressions (no autograd),
    chunked over i so the pair temporaries stay near 2^22 elements. Each
    i chunk's pair block feeds both sides: its rows sum into ``d_feats_i``,
    its columns into ``d_feats_j``. Returns ``(d_feats_i f32[Ni, 8],
    d_feats_j f32[Nj, 8])``."""
    _check(feats_i, feats_j, g_raw, mode, dim)
    d = dim
    dev = feats_i.device
    ni, nj = feats_i.shape[0], feats_j.shape[0]
    if chunk is None:
        chunk = max(1, min(ni, (1 << 22) // max(nj, 1)))
    eps2 = _eps2(eps)
    growth = _float32(growth_rate)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    one = torch.ones((), dtype=torch.float32, device=dev)
    pj, vj = feats_j[:, 0:d], feats_j[:, d:2 * d]
    mj, rj = feats_j[None, :, 2 * d], feats_j[None, :, 2 * d + 1]
    gj = (int(j_offset)
          + torch.arange(nj, dtype=torch.int32, device=dev))[None, :]
    aj = mj > 0
    d_fi = torch.zeros_like(feats_i)
    d_fj = torch.zeros_like(feats_j)
    for s in range(0, ni, chunk):
        f, g = feats_i[s:s + chunk], g_raw[s:s + chunk]
        c_rows = f.shape[0]
        mi, ri = f[:, 2 * d:2 * d + 1], f[:, 2 * d + 1:2 * d + 2]
        gi = (int(i_offset) + s
              + torch.arange(c_rows, dtype=torch.int32, device=dev))[:, None]
        u = [pj[None, :, k] - f[:, None, k] for k in range(d)]  # p_j - p_i
        d2 = _dot(u, u)
        rsum = ri + rj
        overlap = d2 <= rsum * rsum
        d2e = d2 + eps2
        live = aj & (gi != gj)
        if mode == "elastic":
            c = live & (d2e > 0)
        else:
            c = live & ~overlap & (d2e > 0)
        inv = torch.rsqrt(torch.where(c, d2e, one))
        sc = inv * inv * inv
        gf = [g[:, k:k + 1] for k in range(d)]
        gdotu = _dot(gf, u)
        t = 3.0 * (inv * inv) * sc * gdotu
        out_i, out_j = d_fi[s:s + c_rows], d_fj
        for k in range(d):
            # side i: c m_j (t u - s g); side j is its negation
            pk = torch.where(c, mj * (t * u[k] - sc * gf[k]), zero)
            out_i[:, k] += pk.sum(1)
            out_j[:, k] -= pk.sum(0)
        m_col = 2 * d                                   # the mass feature
        out_j[:, m_col] += torch.where(c, sc * gdotu, zero).sum(0)
        if mode == "reference":
            merge = overlap & live & (mi >= mj)
            out_j[:, m_col] += torch.where(merge, g[:, d:d + 1],
                                           zero).sum(0)
            out_j[:, m_col + 1] += torch.where(
                merge, growth * g[:, d + 1:d + 2], zero).sum(0)
        elif mode == "elastic":
            rv = [vj[None, :, k] - f[:, None, d + k]      # v_j - v_i
                  for k in range(d)]
            vdotp = _dot(rv, u)
            a = overlap & live & (vdotp < 0) & (d2 > 0)
            invd2 = 1.0 / torch.where(a, d2, one)
            minv = 1.0 / torch.where(a, mi + mj, one)
            recip = minv * invd2
            q = vdotp * recip
            h = [g[:, d + k:d + k + 1] for k in range(d)]
            hdotu = _dot(h, u)
            gr = hdotu * recip
            for k in range(d):
                ek = torch.where(a, mj * (gr * (rv[k] - (2.0 * vdotp) * u[k]
                                                * invd2) + q * h[k]), zero)
                wk = torch.where(a, mj * gr * u[k], zero)
                out_i[:, k] -= ek.sum(1)
                out_i[:, d + k] -= wk.sum(1)
                out_j[:, k] += ek.sum(0)
                out_j[:, d + k] += wk.sum(0)
            hq = torch.where(a, hdotu * q * minv, zero)
            out_i[:, m_col] -= (hq * mj).sum(1)
            out_j[:, m_col] += (hq * mi).sum(0)
    if mode == "momentum" and parent is not None:
        _route_best_mass(d_fj, parent, g_raw, j_offset, d)
    return d_fi, d_fj


def _dot(a, b):
    """sum_k a[k] * b[k], each product rounded, summed left to right (the
    kernel's and the oracle's order over the axes)."""
    out = a[0] * b[0]
    for x, y in zip(a[1:], b[1:]):
        out = out + x * y
    return out


def raw_backward(feats_i: torch.Tensor, feats_j: torch.Tensor, i_offset: int,
                 j_offset: int, parent, g_raw: torch.Tensor, *, mode: str,
                 eps: float, growth_rate: float, dim: int = 2):
    """Full VJP of ``tile_accumulators_raw`` with respect to both feature
    operands, in the port's row layout of ``dim`` dimensions.

    ``g_raw`` f32[Ni, 8] is the cotangent of the raw channels; ``parent``
    the forward's momentum-mode i32[Ni] (None otherwise). Returns
    ``(d_feats_i f32[Ni, 8], d_feats_j f32[Nj, 8])``.

    A CUDA tensor goes to the hand-written kernel, both sides in one grid;
    a CPU tensor goes to ``raw_backward_reference``.
    """
    _check(feats_i, feats_j, g_raw, mode, dim)
    if feats_i.device.type == "cpu":
        return raw_backward_reference(
            feats_i, feats_j, i_offset, j_offset, parent, g_raw, mode=mode,
            eps=eps, growth_rate=growth_rate, dim=dim)
    if feats_i.device.type != "cuda":
        raise ValueError(f"no backward kernel for device {feats_i.device}")
    from nbodyax_torch.physics._build import load_library
    lib = load_library()
    fi, fj, g = _aligned(feats_i), _aligned(feats_j), _aligned(g_raw)
    ni, nj = fi.shape[0], fj.shape[0]
    i_offset, j_offset = int(i_offset), int(j_offset)
    if min(i_offset, j_offset) < 0 or max(i_offset + ni,
                                          j_offset + nj) > _I32_MAX:
        raise ValueError("body ids must be non-negative and fit in int32")
    dev = fi.device
    d_fi = torch.empty_like(fi)
    d_fj = torch.empty_like(fj)
    s_i, s_j = backward_splits(ni, nj, mode, dev, dim)
    part_i = (torch.empty((s_i, ni, 8), dtype=torch.float32, device=dev)
              if s_i > 1 else None)
    part_j = (torch.empty((s_j, nj, 8), dtype=torch.float32, device=dev)
              if s_j > 1 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.nbodyax_pair_backward(
            fi.data_ptr(), ni, fj.data_ptr(), nj, i_offset, j_offset,
            g.data_ptr(), MODES.index(mode), dim, _eps2(eps),
            _float32(growth_rate), s_i, s_j,
            part_i.data_ptr() if part_i is not None else None,
            part_j.data_ptr() if part_j is not None else None,
            d_fi.data_ptr(), d_fj.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"pair backward kernel launch failed: CUDA error "
                           f"{err}")
    raw_backward.launches += 2
    if mode == "momentum" and parent is not None:
        _route_best_mass(d_fj, parent, g, j_offset, dim)
    return d_fi, d_fj


raw_backward.launches = 0


def backward_splits(ni: int, nj: int, mode: str, dev,
                    dim: int = 2) -> tuple[int, int]:
    """The partner splits ``(side i, side j)`` the backward kernel uses for
    Ni i bodies against Nj j bodies in ``dim`` dimensions on CUDA device
    ``dev``: both sides' row blocks share the card."""
    slots, rows = launch_shape("backward", mode, _index(torch.device(dev)),
                               dim)
    blocks = -(-ni // rows) + -(-nj // rows)
    return (choose_splits(blocks, nj, slots),
            choose_splits(blocks, ni, slots))
