"""Frame rendering: rasterizer, PGM writer and background frame writer.

Counterpart of ``nbodyax/render.py``, with the reference's pixel math
(``generateImage`` / ``saveImageToDisk``):

- centre pixel: C truncation of ``(p + field) / (2*field) * img``;
- pixel radius: ``r * imgW / fieldW``;
- bounding box: the reference's clamps, including the ``>= imgH`` /
  ``> imgW`` asymmetry;
- a pixel is painted 0 where ``dx^2 + dy^2 <= int(r_px^2)``, on a 254
  background.

Each live body paints a fixed PATCH x PATCH window; discs wider than that go
through two more fixed-shape tiers (the 64 largest through a 4x window,
the 8 largest over the whole image), so every disc renders complete. Every
painted pixel gets the same value 0, so painting is an index assignment
and needs no scatter-min.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Optional

import numpy as np
import torch

from nbodyax_torch.state import SimState

__all__ = ["rasterize", "render_state", "write_pgm", "FrameWriter",
           "FrameWriteError", "pgm_bytes", "BACKGROUND", "BODY"]

BACKGROUND = 254
BODY = 0


class FrameWriteError(RuntimeError):
    """Host-side frame IO failure (disk full, unwritable path)."""


def _trunc(x: torch.Tensor) -> torch.Tensor:
    """float -> int32, truncating toward zero like a C cast."""
    return x.to(torch.int32)


def rasterize(pos, mass, radius, *, img_width: int, img_height: int,
              field_width: int, field_height: int, patch: int = 32,
              mid_k: int = 64, big_k: int = 8) -> torch.Tensor:
    """Render live bodies as filled discs: uint8[img_height, img_width] on
    the device of ``pos``."""
    dev = pos.device
    n = pos.shape[0]
    fw2, fh2 = 2.0 * field_width, 2.0 * field_height
    i32 = torch.int32

    cx = _trunc((pos[:, 0] + field_width) / fw2 * img_width)
    cy = _trunc((pos[:, 1] + field_height) / fh2 * img_height)
    r_px = radius * img_width / field_width

    def where_i(cond, a: int, b):
        return torch.where(cond, torch.full_like(b, a), b)

    x_min = where_i(cx - r_px < 0, 0, _trunc(cx - r_px))
    x_max = where_i(cx + r_px > img_width, img_width, _trunc(cx + r_px))
    y_min = where_i(cy - r_px < 0, 0, _trunc(cy - r_px))
    y_max = where_i(cy + r_px >= img_height, img_height, _trunc(cy + r_px))
    r2i = _trunc(r_px * r_px)

    # one spare slot at the end takes every unpainted window pixel, so the
    # scatter needs no data-dependent shape (and no host sync)
    spare = img_width * img_height
    img = torch.full((spare + 1,), BACKGROUND, dtype=torch.uint8, device=dev)

    def scatter_discs(sel, live, win):
        """Paint the discs ``sel`` through a win x win window anchored at
        the (unclamped, truncated) bbox corner."""
        b_cx, b_cy, b_r = cx[sel], cy[sel], r_px[sel]
        ax = _trunc(b_cx - b_r)[:, None, None]
        ay = _trunc(b_cy - b_r)[:, None, None]
        off = torch.arange(win, dtype=i32, device=dev)
        px = ax + off[None, None, :]                    # [K, W, W]
        py = ay + off[None, :, None]
        dx = px - b_cx[:, None, None]
        dy = py - b_cy[:, None, None]
        inside = (dx * dx + dy * dy) <= r2i[sel][:, None, None]
        in_box = ((px >= x_min[sel][:, None, None])
                  & (px < x_max[sel][:, None, None])
                  & (py >= y_min[sel][:, None, None])
                  & (py < y_max[sel][:, None, None]))
        paint = (inside & in_box & live[:, None, None]
                 & (px >= 0) & (px < img_width)
                 & (py >= 0) & (py < img_height))
        flat = torch.where(paint, py * img_width + px,
                           torch.full_like(px, spare))
        # index_fill_ takes the value as a kernel argument: an index
        # assignment of a Python scalar copies it to the card first, which
        # a CUDA graph capture refuses
        img.index_fill_(0, flat.reshape(-1).long(), BODY)

    live = mass > 0
    scatter_discs(torch.arange(n, device=dev), live, patch)

    diam = 2.0 * r_px + 2.0
    neg = torch.full_like(r_px, -1.0)
    mid_k = min(mid_k, n)
    if mid_k > 0:
        over_mid = (diam > patch) & (diam <= 4 * patch) & live
        vals, sel = torch.topk(torch.where(over_mid, r_px, neg), mid_k)
        scatter_discs(sel, vals > 0, 4 * patch)

    img = img[:spare].reshape(img_height, img_width)

    big_k = min(big_k, n)
    if big_k > 0:
        oversized = (diam > 4 * patch) & live
        vals, sel = torch.topk(torch.where(oversized, r_px, neg), big_k)
        ys = torch.arange(img_height, dtype=i32, device=dev)[None, :, None]
        xs = torch.arange(img_width, dtype=i32, device=dev)[None, None, :]

        def per_big(t):
            return t[sel][:, None, None]

        inside = ((xs - per_big(cx)) ** 2 + (ys - per_big(cy)) ** 2
                  <= per_big(r2i))
        box = ((xs >= per_big(x_min)) & (xs < per_big(x_max))
               & (ys >= per_big(y_min)) & (ys < per_big(y_max)))
        big_mask = (inside & box & (vals > 0)[:, None, None]).any(0)
        img = torch.where(big_mask, torch.full_like(img, BODY), img)
    return img


def render_state(state: SimState, cfg) -> torch.Tensor:
    return rasterize(state.pos, state.mass, state.radius,
                     img_width=cfg.img_width, img_height=cfg.img_height,
                     field_width=cfg.field_width,
                     field_height=cfg.field_height, patch=cfg.render_patch)


def pgm_bytes(img: np.ndarray) -> bytes:
    """Binary P5 encoding with the reference's header:
    ``P5\\n{W} {H}\\n255\\n`` + raw bytes."""
    h, w = img.shape
    return b"P5\n%d %d\n255\n" % (w, h) + np.ascontiguousarray(
        img, dtype=np.uint8).tobytes()


def write_pgm(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(pgm_bytes(img))


class FrameWriter:
    """Asynchronous frame writer.

    ``submit`` queues a rendered frame (a tensor on any device); a daemon
    thread copies it to the host and writes ``{image_path}/iteration_{i}.ppm``
    (the reference's file name; the content is P5 grayscale). Rendering thus
    overlaps the next steps. A frame already copied to host memory by a
    non-blocking copy comes with the CUDA event that the copy recorded; the
    thread waits for it before reading. ``drain`` waits until every queued
    frame is written. Errors surface on the next ``submit``, ``drain`` or on
    ``close``.
    """

    def __init__(self, image_path: str, max_pending: int = 4):
        self.image_path = image_path
        os.makedirs(image_path, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                iteration, img, ready = item
                if ready is not None:
                    ready.synchronize()
                write_pgm(os.path.join(self.image_path,
                                       f"iteration_{iteration}.ppm"),
                          img.cpu().numpy())
            except Exception as e:  # surfaced on submit() / close()
                self._err = e
            finally:
                self._q.task_done()

    def _raise(self) -> None:
        if self._err is not None:
            raise FrameWriteError("frame writer failed") from self._err

    def submit(self, iteration: int, img: torch.Tensor, ready=None) -> None:
        self._raise()
        self._q.put((iteration, img, ready))

    def drain(self) -> None:
        self._q.join()
        self._raise()

    def close(self) -> None:
        self._q.put(None)
        self._thread.join()
        self._raise()
