"""Delta presentation: transfer only CHANGED tiles of each frame to the host.

The reference presents with plain `Present(1, 0)` (main.cpp:337), but its flip-
model swapchain family exists precisely to let the present path skip unchanged
content (DXGI `Present1` dirty rects).  Here the present cost is the
device->host readback — 6 MB/frame at 1080p — so the analog packs the
frame into fixed-shape tiles ON DEVICE, compacts the tiles that differ from the
previous presented frame to the front of a static buffer (the same fixed-
capacity + compaction philosophy as the rasterizer's binning), and the host
reads only a power-of-two-rounded prefix, reconstructing the frame from its own
copy of the previous one.  Static pixels (backgrounds, settled geometry) never
cross the link again.

Exactness: reconstruction is bit-identical to a full readback — a tile is
transferred iff ANY byte differs, so the host mirror never drifts.  The
power-of-two rounding bounds the per-frame program count (one sliced readback
program per bucket, compiled once each) while transferring at most 2x the
changed bytes.

Round 5 adds a PIXEL-level wire encoding on top (default ON): within the
dirty-tile prefix, only ~13% of pixels actually change per frame on the
rotating benchmark scene (tools/delta_probe.py, 2026-08-21), so the buffer
ships per-tile dirty-pixel bitmaps + just the changed pixels' bytes —
measured ~5.8x fewer wire bytes (1.16 -> 0.20 MB/frame) on the link that
bounds delivered FPS.  Both caps (dirty tiles, changed pixels) are
speculative with loud miss handling; reconstruction stays bit-identical
because unchanged pixels inside dirty tiles equal the host mirror's bytes by
the mirror invariant.
"""
from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def _bucket(x: int) -> int:
    """Smallest quarter-pow2 step >= x (… 8, 10, 12, 14, 16, 20, 24, 28, 32 …):
    bounds the compiled pack-program count to ~4 per octave while capping the
    speculative-prefix overshoot at 25% (plain pow2 overshoots up to 100%)."""
    if x <= 8:
        return max(1, x)
    p = 1 << (x.bit_length() - 1)  # pow2 floor
    q = p // 4
    return p + q * (-(-(x - p) // q))


def _pick_tile(size: int, preferred: int) -> int:
    """Largest divisor of `size` that is <= preferred (>= 1)."""
    t = min(preferred, size)
    while size % t:
        t -= 1
    return t


def _tile_layout(frame: jnp.ndarray, th: int, tw: int) -> jnp.ndarray:
    """[H, W, C] -> [NT, tile_bytes] tile layout (one u8 relayout).  The
    queue CACHES the previous frame's result so each push relayouts only the
    new frame (the old pack re-tiled both every frame)."""
    H, W, C = frame.shape
    TH, TW = H // th, W // tw
    return (
        frame.reshape(TH, th, TW, tw, C)
        .transpose(0, 2, 1, 3, 4)
        .reshape(TH * TW, th * tw * C)
    )


def _dirty_tiles(t_prev: jnp.ndarray, t_new: jnp.ndarray):
    """(count, order): dirty tile indices first, ascending (stable argsort),
    clean tiles after."""
    changed = jnp.any(t_new != t_prev, axis=1)
    count = changed.sum(dtype=jnp.int32)
    order = jnp.argsort(~changed, stable=True).astype(jnp.int32)
    return count, order


@partial(jax.jit, static_argnums=(2, 3))
def _pack_stable(t_prev, frame, th: int, tw: int):
    """Shape-stable raw-mode pack prologue (ONE dispatch): tile relayout +
    dirty-tile compaction order."""
    t_new = _tile_layout(frame, th, tw)
    count, order = _dirty_tiles(t_prev, t_new)
    return t_new, count, order


@partial(jax.jit, static_argnums=(2, 3, 4))
def _pack_stable_px(t_prev, frame, th: int, tw: int, channels: int):
    """Shape-STABLE half of the pixel-level pack (the round-5 wire encoding),
    fused into ONE dispatch: tile relayout, dirty-tile order, per-pixel
    change masks -> bitmaps, per-tile changed-pixel counts, and the compacted
    changed-pixel order — all over the UNORDERED tile array.

    Shape stability is the point: the compaction argsort compiles once per
    input size, and sizing it by the speculative cap recompiled the sort for
    every cap bucket.  Computing the
    compaction at the full [NT * P] size makes this program compile ONCE per
    frame geometry (persistent-cached across processes); the per-bucket
    transfer program below only slices and gathers (sub-second compiles).

    Unordered is safe because dirty RANK order equals ascending tile-id order
    (_dirty_tiles' stable argsort), so ascending flat (tile, px) indices over
    changed pixels are exactly the (rank, px) sequence the host expects."""
    t_new = _tile_layout(frame, th, tw)
    count, order = _dirty_tiles(t_prev, t_new)
    NT, B = t_new.shape
    C = channels
    P = B // C
    Pp = -(-P // 8) * 8
    m = jnp.any(
        t_new.reshape(NT, P, C) != t_prev.reshape(NT, P, C), axis=2
    )  # [NT, P]
    mp = jnp.pad(m, ((0, 0), (0, Pp - P)))
    bitmap = jnp.sum(
        mp.reshape(NT, Pp // 8, 8).astype(jnp.uint8)
        << jnp.arange(8, dtype=jnp.uint8),
        axis=-1,
        dtype=jnp.uint8,
    )
    flat = m.reshape(-1)
    iota = jnp.arange(NT * P, dtype=jnp.int32)
    key = jnp.where(flat, iota, NT * P)
    ordpx = jnp.argsort(key)  # ascending changed flat indices first
    tile_counts = m.sum(axis=1, dtype=jnp.int32)  # [NT], unordered
    return t_new, count, order, (bitmap, ordpx, tile_counts)


@partial(jax.jit, static_argnums=(4, 5, 6))
def _pack_transfer_px(
    count, order, t_new, fields, channels: int, cap: int, px_cap: int
) -> jnp.ndarray:
    """Pixel-level single-transfer buffer:

      [4B count][4B npx][cap*4B dirty order][cap*ceil(P/8)B pixel bitmaps]
      [px_cap*C B changed pixels]

    Measured on the rotating benchmark scene (tools/delta_probe.py,
    2026-08-21): only ~13% of the pixels inside dirty 8x64 tiles actually
    change per frame, so masking unchanged pixels cuts the wire bytes ~5.8x
    vs raw dirty tiles (1.16 -> 0.20 MB/frame) — the delta-present link was
    bandwidth-bound on exactly those bytes (BENCH.md).  The bitmap is
    little-bit-order (np.unpackbits(bitorder='little')); changed pixels ride
    in ascending flat (dirty-tile-rank, pixel) order, so the host
    reconstructs positions from the bitmaps alone.  Reconstruction stays
    bit-identical: unchanged pixels inside dirty tiles equal the host
    mirror's bytes by the mirror invariant."""
    bitmap, ordpx, tile_counts = fields
    NT, B = t_new.shape
    C = channels
    P = B // C
    ranked = order[:cap]
    npx = jnp.sum(tile_counts[ranked])  # changed px within the first cap ranks
    px = t_new.reshape(NT * P, C)[ordpx[:px_cap]]
    hdr = jax.lax.bitcast_convert_type(
        jnp.stack([count, npx]), jnp.uint8
    ).reshape(-1)
    idx = jax.lax.bitcast_convert_type(ranked, jnp.uint8).reshape(-1)
    return jnp.concatenate(
        [hdr, idx, bitmap[ranked].reshape(-1), px.reshape(-1)]
    )


@partial(jax.jit, static_argnums=(3,))
def _pack_transfer(count, order, t_new, cap: int) -> jnp.ndarray:
    """ONE device buffer holding everything a raw-tile present needs:
    [4B count][cap*4B dirty-order prefix][cap*tile_bytes pixel prefix].

    The host then presents with a SINGLE device->host transfer instead of
    three (count readback -> order -> pixel prefix): each readback pays a
    full device->host round trip.
    `cap` is speculative (chosen from previously observed dirty counts); a
    frame dirtier than the cap takes a second transfer for the remainder."""
    hdr = jax.lax.bitcast_convert_type(
        count.reshape(1), jnp.uint8
    ).reshape(-1)
    ranked = order[:cap]
    idx = jax.lax.bitcast_convert_type(ranked, jnp.uint8).reshape(-1)
    return jnp.concatenate([hdr, idx, t_new[ranked].reshape(-1)])


@partial(jax.jit, static_argnums=(2,))
def _gather_rows(t_new, order, k: int) -> jnp.ndarray:
    """Rank-ordered tile rows [0, k) — the speculation-miss re-transfer."""
    return t_new[order[:k]]


class DeltaPresentQueue:
    """Bounded queue of in-flight frames presented via dirty-tile deltas.

    Same contract as `PresentQueue` (push returns the oldest presented frame
    once `depth` frames are in flight; present_next/drain download in order)
    but each download moves only the power-of-two-rounded prefix of changed
    tiles.  `bytes_transferred` / `bytes_full` expose the savings."""

    def __init__(
        self, height: int, width: int, depth: int = 3,
        tile_h: int = 8, tile_w: int = 64, channels: int = 3,
        pixel_level: bool = True, threaded: bool = True,
    ):
        if depth < 1:
            raise ValueError("depth must be >= 1")
        # ONE worker so presents stay FIFO (the host mirror chains).
        self._pool = ThreadPoolExecutor(max_workers=1) if threaded else None
        self.depth = depth
        self.th = _pick_tile(height, tile_h)
        self.tw = _pick_tile(width, tile_w)
        self.H, self.W, self.C = height, width, channels
        self.TH, self.TW = height // self.th, width // self.tw
        self.NT = self.TH * self.TW
        self.tile_bytes = self.th * self.tw * channels
        self.tile_px = self.th * self.tw
        self._bmp_bytes = -(-self.tile_px // 8)  # per-tile bitmap bytes
        # Pixel-level wire encoding (see _pack_transfer_px): ships per-pixel
        # dirty bitmaps + only changed pixels' bytes for the dirty prefix —
        # measured ~5.8x fewer wire bytes on the rotating benchmark scene.
        self.pixel_level = pixel_level
        self._queue: deque = deque()
        # prev frame's TILE LAYOUT on device feeds the next pack (cached so
        # each push relayouts only the new frame); the host mirror
        # reconstructs.
        self._prev_tiles = jnp.zeros((self.NT, self.tile_bytes), jnp.uint8)
        self._host = np.zeros((self.NT, self.tile_bytes), np.uint8)
        self.frames_presented = 0
        self.bytes_transferred = 0
        self.bytes_full = 0
        # Speculative single-transfer tile cap: starts at NT (the first
        # present moves every tile anyway), then tracks observed dirty counts
        # with 1.5x headroom.  A frame dirtier than the cap costs one extra
        # transfer (counted in transfer_misses), never a wrong frame.
        self._spec = self.NT
        # Speculative changed-pixel cap for the pixel-level buffer, tracked
        # from observed counts exactly like the tile cap.
        self._spec_px = self.NT * self.tile_px
        self.transfer_misses = 0
        # Cap hysteresis: every distinct (cap, px_cap) pair is its own
        # compiled pack program, and counts that wobble across a bucket
        # boundary caused 120-360 ms program-switch stalls between otherwise
        # ~33 ms frames (measured 2026-08-21 on the rotating benchmark).
        # Caps GROW immediately (correctness headroom) but only SHRINK after
        # the smaller bucket has sufficed for _SHRINK_RUN consecutive
        # presents.
        self._low = 0
        self._low_px = 0
        # Whether a px present has observed a real changed-pixel count yet
        # (gates the one-time quarter-density seeding vs slow-decay retry).
        self._px_informed = False

    _SHRINK_RUN = 16

    def _sticky(self, cur: int, want: int, low: int, limit: int):
        """(new_cap, new_low): grow now, shrink only after a sustained run of
        observations at <= half the current bucket: counts wobble across
        adjacent quarter-pow2 boundaries, and every bucket flip is a switch
        of compiled program, so rare 2x shrinks keep the program set put."""
        if want > cur:
            return min(want, limit), 0
        if want * 2 <= cur:
            low += 1
            if low >= self._SHRINK_RUN:
                return want, 0
            return cur, low
        return cur, 0

    def _px_mode(self, cap: int, px_cap: int) -> bool:
        """Use the pixel-level buffer iff its (static) size undercuts the raw
        dirty-tile buffer AND the observed changed-pixel estimate fits the
        quarter-density payload — falls back to raw on full-dirty first
        frames, bitmap-dominated tiny caps, and dense-change scenes (where
        every px frame would pay a miss re-transfer)."""
        if not self.pixel_level or cap == 0:
            return False
        raw = cap * self.tile_bytes
        px = cap * self._bmp_bytes + px_cap * self.C + 4
        return px < raw and self._spec_px <= px_cap

    def push(self, device_frame) -> Optional[np.ndarray]:
        """Submit a rendered device frame; returns the OLDEST frame (as a host
        uint8 [H, W, 3] array) when the queue is full, else None."""
        # Build the single-transfer buffer NOW (speculative caps) and start
        # its device->host copy asynchronously: by the time this frame is
        # presented (depth frames later) the bytes have crossed the link
        # UNDER the following frames' renders instead of serializing after
        # them.
        cap = self._spec
        # The pixel payload is sized at QUARTER pixel density — a STATIC
        # function of the tile cap, so each tile bucket owns exactly one
        # compiled pack program (sizing it from the observed pixel count
        # doubled the program set and the bucket-switch stalls ate the
        # protocol's win; the rotating benchmark measures ~13% density, so
        # 25% padding still cuts wire bytes ~3.4x vs raw tiles).  The
        # observed-count estimate (_spec_px) only gates the MODE below.
        px_cap = max(1, cap * self.tile_px // 4)
        if self._px_mode(cap, px_cap):
            t_new, count, order, fields = _pack_stable_px(
                self._prev_tiles, device_frame, self.th, self.tw, self.C
            )
            buf = _pack_transfer_px(
                count, order, t_new, fields, self.C, cap, px_cap
            )
            mode = "px"
        else:
            t_new, count, order = _pack_stable(
                self._prev_tiles, device_frame, self.th, self.tw
            )
            buf = _pack_transfer(count, order, t_new, cap)
            mode = "raw"
            px_cap = 0
        self._prev_tiles = t_new
        try:
            buf.copy_to_host_async()
        except AttributeError:  # non-jax arrays in tests / CPU fallbacks
            pass
        job = (mode, cap, px_cap, buf, count, order, t_new)
        if self._pool is not None:
            # Threaded present: the transfer wait + host decode run on the
            # worker (FIFO, so the host mirror chain stays ordered) and
            # OVERLAP the next frames' dispatches — the synchronous
            # np.asarray wait on the loop thread was ~half the rotating
            # frame time.  Counters/caps still update at consumption time
            # (sync-identical accounting).
            self._queue.append(self._pool.submit(self._present_job, job))
        else:
            self._queue.append(job)
        if len(self._queue) > self.depth:
            return self.present_next()
        return None

    def present_next(self) -> Optional[np.ndarray]:
        if not self._queue:
            return None
        item = self._queue.popleft()
        res = item.result() if self._pool is not None else self._present_job(item)
        return self._consume(res)

    def _present_job(self, job):
        """Transfer + decode ONE present into the host mirror; returns the
        reconstructed frame and the observations the consumer applies to the
        counters/speculative caps.  Mutates only self._host (jobs run FIFO)."""
        mode, cap, px_cap, dbuf, count, order, t_new = job
        # ONE device->host transfer per present (count + dirty order prefix +
        # dirty payload packed device-side at push, copy already in flight —
        # _pack_transfer/_pack_transfer_px docstrings).  The old three
        # serialized readbacks paid three link round trips AFTER the render.
        buf = np.asarray(dbuf)
        nbytes = buf.nbytes
        misses = 0
        c = int(buf[:4].view(np.int32)[0])
        take = min(c, cap)
        npx = None  # observed changed-pixel count (px mode only)
        if mode == "px":
            npx = int(buf[4:8].view(np.int32)[0])
            off = 8
            idx = buf[off : off + 4 * cap].view(np.int32)[:take]
            off += 4 * cap
            bmp = buf[off : off + cap * self._bmp_bytes].reshape(
                cap, self._bmp_bytes
            )[:take]
            off += cap * self._bmp_bytes
            px = buf[off:].reshape(px_cap, self.C)
            if take:
                bits = np.unpackbits(bmp, axis=1, bitorder="little")[
                    :, : self.tile_px
                ]
                pos = np.flatnonzero(bits)  # ascending == device pixel order
                tiles_buf = self._host[idx]  # prev content, by the invariant
                flat_px = tiles_buf.reshape(take * self.tile_px, self.C)
                nv = min(npx, px_cap)
                flat_px[pos[:nv]] = px[:nv]
                if npx > px_cap:
                    # Pixel-speculation miss: the missing pixels are the TAIL
                    # of the ascending flat order, i.e. they live in the last
                    # rows of the dirty prefix — re-transfer those tiles raw.
                    misses += 1
                    first_bad = int(pos[px_cap]) // self.tile_px
                    k = 1 << max(take - 1, 1).bit_length()
                    rest = np.asarray(_gather_rows(t_new, order, k))[
                        first_bad:take
                    ]
                    tiles_buf[first_bad:take] = rest
                    nbytes += k * self.tile_bytes
                self._host[idx] = tiles_buf
        elif take:
            idx = buf[4 : 4 + 4 * cap].view(np.int32)[:take]
            tiles = buf[4 + 4 * cap :].reshape(cap, self.tile_bytes)[:take]
            self._host[idx] = tiles
        if c > cap:
            # Tile-speculation miss: one extra transfer for the remainder.
            misses += 1
            k = 1 << (c - 1).bit_length()
            idx_rest = np.asarray(order)[cap:c]
            rest = np.asarray(_gather_rows(t_new, order, k))[cap:c]
            self._host[idx_rest] = rest
            nbytes += k * self.tile_bytes + self.NT * 4
            npx = None  # pixel count unseen past the cap: don't decay _spec_px
        # Snapshot into a fresh buffer (ONE copy; later jobs keep mutating
        # the mirror, and for degenerate tile grids the transpose+reshape
        # would be a view of it).
        frame = np.empty((self.H, self.W, self.C), np.uint8)
        frame.reshape(self.TH, self.th, self.TW, self.tw, self.C)[...] = (
            self._host.reshape(self.TH, self.TW, self.th, self.tw, self.C)
            .transpose(0, 2, 1, 3, 4)
        )
        return frame, nbytes, misses, c, npx

    def _consume(self, res) -> np.ndarray:
        """Apply one present's observations: byte/miss counters and the
        speculative-cap tracking.  Runs on the caller thread at consumption
        time, so accounting and cap evolution are identical to the
        synchronous path."""
        frame, nbytes, misses, c, npx = res
        self.bytes_transferred += nbytes
        self.transfer_misses += misses
        # Track observed dirty counts with 15% headroom on quarter-pow2
        # buckets (pow2 buckets overshoot up to 2x — at ~1.5 KB/tile the
        # overshoot bytes cost more than the round trips they were meant to
        # save); decay to 0 on a clean frame so settled scenes move only the
        # 4-byte count again (the first change after a settle pays one miss
        # — the right trade: misses cost one extra transfer, static frames
        # are forever).
        if c == 0:
            self._spec = 0
            self._low = 0
        else:
            want = min(self.NT, _bucket(int(c * 1.15) + 1))
            self._spec, self._low = self._sticky(
                self._spec, want, self._low, self.NT
            )
        if npx is not None:
            self._px_informed = True
            want_px = min(
                self.NT * self.tile_px, _bucket(int(npx * 1.15) + 1)
            )
            self._spec_px, self._low_px = self._sticky(
                self._spec_px, want_px, self._low_px, self.NT * self.tile_px
            )
        elif c > 0:
            # Raw presents (and tile-miss px presents) don't observe the true
            # pixel count.  The FIRST time, seed the estimate at the
            # quarter-density payload size so px mode can engage on the next
            # push; once informed (a px present observed a real count), only
            # DECAY the estimate slowly toward the seed — a dense-change
            # scene whose observed count disabled px mode re-tries it every
            # ~20 frames instead of thrashing into a miss every frame.
            seed = max(1, self._spec * self.tile_px // 4)
            if not self._px_informed:
                self._spec_px = seed
            else:
                self._spec_px = max(seed, int(self._spec_px * 0.95))
        self.bytes_full += self.NT * self.tile_bytes
        self.frames_presented += 1
        return frame

    def drain(self):
        while self._queue:
            yield self.present_next()

    @property
    def in_flight(self) -> int:
        return len(self._queue)
