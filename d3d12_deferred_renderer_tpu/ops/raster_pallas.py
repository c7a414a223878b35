"""Tile-binned rasterizer: XLA binning + one Pallas-Triton program per tile.

Replaces the D3D12 hardware rasterizer + ROPs with a software design in the
spirit of binned CUDA rasterizers (CuRast, PAPERS.md):

1. **Binning (XLA)**: one record sort by (footprint tier, submission index)
   compacts live triangles into per-tier prefixes (dead records — backface
   culled, offscreen, unused near-clip slots — sort past every tier); each
   tier's budget-sized slice expands its tile rect into (tile, triangle) sort
   keys (small/medium/large rects + full-grid big, thresholds area-scaled),
   packed into one int32 key and sorted — key order is (tile, submission)
   order, D3D's depth-LESS "first-equal wins" requirement.  The sorted pair
   prefix IS the output: one row gather builds a compacted RECORD STREAM whose
   per-tile segments sit back-to-back.  Small scenes use the O(tiles*T)
   overlap-matrix + top_k path, which doubles as the tested oracle for the
   sort path.

2. **Raster kernel (Pallas through Triton)**: one program per screen tile.  It
   walks its tile's segment ``stream[offs[t] : offs[t] + counts[t]]`` in
   submission order with the tile's depth / normal / uv / mesh-id planes held
   in registers; the strict ``z < depth`` test keeps depth-LESS first-wins
   exactly as raster_ref defines it (bit-identical in interpret mode, which
   the tests assert).  A depth-only variant serves the shadow map, the
   light-culling prepass and calibration.

The per-pixel rules (pixel-center sampling, top-left fill, depth clip,
perspective-correct attributes) are shared with raster_ref via the same packed
triangle records from ops/transform.py.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import RendererConfig
from .raster_ref import FragmentPlanes
from .transform import (
    TRI_AREA,
    TRI_MESH_ID,
    TRI_N0,
    TRI_RW0,
    TRI_RW1,
    TRI_RW2,
    TRI_UV0,
    TRI_VALID,
    TRI_X0,
    TRI_X1,
    TRI_X2,
    TRI_Y0,
    TRI_Y1,
    TRI_Y2,
    TRI_Z0,
    TRI_Z1,
    TRI_Z2,
)


class BinnedTriangles(NamedTuple):
    idx: jnp.ndarray      # [NT, K] int32 per-tile triangle ids, or None (stream-only)
    counts: jnp.ndarray   # [NT, 1] int32 — triangles binned to each tile (clamped to K)
    overflow: jnp.ndarray  # [] int32 — tiles whose true count exceeded K (dropped tris)
    # Compacted record stream: tile t's records are rows
    # [offs[t], offs[t] + counts[t]) in submission order.
    stream: jnp.ndarray | None = None   # [rows, TRI_STRIDE] f32
    offs: jnp.ndarray | None = None     # [NT + 1] int32 segment offsets

    def with_stream(self, packed: jnp.ndarray) -> "BinnedTriangles":
        """Record stream from the dense idx (the flat binning path): tile t's
        segment is its K-slot row of idx, so offs[t] = t * K."""
        NT, K = self.idx.shape
        offs = jnp.arange(NT + 1, dtype=jnp.int32) * K
        return self._replace(stream=packed[self.idx.reshape(-1)], offs=offs)


# bin_triangles uses the flat [tiles, T] overlap matrix + per-tile top_k only for
# small scenes (its cost scales with NT*T).  Above FLAT_CELLS it switches to
# sort-based binning: emit (tile, triangle) pairs and let one device sort group
# them per tile in submission order.
FLAT_CELLS = 1_000_000


def _overlap_matrix(aabb, valid, y0s, x0s, span_h, span_w):
    """[len(y0s) * len(x0s), T] bool: tri AABB vs tile-rect intersection."""
    minx, miny, maxx, maxy = aabb[:, 0], aabb[:, 1], aabb[:, 2], aabb[:, 3]
    ox = (minx[None, :] < x0s[:, None] + span_w) & (maxx[None, :] >= x0s[:, None])
    oy = (miny[None, :] < y0s[:, None] + span_h) & (maxy[None, :] >= y0s[:, None])
    return (oy[:, None, :] & ox[None, :, :] & valid[None, None, :]).reshape(
        y0s.shape[0] * x0s.shape[0], -1
    )


def bin_triangles_flat(
    packed: jnp.ndarray,
    aabb: jnp.ndarray,
    valid: jnp.ndarray,
    cfg: RendererConfig,
    band_h: int | None = None,
    y_offset=0,
) -> BinnedTriangles:
    """O(NT*T) overlap-matrix binning — fast for small scenes, and the semantics
    oracle the sort-based path is tested against."""
    H = band_h or cfg.height
    W = cfg.width
    TH, TW = cfg.tile_h, cfg.tile_w
    nty, ntx = -(-H // TH), -(-W // TW)
    T = packed.shape[0]
    K = min(cfg.max_tris_per_tile, T)
    y_off = jnp.asarray(y_offset, jnp.float32)

    ty = y_off + jnp.arange(nty, dtype=jnp.float32) * TH
    tx = jnp.arange(ntx, dtype=jnp.float32) * TW
    overlap = _overlap_matrix(aabb, valid, ty, tx, TH, TW)
    # top_k keeps ties in index order => triangles stay in submission order,
    # preserving depth-LESS first-wins semantics.
    _, idx = jax.lax.top_k(overlap.astype(jnp.float32), K)
    true_counts = jnp.sum(overlap, axis=-1)
    counts = jnp.minimum(true_counts, K).astype(jnp.int32)
    overflow = jnp.sum(true_counts > K).astype(jnp.int32)
    return BinnedTriangles(
        idx=idx.astype(jnp.int32), counts=counts[:, None], overflow=overflow
    )


def bin_triangles(
    packed: jnp.ndarray,
    aabb: jnp.ndarray,
    valid: jnp.ndarray,
    cfg: RendererConfig,
    band_h: int | None = None,
    y_offset=0,
    stream_src: jnp.ndarray | None = None,
) -> BinnedTriangles:
    """XLA-side binning + compaction + gather (see module docstring).

    Flat overlap-matrix path for small scenes; sort-based (tile, triangle)-pair
    binning for large ones.  The sort path:

      1. Each triangle's AABB maps to a tile-index rectangle.  ONE record sort
         by (footprint tier, submission index) compacts the live triangles of
         every tier into contiguous prefixes, with the rect geometry riding
         the sort as a bit-packed payload operand.  Triangles covering at most
         ``cfg.bin_expand`` tiles emit from a [bin_max_small, E] compacted
         expansion (-1 = every record); wider footprints route through two
         further compacted rect tiers (``bin_expand_medium``/``bin_max_medium``
         then ``bin_expand_large``/``bin_max_large``); the widest ("big")
         triangles — up to ``cfg.bin_max_big`` of them — emit one pair per
         overlapped tile from a [B, NT] expansion (skipped entirely when the
         large tier's rect already covers the grid).  Unused slots emit the
         sentinel tile NT.
      2. One lexicographic sort by (tile, tri) groups pairs per tile with
         triangles in submission order — the exact order-preservation property
         the flat path gets from top_k tie behavior (depth-LESS first-wins).
      3. searchsorted yields per-tile segment offsets; the output is either the
         dense [NT, K] id layout, or — with `stream_src` — the compacted record
         STREAM: one row gather of `stream_src` rows by the sorted pair prefix
         (row i of the stream is sorted pair i, segment offsets = the bounds),
         skipping the dense NT*K-element id gather entirely.

    Overflow counts tiles whose triangle list exceeded K, plus any big triangles
    beyond the bin_max_big budget (each would silently drop coverage), plus a
    stream-capacity excess when `stream_src` is used.

    `band_h`/`y_offset` restrict binning to a horizontal band of the frame
    starting at pixel row y_offset (which may be a traced value — the multi-chip
    screen-sharded path passes axis_index * band)."""
    H = band_h or cfg.height
    W = cfg.width
    TH, TW = cfg.tile_h, cfg.tile_w
    nty, ntx = -(-H // TH), -(-W // TW)
    NT = nty * ntx
    T = packed.shape[0]
    K = min(cfg.max_tris_per_tile, T)

    if T * NT <= FLAT_CELLS:
        binned = bin_triangles_flat(packed, aabb, valid, cfg, band_h, y_offset)
        if stream_src is not None:
            binned = binned.with_stream(stream_src)
        return binned

    # Tier budgets scale with the FULL framebuffer area (base: 1080p): at 4K a
    # triangle's tile footprint quadruples, so the same scene needs wider
    # rects and deeper compaction budgets — without this, resolution changes
    # silently shift work into the overflow counters (loud, but a footgun).
    # Band mode scales by the full-frame area too, NOT the band's: a
    # triangle's horizontal tile span is never band-clipped, so per-band
    # footprints approach the single-chip ones and a band-area scale would
    # under-budget the tiers on sharded high-resolution renders.
    area_scale = max(1, round((cfg.height * W) / (1920 * 1080)))
    E = max(1, cfg.bin_expand * area_scale)
    EM = max(E + 1, cfg.bin_expand_medium * area_scale)
    MB = min(cfg.bin_max_medium * area_scale, T)
    EL = max(EM + 1, cfg.bin_expand_large * area_scale)
    ML = min(cfg.bin_max_large * area_scale, T)
    B = min(cfg.bin_max_big * area_scale, T)
    # When the large tier's rect already covers the whole grid, no footprint
    # can exceed it — the grid-wide big tier would emit only sentinels, so
    # skip its [B, NT] expansion entirely (a static-shape decision).
    has_big = EL < NT
    y_off = jnp.asarray(y_offset, jnp.float32)

    # Tile-index rectangle per triangle.  The flat path's overlap condition
    # (minx < x0+TW) & (maxx >= x0) is exactly tx in [floor(minx/TW),
    # floor(maxx/TW)] — identical binning criterion.
    minx, miny, maxx, maxy = aabb[:, 0], aabb[:, 1], aabb[:, 2], aabb[:, 3]
    tx0 = jnp.floor(minx / TW).astype(jnp.int32)
    tx1 = jnp.floor(maxx / TW).astype(jnp.int32)
    ty0 = jnp.floor((miny - y_off) / TH).astype(jnp.int32)
    ty1 = jnp.floor((maxy - y_off) / TH).astype(jnp.int32)
    live = valid & (tx1 >= 0) & (tx0 < ntx) & (ty1 >= 0) & (ty0 < nty)
    tx0 = jnp.clip(tx0, 0, ntx - 1)
    tx1 = jnp.clip(tx1, 0, ntx - 1)
    ty0 = jnp.clip(ty0, 0, nty - 1)
    ty1 = jnp.clip(ty1, 0, nty - 1)
    w = tx1 - tx0 + 1
    h = ty1 - ty0 + 1
    footprint = w * h

    # The small-tier budget scales with area like MB/ML/B: its threshold E
    # scales, so at 4K triangles measured in the 1080p fp 3..8 bucket land in
    # the scaled small tier (E=8) — a count-invariant budget would silently
    # thin the tuned margin before the loud overflow.
    LS = T if cfg.bin_max_small < 0 else min(cfg.bin_max_small * area_scale, T)

    small = live & (footprint <= E)
    medium = live & (footprint > E) & (footprint <= EM)
    if has_big:
        large = live & (footprint > EM) & (footprint <= EL)
        big = live & (footprint > EL)
    else:
        large = live & (footprint > EM)
        big = jnp.zeros_like(live)

    # --- Compacted tiers via ONE stage-1 sort (replaces per-tier top_k) ---
    # Records sort by (tier, submission index): the sorted prefix holds each
    # tier's triangles back-to-back in ascending id order — exactly the set +
    # order top_k(tier_mask) produced, for every tier at once, including the
    # SMALL tier (whose dense [T, E] expansion was ~75% dead records on the
    # benchmark scene: backface-culled + unused near-clip slots emitted 150k
    # sentinel sort keys).  The rect geometry rides the sort as one bit-packed
    # payload operand, so no post-sort gathers are needed.
    tier = jnp.where(
        small, 0,
        jnp.where(medium, 1, jnp.where(large, 2, jnp.where(big, 3, 4))),
    ).astype(jnp.int32)
    n_small = jnp.sum(small).astype(jnp.int32)
    n_med = jnp.sum(medium).astype(jnp.int32)
    n_lrg = jnp.sum(large).astype(jnp.int32)
    n_big = jnp.sum(big).astype(jnp.int32)

    key1 = tier * T + jnp.arange(T, dtype=jnp.int32)
    bw = max((ntx - 1).bit_length(), 1)
    bh = max((nty - 1).bit_length(), 1)
    packed_bits = 2 * (bw + bh)
    if packed_bits <= 30:
        pay = (
            (((w - 1) << (bh + bh + bw)) | ((h - 1) << (bh + bw)))
            | (ty0 << bw)
            | tx0
        ).astype(jnp.int32)
        key1_s, pay_s = jax.lax.sort((key1, pay), num_keys=1)
    else:  # absurdly large tile grids: carry the raw rect columns instead
        key1_s, w_s4, h_s4, ty0_s4, tx0_s4 = jax.lax.sort(
            (key1, w, h, ty0, tx0), num_keys=1
        )
        pay_s = None
    tier_sorted = key1_s // T
    idx_sorted = key1_s - tier_sorted * T

    def tier_slice(start, L):
        """Compacted (ids, w, h, ty0, tx0, tier) for one tier's L-slot budget.
        `start` is traced; dynamic_slice clamps it to T - L, and the tier mask
        (checked against the sliced tier codes) keeps clamp-shifted slots from
        leaking neighbouring tiers' records."""
        ids = jax.lax.dynamic_slice_in_dim(idx_sorted, start, L)
        ts = jax.lax.dynamic_slice_in_dim(tier_sorted, start, L)
        if pay_s is not None:
            p = jax.lax.dynamic_slice_in_dim(pay_s, start, L)
            w_ = (p >> (bh + bh + bw)) + 1
            h_ = ((p >> (bh + bw)) & ((1 << bh) - 1)) + 1
            ty0_ = (p >> bw) & ((1 << bh) - 1)
            tx0_ = p & ((1 << bw) - 1)
        else:
            w_ = jax.lax.dynamic_slice_in_dim(w_s4, start, L)
            h_ = jax.lax.dynamic_slice_in_dim(h_s4, start, L)
            ty0_ = jax.lax.dynamic_slice_in_dim(ty0_s4, start, L)
            tx0_ = jax.lax.dynamic_slice_in_dim(tx0_s4, start, L)
        return ids, w_, h_, ty0_, tx0_, ts

    def rect_slots(e, w_, ty0_, tx0_, fp_, ok_):
        """Slot e of a triangle's w x h tile rect, row-major; sentinel NT when
        the slot is past the footprint or the triangle is not in this tier."""
        dy = e[None, :] // w_[:, None]
        dx = e[None, :] % w_[:, None]
        tile = (ty0_[:, None] + dy) * ntx + (tx0_[:, None] + dx)
        ok = ok_[:, None] & (e[None, :] < fp_[:, None])
        return jnp.where(ok, tile, NT)

    def expand_rect(start, L, Ek, code):
        ids, w_, h_, ty0_, tx0_, ts = tier_slice(start, L)
        e = jnp.arange(Ek, dtype=jnp.int32)
        tile = rect_slots(e, w_, ty0_, tx0_, w_ * h_, ts == code)
        tri = jnp.broadcast_to(ids[:, None], (L, Ek))
        return tile.reshape(-1), tri.reshape(-1)

    tile_s, tri_s = expand_rect(jnp.int32(0), LS, E, 0)
    tile_m, tri_m = expand_rect(n_small, MB, EM, 1)
    tile_l, tri_l = expand_rect(n_small + n_med, ML, EL, 2)

    tile_parts = [tile_s, tile_m, tile_l]
    tri_parts = [tri_s, tri_m, tri_l]

    # Big triangles: each emits one pair per overlapped tile of the full grid.
    if has_big:
        bids, bw_, bh_, bty0, btx0, bts = tier_slice(
            n_small + n_med + n_lrg, B
        )
        big_ok = bts == 3
        tyi = jnp.arange(nty, dtype=jnp.int32)[None, :, None]
        txi = jnp.arange(ntx, dtype=jnp.int32)[None, None, :]
        ov = (
            (tyi >= bty0[:, None, None])
            & (tyi <= (bty0 + bh_ - 1)[:, None, None])
            & (txi >= btx0[:, None, None])
            & (txi <= (btx0 + bw_ - 1)[:, None, None])
            & big_ok[:, None, None]
        )  # [B, nty, ntx]
        tile_parts.append(jnp.where(ov, tyi * ntx + txi, NT).reshape(-1))
        tri_parts.append(jnp.broadcast_to(bids[:, None], (B, NT)).reshape(-1))

    tiles = jnp.concatenate(tile_parts)
    tris = jnp.concatenate(tri_parts)
    P = tiles.shape[0]

    # Sort by (tile, tri).  When the packed key tile*T2 + tri fits int32, ONE
    # single-key sort replaces the 2-key lexicographic sort (~2x cheaper);
    # (tile, tri) pairs are unique so key order == pair order exactly.
    T2 = 1 << max(T - 1, 1).bit_length()
    if (NT + 1) * T2 < 2**31:
        keys = tiles * T2 + tris
        (keys_sorted,) = jax.lax.sort((keys,), num_keys=1)
        tris_sorted = keys_sorted & (T2 - 1)
        bounds = jnp.searchsorted(
            keys_sorted, jnp.arange(NT + 1, dtype=jnp.int32) * T2, side="left"
        ).astype(jnp.int32)
    else:
        tiles_sorted, tris_sorted = jax.lax.sort((tiles, tris), num_keys=2)
        # Per-tile segments: sentinel pairs (tile == NT) sort past every tile.
        bounds = jnp.searchsorted(
            tiles_sorted, jnp.arange(NT + 1, dtype=jnp.int32), side="left"
        ).astype(jnp.int32)
    true_counts = bounds[1:] - bounds[:-1]
    counts = jnp.minimum(true_counts, K).astype(jnp.int32)
    overflow = (
        jnp.sum(true_counts > K)
        + jnp.maximum(n_small - LS, 0)
        + jnp.maximum(n_med - MB, 0)
        + jnp.maximum(n_lrg - ML, 0)
        + (jnp.maximum(n_big - B, 0) if has_big else 0)
    ).astype(jnp.int32)

    if stream_src is not None:
        # The sorted pair prefix IS the stream: row i holds sorted pair i's
        # record, per-tile segments are [bounds[t], bounds[t+1]).  One row
        # gather builds it; no dense id layout needed at all.  The cap scales
        # with the framebuffer area like the tier budgets above.
        cap = min(cfg.bin_stream_cap * area_scale, P)
        offs = jnp.minimum(bounds, cap)
        scounts = jnp.minimum(counts, offs[1:] - offs[:-1])
        overflow = overflow + (bounds[NT] > cap).astype(jnp.int32)
        return BinnedTriangles(
            idx=None, counts=scounts[:, None], overflow=overflow,
            stream=stream_src[tris_sorted[:cap]], offs=offs,
        )

    gidx = jnp.clip(bounds[:-1, None] + jnp.arange(K, dtype=jnp.int32)[None, :], 0, P - 1)
    idx = tris_sorted[gidx]  # [NT, K]; slots beyond counts are padding
    return BinnedTriangles(idx=idx, counts=counts[:, None], overflow=overflow)


# Perspective-correct attribute channels of the full rasterizer: (first record
# column, column step between the three vertices).  Normal xyz, then uv.
_ATTR_CHANNELS = (
    (TRI_N0, 3), (TRI_N0 + 1, 3), (TRI_N0 + 2, 3),
    (TRI_UV0, 2), (TRI_UV0 + 1, 2),
)

# Warps per raster program: a 1024-pixel tile keeps 7 planes in registers.
RASTER_WARPS = 4


def _raster_kernel(offs_ref, counts_ref, yoff_ref, stream_ref, *out_refs,
                   tile_h, tile_w, ntx, attrs):
    """One screen tile: walk its record segment in submission order.

    The per-triangle arithmetic is raster_ref.rasterize_packed's, expression
    for expression, so interpret mode is bit-identical to the oracle; record
    fields are scalar loads (uniform across the program, served from cache)."""
    ty = pl.program_id(0)
    tx = pl.program_id(1)
    t = ty * ntx + tx
    start = offs_ref[t]
    n = counts_ref[t]
    shape = (tile_h, tile_w)
    py = (
        (yoff_ref[0] + ty * tile_h).astype(jnp.float32) + 0.5
        + jax.lax.broadcasted_iota(jnp.int32, shape, 0).astype(jnp.float32)
    )
    px = (
        (tx * tile_w).astype(jnp.float32) + 0.5
        + jax.lax.broadcasted_iota(jnp.int32, shape, 1).astype(jnp.float32)
    )

    def body(i, carry):
        depth = carry[0]

        def f(col):
            return stream_ref[i, col]

        def edge(ax, ay, bx, by):
            # e(p) = cross2d(b - a, p - a); top-left tie rule (raster_ref).
            e = (ay - by) * px + (bx - ax) * py + (ax * by - bx * ay)
            dx = bx - ax
            dy = by - ay
            tl = ((dy == 0.0) & (dx > 0.0)) | (dy < 0.0)
            return (e > 0.0) | ((e == 0.0) & tl), e

        x0, y0 = f(TRI_X0), f(TRI_Y0)
        x1, y1 = f(TRI_X1), f(TRI_Y1)
        x2, y2 = f(TRI_X2), f(TRI_Y2)
        c0, e0 = edge(x1, y1, x2, y2)
        c1, e1 = edge(x2, y2, x0, y0)
        c2, e2 = edge(x0, y0, x1, y1)
        inv_area = 1.0 / f(TRI_AREA)
        b0 = e0 * inv_area
        b1 = e1 * inv_area
        b2 = e2 * inv_area
        z = b0 * f(TRI_Z0) + b1 * f(TRI_Z1) + b2 * f(TRI_Z2)
        passes = (
            c0 & c1 & c2 & (f(TRI_VALID) > 0.0)
            & (z < depth) & (z >= 0.0) & (z <= 1.0)
        )
        out = [jnp.where(passes, z, depth)]
        if attrs:
            rw = b0 * f(TRI_RW0) + b1 * f(TRI_RW1) + b2 * f(TRI_RW2)
            inv_rw = 1.0 / jnp.where(rw == 0.0, 1.0, rw)
            for (col, step), old in zip(_ATTR_CHANNELS, carry[1:-1]):
                a = (b0 * f(col) + b1 * f(col + step) + b2 * f(col + 2 * step))
                out.append(jnp.where(passes, a * inv_rw, old))
            mid = f(TRI_MESH_ID).astype(jnp.int32)
            out.append(jnp.where(passes, mid, carry[-1]))
        return tuple(out)

    init = [jnp.ones(shape, jnp.float32)]
    if attrs:
        init += [jnp.zeros(shape, jnp.float32) for _ in _ATTR_CHANNELS]
        init.append(jnp.full(shape, -1, jnp.int32))
    planes = jax.lax.fori_loop(start, start + n, body, tuple(init))
    for ref, plane in zip(out_refs, planes):
        ref[...] = plane


def _run_raster_kernel(binned, cfg, band_h, y_offset, attrs, interpret):
    """Launch _raster_kernel over the (band of the) tile grid -> planes
    [Hp, Wp] each (depth, then with `attrs` nx ny nz u v mesh_id)."""
    H = band_h or cfg.height
    TH, TW = cfg.tile_h, cfg.tile_w
    nty, ntx = -(-H // TH), -(-cfg.width // TW)
    plane = jax.ShapeDtypeStruct((nty * TH, ntx * TW), jnp.float32)
    out_shape = [plane]
    if attrs:
        out_shape += [plane] * len(_ATTR_CHANNELS)
        out_shape.append(jax.ShapeDtypeStruct(plane.shape, jnp.int32))
    spec = pl.BlockSpec((TH, TW), lambda i, j: (i, j))
    whole = pl.BlockSpec(memory_space=pl.ANY)
    yoff = jnp.asarray(y_offset, jnp.int32).reshape(1)
    kernel = functools.partial(
        _raster_kernel, tile_h=TH, tile_w=TW, ntx=ntx, attrs=attrs
    )
    return pl.pallas_call(
        kernel,
        grid=(nty, ntx),
        in_specs=[whole] * 4,
        out_specs=[spec] * len(out_shape),
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=RASTER_WARPS),
        interpret=interpret,
        name="raster_depth" if not attrs else "raster",
    )(binned.offs, binned.counts[:, 0], yoff, binned.stream)


def _bin_stream(packed, aabb, cfg, band_h, y_offset):
    with jax.named_scope("binning"):
        valid = packed[:, TRI_VALID] > 0.0
        return bin_triangles(
            packed, aabb, valid, cfg, band_h=band_h, y_offset=y_offset,
            stream_src=packed,
        )


def rasterize_depth(
    packed: jnp.ndarray,
    aabb: jnp.ndarray,
    cfg: RendererConfig,
    interpret: bool = False,
    return_overflow: bool = False,
) -> jnp.ndarray:
    """Depth-only tile-binned rasterization of the whole cfg.height x
    cfg.width target -> depth [H, W] float32 (cleared 1.0).

    Exactly the depth plane rasterize_binned would produce, at ~the z-test
    cost alone: the shadow map (a cfg with width = height = map size) and
    calibration use it.  With return_overflow=True returns (depth, overflow):
    the binning's dropped-triangle tile count (the no-silent-drop contract)."""
    binned = _bin_stream(packed, aabb, cfg, None, 0)
    (depth,) = _run_raster_kernel(binned, cfg, None, 0, False, interpret)
    depth = depth[: cfg.height, : cfg.width]
    if return_overflow:
        return depth, binned.overflow
    return depth


def rasterize_binned(
    packed: jnp.ndarray,
    aabb: jnp.ndarray,
    cfg: RendererConfig,
    interpret: bool = False,
    band_h: int | None = None,
    y_offset=0,
    return_overflow: bool = False,
):
    """Tile-binned rasterization -> FragmentPlanes (same contract as
    raster_ref.rasterize_packed).

    With `band_h`/`y_offset`, rasterizes only rows [y_offset, y_offset + band_h)
    of the full frame (y_offset may be traced) — the screen-sharded multi-chip
    path runs this per band.  With return_overflow=True, returns
    (FragmentPlanes, overflow) where overflow counts tiles whose triangle list
    exceeded the K cap (those tiles silently lose geometry — frame.render
    threads this to the runtime overflow warning)."""
    H = band_h or cfg.height
    W = cfg.width
    binned = _bin_stream(packed, aabb, cfg, band_h, y_offset)
    depth, nx, ny, nz, u, v, mid = (
        p[:H, :W]
        for p in _run_raster_kernel(binned, cfg, band_h, y_offset, True, interpret)
    )
    frags = FragmentPlanes(
        depth=depth,
        normal=jnp.stack([nx, ny, nz], axis=-1),
        uv=jnp.stack([u, v], axis=-1),
        mesh_id=mid,
    )
    if return_overflow:
        return frags, binned.overflow
    return frags
