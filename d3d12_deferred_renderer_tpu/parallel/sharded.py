"""Multi-chip rendering: screen-row bands x frame batches x triangle shards
over a device mesh.

Strategy (SURVEY.md §5 "distributed communication backend"): rendering is data
parallel over pixels — scene state is replicated (it is small), every chip runs
vertex transform + binning for its own screen band, rasterizes and shades only that
band, and the G-buffer NEVER crosses chips.  The only cross-chip data movement is
the implicit assembly of the final uint8 frame (out_specs concatenation across devices).
A second mesh axis batches whole frames (BASELINE config 5: 8 frames per jit step).

A third axis shards the GEOMETRY (`render_tri_sharded`): each chip rasterizes a
contiguous slice of the triangle stream over the (band of the) screen, and the
partial fragment buffers composite with a depth-min + submission-order tie-break
— classic sort-last compositing, expressed as two `pmin`s and a fused
`psum_scatter` across devices.  Pixel-parallel bands win when pixels dominate;
triangle shards win when geometry dominates (the raster/binning cost splits by
T while the composite traffic is a constant few framebuffer planes).

All functions run under a jitted shard_map with static RendererConfig, so XLA
compiles one SPMD program (an eager shard_map would dispatch the body op by
op); `dryrun_multichip` in __graft_entry__.py validates this on a virtual
CPU mesh.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..config import RendererConfig
from ..ops import dispatch, post
from ..ops.gbuffer import encode_gbuffer
from ..ops.lighting import shade_lambert
from ..ops.transform import setup_frame_triangles
from ..scene import SceneState
from ..xmath import XM_2PI


class BandAxes(NamedTuple):
    """Flat screen-band axis handle: mesh-axis names MAJOR -> MINOR in the
    band-to-screen-row flattening order (rows major, tri minor), with their
    static sizes.

    Round-4 defect (VERDICT.md): passing the combined ``("rows", "tri")``
    tuple straight to ``all_gather``/``ppermute``/``axis_index`` flattens it
    in MESH-DECLARATION order, while the band-to-row mapping
    (``y0 = rows_idx * band + tri_idx * sub``) and shard_map ``out_specs``
    follow TUPLE order — so a mesh declared ``("tri", "rows")`` scrambled the
    cross-band halo/gather at sub-band boundaries.  Every cross-band
    collective now goes through this handle, which composes single-axis
    collectives in the explicit major->minor order and is therefore correct
    for ANY mesh declaration order."""

    names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def total(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @property
    def psum_axes(self):
        """Axis-name handle for order-independent collectives (psum)."""
        return self.names if len(self.names) > 1 else self.names[0]

    @property
    def spec(self):
        """The PartitionSpec entry for the sharded rows dimension: shard_map
        out_specs flatten a tuple entry in TUPLE order (major first), matching
        index()."""
        return self.names if len(self.names) > 1 else self.names[0]

    def index(self):
        """Flat band index in major->minor order (traced)."""
        idx = jax.lax.axis_index(self.names[0])
        for nm, sz in zip(self.names[1:], self.sizes[1:]):
            idx = idx * sz + jax.lax.axis_index(nm)
        return idx

    def all_gather_tiled(self, x: jnp.ndarray) -> jnp.ndarray:
        """Concatenate every band's `x` along dim 0 in flat-band (major->
        minor) order: nested single-axis tiled all_gathers, minor axis first,
        so the result is independent of mesh declaration order."""
        for nm in reversed(self.names):
            x = jax.lax.all_gather(x, nm, tiled=True)
        return x


def _bloom_band(
    hdr: jnp.ndarray, cfg: RendererConfig, axes: BandAxes
) -> jnp.ndarray:
    """post.bloom over the FULL frame, evaluated band-locally: the 4x-
    downsampled thresholded bright field is tiny (~1.5 MB f32 at 1080p), so
    each chip all-gathers it, runs the single-chip blur verbatim on
    the identical full array, and keeps its own rows — bit-identical to
    post.bloom on the assembled frame (requires band % downsample == 0 so the
    per-band [::4] slices concatenate to the global one)."""
    from ..ops.post import (
        BLOOM_DOWNSAMPLE,
        BLOOM_RADIUS,
        BLOOM_SIGMA,
        _blur_separable,
    )

    d, sigma, radius = BLOOM_DOWNSAMPLE, BLOOM_SIGMA, BLOOM_RADIUS
    bh, W, _ = hdr.shape
    bright = jnp.maximum(hdr - cfg.bloom_threshold, 0.0)
    ds = bright[::d, ::d]
    full = axes.all_gather_tiled(ds)
    blurred = _blur_separable(full, sigma, radius)
    y0 = axes.index() * ds.shape[0]
    mine = jax.lax.dynamic_slice_in_dim(blurred, y0, ds.shape[0], 0)
    up = jnp.repeat(jnp.repeat(mine, d, 0), d, 1)[:bh, :W]
    return hdr + cfg.bloom_strength * up


def _fxaa_band(color: jnp.ndarray, axes: BandAxes) -> jnp.ndarray:
    """post.fxaa with its 1-row cross-band footprint satisfied by a boundary-
    row exchange: every band contributes its first+last rows to one tiny
    all_gather (2 rows x W x 3 per band, flat-band order via BandAxes), then
    selects its flat neighbors' boundary rows and filters the extended strip.
    Global image edges replicate the band's own edge row — dynamic_slice's
    start clamping yields exactly post.fxaa's edge-clamped taps — so output
    rows are bit-identical to single-chip FXAA for any mesh axis order."""
    n = axes.total
    if n == 1:
        return post.fxaa(color)
    i = axes.index()
    edges = jnp.concatenate([color[:1], color[-1:]], axis=0)  # [2, W, C]
    all_edges = axes.all_gather_tiled(edges)  # [2n, W, C]: band b at 2b, 2b+1
    # Previous band's LAST row is slot 2i-1; next band's FIRST row is 2i+2.
    # dynamic_slice clamps starts into [0, 2n-1]: band 0's "previous" resolves
    # to its own first row, band n-1's "next" to its own last row — the edge
    # replication post.fxaa applies at the image border.
    top = jax.lax.dynamic_slice_in_dim(all_edges, 2 * i - 1, 1, 0)
    bot = jax.lax.dynamic_slice_in_dim(all_edges, 2 * i + 2, 1, 0)
    ext = jnp.concatenate([top, color, bot], axis=0)
    return post.fxaa(ext)[1:-1]


def _post_band(
    hdr: jnp.ndarray, cfg: RendererConfig, axes: BandAxes
) -> jnp.ndarray:
    """post.apply_post (bloom -> tonemap -> gamma -> FXAA) for one screen
    band, with the two cross-pixel filters made exact across bands (see
    _bloom_band/_fxaa_band); tonemap/gamma are pointwise and band-local."""
    x = hdr
    if cfg.bloom:
        x = _bloom_band(x, cfg, axes)
    if cfg.tonemap == "reinhard":
        x = post.reinhard(x)
    x = post.gamma_encode(x, cfg.gamma)
    if cfg.fxaa:
        x = _fxaa_band(x, axes)
    return x


def _render_band(
    state: SceneState, cfg: RendererConfig, y0, band_h: int,
    axes: BandAxes,
    pallas_interpret: bool = False,
):
    """Render rows [y0, y0 + band_h) of the full cfg.height x cfg.width frame.
    `y0` may be traced (axis_index * band).  Returns (uint8 band, overflow):
    the band-local per-tile capacity overflow count (the single-chip
    no-silent-drop contract, frame.render_stats) — callers psum it over the
    rows axis."""
    tris, view_proj = setup_frame_triangles(state, cfg)
    frags, overflow = dispatch.rasterize(
        tris.packed, tris.aabb, cfg, band_h=band_h, y_offset=y0,
        interpret=pallas_interpret,
    )
    color, s_overflow = _shade_band(
        frags, state, cfg, view_proj, y0, axes, pallas_interpret
    )
    return color, overflow + s_overflow


def _shade_band(
    frags, state: SceneState, cfg: RendererConfig, view_proj, y0,
    axes: BandAxes, pallas_interpret: bool = False,
):
    """Bump -> G-buffer encode -> shading -> post for one screen band held in
    `frags` (rows [y0, y0 + band_h) of the full frame).  `axes` is the flat
    band-axis handle (one mesh axis, or the rows x tri composition) that every
    cross-band filter collective goes through.  Returns (uint8 band,
    shading-side overflow); raster overflow is the caller's."""
    overflow = jnp.zeros((), jnp.int32)
    if cfg.normal_mapping:
        # Band-local and exact when bands align to the bump block grid
        # (checked in _check_band_safe): blocks never straddle a band, so the
        # per-block derivatives equal the single-chip ones.
        from ..ops.bump import apply_normal_mapping
        from ..ops.lighting import reconstruct_world_positions

        world = reconstruct_world_positions(
            frags.depth, view_proj, cfg, y_offset=y0, full_height=cfg.height
        )
        frags = apply_normal_mapping(
            frags, world, cfg.bump_strength, cfg.bump_frequency
        )
    gb = encode_gbuffer(frags, state.materials, cfg)

    if cfg.shading == "lambert":
        color = shade_lambert(gb, state.lights, cfg)
        if cfg.fxaa:
            color = _fxaa_band(color, axes)
    else:
        vis = None
        if cfg.shadows:
            # The shadow map is view-global and band-independent: every chip
            # renders it replicated (it is small) and samples its own band.
            from ..ops.shadows import render_shadow_map, shadow_visibility

            shadow_depth, light_vp, s_overflow = render_shadow_map(
                state, cfg, return_overflow=True, interpret=pallas_interpret
            )
            vis, v_overflow = shadow_visibility(
                gb.depth, view_proj, shadow_depth, light_vp, cfg,
                y_offset=y0, full_height=cfg.height, return_overflow=True,
            )
            overflow = overflow + s_overflow + v_overflow
        hdr, l_overflow = dispatch.shade_pbr(
            gb, state.lights, cfg, view_proj, state.camera.eye,
            shadow_visibility=vis, y_offset=y0, full_height=cfg.height,
            interpret=pallas_interpret,
        )
        overflow = overflow + l_overflow
        color = _post_band(hdr, cfg, axes)
    return post.to_uint8(color), overflow


def _check_band_safe(cfg: RendererConfig, band: int) -> None:
    """Cross-pixel filters are supported across bands (bloom all-gathers its
    downsampled field, FXAA halo-exchanges a row, bump is block-aligned) but
    each needs the band height to respect its grid — refuse loudly instead of
    diverging silently from the single-chip render() (round-1 advisor
    finding)."""
    from ..ops.bump import BUMP_BLOCK
    from ..ops.post import BLOOM_DOWNSAMPLE

    if cfg.bloom and band % BLOOM_DOWNSAMPLE:
        raise ValueError(
            f"bloom needs band height divisible by its {BLOOM_DOWNSAMPLE}x "
            f"downsample, got {band}: choose a band count so "
            f"height/bands % {BLOOM_DOWNSAMPLE} == 0"
        )
    if cfg.normal_mapping and band % BUMP_BLOCK[0]:
        raise ValueError(
            f"normal mapping needs band height divisible by the "
            f"{BUMP_BLOCK[0]}-row bump block grid, got {band}: blocks must "
            "not straddle band boundaries"
        )
    if cfg.shadows and max(1, cfg.shadow_vis_downsample) > 1:
        raise ValueError(
            "shadow_vis_downsample > 1 is band-local (the coarse visibility "
            "upsample cannot see neighboring bands' samples) and would "
            "silently diverge from the single-chip render: use "
            "shadow_vis_downsample=1 on the sharded path"
        )


def render_sharded(
    state: SceneState, cfg: RendererConfig, mesh: Mesh, rows_axis: str = "rows",
    pallas_interpret: bool = False, return_stats: bool = False,
) -> jnp.ndarray:
    """One frame, screen rows sharded across `rows_axis` -> [H, W, 3] uint8
    (device-sharded along rows).

    With return_stats=True returns (frame, stats) where stats["overflow"] is
    the per-tile capacity overflow count summed over all bands — the same
    no-silent-drop signal as the single-chip render_stats()."""
    n = mesh.shape[rows_axis]
    if cfg.height % n:
        raise ValueError(f"height {cfg.height} not divisible by {n} bands")
    band = cfg.height // n
    _check_band_safe(cfg, band)
    axes = BandAxes((rows_axis,), (n,))

    def fn(st):
        y0 = jax.lax.axis_index(rows_axis) * band
        frame, overflow = _render_band(
            st, cfg, y0, band, axes, pallas_interpret
        )
        return frame, jax.lax.psum(overflow, rows_axis)

    frame, overflow = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=P(),
        out_specs=(P(rows_axis, None, None), P()),
        check_vma=False,
    ))(state)
    if return_stats:
        return frame, {"overflow": overflow}
    return frame


def _raster_band_tri_slice(
    state: SceneState, cfg: RendererConfig, tri_axis: str, n_t: int,
    y0, band_h: int, pallas_interpret: bool = False,
):
    """Rasterize THIS chip's contiguous slice of the triangle stream over rows
    [y0, y0 + band_h).  Geometry stays replicated in `state` (it is small —
    the axis splits the binning/raster COMPUTE, not storage); each chip slices
    ceil(T / n_t) records after setup.  Zero padding records carry
    TRI_VALID == 0 and can never win a pixel.  Returns
    (FragmentPlanes, view_proj, raster overflow)."""
    tris, view_proj = setup_frame_triangles(state, cfg)
    packed, aabb = tris.packed, tris.aabb
    T = packed.shape[0]
    per = -(-T // n_t)
    pad = n_t * per - T
    if pad:
        packed = jnp.pad(packed, ((0, pad), (0, 0)))
        aabb = jnp.pad(aabb, ((0, pad), (0, 0)))
    tid = jax.lax.axis_index(tri_axis)
    pk = jax.lax.dynamic_slice_in_dim(packed, tid * per, per, 0)
    ab = jax.lax.dynamic_slice_in_dim(aabb, tid * per, per, 0)
    frags, overflow = dispatch.rasterize(
        pk, ab, cfg, band_h=band_h, y_offset=y0, interpret=pallas_interpret
    )
    return frags, view_proj, overflow


def _composite_tri(frags, tri_axis: str, n_t: int, sub_h: int):
    """Sort-last composite of per-chip partial fragment buffers -> this chip's
    [sub_h, W] sub-band of the merged buffer, plus this chip's tri-axis index.

    Exactness: the single-chip rasterizer is depth-LESS first-wins, i.e. the
    winner is the lexicographic (depth, submission index) minimum.  Each chip
    holds a CONTIGUOUS slice of the submission stream, so its local winner is
    already the slice minimum and the cross-chip winner is
    min over chips of (depth, chip rank) — two elementwise `pmin`s.  Attribute
    planes then merge with one fused masked `psum_scatter` per plane (exactly
    one chip contributes per pixel), which also lands each chip its own
    sub-band of rows for the shading stage.  Background pixels (depth 1.0 on
    every chip) resolve to chip 0, whose cleared attributes equal everyone's."""
    from ..ops.raster_ref import FragmentPlanes

    tid = jax.lax.axis_index(tri_axis)
    depth = frags.depth
    gmin = jax.lax.pmin(depth, tri_axis)
    won = depth == gmin
    rank = jax.lax.pmin(jnp.where(won, tid, n_t), tri_axis)
    win = won & (tid == rank)

    def scat(p):
        m = win if p.ndim == 2 else win[..., None]
        contrib = jnp.where(m, p, jnp.zeros_like(p))
        return jax.lax.psum_scatter(
            contrib, tri_axis, scatter_dimension=0, tiled=True
        )

    merged = FragmentPlanes(
        depth=jax.lax.dynamic_slice_in_dim(gmin, tid * sub_h, sub_h, 0),
        normal=scat(frags.normal),
        uv=scat(frags.uv),
        mesh_id=scat(frags.mesh_id),
    )
    return merged, tid


def _shade_axes(rows_axis, tri_axis, n_r: int, n_t: int) -> BandAxes:
    """Band-axis handle for the shading stage: bands split over rows major,
    tri minor — matching y0 = rows_idx * band_h + tri_idx * sub_h.  The
    explicit major->minor order here is what keeps the cross-band collectives
    correct on ANY mesh declaration order (see BandAxes)."""
    if rows_axis:
        return BandAxes((rows_axis, tri_axis), (n_r, n_t))
    return BandAxes((tri_axis,), (n_t,))


def render_tri_sharded(
    state: SceneState, cfg: RendererConfig, mesh: Mesh, tri_axis: str = "tri",
    rows_axis: str | None = None, pallas_interpret: bool = False,
    return_stats: bool = False,
) -> jnp.ndarray:
    """One frame with the TRIANGLE STREAM sharded across `tri_axis` (sort-last
    compositing), optionally combined with screen-row bands across `rows_axis`
    -> [H, W, 3] uint8.

    Each chip rasterizes its triangle slice over its band, buffers composite
    via `_composite_tri`, and shading/post run on sub-bands of
    band_h / n_tri rows using the same cross-band-exact filter machinery as
    `render_sharded` (the combined (rows, tri) axis tuple is one flat band
    axis to every collective).  This path always runs the raster -> shade
    staged pipeline, like the single-chip frame: compositing needs the
    fragment buffer between the two.

    With return_stats=True returns (frame, stats) with the summed overflow
    signal, like render_sharded."""
    n_t = mesh.shape[tri_axis]
    n_r = mesh.shape[rows_axis] if rows_axis else 1
    if cfg.height % n_r:
        raise ValueError(f"height {cfg.height} not divisible by {n_r} bands")
    band = cfg.height // n_r
    if band % n_t:
        raise ValueError(
            f"band height {band} not divisible by {n_t} triangle shards "
            "(shading sub-bands)"
        )
    sub = band // n_t
    _check_band_safe(cfg, sub)
    axes = _shade_axes(rows_axis, tri_axis, n_r, n_t)

    def fn(st):
        y0_band = (
            jax.lax.axis_index(rows_axis) * band if rows_axis else 0
        )
        frags, view_proj, r_ovf = _raster_band_tri_slice(
            st, cfg, tri_axis, n_t, y0_band, band, pallas_interpret
        )
        merged, tid = _composite_tri(frags, tri_axis, n_t, sub)
        y0 = y0_band + tid * sub
        color, s_ovf = _shade_band(
            merged, st, cfg, view_proj, y0, axes, pallas_interpret
        )
        return color, jax.lax.psum(r_ovf + s_ovf, axes.psum_axes)

    frame, overflow = jax.jit(jax.shard_map(
        fn, mesh=mesh, in_specs=P(),
        out_specs=(P(axes.spec, None, None), P()),
        check_vma=False,
    ))(state)
    if return_stats:
        return frame, {"overflow": overflow}
    return frame


def render_frames_batch_tri_sharded(
    state: SceneState,
    times: jnp.ndarray,
    cfg: RendererConfig,
    mesh: Mesh,
    frame_axis: str = "frame",
    tri_axis: str = "tri",
    rows_axis: str | None = None,
    return_stats: bool = False,
    pallas_interpret: bool = False,
) -> jnp.ndarray:
    """Batch of frames sharded (frames over `frame_axis`) x (triangles over
    `tri_axis`) x (optional rows over `rows_axis`) -> [B, H, W, 3] uint8: the
    full 3-axis mesh composition (data x geometry x pixel parallelism)."""
    nf = mesh.shape[frame_axis]
    n_t = mesh.shape[tri_axis]
    n_r = mesh.shape[rows_axis] if rows_axis else 1
    B = times.shape[0]
    if B % nf or cfg.height % n_r:
        raise ValueError("batch/height not divisible by mesh axes")
    band = cfg.height // n_r
    if band % n_t:
        raise ValueError(
            f"band height {band} not divisible by {n_t} triangle shards"
        )
    sub = band // n_t
    _check_band_safe(cfg, sub)
    axes = _shade_axes(rows_axis, tri_axis, n_r, n_t)

    def one(st):
        y0_band = (
            jax.lax.axis_index(rows_axis) * band if rows_axis else 0
        )
        frags, view_proj, r_ovf = _raster_band_tri_slice(
            st, cfg, tri_axis, n_t, y0_band, band, pallas_interpret
        )
        merged, tid = _composite_tri(frags, tri_axis, n_t, sub)
        y0 = y0_band + tid * sub
        color, s_ovf = _shade_band(
            merged, st, cfg, view_proj, y0, axes, pallas_interpret
        )
        return color, r_ovf + s_ovf

    def fn(st, ts):  # ts: local [B // nf]
        frames, overflow = jax.vmap(lambda t: one(_with_time(st, t)))(ts)
        total = jax.lax.psum(
            jax.lax.psum(overflow.sum(), axes.psum_axes), frame_axis
        )
        return frames, total

    frames, overflow = jax.jit(jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(), P(frame_axis)),
        out_specs=(P(frame_axis, axes.spec, None, None), P()),
        check_vma=False,
    ))(state, times)
    if return_stats:
        return frames, {"overflow": overflow}
    return frames


def _with_time(state: SceneState, t) -> SceneState:
    """Set the animation clock to t (yaw of every mesh = t, main.cpp:200-207)."""
    return dataclasses.replace(
        state, time=t, orientation=state.orientation.at[:, 1].set(t)
    )


def render_frames_batch_sharded(
    state: SceneState,
    times: jnp.ndarray,
    cfg: RendererConfig,
    mesh: Mesh,
    frame_axis: str = "frame",
    rows_axis: str = "rows",
    return_stats: bool = False,
    pallas_interpret: bool = False,
) -> jnp.ndarray:
    """Batch of frames at animation clocks `times` [B] -> [B, H, W, 3] uint8,
    sharded (frames over `frame_axis`) x (rows over `rows_axis`).

    With return_stats=True returns (frames, stats) where stats["overflow"] is
    the capacity overflow count summed over every band of every frame."""
    nf, nr = mesh.shape[frame_axis], mesh.shape[rows_axis]
    B = times.shape[0]
    if B % nf or cfg.height % nr:
        raise ValueError("batch/height not divisible by mesh axes")
    band = cfg.height // nr
    _check_band_safe(cfg, band)
    axes = BandAxes((rows_axis,), (nr,))

    def fn(st, ts):  # ts: local [B // nf]
        y0 = jax.lax.axis_index(rows_axis) * band
        frames, overflow = jax.vmap(
            lambda t: _render_band(
                _with_time(st, t), cfg, y0, band, axes,
                pallas_interpret,
            )
        )(ts)
        total = jax.lax.psum(
            jax.lax.psum(overflow.sum(), rows_axis), frame_axis
        )
        return frames, total

    frames, overflow = jax.jit(jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P(), P(frame_axis)),
        out_specs=(P(frame_axis, rows_axis, None, None), P()),
        check_vma=False,
    ))(state, times)
    if return_stats:
        return frames, {"overflow": overflow}
    return frames


def animation_times(start_time: float, num_frames: int, yaw_per_frame: float = 0.01):
    """The reference's animation clock for `num_frames` consecutive frames."""
    t = start_time + yaw_per_frame * (1 + jnp.arange(num_frames, dtype=jnp.float32))
    return jnp.mod(t, XM_2PI)
