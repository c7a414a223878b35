"""Tiled-deferred PBR shading as one Pallas-Triton program per light-cull tile.

The XLA tiled shading (lighting.shade_pbr_tiled) walks every per-tile light
SLOT over the whole frame under a liveness mask, so its cost is
O(cap x pixels) whatever the live counts.  This kernel runs one program per
(TILE x TILE) cull tile: it decodes the G-buffer in registers exactly like
lighting.hlsl:34-40 (gbuffer.decode_gbuffer), reconstructs world positions
from depth, adds the directional GGX term (times the optional shadow
visibility) and then loops over ONLY that tile's live lights from
cull_lights_to_tiles.  It writes linear HDR, so the XLA post chain
(bloom -> tonemap -> gamma -> FXAA) runs unchanged.

The BRDF is lighting.ggx_planar, the same body the XLA paths evaluate; the
XLA shade_pbr_tiled stays the CPU path and the oracle the tests compare to.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import RendererConfig
from ..scene import Lights
from ..xmath import normalize_safe
from .gbuffer import GBuffer
from .lighting import (
    _point_light_attenuation,
    cull_lights_to_tiles,
    ggx_planar,
    normalize3,
)

# Light-cull tile edge: one program shades one TILE x TILE block with that
# tile's light list (the XLA path's default cull tile).
TILE = 32
SHADE_WARPS = 4

# Uniform vector layout (f32).
U_INV_VP = 0      # 16 floats, row-major, row-vector convention
U_EYE = 16        # 3
U_LDIR = 19       # 3 (normalized -lightDirection: toward the light)
U_LCOLOR = 22     # 3
U_AMBIENT = 25
U_W = 26
U_H = 27          # FULL frame height (bands map rows through U_Y0)
U_Y0 = 28         # band row offset (0 for whole frames)
U_SIZE = 32


def _shade_kernel(u_ref, lights_ref, ids_ref, counts_ref, gb0_ref, gb1_ref,
                  depth_ref, *rest, height, width, gamma, has_vis):
    vis_ref, out_ref = rest if has_vis else (None, rest[0])
    ty = pl.program_id(0)
    tx = pl.program_id(1)
    t = ty * pl.num_programs(1) + tx
    shape = (TILE, TILE)
    rows = ty * TILE + jax.lax.broadcasted_iota(jnp.int32, shape, 0)
    cols = tx * TILE + jax.lax.broadcasted_iota(jnp.int32, shape, 1)
    inside = (rows < height) & (cols < width)
    blk = (pl.ds(ty * TILE, TILE), pl.ds(tx * TILE, TILE))

    def load(ref, *ch, other=0.0):
        return plgpu.load(ref.at[blk + ch], mask=inside, other=other)

    def u(i):
        return u_ref[i]

    # G-buffer decode (gbuffer.decode_gbuffer).
    alb = tuple(
        jnp.power(jnp.maximum(load(gb0_ref, c), 0.0), gamma) for c in range(3)
    )
    metal = load(gb0_ref, 3)
    n = normalize3(tuple(load(gb1_ref, c) * 2.0 - 1.0 for c in range(3)))
    rough = load(gb1_ref, 3)
    depth = load(depth_ref, other=1.0)

    # World position (lighting.reconstruct_world_positions).
    ndc_x = (cols.astype(jnp.float32) + 0.5) * (2.0 / u(U_W)) - 1.0
    ndc_y = 1.0 - (
        (u(U_Y0).astype(jnp.int32) + rows).astype(jnp.float32) + 0.5
    ) * (2.0 / u(U_H))
    wh = [
        ndc_x * u(U_INV_VP + j) + ndc_y * u(U_INV_VP + 4 + j)
        + depth * u(U_INV_VP + 8 + j) + u(U_INV_VP + 12 + j)
        for j in range(4)
    ]
    world = tuple(wh[j] / wh[3] for j in range(3))
    v = normalize3(tuple(u(U_EYE + j) - world[j] for j in range(3)))

    ldir = tuple(jnp.full(shape, u(U_LDIR + j), jnp.float32) for j in range(3))
    direct = ggx_planar(n, v, ldir, alb, metal, rough)
    if has_vis:
        vis = load(vis_ref, other=1.0)
        direct = tuple(d * vis for d in direct)
    radiance = tuple(direct[c] * u(U_LCOLOR + c) for c in range(3))

    def light(k, acc):
        lid = ids_ref[t, k]

        def f(col):
            return lights_ref[lid, col]

        to_l = tuple(f(j) - world[j] for j in range(3))
        dist = jnp.sqrt(to_l[0] * to_l[0] + to_l[1] * to_l[1] + to_l[2] * to_l[2])
        dmax = jnp.maximum(dist, 1e-6)
        l = tuple(c / dmax for c in to_l)
        atten = _point_light_attenuation(dist, f(3), f(7))
        brdf = ggx_planar(n, v, l, alb, metal, rough)
        return tuple(acc[c] + brdf[c] * f(4 + c) * atten for c in range(3))

    radiance = jax.lax.fori_loop(0, counts_ref[t], light, radiance)
    covered = depth < 1.0
    for c in range(3):
        out = radiance[c] + u(U_AMBIENT) * alb[c]
        plgpu.store(
            out_ref.at[blk + (c,)], jnp.where(covered, out, 0.0), mask=inside
        )


def light_table(lights: Lights) -> jnp.ndarray:
    """[max(L, 1), 8] point-light rows: pos.xyz, radius, color.rgb, intensity."""
    t = jnp.zeros((max(lights.num_point, 1), 8), jnp.float32)
    if lights.num_point:
        t = t.at[:, 0:3].set(lights.point_position)
        t = t.at[:, 3].set(lights.point_radius)
        t = t.at[:, 4:7].set(lights.point_color)
        t = t.at[:, 7].set(lights.point_intensity)
    return t


def shade_pbr_tiled_pallas(
    gb: GBuffer,
    lights: Lights,
    cfg: RendererConfig,
    view_proj: jnp.ndarray,
    eye: jnp.ndarray,
    shadow_visibility: jnp.ndarray | None = None,
    interpret: bool = False,
    return_overflow: bool = False,
    y_offset=0,
    full_height: int | None = None,
):
    """Tiled-deferred PBR shading -> linear HDR [H, W, 3] (same contract as
    lighting.shade_pbr_tiled: per-tile light lists capped at
    cfg.max_lights_per_tile, overflowing tiles counted loudly).

    `y_offset`/`full_height` shade a horizontal band of a taller framebuffer
    (the screen-sharded multi-chip path): rows map to full-frame NDC and the
    light culling sees the same band offset."""
    H, W = gb.depth.shape
    nty, ntx = -(-H // TILE), -(-W // TILE)
    overflow = jnp.zeros((), jnp.int32)
    if lights.num_point:
        with jax.named_scope("light_cull"):
            tl = cull_lights_to_tiles(
                gb.depth, lights, cfg, view_proj, TILE,
                y_offset=y_offset, full_height=full_height,
            )
        ids = tl.indices.reshape(nty * ntx, -1)
        counts = tl.counts.reshape(-1)
        overflow = tl.overflow
    else:
        ids = jnp.zeros((nty * ntx, 1), jnp.int32)
        counts = jnp.zeros((nty * ntx,), jnp.int32)

    uni = jnp.zeros((U_SIZE,), jnp.float32)
    uni = uni.at[U_INV_VP : U_INV_VP + 16].set(jnp.linalg.inv(view_proj).reshape(-1))
    uni = uni.at[U_EYE : U_EYE + 3].set(eye)
    uni = uni.at[U_LDIR : U_LDIR + 3].set(normalize_safe(-lights.direction))
    uni = uni.at[U_LCOLOR : U_LCOLOR + 3].set(lights.color)
    uni = uni.at[U_AMBIENT].set(cfg.ambient)
    uni = uni.at[U_W].set(float(W))
    uni = uni.at[U_H].set(float(full_height or H))
    uni = uni.at[U_Y0].set(jnp.asarray(y_offset, jnp.float32))

    args = [uni, light_table(lights), ids, counts, gb.gb0, gb.gb1, gb.depth]
    if shadow_visibility is not None:
        args.append(shadow_visibility)
    kernel = functools.partial(
        _shade_kernel, height=H, width=W, gamma=cfg.gamma,
        has_vis=shadow_visibility is not None,
    )
    hdr = pl.pallas_call(
        kernel,
        grid=(nty, ntx),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * len(args),
        out_specs=pl.BlockSpec(memory_space=pl.ANY),
        out_shape=jax.ShapeDtypeStruct((H, W, 3), jnp.float32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=SHADE_WARPS),
        interpret=interpret,
        name="shade_pbr",
    )(*args)
    if return_overflow:
        return hdr, overflow
    return hdr
