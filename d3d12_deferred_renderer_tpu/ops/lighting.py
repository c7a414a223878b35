"""Deferred lighting: reference-parity Lambert and Cook-Torrance PBR with
per-tile light culling.

Parity path (``shade_lambert``) reproduces lighting.hlsl:32-51 exactly: decode the
quantized G-buffer, one directional light, Lambert diffuse + constant ambient 0.3,
gamma out.  Metalness/roughness are decoded but unused — the reference samples them
without consuming them (a preserved quirk).

PBR path (``shade_pbr`` / tiled variant) implements Cook-Torrance GGX over the same
G-buffer for BASELINE configs 2-5: N point lights with windowed inverse-square
falloff plus the directional light, world position reconstructed from the depth
buffer through the inverse view-projection (the standard deferred reconstruction the
reference never needed with a single directional light).

Per-tile light culling: the screen is divided into tiles; each tile's pixel footprint
+ min/max depth defines a world-space AABB, tested against every light's influence
sphere; surviving light indices are compacted per tile (top_k).  The shading loop
then only visits a tile's surviving lights — the rasterizer analog of block-sparse
attention.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import RendererConfig
from ..scene import Lights
from .gbuffer import GBuffer, decode_gbuffer


from ..xmath import normalize_safe as _normalize  # shared zero-guarded normalize

_HIGHEST = jax.lax.Precision.HIGHEST


def shade_lambert(gb: GBuffer, lights: Lights, cfg: RendererConfig) -> jnp.ndarray:
    """Reference lighting pass (lighting.hlsl:32-51) -> display-ready [H,W,3] in [0,1].

    Runs on EVERY pixel — the fullscreen triangle covers the whole target with depth
    test disabled (main.cpp:307, 815-816), so background pixels shade the cleared
    G-buffer (to black), overwriting the cornflower clear."""
    d = decode_gbuffer(gb, cfg)
    L = _normalize(-lights.direction)
    brightness = jnp.clip(
        jnp.einsum("hwc,c->hw", d.normal, L, precision=_HIGHEST), 0.0, 1.0
    )
    color = d.albedo * (cfg.ambient + lights.color * brightness[..., None])
    return jnp.power(jnp.maximum(color, 0.0), 1.0 / cfg.gamma)


def reconstruct_world_positions(
    depth: jnp.ndarray,
    view_proj: jnp.ndarray,
    cfg: RendererConfig,
    y_offset=0,
    full_height: int | None = None,
) -> jnp.ndarray:
    """Per-pixel world position from NDC depth via the inverse view-projection.

    Inverts the D3D viewport transform used in triangle_setup: pixel centers at
    +0.5, y flipped, z = stored depth; row-vector convention throughout.
    `y_offset`/`full_height` support rendering a horizontal band of a taller
    framebuffer (screen-sharded multi-chip rendering)."""
    H, W = depth.shape
    FH = full_height or H
    xs = (jnp.arange(W, dtype=jnp.float32) + 0.5) * (2.0 / W) - 1.0
    ys = 1.0 - (y_offset + jnp.arange(H, dtype=jnp.float32) + 0.5) * (2.0 / FH)
    ndc_y, ndc_x = jnp.meshgrid(ys, xs, indexing="ij")
    m = jnp.linalg.inv(view_proj)
    # (ndc_x, ndc_y, depth, 1) @ inv_vp as an elementwise float32 sum in a
    # fixed order (the Triton shading kernel evaluates the same expression):
    # at depths near 1 the reconstruction cancels, so the order shows.
    wh = [
        ndc_x * m[0, j] + ndc_y * m[1, j] + depth * m[2, j] + m[3, j]
        for j in range(4)
    ]
    return jnp.stack([wh[j] / wh[3] for j in range(3)], axis=-1)


# ---------------------------------------------------------------------------
# Cook-Torrance GGX
# ---------------------------------------------------------------------------

def ggx_planar(n, v, l, albedo, metalness, roughness):
    """Cook-Torrance specular + energy-conserving Lambert diffuse, times NdotL.

    Channel-planar form: n, v, l and albedo are 3-tuples of same-shaped
    arrays, metalness and roughness arrays of that shape; returns the 3-tuple
    radiance factor to be multiplied by light color.  The single BRDF body of
    the XLA shading paths and the Triton shading kernel (ops/lighting_pallas.py),
    whose blocks have no small channel axis to reduce over."""

    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    h = normalize3(tuple(v[i] + l[i] for i in range(3)))
    ndl = jnp.maximum(dot(n, l), 0.0)
    ndv = jnp.maximum(dot(n, v), 1e-4)
    ndh = jnp.maximum(dot(n, h), 0.0)
    vdh = jnp.maximum(dot(v, h), 0.0)

    alpha = jnp.maximum(roughness * roughness, 1e-3)
    a2 = alpha * alpha
    denom = ndh * ndh * (a2 - 1.0) + 1.0
    D = a2 / (jnp.pi * denom * denom)

    k = (roughness + 1.0) ** 2 / 8.0
    g1 = ndv / (ndv * (1.0 - k) + k)
    g2 = ndl / (ndl * (1.0 - k) + k + 1e-7)
    DG = D * (g1 * g2)
    fresnel = jnp.power(1.0 - vdh, 5.0)
    spec_den = 4.0 * ndv * ndl + 1e-4

    out = []
    for c in range(3):
        f0 = 0.04 * (1.0 - metalness) + albedo[c] * metalness
        F = f0 + (1.0 - f0) * fresnel
        spec = DG * F / spec_den
        diffuse = (1.0 - F) * (1.0 - metalness) * albedo[c] / jnp.pi
        out.append((diffuse + spec) * ndl)
    return tuple(out)


def normalize3(v):
    """normalize_safe over a planar 3-tuple (zero vectors pass unchanged)."""
    n = jnp.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    n = jnp.where(n == 0.0, 1.0, n)
    return tuple(c / n for c in v)


def _planes(a):
    return tuple(a[..., i] for i in range(a.shape[-1]))


def _ggx_brdf(n, v, l, albedo, metalness, roughness):
    """ggx_planar over stacked [..., 3] vectors (broadcasting); returns the
    stacked [..., 3] radiance factor."""
    shape = jnp.broadcast_shapes(
        n.shape, v.shape, l.shape, albedo.shape, metalness.shape + (3,)
    )

    def b(a):
        return _planes(jnp.broadcast_to(a, shape))

    out = ggx_planar(b(n), b(v), b(l), b(albedo), metalness, roughness)
    return jnp.stack(out, axis=-1)


def _point_light_attenuation(dist, radius, intensity):
    """Windowed inverse-square falloff, zero at the influence radius (so per-tile
    culling is exact, not an approximation)."""
    window = jnp.clip(1.0 - (dist / radius) ** 4, 0.0, 1.0) ** 2
    return intensity * window / (dist * dist + 1.0)


def shade_pbr(
    gb: GBuffer,
    lights: Lights,
    cfg: RendererConfig,
    view_proj: jnp.ndarray,
    eye: jnp.ndarray,
    shadow_visibility: jnp.ndarray | None = None,
    y_offset=0,
    full_height: int | None = None,
) -> jnp.ndarray:
    """Unculled PBR shading (every light at every pixel) -> linear HDR [H,W,3].

    The exact-but-slow baseline the tiled/culled paths are verified against."""
    d = decode_gbuffer(gb, cfg)
    world = reconstruct_world_positions(
        gb.depth, view_proj, cfg, y_offset, full_height
    )
    v = _normalize(eye - world)

    # Directional light.
    ldir = _normalize(-lights.direction)
    direct = _ggx_brdf(d.normal, v, ldir, d.albedo, d.metalness, d.roughness)
    if shadow_visibility is not None:
        direct = direct * shadow_visibility[..., None]
    radiance = direct * lights.color

    # Point lights: scan to bound memory (the Pallas kernel is the fast path).
    def body(acc, light):
        pos, color, radius, intensity = light
        to_l = pos - world
        dist = jnp.linalg.norm(to_l, axis=-1)
        l = to_l / jnp.maximum(dist, 1e-6)[..., None]
        atten = _point_light_attenuation(dist, radius, intensity)
        brdf = _ggx_brdf(d.normal, v, l, d.albedo, d.metalness, d.roughness)
        return acc + brdf * color * atten[..., None], None

    if lights.num_point:
        radiance, _ = jax.lax.scan(
            body,
            radiance,
            (
                lights.point_position,
                lights.point_color,
                lights.point_radius,
                lights.point_intensity,
            ),
        )

    ambient = cfg.ambient * d.albedo
    out = radiance + ambient
    covered = gb.depth < 1.0
    return jnp.where(covered[..., None], out, 0.0)


# ---------------------------------------------------------------------------
# Per-tile light culling
# ---------------------------------------------------------------------------

class TileLights(NamedTuple):
    indices: jnp.ndarray  # [ty, tx, K] int32 light ids (compacted, padded)
    counts: jnp.ndarray   # [ty, tx] int32 (clamped to K)
    overflow: jnp.ndarray  # [] int32 — tiles whose true light count exceeded K


def cull_lights_to_tiles(
    depth: jnp.ndarray,
    lights: Lights,
    cfg: RendererConfig,
    view_proj: jnp.ndarray,
    tile: int = 32,
    max_per_tile: int | None = None,
    y_offset=0,
    full_height: int | None = None,
) -> TileLights:
    """Light-sphere vs tile world-AABB culling.

    Each (tile_h x tile_w) screen block's 4 corners at its min/max depth give 8
    points; pushed through inv(view_proj) they bound the tile's visible geometry in
    world space.  A point light affects the tile iff its influence sphere intersects
    that AABB.  Empty tiles (no geometry) cull everything.

    `tile` is a square size (int) or a (tile_h, tile_w) pair — the Pallas paths
    cull on their native (cfg.tile_h, cfg.tile_w) grid."""
    H, W = depth.shape
    FH = full_height or H
    K = max_per_tile or cfg.max_lights_per_tile
    th, tw = (tile, tile) if isinstance(tile, int) else tile
    ty, tx = -(-H // th), -(-W // tw)
    # Pad to whole tiles with background depth (1.0): padded area culls as
    # no-geometry; partially-padded border tiles only grow their AABB
    # (conservative — culling stays exact).
    if (ty * th, tx * tw) != (H, W):
        depth = jnp.pad(
            depth, ((0, ty * th - H), (0, tx * tw - W)), constant_values=1.0
        )
    d_t = depth.reshape(ty, th, tx, tw)
    zmin = d_t.min(axis=(1, 3))
    has_geo = zmin < 1.0
    # Max over COVERED pixels only (depth < 1.0): background must not stretch the
    # AABB to the far plane, but an epsilon clamp would wrongly cull lights that
    # only reach pixels with depth in (1-eps, 1).  inv(view_proj) is finite at
    # any covered depth, so no clamp is needed.
    covered_t = d_t < 1.0
    zmax = jnp.where(covered_t, d_t, -jnp.inf).max(axis=(1, 3))
    zmax = jnp.where(has_geo, zmax, zmin)

    xs0 = jnp.arange(tx, dtype=jnp.float32) * tw * (2.0 / W) - 1.0
    xs1 = (jnp.arange(tx, dtype=jnp.float32) + 1) * tw * (2.0 / W) - 1.0
    ys0 = 1.0 - (y_offset + jnp.arange(ty, dtype=jnp.float32) * th) * (2.0 / FH)
    ys1 = 1.0 - (y_offset + (jnp.arange(ty, dtype=jnp.float32) + 1) * th) * (2.0 / FH)

    inv_vp = jnp.linalg.inv(view_proj)

    def corner(x, y, z):  # x:[tx] or [ty,tx] ...
        xg = jnp.broadcast_to(x[None, :], (ty, tx))
        yg = jnp.broadcast_to(y[:, None], (ty, tx))
        h = jnp.stack([xg, yg, z, jnp.ones_like(z)], -1)
        w = jnp.einsum("yxi,ij->yxj", h, inv_vp, precision=_HIGHEST)
        return w[..., :3] / w[..., 3:4]

    def sphere_hits_slab(z0, z1, alive):
        """[ty, tx, L] bool: light sphere vs the tile's world AABB for the
        depth slab [z0, z1] (conservative: the AABB contains the slab)."""
        corners = jnp.stack(
            [
                corner(xs, ys, z)
                for xs in (xs0, xs1)
                for ys in (ys0, ys1)
                for z in (z0, z1)
            ]
        )  # [8, ty, tx, 3]
        bmin = corners.min(axis=0)
        bmax = corners.max(axis=0)
        c = lights.point_position  # [L, 3]
        r = lights.point_radius    # [L]
        delta = jnp.maximum(
            jnp.maximum(bmin[:, :, None, :] - c, c - bmax[:, :, None, :]), 0.0
        )  # [ty, tx, L, 3]
        dist2 = jnp.sum(delta * delta, axis=-1)
        return (dist2 <= (r * r)) & alive[..., None]

    # NDC depth compresses distant geometry near 1.0, so a single
    # [zmin, zmax] slab for a tile spanning any depth range unprojects to an
    # enormous world box and keeps far more lights than reach any pixel.
    # Split each tile's slab at the WORLD-depth midpoint (z = A + B/w for the
    # D3D perspective projection) and take the union of the two slabs'
    # intersections — still conservative (the union contains every covered
    # pixel), typically several times tighter on deep tiles.
    A = cfg.z_far / (cfg.z_far - cfg.z_near)
    B = -cfg.z_far * cfg.z_near / (cfg.z_far - cfg.z_near)
    w0 = B / jnp.minimum(zmin - A, -1e-12)
    w1 = B / jnp.minimum(zmax - A, -1e-12)
    zmid = A + B / (0.5 * (w0 + w1))
    zmid = jnp.clip(zmid, zmin, zmax)

    lo = covered_t & (d_t <= zmid[:, None, :, None])
    hi = covered_t & (d_t > zmid[:, None, :, None])
    zmin_lo = jnp.where(lo, d_t, jnp.inf).min(axis=(1, 3))
    zmax_lo = jnp.where(lo, d_t, -jnp.inf).max(axis=(1, 3))
    zmin_hi = jnp.where(hi, d_t, jnp.inf).min(axis=(1, 3))
    zmax_hi = jnp.where(hi, d_t, -jnp.inf).max(axis=(1, 3))
    has_lo = jnp.isfinite(zmin_lo)
    has_hi = jnp.isfinite(zmin_hi)
    zmin_lo = jnp.where(has_lo, zmin_lo, zmin)
    zmax_lo = jnp.where(has_lo, zmax_lo, zmin)
    zmin_hi = jnp.where(has_hi, zmin_hi, zmax)
    zmax_hi = jnp.where(has_hi, zmax_hi, zmax)

    affects = sphere_hits_slab(zmin_lo, zmax_lo, has_geo & has_lo) | (
        sphere_hits_slab(zmin_hi, zmax_hi, has_geo & has_hi)
    )  # [ty, tx, L]

    # Compact to at most K indices per tile; lax.top_k keeps lowest indices on ties.
    L = affects.shape[-1]
    k = min(K, L)
    score = affects.astype(jnp.float32)
    _, idx = jax.lax.top_k(score, k)
    true_counts = jnp.sum(affects, axis=-1)
    counts = jnp.minimum(true_counts, k).astype(jnp.int32)
    overflow = jnp.sum(true_counts > k).astype(jnp.int32)
    return TileLights(indices=idx.astype(jnp.int32), counts=counts, overflow=overflow)


def shade_pbr_tiled(
    gb: GBuffer,
    lights: Lights,
    cfg: RendererConfig,
    view_proj: jnp.ndarray,
    eye: jnp.ndarray,
    tile: int = 32,
    shadow_visibility: jnp.ndarray | None = None,
    y_offset=0,
    full_height: int | None = None,
    return_overflow: bool = False,
):
    """PBR shading with per-tile light culling (pure-XLA path; the Pallas lighting
    kernel, ops/lighting_pallas.py, walks only the live lights).  Exactly equals
    shade_pbr WHEN no tile's live-light count exceeds cfg.max_lights_per_tile —
    overflowing tiles drop their excess lights.  Pass return_overflow=True to
    get (hdr, overflow) where overflow counts such tiles (frame.render threads
    it to the runtime overflow warning; the flagship config sizes the cap at
    the full light count so overflow is structurally zero)."""
    d = decode_gbuffer(gb, cfg)
    world = reconstruct_world_positions(
        gb.depth, view_proj, cfg, y_offset, full_height
    )
    v = _normalize(eye - world)

    ldir = _normalize(-lights.direction)
    direct = _ggx_brdf(d.normal, v, ldir, d.albedo, d.metalness, d.roughness)
    if shadow_visibility is not None:
        direct = direct * shadow_visibility[..., None]
    radiance = direct * lights.color

    overflow = jnp.zeros((), jnp.int32)
    if lights.num_point:
        H, W = gb.depth.shape
        ty, tx = -(-H // tile), -(-W // tile)
        Hp, Wp = ty * tile, tx * tile
        with jax.named_scope("light_cull"):
            tl = cull_lights_to_tiles(
                gb.depth, lights, cfg, view_proj, tile,
                y_offset=y_offset, full_height=full_height,
            )
        overflow = tl.overflow

        def tiled(a):  # [H, W, C] -> [ty, tx, tile, tile, C] (zero-pad border)
            if (Hp, Wp) != (H, W):
                a = jnp.pad(a, ((0, Hp - H), (0, Wp - W), (0, 0)))
            return a.reshape(ty, tile, tx, tile, -1).transpose(0, 2, 1, 3, 4)

        n_t, alb_t = tiled(d.normal), tiled(d.albedo)
        met_t = tiled(d.metalness[..., None])[..., 0]
        rgh_t = tiled(d.roughness[..., None])[..., 0]
        wld_t, v_t = tiled(world), tiled(v)
        acc0 = tiled(radiance)

        K = tl.indices.shape[-1]

        def body(acc, k):
            lid = tl.indices[:, :, k]  # [ty, tx]
            live = (k < tl.counts)[..., None, None]  # [ty, tx, 1, 1]
            pos = lights.point_position[lid][:, :, None, None, :]
            col = lights.point_color[lid][:, :, None, None, :]
            rad = lights.point_radius[lid][:, :, None, None]
            inten = lights.point_intensity[lid][:, :, None, None]
            to_l = pos - wld_t
            dist = jnp.linalg.norm(to_l, axis=-1)
            l = to_l / jnp.maximum(dist, 1e-6)[..., None]
            atten = _point_light_attenuation(dist, rad, inten)
            brdf = _ggx_brdf(n_t, v_t, l, alb_t, met_t, rgh_t)
            contrib = brdf * col * atten[..., None]
            return acc + jnp.where(live[..., None], contrib, 0.0), None

        acc, _ = jax.lax.scan(body, acc0, jnp.arange(K))
        radiance = acc.transpose(0, 2, 1, 3, 4).reshape(Hp, Wp, 3)[:H, :W]

    out = radiance + cfg.ambient * d.albedo
    covered = gb.depth < 1.0
    out = jnp.where(covered[..., None], out, 0.0)
    if return_overflow:
        return out, overflow
    return out
