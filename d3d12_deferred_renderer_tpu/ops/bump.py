"""Procedural normal mapping (BASELINE config 4).

The reference loads no textures (stb_image is dead code, main.cpp:24-25), so there
are no tangent-space normal maps to sample.  We implement normal mapping the
deferred-renderer way without stored tangents: screen-space derivative bump mapping
(Mikkelsen, "Bump Mapping Unparametrized Surfaces on the GPU").  Tangent/bitangent
are reconstructed per pixel from screen-space derivatives of the world position and
the interpolated uv, and the height field is an analytic procedural pattern of uv —
so the whole thing stays inside the single jitted frame program.

Derivative domain: screen-space differences are taken within BUMP_BLOCK
(8 x 128) screen blocks, clamped at block edges, so a block needs no data
from its neighbours (and bands of the multi-chip path aligned to the block
height need no halo).  This mirrors real GPU derivative semantics (HLSL
ddx/ddy operate on 2x2 quads, not on arbitrary neighbors): the blocks are just
bigger.  At block seams the forward difference is replaced by the previous
column/row's difference (the same edge clamp the full-screen version applied
at the image border).  The block is part of the image's definition, not a
kernel tile: changing it changes the images.
"""
from __future__ import annotations

import jax.lax as _lax
import jax.numpy as jnp

from .raster_ref import FragmentPlanes

# Screen-space derivative block (rows, columns): see the module docstring.
BUMP_BLOCK = (8, 128)


def _ddx_p(a):
    """Forward difference along the last axis, edge-clamped; [..., h, w]."""
    d = a[..., :, 1:] - a[..., :, :-1]
    return jnp.concatenate([d, d[..., :, -1:]], axis=-1)


def _ddy_p(a):
    d = a[..., 1:, :] - a[..., :-1, :]
    return jnp.concatenate([d, d[..., -1:, :]], axis=-2)


def procedural_height_gradient(u: jnp.ndarray, v: jnp.ndarray, freq: float = 24.0):
    """Analytic dh/du, dh/dv of h(u,v) = sin(2*pi*f*u) * sin(2*pi*f*v) / (2*pi*f).

    Evaluated via the product-to-sum identity — cos(a)sin(b) =
    (sin(b+a) + sin(b-a))/2, sin(a)cos(b) = (sin(b+a) - sin(b-a))/2 — so the
    whole gradient costs TWO transcendentals per pixel instead of four.
    Values differ from the textbook form only by rounding (~1 ULP), far inside
    every consumer's tolerance."""
    w = 2.0 * jnp.pi * freq
    s_sum = jnp.sin(w * (v + u))
    s_dif = jnp.sin(w * (v - u))
    dh_du = 0.5 * (s_sum + s_dif)
    dh_dv = 0.5 * (s_sum - s_dif)
    return dh_du, dh_dv


def bump_planar(world, uv, n, mid, strength: float, freq: float):
    """Perturb normals within one derivative block (channel-planar form).

    world = (wx, wy, wz), uv = (u, v), n = (nx, ny, nz): arrays [..., h, w]
    where (h, w) is the derivative block (leading batch dims allowed).  ``mid``
    is the mesh id as FLOAT with -1.0 for background.  Returns the perturbed
    (nx, ny, nz).  Pixels whose derivative taps cross meshes, hit background,
    or have a degenerate uv mapping keep their geometric normal.

    Only elementwise jnp ops over the block axes.
    """
    wx, wy, wz = world
    u, v = uv
    nx, ny, nz = n

    dp_dx = (_ddx_p(wx), _ddx_p(wy), _ddx_p(wz))
    dp_dy = (_ddy_p(wx), _ddy_p(wy), _ddy_p(wz))
    du_dx, dv_dx = _ddx_p(u), _ddx_p(v)
    du_dy, dv_dy = _ddy_p(u), _ddy_p(v)

    # Solve for the uv-aligned surface tangents T (d world / d u) and B:
    #   [dp_dx]   [du_dx dv_dx] [T]
    #   [dp_dy] = [du_dy dv_dy] [B]
    det = du_dx * dv_dy - dv_dx * du_dy
    safe_det = jnp.where(jnp.abs(det) < 1e-12, 1.0, det)
    inv = 1.0 / safe_det
    T = tuple((dp_dx[i] * dv_dy - dp_dy[i] * dv_dx) * inv for i in range(3))
    B = tuple((dp_dy[i] * du_dx - dp_dx[i] * du_dy) * inv for i in range(3))

    dh_du, dh_dv = procedural_height_gradient(u, v, freq)

    # rsqrt instead of sqrt-then-divide throughout.  Values move ~1 ULP
    # (inside every consumer's tolerance; parity tests are tolerance-based).
    nlen2 = nx * nx + ny * ny + nz * nz
    inv_nlen = jnp.where(nlen2 == 0.0, 1.0, _lax.rsqrt(jnp.maximum(nlen2, 1e-38)))
    nu = (nx * inv_nlen, ny * inv_nlen, nz * inv_nlen)

    # Project tangents off the normal (keep perturbation in the tangent plane),
    # normalize to bound the bump slope independent of uv parameterization scale.
    def tangentize(t):
        dot = t[0] * nu[0] + t[1] * nu[1] + t[2] * nu[2]
        t = tuple(t[i] - dot * nu[i] for i in range(3))
        norm2 = t[0] * t[0] + t[1] * t[1] + t[2] * t[2]
        inv_t = jnp.where(
            norm2 < 1e-24, 1.0, _lax.rsqrt(jnp.maximum(norm2, 1e-38))
        )
        return tuple(c * inv_t for c in t)

    Tt, Bt = tangentize(T), tangentize(B)
    pert = tuple(
        nu[i] - strength * (dh_du * Tt[i] + dh_dv * Bt[i]) for i in range(3)
    )
    pn2 = pert[0] * pert[0] + pert[1] * pert[1] + pert[2] * pert[2]
    inv_pn = jnp.where(pn2 == 0.0, 1.0, _lax.rsqrt(jnp.maximum(pn2, 1e-38)))
    pert = tuple(c * inv_pn for c in pert)

    # Validity: same mesh under all derivative taps, nondegenerate uv mapping.
    # The edge pad REPLICATES the last comparison, exactly as _ddx_p/_ddy_p
    # replicate the last difference: the final column's derivative taps the
    # (w-2, w-1) pair, so its validity is that pair's comparison (padding ones
    # would perturb edge pixels with a garbage cross-mesh tangent).
    sx = (mid[..., :, 1:] == mid[..., :, :-1]).astype(jnp.float32)
    same_x = jnp.concatenate([sx, sx[..., :, -1:]], axis=-1)
    sy = (mid[..., 1:, :] == mid[..., :-1, :]).astype(jnp.float32)
    same_y = jnp.concatenate([sy, sy[..., -1:, :]], axis=-2)
    ok = (
        (mid >= 0.0) & (same_x > 0.5) & (same_y > 0.5)
        & (jnp.abs(det) >= 1e-12)
    )
    return tuple(jnp.where(ok, pert[i], n[i]) for i in range(3))


def apply_normal_mapping(
    frags: FragmentPlanes,
    world_pos: jnp.ndarray,
    strength: float = 0.35,
    freq: float = 24.0,
) -> FragmentPlanes:
    """Perturb fragment normals with the procedural height field.

    world_pos: [H, W, 3] reconstructed positions (reused from the lighting path).
    Derivatives are block-local over BUMP_BLOCK screen blocks (see module
    docstring); out-of-image padding counts as background, so pixels on a
    partial block's image edge keep their geometric normal.
    """
    H, W = frags.depth.shape
    bh, bw = BUMP_BLOCK
    nby, nbx = -(-H // bh), -(-W // bw)
    Hp, Wp = nby * bh, nbx * bw

    def blocks(a, fill):
        a = jnp.pad(a, ((0, Hp - H), (0, Wp - W)), constant_values=fill)
        # [Hp, Wp] -> [nby, nbx, bh, bw]
        return a.reshape(nby, bh, nbx, bw).transpose(0, 2, 1, 3)

    def unblocks(a):
        return a.transpose(0, 2, 1, 3).reshape(Hp, Wp)[:H, :W]

    world = tuple(blocks(world_pos[..., i], 0.0) for i in range(3))
    uv = tuple(blocks(frags.uv[..., i], 0.0) for i in range(2))
    n = tuple(blocks(frags.normal[..., i], 0.0) for i in range(3))
    mid = blocks(frags.mesh_id.astype(jnp.float32), -1.0)

    out = bump_planar(world, uv, n, mid, strength, freq)
    new_normal = jnp.stack([unblocks(c) for c in out], axis=-1)
    return frags._replace(normal=new_normal)
