"""Reference rasterizer: pure jnp, full-screen per triangle, golden-model semantics.

This is the semantics-defining implementation of the geometry pass (the D3D12
hardware rasterizer + geometry.hlsl in the reference).  It runs everywhere (CPU
backend included — BASELINE config 1) and the Pallas tile-binned rasterizer
(raster_pallas.py) is tested for exact agreement against it.

Rasterization rules implemented (matching D3D11/12 functional spec):
- sample at pixel centers (px + 0.5, py + 0.5);
- top-left fill rule for pixel centers exactly on an edge;
- depth test LESS against a buffer cleared to 1.0 (main.cpp:194, 763);
- per-pixel depth clip to [0, 1] (DepthClipEnable=TRUE, main.cpp:735);
- perspective-correct attribute interpolation (HLSL default `linear` modifier):
  attributes are interpolated as attr/w and renormalized by interpolated 1/w.

Output is the raw rasterization result ("fragment planes"), format-agnostic;
gbuffer.py applies the reference's render-target quantization on top.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..config import RendererConfig
from .transform import (
    TRI_AREA,
    TRI_MESH_ID,
    TRI_N0,
    TRI_N1,
    TRI_N2,
    TRI_RW0,
    TRI_RW1,
    TRI_RW2,
    TRI_UV0,
    TRI_UV1,
    TRI_UV2,
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
    TriSetup,
)


class FragmentPlanes(NamedTuple):
    """Raw per-pixel rasterization output (pre-quantization)."""

    depth: jnp.ndarray    # [H, W] float32, cleared to 1.0
    normal: jnp.ndarray   # [H, W, 3] world-space, unnormalized interpolant
    uv: jnp.ndarray       # [H, W, 2]
    mesh_id: jnp.ndarray  # [H, W] int32, -1 where no fragment


def _edge_coeffs(ax, ay, bx, by):
    """Edge function e(p) = A*px + B*py + C = cross2d(b - a, p - a) for directed
    edge a->b, plus the top-left tie-break bias.  With canonical positive-area
    winding, e > 0 strictly inside; pixel centers with e == 0 count iff the edge is
    a top edge (horizontal, interior below: dy==0, dx>0) or a left edge (dy<0),
    matching the D3D fill rule in y-down render-target space."""
    A = ay - by
    B = bx - ax
    C = ax * by - bx * ay
    dx = bx - ax
    dy = by - ay
    is_top = (dy == 0.0) & (dx > 0.0)
    is_left = dy < 0.0
    return A, B, C, (is_top | is_left)


def rasterize_packed(
    packed: jnp.ndarray, height: int, width: int, px=None, py=None
) -> FragmentPlanes:
    """Rasterize packed triangle records over an (height x width) pixel grid.

    `px`, `py` optionally override the pixel-center coordinate grids (used by the
    tile kernels to rasterize a sub-rectangle in the same code path).
    """
    if px is None or py is None:
        ys = jnp.arange(height, dtype=jnp.float32) + 0.5
        xs = jnp.arange(width, dtype=jnp.float32) + 0.5
        py, px = jnp.meshgrid(ys, xs, indexing="ij")  # [H, W]

    init = FragmentPlanes(
        depth=jnp.ones((height, width), jnp.float32),
        normal=jnp.zeros((height, width, 3), jnp.float32),
        uv=jnp.zeros((height, width, 2), jnp.float32),
        mesh_id=jnp.full((height, width), -1, jnp.int32),
    )

    def body(state: FragmentPlanes, tri: jnp.ndarray):
        x0, y0 = tri[TRI_X0], tri[TRI_Y0]
        x1, y1 = tri[TRI_X1], tri[TRI_Y1]
        x2, y2 = tri[TRI_X2], tri[TRI_Y2]

        # Barycentric edge functions: w0 from edge (v1->v2), etc.
        A0, B0, C0, tl0 = _edge_coeffs(x1, y1, x2, y2)
        A1, B1, C1, tl1 = _edge_coeffs(x2, y2, x0, y0)
        A2, B2, C2, tl2 = _edge_coeffs(x0, y0, x1, y1)

        e0 = A0 * px + B0 * py + C0
        e1 = A1 * px + B1 * py + C1
        e2 = A2 * px + B2 * py + C2

        def cov(e, tl):
            return (e > 0.0) | ((e == 0.0) & tl)

        covered = cov(e0, tl0) & cov(e1, tl1) & cov(e2, tl2)

        inv_area = 1.0 / tri[TRI_AREA]
        b0 = e0 * inv_area
        b1 = e1 * inv_area
        b2 = e2 * inv_area

        z = b0 * tri[TRI_Z0] + b1 * tri[TRI_Z1] + b2 * tri[TRI_Z2]
        passes = (
            covered
            & (tri[TRI_VALID] > 0.0)
            & (z < state.depth)
            & (z >= 0.0)
            & (z <= 1.0)
        )

        rw = b0 * tri[TRI_RW0] + b1 * tri[TRI_RW1] + b2 * tri[TRI_RW2]
        inv_rw = 1.0 / jnp.where(rw == 0.0, 1.0, rw)

        def interp(v0, v1, v2):
            # Elementwise float32 sum, not a matrix product: no TF32 rounding
            # on GPUs, and the same expression the tile kernel evaluates.
            a = (
                b0[..., None] * tri[v0]
                + b1[..., None] * tri[v1]
                + b2[..., None] * tri[v2]
            )
            return a * inv_rw[..., None]

        normal = interp(  # [H, W, 3]
            slice(TRI_N0, TRI_N0 + 3), slice(TRI_N1, TRI_N1 + 3),
            slice(TRI_N2, TRI_N2 + 3),
        )
        uv = interp(  # [H, W, 2]
            slice(TRI_UV0, TRI_UV0 + 2), slice(TRI_UV1, TRI_UV1 + 2),
            slice(TRI_UV2, TRI_UV2 + 2),
        )

        new = FragmentPlanes(
            depth=jnp.where(passes, z, state.depth),
            normal=jnp.where(passes[..., None], normal, state.normal),
            uv=jnp.where(passes[..., None], uv, state.uv),
            mesh_id=jnp.where(passes, tri[TRI_MESH_ID].astype(jnp.int32), state.mesh_id),
        )
        return new, None

    out, _ = jax.lax.scan(body, init, packed)
    return out


def rasterize(tris: TriSetup, cfg: RendererConfig) -> FragmentPlanes:
    return rasterize_packed(tris.packed, cfg.height, cfg.width)
