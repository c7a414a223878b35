"""Texture sampling: the lighting pass's static linear-clamp sampler (C10 analog).

The reference binds a MIN_MAG_MIP_LINEAR / CLAMP static sampler (main.cpp:632-638)
and samples the G-buffer with uv = pixel center / resolution (lighting.hlsl:34-35)
— which lands exactly on texel centers, so bilinear == nearest there and the
lighting path reads the G-buffer directly.  This module provides the general
sampler for every case where the uv grid does NOT align (shadow-map lookups,
post-process chains, future texture support), with D3D texel addressing:
texel i covers [i, i+1), centers at i+0.5, CLAMP addressing.
"""
from __future__ import annotations

import jax.numpy as jnp


def sample_nearest(tex: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """tex [Ht, Wt, C] or [Ht, Wt]; uv [..., 2] in [0,1] -> [..., C]."""
    Ht, Wt = tex.shape[0], tex.shape[1]
    x = jnp.clip(jnp.floor(uv[..., 0] * Wt).astype(jnp.int32), 0, Wt - 1)
    y = jnp.clip(jnp.floor(uv[..., 1] * Ht).astype(jnp.int32), 0, Ht - 1)
    return tex[y, x]


def sample_bilinear(tex: jnp.ndarray, uv: jnp.ndarray) -> jnp.ndarray:
    """Bilinear filtering with CLAMP addressing (D3D11 functional-spec weights).

    tex [Ht, Wt, C] or [Ht, Wt]; uv [..., 2] in [0,1] -> [..., C] / [...]."""
    Ht, Wt = tex.shape[0], tex.shape[1]
    fx = uv[..., 0] * Wt - 0.5
    fy = uv[..., 1] * Ht - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = fx - x0
    ty = fy - y0

    def at(xi, yi):
        xi = jnp.clip(xi.astype(jnp.int32), 0, Wt - 1)
        yi = jnp.clip(yi.astype(jnp.int32), 0, Ht - 1)
        return tex[yi, xi]

    c00 = at(x0, y0)
    c10 = at(x0 + 1, y0)
    c01 = at(x0, y0 + 1)
    c11 = at(x0 + 1, y0 + 1)
    if tex.ndim == 3:
        tx = tx[..., None]
        ty = ty[..., None]
    top = c00 + (c10 - c00) * tx
    bot = c01 + (c11 - c01) * tx
    return top + (bot - top) * ty


def pack_cmp_quads(tex: jnp.ndarray) -> jnp.ndarray:
    """Quad-pack a depth map for one-gather bilinear footprints.

    Returns [(Ht+1)*(Wt+1), 8] where row (y0+1)*(Wt+1)+(x0+1) holds the 2x2
    CLAMP-addressed footprint (c00, c10, c01, c11) at integer base (x0, y0),
    x0 in [-1, Wt-1], padded to 8 lanes (zeros in 4..7).  Edge replication
    reproduces per-tap CLAMP exactly.  One row-gather of the packed table
    replaces four element-gathers (32-byte rows)."""
    p = jnp.pad(tex, ((1, 1), (1, 1)), mode="edge")
    z = jnp.zeros_like(p[:-1, :-1])
    quads = jnp.stack(
        [p[:-1, :-1], p[:-1, 1:], p[1:, :-1], p[1:, 1:], z, z, z, z], -1
    )
    return quads.reshape(-1, 8)


def pack_cmp_windows(tex: jnp.ndarray) -> jnp.ndarray:
    """Window-pack a depth map for one-gather 4x4 footprints.

    Returns [(Ht+1)*(Wt+1), 16] where row (y0+1)*(Wt+1)+(x0+1) holds the 4x4
    CLAMP-addressed texel window at integer base (x0, y0), x0 in [-1, Wt-1],
    row-major (lane 4*i+j = texel (y0+i, x0+j)).  Edge replication reproduces
    per-tap CLAMP exactly, same as pack_cmp_quads.  One window row covers the
    2x2 bilinear footprints of a whole 2x2 PIXEL quad whenever the quad's
    footprint bases span <= 2 texels per axis — one row-gather then serves
    four pixels (the sparse-PCF fast path, ops/shadows.py); lanes (0, 1, 4, 5)
    of a single pixel's own window are exactly its pack_cmp_quads footprint,
    which is what the wide-quad fallback uses."""
    p = jnp.pad(tex, ((1, 3), (1, 3)), mode="edge")
    Ht, Wt = tex.shape
    wins = jnp.stack(
        [p[i : i + Ht + 1, j : j + Wt + 1] for i in range(4) for j in range(4)],
        axis=-1,
    )
    return wins.reshape(-1, 16)


def sample_bilinear_cmp(
    tex: jnp.ndarray,
    uv: jnp.ndarray,
    ref: jnp.ndarray,
    bias: float = 0.0,
    packed: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """D3D comparison sampler (SampleCmp with LESS_EQUAL + linear filtering):
    compare `ref <= texel + bias` at each of the 2x2 footprint texels FIRST,
    then bilinearly weight the binary results — percentage-closer filtering
    with the same texel addressing/weights as sample_bilinear.

    All four footprint taps come from ONE row-gather of the quad-packed map
    (pack_cmp_quads) — bit-identical to four clamped element-gathers.  When
    sampling the same map many times, pre-pack once and
    pass packed= (e.g. per frame); tex is still required for the shape.

    tex [Ht, Wt]; uv [..., 2] in [0,1]; ref [...] -> visibility [...] in [0,1].
    """
    Ht, Wt = tex.shape[0], tex.shape[1]
    qflat = pack_cmp_quads(tex) if packed is None else packed
    fx = uv[..., 0] * Wt - 0.5
    fy = uv[..., 1] * Ht - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = fx - x0
    ty = fy - y0

    # Clamping the BASE (not each tap) is exact: whenever the clamp engages,
    # the replicated-edge quad holds equal texels, so the blend is invariant.
    xi = jnp.clip(x0.astype(jnp.int32), -1, Wt - 1) + 1
    yi = jnp.clip(y0.astype(jnp.int32), -1, Ht - 1) + 1
    taps = qflat[yi * (Wt + 1) + xi]  # [..., 4] — one gather
    c = (ref[..., None] <= taps + bias).astype(jnp.float32)
    top = c[..., 0] + (c[..., 1] - c[..., 0]) * tx
    bot = c[..., 2] + (c[..., 3] - c[..., 2]) * tx
    return top + (bot - top) * ty
