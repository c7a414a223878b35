"""Directional-light shadow mapping (BASELINE config 4).

Absent from the reference (single unshadowed directional light, main.cpp:245-247);
added as a capability extension.  The shadow map is a depth-only render from the
light's orthographic view, produced by the SAME rasterizer as the main geometry pass
— one more pallas_call/XLA fragment inside the single frame program.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from .. import xmath
from ..config import RendererConfig
from ..scene import SceneState
from . import dispatch
from .transform import triangle_setup


def orthographic_lh(width, height, z_near, z_far, dtype=jnp.float32):
    """XMMatrixOrthographicLH semantics (row-vector convention)."""
    zr = 1.0 / (z_far - z_near)
    m = jnp.zeros((4, 4), dtype)
    m = m.at[0, 0].set(2.0 / width)
    m = m.at[1, 1].set(2.0 / height)
    m = m.at[2, 2].set(zr)
    m = m.at[3, 2].set(-z_near * zr)
    m = m.at[3, 3].set(1.0)
    return m


def light_view_proj(
    light_direction: jnp.ndarray,
    center=(0.0, 0.0, 0.0),
    extent: float = 24.0,
    distance: float = 30.0,
):
    """Ortho view-projection covering a world-space box around `center` as seen
    along the light direction."""
    d = light_direction / jnp.linalg.norm(light_direction)
    center = jnp.asarray(center, jnp.float32)
    eye = center - d * distance
    up = jnp.where(
        jnp.abs(d[1]) > 0.99,
        jnp.asarray([1.0, 0.0, 0.0], jnp.float32),
        jnp.asarray([0.0, 1.0, 0.0], jnp.float32),
    )
    view = xmath.look_at_lh(eye, center, up)
    proj = orthographic_lh(extent, extent, 0.1, distance * 2.0)
    return jnp.matmul(view, proj, precision=jax.lax.Precision.HIGHEST)


def shadow_bin_config(cfg: RendererConfig, n_tris: int) -> RendererConfig:
    """The binning/raster config the shadow-map pass runs under (width/height
    = map size; light-view tier budgets; the display's raster tile, which
    measured fastest of the safe shapes for the depth kernel, PERF.md).

    With cfg.shadow_bin_tiers set (calibrate.autotune_shadow), the calibrated
    light-view tiers apply — sized from the scene's measured light-view
    footprint occupancy over the orbit, roughly halving the sort-key array.
    Otherwise the safe default: at least default-config headroom per tier
    (never the display config's camera-tuned narrowing — the light's ortho
    view sees wide occluders face-on), and a small-tier budget covering every
    possibly-live record (cull="none" keeps ~all slot-0 records).  Overflow
    stays loud either way."""
    S = cfg.shadow_map_size
    shadow_cfg = dataclasses.replace(
        cfg, width=S, height=S,
        max_tris_per_tile=8 * cfg.max_tris_per_tile,
    )
    if cfg.shadow_bin_tiers is not None:
        e, em, mm, el, ml, mb, ms = cfg.shadow_bin_tiers
        shadow_cfg = dataclasses.replace(
            shadow_cfg,
            bin_expand=e, bin_expand_medium=em, bin_max_medium=mm,
            bin_expand_large=el, bin_max_large=ml, bin_max_big=mb,
            bin_max_small=ms,
        )
    else:
        shadow_cfg = dataclasses.replace(
            shadow_cfg,
            bin_max_small=-(-(n_tris + 2048) // 128) * 128,
            bin_expand=max(4, cfg.bin_expand),
            bin_expand_medium=max(32, cfg.bin_expand_medium),
            bin_max_medium=max(512, cfg.bin_max_medium),
            bin_expand_large=max(256, cfg.bin_expand_large),
            bin_max_large=max(64, cfg.bin_max_large),
            bin_max_big=max(16, cfg.bin_max_big),
        )
    return shadow_cfg


def setup_light_view_triangles(
    state: SceneState, cfg: RendererConfig, shadow_cfg: RendererConfig,
    lvp: jnp.ndarray,
):
    """Triangle setup in the LIGHT's view (cull="none": both faces occlude;
    depth-only — attribute lanes are zero-filled).  Shared by
    render_shadow_map, calibrate.autotune_shadow, and the calibration tests."""
    geo = state.geometry
    model = xmath.model_matrix(state.position, state.orientation, state.scale)
    mvp = jnp.matmul(model, lvp, precision=jax.lax.Precision.HIGHEST)
    if geo.fv_positions is not None:
        from .transform import _fv_transform_cols, _setup_cols

        # Depth-only setup (attrs=None): the shadow map never reads normals or
        # uvs, and skipping their transform/clip/pack halves the column ops.
        c_cols, _, _ = _fv_transform_cols(geo, mvp, model, attrs=False)
        return _setup_cols(
            c_cols, None, None, geo.tri_mesh_id, shadow_cfg, cull="none"
        )
    vm = geo.vertex_mesh_id
    clip = xmath.transform_points(geo.logical_positions(), mvp[vm])
    return triangle_setup(
        clip, geo.logical_normals(), geo.logical_uvs(), geo.indices,
        geo.tri_mesh_id, shadow_cfg, cull="none",
    )


def render_shadow_map(
    state: SceneState, cfg: RendererConfig, return_overflow: bool = False,
    interpret: bool = False,
):
    """Depth-only pass from the light's view.  Returns (depth [S,S], light_vp),
    plus the binning overflow count with ``return_overflow=True`` (a shadow
    tile exceeding the per-tile triangle cap would silently drop occluders —
    the same no-silent-drop contract as the main pass).

    Runs the same depth raster as the light-culling prepass
    (ops/dispatch.rasterize_depth): the binned depth kernel on the light's
    tile grid (shadow_bin_config), or the oracle rasterizer."""
    S = cfg.shadow_map_size
    lvp = light_view_proj(state.lights.direction)
    if dispatch.kernel_mode(cfg, interpret) == dispatch.XLA:
        shadow_cfg = dataclasses.replace(cfg, width=S, height=S)
    else:
        # The light's ortho view concentrates the whole scene into few tiles,
        # hence the light-view binning budgets of shadow_bin_config.
        shadow_cfg = shadow_bin_config(cfg, state.geometry.tri_mesh_id.shape[0])
    tris = setup_light_view_triangles(state, cfg, shadow_cfg, lvp)
    sd, s_overflow = dispatch.rasterize_depth(
        tris.packed, tris.aabb, shadow_cfg, interpret=interpret
    )
    if return_overflow:
        return sd, lvp, s_overflow
    return sd, lvp


def shadow_visibility(
    depth: jnp.ndarray,
    view_proj: jnp.ndarray,
    shadow_depth: jnp.ndarray,
    light_vp: jnp.ndarray,
    cfg: RendererConfig,
    bias: float = 2e-3,
    y_offset=0,
    full_height: int | None = None,
    return_overflow: bool = False,
    lit_mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Per-pixel visibility of the directional light with bilinear-weighted PCF
    (the D3D comparison-sampler semantics via sampling.sample_bilinear_cmp:
    compare at each footprint texel, then filter). [H, W] in [0,1].

    ``lit_mask`` ([H, W] bool, optional) marks pixels whose shading actually
    consumes vis (geometry facing the light: NdotL > 0 — a pixel facing away
    multiplies vis by a zero directional term).  On the sparse path it prunes
    tiles with NO lit pixel from the compaction, cutting the dominant
    shadow-map gather count; pruned pixels return vis = 1.0.  EXACT at the
    frame level by construction; lit pixels are bit-identical either way.

    When the framebuffer tiles evenly into (8, 128) blocks and
    ``cfg.shadow_tiles_cap`` is nonzero, sampling runs SPARSELY: only tiles
    containing geometry (min depth < 1) are compacted and sampled — the
    per-pixel shadow-map gathers are the dominant cost and background tiles
    need no shadow (their pixels shade to black regardless of vis).  Sampled
    pixels are BIT-identical to the dense path; uncovered tiles return 1.0.
    Covered tiles beyond the cap are dropped LOUDLY via the overflow counter
    (``return_overflow=True`` returns (vis, overflow) — the binning/culling
    no-silent-drop contract).

    `y_offset`/`full_height` evaluate a horizontal band of a taller framebuffer
    (the screen-sharded multi-chip path; the shadow map itself is view-global —
    the band path stays dense)."""
    from .sampling import sample_bilinear_cmp

    H, W = depth.shape
    sparse_ok = (
        cfg.shadow_tiles_cap != 0
        and max(1, cfg.shadow_vis_downsample) == 1
        and full_height is None
        and isinstance(y_offset, int) and y_offset == 0
        and H % 8 == 0 and W % 128 == 0
    )
    if sparse_ok:
        return _shadow_visibility_sparse(
            depth, view_proj, shadow_depth, light_vp, cfg, bias,
            return_overflow=return_overflow, lit_mask=lit_mask,
        )

    # Screen NDC -> light clip in ONE composed 4x4: the world-space perspective
    # divide cancels against the light projection (row-vector convention:
    # ((q@inv_vp).xyz/w, 1) @ lvp == (q @ (inv_vp@lvp)) / w, and the final
    # xyz/w ratio is divide-invariant; the ortho light keeps w > 0).  Saves the
    # [H,W,3] world materialization + a second full-screen 4x4 transform.
    FH = full_height or H
    xs = (jnp.arange(W, dtype=jnp.float32) + 0.5) * (2.0 / W) - 1.0
    ys = 1.0 - (y_offset + jnp.arange(H, dtype=jnp.float32) + 0.5) * (2.0 / FH)
    ndc_y, ndc_x = jnp.meshgrid(ys, xs, indexing="ij")
    M = jnp.matmul(
        jnp.linalg.inv(view_proj), light_vp, precision=jax.lax.Precision.HIGHEST
    )
    lc = (
        ndc_x[..., None] * M[0]
        + ndc_y[..., None] * M[1]
        + depth[..., None] * M[2]
        + M[3]
    )
    ndc = lc[..., :3] / jnp.maximum(lc[..., 3:4], 1e-8)
    z = ndc[..., 2]

    # Same viewport convention as the main pass: y flipped; uv in [0, 1].
    uv = jnp.stack(
        [(ndc[..., 0] + 1.0) * 0.5, (1.0 - ndc[..., 1]) * 0.5], axis=-1
    )
    d = max(1, cfg.shadow_vis_downsample)
    if d > 1:
        # Compare at every d-th pixel and bilinearly upsample the
        # visibility field (cfg.shadow_vis_downsample).
        H, W = z.shape
        o = d // 2
        uv_c = uv[o::d, o::d]
        z_c = z[o::d, o::d]
        vis_c = sample_bilinear_cmp(shadow_depth, uv_c, z_c, bias)
        vis = jax.image.resize(vis_c, (H, W), method="bilinear")
    else:
        vis = sample_bilinear_cmp(shadow_depth, uv, z, bias)
    inside = (
        (ndc[..., 0] >= -1.0) & (ndc[..., 0] <= 1.0)
        & (ndc[..., 1] >= -1.0) & (ndc[..., 1] <= 1.0)
        & (z >= 0.0) & (z <= 1.0)
    )
    out = jnp.where(inside, vis, 1.0)
    if return_overflow:
        return out, jnp.zeros((), jnp.int32)
    return out


def _shadow_visibility_sparse(
    depth, view_proj, shadow_depth, light_vp, cfg, bias,
    return_overflow=False, lit_mask=None,
):
    """Covered-tile-compacted PCF (see shadow_visibility docstring).

    The per-pixel math IS the dense path's (the same sample_bilinear_cmp call
    and transform chain), evaluated on [B, 1024] gathered tile rows instead of
    [H, W] — sampled pixels are bit-identical.  The shadow-map row-gather count
    drops by the background-tile fraction (~2x on the benchmark scene), which
    is the dominant term of the visibility cost."""
    from .sampling import sample_bilinear_cmp

    H, W = depth.shape
    TH, TW = 8, 128
    nty, ntx = H // TH, W // TW
    NT = nty * ntx
    P = TH * TW
    cap = cfg.shadow_tiles_cap
    if lit_mask is not None and cfg.shadow_tiles_cap_lit:
        # The lit-facing prune shrinks the compacted set (tiles with no
        # NdotL>0 pixel never consume vis), so a lit-sized cap suffices —
        # the gather count scales with the STATIC cap (config.py docstring).
        cap = cfg.shadow_tiles_cap_lit
    if cap < 0:  # auto: 3/4 of the tile grid, VPU-aligned
        cap = min(NT, -(-(NT * 3 // 4) // 8) * 8)
    cap = min(cap, NT)

    d_t = depth.reshape(nty, TH, ntx, TW).transpose(0, 2, 1, 3).reshape(NT, P)
    if lit_mask is not None:
        # Tiles with no lit-facing geometry pixel need no taps at all: their
        # vis is multiplied by a zero directional term everywhere (docstring
        # of shadow_visibility).  Lit pixels stay bit-identical.
        m_t = (
            lit_mask.reshape(nty, TH, ntx, TW)
            .transpose(0, 2, 1, 3).reshape(NT, P)
        )
        covered = jnp.any(m_t & (d_t < 1.0), axis=1)
    else:
        covered = d_t.min(axis=1) < 1.0
    n_cov = jnp.sum(covered.astype(jnp.int32))
    overflow = (n_cov > cap).astype(jnp.int32)
    # Compact covered tile ids; padding slots point past the grid and are
    # dropped by the final scatter.
    idx = jnp.nonzero(covered, size=cap, fill_value=NT)[0]
    idx_c = jnp.minimum(idx, NT - 1)
    d_sel = d_t[idx_c]  # [B, P] — one row-gather per covered tile

    # Pixel centers of the selected tiles (identical float values to the dense
    # meshgrid: integer coords below 2^24 convert exactly).
    tyi = (idx_c // ntx).astype(jnp.float32)
    txi = (idx_c % ntx).astype(jnp.float32)
    fi = jnp.arange(P, dtype=jnp.float32)
    prow = jnp.floor(fi * (1.0 / TW))
    pcol = fi - prow * TW
    pxf = txi[:, None] * TW + pcol[None, :]
    pyf = tyi[:, None] * TH + prow[None, :]
    ndc_x = (pxf + 0.5) * (2.0 / W) - 1.0
    ndc_y = 1.0 - (pyf + 0.5) * (2.0 / H)

    M = jnp.matmul(
        jnp.linalg.inv(view_proj), light_vp, precision=jax.lax.Precision.HIGHEST
    )
    lc = (
        ndc_x[..., None] * M[0]
        + ndc_y[..., None] * M[1]
        + d_sel[..., None] * M[2]
        + M[3]
    )
    ndc = lc[..., :3] / jnp.maximum(lc[..., 3:4], 1e-8)
    z = ndc[..., 2]
    uv = jnp.stack(
        [(ndc[..., 0] + 1.0) * 0.5, (1.0 - ndc[..., 1]) * 0.5], axis=-1
    )

    if cfg.shadow_window_gather:
        vis, w_overflow = _pcf_window_rows(
            shadow_depth, uv, z, bias, cfg, tile_w=TW
        )
        overflow = overflow + w_overflow
    else:
        vis = sample_bilinear_cmp(shadow_depth, uv, z, bias)

    inside = (
        (ndc[..., 0] >= -1.0) & (ndc[..., 0] <= 1.0)
        & (ndc[..., 1] >= -1.0) & (ndc[..., 1] <= 1.0)
        & (z >= 0.0) & (z <= 1.0)
    )
    rows = jnp.where(inside, vis, 1.0)  # [B, P]

    out = jnp.ones((NT, P), jnp.float32).at[idx].set(rows, mode="drop")
    out = out.reshape(nty, ntx, TH, TW).transpose(0, 2, 1, 3).reshape(H, W)
    if return_overflow:
        return out, overflow
    return out


def _pcf_window_rows(shadow_depth, uv, z, bias, cfg, tile_w=128):
    """PCF over [B, P] gathered tile rows with ONE 4x4-window gather per 2x2
    pixel quad (see config.shadow_window_gather).  Returns (vis [B, P],
    overflow).

    Exactness argument: a window row's lane (i, j) holds the SAME
    CLAMP-replicated texel value as pack_cmp_quads' footprint taps
    (sampling.pack_cmp_windows), and the per-pixel compare/blend below is
    sample_bilinear_cmp's verbatim.  A quad whose four (clamped) footprint
    bases span <= 2 texels per axis reads all 16 candidate taps from its one
    window; each pixel then selects its 2x2 by static lane offsets (a 9-way
    where-chain over the (dy, dx) in [0,2]^2 cases — XLA fuses it into one
    elementwise pass).  Wider quads (depth edges, grazing angles) are
    compacted and resampled per-pixel from lanes (0, 1, 4, 5) of each pixel's
    OWN window row — the exact pack_cmp_quads footprint — so every pixel is
    bit-identical to the dense path either way.  More bad quads than the cap
    raises the loud overflow counter (the caps-are-loud contract)."""
    from .sampling import pack_cmp_windows

    Sh, Sw = shadow_depth.shape
    B, P = z.shape
    TW = tile_w
    TH = P // TW
    Q = P // 4
    win = pack_cmp_windows(shadow_depth)

    fx = uv[..., 0] * Sw - 0.5
    fy = uv[..., 1] * Sh - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = fx - x0
    ty = fy - y0
    # Clamping the BASE (not each tap) is exact — replicated-edge windows hold
    # equal texels wherever the clamp engages (same argument as
    # sample_bilinear_cmp).
    xi = jnp.clip(x0.astype(jnp.int32), -1, Sw - 1)
    yi = jnp.clip(y0.astype(jnp.int32), -1, Sh - 1)

    def quads(a):
        """[B, P] tile rows -> [B, Q, 4] 2x2 pixel quads (r0c0 r0c1 r1c0 r1c1)."""
        return (
            a.reshape(B, TH // 2, 2, TW // 2, 2)
            .transpose(0, 1, 3, 2, 4)
            .reshape(B, Q, 4)
        )

    xq, yq = quads(xi), quads(yi)
    txq, tyq, zq = quads(tx), quads(ty), quads(z)
    bx = xq.min(axis=-1)
    by = yq.min(axis=-1)  # [B, Q] window base
    good = ((xq.max(-1) - bx) <= 2) & ((yq.max(-1) - by) <= 2)
    w16 = win[(by + 1) * (Sw + 1) + (bx + 1)]  # [B, Q, 16] — ONE gather/quad
    dx = xq - bx[..., None]
    dy = yq - by[..., None]  # in [0, 2] for good quads

    taps = jnp.zeros((B, Q, 4, 4), win.dtype)
    w16p = w16[:, :, None, :]  # broadcast over the quad's 4 pixels
    for oy in range(3):
        for ox in range(3):
            lanes = w16p[
                ..., [oy * 4 + ox, oy * 4 + ox + 1, (oy + 1) * 4 + ox, (oy + 1) * 4 + ox + 1]
            ]
            sel = ((dy == oy) & (dx == ox))[..., None]
            taps = jnp.where(sel, lanes, taps)

    def cmp_blend(taps_, z_, tx_, ty_):
        c = (z_[..., None] <= taps_ + bias).astype(jnp.float32)
        top = c[..., 0] + (c[..., 1] - c[..., 0]) * tx_
        bot = c[..., 2] + (c[..., 3] - c[..., 2]) * tx_
        return top + (bot - top) * ty_

    vis_q = cmp_blend(taps, zq, txq, tyq)  # [B, Q, 4]

    # Wide-quad fallback: per-pixel taps from each pixel's own window row.
    cap = cfg.shadow_bad_quads_cap
    if cap < 0:  # auto: 1/8 of the quad budget, VPU-aligned
        cap = max(8, -(-(B * Q // 8) // 8) * 8)
    cap = min(cap, B * Q)
    bad = ~good
    n_bad = jnp.sum(bad.astype(jnp.int32))
    flat = bad.reshape(-1)
    bidx = jnp.nonzero(flat, size=cap, fill_value=B * Q)[0]
    bcl = jnp.minimum(bidx, B * Q - 1)

    def fq(a):
        return a.reshape(B * Q, 4)[bcl]

    xb, yb, txb, tyb, zb = fq(xq), fq(yq), fq(txq), fq(tyq), fq(zq)
    wb = win[(yb + 1) * (Sw + 1) + (xb + 1)]  # [cap, 4, 16]
    tb = wb[..., [0, 1, 4, 5]]  # the pixel's own 2x2 footprint
    vb = cmp_blend(tb, zb, txb, tyb)  # [cap, 4]
    vis_q = vis_q.reshape(B * Q, 4).at[bidx].set(vb, mode="drop")

    vis = (
        vis_q.reshape(B, TH // 2, TW // 2, 2, 2)
        .transpose(0, 1, 3, 2, 4)
        .reshape(B, P)
    )
    return vis, (n_bad > cap).astype(jnp.int32)
