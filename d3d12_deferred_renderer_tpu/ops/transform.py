"""Vertex transform and triangle setup — the fixed-function front of the geometry pass.

What D3D12 does in the input assembler + vertex shader + primitive setup
(geometry.hlsl:27-40; rasterizer state at main.cpp:725-766) becomes two dense ops:

1. ``vertex_transform``: one batched matmul over the unified vertex buffer.  The
   reference re-uploads per-mesh MVP constant buffers and issues one draw per mesh
   (main.cpp:210-241); here every mesh's matrix is computed at once ([M,4,4]) and
   gathered per vertex, so the whole scene transforms in a single batched op.

2. ``triangle_setup``: perspective divide, viewport transform (D3D convention:
   y flipped, pixel centers at +0.5), back-face cull (FrontCounterClockwise=TRUE,
   CULL_BACK — main.cpp:727-728), winding canonicalization, near-plane rejection, and
   per-triangle packing of everything the rasterizer needs (screen verts, NDC z,
   1/w, attributes premultiplied by 1/w for perspective-correct interpolation).

Facing convention: D3D determines facing from the signed area in render-target space
(y down).  With FrontCounterClockwise=TRUE, front-facing ⟺ signed area < 0 under the
standard 2D cross product in y-down coordinates.  NOTE a preserved reference quirk:
the bundled cube/pyramid OBJs are wound clockwise when viewed from outside, so under
the reference's rasterizer state their camera-facing sides are CULLED and the far
(interior) faces are what you see.  We reproduce that faithfully; procedural
benchmark meshes are wound to show exteriors.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import xmath
from ..config import RendererConfig
from ..scene import SceneState

# Packed triangle-record layout (float32 columns) consumed by the rasterizers.
# One flat [T, TRI_STRIDE] array: a record is one 128-byte row.
TRI_X0, TRI_Y0, TRI_X1, TRI_Y1, TRI_X2, TRI_Y2 = 0, 1, 2, 3, 4, 5
TRI_Z0, TRI_Z1, TRI_Z2 = 6, 7, 8
TRI_RW0, TRI_RW1, TRI_RW2 = 9, 10, 11
TRI_N0 = 12  # 12-14: normal0 * rw0
TRI_N1 = 15  # 15-17
TRI_N2 = 18  # 18-20
TRI_UV0 = 21  # 21-22: uv0 * rw0
TRI_UV1 = 23  # 23-24
TRI_UV2 = 25  # 25-26
TRI_MESH_ID = 27
TRI_VALID = 28
TRI_AREA = 29  # canonical (positive) doubled area
TRI_STRIDE = 32  # padded to a power of two (128-byte rows)


class TriSetup(NamedTuple):
    """Unpacked triangle setup; `packed` is the flat [T, TRI_STRIDE] record array."""

    packed: jnp.ndarray   # [T, TRI_STRIDE] float32
    aabb: jnp.ndarray     # [T, 4] float32: minx, miny, maxx, maxy (pixel coords)
    valid: jnp.ndarray    # [T] bool

    @property
    def num_triangles(self) -> int:
        return int(self.packed.shape[0])


_HIGHEST = jax.lax.Precision.HIGHEST


def _mm(a, b):
    """float32 matrix product at full precision (never TF32)."""
    return jnp.matmul(a, b, precision=_HIGHEST)


def camera_matrices(state: SceneState, cfg: RendererConfig):
    """View and projection matrices from the scene camera (main.cpp:214-224)."""
    view = xmath.look_at_lh(state.camera.eye, state.camera.at, state.camera.up)
    proj = xmath.perspective_fov_lh(cfg.fov_y, cfg.aspect, cfg.z_near, cfg.z_far)
    return view, proj


def vertex_transform(
    state: SceneState, cfg: RendererConfig, model=None, view_proj=None
):
    """Transform the unified vertex buffer to clip space + world-space normals.

    Returns (clip [V,4], world_normal [V,3], view_proj [4,4]).
    Matches geometry.hlsl:32-37: position through model/view/projection, normal
    through the model matrix only (deliberately NOT the inverse-transpose).
    Pass precomputed `model`/`view_proj` to avoid re-deriving them (the frame
    front-end already has both).
    """
    geo = state.geometry
    if model is None:
        model = xmath.model_matrix(
            state.position, state.orientation, state.scale
        )  # [M,4,4]
    if view_proj is None:
        view, proj = camera_matrices(state, cfg)
        view_proj = _mm(view, proj)
    mvp = _mm(model, view_proj)  # [M,4,4]

    vm = geo.vertex_mesh_id
    clip = xmath.transform_points(geo.logical_positions(), mvp[vm])     # [V,4]
    world_n = xmath.transform_vectors(geo.logical_normals(), model[vm])  # [V,3]
    return clip, world_n, view_proj


def face_vertex_transform(state: SceneState, cfg: RendererConfig):
    """Gather-free vertex transform over the host-pre-expanded face-vertex
    buffers (GeometryBuffers.fv_*): the input-assembler index fetch happened at
    scene build, so the per-frame work is two dense batched matmuls plus one
    small [M,4,4]->[I,4,4] matrix gather.

    Returns (clip [I,4], world_normal [I,3], view_proj [4,4]) with I = 3*T rows
    in triangle submission order — feed triangle_setup(pregathered=True).

    The per-vertex matrix selection is a one-hot contraction, not a gather:
    one [I,4] x [4, M*4] product against every mesh's matrix at once, then a
    masked reduction over the (small) mesh axis."""
    geo = state.geometry
    model = xmath.model_matrix(state.position, state.orientation, state.scale)
    view, proj = camera_matrices(state, cfg)
    view_proj = _mm(view, proj)
    mvp = _mm(model, view_proj)

    fm = geo.fv_mesh_id
    I = fm.shape[0]
    M = mvp.shape[0]
    onehot = (fm[:, None] == jnp.arange(M, dtype=fm.dtype)).astype(jnp.float32)
    hp = _HIGHEST

    pos_h = jnp.concatenate(
        [geo.fv_positions, jnp.ones((I, 1), jnp.float32)], axis=-1
    )
    clip_all = jnp.matmul(
        pos_h, mvp.transpose(1, 0, 2).reshape(4, M * 4), precision=hp
    )  # [I, M*4]: row n transformed by EVERY mesh's mvp
    clip = jnp.sum(clip_all.reshape(I, M, 4) * onehot[:, :, None], axis=1)

    nrm_all = jnp.matmul(
        geo.fv_normals, model[:, :3, :3].transpose(1, 0, 2).reshape(3, M * 3),
        precision=hp,
    )
    world_n = jnp.sum(nrm_all.reshape(I, M, 3) * onehot[:, :, None], axis=1)
    return clip, world_n, view_proj


# ---------------------------------------------------------------------------
# Stacked-column (structure-of-arrays) primitive setup.
#
# Every stage below operates on stacked [vert, comp, T] arrays — the triangle
# axis is the minor (contiguous) axis, so one XLA op processes every component
# of every vertex at once instead of one small op per component.
# ---------------------------------------------------------------------------


def _clip_near_plane_stack(c, n, uv):
    """Clip triangles against the near plane (clip-space z = 0, D3D convention).

    Static-shape formulation for XLA: every input triangle emits EXACTLY TWO
    output slots.  A fully-inside triangle emits (itself, degenerate); one
    vertex inside emits (clipped tri, degenerate); two inside emit the two
    triangles of the clipped quad; fully-outside emits two degenerates.
    Degenerate slots have zero area and are rejected downstream.  Cyclic vertex
    rotation keeps winding intact; attributes lerp in clip space (exact,
    pre-divide).

    Inputs are stacked [3, C, T] arrays (c: C=4, n: C=3, uv: C=2); outputs have
    2T slots along the last axis (slot pairs interleaved).  `n`/`uv` may be
    None (depth-only passes — the shadow map needs positions alone; skipping
    attribute rotation/lerp is ~half the ops).  Also returns duplicate(a): any
    per-input-triangle array -> the 2T output slots."""
    z0, z1, z2 = c[0, 2], c[1, 2], c[2, 2]
    in0, in1, in2 = z0 >= 0.0, z1 >= 0.0, z2 >= 0.0
    n_in = in0.astype(jnp.int32) + in1.astype(jnp.int32) + in2.astype(jnp.int32)
    T = z0.shape[0]

    # Rotate vertex order to a canonical arrangement (preserves winding):
    #   n_in == 1 -> the inside vertex at slot 0
    #   n_in == 2 -> the outside vertex at slot 2
    i32 = jnp.int32
    first_in = jnp.where(in0, i32(0), jnp.where(in1, i32(1), i32(2)))
    first_out = jnp.where(~in0, i32(0), jnp.where(~in1, i32(1), i32(2)))
    r = jnp.where(n_in == 1, first_in, jnp.where(n_in == 2, (first_out + 1) % 3, 0))

    def rot(a):
        # r is one of 3 cyclic rotations of the vertex axis: a where-chain over
        # the two static rolls instead of a per-element take_along_axis
        # gather, and rolling the stacked array keeps it to 2 selects total.
        a1 = jnp.concatenate([a[1:], a[:1]], axis=0)  # v -> (v+1) % 3
        a2 = jnp.concatenate([a[2:], a[:2]], axis=0)  # v -> (v+2) % 3
        return jnp.where(r == 0, a, jnp.where(r == 1, a1, a2))

    c = rot(c)
    n = rot(n) if n is not None else None
    uv = rot(uv) if uv is not None else None
    zA, zB, zC = c[0, 2], c[1, 2], c[2, 2]

    def lerp_t(za, zb):
        d = za - zb
        return za / jnp.where(d == 0.0, 1.0, d)

    tAB = lerp_t(zA, zB)
    tAC = lerp_t(zA, zC)
    tBC = lerp_t(zB, zC)

    sel1 = n_in == 1
    sel2 = n_in == 2
    sel3 = n_in == 3

    def clip_attr(a):
        A, B, C = a[0], a[1], a[2]  # [C, T] each
        AB = A + (B - A) * tAB
        AC = A + (C - A) * tAC
        BC = B + (C - B) * tBC
        # slots: n_in==3 -> (A,B,C); ==2 -> (A,B,BC)+(A,BC,AC);
        #        ==1 -> (A,AB,AC); ==0 -> degenerate (A,A,A)
        s0v1 = jnp.where(sel3 | sel2, B, jnp.where(sel1, AB, A))
        s0v2 = jnp.where(sel3, C, jnp.where(sel2, BC, jnp.where(sel1, AC, A)))
        s1v1 = jnp.where(sel2, BC, A)
        s1v2 = jnp.where(sel2, AC, A)
        s0 = jnp.stack([A, s0v1, s0v2])  # [3, C, T]
        s1 = jnp.stack([A, s1v1, s1v2])
        # Interleave slot pairs along the triangle axis: out[.., 2t] = s0[.., t].
        return jnp.stack([s0, s1], axis=-1).reshape(3, a.shape[1], 2 * T)

    c2 = clip_attr(c)
    n2 = clip_attr(n) if n is not None else None
    uv2 = clip_attr(uv) if uv is not None else None

    def duplicate(a):
        # Interleave-duplicate WITHOUT an index-array gather: a size-T iota
        # constant here would be baked into the HLO and make compile time scale
        # with the triangle count.
        return jnp.stack([a, a], axis=1).reshape((2 * T,) + a.shape[1:])

    return c2, n2, uv2, duplicate


def _clip_near_plane(c, n, uv):
    """Row-shape ([T, 3, C]) wrapper over _clip_near_plane_stack (same clipping
    semantics; kept as the spec-shaped entry point for the clipping tests).
    `n`/`uv` may be None (depth-only passes), matching the stack form's
    contract."""
    c2, n2, uv2, duplicate = _clip_near_plane_stack(
        c.transpose(1, 2, 0),
        None if n is None else n.transpose(1, 2, 0),
        None if uv is None else uv.transpose(1, 2, 0),
    )

    def rows(a):
        return None if a is None else a.transpose(2, 0, 1)

    return rows(c2), rows(n2), rows(uv2), duplicate


def triangle_setup(
    clip: jnp.ndarray,
    world_normal: jnp.ndarray,
    uvs: jnp.ndarray,
    indices: jnp.ndarray,
    tri_mesh_id: jnp.ndarray,
    cfg: RendererConfig,
    cull: str = "back",
    front_ccw: bool = True,
    near_clip: bool = True,
    pregathered: bool = False,
) -> TriSetup:
    """Primitive setup: near-plane clip, cull, canonicalize winding, pack records.

    With near_clip=True (default) the output has 2x the input triangle count
    (static-shape clipping, see _clip_near_plane_stack).  With pregathered=True
    the clip/normal/uv inputs are already face-vertex expanded ([3T, ...] rows
    in submission order — see face_vertex_transform) and `indices` is ignored."""
    if pregathered:
        c = clip.reshape(-1, 3, 4)
        n = world_normal.reshape(-1, 3, 3)
        uv = uvs.reshape(-1, 3, 2)
    else:
        tri_idx = indices.reshape(-1, 3)  # [T, 3]
        c = clip[tri_idx]          # [T, 3, 4]
        n = world_normal[tri_idx]  # [T, 3, 3]
        uv = uvs[tri_idx]          # [T, 3, 2]

    return _setup_cols(
        c.transpose(1, 2, 0), n.transpose(1, 2, 0), uv.transpose(1, 2, 0),
        tri_mesh_id, cfg, cull=cull, front_ccw=front_ccw, near_clip=near_clip,
    )


def _setup_cols(
    c, n, uv, tri_mesh_id, cfg: RendererConfig,
    cull: str = "back", front_ccw: bool = True, near_clip: bool = True,
) -> TriSetup:
    """Stacked-column primitive setup (see triangle_setup for semantics).

    c: [3, 4, T] clip positions; n: [3, 3, T]; uv: [3, 2, T].  `n`/`uv` may be
    None for depth-only passes (shadow maps): the attribute record lanes
    (TRI_N0..TRI_UV2) are zero-filled and must not be consumed."""
    W, H = cfg.width, cfg.height

    if near_clip:
        c, n, uv, duplicate = _clip_near_plane_stack(c, n, uv)
        tri_mesh_id = duplicate(tri_mesh_id)

    # After near clipping every surviving vertex has clip z >= 0, which for the
    # LH projection implies w >= z_near > 0; the guard below only rejects
    # numerical stragglers and degenerate fills.
    w = c[:, 3]  # [3, T]
    w_ok = (w[0] > 1e-6) & (w[1] > 1e-6) & (w[2] > 1e-6)
    rw = 1.0 / jnp.where(w == 0.0, 1.0, w)  # [3, T]

    # D3D viewport transform (viewport at main.cpp:90): y flips, z in [0, 1].
    sx = (c[:, 0] * rw + 1.0) * (W * 0.5)  # [3, T]
    sy = (1.0 - c[:, 1] * rw) * (H * 0.5)
    sz = c[:, 2] * rw

    # Signed doubled area in y-down render-target space.
    area2 = (sx[1] - sx[0]) * (sy[2] - sy[0]) - (sy[1] - sy[0]) * (sx[2] - sx[0])

    front = (area2 < 0.0) if front_ccw else (area2 > 0.0)
    if cull == "back":
        keep_facing = front
    elif cull == "front":
        keep_facing = ~front
    elif cull == "none":
        keep_facing = jnp.ones_like(front)
    else:
        raise ValueError(f"unknown cull mode {cull!r}")

    valid = w_ok & keep_facing & (area2 != 0.0)

    # Trivial frustum reject: AABB fully outside the screen or depth range.
    minx = jnp.minimum(jnp.minimum(sx[0], sx[1]), sx[2])
    maxx = jnp.maximum(jnp.maximum(sx[0], sx[1]), sx[2])
    miny = jnp.minimum(jnp.minimum(sy[0], sy[1]), sy[2])
    maxy = jnp.maximum(jnp.maximum(sy[0], sy[1]), sy[2])
    on_screen = (maxx >= 0.0) & (minx < W) & (maxy >= 0.0) & (miny < H)
    z_ok = (jnp.maximum(jnp.maximum(sz[0], sz[1]), sz[2]) >= 0.0) & (
        jnp.minimum(jnp.minimum(sz[0], sz[1]), sz[2]) <= 1.0
    )
    valid = valid & on_screen & z_ok

    # Canonicalize winding to positive area (swap v1 <-> v2 when negative) so
    # the rasterizer's inside test is uniformly e >= 0.
    swap = area2 < 0.0

    def pick(a):  # [3, ..., T] -> canonical vertex order (v1/v2 swapped)
        return (a[0], jnp.where(swap, a[2], a[1]), jnp.where(swap, a[1], a[2]))

    sxy = jnp.stack([sx, sy], axis=1)  # [3, 2, T]: (x_v, y_v) pairs
    pxy = pick(sxy)
    pz = pick(sz)    # 3 x [T]
    prw = pick(rw)   # 3 x [T]

    area_c = jnp.abs(area2)
    zero = jnp.zeros_like(area_c)

    # Assemble the record: concatenate the 32 rows and transpose ONCE — row
    # order MUST follow the TRI_* layout above.
    parts = [
        pxy[0], pxy[1], pxy[2],                      # 0-5: x0 y0 x1 y1 x2 y2
        jnp.stack([pz[0], pz[1], pz[2]]),            # 6-8
        jnp.stack([prw[0], prw[1], prw[2]]),         # 9-11
    ]
    if n is not None:
        pn = pick(n)
        puv = pick(uv)
        parts += [pn[v] * prw[v] for v in range(3)]   # 12-20: normal_v * rw_v
        parts += [puv[v] * prw[v] for v in range(3)]  # 21-26: uv_v * rw_v
    else:
        parts += [jnp.zeros((15,) + area_c.shape, jnp.float32)]  # depth-only
    parts += [
        jnp.stack([
            tri_mesh_id.astype(jnp.float32),          # 27
            valid.astype(jnp.float32),                # 28
            area_c,                                   # 29
            zero, zero,                               # 30-31
        ])
    ]
    packed = jnp.concatenate(parts, axis=0).T

    aabb = jnp.stack(
        [
            jnp.clip(minx, 0.0, W),
            jnp.clip(miny, 0.0, H),
            jnp.clip(maxx, 0.0, W),
            jnp.clip(maxy, 0.0, H),
        ],
        axis=0,
    ).T
    return TriSetup(packed=packed, aabb=aabb, valid=valid)


def _fv_select_mats(tri_mesh_id, mvp: jnp.ndarray, model, attrs: bool = True):
    """Per-triangle matrix selection as one one-hot product of the flattened
    matrix tables against [M, T].  HIGHEST precision keeps the one-hot
    selection bit-exact (a reduced-precision product would round the selected
    float32 matrix entries).

    Returns (selC [16, T], selN [9, T] or None): row k*4+c of selC is
    mvp[mesh_id(t), k, c]; row k*3+j of selN is model[mesh_id(t), k, j]."""
    M = mvp.shape[0]
    hp = _HIGHEST
    onehot = (
        tri_mesh_id[None, :] == jnp.arange(M, dtype=tri_mesh_id.dtype)[:, None]
    ).astype(jnp.float32)  # [M, T]
    selC = jnp.matmul(mvp.reshape(M, 16).T, onehot, precision=hp)  # [16, T]
    selN = (
        jnp.matmul(model[:, :3, :3].reshape(M, 9).T, onehot, precision=hp)
        if attrs
        else None
    )  # [9, T]
    return selC, selN


def _fv_transform_cols(geo, mvp: jnp.ndarray, model: jnp.ndarray,
                       attrs: bool = True):
    """Column-layout gather-free transform of the face-vertex buffers.

    The per-TRIANGLE matrix selection is one one-hot product (see
    _fv_select_mats), shared by the triangle's 3 vertices.
    Returns (c_cols, n_cols, uv_cols) for _setup_cols; attrs=False (depth-only
    passes) skips the normal transform and returns (c_cols, None, None)."""

    # [slot, comp, T] columns — pre-transposed on the host at scene build
    # (GeometryBuffers.fv_*_cols); the device re-transpose fallback covers
    # geometry resumed from older checkpoints.
    if geo.fv_pos_cols is not None:
        p, nr, uvr = geo.fv_pos_cols, geo.fv_nrm_cols, geo.fv_uv_cols
    else:
        fv_pos = geo.fv_positions      # [I, 3], I = 3T rows in submission order
        T = fv_pos.shape[0] // 3
        p = fv_pos.reshape(T, 3, 3).transpose(1, 2, 0)
        nr = geo.fv_normals.reshape(T, 3, 3).transpose(1, 2, 0)
        uvr = geo.fv_uvs.reshape(T, 3, 2).transpose(1, 2, 0)

    selC, selN = _fv_select_mats(geo.tri_mesh_id, mvp, model, attrs=attrs)
    sC = selC.reshape(4, 4, -1)  # [k, c, T]: mvp row k, column c per triangle

    # Row-vector convention: clip[c] = sum_k pos_h[k] * mvp[k, c], pos_h[3]=1.
    c_cols = (
        p[:, 0, None, :] * sC[0][None]
        + p[:, 1, None, :] * sC[1][None]
        + p[:, 2, None, :] * sC[2][None]
        + sC[3][None]
    )  # [3, 4, T]
    if not attrs:
        return c_cols, None, None
    sN = selN.reshape(3, 3, -1)
    n_cols = (
        nr[:, 0, None, :] * sN[0][None]
        + nr[:, 1, None, :] * sN[1][None]
        + nr[:, 2, None, :] * sN[2][None]
    )  # [3, 3, T]
    return c_cols, n_cols, uvr


def setup_frame_triangles(
    state: SceneState, cfg: RendererConfig, **kw
) -> tuple:
    """Full front-end: vertex transform + triangle setup.  Returns (TriSetup, view_proj).

    Uses the gather-free column face-vertex path when the geometry carries the
    host-pre-expanded fv_* buffers (always, for scenes built this round);
    falls back to the indexed path for geometry resumed from old checkpoints."""
    geo = state.geometry
    model = xmath.model_matrix(state.position, state.orientation, state.scale)
    view, proj = camera_matrices(state, cfg)
    view_proj = _mm(view, proj)
    if geo.fv_positions is not None:
        c_cols, n_cols, uv_cols = _fv_transform_cols(
            geo, _mm(model, view_proj), model
        )
        tris = _setup_cols(c_cols, n_cols, uv_cols, geo.tri_mesh_id, cfg, **kw)
    else:
        clip, world_n, view_proj = vertex_transform(
            state, cfg, model=model, view_proj=view_proj
        )
        tris = triangle_setup(
            clip, world_n, geo.logical_uvs(), geo.indices, geo.tri_mesh_id,
            cfg, **kw,
        )
    return tris, view_proj
