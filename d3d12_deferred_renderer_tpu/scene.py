"""Scene state as JAX pytrees: geometry, transforms, camera, lights, materials.

Replaces the reference's file-scope globals + per-frame constant-buffer uploads
(source/main.cpp:118-128, 236-250) with a single immutable pytree that flows through
the jitted frame function — the analog of the persistently-mapped upload heap is
donating this pytree into the XLA program.

The animation rule matches main.cpp:200-207: time advances 0.01 rad per frame, wraps
at 2*pi, and drives the yaw of every mesh.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .config import RendererConfig
from .models.meshlib import SceneGeometry
from .xmath import XM_2PI


def _pytree_dataclass(cls):
    fields = [f.name for f in dataclasses.fields(cls)]
    jax.tree_util.register_pytree_node(
        cls,
        lambda obj: (tuple(getattr(obj, f) for f in fields), None),
        lambda aux, children: cls(*children),
    )
    return cls


@_pytree_dataclass
@dataclasses.dataclass(frozen=True)
class Camera:
    """Camera parameters (main.cpp:214-224 defaults live in RendererConfig)."""

    eye: jnp.ndarray  # [3]
    at: jnp.ndarray   # [3]
    up: jnp.ndarray   # [3]

    @staticmethod
    def from_config(cfg: RendererConfig) -> "Camera":
        return Camera(
            eye=jnp.asarray(cfg.eye, jnp.float32),
            at=jnp.asarray(cfg.at, jnp.float32),
            up=jnp.asarray(cfg.up, jnp.float32),
        )


@_pytree_dataclass
@dataclasses.dataclass(frozen=True)
class Lights:
    """One directional light (reference parity, main.cpp:245-247) plus N point
    lights (BASELINE configs 2-5).  ``num_point`` is a static python int baked into
    the compiled program via array shapes."""

    direction: jnp.ndarray    # [3] directional light direction
    color: jnp.ndarray        # [3] directional light color
    point_position: jnp.ndarray  # [L, 3]
    point_color: jnp.ndarray     # [L, 3]
    point_radius: jnp.ndarray    # [L] influence radius (for per-tile culling)
    point_intensity: jnp.ndarray  # [L]

    @staticmethod
    def directional_only(cfg: RendererConfig) -> "Lights":
        return Lights(
            direction=jnp.asarray(cfg.light_direction, jnp.float32),
            color=jnp.asarray(cfg.light_color, jnp.float32),
            point_position=jnp.zeros((0, 3), jnp.float32),
            point_color=jnp.zeros((0, 3), jnp.float32),
            point_radius=jnp.zeros((0,), jnp.float32),
            point_intensity=jnp.zeros((0,), jnp.float32),
        )

    @property
    def num_point(self) -> int:
        return int(self.point_position.shape[0])


@_pytree_dataclass
@dataclasses.dataclass(frozen=True)
class Materials:
    """Per-mesh material constants.  The reference hardcodes one material in the
    geometry pixel shader (geometry.hlsl:46-49); per-mesh materials generalize it
    (all-equal defaults reproduce parity)."""

    albedo: jnp.ndarray     # [M, 3]
    metalness: jnp.ndarray  # [M]
    roughness: jnp.ndarray  # [M]

    @staticmethod
    def from_config(cfg: RendererConfig, num_meshes: int) -> "Materials":
        return Materials(
            albedo=jnp.tile(jnp.asarray([cfg.albedo], jnp.float32), (num_meshes, 1)),
            metalness=jnp.full((num_meshes,), cfg.metalness, jnp.float32),
            roughness=jnp.full((num_meshes,), cfg.roughness, jnp.float32),
        )

    @staticmethod
    def varied(num_meshes: int, seed: int = 7) -> "Materials":
        """Distinct per-mesh materials for benchmark/demo scenes (the reference has
        exactly one hardcoded material; this exercises the per-mesh gather path)."""
        rng = np.random.default_rng(seed)
        return Materials(
            albedo=jnp.asarray(rng.uniform(0.1, 0.9, (num_meshes, 3)), jnp.float32),
            metalness=jnp.asarray(rng.uniform(0.0, 1.0, num_meshes), jnp.float32),
            roughness=jnp.asarray(rng.uniform(0.15, 0.9, num_meshes), jnp.float32),
        )


@_pytree_dataclass
@dataclasses.dataclass(frozen=True)
class GeometryBuffers:
    """Device-resident unified vertex/index buffers (C14 analog, main.cpp:836-913)."""

    positions: jnp.ndarray    # [Vb, 3] shared base storage
    normals: jnp.ndarray      # [Vb, 3]
    uvs: jnp.ndarray          # [Vb, 2]
    indices: jnp.ndarray      # [I] int32 into logical vertex space
    tri_mesh_id: jnp.ndarray  # [T] int32 (instance id when instanced)
    vertex_mesh_id: jnp.ndarray  # [V] int32 per logical vertex
    vertex_source: object     # [V] int32 -> base row, or None (not instanced)
    # Face-vertex expansion, precomputed ON THE HOST at scene build (the index
    # maps are static): fv_* hold each triangle corner's attributes in
    # submission order, so per-frame triangle assembly needs NO device gathers
    # (the input-assembler fetch is free at build time instead of per frame).
    # None when the geometry was built by an older path (checkpoint resume).
    fv_positions: object = None  # [I, 3] f32
    fv_normals: object = None    # [I, 3] f32
    fv_uvs: object = None        # [I, 2] f32
    fv_mesh_id: object = None    # [I] int32 (tri_mesh_id repeated 3x)
    # Column ([slot, comp, T]) views of the fv buffers, transposed ONCE on the
    # host: the column triangle-setup pipeline (ops/transform.py) consumes the
    # triangle axis as the VPU lane axis; re-transposing [I, 3] minor-dim
    # buffers on device costs ~2 ms/frame at 24k triangles.
    fv_pos_cols: object = None   # [3, 3, T] f32
    fv_nrm_cols: object = None   # [3, 3, T] f32
    fv_uv_cols: object = None    # [3, 2, T] f32

    @staticmethod
    def from_host(geo: SceneGeometry) -> "GeometryBuffers":
        base_idx = geo.indices
        if geo.vertex_source is not None:
            base_idx = geo.vertex_source[base_idx]
        fv_pos = geo.positions[base_idx]
        fv_nrm = geo.normals[base_idx]
        fv_uv = geo.uvs[base_idx]
        T = fv_pos.shape[0] // 3
        return GeometryBuffers(
            positions=jnp.asarray(geo.positions),
            normals=jnp.asarray(geo.normals),
            uvs=jnp.asarray(geo.uvs),
            indices=jnp.asarray(geo.indices),
            tri_mesh_id=jnp.asarray(geo.tri_mesh_id),
            vertex_mesh_id=jnp.asarray(geo.vertex_mesh_id),
            vertex_source=(
                None if geo.vertex_source is None else jnp.asarray(geo.vertex_source)
            ),
            fv_positions=jnp.asarray(fv_pos),
            fv_normals=jnp.asarray(fv_nrm),
            fv_uvs=jnp.asarray(fv_uv),
            fv_mesh_id=jnp.asarray(np.repeat(geo.tri_mesh_id, 3)),
            fv_pos_cols=jnp.asarray(
                np.ascontiguousarray(fv_pos.reshape(T, 3, 3).transpose(1, 2, 0))
            ),
            fv_nrm_cols=jnp.asarray(
                np.ascontiguousarray(fv_nrm.reshape(T, 3, 3).transpose(1, 2, 0))
            ),
            fv_uv_cols=jnp.asarray(
                np.ascontiguousarray(fv_uv.reshape(T, 3, 2).transpose(1, 2, 0))
            ),
        )

    def logical_positions(self) -> jnp.ndarray:
        """Per-logical-vertex positions (resolving instancing indirection)."""
        if self.vertex_source is None:
            return self.positions
        return self.positions[self.vertex_source]

    def logical_normals(self) -> jnp.ndarray:
        if self.vertex_source is None:
            return self.normals
        return self.normals[self.vertex_source]

    def logical_uvs(self) -> jnp.ndarray:
        if self.vertex_source is None:
            return self.uvs
        return self.uvs[self.vertex_source]

    @property
    def num_triangles(self) -> int:
        return int(self.indices.shape[0] // 3)


@_pytree_dataclass
@dataclasses.dataclass(frozen=True)
class SceneState:
    """The complete per-frame render state — everything the jitted frame function
    reads.  Functional update per frame via ``animate``."""

    geometry: GeometryBuffers
    position: jnp.ndarray     # [M, 3] per-mesh translation
    orientation: jnp.ndarray  # [M, 3] (pitch, yaw, roll)
    scale: jnp.ndarray        # [M, 3]
    materials: Materials
    camera: Camera
    lights: Lights
    time: jnp.ndarray         # scalar f32, the animation clock


def default_transforms(num_meshes: int) -> tuple:
    """Reference placement: mesh i at x = -2 + 2*i, unit scale (main.cpp:888-890)."""
    pos = np.zeros((num_meshes, 3), np.float32)
    pos[:, 0] = -2.0 + 2.0 * np.arange(num_meshes)
    return (
        jnp.asarray(pos),
        jnp.zeros((num_meshes, 3), jnp.float32),
        jnp.ones((num_meshes, 3), jnp.float32),
    )


def grid_transforms(num_meshes: int, cols: int = 6, spacing: float = 1.6) -> tuple:
    """Benchmark placement: meshes on a grid centered at origin (first mesh, the
    ground plane if present, stays at origin)."""
    pos = np.zeros((num_meshes, 3), np.float32)
    for k in range(1, num_meshes):
        i = k - 1
        r, c = divmod(i, cols)
        pos[k] = (
            (c - (cols - 1) / 2.0) * spacing,
            -0.4,  # resting near the ground plane at y = -1
            (r * spacing) - 2.0,
        )
    return (
        jnp.asarray(pos),
        jnp.zeros((num_meshes, 3), jnp.float32),
        jnp.ones((num_meshes, 3), jnp.float32),
    )


def make_scene(
    geo: SceneGeometry,
    cfg: RendererConfig,
    lights: Optional[Lights] = None,
    placement: str = "reference",
    materials: Optional[Materials] = None,
) -> SceneState:
    m = geo.num_meshes
    if placement == "reference":
        pos, orient, scale = default_transforms(m)
    elif placement == "grid":
        pos, orient, scale = grid_transforms(m)
    elif placement == "origin":
        # Every mesh at the origin, unit scale — for scenes whose layout is
        # baked into the vertex data (e.g. procedural.colonnade_meshes).
        pos = jnp.zeros((m, 3), jnp.float32)
        orient = jnp.zeros((m, 3), jnp.float32)
        scale = jnp.ones((m, 3), jnp.float32)
    else:
        raise ValueError(
            f"unknown placement {placement!r}: expected 'reference', 'grid',"
            " or 'origin'"
        )
    return SceneState(
        geometry=GeometryBuffers.from_host(geo),
        position=pos,
        orientation=orient,
        scale=scale,
        materials=materials if materials is not None else Materials.from_config(cfg, m),
        camera=Camera.from_config(cfg),
        lights=lights if lights is not None else Lights.directional_only(cfg),
        time=jnp.zeros((), jnp.float32),
    )


def animate(state: SceneState, yaw_per_frame: float = 0.01, cfg=None) -> SceneState:
    """Advance the animation clock and yaw every mesh (main.cpp:200-207).

    Note the reference's quirk: time is frame-count based, not wall-clock
    (static float inside the loop, main.cpp:201).  With cfg.animate_camera the
    camera also orbits the scene (BASELINE config 5 flythrough)."""
    t = jnp.mod(state.time + yaw_per_frame, XM_2PI)
    orientation = state.orientation.at[:, 1].set(t)
    state = dataclasses.replace(state, time=t, orientation=orientation)
    if cfg is not None and cfg.animate_camera:
        # The animation clock wraps at 2*pi (reference quirk, main.cpp:201-203),
        # so only WHOLE revolutions per clock cycle keep the orbit continuous
        # across the wrap — a fractional orbit_speed would teleport the camera
        # every ~628 frames.  Rounding here (min 1) keeps any configured value
        # safe; orbit_speed is documented as revolutions per animation cycle.
        a = t * max(1.0, round(cfg.orbit_speed))
        eye = jnp.stack(
            [
                cfg.orbit_radius * jnp.sin(a),
                jnp.asarray(cfg.orbit_height, jnp.float32),
                -cfg.orbit_radius * jnp.cos(a),
            ]
        )
        state = dataclasses.replace(
            state, camera=dataclasses.replace(state.camera, eye=eye)
        )
    return state


def random_point_lights(
    n: int,
    seed: int = 0,
    extent: float = 8.0,
    radius: float = 3.0,
    intensity: float = 1.2,
    cfg: Optional[RendererConfig] = None,
) -> Lights:
    """N colored point lights scattered over the scene (BASELINE configs 2-5)."""
    cfg = cfg or RendererConfig()
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    pos[:, 1] = rng.uniform(-0.5, 3.0, n).astype(np.float32)
    color = rng.uniform(0.25, 1.0, (n, 3)).astype(np.float32)
    return Lights(
        direction=jnp.asarray(cfg.light_direction, jnp.float32),
        color=jnp.asarray(cfg.light_color, jnp.float32),
        point_position=jnp.asarray(pos),
        point_color=jnp.asarray(color),
        point_radius=jnp.full((n,), radius, jnp.float32),
        point_intensity=jnp.full((n,), intensity, jnp.float32),
    )
