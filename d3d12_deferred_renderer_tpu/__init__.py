"""Deferred-shading renderer in JAX/XLA with Pallas-Triton GPU kernels.

A from-scratch framework with the capabilities of the reference D3D12 deferred
renderer (t0yman/d3d12-deferred-renderer): OBJ loading with vertex dedup, unified
vertex/index scene layout, two-pass deferred pipeline (G-buffer -> lighting),
DirectXMath-parity LH math, per-frame animation, triple-buffered presentation —
redesigned for an accelerator: the whole frame is one jitted XLA program,
rasterization is a tile-binned Pallas-Triton kernel, lighting scales to hundreds of
point lights with per-tile culling (a Pallas-Triton shading kernel), and multi-device
scaling shards screen bands / frame batches / triangles over a device mesh.
"""
from .config import FLAGSHIP_CONFIG, REFERENCE_CONFIG, RendererConfig
from .frame import render, render_batch, render_gbuffer, step_frame, step_frame_jit
from .models import (
    build_instanced_geometry,
    build_scene_geometry,
    load_obj,
    procedural,
)
from .scene import (
    Camera,
    Lights,
    Materials,
    SceneState,
    animate,
    make_scene,
    random_point_lights,
)
from .calibrate import autotune
from . import xmath

__all__ = [
    "RendererConfig",
    "REFERENCE_CONFIG",
    "FLAGSHIP_CONFIG",
    "render",
    "render_batch",
    "render_gbuffer",
    "step_frame",
    "step_frame_jit",
    "load_obj",
    "build_scene_geometry",
    "build_instanced_geometry",
    "procedural",
    "Camera",
    "Lights",
    "Materials",
    "SceneState",
    "animate",
    "make_scene",
    "random_point_lights",
    "xmath",
]

__version__ = "0.1.0"
