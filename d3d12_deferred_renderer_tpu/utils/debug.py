"""Debug validation — the D3D12 debug layer analog (SURVEY.md §5).

The reference enables the debug layer + GPU-based validation in debug builds
(main.cpp:379-390) to catch API misuse at runtime.  The XLA equivalent hazards are
numerical (NaN/Inf escaping a kernel) and resource-shape mistakes; `debug_layer`
turns on jax's nan/inf checking for a scope, and `validate_scene` fail-fasts on
malformed scene state before the first frame (the reference instead crashes deep
inside LoadObjFile when an asset is missing, main.cpp:824-826).
"""
from __future__ import annotations

import contextlib
import os

import jax
import numpy as np


# The checkout this package runs from (utils/ -> package/ -> checkout/).
_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def enable_compilation_cache(min_compile_secs: float = 2.0) -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX keeps the cache there on its
    own and no other directory is set here; otherwise the cache is the fixed
    `.jax_cache/` inside the checkout (a fixed path, so later runs find it).
    Called by chip_smoke.py, bench.py and tools/demo.py."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = os.path.join(_CHECKOUT, ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", min_compile_secs)
    return path


@contextlib.contextmanager
def debug_layer(nans: bool = True, infs: bool = True):
    """Enable NaN/Inf tripwires for the enclosed scope (re-jits affected fns)."""
    prev_nan = jax.config.jax_debug_nans
    prev_inf = jax.config.jax_debug_infs
    jax.config.update("jax_debug_nans", nans)
    jax.config.update("jax_debug_infs", infs)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev_nan)
        jax.config.update("jax_debug_infs", prev_inf)


def validate_scene(state, cfg) -> None:
    """Fail fast with a clear message on malformed scene state."""
    geo = state.geometry
    V = (geo.vertex_source if geo.vertex_source is not None else geo.positions).shape[0]
    idx = np.asarray(geo.indices)
    problems = []
    if idx.size % 3:
        problems.append(f"index count {idx.size} not divisible by 3")
    if idx.size and (idx.min() < 0 or idx.max() >= V):
        problems.append(f"indices out of range [0, {V}) : min={idx.min()} max={idx.max()}")
    if geo.tri_mesh_id.shape[0] != idx.size // 3:
        problems.append("tri_mesh_id length != triangle count")
    M = state.position.shape[0]
    # Range checks that would otherwise corrupt silently: out-of-bounds
    # gathers CLAMP under jit, and a tri_mesh_id outside [0, M) zeroes its
    # one-hot matrix row (ops/transform.py) — garbage frames, no error.
    tmid = np.asarray(geo.tri_mesh_id)
    if tmid.size and (tmid.min() < 0 or tmid.max() >= M):
        problems.append(
            f"tri_mesh_id out of range [0, {M}): min={tmid.min()} max={tmid.max()}"
        )
    if geo.vertex_source is not None:
        vs = np.asarray(geo.vertex_source)
        Vb = geo.positions.shape[0]
        if vs.size and (vs.min() < 0 or vs.max() >= Vb):
            problems.append(
                f"vertex_source out of range [0, {Vb}): "
                f"min={vs.min()} max={vs.max()}"
            )
    if geo.fv_positions is not None:
        I = idx.size
        for name, arr, rows in [
            ("fv_positions", geo.fv_positions, I),
            ("fv_normals", geo.fv_normals, I),
            ("fv_uvs", geo.fv_uvs, I),
        ]:
            if arr is not None and arr.shape[0] != rows:
                problems.append(
                    f"{name} rows {arr.shape[0]} != index count {rows}"
                )
    for name, arr, shape in [
        ("position", state.position, (M, 3)),
        ("orientation", state.orientation, (M, 3)),
        ("scale", state.scale, (M, 3)),
        ("materials.albedo", state.materials.albedo, (M, 3)),
        ("materials.metalness", state.materials.metalness, (M,)),
        ("materials.roughness", state.materials.roughness, (M,)),
    ]:
        if tuple(arr.shape) != shape:
            problems.append(f"{name} shape {tuple(arr.shape)} != {shape}")
    if not np.isfinite(np.asarray(state.position)).all():
        problems.append("non-finite mesh positions")
    if cfg.width % 2 or cfg.height % 2:
        problems.append(f"odd framebuffer size {cfg.width}x{cfg.height}")
    if problems:
        raise ValueError("invalid scene state:\n  - " + "\n  - ".join(problems))
