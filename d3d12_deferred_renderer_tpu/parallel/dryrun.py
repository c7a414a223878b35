"""Shared multichip dry-run steps.

These are the EXACT scene/config/mesh constructions and assertions the
driver's recorded MULTICHIP artifact executes (__graft_entry__.dryrun_multichip
delegates here), importable so the CPU test suite runs them VERBATIM first.
Round-4 lesson (VERDICT.md): the recorded artifact must never be the first
executor of a composition — the 3-axis mesh + shadows + bloom + FXAA
combination shipped with an axis-order defect precisely because no test ran
it.  tests/test_dryrun.py now runs every step below on the same 8-device
virtual CPU mesh the driver uses, so any future MULTICHIP:false is preceded by
a test failure by construction.

Reference bar: the reference's cross-pass exactness is enforced by explicit
resource barriers (main.cpp:252-291); the sharded renderer's collectives must
be exactly as airtight, which these pixel-equality assertions certify.
"""
from __future__ import annotations

import dataclasses

import jax
import numpy as np


def staged_config():
    """The staged-path dry-run config: tiny frame, FULL cross-band feature
    stack — replicated shadow map + banded PCF, bloom (all-gathered
    downsampled bright field), FXAA (boundary-row exchange) — so the dry run
    exercises every cross-band collective."""
    import d3d12_deferred_renderer_tpu as dxr

    return dxr.RendererConfig(
        width=128,
        height=32,
        use_pallas=False,
        shading="pbr",
        shadows=True,
        shadow_map_size=64,
        bloom=True,
        fxaa=True,
    )


def kernel_config():
    """The Pallas-interpret dry-run config: the SAME sharded band path a GPU
    runs (binned record stream + the Triton raster and shading kernels per
    band) through the interpreter.  Tiny shapes bound the interpreter cost;
    the config-4 extras are covered by the staged step."""
    import d3d12_deferred_renderer_tpu as dxr

    return dxr.RendererConfig(
        width=128,
        height=64,
        use_pallas=True,
        shading="pbr",
        shadows=False,
        bloom=False,
        fxaa=False,
    )


def dryrun_scene(cfg):
    """Cube + 8 point lights — small enough for interpret mode, busy enough
    that every band/shard contains geometry."""
    import d3d12_deferred_renderer_tpu as dxr

    geo = dxr.build_scene_geometry([dxr.procedural.cube(1.0)])
    lights = dxr.random_point_lights(8, cfg=cfg)
    return dxr.make_scene(geo, cfg, lights=lights)


def factor_axes(n_devices: int, height: int = 32):
    """Factor n into (frames, rows): rows gets the largest power-of-2 factor
    dividing the height (capped at 8); frames take the rest."""
    rows = 1
    n = n_devices
    while n % 2 == 0 and height % (rows * 2) == 0 and rows < 8:
        rows *= 2
        n //= 2
    return n_devices // rows, rows


def assert_matches_single_device(got, start_state, cfg, max_lsb, name):
    """Sharded output must equal the sequential single-device render (one
    jitted frame program, like the sharded one) — the same bounds
    tests/test_parallel.py pins (bit-exact for Lambert, <= 1 u8
    LSB for PBR band-local light culling).  This makes the recorded MULTICHIP
    artifact certify pixel-correct multi-chip rendering, not just
    completion."""
    import d3d12_deferred_renderer_tpu as dxr

    s = start_state
    got = np.asarray(got)
    for i in range(got.shape[0]):
        s, f = dxr.step_frame_jit(s, cfg)
        diff = np.abs(got[i].astype(int) - np.asarray(f).astype(int))
        assert diff.max() <= max_lsb, (
            name, i, int(diff.max()), float((diff > 0).mean())
        )
        assert (diff > 0).mean() < 2e-3, (
            name, i, int(diff.max()), float((diff > 0).mean())
        )


def run_staged(n_devices: int) -> None:
    """Frames x screen-row bands (dp x sp) on the staged-XLA path, with the
    full cross-band feature stack, asserted against single-device frames."""
    from .mesh import make_mesh
    from .sharded import animation_times, render_frames_batch_sharded

    cfg = staged_config()
    state = dryrun_scene(cfg)
    frames_axis, rows = factor_axes(n_devices, cfg.height)
    mesh = make_mesh(
        (frames_axis, rows), ("frame", "rows"),
        devices=jax.devices()[:n_devices],
    )
    batch = max(frames_axis, 2)
    times = animation_times(0.0, batch)
    frames = render_frames_batch_sharded(state, times, cfg, mesh)
    frames.block_until_ready()
    assert frames.shape == (batch, cfg.height, cfg.width, 3), frames.shape
    # PBR band-local light culling may flip 1 LSB (test_parallel.py).
    assert_matches_single_device(frames, state, cfg, 1, "frames x rows")


def run_interpret(n_devices: int) -> None:
    """Interpret-mode Pallas banded step: the kernel code branch a GPU runs,
    asserted against the staged single-device XLA path (<= 1 u8 LSB, the
    test_band_raster.py bound)."""
    from .mesh import make_mesh
    from .sharded import animation_times, render_frames_batch_sharded

    cfg_k = kernel_config()
    state = dryrun_scene(staged_config())
    rows_k = 2 if n_devices % 2 == 0 else 1
    mesh_k = make_mesh(
        (1, rows_k), ("frame", "rows"), devices=jax.devices()[:rows_k]
    )
    frames_k = render_frames_batch_sharded(
        state, animation_times(0.0, 2), cfg_k, mesh_k, pallas_interpret=True
    )
    frames_k.block_until_ready()
    assert frames_k.shape == (2, cfg_k.height, cfg_k.width, 3), frames_k.shape
    assert_matches_single_device(
        frames_k, state,
        dataclasses.replace(cfg_k, use_pallas=False),
        1, "pallas-interpret bands",
    )


def three_axis_mesh(n_devices: int):
    """The 3-axis (frame, tri, rows) mesh the driver dry run declares.  NOTE
    the declaration order deliberately differs from the shading stage's
    (rows-major, tri-minor) band flattening — the round-4 failure mode — so
    this construction keeps pinning mesh-order independence."""
    from .mesh import make_mesh

    tri = 2
    rows3 = 2 if n_devices % 4 == 0 else 1
    frames3 = n_devices // (tri * rows3)
    return make_mesh(
        (frames3, tri, rows3), ("frame", "tri", "rows"),
        devices=jax.devices()[:n_devices],
    ), frames3


def run_three_axis(n_devices: int) -> None:
    """Frames (dp) x triangle shards (sort-last compositing) x screen-row
    bands (sp) with the FULL shadows + bloom + FXAA stack, asserted against
    single-device frames."""
    from .sharded import animation_times, render_frames_batch_tri_sharded

    cfg = staged_config()
    state = dryrun_scene(cfg)
    mesh3, frames3 = three_axis_mesh(n_devices)
    batch3 = max(frames3, 2)
    out = render_frames_batch_tri_sharded(
        state, animation_times(0.0, batch3), cfg, mesh3,
        frame_axis="frame", tri_axis="tri", rows_axis="rows",
    )
    out.block_until_ready()
    assert out.shape == (batch3, cfg.height, cfg.width, 3), out.shape
    # Sort-last triangle compositing must not change pixels either.
    assert_matches_single_device(out, state, cfg, 1, "frames x tri x rows")
