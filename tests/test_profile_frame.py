"""tools/profile_frame.py's trace reduction: kernels map to frame stages by
the HLO op paths the frame's named scopes leave behind."""
import os
import sys

import jax
import jax.numpy as jnp

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")
)
import profile_frame as pf  # noqa: E402


def _compiled_hlo():
    def f(x):
        with jax.named_scope("setup"):
            y = jnp.sin(x) * 2.0 + 1.0
        with jax.named_scope("raster"):
            with jax.named_scope("binning"):
                z = jnp.sort(y)
            w = z * y
        return w

    return jax.jit(f).lower(jnp.ones(1024)).compile().as_text()


def test_innermost_stage_wins():
    assert pf.stage_of("jit(step)/raster/binning/sort") == "binning"
    assert pf.stage_of("jit(step)/shading/light_cull/reduce_max") == "light_cull"
    assert pf.stage_of("jit(step)/mul") == "other"


def test_kernel_names_map_to_stages():
    """XLA names a GPU kernel after its HLO instruction ('.' -> '_') and may
    run it inside a command buffer; Pallas kernels carry their own names."""
    paths = pf.hlo_op_paths(_compiled_hlo())
    stages = {pf.stage_of(p) for p in paths.values()}
    assert {"setup", "raster", "binning"} <= stages
    name, path = next((n, p) for n, p in paths.items() if pf.stage_of(p) == "setup")
    base, _, idx = name.rpartition(".")
    kernel = f"{base}_{idx}" if idx.isdigit() else name
    buffered = {"tf_op": "XlaModule:", "hlo_op": "command_buffer"}
    assert pf.event_stage(kernel, buffered, paths) == "setup"
    assert pf.event_stage("raster_depth", buffered, paths) == "shadow_map"
    assert pf.event_stage("shade_pbr", buffered, paths) == "shading"
    assert pf.event_stage("memcpy32_post", buffered, paths) == "other"
