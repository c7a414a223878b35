"""The single backend choice (ops/dispatch.py), full-precision products, the
compile-cache location and chip_smoke.py's refusal to run without a GPU."""
import dataclasses
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu import frame as fr
from d3d12_deferred_renderer_tpu.ops import dispatch
from d3d12_deferred_renderer_tpu.ops.transform import setup_frame_triangles

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cube_state(cfg, n_lights=4):
    geo = dxr.build_scene_geometry([dxr.procedural.cube(1.0)])
    lights = dxr.random_point_lights(n_lights, cfg=cfg)
    return dxr.animate(dxr.make_scene(geo, cfg, lights=lights))


def _primitives(fn, *args):
    """Every primitive name in fn's jaxpr, sub-jaxprs included."""
    names = set()

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            names.add(eqn.primitive.name)
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return names


def _raster_prims(cfg, interpret=False):
    state = _cube_state(cfg)
    tris, _ = setup_frame_triangles(state, cfg)
    return _primitives(
        lambda p, a: dispatch.rasterize(p, a, cfg, interpret=interpret),
        tris.packed, tris.aabb,
    )


def test_cpu_runs_the_oracles():
    cfg = dxr.RendererConfig(width=128, height=32)
    assert jax.default_backend() == "cpu"
    assert dispatch.kernel_mode(cfg) == dispatch.XLA
    assert "pallas_call" not in _raster_prims(cfg)


def test_interpret_only_when_asked():
    cfg = dxr.RendererConfig(width=128, height=32)
    assert dispatch.kernel_mode(cfg, interpret=True) == dispatch.INTERPRET
    assert "pallas_call" in _raster_prims(cfg, interpret=True)
    # use_pallas=False wins over interpret: the oracle, with no kernel.
    off = dataclasses.replace(cfg, use_pallas=False)
    assert dispatch.kernel_mode(off, interpret=True) == dispatch.XLA
    assert "pallas_call" not in _raster_prims(off, interpret=True)


@pytest.mark.parametrize("use_pallas,want", [(True, "triton"), (False, "xla")])
def test_gpu_backend_runs_the_kernels(monkeypatch, use_pallas, want):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    cfg = dxr.RendererConfig(use_pallas=use_pallas)
    assert dispatch.kernel_mode(cfg) == want


@pytest.mark.parametrize("tile", [(8, 100), (12, 128), (0, 128)])
def test_gpu_backend_unsupported_config_raises(monkeypatch, tile):
    """A config the Triton kernels cannot run raises on a GPU; it never falls
    back to the oracle (and the same config is refused in interpret mode)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    cfg = dxr.RendererConfig(tile_h=tile[0], tile_w=tile[1])
    with pytest.raises(ValueError, match="power-of-two"):
        dispatch.kernel_mode(cfg)
    with pytest.raises(ValueError, match="power-of-two"):
        dispatch.kernel_mode(cfg, interpret=True)


def test_unknown_backend_raises(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    with pytest.raises(NotImplementedError):
        dispatch.kernel_mode(dxr.RendererConfig())


def _dot_precisions(fn, *args):
    out = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return out


@pytest.mark.parametrize(
    "extra",
    [
        {},
        {"shading": "pbr", "shadows": True, "shadow_map_size": 64},
        {"shading": "pbr", "normal_mapping": True, "bloom": True, "fxaa": True},
    ],
    ids=["lambert", "pbr_shadows", "pbr_bump_post"],
)
def test_every_product_is_full_precision(extra):
    """A GPU runs default-precision float32 products in TF32: every
    dot_general of the frame program asks for HIGHEST."""
    cfg = dxr.RendererConfig(width=128, height=32, **extra)
    state = _cube_state(cfg)
    precisions = _dot_precisions(lambda s: fr.render_stats(s, cfg), state)
    assert precisions, "the frame has matrix products"
    highest = jax.lax.Precision.HIGHEST
    for p in precisions:
        assert p is not None and all(q == highest for q in p), p


@pytest.mark.parametrize("env_set", [False, True], ids=["default", "env"])
def test_compile_cache_location(tmp_path, env_set):
    """JAX_COMPILATION_CACHE_DIR, when set, is where the cache lands (and
    nothing else is set in code); otherwise <checkout>/.jax_cache."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_set:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    code = (
        "import jax; jax.config.update('jax_platforms', 'cpu'); "
        "from d3d12_deferred_renderer_tpu.utils.debug import "
        "enable_compilation_cache as e; p = e(); "
        "print(p); print(jax.config.jax_compilation_cache_dir)"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, cwd=ROOT, capture_output=True,
        text=True, check=True, timeout=120,
    ).stdout.split()
    want = str(tmp_path / "cache") if env_set else os.path.join(ROOT, ".jax_cache")
    assert out == [want, want]


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=120,
    )


def test_chip_smoke_fails_without_a_gpu():
    p = _run_smoke(ROOT)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
    assert "needs a GPU" in p.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    p = _run_smoke(tmp_path)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout


@pytest.mark.gpu
def test_gpu_frame_matches_oracle(gpu):
    """On a GPU: one frame with the Triton kernels against the oracle."""
    cfg = dxr.RendererConfig(width=256, height=128, shading="pbr")
    state = _cube_state(cfg, n_lights=16)
    got = np.asarray(jax.jit(lambda s: fr.render(s, cfg))(state)).astype(int)
    want = np.asarray(
        jax.jit(lambda s: fr.render(s, dataclasses.replace(cfg, use_pallas=False)))(state)
    ).astype(int)
    d = np.abs(got - want)
    assert d.mean() <= 0.5 and (d.max(-1) > 4).mean() <= 0.005


@pytest.mark.gpu
def test_gpu_kernels_in_the_frame(gpu):
    """On a GPU the frame program holds the kernels, not the oracle's scan."""
    cfg = dxr.RendererConfig(width=256, height=128, shading="pbr")
    state = _cube_state(cfg)
    hlo = jax.jit(lambda s: fr.render(s, cfg)).lower(state).as_text()
    assert "triton" in hlo
    assert jnp.asarray(0).devices().pop().platform == "gpu"
