"""Trace frames on the GPU and attribute their device time to frame stages.

    python tools/profile_frame.py [--config flagship|config4] [--oracle]
                                  [--frames 3] [--out traces]

Renders the bench.py scene (24 meshes, 256 point lights) at 1080p through
frame.render_stats, warms up, then traces `--frames` frames with
jax.profiler.  Every device kernel is attributed to the innermost frame-stage
scope on its op path (frame.render_stats names them: setup, raster, binning,
bump, gbuffer, shadow_map, pcf, shading, light_cull, post).  Prints one JSON
line: per stage its device milliseconds per frame and kernel launches per
frame, the device busy time and idle share of the traced window, and the
card's name and power limit.  `--oracle` runs the plain-XLA stages
(use_pallas=False) instead of the Triton kernels.
"""
from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import time

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STAGES = (
    "setup", "raster", "binning", "bump", "gbuffer", "shadow_map", "pcf",
    "shading", "light_cull", "post",
)


def stage_of(op_path: str) -> str:
    """Innermost frame-stage scope on an op path ("other" when none)."""
    found = "other"
    for part in op_path.split("/"):
        if part in STAGES:
            found = part
    return found


_INST = re.compile(r"^\s*(ROOT\s+)?%?([\w.\-]+) = ")
_OP_NAME = re.compile(r'op_name="([^"]+)"')
_CALLS = re.compile(r"(?:calls|body|to_apply)=%?([\w.\-]+)")


def hlo_op_paths(hlo_text: str) -> dict:
    """HLO instruction name -> op path (metadata op_name), from compiled HLO
    text.  A fusion or call without its own staged op_name takes the op_name
    of the computation it calls (its ROOT's, else any staged instruction's)."""
    paths, calls, root_of, any_of = {}, {}, {}, {}
    comp = None
    for line in hlo_text.splitlines():
        m = _INST.match(line)
        if not m:
            if line.rstrip().endswith("{"):
                comp = line.split()[0 if not line.startswith("ENTRY") else 1]
                comp = comp.lstrip("%")
            continue
        name = m.group(2)
        op = _OP_NAME.search(line)
        if op:
            paths[name] = op.group(1)
            if stage_of(op.group(1)) != "other":
                any_of.setdefault(comp, op.group(1))
                if m.group(1):
                    root_of[comp] = op.group(1)
        c = _CALLS.search(line)
        if c:
            calls[name] = c.group(1)
    for name, callee in calls.items():
        if stage_of(paths.get(name, "")) == "other":
            staged = root_of.get(callee) or any_of.get(callee)
            if staged:
                paths[name] = staged
    return paths


# The Pallas kernels' names (pallas_call name=...) and the stage each one
# serves in the frame program (the depth-only kernel renders the shadow map).
KERNEL_STAGES = {"raster_depth": "shadow_map", "raster": "raster",
                 "shade_pbr": "shading"}


def event_stage(name: str, stats: dict, op_paths: dict) -> str:
    """Stage of one device kernel event.  XLA names a kernel after its HLO
    instruction with '.' -> '_' (and may run it inside a command buffer, so
    the event's own op stats can name the whole module)."""
    for key in (str(stats.get("tf_op", "")), str(stats.get("hlo_op", ""))):
        if stage_of(key) != "other":
            return stage_of(key)
    path = op_paths.get(str(stats.get("hlo_op", "")), "") or op_paths.get(name, "")
    if not path:
        base, _, idx = name.rpartition("_")
        if idx.isdigit():
            path = op_paths.get(f"{base}.{idx}", "")
    if stage_of(path) != "other":
        return stage_of(path)
    for kernel, stage in KERNEL_STAGES.items():
        if kernel in name:
            return stage
    return "other"


def reduce_trace(trace_dir: str, op_paths: dict, frames: int) -> dict:
    """Per-stage device time and kernel count per frame from an xplane trace."""
    from jax.profiler import ProfileData

    (path,) = glob.glob(os.path.join(trace_dir, "plugins/profile/*/*.xplane.pb"))
    data = ProfileData.from_file(path)
    stages: dict = {}
    intervals = []
    sample = []
    unmapped = []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        lines = [ln for ln in plane.lines if ln.name.startswith("Stream")]
        for line in lines or plane.lines:
            for ev in line.events:
                stats = {k: v for k, v in ev.stats}
                if len(sample) < 60:
                    sample.append({"line": line.name, "name": ev.name,
                                   "stats": {k: str(v) for k, v in stats.items()}})
                stage = event_stage(ev.name, stats, op_paths)
                if stage == "other" and len(unmapped) < 20:
                    unmapped.append(
                        {"name": ev.name, "hlo_op": str(stats.get("hlo_op", ""))}
                    )
                st = stages.setdefault(stage, [0.0, 0])
                st[0] += ev.duration_ns
                st[1] += 1
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not intervals:
        raise RuntimeError("the trace holds no device events")
    intervals.sort()
    busy, cur_s, cur_e = 0.0, *intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = intervals[-1][1] - intervals[0][0]
    return {
        "stages": {
            k: {"ms": round(v[0] / 1e6 / frames, 4), "kernels": v[1] / frames}
            for k, v in sorted(stages.items(), key=lambda kv: -kv[1][0])
        },
        "device_busy_ms": round(busy / 1e6 / frames, 4),
        "idle_share": round(1.0 - busy / window, 4),
        "sample_events": sample,
        "unmapped": unmapped,
    }


def config(name: str, oracle: bool):
    import d3d12_deferred_renderer_tpu as dxr

    cfg = dxr.FLAGSHIP_CONFIG
    if name == "config4":
        cfg = dataclasses.replace(
            cfg, shadows=True, normal_mapping=True, bloom=True, fxaa=True
        )
    return dataclasses.replace(cfg, use_pallas=not oracle)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", choices=("flagship", "config4"), default="flagship")
    ap.add_argument("--oracle", action="store_true")
    ap.add_argument("--frames", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "traces"))
    ap.add_argument("--keep-trace", action="store_true",
                    help="keep the xplane files (large for --oracle)")
    args = ap.parse_args()
    if jax.default_backend() != "gpu":
        print(f"profile_frame: needs a GPU, JAX found {jax.default_backend()}",
              file=sys.stderr)
        return 1
    from bench import build
    from d3d12_deferred_renderer_tpu import frame as fr
    from d3d12_deferred_renderer_tpu.utils.debug import enable_compilation_cache

    enable_compilation_cache()
    cfg = config(args.config, args.oracle)
    _, state, _ = build(cfg)

    def step(s):
        s = fr.animate(s, cfg.yaw_per_frame, cfg)
        frame, stats = fr.render_stats(s, cfg)
        return s, frame, stats["overflow"]

    step = jax.jit(step)
    compiled = step.lower(state).compile()
    op_paths = hlo_op_paths(compiled.as_text())
    for _ in range(2):
        state, frame, ovf = step(state)
    jax.block_until_ready(frame)
    name = f"{args.config}{'_oracle' if args.oracle else ''}"
    trace_dir = os.path.join(args.out, name)
    t0 = time.perf_counter()
    with jax.profiler.trace(trace_dir):
        for _ in range(args.frames):
            state, frame, ovf = step(state)
        jax.block_until_ready(frame)
    wall = (time.perf_counter() - t0) / args.frames
    result = reduce_trace(trace_dir, op_paths, args.frames)
    with open(os.path.join(trace_dir, "sample_events.json"), "w") as f:
        json.dump({"events": result.pop("sample_events"),
                   "unmapped": result.pop("unmapped")}, f, indent=1)
    if not args.keep_trace:
        shutil.rmtree(os.path.join(trace_dir, "plugins"))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    result.update(
        config=name, card=smi, overflow=int(ovf),
        traced_wall_ms_per_frame=round(wall * 1e3, 3),
    )
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
