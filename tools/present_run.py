"""Sustained render->present run: the Present(1,0) analog end-to-end.

Drives App.run for N frames at the flagship config with the native threaded
frame sink consuming every presented frame, and reports delivered (present-
side) FPS.  This exercises the full loop the reference's window pump runs
(main.cpp:161-342): animate -> render -> triple-buffered readback -> sink.
Delivered FPS includes the per-frame device->host readback of the frame.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

import d3d12_deferred_renderer_tpu as dxr
from d3d12_deferred_renderer_tpu.runtime import App
from d3d12_deferred_renderer_tpu.utils.debug import enable_compilation_cache

from bench import build  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=300)
    ap.add_argument("--sink", choices=["native", "none"], default="none")
    ap.add_argument(
        "--delta", action="store_true",
        help="dirty-tile present: only changed tiles cross the device->host "
        "link (runtime/delta.py)",
    )
    ap.add_argument(
        "--raw-tiles", action="store_true",
        help="with --delta: disable the pixel-level wire encoding (A/B the "
        "round-4 raw dirty-tile protocol)",
    )
    ap.add_argument(
        "--static", action="store_true",
        help="settled scene (yaw_per_frame=0): frames are bit-identical, so "
        "the delta path's steady-state floor is what's measured",
    )
    args = ap.parse_args()

    enable_compilation_cache()
    if jax.default_backend() != "gpu":
        raise SystemExit(f"needs a GPU, JAX found {jax.default_backend()}")
    cfg = dataclasses.replace(
        dxr.FLAGSHIP_CONFIG,
        **({"yaw_per_frame": 0.0} if args.static else {}),
    )
    _, state, geo = build(cfg)

    cb = None
    if args.sink == "native":
        from d3d12_deferred_renderer_tpu.runtime.native_sink import NativeFrameSink

        sink = NativeFrameSink(
            "/tmp/present_run", cfg.width, cfg.height, num_threads=4
        )
        cb = lambda i, f: sink.push(f, i)  # noqa: E731

    app = App(state, cfg, present_callback=cb, delta_present=args.delta)
    if args.delta and args.raw_tiles:
        app.queue.pixel_level = False
    # Warm up (compile) outside the timed run.
    app.run(2)
    t0 = time.perf_counter()
    stats = app.run(args.frames)
    dt = time.perf_counter() - t0
    extra = ""
    if args.delta:
        q = app.queue
        extra = (
            f", delta moved {q.bytes_transferred / 1e6:.1f} MB of "
            f"{q.bytes_full / 1e6:.1f} MB "
            f"({100 * q.bytes_transferred / max(q.bytes_full, 1):.1f}%)"
        )
    print(
        f"sustained present: {args.frames} frames @ {cfg.width}x{cfg.height} "
        f"in {dt:.2f}s = {args.frames / dt:.1f} FPS delivered "
        f"(sink={args.sink}{extra})",
        flush=True,
    )
    if args.sink == "native":
        sink.close()


if __name__ == "__main__":
    main()
