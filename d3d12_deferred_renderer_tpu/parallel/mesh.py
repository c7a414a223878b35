"""Device-mesh construction for multi-chip rendering.

The reference has NO distributed anything (SURVEY.md §2: parallelism ABSENT — its
only concurrency is 3 frames of CPU<->GPU pipelining).  Scaling a renderer over
several devices composes three axes: screen-row bands shard across one mesh axis (the
sequence-parallel analog — the G-buffer never crosses chips), batched frames across
another (the data-parallel analog), and the triangle stream across a third
(sort-last compositing, the geometry/tensor-parallel analog — partial fragment
buffers merge with pmin/psum_scatter collectives).  The pixel-parallel paths
gather only the final uint8 framebuffer.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def make_mesh(
    axis_sizes: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = ("frame", "rows"),
    devices=None,
) -> Mesh:
    """Create a Mesh over the available devices.

    Default: all devices on the 'rows' axis (screen-space parallel), i.e.
    axis_sizes = (1, n).  Pass e.g. axis_sizes=(2, 4) for 2-frame x 4-band."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if axis_sizes is None:
        axis_sizes = (1, n)
    if int(np.prod(axis_sizes)) != n:
        raise ValueError(f"axis sizes {axis_sizes} != device count {n}")
    dev_array = np.asarray(devices).reshape(tuple(axis_sizes))
    return Mesh(dev_array, tuple(axis_names))
