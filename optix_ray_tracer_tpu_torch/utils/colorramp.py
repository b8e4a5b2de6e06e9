"""Color-ramp presets and per-particle material baking.

Same six presets and linear-interpolation semantics as the reference's
header-only ramp library (``include/Util/ColorRamp.cuh:31-152``): stops are
(position, rgb) tables, ``bake_color_ramp(stops, n)`` emits n colors evenly
sampled on [0, 1], and unknown preset names fall back to viridis
(ColorRamp.cuh:146-151, case-insensitive).

A copy of ``optix_ray_tracer_tpu/utils/colorramp.py``
(host numpy; this package does not import the JAX one).
"""

from __future__ import annotations

import numpy as np

# (position, (r, g, b)) stop tables — values from ColorRamp.cuh:31-81.
PRESETS: dict[str, list[tuple[float, tuple[float, float, float]]]] = {
    "plasma": [
        (0.00, (0.050, 0.030, 0.527)),
        (0.25, (0.537, 0.062, 0.549)),
        (0.50, (0.871, 0.191, 0.494)),
        (0.75, (0.992, 0.580, 0.288)),
        (1.00, (0.940, 0.975, 0.131)),
    ],
    "spectral": [
        (0.00, (0.619, 0.003, 0.258)),
        (0.20, (0.835, 0.243, 0.310)),
        (0.40, (0.957, 0.427, 0.263)),
        (0.60, (0.993, 0.681, 0.380)),
        (0.80, (0.741, 0.858, 0.407)),
        (1.00, (0.400, 0.761, 0.647)),
    ],
    "terrain": [
        (0.00, (0.149, 0.149, 0.149)),
        (0.25, (0.114, 0.451, 0.208)),
        (0.50, (0.639, 0.784, 0.325)),
        (0.75, (0.988, 0.972, 0.745)),
        (1.00, (0.996, 0.922, 0.545)),
    ],
    "heatmap": [
        (0.00, (0.050, 0.050, 0.300)),
        (0.25, (0.000, 0.000, 1.000)),
        (0.50, (0.000, 1.000, 1.000)),
        (0.75, (1.000, 1.000, 0.000)),
        (1.00, (1.000, 0.000, 0.000)),
    ],
    "grayscale": [
        (0.00, (0.050, 0.050, 0.050)),
        (1.00, (0.950, 0.950, 0.950)),
    ],
    "viridis": [
        (0.00, (0.267, 0.004, 0.329)),
        (0.25, (0.283, 0.141, 0.458)),
        (0.50, (0.254, 0.265, 0.530)),
        (0.75, (0.196, 0.509, 0.364)),
        (1.00, (0.993, 0.906, 0.144)),
    ],
}


def resolve_preset(name: str) -> str:
    """Case-insensitive preset lookup with viridis fallback
    (ColorRamp.cuh:132-152)."""
    key = str(name).lower()
    return key if key in PRESETS else "viridis"


def bake_color_ramp(preset_or_stops, count: int) -> np.ndarray:
    """Bake ``count`` colors evenly spaced on the ramp.

    Matches ``bakeColorRamp`` (ColorRamp.cuh:83-112): u = i/(count-1),
    segment located by first stop with position >= u, linear lerp inside the
    segment.  count==1 returns the last stop's color.
    Returns float32 (count, 3).
    """
    if isinstance(preset_or_stops, str):
        stops = PRESETS[resolve_preset(preset_or_stops)]
    else:
        stops = list(preset_or_stops)
    if count <= 0 or not stops:
        return np.zeros((0, 3), np.float32)
    if count == 1:
        return np.asarray([stops[-1][1]], np.float32)

    positions = np.asarray([s[0] for s in stops], np.float32)
    colors = np.asarray([s[1] for s in stops], np.float32)

    u = np.arange(count, dtype=np.float32) / np.float32(count - 1)
    # first stop index s>=1 with u <= positions[s]; clamp into valid range
    upper = np.searchsorted(positions, u, side="left").clip(1, len(stops) - 1)
    lower = upper - 1
    span = positions[upper] - positions[lower]
    t = np.where(span > 0.0, (u - positions[lower]) / np.where(span > 0, span, 1.0), 0.0)
    t = np.clip(t, 0.0, 1.0)[:, None]
    return (colors[lower] * (1.0 - t) + colors[upper] * t).astype(np.float32)
