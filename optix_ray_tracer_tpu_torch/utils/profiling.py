"""The program's spans: named host ranges that land in a
``torch.profiler`` trace beside the device's kernels, on the clock the
profiler aligns them to (port of ``optix_ray_tracer_tpu/utils/
profiling.py``, whose stage timers synchronised the device at every
stage end and so hid the pipelining they timed).

:func:`span` is the one way in.  While a profiler records, it returns a
``torch.profiler.record_function`` range, which the trace holds as a
``user_annotation`` event; otherwise it returns one shared null context,
so a span costs about a microsecond when nothing records.  A span's
count is the count of its events in the trace: there is no second
counter store.

Names, by the part before the first dot: ``fused.*`` the fused frame
loop's phases (``models/fused``), ``route.*`` the raster query routes
(``ops/march``), ``sync.<site>`` each host read of a device value on the
frame loop's path, ``path.*`` the path tracer's sections
(``render/pathtracer``).

The reference has no profiling beyond its frame pacer
(``SDL_GraphicsWindow.cu:265-274``).
"""

from __future__ import annotations

import contextlib

import torch

_NULL = contextlib.nullcontext()
_recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A ``record_function(name)`` range while a torch profiler records,
    else the shared null context; use as ``with span("fused.chunk"):``.
    Never hold one open across a ``yield``: the caller's time would count
    as the program's."""
    return torch.profiler.record_function(name) if _recording() else _NULL
