"""Helpers for the frozen dataclasses of tensors that stand in for the JAX
package's pytrees (``ClusterSet``, ``Scene``, ``Hit``, ...), the device
rule of the port's entry points, and the cache of device constants."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point builds its tensors on: ``device`` where
    given, else the card.  Decided at call time; without CUDA and without
    a ``device`` it raises instead of falling back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass device="cpu" to build on '
                           'the CPU')
    return torch.device("cuda")


def tree_map(fn, obj):
    """A copy of dataclass ``obj`` with ``fn`` applied to every tensor
    field, recursing into fields that are dataclasses themselves."""
    changes = {}
    for f in dataclasses.fields(obj):
        val = getattr(obj, f.name)
        if isinstance(val, torch.Tensor):
            changes[f.name] = fn(val)
        elif dataclasses.is_dataclass(val) and not isinstance(val, type):
            changes[f.name] = tree_map(fn, val)
    return dataclasses.replace(obj, **changes)


class TensorDataclass:
    """Mixin: ``.to(device)`` moves every tensor field."""

    def to(self, device):
        return tree_map(lambda t: t.to(device), self)


def nanmin(x: torch.Tensor, dim) -> torch.Tensor:
    """``jnp.nanmin``: the min over ``dim`` ignoring NaN; NaN where every
    element is NaN."""
    nan = torch.isnan(x)
    m = torch.amin(x.masked_fill(nan, float("inf")), dim=dim)
    return m.masked_fill(torch.all(nan, dim=dim), float("nan"))


def nanmax(x: torch.Tensor, dim) -> torch.Tensor:
    """``jnp.nanmax``: the max over ``dim`` ignoring NaN; NaN where every
    element is NaN."""
    nan = torch.isnan(x)
    m = torch.amax(x.masked_fill(nan, float("-inf")), dim=dim)
    return m.masked_fill(torch.all(nan, dim=dim), float("nan"))


class ConstantCache:
    """Device tensors that depend only on a shape or a fixed value, built
    once per key and kept: a copy of host memory to a CUDA device waits
    for the work queued before it, so the frame loop takes such tables
    from here instead.  ``built`` and ``reused`` count the lookups that
    built a table and those that found one (as ``_lib.Kernel.launches``
    counts launches); :meth:`reset` zeroes both.  A table is shared by
    every caller: never write one in place."""

    def __init__(self):
        self.tables: dict = {}
        self.built = 0
        self.reused = 0

    def reset(self) -> None:
        self.built = 0
        self.reused = 0

    def get(self, key, build):
        """The table under ``key``, which names all it depends on (a
        shape, a device, a value); ``build()`` makes it the first time."""
        table = self.tables.get(key)
        if table is None:
            table = self.tables[key] = build()
            self.built += 1
        else:
            self.reused += 1
        return table


#: the program's one cache of device constants
CONSTANTS = ConstantCache()


def device_constant(values, device) -> torch.Tensor:
    """Host ``values`` (a number or a sequence) rounded to float32, as a
    tensor on ``device`` kept in :data:`CONSTANTS` under their bits; a
    tensor is only cast and moved (``torch.as_tensor``), not kept."""
    if isinstance(values, torch.Tensor):
        return torch.as_tensor(values, dtype=torch.float32, device=device)
    v = np.asarray(values, np.float32)
    device = torch.device(device)
    return CONSTANTS.get(("float32", v.shape, v.tobytes(), device),
                         lambda: torch.as_tensor(v, device=device))
