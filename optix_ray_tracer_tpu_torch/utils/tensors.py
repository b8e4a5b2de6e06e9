"""Helpers for the frozen dataclasses of tensors that stand in for the JAX
package's pytrees (``ClusterSet``, ``Scene``, ``Hit``, ...), and the
device rule of the port's entry points."""

from __future__ import annotations

import dataclasses

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
