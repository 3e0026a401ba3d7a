"""Carry a state and a field between the JAX package and the port.

``state_from_numpy(np.asarray(s.pos), np.asarray(s.occ), s.sweep,
s.overflow)`` takes an ``mcjax`` SimState across; ``state_to_numpy`` gives
the same four arrays back. Both packages share the slab layout, so nothing
is reordered; a mixture state's species plane comes across as it is.

An external field crosses as a plain dict of its parameters
(``field_to_spec`` reads one off a field of either package, whose field
classes are dataclasses with the same names and constructor arguments);
``field_from_spec`` builds the port's field from it. A frame origin
crosses as a numpy float32 [dim] array (``origin_from_numpy``).

A pair model crosses as the JAX package's checkpoint payload,
``{"kind": class name, "params": constructor arguments}``
(``potential_to_spec`` reads it off a model of either package, the same
payload as ``mcjax.models.potentials.potential_to_dict``);
``potential_from_spec`` builds the port's model from it, a fitted
``PolynomialPotential`` with its coefficients included.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from mcjax_torch.core.device import resolve_device
from mcjax_torch.core.state import SimState
from mcjax_torch.models import fields, potentials


def state_from_numpy(pos, occ, sweep, overflow,
                     device: str | torch.device | None = None) -> SimState:
    """Build a SimState on ``device`` (CUDA unless named) from numpy data."""
    dev = resolve_device(device)
    pos = np.array(pos, dtype=np.float32)   # copies: the tensors own
    occ = np.array(occ, dtype=np.int32)     # their memory
    if pos.ndim < 4 or occ.shape != (pos.shape[0], *pos.shape[3:]):
        raise ValueError(f"pos {pos.shape} and occ {occ.shape} are not one "
                         "slab state")
    return SimState(
        pos=torch.from_numpy(pos).to(dev),
        occ=torch.from_numpy(occ).to(dev),
        sweep=int(np.asarray(sweep)),
        overflow=torch.tensor(bool(np.asarray(overflow)), device=dev),
    )


def state_to_numpy(state: SimState
                   ) -> tuple[np.ndarray, np.ndarray, np.int32, np.bool_]:
    """(pos, occ, sweep, overflow) as numpy values."""
    return (state.pos.cpu().numpy(), state.occ.cpu().numpy(),
            np.int32(state.sweep), np.bool_(bool(state.overflow)))


FIELD_CLASSES = {c.__name__: c for c in (
    fields.HarmonicTrap, fields.LinearField, fields.SlitWalls,
    fields.SpeciesField, fields.CompositeField)}


def field_to_spec(field) -> dict:
    """{"class": name, constructor argument: value, ...} of a field of
    either package; tuples become lists, nested fields (``base``,
    ``fields``) specs."""
    spec = {"class": type(field).__name__}
    for f in dataclasses.fields(field):
        v = getattr(field, f.name)
        if f.name == "base":
            v = field_to_spec(v)
        elif f.name == "fields":
            v = [field_to_spec(x) for x in v]
        elif isinstance(v, tuple):
            v = list(v)
        spec[f.name] = v
    return spec


def field_from_spec(spec: dict):
    """The port's field from ``field_to_spec``'s dict (or one written by
    hand with the same keys)."""
    spec = dict(spec)
    name = spec.pop("class")
    if name not in FIELD_CLASSES:
        raise ValueError(f"unknown field class {name!r}")
    if "base" in spec:
        spec["base"] = field_from_spec(spec["base"])
    if "fields" in spec:
        spec["fields"] = tuple(field_from_spec(x) for x in spec["fields"])
    args = {k: tuple(v) if isinstance(v, list) else v
            for k, v in spec.items()}
    return FIELD_CLASSES[name](**args)


def origin_from_numpy(origin, device: str | torch.device | None = None
                      ) -> torch.Tensor:
    """A frame origin (numpy float32 [dim]) as a tensor on ``device``
    (CUDA unless named)."""
    o = np.array(origin, dtype=np.float32).reshape(-1)
    return torch.from_numpy(o).to(resolve_device(device))


def potential_to_spec(pot) -> dict:
    """{"kind": name, "params": {constructor argument: value}} of a pair
    model of either package; tuples (a polynomial's coefficients, a
    mixture's tables) become lists, so the spec is plain JSON."""
    def plain(v):
        return [plain(x) for x in v] if isinstance(v, (tuple, list)) else v
    spec = potentials.potential_to_dict(pot)
    return {"kind": spec["kind"],
            "params": {k: plain(v) for k, v in spec["params"].items()}}


def potential_from_spec(spec: dict):
    """The port's pair model from ``potential_to_spec``'s dict (or the JAX
    package's ``potential_to_dict`` payload)."""
    return potentials.potential_from_dict(spec)
