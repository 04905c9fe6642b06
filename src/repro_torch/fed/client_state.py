"""Named per-client state of the compression pipelines (port of
``repro.fed.client_state``).

A stateful pipeline stage declares its persistent buffers through
``state_spec(n_coords) -> tuple[StateSlot, ...]``. Each slot names one
buffer and gives its per-client shape; the engine stacks the client-scope
slots into ``{name: (client_groups, n_clients) + shape}`` once
(``fedavg.init_server_state``). ``merge="keep"`` is the dead-client rule: a
client that does not take part in a round keeps its rows bit-exactly.

Slot names are the keys of the state dict the pipeline reads and returns
(``state["ef"]`` is the error-feedback residual); they must be unique across
a pipeline's stages, and a collision is a build-time error.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

__all__ = ["StateSlot", "collect_slots", "init_tree", "merge_rows",
           "SCOPES", "MERGE_RULES"]

SCOPES = ("client", "server")
MERGE_RULES = ("keep",)


@dataclasses.dataclass(frozen=True)
class StateSlot:
    """One named persistent buffer of a stateful pipeline stage."""
    name: str
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    scope: str = "client"
    merge: str = "keep"

    def __post_init__(self):
        if not self.name or not isinstance(self.name, str):
            raise ValueError(f"state slot needs a non-empty string name, "
                             f"got {self.name!r}")
        if self.scope not in SCOPES:
            raise ValueError(f"state slot {self.name!r}: scope must be one "
                             f"of {SCOPES}, got {self.scope!r}")
        if self.merge not in MERGE_RULES:
            raise ValueError(f"state slot {self.name!r}: merge must be one "
                             f"of {MERGE_RULES}, got {self.merge!r}")
        object.__setattr__(self, "shape", tuple(int(s) for s in self.shape))

    def zeros(self, lead: Tuple[int, ...] = (), device=None,
              pin_memory: bool = False) -> torch.Tensor:
        """Zeros of ``lead + shape`` (``lead`` stacks rows, e.g. the
        (client_groups, n_clients) axes of the engine's state); in pinned
        host memory with ``pin_memory``."""
        return torch.zeros(tuple(lead) + self.shape, dtype=self.dtype,
                           device=device, pin_memory=pin_memory)


def collect_slots(stages, n_coords: int) -> Tuple[StateSlot, ...]:
    """All slots declared by ``stages`` (via ``state_spec``), in stage
    order. Raises ``ValueError`` on a slot-name collision."""
    slots, owner = [], {}
    for st in stages:
        spec = getattr(st, "state_spec", None)
        if spec is None:
            continue
        for s in spec(n_coords):
            if s.name in owner:
                raise ValueError(
                    f"state slot name collision: {s.name!r} declared by "
                    f"both {type(owner[s.name]).__name__} and "
                    f"{type(st).__name__} — slot names must be unique "
                    f"across a pipeline's stages")
            owner[s.name] = st
            slots.append(s)
    return tuple(slots)


def init_tree(slots, scope: str, lead: Tuple[int, ...] = (), device=None,
              pin_memory: bool = False):
    """Zero-initialised ``{name: buffer}`` dict for one scope (each buffer
    of shape ``lead + slot.shape``), or None when no slot has that scope
    (the engine's "stateless" marker)."""
    sel = {s.name: s.zeros(lead, device, pin_memory) for s in slots
           if s.scope == scope}
    return sel or None


def merge_rows(new_state, old_state, mask: torch.Tensor):
    """The merge="keep" dead-client rule over stacked state rows: rows of
    clients with ``mask > 0`` take the new value, dead clients keep their
    old rows bit-exactly. ``mask`` has one entry per leading-axis row of
    every buffer."""
    def _merge(new, old):
        m = mask.to(new.device).reshape(
            tuple(mask.shape) + (1,) * (new.ndim - mask.ndim))
        return torch.where(m > 0, new, old)
    return {k: _merge(new_state[k], old_state[k]) for k in new_state}
