"""Engine + execution-backend registries: the two pluggable axes behind the
orchestration interface.

Engines self-register with `@register_engine("name")`, so adding a strategy
is one decorator away — no central table to edit. An engine class takes
`(num_machines, **opts)` and exposes
`run_stage(tasks, store, f, write_back=..., return_results=...)`.

Execution backends (`@register_backend`) are orthogonal to engines: an
engine decides *where* tasks run and *what the wire carries* (the cost
model); a backend decides *how the numeric work is executed* — the pure
numpy reference pass, or the PyTorch pipeline that dispatches to the
hand-written CUDA kernels. Every engine takes `backend=` and charges identical
costs on either one (the backend-parity contract in `core/backend.py`).
"""
from __future__ import annotations

from typing import Callable, Dict, Type

ENGINES: Dict[str, type] = {}
BACKENDS: Dict[str, type] = {}


def register_engine(name: str) -> Callable[[type], type]:
    """Class decorator registering an orchestration engine under `name`."""

    def deco(cls: type) -> type:
        if name in ENGINES and ENGINES[name] is not cls:
            raise ValueError(f"engine {name!r} already registered "
                             f"({ENGINES[name].__name__})")
        ENGINES[name] = cls
        return cls

    return deco


def get_engine_cls(name: str) -> Type:
    try:
        return ENGINES[name]
    except KeyError:
        raise KeyError(
            f"unknown engine {name!r}; available: {sorted(ENGINES)}") from None


def make_engine(name: str, num_machines: int, **opts):
    return get_engine_cls(name)(num_machines, **opts)


def register_backend(name: str) -> Callable[[type], type]:
    """Class decorator registering an execution backend under `name`."""

    def deco(cls: type) -> type:
        if name in BACKENDS and BACKENDS[name] is not cls:
            raise ValueError(f"backend {name!r} already registered "
                             f"({BACKENDS[name].__name__})")
        BACKENDS[name] = cls
        return cls

    return deco


def get_backend_cls(name: str) -> Type:
    try:
        return BACKENDS[name]
    except KeyError:
        raise KeyError(
            f"unknown backend {name!r}; available: {sorted(BACKENDS)}") from None
