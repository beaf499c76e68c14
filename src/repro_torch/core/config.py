"""`SessionConfig`: one object for every session-construction option.

The front doors grew their options one kwarg at a time — `engine=`,
`backend=`, `replication=` (spelled `replicate=` on the kvstore/graph
doors), plus free-form engine opts — and each door re-declared
the set by hand. `SessionConfig` is the single consolidated surface:

    cfg = SessionConfig(engine="tdorch", backend="torch",
                        replication={"num_hot": 32})
    Orchestrator(store, config=cfg)

Every door accepts the same `config=`; the old kwargs keep working through
`resolve_session_config`, whose `KWARG_ALIASES` table is the single source
of truth mapping legacy spellings onto config fields (this is where
`replicate=` and `replication=` are unified so the two can never drift
again). Passing a legacy kwarg that contradicts a non-default field of an
explicit `config=` raises — silent precedence is how drift starts.

This module is import-leaf on purpose (no core imports), so every layer —
engines, sessions, front doors — can depend on it without cycles.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

__all__ = ["SessionConfig", "KWARG_ALIASES", "resolve_session_config",
           "check_kernel_backend"]


@dataclasses.dataclass(frozen=True)
class SessionConfig:
    """Everything that shapes an orchestration session, in one place.

    engine          scheduling strategy: "tdorch" (default), a §2.3
                    baseline name ("push"/"pull"/"sort"), "auto" (the
                    per-stage policy of `core/policy.py`), or a prebuilt
                    engine instance (shares its forest/backend caches).
    backend         numeric execution backend: None/"torch" — the PyTorch
                    pipeline on the CUDA card (raises without one);
                    "torch_spmd" — the mesh-sharded pipeline on the card,
                    one shard a machine (the stacked mesh in one process;
                    one rank a machine inside an initialized
                    `torch.distributed` process group, whose world size
                    must be P); "numpy" — the float64 oracle; or a backend
                    instance (e.g. ``TorchBackend(device="cpu")``,
                    ``TorchSpmdBackend(device="cpu")``) to share device
                    caches or pick the device.
    replication     the adaptive hot-chunk subsystem
                    (`core/replication.py`): True / kwargs dict /
                    `ReplicationConfig` / a shared `HotChunkReplicator`.
    elasticity      the elastic-cluster subsystem (`core/elasticity.py`):
                    an `ElasticityConfig` (or kwargs dict) bundling
                    migration=, stealing=, recovery= — or a shared
                    `ElasticityManager`.
    engine_opts     extra engine-constructor kwargs (fanout=, C=, sigma=,
                    work_per_task=, ...), exactly what the legacy
                    `**engine_opts` tail carried.
    """

    engine: Any = "tdorch"
    backend: Any = None
    replication: Any = None
    elasticity: Any = None
    engine_opts: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def replace(self, **kw) -> "SessionConfig":
        return dataclasses.replace(self, **kw)


# The single-source legacy-kwarg mapping table: old front-door spelling →
# `SessionConfig` field. Notably `replicate` (the kvstore/graph spelling)
# and `replication` (the core spelling) resolve to the same field here —
# adding a new session option means adding a config field plus one row.
KWARG_ALIASES: Dict[str, str] = {
    "engine": "engine",
    "backend": "backend",
    "replication": "replication",
    "replicate": "replication",  # legacy kvstore/graph spelling
    "elasticity": "elasticity",
}


def resolve_session_config(config=None, engine_opts: Dict[str, Any] | None
                           = None, **legacy) -> SessionConfig:
    """Merge an optional `config=` with legacy per-kwarg spellings into one
    resolved `SessionConfig`.

    Legacy kwargs use their OLD names (`KWARG_ALIASES` keys); None means
    "not passed" and defers to the config. A legacy value that contradicts a
    non-default field of an explicit `config=` raises `ValueError` (so do
    two aliases of the same field with different values). `engine_opts`
    merge over the config's, per key.
    """
    if config is not None and not isinstance(config, SessionConfig):
        if isinstance(config, dict):
            config = SessionConfig(**config)
        else:
            raise TypeError(
                f"config= must be a SessionConfig or kwargs dict, "
                f"got {type(config).__name__}")
    cfg = config if config is not None else SessionConfig()
    defaults = SessionConfig()
    updates: Dict[str, Any] = {}
    for kw, val in legacy.items():
        field = KWARG_ALIASES.get(kw)
        if field is None:
            raise TypeError(f"unknown session option {kw!r} "
                            f"(known: {sorted(KWARG_ALIASES)})")
        if val is None:
            continue
        current = getattr(cfg, field)
        if (config is not None and current != getattr(defaults, field)
                and current is not val and current != val):
            raise ValueError(
                f"session option {kw}={val!r} conflicts with "
                f"SessionConfig.{field}={current!r} — set it in one place")
        if field in updates and updates[field] != val:
            raise ValueError(
                f"conflicting spellings for SessionConfig.{field}: "
                f"{updates[field]!r} vs {val!r}")
        updates[field] = val
    if engine_opts:
        updates["engine_opts"] = {**cfg.engine_opts, **engine_opts}
    return dataclasses.replace(cfg, **updates) if updates else cfg


def check_kernel_backend(kernel_backend) -> None:
    """Front doors keep the JAX package's `kernel_backend=` spelling, but
    the port has the one route "auto" (None means the same): any other
    value raises."""
    if kernel_backend not in (None, "auto"):
        raise ValueError(
            f"unsupported kernel_backend {kernel_backend!r}: the torch "
            "port has the one route 'auto'")
