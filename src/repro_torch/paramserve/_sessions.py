"""The session cache the parameter-server front doors share: one
long-lived `Orchestrator` per resolved `SessionConfig`."""
from __future__ import annotations

from typing import Dict

from ..core import Orchestrator, SessionConfig


def _spec_sig(spec):
    """Hashable session-cache key for a config spec."""
    if spec is None or spec is False:
        return None
    if spec is True:
        return True
    if isinstance(spec, dict):
        return tuple(sorted((k, _spec_sig(v)) for k, v in spec.items()))
    try:
        hash(spec)
    except TypeError:
        return id(spec)
    return spec


def cached_session(cache: Dict[tuple, Orchestrator], store,
                   cfg: SessionConfig) -> Orchestrator:
    """The session of `cache` for `cfg`, made on first use. Engine and
    backend instances key by identity, specs by value."""
    sig = (cfg.engine if isinstance(cfg.engine, str) else id(cfg.engine),
           _spec_sig(cfg.replication),
           cfg.backend if isinstance(cfg.backend, (str, type(None)))
           else id(cfg.backend),
           _spec_sig(cfg.elasticity),
           tuple(sorted(cfg.engine_opts.items())))
    sess = cache.get(sig)
    if sess is None:
        sess = cache[sig] = Orchestrator(store, config=cfg)
    return sess
