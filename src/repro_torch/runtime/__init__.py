"""The simulated hardware layer (failure injection, heartbeats and
straggler detection, the signals stage-boundary recovery and Phase-3 work
stealing in `core/elasticity.py` act on), gradient compression, and the
fault-tolerant trainer."""
from .compression import CompressionState, compress_gradients, decompress
from .failures import FailureInjector, HeartbeatMonitor, StragglerDetector

__all__ = [
    "CompressionState", "compress_gradients", "decompress",
    "FailureInjector", "HeartbeatMonitor", "StragglerDetector",
    "Trainer", "TrainerConfig",
]


def __getattr__(name):
    # Trainer pulls in the model stack (models -> core); importing it here
    # eagerly would cycle with core.elasticity's use of runtime.failures,
    # so the trainer exports resolve lazily (PEP 562).
    if name in ("Trainer", "TrainerConfig"):
        from . import trainer
        return getattr(trainer, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
