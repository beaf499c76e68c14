"""The simulated hardware layer: failure injection, heartbeats and straggler
detection, the signals stage-boundary recovery and Phase-3 work stealing
(`core/elasticity.py`) act on."""
from .failures import FailureInjector, HeartbeatMonitor, StragglerDetector

__all__ = ["FailureInjector", "HeartbeatMonitor", "StragglerDetector"]
