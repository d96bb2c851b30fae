"""Fault-tolerance pieces of the port: the straggler watchdog and the
heartbeat monitor (stdlib only)."""
from .watchdog import HeartbeatMonitor, StragglerWatchdog  # noqa: F401
