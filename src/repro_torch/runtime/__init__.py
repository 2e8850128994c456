from .ft import HeartbeatMonitor

__all__ = ["HeartbeatMonitor"]
