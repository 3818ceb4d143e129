"""Service-tier pieces of the port (so far only the request timing stamps)."""
from .metrics import RequestTiming

__all__ = ["RequestTiming"]
