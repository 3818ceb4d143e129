"""LM serving engine of the port."""
from .engine import Request, ServingEngine

__all__ = ["Request", "ServingEngine"]
