"""Storage layer (reference: internal/logdb/, internal/tan/ [U])."""
from .logdb import InMemLogDB, LogDBLogReader

__all__ = ["InMemLogDB", "LogDBLogReader"]
