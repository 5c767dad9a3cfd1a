"""Communication layer (reference: internal/transport/ [U])."""
from .inproc import InProcTransport, reset_inproc_network
from .registry import Registry
from .transport import Transport

__all__ = ["InProcTransport", "reset_inproc_network", "Registry", "Transport"]
