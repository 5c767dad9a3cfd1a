"""Replicated-state-machine execution layer (reference: internal/rsm/ [U])."""
from .session import Session as RSMSession, SessionManager
from .managed import ManagedStateMachine, wrap_state_machine, SMType
from .statemachine import StateMachine, Task, TaskQueue

__all__ = [
    "RSMSession",
    "SessionManager",
    "ManagedStateMachine",
    "wrap_state_machine",
    "SMType",
    "StateMachine",
    "Task",
    "TaskQueue",
]
