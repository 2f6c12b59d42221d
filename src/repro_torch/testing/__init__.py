"""Test harnesses: deterministic fault injection for the execution seams
(a copy of ``repro.testing``)."""
from .faults import (
    KINDS,
    TARGETS,
    FaultEvent,
    FaultInjector,
    FaultReport,
    FaultSpec,
    FaultySketchTap,
    InjectedFault,
    InjectedPreemption,
)

__all__ = [
    "KINDS",
    "TARGETS",
    "FaultEvent",
    "FaultInjector",
    "FaultReport",
    "FaultSpec",
    "FaultySketchTap",
    "InjectedFault",
    "InjectedPreemption",
]
