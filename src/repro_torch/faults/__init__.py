"""Deterministic fault injection + recovery for the PIM runtime stack.

Scenario half: :mod:`repro_torch.faults.plan` (frozen dataclasses + text DSL).
Mechanism half: :mod:`repro_torch.faults.injector` (firing, recovery,
accounting).  Attach via ``PIMRuntime(faults=...)`` /
``Server(faults=...)`` / ``DecodeOffload(faults=...)``; see
docs/robustness.md for the model and its invariants.  Port of
``repro.faults``.
"""
from repro_torch.faults.injector import (
    FaultError,
    FaultInjector,
    NoHealthyChannelsError,
)
from repro_torch.faults.plan import (
    ChannelFault,
    FaultPlan,
    LinkDegradation,
    LinkTransient,
    ServeFault,
    StackFault,
    as_plan,
)

__all__ = [
    "ChannelFault",
    "FaultError",
    "FaultInjector",
    "FaultPlan",
    "LinkDegradation",
    "LinkTransient",
    "NoHealthyChannelsError",
    "ServeFault",
    "StackFault",
    "as_plan",
]
