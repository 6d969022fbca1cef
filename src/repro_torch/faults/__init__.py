"""Fault-injection harness: seeded fault plans fired on the engine's
iteration clock, plus the exceptions the execution path hardens against.

    from repro_torch.faults import FaultPlan, FaultInjector, fault_scenario

    inj = FaultInjector(fault_scenario("link_throttle", at=4))
    engine.attach_fault_injector(inj)

See ``repro_torch.faults.injector`` for the event catalogue and
``repro_torch.faults.scenarios`` for the named scenarios the launcher's
``--fault`` flag accepts.
"""
from repro_torch.faults.injector import (FAULT_KINDS, FaultEvent, FaultInjector,
                                   FaultPlan, PermanentTaskFault,
                                   TransientTaskFault)
from repro_torch.faults.scenarios import FAULT_SCENARIOS, fault_scenario

__all__ = ["FAULT_KINDS", "FAULT_SCENARIOS", "FaultEvent", "FaultInjector",
           "FaultPlan", "PermanentTaskFault", "TransientTaskFault",
           "fault_scenario"]
