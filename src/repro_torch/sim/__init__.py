"""Single-device decentralized-training simulation (port of
``repro/sim``)."""
from .engine import (SimResult, check_failure_method, eval_mask,
                     materialize_schedule, node_stack,
                     simulate_decentralized, stack_batches)
from .failure import BYZANTINE_MODES, FailureModel
from .sweep import SweepResult, stack_schedules, sweep_decentralized

__all__ = ["BYZANTINE_MODES", "FailureModel", "SimResult", "SweepResult",
           "check_failure_method", "eval_mask", "materialize_schedule",
           "node_stack", "simulate_decentralized", "stack_batches",
           "stack_schedules", "sweep_decentralized"]
