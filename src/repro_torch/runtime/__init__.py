"""Runtime of the port: serving, training (on one device or across the
ranks of a mesh), sharding rules, the pipeline (``runtime.pp``), and
fault injection and detection."""
from .fault import (FAULT_RATE_ENV, FAULT_SEED_ENV, CrashRateTracker,
                    FailureInjector, InjectedFault, StragglerTracker,
                    TrainSupervisor, fault_rate_from_env, planned_fault)
from .serve_step import greedy_generate, make_decode_step, make_prefill_step
from .sharding import PRESETS, Rules, make_rules
from .train_step import TrainState, init_train_state, make_train_step

__all__ = ["greedy_generate", "make_decode_step", "make_prefill_step",
           "TrainState", "init_train_state", "make_train_step",
           "PRESETS", "Rules", "make_rules",
           "FailureInjector", "StragglerTracker", "CrashRateTracker",
           "TrainSupervisor", "InjectedFault", "planned_fault",
           "fault_rate_from_env", "FAULT_RATE_ENV", "FAULT_SEED_ENV"]
