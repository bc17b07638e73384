"""Cluster-level integration: ESDP as the gang dispatcher of multi-pod
training and serving jobs (counterpart of ``repro.sched``): the lockstep
``ClusterSim`` and the streaming ``DispatchEngine`` (admission, a bounded
queue with backpressure, weighted A/B policy variants)."""
from .cluster import JobType, Slice, build_instance, validate_jobs
from .dispatcher import (ClusterSim, FailureModel, FailureRuntime,
                         MalleableModel, MalleableRuntime, SimOutput)
from .engine import (BACKPRESSURE_POLICIES, LOCKSTEP_POLICIES, DispatchEngine,
                     EngineConfig, EngineOutput, VariantSpec, feasible_ports,
                     lockstep_run)
from .ratemodel import rate_matrix, roofline_rate

__all__ = ["JobType", "Slice", "build_instance", "validate_jobs",
           "ClusterSim", "SimOutput", "FailureModel", "FailureRuntime",
           "MalleableModel", "MalleableRuntime",
           "BACKPRESSURE_POLICIES", "LOCKSTEP_POLICIES", "DispatchEngine",
           "EngineConfig", "EngineOutput", "VariantSpec", "feasible_ports",
           "lockstep_run", "rate_matrix", "roofline_rate"]
