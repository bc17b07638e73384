"""Cluster-level integration: ESDP as the gang dispatcher of multi-pod
training and serving jobs (counterpart of ``repro.sched``; its streaming
``DispatchEngine`` is not ported yet)."""
from .cluster import JobType, Slice, build_instance, validate_jobs
from .dispatcher import (ClusterSim, FailureModel, FailureRuntime,
                         MalleableModel, MalleableRuntime, SimOutput)
from .engine import LOCKSTEP_POLICIES, feasible_ports, lockstep_run
from .ratemodel import rate_matrix, roofline_rate

__all__ = ["JobType", "Slice", "build_instance", "validate_jobs",
           "ClusterSim", "SimOutput", "FailureModel", "FailureRuntime",
           "MalleableModel", "MalleableRuntime",
           "LOCKSTEP_POLICIES", "feasible_ports", "lockstep_run",
           "rate_matrix", "roofline_rate"]
