"""repro_torch.exec — RaceOp registry + resolved ExecPlan (port of repro.exec)."""
from .plan import (ExecPlan, ResolvedOp, Degrade, as_plan, resolve_plan,
                   reset_plan_cache)
from .registry import OP_SLOTS, BackendSpec, get_backend, list_backends, register

__all__ = ["ExecPlan", "ResolvedOp", "Degrade", "as_plan", "resolve_plan",
           "reset_plan_cache", "OP_SLOTS", "BackendSpec", "get_backend",
           "list_backends", "register"]
