"""Plan layer of the port: the template-set IR and the cost model with the
mesh comm model (the reference's ``repro.plan``).  ``python -m
repro_torch.plan`` is the plan inspector."""

# Import-cycle anchor (see repro_torch.exec): core.engine imports this
# package, so entering here first finishes loading the core submodules.
import repro_torch.core

_CYCLE_ANCHOR = repro_torch

from .cost import (
    DEFAULT_MEMORY_BUDGET_BYTES,
    LOCAL_COLUMN_BATCH,
    MAX_CHUNK_SIZE,
    MESH_COLUMN_BATCH,
    CommSchedule,
    CostModel,
    RankedCandidate,
    fusion_slack_factor,
    load_backend_calibration,
    load_fusion_slack,
    pick_chunk_size,
)
from .ir import PlanStage, TemplatePlan, build_template_plan, template_set_canons

__all__ = [
    "CostModel",
    "RankedCandidate",
    "CommSchedule",
    "MESH_COLUMN_BATCH",
    "load_backend_calibration",
    "load_fusion_slack",
    "fusion_slack_factor",
    "pick_chunk_size",
    "DEFAULT_MEMORY_BUDGET_BYTES",
    "MAX_CHUNK_SIZE",
    "LOCAL_COLUMN_BATCH",
    "PlanStage",
    "TemplatePlan",
    "build_template_plan",
    "template_set_canons",
]
