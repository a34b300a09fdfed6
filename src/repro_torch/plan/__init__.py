"""Plan layer of the port: the template-set IR and the cost model (the
reference's ``repro.plan`` minus its fusion-slack loaders, which the port
pins to 1.0, and minus the mesh column batch, which waits for the mesh
slice)."""

# Import-cycle anchor (see repro_torch.exec): core.engine imports this
# package, so entering here first finishes loading the core submodules.
import repro_torch.core

_CYCLE_ANCHOR = repro_torch

from .cost import (
    DEFAULT_MEMORY_BUDGET_BYTES,
    LOCAL_COLUMN_BATCH,
    MAX_CHUNK_SIZE,
    CostModel,
    RankedCandidate,
    load_backend_calibration,
    pick_chunk_size,
)
from .ir import PlanStage, TemplatePlan, build_template_plan, template_set_canons

__all__ = [
    "CostModel",
    "RankedCandidate",
    "load_backend_calibration",
    "pick_chunk_size",
    "DEFAULT_MEMORY_BUDGET_BYTES",
    "MAX_CHUNK_SIZE",
    "LOCAL_COLUMN_BATCH",
    "PlanStage",
    "TemplatePlan",
    "build_template_plan",
    "template_set_canons",
]
