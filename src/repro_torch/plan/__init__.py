"""Plan layer of the port: the template-set IR and the cost model."""

# Import-cycle anchor (see repro_torch.exec): core.engine imports this
# package, so entering here first finishes loading the core submodules.
import repro_torch.core

_CYCLE_ANCHOR = repro_torch

from .cost import CostModel, pick_chunk_size
from .ir import PlanStage, TemplatePlan, build_template_plan, template_set_canons

__all__ = [
    "CostModel",
    "pick_chunk_size",
    "PlanStage",
    "TemplatePlan",
    "build_template_plan",
    "template_set_canons",
]
