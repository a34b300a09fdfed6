"""repro_torch.exec: execution backends that bind a TemplatePlan to a device.

Backends never derive a schedule themselves: stage order, canonical
sharing, exec groups and liveness come from the
:class:`~repro_torch.plan.ir.TemplatePlan` the engine binds them to.
"""

# Import-cycle anchor: repro_torch.core.engine imports this package, so
# entering here first must finish loading the core submodules first.
import repro_torch.core

_CYCLE_ANCHOR = repro_torch

from .base import EngineBackend, StageTables, build_stage_tables, make_backend
from .local import (
    SELL_GROUP_SIZE,
    BlockedEllBackend,
    DenseBackend,
    EdgesBackend,
    EllBackend,
    LocalBackend,
    SellBackend,
)
from .select import resolve_backend_config, select_backend

__all__ = [
    "EngineBackend",
    "StageTables",
    "build_stage_tables",
    "make_backend",
    "LocalBackend",
    "EdgesBackend",
    "EllBackend",
    "SellBackend",
    "DenseBackend",
    "BlockedEllBackend",
    "SELL_GROUP_SIZE",
    "resolve_backend_config",
    "select_backend",
]
