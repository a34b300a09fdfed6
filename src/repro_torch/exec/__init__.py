"""repro_torch.exec: execution backends that bind a TemplatePlan to a device.

Backends never derive a schedule themselves: stage order, canonical
sharing, exec groups and liveness come from the
:class:`~repro_torch.plan.ir.TemplatePlan` the engine binds them to.
"""

# Import-cycle anchor: repro_torch.core.engine imports this package, so
# entering here first must finish loading the core submodules first.
import repro_torch.core

_CYCLE_ANCHOR = repro_torch

from .base import (
    BagStageTables,
    EngineBackend,
    StageTables,
    build_bag_tables,
    build_stage_tables,
    make_backend,
)
from .local import (
    SELL_GROUP_SIZE,
    BlockedEllBackend,
    CustomBackend,
    DenseBackend,
    EdgesBackend,
    EllBackend,
    LocalBackend,
    MixedBackend,
    SellBackend,
)
from .select import consult_tuning, resolve_backend_config, select_backend, tune_mode

__all__ = [
    "EngineBackend",
    "StageTables",
    "BagStageTables",
    "build_stage_tables",
    "build_bag_tables",
    "make_backend",
    "LocalBackend",
    "EdgesBackend",
    "EllBackend",
    "SellBackend",
    "DenseBackend",
    "BlockedEllBackend",
    "CustomBackend",
    "MixedBackend",
    "SELL_GROUP_SIZE",
    "resolve_backend_config",
    "select_backend",
    "consult_tuning",
    "tune_mode",
]
