"""TuningConfig: the value a tuning run produces and an engine consumes.

The port of ``repro.tune.config``, unchanged: the same fields, JSON layout,
schema version and key fragment, so a cache entry means the same thing in
both packages.  A :class:`TuningConfig` pins every knob the autotuner
searches over — the per-exec-group backend binding (possibly *mixed*:
different backends for different stages of one plan), the fused-slice
``column_batch``, and the coloring ``chunk_size``.  It is a pure, frozen,
JSON-round-trippable value object with **no imports from the
plan/cost/exec layers**, so the cache module, the cost model's candidate
lattice, and the engine can all pass it around without import cycles.

Group bindings are addressed by the plan's exec-group *leader* — the
``(plan_idx, sub_idx)`` stage address that
:attr:`repro_torch.plan.ir.TemplatePlan.exec_groups` keys groups by —
because that is the address the local executor dispatches on.  Binding
addresses are only meaningful against the plan the config was tuned for;
the tuning cache therefore keys entries by the plan's canon sequence (see
:mod:`repro_torch.tune.cache`), so a config can never be applied to a plan
with a different schedule.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

__all__ = ["TuningConfig", "TUNING_SCHEMA_VERSION"]

#: Schema version of the persisted cache file AND of serialized configs.
#: Bump on any incompatible layout change — loaders ignore (with a warning)
#: files or entries written under a different version.
#: v2: added ``memory_budget_bytes`` (the tuner sweeps the chunk picker's
#: budget) and ``mesh_comm`` (blocking | pipelined mesh collectives).
TUNING_SCHEMA_VERSION = 2


@dataclass(frozen=True)
class TuningConfig:
    """One tuned engine configuration (immutable, hashable).

    Attributes:
      default_backend: local backend name for every exec group without an
        explicit binding — and for bag ops and plain ``spmm`` calls, which
        are never group-bound.
      group_backends: sorted ``((plan_idx, sub_idx), backend)`` pairs
        binding specific exec-group leaders to specific backends.  Empty
        for a uniform (single-backend) config.
      column_batch: fused-slice width, or ``None`` to keep the engine's
        auto-pick.
      chunk_size: colorings per launch, or ``None`` to keep the picker's.
      memory_budget_bytes: the chunk picker's live-footprint budget this
        config was tuned under, or ``None`` for the caller's/default
        budget.  Folded into :meth:`key_fragment` so differently-budgeted
        engines never share compiled programs.
      mesh_comm: the mesh backend's collective scheme (``"blocking"`` |
        ``"pipelined"``), or ``None`` to keep the cost model's per-stage
        decision.  Meaningless (and ignored) on local backends.
    """

    default_backend: str
    group_backends: Tuple[Tuple[Tuple[int, int], str], ...] = ()
    column_batch: Optional[int] = None
    chunk_size: Optional[int] = None
    memory_budget_bytes: Optional[int] = None
    mesh_comm: Optional[str] = None
    version: int = field(default=TUNING_SCHEMA_VERSION)

    def __post_init__(self):
        # normalize: bindings sorted by address, redundant (== default)
        # bindings kept — they are meaningful ("this group was measured"),
        # but order must be canonical for key_fragment()/JSON stability
        object.__setattr__(
            self,
            "group_backends",
            tuple(
                sorted(
                    ((int(p), int(i)), str(b))
                    for (p, i), b in self.group_backends
                )
            ),
        )

    # -- derived views -------------------------------------------------------

    @property
    def mixed(self) -> bool:
        """True when any group is bound to a non-default backend."""
        return any(b != self.default_backend for _, b in self.group_backends)

    @property
    def backend_name(self) -> str:
        """The engine-level backend name this config resolves to:
        ``"mixed"`` when bindings disagree, else the uniform backend."""
        return "mixed" if self.mixed else self.default_backend

    def bindings(self) -> Dict[Tuple[int, int], str]:
        """Leader address -> backend name (executor dispatch form)."""
        return {addr: b for addr, b in self.group_backends}

    def key_fragment(self) -> Tuple:
        """The hashable fragment :func:`repro_torch.core.engine.engine_cache_key`
        appends for a tuned engine — two engines tuned differently must
        never share compiled programs.  New fields append at the END so
        positional consumers of earlier elements keep their offsets."""
        return (
            "tuned",
            self.default_backend,
            self.group_backends,
            None if self.column_batch is None else int(self.column_batch),
            None if self.chunk_size is None else int(self.chunk_size),
            None
            if self.memory_budget_bytes is None
            else int(self.memory_budget_bytes),
            self.mesh_comm,
        )

    def describe(self) -> Dict:
        """JSON-safe summary for ``engine.describe()`` / service stats."""
        return {
            "backend": self.backend_name,
            "default_backend": self.default_backend,
            "groups": {f"{p}:{i}": b for (p, i), b in self.group_backends},
            "column_batch": self.column_batch,
            "chunk_size": self.chunk_size,
            "memory_budget_bytes": self.memory_budget_bytes,
            "mesh_comm": self.mesh_comm,
        }

    # -- JSON round trip (bit-exact: ints and strings only) ------------------

    def to_json(self) -> Dict:
        return {
            "version": int(self.version),
            "default_backend": self.default_backend,
            "group_backends": [
                [[p, i], b] for (p, i), b in self.group_backends
            ],
            "column_batch": self.column_batch,
            "chunk_size": self.chunk_size,
            "memory_budget_bytes": self.memory_budget_bytes,
            "mesh_comm": self.mesh_comm,
        }

    @staticmethod
    def from_json(data: Dict) -> "TuningConfig":
        """Inverse of :meth:`to_json`; raises ``ValueError`` on malformed
        or version-mismatched input (callers turn that into a warning)."""
        if not isinstance(data, dict):
            raise ValueError(f"TuningConfig JSON must be an object, got {type(data)}")
        version = data.get("version")
        if version != TUNING_SCHEMA_VERSION:
            raise ValueError(
                f"TuningConfig version {version!r} != supported "
                f"{TUNING_SCHEMA_VERSION}"
            )
        default = data.get("default_backend")
        if not isinstance(default, str) or not default:
            raise ValueError(f"bad default_backend {default!r}")
        raw_groups = data.get("group_backends", [])
        groups = []
        for entry in raw_groups:
            (p, i), b = entry  # malformed shapes raise here
            groups.append(((int(p), int(i)), str(b)))
        cb = data.get("column_batch")
        chunk = data.get("chunk_size")
        budget = data.get("memory_budget_bytes")
        mesh_comm = data.get("mesh_comm")
        if mesh_comm is not None and mesh_comm not in ("blocking", "pipelined"):
            raise ValueError(f"bad mesh_comm {mesh_comm!r}")
        return TuningConfig(
            default_backend=default,
            group_backends=tuple(groups),
            column_batch=None if cb is None else int(cb),
            chunk_size=None if chunk is None else int(chunk),
            memory_budget_bytes=None if budget is None else int(budget),
            mesh_comm=mesh_comm,
        )
