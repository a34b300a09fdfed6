"""Deterministic fault injection for the serving stack.

A copy of ``repro.testing.faults`` (the port imports nothing of the
reference).  The failure-semantics layer (retry/backoff, the degradation
ladder, quarantine) is only testable if every failure mode is
*reproducible*: the same seed must produce the same faults at the same
injection sites in the same order, across runs and across processes.  This
module is that seam.

Production code declares **injection sites** — named points where the real
system can fail — by calling the module-level hooks:

* :func:`maybe_fail` at ``engine_build`` (``CountingEngine.__init__``),
  ``launch`` (``CountingEngine.count_keys_chunk``), and ``collective``
  (the mesh backend's collective dispatch, checked at the same launch
  boundary, once per ring step on the pipelined path);
* :func:`corrupt_result` on the ``launch`` result path (NaN/Inf injection
  into otherwise-successful chunk results);
* :func:`clock_read` at a frontend scheduler's per-round clock read.

With no :class:`FaultPlan` installed every hook is a single module-global
read returning immediately — the seams cost nothing in production.  Tests
install a plan as a context manager::

    plan = FaultPlan([FaultSpec(site="launch", kind="transient", rate=0.125)],
                     seed=7)
    with plan:
        ...drive the service...
    assert plan.fires_by_site()["launch"] > 0

Each spec owns its own ``numpy`` Generator seeded from ``(plan seed, spec
index)`` and its own visit counter, so the fire pattern depends only on the
seed and the *order of visits to that site* — never on wall time, thread
identity, or other specs.  The sites all live on the single scheduler
thread by design (the frontend's determinism seam), so visit order is the
scheduler's round order and the whole failure schedule replays exactly.

No monkeypatching, no test-stack dependencies: stdlib + numpy only.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = [
    "FAULT_SITES",
    "FAULT_KINDS",
    "FAULT_SEED_ENV_VAR",
    "default_fault_seed",
    "FaultSpec",
    "FaultPlan",
    "FaultInjected",
    "TransientFault",
    "MemoryFault",
    "DeterministicFault",
    "active_plan",
    "maybe_fail",
    "corrupt_result",
    "clock_read",
]

#: The named injection points production code declares.
FAULT_SITES = ("engine_build", "launch", "collective", "clock")

#: What a spec does when it fires.  ``transient`` / ``memory`` /
#: ``deterministic`` raise the matching :class:`FaultInjected` subclass
#: (the retry / ladder / quarantine paths classify on these); ``nan``
#: corrupts one result row per fire (:func:`corrupt_result`); ``skew``
#: adds ``magnitude`` seconds to every subsequent :func:`clock_read`.
FAULT_KINDS = ("transient", "memory", "deterministic", "nan", "skew")

#: Environment variable fixing the default plan seed (a chaos run exports
#: it so the whole suite replays one failure schedule).
FAULT_SEED_ENV_VAR = "REPRO_FAULT_SEED"


def default_fault_seed() -> int:
    """The seed a :class:`FaultPlan` built without ``seed=`` uses."""
    raw = os.environ.get(FAULT_SEED_ENV_VAR, "").strip()
    try:
        return int(raw) if raw else 0
    except ValueError:
        return 0


class FaultInjected(RuntimeError):
    """Base class of every injected failure (site + spec recorded)."""

    def __init__(self, site: str, detail: str = ""):
        super().__init__(f"injected fault at {site!r}" + (f": {detail}" if detail else ""))
        self.site = site


class TransientFault(FaultInjected):
    """A failure that a retry is expected to clear (launch hiccup,
    UNAVAILABLE-style collective error)."""


class MemoryFault(FaultInjected):
    """A RESOURCE_EXHAUSTED-style failure — the degradation ladder's cue."""


class DeterministicFault(FaultInjected):
    """A failure retries will never clear (poisoned operands, a compiler
    bug on this shape) — the quarantine path's cue."""


_RAISES = {
    "transient": TransientFault,
    "memory": MemoryFault,
    "deterministic": DeterministicFault,
}


@dataclass(frozen=True)
class FaultSpec:
    """One deterministic failure rule.

    Args:
      site: one of :data:`FAULT_SITES`.
      kind: one of :data:`FAULT_KINDS`.
      rate: per-visit fire probability (1.0 = every eligible visit; drawn
        from the spec's own seeded Generator, so a fractional rate is still
        a fixed schedule for a fixed seed).
      after: skip the first ``after`` visits to the site (lets a test warm
        an engine cleanly, then break its steady state).
      max_fires: stop firing after this many fires (``None`` = unlimited).
      ctx_filter: only visits whose ``ctx`` string contains this substring
        are eligible (e.g. a backend name or an engine-key fragment).
      magnitude: ``skew`` kind only — seconds added per fire, cumulative.
    """

    site: str
    kind: str
    rate: float = 1.0
    after: int = 0
    max_fires: Optional[int] = None
    ctx_filter: Optional[str] = None
    magnitude: float = 0.0

    def __post_init__(self):
        if self.site not in FAULT_SITES:
            raise ValueError(f"unknown fault site {self.site!r} (one of {FAULT_SITES})")
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} (one of {FAULT_KINDS})")
        if not 0.0 < self.rate <= 1.0:
            raise ValueError(f"rate must be in (0, 1], got {self.rate}")
        if self.kind == "skew" and self.site != "clock":
            raise ValueError("kind='skew' only applies to site='clock'")
        if self.kind == "nan" and self.site not in ("launch", "collective"):
            raise ValueError("kind='nan' only applies to result-bearing sites")


@dataclass
class _SpecState:
    """Mutable per-spec bookkeeping (guarded by the plan lock)."""

    rng: np.random.Generator
    visits: int = 0
    fires: int = 0
    fire_log: List[int] = field(default_factory=list)  # visit index per fire


class FaultPlan:
    """A seeded, context-manager-scoped set of :class:`FaultSpec` rules.

    Installing the plan (``with plan:`` or :meth:`install`) routes every
    hook call through its specs; exiting always uninstalls, even on error.
    Exactly one plan may be active per process at a time — nesting raises,
    because two overlapping schedules would not be replayable.

    Determinism: each spec's Generator is seeded ``(seed, spec index)`` and
    consumed one draw per *eligible visit*, so the fire pattern is a pure
    function of (seed, specs, visit order).  All counter state is guarded
    by one lock; the hooks themselves are called from the single scheduler
    thread in every supported harness.
    """

    def __init__(self, specs: Sequence[FaultSpec], *, seed: Optional[int] = None):
        self.specs = tuple(specs)
        self.seed = default_fault_seed() if seed is None else int(seed)
        self._lock = threading.Lock()
        self._states = [
            _SpecState(rng=np.random.default_rng((self.seed, i)))
            for i in range(len(self.specs))
        ]
        self.clock_skew = 0.0

    # -- lifecycle -----------------------------------------------------------

    def install(self) -> "FaultPlan":
        global _ACTIVE
        with _INSTALL_LOCK:
            if _ACTIVE is not None:
                raise RuntimeError(
                    "a FaultPlan is already active — fault plans do not nest"
                )
            _ACTIVE = self
        return self

    def uninstall(self) -> None:
        global _ACTIVE
        with _INSTALL_LOCK:
            if _ACTIVE is self:
                _ACTIVE = None

    def __enter__(self) -> "FaultPlan":
        return self.install()

    def __exit__(self, *exc) -> None:
        self.uninstall()

    # -- observability -------------------------------------------------------

    def fires_by_site(self) -> Dict[str, int]:
        with self._lock:
            out: Dict[str, int] = {}
            for spec, st in zip(self.specs, self._states):
                out[spec.site] = out.get(spec.site, 0) + st.fires
            return out

    def describe(self) -> List[Dict]:
        """Per-spec visit/fire record (the chaos suite's replay assertion)."""
        with self._lock:
            return [
                {
                    "site": spec.site,
                    "kind": spec.kind,
                    "rate": spec.rate,
                    "visits": st.visits,
                    "fires": st.fires,
                    "fire_log": list(st.fire_log),
                }
                for spec, st in zip(self.specs, self._states)
            ]

    # -- the decision kernel -------------------------------------------------

    def _fired_spec(self, site: str, ctx: str, kinds) -> Optional[FaultSpec]:
        """First spec at ``site`` (restricted to ``kinds``) that fires on
        this visit.  Every eligible spec's visit counter advances whether
        or not it fires — the schedule is positional, not outcome-coupled."""
        with self._lock:
            hit: Optional[FaultSpec] = None
            for spec, st in zip(self.specs, self._states):
                if spec.site != site or spec.kind not in kinds:
                    continue
                if spec.ctx_filter is not None and spec.ctx_filter not in ctx:
                    continue
                visit = st.visits
                st.visits += 1
                if visit < spec.after:
                    continue
                if spec.max_fires is not None and st.fires >= spec.max_fires:
                    continue
                draw = float(st.rng.random())
                if draw < spec.rate and hit is None:
                    st.fires += 1
                    st.fire_log.append(visit)
                    hit = spec
            return hit

    def _pick_row(self, site: str, n_rows: int) -> int:
        """Seeded row choice for a ``nan`` corruption (separate stream so
        raising specs at the same site keep their draw sequence)."""
        with self._lock:
            # numeric-only seed sequence (strings must be hex for numpy):
            # a large constant tags the stream, the site by its index
            seq = (self.seed, 0x0BAD0_40A, FAULT_SITES.index(site), n_rows)
            return int(np.random.default_rng(seq).integers(n_rows))


_INSTALL_LOCK = threading.Lock()
_ACTIVE: Optional[FaultPlan] = None


def active_plan() -> Optional[FaultPlan]:
    return _ACTIVE


# ---------------------------------------------------------------------------
# The hooks production code calls
# ---------------------------------------------------------------------------


def maybe_fail(site: str, ctx: str = "") -> None:
    """Raise the planned failure for this visit to ``site``, if any.

    No-op (one global read) without an active plan.  Raises the
    :class:`FaultInjected` subclass matching the fired spec's kind.
    """
    plan = _ACTIVE
    if plan is None:
        return
    spec = plan._fired_spec(site, ctx, ("transient", "memory", "deterministic"))
    if spec is not None:
        raise _RAISES[spec.kind](site, f"kind={spec.kind} ctx={ctx!r}")


def corrupt_result(site: str, values: np.ndarray, ctx: str = "") -> np.ndarray:
    """Apply any planned ``nan`` corruption to a result block.

    Fires set ONE seeded row of the ``(m, T)`` block to NaN — the shape of
    a single poisoned coloring — and return a corrupted copy; the original
    is never mutated.  No-op without an active plan.
    """
    plan = _ACTIVE
    if plan is None or values.shape[0] == 0:
        return values
    spec = plan._fired_spec(site, ctx, ("nan",))
    if spec is None:
        return values
    out = np.array(values, copy=True)
    out[plan._pick_row(site, out.shape[0])] = np.nan
    return out


def clock_read(base: float) -> float:
    """The frontend scheduler's per-round clock read, fault-checked.

    ``skew`` specs add their ``magnitude`` cumulatively; raising kinds
    raise (a watchdog's kill-switch).  Returns
    ``base`` untouched without an active plan.
    """
    plan = _ACTIVE
    if plan is None:
        return base
    spec = plan._fired_spec(
        "clock", "", ("transient", "memory", "deterministic", "skew")
    )
    if spec is None:
        return base + plan.clock_skew
    if spec.kind == "skew":
        with plan._lock:
            plan.clock_skew += spec.magnitude
        return base + plan.clock_skew
    raise _RAISES[spec.kind]("clock", f"kind={spec.kind}")
