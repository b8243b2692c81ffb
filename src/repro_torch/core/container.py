"""Container lifecycle — the cold/warm mechanics at the heart of the paper.

Cold start anatomy (C1/C4), now an explicit staged state machine:

    PROVISION (infrastructure: pull + start the container sandbox)
      -> BOOTSTRAP (language runtime + framework import, CPU-bound so
         tier-dependent)
      -> LOAD (deployment package read + model deserialize, I/O-bound so
         tier-dependent)
      -> WARM.

Warm invocations skip all three, which is why the paper sees a bimodal
latency distribution.  Each completed phase parks the container in an
intermediate lifecycle state (PROVISIONED, BOOTSTRAPPED, LOADED); a
container claimed from an intermediate state only pays the *remaining*
phases — the substrate every cold-start mitigation policy builds on
(``repro_torch.core.cluster.policies.ColdStartPolicy``):

  * a LayeredPool sandbox parks at BOOTSTRAPPED and pays only LOAD when
    claimed;
  * SnapshotRestore replaces BOOTSTRAP+LOAD with a single cheap RESTORE
    phase once a function snapshot exists;
  * PackageCache skips LOAD on a handler cache hit.

The event loop advances a cold-starting container phase-by-phase with
``phase_done`` events (``repro_torch.core.cluster.events.PHASE_DONE``); under the
default FullCold policy the phases are charged in one collapsed step for
bit-parity with the pre-refactor loop, but the per-phase wall times are
still recorded (they sum exactly to the collapsed total).

The provision phase is dominated by fixed infrastructure work; the paper's
cold curves fall with memory but "do not follow the warm pattern" because
this fixed part dominates — modelled as base + a weakly tier-dependent part.

The port's counterpart of ``repro.core.container``: the same arithmetic,
in the same order, on the same explicitly seeded numpy streams, so
that the two give equal results on equal inputs.
"""
from __future__ import annotations

import dataclasses
import enum
import itertools

from repro_torch.core import providers
from repro_torch.core.function import FunctionSpec

_ids = itertools.count()


class Phase(enum.Enum):
    """One stage of the cold-start anatomy (in lifecycle order).

    RESTORE is the snapshot path's substitute for BOOTSTRAP + LOAD: it
    resumes a memory image of an already-bootstrapped, already-loaded
    process, so completing it marks both as done.
    """
    PROVISION = "provision"
    BOOTSTRAP = "bootstrap"
    LOAD = "load"
    RESTORE = "restore"

    # members are singletons compared by identity, so the id-based C-slot
    # hash is equivalent to Enum's Python-level name hash — and the hot
    # loop hashes Phase keys (mark_done, phase_s) hundreds of thousands
    # of times per bench run
    __hash__ = object.__hash__


# which lifecycle milestones each phase completes
_PHASE_COMPLETES = {
    Phase.PROVISION: (Phase.PROVISION,),
    Phase.BOOTSTRAP: (Phase.BOOTSTRAP,),
    Phase.LOAD: (Phase.LOAD,),
    Phase.RESTORE: (Phase.BOOTSTRAP, Phase.LOAD),
}


class State(enum.Enum):
    PROVISIONING = "provisioning"  # cold-start phases in flight
    PROVISIONED = "provisioned"    # parked: sandbox up, no runtime
    BOOTSTRAPPED = "bootstrapped"  # parked: runtime up, no model (bare pool)
    WARM = "warm"                  # idle, ready to serve
    LOADED = "warm"                # alias: lifecycle name for WARM
    BUSY = "busy"
    EVICTED = "evicted"

    __hash__ = object.__hash__     # see Phase.__hash__



# parked state reached when a phase completes and the container is idle
_PARKED_STATE = {
    Phase.PROVISION: State.PROVISIONED,
    Phase.BOOTSTRAP: State.BOOTSTRAPPED,
    Phase.LOAD: State.LOADED,
    Phase.RESTORE: State.LOADED,
}


# provision-time model: fixed sandbox work + mild tier dependence (network /
# image pull gets a proportional share too).  Values sit in the 2017 ranges
# reported by the paper's figures (cold - warm gap of ~1.5-4 s).  These are
# the Lambda profile's numbers; other providers carry their own in
# ``repro_torch.core.providers`` (GPU serverless provisions in seconds, flat).
PROVISION_BASE_S = providers.LAMBDA_PROVISION_BASE_S
PROVISION_TIER_S = providers.LAMBDA_PROVISION_TIER_S   # divided by cpu_share


@dataclasses.dataclass(slots=True)
class ColdStartBreakdown:
    provision_s: float
    bootstrap_s: float
    load_s: float

    @property
    def total_s(self) -> float:
        return self.provision_s + self.bootstrap_s + self.load_s

    def phase_s(self, phase: Phase) -> float:
        return {Phase.PROVISION: self.provision_s,
                Phase.BOOTSTRAP: self.bootstrap_s,
                Phase.LOAD: self.load_s}[phase]


def cold_start_breakdown(spec: FunctionSpec) -> ColdStartBreakdown:
    """Per-phase cold-start anatomy under the spec's provider profile.

    LOAD = package read at the provider's I/O share plus the handler's
    measured load work (param init + warm-up for modern engines; 0 for
    the paper CNNs, preserving the original I/O-only LOAD).  The default
    ``lambda`` provider reproduces the pre-provider arithmetic exactly."""
    m = spec.memory_mb
    h = spec.handler
    prof = providers.get(spec.provider)
    load_s = prof.load_time(h.package_mb, m)
    if h.load_cpu_seconds:
        load_s += prof.exec_time(h.load_cpu_seconds, m)
    return ColdStartBreakdown(
        provision_s=prof.provision_s(m),
        bootstrap_s=prof.exec_time(h.bootstrap_cpu_seconds, m),
        load_s=load_s,
    )


@dataclasses.dataclass(slots=True)
class Container:
    spec: FunctionSpec
    created_at: float
    state: State = State.PROVISIONING
    cid: int = dataclasses.field(default_factory=lambda: next(_ids))
    ready_at: float = 0.0
    last_used_at: float = 0.0
    invocations: int = 0
    # --- staged lifecycle ------------------------------------------------
    # milestones completed so far (Phase.PROVISION/BOOTSTRAP/LOAD members)
    completed: set = dataclasses.field(default_factory=set)
    # wall seconds actually paid per phase (jittered), keyed by Phase
    phase_times: dict = dataclasses.field(default_factory=dict)
    # in-flight phase plan: [(Phase, wall_s, boundary_t)], advanced by
    # PHASE_DONE events; ``phase_idx`` is the next entry to complete
    phase_plan: list = dataclasses.field(default_factory=list)
    phase_idx: int = 0
    # why this cold-start chain runs: "dispatch" (request-bound),
    # "prewarm" (scaling policy), or "pool" (bare-sandbox replenishment)
    role: str = "dispatch"

    def cold_breakdown(self) -> ColdStartBreakdown:
        return cold_start_breakdown(self.spec)

    # --------------------------------------------------------- lifecycle
    def done(self, phase: Phase) -> bool:
        return phase in self.completed

    def mark_done(self, phase: Phase, wall_s: float) -> None:
        """Record a completed phase (its jittered wall time accumulates)."""
        for milestone in _PHASE_COMPLETES[phase]:
            self.completed.add(milestone)
        self.phase_times[phase] = self.phase_times.get(phase, 0.0) + wall_s

    def parked_state(self, phase: Phase) -> State:
        """The idle state a container rests in after completing ``phase``."""
        return _PARKED_STATE[phase]

    @property
    def loaded(self) -> bool:
        return Phase.LOAD in self.completed
