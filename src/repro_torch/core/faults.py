"""Deterministic, seeded fault injection (DESIGN.md §11).

The paper's SLA argument is about the latency *distribution*; this module
adds the availability axis real platforms make unavoidable.  A
``FaultModel`` draws from per-provider failure processes:

  * **provision failures** — a cold start dies partway through setup; the
    sandbox never becomes ready and nothing is billed (the provider ate
    the broken host).
  * **mid-execution crashes / reclaims** — the sandbox dies a uniform
    fraction into the invoke; the elapsed work IS billed, as Lambda bills
    errored invokes.
  * **throttle storms** — correlated 429 bursts: a 2-state on/off process
    (alternating exponential dwells, the same discipline as
    ``workload._mmpp_bursty_scalar``'s MMPP states) gates a per-request
    throttle coin.  Storm windows are a function of *time only*, so two
    policy stacks replayed on one trace see the same storms.
  * **gang-lane faults** — per-lane crash draws for the sharded fan-out
    path, where 1-(1-p)^N multiplies the failure tail exactly like the
    cold tail.

Determinism discipline: every per-request fate is a pure function of
``(seed, rid, attempt[, lane])`` via a splitmix64 hash — NOT a shared
sequential stream — so a request's fate is identical under every policy
stack (retry ladders are comparable point-for-point) and no draw ever
perturbs the cluster's jitter RNG (the default stack's bit-parity).  The
hash keying also makes retry monotone by construction: attempt ``k``'s
fate does not change when a policy adds attempt ``k+1``.

The port's counterpart of ``repro.core.faults``: the same arithmetic,
in the same order, on the same explicitly seeded numpy streams, so
that the two give equal results on equal inputs.
"""
from __future__ import annotations

import dataclasses
from bisect import bisect_right
from typing import Optional

import numpy as np

# splitmix64 constants (Steele et al., the JDK SplittableRandom finalizer)
_M64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15
_MIX1 = 0xBF58476D1CE4E5B9
_MIX2 = 0x94D049BB133111EB
# one salt per fate dimension, so the coins are independent
_SALT_THROTTLE = 0xA1
_SALT_PROVISION = 0xB2
_SALT_CRASH = 0xC3
_SALT_CRASH_FRAC = 0xD4
_SALT_DETECT = 0xE5
_SALT_BACKOFF = 0xF6
_SALT_LANE = 0x17
# storm dwells come from their own numpy Generator at a prime seed offset
# (the _RECLAIM_SEED_OFFSET discipline: never the main jitter stream)
_STORM_SEED_OFFSET = 75721

_DAY_S = 86400.0


def _mix(x: int) -> int:
    """splitmix64 finalizer: full-avalanche 64-bit hash step."""
    x = (x ^ (x >> 30)) * _MIX1 & _M64
    x = (x ^ (x >> 27)) * _MIX2 & _M64
    return x ^ (x >> 31)


def _u01(seed: int, *keys: int) -> float:
    """Uniform [0, 1) keyed by ``(seed, *keys)`` — a counter-based draw,
    stateless and order-independent."""
    x = (seed + _GOLDEN) & _M64
    for k in keys:
        x = _mix((x + k + _GOLDEN) & _M64)
    return (x >> 11) * (1.0 / (1 << 53))


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Seeded failure-process rates for one run (frozen, hashable,
    picklable — it rides on a ``Scenario`` into pool workers).

    ``provision_fail`` / ``exec_crash`` are per-attempt probabilities;
    ``lane_fault`` is the per-lane, per-attempt crash probability on the
    sharded gang path.  ``storms_per_day`` / ``storm_mean_s`` shape the
    on/off throttle process and ``storm_throttle_p`` is the 429
    probability while a storm is ON.  All zeros (the default) means the
    fair-weather machine: ``build()`` returns ``None`` and the simulator
    takes today's exact path.
    """

    provision_fail: float = 0.0
    exec_crash: float = 0.0
    storms_per_day: float = 0.0
    storm_mean_s: float = 120.0
    storm_throttle_p: float = 0.9
    lane_fault: float = 0.0
    seed: int = 0

    def __post_init__(self):
        for f in ("provision_fail", "exec_crash", "storm_throttle_p",
                  "lane_fault"):
            v = getattr(self, f)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{f} must be a probability in [0, 1], "
                                 f"got {v!r}")
        if self.storms_per_day < 0.0:
            raise ValueError(f"storms_per_day must be >= 0, got "
                             f"{self.storms_per_day!r}")
        if self.storm_mean_s <= 0.0:
            raise ValueError(f"storm_mean_s must be > 0, got "
                             f"{self.storm_mean_s!r}")
        object.__setattr__(self, "seed", int(self.seed))

    @property
    def active(self) -> bool:
        return (self.provision_fail > 0.0 or self.exec_crash > 0.0
                or self.storms_per_day > 0.0 or self.lane_fault > 0.0)

    def build(self) -> Optional["FaultModel"]:
        """A fresh ``FaultModel`` (fresh storm-window cache), or ``None``
        when every rate is zero — the simulator's fast-path gate key,
        mirroring ``ShardingConfig.materialize``."""
        return FaultModel(self) if self.active else None

    @classmethod
    def from_provider(cls, profile, severity: float = 1.0,
                      seed: int = 0) -> "FaultConfig":
        """The provider's baseline failure rates (``fault_*`` fields on
        ``ProviderProfile``), scaled by ``severity`` (a chaos multiplier;
        probabilities clamp at 0.95 so a huge severity still terminates)."""
        clamp = lambda p: min(p * severity, 0.95)  # noqa: E731
        return cls(provision_fail=clamp(profile.fault_provision_fail),
                   exec_crash=clamp(profile.fault_exec_crash),
                   storms_per_day=profile.fault_storms_per_day * severity,
                   storm_mean_s=profile.fault_storm_mean_s,
                   storm_throttle_p=min(profile.fault_storm_throttle_p, 1.0),
                   lane_fault=clamp(profile.fault_lane_fault), seed=seed)


class FaultModel:
    """Runtime fate oracle for one simulation.

    Stateless per request (splitmix64-keyed coins); the only mutable state
    is the lazily-extended storm-window list, a function of the config
    seed and time alone.
    """

    __slots__ = ("cfg", "_bounds", "_horizon", "_storm_rng", "_off_mean")

    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        # storm windows as a flat sorted boundary list; a time t is inside
        # a storm iff bisect_right(bounds, t) is odd (bounds alternate
        # on-start, on-end, on-start, ...)
        self._bounds: list[float] = []
        self._horizon = 0.0
        if cfg.storms_per_day > 0.0:
            self._storm_rng = np.random.default_rng(
                cfg.seed + _STORM_SEED_OFFSET)
            cycle = _DAY_S / cfg.storms_per_day
            self._off_mean = max(cycle - cfg.storm_mean_s, 1.0)
        else:
            self._storm_rng = None
            self._off_mean = 0.0

    # ------------------------------------------------------------ storms
    def _extend_storms(self, t: float) -> None:
        exp = self._storm_rng.exponential
        bounds = self._bounds
        horizon = self._horizon
        on_mean = self.cfg.storm_mean_s
        off_mean = self._off_mean
        while horizon <= t:
            horizon += float(exp(off_mean))     # OFF dwell
            bounds.append(horizon)              # storm begins
            horizon += float(exp(on_mean))      # ON dwell
            bounds.append(horizon)              # storm ends
        self._horizon = horizon

    def in_storm(self, t: float) -> bool:
        if self._storm_rng is None:
            return False
        if t >= self._horizon:
            self._extend_storms(t)
        return bisect_right(self._bounds, t) % 2 == 1

    def storm_windows(self, until: float) -> list:
        """The ``(on_start, on_end)`` windows up to ``until`` (diagnostics
        and tests; extends the lazy boundary list as a side effect)."""
        if self._storm_rng is None:
            return []
        if until >= self._horizon:
            self._extend_storms(until)
        b = self._bounds
        return [(b[i], b[i + 1]) for i in range(0, len(b) - 1, 2)
                if b[i] < until]

    # ------------------------------------------------------- request fates
    def throttled(self, t: float, rid: int, attempt: int) -> bool:
        """429 for attempt ``attempt`` of request ``rid`` arriving at
        ``t``: inside a storm window, with the per-attempt coin."""
        return (self.in_storm(t)
                and _u01(self.cfg.seed, rid, attempt,
                         _SALT_THROTTLE) < self.cfg.storm_throttle_p)

    def provision_fails(self, rid: int, attempt: int) -> bool:
        return _u01(self.cfg.seed, rid, attempt,
                    _SALT_PROVISION) < self.cfg.provision_fail

    def provision_detect_frac(self, rid: int, attempt: int) -> float:
        """Fraction of the cold setup elapsed when the failure surfaces."""
        return 0.2 + 0.6 * _u01(self.cfg.seed, rid, attempt, _SALT_DETECT)

    def crash_frac(self, rid: int, attempt: int) -> Optional[float]:
        """Fraction of the exec elapsed when the sandbox dies, or ``None``
        when this attempt runs to completion."""
        if _u01(self.cfg.seed, rid, attempt,
                _SALT_CRASH) < self.cfg.exec_crash:
            return 0.05 + 0.9 * _u01(self.cfg.seed, rid, attempt,
                                     _SALT_CRASH_FRAC)
        return None

    def lane_crash_frac(self, rid: int, attempt: int,
                        lane: int) -> Optional[float]:
        """Gang path: per-lane crash draw (keyed by lane index too)."""
        if _u01(self.cfg.seed, rid, attempt, lane,
                _SALT_LANE) < self.cfg.lane_fault:
            return 0.05 + 0.9 * _u01(self.cfg.seed, rid, attempt, lane,
                                     _SALT_CRASH_FRAC)
        return None

    def backoff_u(self, rid: int, attempt: int) -> float:
        """Uniform [0, 1) for the decorrelated-jitter backoff delay of
        retry ``attempt`` (deterministic per (rid, attempt), like every
        other fate)."""
        return _u01(self.cfg.seed, rid, attempt, _SALT_BACKOFF)
