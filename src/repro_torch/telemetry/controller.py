"""Closed-loop autoscaling: watermarks + hysteresis over telemetry (port
of ``repro.telemetry.controller``; pure numpy).

``LoadAutoscaler`` replaces the tick-scheduled
:class:`~repro_torch.core.distributed.AutoscalePolicy`: instead of declaring
*when* to scale, the app declares *what load means* (high/low
watermarks on the normalized per-shard pressure signal) and the
controller decides at every metrics window.  The decision function is
deliberately boring (DESIGN.md 13.3) — boring is what keeps a control
loop from oscillating:

- **dwell**: a watermark must hold for ``dwell`` consecutive windows
  before any action fires (a one-window spike is noise);
- **cooldown**: after an action, ``cooldown`` windows pass before the
  next (the migrated system needs time to show its new steady state);
- **priority**: heavy-hitter *skew* (one key dominating the window)
  is checked first — scaling out cannot relieve a single-key hotspot,
  so it triggers ``split_keys``; then scale up, scale down, and last
  the ring ``rebalance`` for diffuse imbalance.

``decide`` is a pure-ish function of the report plus the controller's
own streak counters, so hysteresis is unit-testable without an engine;
``DistributedEngine`` interprets the returned :class:`Action`.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Tuple

import numpy as np

from repro_torch.telemetry.metrics import TelemetryConfig, TelemetryReport


@dataclass
class Action:
    """One controller decision, interpreted by the engine's drive loop."""

    kind: str                  # "scale" | "rebalance" | "split"
    target: int = 0            # active shard count ("scale")
    keys: Tuple[int, ...] = () # heavy-hitter keys ("split")
    reason: str = ""


@dataclass
class LoadAutoscaler:
    """Watermark controller over :class:`TelemetryReport` pressure.

    ``pressure`` ~ events/tick/batch_size + backlog + weighted drops,
    per shard (see ``MetricsRegistry.observe_raw``): ~1.0 means a shard
    consumes its full batch every tick; >1 means it is falling behind.
    """

    high: float = 0.75          # mean pressure above -> scale up
    low: float = 0.25           # mean pressure below -> scale down
    window: int = 8             # source ticks per decision window
    dwell: int = 2              # consecutive windows past a watermark
    cooldown: int = 2           # windows to sit out after any action
    # adaptive cooldown: >0 stretches the post-action cooldown to at
    # least pause_factor * (observed migration pause / window wall
    # time) windows — a migration that stalls the stream for many
    # windows' worth of time earns a proportionally longer sit-out,
    # while the device-path's millisecond pauses keep the floor above.
    # 0 keeps the fixed constant.
    pause_factor: float = 0.0
    min_shards: int = 1
    max_shards: int = 0         # 0 = the engine's physical slot count
    scale_factor: int = 2       # grow/shrink multiplier per action
    skew: float = 0.0           # top-key share threshold (0 = no splits)
    # latency watermark (DESIGN.md 18): >0 drives the *scale-up* streak
    # from ``report.event_latency_p99`` (source ticks) instead of mean
    # pressure — a fast-data service is operated off its tail latency,
    # and the tail can breach an SLO while mean backlog still looks
    # healthy.  Scale-down keeps the pressure watermark (a quiet p99
    # says nothing about how much headroom the fleet has).
    p99_high: float = 0.0
    rebalance_ratio: float = 0.0  # max/mean pressure ratio (0 = off)
    gain: float = 0.5           # heat -> weight damping for rebalance
    drain_max: int = 64         # drain-barrier bound per action
    on_change: Optional[Any] = None   # callback(MigrationReport)
    telemetry: Optional[TelemetryConfig] = None  # engine default override

    # hysteresis state (not config)
    _cool: int = field(default=0, repr=False)
    _hi: int = field(default=0, repr=False)
    _lo: int = field(default=0, repr=False)
    _next_cool: int = field(default=0, repr=False)

    def reset(self):
        self._cool = self._hi = self._lo = self._next_cool = 0

    def decide(self, report: TelemetryReport, *, n_active: int,
               limit: int, can_split: bool = True,
               already_split: Tuple[int, ...] = ()) -> Optional[Action]:
        """One window's decision.  ``limit`` is the physical ceiling
        (the engine's physical slots / ``max_shards``);
        ``can_split=False`` (e.g. durable runs, where partials are not
        store-mergeable) skips the
        skew branch *before* it consumes streaks or cooldown, so the
        scale path still fires on a persistent heavy hitter.
        ``already_split`` keys are likewise skipped — splitting is
        idempotent on the engine, so re-firing it would burn cooldown
        on a no-op forever while overload persists.  Returns None to
        hold."""
        act = [s for s in report.active if s < report.pressure.shape[0]]
        p = report.pressure[act] if act else report.pressure
        mean = float(p.mean()) if p.size else 0.0
        self._next_cool = self.cooldown
        if (self.pause_factor > 0.0 and report.migration_pause_s > 0.0
                and report.window_s > 0.0):
            self._next_cool = max(self.cooldown, int(np.ceil(
                self.pause_factor * report.migration_pause_s
                / report.window_s)))
        # streaks accumulate even during cooldown — a persistent
        # condition should fire the moment the cooldown expires
        p99 = float(getattr(report, "event_latency_p99", 0.0) or 0.0)
        hi_cond = p99 > self.p99_high if self.p99_high > 0.0 \
            else mean > self.high
        self._hi = self._hi + 1 if hi_cond else 0
        self._lo = self._lo + 1 if mean < self.low else 0
        if self._cool > 0:
            self._cool -= 1
            return None
        if self.max_shards:
            limit = min(limit, self.max_shards)

        # single-key skew: more shards won't help; split the key
        if (can_split and self.skew > 0.0 and self._hi >= self.dwell
                and report.heavy_hitters and n_active > 1):
            for key, est, share in report.heavy_hitters:
                if share < self.skew:
                    break                    # ranked: rest are cooler
                if key in already_split:
                    continue
                return self._fire(Action(
                    kind="split", keys=(key,),
                    reason=f"key {key} holds {share:.0%} of window "
                           f"events (skew >= {self.skew:.0%})"))
        if self._hi >= self.dwell:
            target = min(limit, n_active * self.scale_factor)
            if target > n_active:
                why = (f"p99 latency {p99:.0f} ticks > {self.p99_high:g}"
                       if self.p99_high > 0.0
                       else f"pressure {mean:.2f} > high {self.high}")
                return self._fire(Action(
                    kind="scale", target=target,
                    reason=f"{why} for {self._hi} windows"))
        if self._lo >= self.dwell:
            target = max(self.min_shards, n_active // self.scale_factor)
            if target < n_active:
                return self._fire(Action(
                    kind="scale", target=target,
                    reason=f"pressure {mean:.2f} < low {self.low} "
                           f"for {self._lo} windows"))
        if (self.rebalance_ratio > 0.0 and p.size and mean > 0.0
                and float(p.max()) / mean >= self.rebalance_ratio):
            return self._fire(Action(
                kind="rebalance",
                reason=f"imbalance {float(p.max()) / mean:.2f}x >= "
                       f"{self.rebalance_ratio}x"))
        return None

    def _fire(self, action: Action) -> Action:
        self._cool = self._next_cool or self.cooldown
        self._hi = self._lo = 0
        return action

    def heat_weights(self, report: TelemetryReport, owners=None,
                     ) -> np.ndarray:
        """Sketch-informed ring weights: shards hot from *diffuse* key
        heat shed arcs; the share attributable to a single heavy hitter
        is subtracted first (moving that key's arc merely relocates the
        hotspot — ``split`` is its remedy, not reweighting).  ``owners``
        maps candidate keys to their shard(s): [K] for a single owner
        arc, or [n_updaters, K] (``engine.heat_owners``) when routing
        is salted per destination updater — the sketch counted each key
        once per subscribing updater's dequeue, so a hitter's mass is
        split evenly across its per-updater rows."""
        heat = np.asarray(report.events, np.float64).copy()
        if owners is not None and report.heavy_hitters:
            keys = np.asarray([k for k, _, _ in report.heavy_hitters],
                              np.int32)
            own = np.atleast_2d(np.asarray(owners(keys)))
            for row in own:
                for (key, est, _), s in zip(report.heavy_hitters, row):
                    if 0 <= s < heat.shape[0]:
                        heat[s] = max(0.0, heat[s] - est / own.shape[0])
        act = [s for s in report.active if s < heat.shape[0]]
        mean = float(heat[act].mean()) if act else 0.0
        if mean <= 0.0:
            return np.ones_like(heat)
        return np.power((mean + 1.0) / (heat + 1.0), self.gain)
