"""Trial-free searcher simulation: replay any method against a curve model.

Reference: ``master/pkg/searcher/simulate.go:65`` (`det preview-search`)
generalized into a harness that makes *method choice* testable: every
registered SearchMethod — including the clone-based PBT — runs against a
deterministic learning-curve model in milliseconds, and the report is a
best-metric-vs-budget table instead of a single end state.

Two model families:

- ``SyntheticCurveModel``: seeded lr-sensitive power-law curves.  A
  config's loss floor depends on how far its learning rate sits from a
  hidden optimum; loss decays toward that floor with *effective* training
  units.  Effective units include units inherited through PBT clones, so
  exploit/explore dynamics (children resume the parent's progress, then
  explore a better lr) are faithfully scored.
- ``JournalCurveModel``: recorded curves, lifted from a real experiment's
  journal (``trial_validated`` records).  A simulated trial follows the
  recorded trial whose hyperparameters are nearest in (log-scaled)
  numeric space, interpolated at its effective unit count.

All randomness is seeded; two runs with the same seed produce identical
reports — the property the mid-generation replay tests lean on.

Port of ``determined_tpu/searcher/simulate.py`` (a copy: the same reports
for the same config, model and seed; ``JournalCurveModel`` reads the port's
journal, which has the JAX package's format).
"""

from __future__ import annotations

import dataclasses
import math
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from determined_tpu_torch.config.experiment import (
    ExperimentConfig,
    Length,
    SearcherConfig,
)
from determined_tpu_torch.searcher._base import RequestID
from determined_tpu_torch.searcher._searcher import Searcher, method_from_config

DEFAULT_METHODS = ("random", "asha", "hyperband", "pbt")


def _numeric_hps(hparams: Dict[str, Any], prefix: str = "") -> Dict[str, float]:
    """Flatten numeric leaves, log-scaling the small-positive ones so a
    learning-rate distance is measured in decades, not absolute deltas."""
    out: Dict[str, float] = {}
    for k, v in (hparams or {}).items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_numeric_hps(v, key + "."))
        elif isinstance(v, bool):
            continue
        elif isinstance(v, (int, float)):
            fv = float(v)
            # the whole sub-1.0 range scales together: a perturb clamped to
            # an lr bound (e.g. exactly 0.1) must not jump coordinate
            # systems relative to its neighbors
            out[key] = math.log10(fv) if 0.0 < fv < 1.0 else fv
    return out


class SyntheticCurveModel:
    """Seeded power-law loss curves with an lr-shaped floor.

    ``metric(hparams, units)`` is a pure function of (seed, hparams,
    units): the per-config jitter comes from hashing the hparams with the
    seed, never from shared mutable rng state — so validation order cannot
    change a trial's curve.
    """

    def __init__(
        self,
        seed: int = 0,
        *,
        lr_key: str = "lr",
        lr_optimum: float = 10 ** -2.5,
        halflife: float = 16.0,
        noise: float = 0.05,
    ) -> None:
        self.seed = seed
        self.lr_key = lr_key
        self.lr_optimum = lr_optimum
        self.halflife = halflife
        self.noise = noise

    def _config_jitter(self, hparams: Dict[str, Any]) -> float:
        # stable across processes (Python's str hash is salted per run)
        items = repr((self.seed, sorted(_numeric_hps(hparams).items())))
        h = zlib.crc32(items.encode()) & 0xFFFFFFFF
        return (h / 0xFFFFFFFF - 0.5) * 2.0  # [-1, 1]

    def metric(self, hparams: Dict[str, Any], units: float) -> float:
        flat = _numeric_hps(hparams)
        lr_log = flat.get(self.lr_key)
        if lr_log is None:
            lr_log = next(iter(flat.values()), math.log10(self.lr_optimum))
        mis = (lr_log - math.log10(self.lr_optimum)) ** 2
        floor = 0.2 + 0.4 * mis
        jitter = self._config_jitter(hparams) * self.noise
        span = 2.0 * (1.0 + jitter)
        return floor + span * self.halflife / (self.halflife + max(units, 0.0))


class JournalCurveModel:
    """Curves recorded from a real experiment journal."""

    def __init__(self, curves: List[Tuple[Dict[str, float], List[Tuple[float, float]]]]):
        if not curves:
            raise ValueError("no recorded curves (journal had no validations)")
        self.curves = curves

    @classmethod
    def from_journal(cls, path: str, metric: str, time_metric: str = "batches"
                     ) -> "JournalCurveModel":
        from determined_tpu_torch.experiment.journal import read_journal

        replay = read_journal(path)
        by_rid: Dict[int, List[Tuple[float, float]]] = {}
        for rec in replay.records:
            if rec.get("type") != "trial_validated":
                continue
            m = rec.get("metrics") or {}
            if not isinstance(m.get(metric), (int, float)):
                continue
            step = m.get(time_metric)
            if not isinstance(step, (int, float)):
                continue
            by_rid.setdefault(int(rec["rid"]), []).append((float(step), float(m[metric])))
        curves = []
        for rid, points in sorted(by_rid.items()):
            hp = _numeric_hps(replay.created.get(rid, {}))
            curves.append((hp, sorted(points)))
        return cls(curves)

    def metric(self, hparams: Dict[str, Any], units: float) -> float:
        flat = _numeric_hps(hparams)

        def dist(hp: Dict[str, float]) -> float:
            keys = set(flat) | set(hp)
            return sum((flat.get(k, 0.0) - hp.get(k, 0.0)) ** 2 for k in keys)

        _, points = min(self.curves, key=lambda c: dist(c[0]))
        xs = [p[0] for p in points]
        ys = [p[1] for p in points]
        return float(np.interp(units, xs, ys))


@dataclasses.dataclass
class SimulationReport:
    """What one simulated search did, digested for comparison."""

    method: str
    seed: int
    trials_created: int
    total_units: int
    max_time: int
    best_metric: Optional[float]
    best_trial: Optional[int]
    best_hparams: Optional[Dict[str, Any]]
    # (cumulative units spent, best metric so far) at every validation
    curve: List[Tuple[int, float]]
    trial_units: Dict[int, int]
    lineage: Dict[int, Optional[int]]

    def best_at(self, units: int) -> Optional[float]:
        """Best metric the method had found once ``units`` were spent."""
        best = None
        for spent, value in self.curve:
            if spent > units:
                break
            best = value
        return best


def _default_period(scfg: SearcherConfig, max_time: int) -> int:
    if scfg.name == "hyperband":
        # epsilon matches hyperband_brackets: exact powers of eta must not
        # round the deepest bracket away
        s_max = int(
            math.log(max(max_time, 2)) / math.log(max(scfg.divisor, 2)) + 1e-9
        )
        return max(int(max_time / scfg.divisor ** s_max), 1)
    if scfg.name == "pbt":
        return max(max_time // 4, 1)
    return max(int(max_time // (scfg.divisor ** (scfg.num_rungs - 1))), 1)


def simulate_method(
    config: ExperimentConfig,
    model: Any = None,
    *,
    seed: int = 0,
    report_period: int = 0,
) -> SimulationReport:
    """Run one whole search synchronously against a curve model.

    Round-robin execution: each pass, every running trial advances one
    validation period and reports; searcher decisions (stops, clones,
    shutdown) apply immediately.  Clone creates inherit the parent's
    effective unit count, so a PBT child's curve continues where its
    exploit parent left off — the simulator analog of the experiment runner's
    checkpoint materialization.
    """
    scfg = config.searcher
    model = model or SyntheticCurveModel(seed)
    method = method_from_config(scfg, config.hyperparameters)
    searcher = Searcher(method, config.hyperparameters, seed)
    max_time = scfg.max_time or (scfg.max_length.units if scfg.max_length else 100)
    period = int(report_period or _default_period(scfg, max_time))

    better = (lambda a, b: a < b) if scfg.smaller_is_better else (lambda a, b: a > b)
    time_metric = scfg.time_metric or "batches"
    own_steps: Dict[RequestID, int] = {}
    inherited: Dict[RequestID, int] = {}
    lineage: Dict[RequestID, Optional[int]] = {}
    seen: set = set()
    curve: List[Tuple[int, float]] = []
    total_units = 0
    best: Optional[float] = None
    best_rid: Optional[int] = None

    def absorb_new_trials() -> None:
        for rid, rec in list(searcher.trials.items()):
            if rid in seen:
                continue
            seen.add(rid)
            src = rec.source_trial_id
            lineage[rid] = src
            inherited[rid] = (
                inherited.get(src, 0) + own_steps.get(src, 0) if src is not None else 0
            )

    searcher.start()
    absorb_new_trials()
    guard = 0
    while searcher.shutdown is None and guard < 100_000:
        guard += 1
        running = sorted(
            (t for t in searcher.trials.values() if t.running),
            key=lambda t: t.request_id,
        )
        if not running:
            break
        for rec in running:
            if searcher.shutdown is not None:
                break
            rid = rec.request_id
            step = own_steps.get(rid, 0) + period
            own_steps[rid] = step
            total_units += period
            value = model.metric(rec.hparams, inherited.get(rid, 0) + step)
            if best is None or better(value, best):
                best, best_rid = value, rid
            curve.append((total_units, best))
            searcher.on_validation(rid, {scfg.metric: value, time_metric: step})
            if rec.stopped_by_searcher or step >= max_time:
                searcher.on_trial_exited(rid)
            absorb_new_trials()
    return SimulationReport(
        method=scfg.name,
        seed=seed,
        trials_created=len(searcher.trials),
        total_units=total_units,
        max_time=max_time,
        best_metric=best,
        best_trial=best_rid,
        best_hparams=(
            searcher.trials[best_rid].hparams if best_rid is not None else None
        ),
        curve=curve,
        trial_units=dict(own_steps),
        lineage=lineage,
    )


def method_variant(config: ExperimentConfig, name: str) -> ExperimentConfig:
    """A copy of ``config`` running method ``name`` at (roughly) equal
    total budget: PBT splits the per-trial budget into generations so a
    surviving line trains ``max_time`` units total, like an un-stopped
    trial under every other method; hyperband sizes itself canonically.
    """
    scfg = config.searcher
    max_time = scfg.max_time or (scfg.max_length.units if scfg.max_length else 100)
    updates: Dict[str, Any] = {"name": name, "max_time": max_time, "max_length": None}
    if name == "pbt":
        gen_len = max(max_time // scfg.num_generations, 1)
        updates.update(
            max_time=gen_len,
            population_size=scfg.population_size or max(scfg.max_trials, 2),
        )
    new_scfg = dataclasses.replace(scfg, **updates)
    return dataclasses.replace(config, searcher=new_scfg)


def compare_methods(
    config: ExperimentConfig,
    methods: Sequence[str] = DEFAULT_METHODS,
    model: Any = None,
    *,
    seed: int = 0,
    report_period: int = 0,
) -> List[SimulationReport]:
    """Simulate several methods from one base config, same model + seed."""
    return [
        simulate_method(
            method_variant(config, name),
            model if model is not None else SyntheticCurveModel(seed),
            seed=seed,
            report_period=report_period,
        )
        for name in methods
    ]


def format_comparison(reports: List[SimulationReport]) -> str:
    """Deterministic best-metric-vs-budget table."""
    if not reports:
        return "(no methods simulated)"
    budget = max(r.total_units for r in reports)
    marks = [max(int(budget * f), 1) for f in (0.25, 0.5, 1.0)]
    header = (
        f"{'method':<14} {'trials':>6} {'units':>8} "
        + " ".join(f"{'best@' + _fmt_units(m):>12}" for m in marks)
        + f" {'best':>10}"
    )
    lines = [header, "-" * len(header)]
    for r in reports:
        cells = []
        for m in marks:
            v = r.best_at(m)
            cells.append(f"{v:>12.4f}" if v is not None else f"{'-':>12}")
        best = f"{r.best_metric:>10.4f}" if r.best_metric is not None else f"{'-':>10}"
        lines.append(
            f"{r.method:<14} {r.trials_created:>6} {r.total_units:>8} "
            + " ".join(cells)
            + f" {best}"
        )
    return "\n".join(lines)


def _fmt_units(units: int) -> str:
    if units >= 10_000:
        return f"{units / 1000:.0f}k"
    return str(units)
