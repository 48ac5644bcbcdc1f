"""Hyperparameter search space: a copy of
``determined_tpu/config/hyperparameters.py`` (typed hp declarations,
sampling, grid expansion).  The draws go through the same
``np.random.Generator`` calls in the same order, so a search seeded alike
samples the same hyperparameters in both packages.

YAML form::

    hyperparameters:
      lr:
        type: log
        minval: -5
        maxval: -1
        base: 10
      hidden:
        type: int
        minval: 32
        maxval: 512
      act:
        type: categorical
        vals: [relu, gelu]
      layers: 4            # bare value == const
"""

from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Any, Dict, Iterator, List, Optional, Sequence

import numpy as np


class InvalidHyperparameter(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class Const:
    val: Any

    def sample(self, rng: np.random.Generator) -> Any:
        return self.val

    def grid(self) -> List[Any]:
        return [self.val]


@dataclasses.dataclass(frozen=True)
class Int:
    minval: int
    maxval: int
    count: Optional[int] = None  # grid points

    def __post_init__(self):
        if self.minval > self.maxval:
            raise InvalidHyperparameter(f"int hp minval {self.minval} > maxval {self.maxval}")
        if self.count is not None and self.count < 1:
            raise InvalidHyperparameter(f"int hp count must be >= 1, got {self.count}")

    def sample(self, rng: np.random.Generator) -> int:
        return int(rng.integers(self.minval, self.maxval + 1))

    def grid(self) -> List[int]:
        # Reference grid.go caps count at the number of distinct ints.
        span = self.maxval - self.minval + 1
        count = min(self.count or span, span)
        if count == 1:
            return [self.minval]
        step = (self.maxval - self.minval) / (count - 1)
        return sorted({int(round(self.minval + i * step)) for i in range(count)})


@dataclasses.dataclass(frozen=True)
class Double:
    minval: float
    maxval: float
    count: Optional[int] = None

    def __post_init__(self):
        if self.minval > self.maxval:
            raise InvalidHyperparameter(f"double hp minval {self.minval} > maxval {self.maxval}")
        if self.count is not None and self.count < 1:
            raise InvalidHyperparameter(f"double hp count must be >= 1, got {self.count}")

    def sample(self, rng: np.random.Generator) -> float:
        return float(rng.uniform(self.minval, self.maxval))

    def grid(self) -> List[float]:
        if self.count is None:
            raise InvalidHyperparameter("grid search requires `count` on double hps")
        if self.count == 1:
            return [self.minval]
        step = (self.maxval - self.minval) / (self.count - 1)
        return [self.minval + i * step for i in range(self.count)]


@dataclasses.dataclass(frozen=True)
class Log:
    """Sampled as base**u for u ~ U(minval, maxval) — reference Log HP."""

    minval: float
    maxval: float
    base: float = 10.0
    count: Optional[int] = None

    def __post_init__(self):
        if self.minval > self.maxval:
            raise InvalidHyperparameter(f"log hp minval {self.minval} > maxval {self.maxval}")
        if self.count is not None and self.count < 1:
            raise InvalidHyperparameter(f"log hp count must be >= 1, got {self.count}")

    def sample(self, rng: np.random.Generator) -> float:
        return float(self.base ** rng.uniform(self.minval, self.maxval))

    def grid(self) -> List[float]:
        if self.count is None:
            raise InvalidHyperparameter("grid search requires `count` on log hps")
        if self.count == 1:
            return [self.base ** self.minval]
        step = (self.maxval - self.minval) / (self.count - 1)
        return [self.base ** (self.minval + i * step) for i in range(self.count)]


@dataclasses.dataclass(frozen=True)
class Categorical:
    vals: Sequence[Any]

    def __post_init__(self):
        if not self.vals:
            raise InvalidHyperparameter("categorical hp needs at least one value")

    def sample(self, rng: np.random.Generator) -> Any:
        return self.vals[int(rng.integers(0, len(self.vals)))]

    def grid(self) -> List[Any]:
        return list(self.vals)


Hyperparameter = Any  # Const | Int | Double | Log | Categorical


def parse_hyperparameter(raw: Any) -> Hyperparameter:
    """Parse one YAML hp declaration. Bare scalars/lists become Const."""
    if isinstance(raw, dict) and "type" in raw:
        t = raw["type"]
        if t == "const":
            return Const(raw["val"])
        if t == "int":
            return Int(int(raw["minval"]), int(raw["maxval"]), raw.get("count"))
        if t == "double":
            return Double(float(raw["minval"]), float(raw["maxval"]), raw.get("count"))
        if t == "log":
            return Log(
                float(raw["minval"]),
                float(raw["maxval"]),
                float(raw.get("base", 10.0)),
                raw.get("count"),
            )
        if t == "categorical":
            return Categorical(tuple(raw["vals"]))
        raise InvalidHyperparameter(f"unknown hyperparameter type {t!r}")
    return Const(raw)


def parse_hyperparameters(raw: Dict[str, Any]) -> Dict[str, Any]:
    """Parse a (possibly nested) dict of hp declarations."""
    out: Dict[str, Any] = {}
    for k, v in (raw or {}).items():
        if isinstance(v, dict) and "type" not in v:
            out[k] = parse_hyperparameters(v)
        else:
            out[k] = parse_hyperparameter(v)
    return out


def _walk(space: Dict[str, Any], prefix=()) -> Iterator:
    for k, v in space.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _set_nested(d: Dict[str, Any], path, val) -> None:
    for k in path[:-1]:
        d = d.setdefault(k, {})
    d[path[-1]] = val


def sample_hyperparameters(space: Dict[str, Any], rng: np.random.Generator) -> Dict[str, Any]:
    """Draw one concrete hp dict from the space (random search / ASHA)."""
    out: Dict[str, Any] = {}
    for path, hp in _walk(space):
        _set_nested(out, path, hp.sample(rng))
    return out


def grid_points(space: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Cartesian product of per-hp grids — reference ``grid.go`` semantics."""
    paths: List = []
    axes: List[List[Any]] = []
    for path, hp in _walk(space):
        paths.append(path)
        axes.append(hp.grid())
    points = []
    for combo in itertools.product(*axes) if axes else [()]:
        d: Dict[str, Any] = {}
        for path, val in zip(paths, combo):
            _set_nested(d, path, val)
        points.append(d)
    return points


def grid_size(space: Dict[str, Any]) -> int:
    return int(math.prod(len(hp.grid()) for _, hp in _walk(space)) if space else 1)
