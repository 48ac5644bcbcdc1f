"""Training lengths: a copy of ``Length`` from
``determined_tpu/config/experiment.py`` (the port imports nothing of the JAX
package).  The rest of the experiment configuration comes with a later
slice of the port."""

from __future__ import annotations

import dataclasses
from typing import Any


class InvalidExperimentConfig(ValueError):
    pass


_LENGTH_UNITS = ("batches", "epochs", "records")


@dataclasses.dataclass(frozen=True)
class Length:
    """Training length in batches/epochs/records."""

    units: int
    unit: str = "batches"

    def __post_init__(self):
        if self.unit not in _LENGTH_UNITS:
            raise InvalidExperimentConfig(f"length unit {self.unit!r} not in {_LENGTH_UNITS}")
        if self.units < 0:
            raise InvalidExperimentConfig(f"length must be >= 0, got {self.units}")

    @classmethod
    def parse(cls, raw: Any, default_unit: str = "batches") -> "Length":
        if isinstance(raw, Length):
            return raw
        if isinstance(raw, int):
            return cls(raw, default_unit)
        if isinstance(raw, dict):
            if len(raw) != 1:
                raise InvalidExperimentConfig(f"length must have one key, got {raw}")
            (unit, units), = raw.items()
            return cls(int(units), unit)
        raise InvalidExperimentConfig(f"cannot parse length {raw!r}")

    @classmethod
    def batches(cls, n: int) -> "Length":
        return cls(n, "batches")

    @classmethod
    def epochs(cls, n: int) -> "Length":
        return cls(n, "epochs")

    @classmethod
    def records(cls, n: int) -> "Length":
        return cls(n, "records")
