"""TrainState: what the training step reads and writes, kept on the device.

Port of ``determined_tpu/train/_state.py``.  The metric sums since the last
report boundary (``metric_acc``/``metric_count``) live on the device beside
the model and the optimizer state, so the hot loop never waits for the host;
``fetch_metrics()`` is the one host sync, at report boundaries.  PyTorch
updates the model and the optimizer state in place, so the state object is
mutated rather than replaced.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

_MASK64 = (1 << 64) - 1


@dataclasses.dataclass
class TrainState:
    """step:          optimizer steps taken (device int64 scalar).
    model:         the trial's module (parameters on the device).
    opt_state:     the optimizer state (moments beside the params).
    metric_acc:    running per-metric f32 sums since the last report.
    metric_count:  number of accumulated steps (device f32 scalar).
    rng:           the state's generator on the device (the JAX state's
                   ``rng``), saved and restored with the checkpoint; each
                   step's generator is seeded from its seed
                   (``step_seed``)."""

    step: torch.Tensor
    model: Any
    opt_state: Any
    metric_acc: Dict[str, torch.Tensor]
    metric_count: torch.Tensor
    rng: torch.Generator

    @classmethod
    def create(
        cls, model: Any, opt_state: Any, device: torch.device, seed: int = 0
    ) -> "TrainState":
        """A fresh state; the metric keys are added by the first step.  The
        step generator's seed is ``seed + 1``: the trial's weights are drawn
        from a generator seeded with ``seed`` (``TrialContext.generator``)."""
        return cls(
            step=torch.zeros((), dtype=torch.int64, device=device),
            model=model,
            opt_state=opt_state,
            metric_acc={},
            metric_count=torch.zeros((), dtype=torch.float32, device=device),
            rng=torch.Generator(device=device).manual_seed(seed + 1),
        )

    def step_seed(self, step: int) -> int:
        """The seed of step ``step``'s generator, the JAX step's
        ``fold_in(state.rng, state.step)``: the state generator's seed and the
        step mixed by splitmix64, on the host, so a step draws the same
        numbers in an uninterrupted, a resumed and a restarted run."""
        z = (self.rng.initial_seed() * 0x9E3779B97F4A7C15 + step) & _MASK64
        z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
        return (z ^ (z >> 31)) >> 1  # 63 bits: every device's generator takes it

    def reset_metrics(self) -> None:
        for v in self.metric_acc.values():
            v.zero_()
        self.metric_count.zero_()

    def fetch_metrics(
        self, reduce: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    ) -> Dict[str, float]:
        """One host sync: mean of each accumulated metric.  ``reduce`` maps
        the stacked sums and count across ranks first (the Trainer's mean
        over a mesh)."""
        keys = list(self.metric_acc)
        stacked = torch.stack([self.metric_acc[k] for k in keys] + [self.metric_count])
        host = (stacked if reduce is None else reduce(stacked)).cpu()
        count = float(host[-1])
        if count == 0:
            return {}
        return {k: float(host[i]) / count for i, k in enumerate(keys)}
