"""Configuration types of the port (only ``Length`` so far)."""

from determined_tpu_torch.config.experiment import InvalidExperimentConfig, Length

__all__ = ["InvalidExperimentConfig", "Length"]
