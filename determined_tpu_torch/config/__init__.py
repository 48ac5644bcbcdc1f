"""Experiment configuration (expconf analog) and the hyperparameter search
space: copies of ``determined_tpu/config``."""

from determined_tpu_torch.config.experiment import (
    CheckpointStorageConfig,
    ExperimentConfig,
    FaultToleranceConfig,
    InvalidExperimentConfig,
    Length,
    LintConfig,
    MeshConfig,
    OptimizationsConfig,
    ReproducibilityConfig,
    ResourcesConfig,
    SearcherConfig,
)
from determined_tpu_torch.config.hyperparameters import (
    Categorical,
    Const,
    Double,
    Int,
    InvalidHyperparameter,
    Log,
    grid_points,
    grid_size,
    parse_hyperparameter,
    parse_hyperparameters,
    sample_hyperparameters,
)

__all__ = [
    "CheckpointStorageConfig",
    "ExperimentConfig",
    "FaultToleranceConfig",
    "InvalidExperimentConfig",
    "Length",
    "LintConfig",
    "MeshConfig",
    "OptimizationsConfig",
    "ReproducibilityConfig",
    "ResourcesConfig",
    "SearcherConfig",
    "Categorical",
    "Const",
    "Double",
    "Int",
    "InvalidHyperparameter",
    "Log",
    "grid_points",
    "grid_size",
    "parse_hyperparameter",
    "parse_hyperparameters",
    "sample_hyperparameters",
]
