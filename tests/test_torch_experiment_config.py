"""The port's experiment configuration and searcher against the JAX
package's on the CPU.

- Every ``examples/**/*.yaml`` that the JAX parser accepts parses in the
  port to the same fields (``MeshConfig`` compared as its axis dict); a list
  of invalid configurations raises ``InvalidExperimentConfig`` in both.
- ``single``, ``grid`` and ``random`` from one seed create the same trials,
  hyperparameters and request ids, in the same order, and snapshot alike;
  asha, adaptive_asha, hyperband and pbt build the JAX package's methods.
- ``chip_smoke.py``'s experiment dict is ``examples/transformer_lm/const.yaml``
  apart from its listed cuts.
"""

import dataclasses
import functools
import glob
import os

import pytest
import yaml

from determined_tpu.config import ExperimentConfig as JaxExperimentConfig
from determined_tpu.config import InvalidExperimentConfig as JaxInvalid
from determined_tpu.searcher import Searcher as JaxSearcher
from determined_tpu.searcher import method_from_config as jax_method_from_config
from determined_tpu_torch.config import ExperimentConfig, InvalidExperimentConfig
from determined_tpu_torch.searcher import Searcher, method_from_config
from tests import torch_threads  # noqa: F401  (one intra-op thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(REPO, "examples", "**", "*.yaml"), recursive=True))


def _fields(cfg):
    """Every field of a parsed configuration as plain data; ``dataclasses``
    turns both packages' ``MeshConfig`` into its axis dict."""
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("path", EXAMPLES, ids=[os.path.relpath(p, REPO) for p in EXAMPLES])
def test_example_configs_parse_to_the_same_fields(path):
    want = JaxExperimentConfig.from_yaml(path)
    got = ExperimentConfig.from_yaml(path)
    assert _fields(got) == _fields(want)
    assert got.resources.mesh.axes() == dataclasses.asdict(want.resources.mesh)
    assert got == ExperimentConfig.parse(yaml.safe_load(open(path)))


INVALID = {
    "version_2": {"version": 2},
    "unknown_field": {"no_such_field": 1},
    "unknown_searcher": {"searcher": {"name": "bayes"}},
    "unknown_searcher_field": {"searcher": {"name": "single", "rungs": 3}},
    "max_trials_0": {"searcher": {"name": "random", "max_trials": 0}},
    "checkpoint_policy": {"checkpoint_policy": "sometimes"},
    "mesh_axis": {"resources": {"mesh": {"rows": 2}}},
    "slots_and_mesh": {"resources": {"slots_per_trial": 2, "mesh": {"data": 2}}},
    "elastic_without_wildcard": {"resources": {"mesh": {"data": 2},
                                               "elastic": {"max_slots": 2}}},
    "grid_without_count": {"searcher": {"name": "grid"},
                           "hyperparameters": {"lr": {"type": "double", "minval": 0.1,
                                                      "maxval": 1.0}}},
    "negative_length": {"searcher": {"name": "single", "max_length": {"batches": -1}}},
    "length_unit": {"min_validation_period": {"steps": 3}},
    "aggregation_0": {"optimizations": {"aggregation_frequency": 0}},
    "quantized": {"optimizations": {"quantized_matmul": "int4"}},
    "virtual_stages": {"optimizations": {"virtual_stages": 2}},
    "jitter": {"fault_tolerance": {"restart_backoff_jitter": 2}},
    "storage_field": {"checkpoint_storage": {"type": "shared_fs", "bukket": "x"}},
    "auto_promote_without_model": {"registry": {"auto_promote": True}},
    "log_policy_action": {"log_policies": [{"pattern": "x", "action": "reboot"}]},
    "suppress_string": {"lint": {"suppress": "rule"}},
    "ring_capacity": {"observability": {"ring_capacity": 8}},
}


@pytest.mark.parametrize("raw", list(INVALID.values()), ids=list(INVALID))
def test_invalid_configs_raise_in_both(raw):
    with pytest.raises(JaxInvalid):
        JaxExperimentConfig.parse(dict(raw))
    with pytest.raises(InvalidExperimentConfig):
        ExperimentConfig.parse(dict(raw))


SPACE = {
    "lr": {"type": "log", "minval": -4, "maxval": -1, "count": 3},
    "width": {"type": "int", "minval": 16, "maxval": 64, "count": 2},
    "act": {"type": "categorical", "vals": ["relu", "gelu"]},
    "drop": {"type": "double", "minval": 0.0, "maxval": 0.5, "count": 2},
    "nested": {"depth": {"type": "int", "minval": 1, "maxval": 4}, "fixed": 7},
}


def _drive(searcher_cls, method_fn, cfg, seed):
    """Run a search to its end, every trial exiting at once: the creates in
    order, then the snapshot."""
    s = searcher_cls(method_fn(cfg.searcher, cfg.hyperparameters), cfg.hyperparameters, seed=seed)
    creates = [(a.request_id, a.hparams) for a in s.start() if hasattr(a, "hparams")]
    done = 0
    while s.shutdown is None and done < 50:
        running = [t.request_id for t in s.runnable_trials()]
        if not running:
            break
        for action in s.on_trial_exited(min(running)):
            if hasattr(action, "hparams"):
                creates.append((action.request_id, action.hparams))
        done += 1
    return creates, s.progress(), s.state_json()


@pytest.mark.parametrize("name", ["single", "grid", "random"])
def test_searchers_create_the_same_trials_as_jax(name):
    space = dict(SPACE)
    if name == "grid":
        space["nested"] = {"depth": {"type": "int", "minval": 1, "maxval": 2}, "fixed": 7}
    raw = {"hyperparameters": space,
           "searcher": {"name": name, "max_trials": 5, "max_concurrent_trials": 2}}
    for seed in (0, 3):
        got = _drive(Searcher, method_from_config, ExperimentConfig.parse(raw), seed)
        want = _drive(JaxSearcher, jax_method_from_config, JaxExperimentConfig.parse(raw), seed)
        assert got == want
    assert len(got[0]) == {"single": 1, "grid": 48, "random": 5}[name]


@pytest.mark.parametrize("name", ["asha", "adaptive_asha", "hyperband", "pbt"])
def test_searchers_of_later_slices_raise(name):
    """The searchers that once waited for a later slice of the port (and
    raised, whence the test's name, kept so its history reads on) now
    build: each is the JAX package's method with the same state
    (tests/test_torch_searcher.py drives them); an unknown name raises in
    both."""
    raw = {"searcher": {"name": name, "max_trials": 4, "max_length": {"batches": 8}}}
    cfg, jcfg = ExperimentConfig.parse(raw), JaxExperimentConfig.parse(raw)
    got = method_from_config(cfg.searcher, cfg.hyperparameters)
    want = jax_method_from_config(jcfg.searcher, jcfg.hyperparameters)
    assert type(got).__name__ == type(want).__name__
    assert got.state_dict() == want.state_dict()
    bad = {"searcher": dict(raw["searcher"], name=name + "_x")}
    with pytest.raises(InvalidExperimentConfig):
        ExperimentConfig.parse(bad)
    with pytest.raises(JaxInvalid):
        JaxExperimentConfig.parse(bad)


def test_chip_smoke_experiment_is_const_yaml_apart_from_its_cuts():
    import chip_smoke

    const = yaml.safe_load(open(os.path.join(REPO, "examples/transformer_lm/const.yaml")))
    got = chip_smoke.experiment_raw_config("/tmp/ckpts", 7)
    restored = {k: dict(v) if isinstance(v, dict) else v for k, v in got.items()}
    placeholders = {"<temp dir>": "/tmp/ckpts", "<--seed>": 7}
    for path, const_value, run_value, _why in chip_smoke.EXPERIMENT_CUTS:
        *parents, leaf = path.split(".")
        node, want = restored, const
        for p in parents:
            node, want = node[p], want.get(p, {})
        if isinstance(run_value, str):
            run_value = placeholders.get(run_value, run_value)
        assert node[leaf] == run_value
        assert want.get(leaf) == const_value
        if const_value is None:
            del node[leaf]
        else:
            node[leaf] = const_value
    # a section the file does not have is left empty by its restored cut
    assert {k: v for k, v in restored.items() if v != {}} == const
    # the port parses it, and its searcher budget and seed are the cut ones
    cfg = ExperimentConfig.parse(got)
    assert cfg.searcher.max_length.units == 24
    assert cfg.reproducibility.experiment_seed == 7
    # part D's cuts start from what the file gets by default
    file_cfg = ExperimentConfig.parse(const)
    d_cfg = ExperimentConfig.parse(chip_smoke._apply_cuts(got, chip_smoke.CRASH_CUTS, {}))
    for path, default, d_value, _why in chip_smoke.CRASH_CUTS:
        keys = path.split(".")
        assert functools.reduce(getattr, keys, file_cfg) == default, path
        assert functools.reduce(getattr, keys, d_cfg) == d_value, path
