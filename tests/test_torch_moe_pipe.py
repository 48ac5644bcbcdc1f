"""MoE blocks inside pipeline stages on a ``seq`` axis (determined_tpu_torch/
models/moe.py's stage form: each rank routes its own tokens, as JAX's
``shard_map`` does) against the JAX package, on the CPU: gloo ranks
(tests/torch_rank_worker.py) against the JAX Trainer on the 8-device
virtual mesh.

- ``LMTrial`` with MoE at pipe 2 x seq 2 (4 ranks) and pipe 2 x seq 2 x
  expert 2 (8 ranks, the composition of tests/test_pipeline_e2e.py's
  ``test_pipe_seq_expert_full_composition``, held to parity here) tracks
  the JAX Trainer at the same mesh for 8 steps from the same weights and
  batches, the gradient clip engaged: losses and ``moe_aux_loss`` (JAX's
  ``pmean`` over the batch and seq shards, the Trainer's mean over the
  ranks) within 1e-5, perplexity within 2e-2, the params' updates within
  the training parity tolerance.  Each rank holds its stage's leaves.
- examples/transformer_lm/pipeline_seq_ep.yaml (pipe 4 x seq 4 x expert 2)
  passes ``check_exp_config``, is mesh_smoke.py's ``SEQ_EP_HPARAMS`` and
  ``SEQ_EP_MESH``, and part M's cuts name the file's values.
"""

import os

import pytest
import yaml

from determined_tpu_torch.config import ExperimentConfig
from determined_tpu_torch.train._trainer import check_exp_config
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.test_torch_pipeline_schedules import check_against_jax, run_on_ranks

MOE = dict(moe_experts=4, moe_every=2, moe_aux_weight=0.01, attention="ring")
RUNS4 = {"pipe2-seq2": (dict(pipe=2, seq=2), MOE, {})}
RUNS8 = {"pipe2-seq2-expert2": (dict(pipe=2, seq=2, expert=2), MOE, {})}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("moe_pipe")
    out = run_on_ranks(root / "four", list(RUNS4), RUNS4, 4)
    out.update(run_on_ranks(root / "eight", list(RUNS8), RUNS8, 8))
    return out


@pytest.mark.parametrize("name", list(RUNS4) + list(RUNS8))
def test_moe_in_pipeline_stages_on_seq_tracks_the_jax_trainer(runs, name):
    mesh, hp, opt = {**RUNS4, **RUNS8}[name]
    out = runs[name]
    check_against_jax(out, mesh, hp, opt)
    assert all(0.0 < m["moe_aux_loss"] < 4.0 for _, m in out["training"])
    keys = [set(k) for k in out["local_keys"]]
    stage0 = [k for k in keys if "embed.weight" in k]
    stage1 = [k for k in keys if "lm_head.weight" in k]
    assert len(stage0) == len(stage1) == len(keys) // 2
    assert all(k.startswith(("embed.", "blocks.0.", "blocks.1.")) for k in stage0[0])
    assert all(k.startswith(("ln_f.", "lm_head.", "blocks.2.", "blocks.3.")) for k in stage1[0])


def test_pipeline_seq_ep_yaml_passes_the_port_and_part_m_cuts_name_it():
    from mesh_smoke import M1_CUTS, M2_CUTS, M2_MESHES, SEQ_EP_HPARAMS, SEQ_EP_MESH

    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "transformer_lm")
    with open(os.path.join(root, "pipeline_seq_ep.yaml")) as f:
        raw = yaml.safe_load(f)
    check_exp_config(ExperimentConfig.parse(raw))
    hp = raw["hyperparameters"]
    assert hp == SEQ_EP_HPARAMS and raw["resources"]["mesh"] == SEQ_EP_MESH
    for key, old, _new, _why in M2_CUTS:
        section, _, leaf = key.rpartition(".")
        assert (raw[section][leaf] if section else hp.get(key)) == old, key
    with open(os.path.join(root, "moe_ep.yaml")) as f:
        moe_ep = yaml.safe_load(f)
    for key, old, _new, _why in M1_CUTS:
        assert moe_ep["hyperparameters"].get(key) == old, key
    # the widths stay the file's: only depth, batch, data and the mesh are cut
    cut = {key for key, *_ in M2_CUTS}
    for key in ("d_model", "n_heads", "vocab_size", "seq_len", "moe_experts", "moe_every",
                "bf16", "remat", "attention"):
        assert key not in cut, key
    # each of part M's meshes passes the port with the file's hyperparameters
    for mesh in M2_MESHES:
        check_exp_config(ExperimentConfig.parse(dict(raw, resources={"mesh": mesh})))
