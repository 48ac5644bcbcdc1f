"""The port's multislice meshes (the ``dcn`` axis of parallel/mesh.py, the
flat and hierarchical syncs of parallel/sharding.py ``_dp_mesh``) and its
elastic gangs (exec/run_trial.py ``elastic_num_slices``, ClusterExperiment's
resize watcher) against the JAX package's, on the CPU.

- ``LMTrial`` on dcn 2 x data 2 over 4 gloo ranks (tests/torch_rank_worker.py,
  one launch) tracks the JAX Trainer on its virtual 2-slice mesh for 4
  steps from the same weights and batches (tests/test_multislice.py's
  flat overlap and hierarchical runs; the port's baseline, overlap off, is
  held against JAX's flat run, which computes the same step): losses and
  params within 1e-5, the plans equal, the three runs equal to each other.  The
  hierarchical plan's cross-slice bytes are the flat plan's / n_ici, and
  FSDP2's mesh is HSDP (replicated over dcn, sharded within the slice)
  where the flat sync shards over both.  Rank r sits in slice r // 2.
- The per-hop ``step.comm`` counters reach the goodput ledger as JAX's.
- An elastic shrink: a dcn 2 x data 2 checkpoint restores on data 2 (one
  slice, 2 ranks) bitwise, as a ``trial.resize`` span, with the sampler's
  position, and two more steps there equal two more on the source mesh
  within tests/test_elastic.py's tolerance.
- ``DTPU_NUM_SLICES`` under ``resources.elastic`` reshapes ``num_slices``
  as JAX's run_trial does, and the wildcard axis absorbs the placed width.
- ClusterExperiment's resize watcher: a trial whose master record counts a resize
  gives the ``trial.resize`` instant and the ``trial_resized`` journal
  record that the JAX package's ClusterExperiment gives, against the same
  fake master.
"""

import json
import logging

import jax
import numpy as np
import pytest

from determined_tpu.config.experiment import ExperimentConfig as JaxExperimentConfig
from determined_tpu.experiment import ClusterExperiment as JaxClusterExperiment
from determined_tpu.experiment.journal import journal_path as jax_journal_path
from determined_tpu.experiment.journal import read_journal as jax_read_journal
from determined_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from determined_tpu.parallel.mesh import make_mesh as jax_make_mesh
from determined_tpu_torch.config import ExperimentConfig
from determined_tpu_torch.convert import state_dict_from_flax
from determined_tpu_torch.exec.run_trial import elastic_num_slices
from determined_tpu_torch.experiment import ClusterExperiment, journal_path, read_journal
from determined_tpu_torch.observability import compute_ledger
from tests import torch_threads  # noqa: F401  (one intra-op thread)
from tests.test_cluster_experiment import FakeMaster, _loss_plan
from tests.test_torch_overlap import HP, STEPS, TOL, check_tracks_jax, jax_run, run_cases
from tests.torch_rank_worker import launch

MESH = dict(num_slices=2, data=2)
FLAT = {"overlap_grad_sync": True, "overlap_bucket_mb": 1}
HIER = dict(FLAT, hierarchical_collectives=True)
# name: (mesh, the port's knobs, the JAX Trainer run it is held against)
RUNS = {
    "dcn2-data2": (MESH, {}, FLAT),
    "dcn2-data2-flat": (MESH, FLAT, FLAT),
    "dcn2-data2-hier": (MESH, HIER, HIER),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_cases(tmp_path_factory.mktemp("dcn"), RUNS, 4)


@pytest.mark.parametrize("name", list(RUNS))
def test_lm_on_dcn2_data2_tracks_the_jax_trainer(runs, name):
    mesh, opt, jax_opt = RUNS[name]
    plan = check_tracks_jax(runs[name], mesh, opt, jax_opt)
    assert plan.hierarchical_dcn == (2 if opt.get("hierarchical_collectives") else 0)
    # every scheme trains the same model
    for k, v in runs["dcn2-data2"]["params"].items():
        np.testing.assert_allclose(runs[name]["params"][k], v, err_msg=k, **TOL)


def test_hierarchical_sync_crosses_slices_with_the_fragment(runs):
    flat, hier = runs["dcn2-data2-flat"], runs["dcn2-data2-hier"]
    n_ici = 2
    assert flat["plan"]["dcn_bytes"] > 0
    assert hier["plan"]["dcn_bytes"] == flat["plan"]["dcn_bytes"] // n_ici
    assert hier["plan"]["bytes"] == flat["plan"]["bytes"]
    assert flat["plan"]["fingerprint"].endswith(":flat")
    assert hier["plan"]["fingerprint"].endswith(":hier=dcn2")
    # FSDP2's mesh: one shard group over both slices, or HSDP over dcn
    for name, want in (("dcn2-data2", (("Shard",), ("dcn_data",))),
                       ("dcn2-data2-flat", (("Shard",), ("dcn_data",))),
                       ("dcn2-data2-hier", (("Replicate", "Shard"), ("dcn", "data")))):
        for rank in runs[name]["every_rank"]:
            assert set(rank["placements"].values()) == {want}, name


def test_per_hop_counters_reach_the_goodput_ledger_as_jaxs(runs):
    """The ledger's step.comm row has both hops, the cross-slice one moving
    fewer bytes under the hierarchical sync (tests/test_multislice.py's
    per-hop test); the flat sync's one shard group spans the slices, so
    all its bytes cross them."""
    c = runs["dcn2-data2-hier"]["counters"]
    ev = [{"ph": "X", "name": "trial.run", "cat": "trial", "ts": 0, "dur": 1e7,
           "pid": 1, "tid": 1, "args": {"trial": "t"}}]
    ev += [{"ph": "C", "name": k, "ts": 10, "pid": 1, "tid": 1, "args": {"value": v}}
           for k, v in c.items() if k.startswith("step.comm")]
    comm = compute_ledger(ev)["experiment"]["step.comm"]
    hops = comm["hops"]
    assert hops["dcn"]["bytes"] > 0 and hops["ici"]["bytes"] > 0
    assert hops["dcn"]["bytes"] < hops["ici"]["bytes"]
    *_, want = jax_run(tuple(MESH.items()), tuple(HIER.items()))
    assert {k for k in c if k.endswith("bytes")} == {k for k in want if k.endswith("bytes")}
    flat = runs["dcn2-data2-flat"]["comm_model"]
    assert flat["ici"] == 0 and flat["dcn"] > hops["dcn"]["bytes"] / STEPS


def test_ranks_sit_in_their_slices_as_jax_devices_do(runs):
    """Rank r sits where the JAX mesh puts device r: dcn outermost and
    slice-major (slice r // 2), and reads the batch shard of that
    position, (dcn, data) row-major."""
    mesh = jax_make_mesh(JaxMeshConfig(**MESH), jax.devices()[:4])
    assert mesh.axis_names[0] == "dcn" and mesh.devices.shape[0] == 2
    dcn, data = mesh.axis_names.index("dcn"), mesh.axis_names.index("data")
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    for name in RUNS:
        for rank, out in enumerate(runs[name]["every_rank"]):
            where = np.argwhere(ids == jax.devices()[rank].id)[0]
            assert (out["coords"]["dcn"], out["coords"]["data"]) == (where[dcn], where[data])
            assert out["batch_shard"] == (rank, 4)


# ---------------------------------------------------------------------------
# elastic gangs
# ---------------------------------------------------------------------------

ELASTIC_OPT = HIER


def test_an_elastic_shrink_restores_on_one_slice_and_continues(tmp_path):
    """dcn 2 x data 2 (4 ranks) saves at step 6; data 2 on one slice (2
    ranks) restores it bitwise as a ``trial.resize`` span, at the same
    sampler position, and two more steps equal two more on the source mesh
    (tests/test_elastic.py's shrink-dcn2-to-single-slice, its tolerance)."""
    _, init, _, _, _ = jax_run(tuple(MESH.items()), tuple(ELASTIC_OPT.items()))
    common = dict(hparams=dict(HP), init_state=state_dict_from_flax(init),
                  ckpt_dir=str(tmp_path / "ck"), steps=(6, 8))
    src = launch("resize", 4, str(tmp_path / "src"), dict(
        common, mode="save", mesh=MESH, exp_config={"optimizations": ELASTIC_OPT}))[0]
    assert src["sid"] and src["steps"] == 6 and src["resize"] == []
    dst = launch("resize", 2, str(tmp_path / "dst"), dict(
        common, mode="restore", sid=src["sid"], mesh=dict(data=2),
        exp_config={"optimizations": FLAT}))[0]
    assert dst["steps"] == 6 and dst["loader"] == src["loader"]
    for k, v in src["at_ckpt"].items():
        assert np.array_equal(dst["at_ckpt"][k], v), k
    # one resize span a cross-mesh restore (the restore, then the continuation)
    assert len(dst["resize"]) == 2
    # (the port names the axes over 1)
    assert [(r["from_mesh"], r["to_mesh"]) for r in dst["resize"]] == [("data=2,dcn=2",
                                                                        "data=2")] * 2
    assert dst["continued_steps"] == src["continued_steps"] == 8
    for k, v in src["continued"].items():
        np.testing.assert_allclose(dst["continued"][k], v, rtol=2e-4, atol=2e-5, err_msg=k)


def _elastic_raw(mesh, elastic=True):
    raw = {"hyperparameters": dict(HP), "resources": {"mesh": dict(mesh)}}
    if elastic:
        raw["resources"]["elastic"] = {"max_slots": 4, "min_slices": 1,
                                       "resize_cooldown_s": 5}
    return raw


@pytest.mark.parametrize("stamp, slots, mesh, elastic", [
    ("1", 2, dict(num_slices=2, data=-1), True),     # shrunk to one slice
    ("2", 4, dict(num_slices=1, data=-1), True),     # grown back to two
    ("2", 4, dict(num_slices=2, data=-1), True),     # the stamp it has
    ("1", 2, dict(num_slices=2, data=2), False),     # not elastic: untouched
    (None, 4, dict(num_slices=2, data=-1), True),    # no stamp: untouched
])
def test_run_trial_reshapes_dcn_from_the_stamp_as_jax(monkeypatch, stamp, slots, mesh, elastic):
    """JAX's run_trial branch (determined_tpu/exec/run_trial.py): under
    ``resources.elastic`` the stamped ``DTPU_NUM_SLICES`` replaces
    ``num_slices``; the wildcard axis then resolves to the placed width
    over it, as the JAX mesh resolves."""
    if stamp is None:
        monkeypatch.delenv("DTPU_NUM_SLICES", raising=False)
    else:
        monkeypatch.setenv("DTPU_NUM_SLICES", stamp)
    monkeypatch.setenv("DTPU_ELASTIC_SLOTS", str(slots))
    raw = _elastic_raw(mesh, elastic)
    cfg = elastic_num_slices(ExperimentConfig.parse(raw), logging.getLogger("t"))
    want_slices = int(stamp) if stamp is not None and elastic else mesh["num_slices"]
    assert cfg.resources.mesh.num_slices == want_slices
    jax_mesh = JaxExperimentConfig.parse(raw).resources.mesh
    want = JaxMeshConfig(**dict(jax_mesh.__dict__, num_slices=want_slices))
    if -1 in want.sizes():
        want = want.resolve(slots)
        got = cfg.resources.mesh.resolve(slots)
        assert (got.sizes(), got.num_slices) == (want.sizes(), want.num_slices)
    # everything else is the configuration as parsed
    assert cfg.hyperparameters == ExperimentConfig.parse(raw).hyperparameters


class _Resizing(FakeMaster):
    """A fake master whose first trial's record counts one elastic resize
    (to 2 slots) from its fourth poll on, as the native master's trial JSON
    does after a shrink."""

    def customize(self, trial):
        if trial.request_id != 1:
            return
        plain = trial.json

        def json_():
            out = plain()
            if trial.polls >= 4:
                out.update(resizes=1, cur_slots=2)
            return out

        trial.json = json_


SINGLE = {"name": "el", "entrypoint": "determined_tpu.models.mnist:MnistTrial",
          "hyperparameters": {"lr": 0.1},
          "searcher": {"name": "single", "metric": "m", "max_length": {"batches": 4}},
          "resources": {"mesh": {"data": -1},
                        "elastic": {"max_slots": 4, "min_slices": 1, "resize_cooldown_s": 5}}}


@pytest.mark.parametrize("side", ["jax", "port"])
def test_the_resize_watcher_journals_the_resize_as_jaxs(side, tmp_path):
    from determined_tpu_torch.observability import get_tracer as port_tracer
    from determined_tpu.observability import get_tracer as jax_tracer

    cluster, parse, read, path, tracer = (
        (JaxClusterExperiment, JaxExperimentConfig.parse, jax_read_journal, jax_journal_path,
         jax_tracer())
        if side == "jax" else
        (ClusterExperiment, ExperimentConfig.parse, read_journal, journal_path, port_tracer()))
    fake = _Resizing(trial_plan=_loss_plan)
    tracer.reset()
    tracer.configure(enabled=True)
    tracer.start()
    try:
        exp = cluster(parse(json.loads(json.dumps(SINGLE))), master_url=fake.url,
                      checkpoint_dir=str(tmp_path), poll_interval=0.01)
        summary = exp.run()
    finally:
        tracer.stop()
        fake.close()
    events = [e for e in tracer.chrome_events() if e.get("name") == "trial.resize"]
    tracer.reset()
    tracer.configure(enabled=False)  # as a fresh process has it
    assert summary["status"] == "completed"
    assert [(e["args"]["resizes"], e["args"]["cur_slots"]) for e in events] == [(1, 2)]
    recs = [r for r in read(path(str(tmp_path))).records if r.get("type") == "trial_resized"]
    assert [(r["rid"], r["resizes"], r["cur_slots"]) for r in recs] == [(1, 1, 2)]
