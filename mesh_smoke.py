#!/usr/bin/env python3
"""Multi-GPU check of the port's mesh path on the GPUs of one host.

    python3 mesh_smoke.py [--gpus 4] [--seed N] [--parts G,E,S,X,C,P,O,R,M,T,L]

(``X`` is X1, X2 and X3, each of which ``--parts`` also takes alone.)

The MoE LM of chip_smoke.py's phase 14 (examples/transformer_lm/moe_ep.yaml
at its full width, cut to 4 layers and a global batch of 8 sequences of
2048, MOE_CUTS) runs on one GPU in this process, then as a gang of
``--gpus`` ranks (one process a GPU, NCCL, ``DistributedContext.from_torch``
from a torchrun-style environment) on each mesh of MESHES, from the same
weights and the same global batches:

R. the reference: 5 steps on one GPU through Trainer(LMTrial).fit.
G. each mesh: 5 steps through train.init(mesh_config=...) ->
   Trainer(LMTrial).fit (FSDP2 over data x fsdp, the experts over expert,
   fused_adamw on each rank's shards): every step's loss and moe_aux_loss
   against R's within MESH_LOSS_TOL, each rank's launch counts (a layer's
   flash forward, dq and dk/dv once a step, fused_adamw once a local leaf),
   the host step and peak memory of each rank.
E. the expert-parallel MoE layer (d 256, e 8, f32, TF32 off) at data 2 x
   expert 2: each rank's output, aux and gradients against the unsharded
   layer on the same rank's tokens within E_TOL.
S. the dense LM of chip_smoke.py's phase 15 (examples/transformer_lm/
   fsdp_tp_sp.yaml at its full width: d 4096, 32 heads of 128, 8 kv heads,
   vocab 32768, seq 32768, bf16, remat; 4 layers, SEQ_CUTS and
   SEQ_MESH_CUTS) for 5 steps on one GPU, then on each mesh of SEQ_MESHES
   (tensor x seq: Megatron's tensor split, ring attention over seq, FSDP2
   over fsdp x seq): every step's loss against the one GPU's within
   MESH_LOSS_TOL, each rank's launches (flash forward twice a layer a step
   under remat, dq and dk/dv once, each times the ring's units that
   ring_block_counts gives this rank on a seq axis; fused_adamw once a
   local leaf), the host step and peak memory of each rank.
   S ends with a tensor 2 x seq 2 checkpoint (SEQ_CKPT_CUTS: the round trip,
   not the size; logged as "S-C"): 3 steps on the mesh, saved whole by the
   chief, restored by one GPU's Trainer bitwise equal to the mesh's
   gathered params and moments.

X. the local experiment on every GPU of the host (``--gpus`` 4), through
   run-local's path (LocalExperiment, its configuration from a dict where
   run-local reads YAML) and ``experiment resume``:
   X1. chip_smoke.py's phase 8 S1 (ASHA over const.yaml's flagship at 2
       layers and full width, 4 trials, rungs at 16 and 32 batches) with the
       default max_concurrent_trials: four trials at once, one a GPU (each
       trial's device read from the journal), against the same search run
       serially on one GPU here: the trial set, and each validation both
       runs made, bitwise (else within TRAIN_PARITY_TOL, the difference
       printed); the concurrent run's rung decisions equal a fresh ASHA
       replaying its events (the serial run's are printed beside them: ASHA
       ranks a report against what its rung holds when it arrives, so the
       arrival order decides); each GPU's launch counts (the kernels' per
       device counters) equal its trials' steps and validations; both wall
       times.
   X2. moe_ep.yaml at MOE_CUTS on fsdp 2 x expert 2 as a gang of four rank
       processes (X2_CUTS: 12 steps, validations at 6 and 12, checkpoint
       period 6): an uninterrupted gang (checkpointed at its end only); a
       driver SIGTERMed before step
       X2_SIGTERM_AT exits 75 with the step-6 checkpoint, and ``experiment
       resume`` ends with validations equal to the uninterrupted gang's,
       bitwise.  Per rank: its sharded checkpoint bytes (their sum within 1%
       of the whole state's) and its save seconds, against the chief-gather
       path, the earlier mesh save (the state gathered leaf by leaf and written whole by
       the chief) on the same state in the same run.  The step-12 checkpoint
       restored on data 4 (inside a trial.resize span) and on one GPU
       (load_trial_from_checkpoint) equals the gang's gathered params and
       moments, bitwise; these restores compare bytes, and only the resume
       takes an md5 pass.
   X3. examples/mnist/adaptive.yaml cut to 4 trials on data 2 (X3_CUTS):
       two gangs at once on the blocks {0,1} and {2,3} (read from the
       journal), the scheduler backfilling a freed block; the trial set
       equals the same search run serially on two GPUs.

C. the cluster path on every GPU of the host: dtpu-master and dtpu-agent
   built from native/ (devcluster.build_binaries, in a process of its own
   while the reference runs), a master and ``--gpus`` agents, one a GPU
   (``cluster up --agents 4 --gpus``: each agent's CUDA_VISIBLE_DEVICES,
   one slot, ``--python`` the port's launcher).  X3's search
   (examples/mnist/adaptive.yaml at X3_CUTS: resources.mesh {data: 2}, so
   the master places each trial as a gang of two one-slot agents) runs
   through the port's ClusterExperiment with C_CUTS: two 2-rank NCCL gangs
   at once, each rank a run_trial process of its own that joins its gang
   through the master's rendezvous (DistributedContext.from_rendezvous).
   One rank is SIGKILLed mid-trial; the master tears the gang down and
   reschedules it from its last checkpoint.  Checks: the search completes
   with the trial set (request id -> hparams) of the same search through
   run-local's path (LocalExperiment on the blocks {0,1} and {2,3}), run
   first as the reference; the master counts at least one restart; both
   ranks of every trial logged their rendezvous (the trial's log at the
   master, rank-prefixed).  Printed: the build's seconds and the wait for
   it, the reference's and the cluster search's seconds, the kill and the
   restart.

P. examples/transformer_lm/pipeline.yaml (chip_smoke.PIPE_CONST) at its full
   width and depth: 16 layers, d 2048, 64 sequences of 2048 a step, M = 8
   microbatches, bf16, flash, remat; P_CUTS printed (its 16-card mesh cut to
   four cards, a 1-step warm-up, 3 steps' data).
   R. one GPU: gradient aggregation over the same 8 microbatches of 8
      sequences, P_STEPS steps.
   each mesh of P_MESHES (pipe 4; pipe 2 x fsdp 2) and each schedule (gpipe,
   1f1b, interleaved V = 2): a gang of four ranks, NCCL point-to-point
   between the pipe ranks (parallel/pipeline.py PipeGroup), P_STEPS steps
   through train.init(mesh_config=...) -> Trainer(LMTrial).fit: every
   step's loss against R's within P_LOSS_TOL; each rank's launches exactly
   (a layer of its stage: the flash forward twice a microbatch a step under
   remat, dq and dk/dv once; fused_adamw once a local leaf a step); each
   rank's step time and peak memory; each rank's measured idle share over a
   2-step torch.profiler window of the device alone (1 - its compute
   kernels' time over the wall: time in NCCL's send/recv kernels counts as
   idle) beside BubbleModel's fraction, and the traced step.
   PC. a checkpoint round trip on pipe 4 (gpipe): 2 steps and a sharded
      save, each rank its stage's leaves; one GPU restores it and its
      params and moments equal the ranks' bitwise; a second gang on pipe 4
      resumes it and its step-3 loss is held against the uninterrupted
      run's.

O. the overlapped gradient sync: chip_smoke's phase 5 workload (the
   flagship at full width) as a gang of four ranks for O_STEPS steps on each
   run of O_RUNS: data 4 with overlap_grad_sync on, then off (the losses
   within O_LOSS_REL: the same mesh, kernels and reduction groups), and
   dcn 2 x data 2 flat and hierarchical (the losses within MESH_LOSS_TOL of
   each other and of data 4).  Each rank's launches exactly, its step time
   and peak memory, the plan and the Trainer's step.comm counters; then 2
   steps traced for the NCCL and compute kernels' time, and 2 more with
   the collectives' records, beside the c10d calls each rank issues.
   Checks: the comm model of the Trainer's counters (the FSDP2 units it
   runs) against the ring bytes each rank issues, a hop at a time; the
   hierarchical sync's all-reduce over each dcn group against the plan's
   fragment.  Before the runs: NVLink's all-reduce bus bandwidth
   (O_BW_BYTES, O_BW_REPS), the figure of train/_overlap.py's table.

R. an elastic trial through the native master: phase 7's configuration
   with R_CUTS (data -1, num_slices from the master's stamp, min_slices 1,
   resize_cooldown_s cut to R_COOLDOWN_S) over four one-GPU agents in two
   slices (devcluster.LocalCluster(slices=2)).  One slice's agents are
   SIGKILLed: the master shrinks the trial to one slice and it resumes from
   its newest checkpoint on the new mesh; the agents start again and after
   the cooldown it grows back to two.  Printed: shrink -> first step and
   grow -> first step in seconds; checked: each restore's params md5
   against the checkpoint it names.

M. MoE on every mesh axis.  K: the flash forward, dq and dk/dv held
   against their plain versions at M's ring blocks (M_KERNEL_SHAPES) and
   timed, fused_adamw at the [4, 2048, 4096] expert leaf of a tensor 2 x
   expert 2 rank.
   M1. moe_ep.yaml at G's width and cuts (MOE_CUTS, M1_CUTS): R once on one
       GPU, then 5 steps through train.init(mesh_config=...) ->
       Trainer(LMTrial).fit on seq 2 x expert 2 (routing groups of 4,096
       that span two rows and both seq ranks: each rank gathers the gates)
       and tensor 2 x expert 2 (the experts split on two dims).
   M2. examples/transformer_lm/pipeline_seq_ep.yaml at its full width (d
       2048, 16 heads, vocab 32,768, 16,384 tokens a sequence, 8 experts
       every second block, bf16, remat, the ring), cut to four cards
       (M2_CUTS): R one GPU aggregating the same 4 microbatches, then 3
       steps on pipe 2 x seq 2 (MoE inside the stages routing their own seq
       shards) and seq 2 x expert 2; a group (4,096) lies inside one rank's
       8,192 tokens, so every path routes alike.
   Checks: every step's loss and moe_aux_loss against R's within
   MESH_LOSS_TOL; each rank's launches exactly (a layer's flash forward
   once a forward unit, twice under remat, dq and dk/dv once, each times
   its ring units from ring_block_counts; fused_adamw once a local leaf a
   step).  Printed: each rank's step time and peak memory.
T. the pipeline on every mesh axis: pipeline.yaml at its full width and
   P_CUTS, 3 steps of each of T_RUNS as one gang of four ranks (pipe 2 x
   tensor 2 gpipe and 1f1b, int8 and fp8; pipe 2 x dcn 2 flat and
   hierarchical; pipe 2 x data 2 with the overlapped sync on and off, and
   at a global batch of 8 in 8 microbatches, replicated over data), each
   against a one-GPU run aggregating the same microbatches (P_LOSS_TOL;
   the quantized runs against one GPU's same mode within chip_smoke's
   KNOBS_QUANT_LOSS_REL).  Checks: each rank's launches exactly, its
   quantized products, the heads a tensor rank's kernels see; on two
   slices each rank's issued ring bytes against the Trainer's comm model
   and its cross-slice bytes against its stage's plan fragment (part O's
   bounds).  Printed: each rank's step, host step, peak memory, idle and
   NCCL shares against BubbleModel's fraction.
L. a node's slots as local ranks: T1's gpipe trial (L_CUTS) through
   dtpu-master and one dtpu-agent that owns the four GPUs, whose trial
   runs four local rank processes; one local rank is SIGKILLed after the
   step-2 checkpoint, the master reschedules the trial, and the resumed
   losses must equal T's T1 bitwise (without T in ``--parts``, T1 runs
   first).

Each gang has a hard timeout (GANG_TIMEOUT_S); its ranks are killed on
expiry and the run fails.  Prints a JSON line a part, the card's name and
power limit, and last {"ok": true, "device": {...}}; exits non-zero on any
failure and without the GPUs.  Imports nothing of JAX or determined_tpu.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

MESHES = (dict(data=2, fsdp=2), dict(data=2, expert=2), dict(fsdp=2, expert=2))
STEPS = 5
# bf16 compute over another split of the batch: each rank's matmuls have
# other shapes (other cuBLAS tilings, other roundings), so the losses agree
# to bf16 reassociation, as tests/test_torch_training.py's BF16_TOL holds
# its bf16 losses
MESH_LOSS_TOL = dict(rtol=2e-3, atol=2e-3)
# f32, TF32 off, the same tokens: the layer to f32 reassociation
E_TOL = dict(rtol=1e-5, atol=1e-5)
GANG_TIMEOUT_S = 300.0
SEQ_MESHES = (dict(tensor=2, seq=2), dict(fsdp=2, tensor=2), dict(seq=4))
# S's changes to chip_smoke's phase 15 L: (key, L's value, S's value, why)
SEQ_MESH_CUTS = [
    ("global_batch_size", 1, 2, "fsdp 2 reads one sequence a batch shard"),
]
# C's round trip at a small width: the full-width state is 19.9 GB
SEQ_CKPT_CUTS = [
    ("d_model", 4096, 256, "the round trip, not the size, is what C's checkpoint shows"),
    ("n_heads", 32, 2, "head dim 128 at width 256"),
    ("n_kv_heads", 8, 2, "one kv head a tensor rank"),
    ("n_layers", 4, 2, "two blocks"),
    ("vocab_size", 32768, 4096, "the same, in the head"),
    ("seq_len", 32768, 256, "the same, in length"),
]
SEQ_CKPT_STEPS = 3
PARTS = ("G", "E", "S", "X", "C", "P", "O", "R", "M", "T", "L")
# P: pipeline.yaml (chip_smoke.PIPE_CONST) with these changes
P_CUTS = [
    ("resources.mesh", {"pipe": 4, "data": 2, "fsdp": 2}, "each of P_MESHES",
     "four cards: the file's 16-card mesh keeps its pipe axis (pipe 4) or its pipe and fsdp "
     "axes (pipe 2 x fsdp 2)"),
    ("dataset_size", 65536, 192, "3 steps of 64"),
    ("warmup_steps", None, 1,
     "the file sets none (LMTrial's 100): 3 steps inside it update at lr <= 6e-6"),
]
P_MESHES = (dict(pipe=4), dict(pipe=2, fsdp=2))
P_SCHEDULES = (("gpipe", 1), ("1f1b", 1), ("interleaved", 2))
P_STEPS = 3
# the same microbatches and kernels; on pipe 4 the same shapes as R, on
# pipe 2 x fsdp 2 half of each microbatch a rank (other matmul shapes), and
# each stage sums its microbatches' gradients in its schedule's order
P_LOSS_TOL = dict(rtol=1e-4, atol=0.0)
# a P gang (start, 3 steps and a 3-step profile) takes about a minute: a
# hung point-to-point fails the part well before GANG_TIMEOUT_S
P_GANG_TIMEOUT_S = 180.0
# O: chip_smoke's phase 5 workload (the flagship at full width) on the four
# cards under the overlapped gradient sync: (name, mesh, optimizations)
O_RUNS = (
    # on before off: the second run of a gang's processes has run slower
    ("data4-on", {"data": 4}, {"overlap_grad_sync": True}),
    ("data4-off", {"data": 4}, {}),
    ("dcn2-data2-flat", {"num_slices": 2, "data": 2}, {"overlap_grad_sync": True}),
    ("dcn2-data2-hier", {"num_slices": 2, "data": 2}, {"overlap_grad_sync": True,
                                                       "hierarchical_collectives": True}),
)
O_STEPS = 8
# the same mesh, kernels and reduction groups: overlap changes FSDP2's
# units, not what a step computes
O_LOSS_REL = 1e-5
# NVLink's bus bandwidth: an all-reduce of this many bytes, timed this often
O_BW_BYTES = 256 << 20
O_BW_REPS = 20
# R: phase 7's configuration (chip_smoke.EXPERIMENT_CONST at
# EXPERIMENT_CUTS' depth and data) as an elastic trial of the native
# master over four one-GPU agents in two slices, with these changes:
# (dotted key, phase 7's value, R's value, why)
R_ENTRY = "mesh_smoke:ElasticLMTrial"
R_DIR_ENV = "DTT_SMOKE_ELASTIC_DIR"
R_COOLDOWN_S = 15
R_CKPT_EVERY = 100
R_TIMEOUT_S = 300.0
R_CUTS = [
    ("entrypoint", "model_def:Trial", R_ENTRY,
     "LMTrial whose chief records each run's start (its world, its mesh, the checkpoint it "
     "restored and the md5 of its params gathered whole), its first step and its checkpoints"),
    ("searcher.max_length", {"batches": 24}, {"batches": 100000},
     "longer than the part: the part kills the experiment once the grown gang has stepped"),
    ("min_validation_period", {"batches": 12}, {"batches": 100000}, "no validation in the part"),
    ("min_checkpoint_period", {"batches": 18}, {"batches": R_CKPT_EVERY},
     "a checkpoint every 100 steps for a shrink to resume from"),
    ("optimizations.async_checkpointing", True, False,
     "each save is finalized before the next step, so the newest one is what a shrink resumes"),
    ("resources.mesh", None, {"data": -1, "num_slices": 2},
     "data absorbs the placed width; num_slices is the master's stamp (DTPU_NUM_SLICES)"),
    ("resources.elastic", None,
     {"max_slots": 4, "min_slices": 1, "resize_cooldown_s": R_COOLDOWN_S},
     f"shrink to one slice, grow back to two; the cooldown cut from 60 s to {R_COOLDOWN_S} s"),
    (f"environment.env.{R_DIR_ENV}", None, "<events dir>",
     "where the trial's chief writes its events (a fresh temporary directory)"),
]
# the master's flags: (flag, its default, R's, why)
R_MASTER_CUTS = [
    ("--agent-timeout-sec", 90, 5, "the killed slice's agents are reaped 5 s after their last "
     "poll"),
]
# M: MoE on every mesh axis.  M1: moe_ep.yaml at G's width and cuts
# (chip_smoke.MOE_CUTS) with these changes: (key, the file's value, M1's,
# why)
M1_CUTS = [
    ("attention", "flash", "auto",
     "seq 2 runs the ring there (flash sees one shard only); auto is flash on one GPU and on "
     "tensor 2 x expert 2, the kernels G's R runs"),
]
M1_MESHES = (dict(seq=2, expert=2), dict(tensor=2, expert=2))
# M2: examples/transformer_lm/pipeline_seq_ep.yaml (its hyperparameters
# and mesh here: the card's machine has no YAML reader) at its full width
# with these changes: (key, the file's value, M2's, why)
SEQ_EP_HPARAMS = dict(
    lr=0.0003, global_batch_size=32, seq_len=16384, vocab_size=32768, d_model=2048,
    n_layers=16, n_heads=16, dataset_size=65536, bf16=True, attention="auto", remat=True,
    pipe_microbatches=8, moe_experts=8, moe_every=2,
)
SEQ_EP_MESH = {"pipe": 4, "seq": 4, "expert": 2}
M2_CUTS = [
    ("resources.mesh", SEQ_EP_MESH, "each of M2_MESHES",
     "four cards: the file's 32-card mesh keeps pipe and seq (pipe 2 x seq 2: MoE inside the "
     "stages, the ring inside each) or seq and expert (seq 2 x expert 2)"),
    ("n_layers", 16, 4,
     "2 layers a stage on pipe 2 (moe_every 2 divides it); one GPU holds the reference's f32 "
     "params, gradients and moments of 4 layers (~1.1B params), not of 16 (~4.1B)"),
    ("global_batch_size", 32, 4, "one GPU holds the reference: 4 sequences of 16,384"),
    ("pipe_microbatches", 8, 4, "one sequence a microbatch, which the reference aggregates"),
    ("dataset_size", 65536, 12, "3 steps of 4"),
    ("warmup_steps", None, 1,
     "the file sets none (LMTrial's 100): 3 steps inside it update at lr <= 9e-6"),
]
M2_MESHES = (dict(pipe=2, seq=2), dict(seq=2, expert=2))
M2_STEPS = 3
# K's rows at M's ring blocks: (label, batch, half-chunk, causal): M2's
# zigzag halves of 4,096 on pipe 2 x seq 2 (one sequence a microbatch) and
# M1's halves of 512 on seq 2 (8 sequences)
M_KERNEL_SHAPES = (("m2_half_causal", 1, 4096, True), ("m2_half_full", 1, 4096, False),
                   ("m1_half_causal", 8, 512, True))
# T: the pipeline on every mesh axis, pipeline.yaml (chip_smoke.PIPE_CONST)
# at P_CUTS on four cards, each run a gang's: (name, mesh, hparams over
# P's, optimizations, the one-GPU reference it is held against)
T_RUNS = (
    ("T1-gpipe", {"pipe": 2, "tensor": 2}, {}, {}, "bf16"),
    ("T1-1f1b", {"pipe": 2, "tensor": 2}, {"pipeline_schedule": "1f1b"}, {}, "bf16"),
    ("T2-flat", {"pipe": 2, "num_slices": 2}, {}, {}, "bf16"),
    ("T2-hier", {"pipe": 2, "num_slices": 2}, {},
     {"overlap_grad_sync": True, "hierarchical_collectives": True}, "bf16"),
    ("T3-on", {"pipe": 2, "data": 2}, {}, {"overlap_grad_sync": True}, "bf16"),
    ("T3-off", {"pipe": 2, "data": 2}, {}, {}, "bf16"),
    ("T4-int8", {"pipe": 2, "tensor": 2}, {}, {"quantized_matmul": "int8"}, "int8"),
    ("T4-fp8", {"pipe": 2, "tensor": 2}, {}, {"quantized_matmul": "fp8"}, "fp8"),
    ("T5", {"pipe": 2, "data": 2}, {"global_batch_size": 8}, {}, "b8"),
)
# T5's global batch of 8 in 8 microbatches: a row a microbatch, which does
# not split over data 2, so every data rank runs the whole microbatch
# (JAX's batch_axes = ()); its reference aggregates the same 8 rows
T_STEPS = P_STEPS
# a T gang (its start, 9 runs of 3 steps and a 2-step profile each) takes
# about five minutes: a hung point-to-point fails the part before this
T_GANG_TIMEOUT_S = 900.0
# L: T1's gpipe trial through dtpu-master and one dtpu-agent that owns the
# four GPUs (--slots 4: its trial runs four local rank processes), with
# these changes to pipeline.yaml over P_CUTS: (dotted key, the file's
# value, L's, why)
L_ENTRY = "mesh_smoke:LocalRanksLMTrial"
L_DIR_ENV = "DTT_SMOKE_LOCAL_RANKS_DIR"
L_HOLD_S = 180.0
L_TIMEOUT_S = 900.0
L_CUTS = [
    ("entrypoint", "model_def:Trial", L_ENTRY,
     "LMTrial whose ranks record their pids and whose chief records each run's start and "
     "checkpoints; the first run holds after its step-2 checkpoint until a rank is killed"),
    ("resources.mesh", {"pipe": 4, "data": 2, "fsdp": 2}, {"pipe": 2, "tensor": 2},
     "T1's mesh on the agent's four slots"),
    ("searcher.max_length", {"batches": 10000}, {"batches": T_STEPS}, "T1's three steps"),
    ("min_validation_period", {"batches": 500}, {"batches": 100000}, "no validation"),
    ("min_checkpoint_period", {"batches": 1000}, {"batches": 2},
     "a checkpoint at step 2 for the restart to resume"),
    ("optimizations.async_checkpointing", True, False,
     "the step-2 save is finalized before the hold"),
    ("checkpoint_policy", "best", "none", "no checkpoint for a validation"),
    ("checkpoint_storage.host_path", "/tmp/dtpu-checkpoints", "<temp dir>",
     "a fresh temporary directory, deleted at the end"),
    ("reproducibility.experiment_seed", None, "<--seed>",
     "the master seeds trial 1 with experiment_seed + 1, T's gangs' seed"),
    (f"environment.env.{L_DIR_ENV}", None, "<events dir>",
     "where the trial's ranks write their events (a fresh temporary directory)"),
]
X_PARTS = ("X1", "X2", "X3")
# X2: moe_ep.yaml (chip_smoke.MOE_EP_CONST) at MOE_CUTS' hyperparameters,
# and these changes: (dotted key, the file's value, X2's value, why)
X2_STEPS = 12
X2_SIGTERM_AT = 4
X2_ENTRY = "mesh_smoke:X2SigtermLMTrial"
X2_CUTS = [
    ("resources.mesh", {"data": 2, "fsdp": 2, "expert": 8}, {"fsdp": 2, "expert": 2},
     "four GPUs: the experts over 2, FSDP2 over the other 2"),
    ("searcher.max_length", {"batches": 10000}, {"batches": X2_STEPS},
     f"{X2_STEPS} steps: preempted, then resumed"),
    ("min_validation_period", {"batches": 500}, {"batches": 6}, "validations at 6 and 12"),
    ("min_checkpoint_period", None, {"batches": 6},
     f"checkpoints at 6 and 12; the SIGTERM before step {X2_SIGTERM_AT} is read at the step-6 "
     "boundary, so the resume trains 6 steps"),
    ("checkpoint_storage.host_path", "/tmp/dtpu-checkpoints", "<temp dir>",
     "a fresh temporary directory, deleted at the end"),
    ("reproducibility.experiment_seed", None, "<--seed>", "the weights and data from --seed"),
]
# X3: examples/mnist/adaptive.yaml (chip_smoke.MNIST_ADAPTIVE) with these
X3_CUTS = [
    ("searcher.max_trials", 16, 4, "4 trials: two gangs at once, then two more"),
    ("searcher.max_length", {"batches": 400}, {"batches": 100},
     "a quarter of the length: four validations a full trial, rung stops at 25 and 50"),
    ("resources.mesh", None, {"data": 2}, "each trial a gang of two ranks"),
    ("checkpoint_storage.host_path", "/tmp/dtpu-checkpoints", "<temp dir>",
     "a fresh temporary directory, deleted at the end"),
    ("reproducibility.experiment_seed", None, "<--seed>", "the searcher's draws from --seed"),
]

# C: X3's search through the master, with these changes on top of X3_CUTS
C_CUTS = [
    ("entrypoint", "model_def:Trial", "determined_tpu_torch.models.mnist:MnistTrial",
     "the port's trial, by name: the agents' processes import it"),
]
C_TIMEOUT_S = 600.0


def log(msg: str) -> None:
    print(msg, flush=True)


def __getattr__(name: str):
    """``X2SigtermLMTrial``, the gang trial X2's driver runs
    (``chip_smoke.sigterm_trial``), and ``ElasticLMTrial``, R's, built on
    first use."""
    if name == "ElasticLMTrial":
        return _elastic_trial()
    if name == "LocalRanksLMTrial":
        return _local_ranks_trial()
    if name != "X2SigtermLMTrial":
        raise AttributeError(name)
    from chip_smoke import sigterm_trial

    cls = sigterm_trial(name, X2_SIGTERM_AT)
    cls.__module__ = __name__
    return cls


def _hparams() -> dict:
    from chip_smoke import _moe_hparams

    return _moe_hparams()


def _seq_hparams(cuts=()) -> dict:
    from chip_smoke import _seq_hparams as phase15_hparams

    hp = phase15_hparams()
    for key, _old, value, _why in list(SEQ_MESH_CUTS) + list(cuts):
        hp[key] = value
    return hp


def _fit(ctx, steps: int, keep: bool = False) -> dict:
    """Trainer(LMTrial(ctx)).fit for ``steps`` steps, reporting each (with
    ``keep`` the trainer too, under ``trainer``)."""
    import torch

    from chip_smoke import _launch_counts, _reset_launches
    from determined_tpu_torch import train
    from determined_tpu_torch.models import LMTrial

    trainer = train.Trainer(LMTrial(ctx))
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.monotonic()
    trainer.fit(max_length=steps, report_period=1, checkpoint_policy="none")
    torch.cuda.synchronize()
    # this fit's rows (a rank's core context may have carried earlier fits)
    rows = ctx.core.train.metrics("training")[-steps:]
    gbs = ctx.get_global_batch_size() * trainer.agg
    out = dict(
        losses=[m["loss"] for _, m in rows], aux=[m.get("moe_aux_loss") for _, m in rows],
        step_ms=[1e3 * gbs / m["samples_per_second"] for _, m in rows],
        wall_s=time.monotonic() - t0, launches=_launch_counts(),
        local_leaves=len(trainer._params), layers=trainer.model.cfg.n_layers,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        params=sum(p.numel() for p in trainer._params.values()),
    )
    if keep:
        out["trainer"] = trainer
    return out


def _rank_gang(workdir: str, mesh: dict, seed: int) -> dict:
    """One rank of a gang: G's fit on ``mesh``, E's layer, S's fit or C's
    checkpoint."""
    import torch

    from determined_tpu_torch import core, train
    from determined_tpu_torch.parallel import MeshConfig

    core_ctx = core.init(checkpoint_dir=mesh.get("ckpt_dir") or os.path.join(workdir, "ck"))
    dist = core_ctx.distributed
    try:
        if mesh.get("part") == "E":
            return _rank_layer(dist)
        if mesh.get("part") == "S":
            return _rank_seq(core_ctx, mesh["mesh"], seed)
        if mesh.get("part") == "C":
            return _rank_ckpt(core_ctx, workdir, seed)
        if mesh.get("part") == "X2R":
            return _rank_x2_restore(core_ctx, workdir, dict(mesh, seed=seed))
        if mesh.get("part") == "P":
            return _rank_pipe(core_ctx, mesh, seed)
        if mesh.get("part") == "PC":
            return _rank_pipe_ckpt(core_ctx, workdir, mesh, seed)
        if mesh.get("part") == "O":
            return _rank_overlap(core_ctx, mesh, seed)
        if mesh.get("part") == "M":
            return _rank_moe(core_ctx, mesh, seed)
        if mesh.get("part") == "T":
            return _rank_pipe_axes(core_ctx, mesh, seed)
        ctx = train.init(hparams=_hparams(), seed=seed, core_context=core_ctx,
                         mesh_config=MeshConfig(**mesh))
        out = _fit(ctx, STEPS)
        out["batch_shard"] = [ctx.mesh.coordinate(a) for a in ("data", "fsdp", "expert")]
        torch.cuda.synchronize()
        return out
    finally:
        dist.close()


def _pipe_hparams(schedule: str = "gpipe", v: int = 1) -> dict:
    from chip_smoke import PIPE_CONST

    hp = dict(PIPE_CONST["hyperparameters"])
    for key, _old, value, _why in P_CUTS:
        if "." not in key:
            hp[key] = value
    return dict(hp, pipeline_schedule=schedule, virtual_stages=v)


def _idle_share(trainer, steps: int) -> dict:
    """This rank's device over ``steps`` more steps under torch.profiler,
    tracing the device alone (CUPTI's kernel records; recording the host's
    ops too slows the host enough to starve the pipe): its compute
    kernels' time and the NCCL kernels' (a pipeline's send/recv waits),
    each over the wall, and the traced step against the untraced one."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from determined_tpu_torch.data import to_device
    from determined_tpu_torch.utils import kineto

    it = iter(trainer.train_loader)
    batches = [to_device(next(it), trainer.device) for _ in range(steps + 1)]
    trainer._train_step(batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for b in batches[1:]:
            trainer._train_step(b)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    with tempfile.TemporaryDirectory(prefix="dtt-mesh-profile-") as d:
        path = os.path.join(d, "pipe.pt.trace.json")
        prof.export_chrome_trace(path)
        collective_us, compute_us = kineto.split_collectives(kineto.op_table([path]))
    return dict(idle_share=1.0 - compute_us / wall_us, nccl_share=collective_us / wall_us,
                traced_step_ms=wall_us / steps / 1e3)


def _rank_pipe(core_ctx, inp: dict, seed: int) -> dict:
    """One rank of P: the schedule's fit on the mesh, then its idle share."""
    import torch

    from determined_tpu_torch import train
    from determined_tpu_torch.parallel import MeshConfig

    ctx = train.init(hparams=_pipe_hparams(inp["schedule"], inp["v"]), seed=seed,
                     core_context=core_ctx, mesh_config=MeshConfig(**inp["mesh"]))
    out = _fit(ctx, P_STEPS, keep=True)
    trainer = out.pop("trainer")
    out["layers"] = len(trainer.model.blocks)
    out["bubble_fraction"] = trainer._bubble_model.fraction
    out["coords"] = {a: ctx.mesh.coordinate(a) for a in ("pipe", "fsdp")}
    out.update(_idle_share(trainer, 2))
    torch.cuda.synchronize()
    return out


def _rank_pipe_ckpt(core_ctx, workdir: str, inp: dict, seed: int) -> dict:
    """One rank of PC: 2 steps and a save (each rank's local params and
    moments kept beside it for the one-GPU restore), or the resume of
    ``inp["sid"]`` to step 3."""
    import torch

    from determined_tpu_torch import train
    from determined_tpu_torch.models import LMTrial
    from determined_tpu_torch.parallel import MeshConfig

    ctx = train.init(hparams=_pipe_hparams(), seed=seed, core_context=core_ctx,
                     mesh_config=MeshConfig(**inp["mesh"]))
    trainer = train.Trainer(LMTrial(ctx))
    if inp.get("sid") is None:
        summary = trainer.fit(max_length=2, checkpoint_period=2, checkpoint_policy="all",
                              report_period=1)
        rank = core_ctx.distributed.rank
        torch.save({"params": {k: v.detach().cpu() for k, v in trainer._opt_params.items()},
                    "mu": {k: v.cpu() for k, v in trainer.state.opt_state.mu.items()},
                    "nu": {k: v.cpu() for k, v in trainer.state.opt_state.nu.items()}},
                   os.path.join(workdir, f"pipe_state_rank{rank}.pt"))
        return dict(storage_id=summary["latest_checkpoint"])
    trainer.fit(max_length=P_STEPS, latest_checkpoint=inp["sid"], report_period=1,
                checkpoint_policy="none")
    return dict(losses=[m["loss"] for _, m in ctx.core.train.metrics("training")])


def _pipe_part(args, root: str) -> None:
    """P (the docstring at the top)."""
    import torch

    from chip_smoke import PIPE_BUBBLE
    from determined_tpu_torch import core, train
    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.models import LMTrial

    t_part = time.monotonic()
    for key, old, value, why in P_CUTS:
        log(f"P cut: {key} {json.dumps(old)} -> {json.dumps(value)} ({why})")
    hp = _pipe_hparams()
    m, layers = hp["pipe_microbatches"], hp["n_layers"]
    plain = {k: v for k, v in hp.items()
             if k not in ("pipe_microbatches", "pipeline_schedule", "virtual_stages")}
    agg = ExperimentConfig.parse({"optimizations": {"aggregation_frequency": m}})
    t0 = time.monotonic()
    ref = _fit(train.init(hparams=dict(plain, global_batch_size=hp["global_batch_size"] // m),
                          seed=args.seed, exp_config=agg), P_STEPS)
    torch.cuda.empty_cache()
    log(f"P R (one GPU, aggregation {m}): " + json.dumps(dict(
        losses=ref["losses"], step_ms=ref["step_ms"], peak_memory_gib=ref["peak_memory_gib"],
        seconds=time.monotonic() - t0)))
    gpipe4 = None
    for mesh in P_MESHES:
        for name, v in P_SCHEDULES:
            t0 = time.monotonic()
            tag = "_".join(f"{a}{n}" for a, n in mesh.items()) + f"_{name}"
            outs = _launch_gang(args.gpus, os.path.join(root, f"p_{tag}"),
                                dict(part="P", mesh=mesh, schedule=name, v=v), args.seed,
                                P_GANG_TIMEOUT_S)
            chief = outs[0]
            np.testing.assert_allclose(chief["losses"], ref["losses"], err_msg=tag, **P_LOSS_TOL)
            for rank, o in enumerate(outs):
                n = o["layers"]
                want = dict(flash_fwd=2 * n * m * P_STEPS, flash_bwd_dq=n * m * P_STEPS,
                            flash_bwd_dkv=n * m * P_STEPS, fused_adamw=o["local_leaves"] * P_STEPS)
                assert o["launches"] == want, (tag, rank, o["launches"], want)
                assert o["bubble_fraction"] == chief["bubble_fraction"]
            if mesh == dict(pipe=4):
                assert abs(chief["bubble_fraction"] - PIPE_BUBBLE[name]) < 1e-12
                if name == "gpipe":
                    gpipe4 = chief["losses"]
            log("P " + json.dumps(dict(
                mesh=mesh, schedule=name, losses=chief["losses"], ref_losses=ref["losses"],
                max_loss_rel=max(abs(a - b) / abs(b) for a, b in
                                 zip(chief["losses"], ref["losses"])),
                step_ms=[o["step_ms"] for o in outs],
                peak_memory_gib=[o["peak_memory_gib"] for o in outs],
                idle_share=[o["idle_share"] for o in outs],
                nccl_share=[o["nccl_share"] for o in outs],
                traced_step_ms=[o["traced_step_ms"] for o in outs],
                bubble_fraction=chief["bubble_fraction"],
                layers=[o["layers"] for o in outs], local_leaves=[o["local_leaves"] for o in outs],
                coords=[o["coords"] for o in outs], launches=[o["launches"] for o in outs],
                seconds=time.monotonic() - t0)))
    # PC: save on pipe 4, restore on one GPU, resume on pipe 4
    t0 = time.monotonic()
    ck = os.path.join(root, "pc_ck")
    saved = _launch_gang(args.gpus, os.path.join(root, "pc_save"),
                         dict(part="PC", mesh=dict(pipe=4), ckpt_dir=ck), args.seed,
                         P_GANG_TIMEOUT_S)
    sid = saved[0]["storage_id"]
    want: dict = {"params": {}, "mu": {}, "nu": {}}
    for rank in range(args.gpus):
        got = torch.load(os.path.join(root, "pc_save", f"pipe_state_rank{rank}.pt"))
        for part in want:
            want[part].update(got[part])
    ctx = train.init(hparams=_pipe_hparams(), seed=args.seed,
                     core_context=core._dummy_init(checkpoint_dir=ck))
    trainer = train.Trainer(LMTrial(ctx))
    summary = trainer.fit(max_length=2, latest_checkpoint=sid, checkpoint_policy="none")
    assert summary["steps_completed"] == 2
    assert set(trainer._params) == set(want["params"])
    for name, p in trainer._params.items():
        assert torch.equal(p.detach().cpu(), want["params"][name]), name
    for which in ("mu", "nu"):
        for name, t in getattr(trainer.state.opt_state, which).items():
            assert torch.equal(t.cpu(), want[which][name]), (which, name)
    del trainer, want
    torch.cuda.empty_cache()
    resumed = _launch_gang(args.gpus, os.path.join(root, "pc_resume"),
                           dict(part="PC", mesh=dict(pipe=4), ckpt_dir=ck, sid=sid),
                           args.seed, P_GANG_TIMEOUT_S)
    step3 = resumed[0]["losses"][-1]
    np.testing.assert_allclose(step3, gpipe4[-1], **P_LOSS_TOL)
    log("PC " + json.dumps(dict(storage_id=sid, restored_on_one_gpu="bitwise",
                                resumed_step3_loss=step3, uninterrupted_step3_loss=gpipe4[-1],
                                bitwise=step3 == gpipe4[-1], seconds=time.monotonic() - t0)))
    log(f"P: {time.monotonic() - t_part:.1f} s")


def _m_hparams(sub: str) -> dict:
    """M1's (moe_ep.yaml at MOE_CUTS and M1_CUTS) or M2's
    (pipeline_seq_ep.yaml at M2_CUTS) hyperparameters."""
    hp, cuts = (_hparams(), M1_CUTS) if sub == "M1" else (dict(SEQ_EP_HPARAMS), M2_CUTS)
    for key, _old, value, _why in cuts:
        if "." not in key:
            hp[key] = value
    return hp


def _rank_moe(core_ctx, inp: dict, seed: int) -> dict:
    """One rank of M: the sub-part's fit on the mesh, and the ring's units
    for this rank (ring_block_counts on its seq group; 1 without one)."""
    import torch

    from determined_tpu_torch import train
    from determined_tpu_torch.ops.ring_attention import ring_block_counts
    from determined_tpu_torch.parallel import MeshConfig

    ctx = train.init(hparams=_m_hparams(inp["sub"]), seed=seed, core_context=core_ctx,
                     mesh_config=MeshConfig(**inp["mesh"]))
    out = _fit(ctx, inp["steps"], keep=True)
    trainer = out.pop("trainer")
    out["local_layers"] = len(trainer.model.blocks)
    out["coords"] = {a: ctx.mesh.coordinate(a) for a in ("pipe", "seq", "tensor", "expert")}
    units = 1
    if ctx.mesh.shape["seq"] > 1:
        q = torch.randn((1, 2, 32, 64), device=ctx.device, dtype=torch.bfloat16)
        _, counts = ring_block_counts(q, q, q, ctx.mesh.group("seq"))
        units = counts[ctx.mesh.coordinate("seq")]
        out["ring_counts"] = counts
    out["ring_units"] = units
    torch.cuda.synchronize()
    return out


def _m_kernel_rows(seed: int) -> dict:
    """M's K: the three flash kernels at M's ring blocks (M_KERNEL_SHAPES,
    16 heads of 128) held against their plain versions and timed, and
    fused_adamw at the expert leaf tensor 2 x expert 2 leaves on a rank."""
    import torch

    from chip_smoke import _free_cuda, adamw_kernel_row, attention_kernel_rows

    hp = _m_hparams("M2")
    h, dh = hp["n_heads"], hp["d_model"] // hp["n_heads"]
    rows: dict = {"flash_fwd": {}, "flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    gen = torch.Generator(device="cuda").manual_seed(seed + 29)
    for label, b, s, causal in M_KERNEL_SHAPES:
        q, k, v, do = (torch.randn((b, h, s, dh), generator=gen, device="cuda").to(torch.bfloat16)
                       for _ in range(4))
        attention_kernel_rows(rows, label, q, k, v, do, causal, True, "M")
        del q, k, v, do
        _free_cuda()
    e, f = hp["moe_experts"], 4 * hp["d_model"]
    rows["fused_adamw"] = {"w_in_tensor2_expert2": adamw_kernel_row(
        seed, hp["lr"], (e // 2, hp["d_model"], f // 2), "w_in", "M")}
    return rows


def _moe_part(args, root: str) -> dict:
    """M (the docstring at the top)."""
    import torch

    from determined_tpu_torch import train
    from determined_tpu_torch.config import ExperimentConfig

    t_part = time.monotonic()
    for sub, cuts in (("M1", M1_CUTS), ("M2", M2_CUTS)):
        for key, old, value, why in cuts:
            log(f"{sub} cut: {key} {json.dumps(old)} -> {json.dumps(value)} ({why})")
    t0 = time.monotonic()
    out: dict = {"K": _m_kernel_rows(args.seed)}
    log(f"M K: {time.monotonic() - t0:.1f} s")
    for sub, meshes, steps in (("M1", M1_MESHES, STEPS), ("M2", M2_MESHES, M2_STEPS)):
        hp = _m_hparams(sub)
        t0 = time.monotonic()
        m = hp.get("pipe_microbatches", 1)
        if sub == "M1":
            ref_ctx = train.init(hparams=hp, seed=args.seed)
        else:
            # the pipeline's microbatches, aggregated on one GPU
            plain = {k: v for k, v in hp.items() if k != "pipe_microbatches"}
            ref_ctx = train.init(
                hparams=dict(plain, global_batch_size=hp["global_batch_size"] // m),
                seed=args.seed, exp_config=ExperimentConfig.parse(
                    {"optimizations": {"aggregation_frequency": m}}))
        ref = _fit(ref_ctx, steps)
        del ref_ctx
        torch.cuda.empty_cache()
        log(f"{sub} R (one GPU): " + json.dumps(dict(
            losses=ref["losses"], aux=ref["aux"], step_ms=ref["step_ms"],
            peak_memory_gib=ref["peak_memory_gib"], seconds=time.monotonic() - t0)))
        out[sub] = {"R": ref}
        for mesh in meshes:
            t0 = time.monotonic()
            tag = f"{sub} " + "x".join(f"{a}{n}" for a, n in mesh.items())
            outs = _launch_gang(args.gpus, os.path.join(root, tag.replace(" ", "_")),
                                dict(part="M", sub=sub, mesh=mesh, steps=steps), args.seed)
            chief = outs[0]
            for key in ("losses", "aux"):
                np.testing.assert_allclose(chief[key], ref[key], err_msg=f"{tag} {key}",
                                           **MESH_LOSS_TOL)
            # a layer's flash forward once a forward unit (twice under
            # remat), dq and dk/dv once, each times this rank's ring units;
            # a pipe rank runs its layers once a microbatch
            fwd = 2 if hp.get("remat") else 1
            units = m if mesh.get("pipe", 1) > 1 else 1
            for rank, o in enumerate(outs):
                u = o["ring_units"]
                if mesh.get("seq", 1) > 1:
                    assert u == 2 * mesh["seq"] + 1, (tag, rank, o["ring_counts"])
                n = o["local_layers"] * units * steps * u
                want = dict(flash_fwd=fwd * n, flash_bwd_dq=n, flash_bwd_dkv=n,
                            fused_adamw=o["local_leaves"] * steps)
                assert o["launches"] == want, (tag, rank, o["launches"], want)
            row = dict(
                mesh=mesh, losses=chief["losses"], ref_losses=ref["losses"], aux=chief["aux"],
                ref_aux=ref["aux"],
                max_loss_rel=max(abs(a - b) / abs(b) for a, b in
                                 zip(chief["losses"], ref["losses"])),
                max_aux_rel=max(abs(a - b) / abs(b) for a, b in zip(chief["aux"], ref["aux"])),
                step_ms=chief["step_ms"],
                wall_ms_a_step=[1e3 * o["wall_s"] / steps for o in outs],
                peak_memory_gib=[o["peak_memory_gib"] for o in outs],
                ref_peak_memory_gib=ref["peak_memory_gib"],
                local_params=[o["params"] for o in outs],
                local_layers=[o["local_layers"] for o in outs],
                coords=[o["coords"] for o in outs], ring_units=[o["ring_units"] for o in outs],
                launches=[o["launches"] for o in outs], seconds=time.monotonic() - t0)
            log(f"{tag}: " + json.dumps(row))
            out[sub]["x".join(f"{a}{n}" for a, n in mesh.items())] = row
    log(f"M: {time.monotonic() - t_part:.1f} s")
    return out


def _busbw() -> dict:
    """NVLink's all-reduce bus bandwidth over the world: O_BW_BYTES of f32,
    timed with CUDA events over O_BW_REPS calls after a warm-up;
    busbw = 2 (n - 1) / n x bytes / seconds (NCCL's definition)."""
    import torch
    import torch.distributed as tdist

    x = torch.ones(O_BW_BYTES // 4, device="cuda")
    for _ in range(5):
        tdist.all_reduce(x)
    torch.cuda.synchronize()
    tdist.barrier()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(O_BW_REPS):
        tdist.all_reduce(x)
    end.record()
    torch.cuda.synchronize()
    sec = start.elapsed_time(end) / 1e3 / O_BW_REPS
    n = tdist.get_world_size()
    return dict(bytes=O_BW_BYTES, seconds=sec, algbw_gb_per_s=O_BW_BYTES / sec / 1e9,
                busbw_gb_per_s=2 * (n - 1) / n * O_BW_BYTES / sec / 1e9)


class _IssuedCollectives:
    """The collectives this rank issues while open, by (name, the group's
    ranks): calls and bytes in and out, from the c10d calls themselves (the
    trace's records are read first; this is the cross-check)."""

    # name: (the positions and keywords of its output, input and group);
    # FSDP2 calls the _single forms or, in older torch, the _tensor ones
    SIGNATURES = {
        "all_reduce": ((0, "tensor"), (0, "tensor"), (2, "group")),
        "reduce_scatter_tensor": ((0, "output"), (1, "input"), (3, "group")),
        "reduce_scatter_single": ((0, "output"), (1, "input"), (3, "group")),
        "all_gather_into_tensor": ((0, "output_tensor"), (1, "input_tensor"), (2, "group")),
        "all_gather_single": ((0, "output_tensor"), (1, "input_tensor"), (2, "group")),
    }

    def __init__(self) -> None:
        self.rows: dict = {}
        self._saved: dict = {}

    def __enter__(self):
        import torch.distributed as tdist

        def arg(a, k, where):
            pos, key = where
            return a[pos] if len(a) > pos else k.get(key)

        for name, (out_at, in_at, group_at) in self.SIGNATURES.items():
            fn = getattr(tdist, name, None)
            if fn is None:
                continue
            self._saved[name] = fn

            def wrapped(*a, _fn=fn, _name=name, _at=(out_at, in_at, group_at), **k):
                out_t, in_t, group = (arg(a, k, w) for w in _at)
                ranks = tuple(tdist.get_process_group_ranks(group) if group is not None
                              else range(tdist.get_world_size()))
                row = self.rows.setdefault((_name, ranks),
                                           {"calls": 0, "in_bytes": 0, "out_bytes": 0})
                row["calls"] += 1
                row["in_bytes"] += in_t.numel() * in_t.element_size()
                row["out_bytes"] += out_t.numel() * out_t.element_size()
                return _fn(*a, **k)

            setattr(tdist, name, wrapped)
        return self

    def __exit__(self, *exc) -> None:
        import torch.distributed as tdist

        for name, fn in self._saved.items():
            setattr(tdist, name, fn)


def _ring_bytes(rows: dict, steps: int) -> dict:
    """Each group's ring bytes a step from collective rows: an all-reduce
    moves 2 (n - 1) / n of its buffer, a reduce-scatter (n - 1) / n of its
    input, an all-gather (n - 1) / n of its output."""
    out: dict = {}
    for (name, ranks), row in rows.items():
        n = max(len(ranks), 1)
        low = name.lower().replace("_", "")
        if "allreduce" in low:
            ring = 2 * (n - 1) / n * row["in_bytes"]
        elif "reducescatter" in low:
            ring = (n - 1) / n * row["in_bytes"]
        elif "allgather" in low:
            ring = (n - 1) / n * row["out_bytes"]
        else:
            continue
        key = f"{name}@{','.join(map(str, ranks))}"
        out[key] = dict(calls=row["calls"] / steps, ring_bytes=ring / steps)
    return out


def _hop_bytes(rows: dict, per_slice: int) -> dict:
    """Ring bytes a step by hop from ``_ring_bytes`` rows: a group whose
    ranks lie in two slices is ``dcn``'s, one within a slice ``ici``'s."""
    hops = {"ici": 0.0, "dcn": 0.0}
    for key, v in rows.items():
        ranks = [int(x) for x in key.split("@")[1].split(",") if x]
        hops["dcn" if len({x // per_slice for x in ranks}) > 1 else "ici"] += v["ring_bytes"]
    return hops


def _comm_window(trainer, steps: int) -> dict:
    """``steps`` more steps traced twice: the device alone (its NCCL and
    compute kernels' time over the wall), then host and device for the
    collectives' records (bytes by group), with the issued collectives
    counted beside them."""
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from determined_tpu_torch.data import to_device
    from determined_tpu_torch.utils import kineto

    it = iter(trainer.train_loader)
    batches = [to_device(next(it), trainer.device) for _ in range(2 * steps + 1)]
    trainer._train_step(batches[0])
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="dtt-mesh-comm-") as d:
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for b in batches[1:steps + 1]:
                trainer._train_step(b)
            torch.cuda.synchronize()
            wall_us = (time.monotonic() - t0) * 1e6
        prof.export_chrome_trace(os.path.join(d, "device.pt.trace.json"))
        collective_us, compute_us = kineto.split_collectives(
            kineto.op_table([os.path.join(d, "device.pt.trace.json")]))
        with _IssuedCollectives() as issued, profile(
                activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for b in batches[steps + 1:]:
                trainer._train_step(b)
            torch.cuda.synchronize()
        prof.export_chrome_trace(os.path.join(d, "both.pt.trace.json"))
        traced = kineto.collective_bytes([os.path.join(d, "both.pt.trace.json")])
    return dict(wall_ms=wall_us / steps / 1e3, collective_ms=collective_us / steps / 1e3,
                compute_ms=compute_us / steps / 1e3, idle_share=1.0 - compute_us / wall_us,
                trace_ring_bytes=_ring_bytes(traced, steps),
                issued_ring_bytes=_ring_bytes(issued.rows, steps))


def _rank_overlap(core_ctx, inp: dict, seed: int) -> dict:
    """One rank of O: the bus bandwidth, then each of ``inp["runs"]``:
    O_STEPS steps of phase 5's workload on its mesh and knobs (the plan,
    the Trainer's step.comm counters, launches, step time, peak memory),
    then its comm window."""
    import gc

    import torch

    from chip_smoke import TRAIN_HPARAMS
    from determined_tpu_torch import train
    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.observability import get_tracer
    from determined_tpu_torch.train import _overlap

    out = dict(busbw=_busbw(), runs={})
    tracer = get_tracer()
    for name, mesh, opt in inp["runs"]:
        cfg = ExperimentConfig.parse({"hyperparameters": dict(TRAIN_HPARAMS),
                                      "optimizations": opt, "resources": {"mesh": mesh}})
        tracer.reset()
        tracer.configure(enabled=True)
        tracer.start()
        ctx = train.init(exp_config=cfg, seed=seed, core_context=core_ctx)
        res = _fit(ctx, O_STEPS, keep=True)
        tracer.stop()
        counters: dict = {}
        for e in tracer.chrome_events():
            if e.get("ph") == "C" and e["name"].startswith("step.comm"):
                counters[e["name"]] = counters.get(e["name"], 0.0) + e["args"]["value"]
        tracer.reset()
        trainer = res.pop("trainer")
        plan = trainer._overlap_plan
        res.update(
            counters_per_step={k: v / O_STEPS for k, v in counters.items()},
            plan=dict(enabled=plan.enabled, buckets=len(plan.buckets),
                      units=len(_overlap.fsdp_units(plan, trainer.model)),
                      fingerprint=plan.fingerprint(), ici_bytes=plan.comm.bytes_per_step,
                      dcn_bytes=plan.comm.dcn_bytes_per_step,
                      bandwidth_gb_per_s=[plan.comm.bandwidth / 1e9,
                                          plan.comm.dcn_bandwidth / 1e9]),
            comm_model=dict(ici=trainer._comm_model.bytes_per_step,
                            dcn=trainer._comm_model.dcn_bytes_per_step,
                            n_buckets=trainer._comm_model.n_buckets),
            coords={a: ctx.mesh.coordinate(a) for a in ("dcn", "data")},
            comm=_comm_window(trainer, 2))
        out["runs"][name] = res
        del trainer, ctx
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _overlap_part(args, root: str) -> None:
    """O (the docstring at the top)."""
    from chip_smoke import TRAIN_HPARAMS

    t0 = time.monotonic()
    outs = _launch_gang(args.gpus, os.path.join(root, "o"), dict(part="O", runs=O_RUNS),
                        args.seed)
    log("O busbw: " + json.dumps([o["busbw"] for o in outs]))
    runs = {name: [o["runs"][name] for o in outs] for name, _, _ in O_RUNS}
    for name, mesh, opt in O_RUNS:
        for rank, r in enumerate(runs[name]):
            want = dict(flash_fwd=r["layers"] * O_STEPS, flash_bwd_dq=r["layers"] * O_STEPS,
                        flash_bwd_dkv=r["layers"] * O_STEPS,
                        fused_adamw=r["local_leaves"] * O_STEPS)
            assert r["launches"] == want, (name, rank, r["launches"], want)
        chief = runs[name][0]
        log("O " + json.dumps(dict(
            name=name, mesh=mesh, optimizations=opt, losses=chief["losses"],
            step_ms=[r["step_ms"] for r in runs[name]],
            peak_memory_gib=[r["peak_memory_gib"] for r in runs[name]],
            plan=chief["plan"], counters_per_step=chief["counters_per_step"],
            comm=[r["comm"] for r in runs[name]], coords=[r["coords"] for r in runs[name]])))
    # the Trainer's step.comm bytes (the comm model of the FSDP2 units it
    # runs) against the ring bytes of the collectives each rank issues and
    # the trace records, a hop at a time: a group spanning slices is dcn's
    model_check = {}
    for name, mesh, _ in O_RUNS:
        per_slice = args.gpus // mesh.get("num_slices", 1)
        for rank, r in enumerate(runs[name]):
            got = {source: _hop_bytes(r["comm"][source], per_slice)
                   for source in ("issued_ring_bytes", "trace_ring_bytes")}
            model = r["comm_model"]
            issued = got["issued_ring_bytes"]
            for hop in ("ici", "dcn"):
                # the model's bytes are every FSDP2 collective's; what else
                # a step issues is the norm's scalars
                assert model[hop] <= issued[hop] <= model[hop] + 4096, (name, rank, hop, model,
                                                                         issued)
            model_check.setdefault(name, []).append(dict(model=model, **got))
    log("O comm model against the collectives: " + json.dumps(model_check))
    off, on = runs["data4-off"][0]["losses"], runs["data4-on"][0]["losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(on, off))
    assert rel <= O_LOSS_REL, ("data4 overlap on vs off", rel, on, off)
    flat, hier = runs["dcn2-data2-flat"][0], runs["dcn2-data2-hier"][0]
    np.testing.assert_allclose(hier["losses"], flat["losses"], **MESH_LOSS_TOL)
    np.testing.assert_allclose(flat["losses"], off, **MESH_LOSS_TOL)
    assert hier["plan"]["dcn_bytes"] == flat["plan"]["dcn_bytes"] // 2
    # the hierarchical sync's cross-slice bytes: the all-reduces over the
    # dcn groups (ranks r and r + 2), against the plan's fragment
    dcn_groups = {f"{r},{r + 2}" for r in range(args.gpus // 2)}
    summary = {}
    for source in ("trace_ring_bytes", "issued_ring_bytes"):
        dcn = [sum(v["ring_bytes"] for k, v in r["comm"][source].items()
                   if "reduce" in k.lower() and k.split("@")[1] in dcn_groups
                   and "scatter" not in k.lower())
               for r in runs["dcn2-data2-hier"]]
        summary[source] = dict(dcn_ring_bytes_per_rank=dcn,
                               plan_dcn_bytes=hier["plan"]["dcn_bytes"],
                               ratio=[d / hier["plan"]["dcn_bytes"] for d in dcn])
    log("O dcn bytes: " + json.dumps(summary))
    measured = [v["ratio"] for v in summary.values() if all(v["dcn_ring_bytes_per_rank"])]
    assert measured, "neither the trace nor the c10d calls show the dcn all-reduce"
    assert all(0.98 <= x <= 1.05 for ratios in measured for x in ratios), measured
    log("O " + json.dumps(dict(
        data4_on_vs_off_max_loss_rel=rel,
        dcn_flat_vs_hier_max_loss_rel=max(abs(a - b) / abs(b) for a, b in
                                          zip(hier["losses"], flat["losses"])),
        busbw_gb_per_s=min(o["busbw"]["busbw_gb_per_s"] for o in outs),
        hparams=TRAIN_HPARAMS, seconds=time.monotonic() - t0)))


def _params_md5(named) -> str:
    """md5 over ``(name, tensor)`` pairs in name order: each name, then its
    tensor's bytes on the host."""
    import hashlib

    h = hashlib.md5()
    for name, t in sorted(named):
        h.update(name.encode())
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _checkpoint_params_md5(path: str) -> str:
    """``_params_md5`` of a checkpoint's params, each leaf read whole from
    either format."""
    import torch

    from determined_tpu_torch.train import serialization

    layout = serialization.load_layout(path)
    if layout is None:
        return _params_md5(serialization.load_arrays(path, "params").items())
    live = {}
    for key, leaf in layout["leaves"].items():
        part, _, name = key.partition(serialization.SEP)
        if part == "params":
            live[name] = torch.empty(leaf["shape"], dtype=getattr(torch, leaf["dtype"]))
    serialization.restore_arrays(path, {"params": live})
    return _params_md5(live.items())


def _restore_check(ckpt: str, start: dict) -> dict:
    """A run's restore (its chief's ``start`` event) against the checkpoint
    it names: the md5 of the params it restored, gathered whole, equal to
    the checkpoint's."""
    want = _checkpoint_params_md5(os.path.join(ckpt, start["restored"]))
    return dict(step=start["step"], world=start["world"], mesh=start["mesh"],
                checkpoint=start["restored"], bitwise=start["params_md5"] == want)


_ELASTIC: dict = {}


def _elastic_trial():
    """R's trial (``ElasticLMTrial``): LMTrial whose chief appends its
    events as JSON lines under ``$DTT_SMOKE_ELASTIC_DIR``: each run's start
    (its world, its mesh, the checkpoint it restored and ``_params_md5`` of
    its params gathered whole, every rank taking part), its first step
    and each checkpoint."""
    if "ElasticLMTrial" in _ELASTIC:
        return _ELASTIC["ElasticLMTrial"]
    from determined_tpu_torch.models import LMTrial
    from determined_tpu_torch.train import Callback

    def event(**rec) -> None:
        rec["t"] = time.time()
        with open(os.path.join(os.environ[R_DIR_ENV], "events.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

    class ElasticLMTrial(LMTrial):
        def build_callbacks(self):
            dist = self.context.core.distributed

            class Record(Callback):
                def on_training_start(self, trainer) -> None:
                    from torch.distributed.tensor import DTensor

                    from determined_tpu_torch.utils import faults

                    if dist.is_chief:
                        # the train.step site fires before each step: at the
                        # second, this run's first step has been dispatched
                        from chip_smoke import _StepHook

                        faults.set_fault_injector(_StepHook(
                            trainer.steps_completed + 1,
                            lambda: event(event="first_step", world=dist.size)))

                    digest = None
                    if trainer.steps_completed:
                        whole = [(k, p.full_tensor() if isinstance(p, DTensor) else p)
                                 for k, p in sorted(trainer._params.items())]
                        digest = _params_md5(whole) if dist.is_chief else None
                    if dist.is_chief:
                        event(event="start", step=trainer.steps_completed, world=dist.size,
                              mesh=trainer.mesh.shape if trainer.mesh is not None else None,
                              restored=os.environ.get("DTPU_LATEST_CHECKPOINT") or None,
                              params_md5=digest)


                def on_checkpoint_write_end(self, storage_id: str) -> None:
                    if dist.is_chief:
                        event(event="checkpoint", storage_id=storage_id, world=dist.size)

            return {"record": Record()}

    ElasticLMTrial.__module__ = __name__
    ElasticLMTrial.__qualname__ = ElasticLMTrial.__name__
    _ELASTIC["ElasticLMTrial"] = ElasticLMTrial
    return ElasticLMTrial


def _elastic_part(args, root: str, build) -> dict:
    """R (the docstring at the top)."""
    import signal
    import threading

    from chip_smoke import EXPERIMENT_CONST, EXPERIMENT_CUTS, _apply_cuts, _read_events
    from determined_tpu_torch import devcluster
    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.experiment import ClusterExperiment

    assert args.gpus == 4, "R runs two slices of two GPUs"
    for key, old, value, why in R_CUTS:
        log(f"R cut: {key} {json.dumps(old)} -> {json.dumps(value)} ({why})")
    for flag, old, value, why in R_MASTER_CUTS:
        log(f"R cut: dtpu-master {flag} {old} -> {value} ({why})")
    where, t_build = build
    t0 = time.monotonic()
    out, _ = t_build.communicate(timeout=R_TIMEOUT_S)
    assert t_build.returncode == 0, f"native build failed:\n{out[-4000:]}"
    log(f"R: native build {float(out.strip().splitlines()[-1]):.1f} s, waited "
        f"{time.monotonic() - t0:.1f} s for it")
    events_dir = tempfile.mkdtemp(prefix="r-events-", dir=root)
    ckpt = os.path.join(root, "r-ckpt")
    raw = _apply_cuts(EXPERIMENT_CONST, EXPERIMENT_CUTS + R_CUTS, {
        "<temp dir>": ckpt, "<--seed>": args.seed, "<events dir>": events_dir})
    flags = [str(x) for flag, _old, value, _why in R_MASTER_CUTS for x in (flag, value)]
    cluster = devcluster.LocalCluster(
        os.path.join(root, "r-state"), ckpt, agents=4,
        gpus=[str(i) for i in range(4)], cwd=REPO, where=where, slices=2, master_args=flags)
    result: dict = {}
    try:
        cluster.start()
        session = cluster.session()
        exp = ClusterExperiment(ExperimentConfig.parse(raw), session=session,
                                checkpoint_dir=os.path.join(root, "r-driver"), poll_interval=0.5)
        summary: dict = {}
        driver = threading.Thread(target=lambda: summary.update(exp.run()), daemon=True)
        t_submit = time.time()
        driver.start()
        path = os.path.join(events_dir, "events.jsonl")

        def wait(what, pred):
            deadline = time.monotonic() + R_TIMEOUT_S
            while time.monotonic() < deadline:
                got = [e for e in _read_events(path) if pred(e)]
                if got:
                    return got[0]
                assert driver.is_alive(), f"the experiment ended before {what}: {summary}"
                time.sleep(0.2)
            raise AssertionError(f"R: no {what} in {R_TIMEOUT_S:.0f} s")

        started = wait("the first step on two slices",
                       lambda e: e["event"] == "first_step" and e["world"] == 4)
        saved = wait("a checkpoint on two slices",
                     lambda e: e["event"] == "checkpoint" and e["world"] == 4)
        t_kill = time.time()
        cluster.kill_agents([2, 3])
        log(f"R: slice 1's agents (2, 3) and their trials SIGKILLed, {t_kill - t_submit:.1f} s "
            f"after the submit; the newest checkpoint {saved['storage_id']}")
        shrunk = wait("the first step on one slice",
                      lambda e: e["event"] == "first_step" and e["world"] == 2
                      and e["t"] > t_kill)
        # each restore against its checkpoint, read before the master's GC
        # may take it
        restores = [_restore_check(ckpt, e) for e in _read_events(path)
                    if e["event"] == "start" and e["restored"]]
        t_restart = time.time()
        cluster.start_agents([2, 3])
        log(f"R: agents 2, 3 restarted {t_restart - t_kill:.1f} s after the kill")
        grown = wait("the first step back on two slices",
                     lambda e: e["event"] == "first_step" and e["world"] == 4
                     and e["t"] > t_restart)
        restores += [_restore_check(ckpt, e) for e in _read_events(path)
                     if e["event"] == "start" and e["restored"] and e["t"] > t_restart]
        mexp = exp.master_experiment_id
        session.post(f"/api/v1/experiments/{mexp}/kill")
        driver.join(timeout=120)
        events = _read_events(path)
        # the master's elastic records of the trial: its log's "elastic:"
        # lines (time, text) and the trial's resize count
        tid = session.get(f"/api/v1/experiments/{mexp}").json()["trials"][0]["id"]
        recs = session.get(f"/api/v1/trials/{tid}/logs", params={"limit": 100000}).json()
        elastic = [(r["ts"] / 1e3, r["line"]) for r in recs
                   if isinstance(r, dict) and "elastic:" in str(r.get("line", ""))]
        trial = session.get(f"/api/v1/trials/{tid}").json()
        grow_at = [t for t, line in elastic if "growing trial" in line]
        completed = [int(line.split(" now ")[1].split("/")[0]) for _, line in elastic
                     if "resize complete" in line]
        result = dict(
            submit_to_first_step_s=started["t"] - t_submit,
            shrink_to_first_step_s=shrunk["t"] - t_kill,
            restart_to_first_step_s=grown["t"] - t_restart,
            grow_to_first_step_s=grown["t"] - grow_at[0] if grow_at else None,
            elastic_log=[(t - t_submit, line) for t, line in elastic],
            resizes=trial.get("resizes"), completed_slots=completed, restores=restores,
            steps=[(e["event"], e.get("step"), e["world"]) for e in events],
            cooldown_s=R_COOLDOWN_S)
        log("R " + json.dumps(result, default=str))
        assert trial.get("resizes") == 2 and completed == [2, 4], (trial, elastic)
        assert grow_at, elastic
        assert [(r["world"], r["mesh"]["dcn"]) for r in restores][:2] == [(2, 1), (4, 2)], \
            restores
        assert all(r["bitwise"] for r in restores), restores
        return result
    finally:
        cluster.stop()
        if t_build.poll() is None:
            os.killpg(t_build.pid, signal.SIGKILL)
            t_build.wait()


def _rank_seq(core_ctx, mesh: dict, seed: int) -> dict:
    """One rank of S: the LM's fit on ``mesh``, and the ring's units for
    this rank (ring_block_counts on its seq group; 1 without one)."""
    import torch

    from determined_tpu_torch import train
    from determined_tpu_torch.ops.ring_attention import ring_block_counts
    from determined_tpu_torch.parallel import MeshConfig

    ctx = train.init(hparams=_seq_hparams(), seed=seed, core_context=core_ctx,
                     mesh_config=MeshConfig(**mesh))
    out = _fit(ctx, STEPS)
    out["coords"] = {a: ctx.mesh.coordinate(a) for a in ("fsdp", "seq", "tensor")}
    units = 1
    if ctx.mesh.shape["seq"] > 1:
        q = torch.randn((1, 2, 32, 64), device=ctx.device, dtype=torch.bfloat16)
        _, counts = ring_block_counts(q, q, q, ctx.mesh.group("seq"))
        units = counts[ctx.mesh.coordinate("seq")]
        out["ring_counts"] = counts
    out["ring_units"] = units
    torch.cuda.synchronize()
    return out


def _rank_ckpt(core_ctx, workdir: str, seed: int) -> dict:
    """One rank of C: SEQ_CKPT_STEPS steps at tensor 2 x seq 2 and a
    checkpoint; the chief also saves the mesh's gathered params and
    moments for the one-GPU restore to be held against."""
    import torch

    from determined_tpu_torch import train
    from determined_tpu_torch.models import LMTrial
    from determined_tpu_torch.parallel import MeshConfig

    ctx = train.init(hparams=_seq_hparams(SEQ_CKPT_CUTS), seed=seed, core_context=core_ctx,
                     mesh_config=MeshConfig(tensor=2, seq=2))
    trainer = train.Trainer(LMTrial(ctx))
    summary = trainer.fit(max_length=SEQ_CKPT_STEPS, report_period=1, checkpoint_policy="all",
                          validation_period=SEQ_CKPT_STEPS)
    full = trainer._full_array_state()
    if core_ctx.distributed.is_chief:
        torch.save({"params": full["params"], "mu": full["opt_state"].mu,
                    "nu": full["opt_state"].nu}, os.path.join(workdir, "mesh_state.pt"))
    return dict(storage_id=summary["latest_checkpoint"])


def _ckpt_on_one_gpu(workdir: str, sid: str, seed: int) -> dict:
    """C's restore: one GPU's Trainer resumes the mesh's checkpoint; its
    params and moments equal the mesh's gathered ones bitwise."""
    import torch

    from determined_tpu_torch import core, train
    from determined_tpu_torch.models import LMTrial

    want = torch.load(os.path.join(workdir, "mesh_state.pt"))
    ctx = train.init(hparams=_seq_hparams(SEQ_CKPT_CUTS), seed=seed,
                     core_context=core._dummy_init(checkpoint_dir=os.path.join(workdir, "ck")))
    trainer = train.Trainer(LMTrial(ctx))
    summary = trainer.fit(max_length=SEQ_CKPT_STEPS, latest_checkpoint=sid,
                          checkpoint_policy="none")
    assert summary["steps_completed"] == SEQ_CKPT_STEPS
    for name, p in trainer._params.items():
        assert torch.equal(p.detach().cpu(), want["params"][name]), name
    for which in ("mu", "nu"):
        for name, t in getattr(trainer.state.opt_state, which).items():
            assert torch.equal(t.cpu(), want[which][name]), (which, name)
    return dict(storage_id=sid, leaves=len(trainer._params), restored="bitwise")


def _layer_inputs(seed: int):
    rng = np.random.default_rng(seed + 21)
    d, e, f = 256, 8, 1024
    x = rng.standard_normal((8, 1024, d)).astype(np.float32)
    weights = {"router": rng.standard_normal((d, e)) * d ** -0.5,
               "w_in": rng.standard_normal((e, d, f)) * (e * d) ** -0.5,
               "w_gate": rng.standard_normal((e, d, f)) * (e * d) ** -0.5,
               "w_out": rng.standard_normal((e, f, d)) * (e * f) ** -0.5}
    return (d, e, f), x, weights


def _layer_run(dims, x, weights, device, mesh=None):
    """The MoE layer's output, aux and gradients (all on the host)."""
    import torch

    from determined_tpu_torch.models.moe import MoE

    d, e, f = dims
    layer = MoE(d, e, f, dtype=torch.float32, device=device)
    layer.load_state_dict({k: torch.tensor(v, dtype=torch.float32) for k, v in weights.items()})
    if mesh is not None:
        layer.shard_experts(mesh.group("expert"), mesh.shape["expert"],
                            mesh.coordinate("expert"))
    xt = torch.tensor(x, device=device, requires_grad=True)
    y, aux = layer(xt)
    ((y ** 2).mean() + 0.01 * aux).backward()
    return dict(y=y.detach().cpu().numpy(), aux=float(aux.detach()),
                x=xt.grad.cpu().numpy(),
                **{n: p.grad.cpu().numpy() for n, p in layer.named_parameters()})


def _rank_layer(dist) -> dict:
    """E on one rank: the expert-parallel layer on this rank's tokens and
    the unsharded layer on the same tokens, both on this rank's GPU."""
    import torch

    from determined_tpu_torch.parallel import MeshConfig, make_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh(MeshConfig(data=2, expert=2), dist.device.type)
    dims, x, weights = _layer_inputs(int(os.environ["MESH_SMOKE_SEED"]))
    rows = np.array_split(x, 2)[mesh.coordinate("data")]
    got = _layer_run(dims, rows, weights, dist.device, mesh)
    want = _layer_run(dims, rows, weights, dist.device)
    n = dims[1] // 2
    lo = mesh.coordinate("expert") * n
    errs = {}
    for k, v in got.items():
        ref = want[k][lo:lo + n] if k in ("w_in", "w_gate", "w_out") else want[k]
        np.testing.assert_allclose(v, ref, err_msg=f"E {k}", **E_TOL)
        errs[k] = float(np.max(np.abs(np.asarray(v) - np.asarray(ref))))
    return dict(max_abs_err=errs)


def _launch_gang(n: int, workdir: str, mesh: dict, seed: int,
                 timeout: float = GANG_TIMEOUT_S) -> list:
    """``n`` rank processes of this script with a torchrun environment;
    their results, or a failure naming the ranks (killed after ``timeout``
    seconds, or as soon as one rank fails: the others would wait for it in
    a collective).  A gang whose rendezvous port was taken before rank 0
    listened on it (a peer's connect can be given that very port as its
    own) starts again once on another port."""
    from determined_tpu_torch.core import allocate_port

    os.makedirs(workdir, exist_ok=True)
    for attempt in (1, 2):
        env = dict(os.environ, WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(allocate_port()),
                   MESH_SMOKE_SEED=str(seed), PYTHONPATH=REPO)
        procs, logs = [], []
        for rank in range(n):
            log_f = open(os.path.join(workdir, f"rank{rank}.log"), "w")
            logs.append(log_f)
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--rank-of", workdir,
                 json.dumps(mesh), "--seed", str(seed)],
                env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank)), cwd=REPO,
                stdout=log_f, stderr=subprocess.STDOUT,
            ))
        deadline = time.monotonic() + timeout
        hung = False
        try:
            while any(p.poll() is None for p in procs):
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                if time.monotonic() > deadline:
                    hung = True
                    break
                time.sleep(0.5)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            for f in logs:
                f.close()
        bad = [r for r, p in enumerate(procs) if hung or p.returncode != 0]
        if not bad:
            break
        texts = {}
        for r in bad:
            with open(os.path.join(workdir, f"rank{r}.log")) as f:
                texts[r] = f.read()[-4000:]
        if attempt == 1 and not hung and any("EADDRINUSE" in t for t in texts.values()):
            log(f"gang {mesh}: its rendezvous port was taken; starting it again")
            continue
        for r, text in texts.items():
            log(f"--- rank {r} of {mesh}:\n{text}")
        raise RuntimeError(f"gang {mesh} failed on ranks {bad}" + (" (timed out)" if hung else ""))
    out = []
    for rank in range(n):
        with open(os.path.join(workdir, f"out{rank}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _seq_part(args, root: str) -> None:
    """S and C (the docstring at the top)."""
    import torch

    from chip_smoke import SEQ_CUTS
    from determined_tpu_torch import train

    for key, old, value, why in SEQ_CUTS + SEQ_MESH_CUTS:
        log(f"S cut: {key} {json.dumps(old)} -> {json.dumps(value)} ({why})")
    for key, old, value, why in SEQ_CKPT_CUTS:
        log(f"C cut: {key} {json.dumps(old)} -> {json.dumps(value)} ({why})")
    ctx = train.init(hparams=_seq_hparams(), seed=args.seed)
    ref = _fit(ctx, STEPS)
    del ctx
    torch.cuda.empty_cache()
    log("S one GPU: " + json.dumps({k: v for k, v in ref.items() if k != "aux"}))
    for i, mesh in enumerate(SEQ_MESHES):
        outs = _launch_gang(args.gpus, os.path.join(root, f"s{i}"), dict(part="S", mesh=mesh),
                            args.seed)
        chief = outs[0]
        np.testing.assert_allclose(chief["losses"], ref["losses"], err_msg=str(mesh),
                                   **MESH_LOSS_TOL)
        for rank, o in enumerate(outs):
            layers, leaves, u = o["layers"], o["local_leaves"], o["ring_units"]
            if mesh.get("seq", 1) > 1:
                assert u == 2 * mesh["seq"] + 1, (mesh, rank, o["ring_counts"])
            want = dict(flash_fwd=2 * layers * STEPS * u, flash_bwd_dq=layers * STEPS * u,
                        flash_bwd_dkv=layers * STEPS * u, fused_adamw=leaves * STEPS)
            assert o["launches"] == want, (mesh, rank, o["launches"], want)
        log("S " + json.dumps(dict(
            mesh=mesh, losses=chief["losses"], ref_losses=ref["losses"],
            max_loss_rel=max(abs(a - b) / abs(b) for a, b in zip(chief["losses"], ref["losses"])),
            step_ms=[o["step_ms"] for o in outs],
            peak_memory_gib=[o["peak_memory_gib"] for o in outs],
            ref_peak_memory_gib=ref["peak_memory_gib"],
            local_params=[o["params"] for o in outs], coords=[o["coords"] for o in outs],
            ring_counts=[o.get("ring_counts") for o in outs],
            launches=[o["launches"] for o in outs])))
    workdir = os.path.join(root, "c")
    outs = _launch_gang(args.gpus, workdir, dict(part="C"), args.seed)
    sid = outs[0]["storage_id"]
    assert all(o["storage_id"] == sid for o in outs), outs
    log("S-C " + json.dumps(_ckpt_on_one_gpu(workdir, sid, args.seed)))


# ---------------------------------------------------------------------------
# X: the local experiment on every GPU of the host
# ---------------------------------------------------------------------------


def _journal(ckpt_dir: str) -> list:
    with open(os.path.join(ckpt_dir, "experiment.journal")) as f:
        return [json.loads(line) for line in f]


def _trial_devices(ckpt_dir: str) -> dict:
    """rid -> the devices of its first ``trial_running`` record."""
    out: dict = {}
    for r in _journal(ckpt_dir):
        if r["type"] == "trial_running":
            out.setdefault(r["rid"], r["devices"])
    return out


def _validations(ckpt_dir: str) -> dict:
    """(rid, steps) -> the validation metrics the searcher received."""
    return {(r["rid"], r["metrics"]["batches"]): r["metrics"] for r in _journal(ckpt_dir)
            if r["type"] == "trial_validated"}


def _recording_experiment():
    """LocalExperiment that records the searcher's events in order (for the
    replay) and deletes a trial's checkpoints when it ends."""
    import copy

    from determined_tpu_torch.experiment import LocalExperiment

    class Recording(LocalExperiment):
        def __init__(self, *args, **kwargs) -> None:
            super().__init__(*args, **kwargs)
            self.events: list = []
            for name in ("on_validation", "on_trial_exited", "on_trial_exited_early"):
                orig = getattr(self.searcher, name)

                def record(*a, _orig=orig, _name=name):
                    self.events.append((_name, copy.deepcopy(a)))
                    return _orig(*a)

                setattr(self.searcher, name, record)

        def _run_trial(self, create, devices=None):
            result = super()._run_trial(create, devices)
            shutil.rmtree(self._trial_checkpoint_dir(create.request_id), ignore_errors=True)
            return result

    return Recording


def _per_device_launches() -> dict:
    import determined_tpu_torch.ops.flash_attention as fa
    from determined_tpu_torch.ops import fused_adamw as fw

    devices = set(fw.launches_by_device)
    for per in fa.launches_by_device.values():
        devices |= set(per)
    return {d: dict(flash_fwd=fa.launches_by_device["flash_fwd"].get(d, 0),
                    flash_bwd_dq=fa.launches_by_device["flash_bwd_dq"].get(d, 0),
                    flash_bwd_dkv=fa.launches_by_device["flash_bwd_dkv"].get(d, 0),
                    fused_adamw=fw.launches_by_device.get(d, 0)) for d in sorted(devices)}


def _x1(args, root: str) -> dict:
    """X1 (the docstring at the top)."""
    import torch

    from chip_smoke import (SEARCH_ASHA_CUTS, TRAIN_PARITY_TOL, _check_trial_set,
                            _reset_launches, search_raw_config)
    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.models import LMTrial
    from determined_tpu_torch.searcher import ASHASearch

    for key, old, value, why in SEARCH_ASHA_CUTS:
        log(f"X1 cut: {key} {json.dumps(old)} -> {json.dumps(value)} ({why})")
    runs = {}
    for label, devices in (("serial", ["cuda:0"]), ("concurrent", None)):
        ckpt = os.path.join(root, f"x1-{label}")
        cfg = ExperimentConfig.parse(search_raw_config("S1", ckpt, args.seed))
        exp = _recording_experiment()(cfg, LMTrial, checkpoint_dir=ckpt, devices=devices)
        _reset_launches()
        t0 = time.monotonic()
        summary = exp.run()
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        runs[label] = dict(exp=exp, cfg=cfg, wall_s=time.monotonic() - t0, summary=summary,
                           devices=_trial_devices(ckpt), validations=_validations(ckpt),
                           launches=_per_device_launches())
        assert summary["status"] == "completed", summary
        _check_trial_set(exp, cfg, args.seed, ASHASearch)
        log(f"X1 {label}: {runs[label]['wall_s']:.1f} s, " + json.dumps(dict(
            summary=summary, devices=runs[label]["devices"],
            scheduler=exp.scheduler_stats, launches=runs[label]["launches"])))
    serial, packed = runs["serial"], runs["concurrent"]
    stats = packed["exp"].scheduler_stats
    assert stats is not None and stats["peak_concurrency"] == 4, stats
    first = [packed["devices"][rid] for rid in sorted(packed["devices"])[:4]]
    assert sorted(d for ds in first for d in ds) == [f"cuda:{i}" for i in range(4)], first

    def trial_set(run):
        return {rid: r.hparams for rid, r in run["exp"].results.items()}

    assert trial_set(packed) == trial_set(serial)
    both = sorted(set(serial["validations"]) & set(packed["validations"]))
    assert both
    diffs = {}
    for key in both:
        a = packed["validations"][key]["validation_loss"]
        b = serial["validations"][key]["validation_loss"]
        diffs[f"{key[0]}@{key[1]}"] = abs(a - b)
        np.testing.assert_allclose(a, b, err_msg=str(key), **TRAIN_PARITY_TOL["loss"])

    def decisions(run):
        return {rid: (r.steps_completed, run["exp"].searcher.is_stopped(rid))
                for rid, r in run["exp"].results.items()}

    # each GPU's launches: its trials' steps and validation batches
    hp = {k: v.val for k, v in packed["cfg"].hyperparameters.items() if hasattr(v, "val")}
    layers, n_val = hp["n_layers"], hp["dataset_size"] // hp["global_batch_size"]
    want: dict = {}
    for rid, r in packed["exp"].results.items():
        dev = int(packed["devices"][rid][0].split(":")[1])
        vals = sum(1 for k in packed["validations"] if k[0] == rid)
        w = want.setdefault(dev, dict(flash_fwd=0, flash_bwd_dq=0, flash_bwd_dkv=0,
                                      fused_adamw=0))
        w["flash_fwd"] += layers * (r.steps_completed + vals * n_val)
        w["flash_bwd_dq"] += layers * r.steps_completed
        w["flash_bwd_dkv"] += layers * r.steps_completed
        w["fused_adamw"] += (3 + 9 * layers) * r.steps_completed
    assert packed["launches"] == want, (packed["launches"], want)
    out = dict(wall_s=dict(serial=serial["wall_s"], concurrent=packed["wall_s"]),
               speedup=serial["wall_s"] / packed["wall_s"], scheduler=stats,
               devices=packed["devices"], validations_compared=len(both),
               validations_bitwise=all(d == 0 for d in diffs.values()),
               max_validation_diff=max(diffs.values()),
               decisions=dict(serial=decisions(serial), concurrent=decisions(packed)),
               launches_by_device=packed["launches"])
    log("X1 " + json.dumps(out, default=str))
    return out


def _x2_raw(ckpt_dir: str, seed: int) -> dict:
    from chip_smoke import MOE_EP_CONST, _apply_cuts, _moe_hparams

    raw = _apply_cuts(MOE_EP_CONST, X2_CUTS, {"<temp dir>": ckpt_dir, "<--seed>": seed})
    raw["hyperparameters"] = _moe_hparams()
    return raw


def _rank_x2_restore(core_ctx, workdir: str, inp: dict) -> dict:
    """One rank of X2's restores: on fsdp 2 x expert 2 the step-12
    checkpoint restored and then gathered and written whole by the chief
    (the earlier mesh save path, timed); on data 4 restored (a trial.resize span)
    and gathered, held against the first bitwise on the chief."""
    import torch

    from determined_tpu_torch import train
    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.models import LMTrial
    from determined_tpu_torch.observability import get_tracer
    from determined_tpu_torch.parallel import MeshConfig

    # these restores compare bytes, not digests: the resume B checked the
    # md5 path of a sharded checkpoint
    cfg = ExperimentConfig.parse(dict(inp["raw"], fault_tolerance={"verify_checkpoints": False}))
    chief = core_ctx.distributed.is_chief
    out: dict = {}
    first = None
    for mesh in (dict(fsdp=2, expert=2), dict(data=4)):
        get_tracer().reset()
        ctx = train.init(hparams=_hparams(), exp_config=cfg, seed=inp["seed"],
                         core_context=core_ctx, mesh_config=MeshConfig(**mesh))
        trainer = train.Trainer(LMTrial(ctx))
        trainer.fit(max_length=X2_STEPS, latest_checkpoint=inp["sid"], checkpoint_policy="none")
        spans = {e["name"] for e in get_tracer().chrome_events() if e["ph"] == "X"}
        torch.cuda.synchronize()
        t0 = time.monotonic()
        full = trainer._full_array_state()
        gather_s = time.monotonic() - t0
        state = None
        if chief:
            state = {"params": full["params"], "mu": full["opt_state"].mu,
                     "nu": full["opt_state"].nu}
        key = "_".join(f"{k}{v}" for k, v in mesh.items())
        if first is None:
            write_s = None
            if chief:
                t1 = time.monotonic()
                torch.save(state, os.path.join(workdir, "gathered.pt"))
                write_s = time.monotonic() - t1
            first = state
            out[key] = dict(gather_s=gather_s, chief_write_s=write_s,
                            resize="trial.resize" in spans)
        else:
            if chief:
                for part in ("params", "mu", "nu"):
                    for name, t in state[part].items():
                        assert torch.equal(t, first[part][name]), (mesh, part, name)
            out[key] = dict(gather_s=gather_s, resize="trial.resize" in spans,
                            bitwise=bool(chief))
        del trainer, ctx, full, state
        torch.cuda.empty_cache()
    return out


def _x2(args, root: str) -> dict:
    """X2 (the docstring at the top)."""
    import glob

    import torch

    from chip_smoke import gang_drive, load_compared
    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.experiment import LocalExperiment
    from determined_tpu_torch.models import LMTrial
    from determined_tpu_torch.train import serialization

    for key, old, value, why in X2_CUTS:
        log(f"X2 cut: {key} {json.dumps(old)} -> {json.dumps(value)} ({why})")
    # at most three 13.3 GB states on the disk at once: U's last checkpoint,
    # A/B's two (or the gathered copy)
    free = shutil.disk_usage(root).free
    log(f"X2: {free / 2**30:.1f} GiB free under {root}")
    assert free > 45 * 2 ** 30, f"X2 needs 45 GiB free under {root}"
    # U: uninterrupted, checkpointed at its end only
    ucfg = _x2_raw(os.path.join(root, "x2-u"), args.seed)
    for key, value in (("checkpoint_policy", "none"), ("min_checkpoint_period",
                                                       {"batches": X2_STEPS})):
        log(f"X2 U cut: {key} {json.dumps(ucfg.get(key))} -> {json.dumps(value)} (U writes "
            "only its step-12 checkpoint, the one the restores read)")
        ucfg[key] = value
    t0 = time.monotonic()
    exp = LocalExperiment(ExperimentConfig.parse(ucfg), LMTrial,
                          checkpoint_dir=ucfg["checkpoint_storage"]["host_path"])
    summary_u = exp.run()
    wall_u = time.monotonic() - t0
    udir = ucfg["checkpoint_storage"]["host_path"]
    val_u = _validations(udir)
    log(f"X2 U (uninterrupted gang): {wall_u:.1f} s, " + json.dumps(summary_u))
    assert summary_u["status"] == "completed" and sorted(val_u) == [(1, 6), (1, X2_STEPS)]
    sid = exp.results[1].checkpoint
    ckpt = os.path.join(udir, "trial_1", sid)
    for other in os.listdir(os.path.join(udir, "trial_1")):
        if other != sid:
            shutil.rmtree(os.path.join(udir, "trial_1", other))
    layout = serialization.load_layout(ckpt)
    whole = sum(int(np.prod(e["shape"], dtype=np.int64)) * torch.empty(
        0, dtype=getattr(torch, e["dtype"])).element_size() for e in layout["leaves"].values())
    rank_bytes = {int(os.path.basename(f)[4:9]): os.path.getsize(f)
                  for f in glob.glob(os.path.join(ckpt, "state", "shards", "rank*.pt"))}
    assert abs(sum(rank_bytes.values()) - whole) <= 0.01 * whole, (rank_bytes, whole)
    attempt = os.path.join(udir, "gangs", "trial_1", "attempt_1")
    save_s = {}
    for r in range(4):
        with open(os.path.join(attempt, f"rank{r}.spans.json")) as f:
            spans = json.load(f)
        save_s[r] = {name: [round(e["dur"] / 1e6, 6) for e in spans if e["name"] == name]
                     for name in ("checkpoint.save", "checkpoint.dispatch", "checkpoint.write",
                                  "checkpoint.stall", "checkpoint.finalize",
                                  "checkpoint.digest")}

    # A and B: SIGTERM before step 4 (read at 6), resumed to 12
    abcfg = _x2_raw(os.path.join(root, "x2-ab"), args.seed)
    abdir = abcfg["checkpoint_storage"]["host_path"]
    config_path = os.path.join(root, "x2.json")
    with open(config_path, "w") as f:
        json.dump(abcfg, f)
    code_a, rec_a, wall_a = gang_drive("run", config_path, abdir, os.path.join(root, "x2a.json"),
                                       X2_ENTRY)
    log(f"X2 A (SIGTERM before step {X2_SIGTERM_AT}): exit {code_a}, {wall_a:.1f} s, "
        + json.dumps(rec_a))
    assert code_a == 75, code_a
    code_b, rec_b, wall_b = gang_drive("resume", "-", abdir, os.path.join(root, "x2b.json"))
    log(f"X2 B (resumed): exit {code_b}, {wall_b:.1f} s, " + json.dumps(rec_b))
    assert code_b == 0, code_b
    val_ab = _validations(abdir)
    assert val_ab == val_u, (val_ab, val_u)
    shutil.rmtree(abdir, ignore_errors=True)

    # the restores: data 4 (trial.resize) and one GPU, against the gathered state
    workdir = os.path.join(root, "x2r")
    outs = _launch_gang(args.gpus, workdir, dict(part="X2R", raw=ucfg, sid=sid,
                                                 ckpt_dir=os.path.join(udir, "trial_1")),
                        args.seed)
    restores = outs[0]
    assert restores["fsdp2_expert2"]["resize"] is False and restores["data4"]["resize"], restores
    want = torch.load(os.path.join(workdir, "gathered.pt"))
    t0 = time.monotonic()
    _, single = load_compared(ckpt, LMTrial)
    one_gpu_s = time.monotonic() - t0
    for name, p in single._params.items():
        assert torch.equal(p.detach().cpu(), want["params"][name]), name
    for which in ("mu", "nu"):
        for name, t in getattr(single.state.opt_state, which).items():
            assert torch.equal(t.cpu(), want[which][name]), (which, name)
    del single, want
    torch.cuda.empty_cache()
    out = dict(
        wall_s=dict(uninterrupted=wall_u, A=wall_a, B=wall_b),
        launch_to_first_step_s=rec_a["launch_to_first_step_s"],
        whole_state_bytes=whole, rank_checkpoint_bytes=rank_bytes,
        rank_bytes_over_whole=sum(rank_bytes.values()) / whole,
        rank_save_s=save_s, chief_gather=restores, one_gpu_restore_s=one_gpu_s,
        validations=[val_u[(1, 6)]["validation_loss"], val_u[(1, X2_STEPS)]["validation_loss"]],
        resumed_bitwise=True, restores_bitwise=True,
    )
    log("X2 " + json.dumps(out))
    return out


def _x3(args, root: str) -> dict:
    """X3 (the docstring at the top)."""
    from chip_smoke import MNIST_ADAPTIVE, _apply_cuts
    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.experiment import LocalExperiment
    from determined_tpu_torch.models import MnistTrial

    for key, old, value, why in X3_CUTS:
        log(f"X3 cut: {key} {json.dumps(old)} -> {json.dumps(value)} ({why})")
    runs = {}
    for label, devices in (("serial", ["cuda:0", "cuda:1"]), ("concurrent", None)):
        ckpt = os.path.join(root, f"x3-{label}")
        raw = _apply_cuts(MNIST_ADAPTIVE, X3_CUTS, {"<temp dir>": ckpt, "<--seed>": args.seed})
        exp = LocalExperiment(ExperimentConfig.parse(raw), MnistTrial, checkpoint_dir=ckpt,
                              devices=devices)
        t0 = time.monotonic()
        summary = exp.run()
        runs[label] = dict(exp=exp, wall_s=time.monotonic() - t0, devices=_trial_devices(ckpt))
        assert summary["status"] == "completed", summary
        log(f"X3 {label}: {runs[label]['wall_s']:.1f} s, " + json.dumps(dict(
            summary=summary, devices=runs[label]["devices"], scheduler=exp.scheduler_stats)))
        shutil.rmtree(ckpt, ignore_errors=True)
    packed = runs["concurrent"]
    stats = packed["exp"].scheduler_stats
    assert stats["peak_concurrency"] == 2 and stats["backfills"] >= 1, stats
    blocks = {tuple(d) for d in packed["devices"].values()}
    assert blocks == {("cuda:0", "cuda:1"), ("cuda:2", "cuda:3")}, blocks
    assert {r: x.hparams for r, x in packed["exp"].results.items()} == \
        {r: x.hparams for r, x in runs["serial"]["exp"].results.items()}
    out = dict(wall_s={k: v["wall_s"] for k, v in runs.items()}, scheduler=stats,
               devices=packed["devices"],
               steps={r: x.steps_completed for r, x in packed["exp"].results.items()})
    log("X3 " + json.dumps(out, default=str))
    return out


def _x_part(args, root: str, names) -> None:
    from determined_tpu_torch.experiment import _gang

    _gang.ATTEMPT_TIMEOUT_S = GANG_TIMEOUT_S
    for name in names:
        fn = {"X1": _x1, "X2": _x2, "X3": _x3}[name]
        t0 = time.monotonic()
        fn(args, root)
        log(f"{name}: {time.monotonic() - t0:.1f} s")


def _run_trial_pids() -> list:
    """Pids of the port's trial processes on this host, oldest first."""
    pids = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/cmdline", "rb") as f:
                cmd = f.read().split(b"\0")
        except OSError:
            continue
        if b"determined_tpu_torch.exec.run_trial" in cmd:
            pids.append(int(name))
    return sorted(pids)


def _cluster_part(args, root: str) -> dict:
    """C (the docstring at the top)."""
    import signal
    import threading

    from chip_smoke import MNIST_ADAPTIVE, _apply_cuts
    from determined_tpu_torch import devcluster
    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.experiment import ClusterExperiment, LocalExperiment
    from determined_tpu_torch.models import MnistTrial

    for key, old, value, why in X3_CUTS + C_CUTS:
        log(f"C cut: {key} {json.dumps(old)} -> {json.dumps(value)} ({why})")
    where = tempfile.mkdtemp(prefix="native-", dir=root)
    t_build = time.monotonic()
    build = subprocess.Popen(
        [sys.executable, "-c", "import sys; from determined_tpu_torch import devcluster; "
         "print(devcluster.build_binaries(sys.argv[1], force=True))", where],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    cluster = None
    try:
        # the reference: run-local's path on the blocks {0,1} and {2,3}
        ref_ckpt = os.path.join(root, "c-ref")
        raw = _apply_cuts(MNIST_ADAPTIVE, X3_CUTS, {"<temp dir>": ref_ckpt,
                                                    "<--seed>": args.seed})
        t0 = time.monotonic()
        ref = LocalExperiment(ExperimentConfig.parse(raw), MnistTrial, checkpoint_dir=ref_ckpt)
        ref_summary = ref.run()
        ref_s = time.monotonic() - t0
        assert ref_summary["status"] == "completed", ref_summary
        want = {r: x.hparams for r, x in ref.results.items()}
        log(f"C reference (run-local, blocks {{0,1}} and {{2,3}}): {ref_s:.1f} s, "
            + json.dumps(ref_summary, default=str))
        shutil.rmtree(ref_ckpt, ignore_errors=True)

        t0 = time.monotonic()
        out, _ = build.communicate(timeout=C_TIMEOUT_S)
        waited = time.monotonic() - t0
        assert build.returncode == 0, f"native build failed:\n{out[-4000:]}"
        build_s = float(out.strip().splitlines()[-1])
        log(f"C: native build {build_s:.1f} s (started {t0 - t_build:.1f} s before the join), "
            f"waited {waited:.1f} s for it")

        ckpt = os.path.join(root, "c-cluster")
        cluster = devcluster.LocalCluster(
            os.path.join(root, "c-state"), ckpt, agents=args.gpus,
            gpus=[str(i) for i in range(args.gpus)], cwd=REPO, where=where)
        cluster.start()
        session = cluster.session()
        log(f"C: master {cluster.url}, {args.gpus} agents, one GPU each")
        raw = _apply_cuts(MNIST_ADAPTIVE, X3_CUTS + C_CUTS, {"<temp dir>": ckpt,
                                                             "<--seed>": args.seed})
        exp = ClusterExperiment(ExperimentConfig.parse(raw), session=session,
                                checkpoint_dir=os.path.join(root, "c-driver"),
                                poll_interval=0.5)
        killed: dict = {}
        done = threading.Event()

        def training() -> bool:
            """A trial has reported a training row to the master."""
            for w in list(exp._watches.values()):
                if w.master_trial_id is not None and session.get(
                        f"/api/v1/trials/{w.master_trial_id}/metrics",
                        params={"group": "training"}).json():
                    return True
            return False

        def kill_one_rank() -> None:
            # once a gang trains: SIGKILL the oldest trial process, once
            deadline = time.monotonic() + C_TIMEOUT_S
            while not done.is_set() and time.monotonic() < deadline:
                pids = _run_trial_pids()
                if len(pids) >= 2 and training():
                    try:
                        os.kill(pids[0], signal.SIGKILL)
                    except OSError:
                        continue
                    killed.update(pid=pids[0], at_s=time.monotonic() - t0)
                    return
                time.sleep(0.2)

        killer = threading.Thread(target=kill_one_rank, daemon=True)
        t0 = time.monotonic()
        killer.start()
        try:
            summary = exp.run()
        finally:
            done.set()
        cluster_s = time.monotonic() - t0
        log(f"C cluster search: {cluster_s:.1f} s, " + json.dumps(summary, default=str))
        assert summary["status"] == "completed", summary
        assert "pid" in killed, "the rank killer found no gang to kill"
        got = {r: x.hparams for r, x in exp.results.items()}
        assert got == want, (got, want)
        mexp = session.get(f"/api/v1/experiments/{summary['master_experiment_id']}").json()
        restarts = {t["id"]: t["restarts"] for t in mexp["trials"]}
        assert sum(restarts.values()) >= 1, restarts
        rendezvous = {}
        for t in mexp["trials"]:
            recs = session.get(f"/api/v1/trials/{t['id']}/logs", params={"limit": 10000}).json()
            lines = [r if isinstance(r, str) else str(r.get("line", r)) for r in recs]
            rendezvous[t["id"]] = sorted({ln.split("]", 1)[0] + "]" for ln in lines
                                          if "rendezvous: joined" in ln and "[rank=" in ln})
            assert rendezvous[t["id"]] == ["[rank=0]", "[rank=1]"], (t["id"], rendezvous)
        res = dict(build_s=build_s, build_waited_s=waited, reference_s=ref_s,
                   cluster_search_s=cluster_s, killed=killed, restarts=restarts,
                   trials={r: dict(hparams=x.hparams, steps=x.steps_completed,
                                   stopped_early=x.stopped_early)
                           for r, x in exp.results.items()},
                   rendezvous=rendezvous)
        log("C " + json.dumps(res, default=str))
        return res
    finally:
        if cluster is not None:
            cluster.stop()
        if build.poll() is None:
            os.killpg(build.pid, signal.SIGKILL)
            build.wait()


def _t_hparams(over: dict) -> dict:
    """pipeline.yaml's hyperparameters at P_CUTS, with a run's changes."""
    hp = _pipe_hparams()
    hp.update(over)
    return hp


def _rank_pipe_axes(core_ctx, inp: dict, seed: int) -> dict:
    """One rank of T: each of ``inp["runs"]`` in turn, T_STEPS steps through
    train.init -> Trainer(LMTrial).fit (launches, quantized products, step
    time, peak memory, the plan and comm model), on several slices the ring
    bytes it issues over 2 more steps, then its idle share."""
    import gc

    import torch

    from determined_tpu_torch import train
    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.data import to_device
    from determined_tpu_torch.train import _quant

    out = {}
    for name, mesh, over, opt, _ref in inp["runs"]:
        cfg = ExperimentConfig.parse({"hyperparameters": _t_hparams(over),
                                      "optimizations": opt, "resources": {"mesh": mesh}})
        ctx = train.init(exp_config=cfg, seed=seed, core_context=core_ctx)
        _quant.reset_launches()
        res = _fit(ctx, T_STEPS, keep=True)
        res["quant"] = dict(_quant.launches)
        trainer = res.pop("trainer")
        model = trainer.model
        first = model.chunk_layers[min(model.chunk_layers)][0]
        sampler = trainer.train_loader.sampler
        res.update(
            layers=len(model.blocks), bubble_fraction=trainer._bubble_model.fraction,
            coords={a: ctx.mesh.coordinate(a) for a in ("dcn", "pipe", "data", "tensor")},
            batch_shard=[sampler.shard_rank, sampler.num_shards],
            # the heads this rank's flash kernels see
            heads=model.blocks[first].attn.wq.weight.shape[0] // model.cfg.head_dim,
            units=len(trainer._plan.units))
        plan = trainer._overlap_plan
        if plan is not None:
            res["plan"] = dict(enabled=plan.enabled, buckets=len(plan.buckets),
                               fingerprint=plan.fingerprint(),
                               dcn_bytes=plan.comm.dcn_bytes_per_step)
        if trainer._comm_model is not None:
            res["comm_model"] = dict(ici=trainer._comm_model.bytes_per_step,
                                     dcn=trainer._comm_model.dcn_bytes_per_step)
        if mesh.get("num_slices", 1) > 1:
            it = iter(trainer.train_loader)
            batches = [to_device(next(it), trainer.device) for _ in range(2)]
            torch.cuda.synchronize()
            with _IssuedCollectives() as issued:
                for b in batches:
                    trainer._train_step(b)
                torch.cuda.synchronize()
            res["issued"] = _hop_bytes(_ring_bytes(issued.rows, 2),
                                       ctx.mesh.size // mesh["num_slices"])
        # the host's step on this rank, untraced (the reports are the chief's)
        it = iter(trainer.train_loader)
        batches = [to_device(next(it), trainer.device) for _ in range(2)]
        torch.cuda.synchronize()
        t0 = time.monotonic()
        for b in batches:
            trainer._train_step(b)
        torch.cuda.synchronize()
        res["host_step_ms"] = (time.monotonic() - t0) / len(batches) * 1e3
        res.update(_idle_share(trainer, 2))
        # progress in the rank's log: a failed gang prints its tail
        print(f"T {name}: " + json.dumps(dict(losses=res["losses"], step_ms=res["step_ms"])),
              flush=True)
        out[name] = res
        del trainer, model, ctx
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _t_references(args, keys) -> dict:
    """T's one-GPU references ``keys``: gradient aggregation over the same
    microbatches (P's R), at bf16, int8 and fp8, and at T5's batch of 8."""
    import torch

    from determined_tpu_torch import train
    from determined_tpu_torch.config import ExperimentConfig

    hp = _pipe_hparams()
    m = hp["pipe_microbatches"]
    plain = {k: v for k, v in hp.items()
             if k not in ("pipe_microbatches", "pipeline_schedule", "virtual_stages")}
    refs = {}
    for key, gbs, opt in (("bf16", hp["global_batch_size"], {}),
                          ("int8", hp["global_batch_size"], {"quantized_matmul": "int8"}),
                          ("fp8", hp["global_batch_size"], {"quantized_matmul": "fp8"}),
                          ("b8", 8, {})):
        if key not in keys:
            continue
        t0 = time.monotonic()
        exp = ExperimentConfig.parse({"optimizations": dict(opt, aggregation_frequency=m)})
        ref = _fit(train.init(hparams=dict(plain, global_batch_size=gbs // m),
                              seed=args.seed + 1, exp_config=exp), T_STEPS)
        torch.cuda.empty_cache()
        refs[key] = ref
        log(f"T R {key} (one GPU, aggregation {m} of {gbs // m}): " + json.dumps(dict(
            losses=ref["losses"], step_ms=ref["step_ms"],
            peak_memory_gib=ref["peak_memory_gib"], seconds=time.monotonic() - t0)))
    return refs


def _pipe_axes_part(args, root: str, names=None) -> dict:
    """T (the docstring at the top), or its runs ``names``; each run's
    chief losses by name."""
    from chip_smoke import KNOBS_QUANT_LOSS_REL

    assert args.gpus == 4, "T runs meshes of four cards"
    t_part = time.monotonic()
    runs = [run for run in T_RUNS if names is None or run[0] in names]
    for key, old, value, why in P_CUTS:
        log(f"T cut: {key} {json.dumps(old)} -> {json.dumps(value)} ({why})")
    refs = _t_references(args, {run[4] for run in runs})
    t0 = time.monotonic()
    outs = _launch_gang(args.gpus, os.path.join(root, "t"), dict(part="T", runs=runs),
                        args.seed + 1, T_GANG_TIMEOUT_S)
    log(f"T gang: {time.monotonic() - t0:.1f} s")
    m, heads = _pipe_hparams()["pipe_microbatches"], _pipe_hparams()["n_heads"]
    losses = {}
    for name, mesh, over, opt, ref_key in runs:
        ranks = [o[name] for o in outs]
        chief = ranks[0]
        ref = refs[ref_key]["losses"]
        losses[name] = chief["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(chief["losses"], ref))
        mode = opt.get("quantized_matmul", "none")
        if mode == "none":
            np.testing.assert_allclose(chief["losses"], ref, err_msg=name, **P_LOSS_TOL)
        else:
            assert rel < KNOBS_QUANT_LOSS_REL, (name, chief["losses"], ref)
        for rank, r in enumerate(ranks):
            n = r["layers"]
            want = dict(flash_fwd=2 * n * m * T_STEPS, flash_bwd_dq=n * m * T_STEPS,
                        flash_bwd_dkv=n * m * T_STEPS, fused_adamw=r["local_leaves"] * T_STEPS)
            assert r["launches"] == want, (name, rank, r["launches"], want)
            # q, k, v, o, gate, up and down a layer, twice under remat; the
            # fused cross-entropy head stays bf16
            qwant = {k: (14 * n * m * T_STEPS if k == mode else 0) for k in ("int8", "fp8")}
            assert r["quant"] == qwant, (name, rank, r["quant"], qwant)
            assert r["heads"] == heads // mesh.get("tensor", 1), (name, rank, r["heads"])
        dcn_ratio = None
        if "num_slices" in mesh:
            for rank, r in enumerate(ranks):
                model, issued = r["comm_model"], r["issued"]
                for hop in ("ici", "dcn"):
                    # the model counts FSDP2's collectives and the stage's
                    # whole-leaf all-reduce; the rest is the norm's scalars
                    assert model[hop] <= issued[hop] <= model[hop] + 4096, (name, rank, hop,
                                                                             model, issued)
            # the cross-slice bytes each rank issued against its stage's
            # plan fragment, within part O's bounds
            dcn_ratio = [r["issued"]["dcn"] / r["plan"]["dcn_bytes"] for r in ranks]
            assert all(0.98 <= x <= 1.05 for x in dcn_ratio), (name, dcn_ratio)
        if name == "T5":
            shards = [r["batch_shard"] for r in ranks]
            assert all(b == [0, 1] for b in shards), shards
        log("T " + json.dumps(dict(
            name=name, mesh=mesh, hparams=over, optimizations=opt, losses=chief["losses"],
            ref=ref_key, ref_losses=ref, max_loss_rel=rel,
            step_ms=chief["step_ms"], host_step_ms=[r["host_step_ms"] for r in ranks],
            peak_memory_gib=[r["peak_memory_gib"] for r in ranks],
            idle_share=[r["idle_share"] for r in ranks],
            nccl_share=[r["nccl_share"] for r in ranks],
            traced_step_ms=[r["traced_step_ms"] for r in ranks],
            bubble_fraction=chief["bubble_fraction"], heads=[r["heads"] for r in ranks],
            layers=[r["layers"] for r in ranks], local_leaves=[r["local_leaves"] for r in ranks],
            units=[r["units"] for r in ranks], batch_shard=[r["batch_shard"] for r in ranks],
            coords=[r["coords"] for r in ranks], launches=[r["launches"] for r in ranks],
            quant=chief["quant"], plan=chief.get("plan"),
            plan_dcn_bytes=[r.get("plan", {}).get("dcn_bytes") for r in ranks],
            dcn_ratio=dcn_ratio, comm_model=[r.get("comm_model") for r in ranks],
            issued=[r.get("issued") for r in ranks])))
    # the overlapped sync and the hierarchical one compute the step the
    # flat sync computes
    for a, b in (("T3-on", "T3-off"), ("T2-hier", "T2-flat")):
        if a not in losses or b not in losses:
            continue
        rel = max(abs(x - y) / abs(y) for x, y in zip(losses[a], losses[b]))
        assert rel <= O_LOSS_REL, (a, b, losses[a], losses[b])
        log(f"T {a} vs {b}: max loss rel {rel}")
    log(f"T: {time.monotonic() - t_part:.1f} s")
    return losses


def _local_ranks_trial():
    """L's trial (``LocalRanksLMTrial``): LMTrial whose ranks append their
    pids, and whose chief appends each run's start and its checkpoints, as
    JSON lines under ``$DTT_SMOKE_LOCAL_RANKS_DIR``; in the first run every
    rank holds after the step-2 checkpoint (up to L_HOLD_S) so that the
    part kills a local rank while the trial is alive."""
    if "LocalRanksLMTrial" in _ELASTIC:
        return _ELASTIC["LocalRanksLMTrial"]
    from determined_tpu_torch.models import LMTrial
    from determined_tpu_torch.train import Callback

    def event(**rec) -> None:
        rec["t"] = time.time()
        with open(os.path.join(os.environ[L_DIR_ENV], "events.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

    class LocalRanksLMTrial(LMTrial):
        def build_callbacks(self):
            dist = self.context.core.distributed
            restored = os.environ.get("DTPU_LATEST_CHECKPOINT") or None

            class Record(Callback):
                def on_training_start(self, trainer) -> None:
                    event(event="pid", rank=dist.rank, local_rank=dist.local_rank,
                          pid=os.getpid(), restored=restored)
                    if dist.is_chief:
                        event(event="start", step=trainer.steps_completed, world=dist.size,
                              local_size=dist.local_size, restored=restored)

                def on_checkpoint_write_end(self, storage_id: str) -> None:
                    if dist.is_chief:
                        event(event="checkpoint", storage_id=storage_id, restored=restored)
                    if restored is None:
                        time.sleep(L_HOLD_S)

            return {"record": Record()}

    LocalRanksLMTrial.__module__ = __name__
    LocalRanksLMTrial.__qualname__ = LocalRanksLMTrial.__name__
    _ELASTIC["LocalRanksLMTrial"] = LocalRanksLMTrial
    return LocalRanksLMTrial


def _local_ranks_part(args, root: str, build, t1_losses) -> dict:
    """L (the docstring at the top)."""
    import signal

    from chip_smoke import PIPE_CONST, _apply_cuts, _read_events
    from determined_tpu_torch import devcluster
    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.experiment import ClusterExperiment

    assert args.gpus == 4, "L runs one agent of four GPUs"
    for key, old, value, why in L_CUTS:
        log(f"L cut: {key} {json.dumps(old)} -> {json.dumps(value)} ({why})")
    where, t_build = build
    if t_build.returncode is None:  # R, when it ran first, waited for it
        t0 = time.monotonic()
        out, _ = t_build.communicate(timeout=L_TIMEOUT_S)
        assert t_build.returncode == 0, f"native build failed:\n{out[-4000:]}"
        log(f"L: native build {float(out.strip().splitlines()[-1]):.1f} s, waited "
            f"{time.monotonic() - t0:.1f} s for it")
    events_dir = tempfile.mkdtemp(prefix="l-events-", dir=root)
    ckpt = os.path.join(root, "l-ckpt")
    raw = dict(PIPE_CONST, hyperparameters=_pipe_hparams())
    raw = _apply_cuts(raw, L_CUTS, {"<temp dir>": ckpt, "<--seed>": args.seed,
                                    "<events dir>": events_dir})
    cluster = devcluster.LocalCluster(
        os.path.join(root, "l-state"), ckpt, agents=1,
        gpus=devcluster.gpu_blocks(args.gpus, 1, 4), cwd=REPO, where=where)
    result: dict = {}
    try:
        cluster.start()
        session = cluster.session()
        log(f"L: master {cluster.url}, one agent of 4 slots (CUDA_VISIBLE_DEVICES "
            f"{cluster.gpus[0]})")
        exp = ClusterExperiment(ExperimentConfig.parse(raw), session=session,
                                checkpoint_dir=os.path.join(root, "l-driver"), poll_interval=0.5)
        summary: dict = {}
        import threading

        driver = threading.Thread(target=lambda: summary.update(exp.run()), daemon=True)
        t_submit = time.monotonic()
        driver.start()
        path = os.path.join(events_dir, "events.jsonl")

        def wait(what, pred):
            deadline = time.monotonic() + L_TIMEOUT_S
            while time.monotonic() < deadline:
                got = [e for e in _read_events(path) if pred(e)]
                if got:
                    return got
                assert driver.is_alive(), f"the experiment ended before {what}: {summary}"
                time.sleep(0.2)
            raise AssertionError(f"L: no {what} in {L_TIMEOUT_S:.0f} s")

        saved = wait("the step-2 checkpoint",
                     lambda e: e["event"] == "checkpoint" and e["restored"] is None)[0]
        pids = wait("four local ranks", lambda e: e["event"] == "pid"
                    and e["restored"] is None)
        while len(pids) < 4:
            time.sleep(0.2)
            pids = [e for e in _read_events(path) if e["event"] == "pid"
                    and e["restored"] is None]
        victim = next(e for e in pids if e["local_rank"] == 1)
        os.kill(victim["pid"], signal.SIGKILL)
        t_kill = time.monotonic()
        log(f"L: local rank 1 (rank {victim['rank']}, pid {victim['pid']}) SIGKILLed "
            f"{t_kill - t_submit:.1f} s after the submit, held after checkpoint "
            f"{saved['storage_id']}")
        resumed = wait("the resumed run", lambda e: e["event"] == "start"
                       and e["restored"] is not None)[0]
        t_resumed = time.monotonic()
        driver.join(timeout=L_TIMEOUT_S)
        assert not driver.is_alive(), "L: the experiment did not end"
        assert summary.get("status") == "completed", summary
        starts = [e for e in _read_events(path) if e["event"] == "start"]
        assert [e["world"] for e in starts] == [4, 4] and starts[0]["local_size"] == 4, starts
        assert resumed["step"] == 2 and resumed["restored"] == saved["storage_id"], resumed
        mexp = session.get(f"/api/v1/experiments/{summary['master_experiment_id']}").json()
        (trial,) = mexp["trials"]
        assert trial["restarts"] >= 1, trial
        rows = session.get(f"/api/v1/trials/{trial['id']}/metrics",
                           params={"group": "training"}).json()
        by_step = {int(r["steps_completed"]): r["metrics"]["loss"] for r in rows}
        got = [by_step[s] for s in range(1, T_STEPS + 1)]
        np.testing.assert_allclose(got, t1_losses, **P_LOSS_TOL)
        result = dict(trial_id=trial["id"], restarts=trial["restarts"], losses=got,
                      t1_losses=t1_losses, bitwise=got == t1_losses,
                      max_loss_rel=max(abs(a - b) / abs(b) for a, b in zip(got, t1_losses)),
                      checkpoint=saved["storage_id"], kill_to_resumed_start_s=t_resumed - t_kill,
                      submit_to_end_s=time.monotonic() - t_submit)
        log("L " + json.dumps(result))
    except BaseException:
        # what the trial's processes said, before the cluster's logs go
        try:
            recs = cluster.session().get("/api/v1/trials/1/logs",
                                         params={"limit": 10000}).json()
            lines = [r if isinstance(r, str) else str(r.get("line", r)) for r in recs]
            log("--- L trial 1's log (tail):\n" + "\n".join(lines[-150:]))
        except Exception as e:  # noqa: BLE001 - the failure below is the report
            log(f"--- L: no trial log from the master ({e!r})")
        for name in ("agent-0", "master"):
            path = os.path.join(cluster.log_dir, f"{name}.log")
            if os.path.exists(path):
                with open(path, errors="replace") as f:
                    log(f"--- L {name}.log (tail):\n" + f.read()[-6000:])
        raise
    finally:
        cluster.stop()
    return result


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--gpus", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--rank-of", nargs=2, metavar=("WORKDIR", "MESH"))
    parser.add_argument("--parts", default=",".join(PARTS))
    args = parser.parse_args()
    parts = set(args.parts.split(","))
    unknown = parts - set(PARTS) - set(X_PARTS)
    if unknown:
        parser.error(f"unknown parts {sorted(unknown)}; choose from {PARTS + X_PARTS}")

    import torch

    if args.rank_of:
        workdir, mesh = args.rank_of[0], json.loads(args.rank_of[1])
        result = _rank_gang(workdir, mesh, args.seed)
        with open(os.path.join(workdir, f"out{os.environ['RANK']}.pkl"), "wb") as f:
            pickle.dump(result, f)
        return 0

    if not torch.cuda.is_available() or torch.cuda.device_count() < args.gpus:
        print(f"mesh_smoke: needs {args.gpus} CUDA devices", file=sys.stderr)
        return 1
    import determined_tpu_torch  # noqa: F401  (fails outside a checkout)
    from chip_smoke import MOE_CUTS, card_line

    t_start = time.monotonic()
    card = card_line()
    log(f"card: {card} x {torch.cuda.device_count()}")
    for key, old, value, why in MOE_CUTS:
        log(f"cut: {key} {json.dumps(old)} -> {json.dumps(value)} ({why})")
    root = tempfile.mkdtemp(prefix="dtt-mesh-smoke-")
    build = None
    if "R" in parts or "L" in parts:
        # the native control plane compiles while the earlier parts run
        where = tempfile.mkdtemp(prefix="native-", dir=root)
        build = (where, subprocess.Popen(
            [sys.executable, "-c", "import sys; from determined_tpu_torch import devcluster; "
             "print(devcluster.build_binaries(sys.argv[1], force=True))", where],
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True))
    try:
        if "G" in parts:
            _mesh_part(args, root)
        if "E" in parts:
            outs = _launch_gang(args.gpus, os.path.join(root, "e"), dict(part="E"), args.seed)
            log("E " + json.dumps({f"rank{r}": o["max_abs_err"] for r, o in enumerate(outs)}))
        if "S" in parts:
            _seq_part(args, root)
        xs = [x for x in X_PARTS if "X" in parts or x in parts]
        if xs:
            _x_part(args, root, xs)
        if "C" in parts:
            t0 = time.monotonic()
            _cluster_part(args, root)
            log(f"C: {time.monotonic() - t0:.1f} s")
        if "P" in parts:
            _pipe_part(args, root)
        if "O" in parts:
            _overlap_part(args, root)
        if "R" in parts:
            t0 = time.monotonic()
            _elastic_part(args, root, build)
            log(f"R: {time.monotonic() - t0:.1f} s")
        if "M" in parts:
            _moe_part(args, root)
        t1 = None
        if "T" in parts:
            t1 = _pipe_axes_part(args, root)["T1-gpipe"]
        if "L" in parts:
            if t1 is None:
                # L holds its losses against T1 gpipe's: without T, T1 alone
                t1 = _pipe_axes_part(args, root, ("T1-gpipe",))["T1-gpipe"]
            t0 = time.monotonic()
            _local_ranks_part(args, root, build, t1)
            log(f"L: {time.monotonic() - t0:.1f} s")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(f"mesh_smoke: {time.monotonic() - t_start:.1f} s")
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


def _mesh_part(args, root: str) -> None:
    """R and G (the docstring at the top)."""
    import torch

    from determined_tpu_torch import train

    ctx = train.init(hparams=_hparams(), seed=args.seed)
    ref = _fit(ctx, STEPS)
    del ctx
    torch.cuda.empty_cache()
    log("R: " + json.dumps(ref))
    for i, mesh in enumerate(MESHES):
        outs = _launch_gang(args.gpus, os.path.join(root, f"g{i}"), mesh, args.seed)
        chief = outs[0]
        np.testing.assert_allclose(chief["losses"], ref["losses"], err_msg=str(mesh),
                                   **MESH_LOSS_TOL)
        np.testing.assert_allclose(chief["aux"], ref["aux"], err_msg=str(mesh),
                                   **MESH_LOSS_TOL)
        for rank, o in enumerate(outs):
            layers, leaves = o["layers"], o["local_leaves"]
            want = dict(flash_fwd=layers * STEPS, flash_bwd_dq=layers * STEPS,
                        flash_bwd_dkv=layers * STEPS, fused_adamw=leaves * STEPS)
            assert o["launches"] == want, (mesh, rank, o["launches"], want)
        log("G " + json.dumps(dict(
            mesh=mesh, losses=chief["losses"], ref_losses=ref["losses"],
            max_loss_rel=max(abs(a - b) / abs(b) for a, b in
                             zip(chief["losses"], ref["losses"])),
            step_ms=[o["step_ms"] for o in outs],
            peak_memory_gib=[o["peak_memory_gib"] for o in outs],
            local_params=[o["params"] for o in outs],
            coords=[o["batch_shard"] for o in outs], launches=chief["launches"])))


if __name__ == "__main__":
    raise SystemExit(main())
