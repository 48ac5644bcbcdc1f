#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (determined_tpu_torch) on one GPU.

    python3 chip_smoke.py [--seed N]
        [--phases kernel,serve,parity,train,train_parity,experiment,search,observe,
                  knobs,serve_ckpt,models,hf,moe,seq,gang,cluster,pipe,fleet,overlap]

Phases, in order; any failure raises and the script exits non-zero:

1. device (always): require CUDA; print the card's name and power limit.
2. kernel: build every hand-written kernel from csrc/ with nvcc (one process
   per source, in parallel), print each one's ptxas registers, spills and
   wgmma warnings, and hold each against its plain PyTorch version on the
   card: flash_fwd (bf16: the launch's own tile and both the 64- and
   128-row tiles) and flash_bwd (dq, dk/dv) at the training and serving
   shapes and the ragged, GQA, head-dim-64, long-walk and f32 corners,
   fused_adamw on flagship leaves and ragged tails.  Fails if ptxas spilled
   or serialised the wgmmas (C75xx) of a flash_bwd_dq_wgmma instance.  Each
   kernel is timed at its main-path shape (the bf16 forward at each tile)
   beside its plain version, its bound (with the share of it reached and
   the achieved TFLOP/s) and a library yardstick
   (``scaled_dot_product_attention`` and its backward,
   ``torch.optim.AdamW(fused=True)``), which the port never calls.
3. serve: the flagship LM (examples/transformer_lm/const.yaml: d2048, L8,
   H16, V32768, bf16 compute, f32 params; random weights from --seed) behind
   a ServeWorker on localhost; greedy POST /v1/generate requests, four of
   them sharing a 512-token prefix.  The launch counters are set to 0 just
   before the requests and read just after.
4. parity: serving-path logits (prefill and three decode steps) against the
   full TransformerLM forward, in bf16 and in an f32 copy of the model.
5. train: the bench.py workload (the flagship at seq 1024, global batch 8,
   bf16, flash attention, fused cross-entropy, fused AdamW with a bf16 first
   moment) through init -> Trainer(LMTrial).fit for 25 steps with a
   validation pass; step time, tokens/s and MFU, the losses, the launch
   counts (set to 0 just before fit, read just after) and a profile of
   three more steps, its device time grouped by the package's op table
   (determined_tpu_torch/utils/kineto.py).
6. train_parity: a 2-layer f32 LM trains 3 steps on the card through the
   kernels and on the CPU through the plain versions, from the same weights
   and batches; losses, weight updates and moments are compared.
7. experiment: the flagship's own experiment file
   (examples/transformer_lm/const.yaml, mirrored in EXPERIMENT_CONST; f32
   first moment as the file has it) through LocalExperiment(cfg, LMTrial),
   cut in length and in depth to 2 layers at the full width (EXPERIMENT_CUTS,
   each printed), its weights and data from --seed.  Checkpoints (3.22 GB)
   go to a fresh temporary directory outside the repo (its free space
   printed first), at most three at once, deleted at the end.
   C. the uninterrupted reference: checkpoint_policy none; its final state
      is kept on the host and its trainer freed.
   A. preempted run: the train.step hook calls request_preemption() before
      step 18; the run ends "preempted" with a best checkpoint at step 12
      (asynchronous, drained by the step-18 save) and a preemption
      checkpoint at step 18, both manifest-verified.
   B. resume(): steps 18 -> 24 from the step-18 checkpoint, whose manifest
      is checked once (by the experiment; the restore reuses the verdict);
      the launch counters are set to 0 just before and read just after, and
      must show 6 steps x the model's leaves fused_adamw (6 x 21 at 2
      layers) and 6 x its layers of each flash backward kernel (6 x 2).
   D. crash and restart: TrialSupervisor with the train.step hook raising at
      step 15 and its own changes (CRASH_CUTS, printed: one restart, no
      backoff, synchronous saves); the second attempt resumes from the
      step-12 checkpoint and ends at step 24.
   B's and D's final params, moments, step and last validation loss are
   held against C's (the largest difference printed, and whether it is
   bitwise) with the train_parity tolerance.  Printed: each save's bytes,
   seconds and GB/s (sync; async dispatch, write with its copy to the host,
   stall, finalize with its md5), the resume (from resume() to the first
   step, the manifest check, the load), the host-clock step during the
   writer's copy, during its torch.save and with no write in flight, and
   each part's device memory at its start and its peak.
8. search: three searches through LocalExperiment, each from its file's
   dict with its changes (SEARCH_*_CUTS, each printed); checkpoints under a
   fresh temporary directory (its free space checked first), deleted at the
   end.  The launch counters are set to 0 just before each search and read
   just after, and must equal the sum over its trials' steps and validation
   passes.  Each trial's steps, seconds, synchronous (stop) save and clone
   seconds and device memory at its start and peak are printed.
   S1. ASHA over the flagship's width at 2 layers (const.yaml's model cut
       in depth; lr log-uniform in [1e-5, 1e-3]; 4 trials, rungs at 16 and
       32 batches):
       a searcher stop reaches a trial as a preemption, whose synchronous
       save is its checkpoint (deleted when the trial ends).  At least one
       trial is stopped below 32 steps; the trial set (ids, hparams, steps,
       stopped) equals a fresh port ASHASearch replaying the run's searcher
       events in order, and the k-th trial's hparams are the searcher's k-th
       draw at --seed, made without a device; no trial starts with device
       memory of an earlier one.
   S2. PBT over the flagship's width at 2 layers (2 members, 2 generations
       of 8 batches, best checkpoints): at least one clone is materialized;
       each restored child's parameters, moments and step equal its
       parent's checkpoint bit for bit; a child ends at 16 steps; every
       trial's lr metric follows its own lr (a perturbed child's is not its
       parent's).
   S3. examples/mnist/adaptive.yaml (MNIST_ADAPTIVE) through MnistTrial:
       adaptive ASHA over 16 trials completes with at least one early stop,
       its trial set equals the replay through a fresh port
       make_adaptive_asha, every step launches fused_adamw on the MLP's 4
       leaves, and the best validation accuracy is above 0.5.  After the
       counts are read, fused_adamw is held against its plain version with
       each optimizer the trials built (no decay, no clip, f32 first moment)
       at every leaf shape they trained and at MNIST_ADAMW_SHAPES.
9. observe: const.yaml's flagship (OBSERVE_CUTS, each printed: 12 steps,
   one validation pass at the end, no checkpoint) through LocalExperiment
   with observability.trace_export and a torch.profiler window over its
   first 3 steps, opened through the trial's core context.  The launch
   counters are set to 0 just before the run and read just after.  Checks:
   traces/events.jsonl, trace.json and goodput.json exist; the ledger has
   one trial with 12 steps and 12 x 8 x 1024 tokens exactly, no dropped
   events, and step, setup and validate rows; the window's op table
   (utils/kineto.py) counts exactly 8 launches a step of each flash kernel
   and 75 of fused_adamw; the profile metrics row holds an op table and
   category totals; the system sampler (OBSERVE_SAMPLE_CUT: every 0.5 s)
   reports at least one row, each with the host memory keys and the card's
   device0_bytes_in_use/_bytes_limit/_hbm_util_pct, the limit equal to
   mem_get_info's and the bytes in use within the run's peak, and a sample
   taken after the run agrees with memory_allocated(); `experiment profile` (whose --json ledger equals
   goodput.json) and `experiment status` (completed) exit 0 as
   subprocesses.  Printed: the ledger's shares, seconds by category,
   tokens/s and MFU (beside phase 5's), the traced steps' host time beside
   the untraced ones, both traces' sizes and the phase's seconds.
10. knobs: the single-device step knobs on phase 5's workload at full
   width and depth.
   a. aggregation_frequency 4 (4 x 8 x 1024 tokens a step) through fit for
      8 steps: the launch counters (0 just before fit, read just after)
      must show 8 x 4 x 8 of each flash kernel and 75 x 8 fused_adamw, one
      update a step; step time, tokens/s, MFU and peak memory beside phase
      5's.  Then one agg-4 update from fixed weights (KNOBS_AGG_CMP_CUTS,
      printed) against one global-batch-32 update over the same 32 samples:
      loss, moments and update within KNOBS_AGG_TOL, and each step's peak
      memory.
   b. quantized_matmul none, int8 and fp8, 25 steps each from the same
      weights and batches: each quantized loss within 2% of the bf16 one at
      every step; 7 x 8 quantized products a step (the fused
      cross-entropy head stays bf16); step time, device time a step by
      group, and the int8 and fp8 gemm rows of the op table
      (utils/kineto.py), which must be there.  Each quantized linear at the
      flagship's shapes (q/k/v/o, gate/up, down) on the card against its
      plain version (QUANT_LINEAR_TOL), timed (with its quantize passes and
      its bare gemm) beside the bf16 F.linear; and the q/k/v/o one at an f32
      compute dtype, where fp8 takes the other _scaled_mm call
      (QUANT_LINEAR_F32_TOL).
   c. compilation_cache_dir: a first subprocess builds every kernel into an
      empty directory (its MISS line), a second loads them from there with
      nvcc made unavailable (its HIT line); each launches the flash forward
      from the cached library; both subprocesses' seconds are printed.
11. serve_ckpt: const.yaml's flagship, cut in depth to phase 7's 2 layers
   (SERVE_CKPT_CUTS, printed), trains 4 steps and saves one synchronous
   checkpoint (3.22 GB, under a fresh temporary directory whose free space
   is checked first, deleted at the end).  A ServeWorker over
   ServeEngine.from_checkpoint (manifest md5 check, load) answers 6 greedy
   requests whose tokens must equal those of an engine over the trainer's
   in-memory model; run_batch_inference then scores 8 batches of 8
   synthetic sequences with the served model, preempted after 4 and
   resumed from its progress checkpoint: every batch exactly once.  The
   flash forward's launches (cold prefills and scored batches) are counted.
   Printed: the save's and the load's seconds (verify, load), TTFT, the
   scored batches a second.
12. models: the CIFAR ResNet and DDPM diffusion trials, each from its
   example's const.yaml (CIFAR_CONST, DIFFUSION_CONST, dicts a CPU test
   holds to the files) through LocalExperiment with the port's trial, at
   full size; the cuts (MODELS_CUTS, printed) are the checkpoint directory
   (a fresh temporary one, deleted at the end) and the seed.  The launch
   counters are set to 0 just before each run and read just after.
   C. cifar10: ResNet-20 (widths 16/32/64, 3 blocks a stage, GroupNorm,
      bf16 compute), SGD with momentum, batch 128 over 8,192 samples, 4
      epochs = 256 steps, a validation at each epoch: finite losses, the
      last validation accuracy above 0.5, no kernel launched (convolutions,
      GroupNorm and SGD are library calls, as in the JAX package).
   D. diffusion: the DDPM UNet at base_channels 32 (82 leaves), fused
      AdamW, batch 64, 500 steps, a validation every 100: exactly 82
      fused_adamw launches a step and no flash launch, the last validation
      loss below 1.0; then ddpm_sample over all 1,000 timesteps for 16
      images from the trained weights: finite, [16, 28, 28, 1].
   K. fused_adamw against its plain version at every leaf shape D trained,
      with D's optimizer (lr 2e-4, decay 1e-4, no clip, f32 first moment),
      and timed at the largest leaf beside its bound, its plain version and
      torch's fused AdamW.
   P. each trial trains 3 f32 steps on the card and on the CPU from the
      same weights, batches and step seeds (MODELS_PARITY_CUTS, printed;
      the diffusion steps draw t and eps on the host), TF32 off: losses,
      updates and optimizer state held as phase 6 holds them.
   Printed: each run's step time, images/s, validation metrics, peak device
   memory and seconds; the sampler's seconds and ms a denoising step.
13. hf: the HuggingFace fine-tune trials on the port's own GPT-2 and BERT
   modules (models/hf_gpt2.py, models/hf_bert.py), f32 as the JAX trials
   compute; torch.backends.cuda.matmul.allow_tf32 is left at PyTorch's
   default and printed.  G and B each run their example's const.yaml
   (HF_GPT2_CONST, HF_BERT_CONST, dicts a CPU test holds to the files)
   through LocalExperiment at full size; the cuts (HF_CUTS, printed) are
   the checkpoint directory (a fresh temporary one, deleted at the end) and
   the seed.  The launch counters are set to 0 just before each run and
   read just after.
   G. examples/hf_gpt2/const.yaml: GPT-2 base (12 layers, width 768, 12
      heads, vocab 50257, 124M parameters in 148 leaves, the head tied to
      wte), batch 32 x 128, plain AdamW, cut to 200 steps (HF_GPT2_CUTS,
      printed), a validation every 100:
      the validation loss falls at every validation and ends below
      ln(50257), no kernel launched; 0.8 ln(50257) is printed beside it.
      Then GPT2FinetuneTrial at tests/test_transformer.py's GPT-2 learning
      test (HF_GPT2_LEARN_HP, 40 steps) on the card: the validation loss
      below that test's bar, 0.8 ln(128).
   B. examples/hf_bert/const.yaml: BERT 4 x 256, vocab 8192, batch 64 x 128,
      3 epochs of 16,384 samples, a validation each epoch: the last
      validation accuracy above 0.6, no kernel launched.
   N. scripts/bench_bert.py's north-star step (BERT-base, seq 128, batch
      128, its hparams), 5 warm steps and 30 timed, once with plain AdamW
      and once with fused from the same weights and batches (the first
      step's loss equal bitwise): the fused run launches fused_adamw
      exactly 35 x 201 leaves times, the plain run never.  Printed:
      samples/s and TFLOP/s under bench_bert.py's count (6 N + 12 L seq d
      a token), its share of the card's bf16 peak (PEAK_FLOPS_BY_KIND, the
      script's convention) and of the f32 peak, both of f32 compute; device
      time by op-table group; peak memory.
   K. fused_adamw against its plain version at the GPT-2 wte leaf
      [50257, 768] and BERT-base's largest encoder leaf [3072, 768] with
      the HF trials' optimizer (f32 first moment, no clip, decay 0.01, a
      schedule value), each timed beside its bound, its plain version and
      torch's fused AdamW.
   P. a 2-layer GPT-2 and a 2-layer BERT at width 64, and GPT-2 base at
      full width and depth (12 x 768, vocab 50257) at 2 sequences a batch
      (HF_PARITY_CUTS and every dropout probability 0 in a smoke-local
      config, printed) train 3 f32 steps on the card and on the CPU from
      the same weights and batches, with plain and with fused AdamW, TF32
      off: losses, updates and moments held as phase 6 holds them; the
      attention key's bias, whose true gradient is 0, has its moments held
      within ZERO_GRAD_MU (mu) and its square (nu) on both sides and its
      weights by the elementwise bound 2 x summed lr.
   Printed: G's and B's step time, tokens/s, device time a step and busy
   share (a 3-step torch.profiler window), validation metrics, peak
   memory and seconds; each part's seconds and the phase's.
14. moe: examples/transformer_lm/moe_ep.yaml (MOE_EP_CONST, a dict a CPU
   test holds to the file): top-2 routed experts (8, every second block) at
   the file's full width (d 2048, 16 heads of 128, vocab 32768, d_ff 8192,
   seq 2048, bf16, flash), cut as MOE_CUTS prints.
   M. 25 steps through train.init -> Trainer(LMTrial).fit at one rank's
      share of the batch (8 sequences), 4 layers, and a validation pass:
      step time, tokens/s and MFU (moe_step_flops: the dense dispatch and
      combine and every capacity slot counted), moe_aux_loss (finite) and
      the loss falling from the first report to the last, peak memory, the
      launch counts (set to 0 just before fit, read just after: a layer's
      flash forward, dq and dk/dv once a step, fused_adamw once a leaf, 41
      leaves), device time a step by op-table group and busy share over a
      3-step profiler window, and one MoE layer's routing, dispatch einsum,
      expert products and combine einsum timed alone (forward + backward)
      with their share of the device step, and the PyTorch ops whose own
      kernels take the most device time (key_averages over 2 steps).
   K. flash_fwd, dq, dk/dv at [8, 16, 2048, 128] bf16 causal and fused_adamw
      at the [8, 2048, 8192] expert leaf with M's optimizer, each held
      against its plain version and timed beside its bound and its library
      call; the kernels line carries them as each row's moe_shape.
   E. _top2_dispatch on the card equal to the CPU's on the same gates; an
      MoE layer at d 256, e 8, f32, TF32 off, card against CPU from host
      draws: routing equal, output and gradients within TRAIN_PARITY_TOL.
   W. DistributedContext.from_torch() over NCCL as a world of one and
      train.init(mesh_config=MeshConfig(data=-1)): FSDP2 on a one-rank mesh,
      fused_adamw on to_local() shards; 5 steps of M's config against 5
      without a mesh, from the same weights and batches (losses within
      TRAIN_PARITY_TOL, the same launch counts a step); a checkpoint
      written on the mesh (MOE_W_CKPT_CUTS, printed) that the no-mesh
      Trainer restores bitwise.
   Printed: each part's seconds and the phase's.
15. seq: examples/transformer_lm/fsdp_tp_sp.yaml (SEQ_CONST, a dict a CPU
   test holds to the file): d 4096, 32 heads of 128, 8 kv heads, vocab
   32768, seq 32768, bf16, remat, fused cross-entropy and fused AdamW.
   R. the ring's kernel route (ops/ring_attention.py) on this card through
      its VirtualRing: at the file's attention shape ([1, 32, 32768, 128]
      q, 8 kv heads, bf16) the zigzag ring at n = 2 and 4, forward and
      backward, against the whole-sequence flash kernels on the same inputs
      (SEQ_RING_TOL); at SEQ_PLAIN_LEN tokens both against the plain
      version in f32 (the ring's own share of the error; KERNEL_TOL's and
      BWD_TOL's bf16 tolerances); the launch counters set to 0 just before
      each ring and read just after, equal to ring_block_counts (2n + 1
      flash forwards, dq and dk/dv a sweep); the sweeps' times beside the
      whole-sequence kernels'.
   L. the file's LM cut as SEQ_CUTS prints (one card: 4 layers, one
      sequence a step, a 10-step warm-up; the file's ring is the
      whole-sequence flash kernels without a seq axis), SEQ_STEPS steps
      through train.init -> Trainer(LMTrial).fit and a validation pass:
      step time, tokens/s and
      MFU (dense_lm_step_flops, remat's recompute not counted), peak
      memory, the launch counts (set to 0 just before fit, read just after:
      a layer's flash forward twice a step under remat and once a
      validation batch, dq and dk/dv once a step, fused_adamw once a leaf,
      39 leaves), device time a step by op-table group and busy share over
      a 3-step profiler window.
   K. flash_fwd, dq and dk/dv at SEQ_KERNEL_SHAPES (the n = 2 ring's
      half-chunks, causal and full, and the whole sequence; 8 kv heads),
      each held against its plain version where its scores fit (8,192) and
      timed beside its bound and scaled_dot_product_attention's time (k and
      v expanded to 32 heads for it); fused_adamw at L's largest leaf
      [16384, 4096] with L's optimizer.  The kernels line carries them as
      each row's seq_shapes.
   Printed: each part's seconds and the phase's.
16. gang: phase 7's experiment (EXPERIMENT_CONST with EXPERIMENT_CUTS: the
   full width at 2 layers, 24 steps, validations at 12 and 24, checkpoint
   period 18; GANG_CUTS printed) run by the gang launcher
   (experiment/_gang.py) on a block of one device: a driver process
   (``gang_driver``: run-local's path, the configuration parsed from its
   dict where run-local reads YAML) sends its block to LocalExperiment's
   gang path, which starts one rank process under NCCL for the trial
   (GANG_ENTRY, LMTrial whose chief SIGTERMs the driver before step 14).
   A. the run: the SIGTERM drains the gang through the relay and the
      ranks' vote to a checkpoint at step 18; the driver exits 75.
      Checks: the step-12 and step-18 checkpoints, manifest-verified; the
      journal holds the step-12 validation, relayed; the rank's launch
      counts come back through the relay and equal 18 steps x the model's
      leaves of fused_adamw, 18 x its layers of each flash backward kernel
      and its layers x (18 + the validation batches) of the forward.
   B. ``experiment resume`` in a second driver: steps 18 -> 24; the
      rank's launch counts come back through the relay and equal 6 steps x
      the model's leaves of fused_adamw, 6 x its layers of each flash
      backward kernel and its layers x (6 + the validation batches) of the
      forward.
   Checks: the journal holds both validations (12 and 24), relayed; the
   step-24 checkpoint, loaded on this card, equals phase 7's uninterrupted
   run C (run here when phase 7 did not run) bitwise: params, moments,
   steps and the last validation loss.  Printed: each driver's seconds,
   the time from the gang's launch to its first step, the host-clock step
   beside phase 7's, and the phase's seconds.
17. cluster: the native control plane.  dtpu-master and dtpu-agent are
   built from native/ (determined_tpu_torch/devcluster.py: cmake, else g++)
   into a fresh temporary directory by a process started when the script
   starts, beside the GPU phases; the phase joins it.  A master and one
   agent (one slot, ``--python`` the port's launcher, exec/launcher.py) run
   on localhost with their state and checkpoints in a temporary directory;
   the port's ClusterExperiment submits phase 7's configuration
   (EXPERIMENT_CUTS, then CLUSTER_CUTS, printed: searcher single, the same
   seed, registry auto_promote) to the master, which places the trial on
   the agent; the agent execs the port's run_trial on this card.  Before
   step 14 the trial waits until the master's preemption signal reaches
   it; the script pauses the experiment through the master's API
   (POST /api/v1/experiments/{id}/pause), the trial checkpoints at its next
   boundary (step 14: the default report period is 2 steps) and exits 0,
   the master holds it PENDING; the script activates the experiment and
   the master relaunches the trial with DTPU_LATEST_CHECKPOINT, which
   resumes 14 -> 24.  Checks: the search completes; the final params,
   moments, steps and validation loss equal phase 7's C bitwise (run here
   when phase 7 did not run); the master's /api/v1/trials/{id}/metrics
   holds the trial's training rows and its validations at 12 and 24;
   /api/v1/checkpoints the drained step-14 checkpoint and the final one;
   the trial's logs at the master (/api/v1/trials/{id}/logs, relayed by
   the agent) a line naming its CUDA device, a heartbeat the master
   answered, and the resumed run's kernel launch counts: 10 steps x the
   model's leaves of fused_adamw (210), 10 x its layers of each flash
   backward kernel (20) and 2 x (10 + 16 validation batches) of the
   forward (52); the registry version 1 of lm-const at the final
   checkpoint's uuid.  Printed: the native build's seconds and how many the
   phase waited for them, the submit-to-first-step time, the trial's step
   (from its reports at the master: each covers 2 steps and ends in a host
   sync; those at a start, a validation or a save left out) beside phase
   7's host-clock step, the trial's host-clock step between reports (the
   enqueue: the report's sync absorbs the device time), the time from the
   pause to the trial's exit, from the activation to the resumed run's
   first step, and the phase's seconds.  The master runs with phase 19's
   flags (FLEET_MASTER_CUTS, printed) and keeps the pause's checkpoint
   through its GC (CLUSTER_CUTS: save_trial_latest 3); with phase 19 to
   follow, the cluster, its registry and its checkpoints stay up for it.
18. pipe: examples/transformer_lm/pipeline.yaml (PIPE_CONST, a dict a CPU
   test holds to the file) at its full width and depth: d 2048, 16 layers,
   16 heads of 128, vocab 32768, seq 2048, bf16, flash, remat, fused
   cross-entropy and fused AdamW, M = 8 microbatches; cut as PIPE_CUTS
   prints (one card: the four stages on a VirtualPipe of 4, one pipe
   group's 16 sequences a step, a 1-step warm-up).
   U. the unpipelined reference: the same weights and data through
      Trainer(LMTrial).fit with gradient aggregation over the same 8
      microbatches (2 sequences each), PIPE_STEPS steps and a validation.
   S. each of gpipe, 1f1b and interleaved (V = 2) through
      train.init(virtual_pipe=4) -> Trainer(LMTrial).fit for PIPE_STEPS
      steps and a validation: every step's loss and the validation loss
      against U's within PIPE_TOL, the params' updates against U's within
      its update_rel; the launch counts, set to 0 just before fit and read
      just after, exactly: a layer's flash forward twice a microbatch a
      step under remat and once a microbatch a validation batch, dq and
      dk/dv once a microbatch a step, fused_adamw once a leaf a step (147
      leaves); BubbleModel's fraction (3/11 for gpipe and 1f1b, 3/19
      interleaved); the step time and the peak memory (1f1b's below
      gpipe's).
   K. flash_fwd, dq and dk/dv at a microbatch's attention ([2, 16, 2048,
      128], causal), each held against its plain version and timed beside
      its bound and scaled_dot_product_attention's; fused_adamw at a
      stage's largest leaf [8192, 2048].  The kernels line carries them as
      each row's pipe_shapes.
   Printed: each part's seconds and the phase's.
19. fleet: the serving fleet through phase 17's master and agent (run
   right after phase 17, on its cluster; asked for alone, it runs phase 17
   first and says so).  The pause's step-14 checkpoint is registered as
   lm-const v2 through the port's CLI (``model register``, a subprocess);
   v1 is phase 17's promoted winner.  v1 and v2 are loaded in this process
   with ServeEngine.from_checkpoint on the card and serve FLEET_PROMPTS of
   phase 11's prompts (cut as FLEET_CUTS prints) one at a time: the
   expected greedy tokens of each version (they must differ); both loads
   run at once, and both engines are freed.  ``fleet set lm-const@1 --target 1`` (the port's CLI): the
   master's supervisor launches a serve task, the agent execs the port's
   exec/serve_replica through the launcher, which loads v1 on the card and
   registers.  Checks: its task log at the master names the card (``device:
   cuda``); the prompts through the master's router (client.generate) give
   v1's tokens; one request straight to the replica gives the router's
   share of the round trip.  ``model deploy lm-const@2`` (the CLI) under
   FLEET_LOAD_THREADS clients sending other prompts back to back through
   the router: the replica drains (its log: the master's drain, a clean
   exit; its slot: no failure, so it exited 75 or 0), the supervisor
   relaunches it on v2, the deploy completes; every answer is 16 tokens
   from the replica the router names, none from the v1 replica after one
   from the v2 replica, the drained replica completed every request it
   took (those in flight at the drain included), and the router's 503s in
   the gap are counted.  The prompts then give v2's tokens (cold on the
   new replica).  SIGKILL of the v2 replica's process: its slot counts the
   failure (exit 137), the master reaps it at its heartbeat TTL and the
   supervisor relaunches it on v2, which serves v2's tokens.  Each
   replica's last ``kernel launches:`` line in its task log: flash_fwd
   equals its layers x the prefills it ran (requests less prefix hits, as
   phase 3 counts), no backward or AdamW launch.  Printed: fleet set ->
   registered -> ready, TTFT and the decode step through the router and
   direct, deploy -> drained -> relaunched -> registered on v2, SIGKILL
   -> relaunched -> registered, each replica's from_checkpoint seconds with
   the md5 part, and the phase's seconds.

20. overlap: phase 5's workload again through an experiment configuration
   with ``optimizations.overlap_grad_sync: true``.  On one card the mesh
   has no gradient-reduction axis, so the Trainer builds no plan (JAX's
   ``build_plan`` returns None there): the reported losses and the
   validation loss equal phase 5's bitwise, with phase 5's launches (the
   counters set to 0 just before fit, read just after; asked for without
   phase 5, phase 5 runs first and says so).  Printed: the overlapped
   sync's plan (train/_overlap.py) for the flagship's leaves at full width
   on data 4 and on dcn 2 x data 2, flat and hierarchical, at the default
   4 MiB buckets: the buckets, the synced leaves, the FSDP2 units they
   give, the ring bytes a step over each hop, the links' bandwidths (the
   card's table entry, or its labelled placeholder) and the comm model's
   exposed and hidden milliseconds at phase 5's step time.

Prints, before the last line, the kernels line (JSON), the script's total
seconds and the card's name and power limit, and as the last line
{"ok": true, "device": {...}}.
Imports nothing of JAX or determined_tpu.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import statistics
import subprocess
import sys
import time
import urllib.request

import numpy as np

# H100 SXM published peaks (NVIDIA data sheet, dense): bf16 tensor cores,
# f32 outside the tensor cores, HBM3 bandwidth
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12

CSRC = "determined_tpu_torch/csrc/"
KERNEL_SOURCES = ("flash_fwd.cu", "flash_bwd.cu", "fused_adamw.cu")
# kernels whose ptxas report must show no spill and no C75xx warning (every
# instance), by source
PTXAS_CLEAN = {"flash_bwd.cu": ("flash_bwd_dq_wgmma", 2)}  # D = 64, 128
# kernels line: name -> (source in the repo, the TPU kernel it replaces)
KERNELS = {
    "flash_fwd": (CSRC + "flash_fwd.cu", "determined_tpu/ops/flash_attention.py:150"),
    "flash_bwd_dq": (CSRC + "flash_bwd.cu", "determined_tpu/ops/flash_attention.py:288"),
    "flash_bwd_dkv": (CSRC + "flash_bwd.cu", "determined_tpu/ops/flash_attention.py:304"),
    "fused_adamw": (CSRC + "fused_adamw.cu", "determined_tpu/ops/fused_adamw.py:125"),
}

# attention cases: the training and serving shapes, then the ragged, GQA and
# f32 corners, and the edges of the bf16 kernels' TMA pipelines: a ragged
# last tile (TMA's zero fill and clipped store), GQA at head dim 64 (the 3-D
# kv tensor map), and a long causal walk (the ring wraps many times).
# name, b, h, hkv, s, d, dtype name, causal
ATTN_CASES_SPEC = [
    ("training", 8, 16, 16, 1024, 128, "bfloat16", True),
    ("serving", 1, 16, 16, 1024, 128, "bfloat16", True),
    ("gqa", 2, 16, 4, 512, 128, "bfloat16", True),
    ("f32_hd64_ragged", 1, 4, 4, 200, 64, "float32", True),
    ("f32_hd128_full_gqa", 2, 8, 2, 77, 128, "float32", False),
    ("bf16_hd64_ragged_full", 1, 4, 4, 130, 64, "bfloat16", False),
    ("bf16_ragged1000", 1, 8, 8, 1000, 128, "bfloat16", True),
    ("bf16_gqa_hd64", 2, 8, 2, 640, 64, "bfloat16", True),
    ("bf16_long4096", 1, 8, 8, 4096, 128, "bfloat16", True),
]

# kernel vs plain version, per dtype.  bf16: both cast p to bf16 before P.V,
# but the kernel's online softmax rounds p against a running max where the
# plain version uses the row max, so outputs differ by a few bf16 ulps
# (2^-8 relative); lse sums f32 values in another order.  f32: the
# tolerance the JAX package holds its own flash kernel to (tests/test_ops.py).
KERNEL_TOL = {
    "bfloat16": dict(out=dict(atol=1e-2, rtol=1e-2), lse=dict(atol=1e-3, rtol=1e-3)),
    "float32": dict(out=dict(atol=2e-5, rtol=2e-5), lse=dict(atol=2e-5, rtol=2e-5)),
}
# backward kernels vs the plain backward; atol is relative to the largest
# |gradient| of the case.  bf16: ds and p are rounded to bf16 before their
# products on both sides, but from f32 values that differ in the last bits
# (another summation order), so a few of them round the other way, and the
# outputs are bf16 (2^-8 relative).  f32: summation order only, over up to
# Sk terms.
BWD_TOL = {
    "bfloat16": dict(rtol=2e-2, atol=2e-2),
    "float32": dict(rtol=2e-4, atol=2e-5),
}

# fused AdamW leaves: two flagship SwiGLU leaves, the embedding, and tails
# that are no multiple of the block
ADAMW_CASES_SPEC = [
    ((2048, 8192), "bfloat16"),
    ((2048, 8192), "float32"),
    ((32768, 2048), "bfloat16"),
    ((77, 33), "float32"),
    ((2048,), "float32"),
]
ADAMW_TIMED = ((2048, 8192), "bfloat16")
# S3's MNIST MLP leaves (fc1 weight and bias, fc2 weight and bias) at the
# widest and a narrow hidden size of adaptive.yaml's range [32, 256]: biases
# smaller than one 256-thread block, ragged tails and an exact multiple;
# held with the optimizer MnistTrial builds (no decay, no clip, f32 moment)
MNIST_ADAMW_SHAPES = ((256, 784), (256,), (10, 256), (10,), (33, 784), (33,), (10, 33))
# the kernel's operations per element: 2 multiplies for g and its square,
# 2 + 3 for m and v, 2 divides for the bias corrections, a square root, an
# add, a divide, a multiply-add for the decay and a multiply-subtract for p
ADAMW_FLOPS_PER_ELEMENT = 17
# f32: the JAX package's bound for its fused sweep against optax
# (tests/test_ops.py); both sides round the same IEEE operations in the same
# order.  bf16 (the stored first moment): one bf16 ulp, where an f32 value a
# last bit apart rounds the other way.
ADAMW_TOL = {
    "float32": dict(rtol=2e-6, atol=2e-7),
    "bfloat16": dict(rtol=2 ** -7, atol=1e-6),
}

# serving-path logits vs the full forward.  bf16 keeps 8 mantissa bits and
# the two paths round at different places (the prompt padded to 1024 vs its
# own length, the chunked decode keeps p in f32 where the forward casts it),
# through 8 layers; logits here have std ~1.  f32: reassociation only.
PARITY_TOL = {"bfloat16": dict(atol=1e-1, rtol=5e-2), "float32": dict(atol=2e-3, rtol=1e-3)}

# phase 5: the bench.py workload (bench.py's hparams at one chip)
TRAIN_HPARAMS = dict(
    lr=3e-4, global_batch_size=8, seq_len=1024, vocab_size=32768, d_model=2048,
    n_layers=8, n_heads=16, dataset_size=64, bf16=True, attention="flash",
    warmup_steps=10, fused_ce="auto", fused_adamw="auto", adam_mu_bf16=True,
)
TRAIN_STEPS = 25
TRAIN_REPORT = 5

# phase 6: a 2-layer f32 LM, card against CPU
TRAIN_PARITY_HPARAMS = dict(
    lr=1e-3, global_batch_size=4, seq_len=256, vocab_size=1024, d_model=256,
    n_layers=2, n_heads=4, dataset_size=16, bf16=False, attention="flash",
    warmup_steps=1, fused_ce=True, fused_adamw=True, adam_mu_bf16=False,
)
TRAIN_PARITY_STEPS = 3
# f32 on both sides, sums taken in other orders (cuBLAS and the kernels vs
# the CPU): the losses agree to f32 reassociation through 2 layers.  Adam
# divides each moment by its root, so a gradient element near zero whose
# sign differs in the last bits moves its weight the other way; the updates
# and moments are therefore held in relative norm over each tensor.
TRAIN_PARITY_TOL = dict(
    loss=dict(rtol=1e-5, atol=1e-5), update_rel=1e-2, moment_rel=1e-3,
)
# a first moment built from gradients whose true value is 0 (an attention
# key's bias): f32 noise of sums of order 1 over a few hundred terms, as
# tests/test_torch_hf_gpt2.py holds it; the second moment within its square
ZERO_GRAD_MU = 1e-6

N_REQUESTS = 12
N_SHARED = 4
SHARED_PREFIX = 512

# phase 7: examples/transformer_lm/const.yaml as a dict (the card's machine
# may lack yaml; a CPU test holds this to the file), then its cuts:
# (dotted key, the file's value, this run's value, why)
EXPERIMENT_CONST = {
    "name": "lm-const",
    "entrypoint": "model_def:Trial",
    "hyperparameters": dict(
        lr=0.0003, global_batch_size=8, seq_len=1024, vocab_size=32768, d_model=2048,
        n_layers=8, n_heads=16, dataset_size=4096, bf16=True, attention="flash",
    ),
    "searcher": {"name": "single", "metric": "validation_loss",
                 "max_length": {"batches": 1000}},
    "min_validation_period": {"batches": 200},
    "checkpoint_storage": {"type": "shared_fs", "host_path": "/tmp/dtpu-checkpoints"},
}
EXPERIMENT_CUTS = [
    ("searcher.max_length", {"batches": 1000}, {"batches": 24},
     "24 steps: preempted at 18, resumed to 24"),
    ("min_validation_period", {"batches": 200}, {"batches": 12},
     "validation (and the best checkpoint) at steps 12 and 24"),
    ("min_checkpoint_period", None, {"batches": 18},
     "makes step 18 a boundary: the Trainer reads the preemption flag at boundaries only"),
    ("hyperparameters.dataset_size", 4096, 128,
     "one validation pass is 16 full-width batches, not 512"),
    ("hyperparameters.n_layers", 8, 2,
     "depth only: six flagship saves of 8.05 GB, their md5 passes and three resumes were "
     "most of the phase; at 2 layers each save is 3.22 GB (the width stays full), and the "
     "time goes to the hf phase; phases 5, 9 and 10 keep 8 layers"),
    ("checkpoint_storage.host_path", "/tmp/dtpu-checkpoints", "<temp dir>",
     "a fresh temporary directory outside the repo, deleted at the end"),
    ("reproducibility.experiment_seed", None, "<--seed>",
     "the trial's weights and data from the run's --seed"),
]
# part D's own changes on top of those: (dotted key, the value the file
# gets by default, D's value, why)
CRASH_CUTS = [
    ("max_restarts", 5, 1, "the crash at step 15 is the one failure: one restart"),
    ("fault_tolerance.restart_backoff_base", 1.0, 0.0, "no backoff sleep before the restart"),
    ("optimizations.async_checkpointing", True, False,
     "the step-12 save is finalized before the crash at 15, so the restart takes it; an "
     "async save is finalized only at the next drain point, and a crash before that restarts "
     "from the last finalized checkpoint (on the CPU: test_torch_fault_tolerance.py"
     "::test_crash_with_async_save_in_flight_resumes_from_finalized_only)"),
]
EXPERIMENT_STEPS = 24
PREEMPT_AT = 18
CRASH_AT = 15

# phase 16: phase 7's configuration run by the gang launcher on a block of
# one device.  The trial class the rank imports by name (module
# ``__getattr__`` below builds it), the step before which its chief SIGTERMs
# the driver, the driver's and the gang's time limit, and the one change
# from phase 7: (what, phase 7's, this phase's, why)
GANG_ENTRY = "chip_smoke:GangLMTrial"
GANG_SIGTERM_AT = 14
GANG_TIMEOUT_S = 300.0
GANG_CUTS = [
    ("the trial's block of one device", "trains on a thread of the experiment",
     "one rank process (NCCL, a world of one) under the gang launcher",
     "the card has one GPU: the launcher, the relay and the preemption drain run for a "
     "block of one, driven directly (LocalExperiment runs a block of one on a thread)"),
    ("the preemption", f"request_preemption() before step {PREEMPT_AT}",
     f"SIGTERM to the driver before step {GANG_SIGTERM_AT}, read at the step-{PREEMPT_AT} "
     "boundary", "what a host's maintenance event sends to run-local"),
]

# phase 17: phase 7's configuration submitted to the native master by the
# port's ClusterExperiment and run by a native agent through the port's
# launcher.  The trial class the agent's process imports by name (module
# ``__getattr__`` builds it), the step before which it waits for the
# master's preemption signal, the variable naming the directory it writes
# its events to, the phase's time limits, and the changes from phase 7's
# configuration: (dotted key, phase 7's value, this phase's, why)
CLUSTER_ENTRY = "chip_smoke:ClusterLMTrial"
CLUSTER_PAUSE_AT = 14
CLUSTER_DIR_ENV = "DTT_SMOKE_CLUSTER_DIR"
CLUSTER_MODEL = "lm-const"
CLUSTER_TIMEOUT_S = 300.0
# the trial process's heartbeat period (HeartbeatReporter.INTERVAL, set
# where the process imports its trial class): (the default, this run's, why)
CLUSTER_HEARTBEAT_CUT = (30.0, 2.0, "each of the trial's two runs is shorter than 30 s")
CLUSTER_CUTS = [
    ("entrypoint", "model_def:Trial", CLUSTER_ENTRY,
     f"LMTrial that waits before step {CLUSTER_PAUSE_AT} until the master's preemption signal "
     "reaches it, and writes its start times and host steps to a file"),
    ("registry", None, {"model": CLUSTER_MODEL, "auto_promote": True},
     "the search's winner is promoted to the master's registry"),
    (f"environment.env.{CLUSTER_DIR_ENV}", None, "<events dir>",
     "where the trial writes its events (a fresh temporary directory)"),
    ("checkpoint_storage.save_trial_latest", None, 3,
     "the master's GC at the search's end keeps the pause's step-14 checkpoint (the newest "
     "three: 24, 18, 14), which phase 19 serves as lm-const v2"),
]

# phase 19: the serving fleet on phase 17's cluster.  The master's flags
# (flag, the master's default, this run's, why), the prompts' cut (what,
# phase 11's, this phase's, why), the concurrent clients during the
# deploy, and the phase's time limit for each wait
FLEET_MASTER_CUTS = [
    ("--serve-replica-timeout-sec", 15, 5,
     "a SIGKILLed replica is reaped (and relaunched) 5 s after its last heartbeat (every 2 s)"),
    ("--fleet-backoff-initial-ms", 1000, 200, "the relaunch after the SIGKILL waits 0.2 s"),
    ("--deploy-step-timeout-sec", 180, 120, "a deploy step that hangs fails the phase sooner"),
]
FLEET_PROMPTS = 4
FLEET_PROMPT_LEN = 128
FLEET_CUTS = [
    ("prompts", f"phase 11's first {FLEET_PROMPTS} (64-1000 tokens)",
     f"their last {FLEET_PROMPT_LEN} tokens",
     "a fleet replica serves the default ServeConfig (max_prompt_len 128): `fleet set` sets no "
     "serve override, as the JAX CLI's does not"),
]
FLEET_LOAD_THREADS = 3
FLEET_TIMEOUT_S = 300.0

# phase 8: searches.  S1 (ASHA) and S2 (PBT) are const.yaml (EXPERIMENT_CONST)
# with these changes, S3 is examples/mnist/adaptive.yaml (MNIST_ADAPTIVE, a
# dict for the same reason; a CPU test holds both to their files); each
# change is (dotted key, the file's value, this run's value, why)
_SEARCH_COMMON_CUTS = [
    ("hyperparameters.lr", 0.0003, {"type": "log", "minval": -5, "maxval": -3},
     "the searched hyperparameter: lr drawn log-uniformly in [1e-5, 1e-3]"),
    ("hyperparameters.dataset_size", 4096, 128,
     "one validation pass is 16 full-width batches, not 512"),
    ("checkpoint_storage.host_path", "/tmp/dtpu-checkpoints", "<temp dir>",
     "a fresh temporary directory outside the repo, deleted at the end"),
    ("reproducibility.experiment_seed", None, "<--seed>",
     "the searcher's draws, the weights and the data from the run's --seed"),
]
SEARCH_ASHA_CUTS = [
    ("searcher", EXPERIMENT_CONST["searcher"],
     {"name": "asha", "metric": "validation_loss", "max_trials": 4, "num_rungs": 2,
      "divisor": 2, "max_length": {"batches": 32}},
     "ASHA: 4 trials, rungs at 16 and 32 batches, the top half of a rung goes on"),
    ("min_validation_period", {"batches": 200}, {"batches": 16}, "a validation at each rung"),
    ("checkpoint_policy", None, "none",
     "no best checkpoints: a searcher stop reaches the trial as a preemption, whose "
     "synchronous save is the one checkpoint of a trial (deleted when the trial ends)"),
    ("hyperparameters.n_layers", 8, 2,
     "depth only: four synchronous stop saves of 8.05 GB were 81% of S1's time; at 2 layers "
     "each is 3.22 GB (the width stays full), and the time goes to the models phase"),
] + _SEARCH_COMMON_CUTS
SEARCH_PBT_CUTS = [
    ("searcher", EXPERIMENT_CONST["searcher"],
     {"name": "pbt", "metric": "validation_loss", "population_size": 2,
      "num_generations": 2, "truncate_fraction": 0.5, "max_length": {"batches": 8}},
     "PBT: 2 members, 2 generations of 8 batches; the worse member is replaced by a "
     "perturbed clone of the better one"),
    ("hyperparameters.n_layers", 8, 2,
     "depth only: every clone saves, verifies and copies a checkpoint, 3.22 GB at 2 layers "
     "and 8.05 GB at 8 (the width stays full)"),
    ("min_validation_period", {"batches": 200}, {"batches": 8},
     "a validation (and a best checkpoint) at the end of each generation"),
] + _SEARCH_COMMON_CUTS
MNIST_ADAPTIVE = {
    "name": "mnist-adaptive",
    "entrypoint": "model_def:Trial",
    "hyperparameters": {
        "lr": {"type": "log", "minval": -4, "maxval": -2},
        "hidden": {"type": "int", "minval": 32, "maxval": 256},
        "global_batch_size": 64,
        "dataset_size": 4096,
    },
    "searcher": {"name": "adaptive_asha", "metric": "validation_accuracy",
                 "smaller_is_better": False, "max_trials": 16, "max_length": {"batches": 400},
                 "num_rungs": 3, "divisor": 4, "mode": "standard"},
    "min_validation_period": {"batches": 25},
    "checkpoint_storage": {"type": "shared_fs", "host_path": "/tmp/dtpu-checkpoints"},
}
SEARCH_MNIST_CUTS = [
    ("checkpoint_storage.host_path", "/tmp/dtpu-checkpoints", "<temp dir>",
     "a fresh temporary directory outside the repo, deleted at the end"),
]

# phase 9: const.yaml (EXPERIMENT_CONST) traced: the tracer's export and a
# torch.profiler window; each change is (dotted key, the file's value, this
# run's value, why)
OBSERVE_STEPS = 12
OBSERVE_WINDOW = 3
# the profiler's system sampler: (its default interval, this run's, why)
OBSERVE_SAMPLE_CUT = (10.0, 0.5, "the run is shorter than one default interval: a sample "
                      "every 0.5 s holds the device memory keys on the card")
OBSERVE_CUTS = [
    ("searcher.max_length", {"batches": 1000}, {"batches": OBSERVE_STEPS},
     f"{OBSERVE_STEPS} steps: a {OBSERVE_WINDOW}-step trace window, then untraced steps"),
    ("min_validation_period", {"batches": 200}, {"batches": OBSERVE_STEPS},
     "one validation pass, at the end (outside the trace window)"),
    ("checkpoint_policy", None, "none",
     "no checkpoint: a flagship save takes about 26.6 s, and phase 7 measures saves"),
    ("hyperparameters.dataset_size", 4096, 128,
     "one validation pass is 16 full-width batches, not 512"),
    ("observability", None, {"enabled": True, "trace_export": True},
     "the tracer's events exported: traces/events.jsonl, trace.json, goodput.json"),
    ("profiling", None, {"enabled": True, "trace": True, "end_after_batch": OBSERVE_WINDOW},
     f"a torch.profiler window over the first {OBSERVE_WINDOW} steps, opened through the "
     "trial's core context"),
    ("checkpoint_storage.host_path", "/tmp/dtpu-checkpoints", "<temp dir>",
     "a fresh temporary directory outside the repo, deleted at the end"),
    ("reproducibility.experiment_seed", None, "<--seed>",
     "the trial's weights and data from the run's --seed"),
]

# phase 10: the step knobs at the flagship's full width and depth, on phase
# 5's workload (TRAIN_HPARAMS)
KNOBS_AGG = 4
KNOBS_AGG_STEPS = 8
KNOBS_AGG_REPORT = 2
# the one-update comparison's changes: (hparam, phase 5's value, this
# comparison's, why)
KNOBS_AGG_CMP_CUTS = [
    ("warmup_steps", 10, 0,
     "the first update at the full lr: in the warmup lr(0) is 0 and the update would be zero"),
]
# agg 4 x 8 samples against one batch of 32: the same 32 samples and loss,
# but each microbatch's weight gradients are bf16 products rounded on their
# own (2^-9 relative) and summed in f32, where the batch of 32 rounds once,
# and cuBLAS may tile 8,192 and 32,768 rows differently; the first moment is
# stored in bf16 on both sides.  Held: the loss to 1e-3 relative, each
# leaf's moments to 2e-2 in relative norm, and Adam's first update, which
# is lr * sign(g) wherever |g| >> eps, moves at most 1% of the weights the
# other way (where |g| is within that noise of 0).
KNOBS_AGG_TOL = dict(loss_rtol=1e-3, moment_rel=2e-2, moved_other_way=1e-2)
KNOBS_QUANT_STEPS = 25
# the JAX package's bound on a quantized loss curve against the unquantized
# one (tests/test_step_optimizations.py)
KNOBS_QUANT_LOSS_REL = 0.02
# substrings of an int8 or fp8 gemm's kernel name (cuBLAS/CUTLASS)
QUANT_GEMM_MARKERS = {"int8": ("i8", "s8", "int8", "imma"), "fp8": ("e4m3", "f8", "fp8")}
# the flagship's quantized linears: name -> (K, N) at 8 x 1024 rows
QUANT_LINEAR_SHAPES = {"q_k_v_o": (2048, 2048), "gate_up": (2048, 8192), "down": (8192, 2048)}
# the card's quantized product against the plain version (the same
# quantized operands multiplied in f32, rescaled in the same order): the
# int8 sums are exact in int32 and within f32 rounding (2^-24 of the sum of
# |terms|) on the plain side; the fp8 tensor cores accumulate in f32 with a
# reduced-precision partial sum between promotions.  Both round the rescaled
# f32 value to bf16, where an f32-level difference can flip one bf16 ulp
# (2^-8 relative): rtol 2^-7, atol a fraction of the largest |output|.
QUANT_LINEAR_TOL = {"int8": dict(rtol=2 ** -7, atol=1e-5), "fp8": dict(rtol=2 ** -7, atol=1e-3)}
# the same at an f32 compute dtype (bf16: false), where fp8 takes unit
# scales and an f32 output with the rescale after: no bf16 rounding, so
# what is left is the plain side's f32 sums (int8) and the fp8 tensor
# cores' reduced-precision partial sums (fp8)
QUANT_LINEAR_F32_TOL = {"int8": dict(rtol=1e-5, atol=1e-5), "fp8": dict(rtol=2 ** -10, atol=1e-3)}

# phase 11: train const.yaml's flagship, save, serve from the checkpoint
SERVE_CKPT_STEPS = 4
# (hyperparameter, const.yaml's value, phase 11's value, why)
SERVE_CKPT_CUTS = [
    ("n_layers", 8, 2,
     "the whole script's time (phase 18 adds about 45 s): phase 7's 2 layers at the full width, "
     "a 3.22 GB checkpoint where 8 layers save 8.05 GB; phase 7 times the same save"),
]
SERVE_CKPT_DATASET = 64
SERVE_CKPT_REQUESTS = 6
SERVE_CKPT_NEW_TOKENS = 16
SERVE_CKPT_SCORE_BATCH = 8
SERVE_CKPT_SCORE_BATCHES = 8
SERVE_CKPT_SCORE_INTERVAL = 2

# phase 12: the CIFAR ResNet and DDPM trials, each its example's const.yaml
# as a dict (a CPU test holds each to its file), then the cuts both take
CIFAR_CONST = {
    "name": "cifar10-resnet",
    "entrypoint": "model_def:Trial",
    "hyperparameters": dict(lr=0.05, momentum=0.9, global_batch_size=128, dataset_size=8192,
                            depth_per_stage=3),
    "searcher": {"name": "single", "metric": "validation_accuracy", "smaller_is_better": False,
                 "max_length": {"epochs": 4}},
    "min_validation_period": {"epochs": 1},
    "checkpoint_storage": {"type": "shared_fs", "host_path": "/tmp/dtpu-checkpoints"},
}
DIFFUSION_CONST = {
    "name": "diffusion-ddpm",
    "entrypoint": "model_def:Trial",
    "hyperparameters": dict(lr=2.0e-4, base_channels=32, timesteps=1000, global_batch_size=64,
                            dataset_size=4096, bf16=True),
    "searcher": {"name": "single", "metric": "validation_loss", "smaller_is_better": True,
                 "max_length": {"batches": 500}},
    "min_validation_period": {"batches": 100},
    "checkpoint_storage": {"type": "shared_fs", "host_path": "/tmp/dtpu-checkpoints"},
}
MODELS_CUTS = [
    ("checkpoint_storage.host_path", "/tmp/dtpu-checkpoints", "<temp dir>",
     "a fresh temporary directory outside the repo, deleted at the end"),
    ("reproducibility.experiment_seed", None, "<--seed>",
     "the trial's weights and data from the run's --seed"),
]
MODELS_UNET_LEAVES = 82
# D's sampler: ddpm_sample over every timestep of the trained model
MODELS_SAMPLES = 16
# part P, card against CPU: each trial's changes, (trial, hparam, the
# file's value, P's value, why); None is the trial's default
MODELS_PARITY_STEPS = 3
MODELS_PARITY_CUTS = [
    ("cifar10", "depth_per_stage", 3, 1,
     "one block a stage (ResNet-8): the CPU side takes its 3 steps in seconds"),
    ("cifar10", "global_batch_size", 128, 32, "the same, in batch"),
    ("cifar10", "bf16", None, False, "f32 on both sides"),
    ("diffusion", "global_batch_size", 64, 16, "the CPU side takes its 3 steps in seconds"),
    ("diffusion", "bf16", True, False, "f32 on both sides"),
]

# phase 13: the HF GPT-2 and BERT fine-tunes, each its example's const.yaml as
# a dict (a CPU test holds each to its file), then the cuts both take
HF_GPT2_CONST = {
    "name": "hf-gpt2-finetune",
    "entrypoint": "model_def:Trial",
    "hyperparameters": dict(lr=5.0e-4, global_batch_size=32, seq_len=128, vocab_size=50257,
                            hidden_size=768, num_layers=12, num_heads=12, dataset_size=8192,
                            warmup_steps=50),
    "searcher": {"name": "single", "metric": "validation_loss", "smaller_is_better": True,
                 "max_length": {"batches": 500}},
    "min_validation_period": {"batches": 100},
    "checkpoint_storage": {"type": "shared_fs", "host_path": "/tmp/dtpu-checkpoints"},
}
HF_BERT_CONST = {
    "name": "hf-bert-classify",
    "entrypoint": "model_def:Trial",
    "hyperparameters": dict(lr=0.0005, global_batch_size=64, seq_len=128, vocab_size=8192,
                            hidden_size=256, num_layers=4, num_heads=8, num_labels=4,
                            dataset_size=16384),
    "searcher": {"name": "single", "metric": "validation_accuracy", "smaller_is_better": False,
                 "max_length": {"epochs": 3}},
    "min_validation_period": {"epochs": 1},
    "checkpoint_storage": {"type": "shared_fs", "host_path": "/tmp/dtpu-checkpoints"},
}
HF_CUTS = [
    ("checkpoint_storage.host_path", "/tmp/dtpu-checkpoints", "<temp dir>",
     "a fresh temporary directory outside the repo, deleted at the end"),
    ("reproducibility.experiment_seed", None, "<--seed>",
     "the trial's weights and data from the run's --seed"),
]
# G's own cut: its length, for the whole script's time (its validation every
# 100 steps kept; the learning-rate schedule does not depend on the length)
HF_GPT2_CUTS = [
    ("searcher.max_length", {"batches": 500}, {"batches": 200},
     "200 steps, a validation at 100 and 200: the whole script's time"),
]
# GPT-2's leaves: wte, wpe, ln_f's two and 12 a layer (the head is tied to
# wte); BERT's: 5 embedding leaves, 16 a layer, the pooler's 2 and the
# classifier's 2
HF_GPT2_LEAVES = 4 + 12 * 12
# G's second run: tests/test_transformer.py::test_hf_gpt2_trial_learns's
# hparams and bar (validation loss below 0.8 ln(vocab) after 40 steps), on
# the card through the port's trial.  const.yaml's GPT-2 base run does not
# reach that bar in its 500 steps, nor in G's 200 (PERF.md §6; whether the JAX trial does at
# this size is not known: no run of it at GPT-2 base is in the repo): it is
# held to falling at every validation and ending below ln(vocab), the
# uniform prediction, and the bar is printed; that the port computes the
# JAX trial's function at this size is held by P's gpt2_base part on the
# card and by tests/test_torch_hf_gpt2.py at GPT-2 base's width on the CPU
HF_GPT2_LEARN_HP = dict(lr=2e-3, global_batch_size=32, seq_len=32, vocab_size=128,
                        hidden_size=64, num_layers=1, num_heads=2, dataset_size=256,
                        warmup_steps=2)
HF_GPT2_LEARN_STEPS = 40
# N: scripts/bench_bert.py's workload (BERT-base, seq 128, batch 128 on one
# card) with its hparams, 5 warm steps and 30 timed, plain and fused AdamW
HF_NORTH_STAR_HP = dict(lr=5e-5, global_batch_size=128, seq_len=128, vocab_size=30522,
                        hidden_size=768, num_layers=12, num_heads=12, num_labels=4,
                        dataset_size=8 * 128, warmup_steps=10)
HF_NORTH_STAR_LEAVES = 5 + 16 * 12 + 4
HF_NORTH_STAR_WARM = 5
HF_NORTH_STAR_TIMED = 30
# part P, card against CPU: each trial's changes, (trial, hparam, the file's
# value, P's value, why), and every dropout probability set to 0 in a
# smoke-local config (the card's Philox and the CPU's generator draw other
# masks from one seed)
HF_PARITY_STEPS = 3
HF_PARITY_CUTS = [
    ("gpt2_base", "global_batch_size", 32, 2,
     "GPT-2 base at full width and depth: the CPU side takes its f32 steps in seconds"),
    ("gpt2", "num_layers", 12, 2, "2 layers of width 64: the CPU side takes its steps in seconds"),
    ("gpt2", "hidden_size", 768, 64, "the same, in width"),
    ("gpt2", "num_heads", 12, 2, "head dim 32 at width 64"),
    ("gpt2", "global_batch_size", 32, 4, "the same, in batch"),
    ("bert", "num_layers", 4, 2, "2 layers of width 64: the CPU side takes its steps in seconds"),
    ("bert", "hidden_size", 256, 64, "the same, in width"),
    ("bert", "num_heads", 8, 2, "head dim 32 at width 64"),
    ("bert", "global_batch_size", 64, 4, "the same, in batch"),
]
HF_NO_DROPOUT = {"gpt2": dict(attn_pdrop=0.0, resid_pdrop=0.0, embd_pdrop=0.0),
                 "bert": dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)}
# P's parts: (part, family, the file whose hparams it cuts)
HF_PARITY_PARTS = (("gpt2", "gpt2"), ("gpt2_base", "gpt2"), ("bert", "bert"))

# phase 14: examples/transformer_lm/moe_ep.yaml as a dict (a CPU test holds
# it to the file), then its cuts for M: (key, the file's value, this run's
# value, why)
MOE_EP_CONST = {
    "name": "lm-moe-ep",
    "entrypoint": "model_def:Trial",
    "hyperparameters": dict(
        lr=0.0003, global_batch_size=32, seq_len=2048, vocab_size=32768, d_model=2048,
        n_layers=16, n_heads=16, dataset_size=65536, bf16=True, attention="flash",
        moe_experts=8, moe_every=2, moe_aux_weight=0.01,
    ),
    "resources": {"mesh": {"data": 2, "fsdp": 2, "expert": 8}},
    "searcher": {"name": "single", "metric": "validation_loss",
                 "max_length": {"batches": 10000}},
    "min_validation_period": {"batches": 500},
    "checkpoint_storage": {"type": "shared_fs", "host_path": "/tmp/dtpu-checkpoints"},
}
MOE_CUTS = [
    ("resources.mesh", {"data": 2, "fsdp": 2, "expert": 8}, None,
     "the card's machine has one H100: M runs without a mesh, W as a world of one"),
    ("global_batch_size", 32, 8, "one rank's share of the batch: 32 / (data 2 x fsdp 2)"),
    ("n_layers", 16, 4,
     "2 MoE blocks: the f32 params, grads and both AdamW moments of 16 layers (~4.3B params) "
     "do not fit 80 GB"),
    ("dataset_size", 65536, 64,
     "25 steps of 8 read 200 samples; the validation pass reads its 8 batches"),
]
MOE_STEPS = 25
MOE_REPORT = 5
MOE_GROUP = 4096  # models/moe.py's group_size, the JAX layer's default
MOE_W_STEPS = 5
# W's checkpoint round trip at a small width: the full-width state is 13 GB
MOE_W_CKPT_CUTS = [
    ("d_model", 2048, 256, "the round trip, not the size, is what W's checkpoint shows"),
    ("n_heads", 16, 2, "head dim 128 at width 256"),
    ("n_layers", 4, 2, "one dense and one MoE block"),
    ("vocab_size", 32768, 4096, "the same, in the head"),
    ("seq_len", 2048, 256, "the same, in length"),
]

# phase 15: examples/transformer_lm/fsdp_tp_sp.yaml as a dict (a CPU test
# holds it to the file), then its cuts for L: (key, the file's value, this
# run's value, why)
SEQ_CONST = {
    "name": "lm-fsdp-tp-sp",
    "entrypoint": "model_def:Trial",
    "hyperparameters": dict(
        lr=0.0003, global_batch_size=32, seq_len=32768, vocab_size=32768, d_model=4096,
        n_layers=32, n_heads=32, n_kv_heads=8, dataset_size=65536, bf16=True, attention="ring",
        remat=True,
    ),
    "resources": {"mesh": {"fsdp": 4, "tensor": 4, "seq": 2}, "single_slice": True},
    "searcher": {"name": "single", "metric": "validation_loss",
                 "max_length": {"batches": 10000}},
    "min_validation_period": {"batches": 500},
    "min_checkpoint_period": {"batches": 1000},
    "optimizations": {"aggregation_frequency": 4},
    "checkpoint_storage": {"type": "shared_fs", "host_path": "/tmp/dtpu-checkpoints"},
}
SEQ_CUTS = [
    ("resources.mesh", {"fsdp": 4, "tensor": 4, "seq": 2}, None,
     "the card's machine has one H100: L runs without a mesh (mesh_smoke.py runs the tensor "
     "and seq meshes on four)"),
    ("n_layers", 32, 4,
     "the f32 params, grads and both AdamW moments of 32 layers (8.05B params x 16 B = "
     "128.9 GB) do not fit 80 GB; 4 layers are 1.24B params, 19.9 GB"),
    ("global_batch_size", 32, 1, "one sequence of 32,768 tokens a microbatch"),
    ("optimizations.aggregation_frequency", 4, 1, "one microbatch a step"),
    ("dataset_size", 65536, 8, "10 steps of 1 wrap its 8 samples; the validation pass reads its 8"),
    ("warmup_steps", None, 10,
     "the file sets none (LMTrial's 100): a few steps inside a 100-step warm-up move the loss "
     "less than its noise (6 steps on the card: 10.894 -> 10.900); bench.py warms up "
     "over 10"),
]
SEQ_STEPS = 10
SEQ_REPORT = 2
# the ring's shapes: fsdp_tp_sp.yaml's attention (32 heads of 128, 8 kv
# heads) over its whole sequence, R's rings, and the length at which the
# plain version (its [32, S, S] f32 scores) still fits the card
SEQ_RING_NS = (2, 4)
SEQ_PLAIN_LEN = 4096
# ring against the whole-sequence kernels, both bf16: each block's out is
# rounded to bf16 before the f32 merge and the merged out once more, where
# the whole kernel rounds once; dq sums up to 2n + 1 bf16 block gradients
# in f32, dk/dv travel in f32 and are rounded once.  A few bf16 ulps (2^-8
# relative): the kernels' own bf16 rtol (KERNEL_TOL, BWD_TOL).  out's atol
# is absolute, so it is cut to the size of the values: over 32,768 random
# keys most rows' |out| is about 0.013, and 2e-3 still passes a one-ulp
# difference at |out| up to 0.5 (2^-9 there) but fails a dropped or
# misweighted block.  Against the plain version in f32 the ring's out is
# held, like the whole kernel's, to the kernel's own bf16 tolerance
SEQ_RING_TOL = dict(out=dict(KERNEL_TOL["bfloat16"]["out"], atol=2e-3),
                    grad=BWD_TOL["bfloat16"])
# K's rows: (label, sequence, causal): a half-chunk of the n = 2 zigzag
# ring (its diagonal and its full blocks) and the whole sequence
SEQ_KERNEL_SHAPES = (("half_chunk_causal", 8192, True), ("half_chunk_full", 8192, False),
                     ("whole_causal", 32768, True))

PIPE_CONST = {
    "name": "lm-pipeline",
    "entrypoint": "model_def:Trial",
    "hyperparameters": dict(
        lr=0.0003, global_batch_size=64, seq_len=2048, vocab_size=32768, d_model=2048,
        n_layers=16, n_heads=16, dataset_size=65536, bf16=True, attention="flash", remat=True,
        pipe_microbatches=8,
    ),
    "resources": {"mesh": {"pipe": 4, "data": 2, "fsdp": 2}},
    "searcher": {"name": "single", "metric": "validation_loss",
                 "max_length": {"batches": 10000}},
    "min_validation_period": {"batches": 500},
    "min_checkpoint_period": {"batches": 1000},
    "checkpoint_storage": {"type": "shared_fs", "host_path": "/tmp/dtpu-checkpoints"},
}
PIPE_CUTS = [
    ("resources.mesh", {"pipe": 4, "data": 2, "fsdp": 2}, None,
     "the card's machine has one H100: the 4 stages run on a VirtualPipe of 4 on it "
     "(train.init(virtual_pipe=4)); mesh_smoke.py P runs pipe 4 and pipe 2 x fsdp 2 on four"),
    ("global_batch_size", 64, 16,
     "one pipe group's share: data 2 x fsdp 2 give each pipe group 64 / 4 = 16 sequences"),
    ("dataset_size", 65536, 48, "3 steps of 16; the validation pass reads its 3 batches"),
    ("warmup_steps", None, 1,
     "the file sets none (LMTrial's 100): 3 steps inside a 100-step warm-up update at lr <= "
     "6e-6, too little for the updates to be compared"),
]
PIPE_STEPS = 3
PIPE_SCHEDULES = (("gpipe", 1), ("1f1b", 1), ("interleaved", 2))
PIPE_BUBBLE = {"gpipe": 3 / 11, "1f1b": 3 / 11, "interleaved": 3 / 19}
# the same microbatches through the same kernels at the same shapes; what
# may differ is the order in which each stage sums its microbatches'
# gradients in f32 (gpipe and interleaved: reversed), and with it the next
# steps' bf16 activations.  The bf16 tolerance of a loss, and 2% of the
# updates' norm (measured on an NVIDIA H100 80GB HBM3 at 700 W: equal
# losses, updates within 5e-9 of U's)
PIPE_TOL = dict(loss=dict(rtol=2e-3, atol=2e-3), update_rel=2e-2)
PIPE_MB_SHAPE = (2, 16, 2048, 128)  # a microbatch's attention: [b, h, s, d]

PHASES = ("kernel", "serve", "parity", "train", "train_parity", "experiment", "search",
          "observe", "knobs", "serve_ckpt", "models", "hf", "moe", "seq", "gang", "cluster",
          "pipe", "fleet", "overlap")
OVERLAP_BUCKET_MB = 4  # optimizations.overlap_bucket_mb's default
OVERLAP_MESHES = (("data4", {"data": 4}, False), ("dcn2_data2_flat", {"dcn": 2, "data": 2}, False),
                  ("dcn2_data2_hier", {"dcn": 2, "data": 2}, True))


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def device_time_us(fn, reps: int = 20, trials: int = 7) -> float:
    """Median device time of one call, from CUDA events around ``reps``
    back-to-back calls.  A sleep kernel queued first keeps the card busy
    while the host enqueues, so host overhead stays out of the reading."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / reps)
    return statistics.median(times)


def attention_bound_us(b, h, hkv, sq, sk, d, dtype_name, causal, *, products, q_side,
                       kv_side, rows):
    """Least time for the card: every input read once, every output written
    once (``q_side`` tensors of [b, h, sq, d], ``kv_side`` of [b, hkv, sk, d],
    ``rows`` f32 [b, h, sq] rows such as lse), against the operations that
    ``products`` matrix products over the pairs this mask keeps need.
    Returns (bound in us, "bytes" or "operations", the operations)."""
    elem = 2 if dtype_name == "bfloat16" else 4
    nbytes = elem * d * (q_side * b * h * sq + kv_side * b * hkv * sk) + 4 * rows * b * h * sq
    if causal:
        pairs = sum(min(i + 1, sk) for i in range(sq))
    else:
        pairs = sq * sk
    flops = 2.0 * products * b * h * d * pairs
    t_bytes = nbytes / PEAK_BYTES
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e6, ("bytes" if t_bytes >= t_ops else "operations"), flops


def timed_row(kernel_us, plain_us, library_us, bound_us, bound_by, flops) -> dict:
    """A kernel's timed fields of the kernels line: times in ms (the plain
    version's None where it does not fit the card), the share of its bound
    it reaches (bound / time) and its achieved TFLOP/s."""
    return dict(ms=kernel_us / 1e3, plain_ms=None if plain_us is None else plain_us / 1e3,
                bound_ms=bound_us / 1e3,
                bound_by=bound_by, library_ms=library_us / 1e3,
                bound_share=bound_us / kernel_us, tflops=flops / kernel_us / 1e6)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------


def _dname(dtype) -> str:
    return str(dtype).split(".")[-1]


def _max_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def build_kernels() -> None:
    """Build every kernel source at once (one nvcc each, in parallel),
    print each one's register and spill lines, and fail if a kernel of
    PTXAS_CLEAN spilled or had its wgmmas serialised."""
    from determined_tpu_torch.ops import _build

    t0 = time.monotonic()
    _build.build_all(list(KERNEL_SOURCES))
    log(f"kernel build: {time.monotonic() - t0:.1f} s ({', '.join(KERNEL_SOURCES)})")
    for source in KERNEL_SOURCES:
        _build.load(source)
        report = _build.ptxas_report(source) or ""
        for line in report.splitlines():
            if any(w in line for w in ("registers", "spill", "Compiling entry", "setmaxnreg",
                                       "wgmma", "Performance", "warning")):
                log(f"  ptxas {source}: {line.strip()}")
        if source in PTXAS_CLEAN:
            kernel, instances = PTXAS_CLEAN[source]
            seen = sum("Compiling entry" in line and kernel in line for line in report.splitlines())
            assert seen == instances, f"ptxas report of {source} shows {seen} {kernel} instances"
            faults = _build.ptxas_faults(report, kernel)
            assert not faults, f"ptxas spilled or serialised {kernel}: {faults}"


def check_flash_fwd(seed: int) -> dict:
    """flash_fwd against its plain version on every forward case (bf16: the
    launch's own tile and both tiles forced), timed at the serving shape and
    at the training shape."""
    import torch
    import torch.nn.functional as F

    import determined_tpu_torch.ops.flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    result = {}
    worst = 0.0
    for name, b, h, hkv, s, d, dname, causal in ATTN_CASES_SPEC:
        dtype = getattr(torch, dname)
        q = torch.randn((b, h, s, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
        ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal=causal)
        tol = KERNEL_TOL[dname]
        # bf16: the launch's own tile (0) and both tiles forced
        for rows in fa.FWD_BLOCK_ROWS if dname == "bfloat16" else (0,):
            if rows == 0:
                out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
            else:
                out, lse = fa._launch_kernel(q, k, v, causal, d ** -0.5, rows)
            torch.cuda.synchronize()
            err_out, err_lse = _max_err(out, ref_out), _max_err(lse, ref_lse)
            log(f"flash_fwd case {name}: [{b},{h}/{hkv},{s},{d}] {dname} causal={causal} "
                f"block_rows={rows or 'auto'} max_abs_err out={err_out:.3e} lse={err_lse:.3e}")
            torch.testing.assert_close(out.float(), ref_out.float(), **tol["out"],
                                       msg=lambda m, rows=rows: f"flash_fwd rows={rows}: {m}")
            torch.testing.assert_close(lse, ref_lse, **tol["lse"])
            worst = max(worst, err_out)
        if name not in ("serving", "training"):
            continue
        by_rows = {
            rows: device_time_us(lambda rows=rows: fa._launch_kernel(q, k, v, True, d ** -0.5, rows))
            for rows in fa.FWD_BLOCK_ROWS
        }
        plain_us = device_time_us(lambda: fa.flash_attention_fwd_reference(q, k, v, causal=True))
        library_us = device_time_us(
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)
        )
        bound_us, bound_by, flops = attention_bound_us(
            b, h, hkv, s, s, d, dname, causal, products=2, q_side=2, kv_side=2, rows=1
        )
        kernel_us = by_rows[0]
        log(f"flash_fwd at the {name} shape [{b},{h},{s},{d}] {dname} causal: "
            f"kernel_us={kernel_us:.2f} (block_rows 64: {by_rows[64]:.2f}, 128: "
            f"{by_rows[128]:.2f}) plain_us={plain_us:.2f} library_us={library_us:.2f} "
            f"bound_us={bound_us:.2f} ({bound_by}) bound_share={bound_us / kernel_us:.3f} "
            f"tflops={flops / kernel_us / 1e6:.1f}")
        times = timed_row(kernel_us, plain_us, library_us, bound_us, bound_by, flops)
        times.update(block64_ms=by_rows[64] / 1e3, block128_ms=by_rows[128] / 1e3)
        if name == "serving":
            result.update(times)
        else:
            result.update({f"train_shape_{k}": v for k, v in times.items()})
    result["max_abs_err"] = worst
    return result


def check_flash_bwd(seed: int) -> dict:
    """flash_bwd's dq and dk/dv kernels against the plain backward on every
    attention case, timed at the training shape beside the plain version,
    the bound and the SDPA backward."""
    import torch
    import torch.nn.functional as F

    import determined_tpu_torch.ops.flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    rows = {"flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    worst = {"flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for name, b, h, hkv, s, d, dname, causal in ATTN_CASES_SPEC:
        dtype = getattr(torch, dname)
        q = torch.randn((b, h, s, d), generator=gen, device="cuda").to(dtype)
        k = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
        v = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(dtype)
        do = torch.randn((b, h, s, d), generator=gen, device="cuda").to(dtype)
        out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal=causal)
        torch.cuda.synchronize()
        tol = BWD_TOL[dname]
        errs = {}
        for grad, g_, w_ in zip(("dq", "dk", "dv"), got, want):
            assert g_.shape == w_.shape and g_.dtype == w_.dtype, (grad, g_.shape, w_.shape)
            scale_ = w_.float().abs().max().item()
            errs[grad] = _max_err(g_, w_)
            torch.testing.assert_close(
                g_.float(), w_.float(), rtol=tol["rtol"], atol=tol["atol"] * scale_,
                msg=lambda m, grad=grad: f"flash_bwd {grad} case {name}: {m}",
            )
        log(f"flash_bwd case {name}: [{b},{h}/{hkv},{s},{d}] {dname} causal={causal} "
            + " ".join(f"max_abs_err {g}={e:.3e}" for g, e in errs.items()))
        worst["flash_bwd_dq"] = max(worst["flash_bwd_dq"], errs["dq"])
        worst["flash_bwd_dkv"] = max(worst["flash_bwd_dkv"], errs["dk"], errs["dv"])
        if name != "training":
            continue
        delta = fa._delta(out, do)
        dq_us = device_time_us(lambda: fa._launch_dq(q, k, v, do, lse, delta, True, d ** -0.5))
        dkv_us = device_time_us(lambda: fa._launch_dkv(q, k, v, do, lse, delta, True, d ** -0.5))
        plain_us = device_time_us(
            lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal=True), reps=5
        )
        # library yardstick: SDPA forward + backward minus its forward
        qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
        sdpa_fwd_us = device_time_us(
            lambda: F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        )
        sdpa_both_us = device_time_us(lambda: torch.autograd.grad(
            F.scaled_dot_product_attention(qg, kg, vg, is_causal=True), (qg, kg, vg), do
        ))
        library_us = sdpa_both_us - sdpa_fwd_us
        # dq reads q, do, k, v, lse, delta and writes dq; dkv writes dk, dv
        for row, kernel_us, products, q_side, kv_side in (
            ("flash_bwd_dq", dq_us, 3, 3, 2), ("flash_bwd_dkv", dkv_us, 4, 2, 4),
        ):
            bound_us, bound_by, flops = attention_bound_us(
                b, h, hkv, s, s, d, dname, causal, products=products, q_side=q_side,
                kv_side=kv_side, rows=2,
            )
            rows[row] = timed_row(kernel_us, plain_us, library_us, bound_us, bound_by, flops)
            log(f"{row} at the training shape [{b},{h},{s},{d}] {dname} causal: "
                f"kernel_us={kernel_us:.2f} plain_us(whole bwd)={plain_us:.2f} "
                f"library_us(SDPA bwd)={library_us:.2f} bound_us={bound_us:.2f} ({bound_by}) "
                f"bound_share={rows[row]['bound_share']:.3f} tflops={rows[row]['tflops']:.1f}")
    for row in rows:
        rows[row]["max_abs_err"] = worst[row]
    return rows


def adamw_bound_us(n: int, mu_bytes: int) -> tuple:
    """The least time of one AdamW leaf of ``n`` elements: p, v and g read,
    p and v written (f32), m read and written (``mu_bytes`` each), the four
    scalars read, against ADAMW_FLOPS_PER_ELEMENT f32 operations an element.
    Returns (bytes, bound in us, "bytes" or "operations")."""
    nbytes = n * (3 * 4 + 2 * mu_bytes + 2 * 4) + 16
    t_bytes = nbytes / PEAK_BYTES
    t_ops = ADAMW_FLOPS_PER_ELEMENT * n / PEAK_FLOPS["float32"]
    return nbytes, max(t_bytes, t_ops) * 1e6, ("bytes" if t_bytes >= t_ops else "operations")


def check_fused_adamw(seed: int) -> dict:
    """fused_adamw against its plain version on flagship leaves and ragged
    tails, timed on a [2048, 8192] SwiGLU leaf with a bf16 first moment."""
    import torch

    from determined_tpu_torch.ops import fused_adamw as fw

    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    hyper = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.01)
    # step 3 of a warmed-up run, the clip active
    scalars = torch.tensor([3e-4, 0.5, 1 - 0.9 ** 3, 1 - 0.999 ** 3], device="cuda")
    worst = 0.0
    result = {}
    for shape, mu_name in ADAMW_CASES_SPEC:
        mu_dtype = getattr(torch, mu_name)
        p = torch.randn(shape, generator=gen, device="cuda")
        g = torch.randn(shape, generator=gen, device="cuda")
        m = (0.1 * torch.randn(shape, generator=gen, device="cuda")).to(mu_dtype)
        v = 0.01 * torch.rand(shape, generator=gen, device="cuda")
        want = fw._leaf_reference(p, m, v, g, scalars, **hyper)
        got = [p.clone(), m.clone(), v.clone()]
        fw.adamw_leaf_(*got[:3], g, scalars, **hyper)
        torch.cuda.synchronize()
        errs = [_max_err(a, b_) for a, b_ in zip(got, want)]
        log(f"fused_adamw case {list(shape)} mu={_dname(mu_dtype)}: max_abs_err "
            f"p={errs[0]:.3e} m={errs[1]:.3e} v={errs[2]:.3e}")
        for what, a, b_ in zip("pmv", got, want):
            tol = ADAMW_TOL[_dname(b_.dtype)]
            torch.testing.assert_close(a.float(), b_.float(), **tol,
                                       msg=lambda m_, what=what: f"fused_adamw {what}: {m_}")
        worst = max(worst, *errs)
        if (shape, mu_name) != ADAMW_TIMED:
            continue
        kernel_us = device_time_us(lambda: fw.adamw_leaf_(p, m, v, g, scalars, **hyper))
        plain_us = device_time_us(lambda: fw._leaf_reference(p, m, v, g, scalars, **hyper))
        lib_p = torch.nn.Parameter(p.clone())
        lib_p.grad = g.clone()
        lib_opt = torch.optim.AdamW([lib_p], lr=3e-4, weight_decay=0.01, fused=True)
        library_us = device_time_us(lib_opt.step)
        n = p.numel()
        nbytes, bound_us, bound_by = adamw_bound_us(n, m.element_size())
        result = timed_row(kernel_us, plain_us, library_us, bound_us, bound_by,
                           ADAMW_FLOPS_PER_ELEMENT * n)
        log(f"fused_adamw on {list(shape)} mu={_dname(mu_dtype)} ({nbytes / 1e6:.1f} MB): "
            f"kernel_us={kernel_us:.2f} plain_us={plain_us:.2f} "
            f"library_us(torch AdamW fused)={library_us:.2f} bound_us={bound_us:.2f} ({bound_by}) "
            f"bound_share={result['bound_share']:.3f} tflops={result['tflops']:.3f}")
    result["max_abs_err"] = worst
    return result


def phase_kernel(seed: int) -> dict:
    """Every kernel built and held against its plain version; returns the
    measured fields of each kernel's row, keyed by kernel name."""
    build_kernels()
    rows = {"flash_fwd": check_flash_fwd(seed)}
    rows.update(check_flash_bwd(seed))
    rows["fused_adamw"] = check_fused_adamw(seed)
    return rows


# ---------------------------------------------------------------------------
# phase 3: serve the flagship through the HTTP entry point
# ---------------------------------------------------------------------------


def flagship_config(dtype):
    from determined_tpu_torch.models.transformer import TransformerConfig

    return TransformerConfig(
        vocab_size=32768, d_model=2048, n_layers=8, n_heads=16,
        max_seq_len=2048, dtype=dtype,
    )


def serve_config():
    from determined_tpu_torch.serve import ServeConfig

    return ServeConfig(
        block_size=16, max_prompt_len=1024, max_new_tokens=32, max_batch=8,
        num_blocks=640, queue_depth=16,
    )


def make_prompts(seed: int, vocab: int):
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=SHARED_PREFIX).tolist()
    prompts = []
    for i in range(N_REQUESTS):
        if i < N_SHARED:
            n = int(rng.integers(SHARED_PREFIX + 64, 1001))
            prompts.append(prefix + rng.integers(0, vocab, size=n - SHARED_PREFIX).tolist())
        else:
            prompts.append(rng.integers(0, vocab, size=int(rng.integers(64, 1001))).tolist())
    order = rng.permutation(N_REQUESTS)
    return [prompts[i] for i in order]


def post(url: str, path: str, body=None, timeout: float = 600.0):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(
        url + path, data=data, headers={"Content-Type": "application/json"},
        method="GET" if body is None else "POST",
    )
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


def phase_serve(seed: int, model) -> dict:
    import determined_tpu_torch.ops.flash_attention as fa
    from determined_tpu_torch.observability import get_tracer
    from determined_tpu_torch.serve import DecodeKernels, ServeEngine, ServeWorker

    cfg = model.cfg
    scfg = serve_config()
    kernels = DecodeKernels(model, scfg)
    worker = ServeWorker(ServeEngine(kernels))
    url = worker.start()
    try:
        # one short request first: CUDA context, cuBLAS handles, kernel load
        status, _ = post(url, "/v1/generate", {"prompt_tokens": [1, 2, 3], "max_new_tokens": 2})
        assert status == 200
        prompts = make_prompts(seed, cfg.vocab_size)
        base = worker.engine.stats()
        tracer = get_tracer()
        tracer.reset()
        fa.reset_launches()  # counts from here on are the main path's
        t0 = time.monotonic()
        with concurrent.futures.ThreadPoolExecutor(len(prompts)) as pool:
            futs = [
                pool.submit(post, url, "/v1/generate",
                            {"prompt_tokens": p, "max_new_tokens": scfg.max_new_tokens,
                             "temperature": 0.0})
                for p in prompts
            ]
            responses = [f.result() for f in futs]
        wall = time.monotonic() - t0
        launches = fa.launches
        stats = worker.engine.stats()
        assert post(url, "/healthz")[1]["status"] == "ok"
        assert post(url, "/stats")[1]["completed"] == stats["completed"]
    finally:
        worker.shutdown()

    for (status, body), prompt in zip(responses, prompts):
        assert status == 200, body
        toks = body["tokens"]
        assert len(toks) == scfg.max_new_tokens, body
        assert all(0 <= t < cfg.vocab_size for t in toks)
        assert body["usage"]["prompt_tokens"] == len(prompt)
    hits = stats["prefix_hits"] - base["prefix_hits"]
    cold = len(prompts) - hits
    assert hits >= 1, "no request took the warm prefix-cache path"
    assert launches == cfg.n_layers * cold, (
        f"flash_fwd launched {launches} times for {cold} cold prefills of "
        f"{cfg.n_layers} layers"
    )
    generated = sum(len(b["tokens"]) for _, b in responses)
    decode_s = _span_seconds(tracer, "serve.decode")
    prefill = _spans(tracer, "serve.prefill")
    cold_s = [s[1] for s in prefill if not s[2]["cached_tokens"]]
    warm_s = [s[1] for s in prefill if s[2]["cached_tokens"]]
    summary = dict(
        requests=len(prompts),
        generated_tokens=generated,
        tokens_per_s=generated / wall,
        mean_ttft_ms=statistics.mean(b["ttft_ms"] for _, b in responses),
        mean_latency_ms=statistics.mean(b["latency_ms"] for _, b in responses),
        decode_steps=len(decode_s),
        mean_decode_step_ms=1e3 * statistics.mean(decode_s),
        mean_cold_prefill_ms=1e3 * statistics.mean(cold_s),
        mean_warm_prefill_ms=1e3 * statistics.mean(warm_s),
        cold_prefills=cold,
        warm_prefills=hits,
        flash_launches=launches,
        wall_s=wall,
    )
    log("serve: " + json.dumps(summary))
    profile_decode(kernels)
    return dict(summary=summary, launches=launches, kernels=kernels, prompts=prompts)


def profile_decode(kernels, steps: int = 3) -> dict:
    """Device-busy share of full decode steps: every lane at position 1000
    (the longest chunk walk the smoke prompts reach), traced with
    torch.profiler.  Tracing adds host time, so the share is a lower bound
    of the untraced one."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    scfg = kernels.serve_cfg
    lanes, width = scfg.max_batch, scfg.blocks_per_seq
    tokens = np.ones(lanes, np.int64)
    positions = np.full(lanes, 1000, np.int64)
    tables = 1 + np.arange(lanes * width, dtype=np.int64).reshape(lanes, width)
    kernels.decode(tokens, positions, tables)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for _ in range(steps):
            kernels.decode(tokens, positions, tables)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    cuda = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in cuda)
    out = dict(
        traced_step_ms=wall_us / steps / 1e3,
        device_ms_per_step=device_us / steps / 1e3,
        device_busy_share=device_us / wall_us,
        device_ops_per_step=sum(e.count for e in cuda) / steps,
    )
    log("decode profile (8 lanes at position 1000): " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 4: serving-path logits against the full forward
# ---------------------------------------------------------------------------


def check_parity(model, kernels, prompts, dtype_name: str) -> None:
    import torch

    tol = PARITY_TOL[dtype_name]
    scfg = kernels.serve_cfg
    table = list(range(1, 1 + scfg.blocks_per_seq))
    lanes = scfg.max_batch
    for prompt in prompts:
        seq = list(prompt)
        got = kernels.prefill(seq, table)
        worst = 0.0
        for step in range(4):
            with torch.no_grad():
                ref = model(torch.tensor([seq], device="cuda"))[0, -1].cpu().numpy()
            err = float(np.abs(got - ref).max())
            worst = max(worst, err)
            np.testing.assert_allclose(got, ref, **tol)
            tok = int(np.argmax(got))
            top2 = np.sort(ref)[-2:]
            if top2[1] - top2[0] > tol["atol"] + tol["rtol"] * abs(top2[1]):
                assert tok == int(np.argmax(ref)), f"greedy token differs at step {step}"
            if step == 3:
                break
            seq.append(tok)
            tokens = np.zeros(lanes, np.int64)
            positions = np.full(lanes, -1, np.int64)
            tables = np.zeros((lanes, scfg.blocks_per_seq), np.int64)
            tokens[0], positions[0], tables[0] = tok, len(seq) - 1, table
            got = kernels.decode(tokens, positions, tables)[0]
        log(f"parity {dtype_name}: prompt of {len(prompt)} tokens, prefill + 3 decode "
            f"steps, max_abs_err={worst:.3e} (tol {tol})")


def phase_parity(model, kernels, prompts) -> None:
    import torch

    from determined_tpu_torch.models.transformer import TransformerLM
    from determined_tpu_torch.serve import DecodeKernels

    # full-f32 products on both sides: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    picks = [max(prompts, key=len), min(prompts, key=len)]
    check_parity(model, kernels, picks, "bfloat16")
    model32 = TransformerLM(flagship_config(torch.float32), generator=torch.Generator("cuda"))
    model32.load_state_dict(model.state_dict())
    kernels32 = DecodeKernels(model32, dataclasses.replace(serve_config(), num_blocks=160))
    check_parity(model32, kernels32, picks, "float32")


# ---------------------------------------------------------------------------
# phase 5: train the flagship through Trainer(LMTrial).fit
# ---------------------------------------------------------------------------


def _launch_counts() -> dict:
    import determined_tpu_torch.ops.flash_attention as fa
    from determined_tpu_torch.ops import fused_adamw as fw

    return dict(flash_fwd=fa.launches, flash_bwd_dq=fa.launches_bwd_dq,
                flash_bwd_dkv=fa.launches_bwd_dkv, fused_adamw=fw.launches)


def _reset_launches() -> None:
    import determined_tpu_torch.ops.flash_attention as fa
    from determined_tpu_torch.ops import fused_adamw as fw

    fa.reset_launches()
    fw.reset_launches()


def phase_train(seed: int) -> dict:
    """The bench.py workload through init -> Trainer(LMTrial).fit."""
    import torch

    from determined_tpu_torch import train
    from determined_tpu_torch.models import LMTrial

    hp = dict(TRAIN_HPARAMS)
    ctx = train.init(hparams=hp, seed=seed)
    trial = LMTrial(ctx)
    trainer = train.Trainer(trial)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()  # counts from here on are the training path's
    t0 = time.monotonic()
    summary = trainer.fit(
        max_length=TRAIN_STEPS, report_period=TRAIN_REPORT, validation_period=TRAIN_STEPS,
        checkpoint_policy="none",
    )
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30

    reports = ctx.core.train.metrics("training")
    gbs, seq = hp["global_batch_size"], hp["seq_len"]
    assert [step for step, _ in reports] == list(range(TRAIN_REPORT, TRAIN_STEPS + 1, TRAIN_REPORT))
    # every report covers TRAIN_REPORT steps; the first holds the warm-up
    step_ms = [1e3 * gbs / m["samples_per_second"] for _, m in reports]
    timed = step_ms[1:]
    mean_step_ms = statistics.mean(timed)
    tokens_per_s = gbs * seq / (mean_step_ms / 1e3)
    mfu = trial.flops_per_token * tokens_per_s / PEAK_FLOPS["bfloat16"]
    first_loss, last_loss = reports[0][1]["loss"], reports[-1][1]["loss"]
    val_loss = summary["validation_metrics"]["validation_loss"]
    for name, x in (("first", first_loss), ("last", last_loss), ("validation", val_loss)):
        assert np.isfinite(x), f"{name} loss is not finite: {x}"
    assert last_loss < first_loss, f"loss did not fall: {first_loss} -> {last_loss}"

    n_leaves = len(trainer._params)
    n_val = trainer.val_loader.batches_per_epoch
    layers = trial._cfg().n_layers
    want = dict(
        flash_fwd=layers * (TRAIN_STEPS + n_val),
        flash_bwd_dq=layers * TRAIN_STEPS,
        flash_bwd_dkv=layers * TRAIN_STEPS,
        fused_adamw=n_leaves * TRAIN_STEPS,
    )
    assert n_leaves == 75, n_leaves
    assert launches == want, f"launches {launches} != expected {want}"
    out = dict(
        card=card_line(),  # the metrics below hold for this card and power limit
        steps=summary["steps_completed"], wall_s=wall,
        step_ms_per_report=step_ms, mean_step_ms_last_20=mean_step_ms,
        tokens_per_s=tokens_per_s, flops_per_token=trial.flops_per_token,
        mfu_vs_989_tflops=mfu, first_report_loss=first_loss, last_report_loss=last_loss,
        validation_loss=val_loss, peak_memory_gib=peak_gib, launches=launches,
        losses=[m["loss"] for _, m in reports],
    )
    log("train: " + json.dumps(out))
    out["profile"] = profile_train(trainer)
    return out


def profile_train(trainer, steps: int = 3, label: str = "train") -> dict:
    """Device time by kernel group over ``steps`` training steps, traced
    with torch.profiler and folded by the package's op table
    (``determined_tpu_torch/utils/kineto.py``), and the device-busy share of
    the traced window (tracing adds host time, so the share is a lower
    bound of the untraced one)."""
    import os
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    from determined_tpu_torch.data import to_device
    from determined_tpu_torch.utils import kineto

    it = iter(trainer.train_loader)
    batches = [to_device(next(it), trainer.device) for _ in range(steps + 1)]
    trainer._train_step(batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for b in batches[1:]:
            trainer._train_step(b)
        torch.cuda.synchronize()
        wall_us = (time.monotonic() - t0) * 1e6
    with tempfile.TemporaryDirectory(prefix="dtt-chip-profile-") as d:
        path = os.path.join(d, "train.pt.trace.json")
        prof.export_chrome_trace(path)
        ops = kineto.op_table([path])
    groups = kineto.category_totals(ops)
    device_us = sum(groups.values())
    out = dict(
        traced_step_ms=wall_us / steps / 1e3,
        device_ms_per_step=device_us / steps / 1e3,
        device_busy_share=device_us / wall_us,
        device_ops_per_step=sum(op["count"] for op in ops) / steps,
        device_ms_per_step_by_group={k: v / steps / 1e3 for k, v in groups.items()},
        launches_per_step_by_group={
            k: v / steps for k, v in kineto.category_counts(ops).items()
        },
        top_kernels_ms_per_step=[
            [op["name"][:90], op["time_us"] / steps / 1e3, op["count"] // steps]
            for op in ops[:12]
        ],
    )
    log(f"{label} profile ({steps} steps): " + json.dumps(out))
    out["ops"] = ops  # the whole table, for callers that look rows up
    return out


# ---------------------------------------------------------------------------
# phase 6: the training step on the card against the plain versions on the CPU
# ---------------------------------------------------------------------------


def phase_train_parity(seed: int) -> dict:
    """A 2-layer f32 LM trains TRAIN_PARITY_STEPS steps on the card, through
    the kernels, and on the CPU, through the plain versions, from the same
    weights and batches."""
    import torch

    from determined_tpu_torch import train
    from determined_tpu_torch.data import to_device
    from determined_tpu_torch.models import LMTrial

    # full-f32 products on both sides: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    trainers = {}
    for dev in ("cuda", "cpu"):
        t = train.Trainer(LMTrial(train.init(hparams=TRAIN_PARITY_HPARAMS, seed=seed, device=dev)))
        t._setup()
        trainers[dev] = t
    card, host = trainers["cuda"], trainers["cpu"]
    host.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
    start = {k: v.detach().cpu().clone() for k, v in host.model.state_dict().items()}
    _reset_launches()
    losses = {"cuda": [], "cpu": []}
    its = {dev: iter(t.train_loader) for dev, t in trainers.items()}
    for _ in range(TRAIN_PARITY_STEPS):
        batches = {dev: next(it) for dev, it in its.items()}
        np.testing.assert_array_equal(batches["cuda"]["tokens"], batches["cpu"]["tokens"])
        for dev, t in trainers.items():
            t._train_step(to_device(batches[dev], t.device))
            losses[dev].append(t.state.fetch_metrics()["loss"])
            t.state.reset_metrics()
    launches = _launch_counts()
    assert all(launches[k] > 0 for k in launches), launches

    tol = TRAIN_PARITY_TOL
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], **tol["loss"])

    def rel(a, b) -> float:
        return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-30))

    upd_err = max(
        rel(card.model.state_dict()[k].cpu() - start[k], host.model.state_dict()[k] - start[k])
        for k in start
    )
    mu_err = max(rel(card.state.opt_state.mu[k].cpu(), host.state.opt_state.mu[k]) for k in start)
    nu_err = max(rel(card.state.opt_state.nu[k].cpu(), host.state.opt_state.nu[k]) for k in start)
    out = dict(losses_card=losses["cuda"], losses_cpu=losses["cpu"],
               max_rel_update_err=upd_err, max_rel_mu_err=mu_err, max_rel_nu_err=nu_err,
               launches=launches)
    log("train parity (card kernels vs CPU plain versions): " + json.dumps(out))
    assert upd_err <= tol["update_rel"], upd_err
    assert max(mu_err, nu_err) <= tol["moment_rel"], (mu_err, nu_err)
    return out


# ---------------------------------------------------------------------------
# phase 7: the flagship experiment: preemption, resume, crash and restart
# ---------------------------------------------------------------------------


def _apply_cuts(raw: dict, cuts, placeholders: dict) -> dict:
    """A copy of ``raw`` with each cut's value set at its dotted key (a
    placeholder string replaced by this run's value)."""
    raw = json.loads(json.dumps(raw))
    for path, _const, value, _why in cuts:
        *parents, leaf = path.split(".")
        node = raw
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = placeholders.get(value, value) if isinstance(value, str) else value
    return raw


def experiment_raw_config(ckpt_dir: str, seed: int) -> dict:
    """EXPERIMENT_CONST with EXPERIMENT_CUTS applied: checkpoints under
    ``ckpt_dir``, the experiment seed ``seed``."""
    return _apply_cuts(EXPERIMENT_CONST, EXPERIMENT_CUTS, {"<temp dir>": ckpt_dir,
                                                          "<--seed>": seed})


class _StepHook:
    """A fault injector (``utils/faults.py``) that runs ``action`` when the
    ``train.step`` site fires for ``step`` (before that step runs), ``times``
    times."""

    def __init__(self, step: int, action, times: int = 1) -> None:
        self.step, self.action, self.left = step, action, times

    def fire(self, site: str, **info) -> None:
        if site == "train.step" and info.get("step") == self.step and self.left:
            self.left -= 1
            self.action()


class _SimulatedCrash(RuntimeError):
    """Stands in for a worker crash mid-step (a TRANSIENT failure)."""


def _capturing(trial_cls):
    """``trial_cls`` with a callback that keeps the Trainer of each run and
    the time its training started (after any restore), so a phase can read
    its final state and its time to resume."""
    from determined_tpu_torch.train import Callback

    trainers: list = []
    started: list = []

    class Capture(Callback):
        def on_training_start(self, trainer) -> None:
            trainers.append(trainer)
            started.append(time.monotonic())

    class Captured(trial_cls):
        def build_callbacks(self):
            return {"capture": Capture()}

    return Captured, trainers, started


def _spans(tracer, name: str) -> list:
    """(start, seconds, args) of every ``name`` span the tracer holds, by
    start time (seconds from the tracer's epoch)."""
    spans = [(e["ts"] / 1e6, e["dur"] / 1e6, e.get("args") or {})
             for e in tracer.chrome_events() if e["ph"] == "X" and e["name"] == name]
    return sorted(spans, key=lambda s: s[0])


def _span_seconds(tracer, name: str) -> list:
    return [s[1] for s in _spans(tracer, name)]


def _host_steps(tracer) -> dict:
    """Host-clock time of each training step (from its data.wait start to
    the next step's), split by what the asynchronous checkpoint writer was
    doing meanwhile: its copy to the host (``checkpoint.copy``), the rest
    of its write (``torch.save``), or nothing.  Intervals that hold a
    boundary (report, validation, a save) are left out, and so is the first
    step (the warm-up)."""
    starts = [s[0] for s in _spans(tracer, "data.wait")]

    def intervals(*names):
        return [(s[0], s[0] + s[1]) for name in names for s in _spans(tracer, name)]

    copies, writes = intervals("checkpoint.copy"), intervals("checkpoint.write")
    boundaries = intervals("step.boundary_block", "validate", "checkpoint.save",
                           "checkpoint.dispatch", "checkpoint.stall", "checkpoint.finalize")
    steps = {"during_copy": [], "during_save": [], "without_write": []}
    for t0, t1 in zip(starts[1:], starts[2:]):
        if any(a < t1 and t0 < b for a, b in boundaries):
            continue
        if any(a < t1 and t0 < b for a, b in copies):
            steps["during_copy"].append(t1 - t0)
        elif any(a < t1 and t0 < b for a, b in writes):
            steps["during_save"].append(t1 - t0)
        else:
            steps["without_write"].append(t1 - t0)
    out = {}
    for k, v in steps.items():
        out[f"steps_{k}"] = len(v)
        out[f"mean_step_ms_{k}"] = 1e3 * statistics.mean(v) if v else None
    return out


def _dir_bytes(path: str) -> int:
    import os

    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


# a checkpoint directory's manifest verdict, kept while its files keep the
# sizes and mtimes it was checked at: a phase that lists its checkpoints
# again reads only the new ones
_VERDICTS: dict = {}


def _verified(d: str) -> bool:
    from determined_tpu_torch.core import file_stats, verify_manifest

    stats = file_stats(d)
    known = _VERDICTS.get(d)
    if known is not None and known[0] == stats:
        return known[1]
    verdict = verify_manifest(d, require_manifest=True)
    _VERDICTS[d] = (stats, verdict)
    return verdict


def _checkpoint_steps(root: str) -> dict:
    """uuid -> steps_completed of every checkpoint under ``root``, and the
    manifest verdict of each (the directories checked at once, each one
    once while its files are unchanged)."""
    import os

    dirs = {}
    for d, _, files in os.walk(root):
        if "metadata.json" in files:
            with open(os.path.join(d, "metadata.json")) as f:
                dirs[d] = json.load(f)["steps_completed"]
    with concurrent.futures.ThreadPoolExecutor(max(len(dirs), 1)) as pool:
        verdicts = dict(zip(dirs, pool.map(_verified, dirs)))
    return {os.path.basename(d): dict(steps=steps, verified=verdicts[d], bytes=_dir_bytes(d))
            for d, steps in dirs.items()}


def _final_state(trainer) -> dict:
    """A run's final params, moments, step counters, last validation loss
    and loader position, copied to the host."""
    opt = trainer.state.opt_state
    return dict(
        params={k: p.detach().cpu() for k, p in trainer.model.named_parameters()},
        mu={k: v.cpu() for k, v in opt.mu.items()},
        nu={k: v.cpu() for k, v in opt.nu.items()},
        steps=(int(trainer.state.step), int(opt.count)),
        validation_loss=trainer._last_val_metrics["validation_loss"],
        loader=trainer.train_loader.state_dict(),
    )


def _compare_final(name: str, got, want: dict, init_params) -> dict:
    """A run's final state (its trainer) against the reference's
    (``_final_state``) with the train_parity tolerance; each reference
    tensor goes to the device for its comparison only."""
    import torch

    tol = TRAIN_PARITY_TOL
    worst = 0.0
    bitwise = True
    upd_rel = mom_rel = 0.0
    opt = got.state.opt_state
    for k, a in got.model.named_parameters():
        a = a.detach()
        b = want["params"][k].to(a.device)
        bitwise &= torch.equal(a, b)
        worst = max(worst, (a - b).abs().max().item())
        upd = (b - init_params[k].to(b.device)).norm().item()
        upd_rel = max(upd_rel, (a - b).norm().item() / max(upd, 1e-30))
        for which in ("mu", "nu"):
            m_a, m_b = getattr(opt, which)[k], want[which][k].to(a.device)
            bitwise &= torch.equal(m_a, m_b)
            worst = max(worst, (m_a.float() - m_b.float()).abs().max().item())
            mom_rel = max(mom_rel, (m_a.float() - m_b.float()).norm().item()
                          / max(m_b.float().norm().item(), 1e-30))
    steps = (int(got.state.step), int(opt.count)) + want["steps"]
    loss = (got._last_val_metrics["validation_loss"], want["validation_loss"])
    out = dict(max_abs_diff=worst, bitwise=bool(bitwise and loss[0] == loss[1]),
               max_rel_update_diff=upd_rel, max_rel_moment_diff=mom_rel,
               steps=steps, validation_loss=loss,
               loader=(got.train_loader.state_dict(), want["loader"]))
    log(f"experiment {name} vs uninterrupted: " + json.dumps(out))
    assert steps == (EXPERIMENT_STEPS,) * 4, steps
    assert out["loader"][0] == out["loader"][1], out["loader"]
    np.testing.assert_allclose(loss[0], loss[1], **tol["loss"])
    assert upd_rel <= tol["update_rel"], upd_rel
    assert mom_rel <= tol["moment_rel"], mom_rel
    return out


@contextlib.contextmanager
def _device_memory(out: dict, part: str):
    """Device memory allocated when a part starts and at its peak (GiB)."""
    import torch

    gc.collect()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    try:
        yield
    finally:
        out[part] = dict(start_gib=start / 2 ** 30,
                         peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        log(f"experiment {part} device memory: " + json.dumps(out[part]))


_SIGTERM_TRIALS: dict = {}


def sigterm_trial(name: str, at: int):
    """LMTrial whose chief rank SIGTERMs its parent, a gang's driver,
    before step ``at`` (once: a resume starts past it), importable as
    ``<module>:<name>`` through the module's ``__getattr__``."""
    if name not in _SIGTERM_TRIALS:
        import os
        import signal

        from determined_tpu_torch.models import LMTrial
        from determined_tpu_torch.train import Callback
        from determined_tpu_torch.utils import faults

        class SigtermLMTrial(LMTrial):
            def build_callbacks(self):
                dist = self.context.core.distributed

                class Sigterm(Callback):
                    def on_training_start(self, trainer) -> None:
                        if dist.is_chief and trainer.steps_completed < at:
                            faults.set_fault_injector(_StepHook(
                                at, lambda: os.kill(os.getppid(), signal.SIGTERM)))

                return {"sigterm": Sigterm()}

        SigtermLMTrial.__qualname__ = SigtermLMTrial.__name__ = name
        _SIGTERM_TRIALS[name] = SigtermLMTrial
    return _SIGTERM_TRIALS[name]


def __getattr__(name: str):
    """``GangLMTrial``: phase 16's trial (``sigterm_trial``), and
    ``ClusterLMTrial``: phase 17's (``cluster_trial``), built on first use,
    since this module imports the port inside functions only."""
    if name == "ClusterLMTrial":
        return cluster_trial()
    if name != "GangLMTrial":
        raise AttributeError(name)
    cls = sigterm_trial(name, GANG_SIGTERM_AT)
    cls.__module__ = __name__
    return cls


def gang_driver(argv) -> int:
    """A gang's driver process (phase 16, mesh_smoke.py's X2): ``run
    CONFIG_JSON DIR OUT [ENTRY]`` (run-local's path: LocalExperiment.run of
    ENTRY, GANG_ENTRY by default; exit 75 when preempted) or ``resume - DIR
    OUT`` (``experiment resume DIR``), with every trial's block, one device
    included, sent to the gang launcher.  Writes the chief's relayed launch
    counts, the time from the gang's launch to its first step and the
    host-clock steps to OUT."""
    import os

    from determined_tpu_torch.cli.main import main as cli_main
    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.experiment import PREEMPTED_EXIT_CODE, LocalExperiment, local
    from determined_tpu_torch.experiment import _gang
    from determined_tpu_torch.observability import get_tracer

    mode, config_path, ckpt_dir, out_path, *entry = argv
    launches: dict = {}
    _gang.ATTEMPT_TIMEOUT_S = GANG_TIMEOUT_S

    def through_launcher(self, create, devices=None):
        with get_tracer().span("trial.run", cat="trial", trial=create.request_id):
            try:
                return self._run_gang(create, list(devices or [self.device]))
            finally:
                launches.update(self.trial_launches)

    local.LocalExperiment._run_trial = through_launcher
    if mode == "run":
        with open(config_path) as f:
            cfg = ExperimentConfig.parse(json.load(f))
        summary = LocalExperiment(cfg, _gang.import_trial(entry[0] if entry else GANG_ENTRY),
                                  checkpoint_dir=ckpt_dir).run()
        print(json.dumps(summary, default=str), flush=True)
        code = PREEMPTED_EXIT_CODE if summary["status"] == "preempted" else 0
    else:
        code = cli_main(["experiment", "resume", ckpt_dir])
    tracer = get_tracer()
    launch = _spans(tracer, "gang.launch")
    steps = _spans(tracer, "data.wait")
    with open(out_path, "w") as f:
        json.dump(dict(
            launches={str(k): v for k, v in launches.items()},
            launch_to_first_step_s=steps[0][0] - launch[0][0] if launch and steps else None,
            host_steps=_host_steps(tracer),
        ), f)
    return code


def gang_drive(mode: str, config_path: str, ckpt_dir: str, out_path: str,
               entry: str = GANG_ENTRY) -> tuple:
    """Run ``gang_driver`` in a process of its own under GANG_TIMEOUT_S:
    its exit code, its record and its seconds."""
    import os
    import signal

    t0 = time.monotonic()
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke; "
         "sys.exit(chip_smoke.gang_driver(sys.argv[1:]))", mode, config_path, ckpt_dir, out_path,
         entry],
        cwd=os.path.dirname(os.path.abspath(__file__)), start_new_session=True,
    )
    try:
        code = proc.wait(timeout=GANG_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        raise AssertionError(f"gang driver ({mode}) did not finish in {GANG_TIMEOUT_S:.0f} s")
    wall = time.monotonic() - t0
    with open(out_path) as f:
        return code, json.load(f), wall


def load_compared(path: str, trial_class):
    """``train.load_trial_from_checkpoint(path)`` on the GPU without its md5
    pass, for a caller that holds every loaded tensor against a reference
    bitwise, which the digest would only repeat (a resume in the same run
    checks the md5 path)."""
    from unittest import mock

    from determined_tpu_torch.train import _load

    with mock.patch.object(_load, "verify_manifest", lambda path, **kw: None):
        return _load.load_trial_from_checkpoint(path, trial_class=trial_class, device="cuda")


def _compare_loaded(name: str, trainer, validation_loss: float, want: dict) -> dict:
    """A checkpoint's state loaded into ``trainer`` against a reference's
    (``_final_state``): bitwise, or the largest difference."""
    import torch

    bitwise, worst = True, 0.0
    opt = trainer.state.opt_state
    for k, a in trainer.model.named_parameters():
        for got, ref in ((a.detach(), want["params"][k]), (opt.mu[k], want["mu"][k]),
                         (opt.nu[k], want["nu"][k])):
            ref = ref.to(got.device)
            bitwise &= torch.equal(got, ref)
            worst = max(worst, (got.float() - ref.float()).abs().max().item())
    steps = (int(trainer.state.step), int(opt.count))
    out = dict(bitwise=bool(bitwise and validation_loss == want["validation_loss"]
                            and steps == want["steps"]),
               max_abs_diff=worst, steps=steps + want["steps"],
               validation_loss=(validation_loss, want["validation_loss"]),
               loader=(trainer.train_loader.state_dict(), want["loader"]))
    log(f"{name} vs uninterrupted: " + json.dumps(out))
    return out


def _journal_validations(ckpt_dir: str) -> list:
    import os

    with open(os.path.join(ckpt_dir, "experiment.journal")) as f:
        recs = [json.loads(line) for line in f]
    return [(r["metrics"]["batches"], r["metrics"]) for r in recs
            if r["type"] == "trial_validated"]


def reference_c(seed: int, root: str) -> tuple:
    """Phase 7's C run here (for ``--phases`` without ``experiment``): the
    uninterrupted 24 steps without checkpoints, under ``root``; its final
    state, None for the initial params, and its host steps."""
    import os

    import torch

    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.experiment import LocalExperiment
    from determined_tpu_torch.models import LMTrial
    from determined_tpu_torch.observability import get_tracer

    trial_cls, trainers, _ = _capturing(LMTrial)
    ref_raw = experiment_raw_config(os.path.join(root, "ref-ck"), seed)
    ref_raw["checkpoint_policy"] = "none"
    ref_raw.pop("min_checkpoint_period")
    get_tracer().reset()
    LocalExperiment(ExperimentConfig.parse(ref_raw), trial_cls,
                    checkpoint_dir=os.path.join(root, "ref")).run()
    reference = (_final_state(trainers.pop()), None, _host_steps(get_tracer()))
    del trainers[:]
    gc.collect()
    torch.cuda.empty_cache()
    log("C (uninterrupted, run here): " + json.dumps(reference[2]))
    return reference


def phase_gang(seed: int, reference=None) -> dict:
    """Parts A and B of phase 16 (the docstring at the top); ``reference``
    is phase 7's C (its final state, initial params and host steps), run
    here when None and returned under ``_C`` for phase 17."""
    import os
    import shutil
    import tempfile

    import torch

    from determined_tpu_torch.models import LMTrial

    t_phase = time.monotonic()
    root = tempfile.mkdtemp(prefix="dtt-chip-gang-")
    for path, const, value, why in EXPERIMENT_CUTS:
        value = seed if value == "<--seed>" else value
        log(f"gang cut: {path} {json.dumps(const)} -> {json.dumps(value)} ({why})")
    for what, before, now, why in GANG_CUTS:
        log(f"gang cut: {what}: {before} -> {now} ({why})")
    out: dict = {}
    try:
        if reference is None:
            reference = reference_c(seed, root)
        out["_C"] = reference
        ref, _, ref_host = reference
        raw = experiment_raw_config(os.path.join(root, "ab"), seed)
        ckpt_dir = raw["checkpoint_storage"]["host_path"]
        config_path = os.path.join(root, "config.json")
        with open(config_path, "w") as f:
            json.dump(raw, f)
        hp = raw["hyperparameters"]
        layers = hp["n_layers"]
        n_leaves = _moe_leaves(layers, every=layers + 1)  # no MoE block: 3 + 9 a block
        n_val = hp["dataset_size"] // hp["global_batch_size"]

        def want_launches(steps: int) -> dict:
            return dict(flash_fwd=layers * (steps + n_val), flash_bwd_dq=layers * steps,
                        flash_bwd_dkv=layers * steps, fused_adamw=n_leaves * steps)

        # ---- A: run-local, SIGTERM before step 14, drained at 18 -----------
        code_a, rec_a, wall_a = gang_drive("run", config_path, ckpt_dir,
                                            os.path.join(root, "a.json"))
        ckpts_a = _checkpoint_steps(ckpt_dir)
        launches_a = rec_a["launches"]["1"]
        log(f"gang A (SIGTERM before step {GANG_SIGTERM_AT}): exit {code_a}, {wall_a:.1f} s, "
            + json.dumps(dict(launch_to_first_step_s=rec_a["launch_to_first_step_s"],
                              host_steps=rec_a["host_steps"], checkpoints=ckpts_a,
                              launches=launches_a)))
        assert code_a == 75, code_a
        assert sorted(c["steps"] for c in ckpts_a.values()) == [12, PREEMPT_AT], ckpts_a
        assert all(c["verified"] for c in ckpts_a.values())
        assert [s for s, _ in _journal_validations(ckpt_dir)] == [12]
        want = want_launches(PREEMPT_AT)
        got_a = {k: launches_a[k] for k in want}
        assert got_a == want, f"A's relayed launches {got_a} != expected {want}"

        # ---- B: experiment resume, 18 -> 24 ---------------------------------
        code_b, rec_b, wall_b = gang_drive("resume", "-", ckpt_dir,
                                            os.path.join(root, "b.json"))
        launches_b = rec_b["launches"]["1"]
        log(f"gang B (resumed): exit {code_b}, {wall_b:.1f} s, " + json.dumps(dict(
            launch_to_first_step_s=rec_b["launch_to_first_step_s"],
            host_steps=rec_b["host_steps"], launches=launches_b)))
        assert code_b == 0, code_b
        validations = _journal_validations(ckpt_dir)
        assert [s for s, _ in validations] == [12, EXPERIMENT_STEPS], validations
        final = [u for u, c in _checkpoint_steps(ckpt_dir).items()
                 if c["steps"] == EXPERIMENT_STEPS]
        assert len(final) == 1, final
        want = want_launches(EXPERIMENT_STEPS - PREEMPT_AT)
        got_b = {k: launches_b[k] for k in want}
        assert got_b == want, f"B's relayed launches {got_b} != expected {want}"
        _, trainer = load_compared(os.path.join(ckpt_dir, "trial_1", final[0]), LMTrial)
        cmp = _compare_loaded("gang B (SIGTERM, resumed)", trainer,
                              validations[-1][1]["validation_loss"], ref)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        assert cmp["bitwise"], cmp
        out.update(
            launches=got_a, launches_resume=got_b, vs_uninterrupted=cmp,
            launch_to_first_step_s=dict(A=rec_a["launch_to_first_step_s"],
                                        B=rec_b["launch_to_first_step_s"]),
            host_step_ms=dict(gang_A=rec_a["host_steps"]["mean_step_ms_without_write"],
                              phase7=ref_host and ref_host["mean_step_ms_without_write"]),
            wall_s=dict(A=wall_a, B=wall_b, phase=time.monotonic() - t_phase),
        )
        log("gang: " + json.dumps({k: v for k, v in out.items() if k != "_C"}))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


class NativeBuild:
    """dtpu-master and dtpu-agent built from native/ into a fresh temporary
    directory by a process of its own (``devcluster.build_binaries``),
    started when the script starts so that its compile runs beside the GPU
    phases; ``join`` waits for it.  An unjoined build is killed at exit."""

    def __init__(self) -> None:
        import atexit
        import os
        import tempfile

        self.where = tempfile.mkdtemp(prefix="dtt-chip-native-")
        self.t0 = time.monotonic()
        self.proc = subprocess.Popen(
            [sys.executable, "-c", "import sys; from determined_tpu_torch import devcluster; "
             "print(devcluster.build_binaries(sys.argv[1], force=True))", self.where],
            cwd=os.path.dirname(os.path.abspath(__file__)), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, start_new_session=True,
        )
        atexit.register(self.close)

    def join(self, timeout: float = 600.0) -> tuple:
        """The build directory, the build's seconds and the seconds this
        call waited for it."""
        t0 = time.monotonic()
        out, _ = self.proc.communicate(timeout=timeout)
        waited = time.monotonic() - t0
        assert self.proc.returncode == 0, f"native build failed:\n{out[-4000:]}"
        return self.where, float(out.strip().splitlines()[-1]), waited

    def close(self) -> None:
        import os
        import shutil
        import signal

        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except OSError:
                pass
            self.proc.wait()
        shutil.rmtree(self.where, ignore_errors=True)


_CLUSTER_TRIALS: dict = {}


def cluster_trial():
    """Phase 17's trial (``ClusterLMTrial``): LMTrial whose first run waits
    before step CLUSTER_PAUSE_AT until the master's preemption signal has
    reached it, and whose every run appends its events (start, waiting,
    signalled, end with its host-clock steps) as JSON lines under
    ``$DTT_SMOKE_CLUSTER_DIR``."""
    if "ClusterLMTrial" in _CLUSTER_TRIALS:
        return _CLUSTER_TRIALS["ClusterLMTrial"]
    import os

    from determined_tpu_torch.core import HeartbeatReporter
    from determined_tpu_torch.models import LMTrial
    from determined_tpu_torch.observability import get_tracer
    from determined_tpu_torch.train import Callback
    from determined_tpu_torch.utils import faults

    # run_trial imports the trial class before core.init starts the
    # reporter, so its beats follow this period
    HeartbeatReporter.INTERVAL = CLUSTER_HEARTBEAT_CUT[1]

    def event(**rec) -> None:
        rec["t"] = time.time()
        with open(os.path.join(os.environ[CLUSTER_DIR_ENV], "events.jsonl"), "a") as f:
            f.write(json.dumps(rec) + "\n")

    class ClusterLMTrial(LMTrial):
        def build_callbacks(self):
            preempt = self.context.core.preempt

            def wait_for_signal() -> None:
                event(event="waiting", step=CLUSTER_PAUSE_AT - 1)
                deadline = time.monotonic() + CLUSTER_TIMEOUT_S
                # a world of one: the read is the flag the master's
                # long-poll sets, not a collective
                while not preempt.should_preempt(auto_ack=False):
                    assert time.monotonic() < deadline, "no preemption signal from the master"
                    time.sleep(0.01)
                event(event="signalled", step=CLUSTER_PAUSE_AT - 1)

            class Record(Callback):
                def on_training_start(self, trainer) -> None:
                    event(event="start", step=trainer.steps_completed)
                    if trainer.steps_completed < CLUSTER_PAUSE_AT - 1:
                        faults.set_fault_injector(_StepHook(CLUSTER_PAUSE_AT - 1,
                                                            wait_for_signal))

                def on_trial_shutdown(self) -> None:
                    faults.set_fault_injector(None)
                    event(event="end", host_steps=_host_steps(get_tracer()))

            return {"record": Record()}

    # recorded in its checkpoints as chip_smoke:ClusterLMTrial, which
    # resolves through the module's __getattr__ (phase 19's replicas load
    # the class by that name)
    ClusterLMTrial.__module__ = __name__
    ClusterLMTrial.__qualname__ = ClusterLMTrial.__name__
    _CLUSTER_TRIALS["ClusterLMTrial"] = ClusterLMTrial
    return ClusterLMTrial


def _read_events(path: str) -> list:
    import os

    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def _wait_for(what: str, fn, timeout: float, alive=None, poll: float = 0.05):
    """Poll ``fn`` until it returns something truthy; fail after
    ``timeout`` seconds or when ``alive()`` turns false."""
    deadline = time.monotonic() + timeout
    while True:
        got = fn()
        if got:
            return got
        assert alive is None or alive(), f"{what}: the cluster or the driver stopped"
        assert time.monotonic() < deadline, f"{what}: not within {timeout:.0f} s"
        time.sleep(poll)


def _log_lines(session, what: str) -> list:
    """The log lines at the master of ``what`` (``trials/<id>`` or
    ``tasks/<id>``: the agent relays the process's output), as strings."""
    recs = session.get(f"/api/v1/{what}/logs", params={"limit": 10000}).json()
    return [r if isinstance(r, str) else str(r.get("line", r)) for r in recs]


def phase_cluster(seed: int, build: NativeBuild, reference=None, keep: bool = False) -> dict:
    """Phase 17 (the docstring at the top); ``reference`` is phase 7's C
    (its final state, initial params and host steps), run here when None.
    With ``keep`` the cluster, its state and checkpoints outlive the phase:
    ``out["_kept"]`` hands them to phase 19, which stops and deletes them."""
    import os
    import shutil
    import tempfile
    import threading

    import torch

    from determined_tpu_torch import devcluster
    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.experiment import ClusterExperiment
    from determined_tpu_torch.models import LMTrial

    t_phase = time.monotonic()
    where, build_s, waited_s = build.join()
    log(f"cluster: native build {build_s:.1f} s (cmake or g++ of native/), the phase waited "
        f"{waited_s:.1f} s for it")
    root = tempfile.mkdtemp(prefix="dtt-chip-cluster-")
    events_dir = os.path.join(root, "events")
    os.makedirs(events_dir)
    events_path = os.path.join(events_dir, "events.jsonl")
    for path, const, value, why in EXPERIMENT_CUTS:
        value = seed if value == "<--seed>" else value
        log(f"cluster cut: {path} {json.dumps(const)} -> {json.dumps(value)} ({why})")
    for path, const, value, why in CLUSTER_CUTS:
        log(f"cluster cut: {path} {json.dumps(const)} -> {json.dumps(value)} ({why})")
    default, interval, why = CLUSTER_HEARTBEAT_CUT
    log(f"cluster cut: the trial's HeartbeatReporter.INTERVAL {default} -> {interval} ({why})")
    for flag, default, value, why in FLEET_MASTER_CUTS:
        log(f"cluster cut: dtpu-master {flag} {default} -> {value} ({why})")
    out: dict = dict(native_build_s=build_s, native_build_waited_s=waited_s)
    cluster = None
    driver = None
    kept = False
    try:
        if reference is None:
            reference = reference_c(seed, root)
        ref, _, ref_host = reference
        gc.collect()
        torch.cuda.empty_cache()

        ckpt_dir = os.path.join(root, "checkpoints")
        cluster = devcluster.LocalCluster(
            os.path.join(root, "state"), ckpt_dir, agents=1, slots=1,
            cwd=os.path.dirname(os.path.abspath(__file__)), where=where,
            master_args=[str(x) for flag, _, value, _ in FLEET_MASTER_CUTS
                         for x in (flag, value)],
        )
        t0 = time.monotonic()
        cluster.start()
        log(f"cluster: master {cluster.url} and one agent up in {time.monotonic() - t0:.1f} s "
            f"(their logs under {cluster.log_dir})")
        session = cluster.session()
        raw = _apply_cuts(experiment_raw_config(ckpt_dir, seed), CLUSTER_CUTS,
                          {"<events dir>": events_dir})
        exp = ClusterExperiment(ExperimentConfig.parse(raw), session=session,
                                checkpoint_dir=os.path.join(root, "driver"), poll_interval=0.5)
        result: dict = {}

        def drive() -> None:
            try:
                result["summary"] = exp.run()
            except BaseException as e:  # noqa: BLE001 - raised on the main thread
                result["error"] = e

        alive = lambda: cluster.alive() and driver.is_alive()  # noqa: E731
        t_submit = time.time()
        driver = threading.Thread(target=drive, name="cluster-driver", daemon=True)
        driver.start()

        def event(name: str, nth: int = 1):
            hits = [e for e in _read_events(events_path) if e["event"] == name]
            return hits[nth - 1] if len(hits) >= nth else None

        # ---- the first run, paused through the master before step 14 -------
        waiting = _wait_for("the trial reaching the pause", lambda: event("waiting"),
                            CLUSTER_TIMEOUT_S, alive)
        eid = exp.master_experiment_id
        tid = exp._watches[1].master_trial_id
        t_pause = time.time()
        session.post(f"/api/v1/experiments/{eid}/pause")
        _wait_for("the trial's exit", lambda: session.get(
            f"/api/v1/trials/{tid}").json()["state"] == "PENDING", CLUSTER_TIMEOUT_S, alive,
            poll=0.02)
        t_exit = time.time()
        first = _read_events(events_path)
        log(f"cluster: trial {tid} paused by the master (experiment {eid}) before step "
            f"{CLUSTER_PAUSE_AT}; the signal reached it in "
            f"{event('signalled')['t'] - t_pause:.2f} s, it exited {t_exit - t_pause:.2f} s "
            "after the pause")

        # ---- the second run, from the drained checkpoint ---------------------
        t_activate = time.time()
        session.post(f"/api/v1/experiments/{eid}/activate")
        driver.join(CLUSTER_TIMEOUT_S)
        assert not driver.is_alive(), "the search did not finish"
        if "error" in result:
            raise result["error"]
        summary = result["summary"]
        t_done = time.time()
        evs = _read_events(events_path)
        starts = [e for e in evs if e["event"] == "start"]
        ends = [e for e in evs if e["event"] == "end"]
        log(f"cluster: search {json.dumps(summary, default=str)}")
        log("cluster: trial events " + json.dumps(evs))
        assert summary["status"] == "completed" and summary["trials"] == 1, summary
        assert [e["step"] for e in starts] == [0, CLUSTER_PAUSE_AT], starts
        del first

        # ---- the master's records --------------------------------------------
        rows = []
        while True:
            page = session.get(f"/api/v1/trials/{tid}/metrics",
                               params={"offset": len(rows)}).json()
            if not page:
                break
            rows += page
        training = [r["steps_completed"] for r in rows if r["group"] == "training"]
        # a report covers 2 steps and ends in a host sync: its samples/s is
        # the step the card sustains; reports at a start, a validation or a
        # save are left out
        gbs = raw["hyperparameters"]["global_batch_size"]
        busy = {2, 12, CLUSTER_PAUSE_AT, CLUSTER_PAUSE_AT + 2, 18, EXPERIMENT_STEPS}
        report_ms = {r["steps_completed"]: 1e3 * gbs / r["metrics"]["samples_per_second"]
                     for r in rows if r["group"] == "training"
                     and r["steps_completed"] not in busy}
        validations = [(r["steps_completed"], r["metrics"]) for r in rows
                       if r["group"] == "validation"]
        log(f"cluster: master metrics: {len(training)} training rows (steps {training}), "
            f"validations at {[s for s, _ in validations]}")
        assert training and training[-1] == EXPERIMENT_STEPS, training
        assert [s for s, _ in validations] == [12, EXPERIMENT_STEPS], validations
        ckpts = [c for c in session.get("/api/v1/checkpoints").json() if c["trial_id"] == tid]
        by_step = {c["metadata"]["steps_completed"]: c for c in ckpts}
        log("cluster: master checkpoints " + json.dumps(
            {s: (c["uuid"], c["state"]) for s, c in sorted(by_step.items())}))
        drained = by_step.get(CLUSTER_PAUSE_AT)
        final = by_step.get(EXPERIMENT_STEPS)
        assert drained is not None and final is not None, sorted(by_step)
        trial_json = session.get(f"/api/v1/trials/{tid}").json()
        assert trial_json["latest_checkpoint"] == final["uuid"], trial_json
        lines = _log_lines(session, f"trials/{tid}")
        device_lines = [ln for ln in lines if "device: cuda" in ln]
        beat_lines = [ln for ln in lines if "beat acknowledged by the master" in ln]
        launch_lines = [ln for ln in lines if "kernel launches: " in ln]
        log(f"cluster: {len(lines)} log lines at the master; " + json.dumps(
            dict(device=device_lines, heartbeat=beat_lines, launches=launch_lines)))
        assert len(device_lines) == 2, device_lines
        assert beat_lines, "no heartbeat answered by the master in the trial's log"
        assert len(launch_lines) == 2, launch_lines
        launches = json.loads(launch_lines[-1].split("kernel launches: ", 1)[1])
        version = session.get(f"/api/v1/models/{CLUSTER_MODEL}/versions/1").json()
        log("cluster: registry " + json.dumps(version))
        assert summary["registry"]["version"] == 1, summary
        assert version["checkpoint_uuid"] == final["uuid"], (version, final["uuid"])

        # ---- the final state against phase 7's C -----------------------------
        _, trainer = load_compared(os.path.join(ckpt_dir, final["uuid"]), LMTrial)
        layers, n_leaves = trainer.model.cfg.n_layers, len(trainer._params)
        n_val = trainer.val_loader.batches_per_epoch
        resumed = EXPERIMENT_STEPS - drained["metadata"]["steps_completed"]
        want = dict(flash_fwd=layers * (resumed + n_val), flash_bwd_dq=layers * resumed,
                    flash_bwd_dkv=layers * resumed, fused_adamw=n_leaves * resumed)
        got = {k: launches[k] for k in want}
        cmp = _compare_loaded("cluster (paused, resumed)", trainer, validations[-1][1][
            "validation_loss"], ref)
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        assert cmp["bitwise"], cmp
        assert got == want, f"resumed run's launches {got} != expected {want}"
        out.update(
            launches=got, vs_uninterrupted=cmp, trial_id=tid,
            submit_to_first_step_s=starts[0]["t"] - t_submit,
            pause_to_signal_s=event("signalled")["t"] - t_pause,
            pause_to_exit_s=t_exit - t_pause,
            activate_to_first_step_s=starts[1]["t"] - t_activate,
            step_ms=dict(
                reports=report_ms, median=statistics.median(report_ms.values()),
                phase7_host_step=ref_host and ref_host["mean_step_ms_without_write"]),
            host_enqueue_ms=dict(
                first_run=ends[0]["host_steps"]["mean_step_ms_without_write"],
                resumed_run=ends[-1]["host_steps"]["mean_step_ms_without_write"]),
            search_s=t_done - t_submit, waiting_step=waiting["step"],
        )
        out["wall_s"] = time.monotonic() - t_phase
        log("cluster: " + json.dumps(out))
        if keep:
            out["_kept"] = dict(cluster=cluster, root=root, ckpt_dir=ckpt_dir,
                                drained=drained["uuid"], final=final["uuid"],
                                checkpoint_states={s: c["state"] for s, c in by_step.items()})
            kept = True
    finally:
        if driver is not None:
            driver.join(10)
        if not kept:
            if cluster is not None:
                cluster.stop()
            shutil.rmtree(root, ignore_errors=True)
    return out


def _last_json(lines: list, prefix: str, before: str = None) -> dict:
    """The JSON of the last line that starts with ``prefix`` (before the
    first line equal to ``before``, when given)."""
    if before is not None and before in lines:
        lines = lines[:lines.index(before)]
    hits = [ln[len(prefix):] for ln in lines if ln.startswith(prefix)]
    assert hits, f"no {prefix!r} line in {lines[-40:]}"
    return json.loads(hits[-1])


class _FleetLoad:
    """Clients sending prompts back to back through the master's router
    (``POST /v1/generate`` on the port's session); each answer is kept with
    the replica the router names (``X-DTPU-Replica``) and its answer time,
    a refusal (503) is counted and retried after a pause."""

    def __init__(self, session, prompts: list, threads: int) -> None:
        import threading

        self.session, self.prompts = session, prompts
        self.answers: list = []   # (replica id, answer time)
        self.refused: list = []   # answer times of 503s
        self.errors: list = []
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [threading.Thread(target=self._run, args=(i,), daemon=True)
                         for i in range(threads)]

    def _run(self, k: int) -> None:
        from determined_tpu_torch.api.session import APIError

        i = k
        while not self._stop.is_set():
            body = {"prompt_tokens": self.prompts[i % len(self.prompts)],
                    "max_new_tokens": SERVE_CKPT_NEW_TOKENS}
            try:
                resp = self.session.post("/v1/generate", json=body)
                assert len(resp.json()["tokens"]) == SERVE_CKPT_NEW_TOKENS, resp.text
                with self._lock:
                    self.answers.append((resp.headers.get("X-DTPU-Replica"), time.time()))
                i += 1
            except APIError as e:
                with self._lock:
                    (self.refused if e.status == 503 else self.errors).append(
                        (time.time(), str(e)))
                time.sleep(0.05)
            except Exception as e:  # noqa: BLE001 - reported and failed on
                with self._lock:
                    self.errors.append((time.time(), repr(e)))
                time.sleep(0.05)

    def start(self) -> "_FleetLoad":
        for t in self._threads:
            t.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(120)

    def served_by(self, rid: str) -> list:
        with self._lock:
            return [t for r, t in self.answers if r == rid]


def phase_fleet(seed: int, kept: dict) -> dict:
    """Phase 19 (the docstring at the top), on the cluster phase 17 kept."""
    import os
    import shutil
    import signal

    import torch

    from determined_tpu_torch.client import Determined
    from determined_tpu_torch.serve import ServeEngine, ServeWorker

    t_phase = time.monotonic()
    cluster, root = kept["cluster"], kept["root"]
    here = os.path.dirname(os.path.abspath(__file__))
    for what, old, new, why in FLEET_CUTS:
        log(f"fleet cut: {what} {old} -> {new} ({why})")
    log(f"fleet: phase 17's checkpoints at the master {json.dumps(kept['checkpoint_states'])}")
    out: dict = dict(card=card_line())
    load = None
    try:
        session = cluster.session()
        client = Determined(cluster.url, session=session)
        env = dict(os.environ, DTPU_TOKEN=session.token)
        env.pop("DTPU_MASTER", None)

        def cli(*argv: str) -> float:
            """The port's CLI in a subprocess; its seconds."""
            t0 = time.monotonic()
            proc = subprocess.run(
                [sys.executable, "-m", "determined_tpu_torch.cli", "-m", cluster.url, *argv],
                cwd=here, env=env, capture_output=True, text=True, timeout=FLEET_TIMEOUT_S)
            took = time.monotonic() - t0
            log(f"fleet: $ cli {' '.join(argv)} -> {proc.returncode} in {took:.2f} s: "
                + " | ".join(proc.stdout.strip().splitlines()))
            assert proc.returncode == 0, proc.stderr[-4000:]
            return took

        def replicas(**match) -> list:
            return [r for r in client.get_serving()
                    if all(r.get(k) == v for k, v in match.items())]

        def slot() -> dict:
            return client.get_serving_fleet()["slots"][0]

        # ---- v2: the checkpoint phase 17's pause drained ----------------------
        v2_path = os.path.join(kept["ckpt_dir"], kept["drained"])
        assert os.path.isdir(v2_path), f"the drained checkpoint {v2_path} is gone"
        cli("model", "register", CLUSTER_MODEL, kept["drained"], "--storage-path", v2_path)
        versions = {int(v["version"]): v for v in client.get_model(CLUSTER_MODEL)["versions"]}
        assert versions[1]["checkpoint_uuid"] == kept["final"], versions
        assert versions[2]["checkpoint_uuid"] == kept["drained"], versions
        paths = {v: versions[v]["storage_path"] for v in (1, 2)}
        registry = {v: (versions[v]["checkpoint_uuid"], paths[v]) for v in paths}
        log(f"fleet: registry {json.dumps(registry)}")

        # ---- the expected tokens, in this process -----------------------------
        vocab = EXPERIMENT_CONST["hyperparameters"]["vocab_size"]
        prompts = [p[-FLEET_PROMPT_LEN:] for p in make_prompts(seed + 1, vocab)[:FLEET_PROMPTS]]
        extra = [p[-FLEET_PROMPT_LEN:] for p in make_prompts(seed + 2, vocab)[:2]]
        # the deploy's traffic: other prompts, so that the token checks'
        # prompts reach each replica cold (a prefix-cache hit takes the
        # suffix prefill, whose bf16 sums may flip a near-tied greedy token)
        load_prompts = [p[-FLEET_PROMPT_LEN:] for p in make_prompts(seed + 3, vocab)]
        def load(v: int) -> tuple:
            t0 = time.monotonic()
            engine = ServeEngine.from_checkpoint(paths[v], None)
            torch.cuda.synchronize()
            return engine, time.monotonic() - t0

        # both at once: each load is mostly the md5 of its files
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            loaded = dict(zip((1, 2), pool.map(load, (1, 2))))
        expected, inproc_load_s = {}, {}
        for v in (1, 2):
            engine, inproc_load_s[v] = loaded.pop(v)
            n_layers = engine.kernels.model.cfg.n_layers
            expected[v], _, _ = _serve_tokens(ServeWorker(engine), prompts)
            del engine
        _free_cuda()
        assert expected[1] != expected[2], "v1 and v2 give the same tokens"
        log(f"fleet: expected tokens in process: v1 and v2 differ on "
            f"{sum(a != b for a, b in zip(expected[1], expected[2]))} of {len(prompts)} prompts; "
            f"from_checkpoint {json.dumps(inproc_load_s)} s")

        def through_router(want: dict) -> list:
            answers = [client.generate(p, max_new_tokens=SERVE_CKPT_NEW_TOKENS)
                       for p in prompts]
            got = [a["tokens"] for a in answers]
            assert got == want, f"router tokens {got} != expected {want}"
            return answers

        # ---- fleet set: the supervisor launches the replica on v1 -------------
        t_set = time.time()
        set_s = cli("fleet", "set", f"{CLUSTER_MODEL}@1", "--target", "1")
        rep1 = _wait_for("the v1 replica registered", lambda: replicas(model_version=1),
                         FLEET_TIMEOUT_S, cluster.alive, poll=0.02)[0]
        t_reg1 = time.time()
        task1 = slot()["task_id"]
        _wait_for("the v1 task ready", lambda: client.get_task(task1).get("ready"),
                  FLEET_TIMEOUT_S, cluster.alive, poll=0.02)
        t_ready1 = time.time()
        lines = _log_lines(session, f"tasks/{task1}")
        device_lines = [ln for ln in lines if "device: cuda" in ln]
        assert device_lines and torch.cuda.get_device_name(0) in device_lines[0], lines[-40:]
        log(f"fleet: replica {rep1['id']} ({rep1['model']}) at {rep1['url']} as {task1}; "
            f"{device_lines[0]}")
        sent = {task1: 0}
        answers = through_router(expected[1])
        sent[task1] += len(prompts)
        # the router's share: one prompt through it, one straight to the replica
        t0 = time.monotonic()
        via = client.generate(extra[0], max_new_tokens=SERVE_CKPT_NEW_TOKENS)
        via_wall = time.monotonic() - t0
        t0 = time.monotonic()
        status, direct = post(rep1["url"], "/v1/generate", {
            "prompt_tokens": extra[1], "max_new_tokens": SERVE_CKPT_NEW_TOKENS})
        direct_wall = time.monotonic() - t0
        assert status == 200, direct
        sent[task1] += 2

        def step_ms(a: dict) -> float:
            return (a["latency_ms"] - a["ttft_ms"]) / (SERVE_CKPT_NEW_TOKENS - 1)

        out.update(
            fleet_set_cli_s=set_s, set_to_registered_s=t_reg1 - t_set,
            set_to_ready_s=t_ready1 - t_set,
            router=dict(ttft_ms=[a["ttft_ms"] for a in answers] + [via["ttft_ms"]],
                        decode_step_ms=[step_ms(a) for a in answers] + [step_ms(via)],
                        round_trip_ms=1e3 * via_wall, server_latency_ms=via["latency_ms"]),
            direct=dict(ttft_ms=direct["ttft_ms"], decode_step_ms=step_ms(direct),
                        round_trip_ms=1e3 * direct_wall, server_latency_ms=direct["latency_ms"]),
        )
        out["router_overhead_ms"] = ((out["router"]["round_trip_ms"] - via["latency_ms"])
                                     - (out["direct"]["round_trip_ms"] - direct["latency_ms"]))

        # ---- model deploy @2 under load ---------------------------------------
        load = _FleetLoad(session, load_prompts, FLEET_LOAD_THREADS).start()
        _wait_for("traffic through the router", lambda: len(load.served_by(rep1["id"])) >= 2,
                  FLEET_TIMEOUT_S, cluster.alive)
        t_deploy = time.time()
        deploy = subprocess.Popen(
            [sys.executable, "-m", "determined_tpu_torch.cli", "-m", cluster.url, "model",
             "deploy", f"{CLUSTER_MODEL}@2", "--timeout", str(FLEET_TIMEOUT_S)],
            cwd=here, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        try:
            _wait_for("the v1 replica's exit",
                      lambda: client.get_task(task1)["state"] == "TERMINATED",
                      FLEET_TIMEOUT_S, cluster.alive, poll=0.02)
            t_drained = time.time()
            task2 = _wait_for("the relaunch", lambda: slot()["task_id"] not in ("", task1)
                              and slot()["task_id"], FLEET_TIMEOUT_S, cluster.alive, poll=0.02)
            t_relaunch = time.time()
            rep2 = _wait_for("the v2 replica registered", lambda: replicas(model_version=2),
                             FLEET_TIMEOUT_S, cluster.alive, poll=0.02)[0]
            t_reg2 = time.time()
            deploy_out, _ = deploy.communicate(timeout=FLEET_TIMEOUT_S)
        finally:
            if deploy.poll() is None:
                deploy.kill()
                deploy.wait()
        t_deployed = time.time()
        log("fleet: $ cli model deploy -> " + " | ".join(deploy_out.strip().splitlines()))
        assert deploy.returncode == 0, deploy_out
        _wait_for("v2 answers through the router", lambda: len(load.served_by(rep2["id"])) >= 2,
                  FLEET_TIMEOUT_S, cluster.alive)
        load.stop()
        assert not load.errors, load.errors[:5]
        v1_done, v2_done = load.served_by(rep1["id"]), load.served_by(rep2["id"])
        assert len(v1_done) + len(v2_done) == len(load.answers), "an answer of another replica"
        assert max(v1_done) <= min(v2_done), "the v1 replica answered after the v2 one"
        sent[task1] += len(v1_done)
        sent[task2] = len(v2_done)
        lines1 = _log_lines(session, f"tasks/{task1}")
        assert f"deploy drain requested by master (target {CLUSTER_MODEL}@v2)" in lines1, \
            lines1[-40:]
        assert lines1[-1] == "drained (clean); exiting", lines1[-40:]
        s1 = slot()
        assert s1["failures"] == 0 and s1["launches"] == 2, s1
        at_drain = _last_json(lines1, "serve stats: ", before="drain requested: rejecting "
                              "new requests, finishing in-flight")
        final1 = _last_json(lines1, "serve stats: ")
        in_flight = at_drain["submitted"] - at_drain["completed"] - at_drain["errored"]
        assert final1["completed"] == sent[task1] and final1["errored"] == 0, (final1, sent)
        answers = through_router(expected[2])
        sent[task2] += len(prompts)
        out.update(
            deploy_to_drained_s=t_drained - t_deploy, deploy_to_relaunched_s=t_relaunch - t_deploy,
            deploy_to_registered_v2_s=t_reg2 - t_deploy, deploy_cli_s=t_deployed - t_deploy,
            load=dict(threads=FLEET_LOAD_THREADS, v1_answers=len(v1_done),
                      v2_answers=len(v2_done), refused_503=len(load.refused),
                      in_flight_at_drain=in_flight,
                      gap_s=min(v2_done) - max(v1_done)),
        )
        log(f"fleet: deploy: replica {rep1['id']} drained with {in_flight} request(s) in "
            f"flight, all {final1['completed']} it took answered; {rep2['id']} on v2 as "
            f"{task2}; the router refused {len(load.refused)} request(s) (503) in the gap")

        # ---- SIGKILL the v2 replica -------------------------------------------
        _wait_for("the v2 replica's counts", lambda: _last_json(
            _log_lines(session, f"tasks/{task2}"), "serve stats: ")["completed"] == sent[task2],
            FLEET_TIMEOUT_S, cluster.alive, poll=0.05)
        pid = cluster.task_pid(task2)
        assert pid, f"no pid for {task2}"
        t_kill = time.time()
        os.kill(pid, signal.SIGKILL)
        task3 = _wait_for("the relaunch after the SIGKILL",
                          lambda: slot()["task_id"] not in ("", task2) and slot()["task_id"],
                          FLEET_TIMEOUT_S, cluster.alive, poll=0.02)
        t_relaunch3 = time.time()
        rep3 = _wait_for("the relaunched replica registered", lambda: [
            r for r in replicas(model_version=2) if r["id"] != rep2["id"]],
            FLEET_TIMEOUT_S, cluster.alive, poll=0.02)[0]
        t_reg3 = time.time()
        s3 = slot()
        assert s3["failures"] == 1 and s3["last_error"] == f"task {task2} exited 137", s3
        through_router(expected[2])
        sent[task3] = len(prompts)
        _wait_for("the relaunched replica's counts", lambda: _last_json(
            _log_lines(session, f"tasks/{task3}"), "serve stats: ")["completed"] == sent[task3],
            FLEET_TIMEOUT_S, cluster.alive, poll=0.05)
        out.update(kill_to_relaunched_s=t_relaunch3 - t_kill,
                   kill_to_registered_s=t_reg3 - t_kill)
        log(f"fleet: SIGKILL of {task2} (pid {pid}): {s3['last_error']}; {rep3['id']} on v2 "
            f"as {task3}")

        # ---- each replica's launches, from its log at the master --------------
        replicas_out, total = {}, dict(flash_fwd=0, flash_bwd_dq=0, flash_bwd_dkv=0,
                                       fused_adamw=0)
        for task in (task1, task2, task3):
            lines = _log_lines(session, f"tasks/{task}")
            launches = _last_json(lines, "kernel launches: ")
            stats = _last_json(lines, "serve stats: ")
            loaded = _last_json(lines, "load seconds: ")
            want = dict(flash_fwd=n_layers * (stats["completed"] - stats["prefix_hits"]),
                        flash_bwd_dq=0, flash_bwd_dkv=0, fused_adamw=0)
            got = {k: launches[k] for k in want}
            assert stats["completed"] == sent[task], (task, stats, sent)
            assert got == want, f"{task}: launches {got} != expected {want}"
            for k in total:
                total[k] += got[k]
            replicas_out[task] = dict(launches=got, requests=stats["completed"],
                                      prefix_hits=stats["prefix_hits"], **loaded)
        out.update(replicas=replicas_out, launches=total,
                   inproc_from_checkpoint_s=inproc_load_s)
        out["phase_s"] = time.monotonic() - t_phase
        log("fleet: " + json.dumps(out))
    finally:
        if load is not None:
            load.stop()
        cluster.stop()
        shutil.rmtree(root, ignore_errors=True)
    return out


def phase_experiment(seed: int) -> dict:
    """Parts C, A, B and D of phase 7 (the docstring at the top)."""
    import os
    import shutil
    import tempfile

    import torch

    from determined_tpu_torch import core, train
    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.exec.run_trial import TrialSupervisor
    from determined_tpu_torch.experiment import LocalExperiment
    from determined_tpu_torch.models import LMTrial
    from determined_tpu_torch.observability import get_tracer
    from determined_tpu_torch.utils import faults

    root = tempfile.mkdtemp(prefix="dtt-chip-experiment-")
    free = shutil.disk_usage(root).free
    log(f"experiment: checkpoints under {root}, {free / 2**30:.1f} GiB free")
    for path, const, value, why in EXPERIMENT_CUTS:
        value = seed if value == "<--seed>" else value
        log(f"experiment cut: {path} {json.dumps(const)} -> {json.dumps(value)} ({why})")
    for path, const, value, why in CRASH_CUTS:
        log(f"experiment D cut: {path} {json.dumps(const)} -> {json.dumps(value)} ({why})")
    trial_cls, trainers, started = _capturing(LMTrial)
    tracer = get_tracer()
    memory: dict = {}
    out: dict = {}
    try:
        raw = experiment_raw_config(os.path.join(root, "ab"), seed)
        cfg = ExperimentConfig.parse(raw)
        init_params = _start_params(cfg, trial_cls)
        # params, f32 first and second moments: 12 bytes a parameter, and at
        # most three checkpoints on the disk at once
        need = 3 * 12 * sum(p.numel() for p in init_params.values())
        assert free > 1.1 * need, (
            f"{free / 2**30:.1f} GiB free under {root}; the phase needs {need / 2**30:.1f} GiB"
        )
        # ---- C: the uninterrupted reference --------------------------------
        ref_raw = dict(raw, checkpoint_policy="none")
        ref_raw.pop("min_checkpoint_period")
        t0 = time.monotonic()
        with _device_memory(memory, "C"):
            summary_c = LocalExperiment(ExperimentConfig.parse(ref_raw), trial_cls,
                                        checkpoint_dir=os.path.join(root, "ref")).run()
        ref = _final_state(trainers.pop())
        log(f"experiment C (uninterrupted): {time.monotonic() - t0:.1f} s, "
            + json.dumps(summary_c))
        assert summary_c["status"] == "completed" and summary_c["total_steps"] == EXPERIMENT_STEPS

        # ---- A: preempted at step 18 -----------------------------------------
        exp = LocalExperiment(cfg, trial_cls, checkpoint_dir=raw["checkpoint_storage"]["host_path"])
        faults.set_fault_injector(_StepHook(PREEMPT_AT - 1, exp.request_preemption))
        t0 = time.monotonic()
        try:
            with _device_memory(memory, "A"):
                summary_a = exp.run()
        finally:
            faults.set_fault_injector(None)
        wall_a = time.monotonic() - t0
        ckpts_a = _checkpoint_steps(cfg.checkpoint_storage.host_path)
        steps_a = sorted(c["steps"] for c in ckpts_a.values())
        spans = {name: _span_seconds(tracer, name) for name in (
            "checkpoint.save", "checkpoint.dispatch", "checkpoint.write", "checkpoint.stall",
            "checkpoint.finalize", "checkpoint.digest")}
        host = _host_steps(tracer)
        ckpt_bytes = max(c["bytes"] for c in ckpts_a.values())
        log(f"experiment A (preempted): {wall_a:.1f} s, " + json.dumps(summary_a))
        log("experiment A checkpoints: " + json.dumps(ckpts_a))
        assert summary_a["status"] == "preempted" and summary_a["in_flight"] == [1], summary_a
        assert steps_a == [12, PREEMPT_AT], steps_a
        assert all(c["verified"] for c in ckpts_a.values())
        (preempted,) = trainers
        assert preempted.steps_completed == PREEMPT_AT
        assert preempted._pending_save is None  # the async save drained
        del preempted, trainers[:]
        (dispatch_s,), (write_s,), (stall_s,), (finalize_s,) = (
            spans["checkpoint.dispatch"], spans["checkpoint.write"], spans["checkpoint.stall"],
            spans["checkpoint.finalize"])
        (sync_s,) = spans["checkpoint.save"]
        digest_async_s, digest_sync_s = spans["checkpoint.digest"]
        saves = dict(
            bytes_per_checkpoint=ckpt_bytes,
            async_step12=dict(dispatch_s=dispatch_s, write_s=write_s,
                              copy_to_host_s=_span_seconds(tracer, "checkpoint.copy"),
                              stall_s=stall_s,
                              finalize_s=finalize_s, finalize_md5_s=digest_async_s,
                              write_gb_per_s=ckpt_bytes / write_s / 1e9),
            sync_step18=dict(save_s=sync_s, md5_s=digest_sync_s,
                             write_s=sync_s - digest_sync_s,
                             gb_per_s=ckpt_bytes / sync_s / 1e9,
                             write_gb_per_s=ckpt_bytes / (sync_s - digest_sync_s) / 1e9),
            md5_gb_per_s=ckpt_bytes / digest_sync_s / 1e9,
        )
        log("experiment saves: " + json.dumps(saves))
        log("experiment host-clock steps (A): " + json.dumps(host))

        # ---- B: resume to step 24 ------------------------------------------------
        exp_b = LocalExperiment(cfg, trial_cls, checkpoint_dir=cfg.checkpoint_storage.host_path)
        _reset_launches()  # counts from here on are the resumed run's
        t0 = time.monotonic()
        with _device_memory(memory, "B"):
            summary_b = exp_b.resume()
            torch.cuda.synchronize()
        wall_b = time.monotonic() - t0
        launches = _launch_counts()
        resumed = trainers.pop()
        restore = dict(
            resume_to_first_step_s=started[-1] - t0,
            verify_s=_span_seconds(tracer, "checkpoint.verify"),
            restore_s=_span_seconds(tracer, "checkpoint.restore"),
            load_s=_span_seconds(tracer, "checkpoint.load"),
        )
        log(f"experiment B (resumed): {wall_b:.1f} s, " + json.dumps(summary_b))
        log("experiment resume: " + json.dumps(restore))
        log("experiment B launches: " + json.dumps(launches))
        assert summary_b["status"] == "completed" and summary_b["total_steps"] == EXPERIMENT_STEPS
        # one md5 pass: the experiment's check; the restore reuses its verdict
        assert len(restore["verify_s"]) == 1 and len(restore["load_s"]) == 1, restore
        n_leaves, layers = len(resumed._params), resumed.model.cfg.n_layers
        n_val = resumed.val_loader.batches_per_epoch
        resumed_steps = EXPERIMENT_STEPS - PREEMPT_AT
        want = dict(flash_fwd=layers * (resumed_steps + n_val),
                    flash_bwd_dq=layers * resumed_steps, flash_bwd_dkv=layers * resumed_steps,
                    fused_adamw=n_leaves * resumed_steps)
        assert launches == want, f"launches {launches} != expected {want}"
        out["launches"] = launches
        out["B_vs_C"] = _compare_final("B (preempted, resumed)", resumed, ref, init_params)
        del resumed
        shutil.rmtree(os.path.join(root, "ab"))

        # ---- D: crash at step 15, restart from step 12 ---------------------------
        d_cfg = ExperimentConfig.parse(_apply_cuts(raw, CRASH_CUTS, {}))
        attempts = []

        def factory():
            trainers.clear()  # the crashed attempt's trainer goes with it
            attempts.append(time.monotonic())
            ctx = train.init(
                exp_config=d_cfg, seed=d_cfg.reproducibility.experiment_seed + 1, device="cuda",
                core_context=core._dummy_init(checkpoint_dir=os.path.join(root, "d")),
            )
            return train.Trainer(trial_cls(ctx))

        def crash():
            raise _SimulatedCrash(f"injected crash at step {CRASH_AT}")

        supervisor = TrialSupervisor(factory, policy=train.RestartPolicy.from_exp_config(d_cfg))
        faults.set_fault_injector(_StepHook(CRASH_AT, crash))
        n_restores = len(_spans(tracer, "checkpoint.restore"))
        t0 = time.monotonic()
        try:
            with _device_memory(memory, "D"):
                summary_d = supervisor.run(
                    d_cfg.searcher.max_length, validation_period=d_cfg.min_validation_period,
                    checkpoint_period=d_cfg.min_checkpoint_period,
                    report_period=d_cfg.min_validation_period,
                )
        finally:
            faults.set_fault_injector(None)
        wall_d = time.monotonic() - t0
        restarted = trainers.pop()
        d_restore = _span_seconds(tracer, "checkpoint.restore")[n_restores:]
        log(f"experiment D (crash at {CRASH_AT}, restart): {wall_d:.1f} s, "
            + json.dumps(summary_d) + f", restore {json.dumps(d_restore)}")
        ckpts_d = _checkpoint_steps(os.path.join(root, "d"))
        log("experiment D checkpoints: " + json.dumps(ckpts_d))
        assert summary_d["restarts"] == 1 and summary_d["steps_completed"] == EXPERIMENT_STEPS
        assert len(attempts) == 2 and len(d_restore) == 1, (attempts, d_restore)
        out["D_vs_C"] = _compare_final("D (crashed, restarted)", restarted, ref, init_params)
        del restarted
        out.update(saves=saves, restore=restore, host_steps=host, device_memory_gib=memory,
                   wall_s=dict(A=wall_a, B=wall_b, D=wall_d))
        # C's final state on the host, for phase 17 to hold its cluster run against
        out["_C"] = (ref, init_params, host)
        out["peak_memory_gib"] = max(m["peak_gib"] for m in memory.values())
        log(f"experiment peak device memory: {out['peak_memory_gib']:.2f} GiB")
    finally:
        del trainers[:]
        shutil.rmtree(root, ignore_errors=True)
    return out


def _start_params(cfg, trial_cls) -> dict:
    """The trial's initial weights (seed experiment_seed + 1, as the local
    experiment's first trial), on the host."""
    from determined_tpu_torch import train

    hp = {k: v.val for k, v in cfg.hyperparameters.items()}
    ctx = train.init(hparams=hp, seed=cfg.reproducibility.experiment_seed + 1, device="cuda")
    model = trial_cls(ctx).build_model()
    return {k: v.detach().cpu() for k, v in model.named_parameters()}


# ---------------------------------------------------------------------------
# phase 8: searches (ASHA and PBT over the flagship, adaptive ASHA over MNIST)
# ---------------------------------------------------------------------------


def search_raw_config(part: str, ckpt_dir: str, seed: int) -> dict:
    """The configuration of search part ``part`` (S1, S2 or S3): its file's
    dict with its cuts applied."""
    base, cuts = {"S1": (EXPERIMENT_CONST, SEARCH_ASHA_CUTS),
                  "S2": (EXPERIMENT_CONST, SEARCH_PBT_CUTS),
                  "S3": (MNIST_ADAPTIVE, SEARCH_MNIST_CUTS)}[part]
    return _apply_cuts(base, cuts, {"<temp dir>": ckpt_dir, "<--seed>": seed})


def _lm_checkpoint_bytes(hp: dict) -> int:
    """Bytes of an LMTrial checkpoint: f32 params, first and second moments
    (embedding and head, per layer two norms, q/k/v/o and the 4x SwiGLU)."""
    d, layers, vocab = hp["d_model"], hp["n_layers"], hp["vocab_size"]
    return 12 * (2 * vocab * d + d + layers * (2 * d + 16 * d * d))


# the checkpoint spans of a search trial, by the key its stats give them
_TRIAL_SPANS = {"checkpoint.save": "sync_save", "checkpoint.write": "async_write",
                "checkpoint.finalize": "async_finalize", "trial.clone": "clone",
                "checkpoint.restore": "restore"}


def _measured_experiment_cls():
    """LocalExperiment that keeps, per trial, its steps, seconds, the
    seconds of its checkpoint spans (synchronous stop saves, the
    asynchronous save's write and finalize, the clone, the restore) and
    device memory at its start and peak, and records the searcher's events
    in order for the replay; ``delete_finished`` deletes a trial's
    checkpoint directory when the trial ends."""
    import copy
    import shutil

    import torch

    from determined_tpu_torch.experiment import LocalExperiment
    from determined_tpu_torch.observability import get_tracer

    class MeasuredExperiment(LocalExperiment):
        def __init__(self, *args, delete_finished: bool = False, **kwargs) -> None:
            super().__init__(*args, **kwargs)
            self.delete_finished = delete_finished
            self.events: list = []
            self.trial_stats: dict = {}
            for name in ("on_validation", "on_trial_exited", "on_trial_exited_early"):
                orig = getattr(self.searcher, name)

                def record(*args, _orig=orig, _name=name):
                    self.events.append((_name, copy.deepcopy(args)))
                    return _orig(*args)

                setattr(self.searcher, name, record)

        def _run_trial(self, create, devices=None):
            tracer = get_tracer()
            seen = {name: len(_spans(tracer, name)) for name in _TRIAL_SPANS}
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            t0 = time.monotonic()
            result = super()._run_trial(create, devices)
            torch.cuda.synchronize()
            rid = create.request_id
            self.trial_stats[rid] = dict(
                steps=result.steps_completed, stopped_early=result.stopped_early,
                hparams=result.hparams, seconds=time.monotonic() - t0,
                **{f"{key}_s": _span_seconds(tracer, name)[seen[name]:]
                   for name, key in _TRIAL_SPANS.items()},
                start_gib=start / 2 ** 30, peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
            )
            log(f"search trial {rid}: " + json.dumps(self.trial_stats[rid]))
            if self.delete_finished:
                shutil.rmtree(self._trial_checkpoint_dir(rid), ignore_errors=True)
            return result

    return MeasuredExperiment


def _replay(cfg, seed: int, events):
    """A fresh port Searcher for ``cfg`` fed the recorded events in order."""
    from determined_tpu_torch.searcher import Searcher, method_from_config

    replay = Searcher(method_from_config(cfg.searcher, cfg.hyperparameters),
                      cfg.hyperparameters, seed=seed)
    replay.start()
    for name, args in events:
        getattr(replay, name)(*args)
    return replay


def _check_trial_set(exp, cfg, seed: int, method_cls) -> int:
    """The experiment's trials (request ids, hparams, steps, stopped or not)
    against a fresh searcher replaying its searcher events in order; returns
    the number of trials."""
    replay = _replay(cfg, seed, exp.events)
    assert isinstance(replay.method, method_cls), type(replay.method)
    tm = cfg.searcher.time_metric or "batches"
    got = sorted((rid, json.dumps(r.hparams, sort_keys=True), r.steps_completed,
                  exp.searcher.is_stopped(rid)) for rid, r in exp.results.items())
    want = sorted((rid, json.dumps(t.hparams, sort_keys=True), int((t.metrics or {}).get(tm, 0)),
                   t.stopped_by_searcher) for rid, t in replay.trials.items())
    assert got == want, f"trial set {got} != replay {want}"
    assert replay.method.state_dict() == exp.searcher.method.state_dict()
    return len(got)


def _run_search(part: str, exp) -> tuple:
    """Run ``exp`` with the launch counters set to 0 just before and read
    just after; returns (summary, seconds, launches)."""
    import torch

    _reset_launches()
    t0 = time.monotonic()
    summary = exp.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _launch_counts()
    log(f"search {part}: {wall:.1f} s, " + json.dumps(summary))
    assert summary["status"] == "completed", summary
    return summary, wall, launches


def _early_stops(exp) -> list:
    """Trials the searcher stopped before their budget."""
    max_steps = exp.config.searcher.max_length.units
    return sorted(rid for rid, r in exp.results.items()
                  if exp.searcher.is_stopped(rid) and r.steps_completed < max_steps)


def _lm_launches(exp, steps: int) -> dict:
    """Kernel launches of an LMTrial search that trained ``steps`` steps:
    per layer a forward a step and a validation batch, a dq and a dk/dv a
    step; AdamW on every leaf a step (embedding, head, final norm, 9 a
    layer)."""
    hp = {k: v.val for k, v in exp.config.hyperparameters.items() if hasattr(v, "val")}
    layers, n_val = hp["n_layers"], hp["dataset_size"] // hp["global_batch_size"]
    validations = sum(1 for name, _ in exp.events if name == "on_validation")
    return dict(flash_fwd=layers * (steps + validations * n_val),
                flash_bwd_dq=layers * steps, flash_bwd_dkv=layers * steps,
                fused_adamw=(3 + 9 * layers) * steps)


def _peak_gib(exp) -> float:
    return max(t["peak_gib"] for t in exp.trial_stats.values())


def _search_asha(seed: int, root: str) -> dict:
    """S1: ASHA over the flagship's width at 2 layers."""
    import os

    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.models import LMTrial
    from determined_tpu_torch.searcher import ASHASearch, SearcherContext

    cfg = ExperimentConfig.parse(search_raw_config("S1", os.path.join(root, "asha"), seed))
    exp = _measured_experiment_cls()(cfg, LMTrial, checkpoint_dir=cfg.checkpoint_storage.host_path,
                                     delete_finished=True)
    _summary, wall, launches = _run_search("S1 (asha)", exp)
    n_trials = _check_trial_set(exp, cfg, seed, ASHASearch)
    # the trials are created up front, in request-id order: the k-th one
    # has the searcher's k-th draw, made here without a device
    draws = SearcherContext(cfg.hyperparameters, seed)
    for rid in sorted(exp.results):
        assert exp.results[rid].hparams == draws.sample(), rid
    stops = _early_stops(exp)
    assert stops, f"no trial was stopped early: {exp.trial_stats}"
    steps = sum(r.steps_completed for r in exp.results.values())
    want = _lm_launches(exp, steps)
    assert launches == want, f"launches {launches} != expected {want}"
    # every trial starts with no other trial's state on the device
    assert max(t["start_gib"] for t in exp.trial_stats.values()) < 1.0, exp.trial_stats
    return dict(wall_s=wall, trials_replayed=n_trials, steps=steps, stopped_early=stops,
                launches=launches, trials=exp.trial_stats, peak_memory_gib=_peak_gib(exp))


def clone_restore_check(root: str, searcher: list, restores: list):
    """A Callback class that holds each restored PBT child's parameters,
    both moments and step against its parent's checkpoint files under
    ``root`` (the parent named by the searcher in ``searcher[0]``) and
    appends {trial, parent, uuid, steps, bitwise} to ``restores``."""
    import os

    import torch

    from determined_tpu_torch.train import Callback, serialization

    class RestoreCheck(Callback):
        def on_training_start(self, trainer) -> None:
            sid = trainer.latest_checkpoint
            if not sid:
                return
            own = trainer.core.checkpoint._storage.base_path
            rid = int(os.path.basename(own).split("_")[1])
            src = searcher[0].trials[rid].source_trial_id
            parent = os.path.join(root, f"trial_{src}", sid)
            params = serialization.load_arrays(parent, "params")
            opt = serialization.load_arrays(parent, "opt_state")
            state = trainer.state.opt_state
            bitwise = all(torch.equal(p.detach().cpu(), params[k])
                          for k, p in trainer._params.items())
            for which in ("mu", "nu"):
                bitwise &= all(torch.equal(v.cpu(), opt[f"{which}/{k}"])
                               for k, v in getattr(state, which).items())
            bitwise &= int(state.count) == int(opt["count"]) == trainer.steps_completed
            restores.append(dict(trial=rid, parent=src, uuid=sid, steps=trainer.steps_completed,
                                 bitwise=bool(bitwise)))

    return RestoreCheck


def _pbt_capture(root: str, searcher: list):
    """LMTrial whose callback holds each restored child against its
    parent's checkpoint (``clone_restore_check``) and keeps every training
    report's ``lr`` with the trial's own lr."""
    import os

    import torch

    from determined_tpu_torch.models import LMTrial
    from determined_tpu_torch.train._optim import warmup_cosine_decay_schedule

    restores: list = []
    lr_reports: list = []

    class Capture(clone_restore_check(root, searcher, restores)):
        def __init__(self, trial) -> None:
            self.trial = trial

        def on_training_workload_end(self, steps_completed, metrics) -> None:
            g = self.trial.context.get_hparam
            period = self.trial.context.exp_config.min_validation_period.units
            own = warmup_cosine_decay_schedule(
                0.0, float(g("lr")), int(g("warmup_steps", 100)), int(g("decay_steps", 10000)))
            counts = torch.arange(steps_completed - period, steps_completed)
            trial_dir = self.trial.context.core.checkpoint._storage.base_path
            lr_reports.append(dict(trial=os.path.basename(trial_dir), lr=float(g("lr")),
                                   steps=steps_completed, reported=metrics["lr"],
                                   own_schedule=float(own(counts).float().mean())))

    class PBTLMTrial(LMTrial):
        def build_callbacks(self):
            return {"capture": Capture(self)}

    return PBTLMTrial, restores, lr_reports


def _search_pbt(seed: int, root: str) -> dict:
    """S2: PBT over the flagship's width at 2 layers."""
    import os

    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.observability import get_tracer
    from determined_tpu_torch.searcher import PBTSearch

    ckpt_dir = os.path.join(root, "pbt")
    cfg = ExperimentConfig.parse(search_raw_config("S2", ckpt_dir, seed))
    searcher: list = []
    trial_cls, restores, lr_reports = _pbt_capture(ckpt_dir, searcher)
    exp = _measured_experiment_cls()(cfg, trial_cls, checkpoint_dir=ckpt_dir)
    searcher.append(exp.searcher)
    _summary, wall, launches = _run_search("S2 (pbt)", exp)
    clones = get_tracer().counters().get("searcher.clones_materialized", 0.0)
    log("search S2 restores: " + json.dumps(restores))
    log("search S2 lr reports: " + json.dumps(lr_reports))
    assert isinstance(exp.searcher.method, PBTSearch)
    assert clones >= 1 and len(restores) == clones, (clones, restores)
    assert all(r["bitwise"] for r in restores), restores
    gen = cfg.searcher.max_length.units
    children = {rid: src for rid, src in exp.searcher.method.lineage.items() if src is not None}
    assert children and all(exp.results[rid].steps_completed == 2 * gen for rid in children), (
        children, {rid: r.steps_completed for rid, r in exp.results.items()})
    # each trial's lr metric follows its own lr; a perturbed child's is not
    # its parent's (the schedule is linear in its peak lr)
    lrs = {f"trial_{rid}": r.hparams["lr"] for rid, r in exp.results.items()}
    perturbed = [rid for rid, src in children.items() if lrs[f"trial_{rid}"] != lrs[f"trial_{src}"]]
    for rep in lr_reports:
        np.testing.assert_allclose(rep["reported"], rep["own_schedule"], rtol=1e-5)
        assert rep["lr"] == lrs[rep["trial"]], rep
    for rid in perturbed:
        (rep,) = [r for r in lr_reports if r["trial"] == f"trial_{rid}"]
        parents = rep["own_schedule"] * lrs[f"trial_{children[rid]}"] / rep["lr"]
        assert not np.isclose(rep["reported"], parents, rtol=1e-3), (rep, parents)
    # a child's steps_completed counts its parent's steps, which it did not run
    steps = sum(r.steps_completed for r in exp.results.values()) - gen * len(children)
    want = _lm_launches(exp, steps)
    assert launches == want, f"launches {launches} != expected {want}"
    hp = {k: v.val for k, v in cfg.hyperparameters.items() if hasattr(v, "val")}
    return dict(wall_s=wall, steps=steps, clones_materialized=clones, children=children,
                perturbed=perturbed, restores=restores, launches=launches,
                checkpoint_bytes=_lm_checkpoint_bytes(hp), trials=exp.trial_stats,
                peak_memory_gib=_peak_gib(exp))


def _mnist_recorder():
    """MnistTrial that records the shapes of every trial's parameters and
    the optimizer each trial builds."""
    from determined_tpu_torch.models import MnistTrial

    leaves: set = set()
    optimizers: list = []

    class RecordedMnistTrial(MnistTrial):
        def build_model(self):
            model = super().build_model()
            leaves.update(tuple(p.shape) for p in model.parameters())
            return model

        def build_optimizer(self):
            optimizers.append(super().build_optimizer())
            return optimizers[-1]

    return RecordedMnistTrial, leaves, optimizers


def check_adamw_leaves(seed: int, shapes, optimizers, label: str) -> float:
    """fused_adamw against its plain version with each of ``optimizers``
    (their lr, decay, clip and first-moment dtype; the scalars of step 3 as
    the optimizer makes them) at every leaf shape of ``shapes``; returns the
    largest difference."""
    import torch

    from determined_tpu_torch.ops import fused_adamw as fw

    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    count = torch.tensor(2, dtype=torch.int32, device="cuda")
    worst = 0.0
    for tx in dict.fromkeys(optimizers):
        kw = dict(b1=tx.b1, b2=tx.b2, eps=tx.eps, wd=tx.weight_decay)
        for shape in shapes:
            p = torch.randn(shape, generator=gen, device="cuda")
            g = torch.randn(shape, generator=gen, device="cuda")
            m = (0.1 * torch.randn(shape, generator=gen, device="cuda")).to(
                tx.mu_dtype or torch.float32)
            v = 0.01 * torch.rand(shape, generator=gen, device="cuda")
            scalars = tx.scalars(count, {"g": g})
            want = fw._leaf_reference(p, m, v, g, scalars, **kw)
            got = [p.clone(), m.clone(), v.clone()]
            fw.adamw_leaf_(*got, g, scalars, **kw)
            torch.cuda.synchronize()
            for what, a, b_ in zip("pmv", got, want):
                torch.testing.assert_close(
                    a.float(), b_.float(), **ADAMW_TOL[_dname(b_.dtype)],
                    msg=lambda m_, what=what, shape=shape: f"fused_adamw {label} {what} {shape}: {m_}")
                worst = max(worst, _max_err(a, b_))
        log(f"fused_adamw {label} optimizer lr={float(scalars[0]):.3e} wd={tx.weight_decay} "
            f"clip_norm={tx.clip_norm} clip_scale={float(scalars[1])} "
            f"mu={_dname(tx.mu_dtype or torch.float32)}: {len(shapes)} leaf shapes agree")
    log(f"fused_adamw {label}: {len(shapes)} shapes {shapes}, max_abs_err {worst:.3e}")
    return worst


def _search_mnist(seed: int, root: str) -> dict:
    """S3: examples/mnist/adaptive.yaml through MnistTrial (its own seed)."""
    import os

    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.searcher import TournamentSearch

    cfg = ExperimentConfig.parse(search_raw_config("S3", os.path.join(root, "mnist"), seed))
    trial_cls, leaves, optimizers = _mnist_recorder()
    exp = _measured_experiment_cls()(cfg, trial_cls,
                                     checkpoint_dir=cfg.checkpoint_storage.host_path)
    _summary, wall, launches = _run_search("S3 (mnist adaptive_asha)", exp)
    assert cfg.searcher.name == "adaptive_asha"
    n_trials = _check_trial_set(exp, cfg, cfg.reproducibility.experiment_seed, TournamentSearch)
    stops = _early_stops(exp)
    assert stops, "adaptive ASHA stopped no trial early"
    best = max(r.metrics["validation_accuracy"] for r in exp.results.values())
    assert best > 0.5, best
    steps = sum(r.steps_completed for r in exp.results.values())
    # the MLP's 4 leaves (two weights, two biases) a step, no attention
    want = dict(flash_fwd=0, flash_bwd_dq=0, flash_bwd_dkv=0, fused_adamw=4 * steps)
    assert launches == want, f"launches {launches} != expected {want}"
    # the kernel at these leaves with these optimizers, after the counts
    # were read
    adamw_err = check_adamw_leaves(seed, sorted(set(leaves) | set(MNIST_ADAMW_SHAPES)),
                                   optimizers, "S3")
    return dict(wall_s=wall, trials_replayed=n_trials, steps=steps, stopped_early=stops,
                best_validation_accuracy=best, launches=launches, peak_memory_gib=_peak_gib(exp),
                adamw_max_abs_err=adamw_err)


def phase_search(seed: int) -> dict:
    """Parts S1, S2 and S3 of phase 8 (the docstring at the top)."""
    import os
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="dtt-chip-search-")
    free = shutil.disk_usage(root).free
    log(f"search: checkpoints under {root}, {free / 2**30:.1f} GiB free")
    for part, cuts in (("S1", SEARCH_ASHA_CUTS), ("S2", SEARCH_PBT_CUTS),
                       ("S3", SEARCH_MNIST_CUTS)):
        for path, const, value, why in cuts:
            value = seed if value == "<--seed>" else value
            log(f"search {part} cut: {path} {json.dumps(const)} -> {json.dumps(value)} ({why})")
    hp1 = search_raw_config("S1", root, seed)["hyperparameters"]
    hp2 = search_raw_config("S2", root, seed)["hyperparameters"]
    # S1 keeps one checkpoint at a time; S2 its four members' checkpoints,
    # two clone copies and one staging copy
    need = max(_lm_checkpoint_bytes(hp1), 7 * _lm_checkpoint_bytes(hp2))
    assert free > 1.1 * need, f"{free / 2**30:.1f} GiB free; the phase needs {need / 2**30:.1f}"
    out: dict = {}
    try:
        for part, fn in (("S1", _search_asha), ("S2", _search_pbt), ("S3", _search_mnist)):
            gc.collect()
            out[part] = fn(seed, root)
            log(f"search {part}: " + json.dumps(
                {k: v for k, v in out[part].items() if k not in ("trials", "restores")}))
            shutil.rmtree(os.path.join(root, {"S1": "asha", "S2": "pbt", "S3": "mnist"}[part]),
                          ignore_errors=True)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = {k: sum(out[p]["launches"][k] for p in ("S1", "S2", "S3"))
                       for k in out["S1"]["launches"]}
    return out




# ---------------------------------------------------------------------------
# phase 9: observe (the tracer's export, the ledger, a torch.profiler window)
# ---------------------------------------------------------------------------


def observe_raw_config(ckpt_dir: str, seed: int) -> dict:
    """EXPERIMENT_CONST with OBSERVE_CUTS applied."""
    return _apply_cuts(EXPERIMENT_CONST, OBSERVE_CUTS, {"<temp dir>": ckpt_dir,
                                                       "<--seed>": seed})


def _observed_trial():
    """LMTrial that turns its core context's profiler on from the
    experiment's ``profiling`` section (as the JAX package's cluster entry
    point does; the local runner never does), and keeps that core context
    and the seconds each trace window took to close."""
    from determined_tpu_torch.models import LMTrial

    class ObservedLMTrial(LMTrial):
        cores: list = []
        stop_s: list = []

        def __init__(self, context) -> None:
            super().__init__(context)
            profiler = context.core.profiler
            stop = profiler.stop_trace

            def timed_stop() -> None:
                if profiler.tracing:
                    t0 = time.monotonic()
                    stop()
                    ObservedLMTrial.stop_s.append(time.monotonic() - t0)

            profiler.stop_trace = timed_stop
            ObservedLMTrial.cores.append(context.core)
            prof = context.exp_config.profiling
            if prof.get("enabled"):
                profiler.on(sampling=True, trace=bool(prof.get("trace")))

    return ObservedLMTrial


def phase_observe(seed: int, train_mfu) -> dict:
    """Phase 9: const.yaml's flagship through LocalExperiment with the
    tracer exported and a torch.profiler window over its first steps; the
    files, the ledger, the window's op table, the ``profile`` row and the
    ``experiment profile`` / ``status`` verbs are checked."""
    import os
    import shutil
    import tempfile

    import torch

    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.core import ProfilerContext
    from determined_tpu_torch.core._profiler import _cuda_memory_stats
    from determined_tpu_torch.experiment import LocalExperiment
    from determined_tpu_torch.observability import get_tracer
    from determined_tpu_torch.utils import kineto

    root = tempfile.mkdtemp(prefix="dtt-chip-observe-")
    for path, const, value, why in OBSERVE_CUTS:
        value = seed if value == "<--seed>" else value
        log(f"observe cut: {path} {json.dumps(const)} -> {json.dumps(value)} ({why})")
    default_interval, interval, why = OBSERVE_SAMPLE_CUT
    assert ProfilerContext.SAMPLE_INTERVAL == default_interval, ProfilerContext.SAMPLE_INTERVAL
    log(f"observe cut: ProfilerContext.SAMPLE_INTERVAL {default_interval} -> {interval} ({why})")
    trial_cls = _observed_trial()
    t_phase = time.monotonic()
    ProfilerContext.SAMPLE_INTERVAL = interval
    try:
        cfg = ExperimentConfig.parse(observe_raw_config(root, seed))
        _reset_launches()  # counts from here on are the traced run's
        t0 = time.monotonic()
        summary = LocalExperiment(cfg, trial_cls, checkpoint_dir=root).run()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        launches = _launch_counts()
        log(f"observe run: {wall:.1f} s, " + json.dumps(summary))
        assert summary["status"] == "completed" and summary["total_steps"] == OBSERVE_STEPS

        # ---- the tracer's files and the ledger --------------------------------
        traces = os.path.join(root, "traces")
        for name in ("events.jsonl", "trace.json", "goodput.json"):
            assert os.path.isfile(os.path.join(traces, name)), f"traces/{name} missing"
        with open(os.path.join(traces, "goodput.json")) as f:
            ledger = json.load(f)
        hp = cfg.hyperparameters
        tokens = OBSERVE_STEPS * hp["global_batch_size"].val * hp["seq_len"].val
        (rid, trial), = ledger["trials"].items()
        assert trial.get("steps") == OBSERVE_STEPS, trial
        assert trial.get("tokens") == tokens, (trial.get("tokens"), tokens)
        assert ledger["dropped_events"] == 0, ledger["dropped_events"]
        assert {"step", "setup", "validate"} <= set(trial["breakdown"]), trial["breakdown"]
        exp = ledger["experiment"]
        goodput = dict(
            attributed_pct=exp["attributed_pct"], productive_pct=exp["productive_pct"],
            seconds_by_category={k: v["seconds"] for k, v in exp["breakdown"].items()},
            trial_wall_s=trial["wall_s"], trial_tokens_per_s=trial.get("tokens_per_s"),
            trial_mfu=trial.get("mfu_estimate"), phase5_mfu=train_mfu,
            experiment_wall_s=exp["wall_s"], events=len(get_tracer().chrome_events()),
        )
        log("observe ledger: " + json.dumps(goodput))

        # ---- the profiler's window: its op table and the profile row ----------
        files = kineto.trace_files(os.path.join(traces, "torch_profiler"))
        assert len(files) == 1, files
        ops = kineto.op_table(files)
        counts = kineto.category_counts(ops)
        (core_ctx,) = trial_cls.cores
        layers, n_leaves = hp["n_layers"].val, 75
        want_window = dict(flash_fwd=layers * OBSERVE_WINDOW, flash_bwd_dq=layers * OBSERVE_WINDOW,
                           flash_bwd_dkv=layers * OBSERVE_WINDOW,
                           fused_adamw=n_leaves * OBSERVE_WINDOW)
        got_window = {k: counts.get(k, 0) for k in want_window}
        log("observe window launches: " + json.dumps(got_window))
        assert got_window == want_window, f"window launches {got_window} != {want_window}"
        (_step, row), = core_ctx.train.metrics("profile")
        assert row["op_table"] and all("time_us" in op for op in row["op_table"]), row
        assert row["category_totals"], row
        # the sampler's rows: host keys and the card's memory keys, the limit
        # the card's own and the bytes in use never above the run's peak
        samples = core_ctx.train.metrics("system_metrics")
        assert samples, "the system sampler reported no row"
        device_keys = ("device0_bytes_in_use", "device0_bytes_limit", "device0_hbm_util_pct")
        _free, card_bytes = torch.cuda.mem_get_info(0)
        peak = torch.cuda.max_memory_allocated(0)
        for _, m in samples:
            # cpu_util_pct is left out of a row when /proc/stat did not move
            # between two samples, as in the JAX sampler
            assert "memory_used_bytes" in m and all(k in m for k in device_keys), m
            assert m["device0_bytes_limit"] == card_bytes, (m, card_bytes)
            assert 0 < m["device0_bytes_in_use"] <= peak, (m, peak)
            share = 100.0 * m["device0_bytes_in_use"] / card_bytes
            assert abs(m["device0_hbm_util_pct"] - share) <= 1e-9, (m, share)
        # and one sample taken now, against the allocator's own count
        now = _cuda_memory_stats()
        allocated = torch.cuda.memory_allocated(0)
        assert abs(now["device0_bytes_in_use"] - allocated) <= 1 << 20, (now, allocated)
        assert now["device0_bytes_limit"] == card_bytes, (now, card_bytes)
        n_val = 16  # dataset_size 128 at a global batch of 8
        want = dict(flash_fwd=layers * (OBSERVE_STEPS + n_val),
                    flash_bwd_dq=layers * OBSERVE_STEPS, flash_bwd_dkv=layers * OBSERVE_STEPS,
                    fused_adamw=n_leaves * OBSERVE_STEPS)
        assert launches == want, f"launches {launches} != expected {want}"
        window = dict(
            trace_bytes=os.path.getsize(files[0]),
            tracer_trace_bytes=os.path.getsize(os.path.join(traces, "trace.json")),
            stop_s=trial_cls.stop_s,
            device_ms_by_category={k: v / 1e3 for k, v in kineto.category_totals(ops).items()},
            top_kernels=[[op["name"][:90], op["time_us"] / 1e3, op["count"]] for op in ops[:10]],
            profile_row_ops=len(row["op_table"]), system_metrics_rows=len(samples),
            device0_bytes_in_use_max=max(m["device0_bytes_in_use"] for _, m in samples),
            device0_bytes_limit=card_bytes,
        )
        log("observe window: " + json.dumps(window))

        # ---- host time of the traced steps against the untraced ones ----------
        # step k's interval runs from its data.wait start to the next one's;
        # the window closes inside step OBSERVE_WINDOW's interval
        starts = [s[0] for s in _spans(get_tracer(), "data.wait")]
        assert len(starts) == OBSERVE_STEPS, len(starts)
        step_ms = [1e3 * (b - a) for a, b in zip(starts, starts[1:])]
        host = dict(
            traced_steps_ms=step_ms[:OBSERVE_WINDOW - 1],
            window_close_step_ms=step_ms[OBSERVE_WINDOW - 1],
            untraced_steps_ms=step_ms[OBSERVE_WINDOW:],
            mean_untraced_ms=statistics.mean(step_ms[OBSERVE_WINDOW:]),
        )
        log("observe host steps: " + json.dumps(host))

        # ---- the CLI verbs, as a user runs them ----------------------------------
        here = os.path.dirname(os.path.abspath(__file__))

        def cli(*args):
            proc = subprocess.run(
                [sys.executable, "-m", "determined_tpu_torch.cli", "experiment", *args, root],
                cwd=here, capture_output=True, text=True, timeout=300,
            )
            assert proc.returncode == 0, (args, proc.returncode, proc.stderr[-2000:])
            return proc.stdout

        log("observe `experiment profile`:\n" + cli("profile"))
        cli_ledger = json.loads(cli("profile", "--json"))["ledger"]
        assert cli_ledger == ledger, "the CLI's ledger (events.jsonl) differs from goodput.json"
        log("observe `experiment status`:\n" + cli("status"))
        assert json.loads(cli("status", "--json"))["status"] == "completed"
    finally:
        ProfilerContext.SAMPLE_INTERVAL = default_interval
        shutil.rmtree(root, ignore_errors=True)
    out = dict(wall_s=wall, phase_s=time.monotonic() - t_phase, launches=launches,
               window_launches=got_window, goodput=goodput, window=window, host_steps=host)
    log(f"observe: phase {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 10: knobs (gradient accumulation, quantized matmuls, the build cache)
# ---------------------------------------------------------------------------


def _lm_trainer(hp: dict, seed: int, **opt):
    """Trainer(LMTrial) over ``hp`` with the experiment's ``optimizations``
    knobs ``opt``, through init as a user calls it."""
    from determined_tpu_torch import train
    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.models import LMTrial

    cfg = ExperimentConfig.parse({"hyperparameters": hp, "optimizations": opt})
    return train.Trainer(LMTrial(train.init(exp_config=cfg, seed=seed)))


def _fit_steps(trainer, steps: int, report: int) -> dict:
    """``fit`` for ``steps`` steps, no validation or checkpoint; the launch
    counters are set to 0 just before and read just after.  Returns the
    reports' losses, the mean step time past the first report (the
    warm-up), the wall time, the launches and the peak device memory."""
    import torch

    from determined_tpu_torch.train import _quant

    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    _quant.reset_launches()
    t0 = time.monotonic()
    trainer.fit(max_length=steps, report_period=report, checkpoint_policy="none")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = dict(_launch_counts(), **{f"quant_{k}": v for k, v in _quant.launches.items()})
    reports = trainer.core.train.metrics("training")
    assert [s for s, _ in reports] == list(range(report, steps + 1, report)), reports
    gbs = trainer.train_loader.sampler.global_batch * trainer.agg
    step_ms = [1e3 * gbs / m["samples_per_second"] for _, m in reports]
    losses = [m["loss"] for _, m in reports]
    assert all(np.isfinite(x) for x in losses), losses
    return dict(losses=losses, step_ms=step_ms, mean_step_ms=statistics.mean(step_ms[1:]),
                wall_s=wall, launches=launches,
                peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


def _free_cuda() -> None:
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def knobs_agg(seed: int, train_peak_gib) -> dict:
    """(a) aggregation_frequency 4 through fit, then one agg-4 update held
    against one global-batch-32 update over the same 32 samples."""
    import torch

    from determined_tpu_torch.data import to_device

    hp = dict(TRAIN_HPARAMS)
    layers = hp["n_layers"]
    trainer = _lm_trainer(hp, seed, aggregation_frequency=KNOBS_AGG)
    run = _fit_steps(trainer, KNOBS_AGG_STEPS, KNOBS_AGG_REPORT)
    steps, n_leaves = KNOBS_AGG_STEPS, len(trainer._params)
    micro = KNOBS_AGG * steps
    want = dict(flash_fwd=layers * micro, flash_bwd_dq=layers * micro,
                flash_bwd_dkv=layers * micro, fused_adamw=n_leaves * steps,
                quant_int8=0, quant_fp8=0)
    assert n_leaves == 75 and run["launches"] == want, (run["launches"], want)
    tokens = KNOBS_AGG * hp["global_batch_size"] * hp["seq_len"]
    tokens_per_s = tokens / (run["mean_step_ms"] / 1e3)
    mfu = trainer.trial.flops_per_token * tokens_per_s / PEAK_FLOPS["bfloat16"]
    assert run["losses"][-1] < run["losses"][0], run["losses"]
    del trainer
    _free_cuda()

    # one update from the same weights: agg 4 x 8 against 1 x 32
    cmp_hp = dict(hp, **{k: v for k, _, v, _ in KNOBS_AGG_CMP_CUTS})
    for key, const, value, why in KNOBS_AGG_CMP_CUTS:
        log(f"knobs agg comparison cut: {key} {const} -> {value} ({why})")
    agg = _lm_trainer(cmp_hp, seed, aggregation_frequency=KNOBS_AGG)
    agg._setup()
    start = {k: v.detach().to("cpu", copy=True) for k, v in agg._params.items()}
    _, stacked = next(agg.train_loader.iter_pairs(agg=KNOBS_AGG))
    torch.cuda.reset_peak_memory_stats()
    agg._train_step(to_device(stacked, agg.device))
    torch.cuda.synchronize()
    peak_agg = torch.cuda.max_memory_allocated() / 2 ** 30
    loss_agg = agg.state.fetch_metrics()["loss"]
    got = {k: tuple(t.detach().to("cpu", copy=True) for t in (
        p, agg.state.opt_state.mu[k], agg.state.opt_state.nu[k])) for k, p in agg._params.items()}
    del agg
    _free_cuda()
    big = _lm_trainer(dict(cmp_hp, global_batch_size=KNOBS_AGG * hp["global_batch_size"]), seed)
    big._setup()
    with torch.no_grad():
        for k, p in big._params.items():
            p.copy_(start[k])
    flat = {k: v.reshape(-1, *v.shape[2:]) for k, v in stacked.items()}
    torch.cuda.reset_peak_memory_stats()
    big._train_step(to_device(flat, big.device))
    torch.cuda.synchronize()
    peak_big = torch.cuda.max_memory_allocated() / 2 ** 30
    loss_big = big.state.fetch_metrics()["loss"]
    tol = KNOBS_AGG_TOL
    lr = float(cmp_hp["lr"])
    worst = dict(mu=0.0, nu=0.0)
    moved_other_way = 0
    n_elems = 0
    for k, p in big._params.items():
        p_agg, mu_agg, nu_agg = (t.cuda() for t in got[k])
        for name, a, b in (("mu", mu_agg, big.state.opt_state.mu[k]),
                           ("nu", nu_agg, big.state.opt_state.nu[k])):
            rel = float(torch.linalg.vector_norm(a.float() - b.float())
                        / torch.linalg.vector_norm(b.float()).clamp_min(1e-30))
            worst[name] = max(worst[name], rel)
        upd_agg, upd_big = p_agg - start[k].cuda(), p.detach() - start[k].cuda()
        moved_other_way += int(((upd_agg - upd_big).abs() > lr).sum())
        n_elems += p.numel()
    del big
    _free_cuda()
    out = dict(
        card=card_line(), agg=KNOBS_AGG, global_batch_size=hp["global_batch_size"],
        steps=steps, step_ms_per_report=run["step_ms"], mean_step_ms=run["mean_step_ms"],
        tokens_per_step=tokens, tokens_per_s=tokens_per_s, mfu_vs_989_tflops=mfu,
        losses=run["losses"], peak_memory_gib=run["peak_memory_gib"],
        phase5_peak_memory_gib=train_peak_gib, launches=run["launches"], wall_s=run["wall_s"],
        update_vs_gbs32=dict(loss_agg4=loss_agg, loss_gbs32=loss_big,
                             max_rel_mu=worst["mu"], max_rel_nu=worst["nu"],
                             share_moved_other_way=moved_other_way / n_elems,
                             step_peak_memory_gib_agg4=peak_agg,
                             step_peak_memory_gib_gbs32=peak_big, tol=tol),
    )
    log("knobs agg: " + json.dumps(out))
    np.testing.assert_allclose(loss_agg, loss_big, rtol=tol["loss_rtol"])
    assert worst["mu"] <= tol["moment_rel"] and worst["nu"] <= tol["moment_rel"], worst
    assert moved_other_way / n_elems <= tol["moved_other_way"], moved_other_way / n_elems
    return out


def _quant_gemm_rows(ops, plain_names, markers) -> list:
    """The matmul rows of an op table that the unquantized run's table lacks
    and whose names carry one of ``markers`` (the int8 or fp8 products)."""
    from determined_tpu_torch.utils import kineto

    return [[op["name"][:110], op["time_us"] / 1e3, op["count"]] for op in ops
            if kineto.kernel_category(op["name"]) == "matmul" and op["name"] not in plain_names
            and any(m in op["name"].lower() for m in markers)]


def knobs_quant(seed: int) -> dict:
    """(b) the flagship at quantized_matmul none, int8 and fp8 from the same
    weights and batches: loss curves, step and device time, the op table's
    int8 and fp8 gemm rows."""
    hp = dict(TRAIN_HPARAMS)
    layers = hp["n_layers"]
    runs, profiles = {}, {}
    for mode in ("none", "int8", "fp8"):
        trainer = _lm_trainer(hp, seed, quantized_matmul=mode)
        run = _fit_steps(trainer, KNOBS_QUANT_STEPS, 1)
        assert trainer.model.cfg.quantized_matmul == mode
        steps = KNOBS_QUANT_STEPS
        want = dict(flash_fwd=layers * steps, flash_bwd_dq=layers * steps,
                    flash_bwd_dkv=layers * steps, fused_adamw=75 * steps, quant_int8=0,
                    quant_fp8=0)
        if mode != "none":
            # q, k, v, o, gate, up, down of every layer; the fused
            # cross-entropy head stays bf16
            want[f"quant_{mode}"] = 7 * layers * steps
        assert run["launches"] == want, (mode, run["launches"], want)
        prof = profile_train(trainer)
        profiles[mode] = prof
        runs[mode] = run
        del trainer
        _free_cuda()
    plain_names = {op["name"] for op in profiles["none"]["ops"]}
    ref = runs["none"]["losses"]
    out = dict(card=card_line(), steps=KNOBS_QUANT_STEPS, modes={})
    for mode in ("none", "int8", "fp8"):
        run, prof = runs[mode], profiles[mode]
        rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"], ref))
        entry = dict(losses=run["losses"], max_rel_loss_vs_bf16=rel,
                     mean_step_ms=run["mean_step_ms"], peak_memory_gib=run["peak_memory_gib"],
                     device_ms_per_step=prof["device_ms_per_step"],
                     device_ms_per_step_by_group=prof["device_ms_per_step_by_group"],
                     launches=run["launches"])
        if mode != "none":
            entry["gemm_rows"] = _quant_gemm_rows(
                prof["ops"], plain_names, QUANT_GEMM_MARKERS[mode])
        out["modes"][mode] = entry
    log("knobs quant: " + json.dumps(out))
    for mode in ("int8", "fp8"):
        entry = out["modes"][mode]
        assert entry["max_rel_loss_vs_bf16"] < KNOBS_QUANT_LOSS_REL, (mode, entry["losses"], ref)
        assert entry["gemm_rows"], f"no {mode} gemm in the op table of the {mode} run"
    return out


def knobs_quant_linears(seed: int) -> dict:
    """Each quantized linear of the flagship on the card (the int8 and fp8
    tensor-core products) against its plain version, timed beside the bf16
    ``F.linear``, at the training shapes (8 x 1024 rows)."""
    import torch
    import torch.nn.functional as F

    from determined_tpu_torch.train import _quant

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = TRAIN_HPARAMS["global_batch_size"] * TRAIN_HPARAMS["seq_len"]
    out = {}
    for name, (k, n) in QUANT_LINEAR_SHAPES.items():
        x = torch.randn(rows, k, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(n, k, generator=gen, device="cuda") * k ** -0.5).bfloat16()
        row = dict(x=[rows, k], w=[n, k],
                   bf16_linear_ms=device_time_us(lambda: F.linear(x, w)) / 1e3)
        for mode in ("int8", "fp8"):
            _quant.reset_launches()
            got = _quant.quantized_matmul(x, w, mode)
            assert _quant.launches[mode] == 1
            want = _quant.quantized_matmul_reference(x, w, mode)
            tol = QUANT_LINEAR_TOL[mode]
            scale = want.float().abs().max().item()
            err = _max_err(got, want)
            torch.testing.assert_close(got.float(), want.float(), rtol=tol["rtol"],
                                       atol=tol["atol"] * scale)
            qx, sx = _quant.quantize(x, mode)
            qw, sw = _quant.quantize(w, mode)
            if mode == "int8":
                gemm = lambda: torch._int_mm(qx, qw.t())  # noqa: E731
            else:
                sa, sb = sx[:, None].contiguous(), sw[None, :].contiguous()
                gemm = lambda: torch._scaled_mm(  # noqa: E731
                    qx, qw.t(), scale_a=sa, scale_b=sb, out_dtype=torch.bfloat16)
            row[mode] = dict(
                max_abs_err=err, max_abs_want=scale, tol=tol,
                ms=device_time_us(lambda: _quant.quantized_matmul(x, w, mode)) / 1e3,
                gemm_ms=device_time_us(gemm) / 1e3,
                plain_ms=device_time_us(lambda: _quant.quantized_matmul_reference(x, w, mode))
                / 1e3,
                quantize_ms=device_time_us(lambda: _quant.quantize(x, mode)) / 1e3,
            )
        out[name] = row
        del x, w
    # an f32 compute dtype takes the other _scaled_mm call (the q/k/v/o shape)
    k, n = QUANT_LINEAR_SHAPES["q_k_v_o"]
    x = torch.randn(rows, k, generator=gen, device="cuda")
    w = torch.randn(n, k, generator=gen, device="cuda") * k ** -0.5
    row = dict(x=[rows, k], w=[n, k], f32_linear_ms=device_time_us(lambda: F.linear(x, w)) / 1e3)
    for mode in ("int8", "fp8"):
        _quant.reset_launches()
        got = _quant.quantized_matmul(x, w, mode)
        assert _quant.launches[mode] == 1 and got.dtype == torch.float32
        want = _quant.quantized_matmul_reference(x, w, mode)
        tol = QUANT_LINEAR_F32_TOL[mode]
        scale = want.abs().max().item()
        torch.testing.assert_close(got, want, rtol=tol["rtol"], atol=tol["atol"] * scale)
        row[mode] = dict(max_abs_err=_max_err(got, want), max_abs_want=scale, tol=tol,
                         ms=device_time_us(lambda: _quant.quantized_matmul(x, w, mode)) / 1e3)
    out["q_k_v_o_f32"] = row
    del x, w
    log("knobs quantized linears: " + json.dumps(out))
    return out


_CACHE_PROBE = """
import json, logging, sys, time
t0 = time.monotonic()
logging.basicConfig(level=logging.INFO, stream=sys.stderr, format="%(message)s")
import torch
from determined_tpu_torch import train
from determined_tpu_torch.config import ExperimentConfig
from determined_tpu_torch.ops import _build
from determined_tpu_torch.ops.flash_attention import flash_attention_fwd
if sys.argv[2] == "hit":
    def no_nvcc():
        raise RuntimeError("nvcc was called on a warm compilation cache")
    _build.find_nvcc = no_nvcc
cfg = ExperimentConfig.parse({"optimizations": {"compilation_cache_dir": sys.argv[1]}})
train.init(exp_config=cfg)
t1 = time.monotonic()
sources = sys.argv[3].split(",")
paths = _build.build_all(sources)
for s in sources:
    _build.load(s)
t2 = time.monotonic()
q = torch.randn(1, 4, 256, 128, device="cuda", dtype=torch.bfloat16)
out, _lse = flash_attention_fwd(q, q, q, causal=True, scale=128 ** -0.5)
torch.cuda.synchronize()
assert bool(torch.isfinite(out).all())
print(json.dumps(dict(build_dir=_build.BUILD_DIR, libraries=paths, import_s=t1 - t0,
                      build_and_load_s=t2 - t1, total_s=time.monotonic() - t0)))
"""


def knobs_cache() -> dict:
    """(c) compilation_cache_dir: a first process builds every kernel into
    an empty directory (MISS), a second finds them there and never calls
    nvcc (HIT); each launches the flash forward from the cached library."""
    import os
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    out = {}
    with tempfile.TemporaryDirectory(prefix="dtt-chip-kernel-cache-") as cache:
        for mode in ("miss", "hit"):
            t0 = time.monotonic()
            proc = subprocess.run(
                [sys.executable, "-c", _CACHE_PROBE, cache, mode, ",".join(KERNEL_SOURCES)],
                cwd=here, capture_output=True, text=True, timeout=600,
            )
            wall = time.monotonic() - t0
            assert proc.returncode == 0, (mode, proc.stderr[-3000:])
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            lines = [ln for ln in proc.stderr.splitlines() if "compilation cache" in ln]
            assert len(lines) == 1 and mode.upper() in lines[0], (mode, lines)
            assert res["build_dir"] == cache and all(
                os.path.dirname(p) == cache for p in res["libraries"]), res
            out[mode] = dict(process_s=wall, log=lines[0], **{
                k: res[k] for k in ("import_s", "build_and_load_s", "total_s")})
    log("knobs compilation cache: " + json.dumps(out))
    return out


def phase_knobs(seed: int, train_peak_gib) -> dict:
    """Phase 10 (the docstring at the top)."""
    t0 = time.monotonic()
    out = dict(agg=knobs_agg(seed, train_peak_gib))
    out["quant"] = knobs_quant(seed)
    out["quant_linears"] = knobs_quant_linears(seed)
    out["cache"] = knobs_cache()
    out["launches"] = out["agg"]["launches"]
    out["phase_s"] = time.monotonic() - t0
    log(f"knobs: phase {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 11: serve_ckpt (train, save, serve from the checkpoint, batch inference)
# ---------------------------------------------------------------------------


def _serve_tokens(worker, prompts) -> tuple:
    """Greedy tokens of each prompt through the worker's HTTP entry point,
    one request at a time; each response's TTFT and the engine's prefix
    cache hits."""
    url = worker.start()
    try:
        tokens, ttft = [], []
        for p in prompts:
            status, body = post(url, "/v1/generate", {
                "prompt_tokens": p, "max_new_tokens": SERVE_CKPT_NEW_TOKENS, "temperature": 0.0})
            assert status == 200, body
            assert len(body["tokens"]) == SERVE_CKPT_NEW_TOKENS, body
            tokens.append(body["tokens"])
            ttft.append(body["ttft_ms"])
        hits = worker.engine.stats()["prefix_hits"]
    finally:
        worker.shutdown()
    return tokens, ttft, hits


def _latest_progress(score_dir: str) -> str:
    """The storage id of the batch-inference progress checkpoint with the
    most batches done."""
    import os

    from determined_tpu_torch import inference

    done = {}
    for sid in os.listdir(score_dir):
        marker = os.path.join(score_dir, sid, inference.PROGRESS_FILE)
        if os.path.isfile(marker):
            with open(marker) as f:
                done[sid] = json.load(f)["batches_done"]
    assert done, f"no progress checkpoint under {score_dir}"
    return max(done, key=done.get)


def phase_serve_ckpt(seed: int) -> dict:
    """Phase 11 (the docstring at the top)."""
    import os
    import shutil
    import tempfile
    import types

    import torch

    from determined_tpu_torch import core, inference, train
    from determined_tpu_torch.data import SyntheticDataset
    from determined_tpu_torch.models import LMTrial
    from determined_tpu_torch.observability import get_tracer
    from determined_tpu_torch.serve import DecodeKernels, ServeEngine, ServeWorker

    t_phase = time.monotonic()
    root = tempfile.mkdtemp(prefix="dtt-chip-serve-ckpt-")
    free = shutil.disk_usage(root).free
    hp = dict(EXPERIMENT_CONST["hyperparameters"], dataset_size=SERVE_CKPT_DATASET)
    for key, old, value, why in SERVE_CKPT_CUTS:
        assert hp[key] == old, (key, hp[key])
        hp[key] = value
        log(f"serve_ckpt cut: {key} {old} -> {value} ({why})")
    log(f"serve_ckpt: checkpoints under {root}, {free / 2**30:.1f} GiB free")
    tracer = get_tracer()
    out: dict = {}
    try:
        need = _lm_checkpoint_bytes(hp)
        assert free > 1.1 * need, (
            f"{free / 2**30:.1f} GiB free under {root}; the phase needs {need / 2**30:.1f} GiB")
        ctx = train.init(hparams=hp, seed=seed,
                         core_context=core._dummy_init(checkpoint_dir=os.path.join(root, "ck")))
        trainer = train.Trainer(LMTrial(ctx))
        tracer.reset()
        t0 = time.monotonic()
        summary = trainer.fit(max_length=SERVE_CKPT_STEPS, checkpoint_policy="best")
        train_s = time.monotonic() - t0
        (save_s,) = _span_seconds(tracer, "checkpoint.save")  # the final, synchronous save
        path = os.path.join(root, "ck", summary["latest_checkpoint"])
        ckpt_bytes = _dir_bytes(path)
        assert summary["steps_completed"] == SERVE_CKPT_STEPS

        prompts = make_prompts(seed + 1, hp["vocab_size"])[:SERVE_CKPT_REQUESTS]
        scfg = serve_config()
        mem_tokens, _, _ = _serve_tokens(
            ServeWorker(ServeEngine(DecodeKernels(trainer.model, scfg))), prompts)
        del trainer, ctx
        _free_cuda()

        tracer.reset()
        t0 = time.monotonic()
        engine = ServeEngine.from_checkpoint(path, scfg)
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
        assert engine.model_label == "LMTrial", engine.model_label
        (verify_s,), (restore_s,) = (_span_seconds(tracer, "checkpoint.verify"),
                                     _span_seconds(tracer, "checkpoint.load"))
        _free_cuda()
        _reset_launches()
        ckpt_tokens, ttft, hits = _serve_tokens(ServeWorker(engine), prompts)
        assert ckpt_tokens == mem_tokens, "the checkpoint serves other tokens than the trainer"

        # batch inference: score a prompt set with the served model,
        # preempted midway and resumed
        model = engine.kernels.model
        data = SyntheticDataset(
            {"tokens": ((hp["seq_len"] + 1,), np.int32, hp["vocab_size"])},
            size=SERVE_CKPT_SCORE_BATCHES * SERVE_CKPT_SCORE_BATCH, seed=seed + 2)
        scores: dict = {}
        preempt_at = SERVE_CKPT_SCORE_BATCHES // 2

        class Scorer(inference.BatchProcessor):
            def process_batch(self, batch, batch_idx):
                tokens = torch.from_numpy(batch["tokens"]).cuda().long()
                with torch.no_grad():
                    logp = torch.log_softmax(model(tokens[:, :-1]), dim=-1)
                    nll = -logp.gather(-1, tokens[:, 1:, None])[..., 0].mean(dim=1)
                assert batch_idx not in scores, f"batch {batch_idx} processed twice"
                scores[batch_idx] = nll.cpu().tolist()
                if batch_idx + 1 == preempt_at:
                    self.core.preempt.simulate()

        score_dir = os.path.join(root, "scores")
        t0 = time.monotonic()
        first = inference.run_batch_inference(
            Scorer, data, SERVE_CKPT_SCORE_BATCH, checkpoint_interval=SERVE_CKPT_SCORE_INTERVAL,
            core_context=core._dummy_init(checkpoint_dir=score_dir))
        resumed = core._dummy_init(checkpoint_dir=score_dir)
        resumed.info = types.SimpleNamespace(latest_checkpoint=_latest_progress(score_dir))
        second = inference.run_batch_inference(
            Scorer, data, SERVE_CKPT_SCORE_BATCH, checkpoint_interval=SERVE_CKPT_SCORE_INTERVAL,
            core_context=resumed)
        torch.cuda.synchronize()
        score_s = time.monotonic() - t0
        assert (first, second) == (preempt_at, SERVE_CKPT_SCORE_BATCHES - preempt_at), (
            first, second)
        assert sorted(scores) == list(range(SERVE_CKPT_SCORE_BATCHES)), sorted(scores)
        flat = [x for i in sorted(scores) for x in scores[i]]
        assert all(np.isfinite(flat)), flat
        launches = dict(flash_fwd=_launch_counts()["flash_fwd"])
        # a cold prefill and a scored batch each run the forward once
        layers = hp["n_layers"]
        want = layers * (len(prompts) - hits + SERVE_CKPT_SCORE_BATCHES)
        assert launches["flash_fwd"] == want, (launches, want)
        out = dict(
            card=card_line(), steps=SERVE_CKPT_STEPS, train_s=train_s, save_s=save_s,
            checkpoint_bytes=ckpt_bytes, save_gb_per_s=ckpt_bytes / save_s / 1e9,
            from_checkpoint_s=load_s, verify_s=verify_s, load_s=restore_s,
            requests=len(prompts), new_tokens=SERVE_CKPT_NEW_TOKENS,
            mean_ttft_ms=statistics.mean(ttft), ttft_ms=ttft, prefix_hits=hits,
            tokens_equal_in_memory=True,
            score_batches=SERVE_CKPT_SCORE_BATCHES, preempted_after=first, resumed=second,
            score_batches_per_s=SERVE_CKPT_SCORE_BATCHES / score_s,
            mean_nll=statistics.mean(flat), launches=launches,
        )
        del engine, model
    finally:
        shutil.rmtree(root, ignore_errors=True)
        _free_cuda()
    out["phase_s"] = time.monotonic() - t_phase
    log("serve_ckpt: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 12: the CIFAR ResNet and DDPM diffusion trials
# ---------------------------------------------------------------------------


def models_raw_config(part: str, ckpt_dir: str, seed: int) -> dict:
    """The configuration of ``part`` (cifar10 or diffusion): its file's dict
    with MODELS_CUTS applied."""
    base = {"cifar10": CIFAR_CONST, "diffusion": DIFFUSION_CONST}[part]
    return _apply_cuts(base, MODELS_CUTS, {"<temp dir>": ckpt_dir, "<--seed>": seed})


def _experiment_run(raw: dict, trial_cls, label: str) -> tuple:
    """``raw`` through LocalExperiment(cfg, trial_cls), the launch counters
    set to 0 just before and read just after, then 3 more steps traced;
    returns the measured fields and the run's Trainer."""
    import torch

    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.experiment import LocalExperiment

    cfg = ExperimentConfig.parse(raw)
    cls, trainers, _started = _capturing(trial_cls)
    exp = LocalExperiment(cfg, cls, checkpoint_dir=cfg.checkpoint_storage.host_path)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.monotonic()
    summary = exp.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _launch_counts()
    assert summary["status"] == "completed", summary
    trainer = trainers[-1]
    reports = trainer.core.train.metrics("training")
    validations = trainer.core.train.metrics("validation")
    gbs = trainer.train_loader.sampler.global_batch
    step_ms = [1e3 * gbs / m["samples_per_second"] for _, m in reports]
    losses = [m["loss"] for _, m in reports]
    assert all(np.isfinite(x) for x in losses), losses
    mean_step_ms = statistics.mean(step_ms[1:])  # the first report holds the warm-up
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    # 3 more steps traced: device time and launches a step (not counted)
    profile = profile_train(trainer, label=label)
    out = dict(
        device_ms_per_step=profile["device_ms_per_step"],
        device_busy_share=profile["device_busy_share"],
        device_ms_per_step_by_group=profile["device_ms_per_step_by_group"],
        launches_per_step_by_group=profile["launches_per_step_by_group"],
        wall_s=wall, steps=trainer.steps_completed, report_steps=[s for s, _ in reports],
        losses=losses, step_ms_per_report=step_ms, mean_step_ms=mean_step_ms,
        samples_per_s=1e3 * gbs / mean_step_ms, validation_steps=[s for s, _ in validations],
        validations=[m for _, m in validations], launches=launches, peak_memory_gib=peak_gib,
    )
    return out, trainer


def _models_experiment(part: str, trial_cls, root: str, seed: int) -> tuple:
    """``part``'s const.yaml through ``_experiment_run``."""
    import os

    raw = models_raw_config(part, os.path.join(root, part), seed)
    out, trainer = _experiment_run(raw, trial_cls, f"models {part}")
    out["images_per_s"] = out.pop("samples_per_s")
    return out, trainer


def models_cifar(seed: int, root: str) -> dict:
    """C: examples/cifar10/const.yaml (ResNet-20, SGD) at full size."""
    from determined_tpu_torch.models import CifarTrial

    out, trainer = _models_experiment("cifar10", CifarTrial, root, seed)
    hp = CIFAR_CONST["hyperparameters"]
    per_epoch = hp["dataset_size"] // hp["global_batch_size"]
    epochs = CIFAR_CONST["searcher"]["max_length"]["epochs"]
    assert out["steps"] == epochs * per_epoch, out["steps"]
    # a validation at each epoch
    want = [per_epoch * (e + 1) for e in range(epochs)]
    assert out["validation_steps"] == want, out["validation_steps"]
    accuracies = [m["validation_accuracy"] for m in out["validations"]]
    assert all(np.isfinite(m["validation_loss"]) for m in out["validations"]), out["validations"]
    assert accuracies[-1] > 0.5, accuracies  # 10 classes: chance is 0.1
    # SGD with momentum, convolutions, GroupNorm: library calls, as the JAX
    # package computes them outside any Pallas kernel
    assert not any(out["launches"].values()), out["launches"]
    out["validation_accuracy"] = accuracies
    out["params"] = sum(p.numel() for p in trainer._params.values())
    log("models C (cifar10): " + json.dumps(out))
    return out


def models_diffusion(seed: int, root: str) -> tuple:
    """D: examples/diffusion/const.yaml (the DDPM UNet, AdamW) at full size,
    then ddpm_sample over every timestep; returns the fields and the run's
    Trainer (for K)."""
    import torch

    from determined_tpu_torch.models import DiffusionTrial, ddpm_sample

    out, trainer = _models_experiment("diffusion", DiffusionTrial, root, seed)
    steps = out["steps"]
    assert steps == DIFFUSION_CONST["searcher"]["max_length"]["batches"], steps
    assert len(trainer._params) == MODELS_UNET_LEAVES, len(trainer._params)
    want = dict(flash_fwd=0, flash_bwd_dq=0, flash_bwd_dkv=0,
                fused_adamw=MODELS_UNET_LEAVES * steps)
    assert out["launches"] == want, f"launches {out['launches']} != expected {want}"
    losses = [m["validation_loss"] for m in out["validations"]]
    period = DIFFUSION_CONST["min_validation_period"]["batches"]
    assert out["validation_steps"] == list(range(period, steps + 1, period)), \
        out["validation_steps"]
    # the bar of tests/test_diffusion.py::test_training_reduces_loss (eps ~
    # N(0, 1) gives 1.0)
    assert losses[-1] < 1.0, losses
    timesteps = int(trainer.context.get_hparam("timesteps"))
    shape = (MODELS_SAMPLES, 28, 28, 1)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    x = ddpm_sample(trainer.model, shape, timesteps, generator=gen)
    torch.cuda.synchronize()
    sample_s = time.monotonic() - t0
    assert tuple(x.shape) == shape and bool(torch.isfinite(x).all()), (x.shape, x.abs().max())
    out.update(validation_loss=losses, sampler_s=sample_s,
               sampler_ms_per_step=1e3 * sample_s / timesteps, samples_std=float(x.std()),
               params=sum(p.numel() for p in trainer._params.values()))
    log("models D (diffusion): " + json.dumps(out))
    return out, trainer


def time_adamw_leaf(seed: int, tx, shape) -> dict:
    """fused_adamw with ``tx``'s settings (f32 p and moments; the lr its
    schedule gives at count 2) on one leaf of ``shape``, timed beside its
    bound, its plain version and torch's fused AdamW: the kernels line's
    timed fields."""
    import torch

    from determined_tpu_torch.ops import fused_adamw as fw

    gen = torch.Generator(device="cuda").manual_seed(seed + 4)
    p, g = (torch.randn(shape, generator=gen, device="cuda") for _ in range(2))
    m = 0.1 * torch.randn(shape, generator=gen, device="cuda")
    v = 0.01 * torch.rand(shape, generator=gen, device="cuda")
    scalars = tx.scalars(torch.tensor(2, dtype=torch.int32, device="cuda"), {"g": g})
    kw = dict(b1=tx.b1, b2=tx.b2, eps=tx.eps, wd=tx.weight_decay)
    kernel_us = device_time_us(lambda: fw.adamw_leaf_(p, m, v, g, scalars, **kw))
    plain_us = device_time_us(lambda: fw._leaf_reference(p, m, v, g, scalars, **kw))
    lib_p = torch.nn.Parameter(p.clone())
    lib_p.grad = g.clone()
    lib_opt = torch.optim.AdamW([lib_p], lr=float(scalars[0]), weight_decay=tx.weight_decay,
                                fused=True)
    library_us = device_time_us(lib_opt.step)
    n = p.numel()
    nbytes, bound_us, bound_by = adamw_bound_us(n, m.element_size())
    return dict(timed_shape=list(shape), bytes=nbytes,
                **timed_row(kernel_us, plain_us, library_us, bound_us, bound_by,
                            ADAMW_FLOPS_PER_ELEMENT * n))


def models_adamw(seed: int, trainer) -> dict:
    """K: fused_adamw against its plain version at every leaf shape D
    trained, with D's optimizer, and timed at the largest leaf beside its
    bound, its plain version and torch's fused AdamW."""
    tx = trainer.tx
    shapes = sorted({tuple(p.shape) for p in trainer._params.values()})
    err = check_adamw_leaves(seed, shapes, [tx], "models K (UNet)")
    shape = max(shapes, key=lambda sh: int(np.prod(sh)))
    out = dict(shapes=len(shapes), max_abs_err=err, **time_adamw_leaf(seed, tx, shape))
    log(f"models K: fused_adamw on the largest UNet leaf {list(shape)} "
        f"({out['bytes'] / 1e6:.3f} MB): " + json.dumps(out))
    return out


def _host_drawn_diffusion_trial():
    """DiffusionTrial whose step draws t and eps on the host, from a CPU
    generator seeded as the step's generator: the card's Philox and the
    CPU's Mersenne Twister draw different numbers from one seed, so both
    sides train on the host's draws."""
    import torch

    from determined_tpu_torch.models import DiffusionTrial
    from determined_tpu_torch.models.diffusion import noised_loss

    class HostDrawnDiffusionTrial(DiffusionTrial):
        def loss(self, model, batch, rng):
            host = torch.Generator().manual_seed(rng.initial_seed())
            img = batch["image"].float() * 2.0 - 1.0
            t = torch.randint(0, int(self._hp("timesteps", 1000)), (img.shape[0],),
                              generator=host).to(img.device)
            eps = torch.randn(tuple(img.shape), generator=host).to(img.device)
            loss = noised_loss(model, img, t, eps, self.schedule)
            return loss, {"mse": loss}

    return HostDrawnDiffusionTrial


@contextlib.contextmanager
def _tf32_off(label: str):
    """Full-f32 products on the card while a part runs: cuDNN's f32
    convolutions default to TF32 (torch.backends.cudnn.allow_tf32), which
    keeps 10 mantissa bits; both flags are restored after."""
    import torch

    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"{label}: TF32 off (torch.backends.cudnn.allow_tf32 and cuda.matmul.allow_tf32 "
        "False): the card's f32 convolutions and products keep f32")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _card_cpu_parity(trial_cls, hp: dict, seed: int, steps: int, zero_grad=None) -> dict:
    """``trial_cls`` trains ``steps`` f32 steps on the card and on the CPU
    from the same weights, batches and step seeds; losses, updates and
    optimizer state held as phase 6 holds them.  ``zero_grad`` maps a leaf to
    the slice of it whose true gradient is 0 (an attention key's bias: the
    softmax does not see a constant added to a row's scores), which each
    side moves by its own f32 noise: its first and second moments must stay
    within ZERO_GRAD_MU and its square on both sides, its weights within
    twice the steps' summed learning rates of each other (a weight moves by
    at most about lr a step), and it is left out of the relative norms.
    Returns the fields; the launches are the card's steps'."""
    import torch

    from determined_tpu_torch import train
    from determined_tpu_torch.data import to_device

    zero_grad = zero_grad or {}
    trainers = {}
    for dev in ("cuda", "cpu"):
        t = train.Trainer(trial_cls(train.init(hparams=hp, seed=seed, device=dev)))
        t._setup()
        trainers[dev] = t
    card, host = trainers["cuda"], trainers["cpu"]
    host.model.load_state_dict({k: v.cpu() for k, v in card.model.state_dict().items()})
    start = {k: v.detach().cpu().clone() for k, v in host.model.state_dict().items()}
    _reset_launches()
    losses = {"cuda": [], "cpu": []}
    its = {dev: iter(t.train_loader) for dev, t in trainers.items()}
    for step in range(steps):
        batches = {dev: next(it) for dev, it in its.items()}
        for k in batches["cpu"]:
            np.testing.assert_array_equal(batches["cuda"][k], batches["cpu"][k])
        assert card.state.step_seed(step) == host.state.step_seed(step)
        for dev, t in trainers.items():
            t.steps_completed = step  # the step generator's step, as fit counts it
            t._train_step(to_device(batches[dev], t.device))
            losses[dev].append(t.state.fetch_metrics()["loss"])
            t.state.reset_metrics()
    launches = _launch_counts()
    tol = TRAIN_PARITY_TOL
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], **tol["loss"])
    lr = card.tx.learning_rate
    bound = 2 * sum(float(lr(torch.tensor(i))) if callable(lr) else lr for i in range(steps))

    def split(k, a, b):
        """(a, b) outside the leaf's zero-gradient slice, and the largest
        |a - b| inside it."""
        if k not in zero_grad:
            return a, b, 0.0
        inside = torch.zeros(a.shape, dtype=torch.bool)
        inside[zero_grad[k]] = True
        return a[~inside], b[~inside], float((a[inside] - b[inside]).abs().max())

    def rel(a, b) -> float:
        return float(torch.linalg.vector_norm(a - b)
                     / torch.linalg.vector_norm(b).clamp_min(1e-30))

    upd_err, zero_grad_err = 0.0, 0.0
    for k in start:
        a, b, inside = split(k, card.model.state_dict()[k].cpu() - start[k],
                             host.model.state_dict()[k] - start[k])
        upd_err, zero_grad_err = max(upd_err, rel(a, b)), max(zero_grad_err, inside)
    moments, zero_grad_moments = {}, {}
    for name, got in card.state.opt_state._asdict().items():
        if isinstance(got, dict):
            want = getattr(host.state.opt_state, name)
            moments[name] = max(rel(*split(k, got[k].cpu(), want[k])[:2]) for k in got)
            # the largest |moment| inside the zero-gradient slices, either side
            zero_grad_moments[name] = max(
                (float(t[sl].abs().max()) for k, sl in zero_grad.items()
                 for t in (got[k].cpu(), want[k])), default=0.0)
    out = dict(losses_card=losses["cuda"], losses_cpu=losses["cpu"],
               max_rel_update_err=upd_err, max_rel_state_err=moments, launches=launches,
               leaves=len(card._params))
    if zero_grad:
        out.update(zero_grad_leaves=sorted(zero_grad), zero_grad_max_abs_err=zero_grad_err,
                   zero_grad_bound=bound, zero_grad_max_abs_moment=zero_grad_moments,
                   zero_grad_moment_bound=dict(mu=ZERO_GRAD_MU, nu=ZERO_GRAD_MU ** 2))
    log(f"{trial_cls.__name__} P (card vs CPU): " + json.dumps(out))
    assert upd_err <= tol["update_rel"], upd_err
    assert max(moments.values()) <= tol["moment_rel"], moments
    if zero_grad:
        assert zero_grad_moments["mu"] <= ZERO_GRAD_MU, zero_grad_moments
        assert zero_grad_moments["nu"] <= ZERO_GRAD_MU ** 2, zero_grad_moments
    assert zero_grad_err <= bound, (zero_grad_err, bound)
    return out


def models_parity(seed: int) -> dict:
    """P: each trial trains MODELS_PARITY_STEPS f32 steps on the card and on
    the CPU from the same weights, batches and step seeds; losses, updates
    and optimizer state compared as phase 6 compares them."""
    from determined_tpu_torch.models import CifarTrial

    out = {}
    with _tf32_off("models P"):
        for part, trial_cls, const in (("cifar10", CifarTrial, CIFAR_CONST),
                                       ("diffusion", _host_drawn_diffusion_trial(),
                                        DIFFUSION_CONST)):
            hp = dict(const["hyperparameters"])
            for which, key, _file, value, why in MODELS_PARITY_CUTS:
                if which == part:
                    hp[key] = value
            out[part] = _card_cpu_parity(trial_cls, hp, seed, MODELS_PARITY_STEPS)
            out[part]["cuts"] = {k: v for w, k, _f, v, _ in MODELS_PARITY_CUTS if w == part}
            n = out[part]["leaves"]
            kernel_steps = MODELS_PARITY_STEPS * n if part == "diffusion" else 0
            assert out[part]["launches"] == dict(flash_fwd=0, flash_bwd_dq=0, flash_bwd_dkv=0,
                                                 fused_adamw=kernel_steps), out[part]["launches"]
    return out


def phase_models(seed: int) -> dict:
    """Parts C, D, K and P of phase 12 (the docstring at the top)."""
    import shutil
    import tempfile

    t_phase = time.monotonic()
    root = tempfile.mkdtemp(prefix="dtt-chip-models-")
    for path, const, value, why in MODELS_CUTS:
        value = seed if value == "<--seed>" else value
        log(f"models cut (C and D): {path} {json.dumps(const)} -> {json.dumps(value)} ({why})")
    for part, key, const, value, why in MODELS_PARITY_CUTS:
        log(f"models P cut ({part}): hyperparameters.{key} {json.dumps(const)} -> "
            f"{json.dumps(value)} ({why})")
    out: dict = {}
    try:
        t0 = time.monotonic()
        out["C"] = models_cifar(seed, root)
        out["C"]["part_s"] = time.monotonic() - t0
        _free_cuda()
        t0 = time.monotonic()
        out["D"], trainer = models_diffusion(seed, root)
        out["D"]["part_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        out["K"] = models_adamw(seed, trainer)
        out["K"]["part_s"] = time.monotonic() - t0
        del trainer
        _free_cuda()
        t0 = time.monotonic()
        out["P"] = models_parity(seed)
        out["P"]["part_s"] = time.monotonic() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = out["D"]["launches"]
    out["phase_s"] = time.monotonic() - t_phase
    log("models: " + json.dumps({k: (v["part_s"] if isinstance(v, dict) and "part_s" in v else v)
                                 for k, v in out.items()}))
    return out


# ---------------------------------------------------------------------------
# phase 13: the HF GPT-2 and BERT fine-tune trials
# ---------------------------------------------------------------------------


def hf_raw_config(part: str, ckpt_dir: str, seed: int) -> dict:
    """The configuration of ``part`` (gpt2 or bert): its file's dict with
    HF_CUTS applied."""
    base = {"gpt2": HF_GPT2_CONST, "bert": HF_BERT_CONST}[part]
    return _apply_cuts(base, HF_CUTS, {"<temp dir>": ckpt_dir, "<--seed>": seed})


def _no_dropout(part: str, trial_cls):
    """``trial_cls`` whose config sets every dropout probability to 0."""
    class NoDropout(trial_cls):
        def config(self):
            return dataclasses.replace(super().config(), **HF_NO_DROPOUT[part])

    NoDropout.__name__ = f"NoDropout{trial_cls.__name__}"
    return NoDropout


def hf_gpt2(seed: int, root: str) -> dict:
    """G: examples/hf_gpt2/const.yaml (GPT-2 base, f32, plain AdamW) at full
    size through LocalExperiment(cfg, GPT2FinetuneTrial)."""
    import math
    import os

    from determined_tpu_torch.models import GPT2FinetuneTrial

    raw = _apply_cuts(hf_raw_config("gpt2", os.path.join(root, "gpt2"), seed),
                      HF_GPT2_CUTS, {})
    out, trainer = _experiment_run(raw, GPT2FinetuneTrial, "hf G (gpt2)")
    hp = HF_GPT2_CONST["hyperparameters"]
    # the bar of tests/test_transformer.py::test_hf_gpt2_trial_learns
    bar = 0.8 * math.log(hp["vocab_size"])
    losses = [m["validation_loss"] for m in out["validations"]]
    out.update(tokens_per_s=out["samples_per_s"] * hp["seq_len"], validation_loss=losses,
               bar=bar, bar_reached=bool(losses and losses[-1] < bar),
               params=sum(p.numel() for p in trainer._params.values()))
    log("hf G (gpt2): " + json.dumps(out))
    steps = raw["searcher"]["max_length"]["batches"]
    period = raw["min_validation_period"]["batches"]
    assert out["steps"] == steps, out["steps"]
    assert out["validation_steps"] == list(range(period, steps + 1, period)), \
        out["validation_steps"]
    assert len(trainer._params) == HF_GPT2_LEAVES, len(trainer._params)
    # plain AdamW (optax.adamw in the JAX trial): no kernel of the repo runs
    assert not any(out["launches"].values()), out["launches"]
    assert all(np.isfinite(losses)), losses
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
    assert losses[-1] < math.log(hp["vocab_size"]), losses
    out["learn"] = hf_gpt2_learns(seed)
    return out


def hf_gpt2_learns(seed: int) -> dict:
    """GPT2FinetuneTrial at tests/test_transformer.py::test_hf_gpt2_trial_learns's
    hparams on the card: the validation loss below that test's bar."""
    import math

    from determined_tpu_torch import train
    from determined_tpu_torch.models import GPT2FinetuneTrial

    hp = dict(HF_GPT2_LEARN_HP)
    ctx = train.init(hparams=hp, seed=seed)
    summary = train.Trainer(GPT2FinetuneTrial(ctx)).fit(
        max_length=HF_GPT2_LEARN_STEPS, validation_period=HF_GPT2_LEARN_STEPS,
        checkpoint_policy="none")
    out = dict(hparams=hp, steps=summary["steps_completed"],
               validation_loss=summary["validation_metrics"]["validation_loss"],
               bar=0.8 * math.log(hp["vocab_size"]))
    log("hf G (the JAX test's GPT-2 learning bar on the card): " + json.dumps(out))
    assert out["validation_loss"] < out["bar"], out
    return out


def hf_bert(seed: int, root: str) -> dict:
    """B: examples/hf_bert/const.yaml (4 x 256, vocab 8192, plain AdamW) at
    full size through LocalExperiment(cfg, BertClassifyTrial)."""
    import os

    from determined_tpu_torch.models import BertClassifyTrial

    raw = hf_raw_config("bert", os.path.join(root, "bert"), seed)
    out, trainer = _experiment_run(raw, BertClassifyTrial, "hf B (bert)")
    hp = HF_BERT_CONST["hyperparameters"]
    accuracies = [m["validation_accuracy"] for m in out["validations"]]
    out.update(tokens_per_s=out["samples_per_s"] * hp["seq_len"],
               validation_accuracy=accuracies,
               params=sum(p.numel() for p in trainer._params.values()))
    log("hf B (bert): " + json.dumps(out))
    per_epoch = hp["dataset_size"] // hp["global_batch_size"]
    epochs = HF_BERT_CONST["searcher"]["max_length"]["epochs"]
    assert out["steps"] == epochs * per_epoch, out["steps"]
    assert out["validation_steps"] == [per_epoch * (e + 1) for e in range(epochs)], \
        out["validation_steps"]
    assert len(trainer._params) == 5 + 16 * hp["num_layers"] + 4, len(trainer._params)
    assert not any(out["launches"].values()), out["launches"]
    # the bar of tests/test_transformer.py::test_hf_bert_trial_learns (4 classes)
    assert accuracies[-1] > 0.6, accuracies
    return out


def bert_flops_per_sample(hp: dict) -> float:
    """scripts/bench_bert.py's count: 6 N + 12 L seq d a token, N the
    encoder's 12 L d^2 and the word embedding's vocab d."""
    d, layers, seq = hp["hidden_size"], hp["num_layers"], hp["seq_len"]
    n_params = layers * 12 * d * d + hp["vocab_size"] * d
    return (6 * n_params + 12 * layers * seq * d) * seq


def hf_north_star(seed: int) -> tuple:
    """N: bench_bert.py's BERT-base step, 5 warm steps and 30 timed, once
    with plain AdamW and once with fused, from the same weights and
    batches; returns the fields and the fused run's optimizer (for K)."""
    import torch

    from determined_tpu_torch import train
    from determined_tpu_torch.data import to_device
    from determined_tpu_torch.models import BertClassifyTrial
    from determined_tpu_torch.observability._goodput import chip_peak_flops

    hp = dict(HF_NORTH_STAR_HP)
    gbs, steps = hp["global_batch_size"], HF_NORTH_STAR_WARM + HF_NORTH_STAR_TIMED
    flops_per_step = bert_flops_per_sample(hp) * gbs
    peak_bf16 = chip_peak_flops(torch.cuda.get_device_name(0))
    out, start, first_loss, tx = {}, None, None, None
    for fused in (False, True):
        name = "fused_adamw" if fused else "adamw"
        trainer = train.Trainer(BertClassifyTrial(train.init(
            hparams=dict(hp, fused_adamw=fused), seed=seed)))
        trainer._setup()
        state = trainer.model.state_dict()
        if start is None:  # both runs from these weights
            start = {k: v.detach().clone() for k, v in state.items()}
        else:
            assert all(torch.equal(state[k], v) for k, v in start.items())
        assert len(trainer._params) == HF_NORTH_STAR_LEAVES, len(trainer._params)
        it = iter(trainer.train_loader)
        batches = [to_device(next(it), trainer.device) for _ in range(steps)]
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        losses = []
        for i, b in enumerate(batches):
            if i == HF_NORTH_STAR_WARM:
                torch.cuda.synchronize()
                t0 = time.monotonic()
            trainer.steps_completed = i  # the step generator's step, as fit counts it
            trainer._train_step(b)
            if i == 0:
                losses.append(trainer.state.fetch_metrics()["loss"])
        torch.cuda.synchronize()
        dt = time.monotonic() - t0
        launches = _launch_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        # the first step's loss is taken before any update: the same weights,
        # batch and dropout masks give the same loss bitwise
        first_loss = losses[0] if first_loss is None else first_loss
        assert losses[0] == first_loss, (losses[0], first_loss)
        leaves = len(trainer._params)
        want = dict(flash_fwd=0, flash_bwd_dq=0, flash_bwd_dkv=0,
                    fused_adamw=steps * leaves if fused else 0)
        assert launches == want, f"{name} launches {launches} != expected {want}"
        step_ms = 1e3 * dt / HF_NORTH_STAR_TIMED
        achieved = flops_per_step / (step_ms / 1e3)
        profile = profile_train(trainer, label=f"hf N ({name})")
        out[name] = dict(
            step_ms=step_ms, samples_per_s=gbs / (step_ms / 1e3), tflops_f32=achieved / 1e12,
            share_of_bf16_peak_f32_compute=achieved / peak_bf16,
            share_of_f32_peak_f32_compute=achieved / PEAK_FLOPS["float32"],
            device_ms_per_step=profile["device_ms_per_step"],
            device_busy_share=profile["device_busy_share"],
            device_ms_per_step_by_group=profile["device_ms_per_step_by_group"],
            launches_per_step_by_group=profile["launches_per_step_by_group"],
            first_loss=losses[0], launches=launches, leaves=leaves, peak_memory_gib=peak_gib)
        log(f"hf N ({name}, {steps} steps, {HF_NORTH_STAR_TIMED} timed): "
            + json.dumps(out[name]))
        if fused:
            tx = trainer.tx
        del trainer, batches
        _free_cuda()
    out.update(flops_per_sample=bert_flops_per_sample(hp), flops_per_step=flops_per_step,
               peak_bf16=peak_bf16, peak_f32=PEAK_FLOPS["float32"])
    return out, tx


def hf_adamw(seed: int, tx) -> dict:
    """K: fused_adamw against its plain version and torch's fused AdamW at
    the GPT-2 wte leaf and BERT-base's largest encoder leaf, with the HF
    trials' optimizer (f32 first moment, no clip, decay 0.01, a value of
    the schedule)."""
    out = {}
    shapes = {"gpt2_wte": (50257, 768), "bert_base_ffn": (3072, 768)}
    out["max_abs_err"] = check_adamw_leaves(seed, list(shapes.values()), [tx], "hf K")
    for name, shape in shapes.items():
        out[name] = time_adamw_leaf(seed, tx, shape)
        log(f"hf K: fused_adamw on the {name} leaf {list(shape)} "
            f"({out[name]['bytes'] / 1e6:.3f} MB): " + json.dumps(out[name]))
    return out


def hf_parity(seed: int) -> dict:
    """P: a 2-layer GPT-2 and a 2-layer BERT at width 64, and GPT-2 base at
    full width and depth at 2 sequences a batch, with every dropout
    probability 0, train HF_PARITY_STEPS f32 steps on the card and on the
    CPU from the same weights and batches, with plain and with fused AdamW."""
    from determined_tpu_torch.models import BertClassifyTrial, GPT2FinetuneTrial

    trials = {"gpt2": (GPT2FinetuneTrial, HF_GPT2_CONST),
              "bert": (BertClassifyTrial, HF_BERT_CONST)}
    out = {}
    with _tf32_off("hf P"):
        for part, family in HF_PARITY_PARTS:
            trial_cls, const = trials[family]
            hp = dict(const["hyperparameters"])
            for which, key, _file, value, _why in HF_PARITY_CUTS:
                if which == part:
                    hp[key] = value
            d, layers = hp["hidden_size"], hp["num_layers"]
            zero_grad = (
                {f"transformer.h.{i}.attn.c_attn.bias": slice(d, 2 * d) for i in range(layers)}
                if family == "gpt2" else
                {f"bert.encoder.layer.{i}.attention.self.key.bias": slice(None)
                 for i in range(layers)})
            for fused in (False, True):
                run = _card_cpu_parity(_no_dropout(family, trial_cls),
                                       dict(hp, fused_adamw=fused), seed, HF_PARITY_STEPS,
                                       zero_grad)
                want = dict(flash_fwd=0, flash_bwd_dq=0, flash_bwd_dkv=0,
                            fused_adamw=HF_PARITY_STEPS * run["leaves"] if fused else 0)
                assert run["launches"] == want, (run["launches"], want)
                out[f"{part}_{'fused_adamw' if fused else 'adamw'}"] = run
    return out


def phase_hf(seed: int) -> dict:
    """Parts G, B, N, K and P of phase 13 (the docstring at the top)."""
    import shutil
    import tempfile

    import torch

    t_phase = time.monotonic()
    root = tempfile.mkdtemp(prefix="dtt-chip-hf-")
    log(f"hf: torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32} "
        "(PyTorch's default; f32 products as the JAX trials compute them)")
    for path, const, value, why in HF_CUTS:
        value = seed if value == "<--seed>" else value
        log(f"hf cut (G and B): {path} {json.dumps(const)} -> {json.dumps(value)} ({why})")
    for path, const, value, why in HF_GPT2_CUTS:
        log(f"hf cut (G): {path} {json.dumps(const)} -> {json.dumps(value)} ({why})")
    for part, key, const, value, why in HF_PARITY_CUTS:
        log(f"hf P cut ({part}): hyperparameters.{key} {json.dumps(const)} -> "
            f"{json.dumps(value)} ({why})")
    for family, fields in HF_NO_DROPOUT.items():
        parts = ", ".join(p for p, f in HF_PARITY_PARTS if f == family)
        log(f"hf P cut ({parts}): config {json.dumps(fields)} (dropout off: the card's and the "
            "CPU's generators draw other masks from one seed)")
    out: dict = {}
    try:
        for part, fn in (("G", lambda: hf_gpt2(seed, root)), ("B", lambda: hf_bert(seed, root))):
            t0 = time.monotonic()
            out[part] = fn()
            out[part]["part_s"] = time.monotonic() - t0
            _free_cuda()
        t0 = time.monotonic()
        out["N"], tx = hf_north_star(seed)
        out["N"]["part_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        out["K"] = hf_adamw(seed, tx)
        out["K"]["part_s"] = time.monotonic() - t0
        _free_cuda()
        t0 = time.monotonic()
        out["P"] = hf_parity(seed)
        out["P"]["part_s"] = time.monotonic() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = out["N"]["fused_adamw"]["launches"]
    out["phase_s"] = time.monotonic() - t_phase
    log("hf: " + json.dumps({k: (v["part_s"] if isinstance(v, dict) and "part_s" in v else v)
                             for k, v in out.items()}))
    return out



# ---------------------------------------------------------------------------
# phase 14: MoE language models, and the mesh path as a world of one
# ---------------------------------------------------------------------------


def _moe_hparams() -> dict:
    """M's hyperparameters: MOE_EP_CONST's with MOE_CUTS."""
    hp = dict(MOE_EP_CONST["hyperparameters"])
    for key, _file, value, _why in MOE_CUTS:
        if not key.startswith("resources"):
            hp[key] = value
    return hp


def moe_step_flops(hp: dict) -> float:
    """Matmul FLOPs of one training step of the MoE LM at ``hp`` (forward
    x 3): q, k, v, o and the causal score and value products a layer, the
    dense SwiGLU of the dense blocks, and in the MoE blocks the f32 router,
    the dense dispatch and combine einsums ([groups, group, e x c] against
    [groups, group, d]) and the three expert products over every slot of
    every group; the lm head.  This is what the card computes, the slots
    that capacity leaves empty included."""
    d, L, V = hp["d_model"], hp["n_layers"], hp["vocab_size"]
    s, b = hp["seq_len"], hp["global_batch_size"]
    f = hp.get("d_ff") or 4 * d
    e, every = hp["moe_experts"], hp["moe_every"]
    tokens = b * s
    grp = min(MOE_GROUP, tokens)
    groups = -(-tokens // grp)
    cap = max(int(hp.get("moe_capacity_factor", 1.25) * grp * 2 / e), 1)
    fwd = 0.0
    for i in range(L):
        fwd += 2 * tokens * 4 * d * d + 2 * 2 * b * d * s * (s + 1) / 2
        if i % every == every - 1:
            fwd += 2 * tokens * d * e                        # router
            fwd += 2 * 2 * groups * grp * e * cap * d        # dispatch + combine
            fwd += 3 * 2 * groups * e * cap * d * f          # w_in, w_gate, w_out
        else:
            fwd += 3 * 2 * tokens * d * f
    fwd += 2 * tokens * d * V
    return 3 * fwd


def _moe_leaves(n_layers: int, every: int) -> int:
    """Parameter leaves of the MoE LM: embed, ln_f, lm_head; 9 a dense
    block (2 norms, 4 attention, 3 SwiGLU), 10 an MoE block (2 norms, 4
    attention, the router and 3 stacked expert leaves)."""
    n_moe = sum(1 for i in range(n_layers) if i % every == every - 1)
    return 3 + 9 * (n_layers - n_moe) + 10 * n_moe


def moe_breakdown(seed: int, hp: dict) -> dict:
    """One MoE layer's parts at M's shapes, forward and backward each,
    timed alone with CUDA events: the routing (softmax gates to dispatch
    and combine, ``_top2_dispatch``'s elementwise work), the dispatch
    einsum, the three expert products with the SwiGLU, and the combine
    einsum.  Per step: these times the MoE layers."""
    import torch

    from determined_tpu_torch.models.moe import _top2_dispatch

    d, e = hp["d_model"], hp["moe_experts"]
    f = hp.get("d_ff") or 4 * d
    tokens = hp["global_batch_size"] * hp["seq_len"]
    grp = min(MOE_GROUP, tokens)
    n = tokens // grp
    cap = max(int(1.25 * grp * 2 / e), 1)
    cd = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed + 14)
    logits = torch.randn((n, grp, e), generator=gen, device="cuda")
    gates = torch.softmax(logits, dim=-1).requires_grad_()
    dispatch, combine, _ = _top2_dispatch(gates.detach(), cap)
    dispatch, combine = dispatch.to(cd), combine.to(cd).requires_grad_()
    x = torch.randn((n, grp, d), generator=gen, device="cuda").to(cd).requires_grad_()
    w = [(torch.randn(shape, generator=gen, device="cuda") * 0.02).to(cd).requires_grad_()
         for shape in ((e, d, f), (e, d, f), (e, f, d))]
    xin = torch.randn((n, e, cap, d), generator=gen, device="cuda").to(cd).requires_grad_()
    eout = torch.randn((n, e, cap, d), generator=gen, device="cuda").to(cd).requires_grad_()

    def routing():
        _, c, aux = _top2_dispatch(gates, cap)
        torch.autograd.grad((c.sum() + aux.sum()), gates)

    def dispatch_einsum():
        y = torch.einsum("ngec,ngd->necd", dispatch, x)
        torch.autograd.grad(y, x, y)

    def experts():
        h = torch.einsum("necd,edf->necf", xin, w[0])
        g = torch.einsum("necd,edf->necf", xin, w[1])
        y = torch.einsum("necf,efd->necd", torch.nn.functional.silu(g) * h, w[2])
        torch.autograd.grad(y, [xin] + w, y)

    def combine_einsum():
        y = torch.einsum("ngec,necd->ngd", combine, eout)
        torch.autograd.grad(y, (combine, eout), y)

    parts = {name: device_time_us(fn, reps=3, trials=5) / 1e3 for name, fn in (
        ("routing", routing), ("dispatch_einsum", dispatch_einsum),
        ("expert_products", experts), ("combine_einsum", combine_einsum))}
    log("moe breakdown (one MoE layer, forward + backward, ms): " + json.dumps(parts))
    return parts


def moe_aten_ops(trainer, steps: int = 2, top: int = 12) -> list:
    """The PyTorch ops whose own kernels take the most device time over
    ``steps`` training steps (torch.profiler's ``key_averages``), to say
    which ops the elementwise group's kernels belong to: [op, ms a step,
    calls a step]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from determined_tpu_torch.data import to_device

    it = iter(trainer.train_loader)
    batches = [to_device(next(it), trainer.device) for _ in range(steps)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches:
            trainer._train_step(b)
        torch.cuda.synchronize()

    def device_us(e) -> float:
        return float(getattr(e, "self_device_time_total", 0.0)
                     or getattr(e, "self_cuda_time_total", 0.0))

    rows = sorted(prof.key_averages(), key=device_us, reverse=True)[:top]
    out = [[e.key[:60], device_us(e) / steps / 1e3, e.count // steps] for e in rows]
    log("moe M ops by own device time a step (ms, calls): " + json.dumps(out))
    return out


def moe_kernel_rows(seed: int) -> dict:
    """flash_fwd, both flash backward kernels and fused_adamw at M's shapes
    ([8, 16, 2048, 128] bf16 causal; the [8, 2048, 8192] expert leaf with
    M's optimizer), each held against its plain version and timed beside
    its bound and its library call."""
    import torch
    import torch.nn.functional as F

    import determined_tpu_torch.ops.flash_attention as fa
    from determined_tpu_torch.ops import fused_adamw as fw
    from determined_tpu_torch.ops.fused_adamw import fused_adamw

    hp = _moe_hparams()
    b, h, s = hp["global_batch_size"], hp["n_heads"], hp["seq_len"]
    dh = hp["d_model"] // h
    gen = torch.Generator(device="cuda").manual_seed(seed + 15)
    q, k, v, do = (torch.randn((b, h, s, dh), generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    rows: dict = {}
    out, lse = fa.flash_attention_fwd(q, k, v, causal=True)
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal=True)
    torch.cuda.synchronize()
    tol = KERNEL_TOL["bfloat16"]
    torch.testing.assert_close(out.float(), ref_out.float(), **tol["out"])
    torch.testing.assert_close(lse, ref_lse, **tol["lse"])
    kernel_us = device_time_us(lambda: fa.flash_attention_fwd(q, k, v, causal=True))
    plain_us = device_time_us(lambda: fa.flash_attention_fwd_reference(q, k, v, causal=True),
                              reps=5)
    library_us = device_time_us(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True))
    bound_us, bound_by, flops = attention_bound_us(
        b, h, h, s, s, dh, "bfloat16", True, products=2, q_side=2, kv_side=2, rows=1)
    rows["flash_fwd"] = dict(shape=[b, h, s, dh], max_abs_err=_max_err(out, ref_out),
                             **timed_row(kernel_us, plain_us, library_us, bound_us, bound_by,
                                         flops))
    del ref_out, ref_lse
    got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal=True)
    torch.cuda.synchronize()
    errs = {}
    for grad, g_, w_ in zip(("dq", "dk", "dv"), got, want):
        scale_ = w_.float().abs().max().item()
        errs[grad] = _max_err(g_, w_)
        torch.testing.assert_close(g_.float(), w_.float(), rtol=BWD_TOL["bfloat16"]["rtol"],
                                   atol=BWD_TOL["bfloat16"]["atol"] * scale_)
    del got, want
    delta = fa._delta(out, do)
    dq_us = device_time_us(lambda: fa._launch_dq(q, k, v, do, lse, delta, True, dh ** -0.5))
    dkv_us = device_time_us(lambda: fa._launch_dkv(q, k, v, do, lse, delta, True, dh ** -0.5))
    plain_us = device_time_us(
        lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal=True), reps=3)
    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    sdpa_fwd_us = device_time_us(lambda: F.scaled_dot_product_attention(qg, kg, vg,
                                                                         is_causal=True))
    sdpa_both_us = device_time_us(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qg, kg, vg, is_causal=True), (qg, kg, vg), do))
    library_us = sdpa_both_us - sdpa_fwd_us
    for row, kernel_us, products, q_side, kv_side, err in (
        ("flash_bwd_dq", dq_us, 3, 3, 2, errs["dq"]),
        ("flash_bwd_dkv", dkv_us, 4, 2, 4, max(errs["dk"], errs["dv"])),
    ):
        bound_us, bound_by, flops = attention_bound_us(
            b, h, h, s, s, dh, "bfloat16", True, products=products, q_side=q_side,
            kv_side=kv_side, rows=2)
        rows[row] = dict(shape=[b, h, s, dh], max_abs_err=err,
                         **timed_row(kernel_us, plain_us, library_us, bound_us, bound_by, flops))
    del q, k, v, do, out, lse, qg, kg, vg, delta
    _free_cuda()
    # M's optimizer: LMTrial's fused AdamW (decay 0.01, clip 1.0, f32 mu)
    tx = fused_adamw(hp["lr"], weight_decay=0.01, clip_norm=1.0)
    shape = (hp["moe_experts"], hp["d_model"], 4 * hp["d_model"])
    err = check_adamw_leaves(seed, [shape], [tx], "moe expert leaf")
    rows["fused_adamw"] = dict(shape=list(shape), max_abs_err=err,
                               **time_adamw_leaf(seed, tx, shape))
    for name, row in rows.items():
        log(f"moe kernel {name} at {row['shape']}: kernel {row['ms'] * 1e3:.2f} us, plain "
            f"{row['plain_ms'] * 1e3:.2f} us, library {row['library_ms'] * 1e3:.2f} us, bound "
            f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}, share "
            f"{row['bound_share']:.3f}), max_abs_err {row['max_abs_err']:.3e}")
    _free_cuda()
    return rows


def moe_main(seed: int) -> dict:
    """M: MOE_EP_CONST's LM, cut (MOE_CUTS), 25 steps through
    train.init -> Trainer(LMTrial).fit with a validation at the end."""
    import torch

    from determined_tpu_torch import train
    from determined_tpu_torch.models import LMTrial

    hp = _moe_hparams()
    ctx = train.init(hparams=hp, seed=seed)
    trial = LMTrial(ctx)
    trainer = train.Trainer(trial)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()  # counts from here on are M's
    t0 = time.monotonic()
    summary = trainer.fit(max_length=MOE_STEPS, report_period=MOE_REPORT,
                          validation_period=MOE_STEPS, checkpoint_policy="none")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    reports = ctx.core.train.metrics("training")
    gbs, seq = hp["global_batch_size"], hp["seq_len"]
    assert [s for s, _ in reports] == list(range(MOE_REPORT, MOE_STEPS + 1, MOE_REPORT))
    step_ms = [1e3 * gbs / m["samples_per_second"] for _, m in reports]
    mean_step_ms = statistics.mean(step_ms[1:])  # the first report holds the warm-up
    tokens_per_s = gbs * seq / (mean_step_ms / 1e3)
    flops = moe_step_flops(hp)
    mfu = flops / (mean_step_ms / 1e3) / PEAK_FLOPS["bfloat16"]
    first, last = reports[0][1], reports[-1][1]
    val = summary["validation_metrics"]
    for name, x in (("first loss", first["loss"]), ("last loss", last["loss"]),
                    ("validation loss", val["validation_loss"]),
                    ("moe_aux_loss", last["moe_aux_loss"])):
        assert np.isfinite(x), f"{name} is not finite: {x}"
    assert last["loss"] < first["loss"], f"loss did not fall: {first['loss']} -> {last['loss']}"
    cfg = trial._cfg()
    n_leaves = len(trainer._params)
    assert n_leaves == _moe_leaves(cfg.n_layers, cfg.moe_every) == 41, n_leaves
    n_val = trainer.val_loader.batches_per_epoch
    want = dict(flash_fwd=cfg.n_layers * (MOE_STEPS + n_val),
                flash_bwd_dq=cfg.n_layers * MOE_STEPS, flash_bwd_dkv=cfg.n_layers * MOE_STEPS,
                fused_adamw=n_leaves * MOE_STEPS)
    assert launches == want, f"launches {launches} != expected {want}"
    n_params = sum(p.numel() for p in trainer._params.values())
    out = dict(card=card_line(), params=n_params, leaves=n_leaves, steps=MOE_STEPS,
               wall_s=wall, step_ms_per_report=step_ms, mean_step_ms=mean_step_ms,
               tokens_per_s=tokens_per_s, step_tflop=flops / 1e12,
               mfu_vs_989_tflops=mfu, first_report_loss=first["loss"],
               last_report_loss=last["loss"], moe_aux_loss=[m["moe_aux_loss"] for _, m in reports],
               validation_loss=val["validation_loss"], peak_memory_gib=peak_gib,
               launches=launches, launches_per_step=dict(
                   flash_fwd=cfg.n_layers, flash_bwd_dq=cfg.n_layers,
                   flash_bwd_dkv=cfg.n_layers, fused_adamw=n_leaves))
    log("moe M: " + json.dumps(out))
    prof = profile_train(trainer, label="moe M")
    prof.pop("ops")
    out["ops_by_own_device_time"] = moe_aten_ops(trainer)
    parts = moe_breakdown(seed, hp)
    n_moe = sum(1 for blk in trainer.model.blocks if hasattr(blk, "moe"))
    per_step = {k: v * n_moe for k, v in parts.items()}
    step_dev = prof["device_ms_per_step"]
    out["profile"] = prof
    out["moe_parts_ms_per_step"] = per_step
    out["dispatch_combine_share_of_device_step"] = (
        (per_step["dispatch_einsum"] + per_step["combine_einsum"]) / step_dev)
    out["routing_share_of_device_step"] = per_step["routing"] / step_dev
    log("moe M parts a step (alone, x %d MoE layers): %s; dispatch+combine %.3f and routing "
        "%.3f of the device step" % (n_moe, json.dumps(per_step),
                                     out["dispatch_combine_share_of_device_step"],
                                     out["routing_share_of_device_step"]))
    del trainer, trial, ctx
    _free_cuda()
    return out


def moe_layer_parity(seed: int) -> dict:
    """E: ``_top2_dispatch`` on the card equal to the CPU's on the same
    gates; an MoE layer (d 256, e 8, f 1024, f32, 4,500 tokens: two groups
    of 4,096, the second padded) card against CPU from host draws, TF32
    off: the routing equal, output and aux within TRAIN_PARITY_TOL's loss
    tolerance, every gradient within its moment norm."""
    import torch

    from determined_tpu_torch.models.moe import MoE, _top2_dispatch

    rng = np.random.default_rng(seed + 16)
    gates = torch.softmax(torch.from_numpy(
        rng.standard_normal((2, 4096, 8)).astype(np.float32)), dim=-1)
    cap = max(int(1.25 * 4096 * 2 / 8), 1)
    for a, b_ in zip(_top2_dispatch(gates.cuda(), cap)[:2], _top2_dispatch(gates, cap)[:2]):
        assert torch.equal(a.cpu(), b_), "_top2_dispatch differs between the card and the CPU"
    d, e, f = 256, 8, 1024
    x = rng.standard_normal((3, 1500, d)).astype(np.float32)
    weights = {"router": rng.standard_normal((d, e)) * d ** -0.5,
               "w_in": rng.standard_normal((e, d, f)) * (e * d) ** -0.5,
               "w_gate": rng.standard_normal((e, d, f)) * (e * d) ** -0.5,
               "w_out": rng.standard_normal((e, f, d)) * (e * f) ** -0.5}
    runs = {}
    with _tf32_off("moe E"):
        for dev in ("cuda", "cpu"):
            layer = MoE(d, e, f, dtype=torch.float32, device=dev)
            layer.load_state_dict({k: torch.tensor(v, dtype=torch.float32)
                                   for k, v in weights.items()})
            xt = torch.tensor(x, device=dev, requires_grad=True)
            y, aux = layer(xt)
            ((y ** 2).mean() + 0.01 * aux).backward()
            xg = torch.cat([xt.detach().reshape(-1, d),
                            torch.zeros((8192 - 4500, d), device=dev)]).reshape(2, 4096, d)
            route = _top2_dispatch(torch.softmax(xg @ layer.router.detach(), dim=-1), cap)[0]
            runs[dev] = dict(y=y.detach().cpu(), aux=float(aux), route=route.cpu(),
                             x=xt.grad.cpu(),
                             **{n: p.grad.cpu() for n, p in layer.named_parameters()})
    card, cpu = runs["cuda"], runs["cpu"]
    assert torch.equal(card["route"], cpu["route"]), "the layer routed tokens differently"
    tol = TRAIN_PARITY_TOL["loss"]
    torch.testing.assert_close(card["y"], cpu["y"], **tol)
    assert abs(card["aux"] - cpu["aux"]) <= tol["atol"] + tol["rtol"] * abs(cpu["aux"])
    rel = {}
    for name in ("x", "router", "w_in", "w_gate", "w_out"):
        rel[name] = float((card[name] - cpu[name]).norm() / cpu[name].norm())
        assert rel[name] <= TRAIN_PARITY_TOL["moment_rel"], (name, rel[name])
    out = dict(y_max_abs_err=_max_err(card["y"], cpu["y"]),
               aux_abs_err=abs(card["aux"] - cpu["aux"]), grad_rel_norm=rel)
    log("moe E: " + json.dumps(out))
    return out


def _moe_world_of_one(seed: int, root: str) -> dict:
    """W: the mesh path over NCCL as a world of one, against the single-
    device path, from the same weights and batches."""
    import os

    import torch

    from determined_tpu_torch import core, train
    from determined_tpu_torch.core import DistributedContext, allocate_port
    from determined_tpu_torch.models import LMTrial
    from determined_tpu_torch.parallel import MeshConfig

    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", LOCAL_WORLD_SIZE="1",
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(allocate_port()))
    dist = DistributedContext.from_torch()
    out: dict = dict(backend=dist.backend)
    try:
        def run(hp, mesh, steps, ckpt_dir, **fit):
            core_ctx = core._dummy_init(distributed=dist if mesh else None,
                                        checkpoint_dir=ckpt_dir)
            ctx = train.init(hparams=hp, seed=seed, core_context=core_ctx,
                             mesh_config=MeshConfig(data=-1) if mesh else None)
            assert (ctx.mesh is not None) == mesh
            trainer = train.Trainer(LMTrial(ctx))
            _reset_launches()
            summary = trainer.fit(max_length=steps, report_period=1, **fit)
            torch.cuda.synchronize()
            losses = [m["loss"] for _, m in ctx.core.train.metrics("training")]
            return trainer, summary, losses, _launch_counts()

        hp = _moe_hparams()
        got = {}
        for mesh in (True, False):
            trainer, _, losses, launches = run(hp, mesh, MOE_W_STEPS,
                                               os.path.join(root, "w1"),
                                               checkpoint_policy="none")
            leaves = len(trainer._params)
            if mesh:
                from torch.distributed.tensor import DTensor

                assert all(isinstance(p, DTensor) for p in trainer._params.values())
            got[mesh] = losses
            layers = hp["n_layers"]
            want = dict(flash_fwd=layers * MOE_W_STEPS, flash_bwd_dq=layers * MOE_W_STEPS,
                        flash_bwd_dkv=layers * MOE_W_STEPS, fused_adamw=leaves * MOE_W_STEPS)
            assert launches == want, (mesh, launches, want)
            out["mesh_launches" if mesh else "single_launches"] = launches
            del trainer
            _free_cuda()
        tol = TRAIN_PARITY_TOL["loss"]
        np.testing.assert_allclose(got[True], got[False], **tol)
        out.update(mesh_losses=got[True], single_losses=got[False],
                   max_loss_diff=max(abs(a - b) for a, b in zip(got[True], got[False])))
        # a checkpoint written on the mesh, restored without one (MOE_W_CKPT_CUTS)
        small = dict(hp)
        for key, _old, value, _why in MOE_W_CKPT_CUTS:
            small[key] = value
        ck = os.path.join(root, "w2")
        mesh_trainer, summary, _, _ = run(small, True, 3, ck, checkpoint_policy="all",
                                          validation_period=3)
        sid = summary["latest_checkpoint"]
        tstate = train.serialization.load_trainer_state(os.path.join(ck, sid))
        assert tstate["mesh_axes"]["data"] == 1 and set(tstate["mesh_axes"]) == {
            "dcn", "data", "fsdp", "tensor", "seq", "expert", "pipe"}
        full = mesh_trainer._full_array_state()
        single, summary2, _, _ = run(small, False, 3, ck, latest_checkpoint=sid,
                                     checkpoint_policy="none")
        assert summary2["steps_completed"] == 3
        for name, p in single._params.items():
            assert torch.equal(p.detach().cpu(), full["params"][name]), name
        for which in ("mu", "nu"):
            for name, t in getattr(single.state.opt_state, which).items():
                assert torch.equal(t.cpu(), getattr(full["opt_state"], which)[name]), name
        out["checkpoint"] = dict(storage_id=sid, leaves=len(single._params), restored="bitwise")
        del mesh_trainer, single, full
    finally:
        dist.close()
        for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE", "MASTER_ADDR",
                    "MASTER_PORT"):
            os.environ.pop(key, None)
        _free_cuda()
    log("moe W: " + json.dumps(out))
    return out


def phase_moe(seed: int) -> dict:
    """Parts M, K, E and W of phase 14 (the docstring at the top)."""
    import shutil
    import tempfile

    t_phase = time.monotonic()
    for key, old, value, why in MOE_CUTS:
        log(f"moe cut (M): {key} {json.dumps(old)} -> {json.dumps(value)} ({why})")
    for key, old, value, why in MOE_W_CKPT_CUTS:
        log(f"moe cut (W's checkpoint): {key} {json.dumps(old)} -> {json.dumps(value)} ({why})")
    root = tempfile.mkdtemp(prefix="dtt-chip-moe-")
    out: dict = {}
    try:
        for part, fn in (("M", lambda: moe_main(seed)), ("K", lambda: moe_kernel_rows(seed)),
                         ("E", lambda: moe_layer_parity(seed)),
                         ("W", lambda: _moe_world_of_one(seed, root))):
            t0 = time.monotonic()
            out[part] = fn()
            log(f"moe {part}: {time.monotonic() - t0:.1f} s")
            _free_cuda()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = out["M"]["launches"]
    out["phase_s"] = time.monotonic() - t_phase
    log(f"moe: phase {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 15: sequence and tensor parallelism (fsdp_tp_sp.yaml)
# ---------------------------------------------------------------------------


def _seq_hparams() -> dict:
    """L's hyperparameters: SEQ_CONST's with SEQ_CUTS (a dotted key is
    the file's other sections)."""
    hp = dict(SEQ_CONST["hyperparameters"])
    for key, _file, value, _why in SEQ_CUTS:
        if "." not in key:
            hp[key] = value
    return hp


def dense_lm_step_flops(hp: dict) -> float:
    """Matmul FLOPs of one training step of the dense LM at ``hp`` (forward
    x 3, remat's recomputed forward not counted): q, k and v (GQA's kv
    width), o, the causal score and value products and the SwiGLU a layer,
    and the lm head, over every token of the step's batch."""
    d, L, V = hp["d_model"], hp["n_layers"], hp["vocab_size"]
    s, b = hp["seq_len"], hp["global_batch_size"]
    f = hp.get("d_ff") or 4 * d
    kv = d // hp["n_heads"] * (hp.get("n_kv_heads") or hp["n_heads"])
    tokens = b * s
    per_layer = 2 * tokens * (2 * d * d + 2 * d * kv + 3 * d * f) + 2 * 2 * b * d * s * (s + 1) / 2
    return 3 * (L * per_layer + 2 * tokens * d * V)


def _ring_inputs(seed: int, s: int):
    """q [1, 32, s, 128], k and v [1, 8, s, 128] and an output gradient, bf16."""
    import torch

    hp = SEQ_CONST["hyperparameters"]
    h, hkv = hp["n_heads"], hp["n_kv_heads"]
    dh = hp["d_model"] // h
    gen = torch.Generator(device="cuda").manual_seed(seed + 17)
    shapes = ((1, h, s, dh), (1, hkv, s, dh), (1, hkv, s, dh), (1, h, s, dh))
    return [torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
            for shape in shapes]


def _ring_grads(q, k, v, do, n: int):
    """The virtual ring's out and (dq, dk, dv) for output gradient ``do``."""
    import torch

    from determined_tpu_torch.ops.ring_attention import VirtualRing, ring_attention_local

    qg, kg, vg = (t.detach().clone().requires_grad_() for t in (q, k, v))
    out = ring_attention_local(qg, kg, vg, VirtualRing(n), causal=True)
    return out.detach(), torch.autograd.grad(out, (qg, kg, vg), do)


def seq_ring_route(seed: int) -> dict:
    """R: the ring's kernel route on one card (the docstring at the top)."""
    import torch

    import determined_tpu_torch.ops.flash_attention as fa
    from determined_tpu_torch.ops.ring_attention import (
        VirtualRing,
        ring_attention_local,
        ring_block_counts,
    )

    out: dict = dict(tol=SEQ_RING_TOL, rings={})
    # the plain version's length first: ring and whole kernel against f32
    q, k, v, do = _ring_inputs(seed, SEQ_PLAIN_LEN)
    ref_out, ref_lse = fa.flash_attention_fwd_reference(q.float(), k.float(), v.float())
    ref = (ref_out,) + fa.flash_attention_bwd_reference(q.float(), k.float(), v.float(),
                                                        ref_out, ref_lse, do.float())
    whole_out, whole_lse = fa.flash_attention_fwd(q, k, v)
    whole = (whole_out,) + fa.flash_attention_bwd(q, k, v, whole_out, whole_lse, do)
    plain: dict = {"whole_kernel": {}}
    for name, got, want in zip(("out", "dq", "dk", "dv"), whole, ref):
        plain["whole_kernel"][name] = _max_err(got, want)
    for n in SEQ_RING_NS:
        ring_out, grads = _ring_grads(q, k, v, do, n)
        errs = {}
        for name, got, want in zip(("out", "dq", "dk", "dv"), (ring_out,) + tuple(grads), ref):
            errs[name] = _max_err(got, want)
            tol = KERNEL_TOL["bfloat16"]["out"] if name == "out" else dict(
                rtol=SEQ_RING_TOL["grad"]["rtol"],
                atol=SEQ_RING_TOL["grad"]["atol"] * want.abs().max().item())
            torch.testing.assert_close(got.float(), want, **tol, msg=f"R n={n} plain {name}")
        plain[f"ring_n{n}"] = errs
    out["plain_f32_max_abs_err"] = dict(length=SEQ_PLAIN_LEN, **plain)
    log(f"seq R at {SEQ_PLAIN_LEN} against the plain version in f32: " + json.dumps(plain))
    del q, k, v, do, ref, ref_out, ref_lse, whole, whole_out, whole_lse
    _free_cuda()

    s = SEQ_CONST["hyperparameters"]["seq_len"]
    q, k, v, do = _ring_inputs(seed, s)
    whole_out, whole_lse = fa.flash_attention_fwd(q, k, v)
    whole = (whole_out,) + fa.flash_attention_bwd(q, k, v, whole_out, whole_lse, do)
    whole_fwd_us = device_time_us(lambda: fa.flash_attention_fwd(q, k, v), reps=3, trials=5)
    whole_bwd_us = device_time_us(
        lambda: fa.flash_attention_bwd(q, k, v, whole_out, whole_lse, do), reps=3, trials=5)
    out["whole"] = dict(shape=list(q.shape), fwd_ms=whole_fwd_us / 1e3,
                        bwd_ms=whole_bwd_us / 1e3)
    for n in SEQ_RING_NS:
        _reset_launches()
        with torch.no_grad():
            ring_attention_local(q, k, v, VirtualRing(n), causal=True)
        fwd_launches = _launch_counts()
        _reset_launches()
        ring_out, grads = _ring_grads(q, k, v, do, n)
        torch.cuda.synchronize()
        both_launches = _launch_counts()
        _, counts = ring_block_counts(q, k, v, VirtualRing(n))
        units = sum(counts)
        assert counts == [2 * n + 1] * n, counts
        assert fwd_launches == dict(flash_fwd=units, flash_bwd_dq=0, flash_bwd_dkv=0,
                                    fused_adamw=0), fwd_launches
        assert both_launches == dict(flash_fwd=units, flash_bwd_dq=units, flash_bwd_dkv=units,
                                     fused_adamw=0), both_launches
        errs = {}
        for name, got, want in zip(("out", "dq", "dk", "dv"), (ring_out,) + tuple(grads), whole):
            errs[name] = _max_err(got, want)
            tol = SEQ_RING_TOL["out"] if name == "out" else dict(
                rtol=SEQ_RING_TOL["grad"]["rtol"],
                atol=SEQ_RING_TOL["grad"]["atol"] * want.float().abs().max().item())
            torch.testing.assert_close(got.float(), want.float(), **tol,
                                       msg=f"R n={n} against the whole kernels: {name}")
        del ring_out, grads
        with torch.no_grad():
            fwd_us = device_time_us(
                lambda: ring_attention_local(q, k, v, VirtualRing(n), causal=True),
                reps=3, trials=5)
        both_us = device_time_us(lambda: _ring_grads(q, k, v, do, n), reps=2, trials=5)
        out["rings"][f"n{n}"] = dict(
            counts=counts, launches_forward=fwd_launches, launches_forward_backward=both_launches,
            max_abs_err_vs_whole=errs, fwd_ms=fwd_us / 1e3, fwd_bwd_ms=both_us / 1e3,
            fwd_vs_whole=fwd_us / whole_fwd_us,
            fwd_bwd_vs_whole=both_us / (whole_fwd_us + whole_bwd_us))
        log(f"seq R ring n={n}: " + json.dumps(out["rings"][f"n{n}"]))
        _free_cuda()
    out["launches"] = out["rings"][f"n{SEQ_RING_NS[-1]}"]["launches_forward_backward"]
    del q, k, v, do, whole, whole_out, whole_lse
    _free_cuda()
    return out


def seq_main(seed: int) -> dict:
    """L: SEQ_CONST's LM, cut (SEQ_CUTS), SEQ_STEPS steps through
    train.init -> Trainer(LMTrial).fit with a validation at the end."""
    import torch

    from determined_tpu_torch import train
    from determined_tpu_torch.models import LMTrial

    hp = _seq_hparams()
    ctx = train.init(hparams=hp, seed=seed)
    trial = LMTrial(ctx)
    trainer = train.Trainer(trial)
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()  # counts from here on are L's
    t0 = time.monotonic()
    summary = trainer.fit(max_length=SEQ_STEPS, report_period=SEQ_REPORT,
                          validation_period=SEQ_STEPS, checkpoint_policy="none")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    reports = ctx.core.train.metrics("training")
    gbs, seq = hp["global_batch_size"], hp["seq_len"]
    assert [s for s, _ in reports] == list(range(SEQ_REPORT, SEQ_STEPS + 1, SEQ_REPORT))
    step_ms = [1e3 * gbs / m["samples_per_second"] for _, m in reports]
    mean_step_ms = statistics.mean(step_ms[1:])  # the first report holds the warm-up
    tokens_per_s = gbs * seq / (mean_step_ms / 1e3)
    flops = dense_lm_step_flops(hp)
    mfu = flops / (mean_step_ms / 1e3) / PEAK_FLOPS["bfloat16"]
    first, last = reports[0][1], reports[-1][1]
    val = summary["validation_metrics"]
    for name, x in (("first loss", first["loss"]), ("last loss", last["loss"]),
                    ("validation loss", val["validation_loss"])):
        assert np.isfinite(x), f"{name} is not finite: {x}"
    assert last["loss"] < first["loss"], f"loss did not fall: {first['loss']} -> {last['loss']}"
    cfg = trial._cfg()
    n_leaves = len(trainer._params)
    assert n_leaves == 3 + 9 * cfg.n_layers == 39, n_leaves
    n_val = trainer.val_loader.batches_per_epoch
    # remat reruns each block's forward in the backward
    want = dict(flash_fwd=cfg.n_layers * (2 * SEQ_STEPS + n_val),
                flash_bwd_dq=cfg.n_layers * SEQ_STEPS, flash_bwd_dkv=cfg.n_layers * SEQ_STEPS,
                fused_adamw=n_leaves * SEQ_STEPS)
    assert launches == want, f"launches {launches} != expected {want}"
    n_params = sum(p.numel() for p in trainer._params.values())
    out = dict(card=card_line(), params=n_params, leaves=n_leaves, steps=SEQ_STEPS,
               wall_s=wall, step_ms_per_report=step_ms, mean_step_ms=mean_step_ms,
               tokens_per_s=tokens_per_s, step_tflop=flops / 1e12,
               mfu_vs_989_tflops=mfu, first_report_loss=first["loss"],
               last_report_loss=last["loss"], validation_loss=val["validation_loss"],
               peak_memory_gib=peak_gib, launches=launches, launches_per_step=dict(
                   flash_fwd=2 * cfg.n_layers, flash_bwd_dq=cfg.n_layers,
                   flash_bwd_dkv=cfg.n_layers, fused_adamw=n_leaves))
    log("seq L: " + json.dumps(out))
    prof = profile_train(trainer, label="seq L")
    prof.pop("ops")
    out["profile"] = prof
    del trainer, trial, ctx
    _free_cuda()
    return out


def attention_kernel_rows(rows: dict, label: str, q, k, v, do, causal: bool, plain_fits: bool,
                          tag: str) -> None:
    """The three flash kernels on ``q, k, v`` (and ``do``) into ``rows``
    under ``label``: each held against its plain version where that fits
    (``plain_fits``) and timed beside it, its bound and SDPA's forward or
    backward on the same inputs (k and v expanded to q's heads)."""
    import torch
    import torch.nn.functional as F

    import determined_tpu_torch.ops.flash_attention as fa
    from determined_tpu_torch.ops.attention import _repeat_kv

    b, h, s, dh = q.shape
    hkv = k.shape[1]
    scale = dh ** -0.5
    tol = KERNEL_TOL["bfloat16"]
    out, lse = fa.flash_attention_fwd(q, k, v, causal=causal)
    kernel_us = device_time_us(lambda: fa.flash_attention_fwd(q, k, v, causal=causal),
                               reps=5, trials=5)
    err, plain_us = None, None
    if plain_fits:
        ref_out, ref_lse = fa.flash_attention_fwd_reference(q, k, v, causal=causal)
        torch.testing.assert_close(out.float(), ref_out.float(), **tol["out"])
        torch.testing.assert_close(lse, ref_lse, **tol["lse"])
        err = _max_err(out, ref_out)
        del ref_out, ref_lse
        plain_us = device_time_us(
            lambda: fa.flash_attention_fwd_reference(q, k, v, causal=causal), reps=2, trials=3)
    qe, ke, ve = (t.detach().clone().requires_grad_() for t in
                  (q, _repeat_kv(k, h // hkv), _repeat_kv(v, h // hkv)))
    sdpa_fwd_us = device_time_us(
        lambda: F.scaled_dot_product_attention(qe, ke, ve, is_causal=causal), reps=5, trials=5)
    bound_us, bound_by, flops = attention_bound_us(
        b, h, hkv, s, s, dh, "bfloat16", causal, products=2, q_side=2, kv_side=2, rows=1)
    rows["flash_fwd"][label] = dict(
        shape=[b, h, s, dh], kv_heads=hkv, causal=causal, max_abs_err=err,
        **timed_row(kernel_us, plain_us, sdpa_fwd_us, bound_us, bound_by, flops))
    errs = {}
    if plain_fits:
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        want = fa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal=causal)
        for grad, g_, w_ in zip(("dq", "dk", "dv"), got, want):
            errs[grad] = _max_err(g_, w_)
            torch.testing.assert_close(
                g_.float(), w_.float(), rtol=BWD_TOL["bfloat16"]["rtol"],
                atol=BWD_TOL["bfloat16"]["atol"] * w_.float().abs().max().item())
        del got, want
        _free_cuda()
        plain_us = device_time_us(
            lambda: fa.flash_attention_bwd_reference(q, k, v, out, lse, do, causal=causal),
            reps=1, trials=3)
    delta = fa._delta(out, do)
    dq_us = device_time_us(lambda: fa._launch_dq(q, k, v, do, lse, delta, causal, scale),
                           reps=5, trials=5)
    dkv_us = device_time_us(lambda: fa._launch_dkv(q, k, v, do, lse, delta, causal, scale),
                            reps=5, trials=5)
    sdpa_both_us = device_time_us(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qe, ke, ve, is_causal=causal), (qe, ke, ve), do),
        reps=3, trials=5)
    for row, kernel_us, products, q_side, kv_side, err in (
        ("flash_bwd_dq", dq_us, 3, 3, 2, errs.get("dq")),
        ("flash_bwd_dkv", dkv_us, 4, 2, 4, max(errs["dk"], errs["dv"]) if errs else None),
    ):
        bound_us, bound_by, flops = attention_bound_us(
            b, h, hkv, s, s, dh, "bfloat16", causal, products=products, q_side=q_side,
            kv_side=kv_side, rows=2)
        rows[row][label] = dict(
            shape=[b, h, s, dh], kv_heads=hkv, causal=causal, max_abs_err=err,
            **timed_row(kernel_us, plain_us, sdpa_both_us - sdpa_fwd_us, bound_us, bound_by,
                        flops))
    for row in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        r = rows[row][label]
        log(f"{tag} kernel {row} {label} {r['shape']}: kernel {r['ms'] * 1e3:.2f} us, "
            f"sdpa {r['library_ms'] * 1e3:.2f} us, bound {r['bound_ms'] * 1e3:.2f} us "
            f"({r['bound_by']}, share {r['bound_share']:.3f}), plain "
            f"{'not measured' if r['plain_ms'] is None else '%.2f us' % (r['plain_ms'] * 1e3)}"
            f", max_abs_err {r['max_abs_err']}")
    del out, lse, qe, ke, ve, delta
    _free_cuda()


def adamw_kernel_row(seed: int, lr: float, shape, label: str, tag: str) -> dict:
    """fused_adamw as LMTrial builds it (decay 0.01, clip 1.0, f32 mu) held
    at leaf ``shape`` and timed beside its plain version, its bound and
    the library's AdamW."""
    from determined_tpu_torch.ops.fused_adamw import fused_adamw

    tx = fused_adamw(lr, weight_decay=0.01, clip_norm=1.0)
    err = check_adamw_leaves(seed, [shape], [tx], f"{tag}'s {label} leaf")
    row = dict(shape=list(shape), max_abs_err=err, **time_adamw_leaf(seed, tx, shape))
    log(f"{tag} kernel fused_adamw {list(shape)}: kernel {row['ms'] * 1e3:.2f} us, plain "
        f"{row['plain_ms'] * 1e3:.2f} us, library {row['library_ms'] * 1e3:.2f} us, bound "
        f"{row['bound_ms'] * 1e3:.2f} us (share {row['bound_share']:.3f})")
    _free_cuda()
    return row


def seq_kernel_rows(seed: int) -> dict:
    """K: the flash kernels at the ring's shapes and fused_adamw at L's
    largest leaf (the docstring at the top)."""
    hp = SEQ_CONST["hyperparameters"]
    rows: dict = {"flash_fwd": {}, "flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    for label, s, causal in SEQ_KERNEL_SHAPES:
        q, k, v, do = _ring_inputs(seed + s + causal, s)
        attention_kernel_rows(rows, label, q, k, v, do, causal, s <= 8192, "seq")
        del q, k, v, do
        _free_cuda()
    # L's optimizer: LMTrial's fused AdamW (decay 0.01, clip 1.0, f32 mu)
    rows["fused_adamw"] = {"w_gate": adamw_kernel_row(
        seed, hp["lr"], (4 * hp["d_model"], hp["d_model"]), "w_gate", "seq L")}
    return rows


def phase_seq(seed: int) -> dict:
    """Parts R, L and K of phase 15 (the docstring at the top)."""
    t_phase = time.monotonic()
    for key, old, value, why in SEQ_CUTS:
        log(f"seq cut (L): {key} {json.dumps(old)} -> {json.dumps(value)} ({why})")
    out: dict = {}
    for part, fn in (("R", lambda: seq_ring_route(seed)), ("L", lambda: seq_main(seed)),
                     ("K", lambda: seq_kernel_rows(seed))):
        t0 = time.monotonic()
        out[part] = fn()
        log(f"seq {part}: {time.monotonic() - t0:.1f} s")
        _free_cuda()
    out["launches"] = out["L"]["launches"]
    out["phase_s"] = time.monotonic() - t_phase
    log(f"seq: phase {out['phase_s']:.1f} s")
    return out


def _pipe_hparams() -> dict:
    """S's hyperparameters: PIPE_CONST's with PIPE_CUTS."""
    hp = dict(PIPE_CONST["hyperparameters"])
    for key, _file, value, _why in PIPE_CUTS:
        if "." not in key:
            hp[key] = value
    return hp


def _pipe_fit(ctx, label: str, samples: int, against=None) -> dict:
    """PIPE_STEPS steps of ``samples`` sequences and a validation through
    Trainer(LMTrial).fit, the launch counters set to 0 just before and read
    just after; the reported losses, the launches, the step time and the
    peak memory; with ``against`` (the initial params and U's updates, on
    the host) the relative norm and the largest difference of this run's
    updates from U's, else the final params (on the host)."""
    import torch

    from determined_tpu_torch import train
    from determined_tpu_torch.models import LMTrial

    trainer = train.Trainer(LMTrial(ctx))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.monotonic()
    trainer.fit(max_length=PIPE_STEPS, report_period=1, validation_period=PIPE_STEPS,
                checkpoint_policy="none")
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = _launch_counts()
    rows = ctx.core.train.metrics("training")
    val = ctx.core.train.metrics("validation")
    step_ms = [1e3 * samples / m["samples_per_second"] for _, m in rows]
    out = dict(
        losses=[m["loss"] for _, m in rows], validation_loss=val[-1][1]["validation_loss"],
        launches=launches, wall_s=wall, step_ms=step_ms,
        steady_step_ms=sorted(step_ms[1:])[len(step_ms[1:]) // 2],
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
        leaves=len(trainer._params),
        bubble_fraction=trainer._bubble_model.fraction if trainer._bubble_model else None,
    )
    if against is None:
        out["params"] = {k: p.detach().to("cpu", copy=True) for k, p in trainer._params.items()}
    else:
        init, upd_ref = against
        num = den = worst = 0.0
        with torch.no_grad():
            for k, p in trainer._params.items():
                ref = upd_ref[k].to(p.device)
                diff = p - init[k].to(p.device) - ref
                num += float(diff.norm()) ** 2
                den += float(ref.norm()) ** 2
                worst = max(worst, float(diff.abs().max()))
        out.update(update_rel=(num / max(den, 1e-300)) ** 0.5, update_max_abs_diff=worst)
    log(f"pipe {label}: losses {out['losses']}, validation {out['validation_loss']}, step "
        f"{out['steady_step_ms']:.2f} ms (each {[round(x, 2) for x in step_ms]}), peak "
        f"{out['peak_memory_gib']:.2f} GiB, launches {launches}, bubble "
        f"{out['bubble_fraction']}, {wall:.1f} s")
    del trainer
    _free_cuda()
    return out


def pipe_main(seed: int) -> dict:
    """U and S (the docstring at the top)."""
    from determined_tpu_torch import train
    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.models import LMTrial

    hp = _pipe_hparams()
    m, layers = hp["pipe_microbatches"], hp["n_layers"]
    plain = {k: v for k, v in hp.items() if k != "pipe_microbatches"}
    plain["global_batch_size"] = hp["global_batch_size"] // m
    agg = ExperimentConfig.parse({"optimizations": {"aggregation_frequency": m}})
    samples = hp["global_batch_size"]
    ref = _pipe_fit(train.init(hparams=plain, seed=seed, exp_config=agg), "U (aggregation 8)",
                    samples)
    init = {k: p.detach().to("cpu", copy=True) for k, p in
            LMTrial(train.init(hparams=plain, seed=seed)).build_model().named_parameters()}
    upd_ref = {k: p - init[k] for k, p in ref.pop("params").items()}
    _free_cuda()
    val_batches = hp["dataset_size"] // hp["global_batch_size"]
    out: dict = {"U": ref, "S": {}}
    for name, v in PIPE_SCHEDULES:
        shp = dict(hp, pipeline_schedule=name, virtual_stages=v)
        got = _pipe_fit(train.init(hparams=shp, seed=seed, virtual_pipe=4), name, samples,
                        against=(init, upd_ref))
        want_launches = dict(
            flash_fwd=PIPE_STEPS * 2 * layers * m + val_batches * layers * m,
            flash_bwd_dq=PIPE_STEPS * layers * m, flash_bwd_dkv=PIPE_STEPS * layers * m,
            fused_adamw=PIPE_STEPS * got["leaves"])
        assert got["launches"] == want_launches, (name, got["launches"], want_launches)
        assert ref["launches"] == want_launches, (ref["launches"], want_launches)
        assert abs(got["bubble_fraction"] - PIPE_BUBBLE[name]) < 1e-12, got["bubble_fraction"]
        np.testing.assert_allclose(got["losses"], ref["losses"], **PIPE_TOL["loss"],
                                   err_msg=f"pipe {name} losses")
        np.testing.assert_allclose(got["validation_loss"], ref["validation_loss"],
                                   **PIPE_TOL["loss"], err_msg=f"pipe {name} validation")
        assert got["update_rel"] <= PIPE_TOL["update_rel"], (name, got["update_rel"])
        got["loss_max_abs_diff"] = float(np.max(np.abs(np.subtract(got["losses"],
                                                                   ref["losses"]))))
        out["S"][name] = got
        log(f"pipe {name} against U: loss max |diff| {got['loss_max_abs_diff']:.3e}, "
            f"updates rel {got['update_rel']:.3e} (max |diff| {got['update_max_abs_diff']:.3e})")
        del got
        _free_cuda()
    assert out["S"]["1f1b"]["peak_memory_gib"] < out["S"]["gpipe"]["peak_memory_gib"], out
    out["launches"] = out["S"]["1f1b"]["launches"]
    return out


def pipe_kernel_rows(seed: int) -> dict:
    """K: the flash kernels at a microbatch's attention and fused_adamw at
    a stage's largest leaf (the docstring at the top)."""
    import torch

    hp = PIPE_CONST["hyperparameters"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 29)
    q, k, v, do = (torch.randn(PIPE_MB_SHAPE, generator=gen, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    rows: dict = {"flash_fwd": {}, "flash_bwd_dq": {}, "flash_bwd_dkv": {}}
    attention_kernel_rows(rows, "microbatch", q, k, v, do, True, True, "pipe")
    del q, k, v, do
    _free_cuda()
    rows["fused_adamw"] = {"w_gate": adamw_kernel_row(
        seed, hp["lr"], (4 * hp["d_model"], hp["d_model"]), "w_gate", "pipe")}
    return rows


def phase_pipe(seed: int) -> dict:
    """Parts U, S and K of phase 18 (the docstring at the top)."""
    t_phase = time.monotonic()
    for key, old, value, why in PIPE_CUTS:
        log(f"pipe cut (S): {key} {json.dumps(old)} -> {json.dumps(value)} ({why})")
    out: dict = {}
    for part, fn in (("S", lambda: pipe_main(seed)), ("K", lambda: pipe_kernel_rows(seed))):
        t0 = time.monotonic()
        out[part] = fn()
        log(f"pipe {part}: {time.monotonic() - t0:.1f} s")
        _free_cuda()
    out["launches"] = out["S"]["launches"]
    out["phase_s"] = time.monotonic() - t_phase
    log(f"pipe: phase {out['phase_s']:.1f} s")
    return out


def phase_overlap(seed: int, trained: dict) -> dict:
    """Phase 20 (module docstring): phase 5 with overlap_grad_sync on one
    card, equal to it bitwise, and the plan of the flagship's leaves on
    four cards' meshes."""
    import torch

    from determined_tpu_torch import train
    from determined_tpu_torch.config import ExperimentConfig
    from determined_tpu_torch.models import LMTrial
    from determined_tpu_torch.train import _overlap

    t0 = time.monotonic()
    cfg = ExperimentConfig.parse({"hyperparameters": dict(TRAIN_HPARAMS),
                                  "optimizations": {"overlap_grad_sync": True}})
    ctx = train.init(exp_config=cfg, seed=seed)
    trainer = train.Trainer(LMTrial(ctx))
    _reset_launches()
    summary = trainer.fit(max_length=TRAIN_STEPS, report_period=TRAIN_REPORT,
                          validation_period=TRAIN_STEPS, checkpoint_policy="none")
    torch.cuda.synchronize()
    launches = _launch_counts()
    losses = [m["loss"] for _, m in ctx.core.train.metrics("training")]
    val_loss = summary["validation_metrics"]["validation_loss"]
    assert trainer._overlap_plan is None and trainer._comm_model is None, \
        "one card has no gradient-reduction axis: no plan"
    assert losses == trained["losses"], f"losses {losses} != phase 5's {trained['losses']}"
    assert val_loss == trained["validation_loss"], (val_loss, trained["validation_loss"])
    assert launches == trained["launches"], f"launches {launches} != phase 5's"
    train_s = time.monotonic() - t0

    kind = torch.cuda.get_device_name(0)
    ici_bw, dcn_bw = _overlap.link_bandwidths(kind)
    # the within-slice figure is the card's table entry unless none exists;
    # the cross-slice one is always the placeholder on one host
    table_ici = _overlap._table_bw(kind, _overlap.ICI_BW_BY_KIND, 0.0) or None
    step_s = trained["mean_step_ms_last_20"] / 1e3
    leaves = _overlap.model_leaves(trainer.model)
    plans = {}
    for label, mesh, hier in OVERLAP_MESHES:
        plan = _overlap.build_plan(leaves, mesh, enabled=True,
                                   bucket_bytes=OVERLAP_BUCKET_MB << 20, hierarchical=hier,
                                   device_kind=kind)
        sizes = plan.bucket_bytes()
        plans[label] = dict(
            mesh=mesh, hierarchical=bool(plan.hierarchical_dcn), buckets=len(plan.buckets),
            synced_leaves=plan.synced_leaves, leaves=len(leaves),
            bucket_mib=[min(sizes) / 2 ** 20, max(sizes) / 2 ** 20],
            fsdp_units=len(_overlap.fsdp_units(plan, trainer.model)),
            ici_bytes_per_step=plan.comm.bytes_per_step,
            dcn_bytes_per_step=plan.comm.dcn_bytes_per_step,
            fingerprint=plan.fingerprint(),
            split_ms_at_phase5_step={hop: [e * 1e3, h * 1e3] for hop, (e, h) in
                                     plan.comm.split_hops(step_s).items()},
        )
    flat, hier = plans["dcn2_data2_flat"], plans["dcn2_data2_hier"]
    assert hier["dcn_bytes_per_step"] == flat["dcn_bytes_per_step"] // 2
    out = dict(card=card_line(), plan_on_one_card=None, losses_bitwise_phase5=True,
               launches=launches, train_s=train_s, phase5_step_ms=step_s * 1e3,
               bandwidth_gb_per_s={"ici": ici_bw / 1e9, "dcn": dcn_bw / 1e9},
               ici_table_entry_gb_per_s=table_ici and table_ici / 1e9, plans=plans,
               phase_s=time.monotonic() - t0)
    log("overlap: " + json.dumps(out))
    return out


def main() -> int:
    t_start = time.monotonic()
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    # a subset (e.g. --phases kernel) makes a new kernel's first call on the
    # card short; the contract's kernels line needs kernel, serve and train
    parser.add_argument("--phases", default=",".join(PHASES))
    args = parser.parse_args()
    phases = set(args.phases.split(","))
    unknown = phases - set(PHASES)
    if unknown:
        parser.error(f"unknown phases {sorted(unknown)}; choose from {PHASES}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one GPU", file=sys.stderr)
        return 1
    import determined_tpu_torch  # noqa: F401  (fails outside a checkout)

    card = card_line()
    log(f"card: {card}")
    if "overlap" in phases and "train" not in phases:
        log("overlap: phase 20 holds phase 5's run: running phase 5 (train) first")
        phases.add("train")
    if "fleet" in phases and "cluster" not in phases:
        log("fleet: phase 19 serves phase 17's registry on its cluster: running phase 17 "
            "(cluster) first")
        phases.add("cluster")
    # the native control plane compiles beside the GPU phases (phase 17)
    build = NativeBuild() if "cluster" in phases else None
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {torch.cuda.get_device_name(0)}")

    kernel = {}
    if "kernel" in phases:
        kernel = phase_kernel(args.seed)
    serve = None
    if "serve" in phases or "parity" in phases:
        from determined_tpu_torch.models.transformer import TransformerLM

        gen = torch.Generator(device="cuda").manual_seed(args.seed)
        model = TransformerLM(flagship_config(torch.bfloat16), generator=gen)
        n_params = sum(p.numel() for p in model.parameters())
        log(f"flagship LM: {n_params / 1e6:.1f}M params (f32), compute bf16")
        if "serve" in phases:
            serve = phase_serve(args.seed, model)
        if "parity" in phases:
            if serve is None:
                from determined_tpu_torch.serve import DecodeKernels

                kernels, prompts = DecodeKernels(model, serve_config()), make_prompts(
                    args.seed, model.cfg.vocab_size
                )
            else:
                kernels, prompts = serve.pop("kernels"), serve["prompts"]
            phase_parity(model, kernels, prompts)
            del kernels
        serve = serve and {k: v for k, v in serve.items() if k != "kernels"}
        del model  # free the serving models before training
        gc.collect()
        torch.cuda.empty_cache()
    trained = phase_train(args.seed) if "train" in phases else None
    if "train_parity" in phases:
        phase_train_parity(args.seed)
    experiment = None
    if "experiment" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        experiment = phase_experiment(args.seed)
    search = None
    if "search" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        search = phase_search(args.seed)
    observe = None
    if "observe" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        observe = phase_observe(args.seed, trained and trained["mfu_vs_989_tflops"])
    knobs = None
    if "knobs" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        knobs = phase_knobs(args.seed, trained and trained["peak_memory_gib"])
    serve_ckpt = None
    if "serve_ckpt" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        serve_ckpt = phase_serve_ckpt(args.seed)
    models = None
    if "models" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        models = phase_models(args.seed)
    hf = None
    if "hf" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        hf = phase_hf(args.seed)
    moe = None
    if "moe" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        moe = phase_moe(args.seed)
    seq = None
    if "seq" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        seq = phase_seq(args.seed)
    reference = experiment and experiment.pop("_C", None)
    gang = None
    if "gang" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        gang = phase_gang(args.seed, reference)
        reference = gang.pop("_C")
    cluster = None
    if "cluster" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        cluster = phase_cluster(args.seed, build, reference, keep="fleet" in phases)
    fleet = None
    if "fleet" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        fleet = phase_fleet(args.seed, cluster.pop("_kept"))
    pipe = None
    if "pipe" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        pipe = phase_pipe(args.seed)

    overlap = None
    if "overlap" in phases:
        gc.collect()
        torch.cuda.empty_cache()
        overlap = phase_overlap(args.seed, trained)

    if kernel and serve is not None and trained is not None:
        rows = []
        for name, (source, replaces) in KERNELS.items():
            by_phase = {"train": trained["launches"][name]}
            if name == "flash_fwd":
                by_phase["serve"] = serve["launches"]
            if experiment is not None:
                by_phase["experiment_resume"] = experiment["launches"][name]
            fields = dict(kernel[name])
            if observe is not None:
                by_phase["observe"] = observe["launches"][name]
            if knobs is not None:
                by_phase["knobs_agg"] = knobs["launches"][name]
            if serve_ckpt is not None and name == "flash_fwd":
                by_phase["serve_ckpt"] = serve_ckpt["launches"][name]
            if search is not None:
                by_phase["search"] = search["launches"][name]
                if name == "fused_adamw":  # also held at S3's leaves
                    fields["max_abs_err"] = max(fields["max_abs_err"],
                                                search["S3"]["adamw_max_abs_err"])
            if models is not None:
                by_phase["models"] = models["launches"][name]
                if name == "fused_adamw":  # also held at the UNet's leaves
                    fields["max_abs_err"] = max(fields["max_abs_err"], models["K"]["max_abs_err"])
            if hf is not None:
                by_phase["hf"] = hf["launches"][name]
                if name == "fused_adamw":  # also held at the GPT-2 and BERT-base leaves
                    fields["max_abs_err"] = max(fields["max_abs_err"], hf["K"]["max_abs_err"])
            if moe is not None:
                # held and timed at the MoE LM's shapes too
                by_phase["moe"] = moe["launches"][name]
                fields["moe_shape"] = moe["K"][name]
                fields["max_abs_err"] = max(fields["max_abs_err"], moe["K"][name]["max_abs_err"])
            if seq is not None:
                # L's launches, R's ring (n = 4, forward and backward), and
                # the rows at the ring's shapes
                by_phase["seq"] = seq["launches"][name]
                by_phase["seq_ring"] = seq["R"]["launches"][name]
                fields["seq_shapes"] = seq["K"][name]
                fields["max_abs_err"] = max([fields["max_abs_err"]] + [
                    r["max_abs_err"] for r in seq["K"][name].values()
                    if r["max_abs_err"] is not None])
            if gang is not None:
                # the gang's rank, relayed: A's launches, 0 -> 18, and
                # the resumed attempt's (B), 18 -> 24
                by_phase["gang"] = gang["launches"][name]
                by_phase["gang_resume"] = gang["launches_resume"][name]
            if cluster is not None:
                # the agent's trial process, from its log at the master:
                # the resumed run's launches
                by_phase["cluster_resume"] = cluster["launches"][name]
            if fleet is not None:
                # the fleet's three replica processes, from their logs at
                # the master
                by_phase["fleet_replicas"] = fleet["launches"][name]
            if pipe is not None:
                # S's 1f1b run on the virtual pipe, and the rows at a
                # microbatch's shapes
                by_phase["pipe"] = pipe["launches"][name]
                fields["pipe_shapes"] = pipe["K"][name]
                fields["max_abs_err"] = max([fields["max_abs_err"]] + [
                    r["max_abs_err"] for r in pipe["K"][name].values()])
            if overlap is not None:
                # phase 5 again with overlap_grad_sync on one card
                by_phase["overlap"] = overlap["launches"][name]
            rows.append(dict(
                name=name, route="cuda", source=source, replaces=replaces,
                launches=trained["launches"][name], launches_by_phase=by_phase,
                **fields,
            ))
        print(json.dumps({"kernels": rows}), flush=True)
    log(f"chip_smoke: {time.monotonic() - t_start:.1f} s")
    print(card, flush=True)  # name and power limit, as nvidia-smi gives them
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
