#!/usr/bin/env python3
"""Drive the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Needs one CUDA device (H100-class, sm_90a), ``nvcc`` and ``nvidia-smi``.
Run from the root of a checkout: it imports the port
(``distributed_training_with_pipeline_parallelism_tpu_torch``) and never
JAX. Phases, each fatal on failure:

1. Device and toolchain: the card's name and power limit, the CUDA and
   nvcc versions; build every kernel from ``csrc/`` (one nvcc per source,
   all started together); each kernel's registers and spills as ptxas
   reports them, and no spill in a tensor-core kernel (``*_tc``).
2. Every kernel against its plain PyTorch version on the card at the
   decode and training paths' shapes (and phase 11's attention shapes at
   a model rank's H/T heads), with stated tolerances, timed beside
   its plain version, its bound and one library call that computes the
   same function (a yardstick only; the port never calls it; the device
   kernels it ran are recorded by name). The attention kernels' achieved
   TFLOP/s are recorded beside their times.
3. The decode path: GPT-2-small at full width, random weights from a seed,
   D = 4 lockstep pipeline stages, M = 4 streams, B = 16 prompts of 512
   tokens, 32 new tokens, greedy, log-probs through the fused-xent
   kernel, prefill through the flash kernel. In f32 the kernel run must
   give the tokens of a run on the plain paths and of the single-device
   ``generate`` (a mismatch only where the reference's top-2 logit gap is
   below 1e-4), with log-probs within 1e-4; both kernels must have been
   launched. In bf16 one counted run must launch both kernels, and the
   prefill time and decode tokens/s are measured.
4. The training path: tied GPT-2-small (124M) at full width, random
   weights from a seed, B = 24 sequences of 1024 tokens, M = 4
   microbatches. In f32, one pipelined 1F1B step at D = 4 through all four
   kernels must match the same step on the plain versions and
   single-device autograd of ``transformer_loss`` (loss and every
   gradient leaf), and each kernel's launches must be the count the tick
   table predicts. The same step in bf16 compute (f32 master weights),
   through the kernels (bf16 attention on the tensor cores), must match the
   step on the plain versions in bf16 (loss within 1e-2 relative, each
   gradient leaf within 5e-2 of its norm plus 1e-3 of the global norm)
   with the same launch counts. The bf16 step with a
   ``PipelineTelemetry`` (CUDA events at the tick boundaries) must give
   the unstamped step's loss and gradients bitwise and its launches, a
   timeline of T ticks that covers the span between its start and end
   events within 10%, a Perfetto trace of T·D unit or idle cells, and no
   synchronising call (CUDA's sync debug mode) between its first and
   last stamp; the critical path and the F/B/W split are printed, and
   the recorder's overhead as tokens/s on against off over three
   ``make_train_step`` pairs in alternating order. In bf16
   ``make_train_step`` with
   ``adamw`` runs 2 warm-up and 5 timed steps under GPipe (D = 4), 1F1B
   (D = 4) and Interleaved1F1B (D = 2, V = 2): tokens/s, the analytic
   bubble and every step's loss, which must be finite and fall; one step
   runs under the profiler for its idle share.
5. The llama path: Llama-3.2-1B at full width and depth (16 layers, 32
   heads over 8 kv heads, tied, llama3 rope scaling), random weights from
   a seed, D = 4 stages. (a) f32 decode, M = 4, B = 8 prompts of 256
   tokens, 16 new tokens, greedy, log-probs through the fused-xent kernel,
   prefill through the flash kernel (heads expanded from 8 to 32): tokens
   as in phase 3 against the plain run and single-device ``generate``,
   log-probs within 1e-4, both kernels launched. (b) f32 continuous-
   batching serving (``make_serving_step_fn`` + ``ServingEngine``, M = 8
   slots, chunk C = 32, max_len 640, EOS id 1) of a 12-request Poisson
   trace (prompts 16-512, outputs 8-64, load 1.5): every completion equal
   to ``generate`` of its request alone except at a near-tie, the static
   policy gives the same completions in no fewer ticks, and the engine's
   CUDA graphs give the completions of the same operations launched one
   by one (4 requests). (c) The
   same engine in bf16 over a 32-request trace, continuous and static,
   ``SERVE_REPS`` runs each (one; three until the script needed the
   time), the median by wall time: tokens/s, tick gain, s_per_tick,
   TTFT and TPOT percentiles in ticks, blocking reads per block (also as
   CUDA's sync debug mode counts them), and one block under the profiler.
6. Paged KV and speculative serving of the same Llama-3.2-1B on the
   phase-5 program (D = 4, M = 8, C = 32, EOS id 1), pages of 16 rows
   (P_max 42, 337 pages), gamma 3. (a) f32 paged gate: the 12 Poisson
   requests and 16 shared-prefix requests (the loadgen's ``prefix`` mix
   with two seeded 256-token prefixes before prompts of 16-256 tokens)
   equal to the contiguous engine's except at a near-tie, a prefix hit
   rate above 0, and a drained pool that holds only cached pages. (b) f32
   speculative gate against the plain engine on the 12 requests: the
   target as its own draft (fewer ticks), a random 2-layer draft (verify
   visits) and the self-draft paged; the CUDA graphs against eager
   launches on 4 requests in each mode. (c) bf16 timing, ``SERVE_REPS``
   runs each as in phase 5: contiguous against paged on 32 shared-prefix
   requests, plain against both drafts on the 32 Poisson requests, each
   with tokens/s, ticks, TTFT/TPOT, the page or acceptance gauges, the
   synchronising calls inside the tick blocks under CUDA's sync debug
   mode (none allowed) and one profiled block.
7. The reference's own job: ``ref_decoder`` (the ``ModelConfig()``
   default: dim 768, 8 layers, vocab 10000, ffn 2048, non-causal
   self- and cross-attention), random weights from a seed, B = 32
   sequences of 128 tokens, M = 4. Phase 2 has already held both flash
   kernels at its attention shapes ([8, 128, 8, 96] and [8, 128, 4, 192],
   non-causal, f32 and bf16) to their plain versions. (a) f32 gate: one
   1F1B step at D = 4 through all four kernels (flash forced on, fused
   xent) at 8 heads (head_dim 96) and at 4 (head_dim 192), against the
   same step on the plain versions and single-device autograd, with the
   phase-4 tolerances and the launch counts the tick table predicts. The
   plain run replays the kernel run's relu masks (``ReluMasks``: the
   relu's kink turns an f32 rounding difference into a gradient jump),
   and fewer than 1e-6 of the relu inputs may change sign between the
   two.
   (b) Dropout 0.1 (the dense path; flash takes no dropout) on one step
   seed: GPipe at D = 2 and 1F1B at D = 4 give the same loss and
   gradients, and a loss other than eval mode's. (c) The sweep code
   itself: ``sweep_rows`` over layers 8, heads 4/8/12, D 2/4 and the three
   schedules, f32, 5 timed steps after 2 warm-ups: 18 rows of tokens/s,
   speedup, efficiency, bubble columns, the card's MFU and peak memory;
   then one f32 step of the headline row (L8/H8, GPipe, D = 2) under the
   profiler for its idle share. (e) The sweep as the reference runs it:
   the L8/H8 rows at D = 2 under the three schedules as world rows
   (``sweep_rows(..., backend="gloo")``: one world of 2 processes,
   staged on the one card; 3 timed steps after 2; the D = 4 rows were
   cut for the script's time), each world row's tokens/s beside its
   lockstep row's, the bubble columns equal.

8. ``fit``, the training entry point: tied GPT-2-small at full width,
   random weights from a seed, 1F1B at D = 4, M = 4, S = 1024, both
   kernels routed on. (a) A seeded file of 4 M uint16 tokens (a 1/rank
   unigram) written by ``write_token_file``; ``TokenFileDataset``, the
   native C++ loader (built from the port's source) and
   ``prefetch_to_device`` (depth 2) give shifted crops, the prefetch the
   loader's batch unchanged. (b) f32, B = 8, at 4 of the 12 layers (full
   width): 6 ``fit`` steps with a
   checkpoint every 2, a run report and a ``PipelineTelemetry``: the
   ``report.json`` valid (``telemetry.validate_report``), ``events.jsonl``
   written, the live watermarks available with a peak no lower than the
   sampled bytes in use, the cost model's measured step and critical
   path present, the cost model corrected by phase 13's sweep fit and a
   calibration section; the same run killed in step 3's save (an
   uncommitted shell) and preempted at step 3, each resumed: the final
   parameters, both Adam moments and every step's loss bitwise equal to
   the unbroken run. (c) f32 guard: NaN gradients in stage 1 at step 2
   leave the state bitwise as after step 1 with the optimizer's count at
   2 and the counters total 1, last step 2, stage 1; three poisoned steps
   under a budget of 3 raise after committing the last good state; no
   synchronising call (CUDA's sync debug mode) inside the steps or the
   prefetch between two log points. (d) f32 ``grad_accum=2`` on 2 x 4
   against one step on the 8: mean loss within 1e-5 relative, the
   gradients the update consumed within phase 4's leaf bound, parameters
   within Adam's step (2 lr) of each other; the forward-only pipelined
   eval within 1e-5 of single-device ``transformer_loss``, launching
   the forward kernels as its table predicts and no backward kernel, its
   peak memory beside a training step's. (e) bf16 over f32 master
   weights, B = 24, through ``train.main`` with the native loader,
   prefetch 2, eval and an async checkpoint every 5 steps: 2 warm-up and
   10 timed steps, tokens/s from fit's metrics lines beside phase 4's,
   each eval's time, how long each save blocks the loop, the launches of
   one step and one eval, finite and falling losses; then two profiled
   runs (steps 2-4, prefetch 2 and 0) whose Chrome traces must hold all
   four kernels, with their idle shares. The temporary files go at the
   end.

9. Zero-bubble training: tied GPT-2-small at full width, random weights
   from a seed, S = 1024, M = 4, both kernels routed on, under ZBH1 (D =
   4) and ZBV (D = 2, two V-placed chunks a device): the split backward
   (B: recompute and input gradient; W: recompute and weight gradient;
   stage 0 has no B) and the V routes. (a) f32, B = 8: one step of each
   against the same step on the plain versions and single-device
   autograd, with phase 4's bounds, and each kernel's launches the count
   the tables predict (``zb_launches``: lps·(3S−1)·M ``flash_fwd``,
   lps·(2S−1)·M ``flash_bwd``, 2M of each xent kernel; 132 / 84 / 8 / 8
   for both). (b) The same steps in bf16 compute over f32 master
   weights against the plain versions in bf16, phase 4's bf16 bounds,
   the same launch counts. (c) bf16, B = 24, ``make_train_step`` +
   ``adamw``, 2 warm-up and 5 timed steps, in turns: 1F1B, ZBH1, ZBH1,
   1F1B at D = 4, then Interleaved1F1B, ZBV, ZBV, Interleaved1F1B at D =
   2: tokens/s, the ratio of each zero-bubble schedule to its peer, the
   analytic and paper bubbles, and losses that are finite and fall. (d)
   One bf16 ZBH1 step under the profiler: idle share and top kernels.
   (e) ``run_one_experiment`` rows for ZBH1 and ZBV at the sweep's
   headline L8/H8, D = 2 (f32, B = 32, S = 128; ZBV's M = 2D = 4).

10. The ``torch.distributed`` transport: a world of 4 processes on the one
    card (``parallel.mesh.launch``, gloo, every hand-off and collective
    staged through pinned host memory; rank 0's ``mesh.describe()`` is
    printed), tied GPT-2-small at full width, random weights from a
    seed, both kernels routed on, M = 4. Every rank first runs a
    one-layer model's forward and backward per config, all at once: a
    first pipelined step would pay each rank's first launches one rank
    after another down the pipe. (a) f32, B = 8: 1F1B at D = 4
    x n_data = 1, 1F1B and Interleaved1F1B at D = 2 x n_data = 2, each
    with ``comm_overlap`` "none" and "ring": the loss and every leaf of
    each rank against the lockstep process's f32 1F1B D = 4 step on the
    same weights (phase 4's bounds), "ring" bitwise equal to "none", and
    each rank's launches equal to its row of the table
    (``rank_launches``; at n_data = 1 summing to phase 4's 96 / 48 / 4 /
    4). (b) Two clipped AdamW updates at D = 2 x 2, ZeRO-1 and plain,
    against the lockstep process's train step on the whole model and
    batch: each update's clipping norm within 1e-5, each leaf within
    phase 4's bound of its move (the k biases, whose gradient is rounding
    noise, within the learning rate a step). (c) bf16 over f32 master
    weights, B = 24, 1F1B D = 4: the lockstep process, the world twice,
    the lockstep process again (1 warm-up and 3 timed steps each):
    tokens/s, finite losses, one counted step's launches by rank, one
    step profiled on ranks 0 and 3 (wall, the rank's device busy, idle
    share, the host time of its hand-off waits and posts), and one step
    stamped on every rank: rank 0's merged stamps give T ticks and each
    rank's tick, busy-tick and arrival-wait seconds, printed beside the
    profiled ranks' idle shares. (d) ``train.py
    --pipe 2 --data 2 --backend gloo --zero1`` at 4 of its 12 layers (S =
    1024, B = 8; 6 steps, an eval and a checkpoint every 3): its world starts
    beside the phase's world and is killed (its whole process group) once
    step 2 is committed, while the phase's world runs (a) and (b); (c)
    starts only once it is gone. ``train.run``, the function each rank
    of that world runs, runs over the phase's 2 x 2 mesh twice: unbroken
    after (b), beside the killed world's last steps, and after (c) with
    ``--auto-resume`` from the killed world's checkpoints; each rank
    holds its share of step 5's files to the unbroken run's, bitwise.
    The phase prints its seconds against the 90 it is held to.

11. Megatron tensor parallelism: a world of pipe 2 x model 2 processes on
    the card (gloo, staged), each rank its model coordinate's shard of its
    stages (``parallel.tensor_parallel.shard_model``), every rank warmed
    at once first. (a) Tied GPT-2-small at full width and depth, f32, B =
    8, S = 1024, M = 4, 1F1B and Interleaved1F1B (V = 2), each with
    ``tp_overlap`` "none" and "ring": the loss within 1e-5 and every leaf,
    its error and norm gathered over the model group, within phase 4's
    bound of the lockstep process's D = 2 step on the same weights; each
    rank's launches those of the same pipe rank of a pipe-2 world
    (``tp_rank_launches``), the flash kernels at 6 of the 12 heads. (b)
    Llama-3.2-1B at full width, 4 layers, f32 (GQA 32/8 split to 16/4 a
    rank), the tied head vocab-parallel (128256 / 2), B = 4, S = 256, M =
    2: the same gate; no cross-entropy kernel (the vocab-parallel loss
    bypasses K1, as in JAX). (c) ``ref_decoder`` L8/H8 (B = 32, S = 128,
    M = 4) with the vocab-parallel untied head: the flash kernels forced
    on (K2/K3, non-causal, 4 of 8 heads), then dropout 0.1 on the dense
    path (the head-sharded masks) on one step seed, each against the
    lockstep process's step, whose relu masks each rank replays on its
    columns (``ReluMasks``: the row-parallel sums round otherwise,
    and the kink turns that into gradient jumps; fewer than 1e-6 of the
    relu inputs may change sign). (d) bf16 over f32 masters, B = 24, 1F1B
    (the tokens/s of the world in turns with the lockstep process were cut
    for the script's time): launches by rank of one counted step, one
    step profiled on every rank (idle share, the
    model-axis all-reduces' count and host time, the hand-offs'), one
    step stamped on every rank as in phase 10 (c). (e)
    ``train.py --pipe 2 --tp 2 --backend gloo`` at 4 layers, S = 256, 4
    steps: its world starts beside the phase's and is killed once step 1
    is committed; ``train.run`` runs over the phase's mesh unbroken and then
    resumed from the killed world's checkpoints, each rank holding its
    share of step 3's files to the unbroken run's, bitwise. The phase
    prints its seconds.

12. The static table verifier, a certified searched schedule and
    training dynamics: every table phases 3-11 built passed the static
    verifier at build (``DTPP_VERIFY_TABLES=1`` for the whole script, the
    reports counted through a wrap of ``check_table_cached``);
    untied GPT-2-small (the JAX default) at full width, random weights
    from a seed, D = 4, M = 4, S = 1024, both kernels routed on. (a) A
    seeded search at D = 4, M = 4 (600 iterations) writes an artifact
    that reloads through the certifying loader and registers as a
    schedule. (b) f32, B = 8, on the searched table (a split backward) and
    on 1F1B: the ``dynamics=True`` step's loss and every gradient bitwise
    the plain step's, its ``sq_mb`` within 1e-4 relative of M
    single-device autograd passes on the plain versions, one per
    microbatch, ``stage_stats`` within 1e-4 of the same statistics of
    those passes' mean gradient, each kernel's launches the count the
    table predicts; then one 1F1B ``make_train_step(dynamics=True)``
    step, its statistics within 1e-4 of plain f64 norms of its
    gradients, parameters and update. (c) bf16 over f32 masters, B = 24, ``fit(dynamics=
    True)`` for 8 steps logging every 2, prefetched batches with their
    host digests (a seeded token file of 1 M uint16 tokens, a 1/rank
    unigram), the guard and NaN gradients in stage 1 at step 3, a run
    report: the ``dynamics`` section valid with a gradient-noise scale
    over at least 3 updates, one ``anomaly_attributed`` event naming
    stage 1, one valid forensic bundle, no synchronising call between log
    points (CUDA's sync debug mode); then tokens/s with dynamics on and
    off, in turns (on, off, off, on). (d) The sweep's L8/H8 rows at D = 2
    with ``dynamics=True`` and one L8/H8 row at D = 4 on the searched
    artifact, carrying its digest. (c)'s guarded run is stamped, so its
    report carries the cost model under phase 13's correction.

13. The cost model's calibration and serving's cost and memory
    instruments. Its first part runs right after phase 7: (a) the JAX
    ``smoke`` probe grid, seed 0 (9 probes of the JAX probe model, 4 of
    them ``comm_overlap="ring"``), measured on the card through
    ``analysis.calibration.run_probe``; an ``h100`` correction fitted
    from them; every ledger row valid and read back verbatim, a second
    fit over the ledger's rows giving the artifact's bytes, a tampered
    artifact refused, the corrected median |relative error| below the
    raw one, and under the correction comm_overlap <= serial for every
    row and overlapped <= comm_overlap <= serial on the JAX calibration
    pass's three tables (the lower half can part on a probe's table: the
    two prices attribute a hop to ticks one apart; printed). (b) Phase 7 (d)'s 18 f32 sweep rows (from
    their run reports' cost models) as ledger rows, an ``h100``
    correction fitted on them, loaded back by the raising
    ``load_correction_artifact`` and named by
    ``$DTPP_CALIBRATION_CORRECTIONS`` for phases 8-12. The second part
    runs last: phase 8 (b)'s and phase 12 (c)'s ``fit`` reports carry
    ``cost_model.predicted.corrected`` and a ``calibration`` section
    with that correction (both validated by their phases); raw and
    corrected errors of the probes, the sweep rows and both runs are
    printed (under the probe fit too). (c) ``run_paged_bench`` and
    ``run_spec_bench`` on Llama-3.2-1B, f32, with the phase 5-6 program
    (D = 4, 8 slots, chunk 32, pages of 16, gamma 3) and mixes, 8
    requests each: ``outputs_match`` in both, reports that
    ``validate_report`` accepts with the serving cost and memory
    sections, a numeric ``predicted_s_per_tick``, predicted beside
    measured s_per_tick per engine. The phase prints its seconds against
    the 45 it is held to; the script prints every phase's and its
    whole time.

14. FSDP and sequence parallelism: one world of 4 processes on the card
    (gloo, staged) that makes two meshes over its ranks, pipe 2 x data 2
    and pipe 2 x seq 2; tied GPT-2-small at full width and 4 of its 12
    layers, random weights from a seed, B = 8, S = 1024, 1F1B, M = 2,
    both kernels routed on (phase 2 holds them at this phase's shapes,
    [2, 1024, 12, 64] and 2048 rows of the vocab). (a) f32 FSDP: each
    rank's view cut to its data coordinate's shards
    (``parallel.fsdp.fsdp_shard_params``); the loss within 1e-5 relative
    and every leaf, a shard's error and norm summed over the data group,
    within phase 4's bound of the lockstep process's D = 2 step on the
    same weights and batch; each rank's layer matrices and their
    gradients hold exactly half its stage's bytes; its launches its row
    of the table's (``rank_launches``). (b) The same gate on the seq
    mesh, ring then Ulysses (12 heads over 2), 512 tokens a rank: only
    the cross-entropy kernels launch (the sequence-parallel attention is
    plain torch, as in JAX). (c) ``train.py --pipe 2 --data 2 --fsdp``
    and ``--pipe 2 --sp 2 --sp-attn ulysses`` (3 steps each, B = 8, S =
    1024), both at once beside the world's gates: exit 0 and a finite
    final loss.
    (d) bf16 over f32 masters, once they are done: the plain pipe 2 x
    data 2 world, FSDP, ring and Ulysses (1 warm-up and 2 timed
    ``make_train_step`` steps each): tokens/s, one counted step's
    launches by rank, one step profiled on every rank (idle share, the
    port's kernels among the device kernels, which must hold all four
    under FSDP, and the count and host time of the FSDP gathers and
    reduce-scatters, the seq ring's hops and all-to-alls and the
    hand-offs). The phase prints its seconds.

15. Pipelined batch inference and Mixture-of-Experts. (a)
    ``make_pipeline_forward`` on tied GPT-2-small at full width and depth,
    random weights from a seed, B = 8 sequences of 1024 tokens, f32: at D
    = 4, M = 4 on the lockstep transport the logits [8, 1024, 50257]
    within 1e-5 of their largest |value| of single-device
    ``transformer_apply``; ``flash_fwd`` (K4) launched M·L = 48 times, by
    the wrappers' counters and by the profiler, and no other kernel of the
    port. (b) A MoE LM of the same widths at 4 of the 12 layers (cut for
    the script's time), E = 8, top-2, capacity 1.25 (a microbatch routes
    2048 tokens into C = 640 slots an expert), aux 0.01, expert ffn 3072,
    B = 4, 1F1B at D = 2, M = 2, f32: the loss within 1e-5 relative and
    every leaf within phase 4's bound of the per-microbatch oracle
    (autograd of the mean of ``moe_lm_loss`` on the plain versions); the
    cross-entropy kernels launched M times each and no flash kernel (MoE
    blocks attend densely, as in JAX). (c) One world of 4 processes on the
    card (gloo, staged) that makes two meshes over its ranks: pipe 2 x
    data 2, whose forward (V = 1, M = 2) gives every rank its data shard's
    logits within (a)'s bound of the lockstep forward of the same rows;
    and pipe 2 x expert 2, where the MoE step at capacity E and aux 0 is
    held to the lockstep step on the same weights and batch with (b)'s
    gate, each rank's expert stacks exactly half its stage's bytes, 24
    expert all-to-alls a rank's step. (d) ``train.py --moe-experts 8
    --pipe 2`` and ``... --ep 2 --backend gloo``, 3 steps each at 4 layers,
    at once beside the world's gates: exit 0 and a finite final loss.
    Then, in turn, bf16 over f32 masters: the lockstep forward's tokens/s;
    the lockstep MoE step's tokens/s, allocator peak and one profiled step
    (idle share, top kernels, the forward's dispatch and combine einsums'
    share of the device time); the pipe 2 x expert 2 world's tokens/s and
    one profiled step (the all-to-alls' count and host ms). The phase
    prints its seconds.

16. MoE composed with TP, FSDP and seq: one world of 8 processes on the
    card (gloo, staged) that makes three meshes over its ranks, pipe 2 x
    model 2 x expert 2, data 2 x pipe 2 x expert 2 with FSDP and pipe 2 x
    seq 2 x expert 2 with Ulysses; phase 15's MoE LM (GPT-2-small's
    widths, E = 8, top-2, expert ffn 3072, 4 of the 12 layers, cut for the
    script's time), B = 8, S = 1024, 1F1B at D = 2, M = 2. (a) f32 at
    capacity E / top_k and aux 0 (no drops; cut from capacity E for the
    script's time): on each mesh the rank's model is its
    expert block, Megatron shard and FSDP shards of the seeded weights;
    the loss within 1e-5 relative and every leaf (a block's error and
    norm summed over the world from one rank a block) within phase 4's
    bound of the launcher's lockstep step on the same rows; the
    cross-entropy kernels launched M times on each last-stage rank and
    never elsewhere, no flash kernel (MoE blocks attend densely, as in
    JAX); 24 expert all-to-alls a rank's step. (b) bf16 over f32 masters
    at phase 15's routing (capacity 1.25, aux 0.01), on each mesh one
    profiled ``make_train_step`` step (the first, so it also pays the
    first-use costs) and one timed:
    tokens/s, a rank's expert-stack and FSDP-shard bytes, the count and
    host ms of the all-to-alls, model all-reduces, gathers,
    reduce-scatters and hand-offs, and the idle share from the device's
    own events, in [0, 1]. (c) ``train.py --moe-experts 8 --ep 2 --tp 2
    --fsdp --data 2 --pipe 1``, 2 steps at 2 layers and S = 256, beside
    the world: exit 0 and a final loss within 1 of ln V (both
    compositions in one world of 8, for the script's time). The phase
    prints its seconds.

17. TP in the pipelined decoder and the serving engine: one world of
    (pipe 1, data 1, model 2) processes on the card (gloo, staged), each
    rank running D = 2 lockstep stages on its Megatron shard (the blocks
    split, the embedding and the tied head whole) through
    ``parallel.selftest.run_cases``; Llama-3.2-1B at full width (GQA
    32/8, tied, vocab 128256, so the greedy head goes vocab-parallel),
    random weights from a seed. (a) f32 at phase 11's 4 of 16 layers, B
    = 4 prompts of 256 tokens, 16 new tokens, M = 2: each rank's greedy
    tokens those of the T = 1 lockstep decoder and of ``generate`` on
    the same weights, and a ``return_logprobs`` run (the replicated
    head) within 1e-4 (phase 3's rule: a row may part only at a top-2
    logit gap below 1e-4); K4 launched on both ranks at [2, 256, 16, 64]
    (a rank's 16 of 32 heads) and K1 in the log-probs run, by the
    wrappers' counters and each launch's recorded shape. (b) The engine
    in f32, 4 slots, chunk 16, 8 requests (prompts of 16-128 tokens,
    outputs of 8-32): contiguous, paged (pages of 16) and speculative (a
    2-layer draft, whole on every rank, gamma 2), every rank's
    completions (tokens, slots, tick stamps) exactly the T = 1 engine's
    with CUDA graphs, and ``cuda_graphs`` False in the world (staged
    collectives cannot be captured). (c) bf16 at all 16 layers, one
    warm-up and one timed run each, beside the T = 1 lockstep process's
    (timed first, alone on the card): the decoder's tokens/s, the
    engine's s_per_tick and its median TTFT and TPOT in ticks, and from
    one profiled run the count and host ms of the model-axis all-reduces
    and all-gathers. The phase prints its seconds.

18. The model sources (run right after phase 2, on the fresh card:
    ~45 GB of it at the peak): HF-named state dicts made on the card by the
    port's exporters (``models.hf.gpt2_state_dict``, ``llama_state_dict``)
    from seeded port models, in the names and layouts of
    ``GPT2LMHeadModel``, ``GemmaForCausalLM`` and ``Qwen2ForCausalLM``
    (``hf_layout``; ``tests/test_torch_hf.py`` holds it to transformers'
    own classes), read back by ``models.hf.from_hf`` under the published
    config.json fields of openai-community/gpt2 (``GPT2Config()``'s
    defaults), google/gemma-2b and Qwen/Qwen2-0.5B (``HF_CONFIGS``; no
    transformers, no tokenizers, nothing downloaded): each config the
    registry's but for max_seq_len, export and import bitwise both ways.
    (a) The chain of the JAX package's ``scripts/hf_finetune.py`` on
    GPT-2-small: the import as f32 masters under bf16 compute, ``fit``
    for 10 steps of B = 8 x 1024 (1F1B, D = 2, M = 4) from a seeded token
    file, the losses finite and falling and the launches the table's; 16
    greedy tokens from 4 prompts through the pipelined decoder; the
    trained model exported and imported again, its weights and f32 logits
    bitwise. (b) Gemma-2B at full width (head_dim 256, 8 heads over 1 kv
    head, GeGLU, scaled embeddings, vocabulary 256000): the f32 decode at
    all 18 layers, D = 2 lockstep stages, M = 2, B = 4 prompts of 256
    tokens, 16 new tokens, greedy, log-probs through K1 (phase 3's rule
    against the plain run and single-device ``generate``); a f32 1F1B
    gradient step at 4 of the 18 layers, B = 4 x 512, M = 2, D = 2,
    within phase 4's bounds of the plain versions and single-device
    autograd; a bf16 step over the f32 masters at all 18 layers, B = 8 x
    1024, M = 4, D = 2, within phase 4's bf16 bounds of the plain versions
    in bf16, then 3 timed steps (tokens/s of loss and gradients). (c)
    Qwen2-0.5B at full width (q/k/v biases): (b)'s f32 decode gate. Every
    counted run's launches equal the tick table's, each launch at the
    shape its path gives (``launch_shapes``); the phase prints its
    seconds and is held to 90.

Phase 2's bf16 forward cases also hold every output row within 2 bf16
ulps of its largest |o| of the plain version; its cases include phase
18's (head_dim 256 at Gemma-2B's bf16 microbatch and decode prefill, in
bf16 and f32, forward and backward; the cross-entropy kernels at 256000
columns; Qwen2-0.5B's prefill and log-probs). Then it prints the kernel
record as one JSON line (times at the training shape in bf16; launches
from the counted bf16 runs, which take the tensor-core attention kernels
that are timed, by path, the llama decode's and the serving runs' among
them, the paged and speculative runs' 0 as their dense cache attention
takes neither kernel; the llama prefill shape's times beside the flash
kernel's; the reference shapes' bf16 times and the ref_decoder gate's
launches beside each flash kernel's; phase 11's attention shapes at a
model rank's H/T heads, bf16, beside each flash kernel's; phase 8's fit
step, one eval and the entry point's whole run; phase 9's counted bf16 ZBH1 and ZBV steps;
phase 10's counted bf16 world step by rank and summed; phase 11's
counted bf16 TP world step by rank and summed; phase 12's counted f32
dynamics steps and its guarded bf16 ``fit`` run; phase 13's probes and
serving benches; phase 14's counted f32 FSDP, ring and Ulysses steps by
rank and summed, 0 where no kernel serves them; phase 14's shapes' bf16
times beside each kernel's (phase 15's microbatches take the same
shapes); phase 15's counted forward, MoE step and world steps by rank and
summed; phase 16's counted f32 steps on its three meshes by rank and
summed, and the cross-entropy kernels' times at its [1024, 50257]; phase
17's f32 decode and serve runs by rank, and K1's f32 time at its
decode log-probs' [2, 128256]; phase 18's counted runs by path, and
each kernel's times at Gemma-2B's shapes as ``gemma_shapes``),
the card's name and power limit, and as the last line
``{"ok": true, "device": {...}}``. Details go to
``chip_smoke_out/chip_smoke.json``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

PKG = "distributed_training_with_pipeline_parallelism_tpu_torch"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}  # tensor cores / f32 FMA
B, P, N, D, M = 16, 512, 32, 4, 4
# the training path: the JAX bench rung gpt2_small_seq1024_bs24, over stages
TRAIN_B, TRAIN_S, TRAIN_M = 24, 1024, 4
TRAIN_SHAPE = [TRAIN_B // TRAIN_M, TRAIN_S, 12, 64]  # one microbatch's q/k/v
SEED = 0
# the llama path: Llama-3.2-1B through D = 4 stages; the decode gate's
# batch, prompt and new tokens, and the serving engine's program and traces
LLAMA_B, LLAMA_P, LLAMA_N = 8, 256, 16
LLAMA_PREFILL_SHAPE = [LLAMA_B // M, LLAMA_P, 32, 64]  # heads expanded from 8
SERVE = dict(n_slots=8, max_len=640, prompt_max=512, out_max=64,
             prefill_chunk=32, eos_id=1)
SERVE_PROMPTS, SERVE_OUTS, SERVE_LOAD = (16, 512), (8, 64), 1.5
# SERVE_REPS: phases 5 and 6's timed runs a configuration (cut from 3, the
# median by wall time, for the script's time limit)
SERVE_GATE_N, SERVE_TIME_N, SERVE_REPS = 12, 32, 1
# the reference's own job (ref_decoder, dim 768, vocab 10000, ffn 2048):
# batch 32 of 128 tokens, 4 microbatches; one microbatch's attention at
# 8 heads (head_dim 96) and at 4 (head_dim 192), non-causal
REF_B, REF_S, REF_M = 32, 128, 4
REF_SHAPES = {96: [REF_B // REF_M, REF_S, 8, 96],
              192: [REF_B // REF_M, REF_S, 4, 192]}


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, iters: int = 20) -> float:
    """Device time of one call, after three warm-up calls: the summed time
    of the CUDA kernels that a ``torch.profiler`` trace of ``iters`` calls
    records, per call, so the host's gaps between launches are excluded.
    A trace now and then comes back empty (seen on the H100 host after
    some dozens of profiler sessions in one process), so an empty trace is
    taken again, up to three times in all; fails if none records device
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        dev_us = sum(e.self_device_time_total for e in prof.key_averages())
        if dev_us > 0:
            return dev_us / 1e3 / iters
    raise SmokeFailure("torch.profiler recorded no device time in three "
                       "traces")


def device_kernels(fn):
    """The names of the CUDA kernels one call of ``fn`` runs on the device
    (after a warm-up call), as ``torch.profiler`` records them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({e.key[:160] for e in prof.key_averages()
                   if e.self_device_time_total > 0})


def bound(nbytes: float, ops: float, dtype: str):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def all_kernels():
    """Every kernel of the port, in the kernel line's order."""
    from distributed_training_with_pipeline_parallelism_tpu_torch.ops.flash_attention import (
        FLASH_BWD, FLASH_FWD)
    from distributed_training_with_pipeline_parallelism_tpu_torch.ops.fused_xent import (
        XENT_BWD, XENT_FWD)
    return (FLASH_FWD, XENT_FWD, FLASH_BWD, XENT_BWD)


def tp_shapes():
    """Phase 11's attention shapes at a model rank's H/T heads (one
    microbatch): the bf16 GPT-2 timing step's (6 of 12 heads), the
    Llama-3.2-1B gate's (16 of 32, causal) and the ref_decoder gate's (4
    of 8, head_dim 96, non-causal): name -> ([b, s, h, dh], causal)."""
    return {"gpt2": ([TP_TIME_B // TP_M, TRAIN_S, 6, 64], True),
            "llama": ([TP_LLAMA_B // TP_LLAMA_M, TP_LLAMA_S, 16, 64], True),
            "ref": ([REF_B // REF_M, REF_S, 4, 96], False)}


def main_config():
    """GPT-2-small at full width, with both kernels routed."""
    from distributed_training_with_pipeline_parallelism_tpu_torch import gpt2_config
    return gpt2_config("small", use_flash_attention="auto",
                       use_fused_xent=True)


def ptxas_usage(build_log: str):
    """One row per compiled entry function of an ``nvcc -Xptxas=-v`` log:
    its (mangled) symbol, registers and spill bytes."""
    import re
    rows = []
    for ln in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            rows.append(dict(function=m.group(1), registers=None,
                             spill_stores=0, spill_loads=0))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and rows:
            rows[-1].update(spill_stores=int(m.group(1)),
                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and rows:
            rows[-1]["registers"] = int(m.group(1))
    return rows


def phase_toolchain(report):
    import torch
    from distributed_training_with_pipeline_parallelism_tpu_torch.ops._build import (
        build_all, nvcc_version)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    report["card"] = smi
    report["torch"] = torch.__version__
    report["cuda"] = torch.version.cuda
    report["nvcc"] = nvcc_version()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
          f"{report['nvcc']}")
    t0 = time.perf_counter()
    kernels = all_kernels()
    build_all(kernels)
    report["build_s"] = time.perf_counter() - t0
    print(f"built {', '.join(k.source.name for k in kernels)} in "
          f"{report['build_s']:.1f} s")
    report["ptxas"] = {k.name: ptxas_usage(k.build_log) for k in kernels}
    for name, rows in report["ptxas"].items():
        for r in rows:
            print(f"  ptxas {name}: {r['function']}: {r['registers']} registers, "
                  f"spill stores {r['spill_stores']} B, loads {r['spill_loads']} B")
    spilled = [r["function"] for rows in report["ptxas"].values() for r in rows
               if "_tc" in r["function"] and r["spill_stores"] + r["spill_loads"]]
    check(not spilled, f"ptxas spilled registers in {spilled}")


def phase_kernels(report):
    """Each kernel against its plain version on the card; returns the
    records of the training path's shapes (this slice's main path; the
    decode path's shapes are checked and timed too)."""
    import torch
    import torch.nn.functional as F
    from distributed_training_with_pipeline_parallelism_tpu_torch.ops.attention import band_mask
    from distributed_training_with_pipeline_parallelism_tpu_torch.ops.flash_attention import (
        flash_bwd, flash_bwd_plain, flash_fwd, flash_fwd_plain)
    from distributed_training_with_pipeline_parallelism_tpu_torch.ops.fused_xent import (
        xent_bwd, xent_bwd_plain, xent_fwd, xent_fwd_plain)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = []

    def flash_case(b, s, h, dh, dtype, causal, window, layout, tol):
        dt = getattr(torch, dtype)
        if layout == "packed":  # [b, s, h*dh] as the projection writes it
            mk = lambda: torch.randn(b, s, h * dh, generator=gen, device="cuda",  # noqa: E731
                                     dtype=dt).view(b, s, h, dh)
        else:  # [b, h, s, dh] storage read through [b, s, h, dh] strides
            mk = lambda: torch.randn(b, h, s, dh, generator=gen, device="cuda",  # noqa: E731
                                     dtype=dt).transpose(1, 2)
        q, k, v = mk(), mk(), mk()
        o, lse = flash_fwd(q, k, v, causal, window)
        torch.cuda.synchronize()
        o_ref, lse_ref = flash_fwd_plain(q, k, v, causal, window)
        err = (o.float() - o_ref.float()).abs().max().item()
        lse_err = (lse - lse_ref).abs().max().item()
        check(torch.isfinite(o).all().item(), "flash: non-finite output")
        check(err <= tol, f"flash {layout} {[b, s, h, dh]} {dtype} causal="
              f"{causal} window={window}: max |o - plain| {err} > {tol}")
        check(lse_err <= 1e-3, f"flash: lse differs from plain by {lse_err}")
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if window is None:
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, is_causal=causal)
        else:
            mask = band_mask(s, s, window, device="cuda")
            lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qt, kt, vt, attn_mask=mask)
        if causal:
            w = window or s
            pairs = sum(min(i + 1, w) for i in range(s))
        else:
            pairs = s * s
        itemsize = q.element_size()
        flops = 4 * b * h * dh * pairs
        bms, by = bound(4 * b * s * h * dh * itemsize + b * h * s * 4,
                        flops, dtype)
        rec = dict(kernel="flash_fwd", shape=[b, s, h, dh], dtype=dtype,
                   causal=causal, window=window, layout=layout,
                   max_abs_err=err, tol=tol, bound_ms=bms, bound_by=by)
        if dtype == "bfloat16":
            # the error in bf16 ulps of each output row's largest |o_plain|
            # (the bf16 ulp of x is 2^(e - 7) for x in [2^e, 2^(e+1))): the
            # plain version rounds where the kernel rounds, so a row may
            # part by at most 2 ulps, where the absolute bound above would
            # pass a few corrupt V tiles on long rows of small |o|
            row_max = o_ref.float().abs().amax(-1).clamp_min(2.0 ** -126)
            ulp = torch.exp2(torch.floor(torch.log2(row_max)) - 7)
            rec["row_ulp_err"] = ((o.float() - o_ref.float()).abs().amax(-1)
                                  / ulp).max().item()
            check(rec["row_ulp_err"] <= 2.0,
                  f"flash {layout} {[b, s, h, dh]} bf16: a row's error is "
                  f"{rec['row_ulp_err']} > 2 bf16 ulps of its max |o|")
        rec["ms"] = time_ms(lambda: flash_fwd(q, k, v, causal, window))
        rec["tflops"] = flops / rec["ms"] / 1e9
        rec["plain_ms"] = time_ms(lambda: flash_fwd_plain(q, k, v, causal,
                                                          window))
        rec["library_ms"] = time_ms(lib)
        if [b, s, h, dh] == TRAIN_SHAPE:
            rec["library_kernels"] = device_kernels(lib)
        rows.append(rec)
        return rec

    def xent_case(n, v, dtype, rtol):
        dt = getattr(torch, dtype)
        logits = 3 * torch.randn(n, v, generator=gen, device="cuda", dtype=dt)
        tg = torch.randint(0, v, (n,), generator=gen, device="cuda")
        nll, lse = xent_fwd(logits, tg)
        torch.cuda.synchronize()
        nll_ref, lse_ref = xent_fwd_plain(logits, tg)
        rel = ((nll - nll_ref).abs() / nll_ref.abs().clamp_min(1.0)).max().item()
        err = (nll - nll_ref).abs().max().item()
        lse_rel = ((lse - lse_ref).abs() / lse_ref.abs()).max().item()
        check(rel <= rtol and lse_rel <= rtol,
              f"xent {[n, v]} {dtype}: relative nll err {rel}, lse err "
              f"{lse_rel} > {rtol}")
        itemsize = logits.element_size()
        bms, by = bound(n * v * itemsize + n * 8 + 2 * n * 4, 4 * n * v,
                        "float32")
        rec = dict(kernel="xent_fwd", shape=[n, v], dtype=dtype,
                   max_abs_err=err, rel_err=rel, rtol=rtol, bound_ms=bms,
                   bound_by=by)
        rec["ms"] = time_ms(lambda: xent_fwd(logits, tg), 50)
        rec["plain_ms"] = time_ms(lambda: xent_fwd_plain(logits, tg), 50)
        rec["library_ms"] = time_ms(lambda: F.cross_entropy(
            logits, tg, reduction="none"), 50)
        rows.append(rec)
        return rec

    def causal_pairs(s, causal, window):
        if not causal:
            return s * s
        w = window or s
        return sum(min(i + 1, w) for i in range(s))

    def rel_err(got, want):
        """max |got - want| over max |want|, both as f32."""
        return ((got.float() - want.float()).abs().max()
                / want.float().abs().max()).item()

    def flash_bwd_case(b, s, h, dh, dtype, causal, window, layout, rtol):
        dt = getattr(torch, dtype)
        if layout == "packed":
            mk = lambda: torch.randn(b, s, h * dh, generator=gen, device="cuda",  # noqa: E731
                                     dtype=dt).view(b, s, h, dh)
        else:  # [b, h, s, dh] storage, the cotangent too
            mk = lambda: torch.randn(b, h, s, dh, generator=gen, device="cuda",  # noqa: E731
                                     dtype=dt).transpose(1, 2)
        q, k, v, do = mk(), mk(), mk(), mk()
        o, lse = flash_fwd(q, k, v, causal, window)
        got = flash_bwd(q, k, v, o, lse, do, causal, window)
        torch.cuda.synchronize()
        want = flash_bwd_plain(q, k, v, o, lse, do, causal, window)
        errs = [rel_err(x, w) for x, w in zip(got, want)]
        check(all(torch.isfinite(x).all().item() for x in got),
              "flash_bwd: non-finite gradient")
        check(max(errs) <= rtol, f"flash_bwd {layout} {[b, s, h, dh]} {dtype} "
              f"causal={causal} window={window}: max |d - plain| / max "
              f"|plain| (dq, dk, dv) {errs} > {rtol}")
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                      for x in (q, k, v))
        if window is None:
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal)
        else:
            out = F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=band_mask(s, s, window, device="cuda"))
        dot = do.transpose(1, 2)
        lib = lambda: torch.autograd.grad(out, (qt, kt, vt), dot,  # noqa: E731
                                          retain_graph=True)
        # the algorithm's five products (the two-kernel form runs seven)
        flops = 10 * b * h * dh * causal_pairs(s, causal, window)
        bms, by = bound(8 * b * s * h * dh * q.element_size() + b * h * s * 4,
                        flops, dtype)
        err = max((x.float() - w.float()).abs().max().item()
                  for x, w in zip(got, want))
        rec = dict(kernel="flash_bwd", shape=[b, s, h, dh], dtype=dtype,
                   causal=causal, window=window, layout=layout,
                   max_abs_err=err, rel_err=max(errs), rtol=rtol,
                   bound_ms=bms, bound_by=by)
        rec["ms"] = time_ms(lambda: flash_bwd(q, k, v, o, lse, do, causal,
                                              window))
        rec["tflops"] = flops / rec["ms"] / 1e9
        rec["plain_ms"] = time_ms(lambda: flash_bwd_plain(
            q, k, v, o, lse, do, causal, window), 5)
        rec["library_ms"] = time_ms(lib)
        if [b, s, h, dh] == TRAIN_SHAPE:
            rec["library_kernels"] = device_kernels(lib)
        rows.append(rec)
        return rec

    def xent_bwd_case(n, v, dtype, rtol, pad_row=None):
        dt = getattr(torch, dtype)
        logits = 3 * torch.randn(n, v, generator=gen, device="cuda", dtype=dt)
        tg = torch.randint(0, v, (n,), generator=gen, device="cuda")
        g = torch.rand(n, generator=gen, device="cuda") / n
        if pad_row is not None:
            g[pad_row] = 0.0
        _, lse = xent_fwd(logits, tg)
        got = xent_bwd(logits, tg, lse, g)
        torch.cuda.synchronize()
        want = xent_bwd_plain(logits, tg, lse, g)
        rel = rel_err(got, want)
        check(torch.isfinite(got).all().item(), "xent_bwd: non-finite")
        check(rel <= rtol, f"xent_bwd {[n, v]} {dtype}: max |grad - plain| / "
              f"max |plain| {rel} > {rtol}")
        if pad_row is not None:
            check(bool((got[pad_row] == 0).all()),
                  "xent_bwd: a pad row's gradient is not exactly 0")
        x = logits.detach().requires_grad_()
        nll = F.cross_entropy(x, tg, reduction="none")
        lib = lambda: torch.autograd.grad(nll, x, g, retain_graph=True)  # noqa: E731
        itemsize = logits.element_size()
        bms, by = bound(2 * n * v * itemsize + n * (8 + 4 + 4), 4 * n * v,
                        "float32")
        rec = dict(kernel="xent_bwd", shape=[n, v], dtype=dtype,
                   max_abs_err=(got.float() - want.float()).abs().max().item(),
                   rel_err=rel, rtol=rtol, pad_row=pad_row, bound_ms=bms,
                   bound_by=by)
        rec["ms"] = time_ms(lambda: xent_bwd(logits, tg, lse, g))
        rec["plain_ms"] = time_ms(lambda: xent_bwd_plain(logits, tg, lse, g),
                                  5)
        rec["library_ms"] = time_ms(lib)
        rows.append(rec)
        return rec

    tol = {"float32": 2e-5, "bfloat16": 2e-2}
    # backward tolerances, relative to the largest reference gradient:
    # f32 differs by summation order only; bf16 outputs round once (one
    # bf16 ulp is 2^-8 of the value)
    bwd_tol = {"float32": 1e-4, "bfloat16": 1e-2}
    main = {}
    for dtype in ("bfloat16", "float32"):
        # the training path's attention: one microbatch of B/M sequences
        main[("flash_fwd", dtype)] = flash_case(
            *TRAIN_SHAPE, dtype, True, None, "packed",
            tol[dtype])
        # the decode path's prefill: one stream of B/M prompts per stage call
        flash_case(B // M, P, 12, 64, dtype, True, None, "packed", tol[dtype])
        # the llama decode prefill: B/M prompts, 32 heads expanded from 8
        main[("flash_fwd_llama", dtype)] = flash_case(
            *LLAMA_PREFILL_SHAPE, dtype, True, None, "packed", tol[dtype])
        flash_case(16, 512, 12, 64, dtype, True, None, "packed", tol[dtype])
        # the K2 route: a window, a ragged length, head_dim 128, transposed
        flash_case(2, 1000, 8, 128, dtype, True, 256, "transposed",
                   tol[dtype])
        flash_case(2, 256, 4, 64, dtype, False, None, "packed", tol[dtype])
        flash_case(1, 130, 2, 256, dtype, True, None, "transposed",
                   tol[dtype])
        # the reference's attention: non-causal at head_dim 96 and 192
        for dh, shape in REF_SHAPES.items():
            main[(f"flash_fwd_ref{dh}", dtype)] = flash_case(
                *shape, dtype, False, None, "packed", tol[dtype])
    for name, (shape, causal) in tp_shapes().items():
        # phase 11's attention at a model rank's H/T heads (bf16: phase
        # 11's f32 gates hold the f32 kernels there)
        main[(f"flash_fwd_tp_{name}", "bfloat16")] = flash_case(
            *shape, "bfloat16", causal, None, "packed", tol["bfloat16"])
        main[(f"flash_bwd_tp_{name}", "bfloat16")] = flash_bwd_case(
            *shape, "bfloat16", causal, None, "packed", 1e-2)
    # phase 14's FSDP attention: a data rank's microbatch (bf16: phase
    # 14's f32 gate holds the f32 kernels there)
    main[("flash_fwd_par", "bfloat16")] = flash_case(
        *PAR_SHAPE, "bfloat16", True, None, "packed", tol["bfloat16"])
    main[("flash_bwd_par", "bfloat16")] = flash_bwd_case(
        *PAR_SHAPE, "bfloat16", True, None, "packed", 1e-2)
    # phase 18's Gemma-2B: head_dim 256 over 8 heads expanded from 1 (the
    # JAX strided route, K2/K3), causal: the bf16 step's microbatch and the
    # f32 decode's prefill, each in both dtypes; Qwen2-0.5B's prefill (K4,
    # 14 heads from 2) in f32, its decode's dtype
    for dtype in ("bfloat16", "float32"):
        main[("flash_fwd_gemma", dtype)] = flash_case(
            *GEMMA_SHAPE, dtype, True, None, "packed", tol[dtype])
        main[("flash_bwd_gemma", dtype)] = flash_bwd_case(
            *GEMMA_SHAPE, dtype, True, None, "packed", bwd_tol[dtype])
        main[("flash_fwd_gemma_prefill", dtype)] = flash_case(
            *GEMMA_PREFILL_SHAPE, dtype, True, None, "packed", tol[dtype])
    flash_case(*QWEN_PREFILL_SHAPE, "float32", True, None, "packed",
               tol["float32"])
    for dtype, rtol in (("bfloat16", 1e-3), ("float32", 1e-5)):
        # the training path's loss: one microbatch's rows of the vocab
        main[("xent_fwd", dtype)] = xent_case(TRAIN_B // TRAIN_M * TRAIN_S,
                                              50257, dtype, rtol)
        # phase 14's loss: an FSDP rank's [2, 1024] and a seq rank's
        # [4, 512] microbatch, 2048 rows either way
        main[("xent_fwd_par", dtype)] = xent_case(PAR_XENT_ROWS, 50257,
                                                  dtype, rtol)
        # phase 16's loss on a data x expert rank: a [1, 1024] microbatch
        main[("xent_fwd_moe", dtype)] = xent_case(MOE_XENT_ROWS, 50257,
                                                  dtype, rtol)
        # phase 17's decode log-probs: B/M rows of Llama's vocabulary
        main[("xent_fwd_tps", dtype)] = xent_case(TPS_B // TPS_M, 128256,
                                                  dtype, rtol)
        # phase 18: Gemma-2B's bf16 step's microbatch rows of its 256000
        # vocabulary, and its and Qwen2-0.5B's decode log-probs
        main[("xent_fwd_gemma", dtype)] = xent_case(GEMMA_XENT_ROWS,
                                                    GEMMA_VOCAB, dtype, rtol)
        main[("xent_fwd_gemma_decode", dtype)] = xent_case(
            HF_B // HF_M, GEMMA_VOCAB, dtype, rtol)
        xent_case(HF_B // HF_M, QWEN_VOCAB, dtype, rtol)
        # the decode path's head: B/M rows per stage call
        xent_case(B // M, 50257, dtype, rtol)
        xent_case(7, 50257, dtype, rtol)
    for dtype in ("bfloat16", "float32"):
        # the training path's attention: one microbatch of B/M sequences
        main[("flash_bwd", dtype)] = flash_bwd_case(
            *TRAIN_SHAPE, dtype, True, None, "packed",
            bwd_tol[dtype])
        # the K3 route: a window, a ragged length, head_dim 128, transposed
        flash_bwd_case(2, 1000, 8, 128, dtype, True, 256, "transposed",
                       bwd_tol[dtype])
        flash_bwd_case(2, 256, 4, 64, dtype, False, None, "packed",
                       bwd_tol[dtype])
        flash_bwd_case(1, 130, 2, 256, dtype, True, None, "transposed",
                       bwd_tol[dtype])
        for dh, shape in REF_SHAPES.items():
            main[(f"flash_bwd_ref{dh}", dtype)] = flash_bwd_case(
                *shape, dtype, False, None, "packed", bwd_tol[dtype])
        # the training path's head: one microbatch's rows of the vocab
        main[("xent_bwd", dtype)] = xent_bwd_case(
            TRAIN_B // TRAIN_M * TRAIN_S, 50257, dtype, bwd_tol[dtype])
        main[("xent_bwd_par", dtype)] = xent_bwd_case(
            PAR_XENT_ROWS, 50257, dtype, bwd_tol[dtype])
        main[("xent_bwd_moe", dtype)] = xent_bwd_case(
            MOE_XENT_ROWS, 50257, dtype, bwd_tol[dtype])
        main[("xent_bwd_gemma", dtype)] = xent_bwd_case(
            GEMMA_XENT_ROWS, GEMMA_VOCAB, dtype, bwd_tol[dtype])
        xent_bwd_case(7, 50257, dtype, bwd_tol[dtype], pad_row=3)
    for r in rows:
        print(f"  {r['kernel']} {r['shape']} {r['dtype']}"
              + (f" causal={r['causal']} window={r['window']} {r['layout']}"
                 if r["kernel"].startswith("flash") else "")
              + f": max_abs_err {r['max_abs_err']:.3g}"
              + (f" ({r['row_ulp_err']:.2f} ulp of its row's max)"
                 if "row_ulp_err" in r else "")
              + "  kernel "
              f"{r['ms']:.4f} ms"
              + (f" ({r['tflops']:.1f} TFLOP/s)" if "tflops" in r else "")
              + f"  plain {r['plain_ms']:.4f} ms  bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})  library "
              f"{r['library_ms']:.4f} ms")
    for r in rows:
        if "library_kernels" in r:
            print(f"  library yardstick of {r['kernel']} {r['dtype']} ran: "
                  f"{r['library_kernels']}")
    report["kernel_checks"] = rows
    return main


def compare_tokens(name, toks, ref, lps, ref_lps, gap, lp_tol=1e-4,
                   gap_tol=1e-4, p=P, n=N):
    """Rows must agree with ``ref`` token for token; a row may part only at
    a step where the reference's top-2 logit gap is below ``gap_tol`` and
    is not compared past it. Log-probs agree within ``lp_tol`` up to
    there. ``p`` and ``n`` are the prompt and new-token counts. Returns
    the rows that parted at a near-tie."""
    new, ref_new = toks[:, p:], ref[:, p:]
    parted = []
    worst_lp = 0.0
    for r in range(new.shape[0]):
        diff = (new[r] != ref_new[r]).nonzero()
        j = int(diff[0]) if len(diff) else n
        if j < n:
            check(gap[r, j].item() < gap_tol,
                  f"{name}: row {r} step {j}: token {int(new[r, j])} vs "
                  f"{int(ref_new[r, j])} with top-2 gap {gap[r, j].item()}")
            parted.append(dict(row=r, step=j, gap=gap[r, j].item()))
        if j:
            worst_lp = max(worst_lp,
                           (lps[r, :j] - ref_lps[r, :j]).abs().max().item())
    check(worst_lp <= lp_tol,
          f"{name}: log-probs differ by {worst_lp} > {lp_tol}")
    print(f"  {name}: tokens agree "
          f"({len(parted)} rows part at near-ties: {parted}); "
          f"max |logprob diff| {worst_lp:.3g}")
    return dict(parted=parted, max_lp_diff=worst_lp)


def phase_main_path(report, device="cuda"):
    import torch
    import distributed_training_with_pipeline_parallelism_tpu_torch as port
    from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
        transformer_apply)
    from distributed_training_with_pipeline_parallelism_tpu_torch.ops.flash_attention import (
        FLASH_FWD)
    from distributed_training_with_pipeline_parallelism_tpu_torch.ops.fused_xent import (
        XENT_FWD)
    kernels = (FLASH_FWD, XENT_FWD)
    cfg = main_config()
    plain = dataclasses.replace(cfg, use_flash_attention=False,
                                use_fused_xent=False)
    g = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    model = port.init_params(cfg, g, device)
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=g).to(device)
    print(f"  GPT-2-small ({sum(p.numel() for p in model.parameters())} "
          f"params) initialised in {time.perf_counter() - t0:.1f} s")

    def top2_gap(toks):
        with torch.no_grad():
            logits = transformer_apply(plain, model, toks[:, :P + N - 1])
            top = logits[:, P - 1:].float().topk(2, dim=-1).values
        return top[..., 0] - top[..., 1]

    # the counted run: the f32 pipelined decoder through both kernels
    for k in kernels:
        k.launches = 0
    toks, lps = port.make_pipeline_generate_fn(
        cfg, D, N, n_streams=M, return_logprobs=True,
        device=device)(model, prompt)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    print(f"  f32 pipelined decode (D={D}, M={M}, B={B}, P={P}, N={N}): "
          f"kernel launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"the main path launched {name} no time")
    check(toks.shape == (B, P + N), f"tokens shape {tuple(toks.shape)}")
    check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
          "token out of vocab")
    check(bool(torch.isfinite(lps).all() and (lps <= 0).all()),
          "log-probs not finite and <= 0")

    toks_p, lps_p = port.make_pipeline_generate_fn(
        plain, D, N, n_streams=M, return_logprobs=True,
        device=device)(model, prompt)
    check(all(k.launches == launches[k.name] for k in kernels),
          "the plain run launched a kernel")
    toks_s, lps_s = port.generate(cfg, model, prompt, N,
                                  return_logprobs=True, device=device)
    res = dict(launches=launches)
    res["kernel_vs_plain"] = compare_tokens(
        "f32 kernel run vs plain run", toks, toks_p, lps, lps_p,
        top2_gap(toks_p))
    res["pipelined_vs_single"] = compare_tokens(
        "f32 pipelined vs single-device generate", toks, toks_s, lps, lps_s,
        top2_gap(toks_s))

    # bf16 compute over the f32 weights: prefill time and decode rate
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16", param_dtype="float32")
    fn1 = port.make_pipeline_generate_fn(cfg16, D, 1, n_streams=M,
                                         return_logprobs=True, device=device)
    fnn = port.make_pipeline_generate_fn(cfg16, D, N, n_streams=M,
                                         return_logprobs=True, device=device)

    def run(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(model, prompt)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    run(fn1), run(fnn)  # warm-up
    times1 = [run(fn1)[1] for _ in range(3)]
    # the counted bf16 run: its launches are the kernel line's decode count
    for k in kernels:
        k.launches = 0
    (toks16, lps16), _ = run(fnn)
    launches16 = {k.name: k.launches for k in kernels}
    timesn = [run(fnn)[1] for _ in range(3)]
    check(bool(((toks16 >= 0) & (toks16 < cfg.vocab_size)).all()
               and torch.isfinite(lps16).all()), "bf16 run: bad output")
    t1, tn = min(times1), min(timesn)
    res["bf16"] = dict(prefill_ms=t1 * 1e3, total_ms=tn * 1e3,
                       decode_tokens_per_s=B * (N - 1) / (tn - t1),
                       runs_n1_s=times1, runs_n_s=timesn,
                       launches=launches16,
                       agree_with_f32=float((toks16 == toks).float().mean()))
    for name, n in launches16.items():
        check(n > 0, f"the bf16 run launched {name} no time")
    print(f"  bf16 pipelined decode: prefill (N=1 run) {t1 * 1e3:.1f} ms, "
          f"N={N} run {tn * 1e3:.1f} ms, decode "
          f"{res['bf16']['decode_tokens_per_s']:.1f} tokens/s, launches "
          f"{res['bf16']['launches']}")

    # where the time goes: device kernel time against wall time of one
    # bf16 N-token run, under the profiler (which adds some host time)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, wall = run(fnn)
    per_kernel = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                         for e in prof.key_averages()
                         if e.self_device_time_total > 0),
                        key=lambda x: -x[1])
    busy = sum(ms for _, ms, _ in per_kernel)
    res["bf16"]["profile"] = dict(
        wall_ms=wall * 1e3, device_busy_ms=busy,
        idle_share=1 - busy / (wall * 1e3),
        top_kernels=[dict(name=n[:120], ms=ms, count=c)
                     for n, ms, c in per_kernel[:12]])
    print(f"  bf16 N={N} run under the profiler: wall {wall * 1e3:.1f} ms, "
          f"device busy {busy:.1f} ms, idle share "
          f"{res['bf16']['profile']['idle_share']:.3f}")
    for n, ms, c in per_kernel[:8]:
        print(f"    {ms:9.3f} ms  {c:6d}x  {n[:100]}")
    report["main_path"] = res
    return launches16


def profile_step(what, step):
    """Where one call of ``step`` spends its time: run it once, then once
    under ``torch.profiler``; wall and device-busy ms, the idle share
    (1 - busy / wall) and the kernels by device time (top 15 kept, top 10
    printed)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    per_kernel = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                         for e in prof.key_averages()
                         if e.self_device_time_total > 0),
                        key=lambda x: -x[1])
    busy = sum(ms for _, ms, _ in per_kernel)
    idle = 1 - busy / (wall * 1e3)
    print(f"  {what} under the profiler: wall {wall * 1e3:.1f} ms, device "
          f"busy {busy:.1f} ms, idle share {idle:.3f}")
    for n, ms, c in per_kernel[:10]:
        print(f"    {ms:9.3f} ms  {c:6d}x  {n[:100]}")
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy, idle_share=idle,
                top_kernels=[dict(name=n[:120], ms=ms, count=c)
                             for n, ms, c in per_kernel[:15]])


def grad_errors(grads, ref, rtol=1e-4, atol=1e-6):
    """Per-leaf ||g - g_ref|| against the bound rtol ||g_ref|| + atol
    ||G_ref|| (G_ref the global reference gradient): the absolute term
    covers leaves whose true gradient is 0 (the k bias: softmax is
    shift-invariant), where both sides hold rounding noise. Returns the
    worst leaf's ratio to its bound and its name, and the largest relative
    error ||g - g_ref|| / ||g_ref|| over the leaves whose reference norm
    is above 1e-3 ||G_ref||."""
    import torch
    g_norm = torch.sqrt(sum((r.double() ** 2).sum() for r in ref.values()))
    worst, leaf, worst_rel = -1.0, None, 0.0
    for name, r in ref.items():
        r = r.double()
        err = (grads[name].double() - r).norm()
        ratio = (err / (rtol * r.norm() + atol * g_norm)).item()
        if ratio > worst:
            worst, leaf = ratio, name
        if r.norm() > 1e-3 * g_norm:
            worst_rel = max(worst_rel, (err / r.norm()).item())
    return worst, leaf, worst_rel


class LoopProbe:
    """A ``PipelineTelemetry`` wrapper that counts the synchronising calls
    CUDA's sync debug mode reports between its ``STEP_START`` and its
    ``STEP_END`` stamp (``caught``: the list ``warnings`` records into),
    that is inside the tick loop."""

    def __init__(self, tel, caught):
        self.tel, self.caught, self.in_loop = tel, caught, None

    def __getattr__(self, name):
        return getattr(self.tel, name)

    def emit(self, kind, index, device=None):
        from distributed_training_with_pipeline_parallelism_tpu_torch.utils import (
            telemetry as tm)
        if kind == tm.STEP_END:
            self.in_loop = sum("synchroniz" in str(w.message)
                               for w in self.caught[self.n0:])
        self.tel.emit(kind, index, device)
        if kind == tm.STEP_START:
            self.n0 = len(self.caught)


def train_telemetry(cfg16, sched, model, tokens, targets, want, one_step,
                    device):
    """Phase 4's stamped step: the bf16 1F1B D = 4 step with a
    ``PipelineTelemetry`` against the same step without one (loss and
    every gradient leaf bitwise, the launches the table's), its timeline
    and attribution, its Perfetto trace, no synchronising call inside the
    tick loop, and the overhead in tokens/s over alternating pairs of
    ``make_train_step`` runs. Returns the record."""
    import tempfile
    import warnings
    import torch
    import distributed_training_with_pipeline_parallelism_tpu_torch as port
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils import (
        telemetry as tm)
    kernels = all_kernels()
    tel = tm.PipelineTelemetry()
    stamped = port.make_pipeline_grad_fn(cfg16, sched, D, device=device,
                                         telemetry=tel)
    plain = port.make_pipeline_grad_fn(cfg16, sched, D, device=device)
    one_step(stamped)  # warm-up
    tel.reset()
    runs = {}
    for name, fn in (("stamped", stamped), ("plain", plain)):
        for k in kernels:
            k.launches = 0
        loss, grads, wall = one_step(fn)
        runs[name] = (loss, grads, wall, {k.name: k.launches
                                          for k in kernels})
    (loss_s, g_s, wall_s, l_s), (loss_p, g_p, _, l_p) = (runs["stamped"],
                                                         runs["plain"])
    check(loss_s == loss_p, f"stamped loss {loss_s} != unstamped {loss_p}")
    differ = [n for n in g_p if not torch.equal(g_s[n], g_p[n])]
    check(not differ, f"stamped gradients differ from the unstamped step's: "
          f"{differ[:4]}")
    check(l_s == l_p == want, f"stamped step launches {l_s}, unstamped "
          f"{l_p}, table {want}")
    del g_s, g_p
    T = tel.table.shape[0]
    timeline = tel.timeline()
    check(len(timeline) == T, f"{len(timeline)} timeline records != T={T}")
    spans = tel.spans()
    step_span = spans[(tm.STEP_END, 0)][1] - spans[(tm.STEP_START, 0)][0]
    ticks_s = sum(r["duration_s"] for r in timeline)
    check(abs(ticks_s - step_span) <= 0.1 * step_span,
          f"tick durations {ticks_s} s vs the stamped step {step_span} s")
    cp = tm.critical_path(tel)
    sb = tel.stage_breakdown()
    print(f"  bf16 1F1B D={D} stamped step: loss and gradients bitwise the "
          f"unstamped step's, launches {l_s}; {T} ticks summing to "
          f"{ticks_s * 1e3:.2f} ms of the {step_span * 1e3:.2f} ms between "
          f"its start and end events ({wall_s * 1e3:.1f} ms host wall); "
          f"critical path compute {cp['compute_s'] * 1e3:.2f} ms, comm "
          f"{cp['comm_s'] * 1e3:.2f} ms, bubble {cp['bubble_s'] * 1e3:.2f} "
          f"ms, straggler device {cp['straggler_device']}; F/B/W "
          f"{sb['f_frac']:.3f}/{sb['b_frac']:.3f}/{sb['w_frac']:.3f}, "
          f"measured bubble {sb['bubble_measured_mean']:.3f}")
    with tempfile.TemporaryDirectory() as tmp:
        path = tm.write_perfetto_trace(tel, os.path.join(tmp, "trace.json"))
        with open(path) as fh:
            trace = json.load(fh)
    cells = {(e["args"]["tick"], e["tid"]) for e in trace["traceEvents"]
             if e["ph"] == "X" and e["pid"] == 0}
    check(len(cells) == T * D, f"the Perfetto trace covers {len(cells)} "
          f"(tick, device) cells, not T*D={T * D}")
    mem = tel.memory_summary()
    check(mem["available"], "no allocator watermark was sampled")

    # no synchronising call between the step's first and last stamp
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        probe = LoopProbe(tm.PipelineTelemetry(), caught)
        probed = port.make_pipeline_grad_fn(cfg16, sched, D, device=device,
                                            telemetry=probe)
        torch.cuda.set_sync_debug_mode("warn")
        try:
            model.zero_grad(set_to_none=True)
            probed(model, tokens, targets)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    check(probe.in_loop == 0, f"{probe.in_loop} synchronising calls inside "
          f"the stamped tick loop")
    model.zero_grad(set_to_none=True)

    # the overhead: make_train_step + adamw, three pairs in alternating
    # order (off, on / on, off / off, on), so a drift between runs falls
    # on both sides
    init_state = {n: p.detach().clone() for n, p in model.state_dict().items()}
    pairs = []
    for i in range(3):
        pair = {}
        for label in (("off", "on"), ("on", "off"))[i % 2]:
            model.load_state_dict(init_state)
            opt = port.adamw(warmup_steps=2, total_steps=100)
            opt_state = opt.init(model)
            step = port.make_train_step(
                cfg16, sched, D, opt, device=device,
                telemetry=tm.PipelineTelemetry() if label == "on" else None)
            metrics = port.run_train_iterations(
                lambda m, t, y: step(m, opt_state, t, y), model, tokens,
                targets, num_iterations=5, warmup_iterations=2)
            pair[label] = metrics["throughput"]
        pairs.append(pair)
    model.load_state_dict(init_state)
    ratios = [p["on"] / p["off"] for p in pairs]
    print(f"  telemetry overhead, bf16 1F1B D={D} make_train_step, 2 warm-up "
          f"and 5 timed steps a run, three pairs in alternating order, "
          f"off/on: "
          + ", ".join(f"{p['off']:.1f}/{p['on']:.1f}" for p in pairs)
          + f" tokens/s (on / off {[round(r, 4) for r in ratios]})")
    return dict(launches=l_s, n_ticks=T, ticks_s=ticks_s,
                step_span_s=step_span, host_wall_s=wall_s,
                critical_path={k: cp[k] for k in (
                    "compute_s", "comm_s", "bubble_s", "total_s",
                    "straggler_device", "straggler_s_per_device")},
                stage_breakdown={k: sb[k] for k in (
                    "f_frac", "b_frac", "w_frac", "bubble_measured_mean")},
                trace_cells=len(cells), memory=mem,
                sync_in_loop=probe.in_loop, overhead_pairs=pairs,
                overhead_ratios=ratios)


def phase_train(report, device="cuda"):
    """The training main path (see the module doc); returns the kernel
    launches of the counted bf16 step (the kernels the timed runs take;
    the f32 step's launches are checked, not returned)."""
    import torch
    import distributed_training_with_pipeline_parallelism_tpu_torch as port
    from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
        transformer_loss)
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel.schedules import (
        analytic_bubble_fraction)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils.config import (
        virtual_stages_for)
    kernels = all_kernels()
    cfg = port.gpt2_config("small", tie_embeddings=True,
                           use_flash_attention=True, use_fused_xent=True)
    plain = dataclasses.replace(cfg, use_flash_attention=False,
                                use_fused_xent=False)
    g = torch.Generator().manual_seed(SEED)
    model = port.init_params(cfg, g, device)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S),
                           generator=g).to(device)
    targets = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S),
                            generator=g).to(device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  tied GPT-2-small ({n_params} params), B={TRAIN_B}, "
          f"S={TRAIN_S}, M={TRAIN_M}")
    res = dict(n_params=n_params)
    sched = port.ScheduleConfig("1F1B", TRAIN_M)
    lps = cfg.n_layers // D

    def one_step(fn):
        """One pipelined (or single-device) forward and backward from zero
        gradients: (loss, gradients, wall seconds)."""
        model.zero_grad(set_to_none=True)
        t = time.perf_counter()
        loss = fn(model, tokens, targets)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        return loss.item(), {n: p.grad.clone()
                             for n, p in model.named_parameters()}, wall

    def single_device(m, t, y):
        loss = transformer_loss(cfg, m, t, y)
        loss.backward()
        return loss.detach()

    # (a) the counted run: f32, 1F1B at D = 4, both kernels routed
    fn = port.make_pipeline_grad_fn(cfg, sched, D, device=device)
    one_step(fn)  # warm-up (first launches, allocator)
    for k in kernels:
        k.launches = 0
    loss_k, grads_k, wall_k = one_step(fn)
    launches = {k.name: k.launches for k in kernels}
    # the tick table runs each (stage, microbatch) forward unit once and its
    # backward unit once; under remat the backward unit re-runs the stage
    # forward, and only the last stage's backward unit takes the loss
    want = {"flash_fwd": 2 * TRAIN_M * D * lps, "flash_bwd": TRAIN_M * D * lps,
            "xent_fwd": TRAIN_M, "xent_bwd": TRAIN_M}
    print(f"  f32 1F1B D={D} step (kernels): loss {loss_k:.6f}, "
          f"{wall_k:.2f} s, launches {launches} (table predicts {want})")
    check(launches == want, f"kernel launches {launches} != {want}")
    # (b) the same step on the plain versions; (c) single-device autograd
    # of the whole batch through both kernels
    loss_p, grads_p, _ = one_step(
        port.make_pipeline_grad_fn(plain, sched, D, device=device))
    check(all(k.launches == launches[k.name] for k in kernels),
          "the plain run launched a kernel")
    loss_s, grads_s, _ = one_step(single_device)
    res.update(loss_f32=loss_k, launches=launches, launches_predicted=want,
               f32_step_s=wall_k)
    for name, l_ref, g_ref in (("plain run", loss_p, grads_p),
                               ("single device", loss_s, grads_s)):
        rel = abs(loss_k - l_ref) / abs(l_ref)
        ratio, leaf, worst_rel = grad_errors(grads_k, g_ref)
        print(f"  f32 kernel step vs {name}: loss {l_ref:.6f} (rel err "
              f"{rel:.2e}), worst leaf {leaf} at {ratio:.3f} of its bound, "
              f"max leaf rel err {worst_rel:.2e}")
        check(rel <= 1e-5, f"loss vs {name}: rel err {rel} > 1e-5")
        check(ratio <= 1.0, f"grads vs {name}: leaf {leaf} over its bound "
              f"({ratio})")
        res[f"vs_{name.replace(' ', '_')}"] = dict(
            loss=l_ref, loss_rel_err=rel, worst_bound_ratio=ratio,
            worst_leaf=leaf, max_leaf_rel_err=worst_rel)
    del grads_k, grads_p, grads_s

    # (d) the bf16 gate: the same step in bf16 compute over the f32 master
    # weights (the tokens/s runs' setting), through the kernels, against
    # the plain versions in bf16. bf16 operands round once per product and
    # the two sides sum in other orders, hence the wider bound
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16", param_dtype="float32")
    plain16 = dataclasses.replace(plain, dtype="bfloat16",
                                  param_dtype="float32")
    fn16 = port.make_pipeline_grad_fn(cfg16, sched, D, device=device)
    one_step(fn16)  # warm-up
    for k in kernels:
        k.launches = 0
    loss_k16, grads_k16, wall_k16 = one_step(fn16)
    launches16 = {k.name: k.launches for k in kernels}
    check(launches16 == want,
          f"bf16 step: kernel launches {launches16} != {want}")
    loss_p16, grads_p16, _ = one_step(
        port.make_pipeline_grad_fn(plain16, sched, D, device=device))
    check(all(k.launches == launches16[k.name] for k in kernels),
          "the plain bf16 run launched a kernel")
    rel16 = abs(loss_k16 - loss_p16) / abs(loss_p16)
    ratio16, leaf16, worst_rel16 = grad_errors(grads_k16, grads_p16,
                                               rtol=5e-2, atol=1e-3)
    print(f"  bf16 1F1B D={D} step (kernels) vs plain bf16: loss "
          f"{loss_k16:.6f} vs {loss_p16:.6f} (rel err {rel16:.2e}), worst "
          f"leaf {leaf16} at {ratio16:.3f} of its bound, max leaf rel err "
          f"{worst_rel16:.2e}, launches {launches16}")
    check(rel16 <= 1e-2, f"bf16 loss vs plain: rel err {rel16} > 1e-2")
    check(ratio16 <= 1.0, f"bf16 grads vs plain: leaf {leaf16} over its "
          f"bound ({ratio16})")
    res["bf16_gate"] = dict(
        loss=loss_k16, loss_plain=loss_p16, loss_rel_err=rel16,
        worst_bound_ratio=ratio16, worst_leaf=leaf16,
        max_leaf_rel_err=worst_rel16, launches=launches16, step_s=wall_k16)
    del grads_k16, grads_p16
    model.zero_grad(set_to_none=True)
    t_tel = time.perf_counter()
    res["telemetry"] = train_telemetry(cfg16, sched, model, tokens, targets,
                                       want, one_step, device)
    res["telemetry"]["seconds"] = time.perf_counter() - t_tel

    # bf16 compute over f32 master weights: make_train_step + adamw
    init_state = {n: p.detach().clone() for n, p in model.state_dict().items()}
    runs = {}
    for name, n_dev in (("GPipe", D), ("1F1B", D), ("Interleaved1F1B", 2)):
        V = virtual_stages_for(name, cfg.n_layers, n_dev)
        model.load_state_dict(init_state)
        opt = port.adamw(warmup_steps=2, total_steps=100)
        opt_state = opt.init(model)
        step = port.make_train_step(cfg16, port.ScheduleConfig(
            name, TRAIN_M, V), n_dev, opt, device=device)
        losses = []

        def counted(m, t, y):
            loss = step(m, opt_state, t, y)
            losses.append(loss)
            return loss

        metrics = port.run_train_iterations(counted, model, tokens, targets,
                                            num_iterations=5,
                                            warmup_iterations=2)
        losses = [x.item() for x in losses]
        bubble = analytic_bubble_fraction(name, n_dev, V, TRAIN_M)
        runs[name] = dict(D=n_dev, V=V, tokens_per_s=metrics["throughput"],
                          elapsed_s=metrics["elapsed_time"],
                          step_s=metrics["elapsed_time"] / 5,
                          bubble=bubble, losses=losses)
        print(f"  bf16 {name} D={n_dev} V={V}: {metrics['throughput']:.1f} "
              f"tokens/s ({metrics['elapsed_time'] / 5 * 1e3:.1f} ms/step), "
              f"analytic bubble {100 * bubble:.1f}%, losses "
              f"{[round(x, 4) for x in losses]}")
        check(all(math.isfinite(x) for x in losses),
              f"{name}: non-finite loss")
        check(losses[-1] < losses[0], f"{name}: the loss did not fall on the "
              f"repeated batch ({losses})")
    res["bf16"] = runs

    # where the time goes: one bf16 1F1B step under the profiler
    model.load_state_dict(init_state)
    opt = port.adamw(warmup_steps=2, total_steps=100)
    opt_state = opt.init(model)
    step = port.make_train_step(cfg16, sched, D, opt, device=device)
    res["profile"] = dict(schedule="1F1B", D=D, **profile_step(
        "bf16 1F1B step", lambda: step(model, opt_state, tokens, targets)))
    report["train"] = res
    return launches16


def llama_main_config():
    """Llama-3.2-1B at full width and depth (tied, llama3 rope scaling),
    with both kernels routed."""
    from distributed_training_with_pipeline_parallelism_tpu_torch import llama_config
    return llama_config("llama3.2-1b", use_flash_attention="auto",
                        use_fused_xent=True)


def top2_gap_of(cfg, model, toks, p):
    """The plain f32 forward's top-2 logit gap at every emitted position of
    toks [B, p + n] (the reference's near-tie test)."""
    import torch
    from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
        transformer_apply)
    plain = dataclasses.replace(cfg, use_flash_attention=False,
                                use_fused_xent=False)
    with torch.no_grad():
        logits = transformer_apply(plain, model, toks[:, :-1])
        top = logits[:, p - 1:].float().topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def serve_summary_line(name, res, card):
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils.telemetry import (
        serving_summary)
    sm = serving_summary(res)
    print(f"  {name}: {sm['tokens_out']} tokens in {sm['wall_s']:.3f} s = "
          f"{sm['tokens_per_sec']:.1f} tokens/s, {sm['ticks']} ticks "
          f"({sm['busy_ticks']} busy), s_per_tick {sm['s_per_tick']:.6f}, "
          f"TTFT p50/p99 {sm['ttft_ticks']['p50']}/{sm['ttft_ticks']['p99']} "
          f"ticks, TPOT p50/p99 {sm['tpot_ticks']['p50']}/"
          f"{sm['tpot_ticks']['p99']} ticks, host syncs "
          f"{res.host_syncs} in {res.n_blocks} blocks [{card}]")
    for key in ("occupancy", "queue_depth"):
        sm.pop(key)
    return sm


def phase_llama(report, device="cuda"):
    """The llama path (see the module doc); returns the kernel launches of
    the counted f32 decode run and of the serving runs."""
    import torch
    import distributed_training_with_pipeline_parallelism_tpu_torch as port
    from distributed_training_with_pipeline_parallelism_tpu_torch.ops.flash_attention import (
        FLASH_FWD)
    from distributed_training_with_pipeline_parallelism_tpu_torch.ops.fused_xent import (
        XENT_FWD)
    kernels = (FLASH_FWD, XENT_FWD)
    card = report["card"]
    cfg = llama_main_config()
    plain = dataclasses.replace(cfg, use_flash_attention=False,
                                use_fused_xent=False)
    g = torch.Generator(device=device).manual_seed(SEED)
    t0 = time.perf_counter()
    model = port.init_params(cfg, g, device)
    prompt = torch.randint(0, cfg.vocab_size, (LLAMA_B, LLAMA_P),
                           generator=g, device=device)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"  Llama-3.2-1B ({n_params} params, {cfg.n_layers} layers, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} kv heads) initialised "
          f"in {time.perf_counter() - t0:.1f} s")
    res = dict(n_params=n_params)

    # (a) the decode gate, f32: the counted run through both kernels
    for k in kernels:
        k.launches = 0
    toks, lps = port.make_pipeline_generate_fn(
        cfg, D, LLAMA_N, n_streams=M, return_logprobs=True,
        device=device)(model, prompt)
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    print(f"  f32 pipelined decode (D={D}, M={M}, B={LLAMA_B}, P={LLAMA_P}, "
          f"N={LLAMA_N}): kernel launches {launches}")
    for name, n in launches.items():
        check(n > 0, f"the llama decode run launched {name} no time")
    check(toks.shape == (LLAMA_B, LLAMA_P + LLAMA_N),
          f"llama tokens shape {tuple(toks.shape)}")
    check(bool(torch.isfinite(lps).all() and (lps <= 0).all()),
          "llama log-probs not finite and <= 0")
    toks_p, lps_p = port.make_pipeline_generate_fn(
        plain, D, LLAMA_N, n_streams=M, return_logprobs=True,
        device=device)(model, prompt)
    check(all(k.launches == launches[k.name] for k in kernels),
          "the plain llama run launched a kernel")
    toks_s, lps_s = port.generate(cfg, model, prompt, LLAMA_N,
                                  return_logprobs=True, device=device)
    cmp = dict(p=LLAMA_P, n=LLAMA_N)
    res["decode"] = dict(launches=launches)
    res["decode"]["kernel_vs_plain"] = compare_tokens(
        "f32 llama kernel run vs plain run", toks, toks_p, lps, lps_p,
        top2_gap_of(cfg, model, toks_p, LLAMA_P), **cmp)
    res["decode"]["pipelined_vs_single"] = compare_tokens(
        "f32 llama pipelined vs single-device generate", toks, toks_s, lps,
        lps_s, top2_gap_of(cfg, model, toks_s, LLAMA_P), **cmp)
    del toks_p, lps_p, toks_s, lps_s

    # (b) the serving gate, f32: every completion against the single-device
    # generate of its request alone; static gives the same completions
    program = port.make_serving_step_fn(cfg, D, device=device, **SERVE)
    engine = port.ServingEngine(program, model)
    trace = port.synth_trace(SERVE_GATE_N, prompt_lens=SERVE_PROMPTS,
                             out_lens=SERVE_OUTS,
                             prefill_chunk=SERVE["prefill_chunk"],
                             load=SERVE_LOAD, vocab_size=cfg.vocab_size,
                             seed=SEED)
    for k in kernels:
        k.launches = 0
    cont = engine.run(trace)
    serve_launches = {k.name: k.launches for k in kernels}
    check(len(cont.completions) == SERVE_GATE_N and cont.n_failed == 0,
          f"serving gate: {len(cont.completions)} completions, "
          f"{cont.n_failed} failed")
    parted, worst_gap = [], 0.0
    for c in cont.completions:
        p = len(c.prompt)
        budget = next(r.max_new_tokens for r in trace if r.rid == c.rid)
        ref, n_ref = port.generate(
            cfg, model, torch.tensor([c.prompt], device=device), budget,
            eos_id=SERVE["eos_id"], return_lengths=True,
            max_len=program.mlen_alloc, device=device)
        want = ref[0, p:p + int(n_ref[0])].tolist()
        if c.tokens == want:
            continue
        j = next((i for i, (a, b) in enumerate(zip(c.tokens, want))
                  if a != b), min(len(c.tokens), len(want)))
        gap = top2_gap_of(cfg, model, ref, p)[0, j].item()
        check(j < min(len(c.tokens), len(want)) and gap < 1e-4,
              f"serving rid {c.rid}: parts from generate at step {j} "
              f"({c.tokens[j:j + 3]} vs {want[j:j + 3]}), top-2 gap {gap}")
        parted.append(dict(rid=c.rid, step=j, gap=gap))
    stat = engine.run(trace, policy="static")
    by_rid = {c.rid: c.tokens for c in stat.completions}
    check(all(by_rid.get(c.rid) == c.tokens for c in cont.completions),
          "serving gate: the static policy's completions differ")
    check(stat.ticks >= cont.ticks, f"static took {stat.ticks} ticks < "
          f"continuous {cont.ticks}")
    print(f"  f32 serving (D={D}, M={SERVE['n_slots']}, "
          f"C={SERVE['prefill_chunk']}, {SERVE_GATE_N} requests): every "
          f"completion equals generate of its request alone "
          f"({len(parted)} part at near-ties: {parted}); static gives the "
          f"same completions in {stat.ticks} ticks vs {cont.ticks}; kernel "
          f"launches {serve_launches} (the chunked prefill is dense)")
    # the engine's CUDA graphs against the same operations launched one
    # by one, on the trace's first requests: the same stamps and tokens
    eager_program = port.make_serving_step_fn(cfg, D, device=device, **SERVE)
    eager_program.cuda_graphs = False
    eager = port.ServingEngine(eager_program, model).run(trace[:4])
    graphs = engine.run(trace[:4])

    def stamps(r):
        return [(c.rid, c.slot, c.first_token_tick, c.finish_tick, c.tokens)
                for c in r.completions]

    check(stamps(eager) == stamps(graphs),
          "serving: the CUDA graphs' completions differ from eager launches")
    print(f"  f32 serving through CUDA graphs equals eager launches on 4 "
          f"requests: {eager.wall_s:.2f} s eager, {graphs.wall_s:.2f} s "
          f"graphs [{card}]")
    res["serve_gate"] = dict(
        n_requests=SERVE_GATE_N, parted=parted, ticks=cont.ticks,
        ticks_static=stat.ticks, launches=serve_launches,
        tokens_out=cont.tokens_out, eager_s=eager.wall_s,
        graphs_s=graphs.wall_s)
    del engine, eager_program

    # (c) serving timing, bf16 compute over the f32 weights: continuous and
    # static on one program, SERVE_REPS runs each, the median by wall time
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16", param_dtype="float32")
    program16 = port.make_serving_step_fn(cfg16, D, device=device, **SERVE)
    engine16 = port.ServingEngine(program16, model)
    trace = port.synth_trace(SERVE_TIME_N, prompt_lens=SERVE_PROMPTS,
                             out_lens=SERVE_OUTS,
                             prefill_chunk=SERVE["prefill_chunk"],
                             load=SERVE_LOAD, vocab_size=cfg.vocab_size,
                             seed=SEED)
    engine16.run(trace[:2])  # warm-up: first launches, allocator
    runs = {}
    for policy in ("continuous", "static"):
        reps = [engine16.run(trace, policy=policy)
                for _ in range(SERVE_REPS)]
        runs[policy] = sorted(reps, key=lambda r: r.wall_s)[len(reps) // 2]
        runs[policy + "_walls"] = [r.wall_s for r in reps]
    cont, stat = runs["continuous"], runs["static"]
    check(all(r.n_failed == 0 for r in (cont, stat)),
          "bf16 serving: a request failed")
    by_rid = {c.rid: c.tokens for c in stat.completions}
    check(all(by_rid.get(c.rid) == c.tokens for c in cont.completions),
          "bf16 serving: the static policy's completions differ")
    timing = dict(continuous=serve_summary_line("bf16 continuous", cont, card),
                  static=serve_summary_line("bf16 static", stat, card),
                  walls={p: runs[p + "_walls"]
                         for p in ("continuous", "static")})
    timing["tick_gain"] = stat.ticks / cont.ticks
    timing["throughput_gain"] = cont.tokens_per_sec / stat.tokens_per_sec
    timing["syncs_per_block"] = cont.host_syncs / cont.n_blocks
    print(f"  bf16 continuous vs static: tick gain {timing['tick_gain']:.3f}, "
          f"tokens/s gain {timing['throughput_gain']:.3f}, host syncs per "
          f"block {timing['syncs_per_block']:.3f} [{card}]")

    # the blocking transfers of a run over the trace's first requests, as
    # CUDA's sync debug mode reports them
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            short = engine16.run(trace[:4])
        finally:
            torch.cuda.set_sync_debug_mode(0)
    n_sync_warn = sum("synchroniz" in str(w.message) for w in caught)
    timing["sync_debug"] = dict(warnings=n_sync_warn, blocks=short.n_blocks,
                                engine_count=short.host_syncs)

    # one block under the profiler: the tenth of a run over the trace's
    # first requests
    from torch.profiler import ProfilerActivity, profile
    step, seen = program16.step, {}

    def profiled_step(weights, state):
        seen["n"] = seen.get("n", 0) + 1
        if seen["n"] != 10:
            return step(weights, state)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            out = step(weights, state)
            torch.cuda.synchronize()
            seen["wall"] = time.perf_counter() - t
        seen["prof"] = prof
        return out

    program16.step = profiled_step
    try:
        engine16.run(trace[:8])
    finally:
        program16.step = step
    check("prof" in seen, "the profiled run ended before its tenth block")
    per_kernel = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                         for e in seen["prof"].key_averages()
                         if e.self_device_time_total > 0),
                        key=lambda x: -x[1])
    busy = sum(ms for _, ms, _ in per_kernel)
    wall_ms = seen["wall"] * 1e3
    timing["profile"] = dict(
        block_ticks=program16.block_ticks, wall_ms=wall_ms,
        device_busy_ms=busy, idle_share=1 - busy / wall_ms,
        top_kernels=[dict(name=n[:120], ms=ms, count=c)
                     for n, ms, c in per_kernel[:12]])
    print(f"  one bf16 block ({program16.block_ticks} ticks) under the "
          f"profiler: wall {wall_ms:.1f} ms, device busy {busy:.1f} ms, idle "
          f"share {timing['profile']['idle_share']:.3f}; sync debug mode: "
          f"{n_sync_warn} synchronising calls in {short.n_blocks} blocks "
          f"(engine count {short.host_syncs}) [{card}]")
    for n, ms, c in per_kernel[:8]:
        print(f"    {ms:9.3f} ms  {c:6d}x  {n[:100]}")
    res["serve_bf16"] = timing
    report["llama"] = res
    return launches, serve_launches


# phase 6: paged KV and speculative serving on the phase-5 program
PAGE_SIZE, SPEC_GAMMA = 16, 3
# the loadgen's "prefix" mix with 256-token prefixes over the serving
# band of prompts 16-256 and outputs 8-64
PREFIX_MIXES = {"prefix": {"base": "serve", "n_prefixes": 2,
                           "prefix_len": 256},
                "serve": {"prompt_lens": (16, 256), "out_lens": (8, 64)}}
PREFIX_GATE_N, GRAPH_CHECK_N = 16, 4


def prefix_trace(n, vocab):
    from distributed_training_with_pipeline_parallelism_tpu_torch.serving import (
        make_workload)
    return make_workload(n, "prefix", prefill_chunk=SERVE["prefill_chunk"],
                         load=SERVE_LOAD, vocab_size=vocab, seed=SEED,
                         mixes=PREFIX_MIXES)


def same_completions(name, got, ref, cfg, model, device):
    """Every completion of ``got`` equal to the one of ``ref`` with its
    rid, except that a stream may part from the reference where the
    reference's top-2 logit gap (the plain f32 forward) is below 1e-4;
    returns the parts."""
    import torch
    check(got.n_failed == ref.n_failed == 0 and
          len(got.completions) == len(ref.completions),
          f"{name}: {len(got.completions)} completions ({got.n_failed} "
          f"failed) against {len(ref.completions)} ({ref.n_failed})")
    want = {c.rid: c for c in ref.completions}
    parted = []
    for c in got.completions:
        r = want[c.rid]
        if c.tokens == r.tokens:
            continue
        j = next((i for i, (a, b) in enumerate(zip(c.tokens, r.tokens))
                  if a != b), min(len(c.tokens), len(r.tokens)))
        p = len(c.prompt)
        toks = torch.tensor([c.prompt + r.tokens], device=device)
        gap = (top2_gap_of(cfg, model, toks, p)[0, j].item()
               if j < len(r.tokens) else float("inf"))
        check(j < min(len(c.tokens), len(r.tokens)) and gap < 1e-4,
              f"{name}: rid {c.rid} parts at step {j} ({c.tokens[j:j + 3]} "
              f"vs {r.tokens[j:j + 3]}), top-2 gap {gap}")
        parted.append(dict(rid=c.rid, step=j, gap=gap))
    return parted


def run_block_probes(engine, trace):
    """Two probe runs of ``engine``: one over ``trace[:4]`` under CUDA's
    sync debug mode, counting the synchronising calls inside the tick
    blocks (``program.step``) and in all; one over ``trace[:8]`` with its
    tenth block under the profiler (idle share, device time by kernel)."""
    import warnings
    import torch
    from torch.profiler import ProfilerActivity, profile
    program = engine.program
    step, seen = program.step, {"in_step": 0}

    def counted_step(weights, state):
        n = len(caught)
        out = step(weights, state)
        seen["in_step"] += len(caught) - n
        return out

    program.step = counted_step
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            short = engine.run(trace[:4])
        finally:
            torch.cuda.set_sync_debug_mode(0)
            program.step = step
    n_warn = sum("synchroniz" in str(w.message) for w in caught)
    out = dict(sync_debug=dict(warnings=n_warn, in_step=seen["in_step"],
                               blocks=short.n_blocks,
                               engine_count=short.host_syncs))
    check(seen["in_step"] == 0 and short.host_syncs == short.n_blocks,
          f"a tick block synchronised: {seen['in_step']} synchronising "
          f"calls inside {short.n_blocks} blocks")

    def profiled_step(weights, state):
        seen["n"] = seen.get("n", 0) + 1
        if seen["n"] != 10:
            return step(weights, state)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            res = step(weights, state)
            torch.cuda.synchronize()
            seen["wall"] = time.perf_counter() - t
        seen["prof"] = prof
        return res

    program.step = profiled_step
    try:
        engine.run(trace[:8])
    finally:
        program.step = step
    check("prof" in seen, "the profiled run ended before its tenth block")
    per_kernel = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                         for e in seen["prof"].key_averages()
                         if e.self_device_time_total > 0),
                        key=lambda x: -x[1])
    busy = sum(ms for _, ms, _ in per_kernel)
    wall_ms = seen["wall"] * 1e3
    out["profile"] = dict(
        block_ticks=program.block_ticks, wall_ms=wall_ms,
        device_busy_ms=busy, idle_share=1 - busy / wall_ms,
        top_kernels=[dict(name=n[:120], ms=ms, count=c)
                     for n, ms, c in per_kernel[:12]])
    return out


def timed_serving(name, engine, trace, card):
    """SERVE_REPS runs of ``trace`` after a warm-up, the median by wall
    time summarised and printed, then the probes."""
    engine.run(trace[:2])  # warm-up: first launches, allocator
    reps = [engine.run(trace) for _ in range(SERVE_REPS)]
    res = sorted(reps, key=lambda r: r.wall_s)[len(reps) // 2]
    check(res.n_failed == 0, f"{name}: a request failed")
    sm = serve_summary_line(name, res, card)
    for key in ("pages_used", "page_fragmentation", "acceptance_series"):
        sm.pop(key, None)
    sm["walls"] = [r.wall_s for r in reps]
    sm.update(run_block_probes(engine, trace))
    extra = ""
    if res.paged:
        extra += (f"prefix hit rate {res.prefix_hit_rate}, peak pages_used "
                  f"{max(n for _, n in res.pages_used)} of "
                  f"{res.pages_capacity}, n_cow {res.n_cow}; ")
    if res.speculative:
        extra += (f"acceptance_rate {res.acceptance_rate:.4f}, "
                  f"accepted_len_mean {res.accepted_len_mean:.4f}; ")
    prof, dbg = sm["profile"], sm["sync_debug"]
    print(f"    {extra}runs {[round(w, 3) for w in sm['walls']]} s; one "
          f"block ({prof['block_ticks']} ticks) under the profiler: wall "
          f"{prof['wall_ms']:.1f} ms, device {prof['device_busy_ms']:.1f} "
          f"ms, idle share {prof['idle_share']:.3f}; sync debug mode: "
          f"{dbg['warnings']} synchronising calls in {dbg['blocks']} blocks, "
          f"{dbg['in_step']} inside them")
    for k in prof["top_kernels"][:5]:
        print(f"      {k['ms']:9.3f} ms  {k['count']:6d}x  {k['name'][:96]}")
    return res, sm


def phase_paged_spec(report, device="cuda"):
    """Paged KV and speculative serving of Llama-3.2-1B (see the module
    doc); returns the kernel launches of the f32 paged and speculative
    runs (the engine attends its caches densely, as the JAX engine does,
    so none is expected)."""
    import torch
    import distributed_training_with_pipeline_parallelism_tpu_torch as port
    card = report["card"]
    kernels = all_kernels()
    cfg = llama_main_config()
    g = torch.Generator(device=device).manual_seed(SEED)
    model = port.init_params(cfg, g, device)
    dcfg = port.llama_config("llama3.2-1b", n_layers=2)
    draft = port.init_params(dcfg, torch.Generator(device=device)
                             .manual_seed(SEED + 1), device)
    paged = dict(paged=True, page_size=PAGE_SIZE)

    def spec(dc):
        return dict(speculative=True, gamma=SPEC_GAMMA, draft_cfg=dc)

    def engine(c, graphs=True, draft_model=None, **mode):
        program = port.make_serving_step_fn(c, D, device=device, **SERVE,
                                            **mode)
        if not graphs:
            program.cuda_graphs = False
        return port.ServingEngine(program, model, draft_params=draft_model)

    poisson = port.synth_trace(SERVE_GATE_N, prompt_lens=SERVE_PROMPTS,
                               out_lens=SERVE_OUTS,
                               prefill_chunk=SERVE["prefill_chunk"],
                               load=SERVE_LOAD, vocab_size=cfg.vocab_size,
                               seed=SEED)
    shared = prefix_trace(PREFIX_GATE_N, cfg.vocab_size)
    res = dict(page_size=PAGE_SIZE, gamma=SPEC_GAMMA)
    for k in kernels:
        k.launches = 0

    # (a) the f32 paged gate
    dense = engine(cfg)
    ref, ref_shared = dense.run(poisson), dense.run(shared)
    del dense
    eng = engine(cfg, **paged)
    pmax, n_pages = eng.program.max_pages_per_slot, eng.program.n_pages
    got = eng.run(poisson)
    parted = same_completions("f32 paged vs contiguous", got, ref, cfg,
                              model, device)
    eng.paging.check_invariants()
    got_shared = eng.run(shared)
    parted_shared = same_completions("f32 paged vs contiguous, shared "
                                     "prefixes", got_shared, ref_shared, cfg,
                                     model, device)
    check(got_shared.prefix_hit_rate > 0, "the shared-prefix trace hit no "
          "cached prefix")
    eng.paging.check_invariants()  # every page back in the pool or cache
    res["paged_gate"] = dict(
        pmax=pmax, n_pages=n_pages, parted=parted,
        parted_shared=parted_shared, ticks=got.ticks, ticks_ref=ref.ticks,
        shared_ticks=got_shared.ticks, shared_ticks_ref=ref_shared.ticks,
        prefix_hit_rate=got_shared.prefix_hit_rate,
        prefill_skipped_tokens=got_shared.prefill_skipped_tokens,
        n_cow=got_shared.n_cow,
        pages_used_max=max(n for _, n in got_shared.pages_used))
    print(f"  f32 paged (page_size {PAGE_SIZE}, P_max {pmax}, {n_pages} "
          f"pages): {SERVE_GATE_N} Poisson requests equal to contiguous "
          f"({len(parted)} part at near-ties) in {got.ticks} ticks "
          f"({ref.ticks}); {PREFIX_GATE_N} shared-prefix requests equal "
          f"({len(parted_shared)} part) in {got_shared.ticks} ticks against "
          f"{ref_shared.ticks}, prefix hit rate {got_shared.prefix_hit_rate}"
          f", {got_shared.prefill_skipped_tokens} prefill tokens skipped, "
          f"n_cow {got_shared.n_cow}, peak pages_used "
          f"{res['paged_gate']['pages_used_max']}; the drained pool holds "
          f"only cached pages [{card}]")

    # (b) the f32 speculative gate, against the plain engine
    gates = {}
    for name, mode, dm, base in (
            ("self-draft", spec(cfg), model, ref),
            ("random 2-layer draft", spec(dcfg), draft, ref),
            ("paged + self-draft", dict(paged, **spec(cfg)), model, ref)):
        e = engine(cfg, draft_model=dm, **mode)
        r = e.run(poisson)
        gates[name] = dict(
            parted=same_completions(f"f32 speculative, {name}", r, base,
                                    cfg, model, device),
            ticks=r.ticks, ticks_plain=base.ticks,
            spec_verify_visits=r.spec_verify_visits,
            acceptance_rate=r.acceptance_rate,
            accepted_len_mean=r.accepted_len_mean)
        check(r.spec_verify_visits > 0, f"{name}: no verify visit")
        if dm is model:
            check(r.ticks < base.ticks, f"{name} took {r.ticks} ticks, the "
                  f"plain engine {base.ticks}")
        print(f"  f32 speculative, {name} (gamma {SPEC_GAMMA}): equal to "
              f"plain ({len(gates[name]['parted'])} part at near-ties), "
              f"{r.ticks} ticks against {base.ticks}, "
              f"{r.spec_verify_visits} verify visits, acceptance_rate "
              f"{r.acceptance_rate:.4f}, accepted_len_mean "
              f"{r.accepted_len_mean:.4f} [{card}]")
        del e
    res["spec_gate"] = gates

    # the CUDA graphs against the same operations launched one by one
    def stamps(r):
        return [(c.rid, c.slot, c.first_token_tick, c.finish_tick, c.tokens)
                for c in r.completions]

    graph_check = {}
    for name, mode, dm in (("paged", paged, None),
                           ("speculative", spec(cfg), model),
                           ("paged + speculative", dict(paged, **spec(cfg)),
                            model)):
        walls = {}
        runs = {}
        for graphs in (False, True):
            r = engine(cfg, graphs, dm, **mode).run(poisson[:GRAPH_CHECK_N])
            runs[graphs], walls[graphs] = r, r.wall_s
        check(stamps(runs[False]) == stamps(runs[True]) and
              runs[False].spec_accepted_tokens ==
              runs[True].spec_accepted_tokens,
              f"{name}: the CUDA graphs' completions differ from eager "
              f"launches")
        graph_check[name] = dict(eager_s=walls[False], graphs_s=walls[True])
    res["graphs_vs_eager"] = graph_check
    print(f"  f32 CUDA graphs equal eager launches on {GRAPH_CHECK_N} "
          f"requests: " + "; ".join(
              f"{n} {v['eager_s']:.2f} s eager, {v['graphs_s']:.2f} s graphs"
              for n, v in graph_check.items()) + f" [{card}]")
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    res["launches"] = launches
    print(f"  kernel launches in the f32 paged and speculative runs: "
          f"{launches} (the engine attends its caches densely)")

    # (c) bf16 timing: contiguous against paged on shared prefixes, plain
    # against speculative on the Poisson trace
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16", param_dtype="float32")
    dcfg16 = dataclasses.replace(dcfg, dtype="bfloat16",
                                 param_dtype="float32")
    shared32 = prefix_trace(SERVE_TIME_N, cfg.vocab_size)
    poisson32 = port.synth_trace(SERVE_TIME_N, prompt_lens=SERVE_PROMPTS,
                                 out_lens=SERVE_OUTS,
                                 prefill_chunk=SERVE["prefill_chunk"],
                                 load=SERVE_LOAD, vocab_size=cfg.vocab_size,
                                 seed=SEED)
    timing = {}
    for name, trace, mode, dm in (
            ("contiguous, shared prefixes", shared32, {}, None),
            ("paged, shared prefixes", shared32, paged, None),
            ("plain", poisson32, {}, None),
            ("speculative, self-draft", poisson32, spec(cfg16), model),
            ("speculative, random draft", poisson32, spec(dcfg16), draft)):
        e = engine(cfg16, draft_model=dm, **mode)
        r, timing[name] = timed_serving(f"bf16 {name}", e, trace, card)
        if r.paged:
            timing[name].update(prefix_hit_rate=r.prefix_hit_rate,
                                pages_used_max=max(
                                    n for _, n in r.pages_used),
                                n_cow=r.n_cow)
        del e
        torch.cuda.empty_cache()
    res["timing"] = timing
    report["paged_spec"] = res
    return launches


def ref_config(n_heads, **kw):
    """The reference's model (``ModelConfig()``'s ref_decoder: dim 768,
    8 layers, vocab 10000, ffn 2048) at ``n_heads``."""
    from distributed_training_with_pipeline_parallelism_tpu_torch import ModelConfig
    return ModelConfig(n_heads=n_heads, **kw)


class ReluMasks:
    """Record which relu inputs are positive in one pipelined run, then
    replay those masks in a second run of the same tick table (``relu(x)
    = x * mask``, whose gradient is the mask): the reference block's relu
    has a kink at 0, where an f32 rounding difference upstream flips a
    unit and moves a lin1 leaf by about one token's term in 4096 (~5e-4
    of its norm; on an H100 a dozen flips in 134M units part the f32
    ref_decoder step from the plain one at 8x the gate's leaf bound).
    Replayed masks make the two runs one piecewise-linear function, so a
    gate holds the kernels (or the model axis), not the kink, to its
    bound; ``flips`` counts the units whose sign the runs disagree on,
    which must stay below 1e-6 of them. Each mask is keyed by (global
    layer, the layer's call count), which one tick table orders alike in
    every process that runs the layer, so the second run may be a TP
    world's rank (another process, its stages only), which replays its
    ``shard`` = (n, index) block of the mask's columns; the pipeline's
    ``body_apply`` is wrapped to tell the relu its layer."""

    def __init__(self, masks=None, shard=None):
        self.masks = {} if masks is None else masks
        self.shard = shard
        self.flips = self.units = 0

    @contextlib.contextmanager
    def patched(self, replay: bool):
        from distributed_training_with_pipeline_parallelism_tpu_torch.models import (
            transformer as tfm)
        from distributed_training_with_pipeline_parallelism_tpu_torch.ops.layers import (
            fold_seed)
        from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
            pipeline as pp)
        real_body, real_relu = pp.body_apply, tfm.relu
        layer, calls = [None], {}

        def body_apply(cfg, layers, h, rng=None, layer_offset=0, tp=None):
            rope = tfm.rope_table(cfg, h.shape[1], h.device)
            for i, block in enumerate(layers):
                layer[0] = layer_offset + i
                rng_l = None if rng is None else fold_seed(rng, layer[0])
                h = block(cfg, h, rope, rng_l, tp)
            return h

        def relu(x):
            key = (layer[0], calls.get(layer[0], 0))
            calls[layer[0]] = key[1] + 1
            if not replay:
                self.masks[key] = x > 0
                return real_relu(x)
            mask = self.masks[key]
            if self.shard is not None:
                n, j = self.shard
                w = mask.shape[-1] // n
                mask = mask[..., j * w:(j + 1) * w]
            mask = mask.to(x.device)
            self.flips += int(((x > 0) != mask).sum())
            self.units += mask.numel()
            return x * mask

        pp.body_apply, tfm.relu = body_apply, relu
        try:
            yield self
        finally:
            pp.body_apply, tfm.relu = real_body, real_relu


REF_WORLD_TIMED = 3  # (e)'s timed steps a world row, after 2 warm-ups


def phase_ref(report, device="cuda"):
    """The reference's own job (see the module doc); returns the kernel
    launches of the counted f32 gate step at head_dim 96."""
    import torch
    import distributed_training_with_pipeline_parallelism_tpu_torch as port
    from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
        transformer_loss)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils.sweep import (
        compute_speedup_and_efficiency, sweep_rows)
    kernels = all_kernels()
    res = {}
    sched = port.ScheduleConfig("1F1B", REF_M)
    launches96 = None

    def one_step(model, fn, tokens, targets, *seed):
        model.zero_grad(set_to_none=True)
        t = time.perf_counter()
        loss = fn(model, tokens, targets, *seed)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        return loss.item(), {n: p.grad.clone()
                             for n, p in model.named_parameters()}, wall

    # (b) the f32 gate at head_dim 96 (8 heads) and 192 (4 heads)
    for heads in (8, 4):
        cfg = ref_config(heads, use_flash_attention=True, use_fused_xent=True)
        plain = dataclasses.replace(cfg, use_flash_attention=False,
                                    use_fused_xent=False)
        g = torch.Generator().manual_seed(SEED)
        model = port.init_params(cfg, g, device)
        tokens, targets = (torch.randint(0, cfg.vocab_size, (REF_B, REF_S),
                                         generator=g).to(device)
                           for _ in range(2))
        fn = port.make_pipeline_grad_fn(cfg, sched, D, device=device)
        one_step(model, fn, tokens, targets)  # warm-up
        for k in kernels:
            k.launches = 0
        relu = ReluMasks()
        with relu.patched(replay=False):
            loss_k, grads_k, wall_k = one_step(model, fn, tokens, targets)
        launches = {k.name: k.launches for k in kernels}
        # per layer two attentions (self and cross), each run by the
        # forward unit and again by the remat backward unit; the loss only
        # in the last stage's backward units
        want = {"flash_fwd": 2 * 2 * REF_M * cfg.n_layers,
                "flash_bwd": 2 * REF_M * cfg.n_layers,
                "xent_fwd": REF_M, "xent_bwd": REF_M}
        dh = cfg.head_dim
        print(f"  f32 ref_decoder L{cfg.n_layers} H{heads} (head_dim {dh}) "
              f"1F1B D={D} step (kernels): loss {loss_k:.6f}, {wall_k:.2f} "
              f"s, launches {launches} (table predicts {want})")
        check(launches == want, f"ref_decoder dh {dh}: kernel launches "
              f"{launches} != {want}")
        with relu.patched(replay=True):
            loss_p, grads_p, _ = one_step(model, port.make_pipeline_grad_fn(
                plain, sched, D, device=device), tokens, targets)
        del relu.masks
        print(f"  plain run with the kernel run's relu masks: {relu.flips} "
              f"of {relu.units} relu inputs change sign between the runs")
        check(relu.flips <= 1e-6 * relu.units, f"ref dh {dh}: {relu.flips} "
              f"relu inputs change sign between kernel and plain runs")

        def single_device(m, t, y):
            loss = transformer_loss(cfg, m, t, y)
            loss.backward()
            return loss.detach()

        loss_s, grads_s, _ = one_step(model, single_device, tokens, targets)
        rec = dict(head_dim=dh, loss=loss_k, launches=launches,
                   launches_predicted=want, step_s=wall_k,
                   relu_flips=relu.flips, relu_units=relu.units)
        for name, l_ref, g_ref in (("plain run", loss_p, grads_p),
                                   ("single device", loss_s, grads_s)):
            rel = abs(loss_k - l_ref) / abs(l_ref)
            ratio, leaf, worst_rel = grad_errors(grads_k, g_ref)
            print(f"  vs {name}: loss {l_ref:.6f} (rel err {rel:.2e}), "
                  f"worst leaf {leaf} at {ratio:.3f} of its bound, max leaf "
                  f"rel err {worst_rel:.2e}")
            check(rel <= 1e-5, f"ref dh {dh} loss vs {name}: rel err {rel}")
            check(ratio <= 1.0, f"ref dh {dh} grads vs {name}: leaf {leaf} "
                  f"over its bound ({ratio})")
            rec[f"vs_{name.replace(' ', '_')}"] = dict(
                loss=l_ref, loss_rel_err=rel, worst_bound_ratio=ratio,
                worst_leaf=leaf, max_leaf_rel_err=worst_rel)
        res[f"f32_gate_dh{dh}"] = rec
        if dh == 96:
            launches96 = launches
        del model, grads_k, grads_p, grads_s
        torch.cuda.empty_cache()

    # (c) train-mode dropout 0.1 (the dense path: flash forbids it), one
    # step seed, two stage splits: the same loss and gradients
    cfg = ref_config(8, dropout=0.1, use_fused_xent=True)
    g = torch.Generator().manual_seed(SEED)
    model = port.init_params(cfg, g, device)
    tokens, targets = (torch.randint(0, cfg.vocab_size, (REF_B, REF_S),
                                     generator=g).to(device)
                       for _ in range(2))
    out = {}
    for name, n_dev in (("GPipe", 2), ("1F1B", D)):
        fn = port.make_pipeline_grad_fn(
            cfg, port.ScheduleConfig(name, REF_M), n_dev, device=device)
        out[name] = one_step(model, fn, tokens, targets, 1234)
    eval_loss = one_step(model, port.make_pipeline_grad_fn(
        dataclasses.replace(cfg, dropout=0.0), sched, D, device=device),
        tokens, targets)[0]
    (l_a, g_a, _), (l_b, g_b, _) = out["GPipe"], out["1F1B"]
    rel = abs(l_b - l_a) / abs(l_a)
    ratio, leaf, worst_rel = grad_errors(g_b, g_a)
    print(f"  f32 dropout 0.1, step seed 1234: GPipe D=2 loss {l_a:.6f}, "
          f"1F1B D={D} loss {l_b:.6f} (rel err {rel:.2e}), worst leaf {leaf} "
          f"at {ratio:.3f} of its bound; eval-mode loss {eval_loss:.6f}")
    check(rel <= 1e-5, f"dropout: loss differs across splits by {rel}")
    check(ratio <= 1.0, f"dropout: leaf {leaf} over its bound ({ratio})")
    check(abs(l_a - eval_loss) > 1e-4, "dropout changed nothing")
    res["dropout"] = dict(loss_gpipe_d2=l_a, loss_1f1b_d4=l_b, loss_rel_err=rel,
                          worst_bound_ratio=ratio, worst_leaf=leaf,
                          max_leaf_rel_err=worst_rel, eval_loss=eval_loss)
    del model, g_a, g_b, out
    torch.cuda.empty_cache()

    # (d) the sweep code itself: 18 rows of the reference's sweep, their
    # run reports kept for phase 13 (b)
    t0 = time.perf_counter()
    if SWEEP_REPORTS.exists():
        import shutil
        shutil.rmtree(SWEEP_REPORTS)
    rows = sweep_rows(layers=(8,), heads=(4, 8, 12), devices=(2, 4),
                      verbose=False, device=device,
                      report_dir=str(SWEEP_REPORTS))
    check(len(rows) == 18 and all("throughput" in r for r in rows),
          f"sweep: {len(rows)} rows, not 18 timed ones")
    speedup = {(r["n_heads"], r["num_processes"], r["schedule"]): r
               for r in compute_speedup_and_efficiency(rows)}
    print(f"  sweep (f32, B={REF_B}, S={REF_S}, M={REF_M}, 5 timed steps "
          f"after 2): 18 rows in {time.perf_counter() - t0:.1f} s")
    for r in rows:
        sp = speedup.get((r["n_heads"], r["num_processes"], r["schedule"]))
        print(f"    L{r['n_layers']} H{r['n_heads']} D{r['num_processes']} "
              f"{r['schedule']:<16} {r['throughput']:10.1f} tokens/s"
              + (f"  speedup {sp['speedup']:.4f} efficiency "
                 f"{sp['efficiency']:.2f}%" if sp else "")
              + f"  bubble analytic {r['bubble_analytic']:.4f} simulated "
              f"{r['bubble_simulated']:.4f} table {r['bubble_table_exact']:.4f}"
              f"  mfu_card {r['mfu_card']:.4f}  peak "
              f"{r['max_memory_allocated_bytes'] / 2**20:.0f} MiB")
        check(math.isfinite(r["throughput"]) and r["throughput"] > 0,
              f"sweep row {r['schedule']}: throughput {r['throughput']}")
    res["sweep"] = dict(rows=rows, speedup=list(speedup.values()))

    # (e) the headline rows as the reference runs them: a world of D
    # processes a config (one world per D), beside the lockstep rows
    t0 = time.perf_counter()
    world_rows = sweep_rows(layers=(8,), heads=(8,), devices=(2,),
                            verbose=False, device=device, backend="gloo",
                            num_iterations=REF_WORLD_TIMED)
    check(len(world_rows) == 3 and all("throughput" in r
                                       for r in world_rows),
          f"world sweep: {len(world_rows)} rows, not 3 timed ones: "
          f"{[r.get('error') for r in world_rows]}")
    lock = {(r["num_processes"], r["schedule"]): r for r in rows
            if r["n_heads"] == 8}
    print(f"  the sweep as a world (gloo, staged; one world, D = 2): "
          f"3 rows in {time.perf_counter() - t0:.1f} s")
    for r in world_rows:
        twin = lock[(r["num_processes"], r["schedule"])]
        check(r["transport"] == "gloo-staged"
              and r["world_ranks"] == r["num_processes"],
              f"world row {r['schedule']}: {r['transport']}")
        for k in ("bubble_analytic", "bubble_simulated",
                  "bubble_table_exact"):
            check(r[k] == twin[k], f"world row {r['schedule']}: {k}")
        print(f"    L8 H8 D{r['num_processes']} {r['schedule']:<16} world "
              f"{r['throughput']:10.1f} tokens/s, lockstep "
              f"{twin['throughput']:10.1f} (world / lockstep "
              f"{r['throughput'] / twin['throughput']:.4f}), bubble "
              f"analytic {r['bubble_analytic']:.4f}")
    res["world_sweep"] = dict(rows=world_rows,
                              seconds=time.perf_counter() - t0)

    # where the time goes: one f32 step of the headline config (L8/H8,
    # GPipe, D = 2), as the sweep runs it
    cfg = ref_config(8)
    g = torch.Generator().manual_seed(SEED)
    model = port.init_params(cfg, g, device)
    tokens, targets = (torch.randint(0, cfg.vocab_size, (REF_B, REF_S),
                                     generator=g).to(device)
                       for _ in range(2))
    fn = port.make_pipeline_grad_fn(
        cfg, port.ScheduleConfig("GPipe", REF_M), 2, device=device)

    def step():
        model.zero_grad(set_to_none=True)
        return fn(model, tokens, targets)

    res["profile"] = dict(schedule="GPipe", D=2, **profile_step(
        "f32 ref_decoder L8 H8 GPipe D=2 step", step))
    report["ref"] = res
    return launches96


# the fit path (phase 8): tied GPT-2-small at full width through
# utils.train.fit and the training entry point; the f32 gates at B = 8
# (f32 GEMMs on the CUDA cores are slow), the bf16 timing at phase 4's
# B = 24; S = 1024, M = 4, 1F1B at D = 4
FIT_S, FIT_M, FIT_B32, FIT_B16 = 1024, 4, 8, 24
FIT_TOKENS = 4 << 20  # the seeded token file: 4 M uint16 tokens
FIT_TIMED, FIT_WARM = 10, 2
FIT_RESUME_LAYERS = 4  # (b)'s resume runs: 4 of GPT-2-small's 12 layers
FIT_MODEL_ARGS = ["--model", "gpt2-small", "--tie-embeddings"]  # fit_config's


def fit_config():
    """Tied GPT-2-small with both kernels routed on, f32."""
    from distributed_training_with_pipeline_parallelism_tpu_torch import gpt2_config
    return gpt2_config("small", tie_embeddings=True, use_flash_attention=True,
                       use_fused_xent=True)




def zipf_tokens(n, vocab, seed):
    """``n`` token ids drawn with probability 1/rank over the vocabulary
    (a learnable unigram, so a short run's loss falls; uniform tokens sit
    at ln V from the first step)."""
    import numpy as np
    p = 1.0 / np.arange(1, vocab + 1)
    return np.random.default_rng(seed).choice(vocab, size=n, p=p / p.sum())


@contextlib.contextmanager
def patched(obj, name, wrap):
    """``obj.name`` replaced by ``wrap(original)`` inside the block."""
    real = getattr(obj, name)
    setattr(obj, name, wrap(real))
    try:
        yield
    finally:
        setattr(obj, name, real)


class SyncCounter:
    """The synchronising calls CUDA's sync debug mode reports inside each
    call of a train step (:meth:`make` wraps ``make_train_step``) and each
    batch fetch (:meth:`data` wraps the iterator), while :meth:`watch` is
    open."""

    def __init__(self):
        self.in_step, self.in_data, self.caught = [], [], []

    def since(self, k: int) -> int:
        return sum("synchroniz" in str(w.message) for w in self.caught[k:])

    def make(self, make):
        def make_counted(*a, **kw):
            step = make(*a, **kw)

            def counted(*sa, **skw):
                k = len(self.caught)
                out = step(*sa, **skw)
                self.in_step.append(self.since(k))
                return out
            return counted
        return make_counted

    def data(self, it):
        while True:
            k = len(self.caught)
            try:
                batch = next(it)
            except StopIteration:
                return
            finally:
                self.in_data.append(self.since(k))
            yield batch

    @contextlib.contextmanager
    def watch(self):
        import warnings
        import torch
        with warnings.catch_warnings(record=True) as caught:
            self.caught = caught
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                yield self
            finally:
                torch.cuda.set_sync_debug_mode(0)


def same_state(a, b, what):
    """Two restored checkpoints hold bitwise equal model tensors, Adam
    moments and step counts; the number of tensors compared."""
    import torch
    n = 0
    for name, t in a["model"].items():
        check(torch.equal(b["model"][name], t), f"{what}: {name} differs")
        n += 1
    for k, st in a["optimizer"]["state"].items():
        for key in ("step", "exp_avg", "exp_avg_sq"):
            check(torch.equal(b["optimizer"]["state"][k][key], st[key]),
                  f"{what}: optimizer state {k}.{key} differs")
            n += 1
    return n


def trace_summary(path):
    """Device busy time, the window's span and the idle share from a
    ``torch.profiler`` Chrome trace, and which of the port's kernels it
    holds."""
    events = [e for e in json.loads(Path(path).read_text())["traceEvents"]
              if "ts" in e and "dur" in e]
    kern = [e for e in events if e.get("cat") == "kernel"]
    span = (max(float(e["ts"]) + float(e["dur"]) for e in events)
            - min(float(e["ts"]) for e in events)) / 1e3
    busy = sum(float(e["dur"]) for e in kern) / 1e3
    names = {n for n in ("flash_fwd", "flash_bwd", "xent_fwd", "xent_bwd")
             if any(n in e.get("name", "") for e in kern)}
    return dict(span_ms=span, device_busy_ms=busy,
                idle_share=1 - busy / span if span else None,
                n_kernels=len(kern), port_kernels=sorted(names),
                trace_bytes=Path(path).stat().st_size)


def fit_report(out, tel):
    """Phase 8's run report: ``report.json`` valid, ``events.jsonl``
    written, the live watermarks available with a peak no lower than any
    sampled ``bytes_in_use``, and the cost model's measured step and
    attribution present. Returns its figures."""
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils import (
        telemetry as tm)
    manifest = json.loads((out / "report.json").read_text())
    tm.validate_report(manifest)
    check((out / "events.jsonl").exists(), "fit wrote no events.jsonl")
    live = manifest["memory"].get("live", {})
    sampled = max((s["bytes_in_use"] for s in tel.memory_samples), default=0)
    check(live.get("available") is True and live["peak_bytes_in_use"]
          >= sampled > 0, f"live watermarks {live} (sampled {sampled})")
    cm = manifest["cost_model"]
    check("step_s" in cm.get("measured", {}) and "attribution" in cm,
          f"cost model without its measured part: {sorted(cm)}")
    att = cm["attribution"]
    rec = dict(compile_s=manifest["timers"]["compile_s"],
               steps=manifest["counters"]["steps"],
               measured_step_s=cm["measured"]["step_s"],
               predicted_step_s=cm["predicted"]["step_s"],
               mfu=cm["measured"]["mfu"],
               bubble_measured_mean=cm["measured"]["bubble_measured_mean"],
               attribution={k: att[k] for k in (
                   "compute_s", "comm_s", "bubble_s", "straggler_device")},
               live_peak_bytes=live.get("peak_bytes_in_use") or 0,
               n_events=manifest["n_events"],
               calibration=calibrated_record(manifest))
    print(f"  (b) fit's run report: valid, {rec['n_events']} events, "
          f"compile_s {rec['compile_s']:.2f} s, the last step's stamps "
          f"{rec['measured_step_s'] * 1e3:.1f} ms (predicted "
          f"{rec['predicted_step_s'] * 1e3:.1f} ms, MFU {rec['mfu']:.4f}, "
          f"measured bubble {rec['bubble_measured_mean']:.3f}), critical "
          f"path compute {att['compute_s'] * 1e3:.1f} / comm "
          f"{att['comm_s'] * 1e3:.1f} / bubble {att['bubble_s'] * 1e3:.1f} "
          f"ms, live peak {rec['live_peak_bytes'] / 2 ** 30:.2f} GiB")
    return rec


def calibrated_record(manifest):
    """A run report's cost model and calibration parts for phase 13 (b):
    the raw and corrected predicted step, the measured one, both errors,
    the correction and the calibration section (None where missing; the
    phase checks them)."""
    cm = manifest.get("cost_model") or {}
    pred, meas = cm.get("predicted") or {}, cm.get("measured") or {}
    corr = pred.get("corrected") or {}
    return dict(
        name=manifest["meta"].get("name"), predicted_step_s=pred.get("step_s"),
        compute_s=pred.get("compute_s"), comm_s=pred.get("comm_s"),
        corrected=corr or None, measured_step_s=meas.get("step_s"),
        rel_err=meas.get("rel_err"),
        rel_err_corrected=meas.get("rel_err_corrected"),
        calibration=manifest.get("calibration"))


def phase_fit(report, device="cuda"):
    """``fit`` and the training entry point (see the module doc); returns
    the kernel launches of one fit step, of one eval and of the entry
    point's whole run."""
    import os
    import shutil
    import tempfile
    import torch
    import distributed_training_with_pipeline_parallelism_tpu_torch as port
    from distributed_training_with_pipeline_parallelism_tpu_torch import (
        train as entry)
    from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
        Transformer, transformer_loss)
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel.pipeline import (
        _fwd_tick_table)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils import (
        resilience, telemetry as tm, train as ttrain)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils.checkpoint import (
        is_committed, restore_checkpoint)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils.data import (
        TokenFileDataset, prefetch_to_device, write_token_file)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils.data_native import (
        NativeTokenLoader, load_library)
    kernels = all_kernels()
    cfg = fit_config()
    sched = port.ScheduleConfig("1F1B", FIT_M)
    lps = cfg.n_layers // D
    res = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_fit_"))
    t_phase = time.perf_counter()
    try:
        # (a) data: a seeded token file, both loaders, the prefetch
        t0 = time.perf_counter()
        path = str(tmp / "tokens.bin")
        write_token_file(path, zipf_tokens(FIT_TOKENS, cfg.vocab_size, SEED))
        check(os.path.getsize(path) == 2 * FIT_TOKENS, "token file size")
        t = time.perf_counter()
        load_library()
        build_s = time.perf_counter() - t
        fx, fy = TokenFileDataset(path, FIT_S, seed=SEED).sample(FIT_B32)
        with NativeTokenLoader(path, FIT_S, FIT_B32, seed=SEED,
                               n_threads=1) as a, \
                NativeTokenLoader(path, FIT_S, FIT_B32, seed=SEED,
                                  n_threads=1) as b:
            nx, ny = a.next()
            px, py = next(prefetch_to_device(b.batches(), depth=2,
                                             device=device))
        for name, (x, y) in (("TokenFileDataset", (fx, fy)),
                             ("NativeTokenLoader", (nx, ny))):
            check(x.shape == y.shape == (FIT_B32, FIT_S)
                  and (x[:, 1:] == y[:, :-1]).all()
                  and 0 <= x.min() and x.max() < cfg.vocab_size,
                  f"{name}: a batch is not a shifted crop of the file")
        check(px.device.type == torch.device(device).type
              and torch.equal(px.cpu(), torch.from_numpy(nx))
              and torch.equal(py.cpu(), torch.from_numpy(ny)),
              "prefetch_to_device changed the native loader's batch")
        res["data"] = dict(tokens=FIT_TOKENS, native_build_s=build_s,
                           seconds=time.perf_counter() - t0)
        print(f"  (a) data: {FIT_TOKENS} tokens, native loader built in "
              f"{build_s:.1f} s, both loaders and the prefetch agree")

        def seeded_state(c):
            g = torch.Generator().manual_seed(SEED)
            return {k: v.detach().clone() for k, v in
                    port.init_params(c, g, device).state_dict().items()}

        init_state = seeded_state(cfg)
        # (b)'s five resume runs: 4 of the 12 layers at full width
        cfg_b = dataclasses.replace(cfg, n_layers=FIT_RESUME_LAYERS)
        init_b = seeded_state(cfg_b)

        def fresh(c=cfg, state=None):
            model = Transformer(c, device=device)
            model.load_state_dict(init_state if state is None else state)
            return model

        def run_fit(n_steps, ckpt=None, metrics=None, batch=FIT_B32,
                    data=None, c=cfg, **kw):
            if data is None:
                data = prefetch_to_device(TokenFileDataset(
                    path, FIT_S, seed=SEED).batches(batch), 2, device)
            model = fresh(c, init_b if c is cfg_b else None)
            ttrain.fit(c, sched, D, model, data, n_steps,
                       optimizer=port.adamw(warmup_steps=2, total_steps=20),
                       log_every=kw.pop("log_every", 1), verbose=False,
                       checkpoint_dir=None if ckpt is None else str(ckpt),
                       checkpoint_every=2 if ckpt is not None else 0,
                       metrics_path=None if metrics is None else str(metrics),
                       keep_last=2, device=device, **kw)
            return model

        def losses(metrics):
            return [(x["step"], x["loss"]) for x in
                    map(json.loads, Path(metrics).read_text().splitlines())
                    if "loss" in x]

        # (b) the f32 resume gate at 4 of the 12 layers: unbroken (with a
        # run report and its stamps), killed in a save, preempted
        t0 = time.perf_counter()
        tel = tm.PipelineTelemetry()
        run_fit(6, tmp / "ck_unbroken", tmp / "m_unbroken.jsonl",
                report_dir=str(tmp / "report"), telemetry=tel, c=cfg_b)
        want = restore_checkpoint(str(tmp / "ck_unbroken" / "step_5"))
        want_losses = dict(losses(tmp / "m_unbroken.jsonl"))
        res["report"] = fit_report(tmp / "report", tel)
        shutil.rmtree(tmp / "ck_unbroken")
        check(sorted(want_losses) == list(range(6)) and all(
            math.isfinite(x) for x in want_losses.values()),
            f"unbroken run: losses {want_losses}")
        resume = {}
        for fault in ("kill_in_save_step", "preempt_at_step"):
            ck, m = tmp / f"ck_{fault}", tmp / f"m_{fault}.jsonl"
            plan = resilience.FaultPlan(**{fault: 3})
            try:
                run_fit(6, ck, m, fault_plan=plan, c=cfg_b)
                killed = False
            except resilience.SimulatedKill:
                killed = True
            check(killed == (fault == "kill_in_save_step"),
                  f"{fault}: SimulatedKill raised: {killed}")
            shell = str(ck / "step_3")
            check(os.path.exists(os.path.join(shell, "state.pt"))
                  and is_committed(shell) == (not killed),
                  f"{fault}: step_3 committed {is_committed(shell)}")
            first = len(losses(m))
            run_fit(6, ck, m, resume=True, c=cfg_b)
            got_losses = losses(m)
            resumed_at = got_losses[first][0]
            check(resumed_at == (2 if killed else 4),
                  f"{fault}: resumed at step {resumed_at}")
            n = same_state(want, restore_checkpoint(str(ck / "step_5")),
                           fault)
            check(all(x == want_losses[s] for s, x in got_losses),
                  f"{fault}: losses {got_losses} != {want_losses}")
            shutil.rmtree(ck)
            resume[fault] = dict(resumed_at=resumed_at, tensors_equal=n,
                                 losses=got_losses)
            print(f"  (b) f32 {fault}=3 ({FIT_RESUME_LAYERS} layers): "
                  f"resumed at step {resumed_at}, {n} tensors and "
                  f"{len(got_losses)} losses bitwise equal to the unbroken "
                  f"run")
        res["resume"] = dict(resume, unbroken_losses=want_losses,
                             seconds=time.perf_counter() - t0)
        del want

        # (c) the guard gate: a poisoned stage, the budget, no sync
        t0 = time.perf_counter()
        guard_plan = resilience.FaultPlan(nan_grad_steps=(2,),
                                          nan_grad_stage=1)
        run_fit(3, tmp / "ck_guard", guard=resilience.AnomalyGuard(),
                fault_plan=guard_plan)
        s1 = restore_checkpoint(str(tmp / "ck_guard" / "step_1"))
        s2 = restore_checkpoint(str(tmp / "ck_guard" / "step_2"))
        n = same_state(s1, s2, "guard: after the skipped step 2")
        counters = {k: int(v) for k, v in s2["guard"].items()}
        check(counters == {"step": 3, "consec": 1, "total": 1,
                           "last_anomaly_step": 2, "last_bad_stage": 1},
              f"guard counters {counters}")
        count = float(next(iter(s2["optimizer"]["state"].values()))["step"])
        check(count == 2.0, f"the optimizer's count moved to {count}")
        ck = tmp / "ck_budget"
        try:
            run_fit(6, ck, guard=resilience.AnomalyGuard(max_consecutive=3),
                    fault_plan=resilience.FaultPlan(nan_grad_steps=(2, 3, 4)))
            raised = False
        except resilience.AnomalyBudgetExceeded:
            raised = True
        check(raised and is_committed(str(ck / "step_4")),
              f"budget: raised {raised}, step_4 committed")
        same_state(s1, restore_checkpoint(str(ck / "step_4")),
                   "budget: the committed last good state")
        shutil.rmtree(ck)
        shutil.rmtree(tmp / "ck_guard")
        del s1, s2

        # no synchronising call inside the steps or the data between the
        # log points (steps 0 and 5 log): guard and prefetch on
        probe = SyncCounter()
        data = probe.data(prefetch_to_device(TokenFileDataset(
            path, FIT_S, seed=SEED).batches(FIT_B32), 2, device))
        with patched(ttrain, "make_train_step", probe.make), probe.watch():
            run_fit(6, data=data, log_every=5,
                    guard=resilience.AnomalyGuard(), fault_plan=guard_plan)
        in_step, in_data = probe.in_step, probe.in_data
        n_sync = probe.since(0)
        res["guard"] = dict(counters=counters, tensors_equal=n,
                            sync_debug=dict(in_step=in_step, in_data=in_data,
                                            warnings=n_sync),
                            seconds=time.perf_counter() - t0)
        print(f"  (c) f32 guard: step 2 skipped in stage 1 ({n} tensors "
              f"bitwise as after step 1, count 2), counters {counters}; "
              f"budget of 3 raised after committing step 4; sync debug: "
              f"{in_step} in the steps, {in_data} in the data, {n_sync} in "
              f"all (the log points' reads)")
        check(sum(in_step[1:5]) == 0 and sum(in_data[1:5]) == 0,
              f"a synchronising call between log points: steps {in_step}, "
              f"data {in_data}")

        # (d) grad_accum against the concatenated batch; the eval loss
        t0 = time.perf_counter()
        x, y = (torch.from_numpy(v).to(device) for v in TokenFileDataset(
            path, FIT_S, seed=SEED + 1).sample(FIT_B32))
        opt = port.adamw(warmup_steps=0, total_steps=10)
        big = fresh()
        big_state = opt.init(big)
        step_big = ttrain.make_train_step(cfg, sched, D, opt, device=device)
        loss_big = step_big(big, big_state, x, y).item()
        grads_big = {n: p.grad.clone() for n, p in big.named_parameters()}
        acc = fresh()
        multi = ttrain.MultiSteps(opt, 2)
        acc_state = multi.init(acc)
        step_acc = ttrain.make_train_step(cfg, sched, D, multi,
                                          device=device)
        half = FIT_B32 // 2
        l0 = step_acc(acc, acc_state, x[:half], y[:half]).item()
        l1 = step_acc(acc, acc_state, x[half:], y[half:]).item()
        grads_acc = {n: p.grad for n, p in acc.named_parameters()}
        rel = abs((l0 + l1) / 2 - loss_big) / abs(loss_big)
        ratio, leaf, worst_rel = grad_errors(grads_acc, grads_big)
        # Adam's first update is about lr * sign(g), so an element whose
        # gradient sits at the rounding noise may move either way: the
        # parameters are held to Adam's per-element step bound
        step_gap = max((p.detach() - big.get_parameter(n).detach()).abs()
                       .max().item() for n, p in acc.named_parameters())
        count_acc = acc_state.inner.count.item()
        print(f"  (d) f32 grad_accum=2 on 2 x {half} vs one step on "
              f"{FIT_B32}: mean loss rel err {rel:.2e}, the consumed "
              f"gradients' worst leaf {leaf} at {ratio:.3f} of its bound, "
              f"largest parameter gap {step_gap:.2e} (lr "
              f"{opt.learning_rate}), updates {count_acc}")
        check(rel <= 1e-5, f"grad_accum loss: rel err {rel}")
        check(ratio <= 1.0, f"grad_accum grads: leaf {leaf} at {ratio}")
        check(step_gap <= 2 * opt.learning_rate and count_acc == 1.0,
              f"grad_accum parameters: gap {step_gap}, count {count_acc}")
        del acc, acc_state, grads_acc, grads_big
        eval_fn = ttrain.make_eval_fn(cfg, sched, D, device=device)
        eval_fn(big, x, y)  # warm-up
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        loss_eval = eval_fn(big, x, y).item()
        eval_s = time.perf_counter() - t
        eval_peak = torch.cuda.max_memory_allocated() - base
        eval_launches = {k.name: k.launches for k in kernels}
        table, _ = _fwd_tick_table(D, 1, FIT_M)
        units = int((table[..., 2] >= 0).sum())
        eval_want = {"flash_fwd": units * lps, "flash_bwd": 0,
                     "xent_fwd": FIT_M, "xent_bwd": 0}
        with torch.no_grad():
            single = transformer_loss(cfg, big, x, y).item()
        rel_eval = abs(loss_eval - single) / abs(single)
        big.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        step_big(big, big_state, x, y)
        torch.cuda.synchronize()
        train_peak = torch.cuda.max_memory_allocated() - base
        print(f"  (d) f32 eval (forward-only, {units} stage units): loss "
              f"{loss_eval:.6f} vs single device {single:.6f} (rel err "
              f"{rel_eval:.2e}), {eval_s * 1e3:.1f} ms, launches "
              f"{eval_launches} (table predicts {eval_want}), peak above "
              f"the resting state {eval_peak / 2**20:.0f} MiB vs a "
              f"training step's {train_peak / 2**20:.0f} MiB")
        check(rel_eval <= 1e-5, f"eval loss: rel err {rel_eval}")
        check(eval_launches == eval_want,
              f"eval launches {eval_launches} != {eval_want}")
        res["grad_accum_eval"] = dict(
            loss_rel_err=rel, grads_worst_bound_ratio=ratio, worst_leaf=leaf,
            max_leaf_rel_err=worst_rel, param_gap=step_gap,
            eval_loss=loss_eval, single_device_loss=single,
            eval_rel_err=rel_eval, eval_ms=eval_s * 1e3,
            eval_launches=eval_launches, eval_peak_bytes=eval_peak,
            train_step_peak_bytes=train_peak,
            seconds=time.perf_counter() - t0)
        del big, big_state, init_state, init_b
        torch.cuda.empty_cache()

        # (e) bf16 through the entry point: timing, eval, saves, profile
        t0 = time.perf_counter()
        n_steps = FIT_WARM + FIT_TIMED
        base_argv = FIT_MODEL_ARGS + [
            "--pipe", str(D), "--schedule", "1F1B", "--microbatches",
            str(FIT_M), "--batch", str(FIT_B16), "--seq", str(FIT_S),
            "--flash", "on", "--fused-xent", "--dtype", "bfloat16",
            "--param-dtype", "float32", "--lr", "6e-4", "--warmup-steps",
            "2", "--native-loader", "--data-file", path, "--seed", str(SEED),
            "--device", device]
        metrics = tmp / "m_bf16.jsonl"
        step_rows, evals, saves = [], [], []

        def timed_make(make):
            def make_timed(*a, **kw):
                step = make(*a, **kw)

                def timed(*sa, **skw):
                    n0 = {k.name: k.launches for k in kernels}
                    out = step(*sa, **skw)
                    step_rows.append({k.name: k.launches - n0[k.name]
                                      for k in kernels})
                    return out
                return timed
            return make_timed

        def timed_evaluate(evaluate):
            def timed(*a, **kw):
                torch.cuda.synchronize()
                n0 = {k.name: k.launches for k in kernels}
                t = time.perf_counter()
                out = evaluate(*a, **kw)
                torch.cuda.synchronize()
                evals.append(dict(ms=(time.perf_counter() - t) * 1e3,
                                  launches={k.name: k.launches - n0[k.name]
                                            for k in kernels}, **out))
                return out
            return timed

        def timed_save(save):
            def timed(self, step, state, wait=True):
                t = time.perf_counter()
                out = save(self, step, state, wait=wait)
                saves.append(dict(step=step, wait=wait,
                                  ms=(time.perf_counter() - t) * 1e3))
                return out
            return timed

        for k in kernels:
            k.launches = 0
        with patched(ttrain, "make_train_step", timed_make), \
                patched(ttrain, "evaluate", timed_evaluate), \
                patched(resilience.CheckpointManager, "save", timed_save):
            entry.main(base_argv + [
                "--steps", str(n_steps), "--metrics", str(metrics),
                "--eval-every", "5", "--ckpt", str(tmp / "ck_bf16"),
                "--ckpt-every", "5", "--prefetch", "2"])
        main_launches = {k.name: k.launches for k in kernels}
        check(all(main_launches.values()),
              f"the entry point's run launched {main_launches}")
        lines = [json.loads(x) for x in metrics.read_text().splitlines()]
        train_lines = [x for x in lines if "loss" in x]
        fit_losses = [x["loss"] for x in train_lines]
        timed = [x for x in train_lines if x["step"] >= FIT_WARM]
        toks = FIT_B16 * FIT_S
        fit_tps = toks * len(timed) / sum(x["elapsed_s"] for x in timed)
        phase4 = report.get("train", {}).get("bf16", {}).get("1F1B", {})
        step_launches = step_rows[FIT_WARM]
        step_want = {"flash_fwd": 2 * FIT_M * cfg.n_layers,
                     "flash_bwd": FIT_M * cfg.n_layers,
                     "xent_fwd": FIT_M, "xent_bwd": FIT_M}
        eval_batches = evals[0]["num_batches"]
        one_eval = {k: v * eval_batches for k, v in eval_want.items()}
        async_saves = [s["ms"] for s in saves if not s["wait"]]
        print(f"  (e) bf16 B={FIT_B16} through train.main: {len(timed)} "
              f"timed steps at {fit_tps:.1f} tokens/s (per step "
              f"{[round(x['tokens_per_sec'], 1) for x in timed]}); phase 4's "
              f"make_train_step 1F1B in this call: "
              f"{phase4.get('tokens_per_s', float('nan')):.1f} tokens/s; "
              f"losses {[round(x, 4) for x in fit_losses]}")
        print(f"      one eval ({eval_batches} batches): "
              f"{[round(e['ms'], 1) for e in evals]} ms; async saves block "
              f"the loop {[round(x, 1) for x in async_saves]} ms, the final "
              f"synchronous save {[round(s['ms'], 1) for s in saves if s['wait']]} "
              f"ms; a step launches {step_launches}, an eval "
              f"{evals[0]['launches']}")
        check(all(math.isfinite(x) for x in fit_losses)
              and fit_losses[-1] < fit_losses[0],
              f"fit losses {fit_losses}")
        check(step_launches == step_want,
              f"fit step launches {step_launches} != {step_want}")
        check(evals[0]["launches"] == one_eval,
              f"eval launches {evals[0]['launches']} != {one_eval}")
        check(len(async_saves) == 2, f"saves {saves}")
        profiles = {}
        for depth in (2, 0):
            prof = tmp / f"prof_{depth}"
            entry.main(base_argv + ["--steps", "6", "--prefetch", str(depth),
                                    "--profile", str(prof)])
            profiles[depth] = trace_summary(prof / "trace.json")
            p = profiles[depth]
            print(f"      profiled steps 2-4, prefetch {depth}: span "
                  f"{p['span_ms']:.1f} ms, device busy "
                  f"{p['device_busy_ms']:.1f} ms, idle share "
                  f"{p['idle_share']:.3f}, kernels {p['port_kernels']}")
            check(p["port_kernels"] == ["flash_bwd", "flash_fwd", "xent_bwd",
                                        "xent_fwd"],
                  f"the trace holds {p['port_kernels']}")
        res["bf16"] = dict(
            tokens_per_s=fit_tps, per_step=timed, losses=fit_losses,
            phase4_tokens_per_s=phase4.get("tokens_per_s"),
            evals=evals, saves=saves, step_launches=step_launches,
            main_launches=main_launches, profiles=profiles,
            seconds=time.perf_counter() - t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t_phase
    print(f"  phase 8: {res['seconds']:.1f} s")
    report["fit"] = res
    return step_launches, evals[0]["launches"], main_launches


# zero-bubble training (phase 9): the gates' batch (f32 GEMMs run on the
# CUDA cores, so the gates take B = 8), the timing batch, and the two
# split-backward schedules beside the full-backward schedules they are
# timed against, each as (name, D, V)
ZB_GATE_B, ZB_TIME_B, ZB_M = 8, 24, 4
ZB_PAIRS = ((("1F1B", 4, 1), ("ZBH1", 4, 1)),
            (("Interleaved1F1B", 2, 2), ("ZBV", 2, 2)))


def zb_launches(n_layers, D, V, M):
    """Kernel launches of one split-backward step: S·M F units, (S-1)·M B
    units (stage 0 has none) and S·M W units; B and W each recompute the
    stage forward and run one backward, and only the last stage's B and W
    take the head's cross entropy."""
    S = D * V
    lps = n_layers // S
    return {"flash_fwd": lps * (3 * S - 1) * M,
            "flash_bwd": lps * (2 * S - 1) * M,
            "xent_fwd": 2 * M, "xent_bwd": 2 * M}


def phase_zero_bubble(report, device="cuda"):
    """Zero-bubble training, ZBH1 and ZBV (see the module doc); returns
    the kernel launches of the counted bf16 ZBH1 and ZBV steps."""
    import torch
    import distributed_training_with_pipeline_parallelism_tpu_torch as port
    from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
        transformer_loss)
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel.schedules import (
        analytic_bubble_fraction, paper_bubble_fraction)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils.sweep import (
        run_one_experiment)
    kernels = all_kernels()
    cfg = port.gpt2_config("small", tie_embeddings=True,
                           use_flash_attention=True, use_fused_xent=True)
    plain = dataclasses.replace(cfg, use_flash_attention=False,
                                use_fused_xent=False)
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16", param_dtype="float32")
    plain16 = dataclasses.replace(plain, dtype="bfloat16",
                                  param_dtype="float32")
    g = torch.Generator().manual_seed(SEED)
    model = port.init_params(cfg, g, device)
    init_state = {n: p.detach().clone() for n, p in model.state_dict().items()}
    tokens = torch.randint(0, cfg.vocab_size, (ZB_TIME_B, TRAIN_S),
                           generator=g).to(device)
    targets = torch.randint(0, cfg.vocab_size, (ZB_TIME_B, TRAIN_S),
                            generator=g).to(device)
    gate_tok, gate_tgt = tokens[:ZB_GATE_B], targets[:ZB_GATE_B]
    zb = [pair[1] for pair in ZB_PAIRS]
    res = dict(gate_batch=ZB_GATE_B, time_batch=ZB_TIME_B, M=ZB_M)

    def one_step(fn):
        model.zero_grad(set_to_none=True)
        t = time.perf_counter()
        loss = fn(model, gate_tok, gate_tgt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        return loss.item(), {n: p.grad.clone()
                             for n, p in model.named_parameters()}, wall

    def counted(fn):
        """One warm-up step, then a step with the counts set to 0 just
        before it and read just after."""
        one_step(fn)
        for k in kernels:
            k.launches = 0
        loss, grads, wall = one_step(fn)
        return loss, grads, wall, {k.name: k.launches for k in kernels}

    def single_device(m, t, y):
        loss = transformer_loss(cfg, m, t, y)
        loss.backward()
        return loss.detach()

    # (a) the f32 gate: each split schedule through both kernels against
    # the same step on the plain versions and single-device autograd
    loss_s, grads_s, _ = one_step(single_device)
    for name, n_dev, V in zb:
        sched = port.ScheduleConfig(name, ZB_M, V)
        want = zb_launches(cfg.n_layers, n_dev, V, ZB_M)
        loss_k, grads_k, wall_k, launches = counted(
            port.make_pipeline_grad_fn(cfg, sched, n_dev, device=device))
        print(f"  f32 {name} D={n_dev} V={V} step (kernels), B={ZB_GATE_B}: "
              f"loss {loss_k:.6f}, {wall_k:.2f} s, launches {launches} "
              f"(tables predict {want})")
        check(launches == want, f"{name}: kernel launches {launches} != "
              f"{want}")
        loss_p, grads_p, _ = one_step(
            port.make_pipeline_grad_fn(plain, sched, n_dev, device=device))
        check(all(k.launches == launches[k.name] for k in kernels),
              f"{name}: the plain run launched a kernel")
        rec = dict(D=n_dev, V=V, loss=loss_k, step_s=wall_k,
                   launches=launches, launches_predicted=want)
        for what, l_ref, g_ref in (("plain run", loss_p, grads_p),
                                   ("single device", loss_s, grads_s)):
            rel = abs(loss_k - l_ref) / abs(l_ref)
            ratio, leaf, worst_rel = grad_errors(grads_k, g_ref)
            print(f"  f32 {name} vs {what}: loss {l_ref:.6f} (rel err "
                  f"{rel:.2e}), worst leaf {leaf} at {ratio:.3f} of its "
                  f"bound, max leaf rel err {worst_rel:.2e}")
            check(rel <= 1e-5, f"{name} loss vs {what}: rel err {rel} > 1e-5")
            check(ratio <= 1.0, f"{name} grads vs {what}: leaf {leaf} over "
                  f"its bound ({ratio})")
            rec[f"vs_{what.replace(' ', '_')}"] = dict(
                loss=l_ref, loss_rel_err=rel, worst_bound_ratio=ratio,
                worst_leaf=leaf, max_leaf_rel_err=worst_rel)
        res[f"f32_{name}"] = rec
        del grads_k, grads_p
    del grads_s

    # (b) the bf16 gate against the plain versions in bf16 (phase 4's
    # bounds); these counted steps give the kernel line's launches
    step_launches = {}
    for name, n_dev, V in zb:
        sched = port.ScheduleConfig(name, ZB_M, V)
        want = zb_launches(cfg.n_layers, n_dev, V, ZB_M)
        loss_k, grads_k, wall_k, launches = counted(
            port.make_pipeline_grad_fn(cfg16, sched, n_dev, device=device))
        check(launches == want, f"bf16 {name}: kernel launches {launches} "
              f"!= {want}")
        loss_p, grads_p, _ = one_step(
            port.make_pipeline_grad_fn(plain16, sched, n_dev, device=device))
        check(all(k.launches == launches[k.name] for k in kernels),
              f"bf16 {name}: the plain run launched a kernel")
        rel = abs(loss_k - loss_p) / abs(loss_p)
        ratio, leaf, worst_rel = grad_errors(grads_k, grads_p, rtol=5e-2,
                                             atol=1e-3)
        print(f"  bf16 {name} D={n_dev} step (kernels) vs plain bf16: loss "
              f"{loss_k:.6f} vs {loss_p:.6f} (rel err {rel:.2e}), worst leaf "
              f"{leaf} at {ratio:.3f} of its bound, launches {launches}")
        check(rel <= 1e-2, f"bf16 {name} loss vs plain: rel err {rel} > 1e-2")
        check(ratio <= 1.0, f"bf16 {name} grads vs plain: leaf {leaf} over "
              f"its bound ({ratio})")
        res[f"bf16_gate_{name}"] = dict(
            loss=loss_k, loss_plain=loss_p, loss_rel_err=rel,
            worst_bound_ratio=ratio, worst_leaf=leaf,
            max_leaf_rel_err=worst_rel, launches=launches, step_s=wall_k)
        step_launches[name] = launches
        del grads_k, grads_p
    model.zero_grad(set_to_none=True)

    # (c) bf16 over f32 master weights, make_train_step + adamw, B = 24:
    # each zero-bubble schedule beside its full-backward peer in turns
    # (peer, zb, zb, peer), from the same initial weights
    def timed(name, n_dev, V):
        model.load_state_dict(init_state)
        opt = port.adamw(warmup_steps=2, total_steps=100)
        opt_state = opt.init(model)
        step = port.make_train_step(cfg16, port.ScheduleConfig(
            name, ZB_M, V), n_dev, opt, device=device)
        losses = []

        def run(m, t, y):
            loss = step(m, opt_state, t, y)
            losses.append(loss)
            return loss

        metrics = port.run_train_iterations(run, model, tokens, targets,
                                            num_iterations=5,
                                            warmup_iterations=2)
        losses = [x.item() for x in losses]
        check(all(math.isfinite(x) for x in losses), f"{name}: non-finite "
              f"loss")
        check(losses[-1] < losses[0], f"{name}: the loss did not fall on "
              f"the repeated batch ({losses})")
        return metrics["throughput"], metrics["elapsed_time"] / 5, losses

    runs = {}
    for peer, zb_run in ZB_PAIRS:
        for name, n_dev, V in (peer, zb_run, zb_run, peer):
            tps, step_s, losses = timed(name, n_dev, V)
            r = runs.setdefault(name, dict(
                D=n_dev, V=V, tokens_per_s=[], step_s=[], losses=[],
                bubble_analytic=analytic_bubble_fraction(name, n_dev, V,
                                                         ZB_M),
                bubble_paper=paper_bubble_fraction(name, n_dev, V, ZB_M)))
            r["tokens_per_s"].append(tps)
            r["step_s"].append(step_s)
            r["losses"].append(losses)
            print(f"  bf16 {name} D={n_dev} V={V}: {tps:.1f} tokens/s "
                  f"({step_s * 1e3:.1f} ms/step), bubble analytic "
                  f"{r['bubble_analytic']:.4f} / paper "
                  f"{r['bubble_paper']:.4f}, losses "
                  f"{[round(x, 4) for x in losses]}")
        zname, pname = zb_run[0], peer[0]
        ratio = (sum(runs[zname]["tokens_per_s"])
                 / sum(runs[pname]["tokens_per_s"]))
        runs[zname]["ratio_to"] = {pname: ratio}
        print(f"  bf16 {zname} / {pname} tokens/s: {ratio:.4f}")
    res["bf16"] = runs

    # (d) where a ZBH1 step's time goes
    model.load_state_dict(init_state)
    opt = port.adamw(warmup_steps=2, total_steps=100)
    opt_state = opt.init(model)
    step = port.make_train_step(cfg16, port.ScheduleConfig("ZBH1", ZB_M), 4,
                                opt, device=device)
    res["profile"] = dict(schedule="ZBH1", D=4, **profile_step(
        "bf16 ZBH1 step", lambda: step(model, opt_state, tokens, targets)))
    del model, opt_state
    torch.cuda.empty_cache()

    # (e) the sweep's row for each at the headline L8/H8, D = 2
    rows = {}
    for name in ("ZBH1", "ZBV"):
        row = run_one_experiment(8, 8, 2, name, device=device)
        check("error" not in row and "skip_reason" not in row,
              f"sweep row {name}: {row}")
        check(math.isfinite(row["throughput"]) and row["throughput"] > 0,
              f"sweep row {name}: throughput {row['throughput']}")
        rows[name] = {k: row[k] for k in (
            "throughput", "n_virtual", "n_microbatches", "bubble_analytic",
            "bubble_simulated", "bubble_sim_w_b", "bubble_table_exact",
            "predicted_step_s", "backward_policy", "mfu_card",
            "max_memory_allocated_bytes")}
        print(f"  sweep row L8/H8 D=2 {name}: {row['throughput']:.1f} "
              f"tokens/s, M={row['n_microbatches']}, V={row['n_virtual']}, "
              f"bubble analytic {row['bubble_analytic']:.4f} / simulated "
              f"{row['bubble_simulated']:.4f} (w_b "
              f"{row['bubble_sim_w_b']}), policy {row['backward_policy']}")
    res["sweep_rows"] = rows
    report["zero_bubble"] = res
    return step_launches


# the world: 4 processes on the one card over gloo (staged through pinned
# host memory), tied GPT-2-small at full width; the f32 gates at B = 8 as
# (schedule, D, V, n_data), the bf16 timing at B = 24 over D = 4
DIST_GATES = (("1F1B", 4, 1, 1), ("1F1B", 2, 1, 2),
              ("Interleaved1F1B", 2, 2, 2))
DIST_M, DIST_GATE_B, DIST_TIME_B = 4, 8, 24
DIST_WARMUP, DIST_TIMED = 1, 3
# (b): two AdamW updates that both move (no warm-up of the learning rate),
# each clipped (the gradient's norm at these weights is far above 0.1)
DIST_OPT = dict(warmup_steps=0, max_grad_norm=0.1)
DIST_STEPS = 2
# (d): train.py's world, GPT-2-small tied at full width and 4 of its 12
# layers (cut for the script's time limit), S = 1024, ZeRO-1
DIST_TRAIN_ARGS = ["--model", "gpt2-small", "--tie-embeddings", "--layers",
                   "4", "--pipe", "2", "--data", "2", "--backend", "gloo",
                   "--zero1",
                   "--batch", "8", "--seq", "1024", "--microbatches", "2",
                   "--steps", "6", "--ckpt-every", "3", "--eval-every", "3",
                   "--eval-batches", "1", "--flash", "on", "--fused-xent",
                   "--anomaly-guard"]
DIST_WAIT_S = 300  # the longest the world waits for the killed world


def dist_config(bf16=False):
    """Tied GPT-2-small with both kernels routed on; bf16 compute over f32
    master weights for the timing."""
    from distributed_training_with_pipeline_parallelism_tpu_torch import gpt2_config
    kw = dict(dtype="bfloat16", param_dtype="float32") if bf16 else {}
    return gpt2_config("small", tie_embeddings=True, use_flash_attention=True,
                       use_fused_xent=True, **kw)


def rank_launches(cfg, sched, D, d):
    """Kernel launches of pipe rank d's row of the table under the
    rematerialising backward: lps forward layers a forward unit and lps a
    backward unit's recompute, lps backward layers a backward unit, and
    one cross entropy each way a backward unit of the last stage."""
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
        schedules)
    cs = schedules.compile_schedule(sched.name, D, sched.n_virtual,
                                    sched.n_microbatches)
    row = cs.table[:, d]
    S = D * sched.n_virtual
    lps = cfg.n_layers // S
    n_f = int((row[:, schedules.COL_FWD_M] >= 0).sum())
    b_stages = [schedules.placement_stage_of(cs.placement, d, int(v), D)
                for v in row[row[:, schedules.COL_BWD_M] >= 0,
                             schedules.COL_BWD_V]]
    last = sum(s == S - 1 for s in b_stages)
    return {"flash_fwd": lps * (n_f + len(b_stages)),
            "flash_bwd": lps * len(b_stages), "xent_fwd": last,
            "xent_bwd": last}


def leaf_ratio(got, want, leaf_scale, total) -> float:
    """Phase 4's leaf bound: |got - want| over 1e-4 of the leaf's own
    scale plus 1e-6 of the whole model's (1.0 at the bound)."""
    return ((got.double() - want.double()).norm()
            / (1e-4 * leaf_scale + 1e-6 * total)).item()


def signal_file(path, status: str) -> None:
    """Write ``status`` ("ok", or what went wrong) to ``path`` at once."""
    tmp = Path(str(path) + ".tmp")
    tmp.write_text(status)
    tmp.rename(path)


def wait_for(path, what: str) -> float:
    """Wait for :func:`signal_file`'s ``path``; fail unless it says "ok".
    Returns the seconds waited."""
    t = time.perf_counter()
    path = Path(path)
    while not path.exists():
        check(time.perf_counter() - t < DIST_WAIT_S, f"{what} never came")
        time.sleep(0.05)
    check(path.read_text() == "ok", f"{what}: {path.read_text()}")
    return time.perf_counter() - t


def dist_warm(configs, device, shape):
    """The rank's first-use costs, paid by every rank of the world at once:
    a pipelined first step pays them rank after rank down the pipe (each
    rank's first backward waits for the next rank's). For each config, a
    one-layer model's forward and backward at the gates' microbatch
    ``shape`` (rows, sequence): both flash kernels, both cross-entropy
    kernels, the GEMMs of a block and of the head. Returns the seconds."""
    import torch
    from distributed_training_with_pipeline_parallelism_tpu_torch import (
        init_params)
    from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
        transformer_loss)
    t = time.perf_counter()
    for c in configs:
        c1 = dataclasses.replace(c, n_layers=1)
        model = init_params(c1, torch.Generator().manual_seed(SEED), device)
        tokens = torch.zeros(shape, dtype=torch.long, device=device)
        transformer_loss(c1, model, tokens, tokens).backward()
        del model
    torch.cuda.synchronize()
    return time.perf_counter() - t


# the port's torch.profiler ranges: with CUDA activity each also makes a
# device-side entry of its name, which spans the kernels inside it
RANGES = ("handoff_wait", "handoff_post", "tp_all_reduce", "tp_all_gather",
          "tp_reduce_scatter", "fsdp_gather", "fsdp_reduce_scatter",
          "sp_shift", "sp_all_to_all", "ep_all_to_all", "moe_route",
          "moe_dispatch", "moe_experts", "moe_combine")


def device_busy_ms(avg) -> float:
    """The device's own busy time in ms in a profile's ``key_averages()``:
    its kernels and copies (``DeviceType.CUDA`` events), not the host ops
    that launched them nor the ranges' device-side entries."""
    from torch.autograd import DeviceType
    return sum(e.self_device_time_total for e in avg
               if e.device_type == DeviceType.CUDA
               and e.key not in RANGES) / 1e3


def dist_profile(step, mesh, profile_it):
    """One step on every rank; the ranks with ``profile_it`` under the
    profiler: wall, this rank's device busy, its idle share, and the host
    time of its hand-off waits and posts (the transport's spans)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not profile_it:
        step()
        torch.cuda.synchronize()
        mesh.barrier()
        return None
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    mesh.barrier()
    avg = prof.key_averages()
    busy = device_busy_ms(avg)
    spans = {}  # a span's copies also make a device-side entry of its name
    for e in avg:
        if e.key in ("handoff_wait", "handoff_post"):
            spans[e.key] = max(spans.get(e.key, 0.0), e.cpu_time_total / 1e3)
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy,
                idle_share=1 - busy / (wall * 1e3),
                handoff_wait_ms=spans.get("handoff_wait", 0.0),
                handoff_post_ms=spans.get("handoff_post", 0.0))


def stamped_world_step(make_step, model, opt_state, batch, mesh):
    """One stamped train step of a world (``make_step(telemetry)`` gives
    the step): every rank stamps its row of the table and global rank 0
    merges the stamps. Rank 0 returns the timeline's length, the table's
    and, per rank, the seconds of its own tick stamps, those of ticks
    where its row runs a unit and its arrival waits; the other ranks
    None."""
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils import (
        telemetry as tm)
    tel = tm.PipelineTelemetry()
    step = make_step(tel)
    mesh.barrier()  # a profiled rank may still be reading its trace
    step(model, opt_state, *batch).item()
    if mesh.rank != 0:
        return None
    return dict(n_ticks=len(tel.timeline()), table_ticks=tel.table.shape[0],
                step_s=sum(r["duration_s"] for r in tel.timeline()),
                ranks=tel.rank_summary())


def print_world_stamps(stamps, profile, world):
    """Rank 0's stamps of phases 10 and 11 beside each rank's CUPTI idle
    share (where the rank was profiled); fails unless every rank stamped
    every tick."""
    check(stamps["n_ticks"] == stamps["table_ticks"]
          and len(stamps["ranks"]) == world,
          f"the stamped world step: {stamps['n_ticks']} of "
          f"{stamps['table_ticks']} ticks, {len(stamps['ranks'])} of "
          f"{world} ranks")
    print(f"  stamped step: {stamps['n_ticks']} ticks, "
          f"{stamps['step_s'] * 1e3:.1f} ms from rank 0's merged stamps")
    for r in stamps["ranks"]:
        p = profile.get(r["rank"])
        print(f"    rank {r['rank']} (pipe {r['pipe']}): its ticks "
              f"{r['tick_s'] * 1e3:.1f} ms, busy ticks "
              f"{r['busy_tick_s'] * 1e3:.1f} ms, arrival waits "
              f"{r['wait_s'] * 1e3:.1f} ms"
              + (f"; CUPTI idle share {p['idle_share']:.3f}" if p else ""))


def dist_worker(mesh, spec):
    """One rank of phase 10's world: the warm-up, (a) the f32 gates, (b)
    the clipped train steps against the lockstep one, then, once the
    killed ``train.py`` world is gone, (c) the bf16 timing and the
    profiled step and (d) ``train.run`` unbroken and resumed. Returns this
    rank's numbers; raises (failing the world) at a gate."""
    import io
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import distributed_training_with_pipeline_parallelism_tpu_torch as port
    from distributed_training_with_pipeline_parallelism_tpu_torch import (
        train as tmain)
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel.mesh import (
        make_mesh)
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel.selftest import (
        record_norms)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils.config import (
        torch_dtype)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils.data import (
        batch_sharding)
    device = mesh.device
    kernels = all_kernels()
    cfg, cfg16 = dist_config(), dist_config(bf16=True)
    tokens, targets = (torch.from_numpy(spec[k]) for k in ("tokens",
                                                           "targets"))
    gate = (tokens[:DIST_GATE_B], targets[:DIST_GATE_B])
    meshes = {(mesh.n_pipe, mesh.n_data): mesh}
    res = dict(rank=mesh.rank, describe=mesh.describe(), gates=[])
    t_phase = time.perf_counter()
    res["warm_s"] = dist_warm((cfg, cfg16), device,
                              (DIST_GATE_B // DIST_M, tokens.shape[1]))
    # the launcher's references, made while this world started: the whole
    # model's values (cfg16 keeps f32 masters too), the lockstep gradients
    res["refs_wait_s"] = wait_for(spec["refs_ready"], "the references")
    whole = torch.load(spec["whole"], mmap=True, weights_only=True)
    ref = torch.load(spec["ref"], mmap=True, weights_only=True)
    mesh.barrier()

    def mesh_of(D, nd):
        if (D, nd) not in meshes:
            meshes[(D, nd)] = make_mesh(D, nd, backend=mesh.backend,
                                        device=device)
        return meshes[(D, nd)]

    def view(c, m, sched):
        """The rank's view of the seeded model: its stages' blocks."""
        from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
            Transformer)
        own = port.owned_layers(c.n_layers, sched, m.n_pipe, m.pipe)
        v = Transformer(c, device=device, dtype=torch_dtype(c.storage_dtype),
                        layers=own)
        v.load_state_dict({k: whole[k] for k in v.state_dict()})
        return v

    def local(m, batch):
        return tuple(x.to(device) for x in batch_sharding(m)(batch))

    # (a) the f32 gates: against the lockstep step, ring against none,
    # launches against the rank's row of the table
    for name, D, V, nd in DIST_GATES:
        t_gate = time.perf_counter()
        m = mesh_of(D, nd)
        sched = port.ScheduleConfig(name, DIST_M, V)
        model = view(cfg, m, sched)
        view_s = time.perf_counter() - t_gate
        batch = local(m, gate)
        runs = {}
        for co in ("none", "ring"):
            fn = port.make_pipeline_grad_fn(cfg, sched, D, device=device,
                                            mesh=m, comm_overlap=co)
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            for k in kernels:
                k.launches = 0
            t = time.perf_counter()
            loss = fn(model, *batch).item()
            wall = time.perf_counter() - t
            runs[co] = (loss, {n: p.grad.clone()
                               for n, p in model.named_parameters()},
                        {k.name: k.launches for k in kernels}, wall)
        (loss, grads, launches, wall), ring = runs["none"], runs["ring"]
        check(ring[0] == loss and all(torch.equal(ring[1][n], g)
                                      for n, g in grads.items()),
              f"{name} D={D} x {nd}: ring differs from none")
        rel = abs(loss - ref["loss"]) / abs(ref["loss"])
        worst, leaf = -1.0, None
        for n, g in grads.items():
            r = ref["grads"][n].to(device)
            ratio = leaf_ratio(g, r, r.double().norm(), ref["g_norm"])
            if ratio > worst:
                worst, leaf = ratio, n
        want = rank_launches(cfg, sched, D, m.pipe)
        check(rel <= 1e-5, f"{name} D={D} x {nd} rank {mesh.rank}: loss "
              f"rel err {rel} > 1e-5")
        check(worst <= 1.0, f"{name} D={D} x {nd} rank {mesh.rank}: leaf "
              f"{leaf} over its bound ({worst})")
        check(launches == want, f"{name} D={D} x {nd} rank {mesh.rank}: "
              f"launches {launches} != the table's {want}")
        res["gates"].append(dict(
            schedule=name, D=D, V=V, n_data=nd, pipe=m.pipe, data=m.data,
            loss=loss, loss_rel_err=rel, worst_bound_ratio=worst,
            worst_leaf=leaf, launches=launches, step_s=wall,
            ring_step_s=ring[3], view_s=view_s,
            gate_s=time.perf_counter() - t_gate))
        del model, grads, runs, ring

    # (b) DIST_STEPS clipped AdamW updates, ZeRO-1 and plain, D = 2 x 2,
    # against the lockstep process's train step on the whole model and
    # batch: each update's clipping norm (the world's) within 1e-5, each
    # leaf within phase 4's bound of its move; the k biases, whose gradient
    # is rounding noise (softmax ignores a shift), within the two learning
    # rates a step that Adam may move them on the noise's sign
    m = mesh_of(2, 2)
    sched = port.ScheduleConfig("1F1B", DIST_M)
    opt = port.adamw(**DIST_OPT)
    step = port.make_train_step(cfg, sched, 2, opt, device=device, mesh=m)
    batch = local(m, gate)
    after = torch.load(spec["train_ref"], mmap=True, weights_only=True)
    res["train"] = {}
    for label in ("zero1", "plain"):
        model = view(cfg, m, sched)
        state = (port.init_sharded_opt_state(opt, model, m)
                 if label == "zero1" else opt.init(model))
        norms = []
        record_norms(state, norms)
        for _ in range(DIST_STEPS):
            step(model, state, *batch)
        norm_err = max(abs(a - b) / b for a, b in zip(norms, after["norms"]))
        check(len(norms) == DIST_STEPS and norm_err <= 1e-5,
              f"{label} rank {mesh.rank}: clipping norms {norms} against "
              f"the lockstep's {after['norms']}")
        worst, leaf, k_bias = -1.0, None, 0.0
        for n, p in model.named_parameters():
            q = after["params"][n].to(device)
            if n.endswith("attn.k.bias"):
                k_bias = max(k_bias, (p.detach() - q).abs().max().item())
                continue
            move = (q.double() - whole[n].to(device).double()).norm()
            ratio = leaf_ratio(p.detach(), q, move, after["move_norm"])
            if ratio > worst:
                worst, leaf = ratio, n
        check(worst <= 1.0, f"{label} rank {mesh.rank}: leaf {leaf} over "
              f"its bound ({worst})")
        check(k_bias <= 2 * opt.learning_rate * DIST_STEPS,
              f"{label} rank {mesh.rank}: a k bias {k_bias} off")
        res["train"][label] = dict(norms=norms, norm_rel_err=norm_err,
                                   worst_bound_ratio=worst, worst_leaf=leaf,
                                   k_bias_max_abs=k_bias)
        del model, state
    del after
    res["gates_s"] = time.perf_counter() - t_phase

    # (d) train.run, the function each rank of train.py's world runs, over
    # this world's 2 x 2 mesh: unbroken now, beside the killed world's
    # last steps; resumed from its checkpoints once it is gone
    res["train_main"] = {}

    def train_main(label, extra):
        t_run = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            tmain.run(tmain.parser().parse_args(DIST_TRAIN_ARGS + extra),
                      mesh_of(2, 2))
        res["train_main"][label] = dict(seconds=time.perf_counter() - t_run,
                                        output=out.getvalue())

    train_main("unbroken", ["--ckpt", spec["unbroken"]])

    # the killed train.py world, started beside this one, is gone before
    # the timing
    res["killed_wait_s"] = wait_for(spec["killed_done"],
                                    "the killed train.py world's end")
    mesh.barrier()

    # (c) bf16 timing of the D = 4 world (twice), one counted step and one
    # profiled step (ranks 0 and D - 1)
    m = mesh_of(4, 1)
    sched = port.ScheduleConfig("1F1B", DIST_M)
    model = view(cfg16, m, sched)
    opt = port.adamw(warmup_steps=2, total_steps=100)
    state = opt.init(model)
    step = port.make_train_step(cfg16, sched, 4, opt, device=device,
                                mesh=m)
    batch = local(m, (tokens, targets))
    losses = []

    def run(mdl, t, y):
        loss = step(mdl, state, t, y)
        losses.append(loss)
        return loss

    res["timed"] = [port.run_train_iterations(
        run, model, *batch, num_iterations=DIST_TIMED,
        warmup_iterations=DIST_WARMUP, mesh=m) for _ in range(2)]
    res["losses"] = [x.item() for x in losses]
    check(all(math.isfinite(x) for x in res["losses"]),
          f"rank {mesh.rank}: non-finite bf16 loss {res['losses']}")
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    run(model, *batch).item()
    res["step_launches"] = {k.name: k.launches for k in kernels}
    check(res["step_launches"] == rank_launches(cfg16, sched, 4, m.pipe),
          f"bf16 rank {mesh.rank}: launches {res['step_launches']}")
    res["profile"] = dist_profile(lambda: run(model, *batch), m,
                                  m.pipe in (0, 3))
    res["stamps"] = stamped_world_step(
        lambda tel: port.make_train_step(cfg16, sched, 4, opt, device=device,
                                         mesh=m, telemetry=tel),
        model, state, batch, m)
    del model, state
    torch.cuda.empty_cache()

    # (d) the resume; then each rank holds its share of step 5's files to
    # the unbroken run's, bitwise
    train_main("resumed", ["--ckpt", spec["killed"], "--auto-resume"])
    unbroken, resumed = (Path(spec[k]) / "step_5"
                         for k in ("unbroken", "killed"))
    names = sorted(p.name for p in unbroken.glob("*.pt"))
    check(names == sorted(p.name for p in resumed.glob("*.pt")),
          f"step 5's files differ: {names}")
    res["resume_checked"] = names[mesh.rank::mesh.world]
    same_files(unbroken, resumed, res["resume_checked"])
    res["seconds"] = time.perf_counter() - t_phase
    return res


def same_files(a, b, names):
    """Every tensor and value of each checkpoint file ``names`` equal in
    dirs ``a`` and ``b``."""
    import torch

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree, key=str):
                yield from leaves(tree[k], path + (str(k),))
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                yield from leaves(v, path + (str(i),))
        else:
            yield path, tree

    for name in names:
        x, y = (dict(leaves(torch.load(Path(d) / name, map_location="cpu",
                                       weights_only=True)))
                for d in (a, b))
        check(x.keys() == y.keys(), f"{name}: other keys")
        for k, v in x.items():
            same = (torch.equal(v, y[k]) if isinstance(v, torch.Tensor)
                    else v == y[k])
            check(same, f"{name}: {'/'.join(k)} differs after the resume")


class KilledWorld:
    """A ``train.py`` world (phase 10's ``DIST_TRAIN_ARGS``, or ``args``),
    started beside the phase's world and killed (its whole process group)
    once step ``kill_after`` is committed, before step ``last``'s save.
    Then ``done`` holds "ok", or what went wrong, for the phase's world to
    read."""

    def __init__(self, tmp, args=DIST_TRAIN_ARGS, kill_after=2, last=5):
        self.dir = Path(tmp) / "killed"
        self.done = Path(tmp) / "killed_done"
        self.kill_after, self.last = kill_after, last
        self.lines = []  # (seconds since the start, line)
        self.status, self.killed_s = "running", None
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", f"{PKG}.train", *args,
             "--ckpt", str(self.dir)], text=True, start_new_session=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        self._reader = threading.Thread(target=self._read, daemon=True)
        self._reader.start()
        self._watch = threading.Thread(target=self._kill_after_commit,
                                       daemon=True)
        self._watch.start()

    def _read(self):
        for line in self.proc.stdout:
            self.lines.append((time.perf_counter() - self.t0, line.rstrip()))

    def _kill_after_commit(self):
        import signal
        marker = self.dir / f"step_{self.kill_after}" / "_COMMITTED.json"
        status = "ok"
        while not marker.exists() and self.proc.poll() is None:
            if time.perf_counter() - self.t0 > DIST_WAIT_S:
                status = f"step {self.kill_after} never committed"
                break
            time.sleep(0.05)
        self.stop()
        if status == "ok" and self.proc.returncode != -signal.SIGKILL:
            status = f"it ended with {self.proc.returncode} before the kill"
        elif status == "ok" and (self.dir / f"step_{self.last}" /
                                 "_COMMITTED.json").exists():
            status = "the kill came after the last save"
        self.killed_s = time.perf_counter() - self.t0
        self.status = status
        signal_file(self.done, status)

    def stop(self):
        import os
        import signal
        if self.proc.poll() is None:
            try:
                os.killpg(self.proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        self.proc.wait()

    def finish(self):
        """Stop the world if it still runs; its record."""
        self.stop()
        self._watch.join(timeout=60)
        self._reader.join(timeout=60)
        out = "\n".join(line for _, line in self.lines)
        check(self.status == "ok",
              f"the killed train.py world: {self.status}\n{out[-3000:]}")
        return dict(status=self.status, killed_s=self.killed_s,
                    output=self.lines)


def phase_dist(report, device="cuda"):
    """The torch.distributed transport (see the module doc): the lockstep
    timing here, then a world of 4 processes on the one card for the
    gates, the world's timing and ``train.run``, beside which
    ``train.py``'s world runs until it is killed; while both start, the f32
    reference step and the lockstep train steps run here. Returns the
    launches of rank r's counted bf16 step (D = 4, 1F1B) by rank."""
    import shutil
    import tempfile
    import torch
    import distributed_training_with_pipeline_parallelism_tpu_torch as port
    from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
        Transformer)
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel.selftest import (
        record_norms)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils.config import (
        torch_dtype)
    t0 = time.perf_counter()
    cfg, cfg16 = dist_config(), dist_config(bf16=True)
    g = torch.Generator().manual_seed(SEED + 1)
    tokens, targets = (torch.randint(0, cfg.vocab_size,
                                     (DIST_TIME_B, TRAIN_S), generator=g)
                       for _ in range(2))
    gate = (tokens[:DIST_GATE_B].to(device), targets[:DIST_GATE_B].to(device))
    sched = port.ScheduleConfig("1F1B", DIST_M)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-dist-")
    res, killed, world = {}, None, None
    # the seeded model's values, drawn once (cfg16 keeps f32 masters too)
    init_state = port.init_params(cfg, torch.Generator().manual_seed(SEED),
                                  device).state_dict()

    def seeded(c):
        model = Transformer(c, device=device, dtype=torch_dtype(
            c.storage_dtype))
        model.load_state_dict(init_state)
        return model

    def references():
        """The f32 1F1B D = 4 step on B = 8 and (b)'s two lockstep train
        steps, written for the ranks with the model's values."""
        model = seeded(cfg)
        torch.save({n: t.cpu() for n, t in init_state.items()},
                   Path(tmp) / "whole.pt")
        fn = port.make_pipeline_grad_fn(cfg, sched, 4, device=device)
        loss = fn(model, *gate).item()
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        g_norm = math.sqrt(sum((x.double() ** 2).sum().item()
                               for x in grads.values()))
        torch.save({"grads": grads, "loss": loss, "g_norm": g_norm},
                   Path(tmp) / "ref.pt")
        del grads, fn
        # (b)'s: the lockstep train step at D = 2 on the whole batch, in
        # the world's microbatches (M x n_data of them)
        model.zero_grad(set_to_none=True)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        opt = port.adamw(**DIST_OPT)
        state = opt.init(model)
        norms = []
        record_norms(state, norms)
        step = port.make_train_step(
            cfg, port.ScheduleConfig("1F1B", 2 * DIST_M), 2, opt,
            device=device)
        for _ in range(DIST_STEPS):
            step(model, state, *gate)
        check(all(n > DIST_OPT["max_grad_norm"] for n in norms),
              f"the lockstep train step's norms {norms} took no clip")
        move_norm = math.sqrt(sum(
            ((p.detach().double() - before[n].double()) ** 2).sum().item()
            for n, p in model.named_parameters()))
        torch.save({"params": {n: p.detach().cpu()
                               for n, p in model.named_parameters()},
                    "norms": norms, "move_norm": move_norm},
                   Path(tmp) / "train_ref.pt")
        del model, before, state, step
        torch.cuda.empty_cache()
        return loss

    # the lockstep process's bf16 timing, before and after the world's
    def lockstep_tps():
        m = seeded(cfg16)
        opt = port.adamw(warmup_steps=2, total_steps=100)
        st = opt.init(m)
        step = port.make_train_step(cfg16, sched, 4, opt, device=device)
        out = port.run_train_iterations(
            lambda mm, t, y: step(mm, st, t, y), m, tokens.to(device),
            targets.to(device), num_iterations=DIST_TIMED,
            warmup_iterations=DIST_WARMUP)
        del m, st
        torch.cuda.empty_cache()
        return out["throughput"]

    def run_world(spec, box):
        try:
            box["ranks"] = port.launch(dist_worker, port.MeshConfig(4, 1),
                                       spec, backend="gloo", device=device,
                                       timeout_s=300)
        except BaseException as e:  # re-raised by the phase
            box["error"] = e

    try:
        lock = [lockstep_tps()]
        spec = dict(tokens=tokens.numpy(), targets=targets.numpy(),
                    **{k: str(Path(tmp) / v) for k, v in (
                        ("whole", "whole.pt"), ("ref", "ref.pt"),
                        ("train_ref", "train_ref.pt"),
                        ("refs_ready", "refs_ready"),
                        ("unbroken", "unbroken"), ("killed", "killed"),
                        ("killed_done", "killed_done"))})
        # the killed train.py world and this phase's world start together;
        # the references are made while they start
        t_world = time.perf_counter()
        killed = KilledWorld(tmp)
        box = {}
        world = threading.Thread(target=run_world, args=(spec, box))
        world.start()
        try:
            loss = references()
        except BaseException as e:
            signal_file(spec["refs_ready"], f"the launcher failed: {e!r}")
            raise
        signal_file(spec["refs_ready"], "ok")
        res["refs_s"] = time.perf_counter() - t_world
        world.join()
        if "error" in box:
            raise box["error"]
        ranks = box["ranks"]
        world_s = time.perf_counter() - t_world
        res["killed_world"] = killed.finish()
        lock.append(lockstep_tps())
        print(f"  mesh.describe() of rank 0: {ranks[0]['describe']}")
        for r in ranks:
            check(r["describe"]["staging"], f"rank {r['rank']}: gloo on "
                  f"CUDA without staging")
        print(f"  warm-up (one-layer model per config, every rank at once): "
              f"{max(r['warm_s'] for r in ranks):.2f} s")
        for i, (name, D, V, nd) in enumerate(DIST_GATES):
            rows = [r["gates"][i] for r in ranks]
            total = {k: sum(x["launches"][k] for x in rows)
                     for k in rows[0]["launches"]}
            print(f"  f32 {name} D={D} V={V} x data {nd}: loss "
                  f"{rows[0]['loss']:.6f} (rel err "
                  f"{max(x['loss_rel_err'] for x in rows):.2e} vs lockstep "
                  f"{loss:.6f}), worst leaf at "
                  f"{max(x['worst_bound_ratio'] for x in rows):.3f} of its "
                  f"bound, ring == none, launches by rank "
                  f"{[x['launches'] for x in rows]} (sum {total}), step "
                  f"{max(x['step_s'] for x in rows):.2f} s (ring "
                  f"{max(x['ring_step_s'] for x in rows):.2f} s)")
            check(all(v > 0 for v in total.values()),
                  f"{name} D={D}: a kernel was never launched: {total}")
            if nd == 1:
                check(total == dict(flash_fwd=96, xent_fwd=4, flash_bwd=48,
                                    xent_bwd=4),
                      f"{name} D={D}: the ranks' launches sum to {total}")
            res[f"f32_{name}_D{D}_data{nd}"] = dict(ranks=rows,
                                                    launches_sum=total)
        res["train"] = [r["train"] for r in ranks]
        for label in ("zero1", "plain"):
            rows = [r["train"][label] for r in ranks]
            print(f"  {label} AdamW, {DIST_STEPS} clipped updates (D=2 x "
                  f"data 2) vs the lockstep train step: norms "
                  f"{[round(x, 4) for x in rows[0]['norms']]} (rel err "
                  f"{max(x['norm_rel_err'] for x in rows):.2e}), worst leaf "
                  f"at {max(x['worst_bound_ratio'] for x in rows):.3f} of "
                  f"its bound, k biases within "
                  f"{max(x['k_bias_max_abs'] for x in rows):.2e}")
        world_tps = [[r["timed"][i]["throughput"] for r in ranks]
                     for i in range(2)]
        res["bf16"] = dict(
            lockstep_tokens_per_s=lock,
            world_tokens_per_s=[w[0] for w in world_tps],
            world_tokens_per_s_by_rank=world_tps,
            ratio=sum(w[0] for w in world_tps) / sum(lock),
            losses=[r["losses"] for r in ranks],
            step_launches=[r["step_launches"] for r in ranks],
            profile={r["rank"]: r["profile"] for r in ranks if r["profile"]},
            stamps=ranks[0]["stamps"])
        print(f"  bf16 1F1B D=4, B={DIST_TIME_B}, in turns: lockstep "
              f"{lock[0]:.1f}, world {world_tps[0][0]:.1f}, world "
              f"{world_tps[1][0]:.1f}, lockstep {lock[1]:.1f} tokens/s "
              f"(world / lockstep {res['bf16']['ratio']:.4f}); launches "
              f"by rank {res['bf16']['step_launches']}")
        for r, p in sorted(res["bf16"]["profile"].items()):
            print(f"  rank {r} profiled step: wall {p['wall_ms']:.1f} ms, "
                  f"its device busy {p['device_busy_ms']:.1f} ms, idle share "
                  f"{p['idle_share']:.3f}, hand-off wait "
                  f"{p['handoff_wait_ms']:.1f} ms, posts "
                  f"{p['handoff_post_ms']:.1f} ms")
        print_world_stamps(ranks[0]["stamps"], res["bf16"]["profile"],
                           len(ranks))

        # (d) the resume restored, and the ranks compared every file
        tm = ranks[0]["train_main"]
        check("resumed from" in tm["resumed"]["output"],
              f"the resume restored nothing:\n"
              f"{tm['resumed']['output'][-3000:]}")
        names = sorted(n for r in ranks for n in r["resume_checked"])
        check(len(names) == len(ranks), f"step 5's files: {names}")
        losses = {label: [float(x.split()[-1])
                          for x in tm[label]["output"].splitlines()
                          if x.startswith("step ") and ": loss " in x]
                  for label in tm}
        check(all(v and all(math.isfinite(x) for x in v)
                  for v in losses.values()), f"train.run's losses {losses}")
        res["train_main"] = dict(
            args=DIST_TRAIN_ARGS, checked=names, losses=losses,
            seconds={k: v["seconds"] for k, v in tm.items()},
            output={k: v["output"][-2000:] for k, v in tm.items()})
        res["world_s"] = world_s
        res["world_ranks_s"] = [{k: r[k] for k in (
            "warm_s", "refs_wait_s", "gates_s", "killed_wait_s", "seconds")}
            for r in ranks]
        kw = res["killed_world"]
        print(f"  train.py --pipe 2 --data 2 --backend gloo --zero1 (4 of "
              f"12 layers, S={TRAIN_S}): its world killed after step 2's "
              f"commit at {kw['killed_s']:.1f} s (beside this world's "
              f"gates), train.run resumed in this world in "
              f"{tm['resumed']['seconds']:.1f} s, unbroken in "
              f"{tm['unbroken']['seconds']:.1f} s: step 5's {len(names)} "
              f"files bitwise equal, losses {losses}")
    finally:
        if world is not None:
            world.join()
        if killed is not None:
            killed.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        del init_state
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t0
    print(f"  phase 10: {res['seconds']:.1f} s against the 90 s it is held "
          f"to (the world {res['world_s']:.1f} s, its ranks waited "
          f"{max(r['killed_wait_s'] for r in res['world_ranks_s']):.1f} s "
          f"for the killed world)")
    report["dist"] = res
    return {r["rank"]: r["step_launches"] for r in ranks}


# ---------------------------------------------------------------------------
# Phase 11: Megatron tensor parallelism, pipe 2 x model 2
# ---------------------------------------------------------------------------

TP_MESH = (2, 1, 2)  # (n_pipe, n_data, n_model)
TP_M, TP_GATE_B, TP_TIME_B = 4, 8, 24
TP_GATES = (("1F1B", 1), ("Interleaved1F1B", 2))
# (b): Llama-3.2-1B at full width, 4 of its 16 layers
TP_LLAMA_LAYERS, TP_LLAMA_B, TP_LLAMA_S, TP_LLAMA_M = 4, 4, 256, 2
TP_DROP_SEED = 11  # (c)'s step seed
# (e): train.py's TP world, tied GPT-2-small at 4 layers, S = 256
TP_TRAIN_ARGS = ["--model", "gpt2-small", "--tie-embeddings", "--layers",
                 "4", "--pipe", "2", "--tp", "2", "--backend", "gloo",
                 "--batch", "8", "--seq", "256", "--microbatches", "2",
                 "--steps", "4", "--ckpt-every", "1", "--flash", "on",
                 "--fused-xent", "--anomaly-guard"]


def tp_llama_config():
    """Llama-3.2-1B at full width (GQA 32/8, tied, vocab 128256) and
    ``TP_LLAMA_LAYERS`` layers, the flash kernels on, f32."""
    from distributed_training_with_pipeline_parallelism_tpu_torch import llama_config
    return llama_config("llama3.2-1b", n_layers=TP_LLAMA_LAYERS,
                        use_flash_attention=True, use_fused_xent=True)


def tp_ref_config(dropout=0.0):
    """The reference's L8/H8 with the flash kernels forced on, or with
    dropout (the dense path)."""
    if dropout:
        return ref_config(8, dropout=dropout, use_fused_xent=True)
    return ref_config(8, use_flash_attention=True, use_fused_xent=True)


def tp_gates():
    """(name, config, schedule, vocab-parallel, batch rows, seq, step
    seed) of (a)-(c)'s f32 gates: each the world's step against the
    lockstep process's on the same weights and batch."""
    import distributed_training_with_pipeline_parallelism_tpu_torch as port
    cfg = dist_config()
    gates = [(f"gpt2_{s}", cfg, port.ScheduleConfig(s, TP_M, V), False,
              TP_GATE_B, TRAIN_S, None) for s, V in TP_GATES]
    gates.append(("llama", tp_llama_config(),
                  port.ScheduleConfig("1F1B", TP_LLAMA_M), True, TP_LLAMA_B,
                  TP_LLAMA_S, None))
    gates.append(("ref", tp_ref_config(), port.ScheduleConfig("1F1B", REF_M),
                  True, REF_B, REF_S, None))
    gates.append(("ref_dropout", tp_ref_config(0.1),
                  port.ScheduleConfig("1F1B", REF_M), True, REF_B, REF_S,
                  TP_DROP_SEED))
    return gates


def tp_rank_launches(cfg, sched, D, d, vocab_parallel):
    """The launches of pipe rank d of a pipe-D world (``rank_launches``),
    which each of its model ranks makes at H/T heads; the vocab-parallel
    head launches no cross-entropy kernel (it bypasses K1, as in JAX)."""
    import torch
    want = rank_launches(cfg, sched, D, d)
    ref = cfg.arch == "ref_decoder"  # self- and cross-attention a layer
    if not cfg.flash_for(not ref, torch.device("cuda")):
        want.update(flash_fwd=0, flash_bwd=0)
    elif ref:
        want.update(flash_fwd=2 * want["flash_fwd"],
                    flash_bwd=2 * want["flash_bwd"])
    if vocab_parallel:
        want.update(xent_fwd=0, xent_bwd=0)
    return want


def tp_compare(mesh, cfg, vocab_parallel, model, ref):
    """(loss rel err, worst leaf ratio, its leaf) of this rank's shard's
    gradients against the lockstep ``ref``: each leaf's error and norm
    gathered over the model group (a split leaf's parts summed, a
    replicated leaf's taken once), phase 4's bound."""
    import torch
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
        tensor_parallel as ttp)
    names, sq = [], []
    for n, p in model.named_parameters():
        dim = ttp.split_dim(cfg, n, vocab_parallel)
        r = ttp.shard_tensor(ref["grads"][n], dim, mesh.n_model,
                             mesh.model).to(p.device)
        w = 1.0 if dim is not None or mesh.model == 0 else 0.0
        sq.append(torch.stack([(p.grad.double() - r.double()).square().sum(),
                               r.double().square().sum()]) * w)
        names.append(n)
    sq = torch.stack(sq)
    mesh.all_reduce([sq], "model")
    ratios = (sq[:, 0].sqrt() / (1e-4 * sq[:, 1].sqrt()
                                 + 1e-6 * ref["g_norm"])).tolist()
    worst = max(range(len(names)), key=lambda i: ratios[i])
    return ratios[worst], names[worst]


def tp_profile(step, mesh):
    """One step on every rank under the profiler: wall, the rank's device
    busy, its idle share, and the host time of its model-axis all-reduces
    and hand-off waits and posts (their spans)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    mesh.barrier()
    avg = prof.key_averages()
    busy = device_busy_ms(avg)
    spans = {}
    for e in avg:
        if e.key in ("tp_all_reduce", "handoff_wait", "handoff_post"):
            spans[e.key] = max(spans.get(e.key, 0.0), e.cpu_time_total / 1e3)
            spans[e.key + "_count"] = max(spans.get(e.key + "_count", 0),
                                          e.count)
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy,
                idle_share=1 - busy / (wall * 1e3),
                tp_all_reduce_ms=spans.get("tp_all_reduce", 0.0),
                tp_all_reduces=spans.get("tp_all_reduce_count", 0),
                handoff_wait_ms=spans.get("handoff_wait", 0.0),
                handoff_post_ms=spans.get("handoff_post", 0.0))


def tp_worker(mesh, spec):
    """One rank of phase 11's world: the warm-up, (a)-(c) the f32 gates,
    (e) ``train.run`` unbroken beside the killed ``train.py`` world, then
    (d) the bf16 timing, one counted and one profiled step, and (e) the
    resume. Returns this rank's numbers; raises (failing the world) at a
    gate."""
    import io
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import distributed_training_with_pipeline_parallelism_tpu_torch as port
    from distributed_training_with_pipeline_parallelism_tpu_torch import (
        train as tmain)
    from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
        Transformer)
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
        tensor_parallel as ttp)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils.config import (
        torch_dtype)
    device = mesh.device
    kernels = all_kernels()
    cfg16 = dist_config(bf16=True)
    res = dict(rank=mesh.rank, describe=mesh.describe(), gates={})
    t_phase = time.perf_counter()
    gates = tp_gates()
    res["warm_s"] = sum(dist_warm((c,), device, (b // sch.n_microbatches, S))
                        for _, c, sch, _, b, S, _ in gates[0:4:3])
    res["warm_s"] += dist_warm((cfg16,), device, (TP_TIME_B // TP_M,
                                                  TRAIN_S))
    res["refs_wait_s"] = 0.0

    def shard(c, sched, vp, whole):
        own = port.owned_layers(c.n_layers, sched, mesh.n_pipe, mesh.pipe)
        v = Transformer(c, device=device, dtype=torch_dtype(c.storage_dtype),
                        layers=own)
        v.load_state_dict({k: whole[k] for k in v.state_dict()})
        return ttp.shard_model(v, c, mesh, vocab_parallel=vp)

    def batch_of(b, S, seed):
        g = torch.Generator().manual_seed(seed)
        return tuple(torch.randint(0, 10 ** 9, (b, S), generator=g)
                     for _ in range(2))

    # (a)-(c): the f32 gates against the lockstep process's step
    for name, c, sched, vp, b, S, step_seed in gates:
        # the launcher's references come gate by gate while the gates run
        res["refs_wait_s"] += wait_for(spec[f"{name}_ready"],
                                       f"the references of {name}")
        t_gate = time.perf_counter()
        whole = torch.load(spec[f"{name}_whole"], mmap=True,
                           weights_only=True)
        ref = torch.load(spec[f"{name}_ref"], mmap=True, weights_only=True)
        tokens, targets = (x % c.vocab_size for x in batch_of(b, S, SEED + 2))
        batch = (tokens.to(device), targets.to(device))
        extra = () if step_seed is None else (step_seed,)
        model = shard(c, sched, vp, whole)
        # the reference block's relu kink: replay the lockstep step's masks
        relu = (ReluMasks(torch.load(spec[f"{name}_relu"],
                                          weights_only=True),
                               (mesh.n_model, mesh.model))
                if c.arch == "ref_decoder" else None)
        runs = {}
        for co in (("none", "ring") if name.startswith("gpt2")
                   else ("none",)):
            cc = dataclasses.replace(c, tp_overlap=co)
            fn = port.make_pipeline_grad_fn(cc, sched, mesh.n_pipe,
                                            device=device, mesh=mesh,
                                            tp_vocab_parallel=vp)
            model.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            for k in kernels:
                k.launches = 0
            hops = mesh.hops
            t = time.perf_counter()
            with (relu.patched(True) if relu is not None
                  else contextlib.nullcontext()):
                loss = fn(model, *batch, *extra).item()
            wall = time.perf_counter() - t
            launches = {k.name: k.launches for k in kernels}
            rel = abs(loss - ref["loss"]) / abs(ref["loss"])
            worst, leaf = tp_compare(mesh, c, vp, model, ref)
            runs[co] = dict(loss=loss, loss_rel_err=rel,
                            worst_bound_ratio=worst, worst_leaf=leaf,
                            launches=launches, step_s=wall,
                            hops=mesh.hops - hops)
            if relu is not None:
                runs[co].update(relu_flips=relu.flips,
                                relu_units=relu.units)
                check(relu.flips < 1e-6 * relu.units,
                      f"TP {name} rank {mesh.rank}: {relu.flips} of "
                      f"{relu.units} relu inputs changed sign")
            check(rel <= 1e-5, f"TP {name} {co} rank {mesh.rank}: loss rel "
                  f"err {rel} > 1e-5")
            check(worst <= 1.0, f"TP {name} {co} rank {mesh.rank}: leaf "
                  f"{leaf} over its bound ({worst})")
            want = tp_rank_launches(c, sched, mesh.n_pipe, mesh.pipe, vp)
            check(launches == want, f"TP {name} {co} rank {mesh.rank}: "
                  f"launches {launches} != the table's {want}")
        res["gates"][name] = dict(runs, gate_s=time.perf_counter() - t_gate)
        del model, whole, ref
        torch.cuda.empty_cache()
    res["gates_s"] = time.perf_counter() - t_phase

    # (e) train.run over this world's mesh, unbroken, beside the killed
    # train.py world
    res["train_main"] = {}

    def train_main(label, extra):
        t_run = time.perf_counter()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            tmain.run(tmain.parser().parse_args(TP_TRAIN_ARGS + extra), mesh)
        res["train_main"][label] = dict(seconds=time.perf_counter() - t_run,
                                        output=out.getvalue())

    train_main("unbroken", ["--ckpt", spec["unbroken"]])
    res["killed_wait_s"] = wait_for(spec["killed_done"],
                                    "the killed train.py TP world's end")
    mesh.barrier()

    # (d) bf16: one counted step (which pays the first-use costs), one
    # profiled, one stamped (the timing in turns against the lockstep
    # process was cut for the script's time limit)
    sched = port.ScheduleConfig("1F1B", TP_M)
    whole = torch.load(spec["gpt2_1F1B_whole"], mmap=True, weights_only=True)
    model = shard(cfg16, sched, False, whole)
    opt = port.adamw(warmup_steps=2, total_steps=100)
    state = opt.init(model)
    step = port.make_train_step(cfg16, sched, mesh.n_pipe, opt,
                                device=device, mesh=mesh)
    tokens, targets = (x % cfg16.vocab_size
                       for x in batch_of(TP_TIME_B, TRAIN_S, SEED + 3))
    batch = (tokens.to(device), targets.to(device))
    losses = []

    def run(mdl, t, y):
        loss = step(mdl, state, t, y)
        losses.append(loss)
        return loss

    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    run(model, *batch).item()
    res["step_launches"] = {k.name: k.launches for k in kernels}
    want = tp_rank_launches(cfg16, sched, mesh.n_pipe, mesh.pipe, False)
    check(res["step_launches"] == want,
          f"TP bf16 rank {mesh.rank}: launches {res['step_launches']} != "
          f"the pipe rank's {want}")
    res["profile"] = tp_profile(lambda: run(model, *batch), mesh)
    res["losses"] = [x.item() for x in losses]
    check(all(math.isfinite(x) for x in res["losses"]),
          f"TP rank {mesh.rank}: non-finite bf16 loss {res['losses']}")
    res["stamps"] = stamped_world_step(
        lambda tel: port.make_train_step(cfg16, sched, mesh.n_pipe, opt,
                                         device=device, mesh=mesh,
                                         telemetry=tel),
        model, state, batch, mesh)
    del model, state, whole
    torch.cuda.empty_cache()

    # (e) the resume; each rank holds its share of step 3's files to the
    # unbroken run's, bitwise (a world commits a step at its next save, so
    # the kill after step 1's commit comes a step before the last save)
    train_main("resumed", ["--ckpt", spec["killed"], "--auto-resume"])
    unbroken, resumed = (Path(spec[k]) / "step_3"
                         for k in ("unbroken", "killed"))
    names = sorted(p.name for p in unbroken.glob("*.pt"))
    check(names == sorted(p.name for p in resumed.glob("*.pt")),
          f"TP step 3's files differ: {names}")
    res["resume_checked"] = names[mesh.rank::mesh.world]
    same_files(unbroken, resumed, res["resume_checked"])
    res["seconds"] = time.perf_counter() - t_phase
    return res


def phase_tp(report, device="cuda"):
    """Megatron tensor parallelism (see the module doc): the lockstep
    timing here, then a world of pipe 2 x model 2 processes on the one
    card for the f32 gates, the bf16 timing and ``train.run``, beside
    which ``train.py``'s TP world runs until it is killed; while both
    start, the references are made here. Returns the launches of rank
    r's counted bf16 step by rank."""
    import shutil
    import tempfile
    import torch
    import distributed_training_with_pipeline_parallelism_tpu_torch as port
    from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
        Transformer)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils.config import (
        torch_dtype)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-tp-")
    res, killed, world = {}, None, None

    def batch_of(b, S, seed):
        g = torch.Generator().manual_seed(seed)
        return tuple(torch.randint(0, 10 ** 9, (b, S), generator=g)
                     for _ in range(2))

    def references(spec):
        """Each gate's whole model and the lockstep process's f32 step on
        it, written for the ranks."""
        inits = {}
        for name, c, sched, vp, b, S, step_seed in tp_gates():
            path = spec[f"{name}_whole"]
            if path not in inits:
                inits[path] = {n: t.cpu() for n, t in port.init_params(
                    c, torch.Generator().manual_seed(SEED),
                    device).state_dict().items()}
                torch.save(inits[path], path)
            model = Transformer(c, device=device,
                                dtype=torch_dtype(c.storage_dtype))
            model.load_state_dict(inits[path])
            tokens, targets = (x % c.vocab_size
                               for x in batch_of(b, S, SEED + 2))
            fn = port.make_pipeline_grad_fn(c, sched, TP_MESH[0],
                                            device=device)
            extra = () if step_seed is None else (step_seed,)
            relu = ReluMasks()
            with (relu.patched(False) if c.arch == "ref_decoder"
                  else contextlib.nullcontext()):
                loss = fn(model, tokens.to(device), targets.to(device),
                          *extra).item()
            if c.arch == "ref_decoder":
                torch.save({k: m.cpu() for k, m in relu.masks.items()},
                           spec[f"{name}_relu"])
            grads = {n: p.grad.detach().cpu()
                     for n, p in model.named_parameters()}
            g_norm = math.sqrt(sum((x.double() ** 2).sum().item()
                                   for x in grads.values()))
            torch.save({"grads": grads, "loss": loss, "g_norm": g_norm},
                       spec[f"{name}_ref"])
            res.setdefault("lockstep_loss", {})[name] = loss
            del model, grads, fn
            torch.cuda.empty_cache()
            signal_file(spec[f"{name}_ready"], "ok")

    def run_world(spec, box):
        try:
            box["ranks"] = port.launch(tp_worker, port.MeshConfig(*TP_MESH),
                                       spec, backend="gloo", device=device,
                                       timeout_s=300)
        except BaseException as e:  # re-raised by the phase
            box["error"] = e

    try:
        spec = {k: str(Path(tmp) / k) for k in (
            "unbroken", "killed", "killed_done")}
        for name, c, *_ in tp_gates():  # one whole model a family
            spec[f"{name}_whole"] = str(Path(tmp) / f"whole_{c.arch}.pt")
            spec[f"{name}_ref"] = str(Path(tmp) / f"{name}_ref.pt")
            spec[f"{name}_relu"] = str(Path(tmp) / f"{name}_relu.pt")
            spec[f"{name}_ready"] = str(Path(tmp) / f"{name}_ready")
        t_world = time.perf_counter()
        killed = KilledWorld(tmp, TP_TRAIN_ARGS, kill_after=1, last=3)
        box = {}
        world = threading.Thread(target=run_world, args=(spec, box))
        world.start()
        try:
            references(spec)
        except BaseException as e:
            for name, *_ in tp_gates():
                if not Path(spec[f"{name}_ready"]).exists():
                    signal_file(spec[f"{name}_ready"],
                                f"the launcher failed: {e!r}")
            raise
        res["refs_s"] = time.perf_counter() - t_world
        world.join()
        if "error" in box:
            raise box["error"]
        ranks = box["ranks"]
        res["world_s"] = time.perf_counter() - t_world
        res["killed_world"] = killed.finish()
        print(f"  mesh.describe() of rank 0: {ranks[0]['describe']}")
        for r in ranks:
            check(r["describe"]["transport"] == "gloo-staged",
                  f"rank {r['rank']}: {r['describe']}")
        print(f"  warm-up (one-layer models, every rank at once): "
              f"{max(r['warm_s'] for r in ranks):.2f} s; the references "
              f"{res['refs_s']:.1f} s")
        for name, c, sched, vp, b, S, _ in tp_gates():
            rows = [r["gates"][name] for r in ranks]
            for co in [k for k in rows[0] if k != "gate_s"]:
                g = [x[co] for x in rows]
                total = {k: sum(x["launches"][k] for x in g)
                         for k in g[0]["launches"]}
                print(f"  f32 {name} ({sched.name} V={sched.n_virtual}, "
                      f"B={b}, S={S}, {c.n_heads}/{c.kv_heads} heads over 2"
                      f"{', vocab-parallel' if vp else ''}) {co}: loss "
                      f"{g[0]['loss']:.6f} (rel err "
                      f"{max(x['loss_rel_err'] for x in g):.2e} vs lockstep "
                      f"{res['lockstep_loss'][name]:.6f}), worst leaf at "
                      f"{max(x['worst_bound_ratio'] for x in g):.3f} of its "
                      f"bound, launches by rank "
                      f"{[x['launches'] for x in g]}, ring hops "
                      f"{[x['hops'] for x in g]}, step "
                      f"{max(x['step_s'] for x in g):.2f} s"
                      + (f", relu sign changes {[x['relu_flips'] for x in g]}"
                         f" of {g[0]['relu_units']} a rank"
                         if "relu_flips" in g[0] else ""))
                if co == "none" and name != "ref_dropout":
                    check(all(v > 0 for k, v in total.items()
                              if k.startswith("flash")),
                          f"TP {name}: a flash kernel was never launched: "
                          f"{total}")
            res[f"f32_{name}"] = rows
        res["bf16"] = dict(
            losses=[r["losses"] for r in ranks],
            step_launches=[r["step_launches"] for r in ranks],
            profile={r["rank"]: r["profile"] for r in ranks},
            stamps=ranks[0]["stamps"])
        print(f"  bf16 1F1B pipe 2 x model 2, B={TP_TIME_B}, S={TRAIN_S}: "
              f"launches by rank {res['bf16']['step_launches']}")
        for r, p in sorted(res["bf16"]["profile"].items()):
            print(f"  rank {r} profiled step: wall {p['wall_ms']:.1f} ms, "
                  f"its device busy {p['device_busy_ms']:.1f} ms, idle share "
                  f"{p['idle_share']:.3f}, {p['tp_all_reduces']} model-axis "
                  f"all-reduces {p['tp_all_reduce_ms']:.1f} ms, hand-off "
                  f"wait {p['handoff_wait_ms']:.1f} ms, posts "
                  f"{p['handoff_post_ms']:.1f} ms")
        print_world_stamps(ranks[0]["stamps"], res["bf16"]["profile"],
                           len(ranks))
        tm = ranks[0]["train_main"]
        check("resumed from" in tm["resumed"]["output"],
              f"the TP resume restored nothing:\n"
              f"{tm['resumed']['output'][-3000:]}")
        names = sorted(n for r in ranks for n in r["resume_checked"])
        check(len(names) == len(ranks), f"TP step 3's files: {names}")
        res["train_main"] = dict(
            args=TP_TRAIN_ARGS, checked=names,
            seconds={k: v["seconds"] for k, v in tm.items()},
            output={k: v["output"][-2000:] for k, v in tm.items()})
        res["world_ranks_s"] = [{k: r[k] for k in (
            "warm_s", "refs_wait_s", "gates_s", "killed_wait_s", "seconds")}
            for r in ranks]
        print(f"  train.py --pipe 2 --tp 2 --backend gloo (4 layers, S=256): "
              f"its world killed after step 1's commit at "
              f"{res['killed_world']['killed_s']:.1f} s, train.run unbroken "
              f"{tm['unbroken']['seconds']:.1f} s and resumed "
              f"{tm['resumed']['seconds']:.1f} s in this world: step 3's "
              f"{len(names)} files bitwise equal")
    finally:
        if world is not None:
            world.join()
        if killed is not None:
            killed.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t0
    print(f"  phase 11: {res['seconds']:.1f} s (the world "
          f"{res['world_s']:.1f} s)")
    report["tp"] = res
    return {r["rank"]: r["step_launches"] for r in ranks}


# FSDP and sequence parallelism (phase 14): one gloo world of 4 processes
# on the card, which makes two meshes over the same ranks: pipe 2 x data 2
# with FSDP (the launch's) and pipe 2 x seq 2. Tied GPT-2-small at full
# width and 4 of its 12 layers (cut for the script's time limit), B = 8
# sequences of 1024 tokens, 1F1B, M = 2: an FSDP rank's microbatch is
# [2, 1024] and a seq rank's [4, 512], so both heads take 2048 rows
PAR_LAYERS, PAR_B, PAR_M = 4, 8, 2
PAR_TIMED = 2  # (d)'s timed steps a world, after DIST_WARMUP
PAR_SHAPE = [PAR_B // 2 // PAR_M, TRAIN_S, 12, 64]  # an FSDP rank's q/k/v
PAR_XENT_ROWS = PAR_B // 2 // PAR_M * TRAIN_S  # the head's rows, both worlds
# (c): train.py's worlds, 3 steps each at the layers above
PAR_TRAIN_ARGS = {
    "fsdp": ["--pipe", "2", "--data", "2", "--fsdp"],
    "sp": ["--pipe", "2", "--sp", "2", "--sp-attn", "ulysses"]}
PAR_TRAIN_COMMON = ["--model", "gpt2-small", "--tie-embeddings", "--layers",
                    str(PAR_LAYERS), "--backend", "gloo", "--batch",
                    str(PAR_B), "--seq", str(TRAIN_S), "--microbatches",
                    str(PAR_M), "--steps", "3", "--flash", "on",
                    "--fused-xent"]


def par_config(bf16=False):
    """Phase 14's model: ``dist_config`` at ``PAR_LAYERS`` layers."""
    return dataclasses.replace(dist_config(bf16), n_layers=PAR_LAYERS)


def par_compare(mesh, model, ref, fsdp):
    """(loss-free) worst leaf ratio and its leaf of this rank's gradients
    against the lockstep ``ref`` (phase 4's bound): an FSDP rank's shard
    against the reference's block, each leaf's squared error and norm
    summed over the data group (a replicated leaf's from data coordinate
    0), so the ratio is the gathered leaf's."""
    import torch
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
        fsdp as tfsdp, tensor_parallel as ttp)
    dims = tfsdp.fsdp_shard_of(model).dims if fsdp else {}
    names, sq = [], []
    for n, p in model.named_parameters():
        d = dims.get(n)
        r = ttp.shard_tensor(ref["grads"][n], d, mesh.n_data,
                             mesh.data).to(p.device)
        w = 1.0 if d is not None or mesh.data == 0 or not fsdp else 0.0
        sq.append(torch.stack([(p.grad.double() - r.double()).square().sum(),
                               r.double().square().sum()]) * w)
        names.append(n)
    sq = torch.stack(sq)
    if fsdp:
        mesh.all_reduce([sq], "data")
    ratios = (sq[:, 0].sqrt() / (1e-4 * sq[:, 1].sqrt()
                                 + 1e-6 * ref["g_norm"])).tolist()
    worst = max(range(len(names)), key=lambda i: ratios[i])
    return ratios[worst], names[worst]


def par_profile(step, mesh):
    """One step under the profiler: wall, this rank's device busy, its
    idle share, the port's kernels among the device kernels, and the host
    time and count of the collectives' spans (FSDP's gathers and
    reduce-scatters, the seq ring's hops and all-to-alls, the model-axis
    all-reduces, the expert all-to-alls, the hand-offs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    mesh.barrier()
    avg = prof.key_averages()
    busy = device_busy_ms(avg)
    spans = {}
    for e in avg:
        if e.key in ("fsdp_gather", "fsdp_reduce_scatter", "sp_shift",
                     "sp_all_to_all", "tp_all_reduce", "ep_all_to_all",
                     "handoff_wait", "handoff_post"):
            spans[e.key] = dict(ms=max(spans.get(e.key, {}).get("ms", 0.0),
                                       e.cpu_time_total / 1e3),
                                count=max(spans.get(e.key, {}).get("count",
                                                                   0),
                                          e.count))
    kernels = sorted({k for e in avg if e.self_device_time_total > 0
                      for k in ("flash_fwd", "flash_bwd", "xent_fwd",
                                "xent_bwd") if k in e.key})
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy,
                idle_share=1 - busy / (wall * 1e3), spans=spans,
                port_kernels=kernels)


def par_worker(mesh, spec):
    """One rank of phase 14's world: (a) the FSDP f32 gate, (b) the ring
    and Ulysses f32 gates on the pipe 2 x seq 2 mesh over the same ranks,
    then, once ``train.py``'s worlds are done, (d) the bf16 timing of the
    plain, FSDP, ring and Ulysses worlds, one counted and one profiled
    step each. Returns this rank's numbers; raises (failing the world) at
    a gate."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import distributed_training_with_pipeline_parallelism_tpu_torch as port
    from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
        Transformer)
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
        fsdp as tfsdp)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils.config import (
        torch_dtype)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils.data import (
        batch_sharding)
    device = mesh.device
    kernels = all_kernels()
    cfg, cfg16 = par_config(), par_config(bf16=True)
    sched = port.ScheduleConfig("1F1B", PAR_M)
    t_phase = time.perf_counter()
    sp = port.make_mesh(2, 1, 1, 2, backend=mesh.backend, device=device)
    worlds = {"plain": (mesh, False, "ring"), "fsdp": (mesh, True, "ring"),
              "ring": (sp, False, "ring"), "ulysses": (sp, False, "ulysses")}
    res = dict(rank=mesh.rank, describe=mesh.describe(),
               sp_describe=sp.describe(), gates={})
    res["warm_s"] = dist_warm((cfg, cfg16), device,
                              (PAR_B // 2 // PAR_M, TRAIN_S))
    res["refs_wait_s"] = wait_for(spec["ready"], "phase 14's references")
    whole = torch.load(spec["whole"], mmap=True, weights_only=True)
    ref = torch.load(spec["ref"], mmap=True, weights_only=True)
    batch = tuple(t.to(device) for t in torch.load(spec["batch"],
                                                   weights_only=True))

    def model_of(c, w):
        m, fsdp, _ = worlds[w]
        own = port.owned_layers(c.n_layers, sched, m.n_pipe, m.pipe)
        v = Transformer(c, device=device, dtype=torch_dtype(c.storage_dtype),
                        layers=own)
        v.load_state_dict({k: whole[k] for k in v.state_dict()})
        return tfsdp.fsdp_shard_params(v, c, m) if fsdp else v

    def counted(fn):
        torch.cuda.synchronize()
        for k in kernels:
            k.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, {k.name: k.launches for k in kernels}

    # (a)-(b): the f32 gates against the lockstep process's step
    for w in ("fsdp", "ring", "ulysses"):
        m, fsdp, impl = worlds[w]
        model = model_of(cfg, w)
        local = batch_sharding(m)(batch)
        fn = port.make_pipeline_grad_fn(cfg, sched, m.n_pipe, device=device,
                                        mesh=m, fsdp=fsdp, sp_attn_impl=impl)
        t = time.perf_counter()
        loss, launches = counted(lambda: fn(model, *local).item())
        wall = time.perf_counter() - t
        rel = abs(loss - ref["loss"]) / abs(ref["loss"])
        worst, leaf = par_compare(m, model, ref, fsdp)
        want = rank_launches(cfg, sched, m.n_pipe, m.pipe)
        if not fsdp:  # the seq worlds' attention calls no kernel
            want.update(flash_fwd=0, flash_bwd=0)
        g = dict(loss=loss, loss_rel_err=rel, worst_bound_ratio=worst,
                 worst_leaf=leaf, launches=launches, step_s=wall)
        if fsdp:  # the rank's layer matrices against its stage's
            mats = [(n, p) for n, p in model.named_parameters()
                    if n.startswith("layers.") and p.dim() == 2]
            g["held_bytes"] = sum(p.numel() * p.element_size()
                                  for _, p in mats)
            g["stage_bytes"] = sum(whole[n].numel() * whole[n].element_size()
                                   for n, _ in mats)
            g["grad_bytes"] = sum(p.grad.numel() * p.grad.element_size()
                                  for _, p in mats)
            check(2 * g["held_bytes"] == g["stage_bytes"] == 2 * g[
                "grad_bytes"], f"FSDP rank {mesh.rank}: its layer matrices "
                  f"hold {g['held_bytes']} B (gradients {g['grad_bytes']} B) "
                  f"of its stage's {g['stage_bytes']} B, not a half")
        res["gates"][w] = g
        check(rel <= 1e-5, f"{w} rank {mesh.rank}: loss rel err {rel} > 1e-5")
        check(worst <= 1.0, f"{w} rank {mesh.rank}: leaf {leaf} over its "
              f"bound ({worst})")
        check(launches == want, f"{w} rank {mesh.rank}: launches {launches} "
              f"!= the table's {want}")
        del model
        torch.cuda.empty_cache()
    res["gates_s"] = time.perf_counter() - t_phase
    res["train_wait_s"] = wait_for(spec["train_done"],
                                   "the train.py worlds' end")
    mesh.barrier()

    # (d) bf16 timing, then one counted and one profiled step a world
    res["bf16"] = {}
    for w in ("plain", "fsdp", "ring", "ulysses"):
        m, fsdp, impl = worlds[w]
        model = model_of(cfg16, w)
        opt = port.adamw(warmup_steps=2, total_steps=100)
        state = opt.init(model)
        step = port.make_train_step(cfg16, sched, m.n_pipe, opt,
                                    device=device, mesh=m, fsdp=fsdp,
                                    sp_attn_impl=impl)
        local = batch_sharding(m)(batch)

        def run(mdl, t, y):
            return step(mdl, state, t, y)

        timed = port.run_train_iterations(
            run, model, *local, num_iterations=PAR_TIMED,
            warmup_iterations=DIST_WARMUP, mesh=m)
        loss, launches = counted(lambda: run(model, *local).item())
        check(math.isfinite(loss), f"{w} bf16 rank {mesh.rank}: loss {loss}")
        prof = par_profile(lambda: run(model, *local), m)
        res["bf16"][w] = dict(tokens_per_s=timed["throughput"], loss=loss,
                              launches=launches, profile=prof)
        del model, state
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    return res


def phase_par(report, device="cuda"):
    """FSDP and sequence parallelism (see the module doc): the references
    and ``train.py``'s two worlds here, beside the world of 4 processes
    that runs the gates and the timing. Returns each world's launches of
    its counted f32 and bf16 steps, by rank."""
    import shutil
    import tempfile
    import torch
    import distributed_training_with_pipeline_parallelism_tpu_torch as port
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-par-")
    spec = {k: str(Path(tmp) / k) for k in ("whole", "ref", "batch", "ready",
                                            "train_done")}
    res, box, world, trainer = {}, {}, None, None

    def run_world():
        try:
            box["ranks"] = port.launch(par_worker, port.MeshConfig(2, 2),
                                       spec, backend="gloo", device=device,
                                       timeout_s=300)
        except BaseException as e:  # re-raised by the phase
            box["error"] = e

    def train_worlds():
        """``train.py``'s FSDP world and its Ulysses world, at once."""
        t = time.perf_counter()
        procs = {name: subprocess.Popen(
            [sys.executable, "-m", f"{PKG}.train", *PAR_TRAIN_COMMON, *args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True) for name, args in PAR_TRAIN_ARGS.items()}
        status = "ok"
        res["train_main"] = {}
        for name, proc in procs.items():
            try:
                out, _ = proc.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, _ = proc.communicate()
            final = [ln for ln in out.splitlines()
                     if ln.startswith("final loss:")]
            loss = float(final[-1].split(":")[1]) if final else math.nan
            res["train_main"][name] = dict(
                rc=proc.returncode, final_loss=loss,
                seconds=time.perf_counter() - t, output=out[-2000:])
            if status == "ok" and (proc.returncode != 0
                                   or not math.isfinite(loss)):
                status = f"train.py {name}: rc {proc.returncode}, {out[-3000:]}"
        signal_file(spec["train_done"], status)

    try:
        cfg = par_config()
        g = torch.Generator().manual_seed(SEED + 2)
        batch = tuple(torch.randint(0, cfg.vocab_size, (PAR_B, TRAIN_S),
                                    generator=g) for _ in range(2))
        torch.save(batch, spec["batch"])
        model = port.init_params(cfg, torch.Generator().manual_seed(SEED),
                                 device)
        torch.save({n: t.cpu() for n, t in model.state_dict().items()},
                   spec["whole"])
        world = threading.Thread(target=run_world)
        world.start()
        trainer = threading.Thread(target=train_worlds)
        trainer.start()
        t = time.perf_counter()
        try:
            fn = port.make_pipeline_grad_fn(
                cfg, port.ScheduleConfig("1F1B", PAR_M), 2, device=device)
            loss = fn(model, *(x.to(device) for x in batch)).item()
            grads = {n: p.grad.detach().cpu()
                     for n, p in model.named_parameters()}
            g_norm = math.sqrt(sum((x.double() ** 2).sum().item()
                                   for x in grads.values()))
            torch.save({"grads": grads, "loss": loss, "g_norm": g_norm},
                       spec["ref"])
            res["lockstep_loss"] = loss
            del model, grads, fn
            torch.cuda.empty_cache()
            signal_file(spec["ready"], "ok")
        except BaseException as e:
            signal_file(spec["ready"], f"the launcher failed: {e!r}")
            raise
        res["refs_s"] = time.perf_counter() - t
        trainer.join()
        world.join()
        if "error" in box:
            raise box["error"]
        check(Path(spec["train_done"]).read_text() == "ok",
              Path(spec["train_done"]).read_text())
        ranks = box["ranks"]
        res["world_s"] = time.perf_counter() - t0
        for r in ranks:
            check(r["describe"]["transport"] == "gloo-staged",
                  f"rank {r['rank']}: {r['describe']}")
        print(f"  rank 0: {ranks[0]['describe']}; its seq mesh "
              f"{ranks[0]['sp_describe']['shape']}")
        for w in ("fsdp", "ring", "ulysses"):
            gs = [r["gates"][w] for r in ranks]
            total = {k: sum(x["launches"][k] for x in gs)
                     for k in gs[0]["launches"]}
            need = (("flash_fwd", "flash_bwd", "xent_fwd", "xent_bwd")
                    if w == "fsdp" else ("xent_fwd", "xent_bwd"))
            check(all(total[k] > 0 for k in need),
                  f"{w}: a kernel of its path was never launched: {total}")
            print(f"  f32 {w} (1F1B, B={PAR_B}, S={TRAIN_S}, "
                  f"{PAR_LAYERS} layers): loss {gs[0]['loss']:.6f} (rel err "
                  f"{max(x['loss_rel_err'] for x in gs):.2e} vs lockstep "
                  f"{res['lockstep_loss']:.6f}), worst leaf at "
                  f"{max(x['worst_bound_ratio'] for x in gs):.3f} of its "
                  f"bound, launches by rank {[x['launches'] for x in gs]}"
                  + (f", layer matrices {gs[0]['held_bytes']} of "
                     f"{gs[0]['stage_bytes']} B a rank" if w == "fsdp"
                     else ""))
            res[f"f32_{w}"] = gs
        res["bf16"] = {}
        for w in ("plain", "fsdp", "ring", "ulysses"):
            rows = [r["bf16"][w] for r in ranks]
            tps = [x["tokens_per_s"] for x in rows]
            res["bf16"][w] = dict(tokens_per_s=tps[0], by_rank=tps,
                                  launches=[x["launches"] for x in rows],
                                  profile=[x["profile"] for x in rows])
            p = rows[0]["profile"]
            spans = ", ".join(f"{k} {v['count']} x {v['ms']:.1f} ms"
                              for k, v in sorted(p["spans"].items()))
            print(f"  bf16 {w}: {tps[0]:.1f} tokens/s; rank 0 profiled: wall "
                  f"{p['wall_ms']:.1f} ms, idle share {p['idle_share']:.3f}, "
                  f"port kernels {p['port_kernels']}; {spans}")
        kern = sorted({k for r in ranks for k in
                       r["bf16"]["fsdp"]["profile"]["port_kernels"]})
        check(kern == ["flash_bwd", "flash_fwd", "xent_bwd", "xent_fwd"],
              f"FSDP bf16: the profiler saw the port's kernels {kern}")
        for name, t in res["train_main"].items():
            print(f"  train.py {' '.join(PAR_TRAIN_ARGS[name])}: rc "
                  f"{t['rc']}, final loss {t['final_loss']:.4f}, "
                  f"{t['seconds']:.1f} s")
        res["world_ranks_s"] = [{k: r[k] for k in (
            "warm_s", "refs_wait_s", "gates_s", "train_wait_s", "seconds")}
            for r in ranks]
    finally:
        for th in (world, trainer):
            if th is not None:
                th.join()
        shutil.rmtree(tmp, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t0
    print(f"  phase 14: {res['seconds']:.1f} s")
    report["par"] = res
    return {w: {r["rank"]: r["gates"][w]["launches"] for r in ranks}
            for w in ("fsdp", "ring", "ulysses")}


# Pipelined batch inference and Mixture-of-Experts (phase 15). The forward:
# tied GPT-2-small at full width and depth, B = 8 sequences of 1024 tokens,
# D = 4, M = 4 on the lockstep transport, then pipe 2 x data 2 in a world
# (V = 1, M = 2). MoE: the same widths at 4 of the 12 layers (cut for the
# script's time limit), E = 8, top-2, capacity 1.25, aux 0.01, expert ffn
# 3072, B = 4, 1F1B at D = 2, M = 2 (a microbatch routes 2048 tokens into
# C = 640 slots an expert); the world's pipe 2 x expert 2 step at capacity
# E and aux 0, where it equals the lockstep step
FWD_D, FWD_M, FWD_B, FWD_WORLD_M = 4, 4, 8, 2
FWD_TIMED = 3  # (a)'s timed bf16 forward calls, after one warm-up
MOE_LAYERS, MOE_B, MOE_M = 4, 4, 2
MOE_FIELDS = dict(n_experts=8, top_k=2, capacity_factor=1.25,
                  aux_loss_weight=0.01, ffn_dim=3072)
MOE_EP_FIELDS = dict(MOE_FIELDS, capacity_factor=8.0, aux_loss_weight=0.0)
MOE_TIMED = 2  # (b) and (c)'s timed bf16 steps, after DIST_WARMUP
MOE_SPANS = ("moe_route", "moe_dispatch", "moe_experts", "moe_combine")
# (d): train.py, 3 steps each at the layers above, lockstep and as a world
MOE_TRAIN_COMMON = ["--model", "gpt2-small", "--tie-embeddings", "--layers",
                    str(MOE_LAYERS), "--batch", str(MOE_B), "--seq",
                    str(TRAIN_S), "--microbatches", str(MOE_M), "--steps",
                    "3", "--fused-xent", "--moe-experts", "8"]
MOE_TRAIN_ARGS = {"lockstep": ["--pipe", "2"],
                  "ep": ["--pipe", "2", "--ep", "2", "--backend", "gloo"]}


def moe_setup(bf16=False, ep=False):
    """(cfg, moe) of phase 15's MoE model: ``dist_config`` at
    ``MOE_LAYERS`` layers; (c)'s routing (capacity E, aux 0) with ``ep``."""
    from distributed_training_with_pipeline_parallelism_tpu_torch import (
        MoEConfig)
    cfg = dataclasses.replace(dist_config(bf16), n_layers=MOE_LAYERS)
    return cfg, MoEConfig(**(MOE_EP_FIELDS if ep else MOE_FIELDS))


def counted_launches(fn):
    """``fn()``'s result and each kernel's launches during it (the
    wrappers' counters, set to 0 just before)."""
    import torch
    kernels = all_kernels()
    torch.cuda.synchronize()
    for k in kernels:
        k.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k.name: k.launches for k in kernels}


# spin kernels that open and close a trace of profiled_launches
TRACE_EDGE = 256


def profiled_launches(fn, want):
    """How many times the profiler saw each of the port's kernels run in
    one call of ``fn``, from the first whole trace of up to five: the
    first that shows ``want``, else the last whole one. Fails if none is
    whole. On the H100 host CUPTI drops records at the edges of a trace
    once other processes have used the card: the first few records of
    most traces (4 of 48 ``flash_fwd`` launches in phase 15, in every
    trace of a run), and now and then all records after some point.
    So ``fn`` runs between ``TRACE_EDGE`` spin kernels on each side, and
    a trace is whole only if its first record is a spin kernel and its
    last ``TRACE_EDGE`` records are: whatever was lost at an edge was
    spin kernels, not ``fn``'s."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def edge():
        for _ in range(TRACE_EDGE):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()

    whole = None
    for _ in range(5):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            edge()
            fn()
            torch.cuda.synchronize()
            edge()
        names = [e.name for e in sorted(
            (e for e in prof.events() if e.device_type == DeviceType.CUDA),
            key=lambda e: e.time_range.start)]
        spin = ["spin_kernel" in n for n in names]
        if not (spin and spin[0] and len(spin) > TRACE_EDGE
                and all(spin[-TRACE_EDGE:])):
            continue
        whole = {k.name: sum(k.name in n for n in names)
                 for k in all_kernels()}
        if whole == want:
            break
    check(whole is not None, "the profiler kept no whole trace of five")
    return whole


def moe_profile(step, mesh=None):
    """One call of ``step`` under the profiler: wall, device busy (the
    device's own events), idle share, the top kernels, the device ms of
    the kernels launched inside each MoE FFN range (the forwards'; the
    backward's kernels run outside them) and the host ms and count of
    the expert all-to-alls' and hand-offs' spans."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    if mesh is not None:
        mesh.barrier()
    from torch.autograd import DeviceType
    avg = prof.key_averages()
    # the device's own events (kernels, copies), not the host ops that
    # launched them nor the ranges' device-side spans
    kern = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in avg if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0 and e.key not in RANGES),
                  key=lambda x: -x[1])
    busy = device_busy_ms(avg)
    ranges, spans = {}, {}
    for e in avg:
        if e.key in MOE_SPANS and e.device_type == DeviceType.CPU:
            # the kernels launched inside the host range
            ranges[e.key] = e.device_time_total / 1e3
        if e.key in ("ep_all_to_all", "handoff_wait", "handoff_post"):
            spans[e.key] = dict(ms=max(spans.get(e.key, {}).get("ms", 0.0),
                                       e.cpu_time_total / 1e3),
                                count=max(spans.get(e.key, {}).get("count",
                                                                   0),
                                          e.count))
    share = (ranges.get("moe_dispatch", 0.0)
             + ranges.get("moe_combine", 0.0)) / max(busy, 1e-9)
    return dict(wall_ms=wall * 1e3, device_busy_ms=busy,
                idle_share=1 - busy / (wall * 1e3), range_device_ms=ranges,
                dispatch_combine_share=share, spans=spans,
                top_kernels=[dict(name=n[:120], ms=ms, count=c)
                             for n, ms, c in kern[:10]])


def moe_leaf_ratio(mesh, model, ref):
    """Worst leaf ratio (phase 4's bound) of this rank's MoE gradients
    against the lockstep ``ref``: an expert stack's block against the
    reference's block, each leaf's squared error and norm summed over the
    expert group (any other leaf's from expert coordinate 0), so the
    ratio is the whole leaf's. Returns (ratio, leaf)."""
    import torch
    from distributed_training_with_pipeline_parallelism_tpu_torch.models.moe import (
        expert_block, is_expert_leaf)
    names, sq = [], []
    for n, p in model.named_parameters():
        r = expert_block(n, ref["grads"][n], model.expert).to(p.device)
        w = 1.0 if mesh.expert == 0 or is_expert_leaf(n) else 0.0
        sq.append(torch.stack([(p.grad.double() - r.double()).square().sum(),
                               r.double().square().sum()]) * w)
        names.append(n)
    sq = torch.stack(sq)
    mesh.all_reduce([sq], "expert")
    ratios = (sq[:, 0].sqrt() / (1e-4 * sq[:, 1].sqrt()
                                 + 1e-6 * ref["g_norm"])).tolist()
    worst = max(range(len(names)), key=lambda i: ratios[i])
    return ratios[worst], names[worst]


def moe_worker(mesh, spec):
    """One rank of phase 15's world (pipe 2 x expert 2, and pipe 2 x data 2
    over the same ranks): (a) the forward's world gate, (c) the f32 EP
    gate, then, once the launcher's lockstep timing is done, (c)'s bf16
    timing and one profiled step. Returns this rank's numbers; raises
    (failing the world) at a gate."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import distributed_training_with_pipeline_parallelism_tpu_torch as port
    from distributed_training_with_pipeline_parallelism_tpu_torch.models.moe import (
        MoELM, is_expert_leaf)
    from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
        Transformer)
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel.expert_parallel import (
        ep_shard_state)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils.config import (
        torch_dtype)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils.data import (
        batch_sharding)
    device = mesh.device
    t_phase = time.perf_counter()
    fwd_mesh = port.make_mesh(2, 2, backend=mesh.backend, device=device)
    res = dict(rank=mesh.rank, describe=mesh.describe(),
               fwd_describe=fwd_mesh.describe())
    cfg = dist_config()
    res["warm_s"] = dist_warm((cfg,), device,
                              (FWD_B // 2 // FWD_WORLD_M, TRAIN_S))
    res["refs_wait_s"] = wait_for(spec["ready"], "phase 15's references")

    def dense(layers=None):
        whole = torch.load(spec["whole"], mmap=True, weights_only=True)
        m = Transformer(cfg, device=device,
                        dtype=torch_dtype(cfg.storage_dtype), layers=layers)
        m.load_state_dict({k: whole[k] for k in m.state_dict()})
        return m

    # (a) the forward over pipe 2 x data 2 against the lockstep forward of
    # this rank's rows, on the same microbatches
    fsched = port.ScheduleConfig("GPipe", FWD_WORLD_M)
    tokens = batch_sharding(fwd_mesh)(
        (torch.load(spec["fwd_tokens"], weights_only=True),))[0].to(device)
    view = dense(port.owned_layers(cfg.n_layers, fsched, 2, fwd_mesh.pipe))
    fwd = port.make_pipeline_forward(cfg, fsched, 2, device=device,
                                     mesh=fwd_mesh)
    logits, launches = counted_launches(lambda: fwd(view, tokens))
    del view
    full = dense()
    ref = port.make_pipeline_forward(cfg, fsched, 2, device=device)(full,
                                                                    tokens)
    rel = ((logits - ref).abs().max() / ref.abs().max()).item()
    want = {"flash_fwd": cfg.n_layers // 2 * FWD_WORLD_M, "flash_bwd": 0,
            "xent_fwd": 0, "xent_bwd": 0}
    res["forward"] = dict(rel_err=rel, launches=launches,
                          shape=list(logits.shape))
    check(rel <= 1e-5, f"forward world rank {mesh.rank}: logits rel err "
          f"{rel} > 1e-5 of the lockstep forward's")
    check(launches == want, f"forward world rank {mesh.rank}: launches "
          f"{launches} != {want}")
    del logits, ref, full
    torch.cuda.empty_cache()

    # (c) the f32 EP step against the lockstep step on the same weights
    cfg_m, moe = moe_setup(ep=True)
    sched = port.ScheduleConfig("1F1B", MOE_M)
    moe_whole = torch.load(spec["moe_whole"], mmap=True, weights_only=True)
    ref = torch.load(spec["moe_ref"], mmap=True, weights_only=True)
    batch = batch_sharding(mesh)(tuple(
        t.to(device) for t in torch.load(spec["batch"], weights_only=True)))

    def moe_model(c):
        m = MoELM(c, moe, device=device, dtype=torch_dtype(c.storage_dtype),
                  layers=port.owned_layers(MOE_LAYERS, sched, 2, mesh.pipe),
                  expert=(mesh.n_expert, mesh.expert))
        m.load_state_dict(ep_shard_state(
            {k: moe_whole[k] for k in m.state_dict()}, m.expert))
        return m

    model = moe_model(cfg_m)
    fn = port.make_pipeline_grad_fn(cfg_m, sched, 2, device=device,
                                    mesh=mesh, moe=moe)
    a2a = mesh.a2a
    t = time.perf_counter()
    loss, launches = counted_launches(lambda: fn(model, *batch).item())
    step_s = time.perf_counter() - t
    n_a2a = mesh.a2a - a2a
    rel = abs(loss - ref["loss"]) / abs(ref["loss"])
    worst, leaf = moe_leaf_ratio(mesh, model, ref)
    experts = [(n, p) for n, p in model.named_parameters()
               if is_expert_leaf(n)]
    held = sum(p.numel() * p.element_size() for _, p in experts)
    stage = sum(moe_whole[n].numel() * moe_whole[n].element_size()
                for n, _ in experts)
    lps = MOE_LAYERS // 2
    last = mesh.pipe == 1
    want = {"flash_fwd": 0, "flash_bwd": 0, "xent_fwd": MOE_M * last,
            "xent_bwd": MOE_M * last}
    res["ep"] = dict(loss=loss, loss_rel_err=rel, worst_bound_ratio=worst,
                     worst_leaf=leaf, launches=launches, all_to_alls=n_a2a,
                     expert_bytes=held, stage_expert_bytes=stage,
                     step_s=step_s)
    check(rel <= 1e-5, f"EP rank {mesh.rank}: loss rel err {rel} > 1e-5")
    check(worst <= 1.0, f"EP rank {mesh.rank}: leaf {leaf} over its bound "
          f"({worst})")
    check(2 * held == stage, f"EP rank {mesh.rank}: its expert stacks hold "
          f"{held} B of its stage's {stage} B, not a half")
    check(launches == want, f"EP rank {mesh.rank}: launches {launches} != "
          f"{want}")
    # each MoE layer of a unit: 2 in the forward, 2 recomputed and 2
    # transposed in the backward
    check(n_a2a == MOE_M * lps * 6, f"EP rank {mesh.rank}: {n_a2a} expert "
          f"all-to-alls, not {MOE_M * lps * 6}")
    del model
    torch.cuda.empty_cache()
    res["gates_s"] = time.perf_counter() - t_phase
    mesh.barrier()
    if mesh.rank == 0:
        signal_file(spec["gates_done"], "ok")
    res["lock_wait_s"] = wait_for(spec["lock_done"],
                                  "phase 15's lockstep timing")

    # (c) bf16 over f32 masters: timed steps, one counted, one profiled
    cfg16, _ = moe_setup(bf16=True, ep=True)
    model = moe_model(cfg16)
    opt = port.adamw(warmup_steps=2, total_steps=100)
    state = opt.init(model)
    step = port.make_train_step(cfg16, sched, 2, opt, device=device,
                                mesh=mesh, moe=moe)

    def run(m, t, y):
        return step(m, state, t, y)

    timed = port.run_train_iterations(run, model, *batch,
                                      num_iterations=MOE_TIMED,
                                      warmup_iterations=DIST_WARMUP,
                                      mesh=mesh)
    loss, launches = counted_launches(lambda: run(model, *batch).item())
    check(math.isfinite(loss), f"EP bf16 rank {mesh.rank}: loss {loss}")
    res["bf16"] = dict(tokens_per_s=timed["throughput"], loss=loss,
                       launches=launches,
                       profile=moe_profile(lambda: run(model, *batch),
                                           mesh))
    res["seconds"] = time.perf_counter() - t_phase
    return res


def phase_fwd_moe(report, device="cuda"):
    """Pipelined batch inference and MoE (see the module doc): the
    lockstep gates and timing here, ``train.py``'s two runs and a world of
    4 processes beside them. Returns the launches of each counted path
    (the world's by rank)."""
    import copy
    import shutil
    import tempfile
    import torch
    import distributed_training_with_pipeline_parallelism_tpu_torch as port
    from distributed_training_with_pipeline_parallelism_tpu_torch.models.moe import (
        moe_init_params, moe_lm_loss)
    from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
        transformer_apply)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-moe-")
    spec = {k: str(Path(tmp) / k) for k in (
        "whole", "fwd_tokens", "moe_whole", "moe_ref", "batch", "ready",
        "gates_done", "lock_done", "train_done")}
    res, box, world, trainer = {}, {}, None, None
    out = {}

    def run_world():
        try:
            box["ranks"] = port.launch(moe_worker,
                                       port.MeshConfig(2, 1, 1, 1, 2), spec,
                                       backend="gloo", device=device,
                                       timeout_s=300)
        except BaseException as e:  # re-raised by the phase
            box["error"] = e

    def train_runs():
        """``train.py``'s lockstep MoE run and its pipe 2 x expert 2
        world, at once."""
        t = time.perf_counter()
        procs = {name: subprocess.Popen(
            [sys.executable, "-m", f"{PKG}.train", *MOE_TRAIN_COMMON, *args],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            start_new_session=True) for name, args in MOE_TRAIN_ARGS.items()}
        status = "ok"
        res["train_main"] = {}
        for name, proc in procs.items():
            try:
                text, _ = proc.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                proc.kill()
                text, _ = proc.communicate()
            final = [ln for ln in text.splitlines()
                     if ln.startswith("final loss:")]
            loss = float(final[-1].split(":")[1]) if final else math.nan
            res["train_main"][name] = dict(
                rc=proc.returncode, final_loss=loss,
                seconds=time.perf_counter() - t, output=text[-2000:])
            if status == "ok" and (proc.returncode != 0
                                   or not math.isfinite(loss)):
                status = (f"train.py {name}: rc {proc.returncode}, "
                          f"{text[-3000:]}")
        signal_file(spec["train_done"], status)

    try:
        # the world's inputs: the dense and MoE weights, the batches
        cfg = dist_config()
        model = port.init_params(cfg, torch.Generator().manual_seed(SEED),
                                 device)
        torch.save({n: t.cpu() for n, t in model.state_dict().items()},
                   spec["whole"])
        g = torch.Generator().manual_seed(SEED + 3)
        fwd_tokens = torch.randint(0, cfg.vocab_size, (FWD_B, TRAIN_S),
                                   generator=g)
        torch.save(fwd_tokens, spec["fwd_tokens"])
        batch = tuple(torch.randint(0, cfg.vocab_size, (MOE_B, TRAIN_S),
                                    generator=g) for _ in range(2))
        torch.save(batch, spec["batch"])
        batch = tuple(x.to(device) for x in batch)
        cfg_m, moe = moe_setup()
        moe_model = moe_init_params(cfg_m, moe,
                                    torch.Generator().manual_seed(SEED),
                                    device)
        torch.save({n: t.cpu() for n, t in moe_model.state_dict().items()},
                   spec["moe_whole"])
        # (a) the lockstep forward, f32, against single-device
        # transformer_apply; K4 only, M * L launches; counted by the
        # profiler too, before the world and train.py share the card
        fwd = port.make_pipeline_forward(
            cfg, port.ScheduleConfig("GPipe", FWD_M), FWD_D, device=device)
        tokens = fwd_tokens.to(device)
        want = {"flash_fwd": FWD_M * cfg.n_layers, "flash_bwd": 0,
                "xent_fwd": 0, "xent_bwd": 0}
        logits, launches = counted_launches(lambda: fwd(model, tokens))
        by_profiler = profiled_launches(lambda: fwd(model, tokens), want)
        with torch.no_grad():
            ref = transformer_apply(cfg, model, tokens)
        rel = ((logits - ref).abs().max() / ref.abs().max()).item()
        res["forward"] = dict(rel_err=rel, launches=launches,
                              profiler_launches=by_profiler,
                              shape=list(logits.shape))
        print(f"  (a) f32 forward (D={FWD_D}, M={FWD_M}, B={FWD_B}, "
              f"S={TRAIN_S}): logits {list(logits.shape)}, max err "
              f"{rel:.2e} of max |logits| against transformer_apply; "
              f"launches {launches}, by the profiler {by_profiler}")
        check(rel <= 1e-5, f"forward: logits rel err {rel} > 1e-5")
        check(launches == want and by_profiler == want,
              f"forward: launches {launches}, by the profiler "
              f"{by_profiler}, not {want}")
        out["forward"] = launches
        del logits, ref, model, fwd
        torch.cuda.empty_cache()

        world = threading.Thread(target=run_world)
        world.start()
        trainer = threading.Thread(target=train_runs)
        trainer.start()
        sched = port.ScheduleConfig("1F1B", MOE_M)
        try:  # (c)'s reference: the lockstep step at capacity E, aux 0
            _, moe_ep = moe_setup(ep=True)
            ref_model = copy.deepcopy(moe_model)
            loss = port.make_pipeline_grad_fn(
                cfg_m, sched, 2, device=device, moe=moe_ep)(
                ref_model, *batch).item()
            grads = {n: p.grad.detach().cpu()
                     for n, p in ref_model.named_parameters()}
            g_norm = math.sqrt(sum((x.double() ** 2).sum().item()
                                   for x in grads.values()))
            torch.save({"grads": grads, "loss": loss, "g_norm": g_norm},
                       spec["moe_ref"])
            res["ep_lockstep_loss"] = loss
            del ref_model, grads
            torch.cuda.empty_cache()
            signal_file(spec["ready"], "ok")
        except BaseException as e:
            signal_file(spec["ready"], f"the launcher failed: {e!r}")
            raise

        # (b) the lockstep MoE step, f32, against the per-microbatch oracle
        # on the plain versions
        moe_model.zero_grad(set_to_none=True)
        plain = copy.deepcopy(moe_model)
        fn = port.make_pipeline_grad_fn(cfg_m, sched, 2, device=device,
                                        moe=moe)
        loss, launches = counted_launches(lambda: fn(moe_model,
                                                     *batch).item())
        grads = {n: p.grad.detach() for n, p in moe_model.named_parameters()}
        cfg_plain = dataclasses.replace(cfg_m, use_fused_xent=False,
                                        use_flash_attention=False)
        toks, tgts = (x.view(MOE_M, -1, TRAIN_S) for x in batch)
        ref_loss = sum(moe_lm_loss(cfg_plain, moe, plain, toks[m], tgts[m])
                       for m in range(MOE_M)) / MOE_M
        ref_loss.backward()
        rel = abs(loss - ref_loss.item()) / abs(ref_loss.item())
        worst, leaf, worst_rel = grad_errors(
            grads, {n: p.grad for n, p in plain.named_parameters()})
        want = {"flash_fwd": 0, "flash_bwd": 0, "xent_fwd": MOE_M,
                "xent_bwd": MOE_M}
        res["moe"] = dict(loss=loss, loss_rel_err=rel,
                          worst_bound_ratio=worst, worst_leaf=leaf,
                          worst_rel_err=worst_rel, launches=launches)
        print(f"  (b) f32 MoE 1F1B (D=2, M={MOE_M}, B={MOE_B}, "
              f"{MOE_LAYERS} layers, E={moe.n_experts}, top-{moe.top_k}, "
              f"C={moe.capacity(MOE_B // MOE_M * TRAIN_S)}): loss "
              f"{loss:.6f} (rel err {rel:.2e}), worst leaf {leaf} at "
              f"{worst:.3f} of its bound; launches {launches}")
        check(rel <= 1e-5, f"MoE: loss rel err {rel} > 1e-5")
        check(worst <= 1.0, f"MoE: leaf {leaf} over its bound ({worst})")
        check(launches == want, f"MoE: launches {launches} != {want}")
        out["moe"] = launches
        del plain, grads, ref_loss, moe_model, fn
        torch.cuda.empty_cache()

        # the timing waits for train.py's runs and the world's gates
        trainer.join()
        check(Path(spec["train_done"]).read_text() == "ok",
              Path(spec["train_done"]).read_text())
        t = time.perf_counter()
        while not Path(spec["gates_done"]).exists() and world.is_alive():
            time.sleep(0.05)
        if "error" in box:
            raise box["error"]
        res["gates_wait_s"] = wait_for(spec["gates_done"],
                                       "the world's gates")
        try:
            cfg16 = dist_config(bf16=True)
            model16 = port.init_params(cfg16,
                                       torch.Generator().manual_seed(SEED),
                                       device)
            fwd16 = port.make_pipeline_forward(
                cfg16, port.ScheduleConfig("GPipe", FWD_M), FWD_D,
                device=device)
            fwd16(model16, tokens)
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(FWD_TIMED):
                fwd16(model16, tokens)
            torch.cuda.synchronize()
            res["forward"]["bf16_tokens_per_s"] = (
                FWD_B * TRAIN_S * FWD_TIMED / (time.perf_counter() - t))
            del model16, fwd16
            torch.cuda.empty_cache()
            cfg_m16, _ = moe_setup(bf16=True)
            m16 = moe_init_params(cfg_m16, moe,
                                  torch.Generator().manual_seed(SEED),
                                  device)
            opt = port.adamw(warmup_steps=2, total_steps=100)
            state = opt.init(m16)
            step = port.make_train_step(cfg_m16, sched, 2, opt,
                                        device=device, moe=moe)

            def run(m, t, y):
                return step(m, state, t, y)

            torch.cuda.reset_peak_memory_stats()
            timed = port.run_train_iterations(
                run, m16, *batch, num_iterations=MOE_TIMED,
                warmup_iterations=DIST_WARMUP)
            res["moe"]["bf16_tokens_per_s"] = timed["throughput"]
            res["moe"]["bf16_peak_bytes"] = torch.cuda.max_memory_allocated()
            res["moe"]["bf16_profile"] = moe_profile(lambda: run(m16,
                                                                 *batch))
            del m16, state, step
            torch.cuda.empty_cache()
            signal_file(spec["lock_done"], "ok")
        except BaseException as e:
            signal_file(spec["lock_done"], f"the launcher failed: {e!r}")
            raise
        world.join()
        if "error" in box:
            raise box["error"]
        ranks = box["ranks"]
        for r in ranks:
            check(r["describe"]["transport"] == "gloo-staged",
                  f"rank {r['rank']}: {r['describe']}")
        print(f"  rank 0: {ranks[0]['describe']}; its forward mesh "
              f"{ranks[0]['fwd_describe']['shape']}")
        fw = [r["forward"] for r in ranks]
        print(f"  (a) pipe 2 x data 2 forward: worst logits err "
              f"{max(x['rel_err'] for x in fw):.2e} of the lockstep "
              f"forward's, launches by rank {[x['launches'] for x in fw]}; "
              f"bf16 lockstep {res['forward']['bf16_tokens_per_s']:.1f} "
              f"tokens/s")
        p = res["moe"]["bf16_profile"]
        print(f"  (b) bf16 MoE: {res['moe']['bf16_tokens_per_s']:.1f} "
              f"tokens/s, allocator peak {res['moe']['bf16_peak_bytes']} B; "
              f"profiled: wall {p['wall_ms']:.1f} ms, idle share "
              f"{p['idle_share']:.3f}, forward dispatch + combine "
              f"{p['dispatch_combine_share']:.3f} of the device time "
              f"({ {k: round(v, 3) for k, v in p['range_device_ms'].items()} }"
              f" ms)")
        for k in p["top_kernels"][:8]:
            print(f"    {k['ms']:9.3f} ms  {k['count']:6d}x  "
                  f"{k['name'][:90]}")
        ep = [r["ep"] for r in ranks]
        print(f"  (c) f32 pipe 2 x expert 2 (C = E, aux 0): loss "
              f"{ep[0]['loss']:.6f} (rel err "
              f"{max(x['loss_rel_err'] for x in ep):.2e} vs lockstep "
              f"{res['ep_lockstep_loss']:.6f}), worst leaf at "
              f"{max(x['worst_bound_ratio'] for x in ep):.3f} of its bound, "
              f"expert stacks {ep[0]['expert_bytes']} of "
              f"{ep[0]['stage_expert_bytes']} B a rank, "
              f"{ep[0]['all_to_alls']} all-to-alls a step, launches by rank "
              f"{[x['launches'] for x in ep]}")
        b = [r["bf16"] for r in ranks]
        sp = b[0]["profile"]["spans"]
        print(f"  (c) bf16 pipe 2 x expert 2: {b[0]['tokens_per_s']:.1f} "
              f"tokens/s beside lockstep "
              f"{res['moe']['bf16_tokens_per_s']:.1f}; rank 0 profiled: "
              f"wall {b[0]['profile']['wall_ms']:.1f} ms, "
              + ", ".join(f"{k} {v['count']} x {v['ms']:.1f} ms"
                          for k, v in sorted(sp.items())))
        for name, tr in res["train_main"].items():
            print(f"  (d) train.py {' '.join(MOE_TRAIN_ARGS[name])} "
                  f"--moe-experts 8: rc {tr['rc']}, final loss "
                  f"{tr['final_loss']:.4f}, {tr['seconds']:.1f} s")
        res["forward_world"] = fw
        res["ep"] = ep
        res["ep_bf16"] = [{k: x[k] for k in ("tokens_per_s", "loss",
                                             "launches", "profile")}
                          for x in b]
        res["world_ranks_s"] = [{k: r[k] for k in (
            "warm_s", "refs_wait_s", "gates_s", "lock_wait_s", "seconds")}
            for r in ranks]
        out["forward_world"] = {r["rank"]: r["forward"]["launches"]
                                for r in ranks}
        out["moe_ep"] = {r["rank"]: r["ep"]["launches"] for r in ranks}
        for w in ("forward_world", "moe_ep"):
            total = {k: sum(x[k] for x in out[w].values())
                     for k in out["moe"]}
            need = ("flash_fwd",) if w == "forward_world" else (
                "xent_fwd", "xent_bwd")
            check(all(total[k] > 0 for k in need),
                  f"{w}: a kernel of its path was never launched: {total}")
    finally:
        for k in ("ready", "lock_done"):  # a failed launcher frees the world
            if not Path(spec[k]).exists():
                signal_file(spec[k], "the launcher stopped")
        for th in (world, trainer):
            if th is not None:
                th.join()
        shutil.rmtree(tmp, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t0
    print(f"  phase 15: {res['seconds']:.1f} s")
    report["fwd_moe"] = res
    return out


# MoE composed with TP, FSDP and seq (phase 16): phase 15's MoE LM (tied
# GPT-2-small's widths, E = 8, top-2, expert ffn 3072, 4 of 12 layers, cut
# for the script's time limit), B = 8, S = 1024, 1F1B at D = 2, M = 2, in
# one gloo world of 8 ranks staged through host memory on the card, on
# three meshes (pipe, data, model, seq, expert). The f32 gates at capacity
# E / top_k and aux 0 (no drops: an expert takes at most one slot a token,
# so every chunking routes alike) against the lockstep step on the same
# rows; the bf16 step at phase 15's routing (capacity 1.25, aux 0.01)
MOE_PAR_B, MOE_PAR_M, MOE_PAR_REF_M = 8, 2, 8
# the cross-entropy rows of a data 2 x expert 2 rank's microbatch
MOE_XENT_ROWS = 1024
# (a)'s routing (cut from capacity E for the script's time)
MOE_PAR_FIELDS = dict(MOE_EP_FIELDS, capacity_factor=MOE_FIELDS["n_experts"]
                      / MOE_FIELDS["top_k"])
MOE_PAR_MESHES = {"ep_tp": ((2, 1, 2, 1, 2), {}),
                  "fsdp_ep": ((2, 2, 1, 1, 2), {"fsdp": True}),
                  "seq_ep": ((2, 1, 1, 2, 2), {"sp_attn_impl": "ulysses"})}
# (c): train.py, 2 steps, as one world of 8 beside the phase's, at 2
# layers and S = 256: data 2 (FSDP) x model 2 x expert 2, both
# compositions in one world, not a world each, for the script's time (the
# card's host runs 16 processes meanwhile)
MOE_PAR_TRAIN_COMMON = ["--model", "gpt2-small", "--tie-embeddings",
                        "--layers", "2", "--batch",
                        str(MOE_PAR_B), "--seq", "256",
                        "--microbatches", str(MOE_PAR_M), "--steps", "2",
                        "--fused-xent", "--moe-experts", "8", "--ep", "2",
                        "--backend", "gloo"]
MOE_PAR_TRAIN_ARGS = {"fsdp_tp_ep": ["--pipe", "1", "--tp", "2", "--fsdp",
                                     "--data", "2"]}


def moe_par_model(cfg, moe, mesh, fsdp, whole, device):
    """This rank's MoE model on ``mesh``: its blocks' expert block of the
    ``whole`` state, then its Megatron shard, then its FSDP shards."""
    from distributed_training_with_pipeline_parallelism_tpu_torch import (
        owned_layers)
    from distributed_training_with_pipeline_parallelism_tpu_torch.models.moe import (
        MoELM)
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel.expert_parallel import (
        ep_shard_state)
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel.fsdp import (
        fsdp_shard_params)
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel.tensor_parallel import (
        shard_model)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils.config import (
        ScheduleConfig, torch_dtype)
    m = MoELM(cfg, moe, device=device, dtype=torch_dtype(cfg.storage_dtype),
              layers=owned_layers(cfg.n_layers, ScheduleConfig(
                  "1F1B", MOE_PAR_M), 2, mesh.pipe),
              expert=(mesh.n_expert, mesh.expert))
    m.load_state_dict(ep_shard_state({k: whole[k] for k in m.state_dict()},
                                     m.expert))
    if mesh.n_model > 1:
        m = shard_model(m, cfg, mesh)
    return fsdp_shard_params(m, cfg, mesh) if fsdp else m


def moe_par_leaf_ratio(mesh, model, ref):
    """Worst leaf ratio (phase 4's bound) of this rank's gradients against
    the lockstep ``ref``: each of its leaves against the reference cut as
    the rank holds it (the expert block, the Megatron shard, the FSDP
    shard), each whole leaf's squared error and norm summed over the
    world from the one rank of each block (a replicated leaf from
    coordinate 0 of the axes that replicate it). Returns (ratio, leaf)."""
    import torch
    from distributed_training_with_pipeline_parallelism_tpu_torch.models.moe import (
        expert_block, is_expert_leaf)
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel.fsdp import (
        fsdp_shard_of)
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel.tensor_parallel import (
        shard_tensor, split_dim)
    names = list(ref["grads"])
    fs = fsdp_shard_of(model)
    sq = torch.zeros((len(names), 2), dtype=torch.float64,
                     device=mesh.device)
    for n, p in model.named_parameters():
        r = expert_block(n, ref["grads"][n], model.expert)
        tp = split_dim(model.cfg, n) if mesh.n_model > 1 else None
        r = shard_tensor(r, tp, mesh.n_model, mesh.model)
        fd = None if fs is None else fs.dims.get(n)
        r = shard_tensor(r, fd, mesh.n_data, mesh.data).to(p.device)
        own = ((mesh.pipe == 0 or n.startswith("layers."))
               and (mesh.expert == 0 or is_expert_leaf(n))
               and (mesh.model == 0 or tp is not None)
               and (mesh.data == 0 or fd is not None) and mesh.seq == 0)
        if own:
            sq[names.index(n)] = torch.stack([
                (p.grad.double() - r.double()).square().sum(),
                r.double().square().sum()])
    mesh.all_reduce([sq], "world")
    ratios = (sq[:, 0].sqrt() / (1e-4 * sq[:, 1].sqrt()
                                 + 1e-6 * ref["g_norm"])).tolist()
    worst = max(range(len(names)), key=lambda i: ratios[i])
    return ratios[worst], names[worst]


def moe_par_worker(world, spec):
    """One rank of phase 16's world: on each mesh the f32 gate against the
    launcher's lockstep step, then on each the bf16 timed step and one
    profiled step. Returns this rank's numbers; raises (failing the
    world) at a gate."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import distributed_training_with_pipeline_parallelism_tpu_torch as port
    from distributed_training_with_pipeline_parallelism_tpu_torch.models.moe import (
        is_expert_leaf)
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel.fsdp import (
        fsdp_names)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils.data import (
        batch_sharding)
    device = world.device
    t_phase = time.perf_counter()
    res = dict(rank=world.rank, gates={}, bf16={})
    meshes = {name: port.make_mesh(*shape, backend=world.backend,
                                   device=device)
              for name, (shape, _) in MOE_PAR_MESHES.items()}
    res["describe"] = {k: m.describe() for k, m in meshes.items()}
    res["refs_wait_s"] = wait_for(spec["ready"], "phase 16's reference")
    whole = torch.load(spec["moe_whole"], mmap=True, weights_only=True)
    ref = torch.load(spec["moe_ref"], mmap=True, weights_only=True)
    batch = tuple(t.to(device) for t in torch.load(spec["batch"],
                                                   weights_only=True))
    sched = port.ScheduleConfig("1F1B", MOE_PAR_M)
    cfg, _ = moe_setup(ep=True)
    moe = port.MoEConfig(**MOE_PAR_FIELDS)
    for name, (_, kw) in MOE_PAR_MESHES.items():
        mesh = meshes[name]
        fsdp = kw.get("fsdp", False)
        model = moe_par_model(cfg, moe, mesh, fsdp, whole, device)
        fn = port.make_pipeline_grad_fn(cfg, sched, 2, device=device,
                                        mesh=mesh, moe=moe, fsdp=fsdp,
                                        sp_attn_impl=kw.get("sp_attn_impl",
                                                            "ring"))
        local = batch_sharding(mesh)(batch)
        a2a = mesh.a2a
        t = time.perf_counter()
        loss, launches = counted_launches(lambda: fn(model, *local).item())
        step_s = time.perf_counter() - t
        rel = abs(loss - ref["loss"]) / abs(ref["loss"])
        worst, leaf = moe_par_leaf_ratio(mesh, model, ref)
        held = {n: p.numel() * p.element_size()
                for n, p in model.named_parameters()}
        last = mesh.pipe == 1
        want = {"flash_fwd": 0, "flash_bwd": 0,
                "xent_fwd": MOE_PAR_M * last, "xent_bwd": MOE_PAR_M * last}
        res["gates"][name] = dict(
            loss=loss, loss_rel_err=rel, worst_bound_ratio=worst,
            worst_leaf=leaf, launches=launches,
            all_to_alls=mesh.a2a - a2a, step_s=step_s,
            expert_bytes=sum(b for n, b in held.items()
                             if is_expert_leaf(n)),
            fsdp_bytes=sum(held[n] for n in fsdp_names(model)),
            param_bytes=sum(held.values()))
        check(rel <= 1e-5, f"{name} rank {world.rank}: loss rel err {rel} "
              f"> 1e-5")
        check(worst <= 1.0, f"{name} rank {world.rank}: leaf {leaf} over "
              f"its bound ({worst})")
        check(launches == want, f"{name} rank {world.rank}: launches "
              f"{launches} != {want}")
        # 2 forward, 2 recomputed, 2 transposed a layer a microbatch
        n_a2a = MOE_PAR_M * (MOE_LAYERS // 2) * 6
        check(mesh.a2a - a2a == n_a2a, f"{name} rank {world.rank}: "
              f"{mesh.a2a - a2a} expert all-to-alls, not {n_a2a}")
        del model, fn
        torch.cuda.empty_cache()
    res["gates_s"] = time.perf_counter() - t_phase

    # bf16 over f32 masters at phase 15's routing: one profiled step (which
    # also pays the first-use costs), then one timed
    cfg16, moe16 = moe_setup(bf16=True)
    for name, (_, kw) in MOE_PAR_MESHES.items():
        mesh = meshes[name]
        fsdp = kw.get("fsdp", False)
        model = moe_par_model(cfg16, moe16, mesh, fsdp, whole, device)
        opt = port.adamw(warmup_steps=2, total_steps=100)
        state = opt.init(model)
        step = port.make_train_step(cfg16, sched, 2, opt, device=device,
                                    mesh=mesh, moe=moe16, fsdp=fsdp,
                                    sp_attn_impl=kw.get("sp_attn_impl",
                                                        "ring"))
        local = batch_sharding(mesh)(batch)

        losses = []

        def run(m, t, y):
            losses.append(step(m, state, t, y))
            return losses[-1]

        profile = par_profile(lambda: run(model, *local), mesh)
        timed = port.run_train_iterations(run, model, *local,
                                          num_iterations=1,
                                          warmup_iterations=0, mesh=mesh)
        loss = losses[-1].item()
        check(math.isfinite(loss), f"{name} bf16 rank {world.rank}: loss "
              f"{loss}")
        res["bf16"][name] = dict(tokens_per_s=timed["throughput"],
                                 loss=loss, profile=profile)
        del model, state, step
        torch.cuda.empty_cache()
    res["seconds"] = time.perf_counter() - t_phase
    return res


def phase_moe_par(report, device="cuda"):
    """MoE composed with TP, FSDP and seq (see the comment above the
    constants): the lockstep reference here, a world of 8 processes and
    ``train.py``'s two worlds beside it. Returns each mesh's f32 launches
    by rank."""
    import copy
    import shutil
    import tempfile
    import torch
    import distributed_training_with_pipeline_parallelism_tpu_torch as port
    from distributed_training_with_pipeline_parallelism_tpu_torch.models.moe import (
        moe_init_params)
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip-smoke-moe-par-")
    spec = {k: str(Path(tmp) / k) for k in ("moe_whole", "moe_ref", "batch",
                                            "ready")}
    res, box, world, trainer = {}, {}, None, None

    def run_world():
        try:
            box["ranks"] = port.launch(moe_par_worker,
                                       port.MeshConfig(2, 4), spec,
                                       backend="gloo", device=device,
                                       timeout_s=300)
        except BaseException as e:  # re-raised by the phase
            box["error"] = e

    def train_runs():
        """``train.py``'s composed world (every entry of
        ``MOE_PAR_TRAIN_ARGS``, at once)."""
        t = time.perf_counter()
        procs = {name: subprocess.Popen(
            [sys.executable, "-m", f"{PKG}.train", *MOE_PAR_TRAIN_COMMON,
             *args], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, start_new_session=True)
            for name, args in MOE_PAR_TRAIN_ARGS.items()}
        res["train_main"] = {}
        for name, proc in procs.items():
            try:
                text, _ = proc.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                proc.kill()
                text, _ = proc.communicate()
            final = [ln for ln in text.splitlines()
                     if ln.startswith("final loss:")]
            res["train_main"][name] = dict(
                rc=proc.returncode,
                final_loss=float(final[-1].split(":")[1]) if final
                else math.nan, seconds=time.perf_counter() - t,
                output=text[-3000:])

    try:
        cfg, _ = moe_setup(ep=True)
        moe = port.MoEConfig(**MOE_PAR_FIELDS)
        model = moe_init_params(cfg, moe, torch.Generator().manual_seed(SEED),
                                device)
        torch.save({n: t.cpu() for n, t in model.state_dict().items()},
                   spec["moe_whole"])
        g = torch.Generator().manual_seed(SEED + 5)
        batch = tuple(torch.randint(0, cfg.vocab_size, (MOE_PAR_B, TRAIN_S),
                                    generator=g) for _ in range(2))
        torch.save(batch, spec["batch"])
        world = threading.Thread(target=run_world)
        world.start()
        trainer = threading.Thread(target=train_runs)
        trainer.start()
        try:  # the gates' reference: the lockstep step on the same rows
            ref_model = copy.deepcopy(model)
            fn = port.make_pipeline_grad_fn(
                cfg, port.ScheduleConfig("1F1B", MOE_PAR_REF_M), 2,
                device=device, moe=moe)
            loss = fn(ref_model, *(x.to(device) for x in batch)).item()
            grads = {n: p.grad.detach().cpu()
                     for n, p in ref_model.named_parameters()}
            g_norm = math.sqrt(sum((x.double() ** 2).sum().item()
                                   for x in grads.values()))
            torch.save({"grads": grads, "loss": loss, "g_norm": g_norm},
                       spec["moe_ref"])
            res["lockstep_loss"] = loss
            del ref_model, grads, model, fn
            torch.cuda.empty_cache()
            signal_file(spec["ready"], "ok")
        except BaseException as e:
            signal_file(spec["ready"], f"the launcher failed: {e!r}")
            raise
        world.join()
        trainer.join()
        if "error" in box:
            raise box["error"]
        ranks = box["ranks"]
        for r in ranks:
            for name, d in r["describe"].items():
                check(d["transport"] == "gloo-staged",
                      f"rank {r['rank']} {name}: {d}")
        res["ranks"] = [{k: r[k] for k in ("rank", "gates", "bf16",
                                           "refs_wait_s", "gates_s",
                                           "seconds")} for r in ranks]
        out = {}
        for name, (shape, kw) in MOE_PAR_MESHES.items():
            g = [r["gates"][name] for r in ranks]
            b = [r["bf16"][name] for r in ranks]
            out[name] = {r["rank"]: r["gates"][name]["launches"]
                         for r in ranks}
            sp = b[0]["profile"]["spans"]
            print(f"  f32 {name} (pipe, data, model, seq, expert) = {shape}"
                  f"{' ' + str(kw) if kw else ''}: loss {g[0]['loss']:.6f} "
                  f"(rel err {max(x['loss_rel_err'] for x in g):.2e} vs "
                  f"lockstep {res['lockstep_loss']:.6f}), worst leaf at "
                  f"{max(x['worst_bound_ratio'] for x in g):.3f} of its "
                  f"bound, rank 0: expert stacks {g[0]['expert_bytes']} B, "
                  f"FSDP shards {g[0]['fsdp_bytes']} B of "
                  f"{g[0]['param_bytes']} B, {g[0]['all_to_alls']} "
                  f"all-to-alls, step {g[0]['step_s']:.2f} s; launches by "
                  f"rank {[x['launches'] for x in g]}")
            print(f"  bf16 {name}: {b[0]['tokens_per_s']:.1f} tokens/s; "
                  f"rank 0 profiled: wall {b[0]['profile']['wall_ms']:.1f} "
                  f"ms, device busy {b[0]['profile']['device_busy_ms']:.1f} "
                  f"ms, idle share {b[0]['profile']['idle_share']:.3f}; "
                  + ", ".join(f"{k} {v['count']} x {v['ms']:.1f} ms"
                              for k, v in sorted(sp.items())))
            total = {k: sum(x["launches"][k] for x in g)
                     for k in g[0]["launches"]}
            check(total["xent_fwd"] > 0 and total["xent_bwd"] > 0,
                  f"{name}: a kernel of its path was never launched: "
                  f"{total}")
            for x in b:
                check(0.0 <= x["profile"]["idle_share"] <= 1.0,
                      f"{name}: idle share {x['profile']['idle_share']} "
                      f"outside [0, 1]")
        for name, tr in res["train_main"].items():
            print(f"  train.py {' '.join(MOE_PAR_TRAIN_ARGS[name])} --ep 2 "
                  f"--moe-experts 8: rc {tr['rc']}, final loss "
                  f"{tr['final_loss']:.4f}, {tr['seconds']:.1f} s")
            check(tr["rc"] == 0 and math.isfinite(tr["final_loss"])
                  and abs(tr["final_loss"] - math.log(cfg.vocab_size)) < 1.0,
                  f"train.py {name}: rc {tr['rc']}, final loss "
                  f"{tr['final_loss']}: {tr['output']}")
    finally:
        if not Path(spec["ready"]).exists():  # a failed launcher frees it
            signal_file(spec["ready"], "the launcher stopped")
        for th in (world, trainer):
            if th is not None:
                th.join()
        shutil.rmtree(tmp, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t0
    print(f"  phase 16: {res['seconds']:.1f} s")
    report["moe_par"] = res
    return out


# Tensor parallelism in the pipelined decoder and the serving engine
# (phase 17): one gloo world of (pipe 1, data 1, model 2) on the card,
# staged, each rank running D = 2 lockstep stages on its model shard;
# Llama-3.2-1B at full width (GQA 32/8, tied, vocab 128256: the greedy
# head goes vocab-parallel), phase 11's 4 of its 16 layers for the f32
# gates and all 16 for the bf16 timing
TPS_MESH = (1, 1, 2)  # (n_pipe, n_data, n_model)
TPS_D, TPS_B, TPS_P, TPS_N, TPS_M = 2, 4, 256, 16, 2
TPS_SHAPE = [TPS_B // TPS_M, TPS_P, 16, 64]  # K4 at a rank's 16 of 32 heads
TPS_SERVE = dict(n_slots=4, max_len=160, prompt_max=128, out_max=32,
                 prefill_chunk=16, eos_id=1)
TPS_PAGE, TPS_GAMMA, TPS_DRAFT_LAYERS = 16, 2, 2
TPS_REQUESTS, TPS_PROMPTS, TPS_OUTS = 8, (16, 128), (8, 32)
# (c): the decoder timed after one warm-up; the engine's first run, on the
# trace's first 4 requests (a staged all-reduce takes ~2 ms on one card,
# 24 of them a tick at 16 layers: the whole trace took 24 s a run)
TPS_TIME_REQUESTS = 4


def tps_configs():
    """(f32 gate config, its draft, the bf16 timing config)."""
    from distributed_training_with_pipeline_parallelism_tpu_torch import llama_config
    kw = dict(use_flash_attention=True, use_fused_xent=True)
    return (tp_llama_config(),
            llama_config("llama3.2-1b", n_layers=TPS_DRAFT_LAYERS, **kw),
            llama_config("llama3.2-1b", dtype="bfloat16", **kw))


def tps_cases():
    """The world's ``run_cases`` cases: (a)'s two decodes, (b)'s three
    engines, (c)'s bf16 decode (a warm-up and a timed run) and engine
    (one run of the trace's first ``TPS_TIME_REQUESTS``)."""
    world = dict(zip(("n_pipe", "n_data", "n_model"), TPS_MESH),
                 n_stages=TPS_D)
    dec = dict(kind="decode", N=TPS_N, prompt="p", init_seed=SEED, **world)
    serve = dict(kind="serve", requests="r", init_seed=SEED, **world)
    return [
        dict(dec, name="f32_decode", cfg="f32",
             decode=dict(n_streams=TPS_M)),
        dict(dec, name="f32_decode_lp", cfg="f32",
             decode=dict(n_streams=TPS_M, return_logprobs=True)),
        dict(serve, name="f32_contiguous", cfg="f32", program=TPS_SERVE),
        dict(serve, name="f32_paged", cfg="f32",
             program=dict(TPS_SERVE, paged=True, page_size=TPS_PAGE)),
        dict(serve, name="f32_spec", cfg="f32", draft_cfg="draft",
             draft_init_seed=SEED + 1,
             program=dict(TPS_SERVE, gamma=TPS_GAMMA)),
        dict(dec, name="bf16_decode", cfg="bf16", runs=2,
             decode=dict(n_streams=TPS_M)),
        dict(serve, name="bf16_contiguous", cfg="bf16", program=TPS_SERVE,
             requests="timed")]


def tps_worker(mesh, spec):
    """One rank of phase 17's world: ``selftest.run_cases`` over
    ``tps_cases``, with the shape (and dtype code) of every kernel launch
    counted (``launch_shapes``)."""
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
        selftest)
    with launch_shapes() as rec:
        out = selftest.run_cases(mesh, spec)
    out.update(shapes=rec["shapes"], describe=mesh.describe())
    return out


def tps_completions(comps):
    """(rid, tokens, slot, first tick, finish tick, status) rows by rid."""
    return {c[0]: tuple(c[1:]) for c in comps}


def tps_latency(comps, requests):
    """The median TTFT and TPOT in ticks of completion rows."""
    arrival = {r.rid: r.arrival for r in requests}
    ttft = [c[3] - arrival[c[0]] for c in comps]
    tpot = [(c[4] - c[3]) / (len(c[1]) - 1) for c in comps
            if len(c[1]) > 1]
    return statistics.median(ttft), statistics.median(tpot)


def phase_tp_serving(report, device="cuda"):
    """TP in the decoder and the engine (see the comment above the
    constants): the T = 1 bf16 timing here first, then the world, beside
    which the T = 1 f32 references run here. Returns the launches of the
    world's decode cases and its serve cases by rank."""
    import torch
    import distributed_training_with_pipeline_parallelism_tpu_torch as port
    from distributed_training_with_pipeline_parallelism_tpu_torch.ops.flash_attention import (
        FLASH_FWD)
    from distributed_training_with_pipeline_parallelism_tpu_torch.ops.fused_xent import (
        XENT_FWD)
    t0 = time.perf_counter()
    card = report["card"]
    cfg, dcfg, cfg16 = tps_configs()
    kernels = (FLASH_FWD, XENT_FWD)
    prompt = torch.randint(0, cfg.vocab_size, (TPS_B, TPS_P),
                           generator=torch.Generator().manual_seed(SEED + 2))
    trace = port.synth_trace(TPS_REQUESTS, prompt_lens=TPS_PROMPTS,
                             out_lens=TPS_OUTS,
                             prefill_chunk=TPS_SERVE["prefill_chunk"],
                             load=SERVE_LOAD, vocab_size=cfg.vocab_size,
                             seed=SEED)
    timed = trace[:TPS_TIME_REQUESTS]
    spec = dict(cfgs={k: dataclasses.asdict(c) for k, c in
                      (("f32", cfg), ("draft", dcfg), ("bf16", cfg16))},
                trees={}, prompts={"p": prompt.numpy()},
                requests={k: [(r.rid, list(r.prompt), r.max_new_tokens,
                               r.arrival) for r in t]
                          for k, t in (("r", trace), ("timed", timed))},
                threads=1, cases=tps_cases())
    res = dict(shape=TPS_SHAPE)

    def model_of(c, seed):
        return port.init_params(
            c, torch.Generator(device=device).manual_seed(seed), device)

    def engine_of(c, model, draft=None, **kw):
        program = port.make_serving_step_fn(c, TPS_D, device=device,
                                            **TPS_SERVE, **kw)
        return program, port.ServingEngine(program, model,
                                           draft_params=draft)

    # (c) first, alone on the card: the T = 1 lockstep bf16 timing
    model16 = model_of(cfg16, SEED)
    gen16 = port.make_pipeline_generate_fn(cfg16, TPS_D, TPS_N,
                                           n_streams=TPS_M, device=device)
    lock = {"decode_s": []}
    for _ in range(2):  # a warm-up, then the timed run
        torch.cuda.synchronize()
        t = time.perf_counter()
        toks16 = gen16(model16, prompt.to(device))
        torch.cuda.synchronize()
        lock["decode_s"].append(time.perf_counter() - t)
    program16, engine16 = engine_of(cfg16, model16)
    run16 = engine16.run(timed)  # its first run, as the world's
    lock.update(serve_s=run16.wall_s, decode_tokens=toks16.cpu(),
                ticks=run16.ticks,
                completions=[(c.rid, c.tokens, c.slot, c.first_token_tick,
                              c.finish_tick, c.status)
                             for c in run16.completions],
                cuda_graphs=program16.cuda_graphs)
    del model16, gen16, program16, engine16
    torch.cuda.empty_cache()
    res["lockstep_bf16_s"] = time.perf_counter() - t0

    box = {}

    def run_world():
        try:
            box["ranks"] = port.launch(tps_worker, port.MeshConfig(*TPS_MESH),
                                       spec, backend="gloo", device=device,
                                       timeout_s=300)
        except BaseException as e:  # re-raised by the phase
            box["error"] = e

    t_world = time.perf_counter()
    world = threading.Thread(target=run_world)
    world.start()
    try:
        # (a), (b): the T = 1 f32 references, beside the world's gates
        model = model_of(cfg, SEED)
        draft = model_of(dcfg, SEED + 1)
        p_dev = prompt.to(device)
        for k in kernels:
            k.launches = 0
        toks_l = port.make_pipeline_generate_fn(
            cfg, TPS_D, TPS_N, n_streams=TPS_M, device=device)(model, p_dev)
        toks_s = port.generate(cfg, model, p_dev, TPS_N, device=device)
        toks_lp, lps = port.make_pipeline_generate_fn(
            cfg, TPS_D, TPS_N, n_streams=TPS_M, return_logprobs=True,
            device=device)(model, p_dev)
        res["lockstep_launches"] = {k.name: k.launches for k in kernels}
        gap = top2_gap_of(cfg, model, toks_s, TPS_P)
        res["lockstep_vs_generate"] = compare_tokens(
            "f32 T = 1 lockstep decoder vs generate", toks_l, toks_s,
            torch.zeros(toks_l.shape), torch.zeros(toks_s.shape), gap,
            p=TPS_P, n=TPS_N)
        ref_serve = {}
        for mode, kw in (("contiguous", {}),
                         ("paged", dict(paged=True, page_size=TPS_PAGE)),
                         ("spec", dict(speculative=True, gamma=TPS_GAMMA,
                                       draft_cfg=dcfg))):
            program, engine = engine_of(cfg, model,
                                        draft if mode == "spec" else None,
                                        **kw)
            check(program.cuda_graphs, f"T = 1 {mode}: no CUDA graphs")
            r = engine.run(trace)
            check(r.n_failed == 0 and len(r.completions) == TPS_REQUESTS,
                  f"T = 1 {mode}: {len(r.completions)} completions, "
                  f"{r.n_failed} failed")
            ref_serve[mode] = [(c.rid, c.tokens, c.slot, c.first_token_tick,
                                c.finish_tick, c.status)
                               for c in r.completions]
        res["refs_s"] = time.perf_counter() - t_world
        refs_done = time.time()
        top_gap = (top2_gap_of(cfg, model, toks_lp, TPS_P), gap)
        del draft, engine, program
        torch.cuda.empty_cache()
    finally:
        world.join()
    if "error" in box:
        raise box["error"]
    ranks = box["ranks"]
    res["world_s"] = time.perf_counter() - t_world
    res["case_s"] = [{k: round(v, 1) for k, v in r["seconds"].items()}
                     for r in ranks]
    print(f"  mesh.describe() of rank 0: {ranks[0]['describe']}; the T = 1 "
          f"bf16 timing {res['lockstep_bf16_s']:.1f} s, the f32 references "
          f"{res['refs_s']:.1f} s beside the world; the world's cases by "
          f"rank (s): {res['case_s']}")
    for r in ranks:
        check(r["describe"]["transport"] == "gloo-staged",
              f"rank {r['rank']}: {r['describe']}")

    # (a) the decoder gate: tokens against T = 1 on each rank
    res["decode"] = {}
    for r in ranks:
        g, lp = r["cases"]["f32_decode"], r["cases"]["f32_decode_lp"]
        toks = torch.from_numpy(g["outputs"][0])
        got_lp, got_lps = (torch.from_numpy(x) for x in lp["outputs"])
        res["decode"][r["rank"]] = dict(
            vs_lockstep=compare_tokens(
                f"f32 TP rank {r['rank']} vs T = 1 lockstep", toks,
                toks_l.cpu(), torch.zeros(toks.shape),
                torch.zeros(toks.shape), top_gap[1].cpu(), p=TPS_P,
                n=TPS_N),
            vs_generate=compare_tokens(
                f"f32 TP rank {r['rank']} vs generate", toks, toks_s.cpu(),
                torch.zeros(toks.shape), torch.zeros(toks.shape),
                top_gap[1].cpu(), p=TPS_P, n=TPS_N),
            logprobs=compare_tokens(
                f"f32 TP rank {r['rank']} log-probs run vs T = 1", got_lp,
                toks_lp.cpu(), got_lps, lps.cpu(), top_gap[0].cpu(),
                p=TPS_P, n=TPS_N),
            launches=g["launches"], launches_lp=lp["launches"])
        check(g["launches"]["flash_fwd"] > 0 and lp["launches"]["xent_fwd"]
              > 0 and g["launches"]["xent_fwd"] == 0,
              f"rank {r['rank']}: decode launches {g['launches']}, "
              f"log-probs run {lp['launches']}")
        k4 = {k: v for k, v in r["shapes"].items()
              if k.startswith("flash_fwd")}
        check(all(k.startswith(f"flash_fwd {TPS_SHAPE} ") for k in k4),
              f"rank {r['rank']}: K4 launched at {k4}, not {TPS_SHAPE}")
        print(f"  rank {r['rank']}: launches greedy {g['launches']}, "
              f"log-probs {lp['launches']}; by shape {r['shapes']}")
    # (b) the engine gate: the T = 1 engine's completions, exactly
    res["serve"] = {}
    for mode in ("contiguous", "paged", "spec"):
        want = tps_completions(ref_serve[mode])
        for r in ranks:
            info = r["cases"][f"f32_{mode}"]
            got = tps_completions(info["completions"])
            if got != want:
                rids = [k for k in want if got.get(k) != want[k]]
                check(False, f"f32 TP {mode} rank {r['rank']}: the "
                      f"completions of rids {rids} differ from T = 1's: "
                      f"{[(got.get(k), want[k]) for k in rids[:2]]}")
            check(info["cuda_graphs"] is False,
                  f"{mode} rank {r['rank']}: cuda_graphs "
                  f"{info['cuda_graphs']} under a staging mesh")
        res["serve"][mode] = dict(
            ticks=ranks[0]["cases"][f"f32_{mode}"]["ticks"],
            launches=[r["cases"][f"f32_{mode}"]["launches"] for r in ranks],
            acceptance_rate=ranks[0]["cases"][f"f32_{mode}"][
                "acceptance_rate"],
            cuda_graphs=False)
        print(f"  f32 TP engine {mode}: {TPS_REQUESTS} completions on each "
              f"rank equal the T = 1 engine's (graphs on) exactly, "
              f"{res['serve'][mode]['ticks']} ticks, cuda_graphs=False, "
              f"launches by rank {res['serve'][mode]['launches']}"
              + (f", acceptance {res['serve'][mode]['acceptance_rate']:.3f}"
                 if mode == "spec" else ""))

    # (c) bf16 timing beside T = 1
    dec = [r["cases"]["bf16_decode"] for r in ranks]
    srv = [r["cases"]["bf16_contiguous"] for r in ranks]
    n_tok = TPS_B * TPS_N
    t_dec = max(x["wall_s"][-1] for x in dec)
    t_srv = max(x["wall_s"][-1] for x in srv)
    ticks = srv[0]["ticks"]
    lat_tp = tps_latency(srv[0]["completions"], timed)
    lat_l = tps_latency(lock["completions"], timed)
    dec_ticks = TPS_M + TPS_D + TPS_M * (TPS_N - 1) + TPS_D
    res["bf16"] = dict(
        decode_tokens_per_s=n_tok / t_dec,
        lockstep_decode_tokens_per_s=n_tok / lock["decode_s"][-1],
        serve_s_per_tick=t_srv / ticks,
        lockstep_serve_s_per_tick=lock["serve_s"] / lock["ticks"],
        ticks=ticks, lockstep_ticks=lock["ticks"],
        ttft_tpot_ticks=lat_tp, lockstep_ttft_tpot_ticks=lat_l,
        same_tokens_decode=[torch.equal(torch.from_numpy(x["outputs"][0]),
                                        lock["decode_tokens"]) for x in dec],
        same_completions_serve=[tps_completions(x["completions"])
                                == tps_completions(lock["completions"])
                                for x in srv],
        decode_collectives=[x["collectives"] for x in dec],
        serve_collectives=[x["collectives"] for x in srv],
        decode_ticks=dec_ticks,
        started_after_refs=min(x["t0"] for x in dec) >= refs_done,
        launches_decode=[x["launches"] for x in dec],
        launches_serve=[x["launches"] for x in srv])
    b = res["bf16"]
    ratio = b["decode_tokens_per_s"] / b["lockstep_decode_tokens_per_s"]
    print(f"  bf16 decoder ({cfg16.n_layers} layers, B={TPS_B}, P={TPS_P}, "
          f"N={TPS_N}, M={TPS_M}): TP world {b['decode_tokens_per_s']:.1f} "
          f"tokens/s vs T = 1 lockstep "
          f"{b['lockstep_decode_tokens_per_s']:.1f} ({ratio:.4f}x); tokens "
          f"equal T = 1's by rank {b['same_tokens_decode']} [{card}]")
    print(f"  bf16 engine ({cfg16.n_layers} layers, {TPS_TIME_REQUESTS} "
          f"requests, each side's first run): TP world "
          f"s_per_tick {b['serve_s_per_tick']:.6f} over {ticks} ticks vs "
          f"T = 1 (graphs) {b['lockstep_serve_s_per_tick']:.6f} over "
          f"{b['lockstep_ticks']}; TTFT / TPOT p50 ticks {lat_tp} vs "
          f"{lat_l}; completions equal T = 1's by rank "
          f"{b['same_completions_serve']} [{card}]")
    for name, key, n_ticks in (("decode", "decode_collectives", dec_ticks),
                               ("engine", "serve_collectives", ticks)):
        for r, sp in enumerate(b[key]):
            print(f"  bf16 {name} rank {r}, the timed run: "
                  + ", ".join(f"{k} {v['count']} ({v['count'] / n_ticks:.2f}"
                              f" a tick) {v['host_ms']:.1f} host ms"
                              for k, v in sp.items()))
    print(f"  the world's bf16 cases started after the T = 1 references "
          f"ended: {b['started_after_refs']}")
    res["seconds"] = time.perf_counter() - t0
    print(f"  phase 17: {res['seconds']:.1f} s (the world "
          f"{res['world_s']:.1f} s)")
    report["tp_serving"] = res
    by_rank = {"decode": {}, "serve": {}}
    for r in ranks:
        c = r["cases"]
        by_rank["decode"][r["rank"]] = {
            k: c["f32_decode"]["launches"][k] + c["f32_decode_lp"][
                "launches"][k] for k in c["f32_decode"]["launches"]}
        by_rank["serve"][r["rank"]] = {
            k: sum(c[f"f32_{m}"]["launches"][k]
                   for m in ("contiguous", "paged", "spec"))
            for k in c["f32_decode"]["launches"]}
    return by_rank


# training dynamics and the certified search (phase 12): untied GPT-2-small
# (the JAX default), D = 4, M = 4, S = TRAIN_S; the f32 gates at B = 8, the
# bf16 fit at B = 24 over f32 masters
DYN_D, DYN_M, DYN_GATE_B, DYN_TIME_B = 4, 4, 8, 24
DYN_STEPS, DYN_LOG = 8, 2
DYN_TOKENS = 1 << 20  # (c)'s seeded token file
DYN_SEARCH = dict(n_devices=DYN_D, n_microbatches=DYN_M, iterations=600,
                  seed=0)


def dyn_config():
    """Untied GPT-2-small with both kernels routed on, f32."""
    from distributed_training_with_pipeline_parallelism_tpu_torch import gpt2_config
    return gpt2_config("small", use_flash_attention=True, use_fused_xent=True)


def stats_rel_err(got, want):
    """The largest relative error over the float stats both dicts hold
    (the nonfinite counts must be equal)."""
    worst = 0.0
    for k, w in want.items():
        if k == "nonfinite_per_stage":
            check(got[k].tolist() == w.tolist(), f"{k}: {got[k]} != {w}")
            continue
        g, w = got[k].double().cpu(), w.double().cpu()
        worst = max(worst, ((g - w).abs() / w.abs().clamp_min(1e-30))
                    .max().item())
    return worst


def recording(reports):
    """A ``patched`` wrap of ``table_check.check_table_cached`` that also
    appends each report it returns to ``reports``."""
    def wrap(real):
        def check_table_cached(cs):
            reports.append(real(cs))
            return reports[-1]
        return check_table_cached
    return wrap


def plain_stats(n_layers, n_stages, grads, params, updates):
    """The step statistics of ``dynamics.stage_stats`` computed apart from
    it: per-tensor sums in f64 on the card, one read, the stage sums on
    the host (layer i in stage i // (L/S), the embedding in stage 0, the
    rest in stage S - 1)."""
    import torch
    names = list(grads)
    lps = n_layers // n_stages

    def stage(n):
        if n.startswith("layers."):
            return int(n.split(".")[1]) // lps
        return 0 if n in ("tok", "pos") else n_stages - 1

    def sq(t):
        return t.double().square().sum()

    cols = torch.stack([torch.stack([
        sq(grads[n]), grads[n].double().abs().max(),
        (~torch.isfinite(grads[n]).all()).double(), sq(params[n]),
        sq(updates[n])]) for n in names]).cpu()
    g_sq, g_max, bad, p_sq, u_sq, numel = (
        [0.0] * n_stages for _ in range(6))
    l_sq = [0.0] * n_layers
    for n, (g2, gm, b, p2, u2) in zip(names, cols.tolist()):
        s = stage(n)
        g_sq[s] += g2
        g_max[s] = max(g_max[s], gm)
        bad[s] += b
        p_sq[s] += p2
        u_sq[s] += u2
        numel[s] += params[n].numel()
        if n.startswith("layers."):
            l_sq[int(n.split(".")[1])] += g2
    t = torch.tensor
    return {
        "grad_norm": t(sum(g_sq)).sqrt(),
        "grad_norm_per_stage": t(g_sq).sqrt(),
        "grad_max_per_stage": t(g_max),
        "nonfinite_per_stage": t(bad).int(),
        "grad_norm_per_layer": t(l_sq).sqrt(),
        "param_rms_per_stage": (t(p_sq) / t(numel)).sqrt(),
        "update_ratio_per_stage": t(u_sq).sqrt() / t(p_sq).sqrt()}


def phase_dynamics(report, tables, device="cuda"):
    """The static verifier, a certified searched schedule and training
    dynamics (see the module doc); ``tables`` holds the reports the
    verifier gave the earlier phases' tables. Returns the kernel launches
    of the counted f32 dynamics steps (on the searched table and on 1F1B)
    and of the guarded bf16 ``fit`` run."""
    import shutil
    import tempfile
    import torch
    import distributed_training_with_pipeline_parallelism_tpu_torch as port
    from distributed_training_with_pipeline_parallelism_tpu_torch.analysis import (
        schedule_search, table_check, verify_tables_enabled)
    from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
        transformer_loss)
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel import (
        schedules)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils import (
        dynamics, resilience, telemetry as tm, train as ttrain)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils.data import (
        TokenFileDataset, prefetch_to_device, write_token_file)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils.sweep import (
        SCHEDULES, run_one_experiment, summarize_dynamics, sweep_rows)
    kernels = all_kernels()
    res = {}
    launches = {}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dyn_"))
    try:
        # (a) host: every table the earlier phases built was checked at
        # build; a seeded search's artifact reloads, certifies, registers
        t0 = time.perf_counter()
        check(verify_tables_enabled(), "DTPP_VERIFY_TABLES is not set")
        seen = list({id(r): r for r in tables}.values())  # a hit's is shared
        check(len(seen) >= 8 and all(r.ok for r in seen),
              f"{len(seen)} tables checked, "
              f"{sum(not r.ok for r in seen)} with hazards")
        t = time.perf_counter()
        found = schedule_search.search_schedule(
            schedule_search.SearchSpec(**DYN_SEARCH))
        search_s = time.perf_counter() - t
        art = tmp / "searched_schedule.json"
        schedules.save_schedule_artifact(found.artifact, art)
        cs = schedules.load_schedule_artifact(str(art))
        digest = found.artifact["table_digest"]
        check(schedules.table_digest(cs.table) == digest,
              "the reloaded artifact's table differs")
        searched = port.ScheduleConfig.from_artifact(str(art))
        check(schedules.registered_artifact_info(searched.name)
              ["table_digest"] == digest, "the registered pin differs")
        base = found.baselines["1F1B"]
        res["host"] = dict(
            tables_checked=len(seen), search_s=search_s,
            evaluated=found.stats["evaluated"], makespan=cs.makespan,
            bubble=found.predicted["bubble_table_exact"],
            bubble_1f1b=base["bubble_table_exact"], digest=digest,
            split_backward=cs.split_backward,
            seconds=time.perf_counter() - t0)
        print(f"  (a) {len(seen)} tables the phases built, each checked "
              f"clean at build; search D={DYN_D} M={DYN_M} in "
              f"{search_s:.2f} s ({found.stats['evaluated']} candidates): "
              f"makespan {cs.makespan}, bubble "
              f"{found.predicted['bubble_table_exact']:.4f} (1F1B "
              f"{base['bubble_table_exact']:.4f}), artifact reloaded, "
              f"certified and registered as {searched.name!r}")

        # (b) the f32 gates: the dynamics step against the plain step and
        # against M single-device autograd passes on the plain versions
        t0 = time.perf_counter()
        cfg = dyn_config()
        plain = dataclasses.replace(cfg, use_flash_attention=False,
                                    use_fused_xent=False)
        g = torch.Generator().manual_seed(SEED)
        model = port.init_params(cfg, g, device)
        init_state = {n: p.detach().clone()
                      for n, p in model.state_dict().items()}
        tokens = torch.randint(0, cfg.vocab_size, (DYN_TIME_B, TRAIN_S),
                               generator=g).to(device)
        targets = torch.randint(0, cfg.vocab_size, (DYN_TIME_B, TRAIN_S),
                                generator=g).to(device)
        x, y = tokens[:DYN_GATE_B], targets[:DYN_GATE_B]
        named = dict(model.named_parameters())
        mb = DYN_GATE_B // DYN_M
        sq_ref = []
        full = {n: torch.zeros_like(p) for n, p in named.items()}
        for m in range(DYN_M):
            model.zero_grad(set_to_none=True)
            transformer_loss(plain, model, x[m * mb:(m + 1) * mb],
                             y[m * mb:(m + 1) * mb]).backward()
            sq_ref.append(sum(p.grad.double().square().sum()
                              for p in named.values()).item())
            for n, p in named.items():
                full[n].add_(p.grad, alpha=1.0 / DYN_M)
        params = {n: p.detach() for n, p in named.items()}
        st_ref = dynamics.stage_stats(cfg.n_layers, DYN_D, full,
                                      params=params)
        del full
        gates = {}
        for label, sched in (("searched", searched),
                             ("1F1B", port.ScheduleConfig("1F1B", DYN_M))):
            off = port.make_pipeline_grad_fn(cfg, sched, DYN_D, device=device)
            on = port.make_pipeline_grad_fn(cfg, sched, DYN_D, device=device,
                                            dynamics=True)
            model.zero_grad(set_to_none=True)
            loss_off = off(model, x, y)
            grads_off = {n: p.grad.clone() for n, p in named.items()}
            model.zero_grad(set_to_none=True)
            on(model, x, y)  # warm-up
            model.zero_grad(set_to_none=True)
            for k in kernels:
                k.launches = 0
            loss_on, sq_mb = on(model, x, y)
            torch.cuda.synchronize()
            counts = {k.name: k.launches for k in kernels}
            check(torch.equal(loss_on, loss_off) and all(
                torch.equal(p.grad, grads_off[n]) for n, p in named.items()),
                f"{label}: the dynamics step's loss or gradients differ "
                f"from the plain step's")
            want = (zb_launches(cfg.n_layers, DYN_D, 1, DYN_M)
                    if sched.name != "1F1B" else
                    {k: sum(rank_launches(cfg, sched, DYN_D, d)[k]
                            for d in range(DYN_D)) for k in counts})
            check(counts == want and all(v > 0 for v in counts.values()),
                  f"{label}: launches {counts} != {want}")
            sq = sq_mb.double().cpu()
            ref = torch.tensor(sq_ref, dtype=torch.float64)
            sq_err = ((sq - ref).abs() / ref).max().item()
            st = dynamics.stage_stats(
                cfg.n_layers, DYN_D, {n: p.grad for n, p in named.items()},
                params=params)
            st_err = stats_rel_err(st, st_ref)
            print(f"  (b) f32 {label} ({sched.name}) B={DYN_GATE_B}: loss "
                  f"and {len(named)} leaves bitwise the plain step's; sq_mb "
                  f"{[round(v, 4) for v in sq.tolist()]} within "
                  f"{sq_err:.2e} of {DYN_M} single-device passes, "
                  f"stage_stats within {st_err:.2e}; launches {counts}")
            check(sq_err <= 1e-4, f"{label}: sq_mb rel err {sq_err}")
            check(st_err <= 1e-4, f"{label}: stage_stats rel err {st_err}")
            gates[label] = dict(loss=loss_on.item(), sq_mb=sq.tolist(),
                                sq_ref=sq_ref, sq_rel_err=sq_err,
                                stats_rel_err=st_err, launches=counts)
            launches[f"dynamics_{label.lower()}_step"] = counts
        # the train step's statistics (its cached StageIndex, the update
        # from its parameter copy, the norm-based non-finite count) against
        # plain norms of the 1F1B gradients (the step's bitwise, as above),
        # the parameters before the step and their move
        step = ttrain.make_train_step(cfg, sched, DYN_D, port.adamw(),
                                      device=device, dynamics=True)
        before = {n: p.detach().clone() for n, p in named.items()}
        _, st = step(model, port.adamw().init(model), x, y)
        want = plain_stats(cfg.n_layers, DYN_D, grads_off, before, {
            n: before[n] - p.detach() for n, p in named.items()})
        want["sq_mb"] = torch.tensor(sq_ref, dtype=torch.float64)
        check(set(st) == set(want), f"train step stats {sorted(st)}")
        step_err = stats_rel_err(st, want)
        print(f"  (b) f32 1F1B make_train_step(dynamics=True): its "
              f"{len(st)} statistics within {step_err:.2e} of plain norms "
              f"of its gradients, parameters and update (sq_mb of the "
              f"single-device passes)")
        check(step_err <= 1e-4, f"train step stats rel err {step_err}")
        gates["train_step_stats_rel_err"] = step_err
        res["f32"] = dict(gates, seconds=time.perf_counter() - t0)
        del grads_off, st, st_ref, before, want

        # (c) bf16 fit with dynamics on a learnable token file (a 1/rank
        # unigram: on uniform tokens the noise drowns the mean gradient
        # and the noise scale has no positive |G|^2): the guarded run (NaN
        # gradients in stage 1 at step 3) with a report and the sync
        # probe, then tokens/s with dynamics on and off in turns
        t0 = time.perf_counter()
        cfg16 = dataclasses.replace(cfg, dtype="bfloat16",
                                    param_dtype="float32")
        sched = port.ScheduleConfig("1F1B", DYN_M)
        path = str(tmp / "tokens.bin")
        write_token_file(path, zipf_tokens(DYN_TOKENS, cfg.vocab_size, SEED))

        def batches():
            return prefetch_to_device(TokenFileDataset(
                path, TRAIN_S, seed=SEED).batches(DYN_TIME_B), 2, device,
                digest=True)

        def run(dyn, data=None, **kw):
            model.load_state_dict(init_state)
            if data is None:
                data = batches()
            ttrain.fit(cfg16, sched, DYN_D, model, data, DYN_STEPS,
                       optimizer=port.adamw(warmup_steps=2, total_steps=20),
                       log_every=DYN_LOG, verbose=False, device=device,
                       dynamics=dyn, **kw)

        out = tmp / "report"
        probe = SyncCounter()
        data = probe.data(batches())
        for k in kernels:
            k.launches = 0
        with patched(ttrain, "make_train_step", probe.make), probe.watch():
            # stamped, so the report carries the cost model, corrected
            # by phase 13 (b)'s artifact, and its calibration section
            run(True, data=data, report_dir=str(out),
                guard=resilience.AnomalyGuard(),
                fault_plan=resilience.FaultPlan(nan_grad_steps=(3,),
                                                nan_grad_stage=1),
                telemetry=tm.PipelineTelemetry())
        launches["dynamics_fit"] = {k.name: k.launches for k in kernels}
        manifest = json.loads((out / "report.json").read_text())
        tm.validate_report(manifest)
        sec = manifest["dynamics"]
        events = [json.loads(ln) for ln in
                  (out / "events.jsonl").read_text().splitlines()]
        attributed = [e for e in events if e["kind"] == "anomaly_attributed"]
        bundles = sorted(out.glob("forensics_*.json"))
        for b in bundles:
            dynamics.validate_forensic_bundle(json.loads(b.read_text()))
        print(f"  (c) bf16 fit, {DYN_STEPS} steps, log every {DYN_LOG}: "
              f"gns {sec['gns']} over {sec['gns_updates']} updates, final "
              f"grad norm {sec['grad_norm_final']:.4f}, attributed "
              f"{[(e['step'], e['stage'], e['statistic']) for e in attributed]}"
              f", bundles {[b.name for b in bundles]}; sync debug: "
              f"{probe.in_step} in the steps, {probe.in_data} in the data")
        check(sec["gns"] is not None and sec["gns_updates"] >= 3,
              f"dynamics section: gns {sec['gns']}, {sec['gns_updates']} "
              f"updates")
        check(len(attributed) == 1 and attributed[0]["stage"] == 1,
              f"anomaly_attributed events {attributed}")
        check(len(bundles) == 1 and "anomaly" in bundles[0].name,
              f"forensic bundles {bundles}")
        check(sum(probe.in_step[1:]) == 0 and sum(probe.in_data[1:]) == 0,
              f"a synchronising call between log points: steps "
              f"{probe.in_step}, data {probe.in_data}")
        rates = {True: [], False: []}
        for dyn in (True, False, False, True):
            metrics = tmp / f"m_{len(rates[True]) + len(rates[False])}.jsonl"
            run(dyn, metrics_path=str(metrics))
            windows = [x["tokens_per_sec"] for x in
                       map(json.loads, metrics.read_text().splitlines())]
            rates[dyn].append(windows[1:])
        on = statistics.median(v for w in rates[True] for v in w)
        off = statistics.median(v for w in rates[False] for v in w)
        print(f"  (c) bf16 fit tokens/s (windows after the first, median): "
              f"dynamics on {on:.1f}, off {off:.1f}, on / off {on / off:.4f}"
              f" (runs in turns: on, off, off, on)")
        res["bf16_fit"] = dict(
            calibration=calibrated_record(manifest),
            section={k: sec[k] for k in ("gns", "gns_updates",
                                         "grad_norm_final",
                                         "n_skipped_attributed")},
            attributed=attributed, bundles=[b.name for b in bundles],
            sync_debug=dict(in_step=probe.in_step, in_data=probe.in_data),
            tokens_per_s_on=rates[True], tokens_per_s_off=rates[False],
            on_over_off=on / off, seconds=time.perf_counter() - t0)
        del model
        torch.cuda.empty_cache()

        # (d) the sweep: the L8/H8 rows at D = 2 with the dynamics pass,
        # and one row on the searched artifact
        t0 = time.perf_counter()
        rows = sweep_rows(layers=(8,), heads=(8,), devices=(2,),
                          schedules=SCHEDULES, dynamics=True, device=device,
                          verbose=False)
        art_row = run_one_experiment(8, 8, DYN_D, "GPipe", device=device,
                                     schedule_artifact=str(art),
                                     dynamics=True)
        # the rows' uniform random tokens give no positive |G|^2, so their
        # noise scale may be None (the JAX estimator's contract)
        check(len(rows) == 3 and all(
            r.get("grad_norm_final", 0) > 0 and "gns" in r for r in rows),
            f"sweep rows {rows}")
        check("error" not in art_row
              and art_row.get("schedule_artifact_digest") == digest
              and art_row["n_microbatches"] == DYN_M,
              f"the artifact's row {art_row}")
        health = summarize_dynamics(rows + [dict(art_row,
                                                 schedule=searched.name)])
        for r in rows + [art_row]:
            print(f"  (d) sweep row L8/H8 D={r.get('num_processes', DYN_D)} "
                  f"{r.get('schedule', searched.name)}: "
                  f"{r['throughput']:.1f} tokens/s, grad_norm_final "
                  f"{r['grad_norm_final']:.4f}, gns {r['gns']}"
                  + (f", artifact {r['schedule_artifact_digest'][:12]}"
                     if "schedule_artifact_digest" in r else ""))
        res["sweep"] = dict(rows=[{k: r.get(k) for k in (
            "schedule", "throughput", "grad_norm_final", "gns",
            "n_skipped_attributed")} for r in rows],
            artifact_row={k: art_row[k] for k in (
                "throughput", "grad_norm_final", "gns",
                "schedule_artifact_digest", "n_microbatches")},
            health=health, seconds=time.perf_counter() - t0)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["dynamics"] = res
    return launches


# phase 13: the cost model's calibration on the card, and serving's cost
# and memory instruments at full width
CAL_OUT = Path("chip_smoke_out") / "calibration"
SWEEP_REPORTS = Path("chip_smoke_out") / "sweep_reports"  # phase 7 (d)'s
BENCH_N = 8  # (c)'s requests a bench (the phase-6 mixes' lengths)
CAL_BUDGET_S = 45.0  # phase 13 is held to this, both parts together


def derated_rel_err(rec, cf):
    """The signed error of a row's step priced ``compute_s / e_flops +
    comm_s / e_bw`` (the fit's model: the roofline's compute sum and hop
    sum scale exactly by the two efficiencies)."""
    c, k, m = rec["compute_s"], rec["comm_s"] or 0.0, rec["measured_step_s"]
    return (c / cf.flops_efficiency + k / cf.bandwidth_efficiency - m) / m


def phase_calibration(report, device="cuda"):
    """Phase 13 (a) and the fit of (b) (see the module doc): run after
    phase 7, whose sweep rows (b) fits, and before phases 8 and 12, whose
    ``fit`` reports then carry that correction. Returns the probes'
    kernel launches."""
    import shutil
    import torch
    from distributed_training_with_pipeline_parallelism_tpu_torch.analysis import (
        calibration as cal)
    from distributed_training_with_pipeline_parallelism_tpu_torch import (
        ModelConfig)
    from distributed_training_with_pipeline_parallelism_tpu_torch.analysis.cost_model import (
        cost_model_section, detect_hardware)
    from distributed_training_with_pipeline_parallelism_tpu_torch.parallel.schedules import (
        compile_schedule)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils import (
        telemetry as tm)
    card = report["card"]
    hw = detect_hardware(device).name
    check(hw == "h100", f"probe hardware {hw} on {device}, not the cpu")
    kernels = all_kernels()
    t0 = time.perf_counter()
    if CAL_OUT.exists():
        shutil.rmtree(CAL_OUT)
    CAL_OUT.mkdir(parents=True)
    res = {}

    # (a) the smoke grid on the card, its ledger and its correction
    specs = cal.probe_grid("smoke", seed=SEED)
    check(len(specs) == 9 and sum(s.comm_overlap == "ring"
                                  for s in specs) == 4,
          f"the smoke grid: {[s.label for s in specs]}")
    for k in kernels:
        k.launches = 0
    measured = [(spec, cal.run_probe(spec, seed=SEED, device=device))
                for spec in specs]
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    fit = cal.fit_corrections([row for _, row in measured])
    check(set(fit) == {hw}, f"probe fit for {sorted(fit)}")
    rows = [cal.reprice_row(row, spec, fit) for spec, row in measured]
    ledger = CAL_OUT / "probe_ledger.jsonl"
    cal.append_ledger_rows(str(ledger), rows)
    reread, _ = cal.load_ledger(str(ledger), strict=True)
    check([cal.canonical_row_line(r) for r in reread] ==
          [cal.canonical_row_line(r) for r in rows],
          "the probe ledger did not read back verbatim")
    art = CAL_OUT / "probe_corrections.json"
    cal.save_correction_artifact(cal.correction_artifact(fit), str(art))
    refit = cal.fit_corrections(list(reversed(reread)))
    check(cal.correction_artifact_bytes(cal.correction_artifact(refit))
          == art.read_bytes(), "a second fit over the ledger's rows gave "
          "other artifact bytes")
    tampered = json.loads(art.read_text())
    tampered["corrections"][hw]["flops_efficiency"] *= 0.5
    try:
        cal.load_correction_artifact(tampered)
        refused = False
    except cal.CalibrationError:
        refused = True
    check(refused, "a tampered correction artifact loaded")
    section = cal.calibration_section(rows, correction=fit,
                                      ledger_path=str(ledger))
    probe_report = tm.RunReport(name="calibration_probe")
    probe_report.attach_calibration(section)
    tm.validate_report(probe_report.manifest())
    summary = section["summary"]
    raw_med = summary["median_abs_rel_err_raw"]
    cor_med = summary["median_abs_rel_err_corrected"]
    check(raw_med is not None and cor_med is not None and cor_med < raw_med,
          f"probes: corrected median |rel err| {cor_med} not below the raw "
          f"{raw_med}")
    # the corrected sandwich: comm_overlap <= serial on every row (it
    # holds tick by tick); overlapped <= comm_overlap on the JAX
    # calibration pass's tables under this fit (the two attributions
    # differ by a tick, so a row may break it: printed, not gated)
    cf = fit[hw]
    unordered = []
    for spec, row in zip(specs, rows):
        c = row["corrected"]
        check(row["backend"] == "cuda" and row["hardware"] == hw
              and row["measured"].get("peak_bytes", 0) > 0,
              f"probe {spec.label}: {row['backend']} {row['hardware']} "
              f"{row['measured']}")
        check(c["step_s_comm_overlap"] <= c["step_s"] * (1 + 1e-12),
              f"probe {spec.label}: corrected comm_overlap above serial {c}")
        if c["step_s_overlapped"] > c["step_s_comm_overlap"] * (1 + 1e-12):
            unordered.append((spec.label, c["step_s_overlapped"]
                              / c["step_s_comm_overlap"]))
    pcfg = ModelConfig(**cal._PROBE_MODEL)
    for name, d, v, m in (("GPipe", 2, 1, 4), ("1F1B", 4, 1, 8),
                          ("ZBH1", 4, 1, 8)):
        c = cost_model_section(compile_schedule(name, d, v, m), pcfg,
                               batch_size=8, seq_length=16,
                               hardware=detect_hardware(device),
                               correction=cf)["predicted"]["corrected"]
        check(c["step_s_overlapped"] <= c["step_s_comm_overlap"] + 1e-12
              <= c["step_s"] + 1e-12,
              f"the corrected sandwich on {name} D={d} M={m}: {c}")
    print(f"  (a) {len(rows)} probes (smoke grid, seed {SEED}, 4 ring), "
          f"launches {launches}; fitted {hw} e_flops "
          f"{cf.flops_efficiency:.6g}, e_bw {cf.bandwidth_efficiency:.6g} "
          f"(residual rms {cf.residual_rms:.3e} s); the refit gives the "
          f"artifact's bytes, a tampered artifact is refused; median "
          f"|rel err| raw {raw_med:.6f}, corrected {cor_med:.6f}; the "
          f"corrected sandwich holds on the calibration pass's tables, "
          f"overlapped above comm_overlap on {unordered} [{card}]")
    for spec, row in zip(specs, rows):
        print(f"    {spec.label:<42} measured "
              f"{row['measured']['step_s'] * 1e3:8.3f} ms, predicted "
              f"{row['predicted']['step_s'] * 1e3:.6f} ms raw, "
              f"{row['corrected']['step_s'] * 1e3:8.3f} ms corrected; "
              f"rel_err {row['rel_err']['step_s']:+.6f} raw, "
              f"{row['corrected']['rel_err_step_s']:+.6f} corrected; peak "
              f"{row['measured'].get('peak_bytes', 0) / 2 ** 20:.1f} MiB "
              f"(predicted {row['predicted']['peak_bytes'] / 2 ** 20:.3f})")
    res["probes"] = dict(
        rows=rows, launches=launches, correction=cf.summary(),
        overlapped_above_comm_overlap=unordered,
        median_abs_rel_err_raw=raw_med,
        median_abs_rel_err_corrected=cor_med, groups=summary["groups"])

    # (b) the f32 sweep rows of phase 7 as ledger rows, their correction
    # loaded through the raising loader and put where fit and the sweep
    # look for one
    manifests = [json.loads(line) for line in
                 (SWEEP_REPORTS / "sweep_reports.jsonl").read_text()
                 .splitlines()]
    check(len(manifests) == 18, f"{len(manifests)} sweep manifests, not 18")
    srows = [cal.row_from_cost_model(m["cost_model"], source="sweep",
                                     name=m["meta"]["name"],
                                     backend=torch.device(device).type)
             for m in manifests]
    sfit = cal.fit_corrections(srows)
    check(set(sfit) == {hw}, f"sweep fit for {sorted(sfit)}")
    spath = CAL_OUT / "sweep_corrections.json"
    cal.save_correction_artifact(cal.correction_artifact(sfit), str(spath))
    loaded = cal.load_correction_artifact(str(spath))
    check(loaded == sfit, "the sweep correction did not load back")
    os.environ[cal.CORRECTIONS_ENV] = str(spath.resolve())
    scf = loaded[hw]
    sweep_errs = []
    for m, r in zip(manifests, srows):
        rec = dict(compute_s=r["predicted"]["compute_s"],
                   comm_s=r["predicted"]["comm_s"],
                   measured_step_s=r["measured"]["step_s"])
        sweep_errs.append(dict(
            name=m["meta"]["name"], rel_err=r["rel_err"]["step_s"],
            rel_err_sweep_fit=derated_rel_err(rec, scf),
            rel_err_probe_fit=derated_rel_err(rec, cf)))
    med = {k: statistics.median(abs(e[k]) for e in sweep_errs)
           for k in ("rel_err", "rel_err_sweep_fit", "rel_err_probe_fit")}
    print(f"  (b) 18 f32 sweep rows of phase 7 as ledger rows: fitted {hw} "
          f"e_flops {scf.flops_efficiency:.6g}, e_bw "
          f"{scf.bandwidth_efficiency:.6g} (residual rms "
          f"{scf.residual_rms:.3e} s), loaded by load_correction_artifact "
          f"and set as {cal.CORRECTIONS_ENV} for phases 8-12; median "
          f"|rel err| raw {med['rel_err']:.6f}, under the sweep fit "
          f"{med['rel_err_sweep_fit']:.6f}, under the probe fit "
          f"{med['rel_err_probe_fit']:.6f}")
    res["hardware"] = hw
    res["sweep"] = dict(rows=sweep_errs, correction=scf.summary(),
                        median_abs=med)
    res["seconds_fit"] = time.perf_counter() - t0
    report["calibration"] = res
    return launches


def phase_calibration_serving(report, device="cuda"):
    """Phase 13 (b)'s checks of the corrected ``fit`` reports and (c), the
    serving benches (see the module doc); returns the benches' kernel
    launches."""
    import torch
    import distributed_training_with_pipeline_parallelism_tpu_torch as port
    from distributed_training_with_pipeline_parallelism_tpu_torch import (
        serving)
    from distributed_training_with_pipeline_parallelism_tpu_torch.analysis import (
        calibration as cal)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils import (
        telemetry as tm)
    card = report["card"]
    res = report["calibration"]
    t0 = time.perf_counter()
    pcf = cal.CorrectionFactors(**res["probes"]["correction"])
    scf = cal.CorrectionFactors(**res["sweep"]["correction"])

    # (b) the fit runs that ran under the sweep's correction
    runs = {}
    for label, rec in (
            ("phase 8 (b) f32 fit, 4 layers, B=8",
             report["fit"]["report"]["calibration"]),
            ("phase 12 (c) bf16 fit, untied, B=24",
             report["dynamics"]["bf16_fit"]["calibration"])):
        cal_sec = rec["calibration"] or {}
        check(rec["corrected"] is not None and cal_sec.get("correction")
              and res["hardware"] in cal_sec["correction"],
              f"{label}: the report has no corrected cost model or "
              f"calibration section ({rec})")
        check(cal_sec["correction"][res["hardware"]] == scf.summary(),
              f"{label}: a correction other than the sweep's")
        check(cal_sec["rows"][0]["rel_err_corrected"]
              == rec["rel_err_corrected"] is not None,
              f"{label}: the calibration row's error is not the cost "
              f"model's")
        runs[label] = dict(rec, rel_err_probe_fit=derated_rel_err(rec, pcf))
        print(f"  (b) {label}: measured {rec['measured_step_s'] * 1e3:.2f} "
              f"ms a step, predicted {rec['predicted_step_s'] * 1e3:.3f} ms "
              f"raw (rel_err {rec['rel_err']:+.6f}), "
              f"{rec['corrected']['step_s'] * 1e3:.2f} ms under the sweep "
              f"fit (rel_err {rec['rel_err_corrected']:+.6f}), rel_err "
              f"{runs[label]['rel_err_probe_fit']:+.6f} under the probe "
              f"fit; report valid with its calibration section [{card}]")
    res["fit_runs"] = runs

    # (c) the paged and speculative benches, Llama-3.2-1B, f32, on the
    # phase 5-6 geometry and mixes
    kernels = all_kernels()
    for k in kernels:
        k.launches = 0
    cfg = llama_main_config()
    model = port.init_params(cfg, torch.Generator(device=device)
                             .manual_seed(SEED), device)
    common = dict(cfg=cfg, model=model, n_stages=D, n_requests=BENCH_N,
                  seed=SEED, mixes=PREFIX_MIXES, load=SERVE_LOAD,
                  device=device, **SERVE)
    rows, reports = {}, {}
    for name, fn, kw in (
            ("paged", serving.run_paged_bench,
             dict(page_size=PAGE_SIZE, mix="prefix")),
            ("speculative", serving.run_spec_bench,
             dict(gamma=SPEC_GAMMA, mix="serve", reps=1))):
        rep = tm.RunReport(name=f"{name}_bench")
        t = time.perf_counter()
        row = fn(report=rep, **kw, **common)
        wall = time.perf_counter() - t
        manifest = rep.manifest()
        tm.validate_report(manifest)
        check(row["outputs_match"], f"{name} bench: outputs differ")
        check({"cost_model", "memory"} <= set(manifest)
              and {"cost_model", "memory"} <= set(row),
              f"{name} bench: a serving section is missing "
              f"({sorted(manifest)}, {sorted(row)})")
        check(isinstance(row["predicted_s_per_tick"], float)
              and row["predicted_s_per_tick"] > 0,
              f"{name} bench: predicted_s_per_tick "
              f"{row['predicted_s_per_tick']}")
        for eng in row["cost_model"]:
            summ = row[eng]
            pred = row["cost_model"][eng]["predicted"]["step_s"]
            alloc = row["memory"][eng].get("allocator") or {}
            analytic = row["memory"][eng]["analytic"]
            print(f"  (c) f32 {name} bench, {eng}: {summ['n_requests']} "
                  f"requests, {summ['ticks']} ticks, s_per_tick measured "
                  f"{summ['s_per_tick']:.6f}, predicted {pred:.9f} "
                  f"(predicted / measured {pred / summ['s_per_tick']:.6f}); "
                  f"memory analytic {analytic['peak_bytes'] / 2 ** 30:.3f} "
                  f"GiB a stage, allocator peak "
                  f"{alloc.get('max_memory_allocated_bytes', 0) / 2 ** 30:.3f}"
                  f" GiB on the card [{card}]")
        rows[name] = {k: v for k, v in row.items()
                      if k not in ("serving_load",)}
        reports[name] = dict(wall_s=wall, sections=sorted(manifest))
        print(f"  (c) {name} bench: outputs_match, the report valid with "
              f"{sorted(manifest)}, {wall:.1f} s")
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    print(f"  (c) kernel launches in the benches: {launches} (the engine "
          f"attends its caches densely)")
    res["benches"] = dict(rows=rows, reports=reports, launches=launches)
    del model
    torch.cuda.empty_cache()
    res["seconds_serving"] = time.perf_counter() - t0
    res["seconds"] = res["seconds_fit"] + res["seconds_serving"]
    print(f"  phase 13 took {res['seconds']:.1f} s "
          f"({res['seconds_fit']:.1f} after phase 7, "
          f"{res['seconds_serving']:.1f} here; held to {CAL_BUDGET_S:.0f})")
    return launches


# The model sources (phase 18): HF-named state dicts made on the card by
# the port's exporters from seeded port models, read back by
# models.hf.from_hf under the published config.json fields of three
# checkpoints (no transformers, no tokenizers, nothing downloaded)
HF_CONFIGS = {
    # openai-community/gpt2: GPT2Config()'s defaults
    "gpt2": dict(model_type="gpt2", vocab_size=50257, n_positions=1024,
                 n_embd=768, n_layer=12, n_head=12, n_inner=None,
                 activation_function="gelu_new", layer_norm_epsilon=1e-5,
                 tie_word_embeddings=True),
    # google/gemma-2b (tie_word_embeddings: GemmaConfig's default)
    "gemma-2b": dict(model_type="gemma", vocab_size=256000, hidden_size=2048,
                     intermediate_size=16384, num_hidden_layers=18,
                     num_attention_heads=8, num_key_value_heads=1,
                     head_dim=256, hidden_act="gelu", hidden_activation=None,
                     max_position_embeddings=8192, rms_norm_eps=1e-6,
                     rope_theta=10000.0, rope_scaling=None,
                     attention_bias=False, tie_word_embeddings=True),
    # Qwen/Qwen2-0.5B
    "qwen2-0.5b": dict(model_type="qwen2", vocab_size=151936, hidden_size=896,
                       intermediate_size=4864, num_hidden_layers=24,
                       num_attention_heads=14, num_key_value_heads=2,
                       hidden_act="silu", max_position_embeddings=131072,
                       rms_norm_eps=1e-6, rope_theta=1000000.0,
                       use_sliding_window=False, sliding_window=131072,
                       max_window_layers=24, tie_word_embeddings=True),
}
HF_D, HF_M = 2, 2  # (b), (c): decode over D lockstep stages, M streams
HF_B, HF_P, HF_N = 4, 256, 16  # prompts, their length, new tokens
# (a): fit over a seeded token file, then greedy tokens from 4 prompts
HF_FIT_B, HF_FIT_M, HF_FIT_STEPS, HF_FIT_TOKENS = 8, 4, 10, 1 << 20
# (b): the f32 gradient gate at 4 of Gemma-2B's 18 layers; the bf16 step
# at all 18, timed over GEMMA_TIMED steps
GEMMA_GATE_LAYERS, GEMMA_GATE_B, GEMMA_GATE_S, GEMMA_GATE_M = 4, 4, 512, 2
GEMMA_B, GEMMA_M, GEMMA_TIMED = 8, 4, 3
GEMMA_SHAPE = [GEMMA_B // GEMMA_M, TRAIN_S, 8, 256]  # 8 heads from 1
GEMMA_PREFILL_SHAPE = [HF_B // HF_M, HF_P, 8, 256]
GEMMA_XENT_ROWS, GEMMA_VOCAB = GEMMA_B // GEMMA_M * TRAIN_S, 256000
QWEN_PREFILL_SHAPE, QWEN_VOCAB = [HF_B // HF_M, HF_P, 14, 64], 151936
HF_BUDGET_S = 90.0  # phase 18 is held to this


class HFSource:
    """What ``models.hf.from_hf`` reads of a transformers causal LM: its
    ``config`` (here the published config.json fields) and
    ``state_dict()``."""

    def __init__(self, name, state, **fields):
        import types
        self.config = types.SimpleNamespace(**dict(HF_CONFIGS[name],
                                                   **fields))
        self._state = state

    def state_dict(self):
        return self._state


def hf_registry(name):
    """The port's registry config of an HF_CONFIGS entry (f32, routing
    as the registry leaves it)."""
    from distributed_training_with_pipeline_parallelism_tpu_torch import (
        gpt2_config, llama_config)
    if name == "gpt2":  # the registry's GPT-2 is untied, GPT2Config() ties
        return gpt2_config("small", tie_embeddings=True)
    return llama_config(name)


def hf_layout(c):
    """{name: shape} of the state dict that the transformers class of
    config ``c`` (a namespace of config.json fields) holds, less a tied
    ``lm_head.weight`` (transformers ties it to the embedding):
    ``GPT2LMHeadModel``'s ([in, out] ``Conv1D`` matrices, q/k/v packed in
    ``c_attn``) or ``GemmaForCausalLM``'s / ``Qwen2ForCausalLM``'s
    ([out, in] ``nn.Linear`` matrices; Qwen2's q/k/v biases)."""
    if c.model_type == "gpt2":
        d, f, v = c.n_embd, c.n_inner or 4 * c.n_embd, c.vocab_size
        out = {"transformer.wte.weight": (v, d),
               "transformer.wpe.weight": (c.n_positions, d),
               "transformer.ln_f.weight": (d,), "transformer.ln_f.bias": (d,)}
        for i in range(c.n_layer):
            p = f"transformer.h.{i}."
            out.update({
                p + "ln_1.weight": (d,), p + "ln_1.bias": (d,),
                p + "attn.c_attn.weight": (d, 3 * d),
                p + "attn.c_attn.bias": (3 * d,),
                p + "attn.c_proj.weight": (d, d), p + "attn.c_proj.bias": (d,),
                p + "ln_2.weight": (d,), p + "ln_2.bias": (d,),
                p + "mlp.c_fc.weight": (d, f), p + "mlp.c_fc.bias": (f,),
                p + "mlp.c_proj.weight": (f, d), p + "mlp.c_proj.bias": (d,)})
    else:
        d, f, v = c.hidden_size, c.intermediate_size, c.vocab_size
        hd = getattr(c, "head_dim", None) or d // c.num_attention_heads
        q, kv = c.num_attention_heads * hd, c.num_key_value_heads * hd
        out = {"model.embed_tokens.weight": (v, d), "model.norm.weight": (d,)}
        for i in range(c.num_hidden_layers):
            p = f"model.layers.{i}."
            out.update({
                p + "input_layernorm.weight": (d,),
                p + "self_attn.q_proj.weight": (q, d),
                p + "self_attn.k_proj.weight": (kv, d),
                p + "self_attn.v_proj.weight": (kv, d),
                p + "self_attn.o_proj.weight": (d, q),
                p + "post_attention_layernorm.weight": (d,),
                p + "mlp.gate_proj.weight": (f, d),
                p + "mlp.up_proj.weight": (f, d),
                p + "mlp.down_proj.weight": (d, f)})
            if c.model_type == "qwen2":
                out.update({p + "self_attn.q_proj.bias": (q,),
                            p + "self_attn.k_proj.bias": (kv,),
                            p + "self_attn.v_proj.bias": (kv,)})
    if not c.tie_word_embeddings:
        out["lm_head.weight"] = (v, d)
    return out


@contextlib.contextmanager
def launch_shapes():
    """Inside the block, each launch of the four kernels by kernel, shape
    and dtype code (``{"flash_fwd [2, 1024, 8, 256] dtype 1": n, ...}``),
    the wrappers' counters set to 0 first; after it, ``out["launches"]``
    holds the counters and ``out["shapes"]`` the shapes."""
    import torch
    from distributed_training_with_pipeline_parallelism_tpu_torch.ops.flash_attention import (
        FLASH_BWD, FLASH_FWD)
    from distributed_training_with_pipeline_parallelism_tpu_torch.ops.fused_xent import (
        XENT_BWD, XENT_FWD)
    # each C entry's dtype code and the dims after it: flash_fwd's five
    # pointers and flash_bwd's ten, then b, s, h, dh; xent_fwd's four
    # pointers and xent_bwd's five, then n, v
    where = {FLASH_FWD: 5, FLASH_BWD: 10, XENT_FWD: 4, XENT_BWD: 5}
    out = {"shapes": {}}
    torch.cuda.synchronize()
    real = {k: k.call for k in where}

    def counting(kernel, at):
        dims = 4 if kernel in (FLASH_FWD, FLASH_BWD) else 2

        def call(fn, *args):
            key = (f"{kernel.name} {list(args[at + 1:at + 1 + dims])} "
                   f"dtype {args[at]}")
            out["shapes"][key] = out["shapes"].get(key, 0) + 1
            return real[kernel](fn, *args)
        return call

    for k, at in where.items():
        k.launches = 0
        k.call = counting(k, at)
    try:
        yield out
        torch.cuda.synchronize()
    finally:
        for k in where:
            k.call = real[k]
    out["launches"] = {k.name: k.launches for k in where}


def check_launch_shapes(what, rec, want, shapes):
    """The counted launches equal the tick table's ``want``, and every
    launch took one of ``shapes`` ({kernel: "[dims] dtype code"})."""
    check(rec["launches"] == want, f"{what}: kernel launches "
          f"{rec['launches']} != the table's {want}")
    bad = {k: n for k, n in rec["shapes"].items()
           if k.split(" ", 1)[1] != shapes.get(k.split(" ", 1)[0])}
    check(not bad, f"{what}: launches at other shapes than {shapes}: {bad}")


def pipeline_launches(n_layers, m, steps=1):
    """A 1F1B step's launches under the rematerialising backward (phase
    4's count): the forward kernel twice a (layer, microbatch), the
    backward once, each xent kernel once a microbatch."""
    return {"flash_fwd": 2 * m * n_layers * steps,
            "flash_bwd": m * n_layers * steps,
            "xent_fwd": m * steps, "xent_bwd": m * steps}


def phase_model_sources(report, device="cuda"):
    """The model sources on the card (see the module doc): (a) GPT-2-small
    imported, fitted, decoded, exported and imported again; (b) Gemma-2B's
    round trip, f32 decode, f32 gradient gate at 4 layers and bf16 step at
    18; (c) Qwen2-0.5B's round trip and f32 decode. Returns each path's
    launches."""
    import shutil
    import tempfile
    import torch
    import distributed_training_with_pipeline_parallelism_tpu_torch as port
    from distributed_training_with_pipeline_parallelism_tpu_torch.models import (
        hf)
    from distributed_training_with_pipeline_parallelism_tpu_torch.models.transformer import (
        transformer_apply, transformer_loss)
    from distributed_training_with_pipeline_parallelism_tpu_torch.utils.data import (
        TokenFileDataset, prefetch_to_device, write_token_file)
    t0 = time.perf_counter()
    card = report["card"]
    res, paths = {}, {}
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()

    def seconds():
        return round(time.perf_counter() - t0, 1)

    def export(cfg, model):
        return (hf.gpt2_state_dict(cfg, model) if cfg.arch == "gpt2" else
                hf.llama_state_dict(cfg, model,
                                    1.0 if cfg.embed_scale else 0.0))

    def same_weights(a, b, what):
        sa, sb = a.state_dict(), b.state_dict()
        check(sa.keys() == sb.keys(), f"{what}: other parameter names")
        bad = [k for k in sa if not torch.equal(sa[k], sb[k])]
        check(not bad, f"{what}: not bitwise equal at {bad[:4]}")

    def source(name):
        """The seeded port model of the registry config, its HF-named state
        dict (the exporter's, on the card; layout checked) and the model
        ``from_hf`` reads back from it, whose config must be the
        registry's but for max_seq_len and the dtypes and whose weights
        the seeded model's, bitwise; the re-export is the state dict,
        bitwise."""
        cfg = hf_registry(name)
        model = port.init_params(
            cfg, torch.Generator(device=device).manual_seed(SEED), device)
        state = export(cfg, model)
        src = HFSource(name, state)
        layout = {k: tuple(v.shape) for k, v in state.items()}
        want = hf_layout(src.config)
        check(layout == want, f"{name}: exported layout differs from the HF "
              f"class's at {sorted(set(layout.items()) ^ set(want.items()))[:4]}")
        check(all(v.dtype == torch.float32 and v.device == model.tok.device
                  for v in state.values()),
              f"{name}: exported tensors not float32 on {device}")
        got_cfg, got = hf.from_hf(src, device=device)
        diff = [f.name for f in dataclasses.fields(cfg)
                if f.name not in ("max_seq_len", "dtype", "param_dtype")
                and getattr(cfg, f.name) != getattr(got_cfg, f.name)]
        check(not diff, f"{name}: from_hf's config differs from the "
              f"registry's in {diff}")
        same_weights(model, got, f"{name}: export then import")
        again = export(got_cfg, got)
        bad = [k for k in state if not torch.equal(state[k], again[k])]
        check(not bad, f"{name}: import then export not bitwise at {bad[:4]}")
        n = sum(p.numel() for p in got.parameters())
        print(f"  {name}: {n} params; {len(state)} HF-named tensors in the "
              f"{'GPT2LMHeadModel' if cfg.arch == 'gpt2' else src.config.model_type} "
              f"layout; from_hf's config the registry's; export and import "
              f"bitwise both ways ({seconds()} s)")
        del again, model
        return src, got_cfg, got

    def decode_gate(name, cfg, model, shapes):
        """The f32 decode gate (phase 3's rule): the kernel run's tokens
        those of the plain run and of single-device ``generate``, its
        log-probs within 1e-4; K4/K2 at the prefill and K1 on the head,
        counted at their shapes."""
        prompt = torch.randint(0, cfg.vocab_size, (HF_B, HF_P),
                               generator=torch.Generator().manual_seed(SEED + 7)
                               ).to(device)
        kern = dataclasses.replace(cfg, use_flash_attention=True,
                                   use_fused_xent=True)
        plain = dataclasses.replace(cfg, use_flash_attention=False,
                                    use_fused_xent=False)
        with launch_shapes() as rec:
            toks, lps = port.make_pipeline_generate_fn(
                kern, HF_D, HF_N, n_streams=HF_M, return_logprobs=True,
                device=device)(model, prompt)
        want = {"flash_fwd": cfg.n_layers * HF_M, "flash_bwd": 0,
                "xent_fwd": HF_M * HF_N, "xent_bwd": 0}
        check_launch_shapes(f"{name} f32 decode", rec, want, shapes)
        toks_p, lps_p = port.make_pipeline_generate_fn(
            plain, HF_D, HF_N, n_streams=HF_M, return_logprobs=True,
            device=device)(model, prompt)
        toks_s, lps_s = port.generate(kern, model, prompt, HF_N,
                                      return_logprobs=True, device=device)
        check(toks.shape == (HF_B, HF_P + HF_N) and bool(
            torch.isfinite(lps).all() and (lps <= 0).all()),
            f"{name}: tokens {tuple(toks.shape)}, log-probs not finite")
        out = dict(launches=rec["launches"], shapes=rec["shapes"])
        out["vs_plain"] = compare_tokens(
            f"{name} f32 decode vs plain", toks, toks_p, lps, lps_p,
            top2_gap_of(cfg, model, toks_p, HF_P), p=HF_P, n=HF_N)
        out["vs_generate"] = compare_tokens(
            f"{name} f32 decode vs generate", toks, toks_s, lps, lps_s,
            top2_gap_of(cfg, model, toks_s, HF_P), p=HF_P, n=HF_N)
        print(f"  {name} f32 decode (D={HF_D}, M={HF_M}, B={HF_B}, P={HF_P}, "
              f"N={HF_N}): launches {rec['shapes']} ({seconds()} s)")
        return out

    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-hf-"))
    try:
        # (a) the chain of the JAX package's scripts/hf_finetune.py
        src, cfg, model = source("gpt2")
        del src
        cfg16 = dataclasses.replace(cfg, dtype="bfloat16",
                                    param_dtype="float32",
                                    use_flash_attention=True,
                                    use_fused_xent=True)
        path = tmp / "tokens.bin"
        write_token_file(path, zipf_tokens(HF_FIT_TOKENS, cfg.vocab_size,
                                           SEED))
        data = prefetch_to_device(TokenFileDataset(
            str(path), TRAIN_S, seed=SEED).batches(HF_FIT_B), 2, device)
        t = time.perf_counter()
        with launch_shapes() as rec:
            model, history = port.fit(
                cfg16, port.ScheduleConfig("1F1B", HF_FIT_M), HF_D, model,
                data, HF_FIT_STEPS,
                optimizer=port.adamw(warmup_steps=2,
                                     total_steps=HF_FIT_STEPS),
                log_every=1, verbose=False, device=device)
        fit_s = time.perf_counter() - t
        mb = HF_FIT_B // HF_FIT_M
        check_launch_shapes(
            "gpt2 fit", rec, pipeline_launches(cfg.n_layers, HF_FIT_M,
                                               HF_FIT_STEPS),
            {"flash_fwd": f"{[mb, TRAIN_S, 12, 64]} dtype 1",
             "flash_bwd": f"{[mb, TRAIN_S, 12, 64]} dtype 1",
             "xent_fwd": f"{[mb * TRAIN_S, cfg.vocab_size]} dtype 1",
             "xent_bwd": f"{[mb * TRAIN_S, cfg.vocab_size]} dtype 1"})
        losses = [x for _, x in history]
        check(len(losses) == HF_FIT_STEPS and all(map(math.isfinite, losses))
              and losses[-1] < losses[0], f"gpt2 fit: losses {losses}")
        paths["hf_gpt2_fit"] = rec["launches"]
        res["gpt2"] = dict(fit_losses=losses, fit_s=fit_s,
                           fit_tokens_per_s=HF_FIT_STEPS * HF_FIT_B * TRAIN_S
                           / fit_s, fit_shapes=rec["shapes"])
        print(f"  gpt2 fit: {HF_FIT_STEPS} bf16 steps of B={HF_FIT_B} x "
              f"{TRAIN_S} (1F1B, D={HF_D}, M={HF_FIT_M}) in {fit_s:.2f} s "
              f"with its first step, losses {[round(x, 4) for x in losses]}; "
              f"launches {rec['launches']} as the table predicts [{card}]")
        prompt = torch.from_numpy(TokenFileDataset(
            str(path), HF_P, seed=SEED + 1).sample(HF_B)[0]).to(device)
        with launch_shapes() as rec:
            toks = port.make_pipeline_generate_fn(
                cfg16, HF_D, HF_N, n_streams=HF_M, device=device)(
                    model, prompt)
        check_launch_shapes(
            "gpt2 greedy decode", rec,
            {"flash_fwd": cfg.n_layers * HF_M, "flash_bwd": 0,
             "xent_fwd": 0, "xent_bwd": 0},
            {"flash_fwd": f"{[HF_B // HF_M, HF_P, 12, 64]} dtype 1"})
        check(toks.shape == (HF_B, HF_P + HF_N) and bool(
            ((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"gpt2 decode: tokens {tuple(toks.shape)} or out of vocab")
        paths["hf_gpt2_generate"] = rec["launches"]
        state = export(cfg, model)
        check({k: tuple(v.shape) for k, v in state.items()}
              == hf_layout(HFSource("gpt2", {}).config),
              "gpt2: the trained model's export left the HF layout")
        _, back = hf.from_hf(HFSource("gpt2", state), device=device)
        same_weights(model, back, "gpt2: the trained model exported and "
                     "imported")
        x = prompt[:, :TRAIN_S // 4]
        with torch.no_grad():
            check(torch.equal(transformer_apply(cfg, model, x),
                              transformer_apply(cfg, back, x)),
                  "gpt2: the re-imported model's logits are not bitwise "
                  "the trained model's")
        res["gpt2"]["generated"] = toks[:, HF_P:].tolist()
        print(f"  gpt2: {HF_N} greedy tokens from {HF_B} prompts; the trained "
              f"model exported and imported again: weights and f32 logits "
              f"bitwise ({seconds()} s)")
        del model, back, state, data
        torch.cuda.empty_cache()

        # (b) Gemma-2B at full width
        src, cfg, model = source("gemma-2b")
        small = {k: v for k, v in src.state_dict().items()
                 if not k.startswith("model.layers.")
                 or int(k.split(".")[2]) < GEMMA_GATE_LAYERS}
        cfg4, model4 = hf.from_hf(
            HFSource("gemma-2b", small, num_hidden_layers=GEMMA_GATE_LAYERS),
            device=device)
        del src, small
        torch.cuda.empty_cache()
        res["gemma"] = dict(decode=decode_gate(
            "gemma-2b", cfg, model,
            {"flash_fwd": f"{GEMMA_PREFILL_SHAPE} dtype 0",
             "xent_fwd": f"{[HF_B // HF_M, GEMMA_VOCAB]} dtype 0"}))
        paths["hf_gemma_decode"] = res["gemma"]["decode"]["launches"]

        def step_of(c, m, sched, tokens, targets):
            m.zero_grad(set_to_none=True)
            loss = port.make_pipeline_grad_fn(c, sched, HF_D, device=device)(
                m, tokens, targets)
            torch.cuda.synchronize()
            return loss.item()

        def grads_of(m):
            return {n: p.grad.clone() for n, p in m.named_parameters()}

        g = torch.Generator().manual_seed(SEED + 8)
        tokens, targets = (torch.randint(
            0, cfg.vocab_size, (GEMMA_GATE_B, GEMMA_GATE_S),
            generator=g).to(device) for _ in range(2))
        kern4 = dataclasses.replace(cfg4, use_flash_attention=True,
                                    use_fused_xent=True)
        plain4 = dataclasses.replace(cfg4, use_flash_attention=False,
                                     use_fused_xent=False)
        sched = port.ScheduleConfig("1F1B", GEMMA_GATE_M)
        mb = [GEMMA_GATE_B // GEMMA_GATE_M, GEMMA_GATE_S, 8, 256]
        with launch_shapes() as rec:
            loss_k = step_of(kern4, model4, sched, tokens, targets)
        check_launch_shapes(
            "gemma f32 step", rec,
            pipeline_launches(GEMMA_GATE_LAYERS, GEMMA_GATE_M),
            {"flash_fwd": f"{mb} dtype 0", "flash_bwd": f"{mb} dtype 0",
             "xent_fwd": f"{[mb[0] * mb[1], GEMMA_VOCAB]} dtype 0",
             "xent_bwd": f"{[mb[0] * mb[1], GEMMA_VOCAB]} dtype 0"})
        paths["hf_gemma_f32_step"] = rec["launches"]
        grads_k = grads_of(model4)
        loss_p = step_of(plain4, model4, sched, tokens, targets)
        grads_p = grads_of(model4)
        model4.zero_grad(set_to_none=True)
        loss_s = transformer_loss(kern4, model4, tokens, targets)
        loss_s.backward()
        loss_s = loss_s.item()
        gate = dict(loss=loss_k, launches=rec["launches"],
                    shapes=rec["shapes"])
        for what, l_ref, g_ref in (
                ("plain run", loss_p, grads_p),
                ("single device", loss_s, {n: p.grad for n, p in
                                           model4.named_parameters()})):
            rel = abs(loss_k - l_ref) / abs(l_ref)
            ratio, leaf, worst_rel = grad_errors(grads_k, g_ref)
            print(f"  gemma f32 1F1B step ({GEMMA_GATE_LAYERS} layers, "
                  f"B={GEMMA_GATE_B} x {GEMMA_GATE_S}, M={GEMMA_GATE_M}, "
                  f"D={HF_D}) vs {what}: loss {loss_k:.6f} vs {l_ref:.6f} "
                  f"(rel err {rel:.2e}), worst leaf {leaf} at {ratio:.3f} of "
                  f"its bound, max leaf rel err {worst_rel:.2e}")
            check(rel <= 1e-5, f"gemma f32 loss vs {what}: rel err {rel}")
            check(ratio <= 1.0, f"gemma f32 grads vs {what}: leaf {leaf} "
                  f"over its bound ({ratio})")
            gate[f"vs_{what.replace(' ', '_')}"] = dict(
                loss=l_ref, loss_rel_err=rel, worst_bound_ratio=ratio,
                worst_leaf=leaf, max_leaf_rel_err=worst_rel)
        res["gemma"]["f32_step"] = gate
        del model4, grads_k, grads_p
        torch.cuda.empty_cache()

        # the bf16 step over the imported f32 masters, all 18 layers
        g = torch.Generator().manual_seed(SEED + 9)
        tokens, targets = (torch.randint(
            0, cfg.vocab_size, (GEMMA_B, TRAIN_S), generator=g).to(device)
            for _ in range(2))
        kern16 = dataclasses.replace(cfg, dtype="bfloat16",
                                     param_dtype="float32",
                                     use_flash_attention=True,
                                     use_fused_xent=True)
        plain16 = dataclasses.replace(kern16, use_flash_attention=False,
                                      use_fused_xent=False)
        sched = port.ScheduleConfig("1F1B", GEMMA_M)
        with launch_shapes() as rec:
            loss_k = step_of(kern16, model, sched, tokens, targets)
        rows = GEMMA_XENT_ROWS
        check_launch_shapes(
            "gemma bf16 step", rec, pipeline_launches(cfg.n_layers, GEMMA_M),
            {"flash_fwd": f"{GEMMA_SHAPE} dtype 1",
             "flash_bwd": f"{GEMMA_SHAPE} dtype 1",
             "xent_fwd": f"{[rows, GEMMA_VOCAB]} dtype 1",
             "xent_bwd": f"{[rows, GEMMA_VOCAB]} dtype 1"})
        paths["hf_gemma_bf16_step"] = rec["launches"]
        grads_k = grads_of(model)
        loss_p = step_of(plain16, model, sched, tokens, targets)
        rel = abs(loss_k - loss_p) / abs(loss_p)
        ratio, leaf, worst_rel = grad_errors(
            grads_k, {n: p.grad for n, p in model.named_parameters()},
            rtol=5e-2, atol=1e-3)
        del grads_k
        model.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        print(f"  gemma bf16 1F1B step ({cfg.n_layers} layers, B={GEMMA_B} x "
              f"{TRAIN_S}, M={GEMMA_M}, D={HF_D}, f32 masters) vs plain "
              f"bf16: loss {loss_k:.6f} vs {loss_p:.6f} (rel err {rel:.2e}), "
              f"worst leaf {leaf} at {ratio:.3f} of its bound, max leaf rel "
              f"err {worst_rel:.2e}; launches {rec['shapes']}")
        check(math.isfinite(loss_k) and rel <= 1e-2,
              f"gemma bf16 loss vs plain: {loss_k} vs {loss_p}")
        check(ratio <= 1.0, f"gemma bf16 grads vs plain: leaf {leaf} over "
              f"its bound ({ratio})")
        fn = port.make_pipeline_grad_fn(kern16, sched, HF_D, device=device)
        fn(model, tokens, targets)  # warm-up
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(GEMMA_TIMED):
            model.zero_grad(set_to_none=True)
            fn(model, tokens, targets)
        torch.cuda.synchronize()
        step_s = (time.perf_counter() - t) / GEMMA_TIMED
        res["gemma"]["bf16_step"] = dict(
            loss=loss_k, loss_plain=loss_p, loss_rel_err=rel,
            worst_bound_ratio=ratio, worst_leaf=leaf,
            max_leaf_rel_err=worst_rel, launches=rec["launches"],
            shapes=rec["shapes"], step_s=step_s,
            tokens_per_s=GEMMA_B * TRAIN_S / step_s,
            max_memory_allocated=torch.cuda.max_memory_allocated()
            if device != "cpu" else None)
        print(f"  gemma bf16 step: {step_s * 1e3:.1f} ms, "
              f"{GEMMA_B * TRAIN_S / step_s:.1f} tokens/s over "
              f"{GEMMA_TIMED} steps (loss and gradients, no optimizer) "
              f"[{card}] ({seconds()} s)")
        del model, fn
        torch.cuda.empty_cache()

        # (c) Qwen2-0.5B at full width: q/k/v biases
        src, cfg, model = source("qwen2-0.5b")
        del src
        res["qwen2"] = dict(decode=decode_gate(
            "qwen2-0.5b", cfg, model,
            {"flash_fwd": f"{QWEN_PREFILL_SHAPE} dtype 0",
             "xent_fwd": f"{[HF_B // HF_M, QWEN_VOCAB]} dtype 0"}))
        paths["hf_qwen2_decode"] = res["qwen2"]["decode"]["launches"]
        del model
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    res["seconds"] = time.perf_counter() - t0
    print(f"  phase 18: {res['seconds']:.1f} s (held to {HF_BUDGET_S:.0f})"
          + (f", allocator peak {torch.cuda.max_memory_allocated() / 2**30:.1f}"
             f" GiB" if device != "cpu" else ""))
    check(res["seconds"] <= HF_BUDGET_S,
          f"phase 18 took {res['seconds']:.1f} s > {HF_BUDGET_S} s")
    report["model_sources"] = res
    return paths


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 2
    try:
        import distributed_training_with_pipeline_parallelism_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from the root of a checkout ({e})",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # every table a phase builds passes the static verifier at build
    # (phase 12 (a) counts the reports); the worlds' ranks inherit it
    os.environ["DTPP_VERIFY_TABLES"] = "1"
    report = {}
    t0 = time.perf_counter()
    seconds = report["phase_seconds"] = {}

    def phase(n, title, fn, *args):
        print(f"[{n}] {title}")
        t = time.perf_counter()
        out = fn(*args)
        seconds[str(n)] = time.perf_counter() - t
        print(f"  phase {n} took {seconds[str(n)]:.1f} s")
        return out

    phase(1, "device and toolchain", phase_toolchain, report)
    main_shapes = phase(2, "kernels against their plain versions",
                        phase_kernels, report)
    # phase 18 runs on the fresh card: Gemma-2B's gates need ~45 GB of it
    hf_launches = phase(
        18, "the model sources: HF-named GPT-2-small, Gemma-2B and "
        "Qwen2-0.5B through from_hf and the exporters, fit, decode and "
        "steps", phase_model_sources, report)
    torch.cuda.empty_cache()
    tables = []  # the verifier's reports of the tables phases 3-11 build
    from distributed_training_with_pipeline_parallelism_tpu_torch.analysis import (
        table_check)
    with patched(table_check, "check_table_cached", recording(tables)):
        decode_launches = phase(
            3, "decode path: GPT-2-small, 4 lockstep stages",
            phase_main_path, report)
        launches = phase(4, "training path: tied GPT-2-small, pipelined "
                         "steps", phase_train, report)
        llama_launches, serve_launches = phase(
            5, "llama path: Llama-3.2-1B, 4 lockstep stages, decode and "
            "continuous-batching serving", phase_llama, report)
        paged_spec_launches = phase(
            6, "paged KV and speculative serving: Llama-3.2-1B, 4 lockstep "
            "stages", phase_paged_spec, report)
        ref_launches = phase(7, "the reference's job: ref_decoder, "
                             "pipelined steps, dropout, the sweep",
                             phase_ref, report)
        probe_launches = phase(
            "13a", "calibration: the probe grid on the card, and a "
            "correction fitted on phase 7's sweep rows for phases 8-12",
            phase_calibration, report)
        fit_launches, eval_launches, fit_main_launches = phase(
            8, "fit: tied GPT-2-small through utils.train.fit and the "
            "training entry point", phase_fit, report)
        zb_step_launches = phase(9, "zero-bubble training: tied "
                                 "GPT-2-small under ZBH1 and ZBV",
                                 phase_zero_bubble, report)
        report["zero_bubble"]["seconds"] = seconds["9"]
        torch.cuda.empty_cache()
        dist_launches = phase(
            10, "the torch.distributed transport: a gloo world of 4 "
            "processes on the card, tied GPT-2-small", phase_dist, report)
        torch.cuda.empty_cache()
        tp_launches = phase(
            11, "Megatron tensor parallelism: a gloo world of pipe 2 x "
            "model 2 on the card, GPT-2-small, Llama-3.2-1B, ref_decoder",
            phase_tp, report)
        torch.cuda.empty_cache()
        par_launches = phase(
            14, "FSDP and sequence parallelism: a gloo world of 4 on the "
            "card, pipe 2 x data 2 and pipe 2 x seq 2 (ring, Ulysses), "
            "GPT-2-small", phase_par, report)
        torch.cuda.empty_cache()
        fwd_moe_launches = phase(
            15, "pipelined batch inference and Mixture-of-Experts: "
            "GPT-2-small's forward, MoE lockstep and a gloo world of pipe 2 "
            "x expert 2", phase_fwd_moe, report)
        torch.cuda.empty_cache()
        moe_par_launches = phase(
            16, "MoE composed with TP, FSDP and seq: a gloo world of 8 on "
            "the card, pipe 2 x model 2 x expert 2, data 2 x pipe 2 x "
            "expert 2 (FSDP), pipe 2 x seq 2 x expert 2 (Ulysses)",
            phase_moe_par, report)
        torch.cuda.empty_cache()
        tps_launches = phase(
            17, "TP in the pipelined decoder and the serving engine: a "
            "gloo world of model 2 on the card, Llama-3.2-1B, contiguous, "
            "paged and speculative", phase_tp_serving, report)
        torch.cuda.empty_cache()
    dyn_launches = phase(12, "the static verifier, a certified searched "
                         "schedule and training dynamics: untied "
                         "GPT-2-small", phase_dynamics, report, tables)
    report["dynamics"]["seconds"] = seconds["12"]
    bench_launches = phase(
        "13", "calibration: the corrected fit reports; paged and "
        "speculative serving benches, Llama-3.2-1B",
        phase_calibration_serving, report)
    report["seconds"] = time.perf_counter() - t0
    print("chip_smoke: phase seconds " + ", ".join(
        f"{k}: {v:.1f}" for k, v in seconds.items()))
    print(f"chip_smoke: {report['seconds']:.1f} s in all")
    out = Path("chip_smoke_out")
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))

    sources = {"flash_fwd": (
        f"{PKG}/csrc/flash_fwd.cu",
        "distributed_training_with_pipeline_parallelism_tpu/ops/"
        "pallas_attention.py:453 (_flash_fwd_kernel_packed, K4; the same "
        "kernel serves :126 _flash_fwd_kernel, K2)"),
        "xent_fwd": (
        f"{PKG}/csrc/xent_fwd.cu",
        "distributed_training_with_pipeline_parallelism_tpu/ops/"
        "pallas_xent.py:48 (_xent_fwd_kernel, K1)"),
        "flash_bwd": (
        f"{PKG}/csrc/flash_bwd.cu",
        "distributed_training_with_pipeline_parallelism_tpu/ops/"
        "pallas_attention.py:496 (_flash_bwd_kernel_packed, K5; the same "
        "kernel serves :253 _flash_bwd_kernel, K3)"),
        "xent_bwd": (
        f"{PKG}/csrc/xent_bwd.cu",
        "distributed_training_with_pipeline_parallelism_tpu/ops/"
        "pallas_xent.py:92 (_xent_vjp_bwd, the XLA-fused backward of K1)")}
    kernels = []
    for name, (source, replaces) in sources.items():
        r = main_shapes[(name, "bfloat16")]
        kernels.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            shape=r["shape"], dtype=r["dtype"],
            launches_by_path={
                "train": launches[name],
                "decode": decode_launches.get(name, 0),
                "llama_decode": llama_launches.get(name, 0),
                "llama_serving": serve_launches.get(name, 0),
                "llama_paged_spec_serving": paged_spec_launches.get(name, 0),
                "ref_train": ref_launches[name],
                "fit_step": fit_launches[name],
                "eval": eval_launches[name],
                "fit_main": fit_main_launches[name],
                "zbh1_step": zb_step_launches["ZBH1"][name],
                "zbv_step": zb_step_launches["ZBV"][name],
                "dist_step_by_rank": [dist_launches[r][name]
                                      for r in sorted(dist_launches)],
                "dist_step": sum(dist_launches[r][name]
                                 for r in dist_launches),
                "tp_step_by_rank": [tp_launches[r][name]
                                    for r in sorted(tp_launches)],
                "tp_step": sum(tp_launches[r][name] for r in tp_launches),
                **{path: counts[name]
                   for path, counts in dyn_launches.items()},
                "calibration_probes": probe_launches[name],
                "serving_benches": bench_launches[name],
                **{f"{w}_step_by_rank": [counts[r][name]
                                         for r in sorted(counts)]
                   for w, counts in par_launches.items()},
                **{f"{w}_step": sum(counts[r][name] for r in counts)
                   for w, counts in par_launches.items()},
                "forward": fwd_moe_launches["forward"][name],
                "moe_step": fwd_moe_launches["moe"][name],
                **{f"{w}_by_rank": [fwd_moe_launches[w][r][name]
                                    for r in sorted(fwd_moe_launches[w])]
                   for w in ("forward_world", "moe_ep")},
                **{w: sum(fwd_moe_launches[w][r][name]
                          for r in fwd_moe_launches[w])
                   for w in ("forward_world", "moe_ep")},
                **{f"moe_{w}_by_rank": [counts[r][name]
                                        for r in sorted(counts)]
                   for w, counts in moe_par_launches.items()},
                **{f"moe_{w}": sum(counts[r][name] for r in counts)
                   for w, counts in moe_par_launches.items()},
                **{f"tp_{w}_by_rank": [counts[r].get(name, 0)
                                       for r in sorted(counts)]
                   for w, counts in tps_launches.items()},
                **{path: counts[name]
                   for path, counts in hf_launches.items()}}))
        fields = ("shape", "dtype", "max_abs_err", "ms", "plain_ms",
                  "bound_ms", "bound_by", "library_ms")
        kernels[-1]["par_shape"] = {
            k: main_shapes[(f"{name}_par", "bfloat16")][k] for k in fields}
        if name.startswith("xent"):
            kernels[-1]["moe_shape"] = {
                k: main_shapes[(f"{name}_moe", "bfloat16")][k]
                for k in fields}
        if name == "xent_fwd":
            kernels[-1]["tp_decode_shape"] = {
                k: main_shapes[("xent_fwd_tps", "float32")][k]
                for k in fields}
        if name.startswith("flash"):
            kernels[-1]["ref_shapes"] = [
                {k: main_shapes[(f"{name}_ref{dh}", "bfloat16")][k]
                 for k in ("shape", "dtype", "causal", "max_abs_err", "ms",
                           "tflops", "plain_ms", "bound_ms", "bound_by",
                           "library_ms")}
                for dh in REF_SHAPES]
        if name.startswith("flash"):
            kernels[-1]["tp_shapes"] = [
                dict({k: main_shapes[(f"{name}_tp_{m}", "bfloat16")][k]
                      for k in ("shape", "dtype", "causal", "max_abs_err",
                                "ms", "tflops", "plain_ms", "bound_ms",
                                "bound_by", "library_ms")}, model=m)
                for m in tp_shapes()]
        gemma = {"flash_fwd": ("flash_fwd_gemma", "flash_fwd_gemma_prefill"),
                 "flash_bwd": ("flash_bwd_gemma",),
                 "xent_fwd": ("xent_fwd_gemma", "xent_fwd_gemma_decode"),
                 "xent_bwd": ("xent_bwd_gemma",)}[name]
        kernels[-1]["gemma_shapes"] = [
            {k: main_shapes[(key, dtype)].get(k) for k in (
                "shape", "dtype", "max_abs_err", "ms", "tflops", "plain_ms",
                "bound_ms", "bound_by", "library_ms")}
            for key in gemma for dtype in ("bfloat16", "float32")]
        if name == "flash_fwd":
            r = main_shapes[("flash_fwd_llama", "bfloat16")]
            kernels[-1]["llama_prefill"] = {
                k: r[k] for k in ("shape", "dtype", "max_abs_err",
                                  "row_ulp_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}
    print(json.dumps({"kernels": kernels}))
    print(report["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
