#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

(``python3 chip_smoke.py --mu-sweep`` builds the kernels and runs only
the ``moe`` phase's step-size sweep, ``moe_mu_sweep``; ``python3
chip_smoke.py --phase hybrid`` builds the kernels, runs phase 2's
kernel checks and the ``hybrid`` phase, and prints the ``kernels`` line
with the hybrid path's launches and the ``ok`` line; ``--phase mesh``
and ``--phase tp`` do the same for the ``mesh`` and ``tp`` phases,
``--phase fsdp_mesh`` for the FSDP regime across their ranks, ``--phase
ckpt`` for the checkpoints under a process mesh (the ``mesh`` phase with
its ckpt part, then the ``tp`` phase's 8 ranks running only the FSDP
run, which saves), ``--phase dryrun`` for the dry run (phase 2's kernel
checks, the ``lm`` phase and the ``dryrun`` phase), ``--phase
families`` for phase 2's kernel checks and the ``families`` phase.
``--mesh-rank RANK DIR`` and ``--tp-rank RANK DIR`` are one rank of
those phases, which each starts itself.)

Phases (any failure exits non-zero; nothing is caught and passed over):

  1. build the port's CUDA kernels from ``src/repro_torch/csrc`` (nvcc),
     and print ``-Xptxas -v``'s registers, shared memory and spills of
     each of the four kernels, one line each;
  2. hold each kernel bitwise against its plain PyTorch version on the
     card -- at the main path's shape [4, 5, 53248] and at [4, 5, 2^22],
     u in f32 and bf16, the DC correction on and off, voter masks none /
     bool (all voters, as the main path passes it, and with voters
     dropped and one pod's quorum empty) / integer weights with one
     pod's quorum empty, the update and the vote-only forms, v with
     subnormal coordinates (flushed to signed zeros, the empty quorum's
     row otherwise untouched) -- and time both with CUDA events (median
     over repeats, the L2 cache flushed before each launch), plus each
     kernel's own device time from ``torch.profiler`` (or, where the
     profiler sees no launch, CUDA events over back-to-back launches, as
     the row says).  Then the same for the edges of the tiled designs: n
     of one 1024-coordinate tile, of one 4096 flat-buffer tile, of 3 x
     4096 and of 3 x 4096 + 384 (a ragged last tile), P = D = 1, D = 10
     (the clients phase's merged voter axis), D = 300 and, counted over
     voter groups, D = 513, 1024 and 5000; and inputs that are not
     16-byte aligned (or, for ``tally_acc``, n % 128 != 0), which the
     wrappers must refuse with ``ValueError`` and no launch.
     The same for ``tally_acc`` (2 shapes x f32/bf16 x int8/int16/int32
     tallies that do not start at zero x correction on/off, vote weights
     with zeros and pod 1's quorum empty, plus a fold of K=2 clients
     that must give ``vote_update``'s vote on the merged [P, D*K] words;
     then the tiled design's edges) and ``ternary_quant`` (the MLP's
     padded size and 2^22 x f32/bf16, zeros and subnormals in x where
     u = 0, the l2 norm and norm = 0; then n = 10, 64, 640, 50176 and
     2^22 + 3, whose ragged tails the kernel takes itself).  The u and
     delta of ``sign_pack`` and ``tally_acc`` carry NaN, +inf and -inf
     (``nonfinite_``), as the hybrid family's gradients do;
  3. train the paper's task (MLP 784-64-10, Q=4 edges x D=5 devices,
     Dirichlet(0.1), B=400, T_E=15, mu=5e-3, rho=0.2, 2 rounds = 30 steps)
     with ``dc_hier_signsgd`` on the fused transport and the flat state,
     counting kernel launches; then rerun the same steps on the pure
     PyTorch ``ag_packed``/``tree`` path and require bitwise equal edge
     models;
  4. ``clients``: the same task with K=2 virtual clients per device
     (40 clients), Bernoulli(0.5) participation and |D_qk| row-count
     vote weights (an int16 tally): the streamed sweep on fused/flat
     (``tally_acc`` once per client and step, no ``sign_pack`` or
     ``vote_update``), the merged voter axis on fused/flat (one
     ``sign_pack`` and one ``vote_update`` per step) and on
     ag_packed/tree (no kernel).  Merged fused/flat must equal
     ag_packed/tree bitwise; stream must equal merged bitwise when one
     step's per-client gradients of the two forms are bitwise equal on
     the card (else its final test loss within 1e-3, with the count of
     differing coordinates printed).  The same triple with the
     gradients injected (``tests/helpers/injected_grads.py``) must be
     bitwise in any case, and so must one merged step of 640 voters a
     pod (K=128 clients per device, ``vote_update`` over voter groups)
     on fused/flat against ag_packed/tree;
  5. ``quantize``: the entry point ``ops.ternary_quant_nd`` on the MLP's
     four gradient leaves, one ``ternary_quant`` launch each, held
     against its plain version;
  6. ``methods``: the rest of the step on the paper task (Q=4 x D=5,
     B=400, 2 rounds of T_E=15, the batches sampled once and reused):
     ``hier_sgd``, ``hier_local_qsgd`` (``ternary_quant`` with per-row
     norms, 4 launches a step and no other kernel),
     ``scaffold_hier_signsgd``, ``mtgc_hier_signsgd`` (cloud_period=2),
     and ``dc_hier_signsgd`` with error feedback, with momentum 0.9 and
     with the overlapped cloud tier.  Each run on fused/flat must equal
     ag_packed/tree bitwise, launch exactly its kernels, and end below
     the initial model's test loss; for QSGD, SCAFFOLD, MTGC and EF
     with K=2 clients (Bernoulli(0.5), |D_qk| weights) stream must
     equal merged bitwise under the ``clients`` phase's rule.

  7. ``lm``: the LM trainer on gemma3-1b at full width (d_model 1152,
     vocab 262144, window 1024, local:global 5:1), cut to 6 layers (one
     period), P=2 edges x D=3 devices, batch 1 x 1152 tokens a device,
     bf16 compute, f32 master, ``dc_hier_signsgd``, T_E=3: one step's
     per-voter gradients evaluated twice must be bitwise; then 6 steps
     of ``launch.train.run_training`` on fused/flat (exactly one
     ``sign_pack`` and one ``vote_update`` a step), the same steps on
     ag_packed/tree from the same parameters and tokens (bitwise the
     same edge models), and once more on fused/flat under
     torch.profiler (bitwise the first; the kernels' device time beside
     their byte bounds at [2, 3, n_pad], their share of the device
     time); the mean loss of round 2 must be below step 0's; the peak
     memory beside its reckoning; then 2 steps of ``hier_local_qsgd``
     with K=2 streamed clients (one ``ternary_quant`` launch a leaf and
     client) and their peak memory.
  8. ``families``: the ssm and encdec families whole, each as ``lm``
     runs gemma3-1b (P=2 x D=3, bf16 compute, f32 master, DC, T_E=3,
     random weights from seed 0): xlstm-350m cut to 8 blocks (one 7:1
     period; its host-bound sLSTM loop runs once a step), batch 1 x 576
     tokens a device, and whisper-base (6 + 6
     layers, 97,206,784 parameters, batch 4 x 448 tokens and 1500 x 80
     frames a device).  One step's per-voter gradients twice (bitwise),
     4 steps of ``run_training`` on fused/flat (``FAM_STEPS``: exactly 4
     ``sign_pack`` and 4 ``vote_update`` launches; step 2, round 1's last
     local step, under torch.profiler:
     the kernels' device time beside their byte bounds, the device's
     busy time, the top device ops), the same on ag_packed/tree (bitwise
     the same edge models, no launch), the mean loss of round 2 below
     step 0's, the peaks beside ``reckon_peak``'s reckoning.  Then one
     xlstm local step at 4 x 128 tokens a device on the card and dry on
     fake CUDA tensors (``launch.dryrun``, as the ``dryrun`` phase holds
     the lm configuration): arguments equal, peaks within 64 KiB, the
     fake calls the launches (``fam_dry_step``).
  9. ``fault_tolerant``: first the oracle check -- the paper task at full
     width (Q=4 x D=5, B=400, 2 rounds of T_E=15) under a compiled chaos
     schedule of the parity harness's kinds (a client killed mid-round,
     a pod down across the boundary, a straggler demoted at it, a
     heartbeat loss, recoveries), the fused/flat step on its kernels
     held against the port's loop-over-clusters oracle
     (``core.ref_fed``) on the card for hier_signsgd, DC, SCAFFOLD,
     MTGC (bitwise when one step's per-voter gradients of the two forms
     are, else within 1e-5, the count printed) and hier_sgd (1e-5) on
     dyadic data shares, and for DC on the task's own uneven |D_qd|.
     Then gemma3-1b, as in ``lm`` but cut to one local and one global
     layer (``two_layer_cut``), with checkpoints (4.0 GB each,
     ``build/fault_tolerant_ckpt``, the disk checked for three first and
     emptied at the end): run A, K=1, a device killed at 1, a straggler
     at 2, a heartbeat loss at 4 (each back two steps later) and a nan
     at 7: 6 steps with a checkpoint at 6, then a second
     ``run_training`` to 12 that must resume at 6 and, at the nan,
     restore 6 and replay: bitwise the same schedule without the nan,
     12 steps straight (two saves, not three);
     run B, K=2 streamed clients (batch 2), a client killed at 1 and back
     at 3, a nan at 4, a checkpoint every 3: bitwise the uninterrupted
     ag_packed/tree run.  ``sign_pack`` and ``vote_update`` once an
     executed step (replays included), ``tally_acc`` K times; each
     save's bytes and seconds, each submit's and restore's seconds, the
     peaks; then ``tally_acc`` at [2, 3, 417,468,416] bf16 beside its
     bound.
 10. ``serve``: prefill and greedy decode, the four kernels' counters
     set to 0 before it (serving launches none of them): gemma3-1b whole
     (26 layers, 802,384,128 parameters), xlstm-350m and whisper-base
     whole, random weights from seed 0, put into a [2, n_pad] float32
     ``FlatState`` (a training run's master, both edges equal) and
     served as bfloat16 from edge 0 through
     ``specs.serve_params_from_flat``; 8 requests from
     ``serve_request_batch``: gemma 2048-token prompts, max_len 2112,
     64 decode steps (its 22 local layers on the rolled window cache,
     the 4 global ones on the offset cache); xlstm 1024-token prompts,
     64 steps; whisper 1500 x 80 frames and 4-token prompts, 64 steps,
     max_len 448.  Each twice: every logit finite, the generated tokens
     the same; the float32 views share the buffer's storage; gemma's
     decode step 1 after a 1100-token prefill against a 1101-token
     prefill, on the float32 views and on the bfloat16 weights (every
     greedy token the same, the largest difference within 2e-2 of the
     largest logit in float32, 2^-5 in bfloat16).  JSON lines
     ``{"serve": "run" | "decode step" | "memory" | "decode
     consistency" | "phase"}``: prefill ms, decode ms a step and
     tokens/s, launches and the device's busy share of one profiled
     decode step, cache bytes, the peak rise beside ``serve_reckon``'s
     reckoning.
 11. ``fsdp``: the FSDP regime (``core.device_axis``: each layer lifted
     to its [P, D] copies inside its forward, the lift's backward
     voting per leaf on ``sign_pack`` + ``vote_update``).  The lift's
     fused vote on every leaf shape of a gemma3-12b layer (the norms
     padded to 4096) and on its tied table ([2, 2, 262144, 3840]), f32
     and bf16 cotangents, a bf16 correction at rho 0.2, a straggler:
     bitwise its plain ``majority_vote_dev(sgn(u + rho*delta))``.
     gemma3-1b as in ``lm`` (6 layers, P=2 x D=3, 1 x 1152) with
     ``param_mode="fsdp"``, 3 steps on fused/tree, against the
     replicated ag_packed/tree run: bitwise, the differing count
     printed.  Then the main path: gemma3-12b at full width cut to 6
     layers (1,979,895,360 parameters), random weights from seed 0,
     P=2 x D=2, 1 x 512 tokens a device, DC, mu 1e-3, rho 0.2, T_E=3,
     bf16 compute, f32 master, bf16 delta, fused, tree, 6 steps of
     ``run_training``: round 2's mean loss below step 0's, one
     ``sign_pack`` and one ``vote_update`` a leaf and layer a step (62),
     a local step of round 2 profiled (the kernels' device ms beside
     their byte bounds summed over the 62 launches, the device's busy
     share), the peak beside ``reckon_fsdp_peak`` and the replicated
     regime's ``reckon_peak`` at the same shapes.  JSON lines
     ``{"fsdp": "kernel route" | "gemma3-1b vs replicated" |
     "parameters" | "step" | "profiled local step" | "memory" |
     "phase"}``; the kernels line gains ``fsdp_launches``.
 12. ``moe``: the vlm and moe families under FSDP (``moe_cells``: every
     width as published; deepseek-v3 cut to 2 layers -- 1 leading dense
     MLA layer, 1 MoE layer -- 16 routed experts of 256 and the
     vocabulary's eighth, MTP on, 2,437,338,112 parameters; arctic to 2
     layers and 8 experts, 2,576,501,760; internvl2 to 2 layers and
     16032 words, 1,973,985,280, 256 patches a row), P=2 x D=2, 1 x 512
     tokens a device, DC, mu 1e-5 (``MOE_MU``, the largest step of
     ``--mu-sweep`` at which all three losses fall), rho 0.2, T_E=3,
     bf16 compute, f32 master, bf16 delta, fused, tree.  The lift's
     fused vote at every distinct leaf shape of the four configs (expert
     stacks, router, MLA, MTP, the untied tables), [2, 2] f32 and bf16
     cotangents: bitwise its plain ``ag_packed`` vote.  One MoE layer of
     deepseek-v3 and of arctic at full shapes on [2, 2] replicas, f32:
     both dispatches within 1e-5 of the largest |y| of ``moe_oracle``
     (plain loops over replicas, groups and experts), and their bf16
     forward and backward twice bitwise; the check config (deepseek-v3,
     1 MoE layer, 8 experts, MTP; 1,501,475,840 parameters) 3 steps FSDP
     fused/tree bitwise the replicated ag_packed/tree run at P=2 x D=1
     (the replicated regime does not fit at D=2); then 6 steps of
     ``run_training`` for each of the three (round 2's mean loss below
     step 0's, one ``sign_pack`` and one ``vote_update`` a leaf and
     layer a step, a local step of round 2 profiled, the peak beside
     ``reckon_fsdp_peak``), internvl2 and deepseek-v3 then served
     resident in bf16 from edge 0 of the trained masters (8 requests of
     512 tokens, internvl2's with 256 patches, 32 greedy steps, twice:
     the same tokens, finite logits; internvl2's decode step against
     the one-longer prefill on the float32 views, 2e-2 of the largest
     logit and the same greedy tokens; deepseek-v3's MLA layer alone,
     absorbed decode against the train form within 2^-6).  JSON lines
     ``{"moe": "parameters" | "kernel route" | "layer vs oracle" |
     "fsdp vs replicated" | "step" | "profiled local step" | "memory" |
     "phase"}`` and
     ``{"serve": "run"}``; the kernels line gains ``moe_launches``.
 13. ``hybrid``: zamba2-2.7b (``phase_hybrid``) at its published widths
     cut to 12 layers (747,295,040 parameters; the tied shared block
     occurs twice), the ``lm`` phase's algorithm and shapes: one step's
     per-voter gradients twice, bitwise (NaN payloads included), with
     each leaf's NaN count (the reference's SSD overflow, ROADMAP queue
     3; the loss-falls check is not used); 6 steps fused/flat (6 + 6
     launches, the last profiled) bitwise ag_packed/tree, every loss
     finite, the peak beside ``reckon_peak``; the same config under
     FSDP at P=2 x D=2, 3 steps, bitwise the replicated run, 156
     launches of each kernel a step (the shared block's 9 leaves voted
     once); zamba2 whole served as ``serve`` serves gemma (8 x 2048
     prompts, 64 greedy steps; the cache's bytes equal to
     ``hybrid_cache_reckon``; decode step 1 against the one-longer
     prefill on the float32 views).  JSON lines ``{"hybrid":
     "parameters" | "gradients" | "step" | "kernels" | "memory" | "fsdp
     vs replicated" | "phase"}`` and zamba2's ``{"serve": ...}``; the
     kernels line gains ``hybrid_launches``.
 14. ``mesh``: the hierarchy across processes (``launch.mesh``,
     ``core.comm``) on the one card: 4 ranks, 2 pods x 2 data, over
     gloo (NCCL refuses two ranks on one GPU), each a [1, 1] block of
     P=2 x D=2, started as ``chip_smoke.py --mesh-rank`` processes and
     killed past ``MESH_JOIN_S``.  The one-process references run
     first, in this process, and are freed.  The parity toy (injected
     gradients, 6 steps of T_E=3, uneven weights) in four cells -- DC,
     ``hier_sgd``, ``hier_local_qsgd``, DC with K=2 streamed clients at
     Bernoulli(0.5) -- on fused/flat: every slot of the gathered state
     bitwise the one-process run, the losses within 1e-5 (the forward's
     sums run at the block's shape), and in every rank the four
     kernels' launches counted (6 + 6, 18 ``ternary_quant``, 12
     ``tally_acc``).  One fused vote-update at gemma3-1b's 417,468,416
     coordinates (seeded bf16 directions, an f32 master) through
     ``votes.fused_sign_vote_update``: each edge row's sha256 that of
     the one-process [2, 2] result, and the words' gather timed.  Then
     gemma3-1b as in ``lm`` (cut to a local and a global layer, 1 x 1152,
     DC, fused/flat) at P=2 x D=2, ``MESH_LM_STEPS`` (3: round 1) steps
     of ``run_training`` over the ranks: step 0's
     per-device gradients of each [1, 1] block against the one-process
     [2, 2] run (the differing count; each rank's own gradients' sha256
     that of the block computed here), the final masters' differing
     count against the one-process run (bitwise required where the
     gradients are), every loss finite, the local steps' mean below
     step 0's, 3 + 3 launches a rank, each rank's local and prologue
     step ms,
     bytes gathered and peak beside ``reckon_mesh_peak``.  Then the
     ckpt part (item 17e, checkpoints under a process mesh): run B, the
     same run with the mesh checkpoint (one file, the JAX store's, rank
     0 its writer) saved every ``MESH_CKPT_EVERY`` steps to
     ``build/mesh_ckpt/`` (the disk checked first to hold
     ``MESH_CKPT_KEEP`` + 1 of them, removed after), a nan at step 2
     restored (rank 0's choice, each rank reading its rows) and
     replayed: its final rows bitwise run A's, 4 + 4 launches a rank,
     each save's device growth at most the rank's block; then here,
     after the ranks, its step-2 and final checkpoints restored into one
     process (P=2 x D=2: another shape), the final rows bitwise run A's
     and the step-2 state the digests each rank printed of its rows;
     save and restore seconds a rank, bytes, the writer's host peak.
     JSON lines ``{"mesh": "one-process references" | "reckoned rank
     peak" | "before the ranks" | "ckpt disk" | "toy" | "transport" |
     "lm" | "ckpt" | "ckpt part" | "phase"}``; the kernels line gains
     ``mesh_launches_per_rank`` (run B's under ``"ckpt"``).
 15. ``tp``: the model axis across processes (``core.shardflat``, every
     family tensor-parallel) on the one card: 8
     ranks, 2 pods x 2 data x 2 model, over gloo, each a [1, 1] block of
     P=2 x D=2 and one model shard, started as ``chip_smoke.py
     --tp-rank`` processes.  The
     one-process references first, in this process.  The parity toy on
     injected gradients (``w`` column-, ``w2`` row-parallel) in five
     cells -- DC at hidden 64 and 65 (padded blocks), ``hier_sgd``,
     ``hier_local_qsgd``, DC with K=2 streamed clients -- on fused/flat:
     the gathered logical state bitwise the one-process run (QSGD
     within 1e-5), the losses within 1e-5, the four kernels counted in
     every rank.  One fused vote-update on gemma3-1b's sharded layout
     (cut to a local and a global layer, M=2), each rank on its bucket:
     its logical block's sha256 that of the one-process result, the word
     bytes it sent ``4 * bucket_words``.  gemma3-1b (that cut, ``lm``'s
     algorithm) ``MESH_LM_STEPS`` (3) steps of
     ``run_training`` tensor-parallel over the ranks: step 0's
     gradients gathered over model against the model=1 run of the same
     block (the differing count, the largest difference over the leaf's
     largest |value|), the copies bitwise across model ranks at every
     step (an all-gathered sha256), the local steps' mean below step
     0's, 3 + 3 launches a rank, local and prologue step ms, the bytes
     sent on each group, the peak beside ``reckon_mesh_peak`` at the
     bucket.  Then the ssm, hybrid and encdec families (item 17f, part
     two; ``tp_fam_*``) at their published widths: xlstm-350m cut to one
     7:1 period (8 blocks, 1 x 576 tokens), zamba2-2.7b cut to one
     period (6 Mamba2 blocks and the shared one, 1 x 1152, every
     ``a_log`` lowered by 5 so that the SSD scan does not overflow) and
     whisper-base whole (4 x 448 tokens, 1500 frames), each rank drawing
     the seed-0 tree on the card: step 0's gradients of the first [1, 1]
     block against the model=1 run under ``TP_STEP0_REL`` (xlstm and
     zamba2 in float32), copies bitwise on both model ranks; the
     replicated regime's prologue and a local step (``lm``'s algorithm):
     step 1's loss below step 0's, 2 + 2 launches a rank, the copies
     bitwise after each step, the model group's bytes those of
     ``reckon_tp_model_bytes`` to the byte, the other groups' bytes,
     the step ms and the peak.  Then the moe and vlm families (item 17f,
     part one) at their published
     widths: deepseek-v3 (1 dense MLA + 1 MoE layer, 16 of 256 routed
     experts and the shared one, MTP, 16160 words) and internvl2 (1
     layer, 16032 words, 256 patches), their seed-0 trees drawn once
     here and written to ``build/`` files that every rank maps (the
     card never holds a rank's whole tree).  Step 0's gradients through
     the replicated loss on the first [1, 1] block, tensor-parallel and
     gathered over model, against the model=1 run of the block under
     ``TP_STEP0_REL`` (deepseek in float32: its top-k routing flips on
     bf16's reordered sums), copies bitwise on both model ranks; then 2
     steps of ``run_training`` in the FSDP regime (``moe_algo`` at
     ``MOE_MU``, 1 x 512 tokens a device, the prologue and a local
     step): step 1's loss below step 0's,
     one ``sign_pack`` and one ``vote_update`` a lifted leaf and layer a
     step in every rank, each rank's master its model block's data
     shard to the byte, each group's bytes a local and a prologue step
     beside ``reckon_fsdp_mesh_bytes`` and ``reckon_tp_model_bytes``,
     the step ms, the peak beside ``reckon_fsdp_mesh_peak``.  Between
     the two (after the ssm, hybrid and encdec configs, before the moe
     and vlm ones), serving over the model axis (item 17d, part one;
     ``tp_serve*``): xlstm-350m, zamba2-2.7b and whisper-base from the
     masters they trained (edge 0 on every pod: views of pod 0's
     bucket, and of the row pod 1 receives), then gemma3-1b whole (26
     layers, ``max_len`` past its 512 window), deepseek-v3 and
     internvl2 from the mapped trees, each over the 8 ranks: 8 requests
     of 48 tokens, 2 a batch rank, and 4 decode steps.  Model rank 0 of
     the first batch rank serves the batch alone in float32, and the
     rows gathered from the ranks lie within ``TP_SERVE_PREFILL_REL`` (prefill) and
     ``TP_SERVE_DECODE_REL`` (the steps, on the teacher's tokens) of its
     logits, the greedy tokens equal; every rank's cache bytes are
     ``build.cache_bytes``' and each group's bytes a rank sends in the
     prefill and a step ``reckon_tp_serve_bytes``', to the byte; then
     the same in bfloat16, timed; no kernel launched.  After the moe and
     vlm configs, serving from the data ranks' shards (item 17d, part
     two; ``tp_shards*``): deepseek-v3 and internvl2 from the FSDP
     shards their run left, in the gather layout, as above (every
     layer's shards gathered over the data group at every call, the
     data group's bytes a call ``reckon_serve_gather_bytes``' to the
     byte; the reference the one-process serve of edge 0's gathered
     masters); then one request of 48 tokens and 4 steps, replicated
     over the batch ranks, on a cache split by length over the data
     ranks: gemma3-1b whole at long_500k's 524288 (each rank's cache
     ``build.cache_bytes``', about 1.23 GB) and gemma3-1b and
     zamba2-2.7b (one period) at 100 (steps 3-4 on data rank 1), each
     against one process on the whole cache in float32 (the steps under
     ``TP_SHARDS_DECODE_REL``), then in bfloat16, timed, the split
     attention's combines ``reckon_combine_bytes``'.  JSON lines
     ``{"tp": ...}``; the kernels line gains ``tp_launches_per_rank``,
     ``tp_fam_launches_per_rank``, ``tp_moe_launches_per_rank``,
     ``tp_serve_launches_per_rank`` and ``tp_shards_launches_per_rank``.
     ``--phase tp`` runs phase 2's kernel checks and this phase alone;
     ``--phase shards`` the kernel checks, the moe part and the shards
     part.
 16. ``fsdp_mesh``: the FSDP regime across processes (``core.device_axis``
     over a mesh: each rank a shard of every master and correction), run
     by the ``mesh`` phase's 4 ranks and the ``tp`` phase's 8 after
     their own parts.  The lift at gemma3-12b's 11 leaf shapes (a local
     layer's and the tied table, master specs at D=2), fused and wmean,
     under a mask that drops a voter and empties pod 1's quorum: each
     rank's direction shard bitwise the one-process lift on the same
     coordinates of all D voters, its forward's copies its block of the
     master, one ``sign_pack`` and one ``vote_update`` a fused lift.
     gemma3-1b (2 layers) FSDP over the 8 ranks, 3 steps fused/tree,
     against the replicated regime's ag_packed/tree run on the same
     ranks from the same parameters and tokens: 0 differing coordinates
     over the ranks' shards, the losses equal; in the whole script that
     run saves its final state (item 17e) to ``build/tp_fsdp_ckpt/``,
     which the tp phase restores here into one process (M = 1, data 1),
     every rank's shard of every master and correction held against the
     digest the rank printed (``{"tp": "fsdp ckpt", ...}``; the kernels
     line gains ``tp_fsdp_ckpt_launches_per_rank``).  gemma3-12b at full
     width cut to 2 layers (a local and a global one) over the 4 ranks
     (2 pods x 2 data, a [1, 1] block each), DC, mu 1e-3, rho 0.2,
     T_E=3, bf16 compute, f32
     master, bf16 delta, fused/tree, 2 steps of ``run_training`` (the
     prologue and a local step): step 1's loss below step 0's, one
     ``sign_pack`` and one
     ``vote_update`` a leaf and layer a step in every rank, each rank's
     master and correction bytes beside the one-process pod row's, each
     group's bytes a local and a prologue step beside
     ``reckon_fsdp_mesh_bytes``, the step ms, the peak beside
     ``reckon_fsdp_mesh_peak``.  JSON lines ``{"fsdp_mesh": ...}``; the
     kernels line gains ``fsdp_mesh_launches_per_rank``.  ``--phase
     fsdp_mesh`` runs phase 2's kernel checks, then only these parts of
     the two phases' ranks.
 17. ``dryrun`` (item 16; run right after ``lm``): the dry run
     (``launch.dryrun``) held against the card.  The ``lm`` phase's
     configuration (gemma3-1b, 6 layers, P=2 x D=3, 1 x 1152 tokens a
     device, bf16 compute, DC, fused/flat) takes one sync step (the
     prologue) and one local step on the card; the caching allocator's
     requested bytes (unrounded) give each step's arguments -- what the
     state, batch and weights hold at the call, counted from before
     they were made -- and its peak from the same start, and the
     launches are counted; then the same two steps dry, on fake CUDA
     tensors: each step's argument bytes equal the card's, each peak
     within ``DRY_PEAK_SLACK`` bytes of the card's, the fake calls equal
     to the launches.  Then stablelm-3b's smoke config
     (two layers: the quickest to trace) on a fake 2 x 2 x 2 grid
     (``mesh.dry_grid``), K=2 streamed clients and ``hier_local_qsgd``
     (the fake paths of ``tally_acc`` and ``ternary_quant``), a sync
     step each on fake CUDA and on fake CPU tensors: the records equal
     in every number but the device and the host seconds.  No kernel
     launches in any dry run (the real counters unchanged).  JSON lines
     ``{"dryrun": ...}``; the kernels line gains ``dryrun``; the phase's
     seconds against ``DRY_BUDGET_S``.

The ``ternary`` cases of phase 2 include the QSGD step's per-row form:
rows of the MLP's leaf lengths 10, 64, 640 and 50176, R = 20 and 40 rows
(a zero row, a row of subnormals), each row with its own norm from
``signs.row_norms`` -- whose values must not depend on the row count --
and 8 rows of gemma3's embedding leaf (301,989,888 coordinates each)
in bf16 through ``ops.ternary_quant_rows``: 2^31 coordinates and more,
split over two launches of whole rows, bitwise the plain version.

It prints the card's name and power limit first, one JSON line per
kernel case, a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import re
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet, at 700 W
CUDA_CORE_OPS_PER_S = 67e12      # same sheet: f32 outside the tensor cores
MAIN_SHAPE = (4, 5, 53248)       # the MLP's flat buffer: 13 tiles of 4096
LARGE_SHAPE = (4, 5, 1 << 22)
RHO, MU = 0.2, 5e-3
K_CLIENTS = 2
SOURCES = {
    "sign_pack": ("src/repro_torch/csrc/sign_pack.cu",
                  "src/repro/kernels/sign_pack.py:48"),
    "vote_update": ("src/repro_torch/csrc/vote_update.cu",
                    "src/repro/kernels/vote_update.py:60"),
    "tally_acc": ("src/repro_torch/csrc/tally_acc.cu",
                  "src/repro/kernels/tally_acc.py:55"),
    "ternary_quant": ("src/repro_torch/csrc/ternary_quant.cu",
                      "src/repro/kernels/ternary_quant.py:31"),
}


def ptxas_entries(report: str, kernel: str) -> list:
    """Registers, static shared memory and spill bytes of every
    instantiation of ``kernel`` in an ``nvcc -Xptxas -v`` report."""
    entries, cur = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = {"function": m.group(1)} if kernel in m.group(1) else None
            if cur is not None:
                entries.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = map(int, m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
    return entries


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


T_START = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; every line but the ``kernels`` and ``ok`` lines
    carries ``at_s``, the seconds since the script started."""
    if not {"kernels", "ok"} & set(obj):
        obj = {**obj, "at_s": time.perf_counter() - T_START}
    print(json.dumps(obj), flush=True)


class Timer:
    """Median milliseconds of a call, by CUDA events, with the L2 cache
    flushed before every timed launch (the 50 MB L2 would otherwise hold
    the whole main-path working set).  That is the time a caller waits,
    the wrapper's host work included; :meth:`device_ms` is the kernel's
    own execution time, from ``torch.profiler``."""

    def __init__(self, torch, warmup: int = 3, reps: int = 25):
        self.torch, self.warmup, self.reps = torch, warmup, reps
        self.scratch = torch.empty(64 << 20, dtype=torch.uint8,
                                   device="cuda")

    def __call__(self, fn) -> float:
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        times = []
        for _ in range(self.reps):
            self.scratch.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def back_to_back_ms(self, fn) -> float:
        """Mean milliseconds of ``reps`` calls issued back to back between
        two CUDA events (no flush): the device time of launches that keep
        the device busy, else the rate at which the host issues them."""
        torch = self.torch
        for _ in range(self.warmup):
            fn()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(self.reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / self.reps

    def device_ms(self, fn, kernel: str) -> float | None:
        """Mean device time of the launches whose name holds ``kernel``
        over ``reps`` calls (L2 flushed before each); None when the
        profiler sees no such launch."""
        from torch.profiler import ProfilerActivity, profile

        from repro_torch.launch.profile_step import device_us, on_device
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(self.reps):
                self.scratch.zero_()
                fn()
            self.torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if on_device(e) and kernel in e.key]
        calls = sum(e.count for e in evs)
        if not calls:
            return None
        return sum(map(device_us, evs)) / calls / 1e3


def sign_pack_bytes(shape, elt: int, with_delta: bool) -> int:
    p, d, n = shape
    delta_bytes = p * n * elt if with_delta else 0
    return p * d * n * elt + delta_bytes + p * d * n // 8


def vote_update_bytes(shape, update: bool, weights_bytes: int) -> int:
    p, d, n = shape
    out = 2 * p * n * 4 if update else p * n
    return p * d * n // 8 + out + weights_bytes


def sign_pack_ops(shape, with_delta: bool) -> int:
    """Per coordinate: the compare, plus the multiply and add of rho*delta."""
    p, d, n = shape
    return p * d * n * (3 if with_delta else 1)


def vote_update_ops(shape, update: bool) -> int:
    """Per coordinate: a bit test and a weighted add per voter, the vote's
    compare and select, and the multiply and subtract of the update."""
    p, d, n = shape
    return p * n * (2 * d + 2 + (2 if update else 0))


def tally_acc_bytes(shape, u_elt: int, t_elt: int, with_delta: bool) -> int:
    """u read once, the tally read and written once, the correction once
    per pod, the [P, D] int32 weights once."""
    p, d, n = shape
    delta_bytes = p * n * u_elt if with_delta else 0
    return p * d * n * (u_elt + 2 * t_elt) + delta_bytes + 4 * p * d


def tally_acc_ops(shape, with_delta: bool) -> int:
    """Per coordinate: the compare, the multiply and add of w*s, plus the
    multiply and add of rho*delta."""
    p, d, n = shape
    return p * d * n * (5 if with_delta else 3)


def ternary_quant_bytes(n: int, elt: int) -> int:
    """x read and the output written once, u read once, the norm once."""
    return n * (2 * elt + 4) + 4


def ternary_quant_ops(n: int) -> int:
    """Per coordinate: abs, divide, compare, multiply, two selects."""
    return 6 * n


def bound(nbytes: int, ops: int) -> tuple[float, str]:
    """The least time the card could take: the larger of bytes over the
    memory rate and operations over the CUDA cores' rate, and which."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * ops / CUDA_CORE_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


SUBNORMALS = (1e-40, -1e-40, -1e-45, 3e-39)    # in v: each flushes to +-0


def sign_pack_case(torch, timer, u, dl, extra: dict) -> dict:
    """sign_pack on u (and the correction dl, or None) against its plain
    version, bitwise and timed; returns the emitted row."""
    from repro_torch.core import signs
    from repro_torch.kernels import ref
    from repro_torch.kernels.sign_pack import sign_pack

    got = sign_pack(u, dl, RHO)
    want = ref.sign_pack_ref(u, dl, RHO)
    torch.cuda.synchronize()
    mism = int((got != want).sum())
    err = float((signs.unpack_bits(got) - signs.unpack_bits(want)).abs().max())
    row = {"kernel": "sign_pack", "shape": list(u.shape), **extra,
           "dtype": str(u.dtype).split(".")[-1], "delta": dl is not None,
           "mismatched_words": mism, "max_abs_err": err}
    row = timed_row(timer, row, lambda: sign_pack(u, dl, RHO),
                    lambda: ref.sign_pack_ref(u, dl, RHO), "sign_pack_kernel",
                    sign_pack_bytes(u.shape, u.element_size(), dl is not None),
                    sign_pack_ops(u.shape, dl is not None))
    require(mism == 0, f"sign_pack disagrees with its plain version: {row}")
    return row


def vote_update_case(torch, timer, words, v0, mname, mask, update: bool,
                     extra: dict) -> dict:
    """vote_update (the update form on a copy of v0, or the vote-only
    form) against its plain version, bitwise and timed.  A pod whose
    quorum is empty (pod 1 of the *_empty_quorum masks) must keep its row
    of v but for the flush of its subnormals, and vote 0."""
    from repro_torch.core import signs
    from repro_torch.kernels import ref
    from repro_torch.kernels.vote_update import vote_update

    p, d, w = words.shape
    if update:
        got = vote_update(words, v0.clone(), MU, mask)
        want = ref.vote_update_ref(words, v0, MU, mask)
        torch.cuda.synchronize()
        mism = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        err = float((got - want).abs().max())
        untouched = p < 2 or torch.equal(
            got[1].view(torch.int32), signs.ftz(v0[1]).view(torch.int32))
        v = v0.clone()
        kfn = lambda: vote_update(words, v, MU, mask)
        pfn = lambda: ref.vote_update_ref(words, v0, MU, mask)
    else:
        got = vote_update(words, None, 0.0, mask)
        want = ref.vote_update_ref(words, None, 0.0, mask)
        torch.cuda.synchronize()
        mism = int((got != want).sum())
        err = float((got.float() - want.float()).abs().max())
        untouched = p < 2 or not bool(got[1].any())
        kfn = lambda: vote_update(words, None, 0.0, mask)
        pfn = lambda: ref.vote_update_ref(words, None, 0.0, mask)
    wbytes = 0 if mask is None else mask.numel() * mask.element_size()
    row = {"kernel": "vote_update", "shape": [p, d, w * 32], **extra,
           "mask": mname, "form": "update" if update else "vote",
           "subnormal_v": update, "mismatched": mism, "max_abs_err": err}
    row = timed_row(timer, row, kfn, pfn, "vote_update_kernel",
                    vote_update_bytes((p, d, w * 32), update, wbytes),
                    vote_update_ops((p, d, w * 32), update))
    require(mism == 0, f"vote_update disagrees with its plain version: {row}")
    if mname.endswith("empty_quorum"):
        require(untouched, f"pod 1's empty quorum moved its model (beyond "
                f"flushing its subnormals) or voted: {row}")
    return row


def nonfinite_(u, delta) -> None:
    """NaN and +-inf written into u [P, D, n] and delta [P, n] (n >= 352),
    in place, as the hybrid family's gradients carry them: u = +inf and
    -inf (met by delta = -inf and +inf: u + rho*delta is NaN), delta NaN,
    +inf and -inf under finite u.  The sign of NaN is -1 (``signs.sgn``),
    of +inf +1 and of -inf -1."""
    u[0, 0, 192:224] = float("inf")
    u[0, 0, 224:256] = -float("inf")
    delta[0, 192:224] = -float("inf")
    delta[0, 224:240] = float("inf")
    delta[0, 256:288] = float("nan")
    delta[0, 288:320] = float("inf")
    delta[0, 320:352] = -float("inf")


def special_inputs(torch, gen, shape, dtype):
    """u and delta of ``shape`` with signed zeros, NaN, +-inf (in u and in
    delta, :func:`nonfinite_`), subnormals, and coordinates where u +
    rho*delta is exactly 0 in separate f32 rounding (an FMA would not
    be), wherever the shape has room for them."""
    from repro_torch.kernels import ref

    p, d, n = shape
    u = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    delta = torch.randn((p, n), generator=gen, device="cuda").to(dtype)
    u[0, 0, :64] = 0.0
    u[0, 0, 64:128] = -0.0
    # NaN, and a subnormal (counts as 0): rows 1 and 2, or past the zeros
    nan_at = (0, 1, slice(0, 32)) if d >= 3 else (0, d - 1, slice(128, 160))
    sub_at = (0, 2, slice(0, 32)) if d >= 3 else (0, d - 1, slice(160, 192))
    u[nan_at] = float("nan")
    u[sub_at] = -1e-40
    nonfinite_(u, delta)
    q, c = (1, slice(0, 4096)) if p > 1 else (0, slice(n // 2, n))
    u[q, :, c] = (-(ref.f32(RHO) * delta[q, c].float())).to(dtype)
    return u, delta


def model_rows(torch, gen, shape):
    """v of [P, n] with subnormal coordinates in every pod."""
    p, _, n = shape
    v0 = torch.randn((p, n), generator=gen, device="cuda")
    for i, x in enumerate(SUBNORMALS):
        v0[:, 32 * i:32 * (i + 1)] = x
    return v0


def phase_kernels(torch, timer):
    """Kernels vs plain versions, bitwise; returns the main-path rows."""
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(0)
    main_rows = {}
    for shape in (MAIN_SHAPE, LARGE_SHAPE):
        p, d, n = shape
        for dtype in (torch.float32, torch.bfloat16):
            u, delta = special_inputs(torch, gen, shape, dtype)
            for with_delta in (False, True):
                row = sign_pack_case(torch, timer, u,
                                     delta if with_delta else None, {})
                if (shape, dtype, with_delta) == (MAIN_SHAPE, torch.float32,
                                                  True):
                    main_rows["sign_pack"] = row
        words = ref.sign_pack_ref(
            torch.randn(shape, generator=gen, device="cuda"), None, 0.0)
        masks = {
            "none": None,
            "bool": torch.ones((p, d), dtype=torch.bool, device="cuda"),
            "bool_empty_quorum": torch.tensor(
                [[1, 0, 1, 1, 1], [0] * d, [0, 1, 0, 0, 1], [1, 1, 0, 1, 0]],
                dtype=torch.bool, device="cuda")[:p, :d],
            "int_empty_quorum": torch.tensor(
                [[3, 0, 1, 2, 5], [0] * d, [1, 1, 1, 1, 0], [7, 1, 1, 1, 1]],
                dtype=torch.int32, device="cuda")[:p, :d],
        }
        for mname, mask in masks.items():
            v0 = model_rows(torch, gen, shape)
            for update in (True, False):
                row = vote_update_case(torch, timer, words, v0, mname, mask,
                                       update, {})
                if (shape, mname, update) == (MAIN_SHAPE, "bool", True):
                    main_rows["vote_update"] = row
    return main_rows


# The tiled designs' edges: tiles of 1024 coordinates (which divide every
# multiple of 4096, so the ragged case is n = 3*4096 + 384), one pod and
# one voter, the clients phase's merged voter axis D*K = 10, and more
# voters than vote_update's byte counters hold (it counts them in int32).
EDGE_SHAPES = {
    "one kernel tile": (4, 5, 1024),
    "one flat-buffer tile": (4, 5, 4096),
    "odd number of 4096-tiles": (4, 5, 3 * 4096),
    "ragged last kernel tile": (4, 5, 3 * 4096 + 384),
    "P = D = 1": (1, 1, 53248),
    "D = 10": (4, 10, 53248),
    "D = 300": (2, 300, 4096),     # vote_update's int32 counters
    # vote_update over voter groups (at most 512 a stage): 2 groups of
    # 257 / 256, 2 of 512 (past the bit-sliced planes' 1023), 10 of 500
    "D = 513": (2, 513, 4096),
    "D = 1024": (2, 1024, 4096),
    "D = 5000": (2, 5000, 4096),
}
# tally_acc's edges (its tiles need n % 128 == 0, as every shape here has)
TALLY_EDGES = ("one flat-buffer tile", "odd number of 4096-tiles",
               "ragged last kernel tile", "P = D = 1", "D = 10")
TERNARY_EDGES = (10, 64, 640, 50176, (1 << 22) + 3)    # MLP leaves, tails


def edge_masks(torch, gen, p, d):
    """none, and bool / int32 weights with zeros and pod 1's quorum empty
    (pod 0 keeps at least one voter)."""
    bits = torch.rand((p, d), generator=gen, device="cuda") < 0.6
    ints = torch.randint(0, 8, (p, d), generator=gen, device="cuda",
                         dtype=torch.int32)
    bits[0, 0], ints[0, 0] = True, 3
    if p > 1:
        bits[1], ints[1] = False, 0
    return {"none": None, "bool_empty_quorum": bits,
            "int_empty_quorum": ints}


def phase_edges(torch, timer):
    """sign_pack and vote_update at EDGE_SHAPES, bitwise and timed; then
    inputs that are not 16-byte aligned (or, for tally_acc, n % 128 !=
    0), which the wrappers of all four kernels must refuse without
    launching."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.sign_pack import sign_pack
    from repro_torch.kernels.tally_acc import tally_acc
    from repro_torch.kernels.ternary_quant import ternary_quant
    from repro_torch.kernels.vote_update import vote_update

    gen = torch.Generator(device="cuda").manual_seed(5)
    for name, shape in EDGE_SHAPES.items():
        p, d, n = shape
        for dtype in (torch.float32, torch.bfloat16):
            u, delta = special_inputs(torch, gen, shape, dtype)
            sign_pack_case(torch, timer, u, delta, {"case": name})
        words = ref.sign_pack_ref(
            torch.randn(shape, generator=gen, device="cuda"), None, 0.0)
        v0 = model_rows(torch, gen, shape)
        for mname, mask in edge_masks(torch, gen, p, d).items():
            for update in (True, False):
                vote_update_case(torch, timer, words, v0, mname, mask,
                                 update, {"case": name})

    p, d, n = MAIN_SHAPE
    off = lambda *dims, **kw: torch.empty(
        int(torch.tensor(dims).prod()) + 1, device="cuda", **kw)[1:].view(dims)
    u = torch.randn(MAIN_SHAPE, device="cuda")
    words = sign_pack(u)
    w = torch.ones((p, d), dtype=torch.int32, device="cuda")
    t16 = torch.zeros(MAIN_SHAPE, dtype=torch.int16, device="cuda")
    x, ux = u.reshape(-1), torch.rand(u.numel(), device="cuda")
    nrm = torch.linalg.vector_norm(x)
    kernels = (sign_pack, vote_update, tally_acc, ternary_quant)
    refused = []
    for what, call in (
            ("sign_pack u", lambda: sign_pack(off(p, d, n))),
            ("sign_pack delta", lambda: sign_pack(u, off(p, n), RHO)),
            ("vote_update words", lambda: vote_update(
                off(p, d, n // 32, dtype=torch.int32), None, 0.0)),
            ("vote_update v", lambda: vote_update(words, off(p, n), MU)),
            ("tally_acc u", lambda: tally_acc(off(p, d, n), None, 0.0, w,
                                              t16)),
            ("tally_acc delta", lambda: tally_acc(u, off(p, n), RHO, w,
                                                  t16)),
            ("tally_acc tally", lambda: tally_acc(
                u, None, 0.0, w, off(p, d, n, dtype=torch.int16))),
            ("tally_acc n % 128", lambda: tally_acc(
                u[..., :n - 64].contiguous(), None, 0.0, w,
                t16[..., :n - 64].contiguous())),
            ("ternary_quant x", lambda: ternary_quant(off(x.numel()), ux,
                                                      nrm)),
            ("ternary_quant u", lambda: ternary_quant(x, off(x.numel()),
                                                      nrm))):
        launches = [k.launches for k in kernels]
        try:
            call()
        except ValueError as e:
            refused.append(what)
            print(f"[edges] {what} refused: {e}", flush=True)
        torch.cuda.synchronize()
        require([k.launches for k in kernels] == launches,
                f"a kernel launched on {what}")
    emit({"check": "inputs not 16-byte aligned (or n % 128 for tally_acc) "
                   "are refused", "refused": refused})
    require(len(refused) == 10, f"only {refused} were refused")


def timed_row(timer, row, kfn, pfn, kernel, nbytes, ops):
    row.update(kernel_ms=timer(kfn),
               kernel_device_ms=timer.device_ms(kfn, kernel),
               device_ms_by="torch.profiler", plain_ms=timer(pfn))
    if row["kernel_device_ms"] is None:
        row["kernel_device_ms"] = timer.back_to_back_ms(kfn)
        row["device_ms_by"] = ("CUDA events over back-to-back launches: "
                               "the profiler saw no launch")
    row["bound_ms"], row["bound_by"] = bound(nbytes, ops)
    if row["kernel_device_ms"]:
        row["share_of_bound"] = row["bound_ms"] / row["kernel_device_ms"]
    emit(row)
    return row


def tally_case(torch, timer, u, dl, w, t0, extra: dict) -> dict:
    """tally_acc (on a copy of t0) against its plain version, bitwise and
    timed; pod 1, all of whose weights are 0, must keep its tally."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.tally_acc import tally_acc

    got = tally_acc(u, dl, RHO, w, t0.clone())
    want = ref.tally_acc_ref(u, dl, RHO, w, t0)
    torch.cuda.synchronize()
    mism = int((got != want).sum())
    err = float((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    untouched = u.shape[0] < 2 or torch.equal(got[1], t0[1])
    tt = t0.clone()
    row = timed_row(
        timer,
        {"kernel": "tally_acc", "shape": list(u.shape), **extra,
         "dtype": str(u.dtype).split(".")[-1],
         "tally": str(t0.dtype).split(".")[-1], "delta": dl is not None,
         "mismatched": mism, "max_abs_err": err},
        lambda: tally_acc(u, dl, RHO, w, tt),
        lambda: ref.tally_acc_ref(u, dl, RHO, w, t0),
        "tally_acc_kernel",
        tally_acc_bytes(u.shape, u.element_size(), t0.element_size(),
                        dl is not None),
        tally_acc_ops(u.shape, dl is not None))
    require(mism == 0, f"tally_acc disagrees with its plain version: {row}")
    require(untouched, f"pod 1's weight-0 tally moved: {row}")
    return row


def phase_tally(torch, timer):
    """tally_acc vs its plain version, bitwise, and the K-client fold vs
    vote_update's merged vote, then the tiled design's edges; returns the
    main-path row."""
    from repro_torch.core import votes
    from repro_torch.kernels import ref
    from repro_torch.kernels.sign_pack import sign_pack
    from repro_torch.kernels.tally_acc import tally_acc
    from repro_torch.kernels.vote_update import vote_update

    gen = torch.Generator(device="cuda").manual_seed(1)
    main_row = None
    for shape in (MAIN_SHAPE, LARGE_SHAPE):
        p, d, n = shape
        # zeros, and pod 1's whole quorum at weight 0
        w_unit = torch.tensor(
            [[3, 0, 1, 2, 5], [0] * d, [1, 1, 1, 1, 0], [7, 1, 1, 1, 1]],
            dtype=torch.int32, device="cuda")[:p, :d]
        for dtype in (torch.float32, torch.bfloat16):
            u = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            delta = torch.randn((p, n), generator=gen, device="cuda").to(dtype)
            u[0, 0, :64] = 0.0
            u[0, 0, 64:128] = -0.0
            u[0, 1, :32] = float("nan")
            u[0, 2, :32] = -1e-40
            nonfinite_(u, delta)
            u[2, :, :4096] = (-(ref.f32(RHO) * delta[2, :4096].float())
                              ).to(dtype)
            for tdt, scale in ((torch.int8, 1), (torch.int16, 300),
                               (torch.int32, 20000)):
                w = w_unit * scale
                require(votes.tally_dtype(int(w.sum(1).max())) == tdt,
                        f"weights {w.tolist()} do not need {tdt}")
                t0 = torch.randint(-20, 20, shape, generator=gen,
                                   device="cuda").to(tdt)
                for with_delta in (False, True):
                    row = tally_case(torch, timer, u,
                                     delta if with_delta else None, w, t0,
                                     {})
                    if (shape, dtype, tdt, with_delta) == (
                            MAIN_SHAPE, torch.float32, torch.int16, True):
                        main_row = row
        # K clients folded into the tally, then thresholded, is the
        # weighted vote of the merged [P, D*K] voter axis (voter d*K + c)
        us = [torch.randn(shape, generator=gen, device="cuda")
              for _ in range(K_CLIENTS)]
        ws = [w_unit, torch.roll(w_unit, 1, dims=1)]
        tally = torch.zeros(shape, dtype=torch.int16, device="cuda")
        for u_c, w_c in zip(us, ws):
            tally_acc(u_c, delta.float(), RHO, w_c, tally)
        n_eff = sum(w_c.sum(1) for w_c in ws).to(torch.int32)
        fold = votes.tally_vote_dev(tally, n_eff)
        words = sign_pack(torch.stack(us, 2).reshape(p, d * K_CLIENTS, n),
                          delta.float(), RHO)
        merged = vote_update(words, None, 0.0,
                             torch.stack(ws, 2).reshape(p, d * K_CLIENTS))
        torch.cuda.synchronize()
        mism = int((fold != merged).sum())
        emit({"check": "tally_acc K-client fold == vote_update merged vote",
              "shape": list(shape), "clients": K_CLIENTS,
              "mismatched": mism, "pod1_votes": int(fold[1].abs().sum())})
        require(mism == 0 and not fold[1].any(),
                "the K-client tally fold disagrees with the merged vote")

    # the edges: every u and tally type, with the correction
    for name in TALLY_EDGES:
        shape = EDGE_SHAPES[name]
        p, d, n = shape
        w = edge_masks(torch, gen, p, d)["int_empty_quorum"]
        for dtype in (torch.float32, torch.bfloat16):
            u, delta = special_inputs(torch, gen, shape, dtype)
            for tdt in (torch.int8, torch.int16, torch.int32):
                t0 = torch.randint(-20, 20, shape, generator=gen,
                                   device="cuda").to(tdt)
                tally_case(torch, timer, u, delta, w, t0, {"case": name})
    return main_row


def ternary_inputs(torch, gen, n, dtype):
    """x with zeros and subnormals (which quantize to 0 even at u = 0)
    where n has room for them, and uniforms u with zeros there."""
    x = torch.randn(n, generator=gen, device="cuda").to(dtype)
    u = torch.rand(n, generator=gen, device="cuda")
    if n >= 256:
        x[:64] = 0.0
        x[64:96] = 1e-40            # subnormal: quantizes to 0 at u = 0
        x[96:128] = -1e-39
        u[:256] = 0.0
    return x, u


def ternary_case(torch, timer, x, u, norm_kind: str, extra: dict) -> dict:
    """ternary_quant against its plain version, bitwise and timed."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ternary_quant import ternary_quant

    n = x.numel()
    nrm = (torch.linalg.vector_norm(x.float()) if norm_kind == "l2"
           else torch.zeros((), device="cuda"))
    got = ternary_quant(x, u, nrm)
    want = ref.ternary_quant_ref(x, u, nrm)
    torch.cuda.synchronize()
    gi = got.float().view(torch.int32)
    mism = int((gi != want.float().view(torch.int32)).sum())
    err = float((got.float() - want.float()).abs().max())
    zeros_ok = (not got.float().any() if norm_kind == "zero"
                else n < 256 or not got[:128].float().any())
    row = timed_row(
        timer,
        {"kernel": "ternary_quant", "shape": [n], **extra,
         "dtype": str(x.dtype).split(".")[-1], "norm": norm_kind,
         "mismatched": mism, "max_abs_err": err},
        lambda: ternary_quant(x, u, nrm),
        lambda: ref.ternary_quant_ref(x, u, nrm),
        "ternary_quant_kernel",
        ternary_quant_bytes(n, x.element_size()),
        ternary_quant_ops(n))
    require(mism == 0, f"ternary_quant disagrees with its plain version: "
            f"{row}")
    require(zeros_ok, f"ternary_quant gave nonzeros where it must give 0: "
            f"{row}")
    return row


def phase_ternary(torch, timer):
    """ternary_quant vs its plain version, bitwise, then any n (ragged
    tails); returns the main row."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    main_row = None
    for n in (MAIN_SHAPE[2], LARGE_SHAPE[2]):
        for dtype in (torch.float32, torch.bfloat16):
            x, u = ternary_inputs(torch, gen, n, dtype)
            for norm_kind in ("l2", "zero"):
                row = ternary_case(torch, timer, x, u, norm_kind, {})
                if (n, dtype, norm_kind) == (MAIN_SHAPE[2], torch.float32,
                                             "l2"):
                    main_row = row
    for n in TERNARY_EDGES:
        for dtype in (torch.float32, torch.bfloat16):
            x, u = ternary_inputs(torch, gen, n, dtype)
            ternary_case(torch, timer, x, u, "l2", {"case": "any n"})
    for cols in TERNARY_ROWS:
        for rows in (20, 40):
            for dtype in (torch.float32, torch.bfloat16):
                row = ternary_rows_case(torch, timer, gen, rows, cols, dtype)
                if (rows, cols, dtype) == (20, 50176, torch.float32):
                    main_row = row
    ternary_huge_case(torch, gen)
    return main_row


TERNARY_ROWS = (10, 64, 640, 50176)     # the MLP's leaves, a row a voter
HUGE_ROWS = (8, 301989888)     # gemma3's tied embedding, 8 voters' rows


def ternary_huge_case(torch, gen) -> dict:
    """``ops.ternary_quant_rows`` at R*C >= 2^31 coordinates: 8 rows of
    gemma3's embedding leaf (262144 x 1152) in bf16, split over launches
    of whole rows under 2^31 coordinates (7 + 1), held bitwise against
    the plain version row by row on the same uniforms, timed.  Its
    tensors are freed before it returns."""
    from repro_torch.core import signs
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ternary_quant import ternary_quant

    rows, cols = HUGE_ROWS
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    x = torch.randn((rows, cols), generator=gen, device="cuda",
                    dtype=torch.bfloat16)
    u = torch.rand((rows, cols), generator=gen, device="cuda")
    x[0, :2] = 0.0
    x[0, 2:4] = 1e-40
    u[0, :4] = 0.0
    x[1] = 0.0
    per = ops.rows_per_launch(cols)
    launches = -(-rows // per)
    ternary_quant.launches = 0
    got = ops.ternary_quant_rows(x, u)
    torch.cuda.synchronize()
    require(ternary_quant.launches == launches,
            f"ternary_quant_rows at {rows} x {cols}: "
            f"{ternary_quant.launches} launches, want {launches}")
    peak_gib = (torch.cuda.max_memory_allocated() - before) / 2**30
    mism, err = 0, 0.0
    for r in range(rows):
        xf = x[r:r + 1].float()
        want = ref.ternary_quant_ref(xf, u[r:r + 1], signs.row_norms(xf))
        mism += int((got[r:r + 1].view(torch.int32)
                     != want.view(torch.int32)).sum())
        err = max(err, float((got[r:r + 1] - want).abs().max()))
        del xf, want
    require(mism == 0, f"ternary_quant_rows at {rows} x {cols} bf16 "
            f"disagrees with its plain version in {mism} coordinates")
    require(not got[1].any() and not got[0, :4].any(),
            "ternary_quant_rows at 2^31+: nonzeros where it must give 0")
    del got
    timer = Timer(torch, warmup=1, reps=3)
    ms = timer(lambda: ops.ternary_quant_rows(x, u))
    dev = timer.device_ms(lambda: ops.ternary_quant_rows(x, u),
                          "ternary_quant_kernel")
    n = rows * cols
    # the launches' own bytes: x in float32 as the kernel reads it, u,
    # the float32 output, a norm a row
    b_ms, b_by = bound(ternary_quant_bytes(n, 4) + 4 * (rows - 1),
                       ternary_quant_ops(n))
    row = {"kernel": "ternary_quant", "shape": [rows, cols],
           "case": "rows, >= 2^31 coordinates (split)", "dtype": "bfloat16",
           "norm": "per row", "launches_per_call": launches,
           "mismatched": mism, "max_abs_err": err, "call_ms": ms,
           "kernel_device_ms": None if dev is None else dev * launches,
           "bound_ms": b_ms, "bound_by": b_by, "peak_gib": peak_gib}
    emit(row)
    del x, u
    torch.cuda.empty_cache()
    return row


def ternary_rows_case(torch, timer, gen, rows: int, cols: int,
                      dtype) -> dict:
    """The QSGD step's form: x [rows, cols] with its own norm a row
    (``signs.row_norms``), row 1 zero, row 2 subnormal, zeros and
    subnormals at u = 0 in row 0; bitwise against the plain version on
    the same uniforms and norms, timed.  The norms of the first rows must
    be those of a call that holds only them."""
    from repro_torch.core import signs
    from repro_torch.kernels import ref
    from repro_torch.kernels.ternary_quant import ternary_quant

    x = torch.randn((rows, cols), generator=gen, device="cuda").to(dtype)
    u = torch.rand((rows, cols), generator=gen, device="cuda")
    x[0, :2] = 0.0
    x[0, 2:4] = 1e-40
    u[0, :4] = 0.0
    x[1] = 0.0
    x[2] = -1e-39
    u[2] = 0.0
    nrm = signs.row_norms(x)
    half = signs.row_norms(x[:rows // 2].contiguous())
    require(torch.equal(half, nrm[:rows // 2]),
            f"row norms depend on the row count ({rows} vs {rows // 2})")
    got = ternary_quant(x, u, nrm)
    want = ref.ternary_quant_ref(x, u, nrm)
    torch.cuda.synchronize()
    mism = int((got.float().view(torch.int32)
                != want.float().view(torch.int32)).sum())
    err = float((got.float() - want.float()).abs().max())
    zeros_ok = not got[1:3].float().any() and not got[0, :4].float().any()
    row = timed_row(
        timer,
        {"kernel": "ternary_quant", "shape": [rows, cols], "case": "rows",
         "dtype": str(x.dtype).split(".")[-1], "norm": "per row",
         "mismatched": mism, "max_abs_err": err},
        lambda: ternary_quant(x, u, nrm),
        lambda: ref.ternary_quant_ref(x, u, nrm),
        "ternary_quant_kernel",
        ternary_quant_bytes(rows * cols, x.element_size()) + 4 * (rows - 1),
        ternary_quant_ops(rows * cols))
    require(mism == 0, f"ternary_quant (per row) disagrees with its plain "
            f"version: {row}")
    require(zeros_ok, f"ternary_quant (per row) gave nonzeros where it must "
            f"give 0: {row}")
    return row


def phase_slice(torch):
    """The paper task on the fused/flat path, then on ag_packed/tree."""
    from repro_torch.kernels.sign_pack import sign_pack
    from repro_torch.kernels.vote_update import vote_update
    from repro_torch.launch.train import FedBenchCfg, run_paper_task

    cfg = FedBenchCfg(method="dc_hier_signsgd", rounds=2, t_e=15, batch=400,
                      mu=MU, rho=RHO, n_train=20000, q_edges=4,
                      devices_per_edge=5, transport="fused",
                      state_layout="flat")
    steps = cfg.rounds * cfg.t_e
    sign_pack.launches = 0
    vote_update.launches = 0
    fused = run_paper_task(cfg, device="cuda")
    launches = {"sign_pack": sign_pack.launches,
                "vote_update": vote_update.launches}
    print(f"[slice] fused/flat: loss {fused['loss']} acc {fused['acc']} "
          f"ms/step {fused['ms_per_step']} launches {launches}", flush=True)
    for name, count in launches.items():
        require(count == steps, f"{name} launched {count} times in "
                f"{steps} steps (want one launch per step)")
    require(fused["loss"][-1] < fused["loss"][0],
            f"test loss did not fall: {fused['loss']}")
    plain = run_paper_task(dataclasses.replace(
        cfg, transport="ag_packed", state_layout="tree"), device="cuda")
    require(sign_pack.launches == steps and vote_update.launches == steps,
            "the ag_packed/tree run launched a kernel")
    for name, leaf in fused["params"].items():
        other = plain["params"][name]
        require(tuple(leaf.shape) == tuple(other.shape),
                f"{name}: shape {tuple(leaf.shape)} vs {tuple(other.shape)}")
        require(bool(torch.isfinite(leaf).all()), f"{name}: non-finite")
        diff = int((leaf.contiguous().view(torch.int32)
                    != other.contiguous().view(torch.int32)).sum())
        require(diff == 0, f"{name}: fused/flat and ag_packed/tree edge "
                f"models differ in {diff} coordinates")
    print("[slice] fused/flat == ag_packed/tree edge models, bitwise",
          flush=True)
    return fused, plain, launches


def client_grads_bitwise(torch, cfg) -> tuple[bool, int]:
    """One step's per-client MLP gradients in the merged form (batch dims
    [P, D*K]) and the streamed form ([P, D] per client), on the slice's
    first batch: (bitwise equal, coordinates that differ)."""
    import numpy as np

    from repro_torch.core import clients as vclients
    from repro_torch.data import emnist_like
    from repro_torch.launch import train
    from repro_torch.models import mlp

    k, p, d = cfg.clients_per_device, cfg.q_edges, cfg.devices_per_edge
    data = emnist_like.make_federated_data(emnist_like.FedDataCfg(
        n_train=cfg.n_train, n_test=train.N_TEST, alpha=0.1, seed=cfg.seed,
        q_edges=p, devices_per_edge=d * k))[0]
    batch = train._stack_batches(data, cfg, np.random.default_rng(cfg.seed),
                                 "cuda")
    params = mlp.init_mlp(torch.Generator(device="cuda").manual_seed(0))

    def grads(voters, b):
        cp = {n: v.expand((p, voters) + tuple(v.shape)).contiguous()
              .requires_grad_(True) for n, v in params.items()}
        losses = mlp.loss_fn(cp, b)
        return dict(zip(cp, torch.autograd.grad(losses.sum(),
                                                list(cp.values()))))

    merged = grads(d * k, vclients.carve_batch(batch, k))
    differ = 0
    for c in range(k):
        per = grads(d, vclients.client_slice(batch, k, c))
        for n, g in per.items():
            m = merged[n].reshape((p, d, k) + tuple(g.shape[2:]))[:, :, c]
            differ += int((m.contiguous().view(torch.int32)
                           != g.view(torch.int32)).sum())
    return differ == 0, differ


def count_differing(torch, a: dict, b: dict) -> int:
    """Coordinates that differ between two (nested) dicts of float32
    tensors of one structure."""
    return sum(int((x.contiguous().view(torch.int32)
                    != y.contiguous().view(torch.int32)).sum())
               for (_, x), (_, y) in zip(pytree_items(a), pytree_items(b)))


def phase_clients(torch):
    """The paper task with K=2 virtual clients per device: stream and
    merged on the kernels, merged on the plain path, then the same triple
    with injected gradients.  Returns the stream run's launch counts."""
    import numpy as np

    import injected_grads
    from repro_torch.core import hier
    from repro_torch.core.topology import Topology
    from repro_torch.kernels.sign_pack import sign_pack
    from repro_torch.kernels.tally_acc import tally_acc
    from repro_torch.kernels.vote_update import vote_update
    from repro_torch.launch.train import FedBenchCfg, run_paper_task

    kernels = {"sign_pack": sign_pack, "vote_update": vote_update,
               "tally_acc": tally_acc}
    cfg = FedBenchCfg(method="dc_hier_signsgd", rounds=2, t_e=15, batch=400,
                      mu=MU, rho=RHO, n_train=20000, q_edges=4,
                      devices_per_edge=5, clients_per_device=K_CLIENTS,
                      participation="bernoulli", rate=0.5, client_seed=11,
                      data_weights=True, client_mode="stream",
                      transport="fused", state_layout="flat")
    steps = cfg.rounds * cfg.t_e
    same_grads, grad_differ = client_grads_bitwise(torch, cfg)
    print(f"[clients] one step's per-client gradients, merged [P, D*K] vs "
          f"streamed [P, D] form: bitwise {same_grads} ({grad_differ} "
          f"coordinates differ)", flush=True)
    runs = {}
    for name, kw, want in (
            ("stream fused/flat", {},
             {"tally_acc": K_CLIENTS * steps, "sign_pack": 0,
              "vote_update": 0}),
            ("merged fused/flat", {"client_mode": "merged"},
             {"tally_acc": 0, "sign_pack": steps, "vote_update": steps}),
            ("merged ag_packed/tree", {"client_mode": "merged",
                                       "transport": "ag_packed",
                                       "state_layout": "tree"},
             {"tally_acc": 0, "sign_pack": 0, "vote_update": 0})):
        for kern in kernels.values():
            kern.launches = 0
        res = run_paper_task(dataclasses.replace(cfg, **kw), device="cuda",
                             log=lambda line: None)
        launches = {n: kern.launches for n, kern in kernels.items()}
        res["launches"] = launches
        cc = res["clients"]
        print(f"[clients] {name}: test loss {res['loss']} acc {res['acc']} "
              f"ms/step {res['ms_per_step']} data ms/step "
              f"{res['data_ms_per_step']} launches {launches}", flush=True)
        require(launches == want, f"{name}: launches {launches}, want {want}")
        require(res["loss"][-1] < res["loss"][0],
                f"{name}: test loss did not fall: {res['loss']}")
        for n, leaf in res["params"].items():
            require(bool(torch.isfinite(leaf).all()), f"{name}/{n}: "
                    "non-finite")
        runs[name] = res
    weights = np.asarray(cc.weights)
    print(f"[clients] {cc.count} clients per device, client rows "
          f"{int(weights.min())}..{int(weights.max())}, edge totals "
          f"{weights.sum(axis=(1, 2)).tolist()}, weight bound "
          f"{cc.weight_bound(4, 5)}", flush=True)
    stream, merged, tree = (runs[n]["params"] for n in runs)
    diff = count_differing(torch, merged, tree)
    require(diff == 0, f"merged fused/flat and ag_packed/tree differ in "
            f"{diff} coordinates")
    diff = count_differing(torch, stream, merged)
    loss_s = runs["stream fused/flat"]["loss"][-1]
    loss_m = runs["merged fused/flat"]["loss"][-1]
    print(f"[clients] stream vs merged: {diff} coordinates differ, final "
          f"test loss {loss_s} vs {loss_m}", flush=True)
    if same_grads:
        require(diff == 0, "stream and merged differ although their "
                "gradients are bitwise equal")
    else:
        require(abs(loss_s - loss_m) <= 1e-3, "stream and merged final "
                "test losses differ by more than 1e-3")
    print("[clients] merged fused/flat == merged ag_packed/tree, bitwise",
          flush=True)

    # the triple with the gradients injected: bitwise by construction
    shapes = {n: tuple(v.shape[1:]) for n, v in stream.items()}
    grads = injected_grads.make_grads(
        shapes, 4, 5, K_CLIENTS, steps,
        torch.Generator(device="cuda").manual_seed(3), device="cuda")
    finals = []
    for mode, transport, layout in (("stream", "fused", "flat"),
                                    ("merged", "fused", "flat"),
                                    ("merged", "ag_packed", "tree")):
        algo = hier.AlgoConfig(
            method="dc_hier_signsgd", mu=MU, t_e=cfg.t_e, rho=RHO,
            transport=transport, state_layout=layout,
            compute_dtype=torch.float32, delta_dtype=torch.float32,
            clients=dataclasses.replace(cc, mode=mode))
        init_fn, step = hier.make_hier_step(
            Topology(4, 5, "cuda"), algo, injected_grads.make_bundle())
        state = init_fn({n: torch.zeros(s_, device="cuda")
                         for n, s_ in shapes.items()})
        ew = torch.tensor([0.25] * 4, device="cuda")
        ones = torch.ones((4, 5), device="cuda")
        for s_, g in enumerate(grads):
            state, _ = step(state, {"train": g,
                                    "anchor": grads[s_ - s_ % cfg.t_e]},
                            ew, ones, ones)
        finals.append({n: v.clone()
                       for n, v in hier.edge_params(state).items()})
    d1 = count_differing(torch, finals[0], finals[1])
    d2 = count_differing(torch, finals[1], finals[2])
    moved = float(finals[0]["w1"].abs().sum())
    print(f"[clients] injected gradients: stream vs merged {d1}, merged vs "
          f"tree {d2} coordinates differ (|w1|_1 = {moved})", flush=True)
    require(d1 == 0 and d2 == 0 and moved > 0,
            "the injected-gradient stream/merged/tree triple is not bitwise")
    return runs


def phase_quantize(torch):
    """ops.ternary_quant_nd (the QSGD baseline's compressor) on the MLP's
    four gradient leaves: one launch each, against the plain version on
    the same uniforms.  Returns the launch count."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.ternary_quant import ternary_quant
    from repro_torch.models import mlp

    gen = torch.Generator(device="cuda").manual_seed(4)
    params = {n: v.requires_grad_(True) for n, v in mlp.init_mlp(
        torch.Generator(device="cuda").manual_seed(0)).items()}
    batch = {"x": torch.randn((400, 784), generator=gen, device="cuda"),
             "y": torch.randint(0, 10, (400,), generator=gen,
                                device="cuda")}
    grads = torch.autograd.grad(mlp.loss_fn(params, batch),
                                list(params.values()))
    ternary_quant.launches = 0
    quantized = [ops.ternary_quant_nd(
        g, torch.Generator(device="cuda").manual_seed(10 + i))
        for i, g in enumerate(grads)]
    launches = ternary_quant.launches
    for i, (g, q) in enumerate(zip(grads, quantized)):
        u = torch.rand(g.numel(), device="cuda",
                       generator=torch.Generator(device="cuda")
                       .manual_seed(10 + i))
        want = ref.ternary_quant_ref(g.reshape(-1), u,
                                     torch.linalg.vector_norm(g))
        require(torch.equal(q.reshape(-1).view(torch.int32),
                            want.view(torch.int32)),
                f"ternary_quant_nd leaf {i} disagrees with its plain version")
    print(f"[quantize] ternary_quant_nd over the MLP's {len(grads)} gradient "
          f"leaves: {launches} launches", flush=True)
    require(launches == len(grads), f"ternary_quant launched {launches} "
            f"times for {len(grads)} leaves")
    # a flat view off a 16-byte boundary is copied, then quantized
    g = torch.cat([grads[0].reshape(-1)[:1], grads[0].reshape(-1)])[1:]
    q = ops.ternary_quant_nd(g, torch.Generator(device="cuda").manual_seed(9))
    u = torch.rand(g.numel(), device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(9))
    want = ref.ternary_quant_ref(g, u, torch.linalg.vector_norm(g))
    require(g.data_ptr() % 16 != 0 and ternary_quant.launches == launches + 1
            and torch.equal(q.view(torch.int32), want.view(torch.int32)),
            "ternary_quant_nd on a misaligned view: not one launch, or "
            "not its plain version")
    print("[quantize] a misaligned flat view: copied, one launch, bitwise",
          flush=True)
    return launches


def phase_many_voters(torch):
    """One merged step with K=128 clients per device (640 voters a pod,
    more than one 512-voter group of vote_update), injected gradients,
    Bernoulli(0.5) participation and integer weights: fused/flat (one
    sign_pack and one vote_update launch) bitwise ag_packed/tree."""
    import numpy as np

    import injected_grads
    from repro_torch.core import hier
    from repro_torch.core.clients import ClientConfig
    from repro_torch.core.topology import Topology
    from repro_torch.kernels.sign_pack import sign_pack
    from repro_torch.kernels.vote_update import vote_update
    from repro_torch.models import mlp

    k, p, d = 128, 4, 5
    weights = np.random.default_rng(12).integers(1, 50, (p, d, k))
    cc = ClientConfig(count=k, participation="bernoulli", rate=0.5, seed=11,
                      weights=tuple(tuple(tuple(int(x) for x in dev)
                                          for dev in q) for q in weights),
                      mode="merged")
    shapes = {n: tuple(v.shape) for n, v in mlp.init_mlp(
        torch.Generator(device="cuda").manual_seed(0)).items()}
    g = injected_grads.make_grads(
        shapes, p, d, k, 1, torch.Generator(device="cuda").manual_seed(13),
        device="cuda")[0]
    finals, launches = [], []
    for transport, layout in (("fused", "flat"), ("ag_packed", "tree")):
        algo = hier.AlgoConfig(
            method="dc_hier_signsgd", mu=MU, t_e=15, rho=RHO,
            transport=transport, state_layout=layout,
            compute_dtype=torch.float32, delta_dtype=torch.float32,
            clients=cc)
        init_fn, step = hier.make_hier_step(Topology(p, d, "cuda"), algo,
                                            injected_grads.make_bundle())
        state = init_fn({n: torch.zeros(s_, device="cuda")
                         for n, s_ in shapes.items()})
        sign_pack.launches = vote_update.launches = 0
        state, _ = step(state, {"train": g, "anchor": g},
                        torch.tensor([0.25] * p, device="cuda"),
                        torch.ones((p, d), device="cuda"),
                        torch.ones((p, d), device="cuda"))
        torch.cuda.synchronize()
        launches.append((sign_pack.launches, vote_update.launches))
        finals.append({n: v.clone()
                       for n, v in hier.edge_params(state).items()})
    diff = count_differing(torch, finals[0], finals[1])
    moved = float(finals[0]["w1"].abs().sum())
    print(f"[voters] one merged step, {d * k} voters a pod: fused/flat vs "
          f"ag_packed/tree {diff} coordinates differ (|w1|_1 = {moved}); "
          f"launches (sign_pack, vote_update) {launches}", flush=True)
    require(launches == [(1, 1), (0, 0)], f"launches {launches}, want one "
            f"sign_pack and one vote_update on fused/flat, none on the tree")
    require(diff == 0 and moved > 0, "the 640-voter merged step is not "
            "bitwise between fused/flat and ag_packed/tree")


METHOD_RUNS = (
    ("hier_sgd", "hier_sgd", {}),
    ("hier_local_qsgd", "hier_local_qsgd", {}),
    ("scaffold", "scaffold_hier_signsgd", {}),
    ("mtgc", "mtgc_hier_signsgd", {"cloud_period": 2}),
    ("dc + EF", "dc_hier_signsgd", {"error_feedback": True}),
    ("dc + momentum", "dc_hier_signsgd", {"momentum": 0.9}),
    ("dc + overlap", "dc_hier_signsgd", {"cloud_overlap": "overlap"}),
)
STREAMED_RUNS = ("hier_local_qsgd", "scaffold", "mtgc", "dc + EF")
KERNELS = ("sign_pack", "vote_update", "tally_acc", "ternary_quant")


def method_launches(method: str, kw: dict, transport: str, mode: str,
                    steps: int, k: int) -> dict:
    """The kernel launches a run must make: none for hier_sgd; 4
    ternary_quant a step for QSGD (one a leaf, per client when
    streamed); for the sign methods on fused, sign_pack + vote_update a
    merged step, tally_acc a streamed client, nothing streamed under EF
    (its per-leaf tally); nothing on the other transports."""
    want = dict.fromkeys(KERNELS, 0)
    if method == "hier_local_qsgd":
        want["ternary_quant"] = 4 * steps * (k if mode == "stream" else 1)
    elif method != "hier_sgd" and transport == "fused":
        if mode == "stream":
            if not kw.get("error_feedback"):
                want["tally_acc"] = k * steps
        else:
            want["sign_pack"] = want["vote_update"] = steps
    return want


def phase_methods(torch, slice_ms: float) -> dict:
    """The rest of the step on the paper task (see the module docstring).
    Returns {run name: result} of the fused/flat runs."""
    from repro_torch.kernels.sign_pack import sign_pack
    from repro_torch.kernels.tally_acc import tally_acc
    from repro_torch.kernels.ternary_quant import ternary_quant
    from repro_torch.kernels.vote_update import vote_update
    from repro_torch.launch.train import (FedBenchCfg, run_paper_task,
                                          sample_batches)

    kernels = dict(zip(KERNELS, (sign_pack, vote_update, tally_acc,
                                 ternary_quant)))
    base = FedBenchCfg(rounds=2, t_e=15, batch=400, mu=MU, rho=RHO,
                       n_train=20000, q_edges=4, devices_per_edge=5,
                       transport="fused", state_layout="flat")
    steps = base.rounds * base.t_e
    clients = dataclasses.replace(
        base, clients_per_device=K_CLIENTS, participation="bernoulli",
        rate=0.5, client_seed=11, data_weights=True)
    t0 = time.perf_counter()
    batches = {1: sample_batches(base, "cuda"),
               K_CLIENTS: sample_batches(clients, "cuda")}
    print(f"[methods] batches sampled once for all runs: "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    same_grads, grad_differ = client_grads_bitwise(torch, clients)
    print(f"[methods] one step's per-client gradients, merged vs streamed: "
          f"bitwise {same_grads} ({grad_differ} coordinates differ)",
          flush=True)

    def one(name, cfg, mode, method, kw):
        for kern in kernels.values():
            kern.launches = 0
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = run_paper_task(cfg, device="cuda", log=lambda line: None,
                             batches=batches[cfg.clients_per_device])
        torch.cuda.synchronize()
        # the run's own peak, above the batches and buffers held before it
        res["peak_mib"] = (torch.cuda.max_memory_allocated() - before) / 2**20
        res["launches"] = {n: kern.launches for n, kern in kernels.items()}
        want = method_launches(method, kw, cfg.transport, mode, steps,
                               cfg.clients_per_device)
        tag = (f"{name}, {mode} {cfg.transport}/{cfg.state_layout}"
               + (f", K={cfg.clients_per_device}"
                  if cfg.clients_per_device > 1 else ""))
        print(f"[methods] {tag}: test loss {res['loss_init']:.4f} -> "
              f"{res['loss']} acc {res['acc']} ms/step "
              f"{res['ms_per_step']} (slice {slice_ms:.3f}) launches "
              f"{res['launches']} peak MiB {res['peak_mib']:.2f}",
              flush=True)
        require(res["launches"] == want,
                f"{tag}: launches {res['launches']}, want {want}")
        require(all(map(math.isfinite, res["loss"])),
                f"{tag}: non-finite test loss")
        require(res["loss"][-1] < res["loss_init"],
                f"{tag}: test loss {res['loss']} not below its start "
                f"{res['loss_init']}")
        for n, leaf in res["params"].items():
            require(bool(torch.isfinite(leaf).all()), f"{tag}/{n}: "
                    "non-finite")
        return res

    runs = {}
    for name, method, kw in METHOD_RUNS:
        cfg = dataclasses.replace(base, method=method, **kw)
        fused = one(name, cfg, "merged", method, kw)
        plain = one(name, dataclasses.replace(
            cfg, transport="ag_packed", state_layout="tree"), "merged",
            method, kw)
        diff = count_differing(torch, fused["params"], plain["params"])
        require(diff == 0, f"{name}: fused/flat and ag_packed/tree differ "
                f"in {diff} coordinates")
        entry = {"run": name, "ms_per_step_fused_flat":
                 fused["ms_per_step"][-1],
                 "ms_per_step_ag_packed_tree": plain["ms_per_step"][-1],
                 "slice_ms_per_step": slice_ms,
                 "launches": fused["launches"],
                 "peak_mib_fused_flat": fused["peak_mib"],
                 "loss_init": fused["loss_init"], "loss": fused["loss"],
                 "fused_flat_vs_tree_differing": diff}
        if name in STREAMED_RUNS:
            kcfg = dataclasses.replace(clients, method=method, **kw)
            stream = one(name, dataclasses.replace(kcfg,
                                                   client_mode="stream"),
                         "stream", method, kw)
            merged = one(name, kcfg, "merged", method, kw)
            sdiff = count_differing(torch, stream["params"],
                                    merged["params"])
            print(f"[methods] {name}, K={K_CLIENTS}: stream vs merged "
                  f"{sdiff} coordinates differ, final test loss "
                  f"{stream['loss'][-1]} vs {merged['loss'][-1]}",
                  flush=True)
            if same_grads:
                require(sdiff == 0, f"{name}: stream and merged differ "
                        "although their gradients are bitwise equal")
            else:
                require(abs(stream["loss"][-1] - merged["loss"][-1]) <= 1e-3,
                        f"{name}: stream and merged final test losses "
                        "differ by more than 1e-3")
            entry.update(stream_ms_per_step=stream["ms_per_step"][-1],
                         merged_ms_per_step=merged["ms_per_step"][-1],
                         stream_launches=stream["launches"],
                         stream_peak_mib=stream["peak_mib"],
                         merged_peak_mib=merged["peak_mib"],
                         stream_vs_merged_differing=sdiff)
        emit({"methods_run": entry})
        runs[name] = fused
    print("[methods] every run: fused/flat == ag_packed/tree bitwise, "
          "launches as required, test loss below its start", flush=True)
    return runs


LM_ARCH, LM_LAYERS = "gemma3_1b", 6      # one 5:1 local:global period
LM_P, LM_D, LM_SEQ, LM_STEPS, LM_TE = 2, 3, 1152, 6, 3
LM_RECKONED_GB = 49.0        # the phase's peak, reckoned from its buffers


def lm_setup(torch, cfg=None, **algo_kw):
    """``cfg`` (by default gemma3-1b at full width, cut to LM_LAYERS
    layers) on P x D copies: (cfg, topo, algo) of the phase's runs."""
    from repro_torch import configs
    from repro_torch.core import hier
    from repro_torch.core.topology import Topology

    if cfg is None:
        cfg = dataclasses.replace(configs.get_config(LM_ARCH),
                                  n_layers=LM_LAYERS)
    kw = dict(method="dc_hier_signsgd", mu=1e-3, rho=RHO, t_e=LM_TE,
              transport="fused", state_layout="flat",
              compute_dtype=torch.bfloat16, master_dtype=torch.float32,
              delta_dtype=torch.bfloat16)
    kw.update(algo_kw)
    return cfg, Topology(LM_P, LM_D, "cuda"), hier.AlgoConfig(**kw)


def two_layer_cut(arch: str = LM_ARCH):
    """``arch`` (a gemma3 config) at full width cut to one local and one
    global layer (its 5:1 period as 1:1): the depth of the runs whose
    time is the bytes they move -- the ``fault_tolerant`` phase's
    checkpoints, the ``mesh`` and ``tp`` phases' gloo exchanges --, each
    block kind kept."""
    from repro_torch import configs

    return dataclasses.replace(configs.get_config(arch), n_layers=2,
                               local_global=(1, 1))


def lm_grads_bitwise(torch, built, params, batch, tag="lm",
                     on_grads=None) -> int:
    """One step's per-voter gradients of the LM's loss on ``batch`` (its
    [P, D, ...] tensors on the card), twice, from fresh bf16 [P, D]
    copies: the count of coordinates that differ, bit patterns compared
    (NaN payloads too; 0 when autograd is deterministic on the card,
    which the bitwise comparison of the two layouts needs).
    ``on_grads(grads)`` sees the first evaluation's gradients, in the
    order of ``pytree_items(params)``."""
    from repro_torch.core import pytree

    leaves, td = pytree.tree_flatten(params)

    def grads():
        copies = [leaf.unsqueeze(0).unsqueeze(0)
                  .expand((LM_P, LM_D) + tuple(leaf.shape))
                  .to(torch.bfloat16).contiguous().requires_grad_(True)
                  for leaf in leaves]
        losses = built.bundle.loss(pytree.tree_unflatten(td, copies),
                                   batch)
        return torch.autograd.grad(losses.sum(), copies), losses.detach()

    g1, l1 = grads()
    g2, l2 = grads()
    differ = sum(int((a.view(torch.int16) != b.view(torch.int16)).sum())
                 for a, b in zip(g1, g2))
    if on_grads is not None:
        on_grads(g1)
    require(torch.equal(l1, l2), "the LM's losses differ between two "
            "evaluations on the same copies")
    print(f"[{tag}] per-voter losses {l1.float().tolist()}", flush=True)
    return differ


def device_summary(prof) -> dict:
    """Device time by kernel of a torch.profiler trace: the sign_pack and
    vote_update launches (ms, count), every kernel's and copy's (the
    device's busy time), and the ten that took the most."""
    from repro_torch.launch.profile_step import device_us, on_device

    evs = [e for e in prof.key_averages() if on_device(e)]
    res = {"busy_ms": sum(map(device_us, evs)) / 1e3}
    for k in ("sign_pack_kernel", "vote_update_kernel"):
        ks = [e for e in evs if k in e.key]
        res[k] = (sum(map(device_us, ks)) / 1e3, sum(e.count for e in ks))
    evs.sort(key=device_us, reverse=True)
    res["top"] = [{"name": e.key[:240], "calls": e.count,
                   "device_ms": device_us(e) / 1e3} for e in evs[:10]]
    return res


def lm_train(torch, tag, cfg, topo, algo, run, params,
             profile=None) -> dict:
    """One ``run_training`` of an LM from ``params``, the kernels' launch
    counters set to 0 just before it and read just after: its history,
    launches, peak memory above what was held before it, edge models
    and flat layout.  ``profile``: None; "all" (the whole run under
    torch.profiler); or a step index s >= 1 (step s alone: the profiler
    starts once step s-1's loss is on the host and stops once step s's
    is), whose ``device_summary`` is ``prof``."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    from repro_torch.core import hier
    from repro_torch.kernels.sign_pack import sign_pack
    from repro_torch.kernels.ternary_quant import ternary_quant
    from repro_torch.kernels.vote_update import vote_update
    from repro_torch.launch.train import run_training

    prof = (tprofile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA])
            if profile is not None else None)

    def on_metrics(step, metrics):
        if step == profile - 1:
            prof.start()
        elif step == profile:
            torch.cuda.synchronize()
            prof.stop()

    sign_pack.launches = vote_update.launches = ternary_quant.launches = 0
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    if profile == "all":
        prof.start()
    state, history = run_training(
        cfg, topo, algo, run, params=params,
        log=lambda line: print(f"{tag}: {line}", flush=True),
        on_metrics=on_metrics if isinstance(profile, int) else None)
    torch.cuda.synchronize()
    if profile == "all":
        prof.stop()
    res = {"history": history,
           "prof": device_summary(prof) if prof is not None else None,
           "peak_gb": (torch.cuda.max_memory_allocated() - before) / 1e9,
           "launches": {"sign_pack": sign_pack.launches,
                        "vote_update": vote_update.launches,
                        "ternary_quant": ternary_quant.launches},
           "params": hier.edge_params(state),
           "n_pad": getattr(state.params, "layout", None)}
    losses = [h["loss"] for h in history]
    require(all(map(math.isfinite, losses)), f"{tag}: losses {losses}")
    for n, leaf in pytree_items(res["params"]):
        require(bool(torch.isfinite(leaf).all()), f"{tag}/{n}: non-finite")
    return res


def phase_lm(torch) -> dict:
    """The LM trainer on the card: gemma3-1b at full width (6 layers), P=2
    edges x D=3 devices, batch 1 x 1152 tokens a device, bf16 compute, f32
    master, DC-HierSignSGD, T_E=3, 6 steps through ``run_training``: on
    fused/flat (one sign_pack and one vote_update a step), again on
    ag_packed/tree from the same parameters and tokens (bitwise the same
    edge models), and once more on fused/flat under torch.profiler (the
    kernels' device time; bitwise the first).  Then 2 steps of
    hier_local_qsgd with K=2 streamed clients (batch 2 a device).
    Returns the kernel launches counted in the fused/flat DC run and in
    the QSGD run."""
    from repro_torch.core.clients import ClientConfig
    from repro_torch.launch.train import RunCfg
    from repro_torch.models import build

    t_phase = time.perf_counter()
    cfg, topo, algo = lm_setup(torch)
    built = build.build_model(cfg, topo)
    params = built.init_params(torch.Generator(device="cuda").manual_seed(0))
    n_params = build.param_count(params)
    # LMConfig.param_count leaves out the RMS norms' gains
    n_norms = sum(leaf.numel() for name, leaf in pytree_items(params)
                  if name.rsplit(".", 1)[-1] in ("n1", "n2", "qn", "kn",
                                                 "norm"))
    emit({"lm": "parameters", "arch": cfg.name, "n_layers": cfg.n_layers,
          "count": n_params, "norm_gains": n_norms,
          "config_param_count": cfg.param_count(),
          "full_depth_config_param_count": dataclasses.replace(
              cfg, n_layers=26).param_count()})
    require(n_params == cfg.param_count() + n_norms,
            f"{n_params} parameters, the config counts {cfg.param_count()} "
            f"and {n_norms} norm gains")
    run = RunCfg(steps=LM_STEPS, batch_per_device=1, seq_len=LM_SEQ,
                 log_every=1, seed=0)

    from repro_torch.data import synthetic
    tokens = synthetic.make_stream(synthetic.LMStreamCfg(
        vocab=cfg.vocab, seq_len=LM_SEQ, batch_per_device=1, pods=LM_P,
        devices_per_pod=LM_D, seed=0))(0)["tokens"].cuda()
    differ = lm_grads_bitwise(torch, built, params, {"tokens": tokens})
    print(f"[lm] one step's per-voter gradients, evaluated twice: "
          f"{differ} coordinates differ", flush=True)
    require(differ == 0, "the LM's per-voter gradients are not "
            "deterministic on the card: the layouts cannot be bitwise")

    def one(tag, algo_, run_=run, profiled=False):
        return lm_train(torch, f"[lm] {tag}", cfg, topo, algo_, run_,
                        params, profile="all" if profiled else None)

    fused = one("fused/flat", algo)
    want = {"sign_pack": LM_STEPS, "vote_update": LM_STEPS,
            "ternary_quant": 0}
    require(fused["launches"] == want, f"fused/flat launches "
            f"{fused['launches']}, want {want}")
    losses = [h["loss"] for h in fused["history"]]
    round2 = statistics.mean(losses[LM_TE:2 * LM_TE])
    require(round2 < losses[0], f"the loss did not fall: step 0 "
            f"{losses[0]}, round 2 mean {round2}")
    tree = one("ag_packed/tree", dataclasses.replace(
        algo, transport="ag_packed", state_layout="tree"))
    require(tree["launches"] == dict.fromkeys(want, 0),
            f"ag_packed/tree launched kernels: {tree['launches']}")
    diff = count_differing(torch, fused["params"], tree["params"])
    require(diff == 0, f"fused/flat and ag_packed/tree edge models differ "
            f"in {diff} coordinates")
    print("[lm] fused/flat == ag_packed/tree edge models, bitwise",
          flush=True)
    tree_ms = statistics.mean(h["ms"] for h in tree["history"][LM_TE:])
    del tree
    prof_run = one("fused/flat, profiled", algo, profiled=True)
    diff = count_differing(torch, fused["params"], prof_run["params"])
    require(diff == 0, f"two fused/flat runs differ in {diff} coordinates")
    prof = prof_run["prof"]
    n_pad = fused["n_pad"].n_pad
    shape = (LM_P, LM_D, n_pad)
    sp_ms, sp_n = prof["sign_pack_kernel"]
    vu_ms, vu_n = prof["vote_update_kernel"]
    sp_bound = bound(sign_pack_bytes(shape, 2, False),
                     sign_pack_ops(shape, False))
    vu_bound = bound(vote_update_bytes(shape, True, LM_P * LM_D),
                     vote_update_ops(shape, True))
    host_ms = statistics.mean(h["ms"] for h in fused["history"][LM_TE:])
    emit({"lm": "step", "ms_per_step_round2_fused_flat": host_ms,
          "ms_per_step_round2_ag_packed_tree": tree_ms,
          "ms_per_step_round2_profiled": statistics.mean(
              h["ms"] for h in prof_run["history"][LM_TE:]),
          "data_ms_per_step": statistics.mean(
              h["data_ms"] for h in fused["history"]),
          "losses": losses, "round2_mean_loss": round2,
          "n_pad": n_pad, "launches": fused["launches"]})
    emit({"lm": "kernels", "shape": list(shape),
          "sign_pack_device_ms": sp_ms / max(sp_n, 1),
          "sign_pack_bound_ms": sp_bound[0],
          "sign_pack_bytes": sign_pack_bytes(shape, 2, False),
          "vote_update_device_ms": vu_ms / max(vu_n, 1),
          "vote_update_bound_ms": vu_bound[0],
          "vote_update_bytes": vote_update_bytes(shape, True, LM_P * LM_D),
          "launches_profiled": [sp_n, vu_n],
          "device_busy_ms_per_step": prof["busy_ms"] / LM_STEPS,
          "kernels_share_of_device_time": (sp_ms + vu_ms) / prof["busy_ms"],
          "top": prof["top"]})
    emit({"lm": "memory", "peak_gb_fused_flat": fused["peak_gb"],
          "reckoned_gb": LM_RECKONED_GB,
          "total_gb": torch.cuda.get_device_properties(0).total_memory / 1e9})
    dc_launches, dc_peak = fused["launches"], fused["peak_gb"]
    del prof_run, fused
    torch.cuda.empty_cache()

    # hier_local_qsgd, K=2 clients streamed, one row a client
    qalgo = dataclasses.replace(
        algo, method="hier_local_qsgd",
        clients=ClientConfig(count=2, mode="stream"))
    qrun = dataclasses.replace(run, steps=2, batch_per_device=2)
    qsgd = one("hier_local_qsgd, K=2 stream", qalgo, qrun)
    leaves = len(pytree_items(qsgd["params"]))
    want_q = {"sign_pack": 0, "vote_update": 0,
              "ternary_quant": 2 * 2 * leaves}
    require(qsgd["launches"] == want_q, f"hier_local_qsgd launches "
            f"{qsgd['launches']}, want {want_q}")
    n = n_params
    emb = cfg.vocab * cfg.d_model
    emit({"lm": "qsgd stream memory", "peak_gb": qsgd["peak_gb"],
          "uniforms_all_clients_gb": LM_P * LM_D * 2 * n * 4 / 1e9,
          "uniforms_one_client_gb": LM_P * LM_D * n * 4 / 1e9,
          "uniforms_one_client_one_leaf_gb": LM_P * LM_D * emb * 4 / 1e9,
          "losses": [h["loss"] for h in qsgd["history"]],
          "ms_per_step": [h["ms"] for h in qsgd["history"]],
          "launches": qsgd["launches"]})
    qsgd_launches = qsgd["launches"]
    peaks = {"dc": dc_peak, "qsgd": qsgd["peak_gb"]}
    del qsgd, params
    torch.cuda.empty_cache()
    emit({"lm": "phase", "wall_s": time.perf_counter() - t_phase})
    return {"dc": dc_launches, "qsgd": qsgd_launches, "peak_gb": peaks}


DRY_PEAK_SLACK = 2**16       # bytes: a dry run's peak against the card's
                             # (readings 0 bytes in 53 GB; one of the lm
                             # config's activations is 16 MB)
DRY_BUDGET_S = 20.0          # the dryrun phase's seconds
DRY_GRID = (2, 2, 2)         # the smoke config's fake grid
DRY_SMOKE_ARCH = "stablelm_3b"   # two layers: the quickest to trace
DRY_SMOKE = {   # name -> AlgoConfig fields (the wrapper it reaches)
    "stream": dict(transport="fused", state_layout="flat", t_e=3),
    "qsgd": dict(method="hier_local_qsgd", transport="fused",
                 state_layout="flat", t_e=3)}


def dry_record(rec: dict) -> dict:
    """A dry record without its host seconds (the one number the device
    may change)."""
    return {k: v for k, v in rec.items() if k != "trace_s"}


def card_steps(torch, built, topo, algo, batch: int, seq: int,
               labels) -> dict:
    """``labels``' (label, sync) train steps on the card, in order from
    ``init_fn``'s state (seed-0 parameters, seed-1 tokens [P, D, batch,
    seq]): each step's requested-bytes peak and its arguments, both
    counted from before the steps' inputs are made, its launches and
    its loss."""
    from repro_torch.core import hier

    def requested(stat: str) -> int:
        return torch.cuda.memory_stats()[f"requested_bytes.all.{stat}"]

    init_fn, step = hier.make_hier_step(topo, algo, built.bundle)
    torch.cuda.synchronize()
    start = requested("current")      # before the steps' inputs are made
    params = built.init_params(torch.Generator(device="cuda").manual_seed(0))
    state = init_fn(params, 1)
    del params
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = {"train": {"tokens": torch.randint(
        0, built.cfg.vocab, (LM_P, LM_D, batch, seq), device="cuda",
        generator=gen)}}
    weights = (torch.full((LM_P,), 1.0 / LM_P, device="cuda"),
               torch.full((LM_P, LM_D), 1.0 / LM_D, device="cuda"),
               torch.ones((LM_P, LM_D), device="cuda"))
    real = {}
    for label, _ in labels:
        zero_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        require(requested("peak") == requested("current"),
                f"{label}: the allocator's requested peak was not reset")
        args = requested("current") - start
        state, metrics = step(state, tokens, *weights)
        torch.cuda.synchronize()
        real[label] = {
            "peak_bytes": requested("peak") - start,
            "argument_bytes": args, "launches": counted_launches(),
            "loss": float(metrics["loss"])}
        del metrics
        require(math.isfinite(real[label]["loss"]),
                f"{label}: the card's loss {real[label]['loss']}")
    del state, tokens, weights
    torch.cuda.empty_cache()
    return real


def hold_dry(head: dict, tag: str, dry: dict, want: dict) -> None:
    """Emit ``head`` with a dry record's memory and calls beside the
    card's step (``card_steps``), then hold them: the arguments equal,
    the peak within ``DRY_PEAK_SLACK``, the fake calls the launches."""
    mem = dry["memory"]
    off = mem["peak_bytes"] - want["peak_bytes"]
    emit({**head, "dry_peak_bytes": mem["peak_bytes"],
          "card_peak_bytes": want["peak_bytes"], "peak_off_bytes": off,
          "peak_rel": abs(off) / want["peak_bytes"],
          "dry_argument_bytes": mem["argument_bytes"],
          "card_argument_bytes": want["argument_bytes"],
          "dry_calls": dry["launches"], "card_launches": want["launches"],
          "trace_s": dry["trace_s"], "loss": want["loss"]})
    require(mem["argument_bytes"] == want["argument_bytes"],
            f"{tag}: the dry arguments {mem['argument_bytes']} bytes, the "
            f"card's {want['argument_bytes']}")
    require(abs(off) <= DRY_PEAK_SLACK, f"{tag}: the dry peak "
            f"{mem['peak_bytes']} is {off} bytes off the card's "
            f"{want['peak_bytes']} (limit {DRY_PEAK_SLACK})")
    require(dry["launches"] == want["launches"], f"{tag}: fake calls "
            f"{dry['launches']}, the card launched {want['launches']}")


def phase_dryrun(torch, card: str) -> dict:
    """The dry run held against the card (the module docstring's phase
    17): each step's peak beside the card's, the fake calls beside the
    launches, fake CUDA beside fake CPU.  Returns the real launches and
    the fake calls of each step."""
    from repro_torch import configs
    from repro_torch.core import hier
    from repro_torch.core.clients import ClientConfig
    from repro_torch.launch import dryrun, mesh
    from repro_torch.models import build
    from repro_torch.models.config import ShapeCfg

    t_phase = time.perf_counter()
    cfg, topo, algo = lm_setup(torch)
    built = build.build_model(cfg, topo)
    labels = (("sync_step", "always"), ("local_step", "never"))
    real = card_steps(torch, built, topo, algo, 1, LM_SEQ, labels)
    t_real = time.perf_counter() - t_phase

    launched = counted_launches()
    shape = ShapeCfg("lm", "train", LM_SEQ, LM_P * LM_D)
    dry = {label: dryrun.analyze(dryrun.lower_train(
        built, topo, algo, shape, sync), label, verbose=False)
        for label, sync in labels}
    for label, _ in labels:
        hold_dry({"dryrun": label, "card": card}, f"dryrun {label}",
                 dry[label], real[label])
    t_lm = time.perf_counter() - t_phase - t_real

    smoke = configs.get_smoke(DRY_SMOKE_ARCH)
    sshape = ShapeCfg("smoke", "train", 8, 2 * DRY_GRID[0] * DRY_GRID[1])
    devices = {}
    for name, kw in DRY_SMOKE.items():
        if name == "stream":
            kw = dict(kw, clients=ClientConfig(count=2, mode="stream"))
        recs = {}
        for device in ("cuda", "cpu"):
            with mesh.dry_grid(*DRY_GRID, device=device) as dtopo:
                dbuilt = build.build_model(smoke, dtopo)
                recs[device] = dry_record(dryrun.analyze(dryrun.lower_train(
                    dbuilt, dtopo, hier.AlgoConfig(**kw), sshape, "always"),
                    name, verbose=False))
        reached = "tally_acc" if name == "stream" else "ternary_quant"
        emit({"dryrun": f"smoke {name}", "calls": recs["cuda"]["launches"],
              "peak_bytes": recs["cuda"]["memory"]["peak_bytes"],
              "groups": recs["cuda"]["comm"]["groups"],
              "cuda_equals_cpu": recs["cuda"] == recs["cpu"]})
        require(recs["cuda"] == recs["cpu"], f"dryrun smoke {name}: the "
                f"fake CUDA record differs from the fake CPU one:\n"
                f"{recs['cuda']}\n{recs['cpu']}")
        require(recs["cuda"]["launches"][reached] > 0,
                f"dryrun smoke {name}: {reached}'s fake path not reached")
        devices[name] = recs["cuda"]["launches"]
    require(counted_launches() == launched,
            f"a dry run launched kernels: {launched} -> {counted_launches()}")
    wall = time.perf_counter() - t_phase
    emit({"dryrun": "phase", "wall_s": wall, "card_steps_s": t_real,
          "lm_dry_s": t_lm, "smoke_dry_s": wall - t_real - t_lm,
          "budget_s": DRY_BUDGET_S, "within_budget": wall <= DRY_BUDGET_S})
    return {"real": {label: real[label]["launches"] for label, _ in labels},
            "fake": {label: dry[label]["launches"] for label, _ in labels},
            "smoke_fake": devices}


FAMILIES = (("xlstm_350m", 1, 576),      # (arch, batch, tokens) a device:
            ("whisper_base", 4, 448))    # xlstm's sLSTM loop runs a position
                                         # at a time, the script's largest
                                         # cost at 1152 (half the lm
                                         # phase's); whisper's text context
FAM_XLSTM_LAYERS = 8     # xlstm cut to one 7:1 period: one sLSTM block,
                         # whose host-bound loop a position sets its step
FAM_STEPS = 4            # round 1 and round 2's prologue: xlstm's steps
                         # take 2-7 s, the phase's most; round 2's mean
                         # loss is checked, as whisper's step 2 spikes
                         # (15.3 after 11.3 and 9.2)
FAM_PROFILED = 2         # round 1's last local step (a profiled prologue
                         # step's trace, twice the launches, took minutes)


def ssd_entries(cfg, seq: int) -> int:
    """Entries of one row's SSD chunk matrices [nc, H, c, c] at ``seq``
    positions (the ragged tail padded to a whole chunk)."""
    c = min(cfg.ssm.chunk, seq)
    heads = cfg.ssm.expand * cfg.d_model // 64
    return -(-seq // c) * heads * c * c


def reckon_peak(cfg, n: int, batch: int, seq: int, p: int = LM_P,
                d: int = LM_D) -> dict:
    """A training run's peak device memory (GB), reckoned from the tree's
    n parameters and the run's shapes before any run, at P x D copies in
    bf16 compute with an f32 master (the rule gives 49.3 GB for the lm
    phase, whose reckoning was 49); the bytes below are at the lm phase's
    P=2 x D=3 and scale with P (state) and P*D (anchor, grads):

      state   16n: the f32 master [P], bf16 delta and delta_next [P];
      anchor  36n: bf16 [P, D] gradients and their f32 flatten (DC's
              round prologue; the local step's u, its flatten and
              u + rho*delta, bf16 [P, D] each, are as much);
      grads   24n: the backward's bf16 [P, D] copies and gradients,
              while the larger of these activations is alive:
      logits  18 bytes a logit: bf16 logits, the f32 copy logsumexp
              keeps, the f32 gradients of logsumexp and of the gather
              and their sum, the bf16 gradient;
      block   the largest block's recompute and backward: the mLSTM's
              float32 [b, H, t, t] matrices, ten alive (40 bytes an
              entry), the SSD scan's float32 [b, nc, H, c, c] chunk
              matrices (rel's exp, gamma, the raw and the masked scores
              kept for the backward, and their gradients: ten alive, 40
              bytes an entry; ``ssd_entries``), or whisper's encoder
              scores [b, h, f, f], five float32 and two bf16 (24 bytes an
              entry);
      slstm   the ssm family's sLSTM blocks (not recomputed), kept from
              the forward to their backward: a block keeps 52 bytes a row,
              position and model dim -- seven float32 [b, H, hd] a
              position (the recurrent product's operand h, c, n, tanh(z),
              sigmoid(o), max(n, 1) and c over it: 28), the norm's and
              gated FFN's bf16 and float32 activations (about 22) and the
              gates' [b, H] scalars -- and one float32 copy of its bf16
              ``wr`` a [P, D] copy (16 H hd^2 bytes; the product reads it
              in place and never expands it to the rows).

    peak = state + max(anchor, grads + slstm + max(logits, block))."""
    rows = p * d * batch
    slstm = 0
    if cfg.family == "ssm":
        block = 40 * rows * cfg.n_heads * seq ** 2
        hd = cfg.d_model // cfg.n_heads
        slstm = cfg.n_layers // (cfg.xlstm.m_per_s + 1) * (
            52 * rows * seq * cfg.d_model + p * d * 16 * cfg.n_heads * hd ** 2)
    elif cfg.family == "hybrid":
        block = 40 * rows * ssd_entries(cfg, seq)
    else:
        block = 24 * rows * cfg.n_heads * cfg.encoder_frames ** 2
    terms = {"state": 8 * p * n, "anchor": 6 * p * d * n,
             "grads": 4 * p * d * n,
             "logits": 18 * rows * seq * cfg.vocab, "block": block,
             "slstm": slstm}
    peak = terms["state"] + max(terms["anchor"], terms["grads"]
                                + terms["slstm"] + max(terms["logits"],
                                                       terms["block"]))
    return {"peak_gb": peak / 1e9,
            **{f"{k}_gb": v / 1e9 for k, v in terms.items()}}


def phase_families(torch) -> dict:
    """The ssm and encdec families on the card: xlstm-350m (cut to
    ``FAM_XLSTM_LAYERS`` blocks, batch 1 x 576 tokens a device) and
    whisper-base whole (6 + 6
    layers, batch 4 x 448 tokens and 1500 x 80 frames a device), each at
    P=2 x D=3 in the lm phase's algorithm (DC, bf16 compute, f32 master,
    T_E=3, random weights from seed 0): one step's per-voter gradients
    twice (bitwise), ``FAM_STEPS`` steps of ``run_training`` on
    fused/flat (as many sign_pack and vote_update launches; step
    ``FAM_PROFILED``, a local step, profiled), the same on ag_packed/tree
    (bitwise the same edge models), the loss of round 2 below step 0's,
    the peak beside its reckoning.  Returns
    each model's fused/flat launches."""
    from repro_torch import configs
    from repro_torch.data import synthetic
    from repro_torch.launch.train import RunCfg
    from repro_torch.models import build

    t_phase = time.perf_counter()
    launches = {}
    for arch, batch, seq in FAMILIES:
        cfg, topo, algo = lm_setup(torch, configs.get_config(arch))
        n = build.param_count(build.build_model(cfg, topo).abstract_params())
        reckoned = reckon_peak(cfg, n, batch, seq)
        cut = None
        if cfg.family == "ssm":
            cut = f"depth {cfg.n_layers} -> {FAM_XLSTM_LAYERS}"
            cfg = dataclasses.replace(cfg, n_layers=FAM_XLSTM_LAYERS)
        built = build.build_model(cfg, topo)
        params = built.init_params(
            torch.Generator(device="cuda").manual_seed(0))
        n = build.param_count(params)
        reckoned = reckon_peak(cfg, n, batch, seq)
        emit({"families": "parameters", "arch": cfg.name,
              "family": cfg.family, "n_layers": cfg.n_layers,
              "encoder_layers": cfg.encoder_layers, "count": n,
              "config_param_count": cfg.param_count(), "cut": cut,
              "batch": batch, "seq": seq, "reckoned": reckoned})
        tag = f"[families] {arch}"
        run = RunCfg(steps=FAM_STEPS, batch_per_device=batch, seq_len=seq,
                     log_every=1, seed=0)
        first = synthetic.make_stream(synthetic.LMStreamCfg(
            vocab=cfg.vocab, seq_len=seq, batch_per_device=batch, pods=LM_P,
            devices_per_pod=LM_D, seed=0,
            frames=cfg.encoder_frames if cfg.encoder_layers else 0,
            frontend_dim=cfg.frontend_dim))(0)
        differ = lm_grads_bitwise(
            torch, built, params, {k: v.cuda() for k, v in first.items()},
            tag=tag)
        del first
        print(f"{tag}: one step's per-voter gradients, evaluated twice: "
              f"{differ} coordinates differ", flush=True)
        require(differ == 0, f"{arch}: the per-voter gradients are not "
                "deterministic on the card")
        fused = lm_train(torch, f"{tag} fused/flat", cfg, topo, algo, run,
                         params, profile=FAM_PROFILED)
        want = {"sign_pack": FAM_STEPS, "vote_update": FAM_STEPS,
                "ternary_quant": 0}
        require(fused["launches"] == want, f"{arch} fused/flat launches "
                f"{fused['launches']}, want {want}")
        losses = [h["loss"] for h in fused["history"]]
        round2 = statistics.mean(losses[LM_TE:2 * LM_TE])
        require(round2 < losses[0], f"{arch}: the loss did not fall: step "
                f"0 {losses[0]}, round 2 mean {round2}")
        tree = lm_train(torch, f"{tag} ag_packed/tree", cfg, topo,
                        dataclasses.replace(algo, transport="ag_packed",
                                            state_layout="tree"),
                        run, params)
        require(tree["launches"] == dict.fromkeys(want, 0),
                f"{arch} ag_packed/tree launched kernels: "
                f"{tree['launches']}")
        diff = count_differing(torch, fused["params"], tree["params"])
        require(diff == 0, f"{arch}: fused/flat and ag_packed/tree edge "
                f"models differ in {diff} coordinates")
        print(f"{tag}: fused/flat == ag_packed/tree edge models, bitwise",
              flush=True)
        prof = fused["prof"]
        shape = (LM_P, LM_D, fused["n_pad"].n_pad)
        sp_ms, sp_n = prof["sign_pack_kernel"]
        vu_ms, vu_n = prof["vote_update_kernel"]
        sp_bytes = sign_pack_bytes(shape, 2, False)
        vu_bytes = vote_update_bytes(shape, True, LM_P * LM_D)
        host = [h["ms"] for h in fused["history"]]
        emit({"families": "step", "arch": cfg.name,
              "ms_per_local_step_fused_flat": statistics.mean(
                  ms for s, ms in enumerate(host[:LM_TE])
                  if s and s != FAM_PROFILED),
              "ms_profiled_step": host[FAM_PROFILED],
              "ms_per_local_step_ag_packed_tree": statistics.mean(
                  h["ms"] for h in tree["history"][1:LM_TE]),
              "data_ms_per_step": statistics.mean(
                  h["data_ms"] for h in fused["history"]),
              "losses": losses, "round2_mean_loss": round2,
              "launches": fused["launches"]})
        emit({"families": "kernels", "arch": cfg.name, "shape": list(shape),
              "sign_pack_device_ms": sp_ms / max(sp_n, 1),
              "sign_pack_bound_ms": bound(sp_bytes, sign_pack_ops(
                  shape, False))[0],
              "sign_pack_bytes": sp_bytes,
              "vote_update_device_ms": vu_ms / max(vu_n, 1),
              "vote_update_bound_ms": bound(vu_bytes, vote_update_ops(
                  shape, True))[0],
              "vote_update_bytes": vu_bytes,
              "launches_profiled": [sp_n, vu_n],
              "device_busy_ms_profiled_step": prof["busy_ms"],
              "kernels_share_of_device_time":
                  (sp_ms + vu_ms) / max(prof["busy_ms"], 1e-9),
              "top": prof["top"]})
        emit({"families": "memory", "arch": cfg.name,
              "peak_gb_fused_flat": fused["peak_gb"],
              "peak_gb_ag_packed_tree": tree["peak_gb"],
              "reckoned_gb": reckoned["peak_gb"],
              "reckoned_slstm_gb": reckoned["slstm_gb"]})
        launches[arch] = fused["launches"]
        del fused, tree, params, built
        torch.cuda.empty_cache()
        if cfg.family == "ssm":
            fam_dry_step(torch, cfg, topo, algo)
    emit({"families": "phase", "wall_s": time.perf_counter() - t_phase})
    return launches


FAM_DRY_BATCH, FAM_DRY_SEQ = 4, 128   # the xlstm step held against its
                         # dry run, a device: 128 positions through the
                         # sLSTM loop, on 4 rows (at 1 the product's rows
                         # are the P x D copies, which wr carries too)


def fam_dry_step(torch, cfg, topo, algo) -> None:
    """The families phase's xlstm (its cut, P x D, ``FAM_DRY_BATCH`` x
    ``FAM_DRY_SEQ`` tokens a device): a sync and a local step on the
    card (``card_steps``), the local step dry on fake CUDA tensors
    (``launch.dryrun``) and held against the card's as ``phase_dryrun``
    holds the lm configuration's (``hold_dry``).  What it checks that
    the lm configuration does not: the accounting of the sLSTM's loop,
    which keeps its operands a position for the backward."""
    from repro_torch.launch import dryrun
    from repro_torch.models import build
    from repro_torch.models.config import ShapeCfg

    t0 = time.perf_counter()
    built = build.build_model(cfg, topo)
    real = card_steps(torch, built, topo, algo, FAM_DRY_BATCH, FAM_DRY_SEQ,
                      (("sync_step", "always"), ("local_step", "never")))
    t_card = time.perf_counter() - t0
    launched = counted_launches()
    dry = dryrun.analyze(dryrun.lower_train(
        built, topo, algo, ShapeCfg(cfg.name, "train", FAM_DRY_SEQ,
                                    LM_P * LM_D * FAM_DRY_BATCH), "never"),
        "local_step", verbose=False)
    require(counted_launches() == launched, f"families dry: the dry run "
            f"launched kernels: {launched} -> {counted_launches()}")
    hold_dry({"families": "dry", "arch": cfg.name, "batch": FAM_DRY_BATCH,
              "seq": FAM_DRY_SEQ, "card_s": t_card,
              "wall_s": time.perf_counter() - t0},
             "families dry local_step", dry, real["local_step"])


FT_KEEP = 2                          # checkpoints the phase's runs keep
FT_A_STEPS, FT_A_RESUME_TO, FT_A_EVERY = 6, 12, 6    # run A's second
                                     # run resumes at 6, restores it at 7
FT_B_STEPS, FT_B_EVERY, FT_B_K = 6, 3, 2
ORACLE_METHODS = ("hier_signsgd", "dc_hier_signsgd", "scaffold_hier_signsgd",
                  "mtgc_hier_signsgd", "hier_sgd")


def ft_schedule(run: str, nan: bool):
    """The fault_tolerant phase's chaos schedules (events at step s apply
    before step s).  Run A (K=1): a device killed at 1 and back at 3, a
    straggler demoted at 2 and back at 4, a heartbeat loss swept at 4
    and back at 6, a nan at 7.  Run B (K=2): a client killed at 1 and
    back at 3, a nan at 4."""
    from repro_torch.runtime.chaos import ChaosEvent, FaultInjector

    if run == "A":
        evs = [ChaosEvent(1, "device", 0, 1),
               ChaosEvent(2, "straggler", 1, 2),
               ChaosEvent(3, "recover", 0, 1), ChaosEvent(4, "recover", 1, 2),
               ChaosEvent(4, "heartbeat", 1, 0),
               ChaosEvent(6, "recover", 1, 0)]
        nan_at = 7
    else:
        evs = [ChaosEvent(1, "client", 0, 1, 1),
               ChaosEvent(3, "recover", 0, 1, 1)]
        nan_at = 4
    return FaultInjector(evs + ([ChaosEvent(nan_at, "nan")] if nan else []))


def oracle_schedule(t_e: int):
    """The parity harness's churn kinds on the paper task's Q=4 x D=5: a
    client killed mid-round, a pod down across the round boundary, a
    straggler demoted at the boundary, a heartbeat loss swept by the
    timeout, and the recoveries."""
    from repro_torch.runtime.chaos import ChaosEvent, FaultInjector

    return FaultInjector([
        ChaosEvent(1, "client", 0, 4, 0), ChaosEvent(t_e - 3, "pod", 2),
        ChaosEvent(t_e, "straggler", 0, 0, 0),
        ChaosEvent(t_e + 1, "recover", 0, 4, 0),
        ChaosEvent(t_e + 3, "recover", 2),
        ChaosEvent(t_e + 5, "heartbeat", 1, 1),
        ChaosEvent(t_e + 7, "recover", 1, 1),
        ChaosEvent(t_e + 7, "recover", 0, 0, 0)])


def phase_oracle(torch, card: str) -> dict:
    """The paper task at full width (Q=4 x D=5, B=400, 2 rounds of
    T_E=15) under a compiled chaos schedule: the step on fused/flat, its
    kernels engaged, against the port's loop-over-clusters oracle
    (``core.ref_fed``) on the card, fed the same membership arrays.  One
    client kind (K=1, unit weights) keeps the arrays client-granular, as
    the oracle reads them.  The oracle starts from the model the step's
    first prologue commits (the cloud mean of the Q copies of w0), and
    takes each client's gradient on a [Q, D] block of copies
    (``ref_fed.loss_grad_fn(copies=...)``: cuBLAS picks its kernels by
    the shape, and a [1, 1] copy's gradient differs from the step's in
    the last bits).

    Two kinds of data shares: every method on slices of 1, 1, 2, 2, 2
    an edge (every participating share dyadic, exact in float32 and in
    the oracle's float64), then DC on the task's own |D_qd| (uneven
    shares, which the oracle renormalizes over the live clients in
    float64).  Sign methods bitwise when one step's per-voter gradients
    of the two forms are bitwise, else within 1e-5; hier_sgd within
    1e-5; each case prints its differing count.  Returns the sign
    methods' kernel launches by case."""
    import numpy as np

    from repro_torch.core import hier, pytree, ref_fed, votes
    from repro_torch.core.clients import ClientConfig
    from repro_torch.core.topology import Topology
    from repro_torch.kernels.sign_pack import sign_pack
    from repro_torch.kernels.vote_update import vote_update
    from repro_torch.launch.train import (FedBenchCfg, _federated_data,
                                          sample_batches)
    from repro_torch.models import mlp
    from repro_torch.runtime import chaos, elastic

    q, d, t_e, rounds = 4, 5, 15, 2
    steps = rounds * t_e
    base = FedBenchCfg(rounds=rounds, t_e=t_e, batch=400, mu=MU, rho=RHO,
                       n_train=20000, q_edges=q, devices_per_edge=d)
    batches = sample_batches(base, "cuda")
    data_sizes = np.array([[len(dev["y"]) for dev in edge]
                           for edge in _federated_data(base)[0]])
    cc = ClientConfig(count=1, weights=tuple(tuple((1,) for _ in range(d))
                                             for _ in range(q)))
    params0 = mlp.init_mlp(torch.Generator(device="cuda").manual_seed(0))
    # each client's gradient on a [Q, D] block of its copies: the shapes
    # the step's matmuls have, so cuBLAS picks the step's kernels
    grad_fn = ref_fed.loss_grad_fn(mlp.loss_fn, copies=(q, d))

    def client(s, qq, dd):
        return {k: v[qq, dd] for k, v in batches[s].items()}

    leaves, td = pytree.tree_flatten(params0)
    copies = [x.expand((q, d) + tuple(x.shape)).contiguous()
              .requires_grad_(True) for x in leaves]
    g_step = torch.autograd.grad(mlp.loss_fn(pytree.tree_unflatten(
        td, copies), batches[0]).sum(), copies)
    differ = {}
    for form, fn in (("[Q, D] block", grad_fn),
                     ("[1, 1] copy", ref_fed.loss_grad_fn(mlp.loss_fn))):
        differ[form] = 0
        for qq in range(q):
            for dd in range(d):
                g = pytree.tree_flatten(fn(params0, client(0, qq, dd)))[0]
                differ[form] += sum(int((a[qq, dd].view(torch.int32)
                                         != b.view(torch.int32)).sum())
                                    for a, b in zip(g_step, g))
    grad_differ = differ["[Q, D] block"]
    same_grads = grad_differ == 0
    print(f"[oracle] one step's per-voter gradients against the oracle's "
          f"grad_fn, coordinates that differ: {differ} (the oracle uses the "
          f"[Q, D] block; bitwise {same_grads})", flush=True)

    shares = {"dyadic": np.tile([1, 1, 2, 2, 2], (q, 1)), "data": data_sizes}
    print(f"[oracle] |D_qd| of the task (the 'data' shares): "
          f"{data_sizes.tolist()}", flush=True)
    arrays = {}
    for kind, sizes in shares.items():
        member = elastic.Membership(q, d, clients=cc, data_sizes=sizes)
        arrays[kind] = chaos.compile_schedule(oracle_schedule(t_e), member,
                                              steps + 1)
        live = [float(np.mean(a.mask)) for a in arrays[kind]]
        print(f"[oracle] {kind} shares: membership live share by step "
              f"{live}", flush=True)

    launches = {}
    cases = ([(m, "dyadic") for m in ORACLE_METHODS]
             + [("dc_hier_signsgd", "data")])
    for method, kind in cases:
        arr = arrays[kind]
        algo = hier.AlgoConfig(
            method=method, mu=MU, mu_sgd=base.mu_sgd, t_e=t_e, rho=RHO,
            transport="fused", state_layout="flat",
            compute_dtype=torch.float32, master_dtype=torch.float32,
            delta_dtype=torch.float32, clients=cc)
        init_fn, step = hier.make_hier_step(Topology(q, d, "cuda"), algo,
                                            mlp.make_bundle())
        state = init_fn(params0, 0)
        sign_pack.launches = vote_update.launches = 0
        t0 = time.perf_counter()
        for s in range(steps):
            ew, dw, mask = arr[s]
            state, _ = step(state, {"train": batches[s],
                                    "anchor": batches[s - s % t_e]},
                            ew, dw, mask)
        torch.cuda.synchronize()
        step_s = time.perf_counter() - t0
        launched = {"sign_pack": sign_pack.launches,
                    "vote_update": vote_update.launches}
        ew_close = torch.tensor(arr[steps].edge_weights, device="cuda")
        got = {n: votes.pod_weighted_average(v, ew_close)[0]
               for n, v in hier.edge_params(state).items()}

        cfg = ref_fed.HierConfig(mu=MU, mu_sgd=base.mu_sgd, t_e=t_e, rho=RHO,
                                 method=method)
        w0 = ref_fed._tree_weighted_sum(
            [float(x) for x in arr[0].edge_weights], [params0] * q)
        ostate = ref_fed.init_state(w0, q)
        t0 = time.perf_counter()
        for t in range(rounds):
            s0 = t * t_e
            masks = [[list(np.asarray(arr[s0 + tau].mask)[qq, :, 0] > 0.5)
                      for qq in range(q)] for tau in range(t_e)]
            dwq = np.asarray(arr[s0].dev_weights)
            ostate = ref_fed.global_round(
                ostate, cfg, grad_fn,
                [[[client(s0 + tau, qq, dd) for tau in range(t_e)]
                  for dd in range(d)] for qq in range(q)],
                [[client(s0, qq, dd) for dd in range(d)] for qq in range(q)],
                [float(x) for x in arr[s0].edge_weights],
                [[float(x) for x in row] for row in dwq],
                device_mask=masks[0], device_mask_steps=masks,
                vote_weights=[[1] * d for _ in range(q)],
                reweight_participation=True,
                edge_weights_agg=[float(x) for x in
                                  arr[s0 + t_e].edge_weights])
        torch.cuda.synchronize()
        oracle_s = time.perf_counter() - t0
        differ = count_differing(torch, got, ostate.w)
        max_abs = max(float((got[n] - ostate.w[n]).abs().max()) for n in got)
        sign = method != "hier_sgd"
        emit({"fault_tolerant": "oracle", "card": card, "method": method,
              "shares": kind, "grads_bitwise": same_grads,
              "grad_differing": grad_differ, "differing": differ,
              "max_abs_diff": max_abs, "launches": launched,
              "step_s": step_s, "oracle_s": oracle_s})
        tag = f"oracle/{method}/{kind} shares"
        want = steps if sign else 0
        require(launched == {"sign_pack": want, "vote_update": want},
                f"{tag}: launches {launched}, want {want} each")
        require(all(bool(torch.isfinite(v).all()) for v in got.values()),
                f"{tag}: non-finite edge models")
        if sign and same_grads:
            require(differ == 0, f"{tag}: the step and the oracle differ in "
                    f"{differ} coordinates although their gradients are "
                    "bitwise")
        else:
            require(max_abs <= 1e-5, f"{tag}: the step and the oracle "
                    f"differ by {max_abs} ({differ} coordinates)")
        if sign:
            launches[f"{method}, {kind} shares"] = launched
        del state, ostate, got
    return launches


def ft_run(torch, tag, cfg, topo, algo, run, params, injector) -> dict:
    """One ``run_training`` of the fault_tolerant phase with its kernel
    launches, checkpoint events, executed steps (the history's, plus
    each step a restore threw away), peak memory and final edge models
    (views of the state's buffer)."""
    from repro_torch.core import hier
    from repro_torch.kernels.sign_pack import sign_pack
    from repro_torch.kernels.tally_acc import tally_acc
    from repro_torch.kernels.vote_update import vote_update
    from repro_torch.launch.train import run_training

    kernels = {"sign_pack": sign_pack, "vote_update": vote_update,
               "tally_acc": tally_acc}
    for kern in kernels.values():
        kern.launches = 0
    events = []
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, history = run_training(
        cfg, topo, algo, run, fault_injector=injector, params=params,
        log=lambda line: print(f"[fault_tolerant] {tag}: {line}", flush=True),
        on_checkpoint=events.append)
    torch.cuda.synchronize()
    res = {"history": history, "events": events,
           "wall_s": time.perf_counter() - t0,
           "executed": len(history) + sum(e["event"] == "restore"
                                          for e in events),
           "launches": {n: k.launches for n, k in kernels.items()},
           "peak_gb": (torch.cuda.max_memory_allocated() - before) / 1e9,
           "params": hier.edge_params(state)}
    del state
    losses = [h["loss"] for h in history]
    require(all(map(math.isfinite, losses)), f"{tag}: losses {losses}")
    for n, leaf in pytree_items(res["params"]):
        require(bool(torch.isfinite(leaf).all()), f"{tag}/{n}: non-finite")
    for e in events:
        emit({"fault_tolerant": "checkpoint", "run": tag, **e})
    emit({"fault_tolerant": "run", "run": tag, "steps": [h["step"]
                                                          for h in history],
          "live": [h["live"] for h in history], "losses": losses,
          "executed": res["executed"], "launches": res["launches"],
          "peak_gb": res["peak_gb"], "wall_s": res["wall_s"]})
    return res


def ft_saves(res) -> list:
    return [e["step"] for e in res["events"] if e["event"] == "save"]


def ft_restores(res) -> list:
    return [(e["at"], e["step"]) for e in res["events"]
            if e["event"] == "restore"]


def phase_fault_tolerant(torch, lm: dict, card: str) -> dict:
    """Fault-tolerant training on the card (see the module docstring):
    the oracle check, then run A and run B of gemma3-1b at full width
    cut to two layers with checkpoints, restores and resumes, each
    bitwise its
    uninterrupted reference; then tally_acc at the streamed LM shape.
    Returns the kernel launches of the phase's runs."""
    import shutil

    from repro_torch.core import flatbuf
    from repro_torch.core.clients import ClientConfig
    from repro_torch.kernels import ref
    from repro_torch.kernels.tally_acc import tally_acc
    from repro_torch.launch.train import RunCfg
    from repro_torch.models import build

    t_phase = time.perf_counter()
    oracle_launches = phase_oracle(torch, card)
    cfg, topo, algo = lm_setup(torch, two_layer_cut())
    params = build.build_model(cfg, topo).init_params(
        torch.Generator(device="cuda").manual_seed(0))
    n_pad = flatbuf.make_layout(params).n_pad
    # params in f32, delta and delta_next saved as f32 (bf16 widened)
    ckpt_bytes = 3 * LM_P * n_pad * 4
    root = ROOT / "build" / "fault_tolerant_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    free = shutil.disk_usage(root).free
    emit({"fault_tolerant": "disk", "card": card, "dir": str(root),
          "free_gb": free / 1e9, "checkpoint_gb_reckoned": ckpt_bytes / 1e9,
          "keep": FT_KEEP})
    require(free >= (FT_KEEP + 1) * ckpt_bytes,
            f"{free / 1e9:.2f} GB free cannot hold {FT_KEEP + 1} checkpoints "
            f"of {ckpt_bytes / 1e9:.2f} GB")

    # run A: K=1, device events to 6, then a second run resuming at 6
    # whose nan at 7 restores the first run's checkpoint
    run_a = RunCfg(steps=FT_A_STEPS, batch_per_device=1, seq_len=LM_SEQ,
                   ckpt_dir=str(root / "a"), ckpt_every=FT_A_EVERY,
                   ckpt_keep=FT_KEEP, log_every=1, seed=0)
    ref_a = ft_run(torch, "A reference", cfg, topo, algo, dataclasses.replace(
        run_a, steps=FT_A_RESUME_TO, ckpt_dir=None), params,
        ft_schedule("A", nan=False))
    a1 = ft_run(torch, "A", cfg, topo, algo, run_a, params,
                ft_schedule("A", nan=False))
    a2 = ft_run(torch, "A resumed", cfg, topo, algo, dataclasses.replace(
        run_a, steps=FT_A_RESUME_TO), params, ft_schedule("A", nan=True))
    require(ref_a["executed"] == FT_A_RESUME_TO, "A reference: executed "
            f"{ref_a['executed']} steps")
    require(ft_restores(a1) == [] and ft_saves(a1) == [FT_A_STEPS],
            f"A: restores {ft_restores(a1)}, saves {ft_saves(a1)}")
    require(a1["executed"] == FT_A_STEPS, f"A: executed {a1['executed']} "
            "steps")
    resumed = [e for e in a2["events"] if e["event"] == "resume"]
    require(len(resumed) == 1 and resumed[0]["step"] == FT_A_STEPS
            and a2["history"][0]["step"] == FT_A_STEPS,
            f"A resumed: resume events {resumed}, first step "
            f"{a2['history'][0]['step']}")
    require(ft_saves(a2) == [FT_A_RESUME_TO] and ft_restores(a2) == [(7, 6)]
            and a2["executed"] == 8, f"A resumed: saves {ft_saves(a2)}, "
            f"restores {ft_restores(a2)}, executed {a2['executed']}")
    for res in (ref_a, a1, a2):
        n = res["executed"]
        require(res["launches"] == {"sign_pack": n, "vote_update": n,
                                    "tally_acc": 0},
                f"run A: launches {res['launches']}, want {n} sign_pack and "
                "vote_update (one an executed step)")
    diff = count_differing(torch, a2["params"], ref_a["params"])
    require(diff == 0, f"run A: the restored and resumed run differs from "
            f"the uninterrupted one in {diff} coordinates")
    print("[fault_tolerant] run A (resumed at 6, nan at 7 restored from 6) "
          "== uninterrupted 12 steps, bitwise", flush=True)
    launches = {k: a1["launches"][k] + a2["launches"][k]
                for k in a1["launches"]}
    peak_a = max(r["peak_gb"] for r in (ref_a, a1, a2))
    del ref_a, a1, a2
    torch.cuda.empty_cache()

    # run B: K=2 clients streamed, a client killed, a nan at 4
    algo_b = dataclasses.replace(algo, clients=ClientConfig(
        count=FT_B_K, mode="stream"))
    run_b = RunCfg(steps=FT_B_STEPS, batch_per_device=FT_B_K, seq_len=LM_SEQ,
                   ckpt_dir=str(root / "b"), ckpt_every=FT_B_EVERY,
                   ckpt_keep=FT_KEEP, log_every=1, seed=0)
    ref_b = ft_run(torch, "B reference, ag_packed/tree", cfg, topo,
                   dataclasses.replace(algo_b, transport="ag_packed",
                                       state_layout="tree"),
                   dataclasses.replace(run_b, ckpt_dir=None), params,
                   ft_schedule("B", nan=False))
    b = ft_run(torch, "B", cfg, topo, algo_b, run_b, params,
               ft_schedule("B", nan=True))
    require(ref_b["launches"] == dict.fromkeys(ref_b["launches"], 0),
            f"B reference launched kernels: {ref_b['launches']}")
    require(ft_restores(b) == [(4, 3)] and ft_saves(b) == [3, 6]
            and b["executed"] == 8,
            f"B: restores {ft_restores(b)}, saves {ft_saves(b)}, executed "
            f"{b['executed']}")
    require(b["launches"] == {"sign_pack": 0, "vote_update": 0,
                              "tally_acc": FT_B_K * b["executed"]},
            f"B: launches {b['launches']}, want {FT_B_K} tally_acc an "
            "executed step")
    diff = count_differing(torch, b["params"], ref_b["params"])
    require(diff == 0, f"run B: the restored run differs from the "
            f"uninterrupted ag_packed/tree run in {diff} coordinates")
    print("[fault_tolerant] run B (K=2 stream, nan at 4, restored from 3) "
          "== uninterrupted ag_packed/tree, bitwise", flush=True)
    launches = {k: launches[k] + b["launches"][k] for k in launches}
    peak_b = max(ref_b["peak_gb"], b["peak_gb"])
    uniforms_gb = LM_P * LM_D * cfg.vocab * cfg.d_model * 4 / 1e9
    emit({"fault_tolerant": "memory", "card": card,
          "peak_gb_run_a": peak_a, "lm_phase_peak_gb": lm["dc"],
          "peak_gb_run_b": peak_b, "lm_qsgd_stream_peak_gb": lm["qsgd"],
          "lm_qsgd_stream_peak_less_uniforms_gb": lm["qsgd"] - uniforms_gb,
          "checkpoint_gb_reckoned": ckpt_bytes / 1e9})
    del ref_b, b
    torch.cuda.empty_cache()
    shutil.rmtree(root)

    # tally_acc at the lm phase's streamed step's shape (6 layers): one
    # client's bf16 signs
    shape = (LM_P, LM_D, flatbuf.make_layout(build.build_model(
        lm_setup(torch)[0], topo).abstract_params()).n_pad)
    gen = torch.Generator(device="cuda").manual_seed(2)
    u = torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
    w = torch.ones((LM_P, LM_D), dtype=torch.int32, device="cuda")
    t0 = torch.zeros(shape, dtype=torch.int8, device="cuda")
    got = tally_acc(u, None, RHO, w, t0.clone())
    want = ref.tally_acc_ref(u, None, RHO, w, t0)
    mism = int((got != want).sum())
    del got, want
    tt = t0.clone()
    row = timed_row(
        Timer(torch, warmup=1, reps=5),
        {"kernel": "tally_acc", "case": "lm stream shape", "card": card,
         "shape": list(shape), "dtype": "bfloat16", "tally": "int8",
         "delta": False, "mismatched": mism},
        lambda: tally_acc(u, None, RHO, w, tt),
        lambda: ref.tally_acc_ref(u, None, RHO, w, t0), "tally_acc_kernel",
        tally_acc_bytes(shape, 2, 1, False), tally_acc_ops(shape, False))
    require(mism == 0, f"tally_acc disagrees with its plain version at the "
            f"LM's shape: {row}")
    del u, t0, tt
    torch.cuda.empty_cache()
    emit({"fault_tolerant": "phase", "card": card,
          "wall_s": time.perf_counter() - t_phase})
    return {"launches": launches, "oracle": oracle_launches, "tally_lm": row}


SERVES = (("gemma3_1b", 2048, 64, 2112),      # (arch, prompt, decode
          ("xlstm_350m", 1024, 64, 1088),    # steps, max_len)
          ("whisper_base", 4, 64, 448))      # whisper's text context
SERVE_B, SERVE_P = 8, 2          # requests; edges of the flat master
SERVE_CHECK_PROMPT = 1100        # the decode-consistency checks' prompt
# its limits on the largest logit difference, of the largest |logit|:
# float32 views, the JAX package's own (tests/test_arch_smoke.py);
# bfloat16, set from sound runs on the card (PERF.md section 6)
SERVE_CHECK_TOL = {"float32 views": 2e-2, "bfloat16": 2.0 ** -5}
GEMMA_1B_PARAMS = 802_384_128
HYB_FULL_PARAMS = 2_422_359_200    # zamba2-2.7b, 54 layers (the JAX tree's)
SERVE_PARAMS = {"gemma3_1b": GEMMA_1B_PARAMS,
                "zamba2_2p7b": HYB_FULL_PARAMS}


def serve_reckon(cfg, n: int, n_pad: int, cache_bytes: int,
                 prompt: int) -> dict:
    """The serving run's peak above what was held before the flat master
    was made, reckoned from the code (GB): the float32 [P, n_pad] master,
    the bfloat16 weights cast from its edge 0, the caches three times (a
    step's input stacks, its new per-layer slices and their restack),
    and the prefill's largest temporary, two float32 copies of the
    attention scores alive at a time in ``attention._attend`` (gemma's
    [b, h, Q_CHUNK, keys] a query chunk, whisper's encoder [b, h, f, f]),
    four of the mLSTM's [b, H, t, t] decay matrices, or three of the SSD
    scan's float32 [b, nc, H, c, c] chunk matrices (``rel``, its
    ``exp`` and the masked ``gamma``; then the scores)."""
    from repro_torch.models.attention import Q_CHUNK

    b = SERVE_B
    if cfg.family == "ssm":
        temp = 4 * 4 * b * cfg.n_heads * prompt ** 2
    elif cfg.family == "hybrid":
        temp = 3 * 4 * b * ssd_entries(cfg, prompt)
    elif cfg.encoder_layers:
        temp = 2 * 4 * b * cfg.n_heads * cfg.encoder_frames ** 2
    else:
        q = Q_CHUNK if prompt > Q_CHUNK and prompt % Q_CHUNK == 0 else prompt
        temp = 2 * 4 * b * cfg.n_heads * q * prompt
    terms = {"master": SERVE_P * n_pad * 4, "bf16_weights": 2 * n,
             "caches": 3 * cache_bytes, "prefill_temporary": temp}
    return {"peak_gb": sum(terms.values()) / 1e9,
            **{f"{k}_gb": v / 1e9 for k, v in terms.items()}}


def serve_run(torch, built, params, batch, max_len: int, steps: int,
              snapshot_at: int | None = None) -> dict:
    """Prefill ``batch`` then ``steps`` greedy decode steps, timed on the
    host clock between synchronisations: the generated tokens [b,
    steps], whether every logit was finite, the prefill and decode ms,
    the cache's bytes and, at ``snapshot_at``, the step's (cache,
    token) for a profiled rerun."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = built.prefill(params, batch, max_len)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    cache_bytes = sum(a.numel() * a.element_size()
                      for _, a in pytree_items(cache["stacks"]))
    finite = torch.isfinite(logits).all()
    tok = torch.argmax(logits[:, -1:], dim=-1)
    out, snap = [], None
    for i in range(steps):
        if i == snapshot_at:
            snap = (cache, tok)
        logits, cache = built.decode_step(params, cache, tok)
        finite &= torch.isfinite(logits).all()
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out.append(tok)
    tokens = torch.cat(out, dim=1)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    return {"tokens": tokens, "finite": bool(finite),
            "prefill_ms": (t1 - t0) * 1e3,
            "decode_ms_per_step": (t2 - t1) * 1e3 / steps,
            "cache_bytes": cache_bytes, "snapshot": snap}


def serve_profile(torch, built, params, cache, tok) -> dict:
    """One decode step under torch.profiler: its launches (device
    kernels and copies; the host-to-device copies apart), the device's
    busy ms, the step's host-clock ms and the five device ops that took
    the most."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile_step import device_us, on_device
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        built.decode_step(params, cache, tok)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    evs = [e for e in prof.key_averages() if on_device(e)]
    busy = sum(map(device_us, evs)) / 1e3
    evs.sort(key=device_us, reverse=True)
    return {"launches": sum(e.count for e in evs),
            "htod_copies": sum(e.count for e in evs if "HtoD" in e.key),
            "busy_ms": busy, "wall_ms": wall, "busy_share": busy / wall,
            "top": [{"name": e.key[:160], "calls": e.count,
                     "device_ms": device_us(e) / 1e3} for e in evs[:5]]}


def serve_consistency(torch, built, params, cfg, dtype: str) -> dict:
    """A served model on ``params`` (its float32 views, or the bfloat16
    weights the timed runs serve): decode step 1 after a
    SERVE_CHECK_PROMPT-token prefill against the last position of a
    prefill one token longer (gemma's window layers roll their caches,
    every slot valid, the global ones write at offsets; zamba2's decode
    takes the float32 recurrence from the state the chunked scan left,
    where the longer prefill runs the scan again).  The greedy token of
    every request must agree and the largest logit difference stay
    within SERVE_CHECK_TOL[dtype] of the largest |logit|; the smallest
    gap between the longer prefill's two best logits is reported
    beside them."""
    from repro_torch.data import synthetic

    t = SERVE_CHECK_PROMPT
    toks = synthetic.serve_request_batch(
        synthetic.LMStreamCfg(vocab=cfg.vocab, seq_len=t + 1,
                              batch_per_device=SERVE_B, pods=1,
                              devices_per_pod=1),
        SERVE_B, t + 1, seed=18)["tokens"].cuda()
    _, cache = built.prefill(params, {"tokens": toks[:, :t]}, t + 8)
    dec, _ = built.decode_step(params, cache, toks[:, t:])
    full, _ = built.prefill(params, {"tokens": toks}, t + 8)
    dec, full = dec[:, -1].float(), full[:, -1].float()
    del cache
    top2 = torch.topk(full, 2, dim=-1).values
    out = {"dtype": dtype, "prompt": t,
           "greedy_tokens_agree": torch.equal(dec.argmax(-1),
                                              full.argmax(-1)),
           "max_abs_logit_diff": float((dec - full).abs().max()),
           "max_abs_logit": float(full.abs().max()),
           "min_top2_gap": float((top2[:, 0] - top2[:, 1]).min())}
    out["limit"] = SERVE_CHECK_TOL[dtype] * out["max_abs_logit"]
    require(out["greedy_tokens_agree"], f"{cfg.name} {dtype}: decode step "
            f"1 and the longer prefill disagree on a greedy token: {out}")
    require(out["max_abs_logit_diff"] <= out["limit"],
            f"{cfg.name} {dtype}: decode step 1 and the longer prefill "
            f"differ beyond the limit: {out}")
    return out


def kernel_counters() -> tuple:
    """The four kernels' wrappers, whose ``launches`` count their
    launches."""
    from repro_torch.kernels.sign_pack import sign_pack
    from repro_torch.kernels.tally_acc import tally_acc
    from repro_torch.kernels.ternary_quant import ternary_quant
    from repro_torch.kernels.vote_update import vote_update

    return sign_pack, vote_update, tally_acc, ternary_quant


def serve_arch(torch, card: str, arch: str, prompt: int, steps: int,
               max_len: int, checks: tuple = ()) -> None:
    """One arch of the ``serve`` phase, whole, random weights from seed 0:
    put into a [SERVE_P, n_pad] float32 FlatState (both edges equal, as
    after the cloud mean) and served as bfloat16 from edge 0
    (``specs.serve_params_from_flat``); SERVE_B requests of
    ``serve_request_batch``, prefill, ``steps`` greedy decode steps,
    twice (the tokens must be the same, every logit finite), one decode
    step profiled; the float32 views share the buffer's storage; the
    decode-consistency ``checks`` ("float32 views", "bfloat16") of
    :func:`serve_consistency`.  zamba2's run line carries its cache's
    reckoning beside the bytes."""
    from repro_torch import configs
    from repro_torch.core import flatbuf, pytree
    from repro_torch.core.topology import Topology
    from repro_torch.data import synthetic
    from repro_torch.launch import specs
    from repro_torch.models import build

    tag = f"[serve] {arch}"
    cfg = configs.get_config(arch)
    topo = Topology(1, 1, "cuda")
    built = build.build_model(cfg, topo)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    tree = built.init_params(torch.Generator(device="cuda").manual_seed(0))
    n = build.param_count(tree)
    if arch in SERVE_PARAMS:
        require(n == SERVE_PARAMS[arch], f"{arch} has {n} parameters")
    fs = flatbuf.from_tree(pytree.tree_map(
        lambda v: v.unsqueeze(0).expand((SERVE_P,) + tuple(v.shape)),
        tree), batch_dims=1)
    views = specs.serve_params_from_flat(built, fs)
    ptr = fs.buf.untyped_storage().data_ptr()
    leaves = pytree.tree_flatten(views)[0]
    require(all(v.untyped_storage().data_ptr() == ptr for v in leaves),
            f"{arch}: a float32 view does not share the buffer")
    require(all(torch.equal(v, w) for v, w in zip(
        leaves, pytree.tree_flatten(tree)[0])),
        f"{arch}: a view differs from its leaf")
    del tree, leaves
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    params = specs.serve_params_from_flat(built, fs,
                                          dtype=torch.bfloat16)
    batch = synthetic.serve_request_batch(
        synthetic.LMStreamCfg(vocab=cfg.vocab, seq_len=prompt,
                              batch_per_device=SERVE_B, pods=1,
                              devices_per_pod=1,
                              frames=cfg.encoder_frames
                              if cfg.encoder_layers else 0,
                              frontend_dim=cfg.frontend_dim),
        SERVE_B, prompt)
    batch = {k: v.cuda() for k, v in batch.items()}
    first = serve_run(torch, built, params, batch, max_len, steps)
    second = serve_run(torch, built, params, batch, max_len, steps,
                       snapshot_at=steps // 2)
    require(first["finite"] and second["finite"],
            f"{arch}: a logit is not finite")
    require(torch.equal(first["tokens"], second["tokens"]),
            f"{arch}: the generated tokens differ between two runs")
    prof = serve_profile(torch, built, params, *second.pop("snapshot"))
    peak = (torch.cuda.max_memory_allocated() - base) / 1e9
    served = {"float32 views": views, "bfloat16": params}
    done = [serve_consistency(torch, built, served[dtype], cfg, dtype)
            for dtype in checks]
    print(f"{tag}: tokens of request 0: "
          f"{second['tokens'][0, :16].tolist()}", flush=True)
    run = {"serve": "run", "arch": cfg.name, "card": card,
           "parameters": n, "n_pad": fs.layout.n_pad,
           "requests": SERVE_B, "prompt": prompt, "decode_steps": steps,
           "max_len": max_len, "dtype": "bfloat16",
           "prefill_ms": [first["prefill_ms"], second["prefill_ms"]],
           "decode_ms_per_step": [first["decode_ms_per_step"],
                                  second["decode_ms_per_step"]],
           "decode_tokens_per_s": SERVE_B * 1e3
           / second["decode_ms_per_step"],
           "cache_bytes": second["cache_bytes"],
           "tokens_identical_in_two_runs": True, "logits_finite": True,
           "float32_views_zero_copy": True}
    if cfg.family == "hybrid":
        run["cache_reckoned"] = hybrid_cache_reckon(cfg, SERVE_B, max_len)
        require(run["cache_reckoned"]["bytes"] == second["cache_bytes"],
                f"{arch}: the cache holds {second['cache_bytes']} bytes, "
                f"reckoned {run['cache_reckoned']}")
    emit(run)
    emit({"serve": "decode step", "arch": cfg.name, "card": card,
          **prof})
    emit({"serve": "memory", "arch": cfg.name, "card": card,
          "peak_rise_gb": peak,
          "reckoned": serve_reckon(cfg, n, fs.layout.n_pad,
                                   second["cache_bytes"], prompt)})
    for check in done:
        emit({"serve": "decode consistency", "arch": cfg.name,
              "card": card, **check})
    del fs, views, params, batch, first, second, served
    torch.cuda.empty_cache()


def phase_serve(torch, card: str) -> dict:
    """Serving on the card (see the module docstring): gemma3-1b,
    xlstm-350m and whisper-base whole, random weights from seed 0, put
    into a [2, n_pad] float32 FlatState (both edges equal, as after the
    cloud mean) and served as bfloat16 from edge 0
    (``specs.serve_params_from_flat``): 8 requests of
    ``serve_request_batch``, prefill, greedy decode, twice (the tokens
    must be the same, every logit finite), one decode step profiled;
    the float32 views share the buffer's storage; gemma's decode
    consistency on the float32 views and on the bfloat16 weights.  The
    four kernels' counters are set to 0 just before and read just after:
    serving launches none of them."""
    t_phase = time.perf_counter()
    counters = kernel_counters()
    for fn in counters:
        fn.launches = 0
    for arch, prompt, steps, max_len in SERVES:
        serve_arch(torch, card, arch, prompt, steps, max_len,
                   checks=("float32 views", "bfloat16")
                   if arch == "gemma3_1b" else ())
    launches = {fn.__name__: fn.launches for fn in counters}
    require(not any(launches.values()),
            f"serving launched a training kernel: {launches}")
    emit({"serve": "phase", "card": card, "launches": launches,
          "wall_s": time.perf_counter() - t_phase})
    return launches


FSDP_ARCH, FSDP_LAYERS = "gemma3_12b", 6    # one 5:1 local:global period
FSDP_P, FSDP_D, FSDP_SEQ, FSDP_STEPS = 2, 2, 512, 6
FSDP_CHECK_STEPS = 3           # gemma3-1b FSDP vs replicated: prologue + 2
FSDP_PROFILED_STEP = 4         # a local step of round 2
FSDP_STRAGGLER = ((True, False), (True, True))


def reckon_fsdp_peak(arch, abstract, batch: int, seq: int) -> dict:
    """The FSDP regime's peak device memory (GB), reckoned before any run
    from the tree's leaves (``abstract``, one replica's shapes) and the
    run's shapes, at p x d = FSDP_P x FSDP_D copies (the ``fsdp`` and
    ``moe`` phases' main paths), bf16 compute, f32 master, the lift's
    copies materialised.  n is the tree's size, t the embedding table's,
    h the head's lifted leaf (the table when it is tied, else
    ``head.out``), m the MTP subtree's:

      state     8pn: the f32 master, bf16 delta and delta_next [P]
                (updated in place: the cloud mean and the descent write
                the master, the fresh anchor the delta it replaces; no
                second copy);
      cot       2pd t: the table's bf16 [P, D] cotangent;
      lifted    2pd (h + m): the head's (and MTP's) bf16 [P, D] copies,
                alive until their backward;
      logits    18 bytes a logit (``reckon_peak``'s rule), around the
                head only, twice with MTP (its logits too);
      u         2pd t: g + rho*delta in bf16 before ``sign_pack``;
      vote      p t int8, then the f32 direction 4p t;
      mean      4p t: the anchor pass's f32 fold (``wmean``; its cast
                and products go by coordinate chunks);
      layer     the largest of the layers' backwards, in backward
                order: the directions of the leaves voted before it, its
                leaves' bf16 [P, D] copies (recomputed under remat), its
                largest leaf L's cotangent 2pd L and then the larger of
                u (2pd L) and vote + direction (5p L), and the table's
                first cotangent 2pd t waiting where the table is read
                twice (tied, or MTP's rolled tokens).

    Phases: the head's backward (lifted + logits + the head's cotangent
    2pd h); each layer's; the embedding's backward, where a table read
    twice has its two cotangents and their sum alive (3 cot, else one);
    the table's vote (cot + max(u, vote + direction)); the anchor's fold
    (cot + mean).  Each direction goes into its master as soon as
    autograd has it (``hier.pod_direction_fsdp``), a stack's once its
    last layer has voted, so by the table's backward every other
    direction has been applied.
    peak = state + max(head, layer, max(k cot, cot + u, cot + vote +
    4pt, cot + mean)), k = 3 or 1."""
    cfg, p, d = arch.cfg, FSDP_P, FSDP_D
    n = sum(math.prod(a.shape) for _, a in pytree_items(abstract))
    t = math.prod(abstract["embed"]["table"].shape)
    h = t if cfg.tie_embed else math.prod(abstract["head"]["out"].shape)
    m = sum(math.prod(a.shape) for _, a in pytree_items(
        abstract.get("mtp", {})))
    reused = cfg.tie_embed or arch.mtp_block is not None
    logit_sets = 2 if arch.mtp_block is not None else 1
    tt = {"state": 8 * p * n, "cot": 2 * p * d * t, "lifted": 2 * p * d * (h + m),
          "logits": 18 * p * d * batch * seq * cfg.vocab * logit_sets,
          "u": 2 * p * d * t, "vote": p * t, "direction": 4 * p * t,
          "mean": 4 * p * t}
    # the layers in backward order, each as its leaves' numels
    order = [name for seg in arch.segments for _ in range(seg.repeats)
             for name, cnt in seg.layout for _ in range(cnt)]
    per_layer = {name: [math.prod(a.shape[1:]) for _, a in
                        pytree_items(abstract["stacks"][name])]
                 for name in abstract["stacks"]}
    done = sum(math.prod(a.shape) for _, a in pytree_items(abstract["head"]))
    done += m if arch.mtp_block is not None else 0
    layer = 0
    for name in reversed(order):
        leaves = per_layer[name]
        big = max(leaves)
        layer = max(layer, 4 * p * done + 2 * p * d * sum(leaves)
                    + 2 * p * d * big + max(2 * p * d * big, 5 * p * big)
                    + (tt["cot"] if reused else 0))
        done += sum(leaves)
    tt["layer"] = layer
    head = tt["lifted"] + tt["logits"] + 2 * p * d * h
    tail = max((3 if reused else 1) * tt["cot"], tt["cot"] + tt["u"],
               tt["cot"] + tt["vote"] + tt["direction"],
               tt["cot"] + tt["mean"])
    peak = tt["state"] + max(head, layer, tail)
    return {"peak_gb": peak / 1e9,
            **{f"{k}_gb": v / 1e9 for k, v in tt.items()}}


def padded(numel: int) -> int:
    """A leaf's numel padded as the lift's vote pads its rows."""
    from repro_torch.core.votes import LEAF_PAD
    return -(-numel // LEAF_PAD) * LEAF_PAD


def gemma_route_shapes(torch) -> list:
    """(name, shape) of every leaf of a gemma3-12b layer and of its tied
    table: the longest rows the FSDP phase's main path gives the lift's
    vote."""
    from repro_torch import configs
    from repro_torch.core.topology import Topology
    from repro_torch.models import build

    cfg = dataclasses.replace(configs.get_config(FSDP_ARCH), n_layers=6)
    abstract = build.build_model(cfg,
                                 Topology(1, 1, "cuda")).abstract_params()
    shapes = sorted((name.split(".", 2)[-1], tuple(leaf.shape[1:]))
                    for name, leaf in pytree_items(abstract)
                    if name.startswith("stacks.local."))
    shapes.append(("embed.table", tuple(abstract["embed"]["table"].shape)))
    return shapes


def moe_route_shapes(abstracts: dict) -> list:
    """(name, shape) of every distinct leaf shape, one layer's for the
    stacked leaves, of the trees in ``abstracts`` (name -> abstract
    parameters): the moe phase's expert stacks, router, MLA, MTP and
    untied tables."""
    seen, shapes = set(), []
    for arch, abstract in abstracts.items():
        for name, leaf in pytree_items(abstract):
            shape = tuple(leaf.shape[1:] if name.startswith("stacks.")
                          else leaf.shape)
            if shape not in seen:
                seen.add(shape)
                shapes.append((f"{arch}:{name}", shape))
    return shapes


def fsdp_kernel_route(torch, shapes: list, tag: str) -> dict:
    """The lift's ``fused`` vote on the kernels (``votes.fused_sign_vote_
    leaf``) against its plain version, ``majority_vote_dev(sgn(u +
    rho*delta))`` on ``ag_packed``, on random f32 and bf16 [FSDP_P,
    FSDP_D] cotangents of every (name, shape) of ``shapes`` (bf16 on the
    main path; f32 folds the correction in the kernel), a bf16
    correction at rho 0.2 and a straggler mask: bitwise.  These launches
    are comparisons, not the main path's; the JSON line is ``{tag:
    "kernel route"}``."""
    from repro_torch.core import signs, votes

    gen = torch.Generator(device="cuda").manual_seed(7)
    mask = torch.tensor(FSDP_STRAGGLER, device="cuda")
    rows, worst = [], 0.0
    t0, before = time.perf_counter(), torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for name, shape in shapes:
        for dt in (torch.float32, torch.bfloat16):
            g = torch.randn((FSDP_P, FSDP_D) + shape, generator=gen,
                            device="cuda").to(dt)
            g.view(-1)[::17] = 0.0
            delta = torch.randn((FSDP_P,) + shape, generator=gen,
                                device="cuda").mul_(2).to(torch.bfloat16)
            got = votes.fused_sign_vote_leaf(g, delta, RHO, mask)
            want = votes.majority_vote_dev(
                signs.sgn(votes.corrected_leaf(g, delta, RHO)), mask,
                "ag_packed")
            del g, delta
            err = float((got.to(torch.int16) - want).abs().max())
            differ = int((got != want).sum())
            require(differ == 0, f"fsdp lift vote {name} {dt}: {differ} "
                    f"coordinates differ from the plain version")
            worst = max(worst, err)
            rows.append({"leaf": name, "shape": list(shape),
                         "dtype": str(dt).split(".")[-1],
                         "padded_to": padded(math.prod(shape)),
                         "max_abs_err": err})
            del got, want
            torch.cuda.empty_cache()
    emit({tag: "kernel route", "leaves": rows, "max_abs_err": worst,
          "bitwise": True, "wall_s": time.perf_counter() - t0,
          "peak_rise_gb": (torch.cuda.max_memory_allocated() - before)
          / 1e9})
    return {"max_abs_err": worst}


def lift_rows(abstract) -> list:
    """The [P, D, numel] rows of the lifts a step's pass makes, numel
    padded to votes.LEAF_PAD: every stacked leaf once a layer, every
    other leaf once (one sign_pack and one vote_update each)."""
    rows = []
    for name, leaf in pytree_items(abstract):
        stacked = name.startswith("stacks.")
        numel = math.prod(leaf.shape[1:] if stacked else leaf.shape)
        rows += [(FSDP_P, FSDP_D, padded(numel))] * (
            leaf.shape[0] if stacked else 1)
    return rows


def lift_bounds(rows: list) -> tuple[float, float]:
    """``sign_pack``'s and ``vote_update``'s bounds (ms, by bytes) summed
    over a pass's lift rows: bf16 cotangents, the vote-only form."""
    return (sum(bound(sign_pack_bytes(r, 2, False),
                      sign_pack_ops(r, False))[0] for r in rows),
            sum(bound(vote_update_bytes(r, False, FSDP_P * FSDP_D),
                      vote_update_ops(r, False))[0] for r in rows))


def phase_fsdp(torch, card: str) -> dict:
    """The FSDP regime on the card (``core.device_axis``: each layer
    lifted to its [P, D] copies inside its forward, the lift's backward
    voting per leaf on ``sign_pack`` + ``vote_update``):

      1. the lift's fused vote against its plain version, bitwise
         (:func:`fsdp_kernel_route`);
      2. gemma3-1b at the lm phase's shape (6 layers, P=2 x D=3, 1 x
         1152 tokens) with ``param_mode="fsdp"``, 3 steps on fused/tree,
         against the replicated regime's ag_packed/tree run: bitwise
         (the same eager ops), the differing count printed;
      3. gemma3-12b at full width cut to 6 layers (1,979,895,360
         parameters), P=2 x D=2, 1 x 512 tokens a device, DC, mu 1e-3,
         rho 0.2, T_E=3, bf16 compute, f32 master, bf16 delta, fused,
         tree, 6 steps of ``run_training``, a local step of round 2
         profiled: round 2's mean loss below step 0's, one sign_pack and
         one vote_update a leaf and layer a step, the peak beside
         :func:`reckon_fsdp_peak` and the replicated regime's
         ``reckon_peak`` at the same shapes.

    Returns the kernels' launches on the main path (step 3)."""
    from repro_torch import configs
    from repro_torch.launch.train import RunCfg
    from repro_torch.models import build

    t_phase = time.perf_counter()
    route = fsdp_kernel_route(torch, gemma_route_shapes(torch), "fsdp")

    # 2. gemma3-1b: FSDP against replicated
    cfg1, topo1, algo1 = lm_setup(torch, state_layout="tree")
    cfg1f = dataclasses.replace(cfg1, param_mode="fsdp")
    run1 = RunCfg(steps=FSDP_CHECK_STEPS, batch_per_device=1, seq_len=LM_SEQ,
                  log_every=1, seed=0)
    built1 = build.build_model(cfg1, topo1)
    params1 = built1.init_params(torch.Generator(device="cuda").manual_seed(0))
    leaves1 = len(pytree_items(params1)) + sum(
        leaf.shape[0] - 1 for name, leaf in pytree_items(params1)
        if name.startswith("stacks."))
    fs1 = lm_train(torch, "[fsdp] gemma3-1b fsdp fused/tree", cfg1f, topo1,
                   algo1, run1, params1)
    want1 = {"sign_pack": FSDP_CHECK_STEPS * leaves1,
             "vote_update": FSDP_CHECK_STEPS * leaves1, "ternary_quant": 0}
    require(fs1["launches"] == want1, f"gemma3-1b fsdp launches "
            f"{fs1['launches']}, want {want1}")
    rp1 = lm_train(torch, "[fsdp] gemma3-1b replicated ag_packed/tree",
                   cfg1, topo1, dataclasses.replace(algo1,
                                                    transport="ag_packed"),
                   run1, params1)
    differ = count_differing(torch, fs1["params"], rp1["params"])
    total = sum(leaf.numel() for _, leaf in pytree_items(fs1["params"]))
    max_diff = max(float((a - b).abs().max()) for (_, a), (_, b) in zip(
        pytree_items(fs1["params"]), pytree_items(rp1["params"])))
    emit({"fsdp": "gemma3-1b vs replicated", "arch": cfg1.name,
          "steps": FSDP_CHECK_STEPS, "coordinates": total,
          "differing": differ, "max_abs_diff": max_diff,
          "bitwise": differ == 0,
          "launches": fs1["launches"], "leaf_layers_a_step": leaves1,
          "losses_fsdp": [h["loss"] for h in fs1["history"]],
          "losses_replicated": [h["loss"] for h in rp1["history"]],
          "peak_gb_fsdp": fs1["peak_gb"],
          "peak_gb_replicated_tree": rp1["peak_gb"]})
    require(differ == 0, f"gemma3-1b fsdp vs replicated: {differ} of "
            f"{total} coordinates differ, by at most {max_diff}")
    del fs1, rp1, params1, built1
    torch.cuda.empty_cache()

    # 3. gemma3-12b at full width through run_training (the main path)
    cfg = dataclasses.replace(configs.get_config(FSDP_ARCH),
                              n_layers=FSDP_LAYERS)
    from repro_torch.core import hier
    from repro_torch.core.topology import Topology
    topo = Topology(FSDP_P, FSDP_D, "cuda")
    algo = hier.AlgoConfig(method="dc_hier_signsgd", mu=1e-3, rho=RHO,
                           t_e=LM_TE, transport="fused", state_layout="tree",
                           compute_dtype=torch.bfloat16,
                           master_dtype=torch.float32,
                           delta_dtype=torch.bfloat16)
    abstract = build.build_model(cfg, topo).abstract_params()
    n = build.param_count(abstract)
    n_table = abstract["embed"]["table"].numel()
    rows = lift_rows(abstract)
    leaves = len(rows)
    sp_bound, vu_bound = lift_bounds(rows)
    reckoned = reckon_fsdp_peak(build.make_archdef(cfg), abstract, 1,
                                FSDP_SEQ)
    replicated = reckon_peak(cfg, n, 1, FSDP_SEQ, p=FSDP_P, d=FSDP_D)
    emit({"fsdp": "parameters", "arch": cfg.name, "n_layers": cfg.n_layers,
          "count": n, "table": n_table, "leaf_layers_a_step": leaves,
          "pods": FSDP_P, "devices_per_pod": FSDP_D, "seq": FSDP_SEQ,
          "reckoned": reckoned, "replicated_reckoned": replicated})
    run = RunCfg(steps=FSDP_STEPS, batch_per_device=1, seq_len=FSDP_SEQ,
                 log_every=1, seed=0)
    res = lm_train(torch, "[fsdp] gemma3-12b fused/tree", cfg, topo, algo,
                   run, None, profile=FSDP_PROFILED_STEP)
    want = {"sign_pack": FSDP_STEPS * leaves,
            "vote_update": FSDP_STEPS * leaves, "ternary_quant": 0}
    require(res["launches"] == want, f"gemma3-12b fsdp launches "
            f"{res['launches']}, want {want}")
    losses = [h["loss"] for h in res["history"]]
    round2 = statistics.mean(losses[LM_TE:2 * LM_TE])
    require(round2 < losses[0], f"gemma3-12b: the loss did not fall: step "
            f"0 {losses[0]}, round 2 mean {round2}")
    prof = res["prof"]
    sp_ms, sp_n = prof["sign_pack_kernel"]
    vu_ms, vu_n = prof["vote_update_kernel"]
    require((sp_n, vu_n) == (leaves, leaves), f"the profiled local step "
            f"launched {sp_n} sign_pack and {vu_n} vote_update, want "
            f"{leaves} each")
    host = [h["ms"] for h in res["history"]]
    emit({"fsdp": "step", "arch": cfg.name, "card": card,
          "ms_per_step": host,
          "ms_per_local_step_round2": statistics.mean(
              host[LM_TE + 1:FSDP_PROFILED_STEP] + host[
                  FSDP_PROFILED_STEP + 1:]),
          "ms_prologue_step_round2": host[LM_TE],
          "ms_profiled_step": host[FSDP_PROFILED_STEP],
          "data_ms_per_step": statistics.mean(
              h["data_ms"] for h in res["history"]),
          "losses": losses, "round2_mean_loss": round2,
          "launches": res["launches"]})
    emit({"fsdp": "profiled local step", "arch": cfg.name, "card": card,
          "sign_pack_launches": sp_n, "sign_pack_device_ms": sp_ms,
          "sign_pack_bound_ms": sp_bound,
          "vote_update_launches": vu_n, "vote_update_device_ms": vu_ms,
          "vote_update_bound_ms": vu_bound, "bound_by": "bytes",
          "device_busy_ms": prof["busy_ms"],
          "device_busy_share": prof["busy_ms"] / host[FSDP_PROFILED_STEP],
          "kernels_share_of_device_time":
              (sp_ms + vu_ms) / max(prof["busy_ms"], 1e-9),
          "top": prof["top"]})
    emit({"fsdp": "memory", "arch": cfg.name, "card": card,
          "peak_gb": res["peak_gb"], "reckoned_gb": reckoned["peak_gb"],
          "replicated_reckoned_gb": replicated["peak_gb"],
          "total_gb": torch.cuda.get_device_properties(0).total_memory / 1e9})
    launches = dict(res["launches"])
    del res
    torch.cuda.empty_cache()
    emit({"fsdp": "phase", "card": card, "route_max_abs_err":
          route["max_abs_err"], "wall_s": time.perf_counter() - t_phase})
    return launches


MOE_P, MOE_D, MOE_SEQ, MOE_STEPS = 2, 2, 512, 6
MOE_CHECK_D = 1                  # the replicated regime at D=2 holds
                                 # more than the card for 1.5e9 params
MOE_MU = 1e-5                    # the largest of MU_SWEEP at which
                                 # all three configs' losses fall
MOE_PROFILED_STEP = 4            # a local step of round 2
MU_SWEEP = (1e-3, 1e-4, 3e-5, 1e-5)    # --mu-sweep
ORACLE_TOL = 1e-5                # of the largest |y|, float32
MLA_DECODE_TOL = 2.0 ** -6       # of the largest |y|: bf16 latent cache
MOE_SERVE_B, MOE_SERVE_PROMPT, MOE_SERVE_STEPS = 8, 512, 32


def moe_cells() -> dict:
    """The phase's configs, every width as published, FSDP: deepseek-v3
    cut to 2 layers (1 leading dense of 3, 1 MoE of 58), 16 routed
    experts of 256 and the vocabulary's eighth (16160 of 129280), MTP
    on; arctic to 2 layers of 35 and 8 experts of 128; internvl2 to 2 layers
    of 80 and 16032 of 128256 words; and the FSDP-vs-replicated check's
    deepseek-v3: 1 MoE layer, no leading dense one, 8 experts."""
    from repro_torch import configs

    def cut(name, moe=None, **kw):
        cfg = configs.get_config(name)
        if moe:
            kw["moe"] = dataclasses.replace(cfg.moe, **moe)
        return dataclasses.replace(cfg, param_mode="fsdp", **kw)

    return {
        "deepseek-v3": cut("deepseek_v3_671b", n_layers=2, vocab=16160,
                           moe={"n_experts": 16, "first_dense": 1}),
        "arctic": cut("arctic_480b", n_layers=2, moe={"n_experts": 8}),
        "internvl2": cut("internvl2_76b", n_layers=2, vocab=16032),
        "check": cut("deepseek_v3_671b", n_layers=1, vocab=16160,
                     moe={"n_experts": 8, "first_dense": 0}),
    }


def moe_layer_check(torch, cfg, tag: str) -> dict:
    """One MoE layer of ``cfg`` at its full shapes on [P, D] = [2, 2]
    replicas, each with its own float32 parameters and 1 x 512 tokens:
    both dispatch forms against :func:`moe_oracle` within ORACLE_TOL of
    the largest |y| (and against each other); then in bf16, the forward
    and the gradients of x and every leaf twice, bitwise; the layer's
    forward ms by CUDA events."""
    from repro_torch.core import pytree
    from repro_torch.models import moe

    gen = torch.Generator(device="cuda").manual_seed(11)
    reps = [moe.init_moe(gen, cfg, "cuda") for _ in range(MOE_P * MOE_D)]
    p = pytree.tree_map(lambda *xs: torch.stack(xs).reshape(
        (MOE_P, MOE_D) + tuple(xs[0].shape)), *reps)
    del reps
    x = torch.randn((MOE_P, MOE_D, 1, MOE_SEQ, cfg.d_model), generator=gen,
                    device="cuda")
    t0 = time.perf_counter()
    want = moe_oracle(torch, p, x, cfg)
    torch.cuda.synchronize()
    oracle_s = time.perf_counter() - t0
    scale = float(want.abs().max())
    out, ys = {"layer": tag, "experts": cfg.moe.n_experts,
               "top_k": cfg.moe.top_k, "d_expert": cfg.moe.d_expert,
               "capacity": moe.capacity(MOE_SEQ, cfg.moe),
               "max_abs_y": scale, "oracle_s": oracle_s}, {}
    for dispatch in ("einsum", "gather"):
        dcfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=dispatch))
        with torch.no_grad():
            y, aux = moe.moe_block(p, x, dcfg)
            err = float((y - want).abs().max())
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(3):
                moe.moe_block(p, x, dcfg)
            end.record()
            end.synchronize()
        out[dispatch] = {"max_abs_err": err, "limit": ORACLE_TOL * scale,
                         "f32_ms": start.elapsed_time(end) / 3,
                         "aux": aux.float().tolist()}
        require(err <= ORACLE_TOL * scale, f"moe {tag} {dispatch}: "
                f"{err} from the loop oracle, past {ORACLE_TOL} of "
                f"{scale}")
        ys[dispatch] = y
    out["dispatches_bitwise"] = torch.equal(ys["einsum"], ys["gather"])
    del ys, want
    pb = pytree.tree_map(lambda a: a.to(torch.bfloat16), p)
    del p
    ct = torch.randn(x.shape, generator=gen, device="cuda").to(
        torch.bfloat16)
    for dispatch in ("einsum", "gather"):
        dcfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch=dispatch))
        runs = []
        for _ in range(2):
            leaves, td = pytree.tree_flatten(pb)
            leaves = [a.detach().requires_grad_(True) for a in leaves]
            xb = x.to(torch.bfloat16).requires_grad_(True)
            y, aux = moe.moe_block(pytree.tree_unflatten(td, leaves), xb,
                                   dcfg)
            g = torch.autograd.grad((y * ct).float().sum() + aux.sum(),
                                    [xb] + leaves)
            runs.append([y.detach()] + [a.detach() for a in g])
            del y, aux, g, leaves, xb
        differ = sum(int((a != b).sum()) for a, b in zip(*runs))
        out[dispatch]["bf16_rerun_differing"] = differ
        require(differ == 0, f"moe {tag} {dispatch}: two bf16 forwards "
                f"and backwards differ in {differ} coordinates")
        del runs
    del pb, x, ct
    torch.cuda.empty_cache()
    emit({"moe": "layer vs oracle", **out})
    return out


def mla_decode_check(torch, cfg, attn_p) -> dict:
    """The MLA layer alone, float32 weights (``attn_p``: one layer's), 8
    rows: a prefill of 512 positions into the bfloat16 latent cache, then
    the absorbed decode of position 512, against the train form's last
    position over all 513: within MLA_DECODE_TOL of the largest |y| (the
    decode reads the latents rounded to bfloat16)."""
    from repro_torch.models import attention, build

    gen = torch.Generator(device="cuda").manual_seed(13)
    t = MOE_SERVE_PROMPT
    x = torch.randn((MOE_SERVE_B, t + 1, cfg.d_model), generator=gen,
                    device="cuda")
    pos = torch.arange(t + 1, device="cuda")
    arch = build.make_archdef(cfg)
    cache = build.make_cache(arch, MOE_SERVE_B, t + 8, "cuda")
    layer0 = {k: v[0] for k, v in cache["stacks"]["dense"].items()}
    with torch.no_grad():
        _, c = attention.mla_attn(attn_p, x[:, :t], pos[:t], cfg,
                                  cache=layer0, prefill=True)
        dec, _ = attention.mla_attn(attn_p, x[:, t:], pos[t:], cfg,
                                    cache=c, pos=t)
        full = attention.mla_attn(attn_p, x, pos, cfg)[:, t:]
    scale = float(full.abs().max())
    err = float((dec - full).abs().max())
    out = {"rows": MOE_SERVE_B, "prompt": t, "max_abs_err": err,
           "max_abs_y": scale, "limit": MLA_DECODE_TOL * scale,
           "cache_dtype": str(c["ckv"].dtype).split(".")[-1]}
    require(err <= MLA_DECODE_TOL * scale, f"MLA absorbed decode vs the "
            f"train form: {out}")
    return out


def moe_serve(torch, card: str, name: str, cfg, masters) -> dict:
    """Serve ``cfg`` resident in bf16 from edge 0 of a run's [P, *leaf]
    masters: 8 requests of MOE_SERVE_PROMPT tokens (and a vlm's
    patches), MOE_SERVE_STEPS greedy steps, twice (the same tokens,
    every logit finite); internvl2's decode step against the one-longer
    prefill on the float32 views (the gemma check's 2e-2 and the same
    greedy tokens); deepseek-v3's MLA layer alone (:func:`mla_decode_
    check`)."""
    from repro_torch.core.topology import Topology
    from repro_torch.data import synthetic
    from repro_torch.launch import specs
    from repro_torch.models import build

    built = build.build_model(cfg, Topology(1, 1, "cuda"))
    require(built.serve_layout == "resident", f"{name}: serve layout "
            f"{built.serve_layout}")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = specs.serve_params_from_tree(masters, torch.bfloat16)
    scfg = synthetic.LMStreamCfg(
        vocab=cfg.vocab, seq_len=MOE_SERVE_PROMPT,
        batch_per_device=MOE_SERVE_B, pods=1, devices_per_pod=1,
        n_patches=cfg.n_patches, d_model=cfg.d_model)
    batch = {k: v.cuda() for k, v in synthetic.serve_request_batch(
        scfg, MOE_SERVE_B, MOE_SERVE_PROMPT + 1).items()}
    prompt = dict(batch, tokens=batch["tokens"][:, :MOE_SERVE_PROMPT])
    max_len = cfg.n_patches + MOE_SERVE_PROMPT + MOE_SERVE_STEPS + 8
    runs = [serve_run(torch, built, params, prompt, max_len,
                      MOE_SERVE_STEPS) for _ in range(2)]
    same = torch.equal(runs[0]["tokens"], runs[1]["tokens"])
    require(same and all(r["finite"] for r in runs), f"{name} serving: "
            f"same tokens {same}, finite {[r['finite'] for r in runs]}")
    out = {"serve": "run", "arch": cfg.name, "card": card,
           "requests": MOE_SERVE_B, "patches": cfg.n_patches,
           "prompt": MOE_SERVE_PROMPT, "decode_steps": MOE_SERVE_STEPS,
           "max_len": max_len, "same_tokens_twice": same,
           "prefill_ms": [r["prefill_ms"] for r in runs],
           "decode_ms_per_step": [r["decode_ms_per_step"] for r in runs],
           "tokens_per_s": [MOE_SERVE_B * 1e3 / r["decode_ms_per_step"]
                            for r in runs],
           "cache_bytes": runs[0]["cache_bytes"]}
    del runs, params
    if cfg.n_patches:                 # decode against the longer prefill
        views = specs.serve_params_from_tree(masters)
        with torch.no_grad():
            _, cache = built.prefill(views, prompt, max_len)
            dec, _ = built.decode_step(
                views, cache, batch["tokens"][:, MOE_SERVE_PROMPT:])
            del cache
            full, _ = built.prefill(views, batch, max_len)
        dec, full = dec[:, -1].float(), full[:, -1].float()
        top2 = torch.topk(full, 2, dim=-1).values
        check = {"dtype": "float32 views",
                 "greedy_tokens_agree": torch.equal(dec.argmax(-1),
                                                    full.argmax(-1)),
                 "max_abs_logit_diff": float((dec - full).abs().max()),
                 "max_abs_logit": float(full.abs().max()),
                 "min_top2_gap": float((top2[:, 0] - top2[:, 1]).min())}
        check["limit"] = SERVE_CHECK_TOL["float32 views"] * check[
            "max_abs_logit"]
        out["decode_consistency"] = check
        require(check["greedy_tokens_agree"] and check["max_abs_logit_diff"]
                <= check["limit"], f"{name}: decode against the longer "
                f"prefill: {check}")
        del views, dec, full
    if cfg.mla is not None:
        attn_p = {k: v[0, 0] for k, v in masters["stacks"]["dense"][
            "attn"].items()}
        out["mla_layer"] = mla_decode_check(torch, cfg, attn_p)
    torch.cuda.synchronize()
    out["peak_rise_gb"] = (torch.cuda.max_memory_allocated() - before) / 1e9
    emit(out)
    return out


def moe_algo(torch, mu: float):
    """The moe phase's algorithm: DC at ``mu``, rho 0.2, T_E=3, bf16
    compute and delta, f32 master, fused, tree."""
    from repro_torch.core import hier
    return hier.AlgoConfig(method="dc_hier_signsgd", mu=mu, rho=RHO,
                           t_e=LM_TE, transport="fused", state_layout="tree",
                           compute_dtype=torch.bfloat16,
                           master_dtype=torch.float32,
                           delta_dtype=torch.bfloat16)


def moe_mu_sweep(torch, card: str) -> None:
    """``python3 chip_smoke.py --mu-sweep``: the moe phase's three
    main-path configs (:func:`moe_cells`), 6 steps of ``run_training``
    each at every mu of MU_SWEEP, the phase's algorithm and data
    otherwise.  One JSON line ``{"moe": "mu sweep"}`` a run: its losses,
    round 2's mean beside step 0's.  It checks nothing: it reads which
    step sizes these cuts' random weights take."""
    from repro_torch.core.topology import Topology
    from repro_torch.launch.train import RunCfg

    cells = moe_cells()
    topo = Topology(MOE_P, MOE_D, "cuda")
    run = RunCfg(steps=MOE_STEPS, batch_per_device=1, seq_len=MOE_SEQ,
                 log_every=1, seed=0)
    for name in ("deepseek-v3", "arctic", "internvl2"):
        for mu in MU_SWEEP:
            res = lm_train(torch, f"[mu sweep] {name} mu {mu:g}",
                           cells[name], topo, moe_algo(torch, mu), run, None)
            losses = [h["loss"] for h in res["history"]]
            emit({"moe": "mu sweep", "arch": cells[name].name, "card": card,
                  "mu": mu, "losses": losses, "step0_loss": losses[0],
                  "round2_mean_loss": statistics.mean(
                      losses[LM_TE:2 * LM_TE])})
            del res
            torch.cuda.empty_cache()


def phase_moe(torch, card: str) -> dict:
    """The vlm and moe families on the card, FSDP, P=2 x D=2, 1 x 512
    tokens a device (internvl2: and 256 patches), DC, mu 1e-5 (MOE_MU:
    the largest step of :func:`moe_mu_sweep` at which all three losses
    fall; at 1e-3 the reference's own step rises as the port's does at
    these widths, ``tests/helpers/torch_mu_witness.py``), rho 0.2,
    T_E=3, bf16 compute, f32 master, bf16 delta, fused, tree, random
    weights from seed 0 (:func:`moe_cells`):

      1. the lift's fused vote at every leaf shape of the four configs
         on [2, 2] cotangents, bitwise its plain ``ag_packed`` vote
         (:func:`fsdp_kernel_route`); one MoE layer of deepseek-v3 and
         of arctic at full shapes against the loop oracle, both
         dispatches, and bitwise on a bf16 rerun
         (:func:`moe_layer_check`);
      2. the check config, 3 steps FSDP fused/tree against the
         replicated ag_packed/tree run at P=2 x D=1 (the replicated
         regime's [P, D] copies, gradients and anchor of 1.5e9
         parameters pass the card's 80 GB at D=2, so step 1 holds the
         vote with two voters a pod at these shapes): bitwise;
      3. deepseek-v3, arctic and internvl2, 6 steps of ``run_training``
         each (a local step of round 2 profiled): round 2's mean loss
         below step 0's, one sign_pack and one vote_update a leaf and
         layer a step, the peak beside :func:`reckon_fsdp_peak`;
      4. internvl2 and deepseek-v3 served resident from edge 0 of their
         trained masters (:func:`moe_serve`).

    Returns each config's kernel launches in step 3 (the main path)."""
    from repro_torch.core import pytree
    from repro_torch.core.topology import Topology
    from repro_torch.launch.train import RunCfg
    from repro_torch.models import build

    t_phase = time.perf_counter()
    cells = moe_cells()
    topo = Topology(MOE_P, MOE_D, "cuda")
    algo = moe_algo(torch, MOE_MU)
    reckoned, abstracts = {}, {}
    for name, cfg in cells.items():
        b = build.build_model(cfg, topo)
        abstract = abstracts[name] = b.abstract_params()
        rows = lift_rows(abstract)
        reckoned[name] = {
            "count": build.param_count(abstract),
            "leaf_layers_a_step": len(rows),
            "bound_ms": lift_bounds(rows),
            "reckoned": reckon_fsdp_peak(b.arch, abstract, 1, MOE_SEQ)}
    emit({"moe": "parameters", "card": card, "pods": MOE_P,
          "devices_per_pod": MOE_D, "seq": MOE_SEQ,
          **{name: {"n_layers": cfg.n_layers, "vocab": cfg.vocab,
                    "experts": cfg.moe.n_experts if cfg.moe else 0,
                    **reckoned[name]} for name, cfg in cells.items()}})

    # 1. the lift's vote at the leaf shapes with 2 voters a pod, and the
    # MoE layer against the loop oracle
    route = fsdp_kernel_route(torch, moe_route_shapes(abstracts), "moe")
    del abstracts
    for name in ("deepseek-v3", "arctic"):
        moe_layer_check(torch, dataclasses.replace(
            cells[name], param_mode="replicated"), name)

    # 2. FSDP against replicated, bitwise.  Each run starts from seed 0's
    # parameters made anew; the FSDP run's edge models wait on the host
    ccfg = cells["check"]
    ctopo = Topology(MOE_P, MOE_CHECK_D, "cuda")
    run3 = RunCfg(steps=FSDP_CHECK_STEPS, batch_per_device=1,
                  seq_len=MOE_SEQ, log_every=1, seed=0)

    def check_params():
        return build.build_model(ccfg, ctopo).init_params(
            torch.Generator(device="cuda").manual_seed(0))

    fs = lm_train(torch, "[moe] check fsdp fused/tree", ccfg, ctopo, algo,
                  run3, check_params())
    fs_params = pytree.tree_map(lambda a: a.cpu(), fs["params"])
    fs_peak, fs_launches, fs_hist = fs["peak_gb"], fs["launches"], fs[
        "history"]
    del fs
    torch.cuda.empty_cache()
    rp = lm_train(torch, "[moe] check replicated ag_packed/tree",
                  dataclasses.replace(ccfg, param_mode="replicated"), ctopo,
                  dataclasses.replace(algo, transport="ag_packed"), run3,
                  check_params())
    rp_params = pytree.tree_map(lambda a: a.cpu(), rp["params"])
    differ = count_differing(torch, fs_params, rp_params)
    total = sum(leaf.numel() for _, leaf in pytree_items(fs_params))
    leaves = reckoned["check"]["leaf_layers_a_step"]
    emit({"moe": "fsdp vs replicated", "arch": ccfg.name, "card": card,
          "pods": MOE_P, "devices_per_pod": MOE_CHECK_D,
          "count": reckoned["check"]["count"], "steps": FSDP_CHECK_STEPS,
          "coordinates": total, "differing": differ, "bitwise": differ == 0,
          "launches": fs_launches, "leaf_layers_a_step": leaves,
          "losses_fsdp": [h["loss"] for h in fs_hist],
          "losses_replicated": [h["loss"] for h in rp["history"]],
          "peak_gb_fsdp": fs_peak, "peak_gb_replicated_tree": rp["peak_gb"]})
    require(differ == 0, f"moe check: fsdp vs replicated, {differ} of "
            f"{total} coordinates differ")
    require(fs_launches["sign_pack"] == FSDP_CHECK_STEPS * leaves,
            f"moe check: launches {fs_launches}")
    del rp, rp_params, fs_params
    torch.cuda.empty_cache()

    # 3. training through run_training (the main path), 4. serving
    launches = {}
    run = RunCfg(steps=MOE_STEPS, batch_per_device=1, seq_len=MOE_SEQ,
                 log_every=1, seed=0)
    for name in ("deepseek-v3", "arctic", "internvl2"):
        cfg = cells[name]
        leaves = reckoned[name]["leaf_layers_a_step"]
        res = lm_train(torch, f"[moe] {name} fused/tree", cfg, topo, algo,
                       run, None, profile=MOE_PROFILED_STEP)
        want = {"sign_pack": MOE_STEPS * leaves,
                "vote_update": MOE_STEPS * leaves, "ternary_quant": 0}
        require(res["launches"] == want, f"{name}: launches "
                f"{res['launches']}, want {want}")
        losses = [h["loss"] for h in res["history"]]
        round2 = statistics.mean(losses[LM_TE:2 * LM_TE])
        require(round2 < losses[0], f"{name}: the loss did not fall: step "
                f"0 {losses[0]}, round 2 mean {round2}")
        prof = res["prof"]
        sp_ms, sp_n = prof["sign_pack_kernel"]
        vu_ms, vu_n = prof["vote_update_kernel"]
        require((sp_n, vu_n) == (leaves, leaves), f"{name}: the profiled "
                f"step launched {sp_n} sign_pack and {vu_n} vote_update, "
                f"want {leaves} each")
        host = [h["ms"] for h in res["history"]]
        local = host[LM_TE + 1:MOE_PROFILED_STEP] + host[
            MOE_PROFILED_STEP + 1:]
        emit({"moe": "step", "arch": cfg.name, "card": card,
              "ms_per_step": host,
              "ms_per_local_step_round2": statistics.mean(local),
              "ms_prologue_step_round2": host[LM_TE],
              "ms_profiled_step": host[MOE_PROFILED_STEP],
              "data_ms_per_step": statistics.mean(
                  h["data_ms"] for h in res["history"]),
              "losses": losses, "round2_mean_loss": round2,
              "launches": res["launches"], "leaf_layers_a_step": leaves})
        sp_bound, vu_bound = reckoned[name]["bound_ms"]
        emit({"moe": "profiled local step", "arch": cfg.name, "card": card,
              "sign_pack_launches": sp_n, "sign_pack_device_ms": sp_ms,
              "sign_pack_bound_ms": sp_bound,
              "vote_update_launches": vu_n, "vote_update_device_ms": vu_ms,
              "vote_update_bound_ms": vu_bound, "bound_by": "bytes",
              "device_busy_ms": prof["busy_ms"],
              "device_busy_share": prof["busy_ms"] / host[
                  MOE_PROFILED_STEP],
              "kernels_share_of_device_time":
                  (sp_ms + vu_ms) / max(prof["busy_ms"], 1e-9),
              "top": prof["top"]})
        emit({"moe": "memory", "arch": cfg.name, "card": card,
              "peak_gb": res["peak_gb"],
              "reckoned_gb": reckoned[name]["reckoned"]["peak_gb"],
              "total_gb": torch.cuda.get_device_properties(0).total_memory
              / 1e9})
        launches[name] = dict(res["launches"])
        masters = res["params"]
        del res
        if name != "arctic":
            moe_serve(torch, card, name, cfg, masters)
        del masters
        torch.cuda.empty_cache()
    emit({"moe": "phase", "card": card, "route_max_abs_err":
          route["max_abs_err"], "wall_s": time.perf_counter() - t_phase})
    return launches


def moe_oracle(torch, p, x, cfg):
    """The MoE layer by plain loops, apart from ``models.moe``: for each
    replica (the leading dims of x [*lead, b, t, d] and of every leaf of
    p), each group of its tokens and each expert, the (token, choice)
    pairs routed there in token-then-choice order up to the capacity,
    through the expert's SwiGLU, weighted by the renormalised gate and
    added to the token's row; then the shared experts and the dense
    residual MLP.  The top-k is numpy's stable argsort of the negated
    probabilities on the host (equal probabilities keep the lower
    expert), the queues Python lists."""
    import numpy as np
    fn = torch.nn.functional
    e = cfg.moe
    lead = tuple(x.shape[:-3])
    b, t, d = x.shape[-3:]
    n = b * t
    g = max(1, n // e.group_tokens)
    s_len = n // g
    cap = max(1, int(s_len * e.top_k / e.n_experts * e.capacity_factor))
    flat = lambda a: a.reshape((-1,) + tuple(a.shape[len(lead):]))  # noqa
    xs = x.reshape((-1, g, s_len, d))
    pr = {k: (flat(v) if not isinstance(v, dict)
              else {kk: flat(vv) for kk, vv in v.items()})
          for k, v in p.items()}

    def swiglu(gate, up, down, rows):
        return (fn.silu(rows @ gate) * (rows @ up)) @ down

    y = torch.zeros_like(xs)
    for r in range(xs.shape[0]):
        for gi in range(g):
            rows = xs[r, gi]
            probs = torch.softmax((rows @ pr["router"][r]).float(), dim=-1)
            probs = probs.cpu().numpy()
            order = np.argsort(-probs, axis=-1, kind="stable")[:, :e.top_k]
            gates = np.take_along_axis(probs, order, axis=-1)
            gates = gates / np.maximum(gates.sum(-1, keepdims=True),
                                       np.float32(1e-9))
            queues = [[] for _ in range(e.n_experts)]
            for s in range(s_len):
                for j in range(e.top_k):
                    q = queues[order[s, j]]
                    if len(q) < cap:
                        q.append((s, float(gates[s, j])))
            for ex, q in enumerate(queues):
                if not q:
                    continue
                toks = torch.tensor([s for s, _ in q], device=x.device)
                w = torch.tensor([gv for _, gv in q], dtype=x.dtype,
                                 device=x.device)
                out = swiglu(pr["w_gate"][r, ex], pr["w_up"][r, ex],
                             pr["w_down"][r, ex], rows[toks])
                y[r, gi, toks] += w[:, None] * out
    y = y.reshape(x.shape)
    xr = x.reshape((-1, n, d))
    for name in ("shared", "dense"):
        if name in pr:
            m = pr[name]
            y = y + torch.stack([swiglu(m["gate"][r], m["up"][r],
                                        m["down"][r], xr[r])
                                 for r in range(xr.shape[0])]).reshape(
                                     x.shape)
    return y


HYB_ARCH, HYB_LAYERS = "zamba2_2p7b", 12   # two periods: 6 Mamba2 blocks
                                           # and the shared block each
HYB_PARAMS = 747_295_040         # the 12-layer cut (the JAX tree's count)
HYB_FSDP_D, HYB_FSDP_STEPS = 2, 3
HYB_PROMPT, HYB_DECODE = 2048, 64  # served whole: 8 requests


def hybrid_cache_reckon(cfg, b: int, max_len: int) -> dict:
    """The served zamba2's cache after prefill, in bytes: a float32 SSM
    state [b, H, 64, d_state] and a bfloat16 conv state [b, d_conv - 1,
    d_in] for each Mamba2 block (every one of ``n_layers``), and the
    shared block's bfloat16 k and v [b, max_len, kv_heads, hd] for each
    of its occurrences (``n_layers // attn_every``)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    terms = {"ssm": cfg.n_layers * b * (d_in // 64) * 64 * s.d_state * 4,
             "conv": cfg.n_layers * b * (s.d_conv - 1) * d_in * 2,
             "kv": (cfg.n_layers // s.attn_every) * 2 * b * max_len
             * cfg.n_kv_heads * cfg.hd * 2}
    return {"bytes": sum(terms.values()), **terms}


def vote_leaves(arch, abstract) -> int:
    """The lift's votes a step under FSDP: one a leaf and layer of each
    stacked block, one a leaf of a tied block (its cotangents summed over
    the occurrences first), one a leaf of the embedding and head."""
    tied = {name for seg in arch.segments for name in seg.tied}
    return sum(leaf.shape[0] if name.startswith("stacks.")
               and name.split(".")[1] not in tied else 1
               for name, leaf in pytree_items(abstract))


def phase_hybrid(torch, card: str) -> dict:
    """The hybrid family on the card: zamba2-2.7b at its published widths
    (d 2560, d_state 64, expand 2, chunk 256, the shared block every 6
    layers: 32 heads of 80, ff 10240; vocab 32000), cut to 12 layers (two
    periods, so the tied block occurs twice; 747,295,040 parameters),
    random weights from seed 0, in the lm phase's algorithm (P=2 x D=3,
    1 x 1152 tokens a device -- 1280 with the last chunk padded --, DC,
    bf16 compute, f32 master, bf16 delta, mu 1e-3, rho 0.2, T_E=3):

      1. one step's per-voter gradients twice, bitwise (NaN payloads
         included), each leaf's NaN count printed: the SSD scan's
         overflow gives the reference's NaN gradients (ROADMAP queue 3),
         which the sign sends to -1;
      2. 6 steps of ``run_training`` on fused/flat (6 sign_pack and 6
         vote_update launches, the last step profiled) and on
         ag_packed/tree: bitwise the same edge models, every loss finite
         (the "loss falls" check is not used: the NaN coordinates vote -1
         whatever the data), the peak beside ``reckon_peak``;
      3. the same config with ``param_mode="fsdp"`` at P=2 x D=2, 3 steps
         on fused/tree, bitwise the replicated ag_packed/tree run, one
         vote a leaf and layer and ONE a leaf of the shared block a step
         (``vote_leaves``: 156; 165 would be a vote an occurrence);
      4. zamba2 whole (54 layers) served as the serve phase serves
         (``serve_arch``: bf16 from a [2, n_pad] f32 master, 8 requests of
         2048 tokens, 64 greedy steps, twice), the cache's bytes against
         ``hybrid_cache_reckon``, decode step 1 against the one-longer
         prefill on the float32 views; no training kernel launched.

    Returns the kernels' launches of steps 2 (fused/flat) and 3."""
    from repro_torch import configs
    from repro_torch.data import synthetic
    from repro_torch.launch.train import RunCfg
    from repro_torch.models import build

    t_phase = time.perf_counter()
    full = configs.get_config(HYB_ARCH)
    cfg, topo, algo = lm_setup(torch, dataclasses.replace(
        full, n_layers=HYB_LAYERS))
    built = build.build_model(cfg, topo)
    params = built.init_params(torch.Generator(device="cuda").manual_seed(0))
    n = build.param_count(params)
    n_full = build.param_count(build.build_model(full, topo)
                               .abstract_params())
    occ = build.occurrence_counts(built.arch.segments)
    reckoned = reckon_peak(cfg, n, 1, LM_SEQ)
    emit({"hybrid": "parameters", "arch": cfg.name, "card": card,
          "n_layers": cfg.n_layers, "count": n,
          "cut": f"depth {full.n_layers} -> {HYB_LAYERS}",
          "full_depth_count": n_full, "occurrences": occ,
          "seq": LM_SEQ, "chunk": cfg.ssm.chunk, "reckoned": reckoned})
    require(n == HYB_PARAMS and n_full == HYB_FULL_PARAMS,
            f"zamba2: {n} parameters at {HYB_LAYERS} layers, {n_full} "
            "whole")
    tag = "[hybrid] zamba2"
    tokens = synthetic.make_stream(synthetic.LMStreamCfg(
        vocab=cfg.vocab, seq_len=LM_SEQ, batch_per_device=1, pods=LM_P,
        devices_per_pod=LM_D, seed=0))(0)["tokens"].cuda()
    nans = {}

    def count_nans(grads):
        for (name, _), g in zip(pytree_items(params), grads):
            nans[name] = int(torch.isnan(g).sum())

    differ = lm_grads_bitwise(torch, built, params, {"tokens": tokens},
                              tag=tag, on_grads=count_nans)
    emit({"hybrid": "gradients", "card": card,
          "differing_between_two_evaluations": differ,
          "leaves_with_nan": sum(1 for v in nans.values() if v),
          "leaves": len(nans), "nan_counts": nans})
    require(differ == 0, "zamba2: the per-voter gradients are not "
            "deterministic on the card (bit patterns, NaN payloads too)")
    print(f"{tag}: the loss-falls check is not used: the reference's "
          f"NaN gradients ({sum(1 for v in nans.values() if v)} of "
          f"{len(nans)} leaves) vote -1 whatever the data; the losses "
          "must be finite and the routes bitwise", flush=True)

    run = RunCfg(steps=LM_STEPS, batch_per_device=1, seq_len=LM_SEQ,
                 log_every=1, seed=0)
    fused = lm_train(torch, f"{tag} fused/flat", cfg, topo, algo, run,
                     params, profile=LM_STEPS - 1)
    want = {"sign_pack": LM_STEPS, "vote_update": LM_STEPS,
            "ternary_quant": 0}
    require(fused["launches"] == want, f"zamba2 fused/flat launches "
            f"{fused['launches']}, want {want}")
    tree = lm_train(torch, f"{tag} ag_packed/tree", cfg, topo,
                    dataclasses.replace(algo, transport="ag_packed",
                                        state_layout="tree"), run, params)
    require(tree["launches"] == dict.fromkeys(want, 0),
            f"zamba2 ag_packed/tree launched kernels: {tree['launches']}")
    diff = count_differing(torch, fused["params"], tree["params"])
    require(diff == 0, f"zamba2: fused/flat and ag_packed/tree edge "
            f"models differ in {diff} coordinates")
    print(f"{tag}: fused/flat == ag_packed/tree edge models, bitwise",
          flush=True)
    prof = fused["prof"]
    shape = (LM_P, LM_D, fused["n_pad"].n_pad)
    sp_ms, sp_n = prof["sign_pack_kernel"]
    vu_ms, vu_n = prof["vote_update_kernel"]
    sp_bytes = sign_pack_bytes(shape, 2, False)
    vu_bytes = vote_update_bytes(shape, True, LM_P * LM_D)
    host = [h["ms"] for h in fused["history"]]
    emit({"hybrid": "step", "arch": cfg.name, "card": card,
          "ms_per_step": host,
          "ms_per_step_round2_fused_flat": statistics.mean(host[LM_TE:-1]),
          "ms_profiled_step": host[-1],
          "ms_per_step_round2_ag_packed_tree": statistics.mean(
              h["ms"] for h in tree["history"][LM_TE:]),
          "data_ms_per_step": statistics.mean(
              h["data_ms"] for h in fused["history"]),
          "losses": [h["loss"] for h in fused["history"]],
          "launches": fused["launches"]})
    emit({"hybrid": "kernels", "arch": cfg.name, "card": card,
          "shape": list(shape),
          "sign_pack_device_ms": sp_ms / max(sp_n, 1),
          "sign_pack_bound_ms": bound(sp_bytes, sign_pack_ops(
              shape, False))[0],
          "vote_update_device_ms": vu_ms / max(vu_n, 1),
          "vote_update_bound_ms": bound(vu_bytes, vote_update_ops(
              shape, True))[0],
          "launches_profiled": [sp_n, vu_n],
          "device_busy_ms_profiled_step": prof["busy_ms"],
          "device_busy_share": prof["busy_ms"] / host[-1],
          "kernels_share_of_device_time":
              (sp_ms + vu_ms) / max(prof["busy_ms"], 1e-9),
          "top": prof["top"]})
    emit({"hybrid": "memory", "arch": cfg.name, "card": card,
          "peak_gb_fused_flat": fused["peak_gb"],
          "peak_gb_ag_packed_tree": tree["peak_gb"],
          "reckoned_gb": reckoned["peak_gb"],
          "total_gb": torch.cuda.get_device_properties(0).total_memory / 1e9})
    launches = {"replicated": fused["launches"]}
    del fused, tree
    torch.cuda.empty_cache()

    # 3. FSDP against replicated, the shared block voted once a step
    topo2 = dataclasses.replace(topo, devices_per_pod=HYB_FSDP_D)
    algo2 = dataclasses.replace(algo, state_layout="tree")
    cfgf = dataclasses.replace(cfg, param_mode="fsdp")
    leaves = vote_leaves(built.arch, built.abstract_params())
    run2 = dataclasses.replace(run, steps=HYB_FSDP_STEPS)
    fs = lm_train(torch, f"{tag} fsdp fused/tree", cfgf, topo2, algo2,
                  run2, params)
    want2 = {"sign_pack": HYB_FSDP_STEPS * leaves,
             "vote_update": HYB_FSDP_STEPS * leaves, "ternary_quant": 0}
    rp = lm_train(torch, f"{tag} replicated ag_packed/tree", cfg, topo2,
                  dataclasses.replace(algo2, transport="ag_packed"), run2,
                  params)
    differ = count_differing(torch, fs["params"], rp["params"])
    emit({"hybrid": "fsdp vs replicated", "arch": cfg.name, "card": card,
          "pods": LM_P, "devices_per_pod": HYB_FSDP_D,
          "steps": HYB_FSDP_STEPS, "votes_a_step": leaves,
          "launches": fs["launches"], "differing": differ,
          "bitwise": differ == 0,
          "ms_per_step_fsdp": [h["ms"] for h in fs["history"]],
          "ms_per_step_replicated": [h["ms"] for h in rp["history"]],
          "losses_fsdp": [h["loss"] for h in fs["history"]],
          "peak_gb_fsdp": fs["peak_gb"], "peak_gb_replicated": rp["peak_gb"]})
    require(fs["launches"] == want2, f"zamba2 fsdp launches "
            f"{fs['launches']}, want {want2} (a vote a leaf and layer, "
            f"the shared block's leaves once a step)")
    require(differ == 0, f"zamba2 fsdp vs replicated: {differ} coordinates "
            "differ")
    launches["fsdp"] = fs["launches"]
    del fs, rp, params, built
    torch.cuda.empty_cache()

    # 4. served whole
    counters = kernel_counters()
    for fn in counters:
        fn.launches = 0
    serve_arch(torch, card, HYB_ARCH, HYB_PROMPT, HYB_DECODE,
               HYB_PROMPT + HYB_DECODE, checks=("float32 views",))
    served = {fn.__name__: fn.launches for fn in counters}
    require(not any(served.values()),
            f"serving zamba2 launched a training kernel: {served}")
    emit({"hybrid": "phase", "card": card,
          "wall_s": time.perf_counter() - t_phase})
    return launches


MESH_GRID = (2, 2)               # pods x data ranks, a [1, 1] block each
MESH_P, MESH_D = 2, 2            # the global hierarchy over them
MESH_STEPS, MESH_TE = 6, 3
MESH_LM_STEPS = 3                # gemma3-1b over the ranks (mesh, tp):
                                 # round 1, its prologue and two local
                                 # steps -- a gloo prologue costs 25-40
                                 # local steps, so no second one
MESH_JOIN_S = 600                # the ranks' join limit
MESH_CKPT_EVERY = 2              # run B (the ckpt part): saved at 2, a
MESH_CKPT_NAN = 2                # nan at 2 restored and replayed, saved
MESH_CKPT_KEEP = 2               # at the end: the two steps the store keeps
CKPT_SLOTS = ("params", "delta", "delta_next")   # DC's slots (f32 on disk)
SHM = "/dev/shm"                 # where the ranks' shared slots go
SHM_NEED_PER_RANK = 256 << 20    # 3 slots of 64 MiB a rank, and room
MESH_TOY = {"w": (16, 64), "b": (33,), "w2": (64, 33)}   # the parity toy
MESH_CELLS = {       # name -> (AlgoConfig fields, K clients or None)
    "dc fused/flat": (dict(method="dc_hier_signsgd"), None),
    "hier_sgd fused/flat": (dict(method="hier_sgd"), None),
    "hier_local_qsgd fused/flat": (dict(method="hier_local_qsgd"), None),
    "dc fused/flat K=2 stream": (dict(method="dc_hier_signsgd"), 2),
}
MESH_SEED = 1000                 # the LM-size transport's directions


def mesh_toy_run(torch, topo, cell: str) -> dict:
    """One parity-toy cell on ``topo`` (the one-process [2, 2] topology
    or a rank's block): ``MESH_STEPS`` steps of the injected-gradient
    toy (``tests/helpers/injected_grads.py``; gradients, weights and
    masks drawn whole from seeds, every rank keeping its block), fused
    transport, flat state, f32; returns the gathered global state as
    numpy, the losses and the four kernels' launches in this process."""
    import injected_grads
    from repro_torch.convert import gather_train_state
    from repro_torch.core import hier, pytree
    from repro_torch.core.clients import ClientConfig

    fields, k = MESH_CELLS[cell]
    cc = ClientConfig()
    if k:
        cc = ClientConfig(count=k, participation="bernoulli", rate=0.5,
                          seed=11, mode="stream", weights=tuple(
                              tuple(tuple((q + 2 * d + 3 * c) % 5 + 1
                                          for c in range(k))
                                    for d in range(MESH_D))
                              for q in range(MESH_P)))
    algo = hier.AlgoConfig(t_e=MESH_TE, mu=MU, mu_sgd=0.05, rho=RHO,
                           transport="fused", state_layout="flat",
                           compute_dtype=torch.float32,
                           delta_dtype=torch.float32, clients=cc, **fields)
    gen = torch.Generator().manual_seed(5)
    grads = injected_grads.make_grads(MESH_TOY, MESH_P, MESH_D, k or 1,
                                      MESH_STEPS, gen)
    w0 = {n: torch.randn(s, generator=gen) for n, s in MESH_TOY.items()}
    ew = torch.tensor([0.375, 0.625])
    dw = torch.tensor([[0.25, 0.75], [0.5, 0.5]])
    mask = torch.ones((MESH_P, MESH_D) + ((k,) if k else ()))
    init_fn, step = hier.make_hier_step(topo, algo,
                                        injected_grads.make_bundle())
    state = init_fn(w0)
    counters = kernel_counters()
    for kern in counters:
        kern.launches = 0
    losses = []
    for g in grads:
        batch = pytree.tree_map(lambda x: x.to("cuda"), topo.block(g))
        state, metrics = step(state, {"train": batch}, ew, dw, mask)
        losses.append(float(metrics["loss"]))
    launches = dict(zip(("sign_pack", "vote_update", "tally_acc",
                         "ternary_quant"),
                        (kern.launches for kern in counters)))
    full = gather_train_state(state, topo)
    return {"state": {n: v for n, v in full._asdict().items()
                      if n not in ("rng", "step")},
            "losses": losses, "launches": launches}


def mesh_directions(torch, topo, n: int):
    """The LM-size transport's inputs, the rank's block of the seeded
    global ones: [P_loc, D_loc, n] bf16 directions (row (q, d) drawn from
    seed ``MESH_SEED + q*D + d``) and the [P_loc, n] f32 master (row q
    from ``MESH_SEED - 1 - q``)."""
    def row(seed, dtype):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn(n, generator=g, device="cuda", dtype=dtype)

    pods = range(topo.pod_offset, topo.pod_offset + topo.local_pods)
    devs = range(topo.device_offset,
                 topo.device_offset + topo.local_devices)
    u = torch.stack([torch.stack([row(MESH_SEED + q * MESH_D + d,
                                      torch.bfloat16) for d in devs])
                     for q in pods])
    v = torch.stack([row(MESH_SEED - 1 - q, torch.float32) for q in pods])
    return u, v


def mesh_transport(torch, topo, n: int) -> dict:
    """One fused vote-update at the LM's size through
    ``votes.fused_sign_vote_update`` (sign_pack on the rank's rows, the
    words gathered over the data group, vote_update on its [P_loc, n]
    master in place, mu 1e-3): each edge row's sha256, and the time of
    the words' gather alone (median of 3, host clock around
    synchronised calls)."""
    from repro_torch.core import comm, flatbuf, votes
    from repro_torch.kernels import ops as kops

    u, v = mesh_directions(torch, topo, n)
    layout = flatbuf.make_layout({"w": v}, batch_dims=1)
    mask = torch.ones((topo.local_pods, MESH_D), dtype=torch.bool,
                      device="cuda")
    mu = 1e-3
    out = votes.fused_sign_vote_update(
        layout, {"w": u}, None, 0.0, mask, v,
        torch.tensor(mu, dtype=torch.float32, device="cuda"), mu_static=mu,
        topo=topo)
    require(out is v, "the fused vote-update did not update in place")
    torch.cuda.synchronize()
    digests = row_digests(torch, v)
    words = kops.fused_pack_flat(u, None, 0.0)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        gathered = comm.gather_devices(topo, words)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    res = {"digests": digests, "word_bytes_per_device": words[0, 0].numel()
           * words.element_size(), "gathered_shape": list(gathered.shape),
           "gather_ms": statistics.median(times), "gather_ms_all": times}
    del u, v, words, gathered
    torch.cuda.empty_cache()
    return res


def mesh_lm_grads(torch, built, params, tokens, shape):
    """Per-voter gradients of the LM at ``params`` on ``tokens`` ([P', D',
    1, seq]) from fresh bf16 [P', D'] copies, in ``pytree_items`` order,
    flattened to one bf16 vector per voter: [P', D', n]."""
    from repro_torch.core import pytree

    leaves, td = pytree.tree_flatten(params)
    copies = [leaf.unsqueeze(0).unsqueeze(0).expand(shape + tuple(leaf.shape))
              .to(torch.bfloat16).contiguous().requires_grad_(True)
              for leaf in leaves]
    losses = built.bundle.loss(pytree.tree_unflatten(td, copies),
                               {"tokens": tokens})
    grads = torch.autograd.grad(losses.sum(), copies)
    del copies, losses
    return torch.cat([g.reshape(shape + (-1,)) for g in grads], dim=-1)


def mesh_lm_setup(torch, topo):
    """gemma3-1b at full width cut to two layers (:func:`two_layer_cut`)
    on ``topo``: (cfg, built, params from seed 0, the DC fused/flat
    algo, the run)."""
    from repro_torch.launch.train import RunCfg
    from repro_torch.models import build

    cfg, _, algo = lm_setup(torch, two_layer_cut())
    built = build.build_model(cfg, topo)
    params = built.init_params(torch.Generator(device="cuda").manual_seed(0))
    run = RunCfg(steps=MESH_LM_STEPS, batch_per_device=1, seq_len=LM_SEQ,
                 log_every=1, seed=0)
    return cfg, built, params, algo, run


def mesh_tokens(torch, cfg):
    from repro_torch.data import synthetic

    return synthetic.make_stream(synthetic.LMStreamCfg(
        vocab=cfg.vocab, seq_len=LM_SEQ, batch_per_device=1, pods=MESH_P,
        devices_per_pod=MESH_D, seed=0))(0)["tokens"]


def digest(torch, x) -> str:
    """The sha256 of a tensor's bytes (bfloat16 as its 16-bit words)."""
    import hashlib

    x = x.contiguous()
    if x.dtype == torch.bfloat16:
        x = x.view(torch.int16)
    return hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest()


def digests(torch, xs) -> list:
    """:func:`digest` of each tensor of ``xs``, on a pool of threads (the
    copies to the host and sha256 release the GIL)."""
    import concurrent.futures

    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        return list(pool.map(lambda x: digest(torch, x), xs))


def row_digests(torch, buf) -> list:
    return digests(torch, list(buf))


def mesh_lm_rank(torch, topo, tmp: str) -> dict:
    """The rank's part of the LM run: its step-0 gradients' digest, then
    ``run_training`` over the mesh (MESH_LM_STEPS, DC fused/flat) with the
    kernels' counters and ``comm.traffic`` set to 0 just before it: its
    losses, step times, launches and peak; the ranks of data column 0
    write their edge's final master row to ``tmp/lm_row{q}.npy``."""
    import hashlib

    import numpy as np

    from repro_torch.core import comm
    from repro_torch.launch.train import run_training

    cfg, built, params, algo, run = mesh_lm_setup(torch, topo)
    tokens = topo.block(mesh_tokens(torch, cfg)).cuda()
    g = mesh_lm_grads(torch, built, params, tokens, (1, 1))
    grad_digest = hashlib.sha256(g.view(torch.int16).cpu().numpy()
                                 .tobytes()).hexdigest()
    del g, tokens
    torch.cuda.empty_cache()
    counters = kernel_counters()
    for kern in counters:
        kern.launches = 0
    comm.reset_traffic()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, history = run_training(cfg, topo, algo, run, params=params,
                                  log=lambda line: None)
    torch.cuda.synchronize()
    res = {"grad_digest": grad_digest,
           "losses": [h["loss"] for h in history],
           "ms": [h["ms"] for h in history],
           "data_ms": [h["data_ms"] for h in history],
           "launches": dict(zip(("sign_pack", "vote_update", "tally_acc",
                                 "ternary_quant"),
                                (kern.launches for kern in counters))),
           "traffic": {op: dict(v) for op, v in comm.traffic.items()},
           "peak_gb": (torch.cuda.max_memory_allocated() - before) / 1e9,
           "held_gb": before / 1e9}
    if topo.mesh.data_rank == 0:
        np.save(pathlib.Path(tmp) / f"lm_row{topo.pod_offset}.npy",
                state.params.buf[0].cpu().numpy())
    del state, params
    torch.cuda.empty_cache()
    return res


def reckon_mesh_peak(n: int, p_loc: int = 1, d_loc: int = 1,
                     vocab: int = 262144) -> dict:
    """A mesh rank's peak device memory (GB) in the LM run, reckoned
    from n parameters before any run (bf16 compute, f32 master, bf16
    delta, DC; ``reckon_peak``'s terms at the rank's block).  The
    cross-rank means gather and fold a chunk of coordinates at a time
    (``votes._across_devices``, ``votes.pod_weighted_average``), so
    their gathers add no term:

      state   8n a pod row: the f32 master, bf16 delta and delta_next;
      local   the backward's bf16 copies and gradients (4n a voter) and
              the logits (18 bytes a logit, ``vocab`` a position: a
              model rank's vocab block under tensor parallelism, where n
              is its bucket);
      anchor  the f32 flatten of the anchor gradients (4n a voter) and
              c_q (4n a row);
      cloud   c_q, c and their f32 difference (12n a row).

    peak = state + max(local, anchor, cloud)."""
    rows = p_loc * d_loc
    terms = {"state": 8 * p_loc * n,
             "local": 4 * rows * n + 18 * rows * LM_SEQ * vocab,
             "anchor": 4 * rows * n + 4 * p_loc * n,
             "cloud": 12 * p_loc * n}
    peak = terms["state"] + max(terms["local"], terms["anchor"],
                                terms["cloud"])
    return {"peak_gb": peak / 1e9,
            **{f"{k}_gb": v / 1e9 for k, v in terms.items()}}


def rank_topology(mesh, grid: tuple):
    """A rank's topology on ``grid`` over gloo on the card, its
    all-gathers and all-to-alls through the host memory the ranks share
    (the directory :func:`mesh_spawn` hands them)."""
    import os

    return mesh.make_host_topology(
        *grid, backend="gloo", device="cuda",
        shared_dir=os.environ["CHIP_SMOKE_SHARED_DIR"])


def exchange_info(topo) -> dict:
    """Where the rank's shared slots live and, per group, whether the
    driver took them page-locked."""
    import os

    d = os.environ["CHIP_SMOKE_SHARED_DIR"]
    return {"dir": "shm" if d.startswith(SHM) else "tmp",
            "pinned": {name: ex.pinned
                       for name, ex in topo.mesh.exchange.items()}}


def mesh_rank_main(tmp: str, rank: int) -> None:
    """One rank of the ``mesh`` phase (``chip_smoke.py --mesh-rank RANK
    DIR``): gloo over ``DIR/rdv``, a 2 x 2 grid on the one card, the
    parity toy's cells, the LM-size transport and the LM run; writes
    ``DIR/rank{RANK}.pkl``."""
    import os
    import pickle

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests" / "helpers"))
    from repro_torch.core.topology import resolve_device
    from repro_torch.launch import mesh
    from repro_torch.kernels import build

    resolve_device("cuda")
    build.load()
    d = pathlib.Path(tmp)
    with open(d / "job.pkl", "rb") as f:
        job = pickle.load(f)
    t0 = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"file://{d / 'rdv'}",
                            rank=rank, world_size=MESH_GRID[0] * MESH_GRID[1],
                            timeout=mesh.TIMEOUT)
    topo = rank_topology(mesh, MESH_GRID)
    res = {"rank": rank, "coords": (topo.mesh.pod_rank, topo.mesh.data_rank),
           "init_s": time.perf_counter() - t0,
           "exchange": exchange_info(topo)}
    if "mesh" in job["parts"]:
        mesh_rank_work(torch, topo, job, tmp, res)
    if "fsdp" in job["parts"]:
        t1 = time.perf_counter()
        res["fsdp_lift"] = fsdp_lift_rank(torch, topo)
        t2 = time.perf_counter()
        res["fsdp_lm"] = fsdp_mesh_lm_rank(torch, topo)
        res["fsdp_lift_s"] = t2 - t1
        res["fsdp_lm_s"] = time.perf_counter() - t2
    with open(d / f"rank{rank}.tmp", "wb") as f:
        pickle.dump(res, f)
    os.replace(d / f"rank{rank}.tmp", d / f"rank{rank}.pkl")
    dist.barrier()
    dist.destroy_process_group()


def mesh_rank_work(torch, topo, job: dict, tmp: str, res: dict) -> None:
    """The mesh phase's own part of a rank's run, into ``res``."""
    import torch.distributed as dist

    rank = topo.mesh.rank
    # gloo takes CUDA tensors: an int8 and an int32 sum, a bf16 gather
    x = torch.full((4,), rank + 1, dtype=torch.int8, device="cuda")
    dist.all_reduce(x)
    y = x.to(torch.int32)
    dist.all_reduce(y)
    parts = [torch.empty(3, dtype=torch.bfloat16, device="cuda")
             for _ in range(4)]
    dist.all_gather(parts, torch.full((3,), float(rank), device="cuda",
                                      dtype=torch.bfloat16))
    res["probe"] = {"int8_sum": x.tolist(), "int32_sum": y.tolist(),
                    "bf16_gather": [p.tolist() for p in parts]}
    res["toy"] = {}
    for cell in MESH_CELLS:
        t1 = time.perf_counter()
        out = mesh_toy_run(torch, topo, cell)
        out["s"] = time.perf_counter() - t1
        if rank:
            del out["state"]
        res["toy"][cell] = out
    t1 = time.perf_counter()
    res["transport"] = mesh_transport(torch, topo, job["n_pad"])
    res["transport"]["s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    res["lm"] = mesh_lm_rank(torch, topo, tmp)
    res["lm"]["s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    res["ckpt"] = mesh_ckpt_rank(torch, topo, job["ckpt_dir"], tmp)
    res["ckpt"]["s"] = time.perf_counter() - t1


def host_resident_gb() -> float:
    """This process's resident host memory now (GB), from /proc."""
    import os

    with open("/proc/self/statm") as f:
        pages = int(f.read().split()[1])
    return pages * os.sysconf("SC_PAGE_SIZE") / 1e9


class save_meter:
    """Within it, each ``AsyncSaver.submit`` of this process timed, its
    device memory growth measured (the peak over the call, less what was
    allocated before it) and its host memory growth (resident after the
    call less before: on the writer the global copy it queued), appended
    to ``saves`` as ``{"step", "s", "growth_gb", "host_growth_gb"}``."""

    def __init__(self, torch, saves: list):
        self.torch, self.saves = torch, saves

    def __enter__(self):
        from repro_torch.checkpoint.async_ckpt import AsyncSaver

        torch, saves, real = self.torch, self.saves, AsyncSaver.submit
        self.real = real

        def submit(saver, step, tree):
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            host = host_resident_gb()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            real(saver, step, tree)
            torch.cuda.synchronize()
            saves.append({"step": step, "s": time.perf_counter() - t0,
                          "growth_gb": (torch.cuda.max_memory_allocated()
                                        - before) / 1e9,
                          "host_growth_gb": host_resident_gb() - host})
        AsyncSaver.submit = submit
        return self

    def __exit__(self, *exc):
        from repro_torch.checkpoint.async_ckpt import AsyncSaver

        AsyncSaver.submit = self.real
        return False


def mesh_ckpt_rank(torch, topo, root: str, tmp: str) -> dict:
    """Run B of the mesh phase's ckpt part (item 17e) on this rank: run
    A's run (MESH_LM_STEPS steps of DC fused/flat) with checkpoints in
    ``root`` every MESH_CKPT_EVERY steps and a nan at MESH_CKPT_NAN,
    restored and replayed, the kernels' counters and ``comm.traffic``
    set to 0 just before it: the digests of the rank's rows of each
    slot at the step-2 save, its final rows against run A's (data
    column 0, ``tmp/lm_row{q}.npy``), its launches, each save's seconds
    and device and host growth (the device's beside the rank's block),
    the restore's seconds and the bytes it sent the writer (received,
    on rank 0)."""
    import numpy as np

    from repro_torch.core import comm
    from repro_torch.launch.train import run_training
    from repro_torch.runtime.chaos import ChaosEvent, FaultInjector

    cfg, _, params, algo, run = mesh_lm_setup(torch, topo)
    run = dataclasses.replace(run, ckpt_dir=root, ckpt_every=MESH_CKPT_EVERY,
                              ckpt_keep=MESH_CKPT_KEEP)
    rows, events, saves = {}, [], []

    def on_state(step, state):
        if state.step == MESH_CKPT_EVERY and not rows:
            rows.update(zip(CKPT_SLOTS, ([d] for d in digests(torch, [
                getattr(state, name).buf[0] for name in CKPT_SLOTS]))))

    zero_launches()
    comm.reset_traffic()
    with save_meter(torch, saves):
        state, history = run_training(
            cfg, topo, algo, run, params=params,
            fault_injector=FaultInjector([ChaosEvent(MESH_CKPT_NAN, "nan")]),
            log=lambda line: None, on_checkpoint=events.append,
            on_state=on_state)
    torch.cuda.synchronize()
    res = {"digests": rows, "events": events, "saves": saves,
           "steps": [h["step"] for h in history],
           "losses": [h["loss"] for h in history],
           "launches": counted_launches(),
           "traffic": dict(comm.traffic["checkpoint"]),
           "block_gb": sum(getattr(state, n).buf.numel()
                           * getattr(state, n).buf.element_size()
                           for n in CKPT_SLOTS) / 1e9}
    if topo.mesh.data_rank == 0:
        row = np.load(pathlib.Path(tmp) / f"lm_row{topo.pod_offset}.npy")
        res["rows_differing"] = int(
            (state.params.buf[0].cpu().numpy().view(np.int32)
             != row.view(np.int32)).sum())
    del state, params
    torch.cuda.empty_cache()
    return res


def mesh_ckpt_check(torch, card: str, root, tmp, ranks: list,
                    ckpt_bytes: int) -> dict:
    """The parent's half of the ckpt part, once the ranks have joined:
    run B's step-2 and final checkpoints restored into one process
    (P=2 x D=2 on the card: another shape than the 2 x 2 ranks'), the
    final rows held bitwise against run A's on the ranks
    (``tmp/lm_row{q}.npy``), the step-2 state against the digests each
    rank printed of its rows; then the ranks' readings and the checks
    (one line ``{"mesh": "ckpt", ...}``).  Returns the ranks'
    launches in run B."""
    import numpy as np

    from repro_torch.checkpoint import store
    from repro_torch.core import hier
    from repro_torch.core.topology import Topology

    steps = store.available_steps(root)
    require(steps == [MESH_CKPT_EVERY, MESH_LM_STEPS],
            f"mesh ckpt: the store holds steps {steps}")
    one = Topology(MESH_P, MESH_D, "cuda")
    cfg, built, params, algo, _ = mesh_lm_setup(torch, one)
    init_fn, _ = hier.make_hier_step(one, algo, built.bundle)
    like = init_fn(params, 0)
    del params, built
    t0 = time.perf_counter()
    final = store.restore(root, MESH_LM_STEPS, like)
    torch.cuda.synchronize()
    final_s = time.perf_counter() - t0
    final_differ = [int((final.params.buf[q].cpu().numpy().view(np.int32)
                         != np.load(pathlib.Path(tmp) / f"lm_row{q}.npy")
                         .view(np.int32)).sum()) for q in range(MESH_P)]
    del final
    t0 = time.perf_counter()
    saved = store.restore(root, MESH_CKPT_EVERY, like)
    torch.cuda.synchronize()
    saved_s = time.perf_counter() - t0
    flat = digests(torch, [r for name in CKPT_SLOTS
                           for r in getattr(saved, name).buf])
    want = {name: flat[i * MESH_P:(i + 1) * MESH_P]
            for i, name in enumerate(CKPT_SLOTS)}
    del saved, like
    torch.cuda.empty_cache()
    digests_differ = {f"{r['coords'][0]},{r['coords'][1]}": [
        name for name in CKPT_SLOTS
        if r["ckpt"]["digests"][name] != want[name][r["coords"][0]:
                                                     r["coords"][0] + 1]]
        for r in ranks}
    ck = [r["ckpt"] for r in ranks]
    emit({"mesh": "ckpt", "card": card, "grid": list(MESH_GRID),
          "checkpoint_gb_reckoned": ckpt_bytes / 1e9,
          "bytes": [rec.get("bytes") for rec in ck[0]["events"]
                    if rec["event"] == "save"],
          "events_rank0": ck[0]["events"],
          "steps_run": ck[0]["steps"], "losses": ck[0]["losses"],
          "submit_s_per_rank": [[x["s"] for x in c["saves"]] for c in ck],
          "save_s_writer": [rec.get("save_s") for rec in ck[0]["events"]
                            if rec["event"] == "save"],
          "restore_s_per_rank": [[e["restore_s"] for e in c["events"]
                                  if e["event"] == "restore"] for c in ck],
          "device_growth_gb_per_rank": [[x["growth_gb"] for x in c["saves"]]
                                        for c in ck],
          "block_gb_per_rank": [c["block_gb"] for c in ck],
          "sent_gb_per_rank": [c["traffic"]["sent"] / 1e9 for c in ck],
          "writer_received_gb": ck[0]["traffic"]["received"] / 1e9,
          "host_growth_gb_per_rank": [[x["host_growth_gb"]
                                       for x in c["saves"]] for c in ck],
          "writer_host_gb_reckoned": ckpt_bytes / 1e9,
          "launches_per_rank": [c["launches"] for c in ck],
          "run_b_s_per_rank": [c["s"] for c in ck],
          "rows_differing_per_rank": [c.get("rows_differing") for c in ck],
          "one_process_final_rows_differing": final_differ,
          "one_process_restore_s": {"final": final_s, "step 2": saved_s},
          "step2_digests_differing": digests_differ})
    executed = MESH_LM_STEPS + 1          # step 2 runs twice
    for c in ck:
        require([e["event"] for e in c["events"]]
                == ["restore", "save", "save"]
                and c["events"][0]["step"] == MESH_CKPT_EVERY,
                f"mesh ckpt: events {c['events']}")
        require(c["launches"] == {"sign_pack": executed,
                                  "vote_update": executed,
                                  "tally_acc": 0, "ternary_quant": 0},
                f"mesh ckpt: launches {c['launches']}")
        require(c.get("rows_differing", 0) == 0,
                "mesh ckpt: run B's final rows are not run A's")
        for x in c["saves"]:
            require(x["growth_gb"] <= c["block_gb"],
                    f"mesh ckpt: a save grew the card's memory by "
                    f"{x['growth_gb']} GB, more than the rank's block "
                    f"{c['block_gb']} GB")
    require(final_differ == [0] * MESH_P,
            f"mesh ckpt: the final checkpoint's rows differ from run A's: "
            f"{final_differ}")
    require(all(not v for v in digests_differ.values()),
            f"mesh ckpt: the step-2 checkpoint differs from the ranks' "
            f"blocks: {digests_differ}")
    return [c["launches"] for c in ck]


def mesh_spawn(torch, tmp: str, world: int = MESH_GRID[0] * MESH_GRID[1],
               flag: str = "--mesh-rank", limit: float = MESH_JOIN_S,
               meanwhile=None) -> list:
    """Start the ``world`` ranks on the card as ``chip_smoke.py FLAG RANK
    DIR`` (one intra-op thread each: the ranks share the host's cores,
    and their work there is gloo's copies), run ``meanwhile()`` here if
    given, and wait for them at most ``limit`` seconds; a rank that fails
    or outlives it, or a failing ``meanwhile``, fails the phase, every
    rank killed first.  The ranks build their meshes with shared host
    memory (``make_host_topology(shared_dir=...)``, ``rank_topology``)
    in a fresh directory under ``SHM`` where it has room, else in
    ``tmp``; the directory under ``SHM`` is removed after them.  Returns
    the ranks' results."""
    import os

    import shutil
    import tempfile

    shared = tmp
    if (os.path.isdir(SHM)
            and shutil.disk_usage(SHM).free >= SHM_NEED_PER_RANK * world):
        shared = tempfile.mkdtemp(prefix="chip_smoke_", dir=SHM)
    try:
        return _mesh_spawn(torch, tmp, world, flag, limit, meanwhile, shared)
    finally:
        if shared != tmp:
            shutil.rmtree(shared, ignore_errors=True)


def _mesh_spawn(torch, tmp, world, flag, limit, meanwhile, shared) -> list:
    import os
    import pickle

    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True",
               CHIP_SMOKE_SHARED_DIR=shared)
    logs = [open(pathlib.Path(tmp) / f"rank{r}.log", "w+")
            for r in range(world)]
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), flag,
         str(r), tmp], env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(world)]
    if meanwhile is not None:
        try:
            meanwhile()
        except BaseException:
            for proc in procs:
                proc.kill()
            for proc in procs:
                proc.wait()
            raise
    deadline = time.monotonic() + limit

    def tails():
        out = []
        for r, log in enumerate(logs):
            log.flush()
            log.seek(0)
            out.append(f"--- rank {r}\n{log.read()[-4000:]}")
        return "\n".join(out)

    try:
        for proc in procs:
            proc.wait(timeout=max(deadline - time.monotonic(), 0.0))
    except subprocess.TimeoutExpired:
        for proc in procs:
            proc.kill()
        for proc in procs:
            proc.wait()
        fail(f"the {flag} ranks outlived {limit} s: killed\n{tails()}")
    codes = [proc.returncode for proc in procs]
    if any(codes):
        fail(f"a {flag} rank failed (exit codes {codes})\n{tails()}")
    for log in logs:
        log.close()
    out = []
    for r in range(world):
        with open(pathlib.Path(tmp) / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def states_differing(want: dict, got: dict) -> int:
    """Coordinates (bytes compared) that differ between two gathered
    numpy states."""
    import numpy as np

    total = 0
    for name, w in want.items():
        g = got[name]
        require((w is None) == (g is None), f"slot {name} present in one "
                "state only")
        if w is None:
            continue
        wl = w if isinstance(w, dict) else {"": w}
        gl = g if isinstance(g, dict) else {"": g}
        for k in wl:
            a, b = np.asarray(wl[k]), np.asarray(gl[k])
            require(a.shape == b.shape, f"slot {name}/{k}: shape "
                    f"{a.shape} vs {b.shape}")
            total += int((a.view(np.uint8) != b.view(np.uint8)).sum())
    return total


def phase_mesh(torch, card: str, fsdp: bool = False) -> dict:
    """The hierarchy across processes on the one card: 4 ranks (2 pods x
    2 data) over gloo, each holding a [1, 1] block of P=2 x D=2.  The
    one-process references run here first (and are freed), then the
    ranks: the parity toy's cells bitwise the one-process run with the
    four kernels counted in every rank; one fused vote-update at the
    LM's size bitwise; gemma3-1b (2 layers, full width)
    ``MESH_LM_STEPS`` steps of ``run_training`` over the ranks, its
    step-0 gradients and its
    trajectory against the one-process run.  With ``fsdp`` the ranks
    then run their part of the FSDP regime across processes
    (:func:`fsdp_lift_rank`, :func:`fsdp_mesh_lm_rank`), whose results
    come back under ``"ranks"`` for :func:`fsdp_mesh_report`.  Returns
    the per-rank launches of the toy's cells and of the LM run."""
    import gc
    import hashlib
    import pickle
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.core import flatbuf, signs, votes
    from repro_torch.core.topology import Topology
    from repro_torch.launch.train import run_training

    t_phase = time.perf_counter()
    one = Topology(MESH_P, MESH_D, "cuda")
    # 1. the one-process references
    toy_ref = {cell: mesh_toy_run(torch, one, cell) for cell in MESH_CELLS}
    cfg, built, params, algo, run = mesh_lm_setup(torch, one)
    tokens = mesh_tokens(torch, cfg).cuda()
    g_ref = mesh_lm_grads(torch, built, params, tokens, (MESH_P, MESH_D))
    n_params = g_ref.shape[-1]
    grad_differ, grad_digests = {}, {}
    for q in range(MESH_P):
        for d in range(MESH_D):
            g = mesh_lm_grads(torch, built, params,
                              tokens[q:q + 1, d:d + 1], (1, 1))
            grad_differ[f"{q},{d}"] = int(
                (g[0, 0].view(torch.int16) != g_ref[q, d].view(torch.int16))
                .sum())
            grad_digests[f"{q},{d}"] = hashlib.sha256(
                g.view(torch.int16).cpu().numpy().tobytes()).hexdigest()
            del g
    del g_ref, tokens
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    state, history = run_training(cfg, one, algo, run, params=params,
                                  log=lambda line: None)
    torch.cuda.synchronize()
    ref_s = time.perf_counter() - t1
    n_pad = state.params.layout.n_pad
    lm_ref = {"losses": [h["loss"] for h in history],
              "ms": [h["ms"] for h in history],
              "rows": state.params.buf.cpu().numpy()}      # 3.3 GB, host
    del state, params, built
    torch.cuda.empty_cache()
    u, v = mesh_directions(torch, one, n_pad)
    layout = flatbuf.make_layout({"w": v}, batch_dims=1)
    votes.fused_sign_vote_update(
        layout, {"w": u}, None, 0.0,
        torch.ones((MESH_P, MESH_D), dtype=torch.bool, device="cuda"), v,
        torch.tensor(1e-3, dtype=torch.float32, device="cuda"),
        mu_static=1e-3)
    transport_ref = row_digests(torch, v)
    del u, v
    torch.cuda.empty_cache()
    emit({"mesh": "one-process references", "wall_s": time.perf_counter()
          - t_phase, "lm_run_s": ref_s, "lm_losses": lm_ref["losses"],
          "lm_ms": lm_ref["ms"], "step0_grads_differing_by_block":
          grad_differ, "n_params": n_params, "n_pad": n_pad})
    reckoned = reckon_mesh_peak(n_pad)
    emit({"mesh": "reckoned rank peak", **reckoned})

    # 2. the ranks, with this process holding no tensor on the card
    gc.collect()
    torch.cuda.empty_cache()
    emit({"mesh": "before the ranks",
          "allocated_gb": torch.cuda.memory_allocated() / 1e9,
          "reserved_gb": torch.cuda.memory_reserved() / 1e9,
          "free_gb": torch.cuda.mem_get_info()[0] / 1e9})
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    # the ckpt part's run B keeps MESH_CKPT_KEEP checkpoints of params,
    # delta and delta_next, [P, n_pad] each, f32 on disk
    ckpt_bytes = len(CKPT_SLOTS) * MESH_P * n_pad * 4
    ckpt_root = ROOT / "build" / "mesh_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    ckpt_root.mkdir(parents=True)
    free = shutil.disk_usage(ckpt_root).free
    emit({"mesh": "ckpt disk", "card": card, "dir": str(ckpt_root),
          "free_gb": free / 1e9, "checkpoint_gb_reckoned": ckpt_bytes / 1e9,
          "keep": MESH_CKPT_KEEP})
    require(free >= (MESH_CKPT_KEEP + 1) * ckpt_bytes,
            f"{free / 1e9:.2f} GB free cannot hold {MESH_CKPT_KEEP + 1} "
            f"checkpoints of {ckpt_bytes / 1e9:.2f} GB")
    try:
        with open(pathlib.Path(tmp) / "job.pkl", "wb") as f:
            pickle.dump({"n_pad": n_pad, "parts": ("mesh", "fsdp")
                         if fsdp else ("mesh",),
                         "ckpt_dir": str(ckpt_root)}, f)
        t1 = time.perf_counter()
        ranks = mesh_spawn(torch, tmp)
        ranks_s = time.perf_counter() - t1
        traj = {}
        for q in range(MESH_P):
            row = np.load(pathlib.Path(tmp) / f"lm_row{q}.npy")
            ref = lm_ref["rows"][q]
            traj[q] = {"differing": int((row.view(np.int32)
                                         != ref.view(np.int32)).sum()),
                       "max_abs_diff": float(np.abs(row - ref).max())}
        del lm_ref["rows"]
        t1 = time.perf_counter()
        ckpt_launches = mesh_ckpt_check(torch, card, ckpt_root, tmp, ranks,
                                        ckpt_bytes)
        emit({"mesh": "ckpt part", "parent_s": time.perf_counter() - t1,
              "rank_s": [r["ckpt"]["s"] for r in ranks]})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(ckpt_root, ignore_errors=True)

    # 3. the checks
    for r in ranks:
        require(r["probe"]["int8_sum"] == [10] * 4
                and r["probe"]["int32_sum"] == [40] * 4,
                f"rank {r['rank']}: gloo sums on CUDA tensors {r['probe']}")
    toy_launches = {}
    for cell, ref in toy_ref.items():
        got = ranks[0]["toy"][cell]
        diff = states_differing(ref["state"], got["state"])
        per_rank = [r["toy"][cell]["launches"] for r in ranks]
        # the losses are the model's forward, summed by the card's
        # reductions at the block's shape: not part of the trajectory
        rel = max(abs(a - b) / max(abs(b), 1e-30)
                  for a, b in zip(got["losses"], ref["losses"]))
        emit({"mesh": "toy", "cell": cell, "differing": diff,
              "losses_equal": got["losses"] == ref["losses"],
              "losses_max_rel_diff": rel,
              "launches_per_rank": per_rank,
              "one_process_launches": ref["launches"],
              "rank_s": [r["toy"][cell]["s"] for r in ranks]})
        require(diff == 0, f"mesh toy {cell}: {diff} coordinates differ "
                "from the one-process run")
        require(rel <= 1e-5, f"mesh toy {cell}: losses {got['losses']} "
                f"against the one-process {ref['losses']}")
        for r in ranks:
            require(r["toy"][cell]["losses"] == got["losses"],
                    f"mesh toy {cell}: rank {r['rank']}'s losses differ "
                    "from rank 0's")
        toy_launches[cell] = per_rank
    for name in ("sign_pack", "vote_update", "tally_acc", "ternary_quant"):
        for r in range(len(ranks)):
            require(sum(toy_launches[c][r][name] for c in MESH_CELLS) > 0,
                    f"rank {r} never launched {name} in the toy's cells")
    tr = [r["transport"] for r in ranks]
    emit({"mesh": "transport", "n_pad": n_pad,
          "word_bytes_per_device": tr[0]["word_bytes_per_device"],
          "gathered_shape": tr[0]["gathered_shape"],
          "gather_ms_per_rank": [t["gather_ms"] for t in tr],
          "gather_ms_all": [t["gather_ms_all"] for t in tr],
          "bitwise": all(r["transport"]["digests"][0]
                         == transport_ref[r["coords"][0]] for r in ranks),
          "card": card})
    for r in ranks:
        require(r["transport"]["digests"][0]
                == transport_ref[r["coords"][0]],
                f"rank {r['rank']}: the LM-size fused vote-update differs "
                "from the one-process result")
    lm = [r["lm"] for r in ranks]
    grads_same = all(grad_differ[f"{q},{d}"] == 0 for q in range(MESH_P)
                     for d in range(MESH_D))
    for r in ranks:
        q, d = r["coords"]
        require(r["lm"]["grad_digest"] == grad_digests[f"{q},{d}"],
                f"rank {r['rank']}: its step-0 gradients are not the "
                "[1, 1] block's computed in one process")
    traj_same = all(t["differing"] == 0 for t in traj.values())
    losses = lm[0]["losses"]
    local_mean = statistics.mean(losses[1:])
    local = [[ms for s, ms in enumerate(x["ms"]) if s % MESH_TE]
             for x in lm]
    prologue = [[ms for s, ms in enumerate(x["ms"]) if s % MESH_TE == 0]
                for x in lm]
    words = tr[0]["word_bytes_per_device"]
    emit({"mesh": "lm", "arch": cfg.name, "n_layers": cfg.n_layers,
          "grid": list(MESH_GRID), "P": MESH_P, "D": MESH_D,
          "step0_grads_bitwise": grads_same,
          "step0_grads_differing_by_block": grad_differ,
          "trajectory_bitwise": traj_same,
          "trajectory_differing_by_edge": traj,
          "master_coordinates_per_edge": n_pad,
          "losses": losses, "one_process_losses": lm_ref["losses"],
          "local_steps_mean_loss": local_mean,
          "local_step_ms_per_rank": [statistics.mean(x) for x in local],
          "prologue_step_ms_per_rank": [statistics.mean(x)
                                        for x in prologue],
          "one_process_ms": lm_ref["ms"],
          "data_ms_per_rank": [statistics.mean(x["data_ms"]) for x in lm],
          "launches_per_rank": [x["launches"] for x in lm],
          "traffic_rank0": lm[0]["traffic"],
          "uplink_bits_per_device_round": signs.uplink_bits(
              "dc_hier_signsgd", n_pad, MESH_TE),
          "sign_words_bytes_per_step": words,
          "peak_gb_per_rank": [x["peak_gb"] for x in lm],
          "held_gb_per_rank": [x["held_gb"] for x in lm],
          "reckoned_peak_gb": reckoned["peak_gb"],
          "rank_s": [x["s"] for x in lm], "card": card})
    for x in lm:
        require(all(map(math.isfinite, x["losses"])), "non-finite loss")
        require(x["losses"] == losses, "the ranks' losses differ")
        require(x["launches"] == {"sign_pack": MESH_LM_STEPS,
                                  "vote_update": MESH_LM_STEPS,
                                  "tally_acc": 0, "ternary_quant": 0},
                f"mesh lm launches {x['launches']}")
    require(local_mean < losses[0], f"mesh lm: the loss did not fall: step "
            f"0 {losses[0]}, the local steps' mean {local_mean}")
    if grads_same:
        require(traj_same,
                "mesh lm: the step-0 gradients are bitwise but the "
                "trajectory is not")
    emit({"mesh": "phase", "wall_s": time.perf_counter() - t_phase,
          "ranks_s": ranks_s, "rank_init_s": [r["init_s"] for r in ranks],
          "exchange": [r["exchange"] for r in ranks]})
    return {"toy": toy_launches, "lm": [x["launches"] for x in lm],
            "ckpt": ckpt_launches, "ranks": ranks}


TP_GRID = (2, 2, 2)              # pods x data x model ranks, a [1, 1] block
TP_P, TP_D, TP_M = 2, 2, 2       # the global hierarchy and the model axis
TP_JOIN_S = 600                  # the ranks' join limit
TP_SPECS = {"w": (None, "model"), "b": (None,), "w2": ("model", None)}
TP_CELLS = {     # name -> (AlgoConfig fields, toy hidden width, K or None)
    "dc fused/flat h64": (dict(method="dc_hier_signsgd"), 64, None),
    "dc fused/flat h65": (dict(method="dc_hier_signsgd"), 65, None),
    "hier_sgd fused/flat h64": (dict(method="hier_sgd"), 64, None),
    "hier_local_qsgd fused/flat h65": (dict(method="hier_local_qsgd"), 65,
                                       None),
    "dc fused/flat K=2 stream h65": (dict(method="dc_hier_signsgd"), 65, 2),
}
TP_QSGD_ATOL = 1e-5              # the multi-device parity atol
TP_SEED = 2000                   # the LM-size transport's directions
# step 0's bf16 gradients, gathered over model, against the model=1 run:
# the largest max|a - b| / max|b| of a leaf.  A sound port reads 0.0077-
# 0.0135 at full width on the H100 and 0.030 at gemma3-1b's smoke width
# on the CPU; with sum_model or copy_to_model dropped it reads above 1.1
# (tests/helpers/torch_tp_step0_bound.py).
TP_STEP0_REL = 0.1


def tp_toy_run(torch, topo, cell: str) -> dict:
    """One parity-toy cell over ``topo``'s model axis (or none: the
    one-process [2, 2] reference): ``MESH_STEPS`` steps of the
    injected-gradient toy at the cell's hidden width, ``w`` and ``w2``
    split by ``TP_SPECS`` (``injected_grads.make_tp_bundle``), fused
    transport, flat state, f32.  Returns the gathered logical state
    (numpy trees), the losses, the four kernels' launches in this
    process and the bytes it sent."""
    import injected_grads
    from repro_torch.convert import gather_train_state
    from repro_torch.core import comm, hier, pytree, shardflat
    from repro_torch.core.clients import ClientConfig

    fields, hid, k = TP_CELLS[cell]
    shapes = {"w": (16, hid), "b": (33,), "w2": (hid, 33)}
    cc = ClientConfig()
    if k:
        cc = ClientConfig(count=k, participation="bernoulli", rate=0.5,
                          seed=11, mode="stream", weights=tuple(
                              tuple(tuple((q + 2 * d + 3 * c) % 5 + 1
                                          for c in range(k))
                                    for d in range(TP_D))
                              for q in range(TP_P)))
    algo = hier.AlgoConfig(t_e=MESH_TE, mu=MU, mu_sgd=0.05, rho=RHO,
                           transport="fused", state_layout="flat",
                           compute_dtype=torch.float32,
                           delta_dtype=torch.float32, clients=cc, **fields)
    gen = torch.Generator().manual_seed(5)
    grads = injected_grads.make_grads(shapes, TP_P, TP_D, k or 1,
                                      MESH_STEPS, gen)
    w0 = {n: torch.randn(s, generator=gen) for n, s in shapes.items()}
    ew = torch.tensor([0.375, 0.625])
    dw = torch.tensor([[0.25, 0.75], [0.5, 0.5]])
    mask = torch.ones((TP_P, TP_D) + ((k,) if k else ()))
    init_fn, step = hier.make_hier_step(
        topo, algo, injected_grads.make_tp_bundle(topo, shapes, TP_SPECS))
    state = init_fn(w0)
    layout = shardflat.param_layout(topo, TP_SPECS, w0)
    counters = kernel_counters()
    for kern in counters:
        kern.launches = 0
    comm.reset_traffic()
    losses = []
    for g in grads:
        batch = pytree.tree_map(lambda x: x.to("cuda"), topo.block(g))
        state, metrics = step(state, {"train": batch}, ew, dw, mask)
        losses.append(float(metrics["loss"]))
    launches = dict(zip(("sign_pack", "vote_update", "tally_acc",
                         "ternary_quant"),
                        (kern.launches for kern in counters)))
    sent = {op: v["sent"] for op, v in comm.traffic.items()}
    full = gather_train_state(state, topo, layout=layout, logical=True)
    return {"state": {n: v for n, v in full._asdict().items()
                      if n not in ("rng", "step")},
            "losses": losses, "launches": launches, "sent": sent,
            "shards": layout.shards}


def tp_gemma(torch, topo):
    """gemma3-1b at full width cut to two layers (:func:`two_layer_cut`)
    on ``topo``: (cfg, built, its abstract parameters, their sharded
    layout at ``TP_M``)."""
    from repro_torch.core import flatbuf
    from repro_torch.models import build

    cfg = two_layer_cut()
    built = build.build_model(cfg, topo)
    abstract = built.abstract_params()
    specs = build.compute_specs(build.make_archdef(cfg, TP_M), TP_M)
    layout = flatbuf.make_layout(abstract, sharding=flatbuf.ModelSharding(
        TP_M, "model", specs))
    return cfg, built, abstract, layout


def tp_directions(torch, layout, abstract, pods, devs):
    """The LM-size transport's inputs for edges ``pods`` and devices
    ``devs``, trees of whole logical leaves: leaf i's bf16 directions of
    (q, d) from seed ``TP_SEED + (i*P + q)*D + d``, its f32 master row q
    from ``TP_SEED - 1 - (i*P + q)``."""
    from repro_torch.core import pytree

    def row(seed, shape, dtype):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn(shape, generator=g, device="cuda", dtype=dtype)

    u, v = [], []
    for i, leaf in enumerate(pytree.flatten_up_to(layout.treedef, abstract)):
        shape = tuple(leaf.shape)
        u.append(torch.stack([torch.stack([
            row(TP_SEED + (i * TP_P + q) * TP_D + d, shape, torch.bfloat16)
            for d in devs]) for q in pods]))
        v.append(torch.stack([row(TP_SEED - 1 - (i * TP_P + q), shape,
                                  torch.float32) for q in pods]))
    return (pytree.tree_unflatten(layout.treedef, u),
            pytree.tree_unflatten(layout.treedef, v))


def tp_digest(torch, layout, tree, q: int, m: int,
              local: bool = False) -> str:
    """sha256 of model block m of edge row q of a [P', *leaf] tree of
    logical leaves (each leaf's logical block, in flatten order);
    ``local``: the tree is rank m's own blocks already."""
    import hashlib

    from repro_torch.core import flatbuf, pytree

    h = hashlib.sha256()
    for slot, leaf in zip(layout.slots,
                          pytree.flatten_up_to(layout.treedef, tree)):
        blk = leaf[q]
        if slot.shard_dim is not None:
            if not local:
                blk = flatbuf.slot_block(slot, blk, m, layout.shards)
            blk = blk.narrow(slot.shard_dim, 0,
                             slot.local_extent(layout.shards, m))
        h.update(blk.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def tp_transport(torch, topo, layout, abstract) -> dict:
    """One fused vote-update on gemma3-1b's sharded layout, the rank's
    bucket only (``votes.fused_sign_vote_update`` on its [1, 1] block of
    the seeded directions, its words gathered over the data group, its
    [1, bucket_pad] master updated in place, mu 1e-3): the digest of its
    edge row's logical block and the bytes it sent."""
    from repro_torch.core import comm, flatbuf, shardflat, votes

    m = topo.model_rank
    u, v = tp_directions(torch, layout, abstract, [topo.pod_offset],
                         [topo.device_offset])
    u = shardflat.local_block(topo, layout, u, 2)
    v_buf = shardflat.flatten(topo, layout, shardflat.local_block(
        topo, layout, v, 1), 1)
    del v
    mask = torch.ones((1, TP_D), dtype=torch.bool, device="cuda")
    comm.reset_traffic()
    out = votes.fused_sign_vote_update(
        layout.bucket(), u, None, 0.0, mask, v_buf,
        torch.tensor(1e-3, dtype=torch.float32, device="cuda"),
        mu_static=1e-3, topo=topo)
    torch.cuda.synchronize()
    require(out is v_buf, "the fused vote-update did not update in place")
    sent = {op: x["sent"] for op, x in comm.traffic.items()}
    del u
    local = flatbuf.unflatten_tree(layout.bucket(), out, 1)
    digest = tp_digest(torch, layout, local, 0, m, local=True)
    res = {"digest": digest, "sent": sent,
           "bucket_words": layout.bucket_words,
           "bucket_pad": layout.bucket_pad, "n_pad": layout.n_pad}
    del out, v_buf, local
    torch.cuda.empty_cache()
    return res


def copies_digest(torch, state, layout) -> bytes:
    """sha256 of every copy leaf (no spec splits it) of the master and
    the DC corrections in a rank's flat state."""
    import hashlib

    from repro_torch.core import pytree

    h = hashlib.sha256()
    for slot in (state.params, state.delta, state.delta_next):
        leaves = pytree.flatten_up_to(layout.treedef, slot.tree(cast=False))
        for s, leaf in zip(layout.slots, leaves):
            if s.shard_dim is None:
                h.update(leaf.contiguous().view(torch.uint8).cpu().numpy()
                         .tobytes())
    return h.digest()


def tp_lm_grads(torch, built, params, tokens, topo=None, layout=None):
    """Per-voter gradients of the LM at ``params`` (a rank's blocks with
    ``layout``'s sharding, or the whole tree) on ``tokens`` [1, 1, 1,
    seq], from fresh bf16 [1, 1] copies cut to their logical rows: the
    gradient tree, with each sharded leaf's blocks gathered over the
    model group (tails dropped) when ``topo`` is given, and whether the
    copies' gradients were bitwise the same on every model rank."""
    import torch.distributed as dist

    from repro_torch.core import pytree, shardflat

    leaves, td = pytree.tree_flatten(params)
    copies = [leaf.unsqueeze(0).unsqueeze(0).to(torch.bfloat16)
              .contiguous().requires_grad_(True) for leaf in leaves]
    tree = pytree.tree_unflatten(td, copies)
    if topo is not None:
        tree = shardflat.logical(topo, layout, tree, 2)
    losses = built.bundle.loss(tree, {"tokens": tokens})
    grads = list(torch.autograd.grad(losses.sum(), copies))
    del copies, losses, tree
    agree = True
    if topo is not None:
        for s, g in zip(layout.slots, grads):
            if s.shard_dim is None:
                parts = [torch.empty_like(g) for _ in range(TP_M)]
                dist.all_gather(parts, g.contiguous(),
                                group=topo.mesh.model_group)
                agree &= all(torch.equal(parts[0], x) for x in parts[1:])
        grads = pytree.flatten_up_to(td, shardflat.gather(
            topo, layout, pytree.tree_unflatten(td, grads), 2))
    return grads, bool(agree)


def tp_lm_rank(torch, topo) -> dict:
    """The rank's part of the LM run: step 0's gradients on its [1, 1]
    block tensor-parallel, gathered over the model group, against the
    model=1 run of the same block (model rank 0 takes the latter; the
    differing count and the largest difference over the leaf's largest
    |value|); then ``run_training`` over the ranks (``MESH_LM_STEPS``, DC
    fused/flat) with the counters and ``comm.traffic`` set to 0 just
    before it: its losses, step times, launches, the bytes sent on each
    group at each step, the copies' digest agreement at each step and
    the peak."""
    import torch.distributed as dist

    from repro_torch.core import comm, shardflat
    from repro_torch.core.topology import Topology
    from repro_torch.launch.train import RunCfg, run_training
    from repro_torch.models import build

    cfg, built, abstract, _ = tp_gemma(torch, topo)
    _, _, algo = lm_setup(torch)
    params = built.init_params(torch.Generator(device="cuda").manual_seed(0))
    layout = shardflat.param_layout(topo, built.bundle.specs, params)
    tokens = topo.block(mesh_tokens(torch, cfg)).cuda()
    local = shardflat.local_block(topo, layout, params)
    g_tp, grads_agree = tp_lm_grads(torch, built, local, tokens, topo,
                                    layout)
    del local
    res = {"step0_copies_agree": grads_agree}
    if topo.model_rank == 0:
        plain = build.build_model(cfg, Topology(1, 1, "cuda"))
        g_one, _ = tp_lm_grads(torch, plain, params, tokens)
        differ, worst, n = 0, 0.0, 0
        for a, b in zip(g_tp, g_one):
            differ += int((a.view(torch.int16) != b.view(torch.int16)).sum())
            scale = float(b.float().abs().max())
            worst = max(worst, float((a.float() - b.float()).abs().max())
                        / max(scale, 1e-30))
            n += b.numel()
        res.update(step0_differing=differ, step0_max_rel_diff=worst,
                   step0_coordinates=n)
        del g_one, plain
    del g_tp, tokens
    torch.cuda.empty_cache()
    run = RunCfg(steps=MESH_LM_STEPS, batch_per_device=1, seq_len=LM_SEQ,
                 log_every=1, seed=0)
    counters = kernel_counters()
    for kern in counters:
        kern.launches = 0
    comm.reset_traffic()
    per_step, agree = [], []

    def on_state(step, state):
        torch.cuda.synchronize()
        per_step.append({op: v["sent"] for op, v in comm.traffic.items()})
        digest = torch.tensor(list(copies_digest(torch, state, layout)),
                              dtype=torch.uint8, device="cuda")
        parts = [torch.empty_like(digest) for _ in range(TP_M)]
        dist.all_gather(parts, digest, group=topo.mesh.model_group)
        agree.append(all(torch.equal(parts[0], x) for x in parts[1:]))

    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, history = run_training(cfg, topo, algo, run, params=params,
                                  log=lambda line: None, on_state=on_state)
    torch.cuda.synchronize()
    res.update({
        "losses": [h["loss"] for h in history],
        "ms": [h["ms"] for h in history],
        "data_ms": [h["data_ms"] for h in history],
        "launches": dict(zip(("sign_pack", "vote_update", "tally_acc",
                              "ternary_quant"),
                             (kern.launches for kern in counters))),
        "sent_per_step": per_step, "copies_agree": agree,
        "peak_gb": (torch.cuda.max_memory_allocated() - before) / 1e9,
        "held_gb": before / 1e9, "bucket_pad": layout.bucket_pad,
        "n_pad": layout.n_pad})
    del state, params
    torch.cuda.empty_cache()
    return res


def tp_rank_main(tmp: str, rank: int) -> None:
    """One rank of the ``tp`` phase (``chip_smoke.py --tp-rank RANK
    DIR``): gloo over ``DIR/rdv``, a 2 x 2 x 2 grid on the one card, the
    toy's cells, the LM-size transport and the LM run; writes
    ``DIR/rank{RANK}.pkl``."""
    import os
    import pickle

    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests" / "helpers"))
    from repro_torch.core.topology import resolve_device
    from repro_torch.launch import mesh
    from repro_torch.kernels import build

    resolve_device("cuda")
    build.load()
    d = pathlib.Path(tmp)
    with open(d / "job.pkl", "rb") as f:
        job = pickle.load(f)
    t0 = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"file://{d / 'rdv'}",
                            rank=rank, world_size=math.prod(TP_GRID),
                            timeout=mesh.TIMEOUT)
    topo = rank_topology(mesh, TP_GRID)
    m = topo.mesh
    res = {"rank": rank, "coords": (m.pod_rank, m.data_rank, m.model_rank),
           "init_s": time.perf_counter() - t0,
           "exchange": exchange_info(topo)}
    if "tp" in job["parts"]:
        tp_rank_work(torch, topo, res)
    if "fsdp" in job["parts"]:
        t1 = time.perf_counter()
        res["fsdp_tp"] = fsdp_tp_rank(torch, topo, job.get("fsdp_ckpt"))
        res["fsdp_tp_s"] = time.perf_counter() - t1
    masters = {}
    if "fam" in job["parts"]:
        t1 = time.perf_counter()
        res["fam_tp"], masters = tp_fam_rank(torch, topo)
        res["fam_tp_s"] = time.perf_counter() - t1
    if "serve" in job["parts"]:
        res["serve_tp"] = tp_serve_rank(torch, topo, job["trees"], masters)
    masters = {}
    if "moe" in job["parts"]:
        res["moe_tp"], masters = tp_moe_rank(torch, topo, job["trees"])
    if "shards" in job["parts"]:
        res["shards_tp"] = tp_shards_rank(torch, topo, job["trees"], masters)
    del masters
    with open(d / f"rank{rank}.tmp", "wb") as f:
        pickle.dump(res, f)
    os.replace(d / f"rank{rank}.tmp", d / f"rank{rank}.pkl")
    dist.barrier()
    dist.destroy_process_group()


def tp_rank_work(torch, topo, res: dict) -> None:
    """The tp phase's own part of a rank's run, into ``res``."""
    import torch.distributed as dist

    m = topo.mesh
    rank = m.rank
    # does gloo sum a bf16 CUDA tensor?  (comm's model sums cross as
    # float32 either way)
    x = torch.full((4,), 0.5 * (rank + 1), dtype=torch.bfloat16,
                   device="cuda")
    try:
        dist.all_reduce(x, group=m.model_group)
        res["bf16_all_reduce"] = x.tolist()
    except RuntimeError as e:
        res["bf16_all_reduce"] = f"refused: {e}"[:200]
    res["toy"] = {}
    for cell in TP_CELLS:
        t1 = time.perf_counter()
        out = tp_toy_run(torch, topo, cell)
        out["s"] = time.perf_counter() - t1
        if rank:
            del out["state"]
        res["toy"][cell] = out
    t1 = time.perf_counter()
    _, _, abstract, layout = tp_gemma(torch, topo)
    res["transport"] = tp_transport(torch, topo, layout, abstract)
    res["transport"]["s"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    res["lm"] = tp_lm_rank(torch, topo)
    res["lm"]["s"] = time.perf_counter() - t1


def fsdp_ckpt_check(torch, card: str, root, ranks: list,
                    ckpt_bytes: int) -> list:
    """The parent's half of the tp phase's FSDP checkpoint (item 17e),
    once the ranks have joined: the 2 x 2 x 2 ranks' final FSDP state
    restored into one process (P=2 x D=2 on the card, M = 1, data 1: the
    masters whole), each rank's shard of every leaf of each slot cut from
    it (``hier.fsdp_index``, the model block by ``flatbuf.slot_block``)
    and held against the digest the rank printed of its own; the ranks'
    save readings and the checks (one line ``{"tp": "fsdp ckpt",
    ...}``).  Returns the ranks' launches in that run."""
    from repro_torch.checkpoint import store
    from repro_torch.core import device_axis, flatbuf, hier, pytree
    from repro_torch.core.topology import ProcessMesh, Topology
    from repro_torch.models import build

    steps = store.available_steps(root)
    require(steps == [FSDP_TP_STEPS], f"tp fsdp ckpt: the store holds steps "
            f"{steps}")
    pods, data, model = TP_GRID
    one = Topology(pods, data, "cuda")
    cfg, _, abstract, layout = tp_gemma(torch, one)
    cfg = dataclasses.replace(cfg, param_mode="fsdp")
    _, _, algo = lm_setup(torch, state_layout="tree")
    built = build.build_model(cfg, one)
    init_fn, _ = hier.make_hier_step(one, algo, built.bundle)
    like = init_fn(built.init_params(torch.Generator(
        device="cuda").manual_seed(0)), 0)
    del built
    t0 = time.perf_counter()
    state = store.restore(root, FSDP_TP_STEPS, like)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del like
    differ = {}
    for r in ranks:
        a, b, m = r["coords"]
        topo_r = Topology(pods, data, "cuda", mesh=ProcessMesh(
            pods=pods, data=data, pod_rank=a, data_rank=b, pod_group=None,
            data_group=None, backend="gloo", model=model, model_rank=m))
        specs = build.build_model(cfg, topo_r).bundle.master_specs
        names, cuts = [], []
        for name in r["fsdp_tp"]["ckpt"]["digests"]:
            leaves, td = pytree.tree_flatten(getattr(state, name))
            for i, (x, spec, slot) in enumerate(zip(
                    leaves, pytree.flatten_up_to(td, specs), layout.slots)):
                x = x[hier.fsdp_index(topo_r, spec, tuple(x.shape))]
                if slot.shard_dim not in (None, device_axis.data_dim(spec)):
                    x = flatbuf.slot_block(slot, x, m, layout.shards, 1)
                names.append((name, i))
                cuts.append(x)
        want = r["fsdp_tp"]["ckpt"]["digests"]
        differ[f"{a},{b},{m}"] = [
            f"{name}[{i}]" for (name, i), got in zip(names,
                                                     digests(torch, cuts))
            if got != want[name][i]]
    del state
    torch.cuda.empty_cache()
    ck = [r["fsdp_tp"]["ckpt"] for r in ranks]
    launches = [r["fsdp_tp"]["launches"] for r in ranks]
    emit({"tp": "fsdp ckpt", "card": card, "grid": list(TP_GRID),
          "checkpoint_gb_reckoned_at_most": ckpt_bytes / 1e9,
          "bytes": [e.get("bytes") for e in ck[0]["events"]],
          "submit_s_per_rank": [[x["s"] for x in c["saves"]] for c in ck],
          "save_s_writer": [e.get("save_s") for e in ck[0]["events"]],
          "device_growth_gb_per_rank": [[x["growth_gb"] for x in c["saves"]]
                                        for c in ck],
          "block_gb_per_rank": [c["block_gb"] for c in ck],
          "sent_gb_per_rank": [c["traffic"]["sent"] / 1e9 for c in ck],
          "writer_received_gb": ck[0]["traffic"]["received"] / 1e9,
          "host_growth_gb_per_rank": [[x["host_growth_gb"]
                                       for x in c["saves"]] for c in ck],
          "one_process_restore_s": restore_s,
          "launches_per_rank": launches,
          "shards_differing": differ})
    for c in ck:
        require([e["event"] for e in c["events"]] == ["save"],
                f"tp fsdp ckpt: events {c['events']}")
        for x in c["saves"]:
            require(x["growth_gb"] <= c["block_gb"],
                    f"tp fsdp ckpt: a save grew the card's memory by "
                    f"{x['growth_gb']} GB, more than the rank's block "
                    f"{c['block_gb']} GB")
    require(all(not v for v in differ.values()),
            f"tp fsdp ckpt: shards differ from the one-process restore: "
            f"{differ}")
    for x in launches:
        require(x["sign_pack"] > 0 and x["vote_update"] > 0,
                f"tp fsdp ckpt: launches {x}")
    return launches


def tp_spawn(torch, tmp: str, meanwhile=None) -> list:
    """Start the eight ranks on the card and wait for them at most
    ``TP_JOIN_S`` seconds (``mesh_spawn``'s rules)."""
    return mesh_spawn(torch, tmp, world=math.prod(TP_GRID), flag="--tp-rank",
                      limit=TP_JOIN_S, meanwhile=meanwhile)


def states_max_abs(want: dict, got: dict) -> float:
    """The largest |difference| between two gathered logical states."""
    import numpy as np

    worst = 0.0
    for name, w in want.items():
        if w is None:
            continue
        for k in w:
            worst = max(worst, float(np.abs(np.asarray(got[name][k])
                                            - np.asarray(w[k])).max()))
    return worst


def tp_references(torch) -> dict:
    """The ``tp`` part's one-process references, run here before the
    ranks and freed: the toy's cells and the fused vote-update on
    gemma3-1b's sharded layout (its blocks' digests), and the rank's
    reckoned peak."""
    from repro_torch.core import flatbuf, votes
    from repro_torch.core.topology import Topology

    t0 = time.perf_counter()
    one = Topology(TP_P, TP_D, "cuda")
    toy_ref = {cell: tp_toy_run(torch, one, cell) for cell in TP_CELLS}
    cfg, _, abstract, layout = tp_gemma(torch, one)
    u, v = tp_directions(torch, layout, abstract, range(TP_P), range(TP_D))
    flat = flatbuf.make_layout(v, batch_dims=1)
    v_buf = flatbuf.flatten_tree(flat, v, 1)
    del v
    votes.fused_sign_vote_update(
        flat, u, None, 0.0,
        torch.ones((TP_P, TP_D), dtype=torch.bool, device="cuda"), v_buf,
        torch.tensor(1e-3, dtype=torch.float32, device="cuda"),
        mu_static=1e-3)
    del u
    done = flatbuf.unflatten_tree(flat, v_buf, 1)
    transport_ref = {(q, m): tp_digest(torch, layout, done, q, m)
                     for q in range(TP_P) for m in range(TP_M)}
    del done, v_buf
    n_params = layout.n
    reckoned = reckon_mesh_peak(layout.bucket_pad, vocab=cfg.vocab // TP_M)
    emit({"tp": "one-process references", "wall_s": time.perf_counter()
          - t0, "n_params": n_params, "n_pad": layout.n_pad,
          "bucket_pad": layout.bucket_pad, "unsharded_n_pad": flat.n_pad,
          "copies": [int(s.size) for s in layout.slots
                     if s.shard_dim is None]})
    emit({"tp": "reckoned rank peak", **reckoned})
    return {"toy": toy_ref, "transport": transport_ref, "cfg": cfg,
            "n_params": n_params, "reckoned": reckoned}


def phase_tp(torch, card: str,
             parts: tuple = ("tp", "fam", "moe", "serve", "shards")) -> dict:
    """The model axis across processes on the one card: 8 ranks (2 pods
    x 2 data x 2 model) over gloo, each a [1, 1] block of P=2 x D=2 and
    one model shard.  The one-process references run here first and
    are freed (:func:`tp_references`); then the ranks, each running the
    ``parts`` named: ``"tp"`` -- the parity toy's cells (w column-, w2
    row-parallel) on logical coordinates against the one-process run
    with the four kernels counted in every rank; one fused vote-update
    on gemma3-1b's sharded layout, each rank's bucket bitwise the one
    process's block; gemma3-1b (2 layers, full width) ``MESH_LM_STEPS``
    steps of ``run_training`` tensor-parallel over the ranks
    (:func:`tp_report`); ``"fsdp"`` -- gemma3-1b in the FSDP regime
    against the replicated one (:func:`fsdp_tp_rank`, checked by
    ``fsdp_mesh_report``); ``"fam"`` -- xlstm-350m, zamba2-2.7b and
    whisper-base at their published widths, tensor-parallel: step 0's
    gradients against one process and the replicated regime's prologue
    and a local step (:func:`tp_fam_rank`, :func:`tp_fam_report`);
    ``"moe"`` -- deepseek-v3 and internvl2 at their published widths,
    tensor-parallel: step 0's gradients against one process and 2 steps
    in the FSDP regime (:func:`tp_moe_rank`, :func:`tp_moe_report`),
    their seed-0 trees written once to git-ignored ``build/`` files
    that every rank maps; ``"serve"`` (with ``"fam"``; run after it and
    before ``"moe"``) -- serving over the model axis (item 17d, part
    one): xlstm-350m, zamba2-2.7b and whisper-base from the masters the
    fam part trained, gemma3-1b whole, deepseek-v3 and internvl2 from
    such trees, each held against one process's serve
    (:func:`tp_serve_rank`, :func:`tp_serve_report`); ``"shards"`` (with
    ``"moe"``) -- serving from the data ranks' shards (item 17d, part
    two): deepseek-v3 and internvl2 in the gather layout from the FSDP
    state the moe part leaves, and one request on a cache split by
    length over the data ranks (gemma3-1b at long_500k's 524288, and
    gemma3-1b and zamba2-2.7b across a block boundary), each held against
    one process's serve (:func:`tp_shards_gather`,
    :func:`tp_shards_len`, :func:`tp_shards_report`).  Returns the
    per-rank launches of each part and the ranks' results
    (``"ranks"``)."""
    import gc
    import pickle
    import shutil
    import tempfile

    require("serve" not in parts or "fam" in parts,
            "the tp phase's serve part serves the masters its fam part "
            "trains")
    require("shards" not in parts or "moe" in parts,
            "the tp phase's shards part serves the FSDP state its moe part "
            "trains")
    t_phase = time.perf_counter()
    refs = tp_references(torch) if "tp" in parts else None
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    (ROOT / "build").mkdir(exist_ok=True)
    trees = pathlib.Path(tempfile.mkdtemp(prefix="tp_params_",
                                          dir=ROOT / "build"))

    cells = {**(tp_moe_cells() if {"moe", "serve"} & set(parts) else {}),
             **({"gemma3-1b": tp_serve_cells()["gemma3-1b"]}
                if {"serve", "shards"} & set(parts) else {}),
             **({"zamba2-2.7b": tp_fam_cells()["zamba2-2.7b"][0]}
                if "shards" in parts else {})}

    def write_trees():
        # while the ranks run their earlier parts; they wait for "ready"
        written = tp_write_params(torch, trees, cells)
        (trees / "ready").touch()
        emit({"tp": "parameters written", "card": card, **written})

    ckpt_root = ROOT / "build" / "tp_fsdp_ckpt"
    shutil.rmtree(ckpt_root, ignore_errors=True)
    job = {"parts": tuple(parts), "trees": str(trees)}
    if "fsdp" in parts:
        # the FSDP run's one save: at most params, delta and delta_next,
        # [P, *leaf] each, f32 on disk
        from repro_torch.core import pytree
        from repro_torch.core.topology import Topology

        abstract = tp_gemma(torch, Topology(TP_GRID[0], TP_GRID[1],
                                            "cuda"))[2]
        n = sum(x.numel() for x in pytree.tree_flatten(abstract)[0])
        ckpt_bytes = len(CKPT_SLOTS) * TP_GRID[0] * n * 4
        ckpt_root.mkdir(parents=True)
        free = shutil.disk_usage(ckpt_root).free
        emit({"tp": "fsdp ckpt disk", "card": card, "dir": str(ckpt_root),
              "free_gb": free / 1e9,
              "checkpoint_gb_reckoned_at_most": ckpt_bytes / 1e9})
        require(free >= 2 * ckpt_bytes, f"{free / 1e9:.2f} GB free cannot "
                f"hold 2 checkpoints of {ckpt_bytes / 1e9:.2f} GB")
        job["fsdp_ckpt"] = str(ckpt_root)
    fsdp_ckpt = None
    try:
        emit({"tp": "before the ranks",
              "allocated_gb": torch.cuda.memory_allocated() / 1e9,
              "free_gb": torch.cuda.mem_get_info()[0] / 1e9})
        with open(pathlib.Path(tmp) / "job.pkl", "wb") as f:
            pickle.dump(job, f)
        t1 = time.perf_counter()
        ranks = tp_spawn(torch, tmp, write_trees if cells else None)
        ranks_s = time.perf_counter() - t1
        if "fsdp" in parts:
            t1 = time.perf_counter()
            fsdp_ckpt = fsdp_ckpt_check(torch, card, ckpt_root, ranks,
                                        ckpt_bytes)
            emit({"tp": "fsdp ckpt part",
                  "parent_s": time.perf_counter() - t1,
                  "rank_s": [r["fsdp_tp_s"] for r in ranks]})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(trees, ignore_errors=True)
        shutil.rmtree(ckpt_root, ignore_errors=True)
    out = {"ranks": ranks}
    if fsdp_ckpt is not None:
        out["fsdp_ckpt"] = fsdp_ckpt
    if "tp" in parts:
        out.update(tp_report(torch, card, ranks, refs))
    if "moe" in parts:
        out["moe"] = tp_moe_report(torch, card, ranks)
    if "fam" in parts:
        out["fam"] = tp_fam_report(torch, card, ranks)
        emit({"tp": "fam part", "rank_s": [r["fam_tp_s"] for r in ranks]})
    if "serve" in parts:
        tp_serve_report(torch, card, ranks)
        out["serve"] = {name: [r["serve_tp"][name]["launches"]
                               for r in ranks]
                        for name in tp_serve_cells()}
    if "shards" in parts:
        out["shards"] = tp_shards_report(torch, card, ranks)
    emit({"tp": "phase", "parts": list(parts),
          "wall_s": time.perf_counter() - t_phase, "ranks_s": ranks_s,
          "rank_init_s": [r["init_s"] for r in ranks],
          "exchange": [r["exchange"] for r in ranks]})
    return out


def tp_report(torch, card: str, ranks: list, refs: dict) -> dict:
    """The ``tp`` part's checks, from the ranks' results and
    :func:`tp_references`: the toy's cells against one process (bitwise,
    QSGD within ``TP_QSGD_ATOL``), every kernel launched in every rank,
    the vote-update's buckets bitwise, gemma3-1b's losses, copies, step
    0's gradients under ``TP_STEP0_REL`` and its launches.  Returns the
    per-rank launches of the toy's cells and of the LM run."""
    from repro_torch.core import signs

    toy_ref, transport_ref = refs["toy"], refs["transport"]
    cfg, n_params, reckoned = refs["cfg"], refs["n_params"], refs["reckoned"]
    emit({"tp": "gloo bf16 all_reduce on CUDA tensors",
          "per_rank": [r["bf16_all_reduce"] for r in ranks]})
    toy_launches = {}
    for cell, ref in toy_ref.items():
        got = ranks[0]["toy"][cell]
        diff = states_differing(ref["state"], got["state"])
        worst = states_max_abs(ref["state"], got["state"])
        per_rank = [r["toy"][cell]["launches"] for r in ranks]
        qsgd = "qsgd" in cell
        rel = max(abs(a - b) / max(abs(b), 1e-30)
                  for a, b in zip(got["losses"], ref["losses"]))
        emit({"tp": "toy", "cell": cell, "shards": got["shards"],
              "differing": diff, "max_abs_diff": worst,
              "losses_equal": got["losses"] == ref["losses"],
              "losses_max_rel_diff": rel,
              "launches_per_rank": per_rank,
              "one_process_launches": ref["launches"],
              "sent_rank0": got["sent"],
              "rank_s": [r["toy"][cell]["s"] for r in ranks]})
        require(got["shards"] == TP_M, f"tp toy {cell}: not sharded")
        if qsgd:
            require(worst <= TP_QSGD_ATOL, f"tp toy {cell}: {worst} from "
                    "the one-process run")
        else:
            require(diff == 0, f"tp toy {cell}: {diff} coordinates differ "
                    "from the one-process run")
        # the losses are the injected forward's sums, run by the card's
        # reductions at the block's shape: held at 1e-5 (as in ``mesh``)
        require(rel <= 1e-5, f"tp toy {cell}: losses {got['losses']} "
                f"against {ref['losses']}")
        for r in ranks:
            require(r["toy"][cell]["losses"] == got["losses"],
                    f"tp toy {cell}: rank {r['rank']}'s losses differ")
        toy_launches[cell] = per_rank
    for name in ("sign_pack", "vote_update", "tally_acc", "ternary_quant"):
        for r in range(len(ranks)):
            require(sum(toy_launches[c][r][name] for c in TP_CELLS) > 0,
                    f"rank {r} never launched {name} in the toy's cells")
    tr = [r["transport"] for r in ranks]
    emit({"tp": "transport", "n_pad": tr[0]["n_pad"],
          "bucket_pad": tr[0]["bucket_pad"],
          "word_bytes_sent_per_rank": [t["sent"]["gather_devices"]
                                       for t in tr],
          "four_bucket_words": 4 * tr[0]["bucket_words"],
          "model_group_bytes_per_rank": [
              sum(t["sent"][op] for op in ("sum_model", "copy_to_model",
                                           "max_model", "gather_model"))
              for t in tr],
          "bitwise": all(r["transport"]["digest"]
                         == transport_ref[(r["coords"][0], r["coords"][2])]
                         for r in ranks),
          "rank_s": [t["s"] for t in tr], "card": card})
    for r in ranks:
        require(r["transport"]["digest"]
                == transport_ref[(r["coords"][0], r["coords"][2])],
                f"rank {r['rank']}: its bucket of the fused vote-update "
                "differs from the one-process block")
        require(r["transport"]["sent"]["gather_devices"]
                == 4 * r["transport"]["bucket_words"],
                f"rank {r['rank']}: sent {r['transport']['sent']}")
    lm = [r["lm"] for r in ranks]
    losses = lm[0]["losses"]
    local_mean = statistics.mean(losses[1:])
    local = [[ms for s, ms in enumerate(x["ms"]) if s % MESH_TE] for x in lm]
    prologue = [[ms for s, ms in enumerate(x["ms"]) if s % MESH_TE == 0]
                for x in lm]

    def group_bytes(sent, ops):
        return sum(sent[op] for op in ops)

    groups = {"data": ("gather_devices", "sum_devices"),
              "pod": ("gather_pods",),
              "model": ("sum_model", "copy_to_model", "max_model",
                        "gather_model")}
    sent = []
    for x in lm:
        steps = [dict(x["sent_per_step"][0])] + [
            {op: b[op] - a[op] for op in b}
            for a, b in zip(x["sent_per_step"], x["sent_per_step"][1:])]
        sent.append({g: {"local_step": group_bytes(steps[1], ops),
                         "prologue_step": group_bytes(steps[0], ops),
                         "round": sum(group_bytes(s, ops)
                                      for s in steps[:MESH_TE])}
                     for g, ops in groups.items()})
    step0 = [x for x in lm if "step0_differing" in x]
    emit({"tp": "lm", "arch": cfg.name, "n_layers": cfg.n_layers,
          "grid": list(TP_GRID), "P": TP_P, "D": TP_D, "M": TP_M,
          "n_params": n_params, "bucket_pad": lm[0]["bucket_pad"],
          "step0_differing": [x["step0_differing"] for x in step0],
          "step0_coordinates": step0[0]["step0_coordinates"],
          "step0_max_rel_diff": [x["step0_max_rel_diff"] for x in step0],
          "step0_copies_agree": all(x["step0_copies_agree"] for x in lm),
          "copies_agree_every_step": [all(x["copies_agree"][s] for x in lm)
                                      for s in range(len(losses))],
          "losses": losses, "local_steps_mean_loss": local_mean,
          "local_step_ms_per_rank": [statistics.mean(x) for x in local],
          "prologue_step_ms_per_rank": [statistics.mean(x)
                                        for x in prologue],
          "data_ms_per_rank": [statistics.mean(x["data_ms"]) for x in lm],
          "launches_per_rank": [x["launches"] for x in lm],
          "bytes_sent_per_rank": sent,
          "uplink_bits_per_device_round": signs.uplink_bits(
              "dc_hier_signsgd", lm[0]["bucket_pad"], MESH_TE),
          "peak_gb_per_rank": [x["peak_gb"] for x in lm],
          "held_gb_per_rank": [x["held_gb"] for x in lm],
          "reckoned_peak_gb": reckoned["peak_gb"],
          "rank_s": [x["s"] for x in lm], "card": card})
    for x in lm:
        require(all(map(math.isfinite, x["losses"])), "non-finite loss")
        require(x["losses"] == losses, "the ranks' losses differ")
        require(all(x["copies_agree"]) and x["step0_copies_agree"],
                "tp lm: a copy leaf differs across the model group")
        require(x["launches"] == {"sign_pack": MESH_LM_STEPS,
                                  "vote_update": MESH_LM_STEPS,
                                  "tally_acc": 0, "ternary_quant": 0},
                f"tp lm launches {x['launches']}")
    require(local_mean < losses[0], f"tp lm: the loss did not fall: step 0 "
            f"{losses[0]}, the local steps' mean {local_mean}")
    for x in step0:
        require(x["step0_max_rel_diff"] <= TP_STEP0_REL,
                f"tp lm: step 0's gradients {x['step0_max_rel_diff']} of a "
                f"leaf's scale from the model=1 run's (limit {TP_STEP0_REL})")
    require(len(step0) == TP_P * TP_D, "tp lm: a block's step-0 check "
            "is missing")
    return {"toy": toy_launches, "lm": [x["launches"] for x in lm]}


# -- the FSDP regime across processes (ROADMAP item 17c) ------------------------

FSDP_MESH_STEPS = 2              # gemma3-12b over the mesh ranks: the
                                 # prologue and a local step (a gloo
                                 # prologue costs 3.8 local steps); step
                                 # 1's loss below step 0's
FSDP_MESH_MASK = ((1.0, 0.0), (0.0, 0.0))   # the lift check: pod 0's
                                 # device 1 dropped, pod 1's quorum empty
FSDP_MESH_SHARES = ((0.25, 0.75), (0.5, 0.5))
FSDP_MESH_SEED = 3000            # the lift check's seeded inputs
FSDP_TP_STEPS = 3                # gemma3-1b FSDP vs replicated, 8 ranks
KERNEL_NAMES = ("sign_pack", "vote_update", "tally_acc", "ternary_quant")


def counted_launches() -> dict:
    return dict(zip(KERNEL_NAMES, (k.launches for k in kernel_counters())))


def zero_launches() -> None:
    for kern in kernel_counters():
        kern.launches = 0


def fsdp_mesh_model(topo):
    """(cfg, built): gemma3-12b at full width cut to two layers
    (:func:`two_layer_cut`), in the FSDP regime on ``topo`` (its master
    specs at topo's D)."""
    from repro_torch.models import build

    cfg = dataclasses.replace(two_layer_cut(FSDP_ARCH), param_mode="fsdp")
    return cfg, build.build_model(cfg, topo)


def fsdp_lift_leaves(built) -> list:
    """(name, shape, master spec) of every leaf of a gemma3-12b local
    layer and of its tied table: the shapes the lift's vote gets."""
    from repro_torch.core import pytree
    from repro_torch.models import build

    abstract = built.abstract_params()
    mspecs = built.bundle.master_specs
    local = abstract["stacks"]["local"]
    specs = pytree.flatten_up_to(pytree.tree_flatten(local)[1],
                                 build.layer_specs(built.arch,
                                                   mspecs)["local"])
    out = [(f"stacks.local.{name}", tuple(leaf.shape[1:]), spec)
           for (name, leaf), spec in zip(pytree_items(local), specs)]
    out.append(("embed.table", tuple(abstract["embed"]["table"].shape),
                mspecs["embed"]["table"]))
    return out


def fsdp_row(torch, seed: int, shape, dtype, device):
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=device, dtype=dtype)


def synchronize(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def fsdp_lift_rank(torch, topo) -> list:
    """The lift across the ranks at gemma3-12b's leaf shapes
    (:func:`fsdp_lift_leaves`), fused (rho 0.2) and wmean, bf16
    cotangents drawn from seeds (row (q, d) of a leaf from its own
    seed, so every rank draws the global inputs' rows it needs), under
    FSDP_MESH_MASK: the rank's shard of the master lifted
    (``device_axis.fsdp_lift``), its forward's copies held against its
    block of the master, its backward run on its voters' cotangents
    with the kernels' counters at 0 just before it; then the
    one-process lift (no mesh) on the same coordinates of all D voters
    of the rank's edges -- the lift is coordinatewise, so that is the
    one-process direction's slice -- and the coordinates where the two
    differ."""
    from repro_torch.core import comm, device_axis

    _, built = fsdp_mesh_model(topo)
    dev = topo.device
    p, dl, d = topo.local_pods, topo.local_devices, topo.devices_per_pod
    pods = range(topo.pod_offset, topo.pod_offset + p)
    mine = range(topo.device_offset, topo.device_offset + dl)
    maskf = torch.tensor(FSDP_MESH_MASK, device=dev)[topo.pod_rows]
    devwf = torch.tensor(FSDP_MESH_SHARES, device=dev)[topo.pod_rows]
    rows = []
    for i, (name, shape, spec) in enumerate(fsdp_lift_leaves(built)):
        dim = device_axis.data_dim(spec)
        seed = FSDP_MESH_SEED + 1000 * i

        def cot(q, dv):
            return fsdp_row(torch, seed + 10 * q + dv + 1, shape,
                            torch.bfloat16, dev)

        for transport in ("fused", "wmean"):
            rho = RHO if transport == "fused" else 0.0
            w = torch.stack([fsdp_row(torch, seed - 1 - q, shape,
                                      torch.float32, dev) for q in pods])
            w_sh = device_axis.shard(w, dim, topo).contiguous()
            w_sh.requires_grad_(True)
            copy = w.to(torch.bfloat16)
            del w
            delta = torch.stack([fsdp_row(torch, seed - 5 - q, shape,
                                          torch.bfloat16, dev) for q in pods])
            d_sh = device_axis.shard(delta, dim, topo).contiguous()
            del delta
            g = torch.stack([torch.stack([cot(q, dv) for dv in mine])
                             for q in pods])
            cfg = device_axis.LiftCfg(devices=dl, transport=transport,
                                      rho=rho, compute_dtype=torch.bfloat16,
                                      topo=topo)
            zero_launches()
            comm.reset_traffic()
            synchronize(torch, dev)
            t0 = time.perf_counter()
            out = device_axis.fsdp_lift(cfg, w_sh, d_sh, spec, maskf=maskf,
                                        devwf=devwf)
            synchronize(torch, dev)
            t1 = time.perf_counter()
            copies_ok = bool(torch.equal(out, copy.unsqueeze(1).expand_as(
                out)))
            del copy
            out.backward(g)
            synchronize(torch, dev)
            t2 = time.perf_counter()
            launches, sent = counted_launches(), comm.group_bytes()
            del out, g
            got = w_sh.grad
            g_all = torch.stack([torch.stack([
                device_axis.shard(cot(q, dv), dim, topo, 0).contiguous()
                for dv in range(d)]) for q in pods])
            want = device_axis.lift_direction(
                device_axis.LiftCfg(devices=d, transport=transport, rho=rho,
                                    compute_dtype=torch.bfloat16),
                g_all, d_sh, maskf, devwf).to(torch.float32)
            differ = int((got.view(torch.int32) != want.view(torch.int32))
                         .sum())
            rows.append({"leaf": name, "shape": list(shape),
                         "spec": [str(e) for e in spec],
                         "shard": list(w_sh.shape[1:]),
                         "transport": transport, "differing": differ,
                         "coordinates": got.numel(), "copies_ok": copies_ok,
                         "launches": launches, "data_sent": sent["data"],
                         "forward_ms": 1e3 * (t1 - t0),
                         "backward_ms": 1e3 * (t2 - t1)})
            del w_sh, d_sh, got, want, g_all
            if dev.type == "cuda":
                torch.cuda.empty_cache()
    return rows


def fsdp_mesh_lm_rank(torch, topo) -> dict:
    """The rank's part of gemma3-12b (2 layers, full width) in the FSDP
    regime over the mesh: ``run_training`` for FSDP_MESH_STEPS steps (DC,
    mu 1e-3, rho 0.2, T_E=3, bf16 compute, f32 master, bf16 delta,
    fused, tree, 1 x FSDP_SEQ tokens a device) with the kernels'
    counters and ``comm.traffic`` at 0 just before it: its losses, step
    times, launches, each group's bytes at each step, the bytes of its
    master and corrections, and its peak above what it held."""
    from repro_torch.core import comm, hier, pytree
    from repro_torch.launch.train import RunCfg, run_training

    cfg, _ = fsdp_mesh_model(topo)
    algo = hier.AlgoConfig(method="dc_hier_signsgd", mu=1e-3, rho=RHO,
                           t_e=LM_TE, transport="fused", state_layout="tree",
                           compute_dtype=torch.bfloat16,
                           master_dtype=torch.float32,
                           delta_dtype=torch.bfloat16)
    run = RunCfg(steps=FSDP_MESH_STEPS, batch_per_device=1,
                 seq_len=FSDP_SEQ, log_every=1, seed=0)
    per_step, held = [], {}

    def on_state(step, state):
        per_step.append(comm.group_bytes())
        if not held:
            held.update({name: sum(x.numel() * x.element_size() for x in
                                   pytree.tree_flatten(getattr(state,
                                                               name))[0])
                         for name in ("params", "delta", "delta_next")})

    zero_launches()
    comm.reset_traffic()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, history = run_training(cfg, topo, algo, run,
                                  log=lambda line: None, on_state=on_state)
    torch.cuda.synchronize()
    res = {"losses": [h["loss"] for h in history],
           "ms": [h["ms"] for h in history],
           "data_ms": [h["data_ms"] for h in history],
           "launches": counted_launches(),
           "bytes_per_step": [per_step[0]] + [
               {g: {k: b[g][k] - a[g][k] for k in b[g]} for g in b}
               for a, b in zip(per_step, per_step[1:])],
           "held_bytes": held,
           "peak_gb": (torch.cuda.max_memory_allocated() - before) / 1e9,
           "held_gb": before / 1e9}
    del state
    torch.cuda.empty_cache()
    return res


def fsdp_tp_rank(torch, topo, ckpt_dir: str | None = None) -> dict:
    """gemma3-1b (2 layers, full width) over the tp phase's ranks (2 pods
    x 2 data x 2 model) from the same parameters and tokens: FSDP_TP_STEPS
    steps of the replicated regime (ag_packed/tree), then of the FSDP
    regime (fused/tree, its launches counted), and the coordinates where
    the rank's FSDP shard of each master differs from the same shard of
    its replicated block (so every coordinate is counted once over the
    ranks).  With ``ckpt_dir`` (item 17e) the FSDP run saves its final
    state there (the mesh checkpoint, one file), each save's seconds and
    device growth measured, and the rank's shard of every leaf of each
    slot comes back as a digest (``"ckpt"``)."""
    from repro_torch.core import comm, device_axis, pytree
    from repro_torch.launch.train import RunCfg, run_training
    from repro_torch.models import build

    cfg, _, _, _ = tp_gemma(torch, topo)
    _, _, algo = lm_setup(torch, state_layout="tree")
    cfg_f = dataclasses.replace(cfg, param_mode="fsdp")
    run = RunCfg(steps=FSDP_TP_STEPS, batch_per_device=1, seq_len=LM_SEQ,
                 log_every=1, seed=0)
    built_f = build.build_model(cfg_f, topo)
    params = built_f.init_params(torch.Generator(
        device=topo.device).manual_seed(0))
    repl, hr = run_training(cfg, topo, dataclasses.replace(
        algo, transport="ag_packed"), run, params=params,
        log=lambda line: None)
    zero_launches()
    comm.reset_traffic()
    events, saves = [], []
    with save_meter(torch, saves):
        fsdp, hf = run_training(
            cfg_f, topo, algo, dataclasses.replace(run, ckpt_dir=ckpt_dir),
            params=params, log=lambda line: None,
            on_checkpoint=events.append)
    launches = counted_launches()
    ckpt = None
    if ckpt_dir:
        ckpt = {"events": events, "saves": saves,
                "traffic": dict(comm.traffic["checkpoint"]),
                "block_gb": 0.0,
                "digests": {}}
        for name in CKPT_SLOTS:
            slot = getattr(fsdp, name)
            if slot is None:
                continue
            leaves = pytree.tree_flatten(slot)[0]
            ckpt["digests"][name] = digests(torch, leaves)
            ckpt["block_gb"] += sum(x.numel() * x.element_size()
                                    for x in leaves) / 1e9
    leaves, td = pytree.tree_flatten(fsdp.params)
    specs = pytree.flatten_up_to(td, built_f.bundle.master_specs)
    differ = total = 0
    for r, f, spec in zip(pytree.flatten_up_to(td, repl.params), leaves,
                          specs):
        want = device_axis.shard(r, device_axis.data_dim(spec), topo)
        differ += int((want.contiguous().view(torch.int32)
                       != f.view(torch.int32)).sum())
        total += f.numel()
    res = {"differing": differ, "coordinates": total,
           "losses_fsdp": [h["loss"] for h in hf],
           "losses_replicated": [h["loss"] for h in hr],
           "ms_fsdp": [h["ms"] for h in hf],
           "ms_replicated": [h["ms"] for h in hr],
           "launches": launches, "ckpt": ckpt,
           "leaf_layers": len(lift_rows(built_f.abstract_params()))}
    del repl, fsdp, params
    torch.cuda.empty_cache()
    return res


# -- the moe and vlm families over the model axis (item 17f, part one) --------

TP_MOE_STEPS = 2                 # the prologue and a local step: each
                                 # prologue moves 2.4-3.8 times a local
                                 # step's bytes through gloo, and the
                                 # script's 1200 s hold no second one
TP_INTERNVL2_LAYERS = 1          # internvl2's cut on the tp ranks
# step 0's gradients against model=1 (under TP_STEP0_REL): bf16 as for
# gemma3-1b, but float32 for an MoE, whose top-k routing flips on
# bf16's reordered sums: deepseek-v3's smoke config on the CPU reads
# 0.47 of a leaf's scale sound and 1.09 with copy_to_model dropped in
# bf16, 0.047 with every expert chosen and none dropped, and 2.8e-6
# against 1.07 in float32 (tests/helpers/torch_tp_step0_bound.py)
TP_MOE_STEP0_DTYPE = {"deepseek-v3": "float32", "internvl2": "bfloat16"}


def tp_moe_cells() -> dict:
    """The configs the tp ranks train over the model axis, FSDP, at
    their published widths: :func:`moe_cells`' deepseek-v3 (1 dense MLA
    layer and 1 MoE layer, 16 of 256 routed experts and the shared one,
    MTP, 16160 words) and internvl2 cut to ``TP_INTERNVL2_LAYERS``
    layers (16032 words, 256 patches)."""
    cells = moe_cells()
    return {"deepseek-v3": cells["deepseek-v3"],
            "internvl2": dataclasses.replace(cells["internvl2"],
                                             n_layers=TP_INTERNVL2_LAYERS)}


def tp_write_params(torch, root: pathlib.Path, cells: dict) -> dict:
    """Each config's seed-0 parameters (``cells``: name -> config; the
    moe part's and the serve part's), drawn once on the card as
    ``run_training`` draws them (``init_params`` on a CUDA
    generator), written to ``root/NAME/I.npy`` a leaf at a time in
    pytree order: the 8 ranks map the same files, so no rank holds a
    whole tree on the card.  Returns each config's seconds and bytes."""
    import numpy as np

    from repro_torch.core import pytree
    from repro_torch.core.topology import Topology
    from repro_torch.models import build

    out = {}
    for name, cfg in cells.items():
        t0 = time.perf_counter()
        leaves = pytree.tree_flatten(build.build_model(
            cfg, Topology(1, 1, "cuda")).init_params(
                torch.Generator(device="cuda").manual_seed(0)))[0]
        d = root / name
        d.mkdir()
        nbytes = 0
        for i in range(len(leaves)):
            a = leaves[i].cpu().numpy()
            leaves[i] = None
            np.save(d / f"{i}.npy", a)
            nbytes += a.nbytes
        torch.cuda.empty_cache()
        out[name] = {"s": time.perf_counter() - t0, "bytes": nbytes}
    return out


def tp_wait_trees(trees: str) -> float:
    """Wait, at most ``TP_JOIN_S``, for the parent's trees under
    ``trees`` (:func:`tp_write_params`); the seconds waited."""
    t0 = time.perf_counter()
    while not (pathlib.Path(trees) / "ready").exists():
        if time.perf_counter() - t0 > TP_JOIN_S:
            raise RuntimeError(f"no parameters under {trees}")
        time.sleep(0.5)
    return time.perf_counter() - t0


def tp_host_params(torch, built, d: pathlib.Path):
    """The tree :func:`tp_write_params` wrote to ``d``, as host tensors
    over copy-on-write maps of its files (nothing is read until a leaf
    moves)."""
    import numpy as np

    from repro_torch.core import pytree

    leaves, td = pytree.tree_flatten(built.abstract_params())
    return pytree.tree_unflatten(td, [
        torch.from_numpy(np.load(d / f"{i}.npy", mmap_mode="c"))
        for i in range(len(leaves))])


def tp_batch(torch, topo, cfg, batch: int = 1,
                 seq: int = MOE_SEQ) -> dict:
    """Step 0's batch of the run's stream (seed 0, ``batch`` x ``seq``
    tokens a device, a vlm's patches, whisper's frames), the rank's
    block, on the card."""
    from repro_torch.data import synthetic

    first = synthetic.make_stream(synthetic.LMStreamCfg(
        vocab=cfg.vocab, seq_len=seq, batch_per_device=batch, pods=TP_P,
        devices_per_pod=TP_D, seed=0, n_patches=cfg.n_patches,
        d_model=cfg.d_model,
        frames=cfg.encoder_frames if cfg.encoder_layers else 0,
        frontend_dim=cfg.frontend_dim))(0)
    return {k: v.to(topo.device) for k, v in topo.block(first).items()}


def tp_copies(torch, host, dtype, layout=None, rank: int = 0) -> list:
    """Fresh [1, 1] copies in ``dtype`` on the card of model rank
    ``rank``'s blocks of the mapped tree ``host`` (``layout`` sharded;
    the whole leaves without one), each block cut from the map, so only
    its pages are read, and moved alone."""
    from repro_torch.core import flatbuf, pytree

    out = []
    for i, x in enumerate(pytree.tree_flatten(host)[0]):
        if layout is not None and layout.shards > 1:
            x = flatbuf.slot_block(layout.slots[i], x, rank, layout.shards)
        out.append(x.to(device="cuda", dtype=dtype)[None, None]
                   .contiguous().requires_grad_(True))
    return out


def tp_step0(torch, topo, cfg, host, batch, dtype) -> dict:
    """Step 0's gradients of ``cfg`` in ``dtype`` through the
    replicated-regime loss on the first [1, 1] block (pod 0, device 0;
    the other ranks wait, so the card holds that block's runs alone):
    its two model ranks take theirs tensor-parallel -- every copy leaf's
    gradient bitwise the same on both --, then model rank 0 takes the
    model=1 run's of the same block and tokens and holds each leaf,
    gathered over the model group, against them: the coordinates that
    differ and the largest difference over the leaf's largest |value|.
    The other blocks differ only in their tokens."""
    import torch.distributed as dist

    from repro_torch.core import comm, pytree, shardflat
    from repro_torch.core.topology import Topology
    from repro_torch.models import build

    rcfg = dataclasses.replace(cfg, param_mode="replicated")
    built = build.build_model(rcfg, topo)
    layout = shardflat.param_layout(topo, built.bundle.specs,
                                    built.abstract_params())
    td = pytree.tree_flatten(host)[1]
    m = topo.mesh
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    res = {}
    if (m.pod_rank, m.data_rank) == (0, 0):
        t0 = time.perf_counter()
        copies = tp_copies(torch, host, dtype, layout, topo.model_rank)
        tree = shardflat.logical(topo, layout, pytree.tree_unflatten(
            td, copies), 2)
        losses = built.bundle.loss(tree, batch)
        grads = list(torch.autograd.grad(losses.sum(), copies))
        torch.cuda.synchronize()
        res.update(grads_s=time.perf_counter() - t0,
                   losses=losses.detach().float().flatten().tolist())
        del copies, tree, losses
        agree = True
        for slot, g in zip(layout.slots, grads):
            if slot.shard_dim is None:
                got = comm.gather_model(topo, g, 0)
                agree &= all(torch.equal(got[:1].view(bits),
                                         got[i:i + 1].view(bits))
                             for i in range(1, got.shape[0]))
        res["copies_agree"] = bool(agree)
        t1 = time.perf_counter()
        one = None
        if m.model_rank == 0:
            plain = build.build_model(rcfg, Topology(1, 1, "cuda"))
            whole = tp_copies(torch, host, dtype)
            ones = plain.bundle.loss(pytree.tree_unflatten(td, whole),
                                     batch)
            one = torch.autograd.grad(ones.sum(), whole)
            res["losses_one_process"] = ones.detach().float() \
                .flatten().tolist()
            del whole, ones
        differ, worst, n, nans, nan_moved = 0, 0.0, 0, 0, 0
        for i, (slot, g) in enumerate(zip(layout.slots, grads)):
            if slot.shard_dim is not None:
                ax = 2 + slot.shard_dim
                g = comm.gather_model(topo, g, ax)
                g = g.narrow(ax, 0, g.shape[ax] - slot.shard_pad)
            if one is not None:
                b = one[i]
                differ += int((g.view(bits) != b.view(bits)).sum())
                # a NaN (zamba2's SSD overflow, ROADMAP queue 3) is held
                # by position; the finite values by their difference
                nans += int(b.isnan().sum())
                nan_moved += int((g.isnan() != b.isnan()).sum())
                scale = float(torch.nan_to_num(b.float().abs()).max())
                worst = max(worst, float(torch.nan_to_num(
                    (g.float() - b.float()).abs()).max()) / max(scale, 1e-30))
                n += b.numel()
            del g
        if one is not None:
            res.update(step0_differing=differ, step0_max_rel_diff=worst,
                       step0_coordinates=n, step0_nan=nans,
                       step0_nan_moved=nan_moved,
                       one_process_s=time.perf_counter() - t1)
        del one, grads
        torch.cuda.empty_cache()
    dist.barrier()
    return res


def tp_moe_fsdp(torch, topo, cfg, host) -> dict:
    """``run_training`` of ``cfg`` in the FSDP regime over the ranks for
    TP_MOE_STEPS steps (:func:`moe_algo` at MOE_MU: DC, rho 0.2, T_E=3,
    bf16 compute and delta, f32 master, fused, tree; 1 x MOE_SEQ tokens
    a device) from the mapped seed-0 tree (``init_fn`` moves and cuts it
    a leaf at a time), with the kernels' counters and ``comm.traffic``
    at 0 just before it: its losses, step times, launches, each group's
    bytes at each step, the bytes of its master and corrections, and its
    peak above what it held; and the trained masters (the rank's
    ``[P_loc, *shard]`` FSDP shards), the rest of the state freed."""
    from repro_torch.core import comm, pytree
    from repro_torch.launch.train import RunCfg, run_training

    run = RunCfg(steps=TP_MOE_STEPS, batch_per_device=1, seq_len=MOE_SEQ,
                 log_every=1, seed=0)
    per_step, held = [], {}

    def on_state(step, state):
        per_step.append(comm.group_bytes())
        if not held:
            held.update({name: sum(x.numel() * x.element_size() for x in
                                   pytree.tree_flatten(getattr(state,
                                                               name))[0])
                         for name in ("params", "delta", "delta_next")})

    zero_launches()
    comm.reset_traffic()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, history = run_training(cfg, topo, moe_algo(torch, MOE_MU), run,
                                  params=host, log=lambda line: None,
                                  on_state=on_state)
    torch.cuda.synchronize()
    res = {"losses": [h["loss"] for h in history],
           "ms": [h["ms"] for h in history],
           "data_ms": [h["data_ms"] for h in history],
           "launches": counted_launches(),
           "bytes_per_step": [per_step[0]] + [
               {g: {k: b[g][k] - a[g][k] for k in b[g]} for g in b}
               for a, b in zip(per_step, per_step[1:])],
           "held_bytes": held,
           "peak_gb": (torch.cuda.max_memory_allocated() - before) / 1e9,
           "held_gb": before / 1e9}
    masters = state.params
    del state
    torch.cuda.empty_cache()
    return res, masters


def tp_moe_rank(torch, topo, trees: str) -> tuple:
    """The rank's ``moe`` part: for each :func:`tp_moe_cells` config,
    :func:`tp_step0` then :func:`tp_moe_fsdp`, from the tree the
    parent writes under ``trees`` while the ranks run their earlier
    parts (:func:`tp_wait_trees`).  Returns (its results, each config's
    trained FSDP masters)."""
    from repro_torch.models import build

    out, masters = {"wait_s": tp_wait_trees(trees)}, {}
    for name, cfg in tp_moe_cells().items():
        t0 = time.perf_counter()
        host = tp_host_params(torch, build.build_model(cfg, topo),
                                  pathlib.Path(trees) / name)
        res = {"step0": tp_step0(
            torch, topo, cfg, host, tp_batch(torch, topo, cfg),
            getattr(torch, TP_MOE_STEP0_DTYPE[name]))}
        res["step0"]["s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        res["fsdp"], masters[name] = tp_moe_fsdp(torch, topo, cfg, host)
        res["fsdp"]["s"] = time.perf_counter() - t1
        del host
        torch.cuda.empty_cache()
        out[name] = res
    return out, masters


def tp_step0_report(card: str, cfg, per_rank: list, dtype: str,
                    part: str, extra: dict) -> None:
    """The step-0 check of a part's config from each rank's
    :func:`tp_step0` result: the first block's two model ranks'
    copy leaves' gradients bitwise the same, their losses the same and
    finite, and each leaf within ``TP_STEP0_REL`` of the model=1 run's
    (a JSON line ``{"tp": "PART step 0"}``)."""
    step0 = [x for x in per_rank if "copies_agree" in x]  # the first pair
    checked = [x for x in step0 if "step0_differing" in x]
    emit({"tp": f"{part} step 0", "arch": cfg.name, "card": card,
          "n_layers": cfg.n_layers, "grid": list(TP_GRID),
          "block": [0, 0], "dtype": dtype,
          "step0_differing": [x["step0_differing"] for x in checked],
          "step0_coordinates": [x["step0_coordinates"] for x in checked],
          "step0_max_rel_diff": [x["step0_max_rel_diff"] for x in checked],
          "step0_nan": [x["step0_nan"] for x in checked],
          "step0_nan_moved": [x["step0_nan_moved"] for x in checked],
          "limit": TP_STEP0_REL,
          "copies_agree": [x["copies_agree"] for x in step0],
          "losses_model_ranks": [x["losses"] for x in step0],
          "losses_one_process": [x["losses_one_process"] for x in checked],
          "grads_s_per_model_rank": [x["grads_s"] for x in step0],
          "one_process_s": [x["one_process_s"] for x in checked],
          "rank_s": [x["s"] for x in per_rank], **extra})
    require(len(step0) == TP_M and len(checked) == 1,
            f"tp {part} {cfg.name}: the first block's step-0 check is "
            "missing")
    for x in step0:
        require(x["copies_agree"], f"tp {part} {cfg.name}: a copy leaf's "
                "step-0 gradient differs across the model group")
        require(x["losses"] == step0[0]["losses"]
                and all(map(math.isfinite, x["losses"])),
                f"tp {part} {cfg.name}: the model ranks' step-0 losses "
                f"{[y['losses'] for y in step0]}")
    for x in checked:
        require(x["step0_nan_moved"] == 0, f"tp {part} {cfg.name}: "
                f"{x['step0_nan_moved']} NaN gradients where the model=1 "
                "run's are not, or the reverse")
        require(x["step0_max_rel_diff"] <= TP_STEP0_REL,
                f"tp {part} {cfg.name}: step 0's gradients "
                f"{x['step0_max_rel_diff']} of a leaf's scale from the "
                f"model=1 run's (limit {TP_STEP0_REL})")


def tp_moe_report(torch, card: str, ranks: list) -> dict:
    """The ``moe`` part's checks, from the ranks' results, for each
    config: step 0's gradients on the first block -- every copy leaf's
    bitwise the same on both model ranks, and so are the losses, each
    leaf within ``TP_STEP0_REL`` of the model=1 run's; the FSDP run --
    finite losses, the same on every rank, the last step's below step
    0's, one ``sign_pack`` and one ``vote_update`` a lifted
    leaf and layer a step in every rank and no other kernel, each rank's
    master the data shard of its model block to the byte; each group's
    bytes a local and a prologue step beside their reckonings
    (:func:`reckon_fsdp_mesh_bytes`, :func:`reckon_tp_model_bytes`), the
    step times and the peak beside :func:`reckon_fsdp_mesh_peak`.
    Returns each config's per-rank launches."""
    from repro_torch.core import device_axis
    from repro_torch.core.topology import Topology
    from repro_torch.models import build

    launches = {}
    for name, cfg in tp_moe_cells().items():
        tp_step0_report(card, cfg, [r["moe_tp"][name]["step0"]
                                    for r in ranks],
                        TP_MOE_STEP0_DTYPE[name], "moe", {
                            "trees_wait_s_per_rank": [r["moe_tp"]["wait_s"]
                                                      for r in ranks]})

        lm = [r["moe_tp"][name]["fsdp"] for r in ranks]
        built = build.build_model(cfg, Topology(TP_P, TP_D, "cpu"))
        abstract = built.abstract_params()
        leaves = len(lift_rows(abstract))
        master = sum(4 * max(stack, 1) * (numel // TP_D if device_axis
                                          .data_dim(spec) is not None
                                          else numel)
                     for _, stack, numel, spec in mesh_leaves(built, TP_M))
        data_pod = reckon_fsdp_mesh_bytes(built, TP_D, TP_P, TP_M)
        model = reckon_tp_model_bytes(cfg, built.arch, 1, MOE_SEQ, TP_M)
        reckoned = reckon_fsdp_mesh_peak(built, 1, MOE_SEQ, TP_D, TP_M,
                                         host_init=True)
        losses = lm[0]["losses"]
        sent = [{g: {"local_step": x["bytes_per_step"][1][g]["sent"],
                     "prologue_step": x["bytes_per_step"][0][g]["sent"]}
                 for g in ("data", "pod", "model")} for x in lm]
        emit({"tp": "moe fsdp", "arch": cfg.name, "card": card,
              "n_layers": cfg.n_layers,
              "count": build.param_count(abstract), "grid": list(TP_GRID),
              "P": TP_P, "D": TP_D, "M": TP_M, "seq": MOE_SEQ,
              "n_patches": cfg.n_patches, "steps": TP_MOE_STEPS,
              "mu": MOE_MU, "losses": losses,
              "last_loss": losses[-1],
              "launches_per_rank": [x["launches"] for x in lm],
              "leaf_layers_a_step": leaves,
              "held_bytes_per_rank": [x["held_bytes"] for x in lm],
              "master_bytes_reckoned": master,
              "bytes_sent_per_rank": sent,
              "bytes_reckoned": {**data_pod, "model": model},
              "local_step_ms_per_rank": [
                  statistics.mean(ms for s, ms in enumerate(x["ms"])
                                  if s % LM_TE) for x in lm],
              "prologue_step_ms_per_rank": [
                  statistics.mean(ms for s, ms in enumerate(x["ms"])
                                  if s % LM_TE == 0) for x in lm],
              "ms_per_rank": [x["ms"] for x in lm],
              "data_ms_per_rank": [statistics.mean(x["data_ms"])
                                   for x in lm],
              "peak_gb_per_rank": [x["peak_gb"] for x in lm],
              "held_gb_per_rank": [x["held_gb"] for x in lm],
              "reckoned_peak": reckoned,
              "rank_s": [x["s"] for x in lm]})
        want = {"sign_pack": TP_MOE_STEPS * leaves,
                "vote_update": TP_MOE_STEPS * leaves, "tally_acc": 0,
                "ternary_quant": 0}
        for x in lm:
            require(all(map(math.isfinite, x["losses"])),
                    f"tp moe {name}: non-finite loss")
            require(x["losses"] == losses, f"tp moe {name}: the ranks' "
                    "losses differ")
            require(x["launches"] == want, f"tp moe {name}: launches "
                    f"{x['launches']}, want {want}")
            require(x["held_bytes"]["params"] == master, f"tp moe {name}: "
                    f"a rank holds {x['held_bytes']['params']} master "
                    f"bytes, its shard of its model block {master}")
        require(losses[-1] < losses[0], f"tp moe {name}: step "
                f"{TP_MOE_STEPS - 1}'s loss {losses[-1]} is not below "
                f"step 0's {losses[0]}")
        launches[name] = [x["launches"] for x in lm]
    return launches


# -- the ssm, hybrid and encdec families over the model axis (item 17f,
# part two) ---------------------------------------------------------------

TP_FAM_STEPS = 2                 # the replicated regime's prologue and a
                                 # local step over the ranks
# step 0's gradients against model=1: bf16 as for gemma3-1b where it
# holds, float32 for the recurrent mixers, whose gradients move far
# more than a rounding: their smoke configs on the CPU read 0.84 (xlstm)
# and 0.58 (zamba2) of a leaf's scale sound in bf16, against 0.024 for
# whisper, and 1.0e-5 and 2.0e-5 in float32, 1.05 and more with a
# model collective dropped (tests/helpers/torch_tp_step0_bound.py)
TP_FAM_STEP0_DTYPE = {"xlstm-350m": "float32", "zamba2-2.7b": "float32",
                      "whisper-base": "bfloat16"}
TP_FAM_MU = {"xlstm-350m": 1e-3, "zamba2-2.7b": MOE_MU,
             "whisper-base": 1e-3}
# the fam part's step size: the families and hybrid phases' 1e-3, but
# zamba2's at MOE_MU -- at 1e-3 its loss rose after the prologue's step
# (10.8566 -> 10.8708 on the H100, PERF.md section 6), as a sign step of 1e-3
# does on random weights at published widths (ROADMAP queue 3), which
# is why the moe phase trains at MOE_MU
TP_FAM_CALM = 5.0                # zamba2's a_log lowered by this: the SSD
                                 # scan's overflow (ROADMAP queue 3) would
                                 # make every gradient but the head's NaN.
                                 # A chunk of 256 sums up to 256 decays
                                 # dt * 16 e^-k (dt about 0.8): k = 3, the
                                 # CPU tests' at chunk 16, still passes
                                 # exp's 88 here, k = 5 stays near 23


def tp_fam_cells() -> dict:
    """name -> (config, rows, tokens a device) of the configs the tp ranks
    train tensor-parallel in the replicated regime, at their published
    widths: xlstm-350m cut to one 7:1 period (``FAM_XLSTM_LAYERS``: d
    1024, d_in 2048, 4 heads, vocab 50304), zamba2-2.7b cut to one period
    (6 Mamba2 blocks and the shared block: d 2560, d_in 5120, 80 SSM and
    32 attention heads, vocab 32000) and whisper-base whole (6 + 6
    layers, 1500 frames, vocab 51865 whole); the ``families`` and
    ``hybrid`` phases' tokens a device."""
    from repro_torch import configs

    xlstm = dataclasses.replace(configs.get_config("xlstm_350m"),
                                n_layers=FAM_XLSTM_LAYERS)
    zamba2 = configs.get_config("zamba2_2p7b")
    zamba2 = dataclasses.replace(zamba2, n_layers=zamba2.ssm.attn_every)
    tokens = {arch: (b, t) for arch, b, t in FAMILIES}
    return {"xlstm-350m": (xlstm, *tokens["xlstm_350m"]),
            "zamba2-2.7b": (zamba2, 1, LM_SEQ),
            "whisper-base": (configs.get_config("whisper_base"),
                             *tokens["whisper_base"])}


def tp_fam_params(torch, built, cfg):
    """The seed-0 tree, drawn on the card as ``run_training`` draws it and
    moved to the host a leaf at a time (the step-0 copies and
    ``init_fn`` move only the rank's blocks back: eight ranks' whole
    trees and training states do not fit the card together); zamba2's
    every ``a_log`` lowered by ``TP_FAM_CALM``."""
    from repro_torch.core import pytree

    leaves, td = pytree.tree_flatten(built.init_params(
        torch.Generator(device="cuda").manual_seed(0)))
    for i in range(len(leaves)):
        leaves[i] = leaves[i].cpu()
    params = pytree.tree_unflatten(td, leaves)
    torch.cuda.empty_cache()
    if cfg.family == "hybrid":
        params["stacks"]["mamba"]["mamba"]["a_log"] -= TP_FAM_CALM
    return params


def tp_fam_train(torch, topo, cfg, built, params, batch: int, seq: int,
                 mu: float) -> dict:
    """``run_training`` of ``cfg`` in the replicated regime over the
    ranks for TP_FAM_STEPS steps (the lm phase's algorithm: DC, rho 0.2,
    T_E=3, bf16 compute and delta, f32 master, fused, flat; ``mu``) from
    ``params`` (``init_fn`` cuts the rank's blocks), with the kernels'
    counters and ``comm.traffic`` at 0 just before it: its losses, step
    times, launches, each group's bytes at each step, whether every copy
    leaf of the master and corrections was bitwise the same on both
    model ranks after each step, and its peak above what it held; and the
    trained flat master (the rank's bucket), the rest of the state
    freed."""
    import torch.distributed as dist

    from repro_torch.core import comm, shardflat
    from repro_torch.launch.train import RunCfg, run_training

    _, _, algo = lm_setup(torch, mu=mu)
    run = RunCfg(steps=TP_FAM_STEPS, batch_per_device=batch, seq_len=seq,
                 log_every=1, seed=0)
    layout = shardflat.param_layout(topo, built.bundle.specs, params)
    per_step, agree = [], []

    def on_state(step, state):
        per_step.append(comm.group_bytes())
        digest = torch.tensor(list(copies_digest(torch, state, layout)),
                              dtype=torch.uint8, device="cuda")
        parts = [torch.empty_like(digest) for _ in range(TP_M)]
        dist.all_gather(parts, digest, group=topo.mesh.model_group)
        agree.append(all(torch.equal(parts[0], x) for x in parts[1:]))

    zero_launches()
    comm.reset_traffic()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    state, history = run_training(cfg, topo, algo, run, params=params,
                                  log=lambda line: None, on_state=on_state)
    torch.cuda.synchronize()
    res = {"losses": [h["loss"] for h in history],
           "ms": [h["ms"] for h in history],
           "data_ms": [h["data_ms"] for h in history],
           "launches": counted_launches(),
           "bytes_per_step": [per_step[0]] + [
               {g: {k: b[g][k] - a[g][k] for k in b[g]} for g in b}
               for a, b in zip(per_step, per_step[1:])],
           "copies_agree": agree,
           "peak_gb": (torch.cuda.max_memory_allocated() - before) / 1e9,
           "held_gb": before / 1e9, "bucket_pad": layout.bucket_pad}
    master = state.params
    del state
    torch.cuda.empty_cache()
    return res, master


def tp_fam_rank(torch, topo) -> tuple:
    """The rank's ``fam`` part: for each :func:`tp_fam_cells` config, step
    0's gradients on the first block (:func:`tp_step0`, in
    ``TP_FAM_STEP0_DTYPE``) and :func:`tp_fam_train`, from the seed-0
    tree each rank draws (:func:`tp_fam_params`).  Returns the results
    and each config's trained master (the rank's flat bucket), which
    the serve part serves as it is left."""
    from repro_torch.models import build

    out, masters = {}, {}
    for name, (cfg, batch, seq) in tp_fam_cells().items():
        t0 = time.perf_counter()
        built = build.build_model(cfg, topo)
        params = tp_fam_params(torch, built, cfg)
        res = {"step0": tp_step0(
            torch, topo, cfg, params, tp_batch(torch, topo, cfg, batch,
                                                   seq),
            getattr(torch, TP_FAM_STEP0_DTYPE[name]))}
        res["step0"]["s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        res["train"], master = tp_fam_train(torch, topo, cfg, built, params,
                                            batch, seq, TP_FAM_MU[name])
        res["train"]["s"] = time.perf_counter() - t1
        del params
        masters[name] = master
        torch.cuda.empty_cache()
        out[name] = res
    return out, masters


def tp_fam_report(torch, card: str, ranks: list) -> dict:
    """The ``fam`` part's checks, from the ranks' results, for each
    config: step 0 (:func:`tp_step0_report`); the replicated run --
    finite losses, the same on every rank, step 1's below step 0's, one
    ``sign_pack`` and one ``vote_update`` a step in every rank and no
    other kernel, every copy leaf bitwise the same on both model ranks
    after each step, and the model group's bytes a prologue and a local
    step those :func:`reckon_tp_model_bytes` reckons (the replicated
    regime, bf16 activations); the data and pod groups' bytes, the step
    times and the peak beside them.  Returns each config's per-rank
    launches."""
    from repro_torch.core.topology import Topology
    from repro_torch.models import build

    launches = {}
    for name, (cfg, batch, seq) in tp_fam_cells().items():
        tp_step0_report(card, cfg, [r["fam_tp"][name]["step0"]
                                    for r in ranks],
                        TP_FAM_STEP0_DTYPE[name], "fam",
                        {"a_log_lowered_by": TP_FAM_CALM
                         if cfg.family == "hybrid" else 0.0})
        lm = [r["fam_tp"][name]["train"] for r in ranks]
        built = build.build_model(cfg, Topology(TP_P, TP_D, "cpu"))
        model = reckon_tp_model_bytes(cfg, built.arch, batch, seq, TP_M,
                                      fsdp=False)
        losses = lm[0]["losses"]
        sent = [{g: {"local_step": x["bytes_per_step"][1][g]["sent"],
                     "prologue_step": x["bytes_per_step"][0][g]["sent"]}
                 for g in ("data", "pod", "model")} for x in lm]
        emit({"tp": "fam train", "arch": cfg.name, "card": card,
              "family": cfg.family, "n_layers": cfg.n_layers,
              "encoder_layers": cfg.encoder_layers,
              "count": build.param_count(built.abstract_params()),
              "grid": list(TP_GRID), "P": TP_P, "D": TP_D, "M": TP_M,
              "batch": batch, "seq": seq, "steps": TP_FAM_STEPS,
              "mu": TP_FAM_MU[name], "a_log_lowered_by": TP_FAM_CALM
              if cfg.family == "hybrid" else 0.0,
              "losses": losses, "last_loss": losses[-1],
              "launches_per_rank": [x["launches"] for x in lm],
              "copies_agree_every_step": [
                  all(x["copies_agree"][s] for x in lm)
                  for s in range(len(losses))],
              "bucket_pad": lm[0]["bucket_pad"],
              "bytes_sent_per_rank": sent,
              "model_bytes_reckoned": model,
              "prologue_step_ms_per_rank": [x["ms"][0] for x in lm],
              "local_step_ms_per_rank": [x["ms"][1] for x in lm],
              "data_ms_per_rank": [statistics.mean(x["data_ms"])
                                   for x in lm],
              "peak_gb_per_rank": [x["peak_gb"] for x in lm],
              "held_gb_per_rank": [x["held_gb"] for x in lm],
              "rank_s": [x["s"] for x in lm]})
        want = {"sign_pack": TP_FAM_STEPS, "vote_update": TP_FAM_STEPS,
                "tally_acc": 0, "ternary_quant": 0}
        for x, b in zip(lm, sent):
            require(all(map(math.isfinite, x["losses"])),
                    f"tp fam {name}: non-finite loss")
            require(x["losses"] == losses, f"tp fam {name}: the ranks' "
                    "losses differ")
            require(x["launches"] == want, f"tp fam {name}: launches "
                    f"{x['launches']}, want {want}")
            require(all(x["copies_agree"]), f"tp fam {name}: a copy leaf "
                    "differs across the model group")
            require(b["model"] == model, f"tp fam {name}: the model group's "
                    f"bytes {b['model']}, reckoned {model}")
        require(losses[-1] < losses[0], f"tp fam {name}: step "
                f"{TP_FAM_STEPS - 1}'s loss {losses[-1]} is not below step "
                f"0's {losses[0]}")
        launches[name] = [x["launches"] for x in lm]
    return launches


# -- serving over the model axis (item 17d, part one) ---------------------------

TP_SERVE_B = 8                   # requests: 2 a batch rank of 2 x 2
TP_SERVE_PROMPT = 48             # prompt tokens a request
TP_SERVE_STEPS = 4               # decode steps, teacher-forced
TP_SERVE_MAX_LEN = {"gemma3-1b": 640}   # past gemma's window of 512: its
                                        # local caches are the rolled ones
                                        # (the rest: patches, prompt, steps)
# the one-process serve's logits against the sharded ranks', of its
# largest |logit| (float32 compute; a decode step reads the bfloat16
# cache, where one rounding that differs moves the logits by up to about
# 2^-8 of the largest).  On the H100 (PERF.md) the sound runs read at
# most 1.2e-5 at prefill and 1.1e-3 at a step; planted faults -- a rank
# routing its MoE rows alone, the split norm's sum replaced by M times
# the rank's own, one layer's attention sum replaced by M times the
# rank's share -- read 0.25 and more at prefill and 0.13 and more at a
# step.  Each limit lies between the two, about 8x above the sound
# runs' largest
TP_SERVE_PREFILL_REL = 1e-4
TP_SERVE_DECODE_REL = 2.0 ** -7


def tp_serve_cells() -> dict:
    """name -> config of the serve part, at published widths: gemma3-1b
    whole (26 layers, one kv head, vocabulary 262144), deepseek-v3 and
    internvl2 at the ``moe`` part's cuts (:func:`tp_moe_cells`), and
    xlstm-350m, zamba2-2.7b and whisper-base at the ``fam`` part's
    (:func:`tp_fam_cells`)."""
    from repro_torch import configs

    return {"gemma3-1b": configs.get_config("gemma3_1b"),
            **tp_moe_cells(),
            **{name: cell[0] for name, cell in tp_fam_cells().items()}}


def tp_serve_requests(torch, cfg, name: str) -> dict:
    """The part's TP_SERVE_B requests of ``cfg`` on the host
    (``synthetic.serve_request_batch``: tokens, whisper's frames, a
    vlm's patches), the same on every rank."""
    from repro_torch.data import synthetic

    scfg = synthetic.LMStreamCfg(
        vocab=cfg.vocab, seq_len=TP_SERVE_PROMPT, batch_per_device=1,
        pods=1, devices_per_pod=1, n_patches=cfg.n_patches,
        d_model=cfg.d_model,
        frames=cfg.encoder_frames if cfg.encoder_layers else 0,
        frontend_dim=cfg.frontend_dim)
    return synthetic.serve_request_batch(scfg, TP_SERVE_B, TP_SERVE_PROMPT,
                                         seed=sum(map(ord, name)))


def tp_serve_rows(topo, tree: dict, device) -> dict:
    """The rank's rows of a global batch (its batch rank's block), on
    ``device``."""
    from repro_torch.models import moe

    nb, r = moe.batch_ranks(topo)
    out = {}
    for k, v in tree.items():
        rows = v.shape[0] // nb
        out[k] = v[r * rows:(r + 1) * rows].to(device)
    return out


def host_blocks(torch, topo, built, host, dtype):
    """The rank's logical blocks of the mapped host tree ``host`` at
    ``built``'s model axis, in ``dtype`` on the rank's device, each block
    cut from the map and moved alone."""
    from repro_torch.core import flatbuf, pytree, shardflat

    layout = shardflat.param_layout(topo, built.bundle.specs, host)
    leaves, td = pytree.tree_flatten(host)
    out = []
    for i, x in enumerate(leaves):
        if layout.shards > 1:
            x = flatbuf.slot_block(layout.slots[i], x, topo.model_rank,
                                   layout.shards)
        out.append(x.to(device=topo.device, dtype=dtype))
    return shardflat.logical(topo, layout, pytree.tree_unflatten(td, out))


def tp_serve(torch, topo, name: str, cfg, params, whole,
             layout: str = "resident", warm: bool = True):
    """Serve ``cfg`` over the ranks in ``layout``: TP_SERVE_B requests, 2
    a batch rank, TP_SERVE_PROMPT tokens, TP_SERVE_STEPS decode steps.
    ``params``: the rank's float32 parameter blocks on its device (in
    the gather layout, its FSDP shards); ``whole()``: the whole tree on
    model rank 0 of the first batch rank (None on every other rank;
    called on every rank of pod 0, which it may gather over).

      1. the reference: model rank 0 of the first batch rank serves the
         whole batch alone (``Topology(1, 1)``) in float32 -- prefill
         and greedy decode steps, its logits kept; its greedy tokens are
         the teacher's, summed to every rank;
      2. every rank, float32: prefill its rows and decode them on the
         teacher's tokens, the rows of every batch rank gathered; the
         reference rank holds them against its own logits (the largest
         difference of the largest |logit|; the greedy tokens where the
         gap between the two largest exceeds twice it); every rank's
         cache bytes after each call against ``build.cache_bytes``;
      3. every rank, bfloat16 weights (``params`` cast on the device, a
         leaf at a time): a prefill to warm (with ``warm``), then a timed
         prefill and the decode steps, each
         between synchronisations and barriers, with the bytes the rank
         sends on each group (``comm.group_bytes``) in the prefill and
         in each step, and the cache bytes.

    The kernels' counters are zeroed first and read last: serving
    launches none.  Runs on the rank's device (the card; the CPU in
    ``tests/test_torch_tp_serve.py``'s rehearsal)."""
    import torch.distributed as dist

    from repro_torch.core import comm, pytree
    from repro_torch.core.topology import Topology
    from repro_torch.models import build

    dev = topo.device

    def free():
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    t_start = time.perf_counter()
    zero_launches()
    m = topo.mesh
    built = build.build_model(cfg, topo, layout=layout)
    req = tp_serve_requests(torch, cfg, name)
    max_len = TP_SERVE_MAX_LEN.get(
        name, cfg.n_patches + TP_SERVE_PROMPT + TP_SERVE_STEPS)
    res = {"max_len": max_len}
    ref = None
    teacher = torch.zeros((TP_SERVE_B, TP_SERVE_STEPS), dtype=torch.long)
    if m.pod_rank == 0:
        tree = whole()
        if m.data_rank == 0 and m.model_rank == 0:
            t0 = time.perf_counter()
            plain = build.build_model(cfg, Topology(1, 1, dev))
            batch = {k: v.to(dev) for k, v in req.items()}
            logits, cache = plain.prefill(tree, batch, max_len)
            ref = [logits[:, -1].float()]
            toks = []
            for _ in range(TP_SERVE_STEPS):
                tok = torch.argmax(logits[:, -1:], dim=-1)
                toks.append(tok)
                logits, cache = plain.decode_step(tree, cache, tok)
                ref.append(logits[:, -1].float())
            synchronize(torch, dev)
            res["reference_s"] = time.perf_counter() - t0
            teacher = torch.cat(toks, dim=1).cpu()
            del cache, logits, plain, batch
        del tree
        free()
    dist.all_reduce(teacher)            # the reference's tokens
    batch = tp_serve_rows(topo, req, dev)
    steps = tp_serve_rows(topo, {"t": teacher}, dev)["t"]

    # float32: against the reference
    reckoned = build.cache_bytes(built.arch, TP_SERVE_B, max_len, topo,
                                 torch.float32)
    logits, cache = built.prefill(params, batch, max_len)
    got, held = [logits], [cache_bytes_of(cache)]
    for s in range(TP_SERVE_STEPS):
        logits, cache = built.decode_step(params, cache, steps[:, s:s + 1])
        got.append(logits)
        held.append(cache_bytes_of(cache))
    rows = [comm.gather_batch(topo, x[:, -1]).flatten(0, 1).float()
            for x in got]
    res.update(f32_cache_bytes=held, f32_cache_reckoned=reckoned,
               finite=all(bool(torch.isfinite(x).all()) for x in rows))
    if ref is not None:
        rel, skipped, agree = [], 0, True
        for g, w in zip(rows, ref):
            err = float((g - w).abs().max())
            rel.append(err / float(w.abs().max()))
            top2 = torch.topk(w, 2, dim=-1).values
            clear = (top2[:, 0] - top2[:, 1]) > 2 * err
            agree &= bool(torch.equal(g.argmax(-1)[clear],
                                      w.argmax(-1)[clear]))
            skipped += int((~clear).sum())
        res.update(rel_err=rel, greedy_agree=agree, greedy_skipped=skipped,
                   greedy_positions=len(rows) * TP_SERVE_B)
    del cache, logits, got, rows, ref
    free()

    # bfloat16 weights: timed, with each group's bytes
    leaves, td = pytree.tree_flatten(params)
    del params
    for i, x in enumerate(leaves):      # the float32 block freed as cast
        leaves[i] = x.to(torch.bfloat16) if x.dtype.is_floating_point else x
    params = pytree.tree_unflatten(td, leaves)
    del leaves
    free()
    if warm:
        built.prefill(params, batch, max_len)
    dist.barrier()
    synchronize(torch, dev)
    comm.reset_traffic()
    t0 = time.perf_counter()
    logits, cache = built.prefill(params, batch, max_len)
    synchronize(torch, dev)
    res["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    res["prefill_bytes"] = comm.group_bytes()
    decode_ms, step_bytes, finite = [], [], bool(torch.isfinite(
        logits).all())
    for s in range(TP_SERVE_STEPS):
        dist.barrier()
        synchronize(torch, dev)
        comm.reset_traffic()
        t0 = time.perf_counter()
        logits, cache = built.decode_step(params, cache, steps[:, s:s + 1])
        synchronize(torch, dev)
        decode_ms.append((time.perf_counter() - t0) * 1e3)
        step_bytes.append(comm.group_bytes())
        finite &= bool(torch.isfinite(logits).all())
    res.update(decode_ms=decode_ms, decode_bytes=step_bytes,
               bf16_finite=finite, bf16_cache_bytes=cache_bytes_of(cache),
               bf16_cache_reckoned=build.cache_bytes(
                   built.arch, TP_SERVE_B, max_len, topo, torch.bfloat16),
               launches=counted_launches())
    del params, cache, logits
    free()
    res["s"] = time.perf_counter() - t_start
    return res


def cache_bytes_of(cache) -> int:
    return sum(a.numel() * a.element_size()
               for _, a in pytree_items(cache["stacks"]))


def tp_serve_host(torch, topo, name: str, cfg, host) -> dict:
    """:func:`tp_serve` of a config whose seed-0 tree the ranks map
    (``host``): the float32 blocks cut from the map, the reference's
    whole tree moved to the card."""
    from repro_torch.core import pytree
    from repro_torch.models import build

    built = build.build_model(cfg, topo)
    first = topo.mesh.data_rank == 0 and topo.model_rank == 0
    return tp_serve(
        torch, topo, name, cfg,
        host_blocks(torch, topo, built, host, torch.float32),
        lambda: (pytree.tree_map(lambda x: x.to(topo.device, torch.float32),
                                 host) if first else None))


def tp_serve_state(torch, topo, name: str, cfg, fs) -> dict:
    """:func:`tp_serve` of the flat master ``fs`` a training run left on
    the rank (its ``[P_loc, bucket_pad]`` bucket), taken mid-round:
    every pod serves edge 0 (``specs.serve_params_from_flat``), pod 0's
    ranks as views of their bucket, the other pod's as views of the row
    they receive -- one buffer a rank, checked by storage; the
    reference gathers the views over the model group."""
    from repro_torch.core import shardflat
    from repro_torch.launch import specs
    from repro_torch.models import build

    built = build.build_model(cfg, topo)
    layout = shardflat.param_layout(topo, built.bundle.specs,
                                    built.abstract_params())
    bucket = fs.buf.untyped_storage().data_ptr()
    views = specs.serve_params_from_flat(built, fs)
    ptrs = {v.untyped_storage().data_ptr() for _, v in pytree_items(views)}
    zero_copy = len(ptrs) == 1 and (topo.mesh.pod_rank > 0
                                    or ptrs == {bucket})
    res = tp_serve(torch, topo, name, cfg, views,
                   lambda: (shardflat.gather(topo, layout, views)
                            if topo.mesh.data_rank == 0 else None))
    res["views_zero_copy"] = zero_copy
    return res


def tp_serve_rank(torch, topo, trees: str, masters: dict) -> dict:
    """The rank's serve part, for each :func:`tp_serve_cells` config:
    the ``fam`` part's trained ``masters`` (popped: each freed once
    served), then the rest from the trees the parent writes under
    ``trees`` (:func:`tp_wait_trees`)."""
    from repro_torch.models import build

    cells = tp_serve_cells()
    out = {name: tp_serve_state(torch, topo, name, cells[name],
                                masters.pop(name))
           for name in list(masters)}
    out["wait_s"] = tp_wait_trees(trees)
    for name, cfg in cells.items():
        if name not in out:
            host = tp_host_params(torch, build.build_model(cfg, topo),
                                  pathlib.Path(trees) / name)
            out[name] = tp_serve_host(torch, topo, name, cfg, host)
    return out


def reckon_tp_serve_bytes(cfg, arch, rows: int, seq: int, model: int,
                          data: int, pods: int, elt: int = 2,
                          prefill: bool = True) -> dict:
    """The bytes one rank sends on each group in a prefill of ``seq``
    tokens of its ``rows`` requests (with a vlm's patches and whisper's
    encoder over its frames) or in a decode step (``prefill`` False, one
    token), over ``model`` ranks and ``data`` x ``pods`` batch ranks,
    activations of ``elt`` bytes; reckoned from the config alone.  A sum
    counts the tensor it is handed, a gather the rank's block
    (``comm.traffic``).  With A the [rows, positions, d_model]
    activations: the vocab-parallel lookup (A, tokens) and the head's
    gather of the last position's vocab block (rows x V/M) where the
    vocabulary divides; each attention's row-parallel sum (A; whisper's
    decoder a second for its cross-attention) where the heads divide;
    each FFN's sum (A: an MLP, or an MoE layer's experts and MLPs in
    one); Mamba2's split norm (f32 a position) and ``out``'s sum, with
    the heads whole the conv output's gather (A d_in/d/M); the mLSTM's
    conv gather, norm and ``down``'s sum (with the heads whole q, k and
    v gathered too); the sLSTM's heads' gather (A/M); and where a
    routing group of the call straddles the batch ranks, the MoE's top-k
    expert ids [positions, k] int32, gathered over the data group and
    then, [data, positions, k], over the pod group."""
    from repro_torch.models import build, layers

    d, m = cfg.d_model, model
    heads_split = cfg.n_heads % m == 0
    t = seq + cfg.n_patches if prefill else 1
    npos = rows * t
    model_b, data_b, pod_b = 0, 0, 0

    def mixer(name, n):
        if name == "mamba":
            s = cfg.ssm
            d_in = s.expand * d
            if d_in % m:
                return 0
            gather = n * d_in // m * elt if (d_in // 64) % m else 0
            return n * 4 + n * d * elt + gather
        if name == "mlstm":
            d_in = int(cfg.xlstm.proj_factor * d)
            if d_in % m:
                return 0
            gather = n * d_in // m * elt
            qkv = 3 * gather if cfg.n_heads % m else 0
            return gather + qkv + n * 4 + n * d * elt
        if name == "slstm":
            return n * d // m * elt if heads_split else 0
        attn = n * d * elt if heads_split else 0
        if name == "dec":
            attn *= 2
        ffn = n * d * elt
        if name == "moe":
            e = cfg.moe
            if not (e.n_experts % m == 0 or e.n_shared
                    or e.dense_residual_ff):
                ffn = 0
        return attn + ffn

    vocab = layers.vocab_sharded(cfg.vocab, m)
    if vocab:
        model_b += rows * (seq if prefill else 1) * d * elt
        model_b += rows * (cfg.vocab // m) * elt
    for name, n in build.occurrence_counts(arch.segments).items():
        model_b += n * mixer(name, npos)
        if name == "moe":
            total = npos * data * pods
            s_len = total // max(1, total // cfg.moe.group_tokens)
            if npos % s_len:        # the groups straddle the batch ranks
                ids = npos * cfg.moe.top_k * 4
                data_b += n * ids if data > 1 else 0
                pod_b += n * data * ids if pods > 1 else 0
    if prefill and arch.enc_segments:
        frames = rows * cfg.encoder_frames
        for name, n in build.occurrence_counts(arch.enc_segments).items():
            model_b += n * mixer(name, frames)
    return {"model": model_b, "data": data_b, "pod": pod_b}


def tp_serve_report(torch, card: str, ranks: list,
                    cells: dict | None = None) -> None:
    """The serve part's checks, from the ranks' results, for each
    config: the reference ranks' logits within TP_SERVE_PREFILL_REL
    (prefill) and TP_SERVE_DECODE_REL (each step) of the one-process
    serve's and the greedy tokens equal; every rank's cache bytes the
    reckoning's after every call; every logit finite; no kernel
    launched; a trained state's views one buffer a rank (on pod 0 its
    bucket); and
    beside them the timed bfloat16 run -- prefill and decode ms, tokens
    a second, each group's bytes a rank sends in the prefill and a
    decode step beside :func:`reckon_tp_serve_bytes`.  A JSON line
    ``{"tp": "serve", ...}`` a config and ``{"tp": "serve part"}``.
    ``cells``: the configs served (:func:`tp_serve_cells` by default)."""
    from repro_torch.core.topology import Topology
    from repro_torch.models import build

    part_s = [0.0] * len(ranks)
    for name, cfg in (cells or tp_serve_cells()).items():
        per = [r["serve_tp"][name] for r in ranks]
        for i, x in enumerate(per):
            part_s[i] += x["s"]
        refs = [x for x in per if "rel_err" in x]
        arch = build.make_archdef(cfg, TP_M)
        rows = TP_SERVE_B // (TP_P * TP_D)
        want = {k: reckon_tp_serve_bytes(cfg, arch, rows, TP_SERVE_PROMPT,
                                         TP_M, TP_D, TP_P, 2, prefill=k)
                for k in (True, False)}
        sent = lambda b: {g: b[g]["sent"] for g in ("model", "data", "pod")}
        decode_s = [sum(x["decode_ms"]) / 1e3 for x in per]
        emit({"tp": "serve", "arch": cfg.name, "card": card,
              "n_layers": cfg.n_layers, "count": build.param_count(
                  build.build_model(cfg, Topology(1, 1, "cpu"))
                  .abstract_params()),
              "grid": list(TP_GRID), "requests": TP_SERVE_B,
              "rows_a_rank": rows, "prompt": TP_SERVE_PROMPT,
              "n_patches": cfg.n_patches, "steps": TP_SERVE_STEPS,
              "max_len": per[0]["max_len"],
              "f32_rel_err_per_reference": [x["rel_err"] for x in refs],
              "limits": [TP_SERVE_PREFILL_REL, TP_SERVE_DECODE_REL],
              "greedy_agree": [x["greedy_agree"] for x in refs],
              "greedy_skipped": sum(x["greedy_skipped"] for x in refs),
              "greedy_positions": sum(x["greedy_positions"] for x in refs),
              "reference_s": [x["reference_s"] for x in refs],
              "f32_cache_bytes_per_rank": [x["f32_cache_bytes"][-1]
                                           for x in per],
              "f32_cache_reckoned": per[0]["f32_cache_reckoned"],
              "bf16_cache_bytes_per_rank": [x["bf16_cache_bytes"]
                                            for x in per],
              "bf16_cache_reckoned": per[0]["bf16_cache_reckoned"],
              "bf16_prefill_ms_per_rank": [x["prefill_ms"] for x in per],
              "bf16_decode_ms_per_rank": [x["decode_ms"] for x in per],
              "bf16_tokens_per_s": TP_SERVE_B * TP_SERVE_STEPS
              / max(decode_s),
              "prefill_bytes_sent_rank0": sent(per[0]["prefill_bytes"]),
              "decode_bytes_sent_rank0": [sent(b) for b in
                                          per[0]["decode_bytes"]],
              "bytes_reckoned": {"prefill": want[True],
                                 "decode_step": want[False]},
              "views_zero_copy": [x.get("views_zero_copy") for x in per],
              "launches_per_rank": [x["launches"] for x in per],
              "rank_s": [x["s"] for x in per]})
        require(len(refs) == 1, f"tp serve {name}: {len(refs)} references")
        for x in refs:
            require(x["rel_err"][0] <= TP_SERVE_PREFILL_REL,
                    f"tp serve {name}: prefill logits {x['rel_err'][0]} "
                    "of the largest from one process's")
            require(max(x["rel_err"][1:]) <= TP_SERVE_DECODE_REL,
                    f"tp serve {name}: decode logits {x['rel_err'][1:]} "
                    "of the largest from one process's")
            require(x["greedy_agree"], f"tp serve {name}: a greedy token "
                    "differs from one process's")
        for r, x in zip(ranks, per):
            require(x["finite"] and x["bf16_finite"],
                    f"tp serve {name}: rank {r['rank']}: a logit not finite")
            require(x["f32_cache_bytes"] == [x["f32_cache_reckoned"]]
                    * (TP_SERVE_STEPS + 1)
                    and x["bf16_cache_bytes"] == x["bf16_cache_reckoned"],
                    f"tp serve {name}: rank {r['rank']}'s cache bytes "
                    f"{x['f32_cache_bytes']}, {x['bf16_cache_bytes']}; "
                    f"reckoned {x['f32_cache_reckoned']}, "
                    f"{x['bf16_cache_reckoned']}")
            require(not any(x["launches"].values()), f"tp serve {name}: "
                    f"rank {r['rank']} launched {x['launches']}")
            require(x.get("views_zero_copy", True), f"tp serve {name}: "
                    "the served views are not one buffer (pod 0: the "
                    "bucket)")
            require(sent(x["prefill_bytes"]) == want[True]
                    and all(sent(b) == want[False]
                            for b in x["decode_bytes"]),
                    f"tp serve {name}: rank {r['rank']} sent "
                    f"{sent(x['prefill_bytes'])} in the prefill, "
                    f"{[sent(b) for b in x['decode_bytes']]} a step; "
                    f"reckoned {want}")
    emit({"tp": "serve part", "card": card, "rank_s": part_s,
          "limit_s": 60.0})


# -- serving from the data ranks' shards (item 17d, part two) -----------------

TP_SHARDS_LONG = 524288          # long_500k's max_len: one request, its
                                 # cache's length split over the data ranks
TP_SHARDS_STRADDLE = 100         # data rank 0 holds positions 0-49: the
                                 # prompt's 48 and steps 1-2 there, steps
                                 # 3-4 written and read on data rank 1
TP_SHARDS_DECODE_REL = 2.0 ** -8  # the length cases' float32 steps: their
                                 # combine keeps float32 weights where the
                                 # reference rounds them to bf16


def tp_shards_cells() -> dict:
    """name -> (config, max_len) of the length part: gemma3-1b whole at
    long_500k's length, and gemma3-1b and zamba2-2.7b (the ``fam`` part's
    period) at ``TP_SHARDS_STRADDLE``; each one request of
    ``TP_SERVE_PROMPT`` tokens and ``TP_SERVE_STEPS`` steps."""
    from repro_torch import configs

    gemma = configs.get_config("gemma3_1b")
    return {"gemma3-1b long": (gemma, TP_SHARDS_LONG),
            "gemma3-1b straddle": (gemma, TP_SHARDS_STRADDLE),
            "zamba2-2.7b straddle": (tp_fam_cells()["zamba2-2.7b"][0],
                                     TP_SHARDS_STRADDLE)}


def tp_shards_gather(torch, topo, name: str, cfg, masters) -> dict:
    """:func:`tp_serve` in the gather layout from the FSDP ``masters`` a
    training run left on the rank (``[P_loc, *shard]``): every pod serves
    edge 0's shards (``specs.serve_params_from_tree``; pod 1's received),
    each layer gathered over the data group at every call; the
    reference's whole tree assembled on pod 0, each leaf's shards
    gathered over the data group and data rank 0's blocks over the model
    group, kept on model rank 0 alone."""
    from repro_torch.core import comm, device_axis, pytree, shardflat
    from repro_torch.launch import specs
    from repro_torch.models import build

    built = build.build_model(cfg, topo, layout="gather")
    shards = specs.serve_params_from_tree(masters, None, built)
    m = topo.mesh

    def whole():
        layout = shardflat.param_layout(topo, built.bundle.specs,
                                        built.abstract_params())
        leaves, td = pytree.tree_flatten(shards)
        out = []
        for x, sp, slot in zip(leaves, pytree.flatten_up_to(
                td, built.bundle.master_specs), layout.slots):
            dim = device_axis.data_dim(sp)
            if dim is not None:
                x = comm.gather_shards(topo, x, dim)
            if m.data_rank == 0 and layout.shards > 1 \
                    and slot.shard_dim is not None:
                x = comm.gather_model(topo, x, slot.shard_dim)
            out.append(x if m.data_rank == 0 and m.model_rank == 0
                       else None)
        return (pytree.tree_unflatten(td, out)
                if m.data_rank == 0 and m.model_rank == 0 else None)

    return tp_serve(torch, topo, name, cfg, shards, whole, layout="gather",
                    warm=False)


def tp_shards_len(torch, topo, name: str, cfg, max_len: int, host) -> dict:
    """One request (the first of :func:`tp_serve_requests`) replicated over
    the batch ranks, served with its cache's length split over the data
    ranks (``len_axis="data"``) from the rank's blocks of the mapped
    seed-0 tree ``host`` (zamba2's ``a_log`` lowered by ``TP_FAM_CALM``,
    as the ``fam`` part trains it): model rank 0 of the first batch rank
    serves it alone on the whole cache in float32 first and its greedy
    tokens are the teacher's; then every rank prefills and decodes them
    between synchronisations and barriers, with float32 weights and then
    with bfloat16 ones (the float32 blocks cast on the device) -- the
    largest difference from the reference's logits over its largest
    |logit|, each call's cache bytes beside ``build.cache_bytes``, each
    group's bytes a rank sends, the ms of each call -- with the kernels'
    counters zeroed first."""
    import torch.distributed as dist

    from repro_torch.core import comm, pytree
    from repro_torch.core.topology import Topology
    from repro_torch.models import build

    dev = topo.device
    t_start = time.perf_counter()
    zero_launches()
    m = topo.mesh
    built = build.build_model(cfg, topo)
    req = {k: v[:1] for k, v in tp_serve_requests(torch, cfg, name).items()}
    calm = cfg.family == "hybrid"
    res = {"max_len": max_len}
    ref = None
    teacher = torch.zeros((1, TP_SERVE_STEPS), dtype=torch.long)
    if (m.pod_rank, m.data_rank, m.model_rank) == (0, 0, 0):
        t0 = time.perf_counter()
        tree = pytree.tree_map(lambda x: x.to(dev, torch.float32), host)
        if calm:
            calm_a_log(tree)
        plain = build.build_model(cfg, Topology(1, 1, dev))
        logits, cache = plain.prefill(tree, {k: v.to(dev) for k, v in
                                             req.items()}, max_len)
        ref, toks = [logits[:, -1].float()], []
        for _ in range(TP_SERVE_STEPS):
            tok = torch.argmax(logits[:, -1:], dim=-1)
            toks.append(tok)
            logits, cache = plain.decode_step(tree, cache, tok)
            ref.append(logits[:, -1].float())
        synchronize(torch, dev)
        res["reference_s"] = time.perf_counter() - t0
        teacher = torch.cat(toks, dim=1).cpu()
        del tree, plain, cache, logits
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    dist.all_reduce(teacher)
    params = host_blocks(torch, topo, built, host, torch.float32)
    if calm:
        calm_a_log(params)
    prefill, decode = build.make_serve_fns(built.arch, topo, "resident",
                                           rows="replicated",
                                           len_axis="data")
    batch = {k: v.to(dev) for k, v in req.items()}
    steps = teacher.to(dev)

    def serve(params, dtype) -> dict:
        got, held, ms, sent = [], [], [], []
        for s in range(TP_SERVE_STEPS + 1):
            dist.barrier()
            synchronize(torch, dev)
            comm.reset_traffic()
            t0 = time.perf_counter()
            if s == 0:
                logits, cache = prefill(params, batch, max_len)
            else:
                logits, cache = decode(params, cache, steps[:, s - 1:s])
            synchronize(torch, dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            sent.append({g: b["sent"] for g, b in comm.group_bytes().items()})
            got.append(logits[:, -1].float())
            held.append(cache_bytes_of(cache))
        out = {"ms": ms, "bytes_sent": sent, "cache_bytes": held,
               "cache_reckoned": build.cache_bytes(
                   built.arch, 1, max_len, topo, dtype, len_axis="data"),
               "finite": all(bool(torch.isfinite(x).all()) for x in got)}
        if ref is not None:
            out["rel_err"] = [float((g - w).abs().max()) / float(w.abs().max())
                              for g, w in zip(got, ref)]
        del cache, logits, got
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        return out

    res["f32"] = serve(params, torch.float32)
    leaves, td = pytree.tree_flatten(params)
    del params
    for i, x in enumerate(leaves):      # the float32 block freed as cast
        leaves[i] = x.to(torch.bfloat16) if x.dtype.is_floating_point else x
    params = pytree.tree_unflatten(td, leaves)
    del leaves
    res["bf16"] = serve(params, torch.bfloat16)
    del params, ref
    res["whole_cache_bytes"] = build.cache_bytes(built.arch, 1, max_len,
                                                 None, torch.float32)
    res["launches"] = counted_launches()
    res["s"] = time.perf_counter() - t_start
    return res


def calm_a_log(tree) -> None:
    """zamba2's every ``a_log`` lowered by ``TP_FAM_CALM`` (a new tensor:
    the tree may hold views of a map)."""
    mamba = tree["stacks"]["mamba"]["mamba"]
    mamba["a_log"] = mamba["a_log"] - TP_FAM_CALM


def tp_shards_rank(torch, topo, trees: str, masters: dict) -> dict:
    """The rank's shards part: the ``moe`` part's trained FSDP
    ``masters`` served in the gather layout (:func:`tp_shards_gather`;
    popped: each freed once served), then the length part for each
    :func:`tp_shards_cells` config from the trees the parent writes
    under ``trees``."""
    from repro_torch.models import build

    cells = tp_moe_cells()
    out = {name: tp_shards_gather(torch, topo, name, cells[name],
                                  masters.pop(name))
           for name in list(masters)}
    out["wait_s"] = tp_wait_trees(trees)
    for name, (cfg, max_len) in tp_shards_cells().items():
        host = tp_host_params(torch, build.build_model(cfg, topo),
                              pathlib.Path(trees) / name.split()[0])
        out[name] = tp_shards_len(torch, topo, name, cfg, max_len, host)
        del host
    return out


def reckon_serve_gather_bytes(cfg, devices: int, data: int, model: int,
                              elt: int) -> int:
    """The bytes a rank sends over the data group in one call of the
    gather layout (``comm.traffic``'s ``gather_serve``): its shard of
    every leaf the FSDP master specs split over the data axis, at the
    global D ``devices`` and model axis ``model`` -- the embedding, the
    head and every layer once a call (a tied block once), not MTP's --,
    in ``elt`` bytes; it receives ``data - 1`` times that, its compute
    blocks less its shard."""
    from repro_torch.core import device_axis, pytree
    from repro_torch.models import build

    arch = build.make_archdef(cfg, model)
    abstract = build.init_params(arch, None, "meta")
    mspecs = build.serve_master_specs(arch, devices, model)
    sizes = {"pod": 1, "data": data, "model": model}
    total = 0
    for name, tree in abstract.items():
        if name == "mtp":
            continue
        leaves, td = pytree.tree_flatten(tree)
        for a, sp in zip(leaves, pytree.flatten_up_to(td, mspecs[name])):
            if device_axis.data_dim(sp) is not None:
                total += math.prod(build.block_shape(tuple(a.shape), sp,
                                                     sizes)) * elt
    return total


def reckon_combine_bytes(cfg, arch, t: int, model: int, rows: int = 1) -> int:
    """The bytes a rank sends over the data group in a decode step of
    ``t`` tokens on a cache split by length (``comm.traffic``'s
    ``combine_data``): for each occurrence of a block whose cache spec
    splits the length, the rank's heads' row max, sum and weighted
    values, float32: ``rows x heads x t x (2 + e)`` with e the head dim
    (GQA) or the latent rank (MLA), the heads split where they divide
    the model axis."""
    from repro_torch.models import build

    specs = build.cache_specs(arch, None, "data")["stacks"]
    heads = cfg.n_heads // model if cfg.n_heads % model == 0 else cfg.n_heads
    total = 0
    for name, n in build.occurrence_counts(arch.segments).items():
        sp = specs.get(name)
        leaf = sp["self"] if sp is not None and "self" in sp else sp
        if leaf is None or "data" not in next(iter(leaf.values())):
            continue
        e = cfg.mla.kv_lora_rank if "ckv" in leaf else cfg.hd
        total += n * rows * heads * t * (2 + e) * 4
    return total


def tp_shards_report(torch, card: str, ranks: list, gather_cells=None,
                     len_cells=None) -> dict:
    """The shards part's checks, from the ranks' results.  The gather
    layout (deepseek-v3 and internvl2 from the ``moe`` part's FSDP
    state): the reference rank's float32 logits within
    TP_SERVE_PREFILL_REL (prefill) and TP_SERVE_DECODE_REL (each step)
    of the one-process serve of edge 0's gathered masters, the greedy
    tokens equal, every logit finite, every rank's cache bytes the
    reckoning's, no kernel launched, and each group's bytes a rank sends
    in the bfloat16 prefill and each step those the resident layout
    sends (:func:`reckon_tp_serve_bytes`) plus, over the data group, its
    shards of every layer (:func:`reckon_serve_gather_bytes`; it
    receives its compute blocks less its shard).  The length part: the
    reference rank's float32 logits within TP_SERVE_PREFILL_REL
    (prefill) and TP_SHARDS_DECODE_REL (each step), the bfloat16 ones'
    distance from them recorded; with each dtype's weights every logit
    finite, each call's cache bytes ``build.cache_bytes``'s with the
    length split (below the whole cache's), and each group's bytes a
    rank sends at prefill and each step the resident reckoning's (one
    row) plus, over the data group at a step, the split attention's
    combines (:func:`reckon_combine_bytes`); no kernel launched.  A JSON line
    ``{"tp": "shards", ...}`` a config and ``{"tp": "shards part"}``.
    ``gather_cells``, ``len_cells``: the configs served
    (:func:`tp_moe_cells`, :func:`tp_shards_cells` by default).  Returns
    each config's per-rank launches."""
    from repro_torch.core.topology import Topology
    from repro_torch.models import build

    launches, part_s = {}, [0.0] * len(ranks)
    for name, cfg in (gather_cells or tp_moe_cells()).items():
        per = [r["shards_tp"][name] for r in ranks]
        for i, x in enumerate(per):
            part_s[i] += x["s"]
        refs = [x for x in per if "rel_err" in x]
        arch = build.make_archdef(cfg, TP_M)
        rows = TP_SERVE_B // (TP_P * TP_D)
        shards = reckon_serve_gather_bytes(cfg, TP_D, TP_D, TP_M, 2)
        want = {}
        for k in (True, False):
            want[k] = reckon_tp_serve_bytes(cfg, arch, rows, TP_SERVE_PROMPT,
                                            TP_M, TP_D, TP_P, 2, prefill=k)
            want[k]["data"] += shards
        sent = lambda b: {g: b[g]["sent"] for g in ("model", "data", "pod")}
        received = [b["data"]["received"] for b in per[0]["decode_bytes"]]
        decode_s = [sum(x["decode_ms"]) / 1e3 for x in per]
        emit({"tp": "shards", "layout": "gather", "arch": cfg.name,
              "card": card, "n_layers": cfg.n_layers,
              "count": build.param_count(build.build_model(
                  cfg, Topology(1, 1, "cpu")).abstract_params()),
              "grid": list(TP_GRID), "requests": TP_SERVE_B,
              "rows_a_rank": rows, "prompt": TP_SERVE_PROMPT,
              "steps": TP_SERVE_STEPS, "max_len": per[0]["max_len"],
              "f32_rel_err_per_reference": [x["rel_err"] for x in refs],
              "limits": [TP_SERVE_PREFILL_REL, TP_SERVE_DECODE_REL],
              "greedy_agree": [x["greedy_agree"] for x in refs],
              "greedy_skipped": sum(x["greedy_skipped"] for x in refs),
              "reference_s": [x["reference_s"] for x in refs],
              "f32_cache_bytes_per_rank": [x["f32_cache_bytes"][-1]
                                           for x in per],
              "f32_cache_reckoned": per[0]["f32_cache_reckoned"],
              "bf16_prefill_ms_per_rank": [x["prefill_ms"] for x in per],
              "bf16_decode_ms_per_rank": [x["decode_ms"] for x in per],
              "bf16_tokens_per_s": TP_SERVE_B * TP_SERVE_STEPS
              / max(decode_s),
              "prefill_bytes_sent_rank0": sent(per[0]["prefill_bytes"]),
              "decode_bytes_sent_rank0": [sent(b) for b in
                                          per[0]["decode_bytes"]],
              "decode_data_bytes_received_rank0": received,
              "bytes_reckoned": {"prefill": want[True],
                                 "decode_step": want[False],
                                 "shards_a_call": shards},
              "launches_per_rank": [x["launches"] for x in per],
              "rank_s": [x["s"] for x in per]})
        require(len(refs) == 1, f"tp shards {name}: {len(refs)} references")
        for x in refs:
            require(x["rel_err"][0] <= TP_SERVE_PREFILL_REL,
                    f"tp shards {name}: prefill logits {x['rel_err'][0]} "
                    "of the largest from one process's")
            require(max(x["rel_err"][1:]) <= TP_SERVE_DECODE_REL,
                    f"tp shards {name}: decode logits {x['rel_err'][1:]} "
                    "of the largest from one process's")
            require(x["greedy_agree"], f"tp shards {name}: a greedy token "
                    "differs from one process's")
        for r, x in zip(ranks, per):
            require(x["finite"] and x["bf16_finite"],
                    f"tp shards {name}: rank {r['rank']}: a logit not "
                    "finite")
            require(x["f32_cache_bytes"] == [x["f32_cache_reckoned"]]
                    * (TP_SERVE_STEPS + 1), f"tp shards {name}: rank "
                    f"{r['rank']}'s cache bytes {x['f32_cache_bytes']}, "
                    f"reckoned {x['f32_cache_reckoned']}")
            require(not any(x["launches"].values()), f"tp shards {name}: "
                    f"rank {r['rank']} launched {x['launches']}")
            require(sent(x["prefill_bytes"]) == want[True]
                    and all(sent(b) == want[False]
                            for b in x["decode_bytes"])
                    and all(b["data"]["received"] == (TP_D - 1)
                            * b["data"]["sent"] for b in x["decode_bytes"]),
                    f"tp shards {name}: rank {r['rank']} sent "
                    f"{sent(x['prefill_bytes'])} in the prefill, "
                    f"{[sent(b) for b in x['decode_bytes']]} a step; "
                    f"reckoned {want}")
        launches[name] = [x["launches"] for x in per]
    for name, (cfg, max_len) in (len_cells or tp_shards_cells()).items():
        per = [r["shards_tp"][name] for r in ranks]
        for i, x in enumerate(per):
            part_s[i] += x["s"]
        refs = [x for x in per if "reference_s" in x]
        arch = build.make_archdef(cfg, TP_M)
        want = {dt: [{g: b + (reckon_combine_bytes(cfg, arch, 1, TP_M)
                              if g == "data" and s else 0)
                      for g, b in reckon_tp_serve_bytes(
                          cfg, arch, 1, TP_SERVE_PROMPT, TP_M, 1, 1, elt,
                          prefill=s == 0).items()}
                     for s in range(TP_SERVE_STEPS + 1)]
                for dt, elt in (("f32", 4), ("bf16", 2))}
        emit({"tp": "shards", "layout": "len_axis data", "arch": cfg.name,
              "case": name, "card": card, "n_layers": cfg.n_layers,
              "grid": list(TP_GRID), "requests": 1,
              "prompt": TP_SERVE_PROMPT, "steps": TP_SERVE_STEPS,
              "max_len": max_len,
              "f32_rel_err_per_reference": [x["f32"]["rel_err"]
                                            for x in refs],
              "limits": [TP_SERVE_PREFILL_REL, TP_SHARDS_DECODE_REL],
              "bf16_rel_err_per_reference": [x["bf16"]["rel_err"]
                                             for x in refs],
              "reference_s": [x["reference_s"] for x in refs],
              "cache_bytes_per_rank": [x["f32"]["cache_bytes"][-1]
                                       for x in per],
              "cache_reckoned": per[0]["f32"]["cache_reckoned"],
              "whole_cache_bytes": per[0]["whole_cache_bytes"],
              "f32_ms_per_rank": [x["f32"]["ms"] for x in per],
              "bf16_ms_per_rank": [x["bf16"]["ms"] for x in per],
              "bytes_sent_rank0": {dt: per[0][dt]["bytes_sent"]
                                   for dt in want},
              "bytes_reckoned": want,
              "launches_per_rank": [x["launches"] for x in per],
              "rank_s": [x["s"] for x in per]})
        require(len(refs) == 1, f"tp shards {name}: {len(refs)} references")
        for x in refs:
            err = x["f32"]["rel_err"]
            require(err[0] <= TP_SERVE_PREFILL_REL
                    and max(err[1:]) <= TP_SHARDS_DECODE_REL,
                    f"tp shards {name}: logits {err} of the largest from "
                    "one process's on the whole cache")
        for r, x in zip(ranks, per):
            for dt in want:
                y = x[dt]
                require(y["finite"], f"tp shards {name}: rank {r['rank']}: "
                        f"a {dt} logit not finite")
                require(y["cache_bytes"] == [y["cache_reckoned"]]
                        * (TP_SERVE_STEPS + 1)
                        and y["cache_reckoned"] < x["whole_cache_bytes"],
                        f"tp shards {name}: rank {r['rank']}'s {dt} cache "
                        f"bytes {y['cache_bytes']}, reckoned "
                        f"{y['cache_reckoned']} (whole "
                        f"{x['whole_cache_bytes']})")
                require(y["bytes_sent"] == want[dt], f"tp shards {name}: "
                        f"rank {r['rank']} sent {y['bytes_sent']} ({dt}); "
                        f"reckoned {want[dt]}")
            require(not any(x["launches"].values()), f"tp shards {name}: "
                    f"rank {r['rank']} launched {x['launches']}")
        launches[name] = [x["launches"] for x in per]
    emit({"tp": "shards part", "card": card, "rank_s": part_s,
          "limit_s": 40.0})
    return launches


def block_numel(shape, spec, model: int) -> int:
    """A leaf's coordinates on one model rank: the dim its spec names
    ``"model"`` on (alone or as ``("model", "data")``) cut in ``model``
    even blocks; the whole leaf where none is."""
    numel = math.prod(shape)
    for entry in spec or ():
        names = entry if isinstance(entry, tuple) else (entry,)
        if "model" in names and model > 1:
            return numel // model
    return numel


def mesh_leaves(built, model: int) -> list:
    """(name, layers, per-layer coordinates on a model rank, the
    per-layer master spec) of every leaf: a stack's without its layer
    dim (``layers`` its count), another's whole (``layers`` 0)."""
    abstract = built.abstract_params()
    out = []
    for (name, leaf), spec in zip(pytree_items(abstract), flat_specs(
            built.bundle.master_specs, abstract)):
        stacked = name.startswith("stacks.")
        shape, sp = ((leaf.shape[1:], spec[1:]) if stacked
                     else (leaf.shape, spec))
        out.append((name, leaf.shape[0] if stacked else 0,
                     block_numel(shape, sp, model), sp))
    return out


def reckon_fsdp_mesh_bytes(built, data: int, pods: int,
                           model: int = 1) -> dict:
    """The bytes one rank sends on each group in a local and in a
    prologue step of the FSDP regime over ``pods x data x model`` ranks
    with a [1, 1] block (P_loc = D_loc = 1), reckoned from the leaves
    and their master specs before any run (bf16 compute and delta, f32
    master, DC, fused, every layer recomputed under remat).  Each leaf
    counts at its model block (:func:`block_numel`).  A data-sharded
    leaf of s coordinates a shard: the forward's gather sends its bf16
    shard, 2s, once a pass and again in the recompute (a stacked leaf);
    the backward's correction gather 2s and the words (data - 1) s/8, s
    padded to the 4096-coordinate tile for both; in a prologue the
    anchor pass's gathers again, wmean's f32 terms (data - 1) 4s, and
    over the pod group the cloud mean of the master and of c_q, 4s
    each.  A leaf no spec shards moves its words (and terms) by
    ``gather_devices``: n/8 (4n).  The model group's bytes are
    :func:`reckon_tp_model_bytes`'."""
    from repro_torch.core import device_axis

    tile = 4096
    fwd = delta = words = terms = pod = 0
    for _, stack, numel, spec in mesh_leaves(built, model):
        layers = max(stack, 1)
        dim = device_axis.data_dim(spec)
        passes = 2 if stack else 1
        if dim is None or data == 1:
            words += layers * (numel + 31) // 32 * 4
            terms += layers * 4 * numel
            pod += layers * 8 * numel
            continue
        s = numel // data
        s_pad = -(-s // tile) * tile
        fwd += layers * passes * 2 * s
        delta += layers * 2 * s_pad
        words += layers * (data - 1) * s_pad // 8
        terms += layers * (data - 1) * 4 * s
        pod += layers * 8 * s
    local = fwd + delta + words
    return {"data": {"local_step": local,
                     "prologue_step": local + fwd + terms},
            "pod": {"local_step": 0,
                    "prologue_step": pod if pods > 1 else 0}}


def reckon_tp_model_bytes(cfg, arch, batch: int, seq: int, model: int,
                          elt: int = 2, lead: int = 1,
                          fsdp: bool = True) -> dict:
    """The bytes one rank sends on the model group in a local and in a
    prologue step (the anchor pass runs the loss a second time) of the
    tensor-parallel loss over ``model`` ranks, in the FSDP regime (or the
    replicated one, ``fsdp`` False: a tied block is recomputed there),
    with ``lead`` replicas a rank, ``batch`` rows of ``seq`` tokens (and a
    vlm's patches, whisper's frames) and activations of ``elt`` bytes,
    reckoned from the config alone.  A sum counts the tensor it is handed
    (``comm.traffic``: a bf16 sum as bf16), a gather the rank's block, its
    reduce-scatter backward the whole gradient.  With A the [rows,
    positions, d_model] activations, each block's forward sums, the part
    of them its recompute runs again and its backward's sums:

      * the vocab-parallel lookup (A, tokens only) and each
        cross-entropy's max, sum of exponentials and gold logit (f32 a
        position), each head's input marked (A) -- none where the
        vocabulary does not divide;
      * attention (GQA, MLA, whisper's bidirectional encoder and its
        cross-attention): the row-parallel sum (A), recomputed; backward
        the marked input (A; and the whole kv heads, repeated, where they
        do not split; MLA's query latent, kv latent and rope key; the
        cross keys' and values' encoder output, frames x d_model); an FFN
        (an MLP or an MoE layer's experts and MLPs in one): the sum (A),
        not recomputed (the checkpoint stops once the last tensor its
        backward saved is back, and nothing after the FFN's sum is saved),
        backward the marked input (A; an MoE's f32 combine [g, S, E, C]
        where the experts split);
      * Mamba2: the split norm's sum of squares (f32 a position) and
        ``out``'s sum (A), the first recomputed; backward the marked input
        (A), ``in_b``/``in_c`` and the norm's sum; with the heads whole,
        the conv output's gather (A d_in/d/M, recomputed, its
        reduce-scatter A d_in/d) and ``in_dt``, ``dt_bias``, ``a_log``,
        ``d_skip`` marked;
      * the mLSTM: the conv output's gather and the norm's sum, both
        recomputed, and ``down``'s sum; backward ``up``'s output (A 2
        d_in/d), the gather's reduce-scatter and the norm's sum; with the
        heads whole, q, k and v gathered as one (and their reduce-scatter)
        and ``wi``, ``wf``, ``fb`` marked;
      * the sLSTM (not recomputed): its heads' gather (A/M), backward the
        whole gates (4A).

    deepseek-v3's MTP runs its lookup, its block (not recomputed) and its
    head once more on the tokens; under FSDP a tied block (zamba2's shared
    attention) is applied without the recompute."""
    from repro_torch.models import build, layers, moe

    d, m = cfg.d_model, model
    tok = lead * batch * seq
    pos = lead * batch * (seq + cfg.n_patches)
    heads_split = cfg.n_heads % m == 0

    def attn(npos):
        if not heads_split:
            return 0, 0
        if cfg.mla is not None:
            r = cfg.mla
            return npos * d * elt, npos * elt * (
                r.q_lora_rank + r.kv_lora_rank + r.qk_rope_head_dim)
        bwd = npos * d * elt
        if cfg.qk_norm:
            bwd += lead * cfg.hd * elt * (1 if cfg.n_kv_heads % m else 2)
        if cfg.n_kv_heads % m:
            bwd += 2 * npos * cfg.n_heads * cfg.hd * elt
        return npos * d * elt, bwd

    def ffn(block, npos):
        if block != "moe":
            return npos * d * elt, npos * d * elt
        e = cfg.moe
        split = e.n_experts % m == 0
        if not (split or e.n_shared or e.dense_residual_ff):
            return 0, 0
        bwd = npos * d * elt
        if split:
            per = batch * (seq + cfg.n_patches)
            g = max(1, per // e.group_tokens)
            s_len = per // g
            bwd += lead * g * s_len * e.n_experts * moe.capacity(
                s_len, e) * 4
        return npos * d * elt, bwd

    def mamba(npos):
        s = cfg.ssm
        d_in = s.expand * d
        h = d_in // 64
        if d_in % m:
            return 0, 0, 0
        act = npos * d * elt
        norm = npos * 4
        fwd, rec = norm + act, norm
        bwd = act + 2 * lead * d * s.n_groups * s.d_state * elt + norm
        if h % m:
            gather = npos * d_in // m * elt
            fwd += gather
            rec += gather
            bwd += npos * d_in * elt + lead * (d * h + 3 * h) * elt
        return fwd, rec, bwd

    def mlstm(npos):
        d_in = int(cfg.xlstm.proj_factor * d)
        h = cfg.n_heads
        if d_in % m:
            return 0, 0, 0
        gather = npos * d_in // m * elt
        norm = npos * 4
        fwd = rec = gather + norm
        fwd += npos * d * elt
        bwd = npos * 2 * d_in * elt + npos * d_in * elt + norm
        if h % m:
            fwd += 3 * gather
            rec += 3 * gather
            bwd += 3 * npos * d_in * elt + lead * (2 * d_in * h + h) * elt
        return fwd, rec, bwd

    def slstm(npos):
        if cfg.n_heads % m:
            return 0, 0, 0
        return npos * d // m * elt, 0, npos * 4 * d * elt

    frames = lead * batch * cfg.encoder_frames

    def block_bytes(name, npos):
        """(forward, recomputed, backward) bytes of one occurrence."""
        if name == "mamba":
            return mamba(npos)
        if name == "mlstm":
            return mlstm(npos)
        if name == "slstm":
            return slstm(npos)
        a, b = attn(npos)
        f, g = ffn(name, npos)
        if name == "dec" and heads_split:      # the cross-attention
            a, b = 2 * a, b + npos * d * elt + (
                frames * d * elt if cfg.n_kv_heads % m == 0
                else 2 * frames * cfg.n_heads * cfg.hd * elt)
        return a + f, a, b + g

    vocab = layers.vocab_sharded(cfg.vocab, m)
    xent = 3 * tok * 4 if vocab else 0
    look = tok * d * elt if vocab else 0
    fwd, bwd = look + xent, look                      # lookup; head input
    tied = {name for seg in arch.segments for name in seg.tied}
    runs = [(n, arch.blocks[name], name, pos) for name, n in
            build.occurrence_counts(arch.segments).items()]
    if arch.enc_segments:
        runs += [(n, arch.enc_blocks[name], name, frames) for name, n in
                 build.occurrence_counts(arch.enc_segments).items()]
    for n, bd, name, npos in runs:
        f, r, b = block_bytes(name, npos)
        again = cfg.remat and bd.remat and not (fsdp and name in tied)
        fwd += n * (f + (r if again else 0))
        bwd += n * b
    if arch.mtp_block is not None:
        a, b = attn(tok)
        f, g = ffn("mlp", tok)
        fwd += look + xent + a + f
        bwd += b + g + look
    return {"local_step": fwd + bwd, "prologue_step": 2 * (fwd + bwd)}


def flat_specs(specs, abstract) -> list:
    """``specs`` in ``pytree_items(abstract)``'s order."""
    from repro_torch.core import pytree

    return pytree.flatten_up_to(pytree.tree_flatten(abstract)[1], specs)


def reckon_fsdp_mesh_peak(built, batch: int, seq: int, data: int,
                          model: int = 1, host_init: bool = False) -> dict:
    """A mesh rank's peak device memory (GB) in an FSDP run over ``data``
    data ranks and ``model`` model ranks with a [1, 1] block, reckoned
    before any run from each leaf's model block (:func:`block_numel`):
    ``reckon_fsdp_peak``'s terms at p = d = 1 with the state and the
    means at the shard's size (n/data); at the table's vote (t
    coordinates), its bf16 cotangent 2t, its gathered correction 2t and
    the backward's shard-major copy of the cotangent 2t (the correction
    added in place); at its mean, the cotangent, the copy and the f32
    mean 4t/data; at the head, its lifted leaf h (the table when tied,
    else ``head.out``) and MTP's lifted subtree u, the logits of the
    rank's vocab block (twice with MTP) and the head's cotangent 2h; at
    a layer's vote (or MTP's), its lifted leaves 2L, its largest leaf
    l's cotangent, gathered correction and shard-major copy 6l -- an
    MoE layer's expert block outweighs the table; and the init: the
    full float32 tree before the rank cuts its shards (4n + 4n/data),
    or with ``host_init`` (parameters handed over on the host, moved
    and cut a leaf at a time) the master so far and one whole leaf
    (4n/data + 4 l_max).  Each direction goes into its master as soon
    as it is known (``hier``), so none waits."""
    from repro_torch.models import layers

    cfg = built.cfg
    leaves = mesh_leaves(built, model)
    n = sum(max(stack, 1) * numel for _, stack, numel, _ in leaves)
    size = {name: numel for name, _, numel, _ in leaves}
    t = size["embed.table"]
    h = t if cfg.tie_embed else size["head.out"]
    mtp = sum(numel for name, _, numel, _ in leaves
              if name.startswith("mtp."))
    vocab = (cfg.vocab // model if layers.vocab_sharded(cfg.vocab, model)
             else cfg.vocab)
    abstract = built.abstract_params()
    biggest = max(math.prod(a.shape) for _, a in pytree_items(abstract))
    units = [[numel for name, _, numel, _ in leaves
              if name.startswith(f"stacks.{block}.")]
             for block in abstract["stacks"]]
    units.append([numel for name, _, numel, _ in leaves
                  if name.startswith("mtp.")])
    tt = {"state": 8 * n / data, "cot": 2 * h,
          "logits": 18 * batch * seq * vocab * (2 if mtp else 1),
          "lifted": 2 * (h + mtp), "by_shard": 2 * t,
          "delta_gathered": 2 * t, "mean": 4 * t / data,
          "layer": max(2 * sum(u) + 6 * max(u) for u in units if u),
          "init": (4 * n / data + 4 * biggest if host_init
                   else 4 * n + 4 * n / data)}
    head = tt["lifted"] + tt["logits"] + tt["cot"]
    vote = 2 * t + tt["delta_gathered"] + tt["by_shard"]
    mean = 2 * t + tt["by_shard"] + tt["mean"]
    peak = max(tt["init"], tt["state"] + max(head, vote, mean, tt["layer"]))
    return {"peak_gb": peak / 1e9,
            **{f"{k}_gb": v / 1e9 for k, v in tt.items()}}


def fsdp_mesh_report(torch, card: str, mesh_ranks: list,
                     tp_ranks: list) -> dict:
    """The checks of the FSDP regime across processes, from the ranks'
    results: (1) the lift's shards bitwise the one-process lift's
    slices, fused and wmean, every rank launching one sign_pack and one
    vote_update a fused lift; (2) gemma3-1b FSDP over the 8 tp ranks
    bitwise the replicated regime over them (0 differing); (3)
    gemma3-12b over the 4 mesh ranks: step 1's loss (after the prologue)
    below step 0's, one sign_pack and one vote_update a leaf and layer a
    step in every rank, each group's bytes a local and a prologue step
    beside the reckoning, the state's bytes beside half the one-process
    state's, the step times and the peak beside its reckoning.
    Returns the per-rank launches of the three."""
    from repro_torch.core.topology import Topology

    t0 = time.perf_counter()
    lifts = [r["fsdp_lift"] for r in mesh_ranks]
    for rank, rows in zip(mesh_ranks, lifts):
        for row in rows:
            tag = f"rank {rank['rank']} {row['leaf']} {row['transport']}"
            require(row["differing"] == 0, f"fsdp mesh lift {tag}: "
                    f"{row['differing']} of {row['coordinates']} "
                    "coordinates differ from the one-process lift")
            require(row["copies_ok"], f"fsdp mesh lift {tag}: the forward's "
                    "copies are not the rank's block of the master")
            want = (1 if row["transport"] == "fused" else 0)
            require(row["launches"]["sign_pack"] == want
                    and row["launches"]["vote_update"] == want,
                    f"fsdp mesh lift {tag}: launches {row['launches']}")
    emit({"fsdp_mesh": "lift", "card": card, "grid": list(MESH_GRID),
          "mask": FSDP_MESH_MASK, "rows_rank0": lifts[0],
          "differing_per_rank": [sum(x["differing"] for x in rows)
                                 for rows in lifts],
          "fused_launches_per_rank": [
              {k: sum(x["launches"][k] for x in rows) for k in KERNEL_NAMES}
              for rows in lifts]})

    tp = [r["fsdp_tp"] for r in tp_ranks]
    differ = sum(x["differing"] for x in tp)
    total = sum(x["coordinates"] for x in tp)
    steps_leaves = FSDP_TP_STEPS * tp[0]["leaf_layers"]
    emit({"fsdp_mesh": "gemma3-1b fsdp vs replicated", "card": card,
          "grid": list(TP_GRID), "steps": FSDP_TP_STEPS,
          "differing": differ, "coordinates_over_ranks": total,
          "losses_fsdp": tp[0]["losses_fsdp"],
          "losses_replicated": tp[0]["losses_replicated"],
          "ms_fsdp_per_rank": [x["ms_fsdp"] for x in tp],
          "ms_replicated_per_rank": [x["ms_replicated"] for x in tp],
          "launches_per_rank": [x["launches"] for x in tp]})
    for x in tp:
        require(x["losses_fsdp"] == x["losses_replicated"]
                == tp[0]["losses_fsdp"], "gemma3-1b fsdp mesh: the losses "
                "differ from the replicated run's or across ranks")
        require(x["launches"] == {"sign_pack": steps_leaves,
                                  "vote_update": steps_leaves,
                                  "tally_acc": 0, "ternary_quant": 0},
                f"gemma3-1b fsdp mesh launches {x['launches']}")
    require(differ == 0, f"gemma3-1b fsdp over the 8 ranks: {differ} of "
            f"{total} coordinates differ from the replicated regime")

    lm = [r["fsdp_lm"] for r in mesh_ranks]
    topo = Topology(MESH_P, MESH_D, "cuda")
    cfg, built = fsdp_mesh_model(topo)
    abstract = built.abstract_params()
    n = sum(math.prod(a.shape) for _, a in pytree_items(abstract))
    leaves = len(lift_rows(abstract))
    predicted = reckon_fsdp_mesh_bytes(built, MESH_GRID[1], MESH_GRID[0])
    reckoned = reckon_fsdp_mesh_peak(built, 1, FSDP_SEQ, MESH_GRID[1])
    one_process = {"params": 4 * n, "delta": 2 * n, "delta_next": 2 * n}
    losses = lm[0]["losses"]
    sent = [{g: {"local_step": x["bytes_per_step"][1][g]["sent"],
                 "prologue_step": x["bytes_per_step"][0][g]["sent"]}
             for g in ("data", "pod", "model")} for x in lm]
    emit({"fsdp_mesh": "gemma3-12b", "card": card, "arch": cfg.name,
          "n_layers": cfg.n_layers, "count": n, "grid": list(MESH_GRID),
          "P": MESH_P, "D": MESH_D, "seq": FSDP_SEQ,
          "steps": FSDP_MESH_STEPS, "losses": losses,
          "last_loss": losses[-1],
          "held_bytes_per_rank": [x["held_bytes"] for x in lm],
          "one_process_bytes_a_pod_row": one_process,
          "launches_per_rank": [x["launches"] for x in lm],
          "leaf_layers_a_step": leaves,
          "bytes_sent_per_rank": sent,
          "bytes_per_step_rank0": lm[0]["bytes_per_step"],
          "bytes_predicted": predicted,
          "local_step_ms_per_rank": [
              statistics.mean(ms for s, ms in enumerate(x["ms"])
                              if s % LM_TE) for x in lm],
          "prologue_step_ms_per_rank": [
              statistics.mean(ms for s, ms in enumerate(x["ms"])
                              if s % LM_TE == 0) for x in lm],
          "ms_per_rank": [x["ms"] for x in lm],
          "data_ms_per_rank": [statistics.mean(x["data_ms"]) for x in lm],
          "peak_gb_per_rank": [x["peak_gb"] for x in lm],
          "held_gb_per_rank": [x["held_gb"] for x in lm],
          "reckoned": reckoned,
          "rank_s": [r["fsdp_lm_s"] for r in mesh_ranks]})
    want = {"sign_pack": FSDP_MESH_STEPS * leaves,
            "vote_update": FSDP_MESH_STEPS * leaves, "tally_acc": 0,
            "ternary_quant": 0}
    for x in lm:
        require(all(map(math.isfinite, x["losses"])), "non-finite loss")
        require(x["losses"] == losses, "gemma3-12b fsdp mesh: the ranks' "
                "losses differ")
        require(x["launches"] == want, f"gemma3-12b fsdp mesh launches "
                f"{x['launches']}, want {want}")
        require(x["held_bytes"]["params"] < one_process["params"],
                "gemma3-12b fsdp mesh: a rank holds its whole master")
    require(losses[-1] < losses[0], f"gemma3-12b fsdp mesh: step "
            f"{len(losses) - 1}'s loss {losses[-1]} is not below step 0's "
            f"{losses[0]}")
    emit({"fsdp_mesh": "report", "wall_s": time.perf_counter() - t0})
    return {"lift": [{k: sum(x["launches"][k] for x in rows)
                      for k in KERNEL_NAMES} for rows in lifts],
            "lm": [x["launches"] for x in lm],
            "tp": [x["launches"] for x in tp]}


def phase_fsdp_mesh(torch, card: str) -> dict:
    """``--phase fsdp_mesh``: the FSDP regime across processes alone --
    the mesh phase's 4 ranks running only their FSDP part (the lift
    check, gemma3-12b) and the tp phase's 8 ranks only theirs (gemma3-1b
    FSDP vs replicated) -- and :func:`fsdp_mesh_report`'s checks."""
    import gc
    import pickle
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    results = {}
    for name, spawn in (("mesh", mesh_spawn), ("tp", tp_spawn)):
        tmp = tempfile.mkdtemp(prefix=f"chip_smoke_fsdp_{name}_")
        try:
            with open(pathlib.Path(tmp) / "job.pkl", "wb") as f:
                pickle.dump({"parts": ("fsdp",)}, f)
            t1 = time.perf_counter()
            results[name] = spawn(torch, tmp)
            emit({"fsdp_mesh": f"{name} ranks",
                  "ranks_s": time.perf_counter() - t1})
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    out = fsdp_mesh_report(torch, card, results["mesh"], results["tp"])
    emit({"fsdp_mesh": "phase", "wall_s": time.perf_counter() - t_phase})
    return out


def fsdp_mesh_extra(fm: dict, name: str) -> dict:
    """The kernels line's ``fsdp_mesh_launches_per_rank``: per rank, the
    lift check's, gemma3-12b's (mesh ranks) and gemma3-1b's (tp ranks)
    launches of ``name``."""
    return {"fsdp_mesh_launches_per_rank": {
        "lift_check": [x[name] for x in fm["lift"]],
        "gemma3-12b": [x[name] for x in fm["lm"]],
        "gemma3-1b": [x[name] for x in fm["tp"]]}}


def pytree_items(tree, prefix=""):
    """(dotted name, leaf) pairs of a nested dict of tensors."""
    if not isinstance(tree, dict):
        return [(prefix, tree)]
    out = []
    for k in sorted(tree):
        out += pytree_items(tree[k], f"{prefix}.{k}" if prefix else k)
    return out


def main() -> None:
    # the lm phase's buffers come in many sizes (GBs down to KBs): let
    # the caching allocator grow its segments instead of splitting them
    import os
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    if sys.argv[1:2] == ["--mesh-rank"] and len(sys.argv) == 4:
        mesh_rank_main(sys.argv[3], int(sys.argv[2]))
        return
    if sys.argv[1:2] == ["--tp-rank"] and len(sys.argv) == 4:
        tp_rank_main(sys.argv[3], int(sys.argv[2]))
        return
    if sys.argv[1:] not in ([], ["--mu-sweep"], ["--phase", "hybrid"],
                            ["--phase", "mesh"], ["--phase", "tp"],
                            ["--phase", "fsdp_mesh"], ["--phase", "shards"],
                            ["--phase", "ckpt"], ["--phase", "dryrun"],
                            ["--phase", "families"]):
        fail(f"usage: {sys.argv[0]} [--mu-sweep | --phase hybrid | "
             "--phase mesh | --phase tp | --phase fsdp_mesh | "
             "--phase shards | --phase ckpt | --phase dryrun | "
             "--phase families]")
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this check needs a GPU")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "tests" / "helpers"))
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"cannot import the port from {ROOT / 'src'}: {e}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    t0 = time.perf_counter()
    build.load()
    print(f"[build] {time.perf_counter() - t0:.2f} s", flush=True)
    for kernel in ("sign_pack_kernel", "vote_update_kernel",
                   "tally_acc_kernel", "ternary_quant_kernel"):
        emit({"ptxas": kernel,
              "instances": ptxas_entries(build.ptxas_report(), kernel)})

    from repro_torch.core.topology import resolve_device
    resolve_device("cuda")
    if sys.argv[1:] == ["--mu-sweep"]:
        moe_mu_sweep(torch, card)
        return
    timer = Timer(torch)
    main_rows = phase_kernels(torch, timer)
    emit({"done": "kernels"})
    phase_edges(torch, timer)
    emit({"done": "edges"})
    main_rows["tally_acc"] = phase_tally(torch, timer)
    emit({"done": "tally"})
    main_rows["ternary_quant"] = phase_ternary(torch, timer)
    emit({"done": "ternary"})
    if sys.argv[1:] == ["--phase", "hybrid"]:
        hybrid = phase_hybrid(torch, card)
        paths = dict.fromkeys(SOURCES, "hybrid, zamba2 fused/flat (6 "
                                       "steps, 12 layers)")
        kernels = kernel_rows(main_rows, {
            name: hybrid["replicated"].get(name, 0) for name in SOURCES},
            paths, lambda name: {"hybrid_launches": {
                regime: hybrid[regime].get(name, 0) for regime in hybrid}})
        finish(torch, kernels)
        return
    if sys.argv[1:] == ["--phase", "mesh"]:
        mesh = phase_mesh(torch, card)
        paths = dict.fromkeys(SOURCES, "mesh, the parity toy's cells and "
                              "gemma3-1b (3 steps) in rank 0 of 2 x 2")
        kernels = kernel_rows(main_rows, mesh_rank0_launches(mesh), paths,
                              lambda name: mesh_extra(mesh, name))
        finish(torch, kernels)
        return
    if sys.argv[1:] == ["--phase", "tp"]:
        tp = phase_tp(torch, card)
        paths = dict.fromkeys(SOURCES, "tp, the parity toy's cells and "
                              "gemma3-1b (3 steps, 2 layers) in rank 0 of "
                              "2 x 2 x 2")
        kernels = kernel_rows(main_rows, mesh_rank0_launches(tp), paths,
                              lambda name: tp_extra(tp, name))
        finish(torch, kernels)
        return
    if sys.argv[1:] == ["--phase", "shards"]:
        tp = phase_tp(torch, card, parts=("moe", "shards"))
        paths = dict.fromkeys(SOURCES, "tp moe, deepseek-v3 FSDP (2 steps) "
                              "in rank 0 of 2 x 2 x 2")
        kernels = kernel_rows(
            main_rows, tp["moe"]["deepseek-v3"][0], paths,
            lambda name: {f"tp_{part}_launches_per_rank": {
                arch: [x[name] for x in per_rank]
                for arch, per_rank in tp[part].items()}
                for part in ("moe", "shards")})
        finish(torch, kernels)
        return
    if sys.argv[1:] == ["--phase", "ckpt"]:
        mesh = phase_mesh(torch, card)
        tp = phase_tp(torch, card, parts=("fsdp",))
        paths = dict.fromkeys(SOURCES, "mesh, gemma3-1b run B (3 steps, a "
                              "nan at 2 restored and replayed) in rank 0 "
                              "of 2 x 2")
        kernels = kernel_rows(
            main_rows, mesh["ckpt"][0], paths,
            lambda name: {**mesh_extra(mesh, name),
                          "tp_fsdp_ckpt_launches_per_rank": [
                              x[name] for x in tp["fsdp_ckpt"]]})
        finish(torch, kernels)
        return
    if sys.argv[1:] == ["--phase", "dryrun"]:
        lm_launches = phase_lm(torch)
        dry = phase_dryrun(torch, card)
        launches = {name: lm_launches["dc"].get(name, 0)
                    + lm_launches["qsgd"].get(name, 0) for name in SOURCES}
        paths = dict.fromkeys(SOURCES, "lm, gemma3-1b fused/flat (6 steps) "
                              "and hier_local_qsgd K=2 stream (2 steps)")
        kernels = kernel_rows(main_rows, launches, paths,
                              lambda name: dryrun_extra(dry, name))
        finish(torch, kernels)
        return
    if sys.argv[1:] == ["--phase", "families"]:
        fam_launches = phase_families(torch)
        paths = dict.fromkeys(SOURCES, "families, xlstm-350m (8 blocks) and "
                              "whisper-base fused/flat (4 steps each)")
        kernels = kernel_rows(
            main_rows, {name: sum(fam.get(name, 0)
                                  for fam in fam_launches.values())
                        for name in SOURCES}, paths,
            lambda name: {"families_launches": {
                arch: fam.get(name, 0) for arch, fam in fam_launches.items()}})
        finish(torch, kernels)
        return
    if sys.argv[1:] == ["--phase", "fsdp_mesh"]:
        fm = phase_fsdp_mesh(torch, card)
        paths = dict.fromkeys(SOURCES, "fsdp_mesh, gemma3-12b FSDP (2 steps, "
                              "2 layers) in rank 0 of 2 x 2")
        kernels = kernel_rows(main_rows, fm["lm"][0], paths,
                              lambda name: fsdp_mesh_extra(fm, name))
        finish(torch, kernels)
        return
    fused, plain, launches = phase_slice(torch)
    print(f"[slice] ms/step fused/flat {fused['ms_per_step']} "
          f"ag_packed/tree {plain['ms_per_step']}", flush=True)
    emit({"done": "slice"})
    runs = phase_clients(torch)
    launches["tally_acc"] = runs["stream fused/flat"]["launches"]["tally_acc"]
    emit({"done": "clients"})
    phase_many_voters(torch)
    phase_quantize(torch)
    emit({"done": "voters, quantize"})
    methods = phase_methods(torch, fused["ms_per_step"][-1])
    emit({"done": "methods"})
    launches["ternary_quant"] = (
        methods["hier_local_qsgd"]["launches"]["ternary_quant"])
    lm_launches = phase_lm(torch)
    dry = phase_dryrun(torch, card)
    fam_launches = phase_families(torch)
    ft = phase_fault_tolerant(torch, lm_launches["peak_gb"], card)
    serve_launches = phase_serve(torch, card)
    fsdp_launches = phase_fsdp(torch, card)
    moe_launches = phase_moe(torch, card)
    hybrid = phase_hybrid(torch, card)
    mesh = phase_mesh(torch, card, fsdp=True)
    tp = phase_tp(torch, card, parts=("tp", "fsdp", "fam", "moe", "serve",
                                      "shards"))
    fm = fsdp_mesh_report(torch, card, mesh.pop("ranks"), tp.pop("ranks"))
    paths = {"sign_pack": "paper task, fused/flat (30 steps)",
             "vote_update": "paper task, fused/flat (30 steps)",
             "tally_acc": "clients, stream fused/flat (30 steps, K=2)",
             "ternary_quant": "methods, hier_local_qsgd fused/flat (30 "
                              "steps, 4 leaves a step)"}

    kernels = kernel_rows(main_rows, launches, paths, lambda name: {
        "lm_dc_fused_flat_launches": lm_launches["dc"].get(name, 0),
        "lm_qsgd_stream_launches": lm_launches["qsgd"].get(name, 0),
        "families_launches": {arch: fam[name] if name in fam else 0
                              for arch, fam in fam_launches.items()},
        "fault_tolerant_launches": ft["launches"].get(name, 0),
        "serve_launches": serve_launches[name],
        "fsdp_launches": fsdp_launches.get(name, 0),
        "moe_launches": {arch: m.get(name, 0)
                         for arch, m in moe_launches.items()},
        "oracle_check_launches": sum(
            r.get(name, 0) for r in ft["oracle"].values()),
        "hybrid_launches": {regime: hybrid[regime].get(name, 0)
                            for regime in hybrid},
        **mesh_extra(mesh, name), **tp_extra(tp, name),
        "tp_fsdp_ckpt_launches_per_rank": [x[name]
                                           for x in tp["fsdp_ckpt"]],
        **fsdp_mesh_extra(fm, name), **dryrun_extra(dry, name)})
    finish(torch, kernels)


def dryrun_extra(dry: dict, name: str) -> dict:
    """The kernels line's ``dryrun``: the lm configuration's launches of
    ``name`` on the card and its dry run's fake calls, a step each, and
    the smoke dry runs' fake calls (none of which launched)."""
    return {"dryrun": {
        "card_launches": {k: v[name] for k, v in dry["real"].items()},
        "fake_calls": {k: v[name] for k, v in dry["fake"].items()},
        "smoke_fake_calls": {k: v[name]
                             for k, v in dry["smoke_fake"].items()}}}


def mesh_rank0_launches(mesh: dict) -> dict:
    """Rank 0's launches of each kernel in the ``mesh`` phase: the toy's
    cells and the LM run."""
    return {name: sum(cell[0][name] for cell in mesh["toy"].values())
            + mesh["lm"][0][name] for name in SOURCES}


def mesh_extra(mesh: dict, name: str) -> dict:
    """The kernels line's ``mesh_launches_per_rank``: per rank, the toy's
    cells', the LM run's and (``"ckpt"``) run B's launches of ``name``."""
    return {"mesh_launches_per_rank": [
        {"toy": sum(cell[r][name] for cell in mesh["toy"].values()),
         "lm": mesh["lm"][r][name],
         **({"ckpt": mesh["ckpt"][r][name]} if "ckpt" in mesh else {})}
        for r in range(len(mesh["lm"]))]}


def tp_extra(tp: dict, name: str) -> dict:
    """The kernels line's ``tp_launches_per_rank``: per rank, the toy's
    cells' and the LM run's launches of ``name`` in the ``tp`` phase;
    ``tp_moe_launches_per_rank`` and ``tp_fam_launches_per_rank``: per
    config, each rank's launches of ``name`` in its run over the model
    axis (the moe part's FSDP, the fam part's replicated);
    ``tp_serve_launches_per_rank`` and ``tp_shards_launches_per_rank``:
    the serve and shards parts', each config's."""
    return {"tp_launches_per_rank": mesh_extra(tp, name)[
        "mesh_launches_per_rank"],
        **{f"tp_{part}_launches_per_rank": {
            arch: [x[name] for x in per_rank]
            for arch, per_rank in tp[part].items()}
           for part in ("moe", "fam", "serve", "shards") if part in tp}}


def kernel_rows(main_rows: dict, launches: dict, paths: dict,
                extra) -> list:
    """The ``kernels`` line's rows: each kernel's main-path launches and
    path, its main-shape row's error and times, and ``extra(name)``'s
    launches on the other paths."""
    kernels = []
    for name in SOURCES:
        row = main_rows[name]
        src, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "path": paths[name], "max_abs_err": row["max_abs_err"],
            "ms": row["kernel_ms"], "device_ms": row["kernel_device_ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, **extra(name)})
    return kernels


def finish(torch, kernels: list) -> None:
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
