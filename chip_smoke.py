#!/usr/bin/env python3
"""Drive the PyTorch port (`paddle_tpu_torch`) end to end on one NVIDIA GPU.

    python3 chip_smoke.py               # every phase, as the driver runs it
    python3 chip_smoke.py --flash-only  # phases 1, 2 and 7 only
    python3 chip_smoke.py --train-parallel-only   # phases 1, 2 and 20
    python3 chip_smoke.py --eager-only  # phases 1, 2 and 21
    python3 chip_smoke.py --nn-only     # phases 1, 2 and 22
    python3 chip_smoke.py --hapi-only   # phases 1, 2 and 23
    python3 chip_smoke.py --text-only   # phases 1, 2 and 24
    python3 chip_smoke.py --jit-only    # phases 1, 2 and 25
    python3 chip_smoke.py --dist-only   # phases 1, 2 and 26
    python3 chip_smoke.py --fleet-only  # phases 1, 2 and 27
    python3 chip_smoke.py --fleet3-only # phases 1, 2, 27 and 28
    python3 chip_smoke.py --ps-only     # phases 1, 2 and 29
    python3 chip_smoke.py --rest-only   # phases 1, 2 and 30
    python3 chip_smoke.py --tune-only   # phases 1, 2 and 31 with the sweep

Phases (any exception ends the run with a non-zero exit):
  1. device: the card's name and power limit (nvidia-smi), torch and CUDA
     versions;
  2. build: every CUDA kernel of the port, from `paddle_tpu_torch/csrc/`;
  3. kernel vs plain version on the card: the paged-attention kernel at the
     serving shapes (decode T=1 over ragged positions up to 1000, prefill
     T=64/128/512, int8 pools, a garbage block poisoned with NaN/inf,
     all-masked rows, and decode at the edges of the kernel's KV splits:
     key counts one below, at and one above a split boundary, the full
     table, a pos = -1 slot beside long ones, 16- and 8-token blocks, in
     f32, int8 and bf16; speculative verify windows on the window kernel,
     T=5 in f32, int8 and bf16 and T=2, at positions 0 to the table's
     last key with windows across a block edge, T=5 windows at the first
     split edge, beside the T=1 kernel at the same positions; T=16 and
     T=17, the two sides of the window/tile boundary; the tile kernel at
     the serving path's own prefill shapes, one slot at T=32 from
     position 0 and T=256 after a 256-token prefix, and bf16 at T=128),
     every case launched twice and required to repeat bit for bit, with
     its time, host time per call, the plain version's time, the
     `scaled_dot_product_attention` yardstick and the bound;
  4. the server: `Scheduler` over `PagedGenerationEngine(gpt_125m,
     attention_impl="kernel")`, its executables captured as CUDA graphs
     first (`precompile()`), answers 16 greedy requests (prompts of 1 to
     700 tokens, eight sharing a 256-token prefix), with the kernel's
     launch count read just after (12 a forward: decode steps at T=1,
     prefills on the tile path, credited once per graph replay) and every
     executable captured exactly once; then one profiled decode step;
  5. the same engine with int8 KV pools answers 4 requests;
  6. kernel path vs plain path at full width: first token + 8 greedy
     decode steps per slot must agree, a slot's comparison stopping at the
     first step where the plain path's top-2 logit gap is below 1e-3;
     and a replayed decode step's logits equal, bit for bit (else within
     1e-6, recorded), the same forward run eagerly on the same state;
  7. flash-attention kernels (forward, dQ, dK/dV) vs their plain versions
     on the card: the GPT-350M training shape (B=8, H=16, S=1024, D=64,
     bf16, causal), f32 causal and non-causal, a ragged S=200, D=128, an
     additive (B,1,S,S) mask with fully masked rows, dropout 0.1 and GQA
     16/4, the same options in bf16, and bf16 at the edges of the wgmma
     kernels' 128-row tiles (S=64, 129 and 1000 causal, S=1024
     non-causal, D=128 at S=1024, GQA 16/4 at S=200); with each kernel's
     time, the plain version's time, the `scaled_dot_product_attention`
     forward and backward yardsticks (and the kernel's ratio to them) and
     the bound at the training shape (phase 7a); the backward kernels
     are launched twice on every case and must repeat bit for bit. Phase
     2 prints the registers, spills and shared memory of the wgmma
     kernels (forward, dQ and dK/dV builds). With
     --flash-only the script stops after phase 7, runs every case even
     after a failure, and exits 1 if any failed;
  8. the training step: `make_train_step` on GPT-350M (vocab 50304,
     S=1024, hidden 1024, 24 layers, 16 heads, bf16, no remat, lr 2e-4)
     at B=8 on one fixed batch, 3 warm-up and 10 timed steps: step ms,
     tokens/s, peak memory, MFU, one profiled step, exactly 24 launches
     of each flash kernel a step, and the device ms of the step's parts
     (forward, backward, clip + AdamW) and of the LM head's logits
     product;
  9. training kernel path vs plain path at full width (depth 2, f32, B=2,
     3 steps from the same weights): flash kernels + remat + fused CE
     against dense attention + no remat + unfused CE;
 10. the speculative server: `Scheduler` over `SpeculativeEngine(gpt_125m,
     gamma=4, draft_layers=2, attention_impl="kernel")` answers phase 4's
     16 requests (every verify window on the paged kernel at T=5, the
     draft on its dense cache: exactly 12 paged launches per verify round
     on the window path and per prefill on the tile path, no block
     leaked), with its acceptance rate, tokens a round, tokens/s, draft
     and verify host time, one profiled round (with the paged kernel's
     device time);
     its streams must equal a one-token engine's on 8 prompts, a slot's
     comparison stopping at the first step whose top-2 gap is below 1e-3;
 11. int8 decode weights: teacher-forced against the float engine (8
     slots x 16 steps; greedy match >= 0.99 where the float gap >= 1e-3,
     mean logit KL < 1e-3), the device ms of the per-forward dequant;
     speculative decode with int8 weights and KV agrees >= 0.9 with the
     one-token int8 engine; a weight swap to a clone in the middle of
     phase 10's serving leaves every stream unchanged, and a swap with a
     wrong-shaped tensor is refused, and captures nothing;
 12. the KV handoff: engine A prefills phase 4's eight shared-prefix
     prompts, each request's KV goes `extract_kv_wire` -> `pack_kv_bundle`
     -> `unpack_kv_bundle` -> engine B's `adopt_kv`, and B's greedy
     streams must equal a local engine's (phase 6's near-tie rule), with
     float32 and with int8 pools, with the bundle bytes and the ms of each
     step; then the 256-token shared prefix, restored into a fresh engine
     with `restore_prefix`, must be matched by its next prefill with the
     local stream. Every executable of every engine of phases 4, 5, 10, 11
     and 12 is captured at most once (exactly once where precompiled);
 13. the server under its SLO machinery and chaos (phase 4's engine,
     precompiled): phase 4's 16 requests three times, without the serving
     JSONL, with it, and with the metrics registry off, each run's decode
     step on the host clock and the scheduler's host time a step outside
     `engine.decode()`, and the host µs of each piece of the machinery
     (a fault site, a span, a counter, histogram and gauge update, a JSONL
     line); then on one scheduler writing the JSONL: six batch
     requests past `shed_watermark=4` shed while interactive ones are
     admitted, two 1 ms deadlines expiring in the queue with no tokens, a
     running request's deadline passing mid-decode, a cancel freeing its
     blocks, a `serving.decode_step` fault failing exactly the eight
     requests in flight (then one probe slot, then every slot), a swap the
     `serving.weight_swap` site refuses, a bundle `serving.kv_handoff`
     refuses beside one adopted, a prefix restore `serving.kv_restore`
     refuses (0 tokens, the corrupt counter +1), and `serving.kv_quant`
     truncate on an int8 engine scaling one block by 64 in place so the
     next replayed decode's logits move. Every stream is held to phase 4's
     (the near-tie rule), `serving_decode_failures_total` moves by exactly
     the one injected fault, every decision record replays
     (`observability.decisions`), every timeline's phases sum to its
     `e2e_s`, `tools/metrics_report.py` accepts the registry snapshot,
     and every executable stays captured once. Phases 4, 5, 10, 11 and 12
     contain no decode failure;
 14. the serving fleet on this card: phase 4's weights committed with
     `save_state_dict`, then one prefill and two decode worker processes
     (`python -m paddle_tpu_torch.serving.distributed.worker_main --device
     cuda --engine paged --ckpt ...`, phase 4's engine configuration, every
     executable captured before the endpoint is published) behind a
     `DistFrontend` in this process. Phase 4's 16 requests ride the remote
     prefill and the KV handoff over loopback TCP and every stream is held
     to phase 4's (the near-tie rule), with TTFT through the router, the
     fleet's tokens/s, the router's µs for one `pump()` and each worker's
     start seconds; `FleetPlane.poll_now()` federates the three workers'
     registries, `tools/metrics_report.py` accepts the merged snapshot,
     whose `_fleet` row counts the requests served and gives the handoff
     bytes and seconds; a second router over the two decode workers with
     `prefix_affinity=True, affinity_load_slack=0` places a shared-prefix
     prompt on decode 0 (a local prefill warms its prefix cache), a filler
     on 0, and the same prompt again on decode 1, which restores 0's chain
     over the wire (`restored_from` 0 in the place record, a `kv_restore`
     timeline phase; the stream held to phase 4's); a second wave of 8
     loses one decode worker to
     SIGKILL once each has its first token, at 300 tokens a stream, and
     completes on the survivor (held to phase 4's streams and to the same
     wave run undisturbed before it; `serving_failover_total` >= 1;
     seconds from the kill until every victim streams again and until
     the last request is done); `swap_all` to the same weights as
     version 2, while a second router keeps eight of phase 4's requests
     (of staggered lengths, 40 to 264 tokens) in flight on the survivor,
     is applied under live streams, leaves
     every stream as phase 4's and every live worker reports version 2;
     STOP ends every live worker with exit
     0 and an exit line whose capture counts are 1 for every executable
     and whose paged-kernel launches are above 0; the card's memory by
     process comes from nvidia-smi.

 15. the KV tiers and multi-tenant serving (phase 4's weights and engine
     configuration, every engine precompiled). Tiers: phase 4's eight
     shared-prefix prompts served, every cached block evicted into the
     tiers, the eight served again, with a host tier in f32 (and a disk
     directory), a host tier of one block cascading to disk, an int8 host
     tier and the tiers off: streams held to phase 4's (the int8 tier by
     greedy agreement >= 0.9), the first re-served request promoting the
     16 blocks of the 256-token prefix (`tier_restore` 1, host-tier hits,
     every executable captured once), its restore ms and TTFT printed
     beside the recompute's; `serving.kv_spill` and `serving.kv_restore`
     truncate degrade to a recompute with phase 4's stream (the corrupt
     counter +1); a worker whose chain sits in its host tier answers
     PREFIXLOOKUP with the tiered tokens and its KVEXPORT, restored by a
     second worker's fresh engine, gives phase 4's stream. Tenancy: an
     `AdapterBank` (4 rows, rank 16, all four targets, 12 layers)
     attached before `precompile()`, 8 slots of three tenants and the base
     model on the one captured decode graph, base rows held to phase 4's,
     tenant rows to an engine without a bank that decodes on the merged
     weights W + (A B)^T (the near-tie rule); a swap under live streams
     keeps the other tenants' rows, a `serving.adapter_swap` fault keeps
     the old adapter and ticks the failed count, a rebind captures
     nothing, a tenant's bucket refuses past its burst with replayable
     decision records; speculative rounds with the adapters on the verify
     window agree with the one-token adapted engine; the decode step with
     and without the bank, profiled (kernels a step, the gathers' and
     products' device ms).
 16. the KV ledger and the numerics plane (phase 4's weights and engine
     configuration). (a) phase 4's 16 requests twice each through an
     engine with the ledger and one built with `kvledger.disable()`,
     interleaved: the scheduler's host µs a step outside decode, the
     reconciler's µs a check, the ledger's events, zero divergences,
     equal streams and capture counts; (b) `serving.kv_ledger_leak`
     truncate: the free_list divergence latched at the boundary of the
     step the leak happened in, with a postmortem (in a temporary
     directory); (c) phase 4's profiled decode step on four engines, the
     numerics taps disarmed and armed, f32 and int8 KV + int8 weights:
     step ms, device busy ms, kernels a step (the disarmed f32 engine's
     equal to phase 4's), the taps' device ms, one ingest's host µs,
     tokens equal to the disarmed engine's, every executable captured
     once, no nonfinite or saturation anomaly (drift latches are
     printed); (d) the NaN drill (`numerics.corrupt` nan on
     `blocks.1.ln1.weight`): `decode.logits:nonfinite` in the same step,
     the localizer names layer 1, the prefill masters stay finite,
     `decode` captured once and the probes counted apart, the bundle on
     disk; the `scale_zero` drill on the int8 engine latches
     `weights.scale:drift`. Phases 13-15 run with the ledger attached, as
     every paged engine is built by default.
 17. the device profile and the cost model. (a) phase 4's engine and 16
     requests under a `Scheduler` with `capture_decode_steps(8)` armed:
     the capture stays armed through the first decode step, ends
     `reported`, and its deviceprof.v1 record validates and reconciles
     (device ms a step <= wall) on one stream, joined to the cost model's
     decode step (the same engine on fake tensors, `h100-sxm-fp32`); it
     names `paged_decode_kernel` (op `paged_attention`) 12 times a step
     and reads within 5% of `profile_steps` on the same engine, with
     as many device events as it a step (the window lost none); no graph
     is captured in the window and the streams are phase 4's. (b) phase
     8's GPT-350M bf16 step at B=8 under `deviceprof.capture(iters=3)`,
     joined to `cost_model.estimate` of the same step on fake tensors
     (`h100-sxm`): device ms a step, coverage, the largest rows and ops
     with their efficiency, each flash kernel 24 times a step, the
     estimate's FLOPs within 15% of 1.868e13. (c) `Profiler(scheduler=(1,
     3), timeline=...)` around five steps: the summary renders,
     `analyze()` covers more than 0, and the timeline holds two records
     `tools/perf_report.py` accepts. Traces, records and the summary go
     to `chiprun_out/phase17/`.
 18. warm start: phase 4's GPT-125M written with
     `serving.save_for_generation` (phase 4's paged engine recorded in
     `.gencfg`, whose serving config must equal the config's `as_dict()`)
     under `chiprun_out/phase18/`, with an empty `_compile_cache/`; then
     two fresh processes each build `inference.create_predictor(Config(
     artifact))` and `generate` phase 4's 16 prompts: a cold one, which
     builds the paged kernel's library with nvcc through the artifact's
     compile cache, and a warm one with nvcc off its PATH and CUDA_HOME
     pointed nowhere, so that a compile would raise. Each prints its
     load-to-ready seconds by stage, `predictor_executable_ready_seconds`,
     the first request's TTFT, the cache's stats, the capture counts, the
     paged launches and its peak memory. The cold precompile must report
     every executable "miss" and the warm one "hit" (misses 0, hits >= 1),
     both streams must equal phase 4's token for token, each child must
     launch the paged kernel (decode and prefill tiles) and capture each
     executable once. The weights and the libraries are removed at the
     end; the children's logs and `phase18.json` stay.
 19. multi-device serving on one card (`serving/distributed/tp.py`,
     `pp.py`): phase 4's GPT-125M weights, 8 slots, `max_len` 1024, block
     16, the kernel path, phase 4's 16 prompts and 32 new tokens, greedy,
     through the `Scheduler` on (a) `pp=2` (6 layers a stage,
     `decode_microbatches=2`), (b) `tp=2` (6 heads a shard), (c) `tp=2,
     pp=2` in f32 and with int8 KV (phase 5's four prompts), (d) `spec_pp`
     with `pp=2, gamma=4, draft_layers=2`; every stage and shard on the
     one card, each named by `kv_shard_report`. Each arm is precompiled
     and must hold: streams equal to phase 4's token for token ((a)-(c)
     f32; a departure prints the step and the single-device engine's top-2
     gap there, and fails), phase 5's ((c) int8) or arm (a)'s ((d));
     every stage executable captured once; `heads/tp` heads a shard;
     `num_layers * tp` paged launches a forward (a microbatch through the
     stages) over the decode steps and the prefills; the bubble gauge at
     (pp-1)/(M+pp-1) over a decode window; each shard's pool bytes the
     single pool's over tp*pp (`hbm_accounting`). Each arm prints its
     decode step ms and TTFT with the card's name and power limit, and
     phase 19's launches per kernel go to the report. No number of this
     phase is a multi-card speed: every stage shares the one card.
     `--parallel-only` runs phases 1-5 (4 and 5 for their streams) and
     19.
 20. multi-device training on one card (`parallel/gpt_spmd.py` with a
     plan axis above 1, one controller driving every rank on the one
     card): (a) the flash kernels (forward, dQ, dK/dV) at each plan's
     per-rank shape of GPT-350M (bf16, causal, S=1024, D=64: B=4 H=16
     for dp=2 / sharding=2, B=8 H=8 for mp=2 and ulysses sp=2, B=2 H=16
     for pp=2 M=4, B=2 H=8 for dp=2 x mp=2 x pp=2 M=2) against their
     plain versions at phase 7's tolerances, every backward repeated bit
     for bit; (b) f32 parity at GPT-350M's widths and 4 layers (B=8, lr
     1e-3, 3 steps, one seeded set of weights and state): dp=2,
     sharding=2, mp=2, mp=2 with fused_ce_chunks=8, sp=2 ring and
     ulysses, pp=2 M=4 under gpipe, 1f1b and eager1f1b, pp=2 vpp=2 M=4,
     dp=2 x mp=2 x pp=2 M=2 and pp=2 x sp=2 x dp=2 M=2 (ring: the
     all-gather route), each against `MeshPlan()`: losses within rtol
     2e-4 (hybrids 5e-4), the gathered parameters within 1e-4, and the
     flash launches each plan should make (none on the ring routes);
     (c) timed bf16 arms at phase 8's configuration (24 layers, B=8, no
     remat, unfused CE; 3 warm-up and 5 timed steps): the single device,
     dp=2, sharding=2, mp=2, sp=2 ulysses, pp=2 M=4 1f1b, pp=2 vpp=2 M=4
     and dp=2 x mp=2 x pp=2 M=2, each with its step ms, tokens/s, peak
     memory, each rank's parameter, gradient and optimizer bytes, one
     profiled step (device busy ms, kernels, idle share) and its flash
     launches a step (checked against the plan); the loss finite and
     falling, and sharding=2's m / v / master ceil(size / 2) floats a
     leaf, half of dp=2's; (d) pp=4 M=8 at that configuration under
     gpipe and 1f1b: each schedule's peak allocated bytes above its
     resident parameters, state and gradients, 1F1B's below GPipe's.
     No number of this phase is a multi-card speed: every rank shares
     the one card. `--train-parallel-only` runs phases 1, 2 and 20.
 21. the eager core on the card (`core.tensor.Tensor`, `apply_op`, the
     tape on torch autograd, `PyLayer`, the `tensor` op surface):
     (a) bench_eager.py's MLP step (Linear D->H, ReLU, H->H, ReLU, H->C,
     softmax cross-entropy, SGD at lr 0.05) in the port's eager ops
     (`matmul`, `maximum`, `logsumexp`, `take_along_axis`, parameters
     updated under `no_grad`) at B=256, D=64, H=256, C=8 and at
     B=8192, D=H=4096, C=8, in three arms: the eager Tensor API, the
     same ops on raw torch tensors, and that raw step captured once as
     a CUDA graph and replayed, run in turns. Each arm's step ms
     (quartiles of 60 steps after 5 of warm-up; a host read of the loss
     closes each step), its
     kernels and device ms a step (`deviceprof.capture` over 5 steps),
     and the quartiles of (eager_i - torch_i) / 25 ops over the paired
     steps; arms 1 and 2 give the same losses within 1e-6 and every loss
     falls; and the host us the wrapper adds an op where a step's noise
     cannot hide it: 60 rounds of 200 back-to-back add / multiply /
     maximum / matmul calls on 8x8 f32 through the port and through
     torch, in turns, no sync inside a round, inputs without and with
     grad, quartiles of the paired rounds' difference;
     (b) a `PyLayer` whose forward launches the flash forward kernel and
     whose backward launches dQ and dK/dV, through paddle Tensors at
     GPT-350M's attention shape (B=8, H=16, S=1024, D=64, bf16, causal):
     each launch counter moves by exactly one, output and gradients held
     to the plain versions at phase 7's bf16 tolerance; (c) with
     `FLAGS_check_nan_inf` set, an op making a NaN or Inf raises naming
     the op, and the small step's ms with the flag off and on (in
     turns); (d) the
     CPU tests' op table (`tests/test_torch_tensor_ops.py` `OP_TABLE`
     and `INPLACE_TABLE`, the tie and order rules among them) on CUDA
     against the port on the CPU: integer, bool and index results exact,
     floats at each case's tolerance, values and gradients.
     `--eager-only` runs phases 1, 2 and 21.
 22. `nn`, `optimizer` and `amp` on the card: (a) a BERT-base-width
     encoder (`nn.Embedding(30522, 768)`, `nn.TransformerEncoder` of 12
     post-norm `TransformerEncoderLayer(768, 12, 3072, dropout=0.1,
     activation="gelu")`, `nn.Linear(768, 30522)`; random weights) learns
     to copy one seeded batch of B=8 x S=512 tokens with
     `nn.CrossEntropyLoss`, a bool key-padding mask hiding the last 64
     keys of half the rows, AdamW (LinearWarmup, decay 0.01 off biases and
     norms, ClipGradByGlobalNorm(1.0)), in two arms from the same weights:
     f32 (TF32 off) and bf16 parameters (`amp.decorate` O2, forward under
     `auto_cast`). Each arm: its step-1 loss without dropout (bf16 within
     2e-2 of f32), 30 steps with dropout (the loss falls), step ms (median
     of 27 after 3), tokens/s, kernels and device-busy ms a step
     (`deviceprof.capture`), the flash launches of every step (exactly 12
     forward, 12 dQ and 12 dK/dV: one a layer, through their mask and
     dropout builds) and every SDPA call on the kernel route; then the
     encoder's last hidden states without dropout on the batch, bf16
     against f32 (every batch row within 2.5e-2 relative; two f32
     controls, the key padding dropped and every attention output
     projection zeroed, must fall outside it); (b) phase
     21's small MLP step written with `nn.Sequential`,
     `nn.CrossEntropyLoss` and `optimizer.SGD` beside phase 21's raw-torch
     step, in turns: host us of forward, backward, the update,
     `clear_grad` and the loss read, quartiles over 200 steps; (c) every
     optimizer arm of `tests/test_torch_optimizer.py`, plain and with clip
     and decay, 3 steps on CUDA against the port on the CPU at 1e-5, and
     `GradScaler` skipping an injected inf; (d) the CPU tests' functional
     table (`tests/test_torch_nn_functional.py` `FN_TABLE`) and Layer
     table (`tests/test_torch_nn_layers.py` `LAYER_TABLE`) on CUDA against
     the port on the CPU, through the tests' own comparisons; SDPA at
     head dim 256 and in float16 takes the kernel route, launches the
     forward kernel once and agrees with the plain attention; (e) the
     flash forward, dQ and dK/dV kernels'
     mask and mask + dropout (0.1) builds at B=8, H=12, S=512, D=64 bf16
     with the encoder's [8, 1, 512, 512] f32 mask, timed and held to their
     plain versions, beside SDPA with the same float mask.
     `--nn-only` runs phases 1, 2 and 22.
 23. `io`, `metric`, `hapi` and `vision` on the card: (a) ResNet-50
     (`vision.models.resnet50(num_classes=10)`, random weights) through
     `Model.fit` at CIFAR-10's shapes: `FakeData` 3x32x32, B=128,
     shuffled, a `DataLoader` with 2 worker processes over the
     shared-memory ring, `Momentum(0.1, 0.9, weight_decay=5e-4)`,
     `CrossEntropyLoss`, `Accuracy`, f32 with TF32 off; 3 warm-up and 21
     timed steps: step ms (a step ends in the loss's host read), img/s,
     the gap before each step and `dataloader_wait_seconds`, the ring's
     batches by worker (all of them), peak memory, no `.grad` filled;
     the step's device profile over 3 steps (kernels, busy ms, idle
     share, top ops); the fixed-batch step with cuDNN TF32 off and on, in
     turns; (b) a learnable labelling of FakeData's images (ten bands, the
     label's the brightest) trained 60 steps at lr 0.02: the loss falls (last 5
     steps' mean under 0.5 of the first 5's), held-out accuracy above 0.5,
     `predict(stack_outputs=True)` of [512, 10], `Model.save` -> `load`
     reproducing the eval logits bit for bit; (c) `Model.train_batch`
     against the eager loop on two copies (loss, parameters, BatchNorm
     buffers within 1e-6; a no-decay control must fail it), and the
     card against the CPU at B=8 (eval logits and the first step's loss
     within 1e-4; the train-mode logits against the CPU's float64
     forward, at most 3x the CPU float32 error); (d) `Model.fit`
     over phase 22's encoder cut to 2 layers (bf16 O2, key padding), 5
     steps: 2 launches of each flash kernel a step, every SDPA call on
     the kernel route; (e) the `DataLoader`'s engines (serial, ring with
     2 and 4 workers, thread) at B=128 with no model: equal batches and
     batches/s; (f) every non-PIL op of `vision/ops.py` (with gradients
     where they flow), the conv and pool cases of the CPU tests' Layer
     table, and each zoo family's eval forward, on CUDA against the CPU.
     `--hapi-only` runs phases 1, 2 and 23.
 24. the head dims and float16 the kernels took last, then text and
     audio: (c) first, every new kernel instance against its plain
     version (launched twice, repeating bit for bit; timed beside its
     bound and SDPA): the paged kernel at head dims 32 (8 heads) and 128
     (16 heads) in f32, bf16 and int8, decode over ragged positions and
     at the split edges, T=5 windows, T=128 and T=512 tiles; the flash
     kernels in float16 at D 64 and 128 and at D=256 in f32, bf16 and
     float16 (B=2, H=8, S=1024, causal), plus mask and dropout builds,
     float16 held to 2e-3 with a control that rounds P and dS to bf16
     and must fail that limit; SDPA at D=256 and in float16 on the
     kernel route (with `--text-only`; the whole script runs it in
     phase 22); (a) BERT-base
     (`BertForPretraining(BertConfig())`, random weights, f32, TF32 off)
     pretraining through `Model.fit` on seeded masked-LM data (two runs
     of consecutive ids, NSP, 15% masked) through 2 ring workers, B=32,
     S=128, AdamW, 63 steps: step ms over 20 after 3, sequences/s, the
     device profile of a step, flash launches (12 each a step), SDPA
     routes, the loader's wait, peak memory, the loss falling (the last 5
     steps' mean under 0.8 of the first 5's); (b) GPT-1.3B at full width
     (seeded f32 weights) through `PagedGenerationEngine(attention_impl=
     "kernel")` under the `Scheduler` on CUDA graphs, 8 slots, block 16,
     phase 4's 16 requests x 32 tokens, with f32 and with int8 pools:
     decode step ms, TTFT, tokens/s, paged launches by path (24 a
     forward), a profiled decode step, and every greedy stream
     token-exact against the same engine on the plain attention; (d) a
     2-layer bidirectional LSTM and a GRU (hidden 512, B=64, T=128,
     ragged lengths, Adam): a training step's ms, kernels and busy ms,
     and the first of those steps against a CPU step on every row (1e-4
     of the largest magnitude); (e) Viterbi (B=64, T=128, 50 tags,
     ragged) and beam search (beam 4 over a GRUCell) equal to the CPU's,
     MelSpectrogram and
     MFCC over 16 clips of 5 s at 44.1 kHz against the CPU (1e-5) and the
     stft -> istft round trip (1e-4); (f) ERNIE 3.0 base sequence
     classification at B=32, S=128 through `Model.train_batch`: step ms
     and 12 flash launches of each kernel a step.
     `--text-only` runs phases 1, 2 and 24.
 25. jit, static and the Predictor over a saved program: BERT-base
     (`Bert(BertConfig())`, random weights, eval, f32, TF32 off) at
     B=32, S=128 with a key-padding mask: (a) the `to_static` program's
     forward against the eager forward (ATOL / RTOL), 12 flash forward
     launches a forward in both, ms a forward (median of 20, each ending
     in a host read), kernels, device busy ms and idle share of each;
     (b) `jit.save` on the card, then `inference.create_predictor` in a
     fresh process that imports only `paddle_tpu_torch`: `run()` at B=1,
     8 and 32 from the one artifact, 12 flash launches a run, the
     `ready_stages` seconds and ms a run, each output held against the
     eager Layer and against the same inputs through the plain attention
     (`reference_attention_bhsd`) on the card (ATOL / RTOL); a program
     saved on the CPU is refused on the card; (c) `static.Program.capture`
     of the encoder forward, the `amp` pass: bf16 casts in `to_string()`,
     the flash node kept, the output's relative error (2-norm) against
     the f32 program's within BF16_TOL; (d) a dy2static function with
     a tensor-dependent `while`, `break` and `if` on CUDA tensors
     against its eager Python run. `--jit-only` runs phases 1, 2 and
     25.
 26. the process layer and data parallelism (ROADMAP A.13f(i)): the
     port's launcher (`python -m paddle_tpu_torch.distributed.launch`,
     `--nproc_per_node 2 --devices 0`) starts two ranks of this script
     (`--dist-child`) that join a gloo process group on the one card
     (NCCL takes one rank a device); each rank writes JSON the parent
     reads, and a failed rank fails the phase. (b) `all_reduce` SUM / MAX
     / MIN / PROD / AVG (and SUM in bf16), `broadcast(src=1)`,
     `all_gather`, `reduce_scatter`, `all_gather_object`, `barrier` and
     the TCPStore across the two ranks on CUDA tensors, exact; then a
     one-rank NCCL group's `all_reduce` and `broadcast` on the card.
     (a) ResNet-50 `Model.train_batch` at a global batch of 128
     (3x32x32, f32, phase 23's weights at lr 0.01, SyncBatchNorm), each
     rank on its 64 rows; each of 5 steps held to the one-process step
     from the same weights, optimizer state and batch (rank 0 runs it:
     the loss within DIST_LOSS_RTOL, the update within
     DIST_UPDATE_RTOL); then 5 timed steps: step ms, the gradient
     all-reduce's ms and share of the step (102 MB of f32 through
     gloo's host staging), kernels a step. (c) the
     multi-controller `gpt_spmd` dp2 step at GPT-125M's widths (hidden
     768, 12 heads, S=1024, vocab 50304, bf16, 2 layers, B=8), 3 steps,
     one rank a process, held to the one-controller dp2 plan
     (DIST_GPT_RTOL) and launching the flash kernels 2 x 3 times each in
     each process. `--dist-only` runs phases 1, 2 and 26.
 27. fleet and hybrid parallelism (`fleet_phase`): (a) ERNIE-3.0-Base
     (12 layers, hidden 768, vocab 40000, dropouts 0, f32) as
     `ernie_pipeline_descs` -> `PipelineLayer(num_stages=2)` through
     `Model.fit` over a {"pp": 2} mesh on the one card, B=32, S=128,
     microbatches 4, SGD, 3 steps, each held to the unpipelined step of
     the same PipelineLayer from the same weights (loss, update), with
     step ms, flash launches and kernels a step; (b) two ranks through the
     port's launcher (gloo, card 0): `fleet.init(mp_degree=2)`,
     `distributed_model` / `distributed_optimizer` and `Model` over
     tests/test_hapi_hybrid.py's TinyErnie structure at ERNIE-3.0-Base's
     widths (VocabParallelEmbedding, 12 Column->Row blocks, a
     vocab-parallel head and ParallelCrossEntropy), B=32, S=128, 3 steps
     held to the one-process step from the same state, the mp
     collectives' share of the step; (c) in the same ranks, the
     `gpt_spmd` plans of tests/dist_hybrid_worker.py at GPT-125M's widths
     (2 layers a stage, bf16) with pp, mp and sharding across the two
     processes, 3 steps each, held bit for bit to the one-controller plan
     run in the parent (the losses, and a SHA-256 of every leaf of every
     rank), and each process's flash launches.
     `--fleet-only` runs phases 1, 2 and 27.
 28. fleet across processes: ERNIE-3.0-Base pp2 one stage a process and
     the `gpt_spmd` plans of `FLEET3_GPT_PLANS` in one launch of two
     ranks, held to the parent's one-controller runs. `--fleet3-only`
     runs phases 1, 2, 27 and 28.
 29. the parameter-server tables: the device embedding cache over a
     2^21-key table and two shard servers in child processes.
     `--ps-only` runs phases 1, 2 and 29.
 30. the rest of the surface (ROADMAP A.13h): (a) the custom-op recipe's
     hand-written kernel (`utils/cpp_extension/recipe/scale_shift.cu`),
     built by the port's `cpp_extension.load` in phase 2's time (a thread
     beside the other nvccs), against its plain version `x * a + b` on
     2^26 elements in f32 and bf16, aligned and not, bit for bit; its time
     with L2 flushed beside the bytes bound and `torch.add(b, x, alpha=a)`;
     the recipe's path (the eager op with its gradient `g * a`, and the
     op inside a `to_static` program) counted from 0; (b) the first blocks
     of SECOND's sparse middle encoder (SubmConv3D 4->16, 16->16, Conv3D
     16->32 stride 2, SubmConv3D 32->32, padding 1) on KITTI's voxel grid
     [41, 1600, 1408] over two generated LiDAR-like sweeps of 20,000
     voxels: each layer's device rulebook index for index against the
     host plain rulebook, the pairs per offset, the values against the
     same Layers on the CPU (1e-4), the device forward and the host
     rulebooks' times; (c) `incubate.nn.FusedMultiTransformer` at
     GPT-1.3B's widths (24 layers, 2048, 16 heads, 8192, f32): a prefill
     B=4, S=512 under an additive causal mask through fresh caches, 24
     flash forward launches by the counter, `sdpa_routes` and the
     profiler, then 16 decode steps on the plain route, held to the same
     stack on the plain attention (max |diff| / RMS <= 1e-4); (d)
     ResNet-50 at B=128, 3x32x32 through `fuse_conv_bn` and
     `PostTrainingQuantization(algo="KL")` with per-channel weights over
     4 batches, `jit.save`, served by the Predictor in a fresh process
     within 1e-5 of the in-process model; BERT-base's Linear weights
     pruned 2:4 by `incubate.asp` and one `decorate`d AdamW step on the
     card keeping 2:4. `--rest-only` runs phases 1, 2 and 30 (record
     `chiprun_out/chip_smoke_rest.json`).
 31. the kernels' tiles at launch (`incubate.autotune`, the tile table):
     (a) every new build (the paged kernels at split_keys 256 and
     chunk_keys 32, the 16-bit flash forward at (128, 64); dQ at (128,
     128) spilled and was dropped) against its plain version at phases
     3 and 7's tolerances, each launch twice and bit for bit, the table
     forcing its pair: paged
     decode at key counts one below, at and one above each split edge
     and a pos = -1 slot, T=5 windows across a split edge, 100-row tiles,
     every mode at head dims 32, 64 and 128; flash in bf16 and float16 at
     D 64 and 128, plain and mask/dropout, S that no tile divides, GQA;
     (b) a table of pairs no build has ([0, -3], [96, 96]) and a rotted
     JSON file (env-path and shipped): the default builds run, no raise;
     (c) phase 4's server captured with the shipped table in force and
     with `kernel.enable` off: its 16 greedy streams equal (near-tie rule
     as phase 13's), and equal phase 4's; the decode step of 8 requests
     timed in alternated pairs; (d) a flash forward's host µs with the
     table on and off, and each lookup's; (e) every new build on a main
     path with its counts from 0: phase 4's engine at each new paged
     pair, phase 10's speculative engine at split 256, GPT-350M's widths
     at 2 layers through `make_train_step` at each new flash pair.
     `--tune-only` runs phases 1, 2 and 31 with the sweep first: each
     paged geometry (phase 4's engine; phase 24 (b)'s GPT-1.3B) scored at
     every (split_keys, chunk_keys) by its launch mix (PERF.md §6:
     launches x ms over decode, windows and tiles), each flash geometry
     (phase 8's step; phase 22 (e)'s masked encoder) by forward + dQ +
     dK/dV ms at every pair, the default and each candidate alternated
     over 3 rounds; a winner that beats the default by more than the
     default's spread is committed with `commit_shipped_table(...,
     backend="cuda")` into `chiprun_out/flash_blocks_tuned.json`, a copy
     of the shipped table (copy it over
     `paddle_tpu_torch/ops/flash_blocks_tuned.json` to ship it); record
     `chiprun_out/chip_smoke_tune.json`.

The line before the last is the `kernels` JSON summary; the last line is
`{"ok": true, "device": {...}}`. Without CUDA, or outside a checkout of
the repository, it exits non-zero and prints no result. Longer output
goes to `chiprun_out/chip_smoke.json`.
"""
import json
import math
import os
import re
import statistics
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

ATOL = RTOL = 1e-5          # f32: the kernel's summation order differs
SPEC_AGREE = 0.9            # phase 11: spec x int8 vs one-token int8
QUANT_MATCH = 0.99          # phase 11: int8 weights vs float, greedy
QUANT_KL = 1e-3             # phase 11: mean KL(float || int8 weights)
BF16_TOL = 1e-2             # bf16 output rounding (8 mantissa bits)
# float16 (11 significant bits): one rounding step of an output is at most
# 2^-10 of its magnitude, and the kernels may differ from the plain version
# by one; 2e-3 allows two. A build that rounds P or dS to bf16 (unit
# roundoff 2^-8) exceeds it: phase 24 (c) holds such a control to it.
F16_TOL = 2e-3
GAP_MIN = 1e-3              # phase 6: below this the argmax is a near-tie
# phase 9 (f32, lr 2e-4): the paths sum in other orders, and Adam divides
# each gradient element by its own running scale, so where an element's
# gradient is near zero (the key bias's is zero in exact arithmetic) its
# rounding noise moves the weight by up to about lr. Each leaf's update as
# a whole must agree to 1e-2: a wrong gradient changes it at order 1.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PARAM_ATOL = 2e-4     # lr
TRAIN_UPDATE_RTOL = 1e-2    # |dW_kernel - dW_plain| / |dW_plain| per leaf


def log(*a):
    print(*a, flush=True)


def device_peaks(kind):
    """The H100 SXM peaks (`cost_model.DEVICES`, NVIDIA's data sheet) for
    products of `kind`: float32 (q is f32, and int8 codes are dequantised
    to f32 before they multiply it) outside the tensor cores, or bf16
    dense on the tensor cores; both read HBM3 at 3.35 TB/s."""
    from paddle_tpu_torch.cost_model import DEVICES
    return DEVICES["h100-sxm" if kind in ("bf16", "f16")
                   else "h100-sxm-fp32"]


# ------------------------------------------------------------------ timing
def _flush_l2(buf):
    buf.add_(1.0)             # 256 MB through the 50 MB L2


def time_ms(fn, flush, iters=20, warmup=3):
    """Mean device time of fn() over `iters` launches, each timed by its
    own CUDA events after an L2 flush (the serving path finds the cache
    cold: twelve layers' pools cycle through it). A ~1 ms sleep kernel
    after the flush lets the host enqueue fn's launches before the card
    reaches them, so the events time the device work, not the host's
    launch overhead."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        flush()
        torch.cuda._sleep(2_000_000)
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        torch.cuda.synchronize()
        total += s.elapsed_time(e)
    return total / iters


def host_us(fn, iters=200):
    """Host time of one call of fn() (launch overhead), with the card
    kept busy so no call waits for it."""
    import torch
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


# -------------------------------------------------------- kernel test cases
def paged_case(seed, S, T, pos, *, H=12, D=64, bs=16, nb=64, kind="f32",
               poison=True, all_nan=False):
    """A paged state as the engine lays it out: every position up to
    pos+T-1 is backed by a real block, later table entries point at the
    garbage block 0 (poisoned with NaN/inf when `poison`)."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(seed)
    N = 1 + S * nb
    shape = (N, bs, H, D)
    fdt = torch.bfloat16 if kind == "bf16" else torch.float32
    q = torch.randn((S, T, H, D), generator=g, device="cuda").to(fdt)
    out = {"q": q}
    if kind == "int8":
        out["k"] = torch.randint(-127, 128, shape, generator=g,
                                 device="cuda", dtype=torch.int8)
        out["v"] = torch.randint(-127, 128, shape, generator=g,
                                 device="cuda", dtype=torch.int8)
        out["ks"] = torch.rand((N, H), generator=g, device="cuda") * 4 + .1
        out["vs"] = torch.rand((N, H), generator=g, device="cuda") * 4 + .1
        if poison:
            out["ks"][0] = float("nan")
            out["vs"][0] = float("inf")
    else:
        out["k"] = torch.randn(shape, generator=g, device="cuda").to(fdt)
        out["v"] = torch.randn(shape, generator=g, device="cuda").to(fdt)
        if all_nan:
            out["k"].fill_(float("nan"))
            out["v"].fill_(float("nan"))
        elif poison:
            out["k"][0] = float("nan")
            out["v"][0] = float("inf")
    perm = torch.randperm(N - 1, generator=torch.Generator().manual_seed(
        seed)) + 1
    tables = torch.zeros((S, nb), dtype=torch.int32)
    at = 0
    for s in range(S):
        live = max(0, min(nb, -(-(pos[s] + T) // bs)))
        tables[s, :live] = perm[at:at + live].to(torch.int32)
        at += live
    out["tables"] = tables.cuda()
    out["pos"] = torch.tensor(pos, dtype=torch.int32, device="cuda")
    return out


def case_bound(c, kind):
    """Least time for this call on an H100: bytes each input read once
    (the visible K/V rows, q, the tables, the scale rows of the visited
    blocks) and the output written once, against the products over the
    visible keys (4*D flops per query-key pair and head)."""
    q = c["q"]
    S, T, H, D = q.shape
    bs = c["k"].shape[1]
    elsize = c["k"].element_size()
    L = c["tables"].shape[1] * bs
    pos = c["pos"].tolist()
    rows = sum(max(0, min(p + T, L)) for p in pos)
    pairs = sum(max(0, min(p + i + 1, L)) for p in pos for i in range(T))
    nbytes = 2 * rows * H * D * elsize + 2 * q.numel() * q.element_size() \
        + c["tables"].numel() * 4 + len(pos) * 4
    if "ks" in c:
        nbytes += 2 * sum(-(-max(0, min(p + T, L)) // bs) for p in pos) \
            * H * 4
    flops = 4 * pairs * H * D
    t_bytes = nbytes / device_peaks(kind).hbm_bw * 1e3
    t_ops = flops / device_peaks(kind).peak_flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def paged_cases(sp):
    """Phase 3's cases: (name, shape, kind) for a decode split of `sp`
    keys."""
    rng = __import__("random").Random(0)
    ragged = [0, 15, 16, 17, 255, 511, 777, 1000]
    # verify windows: from 0 to the window that ends on the table's last
    # key (1024 keys), two of them across a 16-token block edge
    verify5 = [0, 12, 14, 255, 500, 777, 1000, 1019]
    verify2 = [0, 12, 15, 255, 500, 777, 1000, 1022]

    def edges(L):
        """Decode positions at the kernel's split edges: key counts one
        below, at and one above the first and the second split boundary,
        the full table, and a slot with no key (pos = -1) beside them."""
        return [sp - 2, sp - 1, sp, 2 * sp - 2, 2 * sp - 1, 2 * sp, L - 1,
                -1]
    return [
        ("decode_f32", dict(S=8, T=1, pos=ragged), "f32"),
        ("decode_f32_rand", dict(S=8, T=1,
                                 pos=[rng.randint(0, 1000) for _ in range(8)]),
         "f32"),
        ("prefill_f32_T64", dict(S=2, T=64, pos=[0, 256]), "f32"),
        ("prefill_f32_T128", dict(S=2, T=128, pos=[0, 256]), "f32"),
        ("prefill_f32_T512", dict(S=2, T=512, pos=[0, 256]), "f32"),
        # a 7-row window (the window kernel's 8-row instance), and
        # 8-token blocks
        ("prefill_f32_T7", dict(S=3, T=7, pos=[0, 61, 300]), "f32"),
        ("decode_f32_bs8", dict(S=8, T=1, pos=ragged[:7] + [500], bs=8),
         "f32"),
        ("decode_int8", dict(S=8, T=1, pos=ragged), "int8"),
        ("prefill_int8_T128", dict(S=2, T=128, pos=[0, 256]), "int8"),
        ("decode_bf16", dict(S=8, T=1, pos=ragged), "bf16"),
        ("all_masked", dict(S=8, T=1, pos=[-1] * 8), "nan"),
        # the decode kernel's split edges, with 16- and 8-token blocks
        ("decode_edges_f32", dict(S=8, T=1, pos=edges(1024)), "f32"),
        ("decode_edges_int8", dict(S=8, T=1, pos=edges(1024)), "int8"),
        ("decode_edges_bf16", dict(S=8, T=1, pos=edges(1024)), "bf16"),
        ("decode_edges_bs8_f32", dict(S=8, T=1, pos=edges(512), bs=8),
         "f32"),
        ("decode_edges_bs8_int8", dict(S=8, T=1, pos=edges(512), bs=8),
         "int8"),
        ("decode_edges_bs8_bf16", dict(S=8, T=1, pos=edges(512), bs=8),
         "bf16"),
        # speculative verify windows (gamma 4 and 1) on the window
        # kernel, and the T=1 kernel at the same positions
        ("verify_f32_T5", dict(S=8, T=5, pos=verify5), "f32"),
        ("verify_int8_T5", dict(S=8, T=5, pos=verify5), "int8"),
        ("verify_f32_T2", dict(S=8, T=2, pos=verify2), "f32"),
        ("decode_f32_verify_pos", dict(S=8, T=1, pos=verify5), "f32"),
        ("verify_bf16_T5", dict(S=8, T=5, pos=verify5), "bf16"),
        # T=5 windows at the first split edge: ending on its last key,
        # straddling it by 1..4 keys, and one past the second edge
        ("verify_f32_T5_split_edge",
         dict(S=8, T=5, pos=[sp - 5, sp - 4, sp - 3, sp - 2, sp - 1,
                             2 * sp - 2, -1, 1019]), "f32"),
        # the boundary of the window path (T <= 16) and the tile path
        ("window_f32_T16", dict(S=8, T=16, pos=[0, 5, 112, 127, 255, 500,
                                                1000, 1008]), "f32"),
        ("prefill_f32_T17", dict(S=8, T=17, pos=[0, 5, 111, 127, 255, 500,
                                                 999, 1007]), "f32"),
        ("prefill_bf16_T128", dict(S=2, T=128, pos=[0, 256]), "bf16"),
        # the serving path's own prefill shapes: one slot, a bucket of
        # 32 at position 0 and of 256 after the 256-token prefix hit
        ("prefill_f32_S1_T32", dict(S=1, T=32, pos=[0]), "f32"),
        ("prefill_f32_S1_T256", dict(S=1, T=256, pos=[256]), "f32"),
    ]


def run_kernel_cases(flush, cases=None, seed=100, timed=None):
    """Phase 3 (and phases 24 (c) and 31 with their own `cases`, whose
    shapes may set H and D): each paged case against its plain version,
    launched twice, then timed beside its bound and SDPA (every case, or
    those named in `timed`)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.serving import blocks
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.ops.paged_attention import paged_attention

    if cases is None:
        cases = paged_cases(pa.decode_split_keys(12, 1024, 64, 16))
    results = []
    for i, (name, shape, kind) in enumerate(cases):
        c = paged_case(seed + i, shape["S"], shape["T"], shape["pos"],
                       H=shape.get("H", 12), D=shape.get("D", 64),
                       bs=shape.get("bs", 16),
                       kind="f32" if kind == "nan" else kind,
                       all_nan=kind == "nan")
        q, k, v, tb, pos = c["q"], c["k"], c["v"], c["tables"], c["pos"]
        if kind == "int8":
            def kern():
                return paged_attention(q, k, v, tb, pos, k_scale=c["ks"],
                                       v_scale=c["vs"])

            def plain():
                return blocks.attend_quant(q, k, v, c["ks"], c["vs"], tb,
                                           pos)
            kd = blocks.gather_quant(k, c["ks"], tb)
            vd = blocks.gather_quant(v, c["vs"], tb)
        else:
            def kern():
                return paged_attention(q, k, v, tb, pos)

            if kind == "bf16":
                # the plain version in f32 over the same bf16 values
                def plain():
                    return blocks.attend(q.float(), k.float(), v.float(),
                                         tb, pos)
            else:
                def plain():
                    return blocks.attend(q, k, v, tb, pos)
            kd, vd = blocks.gather(k, tb), blocks.gather(v, tb)
        got = kern()
        again = kern()
        want = plain()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise AssertionError(f"{name}: two launches on the same inputs "
                                 "differ (the kernel must repeat bit for "
                                 "bit)")
        # query row i of slot s sees no key iff pos[s] + i < 0
        empty = pos[:, None] + torch.arange(q.shape[1], device="cuda") < 0
        if bool(empty.any()) and bool((got[empty] != 0).any()):
            raise AssertionError(f"{name}: rows with no visible key must be "
                                 "exact zeros")
        err = (got.float() - want.float()).abs()
        tol = BF16_TOL if kind == "bf16" else ATOL
        rtol = BF16_TOL if kind == "bf16" else RTOL
        bad = err > tol + rtol * want.float().abs()
        finite = bool(torch.isfinite(got).all())
        max_err = float(err.max())
        if not finite or bool(bad.any()):
            raise AssertionError(
                f"{name}: kernel disagrees with the plain version "
                f"(max_abs_err={max_err}, finite={finite})")
        bound, bound_by, nbytes, flops = case_bound(c, kind)
        rec = {"case": name, "S": int(q.shape[0]), "T": int(q.shape[1]),
               "H": int(q.shape[2]), "D": int(q.shape[3]),
               "bs": int(k.shape[1]), "pos": shape["pos"], "kind": kind,
               "max_abs_err": max_err, "tol": [tol, rtol],
               "bound_ms": bound, "bound_by": bound_by, "bytes": nbytes,
               "flops": flops}
        results.append(rec)
        if timed is not None and name not in timed:
            log(f"case {name}: S={rec['S']} T={rec['T']} H={rec['H']} "
                f"D={rec['D']} bs={rec['bs']} max_abs_err={max_err:.3e} "
                f"(tol {tol}/{rtol}), repeats bit for bit")
            continue
        kms = time_ms(kern, flush)
        khost = host_us(kern)
        pms = time_ms(plain, flush)
        lib_ms = None
        if kind != "nan":
            # yardstick: SDPA over the gathered dense view, same mask
            S, T = q.shape[0], q.shape[1]
            L = kd.shape[1]
            lim = pos.long()[:, None] + torch.arange(T, device="cuda")
            mask = (torch.arange(L, device="cuda")[None, None, :]
                    <= lim[:, :, None])[:, None]
            qd = q.transpose(1, 2)
            kt = kd.to(q.dtype).transpose(1, 2).contiguous()
            vt = vd.to(q.dtype).transpose(1, 2).contiguous()
            lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qd, kt, vt, attn_mask=mask), flush)
        rec.update(ms=kms, host_us=khost, plain_ms=pms, library_ms=lib_ms)
        log(f"case {name}: S={rec['S']} T={rec['T']} H={rec['H']} "
            f"D={rec['D']} bs={rec['bs']} max_abs_err={max_err:.3e} "
            f"(tol {tol}/{rtol}) kernel_ms={kms:.4f} host_us={khost:.1f} "
            f"plain_ms={pms:.4f} "
            f"sdpa_ms={lib_ms if lib_ms is None else round(lib_ms, 4)} "
            f"bound_ms={bound:.5f} ({bound_by})")
    return results


# ------------------------------------------------------------------ serving
def run_timed(sched):
    """Run `sched` until idle. Returns the host seconds of every step that
    made one decode call (`decode`, or `decode_many` for a speculative
    engine) and no prefill, outside that call: the scheduler's own work a
    step, its SLO machinery included."""
    eng = sched.engine
    name = "decode_many" if hasattr(eng, "decode_many") else "decode"
    saved = {n: vars(eng).get(n) for n in (name, "prefill")}
    inner, inner_prefill = getattr(eng, name), eng.prefill
    calls, prefills = [], [0]

    def timed(*a, **kw):
        t0 = time.perf_counter()
        out = inner(*a, **kw)           # a raise leaves the step uncounted
        calls.append(time.perf_counter() - t0)
        return out

    def counted(*a, **kw):
        prefills[0] += 1
        return inner_prefill(*a, **kw)
    setattr(eng, name, timed)
    eng.prefill = counted
    over = []
    try:
        while True:
            n, p = len(calls), prefills[0]
            t0 = time.perf_counter()
            more = sched.step()
            dt = time.perf_counter() - t0
            if len(calls) == n + 1 and prefills[0] == p:
                over.append(dt - calls[-1])
            if not more:
                return over
    finally:
        for n, v in saved.items():
            if v is None:
                delattr(eng, n)
            else:
                setattr(eng, n, v)


def step_host_us(over):
    """Median, mean and count of `run_timed`'s per-step host seconds, µs."""
    xs = sorted(over)
    if not xs:
        return {"steps": 0, "median_us": None, "mean_us": None}
    return {"steps": len(xs), "median_us": xs[len(xs) // 2] * 1e6,
            "mean_us": sum(xs) / len(xs) * 1e6}


def decode_failures():
    """The port's `serving_decode_failures_total` now."""
    from paddle_tpu_torch.observability import metrics
    return metrics.registry().counter("serving_decode_failures_total").value


def serve(engine, prompts, max_new, config=None, tenants=None):
    """Submit every prompt (labelled `tenants[i]` when given), run the
    scheduler until idle; returns (handles, metrics, wall seconds).
    `metrics["sched_host_us"]` is the scheduler's host time a decode step
    outside the decode call (`run_timed`). Every request must end DONE
    with `max_new` tokens, and no decode or prefill failure may be
    contained on the way."""
    from paddle_tpu_torch.serving import Scheduler, ServingConfig
    sched = Scheduler(engine, config or ServingConfig(max_queue=64),
                      device=engine.device)
    failures = decode_failures()
    tenants = tenants or [None] * len(prompts)
    handles = [sched.submit(p, max_new_tokens=max_new, tenant=t)
               for p, t in zip(prompts, tenants)]
    t0 = time.perf_counter()
    over = run_timed(sched)     # every step ends in a host read of tokens
    wall = time.perf_counter() - t0
    sched.close()
    for h in handles:
        if h.status != "DONE" or len(h.tokens) != max_new:
            raise AssertionError(f"request {h.request_id} ended {h.status} "
                                 f"with {len(h.tokens)} tokens ({h.error})")
    if decode_failures() != failures:
        raise AssertionError(f"{decode_failures() - failures} decode "
                             "failures were contained while serving")
    m = sched.metrics()
    m["sched_host_us"] = step_host_us(over)
    return handles, m, wall


def decode_only_tok_s(m):
    """The decode steps' own rate, `Scheduler.metrics()`' `decode_tokens`
    over the decode time (the rate this script has printed since the
    serving slice; `decode_tokens_per_s` counts every delivered token,
    each prefill's first included, as the reference does)."""
    t = m["decode_step_ms"] * m["decode_steps"] / 1e3
    return m["decode_tokens"] / t if t > 0 else 0.0


def check_captures(engine, what, every=True):
    """Every executable of `engine` captured once (`every`), or none more
    than once; returns the counts."""
    counts = dict(engine.capture_counts)
    names = engine.executable_names()
    if any(n not in names or c != 1 for n, c in counts.items()) or \
            (every and set(counts) != set(names)):
        raise AssertionError(f"{what}: capture counts {counts}, want 1 "
                             f"for each of {names}")
    return counts


def precompile(engine, what):
    """Capture every executable of `engine`; returns the seconds taken."""
    import torch
    t0 = time.perf_counter()
    report = engine.precompile()
    torch.cuda.synchronize()
    if set(report.values()) != {"captured"}:
        raise AssertionError(f"{what}: precompile reported {report}")
    return time.perf_counter() - t0


def make_prompts(seed, lengths, shared_from, vocab):
    import numpy as np
    rng = np.random.RandomState(seed)
    shared = rng.randint(0, vocab, 256).tolist()
    out = []
    for i, n in enumerate(lengths):
        tail = rng.randint(0, vocab, n).tolist()
        out.append((shared + tail)[:n] if i >= shared_from and n > 256
                   else tail)
    return out


def compare_paths(model, prompts, steps=8):
    """Phase 6: kernel engine vs gather engine, same weights, on the card.
    Returns (compared steps, steps dropped by the near-tie rule)."""
    import torch
    from paddle_tpu_torch.serving import PagedGenerationEngine
    engs = {impl: PagedGenerationEngine(
        model, slots=len(prompts), block_size=16, attention_impl=impl,
        max_len=model.cfg.max_position_embeddings, device=model.device)
            for impl in ("kernel", "gather")}
    gaps = []                 # per step: plain top-2 gap per slot
    plain = engs["gather"]
    sel, sel_slots = plain._select, plain._select_slots

    def gap(logits):
        top = torch.topk(logits.float(), 2, dim=-1).values
        return (top[..., 0] - top[..., 1]).reshape(-1).tolist()

    def cap_select(logits, slot):
        gaps.append(("prefill", slot, gap(logits)[0]))
        return sel(logits, slot)

    def cap_slots(logits, picks=None):
        gaps.append(("decode", None, gap(logits)))
        return sel_slots(logits, picks)
    plain._select, plain._select_slots = cap_select, cap_slots

    toks = {impl: [[] for _ in prompts] for impl in engs}
    for impl, eng in engs.items():
        for s, p in enumerate(prompts):
            toks[impl][s].append(eng.prefill(s, p))
        for _ in range(steps):
            out = eng.decode()
            for s in range(len(prompts)):
                toks[impl][s].append(int(out[s]))
    slot_gaps = [[None] * (steps + 1) for _ in prompts]
    di = 0
    for kind, slot, g in gaps:
        if kind == "prefill":
            slot_gaps[slot][0] = g
        else:
            di += 1
            for s in range(len(prompts)):
                slot_gaps[s][di] = g[s]
    compared = dropped = 0
    for s in range(len(prompts)):
        for t in range(steps + 1):
            if slot_gaps[s][t] < GAP_MIN:
                dropped += steps + 1 - t
                break
            if toks["kernel"][s][t] != toks["gather"][s][t]:
                raise AssertionError(
                    f"slot {s} step {t}: kernel token "
                    f"{toks['kernel'][s][t]} != plain "
                    f"{toks['gather'][s][t]} (plain gap "
                    f"{slot_gaps[s][t]:.3e})")
            compared += 1
    launches = engs["kernel"].kernel_launches
    if launches <= 0:
        raise AssertionError("phase 6: the kernel engine launched nothing")
    return compared, dropped


def replay_vs_eager(model, prompts):
    """Phase 6: one replayed decode step against the same forward run
    eagerly (outside any graph) on the same state. The eager run writes
    the same K/V at the same positions, so both read one pool."""
    import torch
    from paddle_tpu_torch.serving import PagedGenerationEngine
    eng = PagedGenerationEngine(model, slots=len(prompts), max_len=1024,
                                block_size=16, attention_impl="kernel",
                                device=model.device)
    for s, p in enumerate(prompts):
        eng.prefill(s, p)
    for _ in range(2):
        eng.decode()                  # captures "decode", moves positions
    eng.ensure_decode_capacity()
    eng._io.upload()
    replayed = eng._exe.replay("decode")[0].clone()
    eager = eng._decode_fn()[0]
    torch.cuda.synchronize()
    equal = bool(torch.equal(replayed, eager))
    err = float((replayed - eager).abs().max())
    rec = {"bit_equal": equal, "max_abs_err": err, "tol": 1e-6,
           "positions": [int(x) for x in eng.slot_positions()]}
    log(f"replay vs eager decode step (8 slots, logits [8, 50304]): "
        f"bit-equal {equal}, max_abs_err {err:.3e}")
    if not equal and not err <= 1e-6:
        raise AssertionError(f"phase 6: the replayed decode step differs "
                             f"from the eager forward by {err}")
    return rec


def device_kernels(prof):
    """The kernels (and copies) of a torch.profiler capture: its CUDA
    events without the device ranges of user annotations. The port's
    `RecordEvent` spans (`serving::...`, `fault::...`) open a
    `record_function` range while the profiler records, and its device
    range spans the kernels it encloses."""
    return [e for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith(("serving::", "fault::", "graph::",
                                      "train::"))]


class card_profile:
    """A torch.profiler session over the card (and the host's operators
    unless cpu=False), opened through `deviceprof.start_session` so that
    its window records every device event (opened straight away, a late
    session lost its first 6-8, and now and then a whole step)."""

    def __init__(self, cpu=True):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CUDA]
        if cpu:
            acts.insert(0, ProfilerActivity.CPU)
        self.prof = profile(activities=acts)

    def __enter__(self):
        import torch
        from paddle_tpu_torch.observability.deviceprof import start_session
        start_session(self.prof, torch.device("cuda"))
        return self.prof

    def __exit__(self, *exc):
        self.prof.stop()
        return False


def profile_steps(step, steps):
    """One warm-up call of step() (which ends in a host read), `steps`
    calls untraced (host clock), then `steps` under torch.profiler: device
    busy time per call, the kernels launched per call and the largest
    kernels by device time."""
    import torch
    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    with card_profile() as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) / steps * 1e3
    kernels = device_kernels(prof)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0.0)
    busy_ms = sum(dev_us(e) for e in kernels) / steps / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:6]
    paged = [e for e in kernels if "paged_" in e.key]
    return {"steps": steps,
            "step_ms_untraced": wall_ms, "step_ms_traced": traced_ms,
            "device_busy_ms_per_step": busy_ms,
            "paged_ms_per_step": sum(dev_us(e) for e in paged) / steps / 1e3,
            "paged_launches_per_step": sum(e.count for e in paged) / steps,
            "device_idle_share": (1 - busy_ms / traced_ms
                                  if busy_ms else None),
            "device_idle_share_untraced": (1 - busy_ms / wall_ms
                                           if busy_ms else None),
            "kernels_per_step": sum(e.count for e in kernels) / steps,
            "kernel_counts": {e.key: e.count for e in kernels},
            "kernel_ms": {e.key: dev_us(e) / 1e3 for e in kernels},
            "top": [{"name": e.key[:60], "ms_per_step":
                     dev_us(e) / steps / 1e3, "count": e.count // steps}
                    for e in top]}


def kernel_diff(a, b):
    """{kernel: (count in a, count in b)} for the kernels whose counts
    differ between two profile_steps records."""
    ca, cb = a["kernel_counts"], b["kernel_counts"]
    return {k: (ca.get(k, 0), cb.get(k, 0)) for k in sorted(set(ca) | set(cb))
            if ca.get(k, 0) != cb.get(k, 0)}


def kernel_rows_diff(rec, prof, steps, n=6):
    """The `n` kernels (base names) whose device ms a step differ most
    between a deviceprof record over `steps` steps and a profile_steps
    record: [(name, capture ms, profile ms, capture calls, profile
    calls)] a step."""
    from paddle_tpu_torch.observability.deviceprof import kernel_base_name
    rows = {}
    for o in rec["ops"]:
        r = rows.setdefault(o["op"], [0.0, 0.0, 0, 0])
        r[0] += o["device_ms"] / steps
        r[2] += o["calls"] / steps
    for key, ms in prof["kernel_ms"].items():
        r = rows.setdefault(kernel_base_name(key), [0.0, 0.0, 0, 0])
        r[1] += ms / prof["steps"]
        r[3] += prof["kernel_counts"][key] / prof["steps"]
    top = sorted(rows.items(), key=lambda kv: -abs(kv[1][0] - kv[1][1]))
    return [(k, round(a, 4), round(b, 4), c, d) for k, (a, b, c, d) in top[:n]]


def profile_decode(model, prompts, steps=8, engine_sink=None, **kw):
    """One-token decode steps of a full 8-slot kernel engine (`kw`: more
    engine options; the engine and the tokens of every profiled call go
    to `engine_sink` when given)."""
    from paddle_tpu_torch.serving import PagedGenerationEngine
    eng = PagedGenerationEngine(model, slots=len(prompts), max_len=1024,
                                block_size=16, attention_impl="kernel",
                                device=model.device, **kw)
    for s, p in enumerate(prompts):
        eng.prefill(s, p)
    toks = []

    def step():
        toks.append(eng.decode().copy())
    rec = profile_steps(step, steps)
    if engine_sink is not None:
        engine_sink.extend([eng, toks])
    rec["capture_counts"] = check_captures(eng, "profile", every=False)
    rec.update(slots=len(prompts),
               positions=[int(x) for x in eng.slot_positions()])
    return rec


def log_profile(what, prof, smi):
    log(f"profile {what} (8 slots at positions {prof['positions']}): "
        f"{prof['step_ms_untraced']:.3f} ms untraced, "
        f"{prof['step_ms_traced']:.3f} ms traced, device busy "
        f"{prof['device_busy_ms_per_step']:.3f} ms each, idle share "
        f"{prof['device_idle_share']} of the traced step, "
        f"{prof['device_idle_share_untraced']} of the untraced one, "
        f"{prof['kernels_per_step']:.0f} kernels each; the paged kernel "
        f"{prof['paged_ms_per_step']:.4f} ms in "
        f"{prof['paged_launches_per_step']:.0f} launches [{smi}]")
    for t in prof["top"]:
        log(f"  {t['ms_per_step']:.4f} ms x{t['count']} {t['name']}")


# --------------------------------------------------- speculative serving
# phase 10's engine: the issue's configuration of the speculative server
SPEC = dict(slots=8, max_len=1024, block_size=16, attention_impl="kernel",
            gamma=4, draft_layers=2)


def top2_gaps(logits):
    """Top-2 logit gap of each row of a [rows, V] array."""
    import numpy as np
    top = np.sort(np.asarray(logits, np.float64), axis=-1)[:, -2:]
    return top[:, 1] - top[:, 0]


def serve_spec(model, prompts, smi):
    """Phase 10: the speculative server answers phase 4's requests. Returns
    (record, handles, window launches, prefill-tile launches)."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import SpeculativeEngine
    cfg = model.cfg
    eng = SpeculativeEngine(model, device=model.device, **SPEC)
    capture_s = precompile(eng, "phase 10")
    rounds = []
    spec_round = eng.decode_many

    def recorded():
        out = spec_round()
        rounds.append(eng.last_spec_stats)
        return out
    eng.decode_many = recorded
    pa.launches = pa.launches_window = pa.launches_prefill = 0
    handles, m, wall = serve(eng, prompts, max_new=32)
    launches, window = pa.launches, pa.launches_window
    prefill = pa.launches_prefill
    n_rounds = m["decode_steps"]
    prefills = len(prompts) + m["requests"]["serving.preempted"]
    if launches != cfg.num_layers * (n_rounds + prefills):
        raise AssertionError(
            f"phase 10: {launches} paged launches, want {cfg.num_layers} "
            f"per forward over {n_rounds} verify rounds + {prefills} "
            "prefills (the draft must make none)")
    if window != cfg.num_layers * n_rounds or \
            prefill != cfg.num_layers * prefills:
        raise AssertionError(
            f"phase 10: {window} window and {prefill} tile launches, want "
            f"{cfg.num_layers} a verify round on the window path and "
            f"{cfg.num_layers} a prefill on the tile path; "
            f"{launches - window - prefill} at T=1 (the draft's or a "
            "one-token decode's)")
    counts = check_captures(eng, "phase 10")
    cached = len(eng.prefix_cache)
    eng.prefix_cache.evict(eng.block_pool.capacity)
    if eng.block_pool.in_use != 0:
        raise AssertionError(f"phase 10: {eng.block_pool.in_use} blocks "
                             "still in use after every request ended")
    draft_ms = sum(r["draft_s"] for r in rounds) / len(rounds) * 1e3
    verify_ms = sum(r["verify_s"] for r in rounds) / len(rounds) * 1e3
    rec = {"requests": len(prompts), "max_new_tokens": 32, **SPEC,
           "kernel_launches": launches, "kernel_launches_window": window,
           "kernel_launches_prefill": prefill, "rounds": n_rounds,
           "prefills": prefills,
           "preempted": m["requests"]["serving.preempted"],
           "spec_proposed": m["spec_proposed"],
           "spec_accepted": m["spec_accepted"],
           "acceptance_rate": m["spec_acceptance_rate"],
           "decode_tokens": m["decode_tokens"],
           "tokens_per_round": m["decode_tokens"] / n_rounds,
           "tokens_per_slot_round": 1 + SPEC["gamma"]
           * m["spec_acceptance_rate"],
           "round_ms": m["decode_step_ms"],
           "sched_host_us": m["sched_host_us"],
           "decode_only_tok_s": decode_only_tok_s(m),
           "decode_tokens_per_s": m["decode_tokens_per_s"],
           "draft_ms_per_round": draft_ms, "verify_ms_per_round": verify_ms,
           "prefix_hits": m["prefix_hits"], "prefix_blocks_at_end": cached,
           "capture_s": capture_s, "capture_counts": counts,
           "wall_s": wall, "card": smi}
    log(f"serve gpt_125m speculative (gamma 4, 2-layer draft, kernel): "
        f"{len(prompts)} requests done, acceptance "
        f"{rec['acceptance_rate']:.4f}, {n_rounds} rounds, "
        f"{rec['tokens_per_round']:.2f} tokens a round "
        f"({rec['tokens_per_slot_round']:.2f} a slot-round), "
        f"round_ms={rec['round_ms']:.3f} "
        f"decode_only_tok_s={rec['decode_only_tok_s']:.1f}, draft "
        f"{draft_ms:.3f} ms + verify {verify_ms:.3f} ms a round (host "
        f"clock), launches={launches} ({cfg.num_layers}/forward x "
        f"{n_rounds} rounds + {prefills} prefills), no block leaked; "
        f"captured in {capture_s:.2f} s, capture counts {counts} [{smi}]")
    return rec, handles, window, prefill


def profile_spec_round(model, prompts, smi):
    """Four profiled speculative rounds of a full 8-slot engine."""
    from paddle_tpu_torch.serving import SpeculativeEngine
    eng = SpeculativeEngine(model, device=model.device, **SPEC)
    for s, p in enumerate(prompts):
        eng.prefill(s, p)
    rec = profile_steps(eng.decode_many, 4)
    rec.update(slots=len(prompts),
               positions=[int(x) for x in eng.slot_positions()],
               capture_counts=check_captures(eng, "phase 10 profile",
                                             every=False))
    log_profile("speculative round", rec, smi)
    return rec


def compare_spec(model, prompts, streams, steps=32):
    """Phase 10: the speculative streams against a one-token engine's,
    token by token; a slot's comparison stops at the first step whose
    one-token top-2 gap is below GAP_MIN (the verify's matmuls run at
    slots x 5 rows and the window takes the window kernel, so a near-tie may
    flip). Returns (compared tokens, tokens dropped by the rule)."""
    from paddle_tpu_torch.serving import PagedGenerationEngine
    eng = PagedGenerationEngine(
        model, slots=len(prompts), max_len=1024, block_size=16,
        attention_impl="kernel", capture_logits=True, device=model.device)
    gaps = [[] for _ in prompts]
    sel = eng._select

    def cap_select(logits, slot):
        gaps[slot].append(float(top2_gaps(logits.float().cpu())[0]))
        return sel(logits, slot)
    eng._select = cap_select
    toks = [[eng.prefill(s, p)] for s, p in enumerate(prompts)]
    for _ in range(steps - 1):
        out = eng.decode()
        for s, g in enumerate(top2_gaps(eng.last_logits)):
            gaps[s].append(float(g))
            toks[s].append(int(out[s]))
    compared = dropped = 0
    for s, spec in enumerate(streams):
        for t in range(steps):
            if gaps[s][t] < GAP_MIN:
                dropped += steps - t
                break
            if spec[t] != toks[s][t]:
                raise AssertionError(
                    f"phase 10: slot {s} token {t}: speculative "
                    f"{spec[t]} != one-token {toks[s][t]} (gap "
                    f"{gaps[s][t]:.3e})")
            compared += 1
    return compared, dropped


def quant_weights_quality(model, prompts, smi, steps=16):
    """Phase 11: int8 decode weights teacher-forced against the float
    engine (both fed the float engine's token each step), and the device
    time of one decode forward's dequant."""
    import numpy as np
    import torch
    from paddle_tpu_torch.serving import PagedGenerationEngine
    kw = dict(slots=len(prompts), max_len=1024, block_size=16,
              attention_impl="kernel", capture_logits=True,
              device=model.device)
    fl = PagedGenerationEngine(model, **kw)
    q8 = PagedGenerationEngine(model, weight_dtype="int8", **kw)
    for s, p in enumerate(prompts):
        q8.prefill(s, p)
        q8.set_slot_token(s, fl.prefill(s, p))
    matches, kls, t_fl, t_q8, flips = [], [], [], [], []
    dropped = 0
    for step in range(steps):
        t0 = time.perf_counter()
        toks = fl.decode()
        t_fl.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        q8.decode()
        t_q8.append(time.perf_counter() - t0)
        lo = fl.last_logits.astype(np.float64)
        lq = q8.last_logits.astype(np.float64)
        gaps = top2_gaps(lo)
        keep = gaps >= GAP_MIN
        dropped += int((~keep).sum())
        ao, aq = lo.argmax(-1), lq.argmax(-1)
        matches.extend((ao == aq)[keep].tolist())
        # each counted flip: the float gap, and how far below its own best
        # the int8 engine rates the float engine's pick
        flips.extend({"step": step, "slot": s, "float_gap": float(gaps[s]),
                      "int8_deficit": float(lq[s, aq[s]] - lq[s, ao[s]])}
                     for s in range(len(prompts))
                     if keep[s] and ao[s] != aq[s])
        po = np.exp(lo - lo.max(-1, keepdims=True))
        po /= po.sum(-1, keepdims=True)
        zq = lq - lq.max(-1, keepdims=True)
        log_q = zq - np.log(np.exp(zq).sum(-1, keepdims=True))
        kls.extend((po * (np.log(po + 1e-30) - log_q)).sum(-1).tolist())
        for s in range(len(prompts)):
            q8.set_slot_token(s, int(toks[s]))
    match, kl = float(np.mean(matches)), float(np.mean(kls))
    n_q = sum(1 for v in q8._decode_params.values() if isinstance(v, dict))
    n_w = sum(v["q"].numel() for v in q8._decode_params.values()
              if isinstance(v, dict))
    dequant_ms = time_ms(lambda: q8._dequant_params(q8._decode_params),
                         lambda: None, iters=10)
    # the dequant's least time: read each int8 code and f32 scale once,
    # write each f32 weight once
    dequant_bound = n_w * (1 + 4) / device_peaks("f32").hbm_bw * 1e3
    rec = {"slots": len(prompts), "steps": steps, "greedy_match": match,
           "compared": len(matches), "dropped_near_ties": dropped,
           "flips": flips,
           "logit_kl": kl, "gate": {"match": QUANT_MATCH, "kl": QUANT_KL},
           "decode_step_ms_float": 1e3 * sum(t_fl) / steps,
           "decode_step_ms_int8": 1e3 * sum(t_q8) / steps,
           "quantized_tensors": n_q, "quantized_weights": n_w,
           "dequant_ms": dequant_ms, "dequant_bound_ms": dequant_bound,
           "card": smi}
    log(f"int8 decode weights vs float (teacher-forced, {len(prompts)} "
        f"slots x {steps} steps): greedy match {match:.4f} over "
        f"{len(matches)} decisions ({dropped} near-ties < {GAP_MIN} "
        f"dropped; flips {flips}), mean KL {kl:.3e}; decode step "
        f"{rec['decode_step_ms_float']:.3f} ms float, "
        f"{rec['decode_step_ms_int8']:.3f} ms int8 weights; per-forward "
        f"dequant of {n_q} tensors ({n_w} weights) {dequant_ms:.4f} ms "
        f"device (bound {dequant_bound:.4f}) [{smi}]")
    if not (match >= QUANT_MATCH and kl < QUANT_KL):
        raise AssertionError(f"phase 11: int8 weights fail the quality "
                             f"gate (match {match}, KL {kl})")
    del fl, q8
    torch.cuda.empty_cache()
    return rec


def spec_int8_agreement(model, prompts, smi, n=8):
    """Phase 11: speculative decode with int8 weights and KV against the
    one-token int8 engine over the first n tokens of each request."""
    from paddle_tpu_torch.serving import (PagedGenerationEngine,
                                          SpeculativeEngine)
    kw = dict(weight_dtype="int8", kv_dtype="int8", device=model.device)
    spec, _, _ = serve(SpeculativeEngine(model, **SPEC, **kw), prompts, n)
    one, _, _ = serve(PagedGenerationEngine(
        model, slots=8, max_len=1024, block_size=16,
        attention_impl="kernel", **kw), prompts, n)
    same = [a == b for hs, ho in zip(spec, one)
            for a, b in zip(hs.tokens, ho.tokens)]
    agree = sum(same) / len(same)
    log(f"speculative x int8 weights and KV vs one-token int8: "
        f"{len(prompts)} requests, agreement {agree:.4f} over the first "
        f"{n} tokens (bar {SPEC_AGREE}) [{smi}]")
    if agree < SPEC_AGREE:
        raise AssertionError(f"phase 11: spec x int8 agrees {agree}")
    return {"requests": len(prompts), "tokens": n, "agreement": agree}


def hot_swap(model, prompts, want, smi):
    """Phase 11: phase 10's serving again, with a swap to a cloned param
    dict before step 3 and a swap with one wrong-shaped tensor before
    step 6: every stream must equal phase 10's, the first swap apply and
    the second be refused."""
    import torch
    from paddle_tpu_torch.serving import Scheduler, SpeculativeEngine
    eng = SpeculativeEngine(model, device=model.device, **SPEC)
    sched = Scheduler(eng, max_queue=64, device=model.device)
    handles = [sched.submit(p, max_new_tokens=32) for p in prompts]
    clone = {k: v.detach().clone() for k, v in eng._params.items()}
    bad = dict(clone)
    bad["blocks.0.attn.qkv.weight"] = torch.zeros((3, 3),
                                                  device=model.device)
    plan = {3: (clone, 1), 6: (bad, 2)}
    events = []
    failures = decode_failures()
    while True:
        if sched._steps in plan:
            events.append(sched.schedule_weight_swap(*plan[sched._steps]))
        if not sched.step():
            break
    results = [ev.swap_result for ev in events]
    if decode_failures() != failures:
        raise AssertionError("phase 11: a decode failure was contained")
    if [r["ok"] for r in results] != [True, False] or \
            sched.model_version != 1:
        raise AssertionError(f"phase 11: swap results {results}")
    counts = check_captures(eng, "phase 11 swap", every=False)
    if counts.get("spec_verify") != 1:
        raise AssertionError(f"phase 11: capture counts {counts}")
    inflight = results[0]["inflight"]
    for h, w in zip(handles, want):
        if h.status != "DONE" or h.tokens != w.tokens:
            raise AssertionError(
                f"phase 11: request {h.request_id} changed under the "
                f"swaps: {h.tokens} != {w.tokens}")
    log(f"hot-swap during speculative serving: clone applied with "
        f"{inflight} requests in flight ({results[0]['params']} tensors), "
        f"wrong shape refused ({results[1]['error'][:60]}...), "
        f"{len(prompts)} streams unchanged, capture counts {counts} "
        f"[{smi}]")
    return {"results": results, "streams_unchanged": len(prompts),
            "capture_counts": counts}


# ------------------------------------------------------------- KV handoff
def handoff_streams(model, prompts, kv_dtype, steps, smi):
    """Phase 12 for one pool type: A prefills, every request's KV crosses
    the wire to B, B decodes; B's streams against a local engine's.
    Returns (record, engine A)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.serving import PagedGenerationEngine
    from paddle_tpu_torch.serving.distributed import kv_handoff as kvh
    kw = dict(slots=len(prompts), max_len=1024, block_size=16,
              attention_impl="kernel", kv_dtype=kv_dtype,
              device=model.device)
    a = PagedGenerationEngine(model, **kw)
    b = PagedGenerationEngine(model, **kw)
    capture_s = precompile(b, f"phase 12 {kv_dtype}")
    steps_ms = {"extract": [], "pack": [], "unpack": [], "adopt": []}
    nbytes, firsts = [], []

    def clock(what, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps_ms[what].append((time.perf_counter() - t0) * 1e3)
        return out
    for s, p in enumerate(prompts):
        first = a.prefill(s, p)
        firsts.append(first)
        wire = clock("extract", lambda: a.extract_kv_wire(s))
        quant = {k: wire[k] for k in ("k_scales", "v_scales",
                                      "scale_block") if k in wire}
        bundle = clock("pack", lambda: kvh.pack_kv_bundle(
            wire["ks"], wire["vs"], meta={"plen": wire["plen"],
                                          "first_token": first}, **quant))
        nbytes.append(len(bundle))
        ks, vs, meta = clock("unpack", lambda: kvh.unpack_kv_bundle(bundle))
        clock("adopt", lambda: b.adopt_kv(s, ks, vs, meta["plen"],
                                          meta["first_token"]))
        if not b.last_prefill_stats.get("adopted"):
            raise AssertionError("phase 12: adopt_kv did not adopt")
    got = [[f] for f in firsts]
    for _ in range(steps):
        out = b.decode()
        for s in range(len(prompts)):
            got[s].append(int(out[s]))
    counts = check_captures(b, f"phase 12 {kv_dtype}")
    compared, dropped = stream_parity(model, prompts, got, kw, steps,
                                      f"phase 12 {kv_dtype}")
    longest = int(np.argmax([len(p) for p in prompts]))
    rec = {"kv_dtype": kv_dtype, "requests": len(prompts),
           "tokens": [len(p) for p in prompts], "bundle_bytes": nbytes,
           "ms": steps_ms,
           "ms_mean": {k: sum(v) / len(v) for k, v in steps_ms.items()},
           "longest": {"tokens": len(prompts[longest]),
                       "bytes": nbytes[longest],
                       **{k: v[longest] for k, v in steps_ms.items()}},
           "compared_tokens": compared, "dropped_near_ties": dropped,
           "capture_s": capture_s, "capture_counts": counts, "card": smi}
    lg = rec["longest"]
    log(f"handoff {kv_dtype} pools ({len(prompts)} requests of "
        f"{min(rec['tokens'])}-{max(rec['tokens'])} tokens): streams agree "
        f"on {compared} tokens ({dropped} dropped by the top-2 gap < "
        f"{GAP_MIN} rule); the {lg['tokens']}-token bundle "
        f"{lg['bytes']} bytes, extract {lg['extract']:.2f} ms, pack "
        f"{lg['pack']:.2f}, unpack {lg['unpack']:.2f}, adopt "
        f"{lg['adopt']:.2f}; mean "
        + ", ".join(f"{k} {v:.2f}" for k, v in rec["ms_mean"].items())
        + f" ms; capture counts {counts} [{smi}]")
    del b
    return rec, a


def stream_parity(model, prompts, got, kw, steps, what, slots=None,
                  setup=None):
    """Greedy streams `got` (first token + `steps` decodes per slot)
    against a local engine's, a slot's comparison stopping at the first
    step whose local top-2 gap is below GAP_MIN (`setup(local)` runs
    before its prefills). Returns (compared, dropped)."""
    from paddle_tpu_torch.serving import PagedGenerationEngine
    local = PagedGenerationEngine(model, capture_logits=True, **kw)
    if setup is not None:
        setup(local)
    gaps = [[] for _ in prompts]
    sel = local._select

    def cap_select(logits, slot):
        gaps[slot].append(float(top2_gaps(logits.float().cpu())[0]))
        return sel(logits, slot)
    local._select = cap_select
    want = [[local.prefill(s, p)] for s, p in enumerate(prompts)]
    for _ in range(steps):
        out = local.decode()
        g = top2_gaps(local.last_logits)
        for s in range(len(prompts)):
            gaps[s].append(float(g[s]))
            want[s].append(int(out[s]))
    compared = dropped = 0
    for s in (range(len(prompts)) if slots is None else slots):
        row = got[s if slots is None else slots.index(s)]
        for t in range(len(row)):
            if gaps[s][t] < GAP_MIN:
                dropped += len(row) - t
                break
            if row[t] != want[s][t]:
                raise AssertionError(
                    f"{what}: slot {s} token {t}: {row[t]} != local "
                    f"{want[s][t]} (gap {gaps[s][t]:.3e})")
            compared += 1
    check_captures(local, what + " local", every=False)
    return compared, dropped


def handoff(model, prompts, smi, steps=8):
    """Phase 12: the KV handoff on the card, float32 and int8 pools, then
    a prefix restore of the prompts' shared 256 tokens."""
    import torch
    from paddle_tpu_torch.serving import PagedGenerationEngine
    out = {}
    out["float32"], a = handoff_streams(model, prompts, "float32", steps,
                                        smi)
    kw = dict(slots=len(prompts), max_len=1024, block_size=16,
              attention_impl="kernel", device=model.device)
    ks, vs, n = a.extract_prefix_kv(prompts[1])
    if n < 256:
        raise AssertionError(f"phase 12: A's cached chain covers {n} tokens")
    del a
    r = PagedGenerationEngine(model, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = r.restore_prefix(prompts[1], [k[:256] for k in ks],
                                [v[:256] for v in vs], 256)
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t0) * 1e3
    first = r.prefill(2, prompts[2])
    hit = r.last_prefill_stats["prefix_hit_tokens"]
    if restored != 256 or hit != 256:
        raise AssertionError(f"phase 12: restored {restored} tokens, the "
                             f"next prefill hit {hit}; want 256 and 256")
    row = [first] + [int(r.decode()[2]) for _ in range(steps)]
    compared, dropped = stream_parity(model, prompts[:3], [row], kw, steps,
                                      "phase 12 restore", slots=[2])
    out["restore"] = {"tokens": restored, "prefix_hit_tokens": hit,
                      "restore_ms": restore_ms, "compared_tokens": compared,
                      "dropped_near_ties": dropped,
                      "capture_counts": check_captures(
                          r, "phase 12 restore", every=False)}
    log(f"prefix restore: 256 shared tokens restored in {restore_ms:.2f} "
        f"ms, the next prefill hit {hit} tokens, its stream agrees on "
        f"{compared} tokens ({dropped} dropped) [{smi}]")
    del r
    out["int8"], a = handoff_streams(model, prompts, "int8", steps, smi)
    del a
    torch.cuda.empty_cache()
    return out


# -------------------------------------------------------- SLO machinery
def slo_host_costs(path, n=20000):
    """Phase 13: the host µs of each piece of the SLO machinery, apart
    from the card: one call each of a disarmed fault site, a closed
    `RecordEvent` span with attrs, a counter inc, a histogram observe and
    a gauge set (a private registry), and one serving-JSONL step record
    (dumps, write, flush) in the directory of `path`. The whole step with
    the decode replaced is `sched_host_cost.py`'s."""
    from paddle_tpu_torch.observability import faults, metrics
    from paddle_tpu_torch.profiler import RecordEvent, TracerEventType

    def per_call(fn, k=n):
        fn()
        t0 = time.perf_counter()
        for _ in range(k):
            fn()
        return (time.perf_counter() - t0) / k * 1e6
    reg = metrics.MetricsRegistry()
    child = reg.counter("c_total", labelnames=("tenant",)).labels(tenant="a")
    hist, gauge = reg.histogram("h_seconds"), reg.gauge("g")
    attrs = {"slots": 8, "paged": True, "kv_dtype": "float32",
             "attend": "kernel"}

    def span():
        with RecordEvent("serving::decode_step",
                         TracerEventType.UserDefined, attrs):
            pass
    rec = {"kind": "step", "step": 1, "t": 1.0, "queue_depth": 0,
           "active_slots": 8, "tokens_generated": 100}
    jpath = path + ".cost"
    with open(jpath, "w") as f:
        def line():
            f.write(json.dumps(rec) + "\n")
            f.flush()
        out = {"fault_site": per_call(
                   lambda: faults.fire("serving.decode_step")),
               "span": per_call(span),
               "counter_inc": per_call(lambda: child.inc(8)),
               "histogram_observe": per_call(lambda: hist.observe(0.0018)),
               "gauge_set": per_call(lambda: gauge.set(3)),
               "jsonl_step_record": per_call(line, 2000)}
    os.remove(jpath)
    return out


SLO_ENGINE = dict(slots=8, max_len=1024, block_size=16,
                  attention_impl="kernel")


def next_token_gap(model, tokens):
    """Top-2 logit gap of the next token after `tokens` (a one-slot
    prefill on the kernel path): the near-tie test of a stream mismatch."""
    from paddle_tpu_torch.serving import PagedGenerationEngine
    eng = PagedGenerationEngine(model, device=model.device,
                                **dict(SLO_ENGINE, slots=1))
    seen = []
    sel = eng._select

    def cap(logits, slot):
        seen.append(float(top2_gaps(logits.float().cpu())[0]))
        return sel(logits, slot)
    eng._select = cap
    eng.prefill(0, tokens)
    return seen[0]


def same_stream(model, prompt, got, want, what):
    """`got` against phase 4's `want` over their common length, under the
    near-tie rule: a mismatch ends the comparison if the next token's
    top-2 gap after the agreed tokens is below GAP_MIN, else fails.
    Returns (compared, dropped)."""
    n = min(len(got), len(want))
    for t in range(n):
        if got[t] != want[t]:
            gap = next_token_gap(model, list(prompt) + list(want[:t]))
            if gap < GAP_MIN:
                return t, n - t
            raise AssertionError(f"{what}: token {t}: {got[t]} != phase "
                                 f"4's {want[t]} (gap {gap:.3e})")
    return n, 0


def slo_serving(model, prompts, want, smi):
    """Phase 13: phase 4's server under its SLO machinery and chaos.
    `want`: phase 4's token streams."""
    import torch
    from paddle_tpu_torch.observability import decisions, faults, metrics
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import (LoadShedError,
                                          PagedGenerationEngine, Scheduler,
                                          ServingConfig)
    from paddle_tpu_torch.serving.distributed import kv_handoff as kvh
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "phase13_serve.jsonl")
    snap_path = os.path.join(out_dir, "phase13_metrics.jsonl")
    for f in (path, snap_path):
        if os.path.exists(f):
            os.remove(f)
    reg = metrics.registry()
    failures0 = decode_failures()
    corrupt = reg.counter("serving_kv_tier_corrupt_total")
    corrupt0 = corrupt.value
    eng = PagedGenerationEngine(model, device=model.device, **SLO_ENGINE)
    capture_s = precompile(eng, "phase 13")
    compared = dropped = 0

    def hold(h, i, what, n=None):
        nonlocal compared, dropped
        got = h.tokens if n is None else h.tokens[:n]
        c, d = same_stream(model, prompts[i], got, want[i], what)
        compared += c
        dropped += d

    def idle_pool():
        eng.prefix_cache.evict(eng.block_pool.capacity)
        if eng.block_pool.in_use:
            raise AssertionError(f"phase 13: {eng.block_pool.in_use} "
                                 "blocks leaked")

    # normal traffic: the step on the host clock without and with the
    # serving JSONL, and with the registry switched off
    timing = {}
    pa.launches = pa.launches_window = pa.launches_prefill = 0
    for label, cfg in 2 * (("no_jsonl", ServingConfig(max_queue=64)),
                           ("jsonl", ServingConfig(max_queue=64,
                                                   metrics_path=path)),
                           ("registry_off", ServingConfig(max_queue=64))):
        if label == "registry_off":
            reg.disable()
        try:
            hs, m, wall = serve(eng, prompts, 32, cfg)
        finally:
            reg.enable()
        for i, h in enumerate(hs):
            hold(h, i, f"phase 13 {label} request {i}")
        timing.setdefault(label, []).append(
            {"decode_step_ms": m["decode_step_ms"],
             "decode_only_tok_s": decode_only_tok_s(m),
             "decode_tokens_per_s": m["decode_tokens_per_s"],
             "decode_steps": m["decode_steps"],
             "sched_host_us": m["sched_host_us"], "wall_s": wall})
        idle_pool()
    launches = {"decode": pa.launches - pa.launches_prefill,
                "prefill": pa.launches_prefill,
                "window": pa.launches_window}
    if not launches["decode"] or not launches["prefill"] or \
            launches["window"]:
        raise AssertionError(f"phase 13: paged launches {launches}")

    # chaos, on one scheduler writing the serving JSONL
    sched = Scheduler(eng, ServingConfig(max_queue=64, metrics_path=path,
                                         shed_watermark=4),
                      device=model.device)
    # shedding: six standard requests deepen the queue past the watermark,
    # six batch requests are shed, two interactive ones still admitted
    std = {i: sched.submit(prompts[i], max_new_tokens=32)
           for i in (0, 1, 2, 3, 5, 7)}
    shed = []
    for i in range(8, 14):
        try:
            sched.submit(prompts[i], max_new_tokens=32, priority="batch")
        except LoadShedError:
            shed.append(i)
    if len(shed) < 2:
        raise AssertionError(f"phase 13: {len(shed)} batch requests shed")
    inter = sched.submit(prompts[4], max_new_tokens=32,
                         priority="interactive")
    # a running request whose deadline passes mid-decode
    late = sched.submit(prompts[15], max_new_tokens=300,
                        priority="interactive", timeout_s=0.25)
    sched.step()
    if sched.active_slots() != 8:
        raise AssertionError(f"phase 13: {sched.active_slots()} slots busy")
    # deadlines that pass while every slot is busy
    expired = [sched.submit(prompts[i], max_new_tokens=8, timeout_s=1e-3)
               for i in (6, 9)]
    for _ in range(5):
        sched.step()
    # a cancelled running request: its blocks go back at once
    in_use = eng.block_pool.in_use
    if not sched.cancel(std[7]):
        raise AssertionError("phase 13: the cancel found nothing to cancel")
    freed = in_use - eng.block_pool.in_use
    sched.run_until_idle()
    if [h.status for h in expired] != ["TIMEOUT"] * 2 or \
            any(h.tokens for h in expired):
        raise AssertionError(f"phase 13: queued deadlines "
                             f"{[(h.status, h.tokens) for h in expired]}")
    if late.status != "TIMEOUT" or not 0 < len(late.tokens) < 300:
        raise AssertionError(f"phase 13: running deadline {late.status} "
                             f"with {len(late.tokens)} tokens")
    if std[7].status != "SHED" or not std[7].tokens or freed < 1:
        raise AssertionError(f"phase 13: cancel left {std[7].status}, "
                             f"{len(std[7].tokens)} tokens, {freed} blocks "
                             "freed")
    for i, h in list(std.items()) + [(4, inter)]:
        if i != 7 and h.status != "DONE":
            raise AssertionError(f"phase 13: request {i} {h.status}")
        hold(h, i, f"phase 13 request {i}")
    hold(late, 15, "phase 13 running deadline", n=32)
    idle_pool()

    # a decode-step fault: exactly the requests in flight fail, one probe
    # slot refills, then every slot
    first = [sched.submit(prompts[i], max_new_tokens=32)
             for i in range(8, 16)]
    for _ in range(4):
        sched.step()
    inflight = {h.request_id for h in first if h.status == "RUNNING"}
    faults.arm("serving.decode_step", "raise", max_fires=1)
    sched.step()
    faults.disarm("serving.decode_step")
    errored = {h.request_id for h in first if h.status == "ERROR"}
    if errored != inflight or len(inflight) != 8:
        raise AssertionError(f"phase 13: {len(errored)} errored, "
                             f"{len(inflight)} were in flight")
    for i, h in zip(range(8, 16), first):
        hold(h, i, f"phase 13 partial stream {i}")
    after = [sched.submit(prompts[i], max_new_tokens=32)
             for i in range(8, 16)]
    sched.step()
    probe = sched.active_slots()
    sched.step()
    refill = sched.active_slots()
    if probe != 1 or refill != 8:
        raise AssertionError(f"phase 13: {probe} probe slots, then "
                             f"{refill} after a healthy step")
    sched.run_until_idle()
    for i, h in zip(range(8, 16), after):
        if h.status != "DONE":
            raise AssertionError(f"phase 13: request {i} {h.status} after "
                                 "the fault")
        hold(h, i, f"phase 13 after the fault, request {i}")
    idle_pool()

    # a swap the fault site refuses while eight requests decode
    hs = [sched.submit(prompts[i], max_new_tokens=32) for i in range(8)]
    for _ in range(3):
        sched.step()
    faults.arm("serving.weight_swap", "raise", max_fires=1)
    ev = sched.schedule_weight_swap(
        {k: v.detach().clone() for k, v in eng._params.items()}, version=7)
    sched.step()
    faults.disarm("serving.weight_swap")
    if not ev.is_set() or sched.last_swap["ok"] or \
            sched.model_version is not None:
        raise AssertionError(f"phase 13: swap result {sched.last_swap}")
    sched.run_until_idle()
    for i, h in enumerate(hs):
        hold(h, i, f"phase 13 across the failed swap, request {i}")
    idle_pool()

    # a handoff refused at pack time falls back to a local prefill beside
    # one that crosses the wire; a restore refused restores nothing
    src = PagedGenerationEngine(model, device=model.device, **SLO_ENGINE)
    staged = []
    for s, i in enumerate((9, 10)):
        firsts = src.prefill(s, prompts[i])
        wire = src.extract_kv_wire(s)
        if i == 9:
            faults.arm("serving.kv_handoff", "raise", max_fires=1)
        try:
            ks, vs, meta = kvh.unpack_kv_bundle(kvh.pack_kv_bundle(
                wire["ks"], wire["vs"], meta={"plen": wire["plen"],
                                              "first": firsts}))
            staged.append((ks, vs, meta["plen"], meta["first"]))
        except faults.FaultInjected:
            staged.append(None)
        faults.disarm("serving.kv_handoff")
    pks, pvs, pn = src.extract_prefix_kv(prompts[11])
    del src
    if staged[0] is not None or staged[1] is None or pn < 256:
        raise AssertionError("phase 13: the handoff fault did not refuse "
                             "the first bundle alone")
    refused = sched.submit(prompts[9], max_new_tokens=32, staged_kv=None)
    adopted = sched.submit(prompts[10], max_new_tokens=32,
                           staged_kv=staged[1])
    faults.arm("serving.kv_restore", "raise", max_fires=1)
    restore = sched.submit(prompts[11], max_new_tokens=32,
                           staged_prefix=([k[:256] for k in pks],
                                          [v[:256] for v in pvs], 256,
                                          None))
    sched.run_until_idle()
    faults.disarm("serving.kv_restore")
    if not adopted.adopted or refused.adopted or \
            restore.kv_restored_tokens != 0 or \
            corrupt.value != corrupt0 + 1:
        raise AssertionError(
            f"phase 13: adopted {adopted.adopted}, refused bundle adopted "
            f"{refused.adopted}, restored {restore.kv_restored_tokens}, "
            f"corrupt +{corrupt.value - corrupt0}")
    for i, h in ((9, refused), (10, adopted), (11, restore)):
        if h.status != "DONE":
            raise AssertionError(f"phase 13: request {i} {h.status}")
        hold(h, i, f"phase 13 handoff/restore request {i}")
    sched.close()
    idle_pool()
    counts = check_captures(eng, "phase 13")
    injected = decode_failures() - failures0
    if injected != 1:
        raise AssertionError(f"phase 13: serving_decode_failures_total "
                             f"moved by {injected}, 1 fault injected")
    statuses = {}
    for h in list(std.values()) + [inter, late] + expired + first + \
            after + hs + [refused, adopted, restore]:
        if not h.done():
            raise AssertionError(f"phase 13: request {h.request_id} "
                                 f"{h.status}")
        statuses[h.status] = statuses.get(h.status, 0) + 1
    statuses["SHED"] = statuses.get("SHED", 0) + len(shed)

    # the records: decisions replay, timelines sum, the snapshot validates
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    decs = [r for r in recs if r["kind"] == "decision"]
    errs = decisions.validate_records(decs)
    actions = {r["action"] for r in decs}
    if errs or not {"admit", "shed", "quarantine", "swap"} <= actions:
        raise AssertionError(f"phase 13: decisions {sorted(actions)}, "
                             f"errors {errs[:3]}")
    timelines = [r for r in recs if r["kind"] == "timeline"]
    for r in timelines:
        total = sum(p["dur_s"] for p in r["phases"])
        if abs(total - r["e2e_s"]) > 1e-6 * (len(r["phases"]) + 1):
            raise AssertionError(f"phase 13: timeline phases sum to "
                                 f"{total}, e2e_s {r['e2e_s']}")
    reg.write_snapshot(snap_path)
    rc = subprocess.run([sys.executable,
                         os.path.join(ROOT, "tools", "metrics_report.py"),
                         snap_path], capture_output=True, text=True,
                        timeout=120)
    if rc.returncode:
        raise AssertionError(f"phase 13: metrics_report.py refused the "
                             f"snapshot: {rc.stderr[-500:]}")

    # int8 KV: the kv_quant truncate scales one block in place, and the
    # next replayed decode reads it
    kw = dict(SLO_ENGINE, kv_dtype="int8", capture_logits=True)
    e8, twin = (PagedGenerationEngine(model, device=model.device, **kw)
                for _ in range(2))
    for e in (e8, twin):
        precompile(e, "phase 13 int8")
        e.prefill(0, prompts[3])
        e.prefill(1, prompts[8])
        e.decode()
    layer, tlayer = e8._pool[0], twin._pool[0]
    ptrs = (layer.k_scale.data_ptr(), layer.v_scale.data_ptr())
    victim = next(b for b in range(1, e8.block_pool.num_blocks)
                  if e8.block_pool.refcount(b) > 0)
    faults.arm("serving.kv_quant", "truncate", max_fires=1)
    e8.decode()
    faults.disarm("serving.kv_quant")
    twin.decode()
    torch.cuda.synchronize()
    vslot = next(s for s in range(2) if victim in e8._tables[s])
    scaled = all(torch.equal(getattr(layer, n)[victim],
                             getattr(tlayer, n)[victim] * 64.0)
                 for n in ("k_scale", "v_scale"))
    moved = float(abs(e8.last_logits[vslot]
                      - twin.last_logits[vslot]).max())
    if not scaled or ptrs != (layer.k_scale.data_ptr(),
                              layer.v_scale.data_ptr()) or moved == 0.0:
        raise AssertionError(f"phase 13: kv_quant scaled {scaled}, "
                             f"logits moved {moved}")
    int8_counts = check_captures(e8, "phase 13 int8")
    del e8, twin
    costs = slo_host_costs(path)

    rec = {"capture_s": capture_s, "timing": timing, "launches": launches,
           "shed": len(shed), "cancel_freed_blocks": freed,
           "running_deadline_tokens": len(late.tokens),
           "decode_failures": injected, "statuses": statuses,
           "decisions": {a: sum(r["action"] == a for r in decs)
                         for a in sorted(actions)},
           "timelines": len(timelines), "compared_tokens": compared,
           "dropped_near_ties": dropped, "kv_quant_victim": victim,
           "kv_quant_logit_move": moved, "capture_counts": counts,
           "int8_capture_counts": int8_counts, "host_costs": costs,
           "card": smi}
    for label, runs in timing.items():
        log(f"slo serving, {label}: decode step "
            + " / ".join(f"{r['decode_step_ms']:.3f}" for r in runs)
            + " ms; scheduler host time a step outside decode, median "
            + " / ".join(f"{r['sched_host_us']['median_us']:.1f}"
                         for r in runs) + " us [" + smi + "]")
    log("slo host costs, us a call: " + ", ".join(
        f"{k} {v:.2f}" for k, v in costs.items()) + f" [{smi}]")
    log(f"slo chaos: statuses {statuses}, {len(shed)} shed, decode "
        f"failures {injected} (1 injected), decisions {rec['decisions']}, "
        f"{len(timelines)} timelines summing to e2e, {compared} tokens "
        f"held to phase 4 ({dropped} dropped by the near-tie rule), "
        f"kv_quant moved the victim's logits by {moved:.3e}, capture "
        f"counts {counts} [{smi}]")
    return rec


# ---------------------------------------------------------------- the fleet
# phase 14's workers: phase 4's engine configuration, one process each
FLEET_ENGINE = dict(slots=8, max_len=1024, block_size=16,
                    attention_impl="kernel")
FLEET_MODEL, FLEET_DEVICE = "gpt_125m", "cuda"
FLEET_START_S = 300         # spawn -> every endpoint published, captures in
FLEET_WAVE_S = 180          # submit -> every request of a wave terminal


class FleetWorker:
    """One `worker_main` process of phase 14 (spawned, never forked: the
    smoke process has touched CUDA). Its output goes to
    `<work>/<role><index>.log`, whose `worker_main exit:` line carries its
    capture counts and kernel launches."""

    def __init__(self, role, index, ckpt, work, max_new):
        self.role, self.name = role, f"{role}{index}"
        self.ep_file = os.path.join(work, f"{self.name}.ep")
        self.log_path = os.path.join(work, f"{self.name}.log")
        env = {k: v for k, v in os.environ.items()
               if k not in ("PTN_FAULTS", "PTN_TRACE_EXPORT_DIR")}
        env["PYTHONPATH"] = os.pathsep.join(
            [ROOT] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        self._log = open(self.log_path, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m",
             "paddle_tpu_torch.serving.distributed.worker_main",
             "--role", role, "--engine", "paged", "--model", FLEET_MODEL,
             "--device", FLEET_DEVICE, "--ckpt", ckpt, "--index", str(index),
             "--engine-config", json.dumps(FLEET_ENGINE),
             "--serving-config", json.dumps(
                 {"max_queue": 64, "default_max_new_tokens": max_new}),
             "--endpoint-file", self.ep_file],
            cwd=ROOT, env=env, stdout=self._log, stderr=subprocess.STDOUT)
        self.endpoint = None
        self.start_s = None

    def log_tail(self, n=3000):
        with open(self.log_path) as f:
            return f.read()[-n:]

    def poll_endpoint(self):
        """The published endpoint, or None while the worker starts; a
        worker that exits first fails the phase."""
        if self.endpoint is None and os.path.exists(self.ep_file):
            with open(self.ep_file) as f:
                self.endpoint = f.read().strip()
            self.start_s = time.perf_counter() - self.t0
        if self.endpoint is None and self.proc.poll() is not None:
            raise AssertionError(
                f"phase 14: worker {self.name} exited "
                f"{self.proc.returncode} before publishing its endpoint:\n"
                f"{self.log_tail()}")
        return self.endpoint

    def exit_info(self):
        with open(self.log_path) as f:
            lines = [ln for ln in f.read().splitlines()
                     if ln.startswith("worker_main exit: ")]
        return json.loads(lines[-1][len("worker_main exit: "):]) \
            if lines else None

    def close(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait(timeout=60)
        self._log.close()


def gpu_apps():
    """The card's compute processes as nvidia-smi lists them: [{"pid",
    "used_memory"}] (its pids are the host's, which may not be this
    container's)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    rows = []
    for line in out[1:]:
        pid, _, mem = line.partition(",")
        rows.append({"pid": pid.strip(), "used_memory": mem.strip()})
    return rows


def fleet_serving(model, prompts, want, smi):
    """Phase 14: phase 4's requests through the serving fleet, one prefill
    and two decode worker processes on this card, behind a `DistFrontend`
    in this process; then federation, a SIGKILL failover and a fleet
    swap. `want`: phase 4's token streams."""
    import shutil
    from paddle_tpu_torch.distributed.checkpoint import save_state_dict
    from paddle_tpu_torch.observability import fleet, metrics
    from paddle_tpu_torch.serving import PagedEngineConfig
    from paddle_tpu_torch.serving.distributed import DistFrontend
    max_new = 32
    work = os.path.join(ROOT, "chiprun_out", "phase14")
    ckpt_root = os.path.join(ROOT, "build", "phase14_ckpt")
    shutil.rmtree(work, ignore_errors=True)
    shutil.rmtree(ckpt_root, ignore_errors=True)
    os.makedirs(work)
    ckpt = os.path.join(ckpt_root, "gpt125m")
    t0 = time.perf_counter()
    save_state_dict(model.state_dict(), ckpt)
    save_s = time.perf_counter() - t0
    names = {"decode"} | {f"prefill[{b}]" for b in
                          PagedEngineConfig(**FLEET_ENGINE).prefill_buckets}
    failovers = metrics.registry().counter("serving_failover_total")
    rec = {"engine": FLEET_ENGINE, "ckpt_save_s": save_s, "card": smi}
    compared = dropped = 0
    workers, fe = [], None
    try:
        t0 = time.perf_counter()
        workers = [FleetWorker("prefill", 0, ckpt, work, max_new),
                   FleetWorker("decode", 0, ckpt, work, max_new),
                   FleetWorker("decode", 1, ckpt, work, max_new)]
        while not all([w.poll_endpoint() for w in workers]):
            if time.perf_counter() - t0 > FLEET_START_S:
                raise AssertionError(
                    f"phase 14: workers not up in {FLEET_START_S} s: "
                    + "; ".join(f"{w.name}: {w.log_tail(500)}"
                                for w in workers))
            time.sleep(0.05)
        rec["start_s"] = {w.name: w.start_s for w in workers}
        rec["start_all_s"] = time.perf_counter() - t0
        pre, dec = workers[0], workers[1:]
        fe = DistFrontend([w.endpoint for w in dec], [pre.endpoint])
        pump_s = []

        def pump():
            t = time.perf_counter()
            n = fe.pump()
            pump_s.append(time.perf_counter() - t)
            return n

        def wave(idx, label, until=None, n=max_new):
            """Submit prompts[idx] for `n` tokens each (a pump after each
            submit), pump until `until(reqs)` (default: every request
            terminal); returns (requests, seconds)."""
            t = time.perf_counter()
            reqs = []
            for i in idx:
                reqs.append(fe.submit(prompts[i], max_new=n))
                pump()
            cond = until or (lambda rs: all(r.done() for r in rs))
            while not cond(reqs):
                if time.perf_counter() - t > FLEET_WAVE_S:
                    raise AssertionError(
                        f"phase 14 {label}: not done in {FLEET_WAVE_S} s: "
                        + ", ".join(f"{r.status}/{len(r.tokens)}"
                                    for r in reqs))
                pump()
                time.sleep(0.001)
            return reqs, time.perf_counter() - t

        def finish(reqs, label):
            t = time.perf_counter()
            while pump():
                if time.perf_counter() - t > FLEET_WAVE_S:
                    raise AssertionError(f"phase 14 {label}: not done")
                time.sleep(0.001)

        def hold(reqs, idx, label, ref=None):
            """Every request DONE with its tokens, held to phase 4's
            stream (its first 32 tokens) and to `ref`'s, the same wave's
            requests in an undisturbed run, under the near-tie rule."""
            nonlocal compared, dropped
            for j, (r, i) in enumerate(zip(reqs, idx)):
                if r.status != "DONE" or len(r.tokens) != r.max_new:
                    raise AssertionError(
                        f"phase 14 {label} request {i}: {r.status} with "
                        f"{len(r.tokens)} tokens ({r.error})")
                for other in [want[i]] + ([ref[j].tokens] if ref else []):
                    c, d = same_stream(model, prompts[i], r.tokens, other,
                                       f"phase 14 {label} request {i}")
                    compared += c
                    dropped += d

        # disaggregated serving: phase 4's 16 requests
        idx1 = list(range(len(prompts)))
        reqs1, wall1 = wave(idx1, "serving")
        hold(reqs1, idx1, "serving")
        if not all(r.staged for r in reqs1):
            raise AssertionError("phase 14: a request fell back to a local "
                                 "prefill: " + str([r.staged for r in reqs1]))
        ttfts = [r.ttft_s for r in reqs1]
        phases = {}
        for tl in fe.timeline_records():
            for seg in tl["phases"]:
                phases.setdefault(seg["phase"], []).append(seg["dur_s"])
        stats = fe.stats()
        for w in workers:
            st = stats[w.endpoint]
            if set(st["trace_counts"]) != names or \
                    set(st["trace_counts"].values()) != {1}:
                raise AssertionError(f"phase 14: {w.name} capture counts "
                                     f"{st['trace_counts']}")
            if st["kernel_launches"] <= 0:
                raise AssertionError(f"phase 14: {w.name} launched no "
                                     f"paged kernel")
        rec["serving"] = {
            "requests": len(reqs1), "max_new_tokens": max_new,
            "ttft_s_mean": sum(ttfts) / len(ttfts), "ttft_s_max": max(ttfts),
            "wall_s": wall1,
            "tokens_per_s": sum(len(r.tokens) for r in reqs1) / wall1,
            "placement": [r.worker for r in reqs1],
            "router_phase_s_mean": {k: sum(v) / len(v)
                                    for k, v in phases.items()},
            "pump_us_median": sorted(pump_s)[len(pump_s) // 2] * 1e6,
            "pumps": len(pump_s),
            "stat": {w.name: {k: stats[w.endpoint][k] for k in
                              ("trace_counts", "kernel_launches",
                               "tokens_generated", "version")
                              if k in stats[w.endpoint]}
                     for w in workers}}

        # federation: the three members' registries in one snapshot
        plane = fleet.FleetPlane(
            fe, jsonl_path=os.path.join(work, "fleet_metrics.jsonl"),
            include_router=False)
        merged = plane.poll_now()
        fe.fleet_plane = None
        members = sorted(m["worker_id"] for m in plane.last_members)
        if members != ["decode0", "decode1", "prefill0"]:
            raise AssertionError(f"phase 14: federated members {members}")
        r = subprocess.run([sys.executable,
                            os.path.join(ROOT, "tools", "metrics_report.py"),
                            os.path.join(work, "fleet_metrics.jsonl")],
                           capture_output=True, text=True, timeout=120)
        if r.returncode:
            raise AssertionError(f"phase 14: metrics_report.py refused the "
                                 f"merged snapshot: {r.stderr[-500:]}")
        flat = metrics.flatten_snapshot(merged)
        done = sum(v for k, v in flat.items()
                   if k.startswith("serving_requests_total{")
                   and "status=completed" in k and "worker_id=_fleet" in k)
        if done != len(reqs1):
            raise AssertionError(f"phase 14: the _fleet row counts {done} "
                                 f"completed, {len(reqs1)} served")
        hist = next(s for m in merged["metrics"]
                    if m["name"] == "serving_kv_handoff_seconds"
                    for s in m["samples"]
                    if s["labels"].get("worker_id") == fleet.FLEET_LABEL)
        rec["handoff"] = {
            "bytes": flat["serving_kv_handoff_bytes_total{role=_fleet,"
                          "worker_id=_fleet}"],
            "count": hist["count"], "seconds_sum": hist["sum"],
            "seconds_mean": hist["sum"] / max(hist["count"], 1)}
        steps = {s["labels"]["worker_id"]: s["sum"] / s["count"] * 1e3
                 for m in merged["metrics"]
                 if m["name"] == "serving_decode_step_seconds"
                 for s in m["samples"] if s["count"]}
        rec["federation"] = {"members": members, "completed_fleet": done,
                             "decode_step_ms_mean": steps}

        # prefix affinity with a wire restore: a second router over the
        # decode workers alone, so placements prefill decode-local and
        # warm that worker's prefix cache. The warm prompt lands on decode
        # 0; a filler keeps 0 loaded; the warm prompt again finds its
        # chain on 0 and, with zero load slack, is placed on decode 1,
        # which restores 0's chain over the wire before its prefill
        fe2 = DistFrontend([w.endpoint for w in dec], prefix_affinity=True,
                           affinity_min_match=FLEET_ENGINE["block_size"],
                           affinity_load_slack=0)
        try:
            iw, i_fill = 8, 4
            r1 = fe2.submit(prompts[iw], max_new=max_new)
            while fe2.pump():
                time.sleep(0.001)
            rf = fe2.submit(prompts[i_fill], max_new=300)
            r2 = fe2.submit(prompts[iw], max_new=max_new)
            t = time.perf_counter()
            while fe2.pump():
                if time.perf_counter() - t > FLEET_WAVE_S:
                    raise AssertionError("phase 14 affinity: not done")
                time.sleep(0.001)
            place = [d for d in fe2.decision_records()
                     if d["action"] == "place" and d["key"] == r2.key][0]
            restore = [p["dur_s"] for tl in fe2.timeline_records()
                       if tl.get("key") == r2.key for p in tl["phases"]
                       if p["phase"] == "kv_restore"]
        finally:
            fe2.close()
        if (r1.worker, rf.worker, r2.worker) != (0, 0, 1) or \
                str(place["outcome"].get("restored_from")) != "0" or \
                not restore:
            raise AssertionError(
                f"phase 14 affinity: placed {r1.worker}, {rf.worker}, "
                f"{r2.worker}; place outcome {place['outcome']}; restore "
                f"phases {restore}")
        hold([r1, r2], [iw, iw], "affinity")
        rec["affinity"] = {
            "placed": [r1.worker, rf.worker, r2.worker],
            "matches": place["inputs"].get("matches"),
            "restored_from": place["outcome"]["restored_from"],
            "kv_restore_s": restore[0], "ttft_s": [r1.ttft_s, r2.ttft_s]}

        # failover: a second wave of 8, first undisturbed, then with one
        # decode worker SIGKILLed once every request has its first token.
        # Streams of 300 tokens keep most of the wave in flight at the
        # kill (a 700-token prompt leaves 323 positions)
        idx2, n2 = list(range(8, 16)), 300
        ref2, _ = wave(idx2, "failover reference", n=n2)
        hold(ref2, idx2, "failover reference")
        failovers0 = failovers.value
        reqs2, _ = wave(idx2, "failover", n=n2,
                        until=lambda rs: all(r.tokens for r in rs))
        busy = [sum(1 for r in reqs2 if r.worker == i and not r.done())
                for i in (0, 1)]
        victim = 1 if busy[1] >= busy[0] else 0
        pre_kill = fe.decode.stat(victim)
        victims = [r for r in reqs2 if r.worker == victim and not r.done()]
        dec[victim].proc.kill()
        t_kill = time.perf_counter()
        # resumed: every victim restarted and streaming on the survivor
        while not all(r.done() or (r.failovers and r._cur)
                      for r in victims):
            if time.perf_counter() - t_kill > FLEET_WAVE_S:
                raise AssertionError("phase 14: the victims never resumed")
            pump()
            time.sleep(0.001)
        resumed_s = time.perf_counter() - t_kill
        finish(reqs2, "failover")
        failover_s = time.perf_counter() - t_kill
        hold(reqs2, idx2, "failover", ref=ref2)
        restarted = sum(1 for r in reqs2 if r.failovers)
        if failovers.value - failovers0 < 1 or not restarted:
            raise AssertionError(f"phase 14: failover counter "
                                 f"{failovers.value - failovers0}, "
                                 f"{restarted} restarted")
        survivor = dec[1 - victim]
        rec["failover"] = {
            "killed": dec[victim].name, "victims": busy[victim],
            "restarted": restarted, "max_new_tokens": n2,
            "failover_total": failovers.value - failovers0,
            "kill_to_resumed_s": resumed_s, "kill_to_done_s": failover_s,
            "placed": [r.worker for r in reqs2],
            "delivered_at_restart": [
                len(r._base) for r in reqs2 if r.failovers],
            "killed_stat": {k: pre_kill[k] for k in
                            ("trace_counts", "kernel_launches")}}

        # swap: `swap_all` to the same weights as version 2 while a third
        # wave keeps 8 of phase 4's requests in flight on the survivor
        # (a finished one is replaced at once) until the swap returns, so
        # the worker applies it under live streams whatever its
        # checkpoint load takes. Their lengths are staggered (40 to 264
        # tokens) so that they never all finish together: streams of one
        # length end on one step, and the survivor would idle through
        # their replacements' prefill and handoff, where the swap may
        # land with nothing in flight. The wave rides a second router
        # with its own connections: the first one's socket to the
        # survivor is held by the SWAP call while the checkpoint loads
        import threading
        out, fe3, reqs3 = {}, DistFrontend([survivor.endpoint],
                                           [pre.endpoint]), []
        swapper = threading.Thread(
            target=lambda: out.update(fe.swap_all(ckpt, version=2)))

        def submit3():
            k = len(reqs3)
            reqs3.append(fe3.submit(prompts[k % 16],
                                    max_new=40 + 32 * (k % 8)))

        try:
            t = time.perf_counter()
            while not (reqs3 and all(r.tokens for r in reqs3)):
                while len(reqs3) < 8:
                    submit3()
                fe3.pump()
                if time.perf_counter() - t > FLEET_WAVE_S:
                    raise AssertionError("phase 14: the swap wave never "
                                         "started")
            t_swap = time.perf_counter()
            swapper.start()
            while swapper.is_alive():
                while sum(not r.done() for r in reqs3) < 8:
                    submit3()
                fe3.pump()
                if time.perf_counter() - t > FLEET_WAVE_S:
                    raise AssertionError("phase 14: swap_all never "
                                         "returned")
                time.sleep(0.001)
            swap_s = time.perf_counter() - t_swap
            while fe3.pump():
                time.sleep(0.001)
        finally:
            swapper.join(timeout=FLEET_WAVE_S)
            fe3.close()
        if not all(v.get("ok") for v in out.values()) or \
                not out[survivor.endpoint].get("inflight"):
            raise AssertionError(f"phase 14: swap_all {out}")
        idx3 = [i % 16 for i in range(len(reqs3))]
        hold(reqs3, idx3, "swap")
        versions = {ep: s.get("version") for ep, s in fe.stats().items()}
        if set(versions.values()) != {2} or \
                set(versions) != {pre.endpoint, survivor.endpoint}:
            raise AssertionError(f"phase 14: versions after swap {versions}")
        rec["swap"] = {"swap_all_s": swap_s, "versions": versions,
                       "requests": len(reqs3),
                       "inflight_at_apply": {ep: v.get("inflight")
                                             for ep, v in out.items()}}
        rec["gpu_apps"] = gpu_apps()
        rec["held"] = {"compared_tokens": compared,
                       "dropped_near_ties": dropped}
        rec["decisions"] = {}
        for d in fe.decision_records():
            rec["decisions"][d["action"]] = \
                rec["decisions"].get(d["action"], 0) + 1

        # shutdown: STOP every live worker, each exits 0
        fe.stop_workers()
        exits = {}
        for w in workers:
            rc = w.proc.wait(timeout=60)
            exits[w.name] = rc
            if w is dec[victim]:
                continue
            info = w.exit_info()
            if rc != 0 or info is None:
                raise AssertionError(f"phase 14: {w.name} exited {rc}:\n"
                                     f"{w.log_tail()}")
            if set(info["capture_counts"]) != names or \
                    set(info["capture_counts"].values()) != {1} or \
                    info["kernel_launches"] <= 0 or \
                    info["attention_impl"] != "kernel":
                raise AssertionError(f"phase 14: {w.name} exit line {info}")
            rec.setdefault("exit", {})[w.name] = info
        rec["exit_codes"] = exits
    finally:
        if fe is not None:
            fe.close()
        for w in workers:
            w.close()
        shutil.rmtree(ckpt_root, ignore_errors=True)
    s = rec["serving"]
    log(f"fleet gpt_125m (1 prefill + 2 decode processes, paged kernel): "
        f"workers up in {rec['start_all_s']:.2f} s ("
        + ", ".join(f"{k} {v:.2f}" for k, v in rec["start_s"].items())
        + f"), {s['requests']} requests done, TTFT mean "
        f"{s['ttft_s_mean']:.4f} s max {s['ttft_s_max']:.4f} s through the "
        f"router, {s['tokens_per_s']:.1f} tokens/s, one pump() median "
        f"{s['pump_us_median']:.1f} us, handoff "
        f"{rec['handoff']['bytes']:.0f} bytes in {rec['handoff']['count']} "
        f"bundles, {rec['handoff']['seconds_mean'] * 1e3:.2f} ms each; "
        f"router phases, mean s: " + ", ".join(
            f"{k} {v:.4f}" for k, v in s["router_phase_s_mean"].items())
        + "; decode step inside the workers, mean ms: " + ", ".join(
            f"{k} {v:.3f}" for k, v in
            rec["federation"]["decode_step_ms_mean"].items())
        + f" [{smi}]")
    a = rec["affinity"]
    log(f"fleet prefix affinity: placed {a['placed']} (warm, filler, warm "
        f"again) with matches {a['matches']}; restored from decode "
        f"{a['restored_from']} in {a['kv_restore_s'] * 1e3:.2f} ms (the "
        f"kv_restore phase); TTFT {a['ttft_s'][0]:.4f} s local prefill, "
        f"{a['ttft_s'][1]:.4f} s with the wire restore [{smi}]")
    log("fleet launches, captures and memory: " + ", ".join(
        f"{k} {v['kernel_launches']} launches {v['capture_counts']}, peak "
        f"{v['max_memory_allocated_mib']:.0f} MiB allocated, "
        f"{v['memory_reserved_mib']:.0f} MiB reserved"
        for k, v in rec["exit"].items())
        + f"; killed {rec['failover']['killed']} "
        f"{rec['failover']['killed_stat']['kernel_launches']} launches")
    log(f"fleet failover: SIGKILL {rec['failover']['killed']} with "
        f"{rec['failover']['victims']} live streams, "
        f"{rec['failover']['restarted']} restarted, streaming again "
        f"{rec['failover']['kill_to_resumed_s']:.3f} s and done "
        f"{rec['failover']['kill_to_done_s']:.3f} s after the kill; "
        f"swap_all v2 in {rec['swap']['swap_all_s']:.3f} s under a wave "
        f"of {rec['swap']['requests']} requests, "
        f"versions {sorted(set(rec['swap']['versions'].values()))}, in "
        f"flight at apply {rec['swap']['inflight_at_apply']}; "
        f"{compared} token comparisons against phase 4's and the "
        f"undisturbed waves' streams agree ({dropped} dropped by the "
        f"near-tie rule); decisions {rec['decisions']}; card memory "
        f"{rec['gpu_apps']} [{smi}]")
    return rec


# ------------------------------------------------------------ flash kernels
FLASH_CASES = [
    # name, shape, dtype, causal, mask, dropout rate
    ("a_train_bf16_causal", dict(B=8, H=16, Hk=16, S=1024, D=64), "bf16",
     True, False, 0.0),
    ("b_f32_causal_S1024", dict(B=2, H=8, Hk=8, S=1024, D=64), "f32", True,
     False, 0.0),
    ("c_f32_noncausal", dict(B=2, H=4, Hk=4, S=512, D=64), "f32", False,
     False, 0.0),
    ("d_ragged_S200", dict(B=2, H=4, Hk=4, S=200, D=64), "f32", True, False,
     0.0),
    ("e_D128_f32", dict(B=1, H=4, Hk=4, S=384, D=128), "f32", True, False,
     0.0),
    ("e_D128_bf16", dict(B=2, H=4, Hk=4, S=512, D=128), "bf16", True, False,
     0.0),
    ("f_mask_b1ss", dict(B=2, H=4, Hk=4, S=256, D=64), "f32", False, True,
     0.0),
    ("g_dropout_0.1", dict(B=2, H=4, Hk=4, S=512, D=64), "f32", True, False,
     0.1),
    ("h_gqa_16_4", dict(B=1, H=16, Hk=4, S=512, D=64), "f32", True, False,
     0.0),
    # the same options through the bf16 (tensor-core) builds
    ("d_ragged_S200_bf16", dict(B=2, H=4, Hk=4, S=200, D=64), "bf16", True,
     False, 0.0),
    ("f_mask_b1ss_bf16", dict(B=2, H=4, Hk=4, S=256, D=64), "bf16", False,
     True, 0.0),
    ("g_dropout_0.1_bf16", dict(B=2, H=4, Hk=4, S=512, D=64), "bf16", True,
     False, 0.1),
    ("h_gqa_16_4_bf16", dict(B=1, H=16, Hk=4, S=512, D=64), "bf16", True,
     False, 0.0),
    # the edges of the bf16 kernels' 128-row tiles and 64-column panels
    ("i_S64_bf16", dict(B=2, H=4, Hk=4, S=64, D=64), "bf16", True, False,
     0.0),
    ("j_S129_bf16", dict(B=2, H=4, Hk=4, S=129, D=64), "bf16", True, False,
     0.0),
    ("k_S1000_bf16", dict(B=1, H=8, Hk=8, S=1000, D=64), "bf16", True,
     False, 0.0),
    ("l_noncausal_S1024_bf16", dict(B=1, H=8, Hk=8, S=1024, D=64), "bf16",
     False, False, 0.0),
    ("m_D128_S1024_bf16", dict(B=1, H=8, Hk=8, S=1024, D=128), "bf16", True,
     False, 0.0),
    ("n_gqa_16_4_S200_bf16", dict(B=1, H=16, Hk=4, S=200, D=64), "bf16",
     True, False, 0.0),
]
MASKED_ROWS = (3, 100)      # rows the (B,1,S,S) mask of case f removes


def flash_case(seed, B, H, Hk, S, D, kind, causal, mask, rate):
    """Flattened [B*H, S, D] inputs as the autograd wrapper hands them to
    the kernels, the Meta, and the mask flattened to [B, S, S]."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = {"bf16": torch.bfloat16, "f16": torch.float16}.get(kind,
                                                             torch.float32)

    def rnd(rows):
        return torch.randn((rows, S, D), generator=g, device="cuda").to(dt)
    c = {"q": rnd(B * H), "k": rnd(B * Hk), "v": rnd(B * Hk),
         "do": rnd(B * H), "mask": None}
    if mask:
        m = torch.randn((B, S, S), generator=g, device="cuda") * 2
        m[torch.rand((B, S, S), generator=g, device="cuda") < 0.2] = \
            float("-inf")
        m[:, list(MASKED_ROWS), :] = float("-inf")
        c["mask"] = m
    c["meta"] = fa.Meta(H=H, Hk=Hk, Bm=B if mask else 1, causal=causal,
                        scale=D ** -0.5, rate=rate, seed=seed)
    return c


def flash_bound(B, H, Hk, S, D, kind, causal, which):
    """Least time of one kernel call on an H100: each input read once and
    each output written once over 3.35 TB/s, against the products over the
    (query, key) pairs the call needs (the lower triangle when causal): 2*D
    flops a pair and head per product, 2 products in the forward, 3 in dq,
    4 in dkv, at the rate of the input type."""
    el = 2 if kind in ("bf16", "f16") else 4
    qo = B * H * S * D * el                  # q, dO, O, dQ, dK, dV per head
    kv = B * Hk * S * D * el
    rows = B * H * S * 4                     # lse / delta, f32
    pairs = B * H * (S * (S + 1) // 2 if causal else S * S)
    nbytes, products = {
        "fwd": (qo + 2 * kv + qo + rows, 2),
        "dq": (2 * qo + 2 * kv + 2 * rows + qo, 3),
        "dkv": (2 * qo + 2 * kv + 2 * rows + 2 * qo, 4)}[which]
    flops = products * 2 * D * pairs
    t_bytes = nbytes / device_peaks(kind).hbm_bw * 1e3
    t_ops = flops / device_peaks(kind).peak_flops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations", nbytes, flops)


def run_flash_cases(flush, keep_going=False):
    """Phase 7. Each kernel is held against its plain version on the same
    inputs (the backward kernels get the plain forward's lse and delta).
    Returns (per-case records, timing record at the training shape,
    failures). Without `keep_going` the first failure raises; with it,
    every case runs and the failures are returned."""
    results, timing, failures = [], None, []
    for i, case in enumerate(FLASH_CASES):
        try:
            rec, t = flash_case_check(i, *case, flush=flush)
        except Exception as e:       # noqa: BLE001 - reported, then raised
            if not keep_going:
                raise
            failures.append(f"{case[0]}: {type(e).__name__}: {e}")
            log(f"flash {case[0]}: FAILED {type(e).__name__}: {e}")
            continue
        results.append(rec)
        timing = timing or t
    return results, timing, failures


def flash_case_check(i, name, shp, kind, causal, mask, rate, flush,
                     timed=False, seed=200):
    """One phase-7 case; the first case (or any with `timed`) is also
    timed (phase 7a)."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    c = flash_case(seed + i, **shp, kind=kind, causal=causal, mask=mask,
                   rate=rate)
    q, k, v, do, mf, meta = (c[n] for n in ("q", "k", "v", "do", "mask",
                                            "meta"))
    o, lse = fa.flash_fwd(q, k, v, mf, meta)
    po, plse = fa.fwd_plain(q, k, v, mf, meta)
    delta = (do.float() * po.float()).sum(-1)
    dq = fa.flash_dq(q, k, v, do, plse, delta, mf, meta)
    pdq = fa.dq_plain(q, k, v, do, plse, delta, mf, meta)
    dk, dv = fa.flash_dkv(q, k, v, do, plse, delta, mf, meta)
    pdk, pdv = fa.dkv_plain(q, k, v, do, plse, delta, mf, meta)
    dq2 = fa.flash_dq(q, k, v, do, plse, delta, mf, meta)
    dk2, dv2 = fa.flash_dkv(q, k, v, do, plse, delta, mf, meta)
    o2, lse2 = fa.flash_fwd(q, k, v, mf, meta)
    torch.cuda.synchronize()
    # the kernels use no atomics: a second launch repeats the first bit
    # for bit
    for out, a, b in (("o", o, o2), ("lse", lse, lse2), ("dq", dq, dq2),
                      ("dk", dk, dk2), ("dv", dv, dv2)):
        if not torch.equal(a, b):
            raise AssertionError(f"flash {name}: {out} differs between two "
                                 "launches on the same inputs")
    tol = {"bf16": BF16_TOL, "f16": F16_TOL}.get(kind, ATOL)
    errs, refs, wrong = {}, {}, []
    for out, got, want, t in (("o", o, po, tol), ("lse", lse, plse, ATOL),
                              ("dq", dq, pdq, tol), ("dk", dk, pdk, tol),
                              ("dv", dv, pdv, tol)):
        err = (got.float() - want.float()).abs()
        bad = (err > t + t * want.float().abs()) | ~torch.isfinite(got)
        errs[out] = float(err.max())
        refs[out] = float(want.float().abs().max())
        if refs[out] == 0.0:
            wrong.append(f"{out} (the plain version is all zeros: the "
                         "comparison holds nothing)")
        if bool(bad.any()):
            wrong.append(f"{out} (max_abs_err={errs[out]}, tol {t}, "
                         f"{int(bad.sum())} bad, first at "
                         f"{bad.nonzero()[:4].tolist()})")
    if wrong:
        raise AssertionError(f"flash {name}: kernel disagrees with the "
                             "plain version in " + "; ".join(wrong))
    if mask:
        rows = o.reshape(shp["B"], shp["H"], shp["S"], -1)[
            :, :, list(MASKED_ROWS)]
        if bool((rows != 0).any()):
            raise AssertionError(f"flash {name}: fully masked rows "
                                 "must be exact zeros")
    rec = {"case": name, **shp, "kind": kind, "causal": causal,
           "mask": mask, "dropout": rate, "tol": tol,
           "max_abs_err": errs, "max_abs_plain": refs}
    if kind == "f16":
        rec["bf16_control"] = f16_bf16_control(
            name, q, k, v, do, plse, delta, mf, meta,
            {"o": po, "dq": pdq, "dk": pdk, "dv": pdv})
    log(f"flash {name}: B={shp['B']} H={shp['H']} Hk={shp['Hk']} "
        f"S={shp['S']} D={shp['D']} {kind} causal={causal} mask={mask} "
        f"dropout={rate} max_abs_err "
        + " ".join(f"{n}={e:.2e}" for n, e in errs.items())
        + f" (tol {tol}; largest plain value "
        + " ".join(f"{n}={e:.2e}" for n, e in refs.items()) + ")")
    timing = (time_flash(c, shp, kind, causal, plse, delta, flush)
              if i == 0 or timed else None)
    return rec, timing


def f16_bf16_control(name, q, k, v, do, lse, delta, mask, meta, plain):
    """The float16 plain versions with P and dS rounded to bf16 instead of
    float16 (a build that drops 3 mantissa bits there), held to F16_TOL
    against the sound plain outputs. It must fail the limit somewhere, or
    the limit could not tell such a build from the float16 one. Returns the
    control's max abs errors and the elements over the limit."""
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    sound = fa._round
    fa._round = lambda x, dtype: x.to(
        torch.bfloat16 if dtype == torch.float16 else dtype).float()
    try:
        got = {"o": fa.fwd_plain(q, k, v, mask, meta)[0],
               "dq": fa.dq_plain(q, k, v, do, lse, delta, mask, meta)}
        got["dk"], got["dv"] = fa.dkv_plain(q, k, v, do, lse, delta, mask,
                                            meta)
    finally:
        fa._round = sound
    errs, over = {}, {}
    for out, want in plain.items():
        err = (got[out].float() - want.float()).abs()
        errs[out] = float(err.max())
        over[out] = int((err > F16_TOL + F16_TOL * want.float().abs())
                        .sum())
    log(f"flash {name}: control with P and dS rounded to bf16: "
        "max_abs_err " + " ".join(f"{n}={e:.2e}" for n, e in errs.items())
        + ", over the limit " + " ".join(f"{n}={c}" for n, c in over.items())
        + f" (tol {F16_TOL})")
    if not any(over.values()):
        raise AssertionError(f"flash {name}: a control rounding P and dS to "
                             f"bf16 passes the float16 limit {F16_TOL}: the "
                             "check cannot tell the two apart")
    return {"max_abs_err": errs, "over_limit": over}


def time_flash(c, shp, kind, causal, lse, delta, flush):
    """Device ms of each kernel, its plain version, the SDPA yardsticks
    and the bounds at the training shape (phase 7a)."""
    import torch
    import torch.nn.functional as F
    from paddle_tpu_torch.ops import flash_attention as fa
    q, k, v, do, meta = (c[n] for n in ("q", "k", "v", "do", "meta"))
    B, H, S, D = shp["B"], shp["H"], shp["S"], shp["D"]
    fns = {
        "fwd": (lambda: fa.flash_fwd(q, k, v, None, meta),
                lambda: fa.fwd_plain(q, k, v, None, meta)),
        "dq": (lambda: fa.flash_dq(q, k, v, do, lse, delta, None, meta),
               lambda: fa.dq_plain(q, k, v, do, lse, delta, None, meta)),
        "dkv": (lambda: fa.flash_dkv(q, k, v, do, lse, delta, None, meta),
                lambda: fa.dkv_plain(q, k, v, do, lse, delta, None, meta)),
    }
    q4, k4, v4, do4 = (t.reshape(B, -1, S, D) for t in (q, k, v, do))
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q4, k4, v4))

    def sdpa_fwd():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal)

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        torch.autograd.backward(out, do4)
    lib_fwd = time_ms(sdpa_fwd, flush)
    lib_bwd = time_ms(sdpa_fwd_bwd, flush) - lib_fwd
    out = {"sdpa_fwd_ms": lib_fwd, "sdpa_bwd_ms": lib_bwd}
    for which, (kern, plain) in fns.items():
        bound, by, nbytes, flops = flash_bound(B, H, shp["Hk"], S, D, kind,
                                               causal, which)
        kms = time_ms(kern, flush)
        pms = time_ms(plain, flush, iters=5)
        lib = lib_fwd if which == "fwd" else lib_bwd
        out[which] = {"ms": kms, "plain_ms": pms, "bound_ms": bound,
                      "bound_by": by, "bytes": nbytes, "flops": flops,
                      "tflops": flops / kms / 1e9, "library_ms": lib,
                      "x_library": kms / lib}
        log(f"flash {which} at B={B} H={H} S={S} D={D} {kind} causal: "
            f"kernel_ms={kms:.4f} ({flops / kms / 1e9:.1f} TFLOP/s) "
            f"plain_ms={pms:.4f} bound_ms={bound:.5f} ({by}) "
            f"sdpa_ms={lib:.4f} x_sdpa={kms / lib:.2f}")
    log(f"sdpa yardstick: forward {lib_fwd:.4f} ms, backward "
        f"{lib_bwd:.4f} ms (forward+backward minus forward)")
    return out


_PTX_ARGS = re.compile(
    r"13__nv_bfloat16|6__half|Li(\d+)E?|Lb([01])|S\d*_|[fa]")


def _short_kernel(mangled):
    """`paged_tile_kernel<f32,i8,128,1>` from a mangled kernel name."""
    m = re.search(r"\d+([a-z_]+_kernel)I(.+?)EEv", mangled)
    if m is None:
        return mangled
    names = {"13__nv_bfloat16": "bf16", "6__half": "f16", "f": "f32",
             "a": "i8"}
    args = []
    for t in _PTX_ARGS.finditer(m.group(2)):
        tok = t.group(0)
        args.append(t.group(1) or t.group(2) or (
            args[-1] if tok.startswith("S") else names[tok]))
    return f"{m.group(1)}<{','.join(args)}>"


def ptxas_resources(lib):
    """Registers and spills of every kernel of a built library, from the
    compiler's report (`build.ptxas_report`)."""
    from paddle_tpu_torch._kernels import build
    out, kernel, spills = [], None, (None, None)
    for line in build.ptxas_report(lib).splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            kernel, spills = m.group(1), (None, None)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel is not None:
            out.append({"kernel": _short_kernel(kernel), "mangled": kernel,
                        "registers": int(m.group(1)),
                        "spill_stores": spills[0], "spill_loads": spills[1]})
            kernel = None
    return out


def wgmma_resources(flash_rows):
    """The 16-bit wgmma kernels among the flash library's `ptxas_resources`
    rows, with their head dim, type, build (mask/dropout or plain; its
    tile) and dynamic shared memory."""
    from paddle_tpu_torch.ops import flash_attention as fa
    lib = fa._kernel_lib()
    out = []
    for r in flash_rows:
        kernel = r["mangled"]
        if "wgmma" not in kernel:
            continue
        # the smem query's kernel index: fwd 0, dq 1, dkv 2
        which = (2 if "flash_dkv" in kernel else
                 1 if "flash_dq" in kernel else 0)
        # <type, D, general[, M, N]>: dQ and dK/dV have one tile each
        args = r["kernel"][r["kernel"].index("<") + 1:-1].split(",")
        D = int(args[1])
        tile = ((int(args[3]), int(args[4])) if len(args) == 5
                else fa.BUILDS[("fwd", "dq", "dkv")[which]][0])
        out.append({**r, "D": D, "dtype": args[0],
                    "general": args[2] == "1", "tile": list(tile),
                    "smem_dynamic": lib.flash_attention_wgmma_smem(
                        which, D, *tile)})
    return out


# ------------------------------------------------------------------ training
TRAIN_350M = dict(vocab_size=50304, max_seq_len=1024, hidden=1024,
                  layers=24, heads=16)


# device kernels of a profiled training step, grouped by name
KERNEL_KINDS = (
    ("flash attention", ("flash_",)),
    ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
    ("layernorm", ("layer_norm",)),
    ("reduction", ("reduce",)),
    ("copy", ("copy", "cat", "index")),
    ("elementwise", ("elementwise",)),
)


def step_flops(cfg, n_params, B, S):
    """Operations of one training step: 6 per parameter and token (forward
    and backward products), plus the causal attention products: 2 of
    2*hidden flops per (query, key) pair and layer in the forward, twice
    that again in the backward."""
    pairs = B * S * (S + 1) // 2
    return 6 * n_params * B * S + 12 * cfg.layers * cfg.hidden * pairs


def time_step_parts(cfg, step_fn, params, state, toks, labs):
    """Device ms of the flagship step and of its parts, by CUDA events:
    the whole step, forward + backward of the loss (so clip + AdamW is the
    difference), the forward alone, and the LM head's logits product three
    ways: the port's `matmul_f32` (bf16 operands, f32 result) beside a
    bf16-result matmul and an f32-operand matmul, the two choices it
    avoids (timed only)."""
    import torch
    from paddle_tpu_torch.ops.flash_attention import flash_attention_bhsd
    from paddle_tpu_torch.ops.fused_ce import matmul_f32
    from paddle_tpu_torch.parallel import gpt_spmd

    def no_flush():
        pass

    def loss():
        return gpt_spmd._loss(params, toks, labs, cfg, flash_attention_bhsd)

    def fwd():
        with torch.no_grad():
            loss()

    def fwd_bwd():
        loss().backward()
        for p in params.values():
            p.grad = None

    out = {"step_ms": time_ms(lambda: step_fn(params, state, toks, labs),
                              no_flush, iters=5, warmup=1),
           "fwd_bwd_ms": time_ms(fwd_bwd, no_flush, iters=5, warmup=1),
           "fwd_ms": time_ms(fwd, no_flush, iters=5, warmup=1)}
    out["clip_adamw_ms"] = out["step_ms"] - out["fwd_bwd_ms"]
    T = toks.numel()
    g = torch.Generator(device="cuda").manual_seed(5)
    h = torch.randn((T, cfg.hidden), generator=g, device="cuda").to(
        params["wte"].dtype)
    wte = params["wte"].detach()
    wt = wte.t()
    out["lm_head"] = {
        "tokens": T, "vocab": cfg.vocab_size,
        "flops": 2 * T * cfg.hidden * cfg.vocab_size,
        "matmul_f32_ms": time_ms(lambda: matmul_f32(h, wt), no_flush),
        "bf16_result_ms": time_ms(lambda: torch.matmul(h, wt), no_flush),
        "f32_operands_ms": time_ms(
            lambda: torch.matmul(h.float(), wte.float().t()), no_flush,
            iters=5)}
    log(f"step parts (device ms): step {out['step_ms']:.2f}, forward + "
        f"backward {out['fwd_bwd_ms']:.2f}, forward {out['fwd_ms']:.2f}, "
        f"clip + AdamW {out['clip_adamw_ms']:.2f}")
    lm = out["lm_head"]
    log(f"LM head logits ({T} x {cfg.hidden} x {cfg.vocab_size}): "
        f"matmul_f32 {lm['matmul_f32_ms']:.3f} ms, bf16 result "
        f"{lm['bf16_result_ms']:.3f} ms, f32 operands "
        f"{lm['f32_operands_ms']:.3f} ms")
    return out


def profile_train_step(call, cpu=True):
    """One training step under torch.profiler (phases 8 and 20): the
    traced step ms, device busy ms, the idle share of the traced step,
    kernels, device ms by kernel kind and the largest kernels. cpu=False
    records the card alone (a lighter trace for steps of tens of
    thousands of launches)."""
    import torch
    with card_profile(cpu=cpu) as prof:
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    kernels = device_kernels(prof)

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) \
            or getattr(e, "self_cuda_time_total", 0.0)
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3
    by_kind = {}
    for e in kernels:
        kind = next((k for k, keys in KERNEL_KINDS if any(
            x in e.key.lower() for x in keys)), "other")
        by_kind[kind] = by_kind.get(kind, 0.0) + dev_us(e) / 1e3
    top = sorted(kernels, key=dev_us, reverse=True)[:10]
    return {"traced_step_ms": traced_ms, "device_busy_ms": busy_ms,
            "device_idle_share": (1 - busy_ms / traced_ms if busy_ms
                                  else None),
            "kernels_per_step": sum(e.count for e in kernels),
            "device_ms_by_kind": by_kind,
            "top": [{"name": e.key[:70], "ms": dev_us(e) / 1e3,
                     "count": e.count} for e in top]}


def train_step_350m(smi, warmup=3, steps=10, B=8):
    """Phase 8: the flagship step through `make_train_step`."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel import GPTSpmdConfig, make_train_step
    cfg = GPTSpmdConfig(**TRAIN_350M, param_dtype="bfloat16",
                        compute_dtype="bfloat16", remat=False)
    S = cfg.max_seq_len
    step_fn, init_fn = make_train_step(cfg, learning_rate=2e-4,
                                       device="cuda")
    params, state = init_fn(0)
    n_params = sum(p.numel() for p in params.values())
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).cuda()
    labs = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).cuda()
    losses = []
    for _ in range(warmup):
        loss, params, state = step_fn(params, state, toks, labs)
        losses.append(float(loss))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
    times = []
    for _ in range(steps):
        t0 = time.perf_counter()
        loss, params, state = step_fn(params, state, toks, labs)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    launches = {"fwd": fa.launches_fwd, "dq": fa.launches_dq,
                "dkv": fa.launches_dkv}
    peak = torch.cuda.max_memory_allocated()
    for which, n in launches.items():
        if n != steps * cfg.layers:
            raise AssertionError(f"phase 8: {n} flash {which} launches in "
                                 f"{steps} steps, want {cfg.layers} a step")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"phase 8: loss not finite: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"phase 8: loss did not fall: {losses}")
    step_ms = sorted(times)[len(times) // 2] * 1e3
    mean_ms = sum(times) / len(times) * 1e3
    flops = step_flops(cfg, n_params, B, S)
    bf16_peak = device_peaks("bf16").peak_flops

    prof = profile_train_step(lambda: step_fn(params, state, toks, labs))
    traced_ms, busy_ms = prof["traced_step_ms"], prof["device_busy_ms"]
    rec = {"config": "gpt-350m", **TRAIN_350M, "B": B, "S": S,
           "dtype": "bfloat16", "remat": False, "lr": 2e-4,
           "n_params": n_params, "losses": losses,
           "step_ms_median": step_ms, "step_ms_mean": mean_ms,
           "step_ms_all": [t * 1e3 for t in times],
           "tokens_per_s": B * S / (step_ms / 1e3),
           "peak_memory_gb": peak / 1e9, "flops_per_step": flops,
           "mfu": flops / (step_ms / 1e3) / bf16_peak,
           "peak_bound_ms": flops / bf16_peak * 1e3,
           "launches": launches, **prof,
           "device_idle_share_untraced": (1 - busy_ms / step_ms
                                          if busy_ms else None),
           "card": smi}
    log(f"train gpt-350m bf16 B={B} S={S}: step {step_ms:.2f} ms median "
        f"({mean_ms:.2f} mean), {rec['tokens_per_s']:.0f} tokens/s, peak "
        f"memory {rec['peak_memory_gb']:.2f} GB, {flops:.3e} flops/step, "
        f"MFU {rec['mfu']:.4f} (peak-bound step "
        f"{rec['peak_bound_ms']:.2f} ms), launches/step "
        f"{launches['fwd'] // steps}+{launches['dq'] // steps}+"
        f"{launches['dkv'] // steps}, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} [{smi}]")
    log(f"profile train step: {traced_ms:.2f} ms traced, device busy "
        f"{busy_ms:.2f} ms, idle share {rec['device_idle_share']} of the "
        f"traced step, {rec['device_idle_share_untraced']} of the untraced "
        f"median, {rec['kernels_per_step']} kernels")
    log("  by kind: " + ", ".join(
        f"{k} {v:.2f} ms" for k, v in sorted(
            prof["device_ms_by_kind"].items(), key=lambda kv: -kv[1])))
    for t in rec["top"]:
        log(f"  {t['ms']:.3f} ms x{t['count']} {t['name']}")
    rec["parts"] = time_step_parts(cfg, step_fn, params, state, toks, labs)
    return rec


def compare_train_paths(steps=3, B=2):
    """Phase 9: flash kernels + remat + fused CE against dense attention +
    no remat + unfused CE, f32 (TF32 off), depth 2 at full width, the same
    weights and batch."""
    import dataclasses
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel import GPTSpmdConfig, make_train_step
    cfg_k = GPTSpmdConfig(**{**TRAIN_350M, "layers": 2}, remat=True,
                          fused_ce_chunks=8)
    cfg_p = dataclasses.replace(cfg_k, remat=False, fused_ce_chunks=0)
    S = cfg_k.max_seq_len
    rng = np.random.RandomState(1)
    toks = torch.from_numpy(rng.randint(0, cfg_k.vocab_size, (B, S))).cuda()
    labs = torch.from_numpy(rng.randint(0, cfg_k.vocab_size, (B, S))).cuda()
    runs = {}
    for name, cfg in (("kernel", cfg_k), ("plain", cfg_p)):
        step_fn, init_fn = make_train_step(cfg, learning_rate=2e-4,
                                           device="cuda", attention=name)
        params, state = init_fn(0)
        p0 = {n: t.detach().clone() for n, t in params.items()}
        fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
        losses = []
        for _ in range(steps):
            loss, params, state = step_fn(params, state, toks, labs)
            losses.append(float(loss))
        runs[name] = (losses, params, (fa.launches_fwd, fa.launches_dq,
                                       fa.launches_dkv), p0)
    (lk, pk, nk, p0), (lp, pp, npl, p0p) = runs["kernel"], runs["plain"]
    if not all(torch.equal(p0[n], p0p[n]) for n in p0):
        raise AssertionError("phase 9: the two paths started apart")
    # remat recomputes each block's forward in the backward
    if nk != (2 * steps * 2, steps * 2, steps * 2) or npl != (0, 0, 0):
        raise AssertionError(f"phase 9 launches kernel {nk} plain {npl}")
    loss_err = max(abs(a - b) / abs(b) for a, b in zip(lk, lp))
    leaf_err = {n: float((pk[n] - pp[n]).detach().abs().max()) for n in pk}
    upd_err = {n: float((pk[n] - pp[n]).detach().norm()
                        / (pp[n] - p0[n]).detach().norm()) for n in pk}
    worst = max(leaf_err, key=leaf_err.get)
    worst_upd = max(upd_err, key=upd_err.get)
    param_err, update_err = leaf_err[worst], upd_err[worst_upd]
    rec = {"layers": 2, "B": B, "S": S, "steps": steps, "dtype": "float32",
           "losses_kernel": lk, "losses_plain": lp,
           "loss_max_rel_err": loss_err, "param_max_abs_err": param_err,
           "param_max_abs_err_by_leaf": leaf_err,
           "update_rel_err_by_leaf": upd_err,
           "tol": {"loss_rtol": TRAIN_LOSS_RTOL,
                   "param_atol": TRAIN_PARAM_ATOL,
                   "update_rtol": TRAIN_UPDATE_RTOL},
           "launches_kernel_path": nk}
    log(f"parity train kernel vs plain path (hidden 1024, 2 layers, f32, "
        f"B={B}, {steps} steps): losses {[round(x, 6) for x in lk]} vs "
        f"{[round(x, 6) for x in lp]}, max rel err {loss_err:.2e} (tol "
        f"{TRAIN_LOSS_RTOL}), params max abs err {param_err:.2e} in {worst} "
        f"(tol {TRAIN_PARAM_ATOL}), update rel err {update_err:.2e} in "
        f"{worst_upd} (tol {TRAIN_UPDATE_RTOL}), kernel launches {nk}")
    if not (loss_err <= TRAIN_LOSS_RTOL and param_err <= TRAIN_PARAM_ATOL
            and update_err <= TRAIN_UPDATE_RTOL):
        raise AssertionError("phase 9: kernel and plain training paths "
                             "disagree")
    return rec


# ------------------------------------------- KV tiers and tenancy (15)
TIER_ENGINE = dict(slots=8, max_len=1024, block_size=16,
                   attention_impl="kernel")
TIER_AGREE = 0.9            # phase 15: int8 host tier vs phase 4, greedy
ADAPTER_RANK = 16
ADAPTER_SCALE = 0.05        # A, B ~ N(0, 0.05): the delta flips argmaxes
TENANTS = ["t1", "t1", "t2", "t2", "t3", "t3", None, None]
SHARED_PREFIX = 256         # the tokens phase 4's eight prompts share


def tier_counters():
    """The port's `serving_kv_tier_*` counters now."""
    from paddle_tpu_torch.observability import metrics
    flat = metrics.flatten_snapshot(metrics.registry().snapshot(),
                                    kinds=("counter",))
    return {k: v for k, v in flat.items()
            if k.startswith("serving_kv_tier_")}


def counter_delta(before, after):
    return {k: after[k] - before.get(k, 0.0) for k in after
            if after[k] != before.get(k, 0.0)}


def tier_round(model, prompts, want, what, agree=None, **tier_kw):
    """Phase 15a: serve `prompts` on a fresh engine (`tier_kw` sets its
    tiers; none: tiers off), evict every cached block (with tiers on they
    demote), serve them again. The streams are held to phase 4's `want`
    (the near-tie rule, or with `agree` a greedy agreement floor). Returns
    (record, engine)."""
    import collections
    import torch
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import PagedGenerationEngine
    eng = PagedGenerationEngine(model, device=model.device, **TIER_ENGINE,
                                **tier_kw)
    precompile(eng, what)
    warm, _, _ = serve(eng, prompts, max_new=32)
    for p, h, w in zip(prompts, warm, want):
        same_stream(model, p, h.tokens, w, what + " (warm)")
    evicted = eng.prefix_cache.evict(10 ** 9)
    residency = collections.Counter(eng.kv_tiers.residency().values()) \
        if eng.kv_tiers is not None else {}
    stats = []
    prefill = eng.prefill

    def recorded(*a, **kw):
        out = prefill(*a, **kw)
        stats.append(dict(eng.last_prefill_stats))
        return out
    eng.prefill = recorded
    before = tier_counters()
    pa.launches = pa.launches_window = pa.launches_prefill = 0
    torch.cuda.synchronize()
    try:
        again, m, _ = serve(eng, prompts, max_new=32)
    finally:
        del eng.prefill
    launches = {"decode": pa.launches - pa.launches_prefill,
                "prefill": pa.launches_prefill,
                "window": pa.launches_window}
    if launches["decode"] <= 0 or launches["prefill"] <= 0:
        raise AssertionError(f"{what}: paged launches {launches}")
    if agree is None:
        compared = dropped = 0
        for p, h, w in zip(prompts, again, want):
            c, d = same_stream(model, p, h.tokens, w, what)
            compared, dropped = compared + c, dropped + d
        agreement = None
    else:
        pairs = [(a, b) for h, w in zip(again, want)
                 for a, b in zip(h.tokens, w)]
        agreement = sum(a == b for a, b in pairs) / len(pairs)
        if agreement < agree:
            raise AssertionError(f"{what}: greedy agreement {agreement} "
                                 f"with phase 4 < {agree}")
        compared = dropped = None
    first = stats[0]
    # the first prompt alone, evicted and re-served once more: its restore
    # (or recompute) with the batch's other requests out of the way
    eng.prefix_cache.evict(10 ** 9)
    del stats[:]
    eng.prefill = recorded
    try:
        alone, _, _ = serve(eng, prompts[:1], max_new=32)
    finally:
        del eng.prefill
    same_stream(model, prompts[0], alone[0].tokens, want[0], what + " alone")
    rec = {"alone_promoted_blocks": stats[0].get("tier_promoted_blocks", 0),
           "alone_restore_ms": stats[0].get("tier_restore_s", 0.0) * 1e3,
           "alone_ttft_s": alone[0].ttft_s,
           "evicted_blocks": evicted, "residency": dict(residency),
           "first_promoted_blocks": first.get("tier_promoted_blocks", 0),
           "first_restore_ms": first.get("tier_restore_s", 0.0) * 1e3,
           "first_prefix_hit_tokens": first["prefix_hit_tokens"],
           "first_ttft_s": again[0].ttft_s,
           "ttft_s_mean": sum(h.ttft_s for h in again) / len(again),
           "promoted_blocks": sum(s.get("tier_promoted_blocks", 0)
                                  for s in stats),
           "counters": counter_delta(before, tier_counters()),
           "trace_counts": eng.trace_counts,
           "decode_step_ms": m["decode_step_ms"], "launches": launches,
           "compared_tokens": compared, "dropped_near_ties": dropped,
           "agreement": agreement,
           "capture_counts": check_captures(eng, what)}
    chain = SHARED_PREFIX // TIER_ENGINE["block_size"]
    if tier_kw:
        if rec["first_promoted_blocks"] != chain or \
                rec["trace_counts"].get("tier_restore") != 1:
            raise AssertionError(
                f"{what}: the first re-served request promoted "
                f"{rec['first_promoted_blocks']} blocks (want {chain}), "
                f"trace_counts {rec['trace_counts']}")
    return rec, eng


def tier_chaos(model, eng, prompt, want):
    """Phase 15a chaos on a tiered engine: `serving.kv_spill` truncate
    tears every spill (the chain is lost and the request recomputes);
    after a clean demotion `serving.kv_restore` truncate drops the
    chain's head (corrupt counter +1) and the request recomputes. Both
    streams are held to phase 4's."""
    from paddle_tpu_torch.observability import faults
    out = {}
    for site in ("serving.kv_spill", "serving.kv_restore"):
        if site == "serving.kv_restore":
            eng.prefix_cache.evict(10 ** 9)           # a clean demotion
        kept = set(eng.kv_tiers.residency())
        before = tier_counters()
        faults.arm(site, mode="truncate", nth=1)
        try:
            if site == "serving.kv_spill":
                eng.prefix_cache.evict(10 ** 9)
                torn = set(eng.kv_tiers.residency()) == kept
            handles, _, _ = serve(eng, [prompt], max_new=32)
        finally:
            faults.disarm_all()
        delta = counter_delta(before, tier_counters())
        stats = eng.last_prefill_stats
        c, d = same_stream(model, prompt, handles[0].tokens, want,
                           f"phase 15 {site} chaos")
        if stats["tier_promoted_blocks"] != 0:
            raise AssertionError(f"phase 15 {site}: a tiered block was "
                                 "restored under the fault")
        if site == "serving.kv_spill" and not torn:
            raise AssertionError("phase 15: a torn spill was stored")
        if site == "serving.kv_restore" and \
                delta.get("serving_kv_tier_corrupt_total") != 1:
            raise AssertionError(f"phase 15 kv_restore: counters {delta}")
        out[site] = {"counters": delta, "compared_tokens": c,
                     "dropped_near_ties": d,
                     "prefix_hit_tokens": stats["prefix_hit_tokens"]}
    return out


def tier_worker(model, prompts, want, smi):
    """Phase 15a over the fabric: worker 0's engine demotes the shared
    prefix's chain to its host tier; its PREFIXLOOKUP counts the tiered
    tokens, and its KVEXPORT ships the chain (read from the tier) to
    worker 1's staging area, whose fresh engine restores it ahead of the
    request's prefill; the stream is phase 4's."""
    import torch
    from paddle_tpu_torch.serving import (PagedGenerationEngine,
                                          ServingConfig)
    from paddle_tpu_torch.serving.distributed import (ServingShardClient,
                                                      ServingWorker)
    m1 = type(model)(model.cfg, device=model.device)   # a worker's own
    m1.load_state_dict(model.state_dict())
    e0 = PagedGenerationEngine(model, device=model.device, **TIER_ENGINE,
                               enable_kv_tiers=True, host_tier_blocks=128)
    e1 = PagedGenerationEngine(m1, device=m1.device, **TIER_ENGINE)
    precompile(e0, "phase 15 worker 0")
    precompile(e1, "phase 15 worker 1")
    e0.prefill(0, prompts[0])
    e0.reset_slot(0)
    e0.prefix_cache.evict(10 ** 9)
    tiered = len(e0.kv_tiers.residency())
    torch.cuda.synchronize()
    cfg = ServingConfig(default_max_new_tokens=32)
    w0 = ServingWorker(model, e0, serving_config=cfg)
    w1 = ServingWorker(m1, e1, serving_config=cfg)
    client = ServingShardClient([w0.endpoint, w1.endpoint])
    try:
        match = client.prefix_lookup(0, prompts[1])["match_tokens"]
        t0 = time.perf_counter()
        exp = client.kv_export(0, "p15", prompts[0],
                               decode_endpoint=w1.endpoint)
        export_ms = (time.perf_counter() - t0) * 1e3
        client.submit(1, "p15", prompts[0], max_new=32, use_staged=True)
        deadline = time.monotonic() + 120
        while True:
            view = client.poll(1, ["p15"])["p15"]
            if view["status"] in ("DONE", "ERROR", "TIMEOUT", "SHED"):
                break
            if time.monotonic() > deadline:
                raise AssertionError(f"phase 15 worker: stuck {view}")
            time.sleep(0.01)
        with w1._lock:
            hit = e1.last_prefill_stats["prefix_hit_tokens"]
            counts1 = check_captures(e1, "phase 15 worker 1")
        counts0 = check_captures(e0, "phase 15 worker 0")
    finally:
        client.close()
        w0.shutdown()
        w1.shutdown()
    if match != SHARED_PREFIX:
        raise AssertionError(f"phase 15: PREFIXLOOKUP counted {match} "
                             f"tokens of a {SHARED_PREFIX}-token tiered "
                             "prefix")
    if not exp.get("ok") or exp.get("plen") != SHARED_PREFIX or \
            hit != SHARED_PREFIX \
            or view["status"] != "DONE":
        raise AssertionError(f"phase 15: KVEXPORT {exp}, restored hit "
                             f"{hit}, request {view['status']}")
    c, d = same_stream(model, prompts[0], view["tokens"], want,
                       "phase 15 KVEXPORT restore")
    rec = {"tiered_blocks": tiered, "prefix_lookup_tokens": match,
           "export": exp, "export_ms": export_ms, "restored_hit": hit,
           "compared_tokens": c, "dropped_near_ties": d,
           "capture_counts": [counts0, counts1]}
    log(f"tiers over the fabric: PREFIXLOOKUP {match} tokens from "
        f"{tiered} tiered blocks, KVEXPORT {exp['bytes']} B in "
        f"{export_ms:.1f} ms, the restored request hit {hit} tokens and "
        f"its stream agrees on {c} tokens ({d} dropped) [{smi}]")
    del e0, e1, m1
    return rec


def tiers_phase(model, prompts, want, smi):
    """Phase 15a: the KV tiers under the prefix cache. `prompts`: phase
    4's eight shared-prefix prompts; `want`: their phase 4 streams."""
    import shutil
    import torch
    kvt = os.path.join(ROOT, "build", "phase15_kvt")
    shutil.rmtree(kvt, ignore_errors=True)
    out = {}
    try:
        runs = (("host", dict(enable_kv_tiers=True, host_tier_blocks=128,
                              disk_tier_dir=os.path.join(kvt, "host"))),
                ("disk", dict(enable_kv_tiers=True, host_tier_blocks=1,
                              disk_tier_dir=os.path.join(kvt, "disk"))),
                ("int8", dict(enable_kv_tiers=True, host_tier_blocks=128,
                              host_tier_dtype="int8")),
                ("recompute", {}))
        for name, kw in runs:
            rec, eng = tier_round(
                model, prompts, want, f"phase 15 tiers {name}",
                agree=TIER_AGREE if name == "int8" else None, **kw)
            if name == "host":
                hits = rec["counters"].get(
                    "serving_kv_tier_hits_total{tier=host}", 0)
                chain = SHARED_PREFIX // TIER_ENGINE["block_size"]
                if hits < chain:
                    raise AssertionError(f"phase 15: host tier hits "
                                         f"{hits}, want >= {chain}")
                rec["chaos"] = tier_chaos(model, eng, prompts[0], want[0])
            if name == "disk" and not rec["counters"].get(
                    "serving_kv_tier_promote_total{tier=disk}"):
                raise AssertionError(f"phase 15: nothing promoted from "
                                     f"disk ({rec['counters']})")
            out[name] = rec
            log(f"tiers {name}: evicted {rec['evicted_blocks']} blocks "
                f"(tiers {rec['residency']}), the first re-served request "
                f"promoted {rec['first_promoted_blocks']} blocks in "
                f"{rec['first_restore_ms']:.3f} ms, TTFT "
                f"{rec['first_ttft_s'] * 1e3:.2f} ms (mean "
                f"{rec['ttft_s_mean'] * 1e3:.2f} ms); served alone it "
                f"promoted {rec['alone_promoted_blocks']} blocks in "
                f"{rec['alone_restore_ms']:.3f} ms, TTFT "
                f"{rec['alone_ttft_s'] * 1e3:.2f} ms; "
                + (f"agreement {rec['agreement']:.4f}, "
                   if rec["agreement"] is not None else
                   f"{rec['compared_tokens']} tokens agree "
                   f"({rec['dropped_near_ties']} dropped), ")
                + f"decode step {rec['decode_step_ms']:.3f} ms, "
                f"launches {rec['launches']}, counters {rec['counters']}, "
                f"trace_counts {rec['trace_counts']} [{smi}]")
            del eng
            torch.cuda.empty_cache()
        for site, c in out["host"]["chaos"].items():
            log(f"tiers chaos {site} truncate: counters {c['counters']}, "
                f"recomputed stream agrees on {c['compared_tokens']} tokens "
                f"({c['dropped_near_ties']} dropped) [{smi}]")
        out["worker"] = tier_worker(model, prompts, want[0], smi)
    finally:
        shutil.rmtree(kvt, ignore_errors=True)
    return out


def adapter_bank(cfg):
    """Phase 15b's bank: 4 rows (base + t1..t3), rank 16, all four
    targets, every layer; each tenant's adapter from its own seed."""
    from paddle_tpu_torch.serving.tenancy import (AdapterBank,
                                                  init_adapter_state)
    bank = AdapterBank(cfg, n_adapters=4, rank=ADAPTER_RANK)
    for i, t in enumerate(("t1", "t2", "t3")):
        bank.load(t, init_adapter_state(cfg, ADAPTER_RANK, seed=100 + i,
                                        scale=ADAPTER_SCALE))
    return bank


def merged_reference(model, prompts, bank, tenant, steps):
    """The independent reference of a tenant's streams: an engine with no
    bank prefills on the base weights, then `swap_params` to the tenant's
    merged weights (W + (A B)^T for each adapted `nn.Linear`) before its
    first decode. Returns (streams, top-2 gaps)."""
    import torch
    from paddle_tpu_torch.serving import PagedGenerationEngine
    eng = PagedGenerationEngine(model, device=model.device,
                                capture_logits=True,
                                **dict(TIER_ENGINE, slots=len(prompts)))
    gaps = [[] for _ in prompts]
    sel = eng._select

    def cap(logits, slot):
        gaps[slot].append(float(top2_gaps(logits.float().cpu())[0]))
        return sel(logits, slot)
    eng._select = cap
    rows = [[eng.prefill(s, p)] for s, p in enumerate(prompts)]
    idx = bank.slot_of(tenant)
    merged = dict(eng._params)
    paths = {"qkv": "attn.qkv", "out_proj": "attn.out_proj",
             "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    with torch.no_grad():
        for i in range(bank.num_layers):
            for t in bank.targets:
                name = f"blocks.{i}.{paths[t]}.weight"
                a, b = bank.rows(i, t)
                delta = torch.from_numpy(a[idx] @ b[idx]).to(model.device)
                merged[name] = merged[name] + delta.T
    eng.swap_params(merged)
    for _ in range(steps):
        out = eng.decode()
        g = top2_gaps(eng.last_logits)
        for s in range(len(prompts)):
            rows[s].append(int(out[s]))
            gaps[s].append(float(g[s]))
    return rows, gaps


def near_tie_compare(got, want, gaps, what):
    """`got` against `want` token by token, a row's comparison ending at
    the first step whose reference top-2 gap is below GAP_MIN. Returns
    (compared, dropped)."""
    compared = dropped = 0
    for s, row in enumerate(got):
        for t in range(len(row)):
            if gaps[s][t] < GAP_MIN:
                dropped += len(row) - t
                break
            if row[t] != want[s][t]:
                raise AssertionError(f"{what}: row {s} token {t}: "
                                     f"{row[t]} != {want[s][t]} (gap "
                                     f"{gaps[s][t]:.3e})")
            compared += 1
    return compared, dropped


def hold_tenants(model, prompts, rows, want, refs, what):
    """Base rows against phase 4's streams, tenant rows against their
    merged-weight references. Returns (compared, dropped)."""
    compared = dropped = 0
    for t, (ref, gaps) in refs.items():
        picks = [i for i, x in enumerate(TENANTS) if x == t]
        c, d = near_tie_compare([rows[i] for i in picks], ref, gaps,
                                f"{what} tenant {t}")
        compared, dropped = compared + c, dropped + d
    for i, x in enumerate(TENANTS):
        if x is None:
            c, d = same_stream(model, prompts[i], rows[i], want[i],
                               f"{what} base row {i}")
            compared, dropped = compared + c, dropped + d
    return compared, dropped


def delta_profile(model, prompts, bank):
    """The adapter delta's cost: decode steps of an 8-slot engine with the
    bank attached (slots bound as TENANTS) and of one without, each
    profiled (`profile_steps`), plus the device ms and kernels a step of
    the index (gather) and gemm/bmm (product) kernels over 4 traced
    steps."""
    import torch
    from paddle_tpu_torch.serving import PagedGenerationEngine
    out = {}
    for name, b in (("bank", bank), ("no_bank", None)):
        eng = PagedGenerationEngine(model, device=model.device,
                                    **TIER_ENGINE)
        if b is not None:
            eng.attach_adapters(b)
        for s, p in enumerate(prompts):
            eng.prefill(s, p)
            if b is not None:
                eng.set_slot_adapter(s, b.slot_of(TENANTS[s]))
        rec = profile_steps(eng.decode, 8)
        with card_profile(cpu=False) as prof:
            for _ in range(4):
                eng.decode()
            torch.cuda.synchronize()
        classes = {"index": [0.0, 0.0], "gemm": [0.0, 0.0]}
        for e in device_kernels(prof):
            key = e.key.lower()
            us = getattr(e, "self_device_time_total", None) \
                or getattr(e, "self_cuda_time_total", 0.0)
            for cls, marks in (("index", ("index",)),
                               ("gemm", ("gemm", "bmm", "xmma",
                                         "cutlass"))):
                if any(mk in key for mk in marks):
                    classes[cls][0] += us / 4 / 1e3
                    classes[cls][1] += e.count / 4
        rec["classes_ms_count"] = classes
        rec["capture_counts"] = check_captures(eng, f"phase 15 {name}",
                                               every=False)
        out[name] = rec
        del eng
    return out


def counter_value(key):
    """A port registry counter series now (`name{label=value}`)."""
    from paddle_tpu_torch.observability import metrics
    return metrics.flatten_snapshot(metrics.registry().snapshot(),
                                    kinds=("counter",)).get(key, 0.0)


def tenancy_phase(model, prompts, want, smi, phase4_step_ms):
    """Phase 15b: per-tenant adapters inside the captured decode graph,
    adapter swaps and their fault, rate limiting, the delta's cost."""
    import torch
    from paddle_tpu_torch.observability import decisions, faults
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import (PagedGenerationEngine,
                                          RateLimitedError, Scheduler,
                                          ServingConfig, SpeculativeEngine)
    from paddle_tpu_torch.serving.tenancy import (TenancyConfig,
                                                  TenantSpec,
                                                  init_adapter_state)
    cfg = model.cfg
    bank = adapter_bank(cfg)
    eng = PagedGenerationEngine(model, device=model.device, **TIER_ENGINE)
    eng.attach_adapters(bank)
    capture_s = precompile(eng, "phase 15 tenancy")
    pa.launches = pa.launches_window = pa.launches_prefill = 0
    handles, m, _ = serve(eng, prompts, max_new=32, tenants=TENANTS)
    launches = {"decode": pa.launches - pa.launches_prefill,
                "prefill": pa.launches_prefill}
    if launches["decode"] <= 0 or launches["prefill"] <= 0:
        raise AssertionError(f"phase 15 tenancy: launches {launches}")
    rows = [h.tokens for h in handles]
    if [h.adapter_id for h in handles] != TENANTS:
        raise AssertionError("phase 15: requests bound to adapters "
                             f"{[h.adapter_id for h in handles]}")
    refs = {t: merged_reference(model, [p for p, x in zip(prompts, TENANTS)
                                        if x == t], bank, t, 31)
            for t in ("t1", "t2", "t3")}
    compared, dropped = hold_tenants(model, prompts, rows, want, refs,
                                     "phase 15 tenancy")
    flipped = sum(r != w for r, w, x in zip(rows, want, TENANTS) if x)
    if not flipped:
        raise AssertionError("phase 15: no tenant's delta changed a stream")
    counts = check_captures(eng, "phase 15 tenancy")

    # an adapter swap under live streams, then a refused one
    sched = Scheduler(eng, ServingConfig(max_queue=64), device=eng.device)
    live = [sched.submit(p, max_new_tokens=32, tenant=t)
            for p, t in zip(prompts, TENANTS)]
    while min(len(h.tokens) for h in live) < 8:
        sched.step()
    ev = sched.schedule_adapter_swap("t3", init_adapter_state(
        cfg, ADAPTER_RANK, seed=200, scale=ADAPTER_SCALE))
    sched.run_until_idle()
    if not ev.swap_result["ok"] or ev.swap_result["inflight"] != 8:
        raise AssertionError(f"phase 15: adapter swap {ev.swap_result}")
    keep = {t: refs[t] for t in ("t1", "t2")}
    c2, d2 = hold_tenants(model, prompts, [h.tokens for h in live], want,
                          keep, "phase 15 swap (other rows)")
    failed_key = "serving_adapter_swaps_total{status=failed}"
    failed0 = counter_value(failed_key)
    faults.arm("serving.adapter_swap", "raise")
    try:
        ev = sched.schedule_adapter_swap("t1", init_adapter_state(
            cfg, ADAPTER_RANK, seed=300, scale=ADAPTER_SCALE))
        sched.step()
    finally:
        faults.disarm_all()
    if ev.swap_result["ok"] or counter_value(failed_key) != failed0 + 1:
        raise AssertionError(f"phase 15: faulted swap {ev.swap_result}")
    again = [sched.submit(p, max_new_tokens=32, tenant="t1")
             for p, t in zip(prompts, TENANTS) if t == "t1"]
    sched.run_until_idle()
    sched.close()
    c3, d3 = near_tie_compare([h.tokens for h in again], *refs["t1"],
                              "phase 15 t1 after a refused swap")
    # a rebind mid-stream is a host write
    eng.prefill(0, prompts[6])
    eng.decode()
    eng.set_slot_adapter(0, bank.slot_of("t2"))
    eng.decode()
    eng.reset_slot(0)
    if check_captures(eng, "phase 15 rebind") != counts:
        raise AssertionError("phase 15: a rebind captured a graph")

    # token buckets ahead of shedding
    cost = len(prompts[0]) + 32
    rl = Scheduler(eng, ServingConfig(max_queue=64), device=eng.device,
                   tenancy=TenancyConfig(tenants={"t1": TenantSpec(
                       rate_tokens_per_s=1e-3, burst_tokens=2 * cost)}))
    ok = [rl.submit(prompts[0], max_new_tokens=32, tenant="t1")
          for _ in range(2)]
    try:
        rl.submit(prompts[0], max_new_tokens=32, tenant="t1")
        raise AssertionError("phase 15: the bucket admitted past its burst")
    except RateLimitedError:
        pass
    rl.run_until_idle()
    recs = rl.decision_records()
    errors = decisions.validate_records(recs)
    if errors or [r["action"] for r in recs].count("rate_limit") != 1 or \
            any(h.status != "DONE" for h in ok):
        raise AssertionError(f"phase 15 rate limit: {errors}")
    del eng
    torch.cuda.empty_cache()

    # speculative rounds with the adapters on the verify window
    spec = SpeculativeEngine(model, device=model.device, **SPEC)
    spec.attach_adapters(bank)
    precompile(spec, "phase 15 spec")
    pa.launches = pa.launches_window = pa.launches_prefill = 0
    sh, sm, _ = serve(spec, prompts, max_new=32, tenants=TENANTS)
    window = pa.launches_window
    if window != cfg.num_layers * sm["decode_steps"]:
        raise AssertionError(f"phase 15 spec: {window} window launches")
    spec_counts = check_captures(spec, "phase 15 spec")
    del spec

    def bind(local):
        local.attach_adapters(bank)
        for s, t in enumerate(TENANTS):
            local.set_slot_adapter(s, bank.slot_of(t))
    c4, d4 = stream_parity(model, prompts, [h.tokens for h in sh],
                           dict(TIER_ENGINE, device=model.device), 31,
                           "phase 15 spec with adapters", setup=bind)
    torch.cuda.empty_cache()

    prof = delta_profile(model, prompts, bank)
    b, nb = prof["bank"], prof["no_bank"]
    rec = {"capture_s": capture_s, "capture_counts": counts,
           "launches": launches, "decode_step_ms": m["decode_step_ms"],
           "phase4_decode_step_ms": phase4_step_ms,
           "decode_only_tok_s": decode_only_tok_s(m),
           "compared_tokens": compared, "dropped_near_ties": dropped,
           "tenant_rows_changed": flipped,
           "swap": {"compared_tokens": c2, "dropped_near_ties": d2},
           "refused_swap": {"compared_tokens": c3, "dropped_near_ties": d3},
           "rate_limit_records": len(recs),
           "spec": {"window_launches": window,
                    "prefill_launches": pa.launches_prefill,
                    "round_ms": sm["decode_step_ms"],
                    "acceptance_rate": sm.get("spec_acceptance_rate"),
                    "compared_tokens": c4, "dropped_near_ties": d4,
                    "capture_counts": spec_counts},
           "profile": prof}
    log(f"tenancy: 8 slots (t1, t1, t2, t2, t3, t3, base, base) on one "
        f"captured decode graph (capture counts {counts}), tenant rows "
        f"held to merged-weight engines and base rows to phase 4: "
        f"{compared} tokens agree ({dropped} dropped by the near-tie rule), "
        f"{flipped} of 6 tenant rows differ from phase 4; a swap under 8 "
        f"live streams kept the other rows ({c2} tokens agree), a "
        f"refused swap kept t1's adapter ({c3} tokens agree), a rebind and "
        f"swaps captured nothing, the bucket refused past its burst; spec "
        f"with adapters: {window} window launches, round "
        f"{sm['decode_step_ms']:.3f} ms, {c4} tokens agree with the "
        f"one-token adapted engine ({d4} dropped) [{smi}]")
    log(f"decode step on the host clock: with the bank "
        f"{m['decode_step_ms']:.3f} ms, phase 4 (no bank) "
        f"{phase4_step_ms:.3f} ms; profiled: with the bank "
        f"{b['step_ms_untraced']:.3f} ms untraced, busy "
        f"{b['device_busy_ms_per_step']:.3f} ms over "
        f"{b['kernels_per_step']:.0f} kernels (index {b['classes_ms_count']['index'][1]:.0f} "
        f"in {b['classes_ms_count']['index'][0]:.4f} ms, gemm "
        f"{b['classes_ms_count']['gemm'][1]:.0f} in "
        f"{b['classes_ms_count']['gemm'][0]:.4f} ms); without "
        f"{nb['step_ms_untraced']:.3f} ms untraced, busy "
        f"{nb['device_busy_ms_per_step']:.3f} ms over "
        f"{nb['kernels_per_step']:.0f} kernels (index {nb['classes_ms_count']['index'][1]:.0f} "
        f"in {nb['classes_ms_count']['index'][0]:.4f} ms, gemm "
        f"{nb['classes_ms_count']['gemm'][1]:.0f} in "
        f"{nb['classes_ms_count']['gemm'][0]:.4f} ms) [{smi}]")
    return rec


# ------------------------------------------- ledger and numerics (16)
POISON = "blocks.1.ln1.weight"      # phase 16's NaN drill target
SCALE_ZERO = "blocks.0.mlp.fc1.weight"


def ledger_serving(model, prompts, smi):
    """Phase 16 (a), (b): phase 4's 16 requests twice each through an
    engine with the KV ledger and one without (`kvledger.disable()` as it
    is built), interleaved; the scheduler's host µs a step outside decode,
    the reconciler's µs a check, the events, zero divergences and equal
    streams. Then `serving.kv_ledger_leak` on the ledger engine: the
    reconciler latches the free_list divergence at the boundary of the
    step the leak happened in."""
    import tempfile
    from paddle_tpu_torch.observability import (faults, flight_recorder,
                                                kvledger)
    from paddle_tpu_torch.serving import (PagedGenerationEngine, Scheduler,
                                          ServingConfig)
    engines = {}
    for on in (True, False):
        (kvledger.enable if on else kvledger.disable)()
        try:
            engines[on] = PagedGenerationEngine(model, **SLO_ENGINE,
                                                device=model.device)
        finally:
            kvledger.enable()
        precompile(engines[on], f"phase 16 ledger {on}")
    if engines[False].kv_ledger is not None or \
            engines[True].kv_ledger is None:
        raise AssertionError("phase 16: the ledger switch did not hold")
    runs = {True: [], False: []}
    streams = {True: [], False: []}
    for on in (True, False, True, False):
        eng = engines[on]
        sched = Scheduler(eng, ServingConfig(max_queue=64),
                          device=eng.device)
        ev0 = len(eng.kv_ledger.events) if on else 0
        hs = [sched.submit(p, max_new_tokens=32) for p in prompts]
        over = run_timed(sched)
        if any(h.status != "DONE" or len(h.tokens) != 32 for h in hs):
            raise AssertionError(f"phase 16: ledger {on}: "
                                 f"{[h.status for h in hs]}")
        r = {"sched_host_us": step_host_us(over),
             "decode_step_ms": sched.metrics()["decode_step_ms"]}
        if on:
            recon = sched._kv_reconciler
            if recon is None or recon.divergences:
                raise AssertionError(f"phase 16: divergences "
                                     f"{recon and recon.divergences}")
            r["events"] = len(eng.kv_ledger.events) - ev0
            r["divergences"] = 0
            r["check_us"] = host_us(recon.check, iters=200)
            r["blocks"] = eng.block_pool.num_blocks
        elif sched._kv_reconciler is not None:
            raise AssertionError("phase 16: a reconciler without a ledger")
        runs[on].append(r)
        streams[on].append([h.tokens for h in hs])
    if streams[True] != streams[False]:
        raise AssertionError("phase 16: the ledger changed a stream")
    if engines[True].capture_counts != engines[False].capture_counts:
        raise AssertionError(
            f"phase 16: capture counts {engines[True].capture_counts} vs "
            f"{engines[False].capture_counts}")
    check_captures(engines[True], "phase 16 ledger")
    # (b) the injected leak, caught within one step
    eng = engines[True]
    rec_fr = flight_recorder.get()
    prev_dir = rec_fr.dir
    tmp = tempfile.mkdtemp(prefix="phase16_pm_")
    rec_fr.dir = tmp
    sched = Scheduler(eng, ServingConfig(max_queue=8), device=eng.device)
    spec = faults.arm("serving.kv_ledger_leak", "truncate", nth=1,
                      max_fires=1)
    try:
        hs = [sched.submit(p, max_new_tokens=4) for p in prompts[:2]]
        steps = 0
        while True:
            more = sched.step()
            steps += 1
            if spec.fires:
                break
            if not more:
                raise AssertionError("phase 16: the leak site never fired")
        msgs = list(sched._kv_reconciler.divergences)
        if not any("free_list" in m and "leaked" in m for m in msgs):
            raise AssertionError(f"phase 16: the leak was not latched in "
                                 f"its step: {msgs}")
        sched.run_until_idle()
        pm = sched._kv_reconciler.last_postmortem
        if not (pm and os.path.exists(pm)):
            raise AssertionError("phase 16: no postmortem for the leak")
    finally:
        faults.disarm_all()
        rec_fr.dir = prev_dir
    leak = {"caught_at_step": steps, "divergences": msgs[:2],
            "done": [h.status for h in hs]}
    del engines, eng, sched
    out = {"ledger_on": runs[True], "ledger_off": runs[False],
           "leak": leak, "card": smi}
    on_us = [r["sched_host_us"]["median_us"] for r in runs[True]]
    off_us = [r["sched_host_us"]["median_us"] for r in runs[False]]
    log(f"ledger serving (phase 4's 16 requests, twice each, interleaved): "
        f"scheduler host time a step outside decode, median, ledger on "
        + " / ".join(f"{x:.1f}" for x in on_us) + " us, off "
        + " / ".join(f"{x:.1f}" for x in off_us) + " us; decode step on "
        + " / ".join(f"{r['decode_step_ms']:.3f}" for r in runs[True])
        + " ms, off "
        + " / ".join(f"{r['decode_step_ms']:.3f}" for r in runs[False])
        + f" ms; {runs[True][0]['events']} + {runs[True][1]['events']} "
        f"ledger events, 0 divergences, one reconciler check "
        f"{runs[True][0]['check_us']:.1f} / {runs[True][1]['check_us']:.1f}"
        f" us over {runs[True][0]['blocks']} blocks; streams equal; an "
        f"injected leak latched at step {steps}: {msgs[0][:90]} [{smi}]")
    return out


def numerics_arming(model, prompts, prof4, smi):
    """Phase 16 (c), (d): the decode step profiled on four engines, taps
    disarmed and armed, f32 and int8 KV + int8 weights: kernels a step
    (the disarmed f32 engine's held to phase 4's), device busy ms, the
    taps' device ms (armed minus disarmed), the host µs of one ingest,
    tokens equal to the disarmed engine's, every executable captured
    once, no nonfinite or saturation anomaly. Then the NaN drill on the
    armed f32 engine and the scale_zero drill on the armed int8 one."""
    import tempfile
    import torch
    from paddle_tpu_torch.observability import faults, flight_recorder
    out = {"card": smi}
    kinds = {"f32": {}, "int8": dict(kv_dtype="int8", weight_dtype="int8")}
    keep = {}
    for kind, kw in kinds.items():
        for armed in (False, True):
            sink = []
            name = f"{kind}_{'armed' if armed else 'disarmed'}"
            rec = profile_decode(model, prompts, engine_sink=sink,
                                 numerics_taps=armed, **kw)
            eng, toks = sink
            rec["capture_counts"] = check_captures(eng, f"phase 16 {name}",
                                                   every=False)
            if armed:
                want = keep[f"{kind}_disarmed"][1]
                if [t.tolist() for t in toks] != [t.tolist() for t in want]:
                    raise AssertionError(f"phase 16 {name}: tokens differ "
                                         f"from the disarmed engine's")
            keep[name] = (eng, toks)
            out[name] = rec
    # the decode step on the host clock, the four engines alternating (3
    # rounds of 10 steps each), with each ingest timed on the armed ones
    ingest = {name: [] for name in keep}
    steps_ms = {name: [] for name in keep}
    for name, (eng, _) in keep.items():
        if eng.numerics_monitor is not None:
            real = eng._ingest_numerics

            def timed(sink, real=real, acc=ingest[name]):
                t0 = time.perf_counter()
                real(sink)
                acc.append(time.perf_counter() - t0)
            eng._ingest_numerics = timed
    for _ in range(3):
        for name, (eng, _) in keep.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(10):
                eng.decode()
            steps_ms[name].append((time.perf_counter() - t0) / 10 * 1e3)
    for name, (eng, _) in keep.items():
        rec = out[name]
        rec["step_ms_alternating"] = steps_ms[name]
        if eng.numerics_monitor is None:
            continue
        del eng._ingest_numerics
        mon = eng.numerics_monitor
        bad = {k: v for k, v in mon.counts().items()
               if not k.endswith(":drift")}
        if bad:
            raise AssertionError(f"phase 16 {name}: anomalies {bad}")
        xs = sorted(ingest[name])
        rec.update(monitor_counts=mon.counts(), monitor_total=mon.total(),
                   sites=eng.last_numerics,
                   ingest_us_median=xs[len(xs) // 2] * 1e6)
    k4 = prof4["kernels_per_step"]
    if abs(out["f32_disarmed"]["kernels_per_step"] - k4) >= 1:
        diff = kernel_diff(prof4, out["f32_disarmed"])
        raise AssertionError(
            f"phase 16: the disarmed decode step runs "
            f"{out['f32_disarmed']['kernels_per_step']} kernels, phase 4 "
            f"{k4}; counts in 8 steps (phase 4, phase 16) of the kernels "
            f"that differ: "
            + "; ".join(f"{n4}, {n16}: {k[:120]}"
                        for k, (n4, n16) in diff.items()))
    for kind in kinds:
        a, d = out[f"{kind}_armed"], out[f"{kind}_disarmed"]
        out[f"{kind}_taps_device_ms"] = (a["device_busy_ms_per_step"]
                                         - d["device_busy_ms_per_step"])
        out[f"{kind}_taps_kernels"] = (a["kernels_per_step"]
                                       - d["kernels_per_step"])
    # (d) the NaN drill on the armed f32 engine
    rec_fr = flight_recorder.get()
    prev_dir = rec_fr.dir
    tmp = tempfile.mkdtemp(prefix="phase16_pm_")
    rec_fr.dir = tmp
    try:
        eng = keep["f32_armed"][0]
        faults.arm("numerics.corrupt", mode="nan", nth=1, max_fires=1,
                   target=POISON)
        t0 = time.perf_counter()
        try:
            eng.decode()
        finally:
            faults.disarm_all()
        drill_s = time.perf_counter() - t0
        mon, loc = eng.numerics_monitor, eng.last_localization
        if mon.counts().get("decode.logits:nonfinite", 0) < 1 or \
                loc is None or loc["first_unhealthy_layer"] != 1 or \
                not (mon.bundle_path and os.path.exists(mon.bundle_path)):
            raise AssertionError(f"phase 16: NaN drill {mon.counts()}, "
                                 f"{loc}, bundle {mon.bundle_path}")
        if not bool(torch.isfinite(eng._params[POISON]).all()):
            raise AssertionError("phase 16: the prefill masters were "
                                 "poisoned")
        counts = check_captures(eng, "phase 16 NaN drill", every=False)
        probes = eng.trace_counts.get("numerics_probe", 0)
        if counts.get("decode") != 1 or probes < 1:
            raise AssertionError(f"phase 16: captures {counts}, probes "
                                 f"{probes}")
        out["nan_drill"] = {"counts": mon.counts(), "localization": loc,
                            "probes": probes, "decode_call_s": drill_s,
                            "capture_counts": counts}
        # the scale_zero drill on the armed int8 engine
        eng = keep["int8_armed"][0]
        faults.arm("numerics.corrupt", mode="scale_zero", nth=1,
                   max_fires=1, target=SCALE_ZERO)
        try:
            eng.decode()
        finally:
            faults.disarm_all()
        kinds8 = eng.numerics_monitor.counts()
        if kinds8.get("weights.scale:drift", 0) < 1:
            raise AssertionError(f"phase 16: scale_zero drill {kinds8}")
        out["scale_zero_drill"] = {"counts": kinds8}
    finally:
        rec_fr.dir = prev_dir
    del keep
    for kind in kinds:
        d, a = out[f"{kind}_disarmed"], out[f"{kind}_armed"]
        log(f"numerics taps {kind}: decode step "
            + " / ".join(f"{x:.3f}" for x in d["step_ms_alternating"])
            + " ms disarmed, "
            + " / ".join(f"{x:.3f}" for x in a["step_ms_alternating"])
            + f" ms armed (host clock, alternating; profiled "
            f"{d['step_ms_untraced']:.3f} / {a['step_ms_untraced']:.3f}), "
            f"device busy {d['device_busy_ms_per_step']:.3f}"
            f" / {a['device_busy_ms_per_step']:.3f} ms, kernels a step "
            f"{d['kernels_per_step']:.0f} / {a['kernels_per_step']:.0f}, "
            f"the taps {out[kind + '_taps_device_ms']:.4f} ms of device "
            f"time, one ingest {a['ingest_us_median']:.1f} us (median), "
            f"monitor {a['monitor_counts'] or 'clean'}; tokens equal; "
            f"capture counts {a['capture_counts']} [{smi}]")
    log(f"numerics NaN drill ({POISON}): {out['nan_drill']['counts']}, "
        f"localized to layer "
        f"{out['nan_drill']['localization']['first_unhealthy_layer']} in "
        f"{out['nan_drill']['probes']} eager probes, decode captured once, "
        f"the poisoned step {drill_s * 1e3:.1f} ms with the localizer; "
        f"scale_zero drill ({SCALE_ZERO}): "
        f"{out['scale_zero_drill']['counts']} [{smi}]")
    log(f"phase 4's decode step: {k4:.0f} kernels (phase 16 disarmed "
        f"{out['f32_disarmed']['kernels_per_step']:.0f})")
    return out


# ------------------------------------------- the device profile and cost model
PROFILE_ENGINE = dict(slots=8, max_len=1024, block_size=16,
                      attention_impl="kernel")
CAPTURE_STEPS = 8           # phase 17 (a): decode steps in the capture
PROFILE_AGREE = 0.05        # ... its device ms a step against profile_steps
FLOPS_RTOL = 0.15           # (b): the estimate against step_flops


def op_costs(report):
    """{op: predicted ms} of a cost report (eager kernels join by name)."""
    return {k: 1e3 * report.device.roofline_s(c.flops, c.bytes)
            for k, c in report.by_op.items()}


def graph_costs(report):
    """`op_costs` for a capture of CUDA graph replays: their kernels carry
    no aten op, and every product kernel of a replay is attributed
    `aten::mm` (deviceprof's name table), so the step's products
    (`aten::mm` and `aten::addmm`) join as one."""
    per_op = op_costs(report)
    per_op["aten::mm"] = sum(per_op.pop(k, 0.0)
                             for k in ("aten::mm", "aten::addmm"))
    return per_op


def check_record(rec, what, steps):
    """A joined deviceprof record: valid, reconciled, on one stream."""
    from paddle_tpu_torch.observability import deviceprof
    errs = deviceprof.validate_record(rec)
    if errs:
        raise AssertionError(f"{what}: invalid record: {errs}")
    join = rec["join"]
    if join["steps"] != steps or not join["reconciles"]:
        raise AssertionError(f"{what}: join over {join['steps']} steps, "
                             f"device {join['device_ms_per_step']} ms a "
                             f"step against wall {join['wall_ms_per_step']}")
    if len(rec["planes"]) != 1:
        raise AssertionError(f"{what}: {len(rec['planes'])} device lines "
                             f"{rec['planes']}: the window is not one "
                             "stream, so its summed device time is no "
                             "busy time")


def by_prim(rec):
    """[(op, measured ms a step, predicted ms, efficiency)] of the joined
    ops, largest first: each op's prediction against the sum of its rows
    (a row's own efficiency holds the whole op's prediction against one
    of its kernels)."""
    agg = {}
    for row in rec["join"]["per_op"]:
        if row["predicted_ms"] is not None:
            agg.setdefault(row["prim"], [0.0, row["predicted_ms"]])[0] += \
                row["measured_ms_per_step"]
    return sorted(((p, m, pred, pred / m if m else None)
                   for p, (m, pred) in agg.items()), key=lambda t: -t[1])


def log_record(what, rec, smi, top=10):
    join = rec["join"]
    log(f"deviceprof {what}: device {join['device_ms_per_step']:.4f} ms a "
        f"step over {join['steps']} steps, wall "
        f"{join['wall_ms_per_step']:.4f} ms (ratio "
        f"{join['device_wall_ratio']}), {rec['n_events']} events, "
        f"coverage {join['coverage']:.4f}, modules "
        f"{ {k: round(v, 3) for k, v in list(rec['modules'].items())[:4]} } "
        f"[{smi}]")
    for row in join["per_op"][:top]:
        eff = row["efficiency"]
        log(f"  {row['measured_ms_per_step']:.4f} ms a step "
            f"{100 * row['device_frac']:.1f}% {row['op'][:48]} "
            f"[{row['prim']}] predicted {row['predicted_ms']} ms, "
            f"efficiency {'-' if eff is None else f'{eff:.4f}'}")
    log("  by op: " + ", ".join(
        f"{p} {m:.4f} ms / predicted {pred:.4f} ({eff:.3f})"
        for p, m, pred, eff in by_prim(rec)[:8]))


def serving_profile(model, prompts, want, smi, out_dir):
    """Phase 17 (a): phase 4's engine and requests under a `Scheduler`
    with `capture_decode_steps(8)` armed; the record joined to the cost
    model's decode step (f32 on fake tensors, `h100-sxm-fp32`), held to
    `profile_steps` on the same engine."""
    import torch
    from paddle_tpu_torch import cost_model
    from paddle_tpu_torch.observability import deviceprof
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import (PagedGenerationEngine, Scheduler,
                                          ServingConfig)
    from paddle_tpu_torch.text.models import gpt_125m
    eng = PagedGenerationEngine(model, **PROFILE_ENGINE, device="cuda")
    precompile(eng, "phase 17")
    counts = check_captures(eng, "phase 17")
    sched = Scheduler(eng, ServingConfig(max_queue=64), device=eng.device)
    ctrl = sched.capture_decode_steps(steps=CAPTURE_STEPS, out_dir=out_dir)
    handles = [sched.submit(p, max_new_tokens=32) for p in prompts]
    sched.step()                        # the first decode: never captured
    if ctrl.state != "armed":
        raise AssertionError(f"phase 17: the capture is {ctrl.state} "
                             "after the first decode step")
    t0 = time.perf_counter()
    sched.run_until_idle()
    serve_s = time.perf_counter() - t0
    sched.close()
    block = sched.last_capture or {}
    if ctrl.state != "reported" or block.get("state") != "reported":
        raise AssertionError(f"phase 17: capture {ctrl.state}: {block}")
    if check_captures(eng, "phase 17 after the window") != counts:
        raise AssertionError("phase 17: a graph was captured in the window")
    dropped = 0
    for i, h in enumerate(handles):
        if h.status != "DONE":
            raise AssertionError(f"phase 17: request {i} {h.status}")
        dropped += same_stream(model, prompts[i], h.tokens, want[i],
                               f"phase 17 request {i}")[1]
    rec = deviceprof.load_records(block["jsonl"])[-1]
    # the cost model's decode step: the same engine on fake tensors
    t0 = time.perf_counter()
    cpu_model = gpt_125m(device="cpu", seed=0)
    with cost_model.fake_mode():
        fake = PagedGenerationEngine(cpu_model, **PROFILE_ENGINE,
                                     device="cpu")
        est = cost_model.estimate(fake._decode_fn, device="h100-sxm-fp32")
    del cpu_model, fake
    estimate_s = time.perf_counter() - t0
    deviceprof.join_cost_model(rec, graph_costs(est), steps=CAPTURE_STEPS,
                               wall_step_ms=rec["join"]["wall_ms_per_step"])
    check_record(rec, "phase 17 (a)", CAPTURE_STEPS)
    paged = [o for o in rec["ops"] if o["op"] == "paged_decode_kernel"]
    if len(paged) != 1 or paged[0]["prim"] != "paged_attention" or \
            paged[0]["calls"] != model.cfg.num_layers * CAPTURE_STEPS:
        raise AssertionError(f"phase 17: paged rows {paged}, want one "
                             f"paged_attention row of "
                             f"{model.cfg.num_layers * CAPTURE_STEPS} calls")
    # profile_steps on the same engine, the first wave's prompts again
    for s, p in enumerate(prompts[:eng.config.slots]):
        eng.prefill(s, p)
    pa.launches = 0
    prof = profile_steps(lambda: eng.decode().copy(), CAPTURE_STEPS)
    check_captures(eng, "phase 17 profile")
    dev = rec["join"]["device_ms_per_step"]
    busy = prof["device_busy_ms_per_step"]
    diff = kernel_rows_diff(rec, prof, CAPTURE_STEPS)
    # neither window lost an event: the first step's upload and first
    # kernels go unrecorded when a session opens straight away
    # (start_session)
    if rec["n_events"] != CAPTURE_STEPS * prof["kernels_per_step"]:
        raise AssertionError(
            f"phase 17: the capture holds {rec['n_events']} device events, "
            f"profile_steps {prof['kernels_per_step']} a step ({busy} ms "
            f"against the capture's {dev}); kernels (capture ms, profile "
            f"ms, calls, calls a step): {diff}")
    if abs(dev - busy) > PROFILE_AGREE * busy:
        raise AssertionError(f"phase 17: the capture reads {dev} ms a step, "
                             f"profile_steps {busy} ms; kernels (capture "
                             f"ms, profile ms, calls, calls a step): {diff}")
    del eng
    torch.cuda.empty_cache()
    out = {"record": block["jsonl"], "trace": rec["xplane"],
           "device_ms_per_step": dev, "wall_ms_per_step":
           rec["join"]["wall_ms_per_step"], "profile_busy_ms": busy,
           "profile_kernels_per_step": prof["kernels_per_step"],
           "n_events": rec["n_events"], "coverage": rec["join"]["coverage"],
           "paged_calls": paged[0]["calls"],
           "estimate_flops": est.total_flops, "estimate_ms": est.time_ms,
           "estimate_s": estimate_s, "serve_s": serve_s,
           "dropped_near_ties": dropped, "capture_counts": counts,
           "top": rec["join"]["per_op"][:10], "by_op": by_prim(rec),
           "modules": rec["modules"], "card": smi}
    log_record("serving decode step (phase 4's engine, 8 steps)", rec, smi)
    log(f"  profile_steps on the same engine: busy {busy:.4f} ms a step "
        f"over {prof['kernels_per_step']:.0f} kernels; the capture "
        f"{dev:.4f} ms ({100 * (dev - busy) / busy:+.2f}%); paged decode "
        f"{paged[0]['calls']} calls; estimate {est.total_flops:.4e} flops, "
        f"{est.time_ms:.4f} ms at h100-sxm-fp32 in {estimate_s:.1f} s; "
        f"streams held to phase 4 ({dropped} dropped by the near-tie rule); "
        f"the kernels that differ most (capture ms, profile ms, calls, "
        f"calls a step): {diff} [{smi}]")
    return out


def train_profile(smi, out_dir, B=8, iters=3, warmup=3):
    """Phase 17 (b), (c): phase 8's GPT-350M bf16 step under
    `deviceprof.capture(iters=3)`, joined to `cost_model.estimate` of the
    same step on fake tensors (`h100-sxm`); then `Profiler(scheduler=(1,
    3))` around five steps: summary, analyze, the timeline JSONL."""
    import contextlib
    import io
    import numpy as np
    import torch
    from paddle_tpu_torch import cost_model
    from paddle_tpu_torch.observability import deviceprof
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.parallel import GPTSpmdConfig, make_train_step
    from paddle_tpu_torch.profiler import Profiler
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import perf_report
    cfg = GPTSpmdConfig(**TRAIN_350M, param_dtype="bfloat16",
                        compute_dtype="bfloat16", remat=False)
    S = cfg.max_seq_len
    step_fn, init_fn = make_train_step(cfg, learning_rate=2e-4,
                                       device="cuda")
    params, state = init_fn(0)
    n_params = sum(p.numel() for p in params.values())
    rng = np.random.RandomState(0)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).cuda()
    labs = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).cuda()
    for _ in range(warmup):
        step_fn(params, state, toks, labs)
    torch.cuda.synchronize()
    fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
    t0 = time.perf_counter()
    _, rec = deviceprof.capture(lambda: step_fn(params, state, toks, labs),
                                os.path.join(out_dir, "train"), iters=iters,
                                label="train")
    capture_s = time.perf_counter() - t0
    # the cost model: the same step on fake CPU tensors of the same shapes
    t0 = time.perf_counter()
    step_cpu, init_cpu = make_train_step(cfg, learning_rate=2e-4,
                                         device="cpu")
    with cost_model.fake_mode():
        fparams, fstate = init_cpu(0)
        ftoks = torch.zeros((B, S), dtype=torch.int64)
        est = cost_model.estimate(step_cpu, fparams, fstate, ftoks, ftoks,
                                  device="h100-sxm")
    estimate_s = time.perf_counter() - t0
    deviceprof.join_cost_model(rec, op_costs(est), steps=iters)
    deviceprof.write_record(rec, os.path.join(out_dir, "train",
                                              "deviceprof.jsonl"))
    check_record(rec, "phase 17 (b)", iters)
    flops = step_flops(cfg, n_params, B, S)
    if abs(est.total_flops - flops) > FLOPS_RTOL * flops:
        raise AssertionError(f"phase 17: estimate {est.total_flops:.4e} "
                             f"flops a step, step_flops {flops:.4e}")
    flash = {}
    for o in rec["ops"]:
        if o["prim"] and o["prim"].startswith("flash_attention_"):
            flash[o["op"]] = o["calls"] / iters
    launches = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    if sorted(flash.values()) != [cfg.layers] * 3 or \
            launches != (iters * cfg.layers,) * 3:
        raise AssertionError(f"phase 17: flash rows {flash} a step, "
                             f"launches {launches}, want {cfg.layers} each")
    log_record(f"train step (GPT-350M bf16, B={B}, S={S})", rec, smi)
    log(f"  estimate {est.total_flops:.4e} flops a step against "
        f"step_flops {flops:.4e} ({100 * (est.total_flops / flops - 1):+.2f}"
        f"%), {est.time_ms:.3f} ms at h100-sxm in {estimate_s:.1f} s; "
        f"flash rows {flash} a step; capture {capture_s:.1f} s [{smi}]")
    out = {"record": rec, "by_op": by_prim(rec),
           "estimate_flops": est.total_flops,
           "step_flops": flops, "estimate_ms": est.time_ms,
           "estimate_table": est.table(20), "estimate_s": estimate_s,
           "capture_s": capture_s, "flash_calls_per_step": flash,
           "card": smi}
    # (c) the Profiler's windows around five steps
    timeline = os.path.join(out_dir, "profiler_timeline.jsonl")
    if os.path.exists(timeline):
        os.remove(timeline)
    t0 = time.perf_counter()
    prof = Profiler(scheduler=(1, 3), timeline=timeline, record_shapes=True,
                    log_dir=os.path.join(out_dir, "profiler"),
                    device="cuda")
    with prof:
        for _ in range(5):
            loss, _, _ = step_fn(params, state, toks, labs)
            float(loss)
            prof.step()
    if prof.device_error or prof.last_trace is None:
        raise AssertionError(f"phase 17: the Profiler window recorded no "
                             f"device side: {prof.device_error}")
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        prof.summary()
    report = prof.analyze()
    records = perf_report.load_timeline(timeline)
    summary = text.getvalue()
    with open(os.path.join(out_dir, "profiler_summary.txt"), "w") as f:
        f.write(summary + "\n" + report.render() + "\n")
    if "Overview Summary" not in summary or report.coverage <= 0 or \
            len(records) != 2:
        raise AssertionError(f"phase 17: Profiler summary "
                             f"{len(summary)} chars, coverage "
                             f"{report.coverage}, {len(records)} timeline "
                             "records")
    out["profiler"] = {"coverage": report.coverage,
                       "phases_ms": report.phases,
                       "step_ms": [r["step_ms"] for r in records],
                       "top_gaps": [r["name"] for r in report.top_gaps],
                       "seconds": time.perf_counter() - t0}
    log(f"profiler (1, 3) over 5 steps: timeline steps "
        f"{[r['step'] for r in records]} at {out['profiler']['step_ms']} "
        f"ms, phases {report.phases} ms, coverage {report.coverage:.4f}, "
        f"top gaps {out['profiler']['top_gaps']}, "
        f"{out['profiler']['seconds']:.1f} s [{smi}]")
    for line in summary.splitlines()[:8]:
        log("  " + line)
    return out


WARM_ENGINE = dict(slots=8, max_len=1024, block_size=16,
                   attention_impl="kernel")
WARM_CHILD_S = 600          # one Predictor process, a cold build included

# phase 18's child: a fresh process that serves the artifact through the
# user's entry points and prints one PHASE18 JSON line
WARM_CHILD = r"""
import json, sys, time
t0 = time.perf_counter()
import torch
t_torch = time.perf_counter()
from paddle_tpu_torch.inference import Config, create_predictor
from paddle_tpu_torch.observability import metrics
from paddle_tpu_torch.ops import paged_attention as pa
from paddle_tpu_torch._kernels import build
t1 = time.perf_counter()
artifact, prompts_path, max_new = sys.argv[1], sys.argv[2], int(sys.argv[3])
with open(prompts_path) as f:
    prompts = json.load(f)
pred = create_predictor(Config(artifact))
torch.cuda.synchronize()
t2 = time.perf_counter()
eng = pred.engine
pa.launches = pa.launches_window = pa.launches_prefill = 0
streams = pred.generate(prompts, max_new_tokens=max_new)
torch.cuda.synchronize()
t3 = time.perf_counter()
print("PHASE18 " + json.dumps({
    "import_s": t1 - t0, "import_torch_s": t_torch - t0,
    "load_to_ready_s": t2 - t1,
    "stages": pred.ready_stages,
    "executable_ready_s": metrics.registry().gauge(
        "predictor_executable_ready_seconds").value,
    "first_ttft_s": pred.last_ttft_s[0], "generate_s": t3 - t2,
    "report": pred.precompile_report, "stats": eng._compile_cache.stats,
    "cache_dir": eng._compile_cache.root,
    "nvcc_reachable": build._find_nvcc() is not None,
    "capture_counts": eng.capture_counts,
    "launches": pa.launches, "launches_prefill": pa.launches_prefill,
    "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    "streams": streams}), flush=True)
"""


def warm_child(artifact, prompts_path, max_new, env, log_path):
    """Run WARM_CHILD on `artifact`; returns (its PHASE18 record, the
    parent's seconds from spawn to exit)."""
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-c", WARM_CHILD, artifact,
                        prompts_path, str(max_new)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=WARM_CHILD_S)
    wall = time.perf_counter() - t0
    with open(log_path, "w") as f:
        f.write(r.stdout + "\n--- stderr ---\n" + r.stderr)
    lines = [ln for ln in r.stdout.splitlines() if ln.startswith("PHASE18 ")]
    if r.returncode != 0 or not lines:
        raise AssertionError(f"phase 18 child exited {r.returncode}:\n"
                             f"{r.stderr[-3000:]}")
    return json.loads(lines[-1][len("PHASE18 "):]), wall


def no_compiler_env():
    """This environment with every PATH entry holding nvcc removed and
    CUDA_HOME pointed at a directory that does not exist."""
    env = dict(os.environ)
    env["PATH"] = os.pathsep.join(
        d for d in env.get("PATH", "").split(os.pathsep)
        if d and not os.path.exists(os.path.join(d, "nvcc")))
    env["CUDA_HOME"] = os.path.join(ROOT, "chiprun_out", "no-cuda-home")
    return env


PAR_ENGINE = dict(slots=8, max_len=1024, block_size=16,
                  attention_impl="kernel")
PAR_ARMS = (            # (name, engine kind, config, prompt range, streams)
    ("pp2", "pp", dict(pp=2, decode_microbatches=2), slice(0, 16), "p4"),
    ("tp2", "tp", dict(tp=2), slice(0, 16), "p4"),
    ("tp2pp2", "pp", dict(pp=2, tp=2, decode_microbatches=2), slice(0, 16),
     "p4"),
    ("tp2pp2_int8", "pp", dict(pp=2, tp=2, decode_microbatches=2,
                               kv_dtype="int8"), slice(8, 12), "p5"),
    ("spec_pp2", "spec_pp", dict(pp=2, decode_microbatches=2, gamma=4,
                                 draft_layers=2), slice(0, 16), "pp2"))


def parallel_arm(model, name, kind, kw, prompts, want, smi, max_new=32,
                 profile_prompts=None):
    """One arm of phase 19: an engine of `kind` over phase 4's model,
    precompiled, serving `prompts` through the Scheduler; holds the
    streams to `want`, the captures, the shards' heads and devices, the
    paged launches a forward, the bubble gauge and the shards' pool
    bytes; with `profile_prompts`, profiles 8 decode steps (rounds) of
    the engine holding them (`profile_steps`). Returns (record,
    streams)."""
    import gc
    import torch
    from paddle_tpu_torch.observability import metrics
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import make_engine
    what = f"phase 19 {name}"
    cfg = model.cfg
    engine = make_engine(model, kind, dict(PAR_ENGINE, **kw),
                         device=model.device)
    c = engine.config
    tp, pp = c.tp, getattr(c, "pp", 1)
    M = getattr(c, "decode_microbatches", 1)
    capture_s = precompile(engine, what)
    pa.launches = pa.launches_window = pa.launches_prefill = 0
    handles, m, wall = serve(engine, prompts, max_new)
    launches = {"all": pa.launches, "window": pa.launches_window,
                "prefill": pa.launches_prefill}
    counts = check_captures(engine, what)
    got = [h.tokens for h in handles]
    for i, (g, w) in enumerate(zip(got, want)):
        if g != w:
            t = next(j for j in range(len(w)) if g[j] != w[j])
            gap = next_token_gap(model, list(prompts[i]) + list(w[:t]))
            raise AssertionError(
                f"{what}: request {i} departs at token {t}: {g[t]} != "
                f"{w[t]}; the single-device engine's top-2 gap there is "
                f"{gap:.3e}")
    # heads/tp a shard, each shard on the card
    report = engine.kv_shard_report()
    heads = {r["heads"] for r in report.values()}
    devices = {r["device"] for r in report.values()}
    if len(report) != tp * pp or heads != {cfg.num_heads // tp} or \
            devices != {str(engine.device)}:
        raise AssertionError(f"{what}: shards {report}")
    # num_layers * tp paged launches a forward: a decode step is M
    # microbatch forwards (a speculative round verifies M windows), a
    # prefill one forward (one chunk)
    prefills = len(prompts) + m["requests"]["serving.preempted"]
    per = cfg.num_layers * tp
    steps = m["decode_steps"] * M
    want_l = {"window": per * steps if kind == "spec_pp" else 0,
              "prefill": per * prefills}
    want_l["all"] = per * (steps + prefills)
    if launches != want_l:
        raise AssertionError(f"{what}: paged launches {launches}, want "
                             f"{want_l} ({per} a forward over {steps} "
                             f"decode forwards and {prefills} prefills)")
    rec = {"kind": kind, "config": c.as_dict(), "requests": len(prompts),
           "max_new_tokens": max_new, "decode_step_ms": m["decode_step_ms"],
           "decode_steps": m["decode_steps"], "prefills": prefills,
           "ttft_s_mean": sum(h.ttft_s for h in handles) / len(handles),
           "ttft_s_max": max(h.ttft_s for h in handles),
           "launches": launches, "launches_per_forward": per,
           "capture_counts": counts, "capture_s": capture_s,
           "shards": report, "wall_s": wall, "card": smi}
    if profile_prompts is not None:
        for slot, p in enumerate(profile_prompts):
            engine.prefill(slot, p)
        call = engine.decode_many if kind == "spec_pp" else engine.decode
        rec["profile"] = profile_steps(call, 8)
        pr = rec["profile"]
        log(f"phase 19 {name} profiled: {pr['step_ms_untraced']:.3f} ms a "
            f"{'round' if kind == 'spec_pp' else 'step'} (traced "
            f"{pr['step_ms_traced']:.3f}), device busy "
            f"{pr['device_busy_ms_per_step']:.3f} ms, idle share "
            f"{pr['device_idle_share_untraced']:.3f}, "
            f"{pr['kernels_per_step']:.0f} kernels and "
            f"{pr['paged_launches_per_step']:.0f} paged launches "
            f"({pr['paged_ms_per_step']:.4f} ms) a step; top "
            f"{[(t['name'][:32], round(t['ms_per_step'], 4), t['count']) for t in pr['top'][:4]]} [{smi}]")
        for slot in range(len(profile_prompts)):
            engine.reset_slot(slot)
    if pp > 1:
        # the bubble over a decode window: (pp-1)/(M+pp-1)
        engine.reset_pp_stats()
        for _ in range(2):
            engine.decode()
        gauge = metrics.flatten_snapshot(
            metrics.registry().snapshot(), kinds=("gauge",))[
            "serving_pp_bubble_fraction"]
        if abs(gauge - (pp - 1) / (M + pp - 1)) > 1e-12:
            raise AssertionError(f"{what}: bubble gauge {gauge}, want "
                                 f"{(pp - 1) / (M + pp - 1)}")
        rec["bubble_fraction"] = gauge
        rec["stage_report"] = engine.stage_report()
    # each shard's pool bytes: the single pool's over tp*pp
    acc = engine.hbm_accounting()
    pool = engine._kv_block_bytes() * c.num_blocks
    kv = {n: r["kv"] for n, r in acc["per_shard"].items() if n != "draft"}
    if set(kv.values()) != {pool // (tp * pp)}:
        raise AssertionError(f"{what}: shard pool bytes {kv}, want "
                             f"{pool // (tp * pp)} each")
    rec["hbm"] = acc
    log(f"phase 19 {name} ({kind} {dict(kw)}): {len(prompts)} requests, "
        f"streams equal, decode step {m['decode_step_ms']:.3f} ms, TTFT "
        f"mean {rec['ttft_s_mean'] * 1e3:.2f} ms max "
        f"{rec['ttft_s_max'] * 1e3:.2f} ms, paged launches {launches} "
        f"({per} a forward), captures {len(counts)} (1 each) in "
        f"{capture_s:.2f} s, bubble {rec.get('bubble_fraction', 0.0):.4f}, "
        f"shards "
        f"{ {k: (v['device'], v['heads']) for k, v in report.items()} }, "
        f"shard KV {pool // (tp * pp) / 2**20:.1f} MiB each [{smi}]")
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return rec, got


def parallel_phase(prompts, want4, want5, smi):
    """Phase 19: the tensor-, pipeline- and spec x pipeline-parallel
    engines on one card (module docstring). `want4`: phase 4's streams of
    the 16 prompts; `want5`: phase 5's of prompts 8-11."""
    from paddle_tpu_torch.text.models import gpt_125m
    model = gpt_125m(device="cuda", seed=0)
    # {prompt index: stream} of phases 4 and 5 and of each arm
    streams = {"p4": dict(enumerate(want4)),
               "p5": {8 + i: w for i, w in enumerate(want5)}}
    out = {"arms": {}}
    launches = {"paged_attention": 0, "paged_attention_int8": 0,
                "paged_attention_window": 0, "paged_attention_prefill": 0}
    # the single-device decode step beside the arms' (phase 4's engine)
    base = profile_decode(model, prompts[8:16])
    out["profile_single"] = base
    log(f"phase 19 single-device profiled: {base['step_ms_untraced']:.3f} "
        f"ms a step, device busy {base['device_busy_ms_per_step']:.3f} ms, "
        f"{base['kernels_per_step']:.0f} kernels a step [{smi}]")
    for name, kind, kw, sl, ref in PAR_ARMS:
        idx = range(sl.start, sl.stop)
        rec, got = parallel_arm(
            model, name, kind, kw, prompts[sl],
            [streams[ref][i] for i in idx], smi,
            profile_prompts=None if "int8" in name else prompts[8:16])
        streams[name] = dict(zip(idx, got))
        out["arms"][name] = rec
        la = rec["launches"]
        decode = la["all"] - la["window"] - la["prefill"]
        launches["paged_attention_int8" if kw.get("kv_dtype") == "int8"
                 else "paged_attention"] += decode
        launches["paged_attention_window"] += la["window"]
        launches["paged_attention_prefill"] += la["prefill"]
    out["launches"] = launches
    log(f"phase 19 paged launches by kernel: {launches} [{smi}]")
    return out


def warm_start(prompts, want, smi, max_new=32):
    """Phase 18: phase 4's GPT-125M saved with `save_for_generation`, then
    served by `inference.create_predictor` in a cold and a warm process."""
    import shutil
    from paddle_tpu_torch.serving import (PagedEngineConfig,
                                          default_compile_cache_dir,
                                          save_for_generation)
    from paddle_tpu_torch.text.models import gpt_125m
    out = os.path.join(ROOT, "chiprun_out", "phase18")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    artifact = os.path.join(out, "gpt125m")
    cache_dir = default_compile_cache_dir(artifact)
    try:
        model = gpt_125m(device="cuda", seed=0)
        cfg = PagedEngineConfig(**WARM_ENGINE)
        t0 = time.perf_counter()
        save_for_generation(model, artifact, engine_config=cfg)
        save_s = time.perf_counter() - t0
        del model
        with open(artifact + ".gencfg") as f:
            rec = json.load(f)["serving"]
        if rec["config"] != cfg.as_dict() or rec["engine"] != "paged":
            raise AssertionError(f"phase 18: .gencfg records {rec}, want "
                                 f"paged {cfg.as_dict()}")
        if os.path.exists(cache_dir) and os.listdir(cache_dir):
            raise AssertionError("phase 18: the artifact's compile cache "
                                 "is not empty before the cold child")
        prompts_path = os.path.join(out, "prompts.json")
        with open(prompts_path, "w") as f:
            json.dump(prompts, f)
        runs = {}
        for what, env in (("cold", dict(os.environ)),
                          ("warm", no_compiler_env())):
            rec_c, wall = warm_child(artifact, prompts_path, max_new, env,
                                     os.path.join(out, f"{what}.log"))
            rec_c["spawn_to_exit_s"] = wall
            runs[what] = rec_c
        names = rec["executables"]
        for what, want_how in (("cold", "miss"), ("warm", "hit")):
            r = runs[what]
            if r["report"] != dict.fromkeys(names, want_how):
                raise AssertionError(f"phase 18 {what}: precompile "
                                     f"reported {r['report']}")
            if r["cache_dir"] != os.path.abspath(cache_dir):
                raise AssertionError(f"phase 18 {what}: cache "
                                     f"{r['cache_dir']}, want {cache_dir}")
            if r["streams"] != want:
                bad = [i for i, (a, b) in enumerate(zip(r["streams"], want))
                       if a != b]
                raise AssertionError(f"phase 18 {what}: streams differ from "
                                     f"phase 4's at requests {bad}")
            if r["launches"] <= 0 or r["launches_prefill"] <= 0:
                raise AssertionError(f"phase 18 {what}: paged launches "
                                     f"{r['launches']} ({r['launches_prefill']}"
                                     " on the tile path)")
            if r["capture_counts"] != dict.fromkeys(names, 1):
                raise AssertionError(f"phase 18 {what}: capture counts "
                                     f"{r['capture_counts']}")
        cold, warm = runs["cold"], runs["warm"]
        if cold["stats"]["misses"] < 1 or cold["stats"]["hits"] != 0:
            raise AssertionError(f"phase 18 cold: cache {cold['stats']}")
        if warm["stats"]["misses"] != 0 or warm["stats"]["hits"] < 1:
            raise AssertionError(f"phase 18 warm: cache {warm['stats']}")
        if warm["nvcc_reachable"]:
            raise AssertionError("phase 18 warm: nvcc was reachable")
        result = {"save_s": save_s, "cold": cold, "warm": warm, "card": smi}
        for what, r in runs.items():
            st = r["stages"]
            log(f"warm start {what}: import {r['import_s']:.2f} s (torch "
                f"{r['import_torch_s']:.2f}), load to "
                f"ready {r['load_to_ready_s']:.2f} s (weights read "
                f"{st['weights_read_s']:.2f}, model build "
                f"{st['model_build_s']:.2f}, engine build "
                f"{st['engine_build_s']:.2f}, libraries "
                f"{st['libraries_s']:.2f}, captures {st['captures_s']:.2f}; "
                f"executable ready {r['executable_ready_s']:.2f}), first "
                f"TTFT {r['first_ttft_s']:.4f} s, spawn to exit "
                f"{r['spawn_to_exit_s']:.2f} s, cache {r['stats']}, "
                f"report {sorted(set(r['report'].values()))}, captures "
                f"{sorted(set(r['capture_counts'].values()))}, paged "
                f"launches {r['launches']} ({r['launches_prefill']} tile), "
                f"peak {r['peak_mem_gb']:.2f} GB [{smi}]")
        log(f"warm start: saved in {save_s:.2f} s; both children's "
            f"{len(want)} streams equal phase 4's; the warm child had no "
            f"nvcc [{smi}]")
        for r in runs.values():
            del r["streams"]
        with open(os.path.join(out, "phase18.json"), "w") as f:
            json.dump(result, f, indent=1)
        return result
    finally:
        # the weights (~0.5 GB) and the libraries stay out of chiprun_out
        for path in (artifact + ".pdiparams", cache_dir):
            if os.path.isdir(path):
                shutil.rmtree(path, ignore_errors=True)
            elif os.path.exists(path):
                os.remove(path)


# ------------------------------------- multi-device training on one card (20)
# (a) the flash kernels at each plan's per-rank shape at GPT-350M (bf16,
# causal, D=64, S=1024): (name, B, H)
TRAIN_PAR_RANK_SHAPES = (("dp2_sharding2", 4, 16), ("mp2", 8, 8),
                         ("pp2_M4", 2, 16), ("ulysses_sp2", 8, 8),
                         ("dp2_mp2_pp2_M2", 2, 8))
# (b) f32 parity arms at full width, 4 layers: (name, plan, config
# override, loss rtol: the JAX suite's, 5e-4 for hybrids)
TRAIN_PAR_PARITY = (
    ("dp2", dict(dp=2), {}, 2e-4),
    ("sharding2", dict(sharding=2), {}, 2e-4),
    ("mp2", dict(mp=2), {}, 2e-4),
    ("mp2_fused_ce8", dict(mp=2), {"fused_ce_chunks": 8}, 2e-4),
    ("sp2_ring", dict(sp=2), {}, 2e-4),
    ("sp2_ulysses", dict(sp=2, sp_mode="ulysses"), {}, 2e-4),
    ("pp2_M4_gpipe", dict(pp=2, microbatches=4, schedule="gpipe"), {}, 2e-4),
    ("pp2_M4_1f1b", dict(pp=2, microbatches=4), {}, 2e-4),
    ("pp2_M4_eager1f1b", dict(pp=2, microbatches=4, schedule="eager1f1b"),
     {}, 2e-4),
    ("pp2_vpp2_M4", dict(pp=2, vpp=2, microbatches=4), {}, 2e-4),
    ("dp2_mp2_pp2_M2", dict(dp=2, mp=2, pp=2, microbatches=2), {}, 5e-4),
    ("pp2_sp2_dp2_M2_ring", dict(pp=2, sp=2, dp=2, microbatches=2), {},
     5e-4))
# Adam divides each gradient element by its own running scale, so an
# element whose gradient is rounding noise (another plan sums in another
# order) moves by up to about lr a step: the parameters are held to lr
# (phase 9's rule), each leaf's update as a whole to 1e-2, and the first
# step's moment m (0.1 x the clipped gradient, taken before the
# parameters part: a double-counted or missing part shows at order 1,
# where Adam's update would hide a scale) to 1e-3 of each leaf's largest
TRAIN_PAR_LR = 1e-3
TRAIN_PAR_PARAM_ATOL = TRAIN_PAR_LR
TRAIN_PAR_UPDATE_RTOL = 1e-2
TRAIN_PAR_M_RTOL = 1e-3
# (c) timed bf16 arms at phase 8's configuration
TRAIN_PAR_TIMED = (
    ("single", {}), ("dp2", dict(dp=2)), ("sharding2", dict(sharding=2)),
    ("mp2", dict(mp=2)), ("sp2_ulysses", dict(sp=2, sp_mode="ulysses")),
    ("pp2_M4_1f1b", dict(pp=2, microbatches=4)),
    ("pp2_vpp2_M4", dict(pp=2, vpp=2, microbatches=4)),
    ("dp2_mp2_pp2_M2", dict(dp=2, mp=2, pp=2, microbatches=2)))


def expected_flash_launches(plan, layers):
    """Flash launches of one step: every rank's layers once a microbatch
    forward and once backward; the 1F1B paths recompute each stage
    forward in the backward and skip the last virtual stage's forward;
    the sp ring and the all-gather route launch none."""
    if plan.sp > 1 and plan.sp_mode == "ring":
        return 0, 0
    R, M = plan.n_devices, plan.microbatches if plan.pp > 1 else 1
    per = R * layers // plan.pp * M
    if plan.pp > 1 and (plan.vpp > 1 or plan.schedule != "gpipe"):
        skipped = R // plan.pp * layers // (plan.pp * plan.vpp) * M
        return 2 * per - skipped, per
    return per, per


def flash_rank_shapes():
    """Phase 20 (a): forward, dQ and dK/dV at each rank shape against
    their plain versions (phase 7's tolerances; every backward launched
    twice and repeated bit for bit)."""
    out = []
    for j, (name, B, H) in enumerate(TRAIN_PAR_RANK_SHAPES):
        rec, _ = flash_case_check(
            100 + j, f"rank_{name}", dict(B=B, H=H, Hk=H, S=1024, D=64),
            "bf16", True, False, 0.0, flush=None)
        out.append(rec)
    return out


def _flash_counts():
    from paddle_tpu_torch.ops import flash_attention as fa
    return fa.launches_fwd, fa.launches_dq, fa.launches_dkv


def rank_moment(state, params, grid, key="m"):
    """[{leaf: the optimizer's `key` (m or v) in the rank's piece's
    shape}] a rank: each rank's state shard joined over its `sharding`
    group, the pad cut."""
    import torch
    out = []
    for r in range(grid.size):
        group = grid.ranks_where(**{a: c for a, c in grid.coords[r].items()
                                    if a != "sharding"})
        out.append({k: torch.cat([state[k][q][key] for q in group])
                    [:p[r].numel()].reshape(p[r].shape)
                    for k, p in params.items()})
    return out


def train_parallel_parity(smi, steps=3, B=8):
    """Phase 20 (b): every parity arm from one seeded set of f32 weights
    (and the zero state) against `MeshPlan()` on the same weights and
    batches, compared on the card rank by rank against the reference's
    window of each leaf: losses at the arm's rtol; the parameters within
    TRAIN_PAR_PARAM_ATOL and each leaf's update within
    TRAIN_PAR_UPDATE_RTOL after `steps` steps, the first step's moment
    within TRAIN_PAR_M_RTOL."""
    import dataclasses
    import numpy as np
    import torch
    from paddle_tpu_torch.parallel import (GPTSpmdConfig, MeshPlan,
                                           init_opt_state_leaf,
                                           interleave_permutation,
                                           make_train_step, param_specs)
    from paddle_tpu_torch.parallel.collectives import RankGrid
    from paddle_tpu_torch.parallel.gpt_spmd import (_BLOCK_LEAVES, _window,
                                                    shard_leaf)
    base_cfg = GPTSpmdConfig(**{**TRAIN_350M, "layers": 4}, remat=False)
    S = base_cfg.max_seq_len
    rng = np.random.RandomState(2)
    data = [(torch.from_numpy(rng.randint(0, base_cfg.vocab_size, (B, S))),
             torch.from_numpy(rng.randint(0, base_cfg.vocab_size, (B, S))))
            for _ in range(steps)]
    _, init = make_train_step(base_cfg, device="cuda")
    p0 = init(7)[0]
    specs = param_specs()
    dev = p0["wte"].device

    def stored(glob, plan):
        """The global leaves in the plan's storage order (vpp)."""
        if plan.vpp == 1:
            return glob
        perm = torch.from_numpy(interleave_permutation(
            base_cfg.layers, plan.pp, plan.vpp)).to(dev)
        return {k: (v[perm] if k in _BLOCK_LEAVES else v)
                for k, v in glob.items()}

    def run(cfg, plan):
        step, _ = make_train_step(cfg, plan, learning_rate=TRAIN_PAR_LR,
                                  device="cuda")
        grid = RankGrid(plan.dims, [dev] * plan.n_devices)
        params = {k: shard_leaf(v, specs[k], grid)
                  for k, v in stored(p0, plan).items()}
        state = {k: [init_opt_state_leaf(p, plan) for p in v]
                 for k, v in params.items()}
        if plan.n_devices == 1:
            params = {k: v[0] for k, v in params.items()}
            state = {k: v[0] for k, v in state.items()}
        before = _flash_counts()
        losses, m = [], None
        for toks, labs in data:
            loss, params, state = step(params, state, toks, labs)
            losses.append(float(loss))
            if m is None:       # the first step's m: 0.1 x its gradient
                m = rank_moment(
                    state if plan.n_devices > 1 else
                    {k: [v] for k, v in state.items()},
                    params if plan.n_devices > 1 else
                    {k: [v] for k, v in params.items()}, grid)
        launches = [a - b for a, b in zip(_flash_counts(), before)]
        if plan.n_devices == 1:
            params = {k: [v] for k, v in params.items()}
        return losses, params, m, launches, grid

    ref_losses, ref_p, ref_m, _, _ = run(base_cfg, MeshPlan())
    ref_p = {k: v[0].detach() for k, v in ref_p.items()}
    ref_m = ref_m[0]
    out = {"reference": {"losses": ref_losses}, "arms": {}}
    for name, kw, over, rtol in TRAIN_PAR_PARITY:
        cfg = dataclasses.replace(base_cfg, **over)
        plan = MeshPlan(**kw)
        t0 = time.perf_counter()
        losses, params, m, launches, grid = run(cfg, plan)
        loss_err = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                            ref_losses))
        want_p, want_m, start = (stored(d, plan) for d in (ref_p, ref_m,
                                                           p0))
        errs, upd, merr, over_1e4, noise = {}, {}, {}, {}, {}
        for k, pieces in params.items():
            d2 = u2 = 0.0
            errs[k] = merr[k] = 0.0
            over_1e4[k], noise_k = 0, 0.0
            rms = float(want_m[k].pow(2).mean().sqrt())
            mmax = float(want_m[k].abs().max())
            seen = set()
            for r, piece in enumerate(pieces):
                win = _window(tuple(want_p[k].shape), specs[k], grid, r)
                d = (piece.detach() - want_p[k][win]).abs()
                errs[k] = max(errs[k], float(d.max()))
                merr[k] = max(merr[k], float(
                    (m[r][k] - want_m[k][win]).abs().max()) / mmax)
                key = tuple((w.start, w.stop) for w in win)
                if key in seen:
                    continue
                seen.add(key)
                d2 += float(d.pow(2).sum())
                u2 += float((want_p[k][win] - start[k][win]).pow(2).sum())
                # where the parameters part by more than 1e-4, how large
                # the reference's first gradient is against the leaf's RMS
                big = d > 1e-4
                over_1e4[k] += int(big.sum())
                if bool(big.any()):
                    noise_k = max(noise_k, float(
                        want_m[k][win][big].abs().max()) / rms)
            upd[k] = (d2 / u2) ** 0.5
            if over_1e4[k]:
                noise[k] = noise_k
        del params, m
        torch.cuda.empty_cache()
        worst = max(errs, key=errs.get)
        worst_u, worst_m = max(upd, key=upd.get), max(merr, key=merr.get)
        want = expected_flash_launches(plan, cfg.layers)
        rec = {"plan": kw, "config": over, "losses": losses,
               "loss_max_rel_err": loss_err, "loss_rtol": rtol,
               "param_max_abs_err": errs[worst], "param_worst_leaf": worst,
               "param_max_abs_err_by_leaf": errs,
               "param_elems_over_1e-4": over_1e4,
               "m_over_rms_where_over_1e-4": noise,
               "update_rel_err_by_leaf": upd, "m_rel_err_by_leaf": merr,
               "tol": {"param_atol": TRAIN_PAR_PARAM_ATOL,
                       "update_rtol": TRAIN_PAR_UPDATE_RTOL,
                       "m_rtol": TRAIN_PAR_M_RTOL},
               "flash_launches": launches,
               "seconds": time.perf_counter() - t0}
        out["arms"][name] = rec
        log(f"train parallel parity {name} (f32, hidden 1024, 4 layers, "
            f"B={B}, lr {TRAIN_PAR_LR}, {steps} steps): losses "
            f"{[round(x, 6) for x in losses]} vs "
            f"{[round(x, 6) for x in ref_losses]}, max rel err "
            f"{loss_err:.2e} (rtol {rtol}); params max abs err "
            f"{errs[worst]:.2e} in {worst} (atol {TRAIN_PAR_PARAM_ATOL}; "
            f"{sum(over_1e4.values())} elements above 1e-4, where the "
            f"reference's first gradient is at most "
            f"{max(noise.values(), default=0.0):.2e} of its leaf's RMS); "
            f"update rel err {upd[worst_u]:.2e} in {worst_u} (rtol "
            f"{TRAIN_PAR_UPDATE_RTOL}); step-1 m rel err "
            f"{merr[worst_m]:.2e} in "
            f"{worst_m} (rtol {TRAIN_PAR_M_RTOL}); flash launches "
            f"fwd/dq/dkv {launches} in {steps} steps, "
            f"{rec['seconds']:.1f} s [{smi}]")
        if not (loss_err <= rtol and errs[worst] <= TRAIN_PAR_PARAM_ATOL
                and upd[worst_u] <= TRAIN_PAR_UPDATE_RTOL
                and merr[worst_m] <= TRAIN_PAR_M_RTOL):
            raise AssertionError(f"phase 20 (b) {name}: the plan departs "
                                 "from MeshPlan()")
        if launches != [x * steps for x in (want[0], want[1], want[1])]:
            raise AssertionError(f"phase 20 (b) {name}: flash launches "
                                 f"{launches}, want {want} a step")
    return out


def rank_bytes(params, state, grads_f32):
    """[(param, grad, optimizer bytes)] a rank: the parameters, the
    gradients the step holds (param dtype under autograd, f32 on the 1F1B
    paths) and m + v + master."""
    leaves = list(params.values())
    if not isinstance(leaves[0], (list, tuple)):
        params = {k: [v] for k, v in params.items()}
        state = {k: [v] for k, v in state.items()}
    out = []
    for r in range(len(next(iter(params.values())))):
        ps = [v[r] for v in params.values()]
        pb = sum(p.numel() * p.element_size() for p in ps)
        gb = sum(p.numel() * (4 if grads_f32 else p.element_size())
                 for p in ps)
        ob = sum(st[r][n].numel() * 4 for st in state.values()
                 for n in ("m", "v", "master"))
        out.append((pb, gb, ob))
    return out


def timed_train_config(B):
    """Phase 8's configuration (GPT-350M, bf16, no remat, unfused CE) and
    its fixed batch on the card (phase 20 (c), (d))."""
    import numpy as np
    import torch
    from paddle_tpu_torch.parallel import GPTSpmdConfig
    cfg = GPTSpmdConfig(**TRAIN_350M, param_dtype="bfloat16",
                        compute_dtype="bfloat16", remat=False)
    rng = np.random.RandomState(0)
    shape = (B, cfg.max_seq_len)
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, shape)).cuda()
    labs = torch.from_numpy(rng.randint(0, cfg.vocab_size, shape)).cuda()
    return cfg, toks, labs


def train_parallel_timed(smi, warmup=2, steps=3, B=8):
    """Phase 20 (c): each timed arm at phase 8's configuration: step ms
    (median of `steps` synchronised steps after `warmup`), tokens/s, peak
    memory, each rank's bytes, one profiled step (device busy ms, kernels,
    idle share) and its flash launches a step."""
    import gc
    import torch
    from paddle_tpu_torch.parallel import MeshPlan, make_train_step
    cfg, toks, labs = timed_train_config(B)
    S = cfg.max_seq_len
    out = {}
    for name, kw in TRAIN_PAR_TIMED:
        plan = MeshPlan(**kw)
        gc.collect()
        torch.cuda.empty_cache()
        baseline = torch.cuda.memory_allocated()    # earlier phases' leftovers
        step, init = make_train_step(cfg, plan, learning_rate=2e-4,
                                     device="cuda")
        params, state = init(0)
        losses = []
        for _ in range(warmup):
            losses.append(float(step(params, state, toks, labs)[0]))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = _flash_counts()
        times = []
        for _ in range(steps):
            t0 = time.perf_counter()
            loss = step(params, state, toks, labs)[0]
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            losses.append(float(loss))
        launches = [(a - b) // steps for a, b in zip(_flash_counts(),
                                                     before)]
        peak = torch.cuda.max_memory_allocated()
        prof = profile_train_step(lambda: step(params, state, toks, labs),
                                  cpu=False)
        manual = plan.pp > 1 and (plan.vpp > 1 or plan.schedule != "gpipe")
        per_rank = rank_bytes(params, state, manual)
        step_ms = sorted(times)[len(times) // 2] * 1e3
        want = expected_flash_launches(plan, cfg.layers)
        rec = {"plan": kw, "ranks": plan.n_devices, "losses": losses,
               "step_ms_median": step_ms,
               "step_ms_all": [t * 1e3 for t in times],
               "tokens_per_s": B * S / (step_ms / 1e3),
               "peak_memory_gb": peak / 1e9,
               "peak_above_baseline_gb": (peak - baseline) / 1e9,
               "rank_bytes": [{"param": p, "grad": g, "optimizer": o}
                              for p, g, o in per_rank],
               "flash_launches_per_step": launches,
               "pipeline": dict(step.stats), **prof,
               "device_idle_share_untraced": (
                   1 - prof["device_busy_ms"] / step_ms), "card": smi}
        if name == "sharding2":
            rec["opt_leaf_elems"] = {
                k: [st["m"].numel() for st in v] for k, v in state.items()}
            rec["leaf_elems"] = {k: v[0].numel() for k, v in params.items()}
        out[name] = rec
        log(f"train parallel {name} bf16 B={B} S={S} ({plan.n_devices} "
            f"ranks on one card): step {step_ms:.2f} ms median, "
            f"{rec['tokens_per_s']:.0f} tokens/s, peak "
            f"{rec['peak_memory_gb']:.2f} GB ("
            f"{rec['peak_above_baseline_gb']:.2f} above what was allocated "
            f"before the arm), rank 0 bytes param "
            f"{per_rank[0][0] / 1e9:.3f} GB grad {per_rank[0][1] / 1e9:.3f}"
            f" GB optimizer {per_rank[0][2] / 1e9:.3f} GB, device busy "
            f"{prof['device_busy_ms']:.2f} ms of a "
            f"{prof['traced_step_ms']:.2f} ms traced step "
            f"({prof['kernels_per_step']} kernels, idle "
            f"share {prof['device_idle_share']:.3f}; "
            f"{rec['device_idle_share_untraced']:.3f} of the untraced "
            f"median), flash launches a step fwd/dq/dkv {launches}, loss "
            f"{losses[0]:.4f} -> {losses[-1]:.4f} [{smi}]")
        if not all(math.isfinite(x) for x in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"phase 20 (c) {name}: loss {losses}")
        if launches != [want[0], want[1], want[1]]:
            raise AssertionError(f"phase 20 (c) {name}: flash launches "
                                 f"{launches} a step, want {want}")
        del params, state, step, init
    # ZeRO-2: sharding=2 holds ceil(size / 2) of each leaf's m / v / master
    sh, dp = out["sharding2"], out["dp2"]
    for k, n in sh["leaf_elems"].items():
        if any(e != -(-n // 2) for e in sh["opt_leaf_elems"][k]):
            raise AssertionError(f"phase 20 (c): sharding=2 state of {k} "
                                 f"{sh['opt_leaf_elems'][k]}, want "
                                 f"ceil({n} / 2) a rank")
    ratio = sh["rank_bytes"][0]["optimizer"] / dp["rank_bytes"][0][
        "optimizer"]
    out["zero2_optimizer_ratio"] = ratio
    log(f"ZeRO-2: sharding=2 holds {sh['rank_bytes'][0]['optimizer']} B of "
        f"m/v/master a rank, dp=2 {dp['rank_bytes'][0]['optimizer']} B "
        f"(ratio {ratio:.6f})")
    if not 0.5 <= ratio <= 0.5 + 1e-6:
        raise AssertionError(f"phase 20 (c): ZeRO-2 state ratio {ratio}")
    return out


def schedule_memory(smi, B=8):
    """Phase 20 (d): pp=4, M=8 at the timed configuration under GPipe and
    1F1B: each schedule's peak allocated bytes during a step minus what
    it holds anyway (the resident parameters and state before the step,
    and the gradients it keeps: param dtype under autograd, the f32
    accumulators of 1F1B)."""
    import gc
    import torch
    from paddle_tpu_torch.parallel import MeshPlan, make_train_step
    cfg, toks, labs = timed_train_config(B)
    out = {}
    for sched in ("gpipe", "1f1b"):
        gc.collect()
        torch.cuda.empty_cache()
        plan = MeshPlan(pp=4, microbatches=8, schedule=sched)
        step, init = make_train_step(cfg, plan, learning_rate=2e-4,
                                     device="cuda")
        params, state = init(0)
        float(step(params, state, toks, labs)[0])     # the state exists
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = float(step(params, state, toks, labs)[0])
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak = torch.cuda.max_memory_allocated()
        grads = sum(g for _, g, _ in rank_bytes(params, state,
                                                sched != "gpipe"))
        if sched != "gpipe":
            # 1F1B accumulates wte twice: the embedding's and the head's
            grads += sum(params["wte"][r].numel() * 4
                         for r in range(plan.n_devices))
        act = peak - resident - grads
        out[sched] = {"peak_bytes": peak, "resident_bytes": resident,
                      "grad_bytes": grads, "activation_peak_bytes": act,
                      "step_ms": ms, "loss": loss,
                      "pipeline": dict(step.stats)}
        log(f"schedule memory pp=4 M=8 {sched}: peak {peak / 1e9:.3f} GB, "
            f"resident {resident / 1e9:.3f} GB, gradients "
            f"{grads / 1e9:.3f} GB, activations {act / 1e9:.3f} GB, one "
            f"step {ms:.1f} ms, {step.stats} [{smi}]")
        del params, state, step, init
    ratio = out["1f1b"]["activation_peak_bytes"] / \
        out["gpipe"]["activation_peak_bytes"]
    out["ratio_1f1b_to_gpipe"] = ratio
    log(f"1F1B / GPipe activation peak at pp=4, M=8: {ratio:.4f} (the JAX "
        f"suite expects below 0.5 of its compiled temp bytes) [{smi}]")
    if not ratio < 1.0:
        raise AssertionError(f"phase 20 (d): 1F1B's activation peak is not "
                             f"below GPipe's ({ratio})")
    return out


def train_parallel_phase(smi):
    """Phase 20: the `gpt_spmd` plans with an axis above 1 on the one card
    (module docstring)."""
    import gc
    import torch
    out, secs = {}, {}
    t0 = time.perf_counter()
    for part, fn in (("rank_shapes", flash_rank_shapes),
                     ("parity", lambda: train_parallel_parity(smi)),
                     ("timed", lambda: train_parallel_timed(smi)),
                     ("schedule_memory", lambda: schedule_memory(smi))):
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        out[part] = fn()
        secs[part] = time.perf_counter() - t
    out["seconds"] = time.perf_counter() - t0
    out["seconds_by_part"] = secs
    log(f"phase 20 by part (s): " + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items()) + f" [{smi}]")
    return out


# --------------------------------------------------- 21. the eager core
EAGER_SIZES = (("small", 256, 64, 256, 8), ("large", 8192, 4096, 4096, 8))
EAGER_LR = 0.05
EAGER_WARMUP, EAGER_STEPS = 5, 60
EAGER_OPS = 25            # ops a step that launch work: 13 forward + 2 a
                          # parameter in the update (6 parameters)
EAGER_LOSS_RTOL = 1e-6    # arms 1 and 2 run the same kernels in order
WRAPPER_OPS = ("add", "multiply", "maximum", "matmul")
WRAPPER_CALLS, WRAPPER_WARMUP, WRAPPER_ROUNDS = 200, 5, 60


def flash_pylayer(meta):
    """A PyLayer over the port's flash kernels: forward `flash_fwd`,
    backward `flash_dq` and `flash_dkv`, on paddle Tensors of flattened
    [B*H, S, D] rows (the wrappers take the plain versions on CPU
    tensors)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.core.tensor import apply_op
    from paddle_tpu_torch.ops import flash_attention as fa

    class FlashAttention(pt.autograd.PyLayer):
        @staticmethod
        def forward(ctx, q, k, v):
            o, lse = apply_op(lambda a, b, c: fa.flash_fwd(a, b, c, None,
                                                           meta),
                              q, k, v, name="flash_fwd")
            ctx.save_for_backward(q, k, v, o, lse)
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensor()
            do = apply_op(lambda t: t.contiguous(), do, name="contiguous")
            delta = (do.astype("float32") * o.astype("float32")).sum(-1)
            dq = apply_op(lambda *t: fa.flash_dq(*t, None, meta),
                          q, k, v, do, lse, delta, name="flash_dq")
            dk, dv = apply_op(lambda *t: fa.flash_dkv(*t, None, meta),
                              q, k, v, do, lse, delta, name="flash_dkv")
            return dq, dk, dv
    return FlashAttention


def mlp_init(dev, D, H, C):
    """bench_eager.py's MLP (Linear D->H, ReLU, H->H, ReLU, H->C) as six
    seeded tensors: weights scaled by fan_in ** -0.5, zero biases."""
    import torch
    g = torch.Generator(device=dev).manual_seed(0)
    out = []
    for fi, fo in ((D, H), (H, H), (H, C)):
        out.append(torch.randn((fi, fo), generator=g, device=dev)
                   * fi ** -0.5)
        out.append(torch.zeros((fo,), device=dev))
    return out


def mlp_data(dev, B, D, C):
    import torch
    g = torch.Generator(device=dev).manual_seed(1)
    return (torch.rand((B, D), generator=g, device=dev),
            torch.randint(0, C, (B, 1), generator=g, device=dev))


def eager_mlp_step(pt, x, y, ps, lr=EAGER_LR):
    """One step of the MLP in the port's eager API: forward, softmax
    cross-entropy, backward, SGD under no_grad. Returns the loss (a host
    read, which closes the step)."""
    w1, b1, w2, b2, w3, b3 = ps
    h = pt.maximum(pt.matmul(x, w1) + b1, 0.0)
    h = pt.maximum(pt.matmul(h, w2) + b2, 0.0)
    z = pt.matmul(h, w3) + b3
    loss = (pt.logsumexp(z, axis=-1)
            - pt.take_along_axis(z, y, 1).squeeze(1)).mean()
    loss.backward()
    with pt.no_grad():
        for p in ps:
            p.subtract_(p.grad * lr)
            p.clear_grad()
    return float(loss)


def raw_mlp_step(x, y, ps, zero, lr=EAGER_LR):
    """The same ops on raw torch tensors (the SGD update in place);
    returns the loss as a device tensor."""
    import torch
    w1, b1, w2, b2, w3, b3 = ps
    h = torch.maximum(x @ w1 + b1, zero)
    h = torch.maximum(h @ w2 + b2, zero)
    z = h @ w3 + b3
    loss = (torch.logsumexp(z, -1)
            - torch.take_along_dim(z, y, 1).squeeze(1)).mean()
    loss.backward()
    with torch.no_grad():
        for p in ps:
            p.sub_(p.grad * lr)
    return loss


def interleaved_steps(arms, warmup, steps):
    """Run the arms' steps in turns (a, b, c, then c, b, a, ...) so host
    noise falls on each alike. Each step ends in a host read of its loss.
    Returns {arm: losses of every step}, {arm: (p25, p50, p75) host ms
    of the timed steps} and {arm: host ms of each timed step}."""
    names = list(arms)
    losses = {a: [] for a in names}
    times = {a: [] for a in names}
    for i in range(warmup + steps):
        for a in (names if i % 2 == 0 else names[::-1]):
            t0 = time.perf_counter()
            losses[a].append(arms[a]())
            if i >= warmup:
                times[a].append((time.perf_counter() - t0) * 1e3)
    return losses, {a: quartiles(ts) for a, ts in times.items()}, times


def quartiles(values):
    vs = sorted(values)
    return tuple(vs[int(q * (len(vs) - 1))] for q in (0.25, 0.5, 0.75))


def eager_wrapper_cost(smi, dev):
    """Phase 21 (a), the wrapper's own cost, where a step's host noise
    cannot hide it: rounds of WRAPPER_CALLS back-to-back calls (add,
    multiply, maximum, matmul in turn) on 8x8 f32 tensors, through the
    port's ops and through torch's, the two arms in turns; no sync inside
    a round, one after it. Inputs that do not, then that do, require
    grad. Per round, (port - torch) / WRAPPER_CALLS; quartiles over
    WRAPPER_ROUNDS rounds."""
    import torch
    import paddle_tpu_torch as pt
    raw = {"add": torch.add, "multiply": torch.mul,
           "maximum": torch.maximum, "matmul": torch.matmul}
    g = torch.Generator(device=dev).manual_seed(3)
    a0, b0 = (torch.randn((8, 8), generator=g, device=dev)
              for _ in range(2))

    def timed(fns, x, y):
        def run():
            t0 = time.perf_counter()
            for i in range(WRAPPER_CALLS):
                fns[i % len(fns)](x, y)
            t = time.perf_counter() - t0
            torch.cuda.synchronize()
            return t * 1e6 / WRAPPER_CALLS
        return run

    out = {}
    for label, req in (("no_grad_inputs", False), ("grad_inputs", True)):
        ta, tb = (t.clone().requires_grad_(req) for t in (a0, b0))
        pa, pb = (pt.to_tensor(t, stop_gradient=not req) for t in (a0, b0))
        arms = {"port": timed([getattr(pt, n) for n in WRAPPER_OPS], pa, pb),
                "torch": timed([raw[n] for n in WRAPPER_OPS], ta, tb)}
        us, _, _ = interleaved_steps(arms, WRAPPER_WARMUP, WRAPPER_ROUNDS)
        port, tor = (us[a][WRAPPER_WARMUP:] for a in ("port", "torch"))
        out[label] = {
            "port_us_per_op_quartiles": quartiles(port),
            "torch_us_per_op_quartiles": quartiles(tor),
            "wrapper_us_per_op_quartiles": quartiles(
                p - t for p, t in zip(port, tor))}
    log("wrapper cost (rounds of " + str(WRAPPER_CALLS) + " calls of "
        + "/".join(WRAPPER_OPS) + " on 8x8 f32, no sync inside a round, "
        f"turns, {WRAPPER_ROUNDS} rounds): " + "; ".join(
            f"{k}: host us an op p25/p50/p75 port "
            + "/".join(f"{v:.2f}" for v in r["port_us_per_op_quartiles"])
            + ", torch "
            + "/".join(f"{v:.2f}" for v in r["torch_us_per_op_quartiles"])
            + ", port - torch (paired rounds) "
            + "/".join(f"{v:.2f}" for v in r["wrapper_us_per_op_quartiles"])
            for k, r in out.items()) + f" [{smi}]")
    out["card"] = smi
    return out


def eager_mlp(smi, label, B, D, H, C, out_dir):
    """Phase 21 (a) at one size: the three arms, their step ms, kernels a
    step and the wrapper's host us an op; arms 1 and 2 must give the same
    losses, and the loss must fall."""
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.observability import deviceprof
    dev = torch.device("cuda")
    init = mlp_init(dev, D, H, C)
    x0, y0 = mlp_data(dev, B, D, C)
    x, y = pt.to_tensor(x0), pt.to_tensor(y0)
    ps1 = [pt.to_tensor(t, stop_gradient=False) for t in init]
    ps2 = [t.clone().requires_grad_() for t in init]
    ps3 = [t.clone().requires_grad_() for t in init]
    zero = torch.tensor(0.0)

    def step1():
        return eager_mlp_step(pt, x, y, ps1)

    def step2():
        for p in ps2:
            p.grad = None
        return raw_mlp_step(x0, y0, ps2, zero).item()

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            for p in ps3:
                p.grad = None
            raw_mlp_step(x0, y0, ps3, zero)
    torch.cuda.current_stream().wait_stream(side)
    for p in ps3:
        p.grad = None
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static_loss = raw_mlp_step(x0, y0, ps3, zero)

    def step3():
        graph.replay()
        return static_loss.item()

    rec = {"B": B, "D": D, "H": H, "C": C, "ops_per_step": EAGER_OPS,
           "card": smi}
    arms = {"eager": step1, "torch": step2, "graph": step3}
    losses, quart, times = interleaved_steps(arms, EAGER_WARMUP,
                                             EAGER_STEPS)
    for arm, step in arms.items():
        rec[f"{arm}_step_ms"] = quart[arm][1]
        rec[f"{arm}_step_ms_quartiles"] = quart[arm]
        _, prof = deviceprof.capture(step, os.path.join(out_dir, label, arm),
                                     iters=5, label=f"eager_{label}_{arm}")
        rec[f"{arm}_kernels_per_step"] = prof["n_events"] / 5
        rec[f"{arm}_device_ms_per_step"] = prof["total_device_ms"] / 5
    a, b = np.asarray(losses["eager"]), np.asarray(losses["torch"])
    rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-12)))
    rec["loss_rel_err_eager_vs_torch"] = rel
    rec["loss_first_last"] = {k: (v[0], v[-1]) for k, v in losses.items()}
    # eager step i and torch step i ran back to back: their difference
    # leaves out the host noise that moves both
    rec["wrapper_us_per_op_paired_quartiles"] = quartiles(
        (e - t) * 1e3 / EAGER_OPS for e, t in zip(times["eager"],
                                                  times["torch"]))
    q = {a: "/".join(f"{v:.4f}" for v in quart[a]) for a in quart}
    log(f"eager MLP {label} (B={B} D={D} H={H} C={C}): step ms p25/p50/p75 "
        f"eager {q['eager']}, torch {q['torch']}, graph {q['graph']} "
        f"(turns, {EAGER_STEPS} each); kernels a step "
        f"{rec['eager_kernels_per_step']:.1f} / "
        f"{rec['torch_kernels_per_step']:.1f} / "
        f"{rec['graph_kernels_per_step']:.1f}; device ms a step "
        f"{rec['eager_device_ms_per_step']:.4f} / "
        f"{rec['torch_device_ms_per_step']:.4f} / "
        f"{rec['graph_device_ms_per_step']:.4f}; wrapper us an op "
        "p25/p50/p75 of (eager - torch) step pairs over "
        f"{EAGER_OPS} ops " + "/".join(
            f"{v:.2f}" for v in rec["wrapper_us_per_op_paired_quartiles"])
        + "; "
        f"loss {losses['eager'][0]:.6f} -> {losses['eager'][-1]:.6f}, "
        f"eager vs torch rel err {rel:.2e} [{smi}]")
    if not rel <= EAGER_LOSS_RTOL:
        raise AssertionError(f"phase 21 (a) {label}: eager and torch losses "
                             f"differ by {rel} (tol {EAGER_LOSS_RTOL})")
    for arm, ls in losses.items():
        if not (np.all(np.isfinite(ls)) and ls[-1] < ls[0]):
            raise AssertionError(f"phase 21 (a) {label} {arm}: the loss did "
                                 f"not fall ({ls[0]} -> {ls[-1]})")
    return rec, step1


def eager_flash_pylayer(smi):
    """Phase 21 (b): the PyLayer over the flash kernels at GPT-350M's
    attention shape through paddle Tensors, each kernel launched once and
    held to its plain version."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.ops import flash_attention as fa
    B, H, S, D = 8, 16, 1024, 64
    c = flash_case(2100, B, H, H, S, D, "bf16", True, False, 0.0)
    q0, k0, v0, do0, meta = (c[n] for n in ("q", "k", "v", "do", "meta"))
    q, k, v = (pt.to_tensor(t, stop_gradient=False) for t in (q0, k0, v0))
    before = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    o = flash_pylayer(meta).apply(q, k, v)
    mid = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    o.backward(pt.to_tensor(do0))
    torch.cuda.synchronize()
    after = (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)
    moved = tuple(a - b for a, b in zip(after, before))
    if mid[0] - before[0] != 1 or moved != (1, 1, 1):
        raise AssertionError(f"phase 21 (b): flash launches moved by "
                             f"{moved} (forward {mid[0] - before[0]}), want "
                             "one of each")
    po, plse = fa.fwd_plain(q0, k0, v0, None, meta)
    delta = (do0.float() * po.float()).sum(-1)
    pdq = fa.dq_plain(q0, k0, v0, do0, plse, delta, None, meta)
    pdk, pdv = fa.dkv_plain(q0, k0, v0, do0, plse, delta, None, meta)
    errs = {}
    for name, got, want in (("o", o._data, po), ("dq", q.grad._data, pdq),
                            ("dk", k.grad._data, pdk),
                            ("dv", v.grad._data, pdv)):
        got = got.detach()
        err = (got.float() - want.float()).abs()
        bad = (err > BF16_TOL + BF16_TOL * want.float().abs()) \
            | ~torch.isfinite(got)
        errs[name] = float(err.max())
        if bool(bad.any()):
            raise AssertionError(f"phase 21 (b): {name} disagrees with the "
                                 f"plain version (max_abs_err "
                                 f"{errs[name]}, tol {BF16_TOL})")
    log(f"PyLayer over the flash kernels (B={B} H={H} S={S} D={D} bf16 "
        f"causal): launches fwd/dq/dkv +{moved[0]}/+{moved[1]}/+{moved[2]}, "
        "max_abs_err " + " ".join(f"{n}={e:.2e}" for n, e in errs.items())
        + f" (tol {BF16_TOL}) [{smi}]")
    return {"shape": [B, H, S, D], "launches": dict(zip(
        ("fwd", "dq", "dkv"), moved)), "max_abs_err": errs,
        "tol": BF16_TOL, "card": smi}


def eager_nan_check(smi, step):
    """Phase 21 (c): FLAGS_check_nan_inf raises naming the op on the card,
    and what the flag costs the small MLP step (one host sync an op)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.framework.flags import set_flags

    def flagged(on):
        def run():
            set_flags({"FLAGS_check_nan_inf": on})
            return step()
        return run

    try:
        _, quart, _ = interleaved_steps({"off": flagged(False),
                                      "on": flagged(True)}, 3, 30)
        set_flags({"FLAGS_check_nan_inf": True})
        raised = {}
        for op, fn in (("log", lambda: pt.log(pt.to_tensor([1.0, -1.0]))),
                       ("matmul", lambda: pt.matmul(
                           pt.to_tensor([[float("inf"), 1.0]]),
                           pt.to_tensor([[0.0], [1.0]])))):
            try:
                fn()
            except RuntimeError as e:
                raised[op] = str(e).splitlines()[0]
                if f"'{op}'" not in raised[op]:
                    raise AssertionError(f"phase 21 (c): the error does not "
                                         f"name {op}: {raised[op]}") from e
            else:
                raise AssertionError(f"phase 21 (c): {op} made a NaN/Inf "
                                     "and nothing raised")
    finally:
        set_flags({"FLAGS_check_nan_inf": False})
    off, on = quart["off"][1], quart["on"][1]
    log(f"FLAGS_check_nan_inf on the small step (turns, 30 each): "
        f"p25/p50/p75 ms off "
        + "/".join(f"{v:.4f}" for v in quart["off"]) + ", on "
        + "/".join(f"{v:.4f}" for v in quart["on"])
        + f" (+{on - off:.4f} ms, {(on - off) * 1e3 / EAGER_OPS:.1f} us an "
        f"op); raised: {raised} [{smi}]")
    return {"step_ms_quartiles": quart, "cost_ms": on - off,
            "raised": raised, "card": smi}


def _test_module(name):
    """A CPU test file loaded as a module (its tables import nothing of
    JAX); the tests directory goes on sys.path for its sibling imports."""
    import importlib.util
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(tests, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _on(pt, dev, fn):
    prev = pt.get_device()
    pt.set_device(dev)
    try:
        return fn()
    finally:
        pt.set_device(prev)


def eager_op_table(smi):
    """Phase 21 (d): the CPU tests' op table (and in-place table) run on
    CUDA and compared with the port on the CPU: exact for integer, bool
    and index results, the case's float tolerance otherwise, values and
    gradients."""
    import numpy as np
    import paddle_tpu_torch as pt
    table = _test_module("test_torch_tensor_ops")
    failures, n = [], 0
    for case in table.OP_TABLE:
        n += 1
        try:
            arrays = case.inputs()
            grad = case.grad and any(a.dtype.kind == "f" for a in arrays)
            res = {d: _on(pt, d, lambda: table.run_case(pt, case, arrays,
                                                        grad=grad))
                   for d in ("cpu", "gpu")}
            got = [table.host(o) for o in res["gpu"][0]]
            want = [table.host(o) for o in res["cpu"][0]]
            if case.post is not None:
                got = list(zip(case.post([g for g, _ in got]),
                               [d for _, d in got]))
                want = list(zip(case.post([w for w, _ in want]),
                                [d for _, d in want]))
            table.compare(got, want, case.tol, case.id)
            if grad:
                for i, (g, w) in enumerate(zip(res["gpu"][1],
                                               res["cpu"][1])):
                    if arrays[i].dtype.kind != "f":
                        continue
                    if (g is None) != (w is None):
                        raise AssertionError(f"grad {i}: {g} vs {w}")
                    if g is not None:
                        np.testing.assert_allclose(
                            g.numpy(), w.numpy(), rtol=case.tol,
                            atol=case.tol, err_msg=f"grad of input {i}")
        except Exception as e:      # noqa: BLE001 - every case is reported
            failures.append(f"{case.id}: {type(e).__name__}: "
                            f"{' '.join(str(e).split())[:400]}")
    for name, args, maker in table.INPLACE_TABLE:
        n += 1
        try:
            a = maker(np.random.RandomState(3))
            outs = []
            for dev in ("cpu", "gpu"):
                def run():
                    x = pt.to_tensor(a)
                    getattr(x, name)(*args)
                    return table.host(x)
                outs.append(_on(pt, dev, run))
            table.compare([outs[1]], [outs[0]], table.EW, name)
        except Exception as e:      # noqa: BLE001
            failures.append(f"{name}: {type(e).__name__}: {e}")
    log(f"op table on CUDA against the CPU: {n - len(failures)} of {n} "
        f"cases agree [{smi}]")
    for f in failures:
        log(f"  op table FAILED {f}")
    if failures:
        raise AssertionError(f"phase 21 (d): {len(failures)} of {n} op "
                             "table cases disagree between CUDA and the CPU")
    return {"cases": n, "card": smi}


def eager_phase(smi):
    """Phase 21: the eager core on the card (module docstring)."""
    import gc
    import torch
    t0 = time.perf_counter()
    out_dir = os.path.join(ROOT, "chiprun_out", "phase21")
    out, step_small = {}, None
    out["wrapper_cost"] = eager_wrapper_cost(smi, torch.device("cuda"))
    for label, B, D, H, C in EAGER_SIZES:
        gc.collect()
        torch.cuda.empty_cache()
        out[f"mlp_{label}"], step = eager_mlp(smi, label, B, D, H, C,
                                              out_dir)
        step_small = step_small or step
    out["flash_pylayer"] = eager_flash_pylayer(smi)
    out["nan_check"] = eager_nan_check(smi, step_small)
    out["op_table"] = eager_op_table(smi)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 21 took {out['seconds']:.1f} s [{smi}]")
    return out


# ------------------------------------------- 22. nn, optimizer, amp
# (a) BertConfig's widths (paddle_tpu/text/models/bert.py:12-20), one card
NN_CFG = {"vocab": 30522, "hidden": 768, "heads": 12, "ff": 3072,
          "layers": 12, "B": 8, "S": 512, "pad": 64}
NN_LR, NN_WARMUP_LR_STEPS = 5e-4, 5
NN_WARMUP, NN_STEPS = 3, 27         # 30 training steps an arm, 27 timed
NN_LOSS_RTOL = 2e-2                 # bf16 step-1 loss against f32's
# the encoder's last hidden states, bf16 (O2) against f32, in eval mode:
# the largest relative error of a batch row (||h - h_f32|| / ||h_f32||);
# bf16 reads 7.4e-3 to 8.9e-3 a row on the H100, dropping the key padding
# 8.7e-2 to 1.0e-1 on the padded rows (PERF.md, PR 17)
NN_HIDDEN_RTOL = 2.5e-2
NN_SMALL_WARMUP, NN_SMALL_STEPS = 10, 200
NN_OPT_TOL = 1e-5
NN_FLASH = dict(B=8, H=12, S=512, D=64, pad=64)


def nn_encoder(pt, dropout):
    """Embedding -> TransformerEncoder (post-norm, GELU) -> Linear, in the
    port's `nn`, random weights from the current seed, on the current
    place."""
    nn, c = pt.nn, NN_CFG

    class EncoderLM(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(c["vocab"], c["hidden"])
            self.encoder = nn.TransformerEncoder(nn.TransformerEncoderLayer(
                c["hidden"], c["heads"], c["ff"], dropout=dropout,
                activation="gelu"), c["layers"])
            self.head = nn.Linear(c["hidden"], c["vocab"])

        def forward(self, ids, mask):
            return self.head(self.encoder(self.embed(ids), mask))
    model = EncoderLM()
    for n, p in model.named_parameters():
        p.name = n                      # AdamW's decay rule reads names
    return model


def nn_batch(pt, dev):
    """One seeded token-copying batch: labels are the inputs; a bool
    key-padding mask [B, 1, 1, S] hides the last `pad` keys of the first
    half of the rows, whose positions there carry no label."""
    import torch
    c = NN_CFG
    B, S, pad = c["B"], c["S"], c["pad"]
    g = torch.Generator(device=dev).manual_seed(22)
    ids = torch.randint(0, c["vocab"], (B, S), generator=g, device=dev)
    keep = torch.ones((B, 1, 1, S), dtype=torch.bool, device=dev)
    keep[:B // 2, ..., S - pad:] = False
    labels = ids.clone()
    labels[:B // 2, S - pad:] = -100
    return (pt.to_tensor(ids), pt.to_tensor(keep),
            pt.to_tensor(labels.reshape(-1)))


def _flash_counts():
    from paddle_tpu_torch.ops import flash_attention as fa
    return (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)


def nn_train_arm(pt, smi, arm, state, out_dir):
    """Phase 22 (a), one arm: the encoder from `state`, in f32 or as bf16
    parameters (`amp.decorate` O2, forward under `auto_cast`), trained 30
    steps by AdamW (LinearWarmup, decay 0.01 off biases and norms,
    ClipGradByGlobalNorm(1.0)) with dropout 0.1; step-1 loss in eval mode
    (no dropout) first."""
    import numpy as np
    import torch
    from paddle_tpu_torch.nn.functional import attention as ta
    from paddle_tpu_torch.observability import deviceprof
    c = NN_CFG
    dev = torch.device(pt.get_device().replace("gpu", "cuda"))
    model = nn_encoder(pt, 0.1)
    model.set_state_dict(state)
    sched = pt.optimizer.lr.LinearWarmup(NN_LR, NN_WARMUP_LR_STEPS, 1e-5,
                                         NN_LR)
    opt = pt.optimizer.AdamW(
        sched, parameters=model.parameters(), weight_decay=0.01,
        apply_decay_param_fun=lambda n: not (n.endswith("bias")
                                             or "norm" in n),
        grad_clip=pt.nn.ClipGradByGlobalNorm(1.0))
    bf16 = arm == "bf16"
    if bf16:
        model, opt = pt.amp.decorate(model, opt, level="O2",
                                     dtype="bfloat16")
    ids, mask, labels = nn_batch(pt, dev)
    lf = pt.nn.CrossEntropyLoss()

    def loss_of():
        with pt.amp.auto_cast(enable=bf16, level="O2", dtype="bfloat16"):
            logits = model(ids, mask)
        return lf(logits.astype("float32").reshape([-1, c["vocab"]]),
                  labels)

    model.eval()
    with pt.no_grad():
        loss0 = float(loss_of())
    model.train()
    for k in ta.sdpa_routes:
        ta.sdpa_routes[k] = 0
    moved = []

    def step():
        before = _flash_counts()
        loss = loss_of()
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        value = float(loss)              # the host read closes the step
        moved.append(tuple(a - b for a, b in zip(_flash_counts(), before)))
        return value

    losses, times = [], []
    for i in range(NN_WARMUP + NN_STEPS):
        t0 = time.perf_counter()
        losses.append(step())
        if i >= NN_WARMUP:
            times.append((time.perf_counter() - t0) * 1e3)
    routes = dict(ta.sdpa_routes)
    n_prof = 3
    _, prof = deviceprof.capture(step, os.path.join(out_dir, arm),
                                 iters=n_prof, label=f"nn_encoder_{arm}")
    quart = quartiles(times)
    rec = {"arm": arm, "B": c["B"], "S": c["S"], "step1_loss": loss0,
           "step_ms_quartiles": quart, "step_ms_median": quart[1],
           "tokens_per_s": c["B"] * c["S"] / (quart[1] / 1e3),
           "kernels_per_step": prof["n_events"] / n_prof,
           "device_busy_ms_per_step": prof["total_device_ms"] / n_prof,
           "flash_launches_per_step": sorted(set(moved)),
           "sdpa_routes": routes, "losses": losses,
           "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30
           if dev.type == "cuda" else None, "card": smi}
    rec["idle_share"] = 1.0 - rec["device_busy_ms_per_step"] / quart[1]
    want = c["layers"]
    if set(moved) != {(want, want, want)}:
        raise AssertionError(f"phase 22 (a) {arm}: flash launches a step "
                             f"{sorted(set(moved))}, want {want} of each "
                             "(one a layer)")
    if routes["plain"] or routes["kernel"] != want * len(losses):
        raise AssertionError(f"phase 22 (a) {arm}: SDPA routes {routes}, "
                             f"want every one of {want * len(losses)} "
                             "calls on the kernel route")
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    if not (np.all(np.isfinite(losses)) and last < first):
        raise AssertionError(f"phase 22 (a) {arm}: the loss did not fall "
                             f"({first} -> {last})")
    log(f"nn encoder {arm} (B={c['B']} S={c['S']} hidden {c['hidden']} "
        f"x {c['layers']}, vocab {c['vocab']}): step ms p25/p50/p75 "
        + "/".join(f"{v:.3f}" for v in quart)
        + f" ({NN_STEPS} steps after {NN_WARMUP}), "
        f"{rec['tokens_per_s']:.0f} tokens/s, {rec['kernels_per_step']:.0f}"
        f" kernels a step, device busy {rec['device_busy_ms_per_step']:.3f}"
        f" ms a step (idle {rec['idle_share']:.3f}), flash launches a step "
        f"fwd/dq/dkv {moved[-1]}, SDPA routes {routes}; step-1 loss "
        f"{loss0:.6f}, loss {losses[0]:.4f} -> {losses[-1]:.4f} [{smi}]")
    del model, opt
    return rec


def nn_hidden(pt, state, arm, ids, mask):
    """The encoder's last hidden states (B, S, hidden) in float32, eval
    mode (no dropout), from `state`: arm "f32", "bf16" (O2 parameters,
    forward under `auto_cast`), or one of two f32 controls, faults the
    bf16 check must see: "no_mask" drops the key padding, "zero_attn"
    zeroes every layer's attention output projection."""
    import torch
    model = nn_encoder(pt, 0.1)
    if arm == "zero_attn":
        state = {k: torch.zeros_like(v) if ".self_attn.out_proj." in k
                 else v for k, v in state.items()}
    model.set_state_dict(state)
    bf16 = arm == "bf16"
    if bf16:
        model = pt.amp.decorate(model, level="O2", dtype="bfloat16")
    model.eval()
    with pt.no_grad(), pt.amp.auto_cast(enable=bf16, level="O2",
                                        dtype="bfloat16"):
        h = model.encoder(model.embed(ids),
                          None if arm == "no_mask" else mask)
    return h._data.float()


def nn_hidden_check(pt, smi, state):
    """Phase 22 (a)'s check of the bf16 path as a whole: the encoder's
    last hidden states in bf16 against f32 on one batch, per batch row,
    within NN_HIDDEN_RTOL; each control must fall outside it."""
    import torch
    dev = torch.device(pt.get_device().replace("gpu", "cuda"))
    ids, mask, _ = nn_batch(pt, dev)
    ref = nn_hidden(pt, state, "f32", ids, mask)
    rel = {}
    for arm in ("bf16", "no_mask", "zero_attn"):
        h = nn_hidden(pt, state, arm, ids, mask)
        if not bool(torch.isfinite(h).all()):
            raise AssertionError(f"phase 22 (a): {arm} hidden states are "
                                 "not finite")
        rel[arm] = [float(x) for x in (h - ref).flatten(1).norm(dim=1)
                    / ref.flatten(1).norm(dim=1)]
    worst = {k: max(v) for k, v in rel.items()}
    log("nn encoder last hidden states against f32 (eval, largest "
        "relative error of a batch row; rows 0-3 padded): "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f" (tol {NN_HIDDEN_RTOL}) [{smi}]")
    if not worst["bf16"] <= NN_HIDDEN_RTOL:
        raise AssertionError(f"phase 22 (a): bf16 hidden states differ "
                             f"from f32's by {worst['bf16']} (per row "
                             f"{rel['bf16']})")
    for arm in ("no_mask", "zero_attn"):
        if not worst[arm] > NN_HIDDEN_RTOL:
            raise AssertionError(f"phase 22 (a): the {arm} control "
                                 f"({worst[arm]}) passes the bf16 check")
    return {"rel_err_per_row": rel, "worst": worst, "tol": NN_HIDDEN_RTOL}


def nn_encoder_phase(pt, smi, out_dir):
    """Phase 22 (a): both arms from one set of weights."""
    import gc
    import torch
    pt.seed(22)
    state = {k: v._data.detach().clone()
             for k, v in nn_encoder(pt, 0.1).state_dict().items()}
    out = {}
    for arm in ("f32", "bf16"):
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        out[arm] = nn_train_arm(pt, smi, arm, state, out_dir)
    gc.collect()
    out["hidden"] = nn_hidden_check(pt, smi, state)
    a, b = out["f32"]["step1_loss"], out["bf16"]["step1_loss"]
    rel = abs(b - a) / abs(a)
    out["step1_loss_rel_err"] = rel
    log(f"nn encoder step-1 loss (dropout off) bf16 {b:.6f} vs f32 "
        f"{a:.6f}: rel err {rel:.2e} (tol {NN_LOSS_RTOL}) [{smi}]")
    if not rel <= NN_LOSS_RTOL:
        raise AssertionError(f"phase 22 (a): bf16 step-1 loss {b} differs "
                             f"from f32's {a} by {rel}")
    return out


def nn_small_stages(pt, smi, dev):
    """Phase 22 (b): phase 21's small MLP step written with `nn.Sequential`,
    `nn.CrossEntropyLoss` and `optimizer.SGD`, beside phase 21's raw-torch
    step, in turns; the host us of each stage (forward, backward, the
    update, clearing the gradients, the loss read that closes the step)."""
    import numpy as np
    import torch
    _, B, D, H, C = EAGER_SIZES[0]
    init = mlp_init(dev, D, H, C)
    x0, y0 = mlp_data(dev, B, D, C)
    nn = pt.nn
    net = nn.Sequential(nn.Linear(D, H), nn.ReLU(), nn.Linear(H, H),
                        nn.ReLU(), nn.Linear(H, C))
    net.set_state_dict(dict(zip(("0.weight", "0.bias", "2.weight",
                                 "2.bias", "4.weight", "4.bias"), init)))
    lf = nn.CrossEntropyLoss()
    opt = pt.optimizer.SGD(EAGER_LR, parameters=net.parameters())
    x, y = pt.to_tensor(x0), pt.to_tensor(y0)
    ps = [t.clone().requires_grad_() for t in init]
    zero = torch.tensor(0.0)
    stages = ("forward", "backward", "update", "clear_grad", "read")
    times = {"layer": [], "torch": []}

    def layer_step():
        t = [time.perf_counter()]
        loss = lf(net(x), y)
        t.append(time.perf_counter())
        loss.backward()
        t.append(time.perf_counter())
        opt.step()
        t.append(time.perf_counter())
        opt.clear_grad()
        t.append(time.perf_counter())
        v = float(loss)
        t.append(time.perf_counter())
        times["layer"].append([(b - a) * 1e6 for a, b in zip(t, t[1:])])
        return v

    def torch_step():
        w1, b1, w2, b2, w3, b3 = ps
        t = [time.perf_counter()]
        h = torch.maximum(x0 @ w1 + b1, zero)
        h = torch.maximum(h @ w2 + b2, zero)
        z = h @ w3 + b3
        loss = (torch.logsumexp(z, -1)
                - torch.take_along_dim(z, y0, 1).squeeze(1)).mean()
        t.append(time.perf_counter())
        loss.backward()
        t.append(time.perf_counter())
        with torch.no_grad():
            for p in ps:
                p.sub_(p.grad * EAGER_LR)
        t.append(time.perf_counter())
        for p in ps:
            p.grad = None
        t.append(time.perf_counter())
        v = loss.item()
        t.append(time.perf_counter())
        times["torch"].append([(b - a) * 1e6 for a, b in zip(t, t[1:])])
        return v

    losses, _, _ = interleaved_steps({"layer": layer_step,
                                      "torch": torch_step},
                                     NN_SMALL_WARMUP, NN_SMALL_STEPS)
    rec = {"B": B, "D": D, "H": H, "C": C, "steps": NN_SMALL_STEPS,
           "card": smi}
    for arm, ts in times.items():
        a = np.asarray(ts[NN_SMALL_WARMUP:])
        rec[arm] = {s: quartiles(a[:, i]) for i, s in enumerate(stages)}
        rec[arm]["step"] = quartiles(a.sum(1))
    rec["excess_us_p50"] = {s: rec["layer"][s][1] - rec["torch"][s][1]
                            for s in stages + ("step",)}
    a, b = np.asarray(losses["layer"]), np.asarray(losses["torch"])
    rec["loss_rel_err"] = float(np.max(np.abs(a - b) / np.abs(b)))
    for arm in ("layer", "torch"):
        log(f"nn small step {arm} (B={B} D={D} H={H} C={C}, {NN_SMALL_STEPS}"
            " steps in turns), host us p25/p50/p75: " + "; ".join(
                f"{s} " + "/".join(f"{v:.1f}" for v in rec[arm][s])
                for s in stages + ("step",)) + f" [{smi}]")
    log("nn small step, Layer API over raw torch at the median (us): "
        + ", ".join(f"{s} {v:+.1f}" for s, v in rec["excess_us_p50"].items())
        + f"; losses rel err {rec['loss_rel_err']:.2e} [{smi}]")
    if not rec["loss_rel_err"] <= 1e-5:
        raise AssertionError("phase 22 (b): the Layer step's losses differ "
                             f"from raw torch's by {rec['loss_rel_err']}")
    for arm, ls in losses.items():
        if not ls[-1] < ls[0]:
            raise AssertionError(f"phase 22 (b) {arm}: the loss did not "
                                 f"fall ({ls[0]} -> {ls[-1]})")
    return rec


def nn_optimizers(pt, smi, cuda="gpu"):
    """Phase 22 (c): every optimizer arm of the CPU tests, 3 steps from
    fixed parameters and gradients, plain and with ClipGradByGlobalNorm
    and the arm's decay, on CUDA against the port on the CPU (f32, TF32
    off); and GradScaler skipping the step of an injected inf."""
    import numpy as np
    tests = _test_module("test_torch_optimizer")
    rng = np.random.RandomState(4)
    p0 = {"w": rng.randn(4, 3).astype(np.float32),
          "bias": rng.randn(3).astype(np.float32)}
    grads = [{n: rng.randn(*v.shape).astype(np.float32)
              for n, v in p0.items()} for _ in range(3)]

    def run(name, arm):
        lin = pt.nn.Linear(4, 3)
        lin.set_state_dict({"weight": p0["w"], "bias": p0["bias"]})
        lin.weight.name, lin.bias.name = "w", "bias"
        kw, decay = tests._OPTS[name]
        kw = dict(kw)
        if arm == "clip_decay":
            kw.update(decay, grad_clip=pt.nn.ClipGradByGlobalNorm(0.05))
        opt = tests._cls(pt, name)(parameters=lin.parameters(), **kw)
        for g in grads:
            lin.weight.grad, lin.bias.grad = g["w"], g["bias"]
            opt.step()
        return [lin.weight.numpy(), lin.bias.numpy()]

    failures, n, worst = [], 0, 0.0
    for name in tests._OPTS:
        for arm in ("plain", "clip_decay"):
            n += 1
            got = _on(pt, cuda, lambda: run(name, arm))
            want = _on(pt, "cpu", lambda: run(name, arm))
            for g, w in zip(got, want):
                worst = max(worst, float(np.max(np.abs(g - w)
                                                / np.maximum(np.abs(w),
                                                             1.0))))
                if not np.allclose(g, w, rtol=NN_OPT_TOL, atol=NN_OPT_TOL):
                    failures.append(f"{name}/{arm}")
    amp = _test_module("test_torch_amp")
    state = _on(pt, "cpu", lambda: {k: v.numpy() for k, v in
                                    amp._net(pt).state_dict().items()})
    sc_gpu, _ = _on(pt, cuda, lambda: amp._scaler_run(pt, state))
    sc_cpu, _ = _on(pt, "cpu", lambda: amp._scaler_run(pt, state))
    flags = [(s, k) for s, k, _ in sc_gpu]
    if flags != [(s, k) for s, k, _ in sc_cpu] or not flags[2][1] \
            or any(k for i, (_, k) in enumerate(flags) if i != 2):
        failures.append(f"GradScaler: {flags}")
    for (_, _, g), (_, _, w) in zip(sc_gpu, sc_cpu):
        if not np.allclose(g, w, rtol=NN_OPT_TOL, atol=NN_OPT_TOL):
            failures.append("GradScaler weights")
    agree = n - len([f for f in failures if "/" in f])
    log(f"optimizers on CUDA against the CPU: {agree} of {n} arms agree "
        f"within {NN_OPT_TOL} (worst {worst:.2e}); GradScaler scale/skip "
        f"{flags} [{smi}]")
    if failures:
        raise AssertionError(f"phase 22 (c): {failures}")
    return {"arms": n, "worst_rel_err": worst, "scaler": flags, "card": smi}


def nn_tables(pt, smi, cuda="gpu"):
    """Phase 22 (d): the CPU tests' functional table (`FN_TABLE`) and Layer
    table (`LAYER_TABLE`) on CUDA against the port on the CPU, through the
    tests' own comparisons (`compare_fn_runs`, `compare_layer_runs`):
    integer and index results exact, floats at each case's tolerance,
    values and gradients (and a Layer's parameter gradients and buffers)."""
    fn = _test_module("test_torch_nn_functional")
    ly = _test_module("test_torch_nn_layers")
    ops = _test_module("test_torch_tensor_ops")
    failures, n = [], 0
    for case in fn.FN_TABLE:
        n += 1
        try:
            arrays = case.inputs()
            grad = case.grad and any(a.dtype.kind == "f" for a in arrays)
            got, want = (_on(pt, d, lambda: ops.run_case(pt, case, arrays,
                                                         grad=grad))
                         for d in (cuda, "cpu"))
            fn.compare_fn_runs(got, want, case, arrays)
        except Exception as e:      # noqa: BLE001 - every case is reported
            failures.append(f"{case.id}: {type(e).__name__}: "
                            f"{' '.join(str(e).split())[:300]}")
    n_fn = n
    for case in ly.LAYER_TABLE:
        n += 1
        try:
            arrays = case.inputs()
            state = _on(pt, "cpu", lambda: {
                k: v.numpy() for k, v in case.ctor(pt).state_dict().items()})

            def run(state=state):
                layer = case.ctor(pt)
                layer.set_state_dict(state)
                return ly._run(pt, case, arrays, layer)
            ly.compare_layer_runs(_on(pt, cuda, run), _on(pt, "cpu", run),
                                  case, arrays)
        except Exception as e:      # noqa: BLE001
            failures.append(f"{case.id}: {type(e).__name__}: "
                            f"{' '.join(str(e).split())[:300]}")
    log(f"nn tables on CUDA against the CPU: {n - len(failures)} of {n} "
        f"cases agree ({n_fn} functional, {n - n_fn} Layer) [{smi}]")
    for f in failures:
        log(f"  nn table FAILED {f}")
    if failures:
        raise AssertionError(f"phase 22 (d): {len(failures)} of {n} cases "
                             "disagree between CUDA and the CPU")
    return {"cases": n, "functional": n_fn, "layers": n - n_fn, "card": smi}


def nn_flash_masked(smi):
    """Phase 22 (e): the flash kernels' mask (and mask + dropout) builds at
    the encoder's attention shape, against their plain versions, timed;
    SDPA with the same float mask (no dropout) as the library
    yardstick."""
    import torch
    import torch.nn.functional as TF
    from paddle_tpu_torch.ops import flash_attention as fa
    c = NN_FLASH
    B, H, S, D = c["B"], c["H"], c["S"], c["D"]
    g = torch.Generator(device="cuda").manual_seed(2200)

    def rnd():
        return torch.randn((B * H, S, D), generator=g, device="cuda") \
            .to(torch.bfloat16)
    q, k, v, do = rnd(), rnd(), rnd(), rnd()
    keep = torch.ones((B, 1, 1, S), dtype=torch.bool, device="cuda")
    keep[:B // 2, ..., S - c["pad"]:] = False
    add = torch.where(keep, 0.0, torch.finfo(torch.float32).min)
    mask4 = add.broadcast_to((B, 1, S, S))
    mf = mask4.contiguous().reshape(B, S, S)
    flush_buf = torch.empty(64 * 1024 * 1024, device="cuda")
    flush = lambda: _flush_l2(flush_buf)      # noqa: E731
    out = {"shape": [B, H, S, D], "mask": [B, 1, S, S], "card": smi}
    for rate in (0.0, 0.1):
        meta = fa.Meta(H=H, Hk=H, Bm=B, Hm=1, causal=False, scale=D ** -0.5,
                       rate=rate, seed=2201)
        po, plse = fa.fwd_plain(q, k, v, mf, meta)
        delta = (do.float() * po.float()).sum(-1)
        kern = {"fwd": lambda: fa.flash_fwd(q, k, v, mf, meta),
                "dq": lambda: fa.flash_dq(q, k, v, do, plse, delta, mf, meta),
                "dkv": lambda: fa.flash_dkv(q, k, v, do, plse, delta, mf,
                                            meta)}
        plain = {"fwd": lambda: fa.fwd_plain(q, k, v, mf, meta),
                 "dq": lambda: fa.dq_plain(q, k, v, do, plse, delta, mf,
                                           meta),
                 "dkv": lambda: fa.dkv_plain(q, k, v, do, plse, delta, mf,
                                             meta)}
        got = {w: kern[w]() for w in kern}
        want = {w: plain[w]() for w in plain}
        torch.cuda.synchronize()
        errs = {}
        for w, names in (("fwd", ("o",)), ("dq", ("dq",)),
                         ("dkv", ("dk", "dv"))):
            gs = got[w][:1] if w == "fwd" else (
                (got[w],) if w == "dq" else got[w])
            ws = want[w][:1] if w == "fwd" else (
                (want[w],) if w == "dq" else want[w])
            for name, a, b in zip(names, gs, ws):
                err = (a.float() - b.float()).abs()
                bad = (err > BF16_TOL + BF16_TOL * b.float().abs()) \
                    | ~torch.isfinite(a)
                errs[name] = float(err.max())
                if bool(bad.any()):
                    raise AssertionError(
                        f"phase 22 (e) dropout={rate}: {name} disagrees "
                        f"with the plain version (max_abs_err "
                        f"{errs[name]}, tol {BF16_TOL})")
        rec = {"max_abs_err": errs}
        for w in kern:
            bound, by, nbytes, flops = flash_bound(B, H, H, S, D, "bf16",
                                                   False, w)
            nbytes += B * S * S * 4             # the f32 mask, read once
            t_bytes = nbytes / device_peaks("bf16").hbm_bw * 1e3
            t_ops = flops / device_peaks("bf16").peak_flops * 1e3
            rec[w] = {"ms": time_ms(kern[w], flush),
                      "plain_ms": time_ms(plain[w], flush, iters=5),
                      "bound_ms": max(t_bytes, t_ops),
                      "bound_by": "bytes" if t_bytes >= t_ops
                      else "operations"}
        out[f"dropout_{rate}"] = rec
        log(f"flash mask build at B={B} H={H} S={S} D={D} bf16, mask "
            f"[{B}, 1, {S}, {S}] f32, dropout {rate}: " + "; ".join(
                f"{w} {rec[w]['ms']:.4f} ms (plain {rec[w]['plain_ms']:.4f},"
                f" bound {rec[w]['bound_ms']:.5f} {rec[w]['bound_by']})"
                for w in kern) + "; max_abs_err " + " ".join(
                f"{n_}={e:.2e}" for n_, e in errs.items())
            + f" (tol {BF16_TOL}) [{smi}]")
    q4, k4, v4, do4 = (t.reshape(B, H, S, D) for t in (q, k, v, do))
    m4 = mask4.to(torch.bfloat16)
    qg, kg, vg = (t.detach().requires_grad_(True) for t in (q4, k4, v4))

    def sdpa_fwd():
        return TF.scaled_dot_product_attention(q4, k4, v4, attn_mask=m4)

    def sdpa_fwd_bwd():
        o = TF.scaled_dot_product_attention(qg, kg, vg, attn_mask=m4)
        torch.autograd.backward(o, do4)
    lib_fwd = time_ms(sdpa_fwd, flush)
    out["sdpa_fwd_ms"] = lib_fwd
    out["sdpa_bwd_ms"] = time_ms(sdpa_fwd_bwd, flush) - lib_fwd
    log(f"sdpa yardstick with the same mask (bf16, no dropout): forward "
        f"{lib_fwd:.4f} ms, backward {out['sdpa_bwd_ms']:.4f} ms [{smi}]")
    del flush_buf
    return out


def nn_sdpa_new_builds(pt, smi):
    """SDPA on the inputs the reference sends to its flash kernels and
    the port built kernels for in PR 19 (head dim 256, float16; ROADMAP
    B.4): each takes the kernel route, launches the forward kernel once
    and agrees with the plain attention on the same inputs."""
    import numpy as np
    import torch
    from paddle_tpu_torch.nn.functional import attention as ta
    from paddle_tpu_torch.ops import flash_attention as fa
    rng = np.random.RandomState(0)
    out = {}
    for name, D, dtype in (("d256_bf16", 256, "bfloat16"),
                           ("d64_fp16", 64, "float16"),
                           ("d256_fp16", 256, "float16")):
        x = pt.to_tensor(rng.randn(1, 128, 2, D).astype(np.float32),
                         place="gpu").astype(dtype)
        routes, counts = dict(ta.sdpa_routes), _flash_counts()
        got = pt.nn.functional.scaled_dot_product_attention(x, x, x)
        torch.cuda.synchronize()
        moved = {k: ta.sdpa_routes[k] - routes[k] for k in routes}
        launched = [a - b for a, b in zip(_flash_counts(), counts)]
        if moved != {"kernel": 1, "plain": 0} or launched != [1, 0, 0]:
            raise AssertionError(f"SDPA {name}: routes {moved}, flash "
                                 f"launches {launched}; want the kernel "
                                 "route and one forward launch")
        t = x._data.transpose(1, 2)
        want = fa.reference_attention_bhsd(t, t, t).transpose(1, 2).float()
        diff = (got._data.float() - want).abs()
        tol = F16_TOL if dtype == "float16" else BF16_TOL
        err = float(diff.max())
        if bool((diff > tol + tol * want.abs()).any()):
            raise AssertionError(f"SDPA {name}: kernel route differs from "
                                 f"the plain attention by {err} (tol {tol})")
        out[name] = {"max_abs_err": err, "tol": tol}
    log("SDPA at head dim 256 and in float16 on the kernel route: "
        + "; ".join(f"{k} max_abs_err {v['max_abs_err']:.2e}"
                    for k, v in out.items()) + f" [{smi}]")
    return out


def nn_phase(smi):
    """Phase 22: the port's `nn`, `optimizer` and `amp` on the card
    (module docstring)."""
    import gc
    import torch
    import paddle_tpu_torch as pt
    t0 = time.perf_counter()
    # the encoder steps' traces are tens of MB: parsed, then removed
    out_dir = os.path.join(ROOT, "build", "phase22")
    pt.set_device("gpu")
    try:
        out = {"encoder": nn_encoder_phase(pt, smi, out_dir)}
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["small_step"] = nn_small_stages(pt, smi, torch.device("cuda"))
    out["optimizers"] = nn_optimizers(pt, smi)
    out["tables"] = nn_tables(pt, smi)
    out["sdpa_new_builds"] = nn_sdpa_new_builds(pt, smi)
    out["flash_masked"] = nn_flash_masked(smi)
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 22 took {out['seconds']:.1f} s [{smi}]")
    return out


# ---------------------------------------------------------------------------
# Phase 23: io, metric, hapi and vision on the card: Model.fit on ResNet-50
# ---------------------------------------------------------------------------

HAPI_B = 128                    # (a), (e): CIFAR-10's batch in BASELINE.json
HAPI_WARMUP, HAPI_STEPS = 3, 21
HAPI_PROFILED = 3               # steps under deviceprof.capture
HAPI_TF32_STEPS = 10            # (a): the fixed-batch arms, f32 and TF32
HAPI_LEARN_STEPS = 60           # (b): steps of the banded labelling
HAPI_LEARN_LR = 0.02
# (b): the last 5 losses' mean under this share of the first 5's, and
# held-out accuracy above HAPI_EVAL_ACC; the H100 read shares of 0.009,
# 0.011 and 0.106 and accuracies of 0.961, 0.998 and 0.818 over three
# runs (PERF.md; cuDNN's backward is not deterministic, and the batch
# order was unseeded then; it is seeded now)
HAPI_LOSS_SHARE = 0.5
HAPI_EVAL_ACC = 0.5
# (c) (i): Model.train_batch against the eager loop, largest error of the
# largest magnitude; the H100 read 0 (bit for bit), the no-decay control
# 5.0e-5 (PERF.md)
HAPI_EAGER_RTOL = 1e-6
# (c) (ii): the card against the CPU at B=8, ||a - b|| / ||b|| of the
# eval logits and the first step's loss. Train-mode BatchNorm over 8
# values at layer4's 1x1 maps is ill-conditioned in float32 (the CPU's
# float32 logits read 1.5e-4 from its float64 ones; the H100 2.2e-4 from
# the CPU's float32, PERF.md): there the card is held to the CPU's
# float64 forward, at most HAPI_F64_FACTOR times the CPU float32 error
HAPI_CPU_RTOL = 1e-4
HAPI_F64_FACTOR = 3.0
HAPI_ROUTE_STEPS = 5            # (d): Model.fit over the 2-layer encoder
HAPI_ENGINE_BATCHES = 20        # (e): batches an engine
HAPI_VISION_RTOL = 1e-4         # (f): of the largest magnitude


def _bands(n, seed):
    """A learnable labelling of FakeData's images: ten horizontal bands,
    the label's band made the brightest."""
    import numpy as np
    import paddle_tpu_torch as pt

    class Banded(pt.vision.datasets.FakeData):
        def __getitem__(self, idx):
            img, label = super().__getitem__(idx)
            img = img * 0.5
            rows = np.array_split(np.arange(img.shape[1]), 10)[int(label)]
            img[:, rows] += 0.5
            return img, label
    return Banded(n, (3, 32, 32), 10, seed=seed)


class _StepTimer:
    """A Model callback: each train step's host ms (batch begin -> end,
    the step ending in its loss read) and the losses."""

    @staticmethod
    def make(pt):
        class T(pt.callbacks.Callback):
            def __init__(self):
                super().__init__()
                self.ms, self.losses = [], []

            def on_train_batch_begin(self, step, logs=None):
                self._t0 = time.perf_counter()

            def on_train_batch_end(self, step, logs=None):
                self.ms.append((time.perf_counter() - self._t0) * 1e3)
                self.losses.append(logs["loss"])
        return T()


def _resnet_model(pt, seed=23, wd=5e-4, lr=0.1, sync_bn=False):
    pt.seed(seed)
    net = pt.vision.models.resnet50(num_classes=10)
    if sync_bn:
        net = pt.nn.SyncBatchNorm.convert_sync_batchnorm(net)
    model = pt.Model(net)
    model.prepare(pt.optimizer.Momentum(learning_rate=lr, momentum=0.9,
                                        parameters=net.parameters(),
                                        weight_decay=wd),
                  pt.nn.CrossEntropyLoss(), pt.metric.Accuracy())
    return model


def _wait_hist():
    """`dataloader_wait_seconds`: (bucket bounds, counts by bucket)."""
    from paddle_tpu_torch import io as tio
    child = tio._DL_WAIT._require_default()
    return child.buckets, list(child.counts)


def _hist_median_s(bounds, before, after):
    """The upper bound of the bucket that holds the median observation
    between two reads of a histogram's counts (inf: the overflow)."""
    counts = [b - a for a, b in zip(before, after)]
    half, seen = sum(counts) / 2, 0
    for bound, c in zip(list(bounds) + [float("inf")], counts):
        seen += c
        if seen >= half:
            return bound
    return float("inf")


class _TimedLoader:
    """A DataLoader as Model.fit's train data, timing each batch's wait
    (the `next()` on the loader, which the DataLoader span measures)."""

    def __init__(self, loader):
        self.loader, self.waits = loader, []

    def __len__(self):
        return len(self.loader)

    def __iter__(self):
        it = iter(self.loader)
        while True:
            t = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.waits.append((time.perf_counter() - t) * 1e3)
            yield batch


def hapi_resnet_fit(pt, smi, out_dir):
    """Phase 23 (a): ResNet-50 through Model.fit at CIFAR-10's shapes, fed
    by two ring workers; then its device profile and the TF32 arm."""
    import numpy as np
    import torch
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch import native
    from paddle_tpu_torch.observability import deviceprof
    if not native.available():
        raise AssertionError(f"phase 23 (a): the ring library did not "
                             f"build: {native.build_error()}")
    n_steps = HAPI_WARMUP + HAPI_STEPS
    ds = pt.vision.datasets.FakeData(HAPI_B * n_steps, (3, 32, 32), 10)
    model = _resnet_model(pt)
    timer = _StepTimer.make(pt)
    loader = _TimedLoader(tio.DataLoader(ds, batch_size=HAPI_B,
                                         shuffle=True, num_workers=2,
                                         drop_last=True))
    tio.reset_engine_stats()
    np.random.seed(23)                  # the sampler's shuffle
    bounds, c0 = _wait_hist()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.fit(loader, epochs=1, verbose=0, callbacks=[timer])
    fit_s = time.perf_counter() - t0
    _, c1 = _wait_hist()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    stats = tio.engine_stats()
    if stats["ring"] != n_steps or sum(stats["ring_by_worker"].values()) \
            != n_steps:
        raise AssertionError(f"phase 23 (a): the ring engine handed over "
                             f"{stats}, want all {n_steps} batches")
    if any(p.grad is not None for p in model.parameters()):
        raise AssertionError("phase 23 (a): Model's step filled a .grad")
    times = timer.ms[HAPI_WARMUP:]
    quart = quartiles(times)
    rec = {"B": HAPI_B, "steps": HAPI_STEPS, "warmup": HAPI_WARMUP,
           "step_ms_quartiles": quart, "step_ms_median": quart[1],
           "img_per_s": HAPI_B / (quart[1] / 1e3),
           "wait_ms_quartiles": quartiles(loader.waits[HAPI_WARMUP:]),
           "first_wait_ms": loader.waits[0],
           "wait_hist_median_bucket_s": _hist_median_s(bounds, c0, c1),
           "dataloader_waits": sum(c1) - sum(c0), "engine": stats,
           "losses": timer.losses, "fit_s": fit_s, "peak_gb": peak_gb,
           "card": smi}
    log(f"hapi resnet50 Model.fit (B={HAPI_B}, 3x32x32 FakeData, 2 ring "
        f"workers, Momentum 0.1/0.9, decay 5e-4, f32, TF32 off): step ms "
        f"p25/p50/p75 " + "/".join(f"{v:.3f}" for v in quart)
        + f" ({HAPI_STEPS} after {HAPI_WARMUP}), {rec['img_per_s']:.1f} "
        f"img/s; the wait on the loader a step p25/p50/p75 "
        + "/".join(f"{v:.3f}" for v in rec["wait_ms_quartiles"])
        + f" ms (the first {rec['first_wait_ms']:.1f} ms, workers "
        f"starting), dataloader_wait_seconds' median in the bucket <= "
        f"{rec['wait_hist_median_bucket_s']} s over "
        f"{rec['dataloader_waits']}; ring batches by worker "
        f"{stats['ring_by_worker']}; peak {peak_gb:.2f} GB; loss "
        f"{timer.losses[0]:.4f} -> {timer.losses[-1]:.4f} [{smi}]")

    # the same step on one fixed batch with TF32 off (as above) and on
    # (torch's own default for cuDNN), in turns, before any profiler
    # session is opened
    x, y = next(iter(tio.DataLoader(ds, batch_size=HAPI_B)))

    def timed(n):
        out = []
        for _ in range(n):
            t = time.perf_counter()
            model.train_batch([x], [y])
            out.append((time.perf_counter() - t) * 1e3)
        return out
    arms = {"f32": [], "tf32": []}
    try:
        for _ in range(2):
            for arm in ("f32", "tf32"):
                torch.backends.cudnn.allow_tf32 = arm == "tf32"
                timed(1)
                arms[arm] += timed(HAPI_TF32_STEPS // 2)
    finally:
        torch.backends.cudnn.allow_tf32 = False
    rec["fixed_batch_step_ms"] = {k: quartiles(v) for k, v in arms.items()}
    log("hapi resnet50 fixed-batch step ms p25/p50/p75, cuDNN TF32 off / "
        "on (in turns): " + "; ".join(
            f"{k} " + "/".join(f"{v:.3f}" for v in q)
            for k, q in rec["fixed_batch_step_ms"].items()) + f" [{smi}]")
    # the step's device profile on one fixed batch
    _, prof = deviceprof.capture(lambda: model.train_batch([x], [y]),
                                 out_dir, iters=HAPI_PROFILED,
                                 label="hapi_resnet50")
    busy = prof["total_device_ms"] / HAPI_PROFILED
    rec.update({"kernels_per_step": prof["n_events"] / HAPI_PROFILED,
                "device_busy_ms_per_step": busy,
                "idle_share": 1.0 - busy / quart[1],
                "top_ops": [{"op": o["op"], "prim": o["prim"],
                             "calls": o["calls"] / HAPI_PROFILED,
                             "ms_per_step": o["device_ms"] / HAPI_PROFILED}
                            for o in prof["ops"][:12]]})
    log(f"hapi resnet50 step device profile: {rec['kernels_per_step']:.0f} "
        f"kernels a step, device busy {busy:.3f} ms a step (idle "
        f"{rec['idle_share']:.3f} of the fit's median step) [{smi}]")
    for o in rec["top_ops"]:
        log(f"  {o['ms_per_step']:.4f} ms a step x{o['calls']:.0f} "
            f"{o['prim']} {o['op'][:64]}")
    del model
    return rec


def hapi_learns(pt, smi, out_dir):
    """Phase 23 (b): the loss falls on a learnable labelling; evaluate,
    predict and a save / load round trip."""
    import numpy as np
    import torch
    train = _bands(HAPI_B * HAPI_LEARN_STEPS, seed=0)
    held = _bands(512, seed=10 ** 6)
    model = _resnet_model(pt, seed=24, lr=HAPI_LEARN_LR)
    timer = _StepTimer.make(pt)
    np.random.seed(24)                  # the sampler's shuffle
    model.fit(train, batch_size=HAPI_B, epochs=1, shuffle=True,
              num_workers=2, verbose=0, callbacks=[timer])
    losses = timer.losses
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    res = model.evaluate(held, batch_size=HAPI_B)
    preds = model.predict(held, batch_size=HAPI_B, stack_outputs=True)
    rec = {"steps": len(losses), "losses": losses, "first5": first,
           "last5": last, "share": last / first,
           "eval": {"acc": float(res["acc"]),
                    "loss": [float(v) for v in res["loss"]]},
           "predict_shape": list(preds[0].shape), "card": smi}
    log(f"hapi resnet50 learns the banded labelling: loss (mean of 5) "
        f"{first:.4f} -> {last:.4f} over {len(losses)} steps (share "
        f"{last / first:.3f}, want < {HAPI_LOSS_SHARE}); held-out acc "
        f"{res['acc']:.4f} (chance 0.1, want > {HAPI_EVAL_ACC}), loss "
        f"{res['loss'][0]:.4f}; predict {rec['predict_shape']} [{smi}]")
    if not (np.all(np.isfinite(losses)) and last < HAPI_LOSS_SHARE * first):
        raise AssertionError(f"phase 23 (b): the loss did not fall enough "
                             f"({first} -> {last})")
    if not res["acc"] > HAPI_EVAL_ACC:
        raise AssertionError(f"phase 23 (b): held-out accuracy "
                             f"{res['acc']}")
    if list(preds[0].shape) != [512, 10]:
        raise AssertionError(f"phase 23 (b): predict gave {preds[0].shape}")
    x = np.stack([held[i][0] for i in range(16)])
    path = os.path.join(out_dir, "resnet50")
    torch.backends.cudnn.deterministic = True
    try:
        before = model.predict_batch([x])[0]
        model.save(path)
        fresh = _resnet_model(pt, seed=99, lr=HAPI_LEARN_LR)
        fresh.load(path)
        after = fresh.predict_batch([x])[0]
    finally:
        torch.backends.cudnn.deterministic = False
    rec["save_load_equal"] = bool(np.array_equal(before, after))
    log(f"hapi Model.save -> load: eval logits equal bit for bit: "
        f"{rec['save_load_equal']} [{smi}]")
    if not rec["save_load_equal"]:
        raise AssertionError("phase 23 (b): the loaded model's logits "
                             "differ from the saved one's")
    return rec


def _rel(a, b):
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def hapi_parity(pt, smi, cuda="gpu"):
    """Phase 23 (c): (i) Model.train_batch against the eager loop on two
    copies of ResNet-50 and one batch, with a control the check must
    reject (weight decay left out of the eager arm); (ii) the card's
    first step against the port's on the CPU at B=8."""
    import numpy as np
    import torch
    from paddle_tpu_torch.nn import functional_call, functional_state
    ds = pt.vision.datasets.FakeData(64, (3, 32, 32), 10)
    xs = np.stack([ds[i][0] for i in range(32)])
    ys = np.stack([ds[i][1] for i in range(32)])
    x, y = pt.to_tensor(xs), pt.to_tensor(ys)
    torch.backends.cudnn.deterministic = True
    out = {"card": smi}
    try:
        state = {k: v._data.detach().clone() for k, v in
                 _resnet_model(pt).network.state_dict().items()}

        def eager_arm(wd):
            net = pt.vision.models.resnet50(num_classes=10)
            net.set_state_dict(state)
            opt = pt.optimizer.Momentum(0.1, momentum=0.9,
                                        parameters=net.parameters(),
                                        weight_decay=wd)
            loss = pt.nn.CrossEntropyLoss()(net(x), y)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return float(loss), net
        model = _resnet_model(pt)
        model.network.set_state_dict(state)
        mloss = model.train_batch([x], [y])[0][0]
        errs = {}
        for arm, wd in (("eager", 5e-4), ("control_no_decay", None)):
            eloss, net = eager_arm(wd)
            mine = dict(model.network.state_dict())
            theirs = dict(net.state_dict())
            errs[arm] = {"loss": abs(mloss - eloss) / abs(eloss),
                         "params": max(_rel(mine[k].numpy(),
                                            theirs[k].numpy())
                                       for k, _ in net.named_parameters()),
                         "buffers": max(_rel(mine[k].numpy(),
                                             theirs[k].numpy())
                                        for k, _ in net.named_buffers())}
        out["train_batch_vs_eager"] = errs
        log(f"hapi Model.train_batch vs the eager loop (ResNet-50, B=32, "
            f"f32, cudnn.deterministic): largest relative error (of the "
            f"largest magnitude) loss {errs['eager']['loss']:.3e}, "
            f"parameters {errs['eager']['params']:.3e}, BatchNorm buffers "
            f"{errs['eager']['buffers']:.3e} (tol {HAPI_EAGER_RTOL}); "
            f"control without decay: parameters "
            f"{errs['control_no_decay']['params']:.3e} [{smi}]")
        e = errs["eager"]
        if max(e.values()) > HAPI_EAGER_RTOL:
            raise AssertionError(f"phase 23 (c): train_batch and the eager "
                                 f"loop differ: {e}")
        if not errs["control_no_decay"]["params"] > HAPI_EAGER_RTOL:
            raise AssertionError("phase 23 (c): the no-decay control "
                                 "passes the check")

        # (ii) the card against the CPU at B=8: the eval logits and the
        # first train step's loss; the train-mode logits held to the
        # CPU's float64 forward beside the CPU's float32 one
        x8, y8 = xs[:8], ys[:8]
        res = {}
        for dev, dtype in ((cuda, "float32"), ("cpu", "float32"),
                           ("cpu", "float64")):
            def run(dtype=dtype):
                m = _resnet_model(pt)
                m.network.set_state_dict(state)
                m.network.to(dtype=dtype)
                p, b = functional_state(m.network)
                xt = pt.to_tensor(x8, dtype=dtype)
                with torch.no_grad():
                    logits = {mode: functional_call(
                        m.network, p, b, args=(xt,), train=mode == "train")[0]
                        .numpy().astype(np.float64)
                        for mode in ("train", "eval")}
                loss = m.train_batch([x8], [y8])[0][0] \
                    if dtype == "float32" else None
                return logits, loss
            res[(dev, dtype)] = _on(pt, dev, run)

        def nrel(a, b):
            return float(np.linalg.norm(a - b) / np.linalg.norm(b))
        card, cpu32 = res[(cuda, "float32")], res[("cpu", "float32")]
        f64 = res[("cpu", "float64")][0]["train"]
        cpu = {"eval_logits": nrel(card[0]["eval"], cpu32[0]["eval"]),
               "loss": abs(card[1] - cpu32[1]) / abs(cpu32[1]),
               "train_logits_vs_f64": nrel(card[0]["train"], f64),
               "cpu_f32_train_logits_vs_f64": nrel(cpu32[0]["train"], f64)}
        out["card_vs_cpu"] = cpu
        log(f"hapi ResNet-50 at B=8, the card against the CPU (||a - b|| / "
            f"||b||): eval logits {cpu['eval_logits']:.3e}, the first "
            f"train step's loss {cpu['loss']:.3e} (tol {HAPI_CPU_RTOL}); "
            f"train-mode logits against the CPU's float64 forward: card "
            f"{cpu['train_logits_vs_f64']:.3e}, CPU float32 "
            f"{cpu['cpu_f32_train_logits_vs_f64']:.3e} (the card's at most "
            f"{HAPI_F64_FACTOR}x the CPU's) [{smi}]")
        if max(cpu["eval_logits"], cpu["loss"]) > HAPI_CPU_RTOL or \
                cpu["train_logits_vs_f64"] > HAPI_F64_FACTOR * \
                cpu["cpu_f32_train_logits_vs_f64"]:
            raise AssertionError(f"phase 23 (c): the card and the CPU "
                                 f"differ: {cpu}")
    finally:
        torch.backends.cudnn.deterministic = False
    return out


def hapi_kernel_route(pt, smi):
    """Phase 23 (d): Model.fit over phase 22's encoder cut to 2 layers
    (B=8, S=512, D=64 a head, bf16 O2, the key-padding mask): 2 launches
    of each flash kernel a step and every SDPA call on the kernel route."""
    import numpy as np
    from paddle_tpu_torch.nn.functional import attention as ta
    c = dict(NN_CFG, layers=2)
    V = c["vocab"]
    pt.seed(23)
    nn = pt.nn

    class Encoder(nn.Layer):
        def __init__(self):
            super().__init__()
            self.embed = nn.Embedding(V, c["hidden"])
            self.encoder = nn.TransformerEncoder(nn.TransformerEncoderLayer(
                c["hidden"], c["heads"], c["ff"], dropout=0.1,
                activation="gelu"), c["layers"])
            self.head = nn.Linear(c["hidden"], V)

        def forward(self, ids, mask):
            with pt.amp.auto_cast(level="O2", dtype="bfloat16"):
                logits = self.head(self.encoder(self.embed(ids), mask))
            return logits.astype("float32").reshape([-1, V])

    class Copy(pt.io.Dataset):
        def __len__(self):
            return c["B"] * HAPI_ROUTE_STEPS

        def __getitem__(self, i):
            rng = np.random.RandomState(i)
            ids = rng.randint(0, V, c["S"]).astype(np.int64)
            keep = np.ones((1, 1, c["S"]), bool)
            labels = ids.copy()
            if i % 2 == 0:
                keep[..., c["S"] - c["pad"]:] = False
                labels[c["S"] - c["pad"]:] = -100
            return ids, keep, labels

    net = Encoder()
    opt = pt.optimizer.AdamW(5e-4, parameters=net.parameters(),
                             weight_decay=0.01)
    net, opt = pt.amp.decorate(net, opt, level="O2", dtype="bfloat16")
    model = pt.Model(net)
    model.prepare(opt, lambda logits, labels: pt.nn.functional.cross_entropy(
        logits, labels.reshape([-1])))
    moved = []

    class Launches(pt.callbacks.Callback):
        def on_train_batch_begin(self, step, logs=None):
            self._before = _flash_counts()

        def on_train_batch_end(self, step, logs=None):
            moved.append(tuple(a - b for a, b in
                               zip(_flash_counts(), self._before)))
    rec = _StepTimer.make(pt)
    for k in ta.sdpa_routes:
        ta.sdpa_routes[k] = 0
    model.fit(Copy(), batch_size=c["B"], epochs=1, shuffle=False, verbose=0,
              callbacks=[Launches(), rec])
    routes = dict(ta.sdpa_routes)
    out = {"launches_per_step": moved, "sdpa_routes": routes,
           "losses": rec.losses, "step_ms": rec.ms, "card": smi}
    log(f"hapi Model.fit over the 2-layer encoder (B={c['B']}, S={c['S']}, "
        f"bf16 O2, key padding): flash launches fwd/dq/dkv a step "
        f"{sorted(set(moved))}, SDPA routes {routes}, loss "
        f"{rec.losses[0]:.4f} -> {rec.losses[-1]:.4f}, step ms "
        + "/".join(f"{v:.2f}" for v in rec.ms) + f" [{smi}]")
    want = c["layers"]
    if len(moved) != HAPI_ROUTE_STEPS or set(moved) != {(want,) * 3}:
        raise AssertionError(f"phase 23 (d): flash launches a step "
                             f"{moved}, want {want} of each")
    if routes["plain"] or routes["kernel"] != want * HAPI_ROUTE_STEPS:
        raise AssertionError(f"phase 23 (d): SDPA routes {routes}")
    if not np.all(np.isfinite(rec.losses)):
        raise AssertionError(f"phase 23 (d): losses {rec.losses}")
    return out


def hapi_engines(pt, smi):
    """Phase 23 (e): the DataLoader's engines over FakeData at B=128 with
    no model: serial, the ring with 2 and 4 workers, the prefetch thread;
    equal batches, batches/s each (in all, and after the first few)."""
    import torch
    ds = pt.vision.datasets.FakeData(HAPI_B * HAPI_ENGINE_BATCHES,
                                     (3, 32, 32), 10)
    arms = (("serial", dict()), ("ring2", dict(num_workers=2)),
            ("ring4", dict(num_workers=4)),
            ("thread", dict(num_workers=2, use_shared_memory=False)))
    out, ref = {"card": smi}, None
    settle = 4                  # batches before the steady-state clock
    for name, kw in arms:
        batches, stamps = [], []
        t0 = time.perf_counter()
        for x, y in pt.io.DataLoader(ds, batch_size=HAPI_B, **kw):
            batches.append((x._data, y._data))
            stamps.append(time.perf_counter())
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if ref is None:
            ref = batches
        equal = len(batches) == len(ref) and all(
            torch.equal(a, c) and torch.equal(b, d)
            for (a, b), (c, d) in zip(batches, ref))
        out[name] = {"batches_per_s": len(batches) / dt, "seconds": dt,
                     "steady_batches_per_s": (len(stamps) - settle)
                     / (stamps[-1] - stamps[settle - 1]),
                     "first_batch_s": stamps[0] - t0,
                     "equal": equal, "device": str(batches[0][0].device)}
    log(f"hapi DataLoader engines (FakeData 3x32x32, B={HAPI_B}, "
        f"{HAPI_ENGINE_BATCHES} batches to the card): batches/s in all "
        f"(worker start included) / after the first {settle}: " + ", ".join(
            f"{k} {v['batches_per_s']:.1f} / {v['steady_batches_per_s']:.1f}"
            f" (first batch {v['first_batch_s'] * 1e3:.0f} ms)"
            for k, v in out.items() if k != "card")
        + f"; all equal: {all(v['equal'] for k, v in out.items() if k != 'card')}"
        f" [{smi}]")
    bad = [k for k, v in out.items() if k != "card" and not v["equal"]]
    if bad:
        raise AssertionError(f"phase 23 (e): {bad} gave other batches")
    return out


def _vision_op_cases(pt):
    """[(name, fn(pt) -> list of numpy results)]: every op of
    `vision/ops.py` but the PIL ones, with input gradients where they
    flow, at small seeded shapes."""
    import numpy as np
    from paddle_tpu_torch.vision import ops as V

    def rng(s):
        return np.random.RandomState(s)

    def boxes(r, n, size, lo=1.0):
        xy = r.uniform(0, size * 0.6, (n, 2))
        wh = r.uniform(lo, size * 0.4, (n, 2))
        return np.concatenate([xy, xy + wh], 1).astype(np.float32)

    def grads(fn, *arrays):
        ts = [pt.to_tensor(a, stop_gradient=False) for a in arrays]
        o = fn(*ts)
        w = rng(5).uniform(0.5, 1.5, o.shape).astype(np.float32)
        (o * pt.to_tensor(w)).sum().backward()
        return [o.numpy()] + [t.grad.numpy() for t in ts]

    r = rng(1)
    x = r.rand(2, 8, 10, 12).astype(np.float32)
    b = boxes(r, 5, 10, 0.5)
    off = r.normal(0, 0.8, (2, 18, 7, 7)).astype(np.float32)
    w = r.normal(0, 0.3, (4, 3, 3, 3)).astype(np.float32)
    xd = r.rand(2, 3, 7, 7).astype(np.float32)
    mask = r.rand(2, 9, 7, 7).astype(np.float32)
    prior = boxes(r, 4, 20)
    target = np.repeat(boxes(r, 3, 20)[:, None], 4, 1)
    head = r.normal(0, 0.5, (2, 3 * 9, 4, 4)).astype(np.float32)
    gt = np.asarray([[[0.3, 0.4, 0.2, 0.3], [0.7, 0.2, 0.5, 0.4]],
                     [[0.55, 0.6, 0.1, 0.15], [0.1, 0.9, 0.3, 0.2]]],
                    np.float32)
    anchors = [10, 13, 16, 30, 33, 23, 30, 61, 62, 45, 59, 119]
    sc = r.rand(2, 3, 4, 5).astype(np.float32)
    deltas = r.normal(0, 0.3, (2, 12, 4, 5)).astype(np.float32)
    anc = boxes(r, 60, 64)

    def np_all(v):
        return [t.numpy() if hasattr(t, "numpy") else np.asarray(t)
                for t in (v if isinstance(v, (list, tuple)) else [v])]

    def deform_layer():
        layer = V.DeformConv2D(3, 4, 3, padding=1)
        layer.set_state_dict({"weight": w, "bias": rng(8).rand(4).astype(
            np.float32)})
        return layer
    return [
        ("roi_align", lambda: grads(lambda a, bb: V.roi_align(
            a, bb, np.asarray([2, 3]), (3, 2), 0.9), x, b)),
        ("roi_pool", lambda: np_all(V.roi_pool(
            pt.to_tensor(x), pt.to_tensor(b), [2, 3], (2, 3), 0.8))),
        ("psroi_pool", lambda: np_all(V.psroi_pool(
            pt.to_tensor(x), pt.to_tensor(b), [2, 3], 2, 0.7))),
        ("nms", lambda: np_all(V.nms(pt.to_tensor(boxes(rng(3), 30, 40)),
                                     0.3, rng(3).rand(30), top_k=8))),
        ("nms_categories", lambda: np_all(V.nms(
            pt.to_tensor(boxes(rng(3), 30, 40)), 0.3, rng(4).rand(30),
            category_idxs=rng(4).randint(0, 3, 30), categories=[0, 1, 2]))),
        ("matrix_nms", lambda: np_all(V.matrix_nms(
            pt.to_tensor(np.stack([boxes(rng(6), 12, 1.0, 0.05)] * 2)),
            pt.to_tensor(rng(6).rand(2, 3, 12).astype(np.float32)),
            0.1, 0.05, 8, 6, return_index=True))),
        ("distribute_fpn_proposals", lambda: np_all(
            V.distribute_fpn_proposals(pt.to_tensor(boxes(rng(7), 8, 600)),
                                       2, 5, 4, 224)[0])),
        ("generate_proposals", lambda: np_all(V.generate_proposals(
            pt.to_tensor(sc), pt.to_tensor(deltas), pt.to_tensor(
                np.asarray([[64, 64], [48, 56]], np.float32)),
            pt.to_tensor(anc), pt.to_tensor(np.full((60, 4), 0.5,
                                                    np.float32)),
            pre_nms_top_n=40, return_rois_num=True))),
        ("prior_box", lambda: np_all(V.prior_box(
            pt.to_tensor(np.zeros((1, 4, 3, 5), np.float32)),
            pt.to_tensor(np.zeros((1, 3, 30, 50), np.float32)), [4.0, 8.0],
            [9.0, 16.0], [1.0, 2.0], flip=True, clip=True))),
        ("box_coder", lambda: grads(lambda p, t: V.box_coder(
            p, [0.1, 0.1, 0.2, 0.2], t), prior, target)),
        ("yolo_box", lambda: np_all(V.yolo_box(
            pt.to_tensor(head[:, :16]), pt.to_tensor(
                np.asarray([[64, 96], [80, 80]], np.int32)),
            [10, 13, 16, 30], 3, downsample_ratio=16))),
        ("yolo_loss", lambda: grads(lambda h: V.yolo_loss(
            h, gt, np.asarray([[1, 2], [3, 0]]), anchors, [0, 1, 2], 4, 0.7,
            8), head)),
        ("deform_conv2d", lambda: grads(lambda a, o, ww, m: V.deform_conv2d(
            a, o, ww, padding=1, mask=m), xd, off, w, mask)),
        ("DeformConv2D", lambda: np_all(deform_layer()(
            pt.to_tensor(xd), pt.to_tensor(off)))),
    ]


def hapi_vision_tables(pt, smi, cuda="gpu"):
    """Phase 23 (f): the vision ops, the conv and pool Layer cases of the
    CPU tests' Layer table, and each zoo family's eval forward at a small
    input, on CUDA against the port on the CPU."""
    import numpy as np
    failures, n, worst = [], 0, 0.0

    def check(name, got, want):
        nonlocal worst
        if len(got) != len(want):
            raise AssertionError(f"{len(got)} results, want {len(want)}")
        for g, w in zip(got, want):
            g, w = np.asarray(g), np.asarray(w)
            if g.shape != w.shape:
                raise AssertionError(f"shape {g.shape} vs {w.shape}")
            if w.dtype.kind in "iub":
                if not np.array_equal(g, w):
                    raise AssertionError("integer results differ")
                continue
            err = _rel(g, w) if w.size else 0.0
            worst = max(worst, err)
            if not err <= HAPI_VISION_RTOL:
                raise AssertionError(f"relative error {err}")

    for name, fn in _vision_op_cases(pt):
        n += 1
        try:
            check(name, _on(pt, cuda, fn), _on(pt, "cpu", fn))
        except Exception as e:          # noqa: BLE001 - every case reported
            failures.append(f"{name}: {type(e).__name__}: "
                            f"{' '.join(str(e).split())[:300]}")
    n_ops = n
    ly = _test_module("test_torch_nn_layers")
    conv_pool = [c for c in ly.LAYER_TABLE
                 if "Conv" in c.id or "Pool" in c.id]
    for case in conv_pool:
        n += 1
        try:
            arrays = case.inputs()
            state = _on(pt, "cpu", lambda: {
                k: v.numpy() for k, v in case.ctor(pt).state_dict().items()})

            def run(state=state):
                layer = case.ctor(pt)
                layer.set_state_dict(state)
                return ly._run(pt, case, arrays, layer)
            ly.compare_layer_runs(_on(pt, cuda, run), _on(pt, "cpu", run),
                                  case, arrays)
        except Exception as e:          # noqa: BLE001
            failures.append(f"{case.id}: {type(e).__name__}: "
                            f"{' '.join(str(e).split())[:300]}")
    n_layers = n - n_ops
    zoo = _test_module("test_torch_vision_zoo")
    vis = _test_module("test_torch_vision")
    for name, size in zoo.FORWARDS + [("ppyoloe_crn_tiny", 64)]:
        n += 1
        try:
            kw = {} if name == "LeNet" else dict(
                num_classes=4 if name.startswith("ppyoloe") else 10)
            ch = 1 if name == "LeNet" else 3
            x = np.random.RandomState(0).rand(2, ch, size, size).astype(
                np.float32)
            state = _on(pt, "cpu", lambda: vis.randomize(
                getattr(pt.vision.models, name)(**kw)))

            def fwd(name=name, kw=kw, state=state, x=x):
                net = getattr(pt.vision.models, name)(**kw)
                net.set_state_dict(state)
                net.eval()
                with pt.no_grad():
                    out = net(pt.to_tensor(x))
                return [o.numpy() for o in (out if isinstance(
                    out, (tuple, list)) else [out])]
            check(name, _on(pt, cuda, fwd), _on(pt, "cpu", fwd))
        except Exception as e:          # noqa: BLE001
            failures.append(f"{name}: {type(e).__name__}: "
                            f"{' '.join(str(e).split())[:300]}")
    log(f"hapi vision tables on CUDA against the CPU: {n - len(failures)} "
        f"of {n} agree ({n_ops} ops with their gradients, {n_layers} conv "
        f"and pool Layer cases, {n - n_ops - n_layers} zoo forwards); "
        f"worst relative error {worst:.3e} (tol {HAPI_VISION_RTOL}) [{smi}]")
    for f in failures:
        log(f"  vision table FAILED {f}")
    if failures:
        raise AssertionError(f"phase 23 (f): {len(failures)} of {n} cases "
                             "disagree between CUDA and the CPU")
    return {"cases": n, "ops": n_ops, "layers": n_layers,
            "zoo": n - n_ops - n_layers, "worst_rel_err": worst,
            "card": smi}


def hapi_phase(smi):
    """Phase 23: io, metric, hapi and vision on the card (module
    docstring)."""
    import gc
    import torch
    import paddle_tpu_torch as pt
    t0 = time.perf_counter()
    out_dir = os.path.join(ROOT, "build", "phase23")
    pt.set_device("gpu")
    out, times = {}, {}
    try:
        for key, fn in (("resnet_fit", lambda: hapi_resnet_fit(
                            pt, smi, os.path.join(out_dir, "prof"))),
                        ("learns", lambda: hapi_learns(pt, smi, out_dir)),
                        ("parity", lambda: hapi_parity(pt, smi)),
                        ("kernel_route", lambda: hapi_kernel_route(pt, smi)),
                        ("engines", lambda: hapi_engines(pt, smi)),
                        ("vision", lambda: hapi_vision_tables(pt, smi))):
            t = time.perf_counter()
            out[key] = fn()
            times[key] = time.perf_counter() - t
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    out["part_seconds"] = times
    out["seconds"] = time.perf_counter() - t0
    log(f"phase 23 took {out['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in times.items())
        + f") [{smi}]")
    # the record holds Python numbers only (the report is dumped as JSON)
    return json.loads(json.dumps(out, default=float))


# ---------------------------------------------------------------------------
# Phase 24: the head dims and float16 the kernels took in PR 19 (ROADMAP
# B.4), then text and audio (ROADMAP A.13d)
# ---------------------------------------------------------------------------

TEXT_PAGED_DIMS = ((32, 8), (128, 16))  # (head dim, heads): gpt_tiny's
                                        # head dim, gpt_1p3b's
TEXT_FLASH_SHAPE = dict(B=2, H=8, Hk=8, S=1024)
TEXT_FLASH_CASES = [
    # name, head dim, dtype, causal, mask, dropout rate, timed
    ("t_f16_D64", 64, "f16", True, False, 0.0, True),
    ("t_f16_D128", 128, "f16", True, False, 0.0, True),
    ("t_f32_D256", 256, "f32", True, False, 0.0, True),
    ("t_bf16_D256", 256, "bf16", True, False, 0.0, True),
    ("t_f16_D256", 256, "f16", True, False, 0.0, True),
    # the mask and dropout builds of the new instances, and GQA
    ("t_f16_D64_mask", 64, "f16", False, True, 0.0, False),
    ("t_f16_D128_dropout", 128, "f16", True, False, 0.1, False),
    ("t_bf16_D256_mask", 256, "bf16", False, True, 0.0, False),
    ("t_f16_D256_dropout", 256, "f16", True, False, 0.1, False),
]


def text_paged_cases():
    """Phase 24 (c)'s paged cases at head dims 32 and 128: decode over
    ragged positions up to 1000 and at the split edges of the split each
    geometry takes, verify windows (T=5) and prefill tiles (T=128, 512),
    in every mode."""
    from paddle_tpu_torch.ops import paged_attention as pa
    ragged = [0, 15, 16, 17, 255, 511, 777, 1000]
    verify5 = [0, 12, 14, 255, 500, 777, 1000, 1019]
    out = []
    for D, H in TEXT_PAGED_DIMS:
        sp = pa.decode_split_keys(H, 1024, D, 16)
        edges = [sp - 2, sp - 1, sp, 2 * sp - 2, 2 * sp - 1, 2 * sp, 1023,
                 -1]
        for kind in ("f32", "bf16", "int8"):
            hd = dict(H=H, D=D)
            out += [
                (f"d{D}_decode_{kind}", dict(S=8, T=1, pos=ragged, **hd),
                 kind),
                (f"d{D}_decode_edges_{kind}", dict(S=8, T=1, pos=edges, **hd),
                 kind),
                (f"d{D}_verify_{kind}_T5", dict(S=8, T=5, pos=verify5, **hd),
                 kind),
                (f"d{D}_prefill_{kind}_T128",
                 dict(S=2, T=128, pos=[0, 256], **hd), kind),
                (f"d{D}_prefill_{kind}_T512",
                 dict(S=2, T=512, pos=[0, 256], **hd), kind)]
    return out


def text_kernel_builds(pt, smi):
    """Phase 24 (c): every new kernel instance against its plain version
    on the card (each launched twice and required to repeat bit for bit),
    timed beside its bound and SDPA; the float16 flash cases also hold a
    control that rounds P and dS to bf16 to their limit, which it must
    fail."""
    import torch
    flush_buf = torch.empty(64 * 1024 * 1024, device="cuda")

    def flush():
        _flush_l2(flush_buf)
    paged = run_kernel_cases(flush, text_paged_cases(), seed=2400)
    flash, timing = [], {}
    for i, (name, D, kind, causal, mask, rate, timed) in \
            enumerate(TEXT_FLASH_CASES):
        shp = dict(TEXT_FLASH_SHAPE, D=D)
        rec, t = flash_case_check(i, name, shp, kind, causal, mask, rate,
                                  flush, timed=timed, seed=2450)
        flash.append(rec)
        if t is not None:
            timing[name] = t
    del flush_buf
    return {"paged": paged, "flash": flash, "flash_timing": timing}


TEXT_BERT_B, TEXT_BERT_S = 32, 128     # (a): BERT's first pretraining phase
TEXT_BERT_WARMUP, TEXT_BERT_TIMED = 3, 20
TEXT_ERNIE_WARMUP, TEXT_ERNIE_STEPS = 3, 10    # (f)
TEXT_BERT_STEPS = 63                   # 60 after the warm-up: the loss's run
TEXT_BERT_RANGE = 512                  # the ids a sequence's run may hold
# the last 5 steps' mean loss over the first 5's; call 2 (the first to
# run (a)) read 0.631
TEXT_BERT_LOSS_SHARE = 0.8
TEXT_BERT_MASK_ID = 103                # [MASK] in BERT's vocabulary
TEXT_GPT_ENGINE = dict(slots=8, max_len=1024, block_size=16)
TEXT_RNN = dict(B=64, T=128, I=256, H=512)
TEXT_RNN_RTOL = 1e-4                   # (d): of the CPU's largest magnitude
TEXT_AUDIO = dict(clips=16, seconds=5, sr=44100, n_fft=2048, hop=512,
                  n_mels=128, n_mfcc=40)
TEXT_AUDIO_RTOL = 1e-5                 # (e): of the CPU's largest magnitude
TEXT_ISTFT_ATOL = 1e-4                 # (e): the stft -> istft round trip


def _bert_dataset(pt, n):
    """Masked-LM pretraining data that can be learnt: each sequence is two
    runs of consecutive ids (within TEXT_BERT_RANGE of 1000); the second
    continues the first (NSP label 1) or starts afresh (0); 15% of the
    positions are masked ([MASK]) and carry their id as the MLM label, the
    rest -1. The labels ride as one [S + 1] row: MLM labels, then NSP."""
    import numpy as np
    S, half = TEXT_BERT_S, TEXT_BERT_S // 2

    class MaskedLM(pt.io.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            rng = np.random.RandomState(2400 + i)
            a = rng.randint(0, TEXT_BERT_RANGE)
            nsp = int(rng.rand() < 0.5)
            b = a + half if nsp else rng.randint(0, TEXT_BERT_RANGE)
            ids = 1000 + np.concatenate(
                [(a + np.arange(half)) % TEXT_BERT_RANGE,
                 (b + np.arange(half)) % TEXT_BERT_RANGE]).astype(np.int64)
            tt = np.repeat(np.arange(2, dtype=np.int64), half)
            masked = rng.rand(S) < 0.15
            labels = np.where(masked, ids, -1).astype(np.int64)
            ids = np.where(masked, TEXT_BERT_MASK_ID, ids)
            return ids, tt, np.append(labels, nsp)
    return MaskedLM()


def _pretrain_loss(pt, vocab):
    """The callable Model._compute_loss takes over (mlm_logits,
    nsp_logits, labels): BertForPretraining.loss's MLM (ignore_index=-1)
    plus NSP cross entropy."""
    F = pt.nn.functional

    def loss(mlm_logits, nsp_logits, labels):
        mlm = F.cross_entropy(mlm_logits.reshape([-1, vocab]),
                              labels[:, :-1].reshape([-1]), ignore_index=-1)
        return mlm + F.cross_entropy(nsp_logits, labels[:, -1])
    return loss


class _FlashSteps:
    """A Model callback: flash launches (fwd, dq, dkv) each train step."""

    @staticmethod
    def make(pt):
        class L(pt.callbacks.Callback):
            def __init__(self):
                super().__init__()
                self.moved = []

            def on_train_batch_begin(self, step, logs=None):
                self._before = _flash_counts()

            def on_train_batch_end(self, step, logs=None):
                self.moved.append(tuple(a - b for a, b in
                                        zip(_flash_counts(), self._before)))
        return L()


def text_bert_fit(pt, smi):
    """Phase 24 (a): BERT-base pretraining (MLM + NSP) through Model.fit,
    fed by two ring workers: step ms, sequences/s, the device profile of a
    step, flash launches a step, SDPA routes, the loader's wait, peak
    memory, and the loss falling over 60 steps."""
    import numpy as np
    import torch
    from paddle_tpu_torch import io as tio
    from paddle_tpu_torch.nn.functional import attention as ta
    from paddle_tpu_torch.observability import deviceprof
    from paddle_tpu_torch.text.models import BertConfig, BertForPretraining
    out_dir = os.path.join(ROOT, "build", "phase24")
    pt.seed(24)
    cfg = BertConfig()
    net = BertForPretraining(cfg)
    model = pt.Model(net)
    model.prepare(pt.optimizer.AdamW(1e-4, parameters=net.parameters(),
                                     weight_decay=0.01),
                  _pretrain_loss(pt, cfg.vocab_size))
    ds = _bert_dataset(pt, TEXT_BERT_B * TEXT_BERT_STEPS)
    loader = _TimedLoader(tio.DataLoader(ds, batch_size=TEXT_BERT_B,
                                         shuffle=False, num_workers=2,
                                         drop_last=True))
    timer, flash = _StepTimer.make(pt), _FlashSteps.make(pt)
    for k in ta.sdpa_routes:
        ta.sdpa_routes[k] = 0
    tio.reset_engine_stats()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.fit(loader, epochs=1, verbose=0, callbacks=[timer, flash])
    fit_s = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    routes, stats = dict(ta.sdpa_routes), tio.engine_stats()
    timed = timer.ms[TEXT_BERT_WARMUP:TEXT_BERT_WARMUP + TEXT_BERT_TIMED]
    quart = quartiles(timed)
    losses = timer.losses[TEXT_BERT_WARMUP:]
    share = float(np.mean(losses[-5:]) / np.mean(losses[:5]))
    L = cfg.num_hidden_layers
    rec = {"B": TEXT_BERT_B, "S": TEXT_BERT_S, "steps": TEXT_BERT_STEPS,
           "step_ms_quartiles": quart, "step_ms_median": quart[1],
           "sequences_per_s": TEXT_BERT_B / (quart[1] / 1e3),
           "flash_launches_per_step": sorted(set(flash.moved)),
           "sdpa_routes": routes, "engine": stats,
           "wait_ms_quartiles": quartiles(loader.waits[TEXT_BERT_WARMUP:]),
           "first_wait_ms": loader.waits[0], "peak_gb": peak_gb,
           "losses": timer.losses, "loss_share": share,
           "loss_share_limit": TEXT_BERT_LOSS_SHARE, "fit_s": fit_s,
           "card": smi}
    # one fixed batch: the device profile of a step
    ids, tt, lab = next(iter(tio.DataLoader(ds, batch_size=TEXT_BERT_B)))
    try:
        _, prof = deviceprof.capture(
            lambda: model.train_batch([ids, tt], [lab]), out_dir, iters=3,
            label="bert_base")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    busy = prof["total_device_ms"] / 3
    rec.update({"kernels_per_step": prof["n_events"] / 3,
                "device_busy_ms_per_step": busy,
                "idle_share": 1.0 - busy / quart[1]})
    log(f"text bert-base Model.fit (B={TEXT_BERT_B}, S={TEXT_BERT_S}, MLM + "
        f"NSP, AdamW, f32, TF32 off, 2 ring workers): step ms p25/p50/p75 "
        + "/".join(f"{v:.3f}" for v in quart)
        + f" ({TEXT_BERT_TIMED} after {TEXT_BERT_WARMUP}), "
        f"{rec['sequences_per_s']:.1f} sequences/s; "
        f"{rec['kernels_per_step']:.0f} kernels, busy {busy:.3f} ms a step "
        f"(idle {rec['idle_share']:.3f}); flash fwd/dq/dkv a step "
        f"{rec['flash_launches_per_step']}; SDPA routes {routes}; the wait "
        f"a step p25/p50/p75 "
        + "/".join(f"{v:.3f}" for v in rec["wait_ms_quartiles"])
        + f" ms; peak {peak_gb:.2f} GB; loss {timer.losses[0]:.4f} -> "
        f"{timer.losses[-1]:.4f} (last 5 / first 5 of 60: {share:.3f}, "
        f"limit {TEXT_BERT_LOSS_SHARE}) [{smi}]")
    if set(flash.moved) != {(L, L, L)}:
        raise AssertionError(f"phase 24 (a): flash launches a step "
                             f"{sorted(set(flash.moved))}, want {L} each")
    if routes["plain"] or routes["kernel"] != L * TEXT_BERT_STEPS:
        raise AssertionError(f"phase 24 (a): SDPA routes {routes}")
    if stats["ring"] != TEXT_BERT_STEPS:
        raise AssertionError(f"phase 24 (a): the ring engine handed over "
                             f"{stats}")
    if not np.all(np.isfinite(timer.losses)) or \
            not share < TEXT_BERT_LOSS_SHARE:
        raise AssertionError(f"phase 24 (a): the loss did not fall: last "
                             f"5 / first 5 {share}")
    return rec


def text_gpt_serving(pt, smi):
    """Phase 24 (b): GPT-1.3B at full width through the paged kernel at
    head dim 128 under the Scheduler on CUDA graphs, phase 4's requests;
    the greedy streams token-exact against the same engine on the plain
    (gather) attention, with f32 pools and with int8 pools."""
    import gc
    import torch
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import PagedGenerationEngine
    from paddle_tpu_torch.text.models import gpt_1p3b
    model = gpt_1p3b(device="cuda", seed=0)
    cfg = model.cfg
    L = cfg.num_layers
    lengths = [1, 5, 17, 64, 100, 200, 255, 512,
               257, 290, 300, 333, 400, 480, 600, 700]
    prompts = make_prompts(0, lengths, shared_from=8, vocab=cfg.vocab_size)
    out = {"model": "gpt_1p3b", "head_dim": cfg.hidden_size // cfg.num_heads,
           "card": smi}
    for kv in ("f32", "int8"):
        kw = {} if kv == "f32" else {"kv_dtype": "int8"}
        eng = PagedGenerationEngine(model, attention_impl="kernel",
                                    device="cuda", **TEXT_GPT_ENGINE, **kw)
        cap_s = precompile(eng, f"phase 24 (b) {kv}")
        pa.set_launch_counts((0, 0, 0))
        handles, m, wall = serve(eng, prompts, max_new=32)
        counts = check_captures(eng, f"phase 24 (b) {kv}")
        launches, window, prefill = pa.launch_counts()
        prefills = len(prompts) + m["requests"]["serving.preempted"]
        if launches != L * (m["decode_steps"] + prefills) or \
                prefill != L * prefills or window:
            raise AssertionError(
                f"phase 24 (b) {kv}: {launches} paged launches ({prefill} "
                f"tiles, {window} windows), want {L} a forward over "
                f"{m['decode_steps']} decode steps + {prefills} prefills")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        plain = PagedGenerationEngine(model, attention_impl="gather",
                                      device="cuda", **TEXT_GPT_ENGINE, **kw)
        want, _, _ = serve(plain, prompts, max_new=32)
        del plain
        for i, (h, w) in enumerate(zip(handles, want)):
            if h.tokens != w.tokens:
                t = next(j for j, (a, b) in enumerate(zip(h.tokens, w.tokens))
                         if a != b)
                gap = next_token_gap(model, list(prompts[i])
                                     + list(w.tokens[:t]))
                raise AssertionError(
                    f"phase 24 (b) {kv}: request {i} token {t}: kernel "
                    f"{h.tokens[t]} != plain {w.tokens[t]} (top-2 gap "
                    f"{gap:.3e})")
        ttfts = [h.ttft_s for h in handles]
        rec = {"decode_step_ms": m["decode_step_ms"],
               "decode_steps": m["decode_steps"], "prefills": prefills,
               "decode_only_tok_s": decode_only_tok_s(m),
               "decode_tokens_per_s": m["decode_tokens_per_s"],
               "ttft_s_mean": sum(ttfts) / len(ttfts),
               "ttft_s_max": max(ttfts), "launches": launches,
               "launches_decode": launches - prefill,
               "launches_prefill": prefill, "capture_s": cap_s,
               "capture_counts": counts, "wall_s": wall,
               "streams_equal_plain": len(handles)}
        gc.collect()
        torch.cuda.empty_cache()
        prof = profile_decode(model, prompts[8:16], **kw)
        rec.update({k: prof[k] for k in (
            "device_busy_ms_per_step", "kernels_per_step",
            "paged_ms_per_step", "paged_launches_per_step",
            "step_ms_untraced", "device_idle_share_untraced")})
        out[kv] = rec
        log(f"text serve gpt_1p3b (D={out['head_dim']}) {kv} KV: decode step "
            f"{rec['decode_step_ms']:.3f} ms, {rec['decode_only_tok_s']:.1f} "
            f"decode tokens/s, TTFT mean {rec['ttft_s_mean']:.4f} s max "
            f"{rec['ttft_s_max']:.4f} s; paged launches {launches} "
            f"({rec['launches_decode']} decode, {prefill} tile) = {L} a "
            f"forward x ({m['decode_steps']} decode + {prefills} prefill); "
            f"profiled decode step {rec['step_ms_untraced']:.3f} ms, busy "
            f"{rec['device_busy_ms_per_step']:.3f} ms over "
            f"{rec['kernels_per_step']:.0f} kernels, paged "
            f"{rec['paged_ms_per_step']:.4f} ms x "
            f"{rec['paged_launches_per_step']:.0f}; captured in {cap_s:.1f} "
            f"s; 16 streams token-exact against the plain attention [{smi}]")
    del model
    return out


def _rnn_step(pt, net, opt, x, seq):
    """One training step of a sequence model: forward, a loss over the
    outputs and the final states, backward, the update."""
    out, st = net(x, sequence_length=seq)
    h = st[0] if isinstance(st, tuple) else st
    loss = out.square().mean() + h.square().mean()
    loss.backward()
    grads = {n: p.grad._data.detach().clone()
             for n, p in net.named_parameters()}
    opt.step()
    opt.clear_grad()
    return out, h, loss, grads


def text_rnns(pt, smi):
    """Phase 24 (d): a 2-layer bidirectional LSTM and a GRU (hidden 512,
    B=64, T=128, ragged sequence_length): a training step's ms and kernels
    on the card. The first of those steps (profile_steps' warm-up, from the
    initial weights) is held to one step on the CPU from the same weights
    and inputs, every row: outputs, final states, loss and gradients within
    TEXT_RNN_RTOL of the CPU's largest magnitude."""
    import numpy as np
    c = TEXT_RNN
    rng = np.random.RandomState(24)
    x_np = rng.randn(c["B"], c["T"], c["I"]).astype(np.float32)
    seq_np = rng.randint(1, c["T"] + 1, c["B"]).astype(np.int64)
    seq_np[:2] = (c["T"], 1)
    out = {}
    for name, make in (
            ("lstm_2layer_bidirect", lambda: pt.nn.LSTM(
                c["I"], c["H"], num_layers=2, direction="bidirect")),
            ("gru", lambda: pt.nn.GRU(c["I"], c["H"]))):
        pt.set_device("gpu")
        pt.seed(24)
        net = make()
        state = {k: v.numpy() for k, v in net.state_dict().items()}
        opt = pt.optimizer.Adam(1e-3, parameters=net.parameters())
        x, seq = pt.to_tensor(x_np, stop_gradient=False), pt.to_tensor(seq_np)
        first = []

        def step():
            res = _rnn_step(pt, net, opt, x, seq)
            res[2].item()
            if not first:
                first.append(res)
        t0 = time.perf_counter()
        # one traced step: the LSTM's ~32,000 kernels a step make the
        # trace's parse the phase's largest cost
        prof = profile_steps(step, 1)
        prof_s = time.perf_counter() - t0
        pt.set_device("cpu")
        net_c = make()
        net_c.set_state_dict(state)
        cpu = _rnn_step(
            pt, net_c, pt.optimizer.Adam(1e-3, parameters=net_c.parameters()),
            pt.to_tensor(x_np, stop_gradient=False), pt.to_tensor(seq_np))
        pt.set_device("gpu")
        card = first[0]
        errs = {}
        for i, part in enumerate(("output", "state", "loss")):
            a = card[i]._data.detach().cpu().double()
            b = cpu[i]._data.detach().double()
            errs[part] = float((a - b).abs().max() / b.abs().max())
        errs["grads"] = max(
            float((card[3][n].cpu().double() - g.double()).abs().max()
                  / g.double().abs().max())
            for n, g in cpu[3].items())
        rec = {"step_ms": prof["step_ms_untraced"],
               "kernels_per_step": prof["kernels_per_step"],
               "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
               "idle_share": prof["device_idle_share_untraced"],
               "rel_err": errs, "tol": TEXT_RNN_RTOL,
               "compared_rows": c["B"], "profile_s": prof_s,
               "compare_s": time.perf_counter() - t0 - prof_s}
        out[name] = rec
        log(f"text rnn {name} (hidden {c['H']}, B={c['B']}, T={c['T']}, "
            f"ragged lengths, Adam): training step {rec['step_ms']:.2f} ms, "
            f"{rec['kernels_per_step']:.0f} kernels, busy "
            f"{rec['device_busy_ms_per_step']:.2f} ms (idle "
            f"{rec['idle_share']:.3f}); its first step against the CPU, all "
            f"{c['B']} rows (of the CPU's largest magnitude) "
            + " ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f" (tol {TEXT_RNN_RTOL}); profiled in {prof_s:.1f} s, CPU "
            f"step and comparison {rec['compare_s']:.1f} s [{smi}]")
        if not all(v <= TEXT_RNN_RTOL for v in errs.values()):
            raise AssertionError(f"phase 24 (d) {name}: card and CPU differ "
                                 f"{errs}")
    return out


def _timed_ms(fn, n=5):
    """Host ms of fn() ending in a synchronize, the median of n after one
    warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    ms = []
    for _ in range(n):
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) * 1e3)
    return quartiles(ms)[1]


def text_decoders_audio(pt, smi):
    """Phase 24 (e): Viterbi and beam search on the card against the CPU
    (paths and tokens equal), the audio features over ESC-50's shape
    against the CPU, and the stft -> istft round trip."""
    import numpy as np
    rng = np.random.RandomState(24)
    out = {}
    # Viterbi: B=64, T=128, 50 tags, ragged lengths
    pot = rng.randn(64, 128, 50).astype(np.float32)
    trans = rng.randn(50, 50).astype(np.float32)
    lens = rng.randint(1, 129, 64).astype(np.int64)
    res = {}
    for dev in ("gpu", "cpu"):
        pt.set_device(dev)
        args = [pt.to_tensor(a) for a in (pot, trans, lens)]
        res[dev] = pt.text.viterbi_decode(*args)
        if dev == "gpu":
            vit_ms = _timed_ms(lambda: pt.text.viterbi_decode(*args)[1]
                               .numpy())
    pt.set_device("gpu")
    if not np.array_equal(res["gpu"][1].numpy(), res["cpu"][1].numpy()):
        raise AssertionError("phase 24 (e): Viterbi paths differ from the "
                             "CPU's")
    score_err = float(np.abs(res["gpu"][0].numpy()
                             - res["cpu"][0].numpy()).max())
    out["viterbi"] = {"ms": vit_ms, "score_max_abs_err": score_err}
    # beam search (beam 4) over a GRUCell
    V, Hd, B = 1000, 256, 16
    ids = {}
    for dev in ("gpu", "cpu"):
        pt.set_device(dev)
        pt.seed(24)
        cell = pt.nn.GRUCell(Hd, Hd)
        emb = pt.nn.Embedding(V, Hd)
        proj = pt.nn.Linear(Hd, V)
        layers = {"cell": cell, "emb": emb, "proj": proj}
        if dev == "gpu":
            state = {n: {k: v.numpy() for k, v in layer.state_dict().items()}
                     for n, layer in layers.items()}
            # wide logits: the ranked candidates lie far apart
            state["proj"]["weight"] = rng.randn(Hd, V).astype(np.float32) \
                * 0.5
            h0 = rng.rand(B, Hd).astype(np.float32)
        for n, layer in layers.items():
            layer.set_state_dict(state[n])
        dec = pt.nn.BeamSearchDecoder(cell, 0, V - 1, beam_size=4,
                                      embedding_fn=emb, output_fn=proj)

        def run():
            return pt.nn.dynamic_decode(dec, inits=pt.to_tensor(h0),
                                        max_step_num=32)
        ids[dev] = run()
        if dev == "gpu":
            beam_ms = _timed_ms(lambda: run()[0].numpy(), n=3)
    pt.set_device("gpu")
    if not np.array_equal(ids["gpu"][0].numpy(), ids["cpu"][0].numpy()):
        raise AssertionError("phase 24 (e): beam search tokens differ from "
                             "the CPU's")
    out["beam_search"] = {"ms": beam_ms, "steps": int(ids["gpu"][0].shape[-1]),
                          "score_max_abs_err": float(np.abs(
                              ids["gpu"][1].numpy()
                              - ids["cpu"][1].numpy()).max())}
    # audio at ESC-50's shape: 16 clips of 5 s at 44.1 kHz
    a = TEXT_AUDIO
    n = a["sr"] * a["seconds"]
    t = np.arange(n) / a["sr"]
    clips = (np.sin(2 * np.pi * rng.uniform(100, 4000, (a["clips"], 1)) * t)
             + 0.1 * rng.randn(a["clips"], n)).astype(np.float32)
    feats = {}
    for dev in ("gpu", "cpu"):
        pt.set_device(dev)
        x = pt.to_tensor(clips)
        mel = pt.audio.MelSpectrogram(sr=a["sr"], n_fft=a["n_fft"],
                                      hop_length=a["hop"],
                                      n_mels=a["n_mels"])
        mfcc = pt.audio.MFCC(sr=a["sr"], n_mfcc=a["n_mfcc"],
                             n_fft=a["n_fft"], hop_length=a["hop"],
                             n_mels=a["n_mels"])
        win = pt.audio.functional.get_window("hann", a["n_fft"])
        spec = pt.signal.stft(x, a["n_fft"], a["hop"], window=win)
        back = pt.signal.istft(spec, a["n_fft"], a["hop"], window=win,
                               length=n)
        feats[dev] = {"mel": mel(x).numpy(), "mfcc": mfcc(x).numpy(),
                      "roundtrip": float(np.abs(back.numpy() - clips).max())}
        if dev == "gpu":
            ms = {"mel": _timed_ms(lambda: mel(x).numpy()),
                  "mfcc": _timed_ms(lambda: mfcc(x).numpy()),
                  "stft_istft": _timed_ms(lambda: pt.signal.istft(
                      pt.signal.stft(x, a["n_fft"], a["hop"], window=win),
                      a["n_fft"], a["hop"], window=win, length=n).numpy())}
    pt.set_device("gpu")
    errs = {k: float(np.abs(feats["gpu"][k] - feats["cpu"][k]).max()
                     / np.abs(feats["cpu"][k]).max()) for k in ("mel", "mfcc")}
    out["audio"] = {"ms": ms, "rel_err": errs, "tol": TEXT_AUDIO_RTOL,
                    "roundtrip_max_abs_err": feats["gpu"]["roundtrip"],
                    "roundtrip_tol": TEXT_ISTFT_ATOL,
                    "mel_shape": list(feats["gpu"]["mel"].shape)}
    log(f"text viterbi (B=64, T=128, 50 tags, ragged): {vit_ms:.2f} ms, paths "
        f"equal the CPU's (scores {score_err:.2e}); beam search (beam 4, "
        f"GRUCell 256, vocab {V}, B={B}, {out['beam_search']['steps']} "
        f"steps): {beam_ms:.2f} ms, tokens equal the CPU's; audio over "
        f"{a['clips']} x {a['seconds']} s at {a['sr']} Hz: MelSpectrogram "
        f"{ms['mel']:.3f} ms, MFCC {ms['mfcc']:.3f} ms, stft -> istft "
        f"{ms['stft_istft']:.3f} ms; against the CPU mel {errs['mel']:.2e} "
        f"mfcc {errs['mfcc']:.2e} (tol {TEXT_AUDIO_RTOL}); round trip "
        f"{feats['gpu']['roundtrip']:.2e} (tol {TEXT_ISTFT_ATOL}) [{smi}]")
    if not all(v <= TEXT_AUDIO_RTOL for v in errs.values()) or \
            not feats["gpu"]["roundtrip"] <= TEXT_ISTFT_ATOL:
        raise AssertionError(f"phase 24 (e): audio {out['audio']}")
    return out


def text_ernie(pt, smi):
    """Phase 24 (f): ERNIE 3.0 base sequence classification, train steps
    through Model at B=32, S=128: step ms and flash launches a step."""
    import numpy as np
    from paddle_tpu_torch.text.models import (ErnieForSequenceClassification,
                                              ernie_3_base_config)
    pt.seed(24)
    cfg = ernie_3_base_config()
    net = ErnieForSequenceClassification(cfg, num_classes=2)
    model = pt.Model(net)
    model.prepare(pt.optimizer.AdamW(1e-4, parameters=net.parameters()),
                  pt.nn.CrossEntropyLoss())
    rng = np.random.RandomState(24)
    ids = pt.to_tensor(rng.randint(0, cfg.vocab_size, (32, 128)))
    labels = pt.to_tensor(rng.randint(0, 2, (32,)))
    ms, moved, losses = [], [], []
    for i in range(TEXT_ERNIE_WARMUP + TEXT_ERNIE_STEPS):
        before = _flash_counts()
        t = time.perf_counter()
        losses.append(float(model.train_batch([ids], [labels])[0][0]))
        ms.append((time.perf_counter() - t) * 1e3)
        moved.append(tuple(a - b for a, b in zip(_flash_counts(), before)))
    L = cfg.num_hidden_layers
    quart = quartiles(ms[TEXT_ERNIE_WARMUP:])
    rec = {"step_ms_quartiles": quart, "flash_launches_per_step":
           sorted(set(moved)), "losses": losses, "card": smi}
    log(f"text ernie-3.0-base sequence classification (B=32, S=128, "
        f"AdamW, f32): step ms p25/p50/p75 "
        + "/".join(f"{v:.3f}" for v in quart)
        + f", flash fwd/dq/dkv a step {sorted(set(moved))}, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f} [{smi}]")
    if set(moved) != {(L, L, L)} or not np.all(np.isfinite(losses)):
        raise AssertionError(f"phase 24 (f): flash launches {moved}, "
                             f"losses {losses}")
    return rec


def text_phase(smi, sdpa_builds):
    """Phase 24 (module docstring): parts run in the order c, a, b, d, e,
    f; each raises on failure. With `sdpa_builds` (phase 22 has not run)
    part (c) ends with phase 22's check of SDPA on the new builds."""
    import gc
    import torch
    import paddle_tpu_torch as pt
    t0 = time.perf_counter()
    pt.set_device("gpu")
    out, secs = {}, {}
    steps = (("c", text_kernel_builds), ("a", text_bert_fit),
             ("b", text_gpt_serving), ("d", text_rnns),
             ("e", text_decoders_audio), ("f", text_ernie))
    for key, fn in steps:
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        out[key] = fn(pt, smi)
        if key == "c" and sdpa_builds:
            out[key]["sdpa"] = nn_sdpa_new_builds(pt, smi)
        secs[key] = time.perf_counter() - t1
    out["seconds"] = time.perf_counter() - t0
    out["seconds_by_part"] = secs
    log(f"phase 24 took {out['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()) + f") [{smi}]")
    return out


JIT_B, JIT_S = 32, 128              # phase 25: BERT-base at its phase-1 shape
JIT_BATCHES = (1, 8, 32)            # (b): run() sizes from one artifact
JIT_TIMED = 20                      # (a): forwards timed, after a warm-up
JIT_CHILD_S = 600
JIT_CHILD = r"""
import json, sys, time
t0 = time.perf_counter()
sys.modules["jax"] = None           # the child must not reach JAX
sys.modules["paddle_tpu"] = None
import numpy as np
import torch
from paddle_tpu_torch import inference
from paddle_tpu_torch.ops import flash_attention as fa
prefix, inputs, out_path, batches = sys.argv[1], sys.argv[2], sys.argv[3], \
    [int(b) for b in sys.argv[4].split(",")]
t_import = time.perf_counter() - t0
t1 = time.perf_counter()
pred = inference.create_predictor(inference.Config(prefix + ".pdmodel",
                                                   prefix + ".pdiparams"))
load_s = time.perf_counter() - t1
z = np.load(inputs)
ins = [z["ids"], z["token_types"], z["mask"]]
rec, outs = {"import_s": t_import, "load_to_ready_s": load_s,
             "ready_stages": pred.ready_stages,
             "names": pred.get_input_names(), "runs": {}}, {}
for B in batches:
    args = [a[:B] for a in ins]
    fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
    got = pred.run(args)
    launches = [fa.launches_fwd, fa.launches_dq, fa.launches_dkv]
    ms = []
    for _ in range(10):
        t = time.perf_counter()
        pred.run(args)              # ends in the host copy of the outputs
        ms.append((time.perf_counter() - t) * 1e3)
    ms.sort()
    rec["runs"][B] = {"launches": launches, "ms_median": ms[len(ms) // 2],
                      "ms_all": ms}
    outs[f"seq{B}"], outs[f"pooled{B}"] = got
np.savez(out_path, **outs)
print("JIT_CHILD " + json.dumps(rec), flush=True)
"""


def jit_inputs(pt, cfg, B, S, seed=25):
    """Seeded ids and token types, and an additive key-padding mask whose
    every fourth row keeps its first S - 16 * (b % 4) keys."""
    import numpy as np
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, cfg.vocab_size, (B, S)).astype(np.int64)
    tt = rng.randint(0, 2, (B, S)).astype(np.int64)
    mask = np.zeros((B, 1, 1, S), np.float32)
    for b in range(B):
        if b % 4:
            mask[b, ..., S - 16 * (b % 4):] = -1e4
    return ids, tt, mask


def _bert_pair(pt):
    """The eager BERT-base and a second instance with its weights, which
    `to_static` takes over."""
    from paddle_tpu_torch.text.models import Bert, BertConfig
    pt.seed(25)
    cfg = BertConfig()
    net = Bert(cfg)
    net.eval()
    twin = Bert(cfg)
    twin.set_state_dict(net.state_dict())
    twin.eval()
    return cfg, net, twin


def _launched(fn):
    """fn() with the flash counters set to 0 just before it; returns
    (fn's value, (fwd, dq, dkv) launches)."""
    from paddle_tpu_torch.ops import flash_attention as fa
    fa.launches_fwd = fa.launches_dq = fa.launches_dkv = 0
    out = fn()
    return out, (fa.launches_fwd, fa.launches_dq, fa.launches_dkv)


def _max_err(a, b):
    import numpy as np
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def jit_to_static(pt, smi, net, twin, args):
    """Phase 25 (a): the to_static program against the eager forward."""
    import numpy as np
    st = pt.jit.to_static(twin)
    eager = lambda: [o.numpy() for o in net(*args)]          # noqa: E731
    static = lambda: [o.numpy() for o in st(*args)]          # noqa: E731
    t0 = time.perf_counter()
    static()                        # traces the program
    trace_s = time.perf_counter() - t0
    want, l_eager = _launched(eager)
    got, l_static = _launched(static)
    errs = [_max_err(g, w) for g, w in zip(got, want)]
    rec = {"trace_s": trace_s, "launches_eager": l_eager,
           "launches_static": l_static, "max_abs_err": errs}
    for name, fn in (("eager", eager), ("to_static", static)):
        ms = []
        for _ in range(JIT_TIMED):
            t = time.perf_counter()
            fn()
            ms.append((time.perf_counter() - t) * 1e3)
        prof = profile_steps(fn, 5)
        rec[name] = {"ms_quartiles": quartiles(ms),
                     "kernels_per_forward": prof["kernels_per_step"],
                     "device_busy_ms": prof["device_busy_ms_per_step"],
                     "device_idle_share": prof["device_idle_share"],
                     "traced_ms": prof["step_ms_traced"]}
    (prog,) = st.forward.concrete_programs.values()
    rec["graph_nodes"] = len(prog.graph.nodes)
    rec["flash_nodes"] = sum("flash_fwd" in str(n.target)
                             for n in prog.graph.nodes)
    log(f"jit (a) BERT-base B={JIT_B} S={JIT_S} f32 eval: to_static "
        f"traced in {trace_s:.1f} s ({rec['graph_nodes']} nodes, "
        f"{rec['flash_nodes']} flash_fwd); ms a forward p25/p50/p75 eager "
        + "/".join(f"{v:.3f}" for v in rec["eager"]["ms_quartiles"])
        + ", to_static "
        + "/".join(f"{v:.3f}" for v in rec["to_static"]["ms_quartiles"])
        + f"; kernels {rec['eager']['kernels_per_forward']:.0f} / "
        f"{rec['to_static']['kernels_per_forward']:.0f}, busy "
        f"{rec['eager']['device_busy_ms']:.3f} / "
        f"{rec['to_static']['device_busy_ms']:.3f} ms, idle share "
        f"{rec['eager']['device_idle_share']:.3f} / "
        f"{rec['to_static']['device_idle_share']:.3f}; flash launches "
        f"{l_eager} / {l_static}; max abs err {errs} [{smi}]")
    if l_eager != (12, 0, 0) or l_static != (12, 0, 0) or \
            rec["flash_nodes"] != 12:
        raise AssertionError(f"phase 25 (a): flash launches {l_eager} / "
                             f"{l_static}, {rec['flash_nodes']} nodes")
    if not all(np.allclose(g, w, atol=ATOL, rtol=RTOL)
               for g, w in zip(got, want)):
        raise AssertionError(f"phase 25 (a): to_static differs: {errs}")
    return rec


def jit_predictor(pt, smi, cfg, net, ins, out_dir):
    """Phase 25 (b): jit.save on the card, the Predictor in a fresh
    process, each batch held to the eager Layer and to the plain
    attention; a CPU-saved program refused on the card."""
    import numpy as np
    from paddle_tpu_torch.nn.functional import attention as ta
    from paddle_tpu_torch.static import InputSpec
    prefix = os.path.join(out_dir, "bert")
    specs = [InputSpec([None, JIT_S], "int64", "input_ids"),
             InputSpec([None, JIT_S], "int64", "token_type_ids"),
             InputSpec([None, 1, 1, JIT_S], "float32", "attention_mask")]
    t0 = time.perf_counter()
    pt.jit.save(net, prefix, input_spec=specs)
    save_s = time.perf_counter() - t0
    sizes = {s: os.path.getsize(prefix + s) for s in (".pdmodel",
                                                     ".pdiparams")}
    np.savez(os.path.join(out_dir, "inputs.npz"), ids=ins[0],
             token_types=ins[1], mask=ins[2])
    want, plain = {}, {}
    route = ta.sdpa_route
    for B in JIT_BATCHES:
        args = [pt.to_tensor(a[:B]) for a in ins]
        want[B] = [o.numpy() for o in net(*args)]
        ta.sdpa_route = lambda q, k, d: "plain"
        try:
            plain[B] = [o.numpy() for o in net(*args)]
        finally:
            ta.sdpa_route = route
    env = dict(os.environ, PYTHONPATH=ROOT)
    out_path = os.path.join(out_dir, "served.npz")
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", JIT_CHILD, prefix,
                        os.path.join(out_dir, "inputs.npz"), out_path,
                        ",".join(map(str, JIT_BATCHES))], env=env,
                       capture_output=True, text=True, timeout=JIT_CHILD_S)
    child_s = time.perf_counter() - t0
    with open(os.path.join(ROOT, "chiprun_out", "phase25_child.log"),
              "w") as f:
        f.write(p.stdout + "\n--- stderr ---\n" + p.stderr)
    if p.returncode != 0:
        raise AssertionError(f"phase 25 (b): the Predictor process failed "
                             f"({p.returncode}): {p.stderr[-2000:]}")
    rec = json.loads(next(l for l in p.stdout.splitlines()
                          if l.startswith("JIT_CHILD "))[len("JIT_CHILD "):])
    served = np.load(out_path)
    rec.update({"save_s": save_s, "bytes": sizes, "child_s": child_s})
    for B in JIT_BATCHES:
        r = rec["runs"][str(B)]
        got = [served[f"seq{B}"], served[f"pooled{B}"]]
        r["max_abs_err_eager"] = [_max_err(g, w) for g, w in
                                  zip(got, want[B])]
        r["max_abs_err_plain"] = [_max_err(g, w) for g, w in
                                  zip(got, plain[B])]
        r["eager_plain_max_abs_err"] = [_max_err(g, w) for g, w in
                                        zip(want[B], plain[B])]
        ok = all(np.allclose(g, w, atol=ATOL, rtol=RTOL)
                 for ref in (want[B], plain[B]) for g, w in zip(got, ref))
        log(f"jit (b) Predictor B={B}: {r['ms_median']:.3f} ms a run(), "
            f"flash launches {r['launches']}, max abs err vs eager "
            f"{r['max_abs_err_eager']}, vs the plain attention "
            f"{r['max_abs_err_plain']} [{smi}]")
        if r["launches"] != [12, 0, 0] or not ok:
            raise AssertionError(f"phase 25 (b): B={B} {r}")
    log(f"jit (b) save {save_s:.1f} s (.pdmodel {sizes['.pdmodel']} B, "
        f".pdiparams {sizes['.pdiparams']} B); child import "
        f"{rec['import_s']:.2f} s, load to ready {rec['load_to_ready_s']:.2f}"
        f" s, ready_stages "
        + ", ".join(f"{k} {v:.3f}" for k, v in rec["ready_stages"].items())
        + f"; the child took {child_s:.1f} s [{smi}]")
    # a program traced on the CPU holds the plain attention: refused here
    pt.set_device("cpu")
    try:
        small = pt.nn.Linear(8, 4)
        cpu_prefix = os.path.join(out_dir, "cpu_saved")
        pt.jit.save(small, cpu_prefix, input_spec=[InputSpec([None, 8])])
    finally:
        pt.set_device("gpu")
    refused = []
    for what, call in (
            ("jit.load", lambda: pt.jit.load(cpu_prefix, device="gpu")),
            ("create_predictor", lambda: pt.inference.create_predictor(
                pt.inference.Config(cpu_prefix + ".pdmodel",
                                    cpu_prefix + ".pdiparams")))):
        try:
            call()
        except RuntimeError as e:
            if "traced on cpu" not in str(e):
                raise
            refused.append(what)
    rec["cpu_saved_refused"] = refused
    log(f"jit (b) a CPU-saved program on the card: refused by {refused}")
    if refused != ["jit.load", "create_predictor"]:
        raise AssertionError("phase 25 (b): a CPU-saved program ran on "
                             "the card")
    return rec


def jit_capture_amp(pt, smi, net, ins):
    """Phase 25 (c): Program.capture of the encoder forward and the amp
    pass."""
    import numpy as np
    from paddle_tpu_torch.distributed import passes
    from paddle_tpu_torch.static import InputSpec, Program
    x = net.embeddings(pt.to_tensor(ins[0]), pt.to_tensor(ins[1]))
    mask = pt.to_tensor(ins[2])
    prog = Program.capture(
        lambda h, m: net.encoder(h, m),
        InputSpec([JIT_B, JIT_S, 768]), InputSpec([JIT_B, 1, 1, JIT_S]),
        device=x._data.device)
    f32, l32 = _launched(lambda: prog.run_captured(x, mask)[0]
                         .detach().cpu().numpy())
    want = net.encoder(x, mask).numpy()
    passes.new_pass("amp").apply(prog)
    text = prog.to_string()
    types = [o.type() for o in prog.ops()]
    bf16, l16 = _launched(lambda: prog.run_captured(x, mask)[0]
                          .detach().cpu().numpy())
    rec = {"flash_nodes": types.count("flash_fwd"),
           "bf16_in_ir": "bf16" in text, "casts": types.count("_to_copy"),
           "launches_f32": l32, "launches_bf16": l16,
           "max_abs_err_f32_vs_eager": _max_err(f32, want),
           "max_abs_err_bf16_vs_f32": _max_err(bf16, f32),
           # the products round to 8 mantissa bits in each of 12 layers:
           # the relative error of the whole output, not each element
           "rel_err_bf16_vs_f32": float(np.linalg.norm(bf16 - f32)
                                        / np.linalg.norm(f32)),
           "max_abs_f32": float(np.abs(f32).max()), "tol": BF16_TOL}
    log(f"jit (c) encoder program: amp pass {rec['casts']} casts, bf16 in "
        f"the IR {rec['bf16_in_ir']}, {rec['flash_nodes']} flash_fwd "
        f"nodes, launches f32 {l32} / bf16 {l16}; f32 program vs eager "
        f"{rec['max_abs_err_f32_vs_eager']:.2e}, bf16 vs f32 relative "
        f"{rec['rel_err_bf16_vs_f32']:.2e} (tol {BF16_TOL}), max abs "
        f"{rec['max_abs_err_bf16_vs_f32']:.2e} (|f32| max "
        f"{rec['max_abs_f32']:.2f}) [{smi}]")
    if not rec["bf16_in_ir"] or rec["flash_nodes"] != 12 or \
            l32 != (12, 0, 0) or l16 != (12, 0, 0) or \
            not np.allclose(f32, want, atol=ATOL, rtol=RTOL) or \
            not rec["rel_err_bf16_vs_f32"] <= BF16_TOL:
        raise AssertionError(f"phase 25 (c): {rec}")
    return rec


def jit_control_flow(pt, smi):
    """Phase 25 (d): tensor-dependent while / break / if on CUDA tensors,
    the to_static program against the eager Python run."""
    import numpy as np
    from paddle_tpu_torch.static import op_type

    def fn(x, limit):
        s = pt.zeros_like(x[0])
        row = x[0]                  # carried: bound before the loop
        i = pt.to_tensor(np.int64(0))
        while i < x.shape[0]:
            row = x[i]
            if row.sum() > limit:
                break
            if row.mean() > 0:
                s = s + row
            else:
                s = s - row * 0.5
            i = i + 1
        return s, i

    rng = np.random.RandomState(25)
    st = pt.jit.to_static(fn)
    rec = {"cases": []}
    for rows, limit in ((64, 1e9), (64, 30.0), (256, 60.0)):
        x = pt.to_tensor(rng.randn(rows, 1024).astype(np.float32))
        lim = pt.to_tensor(np.float32(limit))
        want = [o.numpy() for o in fn(x, lim)]
        got = [o.numpy() for o in st(x, lim)]
        err = _max_err(got[0], want[0])
        rec["cases"].append({"rows": rows, "limit": limit, "stopped_at":
                             int(got[1]), "max_abs_err": err})
        if int(got[1]) != int(want[1]) or \
                not np.allclose(got[0], want[0], atol=ATOL, rtol=RTOL):
            raise AssertionError(f"phase 25 (d): {rec['cases'][-1]}")
    kinds = set()
    for g in st.concrete_programs.values():
        kinds |= {op_type(n.target) for m in g.modules()
                  if hasattr(m, "graph") for n in m.graph.nodes
                  if n.op == "call_function"}
    rec["hops"] = sorted(kinds & {"cond", "while_loop", "scan"})
    log(f"jit (d) dy2static while/break/if on CUDA: {rec['cases']}, "
        f"program HOPs {rec['hops']} [{smi}]")
    if rec["hops"] != ["cond", "while_loop"]:
        raise AssertionError(f"phase 25 (d): HOPs {rec['hops']}")
    return rec


def jit_phase(smi):
    """Phase 25 (module docstring): parts a, b, c, d; each raises on
    failure. Returns the record and the flash forward launches of its
    paths (each counted from 0 just before it, the Predictor's in its
    process)."""
    import gc
    import torch
    import paddle_tpu_torch as pt
    t0 = time.perf_counter()
    pt.set_device("gpu")
    out_dir = os.path.join(ROOT, "build", "phase25")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    secs = {}
    try:
        cfg, net, twin = _bert_pair(pt)
        ins = jit_inputs(pt, cfg, JIT_B, JIT_S)
        args = [pt.to_tensor(a) for a in ins]
        t1 = time.perf_counter()
        out = {"a": jit_to_static(pt, smi, net, twin, args)}
        secs["a"] = time.perf_counter() - t1
        del twin
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        out["b"] = jit_predictor(pt, smi, cfg, net, ins, out_dir)
        secs["b"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        out["c"] = jit_capture_amp(pt, smi, net, ins)
        secs["c"] = time.perf_counter() - t1
        t1 = time.perf_counter()
        out["d"] = jit_control_flow(pt, smi)
        secs["d"] = time.perf_counter() - t1
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    a, b, c = out["a"], out["b"], out["c"]
    out["launches_fwd"] = (a["launches_eager"][0] + a["launches_static"][0]
                           + sum(r["launches"][0] for r in b["runs"].values())
                           + c["launches_f32"][0] + c["launches_bf16"][0])
    out["seconds"] = time.perf_counter() - t0
    out["seconds_by_part"] = secs
    log(f"phase 25 took {out['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items())
        + f"); flash forward launches {out['launches_fwd']} [{smi}]")
    return out


# ---------------------------------------------------------------------------
# Phase 26: the process layer and data parallelism (ROADMAP A.13f(i))
# ---------------------------------------------------------------------------

DIST_B = 128                    # (a): phase 23's global batch, 64 a rank
DIST_STEPS = 5                  # (a): steps held to the one-process step
DIST_SEED = 26
# (a): phase 23 (a)'s weights and optimizer at lr 0.01: at its lr 0.1 the
# loss on random labels diverges (3.73 -> 48.2 in 5 steps on the card,
# PERF.md), which grows any rounding difference without bound
DIST_LR = 0.01
# (a): each dp2 step against the one-process step from the same weights,
# optimizer state and batch (the two never drift apart: a 1e-6 change of
# the input moves ResNet-50's second loss by 3.6% on random labels, and
# the two paths' rounding differs). The loss, |a - b| / |b|: the forward
# differs by the statistics' sum and sum of squares against the two-pass
# variance and by the convolutions' order at B=64 against B=128; the CPU
# read 5e-7 to 6.9e-6. The update, ||p_dp - p_one|| / ||p_one - p_before||
# over every parameter: the CPU read 0.0024 to 0.021 (the same step in
# float64 statistics 0.006 to 0.014; the backward of BatchNorm over
# 128 values at layer4's 1x1 maps amplifies rounding); a gradient summed
# where it should be averaged reads 1.0
DIST_LOSS_RTOL = 1e-4
DIST_UPDATE_RTOL = 0.1
DIST_GPT = dict(vocab_size=50304, max_seq_len=1024, hidden=768, layers=2,
                heads=12)       # (c): GPT-125M's widths, 2 layers
DIST_GPT_B, DIST_GPT_STEPS = 8, 3
DIST_GPT_RTOL = 1e-5            # (c): the same sums in the same order
DIST_CHILD_S = 900              # a launch of ranks, imports and builds in
DIST_CHILD_SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _dist_batches(B, steps, seed=DIST_SEED):
    import numpy as np
    rng = np.random.RandomState(seed)
    return [(rng.rand(B, 3, 32, 32).astype("float32"),
             rng.randint(0, 10, (B,)).astype("int64"))
            for _ in range(steps)]


def _dist_gpt(B=DIST_GPT_B, steps=DIST_GPT_STEPS, seed=DIST_SEED):
    import numpy as np
    import torch
    from paddle_tpu_torch.parallel import GPTSpmdConfig
    cfg = GPTSpmdConfig(**DIST_GPT, param_dtype="bfloat16",
                        compute_dtype="bfloat16", remat=False)
    rng = np.random.RandomState(seed)
    shape = (B, cfg.max_seq_len)
    data = [(torch.from_numpy(rng.randint(0, cfg.vocab_size, shape)).cuda(),
             torch.from_numpy(rng.randint(0, cfg.vocab_size, shape)).cuda())
            for _ in range(steps)]
    return cfg, data


def dist_child_collectives(pt, rec):
    """Phase 26 (b), in each rank: the eager collectives over the gloo
    group on CUDA tensors and the TCPStore, with their exact values."""
    import numpy as np
    import torch
    from paddle_tpu_torch.core.device import current_device
    D = pt.distributed
    me, n = D.get_rank(), D.get_world_size()
    dev = current_device()

    def full(v, k=3, dt="float32"):
        return pt.to_tensor(np.full((k,), v, dt), place="gpu")
    got = {}
    for op, dt, v in (("SUM", "float32", me + 1.0), ("MAX", "float32",
                                                      me + 1.0),
                      ("MIN", "float32", me + 1.0), ("PROD", "int64", me + 2),
                      ("AVG", "float32", me + 1.0), ("SUM", "bfloat16",
                                                      me + 1.0)):
        t = full(v, dt=dt) if dt != "bfloat16" else \
            full(v).astype("bfloat16")
        D.all_reduce(t, getattr(D.ReduceOp, op))
        if t._data.device != dev:
            raise AssertionError(f"phase 26 (b): all_reduce {op} left "
                                 f"{dev} for {t._data.device}")
        got[f"all_reduce_{op}_{dt}"] = t.astype("float32").numpy().tolist()
    b = full(10.0 * (me + 1), 2)
    D.broadcast(b, src=1)
    got["broadcast_src1"] = b.numpy().tolist()
    parts = []
    D.all_gather(parts, full(float(me), 2))
    got["all_gather"] = [p.numpy().tolist() for p in parts]
    got["reduce_scatter"] = D.reduce_scatter(pt.to_tensor(
        np.arange(4, dtype="float32") * (me + 1), place="gpu")).numpy() \
        .tolist()
    objs = []
    D.all_gather_object(objs, {"rank": me, "card": torch.cuda.current_device()})
    got["all_gather_object"] = objs
    D.barrier()
    store = D.TCPStore(is_master=True, world_size=n) if me == 0 else None
    port = [None] * n
    torch.distributed.all_gather_object(port, store.port if store else None)
    if store is None:
        store = D.TCPStore(port=port[0], world_size=n)
    store.set(f"k{me}", f"v{me}")
    adds = store.add("count", 1)
    store.barrier("phase26")
    got["store"] = [store.get(f"k{1 - me}").decode(), adds]
    D.barrier()                 # every rank done with the store: rank 0's
    store.stop()                # server may go
    want = {"all_reduce_SUM_float32": [3.0] * 3,
            "all_reduce_MAX_float32": [2.0] * 3,
            "all_reduce_MIN_float32": [1.0] * 3,
            "all_reduce_PROD_int64": [6.0] * 3,
            "all_reduce_AVG_float32": [1.5] * 3,
            "all_reduce_SUM_bfloat16": [3.0] * 3,
            "broadcast_src1": [20.0] * 2,
            "all_gather": [[0.0, 0.0], [1.0, 1.0]],
            "reduce_scatter": [[0.0, 3.0], [6.0, 9.0]][me],
            "all_gather_object": [{"rank": 0, "card": 0},
                                  {"rank": 1, "card": 0}]}
    bad = {k: (got[k], v) for k, v in want.items() if got[k] != v}
    if bad or got["store"][0] != f"v{1 - me}":
        raise AssertionError(f"phase 26 (b) rank {me}: {bad or got['store']}")
    rec["collectives"] = got


def _tree_clone(state):
    import torch
    from torch.utils._pytree import tree_map
    return tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor)
                    else t, state)


def dist_child_resnet(pt, rec, out_dir):
    """Phase 26 (a), in each rank: ResNet-50 `Model.train_batch` on this
    rank's 64 rows of each global batch (the dp route, SyncBatchNorm).
    For DIST_STEPS steps rank 0 first runs the one-process step (phase
    23's model, plain BatchNorm, no mesh) from the dp model's weights and
    optimizer state on the whole batch, and holds the dp step's loss and
    update to it; then DIST_STEPS timed steps with the gradient
    all-reduce timed inside each, and one step under a device capture."""
    import torch
    from paddle_tpu_torch.distributed import collective as dc
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.observability import deviceprof
    me = pt.distributed.get_rank()
    model = _resnet_model(pt, lr=DIST_LR, sync_bn=True)
    mesh = env.get_mesh()
    if model._dp_mesh() is not mesh or mesh.dims != {"dp": 2}:
        raise AssertionError(f"phase 26 (a): the dp route is off "
                             f"({mesh and mesh.dims})")
    ref = _resnet_model(pt, lr=DIST_LR) if me == 0 else None
    batches = _dist_batches(DIST_B, DIST_STEPS)
    losses, ref_losses, ref_ms, upd_err = [], [], [], []
    for x, y in batches:
        if ref is not None:
            before = {k: v._data.clone()
                      for k, v in model.network.state_dict().items()}
            ref.network.set_state_dict(before)
            ref._opt_state = _tree_clone(model._opt_state)
            env.set_mesh(None)          # the plain one-process step
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                ref_losses.append(ref.train_batch([x], [y])[0][0])
                ref_ms.append((time.perf_counter() - t0) * 1e3)
            finally:
                env.set_mesh(mesh)
        pt.distributed.barrier()
        losses.append(model.train_batch([x], [y])[0][0])
        if ref is not None:
            num = den = 0.0
            got = model.network.state_dict()
            for k, v in ref.network.state_dict().items():
                if k.endswith(("_mean", "_variance")):
                    continue
                want, b = v._data.double(), before[k].double()
                num += float(((got[k]._data.double() - want) ** 2).sum())
                den += float(((want - b) ** 2).sum())
            upd_err.append((num / den) ** 0.5)
    # the timed steps: the gradient all-reduce, and apart from it every
    # other reduction across the processes (the BatchNorms' statistics,
    # forward and backward), each timed from a synchronized card
    ar_ms, grad_bytes, comm = [], [], []
    inner, inner_reduce = dc.all_reduce_mean_, dc._world_reduce
    in_grads = []

    def timed_all_reduce(ts, *rest):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        in_grads.append(True)
        try:
            out = inner(ts, *rest)
        finally:
            in_grads.pop()
        torch.cuda.synchronize()
        ar_ms.append((time.perf_counter() - t0) * 1e3)
        grad_bytes.append(sum(t.numel() * 4 for t in ts))
        return out

    def timed_reduce(x, op, *rest):
        if in_grads:
            return inner_reduce(x, op, *rest)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner_reduce(x, op, *rest)
        torch.cuda.synchronize()
        comm.append((time.perf_counter() - t0) * 1e3)
        return out
    dc.all_reduce_mean_, dc._world_reduce = timed_all_reduce, timed_reduce
    step_ms, comm_ms, comm_calls = [], [], []
    try:
        for x, y in batches:
            pt.distributed.barrier()
            torch.cuda.synchronize()
            del comm[:]
            t0 = time.perf_counter()
            model.train_batch([x], [y])
            step_ms.append((time.perf_counter() - t0) * 1e3)
            comm_ms.append(sum(comm))
            comm_calls.append(len(comm))
    finally:
        dc.all_reduce_mean_, dc._world_reduce = inner, inner_reduce
    _, prof = deviceprof.capture(
        lambda: model.train_batch([batches[0][0]], [batches[0][1]]),
        out_dir, iters=1, label="phase26_resnet50")
    rec["resnet"] = {"losses": losses, "one_process_losses": ref_losses,
                     "one_process_step_ms": ref_ms, "update_rel_err": upd_err,
                     "step_ms": step_ms, "allreduce_ms": ar_ms[:DIST_STEPS],
                     "comm_ms": comm_ms, "comm_calls": comm_calls,
                     "grad_bytes": grad_bytes[0],
                     "kernels_per_step": prof["n_events"],
                     "device_busy_ms": prof["total_device_ms"],
                     "peak_gb": torch.cuda.max_memory_allocated() / 2 ** 30}


def dist_child_gpt(pt, rec):
    """Phase 26 (c), in each rank: the multi-controller `gpt_spmd` dp2
    step (this process drives one rank), its flash launches counted."""
    import torch
    from paddle_tpu_torch.parallel import MeshPlan, make_train_step
    cfg, data = _dist_gpt()
    step_fn, init_fn = make_train_step(cfg, MeshPlan(dp=2), device="cuda",
                                       learning_rate=1e-3)
    params, state = init_fn(DIST_SEED)
    if len(params["wte"]) != 1:
        raise AssertionError("phase 26 (c): a process holds "
                             f"{len(params['wte'])} ranks, want 1")
    c0 = _flash_counts()
    losses, step_ms = [], []
    for toks, labs in data:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, params, state = step_fn(params, state, toks, labs)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
    c1 = _flash_counts()
    rec["gpt"] = {"losses": losses, "step_ms": step_ms,
                  "flash_launches": {k: b - a for k, a, b in
                                     zip(("fwd", "dq", "dkv"), c0, c1)},
                  "wte_sum": float(params["wte"][0].detach().double().sum())}


def dist_child_nccl(rec):
    """Phase 26 (b), the one-rank NCCL group: the port's all_reduce and
    broadcast on the card through the nccl backend."""
    import socket
    import numpy as np
    import torch
    import paddle_tpu_torch as pt
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    torch.distributed.init_process_group(
        "nccl", init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1,
        device_id=torch.device("cuda", 0))
    calls = []
    for name in ("all_reduce", "broadcast"):
        fn = getattr(torch.distributed, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)
        setattr(torch.distributed, name, counted)
    t = pt.to_tensor(np.arange(4, dtype="float32") + 1, place="gpu")
    pt.distributed.all_reduce(t)
    pt.distributed.broadcast(t, src=0)
    torch.cuda.synchronize()
    rec["nccl"] = {"backend": pt.distributed.get_backend(),
                   "values": t.numpy().tolist(), "calls": calls}
    if rec["nccl"] != {"backend": "nccl", "values": [1.0, 2.0, 3.0, 4.0],
                       "calls": ["all_reduce", "broadcast"]}:
        raise AssertionError(f"phase 26 (b) nccl: {rec['nccl']}")
    torch.distributed.destroy_process_group()


def dist_child(arm, out_dir):
    """A rank of phase 26, started by the port's launcher (`--dist-child
    ARM DIR`); writes DIR/ARM_rank<r>.json."""
    import faulthandler
    faulthandler.dump_traceback_later(DIST_CHILD_S, exit=True)
    sys.path.insert(0, ROOT)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = {"pid": os.getpid()}
    if arm == "nccl":
        dist_child_nccl(rec)
        me = 0
    else:
        import paddle_tpu_torch as pt
        pt.distributed.init_parallel_env(backend="gloo")
        me = pt.distributed.get_rank()
        rec.update(rank=me, world=pt.distributed.get_world_size(),
                   backend=pt.distributed.get_backend(),
                   device=str(torch.cuda.current_device()))
        dist_child_collectives(pt, rec)
        dist_child_resnet(pt, rec, os.path.join(out_dir, f"capture{me}"))
        torch.cuda.empty_cache()
        dist_child_gpt(pt, rec)
        pt.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"{arm}_rank{me}.json"), "w") as f:
        json.dump(rec, f)
    return 0


def dist_launch(arm, nproc, out_dir, log_dir):
    """Start `nproc` ranks of `dist_child(arm)` through `python -m
    paddle_tpu_torch.distributed.launch`, in a session of their own that
    is killed whole at the end; returns the ranks' records."""
    import signal
    os.makedirs(out_dir, exist_ok=True)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", str(nproc), "--devices", "0",
           "--log_dir", os.path.join(log_dir, arm),
           DIST_CHILD_SCRIPT, "--dist-child", arm, out_dir]
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, cwd=ROOT, env=env, start_new_session=True)
    try:
        rc = p.wait(timeout=DIST_CHILD_S + 60)
    except subprocess.TimeoutExpired:
        rc = "timeout"
    finally:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait()
    if rc != 0:
        tails = []
        for r in range(nproc):
            path = os.path.join(log_dir, arm, f"workerlog.{r}")
            if os.path.exists(path):
                with open(path) as f:
                    tails.append(f"--- rank {r} ---\n{f.read()[-3000:]}")
        raise AssertionError(f"phase 26 ({arm}): the launch exited {rc}\n"
                             + "\n".join(tails))
    recs = []
    for r in range(nproc):
        with open(os.path.join(out_dir, f"{arm}_rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs, time.perf_counter() - t0


def _rel_err(got, want):
    return max(abs(a - b) / max(abs(b), 1e-12) for a, b in zip(got, want))


def dist_phase(smi):
    """Phase 26: (a) ResNet-50 `Model.train_batch` as a dp2 job of two
    processes on the one card over gloo, held to the one-process step;
    (b) the eager collectives on CUDA tensors and a one-rank NCCL group;
    (c) the multi-controller `gpt_spmd` dp2 step at GPT-125M's widths,
    held to the one-controller dp2 plan, with its flash launches."""
    import torch
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.parallel import MeshPlan, make_train_step
    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "phase26")
    log_dir = os.path.join(ROOT, "chiprun_out", "phase26")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(log_dir, exist_ok=True)
    rec = {"card": smi}

    # (c)'s one-controller reference, on the same weights and batches
    cfg, data = _dist_gpt()
    step_fn, init_fn = make_train_step(cfg, MeshPlan(dp=2), device="cuda",
                                       learning_rate=1e-3)
    params, state = init_fn(DIST_SEED)
    c0 = _flash_counts()
    gpt_ref = []
    for toks, labs in data:
        loss, params, state = step_fn(params, state, toks, labs)
        gpt_ref.append(float(loss))
    c1 = _flash_counts()
    gpt_ref_sum = float(params["wte"][0].detach().double().sum())
    ref_flash = [b - a for a, b in zip(c0, c1)]
    del params, state, step_fn, init_fn
    torch.cuda.empty_cache()

    # the two-process job and the one-rank NCCL group
    ranks, launch_s = dist_launch("gloo", 2, work, log_dir)
    nccl, nccl_s = dist_launch("nccl", 1, work, log_dir)
    rec.update(launch_s=launch_s, nccl_launch_s=nccl_s, nccl=nccl[0]["nccl"],
               collectives=ranks[0]["collectives"])
    for r, rr in enumerate(ranks):
        if (rr["rank"], rr["world"], rr["backend"], rr["device"]) != \
                (r, 2, "gloo", "0"):
            raise AssertionError(f"phase 26: rank {r} reads {rr}")
    log(f"dist launch: 2 ranks (gloo, both on card 0) through "
        f"`python -m paddle_tpu_torch.distributed.launch` in "
        f"{launch_s:.1f} s; the one-rank nccl group in {nccl_s:.1f} s "
        f"(backend {nccl[0]['nccl']['backend']}, "
        f"{nccl[0]['nccl']['calls']}) [{smi}]")
    log(f"dist collectives on CUDA tensors over the gloo group: "
        f"{sorted(ranks[0]['collectives'])} exact on both ranks [{smi}]")

    # (a) ResNet-50 dp2 against the one-process step
    a = [rr["resnet"] for rr in ranks]
    a0 = a[0]
    if a[1]["losses"] != a0["losses"]:
        raise AssertionError(f"phase 26 (a): the ranks' losses differ: "
                             f"{a0['losses']} / {a[1]['losses']}")
    loss_err = [abs(d - o) / abs(o) for d, o in
                zip(a0["losses"], a0["one_process_losses"])]
    if max(loss_err) > DIST_LOSS_RTOL or \
            max(a0["update_rel_err"]) > DIST_UPDATE_RTOL:
        raise AssertionError(
            f"phase 26 (a): dp2 losses {a0['losses']} against the "
            f"one-process step {a0['one_process_losses']} (rel err "
            f"{loss_err}, limit {DIST_LOSS_RTOL}); update rel err "
            f"{a0['update_rel_err']} (limit {DIST_UPDATE_RTOL})")
    steps = [ms for ar in a for ms in ar["step_ms"][1:]]
    ars = [ms for ar in a for ms in ar["allreduce_ms"][1:]]
    bn = [c for ar in a for c in ar["comm_ms"][1:]]
    share = [x / s for ar in a for x, s in zip(ar["allreduce_ms"][1:],
                                               ar["step_ms"][1:])]
    rec["resnet"] = {
        "ranks": a, "loss_rel_err": loss_err,
        "update_rel_err": a0["update_rel_err"],
        "step_ms_quartiles": quartiles(steps),
        "allreduce_ms_quartiles": quartiles(ars),
        "allreduce_share_quartiles": quartiles(share),
        "bn_sync_ms_quartiles": quartiles(bn),
        "comm_calls_per_step": a0["comm_calls"][-1],
        "one_process_step_ms_quartiles": quartiles(
            a0["one_process_step_ms"][1:])}
    q, qa, qs = (rec["resnet"][k] for k in (
        "step_ms_quartiles", "allreduce_ms_quartiles",
        "allreduce_share_quartiles"))
    log(f"dist resnet50 dp2 (2 processes, 1 card, gloo, B={DIST_B} global, "
        f"f32, SyncBatchNorm route, lr {DIST_LR}): losses "
        f"{[round(v, 6) for v in a0['losses']]}, each step against the "
        f"one-process step from the same state: loss rel err "
        f"{max(loss_err):.3g}, update rel err "
        f"{max(a0['update_rel_err']):.3g}; step ms p25/p50/p75 "
        + "/".join(f"{v:.2f}" for v in q) + " (one process "
        + "/".join(f"{v:.2f}" for v in
                   rec["resnet"]["one_process_step_ms_quartiles"])
        + "); gradient all-reduce "
        f"({a0['grad_bytes'] / 1e6:.1f} MB f32 a step through gloo's host "
        f"staging) ms " + "/".join(f"{v:.2f}" for v in qa)
        + ", share of the step " + "/".join(f"{v:.3f}" for v in qs)
        + "; the other reductions across the processes (the BatchNorms' "
        "statistics forward and backward, and the loss: "
        f"{rec['resnet']['comm_calls_per_step']} a step, each from a "
        "synchronized card) ms " + "/".join(
            f"{v:.2f}" for v in rec["resnet"]["bn_sync_ms_quartiles"])
        + f"; {a0['kernels_per_step']} / {a[1]['kernels_per_step']} kernels "
        f"a step, device busy {a0['device_busy_ms']:.2f} / "
        f"{a[1]['device_busy_ms']:.2f} ms (ranks 0 / 1); peak "
        f"{a0['peak_gb']:.2f} / {a[1]['peak_gb']:.2f} GB [{smi}]")

    # (c) the multi-controller gpt_spmd dp2 step
    c = [rr["gpt"] for rr in ranks]
    per_rank = cfg.layers * DIST_GPT_STEPS      # one rank a process
    if ref_flash != [2 * per_rank] * 3:
        raise AssertionError(f"phase 26 (c): the one-controller plan "
                             f"launched {ref_flash}, want {2 * per_rank} each")
    for r, cr in enumerate(c):
        err = _rel_err(cr["losses"], gpt_ref)
        fl = cr["flash_launches"]
        if err > DIST_GPT_RTOL or abs(cr["wte_sum"] - gpt_ref_sum) > \
                DIST_GPT_RTOL * abs(gpt_ref_sum) + 1e-6:
            raise AssertionError(
                f"phase 26 (c) rank {r}: losses {cr['losses']} vs "
                f"{gpt_ref} ({err:.3g}), wte sum {cr['wte_sum']} vs "
                f"{gpt_ref_sum}")
        if fl != {"fwd": per_rank, "dq": per_rank, "dkv": per_rank}:
            raise AssertionError(f"phase 26 (c) rank {r}: flash launches "
                                 f"{fl}, want {per_rank} each")
    rec["gpt"] = {"ranks": c, "one_controller_losses": gpt_ref,
                  "one_controller_flash": ref_flash,
                  "loss_rel_err": max(_rel_err(cr["losses"], gpt_ref)
                                      for cr in c)}
    log(f"dist gpt_spmd dp2 multi-controller (GPT-125M widths, 2 layers, "
        f"bf16, B={DIST_GPT_B}, S=1024, 2 processes on 1 card): losses "
        f"{c[0]['losses']} vs one controller {gpt_ref}, worst rel err "
        f"{rec['gpt']['loss_rel_err']:.3g}; step ms "
        f"{[round(v, 1) for v in c[0]['step_ms']]}; flash launches "
        f"{c[0]['flash_launches']} / {c[1]['flash_launches']} (ranks 0 / 1) "
        f"[{smi}]")
    shutil.rmtree(work, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"phase 26 took {rec['seconds']:.1f} s [{smi}]")
    return rec


# ---------------------------------------------------------------------------
# 27. fleet and hybrid parallelism
# ---------------------------------------------------------------------------

FLEET_ERNIE = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
FLEET_PP_B, FLEET_PP_S, FLEET_PP_M, FLEET_PP_STEPS = 32, 128, 4, 3
FLEET_PP_LR = 0.05
# (a): each pipelined step against the unpipelined step from the same
# weights: the loss is a mean over 4 microbatch means against one mean
# over the batch, and the gradients sum 4 microbatches' in f32; both
# differ only by the reductions' order (f32, TF32 off)
FLEET_PP_LOSS_RTOL = 1e-5
FLEET_PP_UPDATE_RTOL = 1e-3
# (b): ERNIE-3.0-Base's widths through fleet's mp layers, mp=2 across two
# processes; the one-process step computes the same sums in another
# order (the row layers' partial products summed across the processes)
FLEET_MP = dict(vocab=40000, hidden=768, ffn=3072, blocks=12, B=32, S=128)
FLEET_MP_STEPS, FLEET_MP_LR = 3, 0.05
FLEET_MP_LOSS_RTOL = 1e-5
FLEET_MP_UPDATE_RTOL = 1e-3
# (c): the gpt_spmd plans of tests/dist_hybrid_worker.py at GPT-125M's
# widths, 2 layers a stage, bf16; (tag, plan, the axis across processes)
FLEET_GPT = dict(vocab_size=50304, max_seq_len=1024, hidden=768, heads=12)
FLEET_GPT_PLANS = (
    ("dp2_pp2_mp2_pp_cross", dict(dp=2, pp=2, mp=2, microbatches=2),
     ("pp",)),
    ("dp4_mp2_mp_cross", dict(dp=4, mp=2), ("mp",)),
    ("dp4_sharding2_sharding_cross", dict(dp=4, sharding=2), ("sharding",)))
FLEET_GPT_STEPS = 3
FLEET_GPT_SEED = 27
FLEET_CHILD_S = 900
FLEET_DEV = "cuda"             # the torch device phase 27 runs on


def _place():
    return "gpu" if FLEET_DEV == "cuda" else FLEET_DEV


def _fleet_gpt(plan, dev):
    """(cfg, tokens, labels) of a phase 27 (c) plan: one row a rank and
    microbatch."""
    import numpy as np
    import torch
    from paddle_tpu_torch.parallel import GPTSpmdConfig
    layers = 2 * plan.get("pp", 1)
    cfg = GPTSpmdConfig(**FLEET_GPT, layers=layers, ffn=4 * FLEET_GPT["hidden"],
                        param_dtype="bfloat16", compute_dtype="bfloat16",
                        remat=False)
    B = plan.get("dp", 1) * plan.get("sharding", 1) * \
        plan.get("microbatches", 1)
    rng = np.random.RandomState(FLEET_GPT_SEED)
    shape = (B, cfg.max_seq_len)
    return (cfg, torch.from_numpy(rng.randint(0, cfg.vocab_size, shape))
            .to(dev), torch.from_numpy(rng.randint(0, cfg.vocab_size, shape))
            .to(dev))


def fleet_gpt_run(plan, axis_order=None):
    """FLEET_GPT_STEPS steps of a phase 27 (c) plan from init_fn's seed:
    losses, step ms, this process's flash launches and a SHA-256 of the
    bytes of every leaf of each local rank ("<rank>/<leaf>")."""
    import hashlib
    import torch
    from paddle_tpu_torch.parallel import MeshPlan, make_train_step
    dev = FLEET_DEV
    cfg, toks, labs = _fleet_gpt(plan, dev)
    step_fn, init_fn = make_train_step(cfg, MeshPlan(**plan), device=dev,
                                       learning_rate=1e-3,
                                       axis_order=axis_order)
    params, state = init_fn(FLEET_GPT_SEED)
    c0 = _flash_counts()
    losses, ms = [], []
    for _ in range(FLEET_GPT_STEPS):
        _sync()
        t0 = time.perf_counter()
        loss, params, state = step_fn(params, state, toks, labs)
        losses.append(float(loss))
        ms.append((time.perf_counter() - t0) * 1e3)
    c1 = _flash_counts()
    digests = {f"{r}/{k}": hashlib.sha256(
        v[i].detach().reshape(-1).contiguous().cpu().view(torch.uint8)
        .numpy().tobytes()).hexdigest()
        for i, r in enumerate(step_fn.grid.local_ranks)
        for k, v in params.items()}
    return {"losses": losses, "step_ms": ms, "leaf_sha256": digests,
            "flash_launches": [b - a for a, b in zip(c0, c1)]}


def _sync(dev=None):
    import torch
    if str(dev or FLEET_DEV) != "cpu" and torch.cuda.is_available():
        torch.cuda.synchronize()


def _mlm_loss(pt):
    def mlm_loss(logits, labels):
        return pt.nn.functional.cross_entropy(
            logits.reshape([-1, logits.shape[-1]]), labels.reshape([-1]))
    return mlm_loss


def fleet_ernie_pp(pt, smi, save_to=None):
    """Phase 27 (a): ERNIE-3.0-Base as a pp2 PipelineLayer through
    Model.fit on the one card, each step held to the unpipelined step of
    the same PipelineLayer from the same weights. `save_to`: a file for
    the weights after the steps."""
    import numpy as np
    from paddle_tpu_torch.distributed import env as denv
    from paddle_tpu_torch.distributed.fleet.meta_parallel import PipelineLayer
    from paddle_tpu_torch.text.models import ernie as te
    pt.set_device(_place())
    cfg = te.ernie_3_base_config(**FLEET_ERNIE)
    loss_fn = _mlm_loss(pt)
    pt.seed(27)
    pl = PipelineLayer(te.ernie_pipeline_descs(cfg, loss_fn=loss_fn),
                       num_stages=2, loss_fn=loss_fn)
    ref = PipelineLayer(te.ernie_pipeline_descs(cfg, loss_fn=loss_fn),
                        num_stages=2, loss_fn=loss_fn)
    prev = denv.get_mesh()
    denv.build_mesh({"pp": 2})
    model = pt.Model(pl)
    model.prepare(pt.optimizer.SGD(FLEET_PP_LR, parameters=pl.parameters()),
                  None, strategy={"microbatches": FLEET_PP_M})
    o_ref = pt.optimizer.SGD(FLEET_PP_LR, parameters=ref.parameters())
    rng = np.random.RandomState(27)
    shape = (FLEET_PP_B, FLEET_PP_S)
    batches = [(rng.randint(0, cfg.vocab_size, shape),
                rng.randint(0, cfg.vocab_size, shape))
               for _ in range(FLEET_PP_STEPS)]
    rec = {"losses": [], "ref_losses": [], "step_ms": [], "ref_step_ms": [],
           "update_rel_err": [], "flash_launches": [], "ref_flash": [],
           "kernels_per_step": None, "card": smi}
    try:
        for x, y in batches:
            ref.set_state_dict({k: v for k, v in pl.state_dict().items()})
            before = {n: p._data.detach().clone()
                      for n, p in pl.named_parameters()}
            c0 = _flash_counts()
            _sync()
            t0 = time.perf_counter()
            lg = loss_fn(ref(pt.to_tensor(x)), pt.to_tensor(y))
            lg.backward()
            o_ref.step()
            o_ref.clear_grad()
            rec["ref_losses"].append(float(lg))
            rec["ref_step_ms"].append((time.perf_counter() - t0) * 1e3)
            c1 = _flash_counts()
            _sync()
            t0 = time.perf_counter()
            rec["losses"].append(model.train_batch([x], [y])[0][0])
            rec["step_ms"].append((time.perf_counter() - t0) * 1e3)
            c2 = _flash_counts()
            rec["ref_flash"].append([b - a for a, b in zip(c0, c1)])
            rec["flash_launches"].append([b - a for a, b in zip(c1, c2)])
            num = den = 0.0
            refp = dict(ref.named_parameters())
            for n, p in pl.named_parameters():
                a, b = p._data.detach(), refp[n]._data.detach()
                num += float(((a - b).double() ** 2).sum())
                den += float(((b - before[n]).double() ** 2).sum())
            rec["update_rel_err"].append(math.sqrt(num / max(den, 1e-30)))
        if save_to:
            # phase 28 (a) holds its two processes' stages to these weights
            import torch
            os.makedirs(os.path.dirname(save_to), exist_ok=True)
            torch.save({n: p._data.detach().cpu()
                        for n, p in pl.named_parameters()}, save_to)
        if FLEET_DEV == "cuda":
            x, y = batches[-1]
            prof = profile_steps(lambda: model.train_batch([x], [y]), 1)
            rec["kernels_per_step"] = prof["kernels_per_step"]
    finally:
        denv.set_mesh(prev)
    rec["loss_rel_err"] = [abs(a - b) / abs(b) for a, b in
                           zip(rec["losses"], rec["ref_losses"])]
    rec["stats"] = {k: v for k, v in model._pp_step.stats.items()}
    L = cfg.num_hidden_layers
    log(f"fleet ernie-3.0-base pp2 PipelineLayer (one controller, B="
        f"{FLEET_PP_B}, S={FLEET_PP_S}, f32, SGD {FLEET_PP_LR}, microbatches "
        f"{FLEET_PP_M}, {rec['stats']['schedule']} over "
        f"{rec['stats']['ticks']} ticks, {rec['stats']['slots']} slots): "
        f"losses {[round(v, 6) for v in rec['losses']]} vs unpipelined "
        f"{[round(v, 6) for v in rec['ref_losses']]}, loss rel err "
        f"{max(rec['loss_rel_err']):.3g}, update rel err "
        f"{max(rec['update_rel_err']):.3g}; step ms "
        f"{[round(v, 1) for v in rec['step_ms']]} vs unpipelined "
        f"{[round(v, 1) for v in rec['ref_step_ms']]}; flash fwd/dq/dkv a "
        f"step {rec['flash_launches'][-1]} vs unpipelined "
        f"{rec['ref_flash'][-1]}; kernels a step {rec['kernels_per_step']} "
        f"[{smi}]")
    if max(rec["loss_rel_err"]) > FLEET_PP_LOSS_RTOL or \
            max(rec["update_rel_err"]) > FLEET_PP_UPDATE_RTOL or \
            not all(np.isfinite(rec["losses"])):
        raise AssertionError(
            f"phase 27 (a): pipelined losses {rec['losses']} vs "
            f"{rec['ref_losses']} (limit {FLEET_PP_LOSS_RTOL}); update rel "
            f"err {rec['update_rel_err']} (limit {FLEET_PP_UPDATE_RTOL})")
    fw, dq, dkv = rec["flash_launches"][-1]
    if dq != FLEET_PP_M * L or dkv != FLEET_PP_M * L or fw <= FLEET_PP_M * L:
        raise AssertionError(f"phase 27 (a): flash launches "
                             f"{rec['flash_launches']}, want dq = dkv = "
                             f"{FLEET_PP_M * L} and more forwards")
    return rec


def _mp_ernie(pt, cfg, mp_layers):
    """Phase 27 (b)'s network: TinyErnie's structure (tests/
    test_hapi_hybrid.py:29-55) at ERNIE-3.0-Base's widths, the vocab
    through VocabParallelEmbedding and a vocab-parallel head."""
    nn = pt.nn
    M = mp_layers

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.ln = nn.LayerNorm(cfg["hidden"])
            self.fc1 = M.ColumnParallelLinear(cfg["hidden"], cfg["ffn"],
                                              gather_output=False)
            self.act = nn.GELU()
            self.fc2 = M.RowParallelLinear(cfg["ffn"], cfg["hidden"],
                                           input_is_parallel=True)

        def forward(self, x):
            return x + self.fc2(self.act(self.fc1(self.ln(x))))

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.emb = M.VocabParallelEmbedding(cfg["vocab"], cfg["hidden"])
            self.blocks = nn.LayerList([Block() for _ in
                                        range(cfg["blocks"])])
            self.head = M.ColumnParallelLinear(cfg["hidden"], cfg["vocab"],
                                               gather_output=False)

        def forward(self, ids):
            h = self.emb(ids)
            for b in self.blocks:
                h = b(h)
            return self.head(h)
    return Net()


def _gather_full(net, n):
    """{name: the whole parameter} of an mp network whose marked
    parameters hold this process's rows (an all_gather each)."""
    import torch
    import torch.distributed as tdist
    out = {}
    for name, p in net.named_parameters():
        loc = getattr(p, "_mp_local", None)
        d = p._data.detach()
        if loc is None:
            out[name] = d.clone()
            continue
        c = d.contiguous().cpu()
        parts = [torch.empty_like(c) for _ in range(n)]
        tdist.all_gather(parts, c, group=loc[2])
        out[name] = torch.cat(parts, p.split_axis).to(d.device)
    return out


class _CommTimer:
    """Times the torch.distributed collectives the mp layers call in a
    window (the card synchronized around each)."""

    def __init__(self, dev):
        import torch.distributed as tdist
        self.dev, self.ms, self.calls = dev, 0.0, 0
        self._saved = {}
        for name in ("all_reduce", "all_gather"):
            fn = getattr(tdist, name)
            self._saved[name] = fn

            def timed(*a, _fn=fn, **k):
                _sync(self.dev)
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **k)
                finally:
                    _sync(self.dev)
                    self.ms += (time.perf_counter() - t0) * 1e3
                    self.calls += 1
            setattr(tdist, name, timed)

    def close(self):
        import torch.distributed as tdist
        for name, fn in self._saved.items():
            setattr(tdist, name, fn)


def fleet_child_mp(pt, rec):
    """Phase 27 (b), in each rank: fleet.init(mp_degree=2), the mp network
    through distributed_model / distributed_optimizer and Model, each
    step held (in rank 0) to the one-process step from the same state."""
    import numpy as np
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.layers import mp_layers
    cfg = FLEET_MP
    me = pt.distributed.get_rank()
    s = fleet.DistributedStrategy()
    s.hybrid_configs["mp_degree"] = 2
    fleet.init(is_collective=True, strategy=s)
    pt.seed(271)
    net = _mp_ernie(pt, cfg, mp_layers)
    golden = _mp_ernie(pt, cfg, mp_layers) if me == 0 else None
    net = fleet.distributed_model(net)
    opt = fleet.distributed_optimizer(pt.optimizer.SGD(
        FLEET_MP_LR, parameters=net.parameters()))
    pce = mp_layers.ParallelCrossEntropy()
    model = pt.Model(net)
    model.prepare(opt, lambda logits, labels: pce(logits, labels).mean())
    if golden is not None:
        # the one-process step: the plain layers and loss, eagerly (a
        # Model would take the mp route of the installed mesh)
        g_opt = pt.optimizer.SGD(FLEET_MP_LR, parameters=golden.parameters())
        g_loss = _mlm_loss(pt)
    rng = np.random.RandomState(272)
    shape = (cfg["B"], cfg["S"])
    out = {"losses": [], "one_process_losses": [], "update_rel_err": [],
           "step_ms": [], "comm_ms": [], "comm_calls": []}
    for _ in range(FLEET_MP_STEPS):
        x = rng.randint(0, cfg["vocab"], shape)
        y = rng.randint(0, cfg["vocab"], shape)
        full = _gather_full(net, 2)
        if golden is not None:
            golden.set_state_dict({k[len("_layers."):]: v
                                   for k, v in full.items()})
            loss = g_loss(golden(pt.to_tensor(x)), pt.to_tensor(y))
            loss.backward()
            g_opt.step()
            g_opt.clear_grad()
            out["one_process_losses"].append(float(loss))
        timer = _CommTimer(FLEET_DEV)
        _sync()
        t0 = time.perf_counter()
        try:
            out["losses"].append(model.train_batch([x], [y])[0][0])
        finally:
            timer.close()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["comm_ms"].append(timer.ms)
        out["comm_calls"].append(timer.calls)
        after = _gather_full(net, 2)
        if golden is not None:
            num = den = 0.0
            gp = dict(golden.named_parameters())
            for k, v in after.items():
                g = gp[k[len("_layers."):]]._data
                num += float(((v - g).double() ** 2).sum())
                den += float(((g - full[k]).double() ** 2).sum())
            out["update_rel_err"].append(math.sqrt(num / max(den, 1e-30)))
    fc1 = dict(net.named_parameters())["_layers.blocks.0.fc1.weight"]
    out["fc1_shape"] = list(fc1.shape)
    rec["mp"] = out
    del golden, net, model
    gc_cuda()


def fleet_child(out_dir):
    """A rank of phase 27 (b) and (c), started by the port's launcher
    (`--fleet-child DIR`); writes DIR/fleet_rank<r>.json."""
    import faulthandler
    faulthandler.dump_traceback_later(FLEET_CHILD_S, exit=True)
    sys.path.insert(0, ROOT)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch as pt
    pt.set_device(_place())
    pt.distributed.init_parallel_env(backend="gloo")
    me = pt.distributed.get_rank()
    rec = {"pid": os.getpid(), "rank": me,
           "world": pt.distributed.get_world_size()}
    fleet_child_mp(pt, rec)
    rec["gpt"] = {}
    for tag, plan, order in FLEET_GPT_PLANS:
        rec["gpt"][tag] = fleet_gpt_run(plan, order)
        gc_cuda()
    pt.distributed.barrier()
    with open(os.path.join(out_dir, f"fleet_rank{me}.json"), "w") as f:
        json.dump(rec, f)
    pt.distributed.destroy_process_group()
    return 0


def fleet_launch(out_dir, log_dir, child="--fleet-child", prefix="fleet",
                 what="phase 27", timeout=FLEET_CHILD_S):
    """Two ranks of `fleet_child` (or another `child` flag's) through
    `python -m paddle_tpu_torch.distributed.launch` on card 0, in a
    session of their own killed whole at the end: (records, seconds)."""
    import signal
    os.makedirs(out_dir, exist_ok=True)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "2", "--devices", "0", "--log_dir", log_dir,
           DIST_CHILD_SCRIPT, child, out_dir]
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, cwd=ROOT, env=env, start_new_session=True)
    try:
        rc = p.wait(timeout=timeout + 60)
    except subprocess.TimeoutExpired:
        rc = "timeout"
    finally:
        try:
            os.killpg(p.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        p.wait()
    if rc != 0:
        tails = []
        for r in range(2):
            path = os.path.join(log_dir, f"workerlog.{r}")
            if os.path.exists(path):
                with open(path) as f:
                    tails.append(f"--- rank {r} ---\n{f.read()[-3000:]}")
        raise AssertionError(f"{what}: the launch exited {rc}\n"
                             + "\n".join(tails))
    recs = []
    for r in range(2):
        with open(os.path.join(out_dir, f"{prefix}_rank{r}.json")) as f:
            recs.append(json.load(f))
    return recs, time.perf_counter() - t0


def fleet_phase(smi):
    """Phase 27: (a) ERNIE-3.0-Base as a pp2 PipelineLayer through
    Model.fit on the one card; (b) fleet's mp layers at ERNIE-3.0-Base's
    widths with mp=2 across two processes; (c) the `gpt_spmd` hybrid plans
    with pp, mp and sharding across two processes, held to the
    one-controller plans."""
    import paddle_tpu_torch as pt
    t_phase = time.perf_counter()
    work = os.path.join(ROOT, "build", "phase27")
    log_dir = os.path.join(ROOT, "chiprun_out", "phase27")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(log_dir, exist_ok=True)
    rec = {"card": smi}
    rec["a"] = fleet_ernie_pp(pt, smi, save_to=FLEET3_ONE)
    gc_cuda()
    # (c)'s one-controller plans, on the same seeds and batches
    ref = {}
    for tag, plan, _ in FLEET_GPT_PLANS:
        ref[tag] = fleet_gpt_run(plan)
        gc_cuda()
    ranks, launch_s = fleet_launch(work, log_dir)
    rec["launch_s"] = launch_s
    for r, rr in enumerate(ranks):
        if (rr["rank"], rr["world"]) != (r, 2):
            raise AssertionError(f"phase 27: rank {r} reads {rr}")
    # (b)
    b = ranks[0]["mp"]
    if ranks[1]["mp"]["losses"] != b["losses"]:
        raise AssertionError(f"phase 27 (b): the ranks' losses differ: "
                             f"{b['losses']} / {ranks[1]['mp']['losses']}")
    b_err = [abs(x - y) / abs(y) for x, y in
             zip(b["losses"], b["one_process_losses"])]
    rec["b"] = {"ranks": [rr["mp"] for rr in ranks], "loss_rel_err": b_err}
    share = [c / s for c, s in zip(b["comm_ms"], b["step_ms"])]
    log(f"fleet mp2 across 2 processes (gloo, one card; ERNIE-3.0-Base "
        f"widths: vocab {FLEET_MP['vocab']} through VocabParallelEmbedding, "
        f"{FLEET_MP['blocks']} Column->Row blocks of {FLEET_MP['hidden']}/"
        f"{FLEET_MP['ffn']}, ParallelCrossEntropy on the vocab-parallel "
        f"head; B={FLEET_MP['B']}, S={FLEET_MP['S']}, f32, SGD): losses "
        f"{[round(v, 6) for v in b['losses']]} vs one process "
        f"{[round(v, 6) for v in b['one_process_losses']]}, loss rel err "
        f"{max(b_err):.3g}, update rel err {max(b['update_rel_err']):.3g}; "
        f"step ms {[round(v, 1) for v in b['step_ms']]}, mp collectives "
        f"{[round(v, 1) for v in b['comm_ms']]} ms ({b['comm_calls'][-1]} "
        f"calls a step), share {[round(v, 3) for v in share]}; fc1 rows "
        f"{b['fc1_shape']} a process [{smi}]")
    if max(b_err) > FLEET_MP_LOSS_RTOL or \
            max(b["update_rel_err"]) > FLEET_MP_UPDATE_RTOL or \
            b["fc1_shape"] != [FLEET_MP["hidden"], FLEET_MP["ffn"] // 2]:
        raise AssertionError(f"phase 27 (b): {rec['b']}")
    # (c)
    rec["c"] = {}
    for tag, plan, order in FLEET_GPT_PLANS:
        one = ref[tag]
        got = [rr["gpt"][tag] for rr in ranks]
        leaves = {}
        for g in got:
            leaves.update(g["leaf_sha256"])
        loss_err = max(_rel_err(g["losses"], one["losses"]) for g in got)
        differ = sorted(k for k, v in one["leaf_sha256"].items()
                        if leaves.get(k) != v)
        if set(leaves) != set(one["leaf_sha256"]):
            differ.append(f"leaf sets {len(leaves)} vs "
                          f"{len(one['leaf_sha256'])}")
        rec["c"][tag] = {"ranks": got, "one_controller": one,
                         "loss_rel_err": loss_err, "leaves_differ": differ}
        log(f"fleet gpt_spmd {tag} across 2 processes ({order[0]} across; "
            f"GPT-125M widths, {2 * plan.get('pp', 1)} layers, bf16): losses "
            f"{got[0]['losses']} vs one controller {one['losses']}, loss "
            f"rel err {loss_err:.3g}, {len(leaves) - len(differ)} of "
            f"{len(one['leaf_sha256'])} rank leaves equal bit for bit; "
            f"step ms {[round(v, 1) for v in got[0]['step_ms']]}"
            f" / {[round(v, 1) for v in got[1]['step_ms']]} (ranks 0 / 1) vs "
            f"one controller {[round(v, 1) for v in one['step_ms']]}; flash "
            f"fwd/dq/dkv {got[0]['flash_launches']} / "
            f"{got[1]['flash_launches']} (one controller "
            f"{one['flash_launches']}) [{smi}]")
        if loss_err > 0 or differ:
            raise AssertionError(f"phase 27 (c) {tag}: not bit for bit the "
                                 f"one-controller plan: {rec['c'][tag]}")
        if any(min(g["flash_launches"]) <= 0 for g in got):
            raise AssertionError(f"phase 27 (c) {tag}: a process launched "
                                 f"no flash kernel: {rec['c'][tag]}")
    shutil.rmtree(work, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"phase 27 took {rec['seconds']:.1f} s [{smi}]")
    return rec


def fleet_launches(rec, which):
    """Phase 27's flash launches of kernel `which` ("fwd", "dq", "dkv"):
    (a)'s pipelined steps and every process of (c)."""
    i = ("fwd", "dq", "dkv").index(which)
    return sum(f[i] for f in rec["a"]["flash_launches"]) + sum(
        r["flash_launches"][i] for c in rec["c"].values() for r in c["ranks"])


# ---------------------------------------------------------------------------
# Phase 28: fleet across processes (pp, sp, GPipe, vpp) on two processes
# ---------------------------------------------------------------------------

FLEET3_DIR = os.path.join(ROOT, "build", "phase28")
FLEET3_ONE = os.path.join(FLEET3_DIR, "ernie_one.pt")
# (b): GPT-125M's widths, 2 layers a stage (DIST_GPT's cut), bf16, one
# row a rank and microbatch; (tag, plan, the axis across processes)
FLEET3_GPT_PLANS = (
    ("sp2_ulysses_sp_cross", dict(sp=2, sp_mode="ulysses"), ("sp",)),
    ("sp2_ring_sp_cross", dict(sp=2, sp_mode="ring"), ("sp",)),
    ("pp2_gpipe_pp_cross", dict(pp=2, microbatches=2, schedule="gpipe"),
     ("pp",)),
    ("pp2_vpp2_pp_cross", dict(pp=2, microbatches=4, vpp=2), ("pp",)))
FLEET3_CHILD_S = 600
# (a): the same weights, batches and schedule as phase 27 (a)'s one
# controller; only the tied embedding's gradient is added across the two
# processes (its two stages' sums, added in stage order in both runs)
FLEET3_PP_LOSS_RTOL = 1e-6
FLEET3_PP_UPDATE_RTOL = 1e-6


def fleet3_ernie_pp(pt, rec):
    """Phase 28 (a), in each rank: phase 27 (a)'s ERNIE-3.0-Base pp2
    PipelineLayer through Model.fit, this process running one stage:
    losses, step ms, flash launches, and this stage's weights after the
    steps against the one controller's (FLEET3_ONE)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.distributed import env as denv
    from paddle_tpu_torch.distributed.fleet.meta_parallel import PipelineLayer
    from paddle_tpu_torch.text.models import ernie as te
    cfg = te.ernie_3_base_config(**FLEET_ERNIE)
    loss_fn = _mlm_loss(pt)
    pt.seed(27)
    pl = PipelineLayer(te.ernie_pipeline_descs(cfg, loss_fn=loss_fn),
                       num_stages=2, loss_fn=loss_fn)
    before = {n: p._data.detach().clone() for n, p in pl.named_parameters()}
    mesh = denv.build_mesh({"pp": 2}, order=("pp",))
    model = pt.Model(pl)
    model.prepare(pt.optimizer.SGD(FLEET_PP_LR, parameters=pl.parameters()),
                  None, strategy={"microbatches": FLEET_PP_M})
    rng = np.random.RandomState(27)
    shape = (FLEET_PP_B, FLEET_PP_S)
    batches = [(rng.randint(0, cfg.vocab_size, shape),
                rng.randint(0, cfg.vocab_size, shape))
               for _ in range(FLEET_PP_STEPS)]
    out = {"losses": [], "step_ms": [], "flash_launches": []}
    for x, y in batches:
        c0 = _flash_counts()
        _sync()
        t0 = time.perf_counter()
        out["losses"].append(model.train_batch([x], [y])[0][0])
        _sync()
        out["step_ms"].append((time.perf_counter() - t0) * 1e3)
        out["flash_launches"].append([b - a for a, b in
                                      zip(c0, _flash_counts())])
    stage = mesh.coords[mesh.local_ranks[0]]["pp"]
    owned = set()
    for i, (layer, _) in enumerate(pl._built):
        if pl.stage_of_layer(i) == stage and hasattr(layer, "parameters"):
            ids = {id(p) for p in layer.parameters()}
            owned |= {n for n, p in pl.named_parameters() if id(p) in ids}
    one = torch.load(FLEET3_ONE)
    num = den = 0.0
    equal = 0
    for n in sorted(owned):
        a = dict(pl.named_parameters())[n]._data.detach().cpu()
        b = one[n]
        equal += int(torch.equal(a, b))
        num += float(((a - b).double() ** 2).sum())
        den += float(((b - before[n].cpu()).double() ** 2).sum())
    out.update(stage=stage, params=len(owned), params_equal=equal,
               update_rel_err=math.sqrt(num / max(den, 1e-30)),
               stats=dict(model._pp_step.stats))
    rec["a"] = out
    denv.set_mesh(None)


def fleet3_child(out_dir):
    """A rank of phase 28, started by the port's launcher (`--fleet3-child
    DIR`); writes DIR/fleet3_rank<r>.json."""
    import faulthandler
    faulthandler.dump_traceback_later(FLEET3_CHILD_S, exit=True)
    sys.path.insert(0, ROOT)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    import paddle_tpu_torch as pt
    pt.set_device(_place())
    pt.distributed.init_parallel_env(backend="gloo")
    me = pt.distributed.get_rank()
    rec = {"pid": os.getpid(), "rank": me,
           "world": pt.distributed.get_world_size()}
    fleet3_ernie_pp(pt, rec)
    gc_cuda()
    rec["gpt"] = {}
    for tag, plan, order in FLEET3_GPT_PLANS:
        rec["gpt"][tag] = fleet_gpt_run(plan, order)
        gc_cuda()
    pt.distributed.barrier()
    with open(os.path.join(out_dir, f"fleet3_rank{me}.json"), "w") as f:
        json.dump(rec, f)
    pt.distributed.destroy_process_group()
    return 0


def fleet3_phase(smi, fleet):
    """Phase 28: (a) phase 27 (a)'s ERNIE-3.0-Base pp2 PipelineLayer
    through Model.fit with one stage a process; (b) `gpt_spmd` at
    GPT-125M's widths with sp (Ulysses, ring) and pp (GPipe, vpp=2)
    across two processes, held to the one-controller plans; (c) phase 27
    (c)'s plan 3, whose sharding sums now run as partial sums and one
    all-reduce / reduce-scatter, against the step when those sums were
    gathers (PERF.md)."""
    t_phase = time.perf_counter()
    log_dir = os.path.join(ROOT, "chiprun_out", "phase28")
    work = os.path.join(FLEET3_DIR, "run")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(log_dir, exist_ok=True)
    rec = {"card": smi}
    ref = {}
    for tag, plan, _ in FLEET3_GPT_PLANS:
        ref[tag] = fleet_gpt_run(plan)
        gc_cuda()
    ranks, rec["launch_s"] = fleet_launch(work, log_dir, child="--fleet3-child",
                                          prefix="fleet3", what="phase 28",
                                          timeout=FLEET3_CHILD_S)
    for r, rr in enumerate(ranks):
        if (rr["rank"], rr["world"]) != (r, 2):
            raise AssertionError(f"phase 28: rank {r} reads {rr}")
    # (a)
    one = fleet["a"]
    a = [rr["a"] for rr in ranks]
    loss_err = max(_rel_err(x["losses"], one["losses"]) for x in a)
    upd = max(x["update_rel_err"] for x in a)
    rec["a"] = {"ranks": a, "loss_rel_err": loss_err,
                "update_rel_err": upd}
    log(f"fleet3 ernie-3.0-base pp2 PipelineLayer, one stage a process "
        f"(gloo, one card; B={FLEET_PP_B}, S={FLEET_PP_S}, f32, SGD "
        f"{FLEET_PP_LR}, microbatches {FLEET_PP_M}, "
        f"{a[0]['stats']['schedule']} over {a[0]['stats']['ticks']} ticks): "
        f"losses {a[0]['losses']} / {a[1]['losses']} (ranks 0 / 1) vs one "
        f"controller {one['losses']}, loss rel err {loss_err:.3g}; stage "
        f"weights equal bit for bit {a[0]['params_equal']}/"
        f"{a[0]['params']} and {a[1]['params_equal']}/{a[1]['params']}, "
        f"update rel err {upd:.3g}; step ms "
        f"{[round(v, 1) for v in a[0]['step_ms']]} / "
        f"{[round(v, 1) for v in a[1]['step_ms']]} vs one controller "
        f"{[round(v, 1) for v in one['step_ms']]}; flash fwd/dq/dkv a step "
        f"{a[0]['flash_launches'][-1]} / {a[1]['flash_launches'][-1]} vs "
        f"one controller {one['flash_launches'][-1]} [{smi}]")
    if loss_err > FLEET3_PP_LOSS_RTOL or upd > FLEET3_PP_UPDATE_RTOL or \
            a[0]["losses"] != a[1]["losses"] or \
            sorted(x["stage"] for x in a) != [0, 1]:
        raise AssertionError(f"phase 28 (a): {rec['a']}")
    if [sum(x) for x in zip(a[0]["flash_launches"][-1],
                            a[1]["flash_launches"][-1])] != \
            list(one["flash_launches"][-1]):
        raise AssertionError(f"phase 28 (a): flash launches {a} against "
                             f"the one controller's {one['flash_launches']}")
    # (b)
    rec["b"] = {}
    for tag, plan, order in FLEET3_GPT_PLANS:
        o = ref[tag]
        got = [rr["gpt"][tag] for rr in ranks]
        leaves = {}
        for g in got:
            leaves.update(g["leaf_sha256"])
        lerr = max(_rel_err(g["losses"], o["losses"]) for g in got)
        differ = sorted(k for k, v in o["leaf_sha256"].items()
                        if leaves.get(k) != v)
        if set(leaves) != set(o["leaf_sha256"]):
            differ.append(f"leaf sets {len(leaves)} vs "
                          f"{len(o['leaf_sha256'])}")
        rec["b"][tag] = {"ranks": got, "one_controller": o,
                         "loss_rel_err": lerr, "leaves_differ": differ}
        log(f"fleet3 gpt_spmd {tag} across 2 processes ({order[0]} across; "
            f"GPT-125M widths, {2 * plan.get('pp', 1)} layers, bf16, S="
            f"{FLEET_GPT['max_seq_len']}): losses {got[0]['losses']} vs one "
            f"controller {o['losses']}, loss rel err {lerr:.3g}, "
            f"{len(leaves) - len(differ)} of {len(o['leaf_sha256'])} rank "
            f"leaves equal bit for bit; step ms "
            f"{[round(v, 1) for v in got[0]['step_ms']]} / "
            f"{[round(v, 1) for v in got[1]['step_ms']]} (ranks 0 / 1) vs "
            f"one controller {[round(v, 1) for v in o['step_ms']]}; flash "
            f"fwd/dq/dkv a process {got[0]['flash_launches']} / "
            f"{got[1]['flash_launches']} (one controller "
            f"{o['flash_launches']}) [{smi}]")
        if lerr > 0 or differ:
            raise AssertionError(f"phase 28 (b) {tag}: not bit for bit the "
                                 f"one-controller plan: {rec['b'][tag]}")
        ring = plan.get("sp_mode") == "ring"
        if any((min(g["flash_launches"]) <= 0) != ring for g in got):
            raise AssertionError(f"phase 28 (b) {tag}: flash launches "
                                 f"{[g['flash_launches'] for g in got]}")
    # (c)
    tag = "dp4_sharding2_sharding_cross"
    c = fleet["c"][tag]
    steps = [g["step_ms"] for g in c["ranks"]]
    rec["c"] = {"step_ms": steps, "one_controller_ms": c["one_controller"][
        "step_ms"], "leaves_differ": c["leaves_differ"],
        "gathered_step_s": [5.1, 7.3]}
    log(f"fleet3 plan 3 {tag} (phase 27 (c)): sharding reduce-scatter and "
        f"data-axis means as partial sums and one collective across the "
        f"processes; step ms {[[round(v, 1) for v in x] for x in steps]} "
        f"(ranks 0 / 1) against 5100-7300 ms with gathered sums (PERF.md) "
        f"and one controller's {[round(v, 1) for v in c['one_controller']['step_ms']]}; "
        f"leaves' largest difference from the one-controller plan 0 (all "
        f"{len(c['one_controller']['leaf_sha256'])} SHA-256 equal) [{smi}]")
    shutil.rmtree(FLEET3_DIR, ignore_errors=True)
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"phase 28 took {rec['seconds']:.1f} s [{smi}]")
    return rec


def fleet3_launches(rec, which):
    """Phase 28's flash launches of kernel `which`: (a)'s and (b)'s, in
    both processes."""
    i = ("fwd", "dq", "dkv").index(which)
    return sum(f[i] for r in rec["a"]["ranks"]
               for f in r["flash_launches"]) + sum(
        r["flash_launches"][i] for b in rec["b"].values()
        for r in b["ranks"])


# ---------------------------------------------------------------------------
# Phase 29: the parameter-server tables and the device embedding cache
# ---------------------------------------------------------------------------

# a MemorySparseTable (adagrad, dim 64) of 2^21 keys held whole on the card
# for one pass; a Criteo-shaped batch: 26 categorical slots, 4096 rows, each
# slot's ids Zipf-skewed over its own 2^21 / 26 of the keys
PS_DIM, PS_KEYS, PS_SLOTS, PS_B, PS_STEPS = 64, 1 << 21, 26, 4096, 50
PS_LR, PS_ZIPF = 0.05, 1.2
PS_SEED = 29                    # `--seed N` sets it
PS_REL = 1e-6                   # the largest relative difference admitted
PS_DEV = "cuda"


def _ps_batches(seed):
    """PS_STEPS batches of (ids (B, slots) int64, labels (B,) f32), drawn
    in bulk; a row's label is the parity of its first slot's id, so the
    embeddings can learn it."""
    import numpy as np
    rng = np.random.RandomState(seed)
    per = PS_KEYS // PS_SLOTS
    z = rng.zipf(PS_ZIPF, (PS_STEPS, PS_B, PS_SLOTS)) - 1
    ids = ((z % per) + np.arange(PS_SLOTS, dtype=np.int64) * per).astype(
        np.int64)
    return ids, (ids[..., 0] % 2).astype(np.float32)


def _ps_head(seed):
    import torch
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(PS_SLOTS * PS_DIM, 1, generator=g) * 0.05).to(PS_DEV)


def _ps_step(rows, head, labels):
    """The fixed linear head's BCE loss over the concatenated slot rows:
    (loss, d loss / d rows)."""
    import torch
    rows = rows.detach().requires_grad_()
    logit = rows.reshape(rows.shape[0], -1) @ head
    loss = torch.nn.functional.binary_cross_entropy_with_logits(
        logit[:, 0], labels)
    g, = torch.autograd.grad(loss, rows)
    return loss, g


def ps_phase(smi, seed=PS_SEED):
    """Phase 29: (a) a DeviceEmbeddingCache holding a 2^21-key adagrad table
    (dim 64) on the card trains PS_STEPS Criteo-shaped steps, is flushed,
    and every row and its state is held to the same steps run against the
    host table directly; (b) one step's PULL / PUSH over two shard servers
    in child processes."""
    import numpy as np
    import torch
    from paddle_tpu_torch import native
    from paddle_tpu_torch.distributed import ps
    t_phase = time.perf_counter()
    rec = {"card": smi, "seed": seed}
    ids, labels = _ps_batches(seed)
    lab = torch.from_numpy(labels).to(PS_DEV)
    head = _ps_head(seed)
    keys = np.arange(PS_KEYS, dtype=np.int64)
    cached = native.SparseTable(PS_DIM, rule="adagrad", lr=PS_LR, seed=seed)
    host = native.SparseTable(PS_DIM, rule="adagrad", lr=PS_LR, seed=seed)
    t0 = time.perf_counter()
    cache = ps.DeviceEmbeddingCache(cached, device=PS_DEV).build_pass(keys)
    _sync(PS_DEV)
    rec["build_pass_s"] = time.perf_counter() - t0
    rec["device_bytes"] = (cache._values.numel() * 4 +
                           cache._state.numel() * 4)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)] \
        if PS_DEV == "cuda" else None
    # the same steps against the host table directly, in lockstep: a step
    # whose host rows equal the cache's has the cache's gradient and
    # merge; one whose rows differ computes its own
    look_ms, upd_ms, merge_ms, step_ms, losses = [], [], [], [], []
    host_losses, diverged = [], []
    for s in range(PS_STEPS):
        _sync(PS_DEV)
        t0 = time.perf_counter()
        sl = cache.slots(ids[s])
        if ev:
            ev[0].record()
        rows = cache.gather(sl).reshape(PS_B, PS_SLOTS, PS_DIM)
        if ev:
            ev[1].record()
        loss, g = _ps_step(rows, head, lab[s])
        t1 = time.perf_counter()
        slots, gm = cache.merge(ids[s], g)
        merge_ms.append((time.perf_counter() - t1) * 1e3)
        if ev:
            ev[2].record()
        cache.apply_merged(slots, gm)
        if ev:
            ev[3].record()
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if ev:
            look_ms.append(ev[0].elapsed_time(ev[1]))
            upd_ms.append(ev[2].elapsed_time(ev[3]))
        hrows = torch.from_numpy(host.pull(ids[s].reshape(-1))).to(
            PS_DEV).reshape(PS_B, PS_SLOTS, PS_DIM)
        if torch.equal(hrows, rows):
            host.push(cache.keys[slots.cpu().numpy()], gm.cpu().numpy())
            host_losses.append(float(loss))
        else:
            diverged.append(s)
            hloss, hg = _ps_step(hrows, head, lab[s])
            host.push(*ps.merge_by_key(ids[s], hg.cpu().numpy(), PS_DIM))
            host_losses.append(float(hloss))
    t0 = time.perf_counter()
    cache.flush()
    rec["flush_s"] = time.perf_counter() - t0
    del cache
    gc_cuda()
    a = np.concatenate(cached.pull_with_state(keys), 1)
    b = np.concatenate(host.pull_with_state(keys), 1)
    equal = bool(np.array_equal(a, b))
    rel = float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))
    touched = int(np.unique(ids).size)
    rec["a"] = {"losses": losses[::10], "host_losses": host_losses[::10],
                "bit_for_bit": equal, "max_rel_diff": rel,
                "steps_diverged": diverged,
                "rows": PS_KEYS, "rows_touched": touched,
                "lookup_ms": look_ms, "update_ms": upd_ms,
                "merge_ms": merge_ms, "step_ms": step_ms}
    med = statistics.median
    log(f"ps device cache: adagrad dim {PS_DIM}, {PS_KEYS} keys on the card "
        f"({rec['device_bytes'] / 2**20:.0f} MiB values + state), "
        f"{PS_STEPS} steps of {PS_B} x {PS_SLOTS} Zipf({PS_ZIPF}) ids "
        f"(seed {seed}; {touched} rows touched): build_pass "
        f"{rec['build_pass_s']:.3f} s, lookup {med(look_ms or [0]):.4f} ms "
        f"and update {med(upd_ms or [0]):.4f} ms on the device a step "
        f"(median; host merge {med(merge_ms):.1f} ms, step "
        f"{med(step_ms):.1f} ms), flush {rec['flush_s']:.3f} s; every row "
        f"and state against the host table: "
        f"{'bit for bit' if equal else f'max rel diff {rel:.3g}'} (host "
        f"rows apart from the cache's before {len(diverged)} of {PS_STEPS} "
        f"steps); loss "
        f"{losses[0]:.6f} -> {losses[-1]:.6f} (host {host_losses[-1]:.6f}) "
        f"[{smi}]")
    k = max(PS_STEPS // 10, 1)
    if not (equal or rel <= PS_REL) or not all(np.isfinite(losses)) or \
            np.mean(losses[-k:]) >= np.mean(losses[:k]):
        raise AssertionError(f"phase 29 (a): {rec['a']}")
    cached.destroy()
    host.destroy()
    rec["b"] = ps_shards(smi, ids[0], head, lab[0], seed)
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"phase 29 took {rec['seconds']:.1f} s [{smi}]")
    return rec


PS_SERVER = r"""
import os, sys
sys.path.insert(0, sys.argv[3])
from paddle_tpu_torch.distributed.ps import PSServer, SparseTable
srv = PSServer(SparseTable(int(sys.argv[4]), rule="adagrad",
                           lr=float(sys.argv[5]), seed=int(sys.argv[2])))
tmp = sys.argv[1] + ".tmp"
with open(tmp, "w") as f:
    f.write(srv.endpoint)
os.replace(tmp, sys.argv[1])
srv._stop.wait()
"""


def ps_shards(smi, ids, head, lab, seed):
    """Phase 29 (b): one training step's PULL and PUSH over a two-shard
    server pair in child processes (`DistributedSparseTable`), the rows
    held to local tables of the same seeds."""
    import numpy as np
    import signal
    import torch
    from paddle_tpu_torch import native
    from paddle_tpu_torch.distributed import ps
    work = os.path.join(ROOT, "build", "phase29")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs, eps = [], []
    try:
        for shard in range(2):
            ep = os.path.join(work, f"shard{shard}.ep")
            procs.append(subprocess.Popen(
                [sys.executable, "-c", PS_SERVER, ep, str(seed + shard),
                 ROOT, str(PS_DIM), str(PS_LR)], env=env,
                start_new_session=True))
            eps.append(ep)
        t_end = time.monotonic() + 120
        while not all(os.path.exists(e) for e in eps):
            if time.monotonic() > t_end or any(p.poll() is not None
                                               for p in procs):
                raise AssertionError("phase 29 (b): a shard server did not "
                                     "start")
            time.sleep(0.05)
        table = ps.DistributedSparseTable(
            [open(e).read().strip() for e in eps], PS_DIM)
        flat = ids.reshape(-1)
        uniq = np.unique(flat)
        t0 = time.perf_counter()
        rows = table.pull(flat)
        pull_ms = (time.perf_counter() - t0) * 1e3
        loss, g = _ps_step(torch.from_numpy(rows).to(PS_DEV).reshape(
            PS_B, PS_SLOTS, PS_DIM), head, lab)
        merged = ps.merge_by_key(flat, g.cpu().numpy(), PS_DIM)
        t0 = time.perf_counter()
        table.push(*merged)
        push_ms = (time.perf_counter() - t0) * 1e3
        after = table.pull(uniq)
        local = [native.SparseTable(PS_DIM, rule="adagrad", lr=PS_LR,
                                    seed=seed + s) for s in range(2)]
        own = ps.shard_for(merged[0], 2)
        for s in range(2):
            local[s].push(merged[0][own == s], merged[1][own == s])
        want = np.stack([local[o].pull(merged[0][i:i + 1])[0]
                         for i, o in enumerate(own)])
        equal = bool(np.array_equal(after, want))
        table.client.stop_servers()
        table.client.close()
    finally:
        for p in procs:
            try:
                p.wait(timeout=20)
            except subprocess.TimeoutExpired:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    out = {"pull_ms": pull_ms, "push_ms": push_ms, "ids": int(flat.size),
           "unique": int(uniq.size), "bit_for_bit": equal,
           "pull_bytes": int(flat.size * (8 + 4 * PS_DIM)),
           "push_bytes": int(uniq.size * (8 + 4 * PS_DIM))}
    log(f"ps shards: 2 server processes, one step's PULL of {flat.size} ids "
        f"{pull_ms:.1f} ms ({out['pull_bytes'] / 2**20:.1f} MiB), PUSH of "
        f"{uniq.size} merged rows {push_ms:.1f} ms "
        f"({out['push_bytes'] / 2**20:.1f} MiB); rows after the push "
        f"{'equal to' if equal else 'DIFFER from'} local tables of the same "
        f"seeds [{smi}]")
    if not equal:
        raise AssertionError(f"phase 29 (b): {out}")
    return out


# ---------------------------------------------------------------------------
# Phase 30: the rest of the surface (ROADMAP A.13h): the custom-op recipe's
# kernel, the sparse backbone, the fused transformer, quantised deploy, ASP
# ---------------------------------------------------------------------------

REST_SEED = 30
REST_DEV = "cuda"
REST_N = 1 << 26                # (a): the recipe kernel's elements
REST_A, REST_B = 1.7, -0.3      # (a): o = x * a + b
# (a): built by cpp_extension.load in phase 2's time (a thread beside
# build_all's nvccs), into a fresh directory so the build is real
REST_BUILD = os.path.join(ROOT, "build", "phase30_recipe")
_recipe_build = {}
# (b): the first blocks of SECOND's sparse middle encoder on KITTI
# (Yan et al. 2018; voxel grid z, y, x of 0.1 x 0.05 x 0.05 m over
# [-3, 1] x [-40, 40] x [0, 70.4] m): two generated sweeps of ~20,000
# active voxels, 4 input channels (x, y, z, reflectance)
REST_GRID = (41, 1600, 1408)
REST_SWEEPS = 2
REST_RINGS, REST_BOXES = 22, 18     # ~20,500 distinct voxels a sweep
# (b): the card's index_add_ sums each output row's terms with atomics in
# an order of their own; f32 sums of up to 27 * Cin products
SPARSE_TOL = 1e-4
# (c): GPT-1.3B's widths (text/models/gpt.py), f32, eval
REST_FMT = dict(embed_dim=2048, num_heads=16, dim_feedforward=8192,
                num_layers=24)
REST_FMT_B, REST_FMT_S, REST_DECODE = 4, 512, 16
FMT_REL = 1e-4                  # (c): max |kernel - plain| / RMS(plain)
# (d): phase 23's ResNet-50 shape; PTQ over 4 batches
REST_RN_B, REST_RN_BATCHES = 128, 4
REST_CHILD_S = 600
REST_CHILD = r"""
import json, sys, time
sys.modules["jax"] = None           # the child must not reach JAX
sys.modules["paddle_tpu"] = None
import numpy as np
import torch
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
from paddle_tpu_torch import inference
prefix, inp, out_path = sys.argv[1:4]
t0 = time.perf_counter()
pred = inference.create_predictor(inference.Config(prefix + ".pdmodel",
                                                   prefix + ".pdiparams"))
load_s = time.perf_counter() - t0
x = np.load(inp)
h = pred.get_input_handle(pred.get_input_names()[0])
h.copy_from_cpu(x)
pred.run()
got = pred.get_output_handle(pred.get_output_names()[0]).copy_to_cpu()
np.save(out_path, got)
print("REST_CHILD " + json.dumps({"load_to_ready_s": load_s}), flush=True)
"""


def start_recipe_build():
    """Phase 2: build the recipe's `.cu` with the port's
    `cpp_extension.load` in a thread, beside build_all's nvccs."""
    import threading

    def run():
        from paddle_tpu_torch.utils.cpp_extension import recipe
        t0 = time.perf_counter()
        try:
            recipe.build(build_directory=REST_BUILD)
            _recipe_build["s"] = time.perf_counter() - t0
        except BaseException as e:          # re-raised by phase 30 (a)
            _recipe_build["error"] = e
    shutil.rmtree(REST_BUILD, ignore_errors=True)
    th = threading.Thread(target=run, daemon=True)
    th.start()
    _recipe_build["thread"] = th


def rest_recipe(pt, smi):
    """Phase 30 (a): the recipe's hand-written kernel against its plain
    version at 2^26 elements in f32 and bf16 (bit for bit), its gradient,
    the op traced by to_static, and its time beside the bound and one
    PyTorch call."""
    import torch
    from paddle_tpu_torch.utils.cpp_extension import recipe
    _recipe_build["thread"].join()
    if "error" in _recipe_build:
        raise _recipe_build["error"]
    build_s = _recipe_build["s"]
    g = torch.Generator(device=REST_DEV).manual_seed(REST_SEED)
    x = torch.randn(REST_N, generator=g, device=REST_DEV)
    xb = x.to(torch.bfloat16)
    errs, equal = {}, {}
    for name, t in (("f32", x), ("bf16", xb), ("f32_unaligned", x[1:]),
                    ("bf16_unaligned", xb[3:])):
        got = recipe.scale_shift_raw(t, REST_A, REST_B)
        want = recipe.scale_shift_plain(t, REST_A, REST_B)
        torch.cuda.synchronize()
        equal[name] = bool(torch.equal(got, want))
        errs[name] = float((got.float() - want.float()).abs().max())
    flush_buf = torch.empty(64 * 1024 * 1024, device=REST_DEV)
    flush = lambda: _flush_l2(flush_buf)          # noqa: E731
    t = {}
    for name, t_in in (("f32", x), ("bf16", xb)):
        b_t = torch.tensor(REST_B, device=REST_DEV, dtype=t_in.dtype)
        t[name] = {
            "ms": time_ms(lambda: recipe.scale_shift_raw(t_in, REST_A,
                                                         REST_B), flush),
            "plain_ms": time_ms(lambda: recipe.scale_shift_plain(
                t_in, REST_A, REST_B), flush),
            # one PyTorch call: b + a * x in one elementwise launch
            "library_ms": time_ms(lambda: torch.add(b_t, t_in, alpha=REST_A),
                                  flush),
            # one read and one write an element; one multiply and one add
            # an element on the non-tensor-core f32 peak
            "bound_bytes_ms": 2 * t_in.numel() * t_in.element_size()
            / device_peaks("f32").hbm_bw * 1e3,
            "bound_ops_ms": 2 * t_in.numel()
            / device_peaks("f32").peak_flops * 1e3}
    for r in t.values():
        r["bound_ms"] = max(r["bound_bytes_ms"], r["bound_ops_ms"])
        r["bound_by"] = "bytes" if r["bound_bytes_ms"] >= r["bound_ops_ms"] \
            else "operations"
    del flush_buf
    # the recipe's path, counted from 0: the eager Tensor op and its
    # gradient, and the op inside a to_static program
    recipe.launches = 0
    xt = pt.to_tensor(x, stop_gradient=False)
    out = recipe.scale_shift(xt, REST_A, REST_B)
    out.sum().backward()

    @pt.jit.to_static
    def traced(v):
        return recipe.scale_shift(v, REST_A, REST_B)

    st = traced(pt.to_tensor(x))
    torch.cuda.synchronize()
    launches = recipe.launches
    want = recipe.scale_shift_plain(x, REST_A, REST_B)
    grad_ok = bool(torch.all(xt.grad._data == REST_A))
    path_ok = bool(torch.equal(out._data, want)) and \
        bool(torch.equal(st._data, want))
    (prog,) = traced.concrete_programs.values()
    nodes = sum("scale_shift" in str(n.target) for n in prog.graph.nodes)
    rec = {"build_s": build_s, "n": REST_N, "equal": equal,
           "max_abs_err": errs, "timing": t, "launches": launches,
           "grad_ok": grad_ok, "path_ok": path_ok, "traced_nodes": nodes,
           "library_call": "torch.add(b, x, alpha=a)"}
    log(f"rest (a) recipe scale_shift: cpp_extension.load built "
        f"scale_shift.cu in {build_s:.1f} s; {REST_N} elements, bit for bit "
        f"with x * a + b: {equal}; f32 {t['f32']['ms']:.4f} ms (plain "
        f"{t['f32']['plain_ms']:.4f}, torch.add(b, x, alpha=a) "
        f"{t['f32']['library_ms']:.4f}, bound {t['f32']['bound_ms']:.4f} ms "
        f"{t['f32']['bound_by']}), bf16 {t['bf16']['ms']:.4f} ms (plain "
        f"{t['bf16']['plain_ms']:.4f}, torch.add "
        f"{t['bf16']['library_ms']:.4f}, bound {t['bf16']['bound_ms']:.4f}); "
        f"recipe path launches {launches} (eager op + to_static program, "
        f"{nodes} op node), gradient g * a {grad_ok} [{smi}]")
    if not all(equal.values()) or not grad_ok or not path_ok or \
            launches != 2 or nodes != 1:
        raise AssertionError(f"phase 30 (a): {rec}")
    return rec


def lidar_voxels(seed):
    """LiDAR-like sweeps on SECOND's KITTI grid, generated from `seed`: the
    sensor at (y=800, x=0) looks down +x over a 90-degree field; REST_RINGS
    scan rings hit a ground plane at ranges growing by 10% a ring (points
    every 0.0016 rad, so near rings fill runs of adjacent voxels and far
    ones thin out), and REST_BOXES car-sized boxes (80 x 36 x 15 voxels,
    4 x 1.8 x 1.5 m) show a front and a side face to 5 scan lines each.
    Returns (indices (4, nnz) [b, z, y, x], features (nnz, 4): the
    normalised coordinates and a reflectance)."""
    import numpy as np
    rng = np.random.RandomState(seed)
    Z, Y, X = REST_GRID
    th = np.arange(-0.78, 0.78, 0.0016)
    sweeps = []
    for b in range(REST_SWEEPS):
        pts = []
        for k in range(REST_RINGS):
            r = 60 * 1.1 ** k
            x = r * np.cos(th)
            pts.append(np.stack([8 + 0.002 * x + rng.randn(len(th)) * 0.3,
                                 800 + r * np.sin(th), x], 1))
        for _ in range(REST_BOXES):
            cx, cy = rng.uniform(150, 1250), rng.uniform(250, 1314)
            side = cy if cy > 800 else cy + 36
            for line in range(5):
                z = 9 + 2.6 * line
                ys = np.arange(cy, cy + 36, 0.5)
                xs = np.arange(cx, cx + 80, 0.5)
                pts.append(np.stack([np.full_like(ys, z), ys,
                                     np.full_like(ys, cx)], 1))
                pts.append(np.stack([np.full_like(xs, z),
                                     np.full_like(xs, side), xs], 1))
        p = np.floor(np.concatenate(pts)).astype(np.int64)
        ok = (p[:, 0] >= 0) & (p[:, 0] < Z) & (p[:, 1] >= 0) & \
            (p[:, 1] < Y) & (p[:, 2] >= 0) & (p[:, 2] < X)
        vox = np.unique(p[ok], axis=0)
        vox = vox[rng.permutation(len(vox))]     # a sweep's own order
        sweeps.append(np.concatenate([np.full((len(vox), 1), b), vox], 1))
    idx = np.concatenate(sweeps).T.astype(np.int64)
    feats = np.concatenate([idx[1:].T / np.asarray(REST_GRID) * 2 - 1,
                            rng.rand(idx.shape[1], 1)], 1).astype(np.float32)
    return idx, feats


def rest_sparse(pt, smi):
    """Phase 30 (b): SECOND's first sparse blocks on the card: each
    layer's device rulebook index for index against the host plain
    rulebook, the values against the same Layers on the CPU."""
    import numpy as np
    import torch
    from paddle_tpu_torch.sparse.nn import conv as sconv
    idx, feats = lidar_voxels(REST_SEED)
    pt.seed(REST_SEED)
    specs = [("subm", 4, 16, 1), ("subm", 16, 16, 1), ("conv", 16, 32, 2),
             ("subm", 32, 32, 1)]
    layers = []
    for kind, cin, cout, stride in specs:
        cls = pt.sparse.nn.SubmConv3D if kind == "subm" else \
            pt.sparse.nn.Conv3D
        layers.append(cls(cin, cout, 3, stride=stride, padding=1))
    shape = [REST_SWEEPS, *REST_GRID, 4]
    xg = pt.sparse.SparseCooTensor(pt.to_tensor(idx), pt.to_tensor(feats),
                                   shape)
    pt.set_device("cpu")
    try:
        cpu_layers = []
        for (kind, cin, cout, stride), l in zip(specs, layers):
            cls = pt.sparse.nn.SubmConv3D if kind == "subm" else \
                pt.sparse.nn.Conv3D
            c = cls(cin, cout, 3, stride=stride, padding=1)
            c.set_state_dict({k: v.numpy() for k, v in
                              l.state_dict().items()})
            cpu_layers.append(c)
        xc = pt.sparse.SparseCooTensor(pt.to_tensor(idx),
                                       pt.to_tensor(feats), shape)
    finally:
        pt.set_device("gpu")
    rec = {"voxels": idx.shape[1], "layers": []}
    for (kind, cin, cout, stride), l, c in zip(specs, layers, cpu_layers):
        k3 = (3, 3, 3)
        s3, p3 = (stride,) * 3, (1, 1, 1)
        in_idx = xg.indices()._data
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev = sconv.rulebook(in_idx, xg.shape, k3, s3, p3, (1, 1, 1),
                             kind == "subm")
        torch.cuda.synchronize()
        dev_ms = (time.perf_counter() - t0) * 1e3
        t0 = time.perf_counter()
        host = sconv.rulebook_plain(in_idx.cpu().numpy(), xg.shape, k3, s3,
                                    p3, (1, 1, 1), kind == "subm")
        host_s = time.perf_counter() - t0
        same = np.array_equal(dev[0].cpu().numpy(), host[0]) and \
            tuple(dev[2]) == tuple(host[2]) and all(
                np.array_equal(g.cpu().numpy(), hg) and
                np.array_equal(s.cpu().numpy(), hs)
                for (g, s), (hg, hs) in zip(dev[1], host[1]))
        pairs = [int(len(hg)) for hg, _ in host[1]]
        y = pt.sparse.relu(l(xg))
        yc = pt.sparse.relu(c(xc))
        got, want = y.values().numpy(), yc.values().numpy()
        err = _max_err(got, want)
        ok = np.array_equal(y.indices().numpy(), yc.indices().numpy()) and \
            np.allclose(got, want, rtol=SPARSE_TOL, atol=SPARSE_TOL)
        r = {"kind": kind, "cin": cin, "cout": cout, "stride": stride,
             "in_sites": int(in_idx.shape[1]), "out_sites":
             int(y.indices().shape[1]), "pairs_per_offset": pairs,
             "rulebook_equal": bool(same), "device_rulebook_ms": dev_ms,
             "host_rulebook_s": host_s, "max_abs_err": err,
             "values_ok": bool(ok)}
        rec["layers"].append(r)
        log(f"rest (b) {kind} {cin}->{cout} stride {stride}: "
            f"{r['in_sites']} -> {r['out_sites']} sites, rulebook equal to "
            f"the host's {same} (device {dev_ms:.1f} ms, host loop "
            f"{host_s:.2f} s), pairs per offset {pairs}, values vs the CPU "
            f"max abs err {err:.3g} [{smi}]")
        if not same or not ok:
            raise AssertionError(f"phase 30 (b): {r}")
        xg, xc = y, yc

    def forward():
        h = pt.sparse.SparseCooTensor(pt.to_tensor(idx), pt.to_tensor(feats),
                                      shape)
        for l in layers:
            h = pt.sparse.relu(l(h))
        torch.cuda.synchronize()
        return h
    forward()
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        forward()
        ms.append((time.perf_counter() - t0) * 1e3)
    rec["forward_ms"] = sorted(ms)[1]
    rec["host_rulebook_s_total"] = sum(r["host_rulebook_s"]
                                       for r in rec["layers"])
    log(f"rest (b) SECOND blocks on {rec['voxels']} voxels in "
        f"{REST_SWEEPS} sweeps of the {REST_GRID} grid: device forward "
        f"(rulebooks included) {rec['forward_ms']:.1f} ms (median of 3), host rulebooks "
        f"{rec['host_rulebook_s_total']:.1f} s [{smi}]")
    return rec


def rest_fused_transformer(pt, smi):
    """Phase 30 (c): FusedMultiTransformer at GPT-1.3B's widths: a prefill
    through fresh caches on the flash kernel (24 launches, by the counter,
    the routes and the profiler), 16 decode steps on the plain route, both
    held to the same stack with every attention on the plain route."""
    import numpy as np
    import torch
    from paddle_tpu_torch.nn.functional import attention as ta
    from paddle_tpu_torch.ops import flash_attention as fa
    pt.seed(REST_SEED)
    fmt = pt.incubate.nn.FusedMultiTransformer(**REST_FMT)
    fmt.eval()
    L = REST_FMT["num_layers"]
    B, S, E = REST_FMT_B, REST_FMT_S, REST_FMT["embed_dim"]
    g = torch.Generator(device=REST_DEV).manual_seed(REST_SEED)
    x = pt.to_tensor(torch.randn(B, S, E, generator=g, device=REST_DEV))
    steps = [pt.to_tensor(torch.randn(B, 1, E, generator=g,
                                      device=REST_DEV))
             for _ in range(REST_DECODE)]
    mask = pt.to_tensor(torch.triu(torch.full((S, S), -1e9,
                                              device=REST_DEV), 1))

    def run():
        with torch.no_grad():
            out, caches = fmt(x, attn_mask=mask, caches=[None] * L)
            outs = [out.numpy()]
            for st in steps:
                o, caches = fmt(st, caches=caches)
                outs.append(o.numpy())
        return outs

    def prefill():
        with torch.no_grad():
            out, _ = fmt(x, attn_mask=mask, caches=[None] * L)
        torch.cuda.synchronize()
        return out
    fa.launches_fwd = 0
    for k in ta.sdpa_routes:
        ta.sdpa_routes[k] = 0
    with card_profile(cpu=False) as prof:
        prefill()
    launches = fa.launches_fwd
    routes = dict(ta.sdpa_routes)
    prof_launches = sum(e.count for e in device_kernels(prof)
                        if "flash_fwd" in e.key)
    ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        prefill()
        ms.append((time.perf_counter() - t0) * 1e3)
    fa.launches_fwd = 0
    kern = run()
    run_launches = fa.launches_fwd
    with torch.no_grad():
        _, caches = fmt(x, attn_mask=mask, caches=[None] * L)
        dms = []
        for st in steps:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, caches = fmt(st, caches=caches)
            torch.cuda.synchronize()
            dms.append((time.perf_counter() - t0) * 1e3)
    route = ta.sdpa_route
    ta.sdpa_route = lambda q, k, d: "plain"
    try:
        plain = run()
    finally:
        ta.sdpa_route = route
    rel = [float(np.abs(a - b).max() / np.sqrt(np.mean(np.square(b))))
           for a, b in zip(kern, plain)]
    finite = all(np.isfinite(a).all() for a in kern)
    rec = {"prefill_launches": launches, "routes": routes,
           "profiler_flash_fwd": prof_launches,
           "run_launches": run_launches, "prefill_ms": sorted(ms)[1],
           "decode_step_ms": sorted(dms)[len(dms) // 2],
           "max_rel_err": max(rel), "rel_err_prefill": rel[0],
           "rel_err_decode_max": max(rel[1:])}
    log(f"rest (c) FusedMultiTransformer GPT-1.3B widths ({L} layers, "
        f"embed {E}, {REST_FMT['num_heads']} heads, ffn "
        f"{REST_FMT['dim_feedforward']}, f32 eval): prefill B={B} S={S} "
        f"{rec['prefill_ms']:.1f} ms with {launches} flash forward launches "
        f"(profiler {prof_launches}, routes {routes}); decode step "
        f"{rec['decode_step_ms']:.2f} ms (median of {REST_DECODE}); max "
        f"|kernel - plain| / RMS {rec['rel_err_prefill']:.2e} prefill, "
        f"{rec['rel_err_decode_max']:.2e} decode [{smi}]")
    if launches != L or prof_launches != L or routes["kernel"] != L or \
            routes["plain"] != 0 or run_launches != L or \
            max(rel) > FMT_REL or not finite:
        raise AssertionError(f"phase 30 (c): {rec}")
    return rec


def rest_quant_deploy(pt, smi, out_dir):
    """Phase 30 (d): ResNet-50 through fuse_conv_bn and PTQ (KL,
    per-channel weights), jit.save, the Predictor in a fresh process held
    to the in-process model; then BERT-base pruned 2:4 by incubate.asp and
    one decorated optimizer step on the card."""
    import numpy as np
    import torch
    from paddle_tpu_torch.static import InputSpec
    pt.seed(REST_SEED)
    net = pt.vision.models.resnet50(num_classes=10)
    rng = np.random.RandomState(REST_SEED)

    def batch():
        return pt.to_tensor(rng.rand(REST_RN_B, 3, 32, 32).astype("float32"))
    net.train()
    with torch.no_grad():
        for _ in range(2):                   # BatchNorm running statistics
            net(batch())
    net.eval()
    x = batch()
    with torch.no_grad():
        before = net(x).numpy()
        pt.quantization.fuse_conv_bn(net)
        fused = net(x).numpy()
    t0 = time.perf_counter()
    with torch.no_grad():
        net, scales = pt.quantization.PostTrainingQuantization(
            net, algo="KL").quantize([(batch(),)
                                      for _ in range(REST_RN_BATCHES)],
                                     batch_nums=REST_RN_BATCHES)
    ptq_s = time.perf_counter() - t0
    with torch.no_grad():
        want = net(x).numpy()
    prefix = os.path.join(out_dir, "resnet50_q")
    t0 = time.perf_counter()
    pt.jit.save(net, prefix, input_spec=[InputSpec([None, 3, 32, 32],
                                                   "float32", "x")])
    save_s = time.perf_counter() - t0
    np.save(os.path.join(out_dir, "x.npy"), x.numpy())
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", REST_CHILD, prefix,
                        os.path.join(out_dir, "x.npy"),
                        os.path.join(out_dir, "served.npy")], env=env,
                       capture_output=True, text=True, timeout=REST_CHILD_S)
    child_s = time.perf_counter() - t0
    with open(os.path.join(ROOT, "chiprun_out", "phase30_child.log"),
              "w") as f:
        f.write(p.stdout + "\n--- stderr ---\n" + p.stderr)
    if p.returncode != 0:
        raise AssertionError(f"phase 30 (d): the Predictor process failed "
                             f"({p.returncode}): {p.stderr[-2000:]}")
    child = json.loads(next(l for l in p.stdout.splitlines()
                            if l.startswith("REST_CHILD "))[11:])
    served = np.load(os.path.join(out_dir, "served.npy"))
    err = _max_err(served, want)
    rec = {"layers_quantized": len(scales), "ptq_s": ptq_s,
           "save_s": save_s, "child_s": child_s,
           "child_load_to_ready_s": child["load_to_ready_s"],
           "served_max_abs_err": err,
           "fuse_max_abs_err": _max_err(fused, before),
           "quant_vs_float_max_abs_err": _max_err(want, before)}
    log(f"rest (d) ResNet-50 B={REST_RN_B} 3x32x32: fuse_conv_bn (max abs "
        f"change {rec['fuse_max_abs_err']:.3g}), PTQ KL per-channel over "
        f"{REST_RN_BATCHES} batches of {len(scales)} layers in {ptq_s:.1f} s "
        f"(quantised vs float max abs {rec['quant_vs_float_max_abs_err']:.3g})"
        f", jit.save {save_s:.1f} s, Predictor child {child_s:.1f} s (load "
        f"to ready {child['load_to_ready_s']:.2f} s): served vs in-process "
        f"max abs err {err:.3g} [{smi}]")
    # folding BatchNorm into the convolution changes only rounding
    fuse_rel = rec["fuse_max_abs_err"] / float(np.sqrt(np.mean(before ** 2)))
    rec["fuse_rel_err"] = fuse_rel
    if not np.allclose(served, want, rtol=1e-5, atol=1e-5) or \
            not np.isfinite(served).all() or not scales or fuse_rel > 1e-4:
        raise AssertionError(f"phase 30 (d): {rec}")
    del net
    gc_cuda()

    from paddle_tpu_torch.text.models import Bert, BertConfig
    asp = pt.incubate.asp
    pt.seed(REST_SEED)
    bert = Bert(BertConfig())
    linear = {f"{n}.weight" for n, l in bert.named_sublayers()
              if isinstance(l, pt.nn.Linear)}
    asp.reset_excluded_layers()
    asp.set_excluded_layers(param_names=[
        n for n, _ in bert.named_parameters() if n not in linear])
    t0 = time.perf_counter()
    pruned = asp.prune_model(bert)
    prune_s = time.perf_counter() - t0
    asp.reset_excluded_layers()
    opt = asp.decorate(pt.optimizer.AdamW(1e-3,
                                          parameters=bert.parameters()))
    ids = pt.to_tensor(rng.randint(0, 30000, (8, 128)).astype("int64"))
    first = next(iter(pruned))
    w = dict(bert.named_parameters())[first]
    before_w = w.numpy()
    seq, pooled = bert(ids)
    ((seq * seq).mean() + pooled.mean()).backward()
    opt.step()
    opt.clear_grad()
    torch.cuda.synchronize()
    params = dict(bert.named_parameters())
    kept = all(asp.check_sparsity(params[n].numpy()) for n in pruned)
    moved = not np.array_equal(before_w, w.numpy())
    dens = asp.calculate_density(w.numpy())
    rec["asp"] = {"pruned": len(pruned), "linear_weights": len(linear),
                  "prune_s": prune_s, "kept_2_4": kept,
                  "weights_moved": moved, "density": dens}
    log(f"rest (d) BERT-base ASP: {len(pruned)} of {len(linear)} Linear "
        f"weights pruned 2:4 in {prune_s:.1f} s; after one decorated AdamW "
        f"step on the card every one keeps 2:4: {kept} (density of "
        f"{first} {dens:.3f}, moved {moved}) [{smi}]")
    if not kept or not moved or len(pruned) != len(linear):
        raise AssertionError(f"phase 30 (d): {rec['asp']}")
    return rec


def rest_phase(smi):
    """Phase 30 (module docstring): parts a, b, c, d; each raises on
    failure."""
    import paddle_tpu_torch as pt
    t0 = time.perf_counter()
    pt.set_device("gpu")
    out_dir = os.path.join(ROOT, "build", "phase30")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    secs, out = {}, {}
    try:
        for part, fn in (("a", lambda: rest_recipe(pt, smi)),
                         ("b", lambda: rest_sparse(pt, smi)),
                         ("c", lambda: rest_fused_transformer(pt, smi)),
                         ("d", lambda: rest_quant_deploy(pt, smi, out_dir))):
            t1 = time.perf_counter()
            out[part] = fn()
            secs[part] = time.perf_counter() - t1
            gc_cuda()
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    out["seconds_by_part"] = secs
    log(f"phase 30 took {out['seconds']:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()) + f") [{smi}]")
    return out


def recipe_entry(rest):
    """The `kernels` line's row of the recipe kernel (f32 at 2^26)."""
    a = rest["a"]
    t = a["timing"]["f32"]
    return {"name": "scale_shift", "route": "cuda",
            "source": "paddle_tpu_torch/utils/cpp_extension/recipe/"
                      "scale_shift.cu",
            "replaces": "tests/test_custom_op_recipe.py:47",
            "launches": a["launches"],
            "max_abs_err": max(a["max_abs_err"].values()),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]}


# ---------------------------------------------------------------------------
# Phase 31: incubate.autotune (ROADMAP A.8): the paged and flash kernels
# take their tiles at launch from the tile table
# ---------------------------------------------------------------------------
PHASE4_LENGTHS = [1, 5, 17, 64, 100, 200, 255, 512,
                  257, 290, 300, 333, 400, 480, 600, 700]
PHASE4_ENGINE = dict(slots=8, max_len=1024, block_size=16,
                     attention_impl="kernel")
TILE_BS, TILE_NB = 16, 64   # the engines' block size and table entries
# the paged geometries the sweep tunes (heads, head dim) and each one's
# launch mix (PERF.md §6): phase 4's engine, phase 24 (b)'s GPT-1.3B
TUNE_PAGED = (
    ("gpt125m", 12, 64, {"decode_f32": 744, "decode_int8": 372,
                         "window_f32": 744, "tile_f32": 384}),
    ("gpt1p3b", 16, 128, {"decode_f32": 1488, "decode_int8": 1488,
                          "tile_f32": 384, "tile_int8": 384}),
)
# the flash geometries the sweep tunes: phase 8's step, phase 22 (e)'s
# masked encoder with dropout
TUNE_FLASH = (
    ("train350m", dict(B=8, H=16, Hk=16, S=1024, D=64), "bf16", True,
     False, 0.0),
    ("nn_masked", dict(B=8, H=12, Hk=12, S=512, D=64), "bf16", False,
     True, 0.1),
)
TUNE_ROUNDS = 3             # each round: default, candidate, default, ...
TUNE_OUT = os.path.join(ROOT, "chiprun_out", "flash_blocks_tuned.json")
TILE_TIMED_PAIRS = 3        # (c), (d): alternated pairs, table on / off
# (a): the new flash build's cases: 16-bit types at D 64 and 128, the plain
# and the mask/dropout build, S that no tile divides. The float16 cases
# are phase 24 (c)'s size (B=2, H=8, S near 1024), where the bf16-rounding
# control fails the float16 limit as it must (at S=777, B=1 it passed)
TILE_FLASH_CASES = [
    ("bf16_D64_S1000", dict(B=1, H=8, Hk=8, S=1000, D=64), "bf16", True,
     False, 0.0),
    ("bf16_D64_mask_S200", dict(B=2, H=4, Hk=4, S=200, D=64), "bf16",
     False, True, 0.0),
    ("bf16_D128_nc_S1000", dict(B=1, H=8, Hk=8, S=1000, D=128), "bf16",
     False, False, 0.0),
    ("bf16_D128_dropout_S333", dict(B=2, H=4, Hk=4, S=333, D=128), "bf16",
     True, False, 0.1),
    ("f16_D64_S1000", dict(B=2, H=8, Hk=8, S=1000, D=64), "f16", True,
     False, 0.0),
    ("f16_D64_mask_S1000", dict(B=2, H=8, Hk=8, S=1000, D=64), "f16",
     False, True, 0.0),
    ("f16_D128_S1000", dict(B=2, H=8, Hk=8, S=1000, D=128), "f16", True,
     False, 0.0),
    ("f16_D128_dropout_S1000", dict(B=2, H=8, Hk=8, S=1000, D=128), "f16",
     True, False, 0.1),
    ("bf16_D64_gqa_S200", dict(B=1, H=16, Hk=4, S=200, D=64), "bf16", True,
     False, 0.0),
]
TILE_TOUR_TOKENS = 8        # (e): new tokens a request on each build's path
TILE_TRAIN = dict(TRAIN_350M, layers=2)     # (e): the flash builds' path


def paged_key(H, D, bs=TILE_BS, nb=TILE_NB):
    return ("paged", "cuda", H, nb * bs, D, bs)


def flash_key(H, S, D, causal):
    return ("cuda", H, S, D, bool(causal))


class tile_table:
    """In-process entries of the tile table, {key: pair}, for a block (a
    pair of None removes the key's entry); the earlier entries are back
    after it."""

    def __init__(self, entries):
        self.entries = entries

    def __enter__(self):
        from paddle_tpu_torch.incubate import autotune as at
        self.saved = {k: at._block_cache.get(k) for k in self.entries}
        for k, v in self.entries.items():
            if v is None:
                at._block_cache.pop(k, None)
            else:
                at._block_cache[k] = tuple(v)

    def __exit__(self, *exc):
        from paddle_tpu_torch.incubate import autotune as at
        for k, v in self.saved.items():
            if v is None:
                at._block_cache.pop(k, None)
            else:
                at._block_cache[k] = v


def tuning(enable):
    """Set `kernel.enable` of the tile table; returns the earlier value."""
    from paddle_tpu_torch.incubate import autotune as at
    was = at.kernel_tuning_enabled()
    at.set_config({"kernel": {"enable": bool(enable)}})
    return was


def build_delta(before, after):
    return {b: n - before.get(b, 0) for b, n in after.items()
            if n != before.get(b, 0)}


def new_paged_pairs():
    from paddle_tpu_torch.ops import paged_attention as pa
    default = (pa.SPLIT_KEYS[0], pa.CHUNK_KEYS[0])
    return [(s, c) for s in pa.SPLIT_KEYS for c in pa.CHUNK_KEYS
            if (s, c) != default]


def new_flash_pairs():
    """The pairs that select a flash build other than the defaults."""
    from paddle_tpu_torch.ops import flash_attention as fa
    return [p for p in fa.TUNE_PAIRS if p != fa.DEFAULT_PAIR]


def tile_paged_cases(split, chunk, rows):
    """(a): cases of the paged builds at (split, chunk) in every mode at
    head dims 32, 64 and 128: with `rows`, decode at key counts one below,
    at and one above each split edge and a pos = -1 slot, and T=5 windows
    across the first split edge; then prefill tiles of 100 rows (no
    multiple of the 64-row tile) across a split edge beside a pos = -1
    slot."""
    s = split
    out = []
    for D, H in ((32, 8), (64, 12), (128, 16)):
        for kind in ("f32", "bf16", "int8"):
            hd = dict(H=H, D=D)
            tag = f"s{split}c{chunk}_d{D}_{kind}"
            if rows:
                out += [
                    (f"{tag}_decode_edges",
                     dict(S=8, T=1, pos=[s - 2, s - 1, s, 2 * s - 2,
                                         2 * s - 1, 2 * s, 1023, -1], **hd),
                     kind),
                    (f"{tag}_window_T5",
                     dict(S=8, T=5, pos=[s - 5, s - 4, s - 3, s - 2, s - 1,
                                         2 * s - 2, -1, 1019], **hd), kind)]
            out.append((f"{tag}_tile_T100",
                        dict(S=3, T=100, pos=[-1, 0, s - 50], **hd), kind))
    return out


def tile_builds_paged(flush):
    """(a), paged: every new build against its plain version (phase 3's
    rules and tolerances), the table forcing its pair at each case's
    geometry; the D=64 f32 cases timed. Returns {pair: records}."""
    from paddle_tpu_torch.ops import paged_attention as pa
    out, seen = {}, {pa.SPLIT_KEYS[0]}
    for i, (split, chunk) in enumerate(new_paged_pairs()):
        # the decode and window builds of a new split run once, with its
        # first chunk
        cases = tile_paged_cases(split, chunk, split not in seen)
        seen.add(split)
        keys = {paged_key(c[1]["H"], c[1]["D"]): (split, chunk)
                for c in cases}
        timed = {n for n, c, kind in cases
                 if c["D"] == 64 and kind == "f32"}
        before = pa.build_counts()
        with tile_table(keys):
            recs = run_kernel_cases(flush, cases, seed=3100 + 100 * i,
                                    timed=timed)
        got = build_delta(before, pa.build_counts())
        for name, c, _ in cases:
            want = pa.build_of(c["T"], split, chunk)
            if got.get(want, 0) < 2:
                raise AssertionError(f"phase 31 (a) {name}: the table's "
                                     f"pair {(split, chunk)} did not run "
                                     f"build {want} ({got})")
        if any(b[1:] != (split, chunk)[:len(b) - 1] for b in got):
            raise AssertionError(f"phase 31 (a): builds {got} ran under "
                                 f"the pair {(split, chunk)}")
        out[(split, chunk)] = recs
    return out


def tile_builds_flash(flush):
    """(a), flash: the new build (the forward at (128, 64)) against its
    plain version (phase 7's rules and tolerances), the table forcing its
    pair, timed at the training shape. Returns {pair: (records,
    timing)}."""
    from paddle_tpu_torch.ops import flash_attention as fa
    out = {}
    train = FLASH_CASES[0]
    for j, pair in enumerate(new_flash_pairs()):
        recs, timing = [], None
        # numbered from 1: flash_case_check times its case 0 too
        for i, (name, shp, kind, causal, mask, rate) in \
                enumerate(TILE_FLASH_CASES + [train], 1):
            before = dict(fa.launches_by_build)
            with tile_table({flash_key(shp["H"], shp["S"], shp["D"],
                                       causal): pair}):
                rec, t = flash_case_check(
                    i, f"t31_{pair[0]}x{pair[1]}_{name}", shp, kind, causal,
                    mask, rate, flush, timed=name == train[0],
                    seed=3300 + 50 * j)
            ran = build_delta(before, fa.launches_by_build)
            new = [w for w in ("fwd", "dq") if pair in fa.BUILDS[w]]
            if any(ran.get((w, *pair), 0) < 2 for w in new):
                raise AssertionError(f"phase 31 (a) {name}: the pair "
                                     f"{pair} did not run the {new} "
                                     f"build(s): {ran}")
            rec["builds"] = {f"{w}:{m}x{n}": c for (w, m, n), c in
                             ran.items()}
            recs.append(rec)
            timing = timing or t
        out[pair] = (recs, timing)
    return out


def tile_poison(smi):
    """(b): a table whose entries are no build's pair ([0, -3] paged,
    [96, 96] flash) and a rotted JSON file, as the env-path cache and as
    the shipped table: every launch runs the default build, no raise."""
    import torch
    from paddle_tpu_torch.incubate import autotune as at
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    path = os.path.join(ROOT, "build", "phase31_table.json")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    c = paged_case(3150, 8, 1, [0, 15, 16, 17, 255, 511, 777, 1000])
    fc = flash_case(3151, B=1, H=16, Hk=16, S=1024, D=64, kind="bf16",
                    causal=True, mask=False, rate=0.0)
    q, k, v, do, meta = (fc[n] for n in ("q", "k", "v", "do", "meta"))
    poisoned = {json.dumps(list(paged_key(12, 64))): [0, -3],
                json.dumps(list(flash_key(16, 1024, 64, True))): [96, 96]}
    want_paged = {("decode", pa.SPLIT_KEYS[0]): 1}
    want_flash = {(w, *fa.BUILDS[w][0]): 1 for w in ("fwd", "dq", "dkv")}
    saved_env = os.environ.get(at._CACHE_ENV)
    saved_shipped = at._SHIPPED_PATH
    out = {}
    try:
        for label, text, shipped in (
                ("no build's pair, env file", json.dumps(poisoned), False),
                ("rotted env file", "{not json", False),
                ("rotted shipped file", "[1, 2", True)):
            with open(path, "w") as f:
                f.write(text)
            if shipped:
                at._SHIPPED_PATH = path
                os.environ.pop(at._CACHE_ENV, None)
            else:
                os.environ[at._CACHE_ENV] = path
            at._disk_cache.clear()
            at._disk_loaded = False
            pb, fb = pa.build_counts(), dict(fa.launches_by_build)
            pa.paged_attention(c["q"], c["k"], c["v"], c["tables"],
                               c["pos"])
            o, lse = fa.flash_fwd(q, k, v, None, meta)
            delta = (do.float() * o.float()).sum(-1)
            fa.flash_dq(q, k, v, do, lse, delta, None, meta)
            fa.flash_dkv(q, k, v, do, lse, delta, None, meta)
            torch.cuda.synchronize()
            got_p = build_delta(pb, pa.build_counts())
            got_f = build_delta(fb, fa.launches_by_build)
            if got_p != want_paged or got_f != want_flash:
                raise AssertionError(f"phase 31 (b) {label}: ran {got_p} "
                                     f"{got_f}, want the defaults "
                                     f"{want_paged} {want_flash}")
            out[label] = {"paged": {str(b): n for b, n in got_p.items()},
                          "flash": {str(b): n for b, n in got_f.items()}}
            log(f"tiles poisoned, {label}: paged {got_p}, flash {got_f}: "
                f"the defaults, no raise [{smi}]")
    finally:
        at._SHIPPED_PATH = saved_shipped
        if saved_env is None:
            os.environ.pop(at._CACHE_ENV, None)
        else:
            os.environ[at._CACHE_ENV] = saved_env
        at._disk_cache.clear()
        at._disk_loaded = False
        os.remove(path)
    return out


def tile_serving(model, prompts, want, smi):
    """(c): phase 4's server with the shipped table in force and with
    `kernel.enable` off (each engine captured under its setting): the 16
    requests' greedy streams equal (and equal phase 4's `want`, where
    given), then the decode step of 8 of them timed in alternated pairs."""
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import PagedGenerationEngine
    kw = dict(PHASE4_ENGINE, device="cuda")
    on = PagedGenerationEngine(model, **kw)
    precompile(on, "phase 31 table on")
    was = tuning(False)
    try:
        off = PagedGenerationEngine(model, **kw)
        precompile(off, "phase 31 table off")
    finally:
        tuning(was)
    pb = pa.build_counts()
    got_on, m_on, _ = serve(on, prompts, max_new=32)
    builds_on = build_delta(pb, pa.build_counts())
    was = tuning(False)
    try:
        pb = pa.build_counts()
        got_off, _, _ = serve(off, prompts, max_new=32)
        builds_off = build_delta(pb, pa.build_counts())
    finally:
        tuning(was)
    exact, compared, dropped = 0, 0, 0
    for i, (a, b) in enumerate(zip(got_on, got_off)):
        exact += a.tokens == b.tokens
        n, d = same_stream(model, prompts[i], a.tokens, b.tokens,
                           f"phase 31 (c) request {i}, table on vs off")
        compared, dropped = compared + n, dropped + d
    same4 = None
    if want is not None:
        same4 = 0
        for i, (a, w) in enumerate(zip(got_on, want)):
            same4 += a.tokens == w
            same_stream(model, prompts[i], a.tokens, w,
                        f"phase 31 (c) request {i} against phase 4")
    steps = {"on": [], "off": []}
    for _ in range(TILE_TIMED_PAIRS):
        steps["on"].append(serve(on, prompts[8:16], max_new=32)[1]
                           ["decode_step_ms"])
        was = tuning(False)
        try:
            steps["off"].append(serve(off, prompts[8:16], max_new=32)[1]
                                ["decode_step_ms"])
        finally:
            tuning(was)
    rec = {"streams_exact": exact, "streams_exact_phase4": same4,
           "requests": len(prompts),
           "compared_tokens": compared, "dropped_near_ties": dropped,
           "builds_on": {str(b): n for b, n in builds_on.items()},
           "builds_off": {str(b): n for b, n in builds_off.items()},
           "decode_step_ms": steps, "card": smi}
    log(f"tiles serving: {exact} of {len(prompts)} greedy streams equal "
        f"with the shipped table in force and with it off ({compared} "
        f"tokens compared, {dropped} dropped as near-ties); builds on "
        f"{builds_on}, off {builds_off}; decode step ms on "
        f"{[round(x, 4) for x in steps['on']]} off "
        f"{[round(x, 4) for x in steps['off']]} (alternated) [{smi}]")
    return rec


def tile_lookup_cost(smi):
    """(d): host µs of a flash forward call (B=8, H=16, S=1024, D=64 bf16,
    causal) with the table on and off, in alternated pairs, and of the two
    lookups alone."""
    from paddle_tpu_torch.incubate import autotune as at
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    c = flash_case(3160, B=8, H=16, Hk=16, S=1024, D=64, kind="bf16",
                   causal=True, mask=False, rate=0.0)
    q, k, v, meta = (c[n] for n in ("q", "k", "v", "meta"))

    def call():
        return fa.flash_fwd(q, k, v, None, meta)
    us = {"on": [], "off": []}
    for _ in range(TILE_TIMED_PAIRS):
        us["on"].append(host_us(call))
        was = tuning(False)
        try:
            us["off"].append(host_us(call))
        finally:
            tuning(was)
    n = 20000
    t0 = time.perf_counter()
    for _ in range(n):
        at.lookup_flash_blocks(8, 16, 1024, 64, True)
    flash_us = (time.perf_counter() - t0) / n * 1e6
    t0 = time.perf_counter()
    for _ in range(n):
        pa.tiles_for(12, 1024, 64, 16)
    paged_us = (time.perf_counter() - t0) / n * 1e6
    rec = {"flash_fwd_host_us": us, "lookup_flash_us": flash_us,
           "lookup_paged_us": paged_us, "card": smi}
    log(f"tiles lookup: flash forward host us a call, table on "
        f"{[round(x, 2) for x in us['on']]} off "
        f"{[round(x, 2) for x in us['off']]} (alternated); the lookups "
        f"alone {flash_us:.2f} us (flash), {paged_us:.2f} us (paged) "
        f"[{smi}]")
    return rec


def tile_tour(model, prompts, smi):
    """(e): each new build on a main path, counts set to 0 before it and
    read after it: phase 4's engine (8 requests) with the table at each new
    paged pair, phase 10's speculative engine at the wider split (the
    window kernel), and GPT-350M's widths at 2 layers through
    `make_train_step` (2 steps, B=8) at each new flash pair."""
    import numpy as np
    import torch
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.parallel import GPTSpmdConfig, make_train_step
    from paddle_tpu_torch.serving import (PagedGenerationEngine,
                                          SpeculativeEngine)
    out = {}
    for pair in new_paged_pairs():
        with tile_table({paged_key(12, 64): pair}):
            eng = PagedGenerationEngine(model, device="cuda",
                                        **PHASE4_ENGINE)
            precompile(eng, f"phase 31 (e) {pair}")
            pa.set_build_counts({})
            serve(eng, prompts[:8], max_new=TILE_TOUR_TOKENS)
            out[f"paged {pair[0]}x{pair[1]}"] = pa.build_counts()
            del eng
    wide = (pa.SPLIT_KEYS[1], pa.CHUNK_KEYS[0])
    with tile_table({paged_key(12, 64): wide}):
        eng = SpeculativeEngine(model, device="cuda", **SPEC)
        precompile(eng, "phase 31 (e) speculative")
        pa.set_build_counts({})
        serve(eng, prompts[8:12], max_new=TILE_TOUR_TOKENS)
        out[f"spec {wide[0]}x{wide[1]}"] = pa.build_counts()
        del eng
    cfg = GPTSpmdConfig(**TILE_TRAIN, param_dtype="bfloat16",
                        compute_dtype="bfloat16", remat=False)
    step_fn, init_fn = make_train_step(cfg, learning_rate=2e-4,
                                       device="cuda")
    params, state = init_fn(0)
    rng = np.random.RandomState(31)
    B, S = 8, cfg.max_seq_len
    toks = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).cuda()
    labs = torch.from_numpy(rng.randint(0, cfg.vocab_size, (B, S))).cuda()
    for pair in new_flash_pairs():
        with tile_table({flash_key(cfg.heads, S, cfg.hidden // cfg.heads,
                                   True): pair}):
            fa.launches_by_build.clear()
            for _ in range(2):
                loss, params, state = step_fn(params, state, toks, labs)
            torch.cuda.synchronize()
            out[f"train {pair[0]}x{pair[1]}"] = dict(fa.launches_by_build)
            if not math.isfinite(float(loss)):
                raise AssertionError(f"phase 31 (e): loss {loss} at {pair}")
    del step_fn, params, state
    for name, counts in out.items():
        log(f"tiles tour {name}: launches by build {counts} [{smi}]")
    return {k: {str(b): n for b, n in v.items()} for k, v in out.items()}


def tune_paged_calls(H, D, seed):
    """The sweep's paged calls at one geometry, by launch kind: decode over
    phase 3's ragged positions (f32, int8), a verify window (T=5) and the
    serving path's prefill tiles (S=1 T=32 from 0, S=1 T=256 after 256,
    S=2 T=512; f32, int8)."""
    from paddle_tpu_torch.ops.paged_attention import paged_attention
    ragged = [0, 15, 16, 17, 255, 511, 777, 1000]
    verify5 = [0, 12, 14, 255, 500, 777, 1000, 1019]
    tiles = [(1, 32, [0]), (1, 256, [256]), (2, 512, [0, 256])]
    shapes = {"decode_f32": [(8, 1, ragged, "f32")],
              "decode_int8": [(8, 1, ragged, "int8")],
              "window_f32": [(8, 5, verify5, "f32")],
              "tile_f32": [(S, T, p, "f32") for S, T, p in tiles],
              "tile_int8": [(S, T, p, "int8") for S, T, p in tiles]}
    out = {}
    for kind, cases in shapes.items():
        fns = []
        for i, (S, T, pos, dt) in enumerate(cases):
            c = paged_case(seed + 10 * len(out) + i, S, T, pos, H=H, D=D,
                           kind=dt)
            sc = dict(k_scale=c["ks"], v_scale=c["vs"]) if dt == "int8" \
                else {}
            fns.append(lambda c=c, sc=sc: paged_attention(
                c["q"], c["k"], c["v"], c["tables"], c["pos"], **sc))
        out[kind] = fns
    return out


def _median(xs):
    return statistics.median(xs)


def alternate(score, default, cands):
    """Scores of `default` and each candidate, timed default, candidate,
    default, candidate, ... for TUNE_ROUNDS rounds; returns {pair:
    [scores]}."""
    samples = {p: [] for p in [default] + list(cands)}
    for _ in range(TUNE_ROUNDS):
        for c in cands:
            samples[default].append(score(default))
            samples[c].append(score(c))
    return samples


def pick(samples, default):
    """The candidate with the least median score and whether it beats the
    default's median by more than the default's own spread."""
    d = samples[default]
    spread = max(d) - min(d)
    best = min((p for p in samples if p != default),
               key=lambda p: _median(samples[p]))
    gain = _median(d) - _median(samples[best])
    return best, gain > spread, {"default_median": _median(d),
                                 "default_spread": spread,
                                 "best_median": _median(samples[best]),
                                 "gain": gain}


def tune_sweep(flush, smi):
    """The sweep (`--tune-only`): each paged geometry of TUNE_PAGED scored
    by its launch mix (launches x ms over T=1, windows and tiles) at every
    pair, each flash geometry of TUNE_FLASH by forward + dQ + dK/dV ms at
    every pair of `TUNE_PAIRS`, default and candidates alternated; a
    winner that beats the default by more than the default's spread is
    committed (`commit_shipped_table`, backend "cuda") into TUNE_OUT, a
    copy of the shipped table."""
    from paddle_tpu_torch.incubate import autotune as at
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import paged_attention as pa
    rec = {"paged": {}, "flash": {}, "card": smi}
    commit = {"paged": {}, "flash": {}}
    default = (pa.SPLIT_KEYS[0], pa.CHUNK_KEYS[0])
    for gi, (name, H, D, mix) in enumerate(TUNE_PAGED):
        calls = tune_paged_calls(H, D, 3200 + 100 * gi)
        key = paged_key(H, D)
        by_kind = {}

        def score(pair):
            with tile_table({key: pair}):
                ms = {k: sum(time_ms(f, flush) for f in calls[k])
                      / len(calls[k]) for k in mix}
            by_kind.setdefault(pair, []).append(ms)
            return sum(mix[k] * ms[k] for k in mix)
        samples = alternate(score, default, new_paged_pairs())
        best, wins, stats = pick(samples, default)
        rec["paged"][name] = {
            "geometry": dict(H=H, D=D, block_size=TILE_BS,
                             padded_len=TILE_BS * TILE_NB),
            "mix": mix, "score_ms": {f"{p[0]}x{p[1]}": v
                                     for p, v in samples.items()},
            "ms_by_kind": {f"{p[0]}x{p[1]}": v for p, v in by_kind.items()},
            "best": list(best), "committed": wins, **stats}
        if wins:
            commit["paged"][(H, TILE_BS * TILE_NB, D, TILE_BS)] = best
        log(f"tune paged {name} (H={H} D={D}): launch-mix ms "
            + "  ".join(f"{p[0]}x{p[1]} " + "/".join(
                f"{x:.3f}" for x in v) for p, v in samples.items())
            + f"; best {best} {'committed' if wins else 'not committed'} "
            f"(gain {stats['gain']:.3f} ms against the default's spread "
            f"{stats['default_spread']:.3f}) [{smi}]")
    for gi, (name, shp, kind, causal, mask, rate) in enumerate(TUNE_FLASH):
        c = flash_case(3250 + gi, **shp, kind=kind, causal=causal,
                       mask=mask, rate=rate)
        q, k, v, do, mf, meta = (c[n] for n in ("q", "k", "v", "do",
                                                "mask", "meta"))
        o, lse = fa.fwd_plain(q, k, v, mf, meta)
        delta = (do.float() * o.float()).sum(-1)
        fns = {"fwd": lambda: fa.flash_fwd(q, k, v, mf, meta),
               "dq": lambda: fa.flash_dq(q, k, v, do, lse, delta, mf, meta),
               "dkv": lambda: fa.flash_dkv(q, k, v, do, lse, delta, mf,
                                           meta)}
        key = flash_key(shp["H"], shp["S"], shp["D"], causal)
        by_kernel = {}

        def score(pair):
            with tile_table({key: pair}):
                ms = {w: time_ms(f, flush) for w, f in fns.items()}
            by_kernel.setdefault(pair, []).append(ms)
            return sum(ms.values())
        samples = alternate(score, fa.DEFAULT_PAIR, new_flash_pairs())
        best, wins, stats = pick(samples, fa.DEFAULT_PAIR)
        rec["flash"][name] = {
            "geometry": dict(shp, kind=kind, causal=causal, mask=mask,
                             dropout=rate),
            "score_ms": {f"{p[0]}x{p[1]}": v for p, v in samples.items()},
            "ms_by_kernel": {f"{p[0]}x{p[1]}": v
                             for p, v in by_kernel.items()},
            "best": list(best), "committed": wins, **stats}
        if wins:
            commit["flash"][(shp["H"], shp["S"], shp["D"], causal)] = best
        log(f"tune flash {name}: fwd+dq+dkv ms "
            + "  ".join(f"{p[0]}x{p[1]} " + "/".join(
                f"{x:.4f}" for x in v) for p, v in samples.items())
            + f"; best {best} {'committed' if wins else 'not committed'} "
            f"(gain {stats['gain']:.4f} ms against the default's spread "
            f"{stats['default_spread']:.4f}) [{smi}]")
    os.makedirs(os.path.dirname(TUNE_OUT), exist_ok=True)
    shutil.copyfile(at._SHIPPED_PATH, TUNE_OUT)
    for kernel, entries in commit.items():
        if entries:
            at.commit_shipped_table(entries, backend="cuda", path=TUNE_OUT,
                                    kernel=kernel)
    rec["committed"] = {k: {str(g): list(p) for g, p in v.items()}
                        for k, v in commit.items()}
    log(f"tune: committed {rec['committed']} into {TUNE_OUT} (copy it over "
        "paddle_tpu_torch/ops/flash_blocks_tuned.json to ship it)")
    return rec


def tile_phase(smi, model=None, prompts=None, want=None, sweep=False):
    """Phase 31: (a) every new build against its plain version, (b) a
    poisoned table runs the defaults, (c) the shipped table in force on
    phase 4's server, (d) the lookup's host cost, (e) each new build on a
    main path; with `sweep`, the sweep (`tune_sweep`) first."""
    import torch
    from paddle_tpu_torch.text.models import gpt_125m
    t0 = time.perf_counter()
    flush_buf = torch.empty(64 * 1024 * 1024, device="cuda")

    def flush():
        _flush_l2(flush_buf)
    rec = {"card": smi}
    if sweep:
        rec["sweep"] = tune_sweep(flush, smi)
    rec["paged_builds"] = {f"{p[0]}x{p[1]}": r for p, r in
                           tile_builds_paged(flush).items()}
    flash = tile_builds_flash(flush)
    rec["flash_builds"] = {f"{p[0]}x{p[1]}": {"cases": r, "timing": t}
                           for p, (r, t) in flash.items()}
    del flush_buf
    rec["poison"] = tile_poison(smi)
    if model is None:
        model = gpt_125m(device="cuda", seed=0)
    if prompts is None:
        prompts = make_prompts(0, PHASE4_LENGTHS, shared_from=8,
                               vocab=model.cfg.vocab_size)
    rec["serving"] = tile_serving(model, prompts, want, smi)
    rec["lookup"] = tile_lookup_cost(smi)
    rec["tour"] = tile_tour(model, prompts, smi)
    rec["seconds"] = time.perf_counter() - t0
    log(f"phase 31 took {rec['seconds']:.1f} s [{smi}]")
    return rec


def tile_entries(tiles, tour_launches):
    """The `kernels` line's entries of the new builds: each one's timed
    case (the D=64 f32 decode, window and T=100 tile cases; the flash
    build at the training shape), the largest error over its f32 cases
    (paged) or its cases (flash, each at its dtype's tolerance), and its
    launches on the main paths of (e) and of the script."""
    from paddle_tpu_torch.ops import paged_attention as pa
    out = []
    src = "paddle_tpu_torch/csrc/paged_attention.cuh"
    rep = "paddle_tpu/ops/pallas/paged_attention.py:75"
    for pair, recs in tiles["paged_builds"].items():
        split, chunk = (int(x) for x in pair.split("x"))
        for kernel, T in (("decode", 1), ("window", 5), ("tile", 100)):
            mine = [r for r in recs if r["T"] == T and r["kind"] == "f32"]
            timed = [r for r in mine if "ms" in r]
            if not timed:
                continue
            build = pa.build_of(T, split, chunk)
            name = {"decode": "paged_attention", "window":
                    "paged_attention_window", "tile":
                    "paged_attention_prefill"}[kernel]
            t = timed[0]
            out.append({"name": f"{name}@{'x'.join(map(str, build[1:]))}",
                        "route": "cuda", "source": src, "replaces": rep,
                        "build": list(build),
                        "launches": tour_launches.get(str(build), 0),
                        "max_abs_err": max(r["max_abs_err"] for r in mine),
                        "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
    fsrc = "paddle_tpu_torch/csrc/flash_attention.cu"
    freps = {"fwd": ("flash_attention_fwd", ("o", "lse"),
                     "paddle_tpu/ops/pallas/flash_attention.py:70"),
             "dq": ("flash_attention_dq", ("dq",),
                    "paddle_tpu/ops/pallas/flash_attention.py:234")}
    from paddle_tpu_torch.ops import flash_attention as fa
    for pair, r in tiles["flash_builds"].items():
        bq, bk = (int(x) for x in pair.split("x"))
        for which, (name, outs, replaces) in freps.items():
            if (bq, bk) not in fa.BUILDS[which][1:]:
                continue
            t = r["timing"][which]
            build = (which, bq, bk)
            out.append({"name": f"{name}@{bq}x{bk}", "route": "cuda",
                        "source": fsrc, "replaces": replaces,
                        "build": list(build),
                        "launches": tour_launches.get(str(build), 0),
                        "max_abs_err": max(c["max_abs_err"][o]
                                           for c in r["cases"]
                                           for o in outs),
                        "ms": t["ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                        "library_ms": t["library_ms"]})
    return out


def tour_launch_counts(tiles):
    """{str(build): launches} over phase 31 (e)'s main-path runs."""
    total = {}
    for counts in tiles["tour"].values():
        for b, n in counts.items():
            total[b] = total.get(b, 0) + n
    return total


def nvcc_seconds(libs):
    """{library: nvcc seconds} from the compile cache entries `libs`
    ({name: library file}) were resolved to (None for a library this
    process loaded from an earlier build)."""
    from paddle_tpu_torch.framework import compile_cache
    out = {}
    for name, path in sorted(libs.items()):
        try:
            with open(os.path.join(os.path.dirname(path),
                                   compile_cache.ENTRY_META)) as f:
                sec = json.load(f).get("compile_seconds")
        except (OSError, ValueError):
            sec = None
        out[name] = None if sec is None else round(float(sec), 1)
    return out


def gc_cuda():
    import gc
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def main(argv):
    flash_only = "--flash-only" in argv
    parallel_only = "--parallel-only" in argv
    train_parallel_only = "--train-parallel-only" in argv
    eager_only = "--eager-only" in argv
    nn_only = "--nn-only" in argv
    hapi_only = "--hapi-only" in argv
    text_only = "--text-only" in argv
    jit_only = "--jit-only" in argv
    dist_only = "--dist-only" in argv
    fleet_only = "--fleet-only" in argv
    fleet3_only = "--fleet3-only" in argv
    ps_only = "--ps-only" in argv
    rest_only = "--rest-only" in argv
    tune_only = "--tune-only" in argv
    seed = int(argv[argv.index("--seed") + 1]) if "--seed" in argv \
        else PS_SEED
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only "
              "on a GPU", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "paddle_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout of the repository "
              "(paddle_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if "--dist-child" in argv:
        i = argv.index("--dist-child")
        return dist_child(argv[i + 1], argv[i + 2])
    if "--fleet-child" in argv:
        return fleet_child(argv[argv.index("--fleet-child") + 1])
    if "--fleet3-child" in argv:
        return fleet3_child(argv[argv.index("--fleet3-child") + 1])
    t_start = time.perf_counter()
    report = {"phase_s": {}}
    t_lap = [t_start]

    def lap(phase):
        """Seconds since the previous lap, as phase `phase`'s."""
        now = time.perf_counter()
        report["phase_s"][phase] = round(now - t_lap[0], 1)
        t_lap[0] = now
        log(f"phase {phase}: {report['phase_s'][phase]} s, "
            f"{now - t_start:.1f} s since the start")

    # 1. device ---------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} device {kind}")
    report["card"] = smi
    # the plain versions are held at full float32 too
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 2. build ------------------------------------------------------------------
    from paddle_tpu_torch._kernels import build
    t0 = time.perf_counter()
    start_recipe_build()
    libs = build.build_all()
    report["build_s"] = time.perf_counter() - t0
    report["nvcc_s"] = nvcc_seconds(libs)
    log(f"built {sorted(libs)} in {report['build_s']:.1f} s (nvcc s by "
        f"library, at once: {report['nvcc_s']})")
    report["ptxas"] = {name: ptxas_resources(name) for name in sorted(libs)}
    for name, rows in report["ptxas"].items():
        for r in rows:
            log(f"ptxas {name} {r['kernel']}: {r['registers']} registers, "
                f"{r['spill_stores']} B spill stores, {r['spill_loads']} B "
                "spill loads")
    report["wgmma_resources"] = wgmma_resources(
        report["ptxas"]["flash_attention"])
    for r in report["wgmma_resources"]:
        log(f"wgmma kernel {r['kernel']} (D={r['D']} {r['dtype']}, "
            f"{'mask/dropout' if r['general'] else 'plain'} build, tile "
            f"{r['tile'][0]}x{r['tile'][1]}): "
            f"{r['registers']} registers, "
            f"{r['spill_stores']} B spill stores, {r['spill_loads']} B "
            f"spill loads, {r['smem_dynamic']} B dynamic shared memory")
    if tune_only:
        # phase 31 alone, with the sweep
        report["tiles"] = tiles = tile_phase(smi, sweep=True)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out",
                               "chip_smoke_tune.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
        log(json.dumps({"kernels": tile_entries(
            tiles, tour_launch_counts(tiles))}))
        return 0
    if rest_only:
        # phase 30 alone
        report["rest"] = rest_phase(smi)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out",
                               "chip_smoke_rest.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
        log(json.dumps({"kernels": [recipe_entry(report["rest"])]}))
        return 0
    if ps_only:
        # phase 29 alone
        report["ps"] = ps_phase(smi, seed)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out",
                               "chip_smoke_ps.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
        return 0
    if fleet3_only:
        # phases 27 and 28 alone
        report["fleet"] = fleet_phase(smi)
        gc_cuda()
        report["fleet3"] = fleet3_phase(smi, report["fleet"])
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out",
                               "chip_smoke_fleet3.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
        return 0
    if fleet_only:
        # phase 27 alone
        report["fleet"] = fleet_phase(smi)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out",
                               "chip_smoke_fleet.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
        return 0
    if dist_only:
        # phase 26 alone
        report["dist"] = dist_phase(smi)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out",
                               "chip_smoke_dist.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
        return 0
    if jit_only:
        # phase 25 alone
        report["jit"] = jit_phase(smi)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out",
                               "chip_smoke_jit.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
        return 0
    if text_only:
        # phase 24 alone
        report["text"] = text_phase(smi, sdpa_builds=True)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out",
                               "chip_smoke_text.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
        return 0
    if hapi_only:
        # phase 23 alone
        report["hapi"] = hapi_phase(smi)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out",
                               "chip_smoke_hapi.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
        return 0
    if nn_only:
        # phase 22 alone
        report["nn"] = nn_phase(smi)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out",
                               "chip_smoke_nn.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
        return 0
    if eager_only:
        # phase 21 alone
        report["eager"] = eager_phase(smi)
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out",
                               "chip_smoke_eager.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
        return 0
    if train_parallel_only:
        # phase 20 alone
        report["train_parallel"] = train_parallel_phase(smi)
        log(f"phase 20 took {report['train_parallel']['seconds']:.1f} s "
            f"[{smi}]")
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out",
                               "chip_smoke_train_parallel.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
        return 0
    if flash_only:
        # the flash kernels alone, every case run and reported
        flush_buf = torch.empty(64 * 1024 * 1024, device="cuda")
        _, _, failures = run_flash_cases(lambda: _flush_l2(flush_buf),
                                         keep_going=True)
        log(f"flash-only: {len(FLASH_CASES) - len(failures)} of "
            f"{len(FLASH_CASES)} cases agree [{smi}]")
        return 1 if failures else 0

    lap('1-2')
    # 3. kernel vs plain --------------------------------------------------------
    flush_buf = torch.empty(64 * 1024 * 1024, device="cuda")
    cases = run_kernel_cases(lambda: _flush_l2(flush_buf))
    report["cases"] = cases
    del flush_buf

    lap('3')
    # 4. the server ---------------------------------------------------------------
    from paddle_tpu_torch.ops import paged_attention as pa
    from paddle_tpu_torch.serving import PagedGenerationEngine
    from paddle_tpu_torch.text.models import gpt_125m
    model = gpt_125m(device="cuda", seed=0)
    cfg = model.cfg
    prompts = make_prompts(0, PHASE4_LENGTHS, shared_from=8,
                           vocab=cfg.vocab_size)
    engine = PagedGenerationEngine(model, device="cuda", **PHASE4_ENGINE)
    capture4 = precompile(engine, "phase 4")
    pa.launches = pa.launches_window = pa.launches_prefill = 0
    pa.set_build_counts({})
    handles, m, wall = serve(engine, prompts, max_new=32)
    builds4 = pa.build_counts()
    counts4 = check_captures(engine, "phase 4")
    launches, prefill4 = pa.launches, pa.launches_prefill
    prefills = len(prompts) + m["requests"]["serving.preempted"]
    if launches <= 0:
        raise AssertionError("the server never launched the kernel")
    if launches != cfg.num_layers * (m["decode_steps"] + prefills) or \
            prefill4 != cfg.num_layers * prefills or pa.launches_window:
        raise AssertionError(
            f"{launches} launches ({prefill4} on the tile path, "
            f"{pa.launches_window} on the window path), want "
            f"{cfg.num_layers} per forward over {m['decode_steps']} decode "
            f"steps + {prefills} prefills (tiles)")
    if m["prefix_hits"] < 1:
        raise AssertionError("no prefix-cache hit on shared prompts")
    ttfts = [h.ttft_s for h in handles]
    serve_rec = {"requests": len(prompts), "max_new_tokens": 32,
                 "kernel_launches": launches,
                 "kernel_launches_prefill": prefill4,
                 "launches_per_forward": cfg.num_layers,
                 "decode_steps": m["decode_steps"], "prefills": prefills,
                 "decode_step_ms": m["decode_step_ms"],
                 "decode_only_tok_s": decode_only_tok_s(m),
                 "decode_tokens_per_s": m["decode_tokens_per_s"],
                 "sched_host_us": m["sched_host_us"],
                 "ttft_s_mean": sum(ttfts) / len(ttfts),
                 "ttft_s_max": max(ttfts), "prefix_hits": m["prefix_hits"],
                 "capture_s": capture4, "capture_counts": counts4,
                 "launches_by_build": {str(b): n for b, n in
                                       builds4.items()},
                 "wall_s": wall, "card": smi}
    report["serve"] = serve_rec
    log(f"serve gpt_125m kernel: {len(prompts)} requests done, "
        f"launches={launches} ({cfg.num_layers}/forward x "
        f"{m['decode_steps']} decode + {prefills} prefill), "
        f"decode_step_ms={m['decode_step_ms']:.3f} "
        f"decode_only_tok_s={serve_rec['decode_only_tok_s']:.1f} "
        f"ttft_mean_s={serve_rec['ttft_s_mean']:.4f} "
        f"ttft_max_s={serve_rec['ttft_s_max']:.4f} "
        f"prefix_hits={m['prefix_hits']} wall_s={wall:.2f}; captured in "
        f"{capture4:.2f} s, capture counts {counts4}; launches by build "
        f"(the shipped tile table in force) {builds4} [{smi}]")

    lap('4')
    # 5. int8 KV ---------------------------------------------------------------------
    eng8 = PagedGenerationEngine(model, slots=8, max_len=1024,
                                 block_size=16, attention_impl="kernel",
                                 kv_dtype="int8", device="cuda")
    precompile(eng8, "phase 5")
    pa.launches = pa.launches_prefill = 0
    handles8, m8, wall8 = serve(eng8, prompts[8:12], max_new=32)
    check_captures(eng8, "phase 5")
    launches8 = pa.launches - pa.launches_prefill   # the decode launches
    if launches8 <= 0:
        raise AssertionError("the int8 server never launched the kernel")
    report["serve_int8"] = {"requests": 4, "kernel_launches": pa.launches,
                            "kernel_launches_decode": launches8,
                            "decode_step_ms": m8["decode_step_ms"],
                            "wall_s": wall8}
    log(f"serve gpt_125m int8 KV: 4 requests done, launches={pa.launches} "
        f"({launches8} decode) "
        f"decode_step_ms={m8['decode_step_ms']:.3f} [{smi}]")
    del eng8, engine
    if parallel_only:
        # phase 19 alone, against phases 4's and 5's streams
        t19 = time.perf_counter()
        del model
        report["parallel"] = parallel_phase(
            prompts, [h.tokens for h in handles],
            [h.tokens for h in handles8], smi)
        report["phase19_s"] = time.perf_counter() - t19
        log(f"phase 19 took {report['phase19_s']:.1f} s [{smi}]")
        os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
        with open(os.path.join(ROOT, "chiprun_out",
                               "chip_smoke_parallel.json"), "w") as f:
            json.dump(report, f, indent=1, default=str)
        return 0

    lap('5')
    # where a decode step's time goes ------------------------------------------------
    prof = profile_decode(model, prompts[8:16])
    report["profile"] = prof
    log_profile("one-token decode step", prof, smi)

    lap('5 profile')
    # 6. kernel path vs plain path ------------------------------------------------
    compared, dropped = compare_paths(model, prompts[:4] + prompts[8:12])
    report["parity"] = {"compared_steps": compared,
                        "dropped_near_ties": dropped, "gap_min": GAP_MIN}
    log(f"parity kernel vs plain path: {compared} slot-steps agree, "
        f"{dropped} dropped by the top-2 gap < {GAP_MIN} rule")
    if compared == 0:
        raise AssertionError("phase 6 compared nothing")
    report["replay_vs_eager"] = replay_vs_eager(model, prompts[8:16])

    lap('6')
    # 7. flash kernels vs plain -------------------------------------------------
    flush_buf = torch.empty(64 * 1024 * 1024, device="cuda")
    flash_cases, flash_t, _ = run_flash_cases(lambda: _flush_l2(flush_buf))
    report["flash_cases"], report["flash_timing"] = flash_cases, flash_t
    del flush_buf

    lap('7')
    # 8. the training step ---------------------------------------------------------
    del model
    torch.cuda.empty_cache()
    report["train"] = train_step_350m(smi)
    torch.cuda.empty_cache()

    lap('8')
    # 9. training kernel path vs plain path ------------------------------------------
    report["train_parity"] = compare_train_paths()
    torch.cuda.empty_cache()

    lap('9')
    # 10. the speculative server ----------------------------------------------
    model = gpt_125m(device="cuda", seed=0)
    spec_rec, spec_handles, window10, prefill10 = serve_spec(model,
                                                             prompts, smi)
    report["serve_spec"] = spec_rec
    spec_rec["profile"] = profile_spec_round(model, prompts[8:16], smi)
    log(f"device busy a speculative round "
        f"{spec_rec['profile']['device_busy_ms_per_step']:.3f} ms (the "
        f"paged kernel {spec_rec['profile']['paged_ms_per_step']:.4f} ms) "
        f"vs a one-token step {prof['device_busy_ms_per_step']:.3f} ms")
    picks = list(range(4)) + list(range(8, 12))
    compared, dropped = compare_spec(model, [prompts[i] for i in picks],
                                     [spec_handles[i].tokens for i in picks])
    spec_rec["parity"] = {"compared_tokens": compared,
                          "dropped_near_ties": dropped, "gap_min": GAP_MIN}
    log(f"parity speculative vs one-token: {compared} tokens agree, "
        f"{dropped} dropped by the top-2 gap < {GAP_MIN} rule")
    if compared == 0:
        raise AssertionError("phase 10 compared nothing")

    lap('10')
    # 11. int8 decode weights, logit capture and hot-swap ---------------------
    report["quant_weights"] = quant_weights_quality(model, prompts[8:16], smi)
    report["spec_int8"] = spec_int8_agreement(model, prompts[8:12], smi)
    report["hot_swap"] = hot_swap(model, prompts, spec_handles, smi)

    lap('11')
    # 12. the KV handoff ----------------------------------------------------
    failures = decode_failures()
    report["handoff"] = handoff(model, prompts[8:16], smi)
    if decode_failures() != failures:
        raise AssertionError("phase 12: a decode failure was contained")

    lap('12')
    # 13. the server under its SLO machinery and chaos ----------------------
    report["slo"] = slo_serving(model, prompts, [h.tokens for h in handles],
                                smi)
    report["slo"]["phase4_decode_step_ms"] = m["decode_step_ms"]
    report["slo"]["phase4_sched_host_us"] = m["sched_host_us"]
    report["slo"]["phase10_round_ms"] = spec_rec["round_ms"]
    report["slo"]["phase10_sched_host_us"] = spec_rec["sched_host_us"]
    log(f"decode step on the host clock with the substrate on: phase 4 "
        f"{m['decode_step_ms']:.3f} ms (scheduler host time a step outside "
        f"decode, median {m['sched_host_us']['median_us']:.1f} us), phase "
        f"10 round {spec_rec['round_ms']:.3f} ms (median "
        f"{spec_rec['sched_host_us']['median_us']:.1f} us) [{smi}]")

    lap('13')
    # 14. the serving fleet: worker processes on this card ------------------
    import gc
    gc.collect()                     # free the earlier phases' engines
    torch.cuda.empty_cache()
    report["fleet"] = fleet_serving(model, prompts,
                                    [h.tokens for h in handles], smi)

    lap('14')
    # 15. KV tiers and multi-tenant serving ----------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    shared, shared_want = prompts[8:16], [h.tokens for h in handles[8:16]]
    report["tiers"] = tiers_phase(model, shared, shared_want, smi)
    report["tenancy"] = tenancy_phase(model, shared, shared_want, smi,
                                      m["decode_step_ms"])
    report["phase15_s"] = time.perf_counter() - t15
    log(f"phase 15 paged launches: tier re-serves "
        f"{ {k: v['launches'] for k, v in report['tiers'].items() if k != 'worker'} }, "
        f"tenancy {report['tenancy']['launches']}, spec with adapters "
        f"{report['tenancy']['spec']['window_launches']} windows; phase 15 "
        f"took {report['phase15_s']:.1f} s [{smi}]")

    lap('15')
    # 16. the KV ledger and the numerics plane ---------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    t16 = time.perf_counter()
    report["ledger"] = ledger_serving(model, prompts, smi)
    gc.collect()
    torch.cuda.empty_cache()
    report["numerics"] = numerics_arming(model, prompts[8:16], prof, smi)
    report["phase16_s"] = time.perf_counter() - t16
    log(f"phase 16 took {report['phase16_s']:.1f} s [{smi}]")

    lap('16')
    # 17. the device profile and the cost model ------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    t17 = time.perf_counter()
    out17 = os.path.join(ROOT, "chiprun_out", "phase17")
    report["deviceprof_serving"] = serving_profile(
        model, prompts, [h.tokens for h in handles], smi, out17)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    report["deviceprof_train"] = train_profile(smi, out17)
    report["phase17_s"] = time.perf_counter() - t17
    log(f"phase 17 took {report['phase17_s']:.1f} s [{smi}]")

    lap('17')
    # 18. warm start: save_for_generation and the Predictor ------------------
    gc.collect()
    torch.cuda.empty_cache()
    t18 = time.perf_counter()
    report["warm_start"] = warm_start(prompts, [h.tokens for h in handles],
                                      smi)
    report["phase18_s"] = time.perf_counter() - t18
    log(f"phase 18 took {report['phase18_s']:.1f} s [{smi}]")

    lap('18')
    # 19. multi-device serving on the one card -------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    t19 = time.perf_counter()
    report["parallel"] = parallel_phase(prompts, [h.tokens for h in handles],
                                        [h.tokens for h in handles8], smi)
    report["phase19_s"] = time.perf_counter() - t19
    log(f"phase 19 took {report['phase19_s']:.1f} s [{smi}]")

    lap('19')
    # 20. multi-device training on the one card ------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    report["train_parallel"] = tp20 = train_parallel_phase(smi)
    single = tp20["timed"]["single"]["step_ms_median"]
    log(f"phase 20 took {tp20['seconds']:.1f} s; single-device step "
        f"{single:.2f} ms in phase 20, {report['train']['step_ms_median']:.2f}"
        f" ms in phase 8 [{smi}]")

    lap('20')
    # 21. the eager core on the card ----------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    report["eager"] = eager_phase(smi)

    lap('21')
    # 22. nn, optimizer and amp on the card -----------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    report["nn"] = nn_phase(smi)

    lap('22')
    # 23. io, metric, hapi and vision: Model.fit on ResNet-50 ------------------
    gc.collect()
    torch.cuda.empty_cache()
    report["hapi"] = hapi_phase(smi)

    lap('23')
    # 24. head dims 32 / 128 / 256 and float16; text and audio ---------------
    gc.collect()
    torch.cuda.empty_cache()
    report["text"] = text_phase(smi, sdpa_builds=False)

    lap('24')
    # 25. jit, static and the Predictor over a saved program -----------------
    gc.collect()
    torch.cuda.empty_cache()
    report["jit"] = jit_phase(smi)

    lap('25')
    # 26. the process layer and data parallelism: dp2 in two processes -------
    gc.collect()
    torch.cuda.empty_cache()
    report["dist"] = dist_phase(smi)

    lap('26')
    # 27. fleet and hybrid parallelism: pp on one card, mp / pp / sharding
    # across two processes ------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    report["fleet"] = fleet_phase(smi)

    lap('27')
    # 28. fleet across processes: sp, GPipe, vpp and the pipeline runner
    # over two processes -------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    report["fleet3"] = fleet3_phase(smi, report["fleet"])

    lap('28')
    # 29. the parameter-server tables: a device embedding cache on the card,
    # two shard servers in child processes --------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    report["ps"] = ps_phase(smi, seed)

    lap('29')
    # 30. the rest of the surface: the custom-op recipe's kernel, sparse,
    # incubate, quantization -------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    report["rest"] = rest_phase(smi)

    lap('30')
    # 31. the kernels' tiles at launch: the tile table -----------------------
    gc.collect()
    torch.cuda.empty_cache()
    report["tiles"] = tiles = tile_phase(
        smi, prompts=prompts, want=[h.tokens for h in handles])

    lap('31')
    # summary ------------------------------------------------------------------------
    # every kernel's max_abs_err covers phase 3's cases and phase 24's at
    # the other head dims and dtypes
    every = cases + report["text"]["c"]["paged"]
    dec = next(c for c in cases if c["case"] == "decode_f32")
    dec8 = next(c for c in cases if c["case"] == "decode_int8")
    win = next(c for c in cases if c["case"] == "verify_f32_T5")
    tile = next(c for c in cases if c["case"] == "prefill_f32_T512")
    err_w = max(c["max_abs_err"] for c in every
                if c["kind"] == "f32" and 1 < c["T"] <= pa.WINDOW_ROWS)
    err_t = max(c["max_abs_err"] for c in every
                if c["kind"] == "f32" and c["T"] > pa.WINDOW_ROWS)
    err_f = max(c["max_abs_err"] for c in every if c["kind"] in ("f32",
                                                                  "nan"))
    err_8 = max(c["max_abs_err"] for c in every if c["kind"] == "int8")

    def entry(name, replaces, launches, c, err):
        return {"name": name, "route": "cuda",
                "source": "paddle_tpu_torch/csrc/paged_attention.cuh",
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": c["ms"], "plain_ms": c["plain_ms"],
                "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                "library_ms": c["library_ms"]}
    # the decode kernel's launches are phase 4's at T=1; the window
    # kernel's phase 10's verify windows; the tile kernel's the prefills of
    # phases 4 and 10. Phase 14 launches the decode and tile kernels from
    # its worker processes, whose counts are in report["fleet"]
    kernels = {"kernels": [
        entry("paged_attention", "paddle_tpu/ops/pallas/paged_attention.py:75",
              launches - prefill4, dec, err_f),
        entry("paged_attention_int8",
              "paddle_tpu/ops/pallas/paged_attention.py:110", launches8, dec8,
              err_8),
        entry("paged_attention_window",
              "paddle_tpu/ops/pallas/paged_attention.py:75", window10, win,
              err_w),
        entry("paged_attention_prefill",
              "paddle_tpu/ops/pallas/paged_attention.py:75",
              prefill4 + prefill10, tile, err_t)]}
    flash_src = {"fwd": ("flash_attention_fwd", ("o", "lse"),
                         "paddle_tpu/ops/pallas/flash_attention.py:70"),
                 "dq": ("flash_attention_dq", ("dq",),
                        "paddle_tpu/ops/pallas/flash_attention.py:234"),
                 "dkv": ("flash_attention_dkv", ("dk", "dv"),
                         "paddle_tpu/ops/pallas/flash_attention.py:286")}
    for which, (name, outs, replaces) in flash_src.items():
        t = flash_t[which]
        kernels["kernels"].append({
            "name": name, "route": "cuda",
            "source": "paddle_tpu_torch/csrc/flash_attention.cu",
            "replaces": replaces,
            # phase 8's step, phase 26 (c)'s two processes, phase 27 (a)'s
            # pipeline and (c)'s two processes, phase 28's two processes,
            # and for the forward phase 25's programs
            "launches": report["train"]["launches"][which]
            + sum(r["flash_launches"][which]
                  for r in report["dist"]["gpt"]["ranks"])
            + fleet_launches(report["fleet"], which)
            + fleet3_launches(report["fleet3"], which)
            + (report["jit"]["launches_fwd"] if which == "fwd" else 0),
            "max_abs_err": max(c["max_abs_err"][o] for c in
                               flash_cases + report["text"]["c"]["flash"]
                               for o in outs),
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    # the recipe's kernel: phase 30 (a)'s path (its eager op and to_static
    # program)
    kernels["kernels"].append(recipe_entry(report["rest"]))
    # the paged and flash kernels' other builds: phase 31 (e)'s main paths
    # at their tiles, phase 4's and 31 (c)'s where the shipped table picks
    # them
    runs = tour_launch_counts(tiles)
    for counts in (report["serve"]["launches_by_build"],
                   tiles["serving"]["builds_on"]):
        for b, n in counts.items():
            runs[b] = runs.get(b, 0) + n
    kernels["kernels"] += tile_entries(tiles, runs)
    report["kernels"] = kernels
    report["total_s"] = time.perf_counter() - t_start
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(report, f, indent=1)
    log(f"total {report['total_s']:.1f} s; seconds by phase "
        f"{report['phase_s']}")
    log(smi)
    log(json.dumps(kernels))
    assert all(math.isfinite(x["ms"]) for x in kernels["kernels"])
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
