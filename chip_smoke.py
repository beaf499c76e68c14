#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on any failed check:

1. Environment: the card's name and power limit, the torch and CUDA
   versions, the time to build the CUDA kernels from `src/repro_torch/
   csrc/` with nvcc (sm_90a), and the registers, shared memory and spills
   of the attention, scan, grouped GEMM, segment-combine and fused-read
   kernels (the 3xTF32 float32 ones, the SIMT float32 ones and the bf16
   tensor-core ones, `gg_sm90` and `gg_bf16` among them, and B5's
   backward kernels: bf16 `fa_bwd_pre_sm90`, `fa_bwd_dkdv_sm90`,
   `fa_bwd_dq_sm90`, float32 `fa_bwd_pre_tf32`, `fa_bwd_dkdv_tf32`,
   `fa_bwd_dq_tf32`; B4's backward: the dx forms of `gg_tf32`, `gg_sm90`
   and `gg_bf16`, and `gg_dw_sm90`, `gg_dw_bf16`, `gg_dw_tf32` with their
   prologue `dw_plan` and the partials' sum `dw_reduce`; B7's backward:
   `ssd_bwd_dstates_sm90` and `ssd_bwd_chunk_sm90` (TMA + TF32 `wgmma`),
   the shared `ssd_bwd_state_pass`, and `ssd_bwd_dstates`, `ssd_bwd_chunk`
   for operands TMA cannot describe).
2. Kernel parity: every kernel against its plain PyTorch version on the
   card — the histogram on each of its routes (`histogram.ops.route`: the
   shared-memory route below 48 KB and in the opt-in band, the global
   route; uniform and Zipf ids, weighted and not, out-of-range ids, ids
   not 16-byte aligned), the segment combine (every
   merge, float32 and float64, empty segments, negative and tied
   priorities, Zipf-2.0 hot segments, NaN / ±inf / ±3e38 under min, max
   and or), the fused stage (every read_op x merge, arity-0 rows, a
   single-row batch, NaN and ±3e38 min/max reads below and at the max
   arity; the gather-reduce on each layout of `stage_fused.ops.layout`,
   w = 1 ... 1536 in float32 and float64, with a task of arity 1,000 and
   rows not 16-byte aligned), the grouped GEMM (the MOE geometries of
   tests/test_kernels.py, empty groups, rows beyond the groups' sum, the
   parameter-server path's two projections; in bf16 the same cases and
   granite's decode-step projections, K or N not a multiple of 8, strided
   weight views at and off 16 bytes and the edges of `gg_sm90`'s tile walk,
   each on the kernel its operands route to — `gg_sm90` or `gg_bf16`,
   counted — within `gemm_check`'s bf16 gate),
   and attention, decode
   attention and the SSD scan (see phase 5; bf16 attention and decode take
   the tensor-core kernels `flash_attention_sm90` and `flash_decode_sm90`,
   float32 attention the 3xTF32 kernel `flash_attention_tf32`, float32
   decode the SIMT one), and B5's backward (bf16
   `flash_attention_bwd_sm90.cu`, float32
   `flash_attention_bwd_tf32_sm90.cu`;
   counters "flash_attention_bwd_bf16" / "_tf32") at hd 32 / 64 / 128, GQA
   1 / 4 / 8, causal and not, S = 1,000 and 4,096 against
   `attention_bwd_ref` on the same inputs (`bwd_check`'s gate), with one
   dk tile zeroed caught, and at S = 4,096 with GQA 8 dk without one middle
   query tile of one head, and without one query head, caught; two calls
   a dtype at the training shape and at prefill_gqa128 (hd 128) give the
   same bits. B4's backward in bf16 and float32 (dx: "moe_gemm_dx_sm90",
   "moe_gemm_dx_bf16", "moe_gemm_dx"; dw: "moe_gemm_dw_sm90",
   "moe_gemm_dw_bf16", "moe_gemm_dw", each on the kernel `route_dx` /
   `route_dw` names) at granite-moe-1b-a400m's training shapes (131,072
   Zipf-1.2 rows over 32 experts, the in- and out-projection), the hot
   path's call with a 7/8 zero tail, 64-row tiles, strided w at and off
   16 bytes, empty groups, negative sizes past M, K and N not multiples
   of 8, a hot group split into 24 chunks of the dw walk, against the
   plain version's float32 sums at `gemm_check`'s gate; every call's dw
   plan equal to `ops.dw_plan_ref`; two calls at the granite shapes and
   the split case give the same bits; dw without 128 rows of the largest
   group, dw without one chunk's partial of a split group, and dx without
   the smallest group's rows, caught. B7's backward (float32, through
   `mamba_ssd` under autograd) against `ssd_scan_bwd_ref` in float64
   (`ssd_bwd_check`'s gate) at zamba2's training shape (2, 4,096, 64
   heads, 64, d_state 64, chunk 128), a chunk of 200 run as 100, one
   chunk, hd 5 / ds 3 / chunk 7, hd 40 / ds 24 / 33 heads and decays that
   underflow, dh_final given and not, each on the route `ops.bwd_route`
   must give it (SSD_BWD_ROUTE: "mamba_scan_bwd", TMA + `wgmma`, and for
   hd 5 / ds 3 the "mamba_scan_bwd_mma" kernels); dx, ddt and dB without
   one chunk's incoming gradient and dB, dC without one head group's
   partial, caught; two calls at the training shape give the same bits.
3. The main path at a real cluster and backlog size — the full YCSB
   setting of the repo's benchmark: P=16 machines, 50,000 tasks per machine
   (800,000 tasks a stage), 800,000 keys of width 16 (51 MB of float32 store
   on the card). Four stages go through `Orchestrator(..., backend="torch")`
   and, on a copy of the store, through the float64 numpy oracle:
     (a) arity-1 Zipf 2.0, update v*c0 + c1, write_back="add";
     (b) arity-1 uniform keys, write_back="write" with random int32
         priorities (its Phase-1 root call passes the host cutoff and
         launches the weighted histogram);
     (c) ragged multi-get, arity 1-8, Zipf 1.5, fused_read("add", finish=
         scale by context), write_back="min" (the fused stage kernel);
     (d) (a) with replication on, two stages in one session, so the second
         stage's replica-local pairs run the unweighted histogram.
   Each stage must give the oracle's `phase_signature()`, `refcount` and
   `exec_site` exactly, and values within the tolerance stated at
   `_check_values`. Each stage must launch each kernel exactly as often as
   `EXPECTED_LAUNCHES` says, and send no lambda to the host path.
4. The parameter-server path at granite-moe-3b-a800m's full width: one MoE
   layer (40 experts of 1536 x 1024 + 512 x 1536 words, top-8; 377 MB of
   float32 on the card) and the 49,155 x 1536 embedding table, on P=8
   machines with bench_paramserve's Zipf-1.2 traffic and replication.
   Four decode steps of 128 tokens through `MoERouter.decode_step` on the
   card, each also through `naive_dispatch(gemm="torch")` (the grouped GEMM
   kernel), both against a float64 host reference made expert by expert;
   embedding lookup, bag pooling (the fused stage kernel), a gradient push
   (the segment-combine kernel), replicated lookups and
   `embed_skew_aware` on the exported hot-row cache, against their numpy
   oracles. Each stage must launch each kernel exactly as often as
   `PS_EXPECTED` says, and no lambda may go to the host path. Then K1-K3
   against their plain versions at this path's inputs, a TF32 control run
   of one decode step (how far a lower precision lands from the
   tolerance), and the costs: decode steps of 16 tokens and every embedding stage on the card
   and on the numpy backend give the same `phase_signature()`, `refcount`,
   `exec_site` and work ratios, and bench_paramserve's gate (orchestrated
   work ratio <= 1.5, naive >= 2x) holds on its own MoE mix on both.
5. The attention and SSM path: the three kernels no model of the JAX
   package calls, through their own entry points (`repro_torch.kernels.
   attention`, `decode_attention`, `mamba_ssd`), at the widths of the
   configs that use them (read from `repro_torch.configs`), each stage in
   float32 and in bf16:
     ssd            zamba2-1.2b's Mamba2 scan, x (2, 32768, 64, 64), chunk
                    128 (batch 32 cut to 2);
     prefill_mha    zamba2-1.2b's shared attention, causal (1, 32768, 32,
                    64) (batch 32 cut to 1);
     prefill_gqa128 command-r-35b's attention, q (1, 8192, 64, 128), k/v 8
                    heads (batch 32 cut to 1, seq 32768 to 8192);
     decode_long    zamba2-1.2b's long_500k decode: caches (1, 524288, 32,
                    64), length 500,000 as a device tensor;
     decode_gqa     tinyllama-1.1b's decode_32k: q (128, 32, 64), caches
                    (128, 32768, 4, 64), length 30,000.
   Each output is held against the plain version (float64 for float32
   runs, float32 on the same inputs for bf16) within the tolerances stated
   at ATTN_REL and SSD_REL; each stage must launch its kernel once
   (`ATTN_EXPECTED`: the bf16 attention and decode stages the `*_sm90`
   kernels, float32 attention `flash_attention_tf32`, float32 decode the
   SIMT kernel). Phase 2 holds the five
   kernels against their plain versions at the FLASH / DECODE / MAMBA
   geometries of tests/test_kernels.py and at edge cases
   (`attention_ssm_parity`).
6. Kernel times at the paths' shapes (CUDA events, median of several
   runs) beside the plain version, the one PyTorch call that computes the
   same function (`torch.bincount`, `index_add_`, `embedding_bag`,
   `torch._grouped_mm` where it takes float32, and in bf16 for the bf16
   grouped GEMM `gg_sm90` at granite-moe-3b-a800m's prefill and decode
   shapes (row 4b, `GG_BF16_SHAPES`, with the call's host and device time,
   and `gg_bf16` on the same operands beside it),
   `F.scaled_dot_product_attention`; none for the SSD scan), and the least
   time the card could take (bytes over 3.35 TB/s, or operations over 67
   TFLOP/s in float32 FMAs, 495/3 TFLOP/s for the float32 kernels that
   run 3xTF32 on the tensor cores (with the FMA bound beside it), or 989
   TFLOP/s in bf16, whichever is larger). Row 5c: B5's backward at
   tinyllama-1.1b's training shape (4, 4096, 32 heads, 4 KV heads, 64) and
   phase 5's prefill_mha and prefill_gqa128, bf16 and float32: call and
   device ms (split into the pre, dk/dv and dq kernels), the plain
   version, the library's backward (SDPA's, alone), a bound of 2.5 times
   the forward's operations, and dq, dk, dv held to phase 2's gate at
   each shape. Row 4d: B4's backward (dx, dw) at granite-moe-1b-a400m's
   training shapes in bf16 and float32: call, host and device ms (CUDA
   events around calls queued behind a spin kernel), the plain version
   (dx and dw together), `torch._grouped_mm` for the same product, the
   bound over the rows inside the groups, the dw walk's chunk rows, split
   groups and workspace bytes, and in bf16 `gg_bf16`'s dx beside
   `gg_sm90`'s and `gg_dw_bf16`'s dw beside `gg_dw_sm90`'s. Row 7b: B7's
   backward at zamba2-1.2b's training shape and phase 5's ssd stage: call
   and device ms (split into its kernels), the plain version, the bound (3xTF32 operations, the FMA bound beside it), no
   library call, and the outputs held to phase 2's gate at each shape.
   The segment
   combine is timed
   at the writer combines of stages (a) add (`index_add_`), (c) min
   (`index_reduce_(..., "amin")`) and (b) write (no one call). The
   histogram (at stage (b)'s root call, the parameter-server lookup's, a
   decode step's and `embed_skew_aware`'s raw ids) and the fused gather-reduce (at stage (c) and the
   parameter-server bags) also get the call's host time and the device
   time alone (torch.profiler's kernels and fills over 20 calls; CUDA
   events around calls queued behind a spin kernel where three profiler
   sessions miss them).
7. Device busy share: stages (a)-(c) once more under torch.profiler, after a
   warm-up run; the device's busy time (kernels, copies, fills) against the
   stage's wall time.
8. The other engines and multi-round plans, at half phase 3's setting
   (ENGINES_TPM: 25,000 tasks a machine, 400,000 keys):
   stages (a)-(c) through `Orchestrator(engine=e)` for e in "pull", "push",
   "sort" and "auto" on the card and, on a copy of the store, on the numpy
   oracle: `phase_signature()`, `exec_site`, `refcount`, values within
   `_check_values`' tolerance, `auto`'s decisions equal to the oracle's,
   no lambda on the host path, launches as `ENGINE_EXPECTED` (plus
   `AUTO_ESTIMATE` under auto). Then benchmarks/bench_plan.py's two cells
   at their full sizes, engine "pull" — pagerank_stages (Barabási-Albert
   n = 50,000, 10 rounds of two stages) and bfs_stages (n = 100,000, from
   vertex 0) — each through `run_plan` and the same `run_stage` loop on
   the card and `run_plan` on numpy: equal session reports
   (`assert_session_parity`), values within the reckoned tolerance (BFS
   exact), at most one host sync a round under the plan, the walls of both.
9. TDO-GP: Erdős-Rényi (2^16 vertices, average degree 16) and star (2^16)
   graphs and bench_graph's Barabási-Albert graph (30,000, attach 8),
   ingested at P=16 on the card and on the numpy oracle (every layout
   array and the ingest bill equal), then BFS, SSSP, CC, PageRank (10
   rounds, tol 0) and BC from vertex 0 both ways: rounds and every
   round's `phase_signature()` equal, BFS / SSSP / CC values exact, BC
   within BC_REL; PageRank's device-route combines are measured against
   exact sums (`_measured_combines`) and the float32 ranks' error is
   reported; PageRank once more in float64 on the ER graph is the gate,
   within PAGERANK_F64_ABS. The ER ingest's Phase-1 root call is timed as
   one more histogram shape of phase 6 (row 1e).

10. The KV store and the serve tier (`repro_torch.kvstore`,
   `repro_torch.serve`) at the main path's table:
   `DistributedHashTable(800,000, 16, value_width=16)` (bench_ycsb's full
   setting, 51 MB of float32 on the card), YCSB Zipf 1.5 with a
   stationary hot set. One-shot: `execute_batch` of YCSB A and B (800,000
   operations), `multi_get` of 100,000 tasks of arity 1-8 and `run_chain`
   over 100,000 chains of 4 hops, each against the numpy backend
   (`phase_signature()`, `refcount`, `exec_site` exactly, values within
   `_check_values`' gates; `execute_batch` also against
   `DistributedHashTable.oracle`). Streaming, sync mode: 65,536 GET / RMW
   requests (10% RMW) and 4,096 multi-gets through `table.serve()` at
   max_batch 256 and 8,192 (size trigger only), every result bit-identical
   to `execute_batch` / `multi_get` on the card over the same coalesced
   batches and within a float32-drift gate of the numpy backend's replay.
   Thread mode: bench_serve's 20,000 requests offered at 80% of the sync
   rate at 256, with `TorchBackend.prefetch` and with it a no-op: every
   future resolves without an error, the numpy replay of the batches the
   executor ran matches each result and the final table; requests/s, p50,
   p99, `overlap_frac`. The card's busy share of a sync run
   (torch.profiler). Then `MoEFrontend` (128 tokens, bit-identical to
   `decode_step`) and `EmbeddingFrontend` (8,192 lookups and bags
   bit-identical to `lookup` / `lookup_bags`, 8,192 gradient pushes within
   K2's sum bound) at phase 4's granite widths. Launches by
   `SERVE_EXPECTED` and, for a streamed run, by its batches' kinds
   (`SERVE_BATCH`); no lambda may go to the host route.
11. Elasticity (`repro_torch.core.elasticity`) at the main path's table
   (800,000 keys x 16), each elastic session against a numpy session under
   the same spec: (a) stage (a)'s traffic for 6 stages uninterrupted, with a
   restart recovery (machines 2 and 9 die at stage 3; durable snapshots
   every 2 stages, npz + sha256, in a temporary directory) and with a shrink
   (machine 5 dies for good): every stage's `phase_signature()` (elastic
   phases included) and `exec_site` equal to numpy's, the restart's equal
   to the uninterrupted run's without them, every stage's values within
   `_check_values`' gate of a numpy stage from the card's pre-stage values,
   no task or chunk left on the dead machine; the ms of each snapshot,
   recovery and 51 MB table re-upload. (b) Work stealing at stage (a) under
   TD-Orch and push, on and off, and at (b), (c) under TD-Orch: max / mean
   tasks a machine, stolen tasks, steal words. (c) benchmarks/
   bench_elastic.py's three arms at its full setting over the same table
   (engine "push", P=8): bills, results and moves equal numpy's every stage,
   and its gate (words and work within 10% of the stationary arm with
   migration, above 1.10x without); `MigrationPlanner.observe` and the
   elections timed. (d) Phase 10's `run_chain` (100,000 x 4 hops) with
   machine 4 killed before hop 2: values and the table bit-identical to the
   uninterrupted chain's, hop bills equal. (e) A sync-mode `serve(
   elasticity={"stealing": True, "migration": True})` over phase 10's stream
   at 256: the report's "elastic" block equal to the shared manager's
   `counters()`, results within the numpy replay's gate. Launches by stage
   as phases 3, 8 and 10 (K1-K3 through elastic sessions).
12. Multi-device execution (`repro_torch.core.shardexec`, `core.spmd`):
   `backend="torch_spmd"` on the stacked mesh (one shard a machine, all on
   the card) against the numpy oracle. (a) Phase 3's four stages, not cut
   (P=16, 800,000 tasks, 800,000 keys x 16): bills, `refcount`,
   `exec_site` equal, values within phase 3's gate, `ShardStageStats`
   equal to a numpy recount from the exec sites, the layout and the
   replica set, the measured work_ratio equal to the charged one; a
   stage's wall, host share, peak device memory and all-to-all bytes, and
   its wall under `backend="torch"`. (b) tests/test_elastic.py's
   TestChaosSharded at (a)'s size (machine 3 dies at stage 4, migration
   on, a Zipf-1.4 stream of write-merge stages): session parity with
   numpy, one recovery, values within rtol 2e-4 / atol 1e-5. (c)
   `moe_push_pull`, `moe_direct_push`, `moe_direct_pull` at phase 4's
   granite widths, ep 8, 8,192 Zipf-1.2 tokens: against `moe_reference`
   with a capacity that drops nothing, drops logged at 1.25. (d)
   `embed_skew_aware` on 8 shards over phase 4's table. (e) The group
   mesh: 4 gloo ranks sharing the card on stage (a)'s traffic at P=4,
   200,000 tasks, gloo's collectives on CUDA tensors: stats equal to the
   stacked mesh's. (f) benchmarks/bench_spmd.py's YCSB cells (P=8, Zipf 1.2
   and 2.0, replication on and off): charged and measured work_ratio and
   its gate. Launches by stage: K1 once a sharded stage plus the cost
   model's calls, K2 twice a writing stage, K4 twice a grouped SwiGLU.
13. Language-model serving (`repro_torch.models`, `launch.serve`):
   zamba2-1.2b, tinyllama-1.1b, granite-moe-3b-a800m and xlstm-350m from
   `repro_torch.configs` at full width and depth in bf16, random weights
   from a seed: `generate` of 64 tokens greedily after a 4,096-token
   prompt, batch 8. Launches exact (`lm_launches`; zamba2: 38 scans and 7
   bf16 attention calls a prefill, 7 bf16 decode calls a step; tinyllama:
   22 and 22; granite: 32 and 32, and 32 histograms and 128 bf16 grouped
   GEMMs a prefill and a step; xlstm: none); prefill ms, decode ms a step,
   tokens/s, peak memory, each kernel's ms inside a prefill and a step,
   the device's idle share of decode steps, a step's byte bound (granite:
   the experts that step routed to). A second `generate` with every kernel
   call held against its plain version (a miss of B5-B7 re-calls both,
   for C2). Cache consistency: a 3,968-token prefill and 128
   teacher-forced steps against a 4,096-token prefill (xlstm: 896 and 128
   against 1,024, `LM_CHECK_PROMPT`; caches, last
   logits, decode caches; xlstm's recurrent states on the reference's
   stabilizer), within `lm_gate` of max|·| (granite also counts the decode
   steps' expert choices that differ from the prefill's), and each of
   `lm_faults` planted must miss it. The second `generate` and the cache
   consistency run granite at 8 layers, zamba2 at 19, tinyllama at 11 and
   xlstm at 16 (`LM_CHECK_LAYERS`). Each config at n_layers=2 in float32
   on the card against float64 on the CPU (logits and caches within
   LM_F32_REL of max|ref|), and `mamba_ssd`'s final state at (8, 4096, 64,
   64) against the plain version.
14. Training (`repro_torch.runtime.Trainer`, `Model.loss_fn`, B4's,
   B5's and B7's backwards): tinyllama-1.1b at full width and depth in
   bf16 (random
   weights from a seed), `SyntheticLMStream` of batch 4 x 4,096 tokens,
   int8 gradient compression, AdamW with a 2-step warmup, 5 steps: once
   uninterrupted (step ms, tokens/s, peak memory; B5's forward and
   backward ms inside a step by CUDA events) and once with a checkpoint
   every 3 steps in a temporary directory and a failure at step 4 (restored
   and continued). Every loss and grad norm finite, the first within 1.0 of
   ln 32,000, the run with the failure's every logged loss and grad norm
   bit-identical to the uninterrupted run's at its step, launches exact
   (one B5 forward and one backward a layer a step run, the plain versions
   never called). The float32 twin (2 layers at full width): `loss_fn`'s
   loss and every parameter's gradient on the card against float64 on the
   CPU (TRAIN_F32_LOSS, TRAIN_F32_REL). Then granite-moe-1b-a400m at full
   width and depth in bf16, batch 2 x 4,096 (TRAIN_MOE_BATCH: 4 x 4,096
   does not fit the card), 4 steps, compression on, no checkpoint: losses
   finite, the first within 0.1% (TRAIN_MOE_FIRST_REL) of the same
   weights' loss in float32 on the card, launches exact (a MoE layer a step: a histogram, four B4
   forward and eight backward launches — dx and dw of each — and B5's
   forward and backward; the plain versions never called), step ms,
   tokens/s, peak memory, B4's forward, dx and dw ms and B5's forward and
   backward ms inside a step; its float32 twin (2 layers, 1 x 256: 64-row tiles) against float64
   on the CPU with the float64 routing pinned to the card's experts
   (TRAIN_F32_LOSS, TRAIN_F32_REL; the tokens it would have routed
   elsewhere counted). Then zamba2-1.2b at full width and depth in bf16
   (38 Mamba2 layers, 7 applications of the shared attention block),
   batch 2 x 4,096, 4 steps, compression on, no checkpoint: losses
   finite, the first within TRAIN_MOE_FIRST_REL of the float32 loss,
   launches exact (a step: one B7 forward and one backward a Mamba layer,
   float32 as the layer lifts the scan's inputs, the backward on the
   "mamba_scan_bwd" route and none on "mamba_scan_bwd_mma", and B5's
   forward and
   backward an application), step ms, tokens/s, peak memory, B7's and
   B5's forward and backward ms inside a step (B7's backward by kernel
   from the profiler); its float32 twin (2 layers, 1 x 256) against
   float64 on the CPU.
15. The model-level mesh (`repro_torch.launch`: `steps.build_step` on
   `mesh.make_host_mesh(1, 4)`, whose "model" axis is a stacked mesh of 4
   shards on the card; the MoE layers' mesh branches in `models/moe.py`),
   bf16, seeded weights: (a) granite-moe-1b-a400m trained at full width
   and depth, batch 1 x 4,096 (1,024 tokens x top-8 a shard), 5 steps of
   the bound train step (the sequence-split branch): losses finite,
   launches exact (a MoE layer a step: a histogram, four B4 forward and
   eight backward launches, B5's forward and backward), the plain versions
   never called; step ms (median of steps 2-5, each step's device span
   beside it), B4's and B5's device ms a step, tokens/s, peak memory, a
   device's all-to-all and psum bytes a step (forward and backward),
   dropped assignments a step; then one more step with every kernel call,
   forward (B1, B4, B5) and backward (B4's dx and dw, B5's), held against
   its plain version at the mesh's shapes, at phase 13's and phase 2's
   gates.
   (b) At capacity factor 4 (nothing drops, asserted) and aux weight 0,
   the (1, 4) mesh against a (1, 1) one on the same weights: the float32
   twin (2 layers, 1 x 256) within phase 14's gates (loss 1e-5·|ref|,
   gradients 1e-4·max|ref|), and 8 layers in bf16 at 1 x 4,096 within
   0.1% of the same weights' float32 loss. (c) granite-moe-3b-a800m at 8
   layers (`LM_CHECK_LAYERS`): an 8 x 4,096 prefill (the sequence-split
   branch) and 16 greedy decode steps (the psum branch) through the bound
   prefill and decode steps, launches exact (a prefill: a histogram and
   four B4 a layer, B5; a step: two B4 a layer, B6), prefill ms (after
   one untimed prefill) and decode ms, peak memory, collectives, drops; again with every kernel call held
   against its plain version; and at capacity factor 4 against the same
   weights on one device, the mesh's tokens fed to both, every logits
   tensor within `lm_gate` (0.25 of max|ref|).

The last line is ``{"ok": true, "device": {...}}``; the line before it
holds the per-kernel numbers as JSON, and the one before that the card's
name and power limit.

A diagnostic of the open fault C2 (ROADMAP), not in the default run:
``--c2-repeats N`` runs phase 5's bf16 prefill_mha stage N times after
phase 4 and reads every share of its gate, then runs phases 5-15 as
always.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet) used for the bound of each kernel
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# float32 work on the tensor cores in 3xTF32: three TF32 products (495
# TFLOP/s dense) for each float32 one (moe_gemm, flash_attention_tf32)
FP32_TC_OPS_PER_S = 495e12 / 3
BF16_OPS_PER_S = 989e12  # dense, tensor cores

P = 16
TASKS_PER_MACHINE = 50_000
VALUE_WIDTH = 16
SEED = 20251111
# host-clock margin before and after a profiled block: torch.profiler keeps
# only the device events whose timestamps fall inside its session, and the
# card's timestamps can sit milliseconds off the host's, more than 20 short
# calls last
PROFILE_PAD_S = 0.25


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def kernel_resources(nvcc_log: Path, names=("fa_tf32", "fa_sm90",
                                             "fa_bwd_pre", "fa_bwd_dkdv",
                                             "fa_bwd_dq",
                                             "fd_split", "fd_sm90",
                                             "ssd_states", "ssd_state_pass",
                                             "ssd_outputs", "ssd_bwd_",
                                             "gg_tf32",
                                             "gg_sm90", "gg_bf16",
                                             "gg_dw_tf32", "gg_dw_bf16",
                                             "gg_dw_sm90", "dw_plan",
                                             "dw_reduce",
                                             "seg_combine",
                                             "fused_reduce", "hist_shared",
                                             "hist_global")) -> dict:
    """Registers, shared memory and spills per instantiation of the named
    kernels, as `nvcc -Xptxas=-v` reported them in the build's log."""
    out, entry, spills = {}, None, ""
    for line in nvcc_log.read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
            entry = entry if any(n in entry for n in names) else None
            spills = ""
        elif entry is not None and "spill stores" in line:
            spills = line.strip()
        elif entry is not None and "Used" in line:
            out[entry] = line.split(":", 1)[1].strip() + (
                f"; {spills}" if spills else "")
            entry = None
    return out


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def time_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median device time of `fn()` over `reps` runs, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(bytes_moved: float, ops: float, ops_per_s: float = FP32_OPS_PER_S):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernel parity on the card
# ---------------------------------------------------------------------------
def _within(got, want, allowed, name: str) -> tuple:
    """(max |Δ|, max |Δ| / allowed) of `got` against `want`, elementwise
    tolerance `allowed`; raises past the tolerance or on a malformed
    output (another shape, or a value that is not finite)."""
    import torch

    got, want = got.double(), want.double()
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: malformed output "
                             f"{tuple(got.shape)}")
    err = (got - want).abs()
    if not err.numel():
        return 0.0, 0.0
    ratio = err / allowed.clamp(min=1e-300)
    share = float(ratio.max().item())
    if not bool((err <= allowed).all()):
        i = tuple(int(x) for x in torch.nonzero(ratio == share)[0])
        raise AssertionError(
            f"{name}: beyond tolerance, max |Δ| {err.max().item()} ({share:.3g}"
            f" of it; at {i}: got {got[i].item()}, want {want[i].item()}, "
            f"allowed {allowed[i].item()}; {int((err > allowed).sum())} "
            "elements beyond)")
    return float(err.max().item()), share


def _sum_bound_ok(got, want, mags, rel=1e-6, abs_=1e-6, rel_want=0.0,
                  name="sum") -> float:
    """Float sums whose terms add in another order (atomics, another
    blocking, float32 against a float64 reference): |Δ| <= rel_want*|want|
    + rel*Σ|terms| + abs_ per element (Σ|terms| per element: `mags`).
    Tensors or numpy arrays; `got` must be finite, of `want`'s shape."""
    import torch

    got, want, mags = (torch.as_tensor(a).double() for a in (got, want, mags))
    allowed = rel_want * want.abs() + rel * mags + abs_
    return _within(got, want, allowed, name)[0]


def _same_with_nan(got, want, name: str) -> None:
    """Bit-for-bit equal values, NaN where the plain version has NaN."""
    import torch

    got = got.cpu()
    want = want.cpu()
    nan = torch.isnan(want)
    if not (torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan], want[~nan])):
        raise AssertionError(f"{name}: differs from the plain version")


def _gemm_case(geom, rng):
    """Rows split into G groups at random cuts, as tests/test_kernels.py
    makes its MOE cases."""
    G, M, K, N = geom
    cuts = np.sort(rng.integers(0, M + 1, size=G - 1))
    sizes = np.diff(np.r_[0, cuts, M]).astype(np.int32)
    return (rng.standard_normal((M, K)).astype(np.float32),
            (rng.standard_normal((G, K, N)) * 0.1).astype(np.float32), sizes)


def gemm_parity(dev, x, w, sizes, name: str) -> float:
    """grouped_gemm on the card against its plain version: |Δ| <=
    1e-5 * Σ_k |x_k w_k| + 1e-6 per element (float32 on both sides, sums
    in another order). bf16 x and w take `gemm_check`'s bf16 gate."""
    import torch

    x, w, sizes = (torch.as_tensor(a).to(dev) for a in (x, w, sizes))
    from repro_torch.kernels.moe_gemm.ops import grouped_gemm

    return gemm_check(x, w, sizes, grouped_gemm(x, w, sizes),
                      f"moe_gemm {name}")[0]


# The bf16 grouped GEMM (`gg_bf16`) against the plain version's float32
# sums on the same bf16 operands, set before it first ran on a card: a
# product of two bf16 values is exact in float32, so the two differ by the
# order of their float32 sums and by the kernel's one rounding of y to bf16
# (half an ulp: up to 2^-8·|y| for a y just above a power of 2, which
# BF16_ROUND covers exactly; its first run on an H100 read 0.96-0.99 of the
# gate, all of it that rounding at the bottom of a binade). The float32
# term: the
# kernel sums each 64-deep ring stage on the tensor core (which truncates
# the sum it writes, ≤ 2^-23 of it a k16 step, 4 a stage) and adds the
# stage's sums into the tile's in float32 (≤ 2^-24 an add, K/64 of them):
# (4·2^-23 + K/64·2^-24)·Σ|x w| ≈ 1.9e-6·Σ|x w| at K = 1,536, the plain
# version's float32 sums a few 1e-7: 1e-5·Σ|x w| + 1e-6, the float32
# kernel's term, holds both with a margin of 5.
GEMM_REL = 1e-5


# the most bytes `_grouped_sums` pads a call's rows to (a decode step's:
# 40 groups of at most 64 rows at K = 1,536 are 15.7 MB); past it, the
# plain version's loop over the groups
GEMM_CHECK_PAD = 1 << 30


def _grouped_sums(x, w, sizes) -> tuple:
    """(Σ x w, Σ |x| |w|) over each row's group in float32, (M, N) each,
    rows past the groups 0: what `grouped_gemm_ref` gives on x, w and on
    |x|, |w|. Where each group's rows, padded to the largest group's, fit
    in GEMM_CHECK_PAD bytes, as one batched product over the groups (a few
    launches, where the loop takes some a group: phase 13 checks 128 calls
    a granite-moe decode step); else through `grouped_gemm_ref`."""
    import torch

    from repro_torch.kernels.moe_gemm.ref import grouped_gemm_ref

    f32, dev = torch.float32, x.device
    M, K = x.shape
    G, _, N = w.shape
    ends = sizes.to(dev, torch.int64).clamp(min=0).cumsum(0).clamp(max=M)
    counts = ends.diff(prepend=ends.new_zeros(1))
    most, rows = (int(v) for v in torch.stack(
        [counts.max(), ends[-1]]).tolist()) if G else (0, 0)
    if not G or G * most * max(K, N) * 4 > GEMM_CHECK_PAD:
        return (grouped_gemm_ref(x.to(f32), w.to(f32), sizes),
                grouped_gemm_ref(x.abs().to(f32), w.abs().to(f32), sizes))
    gid = torch.repeat_interleave(torch.arange(G, device=dev), counts,
                                  output_size=rows)
    pos = torch.arange(rows, device=dev) - (ends - counts)[gid]
    wf = w.to(f32)
    out = []
    for xs, ws in ((x[:rows].to(f32), wf), (x[:rows].abs().to(f32),
                                             wf.abs())):
        pad = torch.zeros((G, most, K), dtype=f32, device=dev)
        pad[gid, pos] = xs
        full = torch.zeros((M, N), dtype=f32, device=dev)
        full[:rows] = torch.bmm(pad, ws)[gid, pos]
        out.append(full)
    return tuple(out)


def gemm_check(x, w, sizes, got, name: str) -> tuple:
    """(max |Δ|, share of the gate) of one grouped GEMM call on the card
    against its plain version's float32 sums on the same inputs: within
    GEMM_REL·Σ|x w| + 1e-6, plus BF16_ROUND·|ref| for bf16 operands
    (Σ|x w| from the plain version on |x|, |w|; both by `_grouped_sums`)."""
    import torch

    want, mags = _grouped_sums(x, w, sizes)
    want = want.double()
    allowed = GEMM_REL * mags.double() + 1e-6
    del mags
    if x.dtype == torch.bfloat16:
        if got.dtype != torch.bfloat16:
            raise AssertionError(f"{name}: bf16 operands gave {got.dtype}")
        allowed += BF16_ROUND * want.abs()
    out = _within(got, want, allowed, name)
    del want, allowed
    return out


def _zipf_ids(rng, n: int, bins: int, gamma: float = 1.2) -> np.ndarray:
    p = 1.0 / np.arange(1, bins + 1) ** gamma
    return rng.permutation(bins)[rng.choice(bins, size=n, p=p / p.sum())]


# (bins, ids): each route of the histogram kernel on an H100 (227 KB of
# opt-in shared memory a block, 132 SMs): the shared route below 48 KB of
# bins (300, 12,288, 40) and in the opt-in band (50,000), the global route
# past the merge's break-even (49,155 and 800,000 bins: the paths' lookup
# and stage (b)) and past the opt-in limit (60,000)
HIST_PARITY = [(300, 40_000), (12_288, 8_000_000), (50_000, 8_000_000),
               (49_155, 8_192), (800_000, 800_000), (60_000, 2_000_000),
               (40, 1_024), (1, 1)]


def histogram_route_parity(dev) -> str:
    """K1 on each route (`histogram.ops.route`) against its plain version,
    exactly: uniform and Zipf-1.2 ids, weighted (int32 in [-2, 9)) and
    not, 1% of the ids below 0 and 1% past the bins; and ids in a view one
    id into its buffer (not 16-byte aligned). Raises if a route was not
    taken."""
    import torch

    from repro_torch.kernels.histogram.ops import (count_ids, device_limits,
                                                   route)
    from repro_torch.kernels.histogram.ref import histogram_ref

    rng = np.random.default_rng(SEED)
    limits = device_limits(dev.index or 0)
    taken, cases = set(), 0
    for bins, n in HIST_PARITY:
        kind = route(n, bins, limits)[0]
        taken.add(kind if kind == "global" or 4 * bins <= 48 * 1024
                  else "shared opt-in")
        for zipf in (False, True):
            ids = _zipf_ids(rng, n, bins) if zipf else rng.integers(0, bins, n)
            ids[rng.random(n) < 0.01] = -3
            ids[rng.random(n) < 0.01] = bins + 5
            flat = torch.from_numpy(np.r_[0, ids].astype(np.int32)).to(dev)
            wts = torch.from_numpy(rng.integers(-2, 9, n + 1).astype(
                np.int32)).to(dev)
            views = [(flat[1:].clone(), w) for w in (None, wts[1:].clone())]
            if zipf and kind == "global":
                views += [(flat[1:], None), (flat[1:], wts[1:])]
            for k, w in views:
                cases += 1
                if not torch.equal(count_ids(k, bins, weights=w),
                                   histogram_ref(k, bins, w)):
                    raise AssertionError(
                        f"histogram {kind} bins={bins} n={n} zipf={zipf} "
                        f"weighted={w is not None} aligned="
                        f"{k.data_ptr() % 16 == 0} differs")
    if taken != {"shared", "shared opt-in", "global"}:
        raise AssertionError(f"histogram parity took only {taken}")
    return (f"exact on {cases} cases over the routes {sorted(taken)} "
            f"(limits {tuple(limits)})")


def fused_layout_parity(dev) -> float:
    """K3's gather-reduce on each layout (`stage_fused.ops.layout`): w in
    1 ... 1536, float32 and float64, every read op, 300 tasks of arity 0-8
    and one of 1,000 over 97 rows, rows 16-byte aligned and a view one
    value in; min/max/first with NaN, ±inf and ±3e38 values, exact (NaN as
    NaN), add within the sum bound (a·u·Σ|terms| for a task of arity a past
    1e-6/u); the max-arity fill read off indptr and stated (8). Returns the
    worst sum error."""
    import torch

    from repro_torch.kernels.stage_fused.ops import fused_reduce, layout
    from repro_torch.kernels.stage_fused.ref import reduce_pairs_ref

    rng = np.random.default_rng(SEED)
    K, n = 97, 301
    arity = rng.integers(0, 9, n)
    arity[150] = 1000
    indptr = torch.from_numpy(np.r_[0, np.cumsum(arity)].astype(
        np.int32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, K, int(arity.sum())).astype(
        np.int32)).to(dev)
    edge = np.array([np.nan, np.inf, -np.inf, 3e38, -3e38])
    # the sum gate a task: 1e-6, or a·u for a task of arity a, whose pairs
    # add in the values' type in pair order (each add rounds by at most
    # u·Σ|terms|; u = 2^-24 in float32): the arity-1,000 task needs it
    a = torch.from_numpy(arity).to(dev, torch.float64)[:, None]
    rel = {dt: (a * u).clamp(min=1e-6) for dt, u in (
        (torch.float32, 2.0 ** -24), (torch.float64, 2.0 ** -53))}
    worst, layouts = 0.0, set()
    for w in (1, 3, 4, 5, 16, 17, 33, 1536):
        for dt in (torch.float32, torch.float64):
            for read_op in ("add", "min", "max", "first"):
                vals = rng.normal(size=(K * w + 1))
                if read_op != "add":
                    pick = rng.random(vals.size) < 0.05
                    vals[pick] = edge[rng.integers(0, 5, int(pick.sum()))]
                flat = torch.from_numpy(vals).to(dev, dt)
                for values in (flat[:-1].view(K, w), flat[1:].view(K, w)):
                    layouts.add(layout(w, values.element_size(),
                                       values.data_ptr() % 16 == 0))
                    for max_ar in (None, 8):
                        got = fused_reduce(values, indptr, idx,
                                           read_op=read_op, max_arity=max_ar)
                        want = reduce_pairs_ref(values, indptr, idx,
                                                read_op=read_op,
                                                max_arity=max_ar)
                        if read_op == "add":
                            worst = max(worst, _sum_bound_ok(
                                got, want, reduce_pairs_ref(
                                    values.abs(), indptr, idx,
                                    read_op="add"), rel=rel[dt],
                                name=f"fused_reduce add w={w} {dt}"))
                        else:
                            _same_with_nan(got, want, f"fused_reduce "
                                           f"{read_op} w={w} {dt}")
    log(f"  stage_fused: {len(layouts)} layouts (vec, lanes a task, "
        f"vectors a lane) {sorted(tuple(x) for x in layouts)} over w = 1 "
        "... 1536, float32 and float64, every read op, with NaN/±inf/±3e38, "
        "arity 0 and 1,000, rows not 16-byte aligned; exact but sums")
    return worst


def parity_phase(dev) -> dict:
    import torch

    from repro_torch.kernels.segment_combine.ops import combine
    from repro_torch.kernels.segment_combine.ref import combine_ref
    from repro_torch.kernels.stage_fused.ops import (FUSED_READ_OPS,
                                                     fused_reduce,
                                                     fused_stage)
    from repro_torch.kernels.stage_fused.ref import (fused_stage_ref,
                                                     reduce_pairs_ref)

    g = torch.Generator().manual_seed(SEED)
    worst = {"histogram": 0.0, "segment_combine": 0.0, "stage_fused": 0.0}

    # histogram: exact on each route, with ids outside [0, bins) on both
    # sides
    log(f"  histogram: {histogram_route_parity(dev)}")

    # segment combine: min/max/or/write exact, add within the sum bound
    for dt in (torch.float32, torch.float64):
        for n, w, S in [(200_000, 16, 1300), (2000, 3, 200), (1, 1, 1),
                        (511, 8, 13)]:
            vals = torch.randn(n, w, generator=g, dtype=dt).to(dev)
            # S+3 ids: some rows drop; S=1300 over few rows leaves empties
            seg = torch.randint(-1, S + 3, (n,), generator=g,
                                dtype=torch.int32).to(dev)
            for order in (torch.randint(-2**31, 2**31 - 1, (n,), generator=g,
                                        dtype=torch.int64).to(torch.int32),
                          torch.randint(-3, 3, (n,), generator=g,
                                        dtype=torch.int32)):  # ties
                order = order.to(dev)
                for op in ("add", "min", "max", "or", "write"):
                    got = combine(vals, seg, S, op=op, order=order)
                    want = combine_ref(vals, seg, S, op=op, order=order)
                    if op == "add":
                        mags = combine_ref(vals.abs(), seg, S, op="add")
                        e = _sum_bound_ok(got, want, mags)
                        worst["segment_combine"] = max(
                            worst["segment_combine"], e)
                    elif not torch.equal(got, want):
                        raise AssertionError(
                            f"combine {op} {dt} n={n} S={S} differs")
    # Zipf-2.0 hot segments in task order (the warp pre-combine and the
    # per-warp tables), ids outside the range, tied orders
    rng = np.random.default_rng(SEED)
    for dt in (torch.float32, torch.float64):
        for n, w, S in [(300_000, 16, 20_000), (5000, 3, 700),
                        (2000, 1536, 300)]:
            p = 1.0 / np.arange(1, S + 1) ** 2.0
            seg = torch.from_numpy(rng.choice(S, size=n, p=p / p.sum())
                                   .astype(np.int32))
            seg[::97] = S + 1
            vals = torch.randn(n, w, generator=g, dtype=dt).to(dev)
            seg = seg.to(dev)
            order = torch.randint(-3, 3, (n,), generator=g,
                                  dtype=torch.int32).to(dev)
            for op in ("add", "min", "max", "or", "write"):
                got = combine(vals, seg, S, op=op, order=order)
                want = combine_ref(vals, seg, S, op=op, order=order)
                if op == "add":
                    mags = combine_ref(vals.abs(), seg, S, op="add")
                    worst["segment_combine"] = max(
                        worst["segment_combine"],
                        _sum_bound_ok(got, want, mags))
                elif not torch.equal(got, want):
                    raise AssertionError(
                        f"combine {op} {dt} hot n={n} w={w} differs")
    # NaN, ±inf and ±3e38 under min/max/or: NaN propagates, the identity
    # folds into hit segments, as the numpy oracle does
    edge = torch.tensor([np.nan, np.inf, -np.inf, 3e38, -3e38, 1.0, -2.0,
                         0.0], dtype=torch.float64)
    for dt in (torch.float32, torch.float64):
        pick = torch.randint(0, edge.numel(), (4096, 16), generator=g)
        vals = edge.to(dt)[pick]
        vals[torch.rand(4096, 16, generator=g) < 0.7] = 1.5
        seg = torch.randint(-2, 39, (4096,), generator=g,
                            dtype=torch.int32)
        vals, seg = vals.to(dev), seg.to(dev)
        for op in ("min", "max", "or"):
            _same_with_nan(combine(vals, seg, 37, op=op),
                           combine_ref(vals, seg, 37, op=op),
                           f"combine {op} {dt} at NaN/inf")
    log("  segment_combine: 80 random cases, 30 on Zipf-2.0 hot segments "
        "(w = 16, 3, 1536) and 6 at NaN/±inf/±3e38; min/max/or/write exact "
        "(NaN as NaN), add within 1e-6*sum|terms| + 1e-6")

    # fused stage: every read_op x merge; min/max/first reads then a
    # non-add merge are exact, anything with a sum within the sum bound
    def finish(ctx, red):
        return red * ctx[:, :1]

    for n, K, w, S, max_ar in [(5000, 300, 16, 40, 8), (1, 10, 16, 1, 5),
                               (777, 50, 3, 9, 12)]:
        ar = torch.randint(0, max_ar + 1, (n,), generator=g)
        ar[::7] = 0  # arity-0 rows
        indptr = torch.zeros(n + 1, dtype=torch.int32)
        indptr[1:] = torch.cumsum(ar, 0)
        idx = torch.randint(0, K, (int(indptr[-1]),), generator=g,
                            dtype=torch.int32)
        vals = torch.randn(K, w, generator=g).to(dev)
        ctx = torch.randn(n, 2, generator=g).to(dev)
        seg = torch.randint(0, S + 1, (n,), generator=g,
                            dtype=torch.int32).to(dev)
        order = torch.randint(-50, 50, (n,), generator=g,
                              dtype=torch.int32).to(dev)
        indptr, idx = indptr.to(dev), idx.to(dev)
        for read_op in FUSED_READ_OPS:
            for merge in ("add", "min", "max", "or", "write"):
                kw = dict(num_segments=S, read_op=read_op, finish=finish,
                          merge_name=merge)
                ug, cg = fused_stage(vals, indptr, idx, ctx, seg, order, **kw)
                uw, cw = fused_stage_ref(vals, indptr, idx, ctx, seg, order,
                                         **kw)
                if read_op == "add" or merge == "add":
                    um, _ = fused_stage_ref(vals.abs(), indptr, idx,
                                            ctx.abs(), seg, order,
                                            **{**kw, "read_op": "add",
                                               "merge_name": "add"})
                    cm = combine_ref(um, seg, S, op="add") if merge == "add" \
                        else combine_ref(um, seg, S, op="max").clamp(min=0)
                    e = max(_sum_bound_ok(ug, uw, um),
                            _sum_bound_ok(cg, cw, cm))
                    worst["stage_fused"] = max(worst["stage_fused"], e)
                elif not (torch.equal(ug, uw) and torch.equal(cg, cw)):
                    raise AssertionError(
                        f"fused_stage {read_op}x{merge} n={n} differs")
    # min/max reads at NaN and ±3e38, below and at the max arity
    values = torch.tensor([[3e38, 1.0], [np.nan, -3e38], [1.0, np.inf],
                           [-3e38, -np.inf], [2.0, 0.5]], dtype=torch.float64)
    tasks = [[0], [0, 1], [2, 3, 4], [4], [2, 0], [], [3, 3, 3], [0, 2]]
    indptr = torch.tensor(np.r_[0, np.cumsum([len(t) for t in tasks])],
                          dtype=torch.int32)
    idx = torch.tensor([k for t in tasks for k in t], dtype=torch.int32)
    for dt in (torch.float32, torch.float64):
        for read_op in ("min", "max"):
            for max_ar in (None, 3, 5):
                _same_with_nan(
                    fused_reduce(values.to(dt).to(dev), indptr.to(dev),
                                 idx.to(dev), read_op=read_op,
                                 max_arity=max_ar),
                    reduce_pairs_ref(values.to(dt), indptr, idx,
                                     read_op=read_op, max_arity=max_ar),
                    f"fused_reduce {read_op} {dt} at NaN/3e38")
    log("  stage_fused: 60 cases (every read_op x merge, arity-0 rows, a "
        "single-row batch) and 12 min/max reads at NaN/±inf/±3e38 below "
        "and at the max arity; sums within 1e-6*sum|terms| + 1e-6, the "
        "rest exact (NaN as NaN)")
    worst["stage_fused"] = max(worst["stage_fused"],
                               fused_layout_parity(dev))

    # grouped GEMM: tests/test_kernels.py's MOE geometries, its empty-group
    # case, rows beyond the groups' sum, and the path's two shapes
    from repro_torch.kernels.moe_gemm.ref import grouped_gemm_ref

    rng = np.random.default_rng(SEED)
    E, d, f = GRANITE["E"], GRANITE["d"], GRANITE["f"]
    cases = [(f"MOE {geom}", *_gemm_case(geom, rng)) for geom in (
        (4, 96, 32, 64), (1, 1, 64, 128), (6, 150, 128, 256),
        (3, 17, 32, 64), (E, 1024, d, 2 * f), (E, 1024, f, d))]
    cases.append(("empty groups", np.ones((8, 32), np.float32),
                  np.ones((4, 32, 16), np.float32),
                  np.array([0, 8, 0, 0], np.int32)))
    x, w, _ = _gemm_case((5, 57, 24, 40), rng)
    cases.append(("rows beyond the sum", x, w,
                  np.array([11, 0, 20, 9, 0], np.int32)))
    worst["moe_gemm"] = max(gemm_parity(dev, *c[1:], name=c[0])
                            for c in cases)
    log(f"  moe_gemm: {len(cases)} cases (the MOE geometries, empty groups, "
        "rows beyond the sum, the path's in- and out-projection); within "
        "1e-5*sum|x w| + 1e-6")
    # bf16: the same cases with x and w rounded to bf16, granite's
    # decode-step shapes (64 and 80 rows over 40 experts), K and N not
    # multiples of 8, strided weight views (16-byte aligned and not), and
    # gg_sm90's tile walk: x boxes running into the next group, groups of
    # one row, more tiles than the card keeps blocks, sizes all 0, a zero
    # tail of three tiles, negative sizes summing past M. Each case on the
    # kernel its operands route to (`moe_gemm.ops.route`): gg_sm90 where a
    # TMA tensor map can describe them, else gg_bf16.
    from repro_torch import kernels
    from repro_torch.kernels.moe_gemm.ops import route

    bf = [(n, torch.from_numpy(x).to(dev, torch.bfloat16),
           torch.from_numpy(w).to(dev, torch.bfloat16), sz)
          for n, x, w, sz in cases]
    for geom in ((E, 64, d, 2 * f), (E, 80, f, d), (3, 300, 30, 50),
                 (2, 200, 33, 7), (4, 4096, d, 2 * f)):
        x, w, sz = _gemm_case(geom, rng)
        bf.append((f"bf16 {geom}", torch.from_numpy(x).to(dev, torch.bfloat16),
                   torch.from_numpy(w).to(dev, torch.bfloat16), sz))
    G, M, K, N, F = 3, 40, 24, 16, 8
    x, _, sz = _gemm_case((G, M, K, N), rng)
    for offset in (0, 1):
        rows = torch.from_numpy(rng.standard_normal(
            (G, offset + K * N + N * F)).astype(np.float32) * 0.1).to(
            dev, torch.bfloat16)
        w_in = rows[:, offset:offset + K * N].view(G, K, N)
        w_out = rows[:, offset + K * N:].view(G, N, F)
        xb = torch.from_numpy(x).to(dev, torch.bfloat16)
        bf.append((f"bf16 strided w_in, offset {offset}", xb, w_in, sz))
        h = grouped_gemm_ref(xb, w_in.contiguous(), torch.from_numpy(sz))
        bf.append((f"bf16 strided w_out, offset {offset}", h.to(dev),
                   w_out, sz))
    for name, geom, sz in (
            ("straddle", (3, 300, 64, 128), [100, 60, 140]),
            ("groups of 1", (6, 70, 128, 64), [1, 1, 0, 1, 66, 1]),
            ("walk wraps, 64 rows", (E, 4000, 256, 1024), None),
            ("walk wraps, 128 rows", (8, 65536, 64, 1024), None),
            ("sizes all 0", (4, 200, 64, 128), [0, 0, 0, 0]),
            ("zero tail of 3 tiles", (3, 400, 128, 64), [30, 0, 10]),
            ("negative, past M", (4, 500, 64, 192), [-7, 300, 0, 400])):
        x, w, drawn = _gemm_case(geom, rng)
        bf.append((f"bf16 {name} {geom}",
                   torch.from_numpy(x).to(dev, torch.bfloat16),
                   torch.from_numpy(w).to(dev, torch.bfloat16),
                   drawn if sz is None else np.array(sz, np.int32)))
    before = kernels.launches()
    by_route = {"moe_gemm_sm90": [], "moe_gemm_bf16": []}
    for c in bf:
        by_route[route(c[1], c[2])].append(gemm_parity(dev, *c[1:],
                                                       name=c[0]))
    ran = kernels.launches()
    for k, errs in by_route.items():
        if ran[k] - before[k] != len(errs):
            raise AssertionError(f"{k}: {ran[k] - before[k]} launches for "
                                 f"{len(errs)} bf16 cases routed to it")
        worst[k] = max(errs)
    log(f"  bf16 grouped GEMM: {len(bf)} cases (the float32 cases rounded, "
        "granite's decode-step projections, K or N not a multiple of 8, "
        "strided weight views at and off 16 bytes, the tile walk's edges): "
        f"{len(by_route['moe_gemm_sm90'])} on moe_gemm_sm90 (gg_sm90), "
        f"{len(by_route['moe_gemm_bf16'])} on moe_gemm_bf16 (gg_bf16); "
        "within 2^-8*|ref| + 1e-5*sum|x w| + 1e-6 of the plain version's "
        "float32 sums")
    worst.update(attention_ssm_parity(dev))
    worst.update(attention_bwd_parity(dev))
    return worst


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------
def muladd(contexts, vals):
    out = vals * contexts[:, 0:1] + contexts[:, 1:2]
    return {"update": out, "result": out}


def scale_by_context(contexts, reduced):
    return reduced * contexts[:, 0:1]


def _launch(**kw):
    """A stage's launches per kernel: those named, 0 for the rest."""
    return {"histogram": 0, "segment_combine": 0, "stage_fused": 0,
            "moe_gemm": 0, "moe_gemm_sm90": 0, "moe_gemm_bf16": 0,
            "moe_gemm_dx": 0, "moe_gemm_dx_sm90": 0, "moe_gemm_dx_bf16": 0,
            "moe_gemm_dw": 0, "moe_gemm_dw_sm90": 0, "moe_gemm_dw_bf16": 0,
            "flash_attention_tf32": 0,
            "flash_attention_sm90": 0, "flash_attention_bwd_tf32": 0,
            "flash_attention_bwd_bf16": 0,
            "flash_decode": 0, "flash_decode_sm90": 0, "mamba_scan": 0,
            "mamba_scan_bwd": 0, "mamba_scan_bwd_mma": 0, **kw}


# launches of each kernel in each stage of the main path: K1 where Phase 1
# passes the host cutoff (stage b's weighted root call, the replica-local
# pairs of stage d's second stage), K2 once for every stage's writer
# combine, K3 in the ragged stage c
EXPECTED_LAUNCHES = {
    "a": _launch(segment_combine=1),
    "b": _launch(histogram=1, segment_combine=1),
    "c": _launch(segment_combine=1, stage_fused=1),
    "d0": _launch(segment_combine=1),
    "d1": _launch(histogram=1, segment_combine=1),
}


def make_stages(tpm: int):
    """The four stages' task batches (numpy, from the seed)."""
    from repro_torch.core import TaskBatch, fused_read
    from repro_torch.kvstore.ycsb import zipf_keys_stationary as zipf

    rng = np.random.default_rng(SEED)
    n, K = P * tpm, 16 * tpm
    origin = TaskBatch.even_origins(n, P)

    def ctx():
        return rng.standard_normal((n, 2))

    a = TaskBatch(contexts=ctx(), read_keys=zipf(n, K, 2.0, rng,
                                                     rng.permutation(K)),
                  origin=origin)
    b = TaskBatch(contexts=ctx(), read_keys=rng.integers(0, K, n),
                  origin=origin,
                  priority=rng.integers(-2**31 + 1, 2**31 - 1, n))
    arity = rng.integers(1, 9, n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(arity, out=indptr[1:])
    c = TaskBatch(contexts=ctx(), origin=origin, read_indptr=indptr,
                  read_indices=zipf(int(indptr[-1]), K, 1.5, rng,
                                     rng.permutation(K)))
    return K, [
        ("a", "arity-1 zipf2.0 add", a, muladd, "add", None, 1),
        ("b", "arity-1 uniform write", b, muladd, "write", None, 1),
        ("c", "ragged zipf1.5 fused_read(add) min", c,
         fused_read("add", scale_by_context), "min", None, 1),
        ("d", "(a) replicated, 2 stages", a, muladd, "add", True, 2),
    ]


def term_magnitudes(tasks, values, kind: str) -> np.ndarray:
    """Per task, the magnitude of the terms its update sums (float64):
    |v|*|c0| + |c1| for muladd, (sum_i |v_i|)*|c0| for the fused stage."""
    c = np.abs(tasks.contexts)
    if kind == "muladd":
        v = np.zeros((tasks.n, values.shape[1]))
        has = tasks.read_keys >= 0
        v[has] = np.abs(values[tasks.read_keys[has]])
        return v * c[:, 0:1] + c[:, 1:2]
    cs = np.concatenate([np.zeros((1, values.shape[1])),
                         np.cumsum(np.abs(values[tasks.read_indices]), 0)])
    return (cs[tasks.read_indptr[1:]] - cs[tasks.read_indptr[:-1]]) \
        * c[:, 0:1]


def _check_values(name, got, want, old, tasks, mags, merge):
    """Store rows after a stage, torch (float32 on the card, applied to the
    float64 host copy) against the float64 oracle. Tolerance per element:
    |Δ| <= 1e-5*|want| + 1e-6*T + 1e-6, where T is the magnitude of the
    terms that made the row: |old| + Σ|terms| of the segment for add (the
    atomics sum up to hundreds of thousands of terms into a hot key in a
    run-dependent order, so a fixed rtol would be wrong), |old| + the
    largest |term| of the segment for min/max/write (float32 rounding of
    the winning term). Rows no task writes must be bit-identical."""
    wk = tasks.write_keys
    live = wk >= 0
    uniq, inv = np.unique(wk[live], return_inverse=True)
    T = np.zeros((uniq.size, got.shape[1]))
    if merge == "add":
        np.add.at(T, inv, mags[live])
    else:
        np.maximum.at(T, inv, mags[live])
    T += np.abs(old[uniq])
    err = np.abs(got[uniq] - want[uniq])
    allowed = 1e-5 * np.abs(want[uniq]) + 1e-6 * T + 1e-6
    ok = err <= allowed
    if not ok.all():
        i = np.argwhere(~ok)[0]
        raise AssertionError(
            f"stage {name}: key {uniq[i[0]]} col {i[1]} got "
            f"{got[uniq][tuple(i)]} want {want[uniq][tuple(i)]} "
            f"(T={T[tuple(i)]})")
    rest = np.ones(got.shape[0], dtype=bool)
    rest[uniq] = False
    if not np.array_equal(got[rest], want[rest]):
        raise AssertionError(f"stage {name}: an unwritten row changed")
    return float(err.max(initial=0.0)), float((err / allowed).max(initial=0))


class _Stages:
    """Runs the named stages of a path: the kernel launches of each are
    checked against the expected table (on the card), its wall time kept."""

    def __init__(self, device: str, expected: dict):
        self.device, self.expected = device, expected
        self.rows = []

    def run(self, tag: str, fn, **info):
        import torch

        from repro_torch import kernels

        if self.device == "cuda":
            torch.cuda.synchronize()
        before = kernels.launches()
        t0 = time.perf_counter()
        out = fn()
        if self.device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        ran = {k: v - before[k] for k, v in kernels.launches().items()}
        if callable(self.expected.get(tag)):  # known after the stage ran
            self.expected[tag] = self.expected[tag]()
        if self.device == "cuda" and ran != self.expected[tag]:
            raise AssertionError(f"stage {tag}: kernel launches {ran}, "
                                 f"expected {self.expected[tag]}")
        self.rows.append(dict(stage=tag, wall_s=wall, launches=ran, **info))
        return out


def _same_bill(name, a, b) -> None:
    """Cost of the torch run `a` equal to the numpy run `b`'s."""
    if a.report.phase_signature() != b.report.phase_signature():
        raise AssertionError(f"{name}: phase_signature differs")
    if a.refcount != b.refcount:
        raise AssertionError(f"{name}: refcount differs")
    if hasattr(a, "exec_site") and not np.array_equal(a.exec_site,
                                                      b.exec_site):
        raise AssertionError(f"{name}: exec_site differs")


def _timed_backend(be):
    """Wrap a torch backend's device calls to split a stage's wall time
    into device numerics (these calls, synchronized) and the host cost
    model (the rest)."""
    import torch

    be.numerics_s = 0.0
    for meth in ("execute", "apply_writes", "key_counts"):
        inner = getattr(be, meth)

        def timed(*a, _inner=inner, **k):
            t = time.perf_counter()
            out = _inner(*a, **k)
            if be.device.type == "cuda":
                torch.cuda.synchronize(be.device)
            be.numerics_s += time.perf_counter() - t
            return out

        setattr(be, meth, timed)


def main_path(device: str = "cuda", tpm: int = TASKS_PER_MACHINE):
    """Run the four stages through the torch backend and the numpy oracle;
    return (one summary dict per stage, K, stages, initial values). Raises
    on any mismatch. `device="cpu"` runs the plain versions (a rehearsal
    without a card)."""
    from repro_torch.core import DataStore, Orchestrator, TorchBackend

    K, stages = make_stages(tpm)
    rng = np.random.default_rng(SEED + 1)
    init = rng.standard_normal((K, VALUE_WIDTH))
    st_dev = DataStore.create(K, P, value_width=VALUE_WIDTH)
    st_ora = DataStore.create(K, P, value_width=VALUE_WIDTH)
    st_dev.write_rows(np.arange(K), init)
    st = _Stages(device, EXPECTED_LAUNCHES)
    for name, desc, tasks, f, merge, rep, n_stages in stages:
        if name == "d":  # (a) again, from the same starting values
            st_dev.write_rows(np.arange(K), init)
        backend = "torch" if device == "cuda" else TorchBackend(device=device)
        s_dev = Orchestrator(st_dev, backend=backend, replication=rep)
        s_ora = Orchestrator(st_ora, backend="numpy", replication=rep)
        _timed_backend(s_dev.backend)
        kind = "fused" if tasks.max_arity > 1 else "muladd"
        for k in range(n_stages):
            # the oracle starts each stage from the torch store's values
            # (the torch side keeps its device copy), so each check sees
            # only that stage's rounding
            st_ora.write_rows(np.arange(K), st_dev.values)
            old = st_ora.values.copy()
            mags = term_magnitudes(tasks, old, kind)
            s_dev.backend.numerics_s = 0.0
            tag = f"{name}{k}" if n_stages > 1 else name
            r_dev = st.run(tag, lambda: s_dev.run_stage(
                tasks, f, write_back=merge, return_results=True),
                desc=desc, tasks=tasks.n, pairs=tasks.nnz)
            row = st.rows[-1]
            wall = row["wall_s"]
            if s_dev.backend._host_lambdas:
                raise AssertionError(f"stage {tag}: a lambda fell back to "
                                     "the host path")
            t0 = time.perf_counter()
            r_ora = s_ora.run_stage(tasks, f, write_back=merge,
                                    return_results=True)
            wall_ora = time.perf_counter() - t0
            _same_bill(f"stage {tag}", r_dev, r_ora)
            res_err = _sum_bound_ok(
                np.asarray(r_dev.results, dtype=np.float64),
                np.asarray(r_ora.results, dtype=np.float64), mags,
                rel_want=1e-5, name=f"stage {tag} results")
            val_err, val_share = _check_values(
                tag, st_dev.values, st_ora.values, old, tasks, mags, merge)
            numerics = s_dev.backend.numerics_s
            row.update(numerics_s=numerics,
                       host_cost_model_s=wall - numerics,
                       tasks_per_s=tasks.n / wall, oracle_wall_s=wall_ora,
                       max_result_err=res_err, max_value_err=val_err,
                       max_value_err_share_of_tolerance=val_share,
                       replicated_chunks=(s_dev.replicas.num_replicated
                                          if s_dev.replicas is not None
                                          else 0))
            log(f"  stage {tag} ({desc}): {tasks.n} tasks, {tasks.nnz} "
                f"pairs, wall {wall:.3f} s = host cost model "
                f"{wall - numerics:.3f} s + backend calls (device numerics "
                f"with their transfers) {numerics:.3f} s"
                f", {tasks.n / wall:.0f} tasks/s (oracle {wall_ora:.3f} s); "
                f"max |Δ| results {res_err:.3g}, store "
                f"{val_err:.3g} (at most {val_share:.3g} of its tolerance); "
                f"signature/refcount/exec_site equal; launches "
                f"{row['launches']}")
    return st.rows, K, stages, init


# ---------------------------------------------------------------------------
# phase 4: the parameter-server path
# ---------------------------------------------------------------------------
# granite-moe-3b-a800m (src/repro/configs/granite_moe_3b_a800m.py) at full
# width: one of its 32 MoE layers (each layer has the same shapes and chunks
# of its own, so a layer is the unit of depth) and its embedding table. The
# cluster and traffic are benchmarks/bench_paramserve.py's.
GRANITE = dict(E=40, d=1536, f=512, k=8, vocab=49_155)
PS_P = 8
PS_ALPHA = 1.2
PS_SEED = 13
PS_REPLICATE = {"num_hot": 4, "refresh": 1, "decay": 0.5, "min_count": 2.0}
DECODE_T = 128  # tokens a decode step (k = 8 gives 1,024 assignments)
DECODE_STEPS = 4  # the first one cold
COST_T = 16  # decode steps held against the numpy backend (host float64)
EMBED_N = 8192  # ids, bags and gradient rows a stage (bench_paramserve's T)
EMBED_HOT = dict(PS_REPLICATE, num_hot=GRANITE["vocab"] // 64)
# bench_paramserve's own MoE mix (its full setting), where its gate holds
GATE_MIX = dict(E=16, d=32, f=64, k=2, T=512, stages=6)

# launches of each kernel in each stage of the parameter-server path: K1
# once for a decode step's Phase-1 root call and once more for the
# replica-local pairs of a step after the first election; K4 twice per
# naive dispatch (in- and out-projection); K1 once for each embedding
# lookup, whose root call (or, once rows are replicated, whose
# replica-local pairs) passes the backend's sparse-range cutoff, plus K3
# for the bags, K2 for the gradient push, and K1 for embed_skew_aware
PS_EXPECTED = {
    "decode0": _launch(histogram=1), "naive0": _launch(moe_gemm=2),
    "decode1": _launch(histogram=2), "naive1": _launch(moe_gemm=2),
    "decode2": _launch(histogram=2), "naive2": _launch(moe_gemm=2),
    "decode3": _launch(histogram=2), "naive3": _launch(moe_gemm=2),
    "lookup": _launch(histogram=1),
    "bags": _launch(histogram=1, stage_fused=1),
    "update": _launch(segment_combine=1),
    "hot0": _launch(histogram=1), "hot1": _launch(histogram=1),
    "hot2": _launch(histogram=1), "hot3": _launch(histogram=1),
    "skew_aware": _launch(histogram=1),
}


def expert_reference(x, top_i, gates, w_in, w_out) -> np.ndarray:
    """The routed expert mixture in float64 on the host, expert by expert:
    the rows of expert e as one product with w_in[e], silu(gate) * up, the
    product with w_out[e], scaled by their gates and added to their tokens.
    The arithmetic of `MoERouter.oracle` without its dense gather."""
    f = w_out.shape[1]
    y = np.zeros((x.shape[0], w_out.shape[2]))
    for e in np.unique(top_i[top_i >= 0]):
        tok, slot = np.nonzero(top_i == e)
        h = x[tok] @ w_in[e]
        g, up = h[:, :f], h[:, f:]
        act = g * (1.0 / (1.0 + np.exp(-g))) * up
        np.add.at(y, tok, (act @ w_out[e]) * gates[tok, slot][:, None])
    return y


# decode and naive outputs (float32 on the card) against the float64
# reference: the sound runs' worst reading was 1.43e-06 on outputs of
# 0.3-0.5; the naive arm with TF32 products misses it (the control in
# `paramserve_kernel_parity`)
DECODE_REL = 1e-5


def _check_close(name, got, want, rel=DECODE_REL) -> float:
    """|Δ| <= rel * (1 + |want|) per element (float32 against float64)."""
    got = np.asarray(got, dtype=np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{name}: malformed output {got.shape}")
    err = np.abs(got - want)
    if not (err <= rel * (1.0 + np.abs(want))).all():
        raise AssertionError(f"{name}: max |Δ| {err.max()} beyond "
                             f"{rel}*(1+|ref|)")
    return float(err.max(initial=0.0))


def _steady_ratio(router, warm, **sess) -> float:
    """Orchestrated work_ratio (max/mean per-machine work) of the session's
    stages after the first, whose per-machine work was `warm`."""
    work = router.session(**sess).report.per_machine()["work"] - warm
    return float(work.max() / work.mean())


def paramserve_path(device: str = "cuda", f: int | None = None,
                    embed_dim: int | None = None):
    """The MoE decode and embedding stages through the torch backend on
    `device`, checked against float64 references; returns (stage rows,
    summary, tensors for the timing phase). Only this part of phase 4 runs
    between the launch counts' reset and reading: the cost comparison with
    the numpy backend and the gate mix come after, in `paramserve_costs`.
    `f`/`embed_dim` cut the widths for a rehearsal on the CPU
    (``device="cpu"``). The stores keep granite's chunk sizes then: the
    cost model's merge threshold (C = ceil(B / sigma)) reads them, and with
    it which Phase-1 calls pass the cutoff that launches K1."""
    import torch

    from repro_torch.core import TorchBackend
    from repro_torch.core.embedding import embed_skew_aware
    from repro_torch.kvstore.ycsb import zipf_keys_stationary as zipf
    from repro_torch.paramserve import EmbeddingStore, MoERouter

    E, d, k = GRANITE["E"], GRANITE["d"], GRANITE["k"]
    f = GRANITE["f"] if f is None else f
    backend = None if device == "cuda" else TorchBackend(device=device)
    gemm_dev = None if device == "cuda" else device
    st = _Stages(device, PS_EXPECTED)
    summary = {}

    t0 = time.perf_counter()
    router = MoERouter(E, d, f, PS_P, num_layers=1, top_k=k, seed=0)
    router.store.chunk_words = 3 * d * GRANITE["f"]
    router.init_weights(1)
    w_in, w_out = router.layer_weights(0)
    perm = np.random.default_rng(PS_SEED).permutation(E)
    summary["moe_setup_s"] = time.perf_counter() - t0
    sess_kw = dict(backend=backend, replicate=PS_REPLICATE)
    naive_ratio, warm, peak = 0.0, None, []
    for s in range(DECODE_STEPS):
        x, ti, g = router.zipf_routing(DECODE_T, alpha=PS_ALPHA,
                                       seed=PS_SEED + s, rank_perm=perm)
        want = expert_reference(x, ti, g, w_in, w_out)
        if device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        res = st.run(f"decode{s}", lambda: router.decode_step(
            x, ti, g, **sess_kw), pairs=int((ti >= 0).sum()))
        if device == "cuda":
            peak.append(torch.cuda.max_memory_allocated())
        nd = st.run(f"naive{s}", lambda: router.naive_dispatch(
            x, ti, g, gemm="torch", device=gemm_dev))
        st.rows[-2]["max_abs_err"] = _check_close(f"decode{s}", res.y, want)
        st.rows[-1]["max_abs_err"] = _check_close(f"naive{s}", nd.y, want)
        naive_ratio = max(naive_ratio, nd.work_ratio)
        if s == 0:
            warm = router.session(**sess_kw).report.per_machine()[
                "work"].copy()
    sess = router.session(**sess_kw)
    if sess.backend._host_lambdas:
        raise AssertionError("decode: the MoE lambda fell back to the host")
    summary.update(moe_orchestrated_work_ratio=_steady_ratio(
        router, warm, **sess_kw), moe_naive_work_ratio=naive_ratio,
        decode_peak_bytes=peak)
    routing = (x, ti, g, want)
    if summary["moe_orchestrated_work_ratio"] > 1.5:
        raise AssertionError("orchestrated work_ratio "
                             f"{summary['moe_orchestrated_work_ratio']} > 1.5")

    # embedding: granite's table, lookups / bags / gradient push, then a
    # replicating session and its exported hot-row cache
    V, D = GRANITE["vocab"], d if embed_dim is None else embed_dim
    t0 = time.perf_counter()
    store = EmbeddingStore(V, D, PS_P, seed=0)
    store.store.chunk_words = d
    store.init_table(1)
    summary["embed_setup_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(PS_SEED)
    perm_v = rng.permutation(V)
    n = EMBED_N
    ids = zipf(n, V, PS_ALPHA, rng, perm_v)
    table0 = store.table.copy()
    res = st.run("lookup", lambda: store.lookup(ids, backend=backend))
    st.rows[-1]["max_abs_err"] = _check_close(
        "lookup", res.values, table0[ids], rel=1e-6)
    arity = rng.integers(1, 9, n)
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(arity, out=indptr[1:])
    bag_ids = zipf(int(indptr[-1]), V, PS_ALPHA, rng, perm_v)
    res = st.run("bags", lambda: store.lookup_bags((indptr, bag_ids),
                                                   backend=backend),
                 pairs=int(indptr[-1]))
    sums = np.add.reduceat(table0[bag_ids], indptr[:-1], axis=0)
    mags = np.add.reduceat(np.abs(table0[bag_ids]), indptr[:-1], axis=0)
    st.rows[-1]["max_abs_err"] = _sum_bound_ok(res.values, sums, mags,
                                               rel_want=1e-5, name="bags")
    up_ids = zipf(n, V, PS_ALPHA, rng, perm_v)
    grads = rng.standard_normal((n, D))
    st.run("update", lambda: store.update(up_ids, grads, backend=backend))
    want = EmbeddingStore.oracle_update(table0, up_ids, grads)
    tmag = EmbeddingStore.oracle_update(np.abs(table0), up_ids,
                                        np.abs(grads))
    st.rows[-1]["max_abs_err"] = _sum_bound_ok(store.table, want, tmag,
                                               rel_want=1e-5, name="update")
    hot_kw = dict(backend=backend, replicate=EMBED_HOT)
    table1 = store.table.copy()
    hot_ids = [zipf(n, V, PS_ALPHA, rng, perm_v)
               for _ in range(DECODE_STEPS)]
    for s, h in enumerate(hot_ids):
        res = st.run(f"hot{s}", lambda: store.lookup(h, **hot_kw))
        st.rows[-1]["max_abs_err"] = _check_close(
            f"hot{s}", res.values, table1[h], rel=1e-6)
    cache = store.device_cache(**hot_kw, device=device)
    dev = torch.device(device)
    table_dev = torch.from_numpy(table1.astype(np.float32)).to(dev)
    q = zipf(n, V, PS_ALPHA, rng, perm_v)
    q_dev = torch.from_numpy(q.astype(np.int32)).to(dev)
    out, cache2, hit = st.run("skew_aware", lambda: embed_skew_aware(
        table_dev, q_dev, cache))
    lookup = cache.lookup.cpu().numpy()
    want_counts = cache.counts.cpu().numpy() + np.bincount(q, minlength=V)
    if not (torch.equal(out.cpu(), torch.from_numpy(
            table1[q].astype(np.float32)))
            and np.array_equal(cache2.counts.cpu().numpy(), want_counts)
            and float(hit) == float(np.mean(lookup[q] >= 0))):
        raise AssertionError("embed_skew_aware differs from its reference")
    summary.update(
        embed_hot_rows=int(cache.hot_ids.numel()), embed_hit_rate=float(hit),
        embed_replica_local_words=float(store.session(
            **hot_kw).report.replica_local_words))
    for sess in store._sessions.values():
        if sess.backend._host_lambdas:
            raise AssertionError("embedding: a lambda fell back to the host")
    tensors = dict(router=router, perm=perm, routing=routing, store=store,
                   ids=ids, skew_ids=q,
                   bags=(indptr, bag_ids), grads=(up_ids, grads),
                   hot_ids=hot_ids)
    return st.rows, summary, tensors


def paramserve_costs(device: str, t: dict) -> dict:
    """Phase 4's cost half: the decode steps at T = COST_T and every
    embedding stage again on the torch backend (fresh sessions) and on the
    numpy backend — phase_signature, refcount, exec_site and both arms'
    work ratios equal — then bench_paramserve's gate on its own MoE mix."""
    from repro_torch.core import TorchBackend
    from repro_torch.paramserve import EmbeddingStore, MoERouter

    router = t["router"]
    be = TorchBackend(device=None if device == "cuda" else device)
    gemm_dev = None if device == "cuda" else device
    arms = {"torch": dict(backend=be, replicate=PS_REPLICATE),
            "numpy": dict(backend="numpy", replicate=PS_REPLICATE)}
    warm = {}
    for s in range(DECODE_STEPS):
        x, ti, g = router.zipf_routing(COST_T, alpha=PS_ALPHA,
                                       seed=PS_SEED + s, rank_perm=t["perm"])
        a = router.decode_step(x, ti, g, **arms["torch"])
        b = router.decode_step(x, ti, g, **arms["numpy"])
        _same_bill(f"decode T={COST_T} step {s}", a, b)
        _check_close(f"decode T={COST_T} step {s}", a.y, b.y)
        na = router.naive_dispatch(x, ti, g, gemm="torch", device=gemm_dev)
        nb = router.naive_dispatch(x, ti, g)
        if na.work_ratio != nb.work_ratio:
            raise AssertionError("naive work_ratio differs from numpy's")
        _check_close(f"naive T={COST_T} step {s}", na.y, nb.y)
        if s == 0:
            warm = {arm: router.session(**kw).report.per_machine()[
                "work"].copy() for arm, kw in arms.items()}
    ratios = {arm: _steady_ratio(router, warm[arm], **kw)
              for arm, kw in arms.items()}
    if ratios["torch"] != ratios["numpy"]:
        raise AssertionError(f"orchestrated work_ratio differs: {ratios}")

    src = t["store"]
    twins = {arm: EmbeddingStore.from_reference(src) for arm in arms}
    ops = [("lookup", lambda es, kw: es.lookup(t["ids"], **kw), {}),
           ("bags", lambda es, kw: es.lookup_bags(t["bags"], **kw), {}),
           ("update", lambda es, kw: es.update(*t["grads"], **kw), {})]
    ops += [(f"hot{s}", lambda es, kw, h=h: es.lookup(h, **kw),
             {"replicate": EMBED_HOT}) for s, h in enumerate(t["hot_ids"])]
    for name, op, extra in ops:
        got = {arm: op(twins[arm], {"backend": arms[arm]["backend"],
                                    **extra}) for arm in arms}
        _same_bill(f"embedding {name}", got["torch"], got["numpy"])

    c = GATE_MIX
    gate = {}
    for arm, backend in (("torch", be), ("numpy", "numpy")):
        r = MoERouter(c["E"], c["d"], c["f"], PS_P, top_k=c["k"], seed=0)
        r.init_weights(1)
        perm = np.random.default_rng(PS_SEED).permutation(c["E"])
        naive, w0 = 0.0, None
        for s in range(c["stages"]):
            x, ti, g = r.zipf_routing(c["T"], alpha=PS_ALPHA,
                                      seed=PS_SEED + s, rank_perm=perm)
            r.decode_step(x, ti, g, backend=backend, replicate=PS_REPLICATE)
            naive = max(naive, r.naive_dispatch(
                x, ti, g, gemm="torch", device=gemm_dev).work_ratio)
            if s == 0:
                w0 = r.session(backend=backend, replicate=PS_REPLICATE
                               ).report.per_machine()["work"].copy()
        gate[arm] = (_steady_ratio(r, w0, backend=backend,
                                   replicate=PS_REPLICATE), naive)
    if gate["torch"] != gate["numpy"]:
        raise AssertionError(f"gate mix ratios differ: {gate}")
    orch, naive = gate["torch"]
    if not (orch <= 1.5 and naive >= 2.0 and naive >= 2.0 * orch):
        raise AssertionError(f"bench_paramserve gate failed: orchestrated "
                             f"{orch}, naive {naive}")
    return dict(cost_decode_orchestrated_work_ratio=ratios["torch"],
                gate_mix=c, gate_orchestrated=orch, gate_naive=naive)


def paramserve_kernel_parity(dev, t: dict) -> dict:
    """K1-K3 on the card at the parameter-server path's own inputs, each
    against its plain version on the same tensors (after the path's launch
    counts are read, so these launches do not count): K1 over a decode
    step's expert ids (40 bins) and the lookup's ids (49,155 bins, beyond
    the shared-memory budget), unweighted and weighted by multiplicity as
    the Phase-1 root call passes them; K2 adding the update's 8,192
    gradient rows of width 1536 into its segments; K3 pooling the 8,192
    bags over the store's device table. Then a control for the decode
    tolerance: both arms once more with TF32 allowed."""
    import torch

    from repro_torch.core import TorchBackend
    from repro_torch.kernels.histogram.ops import count_ids
    from repro_torch.kernels.histogram.ref import histogram_ref
    from repro_torch.kernels.moe_gemm.ops import grouped_gemm
    from repro_torch.kernels.segment_combine.ops import combine
    from repro_torch.kernels.segment_combine.ref import combine_ref
    from repro_torch.kernels.stage_fused.ops import fused_reduce
    from repro_torch.kernels.stage_fused.ref import reduce_pairs_ref

    def i32(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)

    router, store = t["router"], t["store"]
    x, ti, g, want = t["routing"]
    for ids, bins in ((ti[ti >= 0], router.E), (t["ids"], store.V)):
        uniq, cnt = np.unique(ids, return_counts=True)
        for k, w in ((i32(ids), None), (i32(uniq), i32(cnt))):
            if not torch.equal(count_ids(k, bins, weights=w),
                               histogram_ref(k, bins, w)):
                raise AssertionError(f"histogram: {k.numel()} ids into "
                                     f"{bins} bins differ")
    worst = {"histogram": 0.0}

    up_ids, grads = t["grads"]
    uniq, inv = np.unique(up_ids, return_inverse=True)
    upd = torch.from_numpy(grads.astype(np.float32)).to(dev)
    seg = i32(inv)
    worst["segment_combine"] = _sum_bound_ok(
        combine(upd, seg, uniq.size, op="add"),
        combine_ref(upd, seg, uniq.size, op="add"),
        combine_ref(upd.abs(), seg, uniq.size, op="add"),
        name="segment_combine at the update")

    table = TorchBackend(device=dev).device_values(store.store)
    indptr, bag_ids = (i32(a) for a in t["bags"])
    worst["stage_fused"] = _sum_bound_ok(
        fused_reduce(table, indptr, bag_ids, read_op="add"),
        reduce_pairs_ref(table, indptr, bag_ids, read_op="add"),
        reduce_pairs_ref(table.abs(), indptr, bag_ids, read_op="add"),
        name="stage_fused at the bags")
    log(f"  K1-K3 at the path's inputs against their plain versions: K1 "
        f"exact (decode {router.E} bins, lookup {store.V} bins; weighted "
        f"and not), K2 max |Δ| {worst['segment_combine']:.3g}, K3 "
        f"{worst['stage_fused']:.3g} (within 1e-6*sum|terms| + 1e-6)")
    if dev.type != "cuda":
        return worst
    # the control: TF32 allowed for float32 products, one decode step and
    # one naive dispatch whose grouped GEMMs are the plain version (torch
    # matmuls, which take TF32 then); each one's distance from the limit
    from repro_torch.kernels.moe_gemm.ref import grouped_gemm_ref
    from repro_torch.paramserve import moe

    torch.backends.cuda.matmul.allow_tf32 = True
    moe.grouped_gemm = grouped_gemm_ref
    try:
        runs = {"decode": router.decode_step(
            x, ti, g, backend=TorchBackend(device=dev),
            replicate=PS_REPLICATE).y,
            "naive": router.naive_dispatch(x, ti, g, gemm="torch").y}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        moe.grouped_gemm = grouped_gemm
    for arm, y in runs.items():
        err = np.abs(y - want)
        share = float((err / (DECODE_REL * (1.0 + np.abs(want)))).max())
        worst[f"tf32_{arm}_max_abs_err"] = float(err.max())
        worst[f"tf32_{arm}_share_of_limit"] = share
        log(f"  control, TF32 allowed: {arm} off the float64 reference by "
            f"{err.max():.3g}, {share:.3g}x the limit {DECODE_REL}*(1+|ref|)")
    return worst


def _grouped_rows(x, top_i, num_experts: int):
    """The naive arm's layout: kept assignments sorted by expert (stable),
    their activations as float32, and the per-expert row counts."""
    keep = top_i >= 0
    flat_e = top_i[keep]
    order = np.argsort(flat_e, kind="stable")
    xs = x[np.nonzero(keep)[0][order]].astype(np.float32)
    return xs, np.bincount(flat_e, minlength=num_experts).astype(np.int32)


def moe_gemm_timing(dev, t: dict, launches: int) -> dict:
    """K4 at the path's in-projection (the naive arm of the last decode
    step: M = 1,024, K = 1,536, N = 1,024, G = 40), its out-projection
    (K = 512, N = 1,536), and a prefill-sized in-projection (4,096 tokens,
    M = 32,768): each against its plain version, the one PyTorch call for
    it where the installed torch has one, and its bound in 3xTF32 on the
    tensor cores (with the FMA bound beside it)."""
    import torch

    from repro_torch.core import TorchBackend
    from repro_torch.kernels.moe_gemm.ops import grouped_gemm
    from repro_torch.kernels.moe_gemm.ref import grouped_gemm_ref

    router = t["router"]
    E, d, f = router.E, router.d, router.f
    # the naive arm's operands: views of the store's float32 device rows
    rows = TorchBackend(device=dev).device_values(router.store)[:E]
    w_in = rows[:, :2 * d * f].view(E, d, 2 * f)
    w_out = rows[:, 2 * d * f:].view(E, f, d)
    xs, sizes = _grouped_rows(t["routing"][0], t["routing"][1], E)
    xs, sizes = torch.from_numpy(xs).to(dev), torch.from_numpy(sizes).to(dev)
    h = grouped_gemm(xs, w_in, sizes)
    act = (h[:, :f] * torch.sigmoid(h[:, :f]) * h[:, f:]).contiguous()
    xp, tip, _ = router.zipf_routing(4096, alpha=PS_ALPHA,
                                     seed=PS_SEED + DECODE_STEPS,
                                     rank_perm=t["perm"])
    xp, sizes_p = _grouped_rows(xp, tip, E)
    xp, sizes_p = torch.from_numpy(xp).to(dev), \
        torch.from_numpy(sizes_p).to(dev)
    shapes = []
    for label, x, w, sz in (("in-projection", xs, w_in, sizes),
                            ("out-projection", act, w_out, sizes),
                            ("prefill in-projection", xp, w_in, sizes_p)):
        M, K = x.shape
        N = w.shape[2]
        err = gemm_parity(dev, x, w, sz, label)
        bounds = sz.cpu().numpy()
        used = int((bounds > 0).sum())
        nbytes, ops = 4 * (M * K + used * K * N + M * N + E), 2 * M * K * N
        b_ms, b_by = bound(nbytes, ops, FP32_TC_OPS_PER_S)
        starts = np.r_[0, np.cumsum(bounds)]
        offs = torch.from_numpy(np.cumsum(bounds).astype(np.int32)).to(dev)
        wc = w.contiguous()  # the library call and the loop get stacks

        def loop(x=x, w=wc, starts=starts):
            return [x[starts[g]:starts[g + 1]] @ w[g] for g in range(E)
                    if starts[g + 1] > starts[g]]

        library_ms, note = None, ""
        try:
            lib = torch._grouped_mm(x, wc, offs=offs)
            _sum_bound_ok(lib, grouped_gemm_ref(x, w, sz),
                          grouped_gemm_ref(x.abs(), w.abs(), sz), rel=1e-5)
            library_ms = time_ms(lambda: torch._grouped_mm(x, wc, offs=offs))
        except (RuntimeError, TypeError, AttributeError, AssertionError) as exc:
            note = (f"torch._grouped_mm refuses this call "
                    f"({type(exc).__name__}: {str(exc).splitlines()[0]})")
        shapes.append(dict(
            shape=f"{label}: x ({M}, {K}) float32 over {used} of {E} "
                  f"experts, w ({E}, {K}, {N}) a view of the store's rows",
            max_abs_err=err,
            ms=time_ms(lambda: grouped_gemm(x, w, sz)),
            plain_ms=time_ms(lambda: grouped_gemm_ref(x, w, sz)),
            bound_ms=b_ms, bound_by=b_by,
            bound_fma_ms=bound(nbytes, ops)[0], library_ms=library_ms,
            library_note=note, matmul_loop_ms=time_ms(loop)))
    row = dict(name="moe_gemm", route="cuda",
               source="src/repro_torch/csrc/moe_gemm.cu",
               replaces="src/repro/kernels/moe_gemm/kernel.py:40",
               launches=launches, **shapes[0],
               shapes=shapes)
    row["max_abs_err"] = max(s["max_abs_err"] for s in shapes)
    return row


# row 4b: the bf16 grouped GEMM at granite-moe-3b-a800m's serving shapes, batch
# 8: a prefill of 4,096 tokens a row (32,768 tokens, top-8: 262,144
# assignments) and a decode step (8 tokens: 64 assignments), each token's 8
# experts drawn without replacement, as a router of random weights spreads
# them; the in-projection (K = 1,536, N = 1,024) and the out-projection (K =
# 512, N = 1,536)
GG_BF16_SHAPES = (("prefill in-projection", 32_768, "in"),
                  ("prefill out-projection", 32_768, "out"),
                  ("decode in-projection", 8, "in"),
                  ("decode out-projection", 8, "out"))


def moe_gemm_bf16_timing(dev) -> dict:
    """Row 4b: `gg_sm90` at GG_BF16_SHAPES, each against its plain version
    (`gemm_check`): the call's event time, its host time and its device
    time alone (`_call_times`: the prologue `gg_plan` and `gg_sm90`; two
    tensor maps are encoded a call), the plain version's time,
    `torch._grouped_mm` in bf16 (the same function, checked against the
    plain version at the same gate) and the bound: bytes (x, the routed
    experts' weights and y once, the sizes) at 3.35 TB/s or operations at
    989 TFLOP/s. Beside it (`bf16_route`, row 4c), `gg_bf16` on the same
    operands, which it takes where TMA cannot describe them. `launches` is
    filled in from phase 13's granite run, the kernel's main path."""
    import torch

    from repro_torch.kernels.moe_gemm.ops import _launch, grouped_gemm, route
    from repro_torch.kernels.moe_gemm.ref import grouped_gemm_ref

    E, d, f, k = GRANITE["E"], GRANITE["d"], GRANITE["f"], GRANITE["k"]
    rng = np.random.default_rng(SEED + 4)
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    w = {"in": (torch.randn((E, d, 2 * f), generator=g, device=dev)
                * d ** -0.5).to(torch.bfloat16),
         "out": (torch.randn((E, f, d), generator=g, device=dev)
                 * f ** -0.5).to(torch.bfloat16)}
    shapes = []
    for label, tokens, proj in GG_BF16_SHAPES:
        experts = np.argsort(rng.random((tokens, E)), axis=1)[:, :k]
        sizes_np = np.bincount(experts.reshape(-1), minlength=E).astype(
            np.int32)
        wt = w[proj]
        M, K, N = tokens * k, wt.shape[1], wt.shape[2]
        x = torch.randn((M, K), generator=g, device=dev).to(torch.bfloat16)
        sizes = torch.from_numpy(sizes_np).to(dev)
        if route(x, wt) != "moe_gemm_sm90":
            raise AssertionError(f"{label}: routed to {route(x, wt)}")
        err, share = gemm_check(x, wt, sizes, grouped_gemm(x, wt, sizes),
                                f"moe_gemm_sm90 {label}")
        old_err, old_share = gemm_check(
            x, wt, sizes, _launch(x, wt, sizes, kernel="moe_gemm_bf16"),
            f"moe_gemm_bf16 {label}")
        used = int((sizes_np > 0).sum())
        nbytes = 2 * (M * K + used * K * N + M * N) + 4 * E
        b_ms, b_by = bound(nbytes, 2 * M * K * N, BF16_OPS_PER_S)
        offs = torch.from_numpy(np.cumsum(sizes_np).astype(np.int32)).to(dev)
        library_ms, note = None, ""
        try:
            gemm_check(x, wt, sizes, torch._grouped_mm(x, wt, offs=offs),
                       f"torch._grouped_mm {label}")
            library_ms = time_ms(lambda: torch._grouped_mm(x, wt, offs=offs))
        except (RuntimeError, TypeError, AttributeError,
                AssertionError) as exc:
            note = (f"torch._grouped_mm refuses or misses this call "
                    f"({type(exc).__name__}: {str(exc).splitlines()[0]})")
        shapes.append(dict(
            shape=f"{label}: x ({M}, {K}) bf16 over {used} of {E} experts, "
                  f"w ({E}, {K}, {N}) bf16",
            max_abs_err=err, share_of_gate=share,
            **_call_times(lambda: grouped_gemm(x, wt, sizes)),
            plain_ms=time_ms(lambda: grouped_gemm_ref(x, wt, sizes)),
            bound_ms=b_ms, bound_by=b_by, library_ms=library_ms,
            library_note=note,
            bf16_route=dict(ms=time_ms(lambda: _launch(
                x, wt, sizes, kernel="moe_gemm_bf16")), max_abs_err=old_err,
                share_of_gate=old_share)))
        del x
    torch.cuda.empty_cache()
    row = dict(name="moe_gemm_sm90", route="cuda",
               source="src/repro_torch/csrc/moe_gemm.cu",
               replaces="src/repro/kernels/moe_gemm/kernel.py:40",
               launches=0, **shapes[0], shapes=shapes)
    row["max_abs_err"] = max(s["max_abs_err"] for s in shapes)
    return row


# ---------------------------------------------------------------------------
# B4's backward (dx: the forward's kernels with w read transposed,
# csrc/moe_gemm.cu; dw: csrc/moe_gemm_bwd.cu): parity (phase 2), and times
# and the gate at row 4d's shapes (phase 6)
# ---------------------------------------------------------------------------
# granite-moe-1b-a400m (src/repro/configs/granite_moe_1b_a400m.py) at its
# training shape, batch 4 x 4,096 tokens: 131,072 assignments (top 8) over
# 32 experts, sizes drawn Zipf-GG_BWD_ZIPF; the in-projection (K = N =
# 1,024) and the out-projection (K = 512, N = 1,024)
GRANITE_1B = dict(E=32, d=1024, f=512, k=8, hot=4)
GG_BWD_M = 131_072
GG_BWD_ZIPF = 1.2
# the JAX package differentiates `lax.ragged_dot` (its grouped SwiGLU)
BWD_GEMM_REPLACES = "src/repro/core/spmd.py:70"
BWD_GEMM_SOURCES = {"dx": "src/repro_torch/csrc/moe_gemm.cu",
                    "dw": "src/repro_torch/csrc/moe_gemm_bwd.cu"}


def dx_counter(dtype: str) -> str:
    """The launch counter of B4's dx on aligned operands in `dtype`."""
    return "moe_gemm_dx_sm90" if dtype == "bfloat16" else "moe_gemm_dx"


def dw_counter(dtype: str) -> str:
    """The launch counter of B4's dw on aligned operands in `dtype`."""
    return "moe_gemm_dw_sm90" if dtype == "bfloat16" else "moe_gemm_dw"


def _sizes_zipf(rng, M: int, G: int, gamma: float = GG_BWD_ZIPF):
    """Group sizes of M assignments over G experts, Zipf-skewed, the
    experts' ranks shuffled."""
    return np.bincount(_zipf_ids(rng, M, G, gamma), minlength=G).astype(
        np.int32)


def _grouped_wsums(x, dy, sizes, G: int) -> tuple:
    """(Σ x_gᵀ dy_g, Σ |x_g|ᵀ |dy_g|) per group in float32, (G, K, N)
    each: what `grouped_gemm_bwd_ref` gives for dw on (x, dy) and on
    (|x|, |dy|); groups as the kernels take them (negative sizes as 0,
    rows past M cut)."""
    import torch

    f32 = torch.float32
    M, K = x.shape
    N = dy.shape[1]
    ends = sizes.to(torch.int64).clamp(min=0).cumsum(0).clamp(max=M)
    bounds = [0] + ends.tolist()
    want = torch.zeros((G, K, N), dtype=f32, device=x.device)
    mags = torch.zeros_like(want)
    for g in range(G):
        r0, r1 = bounds[g], bounds[g + 1]
        if r1 > r0:
            xs, ds = x[r0:r1].to(f32), dy[r0:r1].to(f32)
            want[g] = xs.T @ ds
            mags[g] = xs.abs().T @ ds.abs()
    return want, mags


def _bwd_allowed(want, mags, dtype):
    """gemm_check's gate: GEMM_REL·Σ|terms| + 1e-6, plus BF16_ROUND·|ref|
    for a bf16 output."""
    import torch

    allowed = GEMM_REL * mags.double() + 1e-6
    if dtype == torch.bfloat16:
        allowed += BF16_ROUND * want.double().abs()
    return allowed


def dx_check(dy, w, sizes, got, name: str) -> tuple:
    """(max |Δ|, share of the gate) of a dx call against the plain
    version's float32 sums: `gemm_check` on dy and wᵀ."""
    return gemm_check(dy, w.transpose(1, 2), sizes, got, name)


def dw_check(x, dy, sizes, got, name: str, sums=None) -> tuple:
    """(max |Δ|, share of the gate) of a dw call against the plain
    version's float32 sums over each group's rows (`_grouped_wsums`)."""
    want, mags = sums or _grouped_wsums(x, dy, sizes, got.shape[0])
    if got.dtype != x.dtype:
        raise AssertionError(f"{name}: {x.dtype} operands gave {got.dtype}")
    return _within(got, want.double(), _bwd_allowed(want, mags, x.dtype),
                   name)


def _bwd_case(dev, G, M, K, N, sizes, dtype, seed, offset=None):
    """x (M, K), dy (M, N) ~ N(0, 1) and w (G, K, N) ~ N(0, K^-1) in
    `dtype` on the card (w a view into rows N + 8 wide, `offset` values
    in, where given), sizes int32."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((M, K), generator=g, device=dev).to(dtype)
    dy = torch.randn((M, N), generator=g, device=dev).to(dtype)
    if offset is None:
        w = (torch.randn((G, K, N), generator=g, device=dev)
             * K ** -0.5).to(dtype)
    else:
        rows = (torch.randn((G, K * (N + 8) + 8), generator=g, device=dev)
                * K ** -0.5).to(dtype)
        w = rows[:, offset:offset + K * (N + 8)].view(G, K, N + 8)[:, :, :N]
    return x, dy, w, torch.as_tensor(np.asarray(sizes, np.int32),
                                     device=dev)


SPLIT_CASE = "split hot group"


def bwd_gemm_cases(rng) -> list:
    """Phase 2's cases for B4's backward: (name, G, M, K, N, sizes,
    w offset or None)."""
    E, d, f, H = (GRANITE_1B[k] for k in ("E", "d", "f", "hot"))
    M = GG_BWD_M
    uniform = np.bincount(rng.integers(0, E, M), minlength=E).astype(
        np.int32)
    return [
        ("in-projection, Zipf", E, M, d, 2 * f, _sizes_zipf(rng, M, E), None),
        ("out-projection, Zipf", E, M, f, d, _sizes_zipf(rng, M, E), None),
        # the hot path's call: all M assignments gathered, the 4 hot
        # experts' rows first (an eighth of M), the rest the zero tail
        ("hot path, zero tail", H, M, d, 2 * f, uniform[:H], None),
        # a float32-twin-sized step: 2,048 assignments, 64-row tiles
        ("decode-sized tiles", E, 2048, d, 2 * f,
         np.bincount(rng.integers(0, E, 2048), minlength=E), None),
        ("strided w, aligned", 3, 300, 64, 128, [100, 60, 140], 0),
        ("strided w, one value in", 3, 300, 64, 128, [100, 60, 140], 1),
        ("empty groups", 4, 8, 32, 16, [0, 8, 0, 0], None),
        ("rows beyond the sum", 5, 57, 24, 40, [11, 0, 20, 9, 0], None),
        ("negative, past M", 4, 500, 64, 192, [-7, 300, 0, 400], None),
        ("K and N not multiples of 8", 3, 300, 30, 50, [90, 0, 150], None),
        ("sizes all 0", 4, 200, 64, 128, [0, 0, 0, 0], None),
        ("no rows", 3, 0, 64, 128, [0, 0, 0], None),
        # the dw walk on an H100 cuts rows in chunks of 512 here
        # (`dw_chunk_rows`): group 0 is 24 chunks, each boundary inside a
        # sum of `gg_dw_sm90`'s second warpgroup (half a sum later)
        (SPLIT_CASE, 4, 20_000, 256, 256, [12_000, 0, 5_000, 2_900], None),
    ]



def dw_plan_check(scratch: dict, sizes, M: int, name: str) -> int:
    """The plan a dw call used (`_launch_dw(..., scratch=)`) against
    `ops.dw_plan_ref` on the same sizes: every chunk (group, rows, slot) in
    walk order and every split group; raises on a difference. Returns the
    number of split groups."""
    from repro_torch.kernels.moe_gemm import ops

    chunks, splits = ops.dw_plan_ref(sizes, M, scratch["chunk_rows"])
    plan = scratch["plan"].cpu().tolist()
    n, n_split = plan[0][:2]
    base = 1 + scratch["max_chunks"]
    got = ([tuple(r) for r in plan[1:1 + n]],
           [tuple(r[:3]) for r in plan[base:base + n_split]])
    if got != (chunks, splits):
        raise AssertionError(f"dw {name}: the card's plan differs from "
                             f"dw_plan_ref ({n} chunks, {n_split} split "
                             f"groups; want {len(chunks)}, {len(splits)})")
    return n_split


def dw_dropped_chunk(x, dy, sizes, sz, dw, scratch: dict, dtype) -> tuple:
    """dw with one chunk's partial left out of its split group's sum (the
    group with most chunks, its middle chunk), the others added in chunk
    order from the call's workspace: (tag, share of the gate); raises if
    the gate does not see it. `sizes` on the host, `sz` on the card."""
    from repro_torch.kernels.moe_gemm import ops

    _, splits = ops.dw_plan_ref(sizes, x.shape[0], scratch["chunk_rows"])
    g, slot0, n = max(splits, key=lambda sp: (sp[2], -sp[0]))
    ws = scratch["workspace"]
    keep = [c for c in range(n) if c != n // 2]
    part = ws[slot0 + keep[0]].clone()
    for c in keep[1:]:
        part += ws[slot0 + c]
    bad = dw.clone()
    bad[g] = part.to(dw.dtype)
    want, mags = _grouped_wsums(x, dy, sz, dw.shape[0])
    allowed = _bwd_allowed(want, mags, dtype)
    share = float(((bad.double() - want.double()).abs() / allowed).max())
    tag = f"dw without chunk {n // 2} of {n} of group {g}"
    if share <= 1.0:
        raise AssertionError(f"B4 backward's gate ({dtype}) does not see "
                             f"{tag}: {share:.4g} of it")
    return tag, share


def _dw_without(x, dy, dw, g: int, r0: int, r1: int):
    """dw with rows [r0, r1) (of group g) left out of group g's sum."""
    import torch

    bad = dw.float().clone()
    bad[g] -= x[r0:r1].float().T @ dy[r0:r1].float()
    return bad.to(dw.dtype)


def bwd_gemm_bulk_faults(x, dy, w, sizes, dx, dw, dtype) -> dict:
    """At the in-projection case: dw of the largest group without one
    128-row slice of its rows (the middle one), and dx without the rows
    of its smallest nonempty group, each beyond the gate (raises
    otherwise). Returns each fault's share of the gate and each gate's
    median over the median |ref|."""
    import torch

    M = x.shape[0]
    ends = sizes.to(torch.int64).clamp(min=0).cumsum(0).clamp(max=M)
    counts = ends.diff(prepend=ends.new_zeros(1)).tolist()
    starts = [e - c for e, c in zip(ends.tolist(), counts)]
    big = int(np.argmax(counts))
    mid = starts[big] + counts[big] // 2 - 64
    small = min((c, g) for g, c in enumerate(counts) if c > 0)[1]
    want_w, mags_w = _grouped_wsums(x, dy, sizes, w.shape[0])
    allowed_w = _bwd_allowed(want_w, mags_w, dtype)
    want_x, mags_x = _grouped_sums(dy, w.transpose(1, 2), sizes)
    allowed_x = _bwd_allowed(want_x, mags_x, dtype)

    def share(bad, want, allowed) -> float:
        return float(((bad.double() - want.double()).abs() / allowed).max())
    bad_x = dx.clone()
    bad_x[starts[small]:starts[small] + counts[small]] = 0
    faults = {
        f"dw without rows {mid}-{mid + 127} of group {big} "
        f"({counts[big]} rows)": share(
            _dw_without(x, dy, dw, big, mid, mid + 128), want_w, allowed_w),
        f"dx without group {small} ({counts[small]} rows)": share(
            bad_x, want_x, allowed_x)}
    for tag, v in faults.items():
        if v <= 1.0:
            raise AssertionError(f"B4 backward's gate ({dtype}) does not see "
                                 f"{tag}: {v:.4g} of it")
    nz = want_x.abs() > 0
    typical = {"dx": float(allowed_x[nz].median()
                           / want_x.double().abs()[nz].median()),
               "dw": float(allowed_w.median()
                           / want_w.double().abs().median())}
    return {"faults": faults, "gate_over_median_ref": typical}


def moe_gemm_bwd_parity(dev) -> dict:
    """Phase 2 for B4's backward: `bwd_gemm_cases` in bf16 and float32,
    each dx (`_launch_dx`, on the kernel `route_dx` names; none for no
    rows) and dw (`_launch_dw`) launching its counter once and within the
    gate; two calls at the granite shapes give the same bits; the planted
    bulk faults miss the gate. Returns {"worst": max |Δ| per counter,
    "shares": the worst share of the gate per counter and its case,
    "bulk": the faults' shares per dtype}."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels.moe_gemm import ops

    rng = np.random.default_rng(SEED + 28)
    cases = bwd_gemm_cases(rng)
    worst, shares, bulk, splits = {}, {}, {}, {}
    seed = SEED + 2800
    for dtype in (torch.bfloat16, torch.float32):
        for name, G, M, K, N, sizes, offset in cases:
            seed += 1
            x, dy, w, sz = _bwd_case(dev, G, M, K, N, sizes, dtype, seed,
                                     offset)
            scratch = {}
            for part, call, check in (
                    ("dx", lambda: ops._launch_dx(dy, w, sz),
                     lambda got: dx_check(dy, w, sz, got, f"dx {name}")),
                    ("dw", lambda: ops._launch_dw(x, dy, sz, w.shape,
                                                  scratch=scratch),
                     lambda got: dw_check(x, dy, sz, got, f"dw {name}"))):
                counter = (ops.route_dx(dy, w) if part == "dx"
                           else ops.route_dw(x, dy))
                before = kernels.launches()
                got = call()
                torch.cuda.synchronize()
                ran = {k: v - before[k] for k, v in kernels.launches().items()
                       if v != before[k]}
                if ran != ({} if part == "dx" and M == 0 else {counter: 1}):
                    raise AssertionError(f"B4 {part} {name} {dtype}: "
                                         f"launched {ran}")
                e, sh = check(got)
                worst[counter] = max(worst.get(counter, 0.0), e)
                shares[counter] = max(shares.get(counter, (0.0, "")),
                                      (sh, name))
                if part == "dw" and K * N:
                    n_split = dw_plan_check(scratch, sizes, M, name)
                    splits[name] = (n_split, scratch["chunk_rows"])
                if ((M == GG_BWD_M or name == SPLIT_CASE)
                        and not torch.equal(got, call())):
                    raise AssertionError(f"B4 {part} {name} {dtype}: two "
                                         "calls on the same inputs differ")
                if part == "dx":
                    dx = got
                else:
                    dw = got
            if name == "in-projection, Zipf":
                bulk[str(dtype)] = bwd_gemm_bulk_faults(x, dy, w, sz, dx, dw,
                                                        dtype)
            if name == SPLIT_CASE:
                bulk[str(dtype)]["faults"].update(
                    [dw_dropped_chunk(x, dy, sizes, sz, dw, scratch,
                                      dtype)])
                if dtype == torch.bfloat16:  # the other bf16 kernel, split
                    def old():
                        return ops._launch_dw(x, dy, sz, w.shape,
                                              kernel="moe_gemm_dw_bf16")
                    got = old()
                    e, sh = dw_check(x, dy, sz, got, f"gg_dw_bf16 {name}")
                    worst["moe_gemm_dw_bf16"] = e
                    shares["moe_gemm_dw_bf16"] = (sh, name)
                    if not torch.equal(got, old()):
                        raise AssertionError(f"gg_dw_bf16 {name}: two calls "
                                             "on the same inputs differ")
            del x, dy, w, dx, dw, got, scratch
        torch.cuda.empty_cache()
    log(f"  B4 backward: {len(cases)} cases a dtype (granite-moe-1b-a400m's "
        f"in- and out-projection over {GG_BWD_M:,} Zipf-{GG_BWD_ZIPF} rows, "
        "the hot path's call with a 7/8 zero tail, 64-row tiles, strided "
        "w at and off 16 bytes, empty groups, rows beyond the sum, negative "
        "sizes past M, K and N not multiples of 8, no rows, a split hot "
        "group): dx and dw within 2^-8·|ref| (bf16) + 1e-5·Σ|terms| + 1e-6 "
        "of the plain version's float32 sums; worst shares of the gate "
        f"(case) {({k: (round(v, 4), c) for k, (v, c) in shares.items()})};"
        " every dw plan equal to dw_plan_ref (split groups, chunk rows: "
        f"{ {k: v for k, v in splits.items() if v[0]} }); two calls at the "
        "granite shapes and the split case give the same bits")
    for dtype, b in bulk.items():
        log(f"  B4 backward bulk faults ({dtype}), shares of the gate (each "
            f"must pass 1): {({k: round(v, 4) for k, v in b['faults'].items()})}"
            f"; the gate's median over the median |ref| "
            f"{({k: round(v, 4) for k, v in b['gate_over_median_ref'].items()})}")
    return {"worst": worst, "shares": shares, "bulk": bulk, "splits": splits}


# row 4d's shapes: the in-projection (the headline) and the out-projection
GG_BWD_SHAPES = (("in-projection", "in"), ("out-projection", "out"))


def _bwd_gemm_library(part: str, x, dy, w, offs):
    """The one PyTorch call for dx (`torch._grouped_mm(dy, wᵀ)`) or dw
    (`torch._grouped_mm(xᵀ, dy)`, groups along the reduction), or None."""
    import torch

    if part == "dx":
        return lambda: torch._grouped_mm(dy, w.transpose(1, 2), offs=offs)
    xt = x.t()
    return lambda: torch._grouped_mm(xt, dy, offs=offs)


def moe_gemm_bwd_timing(dev, errors: dict) -> list:
    """Row 4d: dx and dw at granite-moe-1b-a400m's training shapes
    (GG_BWD_M Zipf rows over 32 experts) in bf16 and float32: the call's
    event time, host time and device time alone (`queued_device_ms`: at
    these calls torch.profiler dropped some of the kernels' events in
    every session, and `device_ms`'s retries cost ~15 s), the plain
    version's time (`grouped_gemm_bwd_ref`, dx and dw together:
    it computes both), `torch._grouped_mm` for the same product (checked
    against the plain version at the gate first) and the bound: bytes
    (dy, the routed experts' w and dx; x, dy and dw) at 3.35 TB/s or the
    rows inside the groups' operations at 989 TFLOP/s (bf16) or 495/3
    (3xTF32). Beside bf16 dx and dw, `gg_bf16`'s dx and `gg_dw_bf16`'s dw
    on the same operands (the unaligned routes); for dw the walk's chunk
    rows, split groups and workspace. One row per counter; launches are
    filled in by phase 14."""
    import torch

    from repro_torch.kernels.moe_gemm import ops
    from repro_torch.kernels.moe_gemm.ref import grouped_gemm_bwd_ref

    E, d, f = GRANITE_1B["E"], GRANITE_1B["d"], GRANITE_1B["f"]
    rng = np.random.default_rng(SEED + 29)
    by = {}
    for dtype in (torch.bfloat16, torch.float32):
        dt = str(dtype).split(".")[1]
        e = 2 if dtype == torch.bfloat16 else 4
        rate = BF16_OPS_PER_S if e == 2 else FP32_TC_OPS_PER_S
        for i, (label, proj) in enumerate(GG_BWD_SHAPES):
            K, N = (d, 2 * f) if proj == "in" else (f, d)
            sizes = _sizes_zipf(rng, GG_BWD_M, E)
            x, dy, w, sz = _bwd_case(dev, E, GG_BWD_M, K, N, sizes, dtype,
                                     SEED + 2900 + i)
            M = GG_BWD_M
            rows = int(sizes.sum())
            used = int((sizes > 0).sum())
            offs = torch.from_numpy(np.cumsum(sizes).astype(np.int32)).to(dev)
            plain_ms = time_ms(lambda: grouped_gemm_bwd_ref(x, w, sz, dy),
                               reps=1, warmup=1)
            for part in ("dx", "dw"):
                if part == "dx":
                    def call():
                        return ops._launch_dx(dy, w, sz)

                    def check(got, tag):
                        return dx_check(dy, w, sz, got, tag)
                    nbytes = e * (rows * N + used * K * N + M * K) + 4 * E
                    old_kernel = "moe_gemm_dx_bf16"

                    def old():
                        return ops._launch_dx(dy, w, sz, kernel=old_kernel)
                else:
                    sums = _grouped_wsums(x, dy, sz, E)
                    walk = {}
                    ops._launch_dw(x, dy, sz, w.shape, scratch=walk)
                    n_split = int(walk["plan"][0, 1])

                    def call():
                        return ops._launch_dw(x, dy, sz, w.shape)
                    old_kernel = "moe_gemm_dw_bf16"

                    def old():
                        return ops._launch_dw(x, dy, sz, w.shape,
                                              kernel=old_kernel)

                    def check(got, tag, sums=sums):
                        return dw_check(x, dy, sz, got, tag, sums)
                    nbytes = e * (rows * K + rows * N + E * K * N) + 4 * E
                err, share = check(call(), f"row 4d {part} {label} {dt}")
                b_ms, b_by = bound(nbytes, 2 * rows * K * N, rate)
                lib = _bwd_gemm_library(part, x, dy, w, offs)
                library_ms, note = None, ""
                try:
                    check(lib(), f"torch._grouped_mm {part} {label} {dt}")
                    library_ms = time_ms(lib)
                except (RuntimeError, TypeError, AttributeError,
                        AssertionError) as exc:
                    note = (f"torch._grouped_mm refuses or misses this call "
                            f"({type(exc).__name__}: "
                            f"{str(exc).splitlines()[0][:160]})")
                shape = (f"{label}: x ({M}, {K}), dy ({M}, {N}) {dt}, "
                         f"{rows} rows over {used} of {E} experts, w ({E}, "
                         f"{K}, {N})")
                row = dict(shape=shape, max_abs_err=err, share_of_gate=share,
                           ms=time_ms(call, reps=20), host_ms=host_ms(call),
                           device_ms=queued_device_ms(call),
                           plain_ms=plain_ms,
                           plain_note="grouped_gemm_bwd_ref: dx and dw",
                           bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                           operations=2 * rows * K * N,
                           library_ms=library_ms, library_note=note)
                if rate == FP32_TC_OPS_PER_S:
                    row["bound_fma_ms"] = bound(nbytes, 2 * rows * K * N)[0]
                if part == "dw":
                    row["walk"] = dict(
                        chunk_rows=walk["chunk_rows"], split_groups=n_split,
                        blocks=walk["blocks"],
                        workspace_bytes=walk["workspace"].numel() * 4)
                    del walk
                if dtype == torch.bfloat16:  # the unaligned route, the same
                    o_err, o_share = check(old(), f"{old_kernel} {label}")
                    row["bf16_route"] = dict(kernel=old_kernel,
                                             ms=time_ms(old),
                                             max_abs_err=o_err,
                                             share_of_gate=o_share)
                counter = (dx_counter(dt) if part == "dx" else dw_counter(dt))
                by.setdefault(counter, []).append(row)
            del x, dy, w, sums
            torch.cuda.empty_cache()
    rows_out = []
    for name, shapes in by.items():
        worst = max([errors.get(name, 0.0)]
                    + [s["max_abs_err"] for s in shapes])
        part = "dx" if "_dx" in name else "dw"
        rows_out.append(dict(name=name, route="cuda",
                             source=BWD_GEMM_SOURCES[part],
                             replaces=BWD_GEMM_REPLACES, launches=0,
                             **{**shapes[0], "max_abs_err": worst},
                             shapes=shapes))
        for s in shapes:
            lib = (f"{s['library_ms']:.4f}" if s["library_ms"] is not None
                   else f"null ({s['library_note']})")
            fma = (f"; {s['bound_fma_ms']:.4f} in FMAs"
                   if "bound_fma_ms" in s else "")
            old = (f"; {s['bf16_route']['kernel']} {s['bf16_route']['ms']:.4f}"
                   f" ms, {s['bf16_route']['share_of_gate']:.4f} of the gate"
                   if "bf16_route" in s else "")
            if "walk" in s:
                old += (f"; walk: chunks of {s['walk']['chunk_rows']} rows, "
                        f"{s['walk']['split_groups']} split groups, "
                        f"{s['walk']['workspace_bytes']:,} B of workspace, "
                        f"{s['walk']['blocks']} blocks")
            log(f"  {name}: call {s['ms']:.4f} ms (host {s['host_ms']:.4f}),"
                f" device {s['device_ms']:.4f} ms, plain (dx and "
                f"dw) {s['plain_ms']:.4f}, torch._grouped_mm {lib}, bound "
                f"{s['bound_ms']:.4f} by {s['bound_by']}{fma}; "
                f"{s['share_of_gate']:.4f} of the gate{old}; at {s['shape']}")
    return rows_out


# ---------------------------------------------------------------------------
# phase 5: the attention and SSM path
# ---------------------------------------------------------------------------
# The three kernels no model of the JAX package calls (its models run their
# own XLA attention and chunked SSD), driven through their own entry points
# (`repro_torch.kernels.attention`, `decode_attention`, `mamba_ssd`) at the
# widths of the configs that use them, read from `repro_torch.configs`. The
# sequence lengths and batches are the port's shape table
# (`repro_torch.launch.specs.SHAPES`, the JAX package's).
ATTN_DTYPES = ("float32", "bfloat16")  # the configs' compute dtype: bf16
U32 = 2.0 ** -24     # float32 unit roundoff
BF16_ROUND = 2.0 ** -8  # relative rounding of a bf16 output (8-bit mantissa)
# float32 kernel against the float64 plain version: |Δ| <= ATTN_REL·(1 +
# |want|). The output is a convex combination of v rows; float32 scores,
# exponentials and sums over up to ~1,000 rows a lane (decode) or 64-key
# tiles (prefill) leave a relative error of a few 1e-7 (√n·u32), so the JAX
# suite's 2e-5 has a margin of 10x and more. The prefill kernel's 3xTF32
# products carry 21 bits of each operand (under 3·2^-20 a product, the
# tensor core truncating each tile's sums); one TF32 rounding of them would
# miss this gate many times over (tests/test_torch_tf32.py).
ATTN_REL = 2e-5
# SSD float32 against float64: |Δ| <= (SSD_REL + 8·u32·max|l|)·Σ|terms| +
# 1e-6, Σ|terms| being the plain version run on |x|, |B|, |C|. SSD_REL
# covers float32 sums of up to 2·128 + 64 products a term; the max|l| part
# covers the decay's exp(l_t − l_s), whose float32 l_t and l_s each carry
# an absolute error of a few u32·|l| from the cumulative sum.
SSD_REL = 1e-5
MATH_SCORE_BYTES = 20e9  # the library's math backend only below this


def attention_ssm_stages() -> list:
    """The path's five stages, widths from the ported configs."""
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import SHAPES

    z, t, c = (get_config(a) for a in ("zamba2-1.2b", "tinyllama-1.1b",
                                       "command-r-35b"))
    s = z.ssm
    seq = SHAPES["prefill_32k"]["seq"]
    long_T, long_B = SHAPES["long_500k"]["seq"], SHAPES["long_500k"]["batch"]
    dec_T, dec_B = SHAPES["decode_32k"]["seq"], SHAPES["decode_32k"]["batch"]
    return [
        dict(tag="ssd", kernel="mamba_scan", B=2, S=seq,
             nh=s.expand * z.d_model // s.head_dim, hd=s.head_dim,
             ds=s.d_state, chunk=s.chunk,
             source="zamba2-1.2b Mamba2 block, prefill_32k",
             cut="batch 32 -> 2"),
        dict(tag="prefill_mha", kernel="flash_attention", B=1, S=seq, T=seq,
             H=z.n_heads, KV=z.n_kv_heads, hd=z.head_dim,
             source="zamba2-1.2b shared attention, prefill_32k",
             cut="batch 32 -> 1"),
        dict(tag="prefill_gqa128", kernel="flash_attention", B=1, S=8192,
             T=8192, H=c.n_heads, KV=c.n_kv_heads, hd=c.head_dim,
             source="command-r-35b attention, prefill_32k",
             cut="batch 32 -> 1, seq 32768 -> 8192"),
        dict(tag="decode_long", kernel="flash_decode", B=long_B, T=long_T,
             H=z.n_heads, KV=z.n_kv_heads, hd=z.head_dim, length=500_000,
             source="zamba2-1.2b shared attention, long_500k", cut="none"),
        dict(tag="decode_gqa", kernel="flash_decode", B=dec_B, T=dec_T,
             H=t.n_heads, KV=t.n_kv_heads, hd=t.head_dim, length=30_000,
             source="tinyllama-1.1b attention, decode_32k", cut="none"),
    ]


def launched_kernel(kernel: str, dtype: str) -> str:
    """The counter a stage of family `kernel` launches in `dtype`: bf16
    attention, decode and the grouped GEMM take their bf16 tensor-core
    kernels (`*_sm90`), float32 attention the 3xTF32 one
    (`flash_attention_tf32`), float32 decode the SIMT one, the float32 GEMM
    `moe_gemm` (3xTF32); the scan and the histogram have one kernel."""
    if kernel in ("flash_attention", "flash_decode", "moe_gemm") and \
            dtype == "bfloat16":
        return f"{kernel}_sm90"
    if kernel == "flash_attention":
        return "flash_attention_tf32"
    return kernel


# each stage launches its kernel once, in each dtype
ATTN_EXPECTED = {f"{tag}/{dt}": _launch(**{launched_kernel(kernel, dt): 1})
                 for tag, kernel in (("ssd", "mamba_scan"),
                                     ("prefill_mha", "flash_attention"),
                                     ("prefill_gqa128", "flash_attention"),
                                     ("decode_long", "flash_decode"),
                                     ("decode_gqa", "flash_decode"))
                 for dt in ATTN_DTYPES}


def stage_inputs(st: dict, dtype: str, dev, seed: int) -> tuple:
    """A stage's inputs, made on the device from the seed (the bf16 inputs
    are the float32 ones rounded): (q, k, v) for attention, (q, k, v,
    length as a 0-d device tensor) for decode, (x, dt, A, B, C) for the
    scan with dt ~ U(0.01, 0.3) and A ~ −U(0.3, 2.0) in float32."""
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=dev).to(dt)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

    if st["kernel"] == "mamba_scan":
        B, S, nh, hd, ds = (st[k] for k in ("B", "S", "nh", "hd", "ds"))
        return (normal(B, S, nh, hd), uniform(0.01, 0.3, B, S, nh),
                -uniform(0.3, 2.0, nh), normal(B, S, ds), normal(B, S, ds))
    B, T, H, KV, hd = (st[k] for k in ("B", "T", "H", "KV", "hd"))
    if st["kernel"] == "flash_attention":
        return (normal(B, st["S"], H, hd), normal(B, T, KV, hd),
                normal(B, T, KV, hd))
    return (normal(B, H, hd), normal(B, T, KV, hd), normal(B, T, KV, hd),
            torch.tensor(st["length"], dtype=torch.int64, device=dev))


def _kernel_call(st: dict, inputs: tuple):
    from repro_torch.kernels import attention, decode_attention, mamba_ssd

    if st["kernel"] == "mamba_scan":
        return lambda: mamba_ssd(*inputs, chunk=st["chunk"])
    if st["kernel"] == "flash_attention":
        return lambda: attention(*inputs, causal=st.get("causal", True))
    return lambda: decode_attention(*inputs)


def _plain_call(st: dict, inputs: tuple, up=None):
    """The plain version on `inputs` (each float tensor passed through
    `up` first: .double() or .float()); decode runs in slices of 32 batch
    rows, which it treats independently, to bound its float64 copies."""
    import torch

    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.flash_decode.ref import decode_attention_ref
    from repro_torch.kernels.mamba_scan.ref import ssd_scan_ref

    def lift(t):
        return up(t) if up is not None and t.is_floating_point() else t

    if st["kernel"] == "mamba_scan":
        return ssd_scan_ref(*map(lift, inputs), chunk=st["chunk"])
    if st["kernel"] == "flash_attention":
        return attention_ref(*map(lift, inputs),
                             causal=st.get("causal", True))
    q, k, v, length = inputs
    return torch.cat([decode_attention_ref(lift(q[i:i + 32]),
                                           lift(k[i:i + 32]),
                                           lift(v[i:i + 32]), length)
                      for i in range(0, q.shape[0], 32)])


def check_against_plain(st: dict, inputs: tuple, got, dtype: str,
                        name: str) -> tuple:
    """The kernel's output against the plain version on the same inputs:
    in float64 for a float32 run, in float32 for a bf16 run (plus the bf16
    rounding of the kernel's output). Tolerances: ATTN_REL and SSD_REL
    above."""
    import torch

    up = (lambda t: t.double()) if dtype == "float32" else \
        (lambda t: t.float())
    want = _plain_call(st, inputs, up)
    if st["kernel"] == "mamba_scan":
        x, dt, A, Bc, Cc = inputs
        c = min(st["chunk"], x.shape[1])
        max_l = float((dt.double() * A.double()).reshape(
            x.shape[0], -1, c, x.shape[2]).cumsum(2).abs().max().item())
        mags = _plain_call(st, (x.abs(), dt, A, Bc.abs(), Cc.abs()), up)
        allowed = (SSD_REL + 8 * U32 * max_l) * mags.double() + 1e-6
        del mags
    else:
        allowed = ATTN_REL * (1 + want.double().abs())
    if dtype == "bfloat16":
        allowed = allowed + BF16_ROUND * want.double().abs()
    out = _within(got, want, allowed, name)
    big = want.numel() * want.element_size() > 1 << 28
    del want, allowed
    if big:  # a prefill's float64 copies; a decode step's stay cached
        torch.cuda.empty_cache()
    return out


def attention_ssm_parity(dev) -> dict:
    """B5-B7 against their plain versions on the card (phase 2), each
    case in float32 (the 3xTF32 attention kernel, the SIMT decode and scan
    kernels) and bf16 (the tensor-core ones):
    the FLASH, DECODE and MAMBA geometries of tests/test_kernels.py, hd 32,
    64 and 128 causal and not, ragged query tiles (S = 100, 300), non-causal
    S != T, decode with G = 1, 4, 8, 16 and 20 (two bf16 blocks a KV head),
    valid prefixes of 0, 1, T and > T and ending on a cache tile (64, 128)
    as an int and as a device tensor, causal S != T refused, a scan whose
    unmasked decay would overflow (finite), and a scan asked for chunk 256.
    Returns the worst max |Δ| per launched kernel."""
    import torch

    from repro_torch.kernels import attention

    worst = {k: 0.0 for k in KERNEL_SOURCES}
    n = {k: 0 for k in worst}
    seed = SEED

    def run(st, inputs, dtype, name):
        got = _kernel_call(st, inputs)()
        e, _ = check_against_plain(st, inputs, got, dtype, name)
        kernel = launched_kernel(st["kernel"], dtype)
        worst[kernel] = max(worst[kernel], e)
        n[kernel] += 1

    for S, T, H, KV, hd, causal in [
            (128, 128, 4, 4, 64, True), (128, 128, 4, 4, 64, False),
            (256, 256, 8, 2, 64, True), (256, 256, 8, 2, 64, False),
            (128, 128, 4, 1, 128, True), (128, 128, 4, 1, 128, False),
            (64, 64, 2, 2, 32, True), (64, 64, 2, 2, 32, False),
            (100, 100, 4, 2, 64, True), (100, 100, 4, 2, 64, False),
            (300, 300, 4, 2, 128, True), (300, 300, 4, 2, 128, False),
            (48, 80, 4, 2, 32, False), (200, 129, 4, 1, 64, False),
            (130, 384, 8, 2, 128, False)]:
        st = dict(kernel="flash_attention", B=2, S=S, T=T, H=H, KV=KV,
                  hd=hd, causal=causal)
        for dtype in ATTN_DTYPES:
            seed += 1
            run(st, stage_inputs(st, dtype, dev, seed), dtype,
                f"attention {(S, T, H, KV, hd, causal)} {dtype}")
    q = torch.zeros((1, 64, 2, 32), device=dev)
    kv = torch.zeros((1, 128, 2, 32), device=dev)
    try:
        attention(q, kv, kv, causal=True)
    except ValueError:
        pass
    else:
        raise AssertionError("attention took causal S != T")

    for B, T, KV, G, hd, own in [(2, 128, 2, 4, 64, 100),
                                 (1, 256, 1, 8, 64, 256),
                                 (2, 64, 4, 1, 32, 1),
                                 (2, 1000, 2, 16, 128, 700),
                                 (3, 700, 2, 8, 64, 650),
                                 (2, 333, 1, 20, 32, 200)]:
        for length in sorted({0, 1, 64, 128, own, T, T + 5}):
            for dtype in ATTN_DTYPES:
                seed += 1
                st = dict(kernel="flash_decode", B=B, T=T, H=KV * G, KV=KV,
                          hd=hd, length=length)
                q, k, v, dev_len = stage_inputs(st, dtype, dev, seed)
                for ln in (length, dev_len):
                    run(st, (q, k, v, ln), dtype,
                        f"decode {(B, T, KV, G, hd)} length {length} "
                        f"({type(ln).__name__}) {dtype}")

    for S, nh, hd, ds, chunk in [(32, 2, 8, 8, 16), (64, 3, 16, 8, 16),
                                 (128, 1, 32, 16, 32), (256, 2, 64, 64, 256),
                                 (42, 20, 5, 3, 7), (300, 17, 64, 64, 100)]:
        st = dict(kernel="mamba_scan", B=2, S=S, nh=nh, hd=hd, ds=ds,
                  chunk=chunk)
        for dtype in ATTN_DTYPES:
            seed += 1
            inputs = stage_inputs(st, dtype, dev, seed)
            run(st, inputs, dtype, f"ssd {(S, nh, hd, ds, chunk)} {dtype}")
    # dt ~ U(1, 5), A ~ −U(5, 25): l falls by up to ~2,000 within a chunk
    # of 16, so exp(l_t − l_s) for s > t would be inf in float32
    st = dict(kernel="mamba_scan", B=2, S=64, nh=3, hd=16, ds=8, chunk=16)
    x, _, _, Bc, Cc = stage_inputs(st, "float32", dev, seed + 1)
    g = torch.Generator(device=dev).manual_seed(seed + 2)
    dt = 1 + 4 * torch.rand((2, 64, 3), generator=g, device=dev)
    A = -(5 + 20 * torch.rand((3,), generator=g, device=dev))
    run(st, (x, dt, A, Bc, Cc), "float32", "ssd with |dt·A| up to 125")
    log(f"  attention: {n['flash_attention_tf32']} float32 "
        f"(flash_attention_tf32) and "
        f"{n['flash_attention_sm90']} bf16 (flash_attention_sm90) cases "
        "(the FLASH geometries, S = 100 and 300, non-causal S != T), causal "
        f"S != T refused; decode: {n['flash_decode']} float32 "
        f"(flash_decode) and {n['flash_decode_sm90']} bf16 "
        "(flash_decode_sm90) cases (the DECODE geometries, G = 16 at hd "
        "128, G = 20; lengths 0, 1, 64, 128, the geometry's, T, T + 5, as an "
        f"int and a device tensor); mamba_scan: {n['mamba_scan']} cases (the "
        "MAMBA geometries, chunk 256 on S = 256, hd 5 / ds 3 / chunk 7 / 20 "
        "heads, chunk 100 / 17 heads, |dt·A| up to 125); within "
        f"{ATTN_REL}·(1+|ref|) (attention) and ({SSD_REL} + 8·u32·max|l|)·"
        "Σ|terms| + 1e-6 (scan) against float64, plus 2^-8·|ref| for bf16 "
        "against float32 on the same inputs")
    return worst


def attention_ssm_path(dev, stages=None) -> list:
    """Drive the five stages (or `stages`, for a rehearsal at a small size
    on the CPU) in float32 and bf16 through the entry points; on the card
    each stage's launches are checked against ATTN_EXPECTED. Every output
    is held against the plain version (`check_against_plain`). Returns one
    row per stage and dtype."""
    import torch

    on_card = dev.type == "cuda"
    st_runner = _Stages(dev.type, ATTN_EXPECTED)
    for i, st in enumerate(stages or attention_ssm_stages()):
        for dtype in ATTN_DTYPES:
            tag = f"{st['tag']}/{dtype}"
            inputs = stage_inputs(st, dtype, dev, SEED + 100 + i)
            if on_card:
                torch.cuda.reset_peak_memory_stats(dev)
            got = st_runner.run(tag, _kernel_call(st, inputs),
                                source=st["source"], cut=st["cut"])
            row = st_runner.rows[-1]
            # the call's own peak (inputs, output and the kernels' scratch,
            # e.g. the scan's float32 chunk states), before the check
            row["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                                 if on_card else None)
            try:
                err, share = check_against_plain(st, inputs, got, dtype, tag)
            except AssertionError as exc:
                # a second call of the kernel and of the plain version tell
                # an output that changes from call to call from a steady one
                again = _kernel_call(st, inputs)()
                up = (lambda t: t.double()) if dtype == "float32" else \
                    (lambda t: t.float())
                plain = [_plain_call(st, inputs, up) for _ in range(2)]
                raise AssertionError(
                    f"{exc}; a second kernel call is "
                    f"{'' if torch.equal(again, got) else 'not '}identical "
                    f"to the first, two plain calls are "
                    f"{'' if torch.equal(*plain) else 'not '}identical"
                ) from exc
            row.update(max_abs_err=err, share_of_tolerance=share,
                       shape=_stage_shape(st, dtype))
            log(f"  {tag} ({st['source']}; cut: {st['cut']}): "
                f"{row['shape']}; wall {row['wall_s']:.4f} s, max |Δ| "
                f"{err:.3g} ({share:.3g} of its tolerance)"
                + (f", peak device memory {row['peak_bytes'] / 1e9:.2f} GB"
                   if on_card else ""))
            del inputs, got
            torch.cuda.empty_cache()
    return st_runner.rows


def _stage_shape(st: dict, dtype: str) -> str:
    if st["kernel"] == "mamba_scan":
        return (f"x ({st['B']}, {st['S']}, {st['nh']}, {st['hd']}), B/C "
                f"({st['B']}, {st['S']}, {st['ds']}) {dtype}, chunk "
                f"{st['chunk']}")
    if st["kernel"] == "flash_attention":
        return (f"q ({st['B']}, {st['S']}, {st['H']}, {st['hd']}), k/v "
                f"({st['B']}, {st['T']}, {st['KV']}, {st['hd']}) {dtype}, "
                "causal")
    return (f"q ({st['B']}, {st['H']}, {st['hd']}), caches ({st['B']}, "
            f"{st['T']}, {st['KV']}, {st['hd']}) {dtype}, length "
            f"{st['length']}")


def _work(st: dict, dtype: str) -> tuple:
    """(bytes, operations, peak operations/s) of a stage: each input read
    once and the output written once; the operations its data needs (the
    causal half of the scores and of the scan's c x c products, C·Bᵀ once
    per (b, chunk) as its heads share it, the valid prefix of a cache).
    The rate is the one of the units the kernel runs on: bf16 tensor cores,
    3xTF32 on them for float32 attention and the float32 scan, FMAs for
    float32 decode."""
    e = 2 if dtype == "bfloat16" else 4
    rate = BF16_OPS_PER_S if dtype == "bfloat16" else (
        FP32_TC_OPS_PER_S if st["kernel"] in ("flash_attention", "mamba_scan")
        else FP32_OPS_PER_S)
    if st["kernel"] == "mamba_scan":
        B, S, nh, hd, ds, c = (st[k] for k in ("B", "S", "nh", "hd", "ds",
                                                "chunk"))
        pairs = c * (c + 1) // 2
        ops = B * (S // c) * (2 * pairs * ds
                              + nh * (2 * pairs * hd + 4 * c * hd * ds))
        return e * (2 * B * S * nh * hd + 2 * B * S * ds) \
            + 4 * (B * S * nh + nh), ops, rate
    B, T, H, KV, hd = (st[k] for k in ("B", "T", "H", "KV", "hd"))
    if st["kernel"] == "flash_attention":
        S = st["S"]
        return e * (2 * B * S * H * hd + 2 * B * T * KV * hd), \
            4 * hd * B * H * S * (S + 1) // 2, rate
    n_valid = T if st["length"] <= 0 else min(st["length"], T)
    return e * (2 * B * H * hd + 2 * B * n_valid * KV * hd) + 8, \
        4 * B * H * n_valid * hd, rate


def _library_call(st: dict, inputs: tuple):
    """One PyTorch call computing the stage's function, on inputs laid out
    as it takes them (made here, outside the timing), or (None, note). The
    math backend only where its float32 score tensor stays under
    MATH_SCORE_BYTES (it is what takes GQA in float32)."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    if st["kernel"] == "mamba_scan":
        return None, ("no one PyTorch call computes the SSD scan (a "
                      "chunked scan with a decaying state)")
    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                SDPBackend.CUDNN_ATTENTION]
    if st["kernel"] == "flash_attention":
        q, k, v = (t.transpose(1, 2).contiguous() for t in inputs)
        if 4 * q.shape[0] * q.shape[1] * q.shape[2] * k.shape[2] \
                <= MATH_SCORE_BYTES:
            backends.append(SDPBackend.MATH)

        def call():
            with sdpa_kernel(backends):
                return F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True).transpose(1, 2)
        return call, ("F.scaled_dot_product_attention(is_causal=True, "
                      "enable_gqa=True), (B, H, S, hd) layout")
    q, k, v, length = inputs
    B, H, hd = q.shape
    KV = k.shape[2]
    # the G query heads of a KV head as G query rows: no expanded cache
    q4 = q.reshape(B, KV, H // KV, hd)
    kt, vt = (t.transpose(1, 2).contiguous() for t in (k, v))
    mask = (torch.arange(k.shape[1], device=q.device) < length)[None, None,
                                                                None]

    def call():
        with sdpa_kernel(backends):
            return F.scaled_dot_product_attention(
                q4, kt, vt, attn_mask=mask).reshape(B, H, hd)
    return call, ("F.scaled_dot_product_attention with a boolean prefix "
                  "mask, the G query heads of a KV head as G query rows")


def time_auto(fn) -> float:
    """time_ms with as many runs as fit in about a second (3 to 10)."""
    import torch

    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t
    reps = int(max(3, min(10, 1.0 / max(once, 1e-6))))
    return time_ms(fn, reps=reps, warmup=1)


KERNEL_SOURCES = {
    "flash_attention_tf32": ("src/repro_torch/csrc/flash_attention_tf32.cu",
                             "src/repro/kernels/flash_attention/kernel.py:75"),
    "flash_attention_sm90": ("src/repro_torch/csrc/flash_attention_sm90.cu",
                             "src/repro/kernels/flash_attention/kernel.py:75"),
    "flash_decode": ("src/repro_torch/csrc/flash_decode.cu",
                     "src/repro/kernels/flash_decode/kernel.py:60"),
    "flash_decode_sm90": ("src/repro_torch/csrc/flash_decode.cu",
                          "src/repro/kernels/flash_decode/kernel.py:60"),
    "mamba_scan": ("src/repro_torch/csrc/mamba_scan.cu",
                   "src/repro/kernels/mamba_scan/kernel.py:58"),
}


def attention_ssm_timing(dev, launches: dict, errors: dict) -> list:
    """B5-B7 at every stage of the path, in float32 and bf16: the kernel,
    its plain version (on the same inputs, so computing in float32), the one
    PyTorch call for it (checked against the plain version first), and the
    bound (bytes over 3.35 TB/s, or operations at the rate `_work` gives:
    989 TFLOP/s in bf16, 495/3 in 3xTF32, 67 in float32 FMAs; a 3xTF32
    kernel's row also carries the FMA bound, `bound_fma_ms`). One row per
    kernel; its first shape is the headline, the rest are under
    `shapes`."""
    import torch

    by_kernel = {k: [] for k in KERNEL_SOURCES}
    for i, st in enumerate(attention_ssm_stages()):
        for dtype in ATTN_DTYPES:
            inputs = stage_inputs(st, dtype, dev, SEED + 100 + i)
            run, plain = _kernel_call(st, inputs), \
                (lambda st=st, inputs=inputs: _plain_call(st, inputs))
            nbytes, ops, rate = _work(st, dtype)
            b_ms, b_by = bound(nbytes, ops, rate)
            fma = ({"bound_fma_ms": bound(nbytes, ops)[0]}
                   if rate == FP32_TC_OPS_PER_S else {})
            lib, note = _library_call(st, inputs)
            library_ms = None
            if lib is not None:
                try:
                    want = plain()
                    got = lib()
                    _within(got, want, 3e-2 * (1 + want.double().abs()),
                            f"library {st['tag']}")
                    del want, got
                    library_ms = time_auto(lib)
                except (RuntimeError, AssertionError) as exc:
                    note += (f"; refused or off: {type(exc).__name__}: "
                             f"{str(exc).splitlines()[0][:160]}")
            by_kernel[launched_kernel(st["kernel"], dtype)].append(dict(
                stage=st["tag"], dtype=dtype,
                shape=f"{st['tag']}: {_stage_shape(st, dtype)}",
                ms=time_auto(run), plain_ms=time_auto(plain),
                bound_ms=b_ms, bound_by=b_by, **fma, bytes=nbytes,
                operations=ops, library_ms=library_ms, library_note=note))
            del inputs, run, plain, lib
            torch.cuda.empty_cache()
    rows = []
    for name, shapes in by_kernel.items():
        source, replaces = KERNEL_SOURCES[name]
        rows.append(dict(name=name, route="cuda", source=source,
                         replaces=replaces, launches=launches[name],
                         **shapes[0], max_abs_err=errors[name],
                         shapes=shapes))
        for s in shapes:
            lib = (f"{s['library_ms']:.4f}" if s["library_ms"] is not None
                   else f"null ({s['library_note']})")
            fma = (f"; {s['bound_fma_ms']:.4f} in FMAs"
                   if "bound_fma_ms" in s else "")
            log(f"  {name}: {s['ms']:.4f} ms (plain {s['plain_ms']:.4f}, "
                f"library {lib}, bound {s['bound_ms']:.4f} by "
                f"{s['bound_by']}{fma}) at {s['shape']}")
    return rows


# ---------------------------------------------------------------------------
# B5's backward (csrc/flash_attention_bwd_sm90.cu for bf16,
# csrc/flash_attention_bwd_tf32_sm90.cu for float32): parity (phase 2), and
# times and
# the gate at row 5c's shapes (phase 6)
# ---------------------------------------------------------------------------
# The backward against `attention_bwd_ref` on the same q, k, v, out, lse and
# dout: each of dq, dk, dv within a·|ref| + b·Σ|terms|, Σ|terms| the plain
# version's magnitudes (|dS|·|k|, |dS|ᵀ·|q| and Pᵀ·|dO|). bf16 against
# float32: 2^-8·|ref| + 2^-7·Σ|terms| with |dS| taken as P ⊙ (|dP| + |D|)
# (`terms="values"`): dP and D sum exact bf16 products in float32, so the
# errors are each output's rounding (bf16's unit roundoff, 2^-8 of |ref|),
# P and dS rounded to bf16 once (2^-8 of each term), and the kernel's and
# the plain version's float32 sums of up to 2^15 terms in other orders
# (2^-9 of Σ|terms| each). The gate is 0.20 / 0.64 / 0.80 of the median
# |ref| of dq / dk / dv at (1, 4096, 8, 1, 64, causal) on N(0, 1) inputs;
# `bwd_bulk_faults` shows dk without one middle query tile of one head,
# and without one of the 8 query heads, missing it there.
# tests/test_torch_flash_bwd.py holds the bf16 arithmetic, emulated,
# against JAX's `_flash_bwd_rule` at this gate and shows planted faults
# missing it. float32 against float64: 2e-5·(|ref| + Σ|terms|) with |dS|
# taken as P ⊙ (|dO|·|v|ᵀ + Σ|dO ⊙ O|) (`terms="products"`): 3xTF32
# products (~2^-19 of each term, dP's own included), the scores' error
# through exp, float32 sums a step.
ATTN_BWD_REL = 2e-5
ATTN_BWD_BF16 = (BF16_ROUND, 2 * BF16_ROUND)  # (on |ref|, on Σ|terms|)
BWD_SOURCES = {"bfloat16": "src/repro_torch/csrc/flash_attention_bwd_sm90.cu",
               "float32":
               "src/repro_torch/csrc/flash_attention_bwd_tf32_sm90.cu"}
# each kernel of a backward call, by a part of its device event's name
BWD_PARTS = {"pre": "fa_bwd_pre", "dkdv": "fa_bwd_dkdv", "dq": "fa_bwd_dq"}
# the JAX package's flash backward: the rule of its custom VJP `_flash_xla`
BWD_REPLACES = "src/repro/models/attention.py:137"
# (B, S, H, KV, hd, causal): hd 32 / 64 / 128, GQA 1 / 4 / 8, causal and
# not, S = 1,000 (ragged tiles) and 4,096
BWD_PARITY = [(2, 1000, 8, 8, 32, True), (2, 1000, 8, 8, 32, False),
              (2, 1000, 16, 4, 64, True), (2, 1000, 16, 4, 64, False),
              (2, 1000, 8, 1, 128, True), (2, 1000, 8, 1, 128, False),
              (1, 4096, 8, 1, 64, True), (1, 4096, 4, 4, 128, False),
              (1, 4096, 8, 2, 32, True)]


def bwd_counter(dtype: str) -> str:
    """The launch counter of B5's backward in `dtype`."""
    return ("flash_attention_bwd_bf16" if dtype == "bfloat16"
            else "flash_attention_bwd_tf32")


def bwd_split(events: dict, source: str, parts: dict = BWD_PARTS):
    """A backward call's device ms by kernel (`parts`: {part: a substring
    of its kernel's name}) from `device_ms`'s events by name; the rest
    (fills, allocations, sums) as "other". None where `device_ms` fell back
    to CUDA events (`source` not "profiler"): those have no events by
    name."""
    if source != "profiler":
        return None
    out = {k: 0.0 for k in (*parts, "other")}
    for name, ms in events.items():
        part = next((k for k, v in parts.items() if v in name), "other")
        out[part] += ms
    return out


def bwd_inputs(dev, B, S, H, KV, hd, causal, dtype: str, seed: int,
               kernel_forward: bool = False) -> tuple:
    """(q, k, v, out, lse, dout): q, k, v, dout in `dtype` made on the
    device from the seed; out (in dtype) and lse (float32) from the plain
    forward (float32 on bf16 values, float64 on float32 ones), or from the
    forward kernel with `kernel_forward` (what training hands the
    backward)."""
    import torch

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_ref

    g = torch.Generator(device=dev).manual_seed(seed)
    dt = getattr(torch, dtype)
    q, dout = (torch.randn((B, S, H, hd), generator=g, device=dev).to(dt)
               for _ in range(2))
    k, v = (torch.randn((B, S, KV, hd), generator=g, device=dev).to(dt)
            for _ in range(2))
    if kernel_forward:
        out, lse = ops._forward(q, k, v, causal, True)
    else:
        up = (lambda t: t.float()) if dtype == "bfloat16" else \
            (lambda t: t.double())
        out, lse = attention_ref(up(q), up(k), up(v), causal=causal,
                                 return_lse=True)
    return q, k, v, out.to(dt), lse.float(), dout


def bwd_gate(inputs: tuple, causal: bool) -> tuple:
    """(want, allowed) for (dq, dk, dv): `attention_bwd_ref` on the same
    inputs (float32 for bf16, float64 for float32) and each element's gate,
    ATTN_BWD_BF16 on terms="values" or ATTN_BWD_REL on terms="products"."""
    import torch

    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    if inputs[0].dtype == torch.bfloat16:
        (rel, rel_terms), terms, up = ATTN_BWD_BF16, "values", torch.float32
    else:
        rel = rel_terms = ATTN_BWD_REL
        terms, up = "products", torch.float64
    want, mags = attention_bwd_ref(*(t.to(up) for t in inputs),
                                   causal=causal, terms=terms)
    allowed = tuple(rel * w.double().abs() + rel_terms * m.double()
                    for w, m in zip(want, mags))
    return want, allowed


def bwd_check(got, inputs: tuple, causal: bool, name: str,
              gate: tuple | None = None) -> tuple:
    """(max |Δ|, share of the gate) of (dq, dk, dv) against `bwd_gate`'s
    (`gate` where given); raises past it."""
    want, allowed = gate or bwd_gate(inputs, causal)
    out = [_within(g, w, a, f"{name} {n}")
           for n, g, w, a in zip(("dq", "dk", "dv"), got, want, allowed)]
    return max(e for e, _ in out), max(s for _, s in out)


# a bulk fault at phase 2's GQA-8 case at S = 4,096: one middle query tile
# (query head 3, rows 2,048-2,111) or one query head (7) left out of dk;
# each missing part is `attention_bwd_ref` with dout zeroed outside it
# (the backward is linear in dout)
BWD_BULK_CASE = (1, 4096, 8, 1, 64, True)
BWD_BULK_TILE = (3, 2048, 2112)
BWD_BULK_HEAD = 7


def bwd_bulk_faults(dev, dtype: str, seed: int) -> dict:
    """At BWD_BULK_CASE: the kernel's output within the gate, and dk without
    one middle query tile of one head, and without one query head, each
    beyond it (raises otherwise). dv without that tile is read, not gated.
    Returns each fault's share of the gate (max |Δ| / allowed) and the
    gate's median over the median |ref| of dq, dk, dv."""
    import torch

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    inputs = bwd_inputs(dev, *BWD_BULK_CASE, dtype, seed)
    got = ops._backward(*inputs, True)
    gate = bwd_gate(inputs, True)
    want, allowed = gate
    bwd_check(got, inputs, True, f"bulk-fault case {dtype}", gate)
    q, k, v, out, lse, dout = inputs
    up = want[0].dtype

    def part(h: int, r0: int, r1: int) -> tuple:  # (dk, dv) of those rows
        dm = torch.zeros_like(dout)
        dm[:, r0:r1, h] = dout[:, r0:r1, h]
        return attention_bwd_ref(*(t.to(up) for t in (q, k, v, out, lse,
                                                      dm)), causal=True)[1:]

    def share(i: int, bad) -> float:
        bad = bad.to(got[i].dtype).double()
        return float(((bad - want[i].double()).abs() / allowed[i]).max())
    tile_dk, tile_dv = part(*BWD_BULK_TILE)
    head_dk, _ = part(BWD_BULK_HEAD, 0, BWD_BULK_CASE[1])
    faults = {"dk without a query tile": share(1, got[1].to(up) - tile_dk),
              "dk without a query head": share(1, got[1].to(up) - head_dk),
              "dv without a query tile": share(2, got[2].to(up) - tile_dv)}
    for tag in ("dk without a query tile", "dk without a query head"):
        if faults[tag] <= 1.0:
            raise AssertionError(f"the backward's gate ({dtype}) does not "
                                 f"see {tag}: {faults[tag]:.4g} of it")
    typical = {n: float(a.median() / w.double().abs().median())
               for n, w, a in zip(("dq", "dk", "dv"), want, allowed)}
    return {"faults": faults, "gate_over_median_ref": typical}


def attention_bwd_parity(dev) -> dict:
    """Phase 2's backward cases (BWD_PARITY, bf16 and float32): each call
    launches its kernel once and lands within `bwd_check`'s gate; one dk
    tile zeroed must miss it. Returns the worst max |Δ| per counter."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels.flash_attention import ops

    worst = {bwd_counter(d): 0.0 for d in ATTN_DTYPES}
    shares = {k: (0.0, None) for k in worst}
    seed = SEED + 500
    for geom in BWD_PARITY:
        causal = geom[-1]
        for dtype in ATTN_DTYPES:
            seed += 1
            inputs = bwd_inputs(dev, *geom, dtype, seed)
            before = kernels.launches()
            got = ops._backward(*inputs, causal)
            torch.cuda.synchronize()
            name = bwd_counter(dtype)
            ran = {k: v - before[k] for k, v in kernels.launches().items()
                   if v != before[k]}
            if ran != {name: 1}:
                raise AssertionError(f"attention backward {geom} {dtype}: "
                                     f"launched {ran}")
            e, share = bwd_check(got, inputs, causal,
                                 f"attention backward {geom} {dtype}")
            worst[name] = max(worst[name], e)
            shares[name] = max(shares[name], (share, geom))
            del inputs, got
    for dtype in ATTN_DTYPES:  # the planted fault: one dk tile zeroed
        inputs = bwd_inputs(dev, 1, 1000, 8, 2, 64, True, dtype, seed + 1)
        dq, dk, dv = ops._backward(*inputs, True)
        dk[:, 64:128] = 0
        try:
            bwd_check((dq, dk, dv), inputs, True, "planted fault")
        except AssertionError:
            continue
        raise AssertionError(f"the backward's gate ({dtype}) does not see "
                             "a zeroed dk tile")
    bulk = {d: bwd_bulk_faults(dev, d, seed + 2) for d in ATTN_DTYPES}
    # the training step's restore gate (phase 14) needs the same bits from
    # the same inputs: two calls a dtype at the training shape (hd 64) and
    # at prefill_gqa128 (hd 128: the float32 kernels' 32-key tiles)
    repeats = [st for st in bwd_timing_shapes()
               if st["tag"] in ("train_tinyllama", "prefill_gqa128")]
    for st in repeats:
        for dtype in ATTN_DTYPES:
            inputs = bwd_inputs(dev, st["B"], st["S"], st["H"], st["KV"],
                                st["hd"], True, dtype, seed + 3,
                                kernel_forward=True)
            first = ops._backward(*inputs, True)
            again = ops._backward(*inputs, True)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(first, again)):
                raise AssertionError(
                    f"attention backward at {st['tag']}: two {dtype} calls "
                    "on the same inputs differ")
            del inputs, first, again
            torch.cuda.empty_cache()
    log(f"  attention backward: {len(BWD_PARITY)} cases a dtype (hd 32 / 64 "
        "/ 128, GQA 1 / 4 / 8, causal and not, S = 1,000 and 4,096) on "
        "flash_attention_bwd_bf16 and _tf32, dq / dk / dv within "
        "2^-8·|ref| + 2^-7·Σ|terms| (bf16 against float32, |dS| as "
        f"P ⊙ (|dP| + |D|)) and {ATTN_BWD_REL}·(|ref| + Σ|terms|) (float32 "
        "against float64, |dS| as P ⊙ (|dO|·|v|ᵀ + Σ|dO ⊙ O|)); worst "
        "shares of the gate (case) "
        f"{({k: (round(v, 4), c) for k, (v, c) in shares.items()})}; a "
        "zeroed dk tile misses the gate in both dtypes; two calls a dtype "
        f"at {' and '.join(st['tag'] for st in repeats)} give the same "
        "bits")
    for dtype, b in bulk.items():
        typical = {k: round(v, 4) for k, v in
                   b["gate_over_median_ref"].items()}
        log(f"  bulk faults at {BWD_BULK_CASE} {dtype}, shares of the gate "
            f"(dk ones must pass 1): "
            f"{({k: round(v, 4) for k, v in b['faults'].items()})}; the "
            f"gate's median over the median |ref| (dq, dk, dv) {typical}")
    return worst


def bwd_timing_shapes() -> list:
    """Row 5c's shapes: tinyllama-1.1b's training step (phase 14), and
    phase 5's prefill_mha and prefill_gqa128 stages."""
    from repro_torch.configs import get_config

    t = get_config("tinyllama-1.1b")
    out = [dict(tag="train_tinyllama", B=TRAIN_BATCH, S=TRAIN_SEQ,
                H=t.n_heads, KV=t.n_kv_heads, hd=t.head_dim,
                source="tinyllama-1.1b training step (phase 14)")]
    for st in attention_ssm_stages():
        if st["tag"] in ("prefill_mha", "prefill_gqa128"):
            out.append(dict(tag=st["tag"], B=st["B"], S=st["S"], H=st["H"],
                            KV=st["KV"], hd=st["hd"], source=st["source"]))
    return out


def _bwd_work(st: dict, dtype: str) -> tuple:
    """(bytes, operations, rate) of one causal backward: q, k, v, out, dout
    and lse read once, dq, dk, dv written once; 2.5 times the forward's
    operations (Sᵀ and dPᵀ again, dq, dk, dv over the causal half)."""
    B, S, H, KV, hd = (st[k] for k in ("B", "S", "H", "KV", "hd"))
    e = 2 if dtype == "bfloat16" else 4
    nbytes = e * (4 * B * S * H * hd + 4 * B * S * KV * hd) + 4 * B * H * S
    ops = 10 * hd * B * H * S * (S + 1) // 2
    return nbytes, ops, (BF16_OPS_PER_S if dtype == "bfloat16"
                         else FP32_TC_OPS_PER_S)


def _bwd_library(q, k, v, dout):
    """The backward alone of `F.scaled_dot_product_attention(is_causal=True,
    enable_gqa=True)` in its (B, H, S, hd) layout, as a call, or (None,
    note) where no backend takes the inputs."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    backends = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                SDPBackend.CUDNN_ATTENTION]
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_()
                  for t in (q, k, v))
    if 4 * qt.shape[0] * qt.shape[1] * qt.shape[2] * kt.shape[2] \
            <= MATH_SCORE_BYTES:
        backends.append(SDPBackend.MATH)
    note = ("the backward of F.scaled_dot_product_attention(is_causal=True, "
            "enable_gqa=True), (B, H, S, hd) layout")
    try:
        with sdpa_kernel(backends):
            out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                 enable_gqa=True)
    except RuntimeError as exc:
        return None, (f"{note}; refused: {type(exc).__name__}: "
                      f"{str(exc).splitlines()[0][:160]}")
    dt = dout.transpose(1, 2).contiguous()

    def call():
        return torch.autograd.grad(out, (qt, kt, vt), dt, retain_graph=True)
    return call, note


def attention_bwd_timing(dev, errors: dict) -> list:
    """Row 5c: the backward's call ms (CUDA events) and device ms
    (torch.profiler) at `bwd_timing_shapes()` in bf16 and float32, beside
    its plain version on the same inputs, the library's backward (checked
    against the plain version first) and the bound (`_bwd_work`; the FMA
    bound beside a float32 row's). One row per counter; the training shape
    is the headline. Launches are filled in by phase 14."""
    import torch

    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    by = {bwd_counter(d): [] for d in ATTN_DTYPES}
    for i, st in enumerate(bwd_timing_shapes()):
        for dtype in ATTN_DTYPES:
            inputs = bwd_inputs(dev, st["B"], st["S"], st["H"], st["KV"],
                                st["hd"], True, dtype, SEED + 600 + i,
                                kernel_forward=True)

            def call(inputs=inputs):
                return ops._backward(*inputs, True)

            def plain(inputs=inputs):
                return attention_bwd_ref(*inputs, causal=True)
            want = plain()  # the library's check, and the plain warm-up
            nbytes, nops, rate = _bwd_work(st, dtype)
            b_ms, b_by = bound(nbytes, nops, rate)
            fma = ({"bound_fma_ms": bound(nbytes, nops)[0]}
                   if rate == FP32_TC_OPS_PER_S else {})
            row = dict(stage=st["tag"], dtype=dtype, config=st["source"],
                       shape=(f"{st['tag']}: q/dout ({st['B']}, {st['S']}, "
                              f"{st['H']}, {st['hd']}), k/v ({st['B']}, "
                              f"{st['S']}, {st['KV']}, {st['hd']}) {dtype}, "
                              "causal"),
                       ms=time_auto(call),
                       # one timed run: the plain version is no yardstick
                       # of speed, and takes 1.4 s at prefill_mha
                       plain_ms=time_ms(plain, reps=1, warmup=0),
                       bound_ms=b_ms, bound_by=b_by, **fma, bytes=nbytes,
                       operations=nops)
            row["device_ms"], row["device_events"], row["device_source"] = \
                device_ms(call, reps=3)
            row["device_split"] = bwd_split(row["device_events"],
                                            row["device_source"])
            # the kernel's own outputs at this shape, at phase 2's gate
            row["max_abs_err"], row["share_of_gate"] = bwd_check(
                call(), inputs, True, f"row 5c {st['tag']} {dtype}")
            lib, note = _bwd_library(*inputs[:3], inputs[5])
            row["library_ms"], row["library_note"] = None, note
            if lib is not None:
                try:
                    got = lib()
                    for g, w in zip(got, want):
                        g = g.transpose(1, 2)
                        _within(g, w, 3e-2 * (1 + w.double().abs()),
                                f"library backward {st['tag']} {dtype}")
                    del got
                    row["library_ms"] = time_auto(lib)
                except (RuntimeError, AssertionError) as exc:
                    row["library_note"] += (
                        f"; refused or off: {type(exc).__name__}: "
                        f"{str(exc).splitlines()[0][:160]}")
            by[bwd_counter(dtype)].append(row)
            del inputs, lib, want
            torch.cuda.empty_cache()
    rows = []
    for dtype in ATTN_DTYPES:
        name = bwd_counter(dtype)
        shapes = by[name]
        worst = max([errors[name]] + [s["max_abs_err"] for s in shapes])
        rows.append(dict(name=name, route="cuda", source=BWD_SOURCES[dtype],
                         replaces=BWD_REPLACES, launches=0,
                         **{**shapes[0], "max_abs_err": worst},
                         shapes=shapes))
        for s in shapes:
            lib = (f"{s['library_ms']:.4f}" if s["library_ms"] is not None
                   else f"null ({s['library_note']})")
            fma = (f"; {s['bound_fma_ms']:.4f} in FMAs"
                   if "bound_fma_ms" in s else "")
            split = ("split not measured" if s["device_split"] is None
                     else ", ".join(f"{k} {v:.4f}"
                                    for k, v in s["device_split"].items()))
            log(f"  {name}: call {s['ms']:.4f} ms, device "
                f"{s['device_ms']:.4f} ms ({split}), plain "
                f"{s['plain_ms']:.4f}, library {lib}, bound "
                f"{s['bound_ms']:.4f} by {s['bound_by']}{fma}; max |Δ| "
                f"{s['max_abs_err']:.4g}, {s['share_of_gate']:.4f} of the "
                f"gate; at {s['shape']}")
    return rows


# ---------------------------------------------------------------------------
# B7's backward (csrc/mamba_scan_bwd_sm90.cu, and csrc/mamba_scan_bwd.cu for
# operands TMA cannot describe; float32): parity (phase 2), and times and
# the gate at row 7b's shapes (phase 6)
# ---------------------------------------------------------------------------
# The backward through `mamba_ssd` under autograd (the kernels' forward,
# its saved states and l, then the three backward kernels) against
# `ssd_scan_bwd_ref` in float64 on the same inputs, each of dx, ddt, dA,
# dB, dC within the forward's gate form: (SSD_REL + 8·u32·max|l|)·Σ|terms|
# + 1e-6, Σ|terms| being `ssd_scan_bwd_ref(terms=True)` (the same pass on
# |x|, |B|, |C|, |dy|, |dh_final|, |A| with every difference a sum). Set
# before the first run on the card: every product 3xTF32 (~2^-21
# of each term), dl's sums over up to 128 steps and dB, dC over a block's
# heads in float32 (√n·u32 in practice), the decays' exp(l_t − l_s) from
# float32 l (the max|l| part, as the forward). The same for the TMA
# route's kernels, whose tensor core carries sums up to 192 of K deep.
# tests/test_torch_ssd_emulation.py holds both routes' arithmetic,
# emulated, against float64 at this gate and shows one TF32 rounding of W
# or P, and dB / dC carried on the tensor core through every head, missing
# it.
# dA has a limit of its own, the same rel on the root-sum-square of its
# (row, chunk, step) parts' Σ|terms| (`ssd_scan_bwd_ref(dA_steps=True)`):
# rounding in different steps is independent, so it adds in quadrature,
# and its terms cancel (dl's pairs enter twice with opposite signs), so
# the Σ|terms| gate of the other outputs came to ~5x the median |dA| at
# zamba2's training shape and could not see a dA that was zero, half
# summed or permuted. On the CPU (float64, 16 heads of that shape) the
# limit is 0.21x the median |dA|; the plain float32 backward reads
# 5.8e-5 of it, dropping row 1's partial of chunk 7 2.4x it, row 1's
# partials 12.5x and rotating the heads 117x; phase 2 plants those three
# (`ssd_bwd_da_faults`).
SSD_BWD_SOURCE = "src/repro_torch/csrc/mamba_scan_bwd_sm90.cu"
# the JAX package's backward of the scan: `jax.grad` of the XLA ops of
# `mamba_chunked` (no Pallas kernel)
SSD_BWD_REPLACES = "src/repro/models/mamba.py:77"
SSD_BWD_PARTS = {"dstates": "ssd_bwd_dstates_sm90", "state_pass":
                 "ssd_bwd_state_pass", "chunk": "ssd_bwd_chunk_sm90"}
SSD_BWD_OUTPUTS = ("dx", "ddt", "dA", "dB", "dC")
# (tag, B, S, nh, hd, ds, chunk, dh_final given, large decays)
SSD_BWD_PARITY = [
    ("train_zamba2", 2, 4096, 64, 64, 64, 128, False, False),
    ("kernel chunk 100", 2, 400, 17, 64, 64, 200, True, False),
    ("one chunk", 2, 128, 3, 32, 16, 128, True, False),
    ("hd 5, ds 3, chunk 7", 2, 42, 20, 5, 3, 7, True, False),
    ("hd 40, ds 24, 33 heads", 1, 256, 33, 40, 24, 64, True, False),
    ("decays underflow", 2, 64, 3, 16, 8, 16, True, True),
]
# each case's route (`ops.bwd_route`): "sm90" but where TMA cannot
# describe a row (hd 5, ds 3: 20 and 12 bytes)
SSD_BWD_ROUTE = {"hd 5, ds 3, chunk 7": "mma"}
# bulk faults at (1, 2,048, 64, 64, 64, 128): 16 chunks, four head groups
SSD_BWD_BULK_CASE = ("bulk faults", 1, 2048, 64, 64, 64, 128, True, False)
SSD_BWD_BULK_CHUNK = 7  # the chunk whose incoming G is dropped
SSD_BWD_DA_FAULT = (1, 7)  # (row, chunk) of the dA partial dropped


def ssd_bwd_inputs(dev, case, seed: int) -> tuple:
    """(x, dt, A, Bc, Cc, dy, dh_final or None) float32 on the device from
    the seed, as `stage_inputs` makes the scan's (dt ~ U(0.01, 0.3), A ~
    −U(0.3, 2.0); with large decays dt ~ U(1, 5), A ~ −U(5, 25), l falling
    by up to ~2,000 within a chunk of 16)."""
    import torch

    _, B, S, nh, hd, ds, chunk, with_dh, large = case
    st = dict(kernel="mamba_scan", B=B, S=S, nh=nh, hd=hd, ds=ds,
              chunk=chunk)
    x, dt, A, Bc, Cc = stage_inputs(st, "float32", dev, seed)
    g = torch.Generator(device=dev).manual_seed(seed + 1)
    if large:
        dt = 1 + 4 * torch.rand((B, S, nh), generator=g, device=dev)
        A = -(5 + 20 * torch.rand((nh,), generator=g, device=dev))
    dy = torch.randn((B, S, nh, hd), generator=g, device=dev)
    dh = (torch.randn((B, nh, hd, ds), generator=g, device=dev)
          if with_dh else None)
    return x, dt, A, Bc, Cc, dy, dh


def ssd_bwd_call(inputs: tuple, chunk: int) -> tuple:
    """The backward as training reaches it: `mamba_ssd(return_state=True)`
    under autograd, then `torch.autograd.grad` with dy (and dh_final):
    (dx, ddt, dA, dB, dC)."""
    import torch

    from repro_torch.kernels import mamba_ssd

    x, dt, A, Bc, Cc, dy, dh = inputs
    leaves = [t.detach().requires_grad_() for t in (x, dt, A, Bc, Cc)]
    with torch.enable_grad():
        y, h = mamba_ssd(*leaves, chunk=chunk, return_state=True)
        outs, grads = ([y], [dy]) if dh is None else ([y, h], [dy, dh])
        return torch.autograd.grad(outs, leaves, grads)


def ssd_bwd_gate(inputs: tuple, chunk: int) -> tuple:
    """(want, allowed, dA's partials): `ssd_scan_bwd_ref` in float64 on the
    inputs; each output's gate, (SSD_REL + 8·u32·max|l|)·Σ|terms| + 1e-6,
    dA's with the root-sum-square of its steps' Σ|terms| in place of their
    sum; and dA's partial of each (row, chunk), (B, NC, nh)."""
    from repro_torch.kernels.mamba_scan.ref import ssd_scan_bwd_ref

    x, dt, A, Bc, Cc, dy, dh = (None if t is None else t.double()
                                for t in inputs)
    c = min(chunk, x.shape[1])
    max_l = float((dt * A).reshape(x.shape[0], -1, c, x.shape[2]).cumsum(
        2).abs().max().item())
    want = list(ssd_scan_bwd_ref(x, dt, A, Bc, Cc, dy, dh, chunk=chunk,
                                 dA_steps=True))
    mags = ssd_scan_bwd_ref(x, dt, A, Bc, Cc, dy, dh, chunk=chunk,
                            terms=True, dA_steps=True)
    rel = SSD_REL + 8 * U32 * max_l
    parts = want[2].sum(3)
    want[2] = parts.sum((0, 1))
    allowed = [rel * m + 1e-6 for m in mags]
    allowed[2] = rel * mags[2].square().sum((0, 1, 3)).sqrt() + 1e-6
    return tuple(want), tuple(allowed), parts


def ssd_bwd_check(got, inputs, chunk: int, name: str, gate=None) -> tuple:
    """(max |Δ|, share of the gate, {output: share}) of the backward's five
    outputs against `ssd_bwd_gate`'s (`gate` where given); raises past
    it."""
    want, allowed, _ = gate or ssd_bwd_gate(inputs, chunk)
    out = {n: _within(g, w, a, f"{name} {n}")
           for n, g, w, a in zip(SSD_BWD_OUTPUTS, got, want, allowed)}
    return (max(e for e, _ in out.values()),
            max(s for _, s in out.values()),
            {n: s for n, (_, s) in out.items()})


def ssd_bwd_bulk_faults(dev, seed: int) -> dict:
    """At SSD_BWD_BULK_CASE: the kernels' outputs within the gate, and each
    planted fault beyond it (raises otherwise): (a) the gradient that the
    later chunks and dh_final send into chunk SSD_BWD_BULK_CHUNK dropped
    from that chunk's dx, ddt and dB (its G_k taken as 0), (b) dB and (c)
    dC without the partial of the second group of heads (heads 16-31: the
    "sm90" route's groups, `ops.SM90_HEADS_PER_BLOCK`). Each missing
    part is `ssd_scan_bwd_ref` in float64 with dy (and dh_final) zeroed
    outside it: the backward is linear in them. Returns each fault's share
    of the gate and the gate's median over the median |ref| per output."""
    import torch

    from repro_torch.kernels.mamba_scan.ops import SM90_HEADS_PER_BLOCK
    from repro_torch.kernels.mamba_scan.ref import ssd_scan_bwd_ref

    case = SSD_BWD_BULK_CASE
    chunk = case[6]
    inputs = ssd_bwd_inputs(dev, case, seed)
    got = ssd_bwd_call(inputs, chunk)
    gate = ssd_bwd_gate(inputs, chunk)
    want, allowed, _ = gate
    ssd_bwd_check(got, inputs, chunk, "bulk-fault case", gate)
    x, dt, A, Bc, Cc, dy, dh = (t.double() for t in inputs)

    def part(dy_m, dh_m):
        return ssd_scan_bwd_ref(x, dt, A, Bc, Cc, dy_m, dh_m, chunk=chunk)

    def share(i: int, bad) -> float:
        return float(((bad - want[i]).abs() / allowed[i]).max())
    k0 = SSD_BWD_BULK_CHUNK * chunk
    rows = slice(k0, k0 + chunk)
    later = dy.clone()
    later[:, :k0 + chunk] = 0  # what reaches chunk k through its G
    g_part = part(later, dh)
    heads = slice(SM90_HEADS_PER_BLOCK, 2 * SM90_HEADS_PER_BLOCK)
    dy_g, dh_g = torch.zeros_like(dy), torch.zeros_like(dh)
    dy_g[:, :, heads], dh_g[:, heads] = dy[:, :, heads], dh[:, heads]
    grp = part(dy_g, dh_g)
    faults = {}
    for i, n in ((0, "dx"), (1, "ddt"), (3, "dB")):
        bad = got[i].double().clone()
        bad[:, rows] -= g_part[i][:, rows]
        faults[f"{n} without chunk {SSD_BWD_BULK_CHUNK}'s G"] = share(i, bad)
    for i, n in ((3, "dB"), (4, "dC")):
        faults[f"{n} without the second head group"] = share(
            i, got[i].double() - grp[i])
    for tag, v in faults.items():
        if v <= 1.0:
            raise AssertionError(f"the scan backward's gate does not see "
                                 f"{tag}: {v:.4g} of it")
    typical = {n: float(a.median() / w.abs().median())
               for n, w, a in zip(SSD_BWD_OUTPUTS, want, allowed)}
    return {"faults": faults, "gate_over_median_ref": typical}


def ssd_bwd_da_faults(dA, gate: tuple) -> dict:
    """dA planted wrong, each reading past dA's limit (raises otherwise):
    (a) the partial of SSD_BWD_DA_FAULT's (row, chunk) dropped, (b) that
    row's partials all dropped, (c) the heads' values rotated by one. The
    partials are `ssd_bwd_gate`'s (float64). Returns each fault's share
    of the limit."""
    want, allowed, parts = gate
    b, k = SSD_BWD_DA_FAULT
    got = dA.double()
    bad = {f"dA without row {b}'s chunk {k}": got - parts[b, k],
           f"dA without row {b}": got - parts[b].sum(0),
           "dA's heads rotated by one": got.roll(1)}
    faults = {t: float(((v - want[2]).abs() / allowed[2]).max())
              for t, v in bad.items()}
    for tag, v in faults.items():
        if v <= 1.0:
            raise AssertionError(f"dA's limit does not see {tag}: {v:.4g} "
                                 "of it")
    return faults


def ssd_bwd_parity(dev) -> dict:
    """Phase 2's scan-backward cases (SSD_BWD_PARITY): each call launches
    the forward and, on the route SSD_BWD_ROUTE names (`ops.bwd_route`
    agreeing), the backward once, and lands within `ssd_bwd_check`'s gate;
    the bulk faults miss it, and at the training shape the dA faults
    (`ssd_bwd_da_faults`) miss dA's; two calls at the training shape give
    the same bits. Returns the worst max |Δ|, the shares and the routes."""
    import torch

    from repro_torch import kernels
    from repro_torch.kernels.mamba_scan import ops

    worst, shares, routes, seed = 0.0, {}, {}, SEED + 700
    da_faults = None
    for case in SSD_BWD_PARITY:
        seed += 2
        inputs = ssd_bwd_inputs(dev, case, seed)
        route = SSD_BWD_ROUTE.get(case[0], "sm90")
        x, _, _, Bc, Cc, dy, _ = inputs
        nc = -(-x.shape[1] // ops.kernel_chunk(min(case[6], x.shape[1])))
        states = torch.empty((x.shape[0], x.shape[2], nc, x.shape[3],
                              Bc.shape[2]), device=dev)  # the forward's
        if ops.bwd_route(x, dy, Bc, Cc, states) != route:
            raise AssertionError(f"scan backward {case[0]}: bwd_route "
                                 f"is not {route!r}")
        del states
        before = kernels.launches()
        got = ssd_bwd_call(inputs, case[6])
        torch.cuda.synchronize()
        ran = {k: v - before[k] for k, v in kernels.launches().items()
               if v != before[k]}
        if ran != {"mamba_scan": 1, ops.BWD_COUNTERS[route]: 1}:
            raise AssertionError(f"scan backward {case[0]}: launched {ran}, "
                                 f"not its route {route!r}")
        routes[case[0]] = ops.BWD_COUNTERS[route]
        gate = ssd_bwd_gate(inputs, case[6])
        e, share, each = ssd_bwd_check(got, inputs, case[6],
                                       f"scan backward {case[0]}", gate)
        worst = max(worst, e)
        shares[case[0]] = each
        if case[0] == "train_zamba2":  # the same bits from the same inputs
            da_faults = ssd_bwd_da_faults(got[2], gate)
            again = ssd_bwd_call(inputs, case[6])
            if not all(torch.equal(a, b) for a, b in zip(got, again)):
                raise AssertionError("scan backward at train_zamba2: two "
                                     "calls on the same inputs differ")
            del again
        del inputs, got, gate
        torch.cuda.empty_cache()
    bulk = ssd_bwd_bulk_faults(dev, seed + 2)
    bulk["faults"].update(da_faults)
    torch.cuda.empty_cache()
    def rounded(d: dict) -> dict:
        return {k: float(f"{v:.4g}") for k, v in d.items()}
    log(f"  scan backward (through mamba_ssd's autograd): "
        f"{len(SSD_BWD_PARITY)} cases on their routes {routes}, dx / ddt / "
        f"dA / dB / dC within ({SSD_REL} + 8·u32·max|l|)·Σ|terms| + 1e-6 "
        "against float64 (dA: the root-sum-square of its steps' Σ|terms|); "
        "shares of the gate "
        f"{({k: rounded(d) for k, d in shares.items()})}; two calls at "
        "train_zamba2 give the same bits")
    log(f"  scan backward bulk faults at {SSD_BWD_BULK_CASE[1:7]} (dA's at "
        f"train_zamba2), shares of the gate (each must pass 1): "
        f"{rounded(bulk['faults'])}; the "
        "gate's median over the median |ref| "
        f"{rounded(bulk['gate_over_median_ref'])}")
    return {"worst": worst, "shares": shares, "bulk": bulk,
            "routes": routes}


def ssd_bwd_timing_shapes() -> list:
    """Row 7b's shapes: zamba2-1.2b's training step (phase 14) and phase
    5's ssd stage."""
    ssd = next(st for st in attention_ssm_stages() if st["tag"] == "ssd")
    train = dict(ssd, tag="train_zamba2", B=TRAIN_SSM_BATCH,
                 S=TRAIN_SSM_SEQ,
                 source="zamba2-1.2b training step (phase 14)")
    return [train, ssd]


def _ssd_bwd_work(st: dict) -> tuple:
    """(bytes, operations, rate) of one backward call in float32: its
    inputs read once (x, dy, dt, A, B, C, the forward's states and l) and
    dx, ddt, dA, dB, dC written once (the G scratch not counted); the
    operations its data needs: per (b, chunk, head) the causal c(c+1)/2
    pairs of P = dy·xᵀ and Wᵀ·dy (hd deep), and c·hd·ds for each of B·Gᵀ,
    x·G, dy·H and D_k; per (b, chunk) the pairs of C·Bᵀ, (Σ_h Q)ᵀ·C and
    (Σ_h Q)·B (ds deep): B and C belong to the chunk, so its heads share
    C·Bᵀ, and Σ_h Qᵀ·C = (Σ_h Q)ᵀ·C."""
    B, S, nh, hd, ds, c = (st[k] for k in ("B", "S", "nh", "hd", "ds",
                                            "chunk"))
    c = min(c, S)
    NC = S // c
    pairs = c * (c + 1) // 2
    nbytes = 4 * (3 * B * S * nh * hd + 2 * B * S * nh + nh
                  + 4 * B * S * ds + B * nh * NC * (hd * ds + 128))
    ops = 2 * B * NC * (3 * pairs * ds + nh * (2 * pairs * hd
                                               + 4 * c * hd * ds))
    return nbytes, ops, FP32_TC_OPS_PER_S


def ssd_bwd_timing(dev, worst: float) -> dict:
    """Row 7b: the backward's call ms (CUDA events around `ops._backward`
    on the forward's own saved states) and device ms (torch.profiler, split
    by kernel) at `ssd_bwd_timing_shapes()`, beside the plain version on
    the same float32 inputs (one timed run), the bound (`_ssd_bwd_work`;
    the FMA bound beside it) and each shape's own outputs at phase 2's
    gate. No one PyTorch call computes it: library null. Launches are
    filled in by phase 14."""
    import torch

    from repro_torch.kernels.mamba_scan import ops

    shapes = []
    for i, st in enumerate(ssd_bwd_timing_shapes()):
        case = (st["tag"], st["B"], st["S"], st["nh"], st["hd"], st["ds"],
                st["chunk"], False, False)
        inputs = ssd_bwd_inputs(dev, case, SEED + 800 + i)
        x, dt, A, Bc, Cc, dy, _ = inputs
        chunk = st["chunk"]
        _, _, states, l = ops._forward(x, dt, A, Bc, Cc, chunk, True, True)

        def call(inputs=inputs, states=states, l=l):
            return ops._backward(*inputs[:6], None, states, l, chunk)

        def plain(inputs=inputs):
            return ops.ssd_scan_bwd_ref(*inputs[:6], None, chunk=chunk)
        nbytes, nops, rate = _ssd_bwd_work(st)
        b_ms, b_by = bound(nbytes, nops, rate)
        row = dict(stage=st["tag"], dtype="float32", config=st["source"],
                   shape=(f"{st['tag']}: x/dy ({st['B']}, {st['S']}, "
                          f"{st['nh']}, {st['hd']}), B/C ({st['B']}, "
                          f"{st['S']}, {st['ds']}) float32, chunk "
                          f"{chunk}"),
                   ms=time_auto(call),
                   plain_ms=time_ms(plain, reps=1, warmup=1),
                   bound_ms=b_ms, bound_by=b_by,
                   bound_fma_ms=bound(nbytes, nops)[0], bytes=nbytes,
                   operations=nops, library_ms=None,
                   library_note="no one PyTorch call computes the SSD "
                   "scan's backward")
        row["device_ms"], row["device_events"], row["device_source"] = \
            device_ms(call, reps=5)
        # the partials' sums in ops._backward (torch.sum) apart from the
        # rest
        row["device_split"] = bwd_split(
            row["device_events"], row["device_source"],
            {**SSD_BWD_PARTS, "sums": "reduce_kernel"})
        # the call's own outputs at this shape, at phase 2's gate
        row["max_abs_err"], row["share_of_gate"], _ = ssd_bwd_check(
            ssd_bwd_call(inputs, chunk), inputs, chunk,
            f"row 7b {st['tag']}")
        shapes.append(row)
        del inputs, states, l, x, dt, A, Bc, Cc, dy
        torch.cuda.empty_cache()
    for s in shapes:
        split = ("split not measured" if s["device_split"] is None
                 else ", ".join(f"{k} {v:.4f}"
                                for k, v in s["device_split"].items()))
        log(f"  mamba_scan_bwd: call {s['ms']:.4f} ms, device "
            f"{s['device_ms']:.4f} ms ({split}), plain {s['plain_ms']:.4f}, "
            f"library null, bound {s['bound_ms']:.4f} by {s['bound_by']} / "
            f"{s['bound_fma_ms']:.4f} in FMAs; max |Δ| "
            f"{s['max_abs_err']:.4g}, {s['share_of_gate']:.4f} of the gate; "
            f"at {s['shape']}")
    worst = max([worst] + [s["max_abs_err"] for s in shapes])
    return dict(name="mamba_scan_bwd", route="cuda", source=SSD_BWD_SOURCE,
                replaces=SSD_BWD_REPLACES, launches=0,
                **{**shapes[0], "max_abs_err": worst}, shapes=shapes)


# ---------------------------------------------------------------------------
# phase 6: kernel times at the main path's shapes
# ---------------------------------------------------------------------------
def _writer_segments(tasks, all_rows: bool):
    """A stage's writer combine as the backend runs it: per-row segment ids
    (np.unique's inverse over the written keys, in task order) and the
    segment count. With `all_rows` every task keeps a row and non-writers
    carry the id S (dropped), as on the fused path."""
    wk = tasks.write_keys
    live = wk >= 0
    uniq, inv = np.unique(wk[live], return_inverse=True)
    if not all_rows:
        return inv.astype(np.int32), uniq.size
    seg = np.full(wk.size, uniq.size, dtype=np.int32)
    seg[live] = inv
    return seg, uniq.size


def segment_combine_timing(dev, by: dict, launches: dict) -> dict:
    """K2 at three writer combines of the main path, float32 rows of width
    16 made from the seed: stage (a)'s add over Zipf-2.0 keys (the
    headline; library `index_add_`), stage (c)'s min over the fused
    stage's per-task rows (library `index_reduce_(..., "amin")` on the
    writer rows), stage (b)'s ordered write over uniform keys (no one
    PyTorch call keeps the lowest-priority row). Bounds: each input read
    once and each output written once (for write, only the winning rows
    are read), one operation per element merged."""
    import torch

    from repro_torch.kernels.segment_combine.ops import combine
    from repro_torch.kernels.segment_combine.ref import combine_ref, identity

    g = torch.Generator().manual_seed(SEED)
    shapes, err = [], 0.0
    for tag, op in (("a", "add"), ("c", "min"), ("b", "write")):
        tasks = by[tag]
        seg_np, S = _writer_segments(tasks, all_rows=tag == "c")
        N, W = seg_np.size, VALUE_WIDTH
        upd = torch.randn(N, W, generator=g).to(dev)
        seg = torch.from_numpy(seg_np).to(dev)
        order = (torch.from_numpy(tasks.priority[tasks.write_keys >= 0]
                                  .astype(np.int32)).to(dev)
                 if op == "write" else None)
        got = combine(upd, seg, S, op=op, order=order)
        want = combine_ref(upd, seg, S, op=op, order=order)
        if op == "add":
            err = max(err, _sum_bound_ok(
                got, want, combine_ref(upd.abs(), seg, S, op="add")))
        elif not torch.equal(got, want):
            raise AssertionError(f"segment_combine {op} at stage {tag} "
                                 "differs from the plain version")
        if op == "write":
            nbytes = 4 * N + 4 * N + 2 * 4 * S * W
        else:
            nbytes = 4 * N * W + 4 * N + 4 * S * W
        b_ms, b_by = bound(nbytes, N * W)
        library_ms, note = None, ("no one PyTorch call keeps each segment's "
                                  "row of lowest priority")
        if op == "add":
            acc = torch.zeros(S, W, device=dev)
            library_ms = time_ms(lambda: acc.index_add_(0, seg, upd))
            note = "Tensor.index_add_"
        elif op == "min":
            live = seg < S
            l_seg, l_upd = seg[live].long(), upd[live].contiguous()
            acc = torch.full((S, W), identity("min", upd.dtype), device=dev)
            lib = acc.clone().index_reduce_(0, l_seg, l_upd, "amin")
            if not torch.equal(lib, want):
                raise AssertionError("index_reduce_ amin differs from the "
                                     "plain version")
            library_ms = time_ms(
                lambda: acc.index_reduce_(0, l_seg, l_upd, "amin"))
            note = "Tensor.index_reduce_(..., 'amin') on the writer rows"
        shapes.append(dict(
            stage=tag, op=op, ms=time_ms(lambda: combine(
                upd, seg, S, op=op, order=order)),
            plain_ms=time_ms(lambda: combine_ref(upd, seg, S, op=op,
                                                 order=order)),
            bound_ms=b_ms, bound_by=b_by, bytes=nbytes, operations=N * W,
            library_ms=library_ms, library_note=note,
            shape=f"stage ({tag}): ({N}, {W}) float32 -> {S} segments, "
                  f"{op}"))
        del upd, seg, order
    for sh in shapes:
        lib = (f"{sh['library_ms']:.4f}" if sh["library_ms"] is not None
               else f"null ({sh['library_note']})")
        log(f"  segment_combine: {sh['ms']:.4f} ms (plain "
            f"{sh['plain_ms']:.4f}, library {lib}, bound "
            f"{sh['bound_ms']:.4f} by {sh['bound_by']}) at {sh['shape']}")
    head = shapes[0]
    return dict(name="segment_combine", route="cuda",
                source="src/repro_torch/csrc/segment_combine.cu",
                replaces="src/repro/kernels/segment_combine/kernel.py:42",
                launches=launches["segment_combine"], max_abs_err=err,
                **{k: head[k] for k in ("ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms", "shape")},
                shapes=shapes)


def device_ms(fn, reps: int = 20) -> tuple:
    """The device's own time for one `fn()` call: the summed durations of
    the device events (kernels, fills, copies) that torch.profiler records
    over `reps` calls, over `reps`; that time by event name; and how it was
    taken. Beside `time_ms`, which also counts the host's work for the call
    while the card waits. Each session opens with one more call, whose
    events are not counted: a session often drops the device events it
    records first (a multi-kernel call's first kernels). Where three
    sessions miss some of the `reps` calls' events, the time is
    `queued_device_ms`'s instead."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a session now and then records no device events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            time.sleep(PROFILE_PAD_S)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        by = {}
        for e in sorted((e for e in prof.events()
                         if e.device_type == DeviceType.CUDA),
                        key=lambda e: e.time_range.start):
            by.setdefault(e.name, []).append(e)
        # a name a call launches k times: k·reps events of the counted
        # calls, and up to k of the first; keep the last k·reps (a total
        # that fits, as 6 of 3 calls' 9, can still miss a call)
        kept = {n: v[-(len(v) // reps) * reps:] for n, v in by.items()
                if len(v) >= reps and len(v) % reps <= len(v) // reps}
        if by and len(kept) == len(by):
            events = [e for v in kept.values() for e in v]
            break
        log(f"  the profiler saw {sum(map(len, by.values()))} device events "
            f"over {reps} calls and a first one "
            f"({sorted(map(len, by.values()))} by name); profiling again")
    else:
        log("  the profiler missed the calls' device events three times; "
            "timing them queued behind a spin kernel")
        return queued_device_ms(fn, reps), {}, "events"
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / reps / 1e3
    return sum(by_name.values()), by_name, "profiler"


def queued_device_ms(fn, reps: int = 20) -> float:
    """Device time of one `fn()` call by CUDA events, none of the host's:
    the `reps` calls are issued while a spin kernel holds the stream, so
    the events bracket only the device's work for them (and the gaps
    between their launches)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms, far longer than issuing the calls
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn, reps: int = 50) -> float:
    """Median host time to issue one `fn()` call (the card idle, nothing
    waited for): what the wrapper costs before the device starts."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    return float(np.median(times))


def _i32(a, dev):
    """A host integer array as a contiguous int32 tensor on `dev`."""
    import torch

    return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)


def _call_times(fn) -> dict:
    """A kernel call's event time (`ms`: the call as a user makes it, host
    work included), its host time (`host_ms`) and its device time
    (`device_ms`; `device_events`: each device event's ms a call;
    `device_source`: "profiler", or "events" where it fell back to
    `queued_device_ms`). The host clock reads first, before the profiler
    has touched the process."""
    times = dict(ms=time_ms(fn, reps=20), host_ms=host_ms(fn))
    (times["device_ms"], times["device_events"],
     times["device_source"]) = device_ms(fn)
    return times


def _log_shapes(name: str, shapes: list) -> None:
    for s in shapes:
        lib = (f"{s['library_ms']:.4f}" if s["library_ms"] is not None
               else "null")
        events = (", ".join(f"{k} {v:.4f}" for k, v in
                            s["device_events"].items())
                  or "CUDA events, the calls queued behind a spin")
        log(f"  {name}: call {s['ms']:.4f} ms (host {s['host_ms']:.4f}), "
            f"device {s['device_ms']:.4f} ms ({events}), plain "
            f"{s['plain_ms']:.4f}, library {lib}, bound {s['bound_ms']:.4f} "
            f"by {s['bound_by']}; {s['launches']} launches on its path; at "
            f"{s['shape']}")


def _histogram_shape(label, ids, wts, bins: int, n_launch: int) -> dict:
    """K1 at one call: checked against its plain version exactly, then
    timed beside the plain version and `torch.bincount` with the same
    weights. Bound: ids (and weights) read once, the bins written once,
    one add an id."""
    import torch

    from repro_torch.kernels.histogram.ops import count_ids
    from repro_torch.kernels.histogram.ref import histogram_ref

    n = ids.numel()
    got = count_ids(ids, bins, weights=wts)
    if not torch.equal(got, histogram_ref(ids, bins, wts)):
        raise AssertionError(f"histogram at the {label} differs")
    b_ms, b_by = bound(4 * n * (1 + (wts is not None)) + 4 * bins, n)
    return dict(
        **_call_times(lambda: count_ids(ids, bins, weights=wts)),
        plain_ms=time_ms(lambda: histogram_ref(ids, bins, wts)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: torch.bincount(ids, weights=wts,
                                                  minlength=bins)),
        launches=n_launch,
        shape=f"{label}: ids ({n},) int32"
              f"{'' if wts is None else ' + weights'}, {bins} bins")


def histogram_timing(dev, K, by: dict, launches: dict, ps: dict,
                     ps_launches: dict) -> dict:
    """K1 at three root calls, each weighted by multiplicity as the engine
    passes it: stage (b)'s (800,000 uniform keys, every pair reaching the
    root unmerged, over 800,000 bins; the headline), the parameter-server
    lookup's (the distinct ids of 8,192 Zipf-1.2 ids over 49,155 bins) and
    a decode step's (the distinct experts of 1,024 assignments over 40
    bins); and at `embed_skew_aware`'s unweighted call on its raw 8,192
    Zipf-1.2 ids over the 49,155 bins, repeats and all (the hot id about a
    fifth of them), where atomics on one bin would serialize
    (`_histogram_shape`)."""
    keys = by["b"].read_keys
    ti = ps["routing"][1]
    cases = [("stage (b) root call", _i32(keys, dev),
              _i32(np.ones_like(keys), dev), K, launches["histogram"])]
    for label, ids, bins in (("lookup root call", ps["ids"], ps["store"].V),
                             ("decode step root call", ti[ti >= 0],
                              ps["router"].E)):
        uniq, cnt = np.unique(ids, return_counts=True)
        cases.append((label, _i32(uniq, dev), _i32(cnt, dev), bins,
                      ps_launches["histogram"]))
    cases.append(("skew-aware embedding's raw ids", _i32(ps["skew_ids"], dev),
                  None, ps["store"].V, ps_launches["histogram"]))
    shapes = [_histogram_shape(*case) for case in cases]
    _log_shapes("histogram", shapes)
    return dict(name="histogram", route="cuda",
                source="src/repro_torch/csrc/histogram.cu",
                replaces="src/repro/kernels/histogram/kernel.py:37",
                max_abs_err=0.0, **shapes[0], shapes=shapes)


def stage_fused_timing(dev, K, by: dict, init, launches: dict, ps: dict,
                       ps_launches: dict) -> dict:
    """K3's gather-reduce (read_op add) at stage (c) (800,000 tasks of
    arity 1-8 over the (800,000, 16) float32 store, Zipf-1.5 keys; the
    headline) and at the parameter-server bags (8,192 bags of arity 1-8,
    Zipf 1.2, over the 49,155 x 1536 float32 table). Library:
    `F.embedding_bag` (mode "sum"; empty bags give 0), checked against the
    plain version first. Bound: the distinct rows read once, indptr and
    indices read once, the output written once, one add a pair and
    column."""
    import torch
    import torch.nn.functional as F

    from repro_torch.core import TorchBackend
    from repro_torch.kernels.stage_fused.ops import fused_reduce
    from repro_torch.kernels.stage_fused.ref import reduce_pairs_ref

    tc = by["c"]
    cases = [("stage (c)", torch.from_numpy(init.astype(np.float32)).to(dev),
              _i32(tc.read_indptr, dev), _i32(tc.read_indices, dev),
              launches["stage_fused"]),
             ("parameter-server bags",
              TorchBackend(device=dev).device_values(ps["store"].store),
              _i32(ps["bags"][0], dev), _i32(ps["bags"][1], dev),
              ps_launches["stage_fused"])]
    shapes, err = [], 0.0
    for label, vals, indptr, idx, n_launch in cases:
        want = reduce_pairs_ref(vals, indptr, idx, read_op="add")
        mags = reduce_pairs_ref(vals.abs(), indptr, idx, read_op="add")
        err = max(err, _sum_bound_ok(
            fused_reduce(vals, indptr, idx, read_op="add"), want, mags,
            name=f"stage_fused at {label}"))

        def bag(vals=vals, indptr=indptr, idx=idx):
            return F.embedding_bag(idx, vals, indptr, mode="sum",
                                   include_last_offset=True)

        _sum_bound_ok(bag(), want, mags, name=f"embedding_bag at {label}")
        del want, mags
        nt, nnz = indptr.numel() - 1, idx.numel()
        rows_read = int(torch.unique(idx).numel())
        w = vals.shape[1]
        b_ms, b_by = bound(4 * rows_read * w + 4 * (nt + 1) + 4 * nnz
                           + 4 * nt * w, nnz * w)
        shapes.append(dict(
            **_call_times(lambda: fused_reduce(vals, indptr, idx,
                                               read_op="add")),
            plain_ms=time_ms(lambda: reduce_pairs_ref(vals, indptr, idx,
                                                      read_op="add")),
            bound_ms=b_ms, bound_by=b_by, library_ms=time_ms(bag),
            launches=n_launch,
            shape=f"{label}: {nt} tasks, {nnz} pairs over "
                  f"({vals.shape[0]}, {w}) float32, {rows_read} distinct "
                  "rows, read_op add"))
        torch.cuda.empty_cache()
    _log_shapes("stage_fused", shapes)
    return dict(name="stage_fused", route="cuda",
                source="src/repro_torch/csrc/stage_fused.cu",
                replaces="src/repro/kernels/stage_fused/kernel.py:162",
                max_abs_err=err, **shapes[0], shapes=shapes)


def timing_phase(dev, K, stages, init, launches, ps: dict,
                 ps_launches: dict) -> list:
    """K1-K3 at the main path's and the parameter-server path's shapes.
    A row's top-level numbers are its first shape's; `launches` there is
    the main path's count, a shape's own is its path's."""
    by = {s[0]: s[2] for s in stages}
    return [histogram_timing(dev, K, by, launches, ps, ps_launches),
            segment_combine_timing(dev, by, launches),
            stage_fused_timing(dev, K, by, init, launches, ps, ps_launches)]


# ---------------------------------------------------------------------------
# phase 7: how busy the card is during a stage
# ---------------------------------------------------------------------------
_OWN_KERNELS = ("hist_", "seg_combine", "write_gather", "fused_reduce",
                "fa_sm90", "fa_tf32", "fd_", "ssd_", "gg_")


def device_busy(name: str, run) -> dict:
    """Wall time of `run()` and the device's busy time in it, by
    torch.profiler: busy is the union of the device's own events (kernels,
    copies, fills), split into this port's kernels, host<->device copies
    and torch's other kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):  # a session now and then records no device events
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            time.sleep(PROFILE_PAD_S)
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        if spans:
            break
        log(f"  {name}: the profiler saw no device activity; profiling "
            "again")
    else:
        raise AssertionError(f"{name}: the profiler saw no device activity")
    busy_us, end = 0.0, -np.inf
    split = {"port_kernels_ms": 0.0, "copies_ms": 0.0,
             "other_device_ms": 0.0}
    for s, e, ev_name in spans:
        busy_us += max(0.0, e - max(s, end))
        end = max(end, e)
        key = ("port_kernels_ms" if any(k in ev_name for k in _OWN_KERNELS)
               else "copies_ms" if ev_name.startswith("Memcpy")
               else "other_device_ms")
        split[key] += (e - s) / 1e3
    busy = busy_us / 1e6
    return dict(wall_s=wall, device_busy_s=busy,
                idle_share=1.0 - busy / wall, **split)


def _log_busy(label, row) -> None:
    log(f"  {label}: wall {row['wall_s']:.3f} s, device busy "
        f"{row['device_busy_s'] * 1e3:.2f} ms (idle "
        f"{row['idle_share']:.4f}); port kernels "
        f"{row['port_kernels_ms']:.3f} ms, copies {row['copies_ms']:.3f} "
        f"ms, other device work {row['other_device_ms']:.3f} ms")


def busy_phase(K, stages, init) -> list:
    """Device busy and idle share of stages (a)-(c) on the torch backend
    (`device_busy`), in a second run of each stage (the first one uploads
    the store)."""
    import torch

    from repro_torch.core import DataStore, Orchestrator

    rows = []
    for name, desc, tasks, f, merge, rep, _ in stages:
        if name == "d":
            continue
        st = DataStore.create(K, P, value_width=VALUE_WIDTH)
        st.write_rows(np.arange(K), init)
        sess = Orchestrator(st, backend="torch", replication=rep)
        sess.run_stage(tasks, f, write_back=merge, return_results=True)
        torch.cuda.synchronize()
        row = dict(stage=name, desc=desc, **device_busy(
            f"stage {name}", lambda: sess.run_stage(
                tasks, f, write_back=merge, return_results=True)))
        _log_busy(f"stage {name} ({desc})", row)
        rows.append(row)
    return rows


# ---------------------------------------------------------------------------
# phase 8: the other engines and multi-round plans
# ---------------------------------------------------------------------------
ENGINES = ("pull", "push", "sort", "auto")
# tasks a machine of the engines' stages: half phase 3's (the keys scale
# with them, so each stage's Phase-1 calls take the routes phase 3's take);
# at phase 3's full 50,000 the engines took ~60 s of a ~1,000 s run, and
# halving them pays, with phase 9's 2^16, for phase 14's granite-moe
# training and B4's backward in phases 1, 2 and 6
ENGINES_TPM = TASKS_PER_MACHINE // 2
# launches of each kernel in stages (a)-(c) under each fixed engine: the
# baselines never call Phase 1's histogram, every stage's writer combine is
# one K2 and the ragged stage (c) one K3; TD-Orch's are phase 3's
ENGINE_EXPECTED = {
    **{eng: {"a": _launch(segment_combine=1),
             "b": _launch(segment_combine=1),
             "c": _launch(segment_combine=1, stage_fused=1)}
       for eng in ("pull", "push", "sort")},
    "tdorch": {k: EXPECTED_LAUNCHES[k] for k in "abc"},
}
# engine="auto" replays every candidate's bill before it runs the stage on
# the one it picks: TD-Orch's replay makes its Phase-1 root call, which
# launches K1 where phase 3's TD-Orch stage does, at (b)
AUTO_ESTIMATE = {"a": _launch(), "b": _launch(histogram=1), "c": _launch()}


def _plus(x: dict, y: dict) -> dict:
    return {k: x[k] + y[k] for k in x}


def _torch_backend(device: str, **kw):
    from repro_torch.core import TorchBackend

    return TorchBackend(**kw) if device == "cuda" \
        else TorchBackend(device=device, **kw)


def _same_decisions(name, a, b) -> None:
    """engine="auto": the torch session's decision ledger equal to the
    numpy session's (chosen engine, every candidate's predicted bill)."""
    ka = [(d.choice, d.predicted, d.predicted_words, d.switched)
          for d in a.report.policy_decisions]
    kb = [(d.choice, d.predicted, d.predicted_words, d.switched)
          for d in b.report.policy_decisions]
    if ka != kb:
        raise AssertionError(f"{name}: policy decisions differ: {ka} / {kb}")


def engines_path(device: str = "cuda", tpm: int = TASKS_PER_MACHINE):
    """Stages (a)-(c) of phase 3 through `Orchestrator(engine=e)` for every
    e of ENGINES, one session a backend and engine (the stages chain, so
    `auto`'s hysteresis sees its incumbent), on the card and on a copy of
    the store through the numpy oracle. Each stage is held to the oracle as
    in phase 3; under `auto` the decisions must be the oracle's too. Returns
    (one row a stage, the launches expected of each stage)."""
    from repro_torch.core import DataStore, Orchestrator

    K, stages = make_stages(tpm)
    init = np.random.default_rng(SEED + 1).standard_normal((K, VALUE_WIDTH))
    expected: dict = {}
    st = _Stages(device, expected)
    for eng in ENGINES:
        st_dev = DataStore.create(K, P, value_width=VALUE_WIDTH)
        st_ora = DataStore.create(K, P, value_width=VALUE_WIDTH)
        st_dev.write_rows(np.arange(K), init)
        s_dev = Orchestrator(st_dev, engine=eng,
                             backend=_torch_backend(device))
        s_ora = Orchestrator(st_ora, engine=eng, backend="numpy")
        _timed_backend(s_dev.backend)
        for name, desc, tasks, f, merge, _, _ in stages:
            if name not in "abc":
                continue
            tag = f"{eng}/{name}"
            st_ora.write_rows(np.arange(K), st_dev.values)
            old = st_ora.values.copy()
            mags = term_magnitudes(tasks, old, "fused" if tasks.max_arity > 1
                                   else "muladd")
            # the oracle first: under auto its decision names the engine
            # whose launches the torch stage must show
            t0 = time.perf_counter()
            r_ora = s_ora.run_stage(tasks, f, write_back=merge,
                                    return_results=True)
            wall_ora = time.perf_counter() - t0
            choice = r_ora.decision.choice if eng == "auto" else eng
            expected[tag] = ENGINE_EXPECTED[choice][name]
            if eng == "auto":
                expected[tag] = _plus(expected[tag], AUTO_ESTIMATE[name])
            s_dev.backend.numerics_s = 0.0
            r_dev = st.run(tag, lambda: s_dev.run_stage(
                tasks, f, write_back=merge, return_results=True),
                desc=desc, tasks=tasks.n, pairs=tasks.nnz)
            row = st.rows[-1]
            if s_dev.backend._host_lambdas:
                raise AssertionError(f"{tag}: a lambda fell back to the "
                                     "host path")
            _same_bill(tag, r_dev, r_ora)
            if eng == "auto":
                _same_decisions(tag, s_dev, s_ora)
            res_err = _sum_bound_ok(
                np.asarray(r_dev.results, dtype=np.float64),
                np.asarray(r_ora.results, dtype=np.float64), mags,
                rel_want=1e-5, name=f"{tag} results")
            val_err, val_share = _check_values(
                tag, st_dev.values, st_ora.values, old, tasks, mags, merge)
            wall, numerics = row["wall_s"], s_dev.backend.numerics_s
            row.update(engine=eng, chosen=choice, numerics_s=numerics,
                       host_cost_model_s=wall - numerics,
                       oracle_wall_s=wall_ora, max_result_err=res_err,
                       max_value_err=val_err,
                       max_value_err_share_of_tolerance=val_share)
            log(f"  {tag}{f' (chose {choice})' if eng == 'auto' else ''}: "
                f"wall {wall:.3f} s = host {wall - numerics:.3f} + backend "
                f"calls {numerics:.3f} (oracle {wall_ora:.3f} s); max |Δ| "
                f"results {res_err:.3g}, store {val_err:.3g} ({val_share:.3g}"
                f" of its tolerance); signature/refcount/exec_site"
                f"{'/decisions' if eng == 'auto' else ''} equal; launches "
                f"{ {k: v for k, v in row['launches'].items() if v} }")
    return st.rows, expected


# benchmarks/bench_plan.py's two cells at their full sizes, engine "pull"
PLAN_SEED = 23
PLAN_P = 8
PLAN_ROUNDS = 10
ALPHA = 0.85


def _f_contrib(ctx, vals):
    """rank-bank gather × (alpha/deg) per edge task."""
    return {"update": vals * ctx[:, 0:1]}


def _f_apply(ctx, vals):
    """rank' = (1-alpha)/n + acc for the rank half; 0 for the acc reset."""
    return {"update": ctx[:, 0:1] + vals * ctx[:, 1:2]}


def _f_bfs(ctx, vals):
    """distance candidate = the round number riding in the context."""
    return {"update": ctx[:, 0:1] + vals * 0.0}


def pagerank_stages(n: int) -> dict:
    """bench_plan's pagerank_stages: power iteration over a two-bank store
    (ranks, accumulators), two stages a round of fixed shapes and no user
    callback; PLAN_ROUNDS rounds on a Barabási-Albert graph (attach 8)."""
    from repro_torch.core import DataStore, StagePlan, TaskBatch
    from repro_torch.graph import generators

    g = generators.barabasi_albert(n, 8, seed=PLAN_SEED)
    deg = np.bincount(g.src, minlength=n).astype(np.float64)
    ctx_a = np.where(deg[g.src] > 0, ALPHA / np.maximum(deg[g.src], 1.0),
                     0.0)[:, None]
    batch_a = TaskBatch(contexts=ctx_a, read_keys=g.src, write_keys=n + g.dst,
                        origin=TaskBatch.even_origins(g.m, PLAN_P))
    ctx_rank = np.zeros((n, 2))
    ctx_rank[:, 0] = (1.0 - ALPHA) / n
    ctx_rank[:, 1] = 1.0
    batch_b = TaskBatch.concat([
        TaskBatch(contexts=ctx_rank, read_keys=np.arange(n) + n,
                  write_keys=np.arange(n, dtype=np.int64),
                  origin=TaskBatch.even_origins(n, PLAN_P)),
        TaskBatch(contexts=np.zeros((n, 2)),
                  read_keys=np.full(n, -1, dtype=np.int64),
                  write_keys=np.arange(n, dtype=np.int64) + n,
                  origin=TaskBatch.even_origins(n, PLAN_P))])

    def fresh():
        store = DataStore.create(2 * n, PLAN_P, value_width=1, chunk_words=1)
        vals = np.zeros((2 * n, 1))
        vals[:n] = 1.0 / n
        store.write_rows(np.arange(2 * n), vals)
        return store

    def loop(sess, store):
        for _ in range(PLAN_ROUNDS):
            sess.run_stage(batch_a, _f_contrib, "add")
            sess.run_stage(batch_b, _f_apply, "write")
        return PLAN_ROUNDS

    plan = StagePlan("pagerank-stages").loop(
        StagePlan().stage(batch_a, _f_contrib, "add")
                   .stage(batch_b, _f_apply, "write"),
        until=None, max_rounds=PLAN_ROUNDS)

    # float32 sums of nonnegative terms: a round adds at most (k + 3)·2^-24
    # to a rank's relative error for k in-edges (the context's and the
    # product's roundings, k - 1 adds in any order, the base's rounding and
    # its add), so R rounds at most R·(max in-degree + 3)·2^-24, plus
    # 2^-24 for the first ranks' rounding
    rel = (PLAN_ROUNDS * (int(np.bincount(g.dst, minlength=n).max()) + 3)
           + 1) * 2.0 ** -24
    # no user callback reads the host: the plan flushes once, at its exit
    return dict(name="pagerank_stages", fresh=fresh, loop=loop,
                plan=lambda sess, store: sess.run_plan(plan).rounds,
                stages_a_round=2, values=lambda store: store.values[:n, 0],
                rel=rel, fewer_syncs=True,
                desc=f"BA n={n} m={g.m}, {PLAN_ROUNDS} rounds")


def bfs_stages(n: int) -> dict:
    """bench_plan's bfs_stages from source 0: frontier BFS with a min merge
    over per-round edge batches whose sizes drift; the plan's emission reads
    the host values once a round. Barabási-Albert graph (attach 4)."""
    from repro_torch.core import CARRY, StagePlan, TaskBatch, DataStore
    from repro_torch.graph import generators

    g = generators.barabasi_albert(n, 4, seed=PLAN_SEED + 1)
    order = np.argsort(g.src, kind="stable")
    indptr = np.zeros(n + 1, dtype=np.int64)
    np.add.at(indptr, g.src + 1, 1)
    np.cumsum(indptr, out=indptr)
    out_dst = g.dst[order]
    inf = float(n + 10)

    def frontier_batch(frontier, rnd):
        counts = indptr[frontier + 1] - indptr[frontier]
        total = int(counts.sum())
        if total == 0:
            return None
        offs = np.repeat(np.cumsum(counts) - counts, counts)
        flat = np.repeat(indptr[frontier], counts) \
            + np.arange(total, dtype=np.int64) - offs
        return TaskBatch(contexts=np.full((total, 1), float(rnd)),
                         read_keys=np.full(total, -1, dtype=np.int64),
                         write_keys=out_dst[flat],
                         origin=TaskBatch.even_origins(total, PLAN_P))

    def fresh():
        store = DataStore.create(n, PLAN_P, value_width=1, chunk_words=1)
        vals = np.full((n, 1), inf)
        vals[0] = 0.0
        store.write_rows(np.arange(n), vals)
        return store

    def loop(sess, store):
        rnd, batch = 1, frontier_batch(np.array([0]), 1)
        while batch is not None:
            sess.run_stage(batch, _f_bfs, "min")
            newly = np.flatnonzero(store.values[:, 0] == rnd)
            rnd += 1
            batch = frontier_batch(newly, rnd) if newly.size else None
        return rnd - 1

    def plan(sess, store):
        def emit(state, res):
            newly = np.flatnonzero(store.values[:, 0] == state.round + 1)
            return (frontier_batch(newly, state.round + 2) if newly.size
                    else None)

        plan = StagePlan("bfs-stages").loop(
            StagePlan().stage(CARRY, _f_bfs, "min", emit=emit),
            until="empty", max_rounds=n)
        return sess.run_plan(plan, carry=frontier_batch(np.array([0]),
                                                        1)).rounds

    # the emission reads the host values every round: a flush a round, as
    # many host syncs as the loop's write-back of its one stage
    return dict(name="bfs_stages", fresh=fresh, loop=loop, plan=plan,
                stages_a_round=1, values=lambda store: store.values[:, 0],
                rel=0.0, fewer_syncs=False,
                desc=f"BA n={n} m={g.m}, source 0")


def plans_path(device: str = "cuda", n_pagerank: int = 50_000,
               n_bfs: int = 100_000):
    """Each plan cell three ways, one session each over a fresh store,
    engine "pull": `run_plan` on the card, the same `run_stage` loop on the
    card, `run_plan` on the numpy oracle. The three session reports must be
    equal (`assert_session_parity`), the values within the cell's reckoned
    tolerance of the oracle's (BFS exact), the plan at most one host sync a
    round and no more than the loop (fewer where no callback reads the
    host); each stage launches one K2."""
    import torch

    from repro_torch.core import Orchestrator, assert_session_parity

    rows, expected = [], {}
    st = _Stages(device, expected)
    for cell in (pagerank_stages(n_pagerank), bfs_stages(n_bfs)):
        name, runs = cell["name"], {}
        for mode, backend, drive in (
                ("numpy", "numpy", cell["plan"]),
                ("plan", _torch_backend(device), cell["plan"]),
                ("loop", _torch_backend(device), cell["loop"])):
            store = cell["fresh"]()
            sess = Orchestrator(store, engine="pull", backend=backend)
            before = sess.backend.host_syncs
            tag = f"{name}/{mode}"
            if mode == "numpy":
                t0 = time.perf_counter()
                rounds = drive(sess, store)
                wall = time.perf_counter() - t0
            else:
                expected[tag] = _launch(segment_combine=cell["stages_a_round"]
                                        * runs["numpy"]["rounds"])
                rounds = st.run(tag, lambda: drive(sess, store))
                wall = st.rows[-1]["wall_s"]
                if sess.backend._host_lambdas:
                    raise AssertionError(f"{tag}: a lambda fell back to the "
                                         "host path")
            runs[mode] = dict(rounds=rounds, wall_s=wall,
                                syncs=sess.backend.host_syncs - before,
                                report=sess.report,
                                values=cell["values"](store).copy())
        want = runs["numpy"]
        for mode in ("plan", "loop"):
            got = runs[mode]
            if got["rounds"] != want["rounds"]:
                raise AssertionError(f"{name}/{mode}: {got['rounds']} "
                                     f"rounds, oracle {want['rounds']}")
            assert_session_parity(got["report"], want["report"])
            err = np.abs(got["values"] - want["values"])
            allowed = cell["rel"] * np.abs(want["values"])
            if not (err <= allowed).all():
                i = int(np.argmax(err - allowed))
                raise AssertionError(
                    f"{name}/{mode}: value {i} {got['values'][i]} against "
                    f"{want['values'][i]} (allowed {allowed[i]})")
            got["max_abs_err"] = float(err.max(initial=0.0))
            got["err_share"] = float((err / np.maximum(allowed, 1e-300))
                                     .max(initial=0.0)) if cell["rel"] else 0.0
        rounds = want["rounds"]
        spr = {d: runs[d]["syncs"] / rounds for d in ("plan", "loop")}
        if spr["plan"] > 1.0:
            raise AssertionError(f"{name}: {spr['plan']} host syncs a round "
                                 "under the plan")
        if spr["plan"] > spr["loop"] or (cell["fewer_syncs"]
                                         and spr["plan"] >= spr["loop"]):
            raise AssertionError(f"{name}: the plan syncs {spr['plan']} a "
                                 f"round, the loop {spr['loop']}")
        row = dict(cell=name, desc=cell["desc"], rounds=rounds,
                   **{f"{d}_{k}": runs[d][k] for d in runs
                      for k in ("wall_s", "syncs")},
                   host_syncs_a_round=spr,
                   max_abs_err={d: runs[d]["max_abs_err"]
                                for d in ("plan", "loop")},
                   err_share_of_tolerance={d: runs[d]["err_share"]
                                           for d in ("plan", "loop")})
        rows.append(row)
        log(f"  {name} ({cell['desc']}): {rounds} rounds; wall plan "
            f"{runs['plan']['wall_s']:.3f} s, loop {runs['loop']['wall_s']:.3f}"
            f" s (numpy plan {runs['numpy']['wall_s']:.3f} s); host syncs a "
            f"round plan {spr['plan']:.3f}, loop {spr['loop']:.3f}; reports "
            f"equal; max |Δ| plan {runs['plan']['max_abs_err']:.3g}, loop "
            f"{runs['loop']['max_abs_err']:.3g}")
        if device == "cuda":
            torch.cuda.empty_cache()
    return rows, expected


# ---------------------------------------------------------------------------
# phase 9: TDO-GP on the card
# ---------------------------------------------------------------------------
# Graph500's scale-20 problem cut to scale 16 (2^16 vertices: at 2^20 the
# host's cost model and oracle combines take phase 9 past 6 minutes; at
# 2^19, on an H100 at 700 W, the Erdős-Rényi graph's ingest and five
# algorithms on both backends took 346 s of a 1,146 s run once phase 13
# served four models, too near the 1,200 s limit; 2^17 took phase 9 88.5 s
# of a 921.5 s run, and halving it pays for phase 14's granite-moe
# training and B4's backward in phases 2 and 6), at
# average degree 16 (Graph500: 32) and with Erdős-Rényi / star /
# Barabási-Albert graphs standing in for its Kronecker generator; P = 16,
# as benchmarks/bench_graph.py
GRAPH_SCALE = 16
GRAPH_P = 16
GRAPH_BA_N = 30_000  # bench_graph's full size
INGEST_ARRAYS = ("vertex_home", "edge_machine", "out_indptr", "out_edges",
                 "in_indptr", "in_edges", "src_grp_indptr",
                 "src_grp_machines", "dst_grp_indptr", "dst_grp_machines")
PAGERANK_ROUNDS = 10
# the float64 PageRank's ranks against the oracle's
PAGERANK_F64_ABS = 1e-12
BC_REL = 1e-9
# one kernel on the graph path: the ingest stage's Phase-1 root call
GRAPH_EXPECTED_INGEST = _launch(histogram=1)


def graph_specs(scale: int = GRAPH_SCALE, ba_n: int = GRAPH_BA_N) -> list:
    from repro_torch.graph import barabasi_albert, erdos_renyi, star_graph

    return [("er", lambda: erdos_renyi(2 ** scale, avg_degree=16, seed=2)),
            ("star", lambda: star_graph(2 ** scale)),
            ("ba", lambda: barabasi_albert(ba_n, attach=8, seed=1))]


def _algorithms() -> list:
    from repro_torch.graph import bc, bfs, cc, pagerank, sssp

    return [("bfs", lambda og, **kw: bfs(og, 0, **kw)),
            ("sssp", lambda og, **kw: sssp(og, 0, **kw)),
            ("cc", lambda og, **kw: cc(og, **kw)),
            ("pagerank", lambda og, **kw: pagerank(
                og, max_iter=PAGERANK_ROUNDS, tol=0.0, **kw)),
            ("bc", lambda og, **kw: bc(og, 0, **kw))]


def _measured_combines(be, unit: float, log_rows: list) -> None:
    """Measure every `combine_by_key` call that takes the device route
    (`sorted_segment_sum`: one counted host sync) against the exact float64
    segment sums of the same inputs, beside a rounding model of a prefix
    sum in the backend's dtype (unit roundoff `unit`): a segment's error at
    most unit·((k + 4)·M + Σ|its terms|), M the prefix's magnitude at its
    end and k its terms (a sequential scan's k adds, or a blocked scan's
    two end adds, one carry and partials below M). The card's scan exceeds
    that model (PERF.md §6), and no bound that holds for any scan
    order is smaller than the ranks themselves, so the model's share is
    reported, not gated: the float64 run's ranks are the gate. Appends
    (max |Δ|, share of the model) a device call."""
    inner = be.combine_by_key

    def combine(values, keys, num_keys, merge, order):
        syncs = be.host_syncs
        uniq, got = inner(values, keys, num_keys, merge, order)
        if be.host_syncs == syncs:
            return uniq, got
        v = np.asarray(values, dtype=np.float64)[:, 0]
        exact = np.bincount(keys, weights=v, minlength=num_keys)[uniq]
        seg_mag = np.bincount(keys, weights=np.abs(v),
                              minlength=num_keys)[uniq]
        k = np.bincount(keys, minlength=num_keys)[uniq]
        model = unit * ((k + 4.0) * np.cumsum(seg_mag) + seg_mag)
        err = np.abs(got[:, 0] - exact)
        if not np.isfinite(got).all():
            raise AssertionError("device edge combine: a sum is not finite")
        log_rows.append((float(err.max(initial=0.0)), float(
            (err / np.maximum(model, 1e-300)).max(initial=0.0))))
        return uniq, got

    be.combine_by_key = combine


def _check_algorithm(tag, name, got, want, info_t, info_n) -> dict:
    if info_t.rounds != info_n.rounds:
        raise AssertionError(f"{tag}: {info_t.rounds} rounds, oracle "
                             f"{info_n.rounds}")
    sig_t = [s.report.phase_signature() for s in info_t.stats]
    sig_n = [s.report.phase_signature() for s in info_n.stats]
    if sig_t != sig_n:
        raise AssertionError(f"{tag}: a round's phase_signature differs")
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"{tag}: shape {got.shape}, want {want.shape}")
    if name in ("bfs", "sssp", "cc"):
        if not np.array_equal(got, want):
            raise AssertionError(f"{tag}: values differ from the oracle's")
        return dict(max_abs_err=0.0)
    err = np.abs(got - want)
    if name == "bc":
        allowed = BC_REL * (1.0 + np.abs(want))
        if not (err <= allowed).all():
            raise AssertionError(f"{tag}: max |Δ| {err.max()} beyond "
                                 f"{BC_REL}·(1+|ref|)")
    return dict(max_abs_err=float(err.max(initial=0.0)),
                max_rel_err=float((err / np.maximum(np.abs(want), 1e-300))
                                  .max(initial=0.0)),
                l1_err=float(err.sum()))


def graph_path(device: str = "cuda", scale: int = GRAPH_SCALE,
               ba_n: int = GRAPH_BA_N):
    """TDO-GP on the card: each graph ingested at P=16 (seed 0, weights
    from seed 3) on the card and through the numpy oracle, then BFS, SSSP,
    CC, PageRank (10 rounds, tol 0) and BC from vertex 0 both ways; on the
    Erdős-Rényi graph PageRank once more in float64. Returns (rows, the
    launches expected of each stage, the ingest's Phase-1 root call on the
    Erdős-Rényi graph: keys, bins, weights)."""
    import torch

    from repro_torch.graph import ingest

    rows, expected, root_call = [], {}, None
    st = _Stages(device, expected)
    for gname, make in graph_specs(scale, ba_n):
        t0 = time.perf_counter()
        g = make().with_weights(seed=3)
        log(f"  graph {gname}: n {g.n}, m {g.m} (made in "
            f"{time.perf_counter() - t0:.2f} s)")
        be = _torch_backend(device)
        _timed_backend(be)
        calls = []
        counts = be.key_counts

        def recorded(keys, num_keys, weights=None, _inner=counts):
            calls.append((np.asarray(keys), num_keys, weights))
            return _inner(keys, num_keys, weights)

        be.key_counts = recorded
        tag = f"ingest/{gname}"
        expected[tag] = GRAPH_EXPECTED_INGEST
        og_t = st.run(tag, lambda: ingest(g, GRAPH_P, seed=0, backend=be))
        wall = st.rows[-1]["wall_s"]
        if be._host_lambdas:
            raise AssertionError(f"{tag}: the ingest lambda fell back to the "
                                 "host path")
        t0 = time.perf_counter()
        og_n = ingest(g, GRAPH_P, seed=0, backend="numpy")
        wall_ora = time.perf_counter() - t0
        for arr in INGEST_ARRAYS:
            if not np.array_equal(getattr(og_t, arr), getattr(og_n, arr)):
                raise AssertionError(f"{tag}: {arr} differs")
        if og_t.ingest_report.phase_signature() \
                != og_n.ingest_report.phase_signature():
            raise AssertionError(f"{tag}: phase_signature differs")
        if gname == "er":
            root_call = calls[0]
        st.rows[-1].update(graph=gname, n=g.n, m=g.m,
                           numerics_s=be.numerics_s,
                           host_s=wall - be.numerics_s, oracle_wall_s=wall_ora,
                           root_call_ids=int(calls[0][0].size))
        log(f"  {tag}: wall {wall:.3f} s = host (cost model, trees, CSR) "
            f"{wall - be.numerics_s:.3f} + backend calls "
            f"{be.numerics_s:.3f} (oracle {wall_ora:.3f} s); root call "
            f"{calls[0][0].size} ids over {calls[0][1]} bins; arrays and "
            f"signature equal")
        del calls
        runs = [(name, alg, {}) for name, alg in _algorithms()]
        if gname == "er":
            runs.append(("pagerank", _algorithms()[3][1],
                         dict(dtype="float64")))
        oracle = {}  # the float64 PageRank is held to the same oracle run
        for name, alg, kw in runs:
            tag = f"{name}{'_f64' if kw else ''}/{gname}"
            be_a = _torch_backend(device, **kw)
            combines: list = []
            if name == "pagerank":
                _measured_combines(
                    be_a, 2.0 ** (-53 if kw else -24), combines)
            expected[tag] = _launch()
            got, info_t = st.run(tag, lambda: alg(og_t, backend=be_a))
            wall = st.rows[-1]["wall_s"]
            if name not in oracle:
                t0 = time.perf_counter()
                oracle[name] = (*alg(og_n, backend="numpy"),
                                time.perf_counter() - t0)
            want, info_n, wall_ora = oracle[name]
            res = _check_algorithm(tag, name, got, want, info_t, info_n)
            res["device_rounds"] = be_a.host_syncs
            if name == "pagerank":
                if len(combines) != be_a.host_syncs:
                    raise AssertionError(f"{tag}: unmeasured device rounds")
                res.update(combine_max_abs_err=max(
                    (c[0] for c in combines), default=0.0),
                    combine_model_share=max((c[1] for c in combines),
                                            default=0.0))
                if kw and res["max_abs_err"] > PAGERANK_F64_ABS:
                    raise AssertionError(f"{tag}: max |Δ| "
                                         f"{res['max_abs_err']} beyond "
                                         f"{PAGERANK_F64_ABS}")
            st.rows[-1].update(graph=gname, algorithm=name,
                               rounds=info_t.rounds, oracle_wall_s=wall_ora,
                               **res)
            extra = ""
            if name == "pagerank":
                extra = (f"; device combines max |Δ| "
                         f"{res['combine_max_abs_err']:.3g}, "
                         f"{res['combine_model_share']:.3g} of the rounding "
                         f"model; ranks max |Δ| {res['max_abs_err']:.3g} "
                         f"(max relative {res['max_rel_err']:.3g}), L1 "
                         f"{res['l1_err']:.3g}"
                         + (f", gate {PAGERANK_F64_ABS}" if kw else ""))
            elif name == "bc":
                extra = f"; max |Δ| {res['max_abs_err']:.3g}"
            log(f"  {tag}: {info_t.rounds} rounds, wall {wall:.3f} s "
                f"(oracle {wall_ora:.3f} s), {be_a.host_syncs} rounds on "
                f"the device route of combine_by_key; rounds and "
                f"signatures equal{'' if name in ('pagerank', 'bc') else ', values exact'}"
                f"{extra}")
        del og_t, og_n, g
        if device == "cuda":
            torch.cuda.empty_cache()
    return st.rows, expected, root_call


def ingest_histogram_timing(dev, call, launches: int) -> dict:
    """K1 at the Erdős-Rényi ingest's Phase-1 root call (every edge's
    source, weighted by the meta-task counts the engine passes, over
    2^GRAPH_SCALE bins): the largest n >> bins call of any path."""
    keys, bins, weights = call
    shape = _histogram_shape("ingest root call", _i32(keys, dev),
                             _i32(weights, dev), bins, launches)
    _log_shapes("histogram", [shape])
    return shape


# ---------------------------------------------------------------------------
# phase 10: the KV store and the streaming serve tier
# ---------------------------------------------------------------------------
# benchmarks/bench_ycsb.py's full setting (P = 16, 50,000 tasks a machine,
# 16 keys a task, rows of 16 words) and benchmarks/bench_serve.py's stream
# (Zipf 1.5, 10% read-modify-writes of (1.0, 0.5), its open-loop window)
SERVE_P = 16
SERVE_TPM = 50_000
SERVE_KEYS = 16 * SERVE_TPM  # 800,000 rows of 16: 51 MB of float32
SERVE_WIDTH = 16
SERVE_GAMMA = 1.5
SERVE_SEED = 29
MGET_N = 100_000  # one-shot multi-get tasks, arity 1-8
CHAIN_N = 100_000  # one-shot read-modify-write chains
CHAIN_HOPS = 4
STREAM_N = 65_536  # sync-mode GET / RMW requests
STREAM_MGETS = 4_096  # sync-mode multi-gets, arity 1-8
STREAM_BATCHES = (256, 8_192)
THREAD_N = 20_000  # bench_serve's open-loop count
THREAD_LOAD = 0.8  # offered: this share of the sync rate at max_batch 256
THREAD_TURNS = (True, False, False, True)  # prefetch on / off, in turns
THREAD_WINDOW = {"max_batch": 256, "min_window": 100e-6,
                 "max_window": 5e-3, "max_queue": 1 << 15}
RMW_OPERAND = (1.0, 0.5)
FRONT_T = 128  # tokens through MoEFrontend
FRONT_N = 8_192  # lookups, bags and gradient pushes a front door's stage

# launches of the one-shot stages: K2 for every write merge (each YCSB batch,
# each chain hop); no K1, as every Phase-1 root call here covers fewer than
# an eighth of the 800,000 keys (the backend's host cutoff), and no K3, as
# the KV lambdas are not fused reads
SERVE_EXPECTED = {
    "ycsb_A": _launch(segment_combine=1),
    "ycsb_B": _launch(segment_combine=1),
    "multi_get": _launch(),
    "chain": _launch(segment_combine=CHAIN_HOPS),
    "moe_front": _launch(histogram=1), "moe_shot": _launch(histogram=1),
    "embed_front": _launch(histogram=2, stage_fused=1, segment_combine=1),
    "embed_shot": _launch(histogram=2, stage_fused=1),
}
# launches of one streamed batch, by kind: a GET / RMW batch with a writer
# combines once (K2); the GETs-only batch and the multi-gets launch nothing
# (their Phase-1 calls cover at most 8,192 keys of 800,000: the host route)
SERVE_BATCH = {"kv_write": _launch(segment_combine=1), "kv_read": _launch(),
               "mget": _launch()}


def _capture(sess) -> list:
    """The OrchestrationResult of every stage `sess` runs from now on (for
    `exec_site`, which the kvstore results do not carry)."""
    box, inner = [], sess.run_stage

    def run_stage(*a, **k):
        res = inner(*a, **k)
        box.append(res)
        return res

    sess.run_stage = run_stage
    return box


def _kv_table(device, K, init):
    from repro_torch.kvstore import DistributedHashTable

    t = DistributedHashTable(K, SERVE_P, value_width=SERVE_WIDTH,
                             seed=SERVE_SEED)
    t.bulk_load(np.arange(K), init)
    return t


def _card_backend(device):
    """None (the entry points' default: the card) on the card; the plain
    versions on the CPU for a rehearsal."""
    from repro_torch.core import TorchBackend

    return None if device == "cuda" else TorchBackend(device=device)


def _no_host_route(name, table) -> None:
    for sess in table._sessions.values():
        be = sess.backend
        if getattr(be, "_host_lambdas", None):
            raise AssertionError(f"{name}: a lambda fell back to the host")


def _results_close(name, got, want) -> float:
    """Fetched rows, float32 of the float64 rows: |Δ| <= 1e-6·|want| +
    1e-6 (one rounding is 2^-24·|want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return _sum_bound_ok(got, want, np.abs(want), name=name)


def kv_one_shot(device, st, K, tpm, n_mget, n_chain, init) -> dict:
    """execute_batch (YCSB A and B), multi_get and run_chain through the
    table's entry points on the card, each against the numpy backend on a
    twin table that starts from the card table's values (so each check sees
    one stage's rounding): bills, refcounts and exec sites exactly, values
    within `_check_values`' gates; execute_batch also against
    `DistributedHashTable.oracle`."""
    from repro_torch.kvstore import DistributedHashTable, make_ycsb_stream
    from repro_torch.kvstore.ycsb import zipf_keys_stationary

    be = _card_backend(device)
    t_dev, t_ora = _kv_table(device, K, init), _kv_table(device, K, init)
    box_dev = _capture(t_dev.session(backend=be))
    box_ora = _capture(t_ora.session(backend="numpy"))
    out = {}

    def twin():
        t_ora.store.write_rows(np.arange(K), t_dev.values)
        box_dev.clear()
        box_ora.clear()
        return t_dev.values.copy()

    def same_sites(tag):
        if len(box_dev) != len(box_ora) or not all(
                np.array_equal(a.exec_site, b.exec_site)
                for a, b in zip(box_dev, box_ora)):
            raise AssertionError(f"{tag}: exec_site differs")

    for wl in ("A", "B"):
        tag = f"ycsb_{wl}"
        keys, is_read, operand = next(make_ycsb_stream(
            wl, tpm, SERVE_P, K, SERVE_GAMMA, SERVE_SEED))
        old = twin()
        r_dev = st.run(tag, lambda: t_dev.execute_batch(
            keys, is_read, operand, backend=be), tasks=keys.size)
        t0 = time.perf_counter()
        r_ora = t_ora.execute_batch(keys, is_read, operand, backend="numpy")
        st.rows[-1]["oracle_wall_s"] = time.perf_counter() - t0
        _same_bill(tag, r_dev, r_ora)
        same_sites(tag)
        tasks = t_dev._make_batch(keys, is_read, operand, None)
        mags = np.abs(old[keys]) * np.abs(operand[:, 0:1]) \
            + np.abs(operand[:, 1:2])
        err = _results_close(tag, r_dev.values, r_ora.values)
        _check_values(tag, t_dev.values, t_ora.values, old, tasks, mags,
                      "write")
        want_vals, want_res = DistributedHashTable.oracle(
            old, keys, is_read, operand)
        _results_close(f"{tag} oracle", r_dev.values, want_res)
        val_err, share = _check_values(f"{tag} oracle", t_dev.values,
                                       want_vals, old, tasks, mags, "write")
        st.rows[-1].update(max_result_err=err, max_value_err=val_err,
                           max_value_err_share_of_tolerance=share,
                           reads=int(is_read.sum()))
        out[tag] = _log_one_shot(st.rows[-1], f"{keys.size} operations, "
                                 f"{int(is_read.sum())} reads")

    rng = np.random.default_rng(SERVE_SEED + 1)
    perm = rng.permutation(K)
    arity = rng.integers(1, 9, n_mget)
    indptr = np.zeros(n_mget + 1, dtype=np.int64)
    np.cumsum(arity, out=indptr[1:])
    indices = zipf_keys_stationary(int(indptr[-1]), K, SERVE_GAMMA, rng, perm)
    twin()
    r_dev = st.run("multi_get", lambda: t_dev.multi_get(
        (indptr, indices), backend=be), tasks=n_mget, pairs=indices.size)
    t0 = time.perf_counter()
    r_ora = t_ora.multi_get((indptr, indices), backend="numpy")
    oracle_wall = time.perf_counter() - t0
    _same_bill("multi_get", r_dev, r_ora)
    same_sites("multi_get")
    if not np.array_equal(r_dev.mask, r_ora.mask):
        raise AssertionError("multi_get: mask differs")
    m = r_dev.mask
    st.rows[-1].update(oracle_wall_s=oracle_wall,
                       max_result_err=_results_close(
                           "multi_get", r_dev.values[m], r_ora.values[m]))
    out["multi_get"] = _log_one_shot(st.rows[-1], f"{n_mget} tasks, "
                                     f"{indices.size} pairs")

    keys = zipf_keys_stationary(n_chain * CHAIN_HOPS, K, SERVE_GAMMA, rng,
                                perm).reshape(n_chain, CHAIN_HOPS)
    operand = rng.random((n_chain, 2))
    old = twin()
    c_dev = st.run("chain", lambda: t_dev.run_chain(keys, operand,
                                                    backend=be),
                   tasks=n_chain, hops=CHAIN_HOPS)
    t0 = time.perf_counter()
    c_ora = t_ora.run_chain(keys, operand, backend="numpy")
    st.rows[-1]["oracle_wall_s"] = time.perf_counter() - t0
    if c_dev.hops != c_ora.hops or not np.array_equal(c_dev.keys,
                                                      c_ora.keys):
        raise AssertionError("chain: hops or keys differ")
    for j, (a, b) in enumerate(zip(c_dev.reports, c_ora.reports)):
        if a.phase_signature() != b.phase_signature():
            raise AssertionError(f"chain hop {j}: phase_signature differs")
    same_sites("chain")
    # each hop rounds v·m + a once in float32, 2^-24 of its magnitude; four
    # hops compound to under 4·3·2^-24 ≈ 7e-7 of it (|v| < 5 here): the
    # gate 1e-5·|want| + 1e-5 covers that many times over
    live = ~np.isnan(c_ora.values)
    allowed = 1e-5 * np.abs(c_ora.values[live]) + 1e-5
    err = np.abs(c_dev.values[live] - c_ora.values[live])
    table_err = np.abs(t_dev.values - t_ora.values)
    if not (np.array_equal(live, ~np.isnan(c_dev.values))
            and (err <= allowed).all()
            and (table_err <= 1e-5 * np.abs(t_ora.values) + 1e-5).all()):
        raise AssertionError(f"chain: values beyond 1e-5·|want| + 1e-5 "
                             f"(max |Δ| {err.max()}, table "
                             f"{table_err.max()})")
    st.rows[-1].update(max_result_err=float(err.max()),
                       max_value_err=float(table_err.max()))
    out["chain"] = _log_one_shot(st.rows[-1], f"{n_chain} chains of "
                                 f"{c_dev.hops} hops")
    del old
    _no_host_route("one-shot", t_dev)
    return out


def _log_one_shot(row, what) -> dict:
    log(f"  {row['stage']} ({what}): wall {row['wall_s']:.3f} s (numpy "
        f"oracle {row['oracle_wall_s']:.3f} s); bills, refcounts and exec "
        f"sites equal, max |Δ| results {row['max_result_err']:.3g}"
        + (f", table {row['max_value_err']:.3g}"
           if "max_value_err" in row else ""))
    return row


def serve_stream(K, n, n_mget, seed):
    """The closed-loop stream: GETs and RMWs (1.0, 0.5) on Zipf 1.5 keys of
    a stationary hot set, and multi-gets of arity 1-8, one after every
    n / n_mget GET / RMW requests."""
    from repro_torch.kvstore.ycsb import zipf_keys_stationary

    rng = np.random.default_rng(seed)
    perm = rng.permutation(K)
    keys = zipf_keys_stationary(n, K, SERVE_GAMMA, rng, perm)
    is_rmw = rng.random(n) < 0.10
    arity = rng.integers(1, 9, n_mget)
    flat = zipf_keys_stationary(int(arity.sum()), K, SERVE_GAMMA, rng, perm)
    groups = np.split(flat, np.cumsum(arity)[:-1]) if n_mget else []
    return dict(keys=keys, is_rmw=is_rmw, groups=groups,
                mget_after=(np.arange(n_mget) * n) // max(n_mget, 1))


def _drive(fe, stream, rate=None):
    """Submit the stream (paced at `rate` requests/s if given); returns the
    futures in request order: GET / RMW requests, then multi-gets."""
    keys, is_rmw, groups = stream["keys"], stream["is_rmw"], stream["groups"]
    after = stream["mget_after"]
    kv, mg, j = [], [], 0
    t0 = time.monotonic()
    for i in range(keys.size):
        if rate is not None:
            lag = t0 + i / rate - time.monotonic()
            if lag > 1e-4:
                time.sleep(lag)
        kv.append(fe.read_modify_write(int(keys[i]), *RMW_OPERAND)
                  if is_rmw[i] else fe.get(int(keys[i])))
        while j < len(groups) and after[j] == i:
            mg.append(fe.multi_get(groups[j]))
            j += 1
    return kv, mg


def _record_batches(fe) -> list:
    """The batches the frontend's executor runs, in order, as (tag, request
    futures): recorded here by wrapping the frontend object's `_execute`,
    not in the library."""
    ran, inner = [], fe._execute

    def execute(prepared):
        ran.append((prepared.spec.name,
                    [r.future for r in prepared.requests]))
        inner(prepared)

    fe._execute = execute
    return ran


def _batches_as_requests(ran, kv, mg):
    """(tag, request indices) of each executed batch."""
    index = {id(f): i for i, f in enumerate(kv)}
    index.update({id(f): i for i, f in enumerate(mg)})
    return [(tag, np.array([index[id(f)] for f in futs], dtype=np.int64))
            for tag, futs in ran]


def _batch_kind(tag, idx, stream) -> str:
    if tag == "mget":
        return "mget"
    return "kv_write" if stream["is_rmw"][idx].any() else "kv_read"


def _one_shot_batch(table, tag, idx, stream, backend):
    """The batch `execute_batch` / `multi_get` builds for these requests:
    the per-request results, in batch order."""
    if tag == "kv":
        rmw = stream["is_rmw"][idx]
        operand = np.where(rmw[:, None], RMW_OPERAND, (1.0, 0.0))
        res = table.execute_batch(stream["keys"][idx], ~rmw, operand,
                                  backend=backend)
        return list(res.values)
    res = table.multi_get([stream["groups"][i] for i in idx],
                          backend=backend)
    return [res.values[j][res.mask[j]] for j in range(idx.size)]


def _replay_numpy(name, table, served, batches, stream, kv, mg) -> float:
    """Replay the executed batches through the numpy backend on `table`,
    which starts from the served table's initial values; every request's
    result and the final table against the card's (`served`). The card's
    values drift from float64 by one float32 rounding (2^-24·|v|) at each
    write of a key, and by one at the load: a row read or left after w
    writes is held to (w + 1)·2^-23·|v| + 1e-6 (twice the drift). Returns
    the largest share of that gate."""
    writes = np.zeros(table.store.num_keys, dtype=np.int64)
    worst = 0.0

    def gate(got, want, w):
        nonlocal worst
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        allowed = (w[:, None] + 1) * 2 * U32 * np.abs(want) + 1e-6
        err = np.abs(got - want)
        if got.shape != want.shape or not (err <= allowed).all():
            raise AssertionError(f"{name} numpy replay: |Δ| {err.max()} "
                                 "beyond (w + 1)·2^-23·|want| + 1e-6")
        worst = max(worst, float((err / allowed).max(initial=0.0)))

    for tag, idx in batches:
        want = _one_shot_batch(table, tag, idx, stream, "numpy")
        futs = kv if tag == "kv" else mg
        for j, i in enumerate(idx):
            ks = np.atleast_1d(stream["keys"][i] if tag == "kv"
                               else stream["groups"][i])
            gate(np.atleast_2d(futs[i].result(timeout=0)),
                 np.atleast_2d(want[j]), writes[ks])
        if tag == "kv":
            written = np.unique(stream["keys"][idx][stream["is_rmw"][idx]])
            writes[written] += 1
    gate(served.values, table.values, writes)
    return worst


def _check_futures(name, kv, mg, fe) -> None:
    """Every future resolved, none with an error, no admission refused."""
    errors = []
    for f in kv + mg:
        try:
            f.result(timeout=0)
        except Exception as exc:  # noqa: BLE001 - collected, then raised
            errors.append(exc)
    if errors or fe.stats.failed or fe.stats.rejected:
        raise AssertionError(
            f"{name}: {len(errors)} futures unresolved or rejected (failed "
            f"{fe.stats.failed}, refused {fe.stats.rejected})"
            + (f"; first: {errors[0]!r}" if errors else ""))


def _note_launches(st, tag, ran, kinds) -> dict:
    """A streamed run's launches against its batches' kinds (SERVE_BATCH),
    checked and kept in `st.expected` like a stage's."""
    expected = _launch()
    for k in kinds:
        expected = _plus(expected, SERVE_BATCH[k])
    st.expected[tag] = expected
    if st.device == "cuda" and ran != expected:
        raise AssertionError(f"stage {tag}: kernel launches {ran}, "
                             f"expected {expected}")
    return expected


def serve_sync(device, st, K, init, stream, max_batch) -> dict:
    """The closed loop in sync mode at `max_batch`, only the size trigger
    firing: every request bit-identical to `execute_batch` / `multi_get`
    on the card over the same coalesced batches (a twin table replays
    them), and within the replay gate of the numpy backend."""
    be = _card_backend(device)
    table, twin = _kv_table(device, K, init), _kv_table(device, K, init)
    fe = table.serve(backend=be, mode="sync", config={
        "max_batch": max_batch, "min_window": 1.0, "max_window": 1.0,
        "max_queue": 1 << 16})
    ran = _record_batches(fe)
    tag = f"sync{max_batch}"
    before = _launch_counts()
    t0 = time.perf_counter()
    kv, mg = _drive(fe, stream)
    fe.flush()
    fe.drain()
    wall = time.perf_counter() - t0
    launches = _launch_counts(before)
    rep = fe.report()
    fe.close()
    _check_futures(tag, kv, mg, fe)
    batches = _batches_as_requests(ran, kv, mg)
    kinds = [_batch_kind(t, i, stream) for t, i in batches]
    st.expected[f"{tag}_replay"] = _note_launches(st, tag, launches, kinds)
    row = dict(stage=tag, wall_s=wall, launches=launches,
               requests=len(kv) + len(mg), batches=len(batches))
    st.rows.append(row)
    twin_be = _card_backend(device)
    shots = st.run(f"{tag}_replay", lambda: [
        _one_shot_batch(twin, b_tag, idx, stream, twin_be)
        for b_tag, idx in batches])
    replay_wall = st.rows[-1]["wall_s"]
    for (b_tag, idx), want in zip(batches, shots):
        futs = kv if b_tag == "kv" else mg
        for j, i in enumerate(idx):
            if not np.array_equal(futs[i].result(timeout=0), want[j]):
                raise AssertionError(f"{tag}: request {b_tag}#{i} differs "
                                     "from the one-shot batch")
    if not np.array_equal(table.values, twin.values):
        raise AssertionError(f"{tag}: the table differs from the one-shot "
                             "batches'")
    worst = _replay_numpy(tag, _kv_table(device, K, init), table, batches,
                          stream, kv, mg)
    _no_host_route(tag, table)
    _no_host_route(f"{tag} replay", twin)
    exec_s = fe.stats.overlap.busy["exec"]
    row.update(requests_per_s=row["requests"] / wall,
               ms_per_batch=wall / len(batches) * 1e3,
               exec_ms_per_batch=exec_s / len(batches) * 1e3,
               admission_us_per_request=(wall - exec_s) / row["requests"]
               * 1e6,
               batches_by_trigger=rep["batches_by_trigger"],
               kinds={k: kinds.count(k) for k in SERVE_BATCH},
               p50_s=rep["p50_s"], p99_s=rep["p99_s"],
               replay_share_of_gate=worst)
    log(f"  {tag}: {row['requests']} requests in {len(batches)} batches "
        f"({row['kinds']}; triggers {rep['batches_by_trigger']}), wall "
        f"{wall:.3f} s = {row['requests_per_s']:.0f} requests/s: the "
        f"executor {row['exec_ms_per_batch']:.3f} ms a batch, admission "
        f"{row['admission_us_per_request']:.1f} us a request; every result "
        f"bit-identical to the one-shot batches (their wall "
        f"{replay_wall:.3f} s), the numpy replay within {worst:.3g} of its "
        "gate")
    return row


def prefetch_cost(device, K, init, reps: int = 200) -> dict:
    """Host time, single-threaded, of what `TorchBackend.prefetch` moves
    off the executor for a 256-request GET batch: the prefetch itself
    (pinned copy, side-stream copy, event), the executor's pickup of the
    staged contexts (event wait, `record_stream`) and the upload the
    executor makes without a prefetch (one pageable copy); medians of
    `reps` calls, synchronized between calls."""
    import torch

    from repro_torch.core import make_backend

    table = _kv_table(device, K, init)
    be = make_backend(_card_backend(device))
    n = THREAD_WINDOW["max_batch"]
    tasks = table._make_batch(np.arange(n), np.ones(n, dtype=bool),
                              np.tile((1.0, 0.0), (n, 1)), None)
    times = {"prefetch_us": [], "pickup_us": [], "upload_us": []}

    def clock(key, fn):
        if be.device.type == "cuda":
            torch.cuda.synchronize(be.device)
        t0 = time.perf_counter()
        fn()
        times[key].append((time.perf_counter() - t0) * 1e6)

    for _ in range(reps):
        clock("prefetch_us", lambda: be.prefetch(tasks, table.store))
        clock("pickup_us", lambda: be._dctx(tasks))
        clock("upload_us", lambda: be._dctx(tasks))
    out = {k: float(np.median(v)) for k, v in times.items()}
    log(f"  prefetch of a {n}-request batch's contexts: "
        f"{out['prefetch_us']:.1f} us of the router's time; the executor's "
        f"pickup {out['pickup_us']:.1f} us against an upload of "
        f"{out['upload_us']:.1f} us without it (medians of {reps})")
    return out


def serve_busy(device, st, K, init) -> dict:
    """Device busy and idle share of the serve tier (`device_busy`): a
    sync-mode run at max_batch 256 of a quarter of the closed-loop stream
    (16,384 GET / RMW requests and 1,024 multi-gets), on a fresh table."""
    table = _kv_table(device, K, init)
    stream = serve_stream(K, STREAM_N // 4, STREAM_MGETS // 4,
                          SERVE_SEED + 4)
    fe = table.serve(backend=_card_backend(device), mode="sync", config={
        "max_batch": 256, "min_window": 1.0, "max_window": 1.0,
        "max_queue": 1 << 16})
    ran, futs = _record_batches(fe), []
    before = _launch_counts()

    def run():
        futs.extend(_drive(fe, stream))
        fe.flush()

    row = dict(stage="busy_sync256", **device_busy("busy_sync256", run))
    fe.close()
    kv, mg = futs
    batches = _batches_as_requests(ran, kv, mg)
    _note_launches(st, "busy_sync256", _launch_counts(before),
                   [_batch_kind(t, i, stream) for t, i in batches])
    row.update(requests=len(kv) + len(mg), batches=len(batches))
    _log_busy(f"sync256 under the profiler ({row['requests']} requests, "
              f"{len(batches)} batches)", row)
    return row


def serve_thread(device, st, K, init, stream, rate, tag,
                 prefetch=True) -> dict:
    """bench_serve's open loop in thread mode: the stream offered at `rate`
    requests/s to the router / executor pair. Every future must resolve
    without an error, and replaying the batches the executor ran through the
    numpy backend must give each result and the final table within the
    replay gate. `prefetch=False` runs the same with the backend's prefetch
    a no-op (overridden on this backend object only), to see what staging
    the contexts takes off the executor."""
    be = _card_backend(device)
    table = _kv_table(device, K, init)
    fe = table.serve(backend=be, mode="thread", config=THREAD_WINDOW)
    backend = fe.sessions[0].backend
    if not prefetch:
        backend.prefetch = lambda tasks, store: None
    ran = _record_batches(fe)
    before = _launch_counts()
    t0 = time.perf_counter()
    kv, mg = _drive(fe, stream, rate=rate)
    fe.drain(timeout=300.0)
    wall = time.perf_counter() - t0
    rep = fe.report()
    fe.close()
    ran_launches = _launch_counts(before)
    _check_futures(tag, kv, mg, fe)
    batches = _batches_as_requests(ran, kv, mg)
    _note_launches(st, tag, ran_launches,
                   [_batch_kind(t, i, stream) for t, i in batches])
    worst = _replay_numpy(tag, _kv_table(device, K, init), table, batches,
                          stream, kv, mg)
    _no_host_route(tag, table)
    busy = fe.stats.overlap.busy
    row = dict(stage=tag, wall_s=wall, launches=ran_launches,
               requests=len(kv) + len(mg), offered_per_s=rate,
               requests_per_s=rep["completed"] / wall,
               p50_s=rep["p50_s"], p99_s=rep["p99_s"],
               overlap_frac=rep["overlap_fraction"],
               exec_busy_s=busy["exec"], route_busy_s=busy["route"],
               batches=len(batches), merged=rep["merged_batches"],
               exec_ms_per_batch=busy["exec"] / len(batches) * 1e3,
               occupancy=rep["batch_occupancy"],
               queue_peak=rep["queue_peak"], replay_share_of_gate=worst)
    st.rows.append(row)
    log(f"  {tag}: {row['requests']} requests offered at {rate:.0f}/s: "
        f"{row['requests_per_s']:.0f} requests/s, p50 "
        f"{row['p50_s'] * 1e3:.3f} ms, p99 {row['p99_s'] * 1e3:.3f} ms, "
        f"overlap_frac {row['overlap_frac']:.4f}; {len(batches)} batches "
        f"({row['merged']} merged, occupancy {row['occupancy']:.3f}), "
        f"executor {row['exec_ms_per_batch']:.3f} ms a batch, router "
        f"{busy['route']:.3f} s; the numpy replay within {worst:.3g} of its "
        "gate")
    return row


def _launch_counts(before=None) -> dict:
    from repro_torch import kernels

    now = kernels.launches()
    return now if before is None else {k: v - before[k]
                                       for k, v in now.items()}


def front_doors(device, st, ps: dict) -> dict:
    """MoEFrontend and EmbeddingFrontend at phase 4's granite widths (its
    router and table): 128 routed tokens bit-identical to `decode_step` on
    the card for the same admission order (and within DECODE_REL of the
    float64 expert reference); 8,192 lookups and bags bit-identical to
    `lookup` / `lookup_bags`; 8,192 gradient pushes within K2's sum bound
    of the float64 update."""
    from repro_torch.kvstore.ycsb import zipf_keys_stationary
    from repro_torch.paramserve import EmbeddingStore

    be = _card_backend(device)
    router, store = ps["router"], ps["store"]
    sync = {"min_window": 1.0, "max_window": 1.0}
    x, ti, g = router.zipf_routing(FRONT_T, alpha=PS_ALPHA,
                                   seed=PS_SEED + 100, rank_perm=ps["perm"])
    fe = router.serve(backend=be, mode="sync",
                      config={"max_batch": FRONT_T, **sync})

    def decode_all():
        futs = [fe.decode(x[t], ti[t], g[t]) for t in range(FRONT_T)]
        return np.stack([f.result(timeout=0) for f in futs])

    y = st.run("moe_front", decode_all, tokens=FRONT_T)
    fe.close()
    one = st.run("moe_shot", lambda: router.decode_step(x, ti, g,
                                                        backend=be))
    if fe.stats.batches != 1 or not np.array_equal(y, one.y):
        raise AssertionError("MoEFrontend: not bit-identical to decode_step")
    w_in, w_out = router.layer_weights(0)
    err = _check_close("moe_front", y, expert_reference(x, ti, g, w_in,
                                                        w_out))
    st.rows[-2]["max_abs_err"] = err

    rng = np.random.default_rng(PS_SEED + 100)
    V, d = store.V, store.d
    perm = rng.permutation(V)
    ids = zipf_keys_stationary(FRONT_N, V, PS_ALPHA, rng, perm)
    arity = rng.integers(1, 9, FRONT_N)
    flat = zipf_keys_stationary(int(arity.sum()), V, PS_ALPHA, rng, perm)
    bags = np.split(flat, np.cumsum(arity)[:-1])
    up_ids = zipf_keys_stationary(FRONT_N, V, PS_ALPHA, rng, perm)
    grads = rng.standard_normal((FRONT_N, d))
    # the front door and the one-shot calls each start from one upload of
    # the same host table (the card's float32 copy after phase 4's push
    # holds sums rounded on the card, not the host's float64 ones)
    table0 = store.table.copy()
    store.store.write_rows(np.arange(V), table0)
    fe = store.serve(backend=be, mode="sync",
                     config={"max_batch": FRONT_N, **sync})

    def serve_all():
        lk = [fe.lookup(int(i)) for i in ids]
        bg = [fe.lookup_bag(b) for b in bags]
        gr = [fe.push_grad(int(i), gv) for i, gv in zip(up_ids, grads)]
        fe.flush()
        return ([f.result(timeout=0) for f in lk],
                [f.result(timeout=0) for f in bg],
                [f.result(timeout=0) for f in gr])

    lk, bg, gr = st.run("embed_front", serve_all, requests=3 * FRONT_N)
    fe.close()
    if fe.stats.batches != 3 or any(r is not None for r in gr):
        raise AssertionError("EmbeddingFrontend: batches or pushes differ")
    want = EmbeddingStore.oracle_update(table0, up_ids, grads)
    mags = EmbeddingStore.oracle_update(np.abs(table0), up_ids,
                                        np.abs(grads))
    grad_err = _sum_bound_ok(store.table, want, mags, rel_want=1e-5,
                             name="push_grad")
    store.store.write_rows(np.arange(V), table0)
    indptr = np.zeros(FRONT_N + 1, dtype=np.int64)
    np.cumsum(arity, out=indptr[1:])

    def one_shot():
        return (store.lookup(ids, backend=be).values,
                store.lookup_bags((indptr, flat), backend=be).values)

    want_lk, want_bg = st.run("embed_shot", one_shot)
    if not (np.array_equal(np.stack(lk), want_lk)
            and np.array_equal(np.stack(bg), want_bg)):
        raise AssertionError("EmbeddingFrontend: lookups or bags not "
                             "bit-identical to lookup / lookup_bags")
    st.rows[-2]["max_abs_err"] = grad_err
    for sess in list(router._sessions.values()) + list(
            store._sessions.values()):
        if getattr(sess.backend, "_host_lambdas", None):
            raise AssertionError("front doors: a lambda fell back to the "
                                 "host")
    walls = {r["stage"]: r["wall_s"] for r in st.rows[-4:]}
    log(f"  MoEFrontend: {FRONT_T} tokens in one batch "
        f"({walls['moe_front']:.4f} s; decode_step {walls['moe_shot']:.4f} "
        f"s), bit-identical to decode_step, max |Δ| {err:.3g} from the "
        f"float64 reference; 3 x {FRONT_N} embedding requests "
        f"{walls['embed_front']:.4f} s (lookup + lookup_bags "
        f"{walls['embed_shot']:.4f} s); "
        f"EmbeddingFrontend: {FRONT_N} lookups and bags bit-identical to "
        f"lookup / lookup_bags, {FRONT_N} gradient pushes max |Δ| "
        f"{grad_err:.3g} (within 1e-6·Σ|terms| + 1e-5·|want| + 1e-6)")
    return dict(moe_max_abs_err=err, grad_max_abs_err=grad_err)


def serve_path(device: str, ps: dict, *,
               K: int = SERVE_KEYS, tpm: int = SERVE_TPM,
               n_mget: int = MGET_N, n_chain: int = CHAIN_N,
               n_stream: int = STREAM_N, n_stream_mget: int = STREAM_MGETS,
               n_thread: int = THREAD_N, batches=STREAM_BATCHES):
    """Phase 10: the one-shot KV stages, the closed loop in sync mode at
    each of `batches`, the open loop in thread mode (with and without
    prefetch) and the parameter-server front doors (on `ps`, phase 4's
    tensors). Returns (rows, summary, expected launches by stage). The
    keyword sizes cut it down for a rehearsal on the CPU."""
    st = _Stages(device, dict(SERVE_EXPECTED))
    init = np.random.default_rng(SERVE_SEED).random((K, SERVE_WIDTH))
    summary = {"one_shot": kv_one_shot(device, st, K, tpm, n_mget, n_chain,
                                       init)}
    stream = serve_stream(K, n_stream, n_stream_mget, SERVE_SEED + 2)
    sync = {b: serve_sync(device, st, K, init, stream, b) for b in batches}
    rate = THREAD_LOAD * sync[batches[0]]["requests_per_s"]
    t_stream = serve_stream(K, n_thread, 0, SERVE_SEED + 3)
    # with prefetch and without, in turns: the two are compared only
    # within this run, and the turns show the spread between runs
    summary["thread"] = [
        serve_thread(device, st, K, init, t_stream, rate,
                     f"thread{i}" + ("" if on else "_no_prefetch"), on)
        for i, on in enumerate(THREAD_TURNS)]
    summary["prefetch_cost"] = prefetch_cost(device, K, init)
    if device == "cuda":  # the profiler reads the card's events
        summary["busy"] = serve_busy(device, st, K, init)
    summary["front_doors"] = front_doors(device, st, ps)
    return st.rows, summary, st.expected


# ---------------------------------------------------------------------------
# phase 11: elasticity at the main path's size
# ---------------------------------------------------------------------------
ELASTIC_STAGES = 6  # stages a recovery arm runs
KILL_AT = 3  # the stage boundary at which machines die
RESTART_DEAD = [2, 9]
SHRINK_DEAD = [5]
CHAIN_KILL = {2: [4]}  # run_chain: machine 4 dies before hop 2
ELASTIC_SERVE = {"stealing": True, "migration": True}
# benchmarks/bench_elastic.py's traffic and knobs at its full setting, over
# the main path's table: machine m's era-A hot set is keys [16m, 16m + 16)
# (homed on m), its era-B one [128 + 16m, ...) (homed on m % 2)
MIG_P = 8
MIG_HOT = 16
MIG_ERA_B = MIG_P * MIG_HOT
MIG_HOT_FRAC = 0.8
MIG_ALPHA = 1.3
MIG_SEED = 23
MIG_TPM = 4_000
MIG_ERAS = (10, 12)
MIG_WINDOW = 6
MIGRATION = {"refresh": 2, "decay": 0.5, "min_count": 16.0,
             "max_moves": 256}
MIG_GATE = 0.10  # bench_elastic.py's: recovered within 10%, control > 1.10x


def _elastic_clock(sess) -> dict:
    """Milliseconds of the session's boundary snapshots, recoveries and
    full-table uploads (a miss of the backend's value cache), each
    synchronized: wrappers on this session's objects, not in the
    library."""
    import torch

    clock = {"snapshot_ms": [], "recovery_ms": [], "upload_ms": []}
    be = sess.backend

    def sync():
        if be.device.type == "cuda":
            torch.cuda.synchronize(be.device)

    def timed(obj, name, key):
        inner = getattr(obj, name)

        def wrapper(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = inner(*a, **k)
            sync()
            clock[key].append((time.perf_counter() - t0) * 1e3)
            return out

        setattr(obj, name, wrapper)

    rec = sess.elastic.recovery if sess.elastic is not None else None
    if rec is not None:
        timed(rec, "_snapshot", "snapshot_ms")
        timed(rec, "_recover", "recovery_ms")
    inner_dv = be.device_values

    def device_values(store):
        ent = store.__dict__.get("_device_values", {}).get(be._cache_key())
        if ent is not None and ent[0] == store.version:
            return inner_dv(store)
        sync()
        t0 = time.perf_counter()
        out = inner_dv(store)
        sync()
        clock["upload_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    be.device_values = device_values
    return clock


def _fresh_store(K, init, machines=P):
    from repro_torch.core import DataStore

    s = DataStore.create(K, machines, value_width=VALUE_WIDTH)
    s.write_rows(np.arange(K), init)
    return s


def elastic_recovery(device, st, K, stage, init, tmp) -> dict:
    """(a) Stage (a)'s traffic for ELASTIC_STAGES stages in three sessions
    on copies of one store: uninterrupted; restart (machines RESTART_DEAD
    die at KILL_AT; durable snapshots every 2 stages); shrink (SHRINK_DEAD
    dies for good). Each elastic session is held to a numpy session under
    the same spec (every stage's `phase_signature()`, elastic phases
    included, and `exec_site`; the counters and homes), the restart arm's
    bills to the uninterrupted run's without the elastic phases, and every
    elastic stage's values to a plain numpy stage from the card's pre-stage
    values (`_check_values`: a lost row restored wrong fails it)."""
    from repro_torch.core import ELASTIC_PHASES, Orchestrator
    from repro_torch.core.cost import assert_cost_parity

    _, desc, tasks, f, merge, _, _ = stage

    def spec(arm, who):
        if arm == "restart":
            return {"recovery": {"injector": {KILL_AT: RESTART_DEAD},
                                 "checkpoint_every": 2,
                                 "directory": str(tmp / f"{arm}-{who}")}}
        if arm == "shrink":
            return {"recovery": {"injector": {KILL_AT: SHRINK_DEAD},
                                 "on_failure": "shrink"}}
        return None

    chk_store = _fresh_store(K, init)
    chk = Orchestrator(chk_store, backend="numpy")
    bills, out = {}, {}
    for arm in ("uninterrupted", "restart", "shrink"):
        s_dev = Orchestrator(_fresh_store(K, init),
                             backend=_torch_backend(device),
                             elasticity=spec(arm, "card"))
        s_ora = None if arm == "uninterrupted" else Orchestrator(
            _fresh_store(K, init), backend="numpy",
            elasticity=spec(arm, "numpy"))
        _timed_backend(s_dev.backend)
        clock = _elastic_clock(s_dev)
        bills[arm] = []
        for k in range(ELASTIC_STAGES):
            tag = f"recovery/{arm}{k}"
            st.expected[tag] = EXPECTED_LAUNCHES["a"]
            old = s_dev.store.values.copy() if s_ora is not None else None
            seen = {key: len(v) for key, v in clock.items()}
            s_dev.backend.numerics_s = 0.0
            r_dev = st.run(tag, lambda: s_dev.run_stage(
                tasks, f, write_back=merge), desc=desc, tasks=tasks.n)
            row = st.rows[-1]
            row.update({key: v[seen[key]:] for key, v in clock.items()},
                       numerics_s=s_dev.backend.numerics_s)
            if s_dev.backend._host_lambdas:
                raise AssertionError(f"{tag}: a lambda fell back to the "
                                     "host path")
            bills[arm].append(r_dev.report)
            if arm == "restart":
                assert_cost_parity(bills["uninterrupted"][k], r_dev.report,
                                   ignore=ELASTIC_PHASES)
            if s_ora is not None:
                t0 = time.perf_counter()
                r_ora = s_ora.run_stage(tasks, f, write_back=merge)
                row["oracle_wall_s"] = time.perf_counter() - t0
                if r_dev.report.phase_signature() != \
                        r_ora.report.phase_signature():
                    raise AssertionError(f"{tag}: phase_signature differs "
                                         "from the numpy session's")
                if not np.array_equal(r_dev.exec_site, r_ora.exec_site):
                    raise AssertionError(f"{tag}: exec_site differs")
                chk_store.write_rows(np.arange(K), old)
                chk.run_stage(tasks, f, write_back=merge)
                row["max_value_err"], row["max_value_err_share"] = \
                    _check_values(tag, s_dev.store.values, chk_store.values,
                                  old, tasks,
                                  term_magnitudes(tasks, old, "muladd"),
                                  merge)
            if arm == "shrink" and k >= KILL_AT and np.isin(
                    r_dev.exec_site, SHRINK_DEAD).any():
                raise AssertionError(f"{tag}: a task executed on a dead "
                                     "machine")
            log(f"  {tag}: wall {row['wall_s']:.3f} s (backend calls "
                f"{row['numerics_s']:.3f}); snapshot ms "
                f"{[round(x, 1) for x in row['snapshot_ms']]}, recovery ms "
                f"{[round(x, 1) for x in row['recovery_ms']]}, table upload "
                f"ms {[round(x, 1) for x in row['upload_ms']]}"
                + (f"; store |Δ| {row['max_value_err']:.3g} "
                   f"({row['max_value_err_share']:.3g} of its tolerance)"
                   if s_ora is not None else ""))
        summary = {"walls_s": [r.get("wall_s") for r in st.rows[
            -ELASTIC_STAGES:]]}
        if s_ora is not None:
            got, want = s_dev.elastic.counters(), s_ora.elastic.counters()
            if got != want or not np.array_equal(s_dev.store.home,
                                                 s_ora.store.home):
                raise AssertionError(f"recovery/{arm}: counters {got} or "
                                     f"homes differ from numpy's {want}")
            summary["counters"] = got
        if arm == "restart" and (got["recoveries"] != len(RESTART_DEAD)
                                 or got["machines_alive"] != P):
            raise AssertionError(f"recovery/restart: counters {got}")
        if arm == "shrink" and (np.isin(s_dev.store.home, SHRINK_DEAD).any()
                                or got["machines_alive"] != P - 1):
            raise AssertionError("recovery/shrink: a chunk is still homed "
                                 f"on a dead machine, or counters {got}")
        out[arm] = summary
        log(f"  recovery/{arm}: counters {summary.get('counters')}")
    return out


def elastic_stealing(device, st, K, stages, init) -> dict:
    """(b) Phase-3 work stealing (`stealing=True`) against the same stage
    without it: stage (a) under TD-Orch and push, and stages (b), (c) under
    TD-Orch (their K1 and K3). Each stage from the same values, held to a
    numpy session under the same spec as in phase 8 (bills, refcounts,
    exec sites, values)."""
    from repro_torch.core import Orchestrator

    by_name = {s[0]: s for s in stages}
    out = {}
    for eng, name, steal in (("tdorch", "a", False), ("tdorch", "a", True),
                             ("push", "a", False), ("push", "a", True),
                             ("tdorch", "b", True), ("tdorch", "c", True)):
        _, desc, tasks, f, merge, _, _ = by_name[name]
        spec = {"stealing": True} if steal else None
        tag = f"steal/{eng}/{name}" + ("" if steal else "_off")
        st.expected[tag] = ENGINE_EXPECTED[eng][name]
        s_dev = Orchestrator(_fresh_store(K, init), engine=eng,
                             backend=_torch_backend(device), elasticity=spec)
        s_ora = Orchestrator(_fresh_store(K, init), engine=eng,
                             backend="numpy", elasticity=spec)
        kind = "fused" if tasks.max_arity > 1 else "muladd"
        mags = term_magnitudes(tasks, init, kind)
        r_dev = st.run(tag, lambda: s_dev.run_stage(tasks, f,
                                                    write_back=merge),
                       desc=desc, tasks=tasks.n)
        row = st.rows[-1]
        if s_dev.backend._host_lambdas:
            raise AssertionError(f"{tag}: a lambda fell back to the host "
                                 "path")
        t0 = time.perf_counter()
        r_ora = s_ora.run_stage(tasks, f, write_back=merge)
        row["oracle_wall_s"] = time.perf_counter() - t0
        _same_bill(tag, r_dev, r_ora)
        val_err, share = _check_values(tag, s_dev.store.values,
                                       s_ora.store.values, init, tasks, mags,
                                       merge)
        counts = np.bincount(r_dev.exec_site, minlength=P)
        stolen = int(s_dev.report.stolen_out.sum())
        if steal and s_dev.elastic.counters()["stolen_tasks"] != stolen:
            raise AssertionError(f"{tag}: stolen_tasks differs from the "
                                 "report's per-machine steals")
        row.update(max_tasks=int(counts.max()), mean_tasks=counts.mean(),
                   stolen_tasks=stolen,
                   steal_words=float(s_dev.report.steal_words),
                   max_value_err=val_err)
        out[tag] = {k: row[k] for k in ("wall_s", "max_tasks", "mean_tasks",
                                        "stolen_tasks", "steal_words")}
        log(f"  {tag}: wall {row['wall_s']:.3f} s (oracle "
            f"{row['oracle_wall_s']:.3f}); tasks a machine max "
            f"{row['max_tasks']} / mean {row['mean_tasks']:.1f}; stolen "
            f"{stolen}, steal words {row['steal_words']:.0f}; bills, exec "
            f"sites equal, store |Δ| {val_err:.3g} ({share:.3g} of its "
            "tolerance)")
    return out


def _mig_store(K, vals):
    """bench_elastic.py's placement over a table of K rows: hashed homes
    over MIG_P machines, then each hot set re-homed as there."""
    s = _fresh_store(K, vals, MIG_P)
    for m in range(MIG_P):
        s.rehome(np.arange(m * MIG_HOT, (m + 1) * MIG_HOT), m)
        s.rehome(np.arange(MIG_ERA_B + m * MIG_HOT,
                           MIG_ERA_B + (m + 1) * MIG_HOT), m % 2)
    return s


def _mig_stage(rng, era_base, n_m):
    """bench_elastic.py's `_stage`: per machine, Zipf reads over its hot
    set at `era_base` plus uniform background over the era-A region."""
    from repro_torch.core import TaskBatch

    nh = int(MIG_HOT_FRAC * n_m)
    keys, origin = [], []
    for m in range(MIG_P):
        base = era_base + m * MIG_HOT
        hot = base + (rng.zipf(MIG_ALPHA, size=nh) - 1) % MIG_HOT
        bg = rng.integers(0, MIG_ERA_B, size=n_m - nh)
        keys.append(np.concatenate([hot, bg]))
        origin.append(np.full(n_m, m, dtype=np.int64))
    keys = np.concatenate(keys)
    return TaskBatch(contexts=np.zeros((keys.size, 1)), read_keys=keys,
                     write_keys=np.full(keys.size, -1, dtype=np.int64),
                     origin=np.concatenate(origin))


def _mig_read(contexts, values):
    return {"result": values[:, :1]}


def elastic_migration(device, st, K, n_m=MIG_TPM, eras=MIG_ERAS,
                      window=MIG_WINDOW) -> dict:
    """(c) bench_elastic.py's three arms (engine "push") over a table of K
    rows, on the card and on numpy: bills, exec sites, results and the
    `moves` log equal every stage; then the benchmark's gate on the card's
    bills over the last `window` stages. `MigrationPlanner.observe` (the
    (K, MIG_P) float64 histogram's np.add.at) and `maybe_migrate` are
    timed on the shifted arm."""
    from repro_torch.core import Orchestrator

    vals = np.random.default_rng(MIG_SEED + 1).standard_normal(
        (K, VALUE_WIDTH))
    arms = {"stationary/mig_on": (False, True), "shift/mig_on": (True, True),
            "shift/mig_off": (True, False)}
    wpt, ratio, out = {}, {}, {}
    for name, (shift, migrate) in arms.items():
        rng = np.random.default_rng(MIG_SEED)
        rng.standard_normal((2 * MIG_ERA_B, 4))  # the bench's store draw
        spec = {"migration": MIGRATION} if migrate else None
        s_dev = Orchestrator(_mig_store(K, vals), engine="push",
                             backend=_torch_backend(device), elasticity=spec)
        s_ora = Orchestrator(_mig_store(K, vals), engine="push",
                             backend="numpy", elasticity=spec)
        clock = _elastic_clock(s_dev)
        host = {"observe_ms": [], "maybe_migrate_ms": []}
        if migrate:
            planner = s_dev.elastic.planner
            for meth in ("observe", "maybe_migrate"):
                inner = getattr(planner, meth)

                def timed(*a, _inner=inner, _key=f"{meth}_ms", **k):
                    t0 = time.perf_counter()
                    res = _inner(*a, **k)
                    host[_key].append((time.perf_counter() - t0) * 1e3)
                    return res

                setattr(planner, meth, timed)
        plan = [0] * eras[0] + ([MIG_ERA_B] if shift else [0]) * eras[1]
        walls = []
        for i, era in enumerate(plan):
            if i == len(plan) - window:
                w0 = float(s_dev.report.sent.sum())
                work0 = s_dev.report.per_machine()["work"].copy()
            tasks = _mig_stage(rng, era, n_m)
            tag = f"migration/{name}/{i}"
            st.expected[tag] = _launch()
            r_dev = st.run(tag, lambda: s_dev.run_stage(
                tasks, _mig_read, return_results=True))
            walls.append(st.rows.pop()["wall_s"])
            r_ora = s_ora.run_stage(tasks, _mig_read, return_results=True)
            _same_bill(tag, r_dev, r_ora)
            _results_close(tag, r_dev.results, r_ora.results)
        if migrate and s_dev.elastic.planner.moves != \
                s_ora.elastic.planner.moves:
            raise AssertionError(f"migration/{name}: moves differ from the "
                                 "numpy session's")
        if not np.array_equal(s_dev.store.home, s_ora.store.home):
            raise AssertionError(f"migration/{name}: homes differ")
        dwork = s_dev.report.per_machine()["work"] - work0
        wpt[name] = (float(s_dev.report.sent.sum()) - w0) / (window * n_m
                                                             * MIG_P)
        ratio[name] = float(dwork.max() / max(dwork.mean(), 1e-12))
        row = dict(stage=f"migration/{name}", launches=_launch(),
                   wall_s=sum(walls), stage_walls_s=walls,
                   words_per_task=wpt[name], work_ratio=ratio[name],
                   migration_words=float(s_dev.report.migration_words),
                   migrations=(s_dev.elastic.counters()["migrations"]
                               if migrate else 0),
                   upload_ms=clock["upload_ms"], **host)
        st.rows.append(row)
        out[name] = row
        log(f"  migration/{name}: {len(plan)} stages of {n_m * MIG_P} tasks "
            f"in {sum(walls):.3f} s; window words/task {wpt[name]:.4f}, "
            f"work ratio {ratio[name]:.4f}, {row['migrations']} chunks "
            f"moved ({row['migration_words']:.0f} words); table uploads "
            f"{len(clock['upload_ms'])} "
            f"({sum(clock['upload_ms']):.1f} ms)"
            + (f"; observe {np.mean(host['observe_ms']):.3f} ms mean / "
               f"{max(host['observe_ms']):.3f} max, maybe_migrate "
               f"{np.mean(host['maybe_migrate_ms']):.3f} ms mean"
               if migrate else "") + "; bills, results, moves equal numpy's")
    gaps = {"words_gap": abs(wpt["shift/mig_on"] / wpt["stationary/mig_on"]
                             - 1.0),
            "work_gap": abs(ratio["shift/mig_on"] / ratio["stationary/mig_on"]
                            - 1.0),
            "off_words": wpt["shift/mig_off"] / wpt["stationary/mig_on"],
            "off_work": ratio["shift/mig_off"] / ratio["stationary/mig_on"]}
    log(f"  bench_elastic gate: with migration words gap "
        f"{gaps['words_gap']:.4f}, work gap {gaps['work_gap']:.4f} (at most "
        f"{MIG_GATE}); without, words {gaps['off_words']:.3f}x, work "
        f"{gaps['off_work']:.3f}x (above {1 + MIG_GATE})")
    if not (gaps["words_gap"] <= MIG_GATE and gaps["work_gap"] <= MIG_GATE
            and gaps["off_words"] > 1 + MIG_GATE
            and gaps["off_work"] > 1 + MIG_GATE):
        raise AssertionError(f"bench_elastic gate failed: {gaps}")
    out["gate"] = gaps
    return out


def elastic_chain(device, st, K, init, n_chain) -> dict:
    """(d) A machine killed mid-plan: `run_chain` (n_chain chains of
    CHAIN_HOPS hops, one plan under the torch plan scope) uninterrupted and
    with `recovery={"injector": CHAIN_KILL}` on the card, and the killed
    one on numpy: fetched values and the table equal the uninterrupted
    chain's exactly (the write merge has no order-dependent sums), each
    hop's bill equals it without the elastic phases and the numpy chain's
    with them."""
    from repro_torch.core import ELASTIC_PHASES
    from repro_torch.core.cost import assert_cost_parity
    from repro_torch.kvstore.ycsb import zipf_keys_stationary

    rng = np.random.default_rng(SERVE_SEED + 4)
    perm = rng.permutation(K)
    keys = zipf_keys_stationary(n_chain * CHAIN_HOPS, K, SERVE_GAMMA, rng,
                                perm).reshape(n_chain, CHAIN_HOPS)
    operand = rng.random((n_chain, 2))
    spec = {"recovery": {"injector": CHAIN_KILL}}
    be = _card_backend(device)
    t_plain, t_kill, t_ora = (_kv_table(device, K, init) for _ in range(3))
    for tag in ("chain/plain", "chain/kill"):
        st.expected[tag] = _launch(segment_combine=CHAIN_HOPS)
    c_plain = st.run("chain/plain", lambda: t_plain.run_chain(
        keys, operand, backend=be), tasks=n_chain)
    c_kill = st.run("chain/kill", lambda: t_kill.run_chain(
        keys, operand, backend=be, elasticity=spec), tasks=n_chain)
    c_ora = t_ora.run_chain(keys, operand, backend="numpy", elasticity=spec)
    if (c_kill.hops != c_plain.hops
            or not np.array_equal(c_kill.keys, c_plain.keys)
            or not np.array_equal(c_kill.values, c_plain.values,
                                  equal_nan=True)
            or not np.array_equal(t_kill.values, t_plain.values)):
        raise AssertionError("chain/kill: values or the table differ from "
                             "the uninterrupted chain's")
    for j, (a, b, c) in enumerate(zip(c_plain.reports, c_kill.reports,
                                      c_ora.reports)):
        assert_cost_parity(a, b, ignore=ELASTIC_PHASES)
        if b.phase_signature() != c.phase_signature():
            raise AssertionError(f"chain/kill hop {j}: phase_signature "
                                 "differs from the numpy chain's")
    sess = t_kill.session(backend=be, elasticity=spec)
    counters = sess.elastic.counters()
    want = t_ora.session(backend="numpy", elasticity=spec).elastic.counters()
    if counters != want or counters["recoveries"] != 1:
        raise AssertionError(f"chain/kill: counters {counters}, numpy's "
                             f"{want}")
    _no_host_route("chain/kill", t_kill)
    walls = [r["wall_s"] for r in st.rows[-2:]]
    log(f"  chain: {n_chain} chains of {c_kill.hops} hops, machine "
        f"{CHAIN_KILL} killed: wall {walls[1]:.3f} s against "
        f"{walls[0]:.3f} uninterrupted; fetched values and the table "
        f"bit-identical, hop bills equal; counters {counters}")
    return {"walls_s": walls, "counters": counters}


def elastic_serve(device, st, K, init, n_stream, n_stream_mget) -> dict:
    """(e) A sync-mode `table.serve(elasticity=ELASTIC_SERVE)` over phase
    10's stream at max_batch 256: every future resolves, launches by batch
    kind, results and the table within the numpy replay's gate (elasticity
    moves no value), and the report's "elastic" block equal to the shared
    manager's `counters()`."""
    stream = serve_stream(K, n_stream, n_stream_mget, SERVE_SEED + 2)
    table = _kv_table(device, K, init)
    fe = table.serve(backend=_card_backend(device), mode="sync",
                     elasticity=ELASTIC_SERVE, config={
                         "max_batch": STREAM_BATCHES[0], "min_window": 1.0,
                         "max_window": 1.0, "max_queue": 1 << 16})
    ran = _record_batches(fe)
    tag = "serve/elastic"
    before = _launch_counts()
    t0 = time.perf_counter()
    kv, mg = _drive(fe, stream)
    fe.flush()
    fe.drain()
    wall = time.perf_counter() - t0
    launches = _launch_counts(before)
    rep = fe.report()
    fe.close()
    _check_futures(tag, kv, mg, fe)
    batches = _batches_as_requests(ran, kv, mg)
    kinds = [_batch_kind(t, i, stream) for t, i in batches]
    _note_launches(st, tag, launches, kinds)
    manager = fe.sessions[0].elastic
    if manager is None or any(s.elastic is not manager
                              for s in fe.sessions):
        raise AssertionError(f"{tag}: the buffer sessions do not share one "
                             "elasticity manager")
    if rep.get("elastic") != manager.counters():
        raise AssertionError(f"{tag}: the report's elastic block "
                             f"{rep.get('elastic')} is not the manager's "
                             f"{manager.counters()}")
    worst = _replay_numpy(tag, _kv_table(device, K, init), table, batches,
                          stream, kv, mg)
    _no_host_route(tag, table)
    row = dict(stage=tag, wall_s=wall, launches=launches,
               requests=len(kv) + len(mg), batches=len(batches),
               requests_per_s=(len(kv) + len(mg)) / wall,
               elastic=rep["elastic"], replay_share_of_gate=worst)
    st.rows.append(row)
    log(f"  {tag}: {row['requests']} requests in {len(batches)} batches, "
        f"wall {wall:.3f} s = {row['requests_per_s']:.0f} requests/s; "
        f"elastic block {rep['elastic']} equal to counters(); the numpy "
        f"replay within {worst:.3g} of its gate")
    return row


def elastic_path(device: str, K: int, stages, init, *,
                 n_chain: int = CHAIN_N, n_stream: int = STREAM_N,
                 n_stream_mget: int = STREAM_MGETS, mig_tpm: int = MIG_TPM,
                 mig_eras=MIG_ERAS, mig_window: int = MIG_WINDOW):
    """Phase 11: (a) recovery, (b) work stealing, (c) migration, (d) a
    mid-plan kill and (e) the serve tier's counters, on the main path's
    table (`K`, `stages` and `init` from phase 3; the KV and serve parts
    on phase 10's). Durable snapshots go to a temporary directory removed
    at the end. Returns (rows, summary, expected launches by stage); the
    keyword sizes cut it down for a rehearsal on the CPU."""
    import shutil
    import tempfile

    st = _Stages(device, {})
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_elastic_"))
    try:
        summary = {"recovery": elastic_recovery(device, st, K, stages[0],
                                                init, tmp)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summary["stealing"] = elastic_stealing(device, st, K, stages, init)
    summary["migration"] = elastic_migration(device, st, K, mig_tpm,
                                             mig_eras, mig_window)
    kv_init = np.random.default_rng(SERVE_SEED).random((K, SERVE_WIDTH))
    summary["chain"] = elastic_chain(device, st, K, kv_init, n_chain)
    summary["serve"] = elastic_serve(device, st, K, kv_init, n_stream,
                                     n_stream_mget)
    return st.rows, summary, st.expected


# ---------------------------------------------------------------------------
# phase 12: multi-device execution — the stacked mesh on one card
# ---------------------------------------------------------------------------
CHAOS_STAGES = 6
CHAOS_SPEC = {"recovery": {"injector": {4: [3]}},
              "migration": {"refresh": 3, "min_count": 4.0}}
CHAOS_ZIPF = 1.4  # tests/test_elastic.py's skewed stream
MOE_EP = 8
MOE_T = 8_192  # tokens over the mesh (1,024 a shard)
MOE_HOT = 4
MOE_TIGHT = 1.25  # the dispatch's default capacity factor
EMBED_SHARDS = 8
GROUP_P = 4
GROUP_TPM = 50_000  # 200,000 tasks over 4 ranks
GROUP_TIMEOUT_S = 300
YCSB_P, YCSB_TPM, YCSB_KEYS, YCSB_STAGES, YCSB_SEED = 8, 2_000, 16_000, 8, 17
YCSB_GAMMAS = (1.2, 2.0)
YCSB_REPLICATION = {"num_hot": 64, "refresh": 2, "decay": 0.5,
                    "min_count": 8.0}
YCSB_GATE = 1.5  # bench_spmd.py's: charged work_ratio at Zipf 1.2, rep on
MESH_REL = 2e-4  # TestChaosSharded's float32 gate: rtol 2e-4, atol 1e-5
MESH_ABS = 1e-5

# launches a stage of the sharded path: K1 once for the mesh's Phase 1 (one
# launch over all shards) besides the host cost model's calls, K2 twice for
# a stage that writes (the local and the owner-side combine); the fused-able
# stage (c) runs its padded form on the mesh, as the JAX package's sharded
# program does, so no K3. The cost model's K1 calls are phase 3's (the same
# engine code decides them); where a stream's are not known ahead (b, e, f),
# `_sharded_launches` reads them off the backend after the stage.
SPMD_STAGE = {t: _launch(histogram=e["histogram"] + 1, segment_combine=2)
              for t, e in EXPECTED_LAUNCHES.items()}
# (c): the histogram once a dispatch, K4 twice a grouped SwiGLU (push-pull
# with hot experts runs two: the pulled and the pushed); (d) one histogram
MOE_LAUNCHES = {"moe_reference": _launch(moe_gemm=2),
                "moe_push_pull/cffree": _launch(histogram=1, moe_gemm=4),
                f"moe_push_pull/cf{MOE_TIGHT}": _launch(histogram=1,
                                                        moe_gemm=4),
                "moe_direct_push/cffree": _launch(histogram=1, moe_gemm=2),
                f"moe_direct_push/cf{MOE_TIGHT}": _launch(histogram=1,
                                                          moe_gemm=2),
                "moe_direct_pull/cffree": _launch(histogram=1, moe_gemm=2)}
SPMD_EXPECTED = {
    **SPMD_STAGE,
    **{f"{t}/torch": EXPECTED_LAUNCHES[t] for t in SPMD_STAGE},
    **MOE_LAUNCHES,
    "embed_mesh": _launch(histogram=1),
}


def _cost_model_k1(be) -> None:
    """Count on `be.cost_model_k1` the histogram launches its host cost
    model's Phase-1 calls (`key_counts`) make."""
    from repro_torch import kernels

    be.cost_model_k1 = 0
    inner = be.key_counts

    def counted(*a, **k):
        before = kernels.launches()["histogram"]
        out = inner(*a, **k)
        be.cost_model_k1 += kernels.launches()["histogram"] - before
        return out

    be.key_counts = counted


def _sharded_launches(be, writes: bool, shards: bool = True):
    """The expected launches of the stage about to run on `be` (wrapped by
    `_cost_model_k1`), known once it has run: the cost model's K1 calls
    plus, on a mesh (`shards`), its one K1 and, for a stage that writes,
    two K2 (one on a single device)."""
    before = be.cost_model_k1
    return lambda: _launch(
        histogram=int(shards) + be.cost_model_k1 - before,
        segment_combine=(1 + int(shards)) * int(writes))


def recount_stats(tasks, exec_site, store, replicas, combine: bool) -> dict:
    """`ShardStageStats` counted in numpy from the placement alone: the
    exec sites, the store's layout and the fully replicated chunks."""
    P_ = store.P
    site = np.asarray(exec_site, dtype=np.int64)
    owner = store.shard_layout().owner

    def count(x):
        return np.bincount(x, minlength=P_).astype(np.int64)

    if tasks.max_arity > 1:
        p_site, p_key = site[tasks.pair_task], tasks.read_indices
    else:
        has = tasks.read_keys >= 0
        p_site, p_key = site[has], tasks.read_keys[has]
    full = np.zeros(store.num_keys, dtype=bool)
    if replicas is not None and replicas.hot_ids.size:
        full[np.asarray(replicas.hot_ids)[replicas.holders.all(axis=1)]] = True
    rep = full[p_key]
    wk = tasks.write_keys
    w = wk >= 0
    out = dict(tasks=count(site), pairs=count(p_site),
               fetch_sent=count(p_site[~rep]),
               fetch_recv=count(owner[p_key[~rep]]),
               replica_local=count(p_site[rep]), writers=count(site[w]),
               combine_sent=np.zeros(P_, np.int64),
               combine_recv=np.zeros(P_, np.int64),
               owned_demand=count(owner[p_key]))
    if combine:
        pairs = np.unique(site[w] * store.num_keys + wk[w])
        out["combine_sent"] = count(pairs // store.num_keys)
        out["combine_recv"] = count(owner[pairs % store.num_keys])
    return out


def _check_stats(name, stats, want: dict) -> None:
    for field, arr in want.items():
        if not np.array_equal(getattr(stats, field), arr):
            raise AssertionError(f"{name}: measured {field} "
                                 f"{getattr(stats, field)}, recount {arr}")


def charged_work_ratio(report) -> float:
    """max/mean of a stage's charged Phase-3 work (tasks at their exec
    sites, one unit each)."""
    ph = next(p for p in report.phases if p.name == "phase3_execute")
    return float(ph.compute.max() / max(ph.compute.mean(), 1e-12))


def _check_ratio(name, stats, report) -> tuple:
    measured, charged = stats.work_ratio(), charged_work_ratio(report)
    if abs(measured - charged) > 1e-12 * charged:
        raise AssertionError(f"{name}: measured work_ratio {measured} != "
                             f"charged {charged}")
    return measured, charged


def _peak_reset(device) -> None:
    import torch

    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()


def _peak(device) -> int:
    import torch

    return torch.cuda.max_memory_allocated() if device == "cuda" else 0


def spmd_main_path(device, st, K, stages, init) -> list:
    """(a) Phase 3's four stages, not cut, through `backend="torch_spmd"`
    (the stacked mesh: 16 shards on the card) against the numpy oracle,
    with the same stage's wall under `backend="torch"` beside it."""
    from repro_torch.core import (DataStore, Orchestrator, TorchBackend,
                                  TorchSpmdBackend)

    sx_be, tx_be = TorchSpmdBackend(device=device), TorchBackend(
        device=device)
    _timed_backend(sx_be)
    _timed_backend(tx_be)
    st_sx, st_tx, st_ora = (DataStore.create(K, P, value_width=VALUE_WIDTH)
                            for _ in range(3))
    rows = []
    for name, desc, tasks, f, merge, rep, n_stages in stages:
        if name in ("a", "d"):  # (a) again, from the same starting values
            st_sx.write_rows(np.arange(K), init)
            st_tx.write_rows(np.arange(K), init)
        s_sx = Orchestrator(st_sx, backend=sx_be, replication=rep)
        s_tx = Orchestrator(st_tx, backend=tx_be, replication=rep)
        s_ora = Orchestrator(st_ora, backend="numpy", replication=rep)
        kind = "fused" if tasks.max_arity > 1 else "muladd"
        for k in range(n_stages):
            tag = f"{name}{k}" if n_stages > 1 else name
            st_ora.write_rows(np.arange(K), st_sx.values)
            old = st_ora.values.copy()
            mags = term_magnitudes(tasks, old, kind)
            sx_be.numerics_s = tx_be.numerics_s = 0.0
            a2a = sx_be.a2a_bytes
            _peak_reset(device)
            r_sx = st.run(tag, lambda: s_sx.run_stage(
                tasks, f, write_back=merge, return_results=True),
                desc=desc, tasks=tasks.n, pairs=tasks.nnz)
            row = st.rows[-1]
            peak = _peak(device)
            if sx_be._host_lambdas:
                raise AssertionError(f"sharded {tag}: a lambda fell back to "
                                     "the host path")
            r_tx = st.run(f"{tag}/torch", lambda: s_tx.run_stage(
                tasks, f, write_back=merge, return_results=True))
            r_ora = s_ora.run_stage(tasks, f, write_back=merge,
                                    return_results=True)
            _same_bill(f"sharded {tag}", r_sx, r_ora)
            _same_bill(f"sharded {tag} (torch)", r_tx, r_ora)
            res_err = _sum_bound_ok(
                np.asarray(r_sx.results, dtype=np.float64),
                np.asarray(r_ora.results, dtype=np.float64), mags,
                rel_want=1e-5, name=f"sharded {tag} results")
            val_err, val_share = _check_values(
                f"sharded {tag}", st_sx.values, st_ora.values, old, tasks,
                mags, merge)
            stats = sx_be.stage_stats[-1]
            _check_stats(f"sharded {tag}", stats, recount_stats(
                tasks, r_sx.exec_site, st_sx, s_sx.replicas,
                combine=bool((tasks.write_keys >= 0).any())))
            measured, charged = _check_ratio(f"sharded {tag}", stats,
                                             r_sx.report)
            wall, numerics = row["wall_s"], sx_be.numerics_s
            row.update(numerics_s=numerics, host_s=wall - numerics,
                       host_share=(wall - numerics) / wall,
                       peak_device_bytes=peak,
                       a2a_bytes=sx_be.a2a_bytes - a2a,
                       torch_wall_s=st.rows[-1]["wall_s"],
                       torch_numerics_s=tx_be.numerics_s,
                       max_result_err=res_err, max_value_err=val_err,
                       max_value_err_share_of_tolerance=val_share,
                       work_ratio=measured, charged_work_ratio=charged,
                       stats={k_: v.tolist() for k_, v in
                              stats._asdict().items()})
            rows.append(row)
            log(f"  (a) stage {tag} ({desc}): wall {wall:.4f} s (host "
                f"{wall - numerics:.4f} s, share {row['host_share']:.3f}), "
                f"backend='torch' {row['torch_wall_s']:.4f} s; peak "
                f"{peak / 1e9:.3f} GB; all-to-all send buffers "
                f"{row['a2a_bytes'] / 1e9:.3f} GB; max |Δ| results "
                f"{res_err:.3g}, store {val_err:.3g} ({val_share:.3g} of the "
                f"gate); work_ratio {measured:.6f} = charged; stats = "
                "recount; launches "
                f"{ {k_: v for k_, v in row['launches'].items() if v} }")
    return rows


def _chaos_batches(K: int, tpm: int) -> list:
    from repro_torch.core import TaskBatch

    n = P * tpm
    out = []
    for i in range(CHAOS_STAGES):
        r = np.random.default_rng(SEED + 300 + i)
        keys = (r.zipf(CHAOS_ZIPF, size=n) % K).astype(np.int64)
        out.append(TaskBatch(contexts=r.standard_normal((n, 2)),
                             read_keys=keys, write_keys=keys.copy(),
                             origin=r.integers(0, P, size=n)))
    return out


def spmd_chaos(device, st, K, init, tpm) -> dict:
    """(b) `tests/test_elastic.py`'s TestChaosSharded at (a)'s size: a
    skewed stream (Zipf 1.4 over 800,000 keys, 800,000 tasks a stage),
    machine 3 killed at stage 4, migration on; `"torch_spmd"` and
    `"torch"` each against numpy under the same spec. The write merge
    (ties to the lowest task row) keeps float32 and float64 within the
    test's gate over six stages; an add at this skew compounds hundreds of
    thousands of float32 terms a key a stage."""
    from repro_torch.core import (DataStore, Orchestrator, TorchBackend,
                                  TorchSpmdBackend, assert_session_parity)

    sx_be, tx_be = TorchSpmdBackend(device=device), TorchBackend(
        device=device)
    _cost_model_k1(sx_be)
    _cost_model_k1(tx_be)
    stores = [DataStore.create(K, P, value_width=VALUE_WIDTH)
              for _ in range(3)]
    for s in stores:
        s.write_rows(np.arange(K), init)
    sessions = [Orchestrator(s, backend=be, elasticity=CHAOS_SPEC)
                for s, be in zip(stores, (sx_be, tx_be, "numpy"))]
    walls, worst = {"torch_spmd": [], "torch": []}, 0.0
    for i, tasks in enumerate(_chaos_batches(K, tpm)):
        st.expected[f"chaos{i}"] = _sharded_launches(sx_be, writes=True)
        r = st.run(f"chaos{i}", lambda: sessions[0].run_stage(
            tasks, muladd, write_back="write"), tasks=tasks.n)
        walls["torch_spmd"].append(st.rows[-1]["wall_s"])
        st.expected[f"chaos{i}/torch"] = _sharded_launches(
            tx_be, writes=True, shards=False)
        st.run(f"chaos{i}/torch", lambda: sessions[1].run_stage(
            tasks, muladd, write_back="write"))
        walls["torch"].append(st.rows[-1]["wall_s"])
        sessions[2].run_stage(tasks, muladd, write_back="write")
        for got in stores[:2]:
            err = np.abs(got.values - stores[2].values)
            allowed = MESH_REL * np.abs(stores[2].values) + MESH_ABS
            if not (err <= allowed).all():
                raise AssertionError(f"chaos stage {i}: values beyond rtol "
                                     f"{MESH_REL} / atol {MESH_ABS}")
            worst = max(worst, float((err / allowed).max()))
        _check_stats(f"chaos stage {i}", sx_be.stage_stats[-1],
                     recount_stats(tasks, r.exec_site, stores[0],
                                   sessions[0].replicas, combine=True))
    for s in sessions[:2]:
        assert_session_parity(sessions[2].report, s.report)
    rec = [s.elastic.counters()["recoveries"] for s in sessions]
    if rec != [1, 1, 1]:
        raise AssertionError(f"chaos: recoveries {rec}, expected one each")
    out = dict(walls_s=walls, worst_share_of_gate=worst, recoveries=1,
               migrations=sessions[0].elastic.counters().get("migrations"))
    log(f"  (b) chaos: {CHAOS_STAGES} stages of {P * tpm} tasks, walls "
        f"{[round(w, 4) for w in walls['torch_spmd']]} s (backend='torch' "
        f"{[round(w, 4) for w in walls['torch']]}); session parity with "
        f"numpy (elastic phases included) on both, 1 recovery, "
        f"{out['migrations']} migrations; values at most {worst:.3g} of the "
        "gate")
    return out


def _moe_capacity_free(ti: np.ndarray, S: int) -> float:
    """A capacity factor with which no shard drops an assignment: the
    largest (shard, owner) bucket of the direct push."""
    e_local = GRANITE["E"] // MOE_EP
    owner = ti.reshape(S, -1) // e_local
    need = max(int(np.bincount(o, minlength=MOE_EP).max()) for o in owner)
    per_shard = ti.size / S / MOE_EP
    return (need + 0.5) / per_shard


def spmd_moe(device, st, ps: dict, tokens: int = MOE_T) -> dict:
    """(c) `moe_push_pull`, `moe_direct_push` and `moe_direct_pull` at
    granite-moe-3b-a800m's widths (phase 4's layer: 40 experts, top-8, d
    1536, expert width 512) over an 8-shard stacked mesh: 8,192 tokens of
    Zipf-1.2 routing, against `moe_reference`; with a capacity that drops
    nothing (every engine must equal the reference) and at the default
    1.25 (drops logged)."""
    import torch

    from repro_torch.core import spmd
    from repro_torch.core.shardexec import StackedMesh

    dev = torch.device(device)
    router = ps["router"]
    x, ti, g = router.zipf_routing(tokens, alpha=PS_ALPHA, seed=PS_SEED + 40,
                                   rank_perm=ps["perm"])
    w_in, w_out = (torch.from_numpy(np.ascontiguousarray(w, dtype=np.float32))
                   .to(dev) for w in router.layer_weights(0))
    E, k, d = GRANITE["E"], GRANITE["k"], x.shape[1]
    S, e_loc, T = MOE_EP, GRANITE["E"] // MOE_EP, tokens // MOE_EP
    xt = torch.from_numpy(x.astype(np.float32)).to(dev)
    tit = torch.from_numpy(ti).to(dev)
    gt = torch.from_numpy(g.astype(np.float32)).to(dev)
    want = st.run("moe_reference", lambda: spmd.moe_reference(
        xt, tit, gt, w_in, w_out))
    ref_wall = st.rows[-1]["wall_s"]
    mesh = StackedMesh(S, dev)
    args = (xt.view(S, T, d), tit.view(S, T, k), gt.view(S, T, k),
            w_in.view((S, e_loc) + w_in.shape[1:]),
            w_out.view((S, e_loc) + w_out.shape[1:]))
    free = _moe_capacity_free(ti, S)
    out = {"capacity_free": free}
    for name, hot in (("moe_push_pull", MOE_HOT), ("moe_direct_push", 0),
                      ("moe_direct_pull", 0)):
        for cf in ((free, MOE_TIGHT) if name != "moe_direct_pull"
                   else (free,)):
            cfg = spmd.MoEDispatchConfig(num_experts=E, top_k=k,
                                         capacity_factor=cf, num_hot=hot,
                                         mesh=mesh)
            tag = f"{name}/cf{'free' if cf == free else cf}"
            _peak_reset(device)
            y, aux = st.run(tag, lambda: getattr(spmd, name)(*args, cfg))
            y = y.reshape(tokens, d)
            dropped = int(aux.dropped_assignments[0])
            row = dict(wall_s=st.rows[-1]["wall_s"], dropped=dropped,
                       peak_device_bytes=_peak(device))
            if not torch.isfinite(y).all():
                raise AssertionError(f"{tag}: non-finite output")
            counts = aux.expert_counts[0].cpu().numpy()
            if not np.array_equal(counts, np.bincount(ti.ravel(),
                                                      minlength=E)):
                raise AssertionError(f"{tag}: expert counts differ")
            if cf == free:
                if dropped:
                    raise AssertionError(f"{tag}: {dropped} dropped")
                row["max_abs_err"] = _check_close(
                    tag, y.double().cpu().numpy(),
                    want.double().cpu().numpy())
            out[tag] = row
            log(f"  (c) {tag}: wall {row['wall_s']:.4f} s, dropped "
                f"{dropped} of {ti.size}, peak "
                f"{row['peak_device_bytes'] / 1e9:.3f} GB"
                + (f", max |Δ| {row['max_abs_err']:.3g} against "
                   "moe_reference" if "max_abs_err" in row else ""))
    out["reference_wall_s"] = ref_wall
    return out


def spmd_embed(device, st, ps: dict) -> dict:
    """(d) `embed_skew_aware` on an 8-shard stacked mesh over phase 4's
    49,155 x 1536 table: phase 4's 8,192 Zipf-1.2 ids split over the
    shards, a cache of the 768 hottest rows. Embeddings exact, the cache's
    counts the global histogram, each shard's hit rate its own."""
    import torch

    from repro_torch.core.embedding import EmbedCache, embed_skew_aware
    from repro_torch.core.shardexec import StackedMesh

    dev = torch.device(device)
    table = np.asarray(ps["store"].table, dtype=np.float32)
    V = table.shape[0]
    ids = np.asarray(ps["skew_ids"], dtype=np.int64)
    freq = np.bincount(ids, minlength=V)
    hot = np.argsort(-freq, kind="stable")[:EMBED_HOT["num_hot"]]
    lookup = np.full(V, -1, dtype=np.int32)
    lookup[hot] = np.arange(hot.size, dtype=np.int32)
    tt = torch.from_numpy(table).to(dev)
    cache = EmbedCache(
        hot_ids=torch.from_numpy(hot.astype(np.int32)).to(dev),
        hot_rows=tt[torch.from_numpy(hot).to(dev)],
        lookup=torch.from_numpy(lookup).to(dev),
        counts=torch.zeros(V, dtype=torch.int32, device=dev))
    mesh = StackedMesh(EMBED_SHARDS, dev)
    q = torch.from_numpy(ids.reshape(EMBED_SHARDS, -1).astype(np.int32)) \
        .to(dev)
    out, cache2, hit = st.run("embed_mesh", lambda: embed_skew_aware(
        tt, q, cache, mesh))
    want_hit = (lookup[ids.reshape(EMBED_SHARDS, -1)] >= 0).mean(1)
    if not (torch.equal(out.reshape(-1, table.shape[1]).cpu(),
                        torch.from_numpy(table[ids]))
            and np.array_equal(cache2.counts.cpu().numpy(), freq)
            and np.allclose(hit.cpu().numpy(), want_hit, rtol=1e-6)):
        raise AssertionError("embed_skew_aware on the mesh differs from its "
                             "reference")
    row = dict(wall_s=st.rows[-1]["wall_s"],
               hit_rates=hit.cpu().numpy().tolist())
    log(f"  (d) embed_skew_aware, {EMBED_SHARDS} shards: wall "
        f"{row['wall_s']:.4f} s, hit rates "
        f"{[round(h, 4) for h in row['hit_rates']]}; exact")
    return row


def _group_stage(tpm: int):
    """Stage (a)'s traffic at GROUP_P machines: Zipf-2.0 reads and
    read-modify-write adds, `tpm` tasks a machine, as many keys as tasks."""
    from repro_torch.core import TaskBatch
    from repro_torch.kvstore.ycsb import zipf_keys_stationary as zipf

    rng = np.random.default_rng(SEED + 500)
    n = GROUP_P * tpm
    K = n
    tasks = TaskBatch(contexts=rng.standard_normal((n, 2)),
                      read_keys=zipf(n, K, 2.0, rng, rng.permutation(K)),
                      origin=TaskBatch.even_origins(n, GROUP_P))
    init = rng.standard_normal((K, VALUE_WIDTH))
    return K, tasks, init


def _group_rank(rank: int, world: int, port: int, out: str, tpm: int,
                device: str) -> None:
    """One machine of the group mesh: a gloo rank on the shared card."""
    import datetime

    import torch
    import torch.distributed as dist

    from repro_torch import kernels
    from repro_torch.core import DataStore, Orchestrator, TorchSpmdBackend

    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=120))
    try:
        K, tasks, init = _group_stage(tpm)
        store = DataStore.create(K, GROUP_P, value_width=VALUE_WIDTH)
        store.write_rows(np.arange(K), init)
        be = TorchSpmdBackend(device=device)
        sess = Orchestrator(store, backend=be)
        kernels.reset_launches()
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sess.run_stage(tasks, muladd, write_back="add",
                             return_results=True)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if rank == 0:
            st = be.stage_stats[-1]
            np.savez(out, values=store.values,
                     results=np.asarray(res.results),
                     stats=np.stack([np.asarray(v) for v in st]))
            Path(out + ".json").write_text(json.dumps(dict(
                wall_s=wall, launches=kernels.launches(),
                kind=be.mesh(GROUP_P).kind, a2a_bytes=be.a2a_bytes)))
    finally:
        dist.destroy_process_group()


def spmd_group(device, st, tpm: int = GROUP_TPM) -> dict:
    """(e) The group mesh: GROUP_P gloo ranks (one process a machine)
    sharing the card, on stage (a)'s traffic at P=4; its stats must equal
    the stacked mesh's on the same batch, both within phase 3's gate of the
    numpy oracle. The ranks are joined with a deadline and killed past
    it."""
    import shutil
    import socket
    import tempfile

    import torch.multiprocessing as mp

    from repro_torch.core import DataStore, Orchestrator, TorchSpmdBackend

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_group_"))
    try:
        out = str(tmp / "rank0.npz")
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        t0 = time.perf_counter()
        ctx = mp.start_processes(_group_rank, args=(GROUP_P, port, out, tpm,
                                                    device),
                                 nprocs=GROUP_P, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + GROUP_TIMEOUT_S
        while not ctx.join(timeout=5):
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                raise AssertionError("the group mesh's ranks passed their "
                                     f"{GROUP_TIMEOUT_S} s deadline")
        spawn_wall = time.perf_counter() - t0
        got = np.load(out)
        info = json.loads(Path(out + ".json").read_text())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    K, tasks, init = _group_stage(tpm)
    be = TorchSpmdBackend(device=device)
    _cost_model_k1(be)
    stores = [DataStore.create(K, GROUP_P, value_width=VALUE_WIDTH)
              for _ in range(2)]
    for s in stores:
        s.write_rows(np.arange(K), init)
    st.expected["group/stacked"] = _sharded_launches(be, writes=True)
    st.run("group/stacked", lambda: Orchestrator(
        stores[0], backend=be).run_stage(tasks, muladd, write_back="add",
                                         return_results=True))
    Orchestrator(stores[1], backend="numpy").run_stage(
        tasks, muladd, write_back="add")
    stacked = np.stack([np.asarray(v) for v in be.stage_stats[-1]])
    if info["kind"] != "group" or not np.array_equal(got["stats"], stacked):
        raise AssertionError(f"group mesh stats {got['stats'].tolist()} != "
                             f"stacked {stacked.tolist()}")
    ran = info["launches"]
    if device == "cuda" and (ran["histogram"] < 1
                             or ran["segment_combine"] != 2):
        raise AssertionError(f"group mesh rank 0 launched {ran}: the "
                             "sharded stage's K1 and two K2 expected")
    mags = term_magnitudes(tasks, init, "muladd")
    errs = [_check_values(f"group/{tag}", vals, stores[1].values, init,
                          tasks, mags, "add")
            for tag, vals in (("ranks", got["values"]),
                              ("stacked", stores[0].values))]
    row = dict(spawn_wall_s=spawn_wall, rank0_stage_wall_s=info["wall_s"],
               stacked_wall_s=st.rows[-1]["wall_s"],
               rank0_launches=info["launches"],
               rank0_a2a_bytes=info["a2a_bytes"],
               value_err_share=[e[1] for e in errs])
    log(f"  (e) group mesh, {GROUP_P} gloo ranks on one card, "
        f"{tasks.n} tasks: rank 0's stage {info['wall_s']:.4f} s (spawn and "
        f"all {spawn_wall:.2f} s), the stacked mesh {row['stacked_wall_s']:.4f}"
        f" s; stats equal; values {row['value_err_share']} of the gate "
        "(gloo's collectives on the card's tensors); rank 0's launches "
        f"{ {k_: v for k_, v in info['launches'].items() if v} }")
    return row


def _ycsb_muladd(contexts, in_vals):
    return {"update": in_vals * contexts[:, 1:2] + contexts[:, 2:3],
            "result": in_vals}


def spmd_ycsb(device, st) -> list:
    """(f) `benchmarks/bench_spmd.py`'s YCSB-C cells at their own settings
    (P=8, Zipf 1.2 and 2.0, replication on and off, 2,000 tasks a machine,
    16,000 keys, 8 stages) on the stacked mesh: charged and measured
    work_ratio, and bench_spmd's gate (charged <= 1.5 at Zipf 1.2 with
    replication on)."""
    from repro_torch.core import (DataStore, Orchestrator, TaskBatch,
                                  TorchSpmdBackend)
    from repro_torch.kvstore import make_ycsb_stream

    be = TorchSpmdBackend(device=device)
    _cost_model_k1(be)
    rows = []
    for gamma in YCSB_GAMMAS:
        for rep_on in (False, True):
            tag = f"ycsb/zipf{gamma}/rep{'on' if rep_on else 'off'}"
            store = DataStore.create(YCSB_KEYS, YCSB_P, value_width=8,
                                     chunk_words=8)
            sess = Orchestrator(store, engine="tdorch", backend=be,
                                replication=(YCSB_REPLICATION if rep_on
                                             else None))
            origin = TaskBatch.even_origins(YCSB_TPM * YCSB_P, YCSB_P)
            be.reset_stats()
            t0 = time.perf_counter()
            for i, (keys, is_read, operand) in enumerate(make_ycsb_stream(
                    "C", YCSB_TPM, YCSB_P, YCSB_KEYS, gamma=gamma,
                    seed=YCSB_SEED, stages=YCSB_STAGES)):
                ctx = np.concatenate(
                    [is_read[:, None].astype(np.float64), operand], axis=1)
                tasks = TaskBatch(contexts=ctx, read_keys=keys,
                                  write_keys=np.where(is_read, np.int64(-1),
                                                      keys),
                                  origin=origin)
                st.expected[f"{tag}/{i}"] = _sharded_launches(
                    be, writes=bool((tasks.write_keys >= 0).any()))
                r = st.run(f"{tag}/{i}", lambda: sess.run_stage(
                    tasks, _ycsb_muladd, write_back="write"))
                _check_stats(f"{tag} stage {i}", be.stage_stats[-1],
                             recount_stats(tasks, r.exec_site, store,
                                           sess.replicas,
                                           combine=bool((tasks.write_keys
                                                         >= 0).any())))
                _check_ratio(f"{tag} stage {i}", be.stage_stats[-1], r.report)
            wall = time.perf_counter() - t0
            pm = sess.report.per_machine()
            measured = sum(s_.tasks for s_ in be.stage_stats)
            m_ratio = float(measured.max() / max(measured.mean(), 1e-12))
            rows.append(dict(cell=tag, work_ratio=pm["work_ratio"],
                             measured_work_ratio=m_ratio,
                             h_ratio=pm["h_ratio"], wall_s=wall))
            log(f"  (f) {tag}: charged work_ratio {pm['work_ratio']:.4f}, "
                f"measured {m_ratio:.4f}, h_ratio {pm['h_ratio']:.4f}, "
                f"{YCSB_STAGES} stages in {wall:.3f} s")
            if gamma == 1.2 and rep_on and pm["work_ratio"] > YCSB_GATE:
                raise AssertionError(f"{tag}: work_ratio {pm['work_ratio']} "
                                     f"> {YCSB_GATE} (bench_spmd's gate)")
    return rows


def spmd_path(device: str, K: int, stages, init, ps: dict, *,
              tpm: int = TASKS_PER_MACHINE, group_tpm: int = GROUP_TPM,
              moe_tokens: int = MOE_T):
    """Phase 12: (a) phase 3's stages, (b) the chaos scenario, (c) the MoE
    dispatch, (d) `embed_skew_aware`, (e) the group mesh and (f)
    bench_spmd's cells, each on a mesh of one shard a machine. Returns
    (rows, summary, expected launches by stage); the keyword sizes cut it
    down for a rehearsal on the CPU."""
    st = _Stages(device, dict(SPMD_EXPECTED))
    summary = {"stages": spmd_main_path(device, st, K, stages, init),
               "chaos": spmd_chaos(device, st, K, init, tpm),
               "moe": spmd_moe(device, st, ps, moe_tokens),
               "embed": spmd_embed(device, st, ps),
               "group": spmd_group(device, st, group_tpm),
               "ycsb": spmd_ycsb(device, st)}
    return st.rows, summary, st.expected


# ---------------------------------------------------------------------------
# phase 13: the language-model serving path
# ---------------------------------------------------------------------------
# Four configs of the repo at full width and depth, in bf16 with random
# weights from a seeded generator, served through `repro_torch.launch.serve.
# generate`: zamba2-1.2b (38 Mamba2 layers through B7 at prefill, one shared
# attention block applied 7 times through B5 / B6), tinyllama-1.1b (22 GQA
# layers through B5 / B6), granite-moe-3b-a800m (32 GQA layers through B5 /
# B6, each with a TD-Orch MoE layer: B1 for Phase 1, four bf16 B4 calls for
# the hot and cold SwiGLUs, at prefill and at every step) and xlstm-350m
# (three units of seven mLSTM layers and one sLSTM layer, in torch ops: no
# port kernel).
LM_ARCHS = ("zamba2-1.2b", "tinyllama-1.1b", "granite-moe-3b-a800m",
            "xlstm-350m")
LM_BATCH = 8
LM_PROMPT = 4096
LM_GEN = 64
LM_SEED = 41
# check 2 decodes the last LM_CHECK_STEPS positions of its prompt
# teacher-forced after a prefill of the rest (3,968 = 31 chunks), at
# generate's prompt, or at LM_CHECK_PROMPT's for a pattern whose prefills
# are long: xlstm's sLSTM loop (host-bound: 5.2 s a 4,096-token prefill)
# would take most of its check's time in the 7 prefills
LM_CHECK_STEPS = 128
LM_CHECK_PROMPT = {"xlstm": 1024}
# checks 2 and 3 (kernel calls against their plain versions, cache
# consistency and its faults) run on a model of the config at this depth,
# with its own random weights from LM_SEED, where the pattern has an
# entry: the run clock pays for B7's backward and phase 14's zamba2 part
# with them. Every layer kind and kernel shape of the full model is still
# there; at full depth granite's 32 layers (224 ms a decode step at batch
# 8) took ~92 s of the phase in check 2's three 128-step runs, zamba2's
# 38 ~30 s; at 16 and 19 layers 48.2 and 20.7 s, tinyllama's 22 16.8 s
# (a fast host). On a host 1.4x slower the whole run read 1,111 s with
# granite at 16 and xlstm at 24 (68.8 and 37.6 s of check 2), so granite
# runs them at 8 layers and xlstm at two units of its three.
LM_CHECK_LAYERS = {"moe": 8, "zamba2": 19, "dense": 11, "xlstm": 16}
LM_TIMED_STEPS = 32  # decode steps timed one by one (the median is kept)
LM_BUSY_STEPS = 4  # decode steps under torch.profiler
# Check 2's gate, as a share of max|logits|, set before the first chip run:
# the logits are bf16 products (one rounding: 2^-8 of |logit|), and every
# layer rounds its output to bf16 in both paths, at values whose float32
# sums differ in order (a 4,096-row GEMM against an 8-row one, B5 against
# B6, the chunked scan against the recurrence). On the CPU, with the plain
# versions, bf16 models of 12 layers at width 512 (zamba2's and
# tinyllama's patterns, 256-token prefill + 128 decode steps) landed at
# 0.0105 and 0.0108 of max|logits| (`Model` in bf16, this check's
# arithmetic); depth 22-45 adds √(45/12) ≈ 1.9x as independent roundings
# would, so about 0.02. The gate is 0.05 (six bf16 ulps of the largest
# logit). The logits alone cannot see a cache fault: random weights spread
# attention over thousands of keys, so one key misplaced or one rotation
# off moves them by about as much as the bf16 roundings do, and a lost SSM
# state has decayed within the 128 steps. So check 2 also holds the caches
# to the same gate: the split prefill's against `forward`'s states on its
# tokens (a state not stored), and the k/v after the steps against the
# long prefill's (a slot or a rotation wrong). Each fault of `lm_faults` is
# planted and must miss.
LM_CONSISTENCY = 0.05
# The MoE and xLSTM patterns' gate, set from CPU runs of this check's
# arithmetic (`Model` in bf16, plain versions, 256-token prefill + 128
# teacher-forced steps, batch 2) before they first ran on a card. granite's
# pattern at width 512 (40 experts of 256, top 8), 12 and 24 layers:
# decode k/v 0.0670 and 0.0654 of max|·|, logits 0.0085 / 0.0168: a
# top-8 choice at a near-tie flips between the 256-row prefill and the
# 2-row step (177 of 24,576 and 546 of 49,152 decode assignments), and one
# flip moves that token's MoE output by its gate's share (~0.1), so the
# k/v of the next layer for that token by a share of order 0.05. xlstm's
# pattern at width 512, 24 layers (three units of 7 + 1): decode states
# (C, n rescaled to the reference's stabilizer m; conv tail; sLSTM c, n,
# h) 0.0945, logits 0.0336: the recurrent states carry every bf16 rounding
# of the inputs of 128 steps. Both above 0.05; the planted faults read
# 0.61-7.4 there (granite slot 1.35; xlstm state 0.83, conv 7.39, carry
# 0.61). The gate for these two patterns is 0.25: 2.6x the largest clean
# reading, 2.4x under the weakest fault. The other patterns keep 0.05.
LM_CONSISTENCY_BY_PATTERN = {"moe": 0.25, "xlstm": 0.25}
# check 3: full width at n_layers=2 in float32 on the card against float64
# on the CPU (plain versions), every logit and cache tensor within
# LM_F32_REL·max|ref|. On the CPU the float32 model lands within 8e-6 of
# max|ref| (k caches: float32 rotary angles at positions up to 264), so
# 1e-4 holds the card's float32 paths (full-float32 GEMMs, 3xTF32 B4, B5
# and B7, SIMT float32 B6) with a margin of 12x. xlstm's two layers are one
# unit (slstm_every 2).
LM_F32 = dict(n_layers=2, batch=2, prompt=256, steps=8)
LM_F32_REL = 1e-4
# check 4: the final state of `mamba_ssd` at zamba2's prefill shape
LM_STATE = dict(kernel="mamba_scan", B=LM_BATCH, S=LM_PROMPT, nh=64, hd=64,
                ds=64, chunk=128)
# the model path's kernel entry points, hooked where the path calls them:
# entry -> (module, attribute, kernel family). The model stack calls B5-B7
# through the `repro_torch.kernels` module; B4 and B1 are imported by name
# into `core.spmd` and `core.torchexec`, so they are swapped there.
_LM_ENTRIES = {
    "attention": ("repro_torch.kernels", "attention", "flash_attention"),
    "decode_attention": ("repro_torch.kernels", "decode_attention",
                         "flash_decode"),
    "mamba_ssd": ("repro_torch.kernels", "mamba_ssd", "mamba_scan"),
    "grouped_gemm": ("repro_torch.core.spmd", "grouped_gemm", "moe_gemm"),
    "count_ids": ("repro_torch.core.torchexec", "count_ids", "histogram"),
}


def lm_faults(cfg) -> tuple:
    """The planted faults of check 2 that a pattern's caches have: "slot"
    (k/v written one slot early), "rope" (decode rotated one position too
    far), "state" (the middle Mamba layer's prefill SSM state, or the
    middle mLSTM layer's prefill C, zeroed), "conv" (the mLSTM conv tail
    left where the prefill put it), "carry" (every sLSTM step fed a zero
    hidden state)."""
    if cfg.pattern == "xlstm":
        return ("state", "conv", "carry")
    return ("slot", "state", "rope") if cfg.pattern == "zamba2" else (
        "slot", "rope")


def lm_gate(cfg) -> float:
    return LM_CONSISTENCY_BY_PATTERN.get(cfg.pattern, LM_CONSISTENCY)


def lm_launches(cfg, prefills: int = 1, steps: int = 0) -> dict:
    """Launches of `prefills` prefills and `steps` decode steps of a model:
    one attention kernel a layer (zamba2: a shared-block application) at
    prefill, one decode kernel a layer a step, one scan a Mamba layer at
    prefill; for a MoE layer one histogram and four grouped GEMMs (the hot
    and the cold SwiGLU) at prefill and at every step; none for xlstm. The
    bf16 kernels in bf16, the float32 ones in float32. The Mamba decode
    step and the xLSTM cells are plain torch."""
    dt = cfg.compute_dtype
    n_attn = {"zamba2": -(-cfg.n_layers // cfg.shared_attn_every),
              "xlstm": 0}.get(cfg.pattern, cfg.n_layers)
    kw = {launched_kernel("flash_attention", dt): prefills * n_attn,
          launched_kernel("flash_decode", dt): steps * n_attn}
    if cfg.pattern == "zamba2":
        kw["mamba_scan"] = prefills * cfg.n_layers
    if cfg.pattern == "moe":
        calls = (prefills + steps) * cfg.n_layers
        kw["histogram"] = calls
        kw[launched_kernel("moe_gemm", dt)] = 4 * calls
    return _launch(**kw)


class _KernelHook:
    """Route the model path's kernel entry points (`_LM_ENTRIES`) through
    `wrap(entry, fn)` inside a `with` block; the wrapped calls still launch
    and count."""

    def __init__(self, wrap):
        self.wrap = wrap

    def __enter__(self):
        import importlib

        self.saved = []
        for name, (mod, attr, _) in _LM_ENTRIES.items():
            m = importlib.import_module(mod)
            fn = getattr(m, attr)
            self.saved.append((m, attr, fn))
            setattr(m, attr, self.wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for m, attr, fn in self.saved:
            setattr(m, attr, fn)
        return False


class _RouteLog:
    """Record every MoE layer's expert choices (top_i, on the device) while
    the `with` block runs: `repro_torch.models.moe._route` wrapped."""

    def __enter__(self):
        from repro_torch.models import moe

        self.calls, self.fn = [], moe._route

        def route(*a, **kw):
            out = self.fn(*a, **kw)
            self.calls.append(out[0])
            return out
        moe._route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe._route = self.fn
        return False


class _PatchBlocks:
    """Swap functions of `repro_torch.models.blocks` (the xLSTM decode
    cells) inside a `with` block: plants check 2's "conv" and "carry"
    faults."""

    def __init__(self, fault):
        self.fault = fault

    def __enter__(self):
        import torch

        from repro_torch.models import blocks

        self.saved = (blocks.mlstm_decode, blocks.slstm_decode)
        plain_m, plain_s = self.saved
        if self.fault == "conv":
            def frozen(params, cfg, x, state, tail):
                out, state, _ = plain_m(params, cfg, x, state, tail)
                return out, state, tail
            blocks.mlstm_decode = frozen
        elif self.fault == "carry":
            def forgetful(params, cfg, x, st):
                return plain_s(params, cfg, x,
                               st._replace(h=torch.zeros_like(st.h)))
            blocks.slstm_decode = forgetful
        return self

    def __exit__(self, *exc):
        from repro_torch.models import blocks

        blocks.mlstm_decode, blocks.slstm_decode = self.saved
        return False


def _event_times(store: dict):
    """A hook that brackets each kernel call with CUDA events into
    store[entry] (device time between them: the call's kernels, and any
    wait for the host's launch)."""
    import torch

    def wrap(name, fn):
        def call(*a, **kw):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **kw)
            e.record()
            store.setdefault(name, []).append((s, e))
            return out
        return call
    return wrap


def _slot_fault(name, fn):
    """A hook that plants the "slot" fault: before each decode call, the
    k/v just written at slot length-1 move to slot length-2 and the new
    slot is left zero, as if the cache were written one slot early."""
    def call(*a, **kw):
        if name == "decode_attention":
            n = kw["length"]
            for c in a[1:3]:
                c[:, n - 2] = c[:, n - 1]
                c[:, n - 1] = 0
        return fn(*a, **kw)
    return call


def _ssd_check(inputs, chunk: int, y, h, name: str) -> tuple:
    """A scan's output y and final state h against the plain version on
    the same inputs (float64 for float32 inputs, float32 for bf16, plus the
    output's bf16 rounding), within phase 5's SSD gate: (SSD_REL +
    8·u32·max|l|)·Σ|terms| + 1e-6, Σ|terms| the plain version on |x|,
    |B|, |C|."""
    import torch

    from repro_torch.kernels.mamba_scan.ref import ssd_scan_ref

    x, dt, A, Bc, Cc = inputs
    up = (lambda t: t.double()) if x.dtype == torch.float32 else \
        (lambda t: t.float())
    c = min(chunk, x.shape[1])
    max_l = float((dt.double() * A.double()).reshape(
        x.shape[0], -1, c, x.shape[2]).cumsum(2).abs().max().item())
    rel = SSD_REL + 8 * U32 * max_l
    want_y, want_h = ssd_scan_ref(up(x), dt, A, up(Bc), up(Cc), chunk=chunk,
                                  return_state=True)
    mag_y, mag_h = ssd_scan_ref(up(x.abs()), dt, A, up(Bc.abs()),
                                up(Cc.abs()), chunk=chunk, return_state=True)
    bf16 = BF16_ROUND if x.dtype == torch.bfloat16 else 0.0
    out = []
    for got, want, mag, what in ((y, want_y, mag_y, "y"),
                                 (h, want_h, mag_h, "final state")):
        allowed = rel * mag.double() + 1e-6 + bf16 * want.double().abs()
        out.append(_within(got, want, allowed, f"{name}: {what}"))
        del allowed
    del want_y, want_h, mag_y, mag_h
    torch.cuda.empty_cache()
    return tuple(out)


def _histogram_check(a, kw, out, name: str) -> tuple:
    """A histogram call against the plain version on the same ids: exact."""
    import torch

    from repro_torch.kernels.histogram.ref import histogram_ref

    want = histogram_ref(a[0], a[1], kw.get("weights"))
    if not torch.equal(out, want):
        raise AssertionError(f"{name}: differs from the plain version "
                             f"({int((out != want).sum())} bins)")
    return 0.0, 0.0


def _value_checks(rows: list):
    """A hook that holds every kernel call against its plain version on the
    same inputs, at phase 5's gates (attention and decode through
    `check_against_plain`; the scan's y and final state through
    `_ssd_check`), the grouped GEMM at `gemm_check`'s and the histogram
    exactly. On a miss of attention, decode or the scan it calls the
    kernel and the plain version again on the same inputs and says which
    one moved (as phase 5 does, for the open fault C2), then raises."""
    import torch

    counts = {}

    def wrap(name, fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            i = counts[name] = counts.get(name, 0) + 1
            tag = f"{name} call {i}"
            dtype = "bfloat16" if a[0].dtype == torch.bfloat16 else "float32"
            row = dict(call=tag, entry=name,
                       shape=[tuple(t.shape) for t in a
                              if isinstance(t, torch.Tensor)],
                       length=kw.get("length"), dtype=str(a[0].dtype))
            with torch.no_grad():  # a training step's forward too
                if name == "grouped_gemm":
                    e, share = gemm_check(*a, out, tag)
                elif name == "count_ids":
                    e, share = _histogram_check(a, kw, out, tag)
                else:
                    e, share = _checked_call(name, fn, a, kw, out, dtype,
                                             tag)
            rows.append(dict(row, max_abs_err=e, share_of_tolerance=share))
            return out
        return call
    return wrap


def _checked_call(name, fn, a, kw, out, dtype, tag) -> tuple:
    """`_value_checks` for attention, decode and the scan."""
    import torch

    if name == "mamba_ssd":
        st = dict(kernel="mamba_scan", chunk=kw["chunk"])
        inputs = a
    elif name == "attention":
        st = dict(kernel="flash_attention", causal=kw.get("causal", True))
        inputs = a
    else:
        st = dict(kernel="flash_decode")
        inputs = (*a, kw["length"])
    try:
        if name == "mamba_ssd":
            (e, share), (e_h, share_h) = _ssd_check(
                inputs, kw["chunk"], out[0], out[1], tag)
            return max(e, e_h), max(share, share_h)
        return check_against_plain(st, inputs, out, dtype, tag)
    except AssertionError as exc:
        again = fn(*a, **kw)
        up = (lambda t: t.double()) if dtype == "float32" else \
            (lambda t: t.float())
        plain = [_plain_call(st, inputs, up) for _ in range(2)]
        first = out[0] if name == "mamba_ssd" else out
        again = again[0] if name == "mamba_ssd" else again
        plain = [p[0] if isinstance(p, tuple) else p for p in plain]
        raise AssertionError(
            f"{exc}; a second kernel call is "
            f"{'' if torch.equal(again, first) else 'not '}"
            "identical to the first, two plain calls are "
            f"{'' if torch.equal(*plain) else 'not '}identical"
        ) from exc


def _lm_step_bytes(model, batch: int, length: int, routed=None) -> int:
    """Bytes a decode step must move at a cache of `length` positions: the
    weights once (of an untied embedding only the batch's rows; of a MoE
    layer's experts only those the step routed to, `routed` giving their
    count a layer), the valid k/v of every attention layer read, the SSM,
    LSTM and conv states read and written, the float32 logits written."""
    cfg = model.cfg
    e = model.embed.element_size()
    w = sum(p.numel() * p.element_size() for p in model.parameters())
    if not cfg.tie_embeddings:
        w -= model.embed.numel() * e - batch * cfg.d_model * e
    if cfg.pattern == "moe":
        m = cfg.moe
        per_expert = 3 * cfg.d_model * m.d_ff_expert * e
        w -= cfg.n_layers * m.padded * per_expert
        w += sum(routed) * per_expert
    n_attn = {"zamba2": model.n_apps, "xlstm": 0}.get(cfg.pattern,
                                                       cfg.n_layers)
    kv = n_attn * 2 * batch * length * cfg.n_kv_heads * cfg.head_dim * e
    states = 0
    if cfg.pattern == "zamba2":
        s = cfg.ssm
        d_in = s.expand * cfg.d_model
        states = cfg.n_layers * batch * 2 * (
            (d_in // s.head_dim) * s.head_dim * s.d_state * 4
            + (s.d_conv - 1) * (d_in + 2 * s.d_state) * e)
    if cfg.pattern == "xlstm":
        from repro_torch.models.xlstm import CONV_K, mlstm_dims

        d_up, nh, hd = mlstm_dims(cfg)
        n_m = model.units * (cfg.xlstm.slstm_every - 1)
        states = 2 * batch * (
            n_m * (nh * (hd * hd + hd + 1) * 4 + (CONV_K - 1) * d_up * e)
            + model.units * 4 * cfg.d_model * 4)
    return w + kv + states + batch * cfg.vocab_size * 4


def _cache_leaves(c) -> list:
    """(name, stacked tensor) of a model's caches."""
    if isinstance(c, dict) and "mlstm" in c:
        (ms, tail), sl = c["mlstm"], c["slstm"]
        return [("mlstm.C", ms.C), ("mlstm.n", ms.n), ("mlstm.m", ms.m),
                ("mlstm.conv", tail), ("slstm.c", sl.c), ("slstm.n", sl.n),
                ("slstm.m", sl.m), ("slstm.h", sl.h)]
    if isinstance(c, dict):
        return [("mamba.conv", c["mamba"].conv),
                ("mamba.ssm", c["mamba"].ssm), ("attn.k", c["attn"][0]),
                ("attn.v", c["attn"][1])]
    return [("attn.k", c[0]), ("attn.v", c[1])]


def _decode_pairs(got, want) -> list:
    """Check 2's decode readings, (got, reference) pairs: the k/v caches;
    for xlstm the recurrent states, the mLSTM's C and n and the sLSTM's c
    and n put on the reference's stabilizer (m is the log of their scale:
    the same state under another m reads the same), the conv tails, the
    sLSTM's h."""
    import torch

    if not (isinstance(got, dict) and "mlstm" in got):
        return [(g, w) for (n, g), (_, w) in zip(_cache_leaves(got),
                                                 _cache_leaves(want))
                if n.endswith((".k", ".v"))]
    (ms, tail), (rs, rtail) = got["mlstm"], want["mlstm"]
    sl, rl = got["slstm"], want["slstm"]
    a, b = torch.exp(ms.m - rs.m), torch.exp(sl.m - rl.m)
    return [(ms.C * a[..., None, None], rs.C), (ms.n * a[..., None], rs.n),
            (tail, rtail), (sl.c * b, rl.c), (sl.n * b, rl.n),
            (sl.h, rl.h)]


def _kv_prefix(name: str, t, n: int):
    """A cache tensor, its k/v buffers cut to their first n positions."""
    return t[:, :, :n] if name.endswith((".k", ".v")) else t


def _share(got, want) -> float:
    """max|got - want| as a share of max|want|."""
    want = want.float()
    return float(((got.float() - want).abs().max()
                  / want.abs().max()).item())


def _flips(routes, ref, batch: int) -> tuple:
    """(assignments of the decode steps' routes not in the reference
    prefill's choices for the same token and layer, all the steps'
    assignments). `routes`: every MoE layer's top_i of every step, in call
    order (layer by layer, step by step); `ref`: each layer's top_i of the
    long prefill at the decoded positions, (batch, steps, k)."""
    import torch

    L, flips, total = len(ref), 0, 0
    for i, got in enumerate(routes):
        want = ref[i % L][:, i // L]  # (batch, k)
        hit = (got[:, :, None] == want[:, None, :]).any(-1)
        flips += int((~hit).sum())
        total += got.numel()
    return flips, total


def lm_consistency(model, prompts, refs, fault=None) -> dict:
    """Check 2's readings, each a share of its reference's max|·|: the
    caches of a prefill of all but the last LM_CHECK_STEPS tokens of
    `prompts` (into buffers LM_GEN longer than `prompts`) against
    `forward`'s states on those tokens ("prefill_caches"; every tensor),
    then the rest of `prompts` decoded teacher-forced: the last step's
    logits against a prefill of all of `prompts`' last logits ("logits"),
    and the decode caches after the steps (`_decode_pairs`) against that
    prefill's ("decode_caches"). `refs` = (forward's states on the split
    prefill's tokens, the whole prefill's logits, its caches, its MoE
    layers' routes at the decoded positions). `fault` plants one of
    `lm_faults`. For a MoE model the clean run also counts the decode
    steps' expert choices that differ from the prefill's ("flips",
    "assignments")."""
    import contextlib

    import torch

    from repro_torch.models import Model

    split_states, want_logits, want_caches, ref_routes = refs
    P = prompts.shape[1]
    split = P - LM_CHECK_STEPS
    _, caches = model.prefill(tokens=prompts[:, :split], max_len=P + LM_GEN)
    if fault == "state":  # the middle Mamba / mLSTM layer's state lost
        if model.cfg.pattern == "zamba2":
            caches["mamba"].ssm[model.cfg.n_layers // 2].zero_()
        else:
            caches["mlstm"][0].C[model.units // 2].zero_()
    out = {"prefill_caches": max(
        _share(_kv_prefix(n, got, split), want)
        for (n, got), (_, want) in zip(_cache_leaves(caches),
                                       _cache_leaves(split_states)))}
    if fault == "rope":
        model._default_positions = (
            lambda b, s, offset=0:
            Model._default_positions(model, b, s, offset + 1))
    hook = (_KernelHook(_slot_fault) if fault == "slot"
            else _PatchBlocks(fault) if fault in ("conv", "carry")
            else contextlib.nullcontext())
    try:
        with hook, _RouteLog() as routes:
            for i in range(split, P):
                step, caches = model.decode_step(
                    caches, tokens=prompts[:, i:i + 1], cache_pos=i)
    finally:
        model.__dict__.pop("_default_positions", None)
    if not bool(torch.isfinite(step).all()):
        raise AssertionError(f"{model.cfg.name}: non-finite decode logits")
    out["logits"] = _share(step, want_logits)
    out["decode_caches"] = max(_share(g, w) for g, w in
                               _decode_pairs(caches, want_caches))
    if ref_routes and fault is None:
        flips, total = _flips(routes.calls, ref_routes, prompts.shape[0])
        return out, dict(flips=flips, assignments=total)
    return out, None


def lm_serve(dev, cfg) -> dict:
    """One config through the serving path, batch LM_BATCH. (1) `generate`
    of LM_GEN tokens greedily after an LM_PROMPT-token prefill — the main
    path: its launches must be `lm_launches(cfg, 1, LM_GEN)` exactly. Then:
    prefill ms, decode ms a step (median of LM_TIMED_STEPS), each kernel's
    ms inside a prefill and a step (CUDA events), the idle share of
    LM_BUSY_STEPS steps (torch.profiler), the step's byte bound (a MoE
    layer's experts: those that step routed to). (2) `generate` again with
    every kernel call held against its plain version (its prefill and all
    its decode steps, at the main path's shapes). (3) Cache consistency
    (`lm_consistency`) within `lm_gate(cfg)`; then each of `lm_faults(cfg)`,
    planted, must miss that gate. Checks 2 and 3 run at LM_CHECK_LAYERS'
    depth where the pattern has an entry."""
    import dataclasses

    import torch

    from repro_torch import kernels
    from repro_torch.launch.serve import generate
    from repro_torch.models import Model

    batch, prompt, gen = LM_BATCH, LM_PROMPT, LM_GEN
    model = Model(cfg, device=dev, seed=LM_SEED)
    g = torch.Generator(device=dev).manual_seed(LM_SEED + 1)
    prompts = torch.randint(0, cfg.vocab_size, (batch, prompt), generator=g,
                            device=dev, dtype=torch.int32)
    row = dict(arch=cfg.name, batch=batch, prompt=prompt, gen=gen,
               params=model.param_count(), dtype=cfg.compute_dtype)

    # (1) the main path, counted
    part_s, t_part = {}, time.perf_counter()
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    seqs = generate(model, prompts, gen)
    torch.cuda.synchronize(dev)
    row["generate_s"] = time.perf_counter() - t0
    ran = kernels.launches()
    want = lm_launches(cfg, 1, gen)
    row["launches"] = {k: v for k, v in ran.items() if v}
    if ran != want:
        raise AssertionError(f"{cfg.name}: generate launched {ran}, "
                             f"expected {want}")
    if seqs.shape != (batch, prompt + gen) or not torch.equal(
            seqs[:, :prompt], prompts) or int(seqs.min()) < 0 or \
            int(seqs.max()) >= cfg.vocab_size:
        raise AssertionError(f"{cfg.name}: malformed generation "
                             f"{tuple(seqs.shape)}")
    row["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    row["tokens_per_s"] = batch * gen / row["generate_s"]

    # timings on the card's clock: a prefill, then decode steps one by one
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    logits, caches = model.prefill(tokens=prompts, max_len=prompt + gen)
    torch.cuda.synchronize(dev)
    row["prefill_ms"] = (time.perf_counter() - t0) * 1e3
    if logits.shape != (batch, 1, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name}: malformed prefill logits")
    step_ms = []
    for i in range(LM_TIMED_STEPS):
        tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
        t0 = time.perf_counter()
        logits, caches = model.decode_step(caches, tokens=tok,
                                           cache_pos=prompt + i)
        torch.cuda.synchronize(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    row["decode_step_ms"] = float(np.median(step_ms))
    row["decode_step_ms_all"] = step_ms
    row["decode_tokens_per_s"] = batch / row["decode_step_ms"] * 1e3
    pos = prompt + LM_TIMED_STEPS
    pre, stp, routed = {}, {}, []
    if any(want.values()):  # xlstm launches no kernel: nothing to time
        with _KernelHook(_event_times(pre)):
            _, c2 = model.prefill(tokens=prompts, max_len=prompt + gen)
        with _KernelHook(_event_times(stp)), _RouteLog() as step_routes:
            model.decode_step(c2, tokens=seqs[:, prompt:prompt + 1],
                              cache_pos=prompt)
        torch.cuda.synchronize(dev)
        del c2
        routed = [int(t.unique().numel()) for t in step_routes.calls]
    row["kernel_ms"] = {
        f"{launched_kernel(_LM_ENTRIES[n][2], cfg.compute_dtype)} in a "
        f"{ph}": sum(s.elapsed_time(e) for s, e in v)
        for ph, times in (("prefill", pre), ("step", stp))
        for n, v in times.items()}
    row["routed_experts"] = routed

    def steps():
        nonlocal logits, caches
        for j in range(LM_BUSY_STEPS):
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            logits, caches = model.decode_step(
                caches, tokens=tok, cache_pos=pos + j)
    row["decode_busy"] = device_busy(f"{cfg.name} decode", steps)
    length = prompt + (gen + 1) // 2  # the mean cache length of a step
    row["step_bytes"] = _lm_step_bytes(model, batch, length, routed)
    row["step_bound_ms"] = row["step_bytes"] / HBM_BYTES_PER_S * 1e3
    del caches, logits

    part_s["main path and timings"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
    if cfg.pattern in LM_CHECK_LAYERS:  # checks 2 and 3 at a cut depth
        del model
        torch.cuda.empty_cache()
        model = Model(dataclasses.replace(
            cfg, n_layers=LM_CHECK_LAYERS[cfg.pattern]), device=dev,
            seed=LM_SEED)
    row["check_layers"] = model.cfg.n_layers

    # (2) the main path again, every kernel call against its plain version
    checks = []
    with _KernelHook(_value_checks(checks)):
        generate(model, prompts, gen)
    row["kernel_checks"] = checks
    part_s["kernel checks"] = time.perf_counter() - t_part
    t_part = time.perf_counter()

    # (3) cache consistency, then the planted faults
    P = LM_CHECK_PROMPT.get(cfg.pattern, prompt)
    cp, split = prompts[:, :P], P - LM_CHECK_STEPS
    _, split_states, _ = model.forward(tokens=cp[:, :split])
    with _RouteLog() as ref_routes:
        want_logits, want_caches = model.prefill(tokens=cp, max_len=P + gen)
    ref = [t.view(batch, P, -1)[:, split:].clone()
           for t in ref_routes.calls]
    refs = (split_states, want_logits, want_caches, ref)
    gate = lm_gate(cfg)
    got, flips = lm_consistency(model, cp, refs)
    row["consistency"] = dict(split=split, steps=LM_CHECK_STEPS,
                              prompt=P, gate=gate, **got)
    if flips is not None:
        row["consistency"]["routing_flips"] = flips
    if not max(got.values()) <= gate:
        raise AssertionError(
            f"{cfg.name}: a {split}-token prefill and {LM_CHECK_STEPS} "
            f"teacher-forced steps against a {P}-token prefill read {got} "
            f"of max|·| (gate {gate})")
    faults = {}
    for f in lm_faults(cfg):
        faults[f] = r = lm_consistency(model, cp, refs, f)[0]
        if not max(r.values()) > gate:
            raise AssertionError(
                f"{cfg.name}: the planted {f!r} fault reads {r} of max|·|, "
                f"inside the gate {gate}: check 2 cannot see it")
    row["faults"] = faults
    part_s["consistency and faults"] = time.perf_counter() - t_part
    row["part_s"] = part_s
    del model, refs, split_states, want_caches
    torch.cuda.empty_cache()
    return row


def lm_f32_config(arch: str, dtype: str):
    """`arch` at full width with LM_F32["n_layers"] layers in `dtype`
    (xlstm: one unit of an mLSTM and an sLSTM layer)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config(arch)
    kw = {}
    if cfg.pattern == "xlstm":
        kw["xlstm"] = dataclasses.replace(cfg.xlstm,
                                          slstm_every=LM_F32["n_layers"])
    return dataclasses.replace(cfg, n_layers=LM_F32["n_layers"],
                               param_dtype=dtype, compute_dtype=dtype, **kw)


def lm_f32_check(dev, arch: str) -> dict:
    """Check 3: `arch` at full width with LM_F32["n_layers"] layers in
    float32 on the card against the same weights in float64 on the CPU
    (the plain versions): a prefill and decode steps, every logit and
    every cache tensor within LM_F32_REL of its max|ref|. The float32
    kernels launch (3xTF32 B4, B5 and B7, SIMT B6, B1), as `lm_launches`
    counts."""
    import copy
    import dataclasses

    import torch

    from repro_torch import kernels
    from repro_torch.models import Model

    n_layers, batch, prompt, steps = (LM_F32[k] for k in (
        "n_layers", "batch", "prompt", "steps"))
    cfg = lm_f32_config(arch, "float32")
    model = Model(cfg, device=dev, seed=LM_SEED)
    ref = copy.deepcopy(model).to(device="cpu", dtype=torch.float64)
    ref.cfg = dataclasses.replace(cfg, param_dtype="float64",
                                  compute_dtype="float64")
    toks = torch.randint(0, cfg.vocab_size, (batch, prompt + steps),
                         generator=torch.Generator().manual_seed(LM_SEED),
                         dtype=torch.int32)

    def run(m, t):
        logits, caches = m.prefill(tokens=t[:, :prompt],
                                   max_len=prompt + steps)
        out = [logits]
        for i in range(steps):
            logits, caches = m.decode_step(
                caches, tokens=t[:, prompt + i:prompt + i + 1],
                cache_pos=prompt + i)
            out.append(logits)
        return torch.cat(out, dim=1), caches

    kernels.reset_launches()
    got, got_c = run(model, toks.to(dev))
    torch.cuda.synchronize(dev)
    ran = kernels.launches()
    want_launch = lm_launches(cfg, 1, steps)
    if ran != want_launch:
        raise AssertionError(f"{arch} float32: launched {ran}, expected "
                             f"{want_launch}")
    want, want_c = run(ref, toks)
    shares = {}
    for name, a, b in [("logits", got, want)] + [
            (n, a, b) for (n, a), (_, b) in zip(_cache_leaves(got_c),
                                                _cache_leaves(want_c))]:
        b = b.double()
        top = float(b.abs().max().item())
        err, share = _within(a.cpu(), b, torch.full_like(
            b, LM_F32_REL * top), f"{arch} float32 {name}")
        shares[name] = dict(max_abs_err=err, share=share, max_abs_ref=top)
    del model, ref, got_c, want_c
    torch.cuda.empty_cache()
    return dict(arch=arch, n_layers=n_layers, batch=batch, prompt=prompt,
                steps=steps, launches={k: v for k, v in ran.items() if v},
                shares=shares)


def lm_final_state(dev, st: dict = LM_STATE) -> dict:
    """Check 4: `mamba_ssd(return_state=True)` at zamba2's prefill shape in
    float32 (the model's route) against the plain version: y and the final
    state."""
    from repro_torch.kernels import mamba_ssd

    inputs = stage_inputs(st, "float32", dev, SEED + 300)
    y, h = mamba_ssd(*inputs, chunk=st["chunk"], return_state=True)
    (e_y, s_y), (e_h, s_h) = _ssd_check(inputs, st["chunk"], y, h,
                                        "final state check")
    return dict(shape=_stage_shape(st, "float32"), y_err=e_y, y_share=s_y,
                state_err=e_h, state_share=s_h)


def lm_path(dev) -> dict:
    """Phase 13: `lm_serve` on each of LM_ARCHS (full width and depth,
    bf16), check 3 on each, check 4."""
    from repro_torch.configs import get_config

    rows = []
    for a in LM_ARCHS:
        t0 = time.perf_counter()
        r = lm_serve(dev, get_config(a))
        r["wall_s"] = time.perf_counter() - t0
        rows.append(r)
        log(f"  {r['arch']} (bf16, {r['params']:,} parameters): batch "
            f"{r['batch']}, prompt {r['prompt']}, generate {r['gen']} in "
            f"{r['generate_s']:.3f} s ({r['tokens_per_s']:.1f} tokens/s); "
            f"launches {r['launches']}; prefill {r['prefill_ms']:.2f} ms, "
            f"decode step {r['decode_step_ms']:.3f} ms (median; "
            f"{r['decode_tokens_per_s']:.1f} tokens/s), byte bound "
            f"{r['step_bound_ms']:.3f} ms ({r['step_bytes'] / 1e9:.3f} GB); "
            f"peak {r['peak_bytes'] / 1e9:.3f} GB; kernels "
            f"{ {k: round(v, 4) for k, v in r['kernel_ms'].items()} } ms; "
            f"decode busy {r['decode_busy']['device_busy_s'] * 1e3:.3f} ms "
            f"of {r['decode_busy']['wall_s'] * 1e3:.3f} (idle "
            f"{r['decode_busy']['idle_share']:.4f}); {r['wall_s']:.1f} s ("
            + ", ".join(f"{k} {v:.1f}" for k, v in r["part_s"].items())
            + ")")
        if r["routed_experts"]:
            log(f"  {r['arch']}: experts routed a layer in the timed step "
                f"{min(r['routed_experts'])}-{max(r['routed_experts'])}")
        worst = {}
        for k in r["kernel_checks"]:
            n, s = k["entry"], k["share_of_tolerance"]
            worst[n] = (worst.get(n, (0, 0))[0] + 1,
                        max(worst.get(n, (0, 0))[1], s))
        lengths = [k["length"] for k in r["kernel_checks"] if k["length"]]
        log(f"  {r['arch']}: at {r['check_layers']} layers, generate's "
            "kernel calls against their plain versions (calls, worst share "
            "of the gate): "
            f"{ {n: (c, round(s, 4)) for n, (c, s) in worst.items()} }"
            + (f"; decode lengths {min(lengths)}-{max(lengths)}"
               if lengths else ""))
        c, keys = r["consistency"], ("prefill_caches", "logits",
                                     "decode_caches")
        flips = c.get("routing_flips")
        log(f"  {r['arch']}: cache consistency ({c['split']} + "
            f"{c['steps']} teacher-forced steps vs a {c['prompt']}-token "
            f"prefill), shares of max|·| (gate {c['gate']}): "
            f"{ {k: round(c[k], 6) for k in keys} }"
            + (f"; {flips['flips']} of {flips['assignments']} decode "
               "assignments routed apart from the prefill" if flips else "")
            + "; planted faults read "
            + "; ".join(f"{f} { {k: round(v[k], 6) for k in keys} }"
                        for f, v in r["faults"].items()))
    f32 = []
    for a in LM_ARCHS:
        f = lm_f32_check(dev, a)
        f32.append(f)
        log(f"  {a} float32, {f['n_layers']} layers, prompt {f['prompt']} + "
            f"{f['steps']} steps vs float64 on the CPU: launches "
            f"{f['launches']}; shares of {LM_F32_REL}·max|ref| "
            f"{ {k: round(v['share'], 4) for k, v in f['shares'].items()} }")
    state = lm_final_state(dev)
    log(f"  final state of mamba_ssd at {state['shape']}: y "
        f"{state['y_share']:.4g}, state {state['state_share']:.4g} of the "
        "SSD gate")
    return dict(serve=rows, float32=f32, final_state=state)


# ---------------------------------------------------------------------------
# phase 14: training (`repro_torch.runtime.Trainer`, `Model.loss_fn`, B5's
# backward)
# ---------------------------------------------------------------------------
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_BATCH = 4
TRAIN_SEQ = 4096
# 5 steps: with 6, a second save of the 15.4 GB checkpoint (~40 s on the
# H100's host) put the whole run at 1,087 s of its 1,200; with 5 the one
# save is at step 3, the failure's restore point
TRAIN_STEPS = 5
TRAIN_CKPT_EVERY = 3
TRAIN_FAILURE = {4: [0]}  # node 0 dies with 4 steps done: back to step 3
TRAIN_WARMUP = 2
TRAIN_SEED = 43
# random weights: the first loss within this of ln(vocab)
TRAIN_FIRST_LOSS = 1.0
# the float32 twin (two layers at full width) on the card against float64
# on the CPU (the plain versions): the loss within TRAIN_F32_LOSS of |ref|,
# every parameter's gradient within TRAIN_F32_REL of its max|ref|. Set
# before the first chip run: full-float32 GEMMs and 3xTF32 attention
# forward and backward (~2^-19 a product); on the CPU the port's float32
# gradients landed within 3e-6 of each tensor's max against the JAX
# package's (tests/test_torch_train_loss.py); 1e-4 is LM_F32_REL.
TRAIN_F32 = dict(n_layers=2, batch=1, seq=256)
TRAIN_F32_LOSS = 1e-5
TRAIN_F32_REL = 1e-4


class _KernelEvents:
    """Bracket a kernel family's launch functions (`timed`: {name in
    `module`: the kind its time is summed under}) with CUDA events inside a `with`
    block, and count its plain versions' calls (`plain`: names in
    `module`; none on the card)."""

    def __init__(self, module: str, timed: dict, plain: tuple):
        self.module, self.timed, self.plain_names = module, timed, plain

    def __enter__(self):
        import importlib

        import torch

        self.ops = importlib.import_module(self.module)
        self.saved = {n: getattr(self.ops, n)
                      for n in (*self.timed, *self.plain_names)}
        self.events = {kind: [] for kind in self.timed.values()}
        self.plain = 0

        def timed(kind, fn):
            def call(*a, **kw):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                out = fn(*a, **kw)
                e.record()
                self.events[kind].append((s, e))
                return out
            return call

        def counted(fn):
            def call(*a, **kw):
                self.plain += 1
                return fn(*a, **kw)
            return call
        for n, kind in self.timed.items():
            setattr(self.ops, n, timed(kind, self.saved[n]))
        for n in self.plain_names:
            setattr(self.ops, n, counted(self.saved[n]))
        return self

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.ops, n, fn)
        return False

    def ms(self) -> dict:
        import torch

        torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v)
                for k, v in self.events.items()}


def _AttnEvents() -> _KernelEvents:
    """Every B5 forward and backward launch (`flash_attention.ops._forward`
    / `_backward`) and its plain versions' calls."""
    return _KernelEvents("repro_torch.kernels.flash_attention.ops",
                         {"_forward": "forward", "_backward": "backward"},
                         ("attention_ref", "attention_bwd_ref"))


def _GemmEvents() -> _KernelEvents:
    """Every B4 launch (`moe_gemm.ops._launch`, the forward; `_launch_dx`
    and `_launch_dw`, the backward's two products, timed apart) and its
    plain versions' calls."""
    return _KernelEvents("repro_torch.kernels.moe_gemm.ops",
                         {"_launch": "forward", "_launch_dx": "dx",
                          "_launch_dw": "dw"},
                         ("grouped_gemm_ref", "grouped_gemm_bwd_ref"))


def _SSDEvents() -> _KernelEvents:
    """Every B7 forward and backward launch (`mamba_scan.ops._forward` /
    `_backward`) and its plain versions' calls."""
    return _KernelEvents("repro_torch.kernels.mamba_scan.ops",
                         {"_forward": "forward", "_backward": "backward"},
                         ("ssd_scan_fwd_ref", "ssd_scan_bwd_ref"))


def _train_launches(cfg, steps: int, dtype: str) -> dict:
    """One forward and one backward launch a layer a step."""
    return _launch(**{launched_kernel("flash_attention", dtype):
                      steps * cfg.n_layers,
                      bwd_counter(dtype): steps * cfg.n_layers})


def _pinned_route(params, cfg, x2d, top_i):
    """`repro_torch.models.moe._route` with the experts given (T, k): a
    reference run held to another run's routing. The gates and the switch
    aux loss come from this run's own probabilities at those experts,
    formed as `_route` forms them."""
    import torch

    from repro_torch.models.layers import compute_float

    m = cfg.moe
    ct = compute_float(x2d.dtype)
    logits = x2d.to(ct) @ params.router.to(ct)
    if m.padded != m.num_experts:
        logits[:, m.num_experts:] = -1e30
    probs = torch.softmax(logits, dim=-1)
    top_i = top_i.to(probs.device, torch.int64)
    top_p = torch.take_along_dim(probs, top_i, dim=-1)
    gates = top_p / top_p.sum(-1, keepdim=True).clamp(min=1e-9)
    flat = top_i.reshape(-1)
    f_e = torch.zeros(m.padded, dtype=ct, device=x2d.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=ct, device=x2d.device)) \
        / top_i.numel()
    aux = m.num_experts * (f_e * probs.mean(0)).sum()
    return top_i.to(torch.int32), gates.to(x2d.dtype), aux


def train_f32_check(dev, arch: str = TRAIN_ARCH) -> dict:
    """`arch` at full width, TRAIN_F32["n_layers"] layers, in float32 on
    the card: one `loss_fn` forward and backward (3xTF32 B5 forward and
    backward, one each a layer; for the MoE pattern B1 and B4's forward,
    dx and dw as `_moe_train_launches` counts them, at 1 x 256 tokens 64-row
    tiles; for zamba2 B7's forward and backward a Mamba layer and B5's an
    application of the shared block, `_ssm_train_launches`) against the
    same weights in float64 on the CPU (the plain versions): the loss within TRAIN_F32_LOSS of |ref|, each parameter's
    gradient within TRAIN_F32_REL of its max|ref|. A MoE model's float64
    run takes the card's top-k experts (its gates and aux loss from its
    own float64 probabilities at them); the tokens whose top-k set its own
    routing would have changed are counted a layer."""
    import copy
    import dataclasses

    import torch

    from repro_torch import kernels
    from repro_torch.data import SyntheticLMStream
    from repro_torch.models import Model, moe

    cfg = lm_f32_config(arch, "float32")
    model = Model(cfg, device=dev, seed=TRAIN_SEED)
    ref = copy.deepcopy(model).to(device="cpu", dtype=torch.float64)
    ref.cfg = dataclasses.replace(cfg, param_dtype="float64",
                                  compute_dtype="float64")
    batch = SyntheticLMStream(vocab_size=cfg.vocab_size,
                              batch_size=TRAIN_F32["batch"],
                              seq_len=TRAIN_F32["seq"],
                              seed=TRAIN_SEED).batch_at(0)
    route = moe._route
    routes, flips = [], []

    def recorded(params, c, x2d):
        out = route(params, c, x2d)
        routes.append(out[0].cpu())
        return out

    def pinned(params, c, x2d):
        card = routes[len(flips)]
        free = route(params, c, x2d)[0].sort(-1).values
        flips.append(int((free != card.sort(-1).values).any(-1).sum()))
        return _pinned_route(params, c, x2d, card)

    def grads(m, device, hook):
        moe._route = hook
        try:
            loss, _ = m.loss_fn({k: torch.from_numpy(v).to(device)
                                 for k, v in batch.items()})
            names = [n for n, _ in m.named_parameters()]
            got = torch.autograd.grad(loss, [p for _, p in
                                             m.named_parameters()])
        finally:
            moe._route = route
        return loss.detach(), dict(zip(names, got))

    kernels.reset_launches()
    with _AttnEvents() as ev, _GemmEvents() as gev, _SSDEvents() as sev:
        loss, got = grads(model, dev, recorded)
        torch.cuda.synchronize(dev)
    ran = kernels.launches()
    want_launch = {"moe": _moe_train_launches, "zamba2": _ssm_train_launches
                   }.get(cfg.pattern, _train_launches)(cfg, 1, "float32")
    plain = ev.plain + gev.plain + sev.plain
    if ran != want_launch or plain:
        raise AssertionError(f"{arch} float32 twin: launched {ran} and the "
                             f"plain versions {plain} times, expected "
                             f"{want_launch} and none")
    rloss, want = grads(ref, "cpu", pinned)
    loss_err, loss_share = _within(loss.cpu(), rloss, TRAIN_F32_LOSS *
                                   rloss.abs(), f"{arch} float32 twin loss")
    shares = {}
    for n, w in want.items():
        top = float(w.abs().max().item())
        _, shares[n] = _within(got[n].cpu(), w, torch.full_like(
            w, TRAIN_F32_REL * top), f"{arch} float32 twin gradient {n}")
    del model, ref, got, want
    torch.cuda.empty_cache()
    return dict(n_layers=cfg.n_layers, batch=TRAIN_F32["batch"],
                seq=TRAIN_F32["seq"], loss=float(rloss),
                loss_share=loss_share,
                grad_share_max=max(shares.values()),
                grad_shares=shares, routing_flips=flips,
                tokens_per_layer=TRAIN_F32["batch"] * TRAIN_F32["seq"],
                launches={k: v for k, v in ran.items() if v})


def train_path(dev) -> dict:
    """Phase 14: `Trainer` takes TRAIN_STEPS steps of tinyllama-1.1b at full
    width and depth in bf16 (random weights from TRAIN_SEED) on
    `SyntheticLMStream(vocab, TRAIN_BATCH, TRAIN_SEQ)`, grad_accum 1, int8
    gradient compression, `AdamWConfig(warmup_steps=TRAIN_WARMUP)`:
    (1) uninterrupted (the control: step times, peak memory, launches,
    B5's forward and backward ms inside one more step); (2) with a
    checkpoint every TRAIN_CKPT_EVERY steps in a temporary directory and a
    failure at step 4 (restored, continued): every logged loss and grad
    norm bit-identical to the control's at its step, launches exact (one
    forward and one backward a layer a step run, the plain versions never
    called); (3) the float32 twin (`train_f32_check`)."""
    import math
    import tempfile

    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMStream
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import FailureInjector, Trainer, TrainerConfig

    cfg = get_config(TRAIN_ARCH)
    stream = SyntheticLMStream(vocab_size=cfg.vocab_size,
                               batch_size=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                               seed=TRAIN_SEED)
    opt = AdamWConfig(warmup_steps=TRAIN_WARMUP)
    row = dict(arch=TRAIN_ARCH, batch=TRAIN_BATCH, seq=TRAIN_SEQ,
               steps=TRAIN_STEPS, dtype=cfg.compute_dtype)

    # (1) the control, uninterrupted, no checkpoint
    with tempfile.TemporaryDirectory() as tmp:
        ctl = Trainer(cfg, opt, TrainerConfig(
            total_steps=TRAIN_STEPS, checkpoint_every=TRAIN_STEPS + 1,
            checkpoint_dir=tmp, log_every=1, compress_grads=True), stream,
            device=dev)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        with _AttnEvents() as ev:
            out = ctl.run(seed=TRAIN_SEED)
        row["control_wall_s"] = time.perf_counter() - t0
        row["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        ran = kernels.launches()
        want = _train_launches(cfg, TRAIN_STEPS, cfg.compute_dtype)
        if ran != want or ev.plain:
            raise AssertionError(f"training launched {ran} and the plain "
                                 f"versions {ev.plain} times, expected "
                                 f"{want} and none")
        row["params"] = ctl.model.param_count()
        control = out["history"]
        # B5 inside one more step, by CUDA events
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch_at(TRAIN_STEPS).items()}
        kernels.reset_launches()
        with _AttnEvents() as ev:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            ctl.train_step(out["state"], batch)
            torch.cuda.synchronize(dev)
            row["timed_step_ms"] = (time.perf_counter() - t0) * 1e3
        row["attention_ms"] = ev.ms()
        row["attention_calls"] = {k: len(v) for k, v in ev.events.items()}
        if kernels.launches() != _train_launches(cfg, 1, cfg.compute_dtype):
            raise AssertionError(f"a step launched {kernels.launches()}")
        del ctl, out, batch
        torch.cuda.empty_cache()

    # (2) checkpoints, a failure, the restore
    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(cfg, opt, TrainerConfig(
            total_steps=TRAIN_STEPS, checkpoint_every=TRAIN_CKPT_EVERY,
            checkpoint_dir=tmp, log_every=1, compress_grads=True,
            keep_checkpoints=1), stream,
            failure_injector=FailureInjector(dict(TRAIN_FAILURE)),
            device=dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        with _AttnEvents() as ev:
            out = tr.run(seed=TRAIN_SEED)
        row["recovery_wall_s"] = time.perf_counter() - t0
        ran = kernels.launches()
        fail_at = min(TRAIN_FAILURE)
        steps_run = TRAIN_STEPS + fail_at - TRAIN_CKPT_EVERY * (
            fail_at // TRAIN_CKPT_EVERY)
        want = _train_launches(cfg, steps_run, cfg.compute_dtype)
        if ran != want or ev.plain or out["recoveries"] != 1:
            raise AssertionError(
                f"the run with a failure launched {ran}, the plain versions "
                f"{ev.plain} times, recovered {out['recoveries']} times; "
                f"expected {want}, none, once")
        row["launches"] = {k: v for k, v in ran.items() if v}
        row["steps_run"] = steps_run
        history = out["history"]
        del tr, out
        torch.cuda.empty_cache()

    # gates
    ln_v = math.log(cfg.vocab_size)
    for h in control + history:
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            raise AssertionError(f"step {h['step']}: loss {h['loss']}, grad "
                                 f"norm {h['grad_norm']}")
    if abs(control[0]["loss"] - ln_v) > TRAIN_FIRST_LOSS:
        raise AssertionError(f"first loss {control[0]['loss']}, ln V = "
                             f"{ln_v}")
    by_step = {h["step"]: h for h in control}
    steps = [h["step"] for h in history]
    if steps != sorted(steps) or len(steps) != steps_run:
        raise AssertionError(f"the run with a failure logged steps {steps}")
    for h in history:
        c = by_step[h["step"]]
        if (h["loss"], h["grad_norm"]) != (c["loss"], c["grad_norm"]):
            raise AssertionError(
                f"step {h['step']} after the restore: loss {h['loss']}, grad "
                f"norm {h['grad_norm']}; uninterrupted {c['loss']}, "
                f"{c['grad_norm']}")
    row["history"] = control
    row["history_with_failure"] = history
    step_s = [h["sec_per_step"] for h in control[1:]]
    row["step_ms"] = float(np.median(step_s)) * 1e3
    row["step_ms_all"] = [s * 1e3 for s in step_s]
    row["tokens_per_s"] = TRAIN_BATCH * TRAIN_SEQ / (row["step_ms"] / 1e3)

    # (3) float32 twin against float64
    row["float32"] = train_f32_check(dev)
    return row


# granite-moe-1b-a400m (src/repro/configs/granite_moe_1b_a400m.py) at full
# width and depth: 24 layers, d_model 1,024, 16 heads (8 KV), 32 experts,
# top 8, d_ff_expert 512, 4 hot experts. Batch 2 x 4,096, cut from
# tinyllama's 4 x 4,096: a layer keeps 0.900 GB for its backward a 4,096
# tokens (the hot path's 8 x 4,096 gathered rows, the cold path's 1.25 x
# that of capacity buffers, each with its SwiGLU; `saved_tensors.py` on
# the CPU), so with ~21 GB of parameters, gradients, moments and
# residuals 4 x 4,096 reckons at ~111 GB and 2 x 4,096 at ~66 GB of the
# card's 80
TRAIN_MOE_ARCH = "granite-moe-1b-a400m"
TRAIN_MOE_BATCH = 2
TRAIN_MOE_SEQ = 4096
TRAIN_MOE_STEPS = 4
# the first loss against the same weights' loss in float32 on the card, in
# place of tinyllama's ln V gate: the tied embedding (N(0, 1) rows, as the
# JAX package draws them) puts a random model's logits at ~32 times a unit
# normal, so its first loss (~293) is far above ln V. bf16 read 1.08e-4 to
# 2.26e-4 of the float32 loss (NVIDIA H100 80GB HBM3, 700.00 W): the gate
# leaves ~4x room over the worst
TRAIN_MOE_FIRST_REL = 1e-3


def _moe_train_launches(cfg, steps: int, dtype: str) -> dict:
    """A MoE layer a step: B5's forward and backward, one histogram (the
    dispatch's Phase 1), four B4 forward launches (the hot and the cold
    SwiGLU) and eight backward ones (dx and dw of each)."""
    n = steps * cfg.n_layers
    return _launch(**{launched_kernel("flash_attention", dtype): n,
                      bwd_counter(dtype): n, "histogram": n,
                      launched_kernel("moe_gemm", dtype): 4 * n,
                      dx_counter(dtype): 4 * n, dw_counter(dtype): 4 * n})


def train_moe_path(dev) -> dict:
    """Phase 14, granite part: `Trainer` takes TRAIN_MOE_STEPS steps of
    granite-moe-1b-a400m at full width and depth in bf16 (random weights
    from TRAIN_SEED) on `SyntheticLMStream(vocab, TRAIN_MOE_BATCH,
    TRAIN_MOE_SEQ)`, int8 gradient compression, no checkpoint: every loss
    finite, the first within TRAIN_MOE_FIRST_REL of the same weights' loss
    in float32 on the card; launches exact (`_moe_train_launches`), the
    plain versions never called; step times, peak memory, and B4's and
    B5's forward and backward ms inside one more step (CUDA events); then
    the float32 twin (`train_f32_check`)."""
    import dataclasses
    import math
    import tempfile

    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMStream
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = get_config(TRAIN_MOE_ARCH)
    stream = SyntheticLMStream(vocab_size=cfg.vocab_size,
                               batch_size=TRAIN_MOE_BATCH,
                               seq_len=TRAIN_MOE_SEQ, seed=TRAIN_SEED)
    row = dict(arch=TRAIN_MOE_ARCH, batch=TRAIN_MOE_BATCH,
               seq=TRAIN_MOE_SEQ, steps=TRAIN_MOE_STEPS,
               dtype=cfg.compute_dtype)
    # the same weights in float32 (the float32 kernels), the first batch's
    # loss under no_grad: what the bf16 run's first loss is held to
    f32 = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    first = {k: torch.from_numpy(v).to(dev)
             for k, v in stream.batch_at(0).items()}
    with torch.no_grad():
        m32 = Model(cfg, device=dev, seed=TRAIN_SEED).to(torch.float32)
        m32.cfg = f32
        row["first_loss_float32"] = float(m32.loss_fn(first)[0])
    del m32, first
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(cfg, AdamWConfig(warmup_steps=TRAIN_WARMUP),
                     TrainerConfig(total_steps=TRAIN_MOE_STEPS,
                                   checkpoint_every=TRAIN_MOE_STEPS + 1,
                                   checkpoint_dir=tmp, log_every=1,
                                   compress_grads=True),
                     stream, device=dev)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        with _AttnEvents() as ev, _GemmEvents() as gev:
            out = tr.run(seed=TRAIN_SEED)
        row["wall_s_steps"] = time.perf_counter() - t0
        row["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        ran = kernels.launches()
        want = _moe_train_launches(cfg, TRAIN_MOE_STEPS, cfg.compute_dtype)
        if ran != want or ev.plain or gev.plain:
            raise AssertionError(
                f"granite training launched {ran} and the plain versions "
                f"{ev.plain} + {gev.plain} times, expected {want} and none")
        row["launches"] = {k: v for k, v in ran.items() if v}
        row["params"] = tr.model.param_count()
        history = out["history"]
        # B4 and B5 inside one more step, by CUDA events
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch_at(TRAIN_MOE_STEPS).items()}
        kernels.reset_launches()
        with _AttnEvents() as ev, _GemmEvents() as gev:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            tr.train_step(out["state"], batch)
            torch.cuda.synchronize(dev)
            row["timed_step_ms"] = (time.perf_counter() - t0) * 1e3
        row["attention_ms"] = ev.ms()
        row["gemm_ms"] = gev.ms()
        row["gemm_calls"] = {k: len(v) for k, v in gev.events.items()}
        if kernels.launches() != _moe_train_launches(cfg, 1,
                                                     cfg.compute_dtype):
            raise AssertionError(f"a granite step launched "
                                 f"{kernels.launches()}")
        del tr, out, batch
        torch.cuda.empty_cache()

    for h in history:
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            raise AssertionError(f"granite step {h['step']}: loss "
                                 f"{h['loss']}, grad norm {h['grad_norm']}")
    ref = row["first_loss_float32"]
    row["first_loss_share"] = abs(history[0]["loss"] - ref) / (
        TRAIN_MOE_FIRST_REL * abs(ref))
    if row["first_loss_share"] > 1:
        raise AssertionError(f"granite first loss {history[0]['loss']}, the "
                             f"same weights in float32 {ref}")
    row["ln_vocab"] = math.log(cfg.vocab_size)
    row["history"] = history
    step_s = [h["sec_per_step"] for h in history[1:]]
    row["step_ms"] = float(np.median(step_s)) * 1e3
    row["step_ms_all"] = [v * 1e3 for v in step_s]
    row["tokens_per_s"] = TRAIN_MOE_BATCH * TRAIN_MOE_SEQ / (
        row["step_ms"] / 1e3)
    row["float32"] = train_f32_check(dev, TRAIN_MOE_ARCH)
    return row


# zamba2-1.2b (src/repro/configs/zamba2_1_2b.py) at full width and depth:
# 38 Mamba2 layers (d_model 2,048, 64 heads of 64, d_state 64, chunk 128)
# and 7 applications of the shared attention block (32 heads of 64). Batch
# 2 x 4,096, granite's: with B7's backward keeping only its inputs and
# the chunk states, a Mamba layer keeps 0.562 GB a 4,096-token row for
# its backward and an application of the shared block 0.589 GB
# (`saved_tensors.py --arch zamba2-1.2b` on the CPU at 2 layers x 4,096
# and 6 x 1,024), so 2 x 4,096 reckons at ~52 GB of activations beside
# ~19 GB of parameters, gradients, moments and residuals
TRAIN_SSM_ARCH = "zamba2-1.2b"
TRAIN_SSM_BATCH = 2
TRAIN_SSM_SEQ = 4096
TRAIN_SSM_STEPS = 4


def _ssm_train_launches(cfg, steps: int, dtype: str) -> dict:
    """A zamba2 step: B7's forward and backward (float32: the layer lifts
    x, B, C) a Mamba layer, B5's forward and backward an application of
    the shared attention block."""
    n = steps * cfg.n_layers
    a = steps * -(-cfg.n_layers // cfg.shared_attn_every)
    return _launch(**{"mamba_scan": n, "mamba_scan_bwd": n,
                      launched_kernel("flash_attention", dtype): a,
                      bwd_counter(dtype): a})


def train_ssm_path(dev) -> dict:
    """Phase 14, zamba2 part: `Trainer` takes TRAIN_SSM_STEPS steps of
    zamba2-1.2b at full width and depth in bf16 (random weights from
    TRAIN_SEED) on `SyntheticLMStream(vocab, TRAIN_SSM_BATCH,
    TRAIN_SSM_SEQ)`, int8 gradient compression, no checkpoint: every loss
    finite, the first within TRAIN_MOE_FIRST_REL of the same weights' loss
    in float32 on the card; launches exact (`_ssm_train_launches`), the
    plain versions never called; step times, peak memory, and B7's and
    B5's forward and backward ms inside one more step (CUDA events; B7's
    backward split by kernel from a torch.profiler session over that
    step); then the float32 twin (`train_f32_check`)."""
    import dataclasses
    import math
    import tempfile

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMStream
    from repro_torch.models import Model
    from repro_torch.optim import AdamWConfig
    from repro_torch.runtime import Trainer, TrainerConfig

    cfg = get_config(TRAIN_SSM_ARCH)
    stream = SyntheticLMStream(vocab_size=cfg.vocab_size,
                               batch_size=TRAIN_SSM_BATCH,
                               seq_len=TRAIN_SSM_SEQ, seed=TRAIN_SEED)
    row = dict(arch=TRAIN_SSM_ARCH, batch=TRAIN_SSM_BATCH,
               seq=TRAIN_SSM_SEQ, steps=TRAIN_SSM_STEPS,
               dtype=cfg.compute_dtype)
    f32 = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    first = {k: torch.from_numpy(v).to(dev)
             for k, v in stream.batch_at(0).items()}
    with torch.no_grad():
        m32 = Model(cfg, device=dev, seed=TRAIN_SEED).to(torch.float32)
        m32.cfg = f32
        row["first_loss_float32"] = float(m32.loss_fn(first)[0])
    del m32, first
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as tmp:
        tr = Trainer(cfg, AdamWConfig(warmup_steps=TRAIN_WARMUP),
                     TrainerConfig(total_steps=TRAIN_SSM_STEPS,
                                   checkpoint_every=TRAIN_SSM_STEPS + 1,
                                   checkpoint_dir=tmp, log_every=1,
                                   compress_grads=True),
                     stream, device=dev)
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        kernels.reset_launches()
        t0 = time.perf_counter()
        with _AttnEvents() as ev, _SSDEvents() as sev:
            out = tr.run(seed=TRAIN_SEED)
        row["wall_s_steps"] = time.perf_counter() - t0
        row["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
        ran = kernels.launches()
        want = _ssm_train_launches(cfg, TRAIN_SSM_STEPS, cfg.compute_dtype)
        if ran != want or ev.plain or sev.plain:
            raise AssertionError(
                f"zamba2 training launched {ran} and the plain versions "
                f"{ev.plain} + {sev.plain} times, expected {want} and none")
        row["launches"] = {k: v for k, v in ran.items() if v}
        row["params"] = tr.model.param_count()
        history = out["history"]
        # B7 and B5 inside one more step, by CUDA events; B7's backward
        # kernels by the profiler's device events over the same step
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in stream.batch_at(TRAIN_SSM_STEPS).items()}
        kernels.reset_launches()
        with _AttnEvents() as ev, _SSDEvents() as sev, profile(
                activities=[ProfilerActivity.CPU,
                            ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            tr.train_step(out["state"], batch)
            torch.cuda.synchronize(dev)
            row["timed_step_ms"] = (time.perf_counter() - t0) * 1e3
            time.sleep(PROFILE_PAD_S)
        row["attention_ms"] = ev.ms()
        row["ssd_ms"] = sev.ms()
        row["ssd_calls"] = {k: len(v) for k, v in sev.events.items()}
        events = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                events[e.name] = events.get(e.name, 0.0) + (
                    e.time_range.end - e.time_range.start) / 1e3
        split = bwd_split(events, "profiler", SSD_BWD_PARTS)
        del split["other"]  # the rest of the step
        row["ssd_bwd_split_ms"] = split if any(split.values()) else None
        if kernels.launches() != _ssm_train_launches(cfg, 1,
                                                     cfg.compute_dtype):
            raise AssertionError(f"a zamba2 step launched "
                                 f"{kernels.launches()}")
        del tr, out, batch, prof
        torch.cuda.empty_cache()

    for h in history:
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            raise AssertionError(f"zamba2 step {h['step']}: loss "
                                 f"{h['loss']}, grad norm {h['grad_norm']}")
    ref = row["first_loss_float32"]
    row["first_loss_share"] = abs(history[0]["loss"] - ref) / (
        TRAIN_MOE_FIRST_REL * abs(ref))
    if row["first_loss_share"] > 1:
        raise AssertionError(f"zamba2 first loss {history[0]['loss']}, the "
                             f"same weights in float32 {ref}")
    row["ln_vocab"] = math.log(cfg.vocab_size)
    row["history"] = history
    step_s = [h["sec_per_step"] for h in history[1:]]
    row["step_ms"] = float(np.median(step_s)) * 1e3
    row["step_ms_all"] = [v * 1e3 for v in step_s]
    row["tokens_per_s"] = TRAIN_SSM_BATCH * TRAIN_SSM_SEQ / (
        row["step_ms"] / 1e3)
    row["float32"] = train_f32_check(dev, TRAIN_SSM_ARCH)
    return row


# ---------------------------------------------------------------------------
# C2: bf16 prefill_mha once beyond its gate (a diagnostic, not in the default
# run: `--c2-repeats N`)
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# phase 15: the model-level mesh (launch.steps on launch.mesh.make_host_mesh)
# ---------------------------------------------------------------------------
# a ("data", "model") mesh of 1 x 4 stacked shards on the card: the MoE
# layers' sequence-split branch (train, prefill) and psum branch (decode)
MESH = (1, 4)
# (a) granite-moe-1b-a400m trained at full width and depth: train_4k's
# batch of 256 cut to one row of 4,096 (each shard routes 1,024 tokens x
# top-8); 5 steps, the first a warm-up (the median is of steps 2-5), then
# one more with every kernel call checked
MESH_TRAIN_BATCH = 1
MESH_TRAIN_SEQ = 4096
MESH_TRAIN_STEPS = 5
# the capacity factor at which nothing drops on a mesh of 4: a shard's
# send capacity T_l·k/ep·cf is then T_l·k, every assignment it has
MESH_AMPLE = 4.0
# (c) granite-moe-3b-a800m served at full width at LM_CHECK_LAYERS' depth:
# an LM_BATCH x LM_PROMPT prefill, then MESH_SERVE_STEPS greedy decode
# steps
MESH_SERVE_ARCH = "granite-moe-3b-a800m"
MESH_SERVE_STEPS = 16


class _DropCount:
    """The assignments the MoE layers' push path drops while the `with`
    block runs (`repro_torch.models.moe.moe_push_pull` wrapped; its drop
    count is a device tensor, summed on the card and read once)."""

    def __enter__(self):
        from repro_torch.models import moe

        self.fn, self.sum, self.calls = moe.moe_push_pull, None, 0

        def counted(*a, **kw):
            y, aux = self.fn(*a, **kw)
            n = aux.dropped_assignments.reshape(-1)[0]  # psum'd: row 0
            self.sum = n if self.sum is None else self.sum + n
            self.calls += 1
            return y, aux
        moe.moe_push_pull = counted
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe

        moe.moe_push_pull = self.fn
        return False

    @property
    def total(self) -> int:
        return 0 if self.sum is None else int(self.sum)


def _mesh_serve_launches(cfg, steps: int) -> dict:
    """A prefill on the mesh (the sequence-split branch: a histogram and
    four B4 launches a MoE layer, B5 a layer) and `steps` decode steps (the
    psum branch: one grouped SwiGLU over all shards' experts, two B4
    launches a layer, no histogram; B6 a layer)."""
    n = cfg.n_layers
    return _launch(**{"flash_attention_sm90": n, "histogram": n,
                      "moe_gemm_sm90": 4 * n + 2 * n * steps,
                      "flash_decode_sm90": n * steps})


def _collectives_row(mesh, per: int) -> dict:
    """A device's collectives on `mesh` (`launch.collectives`), divided by
    `per` (steps)."""
    from repro_torch.launch.collectives import collective_stats

    st = collective_stats(mesh)
    g = mesh.groups[0]
    return dict(wire_bytes=st.wire_bytes / per,
                result_bytes={k: v / per for k, v in g.result_bytes.items()},
                calls={k: v / per for k, v in g.calls.items()},
                a2a_send_bytes=g.a2a_bytes / per)


class _BwdChecks:
    """Hold every backward kernel call of B4 (`moe_gemm.ops._launch_dx`,
    `_launch_dw`) and B5 (`flash_attention.ops._backward`) inside the
    `with` block against its plain version on the same inputs, at phase
    2's gates (`dx_check`, `dw_check`, `bwd_check`); the calls still launch
    and count. `rows` receives one entry a call, as `_value_checks`'."""

    def __init__(self, rows: list):
        self.rows = rows

    def __enter__(self):
        import torch

        from repro_torch.kernels.flash_attention import ops as fa
        from repro_torch.kernels.moe_gemm import ops as gg

        self.saved = (gg._launch_dx, gg._launch_dw, fa._backward)
        launch_dx, launch_dw, backward = self.saved
        counts = {}

        def checked(entry, fn, check):
            def call(*a, **kw):
                out = fn(*a, **kw)
                i = counts[entry] = counts.get(entry, 0) + 1
                tag = f"{entry} call {i}"
                with torch.no_grad():
                    e, share = check(a, out, tag)
                self.rows.append(dict(
                    call=tag, entry=entry, dtype=str(a[0].dtype),
                    shape=[tuple(t.shape) for t in a
                           if isinstance(t, torch.Tensor)],
                    max_abs_err=e, share_of_tolerance=share))
                return out
            return call
        gg._launch_dx = checked("grouped_gemm dx", launch_dx,
                                lambda a, out, tag: dx_check(*a[:3], out,
                                                             tag))
        gg._launch_dw = checked("grouped_gemm dw", launch_dw,
                                lambda a, out, tag: dw_check(*a[:3], out,
                                                             tag))
        fa._backward = checked("attention backward", backward,
                               lambda a, out, tag: bwd_check(out, a[:6],
                                                             a[6], tag))
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels.flash_attention import ops as fa
        from repro_torch.kernels.moe_gemm import ops as gg

        gg._launch_dx, gg._launch_dw, fa._backward = self.saved
        return False


# the entries phase 15 (a)'s checked step must reach: the forward's through
# `_value_checks`, the backward's through `_BwdChecks`
MESH_TRAIN_CHECKED = ("grouped_gemm", "attention", "count_ids",
                      "grouped_gemm dx", "grouped_gemm dw",
                      "attention backward")


def mesh_train(dev) -> dict:
    """Phase 15 (a): `build_step` of granite-moe-1b-a400m at full width and
    depth in bf16 on `make_host_mesh(*MESH)`, MESH_TRAIN_STEPS steps of
    MESH_TRAIN_BATCH x MESH_TRAIN_SEQ: losses finite, launches exact
    (`_moe_train_launches`: one data group runs them as one device does),
    the plain versions never called; step ms (the median of steps 2 on,
    each step's CUDA-event span beside its host wall), tokens/s, peak
    memory, B4's and B5's device ms a step, the collectives and dropped
    assignments a step. Then one more step, not counted, with every kernel
    call of the forward (`_value_checks`) and of the backward
    (`_BwdChecks`) held against its plain version at the mesh's own shapes
    (the shards' receive buffers), each entry of MESH_TRAIN_CHECKED
    reached."""
    import math

    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMStream
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_step
    from repro_torch.optim import AdamWConfig, init_opt_state

    cfg = get_config(TRAIN_MOE_ARCH)
    mesh = make_host_mesh(*MESH, device=dev)
    shape = dict(seq=MESH_TRAIN_SEQ, batch=MESH_TRAIN_BATCH, kind="train")
    step = build_step(cfg, mesh, shape, grad_accum=1, device=dev,
                      seed=TRAIN_SEED,
                      opt_cfg=AdamWConfig(warmup_steps=TRAIN_WARMUP))
    params = dict(step.model.named_parameters())
    opt = init_opt_state(params)
    stream = SyntheticLMStream(vocab_size=cfg.vocab_size,
                               batch_size=MESH_TRAIN_BATCH,
                               seq_len=MESH_TRAIN_SEQ, seed=TRAIN_SEED)
    row = dict(arch=TRAIN_MOE_ARCH, mesh=MESH, batch=MESH_TRAIN_BATCH,
               seq=MESH_TRAIN_SEQ, steps=MESH_TRAIN_STEPS,
               params=step.model.param_count(), dtype=cfg.compute_dtype,
               tokens_a_shard=MESH_TRAIN_BATCH * MESH_TRAIN_SEQ // MESH[1])
    history = []
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    mesh.reset_counts()
    spans = []
    with _AttnEvents() as ev, _GemmEvents() as gev, _DropCount() as drops:
        for i in range(MESH_TRAIN_STEPS):
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in stream.batch_at(i).items()}
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            s.record()
            _, _, met = step.fn(params, opt, batch)
            e.record()
            loss = float(met["loss"])  # waits for the step's work
            history.append(dict(step=i + 1, loss=loss,
                                aux=float(met["aux"]),
                                grad_norm=float(met["grad_norm"]),
                                ms=(time.perf_counter() - t0) * 1e3))
            spans.append((s, e))
    row["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    for h, (s, e) in zip(history, spans):
        h["device_span_ms"] = s.elapsed_time(e)
    row["kernel_ms_per_step"] = {
        f"B5 {k}": v / MESH_TRAIN_STEPS for k, v in ev.ms().items()}
    row["kernel_ms_per_step"].update({
        f"B4 {k}": v / MESH_TRAIN_STEPS for k, v in gev.ms().items()})
    ran = kernels.launches()
    _check_path_launches("model-level mesh's training", ran, {
        "train": _moe_train_launches(cfg, MESH_TRAIN_STEPS,
                                     cfg.compute_dtype)})
    if ev.plain or gev.plain:
        raise AssertionError(f"mesh training called the plain versions "
                             f"{ev.plain} + {gev.plain} times")
    for h in history:
        if not (math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])):
            raise AssertionError(f"mesh training step {h['step']}: {h}")
    row["launches"] = {k: v for k, v in ran.items() if v}
    row["history"] = history
    row["step_ms"] = float(np.median([h["ms"] for h in history[1:]]))
    row["tokens_per_s"] = MESH_TRAIN_BATCH * MESH_TRAIN_SEQ / (
        row["step_ms"] / 1e3)
    row["dropped_per_step"] = drops.total / MESH_TRAIN_STEPS
    row["assignments_per_step"] = (MESH_TRAIN_BATCH * MESH_TRAIN_SEQ
                                   * cfg.moe.top_k * cfg.n_layers)
    row["collectives_per_step"] = _collectives_row(mesh, MESH_TRAIN_STEPS)

    checks = []
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in stream.batch_at(MESH_TRAIN_STEPS).items()}
    with _KernelHook(_value_checks(checks)), _BwdChecks(checks):
        _, _, met = step.fn(params, opt, batch)
    if not math.isfinite(float(met["loss"])):
        raise AssertionError(f"mesh training's checked step: {met}")
    by_entry = {e: sum(c["entry"] == e for c in checks)
                for e in sorted({c["entry"] for c in checks})}
    missing = [e for e in MESH_TRAIN_CHECKED if not by_entry.get(e)]
    if missing:
        raise AssertionError(f"mesh training's checked step reached no "
                             f"call of {missing}: {by_entry}")
    row["kernel_checks"] = len(checks)
    row["kernel_checks_by_entry"] = by_entry
    worst = max(checks, key=lambda c: c["share_of_tolerance"])
    row["kernel_worst_share"] = worst["share_of_tolerance"]
    row["kernel_worst_call"] = worst["call"]
    del step, params, opt, batch
    torch.cuda.empty_cache()
    return row


def _mesh_grads(model, batch):
    import torch

    loss, _ = model.loss_fn(batch)
    names = [n for n, _ in model.named_parameters()]
    got = torch.autograd.grad(loss, [p for _, p in model.named_parameters()])
    return loss.detach(), dict(zip(names, got))


def mesh_equal(dev) -> dict:
    """Phase 15 (b): at MESH_AMPLE capacity (asserted: nothing drops) and
    aux weight 0 (the mesh's aux is the mean of the shards' own, which
    differs from one device's aux over all tokens by definition), the
    (1, 4) mesh against a (1, 1) one on the same weights, both from
    `build_step`: the float32 twin (TRAIN_F32's 2 layers at full width, 1
    x 256) within phase 14's gates — loss TRAIN_F32_LOSS·|ref|, every
    gradient TRAIN_F32_REL·max|ref|; then LM_CHECK_LAYERS["moe"] layers in
    bf16 at MESH_TRAIN_BATCH x MESH_TRAIN_SEQ, the mesh's loss within
    TRAIN_MOE_FIRST_REL of the same weights' float32 loss on one device."""
    import dataclasses

    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLMStream
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_step

    base = get_config(TRAIN_MOE_ARCH)
    ample = dataclasses.replace(base.moe, capacity_factor=MESH_AMPLE,
                                aux_loss_weight=0.0)

    def models(cfg, seq, batch, shapes=(MESH, (1, 1))):
        out = []
        for s in shapes:
            out.append(build_step(cfg, make_host_mesh(*s, device=dev),
                                  dict(seq=seq, batch=batch, kind="train"),
                                  device=dev, seed=TRAIN_SEED).model)
        return out

    def tokens(cfg, batch, seq):
        return {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLMStream(
            vocab_size=cfg.vocab_size, batch_size=batch, seq_len=seq,
            seed=TRAIN_SEED).batch_at(0).items()}

    # the float32 twin
    f32 = dataclasses.replace(base, n_layers=TRAIN_F32["n_layers"],
                              moe=ample, param_dtype="float32",
                              compute_dtype="float32")
    m4, m1 = models(f32, TRAIN_F32["seq"], TRAIN_F32["batch"])
    batch = tokens(f32, TRAIN_F32["batch"], TRAIN_F32["seq"])
    with _DropCount() as drops:
        loss4, g4 = _mesh_grads(m4, batch)
        loss1, g1 = _mesh_grads(m1, batch)
    if drops.total or drops.calls != 2 * f32.n_layers:
        raise AssertionError(f"mesh float32 twin: {drops.total} assignments "
                             f"dropped over {drops.calls} dispatches")
    row = dict(layers=f32.n_layers, batch=TRAIN_F32["batch"],
               seq=TRAIN_F32["seq"], capacity_factor=MESH_AMPLE,
               loss=float(loss1))
    row["loss_err"], row["loss_share"] = _within(
        loss4, loss1, TRAIN_F32_LOSS * loss1.abs(), "mesh float32 twin loss")
    shares = {}
    for n, w in g1.items():
        _, shares[n] = _within(g4[n], w, torch.full_like(
            w, TRAIN_F32_REL * float(w.abs().max())),
            f"mesh float32 twin gradient {n}")
    row["grad_share_max"] = max(shares.values())
    row["grad_share_worst"] = max(shares, key=shares.get)
    del m4, m1, g4, g1
    torch.cuda.empty_cache()

    # bf16 at LM_CHECK_LAYERS' depth against its float32 weights
    c8 = dataclasses.replace(base, n_layers=LM_CHECK_LAYERS["moe"],
                             moe=ample)
    (m4,) = models(c8, MESH_TRAIN_SEQ, MESH_TRAIN_BATCH, (MESH,))
    batch = tokens(c8, MESH_TRAIN_BATCH, MESH_TRAIN_SEQ)
    with torch.no_grad(), _DropCount() as drops:
        bf16 = float(m4.loss_fn(batch)[0])
        c32 = dataclasses.replace(c8, param_dtype="float32",
                                  compute_dtype="float32")
        (m1,) = models(c32, MESH_TRAIN_SEQ, MESH_TRAIN_BATCH, ((1, 1),))
        m1.load_state_dict({k: v.float() for k, v in
                            m4.state_dict().items()})
        ref = float(m1.loss_fn(batch)[0])
    if drops.total:
        raise AssertionError(f"mesh bf16 check dropped {drops.total}")
    row["bf16"] = dict(layers=c8.n_layers, batch=MESH_TRAIN_BATCH,
                       seq=MESH_TRAIN_SEQ, loss=bf16, loss_float32=ref,
                       share=abs(bf16 - ref) / (TRAIN_MOE_FIRST_REL
                                                * abs(ref)))
    if not row["bf16"]["share"] <= 1:
        raise AssertionError(f"mesh bf16 loss {bf16} against the float32 "
                             f"weights' {ref}: {row['bf16']['share']:.3f} "
                             f"of {TRAIN_MOE_FIRST_REL}·|ref|")
    del m4, m1
    torch.cuda.empty_cache()
    return row


def mesh_serve(dev) -> dict:
    """Phase 15 (c): MESH_SERVE_ARCH at full width, LM_CHECK_LAYERS["moe"]
    layers, bf16, on `make_host_mesh(*MESH)` through `build_step`: an
    LM_BATCH x LM_PROMPT prefill (the sequence-split branch) and
    MESH_SERVE_STEPS greedy decode steps (the psum branch). (1) after one
    untimed prefill, counted and timed: launches exact
    (`_mesh_serve_launches`), prefill ms, decode step ms, peak memory,
    collectives, dropped assignments. (2) again with
    every kernel call held against its plain version (`_value_checks`).
    (3) at MESH_AMPLE capacity against the same weights on one device,
    the mesh's greedy tokens fed to both: every logits tensor within
    `lm_gate`'s share of max|ref|."""
    import dataclasses

    import torch

    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import build_step
    from repro_torch.models import Model

    cfg = dataclasses.replace(get_config(MESH_SERVE_ARCH),
                              n_layers=LM_CHECK_LAYERS["moe"])
    P, B, T = LM_PROMPT, LM_BATCH, MESH_SERVE_STEPS
    mesh = make_host_mesh(*MESH, device=dev)
    pre = build_step(cfg, mesh, dict(seq=P, batch=B, kind="prefill"),
                     device=dev, seed=LM_SEED)
    dec = build_step(cfg, mesh, dict(seq=P + T, batch=B, kind="decode"),
                     model=pre.model)
    g = torch.Generator(device=dev).manual_seed(LM_SEED + 1)
    prompts = torch.randint(0, cfg.vocab_size, (B, P), generator=g,
                            device=dev, dtype=torch.int32)
    row = dict(arch=MESH_SERVE_ARCH, layers=cfg.n_layers, batch=B, prompt=P,
               steps=T, mesh=MESH)

    def serve(tokens=None, model_pre=pre.fn, model_dec=dec.fn, times=None):
        """Prefill, then T decode steps: greedy, or fed `tokens` (B, T)."""
        if times is not None:
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
        logits, caches = model_pre({"tokens": prompts}, max_len=P + T)
        if times is not None:
            torch.cuda.synchronize(dev)
            times.append((time.perf_counter() - t0) * 1e3)
        out, fed = [logits], []
        for i in range(T):
            tok = (out[-1][:, -1].argmax(-1, keepdim=True).to(torch.int32)
                   if tokens is None else tokens[:, i:i + 1])
            fed.append(tok)
            if times is not None:
                t0 = time.perf_counter()
            logits, caches = model_dec(caches, {"tokens": tok}, P + i)
            if times is not None:
                torch.cuda.synchronize(dev)
                times.append((time.perf_counter() - t0) * 1e3)
            out.append(logits)
        return out, torch.cat(fed, 1)

    # (1) counted and timed, after one untimed prefill (the model's first)
    pre.fn({"tokens": prompts}, max_len=P + T)
    times = []
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    kernels.reset_launches()
    mesh.reset_counts()
    with _DropCount() as drops:
        out, fed = serve(times=times)
    ran = kernels.launches()
    _check_path_launches("model-level mesh's serving", ran, {
        "serve": _mesh_serve_launches(cfg, T)})
    for t in out:
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("mesh serving: non-finite logits")
    row.update(peak_bytes=torch.cuda.max_memory_allocated(dev),
               launches={k: v for k, v in ran.items() if v},
               prefill_ms=times[0], decode_step_ms=float(np.median(
                   times[1:])), decode_step_ms_all=times[1:],
               dropped_prefill=drops.total, dispatches=drops.calls,
               assignments_prefill=B * P * cfg.moe.top_k * cfg.n_layers,
               collectives=_collectives_row(mesh, 1))

    # (2) every kernel call against its plain version
    checks = []
    with _KernelHook(_value_checks(checks)):
        serve()
    row["kernel_checks"] = len(checks)
    row["kernel_worst_share"] = max(c["share_of_tolerance"] for c in checks)
    row["kernel_checks_by_entry"] = {
        e: sum(c["entry"] == e for c in checks)
        for e in sorted({c["entry"] for c in checks})}

    # (3) ample capacity against one device, the mesh's tokens fed to both
    ample = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=MESH_AMPLE))
    pre.model.cfg = ample
    one = Model(ample, device=dev, seed=LM_SEED)
    with torch.no_grad():
        same = all(torch.equal(a, b) for a, b in zip(
            pre.model.parameters(), one.parameters()))
    if not same:
        raise AssertionError("the mesh's and one device's weights differ")
    with _DropCount() as drops:
        got, fed = serve()

    def one_pre(batch, max_len):
        return one.prefill(tokens=batch["tokens"], max_len=max_len)

    def one_dec(caches, batch, pos):
        return one.decode_step(caches, tokens=batch["tokens"],
                               cache_pos=pos)
    want, _ = serve(fed, one_pre, one_dec)
    if drops.total:
        raise AssertionError(f"mesh serving at capacity {MESH_AMPLE} "
                             f"dropped {drops.total}")
    gate = lm_gate(cfg)
    shares = [float((a.float() - b.float()).abs().max()
                    / b.float().abs().max()) for a, b in zip(got, want)]
    row["one_device"] = dict(gate=gate, prefill=shares[0],
                             decode_max=max(shares[1:]), shares=shares)
    if max(shares) > gate:
        raise AssertionError(f"mesh serving against one device: logits at "
                             f"{max(shares):.4f} of max|ref| (gate {gate})")
    del pre, dec, one, out, got, want
    torch.cuda.empty_cache()
    return row


def mesh_path(dev) -> dict:
    """Phase 15: (a) `mesh_train`, (b) `mesh_equal`, (c) `mesh_serve`."""
    t0 = time.perf_counter()
    out = {"train": mesh_train(dev)}
    out["equal"] = mesh_equal(dev)
    out["serve"] = mesh_serve(dev)
    out["wall_s"] = time.perf_counter() - t0
    return out


def _log_mesh(m: dict, card: str) -> None:
    t, e, s = m["train"], m["equal"], m["serve"]
    tc, sc = t["collectives_per_step"], s["collectives"]
    kms = {k: round(v, 2) for k, v in t["kernel_ms_per_step"].items()}
    log(f"  (a) {t['arch']} ({t['dtype']}, {t['params']:,} parameters) on a "
        f"{t['mesh'][0]} x {t['mesh'][1]} stacked mesh, batch {t['batch']} x "
        f"{t['seq']} ({t['tokens_a_shard']} tokens a shard) on {card}: step "
        f"{t['step_ms']:.2f} ms (median of steps 2-{t['steps']}; host "
        f"{[round(h['ms'], 2) for h in t['history']]}, device span "
        f"{[round(h['device_span_ms'], 2) for h in t['history']]}; kernels "
        f"a step {kms} ms), "
        f"{t['tokens_per_s']:.0f} tokens/s, peak {t['peak_bytes'] / 1e9:.3f}"
        f" GB; losses {[round(h['loss'], 6) for h in t['history']]}, aux "
        f"{[round(h['aux'], 6) for h in t['history']]}; a step: "
        f"{t['dropped_per_step']:.0f} of {t['assignments_per_step']:,} "
        f"assignments dropped, all-to-all "
        f"{tc['result_bytes']['all-to-all'] / 1e9:.4f} GB and psum "
        f"{tc['result_bytes']['all-reduce'] / 1e9:.4f} GB a device "
        f"({tc['calls']['all-to-all']:.0f} / {tc['calls']['all-reduce']:.0f}"
        f" calls, forward and backward; wire {tc['wire_bytes'] / 1e9:.4f} "
        f"GB); launches {t['launches']}; one more step with "
        f"{t['kernel_checks']} kernel calls against their plain versions "
        f"({t['kernel_checks_by_entry']}), worst "
        f"{t['kernel_worst_share']:.4f} of its gate "
        f"({t['kernel_worst_call']})")
    b = e["bf16"]
    log(f"  (b) at capacity {e['capacity_factor']} (no drops), aux weight 0,"
        f" (1, 4) against (1, 1): float32 twin ({e['layers']} layers, "
        f"{e['batch']} x {e['seq']}) loss {e['loss']:.6f} at "
        f"{e['loss_share']:.4f} of {TRAIN_F32_LOSS}·|ref|, gradients at most"
        f" {e['grad_share_max']:.4f} of {TRAIN_F32_REL}·max|ref| "
        f"({e['grad_share_worst']}); bf16 at {b['layers']} layers, "
        f"{b['batch']} x {b['seq']}: loss {b['loss']:.6f} against "
        f"{b['loss_float32']:.6f} in float32 on one device, "
        f"{b['share']:.4f} of {TRAIN_MOE_FIRST_REL}·|ref|")
    o = s["one_device"]
    log(f"  (c) {s['arch']} at {s['layers']} layers, batch {s['batch']}, a "
        f"{s['prompt']}-token prompt and {s['steps']} decode steps: prefill "
        f"{s['prefill_ms']:.2f} ms (sequence split), decode step "
        f"{s['decode_step_ms']:.2f} ms (median; psum branch), peak "
        f"{s['peak_bytes'] / 1e9:.3f} GB; {s['dropped_prefill']:,} of "
        f"{s['assignments_prefill']:,} prefill assignments dropped; "
        f"all-to-all {sc['result_bytes']['all-to-all'] / 1e9:.4f} GB, psum "
        f"{sc['result_bytes']['all-reduce'] / 1e9:.4f} GB a device; launches"
        f" {s['launches']}; {s['kernel_checks']} kernel calls against their "
        f"plain versions ({s['kernel_checks_by_entry']}), worst "
        f"{s['kernel_worst_share']:.4f} of its gate; at capacity "
        f"{MESH_AMPLE} against one device: prefill logits "
        f"{o['prefill']:.4f}, decode at most {o['decode_max']:.4f} of "
        f"max|ref| (gate {o['gate']}); phase 15 took {m['wall_s']:.1f} s")


def c2_repeats(dev, n: int) -> dict:
    """Phase 5's bf16 prefill_mha stage `n` times in this process, on its
    own inputs (same seed): each repeat calls the kernel and the float32
    plain version again and reads the share of the gate (ATTN_REL·(1+|ref|)
    + 2^-8·|ref|), and whether the kernel's output and the plain version's
    are bit-identical to their first calls. Raises after the last repeat if
    any share passed 1."""
    import torch

    stages = attention_ssm_stages()
    i = next(j for j, s in enumerate(stages) if s["tag"] == "prefill_mha")
    st = stages[i]
    inputs = stage_inputs(st, "bfloat16", dev, SEED + 100 + i)
    call = _kernel_call(st, inputs)
    first = call()
    want0 = _plain_call(st, inputs, lambda t: t.float())
    shares, worst_at, out_same, ref_same = [], [], 0, 0
    for _ in range(n):
        got = call()
        want = _plain_call(st, inputs, lambda t: t.float())
        out_same += bool(torch.equal(got, first))
        ref_same += bool(torch.equal(want, want0))
        w = want.double()
        ratio = (got.double() - w).abs() / (ATTN_REL * (1 + w.abs())
                                           + BF16_ROUND * w.abs())
        share = float(ratio.max().item())
        shares.append(share)
        worst_at.append(tuple(int(x) for x in
                              torch.nonzero(ratio == share)[0]))
        del got, want, w, ratio
    torch.cuda.empty_cache()
    out = dict(repeats=n, shares=shares, worst_at=worst_at,
               kernel_identical=out_same, plain_identical=ref_same,
               tf32=torch.backends.cuda.matmul.allow_tf32)
    log(f"  C2: {n} repeats of prefill_mha/bfloat16 after phases 2-4: "
        f"share of the gate min {min(shares):.6g}, max {max(shares):.6g} "
        f"(first five {[round(s, 6) for s in shares[:5]]}); kernel output "
        f"identical to its first call {out_same}/{n}, plain version "
        f"{ref_same}/{n}; worst elements {sorted(set(worst_at))[:4]}; "
        f"allow_tf32 {out['tf32']}")
    if max(shares) > 1:
        raise AssertionError(f"C2: prefill_mha/bfloat16 beyond its gate in "
                             f"{sum(s > 1 for s in shares)} of {n} repeats")
    return out


def _check_path_launches(path: str, launches: dict, expected: dict) -> None:
    """A path's launches must be its table's totals, and every kernel of
    the path (any that its table expects) must have run."""
    log(f"  kernel launches on the {path}: {launches}")
    want = {k: sum(e.get(k, 0) for e in expected.values()) for k in launches}
    missing = [k for k, v in want.items() if v > 0 and launches[k] <= 0]
    if missing:
        raise AssertionError(f"{path} never launched {missing}")
    if launches != want:
        raise AssertionError(f"{path} launches {launches}, expected {want}")


def _log_paramserve(rows, summary) -> None:
    for r in rows:
        err = r.get("max_abs_err")
        log(f"  {r['stage']}: wall {r['wall_s']:.3f} s, launches "
            f"{ {k: v for k, v in r['launches'].items() if v} }"
            + (f", max |Δ| {err:.3g}" if err is not None else ""))
    peak = summary["decode_peak_bytes"]
    log(f"  decode peak device memory (max_memory_allocated) per step: "
        f"{[f'{b / 1e9:.3f} GB' for b in peak]}")
    log(f"  work ratio at T={DECODE_T}: orchestrated "
        f"{summary['moe_orchestrated_work_ratio']:.4f} (steps 1-"
        f"{DECODE_STEPS - 1}), naive {summary['moe_naive_work_ratio']:.4f} "
        f"(worst step); embedding cache: {summary['embed_hot_rows']} hot "
        f"rows, hit rate {summary['embed_hit_rate']:.4f}")


def _log_train(t: dict, card: str) -> None:
    f = t["float32"]
    log(f"  {t['arch']} ({t['dtype']}, {t['params']:,} parameters), batch "
        f"{t['batch']} x {t['seq']} on {card}: step {t['step_ms']:.2f} ms "
        f"(median of steps 2-{t['steps']}; "
        f"{[round(x, 2) for x in t['step_ms_all']]}), "
        f"{t['tokens_per_s']:.0f} tokens/s; peak "
        f"{t['peak_bytes'] / 1e9:.3f} GB; inside a step ({t['timed_step_ms']:.2f}"
        f" ms) B5 forward {t['attention_ms']['forward']:.3f} ms and backward "
        f"{t['attention_ms']['backward']:.3f} ms over "
        f"{t['attention_calls']['forward']} + "
        f"{t['attention_calls']['backward']} calls (3 backward kernels a "
        "call)")
    log(f"  loss history {[round(h['loss'], 6) for h in t['history']]}; "
        f"grad norms {[round(h['grad_norm'], 6) for h in t['history']]}; "
        f"with the failure: steps {[h['step'] for h in t['history_with_failure']]}"
        f", every loss and grad norm bit-identical to the uninterrupted "
        f"run's; launches {t['launches']} over {t['steps_run']} steps run; "
        f"walls {t['control_wall_s']:.1f} s (uninterrupted) and "
        f"{t['recovery_wall_s']:.1f} s (checkpoints, failure, restore)")
    log(f"  float32 twin ({f['n_layers']} layers, {f['batch']} x {f['seq']}) "
        f"vs float64 on the CPU: launches {f['launches']}; loss "
        f"{f['loss']:.6f} at {f['loss_share']:.4f} of {TRAIN_F32_LOSS}·|ref|"
        f", gradients at most {f['grad_share_max']:.4f} of "
        f"{TRAIN_F32_REL}·max|ref|; phase 14 took {t['wall_s']:.1f} s")


def _log_train_moe(t: dict, card: str) -> None:
    f = t["float32"]
    log(f"  {t['arch']} ({t['dtype']}, {t['params']:,} parameters), batch "
        f"{t['batch']} x {t['seq']} on {card}: step {t['step_ms']:.2f} ms "
        f"(median of steps 2-{t['steps']}; "
        f"{[round(x, 2) for x in t['step_ms_all']]}), "
        f"{t['tokens_per_s']:.0f} tokens/s; peak "
        f"{t['peak_bytes'] / 1e9:.3f} GB; inside a step "
        f"({t['timed_step_ms']:.2f} ms) B4 forward "
        f"{t['gemm_ms']['forward']:.3f} ms and backward "
        f"{t['gemm_ms']['dx'] + t['gemm_ms']['dw']:.3f} ms (dx "
        f"{t['gemm_ms']['dx']:.3f}, dw {t['gemm_ms']['dw']:.3f}) over "
        f"{t['gemm_calls']['forward']} + {t['gemm_calls']['dx']} + "
        f"{t['gemm_calls']['dw']} calls, B5 forward {t['attention_ms']['forward']:.3f} and backward "
        f"{t['attention_ms']['backward']:.3f} ms")
    log(f"  loss history {[round(h['loss'], 6) for h in t['history']]} "
        f"(ln V = {t['ln_vocab']:.4f}; the same weights in float32: "
        f"{t['first_loss_float32']:.6f}, the first loss at "
        f"{t['first_loss_share']:.4f} of {TRAIN_MOE_FIRST_REL}·|ref|); grad "
        f"norms {[round(h['grad_norm'], 6) for h in t['history']]}; launches "
        f"{t['launches']} over {t['steps']} steps; {t['wall_s_steps']:.1f} s "
        "of steps")
    log(f"  float32 twin ({f['n_layers']} layers, {f['batch']} x {f['seq']}) "
        f"vs float64 on the CPU, routing pinned to the card's (the float64 "
        f"routing would move {f['routing_flips']} of {f['tokens_per_layer']}"
        f" tokens a layer): launches {f['launches']}; loss {f['loss']:.6f} "
        f"at {f['loss_share']:.4f} of {TRAIN_F32_LOSS}·|ref|, gradients at "
        f"most {f['grad_share_max']:.4f} of {TRAIN_F32_REL}·max|ref|; the "
        f"granite part took {t['wall_s']:.1f} s")


def _log_train_ssm(t: dict, card: str) -> None:
    f = t["float32"]
    split = ("split not measured" if t["ssd_bwd_split_ms"] is None else
             ", ".join(f"{k} {v:.3f}" for k, v in
                       t["ssd_bwd_split_ms"].items()))
    log(f"  {t['arch']} ({t['dtype']}, {t['params']:,} parameters), batch "
        f"{t['batch']} x {t['seq']} on {card}: step {t['step_ms']:.2f} ms "
        f"(median of steps 2-{t['steps']}; "
        f"{[round(x, 2) for x in t['step_ms_all']]}), "
        f"{t['tokens_per_s']:.0f} tokens/s; peak "
        f"{t['peak_bytes'] / 1e9:.3f} GB; inside a step "
        f"({t['timed_step_ms']:.2f} ms, under the profiler) B7 forward "
        f"{t['ssd_ms']['forward']:.3f} ms and backward "
        f"{t['ssd_ms']['backward']:.3f} ms over {t['ssd_calls']['forward']}"
        f" + {t['ssd_calls']['backward']} calls (device: {split}), B5 "
        f"forward {t['attention_ms']['forward']:.3f} and backward "
        f"{t['attention_ms']['backward']:.3f} ms")
    log(f"  loss history {[round(h['loss'], 6) for h in t['history']]} "
        f"(ln V = {t['ln_vocab']:.4f}; the same weights in float32: "
        f"{t['first_loss_float32']:.6f}, the first loss at "
        f"{t['first_loss_share']:.4f} of {TRAIN_MOE_FIRST_REL}·|ref|); grad "
        f"norms {[round(h['grad_norm'], 6) for h in t['history']]}; launches "
        f"{t['launches']} over {t['steps']} steps; {t['wall_s_steps']:.1f} s "
        "of steps")
    log(f"  float32 twin ({f['n_layers']} layers, {f['batch']} x {f['seq']}) "
        f"vs float64 on the CPU: launches {f['launches']}; loss "
        f"{f['loss']:.6f} at {f['loss_share']:.4f} of {TRAIN_F32_LOSS}·|ref|"
        f", gradients at most {f['grad_share_max']:.4f} of "
        f"{TRAIN_F32_REL}·max|ref|; the zamba2 part took {t['wall_s']:.1f} s")


def parse_args(argv):
    ap = argparse.ArgumentParser(
        description="Smoke run of the PyTorch/CUDA port on one NVIDIA GPU "
        "(phases in the module docstring). With no arguments it runs every "
        "phase and prints the result lines.")
    ap.add_argument("--c2-repeats", type=int, default=0, metavar="N",
                    help="after phase 4, run phase 5's bf16 prefill_mha "
                    "stage N times and read each share of its gate")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if not (SRC / "repro_torch" / "csrc").is_dir():
        print("chip_smoke.py runs from a checkout of the repo: "
              f"{SRC / 'repro_torch'} is missing", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py needs a CUDA device; none is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels
    from repro_torch.kernels import _lib

    t_start, clock = time.perf_counter(), {}

    def phase(msg: str) -> None:  # a phase's header, with the run's clock
        clock[msg.split("]")[0] + "]"] = t = time.perf_counter() - t_start
        log(f"{msg} [{t:.1f} s into the run]")

    card = gpu_name_and_power()
    phase(f"[1/15] environment: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _lib.build()
    log(f"  kernels built from src/repro_torch/csrc in "
        f"{time.perf_counter() - t0:.2f} s (sm_90a)")
    resources = kernel_resources(_lib.build_dir() / "nvcc.log")
    for name, use in resources.items():
        log(f"  {name}: {use}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase("[2/15] kernel parity against the plain PyTorch versions")
    parity_worst = parity_phase(dev)
    bwd_gemm = moe_gemm_bwd_parity(dev)
    parity_worst.update(bwd_gemm["worst"])
    ssd_bwd = ssd_bwd_parity(dev)
    torch.cuda.synchronize()

    phase("[3/15] main path: P=16, 800,000 tasks/stage, 800,000 keys x 16, "
        "backend='torch' vs the numpy oracle")
    kernels.reset_launches()
    stages_out, K, stages, init = main_path("cuda")
    torch.cuda.synchronize()
    launches = kernels.launches()
    _check_path_launches("main path", launches, EXPECTED_LAUNCHES)

    phase("[4/15] parameter-server path: granite-moe-3b-a800m, one MoE layer "
        "(40 experts x 2,359,296 words, top-8) and the 49,155 x 1536 "
        "embedding table, P=8, backend='torch'")
    kernels.reset_launches()
    ps_rows, ps_summary, ps_data = paramserve_path("cuda")
    torch.cuda.synchronize()
    ps_launches = kernels.launches()
    _check_path_launches("parameter-server path", ps_launches, PS_EXPECTED)
    _log_paramserve(ps_rows, ps_summary)
    ps_parity = paramserve_kernel_parity(dev, ps_data)
    ps_summary["kernel_parity"] = ps_parity
    ps_summary.update(paramserve_costs("cuda", ps_data))
    log(f"  T={COST_T} decode steps and every embedding stage: "
        "phase_signature/refcount/exec_site and work ratios equal to the "
        "numpy backend's; bench_paramserve gate on its own mix "
        f"{GATE_MIX}: orchestrated {ps_summary['gate_orchestrated']}, "
        f"naive {ps_summary['gate_naive']}")

    c2 = c2_repeats(dev, args.c2_repeats) if args.c2_repeats else None
    phase("[5/15] attention and SSM path: zamba2-1.2b (Mamba2 scan, shared "
        "MHA prefill and long_500k decode), command-r-35b (GQA prefill, hd "
        "128), tinyllama-1.1b (GQA decode_32k), float32 and bf16")
    kernels.reset_launches()
    attn_rows = attention_ssm_path(dev)
    torch.cuda.synchronize()
    attn_launches = kernels.launches()
    _check_path_launches("attention and SSM path", attn_launches,
                         ATTN_EXPECTED)
    errors = {k: max([parity_worst[k]] + [r["max_abs_err"] for r in attn_rows
                                          if r["launches"][k]])
              for k in KERNEL_SOURCES}

    phase("[6/15] kernel times at the paths' shapes")
    rows = timing_phase(dev, K, stages, init, launches, ps_data,
                        ps_launches)
    rows.append(moe_gemm_timing(dev, ps_data, ps_launches["moe_gemm"]))
    for r in rows:  # the worst error of either path's parity check
        r["max_abs_err"] = max(r["max_abs_err"], ps_parity.get(r["name"], 0))
    for s in rows[-1]["shapes"]:
        lib = (f"{s['library_ms']:.4f}" if s["library_ms"] is not None
               else f"null: {s['library_note']}")
        log(f"  moe_gemm: {s['ms']:.4f} ms (plain {s['plain_ms']:.4f}, "
            f"library {lib}, loop of matmuls {s['matmul_loop_ms']:.4f}, "
            f"bound {s['bound_ms']:.4f} by {s['bound_by']}; "
            f"{s['bound_fma_ms']:.4f} in FMAs) at {s['shape']}")
    rows.append(moe_gemm_bf16_timing(dev))
    rows[-1]["max_abs_err"] = max(rows[-1]["max_abs_err"],
                                  parity_worst["moe_gemm_sm90"])
    for s in rows[-1]["shapes"]:
        lib = (f"{s['library_ms']:.4f}" if s["library_ms"] is not None
               else f"null: {s['library_note']}")
        events = (", ".join(f"{k} {v:.4f}" for k, v in
                            s["device_events"].items())
                  or "CUDA events, the calls queued behind a spin")
        log(f"  moe_gemm_sm90: call {s['ms']:.4f} ms (host "
            f"{s['host_ms']:.4f}), device {s['device_ms']:.4f} ms "
            f"({events}), plain {s['plain_ms']:.4f}, torch._grouped_mm "
            f"{lib}, bound {s['bound_ms']:.4f} by {s['bound_by']}; "
            f"{s['share_of_gate']:.4f} of the gate; moe_gemm_bf16 (gg_bf16) "
            f"{s['bf16_route']['ms']:.4f} ms, "
            f"{s['bf16_route']['share_of_gate']:.4f} of the gate; at "
            f"{s['shape']}")
    rows += attention_ssm_timing(dev, attn_launches, errors)
    log("  row 5c: B5's backward")
    rows += attention_bwd_timing(dev, parity_worst)
    log("  row 4d: B4's backward")
    rows += moe_gemm_bwd_timing(dev, parity_worst)
    log("  row 7b: B7's backward")
    rows.append(ssd_bwd_timing(dev, ssd_bwd["worst"]))
    for r in rows:
        if not all(np.isfinite(r[k]) for k in ("ms", "plain_ms", "bound_ms")):
            raise AssertionError(f"{r['name']}: non-finite timing")

    phase("[7/15] device busy share of a stage (torch.profiler)")
    busy = busy_phase(K, stages, init)

    phase(f"[8/15] engines and plans: stages (a)-(c) at {ENGINES_TPM:,} "
          "tasks a machine under engine='pull', 'push', 'sort', 'auto'; "
          "bench_plan's pagerank_stages and bfs_stages through run_plan "
          "and the run_stage loop")
    kernels.reset_launches()
    engine_rows, engine_expected = engines_path("cuda", ENGINES_TPM)
    plan_rows, plan_expected = plans_path("cuda")
    torch.cuda.synchronize()
    _check_path_launches("engines and plans path", kernels.launches(),
                         {**engine_expected, **plan_expected})

    phase(f"[9/15] TDO-GP: Erdős-Rényi and star graphs of 2^{GRAPH_SCALE} "
        f"vertices, Barabási-Albert of {GRAPH_BA_N}, P={GRAPH_P}; BFS, SSSP, "
        "CC, PageRank, BC, backend='torch' vs the numpy oracle")
    kernels.reset_launches()
    graph_rows, graph_expected, root_call = graph_path("cuda")
    torch.cuda.synchronize()
    graph_launches = kernels.launches()
    _check_path_launches("graph path", graph_launches, graph_expected)
    log("  phase 6, row 1e: K1 at the Erdős-Rényi ingest's root call")
    rows[0]["shapes"].append(ingest_histogram_timing(
        dev, root_call, graph_launches["histogram"]))

    phase("[10/15] KV store and serve tier: DistributedHashTable(800,000, "
        "16, value_width=16) one-shot (YCSB A/B, multi_get, run_chain), "
        "streamed in sync and thread mode, and the MoE / embedding front "
        "doors at granite-moe-3b-a800m's widths")
    kernels.reset_launches()
    serve_rows, serve_summary, serve_expected = serve_path("cuda", ps_data)
    torch.cuda.synchronize()
    _check_path_launches("serving path", kernels.launches(), serve_expected)

    phase("[11/15] elasticity at the main path's size: recovery (restart with "
        "durable snapshots, shrink), work stealing, bench_elastic's "
        "migration arms over 800,000 keys, a mid-plan kill in run_chain and "
        "the serve tier's elastic counters, backend='torch' vs numpy")
    kernels.reset_launches()
    el_rows, el_summary, el_expected = elastic_path("cuda", K, stages, init)
    torch.cuda.synchronize()
    _check_path_launches("elastic path", kernels.launches(), el_expected)

    phase("[12/15] multi-device execution: backend='torch_spmd' on the "
        "stacked mesh (one shard a machine) — phase 3's stages at P=16, the "
        "chaos scenario, the MoE dispatch at granite's widths (ep 8), "
        "embed_skew_aware on 8 shards, the group mesh of 4 gloo ranks, "
        "bench_spmd's YCSB cells")
    kernels.reset_launches()
    sp_rows, sp_summary, sp_expected = spmd_path("cuda", K, stages, init,
                                                 ps_data)
    torch.cuda.synchronize()
    _check_path_launches("sharded path", kernels.launches(), sp_expected)

    phase(f"[13/15] language-model serving: {', '.join(LM_ARCHS)} at full "
        f"width and depth in bf16 (random weights), batch {LM_BATCH}, a "
        f"{LM_PROMPT}-token prompt, {LM_GEN} tokens generated greedily; "
        "every kernel call against its plain version, cache consistency "
        "with planted faults, float32 against float64, the scan's final "
        "state")
    t0 = time.perf_counter()
    lm = lm_path(dev)
    lm["wall_s"] = time.perf_counter() - t0
    log(f"  phase 13 took {lm['wall_s']:.1f} s")
    for r in rows:  # the model path's launches, times and worst errors
        n = sum(s["launches"].get(r["name"], 0) for s in lm["serve"])
        if not n:
            continue
        r["launches_model_path"] = n
        r["model_path_ms"] = {s["arch"]: {
            k: v for k, v in s["kernel_ms"].items()
            if k.startswith(r["name"] + " ")} for s in lm["serve"]}
        entry = next(e for e, (_, _, fam) in _LM_ENTRIES.items()
                     if r["name"] == launched_kernel(fam, "bfloat16"))
        r["max_abs_err"] = max([r["max_abs_err"]] + [
            k["max_abs_err"] for s in lm["serve"] for k in s["kernel_checks"]
            if k["call"].startswith(entry + " ")])
        if r["name"] == "moe_gemm_sm90":  # its main path is the model's
            r["launches"] = n
    phase(f"[14/15] training: {TRAIN_ARCH} at full width and depth in bf16 "
          f"(random weights), batch {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
          f"{TRAIN_STEPS} steps of Trainer with int8 gradient compression, a "
          f"checkpoint every {TRAIN_CKPT_EVERY} steps and a failure at step "
          f"{min(TRAIN_FAILURE)}; {TRAIN_MOE_ARCH} at full width and depth "
          f"in bf16, batch {TRAIN_MOE_BATCH} x {TRAIN_MOE_SEQ}, "
          f"{TRAIN_MOE_STEPS} steps; {TRAIN_SSM_ARCH} at full width and "
          f"depth in bf16, batch {TRAIN_SSM_BATCH} x {TRAIN_SSM_SEQ}, "
          f"{TRAIN_SSM_STEPS} steps; each float32 twin against float64")
    t0 = time.perf_counter()
    train = train_path(dev)
    train["wall_s"] = time.perf_counter() - t0
    _log_train(train, card)
    t0 = time.perf_counter()
    train_moe = train_moe_path(dev)
    train_moe["wall_s"] = time.perf_counter() - t0
    _log_train_moe(train_moe, card)
    t0 = time.perf_counter()
    train_ssm = train_ssm_path(dev)
    train_ssm["wall_s"] = time.perf_counter() - t0
    _log_train_ssm(train_ssm, card)
    for r in rows:  # B5's and B4's backward: launches on the training path
        if r["name"] == bwd_counter("bfloat16"):
            r["launches"] = train["launches"][r["name"]]
        elif r["name"] == bwd_counter("float32"):
            r["launches"] = train["float32"]["launches"][r["name"]]
        elif r["name"] in (dx_counter("bfloat16"), dw_counter("bfloat16")):
            r["launches"] = train_moe["launches"][r["name"]]
        elif r["name"] in (dx_counter("float32"), dw_counter("float32")):
            r["launches"] = train_moe["float32"]["launches"][r["name"]]
        elif r["name"] == "mamba_scan_bwd":
            r["launches"] = train_ssm["launches"][r["name"]]
    missing = [r["name"] for r in rows if not r["launches"]]
    if missing:
        raise AssertionError(f"kernels never launched on their main path: "
                             f"{missing}")

    phase(f"[15/15] model-level mesh: launch.steps.build_step on a "
          f"{MESH[0]} x {MESH[1]} stacked mesh (launch.mesh.make_host_mesh),"
          f" bf16: {TRAIN_MOE_ARCH} trained at full width and depth, batch "
          f"{MESH_TRAIN_BATCH} x {MESH_TRAIN_SEQ}, {MESH_TRAIN_STEPS} steps "
          f"(the MoE layers' sequence split); the mesh against one device "
          f"at capacity {MESH_AMPLE}; {MESH_SERVE_ARCH} at "
          f"{LM_CHECK_LAYERS['moe']} layers, a {LM_BATCH} x {LM_PROMPT} "
          f"prefill and {MESH_SERVE_STEPS} decode steps (the psum branch), "
          "every kernel call against its plain version")
    mesh = mesh_path(dev)
    _log_mesh(mesh, card)
    for r in rows:  # the mesh path's launches (training and serving)
        n = sum(mesh[k]["launches"].get(r["name"], 0)
                for k in ("train", "serve"))
        if n:
            r["launches_mesh_path"] = n

    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(
        {"card": card, "stages": stages_out, "kernels": rows,
         "device_busy": busy, "paramserve": {"stages": ps_rows,
                                             **ps_summary},
         "attention_ssm": {"stages": attn_rows, "resources": resources},
         "engines": engine_rows, "plans": plan_rows, "graph": graph_rows,
         "serve": {"stages": serve_rows, **serve_summary},
         "elastic": {"stages": el_rows, **el_summary},
         "spmd": {"stages": sp_rows, **sp_summary}, "lm": lm,
         "train": train, "train_moe": train_moe, "train_ssm": train_ssm,
         "mesh": mesh,
         "moe_gemm_bwd_parity": {k: bwd_gemm[k]
                                 for k in ("shares", "bulk", "splits")},
         "ssd_bwd_parity": {k: ssd_bwd[k]
                            for k in ("shares", "bulk", "routes")},
         "c2": c2,
         "phase_start_s": clock,
         "wall_s": time.perf_counter() - t_start},
        indent=1, default=str))

    log(gpu_name_and_power())
    log(json.dumps({"kernels": [{k: r[k] for k in (
        "name", "route", "source", "replaces", "launches", "max_abs_err",
        "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        for r in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
