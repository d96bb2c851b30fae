#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path on one CUDA card and check it.

    python3 chip_smoke.py        # from the root of a checkout

Phases, each printed as one JSON line; any failed check raises and the
script exits non-zero without the final line:

1. every kernel of the slices (rows 1-11 of the TPU kernel table in
   PERF.md) against its plain PyTorch version on the card: the level-1
   kernels at n = 2**26 float32, at the ragged n = 2**26 - 37, in
   bfloat16 for axpy and dot, the iamax first-occurrence rule on ties
   across the window walk's programs, across one program's steps and
   across lanes, and every level-1 body at the walk's edges (n = 1,
   one step of BLOCK +- 1, one wave of programs times BLOCK +- 1);
   gemv, gemvt and symv (CUDA C++, built with nvcc from
   src/repro_torch/csrc at first use) at 16384 x 16384 float32, at the
   ragged 16381 x 16379 (16381**2 for symv), gemv and symv in bfloat16,
   symv at orders around its 64-row tiles (1 to 129, and 4099), each
   symv case on the route it must take (16384**2 by TMA, 16381**2 by
   ldg), gemv and gemvt on a GMRES basis of shape (31, 2**20) and on
   that basis at an odd offset, gemvt in bfloat16, gemv on GMRES(20)'s
   (21, 16384) basis, each gemv and gemvt case on the route it must
   take (gemvt: 16384**2, bfloat16 and the basis by TMA, 16379 columns
   and the offset view by ldg; gemv: the square and ragged matrices one
   warp per row, the bases by the band kernel's TMA route, the offset
   view by ldg) in one launch with no combine and bitwise from call to
   call, and symv on a copy of A whose upper
   triangle is NaN; each anchored group kind (gemv, gemvt and symv
   anchor) against its plain splice and float64, bitwise from call to
   call, the gemv anchor also on the non-symmetric ragged 16381 x 16379
   matrix, the gemvt anchor also on the offset basis and the symv
   anchor also at the ragged 16381**2, the symv and gemvt anchors'
   products (csrc/symv.cu, csrc/gemv.cu) each on the route it must
   take, and the symv anchor on a NaN upper triangle on both routes;
   gemm (CUDA C++) at
   block-CG's (16384**2) . (16384 x 32) float32 (its TMA route), at the
   ragged non-symmetric (16381 x 16379) . (16379 x 29) (its ldg route:
   rows of 65516 bytes), and at 4096**3 where the operations bound it;
   its 16-bit wgmma route (tensor cores) at block-CG's shape in
   bfloat16, at 4096**3 in bfloat16 and float16, and at llama3-8b's
   dense shapes in bfloat16 (GEMM16_SHAPES: the prefill's gate/up and
   down products over 14248 tokens, a decode step's gate/up product and
   the LM head at M = 8), each case on the route it must take, against
   its plain version and float64; each tiled group kind (gemm ->
   coldot of BLOCK_CG_MATVEC, BLOCK_RESIDUAL's gemm(-1, 1) -> coldot,
   and a gemm -> colaxpy -> coldot epilogue) at the aligned and a ragged
   non-symmetric shape, against its plain splice and float64; transpose
   and ger (CUDA C++) on a non-symmetric 16384 x 16384 float32 A, the
   ragged 16381 x 16379, in bfloat16 and at GMRES's (20, 21);
2. the main path, with every launch counter set to 0 just before each
   part and read just after: `Program.from_spec(AXPYDOT_SPEC)` in the
   dataflow, nodataflow and reference modes, the wider generated group
   waxpby -> scal -> {dot, nrm2, iamax}, and the public `ops` entry
   points, all at n = 2**26; then the Krylov matvec programs CG_MATVEC,
   RESIDUAL, BICG_MATVEC2, POWER_STEP, GMRES_ORTH and SYMV_DOT in all
   three modes, one anchored launch each in dataflow (SYMV_DOT's and
   GMRES_ORTH's products by TMA, counted under the anchored generator),
   and the level-2
   `ops` entry points (gemv, gemvt, symv, gesummv, atax, bicgk) at
   n = 16384; then the loop path: `LoopProgram(BLOCK_CG_LOOP)` on a
   dense SPD float32 A of n = 16384 (κ ≈ 100) with s = 32 unit-norm
   right-hand sides, in all three modes (one tiled launch per dataflow
   iteration that the host issues plus one for the setup's
   BLOCK_RESIDUAL, gemm launches only in nodataflow; the loop's CUDA
   graph replays the other iterations, so a first solve issues two,
   its eager first iteration and the capture; in the timed solves of phase 4, every product of
   both on the TMA route), the CG_LOOP yardstick on each column, and one
   BICGSTAB_LOOP solve, whose cond stage runs on the card; then
   `batched`: `LoopProgram(CG_LOOP).batched` and
   `blas.compile(CG_LOOP).batched` over the 32 columns as lanes, every
   lane's x, iterations, status and history bitwise its column's solve
   above with the same launches, their ms beside the 32 solves' ms,
   `CG(device="cuda").solve_batched` on 4 columns bitwise the class's
   own solves, and a batch of 4 with a NaN in lane 1 (NONFINITE within
   one iteration, the other lanes bitwise their solves); then
   `distributed`: NCCL, rank 0, world 1, a file store
   under build/, `launch.mesh.make_host_mesh()` on the card, the
   communicators' set-up timed apart; paxpy, pdot and paxpydot at
   n = 2**26, pgemv at 16384**2, pgemm in both strategies at (16384**2)
   . (16384 x 32), `distribute_program` of AXPYDOT and the TP and EP
   MoE variants at deepseek-moe-16b's layer widths (4 x 512 tokens,
   bfloat16), each bitwise its single-card call with the same launches,
   both timed; a card host has one card, so only a world of one runs
   here, and the process group is destroyed after; then the
   one-routine GER_SPEC and TRANSPOSE_SPEC programs at 16384 x 16384 in
   all three modes (one ger or transpose launch outside reference mode),
   and `LoopProgram(GMRES_LOOP)` as shipped (m = 20, rtol 1e-6, at most
   50 restarts) on a dense non-symmetric float32 A = 1.25 I + G/sqrt(n),
   n = 16384, in all three modes, with every kernel's launch count
   checked against the restart count (the orthogonalisation's gemvt
   products and launches all by TMA, the basis projections' gemv
   launches by the band kernel's TMA route and the square matvecs' one
   warp per row; no gemvt or gemv combine anywhere on the main path,
   and every reducing level-1 pass one launch that folds its partials);
   then the public API and the class-based solvers: every registry
   routine as `blas.<name>` in dataflow and nodataflow (`api_routines`:
   vectors of 2**26, matrices of 16384**2, gemm at 16384**2 . (16384 x
   32)), bitwise equal to `Program.from_spec(routine_spec(name))` and
   within its kernel's bound of reference mode, one launch for each
   routine with a kernel and none for the others; AXPYDOT built with the
   fluent builder through `blas.compile` (`api_builder`: AXPYDOT_SPEC's
   digest, its program's bits); `blas.cg`, `bicgstab`, `gmres` and
   `block_cg` on the systems above, each bitwise equal to its
   LoopProgram run with the same iterations and status, `blas.jacobi`
   on S + 2 diag(sum_j |S_ij|) and `blas.power_iteration` on the SPD A
   (`api_solvers`); and the classes CG, BiCGStab, Jacobi and
   PowerIteration in dataflow and nodataflow (`class_solvers`: the loop
   spec's iterations, x within rtol 1e-5 of it and whether bitwise, the
   float64 true residual, solve and per-iteration times beside the loop
   spec's; PowerIteration against `blas.power_iteration`, which wraps
   the same class);
   then robust solves (`chaos`): the 25-cell chaos drill of
   `python -m repro_torch.guard --chaos-smoke` on the card in dataflow
   mode (5 solvers x nan/inf/bitflip/scale faults and 3 scale-0
   breakdown cells at n = 24, each detected within 2 iterations of the
   injection and recovered through `blas.solve`, and 2 tuning-store
   quarantine cells); at n = 16384, float32, on the systems above, a nan
   plan at iteration 3 on CG and block-CG (s = 32) and at restart 1 on
   GMRES(20), a bitflip plan on CG and a scale-0 plan on block-CG (which
   must give BREAKDOWN), each detected within 2 iterations and recovered
   by `blas.solve(..., fault=plan)` (attempt log and true residual
   printed), and a ladder that ends on the float64 rung (Jacobi for 3
   iterations, then `torch.linalg.solve_ex` on the card, its ms); then
   `obs`: one CG solve at n = 16384 with `repro_torch.obs` recording,
   bitwise equal to the same solve with recording off, its
   `solver.result` event and `kernel.group` spans, the per-iteration
   event and host ms with recording off and on (off, on, on, off), the
   recorded time split into the group spans by program and the rest of
   the loop, and a program call captured into a CUDA graph while
   recording, which must take no span;
   then the serve path (rows 14-15
   of the table): first mha and decode_attention (CUDA C++) against
   their plain versions at ragged shapes (Sq 33, Skv 70, and the
   multi-tile Sq 300, Skv 333 and Sq = Skv = 1781; a cache of 1500 with
   per-row lengths 0, 1, 70 and 1500, and lengths 0, 1, 63, 64, 65,
   1500 and 1507), GQA 1:1, 4:1 and 5:1, causal or not, windows 8, 32
   and 64, D 64 and 128, in float32 (the FFMA and SIMT routes) and
   bfloat16 (the wgmma and mma routes), and mha with v at a width of its
   own, (d, dv) = (96, 64) and (120, 120) in bfloat16 (wgmma, the heads
   padded to 128 columns by TMA's zero fill) and (96, 64) in float32
   (FFMA); then `ServeEngine.generate` on
   llama3-8b at full width and
   depth in bfloat16 with random weights from a seeded generator: 8
   requests of lengths `default_rng(0).integers(256, 2049, 8)`,
   left-padded by `pad_and_batch`, 32 greedy tokens, one mha launch per
   layer in the prefill (all on the wgmma route) and one
   decode_attention launch per layer and step (all on the mma route);
   its prefill logits and 4 decode steps fed its own tokens against
   the same model with the plain attention versions, its greedy tokens
   against that plain run's, its times; then the same model inside
   `use_gemm_kernel()` (every dense projection through the port's gemm,
   as the reference's `use_pallas(True)` runs its Pallas gemm):
   `ServeEngine.generate` with 225 gemm launches a pass (7 a layer and
   the LM head), all on the wgmma route, the prefill and 4 decode steps
   fed the default run's tokens each counted on its own, their logits
   within SERVE_REL_RMS of the default (torch.matmul) run's, the greedy
   tokens against the default run's above its top-1/top-2 margin, and
   prefill ms, decode ms a step and host issue a step beside the default
   run's and the bounds (the dense products' operations; the weights'
   bytes); and both attention kernels at the serve shapes; then
   sliding-window and MoE serving (phase 2f), each config
   at full width in bfloat16 with random weights from the seed, freed
   before the next: mixtral-8x22b cut to 4 of its 56 layers (about 21 GB
   of weights; window 4096, 8 experts top-2), 4 requests of 4200-6144
   tokens; deepseek-moe-16b whole (28 layers, its first dense; 64
   routed experts top-6 and 2 shared), 8 requests of 256-2048;
   h2o-danube-3-4b whole (24 layers, window 4096, D 120), 8 requests of
   1024-4080 with one of exactly 4080, so that decode crosses W = 4096
   at step 16 and overwrites slot 0. For each: mha with the config's
   window at its prefill shape and decode_attention over its ring's
   view (lengths W and below) against their plain versions, timed
   beside their bounds (decode_attention and its SDPA yardstick also in
   a CUDA graph); `ServeEngine.generate` with 32 greedy tokens,
   one mha launch per layer in the prefill and one decode_attention
   launch per layer and step, all on the routes the head dim gives (D
   128: wgmma and mma; D 120: wgmma and mma); the prefill logits and 4
   teacher-forced steps against plain attention, its greedy tokens
   against that plain run's, the tokens' top-k expert sets that the
   plain run would choose otherwise (per layer), the (token, expert)
   pairs dropped by the capacity, and prefill ms, decode ms per step
   and its host issue beside the operations and bytes bounds; then MLA
   and embedding inputs (phase 2g), each config likewise: minicpm3-4b
   whole (62 layers, MLA: q and k heads of 96, v of 64, a latent cache
   of 256 + 32 a position) through `ServeEngine.generate`, 8 requests
   of 256-2048 tokens, one mha launch per layer in the prefill, all on
   the wgmma route, and no decode_attention launch (the absorbed decode
   is torch ops, as the reference's is plain einsum); musicgen-medium
   whole (48 layers, D 64) on 8 sequences of 256-2048 seeded frame
   embeddings and llava-next-34b cut to 16 of its 60 layers (its 67.9 GB
   would leave no room for the plain run; 16 are 18.8 GB) on 4 of
   2304-3200 seeded patch embeddings, each left-padded with zero
   vectors, through `prefill` and 31 `decode_step`s fed seeded (B, d)
   embeddings: one mha launch per layer (wgmma) and one decode_attention
   launch per layer and step (mma). mha at each prefill shape (and
   decode_attention at each decode shape) timed beside its bound (2 (d
   + dv) FLOPs per visible pair) and SDPA, with the backend SDPA takes;
   the logits against plain attention (minicpm: prefill and 4 steps fed
   the engine's tokens; the embedding configs: all 32 passes, fed the
   same embeddings), the greedy tokens (or each pass's argmax) against
   the plain run's, times beside the bounds, and the phase's seconds;
   then SSM, xLSTM and hybrid serving (phase 2h): first `ssd_chunked`
   against `ssd_sequential` at hymba's SSD heads (H 8, P 400, N 16) and
   `mlstm_chunked` against `mlstm_sequential` at xlstm's mLSTM heads (H
   4, D 384), float32 on the card at B 2, S 512 (TF32 asserted off);
   then hymba-1.5b whole (32 hybrid layers: windowed GQA, 25 heads on 5,
   D 64, W 1024, beside Mamba-2 SSD heads) and xlstm-125m whole (9 mLSTM
   and 3 sLSTM layers), each 8 requests of 256-2048 tokens through
   `ServeEngine.generate` with 32 greedy tokens. hymba: mha at its
   prefill layer with the window and decode_attention over its ring's
   view (full, and lengths under W) against their plain versions, timed
   beside their bounds and SDPA's band and key-mask calls; one mha
   launch per layer in the prefill (wgmma) and one decode_attention
   launch per layer and step (mma); the prefill logits and 4
   teacher-forced steps against plain attention, the greedy tokens
   above the margin. xlstm: no attention kernel launches at all;
   `prefill` on S - 1 tokens and `decode_step`s (the recurrent forms)
   against `forward_logits` (the chunked forms) at S - 1 and 4 positions
   past it. For each, prefill ms and decode ms per step beside their
   bounds (prefill: the dense products, the band's attention, the scans'
   products and the last token's unembedding at 989 TFLOP/s, and with
   the float32 scans at 67; a step: every weight, the states and conv
   windows read and written, the ring rows in reach, at 3.35 TB/s, all
   counted from the model's own tensors), the host issue per step and
   the phase's seconds;
3. bitwise repeatability of the dataflow axpydot, of dot, nrm2 and
   asum (three calls each, at 2**26 and ragged), of CG_MATVEC in
   dataflow and nodataflow, and of the dataflow block-CG and GMRES
   solves;
4. times from CUDA events (warm-up, then many launches over operands
   larger than the 50 MB L2) beside each kernel's bound, its plain
   version and the one PyTorch call that computes the same function;
   for the two attention kernels, gemm and the tiled group also the
   function's TFLOP/s and GB/s at that time, `graph_ms`: the same calls
   replayed from a CUDA graph, with no host issue between them, and
   `host_ms`: the host's time to issue one call (each for the library
   call too, as `library_graph_ms` and `library_host_ms`); for gemvt
   (both shapes, beside addmv), gemv (16384**2, (31, 2**20) and
   (21, 16384), beside addmv) and the anchored groups (the gemv, gemvt
   and symv anchors) `graph_ms` and `host_ms` twice each; the kernels
   with routes also carry their main path's launches per route; gemm
   at 4096**3 beside torch.addmm on a line of its own; gemm's 16-bit
   cases of phase 1 each on a line of its own (route, event, graph and
   host ms, the plain version, the bound at 989 TFLOP/s or 3.35 TB/s,
   torch.addmm with cuBLAS's reduced-precision reductions off, and the
   FFMA route forced for that case alone), the prefill's gate/up
   product also as the `gemm (wgmma)` row of the kernels line; the host issue
   ms per call of `blas.axpy` and `blas.dot` beside a direct call of the
   same program (`api_host`, recorded, not a gate); the SM clock and
   power draw sampled by nvidia-smi every 200 ms through this phase.
5. the static analyzer and the autotuner, over the run's own tuning
   table (REPRO_TORCH_CACHE_DIR points at a fresh temporary directory
   before anything compiles, so "auto", the default, starts cold):
   `verify`: the card's per-block shared memory as the runtime reads
   it (the analyzer's RV401 budget must equal it), every shipped spec
   clean with `verify.analyze`'s host ms, cold `blas.compile` ms of
   CG_MATVEC and GMRES_LOOP with the analyzer and without in turns,
   every CUDA kernel's footprint (kernels/*.py, the figure RV401 and
   the tuner price) at or above what the compiled kernel requests
   (static bytes from cudaFuncGetAttributes plus its launch's dynamic
   bytes, `repro_<stem>_smem`), and AXPYDOT, CG_MATVEC and
   BLOCK_CG_MATVEC bitwise equal under "default" and a cold "auto";
   `tune`: `Executable.tune` (TUNE_BUDGET measurements a site) of
   AXPYDOT, CG_MATVEC, SYMV_DOT, GMRES_ORTH, BLOCK_CG_MATVEC and
   `blas.gemv` at (21, 16384) and 16384^2: the candidates measured, the
   winners, the default's and the winner's event ms in turns (default,
   winner, winner, default) and graph ms, the winner against its plain
   version within the kernel's tolerance (as in phase 2) and against
   itself bitwise; a subprocess that recompiles each with "auto" takes
   the artifact (one `tune.cache.hit`, no miss, no `tune.measure`, the
   same plan); CG_LOOP and BLOCK_CG_LOOP at n = 16384 under the tuned
   plans and the default ones (CONVERGED, true residual within the
   bound of phase 2, solve ms in turns); every Triton kernel compiled
   so far, default and tuned plans, at or under its footprint
   (`metadata.shared`); `profile`: `Executable.profile` of AXPYDOT,
   CG_MATVEC and CG_LOOP, modeled roofline against measured per group;
6. last, training (phase 2i, after every earlier phase has returned and
   its operands are freed, so that the step has the card's memory to
   itself): the attention gradient through
   `MhaFunction` (the mha kernel forward, the torch-ops backward
   `mha_backward_plain`) at three layers' shapes, B 1, S 4096, bf16,
   causal (llama3-8b's 32 on 8 heads at D 128; hymba-1.5b's 25 on 5 at
   D 64, window 1024; minicpm3-4b's MLA 40 heads, d 96, dv 64), dq, dk
   and dv against autograd through the out-of-place float32 reference
   (`kernels/attention.attention_reference`), one mha launch a
   forward and backward, its ms beside the plain forward and backward,
   SDPA's forward and backward and the bound (3.5 times the forward's
   2 (d + dv) operations a visible pair, at 989 TFLOP/s); llama3-8b at
   full width cut to TRAIN_LAYERS of its 32 layers (bf16 parameters,
   float32 moments, remat), B TRAIN_BATCH x S TRAIN_SEQ from
   `SyntheticLM`, one warm-up and TRAIN_STEPS timed steps through
   `make_train_step`: per step the loss, event ms, host issue ms, the
   forward-backward and optimizer ms (events around `AdamW.update`),
   tokens/s, peak memory and mha launches (2 a layer: the forward and
   remat's recompute), beside the bound (the dense products and the
   attention at 989 TFLOP/s, then the optimizer's 22 bytes a bf16
   parameter at 3.35 TB/s), finite and falling losses, and a teacher
   check on one B 1, S TEACHER_SEQ batch (the loss and the gradients
   of layer 0's wq and wo and the last layer's w_down against the same
   step with the float32 reference attention in place of the kernel);
   a restart: `train_loop` on llama3-8b reduced for 2 RESTART_K steps,
   and the same run resumed from its step RESTART_K checkpoint
   (restored_from, steps_run, its losses against the whole run's), a
   bfloat16 train state saved and restored bitwise with the next step's
   loss bitwise; and `python -m repro_torch.launch.train --arch
   llama3-8b --reduced --steps 20` in a subprocess, on the card with no
   --device; the phase's seconds.
7. then the sharded step (phase 2j, once 2i's operands are freed) in an
   NCCL world of one: llama3-8b at full width cut to SHARD_LAYERS
   layers, B SHARD_BATCH x S SHARD_SEQ from `SyntheticLM`, SHARD_STEPS
   steps from one seed through `make_train_step`, unsharded, then under
   `partition.use_mesh` on a ("data", "model") (1, 1) and a ("pod",
   "data", "model") (1, 1, 1) mesh in both styles with `grad_specs`,
   then unsharded again; deterministic algorithms on for the phase (the
   embedding's backward without atomics), so that each sharded run's
   losses, parameters and both moments must be bitwise the first
   unsharded run's, as the second's must; every step's event ms and mha
   launches (2 a layer); then an unsharded state and one on the (1, 1)
   mesh stepped in turns (unsharded, sharded, sharded, unsharded)
   SHARD_ROUNDS times with the SM clock sampled, the sharded steps'
   median beside the unsharded ones' (the mesh machinery's own cost in
   a world of one);
   and the bytes each rank's gathers and gradient sums would move in
   one step of llama3-8b, mixtral-8x22b and deepseek-moe-16b at full
   depth on the 16 x 16 and 2 x 16 x 16 production meshes, reckoned
   from the step's own plan of each parameter (`train.step_traffic`),
   not measured: one card runs no multi-rank collective; the phase's
   seconds.
8. then prefill and decode on a mesh and the launch tools (phase 2k):
   decode_attention with `return_lse=True` against its plain
   version on both routes, one split and several, rows of length 0, at
   llama3-8b's, h2o-danube-3-4b's and hymba-1.5b's decode shapes and in
   float32
   (|lse - plain| <= LSE_TOL max(1, |plain|), -inf and a zero output
   where a row has no key, the output bitwise the call's without lse;
   the `decode_attention (lse)` row of the kernels line, timed at
   llama3-8b's step, with h2o-danube-3-4b's ring step beside it, graph
   ms included); in an NCCL world of one, llama3-8b whole and
   SERVE_SHARD_ARCHS cut to SERVE_SHARD_LAYERS layers, B SERVE_BATCH,
   the phase-2c prompts, prefill and SERVE_SHARD_STEPS greedy steps
   unsharded, then on (1, 1) and (1, 1, 1) meshes (`shard_model`):
   logits and caches bitwise the unsharded run's, one mha launch a
   layer a prefill, one decode_attention launch a layer a step (none
   under MLA), each an lse launch on the meshes; llama3-8b's step whole
   and on the (1, 1) mesh in turns (SERVE_SHARD_ROUNDS rounds of whole,
   mesh, mesh, whole), the medians' ratio, then STEPS_A_TURN steps of
   each under cProfile and torch.profiler (`host_split`: the port's
   functions' ms a step, the ops' count, the card's kernel ms), the
   functions whose cumulative ms differ most; `launch.cost.count` of
   llama3-8b's prefill and one decode step on the (1, 1) mesh and of
   phase 2j's train step, each on the card and on meta stand-ins of the
   mesh (`launch.specs`): flops, HBM bytes and collective bytes equal,
   the roofline's terms beside the call's measured ms and
   `torch.cuda.max_memory_allocated` beside the counted peak (for
   information); last, `python -m repro_torch.launch.dryrun --all
   --both-meshes` in a subprocess (a process a core of the host, after
   the timed calls: its cells ok, skipped and failed, 0 failed, and its
   seconds); the phase's seconds.

After the build, a `ptxas` line gives every CUDA kernel's registers and
spill bytes (`nvcc -Xptxas -v`); a spill in csrc/gemm.cu or
csrc/symv.cu fails the run.

Then the `kernels` line, the card's name and power limit, and the
`{"ok": true, ...}` line. Tolerances:
* float32 reductions: |got - want| <= 1e-5 * sum|terms| (another
  summation order), with `want` also computed in float64;
* element-wise float32: 1e-6 of the operands' scale (a fused
  multiply-add may round once where the plain version rounds twice);
* matvec rows, float32: |got - want| <= 1e-5 * sum_j |alpha A_ij x_j|
  + 1e-6 * |beta y_i|, the sum in float64, against the plain version and
  against a float64 result; outputs of the matvec programs carry the
  bound of their matvec rows through the level-1 routines that follow;
* each reduction a matvec program returns (pq, rnorm, tt, ts, norm,
  lambda, hnorm), also against float64 of the vectors the same run
  returned: 1e-5 * sum|terms| of that reduction alone (SYMV_DOT returns
  no vector, so its reduction is held so on a copy that also returns
  the symv output);
* bfloat16, compared in bfloat16: one bfloat16 unit in the last place of
  the operands' scale for level 1 (2**-8); gemv rows accumulate the same
  bfloat16 inputs in float32 and round once, so the float32 row bound
  plus half a bfloat16 unit of each rounded side: 2**-8 * (|got_i| +
  |want_i|) against the plain version, 2**-8 * |got_i| against float64;
* gemm elements, float32: |got - want| <= 1e-5 * sum_k |alpha A_ik B_kj|
  + 1e-6 * |beta C_ij|, the sum in float64, against the plain version and
  a float64 result; bfloat16 as for gemv rows. Tiled groups: their tile
  outputs under the same bound (a colaxpy epilogue adds |a_j| times it,
  plus 1e-6 of its operands for its own rounding), each coldot column
  against float64 of the tile outputs the same run returned within
  1e-5 * sum|terms| of that column alone, and against the plain splice
  within that plus the operands' bounds carried through the products;
* solves: each converges (CONVERGED); the three modes' iteration counts
  are equal or one apart (float32 sums in another order can move the
  metric across the threshold by one iteration); each column's true
  residual |b_j - A x_j| / |b_j|, in float64, is within rtol + 10 κ
  2**-24: the recurrence residual drifts from the true one by about κ
  times the float32 unit; CG on column j and block-CG's column j agree
  within κ (r_cg + r_block) |x_j|, r the measured true residuals, since
  each solution is within κ r |x| of the exact one, and the slowest
  column's CG iteration count equals block-CG's or is one apart (unit
  columns give both the same threshold; rounding as for the modes).
* transpose: bitwise equal to its plain version and to A.t() (it moves
  bits); ger: within half a unit of its dtype (|got| 2**-24 in float32,
  2**-8 in bfloat16) plus 2**-23 (|alpha x_i y_j| + |A_ij|) (the float32
  steps' two roundings of the terms) of its float64 value, alpha taken
  as the float32 value the kernel is given, and within
  twice that of its plain version; the GER_SPEC program likewise
  against reference mode (whose oracle rounds in another order), and
  TRANSPOSE_SPEC bitwise;
* `blas.<name>` against reference mode: the bound above of the
  routine's kernel (0 for transpose, iamax and the routines with no
  kernel, whose oracle runs in every mode); ger's doubled, as against
  its plain version. Power iteration: CONVERGED, and
  |A x - lambda x| <= 1e-3 |lambda| in float64. A class solver against
  its loop spec: |x - x_loop| <= 1e-5 |x_loop| + 1e-6 max|x_loop|.
* robust solves: a fault is detected when the solve ends with a failure
  status within 2 iterations of the injection (scale 0 on block-CG:
  BREAKDOWN; a bitflip: any failure status, as the reference's own
  tests allow, since the flipped value's binade decides between a
  collapsed sentinel, an overflow and a NaN); a recovered solve is
  CONVERGED on the card after more than one attempt, its true residual
  within the bound its clean solve is held to (rtol + 10 κ 2**-24 for
  the CG family, 1e-5 for GMRES); the float64 rung's true residual
  <= 1e-6. Recording on leaves x bitwise as it was.
* GMRES: each mode CONVERGED, restart counts equal or one apart, the
  float64 true residual |b - A x| / |b| <= 1e-5, and x within
  kappa * relres of a float64 LU solve of the same system (kappa from
  100 power iterations each on AᵀA and its inverse).
* attention kernels against their plain versions (both float32 math):
  |got - want| <= 1e-5 max|v| (1 + 2 d^-0.5 max|q_i| max|k_j|), the
  softmax-weighted sum's rounding plus the scores' rounding carried
  through exp(); in bfloat16 plus one bfloat16 unit of the output, 2**-7
  of the larger side (each side rounds its float32 result once); a row
  with no visible key gives exactly 0.
* the scans in float32 on the card, chunked against sequential:
  |got - want| <= 1e-4 max|want| (SCAN_REL). The chunked forms regroup
  the same float32 products (quadratic sums within a chunk of 128, the
  state carried once a chunk; sums of up to 400 terms) and take the
  exponentials of cumulative log decays of up to a few hundred, whose
  float32 unit moves them by ~1e-5 relative; the CPU tests measure 1e-6
  at narrower heads (tests/test_torch_ssm.py).
* serve logits (float32 of the bfloat16 logits), kernels against plain
  attention, prefill and each of the 4 teacher-forced steps: relative
  RMS |a - b| / |b| <= 0.05. The two runs differ only in the attention's
  float32 summation order, which moves a bfloat16 rounding of the
  attention output by one unit here and there; the difference then
  rides through about 8 bfloat16 roundings per layer over 32 layers,
  and independent unit errors of 2**-9 add up to sqrt(256) 2**-9 = 0.031.
  llama3-8b inside `use_gemm_kernel()` is held to the same bound against
  the default (torch.matmul) run: the two differ only in the float32
  summation order of each projection (the gemm kernel's and cuBLAS's
  tensor-core sums, both of exact products of bfloat16 values), which
  moves a bfloat16 rounding of a projection's output by one unit here
  and there, as the attention kernels do.
  The MoE configs (phase 2f) are held to the same bound with the plain
  run routed as the kernel run was (its gates from its own
  probabilities of those experts): routing is a top-k, and a token whose
  k-th and (k+1)-th router logits lie within the attention's rounding
  of each other takes another expert in the other run, which moves its
  hidden state by a whole expert's output whatever the kernels' error.
  How many tokens' sets the plain run would pick otherwise is printed
  per layer, and the logits of a plain run routing on its own are
  printed beside, not held to the bound.
  xlstm-125m (phase 2h) is held to the same bound for its recurrent
  forms against its chunked forms: both run float32 scans between the
  same bfloat16 roundings, in another order, over 12 layers.
  The kernel run repeats the engine's tokens exactly (the same kernels
  on the same inputs). Greedy tokens: equal to the plain run's wherever
  the plain run's top-1/top-2 margin exceeds twice the largest logit
  error seen in the teacher-forced steps; a row is followed up to its
  first token that differs below that margin.
* the attention gradient against the float32 reference: relative RMS
  |got - want| / |want| <= 1e-2 (GRAD_REL_RMS) for each of dq, dk and
  dv. The kernel's forward output is rounded to bfloat16 before the
  backward reads it (delta = rowsum(dout . out)), the backward's inputs
  are bfloat16 and its results are rounded to bfloat16 (2**-9 relative
  each, a few such roundings), against a reference that keeps float32
  throughout.
* training: every loss finite, the last below the first, the
  process's peak memory (torch.cuda.max_memory_allocated, the earlier
  phases' operands freed) within TRAIN_PEAK_GB;
  the teacher check's loss within 1e-2 relative and each gradient
  within relative RMS 0.05 (the bound of the serve logits, for the same
  reason: bf16 roundings of the attention output ridden through 16
  layers); the restart's resumed losses within 1e-3 relative of the
  whole run's (RESTART_LOSS_REL): deterministic algorithms stay off, so
  the embedding's backward (an index_add with atomics) sums its rows in
  any order, a float32 unit of difference that 10 steps of training
  carry on; the restored bfloat16 state bitwise, and the next step's
  loss on it bitwise (the same forward on the same bits).
"""
from __future__ import annotations

import atexit
import json
import os
import pathlib
import shutil
import struct
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
N = 1 << 26
RAGGED = N - 37
N2 = 16384                     # dense CG system: A is 1.07 GB in float32
RAGGED2 = (16381, 16379)
BASIS = (31, 1 << 20)          # GMRES(30) basis V: 130 MB
S_BLOCK, S_RAGGED = 32, 29     # block-CG right-hand sides
SQUARE = 4096                  # a gemm the operations bound
# llama3-8b's dense products on gemm's 16-bit wgmma route (phase 2c
# under use_gemm_kernel): (label, m, k, n), the prefill's m = 8 requests
# x the padded prompt of 1781 tokens (phase 2c's seeded prompts)
GEMM16_SHAPES = (("llama3-8b prefill gate/up", 14248, 4096, 14336),
                 ("llama3-8b prefill down", 14248, 14336, 4096),
                 ("llama3-8b decode gate/up", 8, 4096, 14336),
                 ("llama3-8b LM head", 8, 4096, 128256))
SERVE_DENSE_LAUNCHES = 7     # gemm launches a layer: wq wk wv wo gate up down
HESSENBERG = (20, 21)          # GMRES(20)'s column stack, transposed
GER_ALPHA = -0.37
SYMV_EDGES = (1, 63, 64, 65, 127, 128, 129, 4099)   # around 64-row tiles
GER_ALPHA32 = float(struct.unpack("f", struct.pack("f", GER_ALPHA))[0])
GMRES_M = 20                   # GMRES_LOOP's restart length
GMRES_BASIS = (GMRES_M + 1, N2)   # GMRES(20)'s basis, projected by gemv
GMRES_SHIFT = 1.25             # c of GMRES's A = c I + G / sqrt(n)
KAPPA = 100.0                  # condition number of block-CG's SPD A
TUNE_BUDGET = 8                # timed candidates per tuned program
TUNE_ITERS = 5                 # timed calls per candidate (the minimum)
F32_UNIT = 2.0 ** -24
HBM_BYTES_PER_S = 3.35e12    # H100 SXM, published
LOADED_W = 250.0             # power draw above which the card is busy
F32_FLOPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12    # H100 SXM bfloat16 in, float32 accumulate
SERVE_BATCH = 8              # requests served together
SERVE_NEW = 32               # greedy tokens per request
SERVE_FORCED = 4             # decode steps compared teacher-forced
SERVE_REL_RMS = 0.05         # serve logits vs plain attention and vs
                             # the default dense products (docstring)
# the sliding-window and MoE serve phases: (arch, layers kept, None for
# all; batch; the range of prompt lengths drawn from the seed)
SWA_MOE_SERVE = (("mixtral-8x22b", 4, 4, (4200, 6144)),
                 ("deepseek-moe-16b", None, 8, (256, 2048)),
                 ("h2o-danube-3-4b", None, 8, (1024, 4080)))
# the MLA and embedding-input serve phase (2g), the same fields
MLA_EMBED_SERVE = (("minicpm3-4b", None, 8, (256, 2048)),
                   ("musicgen-medium", None, 8, (256, 2048)),
                   ("llava-next-34b", 16, 4, (2304, 3200)))
# the SSM and hybrid serve phase (2h), the same fields
SSM_SERVE = (("hymba-1.5b", None, 8, (256, 2048)),
             ("xlstm-125m", None, 8, (256, 2048)))
# its scans in float32, chunked against sequential: (B, S), hymba's SSD
# heads (H, P, N), xlstm's mLSTM heads (H, D), and the bound on
# |chunked - sequential| / max|sequential| (docstring)
SCAN_BS = (2, 512)
SCAN_SSD = (8, 400, 16)
SCAN_MLSTM = (4, 384)
SCAN_REL = 1e-4
RAGGED_SQ, RAGGED_SKV = 33, 70
# the training phase (2i): llama3-8b at full width cut to TRAIN_LAYERS of
# its 32 layers (all 32 with AdamW's moments would need ~96 GB), bf16
# parameters, float32 moments, remat; B x S of train_4k's sequence
# (configs/base.py SHAPES); TRAIN_STEPS timed steps after one warm-up;
# the process's peak allowed, 9 GB under an H100 80GB's 85 GB, so that a
# step that outgrows it fails here and not on the card's last bytes
TRAIN_LAYERS = 16
TRAIN_BATCH, TRAIN_SEQ = 2, 4096
TRAIN_STEPS = 5
TRAIN_LR = 3e-4
TRAIN_PEAK_GB = 76.0
# the sharded step (phase 2j): llama3-8b at full width cut to
# SHARD_LAYERS layers, B x S, SHARD_STEPS steps from one seed, in a
# world of one on each of SHARD_MESHES in both styles; SHARD_ROUNDS
# rounds of steps in turns for the times; the production meshes and
# configs (at full depth) whose collectives' bytes it reckons
SHARD_LAYERS = 4
SHARD_BATCH, SHARD_SEQ = 1, 4096
SHARD_STEPS = 3
SHARD_ROUNDS = 4
SHARD_MESHES = ({"data": 1, "model": 1}, {"pod": 1, "data": 1, "model": 1})
PRODUCTION_MESHES = ({"data": 16, "model": 16},
                     {"pod": 2, "data": 16, "model": 16})
TRAFFIC_ARCHS = ("llama3-8b", "mixtral-8x22b", "deepseek-moe-16b")
# the sharded serve phase (2k): llama3-8b whole and SERVE_SHARD_ARCHS cut
# to SERVE_SHARD_LAYERS layers, prefill of the phase-2c prompts and
# SERVE_SHARD_STEPS greedy steps, unsharded and on SHARD_MESHES in an NCCL
# world of one, then llama3-8b's step whole and on (1, 1) in turns,
# SERVE_SHARD_ROUNDS rounds of STEPS_A_TURN steps; the lse output's bound against its plain version,
# |lse - plain| <= LSE_TOL max(1, |plain|) (float32 from the same 16-bit
# scores: the kernel's base-2 exponent and its order of sums); the dry
# run's time limit (s)
SERVE_SHARD_ARCHS = ("hymba-1.5b", "minicpm3-4b", "h2o-danube-3-4b")
SERVE_SHARD_LAYERS = 4
SERVE_SHARD_STEPS = 8
SERVE_SHARD_ROUNDS, STEPS_A_TURN = 4, 4
LSE_TOL = 2e-5
DRYRUN_LIMIT_S = 600
# the attention gradient (MhaFunction) at a layer's shape, B 1, S 4096,
# bf16, causal: (label, B, Hq, Hkv, S, d, dv, window); its bound on the
# relative RMS against the float32 autograd reference (docstring)
GRAD_SHAPES = (("llama3-8b layer", 1, 32, 8, 4096, 128, 128, None),
               ("hymba-1.5b layer", 1, 25, 5, 4096, 64, 64, 1024),
               ("minicpm3-4b MLA layer", 1, 40, 40, 4096, 96, 64, None))
GRAD_REL_RMS = 1e-2
# the teacher check: one B 1 batch of TEACHER_SEQ tokens, the loss and
# three weights' gradients against the float32 reference attention
TEACHER_SEQ = 2048
TEACHER_LOSS_REL = 1e-2
TEACHER_GRAD_REL_RMS = 0.05
# the restart: train_loop for 2 RESTART_K steps, resumed from step
# RESTART_K; the resumed losses against the whole run's (docstring)
RESTART_K = 10
RESTART_LOSS_REL = 1e-3
# mha shapes beside (RAGGED_SQ, RAGGED_SKV) that span several 128-row
# query and key tiles, ragged at both ends
MHA_TILED = ((300, 333), (1781, 1781))
# mha with v at a width of its own: (dtype name, d, dv, route)
MHA_WIDTHS = (("bfloat16", 96, 64, "wgmma"), ("bfloat16", 120, 120, "wgmma"),
              ("float32", 96, 64, "ffma"))
DECODE_LENS_EDGES = (0, 1, 63, 64, 65)   # around the decode tiles' edges
# power iteration on the SPD A: its top eigenvalues crowd the spectrum's
# edge, so the relative Rayleigh-quotient change is taken down to 3e-7
# (about 1000 iterations) before |A x - lambda x| falls under 1e-3 |lambda|
POWER_TOL, POWER_MAX = 3e-7, 3000


# the Krylov matvec stages this script drives: copies of
# src/repro/solvers/specs.py (a CPU test holds them equal), since this
# script imports nothing of the reference package
SOLVER_SPECS = {
    "RESIDUAL": {
        "name": "residual",
        "routines": [
            {"blas": "gemv", "name": "matvec",
             "scalars": {"alpha": 1.0, "beta": 0.0},
             "inputs": {"A": "A", "x": "x", "y": "b"},
             "connections": {"out": "res.y"}},
            {"blas": "vsub", "name": "res", "inputs": {"x": "b"},
             "connections": {"out": "rn.x"}, "outputs": {"out": "r"}},
            {"blas": "nrm2", "name": "rn", "outputs": {"out": "rnorm"}},
        ],
    },
    "CG_MATVEC": {
        "name": "cg_matvec",
        "routines": [
            {"blas": "gemv", "name": "matvec",
             "scalars": {"alpha": 1.0, "beta": 0.0},
             "inputs": {"A": "A", "x": "p", "y": "p"},
             "connections": {"out": "pq.x"}, "outputs": {"out": "q"}},
            {"blas": "dot", "name": "pq", "inputs": {"y": "p"},
             "outputs": {"out": "pq"}},
        ],
    },
    "BICG_MATVEC2": {
        "name": "bicg_matvec2",
        "routines": [
            {"blas": "gemv", "name": "matvec",
             "scalars": {"alpha": 1.0, "beta": 0.0},
             "inputs": {"A": "A", "x": "s", "y": "s"},
             "connections": {"out": ["tt.x", "tt.y", "ts.x"]},
             "outputs": {"out": "t"}},
            {"blas": "dot", "name": "tt", "outputs": {"out": "tt"}},
            {"blas": "dot", "name": "ts", "inputs": {"y": "s"},
             "outputs": {"out": "ts"}},
        ],
    },
    "POWER_STEP": {
        "name": "power_step",
        "routines": [
            {"blas": "gemv", "name": "matvec",
             "scalars": {"alpha": 1.0, "beta": 0.0},
             "inputs": {"A": "A", "x": "v", "y": "v"},
             "connections": {"out": ["nn.x", "lam.x"]},
             "outputs": {"out": "av"}},
            {"blas": "nrm2", "name": "nn", "outputs": {"out": "norm"}},
            {"blas": "dot", "name": "lam", "inputs": {"y": "v"},
             "outputs": {"out": "lambda"}},
        ],
    },
    "GMRES_ORTH": {
        "name": "gmres_orth",
        "routines": [
            {"blas": "gemvt", "name": "corr",
             "scalars": {"alpha": -1.0, "beta": 1.0},
             "inputs": {"A": "V", "x": "h", "y": "w"},
             "connections": {"out": "hn.x"}, "outputs": {"out": "w2"}},
            {"blas": "nrm2", "name": "hn", "outputs": {"out": "hnorm"}},
        ],
    },
}

# the one-routine ger and transpose programs of
# tests/test_torch_program.py
GER_SPEC = {"routines": [
    {"blas": "ger", "name": "r1", "scalars": {"alpha": {"input": "alpha"}},
     "inputs": {"x": "x", "y": "y", "A": "A"}, "outputs": {"out": "out"}}]}
TRANSPOSE_SPEC = {"routines": [
    {"blas": "transpose", "name": "tr", "inputs": {"A": "A"},
     "outputs": {"out": "out"}}]}

# tests/test_fusion_l2.py's symv -> dot
SYMV_DOT = {
    "name": "symv_dot",
    "routines": [
        {"blas": "symv", "name": "mv",
         "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "A", "x": "x", "y": "x"},
         "connections": {"out": "d.x"}},
        {"blas": "dot", "name": "d", "inputs": {"y": "x"},
         "outputs": {"out": "q"}},
    ],
}

# tests/test_fusion_l3.py's gemm -> colaxpy -> coldot epilogue chain
GEMM_COLAXPY_COLDOT = {
    "name": "gemm_colaxpy_coldot",
    "routines": [
        {"blas": "gemm", "name": "mm",
         "scalars": {"alpha": 1.0, "beta": 0.0},
         "inputs": {"A": "A", "B": "B", "C": "C0"},
         "connections": {"out": "up.x"}, "outputs": {"out": "Q"}},
        {"blas": "colaxpy", "name": "up",
         "inputs": {"a": "alphas", "y": "Y0"},
         "connections": {"out": ["cd.x", "cd.y"]},
         "outputs": {"out": "R"}},
        {"blas": "coldot", "name": "cd", "outputs": {"out": "rz"}},
    ],
}

# each reduction a matvec program returns, held against float64 of the
# vectors the same run returned: (output, its x, its y or None for nrm2);
# SYMV_DOT_S is SYMV_DOT with the symv output `s` returned as well
REDUCTIONS = {
    "CG_MATVEC": [("pq", "q", "p")],
    "RESIDUAL": [("rnorm", "r", None)],
    "BICG_MATVEC2": [("tt", "t", "t"), ("ts", "t", "s")],
    "POWER_STEP": [("norm", "av", None), ("lambda", "av", "v")],
    "GMRES_ORTH": [("hnorm", "w2", None)],
    "SYMV_DOT_S": [("q", "s", "x")],
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def event_ms(fn, reps: int = 5) -> float:
    """Device ms per call of fn, between CUDA events, after one warm-up
    call."""
    import torch

    fn()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Device time per call with no host issue in the way: the calls
    captured in a CUDA graph, replayed between two events."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    side.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * reps)


def host_call_ms(fn, reps: int = 5) -> float:
    """Host ms to launch one call of fn, back to back, after one warm-up
    call; the device work is waited for only at the end."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    took = time.perf_counter() - t0
    torch.cuda.synchronize()
    return took * 1e3 / reps


def issued_iterations(fn):
    """fn() under a registry that does not wait, and the iterations its
    loop solves issued from the host: an eager iteration and a capture
    each issue one iteration's launches, a replay of the loop's CUDA
    graph none (`solvers.driver`)."""
    from repro_torch import obs

    with obs.capture(wait=False) as reg:
        out = fn()
    c = reg.counters
    return out, (c["loop.iterations"] - c.get("loop.graph_replays", 0)
                 + c.get("loop.graph_captures", 0))


def lanes_equal(res, singles) -> list:
    """The lanes of a batched result that differ from their own solves
    in x, iterations, status or history (NaN tails compared as NaN)."""
    import torch

    return [j for j, one in enumerate(singles)
            if not (torch.equal(res.x[j], one.x)
                    and int(res.iterations[j]) == int(one.iterations)
                    and int(res.status[j]) == int(one.status)
                    and torch.equal(res.history[j].nan_to_num(-1.0),
                                    one.history.nan_to_num(-1.0)))]


def batched_phase(cg_lp, A, b_cols, cols, cols_counts, cols_ms,
                  counted_run) -> None:
    """The batched solves against the per-column CG solves of phase 2:
    `LoopProgram.batched` and `blas.compile(...).batched` on the 32
    columns as rows, each lane bitwise its column's solve with the same
    launches in all; `CG.solve_batched` on 4 columns against the class's
    own solves of them; a NaN in one of 4 lanes, NONFINITE within one
    iteration, the other lanes untouched."""
    import torch
    from repro_torch import blas
    from repro_torch.solvers import CG, specs as solver_specs

    B = torch.stack(b_cols)                      # (32, n): a lane a row
    X0 = torch.zeros_like(B)
    want = {k: c for k, c in cols_counts.items() if c}
    runs = (("LoopProgram.batched", cg_lp.batched),
            ("Executable.batched",
             blas.compile(solver_specs.CG_LOOP, device="cuda").batched))
    for label, batched in runs:
        batched(A=A, b=B[:2], x0=X0[:2])         # its kernels compile
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        res, counts = counted_run(lambda: batched(A=A, b=B, x0=X0))
        e1.record()
        e1.synchronize()
        got = {k: c for k, c in counts.items() if c}
        bad = lanes_equal(res, cols)
        ok = (not bad and got == want and tuple(res.x.shape) == tuple(B.shape)
              and tuple(res.history.shape) == (len(cols),
                                               cg_lp.max_iters + 1))
        emit({"phase": "batched", "call": label, "lanes": len(cols),
              "n": B.shape[1], "iterations": res.iterations.tolist(),
              "status": sorted(set(res.status_names())),
              "lanes_not_bitwise": bad, "launches": got,
              "launches_of_the_column_solves": want,
              "batched_ms": e0.elapsed_time(e1),
              "column_solves_ms": cols_ms, "ok": ok})
        check(ok, f"{label}: lanes {bad} differ from their column solves, "
                  f"or launches {got} != {want}")
        del res

    cls = CG(device="cuda")
    singles, counts1 = counted_run(
        lambda: [cls.solve(A, b) for b in b_cols[:4]])
    res, counts4 = counted_run(lambda: cls.solve_batched(A, B[:4]))
    bad = lanes_equal(res, singles)
    ok = not bad and counts1 == counts4
    emit({"phase": "batched", "call": "CG.solve_batched", "lanes": 4,
          "iterations": res.iterations.tolist(), "lanes_not_bitwise": bad,
          "launches": {k: c for k, c in counts4.items() if c},
          "same_launches_as_its_solves": counts1 == counts4, "ok": ok})
    check(ok, f"CG.solve_batched: lanes {bad} differ from CG.solve, or "
              f"launches differ")

    poisoned = B[:4].clone()
    poisoned[1, 5] = float("nan")
    res = cg_lp.batched(A=A, b=poisoned, x0=X0[:4])
    names = res.status_names()
    bad = [j for j in lanes_equal(res, cols[:4]) if j != 1]
    ok = (names[1] == "NONFINITE" and int(res.iterations[1]) <= 1
          and not bad and names.count("CONVERGED") == 3)
    emit({"phase": "batched", "call": "LoopProgram.batched, lane 1 NaN",
          "lanes": 4, "status": names, "iterations": res.iterations.tolist(),
          "lanes_not_bitwise": bad, "ok": ok})
    check(ok, f"poisoned batch: status {names}, iterations "
              f"{res.iterations.tolist()}, lanes not bitwise {bad}")


def distributed_phase(x, y, z, neg_alpha, A, B, b_cols, axpydot_prog,
                      counted_run) -> None:
    """The distributed layer in a world of one: NCCL, rank 0, world 1,
    on `make_host_mesh()`. A card host with one card can show only this
    world (NCCL puts one rank on one device), so every collective runs
    over one rank: each call must be bitwise its single-card call, and
    its time beside that call's is the layer's own cost (the shard
    views, the all_gather of one part, the fixed-order sum of one)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import distributed as D
    from repro_torch.kernels import common, ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import moe as m_moe

    store = common.build_dir() / "dist_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        mesh = make_host_mesh()
        one = torch.ones(1, device=x.device)
        for name in ("data", "model"):   # each group's communicator
            D.psum(mesh, one, name)
        torch.cuda.synchronize()
        emit({"phase": "distributed", "part": "init", "backend": "nccl",
              "world": dist.get_world_size(), "mesh": list(mesh.shape),
              "mesh_dims": list(mesh.mesh_dim_names),
              "init_and_first_collectives_s": time.perf_counter() - t0})

        mo = get_config("deepseek-moe-16b").moe
        d = get_config("deepseek-moe-16b").d_model
        gen = torch.Generator(device=x.device).manual_seed(7)

        def w(*shape, fan_in):
            return (torch.randn(*shape, generator=gen, device=x.device)
                    * fan_in ** -0.5).to(torch.bfloat16)

        e, de, ds = mo.n_experts, mo.d_expert, mo.d_shared
        params = {"router": w(d, e, fan_in=d),
                  "we_gate": w(e, d, de, fan_in=d),
                  "we_up": w(e, d, de, fan_in=d),
                  "we_down": w(e, de, d, fan_in=de),
                  "ws_gate": w(d, ds, fan_in=d), "ws_up": w(d, ds, fan_in=d),
                  "ws_down": w(ds, d, fan_in=ds)}
        tokens = torch.randn(4, 512, d, generator=gen,
                             device=x.device).to(torch.bfloat16)
        kw = dict(n_experts=e, top_k=mo.top_k,
                  capacity_factor=mo.capacity_factor, act="silu")
        axpydot_inputs = dict(neg_alpha=neg_alpha, w=x, v=y, u=z)
        cases = (
            ("paxpy", "n = 2**26 float32",
             lambda: D.paxpy(mesh, 1.7, x, y), lambda: ops.axpy(1.7, x, y)),
            ("pdot", "n = 2**26 float32",
             lambda: D.pdot(mesh, x, y), lambda: ops.dot(x, y)),
            ("paxpydot", "n = 2**26 float32",
             lambda: D.paxpydot(mesh, 0.7, x, y, z),
             lambda: ops.axpydot(0.7, x, y, z)),
            ("pgemv", "A 16384**2 float32",
             lambda: D.pgemv(mesh, 1.1, A, b_cols[0], 0.3, b_cols[1]),
             lambda: ops.gemv(1.1, A, b_cols[0], 0.3, b_cols[1])),
            ("pgemm row_col", "(16384**2) . (16384 x 32) float32",
             lambda: D.pgemm(mesh, A, B, strategy="row_col"),
             lambda: ops.matmul(A, B)),
            ("pgemm contract", "(16384**2) . (16384 x 32) float32",
             lambda: D.pgemm(mesh, A, B, strategy="contract"),
             lambda: ops.matmul(A, B)),
            ("distribute_program(AXPYDOT)", "n = 2**26 float32",
             lambda: D.distribute_program(axpydot_prog, mesh)(
                 **axpydot_inputs)["beta"],
             lambda: axpydot_prog(**axpydot_inputs)["beta"]),
            ("moe_ffn_tp_shard_map", "deepseek-moe-16b layer, 4 x 512 "
             "tokens, bfloat16",
             lambda: m_moe.moe_ffn_tp_shard_map(params, tokens, mesh=mesh,
                                                **kw),
             lambda: m_moe.moe_ffn(params, tokens.reshape(-1, d),
                                   **kw).reshape(tokens.shape)),
            ("moe_ffn_ep_shard_map", "deepseek-moe-16b layer, 4 x 512 "
             "tokens, bfloat16",
             lambda: m_moe.moe_ffn_ep_shard_map(params, tokens, mesh=mesh,
                                                **kw),
             lambda: m_moe.moe_ffn(params, tokens.reshape(-1, d),
                                   **kw).reshape(tokens.shape)),
        )
        for name, shape, dist_fn, single_fn in cases:
            got, counts = counted_run(dist_fn)
            want, single_counts = counted_run(single_fn)
            same = bool(torch.equal(got, want))
            launches = {k: c for k, c in counts.items() if c}
            ok = same and counts == single_counts
            emit({"phase": "distributed", "call": name, "shape": shape,
                  "world": 1, "bitwise_equal_to_single_card": same,
                  "launches": launches,
                  "single_card_launches": {k: c for k, c in
                                           single_counts.items() if c},
                  "ms": event_ms(dist_fn), "single_card_ms":
                  event_ms(single_fn), "host_ms": host_call_ms(dist_fn),
                  "single_card_host_ms": host_call_ms(single_fn), "ok": ok})
            check(ok, f"distributed {name}: not bitwise its single-card "
                      f"call, or launches {launches} differ")
        del params, tokens
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)


def train_phase(dev, smi, counted_run) -> None:
    """Phase 2i, training on the card (see the module's docstring): the
    attention gradient at three layers' shapes, llama3-8b at full width
    cut to TRAIN_LAYERS layers through `make_train_step`, a restart
    through `train_loop`, and the train launcher in a subprocess."""
    import contextlib
    import dataclasses
    import io

    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import attention as k_attn
    from repro_torch.launch.train import train_loop
    from repro_torch.models import attention as m_attn, init_params, \
        train_loss
    from repro_torch.optim import AdamW
    from repro_torch.train import (load_state_tree, make_train_state,
                                   make_train_step, state_tree)

    t_2i = time.perf_counter()
    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 was turned on before phase 2i: the attention gradient's "
          "float32 products must stay true float32")
    gen = torch.Generator(device=dev).manual_seed(50)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev).to(
            torch.bfloat16)

    def rel_rms(a, b):
        return float((a.float() - b.float()).norm() / b.float().norm())

    def timed(fn, reps=3, warm=1):
        for _ in range(warm):
            fn()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(reps):
            fn()
        e1.record()
        e1.synchronize()
        return e0.elapsed_time(e1) / reps

    def fwd_bwd(fn, q, k, v, ct):
        """fn's forward and its backward through autograd at ct: the
        gradients of q, k and v."""
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        fn(qg, kg, vg).backward(ct)
        return qg.grad, kg.grad, vg.grad

    # -- the attention gradient: MhaFunction (the kernel forward, the
    # torch-ops backward) against autograd through the out-of-place
    # float32 reference, beside the plain forward and backward and SDPA's
    rows = []
    for label, b, hq, hkv, s, d, dv, window in GRAD_SHAPES:
        q, k, ct = randn(b, hq, s, d), randn(b, hkv, s, d), randn(b, hq, s, dv)
        v = randn(b, hkv, s, dv)
        route = k_attn.mha_route(q, k, v)
        check(route == "wgmma", f"{label}: mha route {route}")

        def kernel():
            return fwd_bwd(lambda a, b_, c: k_attn.mha(
                a, b_, c, causal=True, window=window), q, k, v, ct)

        def plain():
            out = k_attn.mha_plain(q, k, v, causal=True, window=window)
            return k_attn.mha_backward_plain(q, k, v, out, ct, causal=True,
                                             window=window)

        got, counts = counted_run(kernel)
        want = fwd_bwd(lambda a, b_, c: k_attn.attention_reference(
            a, b_, c, causal=True, window=window),
            q.float(), k.float(), v.float(), ct.float())
        errs = {n: rel_rms(g, w) for n, g, w in zip(("dq", "dk", "dv"),
                                                    got, want)}
        del got, want
        ok = (max(errs.values()) <= GRAD_REL_RMS and counts["mha"] == 1)
        pairs = b * visible_pairs(s, window)
        flops = 3.5 * 2 * (d + dv) * hq * pairs
        nbytes = 2 * 2 * (q.numel() + k.numel() + v.numel() + ct.numel())
        if window is None:
            lib = {"mask": None, "is_causal": True}
        else:
            i = torch.arange(s, device=dev)
            lib = {"mask": (i[:, None] >= i[None]) & (i[:, None] - i[None]
                                                      < window),
                   "is_causal": False}

        def library():
            return fwd_bwd(lambda a, b_, c: F.scaled_dot_product_attention(
                a, b_, c, attn_mask=lib["mask"], is_causal=lib["is_causal"],
                enable_gqa=True), q, k, v, ct)

        row = {"case": f"{label}: q ({b}, {hq}, {s}, {d}), k {hkv} heads, "
                       f"v width {dv}, window {window}, bf16, causal",
               "route": route, "launches_per_call": counts["mha"],
               "rel_rms": errs, "bound_rel_rms": GRAD_REL_RMS,
               "ms": timed(kernel), "plain_ms": timed(plain, reps=1),
               "bound_ms": max(flops / BF16_FLOPS_PER_S,
                               nbytes / HBM_BYTES_PER_S) * 1e3,
               "bound_by": ("operations" if flops / BF16_FLOPS_PER_S
                            >= nbytes / HBM_BYTES_PER_S else "bytes"),
               "flops": flops, "visible_pairs": pairs}
        try:
            lib_grads = library()
            row["library_ms"] = timed(library)
            row["library_rel_rms"] = {
                n: rel_rms(g, w) for n, g, w in zip(
                    ("dq", "dk", "dv"), lib_grads, fwd_bwd(
                        lambda a, b_, c: k_attn.attention_reference(
                            a, b_, c, causal=True, window=window),
                        q.float(), k.float(), v.float(), ct.float()))}
            del lib_grads
        except (torch.OutOfMemoryError, RuntimeError) as exc:
            row["library_ms"] = None
            row["library_error"] = str(exc).splitlines()[0][:200]
        row["ok"] = ok
        rows.append(row)
        del q, k, v, ct, lib
        torch.cuda.empty_cache()
        emit({"phase": "main_path_check", "program": "attention gradient "
              "(MhaFunction) vs float32 autograd reference", **row})
        check(ok, f"attention gradient {label}: relative RMS {errs} (bound "
                  f"{GRAD_REL_RMS}), launches {counts['mha']}")

    # -- llama3-8b at full width, TRAIN_LAYERS of its 32 layers, bf16
    # parameters, float32 moments, remat, through make_train_step
    cfg = get_config("llama3-8b")
    cfg = dataclasses.replace(cfg, n_layers=TRAIN_LAYERS,
                              segments=(("attn", TRAIN_LAYERS),))
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    model = init_params(cfg, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    opt_events = []

    class TimedAdamW(AdamW):
        """AdamW with CUDA events around each update (the step's
        optimizer share)."""

        def update(self, params, grads, opt_state, step, **kw):
            e0, e1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            e0.record()
            out = super().update(params, grads, opt_state, step, **kw)
            e1.record()
            opt_events.append((e0, e1))
            return out

    optim = TimedAdamW(lr=TRAIN_LR)
    state = make_train_state(cfg, model, optim)
    step_fn = make_train_step(cfg, optim, remat=True)
    stream = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                         batch_size=TRAIN_BATCH, seed=0, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    state_bytes = sum(p.numel() * (2 * p.element_size() + 8)
                      for p in model.parameters())   # p, g, m, v
    # the bound: the dense products (forward, backward at twice the
    # forward, remat's second forward of the blocks; the LM head once
    # forward and once backward), attention 4.5 times its forward (the
    # forward, the recompute, the backward at 2.5), both at the bf16
    # peak; then the optimizer's bytes (read p, g, m, v; write p, m, v)
    blk = sum(t.numel() for b_ in model.blocks for t in b_.p.values()
              if t.dim() == 2)
    head = model.lm_head.numel()
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops_dense = tokens * (6 * (blk + head) + 2 * blk)
    flops_attn = (TRAIN_LAYERS * 4.5 * 4 * cfg.head_dim * cfg.n_heads
                  * TRAIN_BATCH * visible_pairs(TRAIN_SEQ, None))
    opt_bytes = sum(p.numel() * (2 * p.element_size() + p.element_size()
                                 + 16) for p in model.parameters())
    compute_ms = (flops_dense + flops_attn) / BF16_FLOPS_PER_S * 1e3
    opt_ms = opt_bytes / HBM_BYTES_PER_S * 1e3
    want_mha = 2 * TRAIN_LAYERS         # forward, remat's recompute
    steps = []
    for i in range(TRAIN_STEPS + 1):
        batch = stream.batch_at(i)
        opt_events.clear()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))

        def one():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            e0.record()
            _, metrics = step_fn(state, batch)
            e1.record()
            return metrics, (time.perf_counter() - t0) * 1e3

        (metrics, issue), counts = counted_run(one)
        (o0, o1), = opt_events
        ms = e0.elapsed_time(e1)
        steps.append({
            "step": i, "warm_up": i == 0, "loss": float(metrics["loss"]),
            "event_ms": ms, "host_issue_ms": issue,
            "forward_backward_ms": e0.elapsed_time(o0),
            "optimizer_ms": o0.elapsed_time(o1),
            "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / ms * 1e3,
            "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
            "mha_launches": counts["mha"]})
        emit({"phase": "main_path", "program": "train step (make_train_step)",
              "arch": "llama3-8b", **steps[-1]})
        check(counts["mha"] == want_mha and counts.get(
            "decode_attention", 0) == 0,
              f"train step {i}: mha launches {counts['mha']} (want "
              f"{want_mha})")
    # one more step under torch.profiler: device time by kernel, and the
    # share of the step's wall time the card spends in no kernel
    from torch.profiler import ProfilerActivity, profile
    batch = stream.batch_at(TRAIN_STEPS + 1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step_fn(state, batch)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    by_kernel, n_kernels = {}, 0
    by_class = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = (e.time_range.end - e.time_range.start) / 1e3
            by_kernel[e.name] = by_kernel.get(e.name, 0.0) + ms
            row = by_class.setdefault(kernel_class(e.name),
                                      {"ms": 0.0, "kernels": 0})
            row["ms"] += ms
            row["kernels"] += 1
            n_kernels += 1
    kernel_ms = sum(by_kernel.values())
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:15]
    emit({"phase": "trace", "program": "train step llama3-8b",
          "nvidia_smi": smi, "traced_step_ms": traced_ms,
          "kernel_ms_sum": kernel_ms, "kernels": n_kernels,
          "idle_share": 1 - kernel_ms / traced_ms,
          "device_ms_by_class": by_class,
          "bound_16bit_products_ms": flops_dense / BF16_FLOPS_PER_S * 1e3,
          "device_ms_by_kernel_top15": [
              {"kernel": k[:160], "class": kernel_class(k), "ms": ms}
              for k, ms in top]})
    del batch, metrics, prof
    losses = [r["loss"] for r in steps]
    timed_steps = steps[1:]

    def median(key):
        vals = sorted(r[key] for r in timed_steps)
        return vals[len(vals) // 2]

    peak_gb = max(r["peak_memory_gb"] for r in steps)
    ok = (all(np.isfinite(losses)) and losses[-1] < losses[0]
          and peak_gb <= TRAIN_PEAK_GB)
    emit({"phase": "times", "program": "train llama3-8b", "nvidia_smi": smi,
          "layers": TRAIN_LAYERS, "batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
          "params": n_params, "state_gb": state_bytes / 1e9,
          "init_s": init_s, "losses": losses,
          "step_ms_median": median("event_ms"),
          "step_ms": [r["event_ms"] for r in timed_steps],
          "host_issue_ms_median": median("host_issue_ms"),
          "forward_backward_ms_median": median("forward_backward_ms"),
          "optimizer_ms_median": median("optimizer_ms"),
          "tokens_per_s_median": median("tokens_per_s"),
          "peak_memory_gb": peak_gb, "peak_bound_gb": TRAIN_PEAK_GB,
          "held_before_training_gb": held_gb,
          "card_memory_gb": torch.cuda.get_device_properties(
              dev).total_memory / 1e9,
          "bound_ms": compute_ms + opt_ms,
          "bound_forward_backward_ms": compute_ms,
          "bound_optimizer_ms": opt_ms, "flops_dense": flops_dense,
          "flops_attention": flops_attn, "optimizer_bytes": opt_bytes,
          "mha_launches_per_step": want_mha, "ok": ok})
    check(ok, f"train llama3-8b: losses {losses}, peak {peak_gb} GB (bound "
              f"{TRAIN_PEAK_GB})")

    # the teacher check: one B 1, S TEACHER_SEQ batch, the loss and three
    # weights' gradients with MhaFunction against the same step with the
    # float32 reference attention in its place
    tb = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=TEACHER_SEQ,
                     batch_size=1, seed=1, device=dev).batch_at(0)
    watch = {"layer 0 wq": model.blocks[0].p["wq"],
             "layer 0 wo": model.blocks[0].p["wo"],
             f"layer {TRAIN_LAYERS - 1} w_down": model.blocks[-1].p["w_down"]}

    def loss_grads():
        loss = train_loss(model, cfg, tb, remat=True)
        return loss.detach(), torch.autograd.grad(loss, list(watch.values()))

    (k_loss, k_grads), counts = counted_run(loss_grads)
    saved = m_attn.mha
    m_attn.mha = lambda q, k, v, *, causal=True, window=None: \
        k_attn.attention_reference(q, k, v, causal=causal,
                                   window=window).to(q.dtype)
    try:
        p_loss, p_grads = loss_grads()
    finally:
        m_attn.mha = saved
    loss_rel = abs(float(k_loss) - float(p_loss)) / abs(float(p_loss))
    grad_rel = {n: rel_rms(a, b_) for n, a, b_ in zip(watch, k_grads,
                                                      p_grads)}
    ok = (loss_rel <= TEACHER_LOSS_REL and max(grad_rel.values())
          <= TEACHER_GRAD_REL_RMS and counts["mha"] == want_mha)
    emit({"phase": "main_path_check", "program": "train loss and gradients "
          "vs float32 reference attention", "arch": "llama3-8b",
          "batch": 1, "seq": TEACHER_SEQ, "loss": float(k_loss),
          "reference_loss": float(p_loss), "loss_rel": loss_rel,
          "loss_bound": TEACHER_LOSS_REL, "grad_rel_rms": grad_rel,
          "grad_bound": TEACHER_GRAD_REL_RMS, "mha_launches": counts["mha"],
          "ok": ok})
    check(ok, f"train teacher check: loss {loss_rel}, gradients {grad_rel}")
    del model, state, optim, step_fn, k_grads, p_grads, watch, tb
    torch.cuda.empty_cache()

    # -- restart on the card: train_loop on llama3-8b reduced (float32),
    # 2 RESTART_K steps whole, and the same run resumed from its step
    # RESTART_K checkpoint; deterministic algorithms stay off, so the
    # embedding's backward (index_add with atomics) sums in any order
    cfg_r = dataclasses.replace(get_config("llama3-8b").reduced(),
                                dtype="float32")
    ck = pathlib.Path(tempfile.mkdtemp(prefix="repro_torch_ckpt_"))
    try:
        kw = dict(steps=2 * RESTART_K, batch_size=8, seq_len=64, lr=3e-3,
                  remat=True, log_every=1, ckpt_every=RESTART_K, device=dev)
        with contextlib.redirect_stdout(io.StringIO()):
            whole, counts = counted_run(lambda: train_loop(
                cfg_r, ckpt_dir=ck / "whole", **kw))
            (ck / "resumed").mkdir()
            shutil.copytree(ck / "whole" / f"step_{RESTART_K:010d}",
                            ck / "resumed" / f"step_{RESTART_K:010d}")
            resumed, r_counts = counted_run(lambda: train_loop(
                cfg_r, ckpt_dir=ck / "resumed", **kw))
        tail = [(s_, l_) for s_, l_ in whole.losses if s_ > RESTART_K]
        loss_rel = max(abs(a[1] - b_[1]) / abs(b_[1])
                       for a, b_ in zip(resumed.losses, tail))
        # the manager's round trip of a bfloat16 train state on the card:
        # restored bitwise, and the next step's loss bitwise
        cfg_b = dataclasses.replace(cfg_r, dtype="bfloat16")
        opt_b = AdamW(lr=1e-3)
        step_b = make_train_step(cfg_b, opt_b, remat=True)
        data_b = SyntheticLM(vocab_size=cfg_b.vocab_size, seq_len=64,
                             batch_size=8, seed=3, device=dev)
        st_a = make_train_state(cfg_b, init_params(cfg_b, 2, device=dev),
                                opt_b)
        for i in range(2):
            step_b(st_a, data_b.batch_at(i))
        mgr = CheckpointManager(ck / "bf16")
        mgr.save(2, state_tree(st_a))
        mgr.wait()
        st_r = make_train_state(cfg_b, init_params(cfg_b, 9, device=dev),
                                opt_b)
        found, tree = mgr.restore_latest(state_tree(st_r))
        load_state_tree(st_r, tree)

        def bits(t):
            return t.detach().reshape(-1).view(torch.uint8)

        flat_a = [bits(t) for t in _leaves(state_tree(st_a))]
        flat_r = [bits(t) for t in _leaves(state_tree(st_r))]
        bitwise = (found == 2 and st_r["step"] == 2
                   and all(torch.equal(a, b_) for a, b_ in zip(flat_a,
                                                               flat_r)))
        nxt = data_b.batch_at(2)
        la = float(step_b(st_a, nxt)[1]["loss"])
        lr_ = float(step_b(st_r, nxt)[1]["loss"])
    finally:
        shutil.rmtree(ck, ignore_errors=True)
    ok = (whole.restored_from is None and whole.steps_run == 2 * RESTART_K
          and resumed.restored_from == RESTART_K
          and resumed.steps_run == RESTART_K and len(tail) == RESTART_K
          and [s_ for s_, _ in resumed.losses] == [s_ for s_, _ in tail]
          and loss_rel <= RESTART_LOSS_REL and bitwise and la == lr_
          and counts["mha"] == 2 * 2 * RESTART_K
          and r_counts["mha"] == 2 * RESTART_K)
    emit({"phase": "main_path_check", "program": "train_loop restart on the "
          "card", "arch": "llama3-8b reduced", "steps": 2 * RESTART_K,
          "restored_from": resumed.restored_from,
          "steps_run": resumed.steps_run,
          "whole_losses": [l_ for _, l_ in tail],
          "resumed_losses": [l_ for _, l_ in resumed.losses],
          "loss_rel": loss_rel, "loss_bound": RESTART_LOSS_REL,
          "deterministic_algorithms": torch.are_deterministic_algorithms_enabled(),
          "bf16_state_restored_bitwise": bitwise,
          "next_loss_bitwise": la == lr_, "mha_launches": [
              counts["mha"], r_counts["mha"]], "ok": ok})
    check(ok, f"train_loop restart: restored_from {resumed.restored_from}, "
              f"steps_run {resumed.steps_run}, loss_rel {loss_rel}, "
              f"bitwise {bitwise}, next loss {la} vs {lr_}")

    # -- the launcher on the card, no --device
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3-8b", "--reduced", "--steps", "20"], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        capture_output=True, text=True, timeout=300)
    last = proc.stdout.strip().splitlines()[-1:] or [""]
    ok = proc.returncode == 0 and "on cuda" in last[0]
    emit({"phase": "main_path_check", "program": "python -m "
          "repro_torch.launch.train --arch llama3-8b --reduced --steps 20",
          "rc": proc.returncode, "last_line": last[0],
          "seconds": time.perf_counter() - t0,
          "stderr_tail": proc.stderr[-400:] if proc.returncode else "",
          "ok": ok})
    check(ok, f"train launcher: rc {proc.returncode}: {proc.stderr[-2000:]}")
    emit({"phase": "times", "program": "phase 2i", "seconds":
          time.perf_counter() - t_2i, "nvidia_smi": smi})


def shard_phase(dev, smi, counted_run) -> None:
    """Phase 2j, the sharded train step in an NCCL world of one (see the
    module's docstring): bitwise the unsharded step on each mesh in each
    style, its time beside the unsharded one's, and the production
    meshes' collective bytes reckoned from the specs."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core.distributed import shard
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import common
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params, partition, sharding
    from repro_torch.optim import AdamW
    from repro_torch.train import (make_train_state, make_train_step,
                                   step_traffic)

    t_2j = time.perf_counter()
    full = get_config("llama3-8b")
    cfg = dataclasses.replace(full, n_layers=SHARD_LAYERS,
                              segments=(("attn", SHARD_LAYERS),))
    stream = SyntheticLM(vocab_size=cfg.vocab_size, seq_len=SHARD_SEQ,
                         batch_size=SHARD_BATCH, seed=0, device=dev)
    batches = [stream.batch_at(i) for i in range(SHARD_STEPS)]
    want_mha = 2 * SHARD_LAYERS          # forward, remat's recompute

    def start(mesh=None, style="2d"):
        """A train state from seed 0 (placed on `mesh` in `style`) and a
        function that runs its step on batch i: (loss, event ms, mha
        launches)."""
        optim = AdamW(lr=TRAIN_LR)
        model = init_params(cfg, 0, device=dev)
        with partition.use_mesh(mesh), partition.parallelism_style(style):
            state = make_train_state(cfg, model, optim)
        specs = model.layout.specs if mesh is not None else None
        step = make_train_step(cfg, optim, remat=True, grad_specs=specs)
        bspec = (sharding.batch_specs(cfg, mesh, style=style)
                 if mesh is not None else None)

        def one(i):
            b = batches[i % SHARD_STEPS]
            if bspec is not None:
                b = {k: shard(mesh, v, bspec[k]) for k, v in b.items()}
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))

            def call():
                e0.record()
                out = step(state, b)
                e1.record()
                return out

            (_, metrics), counts = counted_run(call)
            return float(metrics["loss"]), e0.elapsed_time(e1), counts["mha"]

        return state, one

    def run(mesh=None, style="2d"):
        """SHARD_STEPS steps from seed 0: the state, losses, event ms and
        mha launches of each step."""
        state, one = start(mesh, style)
        losses, ms, mha = (list(c) for c in zip(*(one(i) for i in range(
            SHARD_STEPS))))
        return state, losses, ms, mha

    def same(a, b):
        """Whether two states hold bitwise the same parameters and
        moments."""
        pa, pb = (dict(s["params"].named_parameters()) for s in (a, b))
        return {"params": all(torch.equal(pa[n], pb[n]) for n in pb),
                **{k: all(torch.equal(a["opt"][k][n], b["opt"][k][n])
                          for n in pb) for k in ("m", "v")}}

    def median(xs):
        return sorted(xs)[len(xs) // 2]

    store = common.build_dir() / "shard_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    was_deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    try:
        base, base_losses, base_ms, base_mha = run()
        emit({"phase": "shard", "run": "unsharded", "arch": "llama3-8b",
              "layers": SHARD_LAYERS, "batch": SHARD_BATCH,
              "seq": SHARD_SEQ, "losses": base_losses, "step_ms": base_ms,
              "mha_launches": base_mha})
        check(all(np.isfinite(base_losses)) and all(
            c == want_mha for c in base_mha),
              f"shard: unsharded losses {base_losses}, mha {base_mha}")
        rows = []
        for shape in SHARD_MESHES:
            mesh = make_host_mesh(pod=shape.get("pod"), data=1, model=1)
            for style in ("2d", "fsdp"):
                state, losses, ms, mha = run(mesh, style)
                bits = same(state, base)
                ok = (losses == base_losses and all(bits.values())
                      and all(c == want_mha for c in mha))
                rows.append(ms)
                emit({"phase": "shard", "run": "sharded", "mesh": shape,
                      "style": style, "world": dist.get_world_size(),
                      "losses": losses, "losses_bitwise": losses ==
                      base_losses, "state_bitwise": bits, "step_ms": ms,
                      "mha_launches": mha, "ok": ok})
                del state
                torch.cuda.empty_cache()
                check(ok, f"shard {shape} {style}: losses {losses} against "
                          f"{base_losses}, bitwise {bits}, mha {mha}")
        again, again_losses, again_ms, again_mha = run()
        bits = same(again, base)
        ok = again_losses == base_losses and all(bits.values())
        emit({"phase": "shard", "run": "unsharded again", "losses":
              again_losses, "state_bitwise": bits, "step_ms": again_ms,
              "mha_launches": again_mha, "ok": ok})
        check(ok, f"shard: the unsharded step did not repeat bitwise: "
                  f"{again_losses} against {base_losses}, {bits}")
        del base, again
        torch.cuda.empty_cache()
        # the mesh machinery's own cost: an unsharded state and one on the
        # (1, 1) mesh in "2d", stepped in turns (unsharded, sharded,
        # sharded, unsharded) SHARD_ROUNDS times, the SM clock sampled
        # every 200 ms beside them (the card's clock moves between calls
        # and within one)
        _, plain_step = start()
        _, sharded_step = start(make_host_mesh(data=1, model=1), "2d")
        sampler = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "200"],
            stdout=subprocess.PIPE, text=True)
        times = {"unsharded": [], "sharded": []}
        try:
            for r in range(SHARD_ROUNDS):
                for which in ("unsharded", "sharded", "sharded",
                              "unsharded"):
                    fn = plain_step if which == "unsharded" else sharded_step
                    times[which].append(fn(r)[1])
        finally:
            sampler.terminate()
        mhz = sorted(float(row.split(",")[0]) for row in
                     sampler.communicate(timeout=60)[0].splitlines()
                     if row.split(",")[0].strip().replace(".", "").isdigit())
        del plain_step, sharded_step
        torch.cuda.empty_cache()
        emit({"phase": "times", "program": "sharded step, world of one",
              "nvidia_smi": smi, "arch": "llama3-8b",
              "layers": SHARD_LAYERS, "batch": SHARD_BATCH,
              "seq": SHARD_SEQ, "order": "unsharded, sharded, sharded, "
              f"unsharded, x {SHARD_ROUNDS}",
              "unsharded_step_ms_median": median(times["unsharded"]),
              "sharded_step_ms_median": median(times["sharded"]),
              "sharded_over_unsharded": median(times["sharded"])
              / median(times["unsharded"]),
              "unsharded_step_ms": times["unsharded"],
              "sharded_step_ms": times["sharded"],
              "sm_mhz": {"min": mhz[0], "median": mhz[len(mhz) // 2],
                         "max": mhz[-1]} if mhz else None,
              "checked_runs_step_ms": {"unsharded": base_ms + again_ms,
                                       "sharded": [m for r in rows
                                                   for m in r]}})
        for arch in TRAFFIC_ARCHS:
            whole = get_config(arch)
            for shape in PRODUCTION_MESHES:
                for style in ("2d", "fsdp"):
                    emit({"phase": "shard", "run": "traffic reckoned from "
                          "the step's plan (not measured)", "arch": arch,
                          "layers": whole.n_layers, "dtype": whole.dtype,
                          "mesh": shape, "style": style, "remat": True,
                          "bytes_per_rank_per_step": step_traffic(
                              whole, sharding.MeshShape(shape),
                              style=style)})
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)
        torch.use_deterministic_algorithms(was_deterministic)
    emit({"phase": "times", "program": "phase 2j", "seconds":
          time.perf_counter() - t_2j, "nvidia_smi": smi})


def serve_shard_phase(dev, smi, counted_run) -> dict:
    """Phase 2k, prefill and decode on a mesh and the launch tools (see
    the module's docstring): (a) serving on (1, 1) and (1, 1, 1) meshes
    in an NCCL world of one bitwise the unsharded serve; (b) the decode
    kernel's lse output against its plain version; (c) the cost
    counter's counts on the card equal to its counts on meta stand-ins,
    the roofline terms beside the measured ms; (d) the production-mesh
    dry run in a subprocess. Returns the `kernels` line's row of
    decode_attention's lse variant."""
    import dataclasses

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.configs.base import InputShape
    from repro_torch.core.distributed import shard
    from repro_torch.data import SyntheticLM
    from repro_torch.kernels import common, decode_attention as k_dec, ops
    from repro_torch.launch import roofline, specs as launch_specs
    from repro_torch.launch.cost import count
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import (decode_step, init_params, prefill,
                                    shard_model)
    from repro_torch.models import partition, sharding
    from repro_torch.optim import AdamW
    from repro_torch.serve import pad_and_batch
    from repro_torch.train import make_train_state, make_train_step

    t_2k = time.perf_counter()

    def timed(fn):
        """fn() between two events on the card: (its result, ms)."""
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        out = fn()
        e1.record()
        e1.synchronize()
        return out, e0.elapsed_time(e1)

    # (b) the lse output: both routes, one split and several, a row of
    # length 0, at llama3-8b's, h2o-danube-3-4b's and hymba-1.5b's decode
    # shapes
    gen = torch.Generator(device=dev).manual_seed(31)

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    def cache_view(b, s, hkv, d, dtype):
        return randn(b, s, hkv, d, dtype=dtype).permute(0, 2, 1, 3)

    lens_edge = torch.tensor([0, 1, 700, 1797, 0, 63, 64, 65],
                             dtype=torch.int32, device=dev)
    lens_ring = torch.tensor([0, 1, 700, 1024, 0, 63, 64, 1023],
                             dtype=torch.int32, device=dev)
    lse_cases = (
        ("llama3-8b step", randn(8, 32, 128), cache_view(8, 1813, 8, 128,
                                                         torch.bfloat16),
         1797, "mma"),
        ("llama3-8b step, B 32", randn(32, 32, 128),
         cache_view(32, 1813, 8, 128, torch.bfloat16), 1797, "mma"),
        ("llama3-8b step, rows of length 0", randn(8, 32, 128),
         cache_view(8, 1813, 8, 128, torch.bfloat16), lens_edge, "mma"),
        ("h2o-danube-3-4b ring step", randn(8, 32, 120),
         cache_view(8, 4096, 8, 120, torch.bfloat16), 4096, "mma"),
        ("h2o-danube-3-4b ring, rows of length 0", randn(8, 32, 120),
         cache_view(8, 4096, 8, 120, torch.bfloat16), lens_edge, "mma"),
        ("float32 D 64, B 32", randn(32, 8, 64, dtype=torch.float32),
         cache_view(32, 256, 8, 64, torch.float32), 200, "simt"),
        # hymba-1.5b's ring step (25 heads on 5, D 64, W 1024), as phase
        # 2k's steps on the meshes launch it: several splits at B 8, one
        # at B 64
        ("hymba-1.5b ring step", randn(8, 25, 64),
         cache_view(8, 1024, 5, 64, torch.bfloat16), 1024, "mma"),
        ("hymba-1.5b ring, rows of length 0", randn(8, 25, 64),
         cache_view(8, 1024, 5, 64, torch.bfloat16), lens_ring, "mma"),
        ("hymba-1.5b ring step, B 64", randn(64, 25, 64),
         cache_view(64, 1024, 5, 64, torch.bfloat16), 1024, "mma"),
        ("hymba-1.5b ring, B 64, rows of length 0", randn(64, 25, 64),
         cache_view(64, 1024, 5, 64, torch.bfloat16), lens_ring.repeat(8),
         "mma"))
    lse_err = 0.0
    for case, q, kc, ln, route in lse_cases:
        b, hkv, smax = kc.shape[0], kc.shape[1], kc.shape[2]
        splits = k_dec.decode_plan(b, hkv, smax, k_dec.TILE_KEYS[route],
                                   common.sm_count(dev))
        out0 = ops.decode_attention(q, kc, kc, ln)
        out, lse = ops.decode_attention(q, kc, kc, ln, return_lse=True)
        pout, plse = k_dec.decode_attention_plain(q, kc, kc, ln,
                                                  return_lse=True)
        torch.cuda.synchronize()
        fin = torch.isfinite(plse)
        err = float((lse[fin] - plse[fin]).abs().max())
        tol = LSE_TOL * max(1.0, float(plse[fin].abs().max()))
        ok = (k_dec.decode_route(q, kc, kc) == route
              and torch.equal(out, out0)
              and torch.equal(torch.isfinite(lse), fin)
              and bool(torch.all(lse[~fin] == -torch.inf))
              and bool(torch.all(out[~fin] == 0)) and err <= tol)
        lse_err = max(lse_err, err)
        emit({"phase": "serve_shard", "part": "lse", "case": case,
              "route": route, "splits": splits, "rows_without_keys":
              int((~fin).sum()), "lse_max_abs_err": err, "tol": tol,
              "out_bitwise_without_lse": torch.equal(out, out0), "ok": ok})
        check(ok, f"decode_attention lse {case}: err {err} (tol {tol}), "
                  f"route {k_dec.decode_route(q, kc, kc)}")

    # the lse variant's row of the kernels line, at llama3-8b's step;
    # beside it h2o-danube-3-4b's ring step (D 120, all 4096 slots valid).
    # Timed over a V of its own, as the model passes them: with K = V half
    # the bytes that the bound counts would reach HBM
    q, kc = lse_cases[0][1], lse_cases[0][2]
    vc = cache_view(8, 1813, 8, 128, torch.bfloat16)

    def ev_ms(fn, reps=20, warm=3):
        for _ in range(warm):
            fn()
        return timed(lambda: [fn() for _ in range(reps)])[1] / reps

    dq, dkc = lse_cases[3][1], lse_cases[3][2]
    dvc = cache_view(8, 4096, 8, 120, torch.bfloat16)
    dfn = (lambda: ops.decode_attention(dq, dkc, dvc, 4096,
                                        return_lse=True))
    dpfn = (lambda: k_dec.decode_attention_plain(dq, dkc, dvc, 4096,
                                                 return_lse=True))
    dp1, dk1, dk2, dp2 = ev_ms(dpfn), ev_ms(dfn), ev_ms(dfn), ev_ms(dpfn)
    dbytes = 2 * 2 * 8 * 8 * 4096 * 120 + 2 * 2 * 8 * 32 * 120 + 4 * 8 * 32
    danube_lse = {"case": "q (8, 32, 120), K and V ring views (8, 8, "
                          "4096, 120), len 4096, bfloat16, with the rows' "
                          "lse",
                  "route": k_dec.decode_route(dq, dkc, dvc),
                  "ms": min(dk1, dk2), "ms_runs": [dk1, dk2],
                  "graph_ms": graph_ms(dfn), "plain_ms": min(dp1, dp2),
                  "bound_ms": dbytes / HBM_BYTES_PER_S * 1e3,
                  "bound_by": "bytes"}
    del dq, dkc, dvc

    kfn = (lambda: ops.decode_attention(q, kc, vc, 1797, return_lse=True))
    pfn = (lambda: k_dec.decode_attention_plain(q, kc, vc, 1797,
                                                return_lse=True))
    p1, k1, k2, p2 = ev_ms(pfn), ev_ms(kfn), ev_ms(kfn), ev_ms(pfn)
    nbytes = 2 * 2 * 8 * 8 * 1797 * 128 + 2 * 2 * 8 * 32 * 128 + 4 * 8 * 32
    flops = 4 * 8 * 32 * 1797 * 128
    b_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS_PER_S) * 1e3
    lse_row = {"name": "decode_attention (lse)", "route": "cuda",
               "source": "src/repro_torch/csrc/decode_attention.cu",
               "replaces": "src/repro/kernels/decode_attention.py:85",
               "max_abs_err": lse_err, "ms": min(k1, k2),
               "ms_runs": [k1, k2], "plain_ms": min(p1, p2),
               "bound_ms": b_ms, "bound_by": "bytes"
               if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S
               else "operations", "library_ms": None,
               "library_note": "no one PyTorch call returns the output and "
                               "its rows' log-sum-exp",
               "case": "q (8, 32, 128), K and V caches (8, 8, 1813, 128) "
                       "strided views, len 1797, bfloat16, with the rows' "
                       "lse",
               "h2o-danube-3-4b": danube_lse}
    del q, kc, vc, lse_cases

    store = common.build_dir() / "serve_shard_store"
    store.parent.mkdir(parents=True, exist_ok=True)
    store.unlink(missing_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{store}", rank=0,
                            world_size=1)
    lse_launches = 0
    try:
        rng = np.random.default_rng(0)
        plens = rng.integers(256, 2049, SERVE_BATCH)
        reqs = [rng.integers(1, 128256, int(n)).tolist() for n in plens]
        ((prompts, _),) = pad_and_batch(reqs, SERVE_BATCH)
        prompts = prompts.to(dev).to(torch.int32)
        max_len = prompts.shape[1] + SERVE_SHARD_STEPS

        rows, finals = [], {}
        for arch in ("llama3-8b",) + SERVE_SHARD_ARCHS:
            full = get_config(arch)
            cfg = full if arch == "llama3-8b" else dataclasses.replace(
                full, n_layers=SERVE_SHARD_LAYERS,
                segments=((full.segments[0][0], SERVE_SHARD_LAYERS),))
            model = init_params(cfg, 0, device=dev)
            x = prompts % cfg.vocab_size
            attn = cfg.n_layers
            decodes = 0 if cfg.attn_kind == "mla" else attn
            runs = {}
            for where in ("unsharded",) + tuple(
                    "x".join(map(str, m.values())) for m in SHARD_MESHES):
                mesh = None
                if where != "unsharded":
                    shape = SHARD_MESHES[len(where.split("x")) - 2]
                    mesh = make_host_mesh(pod=shape.get("pod"), data=1,
                                          model=1)
                    shard_model(cfg, model, mesh)
                (out, pre_ms), counts = counted_run(lambda: timed(
                    lambda: prefill(model, cfg, x, max_len)))
                logits, caches, pos = out
                pre_counts = {k: c for k, c in counts.items() if c}
                stages = [logits]
                kept = [[{n: t.clone() for n, t in seg.items()}
                         for seg in caches]]
                feeds = runs["unsharded"]["feeds"] if runs else []
                step_counts, step_ms, step_lse = [], [], []
                for i in range(SERVE_SHARD_STEPS):
                    if len(feeds) <= i:
                        feeds.append(stages[-1].argmax(-1))
                    (out, ms), counts = counted_run(lambda: timed(
                        lambda: decode_step(model, cfg, feeds[i], caches,
                                            pos + i)))
                    step_lse.append(ops.decode_attention.lse_launches)
                    stages.append(out[0])
                    step_counts.append({k: c for k, c in counts.items()
                                        if c})
                    step_ms.append(ms)
                kept.append(caches)
                runs[where] = {"stages": stages, "caches": kept,
                               "feeds": feeds}
                if mesh is not None:
                    lse_launches += sum(step_lse)
                base = runs["unsharded"]
                bits = {"logits": all(torch.equal(a, b) for a, b in zip(
                            stages, base["stages"])),
                        "caches": all(torch.equal(a[n], b[n])
                                      for ka, kb in zip(kept, base["caches"])
                                      for a, b in zip(ka, kb) for n in b)}
                want_pre = {"mha": attn}
                want_step = {"decode_attention": decodes} if decodes else {}
                ok = (all(bits.values()) and pre_counts == want_pre
                      and all(c == want_step for c in step_counts)
                      and all(n == (decodes if mesh is not None else 0)
                              for n in step_lse))
                emit({"phase": "serve_shard", "part": "serve", "arch": arch,
                      "layers": cfg.n_layers, "batch": SERVE_BATCH,
                      "prompt": int(x.shape[1]), "run": where,
                      "bitwise": bits, "prefill_launches": pre_counts,
                      "step_launches": step_counts[0],
                      "lse_launches_per_step": step_lse[0],
                      "prefill_ms": pre_ms, "step_ms": step_ms,
                      "nvidia_smi": smi, "ok": ok})
                check(ok, f"serve on a mesh, {arch} {where}: bitwise {bits},"
                          f" launches {pre_counts} {step_counts[0]} lse "
                          f"{step_lse}")
                rows.append((arch, where, pre_ms, step_ms))
                finals[where] = (model.layout, caches)
                model.layout = None
            if arch == "llama3-8b":
                # a step of the whole model and of its (1, 1) placement in
                # turns (whole, mesh, mesh, whole), SERVE_SHARD_ROUNDS
                # times, each STEPS_A_TURN steps at the last position: the
                # mesh path's own cost on a host-paced step
                turns = {"unsharded": [], "1x1": []}
                last = pos + SERVE_SHARD_STEPS - 1
                tok = runs["unsharded"]["feeds"][-1]
                for _ in range(SERVE_SHARD_ROUNDS):
                    for which in ("unsharded", "1x1", "1x1", "unsharded"):
                        model.layout, kv = finals[which]
                        turns[which] += [timed(lambda: decode_step(
                            model, cfg, tok, kv, last))[1]
                            for _ in range(STEPS_A_TURN)]
                model.layout = None
                med = {k: sorted(v)[len(v) // 2] for k, v in turns.items()}
                emit({"phase": "times", "program": "serve step on a "
                      "(1, 1) mesh, world of one", "arch": arch,
                      "order": "unsharded, 1x1, 1x1, unsharded, x "
                      f"{SERVE_SHARD_ROUNDS}, {STEPS_A_TURN} steps each",
                      "unsharded_step_ms_median": med["unsharded"],
                      "sharded_step_ms_median": med["1x1"],
                      "sharded_over_unsharded": med["1x1"]
                      / med["unsharded"], "step_ms": turns,
                      "nvidia_smi": smi})
                # where the mesh path's host time goes: the same steps of
                # each under cProfile and torch.profiler, and the port's
                # functions whose cumulative ms a step differ most
                split = {}
                for which in ("unsharded", "1x1"):
                    model.layout, kv = finals[which]
                    split[which] = host_split(lambda: decode_step(
                        model, cfg, tok, kv, last), STEPS_A_TURN)
                model.layout = None
                whole, mesh_f = (split[w].pop("functions")
                                 for w in ("unsharded", "1x1"))
                zero = [0, 0.0, 0.0]
                diff = sorted(((k, mesh_f.get(k, zero), whole.get(k, zero))
                               for k in set(whole) | set(mesh_f)),
                              key=lambda r: -abs(r[1][2] - r[2][2]))
                emit({"phase": "trace", "program": "serve step host split, "
                      "llama3-8b, whole and (1, 1) mesh", "steps":
                      STEPS_A_TURN, **split,
                      "top_own_ms_1x1": sorted(
                          ([k, *v] for k, v in mesh_f.items()),
                          key=lambda r: -r[2])[:12],
                      "columns": ["calls", "own_ms", "cum_ms"],
                      "cum_ms_1x1_minus_unsharded": [
                          {"function": k, "1x1": m, "unsharded": w,
                           "cum_diff_ms": m[2] - w[2]}
                          for k, m, w in diff[:16]],
                      "nvidia_smi": smi})
                llama = (cfg, model, x, runs["unsharded"]["feeds"])
            else:
                del model
            del runs
            finals.clear()
            torch.cuda.empty_cache()

        # (c) the counter on the card: llama3-8b's prefill and one decode
        # step on the (1, 1) mesh, then phase 2j's 4-layer train step,
        # each counted on the card and on meta stand-ins of the mesh
        cfg, model, x, feeds = llama
        mesh = make_host_mesh(data=1, model=1)
        shard_model(cfg, model, mesh)
        stand = sharding.MeshShape({"data": 1, "model": 1})

        def counted(label, call, stand_call, ms, model_flops, min_bytes):
            """call and stand_call: (fn, args), on the card and on meta;
            the arguments' own storages are left out of the peak."""
            torch.cuda.reset_peak_memory_stats()
            base_mem = torch.cuda.memory_allocated()
            out, got = count(call[0], *call[1])
            torch.cuda.synchronize()
            card_peak = torch.cuda.max_memory_allocated() - base_mem
            _, want = count(stand_call[0], *stand_call[1])
            roof = roofline.analyze(got.cost, model_flops=model_flops,
                                    chips=1, min_bytes=min_bytes)
            same = {k: getattr(got.cost, k) == getattr(want.cost, k)
                    for k in ("flops", "hbm_bytes", "coll_bytes")}
            ok = all(same.values()) and got.kernels == want.kernels
            emit({"phase": "serve_shard", "part": "counter", "call": label,
                  "card": {"flops": got.cost.flops,
                           "hbm_bytes": got.cost.hbm_bytes,
                           "coll_bytes": got.cost.coll_bytes},
                  "meta": {"flops": want.cost.flops,
                           "hbm_bytes": want.cost.hbm_bytes,
                           "coll_bytes": want.cost.coll_bytes},
                  "equal": same, "kernels": got.kernels,
                  "t_compute_ms": roof.t_compute * 1e3,
                  "t_memory_ms": roof.t_memory * 1e3,
                  "t_bound_ms": roof.t_bound * 1e3, "measured_ms": ms,
                  "measured_over_bound": ms / (roof.t_bound * 1e3),
                  "counted_peak_bytes": want.peak_bytes,
                  "card_max_memory_allocated_bytes": card_peak,
                  "nvidia_smi": smi, "ok": ok})
            check(ok, f"counter {label}: card {got.cost} kernels "
                      f"{got.kernels}, meta {want.cost} {want.kernels}")
            return out

        b, s = x.shape
        params_m, _ = launch_specs.params_struct(cfg, stand)
        x_m = torch.empty((b, s), dtype=torch.int32, device="meta")
        n_params = cfg.n_params()
        (_, caches, pos), pre_ms = timed(lambda: prefill(model, cfg, x,
                                                         max_len))
        counted("prefill, llama3-8b, B 8",
                (prefill, (model, cfg, x, max_len)),
                (prefill, (params_m, cfg, x_m, max_len)), pre_ms,
                2.0 * n_params * b * s, 2.0 * n_params)
        caches_m, _ = launch_specs.cache_struct(
            cfg, stand, InputShape("decode", max_len, b, "decode"))
        step_in = feeds[0].to(torch.int32)
        _, step_ms = timed(lambda: decode_step(model, cfg, step_in, caches,
                                               pos))
        step_m = torch.empty((b,), dtype=torch.int32, device="meta")
        counted("decode step, llama3-8b, B 8",
                (decode_step, (model, cfg, step_in, caches, pos + 1)),
                (decode_step, (params_m, cfg, step_m, caches_m, pos + 1)),
                step_ms, 2.0 * n_params * b, 2.0 * n_params)
        del llama, model, caches, params_m, caches_m
        torch.cuda.empty_cache()

        tcfg = dataclasses.replace(cfg, n_layers=SHARD_LAYERS,
                                   segments=(("attn", SHARD_LAYERS),))
        optim = AdamW(lr=TRAIN_LR)
        with partition.use_mesh(mesh):
            state = make_train_state(tcfg, init_params(tcfg, 0, device=dev),
                                     optim)
        step = make_train_step(tcfg, optim, grad_specs=dict(
            state["params"].layout.specs))
        stream = SyntheticLM(vocab_size=tcfg.vocab_size, seq_len=SHARD_SEQ,
                             batch_size=SHARD_BATCH, seed=0, device=dev)
        batch = {k: v.to(torch.int32) for k, v in stream.batch_at(0).items()}
        step(state, batch)                                    # warm-up
        _, train_ms = timed(lambda: step(state, batch))
        state_m, _ = launch_specs.train_state_struct(tcfg, stand,
                                                     AdamW(lr=TRAIN_LR))
        batch_m, _ = launch_specs.train_batch_struct(
            tcfg, stand, InputShape("train", SHARD_SEQ, SHARD_BATCH,
                                    "train"))
        train_m = make_train_step(tcfg, AdamW(lr=TRAIN_LR))
        n_train = tcfg.n_params()
        counted(f"train step, llama3-8b, {SHARD_LAYERS} layers, B "
                f"{SHARD_BATCH} x S {SHARD_SEQ}", (step, (state, batch)),
                (train_m, (state_m, batch_m)), train_ms,
                6.0 * n_train * SHARD_BATCH * SHARD_SEQ, 22.0 * n_train)
        del state, state_m
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
        store.unlink(missing_ok=True)

    # (d) the dry run, once the card's host-paced calls are timed (its
    # processes would take the host's cores from them)
    dry_dir = common.build_dir() / "dryrun"
    try:
        dry = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--all",
             "--both-meshes", "--force", "--out", str(dry_dir)],
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                     OMP_NUM_THREADS="1"), capture_output=True, text=True,
            timeout=DRYRUN_LIMIT_S)
    except subprocess.TimeoutExpired:
        check(False, f"dry run: past its {DRYRUN_LIMIT_S} s")
    text = dry.stdout + dry.stderr
    done = [ln for ln in text.splitlines() if ln.startswith("done:")]
    parts = done[-1].split() if done else []
    got = ({"ok": int(parts[1]), "skipped": int(parts[3]),
            "failed": int(parts[5]), "seconds": float(parts[8])}
           if len(parts) >= 9 else None)
    pod = []
    for path in sorted(dry_dir.glob("*__pod.json")):
        rec = json.loads(path.read_text())
        if rec.get("status") == "ok":
            r = rec["roofline"]
            pod.append([rec["arch"], rec["shape"], r["bottleneck"],
                        r["roofline_fraction"], r["useful_flops_ratio"]])
    ok = (dry.returncode == 0 and got is not None and got["failed"] == 0
          and got["ok"] == 68 and got["skipped"] == 12)
    emit({"phase": "serve_shard", "part": "dryrun", "cells": got,
          "returncode": dry.returncode,
          "processes": len(os.sched_getaffinity(0)),
          "pod_cells": pod, "ok": ok})
    check(ok, f"dry run: {done or text[-2000:]}")
    lse_row["launches"] = lse_launches
    emit({"phase": "times", "program": "phase 2k", "seconds":
          time.perf_counter() - t_2k, "nvidia_smi": smi,
          "serve_ms": [{"arch": a, "run": w, "prefill_ms": p,
                        "step_ms_median": sorted(st)[len(st) // 2]}
                       for a, w, p, st in rows]})
    return lse_row


def host_split(fn, n):
    """n calls of fn, each ended by a synchronize: under cProfile, a
    call's wall ms and each of the port's functions' calls, own ms and
    cumulative ms (`file:function`, src/repro_torch only); then under
    torch.profiler, a call's wall ms, its CPU ops' count and the card's
    kernel ms (the rest of the wall the card waits on the host)."""
    import cProfile
    import pstats

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = cProfile.Profile()
    t0 = time.perf_counter()
    prof.enable()
    for _ in range(n):
        fn()
        torch.cuda.synchronize()
    prof.disable()
    wall = (time.perf_counter() - t0) * 1e3 / n
    funcs = {}
    for (path, _, name), (_, calls, own, cum, _) in \
            pstats.Stats(prof).stats.items():
        if "repro_torch" in path:
            key = f"{pathlib.Path(path).name}:{name}"
            row = funcs.setdefault(key, [0, 0.0, 0.0])
            row[0] += calls / n
            row[1] += own * 1e3 / n
            row[2] += cum * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as tp:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
            torch.cuda.synchronize()
        traced = (time.perf_counter() - t0) * 1e3 / n
    ops = kernel_ms = 0
    for e in tp.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernel_ms += (e.time_range.end - e.time_range.start) / 1e3
        elif e.name.startswith("aten::"):
            ops += 1
    return {"profiled_ms": wall, "functions": funcs, "traced_ms": traced,
            "aten_ops": ops / n, "kernel_ms": kernel_ms / n}


def _leaves(tree):
    """The leaves of a tree of dicts, dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def kernel_class(name):
    """The class of a CUDA kernel in the train step's trace, by its
    name: cuBLAS's float32 products run the FFMA (`f32f32_f32f32`) or
    SIMT sgemm kernels, its 16-bit ones the `nvjet` or bf16/f16 `xmma`
    kernels."""
    n = name.lower()
    if "mha_kernel<" in n or "mha_wgmma_kernel<" in n:
        return "mha kernel"
    if "gemm" in n or "nvjet" in n or "xmma" in n:
        return ("float32 products" if "f32f32_f32f32" in n or "sgemm" in n
                else "16-bit products")
    if "memcpy" in n or "memset" in n:
        return "copies and sets"
    if "reduce" in n or "softmax" in n:
        return "reductions"
    if "elementwise" in n:
        return "element-wise"
    if "index" in n or "embedding" in n or "scatter" in n or "gather" in n:
        return "indexing"
    return "other"


def visible_pairs(s, window):
    """(query, key) pairs a causal, windowed self-attention of s tokens
    computes: sum over i < s of min(i + 1, window)."""
    w = min(window or s, s)
    return w * (w + 1) // 2 + (s - w) * w


def main() -> int:
    import gc

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout (src/repro_torch missing)",
              file=sys.stderr)
        return 1
    kernels, launches, smi, counted_run = earlier_phases()
    # ------------------------------------------------------------------
    # 2i. training, last: the attention gradient, llama3-8b at full width
    # cut to TRAIN_LAYERS layers through make_train_step, a restart
    # through train_loop, the train launcher; every operand of the
    # earlier phases went with their frame
    # ------------------------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    train_phase(torch.device("cuda"), smi, counted_run)
    # ------------------------------------------------------------------
    # 2j. the sharded step in a world of one, once 2i's operands are gone
    # ------------------------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    shard_phase(torch.device("cuda"), smi, counted_run)
    # ------------------------------------------------------------------
    # 2k. prefill and decode on a mesh, the cost counter, the dry run
    # ------------------------------------------------------------------
    gc.collect()
    torch.cuda.empty_cache()
    lse_row = serve_shard_phase(torch.device("cuda"), smi, counted_run)
    for entry in kernels:   # the main path's launches, 2i's, 2j's and 2k's
        entry["launches"] = launches[entry["name"]]
    kernels.append(lse_row)
    emit({"kernels": kernels})
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def earlier_phases():
    """Phases 1-5 (module docstring); returns the `kernels` line's rows,
    the launches by wrapper, the nvidia-smi line and `counted_run` for
    phases 2i and 2j."""
    import torch

    # a fresh, empty tuning table for this run: "auto" is the default,
    # and rows left in ~/.cache/repro_torch would change the plans
    table_dir = pathlib.Path(tempfile.mkdtemp(prefix="repro_torch_table_"))
    os.environ["REPRO_TORCH_CACHE_DIR"] = str(table_dir)
    atexit.register(shutil.rmtree, table_dir, True)
    sys.path.insert(0, str(ROOT / "src"))
    import triton

    from repro_torch.core import AXPYDOT_SPEC, Program, codegen
    from repro_torch.kernels import (axpy as k_axpy, axpydot as k_axpydot,
                                     common, cuda, dot as k_dot,
                                     gemm as k_gemm, gemv as k_gemv,
                                     ger as k_ger, ops, symv as k_symv,
                                     transpose as k_transpose, window)
    from repro_torch.solvers import LoopProgram, specs as solver_specs

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    emit({"phase": "header", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "triton": triton.__version__, "n": N,
          "tuning_table": str(table_dir)})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(n=N, dtype=torch.float32):
        return torch.randn(n, generator=gen, device=dev).to(dtype)

    x, y, z = randn(), randn(), randn()
    xb, yb = x.to(torch.bfloat16), y.to(torch.bfloat16)
    wrappers = list(ops.KERNELS.values()) + [codegen.group_kernel,
                                             codegen.anchored_kernel,
                                             codegen.tiled_kernel]
    errors: dict = {}
    first_call_s: dict = {}

    # ------------------------------------------------------------------
    # 1. each kernel against its plain version
    # ------------------------------------------------------------------
    eltwise = {
        "axpy": ((1.7,), 2), "scal": ((-0.3,), 1),
        "waxpby": ((0.5, -1.25), 2), "copy": ((), 1), "vmul": ((), 2),
        "rot": ((0.6, 0.8), 2)}

    def eltwise_call(fn, scalars, vecs):
        if fn.__name__.startswith("waxpby"):   # (alpha, x, beta, y)
            return fn(scalars[0], vecs[0], scalars[1], vecs[1])
        return fn(*scalars, *vecs)

    def timed_first(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        first_call_s.setdefault(name, time.perf_counter() - t0)
        return out

    for name, (scalars, k) in eltwise.items():
        plain = getattr(k_axpy, f"{name}_plain")
        cases = [("f32", (x, y)[:k]), ("f32 ragged",
                                         (x[:RAGGED], y[:RAGGED])[:k])]
        if name == "axpy":
            cases.append(("bf16", (xb, yb)))
        for case, vecs in cases:
            got = timed_first(name, lambda: eltwise_call(
                ops.KERNELS[name], scalars, vecs))
            want = eltwise_call(plain, scalars, vecs)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            scale = (1.0 + sum(abs(s) for s in scalars)) * max(
                float(v.float().abs().max()) for v in vecs)
            ulp = 2.0 ** -8 if case == "bf16" else 1e-6
            err = max(float((g.float() - w.float()).abs().max())
                      for g, w in zip(got, want))
            check(all(g.dtype == vecs[0].dtype and g.shape == vecs[0].shape
                      for g in got), f"{name} {case}: dtype/shape")
            ok = err <= ulp * scale
            emit({"phase": "kernel_vs_plain", "kernel": name, "case": case,
                  "max_abs_err": err, "tol": ulp * scale, "ok": ok})
            check(ok, f"{name} {case}: err {err} > {ulp * scale}")
            errors[name] = max(errors.get(name, 0.0), err)

    def f64_terms(name, vecs, alpha=0.9):
        """(exact value, sum of |terms|) in float64."""
        v = [t.double() for t in vecs]
        if name == "dot":
            t = v[0] * v[1]
            return float(t.sum()), float(t.abs().sum())
        if name == "asum":
            return float(v[0].abs().sum()), float(v[0].abs().sum())
        if name == "nrm2":
            s = float((v[0] * v[0]).sum())
            return s ** 0.5, s ** 0.5
        t = (v[0] - alpha * v[1]) * v[2]   # axpydot
        return float(t.sum()), float(t.abs().sum())

    reductions = {"dot": 2, "asum": 1, "nrm2": 1, "axpydot": 3}
    for name, k in reductions.items():
        cases = [("f32", (x, y, z)[:k]),
                 ("f32 ragged", (x[:RAGGED], y[:RAGGED], z[:RAGGED])[:k])]
        if name == "dot":
            cases.append(("bf16", (xb, yb)))
        for case, vecs in cases:
            if name == "axpydot":
                got = timed_first(name, lambda: ops.axpydot(0.9, *vecs))
                want = k_axpydot.axpydot_plain(0.9, *vecs)
            else:
                got = timed_first(name, lambda: getattr(ops, name)(*vecs))
                want = getattr(k_dot, f"{name}_plain")(*vecs)
            exact, mag = f64_terms(name, vecs)
            tol = 1e-5 * mag
            err = abs(float(got) - float(want))
            err64 = abs(float(got) - exact)
            ok = got.dtype == torch.float32 and err <= tol and err64 <= tol
            emit({"phase": "kernel_vs_plain", "kernel": name, "case": case,
                  "max_abs_err": err, "err_vs_f64": err64, "tol": tol,
                  "ok": ok})
            check(ok, f"{name} {case}: err {err}/{err64} > {tol}")
            errors[name] = max(errors.get(name, 0.0), err)

    # the generated group kernel of AXPYDOT_SPEC's dataflow plan
    neg_alpha = -0.7
    programs = {m: Program.from_spec(AXPYDOT_SPEC, mode=m, device="cuda")
                for m in ("dataflow", "nodataflow", "reference")}
    prog = programs["dataflow"]
    group_run = codegen.make_group_callable(
        prog.graph, prog.groups[0], torch.float32)
    group_scalars = {k: neg_alpha for k in group_run.signature.scalar_keys}
    check(set(group_run.signature.vec_in_keys) == {
        ("zcalc", "x"), ("zcalc", "y"), ("zdot", "y")},
        "axpydot group signature")

    def group_vecs(w, v, u):
        return {("zcalc", "x"): v, ("zcalc", "y"): w, ("zdot", "y"): u}

    for case, vecs in (("f32", (x, y, z)),
                       ("f32 ragged", (x[:RAGGED], y[:RAGGED],
                                       z[:RAGGED]))):
        got = timed_first("group_kernel", lambda: group_run(
            group_scalars, group_vecs(*vecs)))[("zdot", "out")]
        want = group_run.plain(group_scalars,
                               group_vecs(*vecs))[("zdot", "out")]
        exact, mag = f64_terms("axpydot", vecs, alpha=-neg_alpha)
        tol = 1e-5 * mag
        err, err64 = abs(float(got) - float(want)), abs(float(got) - exact)
        ok = err <= tol and err64 <= tol
        emit({"phase": "kernel_vs_plain", "kernel": "group_kernel",
              "case": case, "max_abs_err": err, "err_vs_f64": err64,
              "tol": tol, "ok": ok})
        check(ok, f"group kernel {case}: err {err}/{err64} > {tol}")
        errors["group_kernel"] = max(errors.get("group_kernel", 0.0), err)

    # equal |max| in two programs of the walk, in steps 1 and 3 of one
    # program, and in two lanes of one step: the first index wins
    tie = torch.zeros(N, device=dev)
    b = window.BLOCK
    _, share = window.grid(N, common.sm_count(dev), True)
    first = 5 * share + b + 17     # program 5, its second step
    for pos, val in ((first, 7.0), (first + 100, -7.0),
                     (5 * share + 3 * b + 3, 7.0), (9 * share + 9, -7.0),
                     (N - 1, 7.0), (5, 6.5)):
        tie[pos] = val
    iamax_cases = [("f32", x), ("f32 ragged", x[:RAGGED]),
                   ("ties across programs, steps and lanes", tie)]
    for case, vec in iamax_cases:
        got = int(timed_first("iamax", lambda: ops.iamax(vec)))
        want = int(k_dot.iamax_plain(vec))
        ok = got == want and (vec is not tie or got == first)
        emit({"phase": "kernel_vs_plain", "kernel": "iamax", "case": case,
              "got": got, "want": want, "ok": ok})
        check(ok, f"iamax {case}: {got} != {want}")
    errors["iamax"] = 0.0

    # the window walk's edges: one element, one step of BLOCK +- 1, one
    # wave of programs times BLOCK +- 1; every level-1 body against its
    # plain version under the tolerances above
    wave = window.PROGRAMS_PER_SM * common.sm_count(dev) * b
    for n_edge in (1, b - 1, b + 1, wave - 1, wave + 1):
        vx, vy, vz = x[:n_edge], y[:n_edge], z[:n_edge]
        worst = 0.0
        for name, (scalars, k) in eltwise.items():
            vecs = (vx, vy)[:k]
            got = eltwise_call(ops.KERNELS[name], scalars, vecs)
            want = eltwise_call(getattr(k_axpy, f"{name}_plain"), scalars,
                                vecs)
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            scale = (1.0 + sum(abs(s) for s in scalars)) * max(
                float(v.abs().max()) for v in vecs)
            err = max(float((g - w).abs().max()) for g, w in zip(got, want))
            worst = max(worst, err / (1e-6 * scale))
            errors[name] = max(errors[name], err)
        for name, k in reductions.items():
            vecs = (vx, vy, vz)[:k]
            if name == "axpydot":
                got = ops.axpydot(0.9, *vecs)
                want = k_axpydot.axpydot_plain(0.9, *vecs)
            else:
                got = getattr(ops, name)(*vecs)
                want = getattr(k_dot, f"{name}_plain")(*vecs)
            exact, mag = f64_terms(name, vecs)
            err = abs(float(got) - float(want))
            worst = max(worst, err / (1e-5 * mag),
                        abs(float(got) - exact) / (1e-5 * mag))
            errors[name] = max(errors[name], err)
        idx, idx_plain = int(ops.iamax(vx)), int(k_dot.iamax_plain(vx))
        ok = worst <= 1.0 and idx == idx_plain
        emit({"phase": "kernel_vs_plain", "kernel": "window walk",
              "case": f"n = {n_edge}", "grid": window.grid(
                  n_edge, common.sm_count(dev), True),
              "max_err_over_tol": worst, "iamax": [idx, idx_plain],
              "ok": ok})
        check(ok, f"window walk at n = {n_edge}: outside its tolerance")

    # ------------------------------------------------------------------
    # 1b. the level-2 kernels and the anchored generator, at n = 16384
    # ------------------------------------------------------------------
    t0 = time.perf_counter()
    cuda.build()     # one nvcc per csrc/*.cu, all started together
    nvcc_s = time.perf_counter() - t0
    # registers and spill bytes of every CUDA kernel (ptxas -v of the
    # build); gemm's and symv's mainloops must not spill
    ptxas = {stem: cuda.ptxas_report(stem) for stem in cuda.ENTRIES}
    spills = {name: r for stem in ("gemm", "symv")
              for name, r in ptxas[stem].items()
              if r["spill_stores"] or r["spill_loads"]}
    emit({"phase": "ptxas", "kernels": ptxas, "gemm_symv_spills": spills,
          "ok": not spills})
    check(not spills, f"csrc/gemm.cu or csrc/symv.cu kernels spill: "
                      f"{spills}")

    def randn2(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    A = randn2(N2, N2)
    A = (A + A.T).mul_(0.5)       # exactly symmetric: S = A
    xa, ya = randn2(N2), randn2(N2)
    Ag = randn2(*RAGGED2)
    xg, yg = randn2(RAGGED2[1]), randn2(RAGGED2[0])
    As = A[:RAGGED2[0], :RAGGED2[0]].contiguous()
    V, h, w = randn2(*BASIS), randn2(BASIS[0]), randn2(BASIS[1])
    # the same basis one element into a larger buffer: an odd base
    # address, which the gemvt kernels take by the ldg route
    V_off = torch.empty(V.numel() + 1, device=dev)[1:].view(BASIS)
    V_off.copy_(V)
    # GMRES(20)'s (21, 16384) basis, which every inner step projects on,
    # from a generator of its own, so that every operand drawn after it
    # is the one drawn without it
    gen21 = torch.Generator(device=dev).manual_seed(21)
    W21, w21, h21 = (torch.randn(*shape, generator=gen21, device=dev)
                     for shape in (GMRES_BASIS, GMRES_BASIS[1:],
                                   GMRES_BASIS[:1]))
    Ab, xab, yab = (t.to(torch.bfloat16) for t in (A, xa, ya))
    A64 = A.double()
    absA64 = A64.abs()
    alpha2, beta2 = 1.3, -0.7

    def matvec64(a, x, transposed=False, sym=False):
        """(A x, sum_j |A_ij x_j|) in float64; Aᵀ or S from A's lower
        triangle on request."""
        if a is A and not sym:
            a64, abs64 = A64, absA64
        else:
            a64 = a.double()
            if sym:
                a64 = torch.tril(a64) + torch.tril(a64, -1).T
            abs64 = a64.abs()
        if transposed:
            a64, abs64 = a64.T, abs64.T
        x64 = x.double()
        return a64 @ x64, abs64 @ x64.abs()

    def rows_check(kernel, case, got, want, a, x, y, transposed=False,
                   sym=False):
        prod, mag = matvec64(a, x, transposed, sym)
        y64 = y.double()
        bounded_check(kernel, case, got, want, alpha2 * prod + beta2 * y64,
                      1e-5 * abs(alpha2) * mag
                      + 1e-6 * abs(beta2) * y64.abs(), a.dtype)

    def bounded_check(kernel, case, got, want, exact, tol, dtype):
        """Each element of `got` within `tol` of the plain version's
        `want` and of the float64 `exact`; in bfloat16 or float16 each
        side rounds its element once, so half a unit of the dtype of each
        is added (2**-8 and 2**-11 of the element)."""
        g, w = got.double(), want.double()
        tol_plain, tol64 = tol, tol
        half = {torch.bfloat16: 2.0 ** -8, torch.float16: 2.0 ** -11}
        if got.dtype in half:
            tol_plain = tol + half[got.dtype] * (g.abs() + w.abs())
            tol64 = tol + half[got.dtype] * g.abs()
        err = (g - w).abs()
        err64 = (g - exact).abs()
        ok = (got.dtype == dtype and got.shape == want.shape
              and bool(torch.isfinite(g).all())
              and bool((err <= tol_plain).all())
              and bool((err64 <= tol64).all()))
        emit({"phase": "kernel_vs_plain", "kernel": kernel, "case": case,
              "max_abs_err": float(err.max()),
              "max_err_vs_f64": float(err64.max()),
              "max_err_over_tol": max(float((err / tol_plain).max()),
                                      float((err64 / tol64).max())),
              "ok": ok})
        check(ok, f"{kernel} {case}: outside the element tolerance")
        errors[kernel] = max(errors.get(kernel, 0.0), float(err.max()))

    mv_cases = [
        ("gemv", "f32 16384^2", A, xa, ya, False),
        ("gemv", "f32 ragged 16381x16379", Ag, xg, yg, False),
        ("gemv", "bf16 16384^2", Ab, xab, yab, False),
        ("gemv", "f32 (31, 2^20)", V, w, h, False),
        ("gemv", "f32 (31, 2^20) offset view", V_off, w, h, False),
        ("gemv", "f32 (21, 16384) GMRES basis", W21, w21, h21, False),
        ("gemvt", "f32 16384^2", A, ya, xa, True),
        ("gemvt", "f32 ragged 16381x16379", Ag, yg, xg, True),
        ("gemvt", "bf16 16384^2", Ab, yab, xab, True),
        ("gemvt", "f32 (31, 2^20)", V, h, w, True),
        ("gemvt", "f32 (31, 2^20) offset view", V_off, h, w, True),
    ]
    # each case's route. gemvt: TMA where A's base and rows are 16-byte
    # multiples, else ldg (16379 float32 columns, the offset view). gemv:
    # one warp per row where the rows fill the card, else the band
    # kernel by TMA, or by ldg for the offset view
    mv_routes = {
        "gemvt": {"f32 16384^2": "tma", "f32 ragged 16381x16379": "ldg",
                  "bf16 16384^2": "tma", "f32 (31, 2^20)": "tma",
                  "f32 (31, 2^20) offset view": "ldg"},
        "gemv": {"f32 16384^2": "rows", "f32 ragged 16381x16379": "rows",
                 "bf16 16384^2": "rows", "f32 (31, 2^20)": "tma",
                 "f32 (31, 2^20) offset view": "ldg",
                 "f32 (21, 16384) GMRES basis": "tma"}}
    for name, case, a, xv, yv, tr in mv_cases:
        wrapper = getattr(ops, name)
        before = dict(wrapper.route_launches)
        combines = wrapper.finish_launches
        got = timed_first(name, lambda: wrapper(alpha2, a, xv, beta2, yv))
        want = getattr(k_gemv, f"{name}_plain")(alpha2, a, xv, beta2, yv)
        rows_check(name, case, got, want, a, xv, yv, transposed=tr)
        # one launch a call on the case's route, no combine, and the
        # same bits from a second call
        again = wrapper(alpha2, a, xv, beta2, yv)
        took = {r: c - before[r] for r, c in wrapper.route_launches.items()
                if c != before[r]}
        route = mv_routes[name][case]
        plan = (k_gemv.gemvt_plan_for(a) if tr
                else k_gemv.gemv_plan_for(a))
        ok = (took == {route: 2} and wrapper.finish_launches == combines
              and bool(torch.equal(got, again)))
        emit({"phase": "kernel_vs_plain", "kernel": name, "case": case,
              "routes": took, "plan": str(plan),
              "combines": wrapper.finish_launches - combines,
              "bitwise_repeat": bool(torch.equal(got, again)), "ok": ok})
        check(ok, f"{name} {case}: routes {took} (want {route}), a "
                  f"combine, or not repeatable")
        del again
    r0 = RAGGED2[0]
    # 16384^2 by TMA, the ragged 16381^2 (rows of 65524 bytes) by the
    # ldg route, bfloat16, and orders around symv's 64-row tiles
    symv_cases = [("f32 16384^2", A, xa, ya, "tma"),
                  ("f32 ragged 16381^2", As, xa[:r0], ya[:r0], "ldg"),
                  ("bf16 16384^2", Ab, xab, yab, "tma")]
    symv_cases += [(f"f32 {m}^2", A[:m, :m].contiguous(), xa[:m], ya[:m],
                    "tma" if m % 4 == 0 else "ldg") for m in SYMV_EDGES]
    symv_case_routes = {}
    for case, a, xv, yv, route in symv_cases:
        before = dict(ops.symv.route_launches)
        got = timed_first("symv", lambda: ops.symv(alpha2, a, xv, beta2,
                                                     yv))
        took = [r for r, c in ops.symv.route_launches.items()
                if c != before[r]]
        want = k_symv.symv_plain(alpha2, a, xv, beta2, yv)
        rows_check("symv", case, got, want, a, xv, yv, sym=True)
        check(took == [route], f"symv {case}: route {took}, want {route}")
        symv_case_routes[case] = took[0]
        if a is A:
            symv_on_a = got
    upper = torch.ones(N2, N2, dtype=torch.bool, device=dev).triu_(1)
    A_nan = A.masked_fill(upper, float("nan"))
    del upper
    got_nan = ops.symv(alpha2, A_nan, xa, beta2, ya)
    ok = (bool(torch.isfinite(got_nan).all())
          and bool(torch.equal(got_nan, symv_on_a)))
    emit({"phase": "kernel_vs_plain", "kernel": "symv",
          "case": "NaN upper triangle", "finite_and_equal": ok, "ok": ok})
    check(ok, "symv reads the upper triangle")

    # the anchored generator: each anchor kind against its plain splice
    # and float64, at the main path's shapes and at ragged ones
    l2_specs = dict(SOLVER_SPECS, SYMV_DOT=SYMV_DOT)
    l2_programs = {name: {m: Program.from_spec(raw, mode=m, device="cuda")
                          for m in ("dataflow", "nodataflow", "reference")}
                   for name, raw in l2_specs.items()}
    l2_inputs = {
        "CG_MATVEC": dict(A=A, p=xa), "RESIDUAL": dict(A=A, x=xa, b=ya),
        "BICG_MATVEC2": dict(A=A, s=xa), "POWER_STEP": dict(A=A, v=xa),
        "GMRES_ORTH": dict(V=V, h=h, w=w), "SYMV_DOT": dict(A=A, x=xa)}

    # float64 results and error bounds of every output of those programs
    x64, y64 = xa.double(), ya.double()
    q64, qmag = matvec64(A, xa)
    tq = 1e-5 * qmag                      # bound on each row of A x

    def dot_bound(u, tu, v, tv):
        return float(1e-5 * (u * v).abs().sum() + (u.abs() * tv).sum()
                     + (tu * v.abs()).sum())

    def norm_bound(u, tu):
        return float(tu.norm() + 1e-5 * u.norm())

    r64 = y64 - q64
    tr_ = tq + 1e-6 * y64.abs()
    vt64, vtmag = matvec64(V, h, transposed=True)
    w2_64 = w.double() - vt64
    tw2 = 1e-5 * vtmag + 1e-6 * w.double().abs()
    pq = (float(x64 @ q64), dot_bound(x64, 0, q64, tq))
    l2_exact = {
        "CG_MATVEC": {"q": (q64, tq), "pq": pq},
        "RESIDUAL": {"r": (r64, tr_),
                     "rnorm": (float(r64.norm()), norm_bound(r64, tr_))},
        "BICG_MATVEC2": {"t": (q64, tq),
                         "tt": (float(q64 @ q64), dot_bound(q64, tq, q64,
                                                            tq)),
                         "ts": pq},
        "POWER_STEP": {"av": (q64, tq),
                       "norm": (float(q64.norm()), norm_bound(q64, tq)),
                       "lambda": pq},
        "GMRES_ORTH": {"w2": (w2_64, tw2),
                       "hnorm": (float(w2_64.norm()),
                                 norm_bound(w2_64, tw2))},
        "SYMV_DOT": {"q": pq},
    }

    def outputs_close(got, want, exact):
        """Worst |got - want| and |got - exact| over each output's
        bound; both must be <= 1."""
        worst = 0.0
        for key, (ex, tol) in exact.items():
            g = got[key].double() if torch.is_tensor(got[key]) else got[key]
            wv = want[key].double()
            check(bool(torch.isfinite(torch.as_tensor(g)).all()),
                  f"{key} is not finite")
            for ref in (wv, ex):
                worst = max(worst, float(((g - ref).abs() / tol).max()))
        return worst

    def reductions_close(key, got, inputs):
        """Worst |got - f64| over 1e-5 * sum|terms| of each reduction in
        REDUCTIONS[key], f64 from the vectors in `got` itself; None for a
        program that returns no vector to reduce (SYMV_DOT)."""
        if key not in REDUCTIONS:
            return None
        worst = 0.0
        for out, u, v in REDUCTIONS[key]:
            u64 = got[u].double()
            if v is None:
                want = float(u64.norm())
                tol = 1e-5 * want
            else:
                terms = u64 * (got[v] if v in got else inputs[v]).double()
                want, tol = float(terms.sum()), 1e-5 * float(
                    terms.abs().sum())
            worst = max(worst, abs(float(got[out]) - want) / tol)
        return worst

    def group_args(prog, run, inputs):
        bind = {(pi.routine, pi.port): inputs[pi.name]
                for pi in prog.graph.inputs}
        scal = {}
        for rn, sn in run.signature.scalar_keys:
            b = prog.graph.nodes[rn].scalars[sn]
            scal[(rn, sn)] = b.value if b.kind == "value" else \
                inputs[b.input_name]
        return scal, {k: bind[k] for k in run.signature.vec_in_keys}

    # SYMV_DOT returns only its dot; this copy also returns s = S x, so
    # that its rows and its reduction are checked apart
    symv_s = json.loads(json.dumps(SYMV_DOT))
    symv_s["name"] = "symv_dot_s"
    symv_s["routines"][0]["outputs"] = {"out": "s"}
    symv_s_prog = Program.from_spec(symv_s, mode="dataflow", device="cuda")
    qg64, qgmag = matvec64(Ag, xg)
    rg64 = yg.double() - qg64
    trg = 1e-5 * qgmag + 1e-6 * yg.double().abs()
    xs, (qs64, qsmag) = xa[:r0], matvec64(As, xa[:r0], sym=True)
    tqs = 1e-5 * qsmag
    xs64 = xs.double()
    l2_df = {name: progs["dataflow"] for name, progs in l2_programs.items()}
    anchored_cases = [
        # (case, REDUCTIONS key, program, anchor, inputs, float64 outputs,
        #  the product's route: none for the gemv anchor)
        ("CG_MATVEC 16384^2", "CG_MATVEC", l2_df["CG_MATVEC"], "gemv",
         l2_inputs["CG_MATVEC"], l2_exact["CG_MATVEC"], None),
        # not symmetric, so a walk of Aᵀ would differ; both axes ragged
        ("RESIDUAL ragged 16381x16379", "RESIDUAL", l2_df["RESIDUAL"],
         "gemv", dict(A=Ag, x=xg, b=yg),
         {"r": (rg64, trg),
          "rnorm": (float(rg64.norm()), norm_bound(rg64, trg))}, None),
        ("GMRES_ORTH (31, 2^20)", "GMRES_ORTH", l2_df["GMRES_ORTH"],
         "gemvt", l2_inputs["GMRES_ORTH"], l2_exact["GMRES_ORTH"],
         "gemvt/tma"),
        ("GMRES_ORTH (31, 2^20) offset view", "GMRES_ORTH",
         l2_df["GMRES_ORTH"], "gemvt", dict(V=V_off, h=h, w=w),
         l2_exact["GMRES_ORTH"], "gemvt/ldg"),
        ("SYMV_DOT + s 16384^2", "SYMV_DOT_S", symv_s_prog, "symv",
         dict(A=A, x=xa), {"s": (q64, tq), "q": pq}, "symv/tma"),
        ("SYMV_DOT + s ragged 16381^2", "SYMV_DOT_S", symv_s_prog, "symv",
         dict(A=As, x=xs),
         {"s": (qs64, tqs),
          "q": (float(xs64 @ qs64), dot_bound(xs64, 0, qs64, tqs))},
         "symv/ldg"),
    ]
    anchored_runs = {}
    for case, key, aprog, kind, inputs, exact, route in anchored_cases:
        check(len(aprog.groups) == 1 and aprog.groups[0].anchor is not None,
              f"{case}: one anchored group")
        run = codegen.make_anchored_callable(aprog.graph, aprog.groups[0],
                                             torch.float32)
        check(run.body.anchor == kind, f"{case}: a {kind} anchor")
        scal, vecs = group_args(aprog, run, inputs)
        anchored_runs.setdefault(key, (run, scal, vecs))
        before = dict(codegen.anchored_kernel.route_launches)
        got = timed_first("anchored_kernel", lambda: run(scal, vecs))
        took = {r: c - before[r]
                for r, c in codegen.anchored_kernel.route_launches.items()
                if c != before[r]}
        again = run(scal, vecs)
        repeat = all(bool(torch.equal(got[k], again[k])) for k in got)
        del again
        ok = took == ({route: 1} if route else {}) and repeat
        emit({"phase": "kernel_vs_plain", "kernel": "anchored_kernel",
              "case": f"{kind} anchor, {case}", "product_routes": took,
              "bitwise_repeat": repeat, "ok": ok})
        check(ok, f"anchored {kind} group ({case}): product routes {took} "
                  f"(want {route}) or not bitwise repeatable")
        want = run.plain(scal, vecs)
        out_keys = {o.name: (o.routine, o.port)
                    for o in aprog.graph.outputs}
        named = lambda res: {o: res[k] for o, k in out_keys.items()}
        worst = outputs_close(named(got), named(want), exact)
        worst_red = reductions_close(key, named(got), inputs)
        err = max(float((got[k].double() - want[k].double()).abs().max())
                  for k in got)
        ok = worst <= 1.0 and worst_red <= 1.0
        emit({"phase": "kernel_vs_plain", "kernel": "anchored_kernel",
              "case": f"{kind} anchor, {case}", "max_abs_err": err,
              "max_err_over_tol": worst,
              "reduction_err_over_tol": worst_red, "ok": ok})
        check(ok, f"anchored {kind} group ({case}) disagrees with its "
                  f"plain splice or float64")
        errors["anchored_kernel"] = max(errors.get("anchored_kernel", 0.0),
                                        err)
    # the symv anchor on a NaN upper triangle, on both of its product's
    # routes (16384^2 by TMA, the ragged 16381^2 by ldg)
    run, scal, vecs = anchored_runs["SYMV_DOT_S"]
    upper = torch.ones(r0, r0, dtype=torch.bool, device=dev).triu_(1)
    As_nan = As.masked_fill(upper, float("nan"))
    del upper
    for case, a, a_nan, xv in (("16384^2", A, A_nan, xa),
                               ("ragged 16381^2", As, As_nan, xs)):
        clean_vecs = {k: (a if v is A else xv if v is xa else v)
                      for k, v in vecs.items()}
        nan_vecs = {k: (a_nan if v is a else v)
                    for k, v in clean_vecs.items()}
        before = dict(codegen.anchored_kernel.route_launches)
        got_nan, got_a = run(scal, nan_vecs), run(scal, clean_vecs)
        took = {r: c - before[r]
                for r, c in codegen.anchored_kernel.route_launches.items()
                if c != before[r]}
        ok = all(bool(torch.isfinite(got_nan[k]).all())
                 and bool(torch.equal(got_nan[k], got_a[k])) for k in got_a)
        emit({"phase": "kernel_vs_plain", "kernel": "anchored_kernel",
              "case": f"symv anchor, NaN upper triangle, {case}",
              "product_routes": took, "finite_and_equal": ok, "ok": ok})
        check(ok, f"the symv-anchored group reads the upper triangle "
                  f"({case})")
    del As_nan
    # ------------------------------------------------------------------
    # 1c. gemm and the tiled generator (level 3), at block-CG's shapes
    # ------------------------------------------------------------------
    m_g, k_g = RAGGED2
    Bp, Cp, Yp = randn2(N2, S_BLOCK), randn2(N2, S_BLOCK), randn2(N2, S_BLOCK)
    Bg, Cg, Yg = randn2(k_g, S_RAGGED), randn2(m_g, S_RAGGED), \
        randn2(m_g, S_RAGGED)
    ap, ag = randn2(S_BLOCK), randn2(S_RAGGED)
    Asq = Ag[:k_g]                # 16379 x 16379, not symmetric
    Ag64 = Ag.double()
    absAg64 = Ag64.abs()

    def gemm64(a, b):
        """(A B, sum_k |A_ik B_kj|) in float64."""
        if a is A:
            al64, abs64 = A64, absA64
        elif a is Ag or a is Asq:
            al64, abs64 = Ag64[:a.shape[0]], absAg64[:a.shape[0]]
        else:
            al64 = a.double()
            abs64 = al64.abs()
        b64 = b.double()
        return al64 @ b64, abs64 @ b64.abs()

    sq = [randn2(SQUARE, SQUARE) for _ in range(3)]
    # the 16-bit cases, kept for their times in section 4 (all on the
    # wgmma route): 4096^3 in bfloat16 and float16 and llama3-8b's dense
    # shapes in bfloat16; block-CG's bfloat16 product is checked here and
    # made again from A there, so that Ab goes with phase 1
    gemm16 = {f"{dt} 4096^3": [x.to(getattr(torch, dt)) for x in sq]
              for dt in ("bfloat16", "float16")}
    for label, m_, k_, n_ in GEMM16_SHAPES:
        gemm16[f"bfloat16 {label} ({m_}, {k_}) . ({k_}, {n_})"] = [
            (randn2(*s_) * scale_).to(torch.bfloat16) for s_, scale_ in (
                ((m_, k_), 1.0), ((k_, n_), k_ ** -0.5), ((m_, n_), 1.0))]
    gemm_cases = [
        ("f32 16384^2 x 32", A, Bp, Cp),
        ("f32 ragged 16381x16379 x 29", Ag, Bg, Cg),
        ("f32 4096^3", *sq),
        ("bfloat16 16384^2 x 32", Ab, Bp.to(torch.bfloat16),
         Cp.to(torch.bfloat16)),
        *[(case, *ops_) for case, ops_ in gemm16.items()],
    ]
    for case, a, bm_, c in gemm_cases:
        route = k_gemm.gemm_route(a, bm_)
        check(route == ("wgmma" if a.dtype != torch.float32 else
                        ("ldg" if "ragged" in case else "tma")),
              f"gemm {case}: route {route}")
        kname = "gemm (wgmma)" if route == "wgmma" else "gemm"
        got = timed_first(kname, lambda: ops.gemm(alpha2, a, bm_, beta2, c))
        want = k_gemm.gemm_plain(alpha2, a, bm_, beta2, c)
        prod, mag = gemm64(a, bm_)
        c64 = c.double()
        bounded_check(kname, f"{case} route {route}", got, want,
                      alpha2 * prod + beta2 * c64,
                      1e-5 * abs(alpha2) * mag + 1e-6 * abs(beta2)
                      * c64.abs(), c.dtype)
        del prod, mag, c64, got, want
    del sq

    def colsum_bound(x, tx, y, ty):
        """Per column: 1e-5 * sum|x y| + the operands' bounds carried
        through the products (sum |x| ty + tx |y|)."""
        return (1e-5 * (x * y).abs() + x.abs() * ty + tx * y.abs()).sum(0)

    def tiled_case(raw, inputs):
        """A dataflow program's tiled group, its callable and bindings."""
        tprog = Program.from_spec(raw, mode="dataflow", device="cuda")
        (group,) = [g for g in tprog.groups if g.anchor is not None]
        run = codegen.make_tiled_callable(tprog.graph, group, torch.float32)
        scal, vecs = group_args(tprog, run, inputs)
        return tprog, run, scal, vecs

    tiled_inputs = {
        "BLOCK_CG_MATVEC": [("16384^2 x 32", dict(A=A, P=Bp)),
                            ("ragged 16379^2 x 29, not symmetric",
                             dict(A=Asq, P=Bg))],
        "BLOCK_RESIDUAL": [("16384^2 x 32", dict(A=A, X=Bp, B=Cp)),
                           ("ragged 16381x16379 x 29",
                            dict(A=Ag, X=Bg, B=Cg))],
        "GEMM_COLAXPY_COLDOT": [
            ("16384^2 x 32", dict(A=A, B=Bp, C0=Cp, Y0=Yp, alphas=ap)),
            ("ragged 16381x16379 x 29",
             dict(A=Ag, B=Bg, C0=Cg, Y0=Yg, alphas=ag))],
    }
    tiled_specs = {"BLOCK_CG_MATVEC": solver_specs.BLOCK_CG_MATVEC,
                   "BLOCK_RESIDUAL": solver_specs.BLOCK_RESIDUAL,
                   "GEMM_COLAXPY_COLDOT": GEMM_COLAXPY_COLDOT}
    tiled_runs = {}
    for name, cases in tiled_inputs.items():
        for case, inputs in cases:
            tprog, run, scal, vecs = tiled_case(tiled_specs[name], inputs)
            tiled_runs.setdefault(name, (run, scal, vecs))
            got = timed_first("tiled_kernel", lambda: run(scal, vecs))
            want = run.plain(scal, vecs)
            out = {o.name: (o.routine, o.port) for o in tprog.graph.outputs}
            gt = {k: got[key].double() for k, key in out.items()
                 if key in got}
            wt = {k: want[key].double() for k, key in out.items()
                 if key in want}
            # float64 tile outputs and their bounds
            a = inputs["A"]
            if name == "BLOCK_CG_MATVEC":     # q = A P; pq = diag(Pᵀq)
                prod, mag = gemm64(a, inputs["P"])
                p64 = inputs["P"].double()
                tiles = {"q": (prod, 1e-5 * mag)}
                cols = {"pq": (p64, 0.0, gt["q"], 1e-5 * mag)}
            elif name == "BLOCK_RESIDUAL":    # r0 = B - A X; diag(r0ᵀr0)
                prod, mag = gemm64(a, inputs["X"])
                b64 = inputs["B"].double()
                t_r = 1e-5 * mag + 1e-6 * b64.abs()
                tiles = {"r0": (b64 - prod, t_r)}
                cols = {"rz0": (gt["r0"], t_r, gt["r0"], t_r)}
            else:                     # Q = A B; R = a Q + Y0; diag(RᵀR)
                prod, mag = gemm64(a, inputs["B"])
                al64 = inputs["alphas"].double()
                yy64 = inputs["Y0"].double()
                t_q = 1e-5 * mag + 1e-6 * inputs["C0"].double().abs()
                r64 = al64 * prod + yy64
                t_r = al64.abs() * t_q + 1e-6 * ((al64 * prod).abs()
                                                + yy64.abs())
                tiles = {"Q": (prod, t_q), "R": (r64, t_r)}
                cols = {"rz": (gt["R"], t_r, gt["R"], t_r)}
            worst, worst_col = 0.0, 0.0
            for key, (ex, tol) in tiles.items():
                check(bool(torch.isfinite(gt[key]).all()), f"{key} finite")
                worst = max(worst, float(((gt[key] - wt[key]).abs()
                                          / tol).max()),
                            float(((gt[key] - ex).abs() / tol).max()))
            for key, (xx64, tx, y64_, ty) in cols.items():
                terms = xx64 * y64_
                exact64 = terms.sum(0)
                worst_col = max(
                    worst_col,
                    float(((gt[key] - exact64).abs()
                           / (1e-5 * terms.abs().sum(0))).max()),
                    float(((gt[key] - wt[key]).abs()
                           / colsum_bound(xx64, tx, y64_, ty)).max()))
            err = max(float((got[k].double() - want[k].double()).abs().max())
                      for k in got)
            ok = worst <= 1.0 and worst_col <= 1.0 and all(
                got[k].dtype == torch.float32 for k in got)
            emit({"phase": "kernel_vs_plain", "kernel": "tiled_kernel",
                  "case": f"{name} {case}", "max_abs_err": err,
                  "max_err_over_tol": worst,
                  "column_err_over_tol": worst_col, "ok": ok})
            check(ok, f"tiled group {name} ({case}) disagrees with its "
                      f"plain splice or float64")
            errors["tiled_kernel"] = max(errors.get("tiled_kernel", 0.0),
                                         err)
            del prod, mag, tiles, cols
    del Ag64, absAg64, Asq, Bg, Cg, Yg

    # ------------------------------------------------------------------
    # 1d. transpose and ger (CUDA C++), at 16384^2, ragged, in bfloat16
    #     and at GMRES's (20, 21) Hessenberg shape
    # ------------------------------------------------------------------
    An = randn2(N2, N2)              # not symmetric: Aᵀ differs from A
    xn, yn = randn2(N2), randn2(N2)
    small = (randn2(*HESSENBERG), randn2(HESSENBERG[0]),
             randn2(HESSENBERG[1]))
    matrix_cases = [
        ("f32 16384^2", An, xn, yn),
        ("f32 ragged 16381x16379", Ag, yg, xg),
        ("bf16 16384^2", *(t.to(torch.bfloat16) for t in (An, xn, yn))),
        ("f32 (20, 21)", *small),
    ]
    for case, a, xv, yv in matrix_cases:
        got = timed_first("transpose", lambda: ops.transpose(a))
        ok = (got.dtype == a.dtype and got.is_contiguous()
              and bool(torch.equal(got, k_transpose.transpose_plain(a)))
              and bool(torch.equal(got, a.t())))
        emit({"phase": "kernel_vs_plain", "kernel": "transpose",
              "case": case, "bitwise_equal": ok, "ok": ok})
        check(ok, f"transpose {case}: not bitwise A.t()")
        errors["transpose"] = 0.0
        del got
        a_before = a.clone()
        got = timed_first("ger", lambda: ops.ger(GER_ALPHA, xv, yv, a))
        want = k_ger.ger_plain(GER_ALPHA, xv, yv, a)
        outer64 = GER_ALPHA32 * torch.outer(xv.double(), yv.double())
        a64 = a.double()
        exact = outer64 + a64
        terms = outer64.abs_().add_(a64.abs_())
        del outer64, a64
        g = got.double()
        # half a unit of the output dtype, plus the float32 steps'
        # two roundings of the terms
        half = 2.0 ** -8 if a.dtype == torch.bfloat16 else 2.0 ** -24
        tol = terms.mul_(2.0 ** -23).add_(half * g.abs())
        err64 = (g - exact).abs_()
        err = (g - want.double()).abs_()
        ok = (got.dtype == a.dtype and got.shape == a.shape
              and bool(torch.equal(a, a_before))
              and bool((err64 <= tol).all()) and bool((err <= 2 * tol).all()))
        emit({"phase": "kernel_vs_plain", "kernel": "ger", "case": case,
              "max_abs_err": float(err.max()),
              "max_err_vs_f64": float(err64.max()),
              "max_err_over_tol": float((err64 / tol).max()),
              "bitwise_equal_to_plain": bool(torch.equal(got, want)),
              "a_unchanged": bool(torch.equal(a, a_before)), "ok": ok})
        check(ok, f"ger {case}: outside its tolerance, or A was written")
        errors["ger"] = max(errors.get("ger", 0.0), float(err.max()))
        del got, want, exact, tol, err64, err, g, a_before, terms
    del A_nan, As, Ag, Ab

    # ------------------------------------------------------------------
    # 2. the main path, counted
    # ------------------------------------------------------------------
    launches = {w.__name__: 0 for w in wrappers}
    finishes = {w.__name__: 0 for w in wrappers}
    folds = {w.__name__: 0 for w in wrappers}
    # launches per route over the main path (gemm's; the tiled groups'
    # products; the attention kernels')
    route_totals = {w.__name__: dict.fromkeys(w.route_launches, 0)
                    for w in wrappers if hasattr(w, "route_launches")}
    # gemm's wgmma route has a row of its own in the kernels line
    launches["gemm (wgmma)"] = 0

    # the last counted run's launches per route, by wrapper (nonzero)
    last_routes: dict = {}

    def counted_run(fn):
        common.reset_counts(*wrappers)
        out = fn()
        torch.cuda.synchronize()
        counts = {w.__name__: w.launches for w in wrappers}
        last_routes.clear()
        for w in wrappers:
            took = {r: c for r, c in getattr(w, "route_launches", {}).items()
                    if c}
            if took:
                last_routes[w.__name__] = took
        for w in wrappers:
            launches[w.__name__] += w.launches
            finishes[w.__name__] += w.finish_launches
            folds[w.__name__] += w.folded
            for r, c in getattr(w, "route_launches", {}).items():
                route_totals[w.__name__][r] += c
            check(w.plain_calls == 0, f"{w.__name__} ran its plain "
                                      f"version on the card")
        launches["gemm (wgmma)"] += ops.gemm.route_launches["wgmma"]
        return out, counts

    axpydot_inputs = dict(neg_alpha=neg_alpha, w=x, v=y, u=z)
    exact, mag = f64_terms("axpydot", (x, y, z), alpha=-neg_alpha)
    expected = {"dataflow": {"group_kernel": 1},
                "nodataflow": {"axpy": 1, "dot": 1}, "reference": {}}
    betas = {}
    for mode, prog in programs.items():
        out, counts = counted_run(lambda: prog(**axpydot_inputs))
        betas[mode] = out["beta"]
        nonzero = {k: c for k, c in counts.items() if c}
        ok = nonzero == expected[mode]
        emit({"phase": "main_path", "program": "axpydot", "mode": mode,
              "launches": nonzero, "beta": float(out["beta"]), "ok": ok})
        check(ok, f"axpydot {mode}: launches {nonzero}")
    for mode in ("dataflow", "nodataflow"):
        err = abs(float(betas[mode]) - float(betas["reference"]))
        err64 = abs(float(betas[mode]) - exact)
        ok = err <= 1e-5 * mag and err64 <= 1e-5 * mag
        emit({"phase": "main_path_check", "mode": mode,
              "abs_err_vs_reference": err, "abs_err_vs_f64": err64,
              "tol": 1e-5 * mag, "ok": ok})
        check(ok, f"axpydot {mode} disagrees with reference")

    wide_spec = {"name": "wide", "routines": [
        {"blas": "waxpby", "name": "wx",
         "scalars": {"alpha": 0.5, "beta": 2.0},
         "inputs": {"x": "x", "y": "y"}, "connections": {"out": "sc.x"}},
        {"blas": "scal", "name": "sc", "scalars": {"alpha": {"input": "a"}},
         "connections": {"out": ["dd.x", "nn.x", "im.x"]},
         "outputs": {"out": "s"}},
        {"blas": "dot", "name": "dd", "inputs": {"y": "x"},
         "outputs": {"out": "d"}},
        {"blas": "nrm2", "name": "nn", "outputs": {"out": "r"}},
        {"blas": "iamax", "name": "im", "outputs": {"out": "idx"}},
    ]}
    wide_inputs = dict(x=x, y=y, a=torch.tensor(3.0, device=dev))
    wide = {m: Program.from_spec(wide_spec, mode=m, device="cuda")
            for m in ("dataflow", "reference")}
    check(len(wide["dataflow"].groups) == 1, "wide spec: one group")
    got, counts = counted_run(lambda: wide["dataflow"](**wide_inputs))
    want, _ = counted_run(lambda: wide["reference"](**wide_inputs))
    nonzero = {k: c for k, c in counts.items() if c}
    s64 = 3.0 * (0.5 * x.double() + 2.0 * y.double())
    s_err = float((got["s"] - want["s"]).abs().max())
    d_err = abs(float(got["d"]) - float(want["d"]))
    r_err = abs(float(got["r"]) - float(want["r"]))
    top = float(want["s"].abs().max())
    ok = (nonzero == {"group_kernel": 1}
          and s_err <= 1e-6 * float(s64.abs().max())
          and d_err <= 1e-5 * float((s64 * x.double()).abs().sum())
          and r_err <= 1e-5 * float(want["r"])
          and float(want["s"][int(got["idx"])].abs()) >= top * (1 - 1e-6))
    emit({"phase": "main_path", "program": "waxpby->scal->{dot,nrm2,iamax}",
          "mode": "dataflow", "launches": nonzero, "s_max_abs_err": s_err,
          "d_abs_err": d_err, "r_abs_err": r_err,
          "idx": int(got["idx"]), "idx_reference": int(want["idx"]),
          "ok": ok})
    check(ok, "wide group disagrees with reference mode")

    def entry_points():
        return [ops.axpy(1.7, x, y), ops.scal(-0.3, x),
                ops.waxpby(0.5, x, -1.25, y), ops.copy(x),
                ops.vmul(x, y), ops.rot(0.6, 0.8, x, y), ops.dot(x, y),
                ops.asum(x), ops.nrm2(x), ops.iamax(x),
                ops.axpydot(0.9, x, y, z), ops.axpydot_nodf(0.9, x, y, z)]

    _, counts = counted_run(entry_points)
    emit({"phase": "main_path", "program": "ops entry points",
          "launches": {k: c for k, c in counts.items() if c}})

    # the Krylov matvec programs, in all three modes
    l2_expected = {
        "CG_MATVEC": {"gemv": 1, "dot": 1},
        "RESIDUAL": {"gemv": 1, "axpy": 1, "nrm2": 1},   # vsub runs axpy
        "BICG_MATVEC2": {"gemv": 1, "dot": 2},
        "POWER_STEP": {"gemv": 1, "nrm2": 1, "dot": 1},
        "GMRES_ORTH": {"gemvt": 1, "nrm2": 1},
        "SYMV_DOT": {"symv": 1, "dot": 1},
    }
    # the routes those launches take: the symv and gemvt products (of
    # the anchored groups in dataflow, of the kernels in nodataflow) by
    # TMA on these aligned operands; the gemv anchor launches no product;
    # gemv on 16384^2 one warp per row
    l2_routes = {
        "dataflow": {"SYMV_DOT": {"anchored_kernel": {"symv/tma": 1}},
                     "GMRES_ORTH": {"anchored_kernel": {"gemvt/tma": 1}}},
        "nodataflow": {"SYMV_DOT": {"symv": {"tma": 1}},
                       "GMRES_ORTH": {"gemvt": {"tma": 1}},
                       **{name: {"gemv": {"rows": 1}} for name in (
                           "CG_MATVEC", "RESIDUAL", "BICG_MATVEC2",
                           "POWER_STEP")}}}
    for name, progs in l2_programs.items():
        outs = {}
        for mode, lprog in progs.items():
            out, counts = counted_run(lambda: lprog(**l2_inputs[name]))
            outs[mode] = out
            nonzero = {k: c for k, c in counts.items() if c}
            want = {"dataflow": {"anchored_kernel": 1},
                    "nodataflow": l2_expected[name],
                    "reference": {}}[mode]
            want_routes = l2_routes.get(mode, {}).get(name, {})
            ok = nonzero == want and last_routes == want_routes
            emit({"phase": "main_path", "program": name, "mode": mode,
                  "launches": nonzero, "routes": dict(last_routes),
                  "ok": ok})
            check(ok, f"{name} {mode}: launches {nonzero}, want {want}; "
                      f"routes {last_routes}, want {want_routes}")
        for mode, out in outs.items():
            worst = outputs_close(out, outs["reference"], l2_exact[name])
            worst_red = reductions_close(name, out, l2_inputs[name])
            ok = worst <= 1.0 and (worst_red or 0.0) <= 1.0
            emit({"phase": "main_path_check", "program": name,
                  "mode": mode, "max_err_over_tol": worst,
                  "reduction_err_over_tol": worst_red, "ok": ok})
            check(ok, f"{name} {mode} disagrees with reference / float64")

    def l2_entry_points():
        return dict(gemv=ops.gemv(alpha2, A, xa, beta2, ya),
                    gemvt=ops.gemvt(alpha2, A, xa, beta2, ya),
                    symv=ops.symv(alpha2, A, xa, beta2, ya),
                    gesummv=ops.gesummv(0.4, A, 0.6, A, xa),
                    atax=ops.atax(A, xa), bicgk=ops.bicgk(A, xa, ya))

    got, counts = counted_run(l2_entry_points)
    nonzero = {k: c for k, c in counts.items() if c}
    axpb = alpha2 * q64 + beta2 * y64
    taxpb = abs(alpha2) * tq + 1e-6 * abs(beta2) * y64.abs()
    aq64 = A64 @ q64
    qy64, qymag = matvec64(A, ya)
    entry_exact = {
        "gemv": (axpb, taxpb), "gemvt": (axpb, taxpb), "symv": (axpb, taxpb),
        "gesummv": (q64, tq + 1e-6 * q64.abs()),
        "atax": (aq64, 1e-5 * (absA64 @ q64.abs()) + absA64 @ tq),
        "bicgk": None}
    worst = 0.0
    for key, ex in entry_exact.items():
        pairs = ([(got["bicgk"][0], q64, tq),
                  (got["bicgk"][1], qy64, 1e-5 * qymag)]
                 if ex is None else [(got[key], ex[0], ex[1])])
        for g, e, tol in pairs:
            worst = max(worst, float(((g.double() - e).abs() / tol).max()))
    ok = nonzero == {"gemv": 5, "gemvt": 3, "symv": 1} and worst <= 1.0
    emit({"phase": "main_path", "program": "level-2 ops entry points",
          "launches": nonzero, "max_err_over_tol": worst, "ok": ok})
    check(ok, "level-2 ops entry points")
    # the loop path: block-CG on a dense SPD system, in all three modes,
    # beside CG on each column and one BiCGStab solve
    modes = ("dataflow", "nodataflow", "reference")
    del A64, absA64
    # A = (sqrt 2 + delta) I + (G + Gᵀ)/2 with G_ij ~ N(0, 1/n): the
    # symmetric part's spectrum fills [-sqrt 2, sqrt 2] (semicircle), so
    # A's fills [delta, 2 sqrt 2 + delta] and delta sets κ
    delta = 2.0 * 2.0 ** 0.5 / (KAPPA - 1.0)
    A_spd = randn2(N2, N2).div_(N2 ** 0.5)
    A_spd = (A_spd + A_spd.T).mul_(0.5)
    A_spd.diagonal().add_(2.0 ** 0.5 + delta)
    # unit columns: block-CG stops on the worst column against rtol *
    # max_j |b_j|, so equal norms give every column CG's own threshold
    B_blk = randn2(N2, S_BLOCK)
    B_blk /= B_blk.norm(dim=0, keepdim=True)
    X0 = torch.zeros_like(B_blk)
    A_spd64 = A_spd.double()
    rtol = solver_specs.BLOCK_CG_LOOP["iterate"]["while"]["rtol"]
    res_bound = rtol + 10.0 * KAPPA * F32_UNIT

    def true_residuals(x, b):
        """|b_j - A x_j| / |b_j| per column, in float64."""
        b64 = b.double().reshape(N2, -1)
        r = b64 - A_spd64 @ x.double().reshape(N2, -1)
        return r.norm(dim=0) / b64.norm(dim=0)

    blk_progs = {m: LoopProgram(solver_specs.BLOCK_CG_LOOP, mode=m,
                                device="cuda") for m in modes}
    blk = {}
    for mode, lp in blk_progs.items():
        (res, issued), counts = counted_run(lambda: issued_iterations(
            lambda: lp.solve(A=A_spd, B=B_blk, x0=X0)))
        its = int(res.iterations)
        tres = true_residuals(res.x, B_blk)
        blk[mode] = (res, tres)
        want = {"dataflow": {"tiled_kernel": issued + 1, "gemm": 0},
                "nodataflow": {"tiled_kernel": 0, "gemm": issued + 1},
                "reference": {"tiled_kernel": 0, "gemm": 0}}[mode]
        got_counts = {k: counts[k] for k in want}
        ok = (res.status_names() == "CONVERGED" and got_counts == want
              and tuple(res.x.shape) == (N2, S_BLOCK)
              and float(tres.max()) <= res_bound)
        emit({"phase": "main_path", "program": "BLOCK_CG_LOOP",
              "mode": mode, "n": N2, "s": S_BLOCK, "kappa": KAPPA,
              "iterations": its, "issued_iterations": issued,
              "status": res.status_names(),
              "launches": {k: c for k, c in counts.items() if c},
              "max_true_residual": float(tres.max()),
              "residual_bound": res_bound, "ok": ok})
        check(ok, f"BLOCK_CG_LOOP {mode}: status {res.status_names()}, "
                  f"launches {got_counts} (want {want}), true residual "
                  f"{float(tres.max())} (bound {res_bound})")
    its_blk = {m: int(r.iterations) for m, (r, _) in blk.items()}
    spread = max(its_blk.values()) - min(its_blk.values())
    emit({"phase": "main_path_check", "program": "BLOCK_CG_LOOP",
          "iterations": its_blk, "ok": spread <= 1,
          **({"reason": "float32 sums in another order move the metric "
                        "across the threshold by one iteration"}
             if spread == 1 else {})})
    check(spread <= 1, f"block-CG iteration counts {its_blk}")

    # the yardstick: CG on each column, dataflow; one warm-up solve
    # first (its kernels compile), then the counted, timed 32 solves
    cg_lp = LoopProgram(solver_specs.CG_LOOP, mode="dataflow", device="cuda")
    zero_n = torch.zeros(N2, device=dev)
    b_cols = [B_blk[:, j].contiguous() for j in range(S_BLOCK)]
    cg_lp.solve(A=A_spd, b=b_cols[0], x0=zero_n)
    torch.cuda.synchronize()
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    (cg_res, issued), counts = counted_run(lambda: issued_iterations(
        lambda: [cg_lp.solve(A=A_spd, b=b, x0=zero_n) for b in b_cols]))
    ev1.record()
    ev1.synchronize()
    cg_total_ms = ev0.elapsed_time(ev1)
    its_cg = [int(r.iterations) for r in cg_res]
    res_blk, tres_blk = blk["dataflow"]
    tres_cg = torch.stack([true_residuals(r.x, b)[0]
                           for r, b in zip(cg_res, b_cols)])
    x_blk = res_blk.x.double()
    dx = torch.stack([(r.x.double() - x_blk[:, j]).norm()
                      for j, r in enumerate(cg_res)])
    dx_bound = KAPPA * (tres_cg + tres_blk) * x_blk.norm(dim=0)
    gap = max(its_cg) - its_blk["dataflow"]
    ok = (all(r.status_names() == "CONVERGED" for r in cg_res)
          and abs(gap) <= 1
          and float(tres_cg.max()) <= res_bound
          and bool((dx <= dx_bound).all())
          and counts["anchored_kernel"] == issued + S_BLOCK)
    emit({"phase": "main_path", "program": "CG_LOOP x 32 columns",
          "mode": "dataflow", "iterations": its_cg,
          "issued_iterations": issued,
          "max_iterations": max(its_cg),
          "block_cg_iterations": its_blk["dataflow"],
          **({"reason": "the slowest column's float32 metric crosses the "
                        "threshold one iteration apart in the two solvers"}
             if gap else {}),
          "launches": {k: c for k, c in counts.items() if c},
          "max_true_residual": float(tres_cg.max()),
          "max_dx_over_bound": float((dx / dx_bound).max()), "ok": ok})
    check(ok, "CG on each column disagrees with block-CG")
    batched_phase(cg_lp, A_spd, b_cols, cg_res, counts, cg_total_ms,
                  counted_run)
    distributed_phase(x, y, z, neg_alpha, A_spd, B_blk, b_cols,
                      programs["dataflow"], counted_run)

    bi_lp = LoopProgram(solver_specs.BICGSTAB_LOOP, mode="dataflow",
                        device="cuda")
    bi, counts = counted_run(lambda: bi_lp.solve(A=A_spd, b=b_cols[0], x0=zero_n))
    tres_bi = float(true_residuals(bi.x, b_cols[0])[0])
    ok = (bi.status_names() == "CONVERGED" and tres_bi <= res_bound
          and counts["anchored_kernel"] >= int(bi.iterations))
    emit({"phase": "main_path", "program": "BICGSTAB_LOOP",
          "mode": "dataflow", "iterations": int(bi.iterations),
          "status": bi.status_names(),
          "launches": {k: c for k, c in counts.items() if c},
          "true_residual": tres_bi, "ok": ok})
    check(ok, "BICGSTAB_LOOP on the card")
    del A_spd64

    # GER_SPEC and TRANSPOSE_SPEC at 16384^2: one standalone launch each
    # outside reference mode, against reference mode and float64
    alpha_t = torch.full((), GER_ALPHA, device=dev)
    outer64 = GER_ALPHA32 * torch.outer(xn.double(), yn.double())
    ger_exact = outer64 + An.double()
    ger_terms = outer64.abs_().add_(An.double().abs_())
    del outer64
    matrix_programs = {
        "GER_SPEC": (GER_SPEC, dict(A=An, x=xn, y=yn, alpha=alpha_t),
                     "ger"),
        "TRANSPOSE_SPEC": (TRANSPOSE_SPEC, dict(A=An), "transpose")}
    for name, (raw, inputs, kernel) in matrix_programs.items():
        outs = {}
        for mode in modes:
            mprog = Program.from_spec(raw, mode=mode, device="cuda")
            out, counts = counted_run(lambda: mprog(**inputs))
            outs[mode] = out["out"]
            nonzero = {k: c for k, c in counts.items() if c}
            want = {} if mode == "reference" else {kernel: 1}
            ok = nonzero == want and out["out"].dtype == torch.float32
            emit({"phase": "main_path", "program": name, "mode": mode,
                  "shape": [N2, N2], "launches": nonzero, "ok": ok})
            check(ok, f"{name} {mode}: launches {nonzero}, want {want}")
        for mode in ("dataflow", "nodataflow"):
            g = outs[mode]
            if kernel == "transpose":
                ok = bool(torch.equal(g, outs["reference"])) and \
                    bool(torch.equal(g, An.t()))
                emit({"phase": "main_path_check", "program": name,
                      "mode": mode, "bitwise_equal_to_reference": ok,
                      "ok": ok})
            else:
                g64 = g.double()
                tol = ger_terms * 2.0 ** -23 + 2.0 ** -24 * g64.abs()
                err = (g64 - outs["reference"].double()).abs_()
                err64 = (g64 - ger_exact).abs_()
                ok = bool((err <= 2 * tol).all()) and \
                    bool((err64 <= tol).all())
                emit({"phase": "main_path_check", "program": name,
                      "mode": mode, "max_abs_err_vs_reference":
                      float(err.max()), "max_err_vs_f64_over_tol":
                      float((err64 / tol).max()), "ok": ok})
                del g64, tol, err, err64
            check(ok, f"{name} {mode} disagrees with reference / float64")
        del outs
    del ger_exact, ger_terms

    # GMRES(20) on a dense non-symmetric float32 system, A = c I + G/sqrt
    # n with G standard normal: by the circular law G/sqrt(n)'s
    # eigenvalues fill the unit disk, so A's fill the disk of radius 1
    # about c, and a Krylov space of dimension 20 shrinks the residual
    # by about (1/c)**20 per restart. c = 1.25 gives 0.8**20 = 0.012, so
    # rtol 1e-6 takes about 3-5 restarts.
    A_g = randn2(N2, N2).div_(N2 ** 0.5)
    A_g.diagonal().add_(GMRES_SHIFT)
    b_g = randn2(N2)
    x0_g = torch.zeros_like(b_g)
    A_g64, b_g64 = A_g.double(), b_g.double()
    lu, piv = torch.linalg.lu_factor(A_g64)
    x_star = torch.linalg.lu_solve(lu, piv, b_g64[:, None])[:, 0]

    def top_eig(apply, iters=100):
        """Power iteration: the largest eigenvalue of a symmetric
        positive definite operator."""
        v = torch.randn(N2, generator=gen, device=dev, dtype=torch.float64)
        lam = 0.0
        for _ in range(iters):
            v = apply(v)
            lam = float(v.norm())
            v /= lam
        return lam

    sigma_max = top_eig(lambda v: A_g64.T @ (A_g64 @ v)) ** 0.5
    sigma_min = top_eig(lambda v: torch.linalg.lu_solve(
        lu, piv, torch.linalg.lu_solve(lu, piv, v[:, None],
                                       adjoint=True))[:, 0]) ** -0.5
    kappa_g = sigma_max / sigma_min
    del lu, piv
    m_g = GMRES_M
    check(solver_specs.GMRES_LOOP["iterate"]["body"][2]["iterate"][
        "while"]["count"] == m_g, "GMRES_LOOP's restart length")

    def gmres_launches(mode, r):
        """Launches of a solve of r restarts (one setup, r bodies), and
        their routes: each inner step's orthogonalisation against the
        (21, n) basis is a gemvt-anchored group in dataflow (its product
        by TMA) and a gemvt launch in nodataflow (by TMA, no combine);
        its projection h = V w a gemv by the band kernel's TMA route, in
        one launch; the matvecs (and in nodataflow the residuals) gemv
        one warp per row."""
        if mode == "reference":
            return {}, {}
        common_ = {"scal": (m_g + 1) * r, "rot": m_g * r, "dot": m_g * r,
                   "transpose": r}
        if mode == "dataflow":
            return {**common_, "gemv": 2 * m_g * r, "axpy": m_g * r,
                    "anchored_kernel": (m_g + 1) * r + 1, "nrm2": 1}, \
                {"anchored_kernel": {"gemvt/tma": m_g * r},
                 "gemv": {"rows": m_g * r, "tma": m_g * r}}
        return {**common_, "gemv": (2 * m_g + 1) * r + 1,
                "gemvt": m_g * r, "axpy": (m_g + 1) * r + 1,
                "nrm2": (m_g + 1) * r + 2}, \
            {"gemvt": {"tma": m_g * r},
             "gemv": {"rows": (m_g + 1) * r + 1, "tma": m_g * r}}

    gm_progs = {m: LoopProgram(solver_specs.GMRES_LOOP, mode=m,
                               device="cuda") for m in modes}
    gm_ops = dict(A=A_g, b=b_g, x0=x0_g)
    gm = {}
    for mode, lp in gm_progs.items():
        res, counts = counted_run(lambda: lp.solve(**gm_ops))
        restarts = int(res.iterations)
        x64 = res.x.double()
        relres = float((b_g64 - A_g64 @ x64).norm() / b_g64.norm())
        dx = float((x64 - x_star).norm() / x_star.norm())
        nonzero = {k: c for k, c in counts.items() if c}
        want, want_routes = gmres_launches(mode, restarts)
        gm[mode] = res
        ok = (res.status_names() == "CONVERGED" and nonzero == want
              and last_routes == want_routes
              and tuple(res.x.shape) == (N2,)
              and bool(torch.isfinite(res.x).all())
              and relres <= 1e-5 and dx <= kappa_g * relres)
        emit({"phase": "main_path", "program": "GMRES_LOOP", "mode": mode,
              "n": N2, "m": m_g, "shift_c": GMRES_SHIFT,
              "restarts": restarts, "status": res.status_names(),
              "history": res.history_trimmed().tolist(),
              "launches": nonzero, "routes": dict(last_routes),
              "true_residual": relres,
              "rel_err_vs_f64_solve": dx, "kappa": kappa_g,
              "sigma_max": sigma_max, "sigma_min": sigma_min,
              "err_bound": kappa_g * relres, "ok": ok})
        check(ok, f"GMRES_LOOP {mode}: status {res.status_names()}, "
                  f"launches {nonzero} (want {want}), routes "
                  f"{last_routes} (want {want_routes}), true residual "
                  f"{relres}, error {dx} (bound {kappa_g * relres})")
    restarts_g = {m: int(r.iterations) for m, r in gm.items()}
    spread = max(restarts_g.values()) - min(restarts_g.values())
    emit({"phase": "main_path_check", "program": "GMRES_LOOP",
          "restarts": restarts_g, "ok": spread <= 1})
    check(spread <= 1, f"GMRES restart counts {restarts_g}")
    del A_g64, b_g64, x_star

    # ------------------------------------------------------------------
    # 2d. the public API (repro_torch.blas) and the class-based solvers
    # ------------------------------------------------------------------
    from repro_torch import blas
    from repro_torch.blas import functional as blas_fn
    from repro_torch.core import lowering, routines as R
    from repro_torch.solvers import BiCGStab, CG, Jacobi, PowerIteration
    from repro_torch.solvers.iterative import jacobi_dinv

    C_blk, Y_blk, col_a = randn2(N2, S_BLOCK), randn2(N2, S_BLOCK), \
        randn2(S_BLOCK)
    x_pos = y.abs() + 0.5                # vdiv's denominators
    api_scalars = {"alpha": alpha2, "beta": beta2, "c": 0.6, "s": 0.8}

    def api_args(name):
        """blas.<name>'s keyword arguments at the script's sizes: vectors
        of 2**26, matrices of 16384**2 (symv on the SPD A, the others on
        the non-symmetric An), gemm at 16384**2 . (16384 x 32), the
        column routines on (16384, 32) panels."""
        rdef = R.get(name)
        kw = {s: GER_ALPHA if name == "ger" else api_scalars[s]
              for s in rdef.scalars}
        if name in ("gemv", "gemvt", "symv"):
            kw.update(A=A_spd if name == "symv" else An, x=xn, y=yn)
        elif name == "ger":
            kw.update(x=xn, y=yn, A=An)
        elif name == "transpose":
            kw.update(A=An)
        elif name == "gemm":
            kw.update(A=A_spd, B=B_blk, C=C_blk)
        elif name == "colaxpy":
            kw.update(a=col_a, x=B_blk, y=Y_blk)
        elif name == "coldot":
            kw.update(x=B_blk, y=Y_blk)
        elif name == "vdiv":
            kw.update(x=x, y=x_pos)
        else:
            kw.update({p: {"x": x, "y": y}[p] for p in rdef.inputs})
        return kw

    def api_tol(name, kw, got):
        """The bound this script holds the routine's kernel to, element
        by element, for its distance from reference mode: 0 where it
        moves bits or has no kernel (reference mode's oracle then runs in
        every mode); the reductions' 1e-5 sum|terms|; element-wise 1e-6
        of the operands' scale; matvec rows and gemm elements 1e-5 of
        the sum of |terms| plus 1e-6 |beta y|; ger's float32 bound,
        doubled against another rounding order."""
        if R.get(name).kernel is None or name in ("transpose", "iamax"):
            return 0.0
        if name in ("dot", "nrm2", "asum"):
            vecs = [kw[p] for p in R.get(name).inputs]
            return 1e-5 * f64_terms(name, vecs)[1]
        if name in ("gemv", "gemvt", "symv"):
            a64 = kw["A"].double().abs_()
            mag = (a64.T if name == "gemvt" else a64) @ kw["x"].double().abs()
            del a64
            return 1e-5 * abs(kw["alpha"]) * mag \
                + 1e-6 * abs(kw["beta"]) * kw["y"].double().abs()
        if name == "gemm":
            mag = kw["A"].double().abs_() @ kw["B"].double().abs()
            return 1e-5 * abs(kw["alpha"]) * mag \
                + 1e-6 * abs(kw["beta"]) * kw["C"].double().abs()
        if name == "ger":
            terms = (GER_ALPHA32 * torch.outer(kw["x"].double(),
                                               kw["y"].double())).abs_()
            terms.add_(kw["A"].double().abs_())
            return 2 * (terms.mul_(2.0 ** -23)
                        + 2.0 ** -24 * got.double().abs())
        scalars = [kw[s] for s in R.get(name).scalars]
        return 1e-6 * (1.0 + sum(abs(s) for s in scalars)) * max(
            float(kw[p].abs().max()) for p in R.get(name).inputs)

    def as_outputs(out):
        return out if isinstance(out, tuple) else (out,)

    api_modes = ("dataflow", "nodataflow")
    for name in R.names():
        kw = api_args(name)
        fn = getattr(blas, name)
        want = as_outputs(fn(**kw, mode="reference", device="cuda"))
        row = {"phase": "api_routines", "routine": name, "launches": {}}
        oks = []
        for mode in api_modes:
            got, counts = counted_run(
                lambda: as_outputs(fn(**kw, mode=mode, device="cuda")))
            rprog = Program.from_spec(blas_fn.routine_spec(name), mode=mode,
                                      device="cuda")
            direct = rprog(**kw)
            direct = tuple(direct[p] for p in R.get(name).outputs)
            bitwise = all(torch.equal(g, d) for g, d in zip(got, direct))
            err, over = 0.0, 0.0
            for g, r in zip(got, want):
                tol = api_tol(name, kw, g)
                e = (g.double() - r.double()).abs()
                err = max(err, float(e.max()))
                over = max(over, float((e - tol).max()))
                del e
            nonzero = {k: c for k, c in counts.items() if c}
            launched = bool(nonzero) == (R.get(name).kernel is not None)
            ok = bitwise and over <= 0.0 and launched and all(
                g.shape == r.shape and g.dtype == r.dtype
                for g, r in zip(got, want))
            row["launches"][mode] = nonzero
            row[f"{mode}_bitwise_equal_to_program"] = bitwise
            row[f"{mode}_max_abs_err_vs_reference"] = err
            oks.append(ok)
            del got, direct
        row["ok"] = all(oks)
        emit(row)
        check(row["ok"], f"blas.{name} on the card: {row}")
        del want
    del x_pos

    # the fluent builder: AXPYDOT built call by call, through compile
    bld = blas.program("axpydot", dtype="float32")
    zc = bld.axpy(name="zcalc", alpha=bld.input("neg_alpha"), x="v", y="w")
    bld.dot(name="zdot", x=zc, y="u", out="beta")
    exe_b = blas.compile(bld, device="cuda")
    got, counts = counted_run(lambda: exe_b.one(**axpydot_inputs))
    want = programs["dataflow"](**axpydot_inputs)["beta"]
    digest_ok = bld.digest() == lowering.spec_digest(AXPYDOT_SPEC)
    nonzero = {k: c for k, c in counts.items() if c}
    ok = (digest_ok and bool(torch.equal(got, want))
          and nonzero == {"group_kernel": 1})
    emit({"phase": "api_builder", "program": "axpydot", "digest":
          bld.digest(), "digest_equals_AXPYDOT_SPEC": digest_ok,
          "bitwise_equal_to_program": bool(torch.equal(got, want)),
          "beta": float(got), "launches": nonzero, "ok": ok})
    check(ok, "the fluent AXPYDOT disagrees with AXPYDOT_SPEC's program")

    def f64_relres(a, xs, b):
        """|b - A x| / |b| in float64 (A widened for the call)."""
        a64 = a.double()
        r = float((b.double() - a64 @ xs.double()).norm()
                  / b.double().norm())
        del a64
        return r

    # the solver functions against the LoopProgram runs above: the same
    # spec, the same stage programs, so the same iterations, status and
    # bits of x
    api_same = {
        "cg": (lambda: blas.cg(A_spd, b_cols[0], device="cuda"),
               cg_res[0]),
        "bicgstab": (lambda: blas.bicgstab(A_spd, b_cols[0],
                                           device="cuda"), bi),
        "gmres": (lambda: blas.gmres(A_g, b_g, device="cuda"),
                  gm["dataflow"]),
        "block_cg": (lambda: blas.block_cg(A_spd, B_blk, device="cuda"),
                     blk["dataflow"][0])}
    for name, (run, loop_res) in api_same.items():
        res, counts = counted_run(run)
        same = (int(res.iterations) == int(loop_res.iterations)
                and res.status_names() == loop_res.status_names()
                and bool(torch.equal(res.x, loop_res.x)))
        ok = same and res.status_names() == "CONVERGED"
        emit({"phase": "api_solvers", "function": f"blas.{name}",
              "iterations": int(res.iterations),
              "status": res.status_names(),
              "loop_program_iterations": int(loop_res.iterations),
              "bitwise_equal_to_loop_program": same,
              "launches": {k: c for k, c in counts.items() if c},
              "ok": ok})
        check(ok, f"blas.{name} disagrees with its LoopProgram run")

    # Jacobi on a diagonally dominant A = S + 2 diag(sum_j |S_ij|)
    A_dd = A_spd.clone()
    A_dd.diagonal().add_(A_spd.abs().sum(dim=1), alpha=2.0)
    jac, counts = counted_run(lambda: blas.jacobi(A_dd, b_cols[0],
                                                  device="cuda"))
    tres_jac = f64_relres(A_dd, jac.x, b_cols[0])
    ok = jac.status_names() == "CONVERGED" and tres_jac <= res_bound
    emit({"phase": "api_solvers", "function": "blas.jacobi",
          "iterations": int(jac.iterations), "status": jac.status_names(),
          "true_residual": tres_jac, "residual_bound": res_bound,
          "launches": {k: c for k, c in counts.items() if c}, "ok": ok})
    check(ok, f"blas.jacobi: {jac.status_names()}, true residual {tres_jac}")

    def eig_residual(res):
        """|A x - lambda x| / |lambda| in float64, A the SPD matrix."""
        lam = float(res.aux["eigenvalue"])
        x64 = res.x.double()
        a64 = A_spd.double()
        r = float((a64 @ x64 - lam * x64).norm()) / abs(lam)
        del a64
        return r, lam

    pw, counts = counted_run(lambda: blas.power_iteration(
        A_spd, tol=POWER_TOL, max_iters=POWER_MAX, device="cuda"))
    pw_res, pw_lam = eig_residual(pw)
    ok = pw.status_names() == "CONVERGED" and pw_res <= 1e-3
    emit({"phase": "api_solvers", "function": "blas.power_iteration",
          "tol": POWER_TOL, "iterations": int(pw.iterations),
          "status": pw.status_names(), "eigenvalue": pw_lam,
          "residual_over_eigenvalue": pw_res, "bound": 1e-3,
          "launches": {k: c for k, c in counts.items() if c}, "ok": ok})
    check(ok, f"blas.power_iteration: {pw.status_names()}, "
              f"|Ax - lx| / |l| = {pw_res}")

    def timed_solve(run):
        """One solve's event ms (CUDA events around it) and host ms (the
        host's clock around it, the host loop waiting on each
        iteration's stop test)."""
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev0.record()
        res = run()
        ev1.record()
        ev1.synchronize()
        return res, ev0.elapsed_time(ev1), (time.perf_counter() - t0) * 1e3

    # the class solvers against the loop specs that run the same stage
    # programs (PowerIteration, which no loop spec describes, against the
    # blas.power_iteration run of the same class)
    dinv_dd = jacobi_dinv(A_dd)
    class_cases = {
        "CG": (CG, {}, A_spd, solver_specs.CG_LOOP, {}),
        "BiCGStab": (BiCGStab, {}, A_spd, solver_specs.BICGSTAB_LOOP, {}),
        "Jacobi": (Jacobi, {}, A_dd, solver_specs.JACOBI_LOOP,
                   {"dinv": dinv_dd, "omega": 1.0})}
    for name, (cls, ckw, a_sys, loop_spec, extra) in class_cases.items():
        for mode in api_modes:
            solver = cls(mode=mode, device="cuda", **ckw)
            lp = LoopProgram(loop_spec, mode=mode, device="cuda")
            loop_ops = dict(A=a_sys, b=b_cols[0], x0=zero_n, **extra)
            res_c, counts = counted_run(
                lambda: solver.solve(a_sys, b_cols[0]))
            res_l, _ = counted_run(lambda: lp.solve(**loop_ops))
            _, c_ms, c_host = timed_solve(lambda: solver.solve(a_sys,
                                                                b_cols[0]))
            _, l_ms, l_host = timed_solve(lambda: lp.solve(**loop_ops))
            its = int(res_c.iterations)
            bitwise = bool(torch.equal(res_c.x, res_l.x))
            close = bool(torch.allclose(
                res_c.x, res_l.x, rtol=1e-5,
                atol=1e-6 * float(res_l.x.abs().max())))
            tres = f64_relres(a_sys, res_c.x, b_cols[0])
            ok = (res_c.status_names() == "CONVERGED"
                  and res_l.status_names() == "CONVERGED"
                  and its == int(res_l.iterations) and close
                  and tres <= res_bound and solver.trace_count == 1)
            emit({"phase": "class_solvers", "solver": name, "mode": mode,
                  "n": N2, "iterations": its,
                  "loop_spec_iterations": int(res_l.iterations),
                  "status": res_c.status_names(),
                  "x_bitwise_equal_to_loop_spec": bitwise,
                  "x_within_rtol_1e-5": close, "true_residual": tres,
                  "residual_bound": res_bound,
                  "launches": {k: c for k, c in counts.items() if c},
                  "solve_ms": c_ms, "ms_per_iteration": c_ms / max(its, 1),
                  "host_ms_per_iteration": c_host / max(its, 1),
                  "loop_spec_solve_ms": l_ms,
                  "loop_spec_ms_per_iteration": l_ms / max(its, 1),
                  "loop_spec_host_ms_per_iteration": l_host / max(its, 1),
                  "ok": ok})
            check(ok, f"class {name} {mode} disagrees with its loop spec")
    for mode in api_modes:
        solver = PowerIteration(mode=mode, max_iters=POWER_MAX,
                                device="cuda")
        res_c, counts = counted_run(lambda: solver.solve(A_spd,
                                                         tol=POWER_TOL))
        res_b = blas.power_iteration(A_spd, tol=POWER_TOL,
                                     max_iters=POWER_MAX, mode=mode,
                                     device="cuda")
        _, c_ms, c_host = timed_solve(lambda: solver.solve(A_spd,
                                                           tol=POWER_TOL))
        its = int(res_c.iterations)
        eres, lam = eig_residual(res_c)
        bitwise = bool(torch.equal(res_c.x, res_b.x))
        ok = (res_c.status_names() == "CONVERGED" and bitwise
              and its == int(res_b.iterations) and eres <= 1e-3)
        emit({"phase": "class_solvers", "solver": "PowerIteration",
              "mode": mode, "n": N2, "tol": POWER_TOL, "iterations": its,
              "status": res_c.status_names(), "eigenvalue": lam,
              "residual_over_eigenvalue": eres, "bound": 1e-3,
              "x_bitwise_equal_to_blas_power_iteration": bitwise,
              "launches": {k: c for k, c in counts.items() if c},
              "solve_ms": c_ms, "ms_per_iteration": c_ms / max(its, 1),
              "host_ms_per_iteration": c_host / max(its, 1), "ok": ok})
        check(ok, f"class PowerIteration {mode} on the card")
    del A_dd, dinv_dd, C_blk, Y_blk

    # ------------------------------------------------------------------
    # 2e. robust solves: the chaos drill, faults at n = 16384 and the
    #     escalation ladder on the card; then one CG solve recorded by obs
    # ------------------------------------------------------------------
    from repro_torch import obs
    from repro_torch.guard import __main__ as guard_main, chaos, escalate

    # part 1: the 25-cell drill (5 solvers x 4 kinds, 3 scale-0
    # breakdown cells, 2 tuning-store cells) at the drill's n = 24
    drill, counts = counted_run(lambda: guard_main.chaos_smoke(
        device="cuda", quiet=True))
    ok = drill["failed"] == 0 and drill["cases"] == 25
    emit({"phase": "chaos", "part": "drill", "mode": "dataflow",
          "cases": drill["cases"], "failed": drill["failed"],
          "cells": [[r["solver"], r["kind"] + ("/factor=0" if "factor" in r
                                               else ""),
                     r.get("status"), r.get("iterations"), r["ok"],
                     [a["solver"] + "/" + a["action"] + "/" + a["status"]
                      for a in r.get("attempts", [])]]
                    for r in drill["rows"]],
          "errors": [r.get("error") for r in drill["rows"] if not r["ok"]],
          "launches": {k: c for k, c in counts.items() if c},
          "nvidia_smi": smi, "ok": ok})
    check(ok, f"chaos drill on the card: {drill['failed']} of "
              f"{drill['cases']} cells failed")

    # part 2: faults at n = 16384 on the smoke's own systems, float32:
    # detection within DETECTION_SLACK iterations, then blas.solve with
    # the same plan (armed on the first attempt only) recovering, its
    # true residual held to the bound the same clean solve is held to
    # above (res_bound for the CG family, 1e-5 for GMRES) and its
    # distance from 1e-6 recorded
    slack = guard_main.DETECTION_SLACK
    gm_policy = escalate.EscalationPolicy(chain=("gmres",))
    fault_cases = [
        # name, loop spec, operands, plan, recovery policy, must-be status
        ("CG nan", solver_specs.CG_LOOP,
         dict(A=A_spd, b=b_cols[0], x0=zero_n),
         chaos.FaultPlan(program="cg", kind="nan", iteration=3), None,
         None),
        ("CG bitflip", solver_specs.CG_LOOP,
         dict(A=A_spd, b=b_cols[0], x0=zero_n),
         chaos.FaultPlan(program="cg", kind="bitflip", iteration=3), None,
         None),
        ("block-CG nan", solver_specs.BLOCK_CG_LOOP,
         dict(A=A_spd, B=B_blk, x0=X0),
         chaos.FaultPlan(program="block_cg", kind="nan", iteration=3),
         None, None),
        ("block-CG scale 0", solver_specs.BLOCK_CG_LOOP,
         dict(A=A_spd, B=B_blk, x0=X0),
         chaos.FaultPlan(program="block_cg", kind="scale", factor=0.0,
                         iteration=3), None, "BREAKDOWN"),
        ("GMRES(20) nan", solver_specs.GMRES_LOOP,
         dict(A=A_g, b=b_g, x0=x0_g),
         chaos.FaultPlan(program="gmres", kind="nan", iteration=1),
         gm_policy, None),
    ]
    for name, raw, ops_, plan, policy, must in fault_cases:
        exe = blas.compile(raw, device="cuda", fault=plan)
        res, counts = counted_run(lambda: exe.run(tol=1e-6, **ops_))
        its, status = int(res.iterations), res.status_names()
        detected = (status != "CONVERGED"
                    and its <= plan.iteration + slack
                    and (must is None or status == must))
        b_ = ops_.get("b", ops_.get("B"))
        rec, rcounts = counted_run(lambda: blas.solve(
            ops_["A"], b_, tol=1e-6, policy=policy, device="cuda",
            fault=plan))
        if "B" in ops_:            # the worst column, in float64
            a64 = A_spd.double()
            b64 = B_blk.double()
            tres = float(((b64 - a64 @ rec.x.double()).norm(dim=0)
                          / b64.norm(dim=0)).max())
            del a64, b64
            bound_ = res_bound
        elif raw is solver_specs.GMRES_LOOP:
            tres = float((b_g.double() - A_g.double() @ rec.x.double())
                         .norm() / b_g.double().norm())
            bound_ = 1e-5
        else:
            tres = f64_relres(A_spd, rec.x, b_)
            bound_ = res_bound
        recovered = (rec.status_names() == "CONVERGED"
                     and rec.x.device.type == "cuda" and tres <= bound_
                     and len(rec.attempts) > 1)
        ok = detected and recovered
        emit({"phase": "chaos", "part": "n16384", "case": name, "n": N2,
              "plan": {"program": plan.program, "kind": plan.kind,
                       "iteration": plan.iteration,
                       **({"factor": plan.factor}
                          if plan.kind == "scale" else {})},
              "status": status, "iterations": its,
              "detected_within_slack": detected, "slack": slack,
              "launches": {k: c for k, c in counts.items() if c},
              "attempts": [[a.solver, a.action, a.status_name,
                            a.iterations, a.duration_s * 1e3]
                           for a in rec.attempts],
              "recovered_status": rec.status_names(),
              "true_residual": tres, "residual_bound": bound_,
              "true_residual_le_1e-6": tres <= 1e-6,
              "recovery_launches": {k: c for k, c in rcounts.items() if c},
              "nvidia_smi": smi, "ok": ok})
        check(ok, f"chaos {name}: {status} after {its} iterations "
                  f"(injected at {plan.iteration}), recovered "
                  f"{rec.status_names()} with true residual {tres} "
                  f"(bound {bound_})")
    del exe

    # a ladder that ends on the float64 rung: Jacobi for 3 iterations on
    # the SPD system (its iteration matrix has spectral radius ~0.98), no
    # retry, then torch.linalg.solve_ex in float64 on the card
    f64_policy = escalate.EscalationPolicy(chain=("jacobi",),
                                           retry_restart=False)
    rec, counts = counted_run(lambda: blas.solve(
        A_spd, b_cols[0], tol=1e-6, max_iters=3, policy=f64_policy,
        device="cuda"))
    tres = f64_relres(A_spd, rec.x, b_cols[0])
    last = rec.attempts[-1]
    ok = (rec.status_names() == "CONVERGED"
          and [(a.solver, a.action) for a in rec.attempts]
          == [("jacobi", "initial"), ("dense_f64", "escalate_f64")]
          and rec.x.device.type == "cuda"
          and rec.x.dtype == torch.float64 and tres <= 1e-6)
    emit({"phase": "chaos", "part": "f64_rung", "n": N2,
          "attempts": [[a.solver, a.action, a.status_name, a.iterations,
                        a.duration_s * 1e3] for a in rec.attempts],
          "f64_rung_ms": last.duration_s * 1e3,
          "f64_residual": last.residual, "true_residual": tres,
          "launches": {k: c for k, c in counts.items() if c},
          "nvidia_smi": smi, "ok": ok})
    check(ok, f"the float64 rung at n = {N2}: {rec.attempts}, true "
              f"residual {tres}")
    del rec

    # the obs phase: one CG solve with recording on, against the same
    # solve with it off (bitwise), per-iteration event ms both ways in
    # turns (off, on, on, off), and where the recorded time goes
    obs_lp = LoopProgram(solver_specs.CG_LOOP, mode="dataflow",
                         device="cuda")
    cg_ops = dict(A=A_spd, b=b_cols[0], x0=zero_n)
    off, counts = counted_run(lambda: obs_lp.solve(**cg_ops))
    check(not obs.enabled(), "obs recording is on by default")
    with obs.capture() as reg:
        on = obs_lp.solve(**cg_ops)
        recs = list(reg.records)
    result = [r for r in recs if r["name"] == "solver.result"]
    spans = [r for r in recs if r["name"] == "kernel.group"]
    solve_span = [r for r in recs if r["name"] == "solver.solve"]
    its = int(off.iterations)
    bitwise = bool(torch.equal(on.x, off.x)) and int(on.iterations) == its
    turns = []
    for recording in (False, True, True, False):
        if recording:
            with obs.capture():
                _, ev_ms, h_ms = timed_solve(lambda: obs_lp.solve(**cg_ops))
        else:
            _, ev_ms, h_ms = timed_solve(lambda: obs_lp.solve(**cg_ops))
        turns.append((recording, ev_ms / its, h_ms / its))
    by_program: dict = {}
    for r in spans:
        key = r["attrs"]["program"]
        by_program[key] = by_program.get(key, 0.0) + r["dur_s"] * 1e3
    solve_ms_rec = solve_span[0]["dur_s"] * 1e3 if solve_span else None
    group_ms = sum(by_program.values())
    # a span in a CUDA-graph capture would synchronize the capturing
    # stream: under recording, a captured program call takes none
    mv_prog = l2_programs["CG_MATVEC"]["dataflow"]
    mv_in = l2_inputs["CG_MATVEC"]
    eager = mv_prog(**mv_in)["q"].clone()
    with obs.capture() as greg:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            mv_prog(**mv_in)             # warm-up on the capture stream
        side.synchronize()
        warm_spans = [r for r in greg.records if r["name"] == "kernel.group"]
        before = len(greg.records)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            captured = mv_prog(**mv_in)
        graph.replay()
        torch.cuda.synchronize()
        capture_spans = [r for r in greg.records[before:]
                         if r["name"] == "kernel.group"]
    graph_ok = (len(warm_spans) == len(mv_prog.groups) and not capture_spans
                and bool(torch.equal(captured["q"], eager)))
    del graph, captured, eager
    ok = (bitwise and len(result) == 1
          and result[0]["attrs"]["iterations"] == its
          and result[0]["attrs"]["status"] == "CONVERGED"
          and len(spans) > 0 and len(solve_span) == 1 and graph_ok)
    emit({"phase": "obs", "program": "CG_LOOP", "n": N2,
          "iterations": its, "solver_result": result[0]["attrs"]
          if result else None,
          "kernel_group_spans": len(spans),
          "x_bitwise_equal_recording_on_off": bitwise,
          "ms_per_iteration_off": [t[1] for t in turns if not t[0]],
          "ms_per_iteration_on": [t[1] for t in turns if t[0]],
          "host_ms_per_iteration_off": [t[2] for t in turns if not t[0]],
          "host_ms_per_iteration_on": [t[2] for t in turns if t[0]],
          "recorded_solve_ms": solve_ms_rec,
          "kernel_group_ms_by_program": by_program,
          "kernel_group_ms_per_iteration": group_ms / its,
          "other_ms_per_iteration": (solve_ms_rec - group_ms) / its
          if solve_ms_rec is not None else None,
          "records": len(recs),
          "capture_under_recording_ok": graph_ok,
          "launches": {k: c for k, c in counts.items() if c},
          "nvidia_smi": smi, "ok": ok})
    check(ok, "the obs phase: recording changed the solve, or its records "
              "are incomplete, or a span ran inside a capture")
    check(not obs.enabled() and obs.records() == [],
          "obs recording leaked out of its capture")
    del obs_lp, off, on, recs, spans

    # ------------------------------------------------------------------
    # 2c. the serve path: llama3-8b at full width and depth, bfloat16
    # ------------------------------------------------------------------
    import contextlib

    import numpy as np
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.kernels import (attention as k_attn,
                                     decode_attention as k_dec)
    from repro_torch.models import (attention as m_attn, decode_step,
                                    init_params, prefill)
    from repro_torch.serve import ServeEngine, pad_and_batch

    def attn_bound(got, want, q, k, v):
        """|got - want| <= 1e-5 max|v| (1 + 2 scale max|q_i| max|k_j|):
        the softmax-weighted sum's float32 rounding plus the scores'
        carried through exp(); in bfloat16 plus one unit of the output
        (2**-7 of the larger side: each side rounds once)."""
        spread = q.shape[-1] ** -0.5 * float(
            q.float().norm(dim=-1).max()) * float(k.float().norm(
                dim=-1).max())
        tol = 1e-5 * float(v.float().abs().max()) * (1 + 2 * spread)
        err = (got.float() - want.float()).abs()
        if got.dtype != torch.float32:
            tol = tol + 2.0 ** -7 * torch.maximum(got.float().abs(),
                                                  want.float().abs())
        return float(err.max()), float((err / tol).max())

    def attn_case(kernel, case, got, want, q, k, v):
        err, ratio = attn_bound(got, want, q, k, v)
        ok = (got.dtype == want.dtype and got.shape == want.shape
              and bool(torch.isfinite(got).all()) and ratio <= 1.0)
        emit({"phase": "kernel_vs_plain", "kernel": kernel, "case": case,
              "max_abs_err": err, "err_over_bound": ratio, "ok": ok})
        check(ok, f"{kernel} {case}: error {err} at {ratio} of its bound")
        return err

    gen_s = torch.Generator(device=dev).manual_seed(15)

    def randn_s(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=gen_s, device=dev).to(dtype)

    # the attention kernels at ragged shapes, GQA 1:1, 4:1 and 5:1,
    # causal or not, windows, D 64 and 128, float32 and bfloat16; mha also
    # at shapes of several 128-row tiles (bfloat16 on the wgmma route,
    # float32 on the FFMA route)
    for dt in (torch.float32, torch.bfloat16):
        for hq, hkv in ((4, 4), (8, 2), (5, 1)):
            for d in (64, 128):
                for causal, window in ((True, None), (False, None),
                                       (True, 8), (False, 32)):
                    for sq, skv in ((RAGGED_SQ, RAGGED_SKV), *MHA_TILED):
                        q, k, v = (randn_s(2, h, s, d, dtype=dt)
                                   for h, s in ((hq, sq), (hkv, skv),
                                                (hkv, skv)))
                        got = timed_first("mha", lambda: ops.mha(
                            q, k, v, causal=causal, window=window))
                        attn_case("mha", f"{str(dt)[6:]} {hq}:{hkv} D{d} "
                                  f"Sq{sq} Skv{skv} causal {causal} "
                                  f"window {window} route "
                                  f"{k_attn.mha_route(q, k, v)}", got,
                                  k_attn.mha_plain(q, k, v, causal=causal,
                                                   window=window), q, k, v)
                for window in (None, 8, 64):
                    smax = 1500
                    q = randn_s(4, hq, d, dtype=dt)
                    kc, vc = (randn_s(4, smax, hkv, d, dtype=dt).permute(
                        0, 2, 1, 3) for _ in range(2))
                    lens = torch.tensor([0, 1, 70, smax], dtype=torch.int32,
                                        device=dev)
                    got = timed_first("decode_attention",
                                      lambda: ops.decode_attention(
                                          q, kc, vc, lens, window=window))
                    attn_case("decode_attention",
                              f"{str(dt)[6:]} {hq}:{hkv} D{d} lens "
                              f"[0, 1, 70, {smax}] window {window}", got,
                              k_dec.decode_attention_plain(
                                  q, kc, vc, lens, window=window), q, kc, vc)
                    check(bool((got[0] == 0).all()),
                          "decode_attention: len 0 does not give 0")
                # lengths at the tiles' edges and past the capacity
                # (capped; the window counts back from the length)
                smax = 1500
                lens = torch.tensor([*DECODE_LENS_EDGES, smax, smax + 7],
                                    dtype=torch.int32, device=dev)
                q = randn_s(len(lens), hq, d, dtype=dt)
                kc, vc = (randn_s(len(lens), smax, hkv, d,
                                  dtype=dt).permute(0, 2, 1, 3)
                          for _ in range(2))
                for window in (None, 8):
                    got = ops.decode_attention(q, kc, vc, lens,
                                               window=window)
                    attn_case("decode_attention",
                              f"{str(dt)[6:]} {hq}:{hkv} D{d} lens "
                              f"{lens.tolist()} window {window} route "
                              f"{k_dec.decode_route(q, kc, vc)}", got,
                              k_dec.decode_attention_plain(
                                  q, kc, vc, lens, window=window), q, kc, vc)

    # heads of other widths, v at a width of its own: MiniCPM3's (96, 64)
    # and H2O-Danube3's (120, 120) in bfloat16 on the wgmma route (padded
    # to 128 columns by TMA's zero fill), (96, 64) in float32 on the FFMA
    # route
    for dt_name, d, dv, route in MHA_WIDTHS:
        dt = getattr(torch, dt_name)
        for hq, hkv in ((4, 4), (8, 2), (5, 1)):
            for causal, window in ((True, None), (False, None), (True, 8),
                                   (False, 32)):
                for sq, skv in ((RAGGED_SQ, RAGGED_SKV), *MHA_TILED):
                    q, k = (randn_s(2, h, s, d, dtype=dt)
                            for h, s in ((hq, sq), (hkv, skv)))
                    v = randn_s(2, hkv, skv, dv, dtype=dt)
                    check(k_attn.mha_route(q, k, v) == route,
                          f"mha at d {d}, dv {dv}, {dt}: route "
                          f"{k_attn.mha_route(q, k, v)}, want {route}")
                    got = ops.mha(q, k, v, causal=causal, window=window)
                    attn_case("mha", f"{str(dt)[6:]} {hq}:{hkv} d{d} dv{dv} "
                              f"Sq{sq} Skv{skv} causal {causal} window "
                              f"{window} route {route}", got,
                              k_attn.mha_plain(q, k, v, causal=causal,
                                               window=window), q, k, v)

    cfg_s = get_config("llama3-8b")
    t0 = time.perf_counter()
    model = init_params(cfg_s, 0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    rng_s = np.random.default_rng(0)
    plens = rng_s.integers(256, 2049, SERVE_BATCH)
    reqs = [rng_s.integers(1, cfg_s.vocab_size, int(n)).tolist()
            for n in plens]
    ((prompts, valid),) = pad_and_batch(reqs, SERVE_BATCH)
    s_p = prompts.shape[1]
    max_len = s_p + SERVE_NEW
    prompts = prompts.to(dev)
    engine = ServeEngine(cfg_s, model, max_len=max_len,
                         batch_size=SERVE_BATCH)
    res, counts = counted_run(lambda: engine.generate(
        prompts, max_new_tokens=SERVE_NEW, valid=valid))
    nonzero = {k: c for k, c in counts.items() if c}
    want = {"mha": cfg_s.n_layers,
            "decode_attention": cfg_s.n_layers * (SERVE_NEW - 1)}
    # every prefill layer on the wgmma route, every step on the mma route
    route_counts = {
        "mha": dict(ops.mha.route_launches),
        "decode_attention": dict(ops.decode_attention.route_launches)}
    want_routes = {"mha": {"wgmma": want["mha"], "ffma": 0},
                   "decode_attention": {"mma": want["decode_attention"],
                                        "simt": 0}}
    toks = torch.tensor(res.tokens, device=dev)
    ok = (nonzero == want and route_counts == want_routes
          and res.steps == SERVE_NEW
          and tuple(toks.shape) == (SERVE_BATCH, SERVE_NEW)
          and bool(((toks >= 0) & (toks < cfg_s.vocab_size)).all()))
    emit({"phase": "main_path", "program": "ServeEngine.generate",
          "arch": cfg_s.name, "layers": cfg_s.n_layers,
          "d_model": cfg_s.d_model, "dtype": cfg_s.dtype,
          "params": sum(p.numel() for p in model.parameters()),
          "init_s": init_s, "prompt_lens": plens.tolist(),
          "padded_len": s_p, "max_len": max_len, "new_tokens": SERVE_NEW,
          "launches": nonzero, "want": want, "routes": route_counts,
          "want_routes": want_routes,
          "tokens_row0": res.tokens[0], "ok": ok})
    check(ok, f"serve: launches {nonzero} (want {want}), routes "
              f"{route_counts} (want {want_routes}), steps {res.steps}, "
              f"tokens {tuple(toks.shape)}")

    @contextlib.contextmanager
    def plain_attention():
        """The same model with the attention kernels' plain versions."""
        saved = m_attn.mha, m_attn.decode_attention
        m_attn.mha = k_attn.mha_plain
        m_attn.decode_attention = k_dec.decode_attention_plain
        try:
            yield
        finally:
            m_attn.mha, m_attn.decode_attention = saved

    def forced_logits():
        """Prefill logits and SERVE_FORCED decode steps fed the kernel
        run's tokens, in float32."""
        logits, cache, pos = prefill(model, cfg_s, prompts, max_len)
        out = [logits.float()]
        for t in range(SERVE_FORCED):
            logits, cache = decode_step(model, cfg_s,
                                        toks[:, t].to(torch.int32), cache,
                                        pos + t)
            out.append(logits.float())
        return out

    kern = forced_logits()
    with plain_attention():
        plain = forced_logits()
    logit_err, rel = 0.0, []
    for t, (a, b) in enumerate(zip(kern, plain)):
        logit_err = max(logit_err, float((a - b).abs().max()))
        rel.append(float((a - b).norm() / b.norm()))
    same = all(bool(torch.equal(kern[t].argmax(-1), toks[:, t]))
               for t in range(SERVE_FORCED + 1))
    ok = (max(rel) <= SERVE_REL_RMS and same
          and all(bool(torch.isfinite(a).all()) for a in kern))
    emit({"phase": "main_path_check", "program": "serve logits vs plain "
          "attention", "steps": ["prefill"] + [f"decode {t}" for t in
                                               range(SERVE_FORCED)],
          "rel_rms": rel, "bound": SERVE_REL_RMS,
          "max_abs_logit_err": logit_err,
          "logit_scale": float(plain[0].abs().max()),
          "kernel_run_reproduces_engine_tokens": same, "ok": ok})
    check(ok, f"serve logits: relative RMS {rel} (bound {SERVE_REL_RMS}), "
              f"engine tokens reproduced: {same}")
    del plain

    def margin_agreement(arch, a_toks, p_toks, margins, logit_err):
        """Rows of greedy tokens (B, T) of the kernel run against the
        plain run's: equal wherever the plain run's top-1/top-2 margin
        exceeds twice the logit error, a row followed up to its first
        token that differs below that margin (whose continuations differ
        from there on where the tokens are fed back)."""
        checked = agreed = 0
        diverged = []
        for r in range(p_toks.shape[0]):
            for t in range(p_toks.shape[1]):
                if int(p_toks[r, t]) == int(a_toks[r, t]):
                    agreed += 1
                    if float(margins[r, t]) > 2 * logit_err:
                        checked += 1
                    continue
                if float(margins[r, t]) > 2 * logit_err:
                    check(False, f"serve {arch} row {r} step {t}: token "
                                 f"{int(a_toks[r, t])} != "
                                 f"{int(p_toks[r, t])} at margin "
                                 f"{float(margins[r, t])} > 2 x {logit_err}")
                diverged.append([r, t, float(margins[r, t])])
                break
        return {"agreed": agreed, "checked_above_margin": checked,
                "diverged_below_margin": diverged,
                "margin_needed": 2 * logit_err}

    # greedy with plain attention; its tokens must equal the kernel run's
    # wherever its top-1/top-2 margin exceeds twice the logit error
    with plain_attention():
        logits, cache, pos = prefill(model, cfg_s, prompts, max_len)
        p_toks, margins = [], []
        for t in range(SERVE_NEW):
            top2 = logits.float().topk(2, dim=-1).values
            margins.append(top2[:, 0] - top2[:, 1])
            p_toks.append(logits.argmax(-1).to(torch.int32))
            if t < SERVE_NEW - 1:
                logits, cache = decode_step(model, cfg_s, p_toks[-1], cache,
                                            pos + t)
    p_toks = torch.stack(p_toks, 1).cpu()
    margins = torch.stack(margins, 1).cpu()
    del cache, logits
    emit({"phase": "main_path_check", "program": "serve greedy tokens vs "
          "plain attention", **margin_agreement(
              cfg_s.name, torch.tensor(res.tokens), p_toks, margins,
              logit_err), "ok": True})

    # times of the serve path (host clock around synchronised work)
    def wall_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    prefill_ms = wall_ms(lambda: prefill(model, cfg_s, prompts, max_len))
    gen_ms = wall_ms(lambda: engine.generate(
        prompts, max_new_tokens=SERVE_NEW, valid=valid), reps=2)
    def step_times():
        """Host issue ms and event ms of each of SERVE_NEW - 1 greedy
        decode steps after a prefill."""
        _, cache, pos = prefill(model, cfg_s, prompts, max_len)
        tok = toks[:, 0].to(torch.int32)
        lens = torch.full((SERVE_BATCH,), pos + 1, dtype=torch.int32,
                          device=dev)
        issue, step_ev = [], []
        for t in range(SERVE_NEW - 1):
            ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev0.record()
            logits, cache = decode_step(model, cfg_s, tok, cache, pos + t,
                                        cache_len=lens)
            tok = logits.argmax(-1).to(torch.int32)
            ev1.record()
            issue.append((time.perf_counter() - t0) * 1e3)
            ev1.synchronize()
            step_ev.append(ev0.elapsed_time(ev1))
            lens.add_(1)
        return issue, step_ev

    issue, step_ev = step_times()
    decode_ms = (gen_ms - prefill_ms) / (SERVE_NEW - 1)
    emit({"phase": "times", "program": "serve llama3-8b", "batch":
          SERVE_BATCH, "padded_len": s_p, "new_tokens": SERVE_NEW,
          "prefill_ms": prefill_ms, "generate_ms": gen_ms,
          "decode_ms_per_step": decode_ms,
          "decode_tokens_per_s": SERVE_BATCH / decode_ms * 1e3,
          "generate_tokens_per_s": SERVE_BATCH * SERVE_NEW / gen_ms * 1e3,
          "step_event_ms_median": sorted(step_ev)[len(step_ev) // 2],
          "step_host_issue_ms_median": sorted(issue)[len(issue) // 2],
          "step_host_issue_ms": issue,
          "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})

    # the same model with every dense projection on the port's gemm
    # (use_gemm_kernel, the reference's use_pallas(True) path): the
    # bfloat16 products on the wgmma route. Logits against the default
    # (torch.matmul) run within SERVE_REL_RMS: only the float32 summation
    # order of each projection differs, as with the attention kernels
    from repro_torch.models.layers import use_gemm_kernel

    t_dense = time.perf_counter()
    per_pass = SERVE_DENSE_LAUNCHES * cfg_s.n_layers + 1
    pass_counts, gemm_logits = [], []
    with use_gemm_kernel():
        res_g, counts = counted_run(lambda: engine.generate(
            prompts, max_new_tokens=SERVE_NEW, valid=valid))
        routes_g = dict(last_routes)
        # prefill and SERVE_FORCED steps fed the default run's tokens,
        # each pass counted on its own
        (logits, cache, pos), c = counted_run(
            lambda: prefill(model, cfg_s, prompts, max_len))
        pass_counts.append((c, dict(last_routes)))
        gemm_logits.append(logits.float())
        for t in range(SERVE_FORCED):
            (logits, cache), c = counted_run(
                lambda: decode_step(model, cfg_s, toks[:, t].to(torch.int32),
                                    cache, pos + t))
            pass_counts.append((c, dict(last_routes)))
            gemm_logits.append(logits.float())
    del cache, logits
    nonzero = {k: c for k, c in counts.items() if c}
    want = {"gemm": per_pass * SERVE_NEW, "mha": cfg_s.n_layers,
            "decode_attention": cfg_s.n_layers * (SERVE_NEW - 1)}
    want_routes = {"gemm": {"wgmma": want["gemm"]},
                   "mha": {"wgmma": want["mha"]},
                   "decode_attention": {"mma": want["decode_attention"]}}
    passes_ok = all(
        c["gemm"] == per_pass and r["gemm"] == {"wgmma": per_pass}
        for c, r in pass_counts)
    rel_g = [float((a - b).norm() / b.norm())
             for a, b in zip(gemm_logits, kern)]
    logit_err_g = max(float((a - b).abs().max())
                      for a, b in zip(gemm_logits, kern))
    toks_g = torch.tensor(res_g.tokens)
    ok = (nonzero == want and routes_g == want_routes and passes_ok
          and max(rel_g) <= SERVE_REL_RMS and res_g.steps == SERVE_NEW
          and tuple(toks_g.shape) == (SERVE_BATCH, SERVE_NEW)
          and all(bool(torch.isfinite(a).all()) for a in gemm_logits))
    emit({"phase": "main_path", "program": "ServeEngine.generate under "
          "use_gemm_kernel()", "arch": cfg_s.name, "launches": nonzero,
          "want": want, "routes": routes_g, "want_routes": want_routes,
          "gemm_launches_per_pass": [c["gemm"] for c, _ in pass_counts],
          "gemm_routes_per_pass": [r["gemm"] for _, r in pass_counts],
          "want_per_pass": per_pass, "rel_rms_vs_default": rel_g,
          "bound": SERVE_REL_RMS, "max_abs_logit_err": logit_err_g,
          "tokens_row0": res_g.tokens[0], "ok": ok})
    check(ok, f"serve under use_gemm_kernel: launches {nonzero} (want "
              f"{want}), routes {routes_g}, per pass {pass_counts}, "
              f"relative RMS {rel_g} (bound {SERVE_REL_RMS})")
    del kern, gemm_logits

    # the default run's greedy tokens and their top-1/top-2 margins; the
    # gemm run's tokens must equal them wherever the margin exceeds twice
    # the logit difference
    logits, cache, pos = prefill(model, cfg_s, prompts, max_len)
    d_toks, d_margins = [], []
    for t in range(SERVE_NEW):
        top2 = logits.float().topk(2, dim=-1).values
        d_margins.append(top2[:, 0] - top2[:, 1])
        d_toks.append(logits.argmax(-1).to(torch.int32))
        if t < SERVE_NEW - 1:
            logits, cache = decode_step(model, cfg_s, d_toks[-1], cache,
                                        pos + t)
    d_toks = torch.stack(d_toks, 1).cpu()
    d_margins = torch.stack(d_margins, 1).cpu()
    del cache, logits
    emit({"phase": "main_path_check", "program": "serve greedy tokens "
          "under use_gemm_kernel() vs the default run",
          "default_loop_reproduces_engine": bool(torch.equal(
              d_toks, torch.tensor(res.tokens, dtype=torch.int32))),
          **margin_agreement(cfg_s.name, toks_g, d_toks, d_margins,
                             logit_err_g), "ok": True})

    with use_gemm_kernel():
        prefill_g = wall_ms(lambda: prefill(model, cfg_s, prompts, max_len))
        gen_g = wall_ms(lambda: engine.generate(
            prompts, max_new_tokens=SERVE_NEW, valid=valid), reps=2)
        issue_g, step_ev_g = step_times()
    # bounds: the dense products' operations (2 x weights x tokens, the
    # LM head at B rows) at the bfloat16 tensor-core rate; a step's
    # weights (every parameter but the embedding table) at HBM's rate
    dense_names = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
    layer_w = sum(blk.p[k].numel() for blk in model.blocks
                  for k in dense_names)
    head_w = model.lm_head.numel()
    prefill_flops = 2 * layer_w * SERVE_BATCH * s_p \
        + 2 * head_w * SERVE_BATCH
    step_bytes = sum(q.numel() * q.element_size()
                     for q in model.parameters()) \
        - model.embed.numel() * model.embed.element_size()
    decode_g = (gen_g - prefill_g) / (SERVE_NEW - 1)
    emit({"phase": "times", "program": "serve llama3-8b under "
          "use_gemm_kernel()", "batch": SERVE_BATCH, "padded_len": s_p,
          "prefill_ms": prefill_g, "default_prefill_ms": prefill_ms,
          "prefill_bound_ms": prefill_flops / BF16_FLOPS_PER_S * 1e3,
          "prefill_bound_by": "operations (dense products)",
          "decode_ms_per_step": decode_g,
          "default_decode_ms_per_step": decode_ms,
          "decode_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
          "decode_bound_by": "bytes (weights)",
          "step_event_ms_median": sorted(step_ev_g)[len(step_ev_g) // 2],
          "default_step_event_ms_median":
              sorted(step_ev)[len(step_ev) // 2],
          "step_host_issue_ms_median": sorted(issue_g)[len(issue_g) // 2],
          "default_step_host_issue_ms_median":
              sorted(issue)[len(issue) // 2],
          "dense_weights_per_layer": layer_w // cfg_s.n_layers,
          "step_weight_gb": step_bytes / 1e9,
          "seconds": time.perf_counter() - t_dense})

    # the kernels at the serve shapes: a prefill layer and a decode step
    # in the middle of the generation
    sq_, sk_ = randn_s(SERVE_BATCH, cfg_s.n_heads, s_p, cfg_s.head_dim), \
        randn_s(SERVE_BATCH, cfg_s.n_kv_heads, s_p, cfg_s.head_dim)
    sv_ = randn_s(SERVE_BATCH, cfg_s.n_kv_heads, s_p, cfg_s.head_dim)
    errors["mha"] = attn_case(
        "mha", f"serve prefill layer B {SERVE_BATCH} S {s_p} bf16",
        ops.mha(sq_, sk_, sv_), k_attn.mha_plain(sq_, sk_, sv_),
        sq_, sk_, sv_)
    mid = s_p + SERVE_NEW // 2
    dq = randn_s(SERVE_BATCH, cfg_s.n_heads, cfg_s.head_dim)
    dk, dv = (randn_s(SERVE_BATCH, max_len, cfg_s.n_kv_heads,
                      cfg_s.head_dim).permute(0, 2, 1, 3) for _ in range(2))
    dlen = torch.full((SERVE_BATCH,), mid, dtype=torch.int32, device=dev)
    errors["decode_attention"] = attn_case(
        "decode_attention", f"serve decode step B {SERVE_BATCH} len {mid} "
        f"of {max_len} bf16", ops.decode_attention(dq, dk, dv, dlen),
        k_dec.decode_attention_plain(dq, dk, dv, dlen), dq, dk, dv)
    del model, engine
    torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # 2f. sliding-window and MoE serving at full width, bfloat16:
    # mixtral-8x22b (4 of its 56 layers), deepseek-moe-16b and
    # h2o-danube-3-4b (all layers)
    # ------------------------------------------------------------------
    import dataclasses

    from repro_torch.models import model as m_model, moe as m_moe

    def mha_plain_rows(q, k, v, *, causal=True, window=None):
        """mha's plain version one batch row at a time: the float32
        scores of every row at once (29 GB at mixtral's prefill) would
        not fit beside the weights."""
        return torch.cat([k_attn.mha_plain(q[i:i + 1], k[i:i + 1],
                                           v[i:i + 1], causal=causal,
                                           window=window)
                          for i in range(q.shape[0])])

    @contextlib.contextmanager
    def plain_rows_attention():
        """The model with the attention kernels' plain versions."""
        saved = m_attn.mha, m_attn.decode_attention
        m_attn.mha = mha_plain_rows
        m_attn.decode_attention = k_dec.decode_attention_plain
        try:
            yield
        finally:
            m_attn.mha, m_attn.decode_attention = saved

    @contextlib.contextmanager
    def routing(store, flips=None):
        """flips None: keep each MoE call's (T, k) experts in `store`.
        Else route each call as the recorded run did, the gates from this
        run's own probabilities of those experts, and append to `flips`
        the count of tokens whose own top-k set differs: a near tie that
        the two runs break apart moves a token by a whole expert, which
        says nothing of the attention kernels' error."""
        own = m_moe.route_topk
        calls = iter(store)

        def record(logits, k):
            gates, experts = own(logits, k)
            store.append(experts)
            return gates, experts

        def replay(logits, k):
            _, mine = own(logits, k)
            experts = next(calls)
            probs = torch.softmax(logits.float(), dim=-1).gather(1, experts)
            flips.append((mine.sort(-1).values != experts.sort(-1).values)
                         .any(-1).sum())
            return probs / probs.sum(-1, keepdim=True), experts

        m_moe.route_topk = record if flips is None else replay
        try:
            yield
        finally:
            m_moe.route_topk = own

    def decode_run(cfg, model, prompts, max_len, steps, feed=None):
        """Prefill, then steps - 1 decode steps fed `feed[:, t]` or the
        run's own greedy tokens: (tokens (B, steps) on the host, the
        float32 logits of the first SERVE_FORCED + 1 passes, top-1/top-2
        margins (B, steps) on the host)."""
        logits, cache, pos = prefill(model, cfg, prompts, max_len)
        toks, kept, margins = [], [], []
        for t in range(steps):
            lf = logits.float()
            if t <= SERVE_FORCED:
                kept.append(lf)
            top2 = lf.topk(2, dim=-1).values
            margins.append(top2[:, 0] - top2[:, 1])
            toks.append(logits.argmax(-1).to(torch.int32))
            if t < steps - 1:
                nxt = toks[-1] if feed is None else feed[:, t]
                logits, cache = decode_step(model, cfg, nxt, cache, pos + t)
        del cache
        return (torch.stack(toks, 1).cpu(), kept,
                torch.stack(margins, 1).cpu())

    def event_ms(fn, reps=10, warm=2):
        for _ in range(warm):
            fn()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        for _ in range(reps):
            fn()
        ev1.record()
        ev1.synchronize()
        return ev0.elapsed_time(ev1) / reps

    def kernel_case_timed(name, case, fn, plain, libs, q, k, v, flops,
                          nbytes, graphs=False):
        """The kernel against its plain version at a serve shape; then
        the device times (CUDA events) of the kernel (10 calls), of the
        plain version (3) and of each PyTorch call in `libs` ({key:
        callable}; 10 calls, each first held against the plain output,
        and None with the error where the call cannot run), and the
        kernel's bound. With `graphs`, also the kernel's and each library
        call's time in a CUDA graph (`graph_ms`, `<key>_graph_ms`). The
        port never calls these library functions."""
        want = plain()
        row = {"kernel": name, "case": case,
               "max_abs_err": attn_case(name, case, fn(), want, q, k, v),
               "ms": event_ms(fn),
               "plain_ms": event_ms(plain, reps=3, warm=0),
               "bound_ms": max(flops / BF16_FLOPS_PER_S,
                               nbytes / HBM_BYTES_PER_S) * 1e3}
        if graphs:
            row["graph_ms"] = graph_ms(fn)
        for key, lib_fn in libs.items():
            try:
                got = lib_fn()
                row[key] = event_ms(lib_fn)
                if graphs:
                    row[f"{key[:-3]}_graph_ms"] = graph_ms(lib_fn)
                row[f"{key}_err_over_bound"] = attn_bound(
                    got.reshape(want.shape), want, q, k, v)[1]
                del got
            except (torch.OutOfMemoryError, RuntimeError) as exc:
                row[key] = None
                row[f"{key}_error"] = str(exc).splitlines()[0][:200]
            torch.cuda.empty_cache()
        del want
        return row

    def sdpa_calls(q, k, v, window):
        """The library yardsticks of a windowed prefill layer: one
        F.scaled_dot_product_attention call with GQA and a boolean band
        mask (causal only, no mask, without a window), and one on K and
        V expanded to the query heads (the expansion untimed), which
        the memory-efficient backend takes with a mask."""
        if window is None:
            return {"library_ms": lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True)}
        i = torch.arange(q.shape[2], device=dev)
        band = (i[:, None] >= i[None]) & (i[:, None] - i[None] < window)
        rep = q.shape[1] // k.shape[1]
        kx, vx = (t.repeat_interleave(rep, dim=1) for t in (k, v))
        return {"library_ms": lambda: F.scaled_dot_product_attention(
                    q, k, v, attn_mask=band, enable_gqa=True),
                "library_ms_expanded_kv":
                    lambda: F.scaled_dot_product_attention(
                        q, kx, vx, attn_mask=band)}

    for i_cfg, (arch, depth, batch, (lo, hi)) in enumerate(SWA_MOE_SERVE):
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth, segments=(
                (cfg.segments[0][0], depth),))
        mo = cfg.moe
        layers, hd = cfg.n_layers, cfg.head_dim
        rng = np.random.default_rng(1 + i_cfg)
        plens = rng.integers(lo, hi + 1, batch)
        if arch == "h2o-danube-3-4b":
            plens[0] = hi         # 4080: decode crosses W = 4096 at step 16
        reqs = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
                for n in plens]
        ((prompts, valid),) = pad_and_batch(reqs, batch)
        s_p = prompts.shape[1]
        max_len = s_p + SERVE_NEW
        w_slots = m_model._swa_cache_len(cfg, max_len)
        prompts = prompts.to(dev)
        # 16-bit heads up to 128 take the wgmma and the mma route (D 120
        # padded to 128 by TMA's zero fill)
        mha_route = "wgmma" if hd <= 128 else "ffma"
        dec_route = "mma" if hd <= 128 else "simt"

        # the kernels at this config's serve shapes, before its weights
        # take the card: a prefill layer (with the window, over the band),
        # and a decode step over the ring's view, filled and not yet
        kq = randn_s(batch, s_p, cfg.n_heads, hd).transpose(1, 2)
        kk, kv = (randn_s(batch, s_p, cfg.n_kv_heads, hd).transpose(1, 2)
                  for _ in range(2))
        check(k_attn.mha_route(kq, kk, kv) == mha_route,
              f"{arch}: mha route {k_attn.mha_route(kq, kk, kv)}")
        case = (f"{arch} prefill layer B {batch} S {s_p} D {hd} window "
                f"{cfg.window} bf16 route {mha_route}")
        kern_rows = [kernel_case_timed(
            "mha", case, lambda: ops.mha(kq, kk, kv, window=cfg.window),
            lambda: mha_plain_rows(kq, kk, kv, window=cfg.window),
            sdpa_calls(kq, kk, kv, cfg.window), kq, kk, kv,
            4 * hd * batch * cfg.n_heads * visible_pairs(s_p, cfg.window),
            2 * 2 * batch * s_p * hd * (cfg.n_heads + cfg.n_kv_heads))]
        del kq, kk, kv
        rq = randn_s(batch, cfg.n_heads, hd)
        rk, rv = (randn_s(batch, w_slots, cfg.n_kv_heads, hd).permute(
            0, 2, 1, 3) for _ in range(2))
        check(k_dec.decode_route(rq, rk, rv) == dec_route,
              f"{arch}: decode route {k_dec.decode_route(rq, rk, rv)}")
        for fill, lens in (
                ("full", torch.full((batch,), w_slots, dtype=torch.int32,
                                    device=dev)),
                ("short", torch.tensor(
                    [(i * 997) % w_slots + 1 for i in range(batch)],
                    dtype=torch.int32, device=dev))):
            case = (f"{arch} decode step over the "
                    f"{'ring' if cfg.window else 'cache'} B {batch} "
                    f"slots {w_slots} lens {fill} D {hd} bf16 route "
                    f"{dec_route}")
            n_keys = int(lens.sum())
            # the library yardstick: SDPA over the view, all slots valid
            # with no mask, a short fill with a boolean key mask
            key_mask = (None if fill == "full" else
                        (torch.arange(w_slots, device=dev)[None]
                         < lens[:, None])[:, None, None])
            kern_rows.append(kernel_case_timed(
                "decode_attention", case,
                lambda: ops.decode_attention(rq, rk, rv, lens),
                lambda: k_dec.decode_attention_plain(rq, rk, rv, lens),
                {"library_ms": lambda: F.scaled_dot_product_attention(
                    rq[:, :, None], rk, rv, attn_mask=key_mask,
                    enable_gqa=True)},
                rq, rk, rv, 4 * cfg.n_heads * n_keys * hd,
                2 * 2 * n_keys * cfg.n_kv_heads * hd
                + 2 * 2 * batch * cfg.n_heads * hd, graphs=True))
        del rq, rk, rv
        emit({"phase": "kernel_times", "arch": arch, "rows": kern_rows,
              "nvidia_smi": smi})

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = init_params(cfg, 0, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
        engine = ServeEngine(cfg, model, max_len=max_len, batch_size=batch)
        res, counts = counted_run(lambda: engine.generate(
            prompts, max_new_tokens=SERVE_NEW, valid=valid))
        nonzero = {k: c for k, c in counts.items() if c}
        routes_taken = {k: dict(v) for k, v in last_routes.items()}
        want = {"mha": layers, "decode_attention": layers * (SERVE_NEW - 1)}
        want_routes = {"mha": {mha_route: want["mha"]},
                       "decode_attention": {dec_route:
                                            want["decode_attention"]}}
        toks = torch.tensor(res.tokens, device=dev)
        ok = (nonzero == want and routes_taken == want_routes
              and res.steps == SERVE_NEW
              and tuple(toks.shape) == (batch, SERVE_NEW)
              and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()))
        emit({"phase": "main_path", "program": "ServeEngine.generate",
              "arch": arch, "layers": layers, "of_layers":
              get_config(arch).n_layers, "d_model": cfg.d_model,
              "head_dim": hd, "dtype": cfg.dtype, "window": cfg.window,
              "ring_slots": w_slots if cfg.window else None,
              "moe": dataclasses.asdict(cfg.moe) if cfg.moe else None,
              "params": sum(p.numel() for p in model.parameters()),
              "weight_gb": n_bytes / 1e9, "init_s": init_s,
              "prompt_lens": plens.tolist(), "padded_len": s_p,
              "max_len": max_len, "new_tokens": SERVE_NEW,
              "launches": nonzero, "want": want, "routes": routes_taken,
              "want_routes": want_routes, "tokens_row0": res.tokens[0],
              "ok": ok})
        check(ok, f"serve {arch}: launches {nonzero} (want {want}), routes "
                  f"{routes_taken} (want {want_routes}), steps "
                  f"{res.steps}, tokens {tuple(toks.shape)}")

        # the kernel run again, greedy, its routing recorded; then plain
        # attention teacher-forced on its tokens and greedy on its own,
        # both routed as the kernel run was
        n_moe = sum(c for kind, c in cfg.segments if kind == "attn_moe")
        store: list = []
        with routing(store):
            k_toks, kern, _ = decode_run(cfg, model, prompts, max_len,
                                         SERVE_NEW)
        same = bool(torch.equal(k_toks, torch.tensor(res.tokens)))
        feed = k_toks.to(dev)
        flips: list = []
        with plain_rows_attention(), routing(store, flips):
            _, plain, _ = decode_run(cfg, model, prompts, max_len,
                                     SERVE_FORCED + 1, feed)
        logit_err, rel = 0.0, []
        for a, b_ in zip(kern, plain):
            logit_err = max(logit_err, float((a - b_).abs().max()))
            rel.append(float((a - b_).norm() / b_.norm()))
        free_rel = None
        if n_moe:        # for the record: plain attention routing itself
            with plain_rows_attention():
                _, free, _ = decode_run(cfg, model, prompts, max_len,
                                        SERVE_FORCED + 1, feed)
            free_rel = [float((a - b_).norm() / b_.norm())
                        for a, b_ in zip(kern, free)]
            del free
        flips_n = [int(f) for f in flips]
        # per MoE layer: tokens whose top-k set the plain run would pick
        # otherwise, in prefill (of B S) and over the forced steps (of B
        # each)
        flip_rows = [{"layer": j, "prefill": flips_n[j],
                      "decode": sum(flips_n[j + n_moe * (1 + t)]
                                    for t in range(SERVE_FORCED))}
                     for j in range(n_moe)]
        ok = (max(rel) <= SERVE_REL_RMS and same
              and all(bool(torch.isfinite(a).all()) for a in kern))
        emit({"phase": "main_path_check", "program": "serve logits vs plain "
              "attention", "arch": arch, "steps": ["prefill"] + [
                  f"decode {t}" for t in range(SERVE_FORCED)],
              "rel_rms": rel, "bound": SERVE_REL_RMS,
              "rel_rms_plain_routing_its_own": free_rel,
              "max_abs_logit_err": logit_err,
              "logit_scale": float(plain[0].abs().max()),
              "topk_set_flips_per_layer": flip_rows,
              "kernel_run_reproduces_engine_tokens": same, "ok": ok})
        check(ok, f"serve {arch} logits: relative RMS {rel} (bound "
                  f"{SERVE_REL_RMS}), engine tokens reproduced: {same}")
        del kern, plain

        # what the capacity dropped (recorded routing), prefill and
        # decode: (capacity, pairs dropped, tokens with a pair dropped)
        # per MoE call
        drops = []
        for i, experts in enumerate(store):
            cf = (mo.capacity_factor if i < n_moe
                  else max(4.0, mo.capacity_factor))
            cap = m_moe.capacity(experts.shape[0], mo.top_k, mo.n_experts,
                                 cf)
            order, _, keep = m_moe.dispatch(experts, mo.n_experts, cap)
            drops.append((cap, int((~keep).sum()), int(
                (order[~keep] // mo.top_k).unique().numel())))
        if n_moe:
            # where the prefill's pairs went, per MoE layer: tokens per
            # expert over all B S tokens and over the requests' own
            # tokens alone (left padding excluded), and the pairs the
            # capacity dropped among those own tokens
            real = (torch.arange(s_p, device=dev)[None] >= torch.as_tensor(
                s_p - plens, device=dev)[:, None]).reshape(-1)
            load_rows = []
            for j, experts in enumerate(store[:n_moe]):
                order, _, keep = m_moe.dispatch(experts, mo.n_experts,
                                                drops[j][0])
                own = real[order // mo.top_k]
                per_all = torch.bincount(experts.reshape(-1),
                                         minlength=mo.n_experts)
                per_own = torch.bincount(experts[real].reshape(-1),
                                         minlength=mo.n_experts)
                load_rows.append({
                    "layer": j, "capacity": drops[j][0],
                    "tokens_per_expert": per_all.tolist(),
                    "own_tokens_per_expert": per_own.tolist(),
                    "pairs_dropped": drops[j][1],
                    "own_pairs_dropped": int((own & ~keep).sum()),
                    "own_tokens_with_a_drop": int(
                        (order[own & ~keep] // mo.top_k).unique().numel())})
            emit({"phase": "moe_routing", "arch": arch, "part": "prefill",
                  "tokens": batch * s_p, "own_tokens": int(real.sum()),
                  "top_k": mo.top_k, "layers": load_rows})

            # the MoE FFN at full width against its dense oracle, in
            # float32 with no drops (cf = E), on the first MoE layer's
            # weights: 2e-4 of max|want|, as tests/test_moe.py holds the
            # reference to its oracle
            blk = next(blocks[0] for kind, blocks in model.segment_blocks()
                       if kind == "attn_moe")
            p32 = {n: t.float() for n, t in blk.p.items()
                   if n.startswith(("router", "we_", "ws_"))}
            x32 = torch.randn(256, cfg.d_model, generator=gen_s,
                              device=dev)
            got = m_moe.moe_ffn(p32, x32, n_experts=mo.n_experts,
                                top_k=mo.top_k,
                                capacity_factor=float(mo.n_experts),
                                act=cfg.act)
            want_o = m_moe.moe_ffn_reference(p32, x32,
                                             n_experts=mo.n_experts,
                                             top_k=mo.top_k, act=cfg.act)
            err = float((got - want_o).abs().max())
            scale = float(want_o.abs().max())
            ok = (not torch.backends.cuda.matmul.allow_tf32
                  and err <= 2e-4 * scale)
            emit({"phase": "main_path_check", "program": "moe_ffn vs its "
                  "dense oracle at full width, float32, no drops",
                  "arch": arch, "tokens": 256, "max_abs_err": err,
                  "bound": 2e-4 * scale, "ok": ok})
            check(ok, f"{arch}: moe_ffn against its dense oracle: {err} "
                      f"(bound {2e-4 * scale})")
            del p32, x32, got, want_o
            torch.cuda.empty_cache()

        with plain_rows_attention(), routing(store, []):
            p_toks, _, margins = decode_run(cfg, model, prompts, max_len,
                                            SERVE_NEW)
        emit({"phase": "main_path_check", "program": "serve greedy tokens "
              "vs plain attention", "arch": arch, **margin_agreement(
                  arch, torch.tensor(res.tokens), p_toks, margins,
                  logit_err), "ok": True})

        # times beside their bounds: prefill by its operations (the
        # attention over the visible band, the experts' grouped products
        # over their E x capacity buffer as the code runs them, and over
        # the kept pairs alone), a decode step by its bytes (every weight
        # once, every expert of every layer as the grouped products read
        # them, and the cached K and V rows in reach)
        prefill_ms = wall_ms(lambda: prefill(model, cfg, prompts, max_len))
        gen_ms = wall_ms(lambda: engine.generate(
            prompts, max_new_tokens=SERVE_NEW, valid=valid), reps=2)
        _, cache, pos = prefill(model, cfg, prompts, max_len)
        tok = k_toks[:, 0].to(dev)
        lens = torch.full((batch,), pos + 1, dtype=torch.int32, device=dev)
        issue, step_ev = [], []
        for t in range(SERVE_NEW - 1):
            ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev0.record()
            logits, cache = decode_step(model, cfg, tok, cache, pos + t,
                                        cache_len=lens)
            tok = logits.argmax(-1).to(torch.int32)
            ev1.record()
            issue.append((time.perf_counter() - t0) * 1e3)
            ev1.synchronize()
            step_ev.append(ev0.elapsed_time(ev1))
            lens.add_(1)
        del cache, logits
        decode_ms = (gen_ms - prefill_ms) / (SERVE_NEW - 1)

        d, nh, nkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
        tokens = batch * s_p
        attn_w = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
        pairs = batch * visible_pairs(s_p, cfg.window)
        flops = flops_kept = 2 * batch * d * cfg.vocab_size   # last token
        for kind, count in cfg.segments:
            per = 2 * tokens * attn_w + 4 * hd * nh * pairs
            if kind == "attn_moe":
                per += 2 * tokens * d * mo.n_experts          # router
                if mo.n_shared_experts:
                    per += 3 * 2 * tokens * d * mo.d_shared
            else:
                per += 3 * 2 * tokens * d * cfg.d_ff
            flops += count * per
            flops_kept += count * per
        for cap, dropped, _ in drops[:n_moe]:
            flops += 3 * 2 * mo.n_experts * cap * d * mo.d_expert
            flops_kept += (3 * 2 * (tokens * mo.top_k - dropped) * d
                           * mo.d_expert)
        kv_read = sum(
            2 * 2 * batch * nkv * hd * min(s_p + t + 1, w_slots)
            for t in range(SERVE_NEW - 1)) / (SERVE_NEW - 1) * layers
        embed_bytes = model.embed.numel() * model.embed.element_size()
        step_bytes = n_bytes - embed_bytes + 2 * batch * d + kv_read
        routed_bytes = None
        if n_moe:        # only the experts some token of the step picked
            per_expert = 3 * d * mo.d_expert * 2
            picked = sum(int(experts.unique().numel())
                         for experts in store[n_moe:])
            routed_bytes = (step_bytes - n_moe * mo.n_experts * per_expert
                            + picked / (SERVE_NEW - 1) * per_expert)
        row = {"phase": "times", "program": f"serve {arch}",
               "nvidia_smi": smi, "batch": batch, "padded_len": s_p,
               "new_tokens": SERVE_NEW, "prefill_ms": prefill_ms,
               "prefill_bound_ms": flops / BF16_FLOPS_PER_S * 1e3,
               "prefill_bound_ms_kept_pairs":
                   flops_kept / BF16_FLOPS_PER_S * 1e3,
               "prefill_flops": flops, "generate_ms": gen_ms,
               "decode_ms_per_step": decode_ms,
               "decode_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
               "decode_bound_ms_picked_experts":
                   None if routed_bytes is None
                   else routed_bytes / HBM_BYTES_PER_S * 1e3,
               "decode_step_bytes": step_bytes,
               "decode_tokens_per_s": batch / decode_ms * 1e3,
               "step_event_ms_median": sorted(step_ev)[len(step_ev) // 2],
               "step_host_issue_ms_median": sorted(issue)[len(issue) // 2],
               "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9}
        if n_moe:
            row["prefill_capacity"] = drops[0][0]
            row["prefill_pairs_dropped_per_layer"] = [
                dropped for _, dropped, _ in drops[:n_moe]]
            row["prefill_tokens_dropped_per_layer"] = [
                dropped for _, _, dropped in drops[:n_moe]]
            row["prefill_pairs"] = tokens * mo.top_k
            row["decode_capacity"] = drops[n_moe][0]
            row["decode_pairs_dropped"] = sum(
                dropped for _, dropped, _ in drops[n_moe:])
        emit(row)
        del model, engine, store, flips, feed, toks, res
        torch.cuda.empty_cache()

    # ------------------------------------------------------------------
    # 2g. MLA and embedding-input serving at full width, bfloat16:
    # minicpm3-4b (all 62 layers) through ServeEngine; musicgen-medium
    # (all 48) and llava-next-34b (16 of its 60) through prefill and
    # decode_step on seeded embeddings
    # ------------------------------------------------------------------
    t_2g = time.perf_counter()

    def sdpa_backend(call):
        """The backend F.scaled_dot_product_attention takes for `call`:
        the first of its priority order whose own checks pass (each tried
        alone under sdpa_kernel), and every one that can run it."""
        from torch.nn.attention import SDPBackend, sdpa_kernel
        order = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                 SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH]
        try:
            order = [SDPBackend(i) for i in torch._C._get_sdp_priority_order()]
        except (AttributeError, TypeError, ValueError, RuntimeError):
            pass
        runs = []
        for backend in order:
            try:
                with sdpa_kernel(backend):
                    call()
                runs.append(backend.name)
            except RuntimeError:
                continue
        torch.cuda.synchronize()
        return runs[0] if runs else None, runs

    def embed_run(cfg, model, x, feeds, max_len):
        """prefill on x (B, S, d), then one decode_step on each of feeds
        (T, B, d) with the device lengths the engine keeps: the float32
        logits of every pass."""
        logits, cache, pos = prefill(model, cfg, x, max_len)
        out = [logits.float()]
        lens = torch.full((x.shape[0],), pos + 1, dtype=torch.int32,
                          device=dev)
        for t in range(feeds.shape[0]):
            logits, cache = decode_step(model, cfg, feeds[t], cache, pos + t,
                                        cache_len=lens)
            lens.add_(1)
            out.append(logits.float())
        del cache
        return out

    phase_2g_s = {}
    for i_cfg, (arch, depth, batch, (lo, hi)) in enumerate(MLA_EMBED_SERVE):
        t_cfg = time.perf_counter()
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth, segments=(
                (cfg.segments[0][0], depth),))
        mla = cfg.attn_kind == "mla"
        tokens_in = cfg.input_mode == "tokens"
        layers, nh, nkv, d = (cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
                              cfg.d_model)
        # q and k's head width, v's
        hd, hdv = ((cfg.mla.qk_head_dim, cfg.mla.v_head_dim) if mla
                   else (cfg.head_dim, cfg.head_dim))
        rng = np.random.default_rng(10 + i_cfg)
        plens = rng.integers(lo, hi + 1, batch)
        gen_e = torch.Generator(device=dev).manual_seed(20 + i_cfg)
        if tokens_in:
            reqs = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
                    for n in plens]
            ((prompts, valid),) = pad_and_batch(reqs, batch)
            prompts = prompts.to(dev)
            s_p = prompts.shape[1]
        else:
            # seeded frame or patch embeddings, each request left-padded
            # with zero vectors to the longest, as pad_and_batch pads ids;
            # one seeded (B, d) embedding per decode step
            s_p = int(plens.max())
            prompts = torch.zeros(batch, s_p, d, dtype=torch.bfloat16,
                                  device=dev)
            for r, n in enumerate(plens):
                prompts[r, s_p - int(n):] = torch.randn(
                    int(n), d, generator=gen_e, device=dev)
            feeds = torch.randn(SERVE_NEW - 1, batch, d, generator=gen_e,
                                device=dev).to(torch.bfloat16)
        max_len = s_p + SERVE_NEW
        want = {"mha": layers}
        want_routes = {"mha": {"wgmma": layers}}
        if not mla:      # MLA decodes in the latent space, in torch ops
            want["decode_attention"] = layers * (SERVE_NEW - 1)
            want_routes["decode_attention"] = {"mma": want[
                "decode_attention"]}

        # the kernels at this config's serve shapes, before its weights
        # take the card: a prefill layer (q and k of hd columns, v of hdv
        # as the model passes them), and a decode step over the cache's
        # view, filled and not
        if mla:          # q, k concatenated; v the up-projection's columns
            kq, kk = (randn_s(batch, nh, s_p, hd) for _ in range(2))
            kv = randn_s(batch, s_p, nh, cfg.mla.qk_nope_dim + hdv).transpose(
                1, 2)[..., cfg.mla.qk_nope_dim:]
        else:
            kq = randn_s(batch, s_p, nh, hd).transpose(1, 2)
            kk, kv = (randn_s(batch, s_p, nkv, hd).transpose(1, 2)
                      for _ in range(2))
        check(k_attn.mha_route(kq, kk, kv) == "wgmma",
              f"{arch}: mha route {k_attn.mha_route(kq, kk, kv)}")
        sdpa = {"library_ms": lambda: F.scaled_dot_product_attention(
            kq, kk, kv, is_causal=True, enable_gqa=nh != nkv)}
        backend, runnable = sdpa_backend(sdpa["library_ms"])
        case = (f"{arch} prefill layer B {batch} S {s_p} d {hd} dv {hdv} "
                f"{nh}:{nkv} bf16 route wgmma")
        pairs = batch * nh * visible_pairs(s_p, None)
        row = kernel_case_timed(
            "mha", case, lambda: ops.mha(kq, kk, kv),
            lambda: mha_plain_rows(kq, kk, kv), sdpa, kq, kk, kv,
            2 * (hd + hdv) * pairs,
            2 * batch * s_p * (nh * hd + nkv * hd + nkv * hdv + nh * hdv))
        row.update(library_backend=backend, library_backends_that_run=runnable,
                   visible_pairs=pairs)
        kern_rows = [row]
        del kq, kk, kv
        if not mla:
            rq = randn_s(batch, nh, hd)
            rk, rv = (randn_s(batch, max_len, nkv, hd).permute(0, 2, 1, 3)
                      for _ in range(2))
            check(k_dec.decode_route(rq, rk, rv) == "mma",
                  f"{arch}: decode route {k_dec.decode_route(rq, rk, rv)}")
            for fill, lens in (
                    ("full", torch.full((batch,), max_len, dtype=torch.int32,
                                        device=dev)),
                    ("mid", torch.full((batch,), s_p + SERVE_NEW // 2,
                                       dtype=torch.int32, device=dev))):
                n_keys = int(lens.sum())
                key_mask = (None if fill == "full" else
                            (torch.arange(max_len, device=dev)[None]
                             < lens[:, None])[:, None, None])
                kern_rows.append(kernel_case_timed(
                    "decode_attention",
                    f"{arch} decode step over the cache B {batch} slots "
                    f"{max_len} lens {fill} D {hd} {nh}:{nkv} bf16 route mma",
                    lambda: ops.decode_attention(rq, rk, rv, lens),
                    lambda: k_dec.decode_attention_plain(rq, rk, rv, lens),
                    {"library_ms": lambda: F.scaled_dot_product_attention(
                        rq[:, :, None], rk, rv, attn_mask=key_mask,
                        enable_gqa=nh != nkv)},
                    rq, rk, rv, 4 * nh * n_keys * hd,
                    2 * 2 * n_keys * nkv * hd + 2 * 2 * batch * nh * hd))
            del rq, rk, rv
        emit({"phase": "kernel_times", "arch": arch, "rows": kern_rows,
              "nvidia_smi": smi})

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = init_params(cfg, 0, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
        if tokens_in:
            engine = ServeEngine(cfg, model, max_len=max_len,
                                 batch_size=batch)
            res, counts = counted_run(lambda: engine.generate(
                prompts, max_new_tokens=SERVE_NEW, valid=valid))
            toks = torch.tensor(res.tokens, device=dev)
            out_ok = (res.steps == SERVE_NEW
                      and tuple(toks.shape) == (batch, SERVE_NEW)
                      and bool(((toks >= 0)
                                & (toks < cfg.vocab_size)).all()))
        else:
            kern, counts = counted_run(lambda: embed_run(
                cfg, model, prompts, feeds, max_len))
            out_ok = (len(kern) == SERVE_NEW and all(
                tuple(a.shape) == (batch, cfg.vocab_size)
                and bool(torch.isfinite(a).all()) for a in kern))
        nonzero = {k: c for k, c in counts.items() if c}
        routes_taken = {k: dict(v) for k, v in last_routes.items()}
        ok = nonzero == want and routes_taken == want_routes and out_ok
        emit({"phase": "main_path", "program": "ServeEngine.generate"
              if tokens_in else "prefill + decode_step on embeddings",
              "arch": arch, "layers": layers, "of_layers":
              get_config(arch).n_layers, "d_model": d, "heads": [nh, nkv],
              "qk_head_dim": hd, "v_head_dim": hdv, "attn_kind":
              cfg.attn_kind, "input_mode": cfg.input_mode, "dtype":
              cfg.dtype, "params": sum(p.numel() for p in
                                       model.parameters()),
              "weight_gb": n_bytes / 1e9, "init_s": init_s,
              "prompt_lens": plens.tolist(), "padded_len": s_p,
              "max_len": max_len, "new_tokens": SERVE_NEW,
              "launches": nonzero, "want": want, "routes": routes_taken,
              "want_routes": want_routes,
              "tokens_row0": res.tokens[0] if tokens_in else None,
              "ok": ok})
        check(ok, f"serve {arch}: launches {nonzero} (want {want}), routes "
                  f"{routes_taken} (want {want_routes}), outputs {out_ok}")

        # against plain attention: the prefill and SERVE_FORCED steps fed
        # the kernel run's tokens (or every step, fed the same
        # embeddings), then the greedy tokens
        if tokens_in:
            k_toks, kern, _ = decode_run(cfg, model, prompts, max_len,
                                         SERVE_NEW)
            same = bool(torch.equal(k_toks, torch.tensor(res.tokens)))
            with plain_rows_attention():
                _, plain, _ = decode_run(cfg, model, prompts, max_len,
                                         SERVE_FORCED + 1, k_toks.to(dev))
        else:
            same = True
            with plain_rows_attention():
                plain = embed_run(cfg, model, prompts, feeds, max_len)
        logit_err, rel = 0.0, []
        for a, b_ in zip(kern, plain):
            logit_err = max(logit_err, float((a - b_).abs().max()))
            rel.append(float((a - b_).norm() / b_.norm()))
        ok = (max(rel) <= SERVE_REL_RMS and same
              and all(bool(torch.isfinite(a).all()) for a in kern))
        emit({"phase": "main_path_check", "program": "serve logits vs plain "
              "attention", "arch": arch, "steps": ["prefill"] + [
                  f"decode {t}" for t in range(len(rel) - 1)],
              "rel_rms": rel, "bound": SERVE_REL_RMS,
              "max_abs_logit_err": logit_err,
              "logit_scale": float(plain[0].abs().max()),
              "kernel_run_reproduces_engine_tokens":
                  same if tokens_in else None, "ok": ok})
        check(ok, f"serve {arch} logits: relative RMS {rel} (bound "
                  f"{SERVE_REL_RMS}), engine tokens reproduced: {same}")
        if tokens_in:
            with plain_rows_attention():
                p_toks, _, margins = decode_run(cfg, model, prompts,
                                                max_len, SERVE_NEW)
            a_toks = torch.tensor(res.tokens)
        else:           # the argmax of each pass, all fed the same inputs
            a_toks = torch.stack([a.argmax(-1) for a in kern], 1).cpu()
            p_toks = torch.stack([a.argmax(-1) for a in plain], 1).cpu()
            margins = torch.stack([(lambda v: v[:, 0] - v[:, 1])(
                a.topk(2, dim=-1).values) for a in plain], 1).cpu()
        del kern, plain
        emit({"phase": "main_path_check", "program": "serve greedy tokens "
              "vs plain attention" if tokens_in else "argmax of each pass "
              "vs plain attention", "arch": arch,
              **margin_agreement(arch, a_toks, p_toks, margins, logit_err),
              "ok": True})

        # times beside their bounds: prefill by its operations (the
        # projections, the attention over the causal pairs, the FFN, the
        # last token's unembedding), a decode step by its bytes (every
        # weight once, the tied table read whole by the unembedding, the
        # cache rows in reach)
        prefill_ms = wall_ms(lambda: prefill(model, cfg, prompts, max_len))
        if tokens_in:
            run_ms = wall_ms(lambda: engine.generate(
                prompts, max_new_tokens=SERVE_NEW, valid=valid), reps=2)
            feed_step = k_toks.to(dev).T
        else:
            run_ms = wall_ms(lambda: embed_run(cfg, model, prompts, feeds,
                                               max_len), reps=2)
            feed_step = feeds
        _, cache, pos = prefill(model, cfg, prompts, max_len)
        lens = torch.full((batch,), pos + 1, dtype=torch.int32, device=dev)
        issue, step_ev = [], []
        for t in range(SERVE_NEW - 1):
            ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev0.record()
            logits, cache = decode_step(model, cfg, feed_step[t], cache,
                                        pos + t, cache_len=lens)
            ev1.record()
            issue.append((time.perf_counter() - t0) * 1e3)
            ev1.synchronize()
            step_ev.append(ev0.elapsed_time(ev1))
            lens.add_(1)
        del cache, logits
        decode_ms = (run_ms - prefill_ms) / (SERVE_NEW - 1)
        tokens = batch * s_p
        if mla:
            m = cfg.mla
            proj = (d * m.q_lora_rank + m.q_lora_rank * nh * hd
                    + d * (m.kv_lora_rank + m.qk_rope_dim)
                    + m.kv_lora_rank * nh * (m.qk_nope_dim + hdv)
                    + nh * hdv * d)
            per_pos = m.kv_lora_rank + m.qk_rope_dim     # latent cache row
        else:
            proj = d * nh * hd + 2 * d * nkv * hd + nh * hd * d
            per_pos = 2 * nkv * hd                      # K and V rows
        flops = (layers * (2 * tokens * proj + 2 * (hd + hdv) * pairs
                           + 3 * 2 * tokens * d * cfg.d_ff)
                 + 2 * batch * d * cfg.vocab_size)
        cache_read = sum(2 * batch * per_pos * (s_p + t + 1)
                         for t in range(SERVE_NEW - 1)) / (SERVE_NEW - 1)
        step_bytes = n_bytes + layers * cache_read + 2 * batch * d
        emit({"phase": "times", "program": f"serve {arch}",
              "nvidia_smi": smi, "batch": batch, "padded_len": s_p,
              "new_tokens": SERVE_NEW, "prefill_ms": prefill_ms,
              "prefill_bound_ms": flops / BF16_FLOPS_PER_S * 1e3,
              "prefill_flops": flops,
              "generate_ms" if tokens_in else "prefill_and_steps_ms": run_ms,
              "decode_ms_per_step": decode_ms,
              "decode_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
              "decode_step_bytes": step_bytes,
              "decode_tokens_per_s": batch / decode_ms * 1e3,
              "step_event_ms_median": sorted(step_ev)[len(step_ev) // 2],
              "step_host_issue_ms_median": sorted(issue)[len(issue) // 2],
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
        del model, prompts
        if tokens_in:
            del engine, res, toks
        else:
            del feeds
        torch.cuda.empty_cache()
        phase_2g_s[arch] = time.perf_counter() - t_cfg
    emit({"phase": "times", "program": "phase 2g", "seconds":
          time.perf_counter() - t_2g, "seconds_by_config": phase_2g_s,
          "nvidia_smi": smi})

    # ------------------------------------------------------------------
    # 2h. SSM, xLSTM and hybrid serving at full width and depth,
    # bfloat16: hymba-1.5b (its attention on the windowed mha and the
    # ring decode at 25 heads on 5, D 64, W 1024) and xlstm-125m (no
    # attention), both through ServeEngine
    # ------------------------------------------------------------------
    t_2h = time.perf_counter()
    from repro_torch.models import forward_logits, ssm as m_ssm

    check(not torch.backends.cuda.matmul.allow_tf32,
          "TF32 was turned on before phase 2h: the scans' float32 "
          "products must stay true float32")

    def cache_bytes(cache, names):
        return sum(t.numel() * t.element_size() for seg in cache
                   for name, t in seg.items() if name in names)

    # the scans on the card in float32, chunked against sequential, at
    # hymba's SSD heads and xlstm's mLSTM heads
    gen_h = torch.Generator(device=dev).manual_seed(40)

    def randn_f(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen_h, device=dev) * scale

    sb, ss = SCAN_BS
    h_, p_, n_ = SCAN_SSD
    ssd_in = (randn_f(sb, ss, h_, p_), randn_f(sb, ss, h_),
              randn_f(h_, scale=0.5), randn_f(sb, ss, n_),
              randn_f(sb, ss, n_), randn_f(h_) + 1.0)
    h_m, d_m = SCAN_MLSTM
    mlstm_in = (randn_f(sb, ss, h_m, d_m), randn_f(sb, ss, h_m, d_m),
                randn_f(sb, ss, h_m, d_m), randn_f(sb, ss, h_m),
                randn_f(sb, ss, h_m) + 3.0)
    for name, chunked, sequential, args in (
            ("ssd", m_ssm.ssd_chunked, m_ssm.ssd_sequential, ssd_in),
            ("mlstm", m_ssm.mlstm_chunked, m_ssm.mlstm_sequential,
             mlstm_in)):
        got, _ = chunked(*args)
        want = sequential(*args)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        ok = (got.dtype == torch.float32 and bool(torch.isfinite(got).all())
              and err <= SCAN_REL * scale)
        emit({"phase": "main_path_check", "program": f"{name}_chunked vs "
              f"{name}_sequential, float32 on the card",
              "shape": [list(a.shape) for a in args[:2]],
              "chunked_ms": event_ms(lambda: chunked(*args), reps=3),
              "sequential_ms": event_ms(lambda: sequential(*args), reps=1,
                                        warm=0),
              "max_abs_err": err, "bound": SCAN_REL * scale, "ok": ok})
        check(ok, f"{name}_chunked against {name}_sequential on the card: "
                  f"{err} (bound {SCAN_REL * scale})")
    del ssd_in, mlstm_in, got, want

    phase_2h_s = {}
    for i_cfg, (arch, depth, batch, (lo, hi)) in enumerate(SSM_SERVE):
        t_cfg = time.perf_counter()
        cfg = get_config(arch)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth, segments=(
                (cfg.segments[0][0], depth),))
        layers, nh, nkv, d = (cfg.n_layers, cfg.n_heads, cfg.n_kv_heads,
                              cfg.d_model)
        attends = any(kind == "hybrid" for kind, _ in cfg.segments)
        hd = cfg.head_dim
        rng = np.random.default_rng(30 + i_cfg)
        plens = rng.integers(lo, hi + 1, batch)
        reqs = [rng.integers(1, cfg.vocab_size, int(n)).tolist()
                for n in plens]
        ((prompts, valid),) = pad_and_batch(reqs, batch)
        s_p = prompts.shape[1]
        max_len = s_p + SERVE_NEW
        w_slots = m_model._swa_cache_len(cfg, max_len)
        prompts = prompts.to(dev)
        want, want_routes = {}, {}
        if attends:
            # hymba's attention: the windowed mha on its prefill layer
            # and the decode kernel over its ring's view, at 25 heads on
            # 5 (a group of 5, split 4 + 1 in decode), D 64, W 1024
            want = {"mha": layers, "decode_attention": layers
                    * (SERVE_NEW - 1)}
            want_routes = {"mha": {"wgmma": want["mha"]},
                           "decode_attention": {"mma": want[
                               "decode_attention"]}}
            kq = randn_s(batch, s_p, nh, hd).transpose(1, 2)
            kk, kv = (randn_s(batch, s_p, nkv, hd).transpose(1, 2)
                      for _ in range(2))
            check(k_attn.mha_route(kq, kk, kv) == "wgmma",
                  f"{arch}: mha route {k_attn.mha_route(kq, kk, kv)}")
            pairs = batch * visible_pairs(s_p, cfg.window)
            kern_rows = [kernel_case_timed(
                "mha", f"{arch} prefill layer B {batch} S {s_p} D {hd} "
                f"{nh}:{nkv} window {cfg.window} bf16 route wgmma",
                lambda: ops.mha(kq, kk, kv, window=cfg.window),
                lambda: mha_plain_rows(kq, kk, kv, window=cfg.window),
                sdpa_calls(kq, kk, kv, cfg.window), kq, kk, kv,
                4 * hd * nh * pairs,
                2 * 2 * batch * s_p * hd * (nh + nkv))]
            kern_rows[0]["visible_pairs"] = pairs
            del kq, kk, kv
            rq = randn_s(batch, nh, hd)
            rk, rv = (randn_s(batch, w_slots, nkv, hd).permute(0, 2, 1, 3)
                      for _ in range(2))
            check(k_dec.decode_route(rq, rk, rv) == "mma",
                  f"{arch}: decode route {k_dec.decode_route(rq, rk, rv)}")
            for fill, lens in (
                    ("full", torch.full((batch,), w_slots,
                                        dtype=torch.int32, device=dev)),
                    ("short", torch.tensor(
                        [(i * 997) % w_slots + 1 for i in range(batch)],
                        dtype=torch.int32, device=dev))):
                n_keys = int(lens.sum())
                key_mask = (None if fill == "full" else
                            (torch.arange(w_slots, device=dev)[None]
                             < lens[:, None])[:, None, None])
                kern_rows.append(kernel_case_timed(
                    "decode_attention", f"{arch} decode step over the ring "
                    f"B {batch} slots {w_slots} lens {fill} D {hd} "
                    f"{nh}:{nkv} bf16 route mma",
                    lambda: ops.decode_attention(rq, rk, rv, lens),
                    lambda: k_dec.decode_attention_plain(rq, rk, rv, lens),
                    {"library_ms": lambda: F.scaled_dot_product_attention(
                        rq[:, :, None], rk, rv, attn_mask=key_mask,
                        enable_gqa=True)},
                    rq, rk, rv, 4 * nh * n_keys * hd,
                    2 * 2 * n_keys * nkv * hd + 2 * 2 * batch * nh * hd))
            del rq, rk, rv
            emit({"phase": "kernel_times", "arch": arch, "rows": kern_rows,
                  "nvidia_smi": smi})

        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model = init_params(cfg, 0, device=dev)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        n_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
        engine = ServeEngine(cfg, model, max_len=max_len, batch_size=batch)
        res, counts = counted_run(lambda: engine.generate(
            prompts, max_new_tokens=SERVE_NEW, valid=valid))
        nonzero = {k: c for k, c in counts.items() if c}
        routes_taken = {k: dict(v) for k, v in last_routes.items()}
        toks = torch.tensor(res.tokens, device=dev)
        ok = (nonzero == want and routes_taken == want_routes
              and res.steps == SERVE_NEW
              and tuple(toks.shape) == (batch, SERVE_NEW)
              and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()))
        emit({"phase": "main_path", "program": "ServeEngine.generate",
              "arch": arch, "layers": layers, "segments": cfg.segments,
              "d_model": d, "heads": [nh, nkv] if attends else None,
              "head_dim": hd if attends else None, "window": cfg.window,
              "ring_slots": w_slots if attends else None,
              "ssm": dataclasses.asdict(cfg.ssm), "dtype": cfg.dtype,
              "params": sum(p.numel() for p in model.parameters()),
              "weight_gb": n_bytes / 1e9, "init_s": init_s,
              "prompt_lens": plens.tolist(), "padded_len": s_p,
              "max_len": max_len, "new_tokens": SERVE_NEW,
              "launches": nonzero, "want": want, "routes": routes_taken,
              "want_routes": want_routes, "tokens_row0": res.tokens[0],
              "ok": ok})
        check(ok, f"serve {arch}: launches {nonzero} (want {want}), routes "
                  f"{routes_taken} (want {want_routes}), steps "
                  f"{res.steps}, tokens {tuple(toks.shape)}")

        k_toks, kern, _ = decode_run(cfg, model, prompts, max_len,
                                     SERVE_NEW)
        same = bool(torch.equal(k_toks, torch.tensor(res.tokens)))
        if attends:
            # against plain attention: the prefill and SERVE_FORCED steps
            # fed the kernel run's tokens, then greedy on its own
            with plain_rows_attention():
                _, plain, _ = decode_run(cfg, model, prompts, max_len,
                                         SERVE_FORCED + 1, k_toks.to(dev))
            program = "serve logits vs plain attention"
        else:
            # no attention to swap: the chunked scans against the
            # recurrent steps instead, as the reference's own test does
            # (prefill on S - 1 tokens and one decode_step against
            # forward_logits at S - 1, then SERVE_FORCED steps fed the
            # engine's tokens against forward_logits of the longer
            # sequence)
            seq = torch.cat([prompts, k_toks[:, :SERVE_FORCED].to(
                dev, prompts.dtype)], dim=1)
            full = forward_logits(model, cfg, seq).float()
            logits, cache, pos = prefill(model, cfg, seq[:, :s_p - 1],
                                         max_len)
            kern = [logits.float()]
            plain = [full[:, s_p - 2]]
            for t in range(SERVE_FORCED + 1):
                logits, cache = decode_step(model, cfg, seq[:, pos + t],
                                            cache, pos + t)
                kern.append(logits.float())
                plain.append(full[:, pos + t])
            del full, cache, logits
            program = ("prefill(S - 1) and decode_step vs forward_logits "
                       "(chunked against recurrent)")
        logit_err = max(float((a - b_).abs().max())
                        for a, b_ in zip(kern, plain))
        rel = [float((a - b_).norm() / b_.norm())
               for a, b_ in zip(kern, plain)]
        ok = (max(rel) <= SERVE_REL_RMS and same
              and all(bool(torch.isfinite(a).all()) for a in kern))
        emit({"phase": "main_path_check", "program": program, "arch": arch,
              "steps": ["prefill"] + [f"decode {t}" for t in
                                      range(len(rel) - 1)],
              "rel_rms": rel, "bound": SERVE_REL_RMS,
              "max_abs_logit_err": logit_err,
              "logit_scale": float(plain[0].abs().max()),
              "kernel_run_reproduces_engine_tokens": same, "ok": ok})
        check(ok, f"serve {arch} logits: relative RMS {rel} (bound "
                  f"{SERVE_REL_RMS}), engine tokens reproduced: {same}")
        del kern, plain
        if attends:
            with plain_rows_attention():
                p_toks, _, margins = decode_run(cfg, model, prompts,
                                                max_len, SERVE_NEW)
            emit({"phase": "main_path_check", "program": "serve greedy "
                  "tokens vs plain attention", "arch": arch,
                  **margin_agreement(arch, torch.tensor(res.tokens), p_toks,
                                     margins, logit_err), "ok": True})

        # times beside their bounds: prefill by its operations (the dense
        # products, the attention over the visible band, the scans'
        # products, the last token's unembedding), a decode step by its
        # bytes (every weight once, the states and conv windows read and
        # written, the ring rows in reach), counted from the model's own
        # parameters and cache tensors
        prefill_ms = wall_ms(lambda: prefill(model, cfg, prompts, max_len),
                             reps=2)
        gen_ms = wall_ms(lambda: engine.generate(
            prompts, max_new_tokens=SERVE_NEW, valid=valid), reps=1)
        _, cache, pos = prefill(model, cfg, prompts, max_len)
        tok = k_toks[:, 0].to(dev)
        lens = torch.full((batch,), pos + 1, dtype=torch.int32, device=dev)
        issue, step_ev = [], []
        for t in range(SERVE_NEW - 1):
            ev0, ev1 = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ev0.record()
            logits, cache = decode_step(model, cfg, tok, cache, pos + t,
                                        cache_len=lens)
            tok = logits.argmax(-1).to(torch.int32)
            ev1.record()
            issue.append((time.perf_counter() - t0) * 1e3)
            ev1.synchronize()
            step_ev.append(ev0.elapsed_time(ev1))
            lens.add_(1)
        decode_ms = (gen_ms - prefill_ms) / (SERVE_NEW - 1)
        tokens = batch * s_p
        dense_w = sum(t.numel() for blk in model.blocks
                      for name, t in blk.p.items()
                      if t.dim() == 2 and name != "conv_w")
        flops_dense = 2 * tokens * dense_w + 2 * batch * d * cfg.vocab_size
        flops_scan = 0
        lc = min(m_ssm.CHUNK, s_p)
        for kind, count in cfg.segments:
            if kind == "hybrid":
                flops_dense += count * 4 * hd * nh * batch * visible_pairs(
                    s_p, cfg.window)
                sc = cfg.ssm
                hp = sc.expand * d                  # heads x P
                flops_scan += count * tokens * (
                    2 * lc * sc.d_state + 2 * lc * hp + 4 * sc.d_state * hp)
            elif kind == "mlstm":
                hdm = 2 * d                         # heads x D
                dh = hdm // m_model._ssm_heads(cfg, kind)
                flops_scan += count * tokens * (3 * 2 * lc * hdm
                                                + 2 * 2 * dh * hdm)
            elif kind == "slstm":
                dh = d // m_model._ssm_heads(cfg, kind)
                flops_scan += count * tokens * 2 * 4 * d * dh
        state_rw = 2 * cache_bytes(cache, ("C", "n", "m", "h", "c",
                                           "ssm_state", "conv"))
        ring_read = (sum(2 * 2 * batch * nkv * hd * min(s_p + t + 1, w_slots)
                         for t in range(SERVE_NEW - 1))
                     / (SERVE_NEW - 1) * layers if attends else 0)
        table_bytes = (0 if model.lm_head is None else
                       model.embed.numel() * model.embed.element_size())
        step_bytes = (n_bytes - table_bytes + 2 * batch * d + state_rw
                      + ring_read)
        del cache, logits
        emit({"phase": "times", "program": f"serve {arch}",
              "nvidia_smi": smi, "batch": batch, "padded_len": s_p,
              "new_tokens": SERVE_NEW, "prefill_ms": prefill_ms,
              "prefill_bound_ms":
                  (flops_dense + flops_scan) / BF16_FLOPS_PER_S * 1e3,
              "prefill_bound_ms_scans_at_f32_peak":
                  (flops_dense / BF16_FLOPS_PER_S
                   + flops_scan / F32_FLOPS_PER_S) * 1e3,
              "prefill_flops": flops_dense + flops_scan,
              "prefill_scan_flops": flops_scan, "generate_ms": gen_ms,
              "decode_ms_per_step": decode_ms,
              "decode_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3,
              "decode_step_bytes": step_bytes,
              "decode_state_bytes_read_and_written": state_rw,
              "decode_ring_bytes_read": ring_read,
              "decode_tokens_per_s": batch / decode_ms * 1e3,
              "step_event_ms_median": sorted(step_ev)[len(step_ev) // 2],
              "step_host_issue_ms_median": sorted(issue)[len(issue) // 2],
              "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9})
        del model, engine, res, toks, prompts, k_toks
        torch.cuda.empty_cache()

        # each scan of a prefill layer alone, at this config's serve
        # shape on seeded bfloat16 inputs (the float32 weights float32):
        # device time with the host's issue inside it, times the layers
        # that run it, beside the prefill above
        scans = {}
        bs_ = (batch, s_p)
        for kind, count in cfg.segments:
            if kind in scans:
                scans[kind]["layers"] += count
                continue
            nh_s = m_model._ssm_heads(cfg, kind)
            if kind == "hybrid":
                dss = cfg.ssm.expand * d
                args = (randn_s(*bs_, nh_s, dss // nh_s), randn_s(*bs_, nh_s),
                        torch.zeros(nh_s, device=dev), randn_s(
                            *bs_, cfg.ssm.d_state), randn_s(
                            *bs_, cfg.ssm.d_state),
                        torch.ones(nh_s, device=dev))
                fn, name = m_ssm.ssd_chunked, "ssd_chunked"
            elif kind == "mlstm":
                dh = 2 * d // nh_s
                args = (*(randn_s(*bs_, nh_s, dh) for _ in range(3)),
                        randn_s(*bs_, nh_s), randn_s(*bs_, nh_s).float() + 3)
                fn, name = m_ssm.mlstm_chunked, "mlstm_chunked"
            else:
                dh = d // nh_s
                args = (randn_s(*bs_, 4, d),
                        randn_f(4, nh_s, dh, dh, scale=dh ** -0.5))
                fn, name = m_ssm.slstm_scan, "slstm_scan"
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
            ms = event_ms(lambda: fn(*args), reps=2, warm=0)
            scans[kind] = {"scan": name, "layers": count, "ms": ms,
                           "first_call_s": first_s}
            del args
        for row in scans.values():
            row["ms_times_layers"] = row["ms"] * row["layers"]
            row["share_of_prefill"] = row["ms_times_layers"] / prefill_ms
        emit({"phase": "times", "program": f"{arch} scans at the serve "
              f"shape", "nvidia_smi": smi, "batch": batch,
              "padded_len": s_p, "prefill_ms": prefill_ms,
              "scans": list(scans.values())})
        phase_2h_s[arch] = time.perf_counter() - t_cfg
    emit({"phase": "times", "program": "phase 2h", "seconds":
          time.perf_counter() - t_2h, "seconds_by_config": phase_2h_s,
          "nvidia_smi": smi})

    missing = [k for k, c in launches.items() if c == 0]
    check(not missing, f"kernels never launched on the main path: "
                       f"{missing}")

    # ------------------------------------------------------------------
    # 3. repeatability
    # ------------------------------------------------------------------
    b1 = prog(**axpydot_inputs)["beta"].clone()
    b2 = prog(**axpydot_inputs)["beta"].clone()
    n1 = programs["nodataflow"](**axpydot_inputs)["beta"].clone()
    n2 = programs["nodataflow"](**axpydot_inputs)["beta"].clone()
    ok = bool(torch.equal(b1, b2)) and bool(torch.equal(n1, n2))
    emit({"phase": "repeatability", "dataflow": [float(b1), float(b2)],
          "nodataflow": [float(n1), float(n2)], "bitwise_equal": ok})
    check(ok, "dataflow axpydot is not bitwise repeatable")

    # the window walk's reductions, three calls each
    for name, vecs in (("dot", (x, y)), ("nrm2", (x,)), ("asum", (x,)),
                       ("dot", (x[:RAGGED], y[:RAGGED])),
                       ("nrm2", (x[:RAGGED],)), ("asum", (x[:RAGGED],))):
        runs = [getattr(ops, name)(*vecs) for _ in range(3)]
        ok = all(torch.equal(runs[0], r) for r in runs[1:])
        emit({"phase": "repeatability", "kernel": name,
              "n": vecs[0].shape[0], "values": [float(r) for r in runs],
              "bitwise_equal": ok})
        check(ok, f"{name} at n = {vecs[0].shape[0]} is not bitwise "
                  f"repeatable")

    cg = l2_programs["CG_MATVEC"]
    cg_in = l2_inputs["CG_MATVEC"]
    reps = {m: [cg[m](**cg_in) for _ in range(2)]
            for m in ("dataflow", "nodataflow")}
    ok = all(torch.equal(r[0][k], r[1][k]) for r in reps.values()
             for k in ("q", "pq"))
    emit({"phase": "repeatability", "program": "CG_MATVEC",
          "dataflow_pq": [float(r["pq"]) for r in reps["dataflow"]],
          "nodataflow_pq": [float(r["pq"]) for r in reps["nodataflow"]],
          "bitwise_equal": ok})
    check(ok, "CG_MATVEC is not bitwise repeatable")
    del reps

    again = blk_progs["dataflow"].solve(A=A_spd, B=B_blk, x0=X0)
    ok = (bool(torch.equal(again.x, res_blk.x))
          and int(again.iterations) == its_blk["dataflow"])
    emit({"phase": "repeatability", "program": "BLOCK_CG_LOOP",
          "mode": "dataflow", "iterations": [its_blk["dataflow"],
                                             int(again.iterations)],
          "bitwise_equal": ok})
    check(ok, "the dataflow block-CG solve is not bitwise repeatable")

    again = gm_progs["dataflow"].solve(**gm_ops)
    ok = (bool(torch.equal(again.x, gm["dataflow"].x))
          and int(again.iterations) == restarts_g["dataflow"])
    emit({"phase": "repeatability", "program": "GMRES_LOOP",
          "mode": "dataflow", "restarts": [restarts_g["dataflow"],
                                           int(again.iterations)],
          "bitwise_equal": ok})
    check(ok, "the dataflow GMRES solve is not bitwise repeatable")

    # ------------------------------------------------------------------
    # 4. times, with the SM clock and power sampled every 200 ms
    # ------------------------------------------------------------------
    sampler = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "200"],
        stdout=subprocess.PIPE, text=True)
    atexit.register(sampler.kill)
    def cuda_ms(fn, reps=20, warm=3):
        for _ in range(warm):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def bound(nbytes, flops, flops_per_s=F32_FLOPS_PER_S):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / flops_per_s * 1e3
        return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                             "operations")

    n4 = 4 * N
    gvecs = group_vecs(x, y, z)
    lib = torch
    mv_bytes, mv_flops = 4 * (N2 * N2 + 3 * N2), 2 * N2 * N2
    tri_bytes = 4 * (N2 * (N2 + 1) // 2)       # symv's lower triangle
    m_b, n_b = BASIS
    m_g21 = GMRES_BASIS[0]
    basis_bytes, basis_flops = 4 * (m_b * n_b + 2 * n_b + m_b), \
        2 * m_b * n_b
    cg_run, cg_scal, cg_vecs = anchored_runs["CG_MATVEC"]
    t_run, t_scal, t_vecs = tiled_runs["BLOCK_CG_MATVEC"]
    mm_bytes = 4 * (N2 * N2 + 3 * N2 * S_BLOCK)
    mm_flops = 2 * N2 * N2 * S_BLOCK
    table = {
        # name: (kernel fn, plain fn, library fn or None, bytes, flops,
        #        source under src/repro_torch/ (None: core/codegen.py),
        #        replaces)
        "axpy": (lambda: ops.axpy(1.7, x, y),
                 lambda: k_axpy.axpy_plain(1.7, x, y),
                 lambda: lib.add(y, x, alpha=1.7), 3 * n4, 2 * N,
                 "axpy.py", "kernels/axpy.py:58"),
        "scal": (lambda: ops.scal(-0.3, x),
                 lambda: k_axpy.scal_plain(-0.3, x),
                 lambda: lib.mul(x, -0.3), 2 * n4, N,
                 "axpy.py", "kernels/axpy.py:58"),
        "waxpby": (lambda: ops.waxpby(0.5, x, -1.25, y),
                   lambda: k_axpy.waxpby_plain(0.5, x, -1.25, y),
                   None, 3 * n4, 3 * N, "axpy.py", "kernels/axpy.py:58"),
        "copy": (lambda: ops.copy(x), lambda: k_axpy.copy_plain(x),
                 lambda: x.clone(), 2 * n4, 0,
                 "axpy.py", "kernels/axpy.py:58"),
        "vmul": (lambda: ops.vmul(x, y), lambda: k_axpy.vmul_plain(x, y),
                 lambda: lib.mul(x, y), 3 * n4, N,
                 "axpy.py", "kernels/axpy.py:58"),
        "rot": (lambda: ops.rot(0.6, 0.8, x, y),
                lambda: k_axpy.rot_plain(0.6, 0.8, x, y), None,
                4 * n4, 6 * N, "axpy.py", "kernels/axpy.py:58"),
        "dot": (lambda: ops.dot(x, y), lambda: k_dot.dot_plain(x, y),
                lambda: lib.dot(x, y), 2 * n4, 2 * N,
                "dot.py", "kernels/dot.py:108"),
        "asum": (lambda: ops.asum(x), lambda: k_dot.asum_plain(x),
                 lambda: lib.linalg.vector_norm(x, 1), n4, 2 * N,
                 "dot.py", "kernels/dot.py:108"),
        "nrm2": (lambda: ops.nrm2(x), lambda: k_dot.nrm2_plain(x),
                 lambda: lib.linalg.vector_norm(x), n4, 2 * N,
                 "dot.py", "kernels/dot.py:108"),
        "iamax": (lambda: ops.iamax(x), lambda: k_dot.iamax_plain(x),
                  lambda: lib.argmax(x.abs()), n4, 2 * N,
                  "dot.py", "kernels/dot.py:144"),
        "axpydot": (lambda: ops.axpydot(0.9, x, y, z),
                    lambda: k_axpydot.axpydot_plain(0.9, x, y, z), None,
                    3 * n4, 4 * N, "axpydot.py", "kernels/axpydot.py:54"),
        "group_kernel": (lambda: group_run(group_scalars, gvecs),
                         lambda: group_run.plain(group_scalars, gvecs),
                         None,
                         3 * n4, 4 * N, None, "core/codegen.py:363"),
        "gemv": (lambda: ops.gemv(alpha2, A, xa, beta2, ya),
                 lambda: k_gemv.gemv_plain(alpha2, A, xa, beta2, ya),
                 lambda: lib.addmv(ya, A, xa, beta=beta2, alpha=alpha2),
                 mv_bytes, mv_flops, "csrc/gemv.cu", "kernels/gemv.py:60"),
        "gemvt": (lambda: ops.gemvt(alpha2, A, xa, beta2, ya),
                  lambda: k_gemv.gemvt_plain(alpha2, A, xa, beta2, ya),
                  lambda: lib.addmv(ya, A.t(), xa, beta=beta2,
                                    alpha=alpha2),
                  mv_bytes, mv_flops, "csrc/gemv.cu",
                  "kernels/gemv.py:112"),
        "symv": (lambda: ops.symv(alpha2, A, xa, beta2, ya),
                 lambda: k_symv.symv_plain(alpha2, A, xa, beta2, ya),
                 lambda: lib.addmv(ya, A, xa, beta=beta2, alpha=alpha2),
                 tri_bytes + 4 * 3 * N2, mv_flops, "csrc/symv.cu",
                 "kernels/symv.py:63"),
        # CG_MATVEC's group: A and p read once, q written
        "anchored_kernel": (lambda: cg_run(cg_scal, cg_vecs),
                            lambda: cg_run.plain(cg_scal, cg_vecs), None,
                            4 * (N2 * N2 + 2 * N2), mv_flops + 2 * N2,
                            "kernels/anchored.py", "core/codegen.py:655"),
        # block-CG's product: A, B and C read, the output written
        "gemm": (lambda: ops.gemm(alpha2, A, Bp, beta2, Cp),
                 lambda: k_gemm.gemm_plain(alpha2, A, Bp, beta2, Cp),
                 lambda: lib.addmm(Cp, A, Bp, beta=beta2, alpha=alpha2),
                 mm_bytes, mm_flops, "csrc/gemm.cu", "kernels/gemm.py:69"),
        # BLOCK_CG_MATVEC's group: A and P read, q and pq written
        # A read once, Aᵀ written once
        "transpose": (lambda: ops.transpose(An),
                      lambda: k_transpose.transpose_plain(An),
                      lambda: An.t().contiguous(), 2 * 4 * N2 * N2, 0,
                      "csrc/transpose.cu", "kernels/transpose.py:38"),
        # A, x and y read once, A' written once
        "ger": (lambda: ops.ger(GER_ALPHA, xn, yn, An),
                lambda: k_ger.ger_plain(GER_ALPHA, xn, yn, An),
                lambda: lib.addr(An, xn, yn, alpha=GER_ALPHA),
                4 * (2 * N2 * N2 + 2 * N2), 2 * N2 * N2,
                "csrc/ger.cu", "kernels/ger.py:38"),
        "tiled_kernel": (lambda: t_run(t_scal, t_vecs),
                         lambda: t_run.plain(t_scal, t_vecs),
                         lambda: lib.matmul(A, Bp),
                         4 * (N2 * N2 + 2 * N2 * S_BLOCK + S_BLOCK),
                         mm_flops + 2 * N2 * S_BLOCK,
                         "csrc/gemm.cu", "core/codegen.py:934"),
    }
    # the attention kernels at the serve shapes: bfloat16 in, float32
    # accumulation, so the tensor cores' rate bounds their operations
    bq_, hq_, sp_, hd_ = sq_.shape
    hkv_ = sk_.shape[1]
    table["mha"] = (
        lambda: ops.mha(sq_, sk_, sv_),
        lambda: k_attn.mha_plain(sq_, sk_, sv_),
        lambda: F.scaled_dot_product_attention(sq_, sk_, sv_, is_causal=True,
                                               enable_gqa=True),
        2 * 2 * bq_ * sp_ * hd_ * (hq_ + hkv_),          # q, k, v, out
        4 * hd_ * bq_ * hq_ * (sp_ * (sp_ + 1) // 2),    # visible pairs
        "csrc/attention.cu", "kernels/attention.py:92")
    table["decode_attention"] = (
        lambda: ops.decode_attention(dq, dk, dv, dlen),
        lambda: k_dec.decode_attention_plain(dq, dk, dv, dlen),
        lambda: F.scaled_dot_product_attention(
            dq[:, :, None], dk[:, :, :mid], dv[:, :, :mid], enable_gqa=True),
        2 * 2 * bq_ * hkv_ * mid * hd_ + 2 * 2 * bq_ * hq_ * hd_ + 4 * bq_,
        4 * bq_ * hq_ * mid * hd_,
        "csrc/decode_attention.cu", "kernels/decode_attention.py:85")
    flops_per_s = {"mha": BF16_FLOPS_PER_S,
                   "decode_attention": BF16_FLOPS_PER_S}
    routes = {"gemv": "cuda", "gemvt": "cuda", "symv": "cuda",
              "gemm": "cuda", "tiled_kernel": "cuda", "transpose": "cuda",
              "ger": "cuda", "mha": "cuda", "decode_attention": "cuda"}

    def host_ms(fn, reps=20):
        """Host time to issue one call: no synchronisation inside the
        timed calls."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        issue = (time.perf_counter() - t0) / reps * 1e3
        torch.cuda.synchronize()
        return issue

    def measure(kfn, pfn, lfn, nbytes, flops, flops_per_s=F32_FLOPS_PER_S):
        # plain, kernel, kernel, plain: compare only within one call
        p1 = cuda_ms(pfn)
        k1 = cuda_ms(kfn)
        k2 = cuda_ms(kfn)
        p2 = cuda_ms(pfn)
        b_ms, b_by = bound(nbytes, flops, flops_per_s)
        return {"ms": min(k1, k2), "ms_runs": [k1, k2],
                "plain_ms": min(p1, p2), "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": cuda_ms(lfn) if lfn is not None else None}

    def timed_twice(kfn, lfn):
        """Device time per call from a CUDA-graph replay and the host's
        issue time per call, twice each (kernel, library, library,
        kernel where there is a library call)."""
        out = {"graph_ms": [graph_ms(kfn)], "host_ms": [host_ms(kfn)]}
        if lfn is not None:
            out["library_graph_ms"] = [graph_ms(lfn), graph_ms(lfn)]
        out["graph_ms"].append(graph_ms(kfn))
        out["host_ms"].append(host_ms(kfn))
        return out

    gmres_run, gmres_scal, gmres_vecs = anchored_runs["GMRES_ORTH"]
    sprog = l2_programs["SYMV_DOT"]["dataflow"]
    symv_run = codegen.make_anchored_callable(sprog.graph, sprog.groups[0],
                                              torch.float32)
    symv_scal, symv_vecs = group_args(sprog, symv_run, l2_inputs["SYMV_DOT"])
    sq = [randn2(SQUARE, SQUARE) for _ in range(3)]
    square = measure(
        lambda: ops.gemm(alpha2, *sq[:2], beta2, sq[2]),
        lambda: k_gemm.gemm_plain(alpha2, *sq[:2], beta2, sq[2]),
        lambda: lib.addmm(sq[2], *sq[:2], beta=beta2, alpha=alpha2),
        4 * 4 * SQUARE * SQUARE, 2 * SQUARE ** 3)
    emit({"phase": "times", "kernel": "gemm",
          "case": f"{SQUARE}^3 float32", "route": k_gemm.gemm_route(*sq[:2]),
          **square, "library_note": "torch.addmm"})

    # gemm's 16-bit rows (phase 1c's operands): the wgmma route beside its
    # plain version, the FFMA route forced for the row alone, and
    # torch.addmm with cuBLAS's reduced-precision reductions off, so that
    # it sums in float32 as the kernel does (the same function)
    @contextlib.contextmanager
    def ffma_route():
        saved = k_gemm.gemm_route
        k_gemm.gemm_route = k_gemm.load_route
        try:
            yield
        finally:
            k_gemm.gemm_route = saved

    @contextlib.contextmanager
    def float32_reduction():
        mm = torch.backends.cuda.matmul
        saved = (mm.allow_bf16_reduced_precision_reduction,
                 mm.allow_fp16_reduced_precision_reduction)
        mm.allow_bf16_reduced_precision_reduction = False
        mm.allow_fp16_reduced_precision_reduction = False
        try:
            yield
        finally:
            (mm.allow_bf16_reduced_precision_reduction,
             mm.allow_fp16_reduced_precision_reduction) = saved

    def gemm16_row(case, a, b, c):
        (m_, k_), n_ = a.shape, b.shape[1]
        flops = 2 * m_ * n_ * k_
        reps = 3 if flops > 1e12 else 20   # the prefill products: ~2 ms+
        kfn = lambda: ops.gemm(alpha2, a, b, beta2, c)   # noqa: E731
        pfn = lambda: k_gemm.gemm_plain(alpha2, a, b, beta2, c)  # noqa
        lfn = lambda: lib.addmm(c, a, b, beta=beta2,     # noqa: E731
                                alpha=alpha2)
        p1, k1 = cuda_ms(pfn, reps, 1), cuda_ms(kfn, reps, 1)
        k2, p2 = cuda_ms(kfn, reps, 1), cuda_ms(pfn, reps, 1)
        with ffma_route():
            ffma = {"ffma_route": k_gemm.gemm_route(a, b),
                    "ffma_ms": cuda_ms(kfn, reps, 1)}
        with float32_reduction():
            lib_ms = cuda_ms(lfn, reps, 1)
        nbytes = a.element_size() * (m_ * k_ + k_ * n_ + 2 * m_ * n_)
        b_ms, b_by = bound(nbytes, flops, BF16_FLOPS_PER_S)
        row = {"case": case, "route": k_gemm.gemm_route(a, b),
               "plan": str(k_gemm.plan_for(a, b)), "ms": min(k1, k2),
               "ms_runs": [k1, k2],
               "graph_ms": graph_ms(kfn, 2 if reps == 3 else 20),
               "host_ms": host_ms(kfn, reps), "plain_ms": min(p1, p2),
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
               **ffma, "tflop_per_s": flops / min(k1, k2) * 1e-9,
               "gb_per_s": nbytes / min(k1, k2) * 1e-6}
        check(row["route"] == "wgmma" and ffma["ffma_route"] == "tma",
              f"gemm {case}: routes {row['route']}, {ffma['ffma_route']}")
        emit({"phase": "times", "kernel": "gemm (wgmma)", **row,
              "library_note": "torch.addmm, allow_bf16/fp16_reduced_"
                              "precision_reduction False"})
        return row

    t_g16 = time.perf_counter()
    gemm16["bfloat16 16384^2 x 32"] = [A.to(torch.bfloat16),
                                       Bp.to(torch.bfloat16),
                                       Cp.to(torch.bfloat16)]
    gemm16_rows = [gemm16_row(case, *ops_) for case, ops_ in gemm16.items()]
    del gemm16
    emit({"phase": "times", "program": "gemm 16-bit rows",
          "seconds": time.perf_counter() - t_g16})
    extra = {
        "gemv": {
            "short_wide_31x2^20": {**measure(
                lambda: ops.gemv(alpha2, V, w, beta2, h),
                lambda: k_gemv.gemv_plain(alpha2, V, w, beta2, h),
                lambda: lib.addmv(h, V, w, beta=beta2, alpha=alpha2),
                4 * (m_b * n_b + n_b + 2 * m_b), basis_flops), **timed_twice(
                    lambda: ops.gemv(alpha2, V, w, beta2, h),
                    lambda: lib.addmv(h, V, w, beta=beta2, alpha=alpha2))},
            "gmres_basis_21x16384": {**measure(
                lambda: ops.gemv(alpha2, W21, w21, beta2, h21),
                lambda: k_gemv.gemv_plain(alpha2, W21, w21, beta2, h21),
                lambda: lib.addmv(h21, W21, w21, beta=beta2, alpha=alpha2),
                4 * (m_g21 * N2 + N2 + 2 * m_g21), 2 * m_g21 * N2),
                **timed_twice(
                    lambda: ops.gemv(alpha2, W21, w21, beta2, h21),
                    lambda: lib.addmv(h21, W21, w21, beta=beta2,
                                      alpha=alpha2))},
            **timed_twice(
                lambda: ops.gemv(alpha2, A, xa, beta2, ya),
                lambda: lib.addmv(ya, A, xa, beta=beta2, alpha=alpha2)),
            "plan": str(k_gemv.gemv_plan_for(A)),
            "plan_short_wide": str(k_gemv.gemv_plan_for(V)),
            "plan_gmres_basis": str(k_gemv.gemv_plan_for(W21))},
        "gemvt": {"short_wide_31x2^20": {**measure(
            lambda: ops.gemvt(alpha2, V, h, beta2, w),
            lambda: k_gemv.gemvt_plain(alpha2, V, h, beta2, w),
            lambda: lib.addmv(w, V.t(), h, beta=beta2, alpha=alpha2),
            basis_bytes, basis_flops), **timed_twice(
                lambda: ops.gemvt(alpha2, V, h, beta2, w),
                lambda: lib.addmv(w, V.t(), h, beta=beta2,
                                  alpha=alpha2))},
            **timed_twice(
                lambda: ops.gemvt(alpha2, A, xa, beta2, ya),
                lambda: lib.addmv(ya, A.t(), xa, beta=beta2, alpha=alpha2)),
            "plan": str(k_gemv.gemvt_plan_for(A)),
            "plan_short_wide": str(k_gemv.gemvt_plan_for(V))},
        "symv": {"library_note": "torch.addmv over the full matrix: "
                                 "reads n^2 elements",
                 "case_routes": symv_case_routes},
        "anchored_kernel": {
            "case": "CG_MATVEC group (gemv -> dot) at 16384^2",
            # the gemvt and symv anchors' products are the standalone
            # kernels' CUDA mainloops; their epilogues are Triton
            "products": {
                "gemvt": {"route": "cuda",
                          "source": "src/repro_torch/csrc/gemv.cu"},
                "symv": {"route": "cuda",
                         "source": "src/repro_torch/csrc/symv.cu"}},
            "gmres_orth_gemvt_31x2^20": {**measure(
                lambda: gmres_run(gmres_scal, gmres_vecs),
                lambda: gmres_run.plain(gmres_scal, gmres_vecs), None,
                basis_bytes, basis_flops + 2 * n_b), **timed_twice(
                    lambda: gmres_run(gmres_scal, gmres_vecs), None)},
            "symv_dot_16384^2": {**measure(
                lambda: symv_run(symv_scal, symv_vecs),
                lambda: symv_run.plain(symv_scal, symv_vecs), None,
                tri_bytes + 4 * N2, mv_flops + 2 * N2), **timed_twice(
                    lambda: symv_run(symv_scal, symv_vecs), None)},
            **timed_twice(lambda: cg_run(cg_scal, cg_vecs), None)},
        "gemm": {"case": "(16384^2) . (16384 x 32) float32",
                 "square_4096^3": square},
        "tiled_kernel": {
            "case": "BLOCK_CG_MATVEC group (gemm -> coldot) at (16384^2) "
                    ". (16384 x 32)",
            # the product is gemm's mainloop; the generated epilogue and
            # the column fold are Triton
            "epilogue": {"route": "triton",
                         "source": "src/repro_torch/kernels/tiled.py"},
            "library_note": "torch.matmul(A, P): the product alone"},
        "transpose": {
            "case": "16384^2 float32",
            "gmres_hessenberg_20x21": measure(
                lambda: ops.transpose(small[0]),
                lambda: k_transpose.transpose_plain(small[0]),
                lambda: small[0].t().contiguous(),
                2 * 4 * HESSENBERG[0] * HESSENBERG[1], 0)},
        "ger": {"case": "16384^2 float32",
                "library_note": "torch.addr(A, x, y, alpha=): rounds "
                                "alpha x_i y_j in another order"},
        "mha": {"case": f"serve prefill layer: q ({bq_}, {hq_}, {sp_}, "
                        f"{hd_}), k/v {hkv_} heads, bfloat16, causal",
                "library_note": "F.scaled_dot_product_attention(is_causal"
                                ", enable_gqa)"},
        "decode_attention": {
            "case": f"serve decode step: q ({bq_}, {hq_}, {hd_}), cache "
                    f"{tuple(dk.shape)} strided view, len {mid}, bfloat16",
            "library_note": "F.scaled_dot_product_attention on the cache "
                            "sliced to len (one len for every row)"},
    }
    kernels = []
    for name, (kfn, pfn, lfn, nbytes, flops, src, replaces) in \
            table.items():
        if src is None:
            src = "core/codegen.py"
        elif "/" not in src:
            src = f"kernels/{src}"
        entry = {
            "name": name, "route": routes.get(name, "triton"),
            "source": f"src/repro_torch/{src}",
            "replaces": f"src/repro/{replaces}",
            "launches": launches[name],
            "finish_launches": finishes[name],
            "folded": folds[name],
            **({"route_launches": route_totals[name]}
               if name in route_totals else {}),
            "max_abs_err": errors[name],
            **measure(kfn, pfn, lfn, nbytes, flops,
                      flops_per_s.get(name, F32_FLOPS_PER_S)),
            **extra.get(name, {})}
        if name == "iamax":
            entry["library_note"] = "torch.argmax(x.abs()): two calls"
        if name in ("mha", "decode_attention", "gemm", "tiled_kernel"):
            # the function's rate at the kernel's time, device times with
            # no host issue between calls (the events above time
            # back-to-back calls, which the host can pace) and the host's
            # issue time per call
            entry["tflop_per_s"] = flops / entry["ms"] * 1e-9
            entry["gb_per_s"] = nbytes / entry["ms"] * 1e-6
            entry["graph_ms"] = graph_ms(kfn)
            entry["library_graph_ms"] = graph_ms(lfn)
            entry["host_ms"] = host_ms(kfn)
            entry["library_host_ms"] = host_ms(lfn)
        kernels.append(entry)
    # gemm's wgmma route, its own row: timed at the prefill's gate/up
    # product, the main path's largest; every 16-bit row beside it
    (main16,) = [r for r in gemm16_rows if "prefill gate/up" in r["case"]]
    kernels.append({
        "name": "gemm (wgmma)", "route": "cuda",
        "source": "src/repro_torch/csrc/gemm.cu",
        "replaces": "src/repro/kernels/gemm.py:69",
        "launches": launches["gemm (wgmma)"],
        "max_abs_err": errors["gemm (wgmma)"],
        **{key: main16[key] for key in (
            "case", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "graph_ms", "host_ms", "ffma_ms", "tflop_per_s")},
        "library_note": "torch.addmm, reduced-precision reductions off",
        "rows": gemm16_rows})

    df1 = cuda_ms(lambda: programs["dataflow"](**axpydot_inputs))
    ndf1 = cuda_ms(lambda: programs["nodataflow"](**axpydot_inputs))
    ndf2 = cuda_ms(lambda: programs["nodataflow"](**axpydot_inputs))
    df2 = cuda_ms(lambda: programs["dataflow"](**axpydot_inputs))
    ref_ms = cuda_ms(lambda: programs["reference"](**axpydot_inputs))
    wide_ms = cuda_ms(lambda: wide["dataflow"](**wide_inputs))
    wide_run = codegen.make_group_callable(
        wide["dataflow"].graph, wide["dataflow"].groups[0], torch.float32)
    wide_scalars = {("wx", "alpha"): 0.5, ("wx", "beta"): 2.0,
                    ("sc", "alpha"): wide_inputs["a"]}
    wide_vecs = {("wx", "x"): x, ("wx", "y"): y, ("dd", "y"): x}
    check(set(wide_run.signature.vec_in_keys) == set(wide_vecs),
          "wide group signature")
    wide_kernel_ms = cuda_ms(lambda: wide_run(wide_scalars, wide_vecs))
    df, ndf = min(df1, df2), min(ndf1, ndf2)
    emit({"phase": "times", "program": "axpydot", "n": N,
          "dataflow_ms": df, "dataflow_runs": [df1, df2],
          "dataflow_bound_ms": 3 * n4 / HBM_BYTES_PER_S * 1e3,
          "nodataflow_ms": ndf, "nodataflow_runs": [ndf1, ndf2],
          "nodataflow_traffic_bound_ms": 5 * n4 / HBM_BYTES_PER_S * 1e3,
          "reference_ms": ref_ms, "nodf_over_df": ndf / df,
          "expected_ratio": 5 / 3})
    emit({"phase": "times", "program": "waxpby->scal->{dot,nrm2,iamax}",
          "n": N, "dataflow_ms": wide_ms, "group_kernel_ms": wide_kernel_ms,
          "bound_ms": 3 * n4 / HBM_BYTES_PER_S * 1e3})
    cdf1 = cuda_ms(lambda: cg["dataflow"](**cg_in))
    cndf1 = cuda_ms(lambda: cg["nodataflow"](**cg_in))
    cndf2 = cuda_ms(lambda: cg["nodataflow"](**cg_in))
    cdf2 = cuda_ms(lambda: cg["dataflow"](**cg_in))
    cref = cuda_ms(lambda: cg["reference"](**cg_in))
    cdf, cndf = min(cdf1, cdf2), min(cndf1, cndf2)
    gm, gm_in = l2_programs["GMRES_ORTH"], l2_inputs["GMRES_ORTH"]
    gdf = cuda_ms(lambda: gm["dataflow"](**gm_in))
    gndf = cuda_ms(lambda: gm["nodataflow"](**gm_in))
    emit({"phase": "times", "program": "GMRES_ORTH", "shape": list(BASIS),
          "dataflow_ms": gdf, "nodataflow_ms": gndf,
          "bound_ms": basis_bytes / HBM_BYTES_PER_S * 1e3})
    emit({"phase": "times", "program": "CG_MATVEC", "n": N2,
          "dataflow_ms": cdf, "dataflow_runs": [cdf1, cdf2],
          "dataflow_bound_ms": 4 * (N2 * N2 + 2 * N2) / HBM_BYTES_PER_S
          * 1e3,
          "nodataflow_ms": cndf, "nodataflow_runs": [cndf1, cndf2],
          "nodataflow_traffic_bound_ms": 4 * (N2 * N2 + 5 * N2)
          / HBM_BYTES_PER_S * 1e3,
          "reference_ms": cref, "nodf_over_df": cndf / cdf,
          "expected_ratio": (N2 * N2 + 5 * N2) / (N2 * N2 + 2 * N2)})

    def solve_ms(lp, **operands):
        """One solve timed with CUDA events (the host loop syncs once per
        iteration, so this is its wall time on the device's clock), its
        iterations and the iterations the host issued."""
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        res, issued = issued_iterations(lambda: lp.solve(**operands))
        ev1.record()
        ev1.synchronize()
        return ev0.elapsed_time(ev1), int(res.iterations), issued

    blk_ops = dict(A=A_spd, B=B_blk, x0=X0)
    products = (ops.gemm, codegen.tiled_kernel)
    common.reset_counts(*products)
    turns = [(m, solve_ms(blk_progs[m], **blk_ops))
             for m in ("dataflow", "nodataflow", "nodataflow", "dataflow",
                       "reference")]
    blk_ms = {m: min(t for mm, (t, _, _) in turns if mm == m)
              for m in ("dataflow", "nodataflow", "reference")}
    its_t = {m: i for m, (_, i, _) in turns}
    # every product of the timed solves (gemm in nodataflow, the tiled
    # group's in dataflow, one per iteration the host issued and one for
    # the setup's BLOCK_RESIDUAL) on the TMA route
    got_routes = {w.__name__: dict(w.route_launches) for w in products}
    want_routes = {
        w: {"tma": sum(issued + 1 for m, (_, _, issued) in turns
                       if m == mode),
            "ldg": 0, "wgmma": 0}
        for w, mode in (("gemm", "nodataflow"),
                        ("tiled_kernel", "dataflow"))}
    ok = got_routes == want_routes
    emit({"phase": "main_path_check", "program": "BLOCK_CG_LOOP timed",
          "product_routes": got_routes, "want": want_routes, "ok": ok})
    check(ok, f"timed block-CG products: routes {got_routes} (want "
              f"{want_routes})")
    emit({"phase": "times", "program": "BLOCK_CG_LOOP", "n": N2,
          "s": S_BLOCK, "kappa": KAPPA, "iterations": its_t,
          "solve_ms": blk_ms,
          "solve_runs_ms": [[m, t] for m, (t, _, _) in turns],
          "per_iteration_ms": {m: blk_ms[m] / its_t[m] for m in blk_ms},
          "tiled_kernel_ms": next(k["ms"] for k in kernels
                                  if k["name"] == "tiled_kernel"),
          "cg_loop_32_columns_ms": cg_total_ms,
          "cg_loop_32_columns_iterations": sum(its_cg),
          "cg_ms_per_iteration": cg_total_ms / sum(its_cg),
          "cg_32_over_block_cg_dataflow": cg_total_ms / blk_ms["dataflow"]})
    turns = [(m, solve_ms(gm_progs[m], **gm_ops))
             for m in ("dataflow", "nodataflow", "nodataflow", "dataflow",
                       "reference")]
    gm_ms = {m: min(t for mm, (t, _, _) in turns if mm == m)
             for m in ("dataflow", "nodataflow", "reference")}
    its_t = {m: i for m, (_, i, _) in turns}
    emit({"phase": "times", "program": "GMRES_LOOP", "n": N2, "m": m_g,
          "shift_c": GMRES_SHIFT, "restarts": its_t, "solve_ms": gm_ms,
          "solve_runs_ms": [[m, t] for m, (t, _, _) in turns],
          "per_restart_ms": {m: gm_ms[m] / its_t[m] for m in gm_ms}})
    # the function layer's dispatch (a signature bind and a dict lookup
    # before the program call) beside a direct call of the same compiled
    # program on the same inputs: blas, program, program, blas
    api_calls = {
        "axpy": (lambda: blas.axpy(alpha2, x, y, device="cuda"),
                 Program.from_spec(blas_fn.routine_spec("axpy"),
                                   device="cuda"),
                 dict(alpha=alpha2, x=x, y=y)),
        "dot": (lambda: blas.dot(x, y, device="cuda"),
                Program.from_spec(blas_fn.routine_spec("dot"),
                                  device="cuda"), dict(x=x, y=y))}
    for name, (bfn, dprog, inputs) in api_calls.items():
        b1 = host_ms(bfn)
        p1 = host_ms(lambda: dprog(**inputs))
        p2 = host_ms(lambda: dprog(**inputs))
        b2 = host_ms(bfn)
        emit({"phase": "api_host", "function": f"blas.{name}", "n": N,
              "host_ms": [b1, b2], "program_host_ms": [p1, p2],
              "overhead_ms": min(b1, b2) - min(p1, p2)})
    sampler.terminate()
    samples = []
    for row in sampler.communicate(timeout=60)[0].splitlines():
        try:
            mhz, watts = (float(v) for v in row.split(","))
        except ValueError:      # a cut or "[N/A]" row
            continue
        samples.append((mhz, watts))
    # under load: the samples drawing more than LOADED_W
    loaded = sorted(mhz for mhz, watts in samples if watts > LOADED_W)
    emit({"phase": "clocks", "samples": len(samples),
          "loaded_samples": len(loaded),
          "loaded_sm_mhz": {"min": loaded[0], "median":
                            loaded[len(loaded) // 2], "max": loaded[-1]}
          if loaded else None,
          "max_power_w": max((w for _, w in samples), default=None)})
    emit({"phase": "build", "nvcc_s": nvcc_s, "first_call_s": first_call_s,
          "first_calls_total_s": sum(first_call_s.values())})
    # gemvt folds its row splits in a cluster, gemv its column chunks in
    # the band's last block, and a reducing window pass its partials in
    # its last program: no combine on the main path, and every reducing
    # window pass folded
    for name in ("gemvt", "gemv", "dot", "asum", "nrm2", "iamax",
                 "axpydot"):
        ok = finishes[name] == 0 and (
            name in ("gemvt", "gemv") or folds[name] == launches[name])
        emit({"phase": "main_path_check", "kernel": name,
              "combines": finishes[name], "folded": folds[name],
              "launches": launches[name], "ok": ok})
        check(ok, f"{name} launched a combine, or a pass did not fold")
    # ------------------------------------------------------------------
    # 5. the static analyzer, the autotuner and the drift report
    # ------------------------------------------------------------------
    from repro_torch import tune as t_tune, verify as t_verify
    from repro_torch.kernels import (anchored as k_anchored,
                                     tiled as k_tiled, window as k_window)
    from repro_torch.tune import config as t_config
    from repro_torch.verify import __main__ as verify_main

    smem_limit = cuda.smem_optin(dev)
    props = torch.cuda.get_device_properties(dev)
    emit({"phase": "verify", "part": "limit", "nvidia_smi": smi,
          "smem_per_block_optin": smem_limit,
          "torch_smem_per_block_optin": getattr(
              props, "shared_memory_per_block_optin", None),
          "budget_used": common.smem_budget(),
          "table": str(table_dir)})
    check(common.smem_budget() == smem_limit,
          f"the analyzer's budget {common.smem_budget()} is not the card's "
          f"{smem_limit}")

    # every shipped spec is clean on the card host; the analyzer's host
    # time per spec
    analyze_ms, unclean = {}, []
    for label, raw in verify_main._shipped():
        t0 = time.perf_counter()
        rep = t_verify.analyze(raw)
        analyze_ms[label] = (time.perf_counter() - t0) * 1e3
        if rep.errors or rep.warnings:
            unclean.append((label, rep.format()))
    emit({"phase": "verify", "part": "shipped", "specs": len(analyze_ms),
          "unclean": unclean, "analyze_ms": analyze_ms,
          "analyze_ms_max": max(analyze_ms.values()), "ok": not unclean})
    check(not unclean, f"shipped specs fire diagnostics: {unclean}")

    # a cold compile with the analyzer and without, in turns
    def compile_ms(raw, verify):
        lowering.clear_cache()
        t0 = time.perf_counter()
        blas.compile(raw, device="cuda", verify=verify, tiles="default")
        return (time.perf_counter() - t0) * 1e3

    cold = {}
    for label, raw in (("CG_MATVEC", solver_specs.CG_MATVEC),
                       ("GMRES_LOOP", solver_specs.GMRES_LOOP)):
        runs = [(v, compile_ms(raw, v)) for v in (True, False, False,
                                                  True)]
        cold[label] = {"verify_ms": [t for v, t in runs if v],
                       "no_verify_ms": [t for v, t in runs if not v]}
    emit({"phase": "verify", "part": "cold_compile", "ms": cold})

    # each CUDA kernel's footprint (kernels/*.py) against what its
    # compiled kernel requests: static (cudaFuncGetAttributes) plus the
    # dynamic bytes of its launch
    fp_rows, fp_bad = [], []

    def fp_check(kernel, dtype, priced, asked):
        fp_rows.append({"kernel": kernel, "dtype": str(dtype).split(".")[-1],
                        "footprint": priced, "requested": asked})
        if priced < asked:
            fp_bad.append(fp_rows[-1])

    for dt in (torch.float32, torch.bfloat16):
        isz = torch.tensor([], dtype=dt).element_size()
        g = k_gemv.gemv_footprint(isz)
        for rows in (8, 16, 32):
            fp_check(f"gemv_band_kernel/tma rows={rows}", dt,
                     k_gemv.gemv_footprint(isz, t_config.TileConfig(
                         block_m=rows))[0].bytes,
                     cuda.smem_bytes("gemv", "repro_gemv_smem", dt, 0, rows,
                                     k_gemv.BAND_STAGES))
        fp_check("gemv_band_kernel/ldg", dt, g[0].bytes,
                 cuda.smem_bytes("gemv", "repro_gemv_smem", dt, 1, 32, 1))
        for kern, name in ((2, "gemv_rows_kernel/vec"),
                           (3, "gemv_rows_kernel/scalar")):
            fp_check(name, dt, g[1].bytes, cuda.smem_bytes(
                "gemv", "repro_gemv_smem", dt, kern, 8, 1))
        gt = k_gemv.gemvt_footprint(isz)[0].bytes
        for kern, name in ((4, "gemvt_kernel/tma"), (5, "gemvt_kernel/ldg"),
                           (6, "gemvt_kernel/tma raw"),
                           (7, "gemvt_kernel/ldg raw")):
            fp_check(name, dt, gt, cuda.smem_bytes(
                "gemv", "repro_gemv_smem", dt, kern, 32, 1))
        s = k_symv.footprint(isz)
        for kern, name, fp in ((0, "symv_kernel/tma", s[0]),
                               (1, "symv_kernel/ldg", s[0]),
                               (2, "symv_fold_kernel", s[1]),
                               (3, "symv_fold_kernel raw", s[1])):
            fp_check(name, dt, fp.bytes, cuda.smem_bytes(
                "symv", "repro_symv_smem", dt, kern))
        for width in k_gemm.WIDTHS:
            fp_check(f"gemm_kernel width={width}", dt, k_gemm.footprint(
                isz, t_config.TileConfig(block_n=width))[0].bytes,
                cuda.smem_bytes("gemm", "repro_gemm_smem", dt, width))
        fp_check("combine_kernel", dt, k_gemm.footprint(isz)[1].bytes,
                 cuda.smem_bytes("gemm", "repro_gemm_smem", dt, 0))
        if isz == 2:     # the wgmma route, every tile
            for bm in (64, 128):
                for bn in k_gemm.WG_WIDTHS:
                    fp_check(f"gemm_wgmma_kernel bm={bm} bn={bn}", dt,
                             k_gemm.footprint(isz)[2].bytes,
                             cuda.smem_bytes("gemm", "repro_gemm_wgmma_smem",
                                             dt, bm, bn))
        fp_check("transpose_kernel", dt, k_transpose.footprint(isz)[0].bytes,
                 cuda.smem_bytes("transpose", "repro_transpose_smem", dt))
        for vec in (1, 0):
            fp_check(f"ger_kernel vec={vec}", dt, k_ger.footprint(isz)[0]
                     .bytes, cuda.smem_bytes("ger", "repro_ger_smem", dt,
                                             vec))
    emit({"phase": "verify", "part": "cuda_footprints", "rows": fp_rows,
          "not_priced": "mha, decode_attention: no spec routine reaches "
                        "them", "ok": not fp_bad})
    check(not fp_bad, f"footprints below the compiled kernels' request: "
                      f"{fp_bad}")

    # the default plans and a cold "auto" table run the same programs
    same = {}
    cold_cases = {
        "AXPYDOT": (AXPYDOT_SPEC, axpydot_inputs),
        "CG_MATVEC": (l2_programs["CG_MATVEC"]["dataflow"].ir.raw,
                      l2_inputs["CG_MATVEC"]),
        "BLOCK_CG_MATVEC": (solver_specs.BLOCK_CG_MATVEC,
                            dict(A=A, P=Bp))}
    for label, (raw, inputs) in cold_cases.items():
        d = blas.compile(raw, device="cuda", tiles="default")
        a = blas.compile(raw, device="cuda", tiles="auto")
        od, oa = d.run(**inputs), a.run(**inputs)
        same[label] = (not a._impl.ir.tile_plan
                       and all(torch.equal(od[k], oa[k]) for k in od))
    emit({"phase": "verify", "part": "cold_auto_vs_default",
          "bitwise_equal": same, "ok": all(same.values())})
    check(all(same.values()), f"cold auto differs from default: {same}")

    # the tuner on the kernels of the main path, at its widths
    def f64_axpydot(out):
        ex, mg = f64_terms("axpydot", (x, y, z), alpha=-neg_alpha)
        err = abs(float(out["beta"]) - ex)
        return err / (1e-5 * mg)

    def matvec_close(name):
        ref = l2_programs[name]["reference"](**l2_inputs[name])

        def close(out):
            worst = outputs_close(out, ref, l2_exact[name])
            return max(worst, reductions_close(name, out,
                                               l2_inputs[name]) or 0.0)
        return close

    P64 = Bp.double()
    Q64 = A.double() @ P64
    QMAG = A.double().abs() @ P64.abs()

    def block_close(out):
        q = out["q"].double()
        worst = float(((q - Q64).abs() / (1e-5 * QMAG)).max())
        terms = P64 * q
        return max(worst, float(((out["pq"].double() - terms.sum(0)).abs()
                                 / (1e-5 * terms.abs().sum(0))).max()))

    def gemv_close(a, xv, yv):
        a64 = a.double()
        want = alpha2 * (a64 @ xv.double()) + beta2 * yv.double()
        tol = 1e-5 * abs(alpha2) * (a64.abs() @ xv.double().abs()) \
            + 1e-6 * abs(beta2) * yv.double().abs()
        plain = k_gemv.gemv_plain(alpha2, a, xv, beta2, yv).double()

        def close(out):
            got = out["y"].double() if "y" in out else next(
                iter(out.values())).double()
            return max(float(((got - want).abs() / tol).max()),
                       float(((got - plain).abs() / tol).max()))
        return close

    gemv_spec = blas_fn.routine_spec("gemv")
    tune_cases = [
        ("AXPYDOT", AXPYDOT_SPEC, axpydot_inputs, f64_axpydot, "l1"),
        ("CG_MATVEC", l2_programs["CG_MATVEC"]["dataflow"].ir.raw,
         l2_inputs["CG_MATVEC"], matvec_close("CG_MATVEC"), "gemv anchor"),
        ("SYMV_DOT", l2_programs["SYMV_DOT"]["dataflow"].ir.raw,
         l2_inputs["SYMV_DOT"], matvec_close("SYMV_DOT"), "symv anchor"),
        ("GMRES_ORTH", l2_programs["GMRES_ORTH"]["dataflow"].ir.raw,
         l2_inputs["GMRES_ORTH"], matvec_close("GMRES_ORTH"),
         "gemvt anchor"),
        ("BLOCK_CG_MATVEC", solver_specs.BLOCK_CG_MATVEC, dict(A=A, P=Bp),
         block_close, "gemm, tiled"),
        ("blas.gemv (21, 16384)", gemv_spec,
         dict(A=W21, x=w21, y=h21, alpha=alpha2, beta=beta2),
         gemv_close(W21, w21, h21), "gemv"),
        ("blas.gemv 16384^2", gemv_spec,
         dict(A=A, x=xa, y=ya, alpha=alpha2, beta=beta2),
         gemv_close(A, xa, ya), "gemv"),
    ]
    tuned_exes, tune_rows = {}, []
    for label, raw, inputs, close, family in tune_cases:
        shapes = {k: tuple(v.shape) for k, v in inputs.items()
                  if torch.is_tensor(v) and v.ndim}
        default = blas.compile(raw, device="cuda", tiles="default")
        t0 = time.perf_counter()
        tuned = default.tune(shapes, budget=TUNE_BUDGET, iters=TUNE_ITERS)
        sweep_s = time.perf_counter() - t0
        tuned_exes[label] = tuned
        rep = tuned.tune_report
        run_d = lambda: default._impl(**inputs)   # noqa: E731
        run_w = lambda: tuned._impl(**inputs)     # noqa: E731
        d1, w1, w2, d2 = (cuda_ms(f) for f in (run_d, run_w, run_w, run_d))
        graph = {}
        for which, fn in (("default", run_d), ("winner", run_w)):
            try:
                graph[which] = [graph_ms(fn), graph_ms(fn)]
            except Exception as e:          # a program that cannot capture
                torch.cuda.synchronize()
                graph[which] = f"no capture: {type(e).__name__}: {e}"
        got1, got2 = run_w(), run_w()
        bitwise = all(torch.equal(got1[k], got2[k]) for k in got1)
        err = close(got1)
        holds = bool(rep.winners) and min(w1, w2) < \
            min(d1, d2) * t_tune.autotuner.IMPROVEMENT_MARGIN
        row = {"phase": "tune", "program": label, "family": family,
               "shapes": {k: list(v) for k, v in shapes.items()},
               "sweeps": rep.sweeps, "sweep_s": sweep_s,
               "measured": [[m.site, m.tiles, m.us] for m in
                            rep.measurements],
               "baseline_us": rep.baseline_us, "tuned_us": rep.tuned_us,
               "winners": {s: c.key() for s, c in rep.winners.items()},
               "plan": tuned._impl.ir.tile_plan.to_dict(),
               "default_ms": [d1, d2], "winner_ms": [w1, w2],
               "graph_ms": graph, "winner_holds_up": holds,
               "err_over_tol": err, "bitwise_repeat": bitwise,
               "ok": err <= 1.0 and bitwise}
        tune_rows.append(row)
        emit(row)
        check(err <= 1.0, f"tuned {label} disagrees with its plain version "
                          f"({err} of its tolerance)")
        check(bitwise, f"tuned {label} does not repeat bitwise")

    # a second process over the same table takes the tuned artifacts and
    # sweeps nothing
    child = (
        "import json, sys\n"
        f"sys.path.insert(0, {str(ROOT / 'src')!r})\n"
        "from repro_torch import blas, obs\n"
        "out = {}\n"
        "for label, raw in json.loads(sys.argv[1]):\n"
        "    with obs.capture() as reg:\n"
        "        exe = blas.compile(raw, device='cuda')\n"
        "    names = [r['name'] for r in reg.records]\n"
        "    out[label] = {'hit': names.count('tune.cache.hit'),\n"
        "                  'miss': names.count('tune.cache.miss'),\n"
        "                  'measure': names.count('tune.measure'),\n"
        "                  'plan': exe._impl.ir.tile_plan.key()}\n"
        "print(json.dumps(out))\n")
    # the two blas.gemv tunes share one spec, so one artifact: its plan
    # holds both shape buckets, as the second tune's handle resolved it
    cases = [[label, raw] for label, raw, *_ in tune_cases
             if label != "blas.gemv (21, 16384)"]
    proc = subprocess.run([sys.executable, "-c", child, json.dumps(cases)],
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"the recompile process failed: "
                                f"{proc.stderr[-2000:]}")
    sub = json.loads(proc.stdout.strip().splitlines()[-1])
    want_plan = {label: tuned_exes[label]._impl.ir.tile_plan.key()
                 for label, _ in cases}
    ok = all(r["hit"] == 1 and r["miss"] == 0 and r["measure"] == 0
             and r["plan"] == want_plan[k] for k, r in sub.items())
    emit({"phase": "tune", "part": "subprocess_recompile", "results": sub,
          "want_plans": want_plan, "ok": ok})
    check(ok, f"the recompile did not take the artifacts: {sub}")

    # CG and block-CG under the tuned plans beside the default plans;
    # true_residuals reads A_spd64 (freed after phase 2), made again here
    A_spd64 = A_spd.double()
    loop_rows = {}
    for label, raw, operands in (
            ("CG_LOOP", solver_specs.CG_LOOP,
             dict(A=A_spd, b=b_cols[0], x0=zero_n)),
            ("BLOCK_CG_LOOP", solver_specs.BLOCK_CG_LOOP,
             dict(A=A_spd, B=B_blk, x0=X0))):
        lps = {t: LoopProgram(raw, mode="dataflow", device="cuda", tiles=t)
               for t in ("default", "auto")}
        for lp in lps.values():
            lp.solve(**operands)             # builds every kernel
        turns = [(t, solve_ms(lps[t], **operands))
                 for t in ("default", "auto", "auto", "default")]
        results = {t: lps[t].solve(**operands) for t in lps}
        rhs = operands.get("b", operands.get("B"))
        tres = {t: float(true_residuals(r.x, rhs).max())
                for t, r in results.items()}
        plans = {cs.ir.spec.name: cs.ir.tile_plan.to_dict()
                 for cs in lps["auto"].lir.body if cs.tag == "program"}
        row = {"phase": "tune", "part": "solve", "program": label,
               "n": N2, "status": {t: r.status_names()
                                   for t, r in results.items()},
               "iterations": {t: int(r.iterations)
                              for t, r in results.items()},
               "solve_ms": {t: [ms for tt, (ms, _, _) in turns if tt == t]
                            for t in lps},
               "true_residual": tres, "residual_bound": res_bound,
               "tuned_stage_plans": plans,
               "ok": all(r.status_names() == "CONVERGED"
                         for r in results.values())
               and max(tres.values()) <= res_bound}
        loop_rows[label] = row
        emit(row)
        check(row["ok"], f"{label} under the tuned plans: {row['status']}, "
                         f"true residuals {tres}")
        del lps, results
    del A_spd64

    # every Triton kernel compiled so far (default and tuned plans): its
    # footprint against the compiled kernel's shared memory
    def compiled(jit):
        caches = getattr(jit, "device_caches", None)
        if caches:
            for entry in caches.values():
                yield from (entry[0] if isinstance(entry, tuple)
                            else entry).values()
        else:
            for cache in getattr(jit, "cache", {}).values():
                yield from cache.values()

    def constexprs(k):
        src = getattr(k, "src", None)
        names = list(getattr(getattr(src, "fn", None), "arg_names", None)
                     or [])
        out = {}
        for key, v in (getattr(src, "constants", None) or {}).items():
            idx = key[0] if isinstance(key, tuple) and key else key
            if isinstance(idx, str):
                out[idx] = v
            elif isinstance(idx, int) and idx < len(names):
                out[names[idx]] = v
        return out

    tri_rows, tri_bad = [], []

    def tri_check(module, kname, k, priced):
        asked = int(k.metadata.shared)
        tri_rows.append({"module": module, "kernel": kname,
                         "constexprs": {a: b for a, b in constexprs(k)
                                        .items() if isinstance(b, int)},
                         "footprint": priced, "requested": asked})
        if priced < asked:
            tri_bad.append(tri_rows[-1])

    # a window pass is one kernel, its combine folded into it
    for body, mod in k_window._MODULES.items():
        check(not hasattr(mod, "finish_kernel"),
              "a window module has a finish_kernel")
        for k in compiled(mod.window_kernel):
            tri_check("window", "window_kernel", k,
                      k_window.footprint(body)[0].bytes)
    for body, mod in k_anchored._MODULES.items():
        for k in compiled(mod.anchored_kernel):
            c = constexprs(k)
            cfg = t_config.TileConfig(block_m=c.get("BO"),
                                      block_n=c.get("BR"))
            tri_check("anchored", "anchored_kernel", k,
                      k_anchored.footprint(body, 4, cfg)[0].bytes)
        if body.sums or body.argmaxes:
            for k in compiled(mod.finish_kernel):
                tri_check("anchored", "finish_kernel", k,
                          k_window.finish_footprint(body)[0].bytes)
    for body, mod in k_tiled._MODULES.items():
        fps = {fp.kernel: fp.bytes for fp in k_tiled.footprint(body, 4)}
        for kname in ("tiled_kernel", "colsum_kernel", "finish_kernel"):
            if kname in fps and hasattr(mod, kname):
                for k in compiled(getattr(mod, kname)):
                    tri_check("tiled", kname, k, fps[kname])
    # one row per distinct (kernel, constexprs, footprint, request)
    distinct = sorted({json.dumps(r, sort_keys=True) for r in tri_rows})
    emit({"phase": "verify", "part": "triton_footprints",
          "kernels": len(tri_rows), "rows": [json.loads(r) for r in
                                             distinct], "ok": not tri_bad})
    check(tri_rows, "no compiled Triton kernel found in the JIT caches")
    check(not tri_bad, f"Triton footprints below the compiled kernels' "
                       f"request: {tri_bad}")

    # the drift report, modeled roofline against measured, per group
    for label, raw, shapes in (
            ("AXPYDOT", AXPYDOT_SPEC, {"v": N, "w": N, "u": N}),
            ("CG_MATVEC", solver_specs.CG_MATVEC, {"A": (N2, N2), "p": N2}),
            ("CG_LOOP", solver_specs.CG_LOOP,
             {"A": (N2, N2), "b": N2, "x0": N2})):
        drift = blas.compile(raw, device="cuda").profile(shapes, iters=10)
        doc = drift.to_json()
        emit({"phase": "profile", "program": label, **doc})
        check(all(g["measured_us"] is not None for g in doc["groups"]),
              f"profile {label}: a group was not measured")
    del P64, Q64, QMAG
    return kernels, launches, smi, counted_run


if __name__ == "__main__":
    sys.exit(main())
