#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one GPU: ``python3 chip_smoke.py``.

Run from the repository root on a machine with a CUDA card. Phases (any
failure exits non-zero and prints no result line):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build all seventeen hand kernels (thirteen libraries) from
   ``tpu_mpi_tests_torch/kernels/csrc`` (``nvcc`` for ``sm_90a``, one
   process per source, in parallel), and print the registers, stack and
   spills of every flash and fused ring attention instance, of every
   ring collective instance, of every ring halo and one-shot instance,
   of every pack/unpack instance, of every streaming-kernel instance, of
   every iterate and fused RDMA instance and of every heat and derivative
   instance (the seven ``PTXAS`` lines; no instance of the k-step
   kernels' regs route may spill, nor a regs instance of the heat update
   or the derivative that the main path launches);
3. hold each kernel against its plain PyTorch version on the card: the
   k-step iterate on both routes (``check_iterate_routes``: ``regs`` on
   rows that start on 8 bytes up to 8 steps, in 16-byte vectors where
   they start on 16, ``smem`` otherwise) over float32/bfloat16/float64 ×
   dim 0/1 × steps 1-9 and 12 × static flags (0,0)/(1,1)/(1,0)/(0,1) and
   dynamic flags × shapes ragged against the smem tiles and the regs run,
   strip and segment, on rows of 16 and of 8 bytes, and views one element
   and 8 bytes off 16 bytes, each launch counted on its route; and every
   operand the main path gives it (the bench's f32 blocks and bf16
   buffer, the driver's periodic iterate blocks), each on regs; the
   derivative on both routes (``check_deriv_routes``: ``regs`` where every
   row of z and out starts on 16 or 8 bytes, ``scalar`` on views 4 bytes
   off and odd widths) over float32/bfloat16/float64 × dim 0/1 × 9 and
   1000 output rows, and its main-path shapes, on regs; the heat update
   on both routes (``check_heat_routes``: ``regs`` up to 8 steps on rows
   on 16, 8 and 4 bytes, ``smem`` at 9 steps and on bfloat16 rows off 4)
   over float32/bfloat16/float64 × steps 1..9 × widths ragged against the
   warp segment at 150 rows, 68×52, 1000×777, 5×20, 3×3 and views 4 bytes
   off, each launch of both kernels counted on its route, the heat runner
   (exchange + kernel) against its torch tier at ghost width 1 and 4, and
   every heat operand of the main path, on regs: the driver's (8200² at
   k=4 in float32 and bfloat16, 8194² at k=1) and every instance
   microbench ``heat``, ``roofline2`` and ``roofline2`` large launch, at
   its own shape (``heat_main_operands``: k = 1..8 at 2050²-2064² and
   8196²-8208², rows on 16, 8 and 4 bytes, the inner warp walk); the
   dual step over the three
   dtypes × ragged shapes and its operand (8196² float32); the 2-D grids'
   operands over ranks (``check_grid_blocks``): pack and unpack along
   axis 1 at the grid's band widths (n_bnd 1, 2, 4, 8 on the (8192 +
   2k)² heat blocks and 2 on 8196², float32 and bfloat16; f32 k=1 on
   scalar, f32 k=4 on vec16, bf16 k=4 on vec8), and each rank's block
   of the strong-scaled 2x2 grid (4096 + 2k)² and 4100² cut from the
   1x1 field with the ghosts the exchange delivers, ``heat2d`` at the
   three heat runs and ``dual_dim_step`` in float32 and bfloat16, each
   launch on its route, against the plain version and, in the interior,
   the 1x1 result's window, bit for bit. Tolerance: 0 —
   bit-exact in every dtype. The kernels round after every op exactly
   where the eager PyTorch ops round (float32/float64: one IEEE op each,
   no FMA contraction; bfloat16: each op in float32, rounded to bf16),
   so any difference is a fault. The one exception is the dual step's
   residual, a deterministic sum in another order than torch's, held to
   ``hand.RESIDUAL_RTOL`` (relative). The streaming kernels (daxpy,
   scale, sum3) over float32/float64/bfloat16 × n 1, 127, 1000003 and
   the edges of a vec16 group (one pack, a group ± 1 pack, two groups ±
   1 element) on the vec16 route, and one view 4 bytes
   off 16 on the scalar route, × a 2, 1e-7, 1+1e-9 × out of place and in
   place, each launch counted on its route, and at the microbench's
   operands (2^26 and 2^28 float32, vec16), tolerance 0.
   The flash-attention fold (``check_flash_kernel``) over float32/bf16 ×
   L 1..1024 × Lk 1..300 × d 4..256 × dense and causal (partly masked,
   fully masked, fully live, stride 4) × HIGHEST/DEFAULT, a chain of two
   folds, the (L, H, d) layout in one launch, the wgmma route (bf16
   DEFAULT, d <= 128) at L 1, 7, 65, 8191 × d 64 and 128 × dense,
   self-causal, offset, striped and fully masked, and (L, 4, d) with the
   heads inside and outside the rows, each of its launches counted on
   that route, and the main path's operands: HIGHEST holds the carry to
   FLASH_RTOL/FLASH_ATOL, DEFAULT the normalised output to
   FLASH_DEFAULT_ATOL of the plain version at HIGHEST (sums in another
   order, tensor-core operands rounded) and a bf16 (L, H, d) output to
   that plus half a bf16 ulp of its largest value (its own rounding,
   against the plain output in float32), the largest error of each class
   printed. The ALU probe
   (``check_probe_kernel``) over its eight mixes × float32/bfloat16 ×
   (8, 128), (16, 128), (37, 200), (512, 512), a (3, 70, 130) stack and
   the main path's (B, 512, 512) stack × reps 1, 3, 64 × ``se`` 1e-9 and
   0.05, and blocks on clusters of 2 to 16 CTAs and on the l2 route
   (``PROBE_ROUTE_SHAPES``) × reps 1, 3: ``fma``, ``step5*`` and
   ``heat5`` bit-exact; the two dual mixes, which feed a sum taken in
   another order back into every element, within
   ``hand.alu_probe_tolerance`` (2·reps·(eps·max|z| + rtol·max|shift|));
   the chain property ``probe(probe(z, r1), r2) == probe(z, r1 + r2)``
   bit for bit in every mix on both routes; every launch counted on the
   route ``hand.probe_route`` names, both routes launched; the capacity
   guard raising. Pack and unpack
   (``check_pack_kernels``) over both axes × three dtypes × ``n_bnd`` 1,
   2, 3, 8 × ragged shapes (odd widths, one and two rows along axis 1,
   views one element off 16 bytes), so that both kernels launch on every
   route (``vec16``, ``vec8``, ``scalar``), the round trip, and the
   staged exchange's operands (1028 × 524288 axis 0, 524288 × 1028 axis
   1, 8192 × 8196 axis 1), tolerance 0. The dual step's lean body over
   the shapes the raw one has (derivatives bit-exact, residual within
   ``hand.RESIDUAL_RTOL``). The two RDMA ring kernels on the self-ring
   (``check_ring_kernels``): ``ring_halo`` over float32/bfloat16/float64
   × axis 0 (45 and 48 columns), axis 1 and a 1-D column × n_bnd 1..8 ×
   periodic and not × an extent under 3·n_bnd, 96 and 97, three chained
   calls each, so that both routes launch (``vec16``, ``scalar``), the
   main path's operands each on its route, and w = 2 and 4 cross-wired
   instances against the plain world; the fused kernel against the chained tier
   (``ring_halo`` → ``stencil2d_iterate``) over 21 chained calls (the
   epoch counters advance) × steps 1, 4, 8 and 9 × the periodic
   self-ring and ``local_only`` × float32/bfloat16 × rows on 16 bytes
   (regs), on 8 and off 8 (smem) × 1 to 10 row blocks, and against its plain
   version at those and the bench's operands (each on regs), and w = 2
   and 4 cross-wired fused instances with the sends on vec16, scalar and
   staged against the plain world; tolerance 0.
   The three collective kernels (``check_coll_kernels``): the ring
   all-gather and the ring reduce-scatter (credits 1 and 2) at world=1
   and on the self-ring k = 2, 4, 8, the one-shot gather and sum at
   world=1, over float32/bfloat16/float64 × 1-D and 2-D shards of
   1001·k rows and a 7-element one-shot (sizes no TPU tile admits) and
   of 1024·k rows, so that all three kernels launch on both routes
   (``vec16``, ``scalar``), and the main paths' operands, each on the
   ``vec16`` route; then w = 2 and 4 (and 8 for the one-shot kernel)
   instances of each kernel launched from this one process on their own
   streams, their peer pointers cross-wired, against the plain versions'
   world computed on the CPU; tolerance 0. The fused ring attention
   (``check_fused_ring_kernel``) over float32/bfloat16 × HIGHEST/DEFAULT
   × {dense, causal, causal striped} at world=1 and on the self-ring k =
   2, 4, 8 at (333, 17) and (1000, 128), as w = 2 and 4 cross-wired
   instances at (500, 64) a rank, and at the main path's (8192, 128):
   every case bit for bit the pipelined tier's flash launches (the same
   tile body, ``csrc/flash_fold.cuh``), and within the flash kernel's
   tolerances of its plain version (the ring's hops done by indexing);
   every fused launch counted on the route its operands take;
4. the main path, seven paths in turn, each with every launch count set
   to 0 just before it and read just after (and its peak device memory
   read): the headline bench (``tpu_mpi_tests_torch.bench``) at n=8192
   at the card's priors with no schedule cache (``tune/priors.py``: the
   dim-1 single buffer at k=8 in float32, then in bfloat16; the schedule
   checked against the table), the ``stencil2d`` driver with ``--kernel hand``
   at the reference sizes (n_local 1024, n_other 524288) plus its
   iterate leg (``--iterate-tier blocks --iterate-steps 4``), the
   ``heat2d`` driver with ``--kernel hand --mesh 1,1`` at 8192² for 200
   steps (``--halo-steps 4`` float32, ``--halo-steps 1`` float32,
   ``--halo-steps 4`` bfloat16), and the ``stencil2d_grid`` driver with
   ``--kernel hand --mesh 1,1`` at 8192² (20 iterations after 2 warmup).
   Every err-norm and eigen gate must pass, each path's own kernels must
   have launched, and its launches per timestep must be what its
   schedule makes (the driver's iterate leg also runs the fused ==
   chained gate and the OVERLAP probe). Then the RDMA slice
   (``run_rdma_slice``), each path alone with exact launch counts: the
   ``stencil2d`` driver with ``--rdma --kernel hand`` at the reference
   sizes, its iterate leg alone under ``rdma-chained`` and
   ``rdma-fused`` (k=4; the ``ITER BITWISE fused==chained`` and
   ``OVERLAP`` lines required), ``stencil1d --staging pallas`` at 32 Mi
   points, and the bench with ``TPU_MPI_BENCH_TIER`` ``rdma-chained``
   and ``rdma-fused`` at 8192² in float32 and bfloat16 at k=4 (one ring
   and one iterate launch, or one fused launch, per k timesteps) — the
   ``stencil2d --rdma`` path runs the driver's 1000 iterations, so its
   allreduce leg makes 2002 ring reduce-scatter launches; then the
   collective slice (``run_coll_slice``): ``gather_inplace --rdma`` at
   128 Mi float64 (one ring all-gather) and ``collbench`` over the
   library and both hand tiers at its default ladder (one kernel launch
   per chained iteration of a hand-tier row, every row measured); every
   ring collective and one-shot launch of these paths on the ``vec16``
   route, and every ring halo launch of the RDMA slice on its operand's
   route, counted exactly per path, and every k-step, heat and
   derivative launch of every path (``stencil2d_iterate``,
   ``stencil2d_fused_rdma``, ``heat2d``, ``stencil2d_deriv``) on the regs
   route, counted exactly per path; then
   the world=2 legs: two ranks on one card are left out (the symmetric-memory
   allocator refuses them, a line says so) and the NCCL leg runs only
   where ``torch.cuda.device_count() > 1`` (a line says when it did not);
   its ``grid`` part runs the 1x2 and 2x1 grids at world 2 and, where
   there are four cards, the 2x2 grid at world 4 (``_nccl_grid``: the
   heat runner and the grid step with ``kernel="hand"``, 8192² a rank,
   equal to rank 0's 1x1 run bit for bit, launches exact per rank; then
   the heat and grid pipelines at depth 1 and 2, equal bit for bit on
   every rank and within JAX's tolerances of rank 0's 1x1 run).
   Then the DAXPY slice, each path alone in the same
   way: the microbench groups ``daxpy``, ``ceiling`` and ``streams``
   (each must launch exactly the streaming kernels its schedule makes,
   every launch on the vec16 route, and every GB/s row must be finite
   and at most 1.05 × 3350; so must ``roofline2``'s ceiling fit), and the
   five DAXPY drivers at the reference's sizes with every gate passing
   and no hand kernel launched (the JAX drivers reach no Pallas kernel).
   Then the attention slice, each path alone: ``attnbench`` at L=8192,
   d=128 over the tiers xla, flash, ring, ulysses in float32, causal and
   bfloat16 ``--fast``, and the striped causal ring, and the microbench
   groups ``attention`` and ``causal`` at the JAX sizes: the flash kernel
   launched once per attention call of the flash, ring and ulysses tiers
   (none in xla); and ``attnbench --tiers ring,ulysses`` under
   ``--ring-tier pipelined`` and ``fused`` in float32, bfloat16
   ``--fast`` and the striped causal layout — exactly one flash launch
   per call of each pipelined tier, one fused launch per fused ring call,
   the ``[fused]`` tag exactly on the fused rows, and every launch on
   its operands' route (bf16 ``--fast`` on wgmma, f32 HIGHEST on fma;
   microbench ``attention``'s f32 arm on mma, its bf16 arm and
   ``causal`` on wgmma) — no FAIL, every
   TFLOP/s row finite and at most 1.05 × the peak of its arithmetic (67
   f32, 495 TF32, 989 bf16). Then the one-card slice
   (``run_one_card_slice``), each path alone: the microbench groups
   ``vpu`` and ``roofline2`` at the full (512, 512) probe block and the
   JAX kernel sizes (fewer chained probe calls than
   ``python -m tpu_mpi_tests_torch.microbench`` makes, the same reps
   triples; ``roofline2`` a second time at 8192² and 4104..8200, where
   one body's device work outlasts the host's enqueue time), then
   ``stencil``, ``iterate``, ``splitfused``, ``blocks`` (its
   ``blocks_S2_sharded_w1`` row through a process group of one rank) and
   ``heat`` at the JAX sizes — every group launches exactly what its
   schedule makes, every rate row is finite (or NaN by its own fit gate)
   and none exceeds 1.05 × the peak of the instructions it issues (the
   probe rows: issued lone mul/add/sub per element against the card's
   issue rate, SMs × 128 lanes × the peak SM clock, bfloat16 two
   elements an instruction; every probe launch on the cluster route,
   every bfloat16 dual-step launch on the regs route and every float32
   one on smem, exactly); the
   periodic DEVICE_STAGED exchange with ``kernel="hand"`` on both axes
   (one pack and one unpack launch per exchange, each on its operand's
   route — ``vec16`` along axis 0, ``vec8`` along axis 1 — counted
   exactly, the result equal to DIRECT bit for bit); the ``stencil1d``
   driver at 32 Mi points (gate passing, no hand kernel launched). Then
   the overlap slice (``run_overlap_slice``): the three split pipelines
   of ``comm/halo.py`` at depth 1 and depth 2 — the heat pipeline on the
   periodic 8192² block in float32 and bfloat16, the grid step on 8192²,
   the 1-D Jacobi on 32 Mi points — equal bit for bit, each depth-2
   runner's exchanges on its comm stream, and each within JAX's
   tolerances of its fused serial body (``OVERLAP_TOL``; the largest
   error printed); ``iterate_overlap_fn`` equal to ``iterate_hand_fn``
   (tolerance 0) at the bench's 8192 × 8196 f32 and bf16 buffers, every
   iterate launch on ``regs``; the engine refusing the RDMA ring's
   staging; ``heat2d --overlap 2 --kernel torch``, ``stencil2d_grid
   --overlap 2 --kernel torch`` and ``stencil1d --overlap 2``, each a
   path with its gate passing and no hand kernel launched, and the bench
   under ``TPU_MPI_BENCH_OVERLAP=2 TPU_MPI_BENCH_STEPS=1`` (schedule
   ``_ov2``, one iterate launch a chained call, every one on ``regs``,
   exact); then ``torch.profiler`` traces of four heat bodies at 8192²
   at depth 2 and 1, in the steady state and each body posted behind a
   ~2 ms spin kernel on the compute stream: the device time in which
   kernels of two streams ran at once must be exactly 0 at depth 1 and
   above 0 at depth 2 behind the spin (the steady state's is printed).
   Then the tune slice (``run_tune_slice``, the schedule plane): the
   ``stencil2d`` driver at the reference sizes with ``--kernel auto
   --iterate-tier auto --tune`` (every tier candidate measured on the
   card or declined with its reason, the winner stored), again on that
   cache without ``--tune`` (a cache hit, no sweep, launches exact), the
   explicit winner and a ``--tune-pack`` run of the packed cache (the
   iterate field equal bit for bit in all four, ``iterate_gate``); the
   bench at 8192² in float32 and bfloat16 under ``TPU_MPI_BENCH_TUNE=1``
   on a fresh cache (its state equal bit for bit to the explicit
   schedule's, the cache then serving the winner); ``stencil1d
   --staging auto --tune`` at 32 Mi; ``heat2d --kernel auto --overlap
   auto`` at 8192² (launches exact); ``stencil2d --fused --debug-dump``
   and ``--managed --kernel hand`` at the reference sizes (launches
   exact). The world=2 legs' ``tune`` part (and world 4 on four cards)
   runs ``stencil2d --iterate-tier auto --tune`` over the ranks
   (``_nccl_tune``). Then the instrument slice
   (``run_instrument_slice``): ``collbench --collectives auto --tune``
   at the ladder (every variant measured or declined, then all cache
   hits, the explicit winners' rows the auto rows), ``attnbench --tune``
   at 8192×128 in bf16 ``--fast`` and f32 (the tuned ring bit for bit the
   explicit winner's), ``daxpy --iters 64 --tune`` at 2^26 (the same
   ``SUM``), ``stencil2d --rdma`` at the reference sizes with
   ``--telemetry --memwatch --jsonl --trace-out --deadline``, with
   ``--telemetry --jsonl`` alone and with ``--debug-nans`` (each
   launching exactly what the flagless run does; the records, the
   trace, and the ITER exchange means of the three on a ``SPAN_PRICE``
   line), a NaN stopping ``stencil2d_iterate`` and ``halo_exchange``,
   and a watchdog child hung on spin kernels (exit 9, the dump without
   a synchronize); the world=2 ``coll_tune`` leg runs ``collbench
   --collectives auto --tune`` over two cards (``_nccl_coll_tune``) and
   ``attnbench --tiers ring --tune``, where a ring depth above 1 runs
   (``_nccl_ring_tune``: the ring through the cache bit for bit the
   explicit winner's and depth 1's and 2's). Then the serving slice
   (``run_serving_slice``), bf16 at published widths: ``moe --tokens
   8192 --d-model 4096 --tune`` (Mixtral 8x7B's hidden width) and
   ``embedding --vocab 128256 --d-model 4096 --tune`` (Llama 3 8B's
   table), each exact against its dense reference and launching no hand
   kernel; ``decode --heads 8192 --batches 1,8,32 --tune`` (Llama 3
   70B's hidden width) on a fresh cache, again as all cache hits, and
   on a cache holding ring and one-shot winners, the ring all-gather,
   ring reduce-scatter and one-shot launches of each run exact on vec16,
   each seeded row's collective and chain held against the host and the
   library tier (the kernels' decode shards are among the collective
   checks' main-path operands too, and timed);
   the last run again with ``--metrics-port 0 --jsonl`` (the heartbeat
   trail, the progress records, ``/metrics`` scraped while it runs, and
   launches and routes exactly the disarmed run's). Then serving mode
   (``run_serve_slice``): ``drivers/serve.py`` over the seven classes at
   those widths (``SERVE_TABLE``), open-loop Poisson at 200 req/s on a
   cache that sends the halo class through ``ring_halo`` and the decode
   class through ``oneshot`` (every class err=0, the launches exactly one
   a request plus the warm call, on their routes; the halo field and the
   decode buffer bit for bit their plain versions'), again with no cache
   (no hand launch), a recorded run replayed under the same fingerprint
   and per-class arrivals, 20 re-tune swaps of the decode handler (each
   re-sweep's and next batch's launches exact, allocated memory within
   one workspace) and a closed loop at concurrency 8 (``SERVE_ROWS``).
   Then the chaos slice (``run_chaos_slice``): faults armed by
   ``--chaos`` in subprocess legs, each leg's exit code, ``kind:
   "chaos"`` audit records and organic records checked and its JSONL and
   output kept under ``chiprun_out/chaos/`` for the JAX ``tpumt-doctor``:
   a wedged ``ring_halo`` exchange in stencil1d 32 Mi ended by the
   watchdog (exit 9, its dump the JSONL's tail), OOM ramps of the daxpy
   spec to an explicit 48 MB (at 2^20) and to 0.8 of the card's own
   limit (at 2^26)
   (exit 134, the allocator's ``bytes_in_use`` climbing), a shed storm
   and a queue ramp through ``drivers/serve.py`` (the ramp recorded and
   replayed disarmed), and kill and straggler at world 2 as two processes
   on this card (``CHAOS_LEGS``); the flash fold at ``stripebalance``'s
   cells against its plain version, the resident blocks through a
   process group of one rank bit for bit the group-less run, and
   microbench ``stripebalance`` in float32 (``fma``) and bfloat16
   (``wgmma``) as main paths (flash launches exact, on their routes);
5. time each kernel at its main-path shapes with CUDA events (warmed),
   beside its plain version, its one-call PyTorch yardstick where one
   exists (``F.conv2d``, TF32 off: for the derivative, for one heat step
   a 3×3 five-point weight, and for the dual step a (2,1,5,5)
   cross-shaped weight giving both derivatives but not the residual; none
   for the k-step updates) and its bound: the larger of bytes moved (each
   input read once, each output written once) over 3.35 TB/s and flops
   over 67 TFLOP/s (H100 SXM float32 outside the tensor cores; bf16
   arithmetic runs in float32 units) — for the heat update and the
   derivative their lone mul/add/sub over the card's issue rate, bfloat16
   two elements an instruction. The heat update at the driver's three
   operands and at 2064² k=8 in float32 and bfloat16, the derivative at
   the stencil2d driver's operands (and in bfloat16 along dim 0) and at
   microbench ``stencil``'s 1028×8192, back to back and queued, each with
   its route and vector, and at a rank's block of the strong-scaled 2x2
   grid (the dual step too). The iterate at
   the bench's f32 block and bf16 buffer, the driver's block,
   ``rdma-chained``'s f32 dim-1 buffer and microbench ``iterate``'s bf16
   k = 1 field (8-byte rows), back to back and queued, each with its
   route and vector. The streaming
   kernels are timed in place at 2^26 (and daxpy at 2^24 and 2^28)
   float32, back to back and queued behind a stall, beside
   ``y.add_(x, alpha=a)`` and ``x.mul_(a)`` timed both ways; the daxpy
   row also carries ``dispatch_rate``'s host-clock time of the same
   launch, and the ``HBM_CEILING`` line the queued times' two-point fit
   beside the microbench's. The flash
   fold at (8192, 128) f32 HIGHEST dense and causal, bf16 DEFAULT, and
   (32768, 128) bf16 DEFAULT causal, timed with CUDA events and queued
   behind a stall (the wrapper's host time out), beside its plain
   version, its flop bound over the peak of its arithmetic, and
   ``F.scaled_dot_product_attention`` (TF32 off for f32). The probe at
   (B, 512, 512) per mix, its per-rep cost as the slope between two reps
   counts, queued (bound: issued lone operations over the card's issue
   rate, ``hand.probe_bound_s``; no library call computes it); pack and unpack at the staged exchange's
   operands on their routes beside ``torch.stack`` of the two
   ``narrow``s and two ``copy_`` (bound: bytes, the strided side counted
   as the union of the 32-byte sectors it touches; timed with their
   launches queued behind a stall, since they
   are shorter than their wrappers' host cost), and along axis 1 at the
   grid's band widths (the heat runs' blocks); the lean dual step
   beside the raw one's yardstick; ``ring_halo`` at the ``--rdma``
   driver's dim-0 operand, the bench's chained dim-1 buffer and the
   driver's dim-1 operand (the scalar route) on the periodic self-ring
   (queued; bound: both bands read and written once,
   the strided side in 32-byte sectors; yardstick: the torch exchange's
   two ``copy_``), the fused kernel at the bench's dim-0 buffer, its
   compute-only instance and the periodic self-ring, beside the chained
   pair (bound: the iterate kernel's bytes; no library call); the
   collective kernels at a 16 MiB float32 shard on the 4-step self-ring
   (all-gather; reduce-scatter at credits 1 and 2) and the world=1
   one-shot (gather and sum), then at the main paths' world=1 operands,
   beside ``torch.tile``, ``x.view(k, -1).sum(0)`` and ``x.clone()``
   (bound: the shard read once and the output written once); the fused
   ring attention at (8192, 128) at world=1 and on the self-ring k = 4
   beside its plain version, the pipelined tier's flash launches (both
   also queued), its flop bound (live pairs of this run's masks) and
   ``F.scaled_dot_product_attention`` where one call computes the same
   function (K/V tiled k times on the dense self-ring);
6. print the card line, the ``kernels`` JSON line and, last, the device
   JSON line.
"""

from __future__ import annotations

import contextlib
import io
import itertools
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, published, at 700 W
F32_FLOPS_PER_S = 67e12    # H100 SXM float32 outside the tensor cores
TOLERANCE = 0.0            # bit-exact, see the module docstring
ITERATE_SOURCE = "tpu_mpi_tests_torch/kernels/csrc/stencil_iterate.cu"
DERIV_SOURCE = "tpu_mpi_tests_torch/kernels/csrc/stencil_deriv.cu"
HEAT_SOURCE = "tpu_mpi_tests_torch/kernels/csrc/heat2d.cu"
DUAL_SOURCE = "tpu_mpi_tests_torch/kernels/csrc/dual_dim_step.cu"
ITERATE_REPLACES = "tpu_mpi_tests/kernels/pallas_kernels.py:1177"
DERIV_REPLACES = "tpu_mpi_tests/kernels/pallas_kernels.py:636"
HEAT_REPLACES = "tpu_mpi_tests/kernels/pallas_kernels.py:1448"
DUAL_REPLACES = "tpu_mpi_tests/kernels/pallas_kernels.py:1624"
REF_N_LOCAL, REF_N_OTHER = 1024, 512 * 1024  # the driver's defaults
BENCH_N = 8192  # the headline domain
# the bench's own defaults, set explicitly so its timesteps are known
BENCH_ITERS_SHORT, BENCH_ITERS_LONG, BENCH_SAMPLES = 100, 2100, 5
DRIVER_N_ITER, DRIVER_N_WARMUP, DRIVER_ITERATE_ITERS = 5, 2, 4
K4 = 2 * 4     # ghost width of the k=4 schedules
BENCH_SE = 1e-6 * BENCH_N / 8.0  # the bench's eps × scale
DRIVER_SE = 0.01                 # the driver's iterate-leg scale_eps
GRID_N = 8192                    # the 2-D grid paths' local extent
HEAT_N_STEPS = 200               # the heat driver's default step count
HEAT_RUNS = (("float32", 4), ("float32", 1), ("bfloat16", 4))
# the 2-D grids over ranks: weak-scaled, each rank holds the one-card
# block; strong-scaled, GRID_N² split over the 2x2 grid, GRID_HALF² a rank
GRID_HALF = GRID_N // 2
# pack and unpack along axis 1 at the grid's band widths: (shape, n_bnd,
# dtype, path) — the heat blocks ghosted n_bnd = k deep and the
# stencil2d_grid block (n_bnd 2), float32 and bfloat16
GRID_BANDS = tuple(
    [((GRID_N + 2 * k,) * 2, k, dt, f"heat2d k={k}")
     for dt in ("float32", "bfloat16") for k in (1, 2, 4, 8)]
    + [((GRID_N + 4,) * 2, 2, dt, "stencil2d_grid")
       for dt in ("float32", "bfloat16")])
# the routes of the heat runs' bands (hand.pack_route): a 4-byte band a
# row is scalar, 16 bytes vec16, 8 bytes vec8
GRID_BAND_ROUTES = {("float32", 1): "scalar", ("float32", 4): "vec16",
                    ("bfloat16", 4): "vec8"}
# the grid leg's outer bodies a heat run and steps a grid-step run
GRID_LEG_BODIES = 3
STENCIL_MB_SHAPE = (1028, 8192)  # microbench stencil's field
GRID_N_ITER, GRID_N_WARMUP = 20, 2
GRID_SCALE = GRID_N / 8.0        # dz scale of the grid driver (Domain1D)
STREAMS_SOURCE = "tpu_mpi_tests_torch/kernels/csrc/streams.cu"
STREAM_REPLACES = {
    "daxpy": "tpu_mpi_tests/kernels/pallas_kernels.py:84",
    "stream_scale": "tpu_mpi_tests/kernels/pallas_kernels.py:144",
    "stream_sum3": "tpu_mpi_tests/kernels/pallas_kernels.py:190",
}
STREAM_KERNELS = tuple(STREAM_REPLACES)
#: the functor of each streaming kernel in csrc/streams.cu's instances
STREAM_FUNCTORS = {"daxpy": "Daxpy", "stream_scale": "Scale",
              "stream_sum3": "Sum3"}
GBPS_CAP = 1.05 * HBM_BYTES_PER_S / 1e9  # a faster row is a timing bug
FLASH_SOURCE = "tpu_mpi_tests_torch/kernels/csrc/flash_attention.cu"
FLASH_REPLACES = "tpu_mpi_tests/kernels/pallas_kernels.py:3230"
FLASH_ALSO_REPLACES = "tpu_mpi_tests/kernels/pallas_kernels.py:3416"
# H100 SXM dense peaks (published, 700 W) of each arithmetic the
# attention paths run: f32 on the CUDA cores (HIGHEST), TF32 and bf16 on
# the tensor cores (DEFAULT); a TFLOP/s row above 1.05x its peak is a
# timing bug
PEAK_FLOPS = {"f32": F32_FLOPS_PER_S, "tf32": 495e12, "bf16": 989e12}
# kernel vs plain: f32 arithmetic (HIGHEST, either operand dtype) holds
# the carry to rtol/atol 1e-5 (dot products and sums in another order) —
# acc's atol times its row's weight l where l > 1: acc = Σ p·v sums up to
# Lk terms of size p·|v|, so two summation orders differ by ~eps·l·|v|
# where the terms cancel (at 8192×128: 3e-4 on acc, 4e-7 on acc/l);
# the tensor-core route (DEFAULT) holds the normalised output acc/l to an
# absolute 8e-3 (bf16: P rounded to bf16) and 5e-3 (TF32 operands) of
# the plain version at HIGHEST
FLASH_RTOL = FLASH_ATOL = 1e-5
FLASH_DEFAULT_ATOL = {"bfloat16": 8e-3, "float32": 5e-3}
ATTN_L, ATTN_D, ATTN_L_LONG = 8192, 128, 32768
ATTN_N_ITER = 110
# attnbench paths: (path, extra argv, flash-kernel tiers); every
# flash-kernel tier chains 3 warm + n_iter/10 + n_iter calls, one launch
# each (the ring at world=1 makes one step per call), the xla tier none
_ATTN_ARGV = ["--seq-len", str(ATTN_L), "--head-dim", str(ATTN_D),
              "--n-iter", str(ATTN_N_ITER)]
ATTN_CALLS = 3 + ATTN_N_ITER // 10 + ATTN_N_ITER
ATTNBENCH_PATHS = (
    ("attnbench float32", ["--tiers", "xla,flash,ring,ulysses"], 3),
    ("attnbench float32 causal",
     ["--tiers", "xla,flash,ring,ulysses", "--causal"], 3),
    ("attnbench bfloat16 fast", ["--tiers", "xla,flash,ring,ulysses",
                                 "--dtype", "bfloat16", "--fast"], 3),
    ("attnbench ring causal stripe",
     ["--tiers", "ring", "--causal", "--stripe"], 1),
)
# the ring over ranks' paths: ring and ulysses under each rotation tier,
# f32 HIGHEST, bf16 --fast and the striped causal f32 layout; the
# pipelined ring makes one flash launch per call (a ring of one), the
# fused one one fused launch per call; ulysses one flash launch per call
ATTN_RING_CONFIGS = (("float32", []), ("bfloat16 fast",
                                       ["--dtype", "bfloat16", "--fast"]),
                     ("float32 causal stripe", ["--causal", "--stripe"]))
ATTN_RING_PATHS = tuple(
    (f"attnbench ring,ulysses {tier} {name}",
     ["--tiers", "ring,ulysses", "--ring-tier", tier] + extra,
     {"flash_attention_block": (2 if tier == "pipelined" else 1) * ATTN_CALLS,
      "fused_ring_attention": (tier == "fused") * ATTN_CALLS})
    for tier in ("pipelined", "fused") for name, extra in ATTN_RING_CONFIGS)
FRA_SOURCE = "tpu_mpi_tests_torch/kernels/csrc/fused_ring_attention.cu"
FRA_REPLACES = "tpu_mpi_tests/kernels/collectives_pallas.py:529"
FRA_ALSO_REPLACES = ("tpu_mpi_tests/kernels/collectives_pallas.py:376 "
                     "(kernel body), :361 (fused_ring_feasible)")
# the attention microbench groups: attention = 2 dtypes x one chained
# flash arm of 3 + 100 + 1100 calls; causal = 5 arms per size of 3 +
# iters/10 + iters calls, iters = 800 at L=8192 and 200 at L=32768
ATTN_MICROBENCH_LAUNCHES = {
    "attention": 2 * (3 + 100 + 1100),
    "causal": 5 * (3 + 80 + 800) + 5 * (3 + 20 + 200),
}
# their routes: attention's float32 arm on TF32 mma.sync, its bf16 arm
# and every causal arm (bf16) on wgmma
ATTN_MICROBENCH_ROUTES = {
    "attention": {"mma": 3 + 100 + 1100, "wgmma": 3 + 100 + 1100},
    "causal": {"wgmma": ATTN_MICROBENCH_LAUNCHES["causal"]},
}
PROBE_SOURCE = "tpu_mpi_tests_torch/kernels/csrc/alu_probe.cu"
PROBE_REPLACES = "tpu_mpi_tests/kernels/pallas_kernels.py:469"
PACK_SOURCE = "tpu_mpi_tests_torch/kernels/csrc/pack.cu"
PACK_REPLACES = {
    "pack_edges": "tpu_mpi_tests/kernels/pallas_kernels.py:2772",
    "unpack_ghosts": "tpu_mpi_tests/kernels/pallas_kernels.py:2803",
}
PROBE_HW = 512                   # the probe block of the vpu/roofline2 groups
PROBE_SE_VISIBLE = 0.05          # an update scale the arithmetic shows at
# chained probe calls per timing point in this script (the microbench's
# own default is 400); the reps triples are the groups' own
SMOKE_PROBE_ITERS = 40
# the probe's route cases: (shape, dtype, route) — blocks on clusters of
# 2, 4, 8 and 16 CTAs, ragged against the slab and the vector, and blocks
# no cluster's shared memory holds
PROBE_ROUTE_SHAPES = (((1000, 40), "float32", "cluster"),
                      ((997, 100), "float32", "cluster"),
                      ((250, 520), "float32", "cluster"),
                      ((515, 500), "float32", "cluster"),
                      ((1023, 130), "bfloat16", "cluster"),
                      ((300, 2000), "bfloat16", "cluster"),
                      ((700, 1000), "float32", "l2"),
                      ((2, 1030, 1024), "bfloat16", "l2"))
SECTOR = 32                      # bytes the card moves per touched sector
# the staged exchange's operands: (shape, axis) — the stencil2d driver's
# two decompositions and the splitfused group's periodic field
STAGED_CASES = (((REF_N_LOCAL + 4, REF_N_OTHER), 0),
                ((REF_N_OTHER, REF_N_LOCAL + 4), 1),
                ((BENCH_N, BENCH_N + 4), 1))
STAGED_EXCHANGES = 20
# the route each staged operand's pack and unpack take (hand.pack_route):
# whole 16-byte vectors along axis 0; an 8-byte band a row along axis 1
STAGED_ROUTES = {0: "vec16", 1: "vec8"}
# roofline2 a second time at sizes whose per-body device work outlasts the
# host's enqueue time on this card (the JAX sizes, 2048^2 and 2056..4104,
# are host-bound in a Python loop of launches); same size ratios, so the
# same chain lengths
ROOFLINE_LARGE = {"n": GRID_N, "sizes": (4104, 5800, 8200)}
STENCIL1D_N = 32 * 1024 * 1024   # the 1-D driver's default size
RING_SOURCE = "tpu_mpi_tests_torch/kernels/csrc/ring_halo.cu"
RING_REPLACES = "tpu_mpi_tests/kernels/pallas_kernels.py:1804"
FUSED_SOURCE = "tpu_mpi_tests_torch/kernels/csrc/fused_rdma.cu"
FUSED_REPLACES = "tpu_mpi_tests/kernels/pallas_kernels.py:2090"
RING_CHAIN = 21  # chained ring calls per fused-vs-chained case
# ring_halo's main-path operands: (shape, axis, n_bnd, dtype, route,
# leg) — the stencil2d --rdma legs (dim 0 and dim 1; the dim-1 band is 8
# bytes a row: scalar), the driver's iterate leg at k=4, the bench's
# chained dim-1 buffer at k=4 and stencil1d's (n, 1) column; every buffer
# a fresh allocation (16-byte aligned), so the route is the geometry's
RING_MAIN_PATH = (
    ((REF_N_LOCAL + 4, REF_N_OTHER), 0, 2, "float32", "vec16",
     "stencil2d --rdma dim 0"),
    ((REF_N_OTHER, REF_N_LOCAL + 4), 1, 2, "float32", "scalar",
     "stencil2d --rdma dim 1"),
    ((REF_N_LOCAL + 16, REF_N_OTHER), 0, 8, "float32", "vec16",
     "stencil2d iterate leg"),
    ((BENCH_N, BENCH_N + 16), 1, 8, "float32", "vec16",
     "bench rdma-chained float32"),
    ((BENCH_N, BENCH_N + 16), 1, 8, "bfloat16", "vec16",
     "bench rdma-chained bfloat16"),
    ((STENCIL1D_N + 4,), 0, 2, "float32", "scalar",
     "stencil1d --staging pallas"),
)
# the fused kernel's main-path operands: (shape, dtype, periodic) — the
# bench's dim-0 buffer at k=4 (world=1 non-periodic: the compute-only
# instance) and the same as a periodic self-ring, in both dtypes
FUSED_MAIN_PATH = (
    ((BENCH_N + 16, BENCH_N), "float32", False),
    ((BENCH_N + 16, BENCH_N), "float32", True),
    ((BENCH_N + 16, BENCH_N), "bfloat16", False),
)
# ring_halo timed: (shape, axis, n_bnd, dtype, path)
RING_TIMED = (
    ((REF_N_LOCAL + 4, REF_N_OTHER), 0, 2, "float32", "stencil2d --rdma"),
    ((BENCH_N, BENCH_N + 16), 1, 8, "float32", "bench rdma-chained"),
    ((REF_N_OTHER, REF_N_LOCAL + 4), 1, 2, "float32",
     "stencil2d --rdma dim 1"),
)
# the collective kernels (ring all-gather, ring reduce-scatter, one-shot)
COLL_SOURCE = "tpu_mpi_tests_torch/kernels/csrc/ring_collectives.cu"
#: the kernels of COLL_SOURCE, whose launches count per route
RING_COLLECTIVES = ("ring_allgather", "ring_reduce_scatter")
#: the collective kernels whose launches count per route
ROUTED_COLLECTIVES = RING_COLLECTIVES + ("oneshot",)
ONESHOT_SOURCE = "tpu_mpi_tests_torch/kernels/csrc/oneshot.cu"
AG_REPLACES = "tpu_mpi_tests/kernels/pallas_kernels.py:2339"
RS_REPLACES = "tpu_mpi_tests/kernels/pallas_kernels.py:2576"
RS_ALSO_REPLACES = "tpu_mpi_tests/kernels/pallas_kernels.py:2717"
ONESHOT_REPLACES = "tpu_mpi_tests/kernels/collectives_pallas.py:179"
ONESHOT_ALSO_REPLACES = ("tpu_mpi_tests/kernels/collectives_pallas.py:74, "
                         ":274, :308")
#: stencil2d --rdma's timed iterations (the driver's default): its
#: allreduce leg makes 2 dims × (1 warm + 1000) reduce-scatter launches
RDMA_DRIVER_N_ITER = 1000
#: gather_inplace --rdma at the reference size: 128 Mi float64 per rank
GATHER_N = 128 * 1024 * 1024
#: collbench's tiers on the main path, at its default ladder
COLLBENCH_NAMES = ("allgather", "allreduce", "reducescatter",
                   "allgather_rdma", "allreduce_rdma", "allgather_oneshot",
                   "allreduce_oneshot")
COLLBENCH_SIZES_KIB = (4, 64, 1024, 16384)
COLLBENCH_N_ITER = 500
#: the timed operand: a 16 MiB float32 shard, on a 4-step self-ring
COLL_TIMED_N, COLL_TIMED_K = 4 * 1024 * 1024, 4
N26, N28 = 1 << 26, 1 << 28
# launches each microbench group's schedule makes (microbench.py):
# dispatch_rate = 1 warm + n_base + (n_base + n_iter) calls; chain_rate =
# 3 warm + n_short + n_long launches
_DR = {1000: 1 + 100 + 1100, 500: 1 + 50 + 550}


def _ceiling_calls():
    """Calls of each kernel in the HBM ceiling fit: one dispatch_rate per
    kernel per interleaved pair."""
    from tpu_mpi_tests_torch.microbench import CEILING_PAIRS

    return CEILING_PAIRS * _DR[1000]


def microbench_launches():
    """Launches each DAXPY-slice microbench group's schedule makes."""
    return {
        "daxpy": {"daxpy": 2 * _DR[1000] + _DR[500] + 2 * (3 + 100 + 1100),
                  "stream_scale": 0, "stream_sum3": 0},
        "ceiling": {"daxpy": _ceiling_calls(),
                    "stream_scale": _ceiling_calls(), "stream_sum3": 0},
        "streams": {"daxpy": (3 + 100 + 1000) + (3 + 30 + 300),
                    "stream_scale": 3 + 100 + 1000,
                    "stream_sum3": 3 + 100 + 1000},
    }


def _chain(n_short, n_long, repeats=1):
    """Calls one ``chain_rate`` makes: 3 warm, then the two runs."""
    return 3 + repeats * (n_short + n_long)


def _kstep_calls(short, floor, ks=(2, 4, 6, 8)):
    return sum(_chain(max(short[1], short[0] // k), max(floor, 2000 // k))
               for k in ks)


def one_card_launches():
    """Launches each one-card microbench group's schedule makes
    (microbench.py), per kernel; a kernel not named launches nothing."""
    point = _chain(max(1, SMOKE_PROBE_ITERS // 10), SMOKE_PROBE_ITERS)
    kstep = _kstep_calls((50, 5), 50)
    dual = sum(_chain(it // 10, it, repeats=2) for it in
               (max(40, 400 * 2056**2 // nn**2) for nn in (2056, 2904, 4104)))
    heat = sum(_chain(max(1, 40 // k), max(max(1, 40 // k) + 1, 2000 // k))
               for k in (1, 4, 8))
    return {
        # 3 mixes x 2 dtypes x 3 reps values; S=2 blocks f32 + bf16 dim 1
        "vpu": {"alu_probe": 18 * point, "stencil2d_iterate": 3 * kstep},
        # the ceiling fit, 3 mixes x 2 dtypes x 3 reps, heat and both
        # dual bodies in 2 dtypes
        "roofline2": {"daxpy": _ceiling_calls(),
                      "stream_scale": _ceiling_calls(),
                      "alu_probe": 18 * point,
                      "heat2d": 2 * _kstep_calls((50, 2), 20),
                      "dual_dim_step": 2 * 2 * dual},
        # the same schedule at sizes that keep the card busy
        "roofline2 large": {"daxpy": _ceiling_calls(),
                            "stream_scale": _ceiling_calls(),
                            "alu_probe": 18 * point,
                            "heat2d": 2 * _kstep_calls((50, 2), 20),
                            "dual_dim_step": 2 * 2 * dual},
        "stencil": {"stencil2d_deriv": 2 * (1 + 50 + 550)},
        "iterate": {"stencil2d_iterate": 3 * _chain(100, 2100)
                    + 3 * _chain(25, 525)},
        "splitfused": {},
        # S=2 blocks, the same through a group of one rank, dim 1
        "blocks": {"stencil2d_iterate": 5 * _chain(25, 525, repeats=2)},
        "heat": {"heat2d": 2 * heat},
    }


# the DAXPY drivers at the reference's sizes: (path, module, argv, lines)
DAXPY_DRIVERS = (
    ("daxpy", "daxpy", ["--n", str(N26), "--dtype", "float64", "--iters",
                        "20"], ("0/1 SUM = ", "TIME kernel : ")),
    ("mpi_daxpy", "mpi_daxpy", ["--n-total", str(N26), "--ranks", "4",
                                "--dtype", "float64"],
     ("4 logical ranks over 1 devices", "3/4 SUM = ")),
    ("mpi_daxpy_nvtx float32", "mpi_daxpy_nvtx", ["--dtype", "float32"],
     ("0/1 ALLSUM = ", "TIME gather : ")),
    ("mpi_daxpy_nvtx float64", "mpi_daxpy_nvtx", ["--dtype", "float64"],
     ("0/1 ALLSUM = 25165824.500000", "TIME gather : ")),
    ("mpi_daxpy_nvtx managed", "mpi_daxpy_nvtx",
     ["--dtype", "float64", "--space", "managed", "--barrier"],
     ("0/1 ALLSUM = 25165824.500000", "TIME barrier : ")),
    ("gather_inplace", "gather_inplace",
     ["--n-per-rank", str(128 << 20), "--dtype", "float64"],
     ("0/1 lsum=134217728.0 asum=134217728.0",)),
    ("envprobe", "envprobe", ["--verbose"], ("0/1 MEMORY_PER_CORE=",)),
)


class SmokeFailure(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    if not out:
        raise SmokeFailure("nvidia-smi printed nothing")
    return out.splitlines()[0]


def bench_blocks_used(dtype: str) -> int:
    """The resident blocks the bench's prior schedule runs in ``dtype``
    (``tune/priors.py``): S when S >= 2 divides the domain at k > 1,
    else 0 (the dim-1 single buffer)."""
    from tpu_mpi_tests_torch.tune import priors

    S, k = priors.bench_blocks(dtype), priors.BENCH_STEPS
    return S if S >= 2 and k > 1 and BENCH_N % S == 0 else 0


def iterate_cases():
    """The iterate kernel's operands on the main path, from the schedules
    the bench's priors and the driver build: (path, shape, dtype, dim,
    flags, scale_eps, steps). Resident blocks are physical at the
    domain's outer edges (one case a flag pair); the dim-1 single buffer
    at both; the driver's iterate leg (k = 4, the prior block count)
    runs a periodic self-ring."""
    import torch

    from tpu_mpi_tests_torch.tune import priors

    k = priors.BENCH_STEPS
    cases = []
    for dtype, tdtype in (("float32", torch.float32),
                          ("bfloat16", torch.bfloat16)):
        S = bench_blocks_used(dtype)
        if S:
            shape = (BENCH_N // S + 4 * k, BENCH_N)
            cases += [(f"bench {dtype}", shape, tdtype, 0, flags, BENCH_SE,
                       k) for flags in ((1, 0), (0, 1))]
        else:
            cases.append((f"bench {dtype}", (BENCH_N, BENCH_N + 4 * k),
                          tdtype, 1, (1, 1), BENCH_SE, k))
    S = priors.bench_blocks("float32")
    rows = REF_N_LOCAL // S if S >= 2 and REF_N_LOCAL % S == 0 \
        else REF_N_LOCAL
    cases.append(("stencil2d", (rows + 2 * K4, REF_N_OTHER), torch.float32,
                  0, (0, 0), DRIVER_SE, 4))
    return cases


def heat_cases():
    """The heat update's operands on the main path: (path, shape, dtype,
    steps, cx, cy) — the driver's 8192² shard ghosted k deep on both
    axes, with the driver's own coefficients."""
    import torch

    from tpu_mpi_tests_torch.drivers import heat2d

    _, cx, cy = heat2d.coefficients(GRID_N, GRID_N, 0.1)
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    return [(f"heat2d {dt} k={k}", (GRID_N + 2 * k, GRID_N + 2 * k),
             dtypes[dt], k, cx, cy) for dt, k in HEAT_RUNS]


def heat_main_operands():
    """(path, n, dtype name, steps) of every heat instance the main path
    launches, each (n, dtype, steps) once, on the (n + 2·steps)² shard:
    the heat driver's three runs, microbench ``heat`` (k = 1, 4, 8 at
    2048²) and ``roofline2`` (k = 2, 4, 6, 8 at 2048² and
    ROOFLINE_LARGE's n)."""
    ops = [("heat2d", GRID_N, dt, k) for dt, k in HEAT_RUNS]
    ops += [("microbench heat", 2048, dt, k)
            for dt in ("float32", "bfloat16") for k in (1, 4, 8)]
    ops += [("microbench roofline2", n, dt, k)
            for n in (2048, ROOFLINE_LARGE["n"])
            for dt in ("float32", "bfloat16") for k in (2, 4, 6, 8)]
    seen, out = set(), []
    for path, n, dt, k in ops:
        if (n, dt, k) not in seen:
            seen.add((n, dt, k))
            out.append((path, n, dt, k))
    return out


def heat_microbench_cases():
    """The heat update's microbench operands (``heat_main_operands`` past
    the driver's runs) as (path, shape, dtype, steps, cx, cy): every
    regs instance the microbench launches, at its own shape, with its
    coefficients (0.05 on both axes)."""
    import torch

    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16}
    return [(f"{path} {dt} k={k}", (n + 2 * k, n + 2 * k), dtypes[dt], k,
             0.05, 0.05)
            for path, n, dt, k in heat_main_operands()
            if path != "heat2d"]


def compare(name, got, want, failures):
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        failures.append(f"{name}: shape/dtype {tuple(got.shape)} "
                        f"{got.dtype} != {tuple(want.shape)} {want.dtype}")
        return float("inf")
    diff = (got.double() - want.double()).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    same = torch.equal(got, want) or err <= TOLERANCE
    if not same or not torch.isfinite(got.double()).all():
        failures.append(f"{name}: max |kernel - plain| = {err:g} "
                        f"(tolerance {TOLERANCE:g})")
    return err


def check_kernels(device):
    """Phase 3: every kernel against its plain version on the card.
    Returns the max abs error per kernel at its main-path shapes."""
    import torch

    from tpu_mpi_tests_torch.kernels import hand

    gen = torch.Generator(device=device).manual_seed(1234)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32).to(dtype)

    failures = []
    n_cases = check_iterate_routes(device, rand, failures)
    n_cases += check_deriv_routes(device, rand, failures)

    n_cases += check_grid_kernels(device, rand, failures)
    n_stream, stream_errs = check_stream_kernels(device, gen, failures)
    n_cases += n_stream
    n_flash, flash_errs, flash_main = check_flash_kernel(device, gen,
                                                         failures)
    n_probe, probe_errs = check_probe_kernel(device, rand, failures)
    n_cases += n_probe
    n_pack, pack_errs = check_pack_kernels(device, rand, failures)
    n_cases += n_pack
    n_ring, ring_errs = check_ring_kernels(device, rand, failures)
    n_cases += n_ring
    n_coll, coll_errs = check_coll_kernels(device, rand, failures)
    n_cases += n_coll
    n_fused, fused_main, fused_classes = check_fused_ring_kernel(
        device, gen, failures)

    # the main-path shapes: the bench's f32 blocks and bf16 dim-1 buffer,
    # the driver's periodic iterate blocks, the driver's derivatives, the
    # heat paths' shards, the grid path's block
    errs = {"stencil2d_iterate": 0.0, "stencil2d_deriv": 0.0,
            "heat2d": 0.0, "dual_dim_step": 0.0,
            "dual_dim_step residual (relative)": 0.0, **stream_errs,
            **probe_errs, **pack_errs, **ring_errs, **coll_errs}
    for _, shape, dtype, dim, flags, se, k in iterate_cases():
        z = rand(shape, dtype)
        before = hand.stencil2d_iterate.launches_by_route["regs"]
        err = compare(
            f"iterate main-path {shape} {dtype} flags={flags} k={k}",
            hand.stencil2d_iterate(z, se, dim=dim, steps=k,
                                   phys_static=flags),
            hand.stencil2d_iterate_ref(z, se, dim=dim, steps=k,
                                       phys_static=flags), failures)
        errs["stencil2d_iterate"] = max(errs["stencil2d_iterate"], err)
        if hand.stencil2d_iterate.launches_by_route["regs"] != before + 1:
            failures.append(f"iterate main-path {shape} {dtype}: not "
                            f"launched on the regs route")
        n_cases += 1
        del z
    for shape, dim in (((REF_N_LOCAL + 4, REF_N_OTHER), 0),
                       ((REF_N_LOCAL, REF_N_OTHER + 4), 1)):
        z = rand(shape, torch.float32)
        before = hand.stencil2d_deriv.launches_by_route["regs"]
        err = compare(f"deriv main-path {shape} dim={dim}",
                      hand.stencil2d_deriv(z, 128.0, dim=dim),
                      hand.stencil2d_deriv_ref(z, 128.0, dim=dim),
                      failures)
        errs["stencil2d_deriv"] = max(errs["stencil2d_deriv"], err)
        if hand.stencil2d_deriv.launches_by_route["regs"] != before + 1:
            failures.append(f"deriv main-path {shape} dim={dim}: not "
                            f"launched on the regs route")
        n_cases += 1
        del z
    # the heat driver's three runs, then every instance microbench heat,
    # roofline2 and roofline2 large launch, at its own shape
    for path, shape, dtype, k, cx, cy in (heat_cases()
                                          + heat_microbench_cases()):
        z = rand(shape, dtype)
        before = hand.heat2d.launches_by_route["regs"]
        err = compare(f"heat2d main-path {path} {shape}",
                      hand.heat2d(z, cx, cy, steps=k),
                      hand.heat2d_ref(z, cx, cy, steps=k), failures)
        errs["heat2d"] = max(errs["heat2d"], err)
        if hand.heat2d.launches_by_route["regs"] != before + 1:
            failures.append(f"heat2d main-path {path}: not launched on the "
                            f"regs route")
        n_cases += 1
        del z
        torch.cuda.empty_cache()
    # the grid path's float32 block (smem), and the bfloat16 blocks
    # roofline2 and the dual step's timing row launch (regs): (GRID_N + 4)²
    # (outputs' rows on 16 bytes) and 4104² (z's rows on 16 bytes, a
    # short last thread a row)
    for n, dtype, route in ((GRID_N + 4, torch.float32, "smem"),
                            (GRID_N + 4, torch.bfloat16, "regs"),
                            (4104, torch.bfloat16, "regs")):
        z = rand((n, n), dtype)
        for lean in (False, True):
            name = (f"dual_dim_step{' lean' if lean else ''} main-path")
            before = hand.dual_dim_step.launches_by_route[route]
            err, rel = compare_dual(name, z, GRID_SCALE, GRID_SCALE,
                                    failures, lean=lean)
            if hand.dual_dim_step.launches_by_route[route] != before + 1:
                failures.append(f"{name} {n}² {dtype}: not launched on the "
                                f"{route} route")
            errs["dual_dim_step"] = max(errs["dual_dim_step"], err)
            key = (f"dual_dim_step{' lean' if lean else ''} residual "
                   f"(relative){'' if dtype == torch.float32 else ' bf16'}")
            errs[key] = max(errs.get(key, 0.0), rel)
            n_cases += 1
        del z
        torch.cuda.empty_cache()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if failures:
        raise SmokeFailure("kernel/plain mismatches:\n  "
                           + "\n  ".join(failures))
    log(f"CHECK {n_cases} kernel-vs-plain cases bit-exact (the probe's dual "
        f"mixes and the dual step's residuals within their tolerances), "
        f"{n_flash} flash cases within their tolerances, {n_fused} fused "
        f"ring attention cases bit for bit the pipelined flash launches and "
        f"within the flash tolerances of their plain version")
    errs["fused_ring_attention"] = fused_main
    errs["fused_ring_attention classes"] = fused_classes
    # the flash kernel's main-path error: the normalised output at the
    # f32 HIGHEST operand; every class beside it
    errs["flash_attention_block"] = max(
        v for k, v in flash_main.items() if "highest" in k)
    errs["flash_attention_block classes"] = flash_errs
    errs["flash_attention_block main path"] = flash_main
    return errs


def iterate_edges(dtype, dim, steps):
    """Shapes of the iterate's checks: ragged against the smem tiles
    (64×64 at dim 0, 8×256 at dim 1) and against the regs route's run
    (two runs of kRunRows rows and 37: three balanced runs), strip (a
    CTA's kRegsThreads column vectors and 3) and segment (150 vectors
    a row) in 16-byte vectors, and the same in 8-byte vectors (rows of
    1208 bytes, on 8 bytes and off 16)."""
    import torch

    item = torch.empty((), dtype=dtype).element_size()
    E = 16 // item
    K = 2 * steps
    if dim == 0:
        return ((2 * K + 150, 200), (2 * 128 + 37, (128 + 3) * E),
                (2 * 128 + 37, 1208 // item))
    return ((37, 2 * K + 600), (5, 150 * E), (5, 1208 // item))


def check_iterate_routes(device, rand, failures) -> int:
    """The iterate against its plain version on both routes, bit for
    bit: float32/bfloat16/float64 × dim 0/1 × steps 1-9 and 12 × static
    flags (0,0)/(1,1)/(1,0)/(0,1) and dynamic flags × the ragged shapes
    of :func:`iterate_edges` (steps up to 8 on rows on 8 bytes take
    regs, 9 and 12 smem), and views one element off 16 bytes (smem, but
    regs for float64) and 8 bytes off (regs); each launch counted on the
    route :func:`hand.kstep_route` names. Fails unless both routes
    launched."""
    import torch

    from tpu_mpi_tests_torch.kernels import hand

    n_cases = 0
    took0 = dict(hand.stencil2d_iterate.launches_by_route)
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        for dim in (0, 1):
            for steps in (*range(1, 10), 12):
                for shape in iterate_edges(dtype, dim, steps):
                    z = rand(shape, dtype)
                    route = hand.kstep_route(z, dim, steps)
                    for flags in ((0, 0), (1, 1), (1, 0), (0, 1),
                                  "dynamic"):
                        kw = ({"phys": torch.tensor(
                            [0, 1], dtype=torch.int32, device=device)}
                              if flags == "dynamic"
                              else {"phys_static": flags})
                        before = hand.stencil2d_iterate.launches_by_route[
                            route]
                        got = hand.stencil2d_iterate(z, 0.37, dim=dim,
                                                     steps=steps, **kw)
                        want = hand.stencil2d_iterate_ref(
                            z, 0.37, dim=dim, steps=steps, **kw)
                        name = (f"iterate {dtype} dim={dim} steps={steps} "
                                f"{shape} flags={flags} route={route}")
                        compare(name, got, want, failures)
                        if hand.stencil2d_iterate.launches_by_route[
                                route] != before + 1:
                            failures.append(f"{name}: not counted on its "
                                            f"route")
                        n_cases += 1
        item = torch.empty((), dtype=dtype).element_size()
        # one element off 16 bytes; 8 bytes off, on rows of 264 bytes
        for off, width in ((1, 129), (8 // item, 264 // item)):
            buf = rand((60 * width + off,), dtype)
            z = buf[off:].view(60, width)
            for dim in (0, 1):
                got = hand.stencil2d_iterate(z, 0.37, dim=dim, steps=4,
                                             phys_static=(1, 0))
                compare(f"iterate {dtype} dim={dim} view {off * item} "
                        f"bytes off route={hand.kstep_route(z, dim, 4)} "
                        f"vec={hand.kstep_vec_bytes(z)}", got,
                        hand.stencil2d_iterate_ref(z, 0.37, dim=dim,
                                                   steps=4,
                                                   phys_static=(1, 0)),
                        failures)
                n_cases += 1
    route_took("stencil2d_iterate", took0, failures)
    return n_cases


def compare_dual(name, z, sx, sy, failures, lean=False):
    """The dual step (its raw or its lean body) against its plain
    version: both derivatives bit-exact, the residual within
    ``hand.RESIDUAL_RTOL``. Returns (max abs error of the derivatives,
    relative error of the residual)."""
    from tpu_mpi_tests_torch.kernels import hand

    gx, gy, gr = hand.dual_dim_step(z, 2, sx, sy, lean=lean)
    wx, wy, wr = hand.dual_dim_step_ref(z, 2, sx, sy, lean=lean)
    err = max(compare(f"{name} {tuple(z.shape)} {z.dtype} dz_dx", gx, wx,
                      failures),
              compare(f"{name} {tuple(z.shape)} {z.dtype} dz_dy", gy, wy,
                      failures))
    want = float(wr)
    rel = abs(float(gr) - want) / max(abs(want), 1e-300)
    rtol = hand.RESIDUAL_RTOL[z.dtype]
    if gr.dtype != z.dtype or not rel <= rtol:
        failures.append(f"{name} {tuple(z.shape)} {z.dtype} residual: "
                        f"{float(gr)!r} vs {want!r}, relative {rel:g} "
                        f"(tolerance {rtol:g})")
    return err, rel


def offset_view(rand, shape, dtype, off_bytes):
    """A contiguous ``shape`` view of ``rand`` values ``off_bytes`` past a
    16-byte boundary."""
    import torch

    item = torch.empty((), dtype=dtype).element_size()
    n = shape[0] * shape[1]
    buf = rand((n + 64,), dtype)
    skip = (-buf.data_ptr() % 16) // item + off_bytes // item
    return buf[skip:skip + n].view(shape)


def route_took(name, took0, failures):
    """Launches of kernel ``name`` per route since ``took0`` (logged);
    a failure unless every route launched."""
    from tpu_mpi_tests_torch.kernels import hand

    now = hand.WRAPPERS[name].launches_by_route
    took = {r: now[r] - took0[r] for r in took0}
    log(f"CHECK {name} launches by route: {json.dumps(took)}")
    if min(took.values()) <= 0:
        failures.append(f"{name}: the checks did not launch every route "
                        f"({took})")


def checked_launch(name, route, run, failures):
    """``run()``, failing unless it launched ``name`` once, on ``route``."""
    from tpu_mpi_tests_torch.kernels import hand

    by_route = hand.WRAPPERS[name].launches_by_route
    before = dict(by_route)
    got = run()
    if {r: by_route[r] - before[r] for r in by_route} != {
            r: int(r == route) for r in by_route}:
        failures.append(f"{name}: a launch not counted on its route "
                        f"{route}")
    return got


#: geometry -> a row width ragged against the regs routes' segments, for
#: an element of ``item`` bytes: rows on 16, 8, 4 and 2 bytes
GEOMETRY_WIDTH = {"rows16": lambda item: 16 // item * 37,
                  "rows8": lambda item: 16 // item * 37 + 8 // item,
                  "rows4": lambda item: 16 // item * 37 + 4 // item,
                  "rows2": lambda item: 16 // item * 37 + 1}


def check_heat_routes(device, rand, failures) -> int:
    """The heat update against its plain version on both routes, bit for
    bit: float32/bfloat16/float64 × steps 1-9 × rows on 16, 8 and 4 bytes
    (regs up to 8 steps) and bfloat16 rows off 4 (smem) at 150 rows
    (ragged against the runs) and a width ragged against the warp
    segment, the tile-ragged (68, 52) and (1000, 777), a shard narrower
    than one segment (5, 20), 3×3, and views 4 bytes off 16; each launch
    counted on the route :func:`hand.heat_route` names. Fails unless both
    routes launched."""
    import torch

    from tpu_mpi_tests_torch.kernels import hand

    n_cases = 0
    took0 = dict(hand.heat2d.launches_by_route)
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        item = torch.empty((), dtype=dtype).element_size()
        widths = [GEOMETRY_WIDTH[g](item) for g in GEOMETRY_WIDTH
                  if g != "rows2" or item == 2]
        shards = ([rand((150, w), dtype) for w in widths]
                  + [rand(s, dtype) for s in ((68, 52), (1000, 777), (5, 20),
                                               (3, 3))])
        if item < 8:
            shards.append(offset_view(rand, (40, 36), dtype, 4))
        for z in shards:
            for steps in range(1, 10):
                route = hand.heat_route(z, steps)
                got = checked_launch(
                    "heat2d", route,
                    lambda: hand.heat2d(z, 0.13, 0.21, steps=steps),
                    failures)
                compare(f"heat2d {dtype} {tuple(z.shape)} steps={steps} "
                        f"vec={hand.heat_vec_bytes(z)} route={route}", got,
                        hand.heat2d_ref(z, 0.13, 0.21, steps=steps),
                        failures)
                n_cases += 1
    route_took("heat2d", took0, failures)
    return n_cases


def check_deriv_routes(device, rand, failures) -> int:
    """The derivative against its plain version on both routes, bit for
    bit: float32/bfloat16/float64 × dim 0/1 × rows of z and out on 16 and
    8 bytes (regs) and views 4 bytes off 16 and odd widths (scalar), at 9
    and 1000 output rows (ragged against the runs) and widths ragged
    against the dim-1 segment; each launch counted on the route
    :func:`hand.deriv_route` names. Fails unless both routes launched."""
    import torch

    from tpu_mpi_tests_torch.kernels import hand

    n_cases = 0
    took0 = dict(hand.stencil2d_deriv.launches_by_route)
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        item = torch.empty((), dtype=dtype).element_size()
        for dim in (0, 1):
            for rows in (9, 1000):
                for geometry in ("rows16", "rows8", "view4", "odd"):
                    width = (GEOMETRY_WIDTH["rows8"](item)
                             if geometry == "rows8"
                             else GEOMETRY_WIDTH["rows16"](item) + (
                                 1 if geometry == "odd" else 0))
                    shape = ((rows + 4, width) if dim == 0
                             else (rows, width + 4))
                    if geometry == "view4":
                        if item == 8:
                            continue
                        z = offset_view(rand, shape, dtype, 4)
                    else:
                        z = rand(shape, dtype)
                    route = hand.deriv_route(z, dim)
                    got = checked_launch(
                        "stencil2d_deriv", route,
                        lambda: hand.stencil2d_deriv(z, 3.0, dim=dim),
                        failures)
                    compare(f"deriv {dtype} dim={dim} {shape} {geometry} "
                            f"vec={hand.deriv_vec_bytes(z, dim)} "
                            f"route={route}", got,
                            hand.stencil2d_deriv_ref(z, 3.0, dim=dim),
                            failures)
                    n_cases += 1
    route_took("stencil2d_deriv", took0, failures)
    return n_cases


def check_grid_kernels(device, rand, failures) -> int:
    """The heat update on both routes (:func:`check_heat_routes`), the
    grid's operands (:func:`check_grid_blocks`), the dual step at small
    ragged shapes in every dtype, and the heat runner at ghost widths 1
    and 4. Returns the number of cases."""
    import torch

    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.kernels import hand

    n_cases = check_heat_routes(device, rand, failures)
    n_cases += check_grid_blocks(device, rand, failures)
    took0 = dict(hand.dual_dim_step.launches_by_route)
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        # ragged against the 32x128 output tile on both axes; rows on 4
        # elements (the regs route for bfloat16) and off them (smem)
        for shape in ((68, 52), (1000, 777)):
            z = rand(shape, dtype)
            compare_dual("dual_dim_step", z, 3.0, 0.5, failures)
            compare_dual("dual_dim_step lean", z, 3.0, 0.5, failures,
                         lean=True)
            n_cases += 2
    route_took("dual_dim_step", took0, failures)
    # the runner: periodic exchange on both axes + the kernel on two
    # ping-ponged buffers, against the torch tier, 3 bodies
    for n_bnd, steps in ((1, 1), (4, 1), (4, 2), (4, 3), (4, 4)):
        z = rand((100 + 2 * n_bnd, 260 + 2 * n_bnd), torch.float32)
        got = H.heat_step2d_fn(n_bnd, 0.2, 0.2, steps=steps,
                               kernel="hand")(z.clone(), 3)
        want = H.heat_step2d_fn(n_bnd, 0.2, 0.2, steps=steps,
                                kernel="torch")(z.clone(), 3)
        compare(f"heat runner n_bnd={n_bnd} steps={steps}", got, want,
                failures)
        n_cases += 1
    return n_cases


def check_grid_blocks(device, rand, failures) -> int:
    """This slice's operands on one card. Pack and unpack along axis 1 at
    the grid's band widths (:data:`GRID_BANDS`), each launch counted on
    the route ``hand.pack_route`` names (the heat runs' on
    :data:`GRID_BAND_ROUTES`), against their plain versions. Then each
    rank's block of the strong-scaled 2x2 grid, cut from the 1x1 field
    with its ghosts filled from the field's neighbouring windows (what
    the exchange delivers: the periodic wrap for the heat update, the
    neighbours' interiors and the physical ghosts for the dual step):
    ``hand.heat2d`` at :data:`HEAT_RUNS`' dtypes and depths and
    ``hand.dual_dim_step`` in float32 and bfloat16, each launch on its
    route, against its plain version and, in the interior, against the
    matching window of the 1x1 result, bit for bit (the dual step's
    residual: the four blocks' partials summed, within
    ``hand.RESIDUAL_RTOL`` of the 1x1 residual). Returns the cases."""
    import torch

    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.drivers import heat2d
    from tpu_mpi_tests_torch.kernels import hand

    n_cases = 0
    for shape, n_bnd, dt, path in GRID_BANDS:
        dtype = getattr(torch, dt)
        z = rand(shape, dtype)
        route = hand.pack_route(z, 1, n_bnd)
        want = GRID_BAND_ROUTES.get((dt, n_bnd), route) \
            if path.startswith("heat2d") else route
        name = f"grid band {path} {dt} {shape[0]}x{shape[1]} axis=1 " \
               f"b={n_bnd} {route}"
        if route != want:
            failures.append(f"{name}: pack_route says {route}, the band "
                            f"width makes {want}")
        lo, hi = checked_launch("pack_edges", route,
                                lambda: hand.pack_edges(z, 1, n_bnd),
                                failures)
        wlo, whi = hand.pack_edges_ref(z, 1, n_bnd)
        compare(f"pack_edges lo {name}", lo, wlo, failures)
        compare(f"pack_edges hi {name}", hi, whi, failures)
        # the row ring's arrivals: the neighbours' bands
        flo, fhi = rand(tuple(lo.shape), dtype), rand(tuple(hi.shape), dtype)
        zc = z.clone()
        got = checked_launch(
            "unpack_ghosts", hand.pack_route(zc, 1, n_bnd, flo.data_ptr(),
                                             fhi.data_ptr()),
            lambda: hand.unpack_ghosts(zc, flo, fhi, 1, n_bnd), failures)
        compare(f"unpack_ghosts {name}", got,
                hand.unpack_ghosts_ref(z.clone(), flo, fhi, 1, n_bnd),
                failures)
        n_cases += 1
        del z, zc, got, lo, hi, wlo, whi, flo, fhi
        torch.cuda.empty_cache()

    _, cx, cy = heat2d.coefficients(GRID_N, GRID_N, 0.1)
    h = GRID_HALF
    for dt, k in HEAT_RUNS:
        field = rand((GRID_N + 2 * k,) * 2, getattr(torch, dt))
        H.exchange2d(field, k, True)  # the 1x1 grid's periodic ghosts
        whole = checked_launch("heat2d", hand.heat_route(field, k),
                               lambda: hand.heat2d(field, cx, cy, steps=k),
                               failures)
        inner = field[k:k + GRID_N, k:k + GRID_N]
        for rx, ry in itertools.product((0, 1), (0, 1)):
            rows = torch.arange(rx * h - k, (rx + 1) * h + k,
                                device=device) % GRID_N
            cols = torch.arange(ry * h - k, (ry + 1) * h + k,
                                device=device) % GRID_N
            blk = inner[rows][:, cols].contiguous()
            route = hand.heat_route(blk, k)
            name = (f"heat2d 2x2 block ({rx},{ry}) {dt} k={k} "
                    f"{blk.shape[0]}x{blk.shape[1]} route={route}")
            got = checked_launch("heat2d", route,
                                 lambda: hand.heat2d(blk, cx, cy, steps=k),
                                 failures)
            compare(name, got, hand.heat2d_ref(blk, cx, cy, steps=k),
                    failures)
            compare(f"{name} against the 1x1 result's window",
                    got[k:k + h, k:k + h],
                    whole[k + rx * h:k + (rx + 1) * h,
                          k + ry * h:k + (ry + 1) * h], failures)
            n_cases += 1
        del field, whole, inner, blk, got
        torch.cuda.empty_cache()
    s = GRID_SCALE
    for dtype in (torch.float32, torch.bfloat16):
        field = rand((GRID_N + 4,) * 2, dtype)
        wx, wy, wr = checked_launch(
            "dual_dim_step", hand.dual_route(field),
            lambda: hand.dual_dim_step(field, 2, s, s), failures)
        parts = 0.0
        for rx, ry in itertools.product((0, 1), (0, 1)):
            blk = field[rx * h:rx * h + h + 4, ry * h:ry * h + h + 4] \
                .contiguous()
            route = hand.dual_route(blk)
            name = (f"dual_dim_step 2x2 block ({rx},{ry}) {dtype} "
                    f"{blk.shape[0]}x{blk.shape[1]} route={route}")
            gx, gy, gr = checked_launch(
                "dual_dim_step", route,
                lambda: hand.dual_dim_step(blk, 2, s, s), failures)
            px_, py_, _ = hand.dual_dim_step_ref(blk, 2, s, s)
            compare(f"{name} dz_dx", gx, px_, failures)
            compare(f"{name} dz_dy", gy, py_, failures)
            window = (slice(rx * h, (rx + 1) * h), slice(ry * h, (ry + 1) * h))
            compare(f"{name} dz_dx against the 1x1 window", gx, wx[window],
                    failures)
            compare(f"{name} dz_dy against the 1x1 window", gy, wy[window],
                    failures)
            parts += float(gr)
            n_cases += 1
        rel = abs(parts - float(wr)) / max(abs(float(wr)), 1e-300)
        if not rel <= hand.RESIDUAL_RTOL[dtype]:
            failures.append(f"dual_dim_step 2x2 {dtype}: the blocks' "
                            f"residuals sum to {parts!r}, the 1x1 residual "
                            f"is {float(wr)!r} (relative {rel:g})")
        log(f"CHECK grid 2x2 blocks {dtype}: dual_dim_step residual, four "
            f"blocks against the 1x1 field, relative {rel:.3g} (tolerance "
            f"{hand.RESIDUAL_RTOL[dtype]:g})")
        del field, wx, wy, wr, blk, gx, gy, px_, py_
        torch.cuda.empty_cache()
    return n_cases


def probe_batch(device, dtype=None) -> int:
    """Blocks per probe launch on the main path (the groups' own rule):
    the clusters of (512, 512) blocks of ``dtype`` (float32 when None)
    the card holds at once."""
    import torch

    from tpu_mpi_tests_torch import microbench

    return microbench.probe_batch(PROBE_HW, PROBE_HW, device,
                                  dtype or torch.float32)


def check_probe_kernel(device, rand, failures):
    """The ALU probe against its plain version: every mix × float32 and
    bfloat16 × small, ragged, batched and main-path shapes × reps 1, 3,
    64 × the inert and a visible ``se``. ``fma``, ``step5*`` and
    ``heat5``: tolerance 0. The dual mixes: ``hand.alu_probe_tolerance``
    from the plain run's largest value and shift. Then the chain
    property, bit for bit in every mix, and the capacity guard. Returns
    (number of cases, {"alu_probe": max abs error of the bit-exact mixes
    at the main-path stack, "alu_probe dual mixes": their largest error
    and the tolerance it was held to})."""
    import torch

    from tpu_mpi_tests_torch.kernels import hand

    B = probe_batch(device)
    main = (B, PROBE_HW, PROBE_HW)
    shapes = ((8, 128), (16, 128), (37, 200), (PROBE_HW, PROBE_HW),
              (3, 70, 130), main)
    n_cases = 0
    errs = {"alu_probe": 0.0}
    dual = {"max_abs_err": 0.0, "tolerance_at_that_case": 0.0, "equal": 0,
            "cases": 0}
    for dtype in (torch.float32, torch.bfloat16):
        main = (probe_batch(device, dtype), PROBE_HW, PROBE_HW)
        for shape in shapes[:-1] + (main,):
            z = rand(shape, dtype)
            for mix in hand.ALU_PROBE_MIXES:
                for reps in (1, 3, 64):
                    for se in (1e-9, PROBE_SE_VISIBLE):
                        name = (f"alu_probe {mix} {dtype} {shape} "
                                f"reps={reps} se={se}")
                        got = hand.alu_probe(z, reps, mix, se=se)
                        shifts = []
                        want = hand.alu_probe_ref(z, reps, mix, se=se,
                                                  shifts=shifts)
                        n_cases += 1
                        if not mix.startswith("dualdim"):
                            err = compare(name, got, want, failures)
                            if shape == main:
                                errs["alu_probe"] = max(errs["alu_probe"],
                                                        err)
                            continue
                        err = float((got.double() - want.double()).abs()
                                    .max())
                        tol = hand.alu_probe_tolerance(
                            dtype, reps, float(want.double().abs().max()),
                            max(shifts))
                        dual["cases"] += 1
                        dual["equal"] += int(torch.equal(got, want))
                        if err >= dual["max_abs_err"]:
                            dual["max_abs_err"] = err
                            dual["tolerance_at_that_case"] = tol
                        if not err <= tol or not torch.isfinite(
                                got.double()).all():
                            failures.append(f"{name}: max |kernel - plain| "
                                            f"= {err:g} beyond {tol:g}")
            del z
    # every route: clusters of 2 to 16 CTAs and the l2 route, each launch
    # counted on the route hand.probe_route names
    took0 = dict(hand.alu_probe.launches_by_route)
    for shape, dname, route in PROBE_ROUTE_SHAPES:
        dtype = getattr(torch, dname)
        z = rand(shape, dtype)
        if hand.probe_route(z) != route:
            failures.append(f"alu_probe {shape} {dname}: route "
                            f"{hand.probe_route(z)}, expected {route}")
        for mix in hand.ALU_PROBE_MIXES:
            for reps in (1, 3):
                name = (f"alu_probe {mix} {dtype} {shape} reps={reps} "
                        f"route={route}")
                before = hand.alu_probe.launches_by_route[route]
                got = hand.alu_probe(z, reps, mix, se=PROBE_SE_VISIBLE)
                shifts = []
                want = hand.alu_probe_ref(z, reps, mix, se=PROBE_SE_VISIBLE,
                                          shifts=shifts)
                n_cases += 1
                if hand.alu_probe.launches_by_route[route] != before + 1:
                    failures.append(f"{name}: not counted on its route")
                if not mix.startswith("dualdim"):
                    compare(name, got, want, failures)
                    continue
                err = float((got.double() - want.double()).abs().max())
                tol = hand.alu_probe_tolerance(
                    dtype, reps, float(want.double().abs().max()),
                    max(shifts))
                if not err <= tol:
                    failures.append(f"{name}: max |kernel - plain| = "
                                    f"{err:g} beyond {tol:g}")
        del z
    took = {r: hand.alu_probe.launches_by_route[r] - took0[r]
            for r in took0}
    log(f"CHECK alu_probe route cases launches by route: "
        f"{json.dumps(took)}")
    if min(took.values()) <= 0:
        failures.append(f"alu_probe: the route cases did not launch both "
                        f"routes ({took})")
    errs["alu_probe dual mixes"] = dual
    # chain property: two launches equal one, bit for bit, in every mix,
    # on both routes
    for shape, dtype in (((2, 100, 300), torch.float32),
                         ((515, 500), torch.float32),
                         ((700, 1000), torch.float32)):
        z = rand(shape, dtype)
        for mix in hand.ALU_PROBE_MIXES:
            once = hand.alu_probe(z, 7, mix, se=PROBE_SE_VISIBLE)
            twice = hand.alu_probe(
                hand.alu_probe(z, 3, mix, se=PROBE_SE_VISIBLE), 4, mix,
                se=PROBE_SE_VISIBLE)
            if not torch.equal(once, twice) or torch.equal(once, z):
                failures.append(f"alu_probe {mix} {shape} route="
                                f"{hand.probe_route(z)}: probe(probe(z, 3), "
                                f"4) != probe(z, 7)")
            n_cases += 1
        del z
    # the capacity guard: two buffers over the L2 raise, nothing launches
    l2 = hand.alu_probe_l2_bytes()
    big = torch.zeros((l2 // 4 // 1024 // 2 + 1024, 1024), device=device)
    before = hand.alu_probe.launches
    try:
        hand.alu_probe(big, 2, "fma")
        failures.append("alu_probe: a block pair over the L2 did not raise")
    except ValueError as e:
        if "L2" not in str(e) or hand.alu_probe.launches != before:
            failures.append(f"alu_probe capacity guard: {e}")
    n_cases += 1
    del big
    log(f"PROBE {n_cases} cases; main-path stack {list(main)} on "
        f"{hand.probe_route(torch.empty(main))} (cluster of "
        f"{hand.probe_cluster(PROBE_HW, PROBE_HW, torch.float32)[0]} CTAs "
        f"float32, {hand.probe_cluster(PROBE_HW, PROBE_HW, torch.bfloat16)[0]}"
        f" bfloat16), L2 {l2} B; dual mixes {json.dumps(dual)}")
    return n_cases, errs


def check_pack_kernels(device, rand, failures):
    """Pack and unpack against their plain versions, tolerance 0: both
    axes × float32/float64/bfloat16 × n_bnd 1, 2, 3, 8 × ragged shapes
    (odd widths, n0 = 1 and 2 along axis 1, views one element off 16
    bytes), the round trip (ghosts take the packed edges, the interior is
    untouched), and the staged exchange's operands; every route
    (``hand.pack_route``) launched by both kernels. Returns (number of
    cases, max abs error per kernel at those operands)."""
    import torch

    from tpu_mpi_tests_torch.kernels import hand

    routes0 = hand.route_counts()

    def clone_at(z):
        """A copy of ``z`` as many elements past its allocation's start
        (the unpack launch takes the same route as the pack)."""
        at = z.storage_offset()
        out = torch.empty(at + z.numel(), dtype=z.dtype, device=z.device)
        return out[at:].view(z.shape).copy_(z)

    def one(z, axis, n_bnd, where):
        route = hand.pack_route(z, axis, n_bnd)
        name = (f"{where} {z.dtype} {tuple(z.shape)} axis={axis} b={n_bnd} "
                f"{route}")
        lo, hi = hand.pack_edges(z, axis, n_bnd)
        wlo, whi = hand.pack_edges_ref(z, axis, n_bnd)
        e_pack = max(compare(f"pack_edges lo {name}", lo, wlo, failures),
                     compare(f"pack_edges hi {name}", hi, whi, failures))
        n = z.shape[axis]
        got = hand.unpack_ghosts(clone_at(z), lo, hi, axis, n_bnd)
        want = hand.unpack_ghosts_ref(z.clone(), lo, hi, axis, n_bnd)
        e_unpack = compare(f"unpack_ghosts {name}", got, want, failures)
        inner = (n_bnd, n - 2 * n_bnd)
        if not (torch.equal(got.narrow(axis, 0, n_bnd), lo)
                and torch.equal(got.narrow(axis, n - n_bnd, n_bnd), hi)
                and torch.equal(got.narrow(axis, *inner),
                                z.narrow(axis, *inner))):
            failures.append(f"pack/unpack round trip {name}")
        return e_pack, e_unpack

    n_cases = 0
    for dtype in (torch.float32, torch.float64, torch.bfloat16):
        for shape in ((37, 201), (300, 1028), (64, 1027), (1, 1028),
                      (2, 1028)):
            z = rand(shape, dtype)
            # the same array one element off 16 bytes: a narrower route
            off = rand((shape[0] * shape[1] + 1,), dtype)[1:].view(shape)
            off.copy_(z)
            for axis in (0, 1):
                for n_bnd in (1, 2, 3, 8):
                    if z.shape[axis] < 2 * n_bnd:
                        continue
                    one(z, axis, n_bnd, "ragged")
                    one(off, axis, n_bnd, "off 16 bytes")
                    n_cases += 2
    routes = hand.route_counts()
    for name in ("pack_edges", "unpack_ghosts"):
        took = {r: routes[name][r] - routes0[name][r] for r in routes[name]}
        if not all(took.values()):
            failures.append(f"{name}: a route was never launched by the "
                            f"checks: {took}")
    errs = {"pack_edges": 0.0, "unpack_ghosts": 0.0}
    for shape, axis in STAGED_CASES:
        z = rand(shape, torch.float32)
        e_pack, e_unpack = one(z, axis, 2, "main-path")
        errs["pack_edges"] = max(errs["pack_edges"], e_pack)
        errs["unpack_ghosts"] = max(errs["unpack_ghosts"], e_unpack)
        n_cases += 1
        del z
        torch.cuda.empty_cache()
    return n_cases, errs


def same_offset_copy(t):
    """A copy of 1-D ``t`` that starts as far past 16 bytes as ``t`` does
    (so an in-place launch on it takes ``t``'s route)."""
    import torch

    off = t.data_ptr() % 16 // t.element_size()
    buf = torch.empty(t.numel() + off, dtype=t.dtype, device=t.device)
    return buf[off:].copy_(t)


def stream_calls(name, a, ops, inplace):
    """(kernel call, plain call) of streaming kernel ``name`` on operands
    ``ops`` (x, y for daxpy; x for scale; w, x, y for sum3); in place, the
    kernel writes into a copy of its last operand at the same offset from
    16 bytes, and returns it."""
    from tpu_mpi_tests_torch.kernels import hand

    kernel, plain = getattr(hand, name), getattr(hand, f"{name}_ref")
    args = ops if name == "stream_sum3" else (a, *ops)

    def run_kernel():
        if not inplace:
            return kernel(*args)
        tgt = same_offset_copy(args[-1])
        return kernel(*args[:-1], tgt, out=tgt)

    return run_kernel, lambda: plain(*args)


def stream_edges(dtype):
    """n at the edges of a vec16 group (``hand.STREAM_GROUP_PACKS``
    16-byte packs, one CTA's work) for ``dtype``: one pack, one group ± 1
    pack, and two groups ± 1 element (the grid's CTAs × the group ± 1:
    the last group one pack short with a tail of a pack less one, or two
    whole groups, a tail of one element and a third CTA)."""
    from tpu_mpi_tests_torch.kernels import hand

    pack = 16 // dtype.itemsize
    group = hand.STREAM_GROUP_PACKS * pack
    return (pack, group - pack, group + pack, 2 * group - 1, 2 * group + 1)


def check_stream_kernels(device, gen, failures):
    """The streaming kernels against their plain versions, tolerance 0:
    every dtype × n 1, 127, 1000003 on 16-byte operands (the vec16 route)
    and a view 4 bytes off 16 (the scalar route), then the edges of a
    vec16 group (:func:`stream_edges`), × a × out of place / in place,
    each launch counted on the route its operands take; then the
    microbench's own operands at 2^26 and 2^28 float32. Returns (number
    of cases, max abs error per kernel at the main-path operands)."""
    import torch

    from tpu_mpi_tests_torch.kernels import hand

    def rand(n, dtype, offset=0):
        t = torch.rand(n + offset, generator=gen, device=device,
                       dtype=torch.float32) * 4 - 2
        return t.to(dtype)[offset:]

    def cases(dtype, n, offset):
        nonlocal n_cases
        w, x, y = (rand(n, dtype, offset) for _ in range(3))
        route = "scalar" if offset else "vec16"
        for name in STREAM_KERNELS:
            ops = {"daxpy": (x, y), "stream_scale": (x,),
                   "stream_sum3": (w, x, y)}[name]
            for a in ((None,) if name == "stream_sum3"
                      else (2.0, 1e-7, 1.0 + 1e-9)):
                for inplace in (False, True):
                    before = hand.route_counts()[name]
                    got, want = (f() for f in stream_calls(
                        name, a, ops, inplace))
                    label = (f"{name} {dtype} n={n} offset={offset} a={a} "
                             f"inplace={inplace}")
                    compare(label, got, want, failures)
                    after = hand.route_counts()[name]
                    took = {r: after[r] - before[r] for r in after}
                    if took != {r: int(r == route) for r in after}:
                        failures.append(f"{label}: launched {took}, its "
                                        f"operands take {route}")
                    n_cases += 1

    n_cases = 0
    dtypes = (torch.float32, torch.float64, torch.bfloat16)
    for dtype in dtypes:
        for n, offset in ((1, 0), (127, 0), (1000003, 0), (1000003, 1)):
            cases(dtype, n, offset)
    for dtype in dtypes:
        for n in stream_edges(dtype):
            cases(dtype, n, 0)
    # the main path's operands: the microbench's calls, each shape once
    errs = dict.fromkeys(STREAM_KERNELS, 0.0)
    for name, n, a, inplace in (
            ("daxpy", N26, 2.0, False), ("daxpy", N26, 1e-7, True),
            ("daxpy", N26, 1.0, True), ("daxpy", N28, 2.0, False),
            ("daxpy", N28, 1.0, True), ("stream_scale", N26, 2.0, False),
            ("stream_scale", N26, 1.0 + 1e-9, True),
            ("stream_sum3", N26, None, True)):
        k = {"daxpy": 2, "stream_scale": 1, "stream_sum3": 3}[name]
        ops = tuple(rand(n, torch.float32) for _ in range(k))
        before = hand.route_counts()[name]["vec16"]
        got, want = (f() for f in stream_calls(name, a, ops, inplace))
        label = f"{name} main-path n={n} a={a} inplace={inplace}"
        errs[name] = max(errs[name], compare(label, got, want, failures))
        if hand.route_counts()[name]["vec16"] != before + 1:
            failures.append(f"{label}: not launched on the vec16 route")
        n_cases += 1
        del ops, got, want
        torch.cuda.empty_cache()
    return n_cases, errs


def wgmma_heads_operands(rand, heads_outer, d):
    """q, k, v of ``check_flash_kernel``'s (L, 4, d) wgmma cases, bf16,
    L 333, drawn by ``rand(shape, dtype)``: the heads inside the rows
    (333, 4, d), or outside them (a head stride L·d above the row stride
    d)."""
    import torch

    if heads_outer:
        return tuple(rand((4, 333, d), torch.bfloat16).transpose(0, 1)
                     for _ in range(3))
    return tuple(rand((333, 4, d), torch.bfloat16) for _ in range(3))


def heads_error(q, k, v, precision):
    """(max |out - plain out|, its tolerance) of ``hand.flash_attention``
    over (L, H, d) causal operands against the plain version at HIGHEST
    in float32 on the same values. HIGHEST is held to FLASH_ATOL; DEFAULT
    to FLASH_DEFAULT_ATOL plus, for a bf16 output, its own rounding: half
    an ulp of the largest output, 2^-8 × max|want| (bf16 keeps 8
    significant bits). The plain output is not rounded to bf16, so the
    bound counts one rounding, the kernel's."""
    from tpu_mpi_tests_torch.kernels import hand

    got = hand.flash_attention(q, k, v, causal=True, precision=precision)
    want = hand.flash_attention_ref(q.float(), k.float(), v.float(),
                                    causal=True)
    err = float((got.float() - want).abs().max())
    if precision == "highest":
        return err, FLASH_ATOL
    dt = str(q.dtype).split(".")[1]
    half_ulp = 2.0**-8 * float(want.abs().max()) if dt == "bfloat16" else 0
    return err, FLASH_DEFAULT_ATOL[dt] + half_ulp


def flash_heads_witness(device, seeds):
    """The (L, 4, d) wgmma cases of ``check_flash_kernel`` on operands
    from each of ``seeds``: per case, max |out - plain out| against the
    plain output in float32 (``err``) and rounded to bf16 as the output
    is (``err_rounded``), max|want|, and at the worst element of the
    rounded comparison the gap in bf16 ulps there and the float32 gap;
    then the cases beyond each bound: the bound before (FLASH_DEFAULT_ATOL
    + 2^-9 × max|want| against the rounded plain output) and
    :func:`heads_error`'s."""
    import torch

    from tpu_mpi_tests_torch.kernels import hand

    rows = []
    for seed in seeds:
        gen = torch.Generator(device=device).manual_seed(seed)

        def rand(shape, dtype):
            return torch.randn(shape, generator=gen,
                               device=device).to(dtype)

        for heads_outer in (False, True):
            for d in (64, 128):
                q, k, v = wgmma_heads_operands(rand, heads_outer, d)
                err, tol = heads_error(q, k, v, "default")
                got = hand.flash_attention(q, k, v, causal=True,
                                           precision="default").float()
                want = hand.flash_attention_ref(
                    q.float(), k.float(), v.float(), causal=True)
                rounded = want.to(torch.bfloat16).float()
                gap = (got - rounded).abs()
                i = int(gap.argmax())
                top = float(want.abs().max())
                w = float(rounded.flatten()[i])
                ulp = 2.0 ** (math.floor(math.log2(abs(w))) - 7) if w else 0
                rows.append({
                    "seed": seed, "heads_outer": heads_outer, "d": d,
                    "err": err, "tol": tol, "max_want": top,
                    "err_rounded": float(gap.max()),
                    "tol_before": FLASH_DEFAULT_ATOL["bfloat16"]
                    + 2.0**-9 * top,
                    "worst_ulps": float(gap.flatten()[i]) / ulp if ulp
                    else None,
                    "worst_f32_gap": float((got - want).abs().flatten()[i]),
                })
    return {"cases": len(rows),
            "beyond_before": [r for r in rows
                              if r["err_rounded"] > r["tol_before"]],
            "beyond_now": [r for r in rows if r["err"] > r["tol"]],
            "max_err_over_tol": max(r["err"] / r["tol"] for r in rows),
            "max_err_rounded": max(r["err_rounded"] for r in rows)}


def check_flash_kernel(device, gen, failures):
    """The flash kernel against its plain version: f32 and bf16 × L 1, 7,
    100, 257, 1024 × Lk 1, 64, 300 × d 4, 17, 64, 128, 256, non-causal
    and causal with offsets that leave the block partly live (0, 0),
    fully masked (0, 10^6), fully live (10^6, 0) and partly live at
    pos_stride 4, each at HIGHEST (the carry, FLASH_RTOL/ATOL) and
    DEFAULT (the normalised output against the plain version at HIGHEST,
    FLASH_DEFAULT_ATOL); a chain of two folds against one fold over the
    concatenated block; the (L, H, d) layout with H=4 in one launch; the
    wgmma route (bf16 DEFAULT) at L 1, 7, 65, 8191 × (Lk, d) (L, 128) and
    (129, 64) × dense, self-causal, offset, striped and fully masked, and
    (L, 4, d) with the heads inside and outside the rows, each launch
    counted on that route; the main path's operands (8192×128 f32 and
    bf16, 32768×128 bf16 causal). Returns (number of cases, largest error
    per class, the main-path errors)."""
    import torch

    from tpu_mpi_tests_torch.kernels import hand

    torch.backends.cuda.matmul.allow_tf32 = False
    errs: dict[str, float] = {}

    def rand(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    def carry(L, d, fresh=False):
        if fresh:
            return (torch.full((L, 1), float("-inf"), device=device),
                    torch.zeros((L, 1), device=device),
                    torch.zeros((L, d), device=device))
        return rand((L, 1)), rand((L, 1)).abs() + 0.5, rand((L, d))

    def note(cls, err):
        errs[cls] = max(errs.get(cls, 0.0), err)
        return err

    def close(name, cls, got, want):
        """Carries at HIGHEST: rtol/atol, -inf rows equal; acc's atol
        scaled by its row's weight l where l > 1 (see FLASH_ATOL)."""
        err = 0.0
        for g, w, what in zip(got, want, ("m", "l", "acc")):
            atol = FLASH_ATOL
            if what == "acc":
                atol = FLASH_ATOL * want[1].clamp(min=1.0)
            ok = (g - w).abs() <= atol + FLASH_RTOL * w.abs()
            ok |= g == w  # -inf rows
            fin = torch.isfinite(w)
            if fin.any():
                err = max(err, float((g[fin] - w[fin]).abs().max()))
            if not bool(ok.all()):
                failures.append(f"flash {name} {what}: max |kernel - plain|"
                                f" = {err:g} beyond rtol/atol {FLASH_RTOL:g}")
        return note(cls, err)

    def normalised_close(name, cls, got, want, dtype):
        g, w = got[2] / got[1], want[2] / want[1]
        err = float((g - w).abs().max())
        tol = FLASH_DEFAULT_ATOL[str(dtype).split(".")[1]]
        if not err <= tol:
            failures.append(f"flash {name}: max |out - plain out| = {err:g}"
                            f" beyond {tol:g}")
        return note(cls, err)

    def fold(q, k, v, c, offs, causal, precision, plain=False, **kw):
        fn = hand.flash_attention_block_ref if plain \
            else hand.flash_attention_block
        args = [t.clone() for t in c] if not plain else list(c)
        return fn(q, k, v, *args, offs[0], offs[1], scale=q.shape[1]**-0.5,
                  causal=causal, pos_stride=offs[2], precision=precision,
                  **kw)

    n_cases = 0
    big = 10**6
    offsets = ((False, (0, 0, 1), "dense"),
               (True, (0, 0, 1), "partly masked"),
               (True, (0, big, 1), "fully masked"),
               (True, (big, 0, 1), "fully live"),
               (True, (40, 16, 4), "stride 4"))
    for dtype in (torch.float32, torch.bfloat16):
        dn = str(dtype).split(".")[1]
        for L in (1, 7, 100, 257, 1024):
            for Lk in (1, 64, 300):
                for d in (4, 17, 64, 128, 256):
                    q, k, v = rand((L, d), dtype), rand((Lk, d), dtype), \
                        rand((Lk, d), dtype)
                    c = carry(L, d)
                    for causal, offs, what in offsets:
                        name = f"{dn} L={L} Lk={Lk} d={d} {what}"
                        want = fold(q, k, v, c, offs, causal, "highest",
                                    plain=True)
                        close(name + " highest", f"{dn} highest",
                              fold(q, k, v, c, offs, causal, "highest"),
                              want)
                        normalised_close(
                            name + " default", f"{dn} default",
                            fold(q, k, v, c, offs, causal, "default"), want,
                            dtype)
                        n_cases += 2
    # two folds chained against one fold over the concatenated block
    for causal in (False, True):
        q, k1, v1 = rand((300, 64)), rand((200, 64)), rand((200, 64))
        k2, v2 = rand((150, 64)), rand((150, 64))
        c = carry(300, 64, fresh=True)
        mid = fold(q, k1, v1, c, (100, 0, 1), causal, "highest")
        got = fold(q, k2, v2, mid, (100, 200, 1), causal, "highest")
        want = fold(q, torch.cat([k1, k2]), torch.cat([v1, v2]), c,
                    (100, 0, 1), causal, "highest", plain=True)
        close(f"chain of two folds causal={causal}", "float32 highest", got,
              want)
        n_cases += 1
    # (L, H, d) with H=4: one launch over the heads, no copy
    for dtype, precision in ((torch.float32, "highest"),
                             (torch.bfloat16, "default")):
        q, k, v = (rand((333, 4, 64), dtype) for _ in range(3))
        before = hand.flash_attention_block.launches
        err, tol = heads_error(q, k, v, precision)
        if hand.flash_attention_block.launches != before + 1:
            failures.append("flash (L, H, d): not one launch")
        if not err <= tol:
            failures.append(f"flash (L, 4, d) {dtype} {precision}: "
                            f"{err:g} beyond {tol:g}")
        note(f"(L, H, d) {str(dtype).split('.')[1]} {precision}", err)
        n_cases += 1
    # the wgmma route (bf16 DEFAULT, d <= 128, 16-byte chunks): ragged L,
    # causal with offsets and the striped ring's stride, fully masked;
    # (L, H, d) with the heads inside and outside the rows; every launch
    # counted on that route
    wg0 = hand.flash_attention_block.launches_by_route["wgmma"]
    n_wg = 0
    wg_offsets = ((False, (0, 0, 1), "dense"),
                  (True, (0, 0, 1), "self-causal"),
                  (True, (1000, 37, 1), "offsets"),
                  (True, (3, 1, 4), "striped p=3 of 4 from 1"),
                  (True, (0, big, 1), "fully masked"))
    for L in (1, 7, 65, 8191):
        for Lk, d in ((L, 128), (129, 64)):
            q = rand((L, d), torch.bfloat16)
            k, v = (rand((Lk, d), torch.bfloat16) for _ in range(2))
            c = carry(L, d)
            for causal, offs, what in wg_offsets:
                name = f"wgmma L={L} Lk={Lk} d={d} {what}"
                want = fold(q, k, v, c, offs, causal, "highest", plain=True)
                normalised_close(name, "bfloat16 wgmma", fold(
                    q, k, v, c, offs, causal, "default"), want,
                    torch.bfloat16)
                n_wg += 1
                n_cases += 1
            del q, k, v, c
    for heads_outer in (False, True):
        for d in (64, 128):
            q, k, v = wgmma_heads_operands(rand, heads_outer, d)
            err, tol = heads_error(q, k, v, "default")
            if not err <= tol:
                failures.append(f"flash wgmma (L, 4, {d}) heads_outer="
                                f"{heads_outer}: {err:g} beyond {tol:g}")
            note("bfloat16 wgmma (L, H, d)", err)
            n_wg += 1
            n_cases += 1
    got_wg = hand.flash_attention_block.launches_by_route["wgmma"] - wg0
    if got_wg != n_wg:
        failures.append(f"flash wgmma cases: {got_wg} launches on the wgmma "
                        f"route, {n_wg} cases")
    # the main path's operands, from the fresh carry as flash_attention
    # starts it
    main = {}
    for L, dtype, causal, precision in (
            (ATTN_L, torch.float32, False, "highest"),
            (ATTN_L, torch.float32, True, "highest"),
            (ATTN_L, torch.bfloat16, False, "default"),
            (ATTN_L_LONG, torch.bfloat16, True, "default")):
        q, k, v = (rand((L, ATTN_D), dtype) for _ in range(3))
        c = carry(L, ATTN_D, fresh=True)
        name = f"main-path {L}x{ATTN_D} {dtype} causal={causal} {precision}"
        want = fold(q, k, v, c, (0, 0, 1), causal, "highest", plain=True,
                    k_tile=4096)
        got = fold(q, k, v, c, (0, 0, 1), causal, precision)
        if precision == "highest":
            close(name, "main-path highest", got, want)
        else:
            normalised_close(name, "main-path default", got, want, dtype)
        main[name] = float((got[2] / got[1] - want[2] / want[1]).abs().max())
        n_cases += 1
        del q, k, v, c, got, want
        torch.cuda.empty_cache()
    torch.cuda.synchronize(device)
    log(f"FLASH_ERRORS largest per class {json.dumps(errs)}")
    log(f"FLASH_ERRORS main path (normalised output) {json.dumps(main)}")
    return n_cases, errs, main


#: path -> the attention kernels' and the ring collectives' launches per
#: route on that path (hand.route_counts(), read with the path's counts)
ROUTE_COUNTS: dict = {}


def check_routes(path, name, want):
    """Fail unless ``name``'s launches on ``path`` took exactly the routes
    ``want`` names (route -> count; every other route none)."""
    got = ROUTE_COUNTS[path][name]
    full = dict.fromkeys(got, 0) | want
    if got != full:
        raise SmokeFailure(f"{path}: {name} launches by route {got}, its "
                           f"operands' route makes {full}")


def check_stream_routes(path, launches):
    """Every streaming-kernel launch of ``path`` (``launches``: kernel ->
    count) on the vec16 route: the microbench's operands are fresh
    allocations, which start on 16 bytes."""
    for name in STREAM_KERNELS:
        n = launches.get(name, 0)
        check_routes(path, name, {"vec16": n} if n else {})


#: the k-step kernels, whose launches count per route (hand.KSTEP_ROUTES)
KSTEP_KERNELS = ("stencil2d_iterate", "stencil2d_fused_rdma")


def check_kstep_routes(path, launches):
    """Every k-step launch of ``path`` (``launches``: kernel -> count) on
    the regs route: every main-path operand's rows start on 8 bytes."""
    for name in KSTEP_KERNELS:
        n = launches.get(name, 0)
        check_routes(path, name, {"regs": n} if n else {})


#: the heat update and the derivative, whose launches count per route
#: (hand.HEAT_ROUTES, hand.DERIV_ROUTES)
HEAT_DERIV_KERNELS = ("heat2d", "stencil2d_deriv")


def check_heat_deriv_routes(path, launches):
    """Every heat and derivative launch of ``path`` (``launches``: kernel
    -> count) on the regs route: every main-path heat shard's rows start
    on a word (16 bytes at 8200² and 2056², 8 at 8194² float32 and at
    2052² and 2060² bfloat16, 4 at 2050² bfloat16), every derivative's on
    16 bytes (no operand of the main path is named as an exception)."""
    for name in HEAT_DERIV_KERNELS:
        n = launches.get(name, 0)
        check_routes(path, name, {"regs": n} if n else {})


def check_probe_dual_routes(path, launches, dual_bf16):
    """Every probe launch of ``path`` (``launches``: kernel -> count) on
    the cluster route, ``dual_bf16`` of its dual-step launches on the regs
    route and the rest on smem: the main path's (512, 512) blocks fit a
    cluster, its bfloat16 dual-step blocks have rows on 4 elements and
    its float32 ones take smem."""
    n = launches.get("alu_probe", 0)
    check_routes(path, "alu_probe", {"cluster": n} if n else {})
    n = launches.get("dual_dim_step", 0)
    check_routes(path, "dual_dim_step",
                 {r: c for r, c in (("regs", dual_bf16),
                                    ("smem", n - dual_bf16)) if c})


def drive_path(path, fn, kernels, peaks):
    """Run one main path with every launch count set to 0 just before and
    read just after; fail unless each of ``kernels`` launched in it.
    Records the path's peak device memory in ``peaks``. Returns (fn's
    result, the path's counts)."""
    import torch

    from tpu_mpi_tests_torch.kernels import hand

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    hand.reset_launch_counts()
    result = fn()
    counts = hand.launch_counts()
    ROUTE_COUNTS[path] = hand.route_counts()
    peaks[path] = torch.cuda.max_memory_allocated()
    for name in kernels:
        if counts[name] <= 0:
            raise SmokeFailure(f"kernel {name} was never launched on the "
                               f"{path} path")
    return result, counts


#: each driver path's captured standard output (:func:`drive_driver`)
DRIVER_TEXT: dict = {}


def drive_driver(path, module, argv, kernels, needed, peaks, stdout=None):
    """Run a driver's ``main(argv)`` as one main path (:func:`drive_path`)
    with its output captured (into ``stdout`` when given, which another
    thread may read while it runs) and logged; fail unless it exits 0
    with no FAIL line and prints each of ``needed``. Returns the path's
    counts."""
    log(f"DRIVER python -m {module.__name__} " + " ".join(argv))

    def run():
        out = io.StringIO() if stdout is None else stdout
        with contextlib.redirect_stdout(out):
            rc = module.main(argv)
        return rc, out.getvalue()

    (rc, text), counts = drive_path(path, run, kernels, peaks)
    DRIVER_TEXT[path] = text
    for line in text.splitlines():
        log(f"  {line}")
    if rc != 0 or "FAIL" in text:
        raise SmokeFailure(f"{path} driver failed (rc={rc})")
    for want in needed:
        if want not in text:
            raise SmokeFailure(f"{path} output lacks {want!r}")
    return counts


def check_per_timestep(path, name, launches, timesteps, want):
    """Launches per timestep measured on a path, held against what its
    schedule makes (S launches per k timesteps on S blocks, one per k on
    a single buffer, one derivative per driver iteration)."""
    got = launches / timesteps
    if abs(got - want) > 1e-12:
        raise SmokeFailure(f"{path}: {name} made {launches} launches in "
                           f"{timesteps} timesteps ({got:g} per timestep), "
                           f"its schedule makes {want:g}")
    return got


def run_main_path(device):
    """Phase 4: the bench in each dtype and the driver, each path with
    the counts zeroed just before it and read just after. Returns
    (counts per path, launches per timestep per path, bench records)."""
    from tpu_mpi_tests_torch import bench
    from tpu_mpi_tests_torch.drivers import heat2d, stencil2d, stencil2d_grid
    from tpu_mpi_tests_torch.tune import priors

    # the bench's default schedules at the headline size, one dtype per
    # run so each has counts of its own, whatever the caller's
    # environment selects; no schedule cache, so every knob takes the
    # card's prior (tune/priors.py)
    for var in [v for v in os.environ if v.startswith("TPU_MPI_BENCH_")]:
        del os.environ[var]
    os.environ["TPU_MPI_TUNE_CACHE"] = os.path.join(
        tempfile.mkdtemp(prefix="smoke_no_cache_"), "tune.json")
    os.environ.update({
        "TPU_MPI_BENCH_N": str(BENCH_N),
        "TPU_MPI_BENCH_SECOND_DTYPE": "none",
        "TPU_MPI_BENCH_ITERS_SHORT": str(BENCH_ITERS_SHORT),
        "TPU_MPI_BENCH_ITERS_LONG": str(BENCH_ITERS_LONG),
        "TPU_MPI_BENCH_SAMPLES": str(BENCH_SAMPLES),
    })
    counts, per_step, recs, peaks = {}, {}, {}, {}
    for dtype in ("float32", "bfloat16"):
        path = f"bench {dtype}"
        os.environ["TPU_MPI_BENCH_DTYPE"] = dtype

        def run_bench():
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                rec = bench.main(["--device", device.type])
            log(f"BENCH {out.getvalue().strip().splitlines()[-1]}")
            return rec

        rec, counts[path] = drive_path(path, run_bench,
                                       ["stencil2d_iterate"], peaks)
        if rec.get("tier") != "blocks" or not rec.get("value", 0) > 0:
            raise SmokeFailure(f"{path}: not a measured blocks-tier run: "
                               f"{rec}")
        S = bench_blocks_used(dtype)
        want = (f"blocks{S}_dim0" if S else "dim1") + \
            f"_world1_{dtype}_ov1_{priors.stencil_tier(dtype)}_h1x1"
        if rec["schedule"] != want or rec["steps"] != priors.BENCH_STEPS:
            raise SmokeFailure(f"{path}: ran {rec['schedule']} at k="
                               f"{rec['steps']}, not the card's priors "
                               f"({want} at k={priors.BENCH_STEPS})")
        # chain_rate runs 3 warm calls, then n_short and n_long calls per
        # sample; each call advances k timesteps (bench.measure)
        k = rec["steps"]
        n_short = max(1, BENCH_ITERS_SHORT // k)
        n_long = max(n_short + 1, BENCH_ITERS_LONG // k)
        timesteps = BENCH_SAMPLES * (3 + n_short + n_long) * k
        n_blocks = max(1, S)
        per_step[path] = {"stencil2d_iterate": check_per_timestep(
            path, "stencil2d_iterate", counts[path]["stencil2d_iterate"],
            timesteps, n_blocks / k)}
        recs[dtype] = rec

    path = "stencil2d"
    argv = ["--device", device.type, "--n-local", str(REF_N_LOCAL),
            "--n-other", str(REF_N_OTHER),
            "--n-iter", str(DRIVER_N_ITER), "--n-warmup",
            str(DRIVER_N_WARMUP), "--kernel", "hand",
            "--iterate-tier", "blocks", "--iterate-steps", "4",
            "--iterate-iters", str(DRIVER_ITERATE_ITERS)]
    counts[path] = drive_driver(
        path, stencil2d, argv, ["stencil2d_iterate", "stencil2d_deriv"],
        ("TEST dim:0", "TEST dim:1", "ITER ERR rel="), peaks)
    # the iterate leg: one warm call, then --iterate-iters calls, k
    # timesteps each, S blocks (the fused == chained gate's chained tier
    # adds one iterate launch per call); the derivative: dim × buf = 4
    # tests of n_warmup + n_iter iterations, one launch each
    k = 4
    S = priors.bench_blocks("float32")
    n_blocks = S if S >= 2 and REF_N_LOCAL % S == 0 else 1
    # the fused == chained gate's chained tier exchanges the iterate leg's
    # operand through ring_halo
    check_routes(path, "ring_halo", ring_routes(
        ("stencil2d iterate leg", counts[path]["ring_halo"])))
    per_step[path] = {
        "stencil2d_iterate": check_per_timestep(
            path, "stencil2d_iterate",
            counts[path]["stencil2d_iterate"] - DRIVER_ITERATE_ITERS,
            (1 + DRIVER_ITERATE_ITERS) * k, n_blocks / k),
        "stencil2d_deriv": check_per_timestep(
            path, "stencil2d_deriv", counts[path]["stencil2d_deriv"],
            4 * (DRIVER_N_WARMUP + DRIVER_N_ITER), 1.0),
    }

    # the heat mini-app: one launch per outer body of k timesteps
    for dtype, k in HEAT_RUNS:
        path = f"heat2d {dtype} k={k}"
        argv = ["--device", device.type, "--kernel", "hand", "--mesh", "1,1",
                "--nx-local", str(GRID_N), "--ny-local", str(GRID_N),
                "--n-steps", str(HEAT_N_STEPS), "--halo-steps", str(k),
                "--dtype", dtype]
        counts[path] = drive_driver(path, heat2d, argv, ["heat2d"],
                                    ("HEAT mesh:1x1", "HEAT ERR rel="),
                                    peaks)
        per_step[path] = {"heat2d": check_per_timestep(
            path, "heat2d", counts[path]["heat2d"], HEAT_N_STEPS, 1 / k)}

    # the 2-D grid step: one dual-step launch per iteration
    path = "stencil2d_grid"
    argv = ["--device", device.type, "--kernel", "hand", "--mesh", "1,1",
            "--nx-local", str(GRID_N), "--ny-local", str(GRID_N),
            "--n-iter", str(GRID_N_ITER), "--n-warmup", str(GRID_N_WARMUP)]
    counts[path] = drive_driver(path, stencil2d_grid, argv,
                                ["dual_dim_step"],
                                ("GRID TEST px:1 py:1", "step mean="),
                                peaks)
    per_step[path] = {"dual_dim_step": check_per_timestep(
        path, "dual_dim_step", counts[path]["dual_dim_step"],
        GRID_N_ITER + GRID_N_WARMUP, 1.0)}
    check_probe_dual_routes(path, counts[path], 0)  # float32 blocks

    recs["rdma"] = run_rdma_slice(device, counts, per_step, peaks)
    recs["coll"] = run_coll_slice(device, counts, peaks)
    rdma_world2_legs()
    for var in [v for v in os.environ if v.startswith("TPU_MPI_BENCH_")]:
        del os.environ[var]
    recs["microbench"] = run_daxpy_slice(device, counts, peaks)
    recs["attention"] = run_attention_slice(device, counts, peaks)
    recs["one_card"] = run_one_card_slice(device, counts, peaks)
    recs["overlap"] = run_overlap_slice(device, counts, per_step, peaks)
    recs["tune"] = run_tune_slice(device, counts, peaks)
    recs["instrument"] = run_instrument_slice(device, counts, peaks)
    recs["serving"] = run_serving_slice(device, counts, peaks)
    recs["serve"] = run_serve_slice(device, counts, peaks)
    recs["chaos"] = run_chaos_slice(device, counts, peaks)
    # every k-step, heat and derivative launch of every path on the regs
    # route
    for path, c in counts.items():
        check_kstep_routes(path, c)
        check_heat_deriv_routes(path, c)
    log(f"KSTEP_ROUTES {json.dumps({p: {n: r[n] for n in KSTEP_KERNELS if sum(r[n].values())} for p, r in ROUTE_COUNTS.items()})}")
    log("HEAT_DERIV_ROUTES " + json.dumps(
        {p: {n: r[n] for n in HEAT_DERIV_KERNELS if sum(r[n].values())}
         for p, r in ROUTE_COUNTS.items()}))
    # the staged legs of the stencil2d driver were handed the pack/unpack
    # kernels; its non-periodic world=1 exchange moves nothing
    for name in ("pack_edges", "unpack_ghosts"):
        if counts["stencil2d"][name]:
            raise SmokeFailure(f"stencil2d: {name} launched "
                               f"{counts['stencil2d'][name]} times on a "
                               f"non-periodic world=1 exchange")

    log(f"LAUNCHES {json.dumps(counts)}")
    log(f"LAUNCHES_PER_TIMESTEP {json.dumps(per_step)}")
    log(f"PEAK_BYTES {json.dumps(peaks)}")
    return counts, per_step, recs


#: the tune slice: the sweep budget of each --tune run (seconds)
TUNE_BUDGET_S = 60


def iterate_leg_want(tier: str, it: int, n_blocks: int) -> dict:
    """Exact launches of the stencil2d driver's iterate leg under ``tier``
    (with no sweep): the timed leg (1 warm + ``it`` calls of the tier:
    ``n_blocks`` iterate launches a call on resident blocks, one on the
    single buffer), the fused == chained gate (``it`` fused, ``it``
    chained: ring_halo + iterate) and the OVERLAP probe (1 + ``it`` fused
    and compute-only fused calls)."""
    timed = {"blocks": {"stencil2d_iterate": max(1, n_blocks)},
             "rdma-chained": {"ring_halo": 1, "stencil2d_iterate": 1},
             "rdma-fused": {"stencil2d_fused_rdma": 1}, "xla": {}}[tier]
    want = {"ring_halo": it, "stencil2d_iterate": it,
            "stencil2d_fused_rdma": it + 2 * (1 + it)}
    for name, per_call in timed.items():
        want[name] += per_call * (1 + it)
    return want


def _jsonl_records(path: str, kind: str) -> list:
    with open(path) as f:
        return [r for r in map(json.loads, f) if r.get("kind") == kind]


def _iterate_bits(path: str) -> int:
    (rec,) = _jsonl_records(path, "iterate_gate")
    return rec["bits"]


def _states_equal(a, b) -> bool:
    import torch

    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return len(a) == len(b) and all(map(torch.equal, a, b))


def run_tune_slice(device, counts, peaks):
    """The schedule plane on the card, each path alone (``tune/``):

    * ``stencil2d --kernel auto --iterate-tier auto --tune`` at the
      reference sizes: every tier candidate measured on the card (or
      declined with its reason, never skipped by the budget), the winner
      stored; then the same run on the cache without ``--tune``: a
      ``tune_hit``, no sweep, the winner's launches exact, its iterate
      field equal bit for bit to the sweep run's and to the explicit
      winner's (``iterate_gate`` records);
    * the bench at 8192² in float32 and bfloat16 under
      ``TPU_MPI_BENCH_TUNE=1`` on a fresh cache: the resolved schedule
      printed, its final state equal bit for bit to the explicit
      schedule's, and a resolution without the variable served by the
      cache;
    * ``stencil1d --staging auto --tune`` at 32 Mi points, ``heat2d
      --kernel auto --overlap auto`` at 8192², and stencil2d's
      ``--fused --debug-dump`` and ``--managed`` legs at the reference
      sizes, each with exact launches;
    * a pack of the stencil2d cache (``python -m
      tpu_mpi_tests_torch.tune.pack``), imported into a fresh cache
      entry for entry, and preloaded by ``--tune-pack`` into a run with
      no cache file: a cache hit on the same field.

    Returns the bench records."""
    import torch

    from tpu_mpi_tests_torch import bench
    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.drivers import heat2d, stencil1d, stencil2d
    from tpu_mpi_tests_torch.tune import cache as tcache
    from tpu_mpi_tests_torch.tune import priors
    from tpu_mpi_tests_torch.tune.fingerprint import fingerprint

    tmp = tempfile.mkdtemp(prefix="smoke_tune_")
    cache = os.path.join(tmp, "tune.json")
    it = DRIVER_ITERATE_ITERS
    base = ["--device", device.type, "--n-local", str(REF_N_LOCAL),
            "--n-other", str(REF_N_OTHER)]
    leg = base + ["--iterate-tier", "auto", "--iterate-steps", "4",
                  "--iterate-iters", str(it)]
    matrix = ["--n-iter", str(DRIVER_N_ITER), "--n-warmup",
              str(DRIVER_N_WARMUP)]
    derivs = 4 * (DRIVER_N_WARMUP + DRIVER_N_ITER)

    path = "stencil2d --tune"
    jl = {name: os.path.join(tmp, f"{name}.jsonl")
          for name in ("sweep", "hit", "explicit", "pack")}
    counts[path] = drive_driver(
        path, stencil2d, leg + matrix + [
            "--kernel", "auto", "--tune", "--tune-budget",
            str(TUNE_BUDGET_S), "--tune-cache", cache, "--jsonl",
            jl["sweep"]],
        ["stencil2d_iterate", "stencil2d_fused_rdma", "ring_halo"],
        ("TUNE stencil/tier winner=", "TEST dim:0", "TEST dim:1",
         "ITER ERR rel="), peaks)
    cands = [r for r in _jsonl_records(jl["sweep"], "tune")
             if r["knob"] == "stencil/tier"]
    for r in cands:
        log(f"  SWEEP stencil/tier {r['candidate']}: "
            f"{r.get('seconds')} s/timestep {r.get('error', '')}")
        if r.get("skipped") or (r.get("seconds") is None
                                and not r.get("error")):
            raise SmokeFailure(f"{path}: candidate {r['candidate']} was "
                               f"neither measured nor declined: {r}")
    if [r["candidate"] for r in cands] != list(
            H.stencil_tier_candidates("float32")):
        raise SmokeFailure(f"{path}: swept {[r['candidate'] for r in cands]}")
    (result,) = [r for r in _jsonl_records(jl["sweep"], "tune_result")
                 if r["knob"] == "stencil/tier"]
    winner = result["value"]
    stored = tcache.ScheduleCache.load(cache).lookup(
        "stencil/tier", fingerprint(dtype="float32", n=REF_N_LOCAL,
                                    world=1))
    if stored != winner:
        raise SmokeFailure(f"{path}: the cache holds {stored!r}, the sweep "
                           f"chose {winner!r}")
    log(f"TUNE stencil/tier at {REF_N_LOCAL}x{REF_N_OTHER} float32: winner "
        f"{winner} ({result['seconds']} s a timestep)")

    n_blocks = priors.bench_blocks("float32")
    want = iterate_leg_want(winner, it, n_blocks if REF_N_LOCAL % max(
        1, n_blocks) == 0 else 0)
    if winner != "xla":  # --kernel auto: every hand tier maps to hand
        want["stencil2d_deriv"] = derivs
    path = "stencil2d tuned (cache hit)"
    counts[path] = drive_driver(
        path, stencil2d, leg + matrix + [
            "--kernel", "auto", "--tune-cache", cache, "--jsonl",
            jl["hit"]], [n for n, c in want.items() if c],
        ("TUNE stencil/tier cache-hit", f"ITER tier={winner} ",
         "NOTE --kernel auto -> "), peaks)
    if "winner=" in DRIVER_TEXT[path]:
        raise SmokeFailure(f"{path}: swept on a cache hit")
    _exact(path, counts[path], want)

    path = f"stencil2d --iterate-tier {winner} (explicit)"
    counts[path] = drive_driver(
        path, stencil2d, base + [
            "--iterate-tier", winner, "--iterate-steps", "4",
            "--iterate-iters", str(it), "--iterate-only", "--jsonl",
            jl["explicit"]], [], (f"ITER tier={winner} ",), peaks)
    _exact(path, counts[path], iterate_leg_want(winner, it, n_blocks))
    bits = {name: _iterate_bits(jl[name])
            for name in ("sweep", "hit", "explicit")}
    if len(set(bits.values())) != 1:
        raise SmokeFailure(f"the tuned iterate fields differ from the "
                           f"explicit winner's: {bits}")
    log(f"TUNE the tuned runs' iterate field equals the explicit "
        f"{winner} run's bit for bit (bits {bits['explicit']})")

    # the pack round trip, then a run that has only the pack
    pack = os.path.join(tmp, "pack.json")
    fresh = os.path.join(tmp, "imported.json")
    for argv in (["pack", "--cache", cache, "-o", pack],
                 ["import", pack, "--cache", fresh]):
        out = subprocess.run(
            [sys.executable, "-m", "tpu_mpi_tests_torch.tune.pack", *argv],
            capture_output=True, text=True, timeout=120)
        log(f"PACK {' '.join(argv[:1])}: {out.stdout.strip()}")
        if out.returncode:
            raise SmokeFailure(f"tune.pack {argv[0]} failed: {out.stderr}")
    if tcache.ScheduleCache.load(fresh).entries != \
            tcache.ScheduleCache.load(cache).entries:
        raise SmokeFailure("the imported pack differs from its cache")
    path = "stencil2d --tune-pack"
    counts[path] = drive_driver(
        path, stencil2d, leg + [
            "--iterate-only", "--tune-pack", pack, "--tune-cache",
            os.path.join(tmp, "none.json"), "--jsonl", jl["pack"]],
        [], ("TUNE PACK ", "TUNE stencil/tier cache-hit",
             f"ITER tier={winner} "), peaks)
    _exact(path, counts[path], iterate_leg_want(winner, it, n_blocks))
    if _iterate_bits(jl["pack"]) != bits["explicit"]:
        raise SmokeFailure(f"{path}: the iterate field differs")

    # the bench: sweeps on a fresh cache, then the explicit schedule
    os.environ.update({
        "TPU_MPI_BENCH_N": str(BENCH_N),
        "TPU_MPI_BENCH_ITERS_SHORT": str(BENCH_ITERS_SHORT),
        "TPU_MPI_BENCH_ITERS_LONG": str(BENCH_ITERS_LONG),
        "TPU_MPI_BENCH_SAMPLES": str(BENCH_SAMPLES),
        "TPU_MPI_BENCH_TUNE": "1",
        "TPU_MPI_TUNE_CACHE": os.path.join(tmp, "bench.json")})
    recs = {}
    for dtype in ("float32", "bfloat16"):
        path = f"bench {dtype} TPU_MPI_BENCH_TUNE=1"

        def run_tuned():
            err = io.StringIO()
            bench.configure_tuning()
            with contextlib.redirect_stderr(err):
                rec, state = bench.run_dtype(dtype, n=BENCH_N,
                                             device=device)
            return rec, state, err.getvalue()

        (rec, state, err), counts[path] = drive_path(
            path, run_tuned, ["stencil2d_iterate"], peaks)
        sched = [ln for ln in err.splitlines()
                 if ln.startswith("SCHEDULE bench")]
        for line in err.splitlines():
            if line.startswith("{"):
                r = json.loads(line)
                log(f"  SWEEP {r['knob']} {r.get('candidate', '')} "
                    f"{r['kind']} {r.get('value', '')} "
                    f"{r.get('seconds')} {r.get('error', '')}")
        log(f"BENCH TUNE {dtype}: {sched} {json.dumps(rec)}")
        if len(sched) != 1 or "(sweep)" not in sched[0]:
            raise SmokeFailure(f"{path}: no swept schedule: {sched}")
        m = rec["schedule"].split("_")[0]
        S = int(m[len("blocks"):]) if m.startswith("blocks") else 0
        rec2, state2 = bench.measure_schedule(
            dtype, n=BENCH_N, steps=rec["steps"], device=device,
            n_blocks=S, tier=rec["tier"])
        if rec2["schedule"] != rec["schedule"] or \
                not _states_equal(state, state2):
            raise SmokeFailure(f"{path}: the tuned bench's state differs "
                               f"from the explicit schedule's "
                               f"({rec2['schedule']})")
        del state, state2
        os.environ["TPU_MPI_BENCH_TUNE"] = "0"
        bench.configure_tuning()
        again = bench.resolve_schedule(dtype, n=BENCH_N, device=device)
        os.environ["TPU_MPI_BENCH_TUNE"] = "1"
        if again["tier"] != rec["tier"] or again["source"]["tier"] != \
                "cache":
            raise SmokeFailure(f"{path}: the cache does not serve the "
                               f"winner: {again}")
        log(f"BENCH TUNE {dtype}: state equals the explicit "
            f"{rec['schedule']} run bit for bit; cached {again}")
        recs[dtype] = rec
        torch.cuda.empty_cache()
    for var in [v for v in os.environ if v.startswith("TPU_MPI_BENCH_")]:
        del os.environ[var]

    path = "stencil1d --staging auto --tune"
    counts[path] = drive_driver(
        path, stencil1d, ["--device", device.type, "--n-global",
                          str(STENCIL1D_N), "--dtype", "float32",
                          "--staging", "auto", "--tune", "--tune-cache",
                          cache], ["ring_halo"],
        ("TUNE halo/staging winner=", "TUNE halo/staging resolved -> ",
         "err_norm = "), peaks)

    path = "heat2d --kernel auto --overlap auto"
    counts[path] = drive_driver(
        path, heat2d, ["--device", device.type, "--kernel", "auto",
                       "--overlap", "auto", "--mesh", "1,1", "--nx-local",
                       str(GRID_N), "--ny-local", str(GRID_N), "--n-steps",
                       str(HEAT_N_STEPS), "--halo-steps", "1",
                       "--tune-cache", cache], ["heat2d"],
        ("NOTE --kernel auto -> hand (stencil/tier "
         f"{priors.stencil_tier('float32')})",
         "OVERLAP heat2d depth resolved -> 1", "HEAT ERR rel="), peaks)
    _exact(path, counts[path], {"heat2d": HEAT_N_STEPS})

    path = "stencil2d --fused --debug-dump"
    counts[path] = drive_driver(
        path, stencil2d, base + matrix + ["--fused", "--debug-dump"], [],
        ("SKIP dim:0, device, buf:1: --fused supports only",
         "TEST dim:1, device , buf:0; fused=", "DEBUG rank 0 lo ghost+edge:",
         "DEBUG rank 0 hi ghost+edge:"), peaks)
    _exact(path, counts[path], {})
    path = "stencil2d --managed"
    counts[path] = drive_driver(
        path, stencil2d, base + matrix + ["--managed", "--kernel", "hand"],
        ["stencil2d_deriv"], ("TEST dim:0, managed, buf:1;",
                              "TEST dim:1, managed, buf:0; allreduce=",
                              "MEMINFO dim:0, managed, buf:1: allocated "),
        peaks)
    _exact(path, counts[path], {"stencil2d_deriv": 2 * derivs})
    return recs



#: the overlap slice: pipeline rounds at full size, traced heat bodies,
#: and the spin before each traced body of the busy-stream trace (~2 ms)
OVERLAP_ROUNDS = 3
OVERLAP_TRACE_BODIES = 4
OVERLAP_SPIN_CYCLES = 4_000_000
#: JAX's tolerances for a pipeline against its fused serial body
#: (tests/test_overlap.py:91, :158, :192-199): (rtol, atol), and the grid
#: residual's rtol
OVERLAP_TOL = {"jacobi": (1e-6, 1e-12), "heat": (1e-6, 1e-7),
               "grid": (1e-4, 1e-3)}
OVERLAP_RESIDUAL_RTOL = 1e-5


#: the instrument slice: collbench's chain length at 1 MiB (the rows
#: scale it up inversely, to 25600 at 4 KiB), attnbench's chain, the
#: daxpy length and the watchdog child's spin (~0.5 s a launch at the
#: card's ~2 GHz, eight launches queued behind one deadline of 2 s)
INSTR_COLL_N_ITER = 100
INSTR_ATTN_N_ITER = 110
INSTR_DAXPY_N = 1 << 26
WATCHDOG_SPIN_CYCLES = 1_000_000_000
WATCHDOG_DEADLINE_S = 2.0

#: the watchdog child: a deadline that runs out while the main thread
#: waits for queued spin kernels; torch.cuda.synchronize is wrapped so a
#: call from any thread but the main one (the fire's dump) prints a line
WATCHDOG_CHILD = r"""
import sys, threading, torch
from tpu_mpi_tests_torch.instrument import telemetry as T
from tpu_mpi_tests_torch.instrument import watchdog as WD
from tpu_mpi_tests_torch.instrument.report import Reporter
jsonl, cycles, deadline = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
rep = Reporter(jsonl_path=jsonl)
T.enable(sink=rep.jsonl)
real = torch.cuda.synchronize
def synchronize(*a, **k):
    if threading.current_thread() is not threading.main_thread():
        print("SYNC FROM " + threading.current_thread().name,
              file=sys.stderr, flush=True)
    return real(*a, **k)
torch.cuda.synchronize = synchronize
held = torch.ones(1 << 24, device="cuda")
torch.cuda.synchronize()
for i in range(8):
    WD.note_comm_op(f"spin(launch={i}, cycles={cycles})")
    torch.cuda._sleep(cycles)
with WD.deadline(deadline, "spin"):
    torch.cuda.synchronize()
print("UNREACHED")
"""


def _coll_rows(text):
    import re

    from tpu_mpi_tests_torch.drivers import collbench

    return [(r[0], int(r[1]), int(r[4]))
            for r in re.findall(collbench.COLL_LINE_RE, text)]


def _iter_means(text):
    """``{(dim, buf): exchange mean}`` of a stencil2d run's ITER lines."""
    import re

    return {f"dim{d} buf{b}": float(m) for d, b, m in re.findall(
        r"^ITER dim:(\d), device , buf:(\d); exchange mean=(\S+),",
        text, re.M)}


def run_instrument_slice(device, counts, peaks):
    """The instrument spine and the last knob owners on the card, each
    path alone:

    * ``collbench --collectives auto --tune`` at the driver's ladder
      (4 KiB-16 MiB f32) on a fresh cache: a ``tune_result`` per base
      and size and one for ``coll/dispatch_depth`` (priced at the
      smallest size), every candidate measured or declined with its
      reason; the same run again is all ``tune_hit``; each winner run
      explicitly gives the auto run's ``COLL`` rows (name, bytes, chain
      length); the candidates' ring
      and one-shot launches on their routes;
    * ``attnbench --tiers flash,ring --tune`` at L=8192, d=128 in bf16
      ``--fast`` and f32: the ``ring/tier`` records, and no
      ``ring/pipeline_depth`` sweep (the ring clamps the depth to the
      world, 1 here: the world-2 ``coll_tune`` leg sweeps it); the ring
      resolved through that cache equal bit for bit to the explicit
      winner and to depth 1;
    * ``daxpy --iters 64 --tune`` at 2^26: the chunk winner, its ``SUM``
      the untuned run's;
    * ``stencil2d --rdma`` at the reference sizes with ``--telemetry
      --memwatch --jsonl --trace-out --deadline 600``: ``manifest``,
      ``topo``, ``clock_sync`` first, ``span`` records of the exchange
      and the allreduce with seconds > 0, ``mem`` records with the card's
      ``bytes_in_use``, ``telemetry_summary``, a trace the port's
      timeline wrote; its launches and routes exactly those of the
      flagless ``stencil2d --rdma`` path, as are a ``--telemetry
      --jsonl`` run's; the three runs' ``ITER`` exchange means on a line
      of their own (a span's price; nothing gates on it);
    * the same run under ``--debug-nans``: launches and routes exact;
      a NaN in a field stops ``stencil2d_iterate`` and ``halo_exchange``
      with ``FloatingPointError`` naming the op;
    * a child process whose ``--deadline`` runs out while it waits for
      queued spin kernels: it exits 9 after printing the flight recorder
      and the memory state and writing the ``watchdog`` record, and its
      dump never calls ``torch.cuda.synchronize``.

    Returns the collbench winners."""
    import shutil

    import torch

    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.comm import ring as TR
    from tpu_mpi_tests_torch.drivers import attnbench, collbench, daxpy, \
        stencil2d
    from tpu_mpi_tests_torch.instrument import nans
    from tpu_mpi_tests_torch.kernels import hand
    from tpu_mpi_tests_torch.tune import registry as treg

    tmp = tempfile.mkdtemp(prefix="smoke_instr_")
    here = os.path.dirname(os.path.abspath(__file__))
    keep = os.path.join(here, "chiprun_out", "instrument")
    os.makedirs(keep, exist_ok=True)
    ladder = ",".join(str(k) for k in COLLBENCH_SIZES_KIB)

    # collbench --collectives auto --tune, then all cache hits
    cache = os.path.join(tmp, "coll.json")
    jl = os.path.join(tmp, "coll.jsonl")
    base = ["--device", device.type, "--collectives", "auto",
            "--sizes-kib", ladder, "--n-iter", str(INSTR_COLL_N_ITER),
            "--tune", "--tune-budget", str(TUNE_BUDGET_S), "--tune-cache",
            cache]
    path = "collbench --collectives auto --tune"
    counts[path] = drive_driver(
        path, collbench, base + ["--jsonl", jl],
        ["ring_allgather", "ring_reduce_scatter", "oneshot"],
        ("TUNE coll_variant/allreduce winner=",), peaks)
    for name in ("ring_allgather", "ring_reduce_scatter"):
        check_routes(path, name, {"vec16": counts[path][name]})
    check_routes(path, "oneshot", {"vec16": counts[path]["oneshot"]})
    for r in _jsonl_records(jl, "tune"):
        log(f"  SWEEP {r['knob']} {r['candidate']}: {r.get('seconds')} "
            f"{r.get('error', '')}")
        if r.get("skipped") or (r.get("seconds") is None
                                and not r.get("error")):
            raise SmokeFailure(f"{path}: candidate {r} was neither "
                               f"measured nor declined")
    results = _jsonl_records(jl, "tune_result")
    winners = {}
    for r in results:
        if r["knob"].startswith("coll_variant/"):
            winners[(r["knob"].split("/")[1], r["fingerprint"])] = r["value"]
    depth = [r for r in results if r["knob"] == "coll/dispatch_depth"]
    if len(winners) != 2 * len(COLLBENCH_SIZES_KIB) or len(depth) != 1 \
            or len(results) != len(winners) + 1:
        raise SmokeFailure(f"{path}: tune_result records {results}")
    log(f"COLL TUNE coll/dispatch_depth winner {depth[0]['value']} "
        f"({depth[0]['seconds']} s a chain)")
    auto_rows = _coll_rows(DRIVER_TEXT[path])
    path_hit = "collbench --collectives auto --tune (cache hits)"
    counts[path_hit] = drive_driver(path_hit, collbench, base, [],
                                    ("TUNE coll_variant/allreduce "
                                     "cache-hit",),
                                    peaks)
    hit_text = DRIVER_TEXT[path_hit]
    if "winner=" in hit_text or hit_text.count("cache-hit") != \
            len(results):
        raise SmokeFailure(f"{path_hit}: the rerun swept")
    if _coll_rows(hit_text) != auto_rows:
        raise SmokeFailure(f"{path_hit}: rows {_coll_rows(hit_text)} != "
                           f"{auto_rows}")
    explicit_rows = []
    by_name = {}
    for name, nbytes, _ in auto_rows:
        by_name.setdefault(name, []).append(str(nbytes // 1024))
    for name, sizes in by_name.items():
        p = f"collbench {name} (the auto winner)"
        counts[p] = drive_driver(
            p, collbench, ["--device", device.type, "--collectives", name,
                           "--sizes-kib", ",".join(sizes), "--n-iter",
                           str(INSTR_COLL_N_ITER)], [], ("COLL ",), peaks)
        explicit_rows += _coll_rows(DRIVER_TEXT[p])
    if sorted(explicit_rows) != sorted(auto_rows):
        raise SmokeFailure(f"collbench: the explicit winners' rows "
                           f"{explicit_rows} != the auto rows {auto_rows}")
    log(f"COLL TUNE winners {json.dumps({f'{b} {fp}': v for (b, fp), v in winners.items()})}")

    # attnbench --tune, bf16 --fast and f32
    for dtype, fast in (("bfloat16", True), ("float32", False)):
        cache = os.path.join(tmp, f"attn_{dtype}.json")
        jl = os.path.join(tmp, f"attn_{dtype}.jsonl")
        path = f"attnbench --tune {dtype}{' --fast' if fast else ''}"
        counts[path] = drive_driver(
            path, attnbench, ["--device", device.type, "--tiers",
                              "flash,ring", "--seq-len", "8192",
                              "--head-dim", "128", "--dtype", dtype,
                              "--n-iter", str(INSTR_ATTN_N_ITER), "--tune",
                              "--tune-budget", str(TUNE_BUDGET_S),
                              "--tune-cache", cache, "--jsonl", jl]
            + (["--fast"] if fast else []),
            ["flash_attention_block", "fused_ring_attention"],
            ("ATTN flash", "ATTN ring"), peaks)
        got = {r["knob"]: r["value"]
               for r in _jsonl_records(jl, "tune_result")}
        for r in _jsonl_records(jl, "tune"):
            log(f"  SWEEP {dtype} {r['knob']} {json.dumps(r['candidate'])}: "
                f"{r.get('seconds')} {r.get('error', '')}")
        precision = "default" if fast else "highest"
        tdt = getattr(torch, dtype)
        if set(got) != {"ring/tier"}:
            raise SmokeFailure(f"{path}: tune results {got}")
        log(f"ATTN TUNE {dtype} winners {json.dumps(got)}")
        # the ring through that cache == the explicit winner == depth 1
        treg.configure(cache_path=cache)
        try:
            gen = torch.Generator(device=device).manual_seed(20)
            q, k, v = (torch.randn((8192, 128), generator=gen,
                                   device=device).to(tdt) for _ in range(3))
            with hand.matmul_precision(precision):
                outs = [TR.ring_attention_fn(
                    1, flash=True, precision=precision, depth=dp,
                    tier=tier)(q, k, v) for dp, tier in (
                        (None, None), (1, got["ring/tier"]))]
        finally:
            treg.deconfigure()
        if not all(torch.equal(outs[0], o) for o in outs[1:]):
            raise SmokeFailure(f"{path}: the tuned ring differs from the "
                               f"explicit winner")

    # daxpy --iters 64 --tune at 2^26: the chunk winner, the same SUM
    sums = {}
    djl = os.path.join(tmp, "daxpy.jsonl")
    for name, extra in (("daxpy --iters 64", []),
                        ("daxpy --iters 64 --tune", [
                            "--tune", "--tune-cache",
                            os.path.join(tmp, "daxpy.json"), "--jsonl",
                            djl])):
        counts[name] = drive_driver(
            name, daxpy, ["--device", device.type, "--n",
                          str(INSTR_DAXPY_N), "--iters", "64"] + extra, [],
            ("SUM = ",), peaks)
        sums[name] = [ln for ln in DRIVER_TEXT[name].splitlines()
                      if " SUM = " in ln]
    if len(set(map(tuple, sums.values()))) != 1 or \
            "TUNE daxpy/chunk winner=" not in DRIVER_TEXT[name]:
        raise SmokeFailure(f"daxpy --tune: sums {sums}")
    for r in _jsonl_records(djl, "tune"):
        log(f"  SWEEP daxpy/chunk {r['candidate']}: {r.get('seconds')} "
            f"s an application")

    # stencil2d --rdma with the spine's flags, against the flagless path
    argv = stencil2d_rdma_argv(device)
    jl = os.path.join(tmp, "stencil2d.jsonl")
    trace = os.path.join(tmp, "stencil2d.trace.json")
    path = "stencil2d --rdma --telemetry"
    counts[path] = drive_driver(
        path, stencil2d, argv + ["--telemetry", "--memwatch", "--jsonl", jl,
                                 "--trace-out", trace, "--deadline", "600"],
        ["ring_halo", "stencil2d_deriv", "ring_reduce_scatter"],
        ("MANIFEST gpu", "TELEMETRY halo_exchange_rdma :",
         "TELEMETRY allreduce_rdma :", f"TRACE {trace}: "), peaks)
    flagless = "stencil2d --rdma"
    spans_only = "stencil2d --rdma --telemetry (spans only)"
    for p, extra in ((spans_only, ["--telemetry", "--jsonl",
                                   os.path.join(tmp, "spans.jsonl")]),
                     ("stencil2d --rdma --debug-nans", ["--debug-nans"])):
        counts[p] = drive_driver(p, stencil2d, argv + extra, ["ring_halo"],
                                 ("allreduce=",), peaks)
    for p in (path, spans_only, "stencil2d --rdma --debug-nans"):
        if counts[p] != counts[flagless] or \
                ROUTE_COUNTS[p] != ROUTE_COUNTS[flagless]:
            raise SmokeFailure(f"{p}: launches {counts[p]} / routes differ "
                               f"from the flagless run's {counts[flagless]}")
    with open(jl) as f:
        recs = [json.loads(line) for line in f]
    if [r["kind"] for r in recs[:3]] != ["manifest", "topo", "clock_sync"]:
        raise SmokeFailure(f"{path}: the JSONL starts "
                           f"{[r['kind'] for r in recs[:3]]}")
    spans = [r for r in recs if r["kind"] == "span"]
    for op in ("halo_exchange_rdma", "allreduce_rdma"):
        mine = [r for r in spans if r["op"] == op]
        if not mine or not all(r["seconds"] > 0 for r in mine):
            raise SmokeFailure(f"{path}: {op} spans {mine[:2]}")
    mem = [r for r in recs if r["kind"] == "mem"]
    if not mem or not all(r.get("bytes_in_use", 0) > 0 for r in mem):
        raise SmokeFailure(f"{path}: mem records {mem[:2]}")
    if not [r for r in recs if r["kind"] == "telemetry_summary"]:
        raise SmokeFailure(f"{path}: no telemetry_summary")
    with open(trace) as f:
        doc = json.load(f)
    if not any(e["ph"] == "X" for e in doc["traceEvents"]):
        raise SmokeFailure(f"{path}: the trace has no span")
    shutil.copy(jl, keep)
    shutil.copy(trace, keep)
    log(f"SPAN_PRICE ITER exchange mean (s) stencil2d --rdma "
        f"{json.dumps(_iter_means(DRIVER_TEXT[flagless]))}; --telemetry "
        f"--jsonl {json.dumps(_iter_means(DRIVER_TEXT[spans_only]))}; "
        f"with --memwatch --trace-out --deadline too "
        f"{json.dumps(_iter_means(DRIVER_TEXT[path]))}; spans "
        f"{json.dumps({op: [len(v), sum(v) / len(v)] for op, v in _span_seconds(spans).items()})}")

    # --debug-nans: a NaN stops the op that made it
    z = torch.zeros((REF_N_LOCAL + 4, 8192), device=device)
    z[100, 100] = float("nan")
    nans.arm(True)
    try:
        for op, run in (
                ("stencil2d_iterate",
                 lambda: hand.stencil2d_iterate(z, 0.1, dim=0, steps=1)),
                ("halo_exchange",
                 lambda: H.halo_exchange(z, axis=0, periodic=True))):
            try:
                run()
            except FloatingPointError as e:
                if op not in str(e):
                    raise SmokeFailure(f"--debug-nans named {e}") from e
                log(f"DEBUG_NANS {op}: {e}")
            else:
                raise SmokeFailure(f"--debug-nans: {op} did not stop")
    finally:
        nans.arm(False)

    # the watchdog: a child hung in a wait on spin kernels
    wjl = os.path.join(tmp, "watchdog.jsonl")
    child = subprocess.run(
        [sys.executable, "-c", WATCHDOG_CHILD, wjl,
         str(WATCHDOG_SPIN_CYCLES), str(WATCHDOG_DEADLINE_S)], cwd=here,
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": here + os.pathsep
             + os.environ.get("PYTHONPATH", "")})
    for line in child.stderr.splitlines():
        log(f"  WATCHDOG child: {line}")
    wrecs = _jsonl_records(wjl, "watchdog")
    wmem = [r for r in _jsonl_records(wjl, "mem")
            if r.get("event") == "watchdog"]
    if (child.returncode != 9 or "UNREACHED" in child.stdout
            or "WATCHDOG: phase 'spin' exceeded" not in child.stderr
            or "spin(launch=7" not in child.stderr
            or "HBM dev" not in child.stderr
            or "SYNC FROM" in child.stderr or len(wrecs) != 1
            or not wmem or not wmem[0].get("bytes_in_use")):
        raise SmokeFailure(f"watchdog child: rc={child.returncode} "
                           f"records {wrecs} {wmem}\n{child.stderr}")
    log(f"WATCHDOG child exited {child.returncode} after "
        f"{WATCHDOG_DEADLINE_S} s with the flight recorder and the "
        f"memory state, no synchronize in its dump")
    return {f"{b} {fp}": v for (b, fp), v in winners.items()}


def _span_seconds(spans):
    out = {}
    for r in spans:
        out.setdefault(r["op"], []).append(r["seconds"])
    return out


#: the serving slice's published widths (bf16): Mixtral 8x7B's hidden
#: width for the MoE tokens, Llama 3 8B's embedding table, Llama 3 70B's
#: hidden width as the decode all-reduce payload a token
MOE_ARGV = ["--tokens", "8192", "--d-model", "4096", "--dtype", "bfloat16"]
EMBED_ARGV = ["--vocab", "128256", "--d-model", "4096", "--dtype",
              "bfloat16"]
DECODE_HEADS = 8192
DECODE_BATCHES = (1, 8, 32)
DECODE_N_ITER = 2000  # the spec's default chain
DECODE_ARGV = ["--heads", str(DECODE_HEADS), "--batches",
               ",".join(map(str, DECODE_BATCHES)), "--dtype", "bfloat16"]
#: the hand kernel a decode row's variant launches, one a chained call at
#: world 1 (the ring allreduce is one reduce-scatter launch there)
DECODE_KERNEL = {("allreduce", "rdma"): "ring_reduce_scatter",
                 ("allgather", "rdma"): "ring_allgather",
                 ("allreduce", "oneshot"): "oneshot",
                 ("allgather", "oneshot"): "oneshot"}
#: cached hand winners of the third decode run: every hand kernel's
#: rows on the path (coll, batch) -> variant
DECODE_SEEDED = {("allreduce", 1): "rdma", ("allreduce", 8): "oneshot",
                 ("allreduce", 32): "rdma", ("allgather", 1): "oneshot",
                 ("allgather", 8): "rdma", ("allgather", 32): "rdma"}


def decode_row_calls(n_iter: int = DECODE_N_ITER) -> int:
    """Calls of one decode row's chain: ``chain_rate``'s 3 warm calls,
    then n_iter // 10 and n_iter."""
    return 3 + (n_iter // 10 or 1) + n_iter


def decode_sweep_calls(n_iter: int = DECODE_N_ITER) -> int:
    """Calls of one variant's measurement in a decode sweep (collbench's
    ``_measure_chain`` at world 1: one chain pair of max(10, n_iter //
    10))."""
    n_meas = max(10, n_iter // 10)
    return 3 + (n_meas // 10 or 1) + n_meas


def decode_launches(rows, sweeps=()) -> dict:
    """The hand launches of a decode run: ``rows`` the (collective,
    variant) of each DECODE row, ``sweeps`` the (collective, candidate)
    measured by its sweep."""
    want = {}
    for coll, variant in rows:
        k = DECODE_KERNEL.get((coll, variant))
        if k:
            want[k] = want.get(k, 0) + decode_row_calls()
    for coll, cand in sweeps:
        k = DECODE_KERNEL.get((coll, cand))
        if k:
            want[k] = want.get(k, 0) + decode_sweep_calls()
    return want


def _decode_rows(path):
    import re

    from tpu_mpi_tests_torch.workloads import decode

    rows = re.findall(decode.DECODE_LINE_RE, DRIVER_TEXT[path])
    if [(r[0], int(r[2]), r[3]) for r in rows] != [
            (c, b, str(DECODE_HEADS)) for c in ("allreduce", "allgather")
            for b in DECODE_BATCHES]:
        raise SmokeFailure(f"{path}: DECODE rows {rows}")
    return rows


def check_decode_seeded(device, chain: int = 10):
    """Each cached hand winner's row of the seeded decode run, outside
    the counted runs, on seeded integer-valued bf16 shards of batch ×
    heads elements: the row's collective once against the host reference
    (the sum for the allreduce, the concatenation for the allgather: at
    world=1 the shard itself), then the row's chained body
    (``collbench._loop_fn``, ``chain`` iterations) bit for bit against
    the library tier's chain, the one the spec's verify holds against
    the host. Returns the rows checked."""
    import numpy as np
    import torch

    from tpu_mpi_tests_torch.comm import collectives as C
    from tpu_mpi_tests_torch.drivers import collbench as CB

    once = {("allreduce", "rdma"): lambda x: C.allreduce_rdma(x[None])[0],
            ("allreduce", "oneshot"):
                lambda x: C.allreduce_oneshot(x[None])[0],
            ("allgather", "rdma"): C.all_gather_rdma,
            ("allgather", "oneshot"): C.all_gather_oneshot}
    rng = np.random.default_rng(2103)
    done = []
    for (coll, batch), variant in DECODE_SEEDED.items():
        n = batch * DECODE_HEADS
        host = rng.integers(-64, 65, n).astype(np.float32)
        x = torch.from_numpy(host).to(device, torch.bfloat16)
        got = once[(coll, variant)](x)
        # world=1: the sum over one rank and the concatenation of one
        # block are both the shard
        if not np.array_equal(got.float().cpu().numpy(), host):
            raise SmokeFailure(f"decode {coll}[{variant}] batch={batch}: "
                               f"the hand collective differs from the "
                               f"host reference")
        hand_chain = CB._loop_fn(CB.effective_name(coll, variant), 1, 0)(
            x, chain)
        lib_chain = CB._loop_fn(coll, 1, 0)(x, chain)
        if not torch.equal(hand_chain, lib_chain):
            raise SmokeFailure(f"decode {coll}[{variant}] batch={batch}: "
                               f"the {chain}-step chain differs from the "
                               f"library tier's")
        done.append(f"{coll}[{variant}] batch={batch}")
    log(f"CHECK decode seeded rows: {len(done)} hand-winner rows equal "
        f"the host reference once and the library chain over {chain} "
        f"steps, bit for bit: {', '.join(done)}")
    return done


def run_serving_slice(device, counts, peaks):
    """The serving-era workloads and the live plane on the card, each
    path alone, bf16 at published widths:

    * ``moe --tokens 8192 --d-model 4096 --tune`` (Mixtral 8x7B's hidden
      width): both combine hops priced, the winner's 32 routed steps,
      the exact check against the dense reference (the spec's verify);
    * ``embedding --vocab 128256 --d-model 4096 --tune`` (Llama 3 8B's
      table, 1.05 GB on the card): both local gathers priced, lookups
      and scatter-adds exact against the dense reference;
    * ``decode --heads 8192 --batches 1,8,32 --tune`` (Llama 3 70B's
      hidden width) on a fresh cache: every ``coll_variant`` candidate
      measured or declined, then the same run as all cache hits, then on
      a cache seeded with hand winners (``DECODE_SEEDED``), whose rows
      launch the ring and one-shot kernels; each run's ring all-gather,
      ring reduce-scatter and one-shot launches exact, on vec16; each
      seeded row's collective and chain then held against the host and
      the library tier (:func:`check_decode_seeded`);
    * the seeded run again with ``--metrics-port 0 --jsonl``: its
      ``health`` heartbeat trail (a final beat), ``time`` progress
      records, ``/metrics`` scraped while it runs (the decode gauges,
      ``# EOF``), and launches and routes exactly the disarmed run's.

    Returns the rows and winners."""
    import re
    import threading
    import urllib.request

    from tpu_mpi_tests_torch.comm import dist
    from tpu_mpi_tests_torch.tune import cache as tcache
    from tpu_mpi_tests_torch.tune.fingerprint import fingerprint
    from tpu_mpi_tests_torch.workloads import decode, embedding, moe

    tmp = tempfile.mkdtemp(prefix="smoke_serving_")
    base = ["--device", device.type]
    out = {}

    path = "moe --tune"
    jl = os.path.join(tmp, "moe.jsonl")
    counts[path] = drive_driver(
        path, moe, base + MOE_ARGV + [
            "--tune", "--tune-cache", os.path.join(tmp, "moe.json"),
            "--jsonl", jl], [],
        ("TUNE moe/combine winner=", "ROUTE moe: world=1",
         "WORKLOAD moe: us_per_step="), peaks)
    _exact(path, counts[path], {})
    out["moe"] = {"route": _jsonl_records(jl, "route")[-1],
                  "row": _jsonl_records(jl, "workload")[0],
                  "sweep": {r["candidate"]: r.get("seconds")
                            for r in _jsonl_records(jl, "tune")}}

    path = "embedding --tune"
    jl = os.path.join(tmp, "embedding.jsonl")
    counts[path] = drive_driver(
        path, embedding, base + EMBED_ARGV + [
            "--tune", "--tune-cache", os.path.join(tmp, "embed.json"),
            "--jsonl", jl], [],
        ("TUNE embedding/lookup winner=", "EMBED lookup: variant=",
         "EMBED scatter: us_per_op=",
         "WORKLOAD embedding: lookup_us_per_op="), peaks)
    _exact(path, counts[path], {})
    out["embedding"] = {"rows": _jsonl_records(jl, "embed"),
                        "sweep": {r["candidate"]: r.get("seconds")
                                  for r in _jsonl_records(jl, "tune")}}

    # decode --tune on a fresh cache, then all cache hits
    cache = os.path.join(tmp, "decode.json")
    jl = os.path.join(tmp, "decode_tune.jsonl")
    path = "decode --tune"
    counts[path] = drive_driver(
        path, decode, base + DECODE_ARGV + [
            "--tune", "--tune-budget", str(TUNE_BUDGET_S), "--tune-cache",
            cache, "--jsonl", jl],
        ["ring_allgather", "ring_reduce_scatter", "oneshot"],
        ("TUNE coll_variant/allreduce winner=",
         "WORKLOAD decode: allreduce_us_per_op="), peaks)
    rows = _decode_rows(path)
    sweeps = []
    for r in _jsonl_records(jl, "tune"):
        log(f"  SWEEP {r['knob']} {r['candidate']}: {r.get('seconds')} "
            f"{r.get('error', '')}")
        if r.get("skipped") or (r.get("seconds") is None
                                and not r.get("error")):
            raise SmokeFailure(f"{path}: candidate {r} was neither "
                               f"measured nor declined")
        if r.get("seconds") is not None:
            sweeps.append((r["knob"].split("/")[1], r["candidate"]))
    _exact(path, counts[path], decode_launches(
        [(r[0], r[1]) for r in rows], sweeps))
    for name in ROUTED_COLLECTIVES:
        check_routes(path, name, {"vec16": counts[path][name]})
    out["decode tune"] = [r for r in _jsonl_records(jl, "decode")]
    path_hit = "decode --tune (cache hits)"
    counts[path_hit] = drive_driver(
        path_hit, decode, base + DECODE_ARGV + [
            "--tune", "--tune-cache", cache], [],
        ("TUNE coll_variant/allreduce cache-hit",), peaks)
    hit_rows = _decode_rows(path_hit)
    if "winner=" in DRIVER_TEXT[path_hit] or \
            [r[1] for r in hit_rows] != [r[1] for r in rows]:
        raise SmokeFailure(f"{path_hit}: swept, or ran {hit_rows} where "
                           f"the sweep ran {rows}")
    _exact(path_hit, counts[path_hit],
           decode_launches([(r[0], r[1]) for r in hit_rows]))

    # a cache holding hand winners: the rows launch the ring and one-shot
    # kernels; then the same run armed with the live plane
    dist.init(device.type)
    seeded = os.path.join(tmp, "seeded.json")
    sc = tcache.ScheduleCache(seeded)
    for (coll, batch), variant in DECODE_SEEDED.items():
        sc.store(f"coll_variant/{coll}", fingerprint(
            dtype="bfloat16", bytes=batch * DECODE_HEADS * 2, world=1),
            variant)
    sc.save()
    path_seed = "decode (cached hand winners)"
    argv = base + DECODE_ARGV + ["--tune-cache", seeded]
    counts[path_seed] = drive_driver(
        path_seed, decode, argv,
        ["ring_allgather", "ring_reduce_scatter", "oneshot"],
        ("TUNE coll_variant/allgather cache-hit",), peaks)
    seed_rows = _decode_rows(path_seed)
    if [r[1] for r in seed_rows] != [
            DECODE_SEEDED[(c, b)] for c in ("allreduce", "allgather")
            for b in DECODE_BATCHES]:
        raise SmokeFailure(f"{path_seed}: rows {seed_rows}")
    _exact(path_seed, counts[path_seed],
           decode_launches([(r[0], r[1]) for r in seed_rows]))
    for name in ROUTED_COLLECTIVES:
        check_routes(path_seed, name, {"vec16": counts[path_seed][name]})
    out["decode seeded check"] = check_decode_seeded(device)

    path_live = "decode (cached hand winners) --metrics-port 0"
    jl = os.path.join(tmp, "live.jsonl")
    scraped, stop, live_out = [], threading.Event(), io.StringIO()

    def scrape():
        # the exporter's port, once the run prints it; then scrape until
        # the run ends, keeping every body
        while not stop.is_set():
            m = re.search(r"METRICS rank 0: OpenMetrics at http://"
                          r"0\.0\.0\.0:(\d+)/metrics", live_out.getvalue())
            if m:
                try:
                    with urllib.request.urlopen(
                            f"http://127.0.0.1:{m.group(1)}/metrics",
                            timeout=5) as r:
                        scraped.append(r.read().decode())
                except OSError:
                    pass
            stop.wait(0.2)

    scraper = threading.Thread(target=scrape, daemon=True)
    scraper.start()
    try:
        counts[path_live] = drive_driver(
            path_live, decode, argv + ["--metrics-port", "0",
                                       "--metrics-interval", "0.2",
                                       "--jsonl", jl],
            ["ring_allgather", "ring_reduce_scatter", "oneshot"],
            ("METRICS rank 0: OpenMetrics at",), peaks, stdout=live_out)
    finally:
        stop.set()
        scraper.join(timeout=10)
    if counts[path_live] != counts[path_seed] or \
            ROUTE_COUNTS[path_live] != ROUTE_COUNTS[path_seed]:
        raise SmokeFailure(f"{path_live}: launches {counts[path_live]} / "
                           f"routes differ from the disarmed run's "
                           f"{counts[path_seed]}")
    beats = [r for r in _jsonl_records(jl, "health")
             if r.get("event") == "heartbeat"]
    progress = [r for r in _jsonl_records(jl, "time")
                if r.get("event") == "progress"]
    full = [s for s in scraped if "tpumt_decode_us_per_op" in s]
    if not beats or beats[-1].get("final") is not True or not progress \
            or not scraped or not all(s.endswith("# EOF\n")
                                      for s in scraped):
        raise SmokeFailure(f"{path_live}: heartbeats {beats[-2:]}, "
                           f"{len(progress)} progress records, "
                           f"{len(scraped)} scrapes")
    log(f"LIVE {len(beats)} heartbeats (final seq {beats[-1]['seq']}, "
        f"{beats[-1].get('records')} records), {len(progress)} progress "
        f"records, {len(scraped)} /metrics scrapes "
        f"({len(full)} with the decode gauges); last scrape:")
    for line in scraped[-1].splitlines():
        if line.startswith(("tpumt_decode", "tpumt_records",
                            "tpumt_phase", "tpumt_health")):
            log(f"  {line}")
    out["decode seeded"] = _jsonl_records(jl, "decode")
    out["live"] = {"heartbeats": len(beats), "progress": len(progress),
                   "scrapes": len(scraped),
                   "scrapes_with_decode": len(full)}
    return out


#: the serve slice's mix at the earlier slices' widths: decode at Llama 3
#: 70B's hidden width (batch 32), moe at Mixtral 8x7B's, embedding at
#: Llama 3 8B's table (batch 256), attn at attnbench's L and d, halo at
#: stencil1d's 32 Mi, daxpy at 2^26, a 4 Mi bf16 allreduce
SERVE_TABLE = ("decode:32x8192:bfloat16:4,moe:8192x4096:bfloat16:1,"
               "embedding:128256x256x4096:bfloat16:1,"
               "attn:8192x128:bfloat16:1,halo:33554432:float32:2,"
               "daxpy:67108864:float32:2,allreduce:4194304:bfloat16:1")
SERVE_DECODE, SERVE_DECODE_SHAPE = "decode:32x8192:bfloat16", (32, 8192)
SERVE_HALO, SERVE_HALO_N = "halo:33554432:float32", STENCIL1D_N
#: seconds of traffic a run: the seeded open-loop run, the others
SERVE_OPEN_S, SERVE_RUN_S = 8.0, 5.0
SERVE_RATE = 200.0
SERVE_CONCURRENCY = 8
SERVE_SWAPS = 20
#: the hand kernel a decode handler's variant launches, once a request
#: (world 1: the ring allreduce is one reduce-scatter launch)
SERVE_DECODE_KERNEL = {"torch": None, "rdma": "ring_reduce_scatter",
                       "oneshot": "oneshot"}


@contextlib.contextmanager
def captured_handlers():
    """Keep every handler the serve driver builds (by workload name), so
    its state can be held against the plain version after the run."""
    from tpu_mpi_tests_torch.drivers import _common

    real, built = _common.workload_factory, {}

    def factory(name):
        make = real(name)

        def build(device, shape, dtype):
            step = make(device, shape, dtype)
            built[name] = step
            return step
        return build

    _common.workload_factory = factory
    try:
        yield built
    finally:
        _common.workload_factory = real


def serve_summaries(jl):
    """The run's per-class summary records, by class key."""
    return {r["class"]: r for r in _jsonl_records(jl, "serve")
            if r.get("event") == "summary"}


def serve_rows(path):
    """The SERVE lines of a driver path, parsed with the driver's
    pattern; fails unless every class served with no error and no
    shed."""
    import re

    from tpu_mpi_tests_torch.drivers import serve

    rows = {}
    for m in re.finditer(serve.SERVE_LINE_RE, DRIVER_TEXT[path]):
        g = m.groups()
        rows[g[0]] = {"offered_hz": float(g[1]), "achieved_hz": float(g[2]),
                      "n": int(g[3]), "err": int(g[4]), "shed": int(g[5]),
                      **{k: None if v == "-" else float(v) for k, v in
                         zip(("p50_ms", "p95_ms", "p99_ms"), g[6:9])},
                      "qmax": int(g[9])}
    lines = [ln for ln in DRIVER_TEXT[path].splitlines()
             if ln.startswith("SERVE ") and not ln.startswith(
                 "SERVE TRAFFIC")]
    keys = [c.split(":")[0] + ":" + ":".join(c.split(":")[1:3])
            for c in SERVE_TABLE.split(",")]
    if len(lines) != len(keys) or set(rows) != set(keys):
        raise SmokeFailure(f"{path}: SERVE lines {lines} do not parse "
                           f"as one a class of {keys}")
    for key, r in rows.items():
        if r["err"] or r["shed"] or not r["n"]:
            raise SmokeFailure(f"{path}: {key} served {r}")
    return rows


def serve_launches(path, counts, summaries, seeded: bool):
    """Exact hand launches of a serve run: seeded, one ``ring_halo``
    (scalar route: the 1-D field) a halo request and one ``oneshot``
    (vec16) a decode request, each plus the handler's warm call, and
    nothing else; with the cache removed, none at all."""
    if not seeded:
        _exact(path, counts, {})
        return {}
    want = {"ring_halo": 1 + summaries[SERVE_HALO]["requests"],
            "oneshot": 1 + summaries[SERVE_DECODE]["requests"]}
    _exact(path, counts, want)
    check_routes(path, "ring_halo", {"scalar": want["ring_halo"]})
    check_routes(path, "oneshot", {"vec16": want["oneshot"]})
    return want


def check_serve_state(path, built, summaries):
    """The halo handler's field against the plain version of the ring
    halo kernel applied once to the handler's initial field (the
    exchange is idempotent), and the decode buffer against the library
    tier's allreduce chain on ones at the handler's call count (its warm
    call and every request served; the identity at world 1), both bit
    for bit."""
    import torch

    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.drivers import collbench as CB

    halo = built["halo"]
    if halo.staging is not H.Staging.PALLAS_RDMA:
        raise SmokeFailure(f"{path}: the halo class ran {halo.staging}")
    plain = H.halo_exchange(halo.field().cpu(), 0, 2, False,
                            H.Staging.PALLAS_RDMA)
    if not torch.equal(halo.state["z"].cpu(), plain):
        raise SmokeFailure(f"{path}: the halo field differs from the "
                           f"plain exchange")
    decode = built["decode"]
    if decode.tune_info["variant"] != "oneshot":
        raise SmokeFailure(f"{path}: decode ran {decode.tune_info}")
    x = decode.state["x"]
    calls = 1 + summaries[SERVE_DECODE]["requests"]
    want = CB._loop_fn("allreduce", 1, 0)(torch.ones_like(x), calls)
    if not torch.equal(x, want):
        raise SmokeFailure(f"{path}: the decode buffer differs from the "
                           f"plain allreduce chain")


def serve_retune(device, tmp):
    """(e) the re-tune path on the card: the decode handler built at
    ``torch``; SERVE_SWAPS times, one ``tune_stale`` record for its op
    and a window boundary: the controller re-sweeps the three variants
    (each candidate a rebuilt, warmed handler timed over a probe batch),
    writes one ``tune_swap`` and hot-swaps; the launches of the re-sweep
    and of the swapped handler's next batch are exact on their routes,
    and the allocated memory after the last swap is within one
    workspace (the one-shot kernel's comm slot, a shard's bytes) of its
    value after the first."""
    import torch

    from tpu_mpi_tests_torch.drivers import _common
    from tpu_mpi_tests_torch.instrument.metrics import MetricsRegistry
    from tpu_mpi_tests_torch.kernels import hand
    from tpu_mpi_tests_torch.tune import controller as Ctl
    from tpu_mpi_tests_torch.tune import registry as treg

    treg.configure(cache_path=os.path.join(tmp, "retune.json"),
                   enabled=True, budget_s=TUNE_BUDGET_S)
    try:
        records = []
        reg = MetricsRegistry()
        reg.set_health_sink(lambda r: (records.append(r), reg.observe(r)))
        step = _common.workload_factory("decode")(
            device, SERVE_DECODE_SHAPE, "bfloat16")
        if step.tune_info["variant"] != "torch":
            raise SmokeFailure(f"serve retune: built {step.tune_info}")
        handlers = {SERVE_DECODE: step}
        ctl = Ctl.TuneController(reg, handlers, sink=records.append,
                                 line=log, budget_s=TUNE_BUDGET_S)
        shard_bytes = SERVE_DECODE_SHAPE[0] * SERVE_DECODE_SHAPE[1] * 2
        probe = 1 + Ctl.PROBE_REQUESTS  # a candidate's warm call + probe
        mem, winners = [], []
        for i in range(SERVE_SWAPS):
            reg.emit_health({
                "kind": "health", "event": "tune_stale",
                "op": f"serve:{SERVE_DECODE}", "signal": "gbps",
                "baseline": 1.0, "rolling": 0.5, "sag_pct": 50.0,
                "threshold_pct": 15.0, "n": 8,
                "knobs": ["coll_variant/allreduce"], "t": time.time()})
            hand.reset_launch_counts()
            if ctl.window_boundary(time.time()) != 1:
                raise SmokeFailure(f"serve retune: swap {i} did not happen")
            sweep_counts = hand.launch_counts()
            new = handlers[SERVE_DECODE]
            winner = new.tune_info["variant"]
            kernel = SERVE_DECODE_KERNEL[winner]
            want = {"ring_reduce_scatter": probe, "oneshot": probe}
            if kernel:
                want[kernel] += 1  # the swapped handler's warm call
            _exact(f"serve retune swap {i} re-sweep", sweep_counts, want)
            hand.reset_launch_counts()
            new(1)
            _exact(f"serve retune swap {i} next batch", hand.launch_counts(),
                   {kernel: 1} if kernel else {})
            routes = hand.route_counts()
            for name in ("ring_reduce_scatter", "oneshot"):
                n = 1 if name == kernel else 0
                got = routes[name]
                if got != dict.fromkeys(got, 0) | ({"vec16": n} if n
                                                   else {}):
                    raise SmokeFailure(f"serve retune swap {i}: {name} "
                                       f"routes {got}")
            winners.append(winner)
            mem.append(torch.cuda.memory_allocated(device))
        swaps = [r for r in records if r.get("kind") == "control"]
        if len(swaps) != SERVE_SWAPS:
            raise SmokeFailure(f"serve retune: {len(swaps)} tune_swap "
                               f"records for {SERVE_SWAPS} swaps")
        if abs(mem[-1] - mem[0]) > shard_bytes:
            raise SmokeFailure(f"serve retune: allocated {mem[0]} bytes "
                               f"after the first swap, {mem[-1]} after "
                               f"the last (one workspace: {shard_bytes})")
        resweep = [r["resweep_s"] for r in swaps]
        log("SERVE_RETUNE " + json.dumps({
            "winners": winners, "resweep_s": resweep,
            "allocated_first": mem[0], "allocated_last": mem[-1],
            "workspace_bytes": shard_bytes,
            "candidate_seconds": [[r["candidate"], r.get("seconds")]
                                  for r in records
                                  if r.get("kind") == "tune"]}))
        return {"winners": winners, "resweep_s": resweep,
                "allocated": [mem[0], mem[-1]]}
    finally:
        treg.deconfigure()


def run_serve_slice(device, counts, peaks):
    """Serving mode on the card (``drivers/serve.main``), the
    :data:`SERVE_TABLE` mix, each run a main path with its counts zeroed
    just before and read just after:

    (a) open-loop Poisson at SERVE_RATE req/s, ``--seed 0``, on a cache
    seeded with ``halo/staging = pallas`` and ``coll_variant/allreduce =
    oneshot`` for the halo and decode classes' contexts: every class
    serves with err=0, every SERVE line parses with the driver's pattern;
    (b) its launches exact — ``ring_halo`` 1 + the halo class's requests
    (scalar route), ``oneshot`` 1 + the decode class's (vec16), nothing
    else — then the same mix with the cache removed, launching no hand
    kernel (priors ``direct`` and ``torch``); both printed as
    ``SERVE_LAUNCHES``; (c) after (a), the halo field and the decode
    buffer against their plain versions, bit for bit; (d) a recorded run
    replayed: the same per-class arrivals and fingerprint, the manifest
    carrying it; (e) the re-tune path (:func:`serve_retune`); (f) a
    closed loop at concurrency SERVE_CONCURRENCY. Each class's achieved
    rate and p50/p95/p99 go out as ``SERVE_ROWS``. No run has
    ``--telemetry`` on (a span waits for the whole device)."""
    import torch

    from tpu_mpi_tests_torch.comm import dist
    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.drivers import serve
    from tpu_mpi_tests_torch.serve import replay as R
    from tpu_mpi_tests_torch.tune import cache as tcache
    from tpu_mpi_tests_torch.tune.fingerprint import fingerprint

    # the fingerprints name the world's device: join it before seeding
    dist.init(device.type)
    tmp = tempfile.mkdtemp(prefix="smoke_serve_")
    seeded = os.path.join(tmp, "seeded.json")
    sc = tcache.ScheduleCache(seeded)
    sc.store("halo/staging", fingerprint(**H._staging_context(
        torch.empty(SERVE_HALO_N + 4, dtype=torch.float32, device="meta"),
        0, 1)), "pallas")
    sc.store("coll_variant/allreduce", fingerprint(
        dtype="bfloat16", bytes=SERVE_DECODE_SHAPE[0] * SERVE_DECODE_SHAPE[1]
        * 2, world=1), "oneshot")
    sc.save()
    base = ["--device", device.type, "--workloads", SERVE_TABLE,
            "--seed", "0", "--report-interval", "1"]
    out = {"rows": {}, "launches": {}}

    def run(path, argv, cache, seeded_run):
        jl = os.path.join(tmp, "".join(c if c.isalnum() else "_"
                                       for c in path) + ".jsonl")
        with captured_handlers() as built:
            counts[path] = drive_driver(
                path, serve, base + argv + ["--tune-cache", cache,
                                            "--jsonl", jl],
                ["ring_halo", "oneshot"] if seeded_run else [],
                ("serve: 7 handlers warmed",), peaks)
        rows = serve_rows(path)
        summaries = serve_summaries(jl)
        for key, row in rows.items():
            # the latency's split: queue delay (arrival to dispatch) and
            # service (dispatch to the card's completion)
            row.update({k: summaries[key].get(k) for k in (
                "qd_p50_ms", "qd_p99_ms", "svc_p50_ms", "svc_p99_ms")})
        out["launches"][path] = serve_launches(path, counts[path],
                                               summaries, seeded_run)
        out["rows"][path] = rows
        return jl, summaries, built

    path = f"serve poisson {SERVE_RATE:g}/s (seeded cache)"
    _, summaries, built = run(path, ["--duration", str(SERVE_OPEN_S),
                                     "--arrival", "poisson", "--rate",
                                     str(SERVE_RATE)], seeded, True)
    check_serve_state(path, built, summaries)
    log(f"CHECK {path}: the halo field and the decode buffer equal their "
        f"plain versions bit for bit")
    del built
    path = f"serve poisson {SERVE_RATE:g}/s (no cache)"
    run(path, ["--duration", str(SERVE_RUN_S), "--arrival", "poisson",
               "--rate", str(SERVE_RATE)],
        os.path.join(tmp, "absent.json"), False)
    log(f"SERVE_LAUNCHES {json.dumps(out['launches'])}")

    art = os.path.join(tmp, "traffic.json")
    path = "serve --record"
    _, rec_sum, _ = run(path, ["--duration", str(SERVE_RUN_S), "--rate",
                               str(SERVE_RATE), "--record", art],
                        seeded, True)
    artifact = R.load_traffic(art)
    path = "serve --replay"
    jl, rep_sum, _ = run(path, ["--replay", art], seeded, True)
    offered = {k: r["arrivals"] for k, r in rep_sum.items()}
    manifest = _jsonl_records(jl, "manifest")[0]
    if (offered != artifact["classes"]
            or offered != {k: r["arrivals"] for k, r in rec_sum.items()}
            or manifest.get("traffic_fingerprint")
            != artifact["fingerprint"]
            or f"fingerprint={artifact['fingerprint']}"
            not in DRIVER_TEXT[path]):
        raise SmokeFailure(f"serve replay: offered {offered}, recorded "
                           f"{artifact['classes']}, manifest "
                           f"{manifest.get('traffic_fingerprint')} for "
                           f"{artifact['fingerprint']}")
    log(f"SERVE_REPLAY fingerprint {artifact['fingerprint']} count "
        f"{artifact['count']} classes {json.dumps(offered)}")
    out["replay"] = {"fingerprint": artifact["fingerprint"],
                     "count": artifact["count"]}

    out["retune"] = serve_retune(device, tmp)

    path = f"serve closed concurrency={SERVE_CONCURRENCY}"
    jl, closed, _ = run(path, ["--duration", str(SERVE_RUN_S), "--arrival",
                               "closed", "--concurrency",
                               str(SERVE_CONCURRENCY)], seeded, True)
    total = sum(r["requests"] for r in closed.values())
    span = max(r["duration_s"] for r in closed.values())
    out["closed_total_hz"] = total / span
    log(f"SERVE_CLOSED {total} requests in {span:.6g} s: "
        f"{total / span:.6g} req/s at concurrency {SERVE_CONCURRENCY}")
    log(f"SERVE_ROWS {json.dumps(out['rows'])}")
    return out


# ---------------------------------------------------------------------------
# the chaos slice: faults injected on the card, the organic records saved
# ---------------------------------------------------------------------------

#: the chaos legs' JSONL, standard output and errors, kept for the JAX
#: tpumt-doctor (which runs where the JAX package is installed)
CHAOS_DIR = os.path.join("chiprun_out", "chaos")
#: the legs' daxpy size and the wedge leg's watchdog deadline (seconds)
CHAOS_DAXPY_N = N26
CHAOS_DEADLINE_S = 6
#: the kill leg's daxpy steps: ~0.37 ms each on the card, so the
#: survivor records ~1.8 s past the death (the doctor's gap is 1 s)
CHAOS_KILL_ITERS = 5000
#: the queue ramp's burst: several 0.5 s SLO windows of backlog at the
#: daxpy class's ~0.3-0.4 ms a request (the serve slice's service split)
CHAOS_RAMP_BURST = 8000
#: stripebalance's two chained runs a cell (``chain_rate`` adds 3 warm
#: calls) and its queued calls (after one warm call)
STRIPE_CHAIN = (30, 330)
STRIPE_QUEUED = 20
#: the group's ring and blocks (its defaults: the JAX group's)
STRIPE_SHAPE = {"w": 8, "lq": 4096, "d": 128}
#: the blocks schedule's field side in the world-of-one check
CHAOS_BLOCKS_N = 8192


def _chaos_env(chaos=None):
    env = dict(os.environ)
    env.pop("TPU_MPI_CHAOS", None)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    if chaos is not None:
        env["TPU_MPI_CHAOS"] = chaos
    return env


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _leg_records(path):
    with open(path) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


def chaos_leg(name, argv, chaos, want, timeout=180, world=1):
    """Run one chaos leg: ``python argv`` with ``TPU_MPI_CHAOS=chaos``, as
    ``world`` processes on this card (rank r's RANK/WORLD_SIZE/LOCAL_RANK
    set, the rendezvous on a free local port); each process's output to
    CHAOS_DIR/<name>[.r<r>].{out,err}. Fails unless process r exits
    ``want[r]`` (``want`` an int for every rank). Returns each process's
    (stdout, stderr)."""
    wants = [want] * world if isinstance(want, int) else list(want)
    port = _free_port()
    procs, files = [], []
    t0 = time.perf_counter()
    for r in range(world):
        env = _chaos_env(chaos)
        if world > 1:
            env.update({"RANK": str(r), "WORLD_SIZE": str(world),
                        "LOCAL_RANK": str(r), "MASTER_ADDR": "127.0.0.1",
                        "MASTER_PORT": str(port)})
        tag = name if world == 1 else f"{name}.r{r}"
        out = open(os.path.join(CHAOS_DIR, f"{tag}.out"), "w")
        err = open(os.path.join(CHAOS_DIR, f"{tag}.err"), "w")
        files.append((out, err))
        procs.append(subprocess.Popen([sys.executable, *argv], env=env,
                                      stdout=out, stderr=err,
                                      cwd=os.path.dirname(
                                          os.path.abspath(__file__))))
    rcs = []
    try:
        for p in procs:
            rcs.append(p.wait(timeout=max(1.0, timeout - (
                time.perf_counter() - t0))))
    except subprocess.TimeoutExpired:
        raise SmokeFailure(f"chaos {name}: no exit in {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in files:
            out.close()
            err.close()
    seconds = time.perf_counter() - t0
    texts = []
    for r in range(world):
        tag = name if world == 1 else f"{name}.r{r}"
        with open(os.path.join(CHAOS_DIR, f"{tag}.out")) as f:
            o = f.read()
        with open(os.path.join(CHAOS_DIR, f"{tag}.err")) as f:
            e = f.read()
        texts.append((o, e))
    if rcs != wants:
        tails = " | ".join(e[-600:] for _, e in texts)
        raise SmokeFailure(f"chaos {name}: exit codes {rcs}, want {wants}: "
                           f"{tails}")
    log(f"CHAOS leg {name}: exit {rcs} in {seconds:.1f} s")
    return texts


def _audit(name, recs, fault):
    """The leg's ``kind: "chaos"`` audit records: one ``armed`` of
    ``fault`` and one ``fire``; returns the fire record, with the seconds
    from arming to firing added as ``armed_to_fire_s``."""
    chaos = [r for r in recs if r.get("kind") == "chaos"]
    events = [(r["event"], r["fault"]) for r in chaos]
    want = [("armed", fault), ("fire", fault)]
    if events != want:
        raise SmokeFailure(f"chaos {name}: audit records {events}, want "
                           f"{want}")
    return {**chaos[1], "armed_to_fire_s": chaos[1]["t"] - chaos[0]["t"]}


DUMP_RE = re.compile(r"comm ops \(newest last\):\n((?:\s+.*\n)+?)"
                     r"\s+(?:memory at fire:|aborting)")


def chaos_wedge(device):
    """stencil1d at 32 Mi float32 through ``ring_halo`` (``--staging
    pallas``), the overlap engine at depth 1, a wedge at the third
    ``halo_exchange*`` span: the watchdog ends it (exit 9), after the
    dispatch note and with no span closing after it; its dump's comm ops
    are the JSONL's tail."""
    jl = os.path.join(CHAOS_DIR, "wedge.jsonl")
    texts = chaos_leg(
        "wedge", ["-m", "tpu_mpi_tests_torch.drivers.stencil1d",
                  "--device", device.type, "--n-global", str(STENCIL1D_N), "--staging", "pallas",
                  "--overlap", "1", "--overlap-iters", "12", "--telemetry",
                  "--deadline", str(CHAOS_DEADLINE_S), "--jsonl", jl],
        "wedge:op=halo_exchange:after=3", 9, timeout=200)
    err = texts[0][1]
    recs = _leg_records(jl)
    fire = _audit("wedge", recs, "wedge")
    disp = [r for r in recs if r.get("kind") == "dispatch"
            and str(r.get("note", "")).startswith("chaos:wedge")]
    wd = [r for r in recs if r.get("kind") == "watchdog"]
    if "WATCHDOG" not in err or len(disp) != 1 or len(wd) != 1:
        raise SmokeFailure(f"wedge: WATCHDOG in stderr "
                           f"{'WATCHDOG' in err}, {len(disp)} wedge "
                           f"dispatch notes, {len(wd)} watchdog records")
    t_d, t_w = disp[0]["t"], wd[0]["t"]
    late = [r for r in recs if r.get("kind") == "span"
            and r.get("t_end", 0) > t_d]
    rdma = [r for r in recs if r.get("kind") == "span"
            and r.get("op") == "halo_exchange_rdma"]
    if late or t_w < t_d or not rdma:
        raise SmokeFailure(f"wedge: {len(late)} spans closed after the "
                           f"wedge, watchdog {t_w - t_d:+.3f} s after it, "
                           f"{len(rdma)} ring_halo exchange spans")
    m = DUMP_RE.search(err)
    if m is None:
        raise SmokeFailure("wedge: no comm ops in the watchdog's dump")
    dumped = [ln.strip().split()[0] for ln in m.group(1).strip().splitlines()]
    stream = [r.get("op") if r["kind"] == "span" else r.get("note")
              for r in recs if r.get("kind") in ("span", "dispatch")]
    if dumped != [s.split()[0] for s in stream[-len(dumped):]]:
        raise SmokeFailure(f"wedge: the watchdog's dump {dumped} is not the "
                           f"JSONL's tail")
    return {"exit": 9, "dispatch_to_watchdog_s": t_w - t_d,
            "armed_to_fire_s": fire["armed_to_fire_s"],
            "ring_halo_spans": len(rdma), "dump_events": len(dumped)}


def _mem_ramp(name, recs):
    """The card's ``mem`` records of an oom leg: the phase records'
    ``bytes_in_use``, which must climb, and the card's ``bytes_limit``."""
    mem = [r for r in recs if r.get("kind") == "mem"]
    phase = [r["bytes_in_use"] for r in mem if r.get("event") == "phase"]
    limits = {d.get("bytes_limit") for r in mem
              for d in r.get("devices", {}).values()} - {None}
    if len(phase) < 2 or phase != sorted(phase) or len(limits) != 1 \
            or any(r.get("event") == "final" for r in mem):
        raise SmokeFailure(f"{name}: phase bytes_in_use {phase}, limits "
                           f"{limits}, a final record "
                           f"{any(r.get('event') == 'final' for r in mem)}")
    return phase, limits.pop(), max(r.get("bytes_in_use", 0) for r in mem)


def chaos_oom(device, name, chaos, iters, n):
    """The daxpy spec at ``n`` float32 under ``--memwatch`` with an oom
    ramp: exit 134, the ballast's bytes in the allocator's counters."""
    jl = os.path.join(CHAOS_DIR, f"{name}.jsonl")
    chaos_leg(name, ["-m", "tpu_mpi_tests_torch.drivers.daxpy", "--device",
                     device.type, "--n", str(n), "--iters", str(iters),
                     "--telemetry", "--memwatch", "--mem-interval", "0.05",
                     "--jsonl", jl], chaos, 134)
    recs = _leg_records(jl)
    fire = _audit(name, recs, "oom")
    phase, limit, peak = _mem_ramp(name, recs)
    return {"exit": 134, "armed_to_fire_s": fire["armed_to_fire_s"],
            "phase_bytes_in_use": phase, "peak_bytes_in_use": peak,
            "bytes_limit": limit}


def _serve_leg_argv(device):
    return ["-m", "tpu_mpi_tests_torch.drivers.serve", "--device",
            device.type, "--arrival", "poisson", "--rate", "20", "--seed",
            "7", "--workloads", f"daxpy:{CHAOS_DAXPY_N}:float32"]


def _serve_summary(jl):
    recs = _leg_records(jl)
    (summary,) = [r for r in recs if r.get("kind") == "serve"
                  and r.get("event") == "summary"]
    return recs, summary


def chaos_flood(device):
    """``drivers/serve.py`` on the daxpy 2^26 class: a 300-request flood
    into a 32-deep queue sheds (exit 1)."""
    jl = os.path.join(CHAOS_DIR, "flood.jsonl")
    chaos_leg("flood", _serve_leg_argv(device) + [
        "--duration", "4", "--report-interval", "1", "--max-queue", "32",
        "--telemetry", "--jsonl", jl], "flood:burst=300:after=1", 1)
    recs, summary = _serve_summary(jl)
    _audit("flood", recs, "flood")
    if not summary["shed"] > 0:
        raise SmokeFailure(f"flood: no shed in {summary}")
    return {"flood": {"exit": 1, "shed": summary["shed"],
                      "arrivals": summary["arrivals"]}}


def chaos_ramp(device):
    """An 8000-request flood into an unbounded queue builds a backlog
    over several SLO windows with no shed, recorded; the recording
    replayed with chaos disarmed offers the same arrivals."""
    ramp = ["--duration", "3", "--report-interval", "0.5", "--max-queue",
            "100000", "--max-batch", "2"]
    art = os.path.join(CHAOS_DIR, "ramp.traffic.json")
    out = {}
    for leg, extra, chaos in (
            ("ramp", ["--record", art],
             f"flood:burst={CHAOS_RAMP_BURST}:after=1"),
            ("ramp_replay", ["--replay", art], None)):
        jl = os.path.join(CHAOS_DIR, f"{leg}.jsonl")
        chaos_leg(leg, _serve_leg_argv(device) + ramp + extra
                  + ["--jsonl", jl], chaos, 0, timeout=240)
        recs, summary = _serve_summary(jl)
        if chaos:
            _audit(leg, recs, "flood")
        elif any(r.get("kind") == "chaos" for r in recs):
            raise SmokeFailure(f"{leg}: chaos records in a disarmed run")
        windows = [r for r in recs if r.get("kind") == "serve"
                   and r.get("event") == "window"]
        depth = max(w.get("queue_depth", 0) for w in windows)
        if summary["shed"] or depth < 8:
            raise SmokeFailure(f"{leg}: shed {summary['shed']}, deepest "
                               f"window queue {depth}")
        out[leg] = {"exit": 0, "arrivals": summary["arrivals"],
                    "window_depth_max": depth,
                    "p99_ms": summary.get("p99_ms")}
    if out["ramp"]["arrivals"] != out["ramp_replay"]["arrivals"]:
        raise SmokeFailure(f"ramp replay offered {out['ramp_replay']}, the "
                           f"recording {out['ramp']}")
    return out


def _side_by_side(*legs):
    """Run the legs ``(fn, args...)`` at once, each on a thread of its own
    that waits on its subprocesses; returns their results in order (the
    first failure raised)."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(len(legs)) as ex:
        futures = [ex.submit(fn, *args) for fn, *args in legs]
        return [f.result() for f in futures]


#: the kill leg's survivor leaves through os._exit: the process group's
#: shutdown would wait for the rank chaos killed
FAST_EXIT_DAXPY = (
    "import os, sys\n"
    "from tpu_mpi_tests_torch.workloads.daxpy import main\n"
    "rc = main(sys.argv[1:])\n"
    "sys.stdout.flush(); sys.stderr.flush()\n"
    "os._exit(rc)\n")


def _world2_args(device):
    return ["--device", device.type, "--n", str(CHAOS_DAXPY_N),
            "--telemetry", "--memwatch", "--mem-interval", "0.05"]


def chaos_kill(device):
    """Kill at world 2, the daxpy spec at 2^26, both ranks on this one
    card (the path makes no NCCL call: the host-name gather and the clock
    sync go over the gloo group): rank 1 dies at its tenth kernel phase
    (137), rank 0 records on for over a second."""
    jl = os.path.join(CHAOS_DIR, "kill.jsonl")
    chaos_leg("kill", ["-c", FAST_EXIT_DAXPY, *_world2_args(device),
                       "--iters", str(CHAOS_KILL_ITERS), "--jsonl", jl],
              "kill:rank=1:phase=kernel:after=10", [0, 137], world=2)
    dead = _leg_records(os.path.join(CHAOS_DIR, "kill.p1.jsonl"))
    live = _leg_records(os.path.join(CHAOS_DIR, "kill.p0.jsonl"))
    fire = _audit("kill rank 1", dead, "kill")
    if any(r.get("kind") == "chaos" for r in live):
        raise SmokeFailure("kill: rank 0 armed a fault aimed at rank 1")
    finals = [any(r.get("kind") == "mem" and r.get("event") == "final"
                  for r in recs) for recs in (live, dead)]
    after = live[-1]["t"] - dead[-1]["t"]
    if finals != [True, False] or fire.get("rank") != 1 or after <= 1.0:
        raise SmokeFailure(f"kill: final mem records {finals} (rank 0, 1), "
                           f"fire {fire}, the survivor recorded {after:.3f} "
                           f"s past the death (the doctor's gap is 1 s)")
    return {"kill": {"exit": [0, 137], "fire_rank": fire["rank"],
                     "survivor_after_s": after}}


def chaos_straggler(device):
    """Straggler at world 2, as :func:`chaos_kill`: every wait of rank 1
    slowed 25 ms, its kernel phase over twice rank 0's."""
    jl = os.path.join(CHAOS_DIR, "straggler.jsonl")
    chaos_leg("straggler", ["-m", "tpu_mpi_tests_torch.drivers.daxpy",
                            *_world2_args(device), "--iters", "40",
                            "--jsonl", jl],
              "straggler:rank=1:delay_ms=25", 0, world=2)
    kernel = []
    for r in (0, 1):
        recs = _leg_records(os.path.join(CHAOS_DIR, f"straggler.p{r}.jsonl"))
        if r == 1:
            _audit("straggler rank 1", recs, "straggler")
        kernel.append(next(x["seconds"] for x in recs
                           if x.get("kind") == "time"
                           and x.get("phase") == "kernel"))
    if not kernel[1] > 2 * kernel[0]:
        raise SmokeFailure(f"straggler: kernel phase {kernel} s (rank 0, 1)")
    return {"straggler": {"exit": [0, 0], "kernel_s": kernel}}


def stripe_launches(w: int = STRIPE_SHAPE["w"]) -> int:
    """Flash launches of one stripebalance grid pair: the contiguous
    layout's live cells (w(w+1)/2) and every striped cell, each one
    chained ``chain_rate`` and one queued timing."""
    cells = w * (w + 1) // 2 + w * w
    return cells * (_chain(*STRIPE_CHAIN) + 1 + STRIPE_QUEUED)


def check_stripe_cells(device, failures) -> dict:
    """The fold at stripebalance's operands (4096 × 128, causal, a w=8
    ring's contiguous and striped cells) against its plain version:
    HIGHEST float32 carries within FLASH_RTOL/FLASH_ATOL, DEFAULT bf16's
    normalised output within FLASH_DEFAULT_ATOL of the plain HIGHEST
    one. Returns the largest error of each class."""
    import torch

    from tpu_mpi_tests_torch.kernels import hand

    lq, d, w = STRIPE_SHAPE["lq"], STRIPE_SHAPE["d"], STRIPE_SHAPE["w"]
    gen = torch.Generator(device=device).manual_seed(2323)
    errs = {}
    cells = ((3, 3, 1), (5, 2, 1), (2, 5, w), (5, 2, w), (7, 0, w))
    for dtype, prec in ((torch.float32, "highest"),
                        (torch.bfloat16, "default")):
        q, k, v = (torch.randn((lq, d), generator=gen, device=device)
                   .to(dtype) for _ in range(3))
        carry = (torch.randn((lq, 1), generator=gen, device=device),
                 torch.randn((lq, 1), generator=gen, device=device).abs()
                 + 0.5,
                 torch.randn((lq, d), generator=gen, device=device))
        for r, src, st in cells:
            qo, ko = (r, src) if st > 1 else (r * lq, src * lq)
            kw = dict(scale=d**-0.5, causal=True, pos_stride=st)
            got = hand.flash_attention_block(
                q, k, v, *(t.clone() for t in carry), qo, ko,
                precision=prec, **kw)
            want = hand.flash_attention_block_ref(
                q, k, v, *carry, qo, ko, precision="highest", **kw)
            name = f"stripe cell r={r} src={src} stride={st} {prec}"
            if prec == "highest":
                err = 0.0
                for g, x, what in zip(got, want, ("m", "l", "acc")):
                    atol = FLASH_ATOL * (want[1].clamp(min=1.0)
                                         if what == "acc" else 1.0)
                    err = max(err, float((g - x).abs().max()))
                    if not bool(((g - x).abs()
                                 <= atol + FLASH_RTOL * x.abs()).all()):
                        failures.append(f"{name} {what}: beyond rtol/atol")
            else:
                err = float((got[2] / got[1] - want[2] / want[1]).abs().max())
                if not err <= FLASH_DEFAULT_ATOL["bfloat16"]:
                    failures.append(f"{name}: normalised error {err:g}")
            errs[prec] = max(errs.get(prec, 0.0), err)
    return errs


def check_world_of_one_blocks(device) -> None:
    """microbench blocks' world-of-one row runs the same launches: the
    resident blocks through a process group of one rank equal the
    group-less run bit for bit after a few iterations (8192², k=4, S=2),
    and the world-of-one run equals the plain version at 512²."""
    import torch

    from tpu_mpi_tests_torch.comm import dist
    from tpu_mpi_tests_torch.comm import halo as H

    for n, plain in ((CHAOS_BLOCKS_N, False), (512, True)):
        K = 2 * 4
        gen = torch.Generator(device=device).manual_seed(77)
        z = torch.randn((n + 2 * K, n), generator=gen, device=device) / 10
        run = H.iterate_hand_blocks_fn(2, K, 1e-4, steps=4)
        with dist.world_of_one(device) as w:
            got = run(H.split_blocks(z, 2, K), 3)
        if plain:
            want = run(H.split_blocks(z.cpu(), 2, K), 3)
            got = tuple(b.cpu() for b in got)
        else:
            want = run(H.split_blocks(z, 2, K), 3)
        if not all(torch.equal(a, b) for a, b in zip(got, want)):
            raise SmokeFailure(f"blocks {n}x{n} through the {w.backend} "
                               f"group of one rank differ from the "
                               f"{'plain version' if plain else 'plain world'}")
    log("CHECK blocks through a process group of one rank: bit for bit the "
        "group-less run (8192^2) and the plain version (512^2)")


def run_chaos_slice(device, counts, peaks):
    """The chaos slice (``chaos/`` and ``--chaos``, the memwatch's card
    path, microbench ``stripebalance``): each leg a subprocess whose exit
    code, ``kind: "chaos"`` audit records and organic records are checked
    and whose JSONL and output are kept under CHAOS_DIR for the JAX
    ``tpumt-doctor``:

    (a) wedge: stencil1d 32 Mi float32 ``--staging pallas --overlap 1
    --telemetry --deadline 6``, ``wedge:op=halo_exchange:after=3``: exit
    9 by the watchdog, its fire record after the wedge's dispatch note
    and no span after it, the dump the JSONL's tail; (b) oom, explicit
    limit: the daxpy spec at 2^20 (the JAX leg's size: at 2^26 x and y
    alone are past the limit) under ``--memwatch``,
    ``oom:step_mb=8:limit_mb=48:frac=0.8``: exit 134; (c) oom at the
    card's own limit, the spec at 2^26: ``oom:step_mb=4096``: exit 134
    once the ballast
    crosses 0.8 × the card's ``bytes_limit``, the phase records'
    ``bytes_in_use`` climbing to it; (d) the floods through
    ``drivers/serve.py`` on the daxpy 2^26 class: a shed storm (exit 1)
    and a queue ramp (no shed), recorded and replayed disarmed; (e) kill
    and straggler at world 2 (two processes on this card, no NCCL call on
    the path); (f) ``stripebalance`` in float32 (HIGHEST, ``fma``) and
    bfloat16 (DEFAULT, ``wgmma``) as main paths, their flash launches
    exact and on their routes, after the fold is held against its plain
    version at the groups' cells; (g) the blocks schedule through a
    process group of one rank against the group-less run and the plain
    version (microbench ``blocks``' new row runs in the one-card slice).
    Returns the legs' numbers and the stripe records."""
    import torch

    from tpu_mpi_tests_torch import microbench

    import shutil

    # the drivers append to a JSONL: start every leg's file afresh
    shutil.rmtree(CHAOS_DIR, ignore_errors=True)
    os.makedirs(CHAOS_DIR)
    t0 = time.perf_counter()
    # three waves: the small legs side by side (the wedge's watchdog has
    # ~4 s of slack past its third exchange), the card-limit ramp alone
    # (it fills 0.8 of the card), then kill beside straggler. The
    # explicit 48 MB leg runs at the JAX leg's 2^20: at 2^26 the working
    # set (x and y, 512 MiB) is past 0.8 x 48 MB at the first boundary,
    # so the fault fires with no ramp for the doctor to see
    wedge, oom_explicit, flood, ramp = _side_by_side(
        (chaos_wedge, device),
        (chaos_oom, device, "oom_explicit",
         "oom:step_mb=8:limit_mb=48:frac=0.8", 20, 1 << 20),
        (chaos_flood, device), (chaos_ramp, device))
    legs = {"wedge": wedge, "oom_explicit": oom_explicit, **flood, **ramp}
    legs["oom_card"] = chaos_oom(device, "oom_card", "oom:step_mb=4096", 40,
                                 CHAOS_DAXPY_N)
    for out in _side_by_side((chaos_kill, device),
                             (chaos_straggler, device)):
        legs.update(out)
    card = legs["oom_card"]
    if not card["peak_bytes_in_use"] >= 0.5 * card["bytes_limit"]:
        raise SmokeFailure(f"oom_card: peak {card['peak_bytes_in_use']} "
                           f"under half the card's limit "
                           f"{card['bytes_limit']}")
    log(f"CHAOS_LEGS {json.dumps(legs)}")
    log(f"  chaos legs: {time.perf_counter() - t0:.1f} s")

    failures = []
    errs = check_stripe_cells(device, failures)
    if failures:
        raise SmokeFailure("; ".join(failures[:10]))
    log(f"CHECK stripebalance cells against the plain fold: max error "
        f"{json.dumps(errs)}")
    check_world_of_one_blocks(device)
    torch.cuda.empty_cache()

    records = []
    want = stripe_launches()
    chained = _chain(*STRIPE_CHAIN)
    for dtype, route in (("float32", "fma"), ("bfloat16", "wgmma")):
        path = f"microbench stripebalance {dtype}"
        os.environ["TPU_MPI_STRIPE_DTYPE"] = dtype

        def run():
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                recs = microbench.run_groups(
                    ["stripebalance"], device, stripebalance={
                        **STRIPE_SHAPE, "chain": STRIPE_CHAIN,
                        "queued_iters": STRIPE_QUEUED})
            for line in out.getvalue().splitlines():
                log(f"  {line}")
            return recs

        t1 = time.perf_counter()
        try:
            recs, counts[path] = drive_path(path, run,
                                            ["flash_attention_block"], peaks)
        finally:
            os.environ.pop("TPU_MPI_STRIPE_DTYPE", None)
        got = counts[path]["flash_attention_block"]
        # a non-finite chained reading is retried once: one more chain
        if got < want or (got - want) % chained:
            raise SmokeFailure(f"{path}: {got} flash launches, the grids "
                               f"make {want} (+{chained} a retried cell)")
        others = {k: v for k, v in counts[path].items()
                  if v and k != "flash_attention_block"}
        if others:
            raise SmokeFailure(f"{path}: launched {others}")
        check_routes(path, "flash_attention_block", {route: got})
        for r in recs:
            v = r["value"]
            if not (math.isfinite(v) and v > 0):
                raise SmokeFailure(f"{path}: {r['metric']} = {v}")
        log(f"  {path}: {time.perf_counter() - t1:.1f} s")
        records += recs
    log(f"  chaos slice: {time.perf_counter() - t0:.1f} s")
    return {"legs": legs, "stripe": records, "stripe_errors": errs}


def overlap_launches():
    """Iterate launches of the bench's overlap schedule (``_ov2``, k=1):
    one a chained call (``chain_rate``: 3 warm, then the two runs per
    sample), every one on ``regs``."""
    return {"bench float32 _ov2": {
        "stencil2d_iterate": BENCH_SAMPLES * _chain(BENCH_ITERS_SHORT,
                                                    BENCH_ITERS_LONG)}}


def _overlap_run(fns, z, depth, rounds, grid_step=False):
    """A split pipeline under a fresh runner at ``depth``: ``rounds``
    ping-ponged steps, or one grid step; returns (result, runner)."""
    import torch

    from tpu_mpi_tests_torch.comm import halo as H

    runner = H.OverlapRunner("halo_exchange", depth=depth)
    if grid_step:
        ex, cores = runner.step(fns[0], fns[1], z)
        out = fns[2](ex, *cores)
    else:
        out = H.overlap_steps(runner, fns, z, rounds)
    torch.cuda.synchronize()
    if depth >= 2 and z.is_cuda and (runner.comm_stream is None
                                     or runner.streamed_steps
                                     != runner.steps):
        raise SmokeFailure(f"a depth-{depth} runner on a card tensor ran "
                           f"{runner.streamed_steps} of {runner.steps} "
                           f"exchanges on its comm stream")
    return out, runner


def _overlap_check(name, d1, d2, serial, tol, res_rtol=None):
    """Depth 1 equal to depth 2 bit for bit, and both within ``tol``
    (rtol, atol) of the serial body; returns the largest error against
    it (0.0: bit for bit)."""
    import torch

    d1, d2, serial = (t if isinstance(t, tuple) else (t,)
                      for t in (d1, d2, serial))
    worst = 0.0
    for i, (a, b, c) in enumerate(zip(d1, d2, serial)):
        if not torch.equal(a, b):
            raise SmokeFailure(f"{name}: depth 2 differs from depth 1")
        if res_rtol is not None and a.dim() == 0:
            rel = abs(float(a) - float(c)) / abs(float(c))
            if not rel <= res_rtol:
                raise SmokeFailure(f"{name}: residual {float(a)!r} vs the "
                                   f"serial body's {float(c)!r}")
            continue
        a, c = a.double(), c.double()
        worst = max(worst, float((a - c).abs().max()))
        if not torch.allclose(a, c, rtol=tol[0], atol=tol[1]):
            raise SmokeFailure(f"{name}: output {i} differs from the serial "
                               f"body beyond rtol {tol[0]:g}, atol "
                               f"{tol[1]:g}")
    return worst


def overlap_trace(device, spin: bool) -> dict:
    """``torch.profiler`` traces of :data:`OVERLAP_TRACE_BODIES` heat
    bodies at 8192² f32 at depth 2 and depth 1, summed by
    ``gpu/trace_summary.py``: the device time in which kernels of two
    streams ran at once (``overlap_ms``). ``spin`` puts a ~2 ms spin
    kernel on the compute stream before each body, so that the body's
    exchange and core are both posted while the card is busy and start
    together; without it (the steady state) the exchange's copies run as
    they are posted. Returns {depth: summary}."""
    import importlib.util

    import torch

    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.drivers import heat2d

    spec = importlib.util.spec_from_file_location(
        "trace_summary", os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "gpu", "trace_summary.py"))
    summary = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(summary)
    _, cx, cy = heat2d.coefficients(GRID_N, GRID_N, 0.1)
    ex_fn, core, seam = H.heat_overlap_fns(cx, cy)
    g = torch.Generator(device=device).manual_seed(6100)
    z0 = torch.randn((GRID_N + 2,) * 2, generator=g, device=device)

    def bodies(depth, n):
        runner = H.OverlapRunner("halo_exchange2d", depth=depth)
        z, spare = z0.clone(), torch.empty_like(z0)
        for _ in range(n):
            if spin:
                torch.cuda._sleep(OVERLAP_SPIN_CYCLES)
            ex, zc = runner.step(ex_fn, lambda t: core(t, out=spare), z)
            z, spare = seam(ex, zc), z
        torch.cuda.synchronize()

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        for depth in (2, 1):
            bodies(depth, 1)  # warm
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            with torch.profiler.profile(activities=acts) as prof:
                bodies(depth, OVERLAP_TRACE_BODIES)
            path = os.path.join(tmp, f"trace_{depth}.json")
            prof.export_chrome_trace(path)
            out[depth] = summary.summarize(path)
            out[depth].pop("trace")
    return out


def run_overlap_slice(device, counts, per_step, peaks):
    """The overlap engine on one card, world 1, at the drivers' sizes:
    the three split pipelines and the bench's overlap schedule at depth 1
    and 2, bit for bit, against their serial bodies; the drivers and the
    bench under ``--overlap 2`` / ``TPU_MPI_BENCH_OVERLAP=2``, each a
    path with its counts zeroed; the engine's refusal of the RDMA ring;
    and the device trace of depth-2 and depth-1 heat bodies. Returns the
    slice's record."""
    import torch

    from tpu_mpi_tests_torch import bench
    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.drivers import heat2d, stencil1d, stencil2d_grid
    from tpu_mpi_tests_torch.kernels import hand
    from tpu_mpi_tests_torch.utils import TpuMtError

    rec = {"max_abs_err_vs_serial": {}}
    g = torch.Generator(device=device).manual_seed(6000)
    _, cx, cy = heat2d.coefficients(GRID_N, GRID_N, 0.1)
    for dtype in (torch.float32, torch.bfloat16):
        name = f"heat {str(dtype)[6:]} {GRID_N}x{GRID_N} 1x1 periodic"
        z = torch.randn((GRID_N + 2,) * 2, generator=g, device=device).to(
            dtype)
        fns = H.heat_overlap_fns(cx, cy)
        d1, _ = _overlap_run(fns, z.clone(), 1, OVERLAP_ROUNDS)
        d2, _ = _overlap_run(fns, z.clone(), 2, OVERLAP_ROUNDS)
        serial = H.heat_step2d_fn(1, cx, cy)(z.clone(), OVERLAP_ROUNDS)
        rec["max_abs_err_vs_serial"][name] = _overlap_check(
            name, d1, d2, serial, OVERLAP_TOL["heat"])
        del z, d1, d2, serial
    name = f"grid float32 {GRID_N}x{GRID_N}"
    z = torch.randn((GRID_N + 4,) * 2, generator=g, device=device)
    fns = H.grid_overlap_fns(2, GRID_SCALE, GRID_SCALE)
    d1, _ = _overlap_run(fns, z.clone(), 1, 1, grid_step=True)
    d2, _ = _overlap_run(fns, z.clone(), 2, 1, grid_step=True)
    serial = H.step2d_fn(2, GRID_SCALE, GRID_SCALE)(z.clone())
    rec["max_abs_err_vs_serial"][name] = _overlap_check(
        name, d1, d2, serial, OVERLAP_TOL["grid"], OVERLAP_RESIDUAL_RTOL)
    del z, d1, d2, serial
    name = f"jacobi float32 {STENCIL1D_N} periodic"
    scale = STENCIL1D_N / 8.0
    z = torch.randn((STENCIL1D_N + 4,), generator=g, device=device)
    fns = H.overlap_jacobi_fns(0, 2, scale, 1e-6, periodic=True)
    d1, _ = _overlap_run(fns, z.clone(), 1, OVERLAP_ROUNDS)
    d2, _ = _overlap_run(fns, z.clone(), 2, OVERLAP_ROUNDS)
    serial = H.iterate_fused_fn(0, 2, scale, 1e-6, periodic=True)(
        z.clone(), OVERLAP_ROUNDS)
    rec["max_abs_err_vs_serial"][name] = _overlap_check(
        name, d1, d2, serial, OVERLAP_TOL["jacobi"])
    del z, d1, d2, serial
    # the bench's overlap schedule against the serialized one, tolerance
    # 0 (the strips take the iterate kernel's arithmetic), every iterate
    # launch counted on regs
    for dtype in (torch.float32, torch.bfloat16):
        name = f"iterate_overlap {str(dtype)[6:]} {BENCH_N}x{BENCH_N + 4}"
        z = torch.randn((BENCH_N, BENCH_N + 4), generator=g,
                        device=device).to(dtype)
        before = hand.route_counts()["stencil2d_iterate"]
        got = H.iterate_overlap_fn(2, BENCH_SE, axis=1)(z.clone(), 5)
        torch.cuda.synchronize()
        took = {r: hand.route_counts()["stencil2d_iterate"][r] - before[r]
                for r in before}
        if took != {"regs": 5, "smem": 0}:
            raise SmokeFailure(f"{name}: iterate launches {took}, the "
                               f"schedule makes 5 on regs")
        want = H.iterate_hand_fn(2, BENCH_SE, axis=1)(z.clone(), 5)
        rec["max_abs_err_vs_serial"][name] = _overlap_check(
            name, got, got, want, (0.0, 0.0))
        del z, got, want
    torch.cuda.empty_cache()
    log(f"OVERLAP pipelines: depth 2 equal to depth 1 bit for bit, each "
        f"runner's exchanges on its comm stream; largest error against "
        f"the serial body {json.dumps(rec['max_abs_err_vs_serial'])} "
        f"(JAX's tolerances {json.dumps(OVERLAP_TOL)}, the iterate 0)")
    try:
        H.overlap_jacobi_fns(0, 2, 1.0, 1e-6, staging="pallas")
        raise SmokeFailure("the overlap engine took the RDMA ring's "
                           "staging")
    except TpuMtError as e:
        log(f"OVERLAP refusal: {e}")

    # the entry points under --overlap 2, each a path of its own
    for path, module, argv, needed in (
            ("heat2d --overlap 2", heat2d,
             ["--kernel", "torch", "--halo-steps", "1", "--mesh", "1,1",
              "--nx-local", str(GRID_N), "--ny-local", str(GRID_N),
              "--n-steps", str(HEAT_N_STEPS), "--overlap", "2"],
             ("OVERLAP heat2d depth=2 overlap_frac=", "HEAT ERR rel=")),
            ("stencil2d_grid --overlap 2", stencil2d_grid,
             ["--kernel", "torch", "--mesh", "1,1", "--nx-local",
              str(GRID_N), "--ny-local", str(GRID_N), "--n-iter",
              str(GRID_N_ITER), "--n-warmup", str(GRID_N_WARMUP),
              "--overlap", "2"],
             ("OVERLAP stencil2d_grid depth=2 ", "GRID TEST px:1 py:1")),
            ("stencil1d --overlap 2", stencil1d,
             ["--n-global", str(STENCIL1D_N), "--overlap", "2"],
             ("OVERLAP halo depth=2 iters=32 ", "err_norm = "))):
        counts[path] = drive_driver(path, module,
                                    ["--device", device.type] + argv, [],
                                    needed, peaks)
        if any(counts[path].values()):
            raise SmokeFailure(f"{path}: the torch pipeline launched hand "
                               f"kernels {counts[path]}")

    for var in [v for v in os.environ if v.startswith("TPU_MPI_BENCH_")]:
        del os.environ[var]
    os.environ.update({
        "TPU_MPI_BENCH_N": str(BENCH_N), "TPU_MPI_BENCH_OVERLAP": "2",
        "TPU_MPI_BENCH_STEPS": "1", "TPU_MPI_BENCH_SECOND_DTYPE": "none",
        "TPU_MPI_BENCH_ITERS_SHORT": str(BENCH_ITERS_SHORT),
        "TPU_MPI_BENCH_ITERS_LONG": str(BENCH_ITERS_LONG),
        "TPU_MPI_BENCH_SAMPLES": str(BENCH_SAMPLES)})
    ((path, want),) = overlap_launches().items()

    def run_bench():
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            r = bench.main(["--device", device.type])
        log(f"BENCH {out.getvalue().strip().splitlines()[-1]}")
        return r

    rec["bench"], counts[path] = drive_path(path, run_bench,
                                            ["stencil2d_iterate"], peaks)
    for var in [v for v in os.environ if v.startswith("TPU_MPI_BENCH_")]:
        del os.environ[var]
    if "_ov2_" not in rec["bench"]["schedule"] or not \
            rec["bench"]["value"] > 0:
        raise SmokeFailure(f"{path}: not a measured _ov2 run: {rec['bench']}")
    if counts[path] != dict.fromkeys(counts[path], 0) | want:
        raise SmokeFailure(f"{path}: launches {counts[path]}, its schedule "
                           f"makes {want}")
    check_routes(path, "stencil2d_iterate",
                 {"regs": want["stencil2d_iterate"]})
    per_step[path] = {"stencil2d_iterate": check_per_timestep(
        path, "stencil2d_iterate", want["stencil2d_iterate"],
        want["stencil2d_iterate"], 1.0)}

    # the streams on the device timeline
    rec["trace"] = {}
    for spin in (False, True):
        tr = overlap_trace(device, spin)
        label = "busy stream" if spin else "steady state"
        rec["trace"][label] = tr
        log(f"OVERLAP trace, {label}, {OVERLAP_TRACE_BODIES} heat bodies "
            f"8192^2 f32: depth 2 overlap_ms {tr[2]['overlap_ms']:.6f} on "
            f"{tr[2]['streams']} streams (idle share "
            f"{tr[2]['idle_share']:.4f}), depth 1 overlap_ms "
            f"{tr[1]['overlap_ms']:.6f} on {tr[1]['streams']} streams "
            f"(idle share {tr[1]['idle_share']:.4f})")
        if tr[1]["overlap_ms"] != 0.0:
            raise SmokeFailure(f"{label}: depth 1 ran kernels of two "
                               f"streams at once")
        if tr[2]["streams"] < 2:
            raise SmokeFailure(f"{label}: depth 2's trace shows one stream")
    if not rec["trace"]["busy stream"][2]["overlap_ms"] > 0.0:
        raise SmokeFailure("busy stream: depth 2's comm and compute "
                           "streams never ran at once")
    return rec


def run_daxpy_slice(device, counts, peaks):
    """The DAXPY slice's paths: the three microbench groups (each must
    launch exactly what its schedule makes, every GB/s row finite and at
    most ``GBPS_CAP``), then the five DAXPY drivers (every gate passing,
    no hand kernel launched). Fills ``counts``/``peaks`` per path and
    returns the microbench records."""
    import importlib

    from tpu_mpi_tests_torch import microbench

    records = []
    for group, want in microbench_launches().items():
        path = f"microbench {group}"

        def run(group=group):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                recs = microbench.run_groups([group], device)
            for line in out.getvalue().splitlines():
                log(f"  {line}")
            return recs

        recs, counts[path] = drive_path(
            path, run, [k for k, v in want.items() if v], peaks)
        got = {k: counts[path][k] for k in want}
        if got != want:
            raise SmokeFailure(f"{path}: launches {got}, its schedule "
                               f"makes {want}")
        check_stream_routes(path, want)
        for r in recs:
            v = r["value"]
            if r["unit"] == "GB/s" and not 0 < v <= GBPS_CAP:
                raise SmokeFailure(f"{path}: {r['metric']} = {v} GB/s is "
                                   f"not finite in (0, {GBPS_CAP:g}]")
        records += recs

    for path, name, argv, needed in DAXPY_DRIVERS:
        module = importlib.import_module(
            f"tpu_mpi_tests_torch.drivers.{name}")
        counts[path] = drive_driver(path, module,
                                    ["--device", device.type] + argv, [],
                                    needed, peaks)
        if any(counts[path].values()):
            raise SmokeFailure(f"{path}: the DAXPY drivers launch no hand "
                               f"kernel (parity with the JAX drivers), "
                               f"got {counts[path]}")
    return records


def issue_rate() -> float:
    """Lone float32 mul/add/sub the card issues a second
    (``hand.alu_issue_rate``: SMs × 128 lanes × the peak SM clock)."""
    from tpu_mpi_tests_torch.kernels import hand

    return hand.alu_issue_rate()


def check_one_card_rates(path, recs):
    """Every rate row of a one-card group: finite and positive, or NaN
    where the row's own fit gate said so (the ``vpu_*_gops`` and
    ``roofline_*``/``dualdim_lean_gain_*`` rows: at the JAX sizes the
    heat and dual-step chains are host-bound on a fast card); no GB/s row
    above ``GBPS_CAP``; no probe row above 1.05 × the card's issue rate
    (:func:`issue_rate`) counted in the lone instructions it issues, a
    bfloat16 row's elements at twice that (bf16x2)."""
    import math

    from tpu_mpi_tests_torch.kernels import hand

    for r in recs:
        v, metric = r["value"], r["metric"]
        gated = (metric.endswith(("_gops", "_ceiling", "_marginal_ps"))
                 or metric.startswith(("dualdim_lean_gain_",
                                       "roofline_heat_")))
        if gated and math.isnan(v):
            log(f"  NOTE {path}: {metric} is NaN by its fit gate: "
                f"{r.get('detail', '')[:160]}")
            continue
        if not (math.isfinite(v) and v > 0):
            raise SmokeFailure(f"{path}: {metric} = {v} is not a finite "
                               f"positive value")
        if r["unit"] == "GB/s" and v > GBPS_CAP:
            raise SmokeFailure(f"{path}: {metric} = {v} GB/s above "
                               f"{GBPS_CAP:g}")
        if r["unit"] == "Gop/s":
            mix = next(m for m in sorted(hand.ALU_PROBE_MIXES, key=len,
                                         reverse=True)
                       if metric.startswith(f"vpu_{m}_"))
            nominal = int(r["detail"].split("nominal ")[1].split()[0])
            issued = v * hand.ALU_PROBE_REAL_OPS[mix] / nominal  # Gop/s
            per = 2 if metric.endswith("_bfloat16_gops") else 1
            cap = 1.05 * per * issue_rate() / 1e9
            if issued > cap:
                raise SmokeFailure(f"{path}: {metric} issues {issued:g} "
                                   f"G element-ops/s, above 1.05x the "
                                   f"card's issue rate ({cap:g})")


def run_one_card_slice(device, counts, peaks):
    """The one-card slice's paths, each alone: the microbench groups
    ``vpu``, ``roofline2``, ``stencil``, ``iterate``, ``splitfused``,
    ``blocks`` and ``heat`` (exact launch counts, rate checks), the
    periodic hand-staged exchange on both axes against DIRECT, and the
    ``stencil1d`` driver. Returns the microbench records."""
    import torch

    from tpu_mpi_tests_torch import microbench
    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.drivers import stencil1d
    from tpu_mpi_tests_torch.kernels import hand

    os.environ.pop("TPU_MPI_VPU_STEP5FMA", None)
    sizes = {"vpu": {"iters": SMOKE_PROBE_ITERS},
             "roofline2": {"iters": SMOKE_PROBE_ITERS},
             "roofline2 large": {"iters": SMOKE_PROBE_ITERS,
                                 **ROOFLINE_LARGE}}
    records = []
    for name, want in one_card_launches().items():
        path = f"microbench {name}"
        group = name.split()[0]

        def run(group=group, name=name):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                recs = microbench.run_groups(
                    [group], device, **{group: sizes.get(name, {})})
            for line in out.getvalue().splitlines():
                log(f"  {line}")
            return recs

        t0 = time.perf_counter()
        recs, counts[path] = drive_path(path, run, list(want), peaks)
        want_all = dict.fromkeys(counts[path], 0) | want
        if counts[path] != want_all:
            raise SmokeFailure(f"{path}: launches {counts[path]}, its "
                               f"schedule makes {want_all}")
        check_stream_routes(path, want_all)
        # roofline2's dual fit runs float32 and bfloat16 alike
        check_probe_dual_routes(path, want_all,
                                want_all.get("dual_dim_step", 0) // 2)
        check_one_card_rates(path, recs)
        log(f"  {path}: {time.perf_counter() - t0:.1f} s")
        records += recs

    # the periodic self-ring exchange, DEVICE_STAGED through the hand
    # pack/unpack kernels, against DIRECT on the same field
    gen = torch.Generator(device=device).manual_seed(4321)
    for shape, axis in STAGED_CASES:
        path = f"staged exchange {shape[0]}x{shape[1]} axis {axis}"
        z = torch.randn(shape, generator=gen, device=device)

        def run(z=z, axis=axis):
            got = z.clone()
            for _ in range(STAGED_EXCHANGES):
                got = H.halo_exchange(got, axis, 2, True, "device",
                                      kernel="hand")
            torch.cuda.synchronize(device)
            return got

        got, counts[path] = drive_path(path, run,
                                       ["pack_edges", "unpack_ghosts"],
                                       peaks)
        want = dict.fromkeys(counts[path], 0) | {
            "pack_edges": STAGED_EXCHANGES, "unpack_ghosts": STAGED_EXCHANGES}
        if counts[path] != want:
            raise SmokeFailure(f"{path}: launches {counts[path]}, one pack "
                               f"and one unpack per exchange make {want}")
        for name in ("pack_edges", "unpack_ghosts"):
            check_routes(path, name, {STAGED_ROUTES[axis]: STAGED_EXCHANGES})
        direct = H.halo_exchange(z.clone(), axis, 2, True, "direct")
        if not torch.equal(got, direct) or torch.equal(got, z):
            raise SmokeFailure(f"{path}: the hand-staged exchange differs "
                               f"from DIRECT")
        nbytes = H.halo_payload_bytes(z, axis, 1, 2, True)
        log(f"STAGED {path}: {STAGED_EXCHANGES} exchanges equal DIRECT bit "
            f"for bit on the {STAGED_ROUTES[axis]} route, payload {nbytes} "
            f"B each")
        del z, got, direct
        torch.cuda.empty_cache()

    for dtype in ("float32", "float64"):
        path = f"stencil1d {dtype}"
        counts[path] = drive_driver(
            path, stencil1d, ["--device", device.type, "--n-global",
                              str(STENCIL1D_N), "--dtype", dtype], [],
            ("0/1 exchange time ", "err_norm = "), peaks)
        if any(counts[path].values()):
            raise SmokeFailure(f"{path}: the 1-D stencil driver launches no "
                               f"hand kernel (parity with the JAX driver), "
                               f"got {counts[path]}")
    return records


def attn_peak(dtype: str, fast: bool, tier: str) -> float:
    """The peak of the arithmetic an attnbench row runs: DEFAULT (--fast)
    puts float32 on TF32 and bf16 on the bf16 tensor cores; HIGHEST runs
    the flash kernel in f32 on the CUDA cores, and torch's matmul (the
    xla tier) in f32 for float32 and on the bf16 tensor cores for bf16."""
    if fast:
        return PEAK_FLOPS["tf32" if dtype == "float32" else "bf16"]
    if tier == "xla" and dtype == "bfloat16":
        return PEAK_FLOPS["bf16"]
    return PEAK_FLOPS["f32"]


def check_rate(path, name, tflops, peak):
    cap = 1.05 * peak / 1e12
    if not 0 < tflops <= cap:
        raise SmokeFailure(f"{path}: {name} = {tflops} TFLOP/s is not "
                           f"finite in (0, {cap:g}] (1.05x its peak)")


def run_attention_slice(device, counts, peaks):
    """The attention slice's paths, each alone: attnbench at L=8192,
    d=128 (float32; causal; bfloat16 --fast; the striped causal ring) and
    the microbench groups ``attention`` and ``causal`` at the JAX sizes.
    Each must launch the flash kernel exactly as its schedule makes,
    print no FAIL, and keep every TFLOP/s row finite and at most 1.05x
    the peak of its arithmetic. Returns the microbench records."""
    import re

    from tpu_mpi_tests_torch import microbench
    from tpu_mpi_tests_torch.drivers import attnbench

    line_re = re.compile(r"^ATTN (\w+)((?:\[\w+\])*) L=\d+ d=\d+ (\w+) "
                         r"(\S+) TFLOP/s$")
    paths = [(path, extra, {"flash_attention_block": n * ATTN_CALLS})
             for path, extra, n in ATTNBENCH_PATHS] + list(ATTN_RING_PATHS)
    for path, extra, want in paths:
        argv = ["--device", device.type] + _ATTN_ARGV + extra
        fast = "--fast" in extra
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            counts[path] = drive_driver(
                path, attnbench, argv, [k for k, n in want.items() if n],
                ("ATTN ",), peaks)
        text = out.getvalue()
        for line in text.splitlines():
            log(line)
        _exact(path, counts[path], want)
        # every launch on the route of its operands: bf16 --fast on the
        # wgmma route, f32 HIGHEST on the CUDA cores
        route = "wgmma" if "--fast" in extra else "fma"
        for name, n in want.items():
            check_routes(path, name, {route: n} if n else {})
        fused = "fused" in extra
        if ("[fused]" in text) != fused:
            raise SmokeFailure(f"{path}: the [fused] tag must appear exactly "
                               f"when the fused kernel ran")
        # drive_driver logged the driver's lines indented, into ``out``
        rows = [line_re.match(ln.strip()) for ln in text.splitlines()
                if ln.strip().startswith("ATTN ")]
        if not rows or not all(rows):
            raise SmokeFailure(f"{path}: malformed ATTN lines")
        for r in rows:
            check_rate(path, f"ATTN {r[1]}", float(r[4]),
                       attn_peak(r[3], fast, r[1]))

    records = []
    for group, want in ATTN_MICROBENCH_LAUNCHES.items():
        path = f"microbench {group}"

        def run(group=group):
            out = io.StringIO()
            with contextlib.redirect_stdout(out):
                recs = microbench.run_groups([group], device)
            for line in out.getvalue().splitlines():
                log(f"  {line}")
            return recs

        recs, counts[path] = drive_path(path, run,
                                        ["flash_attention_block"], peaks)
        got = counts[path]["flash_attention_block"]
        if got != want:
            raise SmokeFailure(f"{path}: {got} flash launches, its schedule "
                               f"makes {want}")
        # DEFAULT: f32 on TF32 mma.sync, bf16 on wgmma
        check_routes(path, "flash_attention_block",
                     ATTN_MICROBENCH_ROUTES[group])
        for r in recs:
            if r["unit"] == "TFLOP/s":  # DEFAULT: TF32 or bf16
                peak = PEAK_FLOPS["tf32" if "float32" in r["metric"]
                                  else "bf16"]
                check_rate(path, r["metric"], r["value"], peak)
            else:  # ms/attn, bf16 DEFAULT, "useful <x> TFLOP/s"
                useful = float(re.search(r"useful (\S+) TFLOP/s",
                                         r["detail"])[1])
                check_rate(path, r["metric"], useful, PEAK_FLOPS["bf16"])
        records += recs
    return records


# ---------------------------------------------------------------------------
# the fused ring attention: every ring step in one launch
# ---------------------------------------------------------------------------

FRA_CONFIGS = tuple((dt, precision) for dt in ("float32", "bfloat16")
                    for precision in ("highest", "default"))
FRA_LAYOUTS = ((False, False), (True, False), (True, True))
# the main path's operands: attnbench at world 1 (one step) in its fused
# configurations — f32 HIGHEST, bf16 --fast, f32 causal striped
FRA_MAIN = (("float32", "highest", False, False),
            ("bfloat16", "default", False, False),
            ("float32", "highest", True, True))


def fused_tolerance(dtype: str, precision: str, want) -> float:
    """Kernel vs plain on the normalised output: f32 arithmetic (HIGHEST)
    to FLASH_ATOL, the tensor cores (DEFAULT) to FLASH_DEFAULT_ATOL of
    the plain version at HIGHEST — the flash kernel's tolerances, since
    each step is its fold; a bf16 output adds its own rounding, half an
    ulp, 2^-8 × max|want|, against ``want``, the plain output in float32
    (not rounded to bf16, so the bound counts one rounding, the
    kernel's)."""
    tol = FLASH_ATOL if precision == "highest" else FLASH_DEFAULT_ATOL[dtype]
    if dtype == "bfloat16":
        tol += 2.0**-8 * float(want.float().abs().max())
    return tol


def check_fused_ring_kernel(device, gen, failures):
    """The fused ring attention against its plain version and, bit for
    bit, against the pipelined tier's flash launches
    (``hand.ring_attention_steps(kernel=True)``: w launches of
    ``flash_attention_block``, whose tile body the kernel shares):
    float32/bfloat16 × HIGHEST/DEFAULT × {plain, causal, causal+striped}
    at world 1 and on the self-ring k = 2, 4, 8 at (333, 17) and (1000,
    128); w = 2 and 4 instances cross-wired on one card at (500, 64) a
    rank, against the one-process world (``hand.fused_ring_world_ref``,
    the hops by indexing); the main path's operands at (8192, 128).
    Returns (cases, the main path's largest error, the error per class,
    the cross-wired one's)."""
    import torch

    from tpu_mpi_tests_torch.kernels import hand

    torch.backends.cuda.matmul.allow_tf32 = False
    classes: dict[str, float] = {}

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=device).to(dtype)

    def f32(*ts):
        return tuple(t.float() for t in ts)

    def check(name, cls, got, flash, plain, dtype, precision):
        """``plain``: the plain output in float32."""
        if not torch.equal(got, flash):
            diff = float((got.float() - flash.float()).abs().max())
            failures.append(f"fused {name}: not bitwise the pipelined "
                            f"flash launches (max |diff| {diff:g})")
        err = float((got.float() - plain).abs().max())
        tol = fused_tolerance(dtype, precision, plain)
        if not err <= tol or not bool(torch.isfinite(got.float()).all()):
            failures.append(f"fused {name}: max |kernel - plain| = {err:g} "
                            f"beyond {tol:g}")
        classes[cls] = max(classes.get(cls, 0.0), err)
        return err

    n_cases = 0
    routes0 = dict(hand.fused_ring_attention.launches_by_route)
    routes_want = dict.fromkeys(hand.FLASH_ROUTES, 0)

    def fused(q, k, v, **kw):
        d = q.shape[-1]
        routes_want[hand.flash_route(q.dtype, kw["precision"], d,
                                     hand.flash_aligned(d, q, k, v))] += 1
        return hand.fused_ring_attention(q, k, v, **kw)

    for dt, precision in FRA_CONFIGS:
        dtype = getattr(torch, dt)
        for causal, stripe in FRA_LAYOUTS:
            kw = dict(causal=causal, stripe=stripe, precision=precision)
            for L, d in ((333, 17), (1000, 128)):
                q, k, v = (rand((L, d), dtype) for _ in range(3))
                for ring in (None, 2, 4, 8):
                    w = ring or 1
                    got = fused(q, k, v, self_ring=ring, **kw)
                    flash = hand.fused_ring_world_ref([(q, k, v)] * w,
                                                      kernel=True, **kw)[0]
                    plain = hand.fused_ring_attention_ref(
                        *f32(q, k, v), self_ring=ring, causal=causal,
                        stripe=stripe)
                    check(f"{dt} {precision} causal={causal} stripe="
                          f"{stripe} ({L}, {d}) self_ring={ring}",
                          f"{dt} {precision} "
                          f"{'world 1' if ring is None else 'self-ring'}",
                          got, flash, plain, dt, precision)
                    n_cases += 1
            for w in (2, 4):
                blocks = [tuple(rand((500, 64), dtype) for _ in range(3))
                          for _ in range(w)]
                got = hand.cross_wired("fused_ring_attention", blocks, **kw)
                flash = hand.fused_ring_world_ref(blocks, kernel=True, **kw)
                plain = hand.fused_ring_world_ref(
                    [f32(*b) for b in blocks], causal=causal, stripe=stripe)
                for r in range(w):
                    check(f"cross-wired w={w} rank {r} {dt} {precision} "
                          f"causal={causal} stripe={stripe}",
                          "cross-wired", got[r], flash[r], plain[r], dt,
                          precision)
                n_cases += 1
    main = 0.0
    for dt, precision, causal, stripe in FRA_MAIN:
        dtype = getattr(torch, dt)
        q, k, v = (rand((ATTN_L, ATTN_D), dtype) for _ in range(3))
        kw = dict(causal=causal, stripe=stripe, precision=precision)
        got = fused(q, k, v, **kw)
        flash = hand.fused_ring_world_ref([(q, k, v)], kernel=True, **kw)[0]
        plain = hand.fused_ring_attention_ref(*f32(q, k, v), causal=causal,
                                              stripe=stripe)
        err = check(f"main-path ({ATTN_L}, {ATTN_D}) {dt} {precision} "
                    f"causal={causal} stripe={stripe}", "main path", got,
                    flash, plain, dt, precision)
        if precision == "highest":
            main = max(main, err)
        n_cases += 1
        del q, k, v, got, flash, plain
        torch.cuda.empty_cache()
    torch.cuda.synchronize(device)
    got_routes = {r: n - routes0[r] for r, n in
                  hand.fused_ring_attention.launches_by_route.items()}
    if got_routes != routes_want:
        failures.append(f"fused launches by route {got_routes}, the "
                        f"operands' routes make {routes_want}")
    log(f"FUSED_RING_ROUTES {json.dumps(got_routes)}")
    log(f"FUSED_RING_ERRORS largest per class {json.dumps(classes)}")
    return n_cases, main, classes


def fused_ring_work(lq, d, dtype, w, causal, stripe):
    """(bytes, flops) of one fused launch on rank 0 of a w-ring of
    identical blocks (the self-ring): q, k, v read once, out written
    once, the (w-1) forwarded K/V blocks written and read once; 4·d flops
    per live (query, key) pair of the w steps, counted from the masks."""
    import torch

    item = torch.empty((), dtype=dtype).element_size()
    i = torch.arange(lq, dtype=torch.float64)
    pairs = 0
    for s in range(w):
        src = (-s) % w
        if not causal:
            pairs += lq * lq
        elif stripe:  # q_pos = i·w, k_pos = j·w + src: j <= i - (src > 0)
            pairs += int((i + (src == 0)).clamp(0, lq).sum())
        else:         # q_pos = i, k_pos = src·lq + j
            pairs += int((i + 1 - src * lq).clamp(0, lq).sum())
    nbytes = 4 * lq * d * item + 2 * (w - 1) * 2 * lq * d * item
    return nbytes, 4 * d * pairs


def time_fused_ring_kernel(device, gen):
    """The fused ring attention at (8192, 128), CUDA events (warmed): at
    world 1 (f32 HIGHEST dense and causal, bf16 DEFAULT) and on the
    self-ring k = 4 (f32 HIGHEST dense, bf16 DEFAULT dense, f32 HIGHEST
    causal striped), beside its plain version, its bound (flops over the
    peak of the arithmetic, or bytes over 3.35 TB/s) and, where one call
    computes the same function, ``F.scaled_dot_product_attention``: q, k,
    v at world 1; K/V tiled k times on the non-causal self-ring (each key
    k times: the same softmax); none on the causal self-ring. The kernel
    and the pipelined launches are also timed queued behind a stall
    (``queued_ms``: the wrappers' host time taken out)."""
    import torch
    import torch.nn.functional as F

    from tpu_mpi_tests_torch.kernels import hand

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for ring, dt, precision, causal, stripe in (
            (None, "float32", "highest", False, False),
            (None, "float32", "highest", True, False),
            (None, "bfloat16", "default", False, False),
            (4, "float32", "highest", False, False),
            (4, "bfloat16", "default", False, False),
            (4, "float32", "highest", True, True)):
        dtype = getattr(torch, dt)
        L, d, w = ATTN_L, ATTN_D, ring or 1
        q, k, v = (torch.randn((L, d), generator=gen, device=device)
                   .to(dtype) for _ in range(3))
        kw = dict(causal=causal, stripe=stripe, precision=precision)
        n = 10 if w == 1 else 4

        def launch():
            return hand.fused_ring_attention(q, k, v, self_ring=ring, **kw)

        def pipelined():  # the pipelined tier's w flash launches, rank 0
            return hand.ring_attention_steps(
                q, lambda s: (k, v), 0, w, scale=d**-0.5, kernel=True, **kw)

        ms = time_cuda(launch, n)
        queued = time_cuda_queued(launch, n)
        plain = time_cuda(lambda: hand.fused_ring_attention_ref(
            q, k, v, self_ring=ring, **kw), 2)
        flash = time_cuda(pipelined, n)
        flash_queued = time_cuda_queued(pipelined, n)
        lib = None
        if w == 1:
            lib = time_cuda(lambda: F.scaled_dot_product_attention(
                q[None, None], k[None, None], v[None, None],
                is_causal=causal), n)
        elif not causal:
            kt, vt = k.repeat(w, 1), v.repeat(w, 1)
            lib = time_cuda(lambda: F.scaled_dot_product_attention(
                q[None, None], kt[None, None], vt[None, None]), n)
        nbytes, flops = fused_ring_work(L, d, dtype, w, causal, stripe)
        arith = "f32" if precision == "highest" else (
            "bf16" if dtype == torch.bfloat16 else "tf32")
        t_ops = flops / PEAK_FLOPS[arith] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({
            "path": ("attnbench --ring-tier fused" if w == 1
                     else "self-ring k=4"),
            "shape": [L, d], "self_ring": ring, "dtype": dt,
            "causal": causal, "stripe": stripe, "precision": precision,
            "arithmetic": arith,
            "route": hand.flash_route(dtype, precision, d, True),
            "ms": ms, "queued_ms": queued, "plain_ms": plain,
            "pipelined_flash_ms": flash,
            "pipelined_flash_queued_ms": flash_queued,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib,
            "library_call": None if lib is None else (
                "F.scaled_dot_product_attention (1,1,L,d)"
                + ("" if w == 1 else f", K/V tiled {w}x")
                + (", TF32 off" if dtype == torch.float32 else "")),
            "live_pairs": flops // (4 * d), "tflops": flops / ms / 1e9})
        del q, k, v
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# the RDMA slice: the ring halo and the fused ring kernel
# ---------------------------------------------------------------------------


def check_ring_kernels(device, rand, failures):
    """The two RDMA ring kernels against their plain versions on the
    self-ring, bit for bit: ``ring_halo`` over float32/bfloat16/float64 ×
    axis 0 (45 and 48 columns), axis 1 and a 1-D column × n_bnd 1..8 ×
    periodic and not × extents under 3·n_bnd, 96 and 97, three chained
    calls each (the epoch counters advance), so that both routes launch
    (``vec16`` where a 48-column row or a 96-wide row's band is whole
    16-byte vectors, ``scalar`` elsewhere and on every staged extent);
    the main paths' operands, each on its route; w = 2 and 4 cross-wired
    instances on both routes and a staged extent, periodic and not,
    against the plain world; the fused kernel against ring_halo →
    stencil2d_iterate (the chained tier) over steps 1, 4, 8 (regs) and 9
    (smem) × the periodic self-ring and ``local_only`` × float32/bfloat16
    × a 16-byte row pitch (regs) and one off it (smem) × nb = 2 and nb > 2
    row blocks, capped and at the default block, 21 chained calls, and
    against its own plain version; w = 2 and 4 cross-wired fused
    instances, periodic and not, with the sends on vec16, scalar and
    staged and the body on both routes, against the plain world; the
    fused main-path operands each on regs. Returns (cases, max abs error
    per kernel and of the cross-wired instances)."""
    import torch

    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.kernels import hand

    n_cases = 0
    errs = {"ring_halo": 0.0, "stencil2d_fused_rdma": 0.0,
            "ring_halo cross-wired": 0.0,
            "stencil2d_fused_rdma cross-wired": 0.0}
    routes0 = dict(hand.ring_halo.launches_by_route)
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        for axis, width in ((0, 45), (0, 48), (1, 37), ("1d", 1)):
            for n_bnd in range(1, 9):
                for periodic in (True, False):
                    for n in sorted({max(2 * n_bnd, 3 * n_bnd - 1), 96,
                                     97}):
                        shape = ((n,) if axis == "1d" else
                                 (n, width) if axis == 0 else (width, n))
                        ax = 0 if axis == "1d" else axis
                        z = rand(shape, dtype)
                        want = z.clone()
                        for _ in range(3):
                            hand.ring_halo(z, axis=ax, n_bnd=n_bnd,
                                           periodic=periodic)
                            hand.ring_halo_ref(want, axis=ax, n_bnd=n_bnd,
                                               periodic=periodic)
                        err = compare(f"ring_halo {dtype} {shape} "
                                      f"axis={axis} n_bnd={n_bnd} "
                                      f"periodic={periodic} route="
                                      f"{hand.halo_route(z, ax, n_bnd)}", z,
                                      want, failures)
                        errs["ring_halo"] = max(errs["ring_halo"], err)
                        n_cases += 1
    took = {r: hand.ring_halo.launches_by_route[r] - routes0[r]
            for r in routes0}
    log(f"CHECK ring_halo launches by route (self-ring cases): "
        f"{json.dumps(took)}")
    if min(took.values()) <= 0:
        failures.append(f"ring_halo: the checks did not launch both routes "
                        f"({took})")
    fused0 = dict(hand.stencil2d_fused_rdma.launches_by_route)
    # rows on 16 bytes (regs), on 8 bytes and off 8 (smem)
    for dtype, widths in ((torch.float32, (300, 302, 301)),
                          (torch.bfloat16, (304, 300, 301))):
        for steps, width, blocks, capped in itertools.product(
                (1, 4, 8, 9), widths, (4, 10), (True, False)):
            K = 2 * steps
            rows, tile = blocks * K, 2 * K if capped else None
            for mode in ("periodic", "local_only"):
                z0 = rand((rows, width), dtype)
                periodic = mode == "periodic"
                fused = H.iterate_fused_rdma_fn(
                    K, 0.01, steps=steps, periodic=periodic,
                    tile_rows=tile, local_only=not periodic)
                a = fused(z0.clone(), RING_CHAIN)
                if periodic:
                    b = H.iterate_hand_fn(K, 0.01, axis=0, steps=steps,
                                          periodic=True,
                                          rdma=True)(z0.clone(),
                                                     RING_CHAIN)
                else:
                    b = H.iterate_hand_fn(K, 0.01, axis=0, steps=steps,
                                          periodic=False)(z0.clone(),
                                                          RING_CHAIN)
                route = hand.kstep_route(z0, 0, steps, fused=True)
                nb = rows // hand.stencil2d_fused_rdma.block_rows
                err = compare(f"fused_rdma {dtype} steps={steps} "
                              f"width={width} nb={nb} {mode} {route} vs "
                              f"chained x{RING_CHAIN}", a, b, failures)
                flags = {"phys_static": (0, 0) if periodic else (1, 1)}
                got = hand.stencil2d_fused_rdma(
                    z0.clone(), 0.01, steps=steps, periodic=periodic,
                    tile_rows=tile, local_only=not periodic, **flags)
                want = hand.stencil2d_fused_rdma_ref(
                    z0.clone(), 0.01, steps=steps, periodic=periodic,
                    tile_rows=tile, local_only=not periodic, **flags)
                err = max(err, compare(
                    f"fused_rdma {dtype} steps={steps} width={width} "
                    f"nb={nb} {mode} {route} vs plain", got, want,
                    failures))
                errs["stencil2d_fused_rdma"] = max(
                    errs["stencil2d_fused_rdma"], err)
                n_cases += 2
    # the main path's operands: the stencil2d --rdma exchanges, the
    # bench's chained dim-1 buffer, the fused operands (the bench's
    # local_only dim-0 buffer and the driver's periodic iterate leg)
    for shape, axis, n_bnd, dtype, route, leg in RING_MAIN_PATH:
        z = rand(shape, getattr(torch, dtype))
        want = hand.ring_halo_ref(z.clone(), axis=axis, n_bnd=n_bnd,
                                  periodic=True)
        before = hand.ring_halo.launches_by_route[route]
        hand.ring_halo(z, axis=axis, n_bnd=n_bnd, periodic=True)
        errs["ring_halo"] = max(errs["ring_halo"], compare(
            f"ring_halo main-path {leg} {shape} axis={axis} {dtype}", z,
            want, failures))
        if hand.ring_halo.launches_by_route[route] != before + 1:
            failures.append(f"ring_halo main-path {leg}: not launched on "
                            f"its operand's route, {route}")
        n_cases += 1
        del z, want
        torch.cuda.empty_cache()
    # cross-wired instances: (dtype, axis, n_bnd, shape) on vec16, vec16,
    # scalar and the staged extent
    for w in (2, 4):
        for periodic in (True, False):
            for dtype, axis, n_bnd, shape in (
                    (torch.float32, 0, 2, (40, 24)),
                    (torch.bfloat16, 1, 8, (37, 96)),
                    (torch.float64, 1, 3, (45, 40)),
                    (torch.float32, 0, 3, (8, 45))):
                shards = [rand(shape, dtype) for _ in range(w)]
                got = hand.cross_wired("ring_halo", shards, axis=axis,
                                       n_bnd=n_bnd, periodic=periodic)
                want = hand.ring_halo_world_ref(
                    [t.cpu() for t in shards], axis=axis, n_bnd=n_bnd,
                    periodic=periodic)
                for r, (g, e) in enumerate(zip(got, want)):
                    errs["ring_halo cross-wired"] = max(
                        errs["ring_halo cross-wired"],
                        compare(f"cross-wired ring_halo w={w} {dtype} "
                                f"{shape} axis={axis} n_bnd={n_bnd} "
                                f"periodic={periodic} rank {r}", g,
                                e.to(device), failures))
                n_cases += 1
    # cross-wired fused instances: (dtype, shape, steps) with the sends
    # on vec16 and the body on regs, the sends scalar and the body on
    # smem (45-element rows), a staged height under 3K (regs), and steps
    # 9 (smem) with vec16 sends
    for w in (2, 4):
        for periodic in (True, False):
            for dtype, shape, steps in (
                    (torch.float32, (40, 96), 2),
                    (torch.bfloat16, (40, 45), 2),
                    (torch.float32, (10, 96), 2),
                    (torch.float64, (60, 40), 9)):
                shards = [rand(shape, dtype) for _ in range(w)]
                kw = {"scale_eps": 0.01, "steps": steps,
                      "periodic": periodic}
                got = hand.cross_wired("stencil2d_fused_rdma", shards, **kw)
                want = hand.stencil2d_fused_rdma_world_ref(
                    [t.cpu() for t in shards], **kw)
                for r, (g, e) in enumerate(zip(got, want)):
                    errs["stencil2d_fused_rdma cross-wired"] = max(
                        errs["stencil2d_fused_rdma cross-wired"],
                        compare(f"cross-wired fused_rdma w={w} {dtype} "
                                f"{shape} steps={steps} periodic={periodic} "
                                f"rank {r}", g, e.to(device), failures))
                n_cases += 1
    took = {r: hand.stencil2d_fused_rdma.launches_by_route[r] - fused0[r]
            for r in fused0}
    log(f"CHECK stencil2d_fused_rdma launches by route (self-ring "
        f"cases): {json.dumps(took)}")
    if min(took.values()) <= 0:
        failures.append(f"stencil2d_fused_rdma: the checks did not launch "
                        f"both routes ({took})")
    for shape, dtype, periodic in FUSED_MAIN_PATH:
        z = rand(shape, getattr(torch, dtype))
        flags = {"phys_static": (0, 0) if periodic else (1, 1)}
        before = hand.stencil2d_fused_rdma.launches_by_route["regs"]
        got = hand.stencil2d_fused_rdma(z.clone(), BENCH_SE, steps=4,
                                        periodic=periodic,
                                        local_only=not periodic, **flags)
        want = hand.stencil2d_fused_rdma_ref(z, BENCH_SE, steps=4,
                                             periodic=periodic,
                                             local_only=not periodic,
                                             **flags)
        errs["stencil2d_fused_rdma"] = max(
            errs["stencil2d_fused_rdma"], compare(
                f"fused_rdma main-path {shape} {dtype} periodic={periodic}",
                got, want, failures))
        if hand.stencil2d_fused_rdma.launches_by_route["regs"] != before + 1:
            failures.append(f"fused_rdma main-path {shape} {dtype}: not "
                            f"launched on the regs route")
        n_cases += 1
        del z, got, want
        torch.cuda.empty_cache()
    return n_cases, errs


# ---------------------------------------------------------------------------
# the collective slice: the ring all-gather, ring reduce-scatter, one-shot
# ---------------------------------------------------------------------------


def coll_main_operands():
    """(kernel, shape, dtype, what) the main paths give the collective
    kernels at world=1: stencil2d --rdma's 2 MiB row, gather_inplace's
    128 Mi float64 shard, collbench's largest (16 MiB) shard, and the
    decode rows' bf16 shards of batch × heads elements (each kernel at
    each batch: the sweep prices every variant at every payload)."""
    decode = tuple(
        (name, (b * DECODE_HEADS,), "bfloat16",
         f"decode {what} batch={b}")
        for b in DECODE_BATCHES
        for name, what in (("ring_reduce_scatter", "allreduce[rdma]"),
                           ("ring_allgather", "allgather[rdma]"),
                           ("oneshot", "*[oneshot]")))
    return (("ring_reduce_scatter", (REF_N_OTHER,), "float32",
             "stencil2d --rdma allreduce row"),
            ("ring_allgather", (GATHER_N,), "float64",
             "gather_inplace --rdma"),
            ("ring_allgather", (COLL_TIMED_N,), "float32",
             "collbench allgather_rdma 16 MiB"),
            ("ring_reduce_scatter", (COLL_TIMED_N,), "float32",
             "collbench allreduce_rdma 16 MiB"),
            ("oneshot", (COLL_TIMED_N,), "float32",
             "collbench *_oneshot 16 MiB")) + decode


def check_coll_kernels(device, rand, failures):
    """The three collective kernels against their plain versions, bit for
    bit: ``ring_allgather`` and ``ring_reduce_scatter`` (credits 1 and 2)
    at world=1 and on the self-ring k = 2, 4, 8 × float32/bfloat16/float64
    × a 1-D and a 2-D shard of 1001·k rows (sizes no TPU tile admits;
    the reduce-scatter's chunks on the scalar route) and of 1024·k rows
    (whole 16-byte vectors: the vec16 route); ``oneshot`` gather and sum
    at world=1 over the three dtypes × 7 and 4096 elements and a (33, 5)
    shard; the main paths' operands (:func:`coll_main_operands`), each
    ring launch counted on the vec16 route; then w = 2 and 4 instances of
    each kernel in this one process, cross-wired on one card
    (``hand.cross_wired``) on shards of 1001·w and 1024·w rows, against
    the plain versions' world computed on the CPU
    (``hand.coll_world_ref``); the one-shot kernel also at w = 8, on
    1001 × 3 (scalar) and 1024 × 3 (vec16) shards. All three kernels
    must have launched on both routes. Returns (cases, max abs error per
    kernel, and the cross-wired one's)."""
    import torch

    from tpu_mpi_tests_torch.kernels import hand

    n_cases = 0
    errs = {"ring_allgather": 0.0, "ring_reduce_scatter": 0.0,
            "oneshot": 0.0, "cross-wired": 0.0}

    def check(name, label, got, want):
        nonlocal n_cases
        errs[name] = max(errs[name], compare(label, got, want, failures))
        n_cases += 1

    routes0 = hand.route_counts()
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        for k, per in itertools.product((None, 2, 4, 8), (1001, 1024)):
            rows = per * (k or 1)
            for shape in ((rows,), (rows, 3)):
                x = rand(shape, dtype)
                check("ring_allgather",
                      f"ring_allgather {dtype} {shape} self_ring={k}",
                      hand.ring_allgather(x, self_ring=k),
                      hand.ring_allgather_ref(x, self_ring=k))
                for credits in (1, 2):
                    check("ring_reduce_scatter",
                          f"ring_reduce_scatter {dtype} {shape} "
                          f"self_ring={k} credits={credits}",
                          hand.ring_reduce_scatter(x, credits, self_ring=k),
                          hand.ring_reduce_scatter_ref(x, credits,
                                                       self_ring=k))
        for shape in ((7,), (4096,), (33, 5)):
            x = rand(shape, dtype)
            for op in ("gather", "sum"):
                check("oneshot", f"oneshot {op} {dtype} {shape}",
                      hand.oneshot(x, op), hand.oneshot_ref(x, op))
    wrappers = {"ring_allgather": (hand.ring_allgather,
                                   hand.ring_allgather_ref),
                "ring_reduce_scatter": (hand.ring_reduce_scatter,
                                        hand.ring_reduce_scatter_ref),
                "oneshot": (hand.oneshot, hand.oneshot_ref)}
    routes = {n: hand.route_counts()[n] for n in ROUTED_COLLECTIVES}
    for n in ROUTED_COLLECTIVES:
        took = {r: routes[n][r] - routes0[n][r] for r in routes[n]}
        log(f"CHECK {n} launches by route (self-ring and world=1 "
            f"cases): {json.dumps(took)}")
        if min(took.values()) <= 0:
            failures.append(f"{n}: the checks did not launch both routes "
                            f"({took})")
    for name, shape, dtype, what in coll_main_operands():
        x = rand(shape, getattr(torch, dtype))
        kernel, plain = wrappers[name]
        before = hand.route_counts().get(name)
        check(name, f"{name} main-path {what} {shape} {dtype}", kernel(x),
              plain(x))
        if before is not None:  # every main-path shard: on vec16
            after = hand.route_counts()[name]
            took = {r: after[r] - before[r] for r in after}
            if took != {"scalar": 0, "vec16": 1}:
                failures.append(f"{name} main-path {what}: launches by "
                                f"route {took}, want one on vec16")
        if name == "oneshot":
            check(name, f"oneshot sum main-path {what}", kernel(x, "sum"),
                  plain(x, "sum"))
        del x
        torch.cuda.empty_cache()
    for name in ("ring_allgather", "ring_reduce_scatter",
                 "oneshot_allgather", "oneshot_allreduce"):
        ring = name.startswith("ring")
        for w in (2, 4) if ring else (2, 4, 8):
            for dtype in (torch.float32, torch.bfloat16):
                for credits, per in itertools.product(
                        (1, 2) if name == "ring_reduce_scatter" else (1,),
                        (1001, 1024)):
                    # one-shot shards of 1001 × 3 elements take the scalar
                    # route, of 1024 × 3 vec16, at every w
                    rows = w * per if ring else per
                    shards = [rand((rows, 3), dtype) for _ in range(w)]
                    got = hand.cross_wired(name, shards, credits=credits)
                    want = hand.coll_world_ref(
                        name, [t.cpu() for t in shards])
                    for r, (g, e) in enumerate(zip(got, want)):
                        errs["cross-wired"] = max(
                            errs["cross-wired"],
                            compare(f"cross-wired {name} w={w} {dtype} "
                                    f"credits={credits} rows={rows} "
                                    f"rank {r}", g,
                                    e.to(device), failures))
                    n_cases += 1
    log(f"CHECK collectives: {n_cases} cases bit-exact so far "
        f"(cross-wired w = 2 and 4, and 8 for the one-shot kernel, on one "
        f"card among them)")
    return n_cases, errs


def collbench_calls():
    """Launches of one collbench row's body per size of the ladder:
    chain_rate's 3 warm calls, n_short and n_long (the JAX n_eff rule)."""
    calls = 0
    for kib in COLLBENCH_SIZES_KIB:
        shard = kib * 1024
        n_eff = min(max(COLLBENCH_N_ITER, 100_000),
                    max(COLLBENCH_N_ITER,
                        COLLBENCH_N_ITER * (1 << 20) // shard))
        calls += 3 + (n_eff // 10 or 1) + n_eff
    return calls


def run_coll_slice(device, counts, peaks):
    """The collective slice's paths, each alone with exact launch counts:
    ``gather_inplace --rdma`` at 128 Mi float64 (one ring all-gather), and
    ``collbench`` over the library and both hand tiers at its default
    ladder (one kernel launch per chained iteration of a hand-tier row;
    at world=1 the ring allreduce is one reduce-scatter launch). Returns
    the collbench rows."""
    import re

    from tpu_mpi_tests_torch.drivers import collbench, gather_inplace

    path = "gather_inplace --rdma"
    counts[path] = drive_driver(
        path, gather_inplace, ["--device", device.type, "--n-per-rank",
                               str(GATHER_N), "--dtype", "float64",
                               "--rdma"], ["ring_allgather"],
        (f"0/1 lsum={GATHER_N:.1f} asum={GATHER_N:.1f}",), peaks)
    _exact(path, counts[path], {"ring_allgather": 1})
    check_routes(path, "ring_allgather", {"vec16": 1})

    path = "collbench"
    out = {}

    def run():
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = collbench.main(["--device", device.type, "--collectives",
                                 ",".join(COLLBENCH_NAMES)])
        out["text"] = buf.getvalue()
        return rc

    log("DRIVER python -m tpu_mpi_tests_torch.drivers.collbench "
        f"--collectives {','.join(COLLBENCH_NAMES)}")
    rc, counts[path] = drive_path(path, run, ["ring_allgather",
                                              "ring_reduce_scatter",
                                              "oneshot"], peaks)
    for line in out["text"].splitlines():
        log(f"  {line}")
    rows = re.findall(collbench.COLL_LINE_RE, out["text"])
    if rc != 0 or [r[0] for r in rows] != [
            n for n in COLLBENCH_NAMES for _ in COLLBENCH_SIZES_KIB]:
        raise SmokeFailure(f"{path}: rc={rc}, rows {rows}")
    # a row is NaN where its chain's two lengths did not difference to a
    # positive time (chain_rate; the JAX driver prints such rows too):
    # host noise over a host-bound chain, counted here, not a fault
    nan_rows = [f"{r[0]} bytes={r[1]}" for r in rows if r[2] == "nan"]
    for name, nbytes, us, busbw, n_iter, _ in rows:
        if not (float(us) > 0 or us == "nan") or busbw not in ("0", "nan"):
            raise SmokeFailure(f"{path}: row {name} bytes={nbytes} is not "
                               f"a world=1 row ({us} us/iter, busbw "
                               f"{busbw})")
    log(f"COLLBENCH {len(rows)} rows, {len(nan_rows)} NaN {nan_rows}")
    calls = collbench_calls()
    _exact(path, counts[path], {"ring_allgather": calls,
                                "ring_reduce_scatter": calls,
                                "oneshot": 2 * calls})
    # every hand-tier row's shard (4 KiB-16 MiB) is whole 16-byte vectors
    for name in ("ring_allgather", "ring_reduce_scatter"):
        check_routes(path, name, {"vec16": calls})
    check_routes(path, "oneshot", {"vec16": 2 * calls})
    return [{"collective": r[0], "bytes": int(r[1]), "us_per_iter":
             float(r[2]), "n": int(r[4])} for r in rows]


def time_coll_kernels(device, gen):
    """Per-launch device times of the collective kernels (CUDA events,
    warmed, the launches queued behind a stall: most of these launches are
    shorter than their wrappers' host cost, which ``ms_host_loop`` shows):
    at a 16 MiB float32 shard on the 4-step self-ring (the all-gather and
    the reduce-scatter at credits 1 and 2) and the world=1 one-shot
    (gather and sum), then at the main paths' world=1 operands (copies).
    Bound: bytes, the shard read once and the output written once, over
    3.35 TB/s. Yardsticks, one torch call each: ``torch.tile(x, (k,))``
    for the all-gather self-ring, ``x.view(k, -1).sum(0)`` for the
    reduce-scatter self-ring, ``x.clone()`` for a world=1 copy."""
    import torch

    from tpu_mpi_tests_torch.kernels import hand

    k = COLL_TIMED_K
    rows = {"ring_allgather": [], "ring_reduce_scatter": [], "oneshot": []}

    def timed(fn, n=20):
        return {"ms": time_cuda_queued(fn, n),
                "ms_host_loop": time_cuda(fn, n)}

    x = torch.randn(COLL_TIMED_N, generator=gen, device=device)
    nb = x.numel() * x.element_size()
    rows["ring_allgather"].append({
        "path": "self-ring (k=4), 16 MiB float32 shard", "self_ring": k,
        "shape": [COLL_TIMED_N], "dtype": "float32",
        "route": hand.coll_route(x, x.numel()),
        **timed(lambda: hand.ring_allgather(x, self_ring=k)),
        "plain_ms": time_cuda_queued(lambda: hand.ring_allgather_ref(
            x, self_ring=k), 20),
        "bound_ms": (nb + k * nb) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes",
        "library_ms": time_cuda_queued(lambda: torch.tile(x, (k,)), 20),
        "library_call": "torch.tile(x, (k,))"})
    for credits in (1, 2):
        rows["ring_reduce_scatter"].append({
            "path": "self-ring (k=4), 16 MiB float32 shard", "self_ring": k,
            "credits": credits, "shape": [COLL_TIMED_N], "dtype": "float32",
            "route": hand.coll_route(x, x.numel() // k),
            **timed(lambda: hand.ring_reduce_scatter(
                x, credits, self_ring=k)),
            "plain_ms": time_cuda_queued(lambda: hand.ring_reduce_scatter_ref(
                x, credits, self_ring=k), 20),
            "bound_ms": (nb + nb // k) / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": time_cuda_queued(lambda: x.view(k, -1).sum(0),
                                           20),
            "library_call": "x.view(k, -1).sum(0)"})
    for op in ("gather", "sum"):
        rows["oneshot"].append({
            "path": "world=1, 16 MiB float32 shard", "op": op,
            "shape": [COLL_TIMED_N], "dtype": "float32",
            "route": hand.coll_route(x, x.numel()),
            **timed(lambda: hand.oneshot(x, op)),
            "plain_ms": time_cuda_queued(lambda: hand.oneshot_ref(x, op),
                                         20),
            "bound_ms": 2 * nb / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes",
            "library_ms": time_cuda_queued(lambda: x.clone(), 20),
            "library_call": "x.clone()"})
    del x
    kernels = {"ring_allgather": (hand.ring_allgather,
                                  hand.ring_allgather_ref),
               "ring_reduce_scatter": (hand.ring_reduce_scatter,
                                       hand.ring_reduce_scatter_ref),
               "oneshot": (hand.oneshot, hand.oneshot_ref)}
    for name, shape, dtype, what in coll_main_operands():
        if name == "oneshot" and shape == (COLL_TIMED_N,):
            continue  # timed above: the same shard and dtype
        x = torch.randn(shape, generator=gen, device=device).to(
            getattr(torch, dtype))
        kernel, plain = kernels[name]
        nb = x.numel() * x.element_size()
        n = 5 if nb > 1 << 28 else 20
        for op in ("gather", "sum") if name == "oneshot" else (None,):
            args = (x,) if op is None else (x, op)
            rows[name].append({
                "path": f"{what} (world=1: a copy)", "shape": list(shape),
                "dtype": dtype, "route": hand.coll_route(x, x.numel()),
                **({} if op is None else {"op": op}),
                **timed(lambda: kernel(*args), n),
                "plain_ms": time_cuda_queued(lambda: plain(*args), n),
                "bound_ms": 2 * nb / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes",
                "library_ms": time_cuda_queued(lambda: x.clone(), n),
                "library_call": "x.clone()"})
        del x
        torch.cuda.empty_cache()
    if torch.cuda.device_count() < 2:
        log(f"TIME collectives: NCCL's calls not timed — "
            f"torch.cuda.device_count() is {torch.cuda.device_count()}; "
            f"the world=2 NCCL leg times them where there are two cards")
    return rows


#: the NCCL leg's parts, in the order a rank runs them
WORLD2_LEGS = ("rdma", "staged", "collectives", "attention", "grid",
               "tune", "coll_tune")
#: the legs that run at world 4 too, where there are four cards
WORLD4_LEGS = ("grid", "tune")
#: the process grids the grid leg runs at each world
GRID_LEG_GRIDS = {2: ((1, 2), (2, 1)), 4: ((2, 2),)}


def rdma_world2_legs(legs=WORLD2_LEGS):
    """The multi-rank legs on the card. Two ranks on one card cannot
    share symmetric memory (PERF.md: the allocator refuses overlapping
    devices), so that leg is left out; the NCCL leg needs two cards.
    ``legs`` picks its parts (:data:`WORLD2_LEGS`): the RDMA halo tiers,
    the hand-staged exchange, the collective kernels against NCCL and
    timed beside it, attention over the ranks."""
    import torch

    unknown = set(legs) - set(WORLD2_LEGS)
    if unknown:
        raise SmokeFailure(f"unknown world=2 legs {sorted(unknown)}; "
                           f"the legs are {WORLD2_LEGS}")
    n = torch.cuda.device_count()
    log("RDMA world=2 on one card: not run — torch's symmetric-memory "
        "rendezvous refuses two ranks on one device (\"detected "
        "allocations from overlapping devices from different ranks\")")
    if n < 2:
        log(f"RDMA world=2 NCCL leg: not run — torch.cuda.device_count() "
            f"is {n}, the leg needs two cards")
        if "grid" in legs:
            log(f"GRID leg: not run — torch.cuda.device_count() is {n}; "
                f"the 1x2 and 2x1 grids need two cards, the 2x2 grid four "
                f"(check_grid_blocks holds each rank's block on this one)")
        return
    import torch.multiprocessing as mp

    # the ranks meet through a file of their own, so that runs sharing a
    # host never meet on one port
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_nccl_rank, args=(2, f"file://{tmp}/rendezvous",
                                   tuple(legs)), nprocs=2, join=True)
    at4 = tuple(leg for leg in legs if leg in WORLD4_LEGS)
    if at4:
        if n >= 4:
            with tempfile.TemporaryDirectory() as tmp:
                mp.spawn(_nccl_rank, args=(4, f"file://{tmp}/rendezvous",
                                           at4), nprocs=4, join=True)
        else:
            log(f"{'/'.join(at4)} legs world=4: not run — "
                f"torch.cuda.device_count() is {n}, they need four cards")
    done = {"rdma": f"fused == chained bit for bit over {RING_CHAIN} "
                    f"calls, the RDMA exchange equal to DIRECT on both "
                    f"ranks and both routes, {PAIR_RUNS} runs on fresh "
                    f"inputs without growth, ring_halo timed beside the "
                    f"torch exchange, the fused kernel beside the "
                    f"chained pair",
            "staged": "the hand-staged exchange equal to DIRECT at the "
                      "stencil2d dim-1 shard, pack and unpack on vec8, "
                      "timed beside DIRECT",
            "collectives": "the collective kernels' tiers equal to NCCL's "
                           "calls on both routes, timed beside them",
            "attention": "ring attention's tiers (depth 1 and 2, fused) "
                         "and Ulysses over the two ranks bit for bit "
                         "their one-process counterparts",
            "grid": "the 1x2 and 2x1 grids (and 2x2 on four cards) equal "
                    "to rank 0's 1x1 run bit for bit, and their overlap "
                    "pipelines at depth 2 equal to depth 1 bit for bit "
                    "and to the 1x1 run within JAX's tolerances",
            "tune": "stencil2d --iterate-tier auto --tune at world 2 (and "
                    "4 on four cards): rank 0 swept stencil/tier, every "
                    "rank ran its winner, only rank 0's cache was written, "
                    "and the tuned, cache-hit and explicit runs' fields "
                    "are equal bit for bit on every rank",
            "coll_tune": "collbench --collectives auto --tune over the two "
                         "ranks: rank 0 swept coll_variant/*, every rank "
                         "ran the same winners, only rank 0's cache was "
                         "written, each rank's JSONL its own .p<r> file "
                         "with its clock_sync offset; attnbench --tune: "
                         "rank 0 swept ring/pipeline_depth (depth 4 "
                         "declined) and ring/tier, every rank ran the "
                         "winners, the ring through the cache equal to "
                         "the explicit winner and depths 1 and 2 bit for "
                         "bit"}
    log("RDMA world=2 NCCL leg: " + "; ".join(done[leg] for leg in legs))


#: runs on fresh inputs in the NCCL leg's peer-memory lifetime check
PAIR_RUNS = 6


def _nccl_rank(rank, world, init_method, legs=WORLD2_LEGS):
    """One rank of the NCCL leg, the parts ``legs`` picks: the RDMA halo
    tiers (:func:`_nccl_rdma`), the hand-staged exchange
    (:func:`_nccl_staged`), the collective kernels
    (:func:`_nccl_collectives`), attention over the ranks
    (:func:`_nccl_attention`)."""
    import torch
    import torch.distributed as tdist

    from tpu_mpi_tests_torch.comm import dist

    torch.cuda.set_device(rank)
    tdist.init_process_group("nccl", init_method=init_method, rank=rank,
                             world_size=world)
    try:
        dist.init("cuda")
        gen = torch.Generator(device="cuda").manual_seed(77)
        if "rdma" in legs:
            _nccl_rdma(rank, gen)
        if "staged" in legs:
            _nccl_staged(rank, gen)
        if "collectives" in legs:
            _nccl_collectives(rank, world, gen)
        if "attention" in legs:
            _nccl_attention(rank, world)
        if "grid" in legs:
            _nccl_grid(rank, world, gen)
        if "tune" in legs:
            _nccl_tune(rank, world,
                       os.path.dirname(init_method[len("file://"):]))
        if "coll_tune" in legs:
            _nccl_coll_tune(rank, world,
                            os.path.dirname(init_method[len("file://"):]))
            _nccl_ring_tune(rank, world,
                            os.path.dirname(init_method[len("file://"):]))
    finally:
        dist.shutdown()


def _nccl_tune(rank, world, tmp):
    """The schedule plane over ``world`` ranks, one card each: ``stencil2d
    --iterate-tier auto --tune`` at the reference sizes with a cache file
    a rank (rank 0 sweeps the tiers and decides, every rank applies its
    winner; only rank 0's file may be written), then the same run on the
    caches without ``--tune`` (rank 0's hit decides), then the explicit
    winner; each rank's iterate field must be the same bit for bit in the
    three runs, and every rank must run one tier."""
    import torch.distributed as tdist

    from tpu_mpi_tests_torch.comm import dist
    from tpu_mpi_tests_torch.drivers import stencil2d
    from tpu_mpi_tests_torch.instrument.report import rank_suffixed_path
    from tpu_mpi_tests_torch.tune import fleet

    own = os.path.join(tmp, f"tune.r{rank}.json")
    base = ["--device", dist.world().device.type, "--n-local", str(REF_N_LOCAL), "--n-other",
            str(REF_N_OTHER), "--iterate-steps", "4", "--iterate-iters",
            str(DRIVER_ITERATE_ITERS), "--iterate-only"]
    texts, bits = {}, {}
    for name, extra in (("sweep", ["--iterate-tier", "auto", "--tune",
                                   "--tune-budget", str(TUNE_BUDGET_S),
                                   "--tune-cache", own]),
                        ("hit", ["--iterate-tier", "auto", "--tune-cache",
                                 own]),
                        ("explicit", None)):
        if extra is None:
            winner = fleet.bcast(
                texts["sweep"].split("ITER tier=")[1].split()[0]
                if rank == 0 else None, "smoke:winner")
            extra = ["--iterate-tier", winner]
        jl = os.path.join(tmp, f"{name}.jsonl")
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = stencil2d.main(base + extra + ["--jsonl", jl])
        texts[name] = out.getvalue()
        if rc != 0 or "FAIL" in texts[name]:
            raise SmokeFailure(f"tune leg world={world} rank {rank} {name}: "
                               f"rc={rc}\n{texts[name]}")
        bits[name] = _iterate_bits(rank_suffixed_path(jl, rank))
    tiers = [None] * world
    tdist.all_gather_object(tiers, {n: t.split("ITER tier=")[1].split()[0]
                                    for n, t in texts.items()})
    if len({json.dumps(t, sort_keys=True) for t in tiers}) != 1 or \
            len(set(tiers[0].values())) != 1:
        raise SmokeFailure(f"tune leg world={world}: the ranks ran "
                           f"different tiers {tiers}")
    if len(set(bits.values())) != 1:
        raise SmokeFailure(f"tune leg world={world} rank {rank}: the tuned "
                           f"fields differ from the explicit winner's {bits}")
    if "TUNE stencil/tier cache-hit" not in texts["hit"] or \
            "winner=" in texts["hit"]:
        raise SmokeFailure(f"tune leg world={world} rank {rank}: the rerun "
                           f"swept\n{texts['hit']}")
    tdist.barrier()
    written = [os.path.exists(os.path.join(tmp, f"tune.r{r}.json"))
               for r in range(world)]
    if written != [True] + [False] * (world - 1):
        raise SmokeFailure(f"tune leg world={world}: cache files written "
                           f"by ranks {written}")
    if rank == 0:
        for line in texts["sweep"].splitlines():
            if line.startswith(("TUNE", "ITER")):
                log(f"  TUNE leg world={world}: {line}")
        for r in _jsonl_records(rank_suffixed_path(
                os.path.join(tmp, "sweep.jsonl"), 0), "tune"):
            log(f"  TUNE leg world={world}: SWEEP {r['knob']} "
                f"{r['candidate']}: {r.get('seconds')} s/timestep "
                f"{r.get('error', '')}")
        log(f"TUNE leg world={world}: every rank ran {tiers[0]['sweep']}; "
            f"only rank 0's cache written; fields equal bit for bit "
            f"(rank 0 bits {bits['explicit']})")



def _nccl_coll_tune(rank, world, tmp):
    """``collbench --collectives auto --tune`` at the driver's ladder over
    ``world`` ranks, one card each, with a JSONL (no ``--telemetry``: a
    span's device-wide wait would be priced with each candidate): rank
    0 sweeps the variants (its ``tune`` records alone), every rank runs
    the broadcast winners (the same ``COLL`` rows), only rank 0's cache
    file is written, and each rank's records go to its own ``.p<r>``
    file, opened by the barrier-echo ``clock_sync``. Then the ring's
    schedule (:func:`_nccl_ring_tune`)."""
    import torch.distributed as tdist

    from tpu_mpi_tests_torch.comm import dist
    from tpu_mpi_tests_torch.drivers import collbench
    from tpu_mpi_tests_torch.instrument.report import rank_suffixed_path

    own = os.path.join(tmp, f"coll_tune.r{rank}.json")
    jl = os.path.join(tmp, "coll_tune.jsonl")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = collbench.main([
            "--device", dist.world().device.type, "--collectives", "auto",
            "--sizes-kib", ",".join(str(k) for k in COLLBENCH_SIZES_KIB),
            "--n-iter", str(INSTR_COLL_N_ITER), "--tune", "--tune-budget",
            str(TUNE_BUDGET_S), "--tune-cache", own, "--jsonl", jl])
    text = out.getvalue()
    if rc != 0 or "FAIL" in text:
        raise SmokeFailure(f"coll_tune leg rank {rank}: rc={rc}\n{text}")
    mine = rank_suffixed_path(jl, rank)
    measured = _jsonl_records(mine, "tune")
    results = {r["knob"] + " " + r["fingerprint"]: r["value"]
               for r in _jsonl_records(mine, "tune_result")}
    (sync,) = _jsonl_records(mine, "clock_sync")
    every = [None] * world
    tdist.all_gather_object(every, {"rows": _coll_rows(text),
                                    "results": results,
                                    "measured": len(measured),
                                    "sync": sync})
    tdist.barrier()
    written = [os.path.exists(os.path.join(tmp, f"coll_tune.r{r}.json"))
               for r in range(world)]
    if rank != 0:
        return
    if any(e["rows"] != every[0]["rows"] or e["results"] !=
           every[0]["results"] for e in every):
        raise SmokeFailure(f"coll_tune leg: the ranks ran different "
                           f"winners {every}")
    if [bool(e["measured"]) for e in every] != [True] + [False] * (
            world - 1) or written != [True] + [False] * (world - 1):
        raise SmokeFailure(f"coll_tune leg: measured {[e['measured'] for e in every]}, "
                           f"caches written {written}")
    if any(e["sync"]["method"] != "barrier_echo" for e in every):
        raise SmokeFailure(f"coll_tune leg: clock_sync {every}")
    for line in text.splitlines():
        if line.startswith(("TUNE", "COLL")):
            log(f"  COLL_TUNE leg world={world}: {line}")
    for r in measured:
        log(f"  COLL_TUNE leg world={world}: SWEEP {r['knob']} "
            f"{r['candidate']}: {r.get('seconds')} {r.get('error', '')}")
    log(f"COLL_TUNE leg world={world}: every rank ran "
        f"{[row[0] for row in every[0]['rows']]}; only rank 0 measured and "
        f"wrote its cache; clock_sync offsets "
        f"{[e['sync']['offset_s'] for e in every]} s, spreads "
        f"{[e['sync']['spread_s'] for e in every]} s")


def _nccl_ring_tune(rank, world, tmp):
    """``attnbench --tiers ring --tune`` at L=8192, d=128, bf16 ``--fast``
    over ``world`` ranks, where a ring depth above 1 runs: rank 0 sweeps
    ``ring/pipeline_depth`` (the depths above the world declined with
    the ring's clamp as the reason, the others measured) and
    ``ring/tier``, every rank applies the broadcast winners; then every
    rank resolves the ring through rank 0's cache, and that output, the
    explicit winner's and depth 1's and 2's of the winning tier are
    equal bit for bit on every rank."""
    import torch
    import torch.distributed as tdist

    from tpu_mpi_tests_torch.comm import ring as R
    from tpu_mpi_tests_torch.comm.collectives import shard_1d
    from tpu_mpi_tests_torch.drivers import attnbench
    from tpu_mpi_tests_torch.instrument.report import rank_suffixed_path
    from tpu_mpi_tests_torch.kernels import hand
    from tpu_mpi_tests_torch.tune import registry as treg

    jl = os.path.join(tmp, "ring_tune.jsonl")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = attnbench.main([
            "--device", "cuda", "--tiers", "ring", "--seq-len", str(ATTN_L),
            "--head-dim", str(ATTN_D), "--dtype", "bfloat16", "--fast",
            "--n-iter", str(INSTR_ATTN_N_ITER), "--tune", "--tune-budget",
            str(TUNE_BUDGET_S), "--tune-cache",
            os.path.join(tmp, f"ring_tune.r{rank}.json"), "--jsonl", jl])
    text = out.getvalue()
    if rc != 0 or "FAIL" in text:
        raise SmokeFailure(f"ring tune leg rank {rank}: rc={rc}\n{text}")
    mine = rank_suffixed_path(jl, rank)
    got = {r["knob"]: r["value"] for r in _jsonl_records(mine, "tune_result")}
    depths = {r["candidate"]: r for r in _jsonl_records(mine, "tune")
              if r["knob"] == "ring/pipeline_depth"}
    every = [None] * world
    tdist.all_gather_object(every, got)
    if any(e != got for e in every) or set(got) != {"ring/pipeline_depth",
                                                     "ring/tier"}:
        raise SmokeFailure(f"ring tune leg: winners by rank {every}")
    # the ring through rank 0's cache == the explicit winner == depth 1
    # and 2 of the winning tier, bit for bit
    gen = torch.Generator(device="cuda").manual_seed(21)
    g = [torch.randn((ATTN_L, ATTN_D), generator=gen, device="cuda")
         .to(torch.bfloat16) for _ in range(3)]
    qkv = [shard_1d(t, "cuda") for t in g]
    treg.configure(cache_path=os.path.join(tmp, "ring_tune.r0.json"))
    try:
        with hand.matmul_precision("default"):
            outs = [R.ring_attention_fn(world, flash=True,
                                        precision="default", depth=dp,
                                        tier=tier)(*qkv)
                    for dp, tier in ((None, None),
                                     (got["ring/pipeline_depth"],
                                      got["ring/tier"]),
                                     (1, got["ring/tier"]),
                                     (2, got["ring/tier"]))]
        torch.cuda.synchronize()
    finally:
        treg.deconfigure()
    same = all(torch.equal(outs[0], o) for o in outs[1:])
    every = [None] * world
    tdist.all_gather_object(every, same)
    if not all(every):
        raise SmokeFailure(f"ring tune leg: the ring through the cache, "
                           f"the explicit winner and depths 1 and 2 differ "
                           f"(bit-equal by rank: {every})")
    if rank != 0:
        return
    # rank 0's sweep records, read after the last collective
    for cand, r in sorted(depths.items()):
        log(f"  RING_TUNE leg world={world}: SWEEP ring/pipeline_depth "
            f"{cand}: {r.get('seconds')} {r.get('error', '')}")
        declined = cand > world
        if (r.get("seconds") is None) != declined or (
                declined and "clamps the depth to the world"
                not in r.get("error", "")):
            raise SmokeFailure(f"ring tune leg: depth candidate {r}")
    if sorted(depths) != [1, 2, 4] or got["ring/pipeline_depth"] > world:
        raise SmokeFailure(f"ring tune leg: depth records {depths}, "
                           f"winner {got}")
    for r in _jsonl_records(mine, "tune"):
        if r["knob"] == "ring/tier":
            log(f"  RING_TUNE leg world={world}: SWEEP ring/tier "
                f"{r['candidate']}: {r.get('seconds')} "
                f"{r.get('error', '')}")
    log(f"RING_TUNE leg world={world}: winners {json.dumps(got)} on "
        f"every rank; the ring through rank 0's cache == the explicit "
        f"winner == depth 1 == depth 2, bit for bit")


def _grid_leg_launches(name, run, want):
    """``run()``, failing unless its launches of the grid's kernels are
    ``want`` (kernel -> {route: count}); returns (result, launches)."""
    from tpu_mpi_tests_torch.kernels import hand

    before = hand.route_counts()
    got = run()
    after = hand.route_counts()
    took = {k: {r: after[k][r] - before[k][r] for r in after[k]
                if after[k][r] - before[k][r]}
            for k in ("heat2d", "dual_dim_step", "pack_edges",
                      "unpack_ghosts")}
    if took != {k: want.get(k, {}) for k in took}:
        raise SmokeFailure(f"{name}: launches by route {took}, the grid's "
                           f"schedule makes {want}")
    return got, took


def _nccl_grid(rank, world, gen):
    """The 2-D process grids over the ranks (:data:`GRID_LEG_GRIDS`):
    per grid, weak-scaled (each rank the one-card block), the heat runner
    with ``kernel="hand"`` at :data:`HEAT_RUNS` for
    :data:`GRID_LEG_BODIES` bodies and ``step2d_fn(kernel="hand")`` in
    float32 for as many steps, on blocks cut from one global field that
    every rank makes from the same seed; rank 0 runs the same global
    field as one 1x1 block on its own card (``mesh.local_grid``) and the
    ranks' interiors, gathered to it, must equal that run bit for bit;
    the residual, a world sum in another order, within
    ``hand.RESIDUAL_RTOL``. Each rank's launches are exact: one heat or
    dual-step launch a body, one pack and one unpack a body where the
    row ring has two ranks (its strided axis-1 bands leave the rank),
    each on its operand's route; they are logged as ``LAUNCHES grid``."""
    import numpy as np
    import torch
    import torch.distributed as tdist

    from tpu_mpi_tests_torch.comm import collectives as C
    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.comm.mesh import local_grid, make_grid
    from tpu_mpi_tests_torch.convert import grid_join
    from tpu_mpi_tests_torch.drivers import heat2d
    from tpu_mpi_tests_torch.kernels import hand

    tdist.barrier()
    launches = {}
    for px, py in GRID_LEG_GRIDS[world]:
        grid = make_grid(px, py)
        tag = f"{px}x{py}"
        nx, ny = px * GRID_N, py * GRID_N
        _, cx, cy = heat2d.coefficients(nx, ny, 0.1)
        for dt, k in HEAT_RUNS:
            dtype = getattr(torch, dt)
            g = torch.Generator(device="cuda").manual_seed(1000 + k)
            inner = torch.randn((nx, ny), generator=g, device="cuda").to(
                dtype)
            blk = torch.zeros((GRID_N + 2 * k,) * 2, dtype=dtype,
                              device="cuda")
            blk[k:-k, k:-k] = inner[grid.rx * GRID_N:(grid.rx + 1) * GRID_N,
                                    grid.ry * GRID_N:(grid.ry + 1) * GRID_N]
            run = H.heat_step2d_fn(k, cx, cy, steps=k, kernel="hand",
                                   grid=grid)
            band = hand.pack_route(blk, 1, k)
            want = {"heat2d": {hand.heat_route(blk, k): GRID_LEG_BODIES}}
            if py > 1:
                want |= {"pack_edges": {band: GRID_LEG_BODIES},
                         "unpack_ghosts": {band: GRID_LEG_BODIES}}
            out, took = _grid_leg_launches(
                f"grid {tag} heat {dt} k={k} rank {rank}",
                lambda: run(blk, GRID_LEG_BODIES), want)
            launches[f"{tag} heat2d {dt} k={k}"] = took
            torch.cuda.synchronize()
            got = C.gather_blocks(out[k:-k, k:-k])
            del out, blk
            if rank == 0:
                whole = torch.zeros((nx + 2 * k, ny + 2 * k), dtype=dtype,
                                    device="cuda")
                whole[k:-k, k:-k] = inner
                ref = H.heat_step2d_fn(k, cx, cy, steps=k, kernel="hand",
                                       grid=local_grid())(whole,
                                                          GRID_LEG_BODIES)
                ref = C.host_value(ref[k:-k, k:-k])
                joined = grid_join(got, px, py)
                if not np.array_equal(joined, ref):
                    bad = int(np.sum(joined != ref))
                    raise SmokeFailure(
                        f"grid {tag} heat {dt} k={k}: the ranks' field "
                        f"differs from the 1x1 run at {bad} points")
                log(f"GRID leg world={world} {tag} heat2d {dt} k={k} "
                    f"{GRID_LEG_BODIES} bodies, {GRID_N}x{GRID_N} a rank: "
                    f"equal to the 1x1 run of {nx}x{ny} bit for bit")
                del whole, ref, joined
            del inner, got
            torch.cuda.empty_cache()
        # the grid step: the 1x1 field's physical ghosts on the grid's
        # edges, its neighbours' interiors for the exchange to deliver
        s = GRID_SCALE
        g = torch.Generator(device="cuda").manual_seed(2000)
        field = torch.randn((nx + 4, ny + 4), generator=g, device="cuda")
        blk = field[grid.rx * GRID_N:grid.rx * GRID_N + GRID_N + 4,
                    grid.ry * GRID_N:grid.ry * GRID_N + GRID_N + 4].clone()
        if grid.rx > 0:
            blk[:2] = 0
        if grid.rx < px - 1:
            blk[-2:] = 0
        if grid.ry > 0:
            blk[:, :2] = 0
        if grid.ry < py - 1:
            blk[:, -2:] = 0
        step = H.step2d_fn(2, s, s, kernel="hand", grid=grid)
        band = hand.pack_route(blk, 1, 2)
        want = {"dual_dim_step": {hand.dual_route(blk): GRID_LEG_BODIES}}
        if py > 1:
            want |= {"pack_edges": {band: GRID_LEG_BODIES},
                     "unpack_ghosts": {band: GRID_LEG_BODIES}}

        def steps():
            for _ in range(GRID_LEG_BODIES):
                out = step(blk)
            return out

        (dx, dy, res), took = _grid_leg_launches(
            f"grid {tag} step rank {rank}", steps, want)
        launches[f"{tag} step2d float32"] = took
        got_x, got_y = C.gather_blocks(dx), C.gather_blocks(dy)
        if rank == 0:
            wx, wy, wr = H.step2d_fn(2, s, s, kernel="hand",
                                     grid=local_grid())(field)
            for name, got, want_t in (("dz_dx", got_x, wx),
                                      ("dz_dy", got_y, wy)):
                if not np.array_equal(grid_join(got, px, py),
                                      C.host_value(want_t)):
                    raise SmokeFailure(f"grid {tag} step {name}: the "
                                       f"ranks' field differs from the "
                                       f"1x1 run")
            rel = abs(float(res) - float(wr)) / abs(float(wr))
            if not rel <= hand.RESIDUAL_RTOL[torch.float32]:
                raise SmokeFailure(f"grid {tag} step residual {float(res)!r}"
                                   f" vs the 1x1 run's {float(wr)!r}")
            log(f"GRID leg world={world} {tag} step2d float32, "
                f"{GRID_N}x{GRID_N} a rank: dz_dx, dz_dy equal to the 1x1 "
                f"run bit for bit, residual relative {rel:.3g} (tolerance "
                f"{hand.RESIDUAL_RTOL[torch.float32]:g})")
            del wx, wy, wr
        del field, blk, dx, dy, got_x, got_y
        torch.cuda.empty_cache()
    log(f"LAUNCHES grid world={world} rank {rank} {json.dumps(launches)}")
    _nccl_grid_overlap(rank, world)


def _nccl_grid_overlap(rank, world):
    """The overlap engine over the ranks (:data:`GRID_LEG_GRIDS`): per
    grid, weak-scaled (8192² a rank), the heat pipeline (float32,
    periodic, ghost width 1) for :data:`GRID_LEG_BODIES` rounds and the
    grid step (float32) under ``OverlapRunner`` at depth 1 and 2: depth 2
    equal to depth 1 bit for bit on every rank, its exchanges on the
    runner's comm stream; and rank 0's 1x1 run of the global field (the
    torch serial bodies on ``mesh.local_grid``) matched within JAX's
    fused-body tolerances (:data:`OVERLAP_TOL`), the largest error
    logged."""
    import numpy as np
    import torch

    from tpu_mpi_tests_torch.comm import collectives as C
    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.comm.mesh import local_grid, make_grid
    from tpu_mpi_tests_torch.convert import grid_join
    from tpu_mpi_tests_torch.drivers import heat2d

    def against_1x1(name, got, ref, tol):
        joined = grid_join(got, px, py).astype(np.float64)
        ref = ref.astype(np.float64)
        if not np.allclose(joined, ref, rtol=tol[0], atol=tol[1]):
            raise SmokeFailure(f"{name}: the ranks' field differs from the "
                               f"1x1 run beyond rtol {tol[0]:g}, atol "
                               f"{tol[1]:g}")
        return float(np.abs(joined - ref).max())

    for px, py in GRID_LEG_GRIDS[world]:
        grid = make_grid(px, py)
        tag = f"{px}x{py}"
        nx, ny = px * GRID_N, py * GRID_N
        _, cx, cy = heat2d.coefficients(nx, ny, 0.1)
        g = torch.Generator(device="cuda").manual_seed(3000)
        inner = torch.randn((nx, ny), generator=g, device="cuda")
        blk = torch.zeros((GRID_N + 2,) * 2, device="cuda")
        blk[1:-1, 1:-1] = inner[grid.rx * GRID_N:(grid.rx + 1) * GRID_N,
                                grid.ry * GRID_N:(grid.ry + 1) * GRID_N]
        fns = H.heat_overlap_fns(cx, cy, grid)
        d1, _ = _overlap_run(fns, blk.clone(), 1, GRID_LEG_BODIES)
        d2, _ = _overlap_run(fns, blk.clone(), 2, GRID_LEG_BODIES)
        if not torch.equal(d1, d2):
            raise SmokeFailure(f"grid {tag} heat pipeline rank {rank}: "
                               f"depth 2 differs from depth 1")
        got = C.gather_blocks(d1[1:-1, 1:-1])
        del d1, d2, blk
        if rank == 0:
            whole = torch.zeros((nx + 2, ny + 2), device="cuda")
            whole[1:-1, 1:-1] = inner
            ref = H.heat_step2d_fn(1, cx, cy, grid=local_grid())(
                whole, GRID_LEG_BODIES)
            err = against_1x1(f"grid {tag} heat pipeline", got,
                              C.host_value(ref[1:-1, 1:-1]),
                              OVERLAP_TOL["heat"])
            log(f"GRID leg world={world} {tag} heat pipeline float32 "
                f"{GRID_LEG_BODIES} rounds, {GRID_N}x{GRID_N} a rank: depth "
                f"2 equal to depth 1 bit for bit on every rank; against "
                f"the 1x1 run max abs err {err!r}")
            del whole, ref
        del inner, got
        torch.cuda.empty_cache()
        s = GRID_SCALE
        g = torch.Generator(device="cuda").manual_seed(4000)
        field = torch.randn((nx + 4, ny + 4), generator=g, device="cuda")
        blk = field[grid.rx * GRID_N:grid.rx * GRID_N + GRID_N + 4,
                    grid.ry * GRID_N:grid.ry * GRID_N + GRID_N + 4].clone()
        if grid.rx > 0:
            blk[:2] = 0
        if grid.rx < px - 1:
            blk[-2:] = 0
        if grid.ry > 0:
            blk[:, :2] = 0
        if grid.ry < py - 1:
            blk[:, -2:] = 0
        fns = H.grid_overlap_fns(2, s, s, grid)
        o1, _ = _overlap_run(fns, blk.clone(), 1, 1, grid_step=True)
        o2, _ = _overlap_run(fns, blk.clone(), 2, 1, grid_step=True)
        if not all(torch.equal(a, b) for a, b in zip(o1, o2)):
            raise SmokeFailure(f"grid {tag} step pipeline rank {rank}: "
                               f"depth 2 differs from depth 1")
        got_x, got_y = C.gather_blocks(o1[0]), C.gather_blocks(o1[1])
        res = float(o1[2])
        del o1, o2, blk
        if rank == 0:
            wx, wy, wr = H.step2d_fn(2, s, s, grid=local_grid())(field)
            errs = [against_1x1(f"grid {tag} step pipeline {n}", got,
                                C.host_value(want), OVERLAP_TOL["grid"])
                    for n, got, want in (("dz_dx", got_x, wx),
                                         ("dz_dy", got_y, wy))]
            rel = abs(res - float(wr)) / abs(float(wr))
            if not rel <= OVERLAP_RESIDUAL_RTOL:
                raise SmokeFailure(f"grid {tag} step pipeline residual "
                                   f"{res!r} vs the 1x1 run's "
                                   f"{float(wr)!r}")
            log(f"GRID leg world={world} {tag} step pipeline float32, "
                f"{GRID_N}x{GRID_N} a rank: depth 2 equal to depth 1 bit "
                f"for bit on every rank; against the 1x1 run max abs err "
                f"dz_dx {errs[0]!r}, dz_dy {errs[1]!r}, residual relative "
                f"{rel:.3g}")
            del wx, wy, wr
        del field, got_x, got_y
        torch.cuda.empty_cache()


def _nccl_rdma(rank, gen):
    """The fused and chained tiers on a periodic 2-card ring, the RDMA
    exchange against DIRECT on both of ``ring_halo``'s routes (a 32-byte
    band a row: vec16; 8 bytes: scalar), the runners' peer pairs freed
    with their results, then ``ring_halo`` timed beside the torch
    exchange (:func:`_nccl_time_halo`) and the fused kernel beside the
    chained pair (:func:`_nccl_time_fused`)."""
    import torch

    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.kernels import hand

    routes0 = dict(hand.ring_halo.launches_by_route)
    z0 = torch.randn((1040, 8192), generator=gen, device="cuda")
    z1 = torch.randn((1040, 8190), generator=gen, device="cuda")
    a = H.iterate_fused_rdma_fn(8, 0.01, steps=4, periodic=True)(
        z0.clone(), RING_CHAIN)
    b = H.iterate_hand_fn(8, 0.01, axis=0, steps=4, periodic=True,
                          rdma=True)(z0.clone(), RING_CHAIN)
    c = H.halo_exchange(H.staging_buffer(z0, "pallas"), 1, 8, True,
                        "pallas")
    d = H.halo_exchange(z0.clone(), 1, 8, True, "direct")
    c1 = H.halo_exchange(H.staging_buffer(z1, "pallas"), 1, 2, True,
                         "pallas")
    d1 = H.halo_exchange(z1.clone(), 1, 2, True, "direct")
    torch.cuda.synchronize()
    if not (torch.equal(a, b) and torch.equal(c, d) and torch.equal(c1, d1)):
        raise SmokeFailure(f"NCCL leg rank {rank}: the RDMA tiers "
                           f"disagree")
    took = {r: hand.ring_halo.launches_by_route[r] - routes0[r]
            for r in routes0}
    # the chained tier's axis-0 exchanges and c on vec16, c1 on scalar
    if took != {"vec16": RING_CHAIN + 1, "scalar": 1}:
        raise SmokeFailure(f"NCCL leg rank {rank}: ring_halo launches by "
                           f"route {took}")
    del a, b, c, d, c1, d1
    # a runner's symmetric pair goes with its result: runs on fresh
    # inputs, their results dropped, must not grow the card's use
    fused = H.iterate_fused_rdma_fn(8, 0.01, steps=4, periodic=True)
    fused(z0.clone(), 1)
    torch.cuda.synchronize()
    free0 = torch.cuda.mem_get_info()[0]
    for _ in range(PAIR_RUNS):
        fused(z0.clone(), 1)
    torch.cuda.synchronize()
    grown = free0 - torch.cuda.mem_get_info()[0]
    pair_bytes = 2 * z0.numel() * z0.element_size()
    log(f"RDMA world=2 NCCL leg rank {rank}: {PAIR_RUNS} runs on fresh "
        f"inputs grew the card's use by {grown} bytes (a pair is "
        f"{pair_bytes})")
    if grown >= pair_bytes:
        raise SmokeFailure(f"NCCL leg rank {rank}: the runners' peer "
                           f"pairs outlive their results ({grown} "
                           f"bytes after {PAIR_RUNS} runs)")
    del z0, z1, fused
    _nccl_time_halo(rank, gen)
    _nccl_time_fused(rank, gen)


def _both_timed(fn, n=50):
    """``fn``'s ms per call at world > 1: queued behind a stall (the
    device's time, the wrapper's host cost out; one call before the start
    event lines the ranks' queues up) and in a host loop, each after a
    barrier so that the ranks start together."""
    import torch
    import torch.distributed as tdist

    torch.cuda.synchronize()
    tdist.barrier()
    queued = time_cuda_queued(fn, n, lead=1)
    torch.cuda.synchronize()
    tdist.barrier()
    return {"queued": queued, "host_loop": time_cuda(fn, n)}


#: ring_halo timed across two cards: (shape, axis, n_bnd, what) — the
#: stencil2d --rdma dim-0 shard and the bench's rdma-chained buffer
HALO_WORLD2 = (((REF_N_LOCAL + 4, REF_N_OTHER), 0, 2, "stencil2d dim 0"),
               ((BENCH_N, BENCH_N + 16), 1, 8, "bench rdma-chained"))


def _nccl_time_halo(rank, gen):
    """``ring_halo`` on the periodic two-card ring (peer stores over
    NVLink) beside the torch exchange (``halo_exchange(..., "direct")``:
    pack, NCCL send/recv, unpack) at the main paths' float32 shards,
    ms per call (:func:`_both_timed`)."""
    import torch

    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.kernels import hand

    times = {}
    for shape, axis, n_bnd, what in HALO_WORLD2:
        z = torch.randn(shape, generator=gen, device="cuda")
        zp = H.staging_buffer(z, "pallas")
        times[what] = {
            "ring_halo": _both_timed(lambda: hand.ring_halo(
                zp, axis=axis, n_bnd=n_bnd, periodic=True)),
            "torch exchange (direct)": _both_timed(lambda: H.halo_exchange(
                z, axis, n_bnd, True, "direct"))}
        del z, zp
        torch.cuda.empty_cache()
    log(f"TIME NCCL leg rank {rank} world=2 ring_halo, float32 shards "
        f"(ms per call): {json.dumps(times)}")


def _nccl_time_fused(rank, gen):
    """The fused kernel on the periodic two-card ring (its sends peer
    stores into the other card, signalled at system scope) beside the
    chained pair it replaces (``ring_halo``, then ``stencil2d_iterate``)
    at the bench's ``rdma-fused`` f32 buffer, k = 4: equal bit for bit
    on the same input, then ms per call (:func:`_both_timed`), with the
    route and the rows per block the launch took."""
    import torch

    from tpu_mpi_tests_torch.comm.peer import peer_ring
    from tpu_mpi_tests_torch.kernels import hand

    shape = (BENCH_N + 2 * K4, BENCH_N)
    z = peer_ring(torch.device("cuda", rank)).empty(shape, torch.float32)
    z.copy_(torch.randn(shape, generator=gen, device="cuda"))
    out, out2 = torch.empty_like(z), torch.empty_like(z)

    def fused():
        return hand.stencil2d_fused_rdma(z, BENCH_SE, steps=4,
                                         periodic=True, phys_static=(0, 0),
                                         out=out)

    def chained():
        hand.ring_halo(z, axis=0, n_bnd=K4, periodic=True)
        return hand.stencil2d_iterate(z, BENCH_SE, dim=0, steps=4,
                                      phys_static=(0, 0), out=out2)

    fused()
    chained()
    torch.cuda.synchronize()
    if not torch.equal(out, out2):
        raise SmokeFailure(f"NCCL leg rank {rank}: the fused kernel at "
                           f"world 2 differs from the chained pair")
    times = {"stencil2d_fused_rdma": _both_timed(fused),
             "chained pair": _both_timed(chained)}
    log(f"TIME NCCL leg rank {rank} world=2 stencil2d_fused_rdma "
        f"{list(shape)} float32 k=4, equal to the chained pair, route "
        f"{hand.kstep_route(z, 0, 4, out, fused=True)}, "
        f"{hand.stencil2d_fused_rdma.block_rows} rows a block (ms per "
        f"call): {json.dumps(times)}")
    del z, out, out2
    torch.cuda.empty_cache()


#: the hand-staged exchange across two cards: the stencil2d dim-1 shard
STAGED_WORLD2 = ((REF_N_OTHER, REF_N_LOCAL + 4), 1, 2)


def _nccl_staged(rank, gen):
    """The hand-staged exchange on the periodic two-card ring
    (``halo_exchange(z, 1, 2, True, "device", kernel="hand")``: the pack
    kernel, NCCL send/recv, the unpack kernel) at the stencil2d dim-1
    shard, equal to DIRECT bit for bit with one launch of each kernel on
    the ``vec8`` route, then timed beside DIRECT (:func:`_both_timed`)."""
    import torch

    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.kernels import hand

    shape, axis, n_bnd = STAGED_WORLD2
    z = torch.randn(shape, generator=gen, device="cuda") + rank

    def staged():
        return H.halo_exchange(z, axis, n_bnd, True, "device",
                               kernel="hand")

    routes0 = hand.route_counts()
    got = H.halo_exchange(z.clone(), axis, n_bnd, True, "device",
                          kernel="hand")
    want = H.halo_exchange(z.clone(), axis, n_bnd, True, "direct")
    torch.cuda.synchronize()
    routes = hand.route_counts()
    took = {name: {r: routes[name][r] - routes0[name][r]
                   for r in routes[name]}
            for name in ("pack_edges", "unpack_ghosts")}
    if not torch.equal(got, want) or torch.equal(got, z):
        raise SmokeFailure(f"NCCL leg rank {rank}: the hand-staged "
                           f"exchange differs from DIRECT")
    if any(t != dict.fromkeys(t, 0) | {STAGED_ROUTES[axis]: 1}
           for t in took.values()):
        raise SmokeFailure(f"NCCL leg rank {rank}: hand-staged launches "
                           f"by route {took}")
    del got, want
    times = {"hand-staged (device, kernel=hand)": _both_timed(staged),
             "torch exchange (direct)": _both_timed(lambda: H.halo_exchange(
                 z, axis, n_bnd, True, "direct"))}
    log(f"TIME NCCL leg rank {rank} world=2 hand-staged exchange "
        f"{shape[0]}x{shape[1]} axis {axis} n_bnd {n_bnd} float32, equal "
        f"to DIRECT, pack and unpack on {STAGED_ROUTES[axis]} (ms per "
        f"call): {json.dumps(times)}")
    del z
    torch.cuda.empty_cache()


def _nccl_attention(rank, world):
    """Attention over the ranks at world=2 (NCCL hops and all-to-alls,
    symmetric-memory slots): ring attention's flash tier at depth 1 and
    2, its fused tier and the one-process world of flash launches
    (``hand.fused_ring_world_ref(kernel=True)``) bit for bit alike, the
    torch-op tier depth-invariant bit for bit, and Ulysses' flash form
    equal to ``flash_attention`` over the whole sequence (each head the
    same fold); the ring checks in f32 HIGHEST and in bf16 DEFAULT (the
    wgmma route); then the fused and pipelined tiers timed side by side
    at L=8192, d=128 in both."""
    import torch

    from tpu_mpi_tests_torch.comm import alltoall as A
    from tpu_mpi_tests_torch.comm import ring as R
    from tpu_mpi_tests_torch.comm.collectives import shard_1d
    from tpu_mpi_tests_torch.kernels import hand

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(5)
    L, d = ATTN_L, ATTN_D
    lq = L // world
    g = [torch.randn((L, d), generator=gen, device="cuda") for _ in range(3)]
    # f32 HIGHEST and bf16 DEFAULT (the wgmma route: TMA reads of the
    # slots a peer stored into over NVLink, after the proxy fence)
    for dtype, precision in ((torch.float32, "highest"),
                             (torch.bfloat16, "default")):
        for causal, stripe in ((False, False), (True, False), (True, True)):
            glob = [R.to_striped(t, world) for t in g] if stripe else g
            glob = [t.to(dtype) for t in glob]
            mine = [shard_1d(t, "cuda") for t in glob]
            kw = dict(causal=causal, stripe=stripe)
            outs = {f"flash depth {dp}": R.ring_attention_fn(
                world, flash=True, depth=dp, precision=precision,
                **kw)(*mine) for dp in (1, 2)}
            outs["fused"] = R.ring_attention_fn(
                world, tier="fused", precision=precision, **kw)(*mine)
            outs["world of flash launches"] = hand.fused_ring_world_ref(
                [tuple(t[r * lq:(r + 1) * lq] for t in glob)
                 for r in range(world)], kernel=True, precision=precision,
                **kw)[rank]
            xla = [R.ring_attention_fn(world, depth=dp, precision=precision,
                                       **kw)(*mine) for dp in (1, 2)]
            torch.cuda.synchronize()
            first = outs["flash depth 1"]
            bad = [name for name, o in outs.items()
                   if not torch.equal(o, first)]
            if bad or not torch.equal(*xla):
                raise SmokeFailure(
                    f"NCCL leg rank {rank} {dtype} {precision} causal="
                    f"{causal} stripe={stripe}: {bad or 'xla depth 2'} "
                    f"differs")
    heads = 2 * world
    h = [torch.randn((L, heads, 64), generator=gen, device="cuda")
         for _ in range(3)]
    got = A.ulysses_attention_fn(world, causal=True, flash=True)(
        *(shard_1d(t, "cuda") for t in h))
    want = hand.flash_attention(*h, causal=True)[rank * lq:(rank + 1) * lq]
    if not torch.equal(got, want):
        raise SmokeFailure(f"NCCL leg rank {rank}: Ulysses differs from "
                           f"flash_attention over the whole sequence")
    for dtype, precision in ((torch.float32, "highest"),
                             (torch.bfloat16, "default")):
        mine = [shard_1d(t.to(dtype), "cuda") for t in g]
        times = [[tier, time_cuda(lambda tier=tier: R.ring_attention_fn(
            world, flash=True, tier=tier, precision=precision)(*mine), 20)]
            for tier in ("pipelined", "fused", "fused", "pipelined")]
        log(f"TIME NCCL leg rank {rank} world={world} ring attention L={L} "
            f"d={d} {str(dtype).split('.')[1]} {precision.upper()} (ms per "
            f"call): {json.dumps(times)}")


def _nccl_collectives(rank, world, gen):
    """The collective kernels' tiers at world=2 over symmetric memory,
    held against NCCL's calls (integer-valued rows: any sum order is
    exact) on a row of whole 16-byte vectors (the ring kernels' vec16
    route) and on one that is not (their scalar route), each launch
    counted on its route, then timed beside NCCL's calls
    (:func:`_nccl_time_collectives`)."""
    import torch
    import torch.distributed as tdist

    from tpu_mpi_tests_torch.comm import collectives as C
    from tpu_mpi_tests_torch.kernels import hand

    routes0 = hand.route_counts()
    for length in (8192, 8190):  # vec16; 8190 / 2 · 4 bytes: scalar
        row = (torch.arange(length, device="cuda", dtype=torch.float32)
               % 13 + rank)[None]
        want_sum = row.clone()
        tdist.all_reduce(want_sum)
        want_g = torch.empty(world * row.shape[1], device="cuda")
        tdist.all_gather_into_tensor(want_g, row[0])
        for name, got, want in (
                ("all_gather_rdma", C.all_gather_rdma(row[0]), want_g),
                ("all_gather_oneshot", C.all_gather_oneshot(row[0]),
                 want_g),
                ("allreduce_rdma credits=1", C.allreduce_rdma(row, 1),
                 want_sum),
                ("allreduce_rdma credits=2", C.allreduce_rdma(row, 2),
                 want_sum),
                ("allreduce_oneshot", C.allreduce_oneshot(row), want_sum)):
            if not torch.equal(got, want):
                raise SmokeFailure(f"NCCL leg rank {rank}: {name} != NCCL "
                                   f"(row of {length})")
    took = {n: {r: hand.route_counts()[n][r] - routes0[n][r]
                for r in routes0[n]} for n in ROUTED_COLLECTIVES}
    # per row: one all-gather, two allreduces (a reduce-scatter and an
    # all-gather each), a one-shot gather and sum, every launch of the
    # 8190 row on the scalar route
    want = {"ring_allgather": {"scalar": 3, "vec16": 3},
            "ring_reduce_scatter": {"scalar": 2, "vec16": 2},
            "oneshot": {"scalar": 2, "vec16": 2}}
    if took != want:
        raise SmokeFailure(f"NCCL leg rank {rank}: launches by route "
                           f"{took}, the rows' routes make {want}")
    _nccl_time_collectives(rank, world, gen)


def _nccl_time_collectives(rank, world, gen):
    """The collective kernels beside NCCL's calls at a 16 MiB float32
    shard, ms per call (:func:`_both_timed`)."""
    import torch
    import torch.distributed as tdist

    from tpu_mpi_tests_torch.kernels import hand

    x = torch.randn(COLL_TIMED_N, generator=gen, device="cuda")
    gathered = torch.empty(world * COLL_TIMED_N, device="cuda")
    scattered = torch.empty(COLL_TIMED_N // world, device="cuda")
    summed = x.clone()
    both = _both_timed
    times = {
        "ring_allgather": both(lambda: hand.ring_allgather(x)),
        "nccl all_gather_into_tensor": both(
            lambda: tdist.all_gather_into_tensor(gathered, x)),
        "ring_reduce_scatter credits=1": both(
            lambda: hand.ring_reduce_scatter(x, 1)),
        "ring_reduce_scatter credits=2": both(
            lambda: hand.ring_reduce_scatter(x, 2)),
        "nccl reduce_scatter_tensor": both(
            lambda: tdist.reduce_scatter_tensor(scattered, x)),
        "ring_allreduce": both(lambda: hand.ring_allreduce(x)),
        "ring_allreduce credits=2": both(
            lambda: hand.ring_allreduce(x, 2)),
        "oneshot gather": both(lambda: hand.oneshot(x, "gather")),
        "oneshot sum": both(lambda: hand.oneshot(x, "sum")),
        "nccl all_reduce": both(lambda: tdist.all_reduce(summed)),
    }
    log(f"TIME NCCL leg rank {rank} world={world}, 16 MiB float32 shard "
        f"(ms per call): {json.dumps(times)}")


def stencil2d_rdma_argv(device) -> list:
    """The ``stencil2d --rdma`` path's argv: the reference sizes, the
    hand kernels, the RDMA exchange and allreduce."""
    return ["--device", device.type, "--n-local", str(REF_N_LOCAL),
            "--n-other", str(REF_N_OTHER), "--n-iter",
            str(RDMA_DRIVER_N_ITER), "--n-warmup", str(DRIVER_N_WARMUP),
            "--kernel", "hand", "--rdma"]


def stencil2d_rdma_path(device, counts, per_step, peaks):
    """The ``stencil2d --rdma`` path with its exact launches and routes
    (the RDMA slice's first, and the flagless run the instrument slice
    holds its runs against)."""
    from tpu_mpi_tests_torch.drivers import stencil2d

    path = "stencil2d --rdma"
    counts[path] = drive_driver(path, stencil2d, stencil2d_rdma_argv(device),
                                ["ring_halo", "stencil2d_deriv",
                                 "ring_reduce_scatter"],
                                ("TEST dim:0", "TEST dim:1",
                                 "allreduce="), peaks)
    calls = 4 * (DRIVER_N_WARMUP + RDMA_DRIVER_N_ITER)  # dim × buf legs
    # the allreduce leg: per dim one warm call and n_iter timed ones, each
    # one ring reduce-scatter launch (a copy at world=1)
    want = {"ring_halo": calls, "stencil2d_deriv": calls,
            "ring_reduce_scatter": 2 * (1 + RDMA_DRIVER_N_ITER)}
    _exact(path, counts[path], want)
    # the 2 MiB row is whole 16-byte vectors: every launch on vec16
    check_routes(path, "ring_reduce_scatter",
                 {"vec16": want["ring_reduce_scatter"]})
    # the exchange: per dim two legs (buf) of n_warmup + n_iter launches
    legs = 2 * (DRIVER_N_WARMUP + RDMA_DRIVER_N_ITER)
    check_routes(path, "ring_halo", ring_routes(
        ("stencil2d --rdma dim 0", legs), ("stencil2d --rdma dim 1", legs)))
    per_step[path] = {"ring_halo": 1.0, "stencil2d_deriv": 1.0}


def run_instrument_alone(device):
    """The instrument slice with the flagless ``stencil2d --rdma`` path it
    compares against (a short call after editing the spine)."""
    counts, per_step, peaks = {}, {}, {}
    stencil2d_rdma_path(device, counts, per_step, peaks)
    out = run_instrument_slice(device, counts, peaks)
    log(f"LAUNCHES {json.dumps(counts)}")
    return out


def run_rdma_slice(device, counts, per_step, peaks):
    """The RDMA slice's paths, each alone with exact launch counts: the
    stencil2d driver with ``--rdma`` at the reference sizes, its iterate
    leg under ``rdma-chained`` and ``rdma-fused`` (the fused == chained
    bitwise gate and the OVERLAP line), ``stencil1d --staging pallas`` at
    32 Mi points, and the bench's two RDMA tiers at 8192² in float32 and
    bfloat16. Returns the bench records."""
    from tpu_mpi_tests_torch import bench
    from tpu_mpi_tests_torch.drivers import stencil1d, stencil2d

    stencil2d_rdma_path(device, counts, per_step, peaks)

    it = DRIVER_ITERATE_ITERS
    for tier, want in (
            ("rdma-chained", {"ring_halo": 1 + 2 * it,
                              "stencil2d_iterate": 1 + 2 * it,
                              "stencil2d_fused_rdma": 2 + 3 * it}),
            ("rdma-fused", {"ring_halo": it, "stencil2d_iterate": it,
                            "stencil2d_fused_rdma": 3 + 4 * it})):
        # the timed leg (1 warm + it calls), the bitwise gate (it fused,
        # it chained), the overlap probe (1 + it fused, 1 + it
        # compute-only fused)
        path = f"stencil2d --iterate-tier {tier}"
        argv = ["--device", device.type, "--n-local", str(REF_N_LOCAL),
                "--n-other", str(REF_N_OTHER), "--iterate-tier", tier,
                "--iterate-steps", "4", "--iterate-iters", str(it),
                "--iterate-only"]
        counts[path] = drive_driver(
            path, stencil2d, argv, list(want),
            (f"ITER tier={tier}", f"ITER BITWISE fused==chained over {it} "
             f"calls: OK", "OVERLAP stencil2d_fused_rdma overlap_frac=",
             "ITER ERR rel="), peaks)
        _exact(path, counts[path], want)
        check_routes(path, "ring_halo", ring_routes(
            ("stencil2d iterate leg", want["ring_halo"])))

    path = "stencil1d --staging pallas"
    counts[path] = drive_driver(
        path, stencil1d, ["--device", device.type, "--n-global",
                          str(STENCIL1D_N), "--dtype", "float32",
                          "--staging", "pallas"], ["ring_halo"],
        ("0/1 exchange time ", "err_norm = "), peaks)
    _exact(path, counts[path], {"ring_halo": 2})  # warm + timed
    check_routes(path, "ring_halo", ring_routes(
        ("stencil1d --staging pallas", 2)))

    recs = {}
    # k = 4: the schedule the RDMA operand tables above describe
    # (RING_MAIN_PATH, FUSED_MAIN_PATH)
    os.environ["TPU_MPI_BENCH_STEPS"] = "4"
    for tier in ("rdma-chained", "rdma-fused"):
        os.environ["TPU_MPI_BENCH_TIER"] = tier
        for dtype in ("float32", "bfloat16"):
            path = f"bench {tier} {dtype}"
            os.environ["TPU_MPI_BENCH_DTYPE"] = dtype

            def run_bench():
                out = io.StringIO()
                with contextlib.redirect_stdout(out):
                    rec = bench.main(["--device", device.type])
                log(f"BENCH {out.getvalue().strip().splitlines()[-1]}")
                return rec

            kernels = (["stencil2d_fused_rdma"] if tier == "rdma-fused"
                       else ["ring_halo", "stencil2d_iterate"])
            rec, counts[path] = drive_path(path, run_bench, kernels, peaks)
            if rec.get("tier") != tier or not rec.get("value", 0) > 0:
                raise SmokeFailure(f"{path}: not a measured {tier} run: "
                                   f"{rec}")
            k = rec["steps"]
            n_short = max(1, BENCH_ITERS_SHORT // k)
            n_long = max(n_short + 1, BENCH_ITERS_LONG // k)
            calls = BENCH_SAMPLES * (3 + n_short + n_long)
            _exact(path, counts[path], dict.fromkeys(kernels, calls))
            check_routes(path, "ring_halo", ring_routes(
                (f"bench rdma-chained {dtype}",
                 counts[path]["ring_halo"])))
            per_step[path] = {name: check_per_timestep(
                path, name, counts[path][name], calls * k, 1 / k)
                for name in kernels}
            recs[f"{tier} {dtype}"] = rec
    del os.environ["TPU_MPI_BENCH_TIER"]
    del os.environ["TPU_MPI_BENCH_STEPS"]
    return recs


def ring_routes(*legs):
    """``ring_halo``'s launches per route on a path made of ``legs``,
    (:data:`RING_MAIN_PATH` leg, launches) pairs: each leg's launches on
    its operand's route."""
    want = {}
    for leg, n in legs:
        route = next(r[4] for r in RING_MAIN_PATH if r[5] == leg)
        want[route] = want.get(route, 0) + n
    return want


def _exact(path, counts, want):
    """Fail unless the path launched exactly ``want`` (and nothing
    else)."""
    full = dict.fromkeys(counts, 0) | want
    if counts != full:
        raise SmokeFailure(f"{path}: launches {counts}, its schedule makes "
                           f"{full}")


def time_ring_kernels(device, gen):
    """Per-launch times of the two RDMA ring kernels at main-path shapes
    on the self-ring. ring_halo: the stencil2d --rdma dim-0 operand and
    the bench's chained dim-1 buffer, periodic (so the bands move),
    queued behind a stall (a few µs of work under the wrapper's host
    cost); bound: the two bands read and written once over 3.35 TB/s
    (the strided axis-1 side in 32-byte sectors touched); yardstick: the
    two ``copy_`` of the torch exchange (``exchange_shard``). The fused
    kernel at the bench's dim-0 buffer (8208 × 8192, k=4): its
    compute-only instance (the bench's world=1 schedule) and the periodic
    self-ring, each beside the chained pair ring_halo → stencil2d_iterate
    on the same operand; bound: the iterate kernel's byte bound; no
    library call computes it."""
    import torch

    from tpu_mpi_tests_torch.comm import halo as H
    from tpu_mpi_tests_torch.kernels import hand

    rows = {"ring_halo": [], "stencil2d_fused_rdma": []}
    for shape, axis, n_bnd, dtype, path in RING_TIMED:
        z = torch.randn(shape, generator=gen, device=device).to(
            getattr(torch, dtype))
        n = shape[axis]
        itemsize = z.element_size()
        contiguous = 2 * n_bnd * (z.numel() // n) * itemsize
        nbytes = (band_sectors(shape, axis, n_bnd, itemsize,
                               (n_bnd, n - 2 * n_bnd))
                  + band_sectors(shape, axis, n_bnd, itemsize,
                                 (0, n - n_bnd)))
        rows["ring_halo"].append({
            "path": path, "shape": list(shape),
            "dtype": dtype, "axis": axis, "n_bnd": n_bnd, "periodic": True,
            "route": hand.halo_route(z, axis, n_bnd),
            "ms": time_cuda_queued(lambda: hand.ring_halo(
                z, axis=axis, n_bnd=n_bnd, periodic=True), 20),
            "ms_host_loop": time_cuda(lambda: hand.ring_halo(
                z, axis=axis, n_bnd=n_bnd, periodic=True), 20),
            "plain_ms": time_cuda_queued(lambda: hand.ring_halo_ref(
                z, axis=axis, n_bnd=n_bnd, periodic=True), 20),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "band_bytes": contiguous,
            "library_ms": time_cuda_queued(lambda: H.exchange_shard(
                z, axis=axis, n_bnd=n_bnd, periodic=True), 20),
            "library_call": "the torch exchange's two copy_ into the ghost "
                            "bands (exchange_shard, world=1)"})
        del z
        torch.cuda.empty_cache()
    for shape, dtype, periodic in FUSED_MAIN_PATH:
        dtype = getattr(torch, dtype)
        z = torch.randn(shape, generator=gen, device=device).to(dtype)
        out = torch.empty_like(z)
        flags = (0, 0) if periodic else (1, 1)

        def fused(z=z, out=out, periodic=periodic, flags=flags):
            return hand.stencil2d_fused_rdma(
                z, BENCH_SE, steps=4, periodic=periodic,
                local_only=not periodic, phys_static=flags, out=out)

        def chained(z=z, out=out, periodic=periodic, flags=flags):
            hand.ring_halo(z, axis=0, n_bnd=8, periodic=periodic)
            return hand.stencil2d_iterate(z, BENCH_SE, dim=0, steps=4,
                                          phys_static=flags, out=out)

        b, why = bound_ms(*iterate_work(shape, dtype, 0, 4, flags))
        rows["stencil2d_fused_rdma"].append({
            "path": "bench rdma-fused" if not periodic
            else "stencil2d --iterate-tier rdma-fused (self-ring)",
            "shape": list(shape), "dtype": str(dtype).split(".")[1],
            "steps": 4, "periodic": periodic, "local_only": not periodic,
            "route": hand.kstep_route(z, 0, 4, out, fused=True),
            "ms": time_cuda(fused, 50),
            "block_rows": hand.stencil2d_fused_rdma.block_rows,
            "chained_pair_ms":
                time_cuda(chained, 50),
            "queued_ms": time_cuda_queued(fused, 20),
            "chained_pair_queued_ms": time_cuda_queued(chained, 20),
            "plain_ms": time_cuda(lambda: hand.stencil2d_fused_rdma_ref(
                z, BENCH_SE, steps=4, periodic=periodic,
                local_only=not periodic, phys_static=flags), 3),
            "bound_ms": b, "bound_by": why, "library_ms": None})
        del z, out
        torch.cuda.empty_cache()
    return rows


def time_cuda(fn, n_iter: int) -> float:
    """Mean milliseconds per call of ``fn`` (warmed), CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n_iter


def time_cuda_queued(fn, n_iter: int, stall_ms: float = 20.0,
                     lead: int = 0) -> float:
    """Mean device milliseconds per call of ``fn`` with the host taken
    out: the stream is stalled first (a spin kernel of ``stall_ms``), so
    the ``n_iter`` calls' launches queue up behind it and then run back
    to back between the two events. For kernels shorter than their
    wrapper's host cost, where :func:`time_cuda` would time the host.
    ``lead`` calls run between the stall and the start event: for a
    collective over ranks one lines the ranks' queues up (each rank's
    launch waits for its peers'), so that a rank whose stall ends first
    (the spin counts its own card's clock) does not time its wait for
    the others."""
    import torch

    fn()
    torch.cuda.synchronize()
    khz = getattr(torch.cuda.get_device_properties(0), "clock_rate", 1.7e6)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(stall_ms * khz))
    for _ in range(lead):
        fn()
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / n_iter


def iterate_work(shape, dtype, dim, steps, flags):
    """(bytes, flops) the k-step update needs: the array read once and
    written once; 7 flops per updated point per step (spans from the
    flags, as the kernel computes them)."""
    import torch

    n, m = shape[dim], shape[1 - dim]
    itemsize = torch.empty((), dtype=dtype).element_size()
    K = 2 * steps
    updated = 0
    for s in range(1, steps + 1):
        lo = K if flags[0] else 2 * s
        hi = n - (K if flags[1] else 2 * s)
        updated += max(0, hi - lo) * m
    return 2 * shape[0] * shape[1] * itemsize, 7 * updated


def deriv_work(shape, dtype, dim):
    """(bytes, lone ops) of a derivative launch: z read once, the output
    written once; 8 lone ops an output point (4 mul, 3 add, the scale)."""
    import torch

    itemsize = torch.empty((), dtype=dtype).element_size()
    out = list(shape)
    out[dim] -= 4
    n_out = out[0] * out[1]
    return (shape[0] * shape[1] + n_out) * itemsize, 8 * n_out


def heat_work(shape, dtype, steps):
    """(bytes, lone ops) of a k-step heat launch: the shard read once and
    written once; 9 lone ops per updated cell ([1, n0−1) × [1, n1−1)) per
    step (nothing contracts under -fmad=false)."""
    import torch

    itemsize = torch.empty((), dtype=dtype).element_size()
    updated = (shape[0] - 2) * (shape[1] - 2)
    return 2 * shape[0] * shape[1] * itemsize, 9 * updated * steps


def dual_work(shape, dtype, lean=False):
    """(bytes, flops) of a dual step: the block read once, both
    (n0−4, n1−4) derivatives written once (the residual scalar is
    negligible); per output point 8 flops per derivative (5 in the lean
    body) and 4 for the two squares and their sums."""
    import torch

    itemsize = torch.empty((), dtype=dtype).element_size()
    n_out = (shape[0] - 4) * (shape[1] - 4)
    return ((shape[0] * shape[1] + 2 * n_out) * itemsize,
            (14 if lean else 20) * n_out)


def bound_ms(nbytes, flops, dtype=None, issue_rate=None):
    """The larger of the bytes over the card's memory rate and the
    operations over its peak: ``flops`` over 67 TFLOP/s, or, given the
    card's ``issue_rate`` (lone mul/add/sub a second,
    ``hand.alu_issue_rate``), ``flops`` as lone ops, bfloat16 two elements
    an instruction — the heat update's and the derivative's, whose ops
    nothing contracts under -fmad=false."""
    import torch

    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    if issue_rate is None:
        t_ops = flops / F32_FLOPS_PER_S * 1e3
    else:
        per = 2 if dtype == torch.bfloat16 else 1
        t_ops = flops / per / issue_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def time_kernels(device):
    """Phase 5: per-launch times at the main-path shapes."""
    import torch
    import torch.nn.functional as F

    from tpu_mpi_tests_torch.kernels import hand
    from tpu_mpi_tests_torch.kernels.stencil import STENCIL5

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=device).manual_seed(99)
    rows = {}

    def iterate_row(path, shape, dtype, dim, flags, se, steps=4):
        z = torch.randn(shape, generator=gen, device=device).to(dtype)
        out = torch.empty_like(z)
        ms = time_cuda(lambda: hand.stencil2d_iterate(
            z, se, dim=dim, steps=steps, phys_static=flags, out=out), 50)
        plain = time_cuda(lambda: hand.stencil2d_iterate_ref(
            z, se, dim=dim, steps=steps, phys_static=flags), 5)
        b, why = bound_ms(*iterate_work(shape, dtype, dim, steps, flags))
        return {"path": path, "shape": list(shape),
                "dtype": str(dtype).split(".")[1], "dim": dim,
                "steps": steps, "phys_static": list(flags),
                "route": hand.kstep_route(z, dim, steps, out),
                "vec_bytes": hand.kstep_vec_bytes(z, out), "ms": ms,
                "queued_ms": time_cuda_queued(lambda: hand.stencil2d_iterate(
                    z, se, dim=dim, steps=steps, phys_static=flags,
                    out=out), 20),
                "plain_ms": plain, "bound_ms": b, "bound_by": why,
                "library_ms": None}

    rate = issue_rate()

    def deriv_row(path, shape, dtype, dim):
        z = torch.randn(shape, generator=gen, device=device).to(dtype)
        scale = 128.0
        out_shape = list(shape)
        out_shape[dim] -= 4
        out = torch.empty(out_shape, device=device, dtype=dtype)

        def launch():
            return hand.stencil2d_deriv(z, scale, dim=dim, out=out)

        ms = time_cuda(launch, 20)
        queued = time_cuda_queued(launch, 20)
        plain = time_cuda(lambda: hand.stencil2d_deriv_ref(z, scale,
                                                           dim=dim), 5)
        w = torch.tensor(STENCIL5 * scale, dtype=dtype, device=device)
        w = w.reshape(1, 1, 5, 1) if dim == 0 else w.reshape(1, 1, 1, 5)
        lib_out = F.conv2d(z[None, None], w)[0, 0]
        if lib_out.shape != out.shape:
            raise SmokeFailure("conv2d yardstick shape mismatch")
        del lib_out
        lib = time_cuda(lambda: F.conv2d(z[None, None], w), 10)
        b, why = bound_ms(*deriv_work(shape, dtype, dim), dtype, rate)
        return {"path": path, "shape": list(shape),
                "dtype": str(dtype).split(".")[1], "dim": dim,
                "route": hand.deriv_route(z, dim, out),
                "vec_bytes": hand.deriv_vec_bytes(z, dim, out), "ms": ms,
                "queued_ms": queued, "plain_ms": plain, "bound_ms": b,
                "bound_by": why, "library_ms": lib}

    def heat_row(path, shape, dtype, k, cx, cy):
        z = torch.randn(shape, generator=gen, device=device).to(dtype)
        out = torch.empty_like(z)

        def launch():
            return hand.heat2d(z, cx, cy, steps=k, out=out)

        ms = time_cuda(launch, 50)
        queued = time_cuda_queued(launch, 20)
        plain = time_cuda(lambda: hand.heat2d_ref(z, cx, cy, steps=k), 5)
        lib = None
        if k == 1:
            # the one-call twin of one step: the five-point weight, valid
            # padding (the outer ring is not computed)
            w = torch.tensor([[0.0, cx, 0.0],
                              [cy, 1.0 - 2.0 * cx - 2.0 * cy, cy],
                              [0.0, cx, 0.0]], dtype=torch.float64)
            w = w.to(device=device, dtype=dtype)[None, None]
            lib_out = F.conv2d(z[None, None], w)[0, 0]
            if tuple(lib_out.shape) != (shape[0] - 2, shape[1] - 2):
                raise SmokeFailure("heat conv2d yardstick shape mismatch")
            del lib_out
            lib = time_cuda(lambda: F.conv2d(z[None, None], w), 10)
        b, why = bound_ms(*heat_work(shape, dtype, k), dtype, rate)
        return {"path": path, "shape": list(shape),
                "dtype": str(dtype).split(".")[1], "steps": k,
                "route": hand.heat_route(z, k, out),
                "vec_bytes": hand.heat_vec_bytes(z, out), "ms": ms,
                "queued_ms": queued, "plain_ms": plain, "bound_ms": b,
                "bound_by": why, "library_ms": lib,
                **({"library_call": "F.conv2d 3x3 five-point weight, valid "
                                    "padding, TF32 off; one step"}
                   if k == 1 else {})}

    def dual_row(shape, dtype, lean=False, path=None):
        z = torch.randn(shape, generator=gen, device=device).to(dtype)
        s = GRID_SCALE
        ms = time_cuda(lambda: hand.dual_dim_step(z, 2, s, s, lean=lean), 20)
        plain = time_cuda(lambda: hand.dual_dim_step_ref(z, 2, s, s,
                                                         lean=lean), 5)
        # the yardstick: both derivatives from one cross-shaped (2,1,5,5)
        # convolution, valid padding (no residual)
        w = torch.zeros((2, 1, 5, 5), dtype=torch.float64)
        w[0, 0, :, 2] = torch.from_numpy(STENCIL5 * s)
        w[1, 0, 2, :] = torch.from_numpy(STENCIL5 * s)
        w = w.to(device=device, dtype=dtype)
        lib_out = F.conv2d(z[None, None], w)[0]
        if tuple(lib_out.shape) != (2, shape[0] - 4, shape[1] - 4):
            raise SmokeFailure("dual-step conv2d yardstick shape mismatch")
        del lib_out
        lib = time_cuda(lambda: F.conv2d(z[None, None], w), 10)
        b, why = bound_ms(*dual_work(shape, dtype, lean))
        return {"path": path or ("microbench roofline2" if lean
                                 else "stencil2d_grid"),
                "body": "lean" if lean else "raw", "shape": list(shape),
                "route": hand.dual_route(z),
                "dtype": str(dtype).split(".")[1], "ms": ms,
                "plain_ms": plain, "bound_ms": b, "bound_by": why,
                "library_ms": lib,
                "library_call": "F.conv2d (2,1,5,5) cross weight, TF32 off; "
                                "both derivatives, no residual"}

    # one row per distinct schedule: the bench's f32 and bf16 operands
    # (the first block's where it runs resident blocks), the driver's
    # periodic block, rdma-chained's f32 dim-1 buffer (k = 4), microbench
    # iterate's bf16 k = 1 field (rows of 16392 bytes: 8-byte vectors)
    rows["stencil2d_iterate"] = []
    firsts = list({c[0]: c for c in reversed(iterate_cases())}.values())
    for case in firsts[::-1] + [
            ("bench rdma-chained float32", (BENCH_N, BENCH_N + 2 * K4),
             torch.float32, 1, (1, 1), BENCH_SE),
            ("microbench iterate bfloat16 k=1", (BENCH_N, BENCH_N + 4),
             torch.bfloat16, 1, (0, 0), 1e-6, 1)]:
        rows["stencil2d_iterate"].append(iterate_row(*case))
        torch.cuda.empty_cache()
    # the stencil2d driver's operands (and the bfloat16 dim-0 field), then
    # microbench stencil's
    rows["stencil2d_deriv"] = []
    for case in (("stencil2d", (REF_N_LOCAL + 4, REF_N_OTHER),
                  torch.float32, 0),
                 ("stencil2d", (REF_N_LOCAL, REF_N_OTHER + 4),
                  torch.float32, 1),
                 ("stencil2d", (REF_N_LOCAL + 4, REF_N_OTHER),
                  torch.bfloat16, 0),
                 ("microbench stencil", STENCIL_MB_SHAPE, torch.float32, 0),
                 ("microbench stencil", STENCIL_MB_SHAPE, torch.float32, 1)):
        rows["stencil2d_deriv"].append(deriv_row(*case))
        torch.cuda.empty_cache()
    # the heat driver's three runs, then microbench heat's and roofline2's
    # deepest (k = 8 at 2064²)
    rows["heat2d"] = []
    # and a rank's block of the strong-scaled 2x2 grid at each heat run
    for case in heat_cases() + [
            (f"microbench heat {dt} k=8", (2064, 2064), dtype, 8, 0.05, 0.05)
            for dt, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16))] + [
            (f"{path} 2x2 strong-scaled block", (GRID_HALF + 2 * k,) * 2,
             dtype, k, cx, cy) for path, _, dtype, k, cx, cy
            in heat_cases()]:
        rows["heat2d"].append(heat_row(*case))
        torch.cuda.empty_cache()
    rows["dual_dim_step"] = [
        dual_row((GRID_N + 4, GRID_N + 4), dtype, lean=lean)
        for dtype in (torch.float32, torch.bfloat16)
        for lean in (False, True)] + [
        dual_row((GRID_HALF + 4,) * 2, dtype,
                 path="stencil2d_grid 2x2 strong-scaled block")
        for dtype in (torch.float32, torch.bfloat16)]
    torch.cuda.empty_cache()
    rows.update(time_probe_and_pack(device, gen))
    rows.update(time_ring_kernels(device, gen))
    rows.update(time_coll_kernels(device, gen))
    rows.update(time_stream_kernels(device, gen))
    rows["flash_attention_block"] = time_flash_kernel(device, gen)
    rows["fused_ring_attention"] = time_fused_ring_kernel(device, gen)
    for name, rs in rows.items():
        for r in rs:
            log(f"TIME {name} {json.dumps(r)}")
    return rows


def band_sectors(shape, axis, n_bnd, itemsize, starts):
    """Bytes the strided side of a pack or unpack moves: the union of the
    32-byte sectors that its bands (``n_bnd`` wide, first index
    ``starts`` along ``axis``) touch. Along axis 0 a band is contiguous
    (its own bytes); along axis 1 each row's ``n_bnd`` elements cost every
    sector they touch, and a sector that two bands touch (row r−1's hi
    band and row r's lo band are neighbours in memory) counts once."""
    import numpy as np

    n0, n1 = shape
    if axis == 0:
        return len(starts) * n_bnd * n1 * itemsize
    rows = np.arange(n0, dtype=np.int64)
    span = (n_bnd * itemsize - 1) // SECTOR + 2  # sectors a band may touch
    ids = []
    for start in starts:
        first = (rows * n1 + start) * itemsize // SECTOR
        last = ((rows * n1 + start + n_bnd) * itemsize - 1) // SECTOR
        for k in range(span):
            ids.append((first + k)[first + k <= last])
    return int(np.unique(np.concatenate(ids)).size) * SECTOR


def time_probe_and_pack(device, gen):
    """Per-launch times of the probe at the main path's (B, 512, 512)
    stack — each main-path mix in float32 at the middle of its reps
    triple, and ``step5_d1`` (the bf16 kernel's yardstick), ``fma`` and
    ``dualdim`` in bfloat16 — queued, with the per-rep cost as the slope
    between that reps count and a quarter of it (launch, first load and
    last store in the intercept), the route, the bound (the lone ops it
    issues over the card's issue rate, :func:`issue_rate`, bfloat16 two
    elements an instruction, against the stack read and written once over
    3.35 TB/s) and its plain version (no library call computes it); and of
    pack and unpack at the staged exchange's operands on their routes,
    with the byte bound (the strided side counted as the union of the
    32-byte sectors it touches), the plain version and the one-call
    yardsticks ``torch.stack`` of the two ``narrow``s and two ``copy_``.
    These copies are shorter than their wrappers' host cost, so they are
    timed queued behind a stall (:func:`time_cuda_queued`);
    ``ms_host_loop`` is the plain loop's time, which is the host's."""
    import torch

    from tpu_mpi_tests_torch.kernels import hand

    rate = issue_rate()
    rows = {"alu_probe": [], "pack_edges": [], "unpack_ghosts": []}
    cases = [("step5_d0", torch.float32, 1024), ("fma", torch.float32, 2048),
             ("step5_d1", torch.float32, 256), ("heat5", torch.float32, 256),
             ("dualdim", torch.float32, 128),
             ("dualdim_lean", torch.float32, 128),
             ("step5_d1", torch.bfloat16, 256), ("fma", torch.bfloat16, 2048),
             ("dualdim", torch.bfloat16, 128)]
    for mix, dtype, reps in cases:
        B = probe_batch(device, dtype)
        shape = (B, PROBE_HW, PROBE_HW)
        elems = B * PROBE_HW * PROBE_HW
        z = torch.randn(shape, generator=gen, device=device).to(dtype)
        ms = time_cuda_queued(lambda: hand.alu_probe(z, reps, mix), 5)
        ms_q = time_cuda_queued(lambda: hand.alu_probe(z, reps // 4, mix),
                                5)
        per_rep = (ms - ms_q) / (reps - reps // 4)  # ms
        plain = time_cuda(lambda: hand.alu_probe_ref(z, reps, mix), 1)
        t_ops = hand.probe_bound_s(mix, dtype, elems, reps, rate) * 1e3
        t_bytes = 2 * elems * z.element_size() / HBM_BYTES_PER_S * 1e3
        b, why = ((t_bytes, "bytes") if t_bytes >= t_ops
                  else (t_ops, "operations"))
        route = hand.probe_route(z, mix)
        cs = hand.probe_cluster(PROBE_HW, PROBE_HW, dtype)
        rows["alu_probe"].append({
            "path": "microbench vpu/roofline2", "shape": list(shape),
            "dtype": str(dtype).split(".")[1], "mix": mix, "reps": reps,
            "route": route, "ctas": hand.alu_probe.last_ctas,
            "cluster_ctas": cs[0] if cs else None, "ms": ms,
            "ms_at_quarter_reps": ms_q, "us_per_rep": 1e3 * per_rep,
            "ps_per_elt_rep": 1e9 * per_rep / elems,
            "bound_ps_per_elt_rep": 1e12 * hand.probe_bound_s(
                mix, dtype, 1, 1, rate),
            "plain_ms": plain, "bound_ms": b, "bound_by": why,
            "issue_rate": rate, "library_ms": None,
            "issued_gops": hand.ALU_PROBE_REAL_OPS[mix] * elems * reps
            / ms / 1e6})
        del z
    for case_shape, axis in STAGED_CASES:
        z = torch.randn(case_shape, generator=gen, device=device)
        n = case_shape[axis]
        lo, hi = hand.pack_edges(z, axis, 2)
        contiguous = 2 * lo.numel() * 4
        common = {"path": "staged exchange", "shape": list(case_shape),
                  "dtype": "float32", "axis": axis, "n_bnd": 2,
                  "route": hand.pack_route(z, axis, 2, lo.data_ptr(),
                                           hi.data_ptr()),
                  "bound_by": "bytes", "bound_counts":
                  "the union of the 32-byte sectors touched on the "
                  "strided side"}
        pack_bytes = band_sectors(case_shape, axis, 2, 4,
                                  (2, n - 4)) + contiguous
        rows["pack_edges"].append({
            **common,
            "ms": time_cuda_queued(lambda: hand.pack_edges(z, axis, 2), 20),
            "ms_host_loop": time_cuda(lambda: hand.pack_edges(z, axis, 2),
                                      20),
            "plain_ms": time_cuda_queued(
                lambda: hand.pack_edges_ref(z, axis, 2), 20),
            "bound_ms": pack_bytes / HBM_BYTES_PER_S * 1e3,
            "library_ms": time_cuda_queued(lambda: torch.stack(
                (z.narrow(axis, 2, 2), z.narrow(axis, n - 4, 2))), 20),
            "library_call": "torch.stack of the two narrows"})
        unpack_bytes = band_sectors(case_shape, axis, 2, 4,
                                    (0, n - 2)) + contiguous
        rows["unpack_ghosts"].append({
            **common,
            "ms": time_cuda_queued(
                lambda: hand.unpack_ghosts(z, lo, hi, axis, 2), 20),
            "ms_host_loop": time_cuda(
                lambda: hand.unpack_ghosts(z, lo, hi, axis, 2), 20),
            "plain_ms": time_cuda_queued(lambda: hand.unpack_ghosts_ref(
                z, lo, hi, axis, 2), 20),
            "bound_ms": unpack_bytes / HBM_BYTES_PER_S * 1e3,
            "library_ms": time_cuda_queued(lambda: (
                z.narrow(axis, 0, 2).copy_(lo),
                z.narrow(axis, n - 2, 2).copy_(hi)), 20),
            "library_call": "two copy_ into the narrows"})
        del z, lo, hi
        torch.cuda.empty_cache()
    # the grid's axis-1 exchange at the heat runs' band widths (f32 k=1
    # scalar, f32 k=4 vec16, bf16 k=4 vec8), a rank's weak-scaled block
    for dt, k in HEAT_RUNS:
        dtype = getattr(torch, dt)
        shape = (GRID_N + 2 * k,) * 2
        z = torch.randn(shape, generator=gen, device=device).to(dtype)
        n, item = shape[1], z.element_size()
        lo, hi = hand.pack_edges(z, 1, k)
        contiguous = 2 * lo.numel() * item
        common = {"path": f"grid axis-1 exchange, heat2d {dt} k={k}",
                  "shape": list(shape), "dtype": dt, "axis": 1,
                  "n_bnd": k,
                  "route": hand.pack_route(z, 1, k, lo.data_ptr(),
                                           hi.data_ptr()),
                  "bound_by": "bytes", "bound_counts":
                  "the union of the 32-byte sectors touched on the "
                  "strided side"}
        rows["pack_edges"].append({
            **common,
            "ms": time_cuda_queued(lambda: hand.pack_edges(z, 1, k), 20),
            "plain_ms": time_cuda_queued(
                lambda: hand.pack_edges_ref(z, 1, k), 20),
            "bound_ms": (band_sectors(shape, 1, k, item, (k, n - 2 * k))
                         + contiguous) / HBM_BYTES_PER_S * 1e3,
            "library_ms": time_cuda_queued(lambda: torch.stack(
                (z.narrow(1, k, k), z.narrow(1, n - 2 * k, k))), 20),
            "library_call": "torch.stack of the two narrows"})
        rows["unpack_ghosts"].append({
            **common,
            "ms": time_cuda_queued(
                lambda: hand.unpack_ghosts(z, lo, hi, 1, k), 20),
            "plain_ms": time_cuda_queued(lambda: hand.unpack_ghosts_ref(
                z, lo, hi, 1, k), 20),
            "bound_ms": (band_sectors(shape, 1, k, item, (0, n - k))
                         + contiguous) / HBM_BYTES_PER_S * 1e3,
            "library_ms": time_cuda_queued(lambda: (
                z.narrow(1, 0, k).copy_(lo),
                z.narrow(1, n - k, k).copy_(hi)), 20),
            "library_call": "two copy_ into the narrows"})
        del z, lo, hi
        torch.cuda.empty_cache()
    return rows


def time_stream_kernels(device, gen):
    """Per-launch times of the streaming kernels in place (``out`` = the
    written operand, as the chained microbench rows launch them) at the
    microbench's sizes (daxpy at 2^26, 2^24 and 2^28, scale and sum3 at
    2^26, float32), each with CUDA events back to back (``ms``) and
    queued behind a stall (``queued_ms``: the wrapper's host time out),
    beside the plain version, the one-call torch yardstick timed both
    ways (``y.add_(x, alpha=a)``, ``x.mul_(a)``; none for sum3), the
    route and the byte bound; the 2^26 daxpy row also carries
    ``dispatch_rate``'s host-clock time of the same launch, to check that
    clock."""
    import torch

    from tpu_mpi_tests_torch.instrument.timers import dispatch_rate
    from tpu_mpi_tests_torch.kernels import hand

    rows = {name: [] for name in STREAM_KERNELS}
    a = 1e-7

    def rand(n):
        return torch.rand(n, generator=gen, device=device) + 1.0

    flops_per_elt = {"daxpy": 2, "stream_scale": 1, "stream_sum3": 2}

    def row(name, n, streams, ops, kernel, plain, lib=None, **extra):
        # each stream read or written once; the ops of the table row
        b, why = bound_ms(streams * n * 4, flops_per_elt[name] * n)
        rec = {"path": "microbench", "shape": [n], "dtype": "float32",
               "inplace": True, "route": hand.stream_route(*ops),
               "ms": time_cuda(kernel, 50),
               "queued_ms": time_cuda_queued(kernel, 20),
               "plain_ms": time_cuda(plain, 10), "bound_ms": b,
               "bound_by": why, "library_ms": None, **extra}
        if lib is not None:
            rec |= {"library_ms": time_cuda(lib, 50),
                    "library_queued_ms": time_cuda_queued(lib, 20)}
        rows[name].append(rec)

    for n in (N26, 1 << 24, N28):
        x, y = rand(n), rand(n)
        extra = {}
        if n == N26:
            extra["dispatch_rate_ms"] = 1e3 * dispatch_rate(
                lambda: hand.daxpy(a, x, y, out=y), n_iter=1000,
                n_base=100)
        row("daxpy", n, 3, (x, y), lambda: hand.daxpy(a, x, y, out=y),
            lambda: hand.daxpy_ref(a, x, y), lambda: y.add_(x, alpha=a),
            library_call="y.add_(x, alpha=a)", **extra)
        del x, y
        torch.cuda.empty_cache()
    x = rand(N26)
    row("stream_scale", N26, 2, (x,),
        lambda: hand.stream_scale(1.0, x, out=x),
        lambda: hand.stream_scale_ref(1.0, x), lambda: x.mul_(1.0),
        library_call="x.mul_(a)")
    w, y = rand(N26), rand(N26)
    row("stream_sum3", N26, 4, (w, x, y),
        lambda: hand.stream_sum3(w, x, y, out=y),
        lambda: hand.stream_sum3_ref(w, x, y))
    del w, x, y
    torch.cuda.empty_cache()
    return rows


def stream_queued_fit(rows):
    """The two-point fit b/(t3 − t2) of this run's queued 2^26 daxpy
    (3 passes) and scale (2 passes): GB/s, NaN where t3 <= t2."""
    t3 = rows["daxpy"][0]["queued_ms"]
    t2 = rows["stream_scale"][0]["queued_ms"]
    return 4 * N26 / 1e6 / (t3 - t2) if t3 > t2 else float("nan")


def flash_work(L, d, dtype, causal):
    """(bytes, flops) one fold needs on self-attention operands (L, d):
    q, k, v read once and the f32 carry (m, l, acc) read and written
    once; 4·d flops per live (query, key) pair — all L² of them, or the
    L·(L+1)/2 on or below the diagonal when causal."""
    import torch

    itemsize = torch.empty((), dtype=dtype).element_size()
    pairs = L * (L + 1) // 2 if causal else L * L
    return 3 * L * d * itemsize + 2 * 4 * (2 * L + L * d), 4 * d * pairs


def time_flash_kernel(device, gen):
    """The flash kernel at the main path's shapes, CUDA events (warmed):
    (8192, 128) f32 HIGHEST non-causal and causal, (8192, 128) bf16
    DEFAULT, (32768, 128) bf16 DEFAULT causal — one fold from the fresh
    carry into a second buffer (the same work every launch) — beside its
    plain version at the same precision, the bound (flops over the peak
    of the arithmetic, or bytes over 3.35 TB/s) and
    ``F.scaled_dot_product_attention`` on (1, 1, L, d) as the one-call
    yardstick (TF32 off for f32; the port never calls it). ``queued_ms``
    times the same launches queued behind a stall (the wrapper's host
    time taken out), beside ``ms``."""
    import torch
    import torch.nn.functional as F

    from tpu_mpi_tests_torch.kernels import hand

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for L, dtype, causal, precision in (
            (ATTN_L, torch.float32, False, "highest"),
            (ATTN_L, torch.float32, True, "highest"),
            (ATTN_L, torch.bfloat16, False, "default"),
            (ATTN_L_LONG, torch.bfloat16, True, "default")):
        d = ATTN_D
        q, k, v = (torch.randn((L, d), generator=gen, device=device)
                   .to(dtype) for _ in range(3))
        kw = {"dtype": torch.float32, "device": device}
        carry = (torch.full((L, 1), float("-inf"), **kw),
                 torch.zeros((L, 1), **kw), torch.zeros((L, d), **kw))
        out = tuple(torch.empty_like(t) for t in carry)
        args = dict(scale=d**-0.5, causal=causal, precision=precision)
        n = 20 if L == ATTN_L else 5

        def launch():
            return hand.flash_attention_block(q, k, v, *carry, 0, 0, out=out,
                                              **args)

        ms = time_cuda(launch, n)
        queued = time_cuda_queued(launch, n)
        plain = time_cuda(lambda: hand.flash_attention_block_ref(
            q, k, v, *carry, 0, 0, k_tile=4096, **args), 2)
        lib = time_cuda(lambda: F.scaled_dot_product_attention(
            q[None, None], k[None, None], v[None, None], is_causal=causal),
            n)
        nbytes, flops = flash_work(L, d, dtype, causal)
        arith = "f32" if precision == "highest" else (
            "bf16" if dtype == torch.bfloat16 else "tf32")
        t_ops = flops / PEAK_FLOPS[arith] * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        rows.append({
            "path": "attnbench/microbench", "shape": [L, d],
            "dtype": str(dtype).split(".")[1], "causal": causal,
            "precision": precision, "arithmetic": arith,
            "route": hand.flash_route(dtype, precision, d, True),
            "ctas": -(-L // hand.FLASH_Q_TILE), "ms": ms,
            "queued_ms": queued, "plain_ms": plain,
            "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": lib,
            "library_call": "F.scaled_dot_product_attention (1,1,L,d)"
                            + (", TF32 off" if dtype == torch.float32
                               else ""),
            "tflops": flops / ms / 1e9, "queued_tflops": flops / queued / 1e9})
        del q, k, v, carry, out
        torch.cuda.empty_cache()
    return rows


def ptxas_summary(build) -> dict:
    """Registers, stack and spill bytes of every flash and fused ring
    attention instance, and ptxas's performance notes (C75xx: wgmmas
    serialised, setmaxnreg ignored), from this process's builds."""
    import re

    out = {}
    for lib in ("flash_attention", "fused_ring_attention"):
        entry = None
        for line in build.BUILD_LOGS.get(lib, "").splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                k = re.search(r"\d+((?:flash|fused_ring)_\w*?kernel)(\w*)",
                              m[1])
                entry = (k[1] + (k[2].split("EEv")[0] if k[2].startswith("I")
                                 else "")) if k else m[1]
                out[entry] = {}
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
            if m and entry:
                out[entry].update(stack=int(m[1]), spill_stores=int(m[2]),
                                  spill_loads=int(m[3]))
            m = re.search(r"Used (\d+) registers", line)
            if m and entry:
                out[entry]["registers"] = int(m[1])
            m = re.search(r"\((C75\d\d)\)[^']*'[^']*?\d+((?:flash|fused_ring)"
                          r"_\w*?kernel)", line)
            if m:
                out.setdefault("notes", []).append(f"{m[1]} {m[2]}")
    return out


#: the template arguments of the ring collectives' instances, as the
#: Itanium ABI mangles them
_MANGLED_ARGS = {"5uint4": "uint4", "5uint2": "uint2",
                 "13__nv_bfloat16": "bf16",
                 "t": "u16", "j": "u32", "y": "u64", "m": "u64",
                 "f": "float", "d": "double"}


def coll_kernel_name(mangled: str) -> str:
    """``ring_allgather_kernel<uint4, 4>`` for the mangled name of a
    peer-store kernel instance (the ring collectives, the one-shot
    kernel, the ring halo) or a halo staging copy (``pack.cu``); the name
    itself when it is not one."""
    import re

    m = re.search(r"(ring_allgather_kernel|ring_reduce_scatter_kernel|"
                  r"coll_copy_kernel|oneshot_kernel|ring_halo_kernel|"
                  r"flat_copy_kernel|seam_walk_kernel)I(\w*?)EEv", mangled)
    if not m:
        return mangled
    args, rest = [], m[2]
    while rest:
        t = re.match(r"5uint[24]|13__nv_bfloat16|S\d*_|Li(\d+)E|"
                     r"Lb([01])E|[tjymfd]", rest)
        if not t:
            return mangled
        args.append(t[1] or ({"0": "false", "1": "true"}[t[2]] if t[2]
                             else args[-1] if t[0].startswith("S")
                             else _MANGLED_ARGS[t[0]]))
        rest = rest[t.end():]
    return f"{m[1]}<{', '.join(args)}>"


def check_no_spills(ptxas, is_main) -> None:
    """Fail unless every instance of each library in ``ptxas`` that
    ``is_main(name)`` picks (a main-path route's instance) runs without
    spills. A library this process did not build (found built under
    ``build/torch_kernels``) has no report to read."""
    for lib, instances in ptxas.items():
        if not instances:
            log(f"PTXAS {lib}: built before this process, no report")
            continue
        main = {k: v for k, v in instances.items() if is_main(k)}
        if not main:
            raise SmokeFailure(f"PTXAS {lib}: no main-path instance read")
        for k, v in main.items():
            if v.get("spill_stores", 0) or v.get("spill_loads", 0):
                raise SmokeFailure(f"PTXAS {lib}: {k} spills {v}")


def main_heat_deriv_instances() -> set:
    """The regs instances of the heat update and the derivative that the
    main path launches (``heat_ab.kernel_name``'s names): the heat
    driver's three runs, microbench ``heat`` (k = 1, 4, 8 at 2048²) and
    ``roofline2`` (k = 2, 4, 6, 8 at 2048² and ROOFLINE_LARGE's n), in
    the vector their rows start on; the float32 derivative in 16-byte
    vectors along both dims (the stencil2d drivers, microbench
    ``stencil``)."""
    names = {"deriv_regs_dim0<float, 16>", "deriv_regs_dim1<float, 16>"}
    for _, n, dt, k in heat_main_operands():
        pitch = (n + 2 * k) * (2 if dt == "bfloat16" else 4)
        vb = next(b for b in (16, 8, 4) if pitch % b == 0)
        names.add(f"heat2d_regs<{'bf16' if dt == 'bfloat16' else 'float'}, "
                  f"{k}, {vb}>")
    return names


def is_kstep_regs(name: str) -> bool:
    """The k-step kernels' regs instances: the iterate's
    ``iterate_regs_dim*``, the fused kernel's instances of k >= 1 steps."""
    return name.startswith("iterate_regs_dim") or (
        name.startswith("fused_rdma_kernel<") and name.split(", ")[1] != "0")


def coll_ptxas_summary(build, lib="ring_collectives") -> dict:
    """Registers, stack and spill bytes of every kernel instance of a
    library from this process's build: the ring collectives (both
    routes' all-gather and reduce-scatter, the world=1 copies),
    ``oneshot``, ``ring_halo`` or ``pack`` (each route's instances)."""
    return build.ptxas_summary(lib, coll_kernel_name)


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "smoke test needs a CUDA card", file=sys.stderr)
        return 2
    try:
        from tpu_mpi_tests_torch.kernels import (build, dual_ab, hand,
                                                 heat_ab, kstep_ab, probe_ab,
                                                 stream_ab)
    except ImportError as e:
        print(f"chip_smoke: the port package is not importable ({e}); run "
              f"from the repository root", file=sys.stderr)
        return 2

    t0 = time.perf_counter()
    try:
        card = card_line()
        log(f"CARD {card}")
        log(f"TORCH {torch.__version__} CUDA {torch.version.cuda} "
            f"python {sys.version.split()[0]}")
        device = torch.device("cuda", 0)

        tb = time.perf_counter()
        paths = build.build()
        log(f"BUILD {len(paths)} libraries in "
            f"{time.perf_counter() - tb:.1f} s")
        for name, text in build.BUILD_LOGS.items():
            for line in text.splitlines():
                if "registers" in line or "spill" in line or \
                        "error" in line.lower() or (
                            name in ("flash_attention",
                                     "fused_ring_attention")
                            and "Compiling entry" in line):
                    log(f"  ptxas {name}: {line.strip()}")
        ptxas = ptxas_summary(build)
        log(f"PTXAS attention instances {json.dumps(ptxas)}")
        coll_ptxas = coll_ptxas_summary(build)
        log(f"PTXAS ring collective instances {json.dumps(coll_ptxas)}")
        halo_ptxas = {lib: coll_ptxas_summary(build, lib)
                      for lib in ("ring_halo", "oneshot")}
        log(f"PTXAS ring_halo and oneshot instances "
            f"{json.dumps(halo_ptxas)}")
        pack_ptxas = coll_ptxas_summary(build, "pack")
        log(f"PTXAS pack instances {json.dumps(pack_ptxas)}")
        stream_ptxas = build.ptxas_summary("streams",
                                           stream_ab.kernel_name)
        log(f"PTXAS stream instances {json.dumps(stream_ptxas)}")
        kstep_ptxas = {lib: build.ptxas_summary(lib, kstep_ab.kernel_name)
                       for lib in ("stencil_iterate", "fused_rdma")}
        log(f"PTXAS iterate and fused instances {json.dumps(kstep_ptxas)}")
        check_no_spills(kstep_ptxas, is_kstep_regs)
        heat_ptxas = {lib: build.ptxas_summary(lib, heat_ab.kernel_name)
                      for lib in ("heat2d", "stencil_deriv")}
        log(f"PTXAS heat and derivative instances {json.dumps(heat_ptxas)}")
        main_heat = main_heat_deriv_instances()
        check_no_spills(heat_ptxas, lambda k: k in main_heat)
        probe_ptxas = build.ptxas_summary("alu_probe", probe_ab.kernel_name)
        dual_ptxas = build.ptxas_summary("dual_dim_step", dual_ab.kernel_name)
        log(f"PTXAS probe and dual-step instances "
            f"{json.dumps({'alu_probe': probe_ptxas, 'dual_dim_step': dual_ptxas})}")
        check_no_spills({"alu_probe": probe_ptxas,
                         "dual_dim_step": dual_ptxas},
                        lambda k: k.startswith(("probe_cluster_kernel<",
                                                "dual_regs_kernel<")))
        log(f"ISSUE_RATE {issue_rate():.6g} lone ops/s (SMs x 128 lanes x "
            f"the peak SM clock)")

        errs = check_kernels(device)
        torch.cuda.empty_cache()
        counts, per_step, recs = run_main_path(device)
        torch.cuda.empty_cache()
        rows = time_kernels(device)
        ceiling = next(r["value"] for r in recs["microbench"]
                       if r["metric"] == "hbm_ceiling_fit_gbps")
        log(f"HBM_CEILING measured hbm_ceiling_fit_gbps {ceiling} GB/s, "
            f"published {HBM_BYTES_PER_S / 1e9:g} GB/s "
            f"(ratio {ceiling / (HBM_BYTES_PER_S / 1e9):.4f}); the same "
            f"run's queued two-point fit (TIME daxpy and stream_scale "
            f"2^26) {stream_queued_fit(rows)} GB/s")
    except Exception:
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        return 1

    kernels = []
    for name, source, replaces in (
            ("stencil2d_iterate", ITERATE_SOURCE, ITERATE_REPLACES),
            ("stencil2d_deriv", DERIV_SOURCE, DERIV_REPLACES),
            ("heat2d", HEAT_SOURCE, HEAT_REPLACES),
            ("dual_dim_step", DUAL_SOURCE, DUAL_REPLACES),
            ("alu_probe", PROBE_SOURCE, PROBE_REPLACES),
            *((name, PACK_SOURCE, PACK_REPLACES[name])
              for name in PACK_REPLACES),
            *((name, STREAMS_SOURCE, STREAM_REPLACES[name])
              for name in STREAM_KERNELS),
            ("flash_attention_block", FLASH_SOURCE, FLASH_REPLACES),
            ("ring_halo", RING_SOURCE, RING_REPLACES),
            ("stencil2d_fused_rdma", FUSED_SOURCE, FUSED_REPLACES),
            ("ring_allgather", COLL_SOURCE, AG_REPLACES),
            ("ring_reduce_scatter", COLL_SOURCE, RS_REPLACES),
            ("oneshot", ONESHOT_SOURCE, ONESHOT_REPLACES),
            ("fused_ring_attention", FRA_SOURCE, FRA_REPLACES)):
        main_row = rows[name][0]
        extra = {}
        if name == "flash_attention_block":
            # max_abs_err: the normalised output at the f32 HIGHEST
            # main-path operands; every class and main-path case beside it
            extra = {"also_replaces": FLASH_ALSO_REPLACES,
                     "max_abs_err_by_class":
                         errs["flash_attention_block classes"],
                     "max_abs_err_main_path":
                         errs["flash_attention_block main path"]}
        if name in ("flash_attention_block", "fused_ring_attention"):
            extra["launches_by_route_per_path"] = {
                p: r[name] for p, r in ROUTE_COUNTS.items()}
            prefix = "flash_" if name == "flash_attention_block" \
                else "fused_"
            extra["ptxas"] = {k: v for k, v in ptxas.items()
                              if k.startswith(prefix)}
        if name == "dual_dim_step":
            # max_abs_err is the derivatives'; the residual is a sum in
            # another order, held to a relative tolerance
            extra = {"residual_rel_err": errs["dual_dim_step residual "
                                              "(relative)"],
                     "lean_residual_rel_err": errs["dual_dim_step lean "
                                                   "residual (relative)"],
                     "residual_rtol": hand.RESIDUAL_RTOL[torch.float32],
                     "bf16_residual_rel_err": errs["dual_dim_step residual "
                                                   "(relative) bf16"],
                     "bf16_lean_residual_rel_err": errs[
                         "dual_dim_step lean residual (relative) bf16"],
                     "bf16_residual_rtol": hand.RESIDUAL_RTOL[
                         torch.bfloat16],
                     "launches_by_route_per_path": {
                         p: r[name] for p, r in ROUTE_COUNTS.items()
                         if sum(r[name].values())},
                     "ptxas": dual_ptxas}
        if name == "ring_reduce_scatter":
            extra = {"also_replaces": RS_ALSO_REPLACES,
                     "cross_wired_max_abs_err": errs["cross-wired"]}
        if name == "ring_allgather":
            extra = {"cross_wired_max_abs_err": errs["cross-wired"]}
        if name in RING_COLLECTIVES:
            extra["launches_by_route_per_path"] = {
                p: r[name] for p, r in ROUTE_COUNTS.items()}
            extra["ptxas"] = {k: v for k, v in coll_ptxas.items()
                              if name in k or "copy" in k}
        if name == "oneshot":
            extra = {"also_replaces": ONESHOT_ALSO_REPLACES,
                     "cross_wired_max_abs_err": errs["cross-wired"]}
        if name == "ring_halo":
            extra = {"cross_wired_max_abs_err":
                     errs["ring_halo cross-wired"]}
        if name in ("ring_halo", "oneshot"):
            extra["launches_by_route_per_path"] = {
                p: r[name] for p, r in ROUTE_COUNTS.items()}
            extra["ptxas"] = halo_ptxas[name]
        if name in HEAT_DERIV_KERNELS:
            extra["launches_by_route_per_path"] = {
                p: r[name] for p, r in ROUTE_COUNTS.items()
                if sum(r[name].values())}
            extra["ptxas"] = heat_ptxas[
                "heat2d" if name == "heat2d" else "stencil_deriv"]
        if name in KSTEP_KERNELS:
            extra["launches_by_route_per_path"] = {
                p: r[name] for p, r in ROUTE_COUNTS.items()
                if sum(r[name].values())}
            extra["ptxas"] = kstep_ptxas[
                "stencil_iterate" if name == "stencil2d_iterate"
                else "fused_rdma"]
        if name == "stencil2d_fused_rdma":
            extra["cross_wired_max_abs_err"] = errs[
                "stencil2d_fused_rdma cross-wired"]
        if name in PACK_REPLACES:
            # the flat copies serve both; the seam walk is one per kernel
            extra["launches_by_route_per_path"] = {
                p: r[name] for p, r in ROUTE_COUNTS.items()}
            extra["ptxas"] = {
                k: v for k, v in pack_ptxas.items()
                if k.startswith("flat") or ("true" in k) == (
                    name == "pack_edges")}
        if name in STREAM_REPLACES:
            extra["launches_by_route_per_path"] = {
                p: r[name] for p, r in ROUTE_COUNTS.items()}
            extra["ptxas"] = {
                k: v for k, v in stream_ptxas.items()
                if k.endswith(f", {STREAM_FUNCTORS[name]}>")}
        if name == "fused_ring_attention":
            # max_abs_err: the normalised output at the main path's f32
            # HIGHEST operands (8192, 128); every class beside it, each
            # case also bit for bit the pipelined tier's flash launches
            extra |= {"also_replaces": FRA_ALSO_REPLACES,
                      "max_abs_err_by_class":
                          errs["fused_ring_attention classes"]}
        if name == "alu_probe":
            # max_abs_err is the bit-exact mixes' (fma, step5*, heat5);
            # the dual mixes feed a sum in another order back and are
            # held to hand.alu_probe_tolerance
            extra = {"dual_mixes": errs["alu_probe dual mixes"],
                     "launches_by_route_per_path": {
                         p: r[name] for p, r in ROUTE_COUNTS.items()
                         if sum(r[name].values())},
                     "ptxas": probe_ptxas,
                     "issue_rate": issue_rate(),
                     "bound_counts": "issued lone mul/add/sub over the "
                                     "issue rate, bf16 two elements an "
                                     "instruction"}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(c[name] for c in counts.values()),
            "launches_per_path": {p: c[name] for p, c in counts.items()},
            "launches_per_timestep": {p: s[name]
                                      for p, s in per_step.items()
                                      if name in s},
            "max_abs_err": errs[name],
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"],
            "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"],
            "variants": rows[name],
            **extra,
        })
    log(f"SECONDS {time.perf_counter() - t0:.1f}")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
