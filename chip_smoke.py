#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py                 # every phase, one card
    python3 chip_smoke.py --steps 10      # a shorter slice phase
    python3 chip_smoke.py --phases 6,8    # some phases (no "ok" line)
    python3 chip_smoke.py --phases 3      # the B2 checks alone
    python3 chip_smoke.py --phases 9      # the B2t and B3 checks alone
    python3 chip_smoke.py --phases 12     # the strategies and test nets
    python3 chip_smoke.py --phases 13     # the RNG bridge on the card
    python3 chip_smoke.py --phases 14     # checkpoint, snapshot, restore
    python3 chip_smoke.py --phases 15     # the rest of the solver, and the
                                          # strategies over the lanes
    python3 chip_smoke.py --phases 16     # the VGG11-BN template net
    python3 chip_smoke.py --phases 17     # the pipeline and the telemetry
    python3 chip_smoke.py --phases 18     # config_block, evaluate,
                                          # debug_info and the watchdog
    python3 chip_smoke.py --phases 19     # the self-healing sweep and the
                                          # genetic search's checkpoint
    python3 chip_smoke.py --phases 20     # the tiled read's k order, and
                                          # the per-lane clocks (virtual
                                          # time)
    python3 chip_smoke.py --phases 21     # the multi-group durable sweep
                                          # driver (run_1000_sweep.py)
    python3 chip_smoke.py --phases 22     # the fault processes and the
                                          # co-design driver
    python3 chip_smoke.py --phases 23     # the experiment harness
    python3 chip_smoke.py --phases 24     # the in-repo CIFAR-10 "full"
                                          # nets and the siamese net
    python3 chip_smoke.py --phases 25     # the ImageNet-width zoo nets
                                          # and generated_net
    python3 chip_smoke.py --phases 26     # the data sources: ImageData,
                                          # WindowData, the Python layer,
                                          # LevelDB, the prefetching feed
    python3 chip_smoke.py --b2-path       # only time B2 through its wrapper
    python3 chip_smoke.py --b2t-path      # only time B2t (wrapper, kernel,
                                          # tile rows)
    python3 chip_smoke.py --b3-path       # only time B3 (wrapper, kernel,
                                          # its passes)
    python3 chip_smoke.py --b4-path       # only time B4 (through the
                                          # layer, alone, autograd's)
    python3 chip_smoke.py --b1-path       # only time B1 (through the
                                          # solver's tail, alone, a copy)
    python3 chip_smoke.py --timed-checkout DIR  # run DIR's chip_smoke.py,
                                          # each of its phases timed
    python3 chip_smoke.py --cold-start    # only time the C = 512 sweep's
                                          # cold start with and without
                                          # precompile_chunk

Phases (each raises on failure; the script then exits non-zero and
prints no "ok" line):

1. the card's name and power limit; build the kernels from csrc/ with
   nvcc (one process per source, started together), timed;
2. kernel B1 (fused ApplyUpdate+Fail) against its plain version,
   bit for bit (`torch.equal` on the int32 view of data', and life_q'),
   every mode, int16 and int32 banks, C = 1 and C = 4, counters within a
   few writes of zero: each ip1/ip2 weight and bias alone, and the
   step's groups in one launch each (the untiled four leaves, the tiled
   ten with conv1-3), a group with leaves off the 16-byte grid, and 20
   leaves in two launches;
3. kernel B2 (crossbar GEMM) against its plain version at the ip1/ip2
   shapes and at ragged ones (1x7x3, 5x18x7, 100x1000x10, 130x257x65),
   C = 1 and C = 4 (x shared and per lane), q_bits 0/2/8, sigma 0 and
   host noise, within the f32 summation-order bound K * 2^-24 * (|x| @
   |w_eff|) (no TF32 anywhere); every storage layout the wrapper takes
   (dense, Caffe's stored (C, num_output, K) turned by view with x as
   the (M, C, K) view, rows off the 16-byte grid, mixed; broken as bool
   or uint8) equal to the dense f32 call bit for bit, the scale reduced
   inside the call equal to w.abs().amax, and a second call equal to the
   first (the split-K order is fixed); then the in-kernel Philox draw:
   moments, reproducibility, independence across seeds and lanes,
   agreement with its tensor-op twin, and the same draw on every
   layout;
4. the single-config slice: CIFAR-10-quick from its solver prototxt,
   lifetimes N(1e8, 3e7), ternary crossbar read, packed banks, fused
   epilogue, batch 100 from the in-repo LMDB, on the "cuda" engine;
   losses, the step time (median and quartiles), a breakdown into host
   feed and device busy time, 10 steps through a prefetching feed at
   each GIL switch interval of 5 and 1 ms, and each kernel's launch
   count against the path's (B2 twice a step, B1 once a step for the four fault
   leaves);
   then a short run with rram_forward.sigma = 0.05 (in-kernel noise);
5. fault transitions: mean 300, std 50, the "cuda" and the "torch"
   engine from one seed, both on the card: in lockstep (same state and
   batch each step) losses within 1e-5 relative and life_q identical;
   an independent "torch" run's life_q identical at every step too;
   cells broken, every broken cell at its stuck value. Then the
   run-to-run drift: two independent "cuda" runs from one seed, three
   ways (cuDNN's nondeterministic algorithms allowed, the same with
   RRAM_POOL_BWD=cuda, and torch.backends.cudnn.deterministic as
   device.py sets it); the port's own setting must give bit-identical
   runs;
6. kernel B4 (max-pool backward) against its plain version, bit for bit
   (`torch.equal` on the int32 view), at pool1's shapes for C = 1 and
   C = 4, at an odd geometry (7x7, k3 s2, pad 1), on a constant plane
   where every window ties, with NaN windows, on 300x300 planes (tiles
   of row bands) and through the private launcher on pool1 in bands of
   rows and columns; against autograd's max-pool backward within the
   reordering of at most 4 f32 addends on the finite cases (reported);
7. the sweep at full width: SweepRunner over CIFAR-10-quick at C = 512
   config lanes (halved until it fits the card), N(1e8, 3e7), ternary,
   packed banks, fused epilogue, the device-resident dataset,
   RRAM_POOL_BWD=cuda, chunk 5: one warm chunk, a step at a time in
   lockstep with the torch engine (every lane's loss within 1e-5
   relative, the banks identical; a lane with no cell dead at init
   within 0.05 of ln(10)), then 10 timed steps:
   configs x steps per second, step time (median and quartiles, CUDA
   events between steps), peak device memory, bytes_per_step_est, the
   profiler's device busy time, and the launches per step whatever C
   is: B2 2, B1 1, B4 1; then one chunk with cudnn.deterministic flipped,
   timed beside it;
8. the sweep held against the plain path and against Solver at C = 8,
   N(300, 50) so cells break: in lockstep, engine "cuda" (and
   RRAM_POOL_BWD=cuda) against engine "torch" (RRAM_POOL_BWD=torch)
   from the same state and batch at every step, life_q identical and
   losses within 1e-5 relative; lane i against a single-config Solver
   started from lane i's state each step, the same; one lane poisoned
   with a NaN parameter is quarantined while the others stay finite;
9. kernels B2t (tiled crossbar read, csrc/crossbar.cu
   rram_crossbar_tiled_forward) and B3 (the implicit-im2col conv read,
   csrc/crossbar.cu rram_crossbar_implicit_forward) against their
   plain versions at the tiled slice's shapes (ip1, conv2, conv3), on a
   strided dilated conv and ragged tiles (bk 7, bn 3), and for B2t at the
   edges of its tiling (M 1, 128 and 129; K 1000 with bk 128 and 96; N
   10 and 130 with bn 64; N 64 with bn 32), C = 1 and C = 4 with x shared
   and per lane, sigma 0 and 0.05 (host noise and in-kernel noise): equal
   (`torch.equal`) on dyadic inputs at sigma 0, ADC 3 and 8 bits, and on
   random ones at the case's ADC (the plain read's partials follow the
   kernels' k order on the card); B2t on every storage layout its
   wrapper takes (dense, stored and turned with x folded, unaligned
   rows, mixed; broken bool, uint8 or f32) equal to the dense call,
   twice each, and at each tile
   height of its GEMM pass (32, 112, 128 rows); B3 equal bit for bit to
   B2t over the patch rows (`conv_patch_rows`) at the same tiles, and on
   every layout its wrapper takes (w, stuck, eps as the `to_im2col` view
   of the stored weight; broken bool, uint8 or f32; x as the transposed
   view of a laned activation) equal to the dense call, twice each; B2t
   and B3 equal to plain where a lane has more tile steps than the ADC
   pass keeps in shared memory; the tiled path's in-kernel noise equals
   B2's for the same seed and cell at each tile height;
10. the tiled single-config slice: CIFAR-10-quick with conv_also,
   rram_forward { adc_bits: 8 tiles: "cells=128x128" }, N(1e8, 3e7),
   ternary, packed banks, fused epilogue, conv_im2col="implicit", 50
   steps: the step time, the device's idle share and top kernels, and the
   launches a step (B3a 2, B2t 1, B2a 1, B1a 1); the first step's loss
   within 1e-5 relative of the torch engine's first step from the same
   seed, the second's within 0.05 of ln(10); at N(300, 50) (int16
   banks) engine "cuda" against "torch" and premat against implicit, in
   lockstep: life_q identical every step; then a short sigma = 0.05 run;
11. the tiled sweep at C = 64 (the same configuration, chunk 5,
   RRAM_POOL_BWD=cuda): configs*steps/s, step time, peak memory, the
   launches a step (B3b 2, B2t 1, B2b 1, B1b 1, B4 1), and lanes held
   against a single-config Solver from their state (banks identical);
12. the mitigation strategies and the test nets: the phase-4 slice at
   N(300, 50) through (a) threshold (at the median |update| / (rate *
   lr_mult) of a first step, so it zeroes a share between 0 and 1),
   (b) remapping (start 5, period 5, a seeded prune order of ip1's 64
   outputs), untracked and tracked, (c) genetic (start 3, period 5,
   switch_time 50, masks from a .caffemodel the port's encode writes),
   (d) all three for 20 steps; each step the "cuda" and the "torch"
   engine from the same state and batch: life_q identical except on
   cells whose "torch" |update| lies within 1e-5 relative of the
   threshold's cutoff (counted), remap_slots identical, losses and
   params within 1e-5 relative, the "cuda" step launching B2 twice and
   B1 once and making no more synchronizing CUDA calls than a step
   without a strategy (after the first), the "torch" step launching
   nothing, results on the card; the card's
   neuron order equal to numpy's stable argsort; then (d)'s step time
   through Solver.step, in turns with the same slice without a
   strategy (paired), beside phase 4's, and test_all on
   cifar10_test_lmdb (accuracy, loss, the forward's time);
13. the RNG bridge (core/prng.py, the reference's threefry key chain):
   random_bits, uniform, normal and bernoulli drawn on the card equal
   the same draws on the CPU bit for bit (`torch.equal` on int32 views)
   at shapes 1, 63, 2^20 + 3 and 512 keys x (64, 1024) (its rows 0, 255
   and 511 drawn on the CPU), the small ones also forced onto the card; the main-path Solver (seed 7) built on
   the card and on the CPU: keys, params and packed banks bit-identical,
   then 20 card steps through B2a (2 a step) and B1a (1 a step) whose
   crossbar seeds equal the CPU solver's key chain; the key chain's host
   time a step (one config, and C = 512 lanes), derived in blocks as the
   solver does and step by step; the sweep's fault-state
   draw at C = 512 (untiled, beside the torch.Generator loop it
   replaced) and C = 64 (tiled), rows 0 and C - 1 drawn alone equal to
   the full draw; the construction times and phase 4's step time beside
   its reading before the key chain;
14. the formats across a restart (a temp directory, removed at the
   end): (a) phase 7's sweep (C = 512, halved until it fits) runs 5
   steps, checkpoints (the v6 .npz, timed, its bytes), runs 5 more; a
   fresh runner from the same seed restores it (timed) and runs the same
   5: every step's lane losses and every params, history, life_q,
   stuck_bits and quarantine leaf bit-identical (`torch.equal` on int32
   views), the continued steps launching B2 2, B1 1, B4 1 a step, their
   step-time median beside the uninterrupted run's; (b) save_fault_states
   at that C, read back and packed with the runner's spec, equal to the
   live banks byte for byte (the caller's time and the writer's); (c)
   phase 4's Solver with snapshot 10 (BINARYPROTO) through solve() to
   iteration 20, then a fresh Solver's solve(resume_file=<iter 10>):
   losses 11-20, params, history and banks bit-identical, the continued
   steps launching B2 2, B1 1 a step, each file's bytes and the
   snapshot's and restore's times; the same with phase 10's tiled Solver
   (B3 2, B2t 1, B2 1, B1 1 a step); (d) a C = 8 card checkpoint at
   N(300, 50) restored into a device="cpu" runner (engine "torch"):
   every leaf equal, and one CPU step within 1e-5 relative of one card
   step from that state, life_q identical;
15. the rest of the solver and the strategies over the sweep's lanes:
   (a) phase 4's slice under each of the six update rules (SGD,
   Nesterov, AdaGrad, RMSProp, AdaDelta, Adam), 10 steps from one state,
   each step through the "cuda" and the "torch" engine from the same
   state: life_q identical, losses within 1e-5 relative, params within
   1e-5 relative except where AdaGrad, RMSProp or Adam divides by the
   root of a history bank below 1e-4 (a gradient near zero: a gradient
   difference at f32 rounding moves the update beyond 1e-5; counted),
   B2 2 and B1 1 a step; each rule's step median in turns with SGD; each rule on fixed
   inputs on the card equal to the CPU bit for bit; (b) iter_size 2,
   clip_gradients (half the first steps' norm, so it engages; norms and
   scales printed) and L1 the same way, B2 4 and B1 1 a step; B1's time
   a step under SGD, Adam and (b); (c) threshold and tracked remapping
   (start 5, period 5) in the sweep: at C = 8, N(300, 50), the laned
   "cuda" step against the laned "torch" step and each lane against a
   single-config Solver from its state, life_q identical off the
   threshold's edge cells, remap slots identical, two remaps; at C = 512
   (phase 7's configuration) 10 steps, 5 steps of the same runner
   without strategies between their halves: configs x steps per
   second, B2 2, B1 1, B4 1 a step, peak memory; (d) the genetic search in the sweep at C = 64
   (start 3, period 5), one lane quarantined: the host's time an
   application, the quarantined lane's params and masks untouched;
   (e) the C = 512 sweep under Adam (step time, peak memory, the two
   history banks' bytes) and under iter_size 2 (B2 4, B1 1, B4 2 a
   step), B1's time in each;
16. the experiment template's VGG11-BN net
   (models/cifar10_vgg11/cifar10_vgg11_template.prototxt as
   run_gaussian_exp.py patches it: lifetimes N(4000, 1200), --hw-sigma's
   rram_forward.sigma = 0.05, BINARYPROTO snapshots, batch 100 from the
   in-repo LMDB, packed banks, fused epilogue): (a) BatchNorm (TRAIN and
   global), Scale and Bias at VGG11's shapes, unlaned and over 4 lanes,
   on the card against the CPU (tops within 1e-5 of their largest value,
   gradients 1e-4, moving stats 1e-5 relative, scale_factor bit for
   bit); (b) the Solver, 20 steps kernel path against plain path in
   lockstep (losses, params and statistics within 1e-4 relative, the
   plain path's noise being B2's Philox twin; scale_factor bit for bit;
   life_q identical except on cells of a bias that feeds a BatchNorm
   whose write rests on rounding, each checked and counted), B2 3 and B1
   1 a step; the step time in turns with the plain path (10 steps each),
   the device's
   busy time and top kernels, the BatchNorm and Scale layers' share,
   peak memory, test_all over 5 test batches (global statistics; no
   param moves) and two runs from one seed bit-identical; (c)
   threshold, tracked remapping (fc1's and fc2's 1024 outputs) and
   genetic, 4 lockstep steps each; (d) the sweep at the largest C of
   64, 32, 16 that fits (RRAM_POOL_BWD=cuda, the device-resident
   dataset): configs x steps per second, peak memory, top kernels, B2 3,
   B1 1, B4 5 a step, lanes 0 and C - 1 against single-config Solvers;
   (e) iter_size 2 in lockstep (B2 6, B1 1); (f) a snapshot and a sweep
   checkpoint restored, continuing bit for bit; (g) conv_also on
   128x128 tiles: each read alone equal to plain (dyadic and random
   inputs, sigma 0 and 0.05, ADC 3 and 8 bits), then 3 lockstep steps
   through B3 (conv2-8), B2t (fc1-3) and B1 (twice a step: 22 fault
   leaves, 16 a launch) without an ADC and with the template's 8-bit
   ADC: every read's input and output equal, losses equal, banks bit
   for bit;
17. the sweep's pipeline and the telemetry plane: (a) phase 7's sweep
   (C = 512, chunk 5, metrics to a JsonlSink, tracing on) at
   pipeline_depth None, 0 and 2 from one seed, 2 chunks each: losses,
   outputs, params, history, banks and records (timing aside) identical
   at every depth, configs x steps per second and host_blocked_seconds
   of each (depth 2's below depth 0's), the laned step's synchronizing
   calls with metrics on and off (equal), depth 2's setup record and
   bench_phase_breakdown; (b) phase 4's slice with enable_metrics and
   display 10, 50 steps, the kernel path against the plain path in
   lockstep: records' integers equal, floats within 1e-5 relative;
   synchronizing calls a step with metrics on and off (equal) and the
   step median each way, in turns; (c) health_every 10 on that Solver
   and on a depth-2 C = 512 sweep, each census equal to a numpy recount
   of the banks' host copy, census ms and its share of 10 steps; the
   tiled slice's per-tile counters and census (128x128 tiles,
   conv_also) equal to the recount; (d) a C = 8 runner whose sink
   blocks, stall_timeout_s 2: StallError within 10 s with an emergency
   checkpoint, which a new runner restores and continues bit for bit
   against a run that never stalled; (e) every JSONL line valid under
   the port's schema, the Chrome trace with its dispatcher and
   chunk-consumer tracks;
18. config_block, evaluate, debug_info and the watchdog: (a) the tiled
   sweep (phase 11's) at C = 64 in blocks of 16 and the untiled sweep
   (phase 7's) at C = 512 in blocks of 128, each against its unblocked
   run from one seed (the watchdog armed, so every lane carries its
   sentinels), 3 steps: every step's lane losses and every params,
   history, life_q, stuck_bits and quarantine leaf and the sentinels
   bit for bit (the float debug vectors' gap reported), the blocked run
   launching each kernel the block count times a step; (b) the tiled
   sweep at C = 512 in blocks of 64, one warm and 3 timed steps:
   configs x steps per second, step median and
   quartiles (CUDA events), peak memory, beside phase 11's C = 64; (c)
   the VGG11-BN sweep (phase 16's) at the largest of C = 512 and 256
   that fits, in blocks of 64, one warm and one timed step: configs x
   steps per second, resident and peak memory, beside phase 16's; (d)
   evaluate at C = 512 (on (a)'s blocked untiled runner) on a test
   batch: lanes 0, 1, 255 and 511 equal to a single-config forward of
   their params (loss within 1e-5 relative, accuracy equal), its time;
   (e) phase 4's Solver with debug_info, 3 steps, each through the kernel
   and the torch engine from the same state: the lines in the
   reference's shapes, the debug vectors within 1e-5 relative, B2 2 and
   B1 1 a step with debug on and off; (f) the watchdog: a Solver with a
   NaN base_lr halts after iteration 0 naming conv1's update; a C = 8
   sweep in blocks of 4 with lane 5 poisoned quarantines lane 5 alone by
   its sentinel, "halt" stops it (also across step() calls), "snapshot"
   writes a checkpoint that restores;
19. the self-healing sweep and the genetic search's checkpoint: (a)
   phase 7's sweep at C = 512 with metrics, pipeline_depth 2,
   enable_self_healing(budget=12, max_retries=1), chunk 2, NaN written
   into ip2's weights of lanes 7, 200 and 511 after 4 iterations, run
   until healing_complete(), against a clean run of 12 iterations: each
   healthy lane's final loss and every params, history and bank row bit
   for bit, every config completed (the poisoned ones in 2 attempts),
   one requeue and one reseed record each, every record schema-valid,
   B2 2, B1 1, B4 1 a step; configs x steps per second of both runs, the
   median and largest _heal_pass in ms, a refill's row bytes; (b) at
   C = 8 a config poisoned at every attempt fails with the reference's
   diagnosis, every config accounted for; (c) at C = 64 (int16 banks) 16
   extra_configs seeded as lanes free up, a spec past int16 refused by
   submit_configs, a start_empty runner completing its submissions
   (their own budget held); (d) a checkpoint mid-sweep, then a poisoned
   lane re-seeded from it (recovery "checkpoint", the lane's rows equal
   to the file's slice); (e) phase 15 (d)'s genetic sweep at C = 64
   checkpointed with `__genetics__` and restored into a new runner,
   whose next 6 steps equal the never-stopped run's bit for bit (losses,
   every state row, prune masks, generators);
20. the tiled read's k order and the per-lane clocks: (a) at VGG11's fc1
   and conv2 and the narrow VGG-BN net's fc1 (128x128 tiles, random
   inputs, sigma 0), the kernel's raw per-tile partials against
   torch.matmul's (the plain read before the repair: elements apart) and
   against the plain read's now (none apart), the share of the 8-bit
   reads' outputs apart before and now, and the in-kernel W_eff cells
   apart from the Philox twin's at sigma 0.05; with the exact-case counts
   of phases 9 and 16 (g); (b) phase 7's sweep at C = 512, depth 2,
   start_empty self-healing: 256 configs at budget 12, 256 more after 4
   iterations at budget 8, to completion, under virtual time and in
   shared time: configs x steps per second (also outside the second
   wave's refills, whose host seconds are printed), step time (median and
   quartiles, CUDA events), peak memory, the per-lane batch gather's
   bytes, B2 2, B1 1, B4 1 a step; each timed after its first chunk; (c)
   at C = 64 with read noise (sigma 0.05, drawn from each lane's step
   key) four configs submitted with 32 others, seeded first into lanes
   0-3 and, in a second run, after the others (a refill policy) into
   other lanes two iterations later: losses, broken shares and every
   params, history and bank row at completion bit for bit; (d) a
   virtual-time checkpoint
   written mid-sweep, restored into a new runner: the report and every
   state leaf equal to the never-stopped run's; a shared-time runner
   refuses the file with the reference's ValueError;
21. the multi-group durable sweep: the port's
   examples/gaussian_failure/run_1000_sweep.py, in this process, over
   CIFAR-10-quick at full width from the in-repo LMDB, 1024 configs in
   two groups of 512, N(1e8, 3e7), ternary, packed banks, engine "cuda",
   depth 2, no block, RRAM_POOL_BWD=cuda, 10 iterations in chunks of 5,
   a run directory: (a) group 1 built by the GroupPrefetcher while group
   0 runs (each group's runner construction, build and wait seconds,
   setup_overlap_seconds, host_blocked_seconds, decode and compile
   seconds, configs x steps per second and the device step times, those
   enqueued while the build ran apart; peak memory, wall time, B2 2, B1
   1, B4 1 a step); (b) the same with --no-overlap; (c) the same with
   --checkpoint-every 5 and SIGTERM once group 1 has stepped: exit 75
   with group 1's checkpoint journaled, then --resume to exit 0. The
   journals' group records, every metrics stream, sweep_report.json and
   every group_*_faults.npz array of (b) and of the resumed (c) equal
   (a)'s, timing fields aside;
22. the fault processes (fault/processes/) over CIFAR-10-quick at full
   width, N(1e8, 3e7), ternary, packed banks, engine "cuda": (a) the
   Solver under read_disturb (kernel B1 in mode "always"),
   read_disturb:reads_per_step=400, permanent_fault_map:fraction=0.05
   (mode "never") and endurance_stuck_at+conductance_drift:nu=0.2,
   sigma=0.1 (unfused: its fused_epilogue_reason printed), kernel path
   against plain path in lockstep for 4 steps: every bank (counters,
   stuck codes, ages, rates) equal at every step, losses within 1e-5
   relative, B2 2 and B1 1 a step in the stack's mode (0 unfused); (b)
   the drift stack's draw and one fail on a stored state, card against
   CPU, bit for bit; (c) phase 7's sweep at C = 512 under read_disturb,
   permanent_fault_map and the drift stack (RRAM_POOL_BWD=cuda): a warm
   step in lockstep with the plain engine (fusing stacks), then 3 timed
   steps, configs x steps per second and the step median beside phase
   7's, B2 2, B1 1 in the stack's mode (0 unfused) and B4 1 a step, the
   drift pass's device time and its share of the step; then B1 in modes
   "always" and "never" on those steps' own fused tails against its
   plain version, timed (the kernels line's new rows); (d) the port's
   run_1000_sweep --process read_disturb (one group of 64, 10
   iterations: exit 0, the manifest pins the canonical spec, B1 "always"
   once a step) and run_codesign over 2 processes x 2 adc_bits x 2
   lanes (exit 0 or 65, the report written, its front printed);
23. the experiment harness (the port's examples/gaussian_failure/
   run_gaussian_exp.py, run_sweeps.py and prune_order.py), in this
   process from a temporary working directory, through the VGG11-BN
   template with absolute paths and snapshot_format BINARYPROTO, at
   phase 16's N(4000, 1200), batch 100: (a) one config with -t 0.01 and
   --hw-sigma 0.05 for 20 iterations (exit 0, the log opening with the
   solver's text and holding Iteration lines, the last iteration's
   .caffemodel, .solverstate and .faultstate, B2a 3 a step and no B1
   (f32 banks), the step time); (b) --sweep-means 4000,8000,1e8 at sigma
   0.05 with RRAM_POOL_BWD=cuda (one line a config, the broken share not
   rising with the mean, above 0 at 4000 and 0 at 1e8, B2b 3 and B4 5 a
   step); (c) run_sweeps over prob 5,20 and threshold 0.01,1e9, 10
   iterations a config (the table; broken > 0 on the prob rows, 0 at
   threshold 1e9); (d) prune_order on (a)'s model at 0.6 (two rows of
   1024), then the runner with -r <order>,5,5 for 10 iterations (the
   remapping applied); (e) whether h5py imports: if not, the template as
   it is (HDF5) refused by name in a process of its own, non-zero exit,
   no Iteration line; if so, its HDF5 snapshot written and restored;
24. the in-repo nets (examples/cifar10/cifar10_full_train_test.prototxt,
   cifar10_full_sigmoid_train_test.prototxt and its BatchNorm form; the
   siamese net), from a temporary working directory for snapshots, the
   LMDB sources read from the checkout, batch 100: (a) each CIFAR-10
   "full" net from its own solver file (cifar10_full_solver.prototxt,
   the sigmoid solver, the BN-sigmoid solver) with only a gaussian
   failure_pattern on ip1 at N(300, 50) (int16 banks; cells die within
   3-8 writes), a seed and BINARYPROTO snapshots set, packed banks, the
   ternary read, the fused epilogue, engine "cuda": the card's and the
   CPU's Solver from one seed equal at init, 5 steps in lockstep (each
   CPU step from the card's state, batch and key): losses within 1e-4
   relative, banks equal but for cells whose write rests on an exact-0
   update in one package (each checked, counted), B2a 1 and B1a 1 a
   step; then 10 timed steps (their median, after the lockstep's 5)
   and the LRN or Sigmoid layers' device time a step; (a') cifar10_full_solver.prototxt
   as it is (snapshot_format HDF5) in a process of its own: without
   h5py refused by name, non-zero exit, no Iteration line; with it, its
   HDF5 snapshot written; (b) cifar10_full and the BN-sigmoid net at
   C = 8 (RRAM_POOL_BWD=cuda), 3 steps: each lane against a
   single-config Solver from its state (loss within 1e-5 relative,
   banks identical), B2b 1 and B1b 1 a step, then blocks of 2 against
   the unblocked runner: banks bit for bit, losses within 1e-5 (the
   conv leaves part there through cuDNN's algorithm at small group
   counts: reported); cifar10_full at C = 512 (halved until it fits),
   N(1e8, 3e7), a warm and 3 timed steps: configs x steps per second,
   step times (CUDA events), peak memory, B2b 1, B1b 1, B4 1 a step,
   the LRN layers' device time, then the same steps in blocks of C / 4,
   every state leaf bit for bit; (c) a synthetic net at C = 8 (Input,
   conv, LRN across channels, Slice and Concat on axis 1, Eltwise SUM
   with coefficients and PROD, Softmax, Flatten, InnerProduct,
   EuclideanLoss): as (b)'s C = 8 checks; then the new layers alone (no
   conv, no GEMM) forward and backward over 8 lanes of laned data
   against blocks of 2, losses and the data gradient bit for bit; (d) the siamese TRAIN net at batch 64 (its Data layers fed as
   one Input layer of pair_data 2x28x28 and sim; its LMDB is not in the
   repository), the crossbar read armed on its six InnerProduct reads of
   three shared weights: B2a 6 a forward, loss within 1e-5 relative of
   the CPU's, gradients within 1e-4 of their largest value; (e)
   cifar10_full with conv_also on 128x128 tiles, 8-bit ADCs, implicit
   operands, 3 steps: B3 2 (conv2, conv3), B2t 1 (ip1), B1 1, no B2a or
   B4 a step, finite losses;
25. the ImageNet-width zoo nets (models/bvlc_alexnet,
   bvlc_reference_caffenet, bvlc_googlenet, resnet50) from their own
   solver files at their published widths, and generated_net (the
   prototxt examples/pycaffe/run_pycaffe.py writes with the reference's
   NetSpec, carried here as GENERATED_NET), under RRAM_POOL_BWD=cuda:
   (a) a stand-in for the ILSVRC12 LMDBs (not in the repository), 64
   3x256x256 Datums from a seed written by the port's BulkWriter into a
   temporary directory, `mean_file` replaced by mean values 104, 117,
   123, a gaussian failure_pattern on the InnerProduct layers at
   N(300, 50) (int16 banks), a seed, no test; packed banks, the ternary
   read, the fused epilogue, engine "cuda"; (b) each net's Solver on the
   card and on the CPU (its draws made on the card, the same bits) at a
   small batch (AlexNet and CaffeNet 4, GoogLeNet and ResNet-50 2): params
   and banks equal at init, one step from one state, batch and key:
   losses within 1e-4 relative, banks equal but for cells on exact-0
   writes (checked, counted), launches a step B2a 3/3/5/1 (the
   InnerProduct fault targets), B1a 1, B4 3/3/13/1 (the MAX pools); (c)
   each net's Solver at its published batch (256, 256, 32, 32; crop 227,
   227, 224, 224, mirror): a warm and 3 timed steps (median, host clock,
   synchronized, the host feed included), the feed's ms a batch, peak
   memory, the launches of (b) a step, then 5 steps through a
   prefetching feed at each GIL switch interval of 5 and 1 ms; (d)
   AlexNet's sweep
   at C = 4, batch 256 (its own raw host feed): each lane against a single-config Solver
   from its state (loss within 1e-5 relative, banks equal but for
   exact-0 writes), a warm and 3 timed steps (configs x steps per
   second, step times by CUDA events, peak memory beside its reckoning
   from the blob shapes), B2b 3, B1b 1, B4 3 a step, then blocks of 2
   against the unblocked runner from one seed and one feed position:
   banks bit for bit, losses within 1e-5; (e) generated_net (random
   DummyData data drawn per lane from the forward key) at C = 8, as
   phase 24 (b)'s lane checks; (f) Dropout's masks (AlexNet's drop6 at
   (256, 4096), alone and over 4 lanes of a laned and of a shared
   bottom) and generated_net's DummyData draws over 4 lanes: card equal
   to CPU bit for bit;
26. the data sources (ImageData, WindowData, the Python layer, LevelDB,
   a Solver's prefetching feed), under RRAM_POOL_BWD=cuda: (a)
   stand-ins from a seed, written by the port's own writers into a
   temporary directory: 64 PNGs of 224-288 pixels a side with train and
   test lists (flickr_style's data/flickr_style/*.txt), 16 PNGs at
   3x375x500 with 24 windows each, half of them foreground (the PASCAL
   window files), a 1x3x256x256 mean .binaryproto
   (data/ilsvrc12/imagenet_mean.binaryproto), and 64 Datums as a
   LevelDB and as an LMDB; (b) flickr_style
   (models/finetune_flickr_style/solver.prototxt, ImageData), pascal's
   finetune net (examples/finetune_pascal_detection/
   pascal_finetune_solver.prototxt, WindowData) and
   examples/pycaffe/linreg.prototxt (the Python layer, pyloss.py) at
   batch 4, faults on the InnerProduct layers at N(300, 50), packed
   banks, the ternary read, the fused epilogue, engine "cuda": the card's
   Solver (its batch from its own feed) against the CPU's
   (its draws made on the card), one step from one state, batch and
   key: losses within 1e-5 relative, banks equal but for cells on
   exact-0 writes, launches a step B2a 3, B1a 1, B4 3 (linreg B2a 2,
   B1a 1); (c) flickr_style at batch 50 and pascal at batch 128, the
   Solver built with `prefetch`: a warm and 3 timed steps (median, host clock,
   synchronized), the launches a step, peak memory; then one step from
   one state through the prefetching feed (profiled: the device busy
   ms) and, its producer stopped, through a raw feed at the same
   position: the batch, every state leaf and the loss bit for bit, that
   step and 2 more through the raw feed and the raw feed's ms a batch
   timed; flickr_style's
   Solver.test over 2 batches of its TEST ImageData layer; (d) a
   LEVELDB Data layer's prefetched batches on the card equal to the
   LMDB's of the same records past a wrap, and its Solver's two steps
   (B2a 1, B1a 1 a step).

Then a JSON line of the step's numbers, a JSON line of the sweep's, one
JSON line of per-kernel numbers (per training step, summed over the
step's launches; B1b, B2b and B4 at the sweep's shapes, B2t and B3a at
the tiled slice's, B3b at the tiled sweep's, B1 also at the tiled
sweep's ten leaves; the B1 rows carry `path_ms` through the solver's
tail and `copy_ms`, a device copy of the same bytes; the B2 and B2t rows also
carry `path_ms`, the reads through the wrapper from operands laid out as
the InnerProduct layer hands them over, and its bound `path_bound_ms`; the
B3 rows the same from the Convolution layer's layouts; the B4 row its
backward through the pooling layer's autograd.Function), a JSON line of
B3's passes by device activity at C = 1 and the tiled sweep's C, a JSON
line "rng" of phase 13's numbers, a JSON line "formats" of phase 14's,
a JSON line "solver_rest" of phase 15's (printed when it ends), a JSON
line "vgg11" of phase 16's (printed when it ends, and again), a JSON
line "telemetry" of phase 17's, a JSON line "blocks" of phase 18's, a
JSON line "healing" of phase 19's, a JSON line "virtual_time" of phase
20's, a JSON line "driver" of phase 21's, a JSON line "processes" of
phase 22's, a JSON line "harness" of phase 23's, a JSON line "nets" of
phase 24's, a JSON line "zoo" of phase 25's, a JSON line
"data_sources" of phase 26's, the card's name and power limit,
and last {"ok": true, "device":
{...}}.
B2t has a row at each path's shapes: C = 1 (the tiled slice) and C
lanes (the tiled sweep). Phase 12 prints its numbers as a JSON line
"strategies" when it ends.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import subprocess
import sys
import time
import types
import warnings
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
PKG = "rram_caffe_simulation_tpu_torch"
SOLVER = "models/cifar10_quick/cifar10_quick_lmdb_solver.prototxt"
TILES = "cells=128x128"          # the smallest realistic array size
HBM_BYTES_PER_S = 3.35e12        # H100 SXM data sheet
F32_FLOP_PER_S = 67e12           # f32 outside the tensor cores
U32 = 2.0 ** -24                 # f32 unit roundoff


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return out[0].strip()


class Check(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise Check(msg)


# ---------------------------------------------------------------------------
# timing

def event_ms(fn, iters=100, warmup=10):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    for _ in range(iters):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / iters


def device_ms_by_name(fn, iters=50, attempts=3):
    """Kernel time on the card per call by device activity (CUPTI through
    torch.profiler): name -> (its mean duration times its launches a
    call, that is its count over `iters` rounded up, in ms; its count),
    so the events a window loses do not pull the time down. A window that
    comes back with no device activity at all (the profiler drops one
    now and then) is taken again, up to `attempts` windows."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    by_name = {}
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        for ev in prof.events():
            if ev.device_type == DeviceType.CUDA:
                by_name.setdefault(ev.name, []).append(
                    ev.time_range.elapsed_us())
        if by_name:
            break
    return {name: (sum(d) / len(d) * math.ceil(len(d) / iters) / 1e3,
                   len(d)) for name, d in by_name.items()}


def device_ms(fn, iters=50, count=None):
    """Kernel time on the card per call, `device_ms_by_name` summed over
    the activities; None if the profiler saw no device activity. With
    `count`, also the number of device activities whose name holds it."""
    by_name = device_ms_by_name(fn, iters)
    ms = sum(v[0] for v in by_name.values()) or None
    return ms if count is None else (ms, sum(
        n for name, (_, n) in by_name.items() if count in name))


def device_activity_names(fn, iters=5):
    """Names of the device activities (kernels, memsets, copies) of
    `iters` calls of fn, by the profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {ev.name for ev in prof.events()
            if ev.device_type == DeviceType.CUDA}


def timed(fn, iters=100):
    """(device ms, host-inclusive ms): the first, when the profiler
    works, is the kernel's own time; the second is the stream time per
    call with the Python launch path in it."""
    ev = event_ms(fn, iters=iters, warmup=max(1, iters // 10))
    dev = device_ms(fn, iters=max(2, iters // 2))
    return (dev if dev is not None else ev), ev


# ---------------------------------------------------------------------------
# phase 2: B1

SLICE_LEAVES = {"ip1/0": (64, 1024), "ip1/1": (64,), "ip2/0": (10, 64),
                "ip2/1": (10,)}
# the tiled configuration's fault leaves (conv_also): conv1-3 too
TILED_LEAVES = {"conv1/0": (32, 3, 5, 5), "conv1/1": (32,),
                "conv2/0": (32, 32, 5, 5), "conv2/1": (32,),
                "conv3/0": (64, 32, 5, 5), "conv3/1": (64,), **SLICE_LEAVES}
B1_KERNELS = ("fused_update_fail_kernel",)     # B1's own device activity


def b1_inputs(shape, life_dtype, C, seed, device):
    import torch
    from rram_caffe_simulation_tpu_torch.fault import packed
    rng = np.random.RandomState(seed)
    full = ((C,) if C > 1 else ()) + tuple(shape)
    data = rng.randn(*full).astype(np.float32)
    upd = (rng.randn(*full) * 1e-3).astype(np.float32)
    sel = rng.rand(*full)
    upd[sel < 0.2] = 0.0
    upd[(sel >= 0.2) & (sel < 0.25)] = 1e-20
    upd[(sel >= 0.25) & (sel < 0.3)] = -9.99e-21
    lq = rng.randint(-3, 4, size=full).astype(life_dtype)
    bank = packed.pack_stuck(rng.choice([-1.0, 0.0, 1.0], size=full))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return t(data), t(upd), t(lq), t(bank)


def b1_group(shapes, life_dtype, C, seed, device):
    """A group's operands as four lists (data, upd, life_q, bank)."""
    leaves = [b1_inputs(s, life_dtype, C, seed + i, device)
              for i, s in enumerate(shapes)]
    return [[lf[j] for lf in leaves] for j in range(4)]


def _off_grid(t, offset):
    """A contiguous view of t's values starting `offset` elements into a
    larger buffer: off the 16-byte grid when offset % 4 != 0."""
    import torch
    buf = torch.empty(t.numel() + offset, dtype=t.dtype, device=t.device)
    view = buf[offset:].view(t.shape)
    view.copy_(t)
    return view


def b1_equal_plain(groups, mode, what):
    """B1's group call against the plain version leaf by leaf, bit for
    bit (the int32 view of data', and life_q')."""
    import torch
    from rram_caffe_simulation_tpu_torch.fault import fused
    kd, kq = fused.fused_update_fail_leaves(*groups, mode=mode)
    pd, pq = fused.fused_update_fail_leaves_plain(*groups, mode=mode)
    torch.cuda.synchronize()
    for i, (a, b, c, d) in enumerate(zip(kd, pd, kq, pq)):
        check(torch.equal(a.view(torch.int32), b.view(torch.int32))
              and torch.equal(c, d),
              f"B1 differs from its plain version: {what}, leaf {i} "
              f"{tuple(groups[0][i].shape)} mode={mode}")


def phase_b1(device):
    """B1 against its plain version: one leaf at a time (the slice's four
    leaves, C = 1 and 4) and as the step's groups (the untiled four and
    the tiled ten leaves, C = 1 and 4), int16 and int32 counters, every
    mode; a group with leaves off the 16-byte grid (scalar route); a
    group of 20 leaves (two launches)."""
    from rram_caffe_simulation_tpu_torch.fault import fused
    n = 0
    for shape in SLICE_LEAVES.values():
        for life_dtype in ("int16", "int32"):
            for C in (1, 4):
                args = [[a] for a in b1_inputs(shape, life_dtype, C, n,
                                               device)]
                for mode in fused.FUSED_MODES:
                    b1_equal_plain(args, mode, f"one leaf {life_dtype} "
                                               f"C={C}")
                    n += 1
    for name, leaves in (("untiled", SLICE_LEAVES), ("tiled", TILED_LEAVES)):
        for life_dtype in ("int16", "int32"):
            for C in (1, 4):
                groups = b1_group(leaves.values(), life_dtype, C, 50, device)
                for mode in fused.FUSED_MODES:
                    fused.FUSED_LIB.reset()
                    b1_equal_plain(groups, mode, f"{name} group "
                                                 f"{life_dtype} C={C}")
                    check(fused.FUSED_LIB.launches == 1,
                          f"the {name} group took "
                          f"{fused.FUSED_LIB.launches} launches, not 1")
                    n += 1
    for life_dtype in ("int16", "int32"):
        d, u, q, b = b1_group(TILED_LEAVES.values(), life_dtype, 4, 70,
                              device)
        # every operand of leaf 0 off the grid; only upd of leaf 2; only
        # the counters of leaf 6 (ip1's weight)
        d[0], u[0], q[0], b[0] = (_off_grid(t, 1) for t in
                                  (d[0], u[0], q[0], b[0]))
        u[2], q[6] = _off_grid(u[2], 3), _off_grid(q[6], 2)
        for mode in fused.FUSED_MODES:
            b1_equal_plain([d, u, q, b], mode, f"leaves off the 16-byte "
                                               f"grid {life_dtype}")
            n += 1
    groups = b1_group(list(TILED_LEAVES.values()) * 2, "int32", 2, 90,
                      device)
    fused.FUSED_LIB.reset()
    b1_equal_plain(groups, "write", "20 leaves")
    check(fused.FUSED_LIB.launches == 2, f"20 leaves took "
          f"{fused.FUSED_LIB.launches} launches, not 2 (16 a table)")
    n += 1
    print(f"phase 2: B1 bit-identical to its plain version in {n} cases "
          "(single leaves, the untiled and tiled groups in one launch each, "
          "leaves off the 16-byte grid, 20 leaves in two launches)",
          flush=True)
    return 0.0


def b1_inputs_dev(shape, C, seed, device):
    """B1 operands with a leading C axis, drawn on the card (the sweep's
    leaves are too large to draw on the host quickly); int32 banks."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    full = (C,) + tuple(shape)
    data = torch.randn(full, generator=g, device=device)
    upd = torch.randn(full, generator=g, device=device) * 1e-3
    lq = torch.randint(-3, 4, full, generator=g, device=device,
                       dtype=torch.int32)
    L = full[-1]
    bank = torch.randint(0, 256, full[:-1] + (-(-L // 4),), generator=g,
                         device=device, dtype=torch.uint8)
    return data, upd, lq, bank & 0x55          # codes 0/1 only: valid


def b1_step_operands(leaves, C, device):
    """The step's fault leaves as the solver's tail takes them: dicts of
    data, upd and the packed banks by key, int32 counters; drawn on the
    card where they have lanes or 1e7 cells (AlexNet's fc6-8: too many
    to draw on the host quickly)."""
    host = C == 1 and sum(math.prod(s) for s in leaves.values()) < 1e7
    ops = {k: (b1_inputs(s, "int32", 1, 100 + i, device) if host
               else b1_inputs_dev(s, C, 100 + i, device))
           for i, (k, s) in enumerate(leaves.items())}
    if C == 1 and not host:
        ops = {k: [t[0] for t in v] for k, v in ops.items()}
    data = {k: v[0] for k, v in ops.items()}
    upd = {k: v[1] for k, v in ops.items()}
    state = {"life_q": {k: v[2] for k, v in ops.items()},
             "stuck_bits": {k: v[3] for k, v in ops.items()}}
    return data, upd, state


def _b1_tail(keys):
    """The solver's fused tail as the checkout's solver runs it: one group
    call through `solver.fused_tail`, or (an older checkout) one wrapper
    call per leaf, as its step did."""
    from rram_caffe_simulation_tpu_torch.fault import fused
    from rram_caffe_simulation_tpu_torch.solver import solver
    if hasattr(solver, "fused_tail"):
        return lambda data, upd, state: solver.fused_tail(
            fused.fused_update_fail_leaves, keys, data, upd, state)

    def per_leaf(data, upd, state):
        data, life_q = dict(data), dict(state["life_q"])
        for k in keys:
            data[k], life_q[k] = fused.fused_update_fail(
                data[k], upd[k], life_q[k], state["stuck_bits"][k])
        return data, {**state, "life_q": life_q}
    return per_leaf


def b1_step_numbers(device, leaves, C=1):
    """Per-step B1 numbers at a step's fault leaves (`leaves`, each with
    C lanes; C = 1 without the lane axis), int32 counters: the kernel's
    device time a step (mean x launches by device activity over >= 10
    steps' calls) and by CUDA events, `path_ms` through the solver's tail
    (by device activity; B1's kernel must be the only device activity
    there), the plain version, a device copy of the
    same bytes (read and written once: the card's practical rate for
    this traffic), and the bound (bytes over 3.35 TB/s). The kernel must
    equal the plain version bit for bit on these inputs. An older
    checkout (no group wrapper) runs one launch per leaf, as its solver
    did."""
    import torch
    from rram_caffe_simulation_tpu_torch.fault import fused
    data, upd, state = b1_step_operands(leaves, C, device)
    keys = list(leaves)
    groups = ([data[k] for k in keys], [upd[k] for k in keys],
              [state["life_q"][k] for k in keys],
              [state["stuck_bits"][k] for k in keys])
    tail = _b1_tail(keys)
    if hasattr(fused, "fused_update_fail_leaves"):
        kernel = lambda: fused.fused_update_fail_leaves(*groups)
    else:
        kernel = lambda: [fused.fused_update_fail(*lf)
                          for lf in zip(*groups)]
    plain = lambda: [fused.fused_update_fail_plain(*lf)
                     for lf in zip(*groups)]
    nd, ns = tail(data, upd, state)
    err = 0.0
    for k in keys:
        pd, pq = fused.fused_update_fail_plain(
            data[k], upd[k], state["life_q"][k], state["stuck_bits"][k])
        check(torch.equal(nd[k].view(torch.int32), pd.view(torch.int32))
              and torch.equal(ns["life_q"][k], pq),
              f"B1 differs from its plain version at C={C} {k}")
        err = max(err, float((nd[k] - pd).abs().max()))
    del nd, ns, pd, pq
    fused.FUSED_LIB.reset()
    kernel()
    per_call = fused.FUSED_LIB.launches
    iters = 100 if C == 1 else 20
    ev = event_ms(kernel, iters=iters, warmup=max(1, iters // 10))
    by_name = device_ms_by_name(kernel, iters)
    ms = sum(v for v, _ in by_name.values())
    seen = sum(c for _, c in by_name.values())
    path = device_ms_by_name(lambda: tail(data, upd, state), iters)
    path_ms = sum(v for v, _ in path.values())
    other = sorted(nm for nm in path
                   if not any(own in nm for own in B1_KERNELS))
    p, _ = timed(plain, max(2, iters // 5))
    cells = sum(t.numel() for t in groups[0])
    nbytes = sum(t.numel() * t.element_size() for g in groups for t in g) \
        + sum(t.numel() * t.element_size() for g in (groups[0], groups[2])
              for t in g)
    src = torch.empty(-(-nbytes // 2), dtype=torch.uint8, device=device)
    dst = torch.empty_like(src)
    copy = event_ms(lambda: dst.copy_(src), iters=iters,
                    warmup=max(1, iters // 10))
    del src, dst
    b = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  B1 C={C} {len(keys)} leaves ({cells} cells, {nbytes} bytes): "
          f"kernel {ms:.5f} ms a step on the card ({per_call} launch(es) "
          f"a step; {seen} activities seen in {iters} steps' calls), "
          f"{ev:.5f} ms by CUDA events; path_ms {path_ms:.5f} through the "
          f"solver's tail (activities "
          f"{ {nm: c for nm, (_, c) in sorted(path.items())} }, other than "
          f"B1's own: {other}); plain {p:.5f} ms; a copy of the same bytes "
          f"{copy:.5f} ms ({nbytes / copy / 1e9:.3f} TB/s); bound {b:.6f} "
          f"ms ({b / ms:.1%} of the kernel's rate); bit-identical to the "
          f"plain version", flush=True)
    check(any(own in nm for nm in path for own in B1_KERNELS),
          f"the profiler did not see B1 among {sorted(path)}")
    check(not other, f"B1's path launched device activity that is not its "
          f"own kernel: {other}")
    return {"ms": ms, "plain_ms": p, "bound_ms": b, "bound_by": "bytes",
            "library_ms": None, "event_ms": ev, "path_ms": path_ms,
            "copy_ms": copy, "launches_per_step": per_call,
            "activities_seen": seen, "calls": iters}, err


def b1_windows(device, leaves, C, windows=5, iters=10):
    """B1's per-step time in `windows` profiled windows of `iters` steps'
    calls each, read two ways: the sum of the window's events over
    `iters` (the reading before the mean-times-launches method) and mean
    x launches, with the events each window saw against the launches it
    made."""
    from rram_caffe_simulation_tpu_torch.fault import fused
    data, upd, state = b1_step_operands(leaves, C, device)
    tail = _b1_tail(list(leaves))
    fn = lambda: tail(data, upd, state)
    fused.FUSED_LIB.reset()
    fn()
    per_call = fused.FUSED_LIB.launches
    out = []
    for _ in range(windows):
        by_name = device_ms_by_name(fn, iters, attempts=1)
        seen = sum(c for _, c in by_name.values())
        mean_x = sum(v for v, _ in by_name.values())
        summed = sum(v / math.ceil(c / iters) * c / iters
                     for v, c in by_name.values())
        out.append({"sum_over_calls_ms": summed, "mean_x_launches_ms": mean_x,
                    "seen": seen, "launched": per_call * iters})
    print(f"  B1 C={C} profiler windows of {iters} steps: "
          + "; ".join(f"{w['sum_over_calls_ms']:.5f} / "
                      f"{w['mean_x_launches_ms']:.5f} ms, {w['seen']} of "
                      f"{w['launched']} seen" for w in out), flush=True)
    return out


def b1_path_numbers(device):
    """`--b1-path`: B1 at the untiled sweep's four leaves (C = 512), the
    tiled sweep's ten (C = 64) and both at C = 1: through the solver's
    tail, alone, and beside a copy of the same bytes; then profiler
    windows of 10 steps at C = 512."""
    res = {}
    for name, leaves, C in (("untiled", SLICE_LEAVES, SWEEP_CONFIGS),
                            ("tiled", TILED_LEAVES, TILED_SWEEP_CONFIGS),
                            ("untiled", SLICE_LEAVES, 1),
                            ("tiled", TILED_LEAVES, 1)):
        res[f"{name} C={C}"], _ = b1_step_numbers(device, leaves, C)
    res[f"windows C={SWEEP_CONFIGS}"] = b1_windows(device, SLICE_LEAVES,
                                                 SWEEP_CONFIGS)
    return res


# ---------------------------------------------------------------------------
# phase 3: B2

B2_SHAPES = {"ip1": (100, 1024, 64), "ip2": (100, 64, 10)}


def b2_inputs(M, K, N, C, x_batched, seed, device):
    import torch
    rng = np.random.RandomState(seed)
    xs = (C, M, K) if x_batched else (M, K)
    x = rng.randn(*xs).astype(np.float32)
    w = (rng.randn(C, K, N) * 0.1).astype(np.float32)
    broken = (rng.rand(C, K, N) < 0.1).astype(np.float32)
    stuck = rng.choice([-1.0, 0.0, 1.0], size=(C, K, N)).astype(np.float32)
    eps = rng.randn(C, K, N).astype(np.float32)
    seeds = rng.randint(0, 2 ** 31 - 1, size=C).astype(np.int32)
    t = lambda a: torch.from_numpy(a).to(device)
    return t(x), t(w), t(broken), t(stuck), t(seeds), t(eps)


def b2_bound(x, w):
    """|y| error bound of an f32 dot of length K summed in any order."""
    import torch
    K = w.shape[1]
    return K * U32 * torch.matmul(x.abs(), w.abs()) + 1e-30


B2_RAGGED = ((1, 7, 3), (5, 18, 7), (100, 1000, 10), (130, 257, 65))


def b2_layouts(x, w, br, st, eps):
    """The same operand values in every storage layout the B2 wrapper
    takes, as name -> (x, w, broken, stuck, eps) views; broken is bool
    in all of them."""
    import torch

    def turned(t):      # Caffe's stored (C, num_output, K), viewed (C, K, N)
        return t.transpose(1, 2).contiguous().transpose(1, 2)

    def folded(t):      # a laned activation's (M, C, K), viewed (C, M, K)
        return (t.transpose(0, 1).contiguous().transpose(0, 1)
                if t.dim() == 3 else t)

    def padded(t):      # rows and base off the 16-byte grid: scalar loads
        big = torch.zeros(t.shape[:-1] + (t.shape[-1] + 3,), dtype=t.dtype,
                          device=t.device)
        big[..., 1:-2] = t
        return big[..., 1:-2]

    bb = br > 0
    return {
        "dense, broken bool": (x, w, bb, st, eps),
        "stored (C, N, K) turned, x folded (M, C, K)":
            (folded(x), turned(w), turned(bb), turned(st), turned(eps)),
        "unaligned rows": tuple(padded(t) for t in (x, w, bb, st, eps)),
        "mixed (w, eps turned; broken uint8)":
            (x, turned(w), bb.to(torch.uint8), st, turned(eps)),
    }


def phase_b2(device):
    """B2 against its plain version within the f32 summation bound at the
    path's and at ragged shapes; every storage layout against the dense
    f32 call, the fused scale against w.abs().amax and a second call
    against the first, all bit for bit."""
    import torch
    from rram_caffe_simulation_tpu_torch.fault import hw_aware as hw
    worst = 0.0
    n = n_layout = 0
    for (M, K, N) in tuple(B2_SHAPES.values()) + B2_RAGGED:
        for C, xb in ((1, False), (4, False), (4, True)):
            x, w, br, st, seeds, eps = b2_inputs(M, K, N, C, xb, n, device)
            amax = w.abs().amax(dim=(1, 2))
            layouts = b2_layouts(x, w, br, st, eps)
            for q_bits in (0, 2, 8):
                for sigma, e in ((0.0, None), (0.05, eps)):
                    where = (f"M,K,N={M},{K},{N} C={C} x_batched={xb} "
                             f"q_bits={q_bits} sigma={sigma}")
                    yk = hw.crossbar_forward(x, w, br, st, seeds, sigma,
                                             q_bits, eps=e)
                    yp = hw.crossbar_forward_plain(x, w, br, st, seeds,
                                                   sigma, q_bits, eps=e)
                    w_eff = hw.effective_weight_plain(
                        w, br, st, sigma, e, hw.q_levels(q_bits), amax)
                    err = (yk - yp).abs()
                    ok = bool((err <= b2_bound(x, w_eff)).all())
                    worst = max(worst, float(err.max()))
                    check(ok, f"B2 out of bound: {where}: max err "
                              f"{float(err.max())}")
                    n += 1
                    for name, (lx, lw, lb, ls, le) in layouts.items():
                        for _ in range(2):      # the second call: same bits
                            y, scale = hw.crossbar_forward_scaled(
                                lx, lw, lb, ls, seeds, sigma, q_bits,
                                eps=le if e is not None else None)
                            check(torch.equal(y, yk), f"B2 on layout "
                                  f"'{name}' differs from the dense f32 "
                                  f"call: {where}")
                            check((scale is None) if not q_bits else
                                  torch.equal(scale, amax), f"B2's fused "
                                  f"scale != w.abs().amax: '{name}' {where}")
                        n_layout += 1
    print(f"phase 3: B2 within the f32 summation bound in {n} cases (the "
          f"path's shapes and ragged {B2_RAGGED}), max abs err {worst:.3e}; "
          f"{n_layout} layout cases (dense, stored and turned, unaligned, "
          f"mixed; broken bool or uint8) equal to the dense f32 call bit for "
          f"bit, twice each, fused scale equal to w.abs().amax", flush=True)
    phase_noise(device)
    return worst


def phase_noise(device):
    import torch
    from rram_caffe_simulation_tpu_torch.fault import hw_aware as hw
    K = N = 256
    C, sigma = 4, 0.05
    x = torch.eye(K, device=device)
    w = torch.ones((C, K, N), device=device)
    zero = torch.zeros_like(w)
    seeds = torch.tensor([11, 12, 977, 2 ** 31 - 2], dtype=torch.int32,
                         device=device)

    def draw(s):
        y = hw.crossbar_forward(x, w, zero, zero, s, sigma, 0)
        return (y - 1.0) / sigma

    e1, e2 = draw(seeds), draw(seeds)
    check(torch.equal(e1, e2), "in-kernel noise not reproducible from seed")
    flat = e1.reshape(C, -1).double()
    mean, std = flat.mean(dim=1), flat.std(dim=1)
    check(bool((mean.abs() < 0.02).all()) and
          bool(((std - 1).abs() < 0.02).all()),
          f"noise moments off: mean {mean.tolist()} std {std.tolist()}")
    r = torch.corrcoef(flat)
    off = (r - torch.eye(C, device=device, dtype=r.dtype)).abs().max()
    check(float(off) < 0.02, f"lanes correlated: max |r| {float(off)}")
    twin = hw.philox_normal(seeds, K, N, device)
    check(float((e1 - twin).abs().max()) < 1e-3,
          "in-kernel noise disagrees with its tensor-op twin")
    # the counter is the flat index of the (K, N) view, whatever the
    # storage: every layout draws the same noise (ragged K, N too)
    Kr, Nr = 70, 19
    xr = torch.eye(Kr, device=device)
    wr = torch.ones((C, Kr, Nr), device=device)
    zr = torch.zeros_like(wr)
    dense = hw.crossbar_forward(xr, wr, zr, zr, seeds, sigma, 0)
    for name, (lx, lw, lb, ls, _) in b2_layouts(xr, wr, zr, zr, zr).items():
        check(torch.equal(hw.crossbar_forward(lx, lw, lb, ls, seeds, sigma,
                                              0), dense),
              f"in-kernel noise depends on the storage layout: '{name}'")
    check(float(((dense - 1.0) / sigma - hw.philox_normal(
        seeds, Kr, Nr, device)).abs().max()) < 1e-3,
        "in-kernel noise at a ragged shape disagrees with philox_normal")
    print(f"phase 3: in-kernel noise over {K * N} cells/lane: mean "
          f"{[round(v, 4) for v in mean.tolist()]}, std "
          f"{[round(v, 4) for v in std.tolist()]}, max |r| between "
          f"lanes/seeds {float(off):.4f}, max |eps - twin| "
          f"{float((e1 - twin).abs().max()):.2e}", flush=True)


def b2_inputs_dev(M, K, N, C, seed, device):
    """B2 operands of the sweep (x per lane), drawn on the card."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((C, M, K), generator=g, device=device)
    w = torch.randn((C, K, N), generator=g, device=device) * 0.1
    broken = torch.rand((C, K, N), generator=g, device=device) < 0.1
    stuck = torch.randint(-1, 2, (C, K, N), generator=g,
                          device=device).float()
    seeds = torch.randint(0, 2 ** 31 - 1, (C,), generator=g, device=device,
                          dtype=torch.int32)
    return x, w, broken, stuck, seeds


def b2_step_numbers(device, C=1, shapes=None, q_bits=2, sigma=0.0):
    """Per-step B2 numbers at the two InnerProduct reads (ternary grid,
    sigma 0, as on the path; `shapes` {layer: (M, K, N)}, `q_bits` and
    `sigma` for another path's reads, the plain version's Philox twin
    then within 2e-3 * sigma of the kernel's draw on every weight, as
    phase 3 holds it): one config with x shared (C = 1), or the
    sweep's C lanes with x per lane, one launch per layer, on dense
    (C, K, N) operands with broken as bool (one byte a cell, as the
    solver derives it). The library call is torch.matmul (torch.bmm over
    the lanes) of x and w_eff. Also the largest |kernel - plain|, each
    case within its bound."""
    import torch
    from rram_caffe_simulation_tpu_torch.fault import hw_aware as hw
    ms = plain = bound = lib = 0.0
    err = 0.0
    bound_by = "bytes"
    iters = 100 if C == 1 else 20
    for i, (M, K, N) in enumerate((shapes or B2_SHAPES).values()):
        if C == 1:
            x, w, br, st, seeds, _ = b2_inputs(M, K, N, 1, False, 200 + i,
                                               device)
        else:
            x, w, br, st, seeds = b2_inputs_dev(M, K, N, C, 200 + i, device)
        br = br > 0
        w_eff = hw.effective_weight_plain(w, br, st, 0.0, None,
                                          hw.q_levels(q_bits),
                                          w.abs().amax(dim=(1, 2)))
        yk = hw.crossbar_forward(x, w, br, st, seeds, sigma, q_bits)
        yp = hw.crossbar_forward_plain(x, w, br, st, seeds, sigma, q_bits)
        e = (yk - yp).abs()
        slack = (x.abs() @ w_eff.abs()) * (2e-3 * sigma) if sigma else 0.0
        check(bool((e <= b2_bound(x, w_eff) + slack).all()),
              f"B2 out of bound at C={C} M,K,N={M},{K},{N}")
        err = max(err, float(e.max()))
        del yk, yp, e
        if C == 1:
            w_eff = w_eff[0]
            lib_fn = lambda: torch.matmul(x, w_eff)
        else:
            lib_fn = lambda: torch.bmm(x, w_eff)
        k, k_call = timed(lambda: hw.crossbar_forward(x, w, br, st, seeds,
                                                      sigma, q_bits), iters)
        p, _ = timed(lambda: hw.crossbar_forward_plain(x, w, br, st, seeds,
                                                       sigma, q_bits),
                     max(2, iters // 5))
        lb, _ = timed(lib_fn, iters)
        nbytes = 4 * x.numel() + 9 * C * K * N + 4 * C * M * N
        flops = 2 * C * M * K * N
        tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
        print(f"  B2 C={C} M,K,N={M},{K},{N}: kernel {k:.5f} ms ({k_call:.5f}"
              f" ms per wrapper call), plain {p:.5f} ms, "
              f"{'torch.matmul' if C == 1 else 'torch.bmm'} {lb:.5f} ms, "
              f"bound {max(tb, tf):.6f} ms (bytes {nbytes}: {tb:.6f}; flop "
              f"{flops}: {tf:.6f})", flush=True)
        if tf > tb and i == 0:
            bound_by = "operations"
        ms, plain, bound, lib = ms + k, plain + p, bound + max(tb, tf), \
            lib + lb
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": lib}, err


B2_PATH_KERNELS = ("crossbar_kernel", "lane_absmax_kernel", "Memset",
                   "Memcpy HtoD")
B2T_PATH_KERNELS = B2_PATH_KERNELS + ("adc_sum_kernel",)   # its second pass


def b2_path_numbers(device, C=1, own_kernels_only=True):
    """`path_ms`: the device time of one step's two crossbar reads through
    `crossbar_matmul` (C = 1) or `crossbar_matmul_lanes`, wrapper passes
    included, from operands laid out as ops/common.py hands them over:
    the weight, the bool broken mask and the stuck values in Caffe's
    stored (C, num_output, K), turned by view; x (M, K), or under lanes
    the (M, C, K) view of the folded (M, C*K) activation. Its bound
    counts the bytes as stored (broken one byte a cell). With
    `own_kernels_only` every device activity of the reads must be B2's
    own (its passes, its memset, the seed's host-to-card copy): no copy,
    cast or amax kernel of the wrapper."""
    import torch
    from rram_caffe_simulation_tpu_torch.fault import hw_aware as hw
    ms = bound = 0.0
    names = set()
    iters = 100 if C == 1 else 20
    for i, (M, K, N) in enumerate(B2_SHAPES.values()):
        g = torch.Generator(device=device).manual_seed(250 + i)
        w = torch.randn((C, N, K), generator=g, device=device) * 0.1
        broken = torch.rand((C, N, K), generator=g, device=device) < 0.1
        stuck = torch.randint(-1, 2, (C, N, K), generator=g,
                              device=device).float()
        if C == 1:
            x = torch.randn((M, K), generator=g, device=device)
            fn = lambda: hw.crossbar_matmul(x, w[0].t(), broken[0].t(),
                                            stuck[0].t(), 7, 0.0, 2)
        else:
            xf = torch.randn((M, C * K), generator=g, device=device)
            x = xf.reshape(M, C, K).transpose(0, 1)
            seeds = torch.arange(C, dtype=torch.int32, device=device)
            fn = lambda: hw.crossbar_matmul_lanes(
                x, w.transpose(1, 2), broken.transpose(1, 2),
                stuck.transpose(1, 2), seeds, 0.0, 2)
        with torch.no_grad():
            y = fn()
            yp = hw.crossbar_forward_plain(
                x, w.transpose(1, 2), broken.transpose(1, 2),
                stuck.transpose(1, 2), torch.zeros(C, dtype=torch.int32,
                                                   device=device), 0.0, 2)
            w_eff = hw._lane_w_eff(w.transpose(1, 2), broken.transpose(1, 2),
                                   stuck.transpose(1, 2), None, 0.0, 2, None)
            check(bool(((y - (yp[0] if C == 1 else yp)).abs()
                        <= b2_bound(x, w_eff)).all()),
                  f"B2 on the path's layout out of bound at C={C} "
                  f"M,K,N={M},{K},{N}")
            del y, yp, w_eff
            k, _ = timed(fn, iters)
            seen = device_activity_names(fn, 20)
            if not seen:        # a short window can come back empty
                seen = device_activity_names(fn, 200)
        check(any("crossbar_kernel" in n for n in seen),
              f"the profiler did not see B2 among {sorted(seen)}")
        names |= seen
        nbytes = 4 * x.numel() + 9 * C * K * N + 4 * C * M * N
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        tf = 2 * C * M * K * N / F32_FLOP_PER_S * 1e3
        print(f"  B2 path C={C} M,K,N={M},{K},{N}: {k:.5f} ms on the card a "
              f"read, wrapper passes included; bound {max(tb, tf):.6f} ms "
              f"(bytes as stored {nbytes})", flush=True)
        ms, bound = ms + k, bound + max(tb, tf)
    foreign = sorted(n for n in names
                     if not any(own in n for own in B2_PATH_KERNELS))
    print(f"  B2 path C={C}: device activities of a read: {sorted(names)}",
          flush=True)
    if own_kernels_only:
        check(not foreign, f"the B2 wrapper launched kernels that are not "
              f"its own on the path's layout: {foreign}")
    return {"path_ms": ms, "path_bound_ms": bound}


def b2t_path_numbers(device, C=1, own_kernels_only=True):
    """B2t's `path_ms`: the device time of one step's tiled ip1 read
    through `crossbar_matmul` (C = 1) or `crossbar_matmul_lanes` with
    ip1's tiles, wrapper passes included, from operands laid out as
    ops/common.py hands them over (as in `b2_path_numbers`). Its bound
    counts the bytes as stored (broken one byte a cell). With
    `own_kernels_only` every device activity of the read must be B2t's
    own (the scale and GEMM passes of crossbar.cu's core, the two-pass
    pass's adc_sum_kernel, its memset, the seed's host-to-card copy): no
    copy, cast or amax kernel of the wrapper. Also
    runs on an older checkout of the package (copy this script beside
    it), for the before numbers."""
    import torch
    from rram_caffe_simulation_tpu_torch.fault import hw_aware as hw
    M, K, N = B2_SHAPES["ip1"]
    tiles = TILED_CASES["ip1"][4]
    g = torch.Generator(device=device).manual_seed(260)
    w = torch.randn((C, N, K), generator=g, device=device) * 0.1
    broken = torch.rand((C, N, K), generator=g, device=device) < 0.1
    stuck = torch.randint(-1, 2, (C, N, K), generator=g,
                          device=device).float()
    seeds = torch.arange(C, dtype=torch.int32, device=device)
    wv, bv, sv = (t.transpose(1, 2) for t in (w, broken, stuck))
    if C == 1:
        x = torch.randn((M, K), generator=g, device=device)
        fn = lambda: hw.crossbar_matmul(x, wv[0], bv[0], sv[0], 0, 0.0, 2,
                                        tiles=tiles)[None]
    else:
        xf = torch.randn((M, C * K), generator=g, device=device)
        x = xf.reshape(M, C, K).transpose(0, 1)
        fn = lambda: hw.crossbar_matmul_lanes(x, wv, bv, sv, seeds, 0.0, 2,
                                              tiles=tiles)
    iters = 100 if C == 1 else 20
    with torch.no_grad():
        y = fn()
        yp = hw.crossbar_forward_plain(x, wv, bv, sv, seeds, 0.0, 2,
                                       tiles=tiles)
        same, share, e_max = exact_gap(y, yp)
        check(same, f"B2t on the path's layout differs from plain at "
              f"C={C} (share {share:.2e}, max err {e_max})")
        del y, yp
        k, _ = timed(fn, iters)
        seen = device_activity_names(fn, 20)
        if not seen:        # a short window can come back empty
            seen = device_activity_names(fn, 200)
    foreign = sorted(n for n in seen
                     if not any(own in n for own in B2T_PATH_KERNELS))
    nbytes = 4 * x.numel() + 9 * C * K * N + 4 * C * M * N
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    tf = 2 * C * M * K * N / F32_FLOP_PER_S * 1e3
    print(f"  B2t path C={C} M,K,N={M},{K},{N} tiles {tiles}: {k:.5f} ms on "
          f"the card a read, wrapper passes included; bound "
          f"{max(tb, tf):.6f} ms (bytes as stored {nbytes}); device "
          f"activities {sorted(seen)}", flush=True)
    if own_kernels_only:
        check(any("crossbar_kernel" in n for n in seen),
              f"the profiler did not see B2t among {sorted(seen)}")
        check(not foreign, f"the B2t wrapper launched kernels that are not "
              f"its own on the path's layout: {foreign}")
    return {"path_ms": k, "path_bound_ms": max(tb, tf)}


# ---------------------------------------------------------------------------
# phases 4 and 5: the solver

def slice_solver(mean, std, sigma=0.0, hw_engine="cuda", seed=1,
                 tiled=False, conv_im2col="implicit", strategies=(),
                 device="cuda", fields=None, fault_process=None):
    """The slice's solver; `tiled` adds conv_also and rram_forward {
    adc_bits: 8 tiles: "cells=128x128" } with the conv operand mode;
    `strategies` are failure_strategy entries as dicts of their
    fields; `fields` other SolverParameter fields (type, iter_size,
    clip_gradients, ...); `fault_process` a fault-process spec (the
    fused epilogue then engages where the stack fuses)."""
    from rram_caffe_simulation_tpu_torch import proto
    from rram_caffe_simulation_tpu_torch.solver import Solver
    from rram_caffe_simulation_tpu_torch.utils.io import read_solver_param
    sp = read_solver_param(SOLVER)
    for strategy in strategies:
        entry = proto.Message("FailureStrategyParameter")
        for name, value in strategy.items():
            setattr(entry, name, value)
        sp.failure_strategy.append(entry)
    for name, value in (fields or {}).items():
        setattr(sp, name, value)
    sp.display = 0
    sp.test_interval = 0        # phases time training steps; 12 tests apart
    sp.random_seed = seed
    sp.failure_pattern.type = "gaussian"
    sp.failure_pattern.mean = mean
    sp.failure_pattern.std = std
    if sigma:
        sp.rram_forward.sigma = sigma
    kw = {}
    if tiled:
        sp.failure_pattern.conv_also = True
        sp.rram_forward.adc_bits = 8
        sp.rram_forward.tiles = TILES
        kw["conv_im2col"] = conv_im2col
    if fault_process is not None:
        kw["fault_process"] = fault_process
    return Solver(sp, device=device, hw_engine=hw_engine,
                  dtype_policy="ternary", fault_format="packed",
                  fused_epilogue=True if fault_process is None else None,
                  **kw)


def phase_slice(steps, gpu):
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.fault import fused, hw_aware
    s = slice_solver(1e8, 3e7)
    check(s.pack_spec["life_dtype"] == "int32", "1e8 banks must be int32")
    warm = min(2, steps - 1)
    kernels.reset_launches()
    losses, times = [], []
    for i in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.step(1)               # ends in a host read of the loss: synced
        times.append(time.perf_counter() - t0)
        losses.append(s.last_loss)
    b2, b1 = hw_aware.CROSSBAR_LIB.launches, fused.FUSED_LIB.launches
    losses = [float(v) for v in losses]
    q1, dt, q3 = (float(v) for v in np.percentile(times[warm:],
                                                  [25, 50, 75]))
    print(f"phase 4: CIFAR-10-quick batch 100, ternary, packed int32 banks, "
          f"fused epilogue, cuda engine: {steps} steps, losses "
          f"{[round(v, 5) for v in losses]}", flush=True)
    print(f"phase 4: step time median {dt * 1e3:.3f} ms (quartiles "
          f"{q1 * 1e3:.3f} / {q3 * 1e3:.3f} ms, n = {steps - warm} after "
          f"{warm} warm-up steps; {gpu}); launches B2 {b2}, B1 {b1}",
          flush=True)
    check(all(math.isfinite(v) for v in losses), "non-finite loss")
    check(abs(losses[0] - math.log(10)) < 0.05,
          f"first loss {losses[0]} far from ln(10) at a near-zero init")
    check(b2 == 2 * steps, f"B2 launched {b2} times, expected {2 * steps}")
    check(b1 == steps, f"B1 launched {b1} times, expected {steps}")
    launches = {"B2": b2, "B1": b1}
    breakdown = step_breakdown(s)
    print(f"phase 4: where a step's {dt * 1e3:.3f} ms go: host feed (LMDB "
          f"read + Datum decode + mean, numpy) {breakdown['feed_ms']:.3f} "
          f"ms; kernels on the card {breakdown['device_busy_ms']:.3f} ms "
          f"({breakdown['device_busy_ms'] / (dt * 1e3):.1%} busy); top "
          f"device kernels: {breakdown['top']}", flush=True)
    breakdown["prefetch_step_ms"] = prefetch_steps(s, PREFETCH_STEPS_P4)
    print(f"phase 4: {PREFETCH_STEPS_P4} steps each through a prefetching "
          f"feed, median ms by GIL switch interval: "
          f"{json.dumps(breakdown['prefetch_step_ms'])} (the raw feed's "
          f"{dt * 1e3:.3f} ms above)", flush=True)

    s2 = slice_solver(1e8, 3e7, sigma=0.05, seed=2)
    kernels.reset_launches()
    s2.step(3)
    torch.cuda.synchronize()
    check(hw_aware.CROSSBAR_LIB.launches == 6 and
          fused.FUSED_LIB.launches == 3 and
          math.isfinite(s2.smoothed_loss),
          "sigma = 0.05 run did not go through the kernels")
    print(f"phase 4: sigma 0.05 run, 3 steps, loss {s2.smoothed_loss:.5f}, "
          "launches B2 6, B1 3", flush=True)
    return launches, dt, breakdown


def device_kernels(prof, steps):
    """(busy ms per step, {kernel name: ms per step}) of a profile: the
    device's activity records, each counted once, busy time as the union
    of their intervals (so nothing overlapping counts twice)."""
    from torch.autograd import DeviceType
    seen, spans, by_name = set(), [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        key = (ev.name, ev.time_range.start, ev.time_range.end)
        if key in seen:
            continue
        seen.add(key)
        spans.append((ev.time_range.start, ev.time_range.end))
        by_name[ev.name] = by_name.get(ev.name, 0.0) + \
            ev.time_range.elapsed_us() / 1e3 / steps
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / 1e3 / steps, by_name


def step_breakdown(s, steps=5):
    """Host feed time per batch, and the device's kernel time per step
    (torch.profiler/CUPTI) with the five largest kernels by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    for _ in range(10):
        s.train_feed()
    feed_ms = (time.perf_counter() - t0) / 10 * 1e3
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s.step(steps)
        torch.cuda.synchronize()
    busy, by_name = device_kernels(prof, steps)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"feed_ms": feed_ms, "device_busy_ms": busy,
            "top": "; ".join(f"{n[:60]} {ms:.4f} ms" for n, ms in top)}


PREFETCH_STEPS_P4 = 10          # phase 4's steps a prefetching block
SWITCH_INTERVALS = (0.005, 0.001)   # s; Python's default first


def prefetch_steps(s, n):
    """The median ms of `n` Solver steps of `s` (host clock,
    synchronized) through a prefetching feed over its net, one block at
    each GIL switch interval of SWITCH_INTERVALS (sys.setswitchinterval),
    after one warm step that starts the producer. The producer is closed
    after them and `s` keeps its own (raw) feed. The batches start at the
    source's first record: these steps time the feed, their training is
    not checked."""
    import torch
    from rram_caffe_simulation_tpu_torch.data.feed import build_feed
    own, interval = s.train_feed, sys.getswitchinterval()
    s.train_feed = build_feed(s.net, device=s.device)
    out = {}
    try:
        s.step(1)
        for si in SWITCH_INTERVALS:
            sys.setswitchinterval(si)
            times = []
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                s.step(1)
                times.append((time.perf_counter() - t0) * 1e3)
            out[f"{si * 1e3:g}ms"] = float(np.median(times))
    finally:
        sys.setswitchinterval(interval)
        s.train_feed.close()
        s.train_feed = own
    return out


def phase_transitions(steps):
    """Kernel path against plain path through the fault transitions.

    Lockstep: every step, the "cuda" and the "torch" step run from the
    same state on the same batch; their losses must agree within 1e-5
    relative (only B2's summation order differs within one step) and
    their life_q banks exactly. Independent: a second solver trains on
    the "torch" engine alone from the same seed; its banks must equal
    the kernel path's at every step. Its losses are only reported: B2
    and torch.matmul sum in other orders, and once cells stick at +-1
    the training dynamics amplify that last-bit difference. Run-to-run
    drift of one engine is `phase_drift`'s subject."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.core import prng
    from rram_caffe_simulation_tpu_torch.fault import fused, hw_aware, packed
    a = slice_solver(300.0, 50.0, hw_engine="cuda", seed=5)
    b = slice_solver(300.0, 50.0, hw_engine="torch", seed=5)
    check(a.pack_spec["life_dtype"] == "int16", "mean 300 banks are int16")
    opts = dict(dtype_policy="ternary", fault_format="packed",
                pack_spec=a.pack_spec, fused_epilogue=True)
    kstep = a.make_train_step(hw_engine="cuda", **opts)
    pstep = a.make_train_step(hw_engine="torch", **opts)
    state = (a.params, a.history, a.fault_state)
    worst_lock = worst_indep = 0.0
    for i in range(steps):
        batch = {k: torch.as_tensor(v).to(a.device)
                 for k, v in a.train_feed().items()}
        rng = prng.fold_in(a._key, i)       # Solver.step's key, both runs
        kernels.reset_launches()
        _, _, pf, pl, _ = pstep(*state, batch, i, rng)
        check(hw_aware.CROSSBAR_LIB.launches == 0
              and fused.FUSED_LIB.launches == 0,
              "the torch engine launched a kernel")
        kp, kh, kf, kl, _ = kstep(*state, batch, i, rng)
        check(hw_aware.CROSSBAR_LIB.launches == 2
              and fused.FUSED_LIB.launches == 1,
              "the cuda engine did not run B2 twice and B1 once")
        b.step(1)
        kl, pl = float(kl), float(pl)
        rel = abs(kl - pl) / max(1.0, abs(pl))
        worst_lock = max(worst_lock, rel)
        check(rel <= 1e-5, f"step {i}: lockstep losses {kl} vs {pl}")
        worst_indep = max(worst_indep, abs(kl - float(b.last_loss))
                          / max(1.0, abs(float(b.last_loss))))
        for k in kf["life_q"]:
            check(torch.equal(kf["life_q"][k], pf["life_q"][k]),
                  f"step {i}: lockstep life_q banks differ on {k}")
            check(torch.equal(kf["life_q"][k], b.fault_state["life_q"][k]),
                  f"step {i}: life_q banks of the independent run differ "
                  f"on {k}")
        state = (kp, kh, kf)
    a.params, a.history, a.fault_state = state
    frac = a.broken_fraction()
    check(frac > 0, "no cell broke")
    flat = a._flat(a.params)
    for k, lq in a.fault_state["life_q"].items():
        stuck = packed.unpack_stuck(a.fault_state["stuck_bits"][k],
                                    a.pack_spec["last_dim"][k])
        br = lq <= 0
        check(torch.equal(flat[k][br], stuck[br]),
              f"a broken cell of {k} is not at its stuck value")
    print(f"phase 5: {steps} steps at N(300, 50), int16 banks: life_q "
          f"identical (cuda vs torch engine, lockstep and independent) at "
          f"every step; lockstep max loss rel diff {worst_lock:.2e} "
          f"(limit 1e-5); independent runs max loss rel diff "
          f"{worst_indep:.2e} (reported only); broken fraction {frac:.4f}, "
          "broken cells at their stuck values", flush=True)


def _bits_equal(a, b):
    import torch
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def drift_pair(steps, deterministic, pool_bwd=None):
    """Two independent "cuda"-engine runs from one seed at N(300, 50),
    stepped side by side: whether their losses and params stay equal bit
    for bit, the first step where they part, the largest loss gap, and
    the median step time of the first run."""
    import torch
    saved = (torch.backends.cudnn.deterministic,
             os.environ.get("RRAM_POOL_BWD"))
    if pool_bwd is not None:
        os.environ["RRAM_POOL_BWD"] = pool_bwd
    try:
        a = slice_solver(300.0, 50.0, seed=5)
        b = slice_solver(300.0, 50.0, seed=5)
        # set after the solvers are built: resolve_device sets the port's
        # own choice on every build
        torch.backends.cudnn.deterministic = deterministic
        first, gap, times = None, 0.0, []
        for i in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            a.step(1)
            times.append(time.perf_counter() - t0)
            b.step(1)
            la, lb = float(a.last_loss), float(b.last_loss)
            fa, fb = a._flat(a.params), b._flat(b.params)
            same = la == lb and all(_bits_equal(fa[k], fb[k]) for k in fa)
            if not same and first is None:
                first = i
            gap = max(gap, abs(la - lb) / max(1.0, abs(lb)))
        return {"identical": first is None, "first_diff_step": first,
                "max_loss_rel_gap": gap,
                "median_step_ms": float(np.median(times)) * 1e3}
    finally:
        torch.backends.cudnn.deterministic = saved[0]
        if saved[1] is None:
            os.environ.pop("RRAM_POOL_BWD", None)
        else:
            os.environ["RRAM_POOL_BWD"] = saved[1]


def phase_drift(steps):
    """Settle what makes two runs from one seed part on the card: the
    same pair three ways. The port's own setting (device.py) must give
    runs that are bit-identical."""
    import torch
    from rram_caffe_simulation_tpu_torch.device import CUDNN_DETERMINISTIC
    ways = {
        "cudnn.deterministic=False": drift_pair(steps, False),
        "cudnn.deterministic=False, RRAM_POOL_BWD=cuda":
            drift_pair(steps, False, pool_bwd="cuda"),
        "cudnn.deterministic=True": drift_pair(steps, True),
    }
    for name, r in ways.items():
        print(f"phase 5: drift, two independent cuda-engine runs, {steps} "
              f"steps at N(300, 50), {name}: "
              f"{'bit-identical' if r['identical'] else 'part at step %d' % r['first_diff_step']}"
              f", max loss rel gap {r['max_loss_rel_gap']:.3e}, median "
              f"step {r['median_step_ms']:.3f} ms", flush=True)
    own = ways[f"cudnn.deterministic={CUDNN_DETERMINISTIC}"]
    check(own["identical"], "two runs from one seed part under the port's "
          f"own setting (cudnn.deterministic={CUDNN_DETERMINISTIC})")
    check(torch.backends.cudnn.deterministic == CUDNN_DETERMINISTIC,
          "the port's cuDNN setting was not restored")
    return ways


# ---------------------------------------------------------------------------
# phase 6: B4

POOL1 = ((3, 3), (2, 2), (0, 1, 0, 1))   # kernel, stride, fpad (CEIL hi 1)


def pooled(hw, kernel, stride, fpad):
    return ((hw[0] + fpad[2] + fpad[3] - kernel[0]) // stride[0] + 1,
            (hw[1] + fpad[0] + fpad[1] - kernel[1]) // stride[1] + 1)


def b4_inputs(lead, hw, geometry, seed, device, const=None):
    """x (lead..., H, W) and g (lead..., Ho, Wo), drawn on the card; x
    constant where `const` is a number, with NaNs (lone ones, and windows
    of two or more) where it is "nan"."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    ohw = pooled(hw, *geometry)
    x = torch.randn(tuple(lead) + tuple(hw), generator=g, device=device)
    if const == "nan":
        x[torch.rand(x.shape, generator=g, device=device) < 0.05] = \
            float("nan")
        x[..., :2, :2] = float("nan")
    elif const is not None:
        x.fill_(const)
    return x, torch.randn(tuple(lead) + ohw, generator=g, device=device)


def autograd_pool_dx(x, g, kernel, stride, fpad):
    """dx through F.pad(-inf) + F.max_pool2d and autograd's own CUDA
    max-pool backward."""
    import torch
    import torch.nn.functional as F
    xr = x.detach().requires_grad_()
    y = F.max_pool2d(F.pad(xr, fpad, value=float("-inf")), kernel, stride)
    (dx,) = torch.autograd.grad(y, xr, g)
    return dx


def phase_b4(device):
    import torch
    from rram_caffe_simulation_tpu_torch.ops import pool_backward as pb
    # (name, lead, hw, geometry, x, shared-memory budget of the plan)
    cases = [("pool1 C=1", (100, 32), (32, 32), POOL1, None, None),
             ("pool1 C=4", (100, 128), (32, 32), POOL1, None, None),
             ("pool1 at the tiled sweep's C",
              (100, 32 * TILED_SWEEP_CONFIGS), (32, 32), POOL1, None, None),
             ("7x7 k3 s2 pad 1", (8, 5), (7, 7),
              ((3, 3), (2, 2), (1, 1, 1, 1)), None, None),
             ("constant plane", (4, 6), (32, 32), POOL1, 0.25, None),
             ("NaN windows", (4, 6), (32, 32), POOL1, "nan", None),
             ("300x300 in row bands", (2, 3), (300, 300), POOL1, None, None),
             ("pool1 in bands of rows and columns", (4, 6), (32, 32), POOL1,
              "nan", 1024)]
    worst_auto = 0.0
    for n, (name, lead, hw, geometry, const, budget) in enumerate(cases):
        x, g = b4_inputs(lead, hw, geometry, 300 + n, device, const)
        if budget is None:
            dk = pb.max_pool_backward(x, g, *geometry)
        else:
            plan = pb.b4_plan(*hw, *g.shape[-2:], *geometry, budget=budget)
            check(plan.rows < hw[0] and plan.cols < hw[1],
                  f"B4's plan under {budget} bytes does not band: {plan}")
            dk = pb._launch_b4(x, g, *geometry, plan)
        dp = pb.max_pool_backward_plain(x, g, *geometry)
        torch.cuda.synchronize()
        check(torch.equal(dk.view(torch.int32), dp.view(torch.int32)),
              f"B4 differs from its plain version: {name}")
        if isinstance(const, float):
            kernel, stride, fpad = geometry
            ohw = g.shape[-2:]
            anchors = dk[..., fpad[2]::stride[0], fpad[0]::stride[1]]
            check(torch.equal(anchors[..., :ohw[0], :ohw[1]], g),
                  "B4: a tied window's cotangent is not at its first "
                  "element")
        if const == "nan":
            continue    # autograd's max_pool2d keeps a window's last NaN
        da = autograd_pool_dx(x, g, *geometry)
        bound = 4 * U32 * pb.max_pool_backward_plain(x, g.abs(), *geometry)
        err = (dk - da).abs()
        check(bool((err <= bound + 1e-30).all()),
              f"B4 and autograd's backward differ beyond reordering: {name}")
        worst_auto = max(worst_auto, float(err.max()))
    del x, g, dk, dp
    # hand the cached blocks back before the sweep: on an H100, phase 7's
    # peak memory (reached in its first chunk) read 81.63 GB after this
    # phase left 8.5 GB cached, and 21.95 GB after 0.8 GB
    torch.cuda.empty_cache()
    print(f"phase 6: B4 bit-identical to its plain version in {len(cases)} "
          f"cases ({', '.join(c[0] for c in cases)}); against autograd's "
          f"max-pool backward (finite cases) max abs err {worst_auto:.3e} "
          "(within 4 f32 roundings of the summed cotangents)", flush=True)
    return 0.0, worst_auto


B4_KERNELS = ("pool_backward_kernel",)     # B4's own device activity


def b4_step_numbers(device, C, ceiling=False, planes=32, hw=(32, 32),
                    geometry=POOL1, batch=100):
    """B4 at the sweep's pool1 (x (100, C*32, 32, 32); `planes` channels
    a lane of `hw` maps under `geometry` at `batch` for another pool):
    the kernel's device time (profiled over >= 10 calls) and by CUDA
    events, its time
    by device activity (an older checkout's two kernels apart), the plain
    version, and autograd's CUDA max-pool backward given the forward's
    indices (torch.ops.aten.max_pool2d_with_indices_backward on the
    padded input); bound = bytes of x + g + dx over the HBM rate. The
    kernel's dx must equal the plain version's bit for bit on these
    inputs. With `ceiling`, also the time of a device copy of x by CUDA
    events (the card's practical rate for a stream that reads and
    writes)."""
    import torch
    import torch.nn.functional as F
    from rram_caffe_simulation_tpu_torch.ops import pool_backward as pb
    kernel, stride, fpad = geometry
    x, g = b4_inputs((batch, planes * C), hw, geometry, 400, device)
    iters = 100 if C <= 4 else 20 if C <= 64 else 10
    fn = lambda: pb.max_pool_backward(x, g, *geometry)
    plain = lambda: pb.max_pool_backward_plain(x, g, *geometry)
    k_ev = event_ms(fn, iters=iters, warmup=2)
    by_name = device_ms_by_name(fn, iters)
    k = sum(v for v, _ in by_name.values())
    p, _ = timed(plain, max(2, iters // 5))
    dk, dp = fn(), plain()
    torch.cuda.synchronize()
    check(torch.equal(dk.view(torch.int32), dp.view(torch.int32)),
          f"B4 differs from its plain version at x {tuple(x.shape)}")
    err = float((dk - dp).abs().max())
    del dk, dp
    xp = F.pad(x, fpad, value=float("-inf"))
    _, idx = F.max_pool2d(xp, kernel, stride, return_indices=True)
    lib = event_ms(lambda: torch.ops.aten.max_pool2d_with_indices_backward(
        g, xp, list(kernel), list(stride), [0, 0], [1, 1], False, idx),
        iters=iters, warmup=2)
    del xp, idx
    nbytes = 4 * (2 * x.numel() + g.numel())
    b = nbytes / HBM_BYTES_PER_S * 1e3
    extra = {}
    if ceiling:
        buf = torch.empty_like(x)
        extra["copy_of_x_ms"] = event_ms(lambda: buf.copy_(x), iters=iters,
                                         warmup=2)
        del buf
    split = ", ".join(f"{nm} {v:.5f} ms ({cnt} in {iters} calls)"
                      for nm, (v, cnt) in sorted(by_name.items()))
    print(f"  B4 C={C} x {tuple(x.shape)}: kernel {k:.5f} ms on the card "
          f"({k_ev:.5f} ms by CUDA events over {iters} calls; by activity: "
          f"{split}), plain {p:.5f} ms, autograd's backward {lib:.5f} ms, "
          f"bound {b:.6f} ms (bytes {nbytes}); bit-identical to the plain "
          f"version{'; ' + str(extra) if extra else ''}", flush=True)
    return {"ms": k, "plain_ms": p, "bound_ms": b, "bound_by": "bytes",
            "library_ms": lib, "event_ms": k_ev, "max_abs_err": err,
            "by_activity": {nm: v for nm, (v, _) in by_name.items()},
            **extra}


def b4_path_numbers(device, C, own_kernel_only=True):
    """B4's `path_ms`: the device time of pool1's backward through the
    layer's autograd.Function (`_MaxPool.backward`, RRAM_POOL_BWD=cuda)
    at the sweep's shape, x (100, C*32, 32, 32), over 10 profiled calls.
    x and g are contiguous tensors drawn here, as conv1's output (which
    the forward saves) and relu1's cotangent are on the sweep's path; so
    this sees a copy that the Function or the wrapper adds, not one that
    another saved layout would cause. With `own_kernel_only`, any device
    activity on the path other than B4's own kernel (a copy from
    `.contiguous()`, a memset, a scratch fill) fails."""
    import torch
    from rram_caffe_simulation_tpu_torch.ops import pool_backward as pb
    x, g = b4_inputs((100, 32 * C), (32, 32), POOL1, 410, device)
    xr = x.requires_grad_()
    y = pb._MaxPool.apply(xr, *POOL1, "cuda")
    fn = lambda: torch.autograd.grad(y, xr, g, retain_graph=True)
    seen = device_ms_by_name(fn, 10)
    ms = sum(v for v, _ in seen.values())
    other = sorted(nm for nm in seen
                   if not any(own in nm for own in B4_KERNELS))
    print(f"  B4 path C={C}: {ms:.5f} ms on the card a backward through "
          f"_MaxPool; device activities "
          f"{ {nm: cnt for nm, (_, cnt) in sorted(seen.items())} } in 10 "
          f"calls; other than B4's own: {other}", flush=True)
    if own_kernel_only:
        check(any(own in nm for nm in seen for own in B4_KERNELS),
              f"the profiler did not see B4 among {sorted(seen)}")
        check(not other, f"B4's path launched device activity that is not "
              f"its own kernel: {other}")
    del y, xr, x, g
    torch.cuda.empty_cache()
    return {"path_ms": ms, "path_activities": sorted(seen)}


# ---------------------------------------------------------------------------
# phases 7 and 8: the sweep

def sweep_runner(C, mean, std, engine="cuda", seed=1, strategies=(),
                 fields=None):
    from rram_caffe_simulation_tpu_torch.parallel import SweepRunner
    s = slice_solver(mean, std, hw_engine=engine, seed=seed,
                     strategies=strategies, fields=fields)
    return SweepRunner(s, n_configs=C, engine=engine, packed_state=True,
                       dtype_policy="ternary")


SWEEP_CONFIGS = 512              # the reference bench's sweep width
SWEEP_CHUNK = 5
SWEEP_STEPS = 10                 # timed steps of phases 7 and 11


def _launches():
    """Launches since the last reset, per kernel (per exported function:
    B2, B2t and B3 share a source)."""
    from rram_caffe_simulation_tpu_torch.fault import fused, hw_aware
    from rram_caffe_simulation_tpu_torch.ops import pool_backward
    crossbar = hw_aware.CROSSBAR_LIB.counts
    return {"B2": crossbar["rram_crossbar_forward"],
            "B2t": crossbar["rram_crossbar_tiled_forward"],
            "B3": crossbar["rram_crossbar_implicit_forward"],
            "B1": fused.FUSED_LIB.launches,
            "B4": pool_backward.POOL_BWD_LIB.launches}


def _untiled(**counts):
    return {"B2t": 0, "B3": 0, **counts}


def _event_stepper(runner, events):
    """Wrap the runner's step function so a CUDA event is recorded on the
    stream after each step's work: the gaps between events are the step
    times on the device's timeline, with no host synchronization."""
    import torch
    inner = runner._step

    def stepper(*args, **kw):
        out = inner(*args, **kw)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        return out
    return inner, stepper


def sweep_breakdown(r, steps=SWEEP_CHUNK):
    """Device kernel time per sweep step (torch.profiler/CUPTI) over one
    chunk, with the five largest kernels by name, and the chunk's own
    step time under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        r.step(steps, chunk=steps)
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    busy, by_name = device_kernels(prof, steps)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"profiled_step_ms": wall, "device_busy_ms": busy,
            "top": "; ".join(f"{n[:60]} {ms:.4f} ms" for n, ms in top)}


def warm_lockstep(r, steps):
    """`steps` sweep steps one at a time, each also through the torch
    engine (plain versions, RRAM_POOL_BWD=torch) from the same state,
    batch and lane keys: every lane's loss within 1e-5 relative of the
    plain one and the banks identical. Returns the last step's lane
    losses and the largest relative gap."""
    import torch
    opts = dict(dtype_policy="ternary", fault_format="packed",
                pack_spec=r._pack_spec, fused_epilogue=True)
    pstep = r.solver.make_train_step(hw_engine="torch", lanes=r.n, **opts)
    worst = 0.0
    for it in range(steps):
        batch = r._batch(r.iter)
        state = (r.params, r.history, r.fault_states)
        keys = r.lane_keys(r.iter)
        os.environ["RRAM_POOL_BWD"] = "torch"
        try:
            _, _, pf, pl, _ = pstep(*state, batch, r.iter, keys)
        finally:
            os.environ["RRAM_POOL_BWD"] = "cuda"
        kp, kh, kf, kl, _ = r._step(*state, batch, r.iter, keys)
        rel = float(((kl - pl).abs() / pl.abs().clamp_min(1.0)).max())
        worst = max(worst, rel)
        check(rel <= 1e-5, f"warm step {it}: sweep losses against the "
              f"plain engine's differ by {rel:.3e} relative")
        for k in kf["life_q"]:
            check(torch.equal(kf["life_q"][k], pf["life_q"][k]),
                  f"warm step {it}: life_q differs from the plain "
                  f"engine's on {k}")
        del pf, pl
        r._commit(kp, kh, kf, kl)
        r.iter += 1
    return kl.cpu().numpy(), worst


def run_sweep(C, timed_steps, gpu):
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = sweep_runner(C, 1e8, 3e7)
    setup_s = time.perf_counter() - t0
    check(r.engine_resolved == "cuda" and r.fused_epilogue_resolved,
          "the sweep did not resolve to the cuda engine with the fused "
          "epilogue")
    check(r._dataset is not None, "the dataset is not on the device")
    check(r._pack_spec["life_dtype"] == "int32", "1e8 banks must be int32")
    # N(1e8, 3e7) leaves 0.043% of cells dead at init, stuck at -1/0/+1
    # (about 28 of ip1's a lane, as the reference draws them), which
    # moves a lane's logits off the near-zero init's ln(10): every lane
    # is held to the plain engine, a lane with none dead to ln(10) too
    dead0 = r.broken_fractions() > 0
    setup_peak = torch.cuda.max_memory_allocated()
    warm, warm_rel = warm_lockstep(r, SWEEP_CHUNK)
    check(bool(np.isfinite(warm).all()), "non-finite loss in the warm chunk")
    warm_dev = np.abs(warm - math.log(10))
    clean_dev = float(warm_dev[~dead0].max()) if (~dead0).any() else None
    check(clean_dev is None or clean_dev < 0.05,
          f"a lane with no cell dead at init is {clean_dev} from ln(10) at "
          "a near-zero init")
    torch.cuda.reset_peak_memory_stats()     # the plain engine's peak
    events = []
    inner, stepper = _event_stepper(r, events)
    r._step = stepper
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    kernels.reset_launches()
    start.record()
    t0 = time.perf_counter()
    losses = r.step(timed_steps, chunk=SWEEP_CHUNK)[0]  # ends in a host read
    wall = time.perf_counter() - t0
    launches = _launches()
    r._step = inner
    step_ms = [a.elapsed_time(b) for a, b in zip([start] + events[:-1],
                                                 events)]
    check(losses.shape == (C,) and bool(np.isfinite(losses).all()),
          "non-finite or misshapen sweep losses")
    check(launches == _untiled(B2=2 * timed_steps, B1=timed_steps,
                               B4=timed_steps),
          f"launches {launches} in {timed_steps} steps, expected B2 2, B1 "
          "1, B4 1 per step")
    # N(1e8, 3e7) draws a few cells dead (z < -3.3); none dies in a run
    check(float(r.broken_fractions().max()) < 1e-3,
          "cells broke at N(1e8, 3e7)")
    q1, med, q3 = (float(v) for v in np.percentile(step_ms, [25, 50, 75]))
    rate = C * timed_steps / wall
    bd = sweep_breakdown(r)
    # the same chunk with cuDNN's determinism flipped, timed beside it
    flip = not torch.backends.cudnn.deterministic
    saved = torch.backends.cudnn.deterministic
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    torch.backends.cudnn.deterministic = flip
    try:
        r.step(SWEEP_CHUNK, chunk=SWEEP_CHUNK)
        torch.cuda.synchronize()
        flip_ms = (time.perf_counter() - t0) / SWEEP_CHUNK * 1e3
        t0 = time.perf_counter()
        torch.backends.cudnn.deterministic = saved
        r.step(SWEEP_CHUNK, chunk=SWEEP_CHUNK)
        torch.cuda.synchronize()
        again_ms = (time.perf_counter() - t0) / SWEEP_CHUNK * 1e3
    finally:
        torch.backends.cudnn.deterministic = saved
    out = {"configs": C, "chunk": SWEEP_CHUNK, "timed_steps": timed_steps,
           "configs_steps_per_s": rate, "wall_s": wall,
           "step_ms_median": med, "step_ms_q1": q1, "step_ms_q3": q3,
           "peak_mem_bytes": int(max(setup_peak,
                                     torch.cuda.max_memory_allocated())),
           "bytes_per_step_est": r.bytes_per_step_est(),
           "setup_s": setup_s, "launches": launches, **bd,
           "warm_lockstep_rel_max": warm_rel,
           "warm_lanes_dead_at_init": int(dead0.sum()),
           "warm_loss_dev_clean_max": clean_dev,
           "warm_loss_dev_max": float(warm_dev.max()),
           # busy time from the profiled chunk against the unprofiled
           # step: the profiler slows the host, not the kernels
           "device_idle_share": max(0.0, 1 - bd["device_busy_ms"] / med),
           f"chunk_step_ms_cudnn_deterministic_{flip}": flip_ms,
           f"chunk_step_ms_cudnn_deterministic_{saved}": again_ms,
           "gpu": gpu}
    del r
    return out


def phase_sweep(C, timed_steps, gpu):
    """Phase 7 at C lanes, halved while the card runs out of memory."""
    import torch
    saved = os.environ.get("RRAM_POOL_BWD")
    os.environ["RRAM_POOL_BWD"] = "cuda"
    try:
        while True:
            try:
                out = run_sweep(C, timed_steps, gpu)
                break
            except torch.cuda.OutOfMemoryError:
                check(C > 8, "the sweep does not fit the card at C = 8")
                print(f"phase 7: C = {C} does not fit the card "
                      f"(out of memory); halving", flush=True)
                C //= 2
                torch.cuda.empty_cache()
    finally:
        if saved is None:
            os.environ.pop("RRAM_POOL_BWD", None)
        else:
            os.environ["RRAM_POOL_BWD"] = saved
    torch.cuda.empty_cache()
    print(f"phase 7: sweep, CIFAR-10-quick batch 100, C = {C} config lanes, "
          f"N(1e8, 3e7), ternary, packed int32 banks, fused epilogue, device "
          f"dataset, RRAM_POOL_BWD=cuda, chunk {SWEEP_CHUNK}: "
          f"{out['configs_steps_per_s']:.1f} configs*steps/s over "
          f"{timed_steps} steps ({out['wall_s']:.3f} s); step median "
          f"{out['step_ms_median']:.3f} ms (quartiles {out['step_ms_q1']:.3f}"
          f" / {out['step_ms_q3']:.3f}); peak memory "
          f"{out['peak_mem_bytes'] / 1e9:.2f} GB; bytes_per_step_est "
          f"{out['bytes_per_step_est']}; launches {out['launches']}; "
          f"{gpu}", flush=True)
    print(f"phase 7: kernels on the card {out['device_busy_ms']:.3f} ms/step"
          f" ({out['device_idle_share']:.1%} of the unprofiled step idle; "
          f"the profiled chunk took {out['profiled_step_ms']:.3f} ms/step); "
          f"top device kernels: {out['top']}", flush=True)
    clean = out["warm_loss_dev_clean_max"]
    print(f"phase 7: warm chunk in lockstep with the torch engine (plain "
          f"versions, RRAM_POOL_BWD=torch): every lane's loss within "
          f"{out['warm_lockstep_rel_max']:.2e} relative (limit 1e-5), life_q "
          f"identical; {out['warm_lanes_dead_at_init']} of {C} lanes with a "
          f"cell dead at init; distance from ln(10): lanes with none "
          + (f"at most {clean:.5f} (limit 0.05)" if clean is not None
             else "(no such lane)")
          + f", every lane at most {out['warm_loss_dev_max']:.5f}",
          flush=True)
    print("phase 7: one chunk each way, ms/step: " + ", ".join(
        f"{k[len('chunk_step_ms_'):]} {v:.3f}" for k, v in out.items()
        if k.startswith("chunk_step_ms_")), flush=True)
    return out


def phase_sweep_checks(steps, C=8):
    """Phase 8: the sweep against its plain path and against Solver, in
    lockstep at N(300, 50); then the per-lane quarantine."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    r = sweep_runner(C, 300.0, 50.0, seed=7)
    check(r._pack_spec["life_dtype"] == "int16", "mean 300 banks are int16")
    opts = dict(dtype_policy="ternary", fault_format="packed",
                pack_spec=r._pack_spec, fused_epilogue=True)
    pstep = r.solver.make_train_step(hw_engine="torch", lanes=C, **opts)
    single = slice_solver(300.0, 50.0, seed=7)
    check(single.pack_spec == r._pack_spec, "pack specs differ")
    saved = os.environ.get("RRAM_POOL_BWD")
    worst_lock = worst_lane = 0.0
    try:
        for it in range(steps):
            batch = r._batch(r.iter)
            state = (r.params, r.history, r.fault_states)
            lanes_before = [r.lane_state(i) for i in range(C)]
            keys = r.lane_keys(r.iter)
            os.environ["RRAM_POOL_BWD"] = "torch"
            kernels.reset_launches()
            _, _, pf, pl, _ = pstep(*state, batch, r.iter, keys)
            check(_launches() == _untiled(B2=0, B1=0, B4=0),
                  "the torch engine launched a kernel")
            os.environ["RRAM_POOL_BWD"] = "cuda"
            kp, kh, kf, kl, _ = r._step(*state, batch, r.iter, keys)
            got = _launches()
            check(got == _untiled(B2=2, B1=1, B4=1),
                  f"sweep step launches {got}, expected B2 2, B1 1, B4 1")
            rel = ((kl - pl).abs() / pl.abs().clamp_min(1.0)).max()
            worst_lock = max(worst_lock, float(rel))
            check(float(rel) <= 1e-5, f"step {it}: lockstep losses "
                  f"{kl.tolist()} vs {pl.tolist()}")
            for k in kf["life_q"]:
                check(torch.equal(kf["life_q"][k], pf["life_q"][k]),
                      f"step {it}: lockstep life_q banks differ on {k}")
            for i in range(C):
                _, _, sf, sl, _ = single._step_fn(*lanes_before[i], batch,
                                                  r.iter, keys[i])
                rel = abs(float(sl) - float(kl[i])) / max(1.0, abs(float(sl)))
                worst_lane = max(worst_lane, rel)
                check(rel <= 1e-5, f"step {it} lane {i}: sweep loss "
                      f"{float(kl[i])} vs Solver {float(sl)}")
                for k in sf["life_q"]:
                    check(torch.equal(sf["life_q"][k], kf["life_q"][k][i]),
                          f"step {it} lane {i}: banks differ from Solver's "
                          f"on {k}")
            r._commit(kp, kh, kf, kl)
            r.iter += 1
        frac = r.broken_fractions()
        check(bool((frac > 0).all()), "a lane had no broken cell")
        # one lane poisoned: frozen, the others train on
        bad = 3
        r.params["conv2"][0][bad, 0, 0, 0, 0] = float("nan")
        before = r.lane_state(bad)[2]["life_q"]
        losses = r.step(2, chunk=2)[0]
    finally:
        if saved is None:
            os.environ.pop("RRAM_POOL_BWD", None)
        else:
            os.environ["RRAM_POOL_BWD"] = saved
    check(list(r.quarantined()) == [bad], f"quarantined {r.quarantined()}")
    check(not math.isfinite(float(losses[bad])), "the poisoned lane's loss")
    check(all(math.isfinite(float(v)) for i, v in enumerate(losses)
              if i != bad), "a healthy lane went non-finite")
    after = r.lane_state(bad)[2]["life_q"]
    check(all(torch.equal(before[k], after[k]) for k in before),
          "the quarantined lane's banks moved")
    print(f"phase 8: sweep C = {C}, {steps} steps at N(300, 50), int16 banks:"
          f" cuda vs torch engine in lockstep, life_q identical, max loss "
          f"rel diff {worst_lock:.2e} (limit 1e-5); each lane vs Solver from "
          f"its state, life_q identical, max loss rel diff {worst_lane:.2e} "
          f"(limit 1e-5); broken fractions {[round(float(v), 4) for v in frac]}"
          f"; lane {bad} poisoned with a NaN: quarantined, banks frozen, the "
          f"other {C - 1} lanes finite", flush=True)


# ---------------------------------------------------------------------------
# phase 9: B2t and B3

CONV_GEOM = (5, 5, 1, 1, 2, 2, 1, 1)     # CIFAR-10-quick's 5x5 pad 2 convs
# name: (x shape of one lane, geom or None for a dense (M, K) x, K, N, tiles)
TILED_CASES = {
    "ip1": ((100, 1024), None, 1024, 64, (128, 64, 8)),
    "conv2": ((100, 32, 16, 16), CONV_GEOM, 800, 32, (128, 32, 8)),
    "conv3": ((100, 32, 8, 8), CONV_GEOM, 800, 64, (128, 64, 8)),
    "strided dilated conv": ((4, 3, 13, 11), (3, 3, 2, 1, 1, 2, 2, 1), 27,
                             11, (7, 3, 3)),
    "ragged ip": ((37, 50), None, 50, 11, (7, 3, 3)),
    # B2t at the edges of its tiling: M 1, 128 and 129 (one row block or
    # two), a short last K-tile (K 1000, bk 128) and bk 96, N 10 and 130
    # with bn 64, two N-tiles in a 64-column block (N 64, bn 32), one
    # K-tile
    "M 1, K 1000": ((1, 1000), None, 1000, 64, (128, 64, 8)),
    "one K-tile": ((100, 64), None, 64, 10, (128, 64, 8)),
    "M 128, bk 96, N 10": ((128, 1000), None, 1000, 10, (96, 64, 8)),
    "N 130": ((100, 256), None, 256, 130, (128, 64, 8)),
    "N 64, bn 32": ((100, 300), None, 300, 64, (128, 32, 8)),
    "M 129": ((129, 1024), None, 1024, 64, (128, 64, 8)),
}
# a lane with more tile steps (gk * gn) than the ADC pass keeps in 48 KB
# of shared memory (12,288): 1-cell crossbar tiles
MANY_TILE_CASES = {
    "ip, 14400 tiles": ((20, 1600), None, 1600, 9, (1, 1, 0)),
    "conv, 13824 tiles": ((2, 16, 9, 9), (3, 3, 1, 1, 1, 1, 1, 1), 144, 96,
                          (1, 1, 0)),
}


def tiled_operands(x_shape, C, x_per_lane, K, N, dyadic, seed, device):
    """x, w, broken, stuck, eps, seeds on the card. Dyadic: x and w are
    multiples of 2^-4 with max |w| = 0.75 in every lane, so every
    partial sum is exact in f32 whatever the order, and the ternary grid
    step (0.75) too."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    xs = ((C,) if x_per_lane else ()) + tuple(x_shape)

    def dy(shape, lim):
        return torch.randint(-lim, lim + 1, shape, generator=g,
                             device=device).float() / 16.0
    if dyadic:
        x, w = dy(xs, 16), dy((C, K, N), 12)
        w[:, 0, 0] = 0.75
    else:
        x = torch.randn(xs, generator=g, device=device)
        w = torch.randn((C, K, N), generator=g, device=device) * 0.1
    broken = (torch.rand((C, K, N), generator=g, device=device)
              < 0.1).float()
    stuck = torch.randint(-1, 2, (C, K, N), generator=g,
                          device=device).float()
    eps = torch.randn((C, K, N), generator=g, device=device)
    seeds = torch.randint(0, 2 ** 31 - 1, (C,), generator=g, device=device,
                          dtype=torch.int32)
    return x, w, broken, stuck, eps, seeds


def tiled_forward(kernel, x, w, br, st, seeds, sigma, q_bits, eps, geom,
                  tiles):
    from rram_caffe_simulation_tpu_torch.fault import hw_aware as hw
    if geom is None:
        fn = hw.crossbar_forward if kernel else hw.crossbar_forward_plain
        return fn(x, w, br, st, seeds, sigma, q_bits, eps=eps, tiles=tiles)
    fn = hw.crossbar_conv_forward if kernel else \
        hw.crossbar_conv_forward_plain
    return fn(x, w, br, st, seeds, sigma, q_bits, tiles, geom, eps=eps)


def tiled_matmul_forward(x, w, br, st, seeds, sigma, q_bits, eps, geom,
                         tiles):
    """The plain tiled read with `torch.matmul` partials (the form a
    tiled layer with no crossbar read armed runs): the library-speed
    plain version the kernels' rows report as `plain_ms`."""
    from rram_caffe_simulation_tpu_torch.fault import hw_aware as hw
    w_eff = hw._lane_w_eff(w, br, st, seeds, sigma, q_bits, eps).contiguous()
    if geom is None:
        return hw.tiled_crossbar_matmul(x.contiguous(), w_eff, *tiles)
    return hw.tiled_crossbar_matmul_slabs(
        hw.conv_operand_slabs(x, geom, "implicit"), w_eff, *tiles)


def exact_gap(y, y_ref):
    """(equal, share of elements apart, max |y - y_ref|): the tiled reads
    sum each tile in one order on both paths (the plain read's partials
    follow the kernels' k order on the card), so they are held equal."""
    import torch
    differ = y != y_ref
    return (torch.equal(y, y_ref), float(differ.float().mean()),
            float((y - y_ref).abs().max()) if y.numel() else 0.0)


B2T_ROWS = (32, 112, 128)        # the tile heights of B2t's GEMM pass


def b3_layouts(x, w, br, st, eps):
    """The same conv operand values in every layout the B3 wrapper takes,
    as name -> (x, w, broken, stuck, eps) views: w, stuck and eps as the
    `to_im2col` view of Caffe's stored (C, C_out, K) weight, broken bool,
    uint8 or f32, x (per lane) as the transposed view of a laned
    (N, C, ch, H, W) activation."""
    import torch

    def turned(t):      # Caffe's stored (C, C_out, K), viewed (C, K, N)
        return t.transpose(1, 2).contiguous().transpose(1, 2)

    def laned(t):       # (N, C, ch, H, W) storage, viewed (C, N, ch, H, W)
        return (t.transpose(0, 1).contiguous().transpose(0, 1)
                if t.dim() == 5 else t)

    bb = br > 0
    return {
        "stored, broken bool, x laned":
            (laned(x), turned(w), turned(bb), turned(st), turned(eps)),
        "broken uint8": (x, w, bb.to(torch.uint8), st, eps),
        "stored, broken f32": (x, turned(w), turned(br), turned(st), eps),
    }


def phase_tiled_kernels(device):
    """B2t and B3 against their plain versions (phase 9); returns the
    largest |kernel - plain| of B2t, of B3 at C = 1 (B3a) and at C = 4
    (B3b) over the random-input cases."""
    import torch
    from rram_caffe_simulation_tpu_torch.fault import hw_aware as hw
    from rram_caffe_simulation_tpu_torch.fault.mapping import conv_patch_rows
    err = {"B2t": 0.0, "B3a": 0.0, "B3b": 0.0}
    n_exact, n_bound, n_layout, seed = 0, 0, 0, 900
    n_b3 = 0
    planned, planned_b3 = set(), set()
    for name, (xs, geom, K, N, tiles) in TILED_CASES.items():
        for C, per_lane in ((1, False), (4, False), (4, True)):
            for dyadic in (True, False):
                seed += 1
                x, w, br, st, eps, seeds = tiled_operands(
                    xs, C, per_lane, K, N, dyadic, seed, device)
                rows = x if geom is None else conv_patch_rows(x, geom)
                layouts = (b2_layouts if geom is None else b3_layouts)(
                    x, w, br, st, eps)
                if geom is None:
                    planned.add(hw.b2t_plan(C, xs[0], K, N, tiles[0]))
                else:
                    planned_b3.add(hw.b3_plan(N))
                runs = [(0.0, None, 0), (0.0, None, 2)]
                if not dyadic:
                    runs += [(0.05, eps, 2), (0.05, None, 2)]
                for adc in ((3, 8) if dyadic else (tiles[2],)):
                    t = (tiles[0], tiles[1], adc)
                    for sigma, e, q_bits in runs:
                        args = (x, w, br, st, seeds, sigma, q_bits, e, geom,
                                t)
                        yk = tiled_forward(True, *args)
                        yp = tiled_forward(False, *args)
                        torch.cuda.synchronize()
                        where = (f"{name} C={C} per_lane={per_lane} "
                                 f"dyadic={dyadic} adc={adc} sigma={sigma} "
                                 f"host_noise={e is not None} q={q_bits}")
                        # B2t at every tile height: the plan's bits
                        for bm in (B2T_ROWS if geom is None else ()):
                            check(torch.equal(hw._launch_b2t(
                                x, w, br, st, seeds, sigma, q_bits, e, t,
                                bm=bm), yk), f"B2t on {bm}-row tiles "
                                f"differs from the plan's: {where}")
                        if geom is not None:
                            # B3 is B2t over the patch rows at the same
                            # tiles, bit for bit
                            check(torch.equal(hw._launch_b2t(
                                rows, w, br, st, seeds, sigma, q_bits, e, t),
                                yk), f"B3 differs from B2t over the patch "
                                f"rows: {where}")
                            n_b3 += 1
                        # B2t and B3 read every layout in place: the dense
                        # f32 call's bits, twice each (a fixed summation
                        # order)
                        for lname, (lx, lw, lb, ls, le) in layouts.items():
                            for _ in range(2):
                                check(torch.equal(tiled_forward(
                                    True, lx, lw, lb, ls, seeds, sigma,
                                    q_bits, le if e is not None else None,
                                    geom, t), yk), f"B2t/B3 on layout "
                                    f"'{lname}' differs from the dense f32 "
                                    f"call: {where}")
                            n_layout += 1
                        same, share, e_max = exact_gap(yk, yp)
                        check(same, f"B2t/B3 differ from plain (share "
                              f"{share:.2e}, max err {e_max}): {where}")
                        if dyadic:
                            n_exact += 1
                            continue
                        key = ("B2t" if geom is None else
                               "B3a" if C == 1 else "B3b")
                        err[key] = max(err[key], e_max)
                        n_bound += 1
                del x, w, br, st, eps, rows
    torch.cuda.empty_cache()
    # the tiled read's in-kernel noise is B2's: x = I, ADC off, so y is
    # w_eff itself, at each of B2t's tile heights
    K = N = 96
    x = torch.eye(K, device=device)
    w = torch.ones((2, K, N), device=device)
    zero = torch.zeros_like(w)
    seeds = torch.tensor([5, 2 ** 31 - 7], dtype=torch.int32, device=device)
    untiled = hw.crossbar_forward(x, w, zero, zero, seeds, 0.05, 0)
    for tiles in ((7, 5, 0), (32, 32, 0), (96, 32, 0)):
        check(torch.equal(untiled, hw.crossbar_forward(
            x, w, zero, zero, seeds, 0.05, 0, tiles=tiles)),
            f"the tiled read's in-kernel noise differs from B2's (tiles "
            f"{tiles})")
        for bm in B2T_ROWS:
            check(torch.equal(untiled, hw._launch_b2t(
                x, w, zero, zero, seeds, 0.05, 0, None, tiles, bm=bm)),
                f"the tiled read's in-kernel noise differs from B2's on "
                f"{bm}-row tiles (tiles {tiles})")
    # more tile steps (gk * gn) in a lane than the ADC pass keeps in
    # shared memory: it reads them from the tile maxima instead
    n_many = 0
    for name, (xs, geom, K, N, tiles) in MANY_TILE_CASES.items():
        for adc in (0, 3):
            seed += 1
            t = (tiles[0], tiles[1], adc)
            x, w, br, st, eps, seeds = tiled_operands(
                xs, 2, False, K, N, True, seed, device)
            args = (x, w, br, st, seeds, 0.0, 2, None, geom, t)
            check(torch.equal(tiled_forward(True, *args),
                              tiled_forward(False, *args)),
                  f"{name} with {-(-K // t[0]) * -(-N // t[1])} tile steps "
                  f"a lane differs from plain (adc {adc})")
            n_many += 1
            del x, w, br, st, eps
    print(f"phase 9: B2t/B3 equal to their plain versions in {n_exact} "
          f"dyadic cases (ADC 3 and 8 bits, sigma 0) and in {n_bound} "
          f"random cases (sigma 0, 0.05 host and in-kernel noise; the plain "
          f"read's partials in the kernels' k order); "
          f"B2t equal at tile rows {list(B2T_ROWS)} (the plan took "
          f"{sorted(planned)}); B3 equal to B2t over the patch rows in "
          f"{n_b3} cases (column tiles {sorted(planned_b3)}); "
          f"{n_many} B2t/B3 cases with more tile steps than shared memory "
          f"holds equal to plain; {n_layout} B2t/B3 layout "
          f"cases (dense, stored and turned with x folded or laned, "
          f"unaligned, mixed; broken bool, uint8, f32) equal to the dense "
          f"call, twice each; "
          f"max abs err B2t {err['B2t']:.3e}, B3a {err['B3a']:.3e}, B3b "
          f"{err['B3b']:.3e}; in-kernel noise equal to B2's at every tile "
          f"height", flush=True)
    err["exact_cases"] = n_exact + n_bound + n_many
    return err


def conv_library_fn(x, w_eff, geom, C, per_lane):
    """F.conv2d of x with the effective weights (cuDNN; no per-tile
    ADC): the library yardstick of B3."""
    import torch.nn.functional as F
    kh, kw, sh, sw, ph, pw, dh, dw = geom
    cout = w_eff.shape[-1]
    wk = w_eff.transpose(-1, -2).reshape(C * cout, -1, kh, kw).contiguous()
    if per_lane:
        n, ch, h, wd = x.shape[1:]
        xx = x.transpose(0, 1).reshape(n, C * ch, h, wd).contiguous()
        return lambda: F.conv2d(xx, wk, None, (sh, sw), (ph, pw), (dh, dw),
                                C)
    return lambda: F.conv2d(x, wk, None, (sh, sw), (ph, pw), (dh, dw))


def conv_rows(xs, geom):
    """M = N * OH * OW of a conv's im2col view, x of one lane `xs`."""
    n, _, h, wd = xs
    return n * ((h + 2 * geom[4] - geom[6] * (geom[0] - 1) - 1) // geom[2]
                + 1) * ((wd + 2 * geom[5] - geom[7] * (geom[1] - 1) - 1)
                        // geom[3] + 1)


def tiled_step_numbers(device, names, C=1, broken_byte=True,
                       cases=None, sigma=0.0, q_bits=2):
    """Per-step numbers of B2t (names ip1) or B3 (conv2, conv3) at C
    lanes (x shared at C = 1, per lane otherwise), ternary, sigma 0, as
    on the path (or the layers of `cases`, by default TILED_CASES, read
    at `sigma` and `q_bits`): kernel, plain version (`torch.matmul`
    partials, warmed, several calls), library call, bound, and the
    kernel's twin (the k-order plain read, one call) as `twin_ms`. The
    kernel
    is profiled over 25 calls at C = 1 and 10 at C > 1 (shorter windows
    read a kernel low). B2t and B3 get `broken` as one byte a cell, as
    the solver has it, unless `broken_byte` is false (an older checkout's
    native f32 mask). Also the largest |kernel - plain| on these inputs,
    each layer equal to plain."""
    import torch
    from rram_caffe_simulation_tpu_torch.fault import hw_aware as hw
    ms = plain = bound = lib = twin = 0.0
    err = 0.0
    bound_by = "bytes"
    for i, name in enumerate(names):
        xs, geom, K, N, tiles = (cases or TILED_CASES)[name]
        iters = 50 if C == 1 else 20
        x, w, br, st, _, seeds = tiled_operands(xs, C, C > 1, K, N, False,
                                                700 + i, device)
        if broken_byte:
            br = br > 0
        w_eff = hw._lane_w_eff(w, br, st, seeds, sigma, q_bits, None)
        args = (x, w, br, st, seeds, sigma, q_bits, None, geom, tiles)
        yk = tiled_forward(True, *args)
        # the kernel's twin (its partials emulated in float64, one k
        # step after another) timed by CUDA events over this one call
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        yp = tiled_forward(False, *args)
        t1.record()
        t1.synchronize()
        tw = t0.elapsed_time(t1)
        same, share, e_max = exact_gap(yk, yp)
        check(same, f"B2t/B3 differ from plain at C={C} {name} (share "
              f"{share:.2e}, max err {e_max})")
        err = max(err, e_max)
        del yk, yp
        torch.cuda.empty_cache()
        k, k_call = timed(lambda: tiled_forward(True, *args), iters)
        p, _ = timed(lambda: tiled_matmul_forward(*args), max(2, iters // 5))
        if geom is None:
            lib_fn = (lambda: torch.matmul(x, w_eff[0])) if C == 1 else \
                (lambda: torch.bmm(x, w_eff))
            M = xs[0]
            x_bytes = x.numel() * 4
        else:
            lib_fn = conv_library_fn(x, w_eff, geom, C, C > 1)
            M = conv_rows(xs, geom)
            x_bytes = x.numel() * 4 + (M + K) * 4          # + the plan
        lb, _ = timed(lib_fn, iters)
        # broken a byte a cell (f32 on an older checkout)
        f32_bytes = x_bytes + 4 * (3 * C * K * N + C * M * N)
        nbytes = f32_bytes - (3 * C * K * N if broken_byte else 0)
        flops = 2 * C * M * K * N
        tb, tf = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOP_PER_S * 1e3
        f32_note = (f"; {max(f32_bytes / HBM_BYTES_PER_S * 1e3, tf):.6f} with "
                    f"broken f32" if broken_byte else "")
        print(f"  {'B2t' if geom is None else 'B3'} C={C} {name} M,K,N="
              f"{M},{K},{N} tiles {tiles}: kernel {k:.5f} ms ({k_call:.5f} "
              f"ms per wrapper call), plain {p:.5f} ms (matmul partials; "
              f"the k-order twin {tw:.3f} ms, one call), library "
              f"{lb:.5f} ms, bound {max(tb, tf):.6f} ms (bytes {nbytes}: "
              f"{tb:.6f}; flop {flops}: {tf:.6f}{f32_note}); max |kernel - "
              f"plain| {e_max:.3e}", flush=True)
        if tf > tb:
            bound_by = "operations"
        ms, plain, bound, lib = ms + k, plain + p, bound + max(tb, tf), \
            lib + lb
        twin += tw
        del x, w, br, st, w_eff
    torch.cuda.empty_cache()
    return {"ms": ms, "plain_ms": plain, "bound_ms": bound,
            "bound_by": bound_by, "library_ms": lib, "twin_ms": twin}, err


def b2t_row_numbers(device, windows=5):
    """Kernel B2t's GEMM pass at 32 and 112 tile rows against each other
    at ip1's shape (tiles (128, 64, 8), ternary, sigma 0, broken a byte)
    for C = 1 (x shared) and the tiled sweep's 64 lanes (x per lane):
    device ms of one call in each of `windows` profiled windows of 20
    calls, the heights taken in turn, with the GEMM launches each window
    saw (20 when none was lost), beside `b2t_plan`'s choice. These are
    the measurements the plan follows; the heights give the same bits
    (phase 9)."""
    import torch
    from rram_caffe_simulation_tpu_torch.fault import hw_aware as hw
    M, K, N = B2_SHAPES["ip1"]
    tiles = TILED_CASES["ip1"][4]
    out = {}
    for C in (1, TILED_SWEEP_CONFIGS):
        x, w, br, st, _, seeds = tiled_operands((M, K), C, C > 1, K, N,
                                                False, 710, device)
        br = br > 0
        ms, seen = {32: [], 112: []}, {32: [], 112: []}
        for _ in range(windows):
            for bm in ms:
                t, n = device_ms(lambda: hw._launch_b2t(
                    x, w, br, st, seeds, 0.0, 2, None, tiles, bm=bm), 20,
                    count="crossbar_kernel")
                check(t is not None, f"the profiler saw no B2t call at {bm} "
                      f"rows")
                ms[bm].append(t)
                seen[bm].append(n)
        plan = hw.b2t_plan(C, M, K, N, tiles[0])
        print(f"  B2t tile rows C={C} ip1, ms a call in {windows} windows "
              f"(GEMM launches seen of 20): " + "; ".join(
                  f"{bm} rows " + ", ".join(
                      f"{v:.5f} ({n})" for v, n in zip(ms[bm], seen[bm]))
                  for bm in ms)
              + f"; the plan takes {plan} rows", flush=True)
        out[str(C)] = {"plan": plan, **{str(bm): ms[bm] for bm in ms},
                       "launches_seen": {str(bm): seen[bm] for bm in ms}}
        del x, w, br, st
        torch.cuda.empty_cache()
    return out


B3_PATH_KERNELS = B2T_PATH_KERNELS + ("weff_kernel",)   # its W_eff pass


def b3_path_numbers(device, C=1, own_kernels_only=True):
    """B3's `path_ms`: the device time of one step's conv2 and conv3 reads
    through `crossbar_conv_matmul` (C = 1) or `crossbar_conv_matmul_lanes`
    with the layers' tiles, wrapper passes included, from operands laid
    out as ops/vision.py hands them over: w, the bool broken mask and
    stuck in Caffe's stored (C, C_out, ch, kh, kw), turned by `to_im2col`;
    x (N, ch, H, W), or under lanes the (C, N, ch, H, W) view of the laned
    (N, C*ch, H, W) activation. Its bound counts the bytes as stored
    (broken one byte a cell) and the f32 FMAs. The pad of x
    (`pad_activation_flat`, its one copy) is timed within; it is also
    profiled alone, and with `own_kernels_only` each device activity of
    the path that is not B3's own (the scale, W_eff and GEMM passes, the
    ADC sum, the memset, the seed's host-to-card copy) must run as many
    times a call as in the pad alone: a copy, cast or amax of the wrapper
    adds launches even where it shares a name with the pad's. Also runs
    on an older checkout of the package (copy this script beside it)."""
    import torch
    from rram_caffe_simulation_tpu_torch.fault import hw_aware as hw
    from rram_caffe_simulation_tpu_torch.fault.mapping import (
        pad_activation_flat, to_im2col)
    ms = bound = 0.0
    names, pad, extra = set(), set(), []
    iters = 50 if C == 1 else 20
    for i, name in enumerate(("conv2", "conv3")):
        xs, geom, K, N, tiles = TILED_CASES[name]
        n, ch, h, wd = xs
        M = conv_rows(xs, geom)
        g = torch.Generator(device=device).manual_seed(270 + i)
        stored = (C, N, ch, geom[0], geom[1])
        w = torch.randn(stored, generator=g, device=device) * 0.1
        broken = torch.rand(stored, generator=g, device=device) < 0.1
        stuck = torch.randint(-1, 2, stored, generator=g,
                              device=device).float()
        wv, bv, sv = (to_im2col(t, 4) for t in (w, broken, stuck))
        seeds = torch.arange(C, dtype=torch.int32, device=device)
        if C == 1:
            x = torch.randn(xs, generator=g, device=device)
            fn = lambda: hw.crossbar_conv_matmul(
                x, wv[0], bv[0], sv[0], 0, 0.0, 2, tiles, geom)[None]
        else:
            xl = torch.randn((n, C * ch, h, wd), generator=g, device=device)
            x = xl.reshape(n, C, ch, h, wd).transpose(0, 1)
            fn = lambda: hw.crossbar_conv_matmul_lanes(
                x, wv, bv, sv, seeds, 0.0, 2, tiles, geom)
        with torch.no_grad():
            y = fn()
            yp = hw.crossbar_conv_forward_plain(x, wv, bv, sv, seeds, 0.0, 2,
                                                tiles, geom)
            same, share, e_max = exact_gap(y, yp)
            check(same, f"B3 on the path's layout differs from plain at "
                  f"C={C} {name} (share {share:.2e}, max err {e_max})")
            del y, yp
            torch.cuda.empty_cache()
            k, _ = timed(fn, iters)
            # launches a call by name (a lost event rounds up, a second
            # launch of a name a call does not)
            seen = {nm: -(-cnt // 10) for nm, (_, cnt) in
                    device_ms_by_name(fn, 10).items()}
            alone = {nm: -(-cnt // 10) for nm, (_, cnt) in device_ms_by_name(
                lambda: pad_activation_flat(x, geom), 10).items()}
        names |= set(seen)
        pad |= set(alone)
        extra += [f"{name} {nm}: {cnt} a call, the pad alone "
                  f"{alone.get(nm, 0)}" for nm, cnt in sorted(seen.items())
                  if not any(own in nm for own in B3_PATH_KERNELS)
                  and cnt != alone.get(nm, 0)]
        nbytes = 4 * x.numel() + 4 * (M + K) + 9 * C * K * N + 4 * C * M * N
        tb = nbytes / HBM_BYTES_PER_S * 1e3
        tf = 2 * C * M * K * N / F32_FLOP_PER_S * 1e3
        print(f"  B3 path C={C} {name} M,K,N={M},{K},{N} tiles {tiles}: "
              f"{k:.5f} ms on the card a read, wrapper passes included; "
              f"bound {max(tb, tf):.6f} ms (bytes as stored {nbytes}; flop "
              f"{2 * C * M * K * N})", flush=True)
        ms, bound = ms + k, bound + max(tb, tf)
        del x, w, broken, stuck, wv, bv, sv
        torch.cuda.empty_cache()
    print(f"  B3 path C={C}: device activities {sorted(names)}; of the pad "
          f"of x alone {sorted(pad)}; launches beyond B3's own and the "
          f"pad's {extra}", flush=True)
    if own_kernels_only:
        check(any("crossbar_kernel" in n for n in names),
              f"the profiler did not see B3 among {sorted(names)}")
        check(not extra, f"the B3 wrapper launched kernels that are not "
              f"its own or the pad's on the path's layout: {extra}")
    return {"path_ms": ms, "path_bound_ms": bound}


def b3_pass_numbers(device, C=1, windows=3):
    """Kernel B3's passes (the scale, W_eff, GEMM and ADC-sum passes, the
    memset, and the pad of x), at the conv2 and conv3 reads of C lanes
    (ternary, sigma 0, broken a byte, as `tiled_step_numbers`): ms a call
    of each device activity, summed over the two layers, in `windows`
    profiled windows of 20 calls at C = 1 and 10 at C > 1."""
    import torch
    from rram_caffe_simulation_tpu_torch.fault import hw_aware as hw
    iters = 20 if C == 1 else 10
    ops = []
    for i, name in enumerate(("conv2", "conv3")):
        xs, geom, K, N, tiles = TILED_CASES[name]
        x, w, br, st, _, seeds = tiled_operands(xs, C, C > 1, K, N, False,
                                                700 + i, device)
        ops.append((x, w, br > 0, st, seeds, tiles, geom))
    out = []
    for _ in range(windows):
        total = {}
        for x, w, br, st, seeds, tiles, geom in ops:
            got = device_ms_by_name(lambda: hw._launch_b3(
                x, w, br, st, seeds, 0.0, 2, None, tiles, geom), iters)
            for k, (v, _) in got.items():
                short = next((own for own in B3_PATH_KERNELS if own in k),
                             "pad of x" if "at::native" in k else k)
                total[short] = total.get(short, 0.0) + v
        out.append(total)
    print(f"  B3 C={C} passes, ms a call (conv2 + conv3) by activity, "
          f"{windows} windows: " + "; ".join(", ".join(
              f"{k} {v:.5f}" for k, v in sorted(w.items()))
              + f" (sum {sum(w.values()):.5f})" for w in out), flush=True)
    del ops
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phases 10 and 11: the tiled slice and the tiled sweep

TILED_LAYERS = {"ip1": (64, 128), "conv2": (128, 32), "conv3": (128, 64)}


def _tiled_per_step(C=1):
    """Launches a step of the tiled configuration (one launch per layer,
    B1 one for all ten fault leaves, whatever C is)."""
    return {"B2": 1, "B2t": 1, "B3": 2, "B1": 1, "B4": 0 if C == 1 else 1}


def phase_tiled_slice(steps, gpu):
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    s = slice_solver(1e8, 3e7, tiled=True)
    check(s._tiles_ctx() == TILED_LAYERS, f"tiles {s._tiles_ctx()}")
    check(s._step_fn.conv_im2col_resolved == "implicit",
          "the implicit operand did not engage")
    check(len(s.fault_state["life_q"]) == 10, "ten fault leaves expected")
    warm = min(2, steps - 1)
    kernels.reset_launches()
    losses, times = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.step(1)
        times.append(time.perf_counter() - t0)
        losses.append(s.last_loss)
    launches = _launches()
    losses = [float(v) for v in losses]
    q1, dt, q3 = (float(v) for v in np.percentile(times[warm:],
                                                  [25, 50, 75]))
    want = {k: v * steps for k, v in _tiled_per_step().items()}
    print(f"phase 10: tiled CIFAR-10-quick ({TILES}, ADC 8 bits, conv_also, "
          f"implicit conv operand), batch 100, ternary, packed int32 banks, "
          f"fused epilogue: {steps} steps, losses "
          f"{[round(v, 5) for v in losses[:5]]} ... {losses[-1]:.5f}",
          flush=True)
    print(f"phase 10: step time median {dt * 1e3:.3f} ms (quartiles "
          f"{q1 * 1e3:.3f} / {q3 * 1e3:.3f} ms, n = {steps - warm}; {gpu}); "
          f"launches {launches}", flush=True)
    check(all(math.isfinite(v) for v in losses), "non-finite loss")
    # the first step reads the cells dead at init (N(1e8, 3e7), 0.043%)
    # at their stuck values against the tiny weights' ternary scale
    # (seed 1 has a conv1 cell at -1 among std-1e-4 weights), so it is
    # held to the torch engine's first step from the same seed; from the
    # second step Fail has put them in the weights and their scale, and
    # the near-zero init reads ln(10)
    ref = slice_solver(1e8, 3e7, tiled=True, hw_engine="torch")
    kernels.reset_launches()
    ref.step(1)
    check(_launches() == _untiled(B2=0, B1=0, B4=0),
          "the torch engine launched a kernel")
    ref_loss = float(ref.last_loss)
    del ref
    first_rel = abs(losses[0] - ref_loss) / max(1.0, abs(ref_loss))
    check(first_rel <= 1e-5, f"first loss {losses[0]} against the torch "
          f"engine's {ref_loss}")
    check(abs(losses[1] - math.log(10)) < 0.05,
          f"second loss {losses[1]} far from ln(10) at a near-zero init")
    print(f"phase 10: first loss {losses[0]:.6f} within {first_rel:.2e} "
          f"relative of the torch engine's first step (limit 1e-5); second "
          f"{losses[1]:.6f} against ln(10) (limit 0.05)", flush=True)
    check(launches == want, f"launches {launches} in {steps} steps, "
          f"expected {want}")
    bd = step_breakdown(s)
    bd["idle_share"] = max(0.0, 1 - bd["device_busy_ms"] / (dt * 1e3))
    print(f"phase 10: host feed {bd['feed_ms']:.3f} ms; kernels on the card "
          f"{bd['device_busy_ms']:.3f} ms/step ({bd['idle_share']:.1%} of "
          f"the step idle); top device kernels: {bd['top']}", flush=True)
    lock = tiled_lockstep(6)
    s2 = slice_solver(1e8, 3e7, sigma=0.05, seed=2, tiled=True)
    kernels.reset_launches()
    s2.step(3)
    torch.cuda.synchronize()
    got = _launches()
    check(got == {k: 3 * v for k, v in _tiled_per_step().items()}
          and math.isfinite(s2.smoothed_loss),
          f"sigma = 0.05 tiled run: launches {got}")
    print(f"phase 10: sigma 0.05 tiled run, 3 steps, loss "
          f"{s2.smoothed_loss:.5f}, launches {got}", flush=True)
    return {"median_ms": dt * 1e3, "q1_ms": q1 * 1e3, "q3_ms": q3 * 1e3,
            "losses_first_last": [losses[0], losses[-1]],
            "first_loss_rel_torch": first_rel,
            "launches": launches, **bd, **lock}


def tiled_lockstep(steps):
    """At N(300, 50) (int16 banks, cells die within a few writes): from
    one state and batch each step, the "cuda" engine against "torch"
    (plain versions) and the premat operand against implicit. life_q
    must be identical every step; premat and implicit are the same
    kernel over the same operand values, so their losses must be equal
    too; the plain path's losses are reported (the ADC can move a level
    where the two sum in other orders)."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.core import prng
    a = slice_solver(300.0, 50.0, seed=5, tiled=True)
    check(a.pack_spec["life_dtype"] == "int16", "mean 300 banks are int16")
    opts = dict(dtype_policy="ternary", fault_format="packed",
                pack_spec=a.pack_spec, fused_epilogue=True)
    steps_by = {"implicit": a.make_train_step(hw_engine="cuda", **opts,
                                              conv_im2col="implicit"),
                "premat": a.make_train_step(hw_engine="cuda", **opts,
                                            conv_im2col="premat"),
                "torch": a.make_train_step(hw_engine="torch", **opts,
                                           conv_im2col="implicit")}
    expect = {"implicit": _tiled_per_step(),
              "premat": {**_tiled_per_step(), "B2t": 3, "B3": 0},
              "torch": _untiled(B2=0, B1=0, B4=0)}
    state = (a.params, a.history, a.fault_state)
    worst = 0.0
    for i in range(steps):
        batch = {k: torch.as_tensor(v).to(a.device)
                 for k, v in a.train_feed().items()}
        out = {}
        rng = prng.fold_in(a._key, i)
        for name, fn in steps_by.items():
            kernels.reset_launches()
            out[name] = fn(*state, batch, i, rng)
            got = _launches()
            check(got == expect[name], f"{name} step launches {got}")
        ki, kp, pl = (out[n] for n in ("implicit", "premat", "torch"))
        check(float(ki[3]) == float(kp[3]), f"step {i}: premat loss "
              f"{float(kp[3])} != implicit {float(ki[3])}")
        worst = max(worst, abs(float(ki[3]) - float(pl[3]))
                    / max(1.0, abs(float(pl[3]))))
        for k in ki[2]["life_q"]:
            for name in ("premat", "torch"):
                check(torch.equal(ki[2]["life_q"][k],
                                  out[name][2]["life_q"][k]),
                      f"step {i}: life_q of {name} differs on {k}")
        state = ki[:3]
    a.params, a.history, a.fault_state = state
    frac = a.broken_fraction()
    check(frac > 0, "no cell broke")
    print(f"phase 10: lockstep at N(300, 50), int16 banks, {steps} steps: "
          f"life_q identical cuda vs torch engine and premat vs implicit at "
          f"every step; premat and implicit losses equal; cuda vs torch "
          f"loss max rel diff {worst:.2e} (reported); broken fraction "
          f"{frac:.4f}", flush=True)
    return {"lockstep_loss_rel_cuda_vs_torch": worst,
            "lockstep_broken_fraction": frac}


TILED_SWEEP_CONFIGS = 64


def phase_tiled_sweep(C, timed_steps, gpu):
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.parallel import SweepRunner
    saved = os.environ.get("RRAM_POOL_BWD")
    os.environ["RRAM_POOL_BWD"] = "cuda"
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        r = SweepRunner(slice_solver(1e8, 3e7, tiled=True), n_configs=C,
                        engine="cuda", packed_state=True,
                        dtype_policy="ternary", conv_im2col="implicit")
        setup_s = time.perf_counter() - t0
        check(r.engine_resolved == "cuda" and r.fused_epilogue_resolved
              and r.conv_im2col_resolved == "implicit",
              "the tiled sweep did not resolve to cuda, fused, implicit")
        check(r._dataset is not None, "the dataset is not on the device")
        warm = r.step(SWEEP_CHUNK, chunk=SWEEP_CHUNK)[0]
        check(bool(np.isfinite(warm).all()), "non-finite warm-chunk loss")
        events = []
        inner, stepper = _event_stepper(r, events)
        r._step = stepper
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        kernels.reset_launches()
        start.record()
        t0 = time.perf_counter()
        losses = r.step(timed_steps, chunk=SWEEP_CHUNK)[0]
        wall = time.perf_counter() - t0
        launches = _launches()
        r._step = inner
        step_ms = [a.elapsed_time(b) for a, b in zip([start] + events[:-1],
                                                     events)]
        want = {k: v * timed_steps for k, v in _tiled_per_step(C).items()}
        check(losses.shape == (C,) and bool(np.isfinite(losses).all()),
              "non-finite or misshapen tiled sweep losses")
        check(launches == want, f"launches {launches} in {timed_steps} "
              f"steps, expected {want}")
        q1, med, q3 = (float(v) for v in np.percentile(step_ms,
                                                       [25, 50, 75]))
        peak = int(torch.cuda.max_memory_allocated())
        bd = sweep_breakdown(r)
        lanes = tiled_lane_check(r, 2)
    finally:
        if saved is None:
            os.environ.pop("RRAM_POOL_BWD", None)
        else:
            os.environ["RRAM_POOL_BWD"] = saved
    out = {"configs": C, "chunk": SWEEP_CHUNK, "timed_steps": timed_steps,
           "configs_steps_per_s": C * timed_steps / wall, "wall_s": wall,
           "step_ms_median": med, "step_ms_q1": q1, "step_ms_q3": q3,
           "peak_mem_bytes": peak,
           "bytes_per_step_est": r.bytes_per_step_est(),
           "conv_patch_bytes_est": r.conv_patch_bytes_est(),
           "setup_s": setup_s, "launches": launches, **bd,
           "device_idle_share": max(0.0, 1 - bd["device_busy_ms"] / med),
           "lanes_checked": lanes, "gpu": gpu}
    del r
    torch.cuda.empty_cache()
    print(f"phase 11: tiled sweep, C = {C}, {TILES}, ADC 8 bits, implicit "
          f"conv operand, N(1e8, 3e7), ternary, packed banks, fused "
          f"epilogue, RRAM_POOL_BWD=cuda, chunk {SWEEP_CHUNK}: "
          f"{out['configs_steps_per_s']:.1f} configs*steps/s over "
          f"{timed_steps} steps; step median {med:.3f} ms (quartiles "
          f"{q1:.3f} / {q3:.3f}); peak memory {peak / 1e9:.2f} GB; "
          f"bytes_per_step_est {out['bytes_per_step_est']}; launches "
          f"{launches}; {gpu}", flush=True)
    print(f"phase 11: kernels on the card {bd['device_busy_ms']:.3f} ms/step "
          f"({out['device_idle_share']:.1%} idle); top device kernels: "
          f"{bd['top']}; lanes {lanes} equal to a single-config Solver from "
          "their state (life_q identical)", flush=True)
    return out


def tiled_lane_check(r, steps):
    """Lanes 0 and C-1 of the tiled sweep against a single-config tiled
    Solver started from their state, one step at a time in lockstep:
    life_q identical."""
    import torch
    C = r.n
    single = slice_solver(1e8, 3e7, seed=3, tiled=True)
    check(single.pack_spec == r._pack_spec, "pack specs differ")
    lanes = [0, C - 1]
    for _ in range(steps):
        batch = r._batch(r.iter)
        before = {i: r.lane_state(i) for i in lanes}
        keys = r.lane_keys(r.iter)
        kp, kh, kf, kl, _ = r._step(r.params, r.history, r.fault_states,
                                    batch, r.iter, keys)
        for i in lanes:
            _, _, sf, sl, _ = single._step_fn(*before[i], batch, r.iter,
                                              keys[i])
            rel = abs(float(sl) - float(kl[i])) / max(1.0, abs(float(sl)))
            check(rel <= 1e-4, f"lane {i}: sweep loss {float(kl[i])} vs "
                  f"Solver {float(sl)}")
            for k in sf["life_q"]:
                check(torch.equal(sf["life_q"][k], kf["life_q"][k][i]),
                      f"lane {i}: banks differ from Solver's on {k}")
        r._commit(kp, kh, kf, kl)
        r.iter += 1
    return lanes

# ---------------------------------------------------------------------------
# phase 12: the mitigation strategies and the test nets

STRATEGY_STEPS = 10         # steps of each run (b) and (c)
ALL_STRATEGIES_STEPS = 20   # steps of run (d), lockstep and timed
EDGE_REL = 1e-5             # a threshold cell within this of its cutoff


def strategy_files(tmp, seed=7):
    """(prune order, prune net, prune model) in `tmp`: a seeded
    permutation of ip1's 64 outputs, the solver's net, and a .caffemodel
    of it written by the port's encode, ip1/ip2 at seeded magnitudes
    with the smaller half zero."""
    import torch
    from rram_caffe_simulation_tpu_torch import proto
    from rram_caffe_simulation_tpu_torch.core import prng
    from rram_caffe_simulation_tpu_torch.net import Net
    from rram_caffe_simulation_tpu_torch.utils.io import (
        read_net_param, read_solver_param, write_proto_binary)
    order = tmp / "prune_order.txt"
    order.write_text(" ".join(
        str(v) for v in np.random.RandomState(seed).permutation(64)) + "\n")
    net_file = read_solver_param(SOLVER).net
    net = Net(read_net_param(net_file), proto.TRAIN, device="cpu")
    params = net.init(prng.PRNGKey(seed))
    for ln in ("ip1", "ip2"):
        w = params[ln][0].abs()
        params[ln][0] = torch.where(w < w.median(), 0.0, w)
    model = tmp / "prune.caffemodel"
    write_proto_binary(str(model), net.to_proto(params))
    return str(order), net_file, str(model)


def _lr_mults(s):
    return {f"{r.layer_name}/{r.slot}": r.lr_mult for r in s._owner_refs}


@contextlib.contextmanager
def threshold_inputs():
    """A list that takes the fault-leaf updates each threshold_diffs
    call is given (the updates before ApplyStrategy) while the context
    is open."""
    from rram_caffe_simulation_tpu_torch.fault import strategies
    seen, threshold_diffs = [], strategies.threshold_diffs

    def spy(diffs, *args):
        seen.append(diffs)
        return threshold_diffs(diffs, *args)

    strategies.threshold_diffs = spy
    try:
        yield seen
    finally:
        strategies.threshold_diffs = threshold_diffs


def calibrate_threshold(seed):
    """The median over the fault leaves' cells of |update| / (rate *
    lr_mult) at the first step (torch engine), to three digits: a
    threshold that zeroes a share of the updates between 0 and 1."""
    import torch
    from rram_caffe_simulation_tpu_torch.core import prng
    s = slice_solver(300.0, 50.0, seed=seed,
                     strategies=[{"type": "threshold"}])
    step = s.make_train_step(hw_engine="torch", dtype_policy="ternary",
                             fault_format="packed", pack_spec=s.pack_spec,
                             fused_epilogue=True)
    batch = {k: torch.as_tensor(v).to(s.device)
             for k, v in s.train_feed().items()}
    with threshold_inputs() as seen:
        step(s.params, s.history, s.fault_state, batch, 0,
             prng.fold_in(s._key, 0))
    rate, mults = s._lr_fn(0), _lr_mults(s)
    ratio = torch.cat([(u.abs() / (rate * mults[k])).flatten()
                       for k, u in seen[0].items()])
    return float(f"{float(ratio.median()):.3g}")


def _edge_cells(s, updates, it, state, due):
    """Fault cells whose "torch"-engine update lies within EDGE_REL of
    the threshold cutoff, in the cells' places after a remap (the mask
    moves as the updates do); and the share of updates zeroed."""
    from rram_caffe_simulation_tpu_torch.fault import packed, strategies
    st = s.strategies
    rate, mults = s._lr_fn(it), _lr_mults(s)
    edge, zeroed, cells = {}, 0, 0
    for k, u in updates.items():
        cut = strategies.threshold_cutoff(st.threshold, rate, mults[k])
        edge[k] = (u.abs() - cut).abs() <= EDGE_REL * cut
        zeroed += int((u.abs() <= cut).sum())
        cells += u.numel()
    if due:
        weights = [w for w, _ in s.fc_pairs]
        view = packed.unpacked_view(state, s.pack_spec, weights)
        args = (edge, edge, view, s.fc_pairs, st.prune_orders)
        edge = (strategies.remap_fc_neurons_tracked(
            *args, state["remap_slots"])[1] if st.remap_tracked
            else strategies.remap_fc_neurons(*args)[1])
    return edge, zeroed / cells


def count_syncs(fn, *args):
    """(fn(*args), the synchronizing CUDA calls it made), by torch's
    sync debug mode."""
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("synchroniz" in str(w.message) for w in caught)


def step_syncs(s):
    """The synchronizing calls of one "cuda" step of solver `s` (its
    second, from its state, the state not advanced)."""
    import torch
    from rram_caffe_simulation_tpu_torch.core import prng
    batch = {k: torch.as_tensor(v).to(s.device)
             for k, v in s.train_feed().items()}
    rng = prng.fold_in(s._key, s.iter)
    for _ in range(2):
        _, n = count_syncs(s._step_fn, s.params, s.history, s.fault_state,
                           batch, s.iter, rng)
    return n


def strategy_lockstep(s, steps, name, base_syncs):
    """Run `name` for `steps` steps: each step, the "torch" and the
    "cuda" step from the same state and batch, both on the card (the
    genetic search first on its iterations, on the shared state), then
    the "cuda" result goes on. The "cuda" step makes no more
    synchronizing CUDA calls than `base_syncs` (a step without a
    strategy) after the first. Per step: life_q identical (a threshold
    run may differ only on cells at the cutoff's edge, counted),
    remap_slots identical, losses and params within 1e-5 relative, the
    "cuda" step launching B2 twice and B1 once and the "torch" step no
    kernel, every result on the card."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.core import prng
    from rram_caffe_simulation_tpu_torch.fault import fused, hw_aware
    opts = dict(dtype_policy="ternary", fault_format="packed",
                pack_spec=s.pack_spec, fused_epilogue=True)
    kstep = s.make_train_step(hw_engine="cuda", **opts)
    pstep = s.make_train_step(hw_engine="torch", **opts)
    st = s.strategies
    out = {"steps": steps, "remap_events": 0, "genetic_applications": 0,
           "edge_cells": 0, "edge_flips": 0, "zeroed_share": [],
           "host_syncs": []}
    masks0 = ([m.copy() for m in st.genetic.prune_weights] if st.genetic
              else None)
    for i in range(steps):
        it = s.iter
        if st.genetic is not None and st.genetic.due():
            s._apply_genetic(st.genetic)
            out["genetic_applications"] += 1
        state = (s.params, s.history, s.fault_state)
        batch = {k: torch.as_tensor(v).to(s.device)
                 for k, v in s.train_feed().items()}
        due = s._remap_due_at(it)
        out["remap_events"] += due
        rng = prng.fold_in(s._key, it)      # Solver.step's key, both steps
        kernels.reset_launches()
        with threshold_inputs() as seen:
            pp, _, pf, pl, _ = pstep(*state, batch, it, rng)
        check(hw_aware.CROSSBAR_LIB.launches == 0
              and fused.FUSED_LIB.launches == 0,
              f"{name} step {i}: the torch engine launched a kernel")
        (kp, kh, kf, kl, _), syncs = count_syncs(kstep, *state, batch, it,
                                                 rng)
        out["host_syncs"].append(syncs)
        b2, b1 = hw_aware.CROSSBAR_LIB.launches, fused.FUSED_LIB.launches
        check(b2 == 2 and b1 == 1, f"{name} step {i}: launches B2 {b2}, "
              f"B1 {b1} (expected 2 and 1)")
        check(all(t.is_cuda for g in kf.values() for t in g.values()),
              f"{name} step {i}: fault state left the card")
        kl, pl = float(kl), float(pl)
        check(abs(kl - pl) <= 1e-5 * max(1.0, abs(pl)),
              f"{name} step {i}: lockstep losses {kl} vs {pl}")
        edge = {}
        if st.threshold is not None:
            edge, share = _edge_cells(s, seen[0], it, state[2], due)
            out["zeroed_share"].append(share)
            out["edge_cells"] += sum(int(m.sum()) for m in edge.values())
        for ln, vals in kp.items():
            for slot, (a, b) in enumerate(zip(vals, pp[ln])):
                if a is None:
                    continue
                far = (a - b).abs() > 1e-5 * b.abs().clamp(min=1.0)
                if f"{ln}/{slot}" in edge:
                    far &= ~edge[f"{ln}/{slot}"]
                check(a.is_cuda and not bool(far.any()),
                      f"{name} step {i}: params of {ln}/{slot} differ")
        for k in kf["life_q"]:
            differ = kf["life_q"][k] != pf["life_q"][k]
            if k in edge:
                out["edge_flips"] += int(differ.sum())
                differ &= ~edge[k]
            check(not bool(differ.any()),
                  f"{name} step {i}: life_q differs on {k} off the "
                  "threshold's edge")
        for g, v in kf.get("remap_slots", {}).items():
            check(torch.equal(v, pf["remap_slots"][g]),
                  f"{name} step {i}: remap_slots[{g}] differ")
        s.params, s.history, s.fault_state = kp, kh, kf
        s.iter += 1
    if masks0 is not None:
        out["genetic_masks_changed"] = any(
            not np.array_equal(a, b)
            for a, b in zip(masks0, st.genetic.prune_weights))
    syncs = out["host_syncs"]
    check(max(syncs[1:]) <= base_syncs,
          f"{name}: synchronizing calls a step {syncs}, more than the "
          f"{base_syncs} of a step without a strategy after the first")
    out["host_syncs"] = {"first_step": syncs[0], "max_later": max(syncs[1:]),
                         "without_strategy": base_syncs}
    if out["zeroed_share"]:
        z = out["zeroed_share"]
        out["zeroed_share"] = [min(z), float(np.mean(z)), max(z)]
    return out


def check_stable_sort(s):
    """The card's neuron order (sort_fc_neurons) against numpy's stable
    argsort of the same counts, on the run's last state: the counts are
    full of ties."""
    from rram_caffe_simulation_tpu_torch.fault import (engine, packed,
                                                       strategies)
    weights = [w for w, _ in s.fc_pairs]
    view = packed.unpacked_view(s.fault_state, s.pack_spec, weights)
    order = strategies.sort_fc_neurons(view, weights)[0].cpu().numpy()
    counts = (engine.stuck_zero_flags(view, weights[0]).sum(1)
              + engine.stuck_zero_flags(view, weights[1]).sum(0))
    counts = counts.cpu().numpy()
    check(np.array_equal(order, np.argsort(counts, kind="stable")),
          "sort_fc_neurons on the card is not the stable order")
    return int(len(counts) - len(np.unique(counts)))


def phase_strategies(gpu, phase4_ms=None):
    """Phase 12: CIFAR-10-quick at full width (batch 100, ternary read,
    packed banks, fused epilogue, engine "cuda"), N(300, 50) lifetimes,
    through the failure strategies: (a) threshold, (b) remapping start 5
    period 5 untracked and tracked, (c) genetic start 3 period 5
    switch_time 50, (d) all three, each in lockstep against the "torch"
    engine; then (d) timed through Solver.step, and test_all on
    cifar10_test_lmdb."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        return _phase_strategies(Path(tmp), gpu, phase4_ms)


def _phase_strategies(tmp, gpu, phase4_ms):
    import torch
    order, net_file, model = strategy_files(tmp)
    thr = calibrate_threshold(seed=12)
    threshold = {"type": "threshold", "threshold": thr}
    remap = {"type": "remapping", "start": 5, "period": 5,
             "prune_order_file": order}
    genetic = {"type": "genetic", "start": 3, "period": 5,
               "switch_time": 50, "prune_net_file": net_file,
               "prune_model_file": model}
    runs = {
        "a_threshold": ([threshold], 6),
        "b_remap": ([remap], STRATEGY_STEPS),
        "b_remap_tracked": ([{**remap, "track_identity": True}],
                            STRATEGY_STEPS),
        "c_genetic": ([genetic], STRATEGY_STEPS),
        "d_all": ([threshold, {**remap, "track_identity": True}, genetic],
                  ALL_STRATEGIES_STEPS),
    }
    res = {}
    base_syncs = step_syncs(slice_solver(300.0, 50.0, seed=12))
    for name, (entries, steps) in runs.items():
        s = slice_solver(300.0, 50.0, seed=12, strategies=entries)
        res[name] = strategy_lockstep(s, steps, name, base_syncs)
        if name.startswith("b_"):
            res[name]["tied_counts"] = check_stable_sort(s)
        print(f"phase 12: {name}: {json.dumps(res[name])}", flush=True)
    a, d = res["a_threshold"], res["d_all"]
    check(0 < a["zeroed_share"][0] and a["zeroed_share"][2] < 1,
          f"threshold {thr} zeroed {a['zeroed_share']} of the updates")
    for name in ("b_remap", "b_remap_tracked", "d_all"):
        check(res[name]["remap_events"] >= 2, f"{name}: too few remaps")
    for name in ("c_genetic", "d_all"):
        check(res[name]["genetic_applications"] >= 2,
              f"{name}: too few genetic applications")

    # (d) timed through Solver.step, in turns with the same slice and
    # no strategy (single-config steps are host-bound and drift within
    # a call, so only a paired reading compares them)
    base = slice_solver(300.0, 50.0, seed=13)
    s = slice_solver(300.0, 50.0, seed=13, strategies=runs["d_all"][0])
    kinds = []
    g = s.strategies.genetic
    for it in range(ALL_STRATEGIES_STEPS):
        times_ = it + 1
        kinds.append("genetic" if times_ >= g.start
                     and (times_ - g.start) % g.period == 0
                     else "remap" if s._remap_due_at(it) else "threshold")
    ms = {"none": [], "all": []}
    for _ in range(ALL_STRATEGIES_STEPS):
        for key, x in (("none", base), ("all", s)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x.step(1)           # ends in a host read of the loss: synced
            ms[key].append((time.perf_counter() - t0) * 1e3)
    warm = 2

    def quartiles(v):
        q1, med, q3 = np.percentile(v, [25, 50, 75])
        return {"median": float(med), "q1": float(q1), "q3": float(q3),
                "n": len(v)}

    step_ms = {k: quartiles(v[warm:]) for k, v in ms.items()}
    step_ms["all_minus_none_paired"] = quartiles(
        np.subtract(ms["all"], ms["none"])[warm:])
    for kind in ("threshold", "remap", "genetic"):
        step_ms[f"all_{kind}_steps"] = quartiles(
            [t for t, k in zip(ms["all"][warm:], kinds[warm:]) if k == kind])
    busy = {"none": step_breakdown(base), "all": step_breakdown(s)}
    s.test_all()                                   # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = s.test_all()[0]
    torch.cuda.synchronize()
    test_ms = (time.perf_counter() - t0) * 1e3
    check(math.isfinite(scores["loss"]) and 0 <= scores["accuracy"] <= 1,
          f"test_all gave {scores}")
    out = {"threshold": thr, "runs": res, "step_ms": step_ms,
           "phase4_step_ms": phase4_ms,
           "device_busy_ms": {k: v["device_busy_ms"]
                              for k, v in busy.items()},
           "top_kernels_all": busy["all"]["top"],
           "test": {"accuracy": scores["accuracy"], "loss": scores["loss"],
                    "forward_ms": test_ms, "test_iter": s.param.test_iter[0],
                    "batch": 100},
           "gpu": gpu}
    a, n = step_ms["all"], step_ms["none"]
    print(f"phase 12: all strategies, step time median {a['median']:.3f} "
          f"ms (quartiles {a['q1']:.3f} / {a['q3']:.3f}) against "
          f"{n['median']:.3f} ms ({n['q1']:.3f} / {n['q3']:.3f}) without "
          f"one, in turns; paired difference median "
          f"{step_ms['all_minus_none_paired']['median']:.3f} ms; kernels "
          f"on the card {busy['all']['device_busy_ms']:.3f} against "
          f"{busy['none']['device_busy_ms']:.3f} ms a step; test_all "
          f"accuracy {scores['accuracy']:.4f}, loss {scores['loss']:.5f}, "
          f"forward {test_ms:.3f} ms; {gpu}", flush=True)
    print(json.dumps({"strategies": out}), flush=True)
    return out


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 13: the RNG bridge on the card

RNG_SHAPES = [(1,), (63,), (2 ** 20 + 3,)]
RNG_LANES = 512, (64, 1024)      # the sweep's ip1 draw: 512 keys x (64, 1024)
RNG_ROWS = 0, 255, 511           # its rows the CPU draws too
RNG_SOLVER_STEPS = 20
# phase 4's median step before the key chain (one torch.Generator for
# every draw), H100 80GB HBM3 at 700 W
PHASE4_BEFORE_MS = "9.7-11.8"


def _same_bits(a, b) -> bool:
    import torch
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


def rng_primitives(device):
    """random_bits, uniform, normal and bernoulli drawn on the card
    against the same draws on the CPU, bit for bit, at each shape (the
    small ones also forced onto the card: below prng.SMALL_DRAW a draw
    runs on the host). Returns the card's ms for the largest draw."""
    import torch
    from rram_caffe_simulation_tpu_torch.core import prng
    key = prng.PRNGKey(7)
    samplers = {
        "random_bits": lambda k, sh, d: prng.random_bits(k, sh, d),
        "uniform": lambda k, sh, d: prng.uniform(k, sh, -0.37, 0.81, d),
        "normal": lambda k, sh, d: prng.normal(k, sh, d),
        "bernoulli": lambda k, sh, d: prng.bernoulli(k, 0.3, sh, d)}
    lanes, block = RNG_LANES
    # a batch of keys draws one block per key: its rows are the rows'
    # keys' own draws, so the CPU draws a few rows, the card all of them
    cases = [(key, sh, None) for sh in RNG_SHAPES] + [
        (prng.split(key, lanes), block, list(RNG_ROWS))]
    small = prng.SMALL_DRAW
    ms = {}
    for k, sh, rows in cases:
        label = "x".join(map(str, np.asarray(k).shape[:-1] + sh))
        for name, fn in samplers.items():
            want = fn(k if rows is None else k[rows], sh, "cpu")
            for force in (False, True):
                prng.SMALL_DRAW = 0 if force else small
                try:
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    got = fn(k, sh, device)
                    torch.cuda.synchronize()
                    took = (time.perf_counter() - t0) * 1e3
                finally:
                    prng.SMALL_DRAW = small
                check(got.is_cuda and _same_bits(
                    got if rows is None else got[rows], want),
                    f"{name} {label}: the card's draw is not the CPU's")
                if want.numel() >= small:
                    break
            ms[f"{name} {label}"] = took
    return ms


def key_chain_host_us(lanes=0, reps=640, blocked=True):
    """Host microseconds a step spends deriving its keys (CIFAR-10-quick's
    four fault keys, crossbar seeds for ip1 and ip2): the step key (one
    per lane under lanes), the noise keys and the randint seeds; as the
    solver's StepNoise does, a block of iterations per numpy pass, or
    (blocked=False) each step on its own."""
    from rram_caffe_simulation_tpu_torch.core import prng
    from rram_caffe_simulation_tpu_torch.solver import solver as solver_mod
    key, noise = prng.PRNGKey(7), solver_mod.StepNoise(4, [0, 2])

    def plain(it):
        rng = prng.fold_in(key, it)
        if lanes:
            rng = prng.fold_in(rng[None], np.arange(lanes))
        prng.randint(solver_mod.noise_keys(rng, 4)[..., [0, 2], :])
    t0 = time.perf_counter()
    for it in range(reps):
        if blocked:
            noise(noise.step_key(key, it, lanes))
        else:
            plain(it)
    return (time.perf_counter() - t0) / reps * 1e6


def rng_solver(gpu):
    """The main path's Solver (seed 7) built on the card and on the CPU:
    params and packed banks bit-identical, the crossbar seeds the card's
    steps hand their reads equal to the CPU solver's key chain, and
    RNG_SOLVER_STEPS card steps through B2a (2 a step) and B1a (1)."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.core import prng
    from rram_caffe_simulation_tpu_torch.fault import fused, hw_aware
    from rram_caffe_simulation_tpu_torch.ops import common
    from rram_caffe_simulation_tpu_torch.solver import solver as solver_mod
    built = {}
    for dev in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        built[dev] = slice_solver(1e8, 3e7, seed=7, device=dev)
        torch.cuda.synchronize()
        built[dev + "_s"] = time.perf_counter() - t0
    card, host = built["cuda"], built["cpu"]
    check(np.array_equal(card._key, host._key), "solver keys differ")
    for ln, vals in host.params.items():
        for i, t in enumerate(vals):
            check(card.params[ln][i].is_cuda
                  and _same_bits(card.params[ln][i], t),
                  f"params of {ln}/{i}: the card's draw is not the CPU's")
    for g, leaves in host.fault_state.items():
        for k, t in leaves.items():
            check(card.fault_state[g][k].is_cuda
                  and _same_bits(card.fault_state[g][k], t),
                  f"fault state {g}/{k}: the card's is not the CPU's")
    seeds, real = [], common.crossbar_matmul

    def spy(x, w, broken, stuck, seed, *rest):
        seeds.append(seed)
        return real(x, w, broken, stuck, seed, *rest)
    common.crossbar_matmul = spy
    kernels.reset_launches()
    times = []
    try:
        for _ in range(RNG_SOLVER_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            card.step(1)        # ends in a host read of the loss: synced
            times.append(time.perf_counter() - t0)
    finally:
        common.crossbar_matmul = real
    step_ms = float(np.median(times[2:])) * 1e3
    b2, b1 = hw_aware.CROSSBAR_LIB.launches, fused.FUSED_LIB.launches
    check(b2 == 2 * RNG_SOLVER_STEPS and b1 == RNG_SOLVER_STEPS,
          f"{RNG_SOLVER_STEPS} steps launched B2 {b2}, B1 {b1}")
    check(math.isfinite(card.smoothed_loss), "non-finite loss")
    idx = [i for i, k in enumerate(host._fault_keys)
           if k in host._crossbar_keys]
    want = [int(v) for it in range(RNG_SOLVER_STEPS)
            for v in prng.randint(solver_mod.noise_keys(
                prng.fold_in(host._key, it), max(idx) + 1)[idx])]
    check(seeds == want, f"crossbar seeds {seeds[:4]}... are not the CPU "
          f"solver's {want[:4]}...")
    return {"build_cuda_s": built["cuda_s"], "build_cpu_s": built["cpu_s"],
            "steps": RNG_SOLVER_STEPS, "step_ms": step_ms,
            "launches": {"B2": b2, "B1": b1}, "seeds_checked": len(want)}


def generator_loop_draw(shapes, pattern, C, device, seed=1):
    """The fault-state draw the key chain replaced, kept to time beside
    it: lane by lane and param by param from one CPU torch.Generator
    (N(0, 1) then uniform per param), stacked and copied to the card."""
    import torch
    from rram_caffe_simulation_tpu_torch.fault import engine
    gen = torch.Generator().manual_seed(seed)
    s1, s2 = engine.stuck_splits(pattern)
    mean, std = float(pattern.mean), float(pattern.std)
    lanes = []
    for _ in range(C):
        life, stuck = {}, {}
        for name, shape in shapes.items():
            life[name] = mean + std * torch.randn(shape, generator=gen)
            u = torch.rand(shape, generator=gen)
            stuck[name] = torch.where(u < s1, -1.0,
                                      torch.where(u < s2, 0.0, 1.0))
        lanes.append((life, stuck))
    return {g: {k: torch.stack([ln[j][k] for ln in lanes]).to(device)
                for k in shapes}
            for j, g in enumerate(("lifetimes", "stuck"))}


def rng_sweep(device, C, tiled):
    """The sweep's fault-state draw at C lanes on the card, timed (the
    SweepRunner's own call), rows 0 and C - 1 drawn alone and held to
    the full draw bit for bit; untiled, the replaced generator loop is
    timed beside it."""
    import torch
    from rram_caffe_simulation_tpu_torch.core import prng
    from rram_caffe_simulation_tpu_torch.fault import engine
    from rram_caffe_simulation_tpu_torch.parallel.sweep import SWEEP_FOLD
    s = slice_solver(1e8, 3e7, tiled=tiled)
    flat = s._flat(s.params)
    shapes = {k: tuple(flat[k].shape) for k in s._fault_keys}
    key = prng.fold_in(s._key, SWEEP_FOLD)
    pattern = s.param.failure_pattern

    def draw(rows=None):
        return engine.stack_fault_states(key, shapes, pattern, C, rows=rows,
                                         tiles=s.tile_spec, device=device)
    draw((0, 1))                                 # warm the card's kernels
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    full = draw()
    torch.cuda.synchronize()
    out = {"C": C, "tiled": tiled, "cells": sum(
        int(np.prod(v)) for v in shapes.values()) * C,
        "draw_ms": (time.perf_counter() - t0) * 1e3}
    for lo in (0, C - 1):
        part = draw((lo, lo + 1))
        for g, leaves in full.items():
            for k, v in leaves.items():
                check(_same_bits(part[g][k], v[lo:lo + 1]),
                      f"C = {C}: row {lo} of {g}/{k} drawn alone differs "
                      "from the full draw")
    del full
    if not tiled:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generator_loop_draw(shapes, pattern, C, device)
        torch.cuda.synchronize()
        out["generator_loop_ms"] = (time.perf_counter() - t0) * 1e3
    torch.cuda.empty_cache()
    return out


def phase_rng(device, gpu, phase4_ms=None):
    """Phase 13: the key chain's draws on the card equal the CPU's; a
    Solver built on the card equals one built on the CPU and steps
    through B2a and B1a; the sweep's draw timed with its rows held to
    the full draw."""
    t0 = time.perf_counter()
    prim = rng_primitives(device)
    print("phase 13: random_bits, uniform, normal, bernoulli on the card "
          f"equal the CPU's bit for bit at {[s for s in RNG_SHAPES]} and "
          f"{RNG_LANES[0]} keys x {RNG_LANES[1]} (rows {list(RNG_ROWS)} on "
          "the CPU); card ms: "
          + ", ".join(f"{k} {v:.2f}" for k, v in prim.items()
                      if k.endswith("x".join(map(str, (RNG_LANES[0],)
                                                  + RNG_LANES[1]))))
          + f" ({gpu})", flush=True)
    sol = rng_solver(gpu)
    host = {"single_us": key_chain_host_us(),
            "lanes_512_us": key_chain_host_us(lanes=512),
            "single_plain_us": key_chain_host_us(reps=128, blocked=False),
            "lanes_512_plain_us": key_chain_host_us(lanes=512, reps=64,
                                                    blocked=False)}
    sol["key_chain_host_us"] = host
    sol["phase4_median_ms"] = phase4_ms
    sol["phase4_before_ms"] = PHASE4_BEFORE_MS
    print(f"phase 13: Solver (seed 7) built in {sol['build_cuda_s']:.3f} s "
          f"on the card, {sol['build_cpu_s']:.3f} s on the CPU: params and "
          f"packed banks bit-identical; {sol['seeds_checked']} crossbar "
          f"seeds of {sol['steps']} card steps equal the CPU solver's; "
          f"launches B2 {sol['launches']['B2']}, B1 {sol['launches']['B1']}; "
          f"median {sol['step_ms']:.3f} ms a step after 2; key chain on "
          f"the host {host['single_us']:.1f} us a step in blocks, "
          f"{host['single_plain_us']:.1f} us step by step (C = 512: "
          f"{host['lanes_512_us']:.1f} and {host['lanes_512_plain_us']:.1f}"
          f" us); phase 4 median "
          + (f"{phase4_ms:.3f} ms" if phase4_ms else "not run")
          + f" (before the key chain: {PHASE4_BEFORE_MS} ms on H100 80GB "
          "HBM3, 700 W); "
          f"{gpu}", flush=True)
    sweeps = [rng_sweep(device, SWEEP_CONFIGS, False),
              rng_sweep(device, TILED_SWEEP_CONFIGS, True)]
    for sw in sweeps:
        extra = (f", the torch.Generator loop it replaced "
                 f"{sw['generator_loop_ms']:.1f} ms"
                 if "generator_loop_ms" in sw else "")
        print(f"phase 13: sweep draw C = {sw['C']} "
              f"{'tiled' if sw['tiled'] else 'untiled'} ({sw['cells']} "
              f"cells, lifetimes and stuck values): {sw['draw_ms']:.1f} ms "
              f"on the card{extra}; rows 0 and {sw['C'] - 1} drawn alone "
              f"equal the full draw ({gpu})", flush=True)
    return {"primitives_ms": prim, "solver": sol, "sweeps": sweeps,
            "phase_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase 14: the formats across a restart

FORMAT_STEPS = 5            # sweep steps before the checkpoint, and after
SNAPSHOT_EVERY, SNAPSHOT_ITERS = 10, 20     # the Solver's snapshot run


def _host_leaves(r):
    """Host copies of every checkpointed leaf of a runner."""
    return {k: v.detach().cpu().clone() for k, v in r._state_arrays().items()}


def _leaves_differ(a: dict, b: dict) -> list:
    return sorted(set(a) ^ set(b)) + [k for k in a if k in b
                                      and not _same_bits(a[k], b[k])]


def _sweep_steps(r, n):
    """n sweep steps one at a time: each step's lane losses (host) and
    its time in ms (each step ends in the host read of its losses)."""
    import torch
    losses, ms = [], []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(r.step(1)[0].copy())
        ms.append((time.perf_counter() - t0) * 1e3)
    return losses, ms


def formats_sweep(C, tmp):
    """(a) and (b) at C lanes: checkpoint, continue, restore into a fresh
    runner, continue the same; save_fault_states read back and packed."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.fault import engine, packed
    r = sweep_runner(C, 1e8, 3e7)
    r.step(FORMAT_STEPS, chunk=FORMAT_STEPS)
    path = os.path.join(tmp, "sweep.ckpt.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.checkpoint(path)
    ckpt_s = time.perf_counter() - t0
    want, run_ms = _sweep_steps(r, FORMAT_STEPS)
    leaves = _host_leaves(r)
    fpath = os.path.join(tmp, "faults.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.save_fault_states(fpath)          # background: the caller's share
    faults_call_s = time.perf_counter() - t0
    r.wait_for_writes()
    faults_writer_s = r._bg_writer.write_s
    with np.load(fpath) as z:
        flat = {k: z[k] for k in z.files}
    check(sorted({k.split("/")[0] for k in flat}) == ["lifetimes", "stuck"],
          f"save_fault_states wrote groups {sorted(flat)}")
    banks = packed.convert_flat(flat, to_packed=True, spec=r._pack_spec)
    live = dict(engine.iter_state_leaves(r.fault_states))
    check(set(banks) == set(live) and all(
        banks[k].tobytes() == live[k].cpu().numpy().tobytes()
        for k in live), "save_fault_states packed again differs from the "
          "live banks")
    out = {"configs": C, "steps": FORMAT_STEPS,
           "checkpoint_s": ckpt_s, "checkpoint_bytes": os.path.getsize(path),
           "fault_states_call_s": faults_call_s,
           "fault_states_writer_s": faults_writer_s,
           "fault_states_bytes": os.path.getsize(fpath)}
    r.close()
    del r, live
    torch.cuda.empty_cache()

    r = sweep_runner(C, 1e8, 3e7)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.restore(path)
    torch.cuda.synchronize()
    out["restore_s"] = time.perf_counter() - t0
    check(r.iter == FORMAT_STEPS, f"restored at iteration {r.iter}")
    kernels.reset_launches()
    got, cont_ms = _sweep_steps(r, FORMAT_STEPS)
    launches = _launches()
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.tobytes() == w.tobytes(), f"continued step {i}: lane losses "
              "differ from the uninterrupted run's")
    differ = _leaves_differ(_host_leaves(r), leaves)
    check(not differ, f"leaves differ after the continuation: {differ[:5]}")
    n = FORMAT_STEPS
    check(launches == _untiled(B2=2 * n, B1=n, B4=n),
          f"continued steps launched {launches}, expected B2 2, B1 1, B4 1 "
          "a step")
    out.update(launches=launches, leaves=len(leaves),
               step_ms_median=float(np.median(cont_ms)),
               uninterrupted_step_ms_median=float(np.median(run_ms)))
    r.close()
    del r
    torch.cuda.empty_cache()
    return out


def _recording(s, losses):
    """Record each step's loss tensor of Solver `s` as its step runs."""
    inner = s._step_fn

    def step(*args, **kw):
        out = inner(*args, **kw)
        losses.append(out[3])
        return out
    step.noise = inner.noise
    s._step_fn = step


def _timing(fn, seconds):
    import torch

    def call(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out
    return call


def formats_solver(tmp, tiled):
    """(c): solve() to iteration 20 with snapshots at 10 and 20, then a
    fresh Solver's solve(resume_file=<iteration 10>)."""
    from rram_caffe_simulation_tpu_torch import kernels, proto

    def build(prefix):
        s = slice_solver(1e8, 3e7, tiled=tiled)
        s.param.snapshot = SNAPSHOT_EVERY
        s.param.snapshot_format = proto.BINARYPROTO
        s.param.snapshot_prefix = prefix
        s.param.max_iter = SNAPSHOT_ITERS
        return s

    prefix = os.path.join(tmp, "tiled" if tiled else "slice")
    s = build(prefix)
    full, snap_s = [], []
    _recording(s, full)
    s.snapshot = _timing(s.snapshot, snap_s)
    s.solve()
    check(s.iter == SNAPSHOT_ITERS and len(full) == SNAPSHOT_ITERS
          and len(snap_s) == 2, f"solve() ran to {s.iter} with "
          f"{len(snap_s)} snapshots")
    state = f"{prefix}_iter_{SNAPSHOT_EVERY}.solverstate"
    sizes = {ext: os.path.getsize(f"{prefix}_iter_{SNAPSHOT_EVERY}.{ext}")
             for ext in ("caffemodel", "solverstate", "faultstate")}
    r = build(prefix + "_resumed")
    # the host feed at the position s's was at iteration 10 (the cursor is
    # not part of a snapshot, in either package)
    for _ in range(SNAPSHOT_EVERY):
        r.train_feed()
    cont, restore_s = [], []
    _recording(r, cont)
    r.restore = _timing(r.restore, restore_s)
    kernels.reset_launches()
    r.solve(resume_file=state)
    launches = _launches()
    n = SNAPSHOT_ITERS - SNAPSHOT_EVERY
    what = "tiled Solver" if tiled else "Solver"
    check(len(cont) == n and all(_same_bits(a, b) for a, b in
                                 zip(cont, full[SNAPSHOT_EVERY:])),
          f"{what}: losses 11-20 after the restore differ")
    for ln, vals in s.params.items():
        for i, t in enumerate(vals):
            check(t is None or _same_bits(r.params[ln][i], t),
                  f"{what}: params of {ln}/{i} differ")
    for k, slots in s.history.items():
        check(_same_bits(r.history[k]["h"], slots["h"]),
              f"{what}: history of {k} differs")
    for g, tree in s.fault_state.items():
        for k, v in tree.items():
            check(_same_bits(r.fault_state[g][k], v),
                  f"{what}: fault leaf {g}/{k} differs")
    per = _tiled_per_step() if tiled else _untiled(B2=2, B1=1, B4=0)
    check(launches == {k: v * n for k, v in per.items()},
          f"{what}: continued steps launched {launches}, expected {per} "
          "a step")
    return {"bytes": sizes, "snapshot_s": snap_s, "restore_s": restore_s[0],
            "launches": launches,
            "losses_11_20_first_last": [float(cont[0]), float(cont[-1])]}


def formats_devices(tmp, C=8):
    """(d): a card checkpoint restored into a CPU runner; one step each."""
    from rram_caffe_simulation_tpu_torch.parallel import SweepRunner
    card = sweep_runner(C, 300.0, 50.0, seed=7)
    card.step(2, chunk=2)
    path = os.path.join(tmp, "card.ckpt.npz")
    card.checkpoint(path)
    s = slice_solver(300.0, 50.0, hw_engine="torch", seed=7, device="cpu")
    cpu = SweepRunner(s, n_configs=C, engine="torch", packed_state=True,
                      dtype_policy="ternary", device="cpu")
    cpu.restore(path)
    differ = _leaves_differ(_host_leaves(card), _host_leaves(cpu))
    check(not differ, f"the CPU runner's leaves differ: {differ[:5]}")
    t0 = time.perf_counter()
    cpu_loss = cpu.step(1)[0]
    cpu_s = time.perf_counter() - t0
    card_loss = card.step(1)[0]
    rel = float((np.abs(card_loss - cpu_loss)
                 / np.maximum(np.abs(cpu_loss), 1.0)).max())
    check(bool(np.isfinite(card_loss).all()) and rel <= 1e-5,
          f"card step losses {card_loss} against the CPU's {cpu_loss}")
    for k, q in card.fault_states["life_q"].items():
        check(_same_bits(q, cpu.fault_states["life_q"][k]),
              f"life_q of {k} differs between the card and the CPU")
    check(float(card.broken_fractions().min()) > 0.0,
          "no lane had a broken cell")
    return {"configs": C, "leaves": len(card._state_arrays()),
            "loss_rel_max": rel, "cpu_step_s": cpu_s}


def phase_formats(C, gpu):
    """Phase 14: the sweep's checkpoint and save_fault_states at C lanes
    (halved while the card runs out of memory), the Solvers' snapshots
    through solve(), and a checkpoint across devices; its files live in
    a temp directory removed at the end."""
    import shutil
    import tempfile
    import torch
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_formats_")
    saved = os.environ.get("RRAM_POOL_BWD")
    try:
        os.environ["RRAM_POOL_BWD"] = "cuda"
        while True:
            try:
                sweep = formats_sweep(C, tmp)
                break
            except torch.cuda.OutOfMemoryError:
                check(C > 8, "the sweep does not fit the card at C = 8")
                print(f"phase 14: C = {C} does not fit the card (out of "
                      "memory); halving", flush=True)
                C //= 2
                torch.cuda.empty_cache()
        devices = formats_devices(tmp)
        if saved is None:
            os.environ.pop("RRAM_POOL_BWD")
        else:
            os.environ["RRAM_POOL_BWD"] = saved
        solver = formats_solver(tmp, tiled=False)
        tiled = formats_solver(tmp, tiled=True)
    finally:
        if saved is None:
            os.environ.pop("RRAM_POOL_BWD", None)
        else:
            os.environ["RRAM_POOL_BWD"] = saved
        shutil.rmtree(tmp)
    torch.cuda.empty_cache()
    print(f"phase 14: sweep C = {sweep['configs']}, N(1e8, 3e7), packed int32"
          f" banks: checkpoint at iteration {FORMAT_STEPS} written in "
          f"{sweep['checkpoint_s']:.3f} s ({sweep['checkpoint_bytes']} bytes),"
          f" restored into a fresh runner in {sweep['restore_s']:.3f} s; "
          f"{FORMAT_STEPS} continued steps bit-identical to the uninterrupted"
          f" run (lane losses, {sweep['leaves']} leaves), launches "
          f"{sweep['launches']}; step median {sweep['step_ms_median']:.3f} ms"
          f" against {sweep['uninterrupted_step_ms_median']:.3f} ms "
          f"uninterrupted; {gpu}", flush=True)
    print(f"phase 14: save_fault_states at C = {sweep['configs']}: "
          f"{sweep['fault_states_bytes']} bytes, f32 layout, packed again "
          f"equal to the live banks; the caller paid "
          f"{sweep['fault_states_call_s']:.3f} s, the writer "
          f"{sweep['fault_states_writer_s']:.3f} s", flush=True)
    for name, res in (("Solver", solver), ("tiled Solver", tiled)):
        print(f"phase 14: {name}: solve() with snapshots at "
              f"{SNAPSHOT_EVERY} and {SNAPSHOT_ITERS} (bytes {res['bytes']};"
              f" snapshot s {[round(v, 4) for v in res['snapshot_s']]}), "
              f"solve(resume_file) restored in {res['restore_s']:.4f} s: "
              f"losses 11-20, params, history and banks bit-identical; "
              f"launches {res['launches']}", flush=True)
    print(f"phase 14: C = {devices['configs']} card checkpoint restored into a"
          f" CPU runner: {devices['leaves']} leaves equal; one step each: "
          f"losses within {devices['loss_rel_max']:.2e} relative (limit "
          f"1e-5), life_q identical (CPU step {devices['cpu_step_s']:.2f} s)",
          flush=True)
    return {"sweep": sweep, "solver": solver, "tiled_solver": tiled,
            "devices": devices, "phase_s": time.perf_counter() - t_phase,
            "gpu": gpu}


# ---------------------------------------------------------------------------
# phase 15: the rest of the solver, and the strategies over the lanes

RULES = ("SGD", "Nesterov", "AdaGrad", "RMSProp", "AdaDelta", "Adam")
RULE_STEPS = 10             # lockstep steps of each rule, and timed ones
# the history bank a rule divides the gradient by the root of, and the
# root below which the division turns a gradient difference at f32
# rounding into an update difference beyond 1e-5 (lr / (sqrt(h) +
# delta) > 10 at CIFAR's base_lr 0.001)
ILL_BANK = {"AdaGrad": "h", "RMSProp": "h", "Adam": "h2"}
ILL_ROOT = 1e-4
SWEEP_STRATEGY_STEPS = 10   # remaps (start 5, period 5) before 4 and 9
GENETIC_CONFIGS = 64


def _params_far(kp, pp, ph, rule):
    """(cells of the "cuda" params beyond 1e-5 relative of the "torch"
    ones, those of them where the rule is ill-conditioned): AdaGrad,
    RMSProp and Adam divide the gradient by the root of a history bank,
    so where that root is below ILL_ROOT (a gradient near zero) a
    gradient difference at f32 rounding moves the update by more than
    1e-5, up to a full step of the other sign. The ill-conditioned cells
    are counted, not held."""
    far = ill = 0
    for ln, vals in kp.items():
        for slot, (a, b) in enumerate(zip(vals, pp[ln])):
            if a is None:
                continue
            off = (a - b).abs() > 1e-5 * b.abs().clamp(min=1.0)
            if rule in ILL_BANK:
                weak = ph[f"{ln}/{slot}"][ILL_BANK[rule]].sqrt() < ILL_ROOT
                ill += int((off & weak).sum())
                off &= ~weak
            far += int(off.sum())
    return far, ill


def solver_lockstep(s, steps, name, b2_per_step):
    """`steps` steps of solver `s`, each through the "torch" engine (no
    launch) and the "cuda" engine (B2 `b2_per_step` times, B1 once) from
    the same state, batch and key, both on the card; the "cuda" result
    goes on. life_q identical, losses within 1e-5 relative, params as
    `_params_far` says (none far). Returns the worst loss gap and the
    ill-conditioned cells beyond 1e-5."""
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.fault import fused, hw_aware
    import torch
    pstep = s.make_train_step(hw_engine="torch", dtype_policy="ternary",
                              fault_format="packed", pack_spec=s.pack_spec,
                              fused_epilogue=True)
    worst, ill = 0.0, 0
    for i in range(steps):
        it = s.iter
        state = (s.params, s.history, s.fault_state)
        batch = s._next_batch()
        rng = s._step_fn.noise.step_key(s._key, it)
        kernels.reset_launches()
        pp, ph, pf, pl, _ = pstep(*state, batch, it, rng)
        check(hw_aware.CROSSBAR_LIB.launches == 0
              and fused.FUSED_LIB.launches == 0,
              f"{name} step {i}: the torch engine launched a kernel")
        kp, kh, kf, kl, _ = s._step_fn(*state, batch, it, rng)
        b2, b1 = hw_aware.CROSSBAR_LIB.launches, fused.FUSED_LIB.launches
        check(b2 == b2_per_step and b1 == 1, f"{name} step {i}: launches "
              f"B2 {b2}, B1 {b1} (expected {b2_per_step} and 1)")
        kl, pl = float(kl), float(pl)
        rel = abs(kl - pl) / max(1.0, abs(pl))
        worst = max(worst, rel)
        check(math.isfinite(kl) and rel <= 1e-5,
              f"{name} step {i}: lockstep losses {kl} vs {pl}")
        for k in kf["life_q"]:
            check(torch.equal(kf["life_q"][k], pf["life_q"][k]),
                  f"{name} step {i}: life_q differs on {k}")
        far, weak = _params_far(kp, pp, ph, s.type)
        ill += weak
        check(far == 0, f"{name} step {i}: {far} params differ beyond 1e-5 "
              "relative where the rule is well conditioned")
        s.params, s.history, s.fault_state = kp, kh, kf
        s.iter += 1
    return worst, ill


def rule_bits_card_vs_cpu(device):
    """Each rule's update and history on fixed inputs (ip1's shape,
    gradients over six decades, zeros, t = 1, 7, 1000), on the card and
    on the CPU: equal bit for bit. Returns the number of cases."""
    import torch
    from rram_caffe_simulation_tpu_torch import proto
    from rram_caffe_simulation_tpu_torch.solver import updates as U
    rng = np.random.RandomState(15)
    shape = (64, 1024)
    hp = U.Hyper(proto.parse("momentum: 0.9 momentum2: 0.999 delta: 1e-8 "
                             "rms_decay: 0.98", "SolverParameter"))
    cases = 0
    for t in (1, 7, 1000):
        diff = (rng.randn(*shape) * 10.0 ** rng.uniform(-6, 0, shape)
                ).astype(np.float32)
        diff[0, :8] = 0.0
        slots = {s: (np.abs(rng.randn(*shape)) * 1e-4).astype(np.float32)
                 for s in ("h", "h2")}
        for rule in RULES:
            names = U.HISTORY_SLOTS[rule]
            out = {}
            for dev in ("cpu", device):
                upd, hist = U.UPDATE_RULES[rule](
                    torch.from_numpy(diff).to(dev),
                    {n: torch.from_numpy(slots[n]).to(dev) for n in names},
                    float(np.float32(0.001) * np.float32(2.0)), hp, t)
                out[str(dev)] = [upd] + [hist[n] for n in names]
            for a, b in zip(out["cpu"], out[str(device)]):
                check(b.is_cuda and torch.equal(
                    a.view(torch.int32), b.cpu().view(torch.int32)),
                    f"{rule} at t = {t}: the card's output differs from "
                    "the CPU's")
            cases += 1
    return cases


def b1_ms_in(step_once, iters=20):
    """B1's device time a step on the inputs a step of the path hands it:
    `step_once()` runs one step, whose fused tail (`solver.fused_tail`:
    the update values of the step's rule, after clipping, iter_size and
    the regularization) is captured, then called `iters` times under the
    profiler (its outputs are new tensors)."""
    from rram_caffe_simulation_tpu_torch.solver import solver as solver_mod
    tail, seen = solver_mod.fused_tail, []

    def capture(*args):
        seen.append(args)
        return tail(*args)
    solver_mod.fused_tail = capture
    try:
        step_once()
    finally:
        solver_mod.fused_tail = tail
    check(len(seen) == 1, f"{len(seen)} fused tails in one step")
    by_name = device_ms_by_name(lambda: tail(*seen[0]), iters=iters)
    return sum(ms for name, (ms, _) in by_name.items()
               if any(k in name for k in B1_KERNELS))


def _paired_steps(a, b, steps):
    """Step medians of solvers a and b, stepped in turns."""
    import torch
    ms = {"a": [], "b": []}
    for _ in range(steps):
        for key, x in (("a", a), ("b", b)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            x.step(1)                       # ends in a host read: synced
            ms[key].append((time.perf_counter() - t0) * 1e3)
    warm = 2
    return (float(np.median(ms["a"][warm:])), float(np.median(ms["b"][warm:])),
            float(np.median(np.subtract(ms["a"], ms["b"])[warm:])))


def rest_single(device, gpu):
    """(a) the six rules and (b) iter_size 2 + clip + L1 at phase 4's
    slice, in lockstep with the plain path, timed, B1 by the
    profiler."""
    import torch
    from rram_caffe_simulation_tpu_torch.solver import solver as solver_mod
    t0 = time.perf_counter()
    out = {"rules": {}, "bits_cases": rule_bits_card_vs_cpu(device),
           "part_s": {}}
    out["part_s"]["bits"] = time.perf_counter() - t0
    sgd = slice_solver(1e8, 3e7, seed=15)
    build_s = []
    for rule in RULES:
        t0 = time.perf_counter()
        s = slice_solver(1e8, 3e7, seed=15, fields={"type": rule})
        build_s.append(time.perf_counter() - t0)
        check(s.type == rule, f"solver type {s.type}, expected {rule}")
        worst, ill = solver_lockstep(s, RULE_STEPS, rule, 2)
        med, sgd_med, paired = _paired_steps(s, sgd, RULE_STEPS)
        out["rules"][rule] = {"lockstep_loss_rel_max": worst,
                              "ill_conditioned_cells": ill,
                              "step_ms_median": med,
                              "sgd_step_ms_median": sgd_med,
                              "paired_diff_ms_median": paired}
        if rule in ("SGD", "Adam"):
            t1 = time.perf_counter()
            out["rules"][rule]["b1_ms"] = b1_ms_in(lambda: s.step(1))
            out["part_s"][f"b1_{rule}"] = time.perf_counter() - t1
        out["part_s"][rule] = time.perf_counter() - t0
        print(f"phase 15: (a) {rule}: {json.dumps(out['rules'][rule])}",
              flush=True)
        del s
    out["part_s"]["solver_builds"] = build_s
    # (b): the clip below the first steps' norm, so that it engages
    norms = []
    clip_fn = solver_mod.clip_gradients

    def record(g, clip, lanes=0):
        l2 = float(torch.sqrt(sum((v.double() ** 2).sum()
                                  for v in g.values())))
        norms.append(l2)
        return clip_fn(g, clip, lanes)
    fields = {"iter_size": 2, "regularization_type": "L1",
              "clip_gradients": 1e30}
    solver_mod.clip_gradients = record
    try:
        probe = slice_solver(1e8, 3e7, seed=16, fields=fields)
        probe.step(3)
        clip = float(np.float32(0.5 * min(norms)))
        fields["clip_gradients"] = clip
        s = slice_solver(1e8, 3e7, seed=16, fields=fields)
        norms.clear()
        worst, ill = solver_lockstep(s, 6, "iter_size 2 + clip + L1", 4)
    finally:
        solver_mod.clip_gradients = clip_fn
    # each lockstep step clips twice (the torch step, then the cuda one)
    check(len(norms) == 12 and min(norms) > clip,
          f"the clip {clip} did not engage on every step: norms {norms}")
    med, sgd_med, paired = _paired_steps(s, sgd, RULE_STEPS)
    out["iter_size_clip_l1"] = {
        "clip": clip, "norms": norms[1::2],
        "scales": [clip / n for n in norms[1::2]],
        "lockstep_loss_rel_max": worst, "ill_conditioned_cells": ill,
        "step_ms_median": med, "sgd_step_ms_median": sgd_med,
        "paired_diff_ms_median": paired, "b1_ms": b1_ms_in(
            lambda: s.step(1))}
    print(f"phase 15: (b) iter_size 2, clip_gradients, L1: "
          f"{json.dumps(out['iter_size_clip_l1'])}", flush=True)
    out["gpu"] = gpu
    return out


def sweep_strategy_lockstep(thr, steps=SWEEP_STRATEGY_STEPS, C=8):
    """(c) at C = 8, N(300, 50), threshold + tracked remapping: each
    step the laned "cuda" step against the laned "torch" step and each
    lane against a single-config Solver from the lane's state, from the
    same batch and keys: life_q identical off the threshold's edge
    cells (counted), remap slots identical, losses within 1e-5
    relative."""
    import torch
    strategies = [{"type": "threshold", "threshold": thr},
                  {"type": "remapping", "start": 5, "period": 5,
                   "track_identity": True,
                   "prune_order_file": STRATEGY_FILES[0]}]
    r = sweep_runner(C, 300.0, 50.0, seed=7, strategies=strategies)
    single = slice_solver(300.0, 50.0, seed=7, strategies=strategies)
    pstep = r.solver.make_train_step(
        hw_engine="torch", lanes=C, dtype_policy="ternary",
        fault_format="packed", pack_spec=r._pack_spec, fused_epilogue=True)
    out = {"configs": C, "steps": steps, "remaps": 0, "edge_cells": 0,
           "edge_flips": 0, "loss_rel_max": 0.0}
    for i in range(steps):
        it = r.iter
        batch = r._batch(it)
        state = (r.params, r.history, r.fault_states)
        lanes = [r.lane_state(c) for c in range(C)]
        keys = r.lane_keys(it)
        due = r.solver._remap_due_at(it)
        out["remaps"] += due
        with threshold_inputs() as seen:
            _, _, pf, pl, _ = pstep(*state, batch, it, keys, due)
        edge, _ = _edge_cells(r.solver, seen[0], it, state[2], due)
        out["edge_cells"] += sum(int(m.sum()) for m in edge.values())
        kp, kh, kf, kl, _ = r._step(*state, batch, it, keys, due)
        others = [("torch engine", pf, pl, None)]
        for c in range(C):
            _, _, sf, sl, _ = single._step_fn(*lanes[c], batch, it, keys[c],
                                              due)
            others.append((f"Solver lane {c}", sf, sl, c))
        for what, f, loss, c in others:
            mine = kl if c is None else kl[c]
            rel = float(((mine - loss).abs()
                         / loss.abs().clamp_min(1.0)).max())
            out["loss_rel_max"] = max(out["loss_rel_max"], rel)
            check(rel <= 1e-5, f"(c) step {i}: losses against the {what} "
                  f"differ by {rel:.2e}")
            for k, v in f["life_q"].items():
                kv = kf["life_q"][k] if c is None else kf["life_q"][k][c]
                e = edge[k] if c is None else edge[k][c]
                differ = kv != v
                if c is None:
                    out["edge_flips"] += int(differ.sum())
                check(not bool((differ & ~e).any()),
                      f"(c) step {i}: life_q off the threshold's edge "
                      f"differs from the {what} on {k}")
            for g, v in f["remap_slots"].items():
                kv = kf["remap_slots"][g]
                check(torch.equal(kv if c is None else kv[c], v),
                      f"(c) step {i}: remap slots differ from the {what}")
        r._commit(kp, kh, kf, kl)
        r.iter += 1
    check(out["remaps"] == 2, f"(c) {out['remaps']} remaps in {steps} steps")
    slots = r.fault_states["remap_slots"]["0"]
    check(not bool((slots == torch.arange(64, device=slots.device)).all()),
          "(c) the tracked remap left every lane at the identity")
    return out


STRATEGY_FILES = [None] * 3  # phase 15's prune order, prune net, model


def timed_sweep(r, steps, chunk=SWEEP_CHUNK):
    """Wall time of `steps` sweep steps in chunks (each ends in a host
    read of the losses)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    r.step(steps, chunk=chunk)
    return time.perf_counter() - t0


def rest_sweeps(gpu, thr):
    """(c) the C = 512 sweep with threshold and tracked remapping, in
    turns with the same runner without strategies; (d) genetic at
    C = 64; (e) the C = 512 sweep under Adam, and iter_size 2."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    t0 = time.perf_counter()
    out = {"c_lockstep": sweep_strategy_lockstep(thr)}
    part = {"c_lockstep": time.perf_counter() - t0}
    t0 = time.perf_counter()
    print(f"phase 15: (c) lockstep: {json.dumps(out['c_lockstep'])}",
          flush=True)
    C = SWEEP_CONFIGS
    strategies = [{"type": "threshold", "threshold": thr},
                  {"type": "remapping", "start": 5, "period": 5,
                   "track_identity": True,
                   "prune_order_file": STRATEGY_FILES[0]}]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    r = sweep_runner(C, 1e8, 3e7, strategies=strategies)
    base = sweep_runner(C, 1e8, 3e7)
    part["c_builds"] = time.perf_counter() - t0
    check(r._dataset is not None and "remap_slots" in r.fault_states,
          "(c) the strategy sweep's dataset or remap slots are missing")
    # a first step each warms cuDNN's plans; then 10 steps in turns
    # (iterations 1-10: remaps before 4 and 9)
    timed_sweep(r, 1, 1)
    timed_sweep(base, 1, 1)
    kernels.reset_launches()
    n = SWEEP_STRATEGY_STEPS // 2
    walls = {"strategies": timed_sweep(r, n)}
    launches = _launches()
    walls["none"] = timed_sweep(base, n)     # 5 steps between the halves
    walls["strategies"] += timed_sweep(r, n)
    check(launches == _untiled(B2=2 * n, B1=n, B4=n),
          f"(c) launches {launches} in {n} steps, expected B2 2, B1 1, B4 "
          "1 a step")
    check(bool(np.isfinite(r.last_losses).all()), "(c) non-finite losses")
    slots = r.fault_states["remap_slots"]["0"]
    check(not bool((slots == torch.arange(64, device=slots.device)).all()),
          "(c) no lane was remapped")
    out["c_sweep"] = {
        "configs": C, "steps": SWEEP_STRATEGY_STEPS,
        "configs_steps_per_s": C * SWEEP_STRATEGY_STEPS / walls["strategies"],
        "configs_steps_per_s_without": C * n / walls["none"],
        "step_ms": walls["strategies"] / SWEEP_STRATEGY_STEPS * 1e3,
        "step_ms_without": walls["none"] / n * 1e3,
        "launches_5_steps": launches,
        "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
        "b1_ms_sgd": b1_ms_in(lambda: base.step(1))}
    print(f"phase 15: (c) C = {C}: {json.dumps(out['c_sweep'])}", flush=True)
    del r, base
    torch.cuda.empty_cache()
    part["c"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # (d) the genetic search at C = 64, lane 5 quarantined
    genetic = {"type": "genetic", "start": 3, "period": 5,
               "switch_time": 50, "prune_net_file": STRATEGY_FILES[1],
               "prune_model_file": STRATEGY_FILES[2]}
    r = sweep_runner(GENETIC_CONFIGS, 300.0, 50.0, seed=8,
                     strategies=[genetic])
    bad = min(5, GENETIC_CONFIGS - 1)
    r.params["ip1"][0][bad, 0, 0] = float("nan")
    r.step(1)
    check(list(r.quarantined()) == [bad], f"(d) quarantined "
          f"{r.quarantined()}, expected [{bad}]")
    frozen = {ln: [None if t is None else t[bad].cpu().numpy().tobytes()
                   for t in vals] for ln, vals in r.params.items()}
    masks0 = [[m.copy() for m in g.prune_weights] for g in r._genetics]
    apply, took = r._apply_genetic, []

    def timed_apply():
        t0 = time.perf_counter()
        apply()
        took.append(time.perf_counter() - t0)
    r._apply_genetic = timed_apply
    losses = r.step(SWEEP_STRATEGY_STEPS - 1, chunk=SWEEP_CHUNK)[0]
    check(len(took) == 2, f"(d) {len(took)} genetic applications in "
          f"{SWEEP_STRATEGY_STEPS} steps, expected 2 (before 2 and 7)")
    now = {ln: [None if t is None else t[bad].cpu().numpy().tobytes()
                for t in vals] for ln, vals in r.params.items()}
    check(now == frozen, "(d) the quarantined lane's params moved")
    check(all(np.array_equal(a, b) for a, b in
              zip(masks0[bad], r._genetics[bad].prune_weights)),
          "(d) the quarantined lane's prune masks moved")
    moved = sum(any(not np.array_equal(a, b) for a, b in
                    zip(m0, g.prune_weights))
                for m0, g in zip(masks0, r._genetics))
    check(moved > 0, "(d) no lane kept a swap")
    check(bool(np.isfinite(np.delete(losses, bad)).all()),
          "(d) a healthy lane went non-finite")
    out["d_genetic"] = {"configs": GENETIC_CONFIGS,
                        "applications": len(took), "lanes_swapped": moved,
                        "host_s_per_application": float(np.mean(took)),
                        "host_ms_per_config": float(np.mean(took))
                        / (GENETIC_CONFIGS - 1) * 1e3,
                        "quarantined": [bad]}
    print(f"phase 15: (d) {json.dumps(out['d_genetic'])}", flush=True)
    del r
    torch.cuda.empty_cache()
    part["d"] = time.perf_counter() - t0

    # (e) the C = 512 sweep under Adam; then iter_size 2
    for name, fields in (("adam", {"type": "Adam"}),
                         ("iter_size_2", {"iter_size": 2})):
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        r = sweep_runner(C, 1e8, 3e7, fields=fields)
        part[f"e_{name}_build"] = time.perf_counter() - t0
        steps = SWEEP_CHUNK if name == "adam" else 1
        timed_sweep(r, 1, 1)
        kernels.reset_launches()
        events = []
        inner, r._step = _event_stepper(r, events)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        start.record()
        wall = timed_sweep(r, steps)
        r._step = inner
        step_ms = [a.elapsed_time(b) for a, b in zip([start] + events[:-1],
                                                     events)]
        got = _launches()
        b2 = 2 * (2 if name == "iter_size_2" else 1)
        check(got == _untiled(B2=b2 * steps, B1=steps, B4=b2 // 2 * steps),
              f"(e) {name}: launches {got} in {steps} steps")
        check(bool(np.isfinite(r.last_losses).all()),
              f"(e) {name}: non-finite losses")
        out[f"e_{name}"] = {
            "configs": C, "steps": steps,
            "step_ms_median": float(np.median(step_ms)),
            "configs_steps_per_s": C * steps / wall,
            "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
            "history_bytes": sum(v.numel() * v.element_size()
                                 for slots in r.history.values()
                                 for v in slots.values()),
            "b1_ms": b1_ms_in(lambda: r.step(1))}
        print(f"phase 15: (e) {name}: {json.dumps(out[f'e_{name}'])}",
              flush=True)
        del r
        torch.cuda.empty_cache()
        part[f"e_{name}"] = time.perf_counter() - t0
    out["part_s"] = part
    out["gpu"] = gpu
    return out


def phase_rest(device, gpu):
    """Phase 15: the rest of the solver (the six rules, iter_size,
    clip_gradients, L1) at phase 4's slice, and the failure strategies
    over the sweep's lanes."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    saved = os.environ.get("RRAM_POOL_BWD")
    os.environ["RRAM_POOL_BWD"] = "cuda"
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            STRATEGY_FILES[:] = strategy_files(Path(tmp))
            single = rest_single(device, gpu)
            t1 = time.perf_counter()
            thr = calibrate_threshold(seed=12)
            t2 = time.perf_counter()
            sweeps = rest_sweeps(gpu, thr)
            print(f"phase 15: single {t1 - t0:.1f} s, calibration "
                  f"{t2 - t1:.1f} s, sweeps {time.perf_counter() - t2:.1f} "
                  f"s; parts {json.dumps(sweeps['part_s'])}; "
                  f"{json.dumps(single['part_s'])}", flush=True)
    finally:
        if saved is None:
            os.environ.pop("RRAM_POOL_BWD", None)
        else:
            os.environ["RRAM_POOL_BWD"] = saved
    torch.cuda.empty_cache()
    out = {"single": single, "sweeps": sweeps, "threshold": thr,
           "phase_s": time.perf_counter() - t0, "gpu": gpu}
    print(json.dumps({"solver_rest": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 16: the experiment template's VGG11-BN net

VGG_TEMPLATE = "models/cifar10_vgg11/cifar10_vgg11_template.prototxt"
# lifetimes N(4000, 1200) at decrement 100: 0.1% of the cells broken by
# the 4th write, 5% by the 20th. N(40, 10) would break every written cell
# at its first write and N(1000, 300) half of them by the 10th, where the
# stuck +-1 weights of fc3 send the loss to 12 and the comparison of
# two summation orders stops meaning anything; the template's 5e6
# breaks none
VGG_LIFE = (4000.0, 1200.0)
VGG_SIGMA = 0.05                 # rram_forward.sigma, as --hw-sigma arms it
VGG_STEPS = 20                   # (b)'s lockstep steps
VGG_TIMED_STEPS = 10             # (b)'s timed ones (20 before phase 23)
VGG_STRATEGY_STEPS = 4           # each strategy's lockstep steps in (c)
VGG_SWEEP_CONFIGS = (64, 32, 16)     # the largest that fits is taken
VGG_SWEEP_STEPS = 3              # (d)'s timed steps (5 before phase 25)
VGG_TEST_ITER = 5                # test_all's batches (the template's 100)
VGG_LEAVES = {"fc1/0": (1024, 512), "fc1/1": (1024,),
              "fc2/0": (1024, 1024), "fc2/1": (1024,),
              "fc3/0": (10, 1024), "fc3/1": (10,)}
VGG_B2_SHAPES = {"fc1": (100, 512, 1024), "fc2": (100, 1024, 1024),
                 "fc3": (100, 1024, 10)}
VGG_POOLS = ((64, 32), (128, 16), (256, 8), (512, 4), (512, 2))  # ch, H=W
POOL2X2 = ((2, 2), (2, 2), (0, 0, 0, 0))
NO_LAUNCH = {"B2": 0, "B2t": 0, "B3": 0, "B1": 0, "B4": 0}
# sigma > 0: the plain path's noise is B2's Philox twin, within 1e-3 of
# the kernel's draw (phase 3), so w_eff parts by up to 5e-5 relative
VGG_REL = 1e-4
VGG_CONV = (3, 3, 1, 1, 1, 1, 1, 1)      # every conv: 3x3, pad 1
# (g)'s tiled reads at batch 100 on 128x128-cell tiles, as TILED_CASES:
# B3a at conv2-8 (conv1's (27, 64) view is one tile, read untiled), B2t
# at fc1-3 (fc3's tile is 128 rows of its 10 columns)
VGG_TILED_CASES = {
    "conv2": ((100, 64, 16, 16), VGG_CONV, 576, 128, (128, 128, 8)),
    "conv3": ((100, 128, 8, 8), VGG_CONV, 1152, 256, (128, 128, 8)),
    "conv4": ((100, 256, 8, 8), VGG_CONV, 2304, 256, (128, 128, 8)),
    "conv5": ((100, 256, 4, 4), VGG_CONV, 2304, 512, (128, 128, 8)),
    "conv6": ((100, 512, 4, 4), VGG_CONV, 4608, 512, (128, 128, 8)),
    "conv7": ((100, 512, 2, 2), VGG_CONV, 4608, 512, (128, 128, 8)),
    "conv8": ((100, 512, 2, 2), VGG_CONV, 4608, 512, (128, 128, 8)),
    "fc1": ((100, 512), None, 512, 1024, (128, 128, 8)),
    "fc2": ((100, 1024), None, 1024, 1024, (128, 128, 8)),
    "fc3": ((100, 1024), None, 1024, 10, (128, 10, 8)),
}
VGG_B3_LAYERS = [f"conv{i}" for i in range(2, 9)]
VGG_B2T_LAYERS = ["fc1", "fc2", "fc3"]


def vgg_solver(seed=1, hw_engine="cuda", strategies=(), tiled=False,
               adc_bits=8, device="cuda", **fields):
    """The template as run_gaussian_exp.py patches it: the gaussian
    failure pattern at VGG_LIFE, rram_forward.sigma VGG_SIGMA
    (--hw-sigma), BINARYPROTO snapshots, with display and the periodic
    test off, test_iter VGG_TEST_ITER and a short max_iter; packed banks
    and the fused epilogue. `tiled` adds conv_also and rram_forward {
    adc_bits: `adc_bits` tiles: "cells=128x128" } with the implicit conv
    operand; `fields` other SolverParameter fields."""
    from rram_caffe_simulation_tpu_torch import proto
    from rram_caffe_simulation_tpu_torch.solver import Solver
    from rram_caffe_simulation_tpu_torch.utils.io import read_solver_param
    sp = read_solver_param(VGG_TEMPLATE)
    sp.failure_pattern.type = "gaussian"
    sp.failure_pattern.mean, sp.failure_pattern.std = VGG_LIFE
    sp.rram_forward.sigma = VGG_SIGMA
    sp.snapshot_format = proto.BINARYPROTO
    sp.snapshot = 0
    sp.max_iter = 100
    sp.display = 0
    sp.test_interval = 0
    sp.test_iter = [VGG_TEST_ITER]
    sp.random_seed = seed
    for strategy in strategies:
        entry = proto.Message("FailureStrategyParameter")
        for name, value in strategy.items():
            setattr(entry, name, value)
        sp.failure_strategy.append(entry)
    for name, value in fields.items():
        setattr(sp, name, value)
    kw = {}
    if tiled:
        sp.failure_pattern.conv_also = True
        sp.rram_forward.adc_bits = adc_bits
        sp.rram_forward.tiles = TILES
        kw["conv_im2col"] = "implicit"
    return Solver(sp, device=device, hw_engine=hw_engine,
                  fault_format="packed", fused_epilogue=True, **kw)


def write_rate(s) -> float:
    """The largest learning rate of solver `s`'s params at its base_lr:
    the scale of an update, against which `rounding_cells` sizes
    rounding."""
    return float(s.param.base_lr) * max(r.lr_mult for r in s._owner_refs)


@contextlib.contextmanager
def tail_updates():
    """A list that takes the {fault key: update} of each fused tail
    (`solver.fused_tail`) run while the context is open."""
    from rram_caffe_simulation_tpu_torch.solver import solver as solver_mod
    seen, tail = [], solver_mod.fused_tail

    def spy(fused_fn, keys, data, upd, fault_state):
        seen.append({k: upd[k] for k in keys})
        return tail(fused_fn, keys, data, upd, fault_state)
    solver_mod.fused_tail = spy
    try:
        yield seen
    finally:
        solver_mod.fused_tail = tail


@contextlib.contextmanager
def layer_io(net, names):
    """{layer: (bottom, top)} of the named layers of `net`, detached
    copies, for each forward pass run while the context is open (the
    last one's)."""
    seen = {}
    for ln in names:
        ly = net.layer_by_name[ln]

        def record(params, bottoms, ctx, _apply=ly.apply, _ln=ln):
            tops = _apply(params, bottoms, ctx)
            seen[_ln] = (bottoms[0].detach().clone(),
                         tops[0].detach().clone())
            return tops
        ly.apply = record
    try:
        yield seen
    finally:
        for ln in names:
            del net.layer_by_name[ln].apply


def io_gaps(kernel_io, plain_io):
    """Per layer, how far the kernel path's reads are from the plain
    path's in one step from the same state: whether the inputs are
    equal, their largest gap relative to the largest |input|, and the
    share of outputs apart by more than 1e-3 of the largest |output|
    (far beyond rounding: an ADC level, or a gap carried in)."""
    out = {}
    for ln, (xk, yk) in kernel_io.items():
        xp, yp = plain_io[ln]
        out[ln] = {
            "in_equal": _same_bits(xk, xp),
            "in_rel": float((xk - xp).abs().max() / xp.abs().max()),
            "out_apart_share": float(((yk - yp).abs() > 1e-3 * yp.abs()
                                      .max()).float().mean())}
    return out


def rounding_cells(qa, qb, ua, ub, noisy, rate, what, edge=None,
                   zeros_anywhere=False):
    """{key: mask} of the cells whose banks two paths left apart, each
    checked to be a rounding decision: in a BatchNorm-fed bias, one
    path's update below the write threshold (1e-20) and the other's at
    rounding size (at most 1e-6 of the rate). With `zeros_anywhere`
    (paths whose gradients part by more than rounding: an ADC level
    flip) any cell where one path's update is an exact 0 may differ.
    Cells of `edge` (the threshold's cutoff edge, {key: mask}) may differ
    too, not counted. Any other difference fails."""
    import torch
    masks = {}
    for k in qa:
        differ = qa[k] != qb[k]
        if edge and k in edge:
            differ &= ~edge[k]
        if k not in noisy and not zeros_anywhere:
            check(not bool(differ.any()), f"{what}: life_q differs on {k}")
            continue
        a, b = ua[k].abs(), ub[k].abs()
        rounding = torch.minimum(a, b) < 1e-20
        if not zeros_anywhere:
            rounding &= torch.maximum(a, b) <= 1e-6 * rate
        check(not bool((differ & ~rounding).any()),
              f"{what}: life_q differs on {k} off the rounding-decided "
              "cells")
        masks[k] = differ
    return masks


def vgg_lockstep(s, steps, name, per_step, rel=VGG_REL, loss_rel=VGG_REL,
                 zeros_anywhere=False, io=()):
    """`steps` steps of solver `s`, each through the "torch" engine (no
    launch) and the "cuda" engine (`per_step` launches) from the same
    state, batch and key, both on the card; the "cuda" result goes on
    (the genetic search first on its iterations, on the shared state).
    Per step: losses within `rel` relative; life_q identical but on
    rounding-decided cells (`rounding_cells`, counted) and, under the
    threshold, on cells at its cutoff's edge (counted); params and the
    BatchNorm statistics within `rel` relative (of 1 below 1) off those
    cells, scale_factor bit for bit; remap_slots identical. `rel` and
    `loss_rel` None report the gaps without holding them;
    `zeros_anywhere` as `rounding_cells` takes it. Returns the counts,
    the gaps, the kernel path's launches and the param element of the
    largest gap (leaf, step, index, both values); with `io` (layer
    names), also their `io_gaps` at the first step."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    st = s.strategies
    pstep = s.make_train_step(hw_engine="torch", fault_format="packed",
                              pack_spec=s.pack_spec, fused_epilogue=True)
    noisy = s.net.bn_fed_biases(s._fault_keys)
    rate = write_rate(s)
    out = {"steps": steps, "rounding_cells": 0, "edge_cells": 0,
           "remap_events": 0, "genetic_applications": 0,
           "loss_rel_max": 0.0, "param_rel_max": 0.0, "param_worst": None,
           "launches": dict(NO_LAUNCH), "losses": []}
    for i in range(steps):
        it = s.iter
        if st.genetic is not None and st.genetic.due():
            s._apply_genetic(st.genetic)
            out["genetic_applications"] += 1
        state = (s.params, s.history, s.fault_state)
        batch = s._next_batch()
        rng = s._step_fn.noise.step_key(s._key, it)
        due = s._remap_due_at(it)
        out["remap_events"] += int(due)
        kernels.reset_launches()
        with threshold_inputs() as seen, tail_updates() as pu, \
                layer_io(s.net, io if i == 0 else ()) as pio:
            pp, _, pf, pl, _ = pstep(*state, batch, it, rng)
        check(_launches() == NO_LAUNCH,
              f"{name} step {i}: the torch engine launched a kernel")
        with tail_updates() as ku, \
                layer_io(s.net, io if i == 0 else ()) as kio:
            kp, kh, kf, kl, _ = s._step_fn(*state, batch, it, rng)
        got = _launches()
        if i == 0 and io:
            out["io"] = io_gaps(kio, pio)
        check(got == {**NO_LAUNCH, **per_step},
              f"{name} step {i}: launches {got}, expected {per_step}")
        out["launches"] = {k: v + got[k] for k, v in out["launches"].items()}
        check(all(t.is_cuda for g in kf.values() for t in g.values()),
              f"{name} step {i}: fault state left the card")
        kl, pl = float(kl), float(pl)
        gap = abs(kl - pl) / max(1.0, abs(pl))
        out["loss_rel_max"] = max(out["loss_rel_max"], gap)
        out["losses"].append(kl)
        check(math.isfinite(kl) and (loss_rel is None or gap <= loss_rel),
              f"{name} step {i}: lockstep losses {kl} vs {pl}")
        edge = {}
        if st.threshold is not None:
            edge, _ = _edge_cells(s, seen[0], it, state[2], due)
            out["edge_cells"] += sum(int(m.sum()) for m in edge.values())
        skip = rounding_cells(kf["life_q"], pf["life_q"], ku[0], pu[0],
                              noisy, rate, f"{name} step {i}", edge,
                              zeros_anywhere)
        out["rounding_cells"] += sum(int(m.sum()) for m in skip.values())
        for k, m in edge.items():
            skip[k] = skip[k] | m if k in skip else m
        for ln, vals in kp.items():
            for slot, (a, b) in enumerate(zip(vals, pp[ln])):
                if a is None:
                    continue
                if s.net.layer_by_name[ln].type_name == "BatchNorm" \
                        and slot == 2:
                    check(_same_bits(a, b), f"{name} step {i}: "
                          f"scale_factor of {ln} differs")
                    continue
                off = (a - b).abs() / b.abs().clamp(min=1.0)
                if f"{ln}/{slot}" in skip:
                    off = off.masked_fill(skip[f"{ln}/{slot}"], 0.0)
                worst = float(off.max())
                if worst > out["param_rel_max"]:
                    at = int(off.argmax())
                    out["param_worst"] = {
                        "leaf": f"{ln}/{slot}", "step": i, "index": at,
                        "kernel": float(a.flatten()[at]),
                        "plain": float(b.flatten()[at])}
                out["param_rel_max"] = max(out["param_rel_max"], worst)
                check(a.is_cuda, f"{name} step {i}: {ln} left the card")
                check(rel is None or worst <= rel, f"{name} step {i}: "
                      f"params of {ln}/{slot} differ ({worst:.2e})")
        for g, v in kf.get("remap_slots", {}).items():
            check(torch.equal(v, pf["remap_slots"][g]),
                  f"{name} step {i}: remap_slots[{g}] differ")
        s.params, s.history, s.fault_state = kp, kh, kf
        s.iter += 1
    return out


def vgg_bn_scale_ms(s):
    """Device time a step of the net's BatchNorm and Scale layers alone,
    forward and backward, each at the shape it meets on the path (random
    inputs): their share of the step."""
    return layer_ms(s.net, ("BatchNorm", "Scale"), s.params, s.device)


def layer_ms(net, types, params=None, device="cuda", lanes=0):
    """Device time a step of the net's layers of `types` alone, forward
    and backward (through the learned Scale's operand too), each at the
    shape it meets on the path, laned over `lanes` lanes (random inputs):
    (total ms, the four largest kernels)."""
    import torch
    from rram_caffe_simulation_tpu_torch.core.registry import LayerContext
    ctx = LayerContext(phase=net.phase, updates={}, lanes=lanes,
                       laned=(bool(lanes),))
    pairs = []
    for ly in net.layers:
        if ly.type_name in types:
            shape = list(net.blob_shapes[ly.lp.bottom[0]])
            if lanes:
                shape[1] *= lanes
            ps = [p.detach().requires_grad_(ly.type_name == "Scale")
                  for p in (params or {}).get(ly.name, [])]
            pairs.append((ly, ps, torch.randn(shape, device=device)
                          .requires_grad_()))

    def fwd_bwd():
        for ly, ps, x in pairs:
            (y,) = ly.apply(ps, [x], ctx)
            torch.autograd.grad(y, [x] + [p for p in ps if p.requires_grad],
                                torch.ones_like(y))
    by_name = device_ms_by_name(fwd_bwd, iters=10 if not lanes else 5)
    return sum(v for v, _ in by_name.values()), sorted(
        by_name.items(), key=lambda kv: -kv[1][0])[:4]


def vgg_layers_on_card(device):
    """(a) BatchNorm (TRAIN and global), Scale and Bias at VGG11's shapes,
    unlaned and over C = 4 lanes (laned and unlaned bottoms), on the card
    against the port's CPU path on the same inputs: tops and the moving
    update within 1e-5 of their largest value (a batch mean of mixed
    signs cancels), gradients (input and params) within 1e-4 of theirs,
    scale_factor bit for bit. Returns the cases and the worst errors."""
    import torch
    from rram_caffe_simulation_tpu_torch import proto
    from rram_caffe_simulation_tpu_torch.core import prng
    from rram_caffe_simulation_tpu_torch.core.registry import (
        LayerContext, create_layer)
    cases = [("BatchNorm", "", proto.TRAIN), ("BatchNorm", "", proto.TEST),
             ("Scale", "scale_param { bias_term: true }", proto.TRAIN),
             ("Bias", "", proto.TRAIN)]
    # conv1's output alone unlaned (its laned copy is a large CPU run)
    shapes = {(100, 64, 32, 32): ((0, False),),
              (100, 512, 2, 2): ((0, False), (4, True), (4, False)),
              (100, 1024): ((0, False), (4, True), (4, False))}
    worst = {"top": 0.0, "grad": 0.0, "stats": 0.0}
    n = 0
    rng = np.random.RandomState(16)
    for ltype, param, phase in cases:
        for shape, lanings in shapes.items():
            for C, bottom_laned in lanings:
                lp = proto.parse(f'name: "l" type: "{ltype}" {param}',
                                 "LayerParameter")
                layer = create_layer(lp, phase)
                layer.setup([shape])
                lead = (C,) if C else ()
                params = [np.asarray(rng.randn(*(lead + tuple(p.shape))),
                                     np.float32)
                          for p in layer.init_params(prng.PRNGKey(0))]
                if ltype == "BatchNorm":
                    params[1] = np.abs(params[1]) + 0.5
                    params[2] = np.full(lead + (1,), 3.5, np.float32)
                xs = shape if not bottom_laned else \
                    (shape[0], C * shape[1]) + shape[2:]
                x = (rng.randn(*xs) * 2).astype(np.float32)
                out = {}
                for dev in ("cpu", device):
                    xt = torch.from_numpy(x).to(dev).requires_grad_()
                    pt = [torch.from_numpy(p).to(dev).requires_grad_()
                          for p in params]
                    ctx = LayerContext(phase=phase, lanes=C,
                                       laned=(bottom_laned,), updates={})
                    (y,) = layer.apply(pt, [xt], ctx)
                    g = torch.from_numpy(np.random.RandomState(3).randn(
                        *y.shape).astype(np.float32)).to(dev)
                    grads = torch.autograd.grad((y * g).sum(), [xt] + pt,
                                                allow_unused=True)
                    out[str(dev)] = (y.detach().cpu(), [
                        None if v is None else v.cpu() for v in grads],
                        [v.cpu() for v in ctx.updates.get("l", [])])
                    if dev != "cpu":
                        check(y.is_cuda, f"{ltype} left the card")
                (yc, gc, uc), (yk, gk, uk) = out["cpu"], out[str(device)]
                what = f"{ltype} phase {phase} {shape} C={C} " \
                    f"laned={bottom_laned}"
                e = float((yk - yc).abs().max() / yc.abs().max())
                worst["top"] = max(worst["top"], e)
                check(e <= 1e-5, f"{what}: top off by {e:.2e}")
                for a, b in zip(gc, gk):
                    if a is None:
                        check(b is None, f"{what}: a gradient on one device")
                        continue
                    e = float((b - a).abs().max() / a.abs().max().clamp(
                        min=1e-30))
                    worst["grad"] = max(worst["grad"], e)
                    check(e <= 1e-4, f"{what}: gradient off by {e:.2e}")
                check(len(uc) == len(uk), f"{what}: updates on one device")
                for j, (a, b) in enumerate(zip(uc, uk)):
                    if j == 2:
                        check(_same_bits(a, b), f"{what}: scale_factor")
                        continue
                    e = float((b - a).abs().max() / a.abs().max())
                    worst["stats"] = max(worst["stats"], e)
                    check(e <= 1e-5, f"{what}: moving stats off by {e:.2e}")
                n += 1
    return {"cases": n, "worst_rel": worst}


def vgg_tiled_reads(device):
    """(g)'s reads alone: B3a at conv2-8 and B2t at fc1-3
    (VGG_TILED_CASES), each through the layer's wrapper
    (`crossbar_conv_matmul`, `crossbar_matmul`) on the operands as the
    layer hands them over (the (K, N) view of Caffe's stored weight, the
    bool broken mask and stuck turned the same way, one seed), against
    the same wrapper's plain version: equal on dyadic inputs (sigma 0,
    no grid and ternary, ADC 3 and 8 bits) and on random ones (sigma 0
    and the path's 0.05 with the in-kernel noise and its twin, no grid
    and ternary, the layer's 8-bit ADC), as phase 9. Returns the largest
    |kernel - plain| of each kernel (0) and the cases."""
    import torch
    from rram_caffe_simulation_tpu_torch.fault import hw_aware as hw
    from rram_caffe_simulation_tpu_torch.fault.mapping import conv_patch_rows

    def turned(t):      # Caffe's stored (num_output, K), viewed (K, N)
        return t[0].t().contiguous().t()
    out = {"max_abs_err": {"B2t": 0.0, "B3a": 0.0}, "exact": 0,
           "exact_random": 0}
    for i, (name, (xs, geom, K, N, tiles)) in enumerate(
            VGG_TILED_CASES.items()):
        kernel = "B2t" if geom is None else "B3a"
        for dyadic in (True, False):
            x, w, br, st, _, _ = tiled_operands(xs, 1, False, K, N, dyadic,
                                                1600 + 2 * i + dyadic, device)
            wv, bv, sv = turned(w), turned(br > 0), turned(st)
            rows = x if geom is None else conv_patch_rows(x, geom)
            seed = 4242 + i
            runs = ([(0.0, 0, adc) for adc in (3, 8)]
                    + [(0.0, 2, adc) for adc in (3, 8)] if dyadic else
                    [(0.0, 0, 8), (VGG_SIGMA, 0, 8), (VGG_SIGMA, 2, 8)])
            for sigma, q_bits, adc in runs:
                t = (tiles[0], tiles[1], adc)
                with torch.no_grad():
                    yk, yp = (
                        hw.crossbar_matmul(x, wv, bv, sv, seed, sigma,
                                           q_bits, kernel_on, t)
                        if geom is None else
                        hw.crossbar_conv_matmul(x, wv, bv, sv, seed, sigma,
                                                q_bits, t, geom, kernel_on)
                        for kernel_on in (True, False))
                where = (f"{kernel} at VGG11's {name} (M, K, N = "
                         f"{rows.shape[0]}, {K}, {N}), dyadic={dyadic} "
                         f"sigma={sigma} q={q_bits} adc={adc}")
                same, share, e_max = exact_gap(yk, yp)
                check(same, f"{where}: differs from plain (share "
                      f"{share:.2e}, max err {e_max})")
                out["exact" if dyadic else "exact_random"] += 1
                out["max_abs_err"][kernel] = max(
                    out["max_abs_err"][kernel], e_max)
            del x, w, br, st, wv, bv, sv, rows, yk, yp
        torch.cuda.empty_cache()
    return out


def vgg_strategy_files(tmp, device, seed=7):
    """(prune order, prune net, prune model) for the VGG11 net, made as
    `strategy_files` makes them: a seeded permutation of fc1's and of
    fc2's 1024 outputs (one row each), the template's net, and a
    .caffemodel of fc1-3 (port's encode) at seeded magnitudes with the
    smaller half zero."""
    import torch
    from rram_caffe_simulation_tpu_torch import proto
    from rram_caffe_simulation_tpu_torch.core import prng
    from rram_caffe_simulation_tpu_torch.net import Net
    from rram_caffe_simulation_tpu_torch.utils.io import (
        read_net_param, read_solver_param, write_proto_binary)
    rng = np.random.RandomState(seed)
    order = tmp / "vgg_prune_order.txt"
    order.write_text("".join(" ".join(str(v) for v in rng.permutation(1024))
                             + "\n" for _ in range(2)))
    net_file = read_solver_param(VGG_TEMPLATE).net
    net = Net(read_net_param(net_file), proto.TRAIN, device=device)
    params = net.init(prng.PRNGKey(seed))
    fcs = ("fc1", "fc2", "fc3")
    for ln in fcs:
        w = params[ln][0].abs()
        params[ln][0] = torch.where(w < w.median(), 0.0, w)
    model = net.to_proto({ln: params[ln] for ln in fcs})
    model._values["layer"] = [lp for lp in model.layer if lp.name in fcs]
    path = tmp / "vgg_prune.caffemodel"
    write_proto_binary(str(path), model)
    return str(order), net_file, str(path)


def vgg_threshold(seed):
    """`calibrate_threshold` on the VGG11 Solver: the median of |update|
    / (rate * lr_mult) over the fault leaves' cells at the first step."""
    import torch
    from rram_caffe_simulation_tpu_torch.core import prng
    s = vgg_solver(seed=seed, strategies=[{"type": "threshold"}])
    step = s.make_train_step(hw_engine="torch", fault_format="packed",
                             pack_spec=s.pack_spec, fused_epilogue=True)
    with threshold_inputs() as seen:
        step(s.params, s.history, s.fault_state, s._next_batch(), 0,
             prng.fold_in(s._key, 0))
    rate, mults = s._lr_fn(0), _lr_mults(s)
    ratio = torch.cat([(u.abs() / (rate * mults[k])).flatten()
                       for k, u in seen[0].items()])
    return float(f"{float(ratio.median()):.3g}")


def vgg_solver_part(device, gpu, tmp):
    """(b) the Solver at full width, (c) each strategy, (e) iter_size 2,
    (f) its restart, (g) conv_also on 128x128 tiles."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    out = {"part_s": {}}
    t0 = time.perf_counter()
    s = vgg_solver(seed=1)
    check(s.net.name == "CIFAR10_VGG11_BN" and s.pack_spec is not None
          and s._step_fn.fused_epilogue_resolved
          and s._step_fn.hw_engine_resolved == "cuda",
          "the VGG11 Solver is not on the kernel path")
    out["part_s"]["build"] = time.perf_counter() - t0
    lock = vgg_lockstep(s, VGG_STEPS, "(b)", {"B2": 3, "B1": 1})
    out["lockstep"] = lock
    frac = s.broken_fraction()
    check(0 < frac < 1, f"broken fraction {frac}: no cell broke, or all")
    out["broken_fraction"] = frac
    print(f"phase 16: (b) VGG11 batch 100, N{VGG_LIFE}, sigma {VGG_SIGMA}, "
          f"packed banks, fused epilogue: {VGG_STEPS} steps kernel vs plain "
          f"in lockstep, launches B2 3 and B1 1 a step; "
          f"{json.dumps({k: v for k, v in lock.items() if k != 'losses'})}"
          f"; losses {[round(v, 5) for v in lock['losses']]}; broken "
          f"fraction {frac:.4f}", flush=True)
    out["part_s"]["lockstep"] = time.perf_counter() - t0

    # timed: the kernel path against the plain one in turns; the main
    # path's launches counted over the kernel path's steps alone
    t0 = time.perf_counter()
    a = vgg_solver(seed=2)
    p = vgg_solver(seed=2, hw_engine="torch")
    ms = {"a": [], "p": []}
    launches = _untiled(B2=0, B1=0, B4=0)
    torch.cuda.reset_peak_memory_stats()
    for _ in range(VGG_TIMED_STEPS):
        for key, x in (("a", a), ("p", p)):
            kernels.reset_launches()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            x.step(1)                       # ends in a host read: synced
            ms[key].append((time.perf_counter() - t1) * 1e3)
            if key == "a":
                launches = {k: launches[k] + v
                            for k, v in _launches().items()}
    peak = torch.cuda.max_memory_allocated()
    check(launches == _untiled(B2=3 * VGG_TIMED_STEPS, B1=VGG_TIMED_STEPS,
                               B4=0),
          f"the VGG11 Solver's steps launched {launches}")
    after = ({ln: [t.clone() for t in v] for ln, v in a.params.items()},
             {g: {k: v.clone() for k, v in tree.items()}
              for g, tree in a.fault_state.items()})
    warm = 2
    q = {k: [float(v) for v in np.percentile(v[warm:], [25, 50, 75])]
         for k, v in ms.items()}
    paired = float(np.median(np.subtract(ms["a"], ms["p"])[warm:]))
    breakdown = step_breakdown(a)
    bn_ms, bn_top = vgg_bn_scale_ms(a)
    out["main_path_launches"] = launches
    out["timed"] = {
        "step_ms_quartiles": q["a"], "plain_step_ms_quartiles": q["p"],
        "paired_diff_ms_median": paired, "n": VGG_TIMED_STEPS - warm,
        "device_busy_ms": breakdown["device_busy_ms"],
        "feed_ms": breakdown["feed_ms"], "top": breakdown["top"],
        "bn_scale_ms": bn_ms,
        "bn_scale_share": bn_ms / breakdown["device_busy_ms"],
        "bn_scale_top": [(nm[:50], v[0]) for nm, v in bn_top],
        "peak_bytes": peak}
    print(f"phase 16: (b) step time median {q['a'][1]:.3f} ms (quartiles "
          f"{q['a'][0]:.3f} / {q['a'][2]:.3f}), plain path {q['p'][1]:.3f} "
          f"ms, in turns (paired difference median {paired:.3f} ms); "
          f"kernels on the card {breakdown['device_busy_ms']:.3f} ms a step "
          f"({breakdown['device_busy_ms'] / q['a'][1]:.1%} busy), host feed "
          f"{breakdown['feed_ms']:.3f} ms; BatchNorm + Scale alone "
          f"{bn_ms:.3f} ms ({bn_ms / breakdown['device_busy_ms']:.1%} of "
          f"the busy time); peak memory {peak / 2 ** 30:.2f} GiB; top "
          f"kernels {breakdown['top']}; launches {launches}; {gpu}",
          flush=True)
    # test_all through the global statistics; nothing advances
    before = {ln: [t.clone() for t in v] for ln, v in a.params.items()}
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    scores = a.test_all()[0]
    torch.cuda.synchronize()
    test_ms = (time.perf_counter() - t1) * 1e3
    check(all(_same_bits(t, before[ln][i]) for ln, v in a.params.items()
              for i, t in enumerate(v)), "test_all moved a param")
    check(math.isfinite(scores["loss"]) and 0 <= scores["accuracy"] <= 1,
          f"test_all gave {scores}")
    out["test"] = {**scores, "test_iter": VGG_TEST_ITER, "ms": test_ms}
    # two runs from one seed: bit-identical after the timed steps
    b = vgg_solver(seed=2)
    b.step(VGG_TIMED_STEPS)
    same = all(_same_bits(t, b.params[ln][i]) for ln, v in after[0].items()
               for i, t in enumerate(v)) and all(
        _same_bits(v, b.fault_state[g][k])
        for g, tree in after[1].items() for k, v in tree.items())
    check(same, "two runs from one seed differ")
    out["two_runs_bit_identical"] = same
    out["part_s"]["timed"] = time.perf_counter() - t0
    del a, p, b
    torch.cuda.empty_cache()

    # (c) the strategies
    t0 = time.perf_counter()
    order, net_file, model = vgg_strategy_files(tmp, device)
    thr = vgg_threshold(seed=12)
    runs = {"threshold": [{"type": "threshold", "threshold": thr}],
            "remap_tracked": [{"type": "remapping", "start": 2, "period": 2,
                               "prune_order_file": order,
                               "track_identity": True}],
            "genetic": [{"type": "genetic", "start": 2, "period": 2,
                         "switch_time": 20, "prune_net_file": net_file,
                         "prune_model_file": model}]}
    out["strategies"] = {"threshold": thr}
    for name, entries in runs.items():
        st = vgg_solver(seed=12, strategies=entries)
        res = vgg_lockstep(st, VGG_STRATEGY_STEPS, f"(c) {name}",
                           {"B2": 3, "B1": 1})
        res.pop("losses")
        out["strategies"][name] = res
        print(f"phase 16: (c) {name}: {json.dumps(res)}", flush=True)
        del st
    check(out["strategies"]["remap_tracked"]["remap_events"] >= 2,
          "(c) too few remaps")
    check(out["strategies"]["genetic"]["genetic_applications"] >= 2,
          "(c) too few genetic applications")
    out["part_s"]["strategies"] = time.perf_counter() - t0

    # (e) iter_size 2
    t0 = time.perf_counter()
    s2 = vgg_solver(seed=3, iter_size=2)
    res = vgg_lockstep(s2, 3, "(e) iter_size 2", {"B2": 6, "B1": 1})
    res.pop("losses")
    out["iter_size_2"] = res
    print(f"phase 16: (e) iter_size 2: {json.dumps(res)}", flush=True)
    del s2
    out["part_s"]["iter_size"] = time.perf_counter() - t0

    # (f) snapshot at 2, restore into a fresh Solver, 2 steps on
    t0 = time.perf_counter()
    prefix = str(tmp / "vgg")
    full = vgg_solver(seed=5, snapshot=2, snapshot_prefix=prefix)
    losses = []
    _recording(full, losses)
    full.step(4)
    r = vgg_solver(seed=5, snapshot=0, snapshot_prefix=prefix + "_r")
    for _ in range(2):
        r.train_feed()          # the feed at the snapshot's position
    cont = []
    _recording(r, cont)
    r.restore(f"{prefix}_iter_2.solverstate")
    r.step(2)
    check(all(_same_bits(x, y) for x, y in zip(cont, losses[2:]))
          and len(cont) == 2, "(f) the restored Solver's losses differ")
    for ln, vals in full.params.items():
        for i, t in enumerate(vals):
            check(_same_bits(r.params[ln][i], t),
                  f"(f) params of {ln}/{i} differ after the restore")
    for g, tree in full.fault_state.items():
        for k, v in tree.items():
            check(_same_bits(r.fault_state[g][k], v),
                  f"(f) fault leaf {g}/{k} differs after the restore")
    out["restart_solver"] = {"bytes": {
        ext: os.path.getsize(f"{prefix}_iter_2.{ext}")
        for ext in ("caffemodel", "solverstate", "faultstate")}}
    del full, r
    out["part_s"]["restart"] = time.perf_counter() - t0

    # (g) conv_also on 128x128 tiles
    t0 = time.perf_counter()
    out.update(vgg_tiled_part(device))
    out["part_s"]["tiled"] = time.perf_counter() - t0
    return out


def vgg_tiled_part(device):
    """(g) conv_also on 128x128 tiles, B3a at conv2-8 and B2t at fc1-3:
    each read alone at its shape (`vgg_tiled_reads`), then 3 Solver
    steps kernel against plain without an ADC and with the template's
    8-bit ADC, each held as (b) and more: every read of the first step
    equal (no output apart), the losses equal and the banks bit for
    bit."""
    import torch
    from rram_caffe_simulation_tpu_torch.fault.fused import B1_LEAVES
    out = {}
    reads = vgg_tiled_reads(device)
    out["tiled_reads"] = reads
    print(f"phase 16: (g) B3a at conv2-8 and B2t at fc1-3 alone, batch "
          f"100: {json.dumps(reads)}", flush=True)
    out["tiled"] = {}
    for adc in (0, 8):
        tl = vgg_solver(seed=8, tiled=True, adc_bits=adc)
        tiles = tl._tiles_ctx()
        check(sorted(tiles) == sorted(VGG_TILED_CASES),
              f"tiled layers {sorted(tiles)}")
        for ln, (xs, _, K, N, t) in VGG_TILED_CASES.items():
            ly = tl.net.layer_by_name[ln]
            bottom = tl.net.blob_shapes[ly.lp.bottom[0]]
            flat = (bottom[0], math.prod(bottom[1:]))
            check(tuple(bottom) == xs or flat == xs,
                  f"{ln} reads {bottom}, (g)'s cases {xs}")
            kt = (ly._kernel_tiles(types.SimpleNamespace(
                tiles=tiles, adc_bits=adc))
                if ly.type_name == "InnerProduct" else (*tiles[ln], adc))
            check(tuple(kt) == (t[0], t[1], adc),
                  f"{ln} reads on tiles {kt}, (g)'s cases {t}")
        # 22 fault leaves: B1's table holds B1_LEAVES (16) a launch
        b1 = -(-len(tl._fault_keys) // B1_LEAVES)
        per_step = {"B2": 0, "B2t": 3, "B3": 7, "B1": b1}
        io = list(VGG_TILED_CASES)
        # the plain read sums each tile in the kernels' order and the
        # rest of the step is shared: the paths are one computation,
        # with or without the tiles' ADCs
        res = vgg_lockstep(tl, 3, f"(g) tiled, ADC {adc}", per_step, io=io)
        check(all(v["in_equal"] and v["out_apart_share"] == 0
                  for v in res["io"].values()),
              f"(g) ADC {adc}: a read parts: {res['io']}")
        check(res["loss_rel_max"] == 0 and res["rounding_cells"] == 0,
              f"(g) ADC {adc}: losses {res['loss_rel_max']} apart, "
              f"{res['rounding_cells']} bank cells apart")
        res.pop("losses")
        if adc:
            res["test"] = vgg_tiled_test(tl)
        out["tiled"][f"adc{adc}"] = res
        print(f"phase 16: (g) conv_also, {TILES}, implicit operand, ADC "
              f"{adc} bits: conv1's (27, 64) view fits one tile and is "
              f"read untiled; {json.dumps(res)}", flush=True)
        del tl
        torch.cuda.empty_cache()
    return out


def vgg_tiled_test(s):
    """test_all of the tiled Solver `s`: its reads arm no crossbar, so
    every tiled layer runs `tiled_crossbar_matmul` with `torch.matmul`
    partials, never the kernels' k-order twin (held: the twin is not
    called). Timed warm, as (b)'s untiled test_all."""
    import torch
    from rram_caffe_simulation_tpu_torch.fault import hw_aware as hw
    s.test_all()                                           # warm
    twin, calls = hw.ordered_tile_partials, [0]

    def counted(*a):
        calls[0] += 1
        return twin(*a)
    hw.ordered_tile_partials = counted
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = s.test_all()[0]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        hw.ordered_tile_partials = twin
    check(calls[0] == 0, f"(g) the tiled test_all ran the k-order twin "
          f"{calls[0]} times")
    check(math.isfinite(scores["loss"]) and 0 <= scores["accuracy"] <= 1,
          f"(g) the tiled test_all gave {scores}")
    return {**scores, "test_iter": VGG_TEST_ITER, "ms": ms,
            "twin_calls": calls[0]}


def vgg_sweep_part(gpu, tmp):
    """(d) the sweep at the largest C of VGG_SWEEP_CONFIGS that fits, and
    its checkpoint restart at C = 2."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.parallel import SweepRunner
    out = {}
    r = None
    for C in VGG_SWEEP_CONFIGS:
        try:
            torch.cuda.reset_peak_memory_stats()
            r = SweepRunner(vgg_solver(seed=4), n_configs=C, engine="cuda",
                            packed_state=True)
            r.step(1)
            break
        except torch.cuda.OutOfMemoryError:
            r = None
            torch.cuda.empty_cache()
            print(f"phase 16: (d) C = {C} does not fit", flush=True)
    check(r is not None, "no VGG11 sweep width fits the card")
    check(r._dataset is not None, "the VGG11 sweep's batches are not on "
          "the card")
    t0 = time.perf_counter()
    kernels.reset_launches()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    r.step(VGG_SWEEP_STEPS, chunk=VGG_SWEEP_STEPS)
    wall = time.perf_counter() - t1
    launches = _launches()
    n = VGG_SWEEP_STEPS
    check(launches == _untiled(B2=3 * n, B1=n, B4=5 * n),
          f"the VGG11 sweep launched {launches}, expected B2 3, B1 1, B4 5 "
          "a step")
    peak = torch.cuda.max_memory_allocated()
    bd = sweep_breakdown(r, 2)
    losses = r.last_losses
    check(bool(np.isfinite(losses).all()), "a VGG11 sweep lane went "
          "non-finite")
    out.update(configs=C, steps=n, configs_steps_per_s=C * n / wall,
               step_ms=wall / n * 1e3, peak_bytes=peak,
               main_path_launches=launches, device_busy_ms=bd[
                   "device_busy_ms"], top=bd["top"],
               bytes_per_step_est=r.bytes_per_step_est(),
               broken_fraction_range=[float(r.broken_fractions().min()),
                                      float(r.broken_fractions().max())])
    print(f"phase 16: (d) VGG11 sweep C = {C}: {C * n / wall:.2f} "
          f"configs*steps/s, step {wall / n * 1e3:.1f} ms, kernels on the "
          f"card {bd['device_busy_ms']:.1f} ms a step, peak memory "
          f"{peak / 2 ** 30:.2f} GiB, launches {launches}; top kernels "
          f"{bd['top']}; {gpu}", flush=True)
    # two lanes against two single-config Solvers, from their state
    single = vgg_solver(seed=4)
    check(single.pack_spec == r._pack_spec, "pack specs differ")
    noisy = single.net.bn_fed_biases(single._fault_keys)
    rate = write_rate(single)
    apart = 0
    for _ in range(2):
        batch = r._batch(r.iter)
        before = {i: r.lane_state(i) for i in (0, C - 1)}
        keys = r.lane_keys(r.iter)
        with tail_updates() as ku:
            kp, kh, kf, kl, _ = r._step(r.params, r.history, r.fault_states,
                                        batch, r.iter, keys)
        for i in (0, C - 1):
            with tail_updates() as su:
                sp_, _, sf, sl, _ = single._step_fn(*before[i], batch,
                                                    r.iter, keys[i])
            rel = abs(float(sl) - float(kl[i])) / max(1.0, abs(float(sl)))
            check(rel <= 1e-4, f"(d) lane {i}: sweep loss {float(kl[i])} "
                  f"vs Solver {float(sl)}")
            skip = rounding_cells(
                {k: v[i] for k, v in kf["life_q"].items()}, sf["life_q"],
                {k: v[i] for k, v in ku[0].items()}, su[0], noisy, rate,
                f"(d) lane {i}")
            apart += sum(int(m.sum()) for m in skip.values())
            for ln in sp_:
                if single.net.layer_by_name[ln].type_name != "BatchNorm":
                    continue
                for j, (x, y) in enumerate(zip(sp_[ln], kp[ln])):
                    ok = (_same_bits(x, y[i]) if j == 2 else float(
                        ((x - y[i]).abs() / y[i].abs().clamp(min=1.0))
                        .max()) <= 1e-4)
                    check(ok, f"(d) lane {i}: statistics {ln}/{j} differ")
        r._commit(kp, kh, kf, kl)
        r.iter += 1
    out["lanes_vs_solver"] = {"lanes": [0, C - 1], "steps": 2,
                              "rounding_cells": apart}
    r.close()
    del r, single
    torch.cuda.empty_cache()

    # (f) the sweep's checkpoint: restore and go on bit for bit
    t0 = time.perf_counter()
    a = SweepRunner(vgg_solver(seed=9), n_configs=2, engine="cuda",
                    packed_state=True)
    a.step(2, chunk=2)
    path = str(tmp / "vgg_sweep.ckpt.npz")
    a.checkpoint(path)
    want, _ = _sweep_steps(a, 2)
    leaves = _host_leaves(a)
    b = SweepRunner(vgg_solver(seed=9), n_configs=2, engine="cuda",
                    packed_state=True)
    b.restore(path)
    got, _ = _sweep_steps(b, 2)
    check(all(x.tobytes() == y.tobytes() for x, y in zip(got, want)),
          "(f) the restored sweep's losses differ")
    differ = _leaves_differ(_host_leaves(b), leaves)
    check(not differ, f"(f) sweep leaves differ after the restore: "
          f"{differ[:5]}")
    out["restart_sweep"] = {"configs": 2, "checkpoint_bytes":
                            os.path.getsize(path), "leaves": len(leaves),
                            "s": time.perf_counter() - t0}
    a.close()
    b.close()
    del a, b
    torch.cuda.empty_cache()
    return out


def phase_vgg(device, gpu):
    """Phase 16: the experiment template's VGG11-BN net at full width
    through B2, B1 and B4 (RRAM_POOL_BWD=cuda in the sweep; the Solver
    runs autograd's max-pool backward, its default): (a) the layers on
    the card, (b) the Solver,
    (c) each strategy, (d) the sweep, (e) iter_size 2, (f) restarts, (g)
    conv_also on tiles."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    saved = os.environ.get("RRAM_POOL_BWD")
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            layers = vgg_layers_on_card(device)
            print(f"phase 16: (a) {json.dumps(layers)}", flush=True)
            t1 = time.perf_counter()
            # the Solver with the default max-pool backward (autograd's),
            # as a user runs it; the sweep through B4
            os.environ.pop("RRAM_POOL_BWD", None)
            solver = vgg_solver_part(device, gpu, Path(tmp))
            t2 = time.perf_counter()
            os.environ["RRAM_POOL_BWD"] = "cuda"
            sweep = vgg_sweep_part(gpu, Path(tmp))
    finally:
        if saved is None:
            os.environ.pop("RRAM_POOL_BWD", None)
        else:
            os.environ["RRAM_POOL_BWD"] = saved
    torch.cuda.empty_cache()
    out = {"layers": layers, "solver": solver, "sweep": sweep,
           "part_s": {"layers": t1 - t0, "solver": t2 - t1,
                      "sweep": time.perf_counter() - t2},
           "phase_s": time.perf_counter() - t0, "gpu": gpu}
    print(f"phase 16: {json.dumps(out['part_s'])}", flush=True)
    print(json.dumps({"vgg11": out}), flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 17: the sweep's pipeline and the telemetry plane

TELEMETRY_CHUNK = 10             # bench.py's chunk
TELEMETRY_CHUNKS = 3             # chunks of (c)'s census run
TELEMETRY_DEPTH_CHUNKS = 2       # chunks of each depth's run in (a)
TELEMETRY_DEPTH_CHUNK = 5        # (a)'s chunk (bench.py's 10 before phase 23)
TELEMETRY_SEED = 17
SOLVER_METRIC_STEPS = 50         # (b)'s lockstep steps, display 10
SOLVER_TIMED_STEPS = 10          # (b)'s timed steps each way, in turns
                                 # (20 before phase 25)
HEALTH_EVERY = 10
STALL_TIMEOUT_S = 2.0
STALL_CONFIGS = 8
TIMING_FIELDS = ("wall_time", "step_latency_s", "iters_per_s")


class _ListSink:
    """A metric sink that keeps its records."""

    def __init__(self):
        self.records = []

    def write(self, record):
        self.records.append(record)


def _timing_off(records):
    return [{k: v for k, v in r.items() if k not in TIMING_FIELDS}
            for r in records if r.get("type") != "span"]


def _jsonl(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def sync_sites(fn, *args):
    """(fn(*args), ["file:line" of each synchronizing CUDA call it
    made]), by torch's sync debug mode."""
    import torch
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn(*args)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [f"{os.path.relpath(w.filename, REPO)}:{w.lineno}"
                 for w in caught if "synchroniz" in str(w.message)]


def _state_equal(a: dict, b: dict) -> list:
    """Names of the leaves of two runner states that differ in a bit."""
    return sorted(k for k in a if not torch_equal(a[k], b[k]))


def torch_equal(x, y) -> bool:
    import torch
    return x.dtype == y.dtype and x.shape == y.shape and bool(
        torch.equal(x, y))


def _recount_leaf(life, stuck, tiles, lead, edges):
    """The census of one leaf recounted in numpy from host arrays: per
    tile (mid-bin lifetimes, f32) the lifetime histogram (a value's bin
    is the count of edges below it, 0 first), broken count and fraction
    (count times the f32 reciprocal of the cells), mean, min, and the
    stuck values of the broken cells."""
    shape = life.shape[lead:]
    nd = len(shape)
    if nd > 2:                       # a conv kernel: its (K, N) view
        flat = life.reshape(life.shape[:lead] + (shape[0], -1))
        life = np.swapaxes(flat, -1, -2)
        stuck = np.swapaxes(stuck.reshape(flat.shape), -1, -2)
        nd = 2
    if nd == 2 and tiles is not None and not tiles.is_default:
        slices = [sl for _, sl in tiles.tile_slices(life.shape[-2:])]
    else:
        slices = [None]
    out = {k: [] for k in ("life_hist", "broken", "broken_frac", "life_min",
                           "life_mean", "stuck_neg", "stuck_zero",
                           "stuck_pos")}
    bounds = np.array([0.0] + list(edges), np.float32)
    for sl in slices:
        lt, st = life, stuck
        if sl is not None:
            r0, r1, c0, c1 = sl
            lt, st = lt[..., r0:r1, c0:c1], st[..., r0:r1, c0:c1]
        lt = lt.reshape(lt.shape[:lead] + (-1,))
        st = st.reshape(lt.shape)
        cells = lt.shape[-1]
        idx = (lt[..., None] > bounds).sum(-1)
        out["life_hist"].append(np.stack(
            [(idx == b).sum(-1) for b in range(len(bounds) + 1)], -1))
        broken = lt <= 0
        count = broken.sum(-1)
        out["broken"].append(count)
        out["broken_frac"].append(count.astype(np.float32) * (
            np.float32(1) / np.float32(cells)))
        out["life_min"].append(lt.min(-1))
        out["life_mean"].append(lt.astype(np.float64).mean(-1))
        for name, v in (("stuck_neg", -1), ("stuck_zero", 0),
                        ("stuck_pos", 1)):
            out[name].append((broken & (st == v)).sum(-1))
    return {k: np.stack(v, -2 if k == "life_hist" else -1)
            for k, v in out.items()}


def host_census(state, spec, tiles, lead):
    """{param: recount} of a packed fault state's host copy."""
    from rram_caffe_simulation_tpu_torch.observe.health import LIFE_EDGES
    d = float(spec["decrement"])
    out = {}
    for k, q in state["life_q"].items():
        q = q.detach().cpu().numpy()
        life = ((q.astype(np.float32) - np.float32(0.5))
                * np.float32(d)).astype(np.float32)
        bank = state["stuck_bits"][k].detach().cpu().numpy()
        codes = np.stack([(bank >> (2 * i)) & 3 for i in range(4)], -1)
        stuck = (codes.reshape(bank.shape[:-1] + (-1,))
                 [..., :spec["last_dim"][k]].astype(np.float32) - 1.0)
        out[k] = _recount_leaf(life, stuck, tiles, lead, LIFE_EDGES)
    return out


def _census_matches(params, recount, where):
    """A health record's payload against the numpy recount: integer
    fields exactly, the fractions exactly (the same f32 product),
    life_mean within 1e-6 relative."""
    for k, st in params.items():
        rc = recount[k]
        for name in ("life_hist", "stuck_neg", "stuck_zero", "stuck_pos",
                     "broken_frac"):
            got = np.asarray(st[name])
            check(np.array_equal(got, rc[name].astype(got.dtype)),
                  f"{where}: {k} {name} differs from the host recount")
        got = np.asarray(st["life_mean"], np.float64)
        check(np.allclose(got, rc["life_mean"], rtol=1e-6, atol=0),
              f"{where}: {k} life_mean differs from the host recount")
        hist = rc["life_hist"]
        cells = hist.reshape((-1,) + hist.shape[-2:])[0].sum(-1)
        check(st["cells"] == [int(c) for c in cells],
              f"{where}: {k} cells differ from the host recount")


def telemetry_runner(C, depth, sink=None, health_every=0, seed=None,
                     stall=None, mean=1e8, std=3e7):
    """Phase 7's sweep configuration (RRAM_POOL_BWD is the caller's) with
    metrics to `sink` and the pipeline at `depth`."""
    from rram_caffe_simulation_tpu_torch.parallel import SweepRunner
    s = slice_solver(mean, std, seed=TELEMETRY_SEED if seed is None
                     else seed)
    if sink is not None:
        s.enable_metrics(sink)
    return SweepRunner(s, n_configs=C, engine="cuda", packed_state=True,
                       dtype_policy="ternary", pipeline_depth=depth,
                       health_every=health_every, stall_timeout_s=stall)


def telemetry_depths(tmp, gpu):
    """(a): the C = 512 sweep at depth None, 0 and 2 from one seed."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.observe import sink as obs_sink
    from rram_caffe_simulation_tpu_torch.observe import spans as obs_spans
    steps = TELEMETRY_DEPTH_CHUNK * TELEMETRY_DEPTH_CHUNKS
    C = SWEEP_CONFIGS
    runs, out, files = {}, {}, []
    for depth in (None, 0, 2):
        path = tmp / f"sweep_depth_{depth}.jsonl"
        files.append(path)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = telemetry_runner(C, depth, obs_sink.JsonlSink(str(path)))
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        check(r._dataset is not None and r.engine_resolved == "cuda"
              and r.fused_epilogue_resolved,
              f"(a) depth {depth}: not phase 7's path")
        r.enable_tracing(profile_dir=str(tmp / f"trace_{depth}"))
        syncs = None
        if depth is None:
            # the laned step with its metrics against the same step
            # without them, from the runner's state (not advanced)
            off = r.solver.make_train_step(
                hw_engine="cuda", dtype_policy="ternary",
                fault_format="packed", pack_spec=r._pack_spec,
                fused_epilogue=True, lanes=r.n, with_metrics=False)
            args = (r.params, r.history, r.fault_states, r._batch(r.iter),
                    r.iter, r.lane_keys(r.iter))
            syncs = {}
            for name, fn in (("metrics_on", r._step), ("metrics_off", off)):
                for _ in range(2):
                    res, sites = sync_sites(fn, *args)
                    del res
                syncs[name] = sites
            check(len(syncs["metrics_on"]) == len(syncs["metrics_off"]),
                  f"(a) metrics add synchronizing calls to the laned step: "
                  f"{syncs}")
            del off, args
        kernels.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses, outputs = r.step(steps, chunk=TELEMETRY_DEPTH_CHUNK)
        wall = time.perf_counter() - t0
        launches = _launches()
        check(launches == _untiled(B2=2 * steps, B1=steps, B4=steps),
              f"(a) depth {depth}: launches {launches}")
        state = {k: v.clone() for k, v in r._state_arrays().items()}
        setup = r.setup_record(setup_s)
        breakdown = obs_spans.bench_phase_breakdown(r._tracer.events())
        trace = r.write_trace()
        r.close()
        r.solver.metrics_logger.close()
        runs[depth] = {"losses": losses, "outputs": outputs, "state": state,
                       "chunk_losses": r.chunk_losses,
                       "records": _jsonl(path)}
        out[str(depth)] = {
            "configs_steps_per_s": C * steps / wall, "wall_s": wall,
            "step_ms": wall / steps * 1e3, "setup_s": setup_s,
            "host_blocked_seconds": r.pipeline.host_blocked_s,
            "drain_seconds": r.pipeline.drain_s,
            "consumer_seconds": (r._consumer.consumer_s
                                 if r._consumer is not None else 0.0),
            "records": r.pipeline.records, "launches": launches,
            "phase_breakdown": breakdown}
        if depth == 2:
            out["setup_record"] = setup
            out["trace"] = trace
        if syncs is not None:
            out["step_syncs"] = syncs
        print(f"phase 17: (a) depth {depth}: "
              f"{out[str(depth)]['configs_steps_per_s']:.1f} configs*steps/s "
              f"({wall:.3f} s for {steps} steps at C = {C}, chunk "
              f"{TELEMETRY_DEPTH_CHUNK}); host blocked "
              f"{r.pipeline.host_blocked_s:.6f} s, drain "
              f"{r.pipeline.drain_s:.6f} s; {gpu}", flush=True)
        del r
        torch.cuda.empty_cache()
    base = runs[0]
    for depth in (None, 2):
        run = runs[depth]
        check(run["losses"].tobytes() == base["losses"].tobytes()
              and sorted(run["outputs"]) == sorted(base["outputs"])
              and all(run["outputs"][k].tobytes()
                      == base["outputs"][k].tobytes()
                      for k in base["outputs"])
              and run["chunk_losses"].tobytes()
              == base["chunk_losses"].tobytes(),
              f"(a) depth {depth}: losses or outputs differ from depth 0")
        differ = _state_equal(base["state"], run["state"])
        check(not differ, f"(a) depth {depth}: state differs from depth 0 "
              f"in {differ[:5]}")
    check(_timing_off(runs[2]["records"]) == _timing_off(base["records"])
          and len(_timing_off(base["records"])) == TELEMETRY_DEPTH_CHUNKS,
          "(a) depth 2's records differ from depth 0's (timing aside)")
    check(_timing_off(runs[None]["records"]) == [],
          "(a) depth None fed the sinks")
    check(out["2"]["host_blocked_seconds"] < out["0"]["host_blocked_seconds"],
          f"(a) depth 2 blocked the host {out['2']['host_blocked_seconds']} "
          f"s, not below depth 0's {out['0']['host_blocked_seconds']} s")
    out["depth2_gain"] = (out["2"]["configs_steps_per_s"]
                          / out["0"]["configs_steps_per_s"] - 1.0)
    print(f"phase 17: (a) depth 2 against depth 0: "
          f"{out['depth2_gain']:+.2%} configs*steps/s; losses, outputs, "
          f"params, history, banks and records identical at every depth",
          flush=True)
    print(f"phase 17: (a) setup record {json.dumps(out['setup_record'])}",
          flush=True)
    print(f"phase 17: (a) bench_phase_breakdown (depth 2) "
          f"{json.dumps(out['2']['phase_breakdown'])}", flush=True)
    for name, sites in out["step_syncs"].items():
        print(f"phase 17: (a) laned step, {name}: {len(sites)} "
              f"synchronizing calls {sites}", flush=True)
    return out, files


def telemetry_solver(tmp, gpu):
    """(b): the phase-4 slice with metrics, kernel path against plain
    path in lockstep; syncs per step and the step time with metrics on
    and off; (c)'s census of the Solver."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.fault import fused, hw_aware
    from rram_caffe_simulation_tpu_torch.observe import sink as obs_sink
    seed = TELEMETRY_SEED + 1
    paths = {name: tmp / f"solver_{name}.jsonl" for name in ("kernel",
                                                             "plain")}
    k = slice_solver(1e8, 3e7, seed=seed)
    p = slice_solver(1e8, 3e7, seed=seed, hw_engine="torch")
    for s, name in ((k, "kernel"), (p, "plain")):
        s.param.display = 10
        s.enable_metrics(obs_sink.JsonlSink(str(paths[name])))
    k.enable_health(HEALTH_EVERY)
    kernels.reset_launches()
    clone = lambda tree: {n: [None if t is None else t.clone() for t in v]
                          for n, v in tree.items()}
    for _ in range(SOLVER_METRIC_STEPS):
        p.params = clone(k.params)
        p.history = {n: {sl: t.clone() for sl, t in v.items()}
                     for n, v in k.history.items()}
        p.fault_state = {g: {n: t.clone() for n, t in v.items()}
                         for g, v in k.fault_state.items()}
        b2, b1 = hw_aware.CROSSBAR_LIB.launches, fused.FUSED_LIB.launches
        k.step(1)
        check(hw_aware.CROSSBAR_LIB.launches == b2 + 2
              and fused.FUSED_LIB.launches == b1 + 1,
              "(b) the kernel path did not launch B2 twice and B1 once")
        p.step(1)
        check(hw_aware.CROSSBAR_LIB.launches == b2 + 2
              and fused.FUSED_LIB.launches == b1 + 1,
              "(b) the plain path launched a kernel")
    for s in (k, p):
        s.metrics_logger.sinks[0].flush()
    recs = {n: [r for r in _jsonl(paths[n]) if r.get("type") is None]
            for n in paths}
    check(len(recs["kernel"]) == len(recs["plain"])
          == SOLVER_METRIC_STEPS // 10, f"(b) records {len(recs['kernel'])}")
    worst = 0.0

    def walk(a, b, where):
        nonlocal worst
        if isinstance(a, dict):
            check(sorted(a) == sorted(b), f"(b) {where}: keys differ")
            for key in a:
                if key not in TIMING_FIELDS:
                    walk(a[key], b[key], f"{where}.{key}")
        elif isinstance(a, list):
            check(len(a) == len(b), f"(b) {where}: lengths differ")
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{where}[{i}]")
        elif isinstance(a, int) and not isinstance(a, bool):
            check(isinstance(b, int) and a == b,
                  f"(b) {where}: integer {a} against {b}")
        elif isinstance(a, float):
            rel = abs(a - b) / max(abs(a), abs(b), 1e-30)
            worst = max(worst, rel)
            check(rel <= 1e-5, f"(b) {where}: {a} against {b}")
        else:
            check(a == b, f"(b) {where}: {a!r} against {b!r}")
    for a, b in zip(recs["kernel"], recs["plain"]):
        walk(a, b, f"iter {a['iter']}")
    # (c): the Solver's censuses, the last against the final banks
    health = [r for r in _jsonl(paths["kernel"]) if r.get("type") == "health"]
    check([r["iter"] for r in health]
          == list(range(HEALTH_EVERY, SOLVER_METRIC_STEPS + 1, HEALTH_EVERY)),
          f"(c) Solver census iterations {[r['iter'] for r in health]}")
    _census_matches(health[-1]["params"],
                    host_census(k.fault_state, k.pack_spec, None, 0),
                    "(c) Solver census")
    census_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k._health_census(k.fault_state)
        census_ms.append((time.perf_counter() - t0) * 1e3)
    k.enable_health(0)
    # syncs a step with metrics on against off, the same state
    off = slice_solver(1e8, 3e7, seed=seed)
    off.param.display = 10
    syncs = {}
    for name, s in (("metrics_on", k), ("metrics_off", off)):
        batch = {n: torch.as_tensor(v).to(s.device)
                 for n, v in s.train_feed().items()}
        from rram_caffe_simulation_tpu_torch.core import prng
        rng = prng.fold_in(s._key, s.iter)
        for _ in range(2):
            res, sites = sync_sites(s._step_fn, s.params, s.history,
                                    s.fault_state, batch, s.iter, rng)
            del res
        syncs[name] = sites
    check(len(syncs["metrics_on"]) == len(syncs["metrics_off"]),
          f"(b) metrics add synchronizing calls to the step: {syncs}")
    # the step time with metrics on and off, in turns
    times = {"metrics_on": [], "metrics_off": []}
    for _ in range(SOLVER_TIMED_STEPS):
        for name, s in (("metrics_on", k), ("metrics_off", off)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            s.step(1)                # ends in a host read of the loss
            times[name].append((time.perf_counter() - t0) * 1e3)
    for s in (k, p):
        s.metrics_logger.close()
    # the median reads a step no record reads (its tree is writes_saved
    # alone); the mean spreads the display steps' full trees over all
    med = {n: float(np.median(v[2:])) for n, v in times.items()}
    mean = {n: float(np.mean(v[2:])) for n, v in times.items()}
    out = {"records": len(recs["kernel"]), "worst_float_rel": worst,
           "step_syncs": syncs, "step_ms_median": med, "step_ms_mean": mean,
           "metrics_cost_ms": med["metrics_on"] - med["metrics_off"],
           "metrics_cost_mean_ms": mean["metrics_on"] - mean["metrics_off"],
           "census_ms": float(np.median(census_ms)),
           "census_share_of_every": float(np.median(census_ms))
           / (HEALTH_EVERY * med["metrics_off"]),
           "censuses": len(health)}
    print(f"phase 17: (b) Solver, {SOLVER_METRIC_STEPS} lockstep steps, "
          f"display 10: kernel and plain records equal (integers exactly, "
          f"floats within {worst:.2e}, limit 1e-5); synchronizing calls a "
          f"step, metrics on {len(syncs['metrics_on'])} "
          f"{syncs['metrics_on']}, off {len(syncs['metrics_off'])}; step "
          f"median on {med['metrics_on']:.3f} ms, off "
          f"{med['metrics_off']:.3f} ms, mean on {mean['metrics_on']:.3f} "
          f"ms, off {mean['metrics_off']:.3f} ms (in turns, n = "
          f"{SOLVER_TIMED_STEPS - 2} each); {gpu}", flush=True)
    print(f"phase 17: (c) Solver census {out['census_ms']:.3f} ms "
          f"({out['census_share_of_every']:.3%} of {HEALTH_EVERY} steps); "
          f"{len(health)} censuses equal to the host recount", flush=True)
    return out, list(paths.values())


def telemetry_health(tmp, gpu, step_ms):
    """(c): the C = 512 sweep with health_every 10 at depth 2, and the
    tiled slice's per-tile counters and census."""
    import torch
    from rram_caffe_simulation_tpu_torch.observe import schema as obs_schema
    from rram_caffe_simulation_tpu_torch.observe import sink as obs_sink
    path = tmp / "sweep_health.jsonl"
    steps = TELEMETRY_CHUNK * TELEMETRY_CHUNKS
    r = telemetry_runner(SWEEP_CONFIGS, 2, obs_sink.JsonlSink(str(path)),
                         health_every=HEALTH_EVERY)
    r.step(steps, chunk=TELEMETRY_CHUNK)
    census_ms = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r._health_census(r.fault_states)
        census_ms.append((time.perf_counter() - t0) * 1e3)
    r.close()
    r.solver.metrics_logger.close()
    health = [x for x in _jsonl(path) if x.get("type") == "health"]
    check([x["iter"] for x in health] == [20, 30],
          f"(c) sweep census iterations {[x['iter'] for x in health]}")
    for x in health:
        check(obs_schema.validate_record(x) == [] and x["lane_map"]
              == list(range(SWEEP_CONFIGS)), "(c) a sweep census record")
    _census_matches(health[-1]["params"],
                    host_census(r.fault_states, r._pack_spec, None, 1),
                    "(c) sweep census")
    summary = r.health_summary()
    del r
    torch.cuda.empty_cache()
    ms = float(np.median(census_ms))
    out = {"sweep_census_ms": ms,
           "sweep_census_share_of_every": ms / (HEALTH_EVERY * step_ms),
           "sweep_summary": summary}
    # the tiled slice: per-tile counters and census after 4 steps at
    # N(300, 50), cells breaking
    from rram_caffe_simulation_tpu_torch.fault.mapping import TileSpec
    tpath = tmp / "tiled_solver.jsonl"
    s = slice_solver(300.0, 50.0, seed=TELEMETRY_SEED + 2, tiled=True)
    s.param.display = 1
    s.enable_metrics(obs_sink.JsonlSink(str(tpath)))
    s.enable_health(1)
    s.step(4)
    s.metrics_logger.close()
    recs = _jsonl(tpath)
    last = [x for x in recs if x.get("type") is None][-1]
    census = [x for x in recs if x.get("type") == "health"][-1]
    check(last["iter"] == 3 and census["iter"] == 4
          and census["tiles"] == TILES, "(c) the tiled slice's records")
    tiles = TileSpec.parse(TILES)
    rc = host_census(s.fault_state, s.pack_spec, tiles, 0)
    _census_matches(census["params"], rc, "(c) tiled census")
    pt = last["fault"]["per_tile"]
    check(sorted(pt) == sorted(k for k in rc if k.endswith("/0")),
          f"(c) per_tile leaves {sorted(pt)}")
    broken_tiles = 0
    for k, st in pt.items():
        for name in ("broken_frac", "life_min", "stuck_neg", "stuck_zero",
                     "stuck_pos"):
            got = np.asarray(st[name])
            check(np.array_equal(got, rc[k][name].astype(got.dtype)),
                  f"(c) per_tile {k} {name} differs from the host recount")
        broken_tiles += int((np.asarray(st["broken_frac"]) > 0).sum())
    check(broken_tiles > 0, "(c) no tile of the tiled slice broke")
    out["tiled"] = {"per_tile_leaves": len(pt), "tiles_with_broken_cells":
                    broken_tiles,
                    "tiles": sum(len(v["broken_frac"]) for v in pt.values())}
    print(f"phase 17: (c) sweep census at C = {SWEEP_CONFIGS}: {ms:.3f} ms "
          f"({out['sweep_census_share_of_every']:.3%} of {HEALTH_EVERY} "
          f"steps at {step_ms:.3f} ms); censuses at 20 and 30 equal to the "
          f"host recount; summary {json.dumps(summary)}; tiled slice: "
          f"per-tile counters and census of {out['tiled']['tiles']} tiles "
          f"({broken_tiles} with broken cells) equal to the host recount; "
          f"{gpu}", flush=True)
    return out, [path, tpath]


def telemetry_stall(tmp, gpu):
    """(d): a sink that blocks; the emergency checkpoint continues bit for
    bit against the run that never stalled."""
    import threading
    import torch
    from rram_caffe_simulation_tpu_torch import async_exec
    release = threading.Event()
    kept = _ListSink()

    class BlockingSink:
        def write(self, record):
            kept.write(record)
            if len(kept.records) >= 2:
                release.wait(60.0)       # a wedged filesystem

    seed = TELEMETRY_SEED + 3
    r = telemetry_runner(STALL_CONFIGS, 1, BlockingSink(), seed=seed,
                         stall=STALL_TIMEOUT_S, mean=300.0, std=50.0)
    r.solver.param.snapshot_prefix = str(tmp / "stall")
    t0 = time.perf_counter()
    try:
        r.step(200, chunk=1)
        raise Check("(d) the blocking sink did not stall the sweep")
    except async_exec.StallError as e:
        took = time.perf_counter() - t0
        path = e.checkpoint_path
    finally:
        release.set()
    it = r.iter
    check(took < 10.0, f"(d) StallError after {took:.1f} s (limit 10)")
    check(path is not None and os.path.exists(path)
          and path.endswith(f"_sweep_stall_iter_{it}.ckpt.npz"),
          f"(d) no emergency checkpoint ({path})")
    again = r.step(2)
    check(r.iter == it, "(d) the stop is not sticky")
    del r, again
    more = 3
    fresh = telemetry_runner(STALL_CONFIGS, None, seed=seed, mean=300.0,
                             std=50.0)
    fresh.restore(path)
    got = fresh.step(more)[0]
    full = telemetry_runner(STALL_CONFIGS, None, seed=seed, mean=300.0,
                            std=50.0)
    full.step(it, chunk=it)
    want = full.step(more)[0]
    check(got.tobytes() == want.tobytes(),
          "(d) the restored run's losses differ from the unstalled run's")
    differ = _state_equal(
        {k: v for k, v in full._state_arrays().items()},
        {k: v for k, v in fresh._state_arrays().items()})
    check(not differ, f"(d) the restored state differs in {differ[:5]}")
    out = {"stall_s": took, "iter": it, "checkpoint": os.path.basename(path),
           "checkpoint_bytes": os.path.getsize(path),
           "records_before": len(kept.records)}
    print(f"phase 17: (d) C = {STALL_CONFIGS}, stall_timeout_s "
          f"{STALL_TIMEOUT_S}: StallError after {took:.2f} s at iteration "
          f"{it}, emergency checkpoint {out['checkpoint']} "
          f"({out['checkpoint_bytes']} bytes) restored: {more} steps equal "
          f"to the run that never stalled, bit for bit", flush=True)
    del fresh, full
    torch.cuda.empty_cache()
    return out, kept.records


def phase_telemetry(gpu):
    """Phase 17: the pipeline at three depths, the Solver's metrics, the
    health census, a stall, and every file they wrote."""
    import tempfile
    import torch
    from rram_caffe_simulation_tpu_torch.observe import schema as obs_schema
    t0 = time.perf_counter()
    saved = os.environ.get("RRAM_POOL_BWD")
    os.environ["RRAM_POOL_BWD"] = "cuda"
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as d:
            tmp = Path(d)
            depths, files = telemetry_depths(tmp, gpu)
            os.environ.pop("RRAM_POOL_BWD")     # (b) as phase 4 runs
            solver, more = telemetry_solver(tmp, gpu)
            os.environ["RRAM_POOL_BWD"] = "cuda"
            files += more
            health, more = telemetry_health(tmp, gpu,
                                            depths["2"]["step_ms"])
            files += more
            stall, stall_records = telemetry_stall(tmp, gpu)
            # (e) every line of every file, and the stall's records
            lines = 0
            for path in files:
                for rec in _jsonl(path):
                    errs = obs_schema.validate_record(rec)
                    check(errs == [], f"(e) {path.name}: {errs}")
                    lines += 1
            for rec in stall_records:
                check(obs_schema.validate_record(rec) == [],
                      "(e) a stall record")
            with open(depths["trace"]) as f:
                trace = json.load(f)
            tracks = sorted({e["args"]["name"] for e in trace["traceEvents"]
                             if e.get("ph") == "M"
                             and e["name"] == "thread_name"})
            check({"dispatcher", "chunk-consumer"} <= set(tracks),
                  f"(e) trace tracks {tracks}")
            depths["trace"] = os.path.basename(depths["trace"])
    finally:
        if saved is None:
            os.environ.pop("RRAM_POOL_BWD", None)
        else:
            os.environ["RRAM_POOL_BWD"] = saved
    torch.cuda.empty_cache()
    out = {"depths": depths, "solver": solver, "health": health,
           "stall": stall, "files": {"jsonl_lines": lines + len(
               stall_records), "trace_tracks": tracks},
           "phase_s": time.perf_counter() - t0, "gpu": gpu}
    print(f"phase 17: (e) {out['files']['jsonl_lines']} JSONL lines valid; "
          f"trace tracks {tracks}; phase 17 {out['phase_s']:.1f} s",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 18: config_block, evaluate, debug_info and the watchdog

BLOCK_STEPS = 3                  # (a)'s steps of each runner
BLOCK_TIMED = 3                  # (b)'s timed steps, after one warm step
BLOCK_CONFIGS = 512              # (b)'s tiled sweep and (d)'s evaluate
BLOCK = 64                       # (b)'s and (c)'s lanes a block
VGG_BLOCK_CONFIGS = (512, 256)   # (c): the largest that fits is taken
VGG_BLOCK_TIMED = 1              # (c)'s timed step (8 blocks), after a warm
                                 # one (setup draws 786M cells, about 26 s)
EVAL_LANES = (0, 1, 255, 511)    # (d)'s lanes held to a single config
DEBUG_STEPS = 3                  # (e)'s lockstep steps
DEBUG_REL = 1e-5                 # (e): debug values, kernel against plain
WATCH_CONFIGS = 8                # (f)'s sweep
DEBUG_LINES = (                  # the reference's debug_info line shapes
    r"    \[Forward\] Layer \S+, (top|param) blob \S+ data: \S+$",
    r"    \[Backward\] Layer \S+, (bottom|param) blob \S+ diff: \S+$",
    r"    \[Backward\] All net params \(data, diff\): L1 norm = "
    r"\(\S+, \S+\); L2 norm = \(\S+, \S+\)$",
    r"    \[Update\] Layer \S+, param \S+ data: \S+; diff: \S+$")


def _iteration_events(r, events):
    """Wrap the runner's iteration so a CUDA event is recorded on the
    stream after each one (all its blocks): the gaps are the step times
    on the device's timeline, with no host synchronization."""
    import torch
    inner = r._iteration

    def iteration(*a, **kw):
        out = inner(*a, **kw)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        events.append(ev)
        return out
    r._iteration = iteration


def _debug_host(r):
    """The last iteration's debug vectors of a runner, on the host."""
    return {k: (v.detach().cpu() if not isinstance(v, dict) else
                {kk: vv.detach().cpu() for kk, vv in v.items()})
            for k, v in r.last_metrics["debug"].items()}


def blocked_pair(make, C, B, steps, per_step, after=None):
    """(a): runners from `make()` (one seed; the solver's watchdog armed,
    so every lane carries its sentinels) unblocked and in blocks of B,
    `steps` steps each, a step at a time: every step's lane losses, and
    at the end every params, history, fault-bank and quarantine leaf and
    the sentinels, bit for bit; the blocked run launching `per_step`
    times C / B a step. `after(runner)` then runs on the blocked
    runner."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    runs = []
    for block in (0, B):
        r = make(block)
        check(len(r._blocks) == (C // B if block else 1),
              f"C = {C} in blocks of {block}: {len(r._blocks)} blocks")
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        losses = [r.step(1)[0].copy() for _ in range(steps)]
        dt = time.perf_counter() - t0
        launches = _launches()
        runs.append((losses, _host_leaves(r), _debug_host(r), launches, dt))
        if block and after is not None:
            runs[-1] += (after(r),)
        r.close()
        del r
        torch.cuda.empty_cache()
    (la, sa, da, _, ta), (lb, sb, db, lnb, tb) = runs[0], runs[1][:5]
    for i, (x, y) in enumerate(zip(la, lb)):
        check(x.tobytes() == y.tobytes(),
              f"C = {C}, blocks of {B}: step {i}'s losses differ from the "
              f"unblocked run's ({int((x != y).sum())} lanes)")
    differ = _leaves_differ(sa, sb)
    check(not differ, f"C = {C}, blocks of {B}: leaves differ from the "
          f"unblocked run's: {differ[:6]}")
    for k, v in da["sentinel"].items():
        check(_same_bits(v, db["sentinel"][k]), f"C = {C}, blocks of {B}: "
              f"sentinel {k} differs")
    # the float trace vectors are per-lane reductions, whose CUDA kernels
    # lay out their sums by the output count: reported, not held
    trace_rel = max(float(((da[k] - db[k]).abs()
                           / db[k].abs().clamp_min(1e-30)).max())
                    for k in da if k != "sentinel")
    G = C // B
    want = {k: n * G * steps for k, n in per_step.items()}
    check(lnb == want, f"C = {C}, blocks of {B}: launches {lnb} in "
          f"{steps} steps, expected {want}")
    return {"configs": C, "block": B, "steps": steps,
            "launches_a_step": {k: n // steps for k, n in lnb.items()},
            "trace_rel_max": trace_rel, "unblocked_s": ta, "blocked_s": tb,
            "after": runs[1][5] if after is not None else None}


def _watchdog_solver(make_solver, policy):
    s = make_solver()
    s.enable_watchdog(policy)
    return s


def blocks_identity(gpu):
    """(a) the tiled sweep (phase 11's) at C = 64 in blocks of 16 and
    the untiled sweep (phase 7's) at C = 512 in blocks of 128, each
    against its unblocked run; (d) on the blocked untiled runner."""
    from rram_caffe_simulation_tpu_torch.parallel import SweepRunner

    def tiled(block):
        return SweepRunner(
            _watchdog_solver(lambda: slice_solver(1e8, 3e7, tiled=True),
                             "halt"),
            n_configs=TILED_SWEEP_CONFIGS, engine="cuda",
            packed_state=True, dtype_policy="ternary",
            conv_im2col="implicit", config_block=block)

    def untiled(block):
        return SweepRunner(
            _watchdog_solver(lambda: slice_solver(1e8, 3e7), "halt"),
            n_configs=SWEEP_CONFIGS, engine="cuda", packed_state=True,
            dtype_policy="ternary", config_block=block)
    out = {"tiled": blocked_pair(tiled, TILED_SWEEP_CONFIGS, 16,
                                 BLOCK_STEPS,
                                 _tiled_per_step(TILED_SWEEP_CONFIGS)),
           "untiled": blocked_pair(untiled, SWEEP_CONFIGS, 128, BLOCK_STEPS,
                                   _untiled(B2=2, B1=1, B4=1),
                                   lambda r: blocks_evaluate(r, gpu))}
    for name, res in out.items():
        print(f"phase 18: (a) {name} sweep, C = {res['configs']} in blocks "
              f"of {res['block']}, {res['steps']} steps: losses, params, "
              f"history, banks, quarantine and sentinel vectors bit for bit "
              f"the unblocked run's (the float debug vectors within "
              f"{res['trace_rel_max']:.2e} relative); launches a step "
              f"{res['launches_a_step']}; {gpu}", flush=True)
    return out


def blocks_tiled_wide(gpu, phase11):
    """(b) the tiled sweep at C = 512 in blocks of 64: one warm and
    BLOCK_TIMED timed steps."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.parallel import SweepRunner
    C = BLOCK_CONFIGS
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    r = SweepRunner(slice_solver(1e8, 3e7, tiled=True), n_configs=C,
                    engine="cuda", packed_state=True, dtype_policy="ternary",
                    conv_im2col="implicit", config_block=BLOCK)
    setup_s = time.perf_counter() - t0
    warm = r.step(1)[0]
    check(bool(np.isfinite(warm).all()), "(b) non-finite warm loss")
    events = []
    _iteration_events(r, events)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    kernels.reset_launches()
    start.record()
    t0 = time.perf_counter()
    losses = r.step(BLOCK_TIMED, chunk=BLOCK_TIMED)[0]
    wall = time.perf_counter() - t0
    launches = _launches()
    step_ms = [a.elapsed_time(b) for a, b in zip([start] + events[:-1],
                                                 events)]
    G = C // BLOCK
    want = {k: v * G * BLOCK_TIMED
            for k, v in _tiled_per_step(C).items()}
    check(losses.shape == (C,) and bool(np.isfinite(losses).all()),
          "(b) non-finite or misshapen losses")
    check(launches == want, f"(b) launches {launches}, expected {want}")
    q1, med, q3 = (float(v) for v in np.percentile(step_ms, [25, 50, 75]))
    out = {"configs": C, "block": BLOCK, "timed_steps": BLOCK_TIMED,
           "configs_steps_per_s": C * BLOCK_TIMED / wall, "wall_s": wall,
           "step_ms_median": med, "step_ms_q1": q1, "step_ms_q3": q3,
           "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
           "setup_s": setup_s, "launches": launches}
    r.close()
    del r
    torch.cuda.empty_cache()
    beside = ("phase 11 in this run: C = {configs}, {configs_steps_per_s:.1f}"
              " configs*steps/s, step median {step_ms_median:.3f} ms, peak "
              "{peak:.2f} GB".format(peak=phase11["peak_mem_bytes"] / 1e9,
                                     **phase11)
              if phase11 else "phase 11 not run")
    print(f"phase 18: (b) tiled sweep, C = {C} in blocks of {BLOCK} "
          f"({TILES}, ADC 8 bits, implicit operand, N(1e8, 3e7), ternary, "
          f"packed, fused, RRAM_POOL_BWD=cuda): "
          f"{out['configs_steps_per_s']:.1f} configs*steps/s over "
          f"{BLOCK_TIMED} steps; step median {med:.3f} ms (quartiles "
          f"{q1:.3f} / {q3:.3f}); peak memory "
          f"{out['peak_mem_bytes'] / 1e9:.2f} GB; launches {launches}; "
          f"{beside}; {gpu}", flush=True)
    return out


def blocks_vgg(gpu, phase16):
    """(c) the VGG11-BN sweep at the largest of VGG_BLOCK_CONFIGS that
    fits, in blocks of 64: one warm and VGG_BLOCK_TIMED timed steps."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.parallel import SweepRunner
    r, tried = None, []
    for C in VGG_BLOCK_CONFIGS:
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            r = SweepRunner(vgg_solver(seed=4), n_configs=C, engine="cuda",
                            packed_state=True, config_block=BLOCK)
            resident = torch.cuda.memory_allocated()
            setup_s = time.perf_counter() - t0
            r.step(1)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0 - setup_s
            break
        except torch.cuda.OutOfMemoryError:
            r = None
            tried.append(C)
            torch.cuda.empty_cache()
            print(f"phase 18: (c) VGG11 C = {C} does not fit", flush=True)
    check(r is not None, "(c) no VGG11 width of "
          f"{VGG_BLOCK_CONFIGS} fits the card in blocks of {BLOCK}")
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    r.step(VGG_BLOCK_TIMED, chunk=VGG_BLOCK_TIMED)
    wall = time.perf_counter() - t0
    launches = _launches()
    n, G = VGG_BLOCK_TIMED, C // BLOCK
    check(launches == _untiled(B2=3 * G * n, B1=G * n, B4=5 * G * n),
          f"(c) launches {launches}, expected B2 3, B1 1, B4 5 a block")
    check(bool(np.isfinite(r.last_losses).all()), "(c) non-finite lane")
    out = {"configs": C, "block": BLOCK, "did_not_fit": tried,
           "timed_steps": n, "configs_steps_per_s": C * n / wall,
           "step_ms": wall / n * 1e3, "resident_bytes": int(resident),
           "setup_s": setup_s, "warm_step_s": warm_s,
           "peak_mem_bytes": int(torch.cuda.max_memory_allocated()),
           "launches": launches}
    r.close()
    del r
    torch.cuda.empty_cache()
    beside = (f"phase 16 in this run: C = {phase16['configs']}, "
              f"{phase16['configs_steps_per_s']:.2f} configs*steps/s, peak "
              f"{phase16['peak_bytes'] / 1e9:.2f} GB" if phase16
              else "phase 16 not run")
    print(f"phase 18: (c) VGG11-BN sweep, C = {C} in blocks of {BLOCK}: "
          f"{out['configs_steps_per_s']:.2f} configs*steps/s, step "
          f"{out['step_ms']:.1f} ms (setup {setup_s:.1f} s, warm step "
          f"{warm_s:.1f} s); resident state "
          f"{resident / 1e9:.2f} GB, peak memory "
          f"{out['peak_mem_bytes'] / 1e9:.2f} GB; launches {launches}; "
          f"{beside}; {gpu}", flush=True)
    return out


def blocks_evaluate(r, gpu):
    """(d) evaluate at C = 512 untiled (the runner `r`, after its steps)
    on the test net's batch: lanes EVAL_LANES against a single-config
    forward of their params (loss within DEBUG_REL relative, accuracy
    equal)."""
    import torch
    s = r.solver
    check(r.n == BLOCK_CONFIGS, f"(d) evaluate at C = {r.n}")
    batch = s.test_feeds[0]()
    r.evaluate(batch)                      # the first call builds nothing
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = r.evaluate(batch)
    eval_s = time.perf_counter() - t0
    net, ctx = s.test_nets[0], s._test_context()
    feed = {k: torch.as_tensor(v).to(r.device) for k, v in
            batch.items()}
    check(all(v.shape[0] == BLOCK_CONFIGS for v in got.values()),
          f"(d) evaluate's outputs {[v.shape for v in got.values()]}")
    worst = 0.0
    for i in EVAL_LANES:
        with torch.no_grad():
            blobs, _ = net.apply(r.lane_state(i)[0], feed, **ctx)
        for name, v in got.items():
            want = float(blobs[name])
            rel = abs(float(v[i]) - want) / max(abs(want), 1e-30)
            worst = max(worst, rel) if name == "loss" else worst
            ok = rel <= DEBUG_REL if name == "loss" else float(v[i]) == want
            check(ok, f"(d) lane {i}'s {name} {float(v[i])} against the "
                  f"single-config forward's {want}")
    out = {"configs": BLOCK_CONFIGS, "outputs": sorted(got),
           "evaluate_s": eval_s, "lanes": list(EVAL_LANES),
           "loss_rel_max": worst,
           "accuracy_range": [float(got["accuracy"].min()),
                              float(got["accuracy"].max())]
           if "accuracy" in got else None}
    print(f"phase 18: (d) evaluate, C = {BLOCK_CONFIGS}, the test net on "
          f"{len(next(iter(batch.values())))} images: {eval_s * 1e3:.1f} "
          f"ms; lanes {list(EVAL_LANES)} equal to a single-config forward "
          f"(loss within {worst:.2e} relative, limit {DEBUG_REL}; accuracy "
          f"equal); {gpu}", flush=True)
    return out


def blocks_debug(gpu):
    """(e) phase 4's Solver with debug_info: DEBUG_STEPS steps, each
    through the kernel step and the torch engine's from the same state,
    batch and key: the printed lines in the reference's shapes, the
    debug vectors within DEBUG_REL relative (sentinels equal); the
    launches a step with debug on and off phase 4's (B2 2, B1 1)."""
    # phase 4's Solver runs autograd's max-pool backward, its default
    saved = os.environ.pop("RRAM_POOL_BWD", None)
    try:
        return _blocks_debug(gpu)
    finally:
        if saved is not None:
            os.environ["RRAM_POOL_BWD"] = saved


def _blocks_debug(gpu):
    import io
    import re
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    s = slice_solver(1e8, 3e7, fields={"debug_info": True})
    plain = s.make_train_step(hw_engine="torch", dtype_policy="ternary",
                              fault_format="packed", pack_spec=s.pack_spec,
                              fused_epilogue=True)
    shapes = [re.compile(p) for p in DEBUG_LINES]
    worst, lines = 0.0, 0
    kernels.reset_launches()
    for _ in range(DEBUG_STEPS):
        batch = s._next_batch()
        key = s._step_fn.noise.step_key(s._key, s.iter)
        state = (s.params, s.history, s.fault_state)
        launched = _launches()
        out = s._step_fn(*state, batch, s.iter, key)
        mine = _launches()
        check({k: mine[k] - launched[k] for k in mine} == _untiled(
            B2=2, B1=1, B4=0), f"(e) the debug step launched "
            f"{ {k: mine[k] - launched[k] for k in mine} }")
        ref = plain(*state, batch, s.iter, key)
        for k, v in out[5]["debug"].items():
            w = ref[5]["debug"][k]
            if k == "sentinel":
                for kk in v:
                    check(torch.equal(v[kk], w[kk]), f"(e) sentinel {kk}")
                continue
            rel = float(((v - w).abs() / w.abs().clamp_min(1e-30)).max())
            worst = max(worst, rel)
            check(rel <= DEBUG_REL, f"(e) debug vector {k}: kernel and "
                  f"plain paths {rel:.2e} apart")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            s._process_debug(out[5]["debug"])
        text = buf.getvalue().splitlines()
        check(text and all(any(p.match(t) for p in shapes) for t in text),
              f"(e) a line not in the reference's shapes: {text[:3]}")
        lines += len(text)
        s.params, s.history, s.fault_state = out[:3]
        s.iter += 1
    off = slice_solver(1e8, 3e7)
    kernels.reset_launches()
    off.step(DEBUG_STEPS)
    check(_launches() == _untiled(B2=2 * DEBUG_STEPS, B1=DEBUG_STEPS, B4=0),
          f"(e) debug off launched {_launches()}, phase 4's is B2 2, B1 1 "
          "a step")
    print(f"phase 18: (e) debug_info on phase 4's Solver, {DEBUG_STEPS} "
          f"steps: {lines} lines in the reference's shapes; debug vectors "
          f"of the kernel and plain paths within {worst:.2e} relative "
          f"(limit {DEBUG_REL}), sentinels equal; B2 2, B1 1 a step with "
          f"debug on and off; {gpu}", flush=True)
    return {"steps": DEBUG_STEPS, "lines": lines, "rel_max": worst}


def blocks_watchdog(gpu, tmp):
    """(f) the watchdog: a Solver with a poisoned rate halts naming the
    first bad layer; a C = 8 sweep with lane 5 poisoned quarantines that
    lane alone, "halt" stops it (also across step() calls), "snapshot"
    checkpoints it and the file restores."""
    import io
    import torch
    from rram_caffe_simulation_tpu_torch.parallel import SweepRunner
    s = slice_solver(300.0, 50.0, fields={"base_lr": float("nan")})
    s.param.snapshot_prefix = str(tmp / "lr")
    s.enable_watchdog("halt")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        s.step(5)
    text = buf.getvalue()
    check(s.iter == 1 and "Watchdog tripped at iteration 0: update phase, "
          "layer conv1, param 0" in text,
          f"(f) the poisoned rate: iter {s.iter}, {text[-300:]!r}")
    out = {"solver_iter": s.iter}
    for policy in ("halt", "snapshot"):
        sv = slice_solver(300.0, 50.0, seed=5)
        sv.param.snapshot_prefix = str(tmp / policy)
        sv.enable_watchdog(policy)
        r = SweepRunner(sv, n_configs=WATCH_CONFIGS, engine="cuda",
                        packed_state=True, dtype_policy="ternary",
                        pipeline_depth=0, config_block=4)
        r.params["ip2"][0][5].view(-1)[0] = float("nan")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            r.step(3)
            it = r.iter
            r.step(2)
        text = buf.getvalue()
        check(r.quarantined().tolist() == [5], f"(f) {policy}: quarantined "
              f"{r.quarantined().tolist()}")
        check("config 5 went non-finite at iteration 0 (forward phase, "
              "layer ip2, top blob ip2)" in text, f"(f) {policy}: "
              f"{text[:300]!r}")
        if policy == "halt":
            check(it == r.iter == 1 and "stopping the sweep" in text,
                  f"(f) halt: iterations {it}, {r.iter}")
        else:
            path = str(tmp / "snapshot_sweep_iter_1.ckpt.npz")
            check(r.iter == 5 and os.path.exists(path), f"(f) snapshot: "
                  f"iteration {r.iter}, {os.listdir(tmp)}")
            again = SweepRunner(slice_solver(300.0, 50.0, seed=5),
                                n_configs=WATCH_CONFIGS, engine="cuda",
                                packed_state=True, dtype_policy="ternary")
            again.restore(path)
            check(again.iter == 1 and again.quarantined().tolist() == [5],
                  "(f) the watchdog's checkpoint did not restore")
            again.close()
        out[policy] = {"iter": r.iter, "quarantined": [5]}
        r.close()
    torch.cuda.empty_cache()
    print(f"phase 18: (f) watchdog: the poisoned rate halted the Solver "
          f"after iteration 0 at conv1's update; the C = {WATCH_CONFIGS} "
          f"sweep (blocks of 4) quarantined lane 5 alone by its sentinel, "
          f"halt stopped it at iteration 1, snapshot wrote a checkpoint at "
          f"iteration 1 that restores; {gpu}", flush=True)
    return out


def phase_blocks(gpu, phase11=None, phase16=None):
    """Phase 18: config_block (a) identity, (b) the tiled sweep at
    C = 512, (c) VGG11-BN at the largest C that fits; (d) evaluate;
    (e) debug_info; (f) the watchdog."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    saved = os.environ.get("RRAM_POOL_BWD")
    os.environ["RRAM_POOL_BWD"] = "cuda"
    part = {}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            out = {}
            for name, fn in (
                    ("identity", lambda: blocks_identity(gpu)),
                    ("tiled_512", lambda: blocks_tiled_wide(gpu, phase11)),
                    ("vgg", lambda: blocks_vgg(gpu, phase16)),
                    ("debug", lambda: blocks_debug(gpu)),
                    ("watchdog", lambda: blocks_watchdog(gpu, Path(tmp)))):
                t1 = time.perf_counter()
                out[name] = fn()
                part[name] = time.perf_counter() - t1
    finally:
        if saved is None:
            os.environ.pop("RRAM_POOL_BWD", None)
        else:
            os.environ["RRAM_POOL_BWD"] = saved
    torch.cuda.empty_cache()
    out["evaluate"] = out["identity"]["untiled"].pop("after")
    out.update(part_s=part, phase_s=time.perf_counter() - t0, gpu=gpu)
    print(f"phase 18: {json.dumps(part)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 19: the self-healing sweep and the genetic search's checkpoint

HEAL_CONFIGS = 512        # (a): phase 7's sweep
HEAL_BUDGET = 12
HEAL_POISON = (7, 200, 511)   # (a)'s lanes poisoned after 4 iterations
HEAL_SMALL = 8            # (b)
HEAL_BATCH = 64           # (c), (d), (e)


class _ListSink:
    def __init__(self):
        self.records = []

    def write(self, record):
        self.records.append(record)


def healing_runner(C, mean, std, depth, seed=1, sink=None):
    """Phase 7's sweep (device dataset, ternary read, packed banks, fused
    epilogue) at pipeline depth `depth`, metrics to `sink`."""
    from rram_caffe_simulation_tpu_torch.parallel import SweepRunner
    s = slice_solver(mean, std, seed=seed)
    if sink is not None:
        s.enable_metrics(sink)
    return SweepRunner(s, n_configs=C, engine="cuda", packed_state=True,
                       dtype_policy="ternary", pipeline_depth=depth)


def poison_lanes(r, lanes):
    """NaN into ip2's first weight of each lane: the lane's loss goes
    non-finite at its next step."""
    import torch
    with torch.no_grad():
        r.params["ip2"][0][list(lanes), 0, 0] = float("nan")


def _retries(sink):
    return [x for x in sink.records if x.get("type") == "retry"]


def _same_bytes(a, b) -> bool:
    import torch
    return torch.equal(a.contiguous().view(torch.uint8),
                       b.contiguous().view(torch.uint8))


def _rows_equal(a, b, lanes) -> list:
    """Names of the state leaves whose rows `lanes` differ between
    runners a and b (quarantine aside)."""
    import torch
    idx = torch.as_tensor(lanes, device=a.quarantine.device)
    sa, sb = a._state_arrays(), b._state_arrays()
    return [n for n in sa if n != "quarantine"
            and not _same_bytes(sa[n].index_select(0, idx),
                                sb[n].index_select(0, idx))]


def heal_wide(gpu):
    """(a) phase 7's sweep at C = 512 with self-healing (depth 2, budget
    12, one retry, chunk 2), three lanes poisoned after 4 iterations,
    against a clean run of the same budget."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.observe import schema as obs_schema
    C, budget, chunk = HEAL_CONFIGS, HEAL_BUDGET, 2
    clean = healing_runner(C, 1e8, 3e7, 2, sink=_ListSink())
    clean.step(chunk, chunk=chunk)            # warms cuDNN's plans
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    clean.step(budget - chunk, chunk=chunk)
    clean_wall = time.perf_counter() - t0
    clean_losses = clean.last_losses.copy()
    check(bool(np.isfinite(clean_losses).all()), "(a) the clean run went "
          "non-finite")
    sink = _ListSink()
    r = healing_runner(C, 1e8, 3e7, 2, sink=sink)
    r.enable_self_healing(budget=budget, max_retries=1)
    heal_ms, calls = [], [0]
    heal, step = r._heal_pass, r._step

    def timed_heal(*a, **kw):
        t1 = time.perf_counter()
        try:
            return heal(*a, **kw)
        finally:
            heal_ms.append((time.perf_counter() - t1) * 1e3)

    def counted_step(*a, **kw):
        calls[0] += 1
        return step(*a, **kw)
    r._heal_pass, r._step = timed_heal, counted_step
    kernels.reset_launches()
    r.step(4, chunk=chunk)
    poison_lanes(r, HEAL_POISON)
    torch.cuda.synchronize()
    it0, t0 = r.iter, time.perf_counter()
    while not r.healing_complete():
        r.step(4, chunk=chunk)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    n = calls[0]
    check(launches == _untiled(B2=2 * n, B1=n, B4=n),
          f"(a) launches {launches} in {n} steps, expected B2 2, B1 1, B4 1 "
          "a step")
    rep = r.config_report()
    check(rep["requested"] == list(range(C)) and rep["failed"] == {}
          and sorted(rep["completed"]) == list(range(C)),
          f"(a) not every config completed: failed {rep['failed']}")
    for cfg, res in rep["completed"].items():
        want = 2 if cfg in HEAL_POISON else 1
        check(res["attempts"] == want, f"(a) config {cfg} took "
              f"{res['attempts']} attempts, expected {want}")
    events = _retries(sink)
    for cfg in HEAL_POISON:
        kinds = sorted(x["event"] for x in events if x["config"] == cfg)
        check(kinds == ["requeue", "reseed"], f"(a) config {cfg}'s retry "
              f"records are {kinds}")
    check(len(events) == 2 * len(HEAL_POISON), f"(a) {len(events)} retry "
          "records")
    for rec in sink.records:
        errs = obs_schema.validate_record(rec)
        check(errs == [], f"(a) an invalid record: {errs}")
    healthy = [i for i in range(C) if i not in HEAL_POISON]
    gaps = [i for i in healthy
            if rep["completed"][i]["loss"] != float(clean_losses[i])]
    check(not gaps, f"(a) healthy lanes {gaps[:8]} end on another loss "
          "than the clean run's")
    differ = _rows_equal(r, clean, healthy)
    check(not differ, f"(a) healthy lanes' {differ} differ from the clean "
          "run's")
    rows = r._fresh_rows(HEAL_POISON[0], 2)
    out = {"configs": C, "budget": budget, "chunk": chunk, "depth": 2,
           "poisoned": list(HEAL_POISON),
           "clean_configs_steps_per_s": C * (budget - chunk) / clean_wall,
           "healing_configs_steps_per_s": C * (r.iter - it0) / wall,
           "healing_iterations_after_poison": r.iter - it0,
           "heal_pass_ms_median": float(np.median(heal_ms)),
           "heal_pass_ms_max": float(np.max(heal_ms)),
           "heal_passes": len(heal_ms), "steps": n, "launches": launches,
           "refill_row_bytes": int(sum(v.nbytes for v in rows.values())),
           "retry_records": len(events), "gpu": gpu}
    del clean, r
    return out


def heal_failure():
    """(b) at C = 8 a config poisoned at every attempt fails for good
    with the reference's diagnosis; every requested config is in the
    report."""
    sink = _ListSink()
    r = healing_runner(HEAL_SMALL, 300.0, 50.0, 0, seed=7, sink=sink)
    r.enable_self_healing(budget=6, max_retries=1)
    target = 3
    while not r.healing_complete():
        act = r.config_report()["active"].get(target)
        if act is not None:
            poison_lanes(r, [act["lane"]])
        r.step(2, chunk=2)
    rep = r.config_report()
    bad = rep["failed"].get(target)
    check(bad is not None and bad["attempts"] == 2,
          f"(b) config {target} did not fail after 2 attempts: {rep}")
    check(bad["diagnosis"] == f"non-finite loss at iteration {bad['iter']}",
          f"(b) diagnosis {bad['diagnosis']!r}")
    check(rep["requested"] == list(range(HEAL_SMALL))
          and sorted(set(rep["completed"]) | set(rep["failed"]))
          == list(range(HEAL_SMALL)), "(b) a config is unaccounted for")
    check([x["event"] for x in _retries(sink)]
          == ["requeue", "reseed", "failed"], "(b) retry records "
          f"{[x['event'] for x in _retries(sink)]}")
    return {"configs": HEAL_SMALL, "failed": {target: bad},
            "completed": len(rep["completed"])}


def heal_batching():
    """(c) continuous batching at C = 64 with int16 banks: 16 extra
    configs seeded as lanes free up; a spec past int16 refused; a
    start_empty runner takes its work from submissions."""
    C = HEAL_BATCH
    specs = [{"mean": 280.0 + 2.5 * i, "std": 40.0} for i in range(16)]
    r = healing_runner(C, 300.0, 50.0, 2, seed=9)
    check(r._pack_spec["life_dtype"] == "int16", "(c) banks are not int16")
    r.enable_self_healing(budget=4, extra_configs=specs)
    try:
        r.submit_configs([{"mean": 1e8, "std": 3e7}])
        refused = ""
    except ValueError as e:
        refused = str(e)
    check("int16" in refused, "(c) a spec past int16 was not refused")
    while not r.healing_complete():
        r.step(4, chunk=2)
    rep = r.config_report()
    want = list(range(C + len(specs)))
    check(sorted(rep["completed"]) == want and rep["failed"] == {},
          f"(c) completed {len(rep['completed'])} of {len(want)}")
    check(min(rep["completed"][c]["iter"] for c in range(C, C + 16)) == 8,
          "(c) the extra configs did not train after the first wave")
    del r
    e = healing_runner(C, 300.0, 50.0, 0, seed=9)
    e.enable_self_healing(budget=3, start_empty=True)
    first = e.submit_configs(specs[:8], budget=2)
    e.step(1)
    later = e.submit_configs(specs[8:12])
    while not e.healing_complete():
        e.step(2, chunk=2)
    rep = e.config_report()
    check(sorted(rep["completed"]) == first + later,
          f"(c) start_empty completed {sorted(rep['completed'])}")
    check(all(rep["completed"][c]["iter"] == 2 for c in first),
          "(c) a submission's own budget did not hold")
    return {"configs": C, "extra": len(specs), "refused": refused,
            "start_empty_completed": len(rep["completed"])}


def heal_recovery(tmp):
    """(d) escalating recovery at C = 64: a checkpoint mid-sweep, then a
    poisoned lane is re-seeded from its slice of the file."""
    sink = _ListSink()
    r = healing_runner(HEAL_BATCH, 300.0, 50.0, 0, seed=10, sink=sink)
    r.enable_self_healing(budget=10, max_retries=1)
    r.step(4, chunk=2)
    path = r.checkpoint(str(tmp / "heal.ckpt.npz"))
    lane = min(17, HEAL_BATCH - 1)
    poison_lanes(r, [lane])
    r.step(2, chunk=2)          # depth 0: reclaimed, refilled at the end
    reseed = _retries(sink)[-1]
    check(reseed["event"] == "reseed"
          and reseed.get("recovery") == "checkpoint",
          f"(d) the retry's record is {reseed}")
    with np.load(path) as z:
        off = [n for n, t in r._state_arrays().items()
               if n != "quarantine"
               and t[lane].cpu().numpy().tobytes() != z[n][lane].tobytes()]
    check(not off, f"(d) the refilled lane's {off} differ from the "
          "checkpoint's slice")
    while not r.healing_complete():
        r.step(4, chunk=2)
    rep = r.config_report()
    check(rep["completed"][lane]["attempts"] == 2
          and len(rep["completed"]) == HEAL_BATCH, "(d) the sweep did not "
          "complete")
    return {"configs": HEAL_BATCH, "lane": lane, "reseed": reseed,
            "file_bytes": os.path.getsize(path)}


def heal_genetic(tmp):
    """(e) phase 15 (d)'s genetic sweep at C = 64: a checkpoint holds
    `__genetics__`, a new runner restores it, and both go on equal bit
    for bit, the search included."""
    files = strategy_files(tmp)
    genetic = {"type": "genetic", "start": 3, "period": 5,
               "switch_time": 50, "prune_net_file": files[1],
               "prune_model_file": files[2]}
    a = sweep_runner(HEAL_BATCH, 300.0, 50.0, seed=8, strategies=[genetic])
    a.step(3, chunk=3)                     # an application before 2
    t0 = time.perf_counter()
    path = a.checkpoint(str(tmp / "genetic.ckpt.npz"))
    ckpt_s = time.perf_counter() - t0
    with np.load(path) as z:
        check("__genetics__" in z.files, "(e) no __genetics__ in the file")
        gbytes = int(z["__genetics__"].nbytes)
    b = sweep_runner(HEAL_BATCH, 300.0, 50.0, seed=8, strategies=[genetic])
    t0 = time.perf_counter()
    b.restore(path)
    restore_s = time.perf_counter() - t0
    masks = [[m.copy() for m in g.prune_weights] for g in a._genetics]
    pos0 = [g._rng.get_state()[2] for g in a._genetics]
    la = a.step(6, chunk=3)[0]             # an application before 7
    lb = b.step(6, chunk=3)[0]
    check(la.tobytes() == lb.tobytes(), "(e) the restored run's losses "
          "differ")
    differ = _rows_equal(a, b, list(range(HEAL_BATCH)))
    check(not differ, f"(e) the restored run's {differ} differ")
    for i, (ga, gb) in enumerate(zip(a._genetics, b._genetics)):
        check(all(np.array_equal(x, y) for x, y in
                  zip(ga.prune_weights, gb.prune_weights))
              and ga._rng.randint(1 << 30) == gb._rng.randint(1 << 30),
              f"(e) lane {i}'s search differs after the restore")
    moved = sum(any(not np.array_equal(x, y) for x, y in
                    zip(m0, g.prune_weights))
                for m0, g in zip(masks, a._genetics))
    check(any(g._rng.get_state()[2] != p for g, p in
              zip(b._genetics, pos0)), "(e) no search ran after the restore")
    return {"configs": HEAL_BATCH, "genetics_bytes": gbytes,
            "checkpoint_s": ckpt_s, "restore_s": restore_s,
            "lanes_swapped_after": moved}


def phase_healing(gpu):
    """Phase 19: (a) the C = 512 sweep with self-healing against a clean
    run; (b) permanent failure; (c) continuous batching; (d) escalating
    recovery; (e) the genetic search across a checkpoint."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    saved = os.environ.get("RRAM_POOL_BWD")
    os.environ["RRAM_POOL_BWD"] = "cuda"
    out, part = {}, {}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            for name, fn in (
                    ("a_wide", lambda: heal_wide(gpu)),
                    ("b_failure", heal_failure),
                    ("c_batching", heal_batching),
                    ("d_recovery", lambda: heal_recovery(Path(tmp))),
                    ("e_genetic", lambda: heal_genetic(Path(tmp)))):
                t1 = time.perf_counter()
                out[name] = fn()
                part[name] = time.perf_counter() - t1
                print(f"phase 19: ({name[0]}) {json.dumps(out[name])}",
                      flush=True)
                torch.cuda.empty_cache()
    finally:
        if saved is None:
            os.environ.pop("RRAM_POOL_BWD", None)
        else:
            os.environ["RRAM_POOL_BWD"] = saved
    out.update(part_s=part, phase_s=time.perf_counter() - t0, gpu=gpu)
    print(f"phase 19: {json.dumps(part)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 20: the tiled read's k order, and the self-healing sweep's
# per-lane clocks (virtual time)

# (a)'s reads: VGG11's fc1 (B2t) and conv2 (B3a: B3's partials are B2t's
# over the patch rows, phase 9), and the narrow VGG-BN net's fc1 (the
# CPU tests' net: its one tiled read, batch 8)
ORDER_CASES = {"VGG11 fc1": VGG_TILED_CASES["fc1"],
               "VGG11 conv2": VGG_TILED_CASES["conv2"],
               "narrow fc1": ((8, 512), None, 512, 16, (128, 16, 8))}
VT_CONFIGS = 512                  # (b): phase 7's sweep
VT_BUDGETS = (12, 8)              # (b): the two waves' budgets
VT_WAVE_AT = 4                    # (b): the second wave's iteration
VT_CONTRACT = 64                  # (c), (d)
VT_TARGETS = 4                    # (c): the configs run twice
VT_OTHERS = 32                    # (c): seeded ahead of them the second time


def _tiled_sum(parts, bn, adc):
    """A tiled read from its (..., gk, M, N) raw partials: each tile's
    ADC (`adc_read`), then the ascending sum over the K-tiles."""
    import torch
    from rram_caffe_simulation_tpu_torch.fault import hw_aware as hw
    cols = []
    for n0 in range(0, parts.shape[-1], bn):
        acc = None
        for kt in range(parts.shape[-3]):
            q = hw.adc_read(parts[..., kt, :, n0:n0 + bn], adc)
            acc = q if acc is None else acc + q
        cols.append(acc)
    return torch.cat(cols, -1)


def order_repair(device):
    """(a) The cause of the old parting, and its repair, at ORDER_CASES
    (random inputs, sigma 0, no grid): the kernel's raw per-tile partials
    (B2t over one K-tile with the ADC off) against torch.matmul's (the
    plain read before the repair) and against the plain read's partials
    now (`ordered_tile_partials`); then the whole read at the 8-bit ADC:
    the share of outputs apart from the kernel's, the matmul form's and
    the plain read's. With sigma 0.05, the cells of the kernel's in-kernel
    W_eff (B2 over identity rows) that differ from the plain version's
    (the Philox twin)."""
    import torch
    from rram_caffe_simulation_tpu_torch.fault import hw_aware as hw
    from rram_caffe_simulation_tpu_torch.fault.mapping import conv_patch_rows
    out = {}
    for i, (name, (xs, geom, K, N, tiles)) in enumerate(ORDER_CASES.items()):
        x, w, br, st, _, seeds = tiled_operands(xs, 1, False, K, N, False,
                                                2000 + i, device)
        br = br > 0
        rows = x if geom is None else conv_patch_rows(x, geom)
        bk, bn, adc = tiles
        with torch.no_grad():
            w_eff = hw._lane_w_eff(w, br, st, seeds, 0.0, 0, None)
            kparts = torch.stack([hw._launch_b2t(
                rows[:, k0:k0 + bk], w[:, k0:k0 + bk], br[:, k0:k0 + bk],
                st[:, k0:k0 + bk], seeds, 0.0, 0, None, (bk, bn, 0))[0]
                for k0 in range(0, K, bk)])
            mparts = hw.matmul_tile_partials(rows, w_eff[0], bk)
            oparts = hw.ordered_tile_partials(rows, w_eff[0], bk)
            yk = tiled_forward(True, x, w, br, st, seeds, 0.0, 0, None, geom,
                               tiles)[0]
            y_before = _tiled_sum(mparts, bn, adc)
            y_now = tiled_forward(False, x, w, br, st, seeds, 0.0, 0, None,
                                  geom, tiles)[0]
            eye = torch.eye(K, device=device)
            w_kernel = hw.crossbar_forward(eye, w, br, st, seeds, VGG_SIGMA,
                                           0)
            w_twin = hw._lane_w_eff(w, br, st, seeds, VGG_SIGMA, 0, None)
        res = {
            "M, K, N": [rows.shape[0], K, N], "tiles": list(tiles),
            "partials": kparts.numel(),
            "partials_apart_matmul": int((kparts != mparts).sum()),
            "partials_apart_ordered": int((kparts != oparts).sum()),
            "outputs_apart_before": float((yk != y_before).float().mean()),
            "outputs_apart_now": float((yk != y_now).float().mean()),
            "weff_cells_apart_sigma_0.05": int((w_kernel != w_twin).sum())}
        check(res["partials_apart_ordered"] == 0
              and res["outputs_apart_now"] == 0,
              f"(a) {name}: the plain read still parts from the kernel: "
              f"{res}")
        out[name] = res
        del x, w, br, st, rows, kparts, mparts, oparts, w_kernel, w_twin
        torch.cuda.empty_cache()
    return out


def vt_runner(C, mean, std, depth, seed=1, virtual=True,
              budget=HEAL_BUDGET, sigma=0.0):
    """Phase 7's sweep (`healing_runner`; with `sigma`, read noise drawn
    from each lane's step key) with self-healing armed and every lane
    idle (start_empty), under virtual time or in shared time."""
    from rram_caffe_simulation_tpu_torch.parallel import SweepRunner
    r = SweepRunner(slice_solver(mean, std, sigma=sigma, seed=seed),
                    n_configs=C, engine="cuda", packed_state=True,
                    dtype_policy="ternary", pipeline_depth=depth)
    r.enable_self_healing(budget=budget, max_retries=1, start_empty=True,
                          virtual_time=virtual)
    return r


def _timed_healing(r, chunk, waves):
    """Run a healing sweep to completion, `waves` ({iteration: (specs,
    budget)}) submitted once the sweep reaches them. The first chunk
    warms cuDNN's plans for the runner's shapes and is not timed. Returns
    (config steps timed, wall s, per-iteration device ms from CUDA
    events, iterations, launches, s of the refills' host work: the
    fresh rows drawn and written) of the rest."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    pending = dict(waves)

    def advance():
        for at in [a for a in pending if a <= r.iter]:
            r.submit_configs(*pending.pop(at))
        r.step(chunk, chunk=chunk)
    advance()
    h = r._healing
    first = int(h.lane_done[h.lane_cfg >= 0].sum())
    events, refill_s = [], [0.0]
    _iteration_events(r, events)

    def timed(fn):
        def call(*a, **kw):
            t1 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                refill_s[0] += time.perf_counter() - t1
        return call
    r._recovery_rows = timed(r._recovery_rows)
    r._write_lanes = timed(r._write_lanes)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while not r.healing_complete() or pending:
        advance()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    total = sum(r._cfg_budget_of(c) for c in r.config_report()["completed"])
    ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    return total - first, wall, ms, len(events), _launches(), refill_s[0]


def vt_wide(gpu):
    """(b) the C = 512 sweep at depth 2, every lane idle at the start: 256
    configs at budget 12, 256 more after 4 iterations at budget 8, run
    to completion under virtual time and in shared time; each timed
    after its first chunk, with the seconds of the second wave's refills
    (256 fresh fault draws and row writes on the host)."""
    import torch
    C, chunk = VT_CONFIGS, 2
    spec = {"mean": 1e8, "std": 3e7}
    half = C // 2
    out = {"configs": C, "budgets": list(VT_BUDGETS),
           "second_wave_at": VT_WAVE_AT, "chunk": chunk, "depth": 2,
           "gpu": gpu}

    def quart(v):
        return [float(np.percentile(v, q)) for q in (25, 50, 75)]
    for virtual in (True, False):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        r = vt_runner(C, 1e8, 3e7, 2, virtual=virtual)
        ids = r.submit_configs([spec] * half, budget=VT_BUDGETS[0])
        steps, wall, ms, n, launches, refill_s = _timed_healing(
            r, chunk, {VT_WAVE_AT: ([spec] * half, VT_BUDGETS[1])})
        peak = torch.cuda.max_memory_allocated()
        what = "virtual" if virtual else "shared"
        check(launches == _untiled(B2=2 * n, B1=n, B4=n),
              f"(b) {what}: launches {launches} in {n} steps, expected "
              "B2 2, B1 1, B4 1 a step")
        rep = r.config_report()
        check(sorted(rep["completed"]) == list(range(C, 2 * C))
              and rep["failed"] == {}, f"(b) {what}: not every config "
              "completed")
        check(all(rep["completed"][c]["iter"] == VT_BUDGETS[0] for c in ids)
              and all(rep["completed"][c]["iter"]
                      == VT_WAVE_AT + VT_BUDGETS[1]
                      for c in range(C + half, 2 * C)),
              f"(b) {what}: a wave did not end at its budget")
        check(all(math.isfinite(v["loss"])
                  for v in rep["completed"].values()),
              f"(b) {what}: a non-finite loss")
        out[what] = {"configs_steps_per_s": steps / wall,
                     "configs_steps_per_s_outside_refills":
                         steps / (wall - refill_s),
                     "config_steps_timed": steps, "wall_s": wall,
                     "refill_s": refill_s, "steps": n,
                     "step_ms_q1_median_q3": quart(ms),
                     "peak_gb": peak / 1e9, "launches": launches}
        if virtual:
            out[what]["gather_bytes_per_step"] = C * r._ds_batch * sum(
                a[0].numel() * a.element_size()
                for a in r._dataset.values())
        del r
    torch.cuda.empty_cache()
    return out


def _contract_run(defer):
    """(c)'s sweep at C = 64 (lifetimes N(400, 100), int16 banks, read
    noise at sigma 0.05 from each lane's step key): the targets (configs
    64-67) and 32 others submitted at once; with `defer` a refill policy
    seeds the others first and holds the targets back until iteration 2.
    Returns the report and each target's rows (params, history, banks)
    at its completion."""
    C = VT_CONTRACT
    r = vt_runner(C, 400.0, 100.0, 0, seed=3, budget=6, sigma=0.05)
    rows = {}

    def keep(cfg, lane, result):
        rows[cfg] = {k: v[lane].clone() for k, v in
                     r._state_arrays().items() if k != "quarantine"}
    r.on_lane_complete = keep
    specs = [{"mean": 380.0 + 5 * i, "std": 90.0}
             for i in range(VT_TARGETS + VT_OTHERS)]
    ids = r.submit_configs(specs)
    targets = ids[:VT_TARGETS]
    if defer:
        def policy(entries, lane_map):
            later = [e for e in entries if e["config"] in targets]
            return [e for e in entries if e["config"] not in targets] + (
                later if r.iter >= 2 else [])
        r.set_refill_policy(policy)
    while not r.healing_complete():
        r.step(2, chunk=2)
    return r.config_report(), rows, targets


def vt_contract():
    """(c) the reproducibility contract on the card: configs 64-67 give
    the same losses, broken shares, params, history and banks bit for bit
    whether they land first in lanes 0-3 or later in others."""
    first, rows_a, targets = _contract_run(False)
    later, rows_b, _ = _contract_run(True)
    lanes_a = [first["completed"][c]["lane"] for c in targets]
    lanes_b = [later["completed"][c]["lane"] for c in targets]
    check(lanes_a == list(range(VT_TARGETS)) and not set(lanes_a)
          & set(lanes_b), f"(c) lanes {lanes_a} and {lanes_b}")
    for c in targets:
        a, b = first["completed"][c], later["completed"][c]
        for field in ("loss", "broken", "attempts", "status"):
            check(a[field] == b[field], f"(c) config {c}'s {field}: "
                  f"{a[field]} and {b[field]}")
        differ = [k for k in rows_a[c] if not _same_bytes(rows_a[c][k],
                                                         rows_b[c][k])]
        check(not differ, f"(c) config {c}'s {differ} differ by lane")
    return {"configs": VT_CONTRACT, "targets": targets,
            "lanes_first": lanes_a, "lanes_later": lanes_b,
            "iters": [first["completed"][targets[0]]["iter"],
                      later["completed"][targets[0]]["iter"]],
            "losses": [first["completed"][c]["loss"] for c in targets]}


def vt_checkpoint(tmp):
    """(d) a virtual-time checkpoint written mid-sweep (second wave
    queued) and restored into a new runner continues equal to the run
    that never stopped; a shared-time runner refuses it."""
    C = VT_CONTRACT
    specs = [{"mean": 380.0 + 5 * i, "std": 90.0} for i in range(40)]

    def fresh():
        return vt_runner(C, 400.0, 100.0, 0, seed=5, budget=6)
    full = fresh()
    full.submit_configs(specs[:24])
    full.step(2, chunk=2)
    full.step(2, chunk=2)
    full.submit_configs(specs[24:], budget=4)
    path = full.checkpoint(str(Path(tmp) / "vt.ckpt.npz"))
    while not full.healing_complete():
        full.step(2, chunk=2)
    back = fresh()
    back.restore(path)
    while not back.healing_complete():
        back.step(2, chunk=2)
    check(back.config_report() == full.config_report(),
          "(d) the restored run's report differs")
    sa, sb = full._state_arrays(), back._state_arrays()
    differ = [n for n in sa if not _same_bytes(sa[n], sb[n])]
    check(not differ, f"(d) the restored run's {differ} differ")
    shared = vt_runner(C, 400.0, 100.0, 0, seed=5, virtual=False)
    try:
        shared.restore(path)
        refused = ""
    except ValueError as e:
        refused = str(e)
    check("virtual_time=True" in refused, f"(d) a shared-time runner "
          f"restored a virtual-time file: {refused!r}")
    return {"configs": C, "iter": full.iter,
            "completed": len(full.config_report()["completed"]),
            "refusal": refused}


def phase_virtual_time(gpu, tiled_checks=None):
    """Phase 20: (a) the tiled read's k order (`order_repair`), with the
    exact-case counts of phases 9 and 16 (g) when they ran; (b) virtual
    time at C = 512 beside shared time; (c) the contract at C = 64; (d) a
    virtual-time checkpoint."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    saved = os.environ.get("RRAM_POOL_BWD")
    os.environ["RRAM_POOL_BWD"] = "cuda"
    out, part = {}, {}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            for name, fn in (
                    ("a_order", lambda: {**order_repair(
                        torch.device("cuda")),
                        "tightened": tiled_checks or {}}),
                    ("b_wide", lambda: vt_wide(gpu)),
                    ("c_contract", vt_contract),
                    ("d_checkpoint", lambda: vt_checkpoint(tmp))):
                t1 = time.perf_counter()
                out[name] = fn()
                part[name] = time.perf_counter() - t1
                print(f"phase 20: ({name[0]}) {json.dumps(out[name])}",
                      flush=True)
                torch.cuda.empty_cache()
    finally:
        if saved is None:
            os.environ.pop("RRAM_POOL_BWD", None)
        else:
            os.environ["RRAM_POOL_BWD"] = saved
    out.update(part_s=part, phase_s=time.perf_counter() - t0, gpu=gpu)
    print(f"phase 20: {json.dumps(part)}", flush=True)
    return out


DRIVER_CONFIGS = 1024           # phase 21: two resident groups
DRIVER_GROUP = 512              # phase 7's sweep width
DRIVER_ITERS = 10               # 20 before phase 22, 15 before phase 23
DRIVER_CHUNK = 5
DRIVER_CKPT_EVERY = 5           # (c): group 1 is preempted at iteration 5
DRIVER_DEVICE = "cuda"
# the resume guard's (scripts/check_resume_equivalence.py) timing fields
DRIVER_TIMING = ("wall_time", "step_latency_s", "iters_per_s",
                 "wall_seconds", "setup_overlap_seconds",
                 "host_blocked_seconds", "checkpoint_write_seconds")


def driver_flags():
    """The flags phase 21 runs the driver with and resumes it with (the
    manifest pins the others)."""
    return ["--packed-state", "--dtype-policy", "ternary", "--engine",
            "cuda", "--device", DRIVER_DEVICE]


def driver_argv(run_dir, *extra):
    return ["--solver", SOLVER, "--configs", str(DRIVER_CONFIGS),
            "--group", str(DRIVER_GROUP), "--iters", str(DRIVER_ITERS),
            "--chunk", str(DRIVER_CHUNK), "--mean", "1e8", "--std", "3e7",
            "--pipeline-depth", "2", "--block", "0", "--run-dir",
            str(run_dir), *driver_flags(), *extra]


def run_driver(argv, preempted=False):
    """The port's run_1000_sweep.main(argv) in this process, this
    script's SIGTERM and SIGINT handlers restored after it. With
    `preempted` the run must end in SystemExit(75) (caught, and nothing
    else); otherwise it must return its record."""
    import signal
    from rram_caffe_simulation_tpu_torch.examples.gaussian_failure import \
        run_1000_sweep as driver
    handlers = {s: signal.getsignal(s) for s in (signal.SIGTERM,
                                                 signal.SIGINT)}
    try:
        if not preempted:
            return driver.main(argv)
        try:
            driver.main(argv)
        except SystemExit as e:
            if e.code != driver.PREEMPTED_EXIT:
                raise
            return None
        check(False, "(c) the preempted run did not exit 75")
    finally:
        for s, h in handlers.items():
            signal.signal(s, h)


def driver_files(run_dir):
    """Every durable file of a run directory, timing fields aside: the
    journal's group and done records, each metrics stream, the report,
    and a sha256 of every fault npz array's bytes."""
    import hashlib

    def jsonl(path):
        with open(path) as f:
            recs = [json.loads(ln) for ln in f if ln.strip()]
        return [{k: v for k, v in r.items() if k not in DRIVER_TIMING}
                for r in recs]
    out = {"journal": json.dumps([r for r in jsonl(
        os.path.join(run_dir, "journal.jsonl"))
        if r["event"] in ("group", "done")])}
    for name in sorted(os.listdir(run_dir)):
        path = os.path.join(run_dir, name)
        if name.startswith("metrics_g"):
            out[name] = json.dumps(jsonl(path))
        elif name == "sweep_report.json":
            with open(path) as f:
                out[name] = json.load(f)
        elif name.endswith("_faults.npz"):
            with np.load(path) as z:
                out[name] = {k: hashlib.sha256(z[k].tobytes()).hexdigest()
                             for k in z.files}
    return out


def driver_journal(run_dir):
    with open(os.path.join(run_dir, "journal.jsonl")) as f:
        return [json.loads(ln) for ln in f if ln.strip()]


@contextlib.contextmanager
def driver_probes(probe):
    """Instrument the driver's runners and prefetcher for one run: each
    runner's construction seconds, a CUDA event after each of its
    iterations (with whether a group build was in flight when it was
    enqueued), each prefetched build's build and wait seconds, and each
    runner's setup record; runners in construction order."""
    import threading
    import torch
    from rram_caffe_simulation_tpu_torch.parallel import sweep as psweep
    cls, pf = psweep.SweepRunner, psweep.GroupPrefetcher
    real = (cls.__init__, cls._iteration, cls.setup_record, pf.take)

    def init(self, *a, **kw):
        t0 = time.perf_counter()
        real[0](self, *a, **kw)
        with lock:
            self._probe_index = len(probe["init_s"])
            probe["init_s"].append(time.perf_counter() - t0)
            probe["events"].append([])

    def iteration(self, *a, **kw):
        out = real[1](self, *a, **kw)
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        building = any(t.name == "group-prefetch" and t.is_alive()
                       for t in threading.enumerate())
        probe["events"][self._probe_index].append((ev, building))
        return out

    def setup_record(self, *a, **kw):
        rec = real[2](self, *a, **kw)
        probe["setup"][self._probe_index] = rec
        return rec

    def take(self):
        r = real[3](self)
        probe["builds"][r._probe_index] = (self.last_build_s,
                                           self.last_wait_s)
        return r

    lock = threading.Lock()
    probe.update(init_s=[], events=[], setup={}, builds={})
    cls.__init__, cls._iteration, cls.setup_record = init, iteration, \
        setup_record
    pf.take = take
    try:
        yield probe
    finally:
        cls.__init__, cls._iteration, cls.setup_record, pf.take = real


def driver_steps(probe):
    """Per runner, in construction order: the device ms between
    consecutive iterations (CUDA events) and whether a build was in
    flight when the later one was enqueued."""
    import torch
    torch.cuda.synchronize()
    return [[(a.elapsed_time(b), bb) for (a, _), (b, bb) in
             zip(evs, evs[1:])] for evs in probe["events"]]


def driver_run(tmp, name, *extra):
    """One overlapped or serial run (a) or (b), timed and probed."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    run_dir = Path(tmp) / name
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    with driver_probes({}) as probe:
        t0 = time.perf_counter()
        rec = run_driver(driver_argv(run_dir, *extra))
        wall = time.perf_counter() - t0
        steps = driver_steps(probe)
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    check(rec["status"] == "clean" and rec["completed_configs"]
          == DRIVER_CONFIGS, f"({name}) not every config completed: {rec}")
    n = (DRIVER_CONFIGS // DRIVER_GROUP) * DRIVER_ITERS
    check(launches == _untiled(B2=2 * n, B1=n, B4=n),
          f"({name}) launches {launches} in {n} steps, expected B2 2, B1 "
          "1, B4 1 a step")
    journal = driver_journal(run_dir)
    groups = [r for r in journal if r["event"] == "group"]
    check(all(math.isfinite(v) for g in groups for v in g["loss"]),
          f"({name}) a non-finite loss")
    out = {"wall_s": wall, "peak_gb": peak / 1e9, "launches": launches,
           "steps": n, "groups": []}
    for gi, g in enumerate(groups):
        ms = [m for m, _ in steps[gi]]
        during = [m for m, b in steps[gi] if b]
        setup = probe["setup"][gi]
        build_s, wait_s = probe["builds"].get(gi, (None, None))
        out["groups"].append({
            "runner_init_s": probe["init_s"][gi],
            "last_build_s": build_s, "last_wait_s": wait_s,
            "wall_seconds": g["wall_seconds"],
            "configs_steps_per_s": DRIVER_GROUP * DRIVER_ITERS
            / g["wall_seconds"],
            "setup_overlap_seconds": g["setup_overlap_seconds"],
            "host_blocked_seconds": g["host_blocked_seconds"],
            "decode_seconds": setup["decode_seconds"],
            "compile_seconds": setup["compile_seconds"],
            "compile": setup["cache"]["compile"],
            "step_ms_median": float(np.median(ms)) if ms else None,
            "step_ms": ms,
            "steps_enqueued_while_building": len(during),
            "step_ms_while_building_median":
                float(np.median(during)) if during else None,
            "broken_mean": g["broken_mean"]})
    return run_dir, out


def phase_driver(gpu):
    """Phase 21: the port's run_1000_sweep.py driver on the card, two
    groups of 512 (CIFAR-10-quick at full width, N(1e8, 3e7), ternary,
    packed banks, engine "cuda", depth 2, RRAM_POOL_BWD=cuda): (a) the
    next group built while the current one runs, (b) the same with
    --no-overlap, (c) the same with group 1 preempted by SIGTERM after
    its first slice, then --resume. (a) = (b) = resumed (c) in every
    durable file, timing fields aside."""
    import shutil
    import signal
    import tempfile
    import torch
    t0 = time.perf_counter()
    saved = os.environ.get("RRAM_POOL_BWD")
    os.environ["RRAM_POOL_BWD"] = "cuda"
    out = {"configs": DRIVER_CONFIGS, "group": DRIVER_GROUP,
           "iters": DRIVER_ITERS, "chunk": DRIVER_CHUNK, "gpu": gpu}
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
            dir_a, out["a_overlap"] = driver_run(tmp, "a")
            files_a = driver_files(dir_a)
            shutil.rmtree(dir_a)
            print(f"phase 21: (a) {json.dumps(out['a_overlap'])}",
                  flush=True)
            dir_b, out["b_serial"] = driver_run(tmp, "b", "--no-overlap")
            differ = sorted(k for k, v in driver_files(dir_b).items()
                            if files_a.get(k) != v)
            check(not differ, f"(b) --no-overlap differs from (a) in "
                  f"{differ}")
            shutil.rmtree(dir_b)
            # what the overlap saved, measured, beside what the driver's
            # records credit it with (the build's seconds take() did not
            # wait for)
            out["overlap_saved_s"] = (out["b_serial"]["wall_s"]
                                      - out["a_overlap"]["wall_s"])
            out["overlap_credited_s"] = sum(
                g["setup_overlap_seconds"]
                for g in out["a_overlap"]["groups"])
            print(f"phase 21: (b) {json.dumps(out['b_serial'])}; "
                  f"saved {out['overlap_saved_s']:.3f} s, credited "
                  f"{out['overlap_credited_s']:.2f} s", flush=True)

            from rram_caffe_simulation_tpu_torch.parallel import sweep
            real, seen, sent = sweep.SweepRunner.step, set(), []

            def step(self, *a, **kw):
                seen.add(self.solver.param.random_seed)
                res = real(self, *a, **kw)
                if len(seen) == 2 and not sent:
                    sent.append(self.iter)
                    os.kill(os.getpid(), signal.SIGTERM)
                return res
            dir_c = Path(tmp) / "c"
            t1 = time.perf_counter()
            sweep.SweepRunner.step = step
            try:
                run_driver(driver_argv(dir_c, "--checkpoint-every",
                                       str(DRIVER_CKPT_EVERY)),
                           preempted=True)
            finally:
                sweep.SweepRunner.step = real
            pre = driver_journal(dir_c)[-1]
            check(pre["event"] == "preempt" and pre["group"] == 1
                  and pre["checkpoint"] == "group_1.ckpt.npz"
                  and (dir_c / pre["checkpoint"]).exists(),
                  f"(c) no journaled checkpoint of group 1: {pre}")
            ck_bytes = (dir_c / pre["checkpoint"]).stat().st_size
            t2 = time.perf_counter()
            rec = run_driver(["--resume", str(dir_c), *driver_flags()])
            t3 = time.perf_counter()
            check(rec["groups_resumed"] == 1 and rec["status"] == "clean",
                  f"(c) the resumed run: {rec}")
            differ = sorted(k for k, v in driver_files(dir_c).items()
                            if files_a.get(k) != v)
            check(not differ, f"(c) the resumed run differs from (a) in "
                  f"{differ}")
            out["c_preempt"] = {"signal_at_iter": sent[0],
                                "checkpoint_iter": pre["iter"],
                                "checkpoint_bytes": ck_bytes,
                                "preempted_run_s": t2 - t1,
                                "resume_s": t3 - t2}
            print(f"phase 21: (c) {json.dumps(out['c_preempt'])}",
                  flush=True)
    finally:
        if saved is None:
            os.environ.pop("RRAM_POOL_BWD", None)
        else:
            os.environ["RRAM_POOL_BWD"] = saved
        torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    return out



# ---------------------------------------------------------------------------
# phase 22: fault processes and co-design

PROCESS_STACKS = ("read_disturb", "read_disturb:reads_per_step=400",
                  "permanent_fault_map:fraction=0.05",
                  "endurance_stuck_at+conductance_drift:nu=0.2,sigma=0.1")
PROCESS_DRIFT = PROCESS_STACKS[-1]
PROCESS_STEPS = 4              # (a)'s lockstep steps of each stack
PROCESS_SWEEP_STACKS = (PROCESS_STACKS[0], PROCESS_STACKS[2], PROCESS_DRIFT)
PROCESS_SWEEP_TIMED = 3        # (c)'s timed steps of each stack (5
                               # before phase 23)
PROCESS_DRIVER_CONFIGS = 64    # (d): run_1000_sweep's one group
PROCESS_DRIVER_ITERS = 10
CODESIGN_ITERS = 10            # (d): run_codesign's iterations a bucket


@contextlib.contextmanager
def tail_args():
    """A list that takes the arguments of each fused tail
    (`solver.fused_tail`: the group function with its mode bound, the
    keys, pre-update data, updates, state) run while the context is
    open."""
    from rram_caffe_simulation_tpu_torch.solver import solver as solver_mod
    seen, tail = [], solver_mod.fused_tail

    def spy(*args):
        seen.append(args)
        return tail(*args)
    solver_mod.fused_tail = spy
    try:
        yield seen
    finally:
        solver_mod.fused_tail = tail


def b1_mode_numbers(args, iters):
    """Kernel B1 on a step's own fused tail (`args` of `fused_tail`, its
    group function bound to the stack's mode): its device time a call,
    the plain version's (the same mode) and the bound; the kernel must
    equal the plain version bit for bit."""
    import functools
    import torch
    from rram_caffe_simulation_tpu_torch.fault import fused
    from rram_caffe_simulation_tpu_torch.solver import solver as solver_mod
    fn, keys, data, upd, state = args
    mode = fn.keywords["mode"]
    plain_fn = functools.partial(fused.fused_update_fail_leaves_plain,
                                 mode=mode)
    kd, ks = solver_mod.fused_tail(fn, keys, data, upd, state)
    pd, ps = solver_mod.fused_tail(plain_fn, keys, data, upd, state)
    for k in keys:
        check(torch.equal(kd[k].view(torch.int32), pd[k].view(torch.int32))
              and torch.equal(ks["life_q"][k], ps["life_q"][k]),
              f"B1 in mode {mode!r} differs from its plain version on {k}")
    err = max(float((kd[k] - pd[k]).abs().max()) for k in keys)
    del kd, ks, pd, ps
    kernel = lambda: solver_mod.fused_tail(fn, keys, data, upd, state)
    by_name = device_ms_by_name(kernel, iters)
    ms = sum(v for nm, (v, _) in by_name.items()
             if any(own in nm for own in B1_KERNELS))
    check(ms > 0, f"the profiler did not see B1 among {sorted(by_name)}")
    p, _ = timed(lambda: solver_mod.fused_tail(plain_fn, keys, data, upd,
                                               state), max(2, iters // 5))
    groups = ([data[k] for k in keys], [upd[k] for k in keys],
              [state["life_q"][k] for k in keys],
              [state["stuck_bits"][k] for k in keys])
    nbytes = sum(t.numel() * t.element_size() for g in groups for t in g) \
        + sum(t.numel() * t.element_size() for g in (groups[0], groups[2])
              for t in g)
    return {"mode": mode, "ms": ms, "plain_ms": p,
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None, "max_abs_err": err}


def process_lockstep(spec, steps):
    """(a): one stack's Solver, kernel path against plain path in
    lockstep (phase 5's checks): every bank of the state (counters, stuck
    codes, ages, rates) equal at every step, losses within 1e-5
    relative; B2 twice and B1 once a step in the stack's mode (none
    under a stack that cannot fuse)."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.core import prng
    from rram_caffe_simulation_tpu_torch.fault import fused
    s = slice_solver(1e8, 3e7, seed=5, fault_process=spec)
    check(s.pack_spec["life_dtype"] == "int32", "1e8 banks must be int32")
    opts = dict(dtype_policy="ternary", fault_format="packed",
                pack_spec=s.pack_spec)
    kstep = s.make_train_step(hw_engine="cuda", **opts)
    pstep = s.make_train_step(hw_engine="torch", **opts)
    mode = kstep.fused_mode
    check(kstep.fused_epilogue_resolved == (mode is not None)
          == s.fault_process.supports_fused_epilogue,
          f"{spec}: the fused epilogue did not resolve as the stack says")
    state = (s.params, s.history, s.fault_state)
    worst, b1, tagged, last_tail = 0.0, 0, {}, None
    for i in range(steps):
        batch = {k: torch.as_tensor(v).to(s.device)
                 for k, v in s.train_feed().items()}
        rng = prng.fold_in(s._key, i)
        kernels.reset_launches()
        _, _, pf, pl, _ = pstep(*state, batch, i, rng)
        check(_launches() == _untiled(B2=0, B1=0, B4=0),
              f"{spec}: the torch engine launched a kernel")
        with tail_args() as seen:
            kp, kh, kf, kl, _ = kstep(*state, batch, i, rng)
        la = _launches()
        check(la["B2"] == 2 and la["B1"] == (1 if mode else 0),
              f"{spec}: step {i} launched {la}")
        check(fused.FUSED_LIB.tagged == ({mode: 1} if mode else {}),
              f"{spec}: B1's modes {fused.FUSED_LIB.tagged}, expected "
              f"{mode!r} once")
        b1 += la["B1"]
        for m, n in fused.FUSED_LIB.tagged.items():
            tagged[m] = tagged.get(m, 0) + n
        if seen:
            last_tail = seen[-1]
        kl, pl = float(kl), float(pl)
        rel = abs(kl - pl) / max(1.0, abs(pl))
        worst = max(worst, rel)
        check(math.isfinite(kl) and rel <= 1e-5,
              f"{spec}: step {i}: lockstep losses {kl} vs {pl}")
        check(sorted(kf) == sorted(pf), f"{spec}: state groups differ")
        for g in kf:
            for k in kf[g]:
                check(torch.equal(kf[g][k], pf[g][k]),
                      f"{spec}: step {i}: {g}/{k} differs between the "
                      "kernel and the plain path")
        state = (kp, kh, kf)
    out = {"spec": s.fault_spec.canonical(), "steps": steps,
           "b1_mode": mode, "b1_launches_a_step": b1 / steps,
           "b1_launches": tagged, "b2_launches_a_step": 2,
           "loss_rel_max": worst,
           "fused_epilogue_reason": kstep.fused_epilogue_reason,
           "quantum": s.pack_spec["decrement"],
           "broken_fraction": s.broken_fraction()}
    if "drift_age" in state[2]:
        ages = state[2]["drift_age"]
        out["drifted_cells"] = int(sum(int((a > 0).sum())
                                       for a in ages.values()))
    return out, last_tail


def drift_card_vs_cpu():
    """(b): the drift stack's draw and one fail on a stored state, on the
    card and on the CPU, bit for bit (XLA's exp and log1p in tensor ops,
    the final fma from float64 steps)."""
    import torch
    from rram_caffe_simulation_tpu_torch import proto
    from rram_caffe_simulation_tpu_torch.core import prng
    from rram_caffe_simulation_tpu_torch.fault.processes import FaultSpec
    pattern = proto.parse('type: "gaussian" mean: 300 std: 60',
                          "FailurePatternParameter")
    stack = FaultSpec.parse(PROCESS_DRIFT).build()
    key = prng.PRNGKey(22)
    cpu = stack.init_state(key, SLICE_LEAVES, pattern, device="cpu")
    card = stack.init_state(key, SLICE_LEAVES, pattern, device="cuda")
    for g in cpu:
        for k in cpu[g]:
            check(torch.equal(card[g][k].cpu().view(torch.int32),
                              cpu[g][k].view(torch.int32)),
                  f"(b) the card's draw of {g}/{k} differs from the CPU's")
    rng = np.random.RandomState(22)
    cpu["drift_age"] = {k: torch.from_numpy(rng.randint(
        0, 2000, v.shape).astype(np.float32))
        for k, v in cpu["drift_age"].items()}
    w = {k: torch.from_numpy((rng.randn(*s) * 0.1).astype(np.float32))
         for k, s in SLICE_LEAVES.items()}
    d = {}
    for k, s in SLICE_LEAVES.items():
        v = (rng.randn(*s) * 1e-3).astype(np.float32)
        v[rng.rand(*s) < 0.5] = 0.0
        d[k] = torch.from_numpy(v)
    to = lambda tree: {k: v.cuda() for k, v in tree.items()}
    wc, sc = stack.fail(w, cpu, d, 100.0)
    wg, sg = stack.fail(to(w), {g: to(t) for g, t in cpu.items()}, to(d),
                        100.0)
    cells = 0
    for k in w:
        check(torch.equal(wg[k].cpu().view(torch.int32),
                          wc[k].view(torch.int32)),
              f"(b) drifted weights of {k}: card and CPU differ")
        cells += w[k].numel()
    for g in sc:
        for k in sc[g]:
            check(torch.equal(sg[g][k].cpu(), sc[g][k]),
                  f"(b) {g}/{k} after the fail: card and CPU differ")
    moved = sum(int((wc[k] != w[k]).sum()) for k in w)
    return {"cells": cells, "moved_cells": moved,
            "rate_mean": float(sum(float(v.sum()) for v in
                                   cpu["drift_rate"].values()) / cells)}


def process_sweep(spec, C, steps):
    """(c): phase 7's sweep (C lanes, N(1e8, 3e7), ternary, packed banks,
    RRAM_POOL_BWD=cuda) under one stack: a warm step in lockstep with
    the plain engine (fusing stacks), then `steps` timed steps. B2 2, B1
    1 in the stack's mode (none unfused) and B4 1 a step."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.fault import fused
    from rram_caffe_simulation_tpu_torch.fault.processes import drift
    from rram_caffe_simulation_tpu_torch.parallel import SweepRunner
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = slice_solver(1e8, 3e7, fault_process=spec)
    r = SweepRunner(s, n_configs=C, engine="cuda", packed_state=True,
                    dtype_policy="ternary")
    setup_s = time.perf_counter() - t0
    mode = r._step.fused_mode
    check(r.engine_resolved == "cuda"
          and r.fused_epilogue_resolved == (mode is not None),
          f"{spec}: the sweep resolved engine {r.engine_resolved}, fused "
          f"{r.fused_epilogue_resolved}")
    out = {"spec": s.fault_spec.canonical(), "configs": C, "b1_mode": mode,
           "setup_s": setup_s}
    drift_args, real_fail = [], drift.ConductanceDrift.fail

    def spy(self, *a):
        drift_args.append((self,) + a)
        return real_fail(self, *a)
    if mode is not None:
        with tail_args() as seen:
            _, out["warm_lockstep_rel"] = warm_lockstep(r, 1)
        tail = seen[-1]
    else:
        drift.ConductanceDrift.fail = spy
        try:
            r.step(1, chunk=1)
        finally:
            drift.ConductanceDrift.fail = real_fail
        tail = None
    events = []
    inner, stepper = _event_stepper(r, events)
    r._step = stepper
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    kernels.reset_launches()
    start.record()
    t0 = time.perf_counter()
    losses = r.step(steps, chunk=steps)[0]
    wall = time.perf_counter() - t0
    launches, tagged = _launches(), dict(fused.FUSED_LIB.tagged)
    r._step = inner
    step_ms = [a.elapsed_time(b) for a, b in zip([start] + events[:-1],
                                                 events)]
    check(losses.shape == (C,) and bool(np.isfinite(losses).all()),
          f"{spec}: non-finite or misshapen sweep losses")
    n = steps if mode else 0
    check(launches == _untiled(B2=2 * steps, B1=n, B4=steps)
          and tagged == ({mode: steps} if mode else {}),
          f"{spec}: launches {launches} {tagged} in {steps} steps")
    out.update({"timed_steps": steps, "wall_s": wall,
                "configs_steps_per_s": C * steps / wall,
                "step_ms_median": float(np.median(step_ms)),
                "launches": launches, "b1_launches": tagged,
                "peak_mem_bytes": int(torch.cuda.max_memory_allocated())})
    if drift_args:
        args = drift_args[-1]
        dms = device_ms(lambda: real_fail(*args), iters=10)
        out["drift_pass_ms"] = dms
        out["drift_share_of_step"] = dms / out["step_ms_median"]
    del r, s
    torch.cuda.empty_cache()
    return out, tail


def phase_processes(gpu, sweep7=None):
    """Phase 22: the fault processes on the card. (a) each stack's Solver
    in lockstep, kernel path against plain; (b) the drift arithmetic on
    the card against the CPU; (c) the C = 512 sweep under read_disturb,
    permanent_fault_map and the drift stack, timed; (d) the drivers:
    run_1000_sweep --process read_disturb and run_codesign."""
    t0 = time.perf_counter()
    out = {"gpu": gpu, "lockstep": {}, "sweep": {}}
    tails = {}
    for spec in PROCESS_STACKS:
        res, tail = process_lockstep(spec, PROCESS_STEPS)
        out["lockstep"][res["spec"]] = res
        if tail is not None and res["b1_mode"] not in tails:
            tails[res["b1_mode"]] = (tail, res["b1_launches"])
        print(f"phase 22: (a) {res['spec']}: {PROCESS_STEPS} steps, kernel "
              f"vs plain in lockstep, every bank equal; loss rel max "
              f"{res['loss_rel_max']:.2e} (limit 1e-5); B1a mode "
              f"{res['b1_mode']}, {res['b1_launches_a_step']:g} launch(es) "
              f"a step, B2a 2; "
              + (f"fused_epilogue_reason: {res['fused_epilogue_reason']}"
                 if res["b1_mode"] is None else
                 f"quantum {res['quantum']:g}"), flush=True)
    out["card_vs_cpu"] = drift_card_vs_cpu()
    print(f"phase 22: (b) {PROCESS_DRIFT}: draw and one fail on the card "
          f"equal to the CPU's bit for bit "
          f"({json.dumps(out['card_vs_cpu'])})", flush=True)
    # the sweeps and the drivers run B4 (RRAM_POOL_BWD=cuda), as phases 7
    # and 21 do
    saved = os.environ.get("RRAM_POOL_BWD")
    os.environ["RRAM_POOL_BWD"] = "cuda"
    try:
        processes_on_the_sweep(out, gpu, sweep7, tails)
    finally:
        if saved is None:
            os.environ.pop("RRAM_POOL_BWD", None)
        else:
            os.environ["RRAM_POOL_BWD"] = saved
    out["phase_s"] = time.perf_counter() - t0
    return out


def processes_on_the_sweep(out, gpu, sweep7, tails):
    """Phase 22's (c), the B1 rows (on (a)'s `tails` and (c)'s) and (d),
    into `out`."""
    import tempfile
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.fault import fused
    C = sweep7["configs"] if sweep7 else SWEEP_CONFIGS
    sweep_tails = {}
    for spec in PROCESS_SWEEP_STACKS:
        res, tail = process_sweep(spec, C, PROCESS_SWEEP_TIMED)
        out["sweep"][res["spec"]] = res
        if tail is not None:
            sweep_tails[res["b1_mode"]] = (tail, res["b1_launches"])
        print(f"phase 22: (c) {res['spec']}, C = {C}: "
              f"{res['configs_steps_per_s']:.1f} configs*steps/s over "
              f"{PROCESS_SWEEP_TIMED} steps, step median "
              f"{res['step_ms_median']:.3f} ms; launches "
              f"{res['launches']}, B1b modes {res['b1_launches']}"
              + (f"; the drift pass {res['drift_pass_ms']:.3f} ms a "
                 f"step on the card, {res['drift_share_of_step']:.2%} "
                 "of the step" if "drift_pass_ms" in res else "")
              + (f"; phase 7 (endurance, same run): "
                 f"{sweep7['configs_steps_per_s']:.1f} configs*steps/s,"
                 f" step median {sweep7['step_ms_median']:.3f} ms"
                 if sweep7 else "") + f"; {gpu}", flush=True)
    # the B1 rows: each mode on a step's own tail, one config and C lanes
    out["b1_rows"] = {}
    for name, src, iters in (("B1a", tails, 100), ("B1b", sweep_tails, 20)):
        for mode, (tail, launches) in sorted(src.items()):
            row = b1_mode_numbers(tail, iters)
            row["launches"] = launches.get(mode, 0)
            out["b1_rows"][f"{name} {mode}"] = row
    del tails, sweep_tails
    torch.cuda.empty_cache()
    print(f"phase 22: B1 in its new modes on the steps' own inputs: "
          f"{json.dumps(out['b1_rows'])}", flush=True)

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        d = Path(tmp) / "rd"
        kernels.reset_launches()
        t1 = time.perf_counter()
        rec = run_driver([
            "--solver", SOLVER, "--configs", str(PROCESS_DRIVER_CONFIGS),
            "--group", str(PROCESS_DRIVER_CONFIGS), "--iters",
            str(PROCESS_DRIVER_ITERS), "--chunk", "5", "--mean", "1e8",
            "--std", "3e7", "--block", "0", "--run-dir", str(d),
            "--process", "read_disturb", *driver_flags()])
        wall = time.perf_counter() - t1
        with open(d / "manifest.json") as f:
            pin = json.load(f)["process"]
        n = PROCESS_DRIVER_ITERS
        check(rec["status"] == "clean" and rec["process"] == "read_disturb"
              and pin == "read_disturb",
              f"(d) run_1000_sweep --process read_disturb: {rec}, pin {pin}")
        check(_launches() == _untiled(B2=2 * n, B1=n, B4=n)
              and fused.FUSED_LIB.tagged == {"always": n},
              f"(d) the driver's launches {_launches()} "
              f"{fused.FUSED_LIB.tagged} in {n} steps")
        out["run_1000_sweep"] = {"configs": PROCESS_DRIVER_CONFIGS,
                                 "iters": n, "wall_s": wall,
                                 "manifest_process": pin,
                                 "b1_launches": dict(fused.FUSED_LIB.tagged)}
        print(f"phase 22: (d) run_1000_sweep --process read_disturb, one "
              f"group of {PROCESS_DRIVER_CONFIGS}, {n} iterations: exit 0 "
              f"in {wall:.1f} s, manifest pin {pin!r}, B1b "
              f"{fused.FUSED_LIB.tagged}", flush=True)
        from rram_caffe_simulation_tpu_torch.examples.gaussian_failure \
            import run_codesign
        t1 = time.perf_counter()
        code = 0
        try:
            run_codesign.main([
                "--solver", SOLVER, "--processes",
                "endurance_stuck_at,read_disturb", "--adc-bits", "0,4",
                "--means", "1000,3000", "--stds", "300", "--iters",
                str(CODESIGN_ITERS), "--chunk", "5", "--out",
                str(Path(tmp) / "codesign"), "--device", "cuda"])
        except SystemExit as e:
            code = e.code
        wall = time.perf_counter() - t1
        check(code in (0, run_codesign.DEGENERATE_EXIT),
              f"(d) run_codesign exited {code}")
        with open(Path(tmp) / "codesign" / "pareto_report.json") as f:
            report = json.load(f)
        check(report["evaluated"] == 8, f"(d) run_codesign: {report}")
        front = [{k: r[k] for k in ("process", "adc_bits", "mean", "loss",
                                    "broken", "adc_cost_bits")}
                 for r in report["front"]]
        out["run_codesign"] = {"exit": code, "wall_s": wall,
                               "front": front,
                               "degenerate": report["degenerate"]}
        print(f"phase 22: (d) run_codesign, 2 processes x 2 adc_bits x 2 "
              f"lanes, {CODESIGN_ITERS} iterations: exit {code} in "
              f"{wall:.1f} s; front {json.dumps(front)}", flush=True)


# ---------------------------------------------------------------------------
# phase 23: the experiment harness

VGG_NET = "models/cifar10_vgg11/cifar10_vgg11_fc1024_bn_scale_msra_fc_also.prototxt"
HARNESS_ITERS = 20                   # (a)'s and (b)'s iterations
HARNESS_MEANS = (4000.0, 8000.0, 1e8)     # (b)'s --sweep-means
HARNESS_PROBS = (5, 20)              # (c)'s prob grid
HARNESS_THRESHOLDS = (0.01, 1e9)     # (c)'s threshold grid
# (c)'s lifetimes: at N(4000, 1200) 0.04% of the cells are drawn at or
# below 0, broken before any write, so no threshold could keep the
# broken share at 0; at N(3000, 500) none is (6 sigma), and 15 writes
# break 0.13% (lifetimes below 1500)
HARNESS_GRID_LIFE = (3000.0, 500.0)
HARNESS_GRID_ITERS = 15              # (c)'s iterations a config
HARNESS_REMAP_ITERS = 10             # (d): remapping start 5, period 5
HARNESS_PRUNE_RATIO = 0.6
HARNESS_MODULE = f"{PKG}.examples.gaussian_failure.run_gaussian_exp"


def harness_templates(tmp: Path) -> dict:
    """The experiment template with absolute paths (its net, the net's
    Data sources): as it is ("hdf5", its snapshot_format HDF5) and with
    snapshot_format BINARYPROTO ("binary")."""
    net = (REPO / VGG_NET).read_text().replace('"examples/',
                                               f'"{REPO}/examples/')
    (tmp / "vgg11.prototxt").write_text(net)
    text = (REPO / VGG_TEMPLATE).read_text()
    check(f'net: "{VGG_NET}"' in text and "snapshot_format: HDF5" in text,
          "the experiment template changed: phase 23 rewrites its net "
          "path and snapshot format")
    text = text.replace(VGG_NET, str(tmp / "vgg11.prototxt"))
    out = {"net": str(tmp / "vgg11.prototxt")}
    for name, body in (("hdf5", text), ("binary", text.replace(
            "snapshot_format: HDF5", "snapshot_format: BINARYPROTO"))):
        (tmp / f"template_{name}.prototxt").write_text(body)
        out[name] = str(tmp / f"template_{name}.prototxt")
    return out


@contextlib.contextmanager
def harness_dir(path: Path):
    """Run a driver from `path`, its solvers/ there too (the runner's
    HERE); the working directory and HERE restored after."""
    from rram_caffe_simulation_tpu_torch.examples.gaussian_failure import \
        run_gaussian_exp
    path.mkdir(parents=True, exist_ok=True)
    cwd, here = os.getcwd(), run_gaussian_exp.HERE
    os.chdir(path)
    run_gaussian_exp.HERE = str(path)
    try:
        yield path
    finally:
        run_gaussian_exp.HERE = here
        os.chdir(cwd)


@contextlib.contextmanager
def step_stamps(stamps: list):
    """Record the host clock (after a device synchronize) at the start
    of every Solver iteration (its batch fetch): the gaps are the steps'
    wall times, the test before iteration 0 and the last snapshot
    outside them."""
    import torch
    from rram_caffe_simulation_tpu_torch.solver import solver as solver_mod
    real = solver_mod.Solver._next_batch

    def spy(self):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        return real(self)
    solver_mod.Solver._next_batch = spy
    try:
        yield
    finally:
        solver_mod.Solver._next_batch = real


def run_harness(main, argv):
    """(return value, stdout) of a driver's main(argv), its output
    echoed."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        code = main(argv)
    sys.stdout.write(buf.getvalue())
    return code, buf.getvalue()


def harness_one(tmp, templates, out):
    """(a) one config with -t and --hw-sigma: the solver text and the
    Iteration lines in the log, the last iteration's three snapshot
    files, B2a 3 and B1 0 a step (f32 banks), the step time."""
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.examples.gaussian_failure import \
        run_gaussian_exp
    mean, std = VGG_LIFE
    stamps = []
    with harness_dir(tmp / "a") as d:
        kernels.reset_launches()
        with step_stamps(stamps):
            code = run_gaussian_exp.main([
                str(mean), str(std), "0", "-y", "--template",
                templates["binary"], "--hw-sigma", str(VGG_SIGMA), "-t",
                "0.01", "--max-iter", str(HARNESS_ITERS)])
        launches = _launches()
        snap = d / f"snapshot_{mean}_{std}_threshold_0.01"
        log = (snap / "log").read_text()
        solver_file = (d / "solvers" / f"solver_{mean}_{std}_threshold_0.01"
                       ".prototxt")
    check(code == 0, f"(a) run_gaussian_exp returned {code}")
    check(log.startswith(solver_file.read_text())
          and "test_interval: 500" in log,
          "(a) the log does not open with the solver's text")
    iteration_lines = [ln for ln in log.splitlines()
                       if ln.startswith("Iteration ")]
    check(any(", loss = " in ln for ln in iteration_lines),
          f"(a) no Iteration loss line in the log: {iteration_lines}")
    files = sorted(p.name for p in snap.iterdir())
    last = [f"_iter_{HARNESS_ITERS}{ext}" for ext in
            (".caffemodel", ".faultstate", ".solverstate")]
    check(set(last) <= set(files), f"(a) snapshot files {files}")
    check(launches == _untiled(B2=3 * HARNESS_ITERS, B1=0, B4=0),
          f"(a) launches {launches} in {HARNESS_ITERS} steps, expected "
          "B2a 3 a step (fc1-3) and no B1 (f32 banks)")
    gaps = np.diff(stamps) * 1e3
    check(len(stamps) == HARNESS_ITERS, f"(a) {len(stamps)} steps stamped")
    q = [float(v) for v in np.percentile(gaps[2:], [25, 50, 75])]
    out["a"] = {"iterations": HARNESS_ITERS, "launches": launches,
                "b2_per_step": launches["B2"] / HARNESS_ITERS,
                "step_ms_quartiles": q, "snapshot_files": files,
                "iteration_lines": len(iteration_lines)}
    print(f"phase 23: (a) run_gaussian_exp {mean} {std} 0 -t 0.01 "
          f"--hw-sigma {VGG_SIGMA} --max-iter {HARNESS_ITERS}: exit 0, log "
          f"with the solver text and {len(iteration_lines)} Iteration "
          f"lines, {last} written; B2a {launches['B2'] / HARNESS_ITERS:g} "
          f"a step, B1 0 (f32 banks); step median {q[1]:.3f} ms "
          f"(quartiles {q[0]:.3f} / {q[2]:.3f}, host clock, synchronized)",
          flush=True)
    return snap / last[0]


def harness_sweep(tmp, templates, out):
    """(b) --sweep-means over HARNESS_MEANS (RRAM_POOL_BWD=cuda): one
    line a config, the broken share not rising with the mean, above 0 at
    the shortest, 0 at 1e8; B2b and B4 launches."""
    import re
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.examples.gaussian_failure import \
        run_gaussian_exp
    mean, std = VGG_LIFE
    means = ",".join(str(m) for m in HARNESS_MEANS)
    with harness_dir(tmp / "b") as d:
        kernels.reset_launches()
        code = run_gaussian_exp.main([
            str(mean), str(std), "0", "-y", "--template", templates["binary"],
            "--hw-sigma", str(VGG_SIGMA), "--max-iter", str(HARNESS_ITERS),
            "--sweep-means", means])
        launches = _launches()
        log = (d / f"snapshot_{mean}_{std}" / "log").read_text()
    check(code == 0, f"(b) run_gaussian_exp --sweep-means returned {code}")
    rows = re.findall(r"^config (\d+) \(mean=(\S+)\): Iteration (\d+), "
                      r"loss = (\S+), broken = (\S+)$", log, re.M)
    check([int(r[0]) for r in rows] == list(range(len(HARNESS_MEANS)))
          and all(int(r[2]) == HARNESS_ITERS for r in rows),
          f"(b) config lines {rows}")
    broken = [float(r[4]) for r in rows]
    check(all(a >= b for a, b in zip(broken, broken[1:]))
          and broken[0] > 0 and broken[-1] == 0.0,
          f"(b) broken shares {broken} over means {HARNESS_MEANS}")
    check(all(math.isfinite(float(r[3])) for r in rows), f"(b) {rows}")
    n = HARNESS_ITERS
    check(launches == _untiled(B2=3 * n, B1=0, B4=5 * n),
          f"(b) launches {launches} in {n} steps, expected B2b 3 (fc1-3) "
          "and B4 5 (the five pools) a step")
    out["b"] = {"means": list(HARNESS_MEANS), "broken": broken,
                "losses": [float(r[3]) for r in rows], "launches": launches}
    print(f"phase 23: (b) --sweep-means {means}, {n} iterations: exit 0; "
          f"broken {broken}, losses {[float(r[3]) for r in rows]}; B2b "
          f"{launches['B2'] / n:g} and B4 {launches['B4'] / n:g} a step",
          flush=True)


def harness_grids(tmp, templates, out):
    """(c) run_sweeps over a prob grid and a threshold grid: the table,
    broken > 0 on the prob rows, exactly 0 at threshold 1e9."""
    from rram_caffe_simulation_tpu_torch.examples.gaussian_failure import \
        run_sweeps
    mean, std = HARNESS_GRID_LIFE
    out["c"] = {}
    for kind, values in (("prob", HARNESS_PROBS),
                         ("threshold", HARNESS_THRESHOLDS)):
        with harness_dir(tmp / "c"):
            code, text = run_harness(run_sweeps.main, [
                kind, str(mean), str(std), "--values",
                ",".join(str(v) for v in values), "--max-iter",
                str(HARNESS_GRID_ITERS), "--template", templates["binary"]])
        check(code == 0, f"(c) run_sweeps {kind} returned {code}")
        lines = text.splitlines()
        head = next((i for i, ln in enumerate(lines)
                     if ln.split()[:2] == [kind, "loss"]), None)
        check(head is not None, f"(c) run_sweeps {kind}: no table")
        table = [ln.split() for ln in lines[head + 1:head + 1 + len(values)]]
        check(len(table) == len(values)
              and all(math.isfinite(float(r[1])) for r in table),
              f"(c) run_sweeps {kind} table {table}")
        broken = [float(r[2]) for r in table]
        if kind == "prob":
            check(all(b > 0 for b in broken), f"(c) prob rows {table}")
        else:
            check(broken[values.index(1e9)] == 0.0,
                  f"(c) threshold 1e9 row {table}")
        out["c"][kind] = [{"value": r[0], "loss": float(r[1]),
                           "broken": float(r[2])} for r in table]
        print(f"phase 23: (c) run_sweeps {kind} {mean} {std} {values}, "
              f"{HARNESS_GRID_ITERS} iterations a config: "
              + "; ".join(" ".join(r) for r in table), flush=True)


def harness_remap(tmp, templates, out, model):
    """(d) prune_order on (a)'s model, then the runner with -r over it:
    the file's two rows permutations of fc1's and fc2's 1024 outputs, the
    remapping applied."""
    from rram_caffe_simulation_tpu_torch.examples.gaussian_failure import (
        prune_order, run_gaussian_exp)
    from rram_caffe_simulation_tpu_torch.fault import strategies
    order = tmp / "d" / "prune_order.txt"
    order.parent.mkdir(parents=True, exist_ok=True)
    code, _ = run_harness(prune_order.main, [
        templates["net"], str(model), str(HARNESS_PRUNE_RATIO), str(order)])
    check(code == 0, f"(d) prune_order returned {code}")
    rows = [[int(x) for x in ln.split()]
            for ln in order.read_text().splitlines()]
    check(len(rows) == 2 and all(sorted(r) == list(range(1024))
                                 for r in rows),
          f"(d) prune order rows of {[len(r) for r in rows]}")
    calls = []
    real = strategies.remap_fc_neurons

    def spy(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    mean, std = VGG_LIFE
    strategies.remap_fc_neurons = spy
    try:
        with harness_dir(tmp / "d"):
            code = run_gaussian_exp.main([
                str(mean), str(std), "0", "-y", "--template",
                templates["binary"], "--hw-sigma", str(VGG_SIGMA), "-r",
                f"{order},5,5", "--max-iter", str(HARNESS_REMAP_ITERS)])
    finally:
        strategies.remap_fc_neurons = real
    check(code == 0, f"(d) run_gaussian_exp -r returned {code}")
    check(len(calls) >= 1, "(d) the remapping never ran")
    out["d"] = {"prune_ratio": HARNESS_PRUNE_RATIO,
                "rows": [len(r) for r in rows], "remaps": len(calls)}
    print(f"phase 23: (d) prune_order at {HARNESS_PRUNE_RATIO} on (a)'s "
          f"model: 2 rows of 1024; run_gaussian_exp -r <order>,5,5 "
          f"--max-iter {HARNESS_REMAP_ITERS}: exit 0, {len(calls)} "
          "remapping(s) applied", flush=True)


def harness_hdf5_start(tmp, templates):
    """(e) without h5py: the runner on the template as it is (HDF5), in
    a process of its own (started here, read by harness_hdf5_end)."""
    d = tmp / "e"
    d.mkdir(parents=True, exist_ok=True)
    mean, std = VGG_LIFE
    argv = [str(mean), str(std), "0", "-y", "--template", templates["hdf5"],
            "--max-iter", "2"]
    code = (f"import sys, {HARNESS_MODULE} as r; r.HERE = {str(d)!r}; "
            f"sys.exit(r.main({argv!r}))")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    return subprocess.Popen([sys.executable, "-c", code], cwd=d, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def harness_hdf5_end(tmp, templates, out, proc):
    """(e) h5py missing: the process exited non-zero, naming h5py, with
    no Iteration line; h5py present: the template's HDF5 snapshot written
    and restored in this process."""
    import importlib.util
    have = importlib.util.find_spec("h5py") is not None
    mean, std = VGG_LIFE
    if not have:
        stdout, stderr = proc.communicate(timeout=300)
        check(proc.returncode != 0 and "h5py" in stderr
              and "NotImplementedError" in stderr,
              f"(e) without h5py the runner exited {proc.returncode}: "
              f"{stderr[-2000:]}")
        check("Iteration" not in stdout, "(e) it trained before refusing")
        out["e"] = {"h5py": False, "exit": proc.returncode,
                    "refusal": stderr.strip().splitlines()[-1]}
        print(f"phase 23: (e) h5py cannot be imported: the template "
              f"(snapshot_format HDF5) refused before training, exit "
              f"{proc.returncode}: {out['e']['refusal']}", flush=True)
        return
    proc.kill()
    proc.communicate()
    from rram_caffe_simulation_tpu_torch.examples.gaussian_failure import \
        run_gaussian_exp
    from rram_caffe_simulation_tpu_torch.solver import Solver
    from rram_caffe_simulation_tpu_torch.utils.io import read_solver_param
    with harness_dir(tmp / "e" / "in_process") as d:
        code = run_gaussian_exp.main([str(mean), str(std), "0", "-y",
                                      "--template", templates["hdf5"],
                                      "--max-iter", "2"])
        snap = d / f"snapshot_{mean}_{std}"
        files = sorted(p.name for p in snap.iterdir())
        check(code == 0 and {"_iter_2.caffemodel.h5", "_iter_2.faultstate",
                             "_iter_2.solverstate.h5"} <= set(files),
              f"(e) HDF5 snapshot files {files}")
        s = Solver(read_solver_param(templates["hdf5"]))
        s.restore(str(snap / "_iter_2.solverstate.h5"))
    check(s.iter == 2, f"(e) restored at iteration {s.iter}")
    out["e"] = {"h5py": True, "files": files}
    print(f"phase 23: (e) h5py imports: the template's HDF5 snapshot "
          f"written ({files}) and restored at iteration 2", flush=True)


def phase_harness(gpu):
    """Phase 23: the fork's experiment harness on the card, from a
    temporary working directory, through the template with absolute
    paths at phase 16's operating point: (a) run_gaussian_exp, (b)
    --sweep-means, (c) run_sweeps, (d) prune_order and -r, (e) HDF5."""
    import tempfile
    t0 = time.perf_counter()
    out = {"gpu": gpu, "part_s": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_harness_") as tmp:
        tmp = Path(tmp)
        templates = harness_templates(tmp)
        saved = os.environ.get("RRAM_POOL_BWD")
        try:
            t = time.perf_counter()
            model = harness_one(tmp, templates, out)
            out["part_s"]["a"] = time.perf_counter() - t
            t = time.perf_counter()
            os.environ["RRAM_POOL_BWD"] = "cuda"
            harness_sweep(tmp, templates, out)
            out["part_s"]["b"] = time.perf_counter() - t
        finally:
            if saved is None:
                os.environ.pop("RRAM_POOL_BWD", None)
            else:
                os.environ["RRAM_POOL_BWD"] = saved
        proc = harness_hdf5_start(tmp, templates)
        try:
            t = time.perf_counter()
            harness_grids(tmp, templates, out)
            out["part_s"]["c"] = time.perf_counter() - t
            t = time.perf_counter()
            harness_remap(tmp, templates, out, model)
            out["part_s"]["d"] = time.perf_counter() - t
            t = time.perf_counter()
            harness_hdf5_end(tmp, templates, out, proc)
            out["part_s"]["e_wait"] = time.perf_counter() - t
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 23: parts {json.dumps(out['part_s'])}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 24: the in-repo nets (CIFAR-10 "full", its sigmoid nets, siamese)

NETS_SOLVERS = {
    "full": "examples/cifar10/cifar10_full_solver.prototxt",
    "sigmoid": "examples/cifar10/cifar10_full_sigmoid_solver.prototxt",
    "sigmoid_bn": "examples/cifar10/cifar10_full_sigmoid_solver_bn.prototxt"}
NETS_LIFE = (300.0, 50.0)        # int16 banks; ip1's cells die in 3-8 writes
NETS_LOCKSTEP = 5                # (a): card against CPU
NETS_TIMED = 10                  # (a): timed Solver steps
NETS_REL = 1e-4                  # (a): losses, card against CPU
NETS_LANES = 8                   # (b), (c): lanes against Solvers, blocks
NETS_LANE_STEPS = 3
NETS_SWEEP_TIMED = 3             # (b): cifar10_full at C = 512
NETS_TILED_STEPS = 3             # (e)
# (e): conv2 (800 x 32) and conv3 (800 x 64) on B3, ip1 (1024 x 10, eight
# K-tiles) on B2t, conv1 (75 x 32) inside one tile (no read kernel), one
# B1 for the eight fault leaves, no B4 in the Solver
NETS_TILED_PER_STEP = {"B2": 0, "B2t": 1, "B3": 2, "B1": 1, "B4": 0}
NETS_TILED_LAYERS = ("conv2", "conv3", "ip1")
NETS_LEAVES = {"ip1/0": (10, 1024), "ip1/1": (10,)}
NETS_B2_SHAPES = {"ip1": (100, 1024, 10)}
SIAMESE_NET = "examples/siamese/mnist_siamese_train_test.prototxt"
SIAMESE_BATCH = 64
NETS_SYNTH = """name: "channel_lanes"
layer { name: "in" type: "Input" top: "data" top: "target"
  input_param { shape { dim: 100 dim: 3 dim: 16 dim: 16 }
                shape { dim: 100 dim: 10 } } }
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
  convolution_param { num_output: 16 pad: 1 kernel_size: 3
    weight_filler { type: "gaussian" std: 0.1 }
    bias_filler { type: "constant" value: 0.1 } } }
layer { name: "lrn" type: "LRN" bottom: "conv" top: "lrn"
  lrn_param { local_size: 5 alpha: 0.0001 beta: 0.75 } }
layer { name: "slice" type: "Slice" bottom: "lrn" top: "s0" top: "s1"
  slice_param { slice_dim: 1 slice_point: 6 } }
layer { name: "concat" type: "Concat" bottom: "s1" bottom: "s0" top: "cat" }
layer { name: "sum" type: "Eltwise" bottom: "cat" bottom: "lrn" top: "sum"
  eltwise_param { operation: SUM coeff: 0.5 coeff: -1.5 } }
layer { name: "prod" type: "Eltwise" bottom: "sum" bottom: "conv"
  top: "prod" eltwise_param { operation: PROD } }
layer { name: "softmax" type: "Softmax" bottom: "prod" top: "softmax" }
layer { name: "flat" type: "Flatten" bottom: "softmax" top: "flat" }
layer { name: "ip1" type: "InnerProduct" bottom: "flat" top: "ip1"
  inner_product_param { num_output: 10
    weight_filler { type: "gaussian" std: 0.01 }
    bias_filler { type: "constant" } } }
layer { name: "loss" type: "EuclideanLoss" bottom: "ip1" bottom: "target"
  top: "loss" }
"""


def nets_solver(name, device, tmp, life=NETS_LIFE, seed=5, tiled=False,
                fields=None):
    """`name`'s own solver file with the overrides phase 24 names: a
    gaussian failure_pattern on ip1, BINARYPROTO snapshots under `tmp`,
    a seed; packed banks, the ternary read, the fused epilogue, engine
    "cuda". `tiled` adds conv_also on 128x128 tiles with 8-bit ADCs and
    implicit operands; `fields` other SolverParameter fields."""
    from rram_caffe_simulation_tpu_torch import proto
    from rram_caffe_simulation_tpu_torch.solver import Solver
    from rram_caffe_simulation_tpu_torch.utils.io import read_solver_param
    sp = read_solver_param(NETS_SOLVERS[name])
    check(sp.snapshot_format == proto.HDF5,
          f"{NETS_SOLVERS[name]} no longer asks for HDF5 snapshots")
    sp.random_seed = seed
    sp.failure_pattern.type = "gaussian"
    sp.failure_pattern.mean, sp.failure_pattern.std = life
    sp.snapshot_format = proto.BINARYPROTO
    sp.snapshot_prefix = str(tmp / name)
    for key, value in (fields or {}).items():
        setattr(sp, key, value)
    kw = {}
    if tiled:
        sp.failure_pattern.conv_also = True
        sp.rram_forward.adc_bits = 8
        sp.rram_forward.tiles = TILES
        kw["conv_im2col"] = "implicit"
    return Solver(sp, device=device, hw_engine="cuda",
                  dtype_policy="ternary", fault_format="packed",
                  fused_epilogue=True, **kw)


def tree_to(tree, device):
    """A params/history/fault-state tree with every tensor on `device`."""
    import torch
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_to(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


@contextlib.contextmanager
def update_spy(rec):
    """While rec["on"], record each fused tail's update tensors
    (references, no copy) in rec["u"]; the Solvers built inside the
    block take the spy (a step resolves its tail when it is made)."""
    from rram_caffe_simulation_tpu_torch.solver import solver as solver_mod
    real = solver_mod.fused_update_fail_leaves

    def spy(d, u, q, st, **kw):
        if rec["on"]:
            rec["u"].append(list(u))
        return real(d, u, q, st, **kw)
    solver_mod.fused_update_fail_leaves = spy
    try:
        yield
    finally:
        solver_mod.fused_update_fail_leaves = real


def banks_apart(got, want, u_got, u_want, rate, what):
    """The cells where two banks differ, each checked to be a write that
    rests on an exact-0 (or rounding-sized) update in one of the two runs
    (`u_got`, `u_want`: their updates; None: the banks must be equal);
    their count."""
    import torch
    differ = got != want
    if not differ.any():
        return 0
    check(u_got is not None, f"{what}: the banks differ")
    small = torch.minimum(u_got.abs(), u_want.abs())
    check(bool((small[differ] <= 1e-6 * rate).all()),
          f"{what}: the banks differ beyond exact-0 writes")
    return int(differ.sum())


def card_vs_cpu(label, make, steps, per_step, rel):
    """A Solver on the card and one on the CPU from one seed (`make(device)`
    builds each; params and banks equal at init), `steps` steps in
    lockstep, each CPU step from the card's state, batch and key: losses
    within `rel` relative, banks equal but for cells on exact-0 writes
    (checked, counted), the launches `per_step` each step. Returns the
    card's Solver after the steps and the part's numbers."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.core import prng
    t0 = time.perf_counter()
    rec = {"on": True, "u": []}
    with update_spy(rec):
        s, c = make("cuda"), make("cpu")
    check(s.pack_spec == c.pack_spec and s._fault_keys == c._fault_keys
          and s._step_fn.fused_epilogue_resolved,
          f"{label}: pack specs or fault keys differ, or no fused tail")
    for ln, vals in s.params.items():
        for a, b in zip(vals, c.params[ln]):
            check(a is None or torch.equal(a.cpu(), b),
                  f"{label}: {ln}'s init differs between card and CPU")
    for k, q in s.fault_state["life_q"].items():
        check(torch.equal(q.cpu(), c.fault_state["life_q"][k]),
              f"{label}: {k}'s banks differ between card and CPU at init")
    build_s = time.perf_counter() - t0
    rate = float(s.param.base_lr)
    worst, apart, cpu_s, losses = 0.0, 0, 0.0, []
    for it in range(steps):
        batch = s.train_feed()
        key = prng.fold_in(s._key, it)
        state = (s.params, s.history, s.fault_state)
        cstate = tree_to(state, "cpu")
        del rec["u"][:]
        kernels.reset_launches()
        kp, kh, kf, kl, _ = s._step_fn(*state, {
            k: torch.as_tensor(v).to(s.device) for k, v in batch.items()},
            it, key)
        torch.cuda.synchronize()
        got = _launches()
        check(got == per_step, f"{label} step {it}: launches {got}, "
              f"expected {per_step}")
        t_cpu = time.perf_counter()
        _, _, pf, pl, _ = c._step_fn(*cstate, {
            k: torch.as_tensor(v).cpu() for k, v in batch.items()}, it, key)
        cpu_s += time.perf_counter() - t_cpu
        kl, pl = float(kl), float(pl)
        gap = abs(kl - pl) / max(1.0, abs(pl))
        worst = max(worst, gap)
        losses.append(kl)
        check(math.isfinite(kl) and gap <= rel,
              f"{label} step {it}: card loss {kl} vs CPU {pl}")
        check(len(rec["u"]) == 2,
              f"{label}: {len(rec['u'])} fused tails a step")
        ku, cu = (dict(zip(s._fault_keys, u)) for u in rec["u"])
        for k in kf["life_q"]:
            apart += banks_apart(kf["life_q"][k].cpu(), pf["life_q"][k],
                                 ku[k].cpu(), cu[k], rate,
                                 f"{label} step {it}: {k}")
        s.params, s.history, s.fault_state = kp, kh, kf
    rec["on"] = False
    del rec["u"][:]
    s.iter = steps
    return s, {"lockstep_steps": steps, "loss_rel_max": worst,
               "losses": losses, "cells_apart_exact0": apart,
               "launches_per_step": per_step, "build_s": build_s,
               "cpu_steps_s": cpu_s}


def nets_card_vs_cpu(name, tmp):
    """(a) one net: `card_vs_cpu` over NETS_LOCKSTEP steps of its Solver
    (int16 banks, ip1 the fault target), then NETS_TIMED timed card
    steps. Returns the part's numbers."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    t_net = time.perf_counter()
    s, out = card_vs_cpu(
        f"(a) {name}", lambda dev: nets_solver(
            name, dev, tmp / ("card" if dev == "cuda" else "cpu")),
        NETS_LOCKSTEP, _untiled(B2=1, B1=1, B4=0), NETS_REL)
    check(s.pack_spec["life_dtype"] == "int16"
          and s._fault_keys == ["ip1/0", "ip1/1"],
          f"(a) {name}: pack spec {s.pack_spec}, fault keys "
          f"{s._fault_keys}")
    kernels.reset_launches()
    times = []
    for _ in range(NETS_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s.step(1)                       # ends in a host read of the loss
        times.append(time.perf_counter() - t0)
    timed = _launches()
    check(timed == _untiled(B2=NETS_TIMED, B1=NETS_TIMED, B4=0),
          f"(a) {name}: timed launches {timed}")
    check(math.isfinite(float(s.last_loss)), f"(a) {name}: loss")
    q = [float(v) * 1e3 for v in np.percentile(times, [25, 50, 75])]
    types = {"full": ("LRN",)}.get(name, ("Sigmoid",))
    per_step = out["launches_per_step"]
    out.update({"launches": {"B2": timed["B2"], "B1": timed["B1"]},
                "step_ms_quartiles": q, "broken": s.broken_fraction(),
                "layer_ms": layer_ms(s.net, types)[0], "layer_types": types,
                "seconds": time.perf_counter() - t_net})
    print(f"phase 24: (a) {name}: card against CPU, {NETS_LOCKSTEP} steps "
          f"in lockstep: losses within {out['loss_rel_max']:.2e} relative "
          f"(limit {NETS_REL:g}), banks equal but "
          f"{out['cells_apart_exact0']} cells on exact-0 writes; B2a "
          f"{per_step['B2']:g} and B1a {per_step['B1']:g} a step; "
          f"step median {q[1]:.3f} ms (quartiles {q[0]:.3f} / {q[2]:.3f}, "
          f"host clock, synchronized) over {NETS_TIMED} steps after the "
          f"lockstep; broken {out['broken']:.4f}; {'+'.join(types)} "
          f"{out['layer_ms']:.3f} ms a step; {out['seconds']:.1f} s (the two "
          f"Solvers' build {out['build_s']:.1f} s, the CPU's steps "
          f"{out['cpu_steps_s']:.1f} s)", flush=True)
    return out


def nets_hdf5_start(tmp):
    """(a') cifar10_full_solver.prototxt as it is (HDF5) in a process of
    its own, from the checkout's root; where h5py imports, two
    iterations with the snapshot under `tmp`."""
    code = (
        "import importlib.util, sys; sys.path.insert(0, {repo!r}); "
        "from rram_caffe_simulation_tpu_torch.solver import Solver; "
        "from rram_caffe_simulation_tpu_torch.utils.io import "
        "read_solver_param; sp = read_solver_param({solver!r}); "
        "have = importlib.util.find_spec('h5py') is not None\n"
        "if have:\n"
        "    sp.max_iter = 2; sp.snapshot = 2; sp.test_interval = 0; "
        "sp.snapshot_prefix = {prefix!r}\n"
        "Solver(sp).solve()").format(repo=str(REPO),
                                     solver=NETS_SOLVERS["full"],
                                     prefix=str(tmp / "hdf5" / "full"))
    (tmp / "hdf5").mkdir(parents=True, exist_ok=True)
    return subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def nets_hdf5_end(tmp, proc, out):
    import importlib.util
    stdout, stderr = proc.communicate(timeout=300)
    if importlib.util.find_spec("h5py") is None:
        check(proc.returncode != 0 and "h5py" in stderr
              and "NotImplementedError" in stderr,
              f"(a') without h5py the solver exited {proc.returncode}: "
              f"{stderr[-2000:]}")
        check("Iteration" not in stdout, "(a') it trained before refusing")
        out["hdf5"] = {"h5py": False, "exit": proc.returncode,
                       "refusal": stderr.strip().splitlines()[-1]}
        print(f"phase 24: (a') h5py cannot be imported: "
              f"{NETS_SOLVERS['full']} (snapshot_format HDF5) refused "
              f"before any step, exit {proc.returncode}: "
              f"{out['hdf5']['refusal']}", flush=True)
        return
    files = sorted(p.name for p in (tmp / "hdf5").iterdir())
    check(proc.returncode == 0 and {"full_iter_2.caffemodel.h5",
                                    "full_iter_2.solverstate.h5"}
          <= set(files), f"(a') HDF5 run exited {proc.returncode}, files "
          f"{files}: {stderr[-2000:]}")
    out["hdf5"] = {"h5py": True, "files": files}
    print(f"phase 24: (a') h5py imports: {NETS_SOLVERS['full']} wrote its "
          f"HDF5 snapshot {files}", flush=True)


def lanes_vs_solvers(r, solver, label, steps, per_step, rec=None):
    """`steps` steps of runner `r`, one at a time, each lane against
    `solver`'s single-config step from the lane's state, batch and key:
    loss within 1e-5 relative, banks identical (with `rec`, the update
    spy both were built under: equal but for cells on exact-0 writes,
    checked and counted), the launches `per_step` each step (the kinds it
    names). Returns the worst loss gap, the cells apart and the runner's losses."""
    from rram_caffe_simulation_tpu_torch import kernels
    C, rate = r.n, float(solver.param.base_lr)
    worst, apart, losses = 0.0, 0, []
    for it in range(steps):
        batch = r._batch(r.iter)
        keys = r.lane_keys(r.iter)
        before = [r.lane_state(i) for i in range(C)]
        state = (r.params, r.history, r.fault_states)
        if rec is not None:
            del rec["u"][:]
        kernels.reset_launches()
        kp, kh, kf, kl, _ = r._step(*state, batch, r.iter, keys)
        got = _launches()
        check(all(got[k] == v for k, v in per_step.items()),
              f"{label} step {it}: launches {got}, expected {per_step}")
        lane_upd = (dict(zip(solver._fault_keys, rec["u"][0]))
                    if rec is not None else None)
        for i in range(C):
            if rec is not None:
                del rec["u"][:]
            _, _, sf, sl, _ = solver._step_fn(*before[i], batch, r.iter,
                                              keys[i])
            gap = abs(float(sl) - float(kl[i])) / max(1.0, abs(float(sl)))
            worst = max(worst, gap)
            check(gap <= 1e-5, f"{label} step {it} lane {i}: loss "
                  f"{float(kl[i])} vs Solver {float(sl)}")
            upd = (dict(zip(solver._fault_keys, rec["u"][0]))
                   if rec is not None else None)
            for k in sf["life_q"]:
                apart += banks_apart(
                    kf["life_q"][k][i], sf["life_q"][k],
                    lane_upd and lane_upd[k][i], upd and upd[k], rate,
                    f"{label} step {it} lane {i}, {k} against the Solver")
        del before, lane_upd, upd
        r._commit(kp, kh, kf, kl)
        r.iter += 1
        losses.append(kl.cpu().numpy())
    return worst, apart, losses


def blocks_vs_unblocked(solver, label, C, opts, rewind=None):
    """A runner in blocks of 2 from `solver`'s seed against the unblocked
    one, 2 steps each (`rewind` restarts a host feed before each): the
    banks bit for bit, the losses within 1e-5; the params' and history's
    gap reported (small lane counts move cuDNN's algorithm for a grouped
    convolution, groups = lanes, and for its group-1 call over a shared
    bottom, filters = lanes x num_output; a bias before a BatchNorm has a
    true gradient of zero, so its own is rounding in either run; the
    large counts of nets_sweep_512 and phase 18, and the new layers alone
    in nets_chain_blocks, hold every leaf bit for bit)."""
    from rram_caffe_simulation_tpu_torch.parallel import SweepRunner
    runs = []
    for block in (0, 2):
        if rewind is not None:
            rewind()
        rb = SweepRunner(solver, n_configs=C, config_block=block, **opts)
        runs.append((rb, [rb.step(1)[0].copy() for _ in range(2)]))
    (a, la), (b, lb) = runs
    loss_gap = max(float(np.abs(x - y).max() / max(1.0, np.abs(y).max()))
                   for x, y in zip(la, lb))
    check(loss_gap <= 1e-5, f"{label}: blocked losses {lb} vs {la}")
    gaps = state_gaps(a, b)
    banks = [k for k in gaps["apart"] if k.startswith("fault/")]
    check(not banks, f"{label}: blocks of 2 part from unblocked on banks "
          f"{banks}")
    for rb in (a, b):
        rb.close()
    return {"block": 2, "block_loss_gap": loss_gap,
            "block_leaves": gaps["leaves"], "block_leaves_apart": gaps["apart"],
            "block_rel_max": gaps["rel_max"]}


LANE_OPTS = dict(engine="cuda", packed_state=True, dtype_policy="ternary")


def nets_lanes(solver, label, C=NETS_LANES, steps=NETS_LANE_STEPS,
               rewind=None):
    """(b), (c): C lanes, `lanes_vs_solvers` over `steps` steps (B2b 1,
    B1b 1 a step), every lane with a broken cell after them; then
    `blocks_vs_unblocked`. `rewind` restarts a host feed before each of
    the last two runners."""
    from rram_caffe_simulation_tpu_torch.parallel import SweepRunner
    r = SweepRunner(solver, n_configs=C, **LANE_OPTS)
    check(r.engine_resolved == "cuda" and r.fused_epilogue_resolved,
          f"{label}: the runner did not resolve to engine cuda, fused")
    check(r._pack_spec == solver.pack_spec,
          f"{label}: the runner's pack spec differs from the Solver's")
    worst, _, _ = lanes_vs_solvers(r, solver, label, steps,
                                   {"B2": 1, "B1": 1})
    broken = r.broken_fractions()
    check(bool((broken > 0).all()), f"{label}: a lane had no broken cell")
    r.close()
    return {"configs": C, "steps": steps, "lane_loss_rel_max": worst,
            "broken": [float(v) for v in broken],
            **blocks_vs_unblocked(solver, label, C, LANE_OPTS, rewind)}


def state_gaps(a, b):
    """Two runners' state leaves compared: how many, the ones not equal
    bit for bit, and the largest gap relative to a leaf's largest
    value."""
    import torch
    leaves, apart, rel = 0, [], 0.0
    for grp, (ga, gb) in (("params", (a.params, b.params)),
                          ("history", (a.history, b.history)),
                          ("fault", (a.fault_states, b.fault_states))):
        for k in ga:
            va, vb = ga[k], gb[k]
            pairs = (zip(va.items(), vb.values()) if isinstance(va, dict)
                     else zip(enumerate(va), vb))
            for (slot, x), y in pairs:
                if x is None:
                    continue
                leaves += 1
                if x.is_floating_point():
                    if torch.equal(x.view(torch.int32), y.view(torch.int32)):
                        continue
                    scale = float(y.abs().max().clamp_min(1e-30))
                    rel = max(rel, float((x - y).abs().max()) / scale)
                elif torch.equal(x, y):
                    continue
                apart.append(f"{grp}/{k}/{slot}")
    return {"leaves": leaves, "apart": apart, "rel_max": rel}


NETS_CHAIN = """name: "new_lane_rules"
layer { name: "in" type: "Input" top: "data" top: "target" top: "sim"
  input_param { shape { dim: 100 dim: 16 dim: 8 dim: 8 }
                shape { dim: 100 dim: 1024 } shape { dim: 100 } } }
layer { name: "across" type: "LRN" bottom: "data" top: "across"
  lrn_param { local_size: 5 alpha: 0.5 beta: 0.75 } }
layer { name: "within" type: "LRN" bottom: "across" top: "within"
  lrn_param { local_size: 3 alpha: 0.3 beta: 0.75
              norm_region: WITHIN_CHANNEL } }
layer { name: "slice" type: "Slice" bottom: "within" top: "s0" top: "s1"
  slice_param { slice_point: 6 } }
layer { name: "concat" type: "Concat" bottom: "s1" bottom: "s0" top: "cat" }
layer { name: "sum" type: "Eltwise" bottom: "cat" bottom: "within" top: "sum"
  eltwise_param { operation: SUM coeff: 0.5 coeff: -1.5 } }
layer { name: "prod" type: "Eltwise" bottom: "sum" bottom: "data"
  top: "prod" eltwise_param { operation: PROD } }
layer { name: "max" type: "Eltwise" bottom: "prod" bottom: "across"
  top: "max" eltwise_param { operation: MAX } }
layer { name: "softmax" type: "Softmax" bottom: "max" top: "softmax" }
layer { name: "split" type: "Split" bottom: "softmax" top: "sa" top: "sb" }
layer { name: "sig" type: "Sigmoid" bottom: "sa" top: "sig" }
layer { name: "tanh" type: "TanH" bottom: "sb" top: "tanh" }
layer { name: "flat" type: "Flatten" bottom: "sig" top: "flat" }
layer { name: "reshape" type: "Reshape" bottom: "tanh" top: "rs"
  reshape_param { shape { dim: 0 dim: 32 dim: -1 } } }
layer { name: "flat2" type: "Flatten" bottom: "rs" top: "flat2" }
layer { name: "euclid" type: "EuclideanLoss" bottom: "flat" bottom: "target"
  top: "euclid" }
layer { name: "contrast" type: "ContrastiveLoss" bottom: "flat"
  bottom: "flat2" bottom: "sim" top: "contrast" }
"""


def nets_chain_blocks(out, C=NETS_LANES, block=2):
    """(c) the new layers alone under lanes (no convolution, no GEMM):
    NETS_CHAIN's forward and backward over C lanes of laned data against
    the same in blocks of `block` lanes, each lane's losses and data
    gradient bit for bit."""
    import torch
    from rram_caffe_simulation_tpu_torch import proto
    from rram_caffe_simulation_tpu_torch.net import Net
    net = Net(proto.parse(NETS_CHAIN, "NetParameter"), proto.TRAIN,
              device="cuda")
    rng = np.random.RandomState(6)
    feed = {"data": rng.randn(100, C * 16, 8, 8),
            "target": rng.rand(100, C * 1024),
            "sim": rng.randint(0, 2, (100, C))}
    feed = {k: torch.as_tensor(v, dtype=torch.float32).to(net.device)
            for k, v in feed.items()}

    def run(batch, lanes):
        x = batch["data"].clone().requires_grad_()
        _, loss = net.apply({}, {**batch, "data": x}, lanes=lanes,
                            laned_data=True)
        (g,) = torch.autograd.grad(loss.sum(), [x])
        return loss.detach(), g
    loss, grad = run(feed, C)
    widths = {"data": 16, "target": 1024, "sim": 1}
    parts = [run({k: v[:, j * block * widths[k]:(j + 1) * block * widths[k]]
                  for k, v in feed.items()}, block)
             for j in range(C // block)]
    bl = torch.cat([p[0] for p in parts])
    bg = torch.cat([p[1] for p in parts], 1)
    check(loss.shape == (C,) and bool(torch.isfinite(loss).all()),
          f"(c) chain losses {loss}")
    check(torch.equal(loss.view(torch.int32), bl.view(torch.int32))
          and torch.equal(grad.view(torch.int32), bg.view(torch.int32)),
          f"(c) the new layers over {C} lanes part from blocks of {block}: "
          f"losses {loss.tolist()} vs {bl.tolist()}, gradient apart by "
          f"{float((grad - bg).abs().max()):.3e}")
    out["c_chain"] = {"configs": C, "block": block,
                      "losses": loss.tolist()}
    print(f"phase 24: (c) the new layers alone (LRN both regions, Slice, "
          f"Concat, Eltwise SUM/PROD/MAX, Softmax, Split, Sigmoid, TanH, "
          f"Flatten, Reshape, EuclideanLoss, ContrastiveLoss) over C = {C} "
          f"lanes against blocks of {block}: losses and the data gradient "
          "bit for bit", flush=True)


def nets_sweep_512(tmp, gpu):
    """(b) cifar10_full at C = 512 (halved until it fits), N(1e8, 3e7),
    RRAM_POOL_BWD=cuda: one warm step, NETS_SWEEP_TIMED timed steps."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.parallel import SweepRunner
    C = SWEEP_CONFIGS
    while True:
        try:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            s = nets_solver("full", "cuda", tmp / "sweep", life=(1e8, 3e7),
                            seed=1)
            r = SweepRunner(s, n_configs=C, engine="cuda",
                            packed_state=True, dtype_policy="ternary")
            setup_s = time.perf_counter() - t0
            r.step(1)
            events = []
            inner, stepper = _event_stepper(r, events)
            r._step = stepper
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            kernels.reset_launches()
            start.record()
            t0 = time.perf_counter()
            losses = r.step(NETS_SWEEP_TIMED, chunk=NETS_SWEEP_TIMED)[0]
            wall = time.perf_counter() - t0
            launches = _launches()
            r._step = inner
            break
        except torch.cuda.OutOfMemoryError:
            check(C > 8, "(b) cifar10_full does not fit the card at C = 8")
            print(f"phase 24: (b) C = {C} does not fit (out of memory); "
                  "halving", flush=True)
            r = s = None
            C //= 2
            torch.cuda.empty_cache()
    n = NETS_SWEEP_TIMED
    check(r._dataset is not None, "(b) the dataset is not on the device")
    check(losses.shape == (C,) and bool(np.isfinite(losses).all()),
          "(b) non-finite sweep losses")
    check(launches == _untiled(B2=n, B1=n, B4=n),
          f"(b) launches {launches} in {n} steps, expected B2b 1, B1b 1, B4 "
          "1 a step (ip1; ip1's two leaves; pool1)")
    step_ms = [a.elapsed_time(b) for a, b in zip([start] + events[:-1],
                                                 events)]
    peak = torch.cuda.max_memory_allocated()
    lrn_ms = layer_ms(s.net, ("LRN",), lanes=C)[0]
    # the same steps in blocks of C / 4 lanes, from the same seed: every
    # state leaf bit for bit
    block = C // 4
    rb = SweepRunner(s, n_configs=C, engine="cuda", packed_state=True,
                     dtype_policy="ternary", config_block=block)
    rb.step(1)
    blosses = rb.step(n, chunk=n)[0]
    gaps = state_gaps(r, rb)
    check(blosses.tobytes() == losses.tobytes() and not gaps["apart"],
          f"(b) C = {C} in blocks of {block} parts from unblocked on "
          f"{gaps['apart']} ({gaps['rel_max']:.2e})")
    rb.close()
    del rb
    out = {"configs": C, "timed_steps": n, "configs_steps_per_s": C * n / wall,
           "step_ms": step_ms, "step_ms_median": float(np.median(step_ms)),
           "peak_mem_bytes": int(peak), "setup_s": setup_s,
           "launches": launches, "lrn_ms": lrn_ms, "block": block,
           "block_leaves_equal": gaps["leaves"], "gpu": gpu}
    r.close()
    del r, s
    torch.cuda.empty_cache()
    print(f"phase 24: (b) cifar10_full sweep, C = {C}, N(1e8, 3e7), "
          f"RRAM_POOL_BWD=cuda: {out['configs_steps_per_s']:.1f} "
          f"configs*steps/s over {n} steps; step median "
          f"{out['step_ms_median']:.3f} ms ({[round(v, 3) for v in step_ms]}"
          f", CUDA events); peak memory {peak / 1e9:.2f} GB; LRN (norm1, "
          f"norm2) {lrn_ms:.3f} ms a step alone; launches {launches}; "
          f"setup {setup_s:.1f} s; in blocks of {block} every one of "
          f"{gaps['leaves']} state leaves bit for bit; {gpu}", flush=True)
    return out


def nets_synthetic_solver():
    """(c)'s Solver, NETS_SYNTH with a seeded host feed, and the feed's
    rewind."""
    from rram_caffe_simulation_tpu_torch import proto
    from rram_caffe_simulation_tpu_torch.solver import Solver
    rng = np.random.RandomState(4)
    bs = [{"data": rng.randn(100, 3, 16, 16).astype(np.float32),
           "target": rng.randn(100, 10).astype(np.float32)}
          for _ in range(4)]
    state = {"i": 0}

    def feed():
        state["i"] += 1
        return bs[(state["i"] - 1) % len(bs)]
    text = (f'net_param {{ {NETS_SYNTH} }} base_lr: 0.01 momentum: 0.9 '
            'weight_decay: 0.004 lr_policy: "fixed" display: 0 '
            'max_iter: 100 random_seed: 4 failure_pattern { '
            f'type: "gaussian" mean: {NETS_LIFE[0]} std: {NETS_LIFE[1]} }}')
    return Solver(proto.parse(text, "SolverParameter"), train_feed=feed,
                  hw_engine="cuda", dtype_policy="ternary",
                  fault_format="packed", fused_epilogue=True), \
        lambda: state.update(i=0)


def siamese_text(batch):
    """The siamese net with its two Data layers (its LMDB is not in the
    repository) as one Input layer of their tops' shapes."""
    import re
    text = (REPO / SIAMESE_NET).read_text()
    blocks = re.split(r"(?m)^(?=layer \{)", text)
    keep = [b for b in blocks if 'type: "Data"' not in b]
    check(len(keep) == len(blocks) - 2, "the siamese net's Data layers")
    feed = ('layer { name: "pair_data" type: "Input" top: "pair_data" '
            f'top: "sim" input_param {{ shape {{ dim: {batch} dim: 2 '
            f'dim: 28 dim: 28 }} shape {{ dim: {batch} }} }} }}\n')
    return keep[0] + feed + "".join(keep[1:])


def nets_siamese(out):
    """(d) the siamese TRAIN net at its width, seeded pair_data/sim fed
    as data tops, the crossbar read armed on its six InnerProduct reads
    (three owners), forward and backward on the card against the CPU."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels, proto
    from rram_caffe_simulation_tpu_torch.core import prng
    from rram_caffe_simulation_tpu_torch.net import Net
    text = siamese_text(SIAMESE_BATCH)
    nets = {d: Net(proto.parse(text, "NetParameter"), proto.TRAIN, device=d)
            for d in ("cuda", "cpu")}
    owners = [r.key for r in nets["cpu"].failure_param_refs]
    check(owners == [("ip1", 0), ("ip1", 1), ("ip2", 0), ("ip2", 1),
                     ("feat", 0), ("feat", 1)], f"(d) fault targets {owners}")
    reads = [ly.name for ly in nets["cpu"].layers
             if ly.type_name == "InnerProduct"]
    params = nets["cpu"].init(prng.PRNGKey(2))
    rng = np.random.RandomState(0)
    broken = {k: torch.from_numpy(rng.rand(*params[k][0].shape) < 0.1)
              for k in ("ip1", "ip2", "feat")}
    stuck = {k: torch.from_numpy(rng.choice(
        [-1.0, 0.0, 1.0], size=tuple(params[k][0].shape)).astype(np.float32))
        for k in broken}
    batch = {"pair_data": torch.from_numpy(
        rng.rand(SIAMESE_BATCH, 2, 28, 28).astype(np.float32)),
        "sim": torch.from_numpy(rng.randint(0, 2, SIAMESE_BATCH)
                                .astype(np.float32))}
    res = {}
    for d, net in nets.items():
        leaves = {k: [t.to(d).requires_grad_() for t in v]
                  for k, v in params.items()}
        cb = {name: (broken[name.replace("_p", "")].to(d),
                     stuck[name.replace("_p", "")].to(d), 11, 0.0, 2, True)
              for name in reads}
        kernels.reset_launches()
        _, loss = net.apply(leaves, {k: v.to(d) for k, v in batch.items()},
                            crossbar=cb)
        fwd = _launches()["B2"]
        flat = [t for v in leaves.values() for t in v]
        grads = torch.autograd.grad(loss, flat)
        res[d] = (float(loss.detach()), [g.cpu() for g in grads], fwd)
    (kl, kg, kf), (pl, pg, _) = res["cuda"], res["cpu"]
    check(kf == 6, f"(d) B2a launched {kf} times in a forward, expected 6")
    rel = abs(kl - pl) / max(1.0, abs(pl))
    check(math.isfinite(kl) and rel <= 1e-5,
          f"(d) siamese loss card {kl} vs CPU {pl}")
    worst = 0.0
    names = [f"{k}/{i}" for k, v in params.items() for i in range(len(v))]
    for name, a, b in zip(names, kg, pg):
        scale = float(b.abs().max())
        gap = float((a - b).abs().max()) / max(scale, 1e-30)
        worst = max(worst, gap)
        check(gap <= 1e-4, f"(d) siamese gradient {name}: {gap:.2e} of its "
              "largest value apart")
    out["d"] = {"batch": SIAMESE_BATCH, "loss": kl, "loss_rel": rel,
                "grad_gap_max": worst, "b2_per_forward": kf,
                "reads": reads}
    print(f"phase 24: (d) siamese TRAIN net, batch {SIAMESE_BATCH}, pair_data "
          f"2x28x28 fed: six crossbar reads of three shared weights (B2a "
          f"{kf} a forward); loss {kl:.6f}, card against CPU {rel:.2e} "
          f"relative (limit 1e-5), gradients within {worst:.2e} of their "
          "largest (limit 1e-4)", flush=True)


def nets_tiled(tmp, out):
    """(e) cifar10_full with conv_also on 128x128 tiles, 8-bit ADCs,
    implicit operands: NETS_TILED_STEPS steps, the launches a step
    NETS_TILED_PER_STEP gives, finite losses."""
    from rram_caffe_simulation_tpu_torch import kernels
    s = nets_solver("full", "cuda", tmp / "tiled", life=(1e8, 3e7),
                    tiled=True, fields={"test_interval": 0})
    tiles = s._tiles_ctx()
    check(sorted(tiles) == sorted(NETS_TILED_LAYERS), f"(e) tiles {tiles}")
    check(s._step_fn.conv_im2col_resolved == "implicit",
          "(e) the implicit operand did not engage")
    check(len(s.fault_state["life_q"]) == 8, "(e) eight fault leaves")
    kernels.reset_launches()
    losses = []
    for _ in range(NETS_TILED_STEPS):
        s.step(1)
        losses.append(float(s.last_loss))
    got = _launches()
    want = {k: v * NETS_TILED_STEPS for k, v in NETS_TILED_PER_STEP.items()}
    check(got == want, f"(e) launches {got} in {NETS_TILED_STEPS} steps, "
          f"expected {want}")
    check(all(math.isfinite(v) for v in losses), f"(e) losses {losses}")
    out["e"] = {"tiles": {k: list(v) for k, v in tiles.items()},
                "losses": losses, "launches": got}
    print(f"phase 24: (e) cifar10_full, conv_also on {TILES} tiles, 8-bit "
          f"ADCs, implicit operands: {NETS_TILED_STEPS} steps, losses "
          f"{[round(v, 5) for v in losses]}; launches {got} (B3 conv2, "
          "conv3; B2t ip1; B1 the eight leaves)", flush=True)


def phase_nets(gpu):
    """Phase 24: the in-repo nets on the card, from a temporary working
    directory for snapshots, the LMDB sources read from the checkout:
    (a) each CIFAR-10 "full" net from its solver file, card against CPU;
    (a') the HDF5 solver file as it is; (b) lanes and blocks at C = 8,
    cifar10_full at C = 512; (c) channel-axis lanes; (d) siamese; (e)
    tiles."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    out = {"gpu": gpu, "part_s": {}, "a": {}}
    saved = os.environ.get("RRAM_POOL_BWD")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nets_") as tmp:
        tmp = Path(tmp)
        proc = nets_hdf5_start(tmp)
        try:
            t = time.perf_counter()
            for name in NETS_SOLVERS:
                out["a"][name] = nets_card_vs_cpu(name, tmp)
            out["part_s"]["a"] = time.perf_counter() - t
            t = time.perf_counter()
            os.environ["RRAM_POOL_BWD"] = "cuda"
            out["b"] = {name: nets_lanes(
                nets_solver(name, "cuda", tmp / "lanes"), f"(b) {name}")
                for name in ("full", "sigmoid_bn")}
            out["b"]["sweep"] = nets_sweep_512(tmp, gpu)
            out["part_s"]["b"] = time.perf_counter() - t
            t = time.perf_counter()
            synth, rewind = nets_synthetic_solver()
            out["c"] = nets_lanes(synth, "(c)", rewind=rewind)
            nets_chain_blocks(out)
            out["part_s"]["c"] = time.perf_counter() - t
            for part, label in (("b", "cifar10_full, BN-sigmoid"),
                                ("c", "synthetic channel-axis net")):
                rows = ([out["b"]["full"], out["b"]["sigmoid_bn"]]
                        if part == "b" else [out["c"]])
                print(f"phase 24: ({part}) {label} at C = {NETS_LANES}, "
                      f"{NETS_LANE_STEPS} steps: each lane against a "
                      "Solver from its state, losses within "
                      f"{max(r['lane_loss_rel_max'] for r in rows):.2e} "
                      "relative, banks identical; blocks of 2: banks bit "
                      "for bit, losses within "
                      f"{max(r['block_loss_gap'] for r in rows):.2e}, "
                      f"{[len(r['block_leaves_apart']) for r in rows]} of "
                      f"{[r['block_leaves'] for r in rows]} param and "
                      "history leaves apart (cuDNN at small group counts), "
                      f"by {[round(r['block_rel_max'], 6) for r in rows]} "
                      "of their largest", flush=True)
        finally:
            if saved is None:
                os.environ.pop("RRAM_POOL_BWD", None)
            else:
                os.environ["RRAM_POOL_BWD"] = saved
        try:
            t = time.perf_counter()
            nets_siamese(out)
            out["part_s"]["d"] = time.perf_counter() - t
            t = time.perf_counter()
            nets_tiled(tmp, out)
            out["part_s"]["e"] = time.perf_counter() - t
            t = time.perf_counter()
            nets_hdf5_end(tmp, proc, out)
            out["part_s"]["a_hdf5_wait"] = time.perf_counter() - t
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 24: parts {json.dumps(out['part_s'])}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 25: the ImageNet-width zoo nets and generated_net

ZOO_NETS = {    # solver file, small batch of (b)
    "alexnet": ("models/bvlc_alexnet/solver.prototxt", 4),
    "caffenet": ("models/bvlc_reference_caffenet/solver.prototxt", 4),
    "googlenet": ("models/bvlc_googlenet/quick_solver.prototxt", 2),
    "resnet50": ("models/resnet50/solver.prototxt", 2),
}
ZOO_RECORDS = 64                 # (a): the stand-in LMDB's 3x256x256 Datums
ZOO_SEED = 24
ZOO_MEAN = (104.0, 117.0, 123.0)  # mean_value in place of the mean file
ZOO_LIFE = NETS_LIFE             # int16 banks; cells die within 3-8 writes
ZOO_REL = 1e-4                   # (b): losses, card against CPU
ZOO_TIMED = 3                    # (c): timed Solver steps, after a warm one
ZOO_PREFETCH_STEPS = 5           # (c): steps a prefetching block
ZOO_PROFILED = 2                 # (c): profiled steps after them
# a kernel's own device activity on the path
ZOO_KERNEL_NAMES = {"B2": ("crossbar_kernel", "lane_absmax_kernel"),
                    "B1": B1_KERNELS, "B4": B4_KERNELS}
ZOO_SWEEP_LANES = 4              # (d): AlexNet's sweep at batch 256
ZOO_SWEEP_TIMED = 3
# examples/pycaffe/generated_net.prototxt as the reference's
# examples/pycaffe/run_pycaffe.py writes it with its NetSpec (the file is
# generated, not in the repository; the port has no NetSpec yet):
# random DummyData data, constant labels
GENERATED_NET = """layer { name: "data" type: "DummyData" top: "data" top: "label"
  dummy_data_param { data_filler { type: "gaussian" }
    data_filler { type: "constant" }
    shape { dim: 8 dim: 1 dim: 8 dim: 8 } shape { dim: 8 } } }
layer { name: "conv" type: "Convolution" bottom: "data" top: "conv"
  convolution_param { num_output: 4 kernel_size: 3
    weight_filler { type: "xavier" } } }
layer { name: "relu" type: "ReLU" bottom: "conv" top: "conv" }
layer { name: "pool" type: "Pooling" bottom: "conv" top: "pool"
  pooling_param { pool: MAX kernel_size: 2 stride: 2 } }
layer { name: "ip" type: "InnerProduct" bottom: "pool" top: "ip"
  inner_product_param { num_output: 10 weight_filler { type: "xavier" } } }
layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" bottom: "label"
  top: "loss" }
"""
# a step's launches under RRAM_POOL_BWD=cuda: B2a one a fault-target
# InnerProduct, B1a one for every 16 fault leaves, B4 one a MAX pool
ZOO_PER_STEP = {"alexnet": (3, 1, 3), "caffenet": (3, 1, 3),
                "googlenet": (5, 1, 13), "resnet50": (1, 1, 1)}
ZOO_B2_SHAPES = {"fc6": (256, 9216, 4096), "fc7": (256, 4096, 4096),
                 "fc8": (256, 4096, 1000)}
ZOO_LEAVES = {"fc6/0": (4096, 9216), "fc6/1": (4096,), "fc7/0": (4096, 4096),
              "fc7/1": (4096,), "fc8/0": (1000, 4096), "fc8/1": (1000,)}
ZOO_POOLS = ((96, 55), (256, 27), (256, 13))     # AlexNet's: planes, H=W
POOL3X3S2 = ((3, 3), (2, 2), (0, 0, 0, 0))       # their kernel, stride, pad


def zoo_lmdb(path, n=ZOO_RECORDS, seed=ZOO_SEED):
    """The stand-in for the ILSVRC12 LMDBs (not in the repository): n
    3x256x256 uint8 Datums with labels below 1000, from a seed, written
    by the port's BulkWriter."""
    from rram_caffe_simulation_tpu_torch import proto
    from rram_caffe_simulation_tpu_torch.data.feed import array_to_datum
    from rram_caffe_simulation_tpu_torch.data.lmdb_py import BulkWriter
    rng = np.random.RandomState(seed)
    with BulkWriter(str(path)) as w:
        for i in range(n):
            arr = rng.randint(0, 256, size=(3, 256, 256), dtype=np.uint8)
            w.put(f"{i:08d}".encode(), proto.encode(
                array_to_datum(arr, int(rng.randint(1000)))))
    return str(path)


def zoo_solver(name, device, db, batch=None, life=ZOO_LIFE, seed=5):
    """`name`'s own solver file with its net's Data layers on `db`, the
    mean file as mean values, the TRAIN batch `batch` (None: the
    published one), a gaussian failure_pattern on its InnerProduct
    layers, a seed, no test; packed banks, the ternary read, the fused
    epilogue, engine "cuda"."""
    from rram_caffe_simulation_tpu_torch import proto
    from rram_caffe_simulation_tpu_torch.solver import Solver
    from rram_caffe_simulation_tpu_torch.utils.io import (read_net_param,
                                                          read_solver_param)
    sp = read_solver_param(ZOO_NETS[name][0])
    netp = read_net_param(sp.net)
    for lp in netp.layer:
        if lp.type != "Data":
            continue
        lp.data_param.source = db
        if batch is not None and lp.include and \
                lp.include[0].phase == proto.TRAIN:
            lp.data_param.batch_size = batch
        if lp.transform_param.HasField("mean_file"):
            lp.transform_param.ClearField("mean_file")
            lp.transform_param.mean_value.extend(ZOO_MEAN)
    sp.ClearField("net")
    sp.net_param = netp
    sp.test_interval = 0
    sp.random_seed = seed
    sp.failure_pattern.type = "gaussian"
    sp.failure_pattern.mean, sp.failure_pattern.std = life
    return Solver(sp, device=device, hw_engine="cuda",
                  dtype_policy="ternary", fault_format="packed",
                  fused_epilogue=True)


@contextlib.contextmanager
def draws_on_card():
    """core/prng.py's bulk draws made on the card and copied to the
    device asked for: the same bits (phase 13 holds card draws equal to
    CPU draws), so a full-width CPU Solver is built in seconds, not
    minutes."""
    import inspect
    from rram_caffe_simulation_tpu_torch.core import prng
    saved = {n: getattr(prng, n) for n in ("normal", "uniform",
                                           "bernoulli", "normal_fma")}

    def on_card(fn):
        sig = inspect.signature(fn)

        def draw(*a, **kw):
            args = sig.bind(*a, **kw)
            args.apply_defaults()
            where = args.arguments["device"]
            args.arguments["device"] = "cuda"
            return fn(*args.args, **args.kwargs).to(where)
        return draw
    for n, fn in saved.items():
        setattr(prng, n, on_card(fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(prng, n, fn)


def zoo_card_vs_cpu(name, db):
    """(b) `name` at its small batch: `card_vs_cpu` over one step, the
    CPU's Solver drawing on the card (the same bits), the launches of
    ZOO_PER_STEP."""
    import torch
    t0 = time.perf_counter()
    batch_n = ZOO_NETS[name][1]

    def make(device):
        if device == "cuda":
            return zoo_solver(name, device, db, batch_n)
        with draws_on_card():
            return zoo_solver(name, device, db, batch_n)
    b2, b1, b4 = ZOO_PER_STEP[name]
    s, out = card_vs_cpu(f"(b) {name}", make, 1,
                         _untiled(B2=b2, B1=b1, B4=b4), ZOO_REL)
    s.close()
    del s
    torch.cuda.empty_cache()
    out.update(batch=batch_n, seconds=time.perf_counter() - t0)
    print(f"phase 25: (b) {name} at batch {batch_n}: card against CPU, one "
          f"step from one state: loss {out['losses'][0]:.6f}, "
          f"{out['loss_rel_max']:.2e} relative (limit {ZOO_REL:g}); banks "
          f"equal but {out['cells_apart_exact0']} cells on exact-0 writes; "
          f"launches B2a {b2}, B1a {b1}, B4 {b4}; the CPU's step "
          f"{out['cpu_steps_s']:.1f} s, the Solvers' build "
          f"{out['build_s']:.1f} s", flush=True)
    return out


def zoo_timed(name, db, gpu):
    """(c) `name` at its published batch: one warm and ZOO_TIMED timed
    Solver steps (host clock, synchronized, the host feed included), the
    feed's ms a batch, peak memory, the launches a step; then
    ZOO_PREFETCH_STEPS steps a block through a prefetching feed
    (`prefetch_steps`)."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    t0 = time.perf_counter()
    s = zoo_solver(name, "cuda", db)
    batch_n = s.net.blob_shapes["data"][0]
    s.step(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times = []
    for _ in range(ZOO_TIMED):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s.step(1)                       # ends in a host read of the loss
        times.append((time.perf_counter() - t1) * 1e3)
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    feed = []
    for _ in range(ZOO_TIMED):
        t1 = time.perf_counter()
        s.train_feed()
        feed.append((time.perf_counter() - t1) * 1e3)
    prefetch_ms = prefetch_steps(s, ZOO_PREFETCH_STEPS)
    b2, b1, b4 = ZOO_PER_STEP[name]
    n = ZOO_TIMED
    check(launches == _untiled(B2=b2 * n, B1=b1 * n, B4=b4 * n),
          f"(c) {name}: launches {launches} in {n} steps, expected B2a "
          f"{b2}, B1a {b1}, B4 {b4} a step")
    loss = float(s.last_loss)
    check(math.isfinite(loss), f"(c) {name}: loss {loss}")
    # the kernels' device time a step on the path, by device activity
    by_name = device_ms_by_name(lambda: s.step(1), iters=ZOO_PROFILED)
    own = {kn: sum(v for nm, (v, _) in by_name.items()
                   if any(k in nm for k in names))
           for kn, names in ZOO_KERNEL_NAMES.items()}
    busy = sum(v for v, _ in by_name.values())
    out = {"batch": batch_n, "step_ms": times,
           "step_ms_median": float(np.median(times)),
           "feed_ms_median": float(np.median(feed)),
           "prefetch_step_ms": prefetch_ms, "peak_bytes": int(peak),
           "launches": launches,
           "launches_per_step": {k: v / n for k, v in launches.items()},
           "kernel_ms": own, "device_busy_ms": busy,
           "loss": loss, "seconds": time.perf_counter() - t0}
    print(f"phase 25: (c) {name} at batch {batch_n}: step median "
          f"{out['step_ms_median']:.3f} ms ({[round(v, 3) for v in times]}, "
          f"host clock, synchronized, the host feed included); the feed "
          f"{out['feed_ms_median']:.3f} ms a batch; through a prefetching "
          f"feed, by GIL switch interval, {json.dumps(prefetch_ms)} ms "
          f"(median of {ZOO_PREFETCH_STEPS}); the device busy "
          f"{busy:.3f} ms a step ({ZOO_PROFILED} profiled), of it B2a "
          f"{own['B2']:.5f}, B1a {own['B1']:.5f}, B4 {own['B4']:.5f} ms; "
          f"peak memory {peak / 1e9:.2f} GB; launches a step B2a {b2}, B1a "
          f"{b1}, B4 {b4}; loss {loss:.5f}; {gpu}", flush=True)
    s.close()
    del s
    torch.cuda.empty_cache()
    return out


def zoo_sweep_reckoning(net, C):
    """(d)'s memory, reckoned from AlexNet's blob shapes before the run:
    the two LRNs' bottoms over C lanes, conv1's unfolded patches of the
    shared bottom, and its cotangent rows padded to LANE_CHUNK lanes
    (ops/vision.py `_SharedBottomConv2d`), in bytes."""
    from rram_caffe_simulation_tpu_torch.ops.vision import LANE_CHUNK
    lrn = sum(math.prod(net.blob_shapes[ly.lp.bottom[0]])
              for ly in net.layers if ly.type_name == "LRN")
    n, _, h, w = net.blob_shapes["conv1"]
    patches = n * h * w * 3 * 11 * 11
    rows = LANE_CHUNK * 96 * n * h * w
    return {"lrn_elements": C * lrn, "lrn_bytes": 4 * C * lrn,
            "conv1_patches_bytes": 4 * patches,
            "conv1_cotangent_rows_bytes": 4 * rows}


def zoo_sweep(db, gpu, C=ZOO_SWEEP_LANES):
    """(d) AlexNet's sweep at batch 256 over C lanes (RRAM_POOL_BWD=cuda,
    the host feed: a TRAIN crop is not materializable): one step of
    `lanes_vs_solvers` (banks equal but for exact-0 writes), a warm and
    ZOO_SWEEP_TIMED timed steps (configs x steps per second, step times
    by CUDA events, peak memory beside the reckoning), then
    `blocks_vs_unblocked` from one feed position."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.parallel import SweepRunner
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    rec = {"on": True, "u": []}
    with update_spy(rec):
        s = zoo_solver("alexnet", "cuda", db)
        r = SweepRunner(s, n_configs=C, **LANE_OPTS)
    reckoned = zoo_sweep_reckoning(s.net, C)
    check(r.engine_resolved == "cuda" and r.fused_epilogue_resolved
          and r._dataset is None, "(d) the runner's path")
    worst, apart, _ = lanes_vs_solvers(r, s, "(d)", 1,
                                       _untiled(B2=3, B1=1, B4=3), rec)
    rec["on"] = False
    del rec["u"][:]
    r.step(1)
    events = []
    inner, stepper = _event_stepper(r, events)
    r._step = stepper
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    kernels.reset_launches()
    start.record()
    t1 = time.perf_counter()
    losses = r.step(ZOO_SWEEP_TIMED, chunk=ZOO_SWEEP_TIMED)[0]
    wall = time.perf_counter() - t1
    launches = _launches()
    r._step = inner
    peak = torch.cuda.max_memory_allocated()
    n = ZOO_SWEEP_TIMED
    check(launches == _untiled(B2=3 * n, B1=n, B4=3 * n),
          f"(d) timed launches {launches}")
    check(bool(np.isfinite(losses).all()), f"(d) losses {losses}")
    step_ms = [a.elapsed_time(b) for a, b in zip([start] + events[:-1],
                                                 events)]
    r.close()
    del r
    torch.cuda.empty_cache()
    blocks = blocks_vs_unblocked(s, "(d)", C, LANE_OPTS)
    del s
    torch.cuda.empty_cache()
    out = {"configs": C, "batch": 256, "lane_loss_rel_max": worst,
           "lane_cells_apart": apart, "timed_steps": n,
           "configs_steps_per_s": C * n / wall, "step_ms": step_ms,
           "step_ms_median": float(np.median(step_ms)),
           "peak_bytes": int(peak), "reckoned": reckoned,
           "launches": launches, **blocks, "gpu": gpu,
           "seconds": time.perf_counter() - t0}
    print(f"phase 25: (d) AlexNet sweep, C = {C}, batch 256, "
          f"RRAM_POOL_BWD=cuda: each lane against a Solver from its state, "
          f"losses within {worst:.2e} relative, {apart} bank cells apart; "
          f"{out['configs_steps_per_s']:.2f} configs*steps/s over {n} "
          f"steps, step median {out['step_ms_median']:.3f} ms "
          f"({[round(v, 3) for v in step_ms]}, CUDA events); peak memory "
          f"{peak / 1e9:.2f} GB, reckoned: LRNs "
          f"{reckoned['lrn_bytes'] / 1e9:.2f} GB, conv1's patches "
          f"{reckoned['conv1_patches_bytes'] / 1e9:.2f} GB and cotangent "
          f"rows {reckoned['conv1_cotangent_rows_bytes'] / 1e9:.2f} GB; "
          f"launches {launches}; blocks of 2: banks bit for bit, losses "
          f"within {blocks['block_loss_gap']:.2e}, "
          f"{len(blocks['block_leaves_apart'])} param and history leaves "
          f"apart by {blocks['block_rel_max']:.2e} of their largest; {gpu}",
          flush=True)
    return out


def zoo_masks(out):
    """(f) Dropout's masks and DummyData's draws on the card equal the
    CPU's bit for bit: AlexNet's drop6 at (256, 4096) over a laned and a
    shared bottom at C = 4 and alone, generated_net's gaussian data
    top at C = 4."""
    import torch
    from rram_caffe_simulation_tpu_torch import proto
    from rram_caffe_simulation_tpu_torch.core import prng
    from rram_caffe_simulation_tpu_torch.core.registry import LayerContext
    from rram_caffe_simulation_tpu_torch.net import Net
    from rram_caffe_simulation_tpu_torch.ops.neuron import DropoutLayer
    lp = proto.parse('name: "drop6" type: "Dropout" bottom: "fc6" '
                     'top: "fc6" dropout_param { dropout_ratio: 0.5 }',
                     "LayerParameter")
    layer = DropoutLayer(lp, proto.TRAIN)
    layer.setup([(256, 4096)])
    C = ZOO_SWEEP_LANES
    key = prng.fold_in(prng.PRNGKey(ZOO_SEED), 7)
    keys = prng.fold_in(key[None], np.arange(C))
    x = torch.randn(256, C * 4096)
    cases = 0
    for lanes, laned, xs in ((0, (), x[:, :4096]), (C, (True,), x),
                             (C, (False,), x[:, :4096])):
        tops = {}
        for dev in ("cuda", "cpu"):
            ctx = LayerContext(phase=proto.TRAIN, rng=keys if lanes else key,
                               lanes=lanes, laned=laned, device=dev)
            tops[dev] = layer.apply([], [xs.to(dev)], ctx)[0].cpu()
        check(torch.equal(tops["cuda"].view(torch.int32),
                          tops["cpu"].view(torch.int32)),
              f"(f) drop6's masks differ between card and CPU (lanes "
              f"{lanes}, laned {laned})")
        cases += 1
    text = GENERATED_NET
    draws = {}
    for dev in ("cuda", "cpu"):
        net = Net(proto.parse(text, "NetParameter"), proto.TRAIN, device=dev)
        params = {ln: [v.unsqueeze(0).expand((C,) + tuple(v.shape))
                       for v in vals]
                  for ln, vals in net.init(prng.PRNGKey(1)).items()}
        draws[dev] = net.apply(params, rng=keys, lanes=C)[0]["data"].cpu()
    check(torch.equal(draws["cuda"].view(torch.int32),
                      draws["cpu"].view(torch.int32)),
          "(f) generated_net's DummyData draws differ between card and CPU")
    out["f"] = {"dropout_cases": cases, "dummydata_lanes": C}
    print(f"phase 25: (f) AlexNet's drop6 at (256, 4096) alone and over "
          f"{C} lanes (laned and shared bottom) and generated_net's "
          f"DummyData over {C} lanes: card equal to CPU bit for bit",
          flush=True)


def generated_solver():
    """generated_net (GENERATED_NET: random DummyData data, constant
    labels) in a Solver: SGD at 0.05, faults on ip at ZOO_LIFE, the
    phase's engine and banks."""
    from rram_caffe_simulation_tpu_torch import proto
    from rram_caffe_simulation_tpu_torch.solver import Solver
    text = (f"net_param {{ {GENERATED_NET} }} "
            'base_lr: 0.05 momentum: 0.9 weight_decay: 0.0005 '
            'lr_policy: "fixed" display: 0 max_iter: 100 random_seed: 5 '
            f'failure_pattern {{ type: "gaussian" mean: {ZOO_LIFE[0]} '
            f"std: {ZOO_LIFE[1]} }}")
    return Solver(proto.parse(text, "SolverParameter"), hw_engine="cuda",
                  dtype_policy="ternary", fault_format="packed",
                  fused_epilogue=True)


def phase_zoo(gpu):
    """Phase 25: the zoo nets at their published widths, from their own
    solver files on a stand-in LMDB, under RRAM_POOL_BWD=cuda: (a) the
    LMDB, (b) each net card against CPU at a small batch, (c) each net's
    Solver at its published batch, (d) AlexNet's sweep, (e)
    generated_net over lanes, (f) Dropout's masks card against CPU."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    out = {"gpu": gpu, "part_s": {}, "b": {}, "c": {}}
    saved = os.environ.get("RRAM_POOL_BWD")
    os.environ["RRAM_POOL_BWD"] = "cuda"
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_") as tmp:
            t = time.perf_counter()
            db = zoo_lmdb(Path(tmp) / "ilsvrc_standin_lmdb")
            out["part_s"]["a"] = time.perf_counter() - t
            out["a"] = {"records": ZOO_RECORDS, "seed": ZOO_SEED,
                        "bytes": os.path.getsize(Path(db) / "data.mdb")}
            print(f"phase 25: (a) stand-in LMDB of {ZOO_RECORDS} 3x256x256 "
                  f"Datums from seed {ZOO_SEED}, {out['a']['bytes']} bytes, "
                  f"in {out['part_s']['a']:.1f} s", flush=True)
            t = time.perf_counter()
            for name in ZOO_NETS:
                out["b"][name] = zoo_card_vs_cpu(name, db)
            out["part_s"]["b"] = time.perf_counter() - t
            t = time.perf_counter()
            for name in ZOO_NETS:
                out["c"][name] = zoo_timed(name, db, gpu)
            out["part_s"]["c"] = time.perf_counter() - t
            t = time.perf_counter()
            out["d"] = zoo_sweep(db, gpu)
            out["part_s"]["d"] = time.perf_counter() - t
            t = time.perf_counter()
            out["e"] = nets_lanes(generated_solver(), "(e) generated_net",
                                  C=NETS_LANES)
            print(f"phase 25: (e) generated_net at C = {NETS_LANES}: each "
                  "lane against a Solver from its state, losses within "
                  f"{out['e']['lane_loss_rel_max']:.2e} relative, banks "
                  "identical; blocks of 2 against unblocked: losses within "
                  f"{out['e']['block_loss_gap']:.2e}, banks bit for bit",
                  flush=True)
            out["part_s"]["e"] = time.perf_counter() - t
            t = time.perf_counter()
            zoo_masks(out)
            out["part_s"]["f"] = time.perf_counter() - t
    finally:
        if saved is None:
            os.environ.pop("RRAM_POOL_BWD", None)
        else:
            os.environ["RRAM_POOL_BWD"] = saved
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 25: parts {json.dumps(out['part_s'])}", flush=True)
    return out



# ---------------------------------------------------------------------------
# phase 26: the data sources

FINETUNE_NETS = {   # solver file, the data layer it trains through
    "flickr_style": ("models/finetune_flickr_style/solver.prototxt",
                     "ImageData"),
    "pascal": ("examples/finetune_pascal_detection/"
               "pascal_finetune_solver.prototxt", "WindowData"),
}
LINREG_NET = "examples/pycaffe/linreg.prototxt"
DATA_SEED = 25
DATA_IMAGES = 64                 # (a): flickr_style's stand-in PNGs
DATA_VOC = (16, 24)              # (a): VOC stand-ins at 3x375x500, windows each
DATA_RECORDS = 64                # (a): the LevelDB's and the LMDB's Datums
DATA_SMALL_BATCH = 4             # (b)
DATA_REL = 1e-5                  # (b): losses, card against CPU
DATA_TIMED = 3                   # (c): timed steps, after a warm one
DATA_TEST_ITER = 2               # (c): flickr_style's Solver.test batches
DATA_PER_STEP = {"flickr_style": (3, 1, 3), "pascal": (3, 1, 3),
                 "linreg": (2, 1, 0)}    # B2a, B1a, B4 a step
# the kernels line at pascal's path, batch 128 (its pools: ZOO_POOLS)
DATA_B2_SHAPES = {"fc6": (128, 9216, 4096), "fc7": (128, 4096, 4096),
                  "fc8_pascal": (128, 4096, 21)}
DATA_LEAVES = {"fc6/0": (4096, 9216), "fc6/1": (4096,), "fc7/0": (4096, 4096),
               "fc7/1": (4096,), "fc8_pascal/0": (21, 4096),
               "fc8_pascal/1": (21,)}


def data_standins(tmp):
    """(a) Stand-ins for the data the nets name and the repository does not
    hold, from DATA_SEED, written by the port's own writers: flickr_style's
    PNGs (sizes around 256x256) and train/test lists, VOC-sized PNGs
    (3x375x500) and a window file of foreground (overlap >= 0.5) and
    background windows, a 1x3x256x256 mean .binaryproto, and one set of
    Datums as a LevelDB and as an LMDB."""
    from rram_caffe_simulation_tpu_torch import proto
    from rram_caffe_simulation_tpu_torch.data import leveldb_py, lmdb_py
    from rram_caffe_simulation_tpu_torch.data.feed import array_to_datum
    from rram_caffe_simulation_tpu_torch.data.imagecodec import encode_png
    from rram_caffe_simulation_tpu_torch.data.windows import (
        WindowRecord, write_window_file)
    from rram_caffe_simulation_tpu_torch.utils.io import (array_to_blob,
                                                          write_proto_binary)
    rng = np.random.RandomState(DATA_SEED)

    def png(name, h, w):
        path = str(tmp / name)
        with open(path, "wb") as f:
            f.write(encode_png(rng.randint(0, 256, (h, w, 3),
                                           dtype=np.uint8)))
        return path
    lines = [f"{png(f'flickr_{i:03d}.png', *rng.randint(224, 289, 2))} "
             f"{rng.randint(20)}\n" for i in range(DATA_IMAGES)]
    files = {"flickr_train": tmp / "flickr_train.txt",
             "flickr_test": tmp / "flickr_test.txt"}
    files["flickr_train"].write_text("".join(lines))
    files["flickr_test"].write_text("".join(lines[:16]))
    n_img, per = DATA_VOC
    images = [(png(f"voc_{i:03d}.png", 375, 500), (3, 375, 500))
              for i in range(n_img)]
    windows = []
    for i in range(n_img):
        for j in range(per):
            x1, x2 = sorted(rng.randint(0, 500, 2))
            y1, y2 = sorted(rng.randint(0, 375, 2))
            fg = j % 2 == 0
            windows.append(WindowRecord(
                i, int(rng.randint(1, 21)) if fg else 0,
                float(0.5 + 0.5 * rng.rand() if fg else 0.49 * rng.rand()),
                (int(x1), int(y1), int(x2), int(y2))))
    files["windows"] = tmp / "windows.txt"
    write_window_file(str(files["windows"]), images, windows)
    files["mean"] = tmp / "imagenet_mean.binaryproto"
    write_proto_binary(str(files["mean"]), array_to_blob(
        (110 + 20 * rng.randn(1, 3, 256, 256)).astype(np.float32)))
    records = [(f"{i:08d}".encode(), proto.encode(array_to_datum(
        rng.randint(0, 256, (3, 32, 32), dtype=np.uint8),
        int(rng.randint(10))))) for i in range(DATA_RECORDS)]
    files["leveldb"], files["lmdb"] = tmp / "leveldb", tmp / "lmdb"
    for mod, key in ((leveldb_py, "leveldb"), (lmdb_py, "lmdb")):
        with mod.BulkWriter(str(files[key])) as w:
            for k, v in records:
                w.put(k, v)
    return {k: str(v) for k, v in files.items()}


def data_solver(name, device, files, batch=None, test_iter=None,
                life=ZOO_LIFE, seed=5, prefetch=False):
    """`name`'s own solver file (FINETUNE_NETS, or "linreg" for
    examples/pycaffe/linreg.prototxt under SGD) with its data layers on
    the stand-ins `files`, the TRAIN batch `batch` (None: the published
    one), `test_iter` batches a test (None: the file's), no automatic
    test, a gaussian failure_pattern on the InnerProduct layers, a seed;
    packed banks, the ternary read, the fused epilogue, engine "cuda";
    its default feeds prefetching with `prefetch`."""
    from rram_caffe_simulation_tpu_torch import proto
    from rram_caffe_simulation_tpu_torch.solver import Solver
    from rram_caffe_simulation_tpu_torch.utils.io import (read_net_param,
                                                          read_solver_param)
    if name == "linreg":
        sys.path.insert(0, str(REPO / "examples/pycaffe"))   # pyloss
        sp = proto.parse('base_lr: 0.01 momentum: 0.9 weight_decay: '
                         '0.0005 lr_policy: "fixed" display: 0',
                         "SolverParameter")
        sp.net_param = read_net_param(LINREG_NET)
    else:
        sp = read_solver_param(FINETUNE_NETS[name][0])
        netp = read_net_param(sp.net)
        for lp in netp.layer:
            if lp.type not in ("ImageData", "WindowData"):
                continue
            train = lp.include[0].phase == proto.TRAIN
            param = (lp.image_data_param if lp.type == "ImageData"
                     else lp.window_data_param)
            param.source = (files["windows"] if lp.type == "WindowData"
                            else files["flickr_train" if train
                                       else "flickr_test"])
            if batch is not None and train:
                param.batch_size = batch
            lp.transform_param.mean_file = files["mean"]
        sp.ClearField("net")
        sp.net_param = netp
        if test_iter is not None:
            sp.test_iter = [test_iter]
    sp.test_interval = 0
    sp.random_seed = seed
    sp.failure_pattern.type = "gaussian"
    sp.failure_pattern.mean, sp.failure_pattern.std = life
    return Solver(sp, device=device, hw_engine="cuda",
                  dtype_policy="ternary", fault_format="packed",
                  fused_epilogue=True, prefetch=prefetch)


def data_card_vs_cpu(name, files):
    """(b) `name` at batch DATA_SMALL_BATCH: `card_vs_cpu` over one step
    (the card Solver's batch from its own feed through its own data
    layer), the CPU's Solver drawing on the card (the same bits), the
    launches of DATA_PER_STEP."""
    import torch
    t0 = time.perf_counter()

    def make(device):
        if device == "cuda":
            return data_solver(name, device, files, DATA_SMALL_BATCH)
        with draws_on_card():
            return data_solver(name, device, files, DATA_SMALL_BATCH)
    b2, b1, b4 = DATA_PER_STEP[name]
    s, out = card_vs_cpu(f"(b) {name}", make, 1,
                         _untiled(B2=b2, B1=b1, B4=b4), DATA_REL)
    s.close()
    del s
    torch.cuda.empty_cache()
    out.update(seconds=time.perf_counter() - t0)
    print(f"phase 26: (b) {name} at batch {DATA_SMALL_BATCH}: card against "
          f"CPU, one step from one state: loss {out['losses'][0]:.6f}, "
          f"{out['loss_rel_max']:.2e} relative (limit {DATA_REL:g}); banks "
          f"equal but {out['cells_apart_exact0']} cells on exact-0 writes; "
          f"launches B2a {b2}, B1a {b1}, B4 {b4}; the CPU's step "
          f"{out['cpu_steps_s']:.1f} s", flush=True)
    return out


def _clone_tree(tree):
    """A params/history/fault-state tree with every tensor cloned."""
    import torch
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_clone_tree(v) for v in tree)
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _flat_tensors(tree, prefix=""):
    import torch
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat_tensors(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat_tensors(v, f"{prefix}{i}/"))
        return out
    return {prefix: tree} if isinstance(tree, torch.Tensor) else {}


def data_timed(name, files, gpu):
    """(c) `name` at its published batch, its Solver built with
    `prefetch`: one warm and DATA_TIMED timed Solver steps (host clock,
    synchronized), the launches a step, peak memory; then one step from
    one state through the prefetching feed (profiled: the device busy ms)
    and, the producer stopped, through a raw feed at the same position:
    the batch, the state and the loss bit for bit; that step and
    DATA_TIMED - 1 more through the raw feed timed, and the raw feed's ms
    a batch; flickr_style's Solver.test."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.data.feed import build_feed
    t0 = time.perf_counter()
    test_iter = DATA_TEST_ITER if name == "flickr_style" else None
    s = data_solver(name, "cuda", files, test_iter=test_iter, prefetch=True)
    check(s.net.layers[0].type_name == FINETUNE_NETS[name][1],
          f"(c) {name} trains through {s.net.layers[0].type_name}")
    batch_n = s.net.blob_shapes["data"][0]
    prefetching, pulls, last = s.train_feed, [0], {}

    def counted():
        pulls[0] += 1
        last["prefetched"] = prefetching()
        return last["prefetched"]
    s.train_feed = counted
    s.step(1)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    times = []
    for _ in range(DATA_TIMED):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s.step(1)                       # ends in a host read of the loss
        times.append((time.perf_counter() - t1) * 1e3)
    launches = _launches()
    peak = torch.cuda.max_memory_allocated()
    b2, b1, b4 = DATA_PER_STEP[name]
    n = DATA_TIMED
    check(launches == _untiled(B2=b2 * n, B1=b1 * n, B4=b4 * n),
          f"(c) {name}: launches {launches} in {n} steps, expected B2a "
          f"{b2}, B1a {b1}, B4 {b4} a step")
    # one step from one state through both feeds, the first profiled
    torch.cuda.synchronize()
    before = _clone_tree((s.params, s.history, s.fault_state))
    it, position = s.iter, pulls[0]
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        s.step(1)
        torch.cuda.synchronize()
    busy = sum(ev.time_range.elapsed_us() for ev in prof.events()
               if ev.device_type == DeviceType.CUDA) / 1e3 or None
    got = _flat_tensors({"p": s.params, "h": s.history, "f": s.fault_state})
    loss_prefetch = float(s.last_loss)
    prefetching.close()                 # the raw feed's times run alone
    raw, feed_ms = build_feed(s.net, prefetch=False), []
    for _ in range(position):          # the batches already taken
        t1 = time.perf_counter()
        raw()
        feed_ms.append((time.perf_counter() - t1) * 1e3)
    s.params, s.history, s.fault_state = before
    s.iter = it
    s.train_feed = lambda: last.setdefault("raw", raw())
    raw_times = []
    for i in range(DATA_TIMED):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        s.step(1)
        raw_times.append((time.perf_counter() - t1) * 1e3)
        if i == 0:
            want = _flat_tensors({"p": s.params, "h": s.history,
                                  "f": s.fault_state})
            loss_raw = float(s.last_loss)
            s.train_feed = raw
    raw_ms = float(np.median(raw_times))
    apart = _leaves_differ(got, want) + _leaves_differ(
        last["prefetched"], {k: torch.from_numpy(v)
                             for k, v in last["raw"].items()})
    check(not apart and loss_prefetch == loss_raw,
          f"(c) {name}: the prefetching and the raw feed's steps part on "
          f"{apart[:5]} (losses {loss_prefetch}, {loss_raw})")
    check(math.isfinite(loss_prefetch), f"(c) {name}: loss {loss_prefetch}")
    out = {"batch": batch_n, "step_ms": times,
           "step_ms_median": float(np.median(times)),
           "raw_step_ms": raw_times, "raw_step_ms_median": raw_ms,
           "feed_ms_median": float(np.median(feed_ms)),
           "peak_bytes": int(peak), "launches": launches,
           "device_busy_ms": busy, "loss": loss_prefetch,
           "leaves_compared": len(want)}
    if test_iter:
        scores = s.test(0)
        check(all(math.isfinite(v) for v in scores.values()),
              f"(c) {name}: Solver.test gave {scores}")
        out["test"] = scores
    s.close()
    del s, before
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    print(f"phase 26: (c) {name} at batch {batch_n} through its "
          f"{FINETUNE_NETS[name][1]} layer, prefetching: step median "
          f"{out['step_ms_median']:.3f} ms ({[round(v, 3) for v in times]}, "
          f"host clock, synchronized); with the raw feed, median "
          f"{raw_ms:.3f} ms ({[round(v, 3) for v in raw_times]}), its "
          f"first step bit for bit with the prefetching step "
          f"(the batch, {len(want)} leaves and the loss); the raw feed "
          f"{out['feed_ms_median']:.3f} ms a batch ({len(feed_ms)} pulls); "
          f"the device busy {busy and round(busy, 3)} ms in the compared "
          f"step; peak memory {peak / 1e9:.2f} GB; launches a step B2a {b2}, B1a {b1}, B4 "
          f"{b4}; loss {loss_prefetch:.5f}"
          + (f"; Solver.test {json.dumps(out['test'])}" if test_iter
             else "") + f"; {gpu}", flush=True)
    return out


def data_leveldb(files):
    """(d) A LEVELDB Data layer (Caffe's default backend) against an LMDB
    of the same records: its prefetching feed's batches on the card equal
    the LMDB's, and its Solver takes two steps (B2a 1, B1a 1 a step)."""
    import torch
    from rram_caffe_simulation_tpu_torch import kernels, proto
    from rram_caffe_simulation_tpu_torch.data.feed import build_feed
    from rram_caffe_simulation_tpu_torch.net import Net
    from rram_caffe_simulation_tpu_torch.solver import Solver

    def net_text(source, backend):
        return (f'layer {{ name: "data" type: "Data" top: "data" '
                f'top: "label" transform_param {{ mirror: true crop_size: 28 '
                f"mean_value: 110 }} data_param {{ source: \"{source}\" "
                f"batch_size: 16 backend: {backend} }} }} "
                'layer { name: "ip" type: "InnerProduct" bottom: "data" '
                'top: "ip" inner_product_param { num_output: 10 '
                'weight_filler { type: "xavier" } } } '
                'layer { name: "loss" type: "SoftmaxWithLoss" bottom: "ip" '
                'bottom: "label" top: "loss" }')
    feeds = [build_feed(Net(proto.parse(net_text(files[k], b),
                                        "NetParameter"), proto.TRAIN),
                        device="cuda")
             for k, b in (("leveldb", "LEVELDB"), ("lmdb", "LMDB"))]
    pulls = DATA_RECORDS // 16 + 2             # past a wrap
    for _ in range(pulls):
        a, b = (f() for f in feeds)
        check(all(v.is_cuda and torch.equal(v, b[k]) for k, v in a.items()),
              "(d) the LevelDB's batches differ from the LMDB's")
    for f in feeds:
        f.close()
    text = (f"net_param {{ {net_text(files['leveldb'], 'LEVELDB')} }} "
            'base_lr: 0.01 lr_policy: "fixed" display: 0 random_seed: 5 '
            f'failure_pattern {{ type: "gaussian" mean: {ZOO_LIFE[0]} '
            f"std: {ZOO_LIFE[1]} }}")
    s = Solver(proto.parse(text, "SolverParameter"), hw_engine="cuda",
               dtype_policy="ternary", fault_format="packed",
               fused_epilogue=True)
    kernels.reset_launches()
    s.step(2)
    launches = _launches()
    loss = float(s.last_loss)
    check(launches == _untiled(B2=2, B1=2, B4=0) and math.isfinite(loss),
          f"(d) the LEVELDB Solver: launches {launches}, loss {loss}")
    s.close()
    print(f"phase 26: (d) a LEVELDB Data layer: {pulls} prefetched batches "
          f"on the card equal to the LMDB's of the same {DATA_RECORDS} "
          f"records (a wrap included); its Solver 2 steps, loss "
          f"{loss:.5f}, B2a 1 and B1a 1 a step", flush=True)
    return {"pulls": pulls, "records": DATA_RECORDS, "loss": loss,
            "launches": launches}


def phase_data_sources(gpu):
    """Phase 26: the data sources, under RRAM_POOL_BWD=cuda: (a) the
    stand-ins, (b) flickr_style, pascal and linreg card against CPU at
    batch 4, (c) the finetune Solvers at their published batches through
    the prefetching feed, (d) a LEVELDB Data layer."""
    import tempfile
    import torch
    t0 = time.perf_counter()
    out = {"gpu": gpu, "part_s": {}, "b": {}, "c": {}}
    saved = os.environ.get("RRAM_POOL_BWD")
    os.environ["RRAM_POOL_BWD"] = "cuda"
    try:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_data_") as tmp:
            t = time.perf_counter()
            files = data_standins(Path(tmp))
            out["part_s"]["a"] = time.perf_counter() - t
            print(f"phase 26: (a) stand-ins from seed {DATA_SEED}: "
                  f"{DATA_IMAGES} flickr_style PNGs, {DATA_VOC[0]} 3x375x500 "
                  f"PNGs with {DATA_VOC[1]} windows each, a 1x3x256x256 "
                  f"mean file, {DATA_RECORDS} Datums as a LevelDB and an "
                  f"LMDB, in {out['part_s']['a']:.1f} s", flush=True)
            t = time.perf_counter()
            for name in list(FINETUNE_NETS) + ["linreg"]:
                out["b"][name] = data_card_vs_cpu(name, files)
            out["part_s"]["b"] = time.perf_counter() - t
            t = time.perf_counter()
            for name in FINETUNE_NETS:
                out["c"][name] = data_timed(name, files, gpu)
            out["part_s"]["c"] = time.perf_counter() - t
            t = time.perf_counter()
            out["d"] = data_leveldb(files)
            out["part_s"]["d"] = time.perf_counter() - t
    finally:
        if saved is None:
            os.environ.pop("RRAM_POOL_BWD", None)
        else:
            os.environ["RRAM_POOL_BWD"] = saved
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t0
    print(f"phase 26: parts {json.dumps(out['part_s'])}", flush=True)
    return out

COLD_RUNS = ("precompile", "serial", "serial", "precompile")


def cold_start_child(mode, build_dir):
    """One cold start of phase 7's C = 512 sweep in this process, its
    kernels built into the empty `build_dir`: the runner built with
    `precompile_chunk` (mode "precompile": the decode on its thread
    beside nvcc and the kernels' load) or without it ("serial": nvcc
    and the load at the first launch), then two chunks; prints one JSON
    line."""
    import threading
    import torch
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.data import feed
    from rram_caffe_simulation_tpu_torch.parallel import SweepRunner
    from rram_caffe_simulation_tpu_torch.parallel import sweep as psweep
    check(mode in ("precompile", "serial"), f"unknown mode {mode!r}")
    kernels.BUILD_DIR = Path(build_dir)
    os.environ["RRAM_POOL_BWD"] = "cuda"
    threads = []

    def decode(layer):
        threads.append(threading.current_thread().name)
        return feed.materialize_data_source(layer)
    psweep.materialize_data_source = decode
    kernels.reset_launches()
    t0 = time.perf_counter()
    s = slice_solver(1e8, 3e7)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    r = SweepRunner(s, n_configs=SWEEP_CONFIGS, engine="cuda",
                    packed_state=True, dtype_policy="ternary",
                    precompile_chunk=SWEEP_CHUNK if mode == "precompile"
                    else 0)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    chunks = []
    for _ in range(2):
        t = time.perf_counter()
        losses, _ = r.step(SWEEP_CHUNK, chunk=SWEEP_CHUNK)
        torch.cuda.synchronize()
        chunks.append(time.perf_counter() - t)
        check(np.isfinite(np.asarray(losses)).all(),
              "cold start: a non-finite loss")
    rec = r.setup_record(setup_s=t2 - t0)
    launches = _launches()
    steps = 2 * SWEEP_CHUNK
    check(launches == _untiled(B2=2 * steps, B1=steps, B4=steps),
          f"cold start: launches {launches} in {steps} steps")
    r.close()
    print(json.dumps({"cold_start": {
        "mode": mode, "solver_s": t1 - t0, "runner_s": t2 - t1,
        "setup_s": t2 - t0, "first_chunk_s": chunks[0],
        "second_chunk_s": chunks[1],
        "to_first_chunk_s": t2 - t0 + chunks[0],
        "decode_seconds": rec["decode_seconds"],
        "compile_seconds": rec["compile_seconds"],
        "compile": rec["cache"]["compile"], "decode_threads": threads,
        "nvcc_builds": kernels.builds(),
        "load_ms": {lib.source.name: lib.load_seconds * 1e3
                    for lib in kernels.all_libraries()
                    if lib.load_seconds is not None},
        "launches": launches}}), flush=True)
    return 0


def cold_start(gpu):
    """`precompile_chunk`'s cold start against the serial order: each
    run of COLD_RUNS in a fresh process with an empty kernel build
    directory (under build/, removed after), one JSON line of them."""
    import shutil
    runs = []
    for i, mode in enumerate(COLD_RUNS):
        d = REPO / "build" / "cold_start" / str(i)
        shutil.rmtree(d, ignore_errors=True)
        try:
            proc = subprocess.run(
                [sys.executable, str(REPO / "chip_smoke.py"),
                 "--cold-start-child", mode, str(d)],
                capture_output=True, text=True, timeout=600)
        finally:
            shutil.rmtree(d, ignore_errors=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith('{"cold_start"')]
        check(proc.returncode == 0 and lines,
              f"cold start {i} ({mode}) failed, rc {proc.returncode}:\n"
              f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        runs.append(json.loads(lines[-1])["cold_start"])
        print(f"cold start {i}: {lines[-1]}", flush=True)
    print(json.dumps({"cold_start": runs, "gpu": gpu}), flush=True)
    return 0


def timed_checkout(path: str) -> int:
    """Run another checkout's chip_smoke.py in full, each of its phase_*
    functions timed, and print their wall seconds as one JSON line: the
    phase times of an older commit (which may not print its own) beside
    this one's, in one call."""
    import functools
    import importlib.util
    src = Path(path).resolve() / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_timed", src)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    took = {}

    def wrap(name, fn):
        @functools.wraps(fn)
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                took[name] = took.get(name, 0.0) + time.perf_counter() - t0
        return call
    for name in [n for n in dir(mod) if n.startswith("phase_")]:
        if callable(getattr(mod, name)):
            setattr(mod, name, wrap(name, getattr(mod, name)))
    t0 = time.perf_counter()
    rc = mod.main([])
    took["script"] = time.perf_counter() - t0
    print(json.dumps({"timed_checkout": {"path": str(src.parent), "rc": rc,
                                         **took}}), flush=True)
    return rc


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--steps", type=int, default=50,
                   help="training steps of the slice phase (default 50)")
    p.add_argument("--transition-steps", type=int, default=6)
    p.add_argument("--phases", default="all",
                   help="comma-separated phases 2-26 to run after the "
                        "build (default all; only a full run prints the "
                        "per-kernel line and the ok line)")
    p.add_argument("--b2-path", action="store_true",
                   help="after the build, only time the crossbar reads "
                        "through the wrapper on the path's layouts (C = 1 "
                        "and the sweep's C) and print them as JSON")
    p.add_argument("--b3-path", action="store_true",
                   help="after the build, only time the conv2 and conv3 "
                        "reads through the wrapper on the layer's layouts "
                        "(C = 1 and the tiled sweep's C), the kernel alone "
                        "and its passes, and print them as JSON")
    p.add_argument("--b4-path", action="store_true",
                   help="after the build, only time the max-pool backward "
                        "at pool1's sweep shapes (C = 512 and the tiled "
                        "sweep's C): through _MaxPool.backward, the kernel "
                        "alone (by device activity and by CUDA events), "
                        "autograd's backward and the bound, as JSON")
    p.add_argument("--b1-path", action="store_true",
                   help="after building B1 alone, only time the fused "
                        "epilogue at the sweeps' leaves (the untiled four "
                        "at C = 512, the tiled ten at C = 64) and both at "
                        "C = 1: through the solver's tail, alone, beside a "
                        "copy of the same bytes, as JSON")
    p.add_argument("--b2t-path", action="store_true",
                   help="after the build, only time the tiled ip1 read "
                        "through the wrapper on the path's layouts (C = 1 "
                        "and the tiled sweep's C), the kernel alone and "
                        "its tile heights, and print them as JSON")
    p.add_argument("--cold-start", action="store_true",
                   help="only time phase 7's C = 512 sweep from an empty "
                        "kernel build directory, with and without "
                        "precompile_chunk, each in a fresh process "
                        "(order precompile, serial, serial, precompile), "
                        "and print the runs as JSON")
    p.add_argument("--cold-start-child", nargs=2, metavar=("MODE", "DIR"),
                   help=argparse.SUPPRESS)
    p.add_argument("--timed-checkout", metavar="DIR",
                   help="only run DIR/chip_smoke.py (another checkout, "
                        "e.g. a parent commit unpacked with git archive) "
                        "in full, each of its phase functions timed, and "
                        "print their seconds as JSON")
    args = p.parse_args(argv)
    t_main = time.perf_counter()
    every = set(range(2, 27))
    want = every if args.phases == "all" else {
        int(v) for v in args.phases.split(",")}

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if args.timed_checkout:
        return timed_checkout(args.timed_checkout)
    if not (REPO / PKG).is_dir():
        print(f"chip_smoke: {PKG}/ not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    os.chdir(REPO)
    from rram_caffe_simulation_tpu_torch import kernels
    from rram_caffe_simulation_tpu_torch.device import resolve_device

    device = resolve_device("cuda")
    if args.cold_start_child:
        return cold_start_child(*args.cold_start_child)
    gpu = gpu_line()
    if args.cold_start:
        return cold_start(gpu)
    print(f"phase 1: {gpu}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    from rram_caffe_simulation_tpu_torch.fault import fused
    libs = [fused.FUSED_LIB] if args.b1_path else kernels.all_libraries()
    t = kernels.build_all(libs)
    for lib in libs:
        regs = [ln.strip() for ln in lib.ptxas_log.splitlines()
                if "registers" in ln or "spill" in ln]
        took = (f"in {lib.build_seconds:.1f} s" if lib.build_seconds
                is not None else "earlier (library found in the build dir)")
        print(f"phase 1: built {lib.source.name} {took}: "
              f"{' | '.join(regs)}", flush=True)
    print(f"phase 1: kernels built in {t:.1f} s (parallel nvcc)", flush=True)
    if args.b1_path:
        print(json.dumps({"b1_path": b1_path_numbers(device), "gpu": gpu}))
        return 0
    from rram_caffe_simulation_tpu_torch.fault import hw_aware
    print("phase 1: B2's GEMM pass, resident blocks per SM by tile rows: "
          + ", ".join(
              f"{bm}: {hw_aware.CROSSBAR_LIB.lib().rram_crossbar_blocks_per_sm(bm, 0)}"
              for bm in (128, 112, 32)), flush=True)

    if args.b2_path:
        print(json.dumps({"b2_path": {
            str(C): b2_path_numbers(device, C, own_kernels_only=False)
            for C in (1, SWEEP_CONFIGS)}, "gpu": gpu}))
        return 0
    if args.b2t_path:
        lanes = (1, TILED_SWEEP_CONFIGS)
        current = hasattr(hw_aware, "b2t_plan")      # else an older checkout
        res = {"b2t_path": {str(C): b2t_path_numbers(
            device, C, own_kernels_only=False) for C in lanes},
            "b2t_kernel": {str(C): tiled_step_numbers(
                device, ["ip1"], C, broken_byte=current)[0] for C in lanes}}
        if current:
            res["b2t_rows"] = b2t_row_numbers(device)
        print(json.dumps({**res, "gpu": gpu}))
        return 0
    if args.b3_path:
        lanes = (1, TILED_SWEEP_CONFIGS)
        current = hasattr(hw_aware, "b3_plan")       # else an older checkout
        res = {"b3_path": {str(C): b3_path_numbers(
            device, C, own_kernels_only=current) for C in lanes},
            "b3_kernel": {str(C): tiled_step_numbers(
                device, ["conv2", "conv3"], C, broken_byte=current)[0]
                for C in lanes}}
        if current:
            res["b3_passes"] = {str(C): b3_pass_numbers(device, C)
                                for C in lanes}
        print(json.dumps({**res, "gpu": gpu}))
        return 0
    if args.b4_path:
        from rram_caffe_simulation_tpu_torch.ops import pool_backward
        current = hasattr(pool_backward, "b4_plan")  # else an older checkout
        res = {}
        for C in (SWEEP_CONFIGS, TILED_SWEEP_CONFIGS):
            res[str(C)] = b4_step_numbers(device, C, ceiling=current)
            res[str(C)].update(b4_path_numbers(device, C, current))
        print(json.dumps({"b4_path": res, "gpu": gpu}))
        return 0
    phase_s = {}

    def timed(n, fn, *a):
        """Run phase n's function and print its wall seconds."""
        t0 = time.perf_counter()
        res = fn(*a)
        phase_s[n] = time.perf_counter() - t0
        print(f"phase {n}: done in {phase_s[n]:.1f} s", flush=True)
        return res
    if 2 in want:
        err_b1 = timed(2, phase_b1, device)
    if 3 in want:
        err_b2 = timed(3, phase_b2, device)
    if 4 in want:
        launches, step_s, breakdown = timed(4, phase_slice, args.steps, gpu)
    if 5 in want:
        drift = timed(5, lambda: (phase_transitions(args.transition_steps),
                                  phase_drift(args.transition_steps))[1])
    if 6 in want:
        err_b4, err_b4_auto = timed(6, phase_b4, device)
    if 7 in want:
        sweep = timed(7, phase_sweep, SWEEP_CONFIGS, SWEEP_STEPS, gpu)
    if 8 in want:
        timed(8, phase_sweep_checks, args.transition_steps)
    if 9 in want:
        err_tiled = timed(9, phase_tiled_kernels, device)
    if 10 in want:
        tiled = timed(10, phase_tiled_slice, args.steps, gpu)
    if 11 in want:
        tiled_sweep = timed(11, phase_tiled_sweep, TILED_SWEEP_CONFIGS,
                            SWEEP_STEPS, gpu)
    if 12 in want:
        timed(12, phase_strategies, gpu,
              step_s * 1e3 if 4 in want else None)
    if 13 in want:
        rng = timed(13, phase_rng, device, gpu,
                    step_s * 1e3 if 4 in want else None)
    if 14 in want:
        formats = timed(14, phase_formats, sweep["configs"] if 7 in want
                        else SWEEP_CONFIGS, gpu)
    if 15 in want:
        timed(15, phase_rest, device, gpu)
    if 16 in want:
        vgg = timed(16, phase_vgg, device, gpu)
    if 17 in want:
        telemetry = timed(17, phase_telemetry, gpu)
    if 18 in want:
        blocks = timed(18, phase_blocks, gpu,
                       tiled_sweep if 11 in want else None,
                       vgg["sweep"] if 16 in want else None)
    if 19 in want:
        healing = timed(19, phase_healing, gpu)
    if 20 in want:
        tightened = {}
        if 9 in want:
            tightened["phase9_exact_cases"] = err_tiled["exact_cases"]
        if 16 in want:
            reads = vgg["solver"]["tiled_reads"]
            tightened["phase16g_exact_reads"] = (reads["exact"]
                                                 + reads["exact_random"])
            tightened["phase16g_lockstep"] = {
                adc: {k: v[k] for k in ("loss_rel_max", "param_rel_max",
                                        "rounding_cells")}
                for adc, v in vgg["solver"]["tiled"].items()}
        virtual = timed(20, phase_virtual_time, gpu, tightened)
    if 21 in want:
        driver = timed(21, phase_driver, gpu)
    if 22 in want:
        processes = timed(22, phase_processes, gpu,
                          sweep if 7 in want else None)
    if 23 in want:
        harness = timed(23, phase_harness, gpu)
    if 24 in want:
        nets = timed(24, phase_nets, gpu)
    if 25 in want:
        zoo = timed(25, phase_zoo, gpu)
    if 26 in want:
        data_sources = timed(26, phase_data_sources, gpu)
    if want != every:
        print(f"phases {sorted(want)} passed; no ok line for a partial run",
              flush=True)
        return 0

    C = sweep["configs"]
    t_rows = time.perf_counter()
    print("per-step kernel numbers (ms on the card, summed over the "
          "step's launches):", flush=True)
    b2, _ = b2_step_numbers(device)
    b2.update(b2_path_numbers(device))
    b1, _ = b1_step_numbers(device, SLICE_LEAVES)
    b2b, err_b2b = b2_step_numbers(device, C)
    b2b.update(b2_path_numbers(device, C))
    b1b, err_b1b = b1_step_numbers(device, SLICE_LEAVES, C)
    b1t, err_b1t = b1_step_numbers(device, TILED_LEAVES,
                                   tiled_sweep["configs"])
    b4 = b4_step_numbers(device, C)
    b4.update(b4_path_numbers(device, C))
    b2t, err_b2t = tiled_step_numbers(device, ["ip1"])
    b2t.update(b2t_path_numbers(device))
    b2tc, err_b2tc = tiled_step_numbers(device, ["ip1"],
                                        tiled_sweep["configs"])
    b2tc.update(b2t_path_numbers(device, tiled_sweep["configs"]))
    b2t_rows = b2t_row_numbers(device)
    b3a, err_b3a = tiled_step_numbers(device, ["conv2", "conv3"])
    b3a.update(b3_path_numbers(device))
    b3b, err_b3b = tiled_step_numbers(device, ["conv2", "conv3"],
                                      tiled_sweep["configs"])
    b3b.update(b3_path_numbers(device, tiled_sweep["configs"]))
    b3_passes = {str(c): b3_pass_numbers(device, c)
                 for c in (1, tiled_sweep["configs"])}
    # phase 16's path: VGG11's three reads (sigma 0.05, no grid), its six
    # fault leaves and five 2x2 pools, one config and the sweep's C
    Cv = vgg["sweep"]["configs"]
    vl, vsl = vgg["solver"]["main_path_launches"], \
        vgg["sweep"]["main_path_launches"]
    vb2, err_vb2 = b2_step_numbers(device, 1, VGG_B2_SHAPES, 0, VGG_SIGMA)
    vb1, err_vb1 = b1_step_numbers(device, VGG_LEAVES)
    vb2b, err_vb2b = b2_step_numbers(device, Cv, VGG_B2_SHAPES, 0,
                                     VGG_SIGMA)
    vb1b, err_vb1b = b1_step_numbers(device, VGG_LEAVES, Cv)
    vb4 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": "bytes",
           "library_ms": 0.0, "max_abs_err": 0.0}
    for ch, h in VGG_POOLS:
        one = b4_step_numbers(device, Cv, planes=ch, hw=(h, h),
                              geometry=POOL2X2)
        vb4 = {k: (max(v, one[k]) if k == "max_abs_err" else v + one[k])
               if k != "bound_by" else v for k, v in vb4.items()}
    # (g)'s tiled reads, at the template's ADC
    vt = vgg["solver"]["tiled"]["adc8"]["launches"]
    vr = vgg["solver"]["tiled_reads"]["max_abs_err"]
    vb2t, err_vb2t = tiled_step_numbers(device, VGG_B2T_LAYERS,
                                        cases=VGG_TILED_CASES,
                                        sigma=VGG_SIGMA, q_bits=0)
    vb3a, err_vb3a = tiled_step_numbers(device, VGG_B3_LAYERS,
                                        cases=VGG_TILED_CASES,
                                        sigma=VGG_SIGMA, q_bits=0)
    sl = sweep["launches"]
    rows = [
        {"name": "crossbar_forward (B2a)", "route": "cuda",
         "source": f"{PKG}/csrc/crossbar.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/hw_aware.py:332",
         "launches": launches["B2"], "max_abs_err": err_b2, **b2},
        {"name": "fused_update_fail (B1a)", "route": "cuda",
         "source": f"{PKG}/csrc/fused_epilogue.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/fused.py:99",
         "launches": launches["B1"], "max_abs_err": err_b1, **b1},
        {"name": "crossbar_forward over C lanes (B2b)", "route": "cuda",
         "source": f"{PKG}/csrc/crossbar.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/hw_aware.py:477",
         "launches": sl["B2"], "max_abs_err": max(err_b2, err_b2b), **b2b},
        {"name": "fused_update_fail over C lanes (B1b)", "route": "cuda",
         "source": f"{PKG}/csrc/fused_epilogue.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/fused.py:118",
         "launches": sl["B1"], "max_abs_err": max(err_b1, err_b1b), **b1b},
        {"name": "fused_update_fail over C lanes, tiled leaves (B1b, tiled "
                 "sweep)", "route": "cuda",
         "source": f"{PKG}/csrc/fused_epilogue.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/fused.py:118",
         "launches": tiled_sweep["launches"]["B1"],
         "max_abs_err": max(err_b1, err_b1t), **b1t},
        {"name": "max_pool_backward (B4)", "route": "cuda",
         "source": f"{PKG}/csrc/pool_backward.cu",
         "replaces": "rram_caffe_simulation_tpu/ops/pool_backward.py:141",
         "launches": sl["B4"], **b4,
         "max_abs_err": max(err_b4, b4["max_abs_err"])},
        {"name": "crossbar_forward tiled (B2t)", "route": "cuda",
         "source": f"{PKG}/csrc/crossbar.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/hw_aware.py:318",
         "launches": tiled["launches"]["B2t"],
         "max_abs_err": max(err_tiled["B2t"], err_b2t), **b2t},
        {"name": "crossbar_forward tiled over C lanes (B2t, C > 1)",
         "route": "cuda", "source": f"{PKG}/csrc/crossbar.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/hw_aware.py:477",
         "launches": tiled_sweep["launches"]["B2t"],
         "max_abs_err": max(err_tiled["B2t"], err_b2tc), **b2tc},
        {"name": "crossbar_conv_forward implicit (B3a)", "route": "cuda",
         "source": f"{PKG}/csrc/crossbar.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/hw_aware.py:905",
         "launches": tiled["launches"]["B3"],
         "max_abs_err": max(err_tiled["B3a"], err_b3a), **b3a},
        {"name": "crossbar_conv_forward implicit over C lanes (B3b)",
         "route": "cuda", "source": f"{PKG}/csrc/crossbar.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/hw_aware.py:975",
         "launches": tiled_sweep["launches"]["B3"],
         "max_abs_err": max(err_tiled["B3b"], err_b3b), **b3b},
        {"name": "crossbar_forward (B2a), VGG11 fc1-3", "route": "cuda",
         "source": f"{PKG}/csrc/crossbar.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/hw_aware.py:332",
         "launches": vl["B2"], "max_abs_err": err_vb2, **vb2},
        {"name": "fused_update_fail (B1a), VGG11 fc1-3", "route": "cuda",
         "source": f"{PKG}/csrc/fused_epilogue.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/fused.py:99",
         "launches": vl["B1"], "max_abs_err": err_vb1, **vb1},
        {"name": "crossbar_forward over C lanes (B2b), VGG11 sweep",
         "route": "cuda", "source": f"{PKG}/csrc/crossbar.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/hw_aware.py:477",
         "launches": vsl["B2"], "max_abs_err": err_vb2b, **vb2b},
        {"name": "fused_update_fail over C lanes (B1b), VGG11 sweep",
         "route": "cuda", "source": f"{PKG}/csrc/fused_epilogue.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/fused.py:118",
         "launches": vsl["B1"], "max_abs_err": err_vb1b, **vb1b},
        {"name": "max_pool_backward (B4), VGG11 sweep's five 2x2 pools",
         "route": "cuda", "source": f"{PKG}/csrc/pool_backward.cu",
         "replaces": "rram_caffe_simulation_tpu/ops/pool_backward.py:141",
         "launches": vsl["B4"], **vb4},
        {"name": "crossbar_forward tiled (B2t), VGG11 fc1-3, conv_also",
         "route": "cuda", "source": f"{PKG}/csrc/crossbar.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/hw_aware.py:318",
         "launches": vt["B2t"], "max_abs_err": max(vr["B2t"], err_vb2t),
         **vb2t},
        {"name": "crossbar_conv_forward implicit (B3a), VGG11 conv2-8, "
                 "conv_also", "route": "cuda",
         "source": f"{PKG}/csrc/crossbar.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/hw_aware.py:905",
         "launches": vt["B3"], "max_abs_err": max(vr["B3a"], err_vb3a),
         **vb3a},
    ]
    # phase 24's path: cifar10_full's ip1 (1024 -> 10) and its two fault
    # leaves, one config (the Solver) and the sweep's C
    Cn = nets["b"]["sweep"]["configs"]
    na, nsl = nets["a"]["full"]["launches"], nets["b"]["sweep"]["launches"]
    nb2, err_nb2 = b2_step_numbers(device, 1, NETS_B2_SHAPES)
    nb2b, err_nb2b = b2_step_numbers(device, Cn, NETS_B2_SHAPES)
    nb1, err_nb1 = b1_step_numbers(device, NETS_LEAVES)
    nb1b, err_nb1b = b1_step_numbers(device, NETS_LEAVES, Cn)
    rows += [
        {"name": "crossbar_forward (B2a), cifar10_full ip1", "route": "cuda",
         "source": f"{PKG}/csrc/crossbar.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/hw_aware.py:332",
         "launches": na["B2"], "max_abs_err": err_nb2, **nb2},
        {"name": "fused_update_fail (B1a), cifar10_full ip1", "route": "cuda",
         "source": f"{PKG}/csrc/fused_epilogue.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/fused.py:99",
         "launches": na["B1"], "max_abs_err": err_nb1, **nb1},
        {"name": "crossbar_forward over C lanes (B2b), cifar10_full sweep",
         "route": "cuda", "source": f"{PKG}/csrc/crossbar.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/hw_aware.py:477",
         "launches": nsl["B2"], "max_abs_err": err_nb2b, **nb2b},
        {"name": "fused_update_fail over C lanes (B1b), cifar10_full sweep",
         "route": "cuda", "source": f"{PKG}/csrc/fused_epilogue.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/fused.py:118",
         "launches": nsl["B1"], "max_abs_err": err_nb1b, **nb1b},
    ]
    # phase 25's path: AlexNet's fc6-fc8 at batch 256 and their six
    # leaves (the Solver, and the sweep's C), its three 3x3 stride-2 MAX
    # pools over the sweep's lanes (the other nets' kernels: phase 25
    # (c)'s profile of their path)
    Cz = zoo["d"]["configs"]
    zc, zsl = zoo["c"], zoo["d"]["launches"]
    zb2, err_zb2 = b2_step_numbers(device, 1, ZOO_B2_SHAPES)
    zb1, err_zb1 = b1_step_numbers(device, ZOO_LEAVES)
    zb2b, err_zb2b = b2_step_numbers(device, Cz, ZOO_B2_SHAPES)
    zb1b, err_zb1b = b1_step_numbers(device, ZOO_LEAVES, Cz)
    zb4 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": "bytes",
           "library_ms": 0.0, "max_abs_err": 0.0}
    for ch, h in ZOO_POOLS:
        one = b4_step_numbers(device, Cz, planes=ch, hw=(h, h),
                              geometry=POOL3X3S2, batch=256)
        zb4 = {k: (max(v, one[k]) if k == "max_abs_err" else v + one[k])
               if k != "bound_by" else v for k, v in zb4.items()}
    rows += [
        {"name": "crossbar_forward (B2a), AlexNet fc6-8, batch 256",
         "route": "cuda", "source": f"{PKG}/csrc/crossbar.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/hw_aware.py:332",
         "launches": zc["alexnet"]["launches"]["B2"], "max_abs_err": err_zb2,
         **zb2},
        {"name": "fused_update_fail (B1a), AlexNet's six leaves",
         "route": "cuda", "source": f"{PKG}/csrc/fused_epilogue.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/fused.py:99",
         "launches": zc["alexnet"]["launches"]["B1"], "max_abs_err": err_zb1,
         **zb1},
        {"name": "crossbar_forward over C lanes (B2b), AlexNet sweep",
         "route": "cuda", "source": f"{PKG}/csrc/crossbar.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/hw_aware.py:477",
         "launches": zsl["B2"], "max_abs_err": err_zb2b, **zb2b},
        {"name": "fused_update_fail over C lanes (B1b), AlexNet sweep",
         "route": "cuda", "source": f"{PKG}/csrc/fused_epilogue.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/fused.py:118",
         "launches": zsl["B1"], "max_abs_err": err_zb1b, **zb1b},
        {"name": "max_pool_backward (B4), AlexNet sweep's three pools",
         "route": "cuda", "source": f"{PKG}/csrc/pool_backward.cu",
         "replaces": "rram_caffe_simulation_tpu/ops/pool_backward.py:141",
         "launches": zsl["B4"], **zb4},
    ]
    # phase 26's path: pascal's finetune net at batch 128 (fc6-fc8_pascal,
    # their six leaves, its three 3x3 stride-2 MAX pools), the launches of
    # its timed Solver steps
    dc = data_sources["c"]["pascal"]["launches"]
    db2, err_db2 = b2_step_numbers(device, 1, DATA_B2_SHAPES)
    db1, err_db1 = b1_step_numbers(device, DATA_LEAVES)
    db4 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "bound_by": "bytes",
           "library_ms": 0.0, "max_abs_err": 0.0}
    for ch, h in ZOO_POOLS:
        one = b4_step_numbers(device, 1, planes=ch, hw=(h, h),
                              geometry=POOL3X3S2, batch=128)
        db4 = {k: (max(v, one[k]) if k == "max_abs_err" else v + one[k])
               if k != "bound_by" else v for k, v in db4.items()}
    rows += [
        {"name": "crossbar_forward (B2a), pascal fc6-8, batch 128",
         "route": "cuda", "source": f"{PKG}/csrc/crossbar.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/hw_aware.py:332",
         "launches": dc["B2"], "max_abs_err": err_db2, **db2},
        {"name": "fused_update_fail (B1a), pascal's six leaves",
         "route": "cuda", "source": f"{PKG}/csrc/fused_epilogue.cu",
         "replaces": "rram_caffe_simulation_tpu/fault/fused.py:99",
         "launches": dc["B1"], "max_abs_err": err_db1, **db1},
        {"name": "max_pool_backward (B4), pascal's three pools, batch 128",
         "route": "cuda", "source": f"{PKG}/csrc/pool_backward.cu",
         "replaces": "rram_caffe_simulation_tpu/ops/pool_backward.py:141",
         "launches": dc["B4"], **db4},
    ]
    # phase 22's path: B1 in the modes of read_disturb ("always") and
    # permanent_fault_map ("never"), on the steps' own tails
    for key, row in sorted(processes["b1_rows"].items()):
        name, mode = key.split()
        lanes = name == "B1b"
        rows.append({
            "name": f"fused_update_fail{' over C lanes' if lanes else ''} "
                    f"({name}), mode {mode!r} "
                    f"({'read_disturb' if mode == 'always' else 'permanent_fault_map'})",
            "route": "cuda", "source": f"{PKG}/csrc/fused_epilogue.cu",
            "replaces": "rram_caffe_simulation_tpu/fault/fused.py:"
                        + ("118" if lanes else "99"),
            **{k: v for k, v in row.items() if k != "mode"}})
    print(json.dumps({"step": {"median_ms": step_s * 1e3,
                               "prefetch_step_ms":
                                   breakdown["prefetch_step_ms"],
                               "feed_ms": breakdown["feed_ms"],
                               "device_busy_ms":
                                   breakdown["device_busy_ms"]},
                      "drift": drift,
                      "b4_vs_autograd_max_abs_err": err_b4_auto}))
    print(json.dumps({"sweep": sweep}))
    print(json.dumps({"tiled_step": tiled}))
    print(json.dumps({"tiled_sweep": tiled_sweep}))
    print(json.dumps({"b2t_rows": b2t_rows}))
    print(json.dumps({"b3_passes": b3_passes}))
    print(json.dumps({"rng": rng}))
    print(json.dumps({"formats": formats}))
    print(json.dumps({"vgg11": vgg}))
    print(json.dumps({"telemetry": telemetry}))
    print(json.dumps({"blocks": blocks}))
    print(json.dumps({"healing": healing}))
    print(json.dumps({"virtual_time": virtual}))
    print(json.dumps({"driver": driver}))
    print(json.dumps({"processes": processes}))
    print(json.dumps({"harness": harness}))
    print(json.dumps({"nets": nets}))
    print(json.dumps({"zoo": zoo}))
    print(json.dumps({"data_sources": data_sources}))
    print(json.dumps({"phase_s": {**{str(n): v for n, v in phase_s.items()},
                                  "kernels_line": time.perf_counter() - t_rows,
                                  "script": time.perf_counter() - t_main}}))
    print(json.dumps({"kernels": rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
