#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one GPU and check them.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  0. card: require CUDA; print the nvidia-smi name and power limit.
  1. build: compile every CUDA kernel of svbfm_tpu_torch, one nvcc per
     source, all started together.
  2. kernels: each kernel against its plain PyTorch twin on the card, at the
     shapes the paths give it (ML-1M, K=20; batch VB fast mode, exact mode
     at F=1 with the w patch, an online-VB chunk of 1/20 of the rows at
     F=1 with K6 on each of its bins in one launch, K5 in each of its
     four modes on each bin in one launch, its lanes a column printed
     beside each bucket, Gibbs/ALS blocks at
     F=20 and F=1 in both draw modes, the gather probe's shapes, the SGD
     family's batches in each step mode (classification and Poisson
     too; SGDA's lambda step also in its classification mode), X12a in
     its three modes on the train rows and X12b on the test rows (VB's
     eval and Gibbs's), and X9b also on a table of
     ML-10M's width, the full-batch exp_sgd's w and v steps at F=20 and
     F=1 (X8a at F=1 in both modes on every degree bucket, its lanes a
     column and load width printed beside each), the block-structure
     sampler's relation kernels on the 1M-rating relational recipe at
     F=20, F=1 and the w sweep (X10a also at F=33, its block form), X10a's,
     X10c's and the resync's forms printed beside each, the joined scores
     on the train and the test rows and over nine relations, with their
     form (K1a's kernel in its relations mode), K2 and X8d with theirs,
     X9c also cut to the 8 blocks it falls back to where the card holds
     no cluster of 16) and on small ragged cases with
     NaN-producing columns or targets, Inf noise, L=1 buckets and columns
     split over blocks, K5 on bins of L = 1-512 with an empty bucket and
     on one of 40 buckets, P1 on index counts that are not a multiple of
     4 and on bases one element past a 16-byte boundary, X13a and X13b
     (K3's and K5's window-accumulating modes) over the 4 windows of the
     windowed batch VB at F = 4 and on small ragged windows, X14a and X14b
     (X8a's and X8c's) over the 4 windows of the windowed Gibbs at F = 4
     and F = 1 and on small ragged windows (NaN sums, NaN lambdas, Inf
     noise, L = 1, an empty bucket), X8a's exact mode and K3 at F = 4 on
     every bucket of the sweep (the resident factor_block-4 shapes, which
     take the windowed paths' lanes forms), their forms printed; time
     each, and
     one PyTorch call where one computes the same function.  Then x9b-digest: sha256 of X9b's outputs on
     seeded inputs.
  2b. serve: the serving path, BatchScorer on K1a's serve epilogue
     (fm_serve, also in the kernel phase in its three modes, at the
     path's batch and on rows and tables with NaN and +-Inf) at
     scripts/bench_serve.py's shape: 10M one-hot rows, K=20, batches of
     2^20, two in flight, host arrays to host predictions (fm_serve
     launched; finite, in [1, 5], the first and last 200k rows against
     the CPU twin's); the same rows in 4,096-row batches through a window
     of two equal to one-shot scoring bit for bit; the probit scorer
     against the twin; end-to-end and device-resident (8 distinct batches
     on the card, one fetch at the end) rows/s, a slot's host fill and a
     batch's copy to the card timed alone.
  3. vb-fast: batch VBFM (fast mode) init + 10 sweeps through VBLearner;
     every kernel of the path must have been launched; the free energy must
     not fall and the test RMSE must drop.
  4. gpu-vs-cpu: 3 fast-mode sweeps from one host-made init on the card
     (kernels) and on the CPU (twins); the trajectories must agree.
  5. quality: test RMSE and free energy after 30 fast-mode sweeps, printed
     beside the JAX package's record on the same recipe (information).
  6. profile: device time per fast-mode sweep by kernel (torch.profiler).
  7. vb-exact: batch VBFM with factor_block=1 (the reference's order),
     5 sweeps: kernels launched, free energy non-decreasing, RMSE falling;
     then one sweep under the profiler, its device time printed beside
     sec/iter.
  8. vb-exact gpu-vs-cpu: 2 exact-mode sweeps at full size from one
     host-made init on the card and on the CPU; the trajectories must agree.
  8b. the feature-sharded batch VB (T1-T4; the kernel phase also holds
     them to their twins at Sf = 2 and 1 and the Sf = 2 partials, summed,
     to K1a, K1b, K2 and K4): group-sum (X6, group_sum beside
     index_add_), tp-vb (TPVBLearner on NCCL with a world of one at
     ML-1M's width, K = 20, 5 sweeps beside the resident fast VB from one
     init, within 1e-4; sec/iter and device time a sweep beside the
     resident's), tp-vb-k0 (K = 0, 2 sweeps: T3's w form) and
     tp-vb-ranks (four gloo ranks on the one card, a (2, 2) mesh, the
     100k-row recipe at K = 8, 3 sweeps beside the resident VB on the
     card; a rank's failure fails the phase).
   8d. the data-parallel replicated learners (VBLearner, MCMCLearner and
     ALSLearner with mesh=: T2-T4 for a VB block, T3 at K = 0 for the
     standalone w sweep, T3's w stats, T5 and T7 for Gibbs/ALS, at lo = 0
     and D_loc = D around the data all-reduce; the kernel phase also
     holds T3 and T7 at F = 1 and 4 on every bucket of the resident plan
     and T3 at K = 0 and T5 on every bin to their twins): dp-vb,
     dp-vb-exact (factor_block 1) and dp-vb-class (-task c, factor_block
     1) on NCCL with a world of one at ML-1M's width, K = 20, beside the
     resident VB from one init; dp-als, dp-mcmc, dp-mcmc-seq
     (factor_block 1) and dp-mcmc-class beside the resident learner under
     one host-table draw source each; every trajectory within 1e-5, a
     sweep's device time and sec/iter beside the resident's; then
     dp-vb-ranks and dp-mcmc-ranks (four gloo ranks on the one card, the
     100k-row recipe at K = 8, 2-3 sweeps each of VB fast and exact mode,
     ALS and Gibbs, within 1e-5 of the world of one).
 9. ovb: online VBFM, 20 chunks of fixed membership, 5 epochs: kernels
     launched, RMSE falling; sec/epoch and peak memory.
  9b. the feature-sharded online VB (T9 and T10 with T1, T2 at F = 1 and
     T4 at F = 1 and 0; the kernel phase holds them to their twins on
     every bin of chunk 0 at Sf = 1 and 2): tp-ovb (TPOVBLearner on NCCL
     with a world of one at ML-1M's width, K = 20, 20 chunks, as many
     epochs as ovb from the same init, the trajectory and the ten tables
     within 1e-5 of ovb's; card against CPU on the 100k-row recipe;
     sec/epoch beside ovb's), tp-ovb-profile (an epoch's device time,
     busy share and ops; tp-ovb-device, after ovb-profile, sets them
     beside the resident's) and tp-ovb-ranks (four gloo ranks on the
     card, a (2, 2) mesh, the 100k-row recipe at K = 8, 5 chunks, 2
     epochs, within 1e-4 of the world of one).
 10. ovb gpu-vs-cpu: 2 epochs of the 100k-row recipe from one host-made
     init on the card and on the CPU; the trajectories must agree.
 11. ovb quality: -reshuffle 1, 20 chunks, 10 epochs (not 30, to keep
     the run's time); test RMSE at epoch 10 beside the reference C++
     run's (information).
 12. cli (twelve child processes started together): python -m
     svbfm_tpu_torch.cli -method vb_online, -method sgd,
     -method exp_sgd and -method als -relation items, and -task c with
     -method mcmc and -method sgd (-out must hold probabilities), -device
     cuda on small libFM files, and on binary files vb_online,
     sgd_online and -cache_size with vb, mcmc and als (4 windows),
     mcmc -num_eval_cases; each must exit 0 and write its files.  Three
     of them also check a flag (aux-cli): vb_online -rlog (the
     reference's header, a row an iteration), sgd -profile (a Chrome
     trace that names K1a's kernel), mcmc -task c -map_eval (MAP@5 on
     every #Iter line and the final one).
 13. ovb-profile: device time of one online-VB epoch by kernel, K5's
     (w_bin_kernel) apart; tp-ovb-device: the feature-sharded epoch's
     (9b) beside it.
 14. mcmc: Gibbs MCMC, factor_block=0 (F=20), 10 iterations from the
     default device generator: kernels launched, no NaN/Inf counts,
     posterior-mean RMSE falling; sec/iter and peak memory.
 15. mcmc gpu-vs-cpu: 2 Gibbs sweeps at full size from one host-made init
     and one host-table draw source, on the card and on the CPU.
 16. als: ALS (-regular 5) at factor_block=1 and 0, 5 iterations each:
     kernels launched, test RMSE of the last state falling; then
     mcmc-seq-profile: device time of one Gibbs sweep at factor_block=1
     by kernel, X8a's (col_draw) and X8b's (row_patch) apart; then 2
     ALS sweeps at F=1, card against CPU.
 17. mcmc-quality: 30 Gibbs iterations; the posterior-mean test RMSE at
     iterations 10 and 30 beside the reference C++'s (information).
 18. mcmc-profile: device time per Gibbs sweep by kernel, X8a's and
     X8b's apart.
 19. gather-probe: ns per index of a 1-D gather of 2M indices from a 4 MB
     table (the kernel and torch.take), the lane-local [S,128] form and
     the depth sweep 8/32/1024 (the counterpart of
     scripts/pallas_gather_probe.py).
 19b. ckpt-resume: batch VB (fast mode), Gibbs (the generator on the
     card), OVB and SGD: 2 sweeps saved by utils/checkpoint.py, a resume
     and 2 more against 4 uninterrupted: every state tensor and metric
     equal bit for bit (SGD, whose X9a adds with float atomics so that two
     uninterrupted runs differ too: within the GPU-vs-CPU bounds).
 20. sgd: minibatch SGD (batch 1024, 976 batches an epoch), 5 epochs:
     X9a, X9b and K1 launched, test RMSE falling; sec/epoch, the host's
     enqueue time and the device's wait after it, peak memory.
 21. sgd gpu-vs-cpu: one full epoch from one host-made init and host-drawn
     permutation on the card and on the CPU.
 22. sgd-online: 50 chunks of the in-memory train set, 3 epochs.
 23. exp-sgd-stoc: 3 epochs of the exponential-family multiplier.
 24. sgda: a 90/10 train/validation split of the train rows, 5 iterations:
     X9c launched, the regs finite and >= 0.
 25. bpr: the 4-5 star rows as positives, learn rate 0.01, 5 epochs: the
     pair accuracy rises, above the init's too, and the pair loss falls.
 26. sgd-quality: SGD test RMSE at epochs 1/10/30 and SGDA (dim 1,1,8,
     learn rate 0.01) at iterations 1-20 beside the reference C++'s
     (information).
 27. sgd-profile: device time of one SGD epoch by kernel; sgda-profile:
     of one SGDA iteration with its lambda steps, and X9c's share.
 27b. the feature-sharded SGD and serving over a mesh (T11, X9a's window
     mode, and T12, the sharded finalize with the serve epilogue; the
     kernel phase holds T11 at every loss to its twin on 1,024 train rows
     with padding entries and valid = 0 rows, at Sf = 1 and on both
     windows of Sf = 2, X9b's dense form on each window, and T12 on
     [serve]'s partials, summed over two shards, and on NaN/+-Inf
     scores): tp-sgd (TPSGDLearner on NCCL with a world of one at
     [sgd]'s width and batch, [sgd]'s epochs from the same init and
     permutations, the RMSE within 2e-4 of [sgd]'s; card against CPU on
     the 100k-row recipe; sec/epoch beside [sgd]'s), tp-sgd-profile and
     tp-sgd-device (an epoch's device time beside [sgd-profile]'s),
     serve-mesh (BatchScorer over the world of one at [serve]'s shape:
     replicated the same bits as [serve]'s predictions, feature-sharded
     within 1e-6 relative; rows/s beside [serve]'s), tp-sgd-ranks (four
     gloo ranks on the card: (1, 4) within 1e-4 of the world of one on
     the 100k-row recipe at K = 8, 2 epochs; (2, 2) beside (2, 1) on two
     more ranks) and serve-mesh-ranks (the scorer over the four ranks,
     replicated and feature-sharded, clamp and probit, on 100,003 of
     [serve]'s rows beside the one-card scorer).
 28. exp-sgd: the full-batch exponential-family sweep (-method exp_sgd,
     learn rate 0.5), factor_block 0, 5 sweeps: X9d's two modes, X8b, X8d,
     the w patch and K1 launched, test RMSE falling; sec/iter, peak memory.
 29. exp-sgd gpu-vs-cpu: 2 sweeps from one host-made init, card and CPU.
 30. bs-mcmc: block-structure Gibbs on the relational recipe
     (scripts/bench_bs.py: 1M ratings, K=20, 20+20 attribute slots, 42
     joined entries a row that are never materialised), F=K, 5 iterations:
     X10a-X10d launched, no NaN/Inf counts, RMSE falling; sec/iter, peak
     memory, the main row layout's width beside the join's.
 31. bs-als: the same with ALS, 5 iterations; then bs-seq, Gibbs at
     factor_block=1 (the factor-sequential path), 2 iterations, and one
     more under the profiler, its device time beside sec/iter.
 32. bs-gpu-vs-cpu: 2 Gibbs sweeps of the 100k-row recipe (4+4 slots, K=8)
     from one host-made init and host-table draw source, card and CPU;
     bs-nine-gpu-vs-cpu: the same, 3 sweeps, on the small relational
     problem with nine relations (the port takes any number).
 33. bs-quality: the PARITY_RUNS.md:166-183 recipe, 30 iterations of
     Gibbs and of ALS (-regular 10), beside the reference C++ (information).
 34. bs-profile: device time of one blocked BS Gibbs sweep by kernel
     (bs-profile and bs-seq-profile also give X10a's, X10c's, the
     resync's and the moments').
 34b. the data-parallel block structure and online VB on NCCL with a
     world of one (the kernel phase holds T13 at F = 1, 4, 20 on every bin
     of OVB chunk 0, on one data shard and on two summed against K6's
     twin, T10 on each shard, and X10a on two join slices of each
     relation at F = 0, 1, 20, 33, each slice against its twin and the
     two summed against one launch on the whole plan): dp-bs (Gibbs at
     F = K beside bs-mcmc's resident learner, 2 sweeps from one init and
     one host-table draw source, and its device time beside the
     resident's), dp-bs-seq (factor_block 1, the same), dp-bs-als,
     dp-bs-class (the recipe binarised at its median), dp-bs-main (the
     100k-row recipe with the items as one-hot main-block columns, so the
     main block's split forms run: T3's w stats, T5, T7); dp-ovb (ML-1M,
     K = 20, 20 chunks, 2 epochs beside the resident OVB from one init:
     factor_block 1 with an epoch's device time, 4, and 1 with
     -reshuffle), dp-ovb-class, dp-ovb-stream (the train rows as a binary
     file, streamed); trajectories and OVB's tables within 1e-5; then
     dp-bs-ranks and dp-ovb-ranks (four gloo ranks on the card, the
     100k-row recipes at K = 8: BS Gibbs (items in the main block) and
     ALS, OVB at factor_block 1 and 4, 2 sweeps or epochs, beside the
     world of one); dp-slice-total: these phases' seconds together.
 35. classification (-task c) on ML-1M with its targets binarised at 3.5:
     vb-class (10 exact-mode sweeps; vb-class-fast, 5 fast-mode sweeps,
     prints where its free energy turns NaN, as the JAX package's does on
     this recipe), mcmc-class (10 Gibbs iterations from
     the device generator), als-class (3), ovb-class (3 epochs), bs-class
     (3 BS Gibbs iterations on the relational recipe binarised at its
     median), sgd-class, sgda-class and sgd-poisson (the Poisson task on
     the stars above 3 as counts), 3 epochs each: X12a and X12b launched
     where the path runs them, the test accuracy above 0.5 and not
     falling; each path's device time under the profiler; VB (3 exact
     sweeps) and Gibbs (2, host-table draws) card against CPU;
     class-quality:
     Gibbs and VB at dim 1,1,8 on the 100k-row recipe beside the
     reference C++'s accuracies (information).
 36. binary: the ML-1M recipe written as the reference's binary .x/.y and
     read back (the arrays must equal the text's), each timed, and the
     chunk reader's index scan.
 37. ovb-stream: OVB with the 20 chunks streamed from that file, 5 epochs,
     sec/epoch and peak memory beside [ovb]'s, then one epoch under the
     profiler (its device busy share and the copies' share).
 38. ovb-stream-gpu-vs-cpu: the 100k-row recipe streamed, 2 epochs.
 39. sgd-online-stream: sgd_online's 50 chunks streamed, 3 epochs, and one
     epoch card against CPU from one host-made init and draw source.
 40. num-eval: VB and Gibbs at -num_eval_cases 50,000 of the 99,978 test
     rows: nec rmse^2 + (N - nec) rmse_test2^2 = N rmse^2 of the unsplit
     run of the same sweep.
 41. vb-windowed (a child process, the card's memory its own): batch VB,
     factor_block 4, the rows in 4 windows (-cache_size 8,388,608), 5
     sweeps beside resident exact VB at factor_block 4 from the same init
     (trajectory within 2e-4, sec/iter, peak memory, which must be lower),
     a profiled sweep (X13a's, X13b's and the copies' shares), and
     vb-windowed-gpu-vs-cpu on the 100k-row recipe, 2 sweeps; then
     mcmc-windowed and als-windowed: Gibbs and ALS (-regular 5) on the same
     4 windows at factor_block 4, 5 iterations each from one host-table
     draw source beside the resident learner at factor_block 4 (trajectory
     within 5e-4, alpha 5e-3, sec/iter, launches a sweep, peak memory,
     which must be lower), Gibbs' profiled sweep (X14a's, X14b's and the
     copies' shares), and mcmc-windowed-gpu-vs-cpu on the 100k-row recipe,
     2 sweeps.
 42. ovb-stream-10m (the same child): OVB on 10M rows of ML-10M's shape
     (71,567 x 10,681) streamed in 100 chunks, 1 epoch: sec/epoch, peak
     memory beside the bytes the train rows would take resident, which it
     must stay below.
Then the nvidia-smi line again, a JSON line with each kernel's launches
(summed over the driven runs of phases 2b, 3, 7, 8b, 9, 14, 16, 19, 20-25,
27b (tp-sgd, serve-mesh), 28,
30-32, 34b, 35, 37, 39, 41 (with mcmc-windowed and als-windowed) and 42,
each
read just after its run with the
counts zeroed just before),
error, times and bound, and as the last line {"ok": true, "device": {...}}.

Imports only svbfm_tpu_torch, torch and numpy: never JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 7
K = 20
NUM_USERS, NUM_ITEMS, NUM_TRAIN = 6040, 3952, 1_000_000
OVB_CHUNKS = 20
# kernel vs twin: max |kernel - twin| <= KERNEL_TOL * max(1, max |twin|)
# where the twin is finite, and the same NaN/Inf pattern where it is not;
# float32 sums of at most a few hundred terms, taken in another order
KERNEL_TOL = 1e-4
# GPU (kernels) vs CPU (twins) trajectories over 3 fast-mode sweeps,
# relative: the H100 measured 1.2e-7 at most (float32, other summation
# orders, atomics in index_add_); 1e-5 leaves a wide margin and still
# catches a wrong sum.  Exact mode (2 sweeps) is held to the same bound.
TRAJ_RTOL = 1e-5
# the same for online VB over 2 epochs of the 100k-row recipe: the H100
# measured 9.4e-8 at most, so the same margin holds
OVB_TRAJ_RTOL = 1e-5
# the JAX package's record on this recipe, measured on a TPU v5e
# (BENCH_r05.json); quality numbers, not speed
JAX_RMSE_30, JAX_FE_30 = 0.68206, -1093193.6
# the reference C++ OVBFM on this recipe, -reshuffle 1, 20 chunks
# (PARITY_RUNS.md:130): test RMSE by epoch; other init draws
REF_OVB_RMSE = {10: 0.7012, 30: 0.6852}
OVB_QUALITY_EPOCHS = 10
# the reference C++ MCMC on this recipe (PARITY_RUNS.md:11,15): posterior-
# mean test RMSE by iteration; other draws
REF_MCMC_RMSE = {10: 0.7377, 30: 0.7361}
# ALS's -regular: unregularised ALS overfits this data (the test RMSE of
# the 100k-row recipe rises over 5 sweeps at 0.1 and 1, falls at 5)
ALS_REG = 5.0
# SGD, GPU (kernels) vs CPU (twins) over one full epoch (976 steps) from
# one host-made init and one host-drawn permutation: relative on the test
# RMSE and MAE, and absolute on the parameter table.  The H100 measured
# 1.2e-8 relative and 4.2e-7 absolute at most (float atomics add each
# batch's gradients in another order than index_add_); the sweeps' 1e-5
# leaves a wide margin on both and still catches a wrong step.
SGD_TRAJ_RTOL = 1e-5
SGD_PARAM_ATOL = 1e-5
# the reference C++ SGD on this recipe (PARITY_RUNS.md:5-15, its flags not
# recorded): test RMSE by epoch
REF_SGD_RMSE = {1: 0.7673, 10: 0.7375, 30: 0.7422}
# the reference C++ SGDA (PARITY_RUNS.md:66-80): dim 1,1,8, -learn_rate
# 0.01, a 90/10 train/validation split of the train rows, test RMSE by
# iteration
SGDA_LR, SGDA_K = 0.01, 8
REF_SGDA_RMSE = {1: 0.7422, 5: 0.7424, 10: 0.7411, 15: 0.7253, 20: 0.7119}
SGD_ONLINE_CHUNKS = 50
# ML-10M's feature count (bench.py:190: 71,567 users + 10,681 items): X9b
# is timed on a table this wide too
ML10M_FEATURES = 82_248
# full-batch exp_sgd: a step divides the gradient by N, so only w0's step
# (lr times the mean residual) is large; at 0.5, test_exp_sgd.py's rate, the
# test RMSE falls over the first sweeps, and w0 converges (lr < 2)
EXP_SGD_LR = 0.5
# relations in the nine-relation bs_scores case and in the small learner
# driven on the card against the CPU: any number must work
NINE_RELATIONS = 9
# the relational recipe (scripts/bench_bs.py:52-74 and :97-99): 1M ratings,
# 20 attribute slots a user and an item row, -regular-style regs 0.05
BS_ROWS, BS_SLOTS, BS_REG = 1_000_000, 20, 0.05
# X10a is also timed past the widths of its warp form (F <= 32), in its
# block form, on the same join plans
BS_AGG_BLOCK_F = 33
# and held against its twin across its block form's widths, on each join
# plan cut to its first BS_AGG_CHECK_COLS relation rows a bucket, with no
# poison, a NaN e and an Inf q at the pad row, two launches the same bits
BS_AGG_CHECK_F = (33, 64, 251)
BS_AGG_CHECK_COLS = 128
# the [bs-k64] phase: BS Gibbs on the relational recipe at -dim 1,1,64 (F =
# 64 at factor_block 0: X10a's block form twice a sweep)
BS_K64 = 64
# X10a's twin is run on column chunks of at most this many channel floats
# past F = 32 (its [CH, C, L] stack is 12 GB on the items' plan at F = 64)
BS_TWIN_FLOATS = 1 << 28
# the reference C++ on the PARITY_RUNS.md:166-183 recipe (100k rows, 4+4
# slots, the first 10% held out, dim 1,1,8): MCMC posterior-mean and ALS
# (-regular 10) test RMSE by iteration; other draws and inits
BS_Q_ROWS, BS_Q_SLOTS, BS_Q_K, BS_Q_ALS_REG = 100_000, 4, 8, 10.0
REF_BS_MCMC_RMSE = {1: 0.7747, 10: 0.6887, 30: 0.6586}
REF_BS_ALS_RMSE = {1: 0.6562, 10: 0.6618, 30: 0.7184}
# BPR's positives: the ratings of 4 and 5 stars; its learn rate: at the
# CLI's 0.1 the pair accuracy on this data (items drawn uniformly) peaks
# after the first epoch and falls, at 0.01 it rises over 5 epochs (both
# measured on the H100)
BPR_MIN_RATING, BPR_LR = 4.0, 0.01
# classification: the ratings binarised at 3.5 (PARITY_RUNS.md:84), and the
# reference C++'s test accuracy (MCMC posterior mean, VB) and VB's Test(ll)
# on the 100k-row recipe at dim 1,1,8 (PARITY_RUNS.md:90-96), by iteration;
# other draws and inits
CLASS_THRESHOLD = 3.5
CLASS_Q_ROWS, CLASS_Q_K = 100_000, 8
REF_CLASS_MCMC_ACC = {10: 0.6249, 20: 0.6392}
REF_CLASS_VB_ACC = {10: 0.6435, 15: 0.6421}
REF_CLASS_VB_LL = {10: 0.4601, 15: 0.5767}
# out of core: the windowed batch VB's device budget (-cache_size) on the
# ML-1M rows, 2 x 8 x 2,000,044 bytes of nnz over 8 MiB -> 4 windows of
# 250,880 rows, and its trajectory held to resident exact VB at the JAX
# test's own bound (test_vb_windowed.py:53-58: the window axis splits each
# column's sum); ML-10M's shape (bench.py:190) streamed in 100 chunks;
# -num_eval_cases on half the test rows, the split identity to float32
# rounding of sums of 10^5 squares
WIN_CACHE_BYTES, WIN_SHAPE, WIN_TRAJ_RTOL = 8_388_608, (4, 250_880), 2e-4
# the feature-sharded VB against the resident fast-mode VB: the CPU tests'
# rtol on RMSE, free energy and alpha (tests/test_tp.py:69-80); its ranks
# phase: four gloo ranks on a (2, 2) mesh on the one card, the 100k-row
# recipe at K = 8, 3 sweeps, within RANKS_TIMEOUT seconds
TP_RTOL = 1e-4
TP_RANKS, TP_RANKS_ROWS, TP_RANKS_K, TP_RANKS_SWEEPS = 4, 100_000, 8, 3
# [tp-ovb-ranks]: the same four ranks and recipe, 5 chunks, 2 epochs (the
# ranks' gloo collectives, some 70 a chunk, set its time)
TP_OVB_RANKS_CHUNKS, TP_OVB_RANKS_EPOCHS = 5, 2
TP_RANKS_TIMEOUT = 240
# [tp-sgd]: the feature-sharded SGD beside the resident [sgd] from one init
# and the same permutations (tests/test_tp_sgd.py:52-54's bound); its ranks
# phase: the 100k-row recipe at K = 8, 2 epochs
TP_SGD_RTOL, TP_SGD_ATOL, TP_SGD_RANKS_EPOCHS = 2e-4, 2e-5, 2
# [serve-mesh]: the feature-sharded scorer beside the one-card scorer (T12
# squares after the sum, K1a in its chunks), and its four gloo ranks' rows
SERVE_MESH_RTOL, SERVE_MESH_RANK_ROWS = 1e-6, 100_003
# the data-parallel replicated learners: T3 and T7's cases at the exact
# mode's factor blocks (F = 20 is the Sf = 1 shard of the TP cases); the
# ranks phases' runs on the 100k-row recipe at K = 8: name -> (path,
# factor_block, sweeps, the metrics held to the world of one's)
DP_KERNEL_F = (1, 4)
DP_RANKS = 4
DP_RANKS_RUNS = {
    "vb": ("dp-vb", 0, 3, ("rmse", "free_energy", "alpha")),
    "vb_exact": ("dp-vb-exact", 1, 2, ("rmse", "free_energy", "alpha")),
    "als": ("dp-als", 0, 3, ("rmse_this", "alpha")),
    "gibbs": ("dp-mcmc", 0, 2, ("rmse", "rmse_this", "alpha")),
}
# the data-parallel block structure and online VB: T13's cases at these F
# on every bin of chunk 0 (one shard; two, summed), X10a's on two join
# slices at these F; the world of one's sweeps and epochs beside the
# resident learners'; the ranks phases' runs on the 100k-row recipes
# (BS_Q_*; OVB at K = 8, 5 chunks): name -> (path, factor_block, sweeps
# or epochs, the metrics held to the world of one's)
DP_OVB_KERNEL_F = (1, 4, 20)
DP_JOIN_F = (0, 1, 20, 33)
DP_BS_SWEEPS, DP_OVB_EPOCHS = 2, 2
DP_SLICE_RANKS_RUNS = {
    # Gibbs on the recipe whose items are main-block columns
    "bs_gibbs": ("dp-bs-main", 0, 2, ("rmse", "rmse_this", "alpha")),
    "bs_als": ("dp-bs-als", 0, 2, ("rmse_this", "alpha")),
    "ovb": ("dp-ovb", 1, 2, ("rmse", "free_energy")),
    "ovb_fb4": ("dp-ovb", 4, 2, ("rmse", "free_energy")),
}
# [tp-mcmc]: Gibbs iterations beside the resident Gibbs, and how far apart
# their posterior-mean RMSEs may end (two chains of other draws)
TP_MCMC_ITERS, TP_MCMC_RMSE_GAP = 20, 0.01
# the windowed Gibbs/ALS beside the resident learner at the same
# factor_block and draws: the JAX test's own bound (test_mcmc_windowed.py:
# 51-56: rmse rtol 5e-4, alpha 5e-3)
MWIN_TRAJ_RTOL, MWIN_ALPHA_RTOL = 5e-4, 5e-3
ML10M_SHAPE, STREAM_10M_CHUNKS = (71_567, 10_681, 10_000_000), 100
NEC, NEC_RTOL = 50_000, 1e-5
# "not falling": the last iteration's test accuracy at most this far below
# the first's, three standard deviations of an accuracy near 0.65 measured
# on 99,978 test rows (sqrt(0.65 * 0.35 / 99,978) = 0.0015)
CLASS_ACC_SLACK = 0.005
# the serving path at scripts/bench_serve.py's shape: ML-1M's one-hot rows
# of a user and an item, K = 20, w0 = 3.5 and w, v ~ 0.1 N(0, 1) from
# seed 0, regression clamped to the star range, 10M rows in batches of
# 2^20; the in-flight window checked at 4,096-row batches, two in flight,
# on 2M rows; the device-resident rate over 8 distinct batches on the card
SERVE_ROWS, SERVE_BATCH = 10_000_000, 1 << 20
SERVE_LO, SERVE_HI = 1.0, 5.0
SERVE_CHECK_ROWS, SERVE_CHECK_BATCH = 2_000_000, 4096
SERVE_RESIDENT_BATCHES, SERVE_RESIDENT_PASSES = 8, 4
# rows of the served predictions held to the CPU twin's
SERVE_CPU_ROWS = 200_000
# checkpoint/resume on the card: CKPT_SWEEPS, a resume, CKPT_SWEEPS more,
# against 2 * CKPT_SWEEPS uninterrupted
CKPT_SWEEPS = 2
# the least time of a kernel's work (PERF.md): its bytes at the H100's HBM
# rate, or its float32 operations at the peak outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

SOURCES = {
    "fm_scores": ("svbfm_tpu_torch/csrc/fm_forward.cu",
                  "svbfm_tpu/ops/forward.py:61"),
    "fm_t_terms": ("svbfm_tpu_torch/csrc/fm_forward.cu",
                   "svbfm_tpu/ops/forward.py:111"),
    # K1a with the serve epilogue: fm_scores and the output transform of
    # BatchScorer's compiled program (serve.py:138-155)
    "fm_serve": ("svbfm_tpu_torch/csrc/fm_forward.cu",
                 "svbfm_tpu/serve.py:140"),
    "vb_build_qt": ("svbfm_tpu_torch/csrc/vb_sweep.cu",
                    "svbfm_tpu/learners/vb.py:317"),
    "vb_col_stats_update": ("svbfm_tpu_torch/csrc/vb_sweep.cu",
                            "svbfm_tpu/learners/vb.py:382"),
    "vb_patch_rows": ("svbfm_tpu_torch/csrc/vb_sweep.cu",
                      "svbfm_tpu/learners/vb.py:508"),
    "w_col_update": ("svbfm_tpu_torch/csrc/w_sweep.cu",
                     "svbfm_tpu/learners/vb.py:125"),
    "w_patch_rows": ("svbfm_tpu_torch/csrc/vb_sweep.cu",
                     "svbfm_tpu/learners/vb.py:149"),
    "ovb_col_stats_update": ("svbfm_tpu_torch/csrc/ovb_sweep.cu",
                             "svbfm_tpu/learners/vb_online.py:476"),
    "build_q": ("svbfm_tpu_torch/csrc/vb_sweep.cu",
                "svbfm_tpu/learners/mcmc.py:337"),
    "mcmc_col_draw": ("svbfm_tpu_torch/csrc/mcmc_sweep.cu",
                      "svbfm_tpu/learners/mcmc.py:371"),
    "mcmc_patch_rows": ("svbfm_tpu_torch/csrc/mcmc_sweep.cu",
                        "svbfm_tpu/learners/mcmc.py:468"),
    "mcmc_w_draw": ("svbfm_tpu_torch/csrc/w_sweep.cu",
                    "svbfm_tpu/learners/mcmc.py:620"),
    "gather_probe": ("svbfm_tpu_torch/csrc/gather_probe.cu",
                     "scripts/pallas_gather_probe.py:83"),
    "sgd_grad_scatter": ("svbfm_tpu_torch/csrc/sgd_step.cu",
                         "svbfm_tpu/learners/sgd.py:103"),
    "sgd_apply": ("svbfm_tpu_torch/csrc/sgd_step.cu",
                  "svbfm_tpu/learners/sgd.py:124"),
    "sgda_lambda": ("svbfm_tpu_torch/csrc/sgd_step.cu",
                    "svbfm_tpu/learners/sgd.py:195"),
    "w_grad_step": ("svbfm_tpu_torch/csrc/w_sweep.cu",
                    "svbfm_tpu/learners/exp_sgd.py:78"),
    "mcmc_col_grad": ("svbfm_tpu_torch/csrc/mcmc_sweep.cu",
                      "svbfm_tpu/learners/exp_sgd.py:120"),
    "bs_join_agg": ("svbfm_tpu_torch/csrc/bs_sweep.cu",
                    "svbfm_tpu/learners/mcmc_bs.py:554"),
    "bs_rel_draw": ("svbfm_tpu_torch/csrc/bs_sweep.cu",
                    "svbfm_tpu/learners/mcmc_bs.py:379"),
    "bs_rel_w_draw": ("svbfm_tpu_torch/csrc/bs_sweep.cu",
                      "svbfm_tpu/learners/mcmc_bs.py:650"),
    "bs_rel_patch": ("svbfm_tpu_torch/csrc/bs_sweep.cu",
                     "svbfm_tpu/learners/mcmc_bs.py:439"),
    "bs_rel_w_patch": ("svbfm_tpu_torch/csrc/bs_sweep.cu",
                       "svbfm_tpu/learners/mcmc_bs.py:670"),
    "bs_rel_moments": ("svbfm_tpu_torch/csrc/bs_forward.cu",
                       "svbfm_tpu/learners/mcmc_bs.py:251"),
    "bs_scores": ("svbfm_tpu_torch/csrc/fm_forward.cu",
                  "svbfm_tpu/learners/mcmc_bs.py:215"),
    "bs_resync": ("svbfm_tpu_torch/csrc/bs_forward.cu",
                  "svbfm_tpu/learners/mcmc_bs.py:463"),
    # the probit task's XLA chains, counted as kernels as the others are
    "probit_latent": ("svbfm_tpu_torch/csrc/probit.cu",
                      "svbfm_tpu/learners/mcmc.py:1072"),
    "probit_eval": ("svbfm_tpu_torch/csrc/probit.cu",
                    "svbfm_tpu/learners/mcmc.py:1046"),
    # K3's and K5's window-accumulating modes (X13a, X13b), the windowed
    # batch VB's v and w statistics and updates
    "vb_col_stats_window": ("svbfm_tpu_torch/csrc/vb_sweep.cu",
                            "svbfm_tpu/learners/vb_windowed.py:447"),
    "w_col_window": ("svbfm_tpu_torch/csrc/w_sweep.cu",
                     "svbfm_tpu/learners/vb_windowed.py:550"),
    # X8a's and X8c's window-accumulating modes (X14a, X14b), the windowed
    # Gibbs/ALS v and w statistics and draws
    "mcmc_col_draw_window": ("svbfm_tpu_torch/csrc/mcmc_sweep.cu",
                             "svbfm_tpu/learners/mcmc_windowed.py:339"),
    "mcmc_w_window": ("svbfm_tpu_torch/csrc/w_sweep.cu",
                      "svbfm_tpu/learners/mcmc_windowed.py:246"),
    # T1-T4, the feature-sharded batch VB (parallel/tp_vb.py): T1 the
    # forward's partials (also tp.py:51's scorer), T2 the caches, T3 a
    # bucket's stats and update launches (K = 0: the w sweep's), T4 the
    # bin patch
    "tp_fm_partials": ("svbfm_tpu_torch/csrc/fm_forward.cu",
                       "svbfm_tpu/parallel/tp_vb.py:229"),
    "tp_build_qt": ("svbfm_tpu_torch/csrc/vb_sweep.cu",
                    "svbfm_tpu/parallel/tp_vb.py:337"),
    "tp_col_stats": ("svbfm_tpu_torch/csrc/vb_sweep.cu",
                     "svbfm_tpu/parallel/tp_vb.py:355"),
    "tp_col_update": ("svbfm_tpu_torch/csrc/vb_sweep.cu",
                      "svbfm_tpu/parallel/tp_vb.py:383"),
    "tp_patch_delta": ("svbfm_tpu_torch/csrc/vb_sweep.cu",
                       "svbfm_tpu/parallel/tp_vb.py:407"),
    "tp_w_stats": ("svbfm_tpu_torch/csrc/w_sweep.cu",
                   "svbfm_tpu/parallel/tp_vb.py:459"),
    "tp_w_update": ("svbfm_tpu_torch/csrc/w_sweep.cu",
                    "svbfm_tpu/parallel/tp_vb.py:473"),
    # T5-T8, the feature-sharded Gibbs/ALS (parallel/tp_mcmc.py): T5 the w
    # draw after T3's w stats, T6 the block's q partials, T7 a bucket's
    # stats and draw launches (X14a's window modes), T8 the bin patch
    "tp_w_draw": ("svbfm_tpu_torch/csrc/w_sweep.cu",
                  "svbfm_tpu/parallel/tp_mcmc.py:158"),
    "tp_build_q": ("svbfm_tpu_torch/csrc/vb_sweep.cu",
                   "svbfm_tpu/parallel/tp_mcmc.py:230"),
    "tp_col_draw_stats": ("svbfm_tpu_torch/csrc/mcmc_sweep.cu",
                          "svbfm_tpu/parallel/tp_mcmc.py:239"),
    "tp_col_draw": ("svbfm_tpu_torch/csrc/mcmc_sweep.cu",
                    "svbfm_tpu/parallel/tp_mcmc.py:269"),
    "tp_mcmc_patch_delta": ("svbfm_tpu_torch/csrc/mcmc_sweep.cu",
                            "svbfm_tpu/parallel/tp_mcmc.py:284"),
    # T9 and T10, the feature-sharded online VB (parallel/tp_ovb.py): K6
    # split into a stats and a blend launch around the data all-reduce
    # (T9), and K5's OVB mode split the same way in tp_w_kernel (T10)
    "tp_ovb_stats": ("svbfm_tpu_torch/csrc/ovb_sweep.cu",
                     "svbfm_tpu/parallel/tp_ovb.py:308"),
    "tp_ovb_blend": ("svbfm_tpu_torch/csrc/ovb_sweep.cu",
                     "svbfm_tpu/parallel/tp_ovb.py:312"),
    "tp_w_ovb_stats": ("svbfm_tpu_torch/csrc/w_sweep.cu",
                       "svbfm_tpu/parallel/tp_ovb.py:222"),
    "tp_w_ovb_blend": ("svbfm_tpu_torch/csrc/w_sweep.cu",
                       "svbfm_tpu/parallel/tp_ovb.py:224"),
    # T11, X9a's window mode: the feature-sharded SGD's batch scatter
    # (parallel/tp_sgd.py, with X9b's dense form), and T12, the
    # feature-sharded scorer's finalize with the serve epilogue (serve.py)
    "tp_sgd_scatter": ("svbfm_tpu_torch/csrc/sgd_step.cu",
                       "svbfm_tpu/parallel/tp_sgd.py:91"),
    "tp_serve": ("svbfm_tpu_torch/csrc/fm_forward.cu",
                 "svbfm_tpu/serve.py:129"),
    # T13, K6 split at any F around the data-parallel OVB's all-reduce
    # (learners/vb_online.py on a data mesh): the stats and the psum,
    # then the blend
    "dp_ovb_stats": ("svbfm_tpu_torch/csrc/ovb_sweep.cu",
                     "svbfm_tpu/learners/vb_online.py:531"),
    "dp_ovb_blend": ("svbfm_tpu_torch/csrc/ovb_sweep.cu",
                     "svbfm_tpu/learners/vb_online.py:533"),
}
# the kernel names whose device time the BS profiles report apart: X10c
# (rel_patch_*_kernel), X10d's resync (resync_*_kernel), moments
# (rel_moments_kernel) and scores (fm_rows_kernel, K1a's kernel in its
# relations mode: no other K1 launch runs in a BS sweep) and X10a
# (join_agg_*_kernel)
BS_FOCUS = ("rel_patch", "resync", "rel_moments", "fm_rows", "join_agg")
# the same for the Gibbs profiles: X8a (col_draw_*) and X8b (row_patch_*)
MCMC_FOCUS = ("col_draw", "row_patch")
# the relation kernels of the block-structure sampler, every path of it
BS_KERNELS = ("bs_rel_moments", "bs_scores", "bs_resync", "bs_join_agg",
              "bs_rel_draw", "bs_rel_w_draw", "bs_rel_patch",
              "bs_rel_w_patch")
# the kernels of the feature-sharded Gibbs/ALS sweep
TP_MCMC_KERNELS = ("tp_fm_partials", "tp_w_stats", "tp_w_draw",
                   "tp_patch_delta", "tp_build_q", "tp_col_draw_stats",
                   "tp_col_draw", "tp_mcmc_patch_delta")
# the kernels of the feature-sharded online VB's chunk update
TP_OVB_KERNELS = ("tp_fm_partials", "tp_w_ovb_stats", "tp_w_ovb_blend",
                  "tp_patch_delta", "tp_build_qt", "tp_ovb_stats",
                  "tp_ovb_blend")
# the kernels of the feature-sharded SGD's minibatch
TP_SGD_KERNELS = ("tp_fm_partials", "tp_sgd_scatter", "sgd_apply")
# the kernels of the data-parallel VB (fast mode) and Gibbs/ALS sweeps
DP_VB_KERNELS = ("fm_scores", "fm_t_terms", "tp_build_qt", "tp_col_stats",
                 "tp_col_update", "tp_patch_delta")
DP_MCMC_KERNELS = ("fm_scores", "build_q", "tp_w_stats", "tp_w_draw",
                   "w_patch_rows", "tp_col_draw_stats", "tp_col_draw",
                   "mcmc_patch_rows")
# the data-parallel BS sweep's main-block pass (w and blocked v)
DP_BS_MAIN_KERNELS = ("build_q", "tp_w_stats", "tp_w_draw", "w_patch_rows",
                      "tp_col_draw_stats", "tp_col_draw", "mcmc_patch_rows")
# the data-parallel OVB chunk: K1, K2 and K4 on the rank's rows, T10 for a
# w bin, T13 for a v bin
DP_OVB_KERNELS = ("fm_scores", "fm_t_terms", "vb_build_qt", "vb_patch_rows",
                  "tp_w_ovb_stats", "tp_w_ovb_blend", "w_patch_rows",
                  "dp_ovb_stats", "dp_ovb_blend")
# the kernels each driven path must launch
PATH_KERNELS = {
    "vb-fast": ("fm_scores", "fm_t_terms", "vb_build_qt",
                "vb_col_stats_update", "vb_patch_rows"),
    "vb-exact": ("fm_scores", "fm_t_terms", "vb_build_qt",
                 "vb_col_stats_update", "vb_patch_rows", "w_col_update",
                 "w_patch_rows"),
    "ovb": ("fm_scores", "fm_t_terms", "vb_build_qt", "vb_patch_rows",
            "w_col_update", "w_patch_rows", "ovb_col_stats_update"),
    "mcmc": ("fm_scores", "build_q", "mcmc_col_draw", "mcmc_patch_rows",
             "mcmc_w_draw", "w_patch_rows"),
    "als": ("fm_scores", "build_q", "mcmc_col_draw", "mcmc_patch_rows",
            "mcmc_w_draw", "w_patch_rows"),
    "gather-probe": ("gather_probe",),
    "serve": ("fm_serve",),
    "sgd": ("fm_scores", "sgd_grad_scatter", "sgd_apply"),
    "sgd-online": ("fm_scores", "sgd_grad_scatter", "sgd_apply"),
    "exp-sgd-stoc": ("fm_scores", "sgd_grad_scatter", "sgd_apply"),
    "sgda": ("fm_scores", "sgd_grad_scatter", "sgd_apply", "sgda_lambda"),
    "bpr": ("fm_scores", "sgd_grad_scatter", "sgd_apply"),
    "exp-sgd": ("fm_scores", "w_grad_step", "w_patch_rows", "build_q",
                "mcmc_col_grad", "mcmc_patch_rows"),
    # the card's recipe has an empty main block: no main-block kernel runs
    "bs-mcmc": BS_KERNELS,
    "bs-als": BS_KERNELS,
    "bs-seq": BS_KERNELS + ("build_q",),
    "bs-k64": BS_KERNELS,
    "bs-nine": BS_KERNELS,
    # classification: X12b's eval, and X12a's latent update where the
    # method has one (OVB has none)
    "vb-class": ("fm_scores", "fm_t_terms", "vb_build_qt",
                 "vb_col_stats_update", "vb_patch_rows", "probit_latent",
                 "probit_eval"),
    "mcmc-class": ("fm_scores", "build_q", "mcmc_col_draw", "mcmc_patch_rows",
                   "mcmc_w_draw", "w_patch_rows", "probit_latent",
                   "probit_eval"),
    "als-class": ("fm_scores", "build_q", "mcmc_col_draw", "mcmc_patch_rows",
                  "mcmc_w_draw", "w_patch_rows", "probit_latent",
                  "probit_eval"),
    "ovb-class": ("fm_scores", "fm_t_terms", "vb_build_qt", "vb_patch_rows",
                  "w_col_update", "w_patch_rows", "ovb_col_stats_update",
                  "probit_eval"),
    "bs-class": BS_KERNELS + ("probit_latent", "probit_eval"),
    "sgd-class": ("fm_scores", "sgd_grad_scatter", "sgd_apply"),
    "sgda-class": ("fm_scores", "sgd_grad_scatter", "sgd_apply",
                   "sgda_lambda"),
    "sgd-poisson": ("fm_scores", "sgd_grad_scatter", "sgd_apply"),
    # out of core: the streamed paths run the in-memory kernels, the
    # windowed batch VB X13a and X13b with K2 and K4 on its windows
    "ovb-stream": ("fm_scores", "fm_t_terms", "vb_build_qt", "vb_patch_rows",
                   "w_col_update", "w_patch_rows", "ovb_col_stats_update"),
    "ovb-stream-10m": ("fm_scores", "fm_t_terms", "vb_build_qt",
                       "vb_patch_rows", "w_col_update", "w_patch_rows",
                       "ovb_col_stats_update"),
    "sgd-online-stream": ("fm_scores", "sgd_grad_scatter", "sgd_apply"),
    "vb-windowed": ("fm_scores", "fm_t_terms", "vb_build_qt",
                    "vb_col_stats_window", "vb_patch_rows", "w_col_window",
                    "w_patch_rows"),
    # the windowed Gibbs/ALS: X14a and X14b with X8d, X8b and the w patch
    # on its windows
    "mcmc-windowed": ("fm_scores", "build_q", "mcmc_col_draw_window",
                      "mcmc_patch_rows", "mcmc_w_window", "w_patch_rows"),
    "als-windowed": ("fm_scores", "build_q", "mcmc_col_draw_window",
                     "mcmc_patch_rows", "mcmc_w_window", "w_patch_rows"),
    # the feature-sharded batch VB at K = 20 and K = 0
    "tp-vb": ("tp_fm_partials", "tp_build_qt", "tp_col_stats",
              "tp_col_update", "tp_patch_delta"),
    "tp-vb-k0": ("tp_fm_partials", "tp_w_stats", "tp_w_update",
                 "tp_patch_delta"),
    # the feature-sharded Gibbs and ALS (T1, T3's w stats, T4 at F = 0 and
    # T5-T8), and under -task c X12a and X12b
    "tp-mcmc": TP_MCMC_KERNELS,
    "tp-als": TP_MCMC_KERNELS,
    "tp-mcmc-class": TP_MCMC_KERNELS + ("probit_latent", "probit_eval"),
    # the feature-sharded online VB (T1, T10, T4 at F = 0 and 1, T2 at
    # F = 1, T9)
    "tp-ovb": TP_OVB_KERNELS,
    # the feature-sharded SGD (T1, T11, X9b dense) and serving over a mesh
    # (replicated: X11; feature-sharded: T1, T12)
    "tp-sgd": TP_SGD_KERNELS,
    "serve-mesh": ("fm_serve", "tp_fm_partials", "tp_serve"),
    # the data-parallel replicated learners: T2-T4 for a VB block, T3 at
    # K = 0 and K4 at F = 0 for the standalone w sweep; X8d, T3's w stats,
    # T5, T7 and X8b for Gibbs/ALS; K1 on the rank's rows
    "dp-vb": DP_VB_KERNELS,
    "dp-vb-exact": DP_VB_KERNELS + ("tp_w_stats", "tp_w_update",
                                    "w_patch_rows"),
    "dp-vb-class": DP_VB_KERNELS + ("tp_w_stats", "tp_w_update",
                                    "w_patch_rows", "probit_latent",
                                    "probit_eval"),
    "dp-als": DP_MCMC_KERNELS,
    "dp-mcmc": DP_MCMC_KERNELS,
    "dp-mcmc-seq": DP_MCMC_KERNELS,
    "dp-mcmc-class": DP_MCMC_KERNELS + ("probit_latent", "probit_eval"),
    # the data-parallel block structure (the 1M-row recipe has an empty
    # main block: X10a on the rank's join slices, then an all-reduce; with
    # the items in the main block, its pass on the rank's slice of the
    # main plan: X8d, T3's w stats, T5, T7, X8b) and online VB (T10, T13),
    # in memory and streamed
    "dp-bs": BS_KERNELS,
    "dp-bs-main": BS_KERNELS + DP_BS_MAIN_KERNELS,
    "dp-bs-seq": BS_KERNELS + ("build_q",),
    "dp-bs-als": BS_KERNELS,
    "dp-bs-class": BS_KERNELS + ("probit_latent", "probit_eval"),
    "dp-ovb": DP_OVB_KERNELS,
    "dp-ovb-class": DP_OVB_KERNELS + ("probit_eval",),
    "dp-ovb-stream": DP_OVB_KERNELS,
}


def say(phase: str, t0: float, **kv) -> None:
    body = " ".join(f"{k}={v}" for k, v in kv.items())
    print(f"[{phase}] {body} seconds={time.perf_counter() - t0:.3f}",
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, graph: bool = True) -> float:
    """Mean device time of one call: ``reps`` calls captured in a CUDA graph
    and replayed between two CUDA events.  The replay launches them back to
    back, so a call's Python wrapper (tens of µs, more than a small
    kernel's run time) is not in the number.  ``graph=False`` (a call that
    synchronises cannot be captured) times the calls themselves between
    the events: host-paced."""
    fn()
    torch.cuda.synchronize()
    if not graph:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    graph.reset()  # frees the graph's memory pool
    return a.elapsed_time(b) / reps


def fresh_ms(prepare, fn, reps: int, means: int = 1) -> list:
    """Mean device times of one call of ``fn(inputs)``, each call on its own
    input set from ``prepare()``: ``reps`` calls on ``reps`` sets captured
    in a CUDA graph, the sets copied back from one untouched set before
    each replay, outside the timed events.  A path that applies an
    in-place op once (X12a) sees fresh values, where ``cuda_ms`` feeds each
    call its predecessor's output.  One mean a replay, ``means`` of them."""
    sets = [prepare() for _ in range(reps)]
    src = prepare()

    def refresh():
        for s in sets:
            for t, o in zip(s, src):
                t.copy_(o)

    fn(prepare())
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for s in sets:
            fn(s)
    out = []
    for i in range(means + 1):
        refresh()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        torch.cuda.synchronize()
        if i:  # the first replay warms
            out.append(a.elapsed_time(b) / reps)
    graph.reset()
    return out


def compare(outs_k, outs_p, what: str) -> float:
    """Max abs error of kernel outputs against the twin's where the twin is
    finite; where it is not, the kernel must have the same NaN/Inf there.
    Raises past the tolerance.  Returns the max abs error."""
    worst = 0.0
    for a, b in zip(outs_k, outs_p):
        a, b = a.double(), b.double()
        fin = torch.isfinite(b)
        if not torch.equal(torch.isfinite(a), fin) or not torch.equal(
                a[~fin].nan_to_num(), b[~fin].nan_to_num()):
            raise AssertionError(f"{what}: kernel and twin differ in their "
                                 "non-finite values")
        a, b = a[fin], b[fin]
        err = (a - b).abs().max().item() if a.numel() else 0.0
        scale = max(1.0, b.abs().max().item() if b.numel() else 0.0)
        if err > KERNEL_TOL * scale:
            raise AssertionError(f"{what}: max abs err {err:.3e} > "
                                 f"{KERNEL_TOL:g} * {scale:.3g}")
        worst = max(worst, err)
    return worst


def _clones(s: dict, *keys) -> tuple:
    return tuple(s[k].clone() for k in keys)


def _bad(device):
    return torch.zeros(4, dtype=torch.int32, device=device)


# ---------------------------------------------------------------------------
# Kernel cases.  A case is (label, prepare, call, cost): prepare() makes
# fresh copies of the inputs an op updates in place; call(variant, inputs)
# runs the CUDA op ("kernel") or its twin ("plain") once and returns the
# outputs.  ``cost`` is None for a case that is only checked, or, for one
# that is timed too, a dict of the bytes the op must move (each input read
# once, each output written once, as this case's data needs them), its
# float32 operations, and ``library``: one PyTorch call that computes the
# same function on the same inputs, or None.  Timing repeats call() on one
# prepared input set, so it times the op alone.  A tensor dict ``s`` holds
# one shape family; a case whose inputs it lacks is skipped.
# ---------------------------------------------------------------------------

def cost(nbytes: float, flops: float, library=None,
         plain_graph: bool = True, note: str = "",
         fresh: bool = False) -> dict:
    """``plain_graph=False``: the twin synchronises (exact_block_draws tests
    its solve on the host), so it is timed host-paced; ``note``: what the
    timed line also prints (X10b's form and split); ``fresh``: each timed
    call on its own fresh inputs (``fresh_ms``)."""
    return dict(bytes=float(nbytes), flops=float(flops), library=library,
                plain_graph=plain_graph, note=note, fresh=fresh)


def plan_note(mod, plan: str, args: tuple, fields: tuple) -> str:
    """The ``fields`` of ``mod.<plan>(*args)``, a kernel's form as the
    timed line prints it; ``form=?`` for a checkout without the plan (an
    older tree timed beside this one by ``kernel_times.py``)."""
    fn = getattr(mod, plan, None)
    if fn is None:
        return "form=?"
    p = fn(*args)
    return " ".join(f"{k}={getattr(p, k)}" for k in fields)


def draw_plan_of(F: int, b):
    """X10b's plan for relation bucket ``b`` on its card (None on the
    CPU)."""
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    if b.rows.device.type != "cuda":
        return None
    C, L = b.rows.shape
    sms = torch.cuda.get_device_properties(b.rows.device).multi_processor_count
    return ks.draw_plan(F, C, L, b.real.lo, b.real.hi, sms)


def draw_note(F: int, b) -> str:
    """X10b's form, k and splits for relation bucket ``b``."""
    p = draw_plan_of(F, b)
    if p is None:
        return ""
    return f"form={p.form} k={p.k} S={p.S} real={b.real.lo}-{b.real.hi}"


def f1_note(b: dict) -> str:
    """X8a's form at F = 1 for bucket ``b`` (lanes a column, slots a
    load)."""
    from svbfm_tpu_torch.kernels import mcmc_sweep as km

    return plan_note(km, "col_draw_f1_plan", (b["rows"], b["x"]),
                     ("lanes", "vec"))


def draw_form_note(F: int, rows, mode: str = "exact") -> str:
    """X8a's (X14a's) form for a bucket of ``rows`` [C, L]: lanes, or
    block, and lanes a column or threads a block."""
    from svbfm_tpu_torch.kernels import mcmc_sweep as km

    C, L = rows.shape
    return plan_note(km, "col_draw_form", (F, C, L, mode),
                     ("form", "lanes", "cols"))


def stats_note(F: int, rows, q, tq) -> str:
    """K3's (X13a's) form for a bucket of ``rows`` [C, L] on the caches q
    and tq: lanes or block, lanes a column (a slot in the block form),
    warps a block, floats a load."""
    from svbfm_tpu_torch.kernels import vb_sweep as kv

    if not hasattr(kv, "col_stats_vec"):
        return "form=?"
    C, L = rows.shape
    return plan_note(kv, "col_stats_form",
                     (F, C, L, kv.col_stats_vec(F, q, tq)),
                     ("form", "lanes", "cols", "warps", "vec"))


def w_note(bins) -> str:
    """K5's form on each bucket of a bin: U lanes a column."""
    from svbfm_tpu_torch.kernels import w_sweep as kw

    return "U=" + "+".join(str(kw.col_lanes(b.rows.shape[1])) for b in bins)


def bound(c: dict):
    """(least ms for the work, what bounds it): the bytes at the HBM rate
    or the operations at the float32 peak, whichever takes longer."""
    tb, tf = c["bytes"] / HBM_BYTES_PER_S, c["flops"] / F32_FLOPS_PER_S
    return 1e3 * max(tb, tf), "bytes" if tb >= tf else "operations"


def make_cases(s: dict):
    from svbfm_tpu_torch.kernels import fm_forward as k1
    from svbfm_tpu_torch.kernels import gather_probe as kg
    from svbfm_tpu_torch.kernels import mcmc_sweep as km
    from svbfm_tpu_torch.kernels import ovb_sweep as ko
    from svbfm_tpu_torch.kernels import vb_sweep as kv
    from svbfm_tpu_torch.kernels import w_sweep as kw

    cases = {name: [] for name in SOURCES}
    tag = s["tag"]
    timed = s.get("timed", True)

    def add(name, label, prepare, call, c):
        cases[name].append((f"{tag} {label}", prepare, call,
                            c if timed else None))

    def nothing():
        return ()

    def rows_bytes(ids):  # the ids and values of the row layout
        return ids.numel() * 8

    def bucket_cost(b, per_entry_floats, per_col_floats, flops_per_entry,
                    plain_graph=True):
        # rows and x are read in every slot; the gathers and the arithmetic
        # only at the real entries (a padding slot has x = 0, so h = 0, and
        # points at one pad row)
        C, L = b["rows"].shape
        n = int(torch.count_nonzero(b["x"]))
        return cost(C * L * 8 + n * 4 * per_entry_floats
                    + C * 4 * per_col_floats, n * flops_per_entry,
                    plain_graph=plain_graph)

    def k2(F, ptab, ids, vals):
        def call(variant, _):
            fn = kv.vb_build_qt if variant == "kernel" else kv.vb_build_qt_plain
            return list(fn(ptab, F, ids, vals))
        return call

    def qt_note(ptab, F, ids, vals):  # K2's and X8d's form
        return plan_note(kv, "qt_plan_of", (ptab, F, ids, vals),
                         ("form", "vec", "lanes", "rows", "build"))

    def k2_cost(F, ptab, ids, vals):
        N, P = ids.shape
        return cost(rows_bytes(ids) + s["D"] * 2 * F * 4 + 3 * N * F * 4,
                    N * P * F * 6, note=qt_note(ptab, F, ids, vals))

    def k4(F, merge_w, seq, ptab, ids, vals, keys):
        def prepare():
            return _clones(s, *keys)

        def call(variant, inp):
            fn = (kv.vb_patch_rows if variant == "kernel"
                  else kv.vb_patch_rows_plain)
            fn(ptab, F, merge_w, ids, vals, *inp, sequential=seq)
            return list(inp)
        return prepare, call

    def k4_cost(F, ptab, ids):
        N, P = ids.shape
        return cost(rows_bytes(ids) + ptab.numel() * 4 + N * F * 24 + N * 16,
                    N * P * F * 20)

    if "stab" in s:  # K1: scores (test eval, train rows, OVB chunk e;
        # SGD's own table) and T-terms, on the tables ops/forward.py builds
        def table_bytes(tab):  # the channels read, not the row's padding
            return tab.shape[0] * tab.shape[1] * 4

        def k1_call(kernel, plain, tab, scalar, ids, vals):
            def call(variant, _):
                fn = kernel if variant == "kernel" else plain
                return [fn(tab, scalar, ids, vals)]
            return call

        def k1_library(tab, ids, vals):  # sum x (w | v) alone, no pairs
            ids64, dense = ids.long(), tab.contiguous()
            return lambda: torch.nn.functional.embedding_bag(
                ids64, dense, per_sample_weights=vals, mode="sum")

        def k1_note(tab, K, ids):
            return plan_note(k1, "fm_plan", (tab, K, ids.shape[1]),
                             ("vec", "lanes", "rows", "build"))

        K = s["stab"].shape[1] - 1
        scores = [("scores", s["stab"], s["eval_ids"], s["eval_vals"])]
        if s.get("train_scores"):  # Gibbs/ALS/exp_sgd's re-score
            scores.append(("scores train", s["stab"], s["ids"], s["vals"]))
        if "sgd_stab" in s:  # the SGD family's [D, 1+K] parameter table
            scores.append(("scores sgd-table", s["sgd_stab"], s["eval_ids"],
                           s["eval_vals"]))
        for label, tab, ids, vals in scores:
            N, P = ids.shape
            add("fm_scores", f"{label} N={N}", nothing,
                k1_call(k1.fm_scores_op, k1.fm_scores_plain, tab, s["w0"],
                        ids, vals),
                cost(rows_bytes(ids) + table_bytes(tab) + N * 4,
                     N * P * (4 * K + 2) + 2 * N * K,
                     k1_library(tab, ids, vals), note=k1_note(tab, K, ids)))
        N, P = s["ids"].shape
        add("fm_t_terms", f"t-terms N={N}", nothing,
            k1_call(k1.fm_t_terms_op, k1.fm_t_terms_plain, s["ttab"],
                    s["s0"], s["ids"], s["vals"]),
            cost(rows_bytes(s["ids"]) + table_bytes(s["ttab"]) + N * 4,
                 N * P * (9 * K + 2) + 4 * N * K,
                 note=k1_note(s["ttab"], K, s["ids"])))

    if "serve" in s:  # K1a with the serve epilogue, its three modes, at
        # bench_serve.py's shape and on rows and tables with NaN and +-Inf
        sv = s["serve"]
        K = sv["tab"].shape[1] - 1

        def serve_call(mode, tab, ids, vals):
            def call(variant, _):
                if variant == "kernel":
                    return [k1.fm_serve_op(tab, sv["w0"], ids, vals, mode,
                                           SERVE_LO, SERVE_HI)]
                return [k1.fm_serve_plain(tab, sv["w0"], ids, vals, mode,
                                          SERVE_LO, SERVE_HI)]
            return call

        ids64, dense = sv["ids"].long(), sv["tab"].contiguous()
        N, P = sv["ids"].shape
        for mode, name, epi in ((k1.SERVE_CLAMP, "clamp", 2),
                                (k1.SERVE_PROBIT, "probit", 20),
                                (k1.SERVE_SCORE, "score", 0)):
            add("fm_serve", f"{name} N={N}", nothing,
                serve_call(mode, sv["tab"], sv["ids"], sv["vals"]),
                cost(rows_bytes(sv["ids"]) + sv["tab"].shape[0] * (K + 1) * 4
                     + N * 4, N * P * (4 * K + 2) + 2 * N * K + N * epi,
                     lambda: torch.nn.functional.embedding_bag(
                         ids64, dense, per_sample_weights=sv["vals"],
                         mode="sum"),
                     note=plan_note(k1, "fm_plan", (sv["tab"], K, P),
                                    ("vec", "lanes", "rows", "build"))))
            add("fm_serve", f"{name} poisoned N={sv['bad_ids'].shape[0]}",
                nothing, serve_call(mode, sv["bad_tab"], sv["bad_ids"],
                                    sv["bad_vals"]), None)

    if "buckets" in s:  # batch VB, fast mode (all K factors in one block)
        F = s["F"]

        def k3_prepare():
            return _clones(s, "mu_t", "sig_t", "ptab", "mu_w", "sig_w") + (
                torch.zeros(2, dtype=torch.int32, device=s["e"].device),)

        def k3(blk, sv, sigma_w):
            def call(variant, inp):
                fn = (kv.vb_col_stats_update if variant == "kernel"
                      else kv.vb_col_stats_update_plain)
                mu_t, sig_t, ptab, mu_w, sig_w, nans = inp
                fn(blk["rows"], blk["x"], blk["cols"], blk["group"],
                   blk["sx2"], s["e"], s["q"], s["tq"], ptab, mu_t, sig_t, sv,
                   s["alpha"], (mu_w, sig_w, sigma_w), nans)
                return [mu_t, sig_t, ptab, mu_w, sig_w, nans]
            return call

        add("vb_build_qt", f"F={F}", nothing,
            k2(F, s["ptab"], s["ids"], s["vals"]),
            k2_cost(F, s["ptab"], s["ids"], s["vals"]))
        for b in s["buckets"]:
            add("vb_col_stats_update",
                f"F={F} [{b['rows'].shape[0]},{b['rows'].shape[1]}]",
                k3_prepare, k3(b, s["sv"], s["sigma_w"]),
                bucket_cost(b, 1 + 2 * F, 2 * F + 5 * F + 6, 12 * F + 2))
        add("vb_patch_rows", f"F={F} seq",
            *k4(F, True, True, s["ptab_patch"], s["ids"], s["vals"],
                ("q", "tq", "tz", "e", "t")),
            k4_cost(F, s["ptab_patch"], s["ids"]))

    def bin_cost(bins, per_col_floats, flops_per_entry):
        # K5 on a bin: rows, x and e gathered once, the column's tables,
        # the dtab rows written, summed over the bin's buckets
        parts = [bucket_cost(_bucket_dict(b), 1, per_col_floats,
                             flops_per_entry) for b in bins]
        return cost(sum(c["bytes"] for c in parts),
                    sum(c["flops"] for c in parts), note=w_note(bins))

    def bin_label(bins):
        if len(bins) > 8:
            return f"bin of {len(bins)} buckets"
        return "bin " + "+".join(f"[{b.rows.shape[0]},{b.rows.shape[1]}]"
                                 for b in bins)

    if "w_bins" in s:  # the standalone linear-term sweep (K5, w patch)
        def k5_prepare(ovb):
            def prepare():
                base = _clones(s, "mu_w", "sig_w") + (
                    torch.zeros_like(s["dtab"]), _bad(s["e"].device))
                return base + (_clones(s, "n_mu_w", "n_sig_w", "t_wj")
                               if ovb else ())
            return prepare

        def k5(bins, ovb):  # every bucket of a bin: one launch, or each twin
            def call(variant, inp):
                fn = (kw.w_bin_update if variant == "kernel"
                      else kw.w_bin_update_plain)
                mu_w, sig_w, dtab, bad = inp[:4]
                extra = None
                if ovb:
                    n_mu, n_sig, t_wj = inp[4:]
                    extra = (n_mu, n_sig, s["rho_w"], t_wj)
                fn(bins, s["e"], mu_w, sig_w, s["w_sigma_w"], s["alpha"],
                   dtab, bad, ovb=extra)
                return list(inp)
            return call

        def wpatch_prepare():
            return _clones(s, "e", "t")

        def wpatch(variant, inp):
            fn = kv.w_patch_rows if variant == "kernel" else kv.w_patch_rows_plain
            fn(s["dtab"], s["ids"], s["vals"], *inp)
            return list(inp)

        ovb = s["ovb"]
        mode = "ovb" if ovb else "vb"
        for bins in s["w_bins"]:
            add("w_col_update", f"{mode} {bin_label(bins)}", k5_prepare(ovb),
                k5(bins, ovb), bin_cost(bins, 16 if ovb else 10,
                                        4 if ovb else 2))
        N, P = s["ids"].shape
        add("w_patch_rows", f"N={N}", wpatch_prepare, wpatch,
            cost(rows_bytes(s["ids"]) + s["dtab"].numel() * 4 + N * 16,
                 N * P * 4))

    if "v_bins" in s:  # online VB factor block (K2, K6, K4 seq=False)
        F = s["vF"]

        def k6_prepare():
            return _clones(s, "v_ptab", "v_mu", "v_sig", "v_nmu",
                           "v_nsig") + (torch.zeros_like(s["rho_v"]),
                                        _bad(s["e"].device))

        def k6(plan):  # every bucket of a bin: one launch, or each twin
            def call(variant, inp):
                fn = (ko.ovb_col_stats_update if variant == "kernel"
                      else ko.ovb_bin_update_plain)
                ptab, mu, sig, nmu, nsig, tv_add, bad = inp
                fn(plan, s["e"], s["vq"], s["vtq"], ptab, mu, sig, nmu, nsig,
                   s["v_sv"], s["alpha"], s["rho_v"], tv_add, bad)
                return [ptab, mu, sig, nmu, nsig, tv_add, bad]
            return call

        add("vb_build_qt", f"F={F}", nothing,
            k2(F, s["v_ptab"], s["ids"], s["vals"]),
            k2_cost(F, s["v_ptab"], s["ids"], s["vals"]))
        for plan in s["v_bins"]:
            parts = [bucket_cost(_bucket_dict(b), 1 + 2 * F, 4 + 11 * F,
                                 12 * F) for b in plan.buckets]
            shapes = "+".join(f"[{C},{L}]" for *_, C, L in plan.rows)
            add("ovb_col_stats_update", f"F={F} bin {shapes}", k6_prepare,
                k6(plan), cost(sum(c["bytes"] for c in parts),
                               sum(c["flops"] for c in parts)))
        add("vb_patch_rows", f"F={F} simultaneous",
            *k4(F, False, False, s["v_ptab_patch"], s["ids"], s["vals"],
                ("vq", "vtq", "vtz", "e", "t")),
            k4_cost(F, s["v_ptab_patch"], s["ids"]))

    if "exact_buckets" in s:  # batch VB exact mode: K2, K3, K4 at F = 1
        def k3x_prepare():
            return _clones(s, "x_mu", "x_sig", "x_ptab") + (
                torch.zeros(2, dtype=torch.int32, device=s["e"].device),)

        def k3x(blk):
            def call(variant, inp):
                fn = (kv.vb_col_stats_update if variant == "kernel"
                      else kv.vb_col_stats_update_plain)
                mu_t, sig_t, ptab, nans = inp
                fn(blk["rows"], blk["x"], blk["cols"], blk["group"],
                   blk["sx2"], s["e"], s["xq"], s["xtq"], ptab, mu_t, sig_t,
                   s["x_sv"], s["alpha"], None, nans)
                return [mu_t, sig_t, ptab, nans]
            return call

        add("vb_build_qt", "exact F=1", nothing,
            k2(1, s["x_ptab"], s["ids"], s["vals"]),
            k2_cost(1, s["x_ptab"], s["ids"], s["vals"]))
        for b in s["exact_buckets"]:
            add("vb_col_stats_update",
                f"exact F=1 [{b['rows'].shape[0]},{b['rows'].shape[1]}]",
                k3x_prepare, k3x(b), bucket_cost(b, 3, 8, 14))
        add("vb_patch_rows", "exact F=1 seq",
            *k4(1, False, True, s["x_ptab_patch"], s["ids"], s["vals"],
                ("xq", "xtq", "xtz", "e", "t")),
            k4_cost(1, s["x_ptab_patch"], s["ids"]))

    def mcmc_block(F, m):
        """Gibbs/ALS: X8d, X8a and X8b on a block of F factors; ``m`` holds
        the block's tensors."""
        ids, vals = s["ids"], s["vals"]
        N, P = ids.shape

        def x8d(variant, _):
            fn = kv.build_q if variant == "kernel" else kv.build_q_plain
            return [fn(m["ptab"], F, ids, vals)]

        def x8d_library():
            return torch.nn.functional.embedding_bag(
                m["ids64"], m["vt"], per_sample_weights=vals, mode="sum")

        add("build_q", f"F={F} N={N}", nothing, x8d,
            cost(rows_bytes(ids) + s["D"] * F * 4 + N * F * 4, N * P * F * 2,
                 x8d_library, note=qt_note(m["ptab"], F, ids, vals)))

        def x8a_prepare():
            return (m["ptab"].clone(), m["vt"].clone(),
                    torch.zeros(2, dtype=torch.int32, device=ids.device))

        def x8a(blk, exact, z):
            def call(variant, inp):
                fn = (km.mcmc_col_draw if variant == "kernel"
                      else km.mcmc_col_draw_plain)
                ptab, vt, nans = inp
                fn(blk["rows"], blk["x"], blk["cols"], blk["group"], m["e"],
                   m["q"], ptab, vt, m["mu"], m["lam"], m["alpha"], z, exact,
                   nans)
                return [ptab, vt, nans]
            return call

        for b in m["buckets"]:
            C, L = b["rows"].shape
            for exact, z in ((True, m["z"]), (False, None)):
                mode = ("exact" if exact else "jacobi") + (
                    "+z" if z is not None else "")
                c = bucket_cost(b, 1 + F,
                                3 * F + (F if z is not None else 0),
                                7 * F + (F * (F - 1) if exact else 0),
                                plain_graph=not exact)
                c["note"] = f1_note(b) if F == 1 else ""
                add("mcmc_col_draw", f"F={F} {mode} [{C},{L}]", x8a_prepare,
                    x8a(b, exact, z), c)

        def x8b_prepare():
            return m["q"].clone(), m["e"].clone()

        for b_i, pt in enumerate(m["ptab_patch"]):  # as each bin leaves it
            def x8b(variant, inp, pt=pt):
                fn = (km.mcmc_patch_rows if variant == "kernel"
                      else km.mcmc_patch_rows_plain)
                q, e = inp
                fn(pt, F, ids, vals, q, e)
                return [q, e]

            add("mcmc_patch_rows", f"F={F} N={N} bin {b_i}", x8b_prepare,
                x8b,
                cost(rows_bytes(ids) + s["D"] * 2 * F * 4 + N * F * 8
                     + N * 8, N * P * F * 6,
                     note=plan_note(km, "patch_plan", (pt, F, m["q"]),
                                    ("form", "vec", "lanes", "rows"))))

    if "mF" in s:  # the block of F = mF factors (m_*) and F = 1 (m1_*)
        for F, sfx in ((s["mF"], ""), (1, "1")):
            mcmc_block(F, {k[len(f"m{sfx}_"):]: v for k, v in s.items()
                           if k.startswith(f"m{sfx}_")})

    if "mw_bins" in s:  # X8c (K5's MCMC mode) and the w patch without t
        def x8c_prepare():
            return (s["mw_w"].clone(), torch.zeros_like(s["mw_dtab"]),
                    _bad(s["ids"].device))

        def x8c(bins, z):
            def call(variant, inp):
                fn = (kw.mcmc_w_bin_draw if variant == "kernel"
                      else kw.mcmc_w_bin_draw_plain)
                w, dtab, bad = inp
                fn(bins, s["mw_e"], w, s["mw_mu"], s["mw_lambda"],
                   s["mw_alpha"], z, dtab, bad)
                return [w, dtab, bad]
            return call

        for bins in s["mw_bins"]:
            for z in (s.get("mw_z"), None):
                add("mcmc_w_draw",
                    f"{'gibbs' if z is not None else 'als'} "
                    f"{bin_label(bins)}", x8c_prepare, x8c(bins, z),
                    bin_cost(bins, 10, 2))

        def wpatch_e(variant, inp):
            fn = kv.w_patch_rows if variant == "kernel" else kv.w_patch_rows_plain
            fn(s["mw_dtab"], s["ids"], s["vals"], *inp)
            return list(inp)

        N, P = s["ids"].shape
        add("w_patch_rows", f"mcmc e only N={N}",
            lambda: (s["mw_e"].clone(),), wpatch_e,
            cost(rows_bytes(s["ids"]) + s["mw_dtab"].numel() * 4 + N * 8,
                 N * P * 2))

    if "xw_bins" in s:  # X9d: K5's gradient mode, the exp_sgd w step
        def x9dw(bins):
            def call(variant, inp):
                fn = (kw.w_bin_grad_step if variant == "kernel"
                      else kw.w_bin_grad_step_plain)
                w, dtab = inp
                fn(bins, s["x_e"], w, dtab, *s["x_step"])
                return [w, dtab]
            return call

        for bins in s["xw_bins"]:
            add("w_grad_step", bin_label(bins),
                lambda: (s["x_w"].clone(),
                         torch.zeros(s["D"], 2, device=s["x_w"].device)),
                x9dw(bins), bin_cost(bins, 4, 2))

    for F, m in s.get("xg", ()):  # X9d: X8a's gradient mode, the v step
        def x9dv(blk, m=m):
            def call(variant, inp):
                fn = (km.mcmc_col_grad if variant == "kernel"
                      else km.mcmc_col_grad_plain)
                ptab, vt = inp
                fn(blk["rows"], blk["x"], blk["cols"], s["x_e"], m["q"], ptab,
                   vt, *s["x_vstep"])
                return [ptab, vt]
            return call

        for b in m["buckets"]:
            c = bucket_cost(b, 1 + F, 3 * F, 5 * F)
            c["note"] = f1_note(b) if F == 1 else ""
            add("mcmc_col_grad",
                f"F={F} [{b['rows'].shape[0]},{b['rows'].shape[1]}]",
                lambda m=m: (m["ptab"].clone(), m["vt"].clone()), x9dv(b), c)

    for r in s.get("bs", ()):  # X10a-X10d on one relation
        bs_cases(add, r)

    for W in s.get("win", ()):  # X13a (and X13b): the windows of one bin
        win_cases(add, W, bucket_cost, bin_cost)

    for W in s.get("mwin", ()):  # X14a (and X14b): the windows of one bin
        mwin_cases(add, W, bucket_cost, bin_cost)

    if "r4" in s:  # X8a and K3 at the resident factor_block-4 shapes
        resident4_cases(add, s["r4"], bucket_cost)

    # X9a, X9b and (SGDA) X9c, per mode
    for key in ("sgd", "sgd_wide", "sgd_tasks"):
        for mode_case in s.get(key, {}).get("modes", ()):
            sgd_cases(add, s[key], *mode_case)

    probit_cases(add, s)

    if "tp_sgd" in s:  # T11 and X9b's dense form over a window
        tp_sgd_cases(add, s["tp_sgd"])

    for label, part, w0, mode, timed_case in s.get("tp_serve", ()):  # T12
        K = (part.shape[1] - 1) // 2
        N = part.shape[0]

        def t12(variant, _, part=part, w0=w0, K=K, mode=mode):
            fn = k1.tp_serve_op if variant == "kernel" else k1.tp_serve_plain
            return [fn(part, w0, K, mode, SERVE_LO, SERVE_HI)]

        add("tp_serve", f"{label} N={N}", nothing, t12,
            cost(part.numel() * 4 + N * 4 + 4, N * (3 * K + 3))
            if timed_case else None)

    for label, t, idx in s.get("gathers", ()):  # P1: o[r, l] = t[i[r, l], l]
        def gcall(variant, _, t=t, idx=idx):
            fn = kg.gather_rows if variant == "kernel" else kg.gather_rows_plain
            return [fn(t, idx)]

        i64 = idx.long()
        if t.shape[1] == 1:
            def library(t=t, i64=i64):
                return torch.take(t.view(-1), i64.view(-1))
        else:
            def library(t=t, i64=i64):
                return torch.take_along_dim(t, i64, dim=0)
        add("gather_probe", label, nothing, gcall,
            cost(idx.numel() * 8 + t.numel() * 4, 0, library))

    if "tp" in s:  # T1-T4, the feature-sharded batch VB's kernels
        tp_cases(add, s, bucket_cost, bin_cost, bin_label)
    if "dp" in s:  # T3, T5, T7 at the data-parallel learners' shapes
        dp_cases(add, s, bucket_cost, bin_cost, bin_label)
    if "tp_ovb" in s:  # T9, T10 and the OVB chunk's T1, T2, T4
        tp_ovb_cases(add, s, bucket_cost, bin_label)
    if "dp_ovb" in s:  # T13 and T10 at the data-parallel OVB's shapes
        dp_ovb_cases(add, s, bucket_cost)
    if "dp_join" in s:  # X10a on a data-parallel learner's join slices
        dp_join_cases(add, s)
    return cases


def tp_tensors(learner, state) -> dict:
    """T1-T4's inputs at the feature-sharded batch VB's shapes (ML-1M, K =
    20, one data shard) from a real init: every shard of Sf = 2 feature
    shards, then the one of Sf = 1, each with its tables, patch table and
    plan; the caches qt as the feature all-reduce leaves them (K2's twin on
    the whole table); a shard's patch table as bin 0 of T3 leaves it; and
    the same at K = 0 for the w sweep."""
    from svbfm_tpu_torch.kernels import vb_sweep as kv
    from svbfm_tpu_torch.kernels import w_sweep as kw
    from svbfm_tpu_torch.ops.forward import score_table, t_term_table
    from svbfm_tpu_torch.parallel.tp_vb import _build_tp_plan, local_plan

    from svbfm_tpu_torch.kernels import mcmc_sweep as km

    cfg = learner.cfg
    D, K = cfg.num_attributes, cfg.num_factor
    G = cfg.num_groups
    dev = state.e.device
    row = learner.train_row
    full = torch.zeros(D, 5 * K + 2, device=dev)
    full[:, :K], full[:, K:2 * K] = state.mu_v.T, state.sigma_v_dash.T
    qt = torch.cat(kv.vb_build_qt_plain(full, K, row.ids, row.vals), 1)
    # T5-T8's: the block's q of the whole v (X8d's twin), seeded group
    # priors and [K, D] / [D] noise tables
    gfull = torch.cat([state.mu_v.T, torch.zeros(D, K, device=dev)], 1)
    gq = kv.build_q_plain(gfull, K, row.ids, row.vals)
    gen = torch.Generator().manual_seed(SEED + 1)

    def rand(*shape, lo=None, hi=None):
        u = (torch.randn(shape, generator=gen) if lo is None else
             lo + (hi - lo) * torch.rand(shape, generator=gen))
        return u.to(dev)
    pri = dict(mu=0.1 * rand(G, K), lam=rand(G, K, lo=0.5, hi=2.0),
               w_mu=0.1 * rand(G), w_lam=rand(G, lo=0.5, hi=2.0),
               z=rand(K, D), zw=rand(D))
    shards = []
    for Sf in (2, 1):
        plan_np, D_loc = _build_tp_plan((1, Sf), learner.plan, learner.meta,
                                        D)

        def cut(a, f):  # the shard's slice of a table over the last dim
            a = torch.nn.functional.pad(a, (0, D_loc * Sf - a.shape[-1]))
            return a[..., f * D_loc:(f + 1) * D_loc].contiguous()

        for f in range(Sf):
            mu_v, sig_v = cut(state.mu_v, f), cut(state.sigma_v_dash, f)
            mu_w, sig_w = cut(state.mu_w, f), cut(state.sigma_w_dash, f)
            ptab = torch.zeros(D_loc, 5 * K + 2, device=dev)
            ptab[:, :K], ptab[:, K:2 * K] = mu_v.T, sig_v.T
            pl = local_plan(plan_np, 0, f, dev)
            sh = dict(Sf=Sf, f=f, lo=f * D_loc, D_loc=D_loc, plan=pl,
                      stab=score_table(mu_w, mu_v),
                      ttab=t_term_table(sig_w, mu_v, sig_v), ptab=ptab,
                      mu_t=mu_v.T.contiguous(), sig_t=sig_v.T.contiguous(),
                      mu_w=mu_w, sig_w=sig_w)
            # bin 0 of T3 on the twins: the patch table T4 reads
            pt, mt, st = ptab.clone(), sh["mu_t"].clone(), sh["sig_t"].clone()
            mw, sw = mu_w.clone(), sig_w.clone()
            nans = torch.zeros(2, dtype=torch.int32, device=dev)
            for b in pl.blocks[0]:
                acc = kv.tp_col_stats_plain(b.rows, b.x, b.cols, D_loc,
                                            state.e, qt, pt, K)
                kv.tp_col_update_plain(acc, b.cols, D_loc, b.group, b.sx2,
                                       pt, mt, st, state.sigma_v,
                                       state.alpha,
                                       (mw, sw, state.sigma_w), nans)
            sh["ptab_patch"] = pt
            # K = 0: bin 0 of the w sweep's stats and update, its dtab
            acc = torch.zeros(D_loc, device=dev)
            kw.tp_w_stats_plain(pl.blocks[0], state.e, acc, D_loc)
            dtab = torch.zeros(D_loc, 2, device=dev)
            kw.tp_w_update_plain(pl.blocks[0], acc, D_loc, mu_w.clone(),
                                 sig_w.clone(), state.sigma_w, state.alpha,
                                 dtab, _bad(dev))
            sh["w_acc"], sh["dtab"] = acc, dtab
            # T5-T8: the shard's v as the block's patch table (v | 0), its
            # noise, and the patch table as bin 0's twins leave it (F = K;
            # factor 0 alone for F = 1)
            vt = mu_v.T.contiguous()
            gb = dict(vt=vt, ptab=torch.cat([vt, torch.zeros_like(vt)], 1),
                      z=cut(pri["z"], f), zw=cut(pri["zw"], f))
            pt, v2 = gb["ptab"].clone(), vt.clone()
            for b in pl.blocks[0]:
                acc = km.tp_col_draw_stats_plain(b.rows, b.x, b.cols, D_loc,
                                                 state.e, gq, gb["ptab"], K,
                                                 True)
                km.tp_col_draw_plain(acc, b.cols, b.group, D_loc, pt, v2,
                                     pri["mu"], pri["lam"], state.alpha,
                                     gb["z"], True, _bad(dev)[:2])
            gb["ptab_patch"] = pt
            gb.update(vt1=vt[:, :1].contiguous(),
                      ptab1=gb["ptab"][:, [0, K]].contiguous(),
                      ptab1_patch=pt[:, [0, K]].contiguous(),
                      z1=gb["z"][:1].contiguous())
            sh["gibbs"] = gb
            shards.append(sh)
    return dict(tag="tp", tp=shards, K=K, D=D, ids=row.ids, vals=row.vals,
                eval_ids=learner.test_row.ids,
                eval_vals=learner.test_row.vals, e=state.e, qt=qt,
                w0=state.mu_0, s0=state.sigma_0_dash, sv=state.sigma_v,
                sigma_w=state.sigma_w, alpha=state.alpha, full_ptab=full,
                gq=gq, gq1=gq[:, :1].contiguous(),
                **{f"pri_{k}": v for k, v in pri.items()},
                pri_mu1=pri["mu"][:, :1].contiguous(),
                pri_lam1=pri["lam"][:, :1].contiguous())


def tp_cases(add, s: dict, bucket_cost, bin_cost, bin_label) -> None:
    """T1-T4 on each shard of Sf = 2 and Sf = 1, each against its twin
    (timed on the first shard of each: the JSON line's is Sf = 2's); and
    at Sf = 2 the shards' partials, summed, against the unsharded kernels
    (K1a, K1b, K2, K4 and the w patch: kernel against kernel)."""
    from svbfm_tpu_torch.kernels import fm_forward as k1
    from svbfm_tpu_torch.kernels import mcmc_sweep as km
    from svbfm_tpu_torch.kernels import vb_sweep as kv
    from svbfm_tpu_torch.kernels import w_sweep as kw
    from svbfm_tpu_torch.parallel.tp import (scores_from_partials,
                                             t_terms_from_partials)

    K = s["K"]
    dev = s["e"].device

    def nothing():
        return ()

    def twin(fn_k, fn_p, *args):
        def call(variant, _):
            out = (fn_k if variant == "kernel" else fn_p)(*args)
            return [out]
        return call

    def rows_in(ids, sh):  # the positions whose ids the shard holds
        loc = ids.long() - sh["lo"]
        return int(((loc >= 0) & (loc < sh["D_loc"])).sum())

    for sh in s["tp"]:
        Sf, f, lo, D_loc = sh["Sf"], sh["f"], sh["lo"], sh["D_loc"]
        tag = f"Sf={Sf} shard {f}"
        timed = f == 0
        for what, ids, vals in (("train", s["ids"], s["vals"]),
                                ("test", s["eval_ids"], s["eval_vals"])):
            N, P = ids.shape
            n_in = rows_in(ids, sh)
            for t_terms, tab in ((False, sh["stab"]), (True, sh["ttab"])):
                if t_terms and what == "test":
                    continue
                ch = k1.tp_channels(K, t_terms)
                ids64 = (ids.long() - lo).clamp(0, D_loc - 1)
                wts = torch.where((ids.long() >= lo) & (ids.long() < lo
                                                        + D_loc), vals,
                                  torch.zeros((), device=dev))
                dense = tab.contiguous()
                c = cost(N * P * 8 + tab.shape[0] * tab.shape[1] * 4
                         + N * ch * 4, n_in * (9 * K + 2 if t_terms
                                               else 4 * K + 2),
                         lambda ids64=ids64, dense=dense, wts=wts:
                         torch.nn.functional.embedding_bag(
                             ids64, dense, per_sample_weights=wts,
                             mode="sum"))
                add("tp_fm_partials",
                    f"{tag} {'t_terms' if t_terms else 'scores'} {what} "
                    f"N={N}", nothing,
                    twin(k1.tp_fm_partials, k1.tp_fm_partials_plain, tab, K,
                         t_terms, ids, vals, lo, D_loc),
                    c if timed else None)
        N, P = s["ids"].shape
        n_in = rows_in(s["ids"], sh)
        add("tp_build_qt", f"{tag} F={K}", nothing,
            twin(kv.tp_build_qt, kv.tp_build_qt_plain, sh["ptab"], K,
                 s["ids"], s["vals"], lo, D_loc),
            cost(N * P * 8 + D_loc * 2 * K * 4 + N * 3 * K * 4,
                 n_in * K * 6) if timed else None)

        def k3_prepare(sh=sh):
            return _clones(sh, "mu_t", "sig_t", "ptab", "mu_w", "sig_w") + (
                torch.zeros(2, dtype=torch.int32, device=dev),)

        def stats(b, sh=sh):
            return twin(kv.tp_col_stats, kv.tp_col_stats_plain, b.rows, b.x,
                        b.cols, sh["D_loc"], s["e"], s["qt"], sh["ptab"], K)

        def update(b, acc, sh=sh):
            def call(variant, inp):
                fn = (kv.tp_col_update if variant == "kernel"
                      else kv.tp_col_update_plain)
                mu_t, sig_t, ptab, mu_w, sig_w, nans = inp
                fn(acc, b.cols, sh["D_loc"], b.group, b.sx2, ptab, mu_t,
                   sig_t, s["sv"], s["alpha"], (mu_w, sig_w, s["sigma_w"]),
                   nans)
                return [mu_t, sig_t, ptab, mu_w, sig_w, nans]
            return call

        every = sorted((b for bb in sh["plan"].blocks for b in bb),
                       key=lambda b: -b.rows.numel())
        for i, b in enumerate(every):
            C, L = b.rows.shape
            bd = dict(rows=b.rows, x=b.x)
            acc = kv.tp_col_stats_plain(b.rows, b.x, b.cols, D_loc, s["e"],
                                        s["qt"], sh["ptab"], K)
            first = timed and i == 0
            add("tp_col_stats", f"{tag} F={K} [{C},{L}]", nothing, stats(b),
                bucket_cost(bd, 1 + 2 * K, 2 * K + 2 * K + 1, 12 * K + 2)
                if first else None)
            # (the update's and the w sweep's twins pick the real columns
            # by a mask, which synchronises: timed host-paced)
            add("tp_col_update", f"{tag} F={K} [{C},{L}]", k3_prepare,
                update(b, acc),
                # a column reads acc (2K + 1), cols/group/sx2, ptab's
                # mu/sig (2K) and mu_w/sig_w; writes mu_t/sig_t (2K),
                # ptab's deltas (3K) and the w pair and its deltas; the
                # [G, K] sv and sigma_w [G] once
                cost(C * ((2 * K + 1) + 3 + 2 * K + 2) * 4
                     + C * (5 * K + 4) * 4
                     + s["sv"].shape[0] * (K + 1) * 4, C * (8 * K + 8),
                     plain_graph=False) if first else None)
        add("tp_patch_delta", f"{tag} F={K} bin 0", nothing,
            twin(kv.tp_patch_delta, kv.tp_patch_delta_plain,
                 sh["ptab_patch"], K, True, s["ids"], s["vals"], s["qt"], lo,
                 D_loc),
            cost(N * P * 8 + D_loc * (5 * K + 2) * 4 + N * 3 * K * 4
                 + N * (3 * K + 2) * 4, n_in * K * 20) if timed else None)
        # K = 0: the standalone w sweep's stats and update on bin 0, and
        # T4's w patch
        bins = sh["plan"].blocks[0]

        def w_stats(variant, inp, sh=sh, bins=bins):
            fn = kw.tp_w_stats if variant == "kernel" else kw.tp_w_stats_plain
            (acc,) = inp
            fn(bins, s["e"], acc, sh["D_loc"])
            return [acc]

        def w_update(variant, inp, sh=sh, bins=bins):
            fn = (kw.tp_w_update if variant == "kernel"
                  else kw.tp_w_update_plain)
            mu_w, sig_w, dtab, bad = inp
            fn(bins, sh["w_acc"], sh["D_loc"], mu_w, sig_w, s["sigma_w"],
               s["alpha"], dtab, bad)
            return [mu_w, sig_w, dtab, bad]

        C = sum(b.rows.shape[0] for b in bins)
        c = bin_cost(bins, 1, 2)
        c["plain_graph"] = False
        add("tp_w_stats", f"{tag} {bin_label(bins)}",
            lambda D_loc=D_loc: (torch.zeros(D_loc, device=dev),), w_stats,
            c if timed else None)
        add("tp_w_update", f"{tag} {bin_label(bins)}",
            lambda sh=sh: _clones(sh, "mu_w", "sig_w") + (
                torch.zeros(sh["D_loc"], 2, device=dev), _bad(dev)),
            w_update, cost(C * 16 + C * 4 * 6, C * 10, plain_graph=False)
            if timed else None)
        add("tp_patch_delta", f"{tag} F=0 bin 0", nothing,
            twin(kv.tp_patch_delta, kv.tp_patch_delta_plain, sh["dtab"], 0,
                 True, s["ids"], s["vals"], None, lo, D_loc), None)
        tp_mcmc_cases(add, s, sh, every, bins, C, bucket_cost, bin_label,
                      timed)

    # the shards of Sf = 2 summed against the unsharded kernels
    two = [sh for sh in s["tp"] if sh["Sf"] == 2]

    def summed(part):
        return sum(part(sh) for sh in two)

    def t1_vs_k1(t_terms):
        def call(variant, _):
            if variant == "kernel":
                tot = summed(lambda sh: k1.tp_fm_partials(
                    sh["ttab" if t_terms else "stab"], K, t_terms, s["ids"],
                    s["vals"], sh["lo"], sh["D_loc"]))
                if t_terms:
                    return [t_terms_from_partials(tot, s["s0"], K)]
                return [scores_from_partials(tot, s["w0"], K)]
            from svbfm_tpu_torch.ops.forward import score_table, t_term_table
            full = [torch.cat([sh[k] for sh in two])[:s["D"]]
                    for k in ("mu_t", "sig_t")]
            mu_w = torch.cat([sh["mu_w"] for sh in two])[:s["D"]]
            sig_w = torch.cat([sh["sig_w"] for sh in two])[:s["D"]]
            if t_terms:
                return [k1.fm_t_terms_op(t_term_table(
                    sig_w, full[0].T, full[1].T), s["s0"], s["ids"],
                    s["vals"])]
            return [k1.fm_scores_op(score_table(mu_w, full[0].T), s["w0"],
                                    s["ids"], s["vals"])]
        return call

    add("tp_fm_partials", "Sf=2 summed scores vs K1a", nothing,
        t1_vs_k1(False), None)
    add("tp_fm_partials", "Sf=2 summed t_terms vs K1b", nothing,
        t1_vs_k1(True), None)

    def t2_vs_k2(variant, _):
        if variant == "kernel":
            return [summed(lambda sh: kv.tp_build_qt(
                sh["ptab"], K, s["ids"], s["vals"], sh["lo"], sh["D_loc"]))]
        return [torch.cat(kv.vb_build_qt(s["full_ptab"], K, s["ids"],
                                         s["vals"]), 1)]

    add("tp_build_qt", "Sf=2 summed vs K2", nothing, t2_vs_k2, None)

    def t4_vs_k4(variant, _):
        if variant == "kernel":
            return list(kv.tp_patch_views(summed(lambda sh: kv.tp_patch_delta(
                sh["ptab_patch"], K, True, s["ids"], s["vals"], s["qt"],
                sh["lo"], sh["D_loc"])), s["ids"].shape[0], K))
        pt = torch.cat([sh["ptab_patch"] for sh in two])[:s["D"]]
        q, tq, tz = (s["qt"][:, i * K:(i + 1) * K].clone() for i in range(3))
        e = torch.zeros_like(s["e"])
        t = torch.zeros_like(s["e"])
        kv.vb_patch_rows(pt.contiguous(), K, True, s["ids"], s["vals"], q,
                         tq, tz, e, t)
        return [torch.cat([q, tq, tz], 1) - s["qt"], e, t]

    add("tp_patch_delta", "Sf=2 summed vs K4", nothing, t4_vs_k4, None)

    def t6_vs_x8d(variant, _):
        if variant == "kernel":
            return [summed(lambda sh: kv.tp_build_q(
                sh["gibbs"]["ptab"], K, s["ids"], s["vals"], sh["lo"],
                sh["D_loc"]))]
        pt = torch.cat([sh["gibbs"]["ptab"] for sh in two])[:s["D"]]
        return [kv.build_q(pt.contiguous(), K, s["ids"], s["vals"])]

    add("tp_build_q", "Sf=2 summed vs X8d", nothing, t6_vs_x8d, None)

    def t8_vs_x8b(variant, _):
        N = s["ids"].shape[0]
        if variant == "kernel":
            return list(km.tp_mcmc_patch_views(summed(
                lambda sh: km.tp_mcmc_patch_delta(
                    sh["gibbs"]["ptab_patch"], K, s["ids"], s["vals"],
                    s["gq"], sh["lo"], sh["D_loc"])), N, K))
        pt = torch.cat([sh["gibbs"]["ptab_patch"] for sh in two])[:s["D"]]
        q, e = s["gq"].clone(), torch.zeros_like(s["e"])
        km.mcmc_patch_rows(pt.contiguous(), K, s["ids"], s["vals"], q, e)
        return [s["gq"] - q, -e]

    add("tp_mcmc_patch_delta", "Sf=2 summed vs X8b", nothing, t8_vs_x8b,
        None)


def tp_ovb_tensors(ovb, state) -> dict:
    """T9, T10, and T1, T2 at F = 1 and T4 at F = 1 and 0, at the
    feature-sharded OVB's shapes: chunk 0 of the resident learner ``ovb``'s
    membership (ML-1M, K = 20, 20 chunks: N = 50,002), factor 0, from a
    real init; the shard of Sf = 1 (the world of one's: the JSON line's),
    then each of Sf = 2, with its chunk plan (local ids, padding columns),
    its cut tables, each bin's sums as T9's and T10's stats twins give them
    (one data shard: nothing to all-reduce), and the patch tables as bin 0
    of T9's and T10's blend twins leaves them."""
    from svbfm_tpu_torch.data.dataset import SparseDataset, SweepPlan
    from svbfm_tpu_torch.kernels import ovb_sweep as ko
    from svbfm_tpu_torch.kernels import vb_sweep as kv
    from svbfm_tpu_torch.kernels import w_sweep as kw
    from svbfm_tpu_torch.ops.forward import (fm_scores, score_table,
                                             t_term_table)
    from svbfm_tpu_torch.parallel.tp_vb import _build_tp_plan, local_plan

    cfg, meta, train = ovb.cfg, ovb.meta, ovb._train_ds
    D, K = cfg.num_attributes, cfg.num_factor
    row, _ = ovb.chunks[0]
    dev = row.ids.device
    idx = np.array_split(ovb.member_perm, ovb.num_chunks)[0]
    sub = SparseDataset(
        ids=train.ids[idx], vals=train.vals[idx], target=train.target[idx],
        num_rows=len(idx), num_features=D, min_target=train.min_target,
        max_target=train.max_target, row_nnz=train.row_nnz[idx])
    plan = SweepPlan.build(sub.to_coo(), D, meta_groups=meta.attr_group,
                           col_count=ovb.col_count)
    e = row.target - fm_scores(state.mu_0, state.mu_w, state.mu_v, row.ids,
                               row.vals)
    full = torch.zeros(D, 5, device=dev)
    full[:, 0], full[:, 1] = state.mu_v[0], state.sigma_v_dash[0]
    qt = torch.cat(kv.vb_build_qt_plain(full, 1, row.ids, row.vals), 1)
    sv = state.sigma_v[:, :1].contiguous()
    shards = []
    for Sf in (1, 2):
        plan_np, D_loc = _build_tp_plan((1, Sf), plan, meta, D)

        def cut(a, f):  # the shard's slice of a table over the last dim
            a = torch.nn.functional.pad(a, (0, D_loc * Sf - a.shape[-1]))
            return a[..., f * D_loc:(f + 1) * D_loc].contiguous()

        for f in range(Sf):
            pl = local_plan(plan_np, 0, f, dev)
            mu_v, sig_v = cut(state.mu_v, f), cut(state.sigma_v_dash, f)
            mu_w, sig_w = cut(state.mu_w, f), cut(state.sigma_w_dash, f)
            ptab = torch.zeros(D_loc, 5, device=dev)
            ptab[:, 0], ptab[:, 1] = mu_v[0], sig_v[0]
            sh = dict(
                Sf=Sf, f=f, lo=f * D_loc, D_loc=D_loc, blocks=pl.blocks,
                bins=[ko.BinPlan(bb) for bb in pl.blocks],
                stab=score_table(mu_w, mu_v),
                ttab=t_term_table(sig_w, mu_v, sig_v), ptab=ptab,
                mu=mu_v[:1].T.contiguous(), sig=sig_v[:1].T.contiguous(),
                nmu=cut(state.n_mu_v, f)[:1].T.contiguous(),
                nsig=cut(state.n_sig_v, f)[:1].T.contiguous(),
                rho_v=(1.0 + cut(state.t_vj, f)) ** -0.5, mu_w=mu_w,
                sig_w=sig_w, nmu_w=cut(state.n_mu_w, f),
                nsig_w=cut(state.n_sig_w, f), t_wj=cut(state.t_wj, f))
            sh["rho_w"] = (1.0 + sh["t_wj"]) ** -0.5
            sh["sums"] = [ko.tp_ovb_stats_plain(b, D_loc, e, qt, ptab)
                          for b in sh["bins"]]
            sh["w_acc"] = []
            for bb in pl.blocks:
                acc = torch.zeros(D_loc, device=dev)
                kw.tp_w_ovb_stats_plain(bb, e, mu_w, acc, D_loc)
                sh["w_acc"].append(acc)
            pt = ptab.clone()
            ko.tp_ovb_blend_plain(
                sh["bins"][0], D_loc, sh["sums"][0], pt, *_clones(
                    sh, "mu", "sig", "nmu", "nsig"), sv, state.alpha,
                sh["rho_v"], None, _bad(dev))
            dtab = torch.zeros(D_loc, 2, device=dev)
            kw.tp_w_ovb_blend_plain(
                pl.blocks[0], sh["w_acc"][0], D_loc, mu_w.clone(),
                sig_w.clone(), state.sigma_w, state.alpha, dtab, _bad(dev),
                (sh["nmu_w"].clone(), sh["nsig_w"].clone(), sh["rho_w"],
                 sh["t_wj"].clone()))
            sh.update(ptab_patch=pt, dtab=dtab)
            shards.append(sh)
    return dict(tag="tp-ovb", tp_ovb=shards, K=K, ids=row.ids,
                vals=row.vals, e=e, qt=qt, sv=sv, sigma_w=state.sigma_w,
                alpha=state.alpha)


def ragged_tp_ovb_tensors(device) -> dict:
    """T9 and T10 (and the chunk's T1, T2, T4) on a small problem of odd D
    (the second of two feature shards holds a padding column, buckets
    padding columns), 3 chunks at K = 3: ``tp_ovb_tensors`` of an OVB
    init, each shard's eta2 of factor 0 and of w NaN at its local column 1
    (NaN candidates, counted)."""
    from svbfm_tpu_torch.data.dataset import SparseDataset
    from svbfm_tpu_torch.data.meta import DataMetaInfo
    from svbfm_tpu_torch.data.synth import (make_movielens_like,
                                            train_test_split)
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.vb_online import OVBLearner

    coo = make_movielens_like(37, 26, 900, rank=2, noise=0.4, seed=5)
    tr, te = train_test_split(coo, 0.2, seed=6)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 37])
    cfg = FMConfig(num_attributes=D, num_factor=3, num_groups=2, seed=SEED,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()), num_batches=3)
    lr = OVBLearner(cfg, SparseDataset.from_coo(tr, D),
                    SparseDataset.from_coo(te, D), meta, device=device,
                    write_files=False)
    s = tp_ovb_tensors(lr, lr.init_state())
    for sh in s["tp_ovb"]:
        sh["nsig"][1] = float("nan")
        sh["nsig_w"][1] = float("nan")
    s.update(tag="tp-ovb-ragged", timed=False)
    return s


def tp_ovb_cases(add, s: dict, bucket_cost, bin_label) -> None:
    """On each shard of the OVB chunk (Sf = 1, then 2), each against its
    twin: T1's partials of the chunk's rows, T2 at F = 1, T9's stats and
    blend launches and T10's on every bin, T4 at F = 1 and 0 on bin 0's
    patch tables.  Timed on the first shard of each Sf; the JSON line's
    are Sf = 1's (the world of one's) for T9 and T10."""
    from svbfm_tpu_torch.kernels import fm_forward as k1
    from svbfm_tpu_torch.kernels import ovb_sweep as ko
    from svbfm_tpu_torch.kernels import vb_sweep as kv
    from svbfm_tpu_torch.kernels import w_sweep as kw

    K, e, qt = s["K"], s["e"], s["qt"]
    ids, vals = s["ids"], s["vals"]
    N, P = ids.shape
    dev = e.device
    G = s["sv"].shape[0]

    def nothing():
        return ()

    def twin(fn_k, fn_p, *args):
        def call(variant, _):
            return [(fn_k if variant == "kernel" else fn_p)(*args)]
        return call

    def bin_stats_cost(bins, per_entry, per_col, flops, plain_graph=True):
        parts = [bucket_cost(dict(rows=b.rows, x=b.x), per_entry, per_col,
                             flops) for b in bins]
        return cost(sum(c["bytes"] for c in parts),
                    sum(c["flops"] for c in parts), plain_graph=plain_graph)

    for sh in s["tp_ovb"]:
        Sf, f, lo, D_loc = sh["Sf"], sh["f"], sh["lo"], sh["D_loc"]
        tag = f"Sf={Sf} shard {f}"
        timed = f == 0
        loc = ids.long() - lo
        n_in = int(((loc >= 0) & (loc < D_loc)).sum())
        ids64 = loc.clamp(0, D_loc - 1)
        wts = torch.where((loc >= 0) & (loc < D_loc), vals,
                          torch.zeros((), device=dev))
        for t_terms, tab in ((False, sh["stab"]), (True, sh["ttab"])):
            ch = k1.tp_channels(K, t_terms)
            dense = tab.contiguous()
            add("tp_fm_partials",
                f"{tag} ovb-chunk {'t_terms' if t_terms else 'scores'} "
                f"N={N}", nothing,
                twin(k1.tp_fm_partials, k1.tp_fm_partials_plain, tab, K,
                     t_terms, ids, vals, lo, D_loc),
                cost(N * P * 8 + tab.shape[0] * tab.shape[1] * 4 + N * ch * 4,
                     n_in * (9 * K + 2 if t_terms else 4 * K + 2),
                     lambda dense=dense: torch.nn.functional.embedding_bag(
                         ids64, dense, per_sample_weights=wts, mode="sum"))
                if timed else None)
        add("tp_build_qt", f"{tag} F=1 ovb-chunk N={N}", nothing,
            twin(kv.tp_build_qt, kv.tp_build_qt_plain, sh["ptab"], 1, ids,
                 vals, lo, D_loc),
            cost(N * P * 8 + D_loc * 2 * 4 + N * 3 * 4, n_in * 6)
            if timed else None)
        for i, (plan, bb) in enumerate(zip(sh["bins"], sh["blocks"])):
            label = f"{tag} {bin_label(bb)}"
            C = plan.num_cols
            # T9, stats: per entry e, q, tq gathered; per column its id,
            # ptab's mu/sig and the two sums written
            add("tp_ovb_stats", label, nothing,
                twin(ko.tp_ovb_stats, ko.tp_ovb_stats_plain, plan, D_loc, e,
                     qt, sh["ptab"]),
                bin_stats_cost(bb, 3, 5, 15) if timed else None)

            def v_blend(variant, inp, plan=plan, i=i, sh=sh):
                fn = (ko.tp_ovb_blend if variant == "kernel"
                      else ko.tp_ovb_blend_plain)
                ptab, mu, sig, nmu, nsig, tv, bad = inp
                fn(plan, sh["D_loc"], sh["sums"][i], ptab, mu, sig, nmu,
                   nsig, s["sv"], s["alpha"], sh["rho_v"], tv, bad)
                return list(inp)

            # (the blend twins pick the real columns by a mask, which
            # synchronises: timed host-paced)
            # T9, blend: a column reads its id, cnt, col_count, group, two
            # sums, ptab's mu/sig, rho, eta1, eta2 and tv_add, and writes
            # the four tables, three deltas and tv_add; sigma_v [G] once
            add("tp_ovb_blend", label,
                lambda sh=sh: _clones(sh, "ptab", "mu", "sig", "nmu",
                                      "nsig") + (
                    torch.zeros(sh["D_loc"], device=dev), _bad(dev)),
                v_blend, cost(C * 20 * 4 + G * 4, C * 25, plain_graph=False)
                if timed else None)

            def w_stats(variant, inp, bb=bb, sh=sh):
                fn = (kw.tp_w_ovb_stats if variant == "kernel"
                      else kw.tp_w_ovb_stats_plain)
                (acc,) = inp
                fn(bb, e, sh["mu_w"], acc, sh["D_loc"])
                return [acc]

            def w_blend(variant, inp, bb=bb, i=i, sh=sh):
                fn = (kw.tp_w_ovb_blend if variant == "kernel"
                      else kw.tp_w_ovb_blend_plain)
                mu_w, sig_w, nmu_w, nsig_w, t_wj, dtab, bad = inp
                fn(bb, sh["w_acc"][i], sh["D_loc"], mu_w, sig_w,
                   s["sigma_w"], s["alpha"], dtab, bad,
                   (nmu_w, nsig_w, sh["rho_w"], t_wj))
                return list(inp)

            # T10, stats: per entry e; per column its id, mu_w and the sum
            add("tp_w_ovb_stats", label,
                lambda sh=sh: (torch.zeros(sh["D_loc"], device=dev),),
                w_stats, bin_stats_cost(bb, 1, 3, 4, plain_graph=False)
                if timed else None)
            # T10, blend: a column reads its id, group, sx2, cnt,
            # col_count, acc, mu, sig, rho, eta1, eta2 and t_wj, and writes
            # eta1, eta2, t_wj, mu, sig and its two deltas; sigma_w [G] once
            add("tp_w_ovb_blend", label,
                lambda sh=sh: _clones(sh, "mu_w", "sig_w", "nmu_w", "nsig_w",
                                      "t_wj") + (
                    torch.zeros(sh["D_loc"], 2, device=dev), _bad(dev)),
                w_blend, cost(C * 19 * 4 + G * 4, C * 20, plain_graph=False)
                if timed else None)
        add("tp_patch_delta", f"{tag} F=1 ovb-chunk bin 0", nothing,
            twin(kv.tp_patch_delta, kv.tp_patch_delta_plain,
                 sh["ptab_patch"], 1, False, ids, vals, qt, lo, D_loc),
            cost(N * P * 8 + D_loc * 5 * 4 + N * 3 * 4 + N * 5 * 4,
                 n_in * 20) if timed else None)
        add("tp_patch_delta", f"{tag} F=0 ovb-chunk bin 0", nothing,
            twin(kv.tp_patch_delta, kv.tp_patch_delta_plain, sh["dtab"], 0,
                 True, ids, vals, None, lo, D_loc), None)


def tp_mcmc_cases(add, s: dict, sh: dict, every, bins, C: int, bucket_cost,
                  bin_label, timed: bool) -> None:
    """T5-T8 on one feature shard against their twins: T5 on bin 0 from
    T3's K = 0 sums; T6 at F = K; T7's stats and draw launches on every
    bucket at F = K (exact), and on the widest bucket also factor-Jacobi
    and F = 1; T8 at F = K and F = 1 on bin 0's patch table.  The timed
    cases (``timed``) are the JSON line's."""
    from svbfm_tpu_torch.kernels import mcmc_sweep as km
    from svbfm_tpu_torch.kernels import vb_sweep as kv
    from svbfm_tpu_torch.kernels import w_sweep as kw

    K = s["K"]
    dev = s["e"].device
    Sf, f, lo, D_loc = sh["Sf"], sh["f"], sh["lo"], sh["D_loc"]
    tag = f"Sf={Sf} shard {f}"
    gb = sh["gibbs"]
    ids, vals = s["ids"], s["vals"]
    N, P = ids.shape
    G = s["pri_mu"].shape[0]
    loc = ids.long() - lo
    inr = (loc >= 0) & (loc < D_loc)
    n_in = int(inr.sum())

    def nothing():
        return ()

    def twin(fn_k, fn_p, *args):
        def call(variant, _):
            return [(fn_k if variant == "kernel" else fn_p)(*args)]
        return call

    # T5: X8c's draw from the bin's data-summed column sums
    def t5(variant, inp):
        fn = kw.tp_w_draw if variant == "kernel" else kw.tp_w_draw_plain
        w, dtab, bad = inp
        fn(bins, sh["w_acc"], D_loc, w, s["pri_w_mu"], s["pri_w_lam"],
           s["alpha"], gb["zw"], dtab, bad)
        return [w, dtab, bad]

    # a column reads its sum, cols/group/sx2, w and z, writes w and the
    # delta pair; the [G] priors once (the twin masks: host-paced)
    add("tp_w_draw", f"{tag} {bin_label(bins)}",
        lambda: (sh["mu_w"].clone(), torch.zeros(D_loc, 2, device=dev),
                 torch.zeros(4, dtype=torch.int32, device=dev)), t5,
        cost(C * 4 * 9 + G * 8, C * 12, plain_graph=False)
        if timed else None)

    # T6: the shard's q partials
    ids64 = loc.clamp(0, D_loc - 1)
    wts = torch.where(inr, vals, torch.zeros((), device=dev))
    add("tp_build_q", f"{tag} F={K} N={N}", nothing,
        twin(kv.tp_build_q, kv.tp_build_q_plain, gb["ptab"], K, ids, vals,
             lo, D_loc),
        cost(N * P * 8 + D_loc * K * 4 + N * K * 4, n_in * K * 2,
             lambda: torch.nn.functional.embedding_bag(
                 ids64, gb["vt"], per_sample_weights=wts, mode="sum"))
        if timed else None)

    # T7: the stats launch, then the draw from the twin's sums
    def draw(b, acc, F, exact, ptab, vt, mu, lam, z):
        def call(variant, inp):
            fn = km.tp_col_draw if variant == "kernel" else km.tp_col_draw_plain
            pt, v, nans = inp
            fn(acc, b.cols, b.group, D_loc, pt, v, mu, lam, s["alpha"], z,
               exact, nans)
            return [pt, v, nans]

        def prepare():
            return (ptab.clone(), vt.clone(),
                    torch.zeros(2, dtype=torch.int32, device=dev))
        return prepare, call

    for i, b in enumerate(every):
        Cb, L = b.rows.shape
        bd = dict(rows=b.rows, x=b.x)
        modes = [(K, True, gb["ptab"], gb["vt"], s["gq"], s["pri_mu"],
                  s["pri_lam"], gb["z"])]
        if i == 0:
            modes += [(K, False, gb["ptab"], gb["vt"], s["gq"], s["pri_mu"],
                       s["pri_lam"], None),
                      (1, True, gb["ptab1"], gb["vt1"], s["gq1"],
                       s["pri_mu1"], s["pri_lam1"], gb["z1"])]
        for F, exact, ptab, vt, q, mu, lam, z in modes:
            mode = ("exact" if exact else "jacobi") + (
                "+z" if z is not None else "")
            nout = km.tp_col_outputs(F, exact)
            first = timed and i == 0 and F == K and exact
            # stats: a real entry gathers e and q's F floats; a column
            # reads its id and v (F) and writes its nout sums
            add("tp_col_draw_stats", f"{tag} F={F} {mode} [{Cb},{L}]",
                nothing, twin(km.tp_col_draw_stats,
                              km.tp_col_draw_stats_plain, b.rows, b.x,
                              b.cols, D_loc, s["e"], q, ptab, F, exact),
                bucket_cost(bd, 1 + F, 1 + F + nout,
                            6 * F + (F * (F - 1) if exact else 0))
                if first else None)
            acc = km.tp_col_draw_stats_plain(b.rows, b.x, b.cols, D_loc,
                                             s["e"], q, ptab, F, exact)
            # draw: a column reads its sums, id, group, v and the priors
            # and z (3F), writes v and dv; the sequential draw's F^2 / 2
            # multiply-adds (the twin solves on the host: host-paced)
            add("tp_col_draw", f"{tag} F={F} {mode} [{Cb},{L}]",
                *draw(b, acc, F, exact, ptab, vt, mu, lam, z),
                cost(Cb * (nout + 2 + 4 * F + 2 * F) * 4,
                     Cb * (F * F + 10 * F), plain_graph=False)
                if first else None)

    # T8: bin 0's patch against the pre-patch q
    for F, pt, q in ((K, gb["ptab_patch"], s["gq"]),
                     (1, gb["ptab1_patch"], s["gq1"])):
        add("tp_mcmc_patch_delta", f"{tag} F={F} bin 0", nothing,
            twin(km.tp_mcmc_patch_delta, km.tp_mcmc_patch_delta_plain, pt, F,
                 ids, vals, q, lo, D_loc),
            cost(N * P * 8 + D_loc * 2 * F * 4 + N * F * 4
                 + N * (F + 1) * 4, n_in * F * 6)
            if timed and F == K else None)


def dp_tensors(learner, state, gibbs, gstate) -> dict:
    """T3, T3 at K = 0, T5 and T7's inputs at the data-parallel replicated
    learners' shapes (``VBLearner``/``MCMCLearner(mesh=)``: ML-1M's
    buckets of the resident plan, lo = 0, D_loc = D, one data shard) from
    a real init: for F = 1, 4 (exact mode's factor blocks; F = 20 is the
    Sf = 1 shard of ``tp_tensors``) the VB patch table and T2's caches
    (K2's twin), and the Gibbs block's (v | 0) table, q (X8d's twin),
    seeded group priors and noise; the w sweep's bins."""
    from svbfm_tpu_torch.kernels import vb_sweep as kv

    cfg = learner.cfg
    D, K, G = cfg.num_attributes, cfg.num_factor, cfg.num_groups
    dev = state.e.device
    row = learner.train_row
    gen = torch.Generator().manual_seed(SEED + 2)

    def rand(*shape, lo=None, hi=None):
        u = (torch.randn(shape, generator=gen) if lo is None else
             lo + (hi - lo) * torch.rand(shape, generator=gen))
        return u.to(dev)
    widths = {}
    for F in DP_KERNEL_F:
        ptab = torch.zeros(D, 5 * F, device=dev)
        ptab[:, :F] = state.mu_v[:F].T
        ptab[:, F:2 * F] = state.sigma_v_dash[:F].T
        vt = gstate.v[:F].T.contiguous()
        gptab = torch.cat([vt, torch.zeros_like(vt)], 1)
        widths[F] = dict(
            ptab=ptab, mu_t=state.mu_v[:F].T.contiguous(),
            sig_t=state.sigma_v_dash[:F].T.contiguous(),
            sv=state.sigma_v[:, :F].contiguous(),
            qt=torch.cat(kv.vb_build_qt_plain(ptab, F, row.ids, row.vals), 1),
            vt=vt, gptab=gptab,
            gq=kv.build_q_plain(gptab, F, row.ids, row.vals),
            mu=0.1 * rand(G, F), lam=rand(G, F, lo=0.5, hi=2.0),
            z=rand(F, D))
    return dict(tag="dp", dp=widths, plan=learner.plan_data, D=D,
                e=state.e, ge=gstate.e, alpha=state.alpha,
                galpha=gstate.alpha, mu_w=state.mu_w,
                sig_w=state.sigma_w_dash, sigma_w=state.sigma_w,
                w=gstate.w, w_mu=0.1 * rand(G),
                w_lam=rand(G, lo=0.5, hi=2.0), zw=rand(D))


def dp_cases(add, s: dict, bucket_cost, bin_cost, bin_label) -> None:
    """T3 (stats, then update with no w rider) and T7 (stats, then the
    exact draw with noise) at F = 1 and 4 on every bucket of the resident
    plan, lo = 0, D_loc = D, each against its twin, timed on the widest
    bucket; T3 at K = 0 and T5 on every bin, timed on bin 0."""
    from svbfm_tpu_torch.kernels import mcmc_sweep as km
    from svbfm_tpu_torch.kernels import vb_sweep as kv
    from svbfm_tpu_torch.kernels import w_sweep as kw

    D = s["D"]
    dev = s["e"].device
    G = s["w_mu"].shape[0]
    every = sorted((b for bb in s["plan"].blocks for b in bb),
                   key=lambda b: -b.rows.numel())

    def nothing():
        return ()

    def twin(fn_k, fn_p, *args):
        def call(variant, _):
            return [(fn_k if variant == "kernel" else fn_p)(*args)]
        return call

    for F, t in s["dp"].items():
        def k3_prepare(t=t):
            return _clones(t, "mu_t", "sig_t", "ptab") + (
                torch.zeros(2, dtype=torch.int32, device=dev),)

        def update(b, acc, t=t):
            def call(variant, inp):
                fn = (kv.tp_col_update if variant == "kernel"
                      else kv.tp_col_update_plain)
                mu_t, sig_t, ptab, nans = inp
                fn(acc, b.cols, D, b.group, b.sx2, ptab, mu_t, sig_t,
                   t["sv"], s["alpha"], None, nans)
                return [mu_t, sig_t, ptab, nans]
            return call

        def draw(b, acc, t=t):
            def call(variant, inp):
                fn = (km.tp_col_draw if variant == "kernel"
                      else km.tp_col_draw_plain)
                pt, v, nans = inp
                fn(acc, b.cols, b.group, D, pt, v, t["mu"], t["lam"],
                   s["galpha"], t["z"], True, nans)
                return [pt, v, nans]
            return call

        def d_prepare(t=t):
            return (t["gptab"].clone(), t["vt"].clone(),
                    torch.zeros(2, dtype=torch.int32, device=dev))

        nout = km.tp_col_outputs(F, True)
        for i, b in enumerate(every):
            C, L = b.rows.shape
            bd = dict(rows=b.rows, x=b.x)
            first = i == 0
            add("tp_col_stats", f"F={F} [{C},{L}]", nothing,
                twin(kv.tp_col_stats, kv.tp_col_stats_plain, b.rows, b.x,
                     b.cols, D, s["e"], t["qt"], t["ptab"], F),
                bucket_cost(bd, 1 + 2 * F, 2 * F + 2 * F + 1, 12 * F + 2)
                if first else None)
            acc = kv.tp_col_stats_plain(b.rows, b.x, b.cols, D, s["e"],
                                        t["qt"], t["ptab"], F)
            # a column reads acc (2F + 1), cols/group/sx2 and ptab's mu/sig
            # (2F); writes mu_t/sig_t (2F) and ptab's deltas (3F); the
            # [G, F] sv once (the twin masks: host-paced)
            add("tp_col_update", f"F={F} [{C},{L}]", k3_prepare,
                update(b, acc),
                cost(C * ((2 * F + 1) + 3 + 2 * F) * 4 + C * 5 * F * 4
                     + G * F * 4, C * 8 * F, plain_graph=False)
                if first else None)
            add("tp_col_draw_stats", f"F={F} exact+z [{C},{L}]", nothing,
                twin(km.tp_col_draw_stats, km.tp_col_draw_stats_plain,
                     b.rows, b.x, b.cols, D, s["ge"], t["gq"], t["gptab"],
                     F, True),
                bucket_cost(bd, 1 + F, 1 + F + nout,
                            6 * F + F * (F - 1)) if first else None)
            gacc = km.tp_col_draw_stats_plain(b.rows, b.x, b.cols, D,
                                              s["ge"], t["gq"], t["gptab"],
                                              F, True)
            add("tp_col_draw", f"F={F} exact+z [{C},{L}]", d_prepare,
                draw(b, gacc),
                cost(C * (nout + 2 + 4 * F + 2 * F) * 4, C * (F * F + 10 * F),
                     plain_graph=False) if first else None)

    # the w sweep: T3's K = 0 stats and update, T5's draw, every bin
    for bi, bins in enumerate(s["plan"].blocks):
        if not bins:
            continue
        first = bi == 0
        C = sum(b.rows.shape[0] for b in bins)

        def w_stats(variant, inp, bins=bins):
            fn = kw.tp_w_stats if variant == "kernel" else kw.tp_w_stats_plain
            (acc,) = inp
            fn(bins, s["e"], acc, D)
            return [acc]

        acc = torch.zeros(D, device=dev)
        kw.tp_w_stats_plain(bins, s["e"], acc, D)
        gacc = torch.zeros(D, device=dev)
        kw.tp_w_stats_plain(bins, s["ge"], gacc, D)

        def w_update(variant, inp, bins=bins, acc=acc):
            fn = (kw.tp_w_update if variant == "kernel"
                  else kw.tp_w_update_plain)
            mu_w, sig_w, dtab, bad = inp
            fn(bins, acc, D, mu_w, sig_w, s["sigma_w"], s["alpha"], dtab,
               bad)
            return [mu_w, sig_w, dtab, bad]

        def t5(variant, inp, bins=bins, gacc=gacc):
            fn = kw.tp_w_draw if variant == "kernel" else kw.tp_w_draw_plain
            w, dtab, bad = inp
            fn(bins, gacc, D, w, s["w_mu"], s["w_lam"], s["galpha"],
               s["zw"], dtab, bad)
            return [w, dtab, bad]

        c = bin_cost(bins, 1, 2)
        c["plain_graph"] = False
        add("tp_w_stats", f"K=0 {bin_label(bins)}",
            lambda: (torch.zeros(D, device=dev),), w_stats,
            c if first else None)
        add("tp_w_update", f"K=0 {bin_label(bins)}",
            lambda: _clones(s, "mu_w", "sig_w") + (
                torch.zeros(D, 2, device=dev), _bad(dev)),
            w_update, cost(C * 16 + C * 4 * 6, C * 10, plain_graph=False)
            if first else None)
        add("tp_w_draw", f"{bin_label(bins)}",
            lambda: (s["w"].clone(), torch.zeros(D, 2, device=dev),
                     _bad(dev)), t5,
            cost(C * 4 * 9 + G * 8, C * 12, plain_graph=False)
            if first else None)


def _shard_bins(plan, meta, dev, S: int) -> list:
    """Each of the ``S`` data shards' ``BinPlan`` a bin of ``plan`` (built
    for S shards), as ``learners/base.py:build_plan_data`` cuts it."""
    import types

    from svbfm_tpu_torch.kernels import ovb_sweep as ko
    from svbfm_tpu_torch.learners.base import build_plan_data

    return [[ko.BinPlan(bb) for bb in build_plan_data(
        plan, meta, dev, types.SimpleNamespace(n_data=S, d_index=d)).blocks]
        for d in range(S)]


def dp_ovb_tensors(ovb, state) -> dict:
    """T13's and T10's inputs at the data-parallel OVB's shapes: chunk 0 of
    the resident learner ``ovb``'s membership (ML-1M, K = 20, 20 chunks:
    N = 50,002), its rows padded to a multiple of two, its plan built for
    one data shard (the world of one's: the JSON line's) and for two (each
    shard's block of rows and slice of the buckets), from a real init: the
    chunk's e; for F in DP_OVB_KERNEL_F the pre-bin (mu | sig | 0) patch
    table of the first F factors, K2's q and tq (its twin), the four [D, F]
    tables, sigma_v's [G, F] and rho_v."""
    from svbfm_tpu_torch.data.dataset import SparseDataset, SweepPlan
    from svbfm_tpu_torch.kernels import vb_sweep as kv
    from svbfm_tpu_torch.ops.forward import fm_scores

    cfg, meta, train = ovb.cfg, ovb.meta, ovb._train_ds
    D = cfg.num_attributes
    dev = state.mu_w.device
    idx = np.array_split(ovb.member_perm, ovb.num_chunks)[0]
    sub = SparseDataset(
        ids=train.ids[idx], vals=train.vals[idx], target=train.target[idx],
        num_rows=len(idx), num_features=D, min_target=train.min_target,
        max_target=train.max_target, row_nnz=train.row_nnz[idx])
    n_pad = -(-len(idx) // 2) * 2
    rows = sub.padded_to(n_pad)
    ids = torch.from_numpy(rows.ids.astype(np.int32)).to(dev)
    vals = torch.from_numpy(rows.vals.astype(np.float32)).to(dev)
    valid = (torch.arange(n_pad, device=dev) < len(idx)).to(torch.float32)
    target = torch.from_numpy(rows.target.astype(np.float32)).to(dev)
    e = (target - fm_scores(state.mu_0, state.mu_w, state.mu_v, ids,
                            vals)) * valid
    bins = {S: _shard_bins(SweepPlan.build(
        sub.to_coo(), D, meta_groups=meta.attr_group,
        col_count=ovb.col_count, n_shards=S, n_rows_total=n_pad), meta, dev,
        S) for S in (1, 2)}
    widths = {}
    for F in DP_OVB_KERNEL_F:
        ptab = torch.zeros(D, 5 * F, device=dev)
        ptab[:, :F] = state.mu_v[:F].T
        ptab[:, F:2 * F] = state.sigma_v_dash[:F].T
        q, tq, _ = kv.vb_build_qt_plain(ptab, F, ids, vals)
        widths[F] = dict(
            ptab=ptab, q=q, tq=tq, mu=state.mu_v[:F].T.contiguous(),
            sig=state.sigma_v_dash[:F].T.contiguous(),
            nmu=state.n_mu_v[:F].T.contiguous(),
            nsig=state.n_sig_v[:F].T.contiguous(),
            sv=state.sigma_v[:, :F].contiguous())
    return dict(tag="dp-ovb", dp_ovb=widths, bins=bins, D=D, e=e,
                rho_v=(1.0 + state.t_vj) ** -0.5, alpha=state.alpha,
                mu_w=state.mu_w, sig_w=state.sigma_w_dash,
                nmu_w=state.n_mu_w, nsig_w=state.n_sig_w, t_wj=state.t_wj,
                sigma_w=state.sigma_w)


def ragged_dp_ovb_tensors(device) -> dict:
    """T13 (and T10) on a small problem, 3 chunks at K = 20: an OVB init's
    ``dp_ovb_tensors``, eta2 NaN at column 1 of every width's table and of
    w (NaN candidates, counted)."""
    from svbfm_tpu_torch.data.dataset import SparseDataset
    from svbfm_tpu_torch.data.meta import DataMetaInfo
    from svbfm_tpu_torch.data.synth import (make_movielens_like,
                                            train_test_split)
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.vb_online import OVBLearner

    coo = make_movielens_like(37, 26, 900, rank=2, noise=0.4, seed=5)
    tr, te = train_test_split(coo, 0.2, seed=6)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 37])
    cfg = FMConfig(num_attributes=D, num_factor=max(DP_OVB_KERNEL_F),
                   num_groups=2, seed=SEED, num_batches=3,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()))
    lr = OVBLearner(cfg, SparseDataset.from_coo(tr, D),
                    SparseDataset.from_coo(te, D), meta, device=device,
                    write_files=False)
    s = dp_ovb_tensors(lr, lr.init_state())
    for t in s["dp_ovb"].values():
        t["nsig"][1] = float("nan")
    s["nsig_w"] = s["nsig_w"].clone()
    s["nsig_w"][1] = float("nan")
    s.update(tag="dp-ovb-ragged", timed=False)
    return s


def dp_ovb_cases(add, s: dict, bucket_cost) -> None:
    """At each F of DP_OVB_KERNEL_F, on every bin of the chunk, each
    against its twin: T13's stats launch on one shard and on each of two
    (its shard's rows), its blend launch from the twin's one-shard sums;
    then the two shards' stats launches summed and the blend against K6's
    twin on the whole bin (the world of one's K6 launch), and T10's stats
    and blend launches at lo = 0, D_loc = D on each shard.  Timed on bin
    0, one shard."""
    from svbfm_tpu_torch.kernels import ovb_sweep as ko
    from svbfm_tpu_torch.kernels import w_sweep as kw

    D, e = s["D"], s["e"]
    dev = e.device
    half = e.shape[0] // 2
    one, two = s["bins"][1][0], s["bins"][2]

    def nothing():
        return ()

    def rows_of(S, d):
        return slice(0, 2 * half) if S == 1 else slice(d * half,
                                                       (d + 1) * half)

    def bin_cost(plan, per_entry, per_col, flops):
        parts = [bucket_cost(dict(rows=b.rows, x=b.x), per_entry, per_col,
                             flops) for b in plan.buckets]
        return cost(sum(c["bytes"] for c in parts),
                    sum(c["flops"] for c in parts))

    for F, t in s["dp_ovb"].items():
        G = t["sv"].shape[0]

        def prep(t=t):
            return _clones(t, "ptab", "mu", "sig", "nmu", "nsig") + (
                torch.zeros(D, device=dev), _bad(dev))

        def blend(plan, sums, t=t):
            def call(variant, inp):
                fn = (ko.dp_ovb_blend if variant == "kernel"
                      else ko.dp_ovb_blend_plain)
                ptab, mu, sig, nmu, nsig, tv, bad = inp
                fn(plan, D, sums, ptab, mu, sig, nmu, nsig, t["sv"],
                   s["alpha"], s["rho_v"], tv, bad)
                return list(inp)
            return call

        def split_vs_k6(i, t=t):
            def call(variant, inp):
                ptab, mu, sig, nmu, nsig, tv, bad = inp
                args = (t["sv"], s["alpha"], s["rho_v"], tv, bad)
                if variant == "plain":
                    ko.ovb_bin_update_plain(one[i], e, t["q"], t["tq"], ptab,
                                            mu, sig, nmu, nsig, *args)
                    return list(inp)
                sums = sum(ko.dp_ovb_stats(
                    two[d][i], D, e[rows_of(2, d)], t["q"][rows_of(2, d)],
                    t["tq"][rows_of(2, d)], ptab) for d in range(2))
                ko.dp_ovb_blend(two[0][i], D, sums, ptab, mu, sig, nmu,
                                nsig, *args)
                return list(inp)
            return call

        for S, shards in ((1, [one]), (2, two)):
            for d, bins in enumerate(shards):
                r = rows_of(S, d)
                for i, plan in enumerate(bins):
                    timed = S == 1 and i == 0
                    label = f"F={F} S={S} shard {d} bin {i} C={plan.num_cols}"
                    # stats: per entry e, q, tq gathered; per column its
                    # id, ptab's mu/sig and the 2F sums written
                    add("dp_ovb_stats", label, nothing,
                        lambda variant, _, plan=plan, r=r, t=t: [
                            (ko.dp_ovb_stats if variant == "kernel"
                             else ko.dp_ovb_stats_plain)(
                                plan, D, e[r], t["q"][r], t["tq"][r],
                                t["ptab"])],
                        bin_cost(plan, 1 + 2 * F, 1 + 4 * F, 15 * F)
                        if timed else None)
                    if S == 2:
                        continue
                    # blend: a column reads its id, cnt, col_count, group,
                    # tv_add, rho, 2F sums, ptab's mu/sig, eta1 and eta2,
                    # and writes the four tables, three deltas and tv_add;
                    # sigma_v [G, F] once (the twin masks: host-paced)
                    C = plan.num_cols
                    sums = ko.dp_ovb_stats_plain(plan, D, e, t["q"],
                                                 t["tq"], t["ptab"])
                    add("dp_ovb_blend", label, prep, blend(plan, sums),
                        cost(C * (7 + 13 * F) * 4 + G * F * 4, C * 25 * F,
                             plain_graph=False) if timed else None)
                    add("dp_ovb_blend", f"F={F} bin {i}: two shards' stats "
                        "summed, the blend, against K6's twin on the bin",
                        prep, split_vs_k6(i), None)
    # T10 at lo = 0, D_loc = D on each shard's rows (F = 0)
    for S, shards in ((1, [one]), (2, two)):
        for d, bins in enumerate(shards):
            r = rows_of(S, d)
            for i, plan in enumerate(bins):
                label = f"F=0 S={S} shard {d} bin {i}"
                acc = torch.zeros(D, device=dev)
                kw.tp_w_ovb_stats_plain(plan.buckets, e[r], s["mu_w"], acc,
                                        D)

                def w_stats(variant, inp, plan=plan, r=r):
                    fn = (kw.tp_w_ovb_stats if variant == "kernel"
                          else kw.tp_w_ovb_stats_plain)
                    (a,) = inp
                    fn(plan.buckets, e[r], s["mu_w"], a, D)
                    return [a]

                def w_blend(variant, inp, plan=plan, acc=acc):
                    fn = (kw.tp_w_ovb_blend if variant == "kernel"
                          else kw.tp_w_ovb_blend_plain)
                    mu_w, sig_w, nmu_w, nsig_w, t_wj, dtab, bad = inp
                    fn(plan.buckets, acc, D, mu_w, sig_w, s["sigma_w"],
                       s["alpha"], dtab, bad,
                       (nmu_w, nsig_w, (1.0 + s["t_wj"]) ** -0.5, t_wj))
                    return list(inp)

                add("tp_w_ovb_stats", label,
                    lambda: (torch.zeros(D, device=dev),), w_stats, None)
                add("tp_w_ovb_blend", label,
                    lambda: _clones(s, "mu_w", "sig_w", "nmu_w", "nsig_w",
                                    "t_wj") + (
                        torch.zeros(D, 2, device=dev), _bad(dev)),
                    w_blend, None)


def dp_join_tensors(learner, state, widths=DP_JOIN_F) -> dict:
    """X10a's inputs at the data-parallel BS learner's shapes: each
    relation's join plan of the BS learner ``learner`` (the relational
    recipe, 1M rows) built for one data shard and for two (the rows padded
    to a multiple of two, each shard's slice of the buckets), the train
    residual e of ``state`` and, for F in ``widths``, a seeded q [N, F] and
    the relation-row table's qB | wn columns (its channel columns zero)."""
    from svbfm_tpu_torch.data.dataset import SweepPlan
    from svbfm_tpu_torch.data.libfm_text import COOData
    from svbfm_tpu_torch.kernels import bs_sweep as ks
    from svbfm_tpu_torch.learners.mcmc_bs import JoinBlock

    dev = state.e.device
    N = learner.train_n
    n_pad = -(-N // 2) * 2
    e = torch.nn.functional.pad(state.e[:N], (0, n_pad - N))
    gen = torch.Generator().manual_seed(SEED + 3)
    qs = {F: (torch.randn(n_pad, F, generator=gen) * 0.3).to(dev) if F
          else None for F in widths}
    rels = []
    for ri, rd in enumerate(learner.rels):
        join = rd.join_tr.cpu().numpy()
        R = learner.rstats[ri].num_rows
        coo = COOData(row=np.arange(N, dtype=np.int32), col=join,
                      val=np.ones(N, np.float32),
                      target=np.zeros(N, np.float32), num_rows=N,
                      num_features=R)
        plans = {}
        for S in (1, 2):
            plan = SweepPlan.build(coo, R, bins="jacobi", n_shards=S,
                                   n_rows_total=n_pad)
            plans[S] = [[JoinBlock(
                rows=torch.from_numpy(b.rows[d].copy()).to(dev),
                x=torch.from_numpy(b.x[d].copy()).to(dev),
                cols=torch.from_numpy(b.cols.copy()).to(dev))
                for b in plan.blocks[0]] for d in range(S)]
        tabs = {}
        for F in widths:
            lay = ks.rel_layout(F)
            tab = torch.zeros(R, lay["ld"], device=dev)
            tab[:, :F] = (torch.randn(R, F, generator=gen) * 0.3).to(dev)
            tab[:, lay["wn"]] = rd.wnum
            tabs[F] = tab
        rels.append(dict(name=("users", "items")[ri] if ri < 2 else str(ri),
                         plans=plans, tabs=tabs))
    return dict(tag="dp-bs", dp_join=rels, e=e, q=qs, widths=widths)


def dp_join_cases(add, s: dict) -> None:
    """X10a on each shard's slice of each relation's join plan (shard-local
    rows, x = 0 pad slots; a relation row joined to no row of the shard
    gets zero sums) against its twin (column chunks past F = 32,
    ``join_agg_twin``), at every F of ``s["widths"]``; and the two slices'
    launches, their channel columns summed, against one launch on the
    whole plan."""
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    e = s["e"]
    half = e.shape[0] // 2
    for rel in s["dp_join"]:
        for F in s["widths"]:
            lay = ks.rel_layout(F)
            ch = slice(lay["we"], lay["wn"])
            q = s["q"][F]
            tab = rel["tabs"][F]

            def slice_call(d, tab=tab, q=q, F=F, rel=rel):
                r = slice(d * half, (d + 1) * half)

                def call(variant, _):
                    fn = ks.bs_join_agg if variant == "kernel" \
                        else join_agg_twin
                    out = tab.clone()
                    fn(rel["plans"][2][d], e[r], None if q is None else q[r],
                       F, out)
                    return [out]
                return call

            def sum_call(variant, _, tab=tab, q=q, F=F, rel=rel, ch=ch):
                if variant == "plain":
                    out = tab.clone()
                    ks.bs_join_agg(rel["plans"][1][0], e, q, F, out)
                    return [out]
                outs = []
                for d in range(2):
                    r = slice(d * half, (d + 1) * half)
                    out = tab.clone()
                    ks.bs_join_agg(rel["plans"][2][d], e[r],
                                   None if q is None else q[r], F, out)
                    outs.append(out)
                outs[0][:, ch] += outs[1][:, ch]
                return [outs[0]]

            for d in range(2):
                add("bs_join_agg", f"{rel['name']} F={F} slice {d} of 2",
                    lambda: (), slice_call(d), None)
            add("bs_join_agg", f"{rel['name']} F={F} two slices' launches "
                "summed, against one launch on the whole plan", lambda: (),
                sum_call, None)


def win_cases(add, W: dict, bucket_cost, bin_cost) -> None:
    """X13a on each bucket of the bin ``W`` holds at F = W["F"] (and, where
    ``W`` has its w tables, X13b on the bin): every window in order (first
    writes the accumulator, the last applies the update), checked against
    the twin's chain; then, timed, one launch of the last window (the
    update) and of the first (the writes to the accumulator alone) on the
    largest bucket, and of the bin."""
    from svbfm_tpu_torch.kernels import vb_sweep as kv
    from svbfm_tpu_torch.kernels import w_sweep as kw

    F, nw = W["F"], len(W["e"])
    last = nw - 1
    dev = W["ptab"].device

    def a_prepare(C):
        def prepare():
            return (W["mu_t"].clone(), W["sig_t"].clone(), W["ptab"].clone(),
                    torch.zeros(2, dtype=torch.int32, device=dev),
                    torch.zeros(C, 2 * F, device=dev))
        return prepare

    def x13a(b, ws):
        def call(variant, inp):
            fn = (kv.vb_col_stats_window if variant == "kernel"
                  else kv.vb_col_stats_window_plain)
            mu, sig, ptab, nans, acc = inp
            for w in ws:
                fn(b["rows"][w], b["x"][w], b["cols"], b["group"], W["e"][w],
                   W["q"][w], W["tq"][w], ptab, mu, sig, W["sv"], W["alpha"],
                   nans, acc, w == 0, w == last)
            return [mu, sig, ptab, nans, acc]
        return call

    def a_cost(b, w):
        # rows and x of the window; e, q, tq at its real entries; the
        # pre-bin mu and sig, the accumulator read (after the first) and
        # written (before the last), the update's writes (the last)
        per_col = 2 * F + (2 * F if w else 0) + (
            2 * F if w < last else 5 * F)
        return bucket_cost(dict(rows=b["rows"][w], x=b["x"][w]), 1 + 2 * F,
                           per_col, 12 * F)

    def shape(b, w=0):
        return f"[{b['rows'][w].shape[0]},{b['rows'][w].shape[1]}]"

    for b in W["buckets"]:  # the chains, checked
        C = b["rows"][0].shape[0]
        add("vb_col_stats_window", f"F={F} {shape(b)} windows 0-{last}",
            a_prepare(C), x13a(b, range(nw)), None)
    big = W["buckets"][0]
    for w in dict.fromkeys((last, 0)):  # timed: the last window first
        c = a_cost(big, w)
        c["note"] = stats_note(F, big["rows"][w], W["q"][w], W["tq"][w])
        add("vb_col_stats_window",
            f"F={F} {shape(big, w)} window {w} of {nw}",
            a_prepare(big["rows"][0].shape[0]), x13a(big, [w]), c)
    if "w_bins" not in W:
        return

    def b_prepare():
        return (W["mu_w"].clone(), W["sig_w"].clone(),
                torch.zeros(W["mu_w"].shape[0], 2, device=dev),
                _bad(dev), torch.zeros_like(W["mu_w"]))

    def x13b(ws):
        def call(variant, inp):
            fn = (kw.w_bin_update_window if variant == "kernel"
                  else kw.w_bin_update_window_plain)
            mu_w, sig_w, dtab, bad, acc = inp
            for w in ws:
                fn(W["w_bins"][w], W["e"][w], mu_w, sig_w, W["sigma_w"],
                   W["alpha"], dtab, bad, acc, w == 0, w == last)
            return [mu_w, sig_w, dtab, bad, acc]
        return call

    label = "+".join(shape(b) for b in W["buckets"])
    add("w_col_window", f"bin {label} windows 0-{last}", b_prepare,
        x13b(range(nw)), None)
    for w in dict.fromkeys((last, 0)):
        add("w_col_window", f"bin {label} window {w} of {nw}", b_prepare,
            x13b([w]), bin_cost(W["w_bins"][w], (1 if w else 0) + (
                1 if w < last else 9), 2))


def resident4_cases(add, R: dict, bucket_cost) -> None:
    """X8a's exact mode with a noise table and K3 without the w rider at
    F = R["F"] on every bucket of the ML-1M sweep: the shapes the resident
    learners at factor_block 4 give them (the windowed phases' reference
    runs), where X8a takes its lanes form and K3 its lanes form on the
    buckets of L <= 128; each timed, its form printed."""
    from svbfm_tpu_torch.kernels import mcmc_sweep as km
    from svbfm_tpu_torch.kernels import vb_sweep as kv

    F = R["F"]
    dev = R["ptab"].device

    def nans():
        return torch.zeros(2, dtype=torch.int32, device=dev)

    def x8a(b):
        def call(variant, inp):
            fn = (km.mcmc_col_draw if variant == "kernel"
                  else km.mcmc_col_draw_plain)
            ptab, vt, n = inp
            fn(b["rows"], b["x"], b["cols"], b["group"], R["e"], R["q"],
               ptab, vt, R["mu"], R["lam"], R["alpha"], R["z"], True, n)
            return [ptab, vt, n]
        return call

    def k3(b):
        def call(variant, inp):
            fn = (kv.vb_col_stats_update if variant == "kernel"
                  else kv.vb_col_stats_update_plain)
            mu_t, sig_t, ptab, n = inp
            fn(b["rows"], b["x"], b["cols"], b["group"], b["sx2"],
               R["vb_e"], R["vq"], R["vtq"], ptab, mu_t, sig_t, R["sv"],
               R["vb_alpha"], None, n)
            return [mu_t, sig_t, ptab, n]
        return call

    for b in R["buckets"]:
        C, L = b["rows"].shape
        c = bucket_cost(b, 1 + F, 4 * F, 7 * F + F * (F - 1),
                        plain_graph=False)  # the twin's draw syncs
        c["note"] = draw_form_note(F, b["rows"])
        add("mcmc_col_draw", f"F={F} exact+z [{C},{L}]",
            lambda: (R["ptab"].clone(), R["vt"].clone(), nans()), x8a(b), c)
        c = bucket_cost(b, 1 + 2 * F, 8 * F, 12 * F + 2)
        c["note"] = stats_note(F, b["rows"], R["vq"], R["vtq"])
        add("vb_col_stats_update", f"F={F} [{C},{L}]",
            lambda: (R["mu_t"].clone(), R["sig_t"].clone(),
                     R["vptab"].clone(), nans()), k3(b), c)


def resident4_tensors(gibbs, gstate, vb, vstate, F: int = 4) -> dict:
    """``resident4_cases``' inputs: factors 0..F-1 of a Gibbs state one
    sweep in (its residual, priors, a noise table) for X8a and of a VB init
    for K3 (its caches built from them, its prior precisions), on every
    bucket of the learners' plan, the largest first."""
    from svbfm_tpu_torch.kernels import vb_sweep as kv

    D = gibbs.cfg.num_attributes
    dev = gstate.e.device
    gen = torch.Generator(device=dev).manual_seed(SEED + F)
    vt = gstate.v[:F].T.contiguous()
    ptab = torch.cat([vt, torch.zeros_like(vt)], 1)
    mu_t = vstate.mu_v[:F].T.contiguous()
    sig_t = vstate.sigma_v_dash[:F].T.contiguous()
    vptab = torch.zeros(D, 5 * F, device=dev)
    vptab[:, :F], vptab[:, F:2 * F] = mu_t, sig_t
    vq, vtq, _ = kv.vb_build_qt_plain(vptab, F, vb.train_row.ids,
                                      vb.train_row.vals)
    row = gibbs.train_row
    every = sorted((_bucket_dict(b) for bb in gibbs.plan_data.blocks
                    for b in bb), key=lambda d: -d["rows"].numel())
    return dict(tag="fb4", D=D, r4=dict(
        F=F, buckets=every, e=gstate.e, vt=vt, ptab=ptab,
        q=kv.build_q_plain(ptab, F, row.ids, row.vals),
        mu=gstate.v_mu[:, :F].contiguous(),
        lam=gstate.v_lambda[:, :F].contiguous(), alpha=gstate.alpha,
        z=torch.randn(F, D, generator=gen, device=dev), vb_e=vstate.e,
        vq=vq, vtq=vtq, vptab=vptab, mu_t=mu_t, sig_t=sig_t,
        sv=vstate.sigma_v[:, :F].contiguous(), vb_alpha=vstate.alpha))


def win_tensors(learner, state, tag: str, timed: bool = True,
                widths=(None,)) -> dict:
    """X13a's and X13b's inputs at the windowed path's shapes: every
    window of ``learner`` (a WindowedVBLearner on the card) from
    ``state``, the bin of the most columns (its buckets the largest
    first), and the caches e, q, tq of each window for the first block of
    each width in ``widths`` (None: the learner's F); X13b's tables with
    the first."""
    from svbfm_tpu_torch.kernels import vb_sweep as kv
    from svbfm_tpu_torch.learners.vb_windowed import WindowBlock

    Wl, nw = learner.wlen, learner.num_windows
    D = learner.cfg.num_attributes
    dev = state.e.device

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    plan = learner.plan
    b = max(range(len(plan.bins)),
            key=lambda i: sum(len(bu.cols) for bu in plan.bins[i]))
    buckets = sorted(
        (dict(rows=[t(bu.rows[w]) for w in range(nw)],
              x=[t(bu.x[w]) for w in range(nw)], cols=cols, group=group,
              sx2=sx2)
         for bu, (cols, group, sx2) in zip(plan.bins[b],
                                           learner._bins_dev[b])),
        key=lambda d: -d["rows"][0].numel())
    e = [state.e[w * Wl:(w + 1) * Wl] for w in range(nw)]
    out = []
    for F in widths:
        F = learner.F if F is None else F
        mu_t = state.mu_v[:F].T.contiguous()
        sig_t = state.sigma_v_dash[:F].T.contiguous()
        ptab = torch.zeros(D, 5 * F, device=dev)
        ptab[:, :F], ptab[:, F:2 * F] = mu_t, sig_t
        caches = [kv.vb_build_qt_plain(ptab, F, t(plan.ids[w]),
                                       t(plan.vals[w])) for w in range(nw)]
        W = dict(F=F, e=e, q=[c[0] for c in caches],
                 tq=[c[1] for c in caches], ptab=ptab, mu_t=mu_t,
                 sig_t=sig_t, sv=state.sigma_v[:, :F].contiguous(),
                 alpha=state.alpha, buckets=buckets)
        if not out:
            W.update(w_bins=[[WindowBlock(d["rows"][w], d["x"][w],
                                          d["cols"], d["group"], d["sx2"])
                              for d in buckets] for w in range(nw)],
                     mu_w=state.mu_w.clone(),
                     sig_w=state.sigma_w_dash.clone(), sigma_w=state.sigma_w)
        out.append(W)
    return dict(tag=tag, timed=timed, D=D, win=out)


def ragged_win_tensors(device) -> list:
    """X13a and X13b on three windows of a small problem whose rows are
    sorted by user, so that most user columns have no entries in most
    windows (their window sums are 0; the case fails if none does), the
    last window padded (rows at wlen - 1 with x = 0), at F = 3 (single
    floats), F = 2 (pairs) and F = 4 (16-byte loads): e is NaN at one row
    of window 1, group 1's prior precisions (sigma_v, sigma_w) are NaN, so
    candidates are counted and reverted.  X13a also runs on an L = 1
    bucket (each window's first slot of the largest bucket)."""
    from svbfm_tpu_torch.data.dataset import SparseDataset
    from svbfm_tpu_torch.data.meta import DataMetaInfo
    from svbfm_tpu_torch.data.synth import make_movielens_like
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.vb_windowed import WindowedVBLearner

    coo = make_movielens_like(40, 30, 2600, seed=9)
    users = np.bincount(coo.row, weights=coo.col * (coo.col < 40),
                        minlength=coo.num_rows)
    by_user = np.argsort(users, kind="stable")  # rows sorted by user
    inv = np.empty_like(by_user)
    inv[by_user] = np.arange(len(by_user))
    coo.row = inv[coo.row].astype(np.int32)
    coo.target = coo.target[by_user]
    D = coo.num_features
    out = []
    for K, fb in ((6, 3), (4, 2), (8, 4)):
        meta = DataMetaInfo.from_field_offsets(D, [0, 40])
        cfg = FMConfig(num_attributes=D, num_factor=K, factor_block=fb,
                       num_groups=2, min_target=1.0, max_target=5.0, seed=3)
        lr = WindowedVBLearner(cfg, SparseDataset.from_coo(coo, D),
                               SparseDataset.from_coo(coo, D), meta,
                               device=device, num_windows=3,
                               write_files=False)
        st = lr.init_state()
        st.e[lr.wlen + 5] = float("nan")
        st.sigma_v[1] = float("nan")
        st.sigma_w[1] = float("nan")
        s = win_tensors(lr, st, f"ragged-win F={fb}", timed=False)
        W = s["win"][0]
        if len(W["e"]) != 3:
            raise AssertionError("ragged-win: not three windows")
        if not any(bool(((b["x"][w] == 0).all(1)).any())
                   for b in W["buckets"] for w in range(3)):
            raise AssertionError("ragged-win: no column with an empty "
                                 "window")
        big = W["buckets"][0]
        W["buckets"].append(dict(
            big, rows=[r[:, :1].contiguous() for r in big["rows"]],
            x=[x[:, :1].contiguous() for x in big["x"]]))
        out.append(s)
    return out


def mwin_cases(add, W: dict, bucket_cost, bin_cost) -> None:
    """X14a on each bucket of the bin ``W`` holds at F = W["F"] (and, where
    ``W`` has its w tables, X14b on the bin, with and without noise):
    every window in order (the first writes the accumulator, the last
    draws), checked against the twin's chain; then, timed, one launch of
    the last window (the draw) and of the first (the writes to the
    accumulator alone) on the largest bucket, and of the bin."""
    from svbfm_tpu_torch.kernels import mcmc_sweep as km
    from svbfm_tpu_torch.kernels import w_sweep as kw

    F, nw = W["F"], len(W["e"])
    last = nw - 1
    dev = W["ptab"].device
    nout = km.col_outputs(F)

    def a_prepare(C):
        def prepare():
            return (W["ptab"].clone(), W["vt"].clone(),
                    torch.zeros(2, dtype=torch.int32, device=dev),
                    torch.zeros(C, nout, device=dev))
        return prepare

    def x14a(b, ws):
        def call(variant, inp):
            fn = (km.mcmc_col_draw_window if variant == "kernel"
                  else km.mcmc_col_draw_window_plain)
            ptab, vt, nans, acc = inp
            for w in ws:
                fn(b["rows"][w], b["x"][w], b["cols"], b["group"], W["e"][w],
                   W["q"][w], ptab, vt, W["mu"], W["lam"], W["alpha"],
                   W["z"], nans, acc, w == 0, w == last)
            return [ptab, vt, nans, acc]
        return call

    def a_cost(b, w):
        # rows and x of the window; e and q at its real entries; the
        # pre-bin v, the accumulator read (after the first) and written
        # (before the last); the last: the priors and noise, v and dv
        per_col = F + (nout if w else 0) + (nout if w < last else 5 * F)
        c = bucket_cost(dict(rows=b["rows"][w], x=b["x"][w]), 1 + F,
                        per_col, 7 * F + F * (F - 1),
                        plain_graph=w < last)  # the twin's draw syncs
        c["note"] = (f1_note(dict(rows=b["rows"][w], x=b["x"][w]))
                     if F == 1 else draw_form_note(F, b["rows"][w]))
        return c

    def shape(b, w=0):
        return f"[{b['rows'][w].shape[0]},{b['rows'][w].shape[1]}]"

    for b in W["buckets"]:  # the chains, checked
        add("mcmc_col_draw_window", f"F={F} {shape(b)} windows 0-{last}",
            a_prepare(b["rows"][0].shape[0]), x14a(b, range(nw)), None)
    big = W["buckets"][0]
    for w in dict.fromkeys((last, 0)):  # timed: the last window first
        add("mcmc_col_draw_window",
            f"F={F} {shape(big, w)} window {w} of {nw}",
            a_prepare(big["rows"][0].shape[0]), x14a(big, [w]),
            a_cost(big, w))
    if "w_bins" not in W:
        return

    def b_prepare():
        D = W["w"].shape[0]
        return (W["w"].clone(), torch.zeros(D, 2, device=dev), _bad(dev),
                torch.zeros(D, device=dev))

    def x14b(ws, z):
        def call(variant, inp):
            fn = (kw.mcmc_w_bin_draw_window if variant == "kernel"
                  else kw.mcmc_w_bin_draw_window_plain)
            w_, dtab, bad, acc = inp
            for w in ws:
                fn(W["w_bins"][w], W["e"][w], w_, W["w_mu"], W["w_lambda"],
                   W["alpha"], z, dtab, bad, acc, w == 0, w == last)
            return [w_, dtab, bad, acc]
        return call

    label = "+".join(f"[{b.rows.shape[0]},{b.rows.shape[1]}]"
                     for b in W["w_bins"][0])
    for z in (W["zw"], None):
        add("mcmc_w_window", f"{'gibbs' if z is not None else 'als'} bin "
            f"{label} windows 0-{last}", b_prepare, x14b(range(nw), z),
            None)
    for w in dict.fromkeys((last, 0)):
        add("mcmc_w_window", f"gibbs bin {label} window {w} of {nw}",
            b_prepare, x14b([w], W["zw"]),
            bin_cost(W["w_bins"][w], (1 if w else 0) + (
                1 if w < last else 8), 2))


def mwin_tensors(learner, state, tag: str, timed: bool = True,
                 widths=(None, 1)) -> dict:
    """X14a's and X14b's inputs at the windowed Gibbs path's shapes: every
    window of ``learner`` (a WindowedMCMCLearner on the card) from
    ``state`` (one sweep in: drawn priors, residual), the bin of the most
    columns (its buckets the largest first), e and each window's q of the
    first block of each width in ``widths`` (None: the learner's F), a
    noise table for each; X14b's tables with the first."""
    from svbfm_tpu_torch.kernels import vb_sweep as kv
    from svbfm_tpu_torch.learners.vb_windowed import WindowBlock

    Wl, nw = learner.wlen, learner.num_windows
    D = learner.cfg.num_attributes
    dev = state.e.device
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    plan = learner.plan
    b = max(range(len(plan.bins)),
            key=lambda i: sum(len(bu.cols) for bu in plan.bins[i]))
    buckets = sorted(
        (dict(rows=[t(bu.rows[w]) for w in range(nw)],
              x=[t(bu.x[w]) for w in range(nw)], cols=cols, group=group,
              sx2=sx2)
         for bu, (cols, group, sx2) in zip(plan.bins[b],
                                           learner._bins_dev[b])),
        key=lambda d: -d["rows"][0].numel())
    e = [state.e[w * Wl:(w + 1) * Wl] for w in range(nw)]
    out = []
    for F in widths:
        F = learner.F if F is None else F
        vt = state.v[:F].T.contiguous()
        ptab = torch.cat([vt, torch.zeros_like(vt)], 1)
        W = dict(F=F, e=e, vt=vt, ptab=ptab, buckets=buckets,
                 q=[kv.build_q_plain(ptab, F, t(plan.ids[w]),
                                     t(plan.vals[w])) for w in range(nw)],
                 mu=state.v_mu[:, :F].contiguous(),
                 lam=state.v_lambda[:, :F].contiguous(), alpha=state.alpha,
                 z=torch.randn(F, D, generator=gen, device=dev))
        if not out:
            W.update(w=state.w.clone(), w_mu=state.w_mu,
                     w_lambda=state.w_lambda,
                     zw=torch.randn(D, generator=gen, device=dev),
                     w_bins=[[WindowBlock(d["rows"][w], d["x"][w], d["cols"],
                                          d["group"], d["sx2"])
                              for d in buckets] for w in range(nw)])
        out.append(W)
    return dict(tag=tag, timed=timed, D=D, mwin=out)


def ragged_mwin_tensors(device) -> list:
    """X14a and X14b on three windows of ragged_win_tensors' small problem
    (rows sorted by user: most user columns have no entries in most
    windows, the last window padded), at F = 3 (single floats in the
    lanes form) and F = 1, at K = 4 with F = 2 (pairs) and at K = 8 with
    F = 4 (16-byte loads of q): e is NaN at
    one row of window 1 (its columns' sums turn NaN, their draws are
    counted and reverted), group 1's lambdas (v and w) are NaN (its draws
    come out 0, uncounted), a noise number of each table is Inf (counted
    and reverted).  X14a also runs on an L = 1 bucket (each window's first
    slot of the largest bucket); X14b's bin also holds an L = 1 bucket (the
    same slots given the item columns) and an empty one."""
    from svbfm_tpu_torch.data.dataset import SparseDataset
    from svbfm_tpu_torch.data.meta import DataMetaInfo
    from svbfm_tpu_torch.data.synth import make_movielens_like
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.mcmc_windowed import WindowedMCMCLearner
    from svbfm_tpu_torch.learners.vb_windowed import WindowBlock

    coo = make_movielens_like(40, 30, 2600, seed=9)
    users = np.bincount(coo.row, weights=coo.col * (coo.col < 40),
                        minlength=coo.num_rows)
    by_user = np.argsort(users, kind="stable")  # rows sorted by user
    inv = np.empty_like(by_user)
    inv[by_user] = np.arange(len(by_user))
    coo.row = inv[coo.row].astype(np.int32)
    coo.target = coo.target[by_user]
    D = coo.num_features
    out = []
    for K, fb, widths in ((6, 3, (None, 1)), (4, 2, (None,)),
                          (8, 4, (None,))):
        meta = DataMetaInfo.from_field_offsets(D, [0, 40])
        cfg = FMConfig(num_attributes=D, num_factor=K, factor_block=fb,
                       num_groups=2, min_target=1.0, max_target=5.0, seed=3)
        lr = WindowedMCMCLearner(cfg, SparseDataset.from_coo(coo, D),
                                 SparseDataset.from_coo(coo, D), meta,
                                 device=device, num_windows=3,
                                 write_files=False)
        st, _ = lr.step(lr.init_state())
        st.e[lr.wlen + 5] = float("nan")
        st.v_lambda[1] = float("nan")
        st.w_lambda[1] = float("nan")
        s = mwin_tensors(lr, st, f"ragged-mwin K={K}", timed=False,
                         widths=widths)
        for W in s["mwin"]:
            if len(W["e"]) != 3:
                raise AssertionError("ragged-mwin: not three windows")
            big = W["buckets"][0]
            W["buckets"].append(dict(
                big, rows=[r[:, :1].contiguous() for r in big["rows"]],
                x=[x[:, :1].contiguous() for x in big["x"]]))
            W["z"][0, big["cols"][1].item()] = float("inf")
            if "w_bins" in W:
                W["zw"][big["cols"][2].item()] = float("inf")
                none = torch.zeros(0, dtype=torch.int32, device=device)
                C1 = min(big["rows"][0].shape[0], D - 40)
                items = torch.arange(40, 40 + C1, dtype=torch.int32,
                                     device=device)
                for w, wb in enumerate(W["w_bins"]):
                    x1 = big["x"][w][:C1, :1].contiguous()
                    wb.append(WindowBlock(
                        big["rows"][w][:C1, :1].contiguous(), x1, items,
                        torch.ones_like(items), (x1 * x1).sum(1)))
                    wb.append(WindowBlock(
                        torch.zeros(0, 8, dtype=torch.int32, device=device),
                        torch.zeros(0, 8, device=device), none, none,
                        torch.zeros(0, device=device)))
        if not any(bool(((b["x"][w] == 0).all(1)).any())
                   for b in s["mwin"][0]["buckets"] for w in range(3)):
            raise AssertionError("ragged-mwin: no column with an empty "
                                 "window")
        out.append(s)
    return out


def bs_cases(add, r: dict) -> None:
    """X10a-X10d on one relation ``r`` (see ``bs_tensors``): per width F
    (0 is the w sweep) the join aggregation over every bucket of the join
    plan, the relation draw of each picked bucket with and without a noise
    table, the patch after each picked bin, the resync; then the moments
    and (with ``r["scores"]``) the joined scores.  The twins that take
    host-side indices or synchronise are timed host-paced."""
    from svbfm_tpu_torch.kernels import bs_forward as kf
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    rd, name = r["rd"], r["name"]
    R, Pr = rd.rrow_ids.shape
    N = rd.join_tr.shape[0]
    Dr = r["Dr"]
    njs = sum(jb.rows.numel() for jb in rd.jplan)

    def x10a_case(F, w):
        lay = ks.rel_layout(F)
        CH = ks.agg_channels(F)

        def x10a(variant, inp):
            fn = ks.bs_join_agg if variant == "kernel" else join_agg_twin
            (rtab,) = inp
            fn(rd.jplan, r["e"], w["q"], F, rtab)
            return [rtab]

        def x10a_library():
            return torch.zeros(R, device=r["e"].device).index_add_(
                0, rd.join_tr, r["e"])

        form = getattr(ks, "join_form", None)
        note = f"form={form(F) if form else '?'}"
        if form and form(F) == "block" and hasattr(ks, "join_block_plan"):
            p = ks.join_block_plan(F)  # units a thread, threads a block
            note += f" kU={p.kU} threads={p.threads}"
        # the join plan's slots, e and q at each data row, qB0 and wn read,
        # the CH channel sums written; per entry: qO (F), e qO (F), the
        # products (P), x times each channel and its sum (2 CH)
        add("bs_join_agg", f"{name} F={F} N={N} R={R}",
            lambda: (w["rtab0"].clone(),), x10a,
            cost(njs * 8 + N * (1 + F) * 4 + R * (F + 1) * 4 + R * CH * 4,
                 N * (2 * F + lay["P"] + 2 * CH),
                 x10a_library if F == 0 else None, plain_graph=False,
                 note=note))

    for F, w in r["widths"]:
        lay = ks.rel_layout(F)
        Fo = max(F, 1)
        x10a_case(F, w)

        for b_i, b in w["picks"]:
            C, L = b.rows.shape
            n = int(torch.count_nonzero(b.x))
            # the slots whose x and row ids X10b's form reads: the narrow
            # forms a column's L slots, the block forms its real entries
            slots = (C * L if ks.draw_form(F, L) in ("group", "warp")
                     else int(b.real.n.sum()))
            for z in (w["z"], None):
                def x10b(variant, inp, b=b, z=z, F=F, w=w):
                    ptab, vt, nans = inp
                    args = (b.rows, b.x, b.cols, b.group, w["rtab"])
                    if F:
                        args += (F,)
                    args += (ptab, vt, w["mu"], w["lam"], r["alpha"], z,
                             nans)
                    if variant == "kernel":
                        (ks.bs_rel_draw if F else ks.bs_rel_w_draw)(
                            *args, b.real)
                    else:
                        (ks.bs_rel_draw_plain if F
                         else ks.bs_rel_w_draw_plain)(*args)
                    return [ptab, vt, nans]

                # per entry the relation row's ld channels; per column v,
                # dv, the priors (and z); per entry h, she, sh2 and the
                # F(F-1)/2 cross sums of M; the F-step draw per column
                npair = F * (F - 1) // 2
                add("bs_rel_w_draw" if F == 0 else "bs_rel_draw",
                    f"{name} F={F} bin {b_i} [{C},{L}]"
                    + (" +z" if z is not None else ""),
                    lambda w=w: (w["ptab"].clone(), w["vt"].clone(),
                                 torch.zeros(2, dtype=torch.int32,
                                             device=w["vt"].device)),
                    x10b,
                    cost(slots * 8 + n * lay["ld"] * 4
                         + C * Fo * (5 + (1 if z is not None else 0)) * 4,
                         n * (12 * Fo + 8 * npair) + C * Fo * Fo * 2,
                         plain_graph=F <= 1,
                         note=draw_note(F, b)))

        for b_i, ptab_b in w["patched"]:
            pos = rd.patch_pos[b_i]
            npos = int(pos.numel())

            def x10c(variant, inp, F=F, pos=pos, ptab_b=ptab_b):
                rtab, dy = inp
                if F == 0:
                    fn = (ks.bs_rel_w_patch if variant == "kernel"
                          else ks.bs_rel_w_patch_plain)
                    fn(rd.rrow_ids, rd.rrow_vals, pos, ptab_b, rtab, dy)
                else:
                    fn = (ks.bs_rel_patch if variant == "kernel"
                          else ks.bs_rel_patch_plain)
                    fn(rd.rrow_ids, rd.rrow_vals, pos, ptab_b, F, rtab, dy)
                return [rtab, dy]

            # per position the row's id and x; each ptab row (2 Fo) the
            # bin's rows name at its positions once (a slot bin's rows name
            # a few); the row's table read and qB, we, weq written; dy read
            # and written; the wcc matvec F^2 per position
            named = int(torch.unique(rd.rrow_ids[:, pos.long()]).numel())
            add("bs_rel_w_patch" if F == 0 else "bs_rel_patch",
                f"{name} F={F} bin {b_i} positions={npos} R={R} "
                f"ptab rows={named}",
                lambda w=w, Fo=Fo: (w["rtab"].clone(), torch.zeros(
                    R, Fo, device=w["rtab"].device)), x10c,
                cost(R * npos * 8 + named * 2 * Fo * 4 + R * lay["ld"] * 4
                     + R * (2 * F + 1) * 4 + R * Fo * 8,
                     R * npos * (2 * F * F + 12 * Fo), plain_graph=False,
                     note=plan_note(ks, "patch_plan", (F,),
                                    ("form", "lanes"))))

        # the resync's three forms (learners/mcmc_bs.py): the w resync (F = 0
        # here: dy alone at F = 1), the full one after a v sweep, and the q
        # build from a relation's contiguous qB (qB1 alone, no e)
        forms = [("w", (w["dy"], None, None))] if F == 0 else [
            ("full", (w["dy"], w["qB1"], w["qB0"])),
            ("q-build", (None, w["qB0"], None))]
        for form, (dy_r, qb1, qb0) in forms:
            Fr = max(F, 1)
            with_e = form != "q-build"

            def x10d(variant, inp, Fr=Fr, dy_r=dy_r, qb1=qb1, qb0=qb0,
                     with_e=with_e):
                fn = (kf.bs_resync if variant == "kernel"
                      else kf.bs_resync_plain)
                q, e = inp
                fn(rd.join_tr, Fr, dy_r, qb1, qb0,
                   None if qb1 is None else q, e if with_e else None)
                return [q, e]

            q0 = w["q"] if w["q"] is not None else torch.zeros(
                1, device=r["e"].device)
            # the join, each gathered table's row at each relation row
            # (dy, qB1, qB0: F floats), q and e read and written; per
            # factor dq, the e term and the update
            tabs = sum(t is not None for t in (dy_r, qb1, qb0))
            add("bs_resync", f"{name} {form} F={Fr} N={N}",
                lambda q0=q0: (q0.clone(), r["e"].clone()), x10d,
                cost(N * 4 + R * Fr * 4 * tabs
                     + N * 8 * (Fr * (qb1 is not None) + with_e),
                     N * Fr * (5 if with_e and qb1 is not None else 1),
                     note=plan_note(
                         kf, "resync_plan_of",
                         (rd.join_tr, Fr, dy_r, qb1, qb0,
                          None if qb1 is None else q0,
                          r["e"] if with_e else None),
                         ("form", "vec", "lanes", "rows"))))

    for F, w in r["agg_widths"]:  # X10a alone (its block form)
        x10a_case(F, w)

    for F, poison, w in r["agg_checks"]:  # checked only, two launches
        def x10a_bits(variant, inp, F=F, w=w, poison=poison):
            (rtab,) = inp
            if variant == "plain":
                join_agg_twin(w["plan"], w["e"], w["q"], F, rtab)
                return [rtab]
            again = rtab.clone()
            for out in (rtab, again):
                ks.bs_join_agg(w["plan"], w["e"], w["q"], F, out)
            if not torch.equal(rtab.view(torch.int32),
                               again.view(torch.int32)):
                raise AssertionError(f"bs_join_agg F={F} poison={poison}: "
                                     "two launches differ")
            return [rtab]

        add("bs_join_agg", f"{name} F={F} cut poison={poison}",
            lambda w=w: (w["rtab0"].clone(),), x10a_bits, None)

    def moments(variant, _):
        fn = (kf.bs_rel_moments if variant == "kernel"
              else kf.bs_rel_moments_plain)
        return [fn(rd.rrow_ids, rd.rrow_vals, r["stab"], r["off"])]

    ids64 = rd.rrow_ids.long() + r["off"]

    def moments_library():  # (lin | qB) alone, no sB
        return torch.nn.functional.embedding_bag(
            ids64, r["stab"], per_sample_weights=rd.rrow_vals, mode="sum")

    K1 = r["stab"].shape[1]
    # the channels written: (qB | lin | sumsB), K + 2 a row
    add("bs_rel_moments", f"{name} K={K1 - 1} R={R} Pr={Pr}", lambda: (),
        moments, cost(R * Pr * 8 + Dr * K1 * 4 + R * (K1 + 1) * 4,
                      R * Pr * (3 * K1), moments_library,
                      note=plan_note(kf, "moments_plan", (K1 - 1,),
                                     ("lanes", "channels", "rows"))))
    for sc in r.get("scores", ()):
        ids, vals = sc["ids"], sc["vals"]

        def scores(variant, _, sc=sc):
            fn = kf.bs_scores if variant == "kernel" else kf.bs_scores_plain
            return [fn(r["stab"], sc["w0"], sc["ids"], sc["vals"],
                       sc["joins"], sc["moms"])]

        Ns, Ps = ids.shape
        Km, nr = K1 - 1, len(sc["joins"])
        # the moments rows the joins reach, K + 2 channels each
        add("bs_scores", f"{sc['label']} N={Ns} relations={nr}", lambda: (),
            scores, cost(Ns * Ps * 8 + Ns * 4 * (1 + nr)
                         + sc["rows_read"] * (Km + 2) * 4,
                         Ns * (nr * (Km + 2) + 3 * Km),
                         note=plan_note(kf, "scores_plan_of",
                                        (r["stab"], ids, sc["moms"]),
                                        ("vec", "lanes", "rows", "build",
                                         "stride"))))


def probit_cases(add, s: dict) -> None:
    """X12a on the train rows in each of its modes and X12b on the test
    rows, VB's eval and Gibbs's (its accumulators updated in place).  The
    bytes: X12a reads e, y (and the Gibbs draw's u) and writes e; X12b
    reads the scores, targets and valid flags, and Gibbs's accumulators
    (psum_but5 from iteration 5) read and written.  The operations are
    counted a row, a transcendental function as one: ~30 in X12a's mean
    modes, ~55 in its Gibbs mode (the erf, then Giles' erfinv), ~50 in
    X12b.  X12b's library call is torch.special.ndtr on the scores, the
    exact Phi (not the reference's A&S erf) and no sums: a yardstick.
    X12a is timed twice: a replay of calls on one e, each reading the one
    before's output (``cuda_ms``; in the ALS mode e drifts towards -+Inf
    from call to call), and the path's single application, each call on a
    fresh copy of e (``fresh_ms``)."""
    from svbfm_tpu_torch.kernels import probit as kp

    latent = [(label, e, y, u, mode, fresh)
              for fresh in ((False, True) if s.get("timed", True)
                            else (False,))
              for label, e, y, u, mode in s.get("probit_latent", ())]
    for label, e, y, u, mode, fresh in latent:
        def call(variant, inp, y=y, u=u, mode=mode):
            (t,) = inp
            fn = (kp.probit_latent if variant == "kernel"
                  else kp.probit_latent_plain)
            fn(t, y, u, mode)
            return [t]

        n = e.shape[0]
        note = (f"blocks={kp.latent_blocks(n)}"
                if hasattr(kp, "latent_blocks") else "form=?")
        add("probit_latent", f"{label}{' fresh' if fresh else ''} N={n}",
            lambda e=e: (e.clone(),), call,
            cost(n * (12 + (4 if u is not None else 0)),
                 n * (55 if u is not None else 30), note=note, fresh=fresh))
    for label, sc, y, valid, nt, acc, it in s.get("probit_eval", ()):
        def prepare(acc=acc):
            return () if acc is None else (acc.clone(), acc.clone())

        def call(variant, inp, sc=sc, y=y, valid=valid, nt=nt, it=it):
            fn = (kp.probit_eval if variant == "kernel"
                  else kp.probit_eval_plain)
            return [fn(sc, y, valid, nt, *inp, it=it)] + list(inp)

        n = sc.shape[0]
        rw = 0 if acc is None else n * (8 + (8 if it >= 5 else 0))
        form = (f"blocks={kp.eval_blocks(n)} "
                if hasattr(kp, "latent_blocks") else "")
        add("probit_eval", f"{label} N={n}", prepare, call,
            cost(n * 12 + rw + 16, n * 50,
                 library=lambda sc=sc: torch.special.ndtr(sc),
                 note=f"{form}library_ms: torch.special.ndtr, the exact "
                 "Phi"))


def probit_tensors(gibbs, state) -> dict:
    """X12a's and X12b's inputs at the classification paths' shapes: the
    ML-1M train rows' scores (the Gibbs state's e + y, e = yhat - y) as
    the residual e = yhat that the latent update reads, the targets
    binarised at 3.5, uniforms from a host generator; the test rows'
    scores, targets and valid flags, and accumulators at Gibbs's 7th
    iteration."""
    from svbfm_tpu_torch.kernels import probit as kp

    row, trow = gibbs.train_row, gibbs.test_row
    dev = row.target.device
    yhat = (state.e + row.target).contiguous()
    y = torch.where(row.target > CLASS_THRESHOLD, 1.0, -1.0).contiguous()
    g = torch.Generator().manual_seed(SEED)
    u = (torch.rand(yhat.shape[0], generator=g) * (1 - 2 * kp.CDF_EPS)
         + kp.CDF_EPS).to(dev)
    scores = gibbs._test_scores(state).contiguous()
    yt = torch.where(trow.target > CLASS_THRESHOLD, 1.0, -1.0).contiguous()
    acc = (6.0 * torch.rand(scores.shape[0], generator=g)).to(dev)
    nt = float(gibbs.test_n)
    return dict(tag="probit", probit_latent=[
        ("vb", yhat, y, None, kp.PROBIT_VB),
        ("als", yhat, y, None, kp.PROBIT_ALS),
        ("gibbs", yhat, y, u, kp.PROBIT_GIBBS)], probit_eval=[
        ("vb", scores, yt, trow.valid, nt, None, 0),
        ("gibbs it=6", scores, yt, trow.valid, nt, acc, 6)])


def ragged_probit_tensors(device) -> dict:
    """X12a in its three modes and X12b (VB's eval and Gibbs's at iteration
    6) on 37 rows: e and the scores NaN, +-Inf and +-8 at a few rows, y = 0
    at one (the positive side, as y >= 0), the uniforms at both clip ends,
    a row outside the valid mask."""
    from svbfm_tpu_torch.kernels import probit as kp

    g = torch.Generator().manual_seed(5)
    n = 37
    e = torch.randn(n, generator=g) * 2
    e[[3, 7, 11, 15, 20]] = torch.tensor([float("nan"), float("inf"),
                                          -float("inf"), 8.0, -8.0])
    y = torch.where(torch.rand(n, generator=g) < 0.5, 1.0, -1.0)
    y[5] = 0.0
    u = torch.rand(n, generator=g) * (1 - 2 * kp.CDF_EPS) + kp.CDF_EPS
    u[[0, 1]] = torch.tensor([kp.CDF_EPS, 1 - kp.CDF_EPS])
    valid = torch.ones(n)
    valid[-1] = 0.0
    acc = 6.0 * torch.rand(n, generator=g)
    e, y, u, valid, acc = (t.to(device) for t in (e, y, u, valid, acc))
    return dict(tag="ragged-probit", timed=False, probit_latent=[
        ("vb", e, y, None, kp.PROBIT_VB), ("als", e, y, None, kp.PROBIT_ALS),
        ("gibbs", e, y, u, kp.PROBIT_GIBBS)], probit_eval=[
        ("vb", e, y, valid, float(n - 1), None, 0),
        ("gibbs it=6", e, y, valid, float(n - 1), acc, 6)])


def sgd_cases(add, g: dict, label: str, m, kind: str, batch) -> None:
    """X9a on one batch in step mode ``m`` (``kind``: "row", "sgda" with
    the entry-gradient record, "pair" with the batch's negatives as its
    fifth tensor), X9b on the accumulator the twin leaves, and for SGDA
    X9c on the validation batch ``g["val"]``.  The bytes count the batch
    and the table and accumulator rows it touches (X9a, the JAX function's
    own), the batch's entries, the accumulator rows they name and their
    owner record (X9a's write and X9b's read), or the count column, and
    the rows the batch changed (X9b), the winners' cache rows (SGDA)."""
    from svbfm_tpu_torch.kernels import sgd_step as ks

    tab, w0 = g["tab"], g["w0"]
    D, K = tab.shape[0], tab.shape[1] - 1
    ids, vals, y, valid = batch[:4]
    B, P = ids.shape
    sgda = kind == "sgda"
    pair = (batch[4], *g["range"]) if kind == "pair" else None
    neg = batch[4] if kind == "pair" else None

    def fresh_ws():
        return ks.make_workspace(D, K, tab.device,
                                 sgda_batch=(B, P) if sgda else None)

    def ws_out(ws):
        return [ws.acc, ws.acc0] + ([ws.gw_e, ws.gv_e, ws.winner]
                                    if sgda else [])

    def x9a(variant, inp):
        (ws,) = inp
        if variant == "kernel":
            ks.sgd_grad_scatter(tab, w0, ids, vals, y, valid, ws, m, pair,
                                record=sgda)
        else:
            ks.sgd_grad_scatter_plain(
                tab, w0, ids, vals, y, valid, ws.acc, ws.acc0, ws.owner, m,
                pair, (ws.gw_e, ws.gv_e, ws.winner) if sgda else None)
        return ws_out(ws)

    touched = ids if pair is None else torch.cat(
        [ids, ks.negative_ids(ids, *pair)[0]])
    n_u = int(torch.unique(touched).numel())
    rec = B * P * (1 + K) * 4 + n_u * 4 if sgda else 0
    add("sgd_grad_scatter", f"{label} B={B}", lambda: (fresh_ws(),), x9a,
        cost(B * (P * 8 + 8) + (B * 4 if pair else 0)
             + n_u * (3 + 2 * K) * 4 + 8 + rec,
             B * (2 if pair else 1) * P * (6 * K + 4)))

    filled = fresh_ws()
    x9a("plain", (filled,))

    def x9b_prepare():
        ws = fresh_ws()
        for a, b in zip(ws_out(ws) + [ws.owner],
                        ws_out(filled) + [filled.owner]):
            a.copy_(b)
        return (tab.clone(), w0.clone(), ws) + (
            (g["grad_tab"].clone(),) if sgda else ())

    def x9b(variant, inp):
        t, w, ws = inp[:3]
        regs = (g["reg_w"], g["reg_v"], g["attr_group"]) if sgda else ()
        if variant == "kernel":
            ks.sgd_apply(t, w, ws, m, ids, neg,
                         regs + (inp[3],) if sgda else None)
        else:
            ks.sgd_apply_plain(t, w, ws.acc, ws.acc0, m, regs + (
                ws.winner, ws.gw_e, ws.gv_e, inp[3]) if sgda else None)
        return [t, w, ws.acc, ws.acc0] + ([inp[3], ws.winner] if sgda else [])

    # X9b finds the rows the batch changed from the batch's entries, the
    # accumulator rows they name and the owner record of them (written by
    # X9a for X9b alone, so charged here), or from the count column,
    # whichever moves less; every other row keeps its value (pow(base, 0) = 1,
    # damp(0) = 0, and its accumulator row is zero already).  A changed
    # row reads and writes its table row and zeroes its accumulator row;
    # SGDA also reads its group and winner, and copies the winning entry's
    # gradients.
    entries = ks.apply_entries(ids, neg)
    n_named = int(torch.unique(entries).numel())
    n_t = int((filled.acc != 0).any(1).sum())
    n_win = int((filled.winner >= 0).sum()) if sgda else 0
    add("sgd_apply", f"{label} D={D}", x9b_prepare, x9b,
        cost(min(D * 4, entries.numel() * 4 + n_named * (4 + K) * 4)
             + n_t * ((1 + K) * 8 + (2 + K) * 4) + 16
             + (n_t * 8 + n_win * (1 + K) * 8 if sgda else 0),
             n_t * (1 + K) * 8))
    if not sgda:
        return
    for tab_v, grad_tab, reg_v, val, mv, cap in [
            (tab, g["grad_tab"], g["reg_v"], g["val"], m, 0),
            *g.get("lambda_more", ())]:
        x9c_case(add, label, tab_v, grad_tab, w0, g["reg_w"], reg_v,
                 g["attr_group"], val, mv, cap)


def tp_sgd_cases(add, g: dict) -> None:
    """T11 on each window of ``g``'s batch at each loss (timed in the
    regression mode), and X9b's dense form on each window's accumulator as
    T11's twin leaves it (regression).  T11's bytes: the batch, its
    partials, the table and accumulator rows of the window's entries and
    acc0; X9b dense: every row of the window's table (read and written)
    and accumulator (read and zeroed)."""
    from svbfm_tpu_torch.kernels import sgd_step as ks

    ids, vals, valid = g["batch"]
    B, P = ids.shape
    for name, m, y in g["modes"]:
        K = m.K
        for sh in g["shards"]:
            tab, lo, part = sh["tab"], sh["lo"], sh["part"]
            D_loc = tab.shape[0]

            def prepare(D_loc=D_loc, K=K, dev=tab.device):
                return (torch.zeros(D_loc, 2 + K, device=dev),
                        torch.zeros(2, device=dev))

            def t11(variant, inp, tab=tab, lo=lo, part=part, m=m, y=y):
                fn = (ks.tp_sgd_scatter if variant == "kernel"
                      else ks.tp_sgd_scatter_plain)
                fn(tab, g["w0"], ids, vals, y, valid, part, lo, *inp, m)
                return list(inp)

            loc = ids.long() - lo
            inr = (loc >= 0) & (loc < D_loc)
            n_in = int(inr.sum())
            n_u = int(torch.unique(loc[inr]).numel())
            timed = name == "regression"
            add("tp_sgd_scatter", f"{name} {sh['label']} B={B}", prepare, t11,
                cost(B * (P * 8 + 8) + part.numel() * 4
                     + n_u * (3 + 2 * K) * 4 + 8,
                     B * 3 * K + n_in * (4 * K + 4)) if timed else None)
            if not timed:
                continue
            acc, acc0 = prepare()
            t11("plain", (acc, acc0))

            def x9b_prepare(tab=tab, acc=acc, acc0=acc0):
                return (tab.clone(), g["w0"].clone(), acc.clone(),
                        acc0.clone())

            def x9b(variant, inp, m=m):
                fn = (ks.sgd_apply_dense if variant == "kernel"
                      else ks.sgd_apply_plain)
                fn(*inp, m)
                return list(inp)

            add("sgd_apply", f"dense window {sh['label']} D_loc={D_loc}",
                x9b_prepare, x9b,
                cost(D_loc * ((1 + K) * 8 + (2 + K) * 8) + 16,
                     D_loc * (1 + K) * 8))


def tp_sgd_tensors(tag: str, tab, w0, batch, modes, timed: bool) -> dict:
    """T11's and X9b's dense form's inputs: ``batch`` (ids, vals, valid)
    on the table ``tab`` [D, 1+K] cut into the windows of Sf = 2 (an odd D
    leaves the second a padding row) and of Sf = 1, each window's partials
    as the feature all-reduce leaves them (T1's twin summed over the
    windows); ``modes``: (name, StepMode, the loss's targets)."""
    from svbfm_tpu_torch.kernels import fm_forward as k1

    D, K = tab.shape[0], tab.shape[1] - 1
    ids, vals = batch[:2]
    shards = []
    for Sf in (2, 1):
        D_loc = -(-D // Sf)
        padded = torch.nn.functional.pad(tab, (0, 0, 0, D_loc * Sf - D))
        wins = [padded[f * D_loc:(f + 1) * D_loc].contiguous()
                for f in range(Sf)]
        part = sum(k1.tp_fm_partials_plain(w, K, False, ids, vals,
                                           f * D_loc, D_loc)
                   for f, w in enumerate(wins))
        shards += [dict(label=f"Sf={Sf} shard {f}", tab=w, lo=f * D_loc,
                        part=part) for f, w in enumerate(wins)]
    return dict(tag=tag, timed=timed, tp_sgd=dict(
        w0=w0, batch=batch, modes=modes, shards=shards))


def tp_sgd_path_tensors(sgd, exp, device) -> dict:
    """``tp_sgd_tensors`` at the feature-sharded SGD's shape: a batch of
    the path's 1,024 train rows (ML-1M, K = 20) with a padding entry (id
    0, x = 0) every 17th row and three valid = 0 rows, a random table,
    X9a's four losses (the targets binarised at 3.5, the stars above 3 as
    counts)."""
    from svbfm_tpu_torch.learners.sgd import sgd_step_mode

    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    D, K = sgd.cfg.num_attributes, sgd.cfg.num_factor
    row = sgd.train_row
    n = row.ids.shape[0]
    idx = torch.randperm(n, generator=gen, device=device)[
        : n // sgd.num_batches]
    ids, vals, y, valid = (t.index_select(0, idx) for t in (
        row.ids, row.vals, row.target, row.valid))
    ids[::17, 1], vals[::17, 1], valid[-3:] = 0, 0.0, 0.0

    def task_mode(task, lo, hi):
        return sgd_step_mode(dataclasses.replace(
            sgd.cfg, task=task, min_target=lo, max_target=hi))

    modes = [("regression", sgd.mode, y), ("exp", exp.mode, y),
             ("classification", task_mode(1, -1.0, 1.0),
              torch.where(y > CLASS_THRESHOLD, 1.0, -1.0)),
             ("poisson", task_mode(2, 0.0, 2.0),
              torch.clamp(y - 3.0, min=0.0))]
    tab = 0.1 * torch.randn(D, 1 + K, generator=gen, device=device)
    return tp_sgd_tensors("tp-sgd", tab, torch.tensor(3.5, device=device),
                          (ids, vals, valid), modes, True)


def ragged_tp_sgd_tensors(device) -> dict:
    """``tp_sgd_tensors`` on a small ragged batch: D = 31 (a padding row in
    the second window of two), K = 5, 40 rows of 3 positions, the third a
    padding entry in every other row, an x = 0 entry at a real id, two
    valid = 0 rows, a NaN target (a non-finite multiplier)."""
    from svbfm_tpu_torch.kernels import sgd_step as ks

    rng = np.random.default_rng(31)
    N, P, D, K = 40, 3, 31, 5

    def t(a, dt=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(device)

    ids = np.stack([rng.integers(0, 12, N), rng.integers(12, D, N),
                    rng.integers(0, D, N)], 1)
    vals = rng.uniform(0.5, 1.5, (N, P))
    ids[::2, 2], vals[::2, 2] = 0, 0.0
    vals[1, 2] = 0.0
    valid = np.ones(N)
    valid[-2:] = 0.0
    y = rng.uniform(1, 5, N)
    y[2] = np.nan
    common = dict(K=K, lr=0.05, min_target=1.0, max_target=5.0,
                  base_w=0.9995, base_v=0.9995, w0_base=0.999)
    modes = [("regression", ks.StepMode(ks.LOSS_REGRESSION, **common), t(y)),
             ("exp", ks.StepMode(ks.LOSS_EXP, stdev=1.5, **common), t(y)),
             ("classification", ks.StepMode(
                 ks.LOSS_CLASSIFICATION, **dict(common, min_target=-1.0,
                                                max_target=1.0)),
              t(np.where(y > 3, 1.0, -1.0))),
             ("poisson", ks.StepMode(ks.LOSS_POISSON, **dict(
                 common, min_target=0.0, max_target=2.0)),
              t(np.clip(y - 3, 0, None)))]
    return tp_sgd_tensors("ragged-tp-sgd", t(rng.normal(0, 0.3, (D, 1 + K))),
                          torch.tensor(0.3, device=device),
                          (t(ids, np.int32), t(vals), t(valid)), modes,
                          False)


def x9c_case(add, label: str, tab, grad_tab, w0, reg_w, reg_v, attr_group,
             val, m, max_blocks: int = 0) -> None:
    """X9c on the validation batch ``val`` in step mode ``m``, its cluster
    cut to ``max_blocks`` where that is > 0.  The bytes count the batch,
    the table and cache rows it names with their groups, and the regs read
    and written."""
    from svbfm_tpu_torch.kernels import sgd_step as ks

    D, K = tab.shape[0], tab.shape[1] - 1
    G = reg_w.shape[0]
    vids, vvals, vy, vvalid = val
    Bv, Pv = vids.shape
    ws = ks.make_workspace(D, K, tab.device)

    def x9c(variant, inp):
        rw, rv = inp
        args = (tab, grad_tab, w0, rw, rv, attr_group, vids, vvals, vy,
                vvalid)
        if variant == "kernel":
            ks.sgda_lambda(*args, ws, m, max_blocks=max_blocks)
        else:
            ks.sgda_lambda_plain(*args, m)
        return [rw, rv]

    n_uv = int(torch.unique(vids).numel())
    cut = f" blocks<={max_blocks}" if max_blocks else ""
    add("sgda_lambda", f"{label} Bv={Bv} G={G} K={K}{cut}",
        lambda: (reg_w.clone(), reg_v.clone()), x9c,
        cost(Bv * (Pv * 8 + 8) + n_uv * ((1 + K) * 8 + 4)
             + G * (1 + K) * 8, Bv * Pv * K * 30))


def check_cases(s: dict, timed: bool) -> dict:
    """Hold every kernel against its twin on the cases ``s`` gives; with
    ``timed``, also time both, and the library call where there is one, on
    the cases with a cost.  Returns per kernel {max_abs_err, times: [(label,
    ms, plain_ms, library_ms, cost)]}."""
    out = {}
    for name, cases in make_cases(s).items():
        if not cases:
            continue
        r = out.setdefault(name, dict(max_abs_err=0.0, times=[]))
        for label, prepare, call, c in cases:
            ok, op = call("kernel", prepare()), call("plain", prepare())
            torch.cuda.synchronize()
            r["max_abs_err"] = max(r["max_abs_err"],
                                   compare(ok, op, f"{name} ({label})"))
            if timed and c is not None:
                inp_k, inp_p = prepare(), prepare()
                lib = c["library"]
                if c["fresh"]:
                    ms, pms = (fresh_ms(prepare, lambda inp, v=v: call(v, inp),
                                        reps)[0]
                               for v, reps in (("kernel", 20), ("plain", 5)))
                else:
                    ms = cuda_ms(lambda: call("kernel", inp_k), 20)
                    pms = cuda_ms(lambda: call("plain", inp_p), 5,
                                  graph=c["plain_graph"])
                r["times"].append((
                    label, ms, pms, None if lib is None else cuda_ms(lib, 20),
                    c))
    return out


def print_report(report: dict) -> None:
    """Each kernel's worst error against its twin, and each timed case."""
    for name, r in report.items():
        print(f"  kernel {name}: max_abs_err={r['max_abs_err']:.3e} "
              f"(tol {KERNEL_TOL:g} x scale)", flush=True)
        for label, ms, pms, lms, c in r["times"]:
            lib = "null" if lms is None else f"{lms:.4f}"
            print(f"    {label}: ms={ms:.4f} plain_ms={pms:.4f} "
                  f"library_ms={lib} bound_ms={bound(c)[0]:.6f} "
                  f"({bound(c)[1]}) {c['note']}".rstrip())


def merge_reports(*reports) -> dict:
    out = {}
    for rep in reports:
        for name, r in rep.items():
            o = out.setdefault(name, dict(max_abs_err=0.0, times=[]))
            o["max_abs_err"] = max(o["max_abs_err"], r["max_abs_err"])
            o["times"] += r["times"]
    return out


def _bucket_dict(blk) -> dict:
    return {f.name: getattr(blk, f.name) for f in dataclasses.fields(blk)}


def fast_tensors(learner, state) -> dict:
    """Batch VB fast-mode kernel inputs at the path's shapes, from a real
    init state; also the exact-mode inputs: K5 and the w patch, and K2, K3
    and K4 at F = 1."""
    from svbfm_tpu_torch.kernels import vb_sweep as kv
    from svbfm_tpu_torch.kernels import w_sweep as kw
    from svbfm_tpu_torch.ops.forward import score_table, t_term_table

    plan = learner.plan_data
    D, F = learner.cfg.num_attributes, learner.cfg.num_factor
    dev = state.e.device
    mu_t = state.mu_v.T.contiguous()
    sig_t = state.sigma_v_dash.T.contiguous()
    ptab = torch.zeros(D, 5 * F + 2, device=dev)
    ptab[:, :F], ptab[:, F:2 * F] = mu_t, sig_t
    row = learner.train_row
    q, tq, tz = kv.vb_build_qt_plain(ptab, F, row.ids, row.vals)
    stab = score_table(state.mu_w, state.mu_v)
    s = dict(
        tag="vb", F=F, D=D, w0=state.mu_0, s0=state.sigma_0_dash, stab=stab,
        ttab=t_term_table(state.sigma_w_dash, state.mu_v,
                          state.sigma_v_dash),
        train_scores=True, sgd_stab=stab.contiguous(), ids=row.ids,
        vals=row.vals, eval_ids=learner.test_row.ids,
        eval_vals=learner.test_row.vals, mu_t=mu_t, sig_t=sig_t, ptab=ptab,
        mu_w=state.mu_w.clone(), sig_w=state.sigma_w_dash.clone(),
        sigma_w=state.sigma_w, w_sigma_w=state.sigma_w,
        sv=state.sigma_v.contiguous(), alpha=state.alpha, e=state.e.clone(),
        t=state.t.clone(), q=q, tq=tq, tz=tz, ovb=False)
    # K3: every bucket of a sweep, the largest first ([6026,256], [1613,512],
    # [2339,256], [14,128] here; the first is the JSON line's); K5: each
    # bin, bin 0 first
    every = sorted((b for bb in plan.blocks for b in bb),
                   key=lambda b: -b.rows.numel())
    s["buckets"] = [_bucket_dict(b) for b in every]
    s["w_bins"] = list(plan.blocks)
    # a patch table as bin 0 leaves it: deltas at bin 0's columns
    pt = ptab.clone()
    mt, st, mw, sw = (a.clone() for a in (mu_t, sig_t, s["mu_w"], s["sig_w"]))
    nans = torch.zeros(2, dtype=torch.int32, device=dev)
    for blk in plan.blocks[0]:
        kv.vb_col_stats_update_plain(
            blk.rows, blk.x, blk.cols, blk.group, blk.sx2, s["e"], q, tq, pt,
            mt, st, s["sv"], s["alpha"], (mw, sw, s["sigma_w"]), nans)
    s["ptab_patch"] = pt
    # exact mode: the w patch table as bin 0 of K5 leaves it; factor 0 alone
    # for K2, K3 and K4 at F = 1, the K4 table as bin 0 of K3 leaves it
    dtab = torch.zeros(D, 2, device=dev)
    kw.w_bin_update_plain(plan.blocks[0], s["e"], s["mu_w"].clone(),
                          s["sig_w"].clone(), s["sigma_w"], s["alpha"], dtab,
                          _bad(dev))
    s["dtab"] = dtab
    s["x_ptab"] = torch.zeros(D, 5, device=dev)
    s["x_ptab"][:, 0], s["x_ptab"][:, 1] = mu_t[:, 0], sig_t[:, 0]
    s["x_mu"], s["x_sig"] = mu_t[:, :1].contiguous(), sig_t[:, :1].contiguous()
    s["x_sv"] = s["sv"][:, :1].contiguous()
    s["xq"], s["xtq"] = q[:, :1].contiguous(), tq[:, :1].contiguous()
    s["xtz"] = tz[:, :1].contiguous()
    s["exact_buckets"] = s["buckets"]
    pt = s["x_ptab"].clone()
    mt, st = s["x_mu"].clone(), s["x_sig"].clone()
    for blk in plan.blocks[0]:
        kv.vb_col_stats_update_plain(
            blk.rows, blk.x, blk.cols, blk.group, blk.sx2, s["e"], s["xq"],
            s["xtq"], pt, mt, st, s["x_sv"], s["alpha"], None, nans)
    s["x_ptab_patch"] = pt
    return s


def ovb_tensors(learner, state) -> dict:
    """Online-VB kernel inputs at the path's shapes: chunk 0 of the
    learner's fixed membership, factor 0 (F = 1), from a real init; K1 on
    the chunk's rows, as each chunk's e/t caches take it; K6 on each of
    the chunk's bins (its ``BinPlan``s)."""
    from svbfm_tpu_torch.kernels import ovb_sweep as ko
    from svbfm_tpu_torch.kernels import vb_sweep as kv
    from svbfm_tpu_torch.kernels import w_sweep as kw
    from svbfm_tpu_torch.ops.forward import (fm_scores, fm_t_terms,
                                             score_table, t_term_table)

    cfg = learner.cfg
    row, bins = learner.chunks[0]
    blocks = [b.buckets for b in bins]
    D = cfg.num_attributes
    dev = row.ids.device
    e = row.target - fm_scores(state.mu_0, state.mu_w, state.mu_v, row.ids,
                               row.vals)
    t = fm_t_terms(state.sigma_0_dash, state.sigma_w_dash, state.mu_v,
                   state.sigma_v_dash, row.ids, row.vals)
    s = dict(
        tag="ovb-chunk", D=D, ovb=True, ids=row.ids, vals=row.vals, e=e, t=t,
        w0=state.mu_0, s0=state.sigma_0_dash, eval_ids=row.ids,
        eval_vals=row.vals, stab=score_table(state.mu_w, state.mu_v),
        ttab=t_term_table(state.sigma_w_dash, state.mu_v,
                          state.sigma_v_dash),
        alpha=state.alpha, mu_w=state.mu_w.clone(),
        sig_w=state.sigma_w_dash.clone(), n_mu_w=state.n_mu_w.clone(),
        n_sig_w=state.n_sig_w.clone(), t_wj=state.t_wj.clone(),
        w_sigma_w=state.sigma_w, rho_w=(1.0 + state.t_wj) ** -0.5,
        w_bins=blocks, vF=1)
    dtab = torch.zeros(D, 2, device=dev)
    kw.w_bin_update_plain(
        blocks[0], e, s["mu_w"].clone(), s["sig_w"].clone(), s["w_sigma_w"],
        s["alpha"], dtab, _bad(dev),
        ovb=(s["n_mu_w"].clone(), s["n_sig_w"].clone(), s["rho_w"],
             s["t_wj"].clone()))
    s["dtab"] = dtab
    mu, sig = state.mu_v[:1].T.contiguous(), state.sigma_v_dash[:1].T.contiguous()
    ptab = torch.zeros(D, 5, device=dev)
    ptab[:, :1], ptab[:, 1:2] = mu, sig
    vq, vtq, vtz = kv.vb_build_qt_plain(ptab, 1, row.ids, row.vals)
    s.update(v_ptab=ptab, v_mu=mu, v_sig=sig,
             v_nmu=state.n_mu_v[:1].T.contiguous(),
             v_nsig=state.n_sig_v[:1].T.contiguous(),
             v_sv=state.sigma_v[:, :1].contiguous(),
             rho_v=(1.0 + state.t_vj) ** -0.5, vq=vq, vtq=vtq, vtz=vtz,
             v_bins=bins)
    pt = ptab.clone()
    tmp = (mu.clone(), sig.clone(), s["v_nmu"].clone(), s["v_nsig"].clone())
    ko.ovb_bin_update_plain(bins[0], e, vq, vtq, pt, *tmp, s["v_sv"],
                            s["alpha"], s["rho_v"], torch.zeros(D, device=dev),
                            _bad(dev))
    s["v_ptab_patch"] = pt
    return s


def ragged_tensors(device) -> list:
    """Three small ragged cases: P = 3 with padding entries, K = 5, one [3, 8]
    bucket with padding entries (x = 0 at the last row).  For K5 and K6,
    column 9 produces NaN candidates (its eta2, and in batch-VB mode its
    group's sigma_w, are NaN) and column 17 has no entries in the chunk
    (cnt = 0)."""
    from svbfm_tpu_torch.kernels import ovb_sweep as ko
    from svbfm_tpu_torch.learners.base import BlockData

    rng = np.random.default_rng(11)
    N, P, D, F, G = 40, 3, 30, 5, 2
    ids = rng.integers(0, D, size=(N, P)).astype(np.int32)
    vals = rng.uniform(0.5, 1.5, size=(N, P)).astype(np.float32)
    nnz = rng.integers(1, P + 1, size=N)
    pad = np.arange(P)[None, :] >= nnz[:, None]
    ids[pad], vals[pad] = 0, 0.0
    CH = 5 * F + 2
    ptab = rng.normal(0, 0.3, size=(D, CH)).astype(np.float32)
    ptab[:, F:2 * F] = rng.uniform(0.01, 0.1, size=(D, F))
    rows = rng.integers(0, N, size=(3, 8)).astype(np.int32)
    x = rng.uniform(0.5, 1.5, size=(3, 8)).astype(np.float32)
    rows[:, 5:], x[:, 5:] = N - 1, 0.0
    nsig = rng.uniform(20.0, 60.0, size=(D, F)).astype(np.float32)
    nsig[9] = np.nan
    n_sig_w = rng.uniform(20.0, 60.0, size=D).astype(np.float32)
    n_sig_w[9] = np.nan

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def scalar(v):
        return torch.tensor(v, dtype=torch.float32, device=device)

    s = dict(
        tag="ragged", timed=False, F=F, D=D, w0=scalar(0.3), s0=scalar(0.02),
        stab=t(rng.normal(0, 0.3, size=(D, 1 + F)).astype(np.float32)),
        ttab=t(np.abs(rng.normal(0, 0.3, size=(D, 1 + 2 * F)))
               .astype(np.float32)),
        ids=t(ids), vals=t(vals), eval_ids=t(ids), eval_vals=t(vals),
        mu_t=t(ptab[:, :F]), sig_t=t(ptab[:, F:2 * F]), ptab=t(ptab),
        mu_w=t(rng.normal(0, 0.1, size=D).astype(np.float32)),
        sig_w=t(np.full(D, 0.02, np.float32)),
        sigma_w=t(np.array([1.0, 2.0], np.float32)),
        sv=t(rng.uniform(0.5, 2.0, size=(G, F)).astype(np.float32)),
        alpha=scalar(1.3),
        e=t(rng.normal(0, 1, size=N).astype(np.float32)),
        t=t(rng.uniform(0, 1, size=N).astype(np.float32)),
        q=t(rng.normal(0, 1, size=(N, F)).astype(np.float32)),
        tq=t(rng.uniform(0, 1, size=(N, F)).astype(np.float32)),
        tz=t(rng.uniform(0, 1, size=(N, F)).astype(np.float32)),
        ptab_patch=t(ptab))
    bucket = dict(rows=t(rows), x=t(x), cols=t(np.array([2, 9, 17], np.int32)),
                  group=t(np.array([0, 1, 1], np.int32)),
                  sx2=t((x * x).sum(1)),
                  cnt=t(np.array([5.0, 5.0, 0.0], np.float32)),
                  col_count=t(np.array([40.0, 12.0, 7.0], np.float32)))
    s["buckets"] = [bucket]
    common = {k: s[k] for k in ("timed", "D", "ids", "vals", "e", "t",
                                "alpha", "mu_w", "sig_w")}
    dtab = t(rng.normal(0, 0.1, size=(D, 2)).astype(np.float32))
    # K5 in batch-VB mode: group 1's sigma_w is NaN (columns 9 and 17)
    wbin = [BlockData(**bucket)]
    vb = dict(common, tag="ragged", ovb=False, w_bins=[wbin], dtab=dtab,
              w_sigma_w=t(np.array([1.0, np.nan], np.float32)))
    # K5 in online mode, K6 (F = 5: three idle factor lanes) and K4 with
    # every position reading the pre-patch caches
    ov = dict(common, tag="ragged", ovb=True, w_bins=[wbin], dtab=dtab,
              w_sigma_w=s["sigma_w"],
              n_mu_w=t(rng.normal(0, 5, size=D).astype(np.float32)),
              n_sig_w=t(n_sig_w),
              t_wj=t(rng.integers(0, 30, size=D).astype(np.float32)),
              rho_w=t(rng.uniform(0.1, 1.0, size=D).astype(np.float32)),
              vF=F, v_ptab=t(ptab[:, :5 * F]), v_mu=s["mu_t"],
              v_sig=s["sig_t"],
              v_nmu=t(rng.normal(0, 5, size=(D, F)).astype(np.float32)),
              v_nsig=t(nsig), v_sv=s["sv"],
              rho_v=t(rng.uniform(0.1, 1.0, size=D).astype(np.float32)),
              vq=s["q"], vtq=s["tq"], vtz=s["tz"],
              v_bins=[ko.BinPlan([BlockData(**bucket)])],
              v_ptab_patch=t(ptab[:, :5 * F]))
    return [s, vb, ov, ragged_mcmc_tensors(device),
            *ragged_sgd_tensors(device), ragged_bs_tensors(device),
            *ragged_w_tensors(device), *ragged_win_tensors(device),
            *ragged_mwin_tensors(device), ragged_probit_tensors(device),
            serve_tensors(device, ragged=True),
            *(ragged_tp_tensors(device, K) for K in (3, 5)),
            ragged_tp_ovb_tensors(device), ragged_dp_ovb_tensors(device),
            ragged_tp_sgd_tensors(device)]


def ragged_tp_tensors(device, K: int) -> dict:
    """T1-T4 on a small problem at K = 3 or 5 (chunks of one factor), an
    odd D (the second of two feature shards holds a padding column) and
    buckets with padding columns: ``tp_tensors`` of a fast-mode VB init."""
    from svbfm_tpu_torch.data.dataset import SparseDataset
    from svbfm_tpu_torch.data.meta import DataMetaInfo
    from svbfm_tpu_torch.data.synth import (make_movielens_like,
                                            train_test_split)
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.vb import VBLearner, init_vb_params

    coo = make_movielens_like(37, 26, 900, rank=2, noise=0.4, seed=K)
    tr, te = train_test_split(coo, 0.2, seed=K + 1)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, 37])
    cfg = FMConfig(num_attributes=D, num_factor=K, num_groups=2, seed=SEED,
                   min_target=float(tr.target.min()),
                   max_target=float(tr.target.max()))
    lr = VBLearner(cfg, SparseDataset.from_coo(tr, D),
                   SparseDataset.from_coo(te, D), meta, device=device,
                   write_files=False)
    s = tp_tensors(lr, lr.state_from_params(init_vb_params(
        torch.Generator().manual_seed(SEED), cfg, device)))
    s["tag"] = f"tp-ragged K={K}"
    return s


def ragged_w_tensors(device) -> list:
    """K5's bin launch in its four modes on two ragged bins: one of buckets
    of L = 1, 8 (one of them empty), 16, 33 and 512 beside a [3, 8] bucket
    with padding entries at the last row, and one of 40 small buckets, so
    that a block looks past the plan's first 32 rows for its bucket.  e is
    NaN at one row, so the columns that gather it get NaN sums: counted
    candidates in the VB, OVB and MCMC modes, reverted steps in the
    gradient mode.  Group 1's sigma_w is NaN in the VB mode and its lambda
    in the MCMC mode (non-finite candidates; MCMC's draws come out 0,
    uncounted); in the OVB mode one column's eta2 is NaN and one has
    cnt = 0; one noise number is Inf (a counted, reverted draw).  Returns
    the VB, the OVB, and the MCMC + gradient tensor sets."""
    from svbfm_tpu_torch.learners.base import BlockData

    rng = np.random.default_rng(5)
    N, P, D = 64, 3, 200

    def t(a, dt=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(device)

    def make_bin(widths, cols):
        out = []
        for C, L in widths:
            rows = rng.integers(0, N - 1, size=(C, L))
            x = rng.uniform(0.5, 1.5, size=(C, L))
            if L == 512:
                rows[0, 400:], x[0, 400:] = N - 1, 0.0
            cnt = (x != 0).sum(1).astype(np.float32)
            group = (rng.uniform(size=C) < 0.2).astype(np.int32)
            out.append(BlockData(
                rows=t(rows, np.int32), x=t(x), cols=t(cols[:C], np.int32),
                group=t(group, np.int32), sx2=t((x * x).sum(1)), cnt=t(cnt),
                col_count=t(cnt + rng.integers(0, 9, size=C))))
            cols = cols[C:]
        return out, cols

    cols = rng.permutation(D)
    first, cols = make_bin(((7, 1), (0, 8), (5, 8), (4, 16), (3, 33),
                            (2, 512), (3, 8)), cols)
    first[-1].rows[:, 5:], first[-1].x[:, 5:] = N - 1, 0.0  # padding
    first[-1].sx2.copy_((first[-1].x ** 2).sum(1))
    first[-1].cnt.fill_(5.0)
    first[2].cnt[1] = 0.0
    many, cols = make_bin([(int(rng.integers(0, 3)), int(rng.choice(
        [1, 2, 3, 5]))) for _ in range(40)], cols)
    e = rng.standard_normal(N)
    e[int(first[0].rows[0, 0])] = np.nan
    ids = rng.integers(0, D, size=(N, P))
    vals = rng.uniform(0.5, 1.5, size=(N, P))
    n_sig_w = rng.uniform(20.0, 60.0, size=D)
    n_sig_w[int(first[3].cols[2])] = np.nan
    zw = rng.standard_normal(D)
    zw[int(first[2].cols[3])] = np.inf
    bins = [first, many]
    vb = dict(tag="ragged-w", timed=False, D=D, ids=t(ids, np.int32),
              vals=t(vals), e=t(e), t=t(rng.uniform(0, 1, size=N)),
              alpha=torch.tensor(1.3, device=device),
              mu_w=t(rng.normal(0, 0.1, size=D)),
              sig_w=t(np.full(D, 0.02)), ovb=False, w_bins=bins,
              w_sigma_w=t(np.array([1.0, np.nan])),
              dtab=t(rng.normal(0, 0.1, size=(D, 2))))
    ov = dict(vb, ovb=True, w_sigma_w=t(np.array([1.0, 2.0])),
              n_mu_w=t(rng.normal(0, 5, size=D)), n_sig_w=t(n_sig_w),
              t_wj=t(rng.integers(0, 30, size=D)),
              rho_w=t(rng.uniform(0.1, 1.0, size=D)))
    mw = dict(tag="ragged-w", timed=False, D=D, ids=vb["ids"],
              vals=vb["vals"], mw_bins=bins, mw_w=t(rng.standard_normal(D)),
              mw_mu=t(rng.standard_normal(2)),
              mw_lambda=t(np.array([2.0, np.nan])),
              mw_alpha=torch.tensor(1.7, device=device), mw_e=vb["e"],
              mw_z=t(zw), mw_dtab=vb["dtab"], x_e=vb["e"],
              x_w=t(rng.standard_normal(D)), x_step=(0.4, 0.05, float(N)),
              xw_bins=bins)
    return [vb, ov, mw]


def mcmc_tensors(learner, state) -> dict:
    """Gibbs/ALS kernel inputs at the path's shapes, from a state one sweep
    into a run (drawn priors and residual): X8d, X8a and X8b on the block of
    all K factors (F = K) and on factor 0 alone (F = 1), X8a on the largest
    bucket of each bin at F = K and on every bucket at F = 1, with and
    without a noise table, in both draw modes; X8c on the largest buckets;
    the patch tables as each bin leaves them (X8b's, from the pre-sweep
    v), the w patch's as bin 0 leaves it."""
    from svbfm_tpu_torch.kernels import mcmc_sweep as km
    from svbfm_tpu_torch.kernels import vb_sweep as kv
    from svbfm_tpu_torch.kernels import w_sweep as kw

    plan, row = learner.plan_data, learner.train_row
    D, K = learner.cfg.num_attributes, learner.cfg.num_factor
    dev = state.e.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    big = [_bucket_dict(max(bb, key=lambda b: b.rows.numel()))
           for bb in plan.blocks]
    s = dict(tag="mcmc", D=D, ids=row.ids, vals=row.vals, mF=K,
             mw_bins=list(plan.blocks), mw_w=state.w.clone(),
             mw_mu=state.w_mu, mw_lambda=state.w_lambda,
             mw_alpha=state.alpha, mw_e=state.e,
             mw_z=torch.randn(D, generator=gen, device=dev))
    dtab = torch.zeros(D, 2, device=dev)
    kw.mcmc_w_bin_draw_plain(plan.blocks[0], state.e, state.w.clone(),
                             state.w_mu, state.w_lambda, state.alpha,
                             s["mw_z"], dtab, _bad(dev))
    s["mw_dtab"] = dtab
    every = [_bucket_dict(b) for bb in plan.blocks for b in bb]
    for F, sfx in ((K, ""), (1, "1")):
        vt = state.v[:F].T.contiguous()
        ptab = torch.cat([vt, torch.zeros_like(vt)], 1)
        m = dict(vt=vt, ptab=ptab, ids64=row.ids.long(), e=state.e,
                 q=kv.build_q_plain(ptab, F, row.ids, row.vals),
                 mu=state.v_mu[:, :F].contiguous(),
                 lam=state.v_lambda[:, :F].contiguous(), alpha=state.alpha,
                 z=torch.randn(F, D, generator=gen, device=dev),
                 buckets=every if F == 1 else big)
        m["ptab_patch"] = []
        for bin_blocks in plan.blocks:
            pt, v2 = ptab.clone(), vt.clone()
            for blk in bin_blocks:
                km.mcmc_col_draw_plain(
                    blk.rows, blk.x, blk.cols, blk.group, m["e"], m["q"], pt,
                    v2, m["mu"], m["lam"], m["alpha"], m["z"], True,
                    torch.zeros(2, dtype=torch.int32, device=dev))
            m["ptab_patch"].append(pt)
        s.update({f"m{sfx}_{k}": v for k, v in m.items()})
    return s


def exp_sgd_tensors(learner, state) -> dict:
    """X9d's inputs at the exp_sgd path's shapes, from a state: e = stdev
    yhat - y, K5's gradient mode on the largest bucket of each bin, X8a's
    gradient mode on the same buckets at F = K and on every bucket at
    F = 1."""
    from svbfm_tpu_torch.kernels import vb_sweep as kv
    from svbfm_tpu_torch.ops.forward import fm_scores

    cfg, plan, row = learner.cfg, learner.plan_data, learner.train_row
    D, K = cfg.num_attributes, cfg.num_factor
    e = (cfg.stdev * fm_scores(state.w0, state.w, state.v, row.ids, row.vals)
         - row.target) * row.valid
    big = [_bucket_dict(max(bb, key=lambda b: b.rows.numel()))
           for bb in plan.blocks]
    every = [_bucket_dict(b) for bb in plan.blocks for b in bb]
    xg = []
    for F in (K, 1):
        vt = state.v[:F].T.contiguous()
        ptab = torch.cat([vt, torch.zeros_like(vt)], 1)
        xg.append((F, dict(vt=vt, ptab=ptab,
                           buckets=every if F == 1 else big,
                           q=kv.build_q_plain(ptab, F, row.ids, row.vals))))
    n = float(learner.train_n)
    return dict(tag="exp-sgd", D=D, x_e=e, x_w=state.w.clone(),
                x_step=(cfg.learn_rate, cfg.regw, n),
                x_vstep=(cfg.learn_rate, cfg.regv, n),
                xw_bins=list(plan.blocks), xg=xg)


def _rebucket(b, rows, x):
    """Relation bucket ``b`` with other slots, its real counts recounted."""
    from svbfm_tpu_torch.kernels import bs_sweep as ks

    x = x.contiguous()
    return dataclasses.replace(b, rows=rows.contiguous(), x=x,
                               real=ks.real_counts(x))


def join_agg_twin(buckets, e, q, F: int, rtab) -> None:
    """X10a's twin (``bs_join_agg_plain``) on column chunks of each bucket
    of at most BS_TWIN_FLOATS channel floats: a relation row's sums are its
    own column's, so the result is the twin's on the whole plan."""
    from svbfm_tpu_torch.kernels import bs_sweep as ks
    from svbfm_tpu_torch.learners.mcmc_bs import JoinBlock

    CH = ks.agg_channels(F)
    parts = []
    for b in buckets:
        C, L = b.rows.shape
        step = max(1, BS_TWIN_FLOATS // max(CH * L, 1))
        parts += [JoinBlock(rows=b.rows[c:c + step], x=b.x[c:c + step],
                            cols=b.cols[c:c + step])
                  for c in range(0, C, step)]
    ks.bs_join_agg_plain(parts, e, q, F, rtab)


def bs_tensors(learner, state, tag: str, timed: bool, widths,
               poison: bool = False, agg_widths=(), agg_checks=()) -> dict:
    """X10a-X10d inputs from a block-structure learner and a state, per
    relation and per width F in ``widths`` (0: the w sweep): the relation
    table as X10a starts it (qB0 of the first F factors, wn) and as it
    leaves it, the buckets to draw (timed: the one-hot bin's largest and the
    longest of the other bins; else every bucket), the patch tables as
    each picked bin leaves them, the resync's dy and qB; the moments and,
    with the first relation, the joined scores.  ``poison`` (the ragged
    case): the last bucket's first column is moved to an extra group whose
    lambda is NaN (its draws come out 0, uncounted), the first pick's first
    column has an Inf noise number (counted, reverted), the one-hot
    bucket is also drawn cut to L = 1 and widened to L = 32 (one real
    entry), and the longest bucket cut to its first 32 slots and with its
    first column all padding.  ``agg_widths``: widths past K at which X10a
    alone runs, from seeded q and qB0 (its block form, F > 32);
    ``agg_checks``: widths at which X10a alone is checked, not timed, on
    the join plan cut to BS_AGG_CHECK_COLS relation rows a bucket (renumbered
    0, 1, ...), from seeded q and qB0, with no poison, a NaN e and an Inf q
    at the pad row N - 1."""
    from svbfm_tpu_torch.kernels import bs_forward as kf
    from svbfm_tpu_torch.kernels import bs_sweep as ks
    from svbfm_tpu_torch.learners.mcmc_bs import JoinBlock, param_table

    dev = state.e.device
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rels, rstats = learner.rels, learner.rstats
    stab = param_table(state.w, state.v, True)
    moms = [kf.bs_rel_moments_plain(rd.rrow_ids, rd.rrow_vals, stab,
                                    rs.attr_offset)
            for rd, rs in zip(rels, rstats)]
    e, row = state.e, learner.train_row
    N = e.shape[0]
    out = []
    for i, (rd, rs, mom) in enumerate(zip(rels, rstats, moms)):
        R, Dr, off = rs.num_rows, rs.num_attrs, rs.attr_offset
        bins = [(b_i, bb) for b_i, bb in enumerate(rd.rplan) if bb]
        if timed:
            rest = [(b_i, b) for b_i, bb in bins[1:] for b in bb]
            picks = [(bins[0][0], max(bins[0][1],
                                      key=lambda b: b.rows.numel()))]
            if rest:
                picks.append(max(rest, key=lambda t: t[1].rows.shape[1]))
        else:
            picks = [(b_i, b) for b_i, bb in bins for b in bb]
        G = state.w_mu.shape[0]
        if poison:
            b_l, last = picks[-1]
            bad = last.group.clone()
            bad[0] = G
            b_0, first = picks[0]
            b_w, wide = max(picks, key=lambda t: t[1].rows.shape[1])
            blank = wide.x.clone()
            blank[0] = 0.0
            widen = (0, 32 - first.rows.shape[1])
            # X10b's edge cases: one real entry in 32 slots, 32 real
            # entries in 32 slots, a long bucket with an all-padding column
            picks[1:1] = [
                (b_0, _rebucket(first, torch.nn.functional.pad(first.rows,
                                                               widen),
                                torch.nn.functional.pad(first.x, widen))),
                (b_w, _rebucket(wide, wide.rows[:, :32], wide.x[:, :32])),
                (b_w, _rebucket(wide, wide.rows, blank))]
            picks[-1] = (b_l, dataclasses.replace(last, group=bad))
            picks.append((b_0, _rebucket(first, first.rows[:, :1],
                                         first.x[:, :1])))
        r = dict(name=f"rel{i}", rd=rd, Dr=Dr, off=off, e=e,
                 alpha=state.alpha, stab=stab, widths=[], agg_widths=[],
                 agg_checks=[])
        for F in agg_widths:
            lay = ks.rel_layout(F)
            rtab0 = torch.zeros(R, lay["ld"], device=dev)
            rtab0[:, :F] = torch.randn(R, F, generator=gen, device=dev)
            r["agg_widths"].append((F, dict(
                rtab0=rtab0,
                q=torch.randn(N, F, generator=gen, device=dev))))
        for F in agg_checks:
            cut, n0 = [], 0
            for b in rd.jplan:
                c = min(b.rows.shape[0], BS_AGG_CHECK_COLS)
                cut.append(JoinBlock(rows=b.rows[:c], x=b.x[:c],
                                     cols=torch.arange(n0, n0 + c,
                                                       dtype=torch.int32,
                                                       device=dev)))
                n0 += c
            rtab0 = torch.zeros(n0, ks.rel_layout(F)["ld"], device=dev)
            rtab0[:, :F] = torch.randn(n0, F, generator=gen, device=dev)
            qc = torch.randn(N, F, generator=gen, device=dev)
            for bad in (None, "e", "q"):
                ep, qp = e, qc
                if bad == "e":
                    ep = e.clone()
                    ep[N - 1] = float("nan")
                elif bad == "q":
                    qp = qc.clone()
                    qp[N - 1, F - 1] = float("inf")
                r["agg_checks"].append((F, bad, dict(plan=cut, e=ep, q=qp,
                                                     rtab0=rtab0)))
        for F in widths:
            Fo = max(F, 1)
            lay = ks.rel_layout(F)
            rtab0 = torch.zeros(R, lay["ld"], device=dev)
            rtab0[:, lay["wn"]] = rd.wnum
            if F == 0:
                q = qB0 = None
                vt = state.w[off:off + Dr].clone()
                mu, lam = state.w_mu.clone(), state.w_lambda.clone()
                z = torch.randn(Dr, generator=gen, device=dev)
            else:
                qB0 = mom[:, :F].contiguous()
                rtab0[:, :F] = qB0
                q = torch.zeros(N, F, device=dev)
                for rd2, mom2 in zip(rels, moms):
                    kf.bs_resync_plain(rd2.join_tr, F, None,
                                       mom2[:, :F].contiguous(), None,
                                       q, None)
                vt = state.v[:F, off:off + Dr].T.contiguous()
                mu = state.v_mu[:, :F].contiguous()
                lam = state.v_lambda[:, :F].contiguous()
                z = torch.randn(F, Dr, generator=gen, device=dev)
            if poison:
                mu = torch.cat([mu, mu[:1]])
                lam = torch.cat([lam, torch.full_like(lam[:1], float("nan"))])
                z.view(Fo, Dr)[:, picks[0][1].cols[0].long()] = float("inf")
            rtab = rtab0.clone()
            join_agg_twin(rd.jplan, e, q, F, rtab)
            ptab = torch.cat([vt.view(Dr, Fo), torch.zeros(Dr, Fo,
                                                           device=dev)], 1)
            patched = []
            for b_i in sorted({b_i for b_i, _ in picks}):
                pt, v2 = ptab.clone(), vt.clone()
                nans = torch.zeros(2, dtype=torch.int32, device=dev)
                for b in rd.rplan[b_i]:
                    if F == 0:
                        ks.bs_rel_w_draw_plain(b.rows, b.x, b.cols, b.group,
                                               rtab, pt, v2, mu, lam,
                                               state.alpha, z, nans)
                    else:
                        ks.bs_rel_draw_plain(b.rows, b.x, b.cols, b.group,
                                             rtab, F, pt, v2, mu, lam,
                                             state.alpha, z, nans)
                patched.append((b_i, pt))
            b_i, pt = patched[0]
            rt, dy = rtab.clone(), torch.zeros(R, Fo, device=dev)
            if F == 0:
                ks.bs_rel_w_patch_plain(rd.rrow_ids, rd.rrow_vals,
                                        rd.patch_pos[b_i], pt, rt, dy)
            else:
                ks.bs_rel_patch_plain(rd.rrow_ids, rd.rrow_vals,
                                      rd.patch_pos[b_i], pt, F, rt, dy)
            r["widths"].append((F, dict(
                q=q, qB0=qB0, qB1=rt[:, :F] if F else None, dy=dy,
                rtab0=rtab0, rtab=rtab, picks=picks, z=z, mu=mu, lam=lam,
                vt=vt, ptab=ptab, patched=patched)))
        if i == 0:
            # the learner's relations on the train and the test rows, and
            # nine made from them (each join rolled, each table scaled)
            joins = [rd2.join_tr for rd2 in rels]
            nr = len(rels)
            nine = []
            for k in range(NINE_RELATIONS):
                m = moms[k % nr]
                nine.append(kf.moments_table(m.shape[0], m.shape[1] - 2, dev)
                            .copy_(m * (1.0 + 0.05 * k)))
            test = learner.test_row
            r["scores"] = [dict(label="train", ids=row.ids, vals=row.vals,
                                w0=state.w0, joins=joins, moms=moms),
                           dict(label="test", ids=test.ids, vals=test.vals,
                                w0=state.w0,
                                joins=[rd2.join_te for rd2 in rels],
                                moms=moms),
                           dict(label="nine", ids=row.ids, vals=row.vals,
                                w0=state.w0,
                                joins=[joins[k % nr].roll(k)
                                       for k in range(NINE_RELATIONS)],
                                moms=nine)]
            for sc in r["scores"]:  # the moments rows the bound charges
                sc["rows_read"] = sum(int(j.unique().numel())
                                      for j in sc["joins"])
        out.append(r)
    return dict(tag=tag, timed=timed, D=state.w.shape[0], bs=out)


def small_bs_learner(device, K: int = 20, factor_block: int = 0,
                     als: bool = False, n_rel: int = 2,
                     main_users: bool = False):
    """A small relational problem for the ragged checks: 3000 ratings, a
    user relation of 1200 rows (its two attribute slots hold columns of
    about 600 rows, long enough for X10b to split them over blocks) and an
    item relation of 50 rows, both with 2 slots; an empty main block.
    ``n_rel`` > 2 adds relations of 8, 13, 18, ... rows (one-hot + 1 slot),
    each with its own join.  ``main_users``: the users are one-hot columns
    of the main block instead of a relation (the Gibbs/ALS main-block pass
    then runs beside the relations)."""
    from svbfm_tpu_torch.data.dataset import SparseDataset
    from svbfm_tpu_torch.data.libfm_text import COOData
    from svbfm_tpu_torch.data.meta import DataMetaInfo
    from svbfm_tpu_torch.data.relation import build_joined_meta
    from svbfm_tpu_torch.data.synth import make_relation
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.mcmc_bs import ALSBSLearner, MCMCBSLearner

    rng = np.random.default_rng(11)
    n, nu, ni = 3000, 1200, 50
    users, items = rng.integers(0, nu, n), rng.integers(0, ni, n)
    y = (3.5 + 0.5 * rng.standard_normal(n)).astype(np.float32)
    rels = [make_relation(nu, nu, 2, seed=1), make_relation(ni, ni, 2, seed=2)]
    joins = [users, items]
    for r in range(n_rel - 2):
        size = 8 + 5 * r
        rels.append(make_relation(size, size, 1, seed=3 + r))
        joins.append(rng.integers(0, size, n))
    d_main = nu if main_users else 0
    if main_users:
        rels, joins = rels[1:], joins[1:]
        coo = COOData(row=np.arange(n, dtype=np.int32),
                      col=users.astype(np.int32), val=np.ones(n, np.float32),
                      target=y, num_rows=n, num_features=nu)
    else:
        coo = COOData(row=np.zeros(0, np.int32), col=np.zeros(0, np.int32),
                      val=np.zeros(0, np.float32), target=y, num_rows=n,
                      num_features=0)
    meta = build_joined_meta(DataMetaInfo(d_main), rels)
    D = meta.num_attributes
    main = SparseDataset.from_coo(coo, D)
    cfg = FMConfig(num_attributes=D, num_factor=K, num_groups=meta.num_attr_groups,
                   min_target=float(y.min()), max_target=float(y.max()),
                   seed=SEED, regw=0.5, regv=0.5, factor_block=factor_block)
    cls = ALSBSLearner if als else MCMCBSLearner
    return cls(cfg, main, main, rels, joins, joins, meta, d_main,
               device=device, write_files=False)


def ragged_bs_tensors(device) -> dict:
    """X10a-X10d on the small relational problem at F = 20, 5, 1 and the w
    sweep: every bucket (L = 1 one-hot buckets, split slot columns), a NaN
    group lambda and an Inf noise number (``bs_tensors``' poison)."""
    learner = small_bs_learner(device)
    state, _ = learner.step(learner.init_state())
    return bs_tensors(learner, state, "ragged-bs", False, (20, 5, 1, 0),
                      poison=True)


def ragged_mcmc_tensors(device) -> dict:
    """The X8a-X8d, X8c and P1 checks on small ragged inputs, at F = 6 and
    17 columns as test_mcmc.py:247-292 draws them: column 3 sits in a group
    whose lambda is NaN (its draws must come out 0, uncounted) and column 5
    has an Inf noise number at factor 2 (its draw is counted and
    reverted); X8c's bucket has a NaN-lambda group and an Inf noise number
    at column 2; the patch rows have padding entries."""
    from svbfm_tpu_torch.learners.base import BlockData

    rng = np.random.default_rng(0)
    N, P, D, F, C, L = 40, 3, 30, 6, 17, 8

    def t(a, dt=np.float32):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(device)

    ids = rng.integers(0, D, size=(N, P))
    vals = rng.uniform(0.5, 1.5, size=(N, P))
    pad = np.arange(P)[None, :] >= rng.integers(1, P + 1, size=N)[:, None]
    ids[pad], vals[pad] = 0, 0.0
    cols = np.sort(rng.permutation(D)[:C])
    rows = rng.integers(0, N, size=(C, L))
    x = rng.uniform(0.5, 1.5, size=(C, L))
    rows[::4, 5:], x[::4, 5:] = N - 1, 0.0  # padding entries
    group = np.zeros(C)
    group[3] = 1
    bucket = dict(rows=t(rows, np.int32), x=t(x), cols=t(cols, np.int32),
                  group=t(group, np.int32), sx2=t((x * x).sum(1)))
    lam = np.abs(rng.standard_normal((2, F))) + 0.3
    lam[1] = np.nan
    z = rng.standard_normal((F, D))
    z[2, cols[5]] = np.inf
    v = rng.standard_normal((D, F))
    dv = np.where(rng.uniform(size=(D, F)) < 0.5, rng.normal(0, 0.1, (D, F)),
                  0.0)
    e = rng.standard_normal(N)
    q = rng.standard_normal((N, F))
    mu = rng.standard_normal((2, F))
    s = dict(tag="ragged-mcmc", timed=False, D=D, ids=t(ids, np.int32),
             vals=t(vals), mF=F)
    for sfx, fs in (("", slice(0, F)), ("1", slice(2, 3))):
        Fs = fs.stop - fs.start
        ptab = np.concatenate([v[:, fs], np.zeros((D, Fs))], 1)
        s.update({f"m{sfx}_{k}": a for k, a in dict(
            vt=t(v[:, fs]), ptab=t(ptab), ids64=t(ids, np.int64), e=t(e),
            q=t(q[:, fs]), mu=t(mu[:, fs]), lam=t(lam[:, fs]),
            alpha=torch.tensor(1.7, device=device), z=t(z[fs]),
            buckets=[bucket],
            ptab_patch=[t(np.concatenate([v[:, fs], dv[:, fs]], 1))]).items()})
    w_lam = np.array([2.0, np.nan])
    zw = rng.standard_normal(D)
    zw[cols[2]] = np.inf
    wbin = [BlockData(**bucket, cnt=t(np.full(C, L)),
                      col_count=t(np.full(C, L)))]
    s.update(mw_bins=[wbin], mw_w=t(rng.standard_normal(D)),
             mw_mu=t(rng.standard_normal(2)), mw_lambda=t(w_lam),
             mw_alpha=torch.tensor(1.3, device=device), mw_e=t(e),
             mw_z=t(zw),
             mw_dtab=t(np.stack([rng.normal(0, 0.1, D), np.zeros(D)], 1)))
    # P1: N = 40 and 37 indices (37 not a multiple of 4), and indices
    # whose base is one element past a 16-byte boundary
    i1 = t(rng.integers(0, D, size=N + 1), np.int32)
    il = t(rng.integers(0, 7, size=5 * 128 + 1), np.int32)
    t1, tl = t(rng.standard_normal((D, 1))), t(rng.standard_normal((7, 128)))
    s["gathers"] = [
        ("ragged 1-D", t1, i1[:N].view(N, 1)),
        ("ragged 1-D n=37", t1, i1[:37].view(37, 1)),
        ("ragged 1-D n=37 base+1", t1, i1[1:38].view(37, 1)),
        ("ragged lanes", tl, il[:640].view(5, 128)),
        ("ragged lanes base+1", tl, il[1:].view(5, 128))]
    # X9d, K5's and X8a's gradient modes, on the same bucket at F = 1, 5 and
    # 20: e is NaN at a row of column 6 (its w step reverts), q Inf at a row
    # of column 4 (its v steps revert)
    xe = e.copy()
    xe[rows[6, 1]] = np.nan
    v20, q20 = rng.standard_normal((D, 20)), rng.standard_normal((N, 20))
    q20[rows[4, 0]] = np.inf
    step = (0.4, 0.05, float(N))
    s.update(x_e=t(xe), x_w=t(rng.standard_normal(D)), x_step=step,
             x_vstep=step, xw_bins=[wbin], xg=[
                 (Fx, dict(vt=t(v20[:, :Fx]), q=t(q20[:, :Fx]),
                           ptab=t(np.concatenate([v20[:, :Fx],
                                                  np.zeros((D, Fx))], 1)),
                           buckets=[bucket])) for Fx in (1, 5, 20)])
    return s


def sgd_tensors(sgd, exp, sgda, bpr, device) -> dict:
    """X9a-X9c inputs at the paths' shapes: a batch of train rows as SGD
    and exp-SGD take them (1024), SGDA's theta batch and validation batch,
    a BPR pair batch with its negatives; a random table, SGDA regs and
    caches.  Also the SGD batch on a table of ML-10M's width, D = 82,248
    (``sgd_wide``), where X9b's time must not grow with D."""
    gen = torch.Generator(device=device).manual_seed(SEED)
    D, K = sgd.cfg.num_attributes, sgd.cfg.num_factor
    G = sgda.cfg.num_groups

    def randn(*shape):
        return 0.1 * torch.randn(*shape, generator=gen, device=device)

    def batch(learner, row):
        n = row.ids.shape[0]
        idx = torch.randperm(n, generator=gen, device=device)[
            : n // learner.num_batches]
        return tuple(t.index_select(0, idx) for t in (
            row.ids, row.vals, row.target, row.valid))

    rows = batch(sgd, sgd.train_row)
    pairs = batch(bpr, bpr.train_row)
    neg = torch.randint(bpr.neg_lo, bpr.neg_hi, (pairs[0].shape[0],),
                        generator=gen, device=device, dtype=torch.int32)
    g = dict(tab=randn(D, 1 + K), w0=torch.tensor(3.5, device=device),
             range=(bpr.neg_lo, bpr.neg_hi),
             reg_w=0.5 * torch.rand(G, generator=gen, device=device),
             reg_v=0.5 * torch.rand(G, K, generator=gen, device=device),
             grad_tab=randn(D, 1 + K), attr_group=sgda.attr_group,
             val=batch(sgda, sgda.val_row),
             modes=[("regression", sgd.mode, "row", rows),
                    ("exp", exp.mode, "row", rows),
                    ("sgda", sgda.mode, "sgda", batch(sgda, sgda.train_row)),
                    ("pair", bpr.mode, "pair", pairs + (neg,))])
    wide = dict(tab=randn(ML10M_FEATURES, 1 + K), w0=g["w0"],
                modes=[("regression-wide", sgd.mode, "row", rows)])
    # X9a's classification and Poisson modes on the same rows, their
    # targets binarised at 3.5 and the stars above 3 as counts; X9a, X9b
    # and X9c in SGDA's classification mode on its batches, binarised
    from svbfm_tpu_torch.learners.sgd import sgd_step_mode

    def binary(b):
        return b[:2] + (torch.where(b[2] > CLASS_THRESHOLD, 1.0, -1.0),
                        b[3])

    def task_mode(cfg, task, lo, hi, **kw):
        return sgd_step_mode(dataclasses.replace(
            cfg, task=task, min_target=lo, max_target=hi), **kw)

    counts = rows[:2] + (torch.clamp(rows[2] - 3.0, min=0.0), rows[3])
    tasks = dict(g, val=binary(g["val"]), lambda_more=(), modes=[
        ("classification", task_mode(sgd.cfg, 1, -1.0, 1.0), "row",
         binary(rows)),
        ("poisson", task_mode(sgd.cfg, 2, 0.0, 2.0), "row", counts),
        ("sgda-classification",
         task_mode(sgda.cfg, 1, -1.0, 1.0, mult_scale=2.0, reg0=0.0),
         "sgda", binary(batch(sgda, sgda.train_row)))])
    # X9c also at the [sgd-quality] SGDA's width, K = 8, and on 1,000
    # validation rows, several a warp, also cut to the 8 blocks it falls
    # back to where the card holds no cluster of 16 (the last entry: the
    # cap; 0 is none)
    n_val = sgda.val_row.ids.shape[0]
    wide_val = torch.randperm(n_val, generator=gen, device=device)[:1000]
    rows1000 = tuple(t.index_select(0, wide_val) for t in (
        sgda.val_row.ids, sgda.val_row.vals, sgda.val_row.target,
        sgda.val_row.valid))
    g["lambda_more"] = [
        (randn(D, 1 + SGDA_K), randn(D, 1 + SGDA_K),
         0.5 * torch.rand(G, SGDA_K, generator=gen, device=device), g["val"],
         dataclasses.replace(sgda.mode, K=SGDA_K), 0),
        (g["tab"], g["grad_tab"], g["reg_v"], rows1000, sgda.mode, 0),
        (g["tab"], g["grad_tab"], g["reg_v"], rows1000, sgda.mode, 8)]
    return dict(tag="sgd", sgd=g, sgd_wide=wide, sgd_tasks=tasks)


# X9b's seeded cases: (label, D, B); the SGD path's shape at ML-1M's width,
# the regression mode at ML-10M's, and BPR's batch of 11,063 pairs, which
# names more entries than there are attributes
X9B_SEEDED = (("regression", NUM_USERS + NUM_ITEMS, 1024),
              ("sgda", NUM_USERS + NUM_ITEMS, 1024),
              ("pair", NUM_USERS + NUM_ITEMS, 1024),
              ("regression-wide", ML10M_FEATURES, 1024),
              ("pair-bpr", NUM_USERS + NUM_ITEMS, 11063))


def x9b_inputs(device, label: str, D: int, B: int):
    """X9b's inputs on a seeded batch of B rows of a user and an item
    (K = 20) on a table of D rows, in the mode ``label`` names: (tab, w0,
    ws, m, ids, neg, sgda, outs), ``outs`` the tensors X9b writes.  The
    accumulator and owners are made, not scattered by X9a (whose float
    atomics add in a run's own order): counts of 0-3 and
    gradients at the attributes the batch names, zero elsewhere, a tenth
    of the named rows with no count, a twentieth all zero."""
    from svbfm_tpu_torch.kernels import sgd_step as ks

    users, P, Kd, G = NUM_USERS, 2, K, 2
    gen = torch.Generator(device=device).manual_seed(SEED)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=device)

    ids = torch.stack([
        torch.randint(0, users, (B,), generator=gen, device=device),
        torch.randint(users, D, (B,), generator=gen, device=device)],
        1).to(torch.int32)
    neg = (torch.randint(users, D, (B,), generator=gen, device=device,
                         dtype=torch.int32) if label.startswith("pair")
           else None)
    entries = (ids.reshape(-1) if neg is None else
               torch.cat([ids.reshape(-1), neg])).long()
    named = torch.unique(entries)
    sgda = label == "sgda"
    ws = ks.make_workspace(D, Kd, device, sgda_batch=(B, P) if sgda
                           else None)
    ws.owner[entries] = torch.arange(entries.numel(), dtype=torch.int32,
                                     device=device)  # X9a's record
    n = named.numel()
    grads = 0.1 * (2 * rand(n, 1 + Kd) - 1)
    grads *= (rand(n, 1) > 0.05).float()
    ws.acc[named, 0] = torch.floor(4 * rand(n)) * (rand(n) > 0.1).float()
    ws.acc[named, 1:] = grads
    ws.acc0.copy_(torch.tensor([float(B), 3.0], device=device))
    tab = 0.1 * (2 * rand(D, 1 + Kd) - 1)
    w0 = torch.tensor(3.5, device=device)
    m = ks.StepMode(ks.LOSS_PAIR if neg is not None else
                    ks.LOSS_REGRESSION, K=Kd, lr=0.1,
                    mult_scale=2.0 if sgda else 1.0, base_w=0.999,
                    base_v=0.998, w0_base=0.9999, w0_grad=neg is None)
    extra, outs = None, [tab, w0, ws.acc, ws.acc0]
    if sgda:
        flat = torch.arange(B * P, dtype=torch.int32, device=device)
        ws.winner.scatter_reduce_(0, ids.reshape(-1).long(), flat, "amax")
        ws.gw_e.copy_(0.1 * rand(B, P))
        ws.gv_e.copy_(0.1 * rand(B, P, Kd))
        grad_tab = 0.1 * rand(D, 1 + Kd)
        attr_group = (torch.arange(D, device=device) >= users).to(
            torch.int32)
        extra = (0.5 * rand(G), 0.5 * rand(G, Kd), attr_group, grad_tab)
        outs += [grad_tab, ws.winner]
    return tab, w0, ws, m, ids, neg, extra, outs


def x9b_digests(device) -> dict:
    """sha256 (16 hex digits) of X9b's outputs after one call on each of
    ``X9B_SEEDED``'s inputs (``x9b_inputs``): a later run or a change to
    X9b is held to these bits."""
    import hashlib

    from svbfm_tpu_torch.kernels import sgd_step as ks

    out = {}
    for label, D, B in X9B_SEEDED:
        *args, outs = x9b_inputs(device, label, D, B)
        ks.sgd_apply(*args)
        h = hashlib.sha256()
        for o in outs:
            h.update(o.cpu().numpy().tobytes())
        out[label] = h.hexdigest()[:16]
    return out


def ragged_sgd_tensors(device) -> list:
    """X9a-X9c on small ragged inputs at K = 1, 5 and 40 (more than a warp
    of factors): 24 rows of a user (0-11), an item (12-29) and a third
    entry that is padding (id 0, x = 0) in every other row; an x = 0 entry
    at a real id; a padding row (valid 0); users repeated across rows
    (duplicate ids in a batch); a pair whose negative is its own item.  At
    K = 5 row 2's target is NaN (a non-finite multiplier) and so is one
    validation target (every SGDA reg comes out NaN)."""
    from svbfm_tpu_torch.kernels import sgd_step as ks

    out = []
    for K in (1, 5, 40):
        rng = np.random.default_rng(K)
        N, P, D, G = 24, 3, 30, 3

        def t(a, dt=np.float32):
            return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(
                device)

        def rows(n):
            ids = np.stack([rng.integers(0, 12, n), rng.integers(12, 30, n),
                            rng.integers(0, 12, n)], 1)
            vals = rng.uniform(0.5, 1.5, (n, P))
            ids[::2, 2], vals[::2, 2] = 0, 0.0
            vals[1, 2] = 0.0
            y = rng.uniform(1, 5, n)
            valid = np.ones(n)
            valid[-1] = 0.0
            if K == 5:
                y[2] = np.nan
            return t(ids, np.int32), t(vals), t(y), t(valid)

        batch = rows(N)
        neg = rng.integers(12, 30, N)
        neg[3] = batch[0][3, 1].item()
        lr, reg = 0.05, 0.01
        base = float(np.float32(1) - np.float32(lr) * np.float32(reg))
        common = dict(K=K, lr=lr, min_target=1.0, max_target=5.0)
        g = dict(tab=t(rng.normal(0, 0.3, (D, 1 + K))),
                 w0=torch.tensor(0.3, device=device),
                 range=(12, 30), reg_w=t(rng.uniform(0, 0.05, G)),
                 reg_v=t(rng.uniform(0, 0.05, (G, K))),
                 grad_tab=t(rng.normal(0, 0.1, (D, 1 + K))),
                 attr_group=t(np.minimum(np.arange(D) // 10, G - 1),
                              np.int32),
                 val=rows(10), modes=[
                     ("regression", ks.StepMode(
                         ks.LOSS_REGRESSION, base_w=base, base_v=base,
                         w0_base=1.0 - lr * 0.02, **common), "row", batch),
                     ("exp", ks.StepMode(ks.LOSS_EXP, stdev=1.5,
                                         base_w=base, base_v=base, **common),
                      "row", batch),
                     ("sgda", ks.StepMode(ks.LOSS_REGRESSION, mult_scale=2.0,
                                          **common), "sgda", batch),
                     ("pair", ks.StepMode(ks.LOSS_PAIR, base_w=base,
                                          base_v=base, w0_base=0.98,
                                          w0_grad=False, **common),
                      "pair", batch + (t(neg, np.int32),))])
        out.append(dict(tag=f"ragged-sgd K={K}", timed=False, sgd=g))
    return out


def serve_model():
    """scripts/bench_serve.py's model: w0 = 3.5, w and v 0.1 N(0, 1) from
    seed 0, D = 6,040 + 3,952, K = 20."""
    rng = np.random.default_rng(0)
    D = NUM_USERS + NUM_ITEMS
    w = 0.1 * rng.standard_normal(D).astype(np.float32)
    v = 0.1 * rng.standard_normal((K, D)).astype(np.float32)
    return 3.5, w, v


def serve_rows(first: int, rows: int):
    """Rows first..first + rows of scripts/bench_serve.py's requests: user
    n % 6,040 and item (7 n) % 3,952, both one-hot."""
    n = np.arange(first, first + rows, dtype=np.int64)
    ids = np.stack([(n % NUM_USERS).astype(np.int32),
                    (NUM_USERS + (n * 7) % NUM_ITEMS).astype(np.int32)], 1)
    return ids, np.ones((rows, 2), np.float32)


def serve_tensors(device, ragged: bool = False) -> dict:
    """The serve epilogue's inputs on ``device``: one batch of the serving
    path (2^20 rows; ``ragged``: 1,001 rows of 3 positions at K = 5, some
    of them padding, untimed), and 4,096 (ragged: 1,001) rows over a table
    whose linear channel is +Inf, -Inf or NaN at some features, a NaN
    value every ninth row, so that scores are NaN, +Inf and -Inf."""
    from svbfm_tpu_torch.ops.forward import score_table

    w0, w, v = serve_model()
    if ragged:
        rng = np.random.default_rng(SEED)
        w, v = w[:40], v[:5, :40]
        ids = rng.integers(0, 40, (1001, 3)).astype(np.int32)
        vals = rng.uniform(0.5, 1.5, (1001, 3)).astype(np.float32)
        ids[1::3, 2], vals[1::3, 2] = 39, 0.0
        bad_ids, bad_vals = ids, vals.copy()
    else:
        ids, vals = serve_rows(0, SERVE_BATCH)
        bad_ids, bad_vals = serve_rows(0, 4096)
    t = torch.from_numpy
    wb = w.copy()
    f = np.arange(wb.shape[0])
    wb[f % 11 == 0], wb[f % 13 == 1], wb[f % 17 == 2] = np.inf, -np.inf, np.nan
    bad_vals[::9, 0] = np.nan
    sv = dict(
        tab=score_table(t(w).to(device), t(v).to(device)),
        bad_tab=score_table(t(wb).to(device), t(v).to(device)),
        w0=torch.tensor(w0, dtype=torch.float32, device=device),
        ids=t(ids).to(device), vals=t(vals).to(device),
        bad_ids=t(bad_ids).to(device), bad_vals=t(bad_vals).to(device))
    # T12 on the partials of the same rows, summed over two feature shards
    # as the mesh's all-reduce leaves them, each mode; and on the poisoned
    # rows' (NaN, +-Inf scores), untimed
    from svbfm_tpu_torch.kernels import fm_forward as k1

    def partials(tab, ids, vals):
        D, K = tab.shape[0], tab.shape[1] - 1
        D_loc = -(-D // 2)
        padded = torch.nn.functional.pad(tab, (0, 0, 0, 2 * D_loc - D))
        return sum(k1.tp_fm_partials_plain(
            padded[f * D_loc:(f + 1) * D_loc], K, False, ids, vals,
            f * D_loc, D_loc) for f in (0, 1))

    good = partials(sv["tab"], sv["ids"], sv["vals"])
    bad = partials(sv["bad_tab"], sv["bad_ids"], sv["bad_vals"])
    tp_serve = [(f"{name}{tag}", part, sv["w0"], mode, timed)
                for name, mode in (("clamp", k1.SERVE_CLAMP),
                                   ("probit", k1.SERVE_PROBIT),
                                   ("score", k1.SERVE_SCORE))
                for tag, part, timed in (("", good, True),
                                         (" poisoned", bad, False))]
    return dict(tag="ragged" if ragged else "serve", timed=not ragged,
                serve=sv, tp_serve=tp_serve)


def serve_phase(build, card: str, dev) -> dict:
    """[serve]: BatchScorer at scripts/bench_serve.py's shape, 10M rows
    from host arrays to host predictions (the launch counts zeroed before
    and read after), held to the CPU twin on the first and last rows, in
    [1, 5]; the 4,096-row window (two in flight) equal to one-shot scoring
    bit for bit, and the probit scorer's probabilities against the twin;
    the device-resident rate over 8 distinct batches on the card, one
    fetch at the end; the host's fill of a pinned slot and one batch's
    copy to the card, timed alone.  Returns the serve run's launches, its
    predictions and its end-to-end rows/s."""
    from svbfm_tpu_torch.learners.base import TASK_CLASSIFICATION
    from svbfm_tpu_torch.serve import BatchScorer

    t0 = time.perf_counter()
    w0, w, v = serve_model()
    ids, vals = serve_rows(0, SERVE_ROWS)
    kw = dict(min_target=SERVE_LO, max_target=SERVE_HI)
    scorer = BatchScorer(w0, w, v, batch_rows=SERVE_BATCH, device=dev, **kw)
    warm = 2 * SERVE_BATCH  # both slots' pinned buffers, made once
    scorer.score_rows(ids[:warm], vals[:warm])
    t1 = time.perf_counter()
    out, launches = drive(build, "serve", lambda: scorer.score_rows(ids,
                                                                    vals))
    e2e = SERVE_ROWS / (time.perf_counter() - t1)
    if out.shape != (SERVE_ROWS,) or not np.isfinite(out).all() or not (
            (out >= SERVE_LO) & (out <= SERVE_HI)).all():
        raise AssertionError("serve: predictions not finite in [1, 5]")
    cpu = BatchScorer(w0, w, v, batch_rows=SERVE_CPU_ROWS, device="cpu",
                      **kw)
    n = SERVE_CPU_ROWS
    err = max(compare([torch.from_numpy(out[sl])], [torch.from_numpy(
        cpu.score_rows(ids[sl], vals[sl]))], "serve vs cpu")
        for sl in (slice(0, n), slice(SERVE_ROWS - n, SERVE_ROWS)))
    # many batches through a window of two: the slots reused under load
    m = SERVE_CHECK_ROWS
    small = BatchScorer(w0, w, v, batch_rows=SERVE_CHECK_BATCH, inflight=2,
                        device=dev, **kw)
    one = BatchScorer(w0, w, v, batch_rows=m, device=dev, **kw)
    if not np.array_equal(small.score_rows(ids[:m], vals[:m]),
                          one.score_rows(ids[:m], vals[:m])):
        raise AssertionError("serve: the 4,096-row window differs from "
                             "one-shot scoring")
    probit = BatchScorer(w0, w, v, batch_rows=SERVE_BATCH, device=dev,
                         task=TASK_CLASSIFICATION)
    pcpu = BatchScorer(w0, w, v, batch_rows=n, device="cpu",
                       task=TASK_CLASSIFICATION)
    perr = compare([torch.from_numpy(probit.score_rows(ids[:n], vals[:n]))],
                   [torch.from_numpy(pcpu.score_rows(ids[:n], vals[:n]))],
                   "serve probit vs cpu")
    # device-resident: distinct batches already on the card
    B = SERVE_BATCH
    res = []
    for b in range(SERVE_RESIDENT_BATCHES):
        bi, bv = serve_rows(b * B, B)
        res.append((torch.from_numpy(bi).to(dev), torch.from_numpy(bv).to(dev),
                    torch.empty(B, device=dev)))
    for bi, bv, o in res:
        scorer.score_device(bi, bv, out=o)
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b_ = torch.cuda.Event(enable_timing=True)
    t2 = time.perf_counter()
    a.record()
    for _ in range(SERVE_RESIDENT_PASSES):
        for bi, bv, o in res:
            scorer.score_device(bi, bv, out=o)
    b_.record()
    total = float(torch.stack([o.sum() for _, _, o in res]).sum())
    wall = time.perf_counter() - t2
    calls = SERVE_RESIDENT_PASSES * SERVE_RESIDENT_BATCHES
    resident = calls * B / wall
    kernel_ms = a.elapsed_time(b_) / calls
    # the host's fill of one pinned slot, and one batch's copy to the card
    pin_i = torch.empty((B, 2), dtype=torch.int32, pin_memory=True)
    pin_v = torch.empty((B, 2), dtype=torch.float32, pin_memory=True)
    fills = min(10, SERVE_ROWS // B)
    t3 = time.perf_counter()
    for b in range(fills):
        sl = slice(b * B, (b + 1) * B)
        pin_i.numpy()[:] = ids[sl]
        pin_v.numpy()[:] = vals[sl]
    fill_ms = (time.perf_counter() - t3) * 1e3 / fills
    d_i, d_v = torch.empty_like(pin_i, device=dev), torch.empty_like(
        pin_v, device=dev)
    h2d_ms = cuda_ms(lambda: (d_i.copy_(pin_i, non_blocking=True),
                              d_v.copy_(pin_v, non_blocking=True)), 10,
                     graph=False)
    del res, d_i, d_v
    say("serve", t0, rows=SERVE_ROWS, batch_rows=B, inflight=2,
        e2e_rows_per_s=f"{e2e:.0f}", resident_rows_per_s=f"{resident:.0f}",
        resident_kernel_ms_per_batch=f"{kernel_ms:.4f}",
        host_fill_ms_per_batch=f"{fill_ms:.3f}",
        h2d_ms_per_batch=f"{h2d_ms:.3f}", resident_sum=f"{total:.6e}",
        max_abs_err_vs_cpu=f"{err:.3e}", probit_max_abs_err=f"{perr:.3e}",
        window_rows=m, window_batch=SERVE_CHECK_BATCH,
        window_equals_one_shot=True,
        launches=json.dumps({k: c for k, c in launches.items() if c},
                            separators=(",", ":")), card=repr(card))
    return launches, out, e2e


def ckpt_phase(dev, runs: dict) -> None:
    """[ckpt-resume]: for each (name: (learner, run kwargs, tol)),
    CKPT_SWEEPS sweeps saved, a resume from the checkpoint and CKPT_SWEEPS
    more against 2 * CKPT_SWEEPS uninterrupted sweeps: every tensor of the
    state and every record's metric equal bit for bit where ``tol`` is
    None; else (a path whose kernels add with float atomics, so that two
    uninterrupted runs differ too, which the phase shows by running one
    twice) within ``tol`` = (rtol on the metrics, atol on the state).
    Each run starts from a fresh init_state (Gibbs, SGD: a new generator
    on the card) and, for OVB, a fresh epoch-order generator."""
    from svbfm_tpu_torch.utils.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    n = CKPT_SWEEPS

    def tensors(state):
        return {f.name: getattr(state, f.name)
                for f in dataclasses.fields(state)
                if isinstance(getattr(state, f.name), torch.Tensor)}

    def metrics(hist):
        return {k: [h[k] for h in hist] for k in hist[0]
                if not k.startswith("time_") and isinstance(hist[0][k], float)}

    def differ(a, b, ha, hb, tol):
        """The state fields and metrics where runs a and b differ: at all,
        or past ``tol``; and the largest differences."""
        ta, tb, ma, mb = tensors(a), tensors(b), metrics(ha), metrics(hb)
        d_state = max((float((ta[k] - tb[k]).abs().max()) for k in ta
                       if ta[k].numel()), default=0.0)
        d_rel = max((abs(x - y) / max(abs(y), 1e-30) for k in ma
                     for x, y in zip(ma[k], mb[k])), default=0.0)
        if tol is None:
            bad = [k for k in ta if not torch.equal(ta[k], tb[k])]
            bad += [k for k in ma if ma[k] != mb[k]]
        else:
            bad = [k for k in ta if not torch.allclose(
                ta[k], tb[k], rtol=0.0, atol=tol[1], equal_nan=True)]
            bad += [k for k in ma if any(
                abs(x - y) > tol[0] * abs(y) for x, y in zip(ma[k], mb[k]))]
        return bad, d_state, d_rel

    try:
        for name, (lr, kw, tol) in runs.items():
            def go(**extra):
                if hasattr(lr, "_member_rng"):  # OVB's host generators
                    lr.rng = np.random.default_rng(lr.cfg.seed + 1)
                return lr.run(lr.init_state(), verbose=False, **kw, **extra)
            full, hf = go(num_iter=2 * n)
            mgr = CheckpointManager(os.path.join(root, name))
            go(num_iter=n, ckpt=mgr, ckpt_every=n)
            res, hr = go(num_iter=2 * n, ckpt=mgr, ckpt_every=100)
            if [h["iter"] for h in hr] != list(range(n, 2 * n)):
                raise AssertionError(f"ckpt-resume {name}: the resumed run "
                                     f"ran iterations {[h['iter'] for h in hr]}")
            bad, d_state, d_rel = differ(res, full, hr, hf[n:], tol)
            if bad:
                raise AssertionError(f"ckpt-resume {name}: resumed and "
                                     f"uninterrupted differ in {bad} "
                                     f"(state {d_state:.3e}, metrics "
                                     f"{d_rel:.3e}, tol {tol})")
            kv = dict(path=name, sweeps=f"{n}+{n}",
                      bitwise_equal=not differ(res, full, hr, hf[n:],
                                               None)[0],
                      max_state_diff=f"{d_state:.3e}",
                      max_metric_rel=f"{d_rel:.3e}")
            if tol is not None:
                again, ha = go(num_iter=2 * n)
                kv.update(tol=",".join(f"{t:g}" for t in tol),
                          repeat_bitwise_equal=not differ(
                              again, full, ha, hf, None)[0])
            say("ckpt-resume", t0, **kv, fields=len(tensors(full)),
                metrics=len(metrics(hr)), checkpoints=",".join(
                    sorted(os.listdir(os.path.join(root, name)))))
    finally:
        shutil.rmtree(root, ignore_errors=True)


def write_map_fixture(work: str, te) -> None:
    """fix.txt in ``work``: the MAP fixture of the test rows of ``te`` (a
    user and an item a row), in the test file's order: whether the row is
    positive, the user, the item."""
    order = np.lexsort((te.col, te.row))
    col = te.col[order].reshape(-1, 2)
    with open(os.path.join(work, "fix.txt"), "w") as f:
        for u, i, y in zip(col.min(1), col.max(1), te.target):
            f.write(f"{int(y > 0)} {u}:1 {i}:1\n")


def aux_check(flag: str, work: str, out: str) -> str:
    """What a CLI run with -rlog (a header that starts with rmse and mae,
    and one row an iteration), -map_eval (MAP@5 on each #Iter line and the
    final MAP@5) or -profile (a Chrome trace that names K1a's kernel) left
    in ``work`` and printed; raises where it is missing.  Returns a note."""
    lines = out.splitlines()
    if flag == "rlog":
        with open(os.path.join(work, "log.tsv")) as f:
            log = f.read().splitlines()
        if len(log) != 3 or not log[0].startswith("rmse\tmae\t"):
            raise AssertionError(f"cli -rlog: {log[:1]}, {len(log)} lines")
        return f"columns={len(log[0].split())}"
    if flag == "map_eval":
        final = [ln for ln in lines if ln.startswith("MAP@5\t")]
        if sum("MAP@5= " in ln for ln in lines) != 2 or not final:
            raise AssertionError("cli -map_eval: no MAP@5 lines")
        return f"final_map={final[0].split()[1]}"
    with open(os.path.join(work, "prof", "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    # K1a: fm_rows_kernel<W, 2, false, 0, 0>, demangled or not
    if not any("fm_rows_kernel" in e.get("name", "") and any(
            t in e["name"] for t in ("2, false, 0, 0>", "Li2ELb0ELi0ELi0E"))
            for e in events):
        raise AssertionError("cli -profile: the trace names no K1a kernel")
    return (f"kernel_events="
            f"{sum(e.get('cat') == 'kernel' for e in events)}")


def positives(coo):
    """The rows rated BPR_MIN_RATING or more, as implicit-feedback
    positives (target 1)."""
    from svbfm_tpu_torch.data.libfm_text import COOData

    keep = coo.target >= BPR_MIN_RATING
    n = int(keep.sum())
    remap = np.full(coo.num_rows, -1, np.int64)
    remap[keep] = np.arange(n)
    m = remap[coo.row] >= 0
    return COOData(row=remap[coo.row[m]].astype(np.int32), col=coo.col[m],
                   val=coo.val[m], target=np.ones(n, np.float32), num_rows=n,
                   num_features=coo.num_features)


def gather_sets(device) -> list:
    """P1's shapes (scripts/pallas_gather_probe.py): a 1-D gather of 2M
    indices from a 4 MB table, the lane-local [S, 128] form, and [depth,
    128] tables at depth 8, 32 and 1024."""
    N, M, W = 1_000_000, 2_000_000, 128
    gen = torch.Generator(device=device).manual_seed(SEED)

    def table(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    def index(hi, *shape):
        return torch.randint(0, hi, shape, generator=gen, device=device,
                             dtype=torch.int32)

    sets = [(f"1-D N={N} M={M}", table(N, 1), index(N, M, 1)),
            (f"lane-local [{N // W},{W}] M={M}", table(N // W, W),
             index(N // W, M // W, W))]
    sets += [(f"depth {d} [{d},{W}]", table(d, W), index(d, d, W))
             for d in (8, 32, 1024)]
    return sets


def probe_gathers(sets) -> list:
    """P1: ns per index of the kernel and of torch.take (1-D) or
    take_along_dim (lane-local and the depth sweep) on each set."""
    from svbfm_tpu_torch.kernels.gather_probe import gather_rows

    lines = []
    for label, t, idx in sets:
        i64 = idx.long()
        if t.shape[1] == 1:
            lib, name = (lambda: torch.take(t.view(-1), i64.view(-1)),
                         "torch.take")
        else:
            lib, name = (lambda: torch.take_along_dim(t, i64, dim=0),
                         "take_along_dim")
        n = idx.numel()
        ms = cuda_ms(lambda: gather_rows(t, idx), 20)
        lms = cuda_ms(lib, 20)
        lines.append(f"  gather {label}: kernel {ms * 1e6 / n:.4f} ns/index "
                     f"({n / ms / 1e6:.1f} G index/s), {name} "
                     f"{lms * 1e6 / n:.4f} ns/index; lowers on sm_90a")
    return lines


def profile_run(fn, n: int, unit: str, phase: str, focus=()) -> float:
    """Device time by kernel over ``n`` units of ``fn`` (one call), and the
    device's busy share of the wall time under the profiler (which slows
    the host, so the share reads low); for each name in ``focus``, also
    the time and share of the kernels whose names hold it.  Returns the
    device µs a unit."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        w0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - w0) * 1e6
    rows = sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    if busy <= 0:
        raise AssertionError(f"{phase}: the profiler saw no device time")
    for us, count, key in rows[:15]:
        print(f"  profile {us / n:10.1f} us/{unit} {count // n:6d}x/{unit} "
              f"{100 * us / busy:5.1f}% {key[:90]}")
    kv = {f"{unit}s": n, f"wall_us_per_{unit}": f"{wall_us / n:.1f}",
          f"device_us_per_{unit}": f"{busy / n:.1f}",
          "device_busy_share": f"{busy / wall_us:.3f}",
          f"device_ops_per_{unit}": sum(r[1] for r in rows) // n}
    for name in focus:
        us = sum(r[0] for r in rows if name in r[2])
        kv.update({f"{name}_us_per_{unit}": f"{us / n:.1f}",
                   f"{name}_share": f"{us / busy:.3f}"})
    say(phase, t0, **kv)
    return busy / n


def drive(build, path: str, fn):
    """Run one path with the launch counts zeroed just before and read just
    after; every kernel of the path must have been launched."""
    torch.cuda.synchronize()
    build.reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(build.launch_counts)
    missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
    if missing:
        raise AssertionError(f"{path}: kernels never launched on the path: "
                             f"{missing}")
    return out, launches


def check_history(hist, path: str, keys, fe_monotone: bool) -> None:
    for h in hist:
        vals = [h[k] for k in keys]
        if not np.all(np.isfinite(vals)):
            raise AssertionError(f"{path}: non-finite metrics at iter "
                                 f"{h['iter']}")
        for k in ("sigma_v", "sigma_w"):
            if k in h and not np.all(np.isfinite(h[k])):
                raise AssertionError(f"{path}: non-finite {k} at iter "
                                     f"{h['iter']}")
    if fe_monotone:
        fes = [h["free_energy"] for h in hist]
        for a, b in zip(fes, fes[1:]):
            if b < a - abs(a) * 1e-4:
                raise AssertionError(f"{path}: free energy fell: {a} -> {b}")
    if not hist[-1]["rmse"] < hist[0]["rmse"]:
        raise AssertionError(f"{path}: test RMSE did not drop over "
                             f"{len(hist)} iterations")


def check_mcmc_history(hist, path: str, key: str) -> None:
    """Finite metrics and hyperparameters, no NaN/Inf counts, and ``key``
    lower at the end than at the first iteration."""
    for h in hist:
        vals = [h[k] for k in ("rmse", "rmse_this", "rmse_all_but5", "mae",
                               "alpha")]
        vals += [np.asarray(h[k]).ravel() for k in ("w_mu", "w_lambda",
                                                    "v_mu", "v_lambda")]
        if not all(np.all(np.isfinite(v)) for v in vals):
            raise AssertionError(f"{path}: non-finite metrics at iter "
                                 f"{h['iter']}")
        bad = {k: v for k, v in h.items()
               if k.startswith(("nan_", "inf_")) and v}
        if bad:
            raise AssertionError(f"{path}: non-finite draws {bad}")
    if not hist[-1][key] < hist[0][key]:
        raise AssertionError(f"{path}: test {key} did not drop over "
                             f"{len(hist)} iterations")


def ml_data(num_train: int, seed: int = 42):
    """bench.py's recipe: synthetic MovieLens-1M shape, 1/11 held out."""
    from svbfm_tpu_torch.data.dataset import SparseDataset
    from svbfm_tpu_torch.data.meta import DataMetaInfo
    from svbfm_tpu_torch.data.synth import make_movielens_like, train_test_split

    coo = make_movielens_like(NUM_USERS, NUM_ITEMS, num_train + num_train // 10,
                              rank=8, noise=0.6, seed=seed)
    tr, te = train_test_split(coo, 1.0 / 11.0, seed=seed + 1)
    D = coo.num_features
    meta = DataMetaInfo.from_field_offsets(D, [0, NUM_USERS])
    return (tr, te, SparseDataset.from_coo(tr, D), SparseDataset.from_coo(te, D),
            meta)


def to_device(state, device):
    return type(state)(**{f.name: getattr(state, f.name).to(device)
                          for f in dataclasses.fields(state)})


def compare_traj(hg, hc, keys, rtol: float, what: str) -> float:
    worst = 0.0
    for a, b in zip(hg, hc):
        for k in keys:
            r = abs(a[k] - b[k]) / abs(b[k])
            if r > rtol:
                raise AssertionError(f"{what} {k} at iter {a['iter']}: "
                                     f"{a[k]} vs {b[k]} (rel {r:.3e})")
            worst = max(worst, r)
    return worst


def write_relation_files(work: str, tr, te, num_users: int) -> None:
    """Move the items of the train/test rows into a relation ``items``
    (one-hot + one attribute slot of two columns, with groups): the main
    files keep the user entries, items.train/items.test hold the joins."""
    from svbfm_tpu_torch.data.libfm_text import COOData, save_libfm_text

    for name, coo in (("train", tr), ("test", te)):
        keep = coo.col < num_users
        item = np.zeros(coo.num_rows, np.int64)
        item[coo.row[~keep]] = coo.col[~keep] - num_users
        save_libfm_text(os.path.join(work, f"{name}.libfm"), COOData(
            row=coo.row[keep], col=coo.col[keep], val=coo.val[keep],
            target=coo.target, num_rows=coo.num_rows,
            num_features=num_users))
        np.savetxt(os.path.join(work, f"items.{name}"), item, fmt="%d")
    ni = tr.num_features - num_users
    with open(os.path.join(work, "items"), "w") as f:
        f.writelines(f"0 {i}:1 {ni + i % 2}:0.5\n" for i in range(ni))
    with open(os.path.join(work, "items.groups"), "w") as f:
        f.writelines(["0\n"] * ni + ["1\n", "1\n"])


def run_clis(dev_index: int, specs: list) -> None:
    """The port's CLI in child processes on small libFM files, all started
    together and each waited for: every spec is (method, extra flags,
    files, options) with options ``relation`` (move the items into a
    relation, ``-relation items``), ``task`` "c" (classification on the
    stars less 3.5, the CLI's positive class > 0: pred.txt must hold
    probabilities), ``binary`` (the files are the reference's binary
    .x/.y alone, no text) and ``aux`` (rlog, map_eval or profile: the
    flag's output checked by ``aux_check``, on a ``[aux-cli]`` line; the
    MAP fixture written beside the files).  Each must exit 0 and write
    v_file.txt, pred.txt, its test_rmse file and ``files``."""
    from svbfm_tpu_torch.data.binary import save_coo_binary
    from svbfm_tpu_torch.data.libfm_text import save_libfm_text
    from svbfm_tpu_torch.data.synth import make_movielens_like, train_test_split

    t0 = time.perf_counter()
    repo = os.path.dirname(os.path.abspath(__file__))
    root = os.path.join(repo, "build", "chip_smoke_cli")
    shutil.rmtree(root, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=repo,
               CUDA_VISIBLE_DEVICES=os.environ.get("CUDA_VISIBLE_DEVICES",
                                                   str(dev_index)))
    runs = []
    try:
        for i, (method, extra, files, opt) in enumerate(specs):
            task = opt.get("task", "r")
            work = os.path.join(root, str(i))
            os.makedirs(work)
            coo = make_movielens_like(200, 150, 5000, seed=3)
            if task == "c":
                coo.target = (coo.target - CLASS_THRESHOLD).astype(
                    np.float32)
            tr, te = train_test_split(coo, 0.2, seed=4)
            if opt.get("relation"):
                write_relation_files(work, tr, te, 200)
                extra = [*extra, "-relation", "items"]
            elif opt.get("binary"):
                save_coo_binary(os.path.join(work, "train.libfm"), tr)
                save_coo_binary(os.path.join(work, "test.libfm"), te)
            else:
                save_libfm_text(os.path.join(work, "train.libfm"), tr)
                save_libfm_text(os.path.join(work, "test.libfm"), te)
            if opt.get("aux") == "map_eval":
                write_map_fixture(work, te)
            cmd = [sys.executable, "-m", "svbfm_tpu_torch.cli", "-task",
                   task, "-train", "train.libfm", "-test", "test.libfm",
                   "-dim", "1,1,8", "-method", method, *extra, "-iter", "2",
                   "-device", "cuda", "-out", "pred.txt"]
            runs.append((method, extra, files, opt, work, subprocess.Popen(
                cmd, cwd=work, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)))
        for method, extra, files, opt, work, proc in runs:
            out, err = proc.communicate(timeout=300)
            if proc.returncode != 0:
                raise AssertionError(f"cli -method {method} exited "
                                     f"{proc.returncode}:\n{err[-2000:]}")
            # the reference rewrites als to mcmc before it names the file
            traj = "mcmc" if method == "als" else method
            want = ("v_file.txt", "pred.txt", f"test_rmse_118_{traj}") + files
            missing = [f for f in want
                       if not os.path.exists(os.path.join(work, f))]
            if missing or "Final\tTest=" not in out:
                raise AssertionError(f"cli -method {method} output "
                                     f"incomplete: missing {missing}")
            final = [ln for ln in out.splitlines()
                     if ln.startswith("Final")][0]
            pred = np.loadtxt(os.path.join(work, "pred.txt"))
            if opt.get("task") == "c" and not ((pred >= 0)
                                               & (pred <= 1)).all():
                raise AssertionError("cli -task c: -out holds values "
                                     "outside [0, 1]")
            say("cli", t0, method=method, task=opt.get("task", "r"),
                relation=bool(opt.get("relation")),
                binary=bool(opt.get("binary")),
                flags=",".join(extra) or "-", rc=proc.returncode,
                final=final.split("=")[1])
            if opt.get("aux"):
                say("aux-cli", t0, flag=f"-{opt['aux']}", method=method,
                    rc=proc.returncode,
                    **dict([aux_check(opt["aux"], work, out).split("=", 1)]))
    finally:
        for *_, proc in runs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(root, ignore_errors=True)


def enqueue_then_wait(step, state, n: int = 3):
    """Host-bound or device-bound: for ``n`` steps, the host time to
    enqueue one, then the time the device still needs after it (ms).
    Returns (state, "enqueue/wait,...")."""
    split = []
    for _ in range(n):
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        state = step(state)
        w1 = time.perf_counter()
        torch.cuda.synchronize()
        split.append(f"{1e3 * (w1 - w0):.3f}/"
                     f"{1e3 * (time.perf_counter() - w1):.3f}")
    return state, ",".join(split)


def check_sgd_history(hist, path: str, key: str = "rmse", first=None,
                      rises: bool = False) -> None:
    """Finite metrics, and ``key`` lower (``rises``: higher) at the end
    than ``first`` (default: at the first epoch)."""
    for h in hist:
        vals = [v for k, v in h.items() if k != "iter"]
        if not np.all(np.isfinite(vals)):
            raise AssertionError(f"{path}: non-finite metrics at epoch "
                                 f"{h['iter']}: {h}")
    first = hist[0][key] if first is None else first
    last = hist[-1][key]
    if not (last > first if rises else last < first):
        raise AssertionError(f"{path}: {key} went {first} -> {last} over "
                             f"{len(hist)} epochs")


def binarised(ds, threshold: float):
    """``ds`` with the classification targets: +1 above ``threshold``, else
    -1 (the CLI binarises at 0; here the stars at 3.5)."""
    return dataclasses.replace(
        ds, target=np.where(ds.target > threshold, 1.0, -1.0).astype(
            np.float32), min_target=-1.0, max_target=1.0)


def check_class_history(hist, path: str, key: str = "accuracy",
                        learns: bool = True, rises: bool = True) -> None:
    """Finite metrics and no non-finite candidates; with ``learns``, the
    test accuracy above 0.5 at every iteration and, with ``rises``, not
    falling: the last at most CLASS_ACC_SLACK below the first."""
    for h in hist:
        vals = [v for k, v in h.items() if isinstance(v, float)]
        if not np.all(np.isfinite(vals)):
            raise AssertionError(f"{path}: non-finite metrics at iter "
                                 f"{h['iter']}: {h}")
        if learns and not h[key] > 0.5:
            raise AssertionError(f"{path}: {key} {h[key]} at iter "
                                 f"{h['iter']}")
        bad = {k: v for k, v in h.items()
               if k.startswith(("nan_", "inf_")) and v}
        if bad:
            raise AssertionError(f"{path}: non-finite candidates {bad}")
    if learns and rises and hist[-1][key] < hist[0][key] - CLASS_ACC_SLACK:
        raise AssertionError(f"{path}: {key} fell {hist[0][key]} -> "
                             f"{hist[-1][key]}")


def class_phases(build, card, dev, train, test, meta, base_cfg, plan,
                 bsp: dict, sgda_split) -> list:
    """Classification (``-task c``) through every learner on ML-1M with its
    targets binarised at 3.5 (K = 20), and the Poisson task through SGD:
    vb-class and vb-class-gpu-vs-cpu (exact mode), vb-class-fast (fast
    mode, information), mcmc-class, mcmc-class-gpu-vs-cpu,
    als-class, ovb-class, bs-class (the 1M-row relational recipe,
    binarised at its median), sgd-class, sgda-class, sgd-poisson, each
    path's device time a sweep under the profiler (``<path>-profile``),
    then class-quality (Gibbs and VB at dim 1,1,8 on the 100k-row recipe
    beside the reference C++).  Returns the driven runs' launch counts."""
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.learners.mcmc import ALSLearner, MCMCLearner
    from svbfm_tpu_torch.learners.sgd import SGDALearner, SGDLearner
    from svbfm_tpu_torch.learners.vb import VBLearner, init_vb_params
    from svbfm_tpu_torch.learners.vb_online import OVBLearner
    from svbfm_tpu_torch.models.fm import init_fm_params

    def med(hist):
        return f"{statistics.median(h['time_learn'] for h in hist[1:]):.6f}"

    def accs(hist, key="accuracy"):
        return ",".join(f"{h[key]:.5f}" for h in hist)

    def launches(counts):
        return json.dumps(counts, separators=(",", ":"))

    ctr, cte = (binarised(d, CLASS_THRESHOLD) for d in (train, test))
    ccfg = dict(base_cfg, task=1, min_target=-1.0, max_target=1.0)
    runs = []

    # ---- vb-class: batch VB, exact mode (the reference's order), 10 sweeps -
    # (fast mode's Jacobi block of all K factors lets the latent update's
    # A&S Phi(-mu) reach 0 here, and e turn infinite, in the JAX package
    # as in the port: vb-class-fast below)
    t0 = time.perf_counter()
    cfg = FMConfig(factor_block=1, **ccfg)
    vb = VBLearner(cfg, ctr, cte, meta, device=dev, plan=plan,
                   write_files=False)
    (vstate, hv), lv = drive(build, "vb-class", lambda: vb.run(
        vb.init_state(), num_iter=10, verbose=False, chunk=1))
    check_class_history(hv, "vb-class")
    runs.append(lv)
    say("vb-class", t0, sweeps=len(hv), factor_block=1, sec_per_iter=med(hv),
        accuracy=accs(hv), loglik=accs(hv, "loglik"),
        fe_last=f"{hv[-1]['free_energy']:.2f}", launches=launches(lv),
        card=repr(card))
    profile_run(lambda: vb.run(vstate, num_iter=1, verbose=False), 1,
                "sweep", "vb-class-profile", focus=("probit",))

    # ---- vb-class-gpu-vs-cpu: 3 exact-mode sweeps, full size ----------------
    t0 = time.perf_counter()
    params = init_vb_params(torch.Generator().manual_seed(SEED), cfg, "cpu")
    cpu = VBLearner(cfg, ctr, cte, meta, device="cpu", plan=plan,
                    write_files=False)
    hists = [lr.run(lr.state_from_params(params), num_iter=3,
                    verbose=False)[1] for lr in (vb, cpu)]
    worst = compare_traj(*hists, ("accuracy", "loglik", "free_energy"),
                         TRAJ_RTOL, "vb-class gpu vs cpu")
    say("vb-class-gpu-vs-cpu", t0, sweeps=3, factor_block=1,
        max_rel=f"{worst:.3e}", rtol=TRAJ_RTOL)
    del cpu, vb, vstate

    # ---- vb-class-fast: fast mode, 5 sweeps (information) -------------------
    # The sweep at which the free energy turns NaN, if one does: the
    # truncated mean's Phi(-mu) underflows to 0 for |mu| past ~5.7 in
    # float32 (tests/test_torch_classification.py pins the helpers' inf)
    t0 = time.perf_counter()
    fast = VBLearner(FMConfig(factor_block=0, **ccfg), ctr, cte, meta,
                     device=dev, plan=plan, write_files=False)
    (_, hf), lf = drive(build, "vb-class", lambda: fast.run(
        fast.init_state(), num_iter=5, verbose=False, chunk=1))
    runs.append(lf)
    first_nan = next((h["iter"] for h in hf
                      if not np.isfinite(h["free_energy"])), None)
    say("vb-class-fast", t0, sweeps=len(hf), sec_per_iter=med(hf),
        accuracy=accs(hf), free_energy=",".join(
            f"{h['free_energy']:.1f}" for h in hf),
        first_nan_iter=first_nan, launches=launches(lf))
    del fast

    # ---- mcmc-class: Gibbs, 10 iterations from the device generator -------
    t0 = time.perf_counter()
    cfg = FMConfig(factor_block=0, **ccfg)  # F = K, as [mcmc]
    gibbs = MCMCLearner(cfg, ctr, cte, meta, device=dev, plan=plan,
                        write_files=False)
    (mstate, hm), lm = drive(build, "mcmc-class", lambda: gibbs.run(
        gibbs.init_state(), num_iter=10, verbose=False, chunk=1))
    check_class_history(hm, "mcmc-class")
    runs.append(lm)
    say("mcmc-class", t0, iterations=len(hm), sec_per_iter=med(hm),
        accuracy=accs(hm), acc_this=accs(hm, "acc_this"),
        loglik_last=f"{hm[-1]['loglik']:.5f}",
        alpha_last=f"{hm[-1]['alpha']:.4f}", launches=launches(lm),
        card=repr(card))
    profile_run(lambda: gibbs.run(mstate, num_iter=1, verbose=False), 1,
                "sweep", "mcmc-class-profile", focus=("probit",))

    # ---- mcmc-class-gpu-vs-cpu: 2 sweeps, host-table draws -----------------
    t0 = time.perf_counter()
    p0 = init_fm_params(torch.Generator().manual_seed(SEED),
                        cfg.num_attributes, K, init_stdev=cfg.init_stdev,
                        init_w_normal=True)
    cpu = MCMCLearner(cfg, ctr, cte, meta, device="cpu", plan=plan,
                      write_files=False)
    hists = [lr.run(lr.state_from_params(p0.w0, p0.w, p0.v,
                                         host_draws(SEED, lr.device)),
                    num_iter=2, verbose=False)[1] for lr in (gibbs, cpu)]
    worst = compare_traj(*hists, ("accuracy", "loglik", "acc_this",
                                  "ll_this", "alpha"), TRAJ_RTOL,
                         "mcmc-class gpu vs cpu")
    say("mcmc-class-gpu-vs-cpu", t0, sweeps=2, max_rel=f"{worst:.3e}",
        rtol=TRAJ_RTOL)
    del cpu, gibbs, mstate

    # ---- als-class: ALS (-regular 5), 3 iterations --------------------------
    t0 = time.perf_counter()
    als = ALSLearner(FMConfig(factor_block=0, **dict(
        ccfg, reg0=ALS_REG, regw=ALS_REG, regv=ALS_REG)), ctr, cte, meta,
        device=dev, plan=plan, write_files=False)
    (astate, ha), la = drive(build, "als-class", lambda: als.run(
        als.init_state(), num_iter=3, verbose=False, chunk=1))
    check_class_history(ha, "als-class")
    runs.append(la)
    say("als-class", t0, iterations=len(ha), sec_per_iter=med(ha),
        accuracy=accs(ha), acc_this=accs(ha, "acc_this"),
        launches=launches(la))
    profile_run(lambda: als.run(astate, num_iter=1, verbose=False), 1,
                "sweep", "als-class-profile", focus=("probit",))
    del als, astate

    # ---- ovb-class: online VB, 20 chunks, 3 epochs --------------------------
    t0 = time.perf_counter()
    ovb = OVBLearner(FMConfig(num_batches=OVB_CHUNKS, **ccfg), ctr, cte,
                     meta, device=dev, write_files=False)
    (ostate, ho), lo = drive(build, "ovb-class", lambda: ovb.run(
        ovb.init_state(), num_iter=3, verbose=False))
    check_class_history(ho, "ovb-class")
    runs.append(lo)
    say("ovb-class", t0, epochs=len(ho), chunks=OVB_CHUNKS,
        sec_per_epoch=med(ho), accuracy=accs(ho), loglik=accs(ho, "loglik"),
        launches=launches(lo))
    profile_run(lambda: ovb.run(ostate, num_iter=1, verbose=False), 1,
                "epoch", "ovb-class-profile", focus=("probit",))
    del ovb, ostate

    # ---- bs-class: block-structure Gibbs, 3 iterations ---------------------
    t0 = time.perf_counter()
    thr = float(np.median(bsp["train"].target[: bsp["train"].num_rows]))
    bspc = dict(bsp, train=binarised(bsp["train"], thr),
                test=binarised(bsp["test"], thr))
    bs = bs_learner(bspc, dev, num_factor=K, regw=BS_REG, regv=BS_REG,
                    task=1, min_target=-1.0, max_target=1.0)
    (bstate, hb), lb = drive(build, "bs-class", lambda: bs.run(
        bs.init_state(), num_iter=3, verbose=False, chunk=1))
    check_class_history(hb, "bs-class")
    runs.append(lb)
    say("bs-class", t0, iterations=len(hb), threshold=f"{thr:.4f}",
        sec_per_iter=med(hb), accuracy=accs(hb), launches=launches(lb))
    profile_run(lambda: bs.run(bstate, num_iter=1, verbose=False), 1,
                "sweep", "bs-class-profile", focus=("probit",))
    del bs, bstate

    # ---- sgd-class, sgda-class, sgd-poisson: 3 epochs each -----------------
    scfg = FMConfig(**ccfg)
    tr90, va10 = (binarised(d, CLASS_THRESHOLD) for d in sgda_split)
    counts = [dataclasses.replace(
        d, target=np.maximum(d.target - 3.0, 0.0).astype(np.float32))
        for d in (train, test)]
    for path, make in (
            ("sgd-class", lambda: SGDLearner(scfg, ctr, cte, meta, device=dev,
                                             write_files=False)),
            ("sgda-class", lambda: SGDALearner(
                dataclasses.replace(scfg, learn_rate=SGDA_LR), tr90, cte,
                va10, meta, device=dev, write_files=False)),
            ("sgd-poisson", lambda: SGDLearner(FMConfig(**dict(
                base_cfg, task=2, min_target=0.0, max_target=2.0)),
                *counts, meta, device=dev, write_files=False))):
        t0 = time.perf_counter()
        learner = make()
        (_, hs), ls = drive(build, path, lambda: learner.run(
            num_iter=3, verbose=False))
        # the Poisson task's "accuracy" (a score >= 0 against a count > 0,
        # sgd.py:398-404) measures no fit: its run is held to finite
        # metrics alone.  The SGD family overfits this recipe from its
        # first epoch at these rates (its regression phases show it: the
        # test RMSE of [sgd-quality] rises after epoch 1), so its accuracy
        # is held above 0.5, not to rise
        check_class_history(hs, path, learns=path != "sgd-poisson",
                            rises=False)
        runs.append(ls)
        say(path, t0, epochs=len(hs), sec_per_epoch=med(hs),
            accuracy=accs(hs), launches=launches(ls))

    # ---- class-quality: the 100k-row recipe, dim 1,1,8 (information) -------
    t0 = time.perf_counter()
    tr1, _, train1, test1, meta1 = ml_data(CLASS_Q_ROWS)
    qcfg = FMConfig(num_attributes=tr1.num_features, num_factor=CLASS_Q_K,
                    task=1, min_target=-1.0, max_target=1.0,
                    num_groups=meta1.num_attr_groups, seed=SEED)
    qtr, qte = (binarised(d, CLASS_THRESHOLD) for d in (train1, test1))
    _, hq = MCMCLearner(qcfg, qtr, qte, meta1, device=dev,
                        write_files=False).run(
        num_iter=max(REF_CLASS_MCMC_ACC), verbose=False)
    _, hvq = VBLearner(qcfg, qtr, qte, meta1, device=dev,
                       write_files=False).run(
        num_iter=max(REF_CLASS_VB_ACC), verbose=False)
    check_class_history(hq, "class-quality mcmc")
    say("class-quality", t0, train_rows=tr1.num_rows, dim="1,1,8",
        **{f"mcmc_acc_iter{i}": f"{hq[i - 1]['accuracy']:.4f}"
           for i in REF_CLASS_MCMC_ACC},
        **{f"vb_acc_iter{i}": f"{hvq[i - 1]['accuracy']:.4f}"
           for i in REF_CLASS_VB_ACC},
        **{f"vb_ll_iter{i}": f"{hvq[i - 1]['loglik']:.4f}"
           for i in REF_CLASS_VB_LL},
        reference_cpp_mcmc_acc=",".join(
            f"{i}:{v}" for i, v in REF_CLASS_MCMC_ACC.items()),
        reference_cpp_vb_acc=",".join(
            f"{i}:{v}" for i, v in REF_CLASS_VB_ACC.items()),
        reference_cpp_vb_ll=",".join(
            f"{i}:{v}" for i, v in REF_CLASS_VB_LL.items()))
    return runs


def sgd_phases(build, card, dev, sgd, exp_sgd, sgda, bpr, train, test, meta,
               base_cfg, sgda_split) -> tuple:
    """Phases 20-27, the SGD family; ``sgda_split`` holds SGDA's train and
    validation datasets.  Returns the launch counts of the driven runs of
    sgd, sgd-online, exp-sgd-stoc, sgda and bpr, sgd-online's sec/epoch,
    and [sgd]'s history, sec/epoch and profiled device µs an epoch."""
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.learners.sgd import (SGDALearner, SGDLearner,
                                              SGDOnlineLearner)
    from svbfm_tpu_torch.models.fm import init_fm_params

    def med(hist):
        return f"{statistics.median(h['time_learn'] for h in hist[1:]):.6f}"

    def rmses(hist, key="rmse"):
        return ",".join(f"{h[key]:.5f}" for h in hist)

    # ---- 20. SGD, batch 1024, 5 epochs -------------------------------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    (sstate, hs), l_sgd = drive(build, "sgd", lambda: sgd.run(
        sgd.init_state(), num_iter=5, verbose=False))
    peak = torch.cuda.max_memory_allocated()
    check_sgd_history(hs, "sgd")
    sstate, split = enqueue_then_wait(sgd.epoch, sstate)
    say("sgd", t0, epochs=len(hs), batches_per_epoch=sgd.num_batches,
        sec_per_epoch=med(hs),
        ms_per_epoch=",".join(f"{1e3 * h['time_learn']:.3f}" for h in hs),
        enqueue_then_wait_ms=split, rmse=rmses(hs), peak_mem_bytes=peak,
        launches=json.dumps(l_sgd, separators=(",", ":")), card=repr(card))

    # ---- 21. SGD, GPU kernels vs CPU twins, one full epoch -----------------
    t0 = time.perf_counter()
    cfg = sgd.cfg
    p0 = init_fm_params(torch.Generator().manual_seed(SEED),
                        cfg.num_attributes, cfg.num_factor,
                        init_stdev=cfg.init_stdev)
    cpu = SGDLearner(cfg, train, test, meta, device="cpu", write_files=False)
    ends, hists = [], []
    for lr in (sgd, cpu):
        st, h = lr.run(lr.state_from_params(p0.w0, p0.w, p0.v,
                                            host_draws(SEED, lr.device)),
                       num_iter=1, verbose=False)
        ends.append(st.tab.cpu())
        hists.append(h)
    worst = compare_traj(*hists, ("rmse", "mae"), SGD_TRAJ_RTOL,
                         "sgd gpu vs cpu")
    gap = (ends[0] - ends[1]).abs().max().item()
    if not gap <= SGD_PARAM_ATOL:
        raise AssertionError(f"sgd gpu vs cpu: parameters differ by {gap:.3e}"
                             f", more than {SGD_PARAM_ATOL}")
    say("sgd-gpu-vs-cpu", t0, epochs=1, batches=sgd.num_batches,
        max_rel=f"{worst:.3e}", rtol=SGD_TRAJ_RTOL,
        max_abs_param=f"{gap:.3e}", atol_param=SGD_PARAM_ATOL)
    del cpu

    # ---- 22. sgd_online, 50 chunks, 3 epochs --------------------------------
    t0 = time.perf_counter()
    online = SGDOnlineLearner(FMConfig(num_batches=SGD_ONLINE_CHUNKS,
                                       **base_cfg), train, test, meta,
                              device=dev, write_files=False)
    (_, ho), l_online = drive(build, "sgd-online", lambda: online.run(
        num_iter=3, verbose=False))
    check_sgd_history(ho, "sgd-online")
    say("sgd-online", t0, epochs=len(ho), chunks=SGD_ONLINE_CHUNKS,
        sec_per_epoch=med(ho), rmse=rmses(ho),
        launches=json.dumps(l_online, separators=(",", ":")))

    # ---- 23. exp_sgd_stoc, 3 epochs -----------------------------------------
    t0 = time.perf_counter()
    (_, he), l_exp = drive(build, "exp-sgd-stoc", lambda: exp_sgd.run(
        num_iter=3, verbose=False))
    check_sgd_history(he, "exp-sgd-stoc")
    say("exp-sgd-stoc", t0, epochs=len(he), sec_per_epoch=med(he),
        rmse=rmses(he), launches=json.dumps(l_exp, separators=(",", ":")))

    # ---- 24. SGDA, 90/10 train/validation split, 5 iterations ---------------
    t0 = time.perf_counter()
    (astate, ha), l_sgda = drive(build, "sgda", lambda: sgda.run(
        num_iter=5, verbose=False))
    check_sgd_history(ha, "sgda", "rmse_train")
    regs = torch.cat([astate.reg_w, astate.reg_v.reshape(-1)])
    if not (torch.isfinite(regs).all() and (regs >= 0).all()):
        raise AssertionError(f"sgda: regs not finite and >= 0: {regs}")
    say("sgda", t0, iterations=len(ha), batches=sgda.num_batches,
        sec_per_iter=med(ha), rmse=rmses(ha), rmse_val=rmses(ha, "rmse_val"),
        reg_w=",".join(f"{r:.5g}" for r in astate.reg_w.tolist()),
        reg_v_mean=f"{astate.reg_v.mean().item():.5g}",
        launches=json.dumps(l_sgda, separators=(",", ":")))

    # ---- 25. BPR on the 4-5 star rows, 5 epochs -----------------------------
    # the pair accuracy must rise over the epochs and above the init's, the
    # pair loss fall
    t0 = time.perf_counter()
    binit = bpr.init_state()
    acc_init = float(bpr.eval_pairs(binit, bpr.eval_negatives())[0])
    (_, hb), l_bpr = drive(build, "bpr", lambda: bpr.run(
        binit, num_iter=5, verbose=False))
    check_sgd_history(hb, "bpr", "accuracy", rises=True)
    check_sgd_history(hb, "bpr", "accuracy", first=acc_init, rises=True)
    check_sgd_history(hb, "bpr", "pair_loss")
    say("bpr", t0, epochs=len(hb), pairs_per_batch=bpr.train_n //
        bpr.num_batches, sec_per_epoch=med(hb),
        pair_accuracy_init=f"{acc_init:.5f}",
        pair_accuracy=rmses(hb, "accuracy"),
        pair_loss=rmses(hb, "pair_loss"),
        launches=json.dumps(l_bpr, separators=(",", ":")))

    # ---- 26. quality beside the reference C++ (information) -----------------
    # SGD at the CLI's default learn rate (0.1) and at the 0.01 of the
    # recorded SGDA and sgd_online runs: the reference SGD column's flags
    # are not recorded
    t0 = time.perf_counter()
    _, hq = sgd.run(num_iter=max(REF_SGD_RMSE), verbose=False)
    slow = SGDLearner(FMConfig(**dict(base_cfg, learn_rate=SGDA_LR)), train,
                      test, meta, device=dev, write_files=False)
    _, hq2 = slow.run(num_iter=max(REF_SGD_RMSE), verbose=False)
    if not np.isfinite([h["rmse"] for h in hq + hq2]).all():
        raise AssertionError("sgd-quality: non-finite test RMSE")
    qcfg = dict(base_cfg, num_factor=SGDA_K, learn_rate=SGDA_LR)
    sq = SGDALearner(FMConfig(**qcfg), sgda_split[0], test, sgda_split[1],
                     meta, device=dev, write_files=False)
    _, hqa = sq.run(num_iter=max(REF_SGDA_RMSE), verbose=False)
    say("sgd-quality", t0, epochs=len(hq),
        sec_per_epoch=med(hq),
        **{f"sgd_test_rmse_epoch{e}": f"{hq[e - 1]['rmse']:.5f}"
           for e in REF_SGD_RMSE},
        **{f"sgd_lr{SGDA_LR}_test_rmse_epoch{e}": f"{hq2[e - 1]['rmse']:.5f}"
           for e in REF_SGD_RMSE},
        sgd_reference_cpp=",".join(f"{e}:{v}"
                                   for e, v in REF_SGD_RMSE.items()),
        **{f"sgda_test_rmse_iter{i}": f"{hqa[i - 1]['rmse']:.5f}"
           for i in REF_SGDA_RMSE},
        sgda_reference_cpp=",".join(f"{i}:{v}"
                                    for i, v in REF_SGDA_RMSE.items()),
        sgda_sec_per_iter=med(hqa))

    # ---- 27. where an SGD epoch's and an SGDA iteration's device time goes -
    sgd_us = profile_run(lambda: sgd.run(sstate, num_iter=1, verbose=False),
                         1, "epoch", "sgd-profile")
    profile_run(lambda: sgda.epoch(astate, 1), 1, "iteration",
                "sgda-profile", focus=("sgda_lambda",))
    return (l_sgd, l_online, l_exp, l_sgda, l_bpr, f"{med(ho)}",
            dict(hist=hs, sec=med(hs), us=sgd_us))


def bs_problem(rows: int, slots: int, holdout: bool,
               main_items: bool = False) -> dict:
    """The relational recipe (``make_bs_problem``): the joined meta, the two
    relations, the train and test main blocks (empty designs) and their
    joins.  The test rows are the first tenth; ``holdout`` keeps them out of
    the train rows (PARITY_RUNS.md:166-183), else the train set is every row
    (scripts/bench_bs.py:100-104).  ``main_items``: the items are one-hot
    columns of the main block instead of a relation (the Gibbs/ALS
    main-block pass then runs beside the user relation's)."""
    from svbfm_tpu_torch.data.dataset import SparseDataset
    from svbfm_tpu_torch.data.libfm_text import COOData
    from svbfm_tpu_torch.data.meta import DataMetaInfo
    from svbfm_tpu_torch.data.relation import build_joined_meta
    from svbfm_tpu_torch.data.synth import make_bs_problem

    _, ru, ri, users, items, y = make_bs_problem(rows, slots, slots)
    rels, joins = ([ru], [users]) if main_items else ([ru, ri],
                                                      [users, items])
    d_main = ri.num_rows if main_items else 0
    meta = build_joined_meta(DataMetaInfo(d_main), rels)
    D = meta.num_attributes
    te_n = min(rows // 10, 1_000_000)
    lo = te_n if holdout else 0

    def block(a, b):
        n = b - a
        if not main_items:
            return SparseDataset.from_coo(COOData(
                row=np.zeros(0, np.int32), col=np.zeros(0, np.int32),
                val=np.zeros(0, np.float32), target=y[a:b], num_rows=n,
                num_features=0), D)
        return SparseDataset.from_coo(COOData(
            row=np.arange(n, dtype=np.int32), col=items[a:b].astype(np.int32),
            val=np.ones(n, np.float32), target=y[a:b], num_rows=n,
            num_features=d_main), D)

    return dict(meta=meta, rels=rels, d_main=d_main, train=block(lo, rows),
                test=block(0, te_n), joins_tr=[j[lo:] for j in joins],
                joins_te=[j[:te_n] for j in joins],
                expanded=rows * (2 + (1 if main_items else 2) * slots),
                cfg=dict(num_attributes=D, num_groups=meta.num_attr_groups,
                         min_target=float(y[lo:].min()),
                         max_target=float(y[lo:].max()), seed=SEED))


def bs_learner(p: dict, device, als: bool = False, mesh=None, **cfg_kw):
    """The BS learner on ``bs_problem``'s ``p`` (``mesh``: a data mesh)."""
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.mcmc_bs import ALSBSLearner, MCMCBSLearner

    cls = ALSBSLearner if als else MCMCBSLearner
    return cls(FMConfig(**dict(p["cfg"], **cfg_kw)), p["train"], p["test"],
               p["rels"], p["joins_tr"], p["joins_te"], p["meta"],
               p["d_main"], device=device, write_files=False, mesh=mesh)


def bs_phases(build, card, dev, bs_mcmc, bsp: dict) -> tuple:
    """The block-structure sampler on the relational recipe (1M ratings,
    42 joined entries a row, the join never materialised): Gibbs and ALS at
    F = K, the factor-sequential path, Gibbs at K = BS_K64 (X10a's block
    form on the path, its relation kernels at F = 64 against their twins),
    card against CPU, nine relations card against CPU, quality beside the
    reference C++, the profile.
    Returns the driven runs' launch counts."""
    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.models.fm import init_fm_params

    def med(hist):
        return f"{statistics.median(h['time_learn'] for h in hist[1:]):.6f}"

    def row_width(learner):
        return int(learner.train_row.ids.shape[1])

    # ---- 30. BS Gibbs, F = K, 5 iterations -------------------------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    (bstate, hb), l_bs = drive(build, "bs-mcmc", lambda: bs_mcmc.run(
        bs_mcmc.init_state(), num_iter=5, verbose=False, chunk=1))
    peak = torch.cuda.max_memory_allocated()
    check_mcmc_history(hb, "bs-mcmc", "rmse")
    bstate, split = enqueue_then_wait(lambda st: bs_mcmc.step(st)[0], bstate,
                                      n=2)
    say("bs-mcmc", t0, rows=bs_mcmc.train_n, K=K,
        factor_block=bs_mcmc.factor_width, sec_per_iter=med(hb),
        ms_per_iter=",".join(f"{1e3 * h['time_learn']:.3f}" for h in hb),
        enqueue_then_wait_ms=split,
        rmse_first=f"{hb[0]['rmse']:.5f}", rmse_last=f"{hb[-1]['rmse']:.5f}",
        main_row_entries=row_width(bs_mcmc), joined_row_entries=2 + 2 * BS_SLOTS,
        expanded_entries=bsp["expanded"], peak_mem_bytes=peak,
        launches=json.dumps(l_bs, separators=(",", ":")), card=repr(card))

    # ---- 31. BS ALS, F = K, 5 iterations; the factor-sequential path -----
    t0 = time.perf_counter()
    als = bs_learner(bsp, dev, als=True, num_factor=K, regw=BS_REG,
                     regv=BS_REG)
    torch.cuda.reset_peak_memory_stats()
    (_, ha), l_als = drive(build, "bs-als", lambda: als.run(
        als.init_state(), num_iter=5, verbose=False, chunk=1))
    check_mcmc_history(ha, "bs-als", "rmse_this")
    say("bs-als", t0, rows=als.train_n, K=K, factor_block=als.factor_width,
        sec_per_iter=med(ha),
        rmse_this_first=f"{ha[0]['rmse_this']:.5f}",
        rmse_this_last=f"{ha[-1]['rmse_this']:.5f}",
        main_row_entries=row_width(als),
        joined_row_entries=2 + 2 * BS_SLOTS,
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        launches=json.dumps(l_als, separators=(",", ":")))
    del als
    t0 = time.perf_counter()
    seq = bs_learner(bsp, dev, num_factor=K, regw=BS_REG, regv=BS_REG,
                     factor_block=1)
    (sstate, hs), l_seq = drive(build, "bs-seq", lambda: seq.run(
        seq.init_state(), num_iter=2, verbose=False, chunk=1))
    check_mcmc_history(hs, "bs-seq", "rmse")
    # its wall time swings with the host; the device time of one more
    # iteration shows X10a at F <= 1 (42 launches an iteration)
    s_dev_us = profile_run(lambda: seq.run(sstate, num_iter=1,
                                           verbose=False),
                           1, "sweep", "bs-seq-profile", focus=BS_FOCUS)
    say("bs-seq", t0, rows=seq.train_n, factor_block=seq.factor_width,
        iterations=len(hs), sec_per_iter=f"{hs[-1]['time_learn']:.6f}",
        device_ms_per_iter=f"{s_dev_us / 1e3:.3f}",
        rmse=",".join(f"{h['rmse']:.5f}" for h in hs),
        launches=json.dumps(l_seq, separators=(",", ":")))
    del seq

    # ---- 31b. BS Gibbs at -dim 1,1,64: X10a's block form on the path ----
    t0 = time.perf_counter()
    k64 = bs_learner(bsp, dev, num_factor=BS_K64, regw=BS_REG, regv=BS_REG)
    torch.cuda.reset_peak_memory_stats()
    (kstate, hk), l_k64 = drive(build, "bs-k64", lambda: k64.run(
        k64.init_state(), num_iter=3, verbose=False, chunk=1))
    peak = torch.cuda.max_memory_allocated()
    check_mcmc_history(hk, "bs-k64", "rmse")
    k_dev_us = profile_run(lambda: k64.run(kstate, num_iter=1,
                                           verbose=False),
                           1, "sweep", "bs-k64-profile", focus=BS_FOCUS)
    say("bs-k64", t0, rows=k64.train_n, K=BS_K64,
        factor_block=k64.factor_width, sec_per_iter=med(hk),
        ms_per_iter=",".join(f"{1e3 * h['time_learn']:.3f}" for h in hk),
        device_ms_per_iter=f"{k_dev_us / 1e3:.3f}",
        rmse_first=f"{hk[0]['rmse']:.5f}", rmse_last=f"{hk[-1]['rmse']:.5f}",
        peak_mem_bytes=peak, launches=json.dumps(l_k64, separators=(",", ":")))
    # the sweep's relation kernels at F = 64 against their twins, timed
    t0 = time.perf_counter()
    rep = check_cases(bs_tensors(k64, kstate, "bs-k64", True,
                                 (k64.factor_width,)), timed=True)
    print_report(rep)
    say("bs-k64-kernels", t0, compared=len(rep), tol=KERNEL_TOL)
    del k64, kstate, rep

    # ---- 32. BS Gibbs, card against CPU (100k-row recipe) ----------------
    t0 = time.perf_counter()
    qp = bs_problem(BS_Q_ROWS, BS_Q_SLOTS, holdout=True)
    p0 = init_fm_params(torch.Generator().manual_seed(SEED),
                        qp["cfg"]["num_attributes"], BS_Q_K,
                        init_w_normal=True)
    hists = []
    for d in (dev, "cpu"):
        lr = bs_learner(qp, d, num_factor=BS_Q_K, regw=BS_REG, regv=BS_REG)
        hists.append(lr.run(lr.state_from_params(
            p0.w0, p0.w, p0.v, host_draws(SEED, d)), num_iter=2,
            verbose=False)[1])
    keys = ("rmse", "rmse_this", "mae", "alpha")
    worst = compare_traj(*hists, keys, TRAJ_RTOL, "bs gpu vs cpu")
    say("bs-gpu-vs-cpu", t0, rows=BS_Q_ROWS, K=BS_Q_K, sweeps=2,
        metrics=",".join(keys), max_rel=f"{worst:.3e}", rtol=TRAJ_RTOL)

    # ---- 32b. nine relations (the small problem), card against CPU -------
    t0 = time.perf_counter()
    hists = []
    for d in (dev, "cpu"):
        lr = small_bs_learner(d, K=BS_Q_K, n_rel=NINE_RELATIONS)
        p9 = init_fm_params(torch.Generator().manual_seed(SEED),
                            lr.cfg.num_attributes, BS_Q_K, init_w_normal=True)
        st = lr.state_from_params(p9.w0, p9.w, p9.v, host_draws(SEED, d))
        if d is dev:
            (_, h), l_nine = drive(build, "bs-nine", lambda: lr.run(
                st, num_iter=3, verbose=False))
        else:
            h = lr.run(st, num_iter=3, verbose=False)[1]
        hists.append(h)
    worst = compare_traj(*hists, keys, TRAJ_RTOL, "bs nine relations gpu "
                         "vs cpu")
    say("bs-nine-gpu-vs-cpu", t0, relations=len(lr.rels), K=BS_Q_K,
        sweeps=3, metrics=",".join(keys), max_rel=f"{worst:.3e}",
        rtol=TRAJ_RTOL, launches=json.dumps(l_nine, separators=(",", ":")))

    # ---- 33. quality beside the reference C++ (information) --------------
    t0 = time.perf_counter()
    n_q = max(REF_BS_MCMC_RMSE)
    qm = bs_learner(qp, dev, num_factor=BS_Q_K)
    _, hqm = qm.run(num_iter=n_q, verbose=False)
    qa = bs_learner(qp, dev, als=True, num_factor=BS_Q_K, reg0=BS_Q_ALS_REG,
                    regw=BS_Q_ALS_REG, regv=BS_Q_ALS_REG)
    _, hqa = qa.run(num_iter=n_q, verbose=False)
    check_mcmc_history(hqm, "bs-quality mcmc", "rmse")
    say("bs-quality", t0, rows=BS_Q_ROWS, K=BS_Q_K, iterations=n_q,
        **{f"mcmc_test_rmse_iter{i}": f"{hqm[i - 1]['rmse']:.5f}"
           for i in REF_BS_MCMC_RMSE},
        mcmc_reference_cpp=",".join(f"{i}:{v}"
                                    for i, v in REF_BS_MCMC_RMSE.items()),
        **{f"als_test_rmse_iter{i}": f"{hqa[i - 1]['rmse_this']:.5f}"
           for i in REF_BS_ALS_RMSE},
        als_reference_cpp=",".join(f"{i}:{v}"
                                   for i, v in REF_BS_ALS_RMSE.items()),
        mcmc_sec_per_iter=med(hqm), als_sec_per_iter=med(hqa))

    # ---- 34. where a blocked BS Gibbs sweep's device time goes -----------
    profile_run(lambda: bs_mcmc.run(bstate, num_iter=1, verbose=False), 1,
                "sweep", "bs-profile", focus=BS_FOCUS)
    return l_bs, l_als, l_seq, l_nine, l_k64


# ---------------------------------------------------------------------------
# Out of core (phases 36-43): binary input, streamed OVB and sgd_online,
# the windowed batch VB, -num_eval_cases
# ---------------------------------------------------------------------------

def tp_rank_child(rank: int, store: str, out: str) -> None:
    """One of the [tp-vb-ranks] phase's gloo ranks on the card: the
    feature-sharded VB on a (2, 2) mesh, TP_RANKS_SWEEPS sweeps of the
    100k-row recipe; rank 0 writes the history and the launch counts to
    ``out`` (JSON)."""
    import torch.distributed as dist

    from svbfm_tpu_torch.kernels import build
    from svbfm_tpu_torch.learners.vb import init_vb_params
    from svbfm_tpu_torch.parallel.mesh import distributed_init, make_mesh2d
    from svbfm_tpu_torch.parallel.tp_vb import TPVBLearner

    distributed_init(init_method=f"file://{store}", world_size=TP_RANKS,
                     rank=rank, backend="gloo", device="cuda")
    tr1, _, train1, test1, meta1 = ml_data(TP_RANKS_ROWS)
    cfg1 = tp_ranks_cfg(tr1, meta1)
    tp = TPVBLearner(cfg1, train1, test1, meta1,
                     mesh=make_mesh2d(n_data=2, n_feature=2, device="cuda"))
    params = init_vb_params(torch.Generator().manual_seed(SEED), cfg1, "cpu")
    state = tp.state_from_params(params)
    torch.cuda.synchronize()
    build.reset_launch_counts()
    _, hist = tp.run(state, num_iter=TP_RANKS_SWEEPS, verbose=False)
    torch.cuda.synchronize()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(dict(hist=[{k: h[k] for k in (
                "rmse", "free_energy", "alpha", "time_learn", "iter")}
                for h in hist], launches=dict(build.launch_counts),
                device=str(tp.device), mesh=list(tp.mesh.shape)), f)
    dist.barrier()
    dist.destroy_process_group()


def tp_ranks_cfg(tr1, meta1):
    from svbfm_tpu_torch.learners.base import FMConfig

    return FMConfig(num_attributes=tr1.num_features, num_factor=TP_RANKS_K,
                    min_target=float(tr1.target.min()),
                    max_target=float(tr1.target.max()),
                    num_groups=meta1.num_attr_groups, seed=SEED)


def tp_phases(build, card, dev, train, test, meta, base_cfg, plan) -> tuple:
    """[group-sum] (X6 beside index_add_), [tp-vb] (the feature-sharded VB
    on NCCL with a world of one at ML-1M's width, K = 20, 5 sweeps beside
    the resident fast-mode VB from one init; its profile and the
    resident's), [tp-vb-k0] (K = 0, 2 sweeps: T3's w form) and
    [tp-vb-ranks] (four gloo ranks on the card, a (2, 2) mesh, beside the
    resident VB on the card).  Returns the launch counts of the two driven
    runs."""
    import torch.distributed as dist

    from svbfm_tpu_torch.learners.base import FMConfig, group_sum
    from svbfm_tpu_torch.learners.vb import VBLearner, init_vb_params
    from svbfm_tpu_torch.parallel.mesh import distributed_init, make_mesh2d
    from svbfm_tpu_torch.parallel.tp_vb import TPVBLearner

    # ---- X6: group_sum at [D, K] -> [G, K] beside index_add_ ---------------
    t0 = time.perf_counter()
    D, G = meta.num_attributes, meta.num_attr_groups
    ag = torch.from_numpy(meta.attr_group.astype(np.int64)).to(dev)
    x = torch.rand(D, K, device=dev)
    gs = cuda_ms(lambda: group_sum(x, ag, G), 20)
    ia = cuda_ms(lambda: x.new_zeros((G, K)).index_add_(0, ag, x), 20)
    if not torch.allclose(group_sum(x, ag, G), x.new_zeros(
            (G, K)).index_add_(0, ag, x), rtol=1e-5, atol=1e-4):
        raise AssertionError("group-sum: group_sum and index_add_ differ")
    say("group-sum", t0, shape=f"[{D},{K}]->[{G},{K}]", ms=f"{gs:.4f}",
        index_add_ms=f"{ia:.4f}",
        bound_ms=f"{1e3 * (D * K + G * K + D) * 4 / HBM_BYTES_PER_S:.6f}",
        card=repr(card))

    # ---- the feature-sharded VB on NCCL, a world of one, full width ------
    t0 = time.perf_counter()
    work = ooc_work("tp")
    distributed_init(init_method=f"file://{os.path.join(work, 'store')}",
                     world_size=1, rank=0, backend="nccl", device="cuda")
    cfg = FMConfig(factor_block=0, **base_cfg)
    params = init_vb_params(torch.Generator().manual_seed(SEED), cfg, "cpu")
    tp = TPVBLearner(cfg, train, test, meta, mesh=make_mesh2d(device="cuda"))
    (tstate, ht), l_tp = drive(build, "tp-vb", lambda: tp.run(
        tp.state_from_params(params), num_iter=5, verbose=False))
    check_history(ht, "tp-vb", ("rmse", "free_energy", "alpha"), True)
    res = VBLearner(cfg, train, test, meta, device=dev, plan=plan,
                    write_files=False)
    rstate, hr = res.run(res.state_from_params(params), num_iter=5,
                         verbose=False, chunk=1)
    worst = compare_traj(ht, hr, ("rmse", "free_energy", "alpha"), TP_RTOL,
                         "tp-vb vs resident vb")
    tp_us = profile_run(lambda: tp.run(tstate, num_iter=1, verbose=False), 1,
                        "sweep", "tp-vb-profile", focus=("tp_",))
    res_us = profile_run(lambda: res.run(rstate, num_iter=1, verbose=False),
                         1, "sweep", "tp-vb-resident-profile")
    sec, rsec = (statistics.median(h["time_learn"] for h in hh[1:])
                 for hh in (ht, hr))
    say("tp-vb", t0, backend=dist.get_backend(), world=dist.get_world_size(),
        mesh="1x1", sweeps=len(ht), sec_per_iter=f"{sec:.6f}",
        resident_sec_per_iter=f"{rsec:.6f}",
        device_ms_per_iter=f"{tp_us / 1e3:.3f}",
        resident_device_ms_per_iter=f"{res_us / 1e3:.3f}",
        rmse=",".join(f"{h['rmse']:.5f}" for h in ht),
        fe_last=f"{ht[-1]['free_energy']:.2f}", max_rel=f"{worst:.3e}",
        rtol=TP_RTOL, launches=json.dumps(l_tp, separators=(",", ":")),
        card=repr(card))
    del tstate, rstate

    t0 = time.perf_counter()
    cfg0 = FMConfig(**dict(base_cfg, num_factor=0))
    p0 = init_vb_params(torch.Generator().manual_seed(SEED), cfg0, "cpu")
    tp0 = TPVBLearner(cfg0, train, test, meta, mesh=tp.mesh)
    (_, h0), l_tp0 = drive(build, "tp-vb-k0", lambda: tp0.run(
        tp0.state_from_params(p0), num_iter=2, verbose=False))
    r0 = VBLearner(cfg0, train, test, meta, device=dev, plan=plan,
                   write_files=False)
    _, hr0 = r0.run(r0.state_from_params(p0), num_iter=2, verbose=False)
    worst = compare_traj(h0, hr0, ("rmse", "free_energy", "alpha"), TP_RTOL,
                         "tp-vb k0 vs resident vb")
    say("tp-vb-k0", t0, sweeps=len(h0), max_rel=f"{worst:.3e}",
        launches=json.dumps(l_tp0, separators=(",", ":")))
    dist.destroy_process_group()
    del tp, tp0, res, r0

    # ---- four gloo ranks on the one card ----------------------------------
    t0 = time.perf_counter()
    work = ooc_work("tp-ranks")
    out = os.path.join(work, "rank0.json")
    spawn_ranks(tp_rank_child, TP_RANKS,
                (os.path.join(work, "store"), out), "tp-vb-ranks")
    with open(out) as f:
        got = json.load(f)
    missing = [k for k in PATH_KERNELS["tp-vb"] if got["launches"][k] == 0]
    if missing:
        raise AssertionError(f"tp-vb-ranks: kernels never launched: "
                             f"{missing}")
    tr1, _, train1, test1, meta1 = ml_data(TP_RANKS_ROWS)
    cfg1 = tp_ranks_cfg(tr1, meta1)
    r1 = VBLearner(cfg1, train1, test1, meta1, device=dev, write_files=False)
    _, hr1 = r1.run(r1.state_from_params(init_vb_params(
        torch.Generator().manual_seed(SEED), cfg1, "cpu")),
        num_iter=TP_RANKS_SWEEPS, verbose=False)
    worst = compare_traj(got["hist"], hr1, ("rmse", "free_energy", "alpha"),
                         TP_RTOL, "tp-vb-ranks vs resident vb")
    say("tp-vb-ranks", t0, ranks=TP_RANKS, backend="gloo",
        mesh="x".join(map(str, got["mesh"])), device=got["device"],
        train_rows=tr1.num_rows, K=TP_RANKS_K, sweeps=len(got["hist"]),
        sec_per_iter=f"{statistics.median(
            h['time_learn'] for h in got['hist'][1:]):.6f}",
        max_rel=f"{worst:.3e}", rtol=TP_RTOL,
        launches=json.dumps({k: got["launches"][k]
                             for k in PATH_KERNELS["tp-vb"]},
                            separators=(",", ":")))
    return l_tp, l_tp0


def tp_mcmc_rank_child(rank: int, store: str, out: str) -> None:
    """One of the [tp-mcmc-ranks] phase's gloo ranks on the card: the
    feature-sharded Gibbs on a (2, 2) mesh, TP_RANKS_SWEEPS sweeps of the
    100k-row recipe from the seed's init and draws; rank 0 writes the
    history and the launch counts to ``out`` (JSON)."""
    import torch.distributed as dist

    from svbfm_tpu_torch.kernels import build
    from svbfm_tpu_torch.parallel.mesh import distributed_init, make_mesh2d

    distributed_init(init_method=f"file://{store}", world_size=TP_RANKS,
                     rank=rank, backend="gloo", device="cuda")
    tp = tp_mcmc_ranks_learner(make_mesh2d(n_data=2, n_feature=2,
                                           device="cuda"))
    state = tp.init_state()
    torch.cuda.synchronize()
    build.reset_launch_counts()
    _, hist = tp.run(state, num_iter=TP_RANKS_SWEEPS, verbose=False)
    torch.cuda.synchronize()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(dict(hist=[{k: h[k] for k in (
                "rmse", "rmse_this", "alpha", "time_learn", "iter")}
                for h in hist], launches=dict(build.launch_counts),
                device=str(tp.device), mesh=list(tp.mesh.shape)), f)
    dist.barrier()
    dist.destroy_process_group()


def tp_mcmc_ranks_learner(mesh):
    """The [tp-mcmc-ranks] recipe's feature-sharded Gibbs on ``mesh``:
    100k rows of the ML-1M recipe, K = 8."""
    from svbfm_tpu_torch.parallel.tp_mcmc import TPMCMCLearner

    tr1, _, train1, test1, meta1 = ml_data(TP_RANKS_ROWS)
    return TPMCMCLearner(tp_ranks_cfg(tr1, meta1), train1, test1, meta1,
                         mesh=mesh)


def tp_mcmc_phases(build, card, dev, train, test, meta, base_cfg,
                   plan) -> tuple:
    """[tp-mcmc] (the feature-sharded ALS and Gibbs on NCCL with a world of
    one at ML-1M's width, K = 20: ALS 5 sweeps beside the resident
    ALSLearner; Gibbs 2 sweeps card against CPU under one host-table draw
    source; 20 Gibbs iterations' posterior-mean RMSE beside the resident
    Gibbs's; a sweep's device time), [tp-mcmc-class] (2 Gibbs sweeps under
    -task c, card against CPU) and [tp-mcmc-ranks] (four gloo ranks on the
    card, a (2, 2) mesh, beside the world of one).  Returns the launch
    counts of the driven runs."""
    import torch.distributed as dist

    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.learners.mcmc import ALSLearner, MCMCLearner
    from svbfm_tpu_torch.models.fm import init_fm_params
    from svbfm_tpu_torch.parallel.mesh import distributed_init, make_mesh2d
    from svbfm_tpu_torch.parallel.tp_mcmc import TPALSLearner, TPMCMCLearner

    t0 = time.perf_counter()
    work = ooc_work("tp-mcmc")
    distributed_init(init_method=f"file://{os.path.join(work, 'store')}",
                     world_size=1, rank=0, backend="nccl", device="cuda")
    mesh = make_mesh2d(device="cuda")
    D = meta.num_attributes
    cfg = FMConfig(factor_block=0, **base_cfg)
    p = init_fm_params(torch.Generator().manual_seed(SEED), D, K,
                       init_stdev=cfg.init_stdev, init_w_normal=True)
    # ALS, 5 sweeps, beside the resident ALSLearner (-regular ALS_REG)
    acfg = FMConfig(factor_block=0, **dict(base_cfg, reg0=ALS_REG,
                                           regw=ALS_REG, regv=ALS_REG))
    tpa = TPALSLearner(acfg, train, test, meta, mesh=mesh)
    (_, ha), l_als = drive(build, "tp-als", lambda: tpa.run(
        tpa.state_from_params(p.w0, p.w, p.v, host_draws(SEED, dev)),
        num_iter=5, verbose=False))
    check_mcmc_history(ha, "tp-als", "rmse_this")
    ra = ALSLearner(acfg, train, test, meta, device=dev, plan=plan,
                    write_files=False)
    _, hra = ra.run(ra.state_from_params(p.w0, p.w, p.v, host_draws(
        SEED, dev)), num_iter=5, verbose=False)
    worst_als = compare_traj(ha, hra, ("rmse_this",), TP_RTOL,
                             "tp-als vs resident als")
    del tpa, ra
    # Gibbs: 2 sweeps card against CPU, one host-table draw source
    tp = TPMCMCLearner(cfg, train, test, meta, mesh=mesh)
    (_, hg), l_mcmc = drive(build, "tp-mcmc", lambda: tp.run(
        tp.state_from_params(p.w0, p.w, p.v, host_draws(SEED, dev)),
        num_iter=2, verbose=False))
    cpu = TPMCMCLearner(cfg, train, test, meta, mesh=make_mesh2d(
        device="cpu"))
    _, hc = cpu.run(cpu.state_from_params(p.w0, p.w, p.v, host_draws(
        SEED, "cpu")), num_iter=2, verbose=False)
    worst_cpu = compare_traj(hg, hc, ("rmse", "rmse_this", "alpha"),
                             TRAJ_RTOL, "tp-mcmc gpu vs cpu")
    del cpu
    # 20 Gibbs iterations' posterior mean beside the resident Gibbs's
    tstate, h20 = tp.run(num_iter=TP_MCMC_ITERS, verbose=False)
    check_mcmc_history(h20, "tp-mcmc", "rmse")
    rg = MCMCLearner(cfg, train, test, meta, device=dev, plan=plan,
                     write_files=False)
    _, hr20 = rg.run(num_iter=TP_MCMC_ITERS, verbose=False)
    gap = abs(h20[-1]["rmse"] - hr20[-1]["rmse"])
    if gap > TP_MCMC_RMSE_GAP:
        raise AssertionError(f"tp-mcmc: posterior-mean RMSE "
                             f"{h20[-1]['rmse']:.5f} at iteration "
                             f"{TP_MCMC_ITERS}, the resident Gibbs's "
                             f"{hr20[-1]['rmse']:.5f}: {gap:.4f} apart")
    us = profile_run(lambda: tp.run(tstate, num_iter=1, verbose=False), 1,
                     "sweep", "tp-mcmc-profile", focus=("tp_",))
    sec, rsec = (statistics.median(h["time_learn"] for h in hh[1:])
                 for hh in (h20, hr20))
    say("tp-mcmc", t0, backend=dist.get_backend(),
        world=dist.get_world_size(), mesh="1x1", F=K,
        als_rmse_this=",".join(f"{h['rmse_this']:.5f}" for h in ha),
        als_vs_resident_max_rel=f"{worst_als:.3e}", rtol=TP_RTOL,
        gibbs_gpu_vs_cpu_max_rel=f"{worst_cpu:.3e}", cpu_rtol=TRAJ_RTOL,
        iterations=TP_MCMC_ITERS, rmse=f"{h20[-1]['rmse']:.5f}",
        resident_rmse=f"{hr20[-1]['rmse']:.5f}", gap=f"{gap:.5f}",
        sec_per_iter=f"{sec:.6f}", resident_sec_per_iter=f"{rsec:.6f}",
        device_ms_per_iter=f"{us / 1e3:.3f}",
        launches=json.dumps(l_mcmc, separators=(",", ":")), card=repr(card))
    del tp, tstate, rg

    # -task c: 2 Gibbs sweeps, card against CPU
    t0 = time.perf_counter()
    ctr, cte = (binarised(d, CLASS_THRESHOLD) for d in (train, test))
    ccfg = FMConfig(factor_block=0, **dict(base_cfg, task=1, min_target=-1.0,
                                           max_target=1.0))
    hist = []
    for d in ("cuda", "cpu"):
        lc = TPMCMCLearner(ccfg, ctr, cte, meta, mesh=mesh if d == "cuda"
                           else make_mesh2d(device="cpu"))

        def go(lc=lc, d=d):
            return lc.run(lc.state_from_params(p.w0, p.w, p.v, host_draws(
                SEED, lc.device)), num_iter=2, verbose=False)
        if d == "cuda":
            (_, h), l_class = drive(build, "tp-mcmc-class", go)
        else:
            _, h = go()
        check_class_history(h, f"tp-mcmc-class {d}")
        hist.append(h)
    worst_class = compare_traj(*hist, ("accuracy", "loglik", "alpha"),
                               TRAJ_RTOL, "tp-mcmc-class gpu vs cpu")
    say("tp-mcmc-class", t0, sweeps=2,
        accuracy=",".join(f"{h['accuracy']:.5f}" for h in hist[0]),
        max_rel=f"{worst_class:.3e}", rtol=TRAJ_RTOL,
        launches=json.dumps(l_class, separators=(",", ":")))

    # four gloo ranks on the one card beside the world of one, one seed
    t0 = time.perf_counter()
    one = tp_mcmc_ranks_learner(mesh)
    _, h1 = one.run(num_iter=TP_RANKS_SWEEPS, verbose=False)
    dist.destroy_process_group()
    del one
    rwork = ooc_work("tp-mcmc-ranks")
    out = os.path.join(rwork, "rank0.json")
    spawn_ranks(tp_mcmc_rank_child, TP_RANKS,
                (os.path.join(rwork, "store"), out), "tp-mcmc-ranks")
    with open(out) as f:
        got = json.load(f)
    missing = [k for k in TP_MCMC_KERNELS if got["launches"][k] == 0]
    if missing:
        raise AssertionError(f"tp-mcmc-ranks: kernels never launched: "
                             f"{missing}")
    worst = compare_traj(got["hist"], h1, ("rmse", "rmse_this", "alpha"),
                         TP_RTOL, "tp-mcmc-ranks vs the world of one")
    say("tp-mcmc-ranks", t0, ranks=TP_RANKS, backend="gloo",
        mesh="x".join(map(str, got["mesh"])), device=got["device"],
        K=TP_RANKS_K, sweeps=len(got["hist"]),
        sec_per_iter=f"{statistics.median(
            h['time_learn'] for h in got['hist'][1:]):.6f}",
        rmse=",".join(f"{h['rmse']:.5f}" for h in got["hist"]),
        max_rel=f"{worst:.3e}", rtol=TP_RTOL,
        launches=json.dumps({k: got["launches"][k]
                             for k in TP_MCMC_KERNELS},
                            separators=(",", ":")))
    return l_als, l_mcmc, l_class


def dp_rank_child(rank: int, store: str, out: str) -> None:
    """One of the [dp-vb-ranks]/[dp-mcmc-ranks] phases' gloo ranks on the
    card: the data-parallel VB (fast mode, then exact mode at factor_block
    1), ALS and Gibbs on a data mesh of DP_RANKS, the 100k-row recipe at
    K = 8, from the seed's init and host-table draws (``dp_ranks_runs``);
    rank 0 writes the histories and each run's launch counts to ``out``
    (JSON)."""
    import torch.distributed as dist

    from svbfm_tpu_torch.parallel.mesh import distributed_init, make_mesh

    distributed_init(init_method=f"file://{store}", world_size=DP_RANKS,
                     rank=rank, backend="gloo", device="cuda")
    got = dp_ranks_runs(make_mesh(device="cuda"))
    if rank == 0:
        with open(out, "w") as f:
            json.dump(got, f)
    dist.barrier()
    dist.destroy_process_group()


def dp_ranks_runs(mesh) -> dict:
    """The ranks phases' runs on ``mesh`` (a world of one in the parent,
    DP_RANKS gloo ranks in the children): for each of DP_RANKS_RUNS, the
    history's metrics, the launch counts and the mesh."""
    from svbfm_tpu_torch.kernels import build
    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.learners.mcmc import ALSLearner, MCMCLearner
    from svbfm_tpu_torch.learners.vb import VBLearner, init_vb_params
    from svbfm_tpu_torch.models.fm import init_fm_params

    tr1, _, train1, test1, meta1 = ml_data(TP_RANKS_ROWS)
    base = tp_ranks_cfg(tr1, meta1)
    out = {}
    for name, (path, fb, n, keys) in DP_RANKS_RUNS.items():
        cfg = dataclasses.replace(base, factor_block=fb, **(
            dict(reg0=ALS_REG, regw=ALS_REG, regv=ALS_REG) if name == "als"
            else {}))
        gen = torch.Generator().manual_seed(SEED)
        torch.cuda.synchronize()
        build.reset_launch_counts()  # the init's K1 launches count too
        if path.startswith("dp-vb"):
            lr = VBLearner(cfg, train1, test1, meta1, mesh=mesh,
                           write_files=False)
            state = lr.state_from_params(init_vb_params(gen, cfg, "cpu"))
        else:
            cls = ALSLearner if name == "als" else MCMCLearner
            lr = cls(cfg, train1, test1, meta1, mesh=mesh, write_files=False)
            p = init_fm_params(gen, cfg.num_attributes, cfg.num_factor,
                               init_stdev=cfg.init_stdev, init_w_normal=True)
            state = lr.state_from_params(p.w0, p.w, p.v,
                                         host_draws(SEED, lr.device))
        _, hist = lr.run(state, num_iter=n, verbose=False, chunk=1)
        torch.cuda.synchronize()
        out[name] = dict(hist=[{k: h[k] for k in keys + (
            "time_learn", "iter")} for h in hist],
            launches=dict(build.launch_counts), device=str(lr.device),
            ranks=mesh.n_data)
    return out


def dp_vb_phase(build, card, dev, mesh, train, test, meta, base_cfg, plan,
                path: str, fb: int, sweeps: int) -> dict:
    """One [dp-vb*] run: the data-parallel VB on ``mesh`` beside the
    resident VB from one init, ``sweeps`` sweeps, the trajectories within
    TRAJ_RTOL; a sweep's device time beside the resident's.  Returns the
    launch counts."""
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.vb import VBLearner, init_vb_params

    t0 = time.perf_counter()
    task = 1 if path.endswith("class") else 0
    if task:
        train, test = (binarised(d, CLASS_THRESHOLD) for d in (train, test))
        base_cfg = dict(base_cfg, task=1, min_target=-1.0, max_target=1.0)
    cfg = FMConfig(factor_block=fb, **base_cfg)
    params = init_vb_params(torch.Generator().manual_seed(SEED), cfg, "cpu")
    dp = VBLearner(cfg, train, test, meta, mesh=mesh, write_files=False)
    (dstate, hd), launches = drive(build, path, lambda: dp.run(
        dp.state_from_params(params), num_iter=sweeps, verbose=False,
        chunk=1))
    res = VBLearner(cfg, train, test, meta, device=dev, plan=plan,
                    write_files=False)
    rstate, hr = res.run(res.state_from_params(params), num_iter=sweeps,
                         verbose=False, chunk=1)
    if task:
        check_class_history(hd, path)
        keys = ("accuracy", "loglik", "free_energy", "alpha")
    else:
        check_history(hd, path, ("rmse", "free_energy", "alpha"), True)
        keys = ("rmse", "train_rmse", "free_energy", "alpha")
    worst = compare_traj(hd, hr, keys, TRAJ_RTOL, f"{path} vs resident vb")
    d_us = profile_run(lambda: dp.run(dstate, num_iter=1, verbose=False), 1,
                       "sweep", f"{path}-profile", focus=("tp_",))
    r_us = profile_run(lambda: res.run(rstate, num_iter=1, verbose=False), 1,
                       "sweep", f"{path}-resident-profile")
    sec, rsec = (statistics.median(h["time_learn"] for h in hh[1:])
                 for hh in (hd, hr))
    say(path, t0, backend=dist_backend(), ranks=mesh.n_data,
        factor_block=fb, task=task, sweeps=sweeps,
        sec_per_iter=f"{sec:.6f}", resident_sec_per_iter=f"{rsec:.6f}",
        device_ms_per_iter=f"{d_us / 1e3:.3f}",
        resident_device_ms_per_iter=f"{r_us / 1e3:.3f}",
        **{keys[0]: ",".join(f"{h[keys[0]]:.5f}" for h in hd)},
        max_rel=f"{worst:.3e}", rtol=TRAJ_RTOL,
        launches=json.dumps(launches, separators=(",", ":")),
        card=repr(card))
    return launches


def dp_mcmc_phase(build, card, dev, mesh, train, test, meta, base_cfg, plan,
                  path: str, fb: int, sweeps: int) -> dict:
    """One [dp-mcmc*]/[dp-als] run: the data-parallel Gibbs (ALS) on
    ``mesh`` beside the resident learner from one init and one host-table
    draw source each, the trajectories within TRAJ_RTOL; a sweep's device
    time beside the resident's.  Returns the launch counts."""
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.learners.mcmc import ALSLearner, MCMCLearner
    from svbfm_tpu_torch.models.fm import init_fm_params

    t0 = time.perf_counter()
    task = 1 if path.endswith("class") else 0
    als = path == "dp-als"
    if task:
        train, test = (binarised(d, CLASS_THRESHOLD) for d in (train, test))
        base_cfg = dict(base_cfg, task=1, min_target=-1.0, max_target=1.0)
    if als:
        base_cfg = dict(base_cfg, reg0=ALS_REG, regw=ALS_REG, regv=ALS_REG)
    cfg = FMConfig(factor_block=fb, **base_cfg)
    cls = ALSLearner if als else MCMCLearner
    p = init_fm_params(torch.Generator().manual_seed(SEED),
                       cfg.num_attributes, K, init_stdev=cfg.init_stdev,
                       init_w_normal=True)
    dp = cls(cfg, train, test, meta, mesh=mesh, write_files=False)
    (dstate, hd), launches = drive(build, path, lambda: dp.run(
        dp.state_from_params(p.w0, p.w, p.v, host_draws(SEED, dev)),
        num_iter=sweeps, verbose=False, chunk=1))
    res = cls(cfg, train, test, meta, device=dev, plan=plan,
              write_files=False)
    rstate, hr = res.run(res.state_from_params(p.w0, p.w, p.v, host_draws(
        SEED, dev)), num_iter=sweeps, verbose=False, chunk=1)
    if task:
        check_class_history(hd, path)
        keys = ("accuracy", "loglik", "alpha")
    else:
        check_mcmc_history(hd, path, "rmse_this" if als else "rmse")
        keys = ("rmse", "rmse_this", "alpha")
    worst = compare_traj(hd, hr, keys, TRAJ_RTOL, f"{path} vs resident")
    d_us = profile_run(lambda: dp.run(dstate, num_iter=1, verbose=False), 1,
                       "sweep", f"{path}-profile", focus=("tp_",))
    r_us = profile_run(lambda: res.run(rstate, num_iter=1, verbose=False), 1,
                       "sweep", f"{path}-resident-profile")
    sec, rsec = (statistics.median(h["time_learn"] for h in hh[1:])
                 for hh in (hd, hr))
    say(path, t0, backend=dist_backend(), ranks=mesh.n_data,
        factor_block=fb, task=task, sweeps=sweeps,
        sec_per_iter=f"{sec:.6f}", resident_sec_per_iter=f"{rsec:.6f}",
        device_ms_per_iter=f"{d_us / 1e3:.3f}",
        resident_device_ms_per_iter=f"{r_us / 1e3:.3f}",
        **{keys[1]: ",".join(f"{h[keys[1]]:.5f}" for h in hd)},
        max_rel=f"{worst:.3e}", rtol=TRAJ_RTOL,
        launches=json.dumps(launches, separators=(",", ":")),
        card=repr(card))
    return launches


def dist_backend() -> str:
    import torch.distributed as dist

    return dist.get_backend() if dist.is_initialized() else "none"


def dp_phases(build, card, dev, train, test, meta, base_cfg, plan) -> list:
    """The data-parallel replicated learners (``VBLearner``/``MCMCLearner``/
    ``ALSLearner(mesh=)``: T3, T3 at K = 0, T5 and T7 at lo = 0, D_loc = D
    around the data all-reduce): [dp-vb] (NCCL, a world of one, ML-1M,
    K = 20: fast mode and exact mode at factor_block 1 beside the resident
    VB, and -task c at factor_block 1), [dp-mcmc] (ALS at the default
    block, Gibbs at the default block and at factor_block 1, and Gibbs
    under -task c, each beside the resident learner under one host-table
    draw source), then [dp-vb-ranks] and [dp-mcmc-ranks] (DP_RANKS gloo
    ranks on the card, the 100k-row recipe at K = 8, beside the world of
    one).  Every trajectory within TRAJ_RTOL.  Returns the launch counts
    of the driven runs."""
    import torch.distributed as dist

    from svbfm_tpu_torch.parallel.mesh import distributed_init, make_mesh

    work = ooc_work("dp")
    distributed_init(init_method=f"file://{os.path.join(work, 'store')}",
                     world_size=1, rank=0, backend="nccl", device="cuda")
    mesh = make_mesh(device="cuda")
    args = (build, card, dev, mesh, train, test, meta, base_cfg, plan)
    runs = [dp_vb_phase(*args, path, fb, n) for path, fb, n in (
        ("dp-vb", 0, 5), ("dp-vb-exact", 1, 3), ("dp-vb-class", 1, 3))]
    runs += [dp_mcmc_phase(*args, path, fb, n) for path, fb, n in (
        ("dp-als", 0, 5), ("dp-mcmc", 0, 2), ("dp-mcmc-seq", 1, 2),
        ("dp-mcmc-class", 1, 2))]

    # DP_RANKS gloo ranks on the one card beside the world of one
    t0 = time.perf_counter()
    one = dp_ranks_runs(mesh)
    dist.destroy_process_group()
    rwork = ooc_work("dp-ranks")
    out = os.path.join(rwork, "rank0.json")
    spawn_ranks(dp_rank_child, DP_RANKS,
                (os.path.join(rwork, "store"), out), "dp-ranks")
    with open(out) as f:
        got = json.load(f)
    for phase, names in (("dp-vb-ranks", ("vb", "vb_exact")),
                         ("dp-mcmc-ranks", ("als", "gibbs"))):
        kv = {}
        for name in names:
            path, _fb, _n, keys = DP_RANKS_RUNS[name]
            g = got[name]
            missing = [k for k in PATH_KERNELS[path]
                       if g["launches"][k] == 0]
            if missing:
                raise AssertionError(f"{phase} {name}: kernels never "
                                     f"launched: {missing}")
            worst = compare_traj(g["hist"], one[name]["hist"], keys,
                                 TRAJ_RTOL,
                                 f"{phase} {name} vs the world of one")
            kv.update({
                f"{name}_{keys[0]}": ",".join(f"{h[keys[0]]:.5f}"
                                              for h in g["hist"]),
                f"{name}_sec_per_iter": f"{statistics.median(
                    h['time_learn'] for h in g['hist'][1:]):.6f}",
                f"{name}_one_sec_per_iter": f"{statistics.median(
                    h['time_learn'] for h in one[name]['hist'][1:]):.6f}",
                f"{name}_max_rel": f"{worst:.3e}"})
        say(phase, t0, ranks=got[names[0]]["ranks"], backend="gloo",
            device=got[names[0]]["device"], K=TP_RANKS_K, rtol=TRAJ_RTOL,
            **kv)
    return runs


def dp_slice_rank_child(rank: int, store: str, out: str) -> None:
    """One of the [dp-bs-ranks]/[dp-ovb-ranks] phases' gloo ranks on the
    card: ``dp_slice_ranks_runs`` on a data mesh of DP_RANKS; rank 0
    writes the histories and each run's launch counts to ``out``
    (JSON)."""
    import torch.distributed as dist

    from svbfm_tpu_torch.parallel.mesh import distributed_init, make_mesh

    distributed_init(init_method=f"file://{store}", world_size=DP_RANKS,
                     rank=rank, backend="gloo", device="cuda")
    got = dp_slice_ranks_runs(make_mesh(device="cuda"))
    if rank == 0:
        with open(out, "w") as f:
            json.dump(got, f)
    dist.barrier()
    dist.destroy_process_group()


def dp_slice_ranks_runs(mesh) -> dict:
    """The ranks phases' runs on ``mesh`` (a world of one in the parent,
    DP_RANKS gloo ranks in the children), each of DP_SLICE_RANKS_RUNS from
    the seed's init: BS Gibbs and ALS on the 100k-row relational recipe
    (4 + 4 slots, K = 8, host-table draws; Gibbs with the items as
    main-block columns beside the user relation), OVB on the 100k-row
    recipe (K = 8, TP_OVB_RANKS_CHUNKS chunks) at factor_block 1 and 4.  For each,
    the history's metrics, the launch counts and the mesh."""
    from svbfm_tpu_torch.kernels import build
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.learners.vb_online import OVBLearner, init_ovb_state
    from svbfm_tpu_torch.models.fm import init_fm_params

    qps = {main: bs_problem(BS_Q_ROWS, BS_Q_SLOTS, holdout=True,
                            main_items=main) for main in (False, True)}
    tr1, _, train1, test1, meta1 = ml_data(TP_RANKS_ROWS)
    out = {}
    for name, (path, fb, n, keys) in DP_SLICE_RANKS_RUNS.items():
        torch.cuda.synchronize()
        build.reset_launch_counts()  # the init's launches count too
        if name.startswith("bs"):
            qp = qps[path == "dp-bs-main"]
            lr = bs_learner(qp, mesh.device, name == "bs_als", mesh=mesh,
                            num_factor=BS_Q_K, regw=BS_REG, regv=BS_REG,
                            factor_block=fb)
            p = init_fm_params(torch.Generator().manual_seed(SEED),
                               lr.cfg.num_attributes, BS_Q_K,
                               init_w_normal=True)
            state = lr.state_from_params(p.w0, p.w, p.v,
                                         host_draws(SEED, lr.device))
            kw = dict(chunk=1)
        else:
            cfg = dataclasses.replace(tp_ranks_cfg(tr1, meta1),
                                      num_batches=TP_OVB_RANKS_CHUNKS,
                                      factor_block=fb)
            lr = OVBLearner(cfg, train1, test1, meta1, mesh=mesh,
                            write_files=False)
            state = to_device(init_ovb_state(
                torch.Generator().manual_seed(SEED), cfg, "cpu"), lr.device)
            kw = {}
        _, hist = lr.run(state, num_iter=n, verbose=False, **kw)
        torch.cuda.synchronize()
        out[name] = dict(hist=[{k: h[k] for k in keys + (
            "time_learn", "iter")} for h in hist],
            launches=dict(build.launch_counts), device=str(lr.device),
            ranks=mesh.n_data)
    return out


def dp_bs_phase(build, card, dev, mesh, bsp: dict, resident, path: str,
                als: bool, fb: int, task: int, sweeps: int,
                profile: bool) -> dict:
    """One [dp-bs*] run: the data-parallel BS learner on ``mesh`` beside
    the resident one (``resident``, else built here) from one init and one
    host-table draw source each, ``sweeps`` sweeps, the trajectories
    within TRAJ_RTOL; with ``profile`` a sweep's device time beside the
    resident's.  Returns the launch counts."""
    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.models.fm import init_fm_params

    t0 = time.perf_counter()
    cfg_kw = dict(num_factor=K, regw=BS_REG, regv=BS_REG, factor_block=fb)
    if task:
        thr = float(np.median(bsp["train"].target[: bsp["train"].num_rows]))
        bsp = dict(bsp, train=binarised(bsp["train"], thr),
                   test=binarised(bsp["test"], thr))
        cfg_kw.update(task=1, min_target=-1.0, max_target=1.0)
    dp = bs_learner(bsp, dev, als, mesh=mesh, **cfg_kw)
    res = resident or bs_learner(bsp, dev, als, **cfg_kw)
    p = init_fm_params(torch.Generator().manual_seed(SEED),
                       dp.cfg.num_attributes, K, init_w_normal=True)

    def start(lr):
        return lr.state_from_params(p.w0, p.w, p.v, host_draws(SEED, dev))

    (dstate, hd), launches = drive(build, path, lambda: dp.run(
        start(dp), num_iter=sweeps, verbose=False, chunk=1))
    rstate, hr = res.run(start(res), num_iter=sweeps, verbose=False, chunk=1)
    if task:
        check_class_history(hd, path)
        keys = ("accuracy", "loglik", "alpha")
    else:
        check_mcmc_history(hd, path, "rmse_this" if als else "rmse")
        keys = ("rmse", "rmse_this", "alpha")
    worst = compare_traj(hd, hr, keys, TRAJ_RTOL, f"{path} vs resident")
    kv = {}
    if profile:
        d_us = profile_run(lambda: dp.run(dstate, num_iter=1, verbose=False),
                           1, "sweep", f"{path}-profile", focus=BS_FOCUS)
        r_us = profile_run(lambda: res.run(rstate, num_iter=1,
                                           verbose=False),
                           1, "sweep", f"{path}-resident-profile",
                           focus=BS_FOCUS)
        kv = dict(device_ms_per_iter=f"{d_us / 1e3:.3f}",
                  resident_device_ms_per_iter=f"{r_us / 1e3:.3f}")
    sec, rsec = (statistics.median(h["time_learn"] for h in hh[1:])
                 for hh in (hd, hr))
    say(path, t0, backend=dist_backend(), ranks=mesh.n_data,
        factor_block=dp.factor_width, task=task, sweeps=sweeps,
        sec_per_iter=f"{sec:.6f}", resident_sec_per_iter=f"{rsec:.6f}", **kv,
        **{keys[1]: ",".join(f"{h[keys[1]]:.5f}" for h in hd)},
        max_rel=f"{worst:.3e}", rtol=TRAJ_RTOL,
        launches=json.dumps(launches, separators=(",", ":")),
        card=repr(card))
    return launches


def dp_ovb_phase(build, card, dev, mesh, train, test, meta, base_cfg,
                 path: str, fb: int, reshuffle: bool, epochs: int,
                 profile: bool, stream: str = "") -> dict:
    """One [dp-ovb*] run: the data-parallel OVB on ``mesh`` (in memory, or
    streamed from the binary train file ``stream``) beside the resident
    OVB built alike, from one init, ``epochs`` epochs of OVB_CHUNKS
    chunks, the trajectories and the tables within TRAJ_RTOL; with
    ``profile`` an epoch's device time beside the resident's.  Returns the
    launch counts."""
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.vb_online import (OVBLearner,
                                                    init_ovb_state)

    t0 = time.perf_counter()
    task = 1 if path.endswith("class") else 0
    if task:
        train, test = (binarised(d, CLASS_THRESHOLD) for d in (train, test))
        base_cfg = dict(base_cfg, task=1, min_target=-1.0, max_target=1.0)
    cfg = FMConfig(num_batches=OVB_CHUNKS, factor_block=fb,
                   reshuffle=reshuffle, **base_cfg)
    init = init_ovb_state(torch.Generator().manual_seed(SEED), cfg, "cpu")

    def learner(**kw):
        if stream:
            return OVBLearner.from_reader(cfg, binary_reader(stream), test,
                                          meta, write_files=False, **kw)
        return OVBLearner(cfg, train, test, meta, write_files=False, **kw)

    w0 = time.perf_counter()
    dp = learner(mesh=mesh)
    setup_s = time.perf_counter() - w0
    (dstate, hd), launches = drive(build, path, lambda: dp.run(
        to_device(init, dev), num_iter=epochs, verbose=False))
    res = learner(device=dev)
    rstate, hr = res.run(to_device(init, dev), num_iter=epochs,
                         verbose=False)
    if task:
        check_class_history(hd, path)
        keys = ("accuracy", "loglik", "free_energy")
    else:
        check_history(hd, path, ("rmse", "mae", "free_energy"), False)
        keys = ("rmse", "mae", "free_energy")
    worst = compare_traj(hd, hr, keys, TRAJ_RTOL, f"{path} vs resident ovb")
    tab = table_gap(dstate, rstate, ("mu_w", "sigma_w_dash", "mu_v",
                                     "sigma_v_dash", "n_mu_v", "n_sig_v"),
                    cfg.num_attributes)
    if tab > TRAJ_RTOL:
        raise AssertionError(f"{path}: the tables {tab:.3e} (of each "
                             "table's scale) from the resident's")
    kv = {}
    if profile:
        d_us = profile_run(lambda: dp.run(dstate, num_iter=1, verbose=False),
                           1, "epoch", f"{path}-profile",
                           focus=("ovb_col_stats", "tp_w_kernel"))
        r_us = profile_run(lambda: res.run(rstate, num_iter=1,
                                           verbose=False),
                           1, "epoch", f"{path}-resident-profile",
                           focus=("ovb_col_stats", "w_bin_kernel"))
        kv = dict(device_ms_per_epoch=f"{d_us / 1e3:.3f}",
                  resident_device_ms_per_epoch=f"{r_us / 1e3:.3f}")
    sec = [h["time_learn"] for h in hd]
    rsec = [h["time_learn"] for h in hr]
    say(path, t0, backend=dist_backend(), ranks=mesh.n_data,
        factor_block=fb, reshuffle=int(reshuffle), task=task,
        streamed=int(bool(stream)), epochs=epochs, chunks=OVB_CHUNKS,
        n_chunk=dp.n_chunk, setup_s=f"{setup_s:.3f}",
        sec_per_epoch=",".join(f"{x:.6f}" for x in sec),
        resident_sec_per_epoch=",".join(f"{x:.6f}" for x in rsec), **kv,
        **{keys[0]: ",".join(f"{h[keys[0]]:.5f}" for h in hd)},
        max_rel=f"{worst:.3e}", tables_max_rel=f"{tab:.3e}",
        rtol=TRAJ_RTOL, launches=json.dumps(launches, separators=(",", ":")),
        card=repr(card))
    return launches


def dp_slice_phases(build, card, dev, tr, train, test, meta, base_cfg,
                    bsp: dict, bs_mcmc) -> list:
    """The data-parallel block structure and online VB
    (``MCMCBSLearner``/``ALSBSLearner``/``OVBLearner(mesh=)``: X10a on the
    rank's join slices and an all-reduce of the channel columns; T10 and
    T13 around the data all-reduces): on NCCL with a world of one,
    [dp-bs] (Gibbs at F = K beside [bs-mcmc]'s resident learner, then at
    factor_block 1, [dp-bs-seq]), [dp-bs-als], [dp-bs-class] on the 1M-row
    relational recipe at K = 20, each beside the resident learner from one
    init and one host-table draw source; [dp-ovb] (ML-1M, K = 20,
    OVB_CHUNKS chunks: factor_block 1 with its device time, 4, and 1 with
    ``reshuffle``), [dp-ovb-class], [dp-ovb-stream] (the train rows as a
    binary file), each beside the resident OVB from one init; then
    [dp-bs-ranks] and [dp-ovb-ranks] (DP_RANKS gloo ranks on the card,
    the 100k-row recipes, beside the world of one).  Every trajectory
    within TRAJ_RTOL.  Returns the launch counts of the driven runs."""
    import torch.distributed as dist

    from svbfm_tpu_torch.data.binary import save_coo_binary
    from svbfm_tpu_torch.parallel.mesh import distributed_init, make_mesh

    t_all = time.perf_counter()
    work = ooc_work("dp-slice")
    distributed_init(init_method=f"file://{os.path.join(work, 'store')}",
                     world_size=1, rank=0, backend="nccl", device="cuda")
    mesh = make_mesh(device="cuda")
    runs = [dp_bs_phase(build, card, dev, mesh, bsp, res, path, als, fb,
                        task, DP_BS_SWEEPS, prof)
            for res, path, als, fb, task, prof in (
                (bs_mcmc, "dp-bs", False, 0, 0, True),
                (None, "dp-bs-seq", False, 1, 0, True),
                (None, "dp-bs-als", True, 0, 0, False),
                (None, "dp-bs-class", False, 0, 1, False))]
    runs.append(dp_bs_phase(
        build, card, dev, mesh, bs_problem(BS_Q_ROWS, BS_Q_SLOTS,
                                           holdout=True, main_items=True),
        None, "dp-bs-main", False, 0, 0, DP_BS_SWEEPS, False))
    prefix = os.path.join(work, "ml1m_train")
    save_coo_binary(prefix, tr)
    args = (build, card, dev, mesh, train, test, meta, base_cfg)
    runs += [dp_ovb_phase(*args, path, fb, resh, DP_OVB_EPOCHS, prof,
                          stream)
             for path, fb, resh, prof, stream in (
                 ("dp-ovb", 1, False, True, ""),
                 ("dp-ovb", 4, False, False, ""),
                 ("dp-ovb", 1, True, False, ""),
                 ("dp-ovb-class", 1, False, False, ""),
                 ("dp-ovb-stream", 1, False, False, prefix))]

    # DP_RANKS gloo ranks on the one card beside the world of one
    t0 = time.perf_counter()
    one = dp_slice_ranks_runs(mesh)
    dist.destroy_process_group()
    rwork = ooc_work("dp-slice-ranks")
    out = os.path.join(rwork, "rank0.json")
    spawn_ranks(dp_slice_rank_child, DP_RANKS,
                (os.path.join(rwork, "store"), out), "dp-slice-ranks")
    with open(out) as f:
        got = json.load(f)
    for phase, names in (("dp-bs-ranks", ("bs_gibbs", "bs_als")),
                         ("dp-ovb-ranks", ("ovb", "ovb_fb4"))):
        kv = {}
        for name in names:
            path, _fb, _n, keys = DP_SLICE_RANKS_RUNS[name]
            g = got[name]
            missing = [k for k in PATH_KERNELS[path]
                       if g["launches"][k] == 0]
            if missing:
                raise AssertionError(f"{phase} {name}: kernels never "
                                     f"launched: {missing}")
            worst = compare_traj(g["hist"], one[name]["hist"], keys,
                                 TRAJ_RTOL,
                                 f"{phase} {name} vs the world of one")
            kv.update({
                f"{name}_{keys[0]}": ",".join(f"{h[keys[0]]:.5f}"
                                              for h in g["hist"]),
                f"{name}_sec_per_iter": ",".join(
                    f"{h['time_learn']:.6f}" for h in g["hist"]),
                f"{name}_one_sec_per_iter": ",".join(
                    f"{h['time_learn']:.6f}" for h in one[name]["hist"]),
                f"{name}_max_rel": f"{worst:.3e}"})
        say(phase, t0, ranks=got[names[0]]["ranks"], backend="gloo",
            device=got[names[0]]["device"], K=BS_Q_K, rtol=TRAJ_RTOL, **kv)
    # every [dp-bs*] and [dp-ovb*] phase, the ranks' spawn among them
    say("dp-slice-total", t_all, phases=len(runs) + 2)
    return runs


def tp_ovb_rank_child(rank: int, store: str, out: str) -> None:
    """One of the [tp-ovb-ranks] phase's gloo ranks on the card: the
    feature-sharded OVB on a (2, 2) mesh, TP_OVB_RANKS_EPOCHS epochs of the
    100k-row recipe from the seed's init; rank 0 writes the history and
    the launch counts to ``out`` (JSON)."""
    import torch.distributed as dist

    from svbfm_tpu_torch.kernels import build
    from svbfm_tpu_torch.parallel.mesh import distributed_init, make_mesh2d

    distributed_init(init_method=f"file://{store}", world_size=TP_RANKS,
                     rank=rank, backend="gloo", device="cuda")
    tp = tp_ovb_ranks_learner(make_mesh2d(n_data=2, n_feature=2,
                                          device="cuda"))
    state = tp.init_state()
    torch.cuda.synchronize()
    build.reset_launch_counts()
    _, hist = tp.run(state, num_iter=TP_OVB_RANKS_EPOCHS, verbose=False)
    torch.cuda.synchronize()
    if rank == 0:
        with open(out, "w") as f:
            json.dump(dict(hist=[{k: h[k] for k in (
                "rmse", "mae", "free_energy", "time_learn", "iter")}
                for h in hist], launches=dict(build.launch_counts),
                device=str(tp.device), mesh=list(tp.mesh.shape)), f)
    dist.barrier()
    dist.destroy_process_group()


def tp_ovb_ranks_learner(mesh):
    """The [tp-ovb-ranks] recipe's feature-sharded OVB on ``mesh``: 100k
    rows of the ML-1M recipe, K = 8, TP_OVB_RANKS_CHUNKS chunks."""
    from svbfm_tpu_torch.parallel.tp_ovb import TPOVBLearner

    tr1, _, train1, test1, meta1 = ml_data(TP_RANKS_ROWS)
    cfg = dataclasses.replace(tp_ranks_cfg(tr1, meta1),
                              num_batches=TP_OVB_RANKS_CHUNKS)
    return TPOVBLearner(cfg, train1, test1, meta1, mesh=mesh)


def table_gap(a, b, names, D: int) -> float:
    """The largest difference between the tables ``names`` of states a and
    b over their first D columns, each relative to the larger of 1 and its
    table's largest magnitude in b."""
    worst = 0.0
    for k in names:
        x = getattr(a, k)[..., :D].double().cpu()
        y = getattr(b, k)[..., :D].double().cpu()
        worst = max(worst, float((x - y).abs().max())
                    / max(1.0, float(y.abs().max())))
    return worst


def tp_ovb_phases(build, card, dev, train, test, meta, base_cfg, ho,
                  ostate, ovb_sec: str) -> tuple:
    """[tp-ovb] (the feature-sharded OVB on NCCL with a world of one at
    ML-1M's width, K = 20, 20 chunks of fixed membership, as many epochs
    as [ovb] ran, beside [ovb]'s resident run from the same init: the
    trajectory and the ten tables within TRAJ_RTOL; card against CPU on
    the 100k-row recipe; sec/epoch beside [ovb]'s), [tp-ovb-profile] (an
    epoch's device time, busy share and ops; [ovb-profile] gives the
    resident's) and [tp-ovb-ranks] (four gloo ranks on the card, a (2, 2)
    mesh, beside the world of one).  Returns the launch counts of the
    driven runs and the device µs of the profiled epoch."""
    import torch.distributed as dist

    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.parallel.mesh import distributed_init, make_mesh2d
    from svbfm_tpu_torch.parallel.tp_ovb import SHARDED_TABLES, TPOVBLearner

    t0 = time.perf_counter()
    work = ooc_work("tp-ovb")
    distributed_init(init_method=f"file://{os.path.join(work, 'store')}",
                     world_size=1, rank=0, backend="nccl", device="cuda")
    mesh = make_mesh2d(device="cuda")
    tp = TPOVBLearner(FMConfig(num_batches=OVB_CHUNKS, **base_cfg), train,
                      test, meta, mesh=mesh)
    (tstate, ht), l_tpo = drive(build, "tp-ovb", lambda: tp.run(
        tp.init_state(), num_iter=len(ho), verbose=False))
    check_history(ht, "tp-ovb", ("rmse", "mae", "free_energy"), False)
    bad = {k: v for h in ht for k, v in h.items()
           if k.startswith(("nan_", "inf_")) and v}
    if bad:
        raise AssertionError(f"tp-ovb: non-finite candidates {bad}")
    worst = compare_traj(ht, ho, ("rmse", "mae", "free_energy"), TRAJ_RTOL,
                         "tp-ovb vs resident ovb")
    tab = table_gap(tp.global_state(tstate), ostate, SHARDED_TABLES,
                    meta.num_attributes)
    if tab > TRAJ_RTOL:
        raise AssertionError(f"tp-ovb: the tables {tab:.3e} (of each "
                             f"table's scale) from the resident's")
    # card against CPU on the 100k-row recipe, [ovb-gpu-vs-cpu]'s
    tr1, _, train1, test1, meta1 = ml_data(100_000)
    cfg1 = FMConfig(num_attributes=tr1.num_features, num_factor=8,
                    min_target=float(tr1.target.min()),
                    max_target=float(tr1.target.max()),
                    num_groups=meta1.num_attr_groups, seed=SEED,
                    num_batches=10)
    hists = []
    for m in (mesh, make_mesh2d(device="cpu")):
        lr = TPOVBLearner(cfg1, train1, test1, meta1, mesh=m)
        hists.append(lr.run(lr.init_state(), num_iter=2, verbose=False)[1])
    worst_cpu = compare_traj(*hists, ("rmse", "mae", "free_energy"),
                             OVB_TRAJ_RTOL, "tp-ovb gpu vs cpu")
    del lr
    sec = statistics.median(h["time_learn"] for h in ht[1:])
    say("tp-ovb", t0, backend=dist.get_backend(),
        world=dist.get_world_size(), mesh="1x1", epochs=len(ht),
        chunks=OVB_CHUNKS, sec_per_epoch=f"{sec:.6f}",
        resident_sec_per_epoch=ovb_sec,
        rmse=",".join(f"{h['rmse']:.5f}" for h in ht),
        fe_last=f"{ht[-1]['free_energy']:.2f}", max_rel=f"{worst:.3e}",
        tables_max_rel=f"{tab:.3e}", rtol=TRAJ_RTOL,
        gpu_vs_cpu_rows=tr1.num_rows, gpu_vs_cpu_max_rel=f"{worst_cpu:.3e}",
        cpu_rtol=OVB_TRAJ_RTOL,
        launches_per_epoch=json.dumps({k: l_tpo[k] // len(ht)
                                       for k in TP_OVB_KERNELS},
                                      separators=(",", ":")),
        card=repr(card))
    us = profile_run(lambda: tp.run(tstate, num_iter=1, verbose=False), 1,
                     "epoch", "tp-ovb-profile", focus=("tp_",))
    del tp, tstate

    # four gloo ranks on the one card beside the world of one, one seed
    t0 = time.perf_counter()
    one = tp_ovb_ranks_learner(mesh)
    _, h1 = one.run(num_iter=TP_OVB_RANKS_EPOCHS, verbose=False)
    dist.destroy_process_group()
    del one
    rwork = ooc_work("tp-ovb-ranks")
    out = os.path.join(rwork, "rank0.json")
    spawn_ranks(tp_ovb_rank_child, TP_RANKS,
                (os.path.join(rwork, "store"), out), "tp-ovb-ranks")
    with open(out) as f:
        got = json.load(f)
    missing = [k for k in TP_OVB_KERNELS if got["launches"][k] == 0]
    if missing:
        raise AssertionError(f"tp-ovb-ranks: kernels never launched: "
                             f"{missing}")
    worst = compare_traj(got["hist"], h1, ("rmse", "mae", "free_energy"),
                         TP_RTOL, "tp-ovb-ranks vs the world of one")
    say("tp-ovb-ranks", t0, ranks=TP_RANKS, backend="gloo",
        mesh="x".join(map(str, got["mesh"])), device=got["device"],
        K=TP_RANKS_K, chunks=TP_OVB_RANKS_CHUNKS, epochs=len(got["hist"]),
        sec_per_epoch=",".join(f"{h['time_learn']:.6f}"
                               for h in got["hist"]),
        rmse=",".join(f"{h['rmse']:.5f}" for h in got["hist"]),
        max_rel=f"{worst:.3e}", rtol=TP_RTOL,
        launches=json.dumps({k: got["launches"][k]
                             for k in TP_OVB_KERNELS},
                            separators=(",", ":")))
    return (l_tpo,), us


def tp_sgd_ranks_learner(mesh):
    """The [tp-sgd-ranks] recipe's feature-sharded SGD on ``mesh``: 100k
    rows of the ML-1M recipe, K = 8, batch 1024."""
    from svbfm_tpu_torch.parallel.tp_sgd import TPSGDLearner

    tr1, _, train1, test1, meta1 = ml_data(TP_RANKS_ROWS)
    return TPSGDLearner(tp_ranks_cfg(tr1, meta1), train1, test1, meta1,
                        mesh=mesh)


def mesh_scorers(mesh, task: int, batch_rows: int) -> dict:
    """[serve]'s model in a BatchScorer over ``mesh``, replicated (False)
    and feature-sharded (True)."""
    from svbfm_tpu_torch.serve import BatchScorer

    w0, w, v = serve_model()
    return {fs: BatchScorer(w0, w, v, mesh=mesh, feature_sharded=fs,
                            task=task, batch_rows=batch_rows,
                            min_target=SERVE_LO, max_target=SERVE_HI)
            for fs in (False, True)}


def tp_sgd_rank_child(rank: int, world: int, store: str, out: str) -> None:
    """One of [tp-sgd-ranks]' gloo ranks on the card.  ``world`` 4: the
    feature-sharded SGD on a (1, 4) and a (2, 2) mesh, TP_SGD_RANKS_EPOCHS
    epochs of the 100k-row recipe from the seed's init, then
    [serve-mesh]'s BatchScorer over the four ranks, replicated and
    feature-sharded, clamp and probit, on SERVE_MESH_RANK_ROWS of [serve]'s
    rows; ``world`` 2: the (2, 1) mesh.  Rank 0 writes each run's history
    and launch counts to ``out`` (JSON) and the predictions beside it
    (npz)."""
    import torch.distributed as dist

    from svbfm_tpu_torch.kernels import build
    from svbfm_tpu_torch.parallel.mesh import (distributed_init, make_mesh,
                                               make_mesh2d)

    distributed_init(init_method=f"file://{store}", world_size=world,
                     rank=rank, backend="gloo", device="cuda")
    runs = {}
    for shape in ((1, 4), (2, 2)) if world == 4 else ((2, 1),):
        tp = tp_sgd_ranks_learner(make_mesh2d(*shape, device="cuda"))
        torch.cuda.synchronize()
        build.reset_launch_counts()
        _, hist = tp.run(num_iter=TP_SGD_RANKS_EPOCHS, verbose=False)
        torch.cuda.synchronize()
        runs["x".join(map(str, shape))] = dict(
            hist=[{k: h[k] for k in ("rmse", "mae", "time_learn", "iter")}
                  for h in hist], launches=dict(build.launch_counts))
    preds = {}
    if world == 4:
        mesh = make_mesh(device="cuda")
        ids, vals = serve_rows(0, SERVE_MESH_RANK_ROWS)
        build.reset_launch_counts()
        for task in (0, 1):
            for fs, sc in mesh_scorers(mesh, task, 1 << 15).items():
                preds[f"task{task}_fs{int(fs)}"] = sc.score_rows(ids, vals)
        torch.cuda.synchronize()
        runs["serve"] = dict(launches=dict(build.launch_counts))
    if rank == 0:
        with open(out, "w") as f:
            json.dump(runs, f)
        np.savez(out + ".npz", **preds)
    dist.barrier()
    dist.destroy_process_group()


def spawn_ranks(child, nprocs: int, args: tuple, what: str) -> None:
    """``nprocs`` spawned processes running ``child(rank, *args)``; fails
    where one fails or they run past TP_RANKS_TIMEOUT."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(child, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + TP_RANKS_TIMEOUT
    try:
        while not ctx.join(timeout=max(1.0, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                raise AssertionError(f"{what}: the ranks ran past "
                                     f"{TP_RANKS_TIMEOUT} s")
    finally:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
                proc.join()


def serve_gap(got: np.ndarray, want: np.ndarray, what: str) -> float:
    """The largest |got - want| / |want|; fails past SERVE_MESH_RTOL."""
    rel = float(np.max(np.abs(got.astype(np.float64) - want)
                       / np.abs(want.astype(np.float64))))
    if not rel <= SERVE_MESH_RTOL:
        raise AssertionError(f"{what}: {rel:.3e} relative, more than "
                             f"{SERVE_MESH_RTOL}")
    return rel


def tp_sgd_phases(build, card, dev, sgd, sgd_ref, train, test, meta,
                  served, serve_e2e) -> tuple:
    """[tp-sgd] (the feature-sharded SGD on NCCL with a world of one at
    [sgd]'s width and batch, as many epochs from the same init and
    permutations, the RMSE trajectory within TP_SGD_RTOL of [sgd]'s; card
    against CPU on the 100k-row recipe; sec/epoch beside [sgd]'s),
    [tp-sgd-profile] and [tp-sgd-device] (an epoch's device time beside
    [sgd-profile]'s), [serve-mesh] (BatchScorer over the world of one at
    [serve]'s shape: replicated the same bits as [serve]'s predictions,
    feature-sharded within SERVE_MESH_RTOL; rows/s beside [serve]'s) and
    [tp-sgd-ranks] with [serve-mesh-ranks] (four gloo ranks on the card: a
    (1, 4) mesh beside the world of one, a (2, 2) beside a (2, 1) on two
    more ranks; the scorer over the four ranks, clamp and probit, beside
    the one-card scorer).  Returns the launch counts of the driven
    [tp-sgd] and [serve-mesh] runs."""
    import torch.distributed as dist

    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.models.fm import init_fm_params
    from svbfm_tpu_torch.parallel.mesh import distributed_init, make_mesh2d
    from svbfm_tpu_torch.parallel.tp_sgd import TPSGDLearner
    from svbfm_tpu_torch.serve import BatchScorer

    t0 = time.perf_counter()
    work = ooc_work("tp-sgd")
    distributed_init(init_method=f"file://{os.path.join(work, 'store')}",
                     world_size=1, rank=0, backend="nccl", device="cuda")
    mesh = make_mesh2d(device="cuda")
    tp = TPSGDLearner(sgd.cfg, train, test, meta, mesh=mesh)
    hs = sgd_ref["hist"]
    (tstate, ht), l_tps = drive(build, "tp-sgd", lambda: tp.run(
        tp.init_state(), num_iter=len(hs), verbose=False))
    check_sgd_history(ht, "tp-sgd")
    worst = compare_traj(ht, hs, ("rmse", "mae"), TP_SGD_RTOL,
                         "tp-sgd vs resident sgd")
    # card against CPU on the 100k-row recipe, one host-drawn epoch
    tr1, _, train1, test1, meta1 = ml_data(TP_RANKS_ROWS)
    cfg1 = tp_ranks_cfg(tr1, meta1)
    p1 = init_fm_params(torch.Generator().manual_seed(SEED),
                        cfg1.num_attributes, cfg1.num_factor,
                        init_stdev=cfg1.init_stdev)
    hists = []
    for m in (mesh, make_mesh2d(device="cpu")):
        lr = TPSGDLearner(cfg1, train1, test1, meta1, mesh=m)
        hists.append(lr.run(lr.state_from_params(
            p1.w0, p1.w, p1.v, host_draws(SEED, lr.device)), num_iter=1,
            verbose=False)[1])
    worst_cpu = compare_traj(*hists, ("rmse", "mae"), SGD_TRAJ_RTOL,
                             "tp-sgd gpu vs cpu")
    del lr
    say("tp-sgd", t0, backend=dist.get_backend(),
        world=dist.get_world_size(), mesh="1x1", epochs=len(ht),
        batches_per_epoch=tp.num_batches,
        sec_per_epoch=f"{statistics.median(h['time_learn'] for h in ht[1:]):.6f}",
        resident_sec_per_epoch=sgd_ref["sec"],
        rmse=",".join(f"{h['rmse']:.5f}" for h in ht), max_rel=f"{worst:.3e}",
        rtol=TP_SGD_RTOL, gpu_vs_cpu_rows=tr1.num_rows,
        gpu_vs_cpu_max_rel=f"{worst_cpu:.3e}", cpu_rtol=SGD_TRAJ_RTOL,
        launches_per_epoch=json.dumps({k: l_tps[k] // len(ht)
                                       for k in TP_SGD_KERNELS},
                                      separators=(",", ":")),
        card=repr(card))
    t0 = time.perf_counter()
    us = profile_run(lambda: tp.run(tstate, num_iter=1, verbose=False), 1,
                     "epoch", "tp-sgd-profile",
                     focus=("tp_partials", "sgd_grad_scatter",
                            "sgd_apply_dense"))
    say("tp-sgd-device", t0, device_ms_per_epoch=f"{us / 1e3:.3f}",
        resident_device_ms_per_epoch=f"{sgd_ref['us'] / 1e3:.3f}",
        ratio=f"{us / sgd_ref['us']:.3f}", card=repr(card))
    del tp, tstate

    # ---- serving over the world of one, at [serve]'s shape ------------------
    t0 = time.perf_counter()
    ids, vals = serve_rows(0, SERVE_ROWS)
    scorers = mesh_scorers(mesh, 0, SERVE_BATCH)
    warm = 2 * SERVE_BATCH  # both slots' pinned buffers, made once
    for sc in scorers.values():
        sc.score_rows(ids[:warm], vals[:warm])
    preds, rates = {}, {}

    def both():
        for fs, sc in scorers.items():
            t1 = time.perf_counter()
            preds[fs] = sc.score_rows(ids, vals)
            rates[fs] = SERVE_ROWS / (time.perf_counter() - t1)
    _, l_smesh = drive(build, "serve-mesh", both)
    if not np.array_equal(preds[False], served):
        raise AssertionError("serve-mesh: the replicated scorer's bits "
                             "differ from [serve]'s")
    gap = serve_gap(preds[True], served, "serve-mesh feature-sharded")
    del scorers, preds
    say("serve-mesh", t0, rows=SERVE_ROWS, batch_rows=SERVE_BATCH,
        backend=dist.get_backend(), world=dist.get_world_size(),
        replicated_rows_per_s=f"{rates[False]:.0f}",
        sharded_rows_per_s=f"{rates[True]:.0f}",
        serve_rows_per_s=f"{serve_e2e:.0f}", replicated_same_bits=True,
        sharded_max_rel=f"{gap:.3e}", rtol=SERVE_MESH_RTOL,
        launches=json.dumps({k: c for k, c in l_smesh.items() if c},
                            separators=(",", ":")), card=repr(card))

    # ---- several gloo ranks on the card, beside the world of one -----------
    t0 = time.perf_counter()
    one = tp_sgd_ranks_learner(mesh)
    _, h1 = one.run(num_iter=TP_SGD_RANKS_EPOCHS, verbose=False)
    del one
    sids, svals = serve_rows(0, SERVE_MESH_RANK_ROWS)
    w0, w, v = serve_model()
    want = {task: BatchScorer(w0, w, v, device=dev, task=task,
                              min_target=SERVE_LO, max_target=SERVE_HI
                              ).score_rows(sids, svals) for task in (0, 1)}
    dist.destroy_process_group()
    got, preds = {}, None
    for world in (4, 2):
        rwork = ooc_work(f"tp-sgd-ranks-{world}")
        out = os.path.join(rwork, "rank0.json")
        spawn_ranks(tp_sgd_rank_child, world, (world, os.path.join(
            rwork, "store"), out), "tp-sgd-ranks")
        with open(out) as f:
            got.update(json.load(f))
        if world == 4:
            with np.load(out + ".npz") as z:
                preds = dict(z)
    for name in ("1x4", "2x2", "2x1"):
        missing = [k for k in TP_SGD_KERNELS
                   if got[name]["launches"][k] == 0]
        if missing:
            raise AssertionError(f"tp-sgd-ranks {name}: kernels never "
                                 f"launched: {missing}")
    w14 = compare_traj(got["1x4"]["hist"], h1, ("rmse", "mae"), TP_RTOL,
                       "tp-sgd-ranks (1, 4) vs the world of one")
    w22 = compare_traj(got["2x2"]["hist"], got["2x1"]["hist"],
                       ("rmse", "mae"), TP_RTOL,
                       "tp-sgd-ranks (2, 2) vs (2, 1)")
    say("tp-sgd-ranks", t0, ranks="4+2", backend="gloo", device=str(dev),
        K=TP_RANKS_K, epochs=TP_SGD_RANKS_EPOCHS,
        **{f"sec_per_epoch_{n}": ",".join(
            f"{h['time_learn']:.6f}" for h in got[n]["hist"])
           for n in ("1x4", "2x2", "2x1")},
        rmse_1x4=",".join(f"{h['rmse']:.5f}" for h in got["1x4"]["hist"]),
        max_rel_1x4_vs_one=f"{w14:.3e}", max_rel_2x2_vs_2x1=f"{w22:.3e}",
        rtol=TP_RTOL,
        launches_1x4=json.dumps({k: got["1x4"]["launches"][k]
                                 for k in TP_SGD_KERNELS},
                                separators=(",", ":")))
    t0 = time.perf_counter()
    missing = [k for k in PATH_KERNELS["serve-mesh"]
               if got["serve"]["launches"][k] == 0]
    if missing:
        raise AssertionError(f"serve-mesh-ranks: kernels never launched: "
                             f"{missing}")
    gaps = {}
    for task in (0, 1):
        if not np.array_equal(preds[f"task{task}_fs0"], want[task]):
            raise AssertionError(f"serve-mesh-ranks task {task}: the "
                                 "replicated scorer's bits differ from the "
                                 "one-card scorer's")
        gaps[task] = serve_gap(preds[f"task{task}_fs1"], want[task],
                               f"serve-mesh-ranks task {task} sharded")
    say("serve-mesh-ranks", t0, ranks=4, backend="gloo",
        rows=SERVE_MESH_RANK_ROWS, batch_rows=1 << 15,
        replicated_same_bits=True, sharded_clamp_max_rel=f"{gaps[0]:.3e}",
        sharded_probit_max_rel=f"{gaps[1]:.3e}", rtol=SERVE_MESH_RTOL)
    return l_tps, l_smesh


def ooc_work(name: str) -> str:
    """A fresh folder under the git-ignored build/ for a phase's files."""
    repo = os.path.dirname(os.path.abspath(__file__))
    work = os.path.join(repo, "build", name)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    return work


def binary_reader(prefix: str):
    from svbfm_tpu_torch.data.stream import BinaryChunkReader

    return BinaryChunkReader(prefix + ".x", prefix + ".y")


def ooc_phases(build, card, dev, tr, te, train, test, meta, base_cfg, plan,
               ovb_ref: dict, sgd_online_sec: str) -> tuple:
    """Phases 36-40 in this process: [binary], [ovb-stream] (and its
    profile), [ovb-stream-gpu-vs-cpu], [sgd-online-stream] (and its
    GPU-vs-CPU check), [num-eval]; then [vb-windowed], [mcmc-windowed],
    [als-windowed] and [ovb-stream-10m] in a child process of their own,
    whose peak device memory is theirs alone.  Returns the launch counts
    of the driven runs."""
    from svbfm_tpu_torch.data.binary import load_coo_binary, save_coo_binary
    from svbfm_tpu_torch.data.dataset import SparseDataset
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.learners.mcmc import MCMCLearner
    from svbfm_tpu_torch.learners.sgd import SGDOnlineLearner
    from svbfm_tpu_torch.learners.vb import VBLearner, init_vb_params
    from svbfm_tpu_torch.learners.vb_online import OVBLearner, init_ovb_state
    from svbfm_tpu_torch.models.fm import init_fm_params

    def med(hist):
        return statistics.median(h["time_learn"] for h in hist[1:])

    # ---- 36. the ML-1M recipe as the reference's binary .x/.y --------------
    t0 = time.perf_counter()
    work = ooc_work("chip_smoke_ooc")
    prefix = os.path.join(work, "ml1m_train")
    w0 = time.perf_counter()
    save_coo_binary(prefix, tr)
    save_coo_binary(os.path.join(work, "ml1m_test"), te)
    write_s = time.perf_counter() - w0
    w0 = time.perf_counter()
    back = load_coo_binary(prefix)
    load_s = time.perf_counter() - w0
    w0 = time.perf_counter()
    reader = binary_reader(prefix)
    index_s = time.perf_counter() - w0
    again = SparseDataset.from_coo(back, tr.num_features)
    for k in ("ids", "vals", "target"):
        if not np.array_equal(getattr(again, k), getattr(train, k)):
            raise AssertionError(f"binary: {k} read back differs")
    if reader.num_rows != tr.num_rows or reader.num_cols != tr.num_features:
        raise AssertionError("binary: the reader's header differs")
    native = os.path.exists(os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools", "libfm_parse.so"))
    say("binary", t0, rows=tr.num_rows, nnz=tr.nnz,
        file_bytes=os.path.getsize(prefix + ".x"), write_s=f"{write_s:.3f}",
        load_s=f"{load_s:.3f}", reader_index_s=f"{index_s:.3f}",
        index_scan="native" if native else "numpy")

    # ---- 37. OVB streamed from the file, 20 chunks, 5 epochs ---------------
    t0 = time.perf_counter()
    w0 = time.perf_counter()
    so = OVBLearner.from_reader(FMConfig(num_batches=OVB_CHUNKS, **base_cfg),
                                reader, test, meta, device=dev,
                                write_files=False)
    setup_s = time.perf_counter() - w0
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (ost, hs), l_ostream = drive(build, "ovb-stream", lambda: so.run(
        so.init_state(), num_iter=5, verbose=False))
    peak = torch.cuda.max_memory_allocated() - base
    check_history(hs, "ovb-stream", ("rmse", "mae", "free_energy"), False)
    bad = {k: v for h in hs for k, v in h.items()
           if k.startswith(("nan_", "inf_")) and v}
    if bad:
        raise AssertionError(f"ovb-stream: non-finite candidates {bad}")
    say("ovb-stream", t0, epochs=len(hs), chunks=OVB_CHUNKS,
        setup_s=f"{setup_s:.3f}", sec_per_epoch=f"{med(hs):.6f}",
        in_memory_sec_per_epoch=ovb_ref["sec"],
        rmse=",".join(f"{h['rmse']:.5f}" for h in hs),
        peak_mem_over_base_bytes=peak,
        in_memory_peak_over_base_bytes=ovb_ref["peak"],
        launches=json.dumps(l_ostream, separators=(",", ":")),
        card=repr(card))
    profile_run(lambda: so.run(ost, num_iter=1, verbose=False), 1, "epoch",
                "ovb-stream-profile", focus=("Memcpy HtoD",))
    del so, ost

    # ---- 38. streamed OVB, GPU kernels vs CPU twins (100k rows) ------------
    t0 = time.perf_counter()
    tr1, _, _, test1, meta1 = ml_data(100_000)
    p1 = os.path.join(work, "ml100k_train")
    save_coo_binary(p1, tr1)
    cfg1 = FMConfig(num_attributes=tr1.num_features, num_factor=8,
                    min_target=float(tr1.target.min()),
                    max_target=float(tr1.target.max()),
                    num_groups=meta1.num_attr_groups, seed=SEED,
                    num_batches=10)
    init1 = init_ovb_state(torch.Generator().manual_seed(SEED), cfg1, "cpu")
    hists = [OVBLearner.from_reader(cfg1, binary_reader(p1), test1, meta1,
                                    device=d, write_files=False).run(
        to_device(init1, d), num_iter=2, verbose=False)[1]
        for d in (dev, "cpu")]
    worst = compare_traj(*hists, ("rmse", "mae", "free_energy"),
                         OVB_TRAJ_RTOL, "ovb-stream gpu vs cpu")
    say("ovb-stream-gpu-vs-cpu", t0, train_rows=tr1.num_rows, epochs=2,
        chunks=10, max_rel=f"{worst:.3e}", rtol=OVB_TRAJ_RTOL)

    # ---- 39. sgd_online streamed from the file, 50 chunks, 3 epochs --------
    t0 = time.perf_counter()
    scfg = FMConfig(num_batches=SGD_ONLINE_CHUNKS, **base_cfg)
    ss = SGDOnlineLearner.from_reader(scfg, reader, test, meta, device=dev,
                                      write_files=False)
    (_, hg), l_sstream = drive(build, "sgd-online-stream", lambda: ss.run(
        num_iter=3, verbose=False))
    check_sgd_history(hg, "sgd-online-stream")
    p0 = init_fm_params(torch.Generator().manual_seed(SEED), tr.num_features,
                        K, init_stdev=scfg.init_stdev)
    ends, hists = [], []
    for d in (dev, "cpu"):
        lr = SGDOnlineLearner.from_reader(scfg, reader, test, meta, device=d,
                                          write_files=False)
        st, h = lr.run(lr.state_from_params(p0.w0, p0.w, p0.v,
                                            host_draws(SEED, d)),
                       num_iter=1, verbose=False)
        ends.append(st.tab.cpu())
        hists.append(h)
    worst = compare_traj(*hists, ("rmse", "mae"), SGD_TRAJ_RTOL,
                         "sgd-online-stream gpu vs cpu")
    gap = (ends[0] - ends[1]).abs().max().item()
    if not gap <= SGD_PARAM_ATOL:
        raise AssertionError(f"sgd-online-stream gpu vs cpu: parameters "
                             f"differ by {gap:.3e}")
    say("sgd-online-stream", t0, epochs=len(hg), chunks=SGD_ONLINE_CHUNKS,
        sec_per_epoch=f"{med(hg):.6f}",
        in_memory_sec_per_epoch=sgd_online_sec,
        rmse=",".join(f"{h['rmse']:.5f}" for h in hg),
        gpu_vs_cpu_max_rel=f"{worst:.3e}", max_abs_param=f"{gap:.3e}",
        launches=json.dumps(l_sstream, separators=(",", ":")))
    del ss

    # ---- 40. -num_eval_cases: the split of the test rows -------------------
    t0 = time.perf_counter()
    N = test.num_rows
    cfg = FMConfig(factor_block=0, **base_cfg)
    params = init_vb_params(torch.Generator().manual_seed(SEED), cfg, "cpu")
    (hs_vb,), (hf_vb,) = (
        lr.run(lr.state_from_params(params), num_iter=1, verbose=False)[1]
        for lr in (VBLearner(cfg, train, test, meta, device=dev, plan=plan,
                             write_files=False, num_eval_cases=NEC),
                   VBLearner(cfg, train, test, meta, device=dev, plan=plan,
                             write_files=False)))
    g0 = init_fm_params(torch.Generator().manual_seed(SEED), tr.num_features,
                        K, init_stdev=cfg.init_stdev, init_w_normal=True)
    (hs_mc,), (hf_mc,) = (
        lr.run(lr.state_from_params(g0.w0, g0.w, g0.v,
                                    host_draws(SEED, dev)),
               num_iter=1, verbose=False)[1]
        for lr in (MCMCLearner(cfg, train, test, meta, device=dev, plan=plan,
                               write_files=False, num_eval_cases=NEC),
                   MCMCLearner(cfg, train, test, meta, device=dev, plan=plan,
                               write_files=False)))
    worst = 0.0
    for split, full, first, rest in (
            (hs_vb, hf_vb, "rmse", "rmse_test2_this"),
            (hs_mc, hf_mc, "rmse_this", "rmse_test2_this"),
            (hs_mc, hf_mc, "rmse", "rmse_test2_all")):
        lhs = NEC * split[first] ** 2 + (N - NEC) * split[rest] ** 2
        rhs = N * full[first] ** 2
        worst = max(worst, abs(lhs - rhs) / rhs)
    if not worst <= NEC_RTOL:
        raise AssertionError(f"num-eval: nec rmse^2 + (N - nec) "
                             f"rmse_test2^2 is {worst:.3e} from N rmse^2")
    say("num-eval", t0, num_eval_cases=NEC, test_rows=N,
        vb=f"{hs_vb['rmse']:.6f}/{hs_vb['rmse_test2_this']:.6f}/"
           f"{hf_vb['rmse']:.6f}",
        gibbs=f"{hs_mc['rmse_this']:.6f}/{hs_mc['rmse_test2_this']:.6f}/"
              f"{hf_mc['rmse_this']:.6f}",
        identity_max_rel=f"{worst:.3e}", rtol=NEC_RTOL)

    # ---- 41-42. [vb-windowed] and [ovb-stream-10m], a process of their own --
    runs = memory_phases_in_child(dev, prefix, os.path.join(work,
                                                            "ml1m_test"))
    shutil.rmtree(work, ignore_errors=True)
    return (l_ostream, l_sstream) + runs


def memory_phases_in_child(dev, train_prefix: str, test_prefix: str) -> tuple:
    """Run ``memory_phases`` in a child python on the same card and pass
    its lines on; returns the launch counts it reports on its last line."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo,
               CUDA_VISIBLE_DEVICES=os.environ.get("CUDA_VISIBLE_DEVICES",
                                                   str(dev.index)))
    code = ("import sys, chip_smoke; sys.exit(chip_smoke.memory_phases("
            f"{train_prefix!r}, {test_prefix!r}))")
    r = subprocess.run([sys.executable, "-c", code], cwd=repo, env=env,
                       capture_output=True, text=True, timeout=900)
    lines = r.stdout.strip().splitlines()
    print("\n".join(lines[:-1]), flush=True)
    if r.returncode != 0 or not lines:
        raise AssertionError(f"memory phases exited {r.returncode}:\n"
                             f"{r.stderr[-3000:]}")
    return tuple(json.loads(lines[-1])["launches"])


def memory_phases(train_prefix: str, test_prefix: str) -> int:
    """Phases 41-42, each with the card to itself: [vb-windowed], batch VB
    at factor_block 4 with the ML-1M rows streamed in 4 windows
    (-cache_size 8,388,608), 5 sweeps beside resident exact VB at the same
    factor_block from the same init (trajectory, sec/iter, peak memory over
    what was allocated before the learner), its profile and
    [vb-windowed-gpu-vs-cpu] (100k rows, 2 sweeps); [mcmc-windowed] and
    [als-windowed], Gibbs and ALS on the same windows, 5 iterations each
    beside the resident learner at factor_block 4 from one init and one
    host-table draw source (trajectory, peak memory, Gibbs' profile), and
    [mcmc-windowed-gpu-vs-cpu] (100k rows, 2 sweeps); then [ovb-stream-10m]:
    OVB on 10M rows of ML-10M's shape streamed in 100 chunks, 1 epoch,
    its peak beside the bytes its train rows would take resident.  The last
    line is the JSON of the driven runs' launch counts."""
    from svbfm_tpu_torch.data.binary import load_coo_binary, save_coo_binary
    from svbfm_tpu_torch.data.dataset import SparseDataset, SweepPlan
    from svbfm_tpu_torch.data.meta import DataMetaInfo
    from svbfm_tpu_torch.data.synth import make_movielens_like, train_test_split
    from svbfm_tpu_torch.kernels import build
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.learners.mcmc import ALSLearner, MCMCLearner
    from svbfm_tpu_torch.learners.mcmc_windowed import (WindowedALSLearner,
                                                        WindowedMCMCLearner)
    from svbfm_tpu_torch.learners.vb import VBLearner, init_vb_params
    from svbfm_tpu_torch.learners.vb_online import OVBLearner
    from svbfm_tpu_torch.learners.vb_windowed import WindowedVBLearner
    from svbfm_tpu_torch.models.fm import init_fm_params

    dev = torch.device("cuda", torch.cuda.current_device())
    build.build_all()
    card = card_line()

    def med(hist):
        return statistics.median(h["time_learn"] for h in hist[1:])

    # ---- 41. batch VB windowed, 4 windows, factor_block 4 -------------------
    t0 = time.perf_counter()
    reader = binary_reader(train_prefix)
    te = load_coo_binary(test_prefix)
    D = reader.num_cols
    meta = DataMetaInfo.from_field_offsets(D, [0, NUM_USERS])
    test = SparseDataset.from_coo(te, D)
    cfg = FMConfig(num_attributes=D, num_factor=K, factor_block=4,
                   min_target=float(reader.targets.min()),
                   max_target=float(reader.targets.max()),
                   num_groups=meta.num_attr_groups, seed=SEED)
    params = init_vb_params(torch.Generator().manual_seed(SEED), cfg, "cpu")
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    w0 = time.perf_counter()
    win = WindowedVBLearner(cfg, reader, test, meta, device=dev,
                            cache_bytes=WIN_CACHE_BYTES, write_files=False)
    setup_s = time.perf_counter() - w0
    if (win.num_windows, win.wlen) != WIN_SHAPE:
        raise AssertionError(f"vb-windowed: {win.num_windows} windows of "
                             f"{win.wlen} rows, not {WIN_SHAPE}")
    (wst, hw), l_win = drive(build, "vb-windowed", lambda: win.run(
        win.state_from_params(params), num_iter=5, verbose=False, chunk=1))
    wpeak = torch.cuda.max_memory_allocated() - base
    check_history(hw, "vb-windowed", ("rmse", "mae", "train_rmse",
                                      "free_energy", "alpha"), True)
    w_dev_us = profile_run(lambda: win.run(wst, num_iter=1, verbose=False),
                           1, "sweep", "vb-windowed-profile",
                           focus=("col_stats", "w_bin_win_kernel",
                                  "Memcpy HtoD"))
    del win, wst
    # resident exact VB at the same factor_block, from the same init
    train = SparseDataset.from_coo(load_coo_binary(train_prefix), D)
    rplan = SweepPlan.build(train.to_coo(), D, meta_groups=meta.attr_group)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res = VBLearner(cfg, train, test, meta, device=dev, plan=rplan,
                    write_files=False)
    _, hr = res.run(res.state_from_params(params), num_iter=5, verbose=False,
                    chunk=1)
    rpeak = torch.cuda.max_memory_allocated() - base
    del res
    worst = compare_traj(hw, hr, ("rmse", "train_rmse", "free_energy"),
                         WIN_TRAJ_RTOL, "vb-windowed vs resident")
    if not wpeak < rpeak:
        raise AssertionError(f"vb-windowed: peak {wpeak} not below the "
                             f"resident learner's {rpeak}")
    say("vb-windowed", t0, sweeps=len(hw), windows=WIN_SHAPE[0],
        window_rows=WIN_SHAPE[1], cache_bytes=WIN_CACHE_BYTES,
        setup_s=f"{setup_s:.3f}", sec_per_iter=f"{med(hw):.6f}",
        device_ms_per_iter=f"{w_dev_us / 1e3:.3f}",
        resident_sec_per_iter=f"{med(hr):.6f}",
        rmse=",".join(f"{h['rmse']:.5f}" for h in hw),
        vs_resident_max_rel=f"{worst:.3e}", rtol=WIN_TRAJ_RTOL,
        peak_mem_over_base_bytes=wpeak,
        resident_peak_mem_over_base_bytes=rpeak,
        launches=json.dumps(l_win, separators=(",", ":")), card=repr(card))

    # ---- 41b. Gibbs and ALS windowed, the same 4 windows, factor_block 4 ----
    g0 = init_fm_params(torch.Generator().manual_seed(SEED), D, K,
                        init_stdev=cfg.init_stdev, init_w_normal=True)
    als_cfg = dataclasses.replace(cfg, reg0=ALS_REG, regw=ALS_REG,
                                  regv=ALS_REG)
    l_mwin = {}
    for path, wcls, rcls, mcfg, key in (
            ("mcmc-windowed", WindowedMCMCLearner, MCMCLearner, cfg, "rmse"),
            ("als-windowed", WindowedALSLearner, ALSLearner, als_cfg,
             "rmse_this")):
        t0 = time.perf_counter()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        w0 = time.perf_counter()
        mw = wcls(mcfg, reader, test, meta, device=dev,
                  cache_bytes=WIN_CACHE_BYTES, write_files=False)
        setup_s = time.perf_counter() - w0
        if (mw.num_windows, mw.wlen, mw.F) != WIN_SHAPE + (4,):
            raise AssertionError(f"{path}: {mw.num_windows} windows of "
                                 f"{mw.wlen} rows at F = {mw.F}")
        (mst, hw), l_mwin[path] = drive(build, path, lambda: mw.run(
            mw.state_from_params(g0.w0, g0.w, g0.v, host_draws(SEED, dev)),
            num_iter=5, verbose=False, chunk=1))
        wpeak = torch.cuda.max_memory_allocated() - base
        check_mcmc_history(hw, path, key)
        prof = {}
        if path == "mcmc-windowed":
            m_dev_us = profile_run(
                lambda: mw.run(mst, num_iter=1, verbose=False), 1, "sweep",
                "mcmc-windowed-profile",
                focus=("col_draw_win", "w_bin_win_kernel", "Memcpy HtoD"))
            prof = dict(device_ms_per_iter=f"{m_dev_us / 1e3:.3f}")
        del mw, mst
        # the resident learner at the same factor_block, init and draws
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        res = rcls(mcfg, train, test, meta, device=dev, plan=rplan,
                   write_files=False)
        _, hr = res.run(res.state_from_params(g0.w0, g0.w, g0.v,
                                              host_draws(SEED, dev)),
                        num_iter=5, verbose=False, chunk=1)
        rpeak = torch.cuda.max_memory_allocated() - base
        del res
        worst = compare_traj(hw, hr, ("rmse", "rmse_this"),
                             MWIN_TRAJ_RTOL, f"{path} vs resident")
        worst_a = compare_traj(hw, hr, ("alpha",), MWIN_ALPHA_RTOL,
                               f"{path} vs resident")
        if not wpeak < rpeak:
            raise AssertionError(f"{path}: peak {wpeak} not below the "
                                 f"resident learner's {rpeak}")
        per = {k: v // len(hw) for k, v in l_mwin[path].items() if v}
        say(path, t0, iterations=len(hw), windows=WIN_SHAPE[0],
            window_rows=WIN_SHAPE[1], factor_block=4,
            setup_s=f"{setup_s:.3f}", sec_per_iter=f"{med(hw):.6f}", **prof,
            resident_sec_per_iter=f"{med(hr):.6f}",
            **{key: ",".join(f"{h[key]:.5f}" for h in hw)},
            vs_resident_max_rel=f"{worst:.3e}", rtol=MWIN_TRAJ_RTOL,
            alpha_max_rel=f"{worst_a:.3e}",
            peak_mem_over_base_bytes=wpeak,
            resident_peak_mem_over_base_bytes=rpeak,
            launches_per_iter=json.dumps(per, separators=(",", ":")),
            card=repr(card))
    del train, rplan

    # ---- 41c. windowed, GPU kernels vs CPU twins (100k rows) ---------------
    t0 = time.perf_counter()
    tr1, _, _, test1, meta1 = ml_data(100_000)
    work = ooc_work("chip_smoke_memory")
    p1 = os.path.join(work, "ml100k_train")
    save_coo_binary(p1, tr1)
    cfg1 = FMConfig(num_attributes=tr1.num_features, num_factor=8,
                    factor_block=2, min_target=float(tr1.target.min()),
                    max_target=float(tr1.target.max()),
                    num_groups=meta1.num_attr_groups, seed=SEED)
    prm1 = init_vb_params(torch.Generator().manual_seed(SEED), cfg1, "cpu")
    hists = []
    for d in (dev, "cpu"):
        lr = WindowedVBLearner(cfg1, binary_reader(p1), test1, meta1,
                               device=d, num_windows=4, write_files=False)
        hists.append(lr.run(lr.state_from_params(prm1), num_iter=2,
                            verbose=False)[1])
    worst = compare_traj(*hists, ("rmse", "train_rmse", "free_energy"),
                         TRAJ_RTOL, "vb-windowed gpu vs cpu")
    say("vb-windowed-gpu-vs-cpu", t0, train_rows=tr1.num_rows, windows=4,
        sweeps=2, max_rel=f"{worst:.3e}", rtol=TRAJ_RTOL)

    # ---- 41d. windowed Gibbs, GPU kernels vs CPU twins (100k rows) ---------
    t0 = time.perf_counter()
    cfgm = dataclasses.replace(cfg1, factor_block=2)
    gm = init_fm_params(torch.Generator().manual_seed(SEED),
                        tr1.num_features, cfgm.num_factor,
                        init_stdev=cfgm.init_stdev, init_w_normal=True)
    hists = []
    for d in (dev, "cpu"):
        lr = WindowedMCMCLearner(cfgm, binary_reader(p1), test1, meta1,
                                 device=d, num_windows=4, write_files=False)
        hists.append(lr.run(lr.state_from_params(gm.w0, gm.w, gm.v,
                                                 host_draws(SEED, d)),
                            num_iter=2, verbose=False)[1])
    worst = compare_traj(*hists, ("rmse", "rmse_this", "mae", "alpha"),
                         TRAJ_RTOL, "mcmc-windowed gpu vs cpu")
    say("mcmc-windowed-gpu-vs-cpu", t0, train_rows=tr1.num_rows, windows=4,
        sweeps=2, max_rel=f"{worst:.3e}", rtol=TRAJ_RTOL)

    # ---- 42. OVB on 10M rows of ML-10M's shape, 100 chunks, 1 epoch ---------
    t0 = time.perf_counter()
    w0 = time.perf_counter()
    users, items, rows = ML10M_SHAPE
    coo = make_movielens_like(users, items, rows + rows // 100, rank=8,
                              noise=0.6, seed=SEED)
    tr10, te10 = train_test_split(coo, 1.0 / 101.0, seed=SEED + 1)
    del coo
    gen_s = time.perf_counter() - w0
    p10 = os.path.join(work, "ml10m_train")
    w0 = time.perf_counter()
    save_coo_binary(p10, tr10)
    write_s = time.perf_counter() - w0
    D10 = tr10.num_features
    del tr10
    w0 = time.perf_counter()
    reader10 = binary_reader(p10)
    index_s = time.perf_counter() - w0
    P = int(reader10.row_sizes.max())
    resident = reader10.num_rows * (8 * P + 4)
    meta10 = DataMetaInfo.from_field_offsets(D10, [0, users])
    cfg10 = FMConfig(num_attributes=D10, num_factor=K,
                     min_target=float(reader10.targets.min()),
                     max_target=float(reader10.targets.max()),
                     num_groups=meta10.num_attr_groups, seed=SEED,
                     num_batches=STREAM_10M_CHUNKS)
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    w0 = time.perf_counter()
    o10 = OVBLearner.from_reader(cfg10, reader10,
                                 SparseDataset.from_coo(te10, D10), meta10,
                                 device=dev, write_files=False)
    setup_s = time.perf_counter() - w0
    (_, h10), l_10m = drive(build, "ovb-stream-10m", lambda: o10.run(
        o10.init_state(), num_iter=1, verbose=False))
    peak = torch.cuda.max_memory_allocated() - base
    h = h10[0]
    if not (np.isfinite(h["rmse"]) and np.isfinite(h["free_energy"])
            and h["rmse"] < 1.5):
        raise AssertionError(f"ovb-stream-10m: epoch metrics {h}")
    if not peak < resident:
        raise AssertionError(f"ovb-stream-10m: peak {peak} not below the "
                             f"resident rows' {resident}")
    say("ovb-stream-10m", t0, train_rows=reader10.num_rows,
        test_rows=te10.num_rows, features=D10, chunks=STREAM_10M_CHUNKS,
        generate_s=f"{gen_s:.3f}", write_s=f"{write_s:.3f}",
        reader_index_s=f"{index_s:.3f}", setup_s=f"{setup_s:.3f}",
        sec_per_epoch=f"{h['time_learn']:.6f}", rmse=f"{h['rmse']:.5f}",
        peak_mem_over_base_bytes=peak, resident_row_bytes=resident,
        peak_below_resident=peak < resident,
        launches=json.dumps(l_10m, separators=(",", ":")), card=repr(card))
    del o10, reader10
    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps({"launches": [l_win, l_10m, *l_mwin.values()]}),
          flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this check needs an NVIDIA GPU")
    t0 = time.perf_counter()
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(card, flush=True)
    say("card", t0, kind=repr(kind), count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)

    from svbfm_tpu_torch.data.dataset import SweepPlan
    from svbfm_tpu_torch.kernels import build
    from svbfm_tpu_torch.data.dataset import SparseDataset
    from svbfm_tpu_torch.data.synth import train_test_split
    from svbfm_tpu_torch.learners.base import FMConfig
    from svbfm_tpu_torch.learners.bpr import BPRLearner
    from svbfm_tpu_torch.learners.draws import host_draws
    from svbfm_tpu_torch.learners.exp_sgd import (ExpSGDLearner,
                                                  ExpSGDStocLearner)
    from svbfm_tpu_torch.learners.sgd import (SGDALearner, SGDLearner,
                                              SGDOnlineLearner)
    from svbfm_tpu_torch.learners.mcmc import ALSLearner, MCMCLearner
    from svbfm_tpu_torch.learners.vb import VBLearner, init_vb_params
    from svbfm_tpu_torch.learners.vb_online import OVBLearner, init_ovb_state
    from svbfm_tpu_torch.learners.vb_windowed import WindowedVBLearner
    from svbfm_tpu_torch.learners.mcmc_windowed import WindowedMCMCLearner
    from svbfm_tpu_torch.models.fm import init_fm_params

    # ---- 1. build --------------------------------------------------------
    t0 = time.perf_counter()
    secs = build.build_all()
    for name, log in build.build_logs.items():
        fn = "?"
        for line in log.splitlines():
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                print(f"  ptxas {name} {fn}: {line.strip()}")
    say("build", t0, libraries=len(build.LIBRARIES), build_s=f"{secs:.2f}")

    # ---- data (bench.py's recipe) ------------------------------------------
    t0 = time.perf_counter()
    tr, te, train, test, meta = ml_data(NUM_TRAIN)
    D = tr.num_features
    base_cfg = dict(num_attributes=D, num_factor=K,
                    min_target=float(tr.target.min()),
                    max_target=float(tr.target.max()),
                    num_groups=meta.num_attr_groups, seed=SEED)
    cfg = FMConfig(factor_block=0, **base_cfg)
    plan = SweepPlan.build(tr, D, meta_groups=meta.attr_group)
    learner = VBLearner(cfg, train, test, meta, device=dev, plan=plan,
                        write_files=False)
    ovb = OVBLearner(FMConfig(num_batches=OVB_CHUNKS, **base_cfg), train,
                     test, meta, device=dev, write_files=False)
    gibbs = MCMCLearner(cfg, train, test, meta, device=dev, plan=plan,
                        write_files=False)
    sgd = SGDLearner(cfg, train, test, meta, device=dev, write_files=False)
    exp_sgd = ExpSGDStocLearner(cfg, train, test, meta, device=dev,
                                write_files=False)
    tr90, va10 = (SparseDataset.from_coo(c, D)
                  for c in train_test_split(tr, 0.1, seed=SEED))
    sgda = SGDALearner(FMConfig(learn_rate=SGDA_LR, **base_cfg), tr90, test,
                       va10, meta, device=dev, write_files=False)
    bpr = BPRLearner(FMConfig(learn_rate=BPR_LR, **base_cfg),
                     SparseDataset.from_coo(positives(tr), D),
                     SparseDataset.from_coo(positives(te), D), meta,
                     device=dev, write_files=False)
    exp_full = ExpSGDLearner(FMConfig(learn_rate=EXP_SGD_LR, **base_cfg),
                             train, test, meta, device=dev,
                             write_files=False)
    bsp = bs_problem(BS_ROWS, BS_SLOTS, holdout=False)
    bs_mcmc = bs_learner(bsp, dev, num_factor=K, regw=BS_REG, regv=BS_REG)
    shapes = [[tuple(b.rows.shape[1:]) for b in bb] for bb in plan.blocks]
    cshapes = [[tuple(b.rows.shape) for b in p.buckets]
               for p in ovb.chunks[0][1]]
    say("data", t0, train_rows=tr.num_rows, test_rows=te.num_rows,
        features=D, buckets=str(shapes).replace(" ", ""),
        ovb_chunk_rows=int(ovb.chunk_sizes[0]),
        ovb_chunk0_buckets=str(cshapes).replace(" ", ""),
        sgd_batches=sgd.num_batches,
        sgda_train_val_rows=f"{sgda.train_n}/{sgda.val_n}",
        bpr_positive_rows=f"{bpr.train_n}/{bpr.test_n}",
        bpr_batches=bpr.num_batches, bs_rows=bs_mcmc.train_n,
        bs_relation_rows="/".join(str(r.num_rows) for r in bs_mcmc.rstats),
        bs_relation_bins="/".join(str(len(rd.rplan)) for rd in bs_mcmc.rels),
        bs_join_buckets="/".join(str(len(rd.jplan)) for rd in bs_mcmc.rels))

    # ---- 2. each kernel against its twin -----------------------------------
    t0 = time.perf_counter()
    gen = torch.Generator().manual_seed(SEED)
    vb0 = learner.state_from_params(init_vb_params(gen, cfg, dev))
    ovb0 = ovb.init_state()
    mc1, _ = gibbs.step(gibbs.init_state())
    bs1, _ = bs_mcmc.step(bs_mcmc.init_state())
    wcfg = FMConfig(factor_block=4, **base_cfg)
    win = WindowedVBLearner(wcfg, train, test, meta, device=dev,
                            cache_bytes=WIN_CACHE_BYTES, write_files=False)
    win0 = win.state_from_params(init_vb_params(
        torch.Generator().manual_seed(SEED), wcfg, dev))
    mwin = WindowedMCMCLearner(wcfg, train, test, meta, device=dev,
                               cache_bytes=WIN_CACHE_BYTES,
                               write_files=False)
    mwin1, _ = mwin.step(mwin.init_state())
    report = merge_reports(
        check_cases(fast_tensors(learner, vb0), timed=True),
        check_cases(ovb_tensors(ovb, ovb0), timed=True),
        check_cases(mcmc_tensors(gibbs, mc1), timed=True),
        check_cases(resident4_tensors(gibbs, mc1, learner, vb0), timed=True),
        check_cases(dict(tag="probe", gathers=gather_sets(dev)), timed=True),
        check_cases(sgd_tensors(sgd, exp_sgd, sgda, bpr, dev), timed=True),
        check_cases(exp_sgd_tensors(exp_full, exp_full.init_state()),
                    timed=True),
        check_cases(probit_tensors(gibbs, mc1), timed=True),
        check_cases(serve_tensors(dev), timed=True),
        check_cases(bs_tensors(bs_mcmc, bs1, "bs", True, (K, 0, 1),
                               agg_widths=(BS_AGG_BLOCK_F,),
                               agg_checks=BS_AGG_CHECK_F), timed=True),
        check_cases(win_tensors(win, win0, "vb-windowed"), timed=True),
        check_cases(mwin_tensors(mwin, mwin1, "mcmc-windowed"), timed=True),
        check_cases(tp_tensors(learner, vb0), timed=True),
        check_cases(dp_tensors(learner, vb0, gibbs, mc1), timed=True),
        check_cases(tp_ovb_tensors(ovb, ovb0), timed=True),
        check_cases(dp_ovb_tensors(ovb, ovb0), timed=True),
        check_cases(dp_join_tensors(bs_mcmc, bs1), timed=False),
        check_cases(tp_sgd_path_tensors(sgd, exp_sgd, dev), timed=True),
        *(check_cases(s, timed=False) for s in ragged_tensors(dev)))
    del mc1, bs1, win, win0, mwin, mwin1
    missing = sorted(set(SOURCES) - set(report))
    if missing:
        raise AssertionError(f"kernels with no case: {missing}")
    # the launch floor: what a kernel that does nothing costs in a graph
    # replay (a reference for the latency-bound kernels, not a kernel)
    one = torch.zeros(1, device=dev)
    print(f"  launch floor: ms={cuda_ms(one.zero_, 20):.4f} (graph replay "
          "of a one-element zero_())", flush=True)
    print_report(report)
    say("kernels", t0, compared=len(report), tol=KERNEL_TOL)
    t0 = time.perf_counter()
    say("x9b-digest", t0, **x9b_digests(dev))

    # ---- 2b. the serving path: BatchScorer on K1a's serve epilogue ----------
    l_serve, served, serve_e2e = serve_phase(build, card, dev)

    # ---- 3. batch VB, fast mode, on the card ---------------------------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    (state, hist), l_fast = drive(build, "vb-fast", lambda: learner.run(
        learner.init_state(), num_iter=10, verbose=False, chunk=1))
    peak = torch.cuda.max_memory_allocated()
    check_history(hist, "vb-fast", ("rmse", "mae", "train_rmse",
                                    "free_energy", "alpha"), True)
    sec_iter = statistics.median(h["time_learn"] for h in hist[1:10])
    say("vb-fast", t0, sweeps=len(hist), sec_per_iter=f"{sec_iter:.6f}",
        rmse_first=f"{hist[0]['rmse']:.6f}", rmse_last=f"{hist[-1]['rmse']:.6f}",
        fe_last=f"{hist[-1]['free_energy']:.2f}", peak_mem_bytes=peak,
        launches=json.dumps(l_fast, separators=(",", ":")), card=repr(card))

    # ---- 4. GPU kernels vs CPU twins, full size ------------------------------
    t0 = time.perf_counter()
    params = init_vb_params(torch.Generator().manual_seed(SEED), cfg, "cpu")
    cpu = VBLearner(cfg, train, test, meta, device="cpu", plan=plan,
                    write_files=False)
    _, hg = learner.run(learner.state_from_params(params), num_iter=3,
                        verbose=False)
    _, hc = cpu.run(cpu.state_from_params(params), num_iter=3, verbose=False)
    worst = compare_traj(hg, hc, ("rmse", "train_rmse", "free_energy"),
                         TRAJ_RTOL, "vb gpu vs cpu")
    say("gpu-vs-cpu", t0, sweeps=3, max_rel=f"{worst:.3e}", rtol=TRAJ_RTOL)

    # ---- 5. quality after 30 sweeps (information) --------------------------
    t0 = time.perf_counter()
    state, h30 = learner.run(state, num_iter=20, verbose=False)
    say("quality", t0, sweeps=30, test_rmse=f"{h30[-1]['rmse']:.5f}",
        free_energy=f"{h30[-1]['free_energy']:.1f}",
        jax_tpu_record=f"{JAX_RMSE_30}/{JAX_FE_30}")

    # ---- 6. where a fast-mode sweep's device time goes -----------------------
    learner.run(state, num_iter=1, verbose=False)
    profile_run(lambda: learner.run(state, num_iter=5, verbose=False), 5,
                "sweep", "profile")

    # ---- 7. batch VB, exact mode (factor_block=1) ----------------------------
    t0 = time.perf_counter()
    exact = VBLearner(FMConfig(factor_block=1, **base_cfg), train, test, meta,
                      device=dev, plan=plan, write_files=False)
    torch.cuda.reset_peak_memory_stats()
    (xstate, hx), l_exact = drive(build, "vb-exact", lambda: exact.run(
        exact.init_state(), num_iter=5, verbose=False, chunk=1))
    check_history(hx, "vb-exact", ("rmse", "mae", "train_rmse",
                                   "free_energy", "alpha"), True)
    peak = torch.cuda.max_memory_allocated()
    # one more sweep under the profiler: its device time, where K4 at F = 1
    # (40 launches a sweep) shows end to end
    x_dev_us = profile_run(lambda: exact.run(xstate, num_iter=1,
                                             verbose=False),
                           1, "sweep", "vb-exact-profile")
    say("vb-exact", t0, sweeps=len(hx),
        sec_per_iter=f"{statistics.median(h['time_learn'] for h in hx[1:]):.6f}",
        device_ms_per_iter=f"{x_dev_us / 1e3:.3f}",
        rmse_first=f"{hx[0]['rmse']:.6f}", rmse_last=f"{hx[-1]['rmse']:.6f}",
        fe_last=f"{hx[-1]['free_energy']:.2f}", peak_mem_bytes=peak,
        launches=json.dumps(l_exact, separators=(",", ":")))

    # ---- 8. exact mode, GPU kernels vs CPU twins, full size -----------------
    t0 = time.perf_counter()
    xcfg = FMConfig(factor_block=1, **base_cfg)
    params = init_vb_params(torch.Generator().manual_seed(SEED), xcfg, "cpu")
    cpu = VBLearner(xcfg, train, test, meta, device="cpu", plan=plan,
                    write_files=False)
    _, hg = exact.run(exact.state_from_params(params), num_iter=2,
                      verbose=False)
    _, hc = cpu.run(cpu.state_from_params(params), num_iter=2, verbose=False)
    worst = compare_traj(hg, hc, ("rmse", "train_rmse", "free_energy"),
                         TRAJ_RTOL, "vb-exact gpu vs cpu")
    say("vb-exact-gpu-vs-cpu", t0, sweeps=2, max_rel=f"{worst:.3e}",
        rtol=TRAJ_RTOL)
    del cpu

    # ---- 8b. the feature-sharded batch VB (T1-T4) ----------------------------
    l_tp, l_tp0 = tp_phases(build, card, dev, train, test, meta, base_cfg,
                            plan)
    # ---- 8c. the feature-sharded Gibbs and ALS (T5-T8) ----------------------
    l_tpm = tp_mcmc_phases(build, card, dev, train, test, meta, base_cfg,
                           plan)
    # ---- 8d. the data-parallel replicated VB, Gibbs and ALS ----------------
    l_dp = dp_phases(build, card, dev, train, test, meta, base_cfg, plan)

    # ---- 9. online VB, 20 chunks of fixed membership -------------------------
    t0 = time.perf_counter()
    ovb_base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    (ostate, ho), l_ovb = drive(build, "ovb", lambda: ovb.run(
        ovb.init_state(), num_iter=5, verbose=False))
    check_history(ho, "ovb", ("rmse", "mae", "free_energy"), False)
    bad = {k: v for h in ho for k, v in h.items()
           if k.startswith(("nan_", "inf_")) and v}
    if bad:
        raise AssertionError(f"ovb: non-finite candidates {bad}")
    # the in-memory learner's chunks stay on the card from its construction
    chunk_bytes = sum(
        t.numel() * t.element_size() for row, bins in ovb.chunks
        for t in [row.ids, row.vals, row.target, row.valid] + [
            getattr(b, f.name) for p in bins for b in p.buckets
            for f in dataclasses.fields(b)])
    ovb_ref = dict(
        sec=f"{statistics.median(h['time_learn'] for h in ho[1:]):.6f}",
        peak=torch.cuda.max_memory_allocated() - ovb_base + chunk_bytes)
    say("ovb", t0, epochs=len(ho), chunks=OVB_CHUNKS,
        sec_per_epoch=f"{statistics.median(h['time_learn'] for h in ho[1:]):.6f}",
        rmse=",".join(f"{h['rmse']:.5f}" for h in ho),
        fe_last=f"{ho[-1]['free_energy']:.2f}",
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        launches=json.dumps(l_ovb, separators=(",", ":")))

    # ---- 9b. the feature-sharded online VB (T9, T10 with T1, T2, T4) -------
    l_tpo, tpo_us = tp_ovb_phases(build, card, dev, train, test, meta,
                                  base_cfg, ho, ostate, ovb_ref["sec"])

    # ---- 10. online VB, GPU kernels vs CPU twins (100k-row recipe) -----------
    t0 = time.perf_counter()
    tr1, _, train1, test1, meta1 = ml_data(100_000)
    cfg1 = FMConfig(num_attributes=tr1.num_features, num_factor=8,
                    min_target=float(tr1.target.min()),
                    max_target=float(tr1.target.max()),
                    num_groups=meta1.num_attr_groups, seed=SEED,
                    num_batches=10)
    init1 = init_ovb_state(torch.Generator().manual_seed(SEED), cfg1, "cpu")
    hists = []
    for d in (dev, "cpu"):
        lr = OVBLearner(cfg1, train1, test1, meta1, device=d,
                        write_files=False)
        hists.append(lr.run(to_device(init1, d), num_iter=2,
                            verbose=False)[1])
    worst = compare_traj(*hists, ("rmse", "mae", "free_energy"),
                         OVB_TRAJ_RTOL, "ovb gpu vs cpu")
    say("ovb-gpu-vs-cpu", t0, train_rows=tr1.num_rows, epochs=2, chunks=10,
        max_rel=f"{worst:.3e}", rtol=OVB_TRAJ_RTOL)

    # ---- 11. online VB quality, -reshuffle 1 (information) ------------------
    t0 = time.perf_counter()
    qual = OVBLearner(FMConfig(num_batches=OVB_CHUNKS, reshuffle=True,
                               **base_cfg), train, test, meta, device=dev,
                      write_files=False)
    _, hq = qual.run(num_iter=OVB_QUALITY_EPOCHS, verbose=False)
    check_history(hq, "ovb-quality", ("rmse", "mae", "free_energy"), False)
    say("ovb-quality", t0, epochs=len(hq),
        sec_per_epoch=f"{statistics.median(h['time_learn'] for h in hq[1:]):.6f}",
        **{f"test_rmse_epoch{e}": f"{hq[e - 1]['rmse']:.5f}"
           for e in REF_OVB_RMSE if e <= OVB_QUALITY_EPOCHS},
        reference_cpp=",".join(f"{e}:{v}" for e, v in REF_OVB_RMSE.items()))

    # ---- 12. the port's CLI -------------------------------------------------
    # (and out of core: binary files streamed, -cache_size,
    # -num_eval_cases)
    # (-rlog, -profile and -map_eval ride on three of the runs)
    run_clis(dev.index, [
        ("vb_online", ["-batch", "5", "-rlog", "log.tsv"],
         ("free_energy_118_vb_online", "log.tsv"), dict(aux="rlog")),
        ("sgd", ["-learn_rate", "0.05", "-profile", "prof"],
         ("prof/trace.json",), dict(aux="profile")),
        ("exp_sgd", ["-learn_rate", str(EXP_SGD_LR)], (), {}),
        ("als", ["-regular", "1"], (), dict(relation=True)),
        ("mcmc", ["-map_eval", "fix.txt", "-map_k", "5"], (),
         dict(task="c", aux="map_eval")),
        ("sgd", ["-learn_rate", "0.05"], (), dict(task="c")),
        ("vb_online", ["-batch", "5"], ("free_energy_118_vb_online",),
         dict(binary=True)),
        ("sgd_online", ["-batch", "5", "-learn_rate", "0.05"], (),
         dict(binary=True)),
        ("vb", ["-cache_size", "40000"], ("free_energy_118_vb",),
         dict(binary=True)),
        ("mcmc", ["-cache_size", "40000"], (), dict(binary=True)),
        ("als", ["-cache_size", "40000", "-regular", "1"], (),
         dict(binary=True)),
        ("mcmc", ["-num_eval_cases", "500"], (), {})])

    # ---- 13. where an online-VB epoch's device time goes --------------------
    t0 = time.perf_counter()
    res_us = profile_run(lambda: ovb.run(ostate, num_iter=1, verbose=False),
                         1, "epoch", "ovb-profile", focus=("w_bin_kernel",))
    say("tp-ovb-device", t0, device_ms_per_epoch=f"{tpo_us / 1e3:.3f}",
        resident_device_ms_per_epoch=f"{res_us / 1e3:.3f}",
        ratio=f"{tpo_us / res_us:.3f}", card=repr(card))

    # ---- 14. Gibbs MCMC, factor_block=0 (F = K), on the card --------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    (mstate, hm), l_mcmc = drive(build, "mcmc", lambda: gibbs.run(
        gibbs.init_state(), num_iter=10, verbose=False, chunk=1))
    peak = torch.cuda.max_memory_allocated()
    check_mcmc_history(hm, "mcmc", "rmse")
    mstate, split = enqueue_then_wait(lambda st: gibbs.step(st)[0], mstate)
    say("mcmc", t0, iterations=len(hm),
        sec_per_iter=f"{statistics.median(h['time_learn'] for h in hm[1:]):.6f}",
        ms_per_iter=",".join(f"{1e3 * h['time_learn']:.3f}" for h in hm),
        enqueue_then_wait_ms=split,
        rmse=",".join(f"{h['rmse']:.5f}" for h in hm),
        rmse_this_last=f"{hm[-1]['rmse_this']:.5f}",
        alpha_last=f"{hm[-1]['alpha']:.4f}", peak_mem_bytes=peak,
        launches=json.dumps(l_mcmc, separators=(",", ":")), card=repr(card))

    # ---- 15. Gibbs, GPU kernels vs CPU twins, full size ---------------------
    t0 = time.perf_counter()
    p0 = init_fm_params(torch.Generator().manual_seed(SEED), D, K,
                        init_stdev=cfg.init_stdev, init_w_normal=True)
    cpu = MCMCLearner(cfg, train, test, meta, device="cpu", plan=plan,
                      write_files=False)
    hists = [lr.run(lr.state_from_params(p0.w0, p0.w, p0.v,
                                         host_draws(SEED, lr.device)),
                    num_iter=2, verbose=False)[1] for lr in (gibbs, cpu)]
    worst = compare_traj(*hists, ("rmse", "rmse_this", "mae", "alpha"),
                         TRAJ_RTOL, "mcmc gpu vs cpu")
    say("mcmc-gpu-vs-cpu", t0, sweeps=2, max_rel=f"{worst:.3e}",
        rtol=TRAJ_RTOL)
    del cpu

    # ---- 16. ALS at factor_block 1 and 0; card vs CPU at F = 1 --------------
    als_cfg = dict(base_cfg, reg0=ALS_REG, regw=ALS_REG, regv=ALS_REG)
    l_als = []
    for fb in (1, 0):
        t0 = time.perf_counter()
        al = ALSLearner(FMConfig(factor_block=fb, **als_cfg), train, test,
                        meta, device=dev, plan=plan, write_files=False)
        (_, ha), la = drive(build, "als", lambda: al.run(
            al.init_state(), num_iter=5, verbose=False, chunk=1))
        check_mcmc_history(ha, f"als factor_block={fb}", "rmse_this")
        l_als.append(la)
        say(f"als-fb{fb}", t0, iterations=len(ha),
            sec_per_iter=f"{statistics.median(h['time_learn'] for h in ha[1:]):.6f}",
            rmse_this=",".join(f"{h['rmse_this']:.5f}" for h in ha),
            launches=json.dumps(la, separators=(",", ":")))
    # ---- 16b. where a factor-sequential Gibbs sweep's device time goes ------
    seq = MCMCLearner(FMConfig(factor_block=1, **base_cfg), train, test,
                      meta, device=dev, plan=plan, write_files=False)
    sstate, _ = seq.run(num_iter=1, verbose=False)
    profile_run(lambda: seq.run(sstate, num_iter=1, verbose=False), 1,
                "sweep", "mcmc-seq-profile", focus=MCMC_FOCUS)
    del seq, sstate

    t0 = time.perf_counter()
    hists = []
    for d in (dev, "cpu"):
        lr = ALSLearner(FMConfig(factor_block=1, **als_cfg), train, test,
                        meta, device=d, plan=plan, write_files=False)
        hists.append(lr.run(lr.state_from_params(
            p0.w0, p0.w, p0.v, host_draws(SEED, d)), num_iter=2,
            verbose=False)[1])
    worst = compare_traj(*hists, ("rmse_this", "mae"), TRAJ_RTOL,
                         "als gpu vs cpu")
    say("als-gpu-vs-cpu", t0, sweeps=2, factor_block=1,
        max_rel=f"{worst:.3e}", rtol=TRAJ_RTOL)

    # ---- 17. Gibbs quality after 30 iterations (information) ----------------
    t0 = time.perf_counter()
    _, hq = gibbs.run(num_iter=max(REF_MCMC_RMSE), verbose=False)
    check_mcmc_history(hq, "mcmc-quality", "rmse")
    say("mcmc-quality", t0, iterations=len(hq),
        sec_per_iter=f"{statistics.median(h['time_learn'] for h in hq[1:]):.6f}",
        **{f"test_rmse_iter{i}": f"{hq[i - 1]['rmse']:.5f}"
           for i in REF_MCMC_RMSE},
        reference_cpp=",".join(f"{i}:{v}" for i, v in REF_MCMC_RMSE.items()))

    # ---- 18. where a Gibbs sweep's device time goes -------------------------
    gibbs.run(mstate, num_iter=1, verbose=False)
    profile_run(lambda: gibbs.run(mstate, num_iter=5, verbose=False), 5,
                "sweep", "mcmc-profile", focus=MCMC_FOCUS)

    # ---- 19. P1: the cost of a gather at data-dependent addresses ----------
    t0 = time.perf_counter()
    sets = gather_sets(dev)
    lines, l_probe = drive(build, "gather-probe", lambda: probe_gathers(sets))
    print("\n".join(lines))
    say("gather-probe", t0, sets=len(sets), card=repr(card))

    # ---- 19b. checkpoint/resume on the card, bit for bit --------------------
    # (SGD's X9a adds each batch's gradients with float atomics: two of
    # its runs differ in their last bits, so it is held to the GPU-vs-CPU
    # bounds)
    ckpt_phase(dev, {"vb": (learner, dict(chunk=1), None),
                     "gibbs": (gibbs, dict(chunk=1), None),
                     "ovb": (ovb, {}, None),
                     "sgd": (sgd, {}, (SGD_TRAJ_RTOL, SGD_PARAM_ATOL))})

    l_sgd, l_online, l_exp, l_sgda, l_bpr, online_sec, sgd_ref = sgd_phases(
        build, card, dev, sgd, exp_sgd, sgda, bpr, train, test, meta,
        base_cfg, (tr90, va10))

    # ---- 27b. the feature-sharded SGD (T1, T11, X9b dense) and serving
    # over a mesh (X11 replicated; T1 and T12 feature-sharded) ------------
    l_tps, l_smesh = tp_sgd_phases(build, card, dev, sgd, sgd_ref, train,
                                   test, meta, served, serve_e2e)
    del served

    # ---- 28. full-batch exp_sgd, factor_block 0, 5 sweeps ------------------
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    (xstate, hx), l_xsgd = drive(build, "exp-sgd", lambda: exp_full.run(
        exp_full.init_state(), num_iter=5, verbose=False))
    check_sgd_history(hx, "exp-sgd")
    _, split = enqueue_then_wait(lambda st: exp_full.step(st)[0], xstate)
    say("exp-sgd", t0, sweeps=len(hx), learn_rate=EXP_SGD_LR,
        sec_per_iter=f"{statistics.median(h['time_learn'] for h in hx[1:]):.6f}",
        enqueue_then_wait_ms=split,
        rmse=",".join(f"{h['rmse']:.5f}" for h in hx),
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        launches=json.dumps(l_xsgd, separators=(",", ":")), card=repr(card))

    # ---- 29. exp_sgd, GPU kernels vs CPU twins, full size -------------------
    t0 = time.perf_counter()
    p0 = init_fm_params(torch.Generator().manual_seed(SEED), D, K,
                        init_stdev=cfg.init_stdev)
    cpu = ExpSGDLearner(exp_full.cfg, train, test, meta, device="cpu",
                        write_files=False)
    hists = [lr.run(lr.state_from_params(p0.w0, p0.w, p0.v), num_iter=2,
                    verbose=False)[1] for lr in (exp_full, cpu)]
    worst = compare_traj(*hists, ("rmse",), TRAJ_RTOL, "exp-sgd gpu vs cpu")
    say("exp-sgd-gpu-vs-cpu", t0, sweeps=2, max_rel=f"{worst:.3e}",
        rtol=TRAJ_RTOL)
    del cpu

    l_bs, l_bs_als, l_bs_seq, l_bs_nine, l_bs_k64 = bs_phases(
        build, card, dev, bs_mcmc, bsp)
    # ---- 34b. the data-parallel block structure and online VB ------------
    l_dps = dp_slice_phases(build, card, dev, tr, train, test, meta,
                            base_cfg, bsp, bs_mcmc)
    del bs_mcmc
    l_class = class_phases(build, card, dev, train, test, meta, base_cfg,
                           plan, bsp, (tr90, va10))
    l_ooc = ooc_phases(build, card, dev, tr, te, train, test, meta, base_cfg,
                       plan, ovb_ref, online_sec)

    runs = (l_serve, l_fast, l_exact, l_tp, l_tp0, *l_tpm, *l_dp, l_ovb,
            *l_tpo, l_mcmc, *l_als, l_probe, l_sgd, l_tps, l_smesh,
            l_online, l_exp, l_sgda, l_bpr, l_xsgd, l_bs, l_bs_als, l_bs_seq,
            l_bs_nine, l_bs_k64, *l_dps, *l_class, *l_ooc)
    launches = {n: sum(lp[n] for lp in runs) for n in SOURCES}
    kernels = []
    for n in SOURCES:
        _label, ms, pms, lms, c = report[n]["times"][0]
        bms, by = bound(c)
        kernels.append(dict(
            name=n, route="cuda", source=SOURCES[n][0],
            replaces=SOURCES[n][1], launches=launches[n],
            max_abs_err=report[n]["max_abs_err"], ms=ms, plain_ms=pms,
            bound_ms=bms, bound_by=by, library_ms=lms))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
