#!/usr/bin/env python3
"""chip_smoke.py — the quickest proof that hpnn_tpu_torch runs on an
NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. probe   — torch/CUDA versions, the card, its power limit.
2. build   — compiles every CUDA source of the main paths from the
   checkout (``hpnn_tpu_torch/csrc/*.cu``) with nvcc for sm_90a, one
   nvcc per source, and the native host library
   (``csrc/hpnn_native.cpp``) with g++, all started together; the host
   library must load.
3. pinned  — the convergence kernel against its plain PyTorch version
   at 784-300-10 with delta = -1e30, so every sample runs exactly
   K+1 iterations: ANN/SNN x BP/BPM, float and double; then the kernel
   against itself, bitwise, under every plan (8 and 16 CTAs, weights
   resident and streamed).
4. main    — ``train_nn`` then ``run_nn`` (the package's CLIs) on a
   seeded synthetic MNIST-shaped dataset: ANN 784-300-10 BP, then
   SNN 784-300-10 BP; the kernel's launch count is read around it.
5. real    — kernel against plain at the loop's own delta/min_iter
   (max_iter lowered so the plain Python loop stays short).
6. timing  — the kernel at each cluster size, its plain version and
   its bound, every mode and type; one chunk of real samples.
7. batch pinned — the four batch-step entry points against their plain
   versions at 784-300-10 BP and 851-230-230 BPM, B = 256, S = 8, ANN
   and SNN, float and double; then bitwise: banked step == direct step
   on every block, grid epoch == S banked steps, dbuf epoch == grid
   epoch, grid epoch == itself run again.
8. batch main — ``train_nn --batch 256 --epochs 5`` then ``run_nn`` and
   ``run_nn --batch`` on 4096 + 1024 synthetic MNIST-shaped files: ANN
   and SNN BP; again with ``HPNN_BANK_DBUF=1`` (byte-identical stdout
   and kernel.opt); ANN with ``HPNN_BANK=0`` (per-step launches) equal
   byte for byte to ``HPNN_BANK_REFRESH=1``; ANN with ``--device cpu``
   in float64, the band the card's float32 run is held to.  The
   batch-step launch counts are read around this phase.
9. batch timing — each entry point, its plain version and its bound
   over one epoch of a 60000 x 784 bank in device memory, B = 256, on
   the cooperative grid (the entry points' team) and on one 16-CTA
   cluster (``batch_step._cluster_team``).
10. fleet pinned — the fleet epoch (#6) against its plain version at
   784-300-10 BP and 851-230-230 BPM, 4 members, B = 256, S = 8, ANN
   and SNN, float and double; then bitwise: member i of #6 == #5 and
   #4 on bank i with orders[i], #6 == itself run again, and #6 at
   every cluster size (1, 2, 4, 8, 16 CTAs a member) == #6 planned.
   Then the bf16 build of #6 (bf16 storage, products on the tensor
   cores with float32 sums) against its plain version (the step math on
   bf16 tensors) at 784-300-10 and 851-230-230, ANN/SNN x BP/BPM:
   weights within ``BF16_BAND["w"]``, each layer's change over the epoch
   within ``BF16_BAND["update_rel"]`` of plain's, losses within
   ``BF16_BAND["loss_rel"]`` relative; bitwise: bf16 #6 == itself run
   again and at every cluster size, member i == bf16 #5 == bf16 #4 on
   bank i, and #6 on each member's first block alone == bf16 #2 == #3
   on it; and ``train.fleet.quant_probe_fleet`` (bf16 against float32)
   on the card below the JAX package's 1e-1.
11. fleet main — ``train.fleet.train_fleet`` on 8 members of 784-300-10
   ANN-BP, 4096 synthetic MNIST-shaped rows, B = 256, 8 epochs, with
   the launch counts read around it; bitwise: ``train_sequential`` ==
   the fleet, ``train_fleet_multi`` (2 rounds) == 2 chained
   ``train_fleet`` calls; the same fleet on the CPU in float64 within
   the bands; then the HPNN-sized fleet (64 members of 32-16-4, B = 1,
   30 ticks), one launch a tick against one per member, bitwise equal,
   and one such tick of #6 against its plain version (ANN/SNN x BP/BPM,
   float and double), the weights held to have moved.  Last, the
   bf16 fleet: ``train_fleet(dtype="bf16")`` on the same 8 members, the
   launch counts set to 0 just before and read just after (the bf16 #6
   row's launches), its loss falling and its weights within
   ``BF16_VS_F32_W`` of the float32 fleet's.
12. fleet timing — #6 over one epoch of 8 and of 32 members' 60000-row
   banks at each cluster size, against its plain version (8 members),
   its bound and the members' #5 epochs run one after another; then #6
   planned at 1-32 members against N times one #5 epoch, and the
   least N at which the fleet is the faster; then bf16 #6 for 8 members
   in turns with float32 #6 (f32, bf16, bf16, f32) and at each cluster
   size, its plain version and its bound (bf16 bytes at 3.35 TB/s
   against the same operations at the 989 TFLOP/s of the bf16 tensor
   cores its products run on; beside it, the same operations at
   float32's 67 TFLOP/s).
13. resume, streaming, ledger, obs, native — on phase 4's ANN round
   (256 samples, chunks of 64) and phase 8's batch round: the launch of
   chunk 2 raises and ``HPNN_FUSE_STATE`` resumes (tokens and kernel.opt
   byte-identical to an uninterrupted run), and a batch run stopped
   after epoch 2 of 5 resumes the same way; ``HPNN_FUSE_EPOCH=0``
   launches #1 once a sample with the chunked run's stdout and
   kernel.opt; the per-sample (its first ``F64_SAMPLES`` samples from
   the generated kernel, at most ``F64_MAX_ITER`` iterations each),
   batch and 8-member fleet rounds in
   float64 on the card and on the CPU, each with ``HPNN_LEDGER`` and
   ``HPNN_TRACE``: ``tools/ledger_diff.py`` exits 0 and the #DBG lines
   agree tag by tag within 1e-12; every obs knob on leaves stdout and
   kernel.opt byte-identical and records ``perf.mfu`` for #1, #4 and #6
   (``tools/check_obs_catalog.py --ledger`` and ``--perf`` pass); the
   native host library parses the 4096-file bank bitwise as the Python
   walk does, both timed, with both rounds' wall times.

14. serve — the serve stack (``hpnn_tpu_torch.serve``) at 784-300-10,
   ANN (phase 4's trained kernel.opt) and SNN (the generated kernel):
   one CUDA graph a (kernel, bucket) captured at warmup and none after;
   graph replay against the eager batched forward on every bucket; the
   bench twin's headline load (16 clients x 25 requests of 1/2/4/8
   rows, max_batch 64, 2 ms wait) with one replay a bucket dispatch and
   every answer held to the CPU's float64 parity answer; one replay's
   time a bucket against one eager launch; the bf16/int8 policies'
   quant_err within docs/performance.md's bounds; 8 same-topology
   kernels through one stacked fleet graph; a hot reload mid-load whose
   answers are each the old or the new version's; a 2-replica router;
   ``serve_nn`` in its own process over HTTP.
15. planes — the serving planes on the card: (a) the tenant host
   (``tenant.TenantSession`` through ``bench_serve.run_bench_tenant``):
   256 distinct 784-300-10 ANN kernels across 8 tenants, 32 resident,
   Zipf 1.2 traffic from 16 clients of 1-8 rows for ``TENANT_SECONDS`` (6 s) with the hot
   tenant ``silver`` at 50 requests/s, every page-in capturing the
   bucket menu: cold hits split into checkpoint read, copy and
   captures, memory_allocated held under (cap + clients) x one
   kernel's measured footprint plus a cuBLAS workspace a capturing
   thread, sheds on the hot tenant only, every answer within 1e-5 of
   the CPU float64 answer, a probe kernel bitwise across a page cycle,
   and what a capture costs a replaying neighbour; (b) the bench
   preset's load in 3 s windows with every plane off and on (A B B A),
   probe rows bitwise alike; (c) a ``POST /v1/capture`` capsule whose
   ``torch.profiler`` window holds the graph launches, an input shift
   firing the drift alert, ``/meterz`` device-seconds against the
   dispatch wall (every dispatch metered; both are host clocks); (d)
   the tuning plane live (``HPNN_TUNE_DRY=0``) and a forced rollback
   of a precision move, bitwise.
16. mesh — multi-GPU (``--mesh``, ``parallel/``) as one card can show
   it: (a) world size 1: ``train_nn --mesh 1x1`` and ``train_nn --batch
   256 --mesh 1x1`` byte-identical (stdout and kernel.opt) to the runs
   without ``--mesh``, and one NCCL rank's all_gather and all-reduce
   through ``parallel/coll.py``; (b) two gloo ranks on the one card
   (``dist.run(..., backend="gloo", device="cuda:0")``): per-sample TP
   (``driver.train_kernel`` then ``run_kernel``) at 784-300-10 on 8
   ANN-BP samples (from phase 4's kernel.opt) and 8 SNN-BP samples
   (generated), ``max_iter`` capped at ``REAL_MAX_ITER``, and
   ``train_kernel_batched`` (B = 256, 2 epochs, 4096 rows) at 2x1 and
   1x2, each in float32 and float64: the SNN output's ``out_exp`` on
   the card zero exactly where the CPU's is over its subnormal range
   (``torch.exp``'s misses printed); float64 held to the same two-rank
   world on the CPU (every weight within 1e-12; ``tools/ledger_diff.py``
   strict, its verdict printed, failing the phase on anything but a
   matrix checksum past the 1e-12 bar), float32 to world size
   1 on the card within the bands (total N_ITER, first-try OK, PASS;
   epoch losses and counts); (c) a ``Router(spill=True)`` request over
   ``max_batch`` against the engine's replay of the same rows.  ``[mesh]``
   lines give ms per TP iteration, samples/s, the share in ``coll.*``,
   ms per DP epoch and the spill's µs per row.  Two or more NCCL ranks
   need two cards, so they are not run here.
17. online — Slice F, train-while-serve (``hpnn_tpu_torch.online``) at
   784-300-10, under a watchdog that prints every thread's stack on
   stdout and exits 1 past ``ONLINE_WATCHDOG_S``: (a) one
   ``OnlineSession`` in compiled mode holding phase 4's ANN kernel.opt and
   a generated ANN (one group: #6) and a generated SNN (alone: #4), fed
   ``mnist_stream`` through ``POST /ingest`` while 8 clients call
   ``infer`` and the trainer thread runs rounds every 0.25 s; (b) at
   least one promotion of each group, every answer bitwise one version's
   graph replay, captures after warmup = installs x buckets, all on the
   trainer thread, no round failed, a NaN candidate rejected while the
   clients are answered, a forced rollback (asked for from the main
   thread, run on the trainer thread) answering bitwise as before the
   promotion, a fresh session on the same ``HPNN_WAL_DIR`` restoring the
   last weights bitwise, memory_allocated at the end within two cuBLAS
   workspaces per capturing thread created (and one more) of its value
   after warmup; (c) one trainer round in float32 and float64 on the
   card against the CPU's float64 round (float64 within 1e-10, float32
   losses within the fleet band); (d) ``[online]`` lines: a round's wall
   and its training's device time, promote latency, infer p50/p99 with
   the trainer idle and busy, the capturing threads.
18. fleet — the serving fleet (``hpnn_tpu_torch.fleet``) at 784-300-10:
   (a) a ``WorkerSupervisor`` spawns two ``online_nn`` worker processes
   on ``cuda`` (trainer parked, ``--interval-s 600``) sharing one
   ``HPNN_WAL_DIR`` whose seed version they restore, behind a
   ``ClusterRouter`` (``CheckpointPublisher(wal_dir=...)``) bound by
   ``serve.make_server``; (b) ``FLEET_CLIENTS`` clients infer through
   the edge while ``FLEET_INSTALLS`` fenced installs run: every answer
   bitwise one version's (as read from every worker after its install,
   the workers agreeing bitwise), each version within 1e-5 of the CPU
   float64 forward, the workers converged on the last; (c) one worker
   SIGKILLed under that load: no answer but a retriable one, the
   supervisor reaps and replaces it, and the replacement serves the last
   WAL version bitwise; (d) a worker drained with SIGTERM exits 0, then
   an ``Autoscaler`` with a tight ``Policy``, fed the requests in flight
   at the edge per worker, grows the fleet 1 -> 2 under a load ramp and
   drains it back to 1 (exit 0, no SIGKILL) once the load has stopped;
   (e) ``[fleet]`` lines: each worker's spawn -> ready seconds
   (no compile cache: its captures included), the install fan-out's
   ms, p50/p99 through the edge, the loss-recovery seconds, and each
   worker's device memory (``nvidia-smi --query-compute-apps``).
19. deep — nets deeper than 16 layers, at 784-(300x19)-10 (20 layers,
   1.86 M weights of gain ~1, seeded): (a) #1 (ANN-BP, ANN-BPM, SNN-BP;
   its weights and dw streamed from device memory, ``DEEP_PINNED_K`` + 1
   iterations a sample) bitwise at 8 and 16 CTAs and across the grid and
   the one-cluster builds, #2-#5 (ANN-BP,
   SNN-BPM; B = 256, S = 8) and #6 (4 members) against their plain
   versions, float64 within 1e-10 and float32 within the shallow bars
   (``TOL``, ``BATCH_TOL``); bf16 #6 against its bf16 plain version,
   printed and gated on being finite (no band at this depth is
   measured); each kernel's time there; (b) ``train_nn`` (4 samples, at
   most ``DEEP_MAX_ITER`` iterations each) then ``run_nn``, and
   ``train_nn --batch 256 --epochs 1`` on 512 files, in float64 on the
   card and on the CPU: the training and ``run_nn`` tokens identical,
   ``kernel.opt`` within 1e-12, the ``BATCH EPOCH`` count equal and its
   loss within 1e-12, #1 and #4 launched in the card runs; docs/api.md's
   flow through ``hpnn_tpu_torch.train_kernel``/``run_kernel`` with no
   device argument, on the card.  Every kernel's entry on the kernels
   line gains ``deepest_layers`` and its errors and times at this depth.
20. wide — #1 on per-sample nets whose owned rows of W overflow a
   cluster's shared memory, at 784-[30000]-10 float32 and 784-[15000]-10
   float64 (the vectors overflow one CTA too): the plan's grid build (one
   cooperative CTA an SM, W streamed through rings in shared memory, the
   vectors published once in device memory) and the one-cluster device
   build (one copy of the vectors a CTA in a device-memory scratch, W
   streamed from HBM; ``grid=False``): (a) the grid against its plain
   version (ANN-BP, ANN-BPM, SNN-BP; 4 samples x ``WIDE_PINNED_K`` + 1
   iterations), float32 within 1e-4 and float64 within 1e-10, and bitwise
   the one-cluster build; (b) at 784-300-10 the device build forced (16
   and 8 CTAs) and the grid forced (all, 16 and 8 CTAs) bitwise the
   shared build, ANN/SNN x BP/BPM x float32/float64, and at
   ``WIDE_MID`` (784-[4000]-10 float32, ANN-BPM) the grid bitwise one
   cluster; (c) ``train_nn`` at 784-[15000]-10 float64 ([init] generate,
   4 samples at most ``WIDE_MAX_ITER`` iterations) on the card and on the
   CPU: tokens and ``kernel.tmp`` identical, ``kernel.opt`` within 1e-12,
   #1 launched on the card; (d) µs an iteration of both builds in turns
   (grid, one cluster, one cluster, grid) at each width and at
   ``WIDE_MID``, each as a share of its bound (W read and written once an
   iteration at 3.35 TB/s, or the operations at 67 TFLOP/s), and the plain
   version after one untimed run.  The kernels line gains the entry
   ``convergence (vectors in device memory)``: its launches are (c)'s,
   its time the grid's, beside the grid's CTAs and the one-cluster
   build's µs an iteration.
21. drills — all twelve of the port's chaos drills
   (``hpnn_tpu_torch/tools/chaos_drill.py``, at the repo tool's
   ``--rate`` 40) on the card, in the repo tool's order: kill9 (an
   ``online_nn`` child on ``cuda`` SIGKILLed after a WAL-committed
   promotion, restarted, its weights bitwise the WAL's), reload and
   sentinel (children on ``cuda``: a chaos-failed then good hot reload,
   NaN candidates the gate rejects), replica and alert (a ``Router``
   whose replicas share the card: a kill routed around, a rule fired and
   resolved across ``spawn_replica``'s captures), worker (two
   ``online_nn`` worker processes on ``cuda``, one SIGKILLed and
   replaced), capsule (a delayed dispatch seam, a capsule and the tail
   report's blame), drift, quota, hog, tune (the tuner live on a
   captured session, bf16 captures included) and torn; each row and the
   phase's seconds printed; a drill that fails, could not run or says it
   skipped fails the phase.
22. tokens — the port's byte-stability lint
   (``hpnn_tpu_torch/tools/check_tokens.py``) with ``device="cuda"``: the
   6-sample 8-5-2 round's stdout byte-identical plain, under every obs
   plane, after serve/Router/cluster/online round trips and with the
   ledger alone, and the ledger rows equal row for row (#1's reruns
   bitwise); it prints the count of token lines compared and of sink
   events, and any failure fails the phase.

The last two lines are the kernel table and the device line.  A failed
phase prints ``chip_smoke: FAILED in phase N (<name>): <reason>`` (and
an exception's traceback) on stdout and stderr and exits 1.

``--planes-only`` runs phase 1 and phase 15 alone and prints no result
line (a quick check of the planes on a card).  ``--online-only`` runs
phase 1 and phase 17 alone (a generated ANN in place of phase 4's) and
prints no result line.  ``--fleet-only`` runs phase 1 and phase 18
alone (``batch_step.cu`` built first, as the workers' trainers launch
#4) and prints no result line.

``--wide-only`` runs phase 1 and phase 20 alone (``convergence.cu`` built
first) and ``--drills-only`` phase 1 and phases 21 and 22 alone (both
sources built first: the drills' trainers launch #4 and the token lint's
rounds #1, its fleet round #6); neither prints a result line.

``--capture-thread`` runs phase 1 and the capture-thread probe alone
(no result line): five cases of a thread that captures CUDA graphs
beside serving replays (a long-lived side thread capturing; a capture
beside a thread looping ``torch.cuda.synchronize()``; beside launches of
#4 and #6 on the legacy default stream, and on a stream of their own;
beside the first load of the kernels and of cuBLAS on another thread),
each in a child process under a watchdog, three runs with
``CUDA_LAUNCH_BLOCKING=1`` and two without; it prints each run's
outcome (ok, raised, hung) and, for a failed one, the tail of its
output (every thread's stack for a hang).

``--tp-repeat`` runs phase 1 and a repeat probe of phase 16's float64
TP SNN run alone (no result line): the same two-rank gloo run on the
card three times (once after the float32 run, as phase 16's ranks do)
and on the CPU six times (two of them on one intra-op thread a rank),
each iteration's ``dEp`` and top-two output gap recorded; it prints
whether the repeats agree bitwise, where two runs' trajectories first
part, and how close each sample's stopping decision came to its
threshold.

``--phase-split`` also builds the phase-clock variants
(``-DHPNN_PHASE_CLOCKS``) of the convergence and batch-step kernels,
holds each bitwise against its kernel and prints where an iteration's
time goes in phase 6, in phase 20 (both builds at each width and at
``WIDE_MID``) and a #4 step's (on each team) in phase 9; in phase 12,
#6's plan split (``fleet_plan_split``: the plan's k-tile and sync
constants, and its estimate against each team's epoch); and,
in phase 9, a #4 step's phases and its tiles' k-tiles by part (loads,
stage stores, fragment loads, products, barrier) in float32 and in
bf16, with every build's registers and spills from ptxas.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import faulthandler
import hashlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import threading
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".smoke")
SEED = 10958
N_IN, N_HID, N_OUT = 784, 300, 10
N_TRAIN_ANN, N_TRAIN_SNN, N_TEST = 256, 16, 256
CHUNK = 64            # HPNN_FUSE_CHUNK for the main path
PINNED_K = 20         # phase 3: max_iter, so K+1 iterations per sample
CLUSTERS = (16, 8)    # phase 6: cluster sizes timed
REAL_MAX_ITER = 1500  # phase 5: caps the plain loop's run time
TIMED_ITERS = 200     # phase 6: iterations per sample, pinned
# Tolerances of kernel vs plain on the same inputs.  Both run the same
# arithmetic; only the order of each dot product's and reduction's sum
# differs (warp shuffles vs torch's kernels).  float64: a reordered sum
# of <= 784 terms moves by ~1e-16 relative per step, so 1e-10 absolute
# on weights (|w| < 1) and outputs (|o| <= 1) leaves a wide margin after
# 21 iterations.  float32: the same reordering moves ~1e-7 relative per
# step and feeds back through 21 updates; 1e-4 absolute is well above
# that drift and far below any real fault (a wrong term is O(1e-2)).
TOL = {"float32": 1e-4, "float64": 1e-10}
# Phase 5 in float32: reduction order moves trajectories near the
# thresholds, so totals are held to a band, not per sample.
REAL_F32_NITER_BAND = 0.05   # relative, on the total N_ITER
REAL_F32_FIRST_OK_BAND = 1   # samples, on the first-try OK count
# Phases 7-9: the batch path (tutorials/mnist/tutorial.sh --batch).
BATCH, EPOCHS, PINNED_S = 256, 5, 8
N_BATCH_TRAIN, N_BATCH_TEST = 4096, 1024   # the tutorial's 60k / 10k, cut
XRD = (851, 230, 230)                      # the XRD kernel's shape
TIMED_ROWS = 60000                         # one MNIST epoch, in memory
SCALING_B, SCALING_STEPS = (16, 64, 256), 64  # per-step time against B
# Batch kernel vs plain: the same arithmetic, each sum in another order.
# float32 moves ~1e-7 relative per operation: 1e-5 after a step, 1e-4
# after the S = 8 steps of an epoch; float64 within 1e-10.  Losses are
# held relative to max(1, |loss|).
BATCH_TOL = {("float32", "step"): 1e-5, ("float32", "epoch"): 1e-4,
             ("float64", "step"): 1e-10, ("float64", "epoch"): 1e-10}
# The card's float32 main path against the CPU's float64 run of the
# same protocol: losses within 1e-3 relative, counts within
# max(2, 0.5% of n).
BAND_LOSS_REL, BAND_COUNT_REL = 1e-3, 0.005
# Phases 10-12: the fleet path (hpnn_tpu/train/fleet.py, bench.py's fleet).
FLEET_N = 4                                   # phase 10: members
FLEET_MAIN_N, FLEET_EPOCHS, FLEET_ROWS = 8, 8, 4096
# lr of the full-width fleet: the loss falls over all 8 epochs and the
# counts climb from a fraction of the rows, so the count band between the
# card's f32 and the CPU's f64 run can tell two runs apart
FLEET_LR = 0.003
HPNN_FLEET = (64, (32, 16, 4), 30)            # bench.py: members, shape, ticks
FLEET_TIMED_N = (8, 32)                       # phase 12: members timed at every C
FLEET_CROSS_N = (1, 2, 4, 8, 16, 32)          # phase 12: members against sequential #5
# The bf16 build of #6 against its plain version (phase 10).  Both
# store every weight, activation and delta in bf16 (8 bits of
# mantissa), but the kernel rounds once where it stores a product's
# float32 sum and the plain version after each tensor operation, so the
# two trajectories part by a bf16 ulp or two of the weights over S = 8
# steps.  Set from the card's readings (NVIDIA H100 80GB HBM3, 700.00 W;
# PERF.md): weights 2.441e-04-4.883e-04 apart (one or two ulps of the
# ~0.04 weights), held within 2e-3; each layer's change over the epoch,
# w - w0, 1.9e-02-1.004e-01 from plain's relative to plain's, held
# within 0.25 (a change of the wrong sign reads 2, none 1); the losses
# 2.1e-03-3.5e-03 relative, held within 2e-2.
BF16_BAND = {"w": 2e-3, "update_rel": 0.25, "loss_rel": 2e-2}
# the bf16 fleet of phase 11 against the float32 one: 2.060e-02 apart in
# every card run (a step of 0.003/256 of an outer product is under half
# a bf16 ulp of most weights and rounds away)
BF16_VS_F32_W = 4e-2
QUANT_ERR_BAR = 1e-1                          # tests/test_quant.py's bar
EPOCH_RE = re.compile(r"BATCH EPOCH +(\d+) loss= (\S+) acc= +\S+% \((\d+)/(\d+)\)")
BATCH_KERNELS = (
    # entry point, TPU kernel it replaces (pallas_call line), on the main path
    ("train_step_fused_batch", "hpnn_tpu/ops/pallas_train.py:528", True),
    ("train_step_fused_banked", "hpnn_tpu/ops/pallas_train.py:629", False),
    ("train_epoch_grid_banked", "hpnn_tpu/ops/pallas_train.py:733", True),
    ("train_epoch_dbuf_banked", "hpnn_tpu/ops/pallas_train.py:882", True),
)


class SmokeFailure(Exception):
    pass


PHASE_NAMES = {
    1: "probe", 2: "build", 3: "pinned", 4: "main", 5: "real", 6: "timing",
    7: "batch pinned", 8: "batch main", 9: "batch timing", 10: "fleet pinned",
    11: "fleet main", 12: "fleet timing", 13: "resume-obs-native", 14: "serve",
    15: "planes", 16: "mesh", 17: "online", 18: "fleet", 19: "deep",
    20: "wide", 21: "drills", 22: "tokens", 0: "capture-thread probe",
}
# the phase running now, named in a failure's message
PHASE = {"n": None, "name": "start-up"}


def enter(n: int) -> None:
    PHASE.update(n=n, name=PHASE_NAMES[n])


def fail(reason: str, trace: str | None = None) -> None:
    """Print the failure, its phase and (for an exception) the traceback
    on stdout and on stderr."""
    where = (f"phase {PHASE['n']} ({PHASE['name']})" if PHASE["n"] is not None
             else PHASE["name"])
    msg = f"chip_smoke: FAILED in {where}: {reason}"
    for stream in (sys.stdout, sys.stderr):
        if trace:
            print(trace.rstrip(), file=stream)
        print(msg, file=stream, flush=True)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ data
def make_dataset(np, rng, n, protos):
    """``n`` MNIST-shaped samples: a class prototype (15% ink) with
    stroke-intensity jitter and 3% random pixels; +-1 one-hot targets."""
    X = np.empty((n, N_IN))
    T = -np.ones((n, N_OUT))
    for i in range(n):
        c = int(rng.integers(0, N_OUT))
        x = protos[c] * rng.uniform(0.6, 1.0, N_IN)
        flip = rng.random(N_IN) < 0.03
        X[i] = np.where(flip, rng.uniform(0.0, 1.0, N_IN), x)
        T[i, c] = 1.0
    return X, T


def write_samples(directory, X, T):
    os.makedirs(directory)
    for i, (x, t) in enumerate(zip(X, T)):
        with open(os.path.join(directory, f"s{i:05d}.txt"), "w") as fp:
            fp.write(f"[input] {N_IN}\n" + " ".join("%.5f" % v for v in x) + "\n")
            fp.write(f"[output] {N_OUT}\n" + " ".join("%.1f" % v for v in t) + "\n")


def write_conf(path, *, name, kind, train_dir, test_dir, init="generate"):
    with open(path, "w") as fp:
        fp.write(f"[name] {name}\n[type] {kind}\n[init] {init}\n[seed] {SEED}\n"
                 f"[input] {N_IN}\n[hidden] {N_HID}\n[output] {N_OUT}\n"
                 f"[train] BP\n[sample_dir] {train_dir}\n[test_dir] {test_dir}\n")


# --------------------------------------------------------------- helpers
def run_cli(main, argv):
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue(), time.perf_counter() - t0


# an entry function in a ptxas -v report, and its kernel template's
# name and arguments in the mangled name
PTXAS_ENTRY_RE = re.compile(r"Compiling entry function '(\S+)'")
PTXAS_KERNEL_RE = re.compile(
    r"(batch_train|cluster_train|convergence_cluster|convergence_grid)"
    r"I(13__nv_bfloat16|[fd])((?:Lb[01]E)*)")


def kernel_name(mangled: str) -> str:
    """``cluster_train<bf16>``, ``convergence_cluster<float, 0, 1>`` (``,
    table`` for the build that reads its layers from the table in device
    memory), or the mangled name of another kernel."""
    m = PTXAS_KERNEL_RE.search(mangled)
    if not m:
        return mangled
    args = [{"f": "float", "d": "double"}.get(m.group(2), "bf16")]
    args += re.findall(r'Lb([01])E', m.group(3))
    args += ["table"] if "TableLayers" in mangled else []
    return f"{m.group(1)}<{', '.join(args)}>"


def ptxas_report(out: str) -> list:
    """One line per entry function of a ``ptxas -v`` report: its kernel
    and type, registers, spill stores and loads."""
    lines, name, spill = [], None, ""
    for line in out.splitlines():
        m = PTXAS_ENTRY_RE.search(line)
        if m:
            name = kernel_name(m.group(1))
        elif "spill" in line:
            spill = line.strip()
        elif "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            lines.append(f"{name}: {regs.group(1) if regs else '?'} registers; {spill}")
    return lines


def build_all(_build, builds):
    """Phase 2: one nvcc per (source, define) of ``builds`` and g++ for
    the host library, all started together, then loaded; each kernel's
    registers and spills from ptxas."""
    with concurrent.futures.ThreadPoolExecutor(len(builds) + 1) as pool:
        native = pool.submit(_build.build_host, "hpnn_native", force=True)
        list(pool.map(lambda b: _build.build(b[0], force=True, define=b[1]), builds))
        native.result()
    for name, define in builds:
        _build.load(name, define)
        secs, out = _build.build_log[(name, define) if define else name]
        log(f"[build] {name}.cu{' -D' + define if define else ''} built in {secs:.1f} s")
        for line in ptxas_report(out):
            log(f"[build]   {line}")


def fleet_team_name(team) -> str:
    """#6's team (ops.batch_step.fleet_cluster's plan) in words."""
    return "the grid" if team == 0 else f"{team}-CTA clusters"


def cuda_ms(torch, fn, reps=3):
    """Median of ``reps`` CUDA-event timings of ``fn()`` after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return sorted(times)[len(times) // 2]


# ------------------------------------------------- convergence plans
def plans_of(convergence, weights, dtype, momentum):
    """Every plan the kernel can take for these weights: each cluster
    size, with the owned weight rows resident where they fit and
    streamed."""
    out = []
    for C in CLUSTERS:
        p = convergence.plan(weights, dtype, momentum, cluster=C)
        out.append(dict(cluster=C))
        if p.weights_resident:
            out.append(dict(cluster=C, weights_resident=False))
    return out


def plan_str(p):
    if p.grid:
        return (f"the grid build, {p.cluster} CTAs, W and dw through rings, "
                f"{p.smem_bytes} B a CTA")
    return (f"{p.cluster} CTAs, W {'shared' if p.weights_resident else 'device'}, dw "
            f"{'shared' if p.dw_resident else 'device'}, {p.smem_bytes} B a CTA")


def same_run(a, b):
    """Two (weights, stats) results equal bitwise."""
    return all(x.equal(y) for x, y in zip(list(a[0]) + list(a[1]), list(b[0]) + list(b[1])))


# ---------------------------------------------------------- batch phases
def state_err(a, b):
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def update_err(w, wp, w0):
    """Over the layers, the largest distance between the kernel's change
    ``w - w0`` and its plain version's ``wp - w0``, relative to the
    plain change."""
    return max(float(((a.float() - z.float()) - (b.float() - z.float())).norm()
                     / (b.float() - z.float()).norm()) for a, b, z in zip(w, wp, w0))


def loss_err(a, b):
    return float(((a - b).abs() / b.abs().clamp_min(1.0)).max())


def batch_bank(np, rng, shape, rows):
    n_in, _, n_out = shape
    X = rng.random((rows, n_in))
    T = -np.ones((rows, n_out))
    T[np.arange(rows), rng.integers(0, n_out, rows)] = 1.0
    return X, T


def batch_pinned(np, torch, dev):
    """Phase 7: each entry point against its plain version, then the
    bitwise agreements.  Returns {entry: {dtype: max error}}."""
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.ops import batch_step as bs

    rng = np.random.default_rng(SEED + 7)
    err = {name: {"float32": 0.0, "float64": 0.0} for name, _, _ in BATCH_KERNELS}

    for shape, momentum in (((N_IN, N_HID, N_OUT), False), (XRD, True)):
        k, _ = km.generate(SEED, shape[0], [shape[1]], shape[2])
        X, T = batch_bank(np, rng, shape, PINNED_S * BATCH)
        dw0 = ([rng.uniform(-1e-3, 1e-3, np.shape(w)) for w in k.weights]
               if momentum else None)
        order = rng.permutation(PINNED_S)
        for model in ("ann", "snn"):
            kw = dict(model=model, momentum=momentum)
            for dtype in (torch.float32, torch.float64):
                dname = str(dtype).split(".")[1]
                tag = (f"{model}-{'BPM' if momentum else 'BP'} "
                       f"{'-'.join(map(str, shape))} {dname}")
                Xd = torch.tensor(X, dtype=dtype, device=dev)
                Td = torch.tensor(T, dtype=dtype, device=dev)

                def fresh():
                    w, dw = km.to_torch(k.weights, dw0, device=dev, dtype=dtype)
                    return list(w), list(dw)

                def steps(fn, w, dw, first, direct):
                    """S single steps in ``order`` (``direct``: each block
                    passed as X/T, else by index); the state after the
                    first goes to ``first``."""
                    out = []
                    for blk in order:
                        if direct:
                            rows = slice(int(blk) * BATCH, (int(blk) + 1) * BATCH)
                            out.append(fn(w, dw, Xd[rows], Td[rows], **kw)[2])
                        else:
                            out.append(fn(w, dw, Xd, Td, int(blk), batch=BATCH, **kw)[2])
                        if len(out) == 1:
                            first.append([t.clone() for t in w + dw] + [out[0].reshape(1)])
                    return torch.stack(out)

                line = []
                for name, _, _ in BATCH_KERNELS:
                    fn, plain = getattr(bs, name), getattr(bs, name + "_plain")
                    (wk, dwk), (wp, dwp) = fresh(), fresh()
                    if "epoch" in name:
                        lk = fn(wk, dwk, Xd, Td, order, batch=BATCH, **kw)[2]
                        lp = plain(wp, dwp, Xd, Td, order, batch=BATCH, **kw)[2]
                    else:
                        fk, fp = [], []
                        direct = name == "train_step_fused_batch"
                        lk = steps(fn, wk, dwk, fk, direct)
                        lp = steps(plain, wp, dwp, fp, direct)
                        fk, fp = fk[0], fp[0]
                        e1 = max(state_err(fk[:-1], fp[:-1]), loss_err(fk[-1], fp[-1]))
                        tol1 = BATCH_TOL[(dname, "step")]
                        check(math.isfinite(e1) and e1 <= tol1,
                              f"{name} {tag}: first step |kernel - plain| {e1:.3e} > {tol1:.0e}")
                    torch.cuda.synchronize()
                    e = max(state_err(wk + dwk, wp + dwp), loss_err(lk, lp))
                    tol = BATCH_TOL[(dname, "epoch")]
                    check(math.isfinite(e) and e <= tol,
                          f"{name} {tag}: {PINNED_S} steps |kernel - plain| {e:.3e} > {tol:.0e}")
                    err[name][dname] = max(err[name][dname], e)
                    line.append(f"{name.replace('train_', '')} {e:.2e}")
                log(f"[batch-pinned] {tag}, B={BATCH} S={PINNED_S}: max|kernel - plain| "
                    + ", ".join(line))

            # bitwise: one sum order everywhere, whatever the entry point
            Xd = torch.tensor(X, dtype=torch.float32, device=dev)
            Td = torch.tensor(T, dtype=torch.float32, device=dev)
            runs = {}
            for run in ("step", "banked", "grid", "dbuf", "grid again"):
                w, dw = km.to_torch(k.weights, dw0, device=dev, dtype=torch.float32)
                w, dw = list(w), list(dw)
                if run == "step":
                    losses = torch.stack([bs.train_step_fused_batch(
                        w, dw, Xd[int(b) * BATCH:(int(b) + 1) * BATCH],
                        Td[int(b) * BATCH:(int(b) + 1) * BATCH], **kw)[2] for b in order])
                elif run == "banked":
                    losses = torch.stack([bs.train_step_fused_banked(
                        w, dw, Xd, Td, int(b), batch=BATCH, **kw)[2] for b in order])
                else:
                    fn = bs.train_epoch_dbuf_banked if run == "dbuf" else bs.train_epoch_grid_banked
                    losses = fn(w, dw, Xd, Td, order, batch=BATCH, **kw)[2]
                runs[run] = [t.cpu() for t in w + dw] + [losses.cpu()]
            for a, b in (("banked", "step"), ("grid", "banked"), ("dbuf", "grid"),
                         ("grid again", "grid")):
                check(all(torch.equal(x, y) for x, y in zip(runs[a], runs[b])),
                      f"{model} {shape}: {a} differs bitwise from {b}")
            log(f"[batch-pinned] {model}-{'BPM' if momentum else 'BP'} "
                f"{'-'.join(map(str, shape))} float32: banked == step per block, "
                f"grid == {PINNED_S} banked steps, dbuf == grid, grid == grid again (bitwise)")
    return err


def epochs_of(out):
    return [(int(e), float(l), int(ok), int(n)) for e, l, ok, n in EPOCH_RE.findall(out)]


def batch_main(np, torch, protos):
    """Phase 8: the batch path through the CLIs.  Returns (launches by
    entry point over the whole phase, per-run statistics)."""
    from hpnn_tpu_torch.cli import run_nn, train_nn
    from hpnn_tpu_torch.fileio import samples as sample_io
    from hpnn_tpu_torch.ops import batch_step as bs

    # pixels 0-255 unnormalized, as the tutorial's pmnist writes them
    rng = np.random.default_rng(SEED + 1)
    Xtr, Ttr = make_dataset(np, rng, N_BATCH_TRAIN, protos)
    Xte, Tte = make_dataset(np, rng, N_BATCH_TEST, protos)
    Xtr, Xte = np.round(255 * Xtr), np.round(255 * Xte)
    bdir = os.path.join(WORK, "batch")
    write_samples(os.path.join(bdir, "train"), Xtr, Ttr)
    write_samples(os.path.join(bdir, "test"), Xte, Tte)
    t0 = time.perf_counter()
    sample_io.read_dir(os.path.join(bdir, "train"))
    parse_s = time.perf_counter() - t0
    log(f"[batch-main] host parse of the {N_BATCH_TRAIN} training files: {parse_s:.2f} s")
    n_steps = math.ceil(N_BATCH_TRAIN / BATCH)
    runs = (
        # label, type, environment, extra CLI args, expected launches, eval
        ("ANN", "ANN", {}, [], {"train_epoch_grid_banked": EPOCHS}, True),
        ("SNN", "SNN", {}, [], {"train_epoch_grid_banked": EPOCHS}, True),
        ("ANN dbuf", "ANN", {"HPNN_BANK_DBUF": "1"}, [],
         {"train_epoch_dbuf_banked": EPOCHS}, False),
        ("SNN dbuf", "SNN", {"HPNN_BANK_DBUF": "1"}, [],
         {"train_epoch_dbuf_banked": EPOCHS}, False),
        ("ANN bank0", "ANN", {"HPNN_BANK": "0"}, [],
         {"train_step_fused_batch": EPOCHS * n_steps}, False),
        ("ANN refresh1", "ANN", {"HPNN_BANK_REFRESH": "1"}, [],
         {"train_epoch_grid_banked": EPOCHS}, False),
        ("ANN cpu f64", "ANN", {}, ["--device", "cpu"], {}, False),
    )
    cwd = os.getcwd()
    got, stats = {}, {}
    for name in bs.launches:
        bs.launches[name] = 0
    try:
        for label, kind, env, extra, expect, with_eval in runs:
            run_dir = os.path.join(bdir, label.replace(" ", "_").lower())
            os.makedirs(run_dir)
            os.chdir(run_dir)
            write_conf("nn.conf", name=f"batch_{kind.lower()}", kind=kind,
                       train_dir="../train", test_dir="../test")
            saved = {k: os.environ.get(k) for k in env}
            os.environ.update(env)
            before = dict(bs.launches)
            try:
                rc, out, secs = run_cli(train_nn.main, extra + [
                    "--batch", str(BATCH), "--epochs", str(EPOCHS), "-v", "-v", "nn.conf"])
            finally:
                for k, v in saved.items():
                    if v is None:
                        os.environ.pop(k, None)
                    else:
                        os.environ[k] = v
            check(rc == 0, f"{label}: train_nn --batch exit {rc}")
            launched = {k: bs.launches[k] - before[k] for k in bs.launches}
            check(launched == {k: expect.get(k, 0) for k in bs.launches},
                  f"{label}: launches {launched}, expected {expect}")
            ep = epochs_of(out)
            check(len(ep) == EPOCHS and all(e[3] == N_BATCH_TRAIN for e in ep),
                  f"{label}: {len(ep)} BATCH EPOCH lines")
            check(all(math.isfinite(e[1]) for e in ep), f"{label}: loss not finite")
            with open("kernel.opt") as fp:
                opt = fp.read()
            got[label] = (out, opt, ep)
            st = dict(seconds=secs, samples_per_s=N_BATCH_TRAIN * EPOCHS / secs,
                      launches=launched, losses=[e[1] for e in ep],
                      counts=[e[2] for e in ep])
            msg = (f"[batch-main] {label} 784-300-10 BP --batch {BATCH} --epochs {EPOCHS}: "
                   f"{secs:.2f} s ({N_BATCH_TRAIN * EPOCHS / secs:.0f} samples/s with the "
                   f"parse), loss {ep[0][1]:.6f} -> {ep[-1][1]:.6f}, acc {ep[0][2]} -> "
                   f"{ep[-1][2]}/{N_BATCH_TRAIN}, launches "
                   f"{ {k: v for k, v in launched.items() if v} }")
            if with_eval:
                check(ep[-1][1] < ep[0][1], f"{label}: last loss not below the first")
                write_conf("cont.conf", name=f"batch_{kind.lower()}", kind=kind,
                           train_dir="../train", test_dir="../test", init="kernel.opt")
                rc, eout, esecs = run_cli(run_nn.main, extra + ["-v", "-v", "cont.conf"])
                check(rc == 0, f"{label}: run_nn exit {rc}")
                rc, bout, bsecs = run_cli(run_nn.main, extra + ["--batch", "-v", "-v",
                                                                "cont.conf"])
                check(rc == 0, f"{label}: run_nn --batch exit {rc}")
                for what, o in (("run_nn", eout), ("run_nn --batch", bout)):
                    check(o.count("TESTING FILE") == N_BATCH_TEST, f"{label} {what}: eval lines")
                p1, p2 = eout.count("[PASS]"), bout.count("[PASS]")
                check(abs(p1 - p2) <= max(2, BAND_COUNT_REL * N_BATCH_TEST),
                      f"{label}: run_nn PASS {p1} vs run_nn --batch PASS {p2}")
                st.update(run_nn_pass=p1, run_nn_batch_pass=p2, run_nn_s=esecs,
                          run_nn_batch_s=bsecs)
                msg += (f"; run_nn PASS {p1}/{N_BATCH_TEST} in {esecs:.2f} s, "
                        f"run_nn --batch PASS {p2}/{N_BATCH_TEST} in {bsecs:.2f} s")
            stats[label] = st
            log(msg)
            os.chdir(bdir)
    finally:
        os.chdir(cwd)
    main_launches = dict(bs.launches)
    for a, b in (("ANN dbuf", "ANN"), ("SNN dbuf", "SNN"), ("ANN bank0", "ANN refresh1")):
        check(got[a][0] == got[b][0], f"{a} stdout differs from {b}")
        check(got[a][1] == got[b][1], f"{a} kernel.opt differs from {b}")
        log(f"[batch-main] {a} == {b}: stdout and kernel.opt byte-identical")
    card, cpu = got["ANN"][2], got["ANN cpu f64"][2]
    for (e, lc, okc, n), (_, lh, okh, _) in zip(card, cpu):
        check(abs(lc - lh) <= BAND_LOSS_REL * abs(lh),
              f"epoch {e}: card f32 loss {lc} vs cpu f64 {lh}")
        check(abs(okc - okh) <= max(2, BAND_COUNT_REL * n),
              f"epoch {e}: card f32 count {okc} vs cpu f64 {okh}")
    rel = max(abs(c[1] - h[1]) / abs(h[1]) for c, h in zip(card, cpu))
    dok = max(abs(c[2] - h[2]) for c, h in zip(card, cpu))
    log(f"[batch-main] ANN card f32 vs cpu f64: max loss rel diff {rel:.3e} "
        f"(band {BAND_LOSS_REL:.0e}), max count diff {dok} (band "
        f"max(2, {BAND_COUNT_REL:.1%} of {N_BATCH_TRAIN}))")
    stats["band"] = dict(max_loss_rel=rel, max_count_diff=dok, parse_s=parse_s)
    return main_launches, stats


def timing_bank(np, torch, dev):
    """Phase 9's inputs: the permuted 60000-row bank of one epoch (its
    tail wrapped as train_kernel_batched does), the block order and the
    float32 weights of a generated 784-300-10 ANN; and S."""
    from hpnn_tpu_torch.models import kernel as km

    S = math.ceil(TIMED_ROWS / BATCH)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)
    X = torch.rand((TIMED_ROWS, N_IN), generator=g, device=dev)
    labels = torch.randint(0, N_OUT, (TIMED_ROWS,), generator=g, device=dev)
    T = -torch.ones((TIMED_ROWS, N_OUT), device=dev)
    T[torch.arange(TIMED_ROWS, device=dev), labels] = 1.0
    perm = np.resize(np.random.RandomState(SEED).permutation(TIMED_ROWS), S * BATCH)
    perm = torch.from_numpy(perm).to(dev)
    order = np.random.RandomState(SEED + 1).permutation(S)
    k, _ = km.generate(SEED, N_IN, [N_HID], N_OUT)
    w = list(km.to_torch(k.weights, device=dev, dtype=torch.float32)[0])
    return X[perm], T[perm], order, w, S


def ktile_split(np, torch, dev, Xp, Tp, order, w, S):
    """A #4 step on the grid (ANN-BP 784-300-10, B = 256, phase 9's
    epoch) by phase, and its tiles' k-tiles by part, in float32 and in
    bf16, each from the phase-clock build's second epoch, timed with CUDA
    events around that epoch.  Rank 0's thread 0 clocks; the cycles of
    its whole epoch over the epoch's time give the SM clock that turns a
    k-tile's cycles into ns."""
    from hpnn_tpu_torch.ops import batch_step as bs

    kw = dict(model="ann", momentum=False)
    out = {}
    for label in ("float32", "bf16"):
        dtype = torch.float32 if label == "float32" else torch.bfloat16
        X, T = Xp.to(dtype), Tp.to(dtype)
        wc = [t.to(dtype, copy=True) for t in w]

        def timed_epoch():
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            losses = bs.train_epoch_grid_banked(wc, [], X, T, order, batch=BATCH, **kw)[2]
            e1.record()
            return losses, e0, e1

        bs.phase_clocks(timed_epoch)  # a warm-up epoch (the first also loads the build)
        (losses, e0, e1), clocks, parts = bs.phase_clocks(timed_epoch)
        ms = e0.elapsed_time(e1)
        check(torch.isfinite(losses).all() and all(torch.isfinite(t.float()).all() for t in wc),
              f"k-tile split, {label}: not finite")
        cyc = sum(clocks.values())
        n_kt = parts.pop(bs.KTILES)
        ghz = cyc / (ms * 1e6)
        split = {k: v / cyc * ms / S * 1e3 for k, v in clocks.items() if v}
        per_kt = {k: v / n_kt / ghz for k, v in parts.items()}
        out[label] = dict(epoch_ms=ms, us_per_step=split, ktiles=n_kt,
                          sm_ghz=ghz, ns_per_ktile=per_kt, clocks=clocks, ktile_clocks=parts)
        log(f"[batch-timing] k-tile split, #4 {label} (its epoch "
            f"{ms:.3f} ms, {ms / S * 1e3:.2f} us/step; SM clock {ghz:.3f} GHz from rank 0's "
            f"cycles): us/step by phase " + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
            + f"; {n_kt} k-tiles of rank 0's thread 0, ns a k-tile by part: "
            + ", ".join(f"{k} {v:.1f}" for k, v in per_kt.items())
            + f" ({sum(per_kt.values()):.1f} in all)")
    return out


def batch_timing(np, torch, dev, phase_split=False):
    """Phase 9: each entry point over one epoch of a 60000-row bank at
    784-300-10 ANN-BP float32, its plain version, and the bound; with
    ``phase_split``, where a #4 step's time goes on each team, and the
    k-tile split of float32 and bf16 (``ktile_split``)."""
    from hpnn_tpu_torch.obs.cost import batch_work, bound_ms
    from hpnn_tpu_torch.ops import batch_step as bs

    Xp, Tp, order, w, S = timing_bank(np, torch, dev)
    kw = dict(model="ann", momentum=False)

    def rows(b):
        return slice(int(b) * BATCH, (int(b) + 1) * BATCH)

    def on_team(c, fn):
        """``fn`` on the grid (c = 0) or on one cluster of c CTAs."""
        def run():
            with bs._cluster_team(c) if c else contextlib.nullcontext():
                return fn()
        return run

    entry_fns = {
        "train_step_fused_batch": lambda: [bs.train_step_fused_batch(
            w, [], Xp[rows(b)], Tp[rows(b)], **kw) for b in order],
        "train_step_fused_banked": lambda: [bs.train_step_fused_banked(
            w, [], Xp, Tp, int(b), batch=BATCH, **kw) for b in order],
        "train_epoch_grid_banked": lambda: bs.train_epoch_grid_banked(
            w, [], Xp, Tp, order, batch=BATCH, **kw),
        "train_epoch_dbuf_banked": lambda: bs.train_epoch_dbuf_banked(
            w, [], Xp, Tp, order, batch=BATCH, **kw),
    }

    # the entry points' team, the grid (0), and the other: one 16-CTA cluster
    teams = (0, 16)
    fns = {(name, c): on_team(c, fn) for c in teams for name, fn in entry_fns.items()}
    times = {key: [] for key in fns}
    for turn in range(2):  # in turns, the second in the reverse order
        for key in (list(fns) if turn == 0 else list(fns)[::-1]):
            times[key].append(cuda_ms(torch, fns[key]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bs.train_epoch_grid_banked_plain(w, [], Xp, Tp, order, batch=BATCH, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(all(torch.isfinite(t).all() for t in w), "timing: weights not finite")
    nbytes, flops = batch_work([tuple(t.shape) for t in w], S, False, 4, BATCH)
    b_ms, b_by = bound_ms(nbytes, flops, "float32")

    def team_name(c):
        return f"one {c}-CTA cluster" if c else "the grid"

    out = {}
    for name, _, _ in BATCH_KERNELS:
        ts, other = times[(name, teams[0])], times[(name, teams[1])]
        ms, other_ms = statistics.median(ts), statistics.median(other)
        out[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                         runs_ms=ts, us_per_step=ms / S * 1e3, team=team_name(teams[0]),
                         other_team=team_name(teams[1]), other_team_ms=other_ms,
                         other_team_runs_ms=other)
        log(f"[batch-timing] {name}: one epoch of {S} steps, B={BATCH}, "
            f"{TIMED_ROWS}-row bank, ANN-BP 784-300-10 float32: {ms:.3f} ms on "
            f"{team_name(teams[0])} ({ms / S * 1e3:.2f} us/step; runs "
            f"{', '.join(f'{t:.3f}' for t in ts)}); {other_ms:.3f} ms on "
            f"{team_name(teams[1])} (runs {', '.join(f'{t:.3f}' for t in other)})")
    log(f"[batch-timing] plain epoch {plain_ms:.1f} ms; bound {b_ms:.4f} ms "
        f"({b_by}: {nbytes} B, {flops} flop; {b_ms / S * 1e3:.2f} us/step)")
    if phase_split:
        # the phase-clock build on the same inputs (bitwise the kernel's),
        # its cycles shared out over the measured time of a step
        for c in teams:
            def epoch(wc, c=c):
                return on_team(c, lambda: bs.train_epoch_grid_banked(
                    wc, [], Xp, Tp, order, batch=BATCH, **kw)[2])()

            wa, wb = [t.clone() for t in w], [t.clone() for t in w]
            la, clocks, _ = bs.phase_clocks(lambda: epoch(wa))
            lb = epoch(wb)
            check(all(torch.equal(a, b) for a, b in zip([la] + wa, [lb] + wb)),
                  f"the batch-step phase-clock build differs bitwise on {team_name(c)}")
            ms = statistics.median(times[("train_epoch_grid_banked", c)])
            cyc = sum(clocks.values())
            split = {k: v / cyc * ms / S * 1e3 for k, v in clocks.items() if v}
            out["train_epoch_grid_banked"].setdefault("split_us_per_step", {})[team_name(c)] = split
            log(f"[batch-timing] #4 on {team_name(c)}: us/step by phase (rank 0's thread 0, "
                f"sync waits included): " + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
        out["train_epoch_grid_banked"]["ktile_split"] = ktile_split(
            np, torch, dev, Xp, Tp, order, [t.clone() for t in w], S)
    # where a step's time goes: the grid epoch's time per step against
    # the rows per step (SCALING_STEPS leading blocks of the bank)
    scaling = {}
    for b in SCALING_B:
        ms = cuda_ms(torch, lambda: bs.train_epoch_grid_banked(
            w, [], Xp, Tp, np.arange(SCALING_STEPS), batch=b, **kw))
        scaling[b] = ms / SCALING_STEPS * 1e3
    log("[batch-timing] grid epoch, us per step by rows per step: "
        + ", ".join(f"B={b} {us:.2f}" for b, us in scaling.items()))
    return out


# ---------------------------------------------------------- fleet phases
def fleet_pinned(np, torch, dev):
    """Phase 10: the fleet epoch (#6) against its plain version, then
    the bitwise agreements with #5 and #4; then the bf16 build.  Returns
    ({dtype: max error}, the bf16 build's errors)."""
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.ops import batch_step as bs

    rng = np.random.default_rng(SEED + 10)
    err = {"float32": 0.0, "float64": 0.0}
    for shape, momentum in (((N_IN, N_HID, N_OUT), False), (XRD, True)):
        ks = [km.generate(SEED + i, shape[0], [shape[1]], shape[2])[0] for i in range(FLEET_N)]
        W = [np.stack([k.weights[l] for k in ks]) for l in range(2)]
        dW = [rng.uniform(-1e-3, 1e-3, w.shape) for w in W] if momentum else None
        banks = [batch_bank(np, rng, shape, PINNED_S * BATCH) for _ in range(FLEET_N)]
        orders = np.stack([rng.permutation(PINNED_S) for _ in range(FLEET_N)])
        for model in ("ann", "snn"):
            kw = dict(batch=BATCH, model=model, momentum=momentum)
            for dtype in (torch.float32, torch.float64):
                dname = str(dtype).split(".")[1]
                tag = (f"{model}-{'BPM' if momentum else 'BP'} "
                       f"{'-'.join(map(str, shape))} {dname}")
                Xd = torch.tensor(np.stack([x for x, _ in banks]), dtype=dtype, device=dev)
                Td = torch.tensor(np.stack([t for _, t in banks]), dtype=dtype, device=dev)

                def fresh():
                    w, dw = km.to_torch(W, dW, device=dev, dtype=dtype)
                    return list(w), list(dw)

                (wk, dwk), (wp, dwp), (w2, dw2), (w0, dw0) = fresh(), fresh(), fresh(), fresh()
                lk = bs.train_fleet_epoch_dbuf_banked(wk, dwk, Xd, Td, orders, **kw)[2]
                lp = bs.train_fleet_epoch_dbuf_banked_plain(wp, dwp, Xd, Td, orders, **kw)[2]
                torch.cuda.synchronize()
                e = max(state_err(wk + dwk, wp + dwp), loss_err(lk, lp))
                tol = BATCH_TOL[(dname, "epoch")]
                check(math.isfinite(e) and e <= tol,
                      f"fleet {tag}: {PINNED_S} steps |kernel - plain| {e:.3e} > {tol:.0e}")
                err[dname] = max(err[dname], e)
                # bitwise: #6 again, and each member's #5 and #4 epochs
                l2 = bs.train_fleet_epoch_dbuf_banked(w2, dw2, Xd, Td, orders, **kw)[2]
                check(all(torch.equal(a, b) for a, b in zip(wk + dwk + [lk], w2 + dw2 + [l2])),
                      f"fleet {tag}: #6 run again differs bitwise")
                for C in (bs.GRID,) + bs.CLUSTER_SIZES:
                    wc, dwc = fresh()
                    lc = bs.train_fleet_epoch_dbuf_banked(wc, dwc, Xd, Td, orders, cluster=C,
                                                          **kw)[2]
                    check(all(torch.equal(a, b) for a, b in zip(wk + dwk + [lk], wc + dwc + [lc])),
                          f"fleet {tag}: #6 on {fleet_team_name(C)} differs bitwise from the "
                          f"plan's")
                for i in range(FLEET_N):
                    for fn in (bs.train_epoch_dbuf_banked, bs.train_epoch_grid_banked):
                        wi, dwi = [t[i].clone() for t in w0], [t[i].clone() for t in dw0]
                        li = fn(wi, dwi, Xd[i], Td[i], orders[i], **kw)[2]
                        check(torch.equal(li, lk[i])
                              and all(torch.equal(a, b[i]) for a, b in zip(wi + dwi, wk + dwk)),
                              f"fleet {tag}: member {i} differs bitwise from {fn.__name__}")
                plan = bs.fleet_cluster(FLEET_N, [tuple(t.shape[1:]) for t in wk], BATCH,
                                        bs.cluster_capacity(dtype, dev))
                log(f"[fleet-pinned] {tag}, N={FLEET_N} B={BATCH} S={PINNED_S}: "
                    f"max|kernel - plain| {e:.2e} (tol {tol:.0e}); member i == #5 == #4 "
                    f"on bank i, #6 == #6 again, #6 on the grid and at C = "
                    f"{', '.join(map(str, bs.CLUSTER_SIZES))} == #6 planned "
                    f"({fleet_team_name(plan)}) (bitwise)")
    return err, fleet_pinned_bf16(np, torch, dev, rng)


def fleet_pinned_bf16(np, torch, dev, rng):
    """Phase 10, the bf16 build of #6 (its products on the tensor cores)
    at 784-300-10 and 851-230-230, ANN/SNN x BP/BPM, against its plain
    version on the same bf16 inputs (``BF16_BAND``); bitwise: #6 run
    again, #6 at every cluster size against the plan, member i against
    bf16 #5 and #4 on bank i, and #6 on each member's first block alone
    against bf16 #2 and #3 on it; then ``quant_probe_fleet`` (bf16
    against float32) on the card.  Returns the errors."""
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.ops import batch_step as bs
    from hpnn_tpu_torch.train import fleet

    bf16 = torch.bfloat16
    out = {"w": 0.0, "loss_rel": 0.0, "update_rel": 0.0}
    for shape in ((N_IN, N_HID, N_OUT), XRD):
        ks = [km.generate(SEED + i, shape[0], [shape[1]], shape[2])[0] for i in range(FLEET_N)]
        W = [np.stack([k.weights[l] for k in ks]) for l in range(2)]
        dW = [rng.uniform(-1e-3, 1e-3, w.shape) for w in W]
        banks = [batch_bank(np, rng, shape, PINNED_S * BATCH) for _ in range(FLEET_N)]
        orders = np.stack([rng.permutation(PINNED_S) for _ in range(FLEET_N)])
        Xd = torch.tensor(np.stack([x for x, _ in banks]), dtype=bf16, device=dev)
        Td = torch.tensor(np.stack([t for _, t in banks]), dtype=bf16, device=dev)
        for model, momentum in (("ann", False), ("ann", True), ("snn", False), ("snn", True)):
            kw = dict(batch=BATCH, model=model, momentum=momentum)
            tag = f"{model}-{'BPM' if momentum else 'BP'} {'-'.join(map(str, shape))} bf16"

            def fresh():
                return ([torch.tensor(w, dtype=bf16, device=dev) for w in W],
                        [torch.tensor(m, dtype=bf16, device=dev) for m in dW] if momentum
                        else [])

            def same(a, b):
                return all(torch.equal(x, y) for x, y in zip(a, b))

            (wk, dwk), (wp, dwp), (w0, dw0) = fresh(), fresh(), fresh()
            lk = bs.train_fleet_epoch_dbuf_banked(wk, dwk, Xd, Td, orders, **kw)[2]
            lp = bs.train_fleet_epoch_dbuf_banked_plain(wp, dwp, Xd, Td, orders, **kw)[2]
            torch.cuda.synchronize()
            check(lk.dtype == torch.float32 and wk[0].dtype == bf16,
                  f"fleet {tag}: losses {lk.dtype}, weights {wk[0].dtype}")
            we = state_err([t.float() for t in wk + dwk], [t.float() for t in wp + dwp])
            ue = update_err(wk, wp, w0)
            le = float(((lk - lp).abs() / lp.abs()).max())
            check(math.isfinite(we) and we <= BF16_BAND["w"],
                  f"fleet {tag}: |kernel - plain| weights {we:.3e} > {BF16_BAND['w']:.0e}")
            check(math.isfinite(ue) and ue <= BF16_BAND["update_rel"],
                  f"fleet {tag}: the kernel's change of a layer is {ue:.3e} of plain's away "
                  f"from it (> {BF16_BAND['update_rel']})")
            check(math.isfinite(le) and le <= BF16_BAND["loss_rel"],
                  f"fleet {tag}: |kernel - plain| losses {le:.3e} relative > "
                  f"{BF16_BAND['loss_rel']:.0e}")
            check(all(not torch.equal(a, b) for a, b in zip(wk, w0)),
                  f"fleet {tag}: the kernel left a layer unchanged")
            out["w"], out["loss_rel"] = max(out["w"], we), max(out["loss_rel"], le)
            out["update_rel"] = max(out["update_rel"], ue)
            # bitwise: #6 again and at every cluster size
            for C in (None, bs.GRID) + bs.CLUSTER_SIZES:
                wc, dwc = fresh()
                lc = bs.train_fleet_epoch_dbuf_banked(wc, dwc, Xd, Td, orders, cluster=C,
                                                      **kw)[2]
                check(same(wk + dwk + [lk], wc + dwc + [lc]),
                      f"fleet {tag}: #6 " + ("run again" if C is None else
                                             f"on {fleet_team_name(C)}")
                      + " differs bitwise from the plan's")
            # member i against #5 and #4 on its bank, and #6 on each
            # member's first block against #2 and #3 on it
            w1, dw1 = fresh()
            l1 = bs.train_fleet_epoch_dbuf_banked(w1, dw1, Xd, Td, orders[:, :1], **kw)[2]
            for i in range(FLEET_N):
                for fn in (bs.train_epoch_dbuf_banked, bs.train_epoch_grid_banked):
                    wi, dwi = [t[i].clone() for t in w0], [t[i].clone() for t in dw0]
                    li = fn(wi, dwi, Xd[i], Td[i], orders[i], **kw)[2]
                    check(torch.equal(li, lk[i]) and same(wi + dwi, [t[i] for t in wk + dwk]),
                          f"fleet {tag}: member {i} differs bitwise from bf16 {fn.__name__}")
                k = int(orders[i][0])
                rows = slice(k * BATCH, (k + 1) * BATCH)
                step = dict(model=model, momentum=momentum)
                for name, call in (
                        ("#2", lambda wi, dwi: bs.train_step_fused_batch(
                            wi, dwi, Xd[i][rows].contiguous(), Td[i][rows].contiguous(),
                            **step)),
                        ("#3", lambda wi, dwi: bs.train_step_fused_banked(
                            wi, dwi, Xd[i], Td[i], k, **kw))):
                    wi, dwi = [t[i].clone() for t in w0], [t[i].clone() for t in dw0]
                    li = call(wi, dwi)[2]
                    check(torch.equal(li, l1[i][0]) and same(wi + dwi, [t[i] for t in w1 + dw1]),
                          f"fleet {tag}: member {i}'s first block differs bitwise from "
                          f"bf16 {name}")
            plan = bs.fleet_cluster(FLEET_N, [tuple(t.shape[1:]) for t in wk], BATCH,
                                    bs.cluster_capacity(bf16, dev))
            log(f"[fleet-pinned] {tag}, N={FLEET_N} B={BATCH} S={PINNED_S}: max|kernel - "
                f"plain| weights {we:.3e} (band {BF16_BAND['w']:.0e}), each layer's change "
                f"{ue:.3e} relative (band {BF16_BAND['update_rel']}), losses {le:.3e} "
                f"relative (band {BF16_BAND['loss_rel']:.0e}); bitwise: #6 == #6 again, #6 at "
                f"the grid and C = {', '.join(map(str, bs.CLUSTER_SIZES))} == #6 planned "
                f"({fleet_team_name(plan)}), "
                f"member i == bf16 #5 == #4 on bank i, first block == #2 == #3")
    # the fleet's quant probe: the same plan in float32 and in bf16
    shape = (N_IN, N_HID, N_OUT)
    ks = [km.generate(SEED + i, N_IN, [N_HID], N_OUT)[0] for i in range(FLEET_N)]
    X, T = batch_bank(np, rng, shape, 8 * BATCH)
    t0 = time.perf_counter()
    _, _, qerr = fleet.quant_probe_fleet(ks, X, T, epochs=2, batch=BATCH, lr=FLEET_LR)
    check(0.0 < qerr < QUANT_ERR_BAR,
          f"quant_probe_fleet bf16 vs float32 err {qerr:.3e} not in (0, {QUANT_ERR_BAR})")
    out["quant_err"] = qerr
    log(f"[fleet-pinned] quant_probe_fleet {FLEET_N} x 784-300-10 ANN-BP, {8 * BATCH} rows, "
        f"B={BATCH}, 2 epochs: bf16 vs float32 weights max|diff| {qerr:.3e} (bar "
        f"{QUANT_ERR_BAR:.0e}) in {time.perf_counter() - t0:.2f} s")
    return out


def fleet_main(np, torch, dev, protos):
    """Phase 11: the fleet path through ``train.fleet``.  Returns
    (launches by entry point over the whole phase, statistics)."""
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.ops import batch_step as bs
    from hpnn_tpu_torch.train import fleet

    rng = np.random.default_rng(SEED + 11)
    X, T = make_dataset(np, rng, FLEET_ROWS, protos)
    ks = [km.generate(SEED + i, N_IN, [N_HID], N_OUT)[0] for i in range(FLEET_MAIN_N)]
    N, E, S = FLEET_MAIN_N, FLEET_EPOCHS, FLEET_ROWS // BATCH
    seeds = list(range(N))
    kw = dict(epochs=E, batch=BATCH, lr=FLEET_LR)
    stats = {}

    def run(label, fn, expect):
        before = dict(bs.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launched = {k: bs.launches[k] - before[k] for k in bs.launches
                    if bs.launches[k] != before[k]}
        check(launched == expect, f"fleet {label}: launches {launched}, expected {expect}")
        stats[label] = dict(seconds=secs, launches=launched)
        return res

    def same(a, b):
        return (all(np.array_equal(x, y) for ka, kb in zip(a[0], b[0])
                    for x, y in zip(ka.weights, kb.weights))
                and np.array_equal(a[1], b[1]) and np.array_equal(a[2], b[2]))

    for name in bs.launches:
        bs.launches[name] = 0
    fl = run("fleet", lambda: fleet.train_fleet(ks, X, T, seeds=seeds, **kw),
             {"train_fleet_epoch_dbuf_banked": E})
    _, losses, counts = fl
    check(losses.shape == (N, E, S) and counts.shape == (N, E), "fleet: result shapes")
    check(np.isfinite(losses).all(), "fleet: loss not finite")
    by_epoch = losses.mean(axis=2)              # (N, E)
    check((by_epoch[:, -1] < by_epoch[:, 0]).all(), "fleet: a member's loss did not fall")
    check(counts[:, 0].max() < FLEET_ROWS,
          "fleet: a member counted every row after one epoch, so counts cannot tell runs apart")
    log(f"[fleet-main] train_fleet {N} x 784-300-10 ANN-BP, {FLEET_ROWS} rows, B={BATCH}, "
        f"{E} epochs, lr {FLEET_LR}: {stats['fleet']['seconds']:.2f} s, mean loss "
        f"{by_epoch[:, 0].mean():.6f} -> {by_epoch[:, -1].mean():.6f}, count "
        f"{counts[:, 0].min()}..{counts[:, 0].max()} -> {counts[:, -1].min()}.."
        f"{counts[:, -1].max()}/{FLEET_ROWS}, launches {stats['fleet']['launches']}")
    sq = run("sequential", lambda: fleet.train_sequential(ks, X, T, seeds=seeds, **kw),
             {"train_epoch_grid_banked": N * E})
    check(same(fl, sq), "train_sequential differs bitwise from train_fleet")
    mr = run("multi K=2", lambda: fleet.train_fleet_multi(ks, X, T, rounds=2, **kw),
             {"train_fleet_epoch_dbuf_banked": 2 * E})
    # round 0 of the default seed_rounds is the fleet run above
    r1 = run("round 2 of 2 chained", lambda: fleet.train_fleet(
        fl[0], X, T, seeds=list(range(N, 2 * N)), **kw), {"train_fleet_epoch_dbuf_banked": E})
    check(same((mr[0], mr[1][:, 1], mr[2][:, 1]), r1)
          and np.array_equal(mr[1][:, 0], fl[1]) and np.array_equal(mr[2][:, 0], fl[2]),
          "train_fleet_multi (2 rounds) differs bitwise from 2 chained train_fleet calls")
    log(f"[fleet-main] bitwise: train_sequential == train_fleet ({stats['sequential']['seconds']:.2f} s, "
        f"{N * E} launches of #4); train_fleet_multi 2 rounds == 2 chained train_fleet "
        f"({stats['multi K=2']['seconds']:.2f} s)")
    cpu = run("cpu f64", lambda: fleet.train_fleet(ks, X, T, seeds=seeds, device="cpu", **kw), {})
    rel = float(np.max(np.abs(fl[1] - cpu[1]) / np.abs(cpu[1])))
    dok = int(np.max(np.abs(fl[2].astype(np.int64) - cpu[2])))
    check(rel <= BAND_LOSS_REL, f"fleet card f32 vs cpu f64: loss rel diff {rel:.3e}")
    check(dok <= max(2, BAND_COUNT_REL * FLEET_ROWS), f"fleet card f32 vs cpu f64: count diff {dok}")
    stats["band"] = dict(max_loss_rel=rel, max_count_diff=dok)
    log(f"[fleet-main] card f32 vs cpu f64 ({stats['cpu f64']['seconds']:.2f} s): max loss rel "
        f"diff {rel:.3e} over every member, epoch and step (band {BAND_LOSS_REL:.0e}), "
        f"max count diff {dok}")

    # the HPNN-sized fleet of bench.py: one new sample per member and tick
    n_m, (hi, hh, ho), ticks = HPNN_FLEET
    hks = [km.generate(1000 + i, hi, [hh], ho)[0] for i in range(n_m)]
    Xh = torch.tensor(rng.normal(size=(1, hi)), dtype=torch.float32, device=dev)
    Th = -torch.ones((1, ho), dtype=torch.float32, device=dev)
    Th[0, int(rng.integers(0, ho))] = 1.0
    fperms, forders = fleet.fleet_plan(range(n_m), n_rows=1, batch=1, epochs=1)
    plans = [fleet.member_plan(i, n_rows=1, batch=1, epochs=1) for i in range(n_m)]
    fleet_fn = fleet.make_fleet_epoch_fn(1, count=False)
    member_fn = fleet.make_member_epoch_fn(1, count=False)
    stacked = fleet.stack_kernels(hks, dtype=torch.float32)
    members = [km.to_torch(k.weights, device=dev, dtype=torch.float32)[0] for k in hks]

    def fleet_ticks():
        for _ in range(ticks):
            fleet_fn(stacked, (), Xh, Th, fperms, forders)

    def sequential_ticks():
        for _ in range(ticks):
            for w, (p, o) in zip(members, plans):
                member_fn(w, (), Xh, Th, p, o)

    tick = {}
    for label, fn, expect in (
            ("hpnn fleet", fleet_ticks, {"train_fleet_epoch_dbuf_banked": ticks}),
            ("hpnn sequential", sequential_ticks, {"train_epoch_grid_banked": n_m * ticks}),
            ("hpnn fleet again", fleet_ticks, {"train_fleet_epoch_dbuf_banked": ticks}),
            ("hpnn sequential again", sequential_ticks, {"train_epoch_grid_banked": n_m * ticks})):
        run(label, fn, expect)
        tick[label] = stats[label]["seconds"] / ticks * 1e3
    check(all(torch.equal(s[i], w) for i, ws in enumerate(members) for s, w in zip(stacked, ws)),
          "HPNN-sized fleet differs bitwise from its members run one by one")
    check(not any(torch.equal(s[i], torch.tensor(w, dtype=torch.float32, device=dev))
                  for i, k in enumerate(hks) for s, w in zip(stacked, k.weights)),
          f"HPNN-sized fleet: a member's layer did not move in {2 * ticks} ticks")
    stats["hpnn_ms_per_tick"] = tick
    log(f"[fleet-main] HPNN-sized fleet, {n_m} x {hi}-{hh}-{ho} ANN-BP, B=1, {ticks} ticks x2, "
        f"bitwise equal, every layer of every member moved: fleet {tick['hpnn fleet']:.3f} / "
        f"{tick['hpnn fleet again']:.3f} ms a tick (1 launch), sequential "
        f"{tick['hpnn sequential']:.3f} / {tick['hpnn sequential again']:.3f} ms a tick "
        f"({n_m} launches)")
    path_launches = dict(bs.launches)
    stats["hpnn_vs_plain"] = hpnn_tick_vs_plain(np, torch, dev, rng, hks)

    # the bf16 fleet's main path: its own launch counts, from 0
    for name in bs.launches:
        bs.launches[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bf = fleet.train_fleet(ks, X, T, seeds=seeds, dtype="bf16", **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launched = {k: v for k, v in bs.launches.items() if v}
    check(launched == {"train_fleet_epoch_dbuf_banked": E},
          f"bf16 fleet: launches {launched}, expected {E} of #6")
    _, bl, bc = bf
    check(bl.dtype == np.float32 and bl.shape == (N, E, S) and np.isfinite(bl).all(),
          "bf16 fleet: losses not finite float32 of the fleet's shape")
    b_epoch = bl.mean(axis=2)
    check((b_epoch[:, -1] < b_epoch[:, 0]).all(), "bf16 fleet: a member's loss did not fall")
    werr = max(float(np.max(np.abs(a - b))) for ka, kb in zip(bf[0], fl[0])
               for a, b in zip(ka.weights, kb.weights))
    check(werr < BF16_VS_F32_W,
          f"bf16 fleet: weights {werr:.3e} from the float32 fleet's (band {BF16_VS_F32_W:.0e})")
    stats["bf16"] = dict(seconds=secs, launches=launched, w_vs_f32=werr,
                         loss_first=float(b_epoch[:, 0].mean()),
                         loss_last=float(b_epoch[:, -1].mean()))
    log(f"[fleet-main] train_fleet dtype=bf16, the same {N} members and plan: {secs:.2f} s, "
        f"launches {launched}, mean loss {b_epoch[:, 0].mean():.6f} -> "
        f"{b_epoch[:, -1].mean():.6f} (float32: {by_epoch[:, -1].mean():.6f}), count "
        f"{bc[:, -1].min()}..{bc[:, -1].max()}/{FLEET_ROWS}, weights max|bf16 - f32| "
        f"{werr:.3e} (band {BF16_VS_F32_W:.0e})")
    return path_launches, stats


def hpnn_tick_vs_plain(np, torch, dev, rng, hks):
    """#6 against its plain version on one tick of the HPNN-sized fleet
    (B = 1, S = 1: one row a step, one-row tiles, the loss warp over one
    row), ANN/SNN x BP/BPM, float and double, on the same stacked
    weights, banks and orders; the kernel's weights must have moved.
    Returns {dtype: max error}."""
    from hpnn_tpu_torch.ops import batch_step as bs

    n_m = len(hks)
    (n_hid, n_in), (n_out, _) = (w.shape for w in hks[0].weights)
    W = [np.stack([k.weights[l] for k in hks]) for l in range(2)]
    dW = [rng.uniform(-1e-3, 1e-3, w.shape) for w in W]
    X = rng.normal(size=(n_m, 1, n_in))
    T = -np.ones((n_m, 1, n_out))
    T[np.arange(n_m), 0, rng.integers(0, n_out, n_m)] = 1.0
    orders = np.zeros((n_m, 1), dtype=np.int64)
    err = {"float32": 0.0, "float64": 0.0}
    for model in ("ann", "snn"):
        for momentum in (False, True):
            kw = dict(batch=1, model=model, momentum=momentum)
            for dtype in (torch.float32, torch.float64):
                dname = str(dtype).split(".")[1]
                tag = f"{model}-{'BPM' if momentum else 'BP'} {dname}"
                Xd = torch.tensor(X, dtype=dtype, device=dev)
                Td = torch.tensor(T, dtype=dtype, device=dev)

                def fresh():
                    return ([torch.tensor(w, dtype=dtype, device=dev) for w in W],
                            [torch.tensor(m, dtype=dtype, device=dev) for m in dW]
                            if momentum else [])

                (w0, dw0), (wk, dwk), (wp, dwp) = fresh(), fresh(), fresh()
                lk = bs.train_fleet_epoch_dbuf_banked(wk, dwk, Xd, Td, orders, **kw)[2]
                lp = bs.train_fleet_epoch_dbuf_banked_plain(wp, dwp, Xd, Td, orders, **kw)[2]
                torch.cuda.synchronize()
                e = max(state_err(wk + dwk, wp + dwp), loss_err(lk, lp))
                tol = BATCH_TOL[(dname, "step")]
                check(math.isfinite(e) and e <= tol,
                      f"HPNN-sized tick {tag}: |kernel - plain| {e:.3e} > {tol:.0e}")
                check(all(not torch.equal(a[i], b[i]) for a, b in zip(wk + dwk, w0 + dw0)
                          for i in range(n_m)),
                      f"HPNN-sized tick {tag}: the kernel left a member's state unchanged")
                err[dname] = max(err[dname], e)
    log(f"[fleet-main] HPNN-sized tick, #6 vs plain, N={n_m} B=1 S=1, ANN/SNN x BP/BPM: "
        f"max|kernel - plain| f32 {err['float32']:.2e} (tol {BATCH_TOL[('float32', 'step')]:.0e}), "
        f"f64 {err['float64']:.2e} (tol {BATCH_TOL[('float64', 'step')]:.0e}); every member's "
        f"weights (and dw) moved")
    return err


def fleet_banks(np, torch, dev, n_max):
    """Phase 12's inputs: the stacked float32 weights of n_max generated
    784-300-10 ANNs, each member's permuted 60000-row bank (its tail
    wrapped as train_kernel_batched does; the first N members' banks are
    a leading slice), their block orders, and S."""
    from hpnn_tpu_torch.models import kernel as km

    S = math.ceil(TIMED_ROWS / BATCH)
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 12)
    X = torch.rand((TIMED_ROWS, N_IN), generator=g, device=dev)
    labels = torch.randint(0, N_OUT, (TIMED_ROWS,), generator=g, device=dev)
    T = -torch.ones((TIMED_ROWS, N_OUT), device=dev)
    T[torch.arange(TIMED_ROWS, device=dev), labels] = 1.0
    ks = [km.generate(SEED + i, N_IN, [N_HID], N_OUT)[0] for i in range(n_max)]
    perm = np.stack([np.resize(np.random.RandomState(SEED + i).permutation(TIMED_ROWS),
                               S * BATCH) for i in range(n_max)])
    idx = torch.from_numpy(perm).to(dev)
    orders = np.stack([np.random.RandomState(SEED + 100 + i).permutation(S)
                       for i in range(n_max)])
    W = [torch.tensor(np.stack([k.weights[l] for k in ks]), dtype=torch.float32, device=dev)
         for l in range(2)]
    return W, X[idx], T[idx], orders, S


def fleet_timing(np, torch, dev):
    """Phase 12: #6 over one epoch of each member's 60000-row bank,
    ANN-BP 784-300-10 float32, for FLEET_TIMED_N members at every
    cluster size; against its plain version (the first N), its bound and
    the members' #5 epochs one after another.  Then #6 as planned for
    FLEET_CROSS_N members against N times one #5 epoch, and bf16 #6 for
    the first N in turns with float32 #6.  Returns ({N: timings},
    crossover, the bf16 timings)."""
    from hpnn_tpu_torch.obs.cost import batch_work, bound_ms
    from hpnn_tpu_torch.ops import batch_step as bs

    n_max = max(FLEET_TIMED_N + FLEET_CROSS_N)
    W_all, Xb_all, Tb_all, orders_all, S = fleet_banks(np, torch, dev, n_max)
    shapes = [tuple(t.shape[1:]) for t in W_all]
    kw = dict(batch=BATCH, model="ann", momentum=False)
    cap = bs.cluster_capacity(torch.float32, dev)
    log(f"[fleet-timing] clusters the card holds at once, by CTAs a cluster: "
        + ", ".join(f"{C}: {n}" for C, n in cap.items()))

    def fleet_fn(W, N, C):
        return lambda: bs.train_fleet_epoch_dbuf_banked(
            W, [], Xb_all[:N], Tb_all[:N], orders_all[:N], cluster=C, **kw)

    out = {}
    for N in FLEET_TIMED_N:
        W = [t[:N].clone() for t in W_all]
        members = [[t[i].clone() for t in W] for i in range(N)]
        plan = bs.fleet_cluster(N, shapes, BATCH, cap)
        fns = {C: fleet_fn(W, N, C) for C in (bs.GRID,) + bs.CLUSTER_SIZES}
        runs, seq = {C: [] for C in fns}, []
        for turn in range(2):  # in turns, the second in the reverse order
            for C in (list(fns) if turn == 0 else list(fns)[::-1]):
                runs[C].append(cuda_ms(torch, fns[C]))
            seq.append(cuda_ms(torch, lambda: [bs.train_epoch_dbuf_banked(
                members[i], [], Xb_all[i], Tb_all[i], orders_all[i], **kw) for i in range(N)]))
        by_c = {C: statistics.median(v) for C, v in runs.items()}
        ms, seq_ms = by_c[plan], statistics.median(seq)
        nbytes, flops = batch_work(shapes, S, False, 4, BATCH)
        b_ms, b_by = bound_ms(N * nbytes, N * flops, "float32")
        plain_ms = None
        if N == FLEET_TIMED_N[0]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bs.train_fleet_epoch_dbuf_banked_plain(W, [], Xb_all[:N], Tb_all[:N],
                                                   orders_all[:N], **kw)
            torch.cuda.synchronize()
            plain_ms = (time.perf_counter() - t0) * 1e3
        check(all(torch.isfinite(t).all() for t in W), "fleet timing: weights not finite")
        out[N] = dict(ms=ms, cluster=plan, ms_by_cluster=by_c, runs_by_cluster=runs,
                      sequential_dbuf_ms=seq_ms, sequential_runs_ms=seq, plain_ms=plain_ms,
                      bound_ms=b_ms, bound_by=b_by, ms_per_step=ms / S,
                      bank_bytes=(Xb_all[:N].numel() + Tb_all[:N].numel()) * 4)
        log(f"[fleet-timing] #6, {N} members x one epoch of {S} steps, B={BATCH}, "
            f"{TIMED_ROWS}-row banks ({out[N]['bank_bytes'] / 1e9:.2f} GB), ANN-BP 784-300-10 "
            f"float32, by team: "
            + ", ".join(f"{fleet_team_name(C)} {v:.3f} ms (runs "
                        f"{', '.join(f'{t:.3f}' for t in runs[C])})" for C, v in by_c.items())
            + f"; planned {fleet_team_name(plan)}: {ms:.3f} ms ({ms / S:.4f} ms/step); "
            f"{N} sequential #5 "
            f"epochs {seq_ms:.3f} ms (runs {', '.join(f'{t:.3f}' for t in seq)}); bound "
            f"{b_ms:.4f} ms ({b_by})"
            + (f"; plain {plain_ms:.1f} ms" if plain_ms is not None else ""))
        del W, members
    bf16_times = fleet_timing_bf16(np, torch, dev, W_all, Xb_all, Tb_all, orders_all,
                                   shapes, S, kw, cap)
    # where the fleet overtakes its members' #5 epochs one after another
    one = [t[0].clone() for t in W_all]
    t5 = statistics.median(cuda_ms(torch, lambda: bs.train_epoch_dbuf_banked(
        one, [], Xb_all[0], Tb_all[0], orders_all[0], **kw)) for _ in range(2))
    cross = {}
    for N in FLEET_CROSS_N:
        plan = bs.fleet_cluster(N, shapes, BATCH, cap)
        f_ms = (out[N]["ms"] if N in out else
                cuda_ms(torch, fleet_fn([t[:N].clone() for t in W_all], N, None)))
        cross[N] = dict(cluster=plan, fleet_ms=f_ms, sequential_ms=N * t5)
    faster = [N for N in FLEET_CROSS_N if cross[N]["fleet_ms"] < cross[N]["sequential_ms"]]
    overtakes = next((N for N in FLEET_CROSS_N
                      if all(M in faster for M in FLEET_CROSS_N if M >= N)), None)
    log(f"[fleet-timing] #6 planned against N x one #5 epoch ({t5:.3f} ms): "
        + ", ".join(f"N={N} ({fleet_team_name(c['cluster'])}) {c['fleet_ms']:.3f} vs "
                    f"{c['sequential_ms']:.3f} ms"
                    for N, c in cross.items())
        + f"; the fleet is the faster from N = {overtakes} on")
    del Xb_all, Tb_all, W_all
    torch.cuda.empty_cache()
    return out, dict(dbuf_epoch_ms=t5, by_members=cross, overtakes_at=overtakes,
                     clusters_at_once=cap), bf16_times


def fleet_timing_bf16(np, torch, dev, W_all, Xb_all, Tb_all, orders_all, shapes, S, kw,
                      cap):
    """Phase 12, bf16: #6's bf16 build for FLEET_TIMED_N[0] members over
    the same banks (cast once), in turns with the float32 build (f32,
    bf16, bf16, f32, each as planned), then at every cluster size, its
    plain version once, and its bound: bf16 bytes at 3.35 TB/s against
    the same operations at bf16's 989 TFLOP/s (the tensor cores its
    products run on); beside it, the operations at float32's 67 TFLOP/s,
    a note and not the bound."""
    from hpnn_tpu_torch.obs.cost import batch_work, bound_ms
    from hpnn_tpu_torch.ops import batch_step as bs

    N = FLEET_TIMED_N[0]
    # bf16's CTA stages its k-tiles in bf16, in less shared memory than
    # float32's; its registers still hold one CTA an SM, so the card holds
    # as many of its clusters at once and the two plan alike
    cap16 = bs.cluster_capacity(torch.bfloat16, dev)
    log(f"[fleet-timing] bf16 #6: clusters the card holds at once, by CTAs a cluster: "
        + ", ".join(f"{C}: {n}" for C, n in cap16.items())
        + f" ({bs.shared_bytes(torch.bfloat16)} bytes of shared memory a CTA; float32 "
        + ", ".join(f"{C}: {n}" for C, n in cap.items()) + ")")
    check(cap16 == cap, f"bf16 #6's cluster capacity {cap16} differs from float32's {cap}")
    plan = bs.fleet_cluster(N, shapes, BATCH, cap16)
    W32 = [t[:N].clone() for t in W_all]
    W16 = [t[:N].to(torch.bfloat16) for t in W_all]
    X16, T16 = Xb_all[:N].to(torch.bfloat16), Tb_all[:N].to(torch.bfloat16)
    fns = {"float32": lambda: bs.train_fleet_epoch_dbuf_banked(
               W32, [], Xb_all[:N], Tb_all[:N], orders_all[:N], **kw),
           "bfloat16": lambda: bs.train_fleet_epoch_dbuf_banked(
               W16, [], X16, T16, orders_all[:N], **kw)}
    runs = {k: [] for k in fns}
    for k in ("float32", "bfloat16", "bfloat16", "float32"):
        runs[k].append(cuda_ms(torch, fns[k]))
    by = {k: statistics.median(v) for k, v in runs.items()}
    by_c = {C: cuda_ms(torch, lambda C=C: bs.train_fleet_epoch_dbuf_banked(
        W16, [], X16, T16, orders_all[:N], cluster=C, **kw))
        for C in (bs.GRID,) + bs.CLUSTER_SIZES}
    Wp = [t[:N].to(torch.bfloat16) for t in W_all]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    bs.train_fleet_epoch_dbuf_banked_plain(Wp, [], X16, T16, orders_all[:N], **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    check(all(torch.isfinite(t.float()).all() for t in W16 + Wp),
          "bf16 fleet timing: weights not finite")
    nbytes, flops = batch_work(shapes, S, False, 2, BATCH)
    b_ms, b_by = bound_ms(N * nbytes, N * flops, "bfloat16")
    fma_ms, _ = bound_ms(N * nbytes, N * flops, "float32")
    out = dict(members=N, cluster=plan, ms=by["bfloat16"], f32_ms=by["float32"],
               runs_ms=runs, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               f32_fma_bound_ms=fma_ms, ms_by_cluster=by_c, clusters_at_once=cap16,
               ms_per_step=by["bfloat16"] / S, bank_bytes=(X16.numel() + T16.numel()) * 2)
    log(f"[fleet-timing] bf16 #6, {N} members x one epoch of {S} steps, B={BATCH}, planned "
        f"{fleet_team_name(plan)}: {by['bfloat16']:.3f} ms (runs "
        f"{', '.join(f'{t:.3f}' for t in runs['bfloat16'])}) "
        f"against float32 #6 {by['float32']:.3f} ms (runs "
        f"{', '.join(f'{t:.3f}' for t in runs['float32'])}), in turns; by team "
        + ", ".join(f"{fleet_team_name(C)} {v:.3f} ms" for C, v in by_c.items())
        + f"; plain {plain_ms:.1f} ms; bound {b_ms:.4f} ms ({b_by}: {N * nbytes} B of bf16, "
        f"{N * flops} flop at bf16's tensor-core rate; {fma_ms:.4f} ms at float32's FMA rate)")
    del W32, W16, Wp, X16, T16
    return out


# the plan split's shapes (--phase-split, phase 12): the two benchmark
# fleets and the HPNN-sized tick, S steps of each
PLAN_SHAPES = {"8 x 784-300-10, B = 256": (8, (784, 300, 10), 256, 24),
               "8 x 851-230-230, B = 256": (8, (851, 230, 230), 256, 14),
               "64 x 32-16-4, B = 1": (64, (32, 16, 4), 1, 64),
               "2 x 784-300-10, B = 32": (2, (784, 300, 10), 32, 8)}


def fleet_plan_split(np, torch, dev):
    """Phase 12 with --phase-split: the constants of #6's team plan
    (``ops.batch_step.KTILE_NS`` and ``SYNC_NS``) from the phase-clock
    build, float32 ANN-BP, and the plan's estimate against each team's
    measured epoch.  Thread 0 of block 0 clocks; its cycles become ns at
    one SM clock, that of the first shape's grid run (its cycles over its
    epoch's CUDA-event time: block 0 of the grid spans the epoch, the
    first cluster of a launch in waves does not).  KTILE_NS: the tile
    phases' cycles over their k-tiles, at 8 x 784-300-10 on the grid;
    SYNC_NS[team]: the sync cycles over the step's syncs, on the
    HPNN-sized fleet (one tile a member a phase, so every busy worker has
    one and a sync is the barrier's own time)."""
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.ops import batch_step as bs

    teams = (bs.GRID,) + bs.CLUSTER_SIZES
    tiles = ("forward tiles", "hidden-delta tiles", "update tiles")
    out, ghz = {}, None
    for name, (N, (n_in, n_hid, n_out), B, S) in PLAN_SHAPES.items():
        rng = np.random.default_rng(SEED + 23)
        ks = [km.generate(SEED + i, n_in, [n_hid], n_out)[0] for i in range(N)]
        W = [torch.tensor(np.stack([k.weights[l] for k in ks]), dtype=torch.float32, device=dev)
             for l in range(2)]
        X = torch.tensor(rng.random((N, S * B, n_in)), dtype=torch.float32, device=dev)
        T = -np.ones((N, S * B, n_out))
        T[:, np.arange(S * B), rng.integers(0, n_out, S * B)] = 1.0
        T = torch.tensor(T, dtype=torch.float32, device=dev)
        orders = np.stack([rng.permutation(S) for _ in range(N)])
        shapes = [tuple(t.shape[1:]) for t in W]
        kw = dict(batch=B, model="ann", momentum=False)
        cap = bs.cluster_capacity(torch.float32, dev)
        _, syncs = bs.step_phases(shapes, B)
        row = {}
        for team in teams:
            w = [t.clone() for t in W]

            def epoch(team=team, w=w):
                e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                e0.record()
                bs.train_fleet_epoch_dbuf_banked(w, [], X, T, orders, cluster=team, **kw)
                e1.record()
                return e0, e1

            bs.phase_clocks(epoch)  # warm-up (the first also loads the build)
            (e0, e1), clocks, parts = bs.phase_clocks(epoch)
            if ghz is None:
                ghz = sum(clocks.values()) / (e0.elapsed_time(e1) * 1e6)
            row[team] = dict(
                ms=cuda_ms(torch, lambda team=team: bs.train_fleet_epoch_dbuf_banked(
                    [t.clone() for t in W], [], X, T, orders, cluster=team, **kw)),
                estimate_ms=bs.step_ns(team, N, shapes, B, cap) * S / 1e6,
                ktiles=parts[bs.KTILES],
                ktile_ns=sum(clocks[k] for k in tiles) / max(1, parts[bs.KTILES]) / ghz,
                sync_ns=clocks["team syncs"] / (syncs * S) / ghz,
                us_per_step={k: v / ghz / S / 1e3 for k, v in clocks.items() if v})
        plan = bs.fleet_cluster(N, shapes, B, cap)
        fastest = min(row, key=lambda t: row[t]["ms"])
        out[name] = dict(by_team=row, plan=plan, fastest=fastest)
        log(f"[plan-split] #6 {name}, S={S}, float32 ANN-BP: planned {fleet_team_name(plan)}, "
            f"fastest {fleet_team_name(fastest)}; by team: " + "; ".join(
                f"{fleet_team_name(t)} {r['ms']:.3f} ms (estimate {r['estimate_ms']:.3f}), "
                f"k-tile {r['ktile_ns']:.1f} ns over {r['ktiles']}, sync {r['sync_ns']:.1f} ns"
                for t, r in row.items()))
        log(f"[plan-split] #6 {name}: block 0's thread 0, us/step by phase on the grid: "
            + ", ".join(f"{k} {v:.2f}" for k, v in row[bs.GRID]["us_per_step"].items()))
    ktile = out["8 x 784-300-10, B = 256"]["by_team"][bs.GRID]["ktile_ns"]
    sync = {t: out["64 x 32-16-4, B = 1"]["by_team"][t]["sync_ns"] for t in teams}
    log(f"[plan-split] constants at the SM clock {ghz:.3f} GHz: KTILE_NS {ktile:.1f}; SYNC_NS "
        + ", ".join(f"{fleet_team_name(t)} {v:.1f}" for t, v in sync.items())
        + f"; the module's: KTILE_NS {bs.KTILE_NS}, SYNC_NS {bs.SYNC_NS}")
    return dict(shapes=out, sm_ghz=ghz, ktile_ns=ktile, sync_ns=sync)


# ------------------------------------------- crash-resume, streaming, obs
# Phase 13: the reference's cross-backend bars (ChangeLog:33-38), on the
# #DBG trace as tools/ledger_diff.py holds the ledger to them
VEC_TOL, MAT_TOL = 1e-14, 1e-12
# the float64 per-sample round, card against CPU, on phase 4's first
# F64_SAMPLES samples from the generated kernel, each capped at
# F64_MAX_ITER iterations: uncapped, those samples take ~2600 iterations
# each and the CPU's float64 round was most of the script's run (~90-99 s
# on the host of an NVIDIA H100 80GB HBM3, 700.00 W; PERF.md)
F64_SAMPLES, F64_MAX_ITER = 32, 400
N_ITER_RE = re.compile(r"N_ITER=\s*(\d+)")
DBG_RE = re.compile(r"#DBG: acc\[(.+)/(\d+)\]=(\S+)")


@contextlib.contextmanager
def knobs(obs, env):
    """``env`` set for the block, the port's memoized obs readings
    forgotten on the way in and out."""
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    obs.reset()
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        obs.reset()


def training_lines(out):
    return [ln for ln in out.splitlines() if "TRAINING FILE" in ln]


def traces_agree(got, ref):
    """(ok, max |diff|, lines): the #DBG lines tag by tag, each value
    within the reference's bar (weights are matrices, eval outputs
    vectors)."""
    a = [(m.group(1), int(m.group(2)), float(m.group(3))) for m in DBG_RE.finditer(got)]
    b = [(m.group(1), int(m.group(2)), float(m.group(3))) for m in DBG_RE.finditer(ref)]
    if not a or [x[:2] for x in a] != [x[:2] for x in b]:
        return False, math.inf, len(a)
    worst, ok = 0.0, True
    for (tag, _, va), (_, _, vb) in zip(a, b):
        tol = VEC_TOL if tag.startswith("out@") else MAT_TOL
        worst = max(worst, abs(va - vb))
        ok = ok and abs(va - vb) <= tol
    return ok, worst, len(a)


def ledger_diff(a, b, *extra):
    """tools/ledger_diff.py at its default bars: (exit code, report)."""
    out = subprocess.run([sys.executable, os.path.join(ROOT, "tools", "ledger_diff.py"),
                          a, b, *extra], capture_output=True, text=True, timeout=120)
    return out.returncode, (out.stdout + out.stderr).strip()


def matrix_misses(a, b):
    """Every divergence ``tools/ledger_diff.py`` finds between ledgers
    ``a`` and ``b`` as ``(row, tensor, |a-b|)``, when each is a matrix
    checksum past the 1e-12 bar; None when any is anything else (a
    vector past 1e-14, a row count, a shape, a NaN)."""
    _, report = ledger_diff(a, b, "--json")
    found = json.loads(report.splitlines()[-1])["divergent"]
    if not all(d["reason"] == "tolerance" and d["tol"] == MAT_TOL for d in found):
        return None
    return [(d["row"], d["tensor"], d["diff"]) for d in found]


def ledger_rel_dev(a, b):
    """Max relative deviation of ledger ``a``'s checksums from ``b``'s,
    row by row."""
    rows = [[json.loads(ln) for ln in open(p) if '"ledger.round"' in ln] for p in (a, b)]
    check(len(rows[0]) == len(rows[1]) > 0, f"ledgers {a} and {b}: row counts differ")
    return max(abs(ra["checksums"][k] - rb["checksums"][k]) / abs(rb["checksums"][k])
               for ra, rb in zip(*rows) for k in rb["checksums"])


def resume_obs_native(np, torch, dev, protos):
    """Phase 13: crash-resume (per-sample and batch), the streaming
    per-sample loop, the card's float64 ledger and #DBG trace against
    the CPU's (per-sample, batch, fleet), obs leaving the tokens alone
    with its MFU records, and the native parse.  Returns statistics."""
    from hpnn_tpu_torch import native, obs
    from hpnn_tpu_torch.cli import train_nn
    from hpnn_tpu_torch.fileio import samples as sample_io
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.ops import batch_step as bs
    from hpnn_tpu_torch.ops import convergence
    from hpnn_tpu_torch.parallel import dp
    from hpnn_tpu_torch.train import batch, driver, fleet, loop

    sdir = os.path.join(WORK, "resume_obs")
    os.makedirs(sdir)
    ps_dir, b_dir = os.path.join(WORK, "train"), os.path.join(WORK, "batch", "train")
    cwd = os.getcwd()
    stats = {}

    def cli(label, argv, env=(), raises=None, train_dir=None, init="generate"):
        """train_nn in its own directory: (stdout, kernel.opt text or
        None, seconds, the directory).  ``raises``: the exception the
        run must end with (its stdout is still returned)."""
        run_dir = os.path.join(sdir, label)
        os.makedirs(run_dir, exist_ok=True)
        os.chdir(run_dir)
        try:
            write_conf("nn.conf", name="smoke_ann", kind="ANN",
                       train_dir=train_dir or (b_dir if "--batch" in argv else ps_dir),
                       test_dir=ps_dir, init=init)
            buf = io.StringIO()
            t0 = time.perf_counter()
            with knobs(obs, dict(env)), contextlib.redirect_stdout(buf):
                try:
                    rc = train_nn.main(argv + ["-v", "-v", "nn.conf"])
                except Exception as exc:  # the deliberate launch error only
                    check(raises is not None and isinstance(exc, raises),
                          f"{label}: train_nn raised {exc!r}")
                    rc = None
            secs = time.perf_counter() - t0
            check(raises is None or rc is None, f"{label}: the launch error did not surface")
            check(raises is not None or rc == 0, f"{label}: train_nn exit {rc}")
            opt = open("kernel.opt").read() if rc == 0 else None
            return buf.getvalue(), opt, secs, run_dir
        finally:
            os.chdir(cwd)

    # 1. resume: the launch of chunk 2 raises; the rerun resumes
    out_a, opt_a, secs_a, _ = cli("chunked", [])
    check(len(training_lines(out_a)) == N_TRAIN_ANN, "chunked: token lines")
    state = os.path.join(sdir, "round.state")
    real_epoch, calls = loop.train_epoch, [0]

    def dying_epoch(*a, **kw):
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("the launch of chunk 2 raised (deliberately)")
        return real_epoch(*a, **kw)

    loop.train_epoch = dying_epoch
    try:
        part1, _, _, _ = cli("crashed", [], {"HPNN_FUSE_STATE": state}, raises=RuntimeError)
    finally:
        loop.train_epoch = real_epoch
    with np.load(state, allow_pickle=False) as z:
        done, hint = int(z["done"]), int(z["chunk"])
    want_hint = max(min(32, CHUNK), CHUNK // 2)  # halved, not below 32
    check((done, hint) == (CHUNK, want_hint),
          f"crash checkpoint: done {done}, chunk {hint} (want {CHUNK}, {want_hint})")
    part2, opt_r, _, _ = cli("resumed", [], {"HPNN_FUSE_STATE": state})
    check(training_lines(part1 + part2) == training_lines(out_a),
          "resume: the two attempts' tokens differ from the uninterrupted run's")
    check(opt_r == opt_a, "resume: kernel.opt differs from the uninterrupted run's")
    check(not os.path.exists(state), "resume: the completed round left its checkpoint")
    log(f"[resume] ANN 784-300-10 BP, {N_TRAIN_ANN} samples in chunks of {CHUNK}: chunk 2's "
        f"launch raised after {done} samples (checkpoint chunk hint {hint}); the resumed "
        f"round's tokens ({len(training_lines(part2))} lines) after the crashed one's "
        f"({len(training_lines(part1))}) and kernel.opt byte-identical to the "
        f"uninterrupted run ({secs_a:.2f} s)")

    bargv = ["--batch", str(BATCH), "--epochs", str(EPOCHS)]
    out_b, opt_b, secs_b, _ = cli("batch", bargv)
    names = sample_io.list_sample_files(b_dir)
    k0 = km.generate(SEED, N_IN, [N_HID], N_OUT)[0]
    key = batch._batch_state_key(
        b_dir, "ann", False, tuple(w.shape for w in k0.weights), BATCH,
        dp.default_lr("ann", False), EPOCHS,
        "cuda-kernel-bank8/generate", names=names)
    # a checkpoint at epoch 0 with a block cap of 2: the run checkpoints
    # after epochs 2 and 4; the launch of epoch 3 raises
    bstate = os.path.join(sdir, "batch.state")
    wdt = np.float32 if dev.type == "cuda" else np.float64  # the run's compute dtype
    driver._save_fuse_state(bstate, key, SEED, 0, 2, [w.astype(wdt) for w in k0.weights])
    real_grid, calls[0] = bs.train_epoch_grid_banked, 0

    def dying_grid(*a, **kw):
        calls[0] += 1
        if calls[0] == 3:
            raise RuntimeError("the launch of epoch 3 raised (deliberately)")
        return real_grid(*a, **kw)

    bs.train_epoch_grid_banked = dying_grid
    try:
        bpart1, _, _, _ = cli("batch_crashed", bargv, {"HPNN_FUSE_STATE": bstate},
                              raises=RuntimeError)
    finally:
        bs.train_epoch_grid_banked = real_grid
    with np.load(bstate, allow_pickle=False) as z:
        check(int(z["done"]) == 2, f"batch crash checkpoint: done {int(z['done'])}")
    bpart2, opt_br, _, _ = cli("batch_resumed", bargv, {"HPNN_FUSE_STATE": bstate})
    check(epochs_of(bpart1) + epochs_of(bpart2) == epochs_of(out_b)
          and len(epochs_of(out_b)) == EPOCHS,
          "batch resume: the epoch tokens differ from the uninterrupted run's")
    check(opt_br == opt_b, "batch resume: kernel.opt differs from the uninterrupted run's")
    log(f"[resume] --batch {BATCH} --epochs {EPOCHS} on {N_BATCH_TRAIN} files: stopped after "
        f"epoch 2 (blocks of 2), resumed: epoch tokens and kernel.opt byte-identical to "
        f"the uninterrupted run ({secs_b:.2f} s)")

    # 2. streaming: one launch of #1 a sample
    before = convergence.launches
    out_s, opt_s, secs_s, _ = cli("streaming", [], {"HPNN_FUSE_EPOCH": "0"})
    launched = convergence.launches - before
    check(launched == N_TRAIN_ANN, f"streaming: {launched} launches for {N_TRAIN_ANN} samples")
    check(out_s == out_a and opt_s == opt_a,
          "streaming: stdout or kernel.opt differs from the chunked card run")
    stats["streaming"] = dict(seconds=secs_s, launches=launched, chunked_seconds=secs_a,
                              chunked_launches=math.ceil(N_TRAIN_ANN / CHUNK))
    log(f"[streaming] HPNN_FUSE_EPOCH=0: {launched} launches of #1 in {secs_s:.2f} s against "
        f"the chunked run's {math.ceil(N_TRAIN_ANN / CHUNK)} in {secs_a:.2f} s; stdout and "
        f"kernel.opt byte-identical")

    # 3. float64 ledger and trace, the card against the CPU
    f64 = {"HPNN_DTYPE": "float64", "HPNN_TRACE": "1"}
    f64_dir = os.path.join(sdir, "train_f64")
    os.makedirs(f64_dir)
    for name in sorted(os.listdir(ps_dir))[:F64_SAMPLES]:
        shutil.copy(os.path.join(ps_dir, name), f64_dir)
    diffs = {}
    max_iter = loop.MAX_BP_ITER
    for what, argv, tdir in (("per-sample", [], f64_dir), ("batch", bargv, None)):
        runs = {}
        for where, extra in (("cuda", []), ("cpu", ["--device", "cpu"])):
            lpath = os.path.join(sdir, f"ledger_{what}_{where}.jsonl")
            loop.MAX_BP_ITER = F64_MAX_ITER if tdir else max_iter
            try:
                runs[where] = cli(f"f64_{what}_{where}", extra + argv,
                                  dict(f64, HPNN_LEDGER=lpath), train_dir=tdir) + (lpath,)
            finally:
                loop.MAX_BP_ITER = max_iter
        rc, report = ledger_diff(runs["cuda"][4], runs["cpu"][4])
        check(rc == 0, f"{what} f64: ledger_diff card vs cpu exit {rc}:\n{report}")
        ok, worst, n = traces_agree(runs["cuda"][0], runs["cpu"][0])
        check(ok, f"{what} f64: #DBG lines of the card and the CPU disagree "
                  f"(max |diff| {worst:.3e} over {n} lines)")
        same_tokens = ([ln for ln in runs["cuda"][0].splitlines() if "#DBG" not in ln
                        and "[GPU]" not in ln] ==
                       [ln for ln in runs["cpu"][0].splitlines() if "#DBG" not in ln])
        max_abs = re.search(r"max \|a-b\|: (\S+)", report).group(1)
        iters = sum(int(m) for m in N_ITER_RE.findall(runs["cpu"][0]))
        diffs[what] = dict(ledger_max_abs_diff=float(max_abs), trace_max_abs_diff=worst,
                           trace_lines=n, tokens_identical=same_tokens, iterations=iters,
                           cuda_seconds=runs["cuda"][2], cpu_seconds=runs["cpu"][2])
        each = (f" ({F64_SAMPLES} samples, {iters} iterations, at most {F64_MAX_ITER} "
                f"each)" if tdir else "")
        log(f"[ledger] {what} round{each} in float64, "
            f"card vs CPU: ledger_diff exit 0 (max |a-b| "
            f"{max_abs}), {n} #DBG lines within 1e-12 (max |diff| {worst:.3e}), tokens "
            f"{'byte-identical' if same_tokens else 'differ'}; card {runs['cuda'][2]:.2f} s, "
            f"CPU {runs['cpu'][2]:.2f} s")
    rng = np.random.default_rng(SEED + 11)   # phase 11's fleet data
    Xf, Tf = make_dataset(np, rng, FLEET_ROWS, protos)
    fks = [km.generate(SEED + i, N_IN, [N_HID], N_OUT)[0] for i in range(FLEET_MAIN_N)]
    fkw = dict(epochs=FLEET_EPOCHS, batch=BATCH, lr=FLEET_LR, seeds=list(range(FLEET_MAIN_N)))
    fl_paths = {}
    for where in ("cuda", "cpu"):
        fl_paths[where] = os.path.join(sdir, f"ledger_fleet_{where}.jsonl")
        t0 = time.perf_counter()
        with knobs(obs, {"HPNN_LEDGER": fl_paths[where]}):
            fleet.train_fleet(fks, Xf, Tf, dtype="f64", device=where, **fkw)
        diffs.setdefault("fleet", {})[f"{where}_seconds"] = time.perf_counter() - t0
    rc, report = ledger_diff(fl_paths["cuda"], fl_paths["cpu"])
    check(rc == 0, f"fleet f64: ledger_diff card vs cpu exit {rc}:\n{report}")
    diffs["fleet"]["ledger_max_abs_diff"] = float(
        re.search(r"max \|a-b\|: (\S+)", report).group(1))
    log(f"[ledger] fleet of {FLEET_MAIN_N} in float64, card vs CPU: ledger_diff exit 0 over "
        f"{FLEET_MAIN_N} member rows (max |a-b| {diffs['fleet']['ledger_max_abs_diff']:.3e})")
    stats["card_vs_cpu_f64"] = diffs

    # 4. obs leaves the tokens alone, and records MFU (a sink and a
    # ledger per run: each starts its rows and span ids anew)
    odir = os.path.join(sdir, "obs")
    os.makedirs(odir)

    def all_on(label):
        return {"HPNN_METRICS": os.path.join(odir, f"metrics_{label}.jsonl"),
                "HPNN_SPANS": "1", "HPNN_COST": "1", "HPNN_PROBES": "1",
                "HPNN_LEDGER": os.path.join(odir, f"ledger_{label}.jsonl"),
                "HPNN_FLIGHT": os.path.join(odir, f"flight_{label}.jsonl")}

    out_o, opt_o, secs_o, _ = cli("obs", [], all_on("per-sample"))
    check(out_o == out_a and opt_o == opt_a, "obs on: per-sample stdout or kernel.opt differs")
    out_ob, opt_ob, secs_ob, _ = cli("obs_batch", bargv, all_on("batch"))
    check(out_ob == out_b and opt_ob == opt_b, "obs on: batch stdout or kernel.opt differs")
    plain = fleet.train_fleet(fks, Xf, Tf, **fkw)
    t0 = time.perf_counter()
    with knobs(obs, all_on("fleet")):
        traced = fleet.train_fleet(fks, Xf, Tf, **fkw)
    secs_of = time.perf_counter() - t0
    check(all(np.array_equal(x, y) for ka, kb in zip(plain[0], traced[0])
              for x, y in zip(ka.weights, kb.weights)), "obs on: the fleet's weights differ")
    mfu = {}
    for label, exe in (("per-sample", "driver.train_epoch"), ("batch", "batch.epoch"),
                       ("fleet", "fleet.epoch")):
        conf = all_on(label)
        for ln in open(conf["HPNN_METRICS"]):
            r = json.loads(ln)
            if r["ev"] == "perf.mfu":
                mfu.setdefault((r["exe"], r.get("kernel")), []).append(r["value"])
        vals = [v for (e, _), vs in mfu.items() if e == exe for v in vs]
        check(vals and all(math.isfinite(v) and v > 0 for v in vals),
              f"metrics: no perf.mfu of {exe}")
        for flag, path in (("--ledger", conf["HPNN_LEDGER"]), ("--perf", conf["HPNN_METRICS"])):
            out = subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                               "check_obs_catalog.py"),
                                  flag, path], capture_output=True, text=True, timeout=120,
                                 cwd=ROOT)
            check(out.returncode == 0,
                  f"check_obs_catalog.py {flag} ({label}): {out.stderr.strip()}")
    stats["obs"] = dict(
        per_sample_seconds=secs_o, per_sample_seconds_off=secs_a, batch_seconds=secs_ob,
        batch_seconds_off=secs_b, fleet_seconds=secs_of,
        mfu={f"{e} {k}": dict(n=len(v), mean=statistics.fmean(v), min=min(v), max=max(v))
             for (e, k), v in mfu.items()})
    log(f"[obs] every obs knob on (metrics, spans, cost, probes, ledger, flight): per-sample "
        f"{secs_o:.2f} s (off {secs_a:.2f}), batch {secs_ob:.2f} s (off {secs_b:.2f}): stdout "
        f"and kernel.opt byte-identical; fleet weights bitwise equal; check_obs_catalog.py "
        f"--ledger and --perf pass")
    for name, v in stats["obs"]["mfu"].items():
        log(f"[obs] perf.mfu {name}: mean {v['mean']:.4e} over {v['n']} launches "
            f"({v['min']:.4e}..{v['max']:.4e})")
    # the card's float32 round of the float64 rounds' samples, its ledger
    # against the CPU's float64 one
    ledger_f32 = os.path.join(sdir, "ledger_per-sample_cuda_f32.jsonl")
    loop.MAX_BP_ITER = F64_MAX_ITER
    try:
        cli("f32_per-sample_cuda", [], {"HPNN_LEDGER": ledger_f32}, train_dir=f64_dir)
    finally:
        loop.MAX_BP_ITER = max_iter
    rel = ledger_rel_dev(ledger_f32, os.path.join(sdir, "ledger_per-sample_cpu.jsonl"))
    stats["f32_card_vs_f64_cpu_ledger_max_rel_dev"] = rel
    log(f"[obs] per-sample ledger ({F64_SAMPLES} samples), card float32 vs CPU float64: max "
        f"relative deviation {rel:.3e} (reported, not gated)")

    # 5. the native parse
    check(native.lib() is not None, "the native host library did not load")
    times = {}
    for what, d in (("batch", b_dir), ("per-sample", ps_dir)):
        got = {}
        # in turns: native, Python, Python, native
        for walk in ("native", "python", "python", "native"):
            with knobs(obs, {"HPNN_NO_NATIVE": "1"} if walk == "python" else {}):
                t0 = time.perf_counter()
                got[walk] = sample_io.read_dir(d)
                times.setdefault(f"{what} {walk}", []).append(time.perf_counter() - t0)
        a, b = got["native"], got["python"]
        check(a[0] == b[0] and a[1].tobytes() == b[1].tobytes()
              and a[2].tobytes() == b[2].tobytes(),
              f"{what}: the native parse differs from the Python walk")
        log(f"[native] {len(a[0])} {what} files: native parse "
            f"{' / '.join(f'{t:.3f}' for t in times[what + ' native'])} s, Python walk "
            f"{' / '.join(f'{t:.3f}' for t in times[what + ' python'])} s, bitwise equal")
    out_np, _, secs_np, _ = cli("python_walk", [], {"HPNN_NO_NATIVE": "1"})
    out_nb, _, secs_nb, _ = cli("python_walk_batch", bargv, {"HPNN_NO_NATIVE": "1"})
    check(out_np == out_a and out_nb == out_b, "the Python walk's rounds print other tokens")
    # --profile on the card: the trace holds #1's kernels and the
    # chunks' ranges
    out_p, opt_p, _, pdir = cli("profile", ["--profile", "trace"])
    check(out_p == out_a and opt_p == opt_a, "--profile: stdout or kernel.opt differs")
    events = json.load(open(os.path.join(pdir, "trace", "trace.json")))["traceEvents"]
    n_kern = sum(1 for e in events if "convergence_cluster" in str(e.get("name", "")))
    n_rng = sum(1 for e in events if e.get("name") == "train.chunk")
    check(n_kern >= math.ceil(N_TRAIN_ANN / CHUNK) and n_rng >= math.ceil(N_TRAIN_ANN / CHUNK),
          f"--profile: {n_kern} convergence kernels and {n_rng} chunk ranges in the trace")
    log(f"[obs] --profile: trace.json holds {n_kern} convergence_cluster kernel events and "
        f"{n_rng} train.chunk ranges; stdout and kernel.opt byte-identical")
    stats["native"] = dict(parse_s=times, per_sample_round_s=dict(native=secs_a,
                                                                  python=secs_np),
                           batch_round_s=dict(native=secs_b, python=secs_nb))
    log(f"[native] round wall: per-sample {secs_np:.2f} s with the Python walk, {secs_a:.2f} s "
        f"native; batch {secs_nb:.2f} s with the Python walk, {secs_b:.2f} s native; tokens "
        f"byte-identical")
    return stats


# ---------------------------------------------------------------- phases
# ------------------------------------------------------------ serving
# Phase 14: hpnn_tpu_torch.serve.  The card's float32 answers against the
# CPU's float64 parity answers on the same rows: a 784-300-10 forward
# moves ~1e-7 relative per float32 operation, so 1e-5 absolute on
# outputs in (-1, 1) is far above that rounding and far below a real
# fault (a wrong term is O(1e-2)).  SNN: its softmax row sum (10 terms
# in float32, in the card's order) adds ~1e-7 relative on outputs in
# (0, 1); the band is the same 1e-5.
SERVE_TOL, SERVE_SNN_TOL = 1e-5, 1e-5
SERVE_MAX_BATCH, SERVE_WAIT_MS = 64, 2.0
SERVE_CLIENTS, SERVE_REQUESTS, SERVE_ROWS = 16, 25, (1, 2, 4, 8)
SERVE_FLEET_N = 8
SERVE_TIMED_REPLAYS = 200
# docs/performance.md's documented bounds on the warmup probe
QUANT_BOUND = {"bf16": 1e-1, "int8": 2e-1}


def serve_rows_ref(cpu_sess, name, xs):
    """CPU float64 parity answers of the blocks ``xs``, one block each."""
    entry = cpu_sess.registry.get(name)
    return [cpu_sess.engine.run_rows(entry, x) for x in xs]


def serve_split(np, obs, load, label):
    """Run ``load()`` with ``HPNN_METRICS`` on and split the mean request
    time from the sink: queue wait (submit to the batch's pop), the
    batch's forward (pad, copy in, replay, copy out) and the rest
    (waking the client, the GIL, the router's hop)."""
    sink = os.path.join(WORK, f"serve_obs_{label}.jsonl")
    with knobs(obs, {"HPNN_METRICS": sink}):
        load()
    recs = [json.loads(ln) for ln in open(sink)]
    req = [r["dt"] for r in recs if r["ev"] == "serve.request" and r["kind"] == "timer"]
    waits = [r for r in recs if r["ev"] == "serve.wait_ms"]
    fwd = [r["dt"] for r in recs if r["ev"] == "serve.forward"]
    sizes = [r for r in recs if r["ev"] == "serve.batch_size"]
    check(len(req) == SERVE_CLIENTS * SERVE_REQUESTS and waits and fwd,
          f"{label}: the obs sink holds {len(req)} serve.request timers")
    split = dict(request_ms=float(np.mean(req)) * 1e3,
                 queue_wait_ms=sum(w["sum"] for w in waits) / sum(w["n"] for w in waits),
                 forward_ms=float(np.mean(fwd)) * 1e3, batches=len(fwd),
                 requests_per_batch=float(np.mean([r["requests"] for r in sizes])),
                 rows_per_batch=float(np.mean([r["mean"] for r in sizes])))
    split["rest_ms"] = split["request_ms"] - split["queue_wait_ms"] - split["forward_ms"]
    log(f"[serve] {label}: ann request, mean of {len(req)} (HPNN_METRICS on): "
        f"{split['request_ms']:.3f} ms = queue wait {split['queue_wait_ms']:.3f} + forward "
        f"{split['forward_ms']:.3f} ({split['batches']} batches of "
        f"{split['requests_per_batch']:.1f} requests, {split['rows_per_batch']:.1f} rows) + "
        f"the rest {split['rest_ms']:.3f}")
    return split


def serve_timing(np, torch, eng, entry):
    """Per bucket: one graph replay (CUDA events over
    SERVE_TIMED_REPLAYS replays) against one eager launch of the same
    batched forward on the same static input, a whole dispatch's wall
    time (copy-in, replay, copy-out), and the bound."""
    from hpnn_tpu_torch.obs.cost import bound_ms, forward_work
    from hpnn_tpu_torch.serve import engine as eng_mod

    weights = eng._device_weights(entry)
    model = eng_mod._model_of(entry)
    shapes = [tuple(w.shape) for w in entry.kernel.weights]
    rng = np.random.default_rng(SEED)
    out = {}
    for bucket in eng.buckets:
        g = eng._compiled_forward(entry, bucket, np.float64)
        n = SERVE_TIMED_REPLAYS

        def replays(g=g, n=n):
            for _ in range(n):
                g.graph.replay()

        def eager(g=g, n=n):
            with torch.no_grad():
                for _ in range(n):
                    eng_mod.batch_forward(model, weights, g.static_in)

        by = {"replay": [], "eager": []}
        for k in ("replay", "eager", "eager", "replay"):
            by[k].append(cuda_ms(torch, replays if k == "replay" else eager) / n * 1e3)
        block = rng.uniform(-1.0, 1.0, (bucket, entry.n_inputs))
        walls = []
        for _ in range(21):
            t0 = time.perf_counter()
            eng.run_rows(entry, block)
            walls.append((time.perf_counter() - t0) * 1e6)
        nbytes, flops = forward_work(shapes, bucket, 4)
        b_ms, b_by = bound_ms(nbytes, flops, "float32")
        out[bucket] = dict(replay_us=statistics.median(by["replay"]),
                           eager_us=statistics.median(by["eager"]),
                           dispatch_us=statistics.median(walls), bound_us=b_ms * 1e3,
                           bound_by=b_by, bytes=nbytes, flops=flops)
    return out


def serve_phase(np, torch, dev, k0):
    """Phase 14: the serve stack on the card at 784-300-10, ANN (phase
    4's trained kernel.opt) and SNN (the generated kernel): captures,
    the bench twin's headline load, every answer against the CPU float64
    parity answer and the eager batched forward, replay == eager on each
    bucket, bf16/int8 quant_err, the fleet, a hot reload mid-load, a
    2-replica router and serve_nn over HTTP.  Returns statistics."""
    import http.client
    import threading

    from hpnn_tpu_torch import obs, runtime, serve
    from hpnn_tpu_torch.fileio import kernel_format
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.serve import compile_cache
    from hpnn_tpu_torch.tools import bench_serve

    check(runtime.deferred_env_message("chip_smoke") is None, "a refused knob is set")
    obs.reset()
    stats = {}
    ann_path = os.path.join(WORK, "ann", "kernel.opt")
    _, w_ann = kernel_format.load_kernel(ann_path)
    k_ann, k_snn = km.Kernel(tuple(w_ann)), k0
    kw = dict(max_batch=SERVE_MAX_BATCH, max_wait_ms=SERVE_WAIT_MS)
    cpu = serve.Session(device="cpu", **kw)
    cpu.register_kernel("ann", k_ann)
    cpu.register_kernel("snn", k_snn, model="snn")
    check(cpu.engine.mode == "parity", "the CPU session is not in parity mode")

    # captures: one graph per (kernel, bucket), nothing after warmup
    sess = serve.Session(device=dev, **kw)
    eng = sess.engine
    check(eng.mode == "compiled" and eng.device.type == "cuda",
          f"the card's session runs {eng.mode} on {eng.device}")
    compile_cache._reset_for_tests()
    t0 = time.perf_counter()
    sess.load_kernel("ann", ann_path)
    sess.register_kernel("snn", k_snn, model="snn")
    warm_s = time.perf_counter() - t0
    n_graphs = 2 * len(eng.buckets)
    check(eng.compiled_count() == n_graphs and compile_cache.counters()[1] == n_graphs,
          f"warmup left {eng.compiled_count()} forwards, {compile_cache.counters()[1]} captures")
    check(all(type(g).__name__ == "_Graph" for g in eng._compiled.values()),
          "a bucket forward is not a captured graph")
    stats["warmup_s"] = warm_s
    log(f"[serve] 784-300-10 ANN + SNN on {eng.device}: {n_graphs} graphs captured "
        f"(buckets {list(eng.buckets)}) in {warm_s:.2f} s")

    # replay == eager batched forward on the same padded block, per bucket
    rng = np.random.default_rng(SEED + 14)
    replay_eager = {}
    for name in ("ann", "snn"):
        entry = sess.registry.get(name)
        worst = 0.0
        for bucket in eng.buckets:
            block = rng.uniform(-1.0, 1.0, (bucket, N_IN))
            got, want = eng.run_rows(entry, block), eng.eager_rows(entry, block)
            worst = max(worst, float(np.max(np.abs(got - want))))
        replay_eager[name] = worst
        check(worst <= SERVE_TOL, f"{name}: replay vs eager {worst:.3e}")
        log(f"[serve] {name}: graph replay vs eager batched forward, every bucket: "
            + ("bitwise equal" if worst == 0.0 else f"max |diff| {worst:.3e}"))
    stats["replay_vs_eager"] = replay_eager

    # the bench twin's headline load, every answer held
    loads = {}
    for name in ("ann", "snn"):
        answers = []
        lock = threading.Lock()

        def keep(x, out, answers=answers):
            with lock:
                answers.append((x, out))

        r0, h0 = eng.replay_count(), compile_cache.counters()
        load = bench_serve.closed_loop(sess, name, N_IN, n_clients=SERVE_CLIENTS,
                                       n_requests=SERVE_REQUESTS, mixed_rows=SERVE_ROWS,
                                       on_answer=keep)
        h1 = compile_cache.counters()
        replays = eng.replay_count() - r0
        check("errors" not in load, f"{name} load: {load.get('errors')}")
        check(load["requests_served"] == SERVE_CLIENTS * SERVE_REQUESTS,
              f"{name} load served {load['requests_served']}")
        check(h1[1] == h0[1] and eng.compiled_count() == n_graphs,
              f"{name} load captured {h1[1] - h0[1]} graphs after warmup")
        check(replays == h1[0] - h0[0] > 0,
              f"{name} load: {replays} replays for {h1[0] - h0[0]} bucket dispatches")
        refs = serve_rows_ref(cpu, name, [x for x, _ in answers])
        err_cpu = max(float(np.max(np.abs(out - ref))) for (_, out), ref in zip(answers, refs))
        err_eager = max(float(np.max(np.abs(out - eng.eager_rows(sess.registry.get(name), x))))
                        for x, out in answers)
        tol = SERVE_SNN_TOL if name == "snn" else SERVE_TOL
        check(all(np.isfinite(out).all() and out.shape == (x.shape[0], N_OUT)
                  for x, out in answers), f"{name}: an answer is malformed or not finite")
        check(err_cpu <= tol, f"{name}: card vs CPU float64 {err_cpu:.3e} > {tol:.0e}")
        check(err_eager <= tol, f"{name}: card vs eager {err_eager:.3e}")
        load.update(replays=replays, max_abs_err_cpu_f64=err_cpu, max_abs_err_eager=err_eager)
        loads[name] = load
        lat = load["latency_ms"]
        log(f"[serve] {name} load, {SERVE_CLIENTS} clients x {SERVE_REQUESTS} requests of "
            f"{list(SERVE_ROWS)} rows, max_batch {SERVE_MAX_BATCH}, {SERVE_WAIT_MS} ms wait: "
            f"p50 {lat['p50']} ms p99 {lat['p99']} ms, {load['throughput_rps']} requests/s, "
            f"{load['rows_per_s']} rows/s; {replays} replays, 0 captures; max |card - cpu f64| "
            f"{err_cpu:.3e} (tol {tol:.0e}), vs the eager forward of each request alone "
            + ("bitwise" if err_eager == 0.0 else f"{err_eager:.3e}"))
    stats["load"] = loads

    # the ANN and SNN loads at once on the one session: two batchers
    # replay their graphs from their own threads, and every answer is
    # still its own kernel's
    both, lock = {"ann": [], "snn": []}, threading.Lock()
    runs = {}

    def load_of(name):
        def keep(x, out):
            with lock:
                both[name].append((x, out))
        runs[name] = bench_serve.closed_loop(
            sess, name, N_IN, n_clients=SERVE_CLIENTS, n_requests=SERVE_REQUESTS,
            mixed_rows=SERVE_ROWS, on_answer=keep)

    threads = [threading.Thread(target=load_of, args=(name,)) for name in both]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    check(not any(t.is_alive() for t in threads) and len(runs) == 2,
          "the concurrent ANN + SNN load did not finish")
    together = {}
    for name, answers in both.items():
        check("errors" not in runs[name], f"concurrent {name} load: {runs[name].get('errors')}")
        check(len(answers) == SERVE_CLIENTS * SERVE_REQUESTS,
              f"concurrent {name} load served {len(answers)}")
        refs = serve_rows_ref(cpu, name, [x for x, _ in answers])
        err = max(float(np.max(np.abs(out - ref))) for (_, out), ref in zip(answers, refs))
        tol = SERVE_SNN_TOL if name == "snn" else SERVE_TOL
        check(err <= tol, f"concurrent {name} load: card vs CPU float64 {err:.3e} > {tol:.0e}")
        together[name] = dict(max_abs_err_cpu_f64=err, p50_ms=runs[name]["latency_ms"]["p50"],
                              p99_ms=runs[name]["latency_ms"]["p99"])
    check(eng.compiled_count() == n_graphs, "the concurrent load captured a graph")
    stats["concurrent"] = together
    log(f"[serve] ANN and SNN loads at once on one session ({SERVE_CLIENTS} clients each): "
        + "; ".join(f"{n} p50 {v['p50_ms']} ms p99 {v['p99_ms']} ms, max |card - cpu f64| "
                    f"{v['max_abs_err_cpu_f64']:.3e}" for n, v in together.items()))

    # where an ANN request's time goes: the same load with HPNN_METRICS on
    split = serve_split(np, obs, lambda: bench_serve.closed_loop(
        sess, "ann", N_IN, n_clients=SERVE_CLIENTS, n_requests=SERVE_REQUESTS,
        mixed_rows=SERVE_ROWS), "session")
    stats["split"] = split

    # one replay per bucket against one eager launch
    timing = serve_timing(np, torch, eng, sess.registry.get("ann"))
    stats["by_bucket"] = timing
    for bucket, t in timing.items():
        log(f"[serve] ANN bucket {bucket}: replay {t['replay_us']:.2f} us, eager "
            f"{t['eager_us']:.2f} us, whole dispatch {t['dispatch_us']:.1f} us; bound "
            f"{t['bound_us']:.3f} us ({t['bound_by']}: {t['bytes']} B, {t['flops']} flop)")

    # bf16 / int8 policies: the warmup probe's error within the documented bounds
    quant = {}
    for prec, bound in QUANT_BOUND.items():
        qs = serve.Session(device=dev, **kw)
        qs.registry.register("ann", k_ann, precision=prec)
        qs.engine.warmup()
        err = qs.engine.precision_doc()["kernels"]["ann"]["quant_err"]
        block = rng.uniform(-1.0, 1.0, (37, N_IN))
        served = float(np.max(np.abs(qs.infer("ann", block)
                                     - serve_rows_ref(cpu, "ann", [block])[0])))
        qs.close()
        check(0.0 < err < bound and served < bound,
              f"{prec}: quant_err {err:.3e}, served {served:.3e}, bound {bound:.0e}")
        quant[prec] = dict(quant_err=err, served_err=served)
        log(f"[serve] {prec} policy: quant_err {err:.3e} on the warmup probe, {served:.3e} "
            f"on 37 served rows (documented bound {bound:.0e})")
    stats["quant"] = quant

    # the fleet: 8 same-topology kernels through one stacked graph
    os.environ["HPNN_SERVE_FLEET"] = "1"
    try:
        fs = serve.Session(device=dev, **kw)
    finally:
        os.environ.pop("HPNN_SERVE_FLEET")
    check(fs.fleet, "HPNN_SERVE_FLEET=1 left the session per-kernel")
    frng = np.random.RandomState(SEED)
    for i in range(SERVE_FLEET_N):
        w = tuple(frng.uniform(-1, 1, (o, n)) / np.sqrt(n)
                  for n, o in ((N_IN, N_HID), (N_HID, N_OUT)))
        fs.register_kernel(f"f{i}", km.Kernel(w))
    payloads = [(f"f{i}", frng.uniform(-1, 1, (1 + i % 8, N_IN))) for i in range(SERVE_FLEET_N)]
    outs = fs.engine.dispatch_fleet(payloads)
    check(any(k[0][0] == "fleet" for k in fs.engine._compiled),
          "dispatch_fleet captured no fleet graph")
    f_err = max(float(np.max(np.abs(out - fs.engine.dispatch(name, [x])[0])))
                for (name, x), out in zip(payloads, outs))
    got = [None] * SERVE_FLEET_N
    threads = [threading.Thread(target=lambda i=i: got.__setitem__(
        i, fs.infer(payloads[i][0], payloads[i][1]))) for i in range(SERVE_FLEET_N)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    f_err = max([f_err] + [float(np.max(np.abs(g - o))) for g, o in zip(got, outs)])
    fs.close()
    check(f_err <= SERVE_TOL, f"fleet vs per-kernel dispatch {f_err:.3e}")
    stats["fleet"] = dict(members=SERVE_FLEET_N, max_abs_err=f_err)
    log(f"[serve] fleet of {SERVE_FLEET_N} x 784-300-10 ANN (HPNN_SERVE_FLEET=1): one "
        f"stacked graph, max |fleet - per-kernel| {f_err:.3e}")

    # hot reload mid-load: clients stream requests while the kernel file
    # is rewritten and reloaded; every answer is the old or the new
    # version's, and the load runs on until the new version has answered.
    # Other clients stream SNN requests meanwhile: their latency while
    # the reload captures against the rest of the run
    hot = os.path.join(WORK, "serve_hot.opt")
    shutil.copyfile(ann_path, hot)
    sess.load_kernel("hot", hot)
    k_new = km.Kernel(tuple(np.asarray(w) for w in k0.weights))
    answers, lock, stop, errors = [], threading.Lock(), threading.Event(), []
    others = []  # (start, end, rows, answer) of the SNN requests

    def client(ci):
        crng = np.random.RandomState(2000 + ci)
        while not stop.is_set():
            x = crng.uniform(-1.0, 1.0, (SERVE_ROWS[ci % len(SERVE_ROWS)], N_IN))
            try:
                out = sess.infer("hot", x, timeout_s=60.0)
            except Exception as exc:  # reported below
                errors.append(repr(exc))
                return
            with lock:
                answers.append((x, out))

    def other(ci):
        crng = np.random.RandomState(3000 + ci)
        while not stop.is_set():
            x = crng.uniform(-1.0, 1.0, (SERVE_ROWS[ci % len(SERVE_ROWS)], N_IN))
            t_req = time.perf_counter()
            try:
                out = sess.infer("snn", x, timeout_s=60.0)
            except Exception as exc:  # reported below
                errors.append(repr(exc))
                return
            with lock:
                others.append((t_req, time.perf_counter(), x, out))

    def wait_for(n):
        t0 = time.perf_counter()
        while len(answers) < n and not errors and time.perf_counter() - t0 < 120:
            time.sleep(0.005)

    threads = [threading.Thread(target=client, args=(ci,)) for ci in range(SERVE_CLIENTS)]
    threads += [threading.Thread(target=other, args=(ci,)) for ci in range(SERVE_CLIENTS // 2)]
    for t in threads:
        t.start()
    try:
        wait_for(SERVE_CLIENTS * SERVE_REQUESTS // 4)
        with open(hot + ".tmp", "w") as fp:
            km.dump("hot", k_new, fp)
        os.replace(hot + ".tmp", hot)
        t0 = time.perf_counter()
        sess.reload("hot")
        t1 = time.perf_counter()
        reload_s = t1 - t0
        wait_for(len(answers) + SERVE_CLIENTS * SERVE_REQUESTS // 4)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=120)
    check(not errors and not any(t.is_alive() for t in threads),
          f"hot reload load: {errors[:3]}")
    cpu.register_kernel("hot_new", k_new)
    seen = {"old": 0, "new": 0}
    xs = [x for x, _ in answers]
    for (x, out), old_ref, new_ref in zip(answers, serve_rows_ref(cpu, "ann", xs),
                                          serve_rows_ref(cpu, "hot_new", xs)):
        old = float(np.max(np.abs(out - old_ref)))
        new = float(np.max(np.abs(out - new_ref)))
        check(min(old, new) <= SERVE_TOL, f"hot reload: an answer is neither version's "
              f"({old:.3e}, {new:.3e})")
        seen["old" if old <= new else "new"] += 1
    check(seen["old"] > 0 and seen["new"] > 0, f"hot reload: answers {seen}")
    check(sess.registry.get("hot").version == 1, "hot reload: version did not move")
    o_err = max(float(np.max(np.abs(out - ref))) for (_, _, _, out), ref in
                zip(others, serve_rows_ref(cpu, "snn", [x for _, _, x, _ in others])))
    check(o_err <= SERVE_SNN_TOL, f"SNN answers during the reload: {o_err:.3e}")
    during = [(b - a) * 1e3 for a, b, _, _ in others if a < t1 and b > t0]
    outside = [(b - a) * 1e3 for a, b, _, _ in others if not (a < t1 and b > t0)]
    check(during and outside, f"SNN requests during / outside the reload: {len(during)}, "
          f"{len(outside)}")
    beside = dict(during=len(during), during_max_ms=max(during),
                  during_p99_ms=float(np.percentile(during, 99)),
                  outside=len(outside), outside_p50_ms=float(np.percentile(outside, 50)),
                  outside_p99_ms=float(np.percentile(outside, 99)), max_abs_err_cpu_f64=o_err)
    stats["hot_reload"] = dict(seen, reload_s=reload_s, snn_beside=beside)
    log(f"[serve] hot reload mid-load ({reload_s:.2f} s: file parse, 4 captures, evict): "
        f"{seen['old']} answers of version 0 and {seen['new']} of version 1, each within "
        f"{SERVE_TOL:.0e} of its version's CPU float64 answer")
    log(f"[serve] SNN requests beside the reload: {len(during)} overlapped it, p99 "
        f"{beside['during_p99_ms']:.3f} ms max {beside['during_max_ms']:.3f} ms; "
        f"{len(outside)} outside it, p50 {beside['outside_p50_ms']:.3f} ms p99 "
        f"{beside['outside_p99_ms']:.3f} ms; max |card - cpu f64| {o_err:.3e}")
    sess.close()

    # a 2-replica router on the one card
    router = serve.Router(2, device=dev, **kw)
    router.register_kernel("ann", k_ann)
    devs = [str(r.engine.device) for r in router.replicas]
    check(devs == ["cuda:0", "cuda:0"], f"router replicas on {devs}")
    answers = []
    load = bench_serve.closed_loop(router, "ann", N_IN, n_clients=SERVE_CLIENTS,
                                   n_requests=SERVE_REQUESTS, mixed_rows=SERVE_ROWS,
                                   on_answer=lambda x, out: answers.append((x, out)))
    per = [r.engine.replay_count() for r in router.replicas]
    r_split = serve_split(np, obs, lambda: bench_serve.closed_loop(
        router, "ann", N_IN, n_clients=SERVE_CLIENTS, n_requests=SERVE_REQUESTS,
        mixed_rows=SERVE_ROWS), "router")
    router.close()
    r_err = max(float(np.max(np.abs(out - ref))) for (_, out), ref in
                zip(answers, serve_rows_ref(cpu, "ann", [x for x, _ in answers])))
    check("errors" not in load and all(p > 0 for p in per) and r_err <= SERVE_TOL,
          f"router: replays by replica {per}, max err {r_err:.3e}, {load.get('errors')}")
    stats["router"] = dict(load, replays_by_replica=per, max_abs_err=r_err, split=r_split)
    log(f"[serve] router, 2 replicas on {devs}: p50 {load['latency_ms']['p50']} ms p99 "
        f"{load['latency_ms']['p99']} ms, {load['throughput_rps']} requests/s, replays by "
        f"replica {per}, max |card - cpu f64| {r_err:.3e}")

    # serve_nn over HTTP: the CLI in its own process, a few /v1/infer calls
    proc = subprocess.Popen(
        [sys.executable, "-m", "hpnn_tpu_torch.cli.serve_nn", "--port", "0",
         "--max-batch", str(SERVE_MAX_BATCH), "cont.conf"],
        cwd=os.path.join(WORK, "ann"), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, env=dict(os.environ, PYTHONPATH=ROOT))
    try:
        port, lines = None, []
        t0 = time.perf_counter()
        while port is None and time.perf_counter() - t0 < 300:
            line = proc.stderr.readline()
            if not line:
                break
            lines.append(line)
            m = re.search(r"listening on [\d.]+:(\d+)", line)
            port = int(m.group(1)) if m else None
        check(port is not None, f"serve_nn did not listen: {''.join(lines)[-2000:]}")
        cn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        cn.request("GET", "/healthz")
        health = json.loads(cn.getresponse().read())
        check(health["buckets"] == list(eng.buckets) and health["kernels"] == ["smoke_ann"],
              f"serve_nn /healthz {health.get('kernels')} {health.get('buckets')}")
        h_err = 0.0
        for rows in (1, 3, 8, 50):
            x = rng.uniform(-1.0, 1.0, (rows, N_IN))
            cn.request("POST", "/v1/infer", body=json.dumps(
                {"kernel": "smoke_ann", "inputs": x.tolist()}))
            resp = cn.getresponse()
            body = json.loads(resp.read())
            check(resp.status == 200, f"serve_nn /v1/infer {resp.status} {body}")
            out = np.asarray(body["outputs"])
            h_err = max(h_err, float(np.max(np.abs(out - serve_rows_ref(cpu, "ann", [x])[0]))))
        cn.close()
    finally:
        proc.terminate()
        out_bytes, _ = proc.communicate(timeout=60)
    check(h_err <= SERVE_TOL, f"serve_nn over HTTP: max err {h_err:.3e}")
    check(out_bytes == "", f"serve_nn wrote {len(out_bytes)} bytes to stdout")
    cpu.close()
    stats["http"] = dict(max_abs_err=h_err, compiled=health["compiled"])
    log(f"[serve] serve_nn over HTTP ({lines[-1].strip()}): 4 /v1/infer calls of 1-50 "
        f"rows, max |card - cpu f64| {h_err:.3e}, stdout 0 bytes")
    return stats


# ------------------------------------------------------------------ planes
TENANT_KERNELS, TENANT_RESIDENT, TENANT_N = 256, 32, 8   # phase 15 (a)
TENANT_SECONDS = 6.0
PLANE_WINDOW_S = 3.0                                   # phase 15 (b)
TUNE_COOLDOWN_S, TUNE_WATCH_S, TUNE_SECONDS = 3.0, 1.0, 8.0
# every plane on: the rule watches the SLO window
PLANE_RULES = "lat@slo.p99_ms>10000:cooldown=0"
DRIFT_RULE = "drift@drift.score>1:cooldown=0"          # phase 15 (c)


def plane_env(caps, url, **extra):
    """The knobs of every serving plane (``HPNN_TUNE_DRY=1``)."""
    env = {"HPNN_ALERTS": PLANE_RULES, "HPNN_SAMPLE": "1",
           "HPNN_CAPSULE_DIR": caps, "HPNN_CAPSULE_PROFILE_MS": "200",
           "HPNN_CAPSULE_COOLDOWN_S": "0", "HPNN_DRIFT": "1",
           "HPNN_DRIFT_WINDOW": "64", "HPNN_BLAME": "1", "HPNN_METER": "1",
           "HPNN_TUNE": "1", "HPNN_TUNE_DRY": "1", "HPNN_COLLECTOR": url,
           "HPNN_COLLECTOR_FLUSH_S": "0.2"}
    env.update(extra)
    return env


CUBLAS_WORKSPACE = 32 << 20     # cuBLAS's workspace for one handle and stream


def capture_cost(np, torch, dev, k):
    """What a capture costs the kernels that keep replaying: 4 rounds of
    4 captures of a 784-300-10 forward as the engine captures (the
    ``torch.cuda.graph`` context, which synchronizes the card and
    empties the allocator's cache, under the process's capture lock),
    while another thread replays a graph and times each dispatch."""
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.serve import engine as eng_mod

    w, _ = km.to_torch(k.weights, device=dev, dtype=torch.float32)
    body = lambda x: eng_mod.batch_forward(eng_mod.ann, w, x)  # noqa: E731
    shape = (SERVE_MAX_BATCH, N_IN)
    side = torch.cuda.Stream(dev)
    replayer = eng_mod._Graph(body, shape, torch.float32, dev, side)
    block = np.zeros(shape, dtype=np.float32)
    lat, stop = [], threading.Event()

    def replay():
        while not stop.is_set():
            t0 = time.perf_counter()
            replayer(block)
            lat.append((t0, time.perf_counter() - t0))

    t = threading.Thread(target=replay)
    t.start()
    spans, ms = [], []
    time.sleep(0.2)
    try:
        for _ in range(4):
            for _ in range(4):
                t0 = time.perf_counter()
                eng_mod._Graph(body, shape, torch.float32, dev, side)
                t1 = time.perf_counter()
                ms.append((t1 - t0) * 1e3)
                spans.append((t0, t1))
                time.sleep(0.02)
            time.sleep(0.2)
    finally:
        stop.set()
        t.join()
    during = [d * 1e3 for t0, d in lat if any(a <= t0 <= b for a, b in spans)]
    quiet = [d * 1e3 for t0, d in lat if not any(a <= t0 <= b for a, b in spans)]
    out = {"capture_ms": {"p50": statistics.median(ms), "max": max(ms)},
           "replays_during": len(during),
           "replay_p99_ms": float(np.percentile(during, 99)) if during else None,
           "outside": {"replays": len(quiet),
                       "replay_p99_ms": float(np.percentile(quiet, 99))}}
    log(f"[planes] a capture beside a replaying kernel (16): {out['capture_ms']['p50']:.2f} ms "
        f"p50 ({out['capture_ms']['max']:.2f} max), the other's dispatch p99 "
        f"{out['replay_p99_ms']} ms over {len(during)}; no capture: dispatch p99 "
        f"{out['outside']['replay_p99_ms']:.3f} ms over {len(quiet)}")
    return out


def tenant_host(np, torch, dev, stats):
    """Phase 15 (a): the tenant host at full width on the card."""
    from hpnn_tpu_torch import obs, tenant
    from hpnn_tpu_torch.models import ann
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.tools import bench_serve

    # one kernel's device footprint: weights + one graph a bucket, all
    # returned when it is paged out
    obs.reset()
    pages = os.path.join(WORK, "tenant_pages")
    rng = np.random.RandomState(SEED + 15)
    k1 = km.Kernel(tuple(rng.uniform(-1, 1, (o, i)) / np.sqrt(i)
                         for i, o in ((N_IN, N_HID), (N_HID, N_OUT))))
    host = tenant.TenantSession(device=dev, resident_max=2, page_dir=pages + "_fp",
                                max_batch=SERVE_MAX_BATCH)
    alloc = []
    for name in ("a", "b", "c"):        # c pages a out
        host.register_for("t", name, k1)          # warmup: 4 captures
        torch.cuda.synchronize()
        alloc.append(torch.cuda.memory_allocated(dev))
    host.close()
    footprint = alloc[1] - alloc[0]
    check(footprint > 0 and abs(alloc[2] - alloc[1]) <= footprint // 8,
          f"page-out did not return a kernel's memory: {alloc} bytes")
    log(f"[planes] one resident 784-300-10 kernel (weights + {SERVE_MAX_BATCH}-row menu of "
        f"4 graphs): {footprint} bytes allocated; a third kernel paging the first out "
        f"moves memory_allocated by {alloc[2] - alloc[1]} bytes")
    stats["capture_cost"] = capture_cost(np, torch, dev, k1)

    obs.reset()
    kernels, answers, lock = {}, [], threading.Lock()

    def keep(tn, kn, x, out, answers=answers):
        with lock:
            answers.append((f"{tn}:{kn}", x, out))

    shutil.rmtree(pages, ignore_errors=True)
    res = bench_serve.run_bench_tenant(
        n_kernels=TENANT_KERNELS, resident=TENANT_RESIDENT, n_tenants=TENANT_N,
        zipf_s=1.2, traffic_s=TENANT_SECONDS, n_threads=SERVE_CLIENTS, hot_rate_rps=50.0,
        device=dev, rows=SERVE_ROWS, max_batch=SERVE_MAX_BATCH,
        max_wait_ms=SERVE_WAIT_MS, page_dir=pages,
        on_answer=keep, registered=kernels)
    check(res["errors"] == 0, f"tenant host: {res['error_sample']}")
    check(res["ok"] > 0 and res["page_ins"] > 0 and res["resident_cap_ok"],
          f"tenant host: ok {res['ok']} page_ins {res['page_ins']} "
          f"resident {res['resident']}")
    check(set(res["shed_by_tenant"]) <= {res["hot_tenant"]},
          f"tenant host: sheds off the hot tenant {res['shed_by_tenant']}")
    check(res["probe"]["bitwise"],
          f"tenant host: probe {res['probe']['kernel']} after a page cycle "
          f"differs by {res['probe']['max_abs_diff']:.3e}")
    # every answer against the CPU float64 answer, one batched forward a kernel
    by = {}
    for name, x, out in answers:
        by.setdefault(name, []).append((x, out))
    worst = 0.0
    for name, pairs in by.items():
        w64, _ = km.to_torch(kernels[name].weights, device="cpu", dtype=torch.float64)
        xs = np.concatenate([x for x, _ in pairs])
        with torch.no_grad():
            ref = ann.run_batch(w64, torch.from_numpy(xs)).numpy()
        got = np.concatenate([o for _, o in pairs])
        check(np.isfinite(got).all() and got.shape == ref.shape,
              f"tenant host: {name} answers malformed")
        worst = max(worst, float(np.max(np.abs(got - ref))))
    check(worst <= SERVE_TOL,
          f"tenant host: card vs CPU float64 {worst:.3e} > {SERVE_TOL:.0e}")
    mem = res["memory"]
    base = mem["start"]["allocated"]
    # the cap, plus a kernel per client pinned over it, plus one
    # cuBLAS workspace per capturing thread on the engine's side
    # stream: the clients (a page-in captures on the requesting
    # thread) and this one
    threads = SERVE_CLIENTS + 1
    bound = (base + (TENANT_RESIDENT + SERVE_CLIENTS) * footprint
             + threads * CUBLAS_WORKSPACE)
    over = [s for s in mem["samples"] if s["allocated"] > bound]
    check(mem["peak"]["allocated"] <= bound and not over,
          f"tenant host: memory_allocated peak {mem['peak']['allocated']} > "
          f"bound {bound} (start + (cap {TENANT_RESIDENT} + pins {SERVE_CLIENTS}) x "
          f"{footprint} + {threads} x {CUBLAS_WORKSPACE})")
    res.update(max_abs_err_cpu_f64=worst, answers=len(answers), footprint_bytes=footprint,
               memory_bound=bound)
    split = res["cold_split_ms"]
    lat = res["latency_ms"]
    log(f"[planes] tenant host, {TENANT_KERNELS} kernels / {TENANT_N} tenants, "
        f"resident {TENANT_RESIDENT}, Zipf 1.2, {SERVE_CLIENTS} clients x {TENANT_SECONDS:.0f} s: "
        f"goodput {res['goodput_rps']} requests/s, p50 {lat['p50']} ms p99 {lat['p99']} ms; "
        f"{res['page_ins']} page-ins, cold hit p50 {res['cold_p50_ms']} ms p99 "
        f"{res['cold_p99_ms']} ms = read {split['read_ms']} + copy {split['h2d_ms']} + "
        f"captures {split['capture_ms']} (p50/p99 ms), {res['captures_per_page_in']} "
        f"captures a page-in; sheds {res['shed_by_tenant']} (quota, hot tenant "
        f"{res['hot_tenant']} at {res['hot_rate_rps']} requests/s); {len(answers)} answers "
        f"max |card - cpu f64| {worst:.3e}; probe after a page cycle bitwise")
    log(f"[planes] tenant host memory_allocated start {base} peak "
        f"{mem['peak']['allocated']} end {mem['end']['allocated']} (bound {bound}); "
        f"memory_reserved start {mem['start']['reserved']} peak {mem['peak']['reserved']} "
        f"end {mem['end']['reserved']}; each second: "
        + " ".join(str(s["allocated"]) for s in mem["samples"]))
    stats["tenant"] = {"page_warmup": res}


def plane_windows(np, torch, dev, url, stats):
    """Phase 15 (b): the bench preset's load in ``PLANE_WINDOW_S`` windows, every plane
    off (A) and on (B), A B B A; fixed probe rows answer bitwise alike."""
    from hpnn_tpu_torch import obs, serve
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.tools import bench_serve

    k, _ = km.generate(11, N_IN, [N_HID], N_OUT)
    prng = np.random.RandomState(SEED + 151)
    probes = [prng.uniform(-1, 1, (r, N_IN)) for r in (1, 3, 8, 50)]
    runs = {"off": [], "on": []}
    answers = {}
    for side in ("off", "on", "on", "off"):
        env = plane_env(os.path.join(WORK, "caps_b"), url) if side == "on" else {}
        with knobs(obs, env):
            sess = serve.Session(device=dev, max_batch=SERVE_MAX_BATCH,
                                 max_wait_ms=SERVE_WAIT_MS)
            sess.register_kernel("bench", k)
            got = [np.asarray(sess.infer("bench", x)) for x in probes]
            load = bench_serve.closed_loop(sess, "bench", N_IN, n_clients=SERVE_CLIENTS,
                                           mixed_rows=SERVE_ROWS, duration_s=PLANE_WINDOW_S)
            armed = sess.health()["tune"]["armed"]
            sess.close()
        check("errors" not in load, f"planes {side}: {load.get('errors')}")
        check(armed == (side == "on"), f"planes {side}: tune armed {armed}")
        for i, (a, b) in enumerate(zip(got, answers.setdefault(side, got))):
            check(np.array_equal(a, b), f"planes {side}: probe {i} moved between windows")
        runs[side].append(load)
    for i, (a, b) in enumerate(zip(answers["on"], answers["off"])):
        check(np.array_equal(a, b),
              f"probe {i}: planes on vs off differ by {float(np.max(np.abs(a - b))):.3e}")
    spread = {}
    for side, loads in runs.items():
        spread[side] = {key: {"min": min(v), "max": max(v)} for key, v in (
            ("p50_ms", [x["latency_ms"]["p50"] for x in loads]),
            ("p99_ms", [x["latency_ms"]["p99"] for x in loads]),
            ("requests_per_s", [x["throughput_rps"] for x in loads]))}
        s = spread[side]
        log(f"[planes] every plane {side}, {SERVE_CLIENTS} clients x {PLANE_WINDOW_S:.0f} s "
            f"windows (A B B A): p50 {s['p50_ms']['min']}-{s['p50_ms']['max']} ms, p99 "
            f"{s['p99_ms']['min']}-{s['p99_ms']['max']} ms, "
            f"{s['requests_per_s']['min']}-{s['requests_per_s']['max']} requests/s")
    log("[planes] probe rows of 1/3/8/50 rows: planes on == off, bitwise")
    stats["overhead"] = {"order": ["off", "on", "on", "off"], "spread": spread,
                         "runs": runs}


def capsules_drift_meter(np, torch, dev, url, stats):
    """Phase 15 (c): a capture's profile holds the graph replays, an
    input shift fires the drift alert, and /meterz's device-seconds
    summed over tenants match the engine's dispatch wall.  The meter's
    device-seconds are the host clock around each dispatch (replay and
    copy-out, as in the JAX package), and the wall below is timed inside
    that interval, so the check shows that every dispatch reaches the
    meter, no record dropped or counted twice; it does not measure the
    card's own time."""
    import http.client

    from hpnn_tpu_torch import obs, serve, tenant
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.serve import engine as eng_mod

    # the engine's dispatch wall, by a clock of its own around each
    # bucket forward the engine hands out (inside the meter's interval)
    walls, wlock = [0.0], threading.Lock()
    lookup = eng_mod.Engine._compiled_forward

    def timed_lookup(self, *a, **kw):
        fn = lookup(self, *a, **kw)

        def timed(block):
            t0 = time.perf_counter()
            out = fn(block)
            with wlock:
                walls[0] += time.perf_counter() - t0
            return out
        return timed

    caps = os.path.join(WORK, "caps_c")
    # a wide drift window: the reference and live class mixes of 512
    # predictions each, so sampling noise alone stays under the breach
    with knobs(obs, plane_env(caps, url, HPNN_ALERTS=f"{PLANE_RULES},{DRIFT_RULE}",
                              HPNN_DRIFT_WINDOW="512")):
        host = tenant.TenantSession(device=dev, max_batch=SERVE_MAX_BATCH,
                                    max_wait_ms=SERVE_WAIT_MS)
        names = [f"t{i}" for i in range(4)]
        for i, t in enumerate(names):
            host.register_for(t, "k", km.generate(20 + i, N_IN, [N_HID], N_OUT)[0])
        server = serve.make_server(host)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        eng_mod.Engine._compiled_forward = timed_lookup
        shift = threading.Event()
        errors, done = [], threading.Event()

        def client(ci):
            crng = np.random.RandomState(4000 + ci)
            j = 0
            while not done.is_set():
                loc = 3.0 if shift.is_set() else 0.0
                x = crng.uniform(-1.0, 1.0, (SERVE_ROWS[(ci + j) % 4], N_IN)) + loc
                j += 1
                try:
                    host.infer_for(names[ci % 4], "k", x, timeout_s=30.0)
                except Exception as exc:  # reported below
                    errors.append(repr(exc))
                    return

        threads = [threading.Thread(target=client, args=(ci,)) for ci in range(8)]
        try:
            for t in threads:
                t.start()
            time.sleep(2.0)
            cn = http.client.HTTPConnection(*server.server_address[:2], timeout=60)
            for _ in range(20):     # 429 while an alert's capsule is in flight
                cn.request("POST", "/v1/capture", body=json.dumps({"reason": "smoke"}))
                resp = cn.getresponse()
                cap = json.loads(resp.read())
                if resp.status != 429:
                    break
                time.sleep(0.5)
            check(resp.status == 200, f"/v1/capture {resp.status} {cap}")
            fired0 = sum(r["fired"] for r in obs.alerts.health_doc()["rules"]
                         if r["rule"] == "drift")
            shift.set()
            t_shift = time.perf_counter()
            fired_at = None
            while time.perf_counter() - t_shift < 10.0 and fired_at is None:
                if sum(r["fired"] for r in obs.alerts.health_doc()["rules"]
                       if r["rule"] == "drift") > fired0:
                    fired_at = time.perf_counter() - t_shift
                time.sleep(0.01)
            done.set()
            for t in threads:
                t.join(timeout=60)
            cn.request("GET", "/meterz")
            meterz = json.loads(cn.getresponse().read())
            cn.close()
        finally:
            done.set()
            eng_mod.Engine._compiled_forward = lookup
            server.shutdown()
            server.server_close()
            host.close()
    check(not errors, f"phase 15 (c) load: {errors[:3]}")
    manifest = cap["manifest"]
    check(manifest.get("profile") is not None,
          f"the capsule holds no profile: {manifest.get('profile_refused')}")
    trace = json.load(open(os.path.join(manifest["capsule"], "profile", "trace.json")))
    launches = [e for e in trace["traceEvents"]
                if "GraphLaunch" in str(e.get("name", ""))]
    kernels_on_card = [e for e in trace["traceEvents"]
                       if e.get("cat") in ("kernel", "Kernel")]
    check(launches, "the capsule's profile holds no graph launch")
    check(sorted(f for f in manifest["files"]) == sorted(
        ["blame.json", "drift.json", "gauges.json", "health.json", "meter.json",
         "spans.jsonl"]), f"capsule files {manifest['files']}")
    check(fired_at is not None, "the input shift did not fire the drift alert in 10 s")
    dev_s = meterz["axes"]["device_s"]
    metered = sum(dev_s["top"].values()) if "top" in dev_s else dev_s["total"]
    rel = abs(metered - walls[0]) / walls[0]
    check(rel <= 0.05, f"/meterz device-seconds {metered:.6f} vs dispatch wall "
          f"{walls[0]:.6f} ({rel:.2%})")
    stats["capsule"] = {"files": manifest["files"], "graph_launches": len(launches),
                        "card_kernels": len(kernels_on_card),
                        "window_ms": manifest["profile"]["window_ms"],
                        "duration_s": manifest["duration_s"]}
    stats["drift_alert_s"] = fired_at
    stats["meter"] = {"device_s": metered, "dispatch_wall_s": walls[0], "rel": rel,
                      "by_tenant": dev_s.get("top")}
    log(f"[planes] capsule {os.path.basename(manifest['capsule'])}: {manifest['files']} + "
        f"profile/ ({manifest['profile']['window_ms']} ms torch.profiler window: "
        f"{len(launches)} graph launches, {len(kernels_on_card)} kernels on the card), "
        f"assembled in {manifest['duration_s']} s")
    log(f"[planes] input shift by +3 mid-load: the drift alert fired after {fired_at:.3f} s")
    log(f"[planes] /meterz device-seconds over {len(names)} tenants {metered:.6f} s vs the "
        f"engine's summed dispatch wall {walls[0]:.6f} s ({rel:.3%}): no dispatch dropped "
        f"by the meter (both are host clocks around the replay and copy-out)")


def tuning_live(np, torch, dev, url, stats):
    """Phase 15 (d): the tuning plane live on the card, and a forced
    rollback of a precision move."""
    from hpnn_tpu_torch import obs, serve, tune
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.serve import compile_cache
    from hpnn_tpu_torch.tools import bench_serve

    k, _ = km.generate(12, N_IN, [N_HID], N_OUT)
    # a 20 ms delay at the dispatch seam makes dispatch the tail's phase
    # (one client, no batching wait), and a 10 us objective burns budget
    env = plane_env(os.path.join(WORK, "caps_d"), url, HPNN_TUNE_DRY="0",
                    HPNN_SLO_MS="0.01", HPNN_TUNE_COOLDOWN_S=str(TUNE_COOLDOWN_S),
                    HPNN_TUNE_WATCH_S=str(TUNE_WATCH_S),
                    HPNN_CHAOS="delay@serve.dispatch:ms=20")
    chaos_lines = io.StringIO()
    with knobs(obs, env), contextlib.redirect_stderr(chaos_lines):
        sess = serve.Session(device=dev, max_batch=SERVE_MAX_BATCH, max_wait_ms=0.0)
        sess.register_kernel("k", k)
        misses0 = compile_cache.counters()[1]
        load = bench_serve.closed_loop(sess, "k", N_IN, n_clients=1, mixed_rows=SERVE_ROWS,
                                       duration_s=TUNE_SECONDS)
        live = tune.tunez_doc() is not None
        sess.tuner.stop()
        tunez = sess.tuner.tunez_doc()          # what /tunez answers
        ledger = list(sess.tuner._ledger)
        prec = sess.engine.precision_doc()["kernels"]["k"]
        captures = compile_cache.counters()[1] - misses0
        n_buckets = len(sess.engine.buckets)
        sess.close()
    other = [ln for ln in chaos_lines.getvalue().splitlines()
             if not ln.startswith("hpnn chaos: delay@serve.dispatch")]
    for ln in other[:20]:
        log(f"[planes] (stderr during the tuning load) {ln}")
    check("errors" not in load, f"tuning load: {load.get('errors')}")
    check(live, "/tunez was not armed during the load")
    applies = [r for r in ledger if r["verdict"] == "apply"]
    check(applies, f"the tuner applied nothing: {tunez['stats']} {tunez['last_verdict']}")
    gaps = [b["t"] - a["t"] for a, b in zip(applies, applies[1:])]
    check(all(g >= TUNE_COOLDOWN_S for g in gaps), f"applies {gaps} s apart")
    check(tunez["stats"]["applied"] == len(applies)
          and applies[-1]["id"] in [r.get("id") for r in tunez["ledger"]],
          f"/tunez counts {tunez['stats']['applied']} applies, the ledger {len(applies)}")
    # each precision move and each rollback of one captures the menu once;
    # a quant_err veto captures it twice (the move and its revert)
    moves = sum(1 for r in ledger if r.get("action") == "precision_down"
                and r["verdict"] in ("apply", "rollback"))
    moves += 2 * sum(1 for r in ledger if r.get("reason") == "quant_err")
    check(captures == moves * n_buckets,
          f"{moves} precision moves captured {captures} graphs ({n_buckets} buckets)")
    if any(a["action"] == "precision_down" for a in applies):
        bound = QUANT_BOUND.get(prec["precision"], 1e-2)
        check(prec.get("quant_err", 0.0) < bound,
              f"{prec['precision']} quant_err {prec.get('quant_err')} >= {bound}")
    log(f"[planes] tuning live (HPNN_SLO_MS=0.01, a 20 ms delay at serve.dispatch, cooldown "
        f"{TUNE_COOLDOWN_S} s, {TUNE_SECONDS:.0f} s of 1 client): {len(applies)} applies "
        f"{[a['action'] for a in applies]} {gaps} s apart, /tunez stats {tunez['stats']}; "
        f"kernel now {prec['precision']} (quant_err {prec.get('quant_err')}), "
        f"{captures} captures")

    # a forced rollback restores the prior policy bitwise
    with knobs(obs, {"HPNN_BLAME": "1", "HPNN_TUNE": "1"}):
        sess = serve.Session(device=dev, max_batch=SERVE_MAX_BATCH, start=True)
        sess.register_kernel("k", k)
        xs = [np.random.RandomState(SEED + i).uniform(-1, 1, (r, N_IN))
              for i, r in enumerate((1, 8, 64))]
        before = [np.asarray(sess.infer("k", x)) for x in xs]
        for i in range(64):
            obs.blame.note_record({"span": 2 * i + 1, "parent": 2 * i + 2,
                                   "name": "serve.dispatch", "t0": 0.0, "dt": 0.9})
            obs.blame.note_record({"span": 2 * i + 2, "parent": None,
                                   "name": "serve.request", "t0": 0.0, "dt": 1.0,
                                   "kernel": "k"})
        tuner = tune.Tuner(sess, policy=tune.Policy(cooldown_s=0.0), clock=lambda: 0.0,
                           p99_fn=lambda: 1.0, burn_fn=lambda: 3.0)
        d = tuner.tick()
        moved = [np.asarray(sess.infer("k", x)) for x in xs]
        back = tuner.rollback("forced")
        after = [np.asarray(sess.infer("k", x)) for x in xs]
        entry = sess.registry.get("k")
        sess.close()
    check(d["verdict"] == "apply" and d["action"] == "precision_down" and back,
          f"forced move {d}, rollback {back}")
    check(entry.precision is None, f"rollback left precision {entry.precision}")
    for i, (a, b) in enumerate(zip(before, after)):
        check(np.array_equal(a, b), f"rollback: block {i} differs by "
              f"{float(np.max(np.abs(a - b))):.3e} from before the move")
    moved_err = max(float(np.max(np.abs(a - b))) for a, b in zip(before, moved))
    stats["tune"] = {"ledger": ledger, "stats": tunez["stats"], "precision": prec,
                     "captures": captures, "forced": {"applied": d.get("applied"),
                                                      "moved_max_abs": moved_err}}
    log(f"[planes] forced precision_down to {d.get('applied')} (answers moved by "
        f"{moved_err:.3e}) and rollback: the native graphs answer bitwise as before")


def planes_summary(p):
    """The headline numbers of phase 15 for the result line (the whole
    record is ``.smoke/planes.json``)."""
    out = {"tenant": {}}
    for mode, r in p["tenant"].items():
        out["tenant"][mode] = {k: r[k] for k in (
            "goodput_rps", "latency_ms", "page_ins", "cold_p50_ms", "cold_p99_ms",
            "cold_split_ms", "captures_per_page_in", "shed_by_tenant",
            "max_abs_err_cpu_f64", "footprint_bytes", "memory_bound")}
        out["tenant"][mode]["memory"] = {k: r["memory"][k] for k in ("start", "peak", "end")}
    out["overhead"] = p["overhead"]["spread"]
    out.update({k: p[k] for k in ("capsule", "drift_alert_s", "meter", "seconds")})
    out["tune"] = {"stats": p["tune"]["stats"], "precision": p["tune"]["precision"]}
    return out


def planes_phase(np, torch, dev):
    """Phase 15: the serving planes on the card."""
    from hpnn_tpu_torch import obs

    stats = {}
    # the in-process collector's per-request stderr line, 5 a second
    obs.collector._CollectorHandler.log_message = lambda *a: None
    collector = obs.collector.start_collector(
        host="127.0.0.1", port=0, path=os.path.join(WORK, "collector.jsonl"))
    url = "http://127.0.0.1:%d" % collector.server_address[1]
    try:
        t0 = time.perf_counter()
        tenant_host(np, torch, dev, stats)
        t1 = time.perf_counter()
        plane_windows(np, torch, dev, url, stats)
        t2 = time.perf_counter()
        capsules_drift_meter(np, torch, dev, url, stats)
        t3 = time.perf_counter()
        tuning_live(np, torch, dev, url, stats)
        t4 = time.perf_counter()
    finally:
        obs.collector.stop_collector(collector)
        obs.reset()
    received = sum(1 for _ in open(os.path.join(WORK, "collector.jsonl")))
    check(received > 0, "the in-process collector received no record")
    stats["collector_records"] = received
    stats["seconds"] = {"tenant": t1 - t0, "overhead": t2 - t1, "capsule_drift_meter": t3 - t2,
                        "tune": t4 - t3}
    log(f"[planes] collector received {received} records; parts in "
        + ", ".join(f"{k} {v:.1f} s" for k, v in stats["seconds"].items()))
    return stats


# --------------------------------------------------------- phase 16: mesh
# per-sample TP samples (phase 4's data): few ANN samples, since a gloo
# TP iteration costs 5-15 ms of host time (PERF.md), and the 8 SNN
# samples whose last stops rest on a subnormal exp
MESH_ANN, MESH_SNN = 8, 8
MESH_EPOCHS = 2                      # batch epochs over the mesh
MESH_SPILL_ROWS = 4096               # the spill's request


def mesh_rank(mesh, jobs):
    """Phase 16's rank body (``dist.run`` loads this file by path): each
    job trains through the library entry point on this rank's mesh
    (``driver.train_kernel`` then ``run_kernel``, or
    ``train_kernel_batched``), in the job's dtype, with the job's ledger.
    Returns, per job, rank 0's tokens, the trained kernel, the wall time
    and the ``coll.*`` totals."""
    import numpy as np
    import torch

    from hpnn_tpu_torch import config, obs
    from hpnn_tpu_torch.parallel import coll
    from hpnn_tpu_torch.train import batch, driver, loop
    from hpnn_tpu_torch.utils import logging as plog

    loop.MAX_BP_ITER = REAL_MAX_ITER   # as phase 5: bounds the capped samples
    own = batch.default_mesh()   # a batch run's own mesh: on the world's device
    if own.device != mesh.device:
        raise RuntimeError(f"default_mesh on {own.device}, the world on {mesh.device}")
    results = []
    for i, job in enumerate(jobs):
        env = {"HPNN_DTYPE": job["dtype"]}
        if job.get("ledger"):
            env["HPNN_LEDGER"] = job["ledger"]
        sink = None
        if job["kind"] == "batch":
            # the epochs' own time: the sink's batch.block_dispatch timers
            # (the run's wall holds the 4096-file parse too)
            sink = os.path.join(os.path.dirname(job["conf"]),
                                f"sink_{os.getpid()}_{i}.jsonl")
            env["HPNN_METRICS"] = sink
        with knobs(obs, env):
            conf = config.load_conf(job["conf"])
            plog.set_verbose(2)
            coll.reset_totals()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                if job["kind"] == "tp":
                    ok = driver.train_kernel(conf, mesh=mesh)
                else:
                    ok = batch.train_kernel_batched(conf, BATCH, MESH_EPOCHS, mesh=mesh)
            if mesh.device.type == "cuda":
                torch.cuda.synchronize(mesh.device)
            secs = time.perf_counter() - t0
            totals = coll.totals()
            out, eout = buf.getvalue(), ""
            if job["kind"] == "tp" and ok:
                buf = io.StringIO()
                with contextlib.redirect_stdout(buf):
                    driver.run_kernel(conf, mesh=mesh)
                eout = buf.getvalue()
            plog.set_verbose(0)
        epoch_s = None
        if sink:
            with open(sink) as fp:
                epoch_s = sum(r["dt"] for r in map(json.loads, fp)
                              if r.get("ev") == "batch.block_dispatch")
        results.append(dict(ok=bool(ok), out=out, eval=eout, seconds=secs, coll=totals,
                            epoch_seconds=epoch_s,
                            weights=[np.asarray(w) for w in conf.kernel.weights]))
    return results


def nccl_world_of_one(mesh):
    """One NCCL rank: an all_gather and an all-reduce through coll."""
    import torch

    from hpnn_tpu_torch.parallel import coll
    from hpnn_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS

    x = torch.arange(5, dtype=torch.float32, device=mesh.device)
    g = coll.all_gather(x, mesh, MODEL_AXIS, layer=0)
    m = coll.pmean(x, mesh, DATA_AXIS, layer=0)
    torch.cuda.synchronize()
    return (torch.distributed.get_backend(), g.cpu().tolist(), m.cpu().tolist(),
            sorted(coll.totals()))


def tokens_of(out):
    """(total N_ITER, first-try OK count, lines) of a round's tokens."""
    n_iter = [int(v) for v in re.findall(r"N_ITER=\s*(\d+)", out)]
    return sum(n_iter), len(re.findall(r" OK N_ITER", out)), len(n_iter)


def mesh_phase(np, torch, dev, Xtr, Ttr, main_outs):
    """Phase 16 (see the module docstring).  Returns its figures."""
    from hpnn_tpu_torch import serve
    from hpnn_tpu_torch.cli import train_nn
    from hpnn_tpu_torch.fileio import kernel_format
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.models import snn as snn_model
    from hpnn_tpu_torch.parallel import dist
    from hpnn_tpu_torch.train import batch, driver, loop
    from hpnn_tpu_torch.utils import logging as plog

    smi = nvidia_smi_line()
    mdir = os.path.join(WORK, "mesh")
    os.makedirs(mdir)
    stats = {"card": smi}
    cwd = os.getcwd()

    # (a) world size 1: --mesh 1x1 is the single-device run, byte for byte
    try:
        for label, extra in (("per-sample", []),
                             ("batch", ["--batch", str(BATCH), "--epochs", "2"])):
            outs = {}
            for mesh_args in ([], ["--mesh", "1x1"]):
                run_dir = os.path.join(mdir, f"w1_{label}_{len(mesh_args)}")
                os.makedirs(run_dir)
                os.chdir(run_dir)
                write_conf("nn.conf", name="smoke_ann", kind="ANN", train_dir="../../train",
                           test_dir="../../test")
                if label == "per-sample" and not mesh_args:
                    # phase 4's own run is the one without --mesh
                    outs[0] = (main_outs["ANN"], open(os.path.join(WORK, "ann", "kernel.opt")).read())
                    continue
                rc, out, _ = run_cli(train_nn.main, extra + mesh_args + ["-v", "-v", "nn.conf"])
                check(rc == 0, f"[mesh] {label} train_nn {mesh_args} exit {rc}")
                outs[len(mesh_args)] = (out, open("kernel.opt").read())
            check(outs[0][0] == outs[2][0], f"[mesh] {label}: --mesh 1x1 stdout differs")
            check(outs[0][1] == outs[2][1], f"[mesh] {label}: --mesh 1x1 kernel.opt differs")
            log(f"[mesh] (a) {label} train_nn --mesh 1x1 == without --mesh: stdout "
                f"({len(outs[0][0])} bytes) and kernel.opt byte-identical")
    finally:
        os.chdir(cwd)
    (backend, g, m, ops), = dist.run(f"{os.path.abspath(__file__)}:nccl_world_of_one", 1,
                                     mesh=(1, 1), device="cuda", timeout=120)
    check(backend == "nccl" and g == [0.0, 1.0, 2.0, 3.0, 4.0] and g == m
          and ops == ["all_gather", "pmean"],
          f"[mesh] NCCL world of one: {backend} {g} {m} {ops}")
    log(f"[mesh] (a) one NCCL rank: all_gather {g}, all-reduce mean {m} through coll")

    # (b) two gloo ranks on the one card against the CPU world (f64) and
    # world size 1 on the card (f32)
    write_samples(os.path.join(mdir, "ann"), Xtr[:MESH_ANN], Ttr[:MESH_ANN])
    write_samples(os.path.join(mdir, "snn"), Xtr[:MESH_SNN], Ttr[:MESH_SNN])
    ann_opt = os.path.join(WORK, "ann", "kernel.opt")
    confs = {}
    for name, kind, train_dir, init in (
            ("tp_ann", "ANN", os.path.join(mdir, "ann"), ann_opt),
            ("tp_snn", "SNN", os.path.join(mdir, "snn"), "generate"),
            ("batch_ann", "ANN", os.path.join(WORK, "batch", "train"), "generate")):
        confs[name] = os.path.join(mdir, f"{name}.conf")
        write_conf(confs[name], name=f"mesh_{name}", kind=kind, train_dir=train_dir,
                   test_dir=os.path.join(WORK, "test"), init=init)

    def ledger_of(where, shape, name, rank="{rank}"):
        return os.path.join(mdir, f"{where}_{name}_{shape[0]}x{shape[1]}_{rank}.jsonl")

    def jobs(names, dtypes, where, shape):
        return [dict(kind="tp" if n.startswith("tp") else "batch", conf=confs[n], dtype=d,
                     name=n, ledger=ledger_of(where, shape, n) if d == "float64" else None)
                for n in names for d in dtypes]

    target = f"{os.path.abspath(__file__)}:mesh_rank"
    worlds = {}
    for where, device in (("card", "cuda:0"), ("cpu", "cpu")):
        dtypes = ("float32", "float64") if where == "card" else ("float64",)
        t0 = time.perf_counter()
        for shape, names in (((1, 2), ("tp_ann", "tp_snn", "batch_ann")),
                             ((2, 1), ("batch_ann",))):
            js = jobs(names, dtypes, where, shape)
            got = dist.run(target, 2, mesh=shape, backend="gloo", device=device,
                           args=(js,), timeout=600)
            for j, r0, r1 in zip(js, got[0], got[1]):
                check(r0["ok"] and r1["ok"], f"[mesh] {where} {shape} {j['name']} failed")
                for a, b in zip(r0["weights"], r1["weights"]):
                    check(np.array_equal(a, b), f"[mesh] {where} {j['name']}: ranks' "
                                                f"kernels differ")
                worlds[(where, shape, j["name"], j["dtype"])] = r0
        log(f"[mesh] (b) the {where} worlds in {time.perf_counter() - t0:.1f} s")

    # the SNN output's exp(z - 1) where it underflows: once every output
    # is 0 a stop rests on whether the target's turns subnormal, so the
    # card's out_exp must give 0 exactly where the CPU's does (torch.exp's
    # own misses are printed)
    zs = torch.linspace(-744.2, -699.0, 4_000_001, dtype=torch.float64)
    zc = zs.to(dev)
    got = {f: (f(zs), f(zc).cpu()) for f in (snn_model.out_exp, lambda z: torch.exp(z - 1.0))}
    (cpu_e, card_e), (cpu_p, card_p) = got.values()
    miss = int(((cpu_e == 0) != (card_e == 0)).sum())
    plain_miss = (cpu_p == 0) != (card_p == 0)
    band = (f" for z - 1 in [{float(zs[plain_miss].min()) - 1.0:.4f}, "
            f"{float(zs[plain_miss].max()) - 1.0:.4f}]" if plain_miss.any() else "")
    check(miss == 0, f"[mesh] SNN out_exp: {miss} of {zs.numel()} arguments give 0 on one "
                     f"side only (card vs CPU)")
    log(f"[mesh] (b) SNN exp(z - 1) for z in [-744.2, -699] ({zs.numel()} points), card vs "
        f"CPU: out_exp 0 on one side only at {miss}, max |diff| "
        f"{float((cpu_e - card_e).abs().max()):.3e}; torch.exp 0 on one side only at "
        f"{int(plain_miss.sum())}{band}, max |diff| "
        f"{float((cpu_p - card_p).abs().max()):.3e} -- {smi}")

    # float64: the card's two-rank ledger against the CPU's, and every
    # weight of the two trained kernels within the matrix bar
    for key in [k for k in worlds if k[0] == "card" and k[3] == "float64"]:
        _, shape, name, _ = key
        tag = f"{name} {shape[0]}x{shape[1]}"
        a, b = ledger_of("card", shape, name, 0), ledger_of("cpu", shape, name, 0)
        rc, report = ledger_diff(a, b)
        w_err = max(float(np.abs(x - y).max()) for x, y in
                    zip(worlds[key]["weights"], worlds[("cpu",) + key[1:]]["weights"]))
        if w_err > MAT_TOL:
            n_card, n_cpu = ([int(v) for v in re.findall(r"N_ITER=\s*(\d+)", w["out"])]
                             for w in (worlds[key], worlds[("cpu",) + key[1:]]))
            check(False, f"[mesh] {tag} f64: a weight differs by {w_err:.3e} between the "
                         f"card and the CPU; N_ITER by sample, card {n_card}, CPU {n_cpu}")
        # the gate on matrices is every weight within 1e-12 (above): a
        # checksum past 8192 has ulps over 1e-12 (PERF.md §7), so its
        # strict verdict is printed, not gated; anything else fails
        misses = matrix_misses(a, b) if rc == 1 else []
        check(rc == 0 or misses is not None,
              f"[mesh] {tag} f64 card vs cpu ledger: {report[-400:]}")
        last = report.splitlines()[-1].strip()
        stats.setdefault("ledger_f64", {})[tag] = dict(
            verdict=last, max_abs=re.search(r"max \|a-b\|: (\S+)", report).group(1),
            matrix_misses=misses, max_weight_diff=w_err)
        log(f"[mesh] (b) {tag} float64 two gloo ranks, card vs cpu: ledger_diff {last}"
            + "".join(f"; row {r} {t} checksum off by {d:.3e}" for r, t, d in misses)
            + f"; max |weight diff| {w_err:.3e} (gate 1e-12)")

    # float32: world size 1 on the card (the kernels) within the bands
    loop_max = loop.MAX_BP_ITER
    loop.MAX_BP_ITER = REAL_MAX_ITER
    ref = {}
    try:
        os.environ["HPNN_DTYPE"] = "float32"
        for name in ("tp_ann", "tp_snn"):
            conf = load_conf_quiet(confs[name])
            plog.set_verbose(2)
            train_out, eval_out = io.StringIO(), io.StringIO()
            with contextlib.redirect_stdout(train_out):
                ok = driver.train_kernel(conf, device=dev)
            with contextlib.redirect_stdout(eval_out):
                driver.run_kernel(conf, device=dev)
            check(ok, f"[mesh] {name} world 1 failed")
            ref[name] = (train_out.getvalue(), eval_out.getvalue())
        # 2x1 permutes the bank every epoch and steps through it in
        # order, which is world size 1's HPNN_BANK=0; 1x2 keeps the bank
        # path of world size 1
        for bank, shape in (("0", (2, 1)), ("1", (1, 2))):
            os.environ["HPNN_BANK"] = bank
            conf = load_conf_quiet(confs["batch_ann"])
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                ok = batch.train_kernel_batched(conf, BATCH, MESH_EPOCHS, device=dev)
            check(ok, "[mesh] batch world 1 failed")
            ref[("batch_ann", shape)] = buf.getvalue()
    finally:
        plog.set_verbose(0)
        loop.MAX_BP_ITER = loop_max
        os.environ.pop("HPNN_DTYPE", None)
        os.environ.pop("HPNN_BANK", None)
    for name in ("tp_ann", "tp_snn"):
        r = worlds[("card", (1, 2), name, "float32")]
        (ni, ok, lines), (ni1, ok1, lines1) = tokens_of(r["out"]), tokens_of(ref[name][0])
        n = MESH_ANN if name == "tp_ann" else MESH_SNN
        check(lines == lines1 == n, f"[mesh] {name}: {lines}/{lines1} token lines")
        check(abs(ni - ni1) <= REAL_F32_NITER_BAND * ni1,
              f"[mesh] {name} f32: total N_ITER {ni} vs world 1 {ni1}")
        check(abs(ok - ok1) <= REAL_F32_FIRST_OK_BAND,
              f"[mesh] {name} f32: first-try OK {ok} vs world 1 {ok1}")
        p, p1 = r["eval"].count("[PASS]"), ref[name][1].count("[PASS]")
        check(r["eval"].count("TESTING FILE") == N_TEST, f"[mesh] {name}: eval lines")
        check(abs(p - p1) <= max(2, BAND_COUNT_REL * N_TEST),
              f"[mesh] {name} f32: PASS {p} vs world 1 {p1}")
        coll_s = sum(v[1] for v in r["coll"].values())
        st = dict(samples=n, seconds=r["seconds"], n_iter=ni, n_iter_world1=ni1,
                  first_ok=ok, first_ok_world1=ok1, passed=p, passed_world1=p1,
                  ms_per_iter=r["seconds"] / ni * 1e3, samples_per_s=n / r["seconds"],
                  coll_share=coll_s / r["seconds"],
                  coll_calls={k: v[0] for k, v in r["coll"].items()})
        stats[name] = st
        log(f"[mesh] (b) {name} 784-300-10 f32, 2 gloo ranks on one card: {n} samples in "
            f"{r['seconds']:.2f} s ({n / r['seconds']:.2f} samples/s), N_ITER {ni} (world 1: "
            f"{ni1}), {st['ms_per_iter']:.3f} ms/iteration, {st['coll_share']:.1%} in coll.* "
            f"({st['coll_calls']}), first-try OK {ok}/{ok1}, PASS {p}/{p1} -- {smi}")
    for shape in ((2, 1), (1, 2)):
        r = worlds[("card", shape, "batch_ann", "float32")]
        got, want = epochs_of(r["out"]), epochs_of(ref[("batch_ann", shape)])
        check(len(got) == len(want) == MESH_EPOCHS, f"[mesh] batch {shape}: epoch lines")
        for (e, l, okc, n), (_, l1, ok1, _) in zip(got, want):
            check(abs(l - l1) <= BAND_LOSS_REL * abs(l1),
                  f"[mesh] batch {shape} epoch {e}: loss {l} vs world 1 {l1}")
            check(abs(okc - ok1) <= max(2, BAND_COUNT_REL * n),
                  f"[mesh] batch {shape} epoch {e}: count {okc} vs world 1 {ok1}")
        tag = f"batch_{shape[0]}x{shape[1]}"
        coll_s, ep_s = sum(v[1] for v in r["coll"].values()), r["epoch_seconds"]
        check(ep_s and ep_s > 0, f"[mesh] batch {shape}: no batch.block_dispatch timer")
        stats[tag] = dict(seconds=r["seconds"], epoch_seconds=ep_s,
                          ms_per_epoch=ep_s / MESH_EPOCHS * 1e3,
                          losses=[x[1] for x in got], losses_world1=[x[1] for x in want],
                          counts=[x[2] for x in got], counts_world1=[x[2] for x in want],
                          coll_share=coll_s / ep_s,
                          coll_calls={k: v[0] for k, v in r["coll"].items()})
        log(f"[mesh] (b) batch {shape[0]}x{shape[1]} f32 B={BATCH}, {N_BATCH_TRAIN} rows, 2 gloo "
            f"ranks on one card: {stats[tag]['ms_per_epoch']:.1f} ms/epoch with the count "
            f"({r['seconds']:.2f} s with the parse), {coll_s / ep_s:.1%} in coll.* "
            f"({stats[tag]['coll_calls']}), losses {stats[tag]['losses']} vs world 1 "
            f"{stats[tag]['losses_world1']}, counts {stats[tag]['counts']} vs "
            f"{stats[tag]['counts_world1']} -- {smi}")

    # (c) the spill on the card against the engine's replays of the same rows
    _, w_ann = kernel_format.load_kernel(ann_opt)
    rows = np.random.default_rng(SEED + 16).uniform(0, 1, (MESH_SPILL_ROWS, N_IN))
    router = serve.Router(spill=True, device=dev, max_batch=64)
    try:
        router.register_kernel("k", km.Kernel(tuple(np.asarray(w) for w in w_ann)))
        spilled = np.asarray(router.infer("k", rows))       # builds the forward
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        spilled = np.asarray(router.infer("k", rows))
        spill_s = time.perf_counter() - t0
        replay = np.concatenate([np.asarray(router.replicas[0].infer("k", rows[i:i + 64]))
                                 for i in range(0, MESH_SPILL_ROWS, 64)])
        spilled_kernels = router.health()["router"]["spilled_kernels"]
    finally:
        router.close()
    err = float(np.abs(spilled - replay).max())
    check(spilled_kernels == ["k"], f"[mesh] the spill was not taken: {spilled_kernels}")
    check(math.isfinite(err) and err <= 2.03e-07,
          f"[mesh] (c) spill vs engine replay max |diff| {err:.3e} > 2.03e-07")
    stats["spill"] = dict(rows=MESH_SPILL_ROWS, seconds=spill_s,
                          us_per_row=spill_s / MESH_SPILL_ROWS * 1e6, max_abs_err=err)
    log(f"[mesh] (c) spill of {MESH_SPILL_ROWS} rows over max_batch 64: "
        f"{stats['spill']['us_per_row']:.3f} us/row, max |spill - engine replay| {err:.3e} "
        f"(band 2.03e-07) -- {smi}")
    return stats


# ------------------------------------------------ step 0: the capture thread
# ``--capture-thread``: the cases that could hang a card once a thread
# other than the serving ones captures CUDA graphs (the online trainer's
# promotions), each run in a child process of its own under a watchdog.
CAPTURE_CASES = {
    "side_capture": "a long-lived side thread captures (12 installs x 4 buckets) "
                    "while the main thread and 4 clients replay",
    "sync": "the side thread captures while a third thread loops "
            "torch.cuda.synchronize()",
    "kernels_legacy": "the side thread captures while a third thread launches #4 "
                      "and #6 on the legacy default stream",
    "kernels_stream": "the side thread captures while a third thread launches #4 "
                      "and #6 on a stream of its own",
    "first_load": "the side thread captures while a third thread loads "
                  "batch_step.cu's library, launches #4 and #6 and makes its "
                  "first cuBLAS call, all for the first time in the process",
}
CAPTURE_RUNS = (("1", 3), (None, 2))   # CUDA_LAUNCH_BLOCKING, runs of each case
CAPTURE_INSTALLS = 12
CAPTURE_CASE_S = 150                    # a child's bound (its watchdog: 30 s less)


def capture_case(case: str) -> int:
    """One case of the capture-thread probe, in this (child) process.
    Prints one JSON line; a hang ends in every thread's stack on stdout
    (``faulthandler``) and exit code 1."""
    faulthandler.dump_traceback_later(CAPTURE_CASE_S - 30, exit=True,
                                      file=sys.stdout)
    import numpy as np
    import torch

    from hpnn_tpu_torch import serve
    from hpnn_tpu_torch.models import kernel as km

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    sess = serve.Session(max_batch=64, n_buckets=4, max_wait_ms=2.0)
    eng = sess.engine
    kernels = [km.generate(SEED + i, N_IN, [N_HID], N_OUT)[0] for i in range(2)]
    for i, k in enumerate(kernels):
        sess.register_kernel(f"k{i}", k)
    rng = np.random.default_rng(SEED)
    X = rng.random((8, N_IN))
    stop, capturing = threading.Event(), threading.Event()
    errors, counts = [], {"requests": 0, "side": 0}
    lock = threading.Lock()

    def guarded(fn):
        def run(*a):
            try:
                fn(*a)
            except BaseException as exc:
                errors.append(f"{threading.current_thread().name}: "
                              f"{type(exc).__name__}: {exc}")
                stop.set()
        return run

    def client(c):
        while not stop.is_set():
            sess.infer(f"k{c % 2}", X[:1 + c % 8])
            with lock:
                counts["requests"] += 1

    forward_of = eng._forward_of

    def forward_of_marked(*a, **kw):
        capturing.set()
        return forward_of(*a, **kw)

    eng._forward_of = forward_of_marked

    def capturer():
        for j in range(CAPTURE_INSTALLS):
            base = kernels[j % 2].weights
            sess.install_kernel(f"k{j % 2}", km.Kernel(
                weights=tuple(w * (1.0 + 1e-3 * (j + 1)) for w in base)))
        stop.set()

    def kernel_args():
        from hpnn_tpu_torch.ops import batch_step

        w = tuple(torch.tensor(a, device=dev, dtype=torch.float32)
                  for a in kernels[0].weights)
        # host data: a CUDA RNG call beside another thread's capture
        # raises by itself ("Offset increment outside graph capture")
        Xb = torch.tensor(rng.random((256, N_IN)), device=dev, dtype=torch.float32)
        Tb = torch.tensor(rng.random((256, N_OUT)), device=dev, dtype=torch.float32)
        order = np.arange(8, dtype=np.int32)
        return batch_step, (w, (), Xb, Tb, order), (
            tuple(torch.stack([a, a]).contiguous() for a in w), (),
            torch.stack([Xb, Xb]), torch.stack([Tb, Tb]), np.stack([order, order]))

    def launch_both(batch_step, one, two):
        batch_step.train_epoch_grid_banked(*one, batch=32)
        batch_step.train_fleet_epoch_dbuf_banked(*two, batch=32)
        torch.cuda.current_stream().synchronize()
        with lock:
            counts["side"] += 2

    def side():
        if case == "sync":
            while not stop.is_set():
                torch.cuda.synchronize()
                with lock:
                    counts["side"] += 1
        elif case in ("kernels_legacy", "kernels_stream"):
            ctx = (torch.cuda.stream(torch.cuda.Stream()) if case == "kernels_stream"
                   else contextlib.nullcontext())
            with ctx:
                args = kernel_args()
                while not stop.is_set():
                    launch_both(*args)
        elif case == "first_load":
            capturing.wait()
            launch_both(*kernel_args())
            a = torch.tensor(X, device=dev, dtype=torch.float32)
            (a @ a.T).sum().item()
            with lock:
                counts["side"] += 1

    if case in ("kernels_legacy", "kernels_stream"):
        # the kernels' first load and launch happen here, on the main
        # thread: this case is about their launches beside a capture
        launch_both(*kernel_args())
    threads = [threading.Thread(target=guarded(client), args=(c,), name=f"client{c}",
                                daemon=True) for c in range(1, 5)]
    threads.append(threading.Thread(target=guarded(side), name="side-work", daemon=True))
    cap = threading.Thread(target=guarded(capturer), name="capturer", daemon=True)
    eng.pin_captures(cap)
    for t in threads + [cap]:
        t.start()
    guarded(client)(0)          # the main thread replays until the captures end
    for t in threads + [cap]:
        t.join(CAPTURE_CASE_S - 60)
    alive = [t.name for t in threads + [cap] if t.is_alive()]
    torch.cuda.synchronize()
    faulthandler.cancel_dump_traceback_later()
    misses = sum(st["misses"] for st in eng.cache_stats().values())
    print(json.dumps({"case": case, "ok": not errors and not alive, "errors": errors[:3],
                      "alive": alive, "captures": misses, "requests": counts["requests"],
                      "side_ops": counts["side"],
                      "seconds": round(time.perf_counter() - t0, 3)}), flush=True)
    sess.close()
    return 0 if not errors and not alive else 1


def tp_probe_rank(mesh, jobs):
    """``--tp-repeat``'s rank body: :func:`mesh_rank` on each job, with
    every convergence iteration's ``dEp`` and the gap between its two
    largest real outputs recorded per sample (``loop.convergence_loop``
    wrapped; its numbers are untouched).  ``threads`` sets the rank's
    intra-op threads."""
    import numpy as np
    import torch

    from hpnn_tpu_torch.train import loop

    real = loop.convergence_loop
    recs = []

    def recording(one_iteration, *a, **kw):
        deps, gaps = [], []

        def step(w, m, acts):
            w, m, acts, dep = one_iteration(w, m, acts)
            out = np.sort(acts[-1].detach().cpu().numpy()[:N_OUT])
            deps.append(float(dep))
            gaps.append(float(out[-1] - out[-2]))
            return w, m, acts, dep

        res = real(step, *a, **kw)
        recs.append((deps, gaps))
        return res

    loop.convergence_loop = recording
    out = []
    for job in jobs:
        if job.get("threads"):
            torch.set_num_threads(job["threads"])
        n0 = len(recs)
        r = mesh_rank(mesh, [job])[0]
        r["threads"] = torch.get_num_threads()
        r["deps"] = [d for d, _ in recs[n0:]]
        r["gaps"] = [g for _, g in recs[n0:]]
        out.append(r)
    return out


def _parting(a, b):
    """Where two recorded runs first differ: (sample, iteration, |a-b| of
    that dEp, a's and b's iteration counts there), or None."""
    for s, (da, db) in enumerate(zip(a["deps"], b["deps"])):
        for i, (x, y) in enumerate(zip(da, db)):
            if x != y:
                return dict(sample=s, iteration=i + 1, dep_diff=abs(x - y),
                            n_iter=(len(da), len(db)))
        if len(da) != len(db):
            return dict(sample=s, iteration=min(len(da), len(db)) + 1, dep_diff=None,
                        n_iter=(len(da), len(db)))
    return None


def _margins(np, r, delta, min_iter):
    """The run's closest calls: over every iteration past ``min_iter``,
    min |dEp - delta| / delta and the least top-two output gap, each with
    its (sample, iteration)."""
    best_d, best_g = (np.inf, None), (np.inf, None)
    for s, (deps, gaps) in enumerate(zip(r["deps"], r["gaps"])):
        for i in range(min_iter, len(deps)):
            d = abs(deps[i] - delta) / delta
            if d < best_d[0]:
                best_d = (d, (s, i + 1))
            if gaps[i] < best_g[0]:
                best_g = (gaps[i], (s, i + 1))
    return dict(dep_rel_margin=best_d[0], dep_at=best_d[1], gap=best_g[0], gap_at=best_g[1])


def tp_repeat_probe(np):
    """``--tp-repeat`` (see the module docstring): phase 16's float64 TP
    SNN world (two gloo ranks, mesh 1x2, the same seeds, samples and
    conf) repeated on the card and on the CPU."""
    import hashlib

    from hpnn_tpu_torch.parallel import dist
    from hpnn_tpu_torch.train import loop

    rng = np.random.default_rng(SEED)
    protos = (rng.random((N_OUT, N_IN)) < 0.15).astype(np.float64)
    Xtr, Ttr = make_dataset(np, rng, N_TRAIN_ANN, protos)
    Xte, Tte = make_dataset(np, rng, N_TEST, protos)
    pdir = os.path.join(WORK, "tp_repeat")
    write_samples(os.path.join(pdir, "snn"), Xtr[:MESH_SNN], Ttr[:MESH_SNN])
    write_samples(os.path.join(pdir, "test"), Xte, Tte)
    conf = os.path.join(pdir, "tp_snn.conf")
    write_conf(conf, name="mesh_tp_snn", kind="SNN", train_dir=os.path.join(pdir, "snn"),
               test_dir=os.path.join(pdir, "test"))
    job = dict(kind="tp", conf=conf, dtype="float64", name="tp_snn", ledger=None)
    target = f"{os.path.abspath(__file__)}:tp_probe_rank"
    runs = []
    # the second card world runs the float32 job first, as phase 16's
    # ranks do; only the float64 runs are compared
    for world, (where, device, threads, dtypes) in enumerate((
            ("card", "cuda:0", None, ("float64", "float64")),
            ("card", "cuda:0", None, ("float32", "float64")),
            ("cpu", "cpu", None, ("float64", "float64")),
            ("cpu", "cpu", None, ("float64", "float64")),
            ("cpu", "cpu", 1, ("float64", "float64")))):
        t0 = time.perf_counter()
        got = dist.run(target, 2, mesh=(1, 2), backend="gloo", device=device,
                       args=([dict(job, dtype=d, threads=threads) for d in dtypes],),
                       timeout=600)
        for d, r0, r1 in zip(dtypes, got[0], got[1]):
            check(r0["ok"] and r1["ok"], f"[tp-repeat] {where} run failed")
            check(all(np.array_equal(a, b) for a, b in zip(r0["weights"], r1["weights"])),
                  f"[tp-repeat] {where}: the ranks' kernels differ")
            if d != "float64":
                continue
            r0["where"] = f"{where}{'' if threads is None else '-1thread'}"
            r0["process"] = world
            r0["sha"] = hashlib.sha256(b"".join(w.tobytes() for w in r0["weights"])
                                       ).hexdigest()[:16]
            runs.append(r0)
        log(f"[tp-repeat] {where} (threads {got[0][0]['threads']}) two runs in one world "
            f"in {time.perf_counter() - t0:.1f} s")
    report = {"runs": [], "pairs": []}
    for i, r in enumerate(runs):
        n_iter = [len(d) for d in r["deps"]]
        m = _margins(np, r, loop.DELTA_BP, loop.MIN_BP_ITER)
        report["runs"].append(dict(run=i, where=r["where"], process=r["process"],
                                   threads=r["threads"], sha=r["sha"], n_iter=n_iter, **m))
        log(f"[tp-repeat] run {i} {r['where']} (world {r['process']}, {r['threads']} "
            f"threads): weights {r['sha']}, N_ITER {n_iter}; closest dEp to delta "
            f"{m['dep_rel_margin']:.3e} relative at (sample, iteration) {m['dep_at']}, "
            f"least top-two gap {m['gap']:.3e} at {m['gap_at']}")
    for i, j in [(0, k) for k in range(1, len(runs))]:
        a, b = runs[i], runs[j]
        w = max(float(np.abs(x - y).max()) for x, y in zip(a["weights"], b["weights"]))
        part = _parting(a, b)
        report["pairs"].append(dict(a=i, b=j, max_weight_diff=w, parting=part))
        log(f"[tp-repeat] run {i} {a['where']} vs run {j} {b['where']}: max |weight diff| "
            f"{w:.3e}; first parting {part}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "tp_repeat.json"), "w") as fp:
        json.dump(dict(report, deps={i: r["deps"] for i, r in enumerate(runs)}), fp)


def capture_thread_probe():
    """``--capture-thread``: every case of :data:`CAPTURE_CASES`, each in
    a child process, :data:`CAPTURE_RUNS` times with and without
    ``CUDA_LAUNCH_BLOCKING=1``; a child that outlives its bound is killed
    and reported as hung.  Returns {case: [outcome, ...]}."""
    from hpnn_tpu_torch.ops import _build

    enter(0)
    t0 = time.perf_counter()
    _build.build("batch_step", force=True)
    log(f"[capture-thread] batch_step.cu built in {time.perf_counter() - t0:.1f} s")
    out_dir = os.path.join(WORK, "capture_thread")
    os.makedirs(out_dir, exist_ok=True)
    results = {}
    for case, what in CAPTURE_CASES.items():
        log(f"[capture-thread] {case}: {what}")
        for blocking, runs in CAPTURE_RUNS:
            env = dict(os.environ, PYTHONPATH=ROOT)
            env.pop("CUDA_LAUNCH_BLOCKING", None)
            if blocking:
                env["CUDA_LAUNCH_BLOCKING"] = blocking
            for r in range(runs):
                tag = f"{case}.{'blocking' if blocking else 'async'}.{r}"
                t1 = time.perf_counter()
                try:
                    p = subprocess.run([sys.executable, os.path.abspath(__file__),
                                        "--capture-case", case], env=env, cwd=ROOT,
                                       capture_output=True, text=True,
                                       timeout=CAPTURE_CASE_S)
                    rc, text = p.returncode, p.stdout + p.stderr
                except subprocess.TimeoutExpired as exc:
                    rc = None
                    text = "".join(s.decode(errors="replace") if isinstance(s, bytes)
                                   else (s or "") for s in (exc.stdout, exc.stderr))
                with open(os.path.join(out_dir, tag + ".log"), "w") as fp:
                    fp.write(text)
                doc = None
                for line in text.splitlines()[::-1]:
                    if line.startswith("{") and '"case"' in line:
                        doc = json.loads(line)
                        break
                if rc is None or "Timeout (0:" in text:
                    outcome = "hung"
                elif rc == 0 and doc is not None and doc["ok"]:
                    outcome = "ok"
                else:
                    outcome = "raised"
                results.setdefault(case, []).append(
                    {"run": tag, "outcome": outcome, "rc": rc, "doc": doc,
                     "seconds": round(time.perf_counter() - t1, 1)})
                log(f"[capture-thread] {tag}: {outcome} (rc {rc}, "
                    f"{time.perf_counter() - t1:.1f} s"
                    + (f", {doc['captures']} captures, {doc['requests']} requests, "
                       f"{doc['side_ops']} side ops" if doc else "") + ")")
                if outcome != "ok":
                    for line in text.strip().splitlines()[-25:]:
                        log(f"[capture-thread]   | {line}")
    with open(os.path.join(out_dir, "results.json"), "w") as fp:
        json.dump(results, fp, indent=1)
    log("[capture-thread] " + json.dumps(
        {c: [r["outcome"] for r in rs] for c, rs in results.items()}))
    return results


# --------------------------------------------------------- phase 17: online
ONLINE_ROWS, ONLINE_BATCH, ONLINE_EPOCHS = 256, 32, 4   # a round's window
ONLINE_INTERVAL_S = 0.25      # trainer cadence: many rounds in the phase
ONLINE_CLIENTS = 8
ONLINE_FEED, ONLINE_BLOCK = 3072, 64   # mnist_stream samples over POST /ingest
ONLINE_IDLE_S = 4.0           # clients alone, the trainer not started
ONLINE_STAGE_S = 40.0         # bound on each stage that waits for rounds
ONLINE_WATCHDOG_S = 420       # faulthandler bound of the whole phase
WORKSPACE_BYTES = 32 << 20    # cuBLAS's workspace a (thread, stream) on the H100
# One trainer round on the card against the CPU's float64 round: float64
# within the kernels' 1e-10; float32 within the fleet bands (candidate
# weights within BATCH_TOL's epoch band, the gate's losses within
# BAND_LOSS_REL relative).
ONLINE_F64_TOL = 1e-10
ONLINE_EVAL_ROWS = 64


def _percentiles(np, xs):
    if not xs:
        return {"n": 0, "p50_ms": float("nan"), "p99_ms": float("nan")}
    a = np.asarray(xs) * 1e3
    return {"n": int(a.size), "p50_ms": float(np.percentile(a, 50)),
            "p99_ms": float(np.percentile(a, 99))}


def online_parity(np, torch, kernels, Xs, Ts):
    """Phase 17 (c): one trainer round (``round_once``: the [a, b] group on
    #6 and [s] on #4, round 0's seeds) on the same fed window and eval
    set, in float32 and float64 on the card (``HPNN_DTYPE``) and in
    float64 on the CPU through the plain versions.  The gate seam
    (``candidate_hook``) collects the candidates; a gate that rejects
    every candidate keeps the round from installing."""
    from hpnn_tpu_torch import obs, online

    window = (Xs[:ONLINE_ROWS], Ts[:ONLINE_ROWS])
    eval_set = (Xs[ONLINE_ROWS:ONLINE_ROWS + ONLINE_EVAL_ROWS],
                Ts[ONLINE_ROWS:ONLINE_ROWS + ONLINE_EVAL_ROWS])
    out = {}
    for tag, device, dtype in (("cuda-f32", "cuda", "float32"),
                               ("cuda-f64", "cuda", "float64"),
                               ("cpu-f64", "cpu", "float64")):
        with knobs(obs, {"HPNN_DTYPE": dtype}):
            o = online.OnlineSession(serve_kwargs={"device": device}, rows=ONLINE_ROWS,
                                     batch=ONLINE_BATCH, epochs=ONLINE_EPOCHS,
                                     interval_s=3600.0, seed=SEED, holdout=0,
                                     eval_set=eval_set, gate=online.Gate(margin=1.0))
            for name, (k, model) in kernels.items():
                o.add_kernel(name, k, model=model, warmup=False)
            cands = {}
            o.trainer.candidate_hook = lambda name, ws: cands.setdefault(name, ws)
            o.feed(*window)
            summary = o.trainer.round_once()
            check(summary["trained"] == len(kernels) and summary["promoted"] == 0,
                  f"online parity round on {tag}: {summary}")
            out[tag] = {n: (cands[n], o.promoter.last_losses[n][0]) for n in kernels}
            o.close()
    ref = out["cpu-f64"]
    report = {}
    for tag in ("cuda-f64", "cuda-f32"):
        w_err = max(float(np.max(np.abs(a - b))) for n in ref
                    for a, b in zip(out[tag][n][0], ref[n][0]))
        l_rel = max(abs(out[tag][n][1] - ref[n][1]) / max(1.0, abs(ref[n][1]))
                    for n in ref)
        report[tag] = {"max_abs_weight_err": w_err, "max_rel_loss_err": l_rel}
        if tag == "cuda-f64":
            check(w_err <= ONLINE_F64_TOL and l_rel <= ONLINE_F64_TOL,
                  f"online round float64: card vs CPU weights {w_err:.3e}, loss "
                  f"{l_rel:.3e} (tol {ONLINE_F64_TOL:.0e})")
        else:
            band = BATCH_TOL[("float32", "epoch")]
            check(w_err <= band and l_rel <= BAND_LOSS_REL,
                  f"online round float32: weights {w_err:.3e} (band {band:.0e}), "
                  f"loss {l_rel:.3e} relative (band {BAND_LOSS_REL:.0e}) against the "
                  f"CPU's float64")
        log(f"[online] (c) {tag} vs cpu-f64, round_once of 3 kernels (#6 on [a, b], "
            f"#4 on [s]): max |w| err {w_err:.3e}, max gate-loss rel err {l_rel:.3e}")
    return report


def online_round_split(np, torch, kernels, Xs, Ts, smi):
    """Phase 17 (d): a trainer round's wall time and the device time of its
    groups' training (#4 and #6 with their bank gathers), from CUDA events
    on the trainer stream; three rounds on a fresh session whose gate
    rejects every candidate (no install), the median printed."""
    from hpnn_tpu_torch import online

    o = online.OnlineSession(serve_kwargs=dict(max_batch=64, n_buckets=4),
                             rows=ONLINE_ROWS, batch=ONLINE_BATCH,
                             epochs=ONLINE_EPOCHS, interval_s=3600.0, seed=SEED,
                             gate=online.Gate(margin=1.0))
    for name, (k, model) in kernels.items():
        o.add_kernel(name, k, model=model)
    o.feed(Xs[:ONLINE_FEED], Ts[:ONLINE_FEED])
    tr = o.trainer
    train_group = tr._train_group
    marks = []

    def timed_group(entries, X, T):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record(tr.stream)
        res = train_group(entries, X, T)
        e1.record(tr.stream)
        marks.append((len(entries), e0, e1))
        return res

    tr._train_group = timed_group
    tr.warm()
    rows = []
    for _ in range(3):
        marks.clear()
        t0 = time.perf_counter()
        tr.round_once()
        wall = time.perf_counter() - t0
        tr.stream.synchronize()
        rows.append((wall * 1e3, {("#6" if n > 1 else "#4"): e0.elapsed_time(e1)
                                  for n, e0, e1 in marks}))
    o.close()
    wall_ms = statistics.median(r[0] for r in rows)
    split = {g: statistics.median(r[1][g] for r in rows) for g in rows[0][1]}
    share = sum(split.values()) / wall_ms
    log(f"[online] (d) {smi}: a round of 3 kernels ({ONLINE_ROWS} rows, B={ONLINE_BATCH}, "
        f"{ONLINE_EPOCHS} epochs): wall {wall_ms:.1f} ms (median of 3), device time of "
        f"its training " + ", ".join(f"{g} {v:.2f} ms" for g, v in split.items())
        + f" ({share * 100:.1f}% of the wall)")
    return {"round_wall_ms": wall_ms, "round_train_device_ms": split,
            "round_train_share": share}


def online_phase(np, torch, dev, k_ann):
    """Phase 17: Slice F, train-while-serve at 784-300-10 (the module
    docstring lists what it holds).  ``k_ann``: phase 4's trained ANN
    (a generated one under ``--online-only``).  Runs under a watchdog
    that prints every thread's stack on stdout and exits 1 if the
    phase outlives ``ONLINE_WATCHDOG_S``."""
    faulthandler.dump_traceback_later(ONLINE_WATCHDOG_S, exit=True, file=sys.stdout)
    try:
        return _online_phase(np, torch, dev, k_ann)
    except BaseException:
        log("[online] every thread's stack at the failure:")
        faulthandler.dump_traceback(file=sys.stdout, all_threads=True)
        raise
    finally:
        faulthandler.cancel_dump_traceback_later()


def gpu_state() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=utilization.gpu,power.draw,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip() or out.stderr.strip()


def stall_watch(stop, last, limit_s):
    """Until ``stop``: when no client has been answered for ``limit_s``
    (``last[0]``: the time of the last answer), print the card's
    utilization and every thread's stack, once."""
    while not stop.wait(0.5):
        idle = time.perf_counter() - last[0]
        if idle > limit_s:
            log(f"[online] STALL: no answer for {idle:.1f} s; card (util, power, "
                f"sm clock): {gpu_state()}; every thread's stack:")
            faulthandler.dump_traceback(file=sys.stdout, all_threads=True)
            return


def _online_phase(np, torch, dev, k_ann):
    import gc
    import http.client

    from hpnn_tpu_torch import online, serve
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.online import streams
    from hpnn_tpu_torch.ops import batch_step

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    work = os.path.join(WORK, "online")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    os.environ["HPNN_WAL_DIR"] = os.path.join(work, "wal")
    kernels = {
        "a": (k_ann, "ann"),
        "b": (km.generate(SEED + 17, N_IN, [N_HID], N_OUT)[0], "ann"),
        "s": (km.generate(SEED + 19, N_IN, [N_HID], N_OUT)[0], "snn"),
    }
    t0 = time.perf_counter()
    Xs, Ts = streams.take(streams.mnist_stream(SEED), ONLINE_FEED + 16)
    probes = {n: Xs[ONLINE_FEED + i:ONLINE_FEED + i + 1] for i, n in enumerate(kernels)}
    log(f"[online] {ONLINE_FEED + 16} mnist_stream samples rendered in "
        f"{time.perf_counter() - t0:.1f} s")

    gc.collect()
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    osess = online.OnlineSession(
        serve_kwargs=dict(max_batch=64, n_buckets=4, max_wait_ms=2.0),
        rows=ONLINE_ROWS, batch=ONLINE_BATCH, epochs=ONLINE_EPOCHS,
        interval_s=ONLINE_INTERVAL_S, holdout=8, seed=SEED,
        gate=online.Gate(margin=0.0, watch_s=3600.0))
    check(osess.wal is not None, "HPNN_WAL_DIR did not arm the promotion WAL")
    eng = osess.serve.engine
    for name, (k, model) in kernels.items():
        osess.add_kernel(name, k, model=model)
    n_buckets = len(eng.buckets)

    def misses():
        return sum(st["misses"] for st in eng.cache_stats().values())

    warm_captures = misses()
    check(warm_captures == len(kernels) * n_buckets,
          f"warmup captured {warm_captures} graphs, want {len(kernels) * n_buckets}")
    torch.cuda.synchronize()
    m1 = torch.cuda.memory_allocated()

    # every version served, every install (its thread and time), every
    # capture's thread and every verdict of the gate
    versions = {n: [osess.serve.registry.get(n)] for n in kernels}
    installs, capture_threads, verdicts = [], set(), []
    lock = threading.Lock()
    install_kernel = osess.serve.install_kernel
    forward_of = eng._forward_of
    consider = osess.promoter.consider
    stage = {"name": "idle", "rollback_of": None}

    def install_logged(name, kernel, **kw):
        t = time.perf_counter()
        entry = install_kernel(name, kernel, **kw)
        with lock:
            installs.append((name, entry.version, time.perf_counter() - t,
                             threading.current_thread().name))
            versions[name].append(entry)
        return entry

    def forward_logged(*a, **kw):
        with lock:
            capture_threads.add(threading.current_thread().name)
        return forward_of(*a, **kw)

    def resident_hook(name, w):
        return tuple(np.asarray(x) for x in osess.serve.registry.get(name).kernel.weights)

    def consider_logged(name, cand, eval_set, **kw):
        outcome = consider(name, cand, eval_set, **kw)
        poisoned = not all(np.isfinite(np.asarray(w)).all() for w in cand)
        with lock:
            verdicts.append(("nan" if poisoned else stage["name"], name, outcome))
        if stage["rollback_of"] == name and outcome == "promoted":
            # one promotion of the drill's kernel, then none (a candidate
            # equal to the resident fails the margin)
            osess.trainer.candidate_hook = resident_hook
            stage["rollback_of"] = None
        return outcome

    osess.serve.install_kernel = install_logged
    eng._forward_of = forward_logged
    osess.promoter.consider = consider_logged

    server = serve.make_server(osess.serve, port=0)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True,
                     name="smoke-online-http").start()
    stop_clients = threading.Event()
    errors, answers = [], {n: {} for n in kernels}
    lat = {"idle": [], "busy": []}
    fed = {"posted": 0}
    window = {"name": "idle"}
    names = list(kernels)

    last_answer = [time.perf_counter()]

    def client(c):
        name = names[c % len(names)]
        x = probes[name]
        try:
            while not stop_clients.is_set():
                w = window["name"]
                t = time.perf_counter()
                y = osess.infer(name, x)
                last_answer[0] = time.perf_counter()
                dt = last_answer[0] - t
                key = np.asarray(y, dtype=np.float64).tobytes()
                with lock:
                    lat.setdefault(w, []).append(dt)
                    answers[name][key] = answers[name].get(key, 0) + 1
        except Exception as exc:
            errors.append(f"client {c}: {type(exc).__name__}: {exc}")

    def post(lo, hi):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        try:
            for i in range(lo, hi, ONLINE_BLOCK):
                body = json.dumps({"inputs": Xs[i:i + ONLINE_BLOCK].tolist(),
                                   "targets": Ts[i:i + ONLINE_BLOCK].tolist()})
                conn.request("POST", "/ingest", body=body,
                             headers={"Content-Type": "application/json"})
                r = conn.getresponse()
                doc = json.loads(r.read())
                if r.status != 200:
                    errors.append(f"POST /ingest {r.status}: {doc}")
                    return
                fed["posted"] += int(doc["accepted"])
                time.sleep(0.2)
        except Exception as exc:
            errors.append(f"feeder: {type(exc).__name__}: {exc}")
        finally:
            conn.close()

    def wait_for(cond, what):
        deadline = time.perf_counter() + ONLINE_STAGE_S
        while not cond():
            check(not errors, f"{what}: {errors[:3]}")
            check(osess.trainer.running(), f"{what}: the trainer thread died")
            check(time.perf_counter() < deadline,
                  f"{what} did not happen within {ONLINE_STAGE_S:.0f} s (last "
                  f"verdicts {verdicts[-6:]}, trainer {osess.trainer.stats})")
            time.sleep(0.05)

    def promoted(n):
        return sum(1 for _s, k, o in verdicts if k == n and o == "promoted")

    clients = [threading.Thread(target=client, args=(c,), daemon=True,
                                name=f"smoke-online-client{c}")
               for c in range(ONLINE_CLIENTS)]
    for t in clients:
        t.start()
    threading.Thread(target=stall_watch, args=(stop_clients, last_answer, 3.0),
                     daemon=True, name="smoke-online-stall-watch").start()
    # (a) the idle window: the clients and the first third of the stream,
    # no trainer; then every launch count to 0 and the trainer started
    third = (ONLINE_FEED // 3) // ONLINE_BLOCK * ONLINE_BLOCK
    t_idle = time.perf_counter()
    post(0, third)
    time.sleep(max(0.0, ONLINE_IDLE_S - (time.perf_counter() - t_idle)))
    for key in batch_step.launches:
        batch_step.launches[key] = 0
    t_start = time.perf_counter()
    window["name"] = "busy"
    osess.start()          # warm on this thread, then the trainer thread
    warm_s = time.perf_counter() - t_start
    feeder = threading.Thread(target=post, args=(third, ONLINE_FEED), daemon=True,
                              name="smoke-online-feed")
    feeder.start()
    stage["name"] = "train"
    wait_for(lambda: (promoted("a") + promoted("b")) >= 1 and promoted("s") >= 1
             and osess.trainer.stats["rounds"] >= 4, "a promotion of each group")
    feeder.join(ONLINE_STAGE_S)
    check(not feeder.is_alive(), "the /ingest feeder did not finish")
    busy_s = time.perf_counter() - t_start

    # (b) a NaN candidate is rejected while the clients go on being answered
    def poison(name, w):
        bad = [np.asarray(x).copy() for x in w]
        bad[0][0, 0] = np.nan
        return tuple(bad)

    stage["name"] = "poison"
    osess.trainer.candidate_hook = poison
    wait_for(lambda: sum(1 for s, _k, _o in verdicts if s == "nan") >= len(kernels),
             "a judged NaN candidate")
    osess.trainer.candidate_hook = resident_hook
    stage["name"] = "settle"
    nan_verdicts = [o for s, _k, o in verdicts if s == "nan"]
    check(set(nan_verdicts) == {"sentinel"},
          f"NaN candidates met {sorted(set(nan_verdicts))}, want only 'sentinel'")
    n_settle = len(verdicts)
    wait_for(lambda: len(verdicts) >= n_settle + len(kernels), "a settled round")
    window["name"] = "quiet"
    stop_clients.set()
    for t in clients:
        t.join(30)
    check(not errors, f"phase 17 load: {errors[:3]}")

    # a forced rollback: one more promotion of "a", then a rollback asked
    # for from this thread (queued to the trainer thread)
    y0 = osess.infer("a", probes["a"])
    v0 = osess.serve.registry.get("a").version
    stage.update(name="rollback", rollback_of="a")
    osess.trainer.candidate_hook = None
    wait_for(lambda: osess.serve.registry.get("a").version > v0,
             "the rollback drill's promotion of a")
    y1 = osess.infer("a", probes["a"])
    check(osess.rollback("a") is not None, "the forced rollback found nothing to restore")
    y2 = osess.infer("a", probes["a"])
    check(not np.array_equal(y0, y1), "the drill's promotion did not change a's answer")
    check(np.array_equal(y0, y2),
          f"after the rollback a answers {y2} != {y0} before the promotion (bitwise)")

    launches = {k: batch_step.launches[k] for k in ("train_epoch_grid_banked",
                                                    "train_fleet_epoch_dbuf_banked")}
    check(launches["train_epoch_grid_banked"] > 0, "phase 17 launched no #4")
    check(launches["train_fleet_epoch_dbuf_banked"] > 0, "phase 17 launched no #6")
    stats = dict(osess.trainer.stats)
    check(stats["failed"] == 0, f"{stats['failed']} online rounds failed")
    n_installs = len(installs)
    n_promoted = sum(1 for _s, _k, o in verdicts if o == "promoted")
    check(n_installs == n_promoted + 1,
          f"{n_installs} installs for {n_promoted} promotions and 1 rollback")
    captures = misses() - warm_captures
    check(captures == n_installs * n_buckets,
          f"{captures} captures after warmup for {n_installs} installs x {n_buckets} "
          "buckets")
    trainer_name = osess.trainer._thread.name
    install_threads = {t for _n, _v, _dt, t in installs}
    check(install_threads == {trainer_name},
          f"installs ran on {sorted(install_threads)}, want the trainer thread alone")
    new_capturers = capture_threads - {threading.current_thread().name}
    check(new_capturers == {trainer_name},
          f"captures after warmup ran on {sorted(capture_threads)}")

    # every answer is one version's graph replay, bitwise (never a torn mix)
    torn, by_version = [], {}
    for name, seen in answers.items():
        refs = {}
        for e in versions[name]:
            y = np.asarray(eng.eager_rows(e, probes[name]), dtype=np.float64)
            refs.setdefault(y.tobytes(), e.version)
        for key, count in seen.items():
            v = refs.get(key)
            if v is None:
                y = np.frombuffer(key, dtype=np.float64)
                near = min(float(np.max(np.abs(y - np.frombuffer(r, dtype=np.float64))))
                           for r in refs)
                torn.append((name, count, near))
            else:
                by_version.setdefault(name, {}).setdefault(v, 0)
                by_version[name][v] += count
    check(not torn, f"answers of no version (kernel, count, nearest |diff|): {torn[:5]}")
    n_answers = sum(sum(s.values()) for s in answers.values())
    for name in kernels:    # the eager references' weights go again
        eng.evict(name, keep_version=osess.serve.registry.get(name).version)
    gc.collect()
    torch.cuda.synchronize()
    m_end = torch.cuda.memory_allocated()
    # the trainer thread holds two cuBLAS workspaces (its stream's, for the
    # gate's eval, and the capture stream's), and this thread may add one
    # on its own stream (the warm eval and the eager references)
    bound = m1 + 2 * WORKSPACE_BYTES * len(new_capturers) + WORKSPACE_BYTES
    check(m_end <= bound,
          f"memory_allocated {m_end} B at the end > {bound} B (after warmup {m1} B, "
          f"+ 2 workspaces x {len(new_capturers)} capturing thread created, + 1)")
    final = {n: tuple(np.asarray(w) for w in osess.serve.registry.get(n).kernel.weights)
             for n in kernels}
    osess.close()
    server.shutdown()
    server.server_close()
    check(fed["posted"] == ONLINE_FEED and osess.buffer.total_fed() == ONLINE_FEED,
          f"/ingest accepted {fed['posted']}, buffer fed {osess.buffer.total_fed()}, "
          f"want {ONLINE_FEED}")

    # a fresh session on the same HPNN_WAL_DIR restores the last committed
    # weights, bitwise
    fresh = online.OnlineSession(serve_kwargs=dict(max_batch=64, n_buckets=4))
    for name, (k, model) in kernels.items():
        fresh.add_kernel(name, k, model=model)
    check(sorted(fresh.restored) == sorted(kernels), f"WAL restored {fresh.restored}")
    for name in kernels:
        got = fresh.serve.registry.get(name).kernel.weights
        check(all(np.asarray(g).tobytes() == f.tobytes() for g, f in zip(got, final[name])),
              f"the WAL restore of {name} differs from the last resident weights")
    reasons = {r["kernel"]: r["reason"] for r in osess.wal.records()}
    fresh.close()
    os.environ.pop("HPNN_WAL_DIR", None)

    # (c) one round's parity, then (d) the printed numbers
    parity = online_parity(np, torch, kernels, Xs, Ts)
    prom = [dt * 1e3 for _n, _v, dt, _t in installs]
    lat_idle, lat_busy = _percentiles(np, lat["idle"]), _percentiles(np, lat["busy"])
    out = {
        "launches": launches,
        "rounds": stats["rounds"], "starved": stats["starved"],
        "round_failed": stats["failed"],
        "promoted": {n: promoted(n) for n in kernels},
        "rejected_nan": len(nan_verdicts), "rollbacks": 1,
        "installs": n_installs, "captures_after_warmup": captures,
        "capturing_threads_created": sorted(new_capturers),
        "answers": n_answers, "answers_by_version": by_version,
        "memory": {"start": m0, "after_warmup": m1, "end": m_end, "bound": bound},
        "promote_ms": {"n": len(prom), "median": statistics.median(prom),
                       "max": max(prom)},
        "warm_s": warm_s, "busy_s": busy_s,
        "infer_idle": lat_idle, "infer_busy": lat_busy,
        "wal_last_reasons": reasons, "parity": parity,
    }
    out.update(online_round_split(np, torch, kernels, Xs, Ts, smi))
    log(f"[online] {smi}: {stats['rounds']} rounds ({stats['starved']} starved, "
        f"{stats['failed']} failed) beside {n_answers} answers to {ONLINE_CLIENTS} "
        f"clients; launches #4 {launches['train_epoch_grid_banked']}, #6 "
        f"{launches['train_fleet_epoch_dbuf_banked']}; promotions {out['promoted']}, "
        f"{len(nan_verdicts)} NaN candidates rejected, 1 rollback bitwise; "
        f"{n_installs} installs x {n_buckets} buckets = {captures} captures on "
        f"{sorted(new_capturers)}")
    log(f"[online] {smi}: promote latency (install + {n_buckets} captures) median "
        f"{out['promote_ms']['median']:.1f} ms, max {out['promote_ms']['max']:.1f} ms "
        f"over {len(prom)} installs; warm-up {warm_s:.2f} s")
    log(f"[online] {smi}: infer latency, trainer idle: p50 {lat_idle['p50_ms']:.3f} ms "
        f"p99 {lat_idle['p99_ms']:.3f} ms (n {lat_idle['n']}); trainer busy: p50 "
        f"{lat_busy['p50_ms']:.3f} ms p99 {lat_busy['p99_ms']:.3f} ms (n {lat_busy['n']})")
    log(f"[online] {smi}: memory_allocated start {m0} B, after warmup {m1} B, end "
        f"{m_end} B (bound {bound} B); capturing threads created: "
        f"{len(new_capturers)}; last WAL records {reasons}")
    log(f"[online] phase 17 in {time.perf_counter() - t_phase:.1f} s")
    return out


# ------------------------------------------------------------ the fleet
FLEET_CLIENTS = 6            # phase 18: clients through the edge
FLEET_INSTALLS = 3           # fenced installs under their load
FLEET_READY_S = 240.0        # a worker's spawn -> ready bound
FLEET_SCALE_S = 120.0        # bound on each autoscaler edge awaited
FLEET_ANSWER_TOL = 1e-5      # a version's card answer against CPU float64
FLEET_WORKER_ARGS = ("--interval-s", "600")   # online_nn flags: the trainer parked


def _edge_infer(port, body):
    """One ``POST /v1/infer`` to the fleet's edge: (status, doc)."""
    import http.client

    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("POST", "/v1/infer", body=body,
                     headers={"Content-Type": "application/json"})
        resp = conn.getresponse()
        raw = resp.read()
        try:
            return resp.status, json.loads(raw)
        except ValueError:
            return resp.status, raw.decode("utf-8", "replace")
    finally:
        conn.close()


def _apps_memory():
    """{pid: MiB} of the card's compute processes, as nvidia-smi reads them
    (empty when it shows none)."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    mem = {}
    for line in out.stdout.strip().splitlines():
        parts = [p.strip() for p in line.split(",")]
        if len(parts) == 2 and parts[0].isdigit() and parts[1].isdigit():
            mem[int(parts[0])] = int(parts[1])
    return mem


class _FleetLoad:
    """Clients in back-to-back loops through the fleet's edge: answers
    by bytes, latencies, retriable answers (429/503/504) and anything
    else as an error."""

    def __init__(self, np, port, body, n):
        self.np, self.port, self.body = np, port, body
        self.stop = threading.Event()
        self.lock = threading.Lock()
        self.answers, self.lat, self.retriable, self.errors = {}, [], 0, []
        self.threads = []
        self.add(n)

    def add(self, n):
        for _ in range(n):
            t = threading.Thread(target=self._loop, daemon=True)
            t.start()
            self.threads.append(t)

    def _loop(self):
        while not self.stop.is_set():
            t0 = time.perf_counter()
            try:
                status, doc = _edge_infer(self.port, self.body)
            except OSError as exc:
                status, doc = 0, repr(exc)
            dt = time.perf_counter() - t0
            with self.lock:
                if status == 200:
                    key = self.np.asarray(doc["outputs"], dtype=self.np.float64).tobytes()
                    self.answers[key] = self.answers.get(key, 0) + 1
                    self.lat.append(dt)
                elif status in (429, 503, 504):
                    self.retriable += 1
                else:
                    self.errors.append((status, str(doc)[:200]))

    def close(self):
        self.stop.set()
        for t in self.threads:
            t.join(60)


def fleet_phase(np, torch, dev):
    """Phase 18: the serving fleet over two ``online_nn`` worker
    processes on the card (module doc).  Returns its statistics."""
    from hpnn_tpu_torch import fleet, obs, serve
    from hpnn_tpu_torch.fleet.router import CheckpointPublisher
    from hpnn_tpu_torch.models import ann
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.online import wal as wal_mod

    t_phase = time.perf_counter()
    smi = nvidia_smi_line()
    work = os.path.join(WORK, "fleet")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    conf = os.path.join(work, "nn.conf")
    with open(conf, "w") as fp:
        fp.write(f"[name] fleet\n[type] ANN\n[init] generate\n[seed] {SEED}\n"
                 f"[input] {N_IN}\n[hidden] {N_HID}\n[output] {N_OUT}\n[train] BP\n")
    wal_dir = os.path.join(work, "wal")
    ks = [km.generate(SEED + 18 + v, N_IN, [N_HID], N_OUT)[0]
          for v in range(FLEET_INSTALLS + 1)]
    wal_mod.PromotionWAL(wal_dir).commit("fleet", ks[0].weights, version=1, reason="seed")
    rng = np.random.default_rng(SEED + 18)
    probe = rng.random(N_IN)
    body = json.dumps({"kernel": "fleet", "inputs": probe.tolist(),
                       "timeout_s": 10.0}).encode()
    sink = os.path.join(work, "fleet.jsonl")
    obs.configure(sink)
    sup = fleet.WorkerSupervisor(conf, workdir=work, kind="online", wal_dir=wal_dir,
                                 args=FLEET_WORKER_ARGS, ready_timeout_s=FLEET_READY_S,
                                 drain_timeout_s=30.0,
                                 # the sink above is this process's: the
                                 # workers record nothing
                                 env={"HPNN_METRICS": ""})
    router = edge = load = scaler = None
    out = {}
    try:
        # (a) two workers, spawned at once, the router and its edge
        free0 = torch.cuda.mem_get_info()[0]
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            spawn_s = [f.result() - t0 for f in [pool.submit(
                lambda: (sup.spawn(), time.perf_counter())[1]) for _ in range(2)]]
        router = fleet.ClusterRouter(supervisor=sup,
                                     publisher=CheckpointPublisher(wal_dir=wal_dir))
        inside = []     # seconds each edge request spent in ClusterRouter.infer
        route = router.infer

        def timed_route(*a, **kw):
            t = time.perf_counter()
            try:
                return route(*a, **kw)
            finally:
                inside.append(time.perf_counter() - t)

        router.infer = timed_route
        edge = serve.make_server(router)
        threading.Thread(target=edge.serve_forever, daemon=True).start()
        port = edge.server_address[1]
        # what the two workers took of the card, device-wide (nvidia-smi
        # may list no compute process from inside a container)
        per_worker_mib = (free0 - torch.cuda.mem_get_info()[0]) / 2 / 2**20
        mem = _apps_memory()
        worker_mem = {f"r{r}": mem.get(sup.workers[r].pid) for r in sup.ranks()}

        def cpu_answer(k):
            ws = [torch.tensor(w, dtype=torch.float64) for w in k.weights]
            return ann.run(ws, torch.tensor(probe, dtype=torch.float64)).numpy()

        refs = {}

        def version_answer(v):
            """Every worker's answer to the probe now: bitwise alike, and
            within FLEET_ANSWER_TOL of the CPU's float64 forward of ks[v]."""
            got = [np.asarray(h.infer("fleet", probe, timeout_s=30.0), dtype=np.float64)
                   for h in sup.handles()]
            check(all(np.array_equal(g, got[0]) for g in got),
                  f"fleet version {v}: the workers answer differently: {got}")
            err = float(np.max(np.abs(got[0] - cpu_answer(ks[v]))))
            check(err <= FLEET_ANSWER_TOL,
                  f"fleet version {v}: |card - cpu f64| {err:.3e} > {FLEET_ANSWER_TOL:.0e}")
            refs[got[0].tobytes()] = v
            return got[0], err

        y0, e0 = version_answer(0)
        cpu_err = [e0]
        # (b) fenced installs under load
        load = _FleetLoad(np, port, body, FLEET_CLIENTS)
        fan_ms = []
        for v in range(1, FLEET_INSTALLS + 1):
            time.sleep(0.3)
            t0 = time.perf_counter()
            router.install_kernel("fleet", ks[v])
            fan_ms.append((time.perf_counter() - t0) * 1e3)
            cpu_err.append(version_answer(v)[1])
        time.sleep(0.3)
        # (c) one worker SIGKILLed under the same load
        y_last = version_answer(FLEET_INSTALLS)[0]
        victim = sup.ranks()[0]
        t_kill = time.perf_counter()
        sup.kill9(victim)
        sup.workers[victim].proc.wait(30)
        time.sleep(0.5)
        replaced = sup.replace_dead()
        recovery_s = time.perf_counter() - t_kill
        check(len(replaced) == 1 and sup.width() == 2,
              f"fleet: {len(replaced)} workers replaced, width {sup.width()}")
        y_rep = np.asarray(replaced[0].handle.infer("fleet", probe, timeout_s=30.0),
                           dtype=np.float64)
        check(np.array_equal(y_rep, y_last),
              "fleet: the replacement's answer differs bitwise from the last version's")
        last_wal = max(r["version"] for r in wal_mod.PromotionWAL(wal_dir).records()
                       if r["kernel"] == "fleet")
        restored = (replaced[0].handle.health() or {}).get("online", {}).get("wal", {})
        check(restored.get("restored") == {"fleet": last_wal},
              f"fleet: the replacement restored {restored.get('restored')}, want WAL "
              f"version {last_wal}")
        time.sleep(0.5)
        load.close()
        retriable = load.retriable
        check(not load.errors, f"fleet load: non-retriable answers {load.errors[:3]}")
        torn = {k: n for k, n in load.answers.items() if k not in refs}
        check(not torn, f"fleet load: {sum(torn.values())} answers of no version")
        by_version = {}
        for k, n in load.answers.items():
            by_version[refs[k]] = by_version.get(refs[k], 0) + n
        lat = _percentiles(np, load.lat)
        routed = _percentiles(np, inside)
        check(lat["n"] > 0, "fleet load: no answer")
        for h in sup.handles():
            check(np.array_equal(np.asarray(h.infer("fleet", probe, timeout_s=30.0),
                                            dtype=np.float64), y_last),
                  f"fleet: worker r{h.rank} did not converge on the last version")
        mem = _apps_memory()
        worker_mem.update({f"r{r}": mem.get(sup.workers[r].pid) for r in sup.ranks()})
        # (d) a SIGTERM drain, then the autoscaler's ride 1 -> 2 -> 1
        rc = sup.drain_and_kill(sup.ranks()[-1])
        check(rc == 0 and sup.width() == 1, f"fleet: the drained worker exited {rc}")
        policy = fleet.Policy(min_width=1, max_width=2, up_step=1, down_step=1,
                              up_outstanding=1.0, down_outstanding=0.5,
                              up_cooldown_s=1.0, down_cooldown_s=2.0, down_for_s=2.0)
        # on the Autoscaler's default signals: the router's outstanding
        # rows per worker, its shed total and the SLO burn
        load = _FleetLoad(np, port, body, 0)
        scaler = fleet.Autoscaler(sup, router, policy=policy, interval_s=0.25)
        scaler.start()
        t_ramp = time.perf_counter()
        load.add(2)
        deadline = t_ramp + FLEET_SCALE_S
        while sup.width() < 2 and time.perf_counter() < deadline:
            if len(load.threads) < 8:
                load.add(2)       # the ramp: two more clients a second
            time.sleep(1.0)
        up_s = time.perf_counter() - t_ramp
        check(sup.width() == 2, f"fleet: the autoscaler did not grow the fleet in "
                                f"{FLEET_SCALE_S:.0f} s")
        load.close()
        check(not load.errors, f"fleet ramp: non-retriable answers {load.errors[:3]}")
        t_calm = time.perf_counter()
        while sup.width() > 1 and time.perf_counter() < t_calm + FLEET_SCALE_S:
            time.sleep(0.25)
        down_s = time.perf_counter() - t_calm
        check(sup.width() == 1, f"fleet: the autoscaler did not drain back to 1 in "
                                f"{FLEET_SCALE_S:.0f} s")
        scaler.stop()
        scaler = None
        obs.configure(None)
        recs = [json.loads(line) for line in open(sink) if line.strip()]
        ups = [r for r in recs if r.get("ev") == "fleet.scale_up"]
        downs = [r for r in recs if r.get("ev") == "fleet.scale_down"]
        gone = [r for r in recs if r.get("ev") == "fleet.worker_down"
                and r.get("reason") == "scale_down"]
        check([(u["from_width"], u["to_width"]) for u in ups] == [(1, 2)]
              and [(d["from_width"], d["to_width"]) for d in downs] == [(2, 1)],
              f"fleet: scale events up {ups} down {downs}")
        check(gone and all(r["returncode"] == 0 and not r["escalated"] for r in gone),
              f"fleet: drained workers {gone}")
        worker_up = [r for r in recs if r.get("ev") == "fleet.worker_up"]
        out = dict(spawn_ready_s=spawn_s, worker_up_s=[r["spawn_s"] for r in worker_up],
                   fanout_ms=fan_ms, edge_latency=lat, in_router=routed,
                   answers_by_version=by_version,
                   retriable=retriable, recovery_s=recovery_s, cpu_err=cpu_err,
                   worker_mem_mib=worker_mem, per_worker_mib=per_worker_mib,
                   scale_up_s=up_s, scale_down_s=down_s,
                   scale_up=ups, scale_down=downs)
        log(f"[fleet] {smi}: 2 online_nn workers, spawn -> ready "
            f"{', '.join(f'{t:.2f}' for t in spawn_s)} s (no compile cache: the bucket "
            f"captures and the trainer's warm round included); every spawn: "
            f"{', '.join(f'{r['spawn_s']:.2f}' for r in worker_up)} s")
        log(f"[fleet] {smi}: {FLEET_INSTALLS} fenced installs under {FLEET_CLIENTS} clients, "
            f"fan-out {', '.join(f'{t:.1f}' for t in fan_ms)} ms; answers by version "
            f"{dict(sorted(by_version.items()))}, none torn; each version within "
            f"{max(cpu_err):.3e} of the CPU float64 forward")
        log(f"[fleet] {smi}: through the edge p50 {lat['p50_ms']:.3f} ms p99 "
            f"{lat['p99_ms']:.3f} ms (n {lat['n']}); inside ClusterRouter.infer (the "
            f"worker's HTTP round trip) p50 {routed['p50_ms']:.3f} ms p99 "
            f"{routed['p99_ms']:.3f} ms (n {routed['n']})")
        log(f"[fleet] {smi}: SIGKILL of r{victim} under load -> replacement "
            f"r{replaced[0].rank} ready in {recovery_s:.2f} s, serving WAL version "
            f"{last_wal} bitwise; retriable answers under the installs and the loss: "
            f"{retriable}")
        log(f"[fleet] {smi}: autoscaler 1 -> 2 in {up_s:.2f} s of a ramp to 8 clients, "
            f"2 -> 1 in {down_s:.2f} s of calm, drained workers exit 0")
        log(f"[fleet] {smi}: device memory a worker: {per_worker_mib:.0f} MiB (the card's free "
            f"memory before and after the first two spawns, halved); nvidia-smi "
            f"--query-compute-apps (MiB): {worker_mem}")
        log(f"[fleet] phase 18 in {time.perf_counter() - t_phase:.1f} s")
        return out
    finally:
        obs.configure(None)
        if scaler is not None:
            scaler.stop()
        if load is not None:
            load.close()
        if edge is not None:
            edge.shutdown()
            edge.server_close()
        if router is not None:
            router.close()
        sup.close()


# ------------------------------------------------------------ deep nets
# Phase 19: every kernel at full MNIST width and 20 layers.  The weights
# are uniform in +-2*sqrt(3/m), a gain of about one a layer through the
# tanh-sigmoid: the generator's 1/sqrt(m) shrinks the signal by ~0.3 a
# layer, so a generated net this deep is dead (outputs 0, deltas 0).
DEEP_HIDDEN = [N_HID] * 19     # 784-(300x19)-10: 20 layers, 1.86 M weights
DEEP_PINNED_K = 10             # #1: max_iter, so K+1 iterations a sample
DEEP_SAMPLES = 4               # #1 against plain, and the per-sample round
DEEP_MAX_ITER = 30             # the per-sample round's cap, card and CPU
DEEP_TESTS = 16                # run_nn's files
DEEP_ROWS = 2 * BATCH          # the --batch epoch's files: two steps
DEEP_FLEET_N = 4


def deep_layers():
    return len(DEEP_HIDDEN) + 1


def deep_shape():
    return f"{N_IN}-({DEEP_HIDDEN[0]}x{len(DEEP_HIDDEN)})-{N_OUT}"


def deep_weights(np, rng, lead=()):
    """784-(300x19)-10 weights (``lead``: stacked members) of gain ~1."""
    dims = [N_IN] + DEEP_HIDDEN + [N_OUT]
    return [rng.uniform(-2 * math.sqrt(3 / m), 2 * math.sqrt(3 / m), tuple(lead) + (n, m))
            for m, n in zip(dims[:-1], dims[1:])]


def write_deep_conf(path, *, kind="ANN", train_dir, test_dir, init):
    with open(path, "w") as fp:
        fp.write(f"[name] smoke_deep\n[type] {kind}\n[init] {init}\n[seed] {SEED}\n"
                 f"[input] {N_IN}\n[hidden] {' '.join(map(str, DEEP_HIDDEN))}\n"
                 f"[output] {N_OUT}\n[train] BP\n[sample_dir] {train_dir}\n"
                 f"[test_dir] {test_dir}\n")


def deep_kernels(np, torch, dev, Xtr, Ttr):
    """Phase 19 (a): #1, #2-#5 and #6 (4 members) against their plain
    versions at 784-(300x19)-10, float32 at the shallow bars and float64
    within 1e-10; bf16 #6 against its bf16 plain version, printed and
    gated on being finite; each kernel's time at this depth.  Returns
    {kernel: {dtype: max error}} and the times."""
    from hpnn_tpu_torch.obs.cost import batch_work, bound_ms, work_of
    from hpnn_tpu_torch.ops import batch_step as bs
    from hpnn_tpu_torch.ops import convergence

    rng = np.random.default_rng(SEED + 19)
    W = deep_weights(np, rng)
    err = {k: {} for k in ["convergence"] + [n for n, _, _ in BATCH_KERNELS]
           + ["train_fleet_epoch_dbuf_banked", "train_fleet_epoch_dbuf_banked (bf16)"]}
    times = {}

    def note(name, dname, e):
        err[name][dname] = max(err[name].get(dname, 0.0), e)

    # #1: the weights stream from device memory (they do not fit the
    # cluster's shared memory), dw too with momentum
    for model, momentum in (("ann", False), ("ann", True), ("snn", False)):
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[1]
            tag = f"{model}-{'BPM' if momentum else 'BP'} {dname}"
            T = Ttr[:DEEP_SAMPLES].copy()
            if model == "snn":
                T = np.where(T > 0, 1.0, 0.0)
            X = torch.tensor(Xtr[:DEEP_SAMPLES], dtype=dtype, device=dev)
            T = torch.tensor(T, dtype=dtype, device=dev)
            w0 = [torch.tensor(w, dtype=dtype, device=dev) for w in W]
            kw = dict(model=model, momentum=momentum, min_iter=5, max_iter=DEEP_PINNED_K)
            p = convergence.plan(w0, dtype, momentum)
            check(not p.weights_resident, f"#1 {tag}: the plan keeps 1.86 M weights resident")
            wk, wp = [t.clone() for t in w0], [t.clone() for t in w0]
            sk = convergence.train_epoch(wk, X, T, 0.2, -1e30, **kw)
            sp = convergence.train_epoch_plain(wp, X, T, 0.2, -1e30, **kw)
            torch.cuda.synchronize()
            check(sk.n_iter.tolist() == sp.n_iter.tolist() == [DEEP_PINNED_K + 1] * DEEP_SAMPLES,
                  f"#1 {tag}: n_iter {sk.n_iter.tolist()} / {sp.n_iter.tolist()}")
            check(sk.first_ok.tolist() == sp.first_ok.tolist(), f"#1 {tag}: first_ok differs")
            e = max(state_err(wk, wp), state_err([sk.out], [sp.out]))
            check(math.isfinite(e) and e <= TOL[dname],
                  f"#1 {tag} at {deep_layers()} layers: |kernel - plain| {e:.3e} > "
                  f"{TOL[dname]:.0e}")
            check(any(not torch.equal(a, b) for a, b in zip(wk, w0)),
                  f"#1 {tag}: the kernel left every layer unchanged")
            note("convergence", dname, e)
            # the same bits at either CTA count, and from the other build
            for plan in [dict(cluster=C) for C in CLUSTERS] + [dict(grid=not p.grid)]:
                wc = [t.clone() for t in w0]
                sc = convergence.train_epoch(wc, X, T, 0.2, -1e30, **plan, **kw)
                check(same_run((wc, sc), (wk, sk)),
                      f"#1 {tag}: {plan} differs bitwise from the plan's {plan_str(p)}")
            log(f"[deep] #1 {tag} {deep_shape()}, {DEEP_SAMPLES} samples x "
                f"{DEEP_PINNED_K + 1} iterations: "
                f"max|kernel - plain| {e:.3e} (tol {TOL[dname]:.0e}); plan {plan_str(p)}; "
                f"C = {', '.join(map(str, CLUSTERS))} and the "
                f"{'one-cluster' if p.grid else 'grid'} build bitwise alike")
    wt = [torch.tensor(w, dtype=torch.float32, device=dev) for w in W]
    X = torch.tensor(Xtr[:DEEP_SAMPLES], dtype=torch.float32, device=dev)
    T = torch.tensor(Ttr[:DEEP_SAMPLES], dtype=torch.float32, device=dev)
    kw = dict(model="ann", min_iter=5, max_iter=DEEP_PINNED_K)
    k_ms = cuda_ms(torch, lambda: convergence.train_epoch(wt, X, T, 0.2, -1e30, **kw))
    iters = DEEP_SAMPLES * (DEEP_PINNED_K + 1)
    nbytes, flops = work_of(wt, DEEP_SAMPLES, iters, False, 4)
    b_ms, b_by = bound_ms(nbytes, flops, "float32")
    times["convergence"] = dict(ms=k_ms, us_per_iter=k_ms / iters * 1e3, bound_ms=b_ms,
                                bound_by=b_by)
    log(f"[deep] #1 ANN-BP float32 {deep_shape()}, {DEEP_SAMPLES} samples x "
        f"{DEEP_PINNED_K + 1} iterations: {k_ms:.3f} ms ({k_ms / iters * 1e3:.2f} us/iteration), "
        f"bound {b_ms:.4f} ms ({b_by})")

    # #2-#5: S = 8 steps of B = 256 on a 2048-row bank
    shapes = [tuple(w.shape) for w in W]
    Xb, Tb = batch_bank(np, rng, (N_IN, N_HID, N_OUT), PINNED_S * BATCH)
    order = rng.permutation(PINNED_S)
    for model, momentum in (("ann", False), ("snn", True)):
        dW = [rng.uniform(-1e-3, 1e-3, w.shape) for w in W] if momentum else None
        kw = dict(model=model, momentum=momentum)
        for dtype in (torch.float32, torch.float64):
            dname = str(dtype).split(".")[1]
            tag = f"{model}-{'BPM' if momentum else 'BP'} {dname}"
            Xd = torch.tensor(Xb, dtype=dtype, device=dev)
            Td = torch.tensor(Tb, dtype=dtype, device=dev)

            def fresh():
                return ([torch.tensor(w, dtype=dtype, device=dev) for w in W],
                        [torch.tensor(m, dtype=dtype, device=dev) for m in dW] if momentum
                        else [])

            line = []
            for name, _, _ in BATCH_KERNELS:
                fn, plain = getattr(bs, name), getattr(bs, name + "_plain")
                (wk, dwk), (wp, dwp) = fresh(), fresh()
                if "epoch" in name:
                    lk = fn(wk, dwk, Xd, Td, order, batch=BATCH, **kw)[2]
                    lp = plain(wp, dwp, Xd, Td, order, batch=BATCH, **kw)[2]
                else:
                    lk, lp = [], []
                    for s, blk in enumerate(order):
                        for f, w, dw, ls in ((fn, wk, dwk, lk), (plain, wp, dwp, lp)):
                            if name == "train_step_fused_batch":
                                rows = slice(int(blk) * BATCH, (int(blk) + 1) * BATCH)
                                ls.append(f(w, dw, Xd[rows], Td[rows], **kw)[2])
                            else:
                                ls.append(f(w, dw, Xd, Td, int(blk), batch=BATCH, **kw)[2])
                        if s == 0:
                            torch.cuda.synchronize()
                            e1 = max(state_err(wk + dwk, wp + dwp),
                                     loss_err(lk[0].reshape(1), lp[0].reshape(1)))
                            tol1 = BATCH_TOL[(dname, "step")]
                            check(math.isfinite(e1) and e1 <= tol1,
                                  f"{name} {tag} at {deep_layers()} layers: first step "
                                  f"|kernel - plain| {e1:.3e} > {tol1:.0e}")
                    lk, lp = torch.stack(lk), torch.stack(lp)
                torch.cuda.synchronize()
                e = max(state_err(wk + dwk, wp + dwp), loss_err(lk, lp))
                tol = BATCH_TOL[(dname, "epoch")]
                check(math.isfinite(e) and e <= tol,
                      f"{name} {tag} at {deep_layers()} layers: {PINNED_S} steps "
                      f"|kernel - plain| {e:.3e} > {tol:.0e}")
                note(name, dname, e)
                line.append(f"{name.replace('train_', '')} {e:.2e}")
            log(f"[deep] {tag} {deep_shape()}, B={BATCH} S={PINNED_S}: max|kernel - plain| "
                + ", ".join(line))
    Xd = torch.tensor(Xb, dtype=torch.float32, device=dev)
    Td = torch.tensor(Tb, dtype=torch.float32, device=dev)
    wt = [torch.tensor(w, dtype=torch.float32, device=dev) for w in W]
    g_ms = cuda_ms(torch, lambda: bs.train_epoch_grid_banked(wt, [], Xd, Td, order,
                                                             batch=BATCH))
    nbytes, flops = batch_work(shapes, PINNED_S, False, 4, BATCH)
    b_ms, b_by = bound_ms(nbytes, flops, "float32")
    times["train_epoch_grid_banked"] = dict(ms=g_ms, us_per_step=g_ms / PINNED_S * 1e3,
                                            bound_ms=b_ms, bound_by=b_by)
    log(f"[deep] #4 ANN-BP float32, one epoch of {PINNED_S} steps of B={BATCH}: {g_ms:.3f} ms "
        f"({g_ms / PINNED_S * 1e3:.1f} us/step), bound {b_ms:.4f} ms ({b_by})")

    # #6: 4 members, each its own bank and order; then its bf16 build
    N = DEEP_FLEET_N
    Wf = deep_weights(np, rng, (N,))
    banks = [batch_bank(np, rng, (N_IN, N_HID, N_OUT), PINNED_S * BATCH) for _ in range(N)]
    orders = np.stack([rng.permutation(PINNED_S) for _ in range(N)])
    for model, momentum in (("ann", False), ("snn", True)):
        dWf = [rng.uniform(-1e-3, 1e-3, w.shape) for w in Wf] if momentum else None
        kw = dict(batch=BATCH, model=model, momentum=momentum)
        for dtype in (torch.float32, torch.float64, torch.bfloat16):
            dname = str(dtype).split(".")[1]
            tag = f"{model}-{'BPM' if momentum else 'BP'} {dname}"
            Xd = torch.tensor(np.stack([x for x, _ in banks]), dtype=dtype, device=dev)
            Td = torch.tensor(np.stack([t for _, t in banks]), dtype=dtype, device=dev)

            def fresh():
                return ([torch.tensor(w, dtype=dtype, device=dev) for w in Wf],
                        [torch.tensor(m, dtype=dtype, device=dev) for m in dWf] if momentum
                        else [])

            (wk, dwk), (wp, dwp), (w0, _) = fresh(), fresh(), fresh()
            lk = bs.train_fleet_epoch_dbuf_banked(wk, dwk, Xd, Td, orders, **kw)[2]
            lp = bs.train_fleet_epoch_dbuf_banked_plain(wp, dwp, Xd, Td, orders, **kw)[2]
            torch.cuda.synchronize()
            plan = bs.fleet_cluster(N, shapes, BATCH, bs.cluster_capacity(dtype, dev))
            if dtype == torch.bfloat16:
                we = state_err([t.float() for t in wk + dwk], [t.float() for t in wp + dwp])
                ue = update_err(wk, wp, w0)
                le = float(((lk - lp).abs() / lp.abs()).max())
                check(all(math.isfinite(v) for v in (we, ue, le)),
                      f"bf16 #6 {tag} at {deep_layers()} layers: errors not finite "
                      f"({we}, {ue}, {le})")
                name = "train_fleet_epoch_dbuf_banked (bf16)"
                err[name][model + ("-BPM" if momentum else "-BP")] = dict(
                    w=we, update_rel=ue, loss_rel=le)
                log(f"[deep] bf16 #6 {tag}, N={N} B={BATCH} S={PINNED_S}, C={plan}: "
                    f"max|kernel - plain| weights {we:.3e}, each layer's change {ue:.3e} "
                    f"relative, losses {le:.3e} relative (no band at this depth: printed, "
                    f"gated on being finite; BF16_BAND at 2 layers is {BF16_BAND})")
                continue
            e = max(state_err(wk + dwk, wp + dwp), loss_err(lk, lp))
            tol = BATCH_TOL[(dname, "epoch")]
            check(math.isfinite(e) and e <= tol,
                  f"#6 {tag} at {deep_layers()} layers: |kernel - plain| {e:.3e} > {tol:.0e}")
            note("train_fleet_epoch_dbuf_banked", dname, e)
            log(f"[deep] #6 {tag}, N={N} B={BATCH} S={PINNED_S}, C={plan}: max|kernel - "
                f"plain| {e:.3e} (tol {tol:.0e})")
    for dtype, name in ((torch.float32, "train_fleet_epoch_dbuf_banked"),
                        (torch.bfloat16, "train_fleet_epoch_dbuf_banked (bf16)")):
        wt = [torch.tensor(w, dtype=dtype, device=dev) for w in Wf]
        Xd = torch.tensor(np.stack([x for x, _ in banks]), dtype=dtype, device=dev)
        Td = torch.tensor(np.stack([t for _, t in banks]), dtype=dtype, device=dev)
        f_ms = cuda_ms(torch, lambda: bs.train_fleet_epoch_dbuf_banked(
            wt, [], Xd, Td, orders, batch=BATCH))
        dname = str(dtype).split(".")[1]
        nbytes, flops = batch_work(shapes, PINNED_S, False, wt[0].element_size(), BATCH)
        b_ms, b_by = bound_ms(N * nbytes, N * flops, dname)
        times[name] = dict(ms=f_ms, members=N, bound_ms=b_ms, bound_by=b_by)
        log(f"[deep] #6 {dname} ANN-BP, {N} members x one epoch of {PINNED_S} steps of "
            f"B={BATCH}: {f_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by})")
    return err, times


def deep_entry_points(np, torch, dev, Xtr, Ttr, Xte, Tte, protos):
    """Phase 19 (b): ``train_nn`` (a per-sample round, then ``run_nn``)
    and ``train_nn --batch`` (one epoch) on a 784-(300x19)-10 conf, on
    the card in float64 and on the CPU in float64, the launch counts set
    to 0 just before each card run and read just after: the tokens
    equal, ``kernel.opt`` within 1e-12, ``BATCH EPOCH`` counts equal
    and its loss within 1e-12; then docs/api.md's flow through
    ``hpnn_tpu_torch.train_kernel``/``run_kernel`` with no device
    argument (the card, float32).  Returns statistics."""
    import hpnn_tpu_torch
    from hpnn_tpu_torch import obs
    from hpnn_tpu_torch.cli import run_nn, train_nn
    from hpnn_tpu_torch.fileio import kernel_format
    from hpnn_tpu_torch.ops import batch_step as bs
    from hpnn_tpu_torch.ops import convergence
    from hpnn_tpu_torch.train import loop
    from hpnn_tpu_torch.utils import logging as nn_log

    ddir = os.path.join(WORK, "deep")
    write_samples(os.path.join(ddir, "train"), Xtr[:DEEP_SAMPLES], Ttr[:DEEP_SAMPLES])
    write_samples(os.path.join(ddir, "test"), Xte[:DEEP_TESTS], Tte[:DEEP_TESTS])
    rng = np.random.default_rng(SEED + 23)
    Xb, Tb = make_dataset(np, rng, DEEP_ROWS, protos)
    write_samples(os.path.join(ddir, "batch"), Xb, Tb)
    with open(os.path.join(ddir, "deep.opt"), "w") as fp:
        kernel_format.dump_kernel("smoke_deep", deep_weights(np, rng), fp)
    cwd = os.getcwd()
    stats = {}

    def cli(label, main, argv, conf_init, env):
        run_dir = os.path.join(ddir, label)
        os.makedirs(run_dir, exist_ok=True)
        os.chdir(run_dir)
        try:
            write_deep_conf("nn.conf", train_dir="../batch" if "--batch" in argv else "../train",
                            test_dir="../test", init=conf_init)
            buf = io.StringIO()
            t0 = time.perf_counter()
            with knobs(obs, env), contextlib.redirect_stdout(buf):
                rc = main(argv + ["-v", "-v", "nn.conf"])
            check(rc == 0, f"deep {label}: exit {rc}")
            return buf.getvalue(), time.perf_counter() - t0, run_dir
        finally:
            os.chdir(cwd)

    def weights_err(a, b):
        wa = kernel_format.load_kernel(os.path.join(a, "kernel.opt"))[1]
        wb = kernel_format.load_kernel(os.path.join(b, "kernel.opt"))[1]
        check([w.shape for w in wa] == [w.shape for w in wb], "deep: kernel.opt shapes differ")
        check(len(wa) == deep_layers(), f"deep: kernel.opt holds {len(wa)} layers")
        return max(float(np.abs(x - y).max()) for x, y in zip(wa, wb))

    f64 = {"HPNN_DTYPE": "float64"}
    max_iter = loop.MAX_BP_ITER
    loop.MAX_BP_ITER = DEEP_MAX_ITER
    try:
        runs = {}
        for where, extra in (("cuda", []), ("cpu", ["--device", "cpu"])):
            convergence.launches = 0
            out, secs, rdir = cli(f"ps_{where}", train_nn.main, extra, "../deep.opt", f64)
            launched = convergence.launches
            runs[where] = (out, secs, rdir, launched)
        check(runs["cuda"][3] > 0, "deep: the card's per-sample round launched no #1")
        check(runs["cpu"][3] == 0, "deep: the CPU's per-sample round launched #1")
        lines = {w: training_lines(r[0]) for w, r in runs.items()}
        check(len(lines["cuda"]) == DEEP_SAMPLES, f"deep: {len(lines['cuda'])} token lines")
        check(lines["cuda"] == lines["cpu"],
              "deep per-sample f64: the card's tokens differ from the CPU's:\n"
              + "\n".join(lines["cuda"] + lines["cpu"]))
        e_ps = weights_err(runs["cuda"][2], runs["cpu"][2])
        check(e_ps <= MAT_TOL, f"deep per-sample f64: kernel.opt card vs CPU {e_ps:.3e}")
        iters = sum(int(m) for m in N_ITER_RE.findall(runs["cpu"][0]))
        evals = {}
        for where, extra in (("cuda", []), ("cpu", ["--device", "cpu"])):
            out, secs, _ = cli(f"ps_{where}", run_nn.main, extra, "kernel.opt", f64)
            evals[where] = (out, secs)
        tested = {w: [ln for ln in r[0].splitlines() if "TESTING FILE" in ln]
                  for w, r in evals.items()}
        check(len(tested["cuda"]) == DEEP_TESTS, f"deep run_nn: {len(tested['cuda'])} eval lines")
        check(tested["cuda"] == tested["cpu"], "deep run_nn f64: the card's tokens differ from "
              "the CPU's:\n" + "\n".join(tested["cuda"] + tested["cpu"]))
        stats["per_sample"] = dict(
            samples=DEEP_SAMPLES, iterations=iters, launches=runs["cuda"][3],
            kernel_opt_max_abs_diff=e_ps, cuda_seconds=runs["cuda"][1],
            cpu_seconds=runs["cpu"][1], run_nn_cuda_seconds=evals["cuda"][1],
            run_nn_cpu_seconds=evals["cpu"][1])
        log(f"[deep] train_nn {deep_shape()} ANN-BP float64, {DEEP_SAMPLES} samples at most "
            f"{DEEP_MAX_ITER} iterations ({iters} in all): card {runs['cuda'][3]} launches of "
            f"#1 in {runs['cuda'][1]:.2f} s, CPU {runs['cpu'][1]:.2f} s; tokens identical, "
            f"kernel.opt within {e_ps:.3e}; run_nn on {DEEP_TESTS} files: tokens identical "
            f"(card {evals['cuda'][1]:.2f} s, CPU {evals['cpu'][1]:.2f} s)")

        bargv = ["--batch", str(BATCH), "--epochs", "1"]
        bruns = {}
        for where, extra in (("cuda", []), ("cpu", ["--device", "cpu"])):
            for k in bs.launches:
                bs.launches[k] = 0
            out, secs, rdir = cli(f"batch_{where}", train_nn.main, extra + bargv,
                                  "../deep.opt", f64)
            bruns[where] = (out, secs, rdir, dict(bs.launches))
        check(bruns["cuda"][3]["train_epoch_grid_banked"] > 0,
              f"deep --batch: the card launched no #4 ({bruns['cuda'][3]})")
        check(not any(bruns["cpu"][3].values()), "deep --batch: the CPU run launched a kernel")
        ep = {w: epochs_of(r[0]) for w, r in bruns.items()}
        check(len(ep["cuda"]) == 1 and len(ep["cpu"]) == 1, f"deep --batch: epochs {ep}")
        (_, lc, okc, nc), (_, lp, okp, np_) = ep["cuda"][0], ep["cpu"][0]
        check((okc, nc) == (okp, np_), f"deep --batch: counts {okc}/{nc} vs {okp}/{np_}")
        check(abs(lc - lp) <= MAT_TOL, f"deep --batch: loss {lc!r} vs {lp!r}")
        e_b = weights_err(bruns["cuda"][2], bruns["cpu"][2])
        check(e_b <= MAT_TOL, f"deep --batch f64: kernel.opt card vs CPU {e_b:.3e}")
        stats["batch"] = dict(rows=DEEP_ROWS, launches=bruns["cuda"][3], loss_cuda=lc,
                              loss_cpu=lp, count=okc, kernel_opt_max_abs_diff=e_b,
                              cuda_seconds=bruns["cuda"][1], cpu_seconds=bruns["cpu"][1])
        log(f"[deep] train_nn --batch {BATCH} --epochs 1 float64 on {DEEP_ROWS} files: "
            f"card {bruns['cuda'][3]['train_epoch_grid_banked']} launch of #4 in "
            f"{bruns['cuda'][1]:.2f} s, CPU {bruns['cpu'][1]:.2f} s; BATCH EPOCH loss "
            f"{lc:.12f} vs {lp:.12f}, count {okc}/{nc} both; kernel.opt within {e_b:.3e}")

        # docs/api.md's flow on the card: no device argument
        hpnn_tpu_torch.runtime.init_all(0)
        conf = hpnn_tpu_torch.NNConf(
            name="embedded_deep", type=hpnn_tpu_torch.NNType.ANN,
            train=hpnn_tpu_torch.NNTrain.BP, seed=SEED,
            f_kernel=os.path.join(ddir, "deep.opt"))
        check(hpnn_tpu_torch.load_kernel(conf), "deep api: load_kernel failed")
        check(len(conf.kernel.weights) == deep_layers(), "deep api: layers")
        conf.samples = os.path.join(ddir, "train")
        conf.tests = os.path.join(ddir, "test")
        convergence.launches = 0
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            nn_log.set_verbose(2)
            try:
                check(hpnn_tpu_torch.train_kernel(conf), "deep api: train_kernel failed")
                hpnn_tpu_torch.run_kernel(conf)
            finally:
                nn_log.set_verbose(0)
        api_s, api_launches = time.perf_counter() - t0, convergence.launches
        out = buf.getvalue()
        check(api_launches > 0, "deep api: train_kernel launched no #1 on the card")
        check(out.count("TRAINING FILE") == DEEP_SAMPLES and
              out.count("TESTING FILE") == DEEP_TESTS, "deep api: token lines")
        api_opt = os.path.join(ddir, "api.opt")
        with open(api_opt, "w") as fp:
            hpnn_tpu_torch.dump_kernel(conf, fp)
        wa = kernel_format.load_kernel(api_opt)[1]
        check(len(wa) == deep_layers() and all(np.isfinite(w).all() for w in wa),
              "deep api: the dumped kernel is malformed or not finite")
        stats["api"] = dict(launches=api_launches, seconds=api_s,
                            passed=out.count("[PASS]"), dtype="float32")
        log(f"[deep] docs/api.md flow on the card (hpnn_tpu_torch.train_kernel/run_kernel, "
            f"no device argument, float32): {api_launches} launches of #1, "
            f"{DEEP_SAMPLES} samples trained and {DEEP_TESTS} tested in {api_s:.2f} s "
            f"(PASS {out.count('[PASS]')}/{DEEP_TESTS})")
    finally:
        loop.MAX_BP_ITER = max_iter
    return stats


def deep_phase(np, torch, dev, Xtr, Ttr, Xte, Tte, protos):
    """Phase 19: the kernels and the entry points at 784-(300x19)-10."""
    t0 = time.perf_counter()
    err, times = deep_kernels(np, torch, dev, Xtr, Ttr)
    t1 = time.perf_counter()
    entry = deep_entry_points(np, torch, dev, Xtr, Ttr, Xte, Tte, protos)
    smi = nvidia_smi_line()
    log(f"[deep] {smi}: kernels against plain {t1 - t0:.1f} s, entry points "
        f"{time.perf_counter() - t1:.1f} s")
    return dict(layers=deep_layers(), shape=deep_shape(),
                err=err, times=times, entry=entry, card=smi,
                seconds=time.perf_counter() - t0)


# ------------------------------------------------------------ wide nets
# Phase 20: #1 on per-sample nets whose input, target, activations and
# deltas overflow one CTA's shared memory, so they live in a device-memory
# scratch of one copy a CTA (the device build); W (95 MB) streams from
# HBM.  float64 takes half the width for the same bytes.
WIDE = {"float32": (N_IN, 30000, N_OUT), "float64": (N_IN, 15000, N_OUT)}
WIDE_PINNED_K = 10     # #1 against plain: max_iter, so K+1 iterations a sample
WIDE_SAMPLES = 4       # #1 against plain, and train_nn's samples
WIDE_MAX_ITER = 30     # train_nn's per-sample cap, card and CPU
WIDE_TIMED_K = 20      # the timed launches: K+1 iterations a sample
WIDE_MID = (N_IN, 4000, N_OUT)   # float32: W (12.5 MB) past 16 CTAs, inside the 50 MB L2
# the builds timed side by side: the plan's (the grid) and one cluster
WIDE_BUILDS = {"grid": dict(grid=True), "one cluster": dict(grid=False)}


def wide_shape(dname):
    n_in, hid, n_out = WIDE[dname]
    return f"{n_in}-[{hid}]-{n_out}"


def wide_weights(np, rng, dname):
    """Seeded uniform weights within 1/sqrt(fan-in) (the generator's
    range) for ``WIDE[dname]``."""
    n_in, hid, n_out = WIDE[dname]
    return [rng.uniform(-1, 1, (hid, n_in)) / math.sqrt(n_in),
            rng.uniform(-1, 1, (n_out, hid)) / math.sqrt(hid)]


def wide_work(weights, S, iters, momentum, dtype_bytes):
    """(bytes, flops) of a launch of #1 whose W does not fit on the chip:
    ``obs.cost.work_of``'s operations, and W read and written once an
    iteration (the least traffic for weights that stream from HBM every
    iteration), beside the samples' bytes."""
    from hpnn_tpu_torch.obs.cost import work_of

    nbytes, flops = work_of(weights, S, iters, momentum, dtype_bytes)
    n_w = sum(int(w.numel()) for w in weights)
    return nbytes - 2 * n_w * dtype_bytes + iters * 2 * n_w * dtype_bytes, flops


def plain_ms(torch, convergence, w0, X, T, kw):
    """Wall ms of one run of #1's plain version on clones of ``w0``,
    after one untimed run on other clones (the kernel's time, from
    ``cuda_ms``, is taken after a warm-up too)."""
    for timed in (False, True):
        wp = [t.clone() for t in w0]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        convergence.train_epoch_plain(wp, X, T, 0.2, -1e30, **kw)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def wide_split(torch, convergence, w0, X, T, kw, ms, iters, tag, cta=0, **plan):
    """Where an iteration of #1 goes under ``plan``: the phase-clock
    build on clones of the inputs, held bitwise against the kernel, rank
    0's (the grid's CTA ``cta``'s) cycles in each phase shared out over
    the kernel's measured ``ms`` for ``iters`` iterations (us an
    iteration by phase)."""
    wc, wq = [t.clone() for t in w0], [t.clone() for t in w0]
    sc, clocks = convergence.phase_clocks(wc, X, T, 0.2, -1e30, cta=cta, **kw, **plan)
    sq = convergence.train_epoch(wq, X, T, 0.2, -1e30, **kw, **plan)
    torch.cuda.synchronize()
    check(same_run((wc, sc), (wq, sq)),
          f"{tag} {plan}: the phase-clock build differs bitwise from the kernel")
    cyc = sum(clocks.values())
    split = {k: v / cyc * ms / iters * 1e3 for k, v in clocks.items() if v}
    log(f"[wide] {tag} {plan or 'default plan'}: us/iteration by phase (CTA {cta}, barrier "
        f"waits included): " + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    return split


def wide_timing(torch, convergence, w0, X, T, shape, phase_split):
    """Phase 20 (d) at one shape: ANN-BP, ``WIDE_SAMPLES`` samples x
    ``WIDE_TIMED_K`` + 1 iterations, through each of ``WIDE_BUILDS`` in
    turns (grid, one cluster, one cluster, grid), the plain version
    after one untimed run, the bound; with ``phase_split``, each build's
    iteration by phase."""
    from hpnn_tpu_torch.obs.cost import bound_ms

    dname = str(X.dtype).split(".")[1]
    kw = dict(model="ann", min_iter=5, max_iter=WIDE_TIMED_K)
    iters = WIDE_SAMPLES * (WIDE_TIMED_K + 1)
    nbytes, flops = wide_work(w0, WIDE_SAMPLES, iters, False, X.element_size())
    b_ms, b_by = bound_ms(nbytes, flops, dname)
    runs = {k: [] for k in WIDE_BUILDS}
    for k in list(WIDE_BUILDS) + list(WIDE_BUILDS)[::-1]:
        runs[k].append(cuda_ms(torch, lambda k=k: convergence.train_epoch(
            w0, X, T, 0.2, -1e30, **kw, **WIDE_BUILDS[k])))
    ms = {k: statistics.median(v) for k, v in runs.items()}
    p_ms = plain_ms(torch, convergence, w0, X, T, kw)
    ctas = convergence.plan(w0, X.dtype, False, grid=True,
                            capacity=convergence.grid_capacity(X.dtype, X.device)).cluster
    out = dict(shape=shape, dtype=dname, ms=ms["grid"], iters=iters,
               us_per_iter=ms["grid"] / iters * 1e3, ctas=ctas,
               cluster_ms=ms["one cluster"], cluster_us_per_iter=ms["one cluster"] / iters * 1e3,
               runs_ms=runs, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
               flops=flops, bound_share={k: b_ms / v for k, v in ms.items()})
    log(f"[wide] #1 ANN-BP {dname} {shape}, {WIDE_SAMPLES} samples x {WIDE_TIMED_K + 1} "
        f"iterations: " + "; ".join(
            f"{k} {ms[k]:.3f} ms ({ms[k] / iters * 1e3:.2f} us/iteration, "
            f"{b_ms / ms[k]:.1%} of the bound; runs {', '.join(f'{t:.3f}' for t in runs[k])})"
            for k in WIDE_BUILDS)
        + f"; the grid {ctas} CTAs, one cluster {convergence.CLUSTER}; plain {p_ms:.1f} ms "
        f"(after one untimed run); bound {b_ms:.4f} ms ({b_by}: {nbytes} B = W read and "
        f"written once an iteration, {flops} flop)")
    if phase_split:
        out["split_us_per_iter"] = {k: wide_split(
            torch, convergence, w0, X, T, kw, ms[k], iters, f"#1 ANN-BP {dname} {shape}",
            **WIDE_BUILDS[k]) for k in WIDE_BUILDS}
        # the grid seen from the CTA that owns the output layer's first row
        starts = convergence.plan(w0, X.dtype, False, grid=True, capacity=ctas).row_starts[-1]
        owner = next(r for r in range(ctas) if starts[r + 1] > 0)
        out["split_us_per_iter"][f"grid, CTA {owner}"] = wide_split(
            torch, convergence, w0, X, T, kw, ms["grid"], iters,
            f"#1 ANN-BP {dname} {shape}", grid=True, cta=owner)
    return out


def wide_kernels(np, torch, dev, Xtr, Ttr, phase_split=False):
    """Phase 20 (a), (b), (d): the grid build against its plain version
    and bitwise the one-cluster device build at ``WIDE``, the grid and
    the forced device build bitwise the shared build at 784-300-10, and
    both builds' times against the bound at ``WIDE`` and ``WIDE_MID``
    (with ``phase_split``, where their iterations go)."""
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.ops import convergence

    rng = np.random.default_rng(SEED + 20)
    err, times, cross = {}, {}, 0
    for dtype in (torch.float32, torch.float64):
        dname = str(dtype).split(".")[1]
        W = wide_weights(np, rng, dname)
        X = torch.tensor(Xtr[:WIDE_SAMPLES], dtype=dtype, device=dev)
        w0 = [torch.tensor(w, dtype=dtype, device=dev) for w in W]
        for model, momentum in (("ann", False), ("ann", True), ("snn", False)):
            tag = f"{model}-{'BPM' if momentum else 'BP'} {dname}"
            T = Ttr[:WIDE_SAMPLES].copy()
            if model == "snn":
                T = np.where(T > 0, 1.0, 0.0)
            T = torch.tensor(T, dtype=dtype, device=dev)
            p = convergence.plan(w0, dtype, momentum,
                                 capacity=convergence.grid_capacity(dtype, dev))
            check(p.grid and not p.vectors_resident and not p.weights_resident,
                  f"#1 {tag} {wide_shape(dname)}: plan {p}")
            kw = dict(model=model, momentum=momentum, min_iter=5, max_iter=WIDE_PINNED_K)
            wk, wp, wc = ([t.clone() for t in w0] for _ in range(3))
            sk = convergence.train_epoch(wk, X, T, 0.2, -1e30, **kw)
            sp = convergence.train_epoch_plain(wp, X, T, 0.2, -1e30, **kw)
            sc = convergence.train_epoch(wc, X, T, 0.2, -1e30, grid=False, **kw)
            torch.cuda.synchronize()
            check(sk.n_iter.tolist() == sp.n_iter.tolist() == [WIDE_PINNED_K + 1] * WIDE_SAMPLES,
                  f"#1 {tag}: n_iter {sk.n_iter.tolist()} / {sp.n_iter.tolist()}")
            check(sk.first_ok.tolist() == sp.first_ok.tolist(), f"#1 {tag}: first_ok differs")
            e = max(state_err(wk, wp), state_err([sk.out], [sp.out]))
            check(math.isfinite(e) and e <= TOL[dname],
                  f"#1 {tag} {wide_shape(dname)}: |kernel - plain| {e:.3e} > {TOL[dname]:.0e}")
            check(any(not torch.equal(a, b) for a, b in zip(wk, w0)),
                  f"#1 {tag}: the kernel left every layer unchanged")
            check(same_run((wk, sk), (wc, sc)),
                  f"#1 {tag} {wide_shape(dname)}: the grid build differs bitwise from the "
                  f"one-cluster device build")
            cross += 1
            err[dname] = max(err.get(dname, 0.0), e)
            log(f"[wide] #1 {tag} {wide_shape(dname)}, {WIDE_SAMPLES} samples x "
                f"{WIDE_PINNED_K + 1} iterations: max|kernel - plain| {e:.3e} (tol "
                f"{TOL[dname]:.0e}); the grid build ({p.cluster} CTAs, {p.scratch_bytes} B "
                f"of published vectors, W through rings) bitwise the one-cluster device build")
        T = torch.tensor(Ttr[:WIDE_SAMPLES], dtype=dtype, device=dev)
        times[dname] = wide_timing(torch, convergence, w0, X, T, wide_shape(dname),
                                   phase_split)

    # (d) the mid width: W past 16 CTAs' shared memory, inside the L2
    n_in, hid, n_out = WIDE_MID
    Wm = [rng.uniform(-1, 1, (hid, n_in)) / math.sqrt(n_in),
          rng.uniform(-1, 1, (n_out, hid)) / math.sqrt(hid)]
    X = torch.tensor(Xtr[:WIDE_SAMPLES], dtype=torch.float32, device=dev)
    T = torch.tensor(Ttr[:WIDE_SAMPLES], dtype=torch.float32, device=dev)
    w0 = [torch.tensor(w, dtype=torch.float32, device=dev) for w in Wm]
    kw = dict(model="ann", momentum=True, min_iter=5, max_iter=WIDE_PINNED_K)
    runs = []
    for build in WIDE_BUILDS.values():
        w = [t.clone() for t in w0]
        runs.append((w, convergence.train_epoch(w, X, T, 0.2, -1e30, **kw, **build)))
    torch.cuda.synchronize()
    check(same_run(*runs), f"#1 {n_in}-[{hid}]-{n_out}: the grid differs from one cluster")
    times["mid"] = wide_timing(torch, convergence, w0, X, T, f"{n_in}-[{hid}]-{n_out}",
                               phase_split)

    # (b) at 784-300-10: the forced device build and the forced grid give
    # the shared build's bits
    k0, _ = km.generate(SEED, N_IN, [N_HID], N_OUT)
    same = 0
    for model in ("ann", "snn"):
        for momentum in (False, True):
            for dtype in (torch.float32, torch.float64):
                tag = f"{model}-{'BPM' if momentum else 'BP'} {str(dtype).split('.')[1]}"
                w0, _ = km.to_torch(k0.weights, device=dev, dtype=dtype)
                X = torch.tensor(Xtr[:4], dtype=dtype, device=dev)
                T = Ttr[:4].copy()
                if model == "snn":
                    T = np.where(T > 0, 1.0, 0.0)
                T = torch.tensor(T, dtype=dtype, device=dev)
                kw = dict(model=model, momentum=momentum, min_iter=5, max_iter=PINNED_K)
                runs = []
                for plan in ({}, dict(vectors_resident=False),
                             dict(vectors_resident=False, cluster=8), dict(grid=True),
                             dict(grid=True, cluster=16), dict(grid=True, cluster=8)):
                    w = tuple(t.clone() for t in w0)
                    runs.append((w, convergence.train_epoch(w, X, T, 0.2, -1e30, **kw, **plan)))
                torch.cuda.synchronize()
                check(convergence.plan(w0, dtype, momentum).vectors_resident,
                      f"{tag}: 784-300-10 left shared memory")
                check(all(same_run(r, runs[0]) for r in runs[1:]),
                      f"{tag} 784-300-10: the device build or the grid differs bitwise from "
                      f"the shared build")
                same += 1
    log(f"[wide] 784-300-10, 4 samples x {PINNED_K + 1} iterations: the device build (16 and "
        f"8 CTAs) and the grid build (all, 16 and 8 CTAs) bitwise the shared build in {same} "
        f"of 8 modes and types; at the wide shapes the grid bitwise one cluster in {cross} of 6")
    return err, times, same


def wide_entry_point(np, torch, dev, Xtr, Ttr):
    """Phase 20 (c): ``train_nn`` at 784-[15000]-10 in float64 ([init]
    generate, ``WIDE_SAMPLES`` samples, at most ``WIDE_MAX_ITER``
    iterations each) on the card and on the CPU, #1's launch count set
    to 0 just before the card run and read just after: the tokens and
    ``kernel.tmp`` identical, ``kernel.opt`` within 1e-12."""
    from hpnn_tpu_torch import obs
    from hpnn_tpu_torch.cli import train_nn
    from hpnn_tpu_torch.fileio import kernel_format
    from hpnn_tpu_torch.ops import convergence
    from hpnn_tpu_torch.train import loop

    n_in, hid, n_out = WIDE["float64"]
    wdir = os.path.join(WORK, "wide")
    write_samples(os.path.join(wdir, "train"), Xtr[:WIDE_SAMPLES], Ttr[:WIDE_SAMPLES])
    cwd = os.getcwd()
    runs = {}
    caps = (loop.MAX_BP_ITER, loop.MAX_BPM_ITER)
    loop.MAX_BP_ITER = loop.MAX_BPM_ITER = WIDE_MAX_ITER
    try:
        for where, extra in (("cuda", []), ("cpu", ["--device", "cpu"])):
            run_dir = os.path.join(wdir, where)
            os.makedirs(run_dir, exist_ok=True)
            os.chdir(run_dir)
            with open("nn.conf", "w") as fp:
                fp.write(f"[name] smoke_wide\n[type] ANN\n[init] generate\n[seed] {SEED}\n"
                         f"[input] {n_in}\n[hidden] {hid}\n[output] {n_out}\n[train] BP\n"
                         f"[sample_dir] ../train\n[test_dir] ../train\n")
            convergence.launches = 0
            t0 = time.perf_counter()
            with knobs(obs, {"HPNN_DTYPE": "float64"}):
                rc, out, _ = run_cli(train_nn.main, extra + ["-v", "-v", "nn.conf"])
            secs = time.perf_counter() - t0
            launched = convergence.launches
            check(rc == 0, f"wide train_nn ({where}): exit {rc}")
            runs[where] = (out, secs, run_dir, launched)
    finally:
        loop.MAX_BP_ITER, loop.MAX_BPM_ITER = caps
        os.chdir(cwd)
    check(runs["cuda"][3] > 0, "wide: the card's train_nn launched no #1")
    check(runs["cpu"][3] == 0, "wide: the CPU's train_nn launched #1")
    lines = {w: training_lines(r[0]) for w, r in runs.items()}
    check(len(lines["cuda"]) == WIDE_SAMPLES, f"wide: {len(lines['cuda'])} token lines")
    check(lines["cuda"] == lines["cpu"], "wide f64: the card's tokens differ from the CPU's:\n"
          + "\n".join(lines["cuda"] + lines["cpu"]))
    tmp = {}
    for w, r in runs.items():
        with open(os.path.join(r[2], "kernel.tmp"), "rb") as fp:
            tmp[w] = hashlib.sha256(fp.read()).hexdigest()
    check(tmp["cuda"] == tmp["cpu"], "wide f64: kernel.tmp differs between card and CPU")
    wa = kernel_format.load_kernel(os.path.join(runs["cuda"][2], "kernel.opt"))[1]
    wb = kernel_format.load_kernel(os.path.join(runs["cpu"][2], "kernel.opt"))[1]
    check([w.shape for w in wa] == [w.shape for w in wb] == [(hid, n_in), (n_out, hid)],
          "wide: kernel.opt shapes")
    e = max(float(np.abs(x - y).max()) for x, y in zip(wa, wb))
    check(e <= MAT_TOL, f"wide f64: kernel.opt card vs CPU {e:.3e}")
    iters = sum(int(m) for m in N_ITER_RE.findall(runs["cpu"][0]))
    for w in runs:
        shutil.rmtree(runs[w][2], ignore_errors=True)   # 2 x 226 MB of kernel text a run
    log(f"[wide] train_nn {wide_shape('float64')} ANN-BP float64, {WIDE_SAMPLES} samples at "
        f"most {WIDE_MAX_ITER} iterations ({iters} in all): card {runs['cuda'][3]} launches "
        f"of #1 in {runs['cuda'][1]:.2f} s, CPU {runs['cpu'][1]:.2f} s; tokens and kernel.tmp "
        f"identical, kernel.opt within {e:.3e}")
    return dict(samples=WIDE_SAMPLES, iterations=iters, launches=runs["cuda"][3],
                kernel_opt_max_abs_diff=e, cuda_seconds=runs["cuda"][1],
                cpu_seconds=runs["cpu"][1])


def wide_phase(np, torch, dev, Xtr, Ttr, phase_split=False):
    """Phase 20: #1's device build at ``WIDE``, then ``train_nn`` there."""
    t0 = time.perf_counter()
    err, times, same = wide_kernels(np, torch, dev, Xtr, Ttr, phase_split)
    entry = wide_entry_point(np, torch, dev, Xtr, Ttr)
    smi = nvidia_smi_line()
    log(f"[wide] {smi}: phase 20 in {time.perf_counter() - t0:.1f} s")
    return dict(err=err, times=times, bitwise_784_300_10=same, entry=entry, card=smi,
                seconds=time.perf_counter() - t0)


# --------------------------------------------------------------- drills
# Phase 21: the port's chaos drills (hpnn_tpu_torch/tools/chaos_drill.py)
# on the card, at the repo tool's --rate; phase 22: the port's token lint.
DRILL_RATE = 40.0


def drills_phase():
    """Phase 21: all twelve drills on the card, each row printed; a
    drill that fails, could not run or says it skipped fails the
    phase."""
    from hpnn_tpu_torch.tools import chaos_drill

    t0 = time.perf_counter()
    wd = os.path.join(WORK, "drills")
    shutil.rmtree(wd, ignore_errors=True)
    rows = chaos_drill.run_drills(tuple(chaos_drill.DRILLS), workdir=wd, rate=DRILL_RATE,
                                  device="cuda")
    for row in rows:
        log(f"[drills] {json.dumps(row, default=str)}")
    check(len(rows) == 12, f"{len(rows)} drill rows, not 12")
    bad = [r["ev"] for r in rows if not r.get("ok") or "skipped" in r]
    check(not bad, f"drills failed: {bad}")
    by = {r["ev"].split(".", 1)[1]: r for r in rows}
    k9 = by["kill9"]
    check(k9.get("restored_bitwise") is True and k9.get("wal_version", 0) >= 1,
          f"kill9: restored_bitwise {k9.get('restored_bitwise')}, "
          f"wal_version {k9.get('wal_version')}")
    for name, row in by.items():
        log(f"[drills] {name}: ok in {row['seconds']:.1f} s")
    smi = nvidia_smi_line()
    log(f"[drills] {smi}: {len(rows)} of {len(rows)} ok on the card in "
        f"{time.perf_counter() - t0:.1f} s: kill9 restored bitwise at WAL version "
        f"{k9['wal_version']} (restart ready {k9.get('restart_ready_s')} s, recovery "
        f"{k9.get('recovery_s')} s, {k9.get('lost')} lost); torn dip "
        f"{by['torn'].get('goodput_dip_pct')}% with {by['torn'].get('clean_lost')} clean "
        f"lost; reload codes {by['reload'].get('reload_codes')} lost "
        f"{by['reload'].get('lost')}; sentinel rejected {by['sentinel'].get('rejected')} "
        f"lost {by['sentinel'].get('lost')}; alert fire {by['alert'].get('fire_s')} s "
        f"resolve {by['alert'].get('resolve_s')} s (spawn {by['alert'].get('spawn_s')} s); "
        f"worker replaced {by['worker'].get('replaced_s')} s (replacement boot "
        f"{by['worker'].get('replacement_boot_s')} s); capsule capture "
        f"{by['capsule'].get('capture_s')} s, dispatch blame "
        f"{by['capsule'].get('dispatch_blame_pct')}%; tune applies "
        f"{by['tune'].get('applies')} rollback_bitwise {by['tune'].get('rollback_bitwise')}")
    return dict(rows=rows, card=smi, seconds=time.perf_counter() - t0)


def tokens_phase():
    """Phase 22: the port's byte-stability lint on the card; any
    failure fails the phase."""
    from hpnn_tpu_torch.tools import check_tokens

    t0 = time.perf_counter()
    wd = os.path.join(WORK, "tokens")
    shutil.rmtree(wd, ignore_errors=True)
    os.makedirs(wd)
    stats = {}
    failures = check_tokens.check(wd, device="cuda", stats=stats)
    for f in failures:
        log(f"[tokens] FAIL: {f}")
    check(not failures, f"check_tokens on cuda: {len(failures)} failure(s): "
          f"{failures[:3]}")
    log(f"[tokens] {nvidia_smi_line()}: stdout byte-stable on cuda in "
        f"{time.perf_counter() - t0:.1f} s: {stats['token_lines']} token lines compared "
        f"in each of 4 rounds, {stats['ledger_rows']} ledger rows equal row for row, "
        f"{stats['sink_events']} sink events")
    return dict(stats, seconds=time.perf_counter() - t0)


def load_conf_quiet(path):
    from hpnn_tpu_torch import config

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        return config.load_conf(path)


def main() -> int:
    import argparse

    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phase-split", action="store_true",
                    help="time the kernels' phases (two more nvcc builds)")
    ap.add_argument("--planes-only", action="store_true",
                    help="run only phase 15 (the serving planes); no result line")
    ap.add_argument("--online-only", action="store_true",
                    help="run only phase 17 (online learning), from a generated "
                         "ANN; no result line")
    ap.add_argument("--fleet-only", action="store_true",
                    help="run only phase 18 (the serving fleet over online_nn worker "
                         "processes); no result line")
    ap.add_argument("--capture-thread", action="store_true",
                    help="run only the capture-thread probe (a child process a "
                         "case and run); no result line")
    ap.add_argument("--tp-repeat", action="store_true",
                    help="run only the repeat probe of phase 16's float64 TP SNN "
                         "world, on the card and the CPU; no result line")
    ap.add_argument("--wide-only", action="store_true",
                    help="run only phase 20 (#1 on nets wider than one CTA); "
                         "no result line")
    ap.add_argument("--drills-only", action="store_true",
                    help="run only phases 21 and 22 (the chaos drills and the "
                         "token lint on the card); no result line")
    ap.add_argument("--capture-case", choices=sorted(CAPTURE_CASES),
                    help=argparse.SUPPRESS)
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "hpnn_tpu_torch")):
        print("chip_smoke: run from a checkout (hpnn_tpu_torch/ not found "
              "beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    if args.capture_case:
        return capture_case(args.capture_case)
    from hpnn_tpu_torch.cli import run_nn, train_nn
    from hpnn_tpu_torch.fileio import kernel_format
    from hpnn_tpu_torch.models import kernel as km
    from hpnn_tpu_torch.obs.cost import bound_ms, work_of
    from hpnn_tpu_torch.ops import _build, convergence
    from hpnn_tpu_torch.train import loop

    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "hpnn_tpu")]
    check(not bad, f"the port pulled in {bad[:5]}")
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. probe
    enter(1)
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[probe] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {kind} count {torch.cuda.device_count()}")
    log(f"[probe] nvidia-smi: {smi}")
    if args.planes_only:
        enter(15)
        os.makedirs(WORK, exist_ok=True)
        t15 = time.perf_counter()
        planes = planes_phase(np, torch, dev)
        with open(os.path.join(WORK, "planes.json"), "w") as fp:
            json.dump(planes, fp, default=str)
        log(f"[planes] phase 15 in {time.perf_counter() - t15:.1f} s (--planes-only: "
            f"no result line)")
        return 0
    if args.capture_thread:
        os.makedirs(WORK, exist_ok=True)
        capture_thread_probe()
        return 0
    if args.tp_repeat:
        enter(16)
        os.makedirs(WORK, exist_ok=True)
        tp_repeat_probe(np)
        return 0
    if args.fleet_only:
        enter(18)
        os.makedirs(WORK, exist_ok=True)
        t0 = time.perf_counter()
        _build.build("batch_step", force=True)
        log(f"[build] batch_step.cu built in {time.perf_counter() - t0:.1f} s")
        fleet_phase(np, torch, dev)
        log("[fleet] --fleet-only: no result line")
        return 0
    if args.wide_only:
        enter(20)
        os.makedirs(WORK, exist_ok=True)
        build_all(_build, (("convergence", None),) + (
            (("convergence", "HPNN_PHASE_CLOCKS"),) if args.phase_split else ()))
        rng = np.random.default_rng(SEED)
        protos = (rng.random((N_OUT, N_IN)) < 0.15).astype(np.float64)
        Xtr, Ttr = make_dataset(np, rng, WIDE_SAMPLES, protos)
        shutil.rmtree(os.path.join(WORK, "wide"), ignore_errors=True)
        wide_phase(np, torch, dev, Xtr, Ttr, args.phase_split)
        log("[wide] --wide-only: no result line")
        return 0
    if args.drills_only:
        enter(21)
        os.makedirs(WORK, exist_ok=True)
        t0 = time.perf_counter()
        build_all(_build, (("convergence", None), ("batch_step", None)))
        log(f"[build] convergence.cu and batch_step.cu built in "
            f"{time.perf_counter() - t0:.1f} s")
        drills_phase()
        enter(22)
        tokens_phase()
        log("[drills] --drills-only: no result line")
        return 0
    if args.online_only:
        enter(17)
        os.makedirs(WORK, exist_ok=True)
        t0 = time.perf_counter()
        _build.build("batch_step", force=True)
        log(f"[build] batch_step.cu built in {time.perf_counter() - t0:.1f} s")
        online_phase(np, torch, dev, km.generate(SEED, N_IN, [N_HID], N_OUT)[0])
        log("[online] --online-only: no result line")
        return 0

    enter(2)
    # 2. build: one nvcc per source and g++ for the host library, all
    # started together
    t0 = time.perf_counter()
    builds = (("convergence", None), ("batch_step", None))
    if args.phase_split:
        builds += (("convergence", "HPNN_PHASE_CLOCKS"), ("batch_step", "HPNN_PHASE_CLOCKS"))
    build_all(_build, builds)
    from hpnn_tpu_torch import native
    check(native.lib() is not None, "the native host library (csrc/hpnn_native.cpp) did not load")
    log(f"[build] hpnn_native.cpp built in {_build.build_log['hpnn_native'][0]:.1f} s and "
        f"loaded: the sample parse, kernel dumps and shuffle run natively")
    log(f"[build] all sources in {time.perf_counter() - t0:.1f} s")
    from hpnn_tpu_torch.ops import batch_step
    for dtype, code in batch_step._DTYPE_CODE.items():
        smem = batch_step._library().hpnn_batch_smem_bytes(code)
        check(smem == batch_step.shared_bytes(dtype),
              f"batch_step.cu takes {smem} bytes of shared memory a block in {dtype}, "
              f"ops/batch_step.py says {batch_step.shared_bytes(dtype)}")
    log(f"[build] batch_step.cu: {batch_step.shared_bytes(torch.float32)} / "
        f"{batch_step.shared_bytes(torch.float64)} bytes of dynamic shared memory a block "
        f"(f32 / f64), as ops/batch_step.py lays them out")

    k0, _ = km.generate(SEED, N_IN, [N_HID], N_OUT)
    rng = np.random.default_rng(SEED)
    protos = (rng.random((N_OUT, N_IN)) < 0.15).astype(np.float64)
    Xtr, Ttr = make_dataset(np, rng, N_TRAIN_ANN, protos)
    Xte, Tte = make_dataset(np, rng, N_TEST, protos)

    def tensors(dtype, S, snn=False):
        w, _ = km.to_torch(k0.weights, device=dev, dtype=dtype)
        T = Ttr[:S].copy()
        if snn:
            T = np.where(T > 0, 1.0, 0.0)
        return (w, torch.tensor(Xtr[:S], dtype=dtype, device=dev),
                torch.tensor(T, dtype=dtype, device=dev))

    # 3. pinned iteration count
    enter(3)
    max_err = {"float32": 0.0, "float64": 0.0}
    for model in ("ann", "snn"):
        for momentum in (False, True):
            for dtype in (torch.float32, torch.float64):
                name = str(dtype).split(".")[1]
                kw = dict(model=model, momentum=momentum, min_iter=5,
                          max_iter=PINNED_K)
                wk, X, T = tensors(dtype, 4, snn=model == "snn")
                w0 = tuple(w.clone() for w in wk)
                wp = tuple(w.clone() for w in wk)
                sk = convergence.train_epoch(wk, X, T, 0.2, -1e30, **kw)
                sp = convergence.train_epoch_plain(wp, X, T, 0.2, -1e30, **kw)
                torch.cuda.synchronize()
                tag = f"{model}-{'BPM' if momentum else 'BP'} {name}"
                check(sk.n_iter.tolist() == [PINNED_K + 1] * 4, f"{tag}: kernel n_iter {sk.n_iter.tolist()}")
                check(sk.n_iter.tolist() == sp.n_iter.tolist(), f"{tag}: n_iter differs")
                check(sk.first_ok.tolist() == sp.first_ok.tolist(), f"{tag}: first_ok differs")
                check(sk.final_ok.tolist() == sp.final_ok.tolist(), f"{tag}: final_ok differs")
                err = max([float((a - b).abs().max()) for a, b in zip(wk, wp)]
                          + [float((sk.out - sp.out).abs().max())])
                check(math.isfinite(err) and err <= TOL[name],
                      f"{tag}: max |kernel - plain| {err:.3e} > {TOL[name]:.0e}")
                max_err[name] = max(max_err[name], err)
                log(f"[pinned] {tag}: n_iter {sk.n_iter.tolist()} first_ok "
                    f"{sk.first_ok.tolist()} max|diff| {err:.3e} (tol {TOL[name]:.0e})")
                # the kernel against itself under every plan, bitwise
                for plan in plans_of(convergence, w0, dtype, momentum):
                    w = tuple(t.clone() for t in w0)
                    check(same_run((w, convergence.train_epoch(w, X, T, 0.2, -1e30, **kw, **plan)),
                                   (wk, sk)), f"{tag}: plan {plan} differs bitwise from the default")
                log(f"[pinned] {tag}: default plan ({plan_str(convergence.plan(w0, dtype, momentum))}) "
                    f"== every plan of {plans_of(convergence, w0, dtype, momentum)} (bitwise)")

    # 4. main path: train_nn then run_nn through the CLIs
    enter(4)
    shutil.rmtree(WORK, ignore_errors=True)
    write_samples(os.path.join(WORK, "train"), Xtr, Ttr)
    write_samples(os.path.join(WORK, "train_snn"), Xtr[:N_TRAIN_SNN], Ttr[:N_TRAIN_SNN])
    write_samples(os.path.join(WORK, "test"), Xte, Tte)
    os.environ["HPNN_FUSE_CHUNK"] = str(CHUNK)
    cwd = os.getcwd()
    main_stats, main_outs = {}, {}
    convergence.launches = 0
    try:
        for kind_name, n_train, train_dir in (
                ("ANN", N_TRAIN_ANN, "train"), ("SNN", N_TRAIN_SNN, "train_snn")):
            run_dir = os.path.join(WORK, kind_name.lower())
            os.makedirs(run_dir)
            os.chdir(run_dir)
            write_conf("nn.conf", name=f"smoke_{kind_name.lower()}", kind=kind_name,
                       train_dir=f"../{train_dir}", test_dir="../test")
            before = convergence.launches
            rc, out, secs = run_cli(train_nn.main, ["-v", "-v", "nn.conf"])
            check(rc == 0, f"{kind_name} train_nn exit {rc}")
            launched = convergence.launches - before
            n_iters = [int(v) for v in re.findall(r"N_ITER=\s*(\d+)", out)]
            n_ok = len(re.findall(r" OK N_ITER", out))
            check(len(n_iters) == n_train, f"{kind_name}: {len(n_iters)} token lines")
            check(launched == math.ceil(n_train / CHUNK),
                  f"{kind_name}: {launched} launches for {n_train} samples")
            check(os.path.exists("kernel.tmp") and os.path.exists("kernel.opt"),
                  f"{kind_name}: kernel files missing")
            _, w_opt = kernel_format.load_kernel("kernel.opt")
            check([w.shape for w in w_opt] == [(N_HID, N_IN), (N_OUT, N_HID)]
                  and all(np.isfinite(w).all() for w in w_opt),
                  f"{kind_name}: kernel.opt malformed or not finite")
            write_conf("cont.conf", name=f"smoke_{kind_name.lower()}", kind=kind_name,
                       train_dir=f"../{train_dir}", test_dir="../test", init="kernel.opt")
            rc, eout, esecs = run_cli(run_nn.main, ["-v", "-v", "cont.conf"])
            check(rc == 0, f"{kind_name} run_nn exit {rc}")
            n_pass = eout.count("[PASS]")
            n_tested = eout.count("TESTING FILE")
            check(n_tested == N_TEST, f"{kind_name}: {n_tested} eval lines")
            if kind_name == "ANN":
                check(n_pass > N_TEST / N_OUT,
                      f"ANN: PASS {n_pass}/{N_TEST} not above chance")
            else:
                # per-sample SNN-BP with +-1 targets drives every
                # non-target output to TINY and most samples to the
                # 102399 cap, so a few dozen samples leave it near chance;
                # hold its eval to the token protocol instead
                check(eout.count("BEST CLASS") == N_TEST, "SNN: BEST CLASS tokens missing")
            total = sum(n_iters)
            main_outs[kind_name] = out
            main_stats[kind_name] = dict(
                samples=n_train, launches=launched, seconds=secs,
                samples_per_s=n_train / secs, mean_n_iter=total / n_train,
                us_per_iter_wall=secs / total * 1e6, first_ok=n_ok,
                passed=n_pass, eval_seconds=esecs)
            log(f"[main] {kind_name} 784-300-10 BP: {n_train} samples in {secs:.2f} s "
                f"({n_train / secs:.2f} samples/s), mean N_ITER {total / n_train:.1f}, "
                f"{secs / total * 1e6:.2f} us/iteration wall, first-try OK {n_ok}, "
                f"{launched} launches; run_nn PASS {n_pass}/{N_TEST} in {esecs:.2f} s")
    finally:
        os.chdir(cwd)
    main_launches = convergence.launches
    check(main_launches > 0, "the main path launched no convergence kernel")

    enter(5)
    # 5. real thresholds.  ANN starts from the main path's trained
    # kernel.opt on unseen test samples (an untrained ANN-BP takes
    # thousands of iterations per sample); SNN from the generated kernel.
    _, w_ann = kernel_format.load_kernel(os.path.join(WORK, "ann", "kernel.opt"))
    for model in ("ann", "snn"):
        for momentum in (False, True):
            mi = loop.MIN_BPM_ITER if momentum else loop.MIN_BP_ITER
            kw = dict(model=model, momentum=momentum, min_iter=mi,
                      max_iter=REAL_MAX_ITER)
            for dtype in (torch.float32, torch.float64):
                name = str(dtype).split(".")[1]
                if model == "ann":
                    wk, _ = km.to_torch(w_ann, device=dev, dtype=dtype)
                    X = torch.tensor(Xte[:8], dtype=dtype, device=dev)
                    T = torch.tensor(Tte[:8], dtype=dtype, device=dev)
                else:
                    wk, X, T = tensors(dtype, 8)
                wp = tuple(w.clone() for w in wk)
                delta = loop.DELTA_BPM if momentum else loop.DELTA_BP
                sk = convergence.train_epoch(wk, X, T, 0.2, delta, **kw)
                sp = convergence.train_epoch_plain(wp, X, T, 0.2, delta, **kw)
                nk, npl = sk.n_iter.tolist(), sp.n_iter.tolist()
                fk, fp = int(sk.first_ok.sum()), int(sp.first_ok.sum())
                tag = f"{model}-{'BPM' if momentum else 'BP'} {name}"
                if name == "float64":
                    check(nk == npl, f"{tag}: n_iter kernel {nk} plain {npl}")
                    check(sk.first_ok.tolist() == sp.first_ok.tolist(),
                          f"{tag}: first_ok differs")
                else:
                    rel = abs(sum(nk) - sum(npl)) / max(1, sum(npl))
                    check(rel <= REAL_F32_NITER_BAND,
                          f"{tag}: total N_ITER {sum(nk)} vs {sum(npl)}")
                    check(abs(fk - fp) <= REAL_F32_FIRST_OK_BAND,
                          f"{tag}: first_ok count {fk} vs {fp}")
                log(f"[real] {tag}: N_ITER kernel {nk} plain {npl} first_ok {fk}/{fp}")


    enter(6)
    # 6. timing: 4 samples x TIMED_ITERS iterations each, every mode and
    # type, at each cluster size, in turns; the kernel row of the result
    # is ANN-BP float32, the main path's
    timings = []
    for model in ("ann", "snn"):
        for momentum in (False, True):
            for dtype in (torch.float32, torch.float64):
                name = str(dtype).split(".")[1]
                wk, X, T = tensors(dtype, 4)
                kw = dict(model=model, momentum=momentum, min_iter=5,
                          max_iter=TIMED_ITERS - 1)
                tag = f"{model}-{'BPM' if momentum else 'BP'} {name}"
                fns = {f"C={C}": (lambda C=C: convergence.train_epoch(
                    wk, X, T, 0.2, -1e30, cluster=C, **kw)) for C in CLUSTERS}
                runs = {k: [] for k in fns}
                for k in list(fns) + list(fns)[::-1]:
                    runs[k].append(cuda_ms(torch, fns[k]))
                by = {k: statistics.median(v) for k, v in runs.items()}
                p = convergence.plan(wk, dtype, momentum)
                k_ms = by[f"C={p.cluster}"]
                wp = tuple(w.clone() for w in wk)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sp = convergence.train_epoch_plain(wp, X, T, 0.2, -1e30, **kw)
                torch.cuda.synchronize()
                p_ms = (time.perf_counter() - t0) * 1e3
                iters = int(sp.n_iter.sum())
                nbytes, flops = work_of(wk, 4, iters, momentum, X.element_size())
                b_ms, b_by = bound_ms(nbytes, flops, name)
                timings.append(dict(config=tag, ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                                    bound_by=b_by, iters=iters, cluster=p.cluster,
                                    smem_bytes=p.smem_bytes, ms_by_plan=by, runs_ms=runs,
                                    us_per_iter={k: v / iters * 1e3 for k, v in by.items()}))
                log(f"[timing] {tag} 784-300-10, 4 samples x {TIMED_ITERS} iterations: "
                    + ", ".join(f"{k} {v:.3f} ms ({v / iters * 1e3:.2f} us/iteration)"
                                for k, v in by.items())
                    + f"; default {plan_str(p)}; plain {p_ms:.1f} ms, bound {b_ms:.4f} ms "
                    f"({b_by}: {nbytes} B, {flops} flop)")
                if args.phase_split:
                    # the phase-clock build on the same inputs (bitwise the
                    # kernel's), its cycles shared out over the measured time
                    wc, wq = tuple(w.clone() for w in wk), tuple(w.clone() for w in wk)
                    sc, clocks = convergence.phase_clocks(wc, X, T, 0.2, -1e30, **kw)
                    sq = convergence.train_epoch(wq, X, T, 0.2, -1e30, **kw)
                    check(same_run((wc, sc), (wq, sq)),
                          f"{tag}: the phase-clock build differs bitwise from the kernel")
                    cyc = sum(clocks.values())
                    split = {k: v / cyc * k_ms / iters * 1e3 for k, v in clocks.items() if v}
                    timings[-1].update(split_us_per_iter=split, clocks=clocks)
                    log(f"[timing] {tag}: us/iteration by phase (C={p.cluster}, rank 0, "
                        f"barrier waits included): "
                        + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    head = timings[0]
    ms, plain_ms, b_ms, b_by = head["ms"], head["plain_ms"], head["bound_ms"], head["bound_by"]
    # a chunk of real samples at the loop's own thresholds, as train_nn sends it
    wk, _ = km.to_torch(k0.weights, device=dev, dtype=torch.float32)
    X = torch.tensor(Xtr[:CHUNK], dtype=torch.float32, device=dev)
    T = torch.tensor(Ttr[:CHUNK], dtype=torch.float32, device=dev)
    e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    e0.record()
    st = convergence.train_epoch(wk, X, T, 0.2, loop.DELTA_BP, model="ann",
                                 min_iter=loop.MIN_BP_ITER, max_iter=loop.MAX_BP_ITER)
    e1.record()
    torch.cuda.synchronize()
    chunk_ms, chunk_iters = e0.elapsed_time(e1), int(st.n_iter.sum())
    log(f"[timing] ANN-BP chunk of {CHUNK} real samples: {chunk_ms:.1f} ms, "
        f"{chunk_iters} iterations ({chunk_ms / chunk_iters * 1e3:.2f} us/iteration)")

    # 7-9. the batch path
    enter(7)
    batch_err = batch_pinned(np, torch, dev)
    enter(8)
    batch_launches, batch_stats = batch_main(np, torch, protos)
    for name, _, on_path in BATCH_KERNELS:
        check(not on_path or batch_launches[name] > 0,
              f"the batch main path launched no {name}")
    enter(9)
    batch_times = batch_timing(np, torch, dev, args.phase_split)

    # 10-12. the fleet path
    enter(10)
    fleet_err, fleet_bf16 = fleet_pinned(np, torch, dev)
    enter(11)
    fleet_launches, fleet_stats = fleet_main(np, torch, dev, protos)
    check(fleet_launches["train_fleet_epoch_dbuf_banked"] > 0,
          "the fleet main path launched no train_fleet_epoch_dbuf_banked")
    enter(12)
    fleet_times, fleet_cross, fleet_bf16_times = fleet_timing(np, torch, dev)
    plan_split = fleet_plan_split(np, torch, dev) if args.phase_split else None

    # 13. crash-resume, streaming, the float64 ledger card vs CPU, obs, native
    enter(13)
    t13 = time.perf_counter()
    slice6 = resume_obs_native(np, torch, dev, protos)
    log(f"[resume-obs-native] phase 13 in {time.perf_counter() - t13:.1f} s")

    # 14. serving: the serve stack on the card
    enter(14)
    t14 = time.perf_counter()
    serve_stats = serve_phase(np, torch, dev, k0)
    log(f"[serve] phase 14 in {time.perf_counter() - t14:.1f} s")

    # 15. the serving planes: tenant host, every plane on/off, capsules,
    # drift, meter, the tuning plane
    enter(15)
    t15 = time.perf_counter()
    planes = planes_phase(np, torch, dev)
    with open(os.path.join(WORK, "planes.json"), "w") as fp:
        json.dump(planes, fp, default=str)
    log(f"[planes] phase 15 in {time.perf_counter() - t15:.1f} s")

    # 16. multi-GPU as one card can show it: world size 1, two gloo ranks
    # on the card, the router's TP spill
    enter(16)
    t16 = time.perf_counter()
    mesh_stats = mesh_phase(np, torch, dev, Xtr, Ttr, main_outs)
    log(f"[mesh] phase 16 in {time.perf_counter() - t16:.1f} s")

    # 17. online learning: train-while-serve with promotions and rollbacks
    enter(17)
    _, w_ann = kernel_format.load_kernel(os.path.join(WORK, "ann", "kernel.opt"))
    online_stats = online_phase(np, torch, dev, km.Kernel(weights=tuple(w_ann)))

    # 18. the serving fleet: online_nn worker processes behind a router
    enter(18)
    fleet_stats_18 = fleet_phase(np, torch, dev)

    # 19. nets deeper than 16 layers: every kernel, then the entry points,
    # at 784-(300x19)-10
    enter(19)
    deep = deep_phase(np, torch, dev, Xtr, Ttr, Xte, Tte, protos)
    log(f"[deep] phase 19 in {deep['seconds']:.1f} s")

    # 20. nets wider than one CTA's shared memory: #1's device build,
    # then train_nn at 784-[15000]-10 in float64, card against CPU
    enter(20)
    wide = wide_phase(np, torch, dev, Xtr, Ttr, args.phase_split)

    # 21. the chaos drills on the card
    enter(21)
    drills = drills_phase()

    # 22. the token lint on the card
    enter(22)
    tokens_phase()
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "hpnn_tpu")]
    check(not bad, f"the port pulled in {bad[:5]}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")

    kernels = [{
        "name": "convergence",
        "route": "cuda",
        "source": "hpnn_tpu_torch/csrc/convergence.cu",
        "replaces": "hpnn_tpu/ops/pallas_train.py:260",
        "replaces_fn": "train_sample_fused",
        "launches": main_launches,
        "max_abs_err": max_err["float32"],
        "max_abs_err_f32": max_err["float32"],
        "max_abs_err_f64": max_err["float64"],
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": b_ms,
        "bound_by": b_by,
        "library_ms": None,
        "timed": f"ANN-BP 784-300-10 float32, 4 samples x {TIMED_ITERS} iterations",
        "cluster": head["cluster"],
        "smem_bytes": head["smem_bytes"],
        "us_per_iter": ms / head["iters"] * 1e3,
        "chunk_ms": chunk_ms,
        "chunk_iters": chunk_iters,
        "main": main_stats,
        "by_config": timings,
        "resume_obs_native": slice6,
        "serve": serve_stats,
        "planes": planes_summary(planes),
        "mesh": mesh_stats,
        "online": online_stats,
    }]
    for name, replaces, on_path in BATCH_KERNELS:
        t = batch_times[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "hpnn_tpu_torch/csrc/batch_step.cu",
            "replaces": replaces,
            "launches": batch_launches[name],
            "on_main_path": on_path,
            "max_abs_err": batch_err[name]["float32"],
            "max_abs_err_f32": batch_err[name]["float32"],
            "max_abs_err_f64": batch_err[name]["float64"],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": None,
            "timed": (f"ANN-BP 784-300-10 float32, one epoch of "
                      f"{math.ceil(TIMED_ROWS / BATCH)} steps of B={BATCH} over a "
                      f"{TIMED_ROWS}-row bank"),
            "us_per_step": t["us_per_step"],
            "runs_ms": t["runs_ms"],
            "team": t["team"],
            "other_team": t["other_team"],
            "other_team_ms": t["other_team_ms"],
        })
    kernels[1]["main"] = batch_stats
    next(k for k in kernels if k["name"] == "train_epoch_grid_banked")[
        "launches_online"] = online_stats["launches"]["train_epoch_grid_banked"]
    t8 = fleet_times[FLEET_TIMED_N[0]]
    fleet_err = {d: max(e, fleet_stats["hpnn_vs_plain"][d]) for d, e in fleet_err.items()}
    kernels.append({
        "name": "train_fleet_epoch_dbuf_banked",
        "route": "cuda",
        "source": "hpnn_tpu_torch/csrc/batch_step.cu",
        "replaces": "hpnn_tpu/ops/pallas_train.py:1041",
        "launches": fleet_launches["train_fleet_epoch_dbuf_banked"],
        "on_main_path": True,
        "max_abs_err": fleet_err["float32"],
        "max_abs_err_f32": fleet_err["float32"],
        "max_abs_err_f64": fleet_err["float64"],
        "ms": t8["ms"],
        "plain_ms": t8["plain_ms"],
        "bound_ms": t8["bound_ms"],
        "bound_by": t8["bound_by"],
        "library_ms": None,
        "timed": (f"ANN-BP 784-300-10 float32, {FLEET_TIMED_N[0]} members x one epoch of "
                  f"{math.ceil(TIMED_ROWS / BATCH)} steps of B={BATCH} over "
                  f"{TIMED_ROWS}-row banks"),
        "cluster": t8["cluster"],
        "ms_by_cluster": t8["ms_by_cluster"],
        "by_members": fleet_times,
        "crossover": fleet_cross,
        "plan_split": plan_split,
        "main": fleet_stats,
        "launches_by_entry": dict(fleet_launches, **{
            f"online.{k}": v for k, v in online_stats["launches"].items()}),
        "fleet_processes": fleet_stats_18,
    })
    tb = fleet_bf16_times
    kernels.append({
        "name": "train_fleet_epoch_dbuf_banked (bf16)",
        "route": "cuda",
        "source": "hpnn_tpu_torch/csrc/batch_step.cu",
        "replaces": "hpnn_tpu/ops/pallas_train.py:1041",
        "launches": fleet_stats["bf16"]["launches"]["train_fleet_epoch_dbuf_banked"],
        "on_main_path": True,
        "max_abs_err": fleet_bf16["w"],
        "max_loss_rel": fleet_bf16["loss_rel"],
        "band": BF16_BAND,
        "quant_err": fleet_bf16["quant_err"],
        "ms": tb["ms"],
        "plain_ms": tb["plain_ms"],
        "bound_ms": tb["bound_ms"],
        "bound_by": tb["bound_by"],
        "library_ms": None,
        "timed": (f"ANN-BP 784-300-10, bf16 storage, products on the tensor cores with "
                  f"float32 sums, {tb['members']} "
                  f"members x one epoch of {math.ceil(TIMED_ROWS / BATCH)} steps of "
                  f"B={BATCH} over {TIMED_ROWS}-row banks"),
        "f32_ms": tb["f32_ms"],
        "f32_fma_bound_ms": tb["f32_fma_bound_ms"],
        "runs_ms": tb["runs_ms"],
        "cluster": tb["cluster"],
        "main": fleet_stats["bf16"],
    })
    # the deepest net each kernel was held at against its plain version
    for k in kernels:
        k["deepest_layers"] = deep["layers"]
        k["deep"] = dict(err=deep["err"][k["name"]], times=deep["times"].get(k["name"]))
    kernels[0]["deep_entry_points"] = deep["entry"]
    kernels[0]["drills"] = drills
    # #1 with its vectors in device memory (phase 20): its launches are
    # train_nn's at 784-[15000]-10 float64, its time the float32 build
    tw = wide["times"]["float32"]
    kernels.insert(1, {
        "name": "convergence (vectors in device memory)",
        "route": "cuda",
        "source": "hpnn_tpu_torch/csrc/convergence.cu",
        "replaces": "hpnn_tpu/ops/pallas_train.py:260",
        "replaces_fn": "train_sample_fused",
        "launches": wide["entry"]["launches"],
        "max_abs_err": wide["err"]["float32"],
        "max_abs_err_f32": wide["err"]["float32"],
        "max_abs_err_f64": wide["err"]["float64"],
        "ms": tw["ms"],
        "plain_ms": tw["plain_ms"],
        "bound_ms": tw["bound_ms"],
        "bound_by": tw["bound_by"],
        "library_ms": None,
        "timed": (f"ANN-BP {tw['shape']} float32, {WIDE_SAMPLES} samples x "
                  f"{WIDE_TIMED_K + 1} iterations through the grid build; bound: W read "
                  f"and written once an iteration"),
        "ctas": tw["ctas"],
        "us_per_iter": tw["us_per_iter"],
        # the one-cluster device build (the wide nets' build before the grid), timed in turns
        "parent_us_per_iter": tw["cluster_us_per_iter"],
        "by_dtype": wide["times"],
        "bitwise_784_300_10": wide["bitwise_784_300_10"],
        "main": wide["entry"],
    })
    log(f"[card] {nvidia_smi_line()}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        fail(str(exc))
    except Exception as exc:
        fail(f"{type(exc).__name__}: {exc}", traceback.format_exc())
    # a failed phase may leave threads blocked on the card: exit without
    # waiting for them (or for the card) at interpreter shutdown
    os._exit(1)
