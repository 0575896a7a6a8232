"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a non-zero exit code and
no result line:

1. device: the card's name and power limit; TF32 off; build every CUDA
   kernel from src/repro_torch/csrc (phase 9a's embeddings table drawn on
   the host meanwhile); the registers, static shared memory and spills
   ``ptxas`` gave each kernel of kernels 1, 2, 2', 5, 6, 7 and 8.  Each
   phase prints the seconds since the build started as it ends.
2. kernels: each hand-written kernel against its plain PyTorch version on
   the card, at every shape the Sketchy training step gives it (fp32
   storage for the Gram and the f32 apply, int8 storage for the mixed Gram,
   the int8 write-back and the int8 apply) and at a few ragged ones; timed
   with CUDA events beside the plain version, one library call as a
   yardstick, and the least time the card could take (bound).  The
   single-block Gram and apply (kernels 3 and 4) at the serving shapes
   against their plain versions computed in float64, two runs giving the
   same bits.  Flash attention (kernel 7) and the SSD chunk scan (kernel
   8) at the dense training, zamba2-7b feedback and S = 4096 shapes
   (FLASH_MAIN, SSD_MAIN; mamba2-370m's too for the scan) and the
   reference's ragged sweeps, and at head dim 256 (gemma-2b's S 4096 and
   128 and the phase 7d gradient's shape, FLASH_HD256) and, untimed, at
   every other shape phases 4d, 7c, 7d, 9a and 9b give it
   (``flash_full_width``), in
   f32 and bf16, at
   the reference's
   tolerances and a relative error of the whole output (MODEL_RTOL), two
   runs giving the same bits; attention timed beside
   ``scaled_dot_product_attention`` (the scan has no single PyTorch call;
   at the main shapes over 200 launches, kernel and sdpa in turns), and at
   the launch-bound shapes (S <= 1024) both also timed alone on the device
   (a CUDA graph of 50 calls).  Kernels 1, 2, 2', 5, 6, 7 and 8 also print
   their achieved TFLOP/s and share of bound (kernels 1, 2, 2' and 5
   against both their 3xTF32 and f32 bounds, each with two runs giving the
   same bits at one main-path shape, and also held to the tolerance on
   data of mean 3; kernel 8 against its bf16 and f32 bounds); every row
   bound by f32 operations also prints that bound at the 3xTF32 rate.
   Kernel 4 also prints its reachable bound beside the read-once one: Y
   needs all of U^T G before its first row, so U and G are read twice but
   for what the chip holds (ONCHIP_BYTES); and the two passes' bytes.
   Kernel 1 also at the seven shapes of Shampoo's per-step L and R Grams at
   full width (``shampoo_gram_calls``), on data of mean 3, one step's 8
   calls summed beside the plain version and ``bmm``; and the copy that
   makes each group's G^T contiguous for L's Gram.  Kernel 1 also at the
   eight Gram shapes of phase 4s's butterfly merge (``merge_gram_shapes``:
   k = 2 (ell - 1) = 126, 22 for the 12-row side) and phase 4d's shrink
   merge (``shrink_merge_gram_shapes``: k = 2 ell = 128, 24), timed beside
   the plain version and ``bmm`` with its bound, one round's calls summed.
2t. tune (kernels/autotune.py): kernels 2, 2' and 6 at the main path's
   shapes (``tune_specs``), every candidate (the apply's column tiles, the
   write-back's block counts) against the plain version on the same
   operands and timed, whether the candidates give the same bits; the
   measured search into a cache under build/tune/; ``auto`` mode on the
   committed kernels/tune_cache.json picks what it records; a step's
   default and tuned sums printed.  (The phase runs after phase 3.)
3. eigh: ``torch.linalg.eigh`` over one refresh's 444 Grams (a library call
   in both packages, timed on its own); then one Shampoo root refresh
   (172 matrices of 1024^2, 270 of 768^2, 2 of 12^2): eigh alone and the
   whole inverse 4th root.
4. main paths: ``repro_torch.launch.train`` at full-width paper-lm-100m with
   Sketchy at the launcher's defaults (peak lr 3e-4, see MAIN_PATH_ARGV) for
   12 steps (refreshes at steps 0 and 10), once with fp32 and once with int8
   second-moment storage (the fused int8 path), each with every kernel's
   launch count set to 0 just before and read just after.  Every loss must
   be finite and the last below the first.  fp32: 16 Grams (8 per refresh)
   and 96 f32 applies (8 per step), no int8 kernel.  int8: 16 mixed Grams,
   16 write-backs, 96 int8 applies, no f32 Gram or apply, and the
   second-moment bytes of the JAX reference (24,661,092).  Both: 288 flash
   attentions (TRAIN_FLASH_PER_STEP: 12 layers, each once in the forward
   and once in the remat recompute of the backward, over 12 steps).  Then
   the paper's baselines on the same path and flags: ``--optimizer
   shampoo`` (fp32 L and R, roots at steps 0 and 10): 96 Grams (8 a step:
   4 pool groups, L and R), 288 flash attentions and no other kernel, and
   the JAX reference's second-moment bytes (1,358,434,432);
   ``--optimizer adam``: 288 flash attentions and no optimizer kernel, and
   654,388,224 B.  Each prints its step times (refresh and plain) and peak
   memory.  Then the engine's refresh schedules and modes and the rank
   budget on the same path: ``--refresh-schedule staggered`` (fp32; 78
   Grams: 8 at count 0, then 2 for each group with a due block, 96
   applies), ``--refresh-mode async`` with int8 storage (16 / 16 / 96, its
   peak printed beside the inline int8 run's), a ``rho_greedy`` budget of
   7104 (half of 222 blocks x 64) with the staggered schedule and int8
   storage (78 / 78 / 96; after the reallocation at step 10 the ranks sum
   to 7104 within [8, 64], printed per group with the blocks that moved),
   and Shampoo staggered and async (96 Grams); the second-moment bytes of
   the fp32, int8 and Shampoo runs above (the pending slot and the active
   ranks uncounted).  Every run also prints the matrices ``eigh`` took in
   each step.
4m. microbatching: full-width paper-lm-100m, Sketchy at MAIN_PATH_ARGV,
   2 steps (a refresh at step 0) with ``make_train_step(microbatches=4)``
   against the whole batch from the same weights: the losses and every
   parameter within MODEL_RTOL[bf16] in norm, kernels 1 and 2 launched as
   often (8 Grams, 16 applies), kernel 7 four times as often.
4s. sharded statistics: ``python -m torch.distributed.run --standalone
   --nproc-per-node 4 -m repro_torch.launch.train`` with MAIN_PATH_ARGV and
   ``--stats-reduction sharded`` (SHARDED_ARGV): 4 ranks share the one card
   over gloo, the sketches' wire and the gradients' mean through pinned
   host buffers; each rank writes its report (``--rank-report``).  Per
   rank: kernel 1 48 launches (2 refreshes x (8 local Grams + 16 merge
   Grams: 4 groups x 2 sides x 2 rounds)), kernel 2 96, kernel 7 288, no
   other kernel; losses finite and falling; at each refresh (steps 0 and
   10) SHARDED_WIRE_BYTES sent in 16 rounds, the JAX reference's
   ``wire_bytes`` of the same pools; the parameters, the sketches and the
   whole optimizer state the same bits on all 4 ranks.  Prints each rank's
   step times (refresh and plain), peak memory, and rank 0's rounds (bytes,
   the exchange with its host copies, the whole round).  Then the reduced
   model at P 2 on the card and at P 2 on the CPU (this script's
   ``--reduced-rank`` mode, both groups at once) from phase 6's weights:
   the same losses within phase 6's tolerance.
4d. distributed training (this script's own ``--mesh-rank`` mode, 4 ranks
   on the one card over gloo, each a process of its own, started once):
   (a) each rank's quarter of the launcher's batch 0 through full-width
   paper-lm-100m (kernel 7 24 times), its gradients'
   ``compressed_mean_grads`` beside their exact ``pmean``: every leaf
   within 0.02 of its largest magnitude and one int8 step of the exact
   mean (plus bf16's rounding of each), the same bits on every rank, and
   the bytes a rank sends (int32 sums, 4 B an element, and one f32 pmax a
   leaf: 654,388,272 B against the exact mean's 654,388,224); then one
   Sketchy step at the launcher's defaults on the same quarter (8 Grams, 8
   applies, 24 flash), whose pools, the rank's own sketches, it keeps.
   (b) ``remesh_opt_state`` of phase 4's fp32 state after its 12 steps
   (MESH_STATE), whole on every rank, on ``remesh(plan_mesh(4,
   model_parallel=2, target_global_batch=8))`` and on the shrink's 2-rank
   plan (ranks 2 and 3 get no mesh): each rank's local shard of every
   pooled stack bit for bit the blocks the reference's ``blocks_sharding``
   gives its position (``_block_rows``: model-major over ('model',
   'data'), else 'data', else whole), the ranks' shards covering every
   block once; the pooled bytes each rank holds.  (c) deepseek-moe-16b at
   full width with 4 of its 28 layers (EP_LAYERS; only the depth cut), 16
   of the 64 experts a rank (``convert.expert_parallel_shard``), a forward
   at B 4, S 512 (T 2048, capacity 241) and the gradient of its loss with
   respect to every moe layer's parameters under ``use_mesh`` on a (1, 4)
   mesh (remat on: the recompute runs on the autograd thread).  The
   parent then runs the single-process model on the same weights and
   batch: each moe block, whole, on the input the ranks' block took and
   pulled back with the cotangent their block's output got: its output,
   every rank's expert gradients (their slices), router and shared-expert
   gradients within MODEL_RTOL[bf16] in norm, the same dropped
   assignments; end to end, kernel 7's launches (7: 4 layers and the 3 moe
   layers' recompute) equal, the first moe layer routes and drops alike,
   a later one drops within the assignments routed to another expert, and
   the logits' and every gradient's relative errors printed (bf16's
   rounding of the routed sum reroutes near-ties in the later layers);
   the per-rank peak beside the single process's, each moe layer's sum.
   Then ``merge_sketches_on_shrink`` of the 4 ranks' own full-width pools
   on the card (kernel 1 24 launches at (N, d, 2 ell)), timed, against
   the same merge on the CPU (covariance, ladder and rho within
   tests/test_torch_distributed.py's tolerance).  Last on the ranks, the
   pipeline (train/pipeline_parallel.py ``gpipe_apply``): full-width
   paper-lm-100m's 12 layers as 4 stages of 3 (the model's dense block, bf16),
   phase 4's batch 0 in 4 microbatches (7 ticks, each stage's exchange
   through host memory), the output and each stage's layer gradients
   against the same 12 layers run one after the other on this rank within
   MODEL_RTOL[bf16] in norm, kernel 7 once a layer a tick; the time a tick
   printed.
5. profile: ``torch.profiler`` over one plain step of each of the four
   runs: device time by kernel and the device's idle share.  Then the
   async int8 run with ``--profile-annotations``: a plain step and the
   refresh-launch step, with the device time of the kernels inside each
   engine span (SPANS) and its host time.
6. reference: the reduced model trained 4 steps on the card (kernels) and on
   the CPU (plain versions) from the same weights gives the same losses,
   with Sketchy at fp32 and int8 storage, Shampoo at fp32 and int8 and Adam;
   the card run launches the flash kernel 4 x 3 times (3 layers, no remat
   in the reduced config).  Also Sketchy staggered (fp32), async (int8),
   with a ``rho_greedy`` budget of half the reduced capacity
   (REDUCED_BUDGET_ARGV; card and CPU reach the same active ranks), and
   Shampoo staggered and async.  Then the reduced model's Sketchy (int8,
   staggered) inline and async over the same gradients on the card: the
   async state's committed pools equal the inline pools bit for bit after
   each of 6 steps.
6a. checkpoint (train/checkpoint.py, the launcher's --checkpoint-dir,
   --checkpoint-every and --resume): at full width (MAIN_PATH_ARGV), for
   Sketchy fp32, int8, async int8, the rho_greedy budget (BUDGET_ARGV) and
   Shampoo fp32 (CKPT_RUNS), steps 0-5 are saved, restored into a fresh
   ``start()`` template and every leaf compared bit for bit with its dtype
   and shape (the pending slot rebuilt empty), the leaf data on disk equal
   to the state's bytes less the pending slot's; the save and restore
   timed; then step 6 from the restored state must give the bits of step 6
   from the live state (async: its pending slot reset), or differ by no
   more than the same step run twice from the live state (the witness;
   both printed).  Then ``python -m repro_torch.launch.train`` with a
   checkpoint every 5 steps leaves step-5, step-10 and step-12 and no
   tmp-; a copy of step-5 alone resumed in process prints "resumed from
   step 5", runs batches 5-11 (batch 5 again, as the reference resumes)
   at optimizer counts 6-12, launching kernels 1, 2 and 7 as those 7 steps
   should (one refresh, at count 10: 8 Grams, 56 applies, 168 flash).
   Then a reduced checkpoint from the CPU resumed on the card and on the
   CPU (phase 6, "resumed").
6b. convex: ``repro_torch.launch.convex`` (the paper's Tbl. 3 streams and
   grid) on the card and on the CPU: the 12 average losses and their ranks
   agree (as tests/test_torch_oco.py holds them), and kernels 3 and 4
   launch once per step of each FD learner (CONVEX_FD_LEARNERS; a diverged
   run stops at its first non-finite iterate or gradient), no other.
7. serve: ``repro_torch.launch.serve`` at full-width paper-lm-100m
   (SERVE_ARGV: step traffic over 24 ticks, the FD gradient monitor over
   the flattened lm_head, d = 25,165,824, and S-AdaGrad head adaptation
   when it says "adapt"), then a shorter run that adapts every tick
   (ADAPT_ARGV), each with every launch count set to 0 just before and read
   just after.  The single-block Gram (kernel 3) must launch once per
   monitor observation and adaptation step, and at least once in the first
   run; the single-block apply (kernel 4) once per adaptation step, and at
   least once in the second; the flash kernel 12 times per feedback
   gradient (one per tick and one per adaptation step; the untied head's
   gradient stops at the head, so no recompute: ``per_gradient``); no other
   kernel.  Every request must be served in full.  Prints the inter-token
   latency p50/p99, tokens served, the monitor's readings, adaptation
   steps, the monitor's ``observe`` and the adaptation step times, and
   peak memory; then profiles one full-width ``observe`` and one
   adaptation step (device time by kernel, idle share).
8. serve reference: the reduced serve run with monitor and adaptation on
   the card (kernels) and on the CPU (plain versions) from the same weights
   gives the same greedy tokens and monitor decisions, and the same adapted
   head within SERVE_HEAD_RTOL.
7b. serve zamba2-7b: ZAMBA_SERVE_ARGV at full width (81 Mamba2 layers, the
   shared attention+MLP block at 14 sites, 6,636,442,832 bf16 parameters;
   step traffic over 16 ticks; the monitor and the adapter over the
   flattened tied embed, d = 114,688,000), counts as in phase 7.  Per
   feedback gradient the flash kernel launches 28 times and the scan 162
   (14 sites and 81 mamba layers, each in the forward and again in the
   remat recompute: the tied embed's gradient flows back through every
   layer); kernels 3, 4, 7 and 8 each at least once, no training kernel.
   Then profiles one full-width feedback gradient, with kernel 8's device
   time and launches in it summed.
8b. serve reference of the reduced zamba2-7b and mamba2-370m, as phase 8,
   the adapted leaf their tied embed.
7c. serve deepseek-moe-16b: MOE_SERVE_ARGV at full width (28 layers, the
   first dense, then 64 routed experts top-6 and 2 shared; 16,375,728,128
   bf16 parameters; the monitor and the adapter over the untied lm_head, d
   = 209,715,200), counts as in phase 7 (28 flash launches per feedback
   gradient, kernels 3, 4 and 7 each at least once); prints the (token,
   expert) assignments dropped for capacity, and the peak allocated and
   reserved beside the card's memory.
7d. dense full width (DENSE_FULL): phi3-mini-3.8b (hd 96) and gemma-2b (hd
   256, one KV head, tied embed) whole, qwen2.5-32b (qkv bias) and qwen3-32b
   (qk norm) with 8 of their 64 layers (65.5 GB of weights and a gradient's
   activations do not fit one card): the engine's one-shot demo (4 requests
   x 8 new tokens), then feedback gradients with respect to the head leaf
   at B 4, S 512: one to warm up and DENSE_FULL_CALLS timed with CUDA
   events (median), with kernel 7's launches (gemma's 36 a gradient at hd
   256: 18 layers, forward and remat recompute).
8c. card against CPU of the reduced NEW_ARCHS (the four above,
   deepseek-moe-16b and kimi-k2-1t-a32b, whose 1.03 T parameters fit no
   card, qwen2-vl-72b and musicgen-large), each on its family's inputs
   (tokens, embeddings, or tokens of 4 codebooks): logits, a
   teacher-forced decode and one Sketchy step (rank 8, block 32, a refresh
   at the step).
9a. train full width (TRAIN_FULL): ``repro_torch.launch.train --arch
   qwen2-vl-72b`` (1 of its 80 layers; the vision frontend a stub, the
   pipeline's embeddings in) and ``musicgen-large`` (12 of 48 layers, 4
   codebooks), Sketchy at the launcher's defaults, 3 steps, peak lr 3e-5
   and 3e-4 (TRAIN_FULL_LR), the depth cut through a patched
   ``registry.get_config``, the caching allocator's expandable segments on
   for this phase alone; every launch count set to 0 just before and read
   just after (kernel 1 twice a pool group at the refresh, kernel 2 twice a
   group a step, kernel 7 twice a layer a step); the losses finite, near
   log V and falling, every weight matrix moved, no leaf by more than the
   grafted step allows, batch 0's loss lower after the run than at step 0;
   the second-moment bytes the reference's; prints the step times, each
   ``eigh``'s time, the peak memory allocated and reserved.
9b. vlm and audio full width (VLM_AUDIO_FULL): qwen2-vl-72b with 8 layers
   and musicgen-large whole, bf16, through the model and cache modules
   (the engine serves token-input archs only): a forward at B 4, S 512,
   a 16-token teacher-forced decode against it (DECODE_BF16_RTOL), and
   phase 7d's timed feedback gradients through ``lm_head`` with kernel 7's
   launches (once a layer a gradient).
10. dry run (launch/dryrun.py): ``python -m repro_torch.launch.dryrun
   --arch paper-lm-100m --shape train_4k`` on a fake group of 256 ranks (the
   production 16 x 16 mesh, the probes), its plan printed; then the plan
   of full-width paper-lm-100m at phase 4's shape on one rank against the
   card: its parameter and state bytes equal to ``launch.train``'s real
   state exactly, the card's bytes allocated above the arguments during
   step 0 (a refresh) PEAK_BAND of the plan's ``temp_bytes``, the step's
   time beside the plan's ``bound_s``.

The last two lines are ``{"kernels": [...]}`` and
``{"ok": true, "device": {...}}``; kernel 7 has a second row there at head
dim 256 (its launches phase 7d's gemma-2b gradients').  Kernel 1's row
there is Sketchy's main path; its Shampoo counts and times are on the
lines of phases 2 and 4, its sharded counts and merge shapes on those of
phases 2, 4s and 4d; kernel 7's expert-parallel launches on 4d's.
"""
from __future__ import annotations

import contextlib
import functools
import dataclasses
import io
import json
import math
import os
import shutil
import signal
import statistics
import subprocess
import sys
import threading
import time
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import tree  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import api, pool  # noqa: E402
from repro_torch.core.factory import OptimizerConfig  # noqa: E402
from repro_torch.core import fd as fd_lib  # noqa: E402
from repro_torch.core import quantize  # noqa: E402
from repro_torch.core import shampoo as shampoo_lib  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import registry as kernel_registry  # noqa: E402
from repro_torch.kernels.flash import kernel as flash_kernel  # noqa: E402
from repro_torch.kernels.flash import ref as flash_ref  # noqa: E402
from repro_torch.kernels.gram import kernel as gram_kernel  # noqa: E402
from repro_torch.kernels.gram import ref as gram_ref  # noqa: E402
from repro_torch.kernels.lowrank import kernel as lowrank_kernel  # noqa: E402
from repro_torch.kernels.lowrank import ref as lowrank_ref  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402
from repro_torch.launch import serve as serve_lib  # noqa: E402
from repro_torch.launch import train as train_lib  # noqa: E402
from repro_torch.models import cache as cache_lib  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.distributed import reduce as dreduce  # noqa: E402
from repro_torch.launch import mesh as mesh_lib  # noqa: E402
from repro_torch.sharding import rules as rules_lib  # noqa: E402
from repro_torch.train import compression, elastic  # noqa: E402
from repro_torch.train import checkpoint as ckpt_lib  # noqa: E402

# Published peaks of one H100 SXM (NVIDIA data sheet, dense, at its 700 W
# limit; launch/roofline.py holds them for the whole package): device
# memory 3.35 TB/s; f32 outside the tensor cores 67 TFLOP/s; tf32 on the
# tensor cores 494.7 TFLOP/s; bf16 on the tensor cores 989 TFLOP/s; int8 on
# the tensor cores 1979 TOP/s.  A bound takes the
# operations at the rate of the fastest unit shown to meet the function's
# tolerance, whatever unit the hand-written kernel itself uses: bf16 for
# bf16 attention (the reference multiplies q k^T and p v in the inputs'
# type, accumulating in f32) and the bf16 SSD scan (csrc/ssd.cu meets the
# reference's bf16 tolerance rounding the decayed scores, the state and
# the decayed u to bf16); error-compensated 3xTF32 (three tf32 products a
# multiply-add, 494.7 / 3 TFLOP/s) for the batched FD Grams' f32 columns
# and the batched apply, which csrc/gram.cu and csrc/lowrank.cu show meets
# their f32 tolerance of 1e-4 sqrt(d) (one tf32 product does not), with the
# mixed Gram's exact int8 columns needing fewer (_mixed_tf32_ms); f32 for
# the other FD kernels (int8 factors meet f32 operands).  Kernels 1, 2, 2'
# and 5 carry the 3xTF32 bound in the JSON line and print their f32 one
# beside it; every other row bound by f32 operations keeps its f32 bound
# there and prints its bound at 3xTF32 beside it, for ordering only.
# ONCHIP_BYTES, what the card holds on chip at once, is the most of a tall
# factor that a two-product pass can keep between its products instead of
# reading it again (kernel 4's bound).
from repro_torch.launch.roofline import (  # noqa: E402
    BF16_FLOPS_PER_S, F32_FLOPS_PER_S, HBM_BYTES_PER_S, INT8_OPS_PER_S,
    ONCHIP_BYTES, TF32_FLOPS_PER_S, TF32X3_FLOPS_PER_S)
RANK, BLOCK = 64, 1024          # the launcher's defaults
# The launcher's defaults but a peak lr of 3e-4 (default 3e-3): with 12
# steps the warmup-cosine schedule warms up for one step, and at full width
# the default peak makes the loss rise over these steps, in f32 as in bf16
# (scripts/torch_lr_probe.py; PERF.md).
MAIN_PATH_ARGV = ["--steps", "12", "--lr", "3e-4", "--log-every", "1"]
INT8_ARGV = ["--second-moment-dtype", "int8"]
# second_moment_bytes of the JAX reference at full width with the
# launcher's defaults and int8 storage (tests/test_torch_quantize.py)
INT8_SECOND_MOMENT_BYTES = 24_661_092
# phase 4s: MAIN_PATH_ARGV with sharded statistics over SHARDED_RANKS
# ranks on the one card; the bytes each rank sends per refresh (int8 wire:
# 2 butterfly rounds x both sides of the 4 pool groups), the JAX
# reference's wire_bytes of the same pool shapes
# (tests/test_torch_distributed.py)
SHARDED_RANKS = 4
SHARDED_ARGV = ["--stats-reduction", "sharded"]
SHARDED_WIRE_BYTES = 48_327_120
# the paper's baselines on the same path: full-matrix Shampoo (fp32 L, R,
# roots every 10 steps, as Sketchy's refresh) and Adam, with the JAX
# reference's second-moment bytes at full width
# (tests/test_torch_optimizers.py)
SHAMPOO_ARGV = ["--optimizer", "shampoo"]
ADAM_ARGV = ["--optimizer", "adam"]
SHAMPOO_SECOND_MOMENT_BYTES = 1_358_434_432
ADAM_SECOND_MOMENT_BYTES = 654_388_224
# the engine's refresh schedules and modes and the rank budget on the same
# path (core/api.py, core/sketchy.py): the staggered schedule (fp32), the
# async refresh (int8), a rho_greedy budget of half the capacity (222
# blocks x 64 / 2 = 7104, as benchmarks/run.py's half-budget row) with the
# staggered schedule (int8), and Shampoo staggered and async; the pending
# slot and the active ranks are counted in no byte
FP32_SECOND_MOMENT_BYTES = 98_292_176
STAGGERED_ARGV = ["--refresh-schedule", "staggered"]
ASYNC_INT8_ARGV = ["--refresh-mode", "async"] + INT8_ARGV
BUDGET_TOTAL, BUDGET_MIN_K, BUDGET_MAX_K = 7104, 8, 64
BUDGET_ARGV = ["--rank-budget",
               f"total={BUDGET_TOTAL},min_k={BUDGET_MIN_K},"
               f"max_k={BUDGET_MAX_K},policy=rho_greedy"] \
    + STAGGERED_ARGV + INT8_ARGV
SHAMPOO_STAGGERED_ASYNC_ARGV = SHAMPOO_ARGV + STAGGERED_ARGV \
    + ["--refresh-mode", "async"]
# the serving path's FD sketches: the flattened full-width lm_head (768 x
# 32768) at the monitor's and the adapter's default rank
SERVE_D, SERVE_ELL = 768 * 32768, 8
SERVE_ARGV = ["--no-reduced", "--traffic",
              "shape=step,rate=1.0,ticks=24,step_at=12",
              "--monitor", "window=4,ell=8", "--adapt", "lr=0.1,beta2=0.95"]
ADAPT_ARGV = ["--no-reduced", "--traffic", "shape=constant,rate=1.0,ticks=4",
              "--adapt", "lr=0.1,beta2=0.95"]
REDUCED_SERVE_ARGV = ["--traffic", "shape=step,rate=1.0,ticks=12,step_at=6",
                      "--monitor", "window=3,ell=8,top_k=3",
                      "--adapt", "lr=0.1,beta2=0.95"]
# the moe family at full width: deepseek-moe-16b (28 layers, the first
# dense, 64 routed experts top-6 and 2 shared, 16,375,728,128 bf16
# parameters), the monitor and the adapter over its untied lm_head (2,048 x
# 102,400; 71-76 GB at peak with the weights, PERF.md)
MOE_SERVE_ARGV = ["--arch", "deepseek-moe-16b", "--no-reduced", "--traffic",
                  "shape=step,rate=1.0,ticks=16,step_at=8",
                  "--monitor", "window=4,ell=8", "--adapt",
                  "lr=0.1,beta2=0.95"]
# the dense configs with one feature each at full width: (arch, layers kept;
# None keeps all): qwen2.5-32b's and qwen3-32b's 65.5 GB of weights and a
# gradient's activations do not fit one card, so they keep 8 of 64 layers
DENSE_FULL = [("phi3-mini-3.8b", None), ("gemma-2b", None),
              ("qwen2.5-32b", 8), ("qwen3-32b", 8)]
DENSE_FULL_BATCH, DENSE_FULL_SEQ = 4, 512
# timed feedback gradients per dense full-width arch, after one warm-up
DENSE_FULL_CALLS = 5
# the flattened full-width lm_head of deepseek-moe-16b (2,048 x 102,400),
# phase 7c's monitored and adapted leaf: kernels 3 and 4 at (MOE_D, 9) and
# (MOE_D, 8, 1) in its run
MOE_D = 2048 * 102400
# the serving launcher's feedback batch (launch/serve.py): batch 4, seq 16
SERVE_FEEDBACK_BATCH, SERVE_FEEDBACK_SEQ = 4, 16
# the architectures of ROADMAP.md queue 1 items 13(a)-(d), reduced, card
# against CPU (kimi-k2-1t-a32b's 1.03 T parameters fit no card)
NEW_ARCHS = ["phi3-mini-3.8b", "qwen2.5-32b", "qwen3-32b", "gemma-2b",
             "deepseek-moe-16b", "kimi-k2-1t-a32b", "qwen2-vl-72b",
             "musicgen-large"]
NEW_ARCH_ARGV = ["--reduced", "--steps", "1", "--seq", "16", "--batch", "4",
                 "--rank", "8", "--block-size", "32", "--update-every", "1"]
# the hybrid family at full width: zamba2-7b's tied embed (32,000 x 3,584)
# is the monitored and adapted leaf
ZAMBA_SERVE_ARGV = ["--arch", "zamba2-7b", "--no-reduced", "--traffic",
                    "shape=step,rate=1.0,ticks=16,step_at=8",
                    "--monitor", "window=4,ell=8", "--adapt",
                    "lr=0.1,beta2=0.95"]
# the vlm and audio families trained at full width through launch.train
# (phase 9a), Sketchy at the launcher's defaults (rank 64, block 1024,
# update_every 10, batch 8 x seq 128, fp32 storage), 3 steps (a refresh at
# count 0, then two plain steps): (arch, layers kept, pool groups, the JAX
# reference's second-moment bytes at that depth,
# tests/test_torch_vlm_audio.py).  The refresh holds M, its Gram and its
# eigenvectors for every block of a group at once (core/fd.py), which
# bounds the depth one card trains: qwen2-vl-72b's one layer and
# 1,192-block head make 2,032 blocks of 1024^2; musicgen-large keeps 12 of
# its 48 layers, 804 blocks (PERF.md §4)
TRAIN_FULL = [("qwen2-vl-72b", 1, 1, 1_066_549_120),
              ("musicgen-large", 12, 2, 420_906_720)]
TRAIN_FULL_STEPS = 3
TRAIN_FULL_ARGV = ["--steps", str(TRAIN_FULL_STEPS), "--log-every", "1"]
# each run's peak lr: the main path's 3e-4, but 3e-5 for qwen2-vl-72b,
# whose loss at 3e-4 rose from 12.78 to 20.09 in the one step that moves
# the weights (the reference's falls and then rises at that lr at d_model
# 2048, vlm_width_lr_cpu.py; whether it would rise as the port's does at
# the full 8,192 is not shown, PERF.md §7)
TRAIN_FULL_LR = {"qwen2-vl-72b": "3e-5", "musicgen-large": "3e-4"}
# phase 9b, the same families' model at full width, driven directly (the
# serving engine takes token-input archs only): (arch, layers kept; None
# keeps all); qwen2-vl-72b cut as phase 7d cuts the qwens
VLM_AUDIO_FULL = [("qwen2-vl-72b", 8), ("musicgen-large", None)]
# phase 9b's teacher-forced decode: its first positions against the
# forward's logits, relative to their norm (bf16 through every layer, the
# decode's attention in plain ops and the forward's in kernel 7)
VLM_AUDIO_DECODE = 16
DECODE_BF16_RTOL = 5e-2
# launches of the flash attention kernel in one training step of
# MAIN_PATH_ARGV: each of the 12 layers' attention once in the forward and
# once more in the backward's recompute (remat; every parameter needs a
# gradient, so the backward passes through every layer)
TRAIN_FLASH_PER_STEP = 12 * 2
# the adapted reduced head (paper-lm-100m's lm_head, the ssm and hybrid
# families' tied embed) on the card against the CPU, relative to its
# largest magnitude: f32 sums of d = 16,384 products in other orders in the
# Gram and the projection, and each device's eigh, over the run's
# adaptation steps (measured 1.2e-7 for the lm_head on an H100)
SERVE_HEAD_RTOL = 1e-5


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def graph_ms(fn, calls: int = 50) -> float:
    """Device time of one call of ``fn``: ``calls`` calls captured in a CUDA
    graph, the graph's replay timed with CUDA events (no host work between
    the launches)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                   # warm up off the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return cuda_ms(graph.replay, 5) / calls


def _in_turns(kernel, library, reps: int) -> tuple[float, float]:
    """``cuda_ms`` of ``kernel`` and ``library`` timed in turns (kernel,
    library, kernel, library), each the lower of its two runs: at
    launch-bound shapes both are host-bound and the host's noise moves
    single runs."""
    runs = [cuda_ms(fn, reps) for fn in (kernel, library, kernel, library)]
    return min(runs[0], runs[2]), min(runs[1], runs[3])


def bound_ms(nbytes: float, flops: float,
             flops_per_s: float = F32_FLOPS_PER_S) -> tuple[float, float]:
    """(ms to move ``nbytes`` through device memory, ms for ``flops`` at
    ``flops_per_s``, by default f32 outside the tensor cores); the bound is
    the larger."""
    return nbytes / HBM_BYTES_PER_S * 1e3, flops / flops_per_s * 1e3


def main_path_shapes() -> tuple[list, list]:
    """(refresh shapes, apply shapes) of one Sketchy step at full width, from
    the port's own pool index, per group the left and right side: (N, d,
    ell, r) of the refresh (its Gram is (N, d, ell + r)) and (N, d, ell, n)
    of the apply."""
    cfg = registry.get_config("paper-lm-100m")
    shapes = [tuple(s) for s in tree.flatten(model_lib.param_shapes(cfg))]
    refresh, apply = [], []
    for g in pool.build_index(tuple(shapes), BLOCK).groups:
        for d, other in ((g.bs_m, g.bs_n), (g.bs_n, g.bs_m)):
            ell = min(RANK, d)
            refresh.append((g.num_blocks, d, ell, other))
            apply.append((g.num_blocks, d, ell, other))
    return refresh, apply


def tolerance_share(got: torch.Tensor, want: torch.Tensor,
                    d: int) -> tuple[float, float]:
    """(largest |got - want|, largest |got - want| over the f32 tolerance of
    the tests, 1e-4 sqrt(d) + 1e-5 |want|: sums of d products in another
    order)."""
    diff = (got.double() - want.double()).abs()
    tol = 1e-4 * math.sqrt(d) + 1e-5 * want.double().abs()
    return float(diff.max()), float((diff / tol).max())


def check(name: str, got: torch.Tensor, want: torch.Tensor, d: int) -> float:
    """Fails unless ``got`` is within the f32 tolerance of ``want``
    (``tolerance_share``); returns the largest absolute difference."""
    diff, share = tolerance_share(got, want, d)
    if not share <= 1:
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max abs diff {diff:.3e})")
    return diff


def phase_kernels(dev) -> dict:
    gen = torch.Generator(device=dev).manual_seed(0)
    refresh_main, apply_main = main_path_shapes()
    gram_main = [(N, d, ell + r) for N, d, ell, r in refresh_main]
    out, f32_rows = {}, []

    rows, err = [], 0.0
    # (N, d, k, mean of the entries): the main path, ragged shapes, and
    # data of mean 3, on which the 3xTF32 products need the promotion of
    # csrc/gram.cu's accumulator every chunk to hold the tolerance
    for N, d, k, mean in [(*s, 0.0) for s in gram_main + [
            (3, 20, 6), (7, 33, 9), (5, 100, 30), (1, 33, 129)]] + [
            (8, 1024, 832, 3.0)]:
        a = torch.randn(N, d, k, generator=gen, device=dev) + mean
        if (N, d, k) == gram_main[0]:
            got = _same_bits(f"batched_gram {(N, d, k)}",
                             lambda: gram_kernel.batched_gram(a))
        else:
            got = gram_kernel.batched_gram(a)
            torch.cuda.synchronize()
        err = max(err, check(f"batched_gram {(N, d, k)} mean {mean}", got,
                             gram_ref.batched_gram_ref(a), d))
        if (N, d, k) not in gram_main:
            continue
        ms = cuda_ms(lambda: gram_kernel.batched_gram(a), 3)
        plain = cuda_ms(lambda: gram_ref.batched_gram_ref(a), 3)
        lib = cuda_ms(lambda: torch.bmm(a.mT, a), 3)
        # symmetric output: d * k (k + 1) / 2 multiply-adds are needed
        flops = N * d * k * (k + 1)
        t_bytes = bound_ms(4 * (N * d * k + N * k * k), 0)[0]
        t_f32, t_tf32 = (flops / rate * 1e3 for rate in
                         (F32_FLOPS_PER_S, TF32X3_FLOPS_PER_S))
        rows.append((ms, plain, lib, t_bytes, t_tf32))
        f32_rows.append(max(t_bytes, t_f32))
        print(f"batched_gram N={N} d={d} k={k}: {ms:.4f} ms "
              f"({_rate(flops, ms)}, {max(t_bytes, t_tf32) / ms:.1%} of the "
              f"3xTF32 bound, {max(t_bytes, t_f32) / ms:.1%} of the f32 "
              f"one), plain {plain:.4f} ms, bmm {lib:.4f} ms "
              f"({_rate(flops, lib)}), bound {max(t_bytes, t_tf32):.4f} ms "
              f"(bytes {t_bytes:.4f}, 3xTF32 operations {t_tf32:.4f}; f32 "
              f"operations {t_f32:.4f})")
    out["batched_gram"] = dict(
        name="batched_gram", route="cuda",
        source="src/repro_torch/csrc/gram.cu",
        replaces="src/repro/kernels/gram/kernel.py:99",
        max_abs_err=err, **_sums(rows))
    _refresh_line("batched_gram", out["batched_gram"], f32_rows,
                  sum(N * d * k * (k + 1) for N, d, k in gram_main), "bmm")

    rows, err, f32_rows = [], 0.0, []
    # (N, d, ell, n, mean of G's entries): the main path, ragged shapes
    # (ell 17, m no multiple of the column tile, ell over one group), and G
    # of mean 3, where the 3xTF32 products' sums are large
    for N, d, ell, n, mean in [(*s, 0.0) for s in apply_main + [
            (3, 24, 6, 10), (7, 123, 17, 50), (2, 300, 130, 70)]] + [
            (*apply_main[0], 3.0)]:
        u = torch.randn(N, d, ell, generator=gen, device=dev)
        g = torch.randn(N, d, n, generator=gen, device=dev) + mean
        c = torch.rand(N, ell, generator=gen, device=dev)
        b = torch.rand(N, generator=gen, device=dev)
        label = f"batched_lowrank_apply {(N, d, ell, n)} mean {mean}"
        if (N, d, ell, n, mean) == (*apply_main[0], 0.0):
            got = _same_bits(label, lambda: (
                lowrank_kernel.batched_lowrank_apply(u, c, b, g)))
        else:
            got = lowrank_kernel.batched_lowrank_apply(u, c, b, g)
            torch.cuda.synchronize()
        err = max(err, check(label, got,
                             lowrank_ref.batched_lowrank_apply_ref(u, c, b, g),
                             d))
        if (N, d, ell, n) not in apply_main or mean != 0.0:
            continue
        ms = cuda_ms(lambda: lowrank_kernel.batched_lowrank_apply(u, c, b, g),
                     5)
        plain = cuda_ms(
            lambda: lowrank_ref.batched_lowrank_apply_ref(u, c, b, g), 5)
        lib = cuda_ms(lambda: torch.baddbmm(
            g * b[:, None, None], u, c[:, :, None] * torch.bmm(u.mT, g)), 5)
        row, f32_bound = _apply_row(
            f"batched_lowrank_apply N={N} d={d} ell={ell} n={n}", ms, plain,
            lib, 4 * (N * d * ell + N * ell + N + 2 * N * d * n), N, d, ell,
            n)
        rows.append(row)
        f32_rows.append(f32_bound)
    out["batched_lowrank_apply"] = dict(
        name="batched_lowrank_apply", route="cuda",
        source="src/repro_torch/csrc/lowrank.cu",
        replaces="src/repro/kernels/lowrank/kernel.py:97",
        max_abs_err=err, **_sums(rows))
    _step_line("batched_lowrank_apply", rows, f32_rows, apply_main)
    out.update(phase_int8_kernels(dev, gen, refresh_main, apply_main))
    out.update(phase_single_kernels(dev, gen))
    out.update(phase_model_kernels(dev, gen))
    return out


def _same_bits(name: str, fn) -> torch.Tensor:
    """``fn()`` twice; fails unless both give the same bits."""
    got, again = fn(), fn()
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail(f"{name}: two runs on the same inputs differ")
    return got


def phase_single_kernels(dev, gen) -> dict:
    """Phase 2's rows of the single-block kernels of the serving path, at
    its shape (the flattened lm_head: d = SERVE_D, ell = 8, one gradient
    column, the timed row), at deepseek-moe-16b's (d = MOE_D, phase 7c)
    and a few ragged ones, against the plain versions in float64."""
    out = {}
    rows, err = [], 0.0
    for d, k in [(SERVE_D, SERVE_ELL + 1), (MOE_D, SERVE_ELL + 1), (33, 9),
                 (100, 30), (4097, 17)]:
        a = torch.randn(d, k, generator=gen, device=dev)
        got = _same_bits(f"gram {(d, k)}", lambda: gram_kernel.gram(a))
        err = max(err, check(f"gram {(d, k)}", got,
                             gram_ref.gram_ref(a.double()), d))
        if d != SERVE_D:
            continue
        ms = cuda_ms(lambda: gram_kernel.gram(a), 10)
        plain = cuda_ms(lambda: gram_ref.gram_ref(a), 10)
        lib = cuda_ms(lambda: torch.matmul(a.T, a), 10)
        t_bytes, t_ops = bound_ms(4 * (d * k + k * k), d * k * (k + 1))
        rows.append((ms, plain, lib, t_bytes, t_ops))
        print(f"gram d={d} k={k}: {ms:.3f} ms, plain {plain:.3f} ms, "
              f"matmul {lib:.3f} ms, bound {max(t_bytes, t_ops):.3f} ms "
              f"(bytes {t_bytes:.3f}, operations {t_ops:.3f})")
    out["gram"] = dict(
        name="gram", route="cuda", source="src/repro_torch/csrc/gram_tall.cu",
        replaces="src/repro/kernels/gram/kernel.py:53", max_abs_err=err,
        **_sums(rows))

    rows, err = [], 0.0
    for d, ell, n in [(SERVE_D, SERVE_ELL, 1), (MOE_D, SERVE_ELL, 1),
                      (24, 6, 1), (123, 17, 5), (1000, 300, 3)]:
        u = torch.randn(d, ell, generator=gen, device=dev)
        g = torch.randn(d, n, generator=gen, device=dev)
        c = torch.rand(ell, generator=gen, device=dev)
        b = torch.rand((), generator=gen, device=dev)
        got = _same_bits(f"lowrank_apply {(d, ell, n)}",
                         lambda: lowrank_kernel.lowrank_apply(u, c, b, g))
        err = max(err, check(
            f"lowrank_apply {(d, ell, n)}", got,
            lowrank_ref.lowrank_apply_ref(u.double(), c.double(), b.double(),
                                          g.double()), d))
        if d != SERVE_D:
            continue
        ms = cuda_ms(lambda: lowrank_kernel.lowrank_apply(u, c, b, g), 10)
        plain = cuda_ms(lambda: lowrank_ref.lowrank_apply_ref(u, c, b, g),
                        10)
        lib = cuda_ms(lambda: b * g + u @ (c[:, None] * (u.T @ g)), 10)
        # the JSON's bound reads each input once; Y needs all of U^T G
        # before its first row, so what of U and G does not stay on chip
        # between the two products is read twice: the reachable bound is
        # the two passes' bytes less ONCHIP_BYTES
        t_bytes, t_ops = bound_ms(4 * (d * ell + ell + 1 + 2 * d * n),
                                  4 * d * ell * n + 2 * d * n + ell * n)
        two_pass_bytes = 4 * (2 * d * ell + 3 * d * n + ell + 1)
        reach = bound_ms(max(two_pass_bytes - ONCHIP_BYTES, 0), 0)[0]
        two_pass = bound_ms(two_pass_bytes, 0)[0]
        rows.append((ms, plain, lib, t_bytes, t_ops))
        print(f"lowrank_apply d={d} ell={ell} n={n}: {ms:.3f} ms, plain "
              f"{plain:.3f} ms, matmuls {lib:.3f} ms, bound "
              f"{max(t_bytes, t_ops):.3f} ms (each input read once: bytes "
              f"{t_bytes:.3f}, operations {t_ops:.3f}); reachable bound "
              f"{max(reach, t_ops):.3f} ms ({max(reach, t_ops) / ms:.1%}; "
              f"U and G read twice but for the {ONCHIP_BYTES} B on chip), "
              f"two passes {two_pass:.3f} ms ({two_pass / ms:.1%})")
    out["lowrank_apply"] = dict(
        name="lowrank_apply", route="cuda",
        source="src/repro_torch/csrc/lowrank_tall.cu",
        replaces="src/repro/kernels/lowrank/kernel.py:51", max_abs_err=err,
        **_sums(rows))
    return out


# kernel 7 at the main paths' shapes (B, Hq, Hkv, S, hd, causal): the dense
# training step, zamba2-7b's feedback gradient (the serving main path, the
# JSON row) and a long sequence; then tests/test_kernels.py:196-201's sweep
FLASH_MAIN = [(8, 12, 12, 128, 64, True), (4, 32, 32, 16, 112, True),
              (1, 32, 32, 4096, 112, True)]
# kernel 7 at gemma-2b's head dim 256 (MQA): S 4096 (its JSON row), S 128,
# and the full-width dense phase's feedback gradient
FLASH_HD256 = [(1, 8, 1, 4096, 256, True), (1, 8, 1, 128, 256, True),
               (DENSE_FULL_BATCH, 8, 1, DENSE_FULL_SEQ, 256, True)]


def flash_full_width() -> list:
    """Kernel 7's shapes in phases 4d, 7c, 7d, 9a and 9b, read from the
    configs: deepseek-moe-16b's feedback gradient (the serving launcher's
    feedback batch) and its expert-parallel run's (phase 4d), each DENSE_FULL and VLM_AUDIO_FULL arch's gradient at
    DENSE_FULL_BATCH x DENSE_FULL_SEQ (gemma-2b's is FLASH_HD256's last)
    and each TRAIN_FULL arch's training step at the launcher's batch and
    sequence (qwen2-vl-72b's GQA 64/8 at hd 128, musicgen-large's MHA
    32/32 at hd 64)."""
    train = train_lib.parse_args([])
    runs = [("deepseek-moe-16b", SERVE_FEEDBACK_BATCH, SERVE_FEEDBACK_SEQ),
            (EP_ARCH, EP_BATCH, EP_SEQ)]
    runs += [(arch, DENSE_FULL_BATCH, DENSE_FULL_SEQ)
             for arch, _ in DENSE_FULL + VLM_AUDIO_FULL]
    runs += [(arch, train.batch, train.seq) for arch, *_ in TRAIN_FULL]
    shapes = []
    for arch, B, S in runs:
        cfg = registry.get_config(arch)
        shapes.append((B, cfg.num_heads, cfg.num_kv_heads, S, cfg.head_dim,
                       True))
    return shapes


FLASH_SWEEP = [(1, 2, 2, 64, 16, True), (2, 4, 2, 96, 32, True),
               (1, 8, 1, 128, 64, True), (2, 2, 2, 80, 16, False)]
# kernel 8 (B, S, H, P, N, chunk): zamba2-7b's feedback gradient (the JSON
# row), zamba2-7b and mamba2-370m at S = 4096 with their chunk of 256; then
# tests/test_kernels.py:215-219's sweep
SSD_MAIN = [(4, 16, 112, 64, 64, 16), (1, 4096, 112, 64, 64, 256),
            (1, 4096, 32, 64, 128, 256)]
# tests/test_kernels.py:215-219's sweep, and S and H that are no multiple
# of the chunk or the head tile (the kernel masks them; models/ssm.py does
# not pad)
SSD_SWEEP = [(1, 32, 4, 16, 16, 8), (2, 64, 8, 16, 32, 16),
             (1, 48, 6, 32, 64, 16), (2, 70, 5, 32, 48, 32)]
# the reference's tolerances (tests/test_kernels.py:210 and :230) against
# the plain version on the f32 upcast inputs
FLASH_ATOL = {torch.float32: 2e-5, torch.bfloat16: 0.05}


def _ssd_atol(dtype, S: int) -> float:
    return 5e-6 * S if dtype == torch.float32 else 0.15


# Beside the atol, the error of the whole output relative to its size,
# ||got - want|| / ||want||: at S 4096 attention's outputs are softmax
# averages over ~2k keys, ~0.03 each, so an atol of 0.05 alone would pass
# a kernel that dropped the later key tiles.  bf16 rounds p before P V and
# the output once (unit roundoff 2^-8 each: ~3e-3 expected); f32 only sums
# in another order.
MODEL_RTOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _agree(label: str, got, want, atol: float) -> float:
    """Fails unless ``got`` is within ``atol`` of ``want`` everywhere and
    within ``MODEL_RTOL`` of it in norm; returns the largest absolute
    difference."""
    err = got.float() - want
    diff = float(err.abs().max())
    rel = float(err.norm() / want.norm())
    rtol = MODEL_RTOL[got.dtype]
    if diff > atol or rel > rtol:
        fail(f"{label}: kernel disagrees with its plain version (max abs "
             f"diff {diff:.3e}, tolerance {atol}; relative error {rel:.3e}, "
             f"tolerance {rtol})")
    return diff


def phase_model_kernels(dev, gen) -> dict:
    """Phase 2's rows of the model's kernels: flash attention (kernel 7)
    and the SSD chunk scan (kernel 8), each against its plain version on
    the f32 upcast inputs at the reference's tolerance and ``MODEL_RTOL``,
    the main shapes timed in bf16 beside the plain version (and, for
    attention, PyTorch's ``scaled_dot_product_attention`` as a yardstick,
    never called by the port).  Bounds: bytes of the inputs and the output
    over 3.35 TB/s, or the operations at the rate of the unit the kernel
    multiplies in (bf16 on the tensor cores, 989 TFLOP/s, for both; the
    scan's f32 bound beside it), whichever is larger; the JSON row is the
    serving main path's shape, one call, and attention at head dim 256 has
    a row of its own (FLASH_HD256, its S 4096 shape).  Every shape that
    phases 7c, 7d, 9a and 9b give kernel 7 (``flash_full_width``) is
    checked too, untimed.  The launch-bound
    shapes also print their device time alone (a CUDA graph of 50
    calls)."""
    out = {}
    rows, rows_hd256, err, err_hd256 = [], [], 0.0, 0.0
    full_width = [c for c in flash_full_width() if c not in FLASH_HD256]
    cases = [(c, torch.bfloat16) for c in FLASH_MAIN + FLASH_HD256
             + full_width] + \
        [(c, dt) for c in FLASH_SWEEP for dt in (torch.float32,
                                                  torch.bfloat16)]
    for (B, Hq, Hkv, S, hd, causal), dt in cases:
        q, k, v = (torch.randn(B, S, h, hd, generator=gen, device=dev)
                   .to(dt).transpose(1, 2) for h in (Hq, Hkv, Hkv))
        label = f"flash_attention {(B, Hq, Hkv, S, hd, causal)} {dt}"
        got = _same_bits(label, lambda: flash_kernel.flash_attention(
            q, k, v, causal=causal))
        want = flash_ref.attention_ref(q.float(), k.float(), v.float(),
                                       causal=causal)
        diff = _agree(label, got, want, FLASH_ATOL[dt])
        del want
        main = (B, Hq, Hkv, S, hd, causal)
        if main in FLASH_HD256:
            err_hd256 = max(err_hd256, diff)
        else:
            err = max(err, diff)
        if main not in FLASH_MAIN + FLASH_HD256:
            continue
        # 200 launches at the launch-bound main-path shapes (over 20 their
        # times moved up to 2x between runs), kernel and sdpa in turns,
        # each the lower of its two runs
        reps = 10 if S > 1024 else 200
        gqa = Hq != Hkv
        ms, lib = _in_turns(
            lambda: flash_kernel.flash_attention(q, k, v, causal=causal),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=gqa), reps)
        plain = cuda_ms(lambda: flash_ref.attention_ref(q, k, v,
                                                        causal=causal), reps)
        if S <= 1024:   # launch-bound: the device's share, without the host
            dev_kernel = graph_ms(lambda: flash_kernel.flash_attention(
                q, k, v, causal=causal))
            dev_lib = graph_ms(
                lambda: torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=gqa))
            print(f"flash_attention B={B} H={Hq} S={S} hd={hd} device time "
                  f"per call (CUDA graph of 50): kernel "
                  f"{dev_kernel * 1e3:.2f} us, sdpa {dev_lib * 1e3:.2f} us")
        pairs = S * (S + 1) // 2 if causal else S * S
        t_bytes, t_ops = bound_ms(2 * (2 * B * Hq * S * hd
                                       + 2 * B * Hkv * S * hd),
                                  4 * B * Hq * pairs * hd, BF16_FLOPS_PER_S)
        (rows_hd256 if main in FLASH_HD256 else rows).append(
            ((B, Hq, S, hd), ms, plain, lib, t_bytes, t_ops))
        flops = 4 * B * Hq * pairs * hd
        print(f"flash_attention B={B} H={Hq} S={S} hd={hd} bf16: {ms:.4f} "
              f"ms ({_rate(flops, ms)}, {max(t_bytes, t_ops) / ms:.1%} of "
              f"bound), plain {plain:.4f} ms, sdpa {lib:.4f} ms "
              f"({_rate(flops, lib)}), bound {max(t_bytes, t_ops):.4f} ms "
              f"(bytes {t_bytes:.4f}, operations {t_ops:.4f}); kernel / "
              f"sdpa {ms / lib:.2f}")
    out["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="src/repro_torch/csrc/flash.cu",
        replaces="src/repro/kernels/flash/kernel.py:80",
        max_abs_err=err, **_row(rows[1]))
    out["flash_attention_hd256"] = dict(
        name="flash_attention_hd256", route="cuda",
        source="src/repro_torch/csrc/flash.cu",
        replaces="src/repro/kernels/flash/kernel.py:80",
        max_abs_err=err_hd256, **_row(rows_hd256[0]))

    rows, err = [], 0.0
    cases = [(c, torch.bfloat16) for c in SSD_MAIN] + \
        [(c, dt) for c in SSD_SWEEP for dt in (torch.float32,
                                                torch.bfloat16)]
    for (B, S, H, P, N, chunk), dt in cases:
        u = (torch.randn(B, S, H, P, generator=gen, device=dev) * 0.5).to(dt)
        dlog = -torch.randn(B, S, H, generator=gen, device=dev).abs() * 0.1
        Bm, Cm = ((torch.randn(B, S, N, generator=gen, device=dev) * 0.3)
                  .to(dt) for _ in "BC")
        label = f"ssd_scan {(B, S, H, P, N, chunk)} {dt}"
        got = _same_bits(label, lambda: ssd_kernel.ssd_scan(u, dlog, Bm, Cm,
                                                           chunk))
        want = ssd_ref.ssd_ref(u.float(), dlog, Bm.float(), Cm.float(),
                               chunk)
        err = max(err, _agree(label, got, want, _ssd_atol(dt, S)))
        if (B, S, H, P, N, chunk) not in SSD_MAIN:
            continue
        reps = 3 if S > 1024 else 20
        ms = cuda_ms(lambda: ssd_kernel.ssd_scan(u, dlog, Bm, Cm, chunk),
                     reps)
        plain = cuda_ms(lambda: ssd_ref.ssd_ref(u, dlog, Bm, Cm, chunk),
                        reps)
        if S <= 1024:   # launch-bound: the device's share, without the host
            dev_ms = graph_ms(lambda: ssd_kernel.ssd_scan(u, dlog, Bm, Cm,
                                                         chunk))
            print(f"ssd_scan B={B} S={S} device time per call (CUDA graph "
                  f"of 50): {dev_ms * 1e3:.2f} us")
        flops = 2 * _ssd_macs(B, S, H, P, N, chunk)
        nbytes = 2 * 2 * B * S * H * P + 4 * B * S * H + 2 * 2 * B * S * N
        t_bytes, t_ops = bound_ms(nbytes, flops, BF16_FLOPS_PER_S)
        t_f32 = bound_ms(0, flops)[1]
        rows.append(((B, S, H, P, N, chunk), ms, plain, None, t_bytes,
                     t_ops))
        print(f"ssd_scan B={B} S={S} H={H} P={P} N={N} chunk={chunk} bf16: "
              f"{ms:.4f} ms ({_rate(flops, ms)}, "
              f"{max(t_bytes, t_ops) / ms:.1%} of the bound, "
              f"{max(t_bytes, t_f32) / ms:.1%} of the f32 one), plain "
              f"{plain:.3f} ms, no library call, bound "
              f"{max(t_bytes, t_ops):.4f} ms (bytes {t_bytes:.4f}, bf16 "
              f"operations {t_ops:.4f}; f32 operations {t_f32:.4f})")
    out["ssd_scan"] = dict(
        name="ssd_scan", route="cuda", source="src/repro_torch/csrc/ssd.cu",
        replaces="src/repro/kernels/ssd/kernel.py:68", max_abs_err=err,
        **_row(rows[0]))
    return out


def _ssd_macs(B: int, S: int, H: int, P: int, N: int, chunk: int) -> int:
    """Multiply-adds the SSD scan's output needs, in chunks of Q = min(chunk,
    S): per chunk and batch row the causal scores C B^T (Q (Q + 1) / 2 N)
    and per head the intra term (Q (Q + 1) / 2 P); the inter term (Q N P a
    head) after the first chunk and the state each chunk adds (Q N P) before
    the last: y reads no other."""
    Q = min(chunk, S)
    chunks = -(-S // Q)
    tri = Q * (Q + 1) // 2
    return B * (chunks * (tri * N + H * tri * P)
                + 2 * (chunks - 1) * H * Q * N * P)


def _rate(flops: float, ms: float) -> str:
    return f"{flops / ms / 1e9:.1f} TFLOP/s"


def _mixed_tf32_ms(N: int, d: int, ell: int, r: int) -> float:
    """ms for the mixed Gram's triangle at the fastest rates that meet its
    tolerance, per block of columns: V.V exact on the int8 tensor cores
    (int32 sums), V.A two tf32 products (V is exact in tf32, A is hi + lo),
    A.A three."""
    return 2 * N * d * (ell * (ell + 1) / 2 / INT8_OPS_PER_S
                        + 2 * ell * r / TF32_FLOPS_PER_S
                        + r * (r + 1) / 2 / TF32X3_FLOPS_PER_S) * 1e3


def _tf32x3(f32_ms: float) -> float:
    """An f32 operations bound (ms) taken at the 3xTF32 rate instead."""
    return f32_ms * F32_FLOPS_PER_S / TF32X3_FLOPS_PER_S


def _tf32x3_bound(rows) -> float:
    """The summed bound of f32-operation rows (ms, plain, lib, bytes,
    f32 operations) with the operations taken at the 3xTF32 rate."""
    return sum(max(r[3], _tf32x3(r[4])) for r in rows)


def _apply_flops(N: int, d: int, ell: int, n: int) -> int:
    """The batched apply's operations: U^T G and U P (2 d ell n each), the
    scaling by c and base G plus the sum."""
    return N * (4 * d * ell * n + 2 * d * n + ell * n)


def _apply_row(label: str, ms: float, plain: float, lib: float,
               nbytes: float, N: int, d: int, ell: int, n: int):
    """(the JSON's row, the f32-FFMA bound) of one timed apply call, its
    line printed: csrc/lowrank.cu multiplies in 3xTF32, so its bound takes
    the operations at that rate (the bytes bound it there); the f32-FFMA
    bound, its old unit's, is printed beside it."""
    flops = _apply_flops(N, d, ell, n)
    t_bytes, t_f32 = bound_ms(nbytes, flops)
    t_tf32 = _tf32x3(t_f32)
    print(f"{label}: {ms:.4f} ms ({_rate(flops, ms)}, "
          f"{max(t_bytes, t_tf32) / ms:.1%} of the bound, "
          f"{max(t_bytes, t_f32) / ms:.1%} of the f32 one), plain "
          f"{plain:.4f} ms, bmm+baddbmm {lib:.4f} ms, bound "
          f"{max(t_bytes, t_tf32):.4f} ms (bytes {t_bytes:.4f}, 3xTF32 "
          f"operations {t_tf32:.4f}; f32 operations {t_f32:.4f})")
    return (ms, plain, lib, t_bytes, t_tf32), max(t_bytes, t_f32)


def _step_line(name: str, rows, f32_bounds: list, shapes) -> None:
    """One step's summed time of an apply row: its rate, its share of the
    bound (the JSON's: bytes) and of the f32-FFMA one, and its factor
    against the library call."""
    sums = _sums(rows)
    f32 = sum(f32_bounds)
    flops = sum(_apply_flops(*s) for s in shapes)
    print(f"{name}, one step ({len(rows)} calls): {sums['ms']:.4f} ms "
          f"({_rate(flops, sums['ms'])}, {sums['bound_ms'] / sums['ms']:.1%} "
          f"of its bound {sums['bound_ms']:.4f} ms ({sums['bound_by']}), "
          f"{f32 / sums['ms']:.1%} of its f32-FFMA bound {f32:.4f} ms), "
          f"bmm+baddbmm {sums['library_ms']:.4f} ms; kernel / library "
          f"{sums['ms'] / sums['library_ms']:.2f}")


def _refresh_line(name: str, sums: dict, f32_bounds: list, flops: float,
                  library: str) -> None:
    """One refresh's summed time of a Gram row: its rate on the triangle's
    operations, its share of the 3xTF32 bound (the JSON's) and of the f32
    one, and its factor against the library call."""
    f32 = sum(f32_bounds)
    print(f"{name}, one refresh ({len(f32_bounds)} calls): "
          f"{sums['ms']:.4f} ms ({_rate(flops, sums['ms'])}, "
          f"{sums['bound_ms'] / sums['ms']:.1%} of its 3xTF32 bound "
          f"{sums['bound_ms']:.4f} ms, {f32 / sums['ms']:.1%} of its f32 "
          f"bound {f32:.4f} ms), {library} {sums['library_ms']:.4f} ms; "
          f"kernel / library {sums['ms'] / sums['library_ms']:.2f}")


def _row(row) -> dict:
    """The JSON numbers of one timed call."""
    _, ms, plain, lib, t_bytes, t_ops = row
    return dict(ms=ms, plain_ms=plain, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations",
                library_ms=lib)


def _int8(shape, gen, dev) -> torch.Tensor:
    return torch.randint(-127, 128, shape, generator=gen, device=dev,
                         dtype=torch.int8)


def phase_int8_kernels(dev, gen, refresh_main, apply_main) -> dict:
    """Phase 2's rows of the kernels of the fused int8 path."""
    ragged = [(3, 20, 12, 5), (4, 70, 12, 1), (5, 100, 30, 2)]
    out = {}

    rows, err, f32_rows = [], 0.0, []
    # (N, d, ell, r, mean of A's entries), as the f32 Gram's rows
    for N, d, ell, r, mean in [(*s, 0.0) for s in refresh_main + ragged] + [
            (8, 1024, 64, 768, 3.0)]:
        vq = _int8((N, d, ell), gen, dev)
        colw = torch.rand(N, ell, generator=gen, device=dev) / 127
        a = torch.randn(N, d, r, generator=gen, device=dev) + mean
        if (N, d, ell, r) == refresh_main[0]:
            got = _same_bits(f"batched_gram_mixed {(N, d, ell, r)}",
                             lambda: gram_kernel.batched_gram_mixed(vq, colw,
                                                                    a))
        else:
            got = gram_kernel.batched_gram_mixed(vq, colw, a)
            torch.cuda.synchronize()
        err = max(err, check(f"batched_gram_mixed {(N, d, ell, r)} mean "
                             f"{mean}", got,
                             gram_ref.batched_gram_mixed_ref(vq, colw, a), d))
        if (N, d, ell, r) not in refresh_main:
            continue
        m = torch.cat([vq.float() * colw[:, None, :], a], dim=2)
        ms = cuda_ms(lambda: gram_kernel.batched_gram_mixed(vq, colw, a), 3)
        plain = cuda_ms(
            lambda: gram_ref.batched_gram_mixed_ref(vq, colw, a), 3)
        lib = cuda_ms(lambda: torch.bmm(m.mT, m), 3)
        k = ell + r
        # the triangle's multiply-adds, and the weights' two multiplies an
        # output in f32
        flops = N * d * k * (k + 1)
        t_bytes = bound_ms(N * d * ell + 4 * (N * d * r + N * ell
                                              + N * k * k), 0)[0]
        t_weights = 2 * N * k * k / F32_FLOPS_PER_S * 1e3
        t_f32 = flops / F32_FLOPS_PER_S * 1e3 + t_weights
        t_tf32 = _mixed_tf32_ms(N, d, ell, r) + t_weights
        rows.append((ms, plain, lib, t_bytes, t_tf32))
        f32_rows.append(max(t_bytes, t_f32))
        print(f"batched_gram_mixed N={N} d={d} ell={ell} r={r}: {ms:.4f} ms "
              f"({_rate(flops, ms)}, {max(t_bytes, t_tf32) / ms:.1%} of the "
              f"3xTF32 bound, {max(t_bytes, t_f32) / ms:.1%} of the f32 "
              f"one), plain {plain:.4f} ms, bmm {lib:.4f} ms "
              f"({_rate(flops, lib)}), bound {max(t_bytes, t_tf32):.4f} ms "
              f"(bytes {t_bytes:.4f}, 3xTF32 operations {t_tf32:.4f}; f32 "
              f"operations {t_f32:.4f})")
    out["batched_gram_mixed"] = dict(
        name="batched_gram_mixed", route="cuda",
        source="src/repro_torch/csrc/gram.cu",
        replaces="src/repro/kernels/gram/kernel.py:158",
        max_abs_err=err, **_sums(rows))
    _refresh_line("batched_gram_mixed", out["batched_gram_mixed"], f32_rows,
                  sum(N * d * (ell + r) * (ell + r + 1)
                      for N, d, ell, r in refresh_main), "bmm")

    rows, err, flips, entries = [], 0.0, 0, 0
    for N, d, k, r in refresh_main + ragged:
        args = (_int8((N, d, k), gen, dev),
                torch.randn(N, k, k, generator=gen, device=dev) / 127,
                torch.randn(N, d, r, generator=gen, device=dev),
                torch.randn(N, r, k, generator=gen, device=dev))
        got = lowrank_kernel.batched_project_quantize(*args)
        torch.cuda.synchronize()
        try:
            flips += lowrank_ref.project_quantize_differences(got, *args)
        except AssertionError as exc:
            fail(f"batched_project_quantize {(N, d, k, r)}: {exc}")
        entries += got[0].numel()
        # the error of the int8 values, in quantization steps
        want = lowrank_ref.batched_project_quantize_ref(*args)
        err = max(err, float((got[0].int() - want[0].int()).abs().max()))
        if (N, d, k, r) not in refresh_main:
            continue
        vqf, w_top, a, w_bot = args[0].float(), *args[1:]
        ms = cuda_ms(lambda: lowrank_kernel.batched_project_quantize(*args),
                     10)
        plain = cuda_ms(
            lambda: lowrank_ref.batched_project_quantize_ref(*args), 10)
        lib = cuda_ms(lambda: torch.baddbmm(torch.bmm(a, w_bot), vqf, w_top),
                      10)
        t_bytes, t_ops = bound_ms(
            N * d * k + 4 * (N * k * k + N * d * r + N * r * k + N)
            + N * d * k, 2 * N * d * k * (k + r) + 2 * N * d * k)
        rows.append((ms, plain, lib, t_bytes, t_ops))
        flops = 2 * N * d * k * (k + r)
        print(f"batched_project_quantize N={N} d={d} k={k} r={r}: {ms:.4f} "
              f"ms ({_rate(flops, ms)}, {max(t_bytes, t_ops) / ms:.1%} of "
              f"bound), plain {plain:.4f} ms, bmm+baddbmm {lib:.4f} ms "
              f"({_rate(flops, lib)}), bound {max(t_bytes, t_ops):.4f} ms "
              f"(bytes {t_bytes:.4f}, operations {t_ops:.4f}; at 3xTF32 "
              f"{_tf32x3(t_ops):.4f})")
    print(f"batched_project_quantize: {flips} of {entries} int8 values "
          f"differ by 1 from the plain version, each at a .5 boundary")
    sums = _sums(rows)
    flops = sum(2 * N * d * k * (k + r) for N, d, k, r in refresh_main)
    print(f"batched_project_quantize, one refresh ({len(rows)} calls): "
          f"{sums['ms']:.4f} ms ({_rate(flops, sums['ms'])}, "
          f"{sums['bound_ms'] / sums['ms']:.1%} of bound), bmm+baddbmm "
          f"{sums['library_ms']:.4f} ms, bound {sums['bound_ms']:.4f} ms "
          f"({_tf32x3_bound(rows):.4f} ms at 3xTF32); kernel / library "
          f"{sums['ms'] / sums['library_ms']:.2f}")
    out["batched_project_quantize"] = dict(
        name="batched_project_quantize", route="cuda",
        source="src/repro_torch/csrc/project_quantize.cu",
        replaces="src/repro/kernels/lowrank/kernel.py:171",
        max_abs_err=err, **_sums(rows))

    rows, err, f32_rows = [], 0.0, []
    for N, d, ell, n, mean in [(*s, 0.0) for s in apply_main + [
            (3, 24, 6, 10), (7, 123, 17, 50), (2, 300, 130, 70)]] + [
            (*apply_main[0], 3.0)]:
        vq = _int8((N, d, ell), gen, dev)
        scale = torch.rand(N, 1, 1, generator=gen, device=dev) / 127
        g = torch.randn(N, d, n, generator=gen, device=dev) + mean
        c = torch.rand(N, ell, generator=gen, device=dev)
        b = torch.rand(N, generator=gen, device=dev)
        args = (vq, scale, c, b, g)
        label = f"batched_lowrank_apply int8 {(N, d, ell, n)} mean {mean}"
        if (N, d, ell, n, mean) == (*apply_main[0], 0.0):
            got = _same_bits(label, lambda: (
                kernel_registry.batched_lowrank_apply_quantized(*args)))
        else:
            got = kernel_registry.batched_lowrank_apply_quantized(*args)
            torch.cuda.synchronize()
        err = max(err, check(
            label, got,
            lowrank_ref.batched_lowrank_apply_quantized_ref(*args), d))
        if (N, d, ell, n) not in apply_main or mean != 0.0:
            continue
        u = vq.float() * scale
        ms = cuda_ms(
            lambda: kernel_registry.batched_lowrank_apply_quantized(*args), 5)
        plain = cuda_ms(
            lambda: lowrank_ref.batched_lowrank_apply_quantized_ref(*args), 5)
        lib = cuda_ms(lambda: torch.baddbmm(
            g * b[:, None, None], u, c[:, :, None] * torch.bmm(u.mT, g)), 5)
        row, f32_bound = _apply_row(
            f"batched_lowrank_apply int8 N={N} d={d} ell={ell} n={n}", ms,
            plain, lib, N * d * ell + 4 * (N * ell + 2 * N + 2 * N * d * n),
            N, d, ell, n)
        rows.append(row)
        f32_rows.append(f32_bound)
    out["batched_lowrank_apply_int8"] = dict(
        name="batched_lowrank_apply_int8", route="cuda",
        source="src/repro_torch/csrc/lowrank.cu",
        replaces="src/repro/kernels/lowrank/kernel.py:97 (int8 U, "
                 "src/repro/kernels/registry.py:133)",
        max_abs_err=err, **_sums(rows))
    _step_line("batched_lowrank_apply int8", rows, f32_rows, apply_main)
    return out


def _sums(rows) -> dict:
    """Times of the main path's calls summed: one refresh for the Grams and
    the write-back, one step for the applies.  The bound is the sum of each
    call's bound; it is named by whichever of bytes and operations takes
    longer in total."""
    ms, plain, lib, t_bytes, t_ops = (sum(col) for col in zip(*rows))
    return dict(ms=ms, plain_ms=plain,
                bound_ms=sum(max(r[3], r[4]) for r in rows),
                bound_by="bytes" if t_bytes > t_ops else "operations",
                library_ms=lib)


def merge_gram_shapes() -> list:
    """(N, d, k) of the butterfly merge's Grams (phase 4s), per pool group
    and side: ``M = [Ba, Bb]``, each side's factor ``ell - 1`` columns (the
    deflated one stays off the wire), so k = 2 (ell - 1), at least ell."""
    return [(N, d, max(2 * (ell - 1), ell))
            for N, d, ell, _ in main_path_shapes()[0]]


def shrink_merge_gram_shapes() -> list:
    """(N, d, k) of the shrink merge's Grams (phase 4d,
    ``merge_sketches_on_shrink``): the exact merge of two stacks takes both
    whole weighted factors, k = 2 ell."""
    return [(N, d, 2 * ell) for N, d, ell, _ in main_path_shapes()[0]]


def phase_merge_grams(dev, gen, shapes=None, label="butterfly round"
                      ) -> None:
    """Kernel 1 at the merge shapes against its plain version (the f32
    tolerance), timed beside the plain version and ``bmm``, with its bound
    (bytes, or 3xTF32 operations); one round's calls summed (a refresh at
    P 4 runs two butterfly rounds; a shrink of 4 stacks to one, three
    rounds of merges)."""
    rows = []
    for N, d, k in shapes or merge_gram_shapes():
        a = torch.randn(N, d, k, generator=gen, device=dev)
        got = gram_kernel.batched_gram(a)
        torch.cuda.synchronize()
        err = check(f"batched_gram merge {(N, d, k)}", got,
                    gram_ref.batched_gram_ref(a), d)
        ms = cuda_ms(lambda: gram_kernel.batched_gram(a), 3)
        plain = cuda_ms(lambda: gram_ref.batched_gram_ref(a), 3)
        lib = cuda_ms(lambda: torch.bmm(a.mT, a), 3)
        flops = N * d * k * (k + 1)
        t_bytes = bound_ms(4 * (N * d * k + N * k * k), 0)[0]
        t_ops = flops / TF32X3_FLOPS_PER_S * 1e3
        rows.append((ms, plain, lib, t_bytes, t_ops))
        print(f"batched_gram merge N={N} d={d} k={k}: {ms:.4f} ms "
              f"({max(t_bytes, t_ops) / ms:.1%} of the bound "
              f"{max(t_bytes, t_ops):.4f} ms), plain {plain:.4f} ms, bmm "
              f"{lib:.4f} ms, max abs err {err:.3e}")
    s = _sums(rows)
    print(f"batched_gram merge, one {label} ({len(rows)} calls): "
          f"{s['ms']:.4f} ms, plain {s['plain_ms']:.4f} ms, bmm "
          f"{s['library_ms']:.4f} ms, bound {s['bound_ms']:.4f} ms (by "
          f"{s['bound_by']})")


def phase_eigh(dev) -> float:
    """Seconds of ``torch.linalg.eigh`` over one refresh's Grams."""
    gen = torch.Generator(device=dev).manual_seed(1)
    grams = []
    for N, d, ell, r in main_path_shapes()[0]:
        m = torch.randn(N, d, ell + r, generator=gen, device=dev)
        grams.append(gram_ref.batched_gram_ref(m))
    torch.linalg.eigh(grams[1][:1])
    torch.cuda.synchronize()
    total = 0.0
    for c in grams:
        t0 = time.perf_counter()
        torch.linalg.eigh(c)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        total += dt
        print(f"eigh {c.shape[0]} x {c.shape[1]}x{c.shape[2]}: {dt:.3f} s")
    n = sum(c.shape[0] for c in grams)
    print(f"eigh over one refresh ({n} matrices): {total:.3f} s")
    return total


def shampoo_gram_calls() -> list:
    """(N, d, k) of kernel 1's calls in one Shampoo step at full width, from
    the port's pool index: per group the Gram of G^T (L's increment, (N,
    bs_n, bs_m)) and of G (R's, (N, bs_m, bs_n)); 8 calls, 7 shapes."""
    cfg = registry.get_config("paper-lm-100m")
    shapes = [tuple(s) for s in tree.flatten(model_lib.param_shapes(cfg))]
    return [c for g in pool.build_index(tuple(shapes), BLOCK).groups
            for c in ((g.num_blocks, g.bs_n, g.bs_m),
                      (g.num_blocks, g.bs_m, g.bs_n))]


def phase_shampoo_grams(dev, gen) -> None:
    """Kernel 1 at every shape Shampoo's statistics give it at full width,
    on data of mean 3, against its plain version at the f32 tolerance;
    timed beside the plain version, ``bmm(A^T, A)`` and the bound (as
    kernel 1's Sketchy rows), summed over one step's 8 calls.  Then the copy
    that makes G^T contiguous for L's Gram, per group, against its bytes."""
    calls = shampoo_gram_calls()
    sums, err = dict(ms=0.0, plain=0.0, lib=0.0, bound=0.0, flops=0.0), 0.0
    timed = {}
    for N, d, k in calls:
        if (N, d, k) not in timed:
            a = torch.randn(N, d, k, generator=gen, device=dev) + 3.0
            got = gram_kernel.batched_gram(a)
            torch.cuda.synchronize()
            err = max(err, check(f"batched_gram (Shampoo) {(N, d, k)} mean 3",
                                 got, gram_ref.batched_gram_ref(a), d))
            ms = cuda_ms(lambda: gram_kernel.batched_gram(a), 3)
            plain = cuda_ms(lambda: gram_ref.batched_gram_ref(a), 3)
            lib = cuda_ms(lambda: torch.bmm(a.mT, a), 3)
            flops = N * d * k * (k + 1)
            t_bytes = bound_ms(4 * (N * d * k + N * k * k), 0)[0]
            t_ops = flops / TF32X3_FLOPS_PER_S * 1e3
            timed[(N, d, k)] = (ms, plain, lib, max(t_bytes, t_ops), flops)
            del a, got
            print(f"batched_gram (Shampoo) N={N} d={d} k={k}: {ms:.4f} ms "
                  f"({_rate(flops, ms)}, {max(t_bytes, t_ops) / ms:.1%} of "
                  f"the 3xTF32 bound), plain {plain:.4f} ms, bmm {lib:.4f} "
                  f"ms, bound {max(t_bytes, t_ops):.4f} ms (bytes "
                  f"{t_bytes:.4f}, 3xTF32 operations {t_ops:.4f})")
        for key, v in zip(("ms", "plain", "lib", "bound", "flops"),
                          timed[(N, d, k)]):
            sums[key] += v
    print(f"batched_gram (Shampoo), one step ({len(calls)} calls): "
          f"{sums['ms']:.4f} ms ({_rate(sums['flops'], sums['ms'])}, "
          f"{sums['bound'] / sums['ms']:.1%} of its 3xTF32 bound "
          f"{sums['bound']:.4f} ms), plain {sums['plain']:.4f} ms, bmm "
          f"{sums['lib']:.4f} ms; kernel / library "
          f"{sums['ms'] / sums['lib']:.2f}; max abs diff {err:.3e}")
    total, total_bound = 0.0, 0.0
    for N, d, k in calls[1::2]:                 # each group's G
        g = torch.randn(N, d, k, generator=gen, device=dev)
        ms = cuda_ms(lambda: g.mT.contiguous(), 5)
        t_bytes = bound_ms(2 * 4 * N * d * k, 0)[0]
        total, total_bound = total + ms, total_bound + t_bytes
        print(f"G^T copy N={N} {d}x{k}: {ms:.4f} ms (bytes bound "
              f"{t_bytes:.4f} ms)")
        del g
    print(f"G^T copies, one Shampoo step: {total:.4f} ms (bytes bound "
          f"{total_bound:.4f} ms)")


def phase_shampoo_eigh(dev) -> None:
    """One Shampoo root refresh at full width: ``eigh`` alone and the whole
    inverse 4th root (core/shampoo.py::_inv_root: symmetrize, eigh, V
    lam^-1/4 V^T) over every group's L and R stack, each the EMA-free
    statistic of one gradient (rank-deficient where the block is not
    square, as after the first step)."""
    from repro_torch.core import fd, shampoo
    gen = torch.Generator(device=dev).manual_seed(2)
    stacks = []
    for N, d, k in shampoo_gram_calls():
        g = torch.randn(N, d, k, generator=gen, device=dev)
        stacks.append(gram_ref.batched_gram_ref(g))
        del g
    fd._eigh(stacks[0][:1])
    torch.cuda.synchronize()
    eigh_s = root_s = 0.0
    for m in stacks:
        t0 = time.perf_counter()
        fd._eigh(m)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        shampoo._inv_root(m, shampoo.MATRIX_EPS, -0.25)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        eigh_s, root_s = eigh_s + t1 - t0, root_s + t2 - t1
        print(f"Shampoo root {m.shape[0]} x {m.shape[1]}^2: eigh "
              f"{t1 - t0:.3f} s, inverse root {t2 - t1:.3f} s")
    sizes = {}
    for m in stacks:
        sizes[m.shape[1]] = sizes.get(m.shape[1], 0) + m.shape[0]
    print(f"Shampoo root refresh ({sizes} matrices by size): eigh "
          f"{eigh_s:.3f} s of {root_s:.3f} s ({eigh_s / root_s:.1%})")


# launch counter -> (wrapper module, attribute)
COUNTERS = kernel_registry.LAUNCH_COUNTERS


def per_gradient(cfg) -> dict:
    """Launches of kernels 7 and 8 in one serving feedback gradient of
    ``cfg``: one per attention (each dense or moe layer, or each site of
    the hybrid family's shared block) and one per mamba layer in the
    forward,
    and as many again in the backward's recompute when ``cfg.remat`` is on
    and the gradient flows back through the layers, which it does when the
    adapted leaf is the tied embedding (an untied head's gradient stops at
    the head)."""
    passes = 2 if cfg.remat and cfg.tie_embeddings else 1
    if cfg.family in model_lib.ATTENTION_STACKS:
        return dict(flash_attention=cfg.num_layers * passes, ssd_scan=0)
    return dict(flash_attention=len(cfg.shared_attn_layers()) * passes,
                ssd_scan=cfg.num_layers * passes)


_zero_counts = kernel_registry.zero_launch_counts
_counts = kernel_registry.launch_counts


def phase_main_path(dev, argv: list, expected: dict,
                    second_moment_bytes=None, check_state=None,
                    save_to=None) -> dict:
    """Train with ``argv`` with every launch count set to 0 just before and
    read just after; ``expected`` gives each count's value.  Also counts
    the matrices ``eigh`` takes in each step (the FD refresh's and
    Shampoo's roots); ``check_state(opt_state)`` checks the final state;
    ``save_to`` (a path) keeps ``(params, opt_state)`` there.  Returns the
    launch counts, with the peak memory under "peak"."""
    eighs = []
    step, eigh = train_lib.Run.step, fd_lib._eigh

    def counted_step(self, i):
        eighs.append(0)
        return step(self, i)

    def counted_eigh(C):
        eighs[-1] += C.shape[0]
        return eigh(C)

    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    with mock.patch.object(train_lib.Run, "step", counted_step), \
            mock.patch.object(fd_lib, "_eigh", counted_eigh), \
            mock.patch.object(shampoo_lib, "_eigh", counted_eigh):
        run, log = train_lib.train(train_lib.parse_args(argv))
    launches = _counts()
    peak = torch.cuda.max_memory_allocated(dev)
    nbytes = api.second_moment_bytes(run.opt_state)
    if check_state is not None:
        check_state(run.opt_state)
    if save_to is not None:
        os.makedirs(os.path.dirname(save_to), exist_ok=True)
        torch.save((run.params, run.opt_state), save_to)
    del run
    label = " ".join(argv[len(MAIN_PATH_ARGV):]) or "fp32"
    losses = [r["loss"] for r in log]
    if not all(math.isfinite(x) for x in losses):
        fail(f"{label}: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        fail(f"{label}: loss did not fall: {losses}")
    if launches != expected:
        fail(f"{label}: main path launches {launches}, expected {expected}")
    if second_moment_bytes is not None and nbytes != second_moment_bytes:
        fail(f"{label}: second-moment bytes {nbytes}, expected "
             f"{second_moment_bytes}")
    times = [r["time_s"] for r in log]
    print(f"main path ({label}) step times (s): {times}")
    print(f"main path ({label}) peak memory allocated: {peak} bytes")
    print(f"main path ({label}) second-moment bytes: {nbytes}")
    print(f"main path ({label}) launches: {launches}")
    print(f"main path ({label}) eigh matrices per step: {eighs}")
    return dict(launches, peak=peak)


SHARDED_DIR = os.path.join(ROOT, "build", "sharded")
SHARDED_TIMEOUT_S = 480
# kernel 1 per rank in phase 4s: 2 refreshes x (8 local Grams + 4 groups x
# 2 sides x log2(4) rounds of merge Grams)
SHARDED_GRAMS = 2 * (8 + 16)


def _rank_env() -> dict:
    """The environment of the ranks this script starts: the checkout's
    sources on the path; gloo on the loopback device unless told another;
    two CPU threads a rank (8 cores, 4 ranks)."""
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
                GLOO_SOCKET_IFNAME=os.environ.get("GLOO_SOCKET_IFNAME", "lo"),
                OMP_NUM_THREADS="2")


def _run_group(cmds: list, timeout: float) -> list:
    """Run the commands at once, each in a process group of its own, and
    wait at most ``timeout`` s in all; every process they started is
    killed at the end, whatever happened.  Returns (exit code, output) of
    each."""
    procs = [subprocess.Popen(cmd, env=_rank_env(), cwd=ROOT, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT,
                              start_new_session=True) for cmd in cmds]
    deadline = time.perf_counter() + timeout
    outs = []
    try:
        for proc in procs:
            try:
                outs.append(proc.communicate(
                    timeout=max(deadline - time.perf_counter(), 1))[0])
            except subprocess.TimeoutExpired:
                fail(f"{proc.args} did not end within {timeout} s")
    finally:
        for proc in procs:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    return [(proc.returncode, out) for proc, out in zip(procs, outs)]


def phase_sharded(dev) -> dict:
    """Phase 4s: ``python -m torch.distributed.run --standalone
    --nproc-per-node 4 -m repro_torch.launch.train`` with MAIN_PATH_ARGV and
    ``--stats-reduction sharded``: 4 ranks on the one card over gloo (the
    wire through pinned host buffers), each reporting its launches (set to
    0 as its run starts), merge rounds, step times, peak memory and state
    digests (``--rank-report``).  Per rank: kernel 1 SHARDED_GRAMS, kernel
    2 96, kernel 7 288 launches and no other kernel; losses finite and
    falling; SHARDED_WIRE_BYTES sent at each refresh (steps 0 and 10) in 16
    rounds; and the parameters, the sketches and the whole optimizer state
    the same bits on every rank.  Returns rank 0's launch counts."""
    torch.cuda.empty_cache()
    shutil.rmtree(SHARDED_DIR, ignore_errors=True)
    argv = MAIN_PATH_ARGV + SHARDED_ARGV + ["--rank-report", SHARDED_DIR]
    t0 = time.perf_counter()
    [(rc, out)] = _run_group([[
        sys.executable, "-m", "torch.distributed.run", "--standalone",
        "--nproc-per-node", str(SHARDED_RANKS), "-m",
        "repro_torch.launch.train", *argv]], SHARDED_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if rc != 0:
        fail(f"sharded run exited {rc}:\n{out[-6000:]}")
    for line in out.splitlines():
        if line.startswith(("sharded", "arch=", "step", "straggler")):
            print(f"sharded: {line}")
    reports = [json.load(open(os.path.join(SHARDED_DIR, f"rank-{r}.json")))
               for r in range(SHARDED_RANKS)]
    expected = dict(dict.fromkeys(COUNTERS, 0), batched_gram=SHARDED_GRAMS,
                    batched_lowrank_apply=96,
                    flash_attention=12 * TRAIN_FLASH_PER_STEP)
    for rep in reports:
        r, steps = rep["rank"], rep["steps"]
        if rep["device"] != f"cuda:{dev.index or 0}":
            fail(f"sharded rank {r} ran on {rep['device']}")
        if rep["launches"] != expected:
            fail(f"sharded rank {r}: launches {rep['launches']}, expected "
                 f"{expected}")
        losses = [st["loss"] for st in steps]
        if not all(math.isfinite(x) for x in losses) \
                or not losses[-1] < losses[0]:
            fail(f"sharded rank {r}: losses {losses}")
        for st in steps:
            st["rounds"] = [x for x in st["exchanges"]
                            if x["kind"] == "round"]
            st["means"] = [x for x in st["exchanges"] if x["kind"] == "mean"]
        merged = [st for st in steps if st["rounds"]]
        if [st["step"] for st in merged] != [0, 10]:
            fail(f"sharded rank {r} merged at steps "
                 f"{[st['step'] for st in merged]}")
        for st in merged:
            sent = sum(x["bytes"] for x in st["rounds"])
            print(f"sharded rank {r} step {st['step']}: {sent} B sent in "
                  f"{len(st['rounds'])} rounds (reference "
                  f"{SHARDED_WIRE_BYTES}), the rounds "
                  f"{sum(x['round_s'] for x in st['rounds']):.3f} s")
            if sent != SHARDED_WIRE_BYTES or len(st["rounds"]) != 16:
                fail(f"sharded rank {r}: {sent} B in {len(st['rounds'])} "
                     f"rounds at step {st['step']}")
        times = [st["time_s"] for st in steps]
        means = [round(sum(x["round_s"] for x in st["means"]), 4)
                 for st in steps]
        print(f"sharded rank {r}: step times (s) {times}; refresh steps "
              f"{[times[st['step']] for st in merged]}, plain median "
              f"{statistics.median(times[1:10]):.4f}; the means (gradients, "
              f"loss, diagonal squares through the host) per step (s) "
              f"{means}; peak memory allocated {rep['peak_bytes']} B")
    for key in ("params_sha256", "second_moment_sha256",
                "opt_state_sha256"):
        digests = {rep[key] for rep in reports}
        print(f"sharded: {key} of the {SHARDED_RANKS} ranks: {digests}")
        if len(digests) != 1:
            fail(f"sharded: the ranks' {key} differ")
    for st in (st for st in reports[0]["steps"] if st["rounds"]):
        for i, x in enumerate(st["rounds"]):
            print(f"sharded rank 0 step {st['step']} round {i} (distance "
                  f"{x['dist']}): {x['bytes']} B, exchange with its host "
                  f"copies {x['exchange_s'] * 1e3:.2f} ms, round "
                  f"{x['round_s'] * 1e3:.2f} ms")
    print(f"sharded: {SHARDED_RANKS} ranks on one card over gloo, "
          f"{wall:.1f} s of wall time for the command (its startup "
          f"included); launches per rank {reports[0]['launches']}")
    return reports[0]["launches"]


SHARDED_REFERENCE_RANKS = 2


def reduced_rank(rank: str, world: str, rendezvous: str, device: str,
                 out: str) -> int:
    """One rank of phase 4s's card-against-CPU check, as ``python3
    chip_smoke.py --reduced-rank RANK WORLD RENDEZVOUS DEVICE OUT``: joins
    a gloo group through the file ``RENDEZVOUS``, trains the reduced model
    from phase 6's weights (REFERENCE_ARGV) with sharded statistics on
    ``DEVICE`` through ``launch.train``, and writes its losses and
    launches to ``OUT``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=int(rank), world_size=int(world))
    try:
        cfg = registry.get_reduced("paper-lm-100m")
        params = model_lib.init_params(cfg, torch.Generator().manual_seed(0))
        start = tree.unflatten(params, [p.to(device)
                                        for p in tree.flatten(params)])
        _zero_counts()
        run, log = train_lib.train(train_lib.parse_args(
            REFERENCE_ARGV + SHARDED_ARGV + ["--device", device]), start)
        with open(out, "w") as f:
            json.dump(dict(losses=[r["loss"] for r in log],
                           launches=_counts(), device=str(run.device)), f)
    finally:
        dist.destroy_process_group()
    return 0


def phase_sharded_reference(dev) -> None:
    """The reduced model with sharded statistics at P 2 on the card and at P
    2 on the CPU, from the same weights (both groups at once): the same
    losses within phase 6's tolerance, the same on both ranks of each."""
    os.makedirs(SHARDED_DIR, exist_ok=True)
    cmds, outs = [], {}
    for device in (f"cuda:{dev.index or 0}", "cpu"):
        rdzv = os.path.join(SHARDED_DIR, f"rendezvous-{device[:4]}")
        with contextlib.suppress(FileNotFoundError):
            os.remove(rdzv)
        for r in range(SHARDED_REFERENCE_RANKS):
            out = os.path.join(SHARDED_DIR, f"reduced-{device[:4]}-{r}.json")
            outs[(device[:4], r)] = out
            cmds.append([sys.executable, os.path.abspath(__file__),
                         "--reduced-rank", str(r),
                         str(SHARDED_REFERENCE_RANKS), rdzv, device, out])
    for (rc, out), cmd in zip(_run_group(cmds, 300), cmds):
        if rc != 0:
            fail(f"sharded reference rank {cmd[3:]} exited {rc}:\n"
                 f"{out[-4000:]}")
    got = {key: json.load(open(path)) for key, path in outs.items()}
    losses = {}
    for (device, r), rep in got.items():
        if not rep["device"].startswith(device):
            fail(f"sharded reference: a {device} rank ran on "
                 f"{rep['device']}")
        if rep["losses"] != got[(device, 0)]["losses"]:
            fail(f"sharded reference: the {device} ranks' losses differ")
        losses[device] = rep["losses"]
    flash = got[("cuda", 0)]["launches"]["flash_attention"]
    cfg = registry.get_reduced("paper-lm-100m")
    if flash != len(losses["cuda"]) * cfg.num_layers \
            or got[("cuda", 0)]["launches"]["batched_gram"] == 0:
        fail(f"sharded reference: card launches "
             f"{got[('cuda', 0)]['launches']}")
    worst = max(abs(a - b) / abs(b)
                for a, b in zip(losses["cuda"], losses["cpu"]))
    print(f"sharded reference (P {SHARDED_REFERENCE_RANKS}): card losses "
          f"{losses['cuda']}, CPU losses {losses['cpu']}, max rel diff "
          f"{worst:.2e}; card rank 0 launches {got[('cuda', 0)]['launches']}")
    if worst > 1e-3:
        fail("card and CPU sharded runs of the reduced model disagree")


# phase 4d: four ranks of this script's own --mesh-rank mode on the one
# card over gloo (the collectives through pinned host buffers)
MESH_RANKS = 4
MESH_DIR = os.path.join(ROOT, "build", "mesh")
MESH_TIMEOUT_S = 300
# the full-width Sketchy state placed on the meshes: phase 4's fp32 run
# after its 12 steps (refreshes at 0 and 10), saved by that phase
MESH_STATE = os.path.join(MESH_DIR, "state.pt")
# remesh_opt_state's plans (devices, model_parallel, target_global_batch):
# the 2 x 2 mesh of 4 ranks, then the 1 x 2 mesh of the shrink to 2
MESH_PLANS = [(4, 2, 8), (2, 2, 8)]
# expert parallelism: deepseek-moe-16b at full width with 4 of its 28
# layers (the dense layer 0 and 3 moe layers; only the depth is cut), B 4,
# S 512, on a (data 1, model 4) mesh: 16 of the 64 experts a rank
EP_ARCH, EP_LAYERS = "deepseek-moe-16b", 4
EP_BATCH, EP_SEQ = DENSE_FULL_BATCH, DENSE_FULL_SEQ
EP_MESH = (1, MESH_RANKS)
# pipeline parallelism (train/pipeline_parallel.py): full-width
# paper-lm-100m's 12 layers as MESH_RANKS stages of 3, the dense block of
# models/model.py, phase 4's batch 0 (8 x 128) in PIPE_MICROBATCHES
PIPE_MICROBATCHES = 4


_digest = train_lib._digest


def _block_rows(N: int, coord, shape) -> tuple[int, int]:
    """The blocks [lo, hi) of a pooled stack of N blocks that the reference's
    ``blocks_sharding`` gives mesh position ``coord`` = (data, model) of a
    (data, model) mesh of ``shape``: the leading dim tiled model-major over
    ('model', 'data') when their product divides N, else over 'data'
    alone, else whole."""
    (nd, nm), (d, m) = shape, coord
    if N % (nd * nm) == 0:
        n, i = N // (nd * nm), m * nd + d
    elif N % nd == 0:
        n, i = N // nd, d
    else:
        return 0, N
    return i * n, (i + 1) * n


def _ce(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``model.loss_fn``'s loss from its logits."""
    logits = logits.float()
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.mean(torch.logsumexp(logits, dim=-1) - gold)


def _mesh_compressed(dev, rank: int, world: int) -> dict:
    """4d, first part: this rank's quarter of the launcher's batch 0 through
    full-width paper-lm-100m (seed 0, as every rank), its gradients'
    ``compressed_mean_grads`` and, beside it, their exact mean; then one
    Sketchy step at the launcher's defaults on the same quarter (a refresh
    at count 0), whose pools (this rank's own sketches) it saves for the
    shrink merge."""
    mesh = mesh_lib.make_host_mesh()
    args = train_lib.parse_args(MAIN_PATH_ARGV + ["--device", str(dev)])
    run = train_lib.start(args)
    rows = args.batch // world
    local = {k: v[rank * rows:(rank + 1) * rows]
             for k, v in run.batch(0).items()}
    leaves = [p.detach().requires_grad_(True)
              for p in tree.flatten(run.params)]
    _zero_counts()
    loss = model_lib.loss_fn(run.cfg, tree.unflatten(run.params, leaves),
                             local)
    grads = list(torch.autograd.grad(loss, leaves))
    grad_launches = _counts()
    del leaves, loss
    torch.cuda.synchronize(dev)
    dreduce.merge_log = []
    t0 = time.perf_counter()
    comp = compression.compressed_mean_grads(grads, mesh, seed=0)
    torch.cuda.synchronize(dev)
    comp_s, comp_log = time.perf_counter() - t0, dreduce.merge_log
    dreduce.merge_log = []
    with dreduce.bind_axis("data", mesh.get_group("data")):
        t0 = time.perf_counter()
        exact = dreduce.pmean(grads, "data")
        torch.cuda.synchronize(dev)
        exact_s, exact_log = time.perf_counter() - t0, dreduce.merge_log
        dreduce.merge_log = None
        absmax = [dreduce.pmax(g.float().abs().amax(), "data") for g in grads]
    worst_rel = worst_step = 0.0
    for c, e, a in zip(comp, exact, absmax):
        c, e = c.float(), e.float()
        diff = (c - e).abs()
        worst_rel = max(worst_rel, float(diff.max() / e.abs().max()))
        # one int8 step, plus each side's rounding to bf16 when cast back
        slack = 2 ** -8 if grads[0].dtype == torch.bfloat16 else 1e-6
        bound = quantize.int8_scale(a) * (1 + slack) + slack * e.abs()
        worst_step = max(worst_step, float((diff / bound).max()))
    elements = sum(g.numel() for g in grads)
    # this rank's own sketches: one Sketchy step on its quarter
    _zero_counts()
    t0 = time.perf_counter()
    run.params, run.opt_state, _ = run.step_fn(run.params, run.opt_state,
                                               local)
    torch.cuda.synchronize(dev)
    step_s, step_launches = time.perf_counter() - t0, _counts()
    torch.save(run.opt_state.inner["precond"].pools,
               os.path.join(MESH_DIR, f"pools-{rank}.pt"))
    out = dict(
        grad_launches=grad_launches, step_launches=step_launches,
        step_s=step_s, leaves=len(grads), elements=elements,
        dtype=str(grads[0].dtype), comp_s=comp_s, exact_s=exact_s,
        comp_bytes=sum(x["bytes"] for x in comp_log),
        comp_kinds=sorted({x["kind"] for x in comp_log}),
        exact_bytes=sum(x["bytes"] for x in exact_log),
        worst_rel=worst_rel, worst_step=worst_step,
        comp_sha256=_digest(comp), exact_sha256=_digest(exact))
    del run, grads, comp, exact
    torch.cuda.empty_cache()
    return out


def _mesh_remesh(dev, rank: int) -> dict:
    """4d, second part: the saved full-width state (every rank the whole
    of it, as a restore gives it) placed by ``remesh_opt_state`` on each of
    MESH_PLANS' meshes (every rank builds each; a rank outside one gets
    none): each pooled stack's local shard against the blocks
    ``_block_rows`` gives this rank's position, bit for bit, and the pooled
    bytes it holds."""
    params, state = torch.load(MESH_STATE, map_location=dev,
                               weights_only=False)
    whole = {leaf.name: leaf.value for leaf in ckpt_lib.leaves(state)
             if "::.pools::" in leaf.name}
    out = {}
    for devices, mp, batch in MESH_PLANS:
        plan = elastic.plan_mesh(devices, model_parallel=mp,
                                 target_global_batch=batch)
        mesh = elastic.remesh(plan)
        if mesh is None:
            out[str(devices)] = None
            continue
        t0 = time.perf_counter()
        _, placed = elastic.remesh_opt_state(state, params, mesh)
        torch.cuda.synchronize(dev)
        seconds = time.perf_counter() - t0
        coord = tuple(mesh.get_coordinate())
        rows, held, wrong = {}, 0, []
        for leaf in ckpt_lib.leaves(placed):
            if leaf.name not in whole:
                continue
            local = leaf.value.to_local()
            lo, hi = _block_rows(whole[leaf.name].shape[0], coord,
                                 plan.mesh_shape)
            if not torch.equal(local, whole[leaf.name][lo:hi]):
                wrong.append(leaf.name)
            rows[leaf.name] = [lo, hi, whole[leaf.name].shape[0]]
            held += local.numel() * local.element_size()
        out[str(devices)] = dict(coord=coord, shape=plan.mesh_shape,
                                 rows=rows, bytes=held, wrong=wrong,
                                 seconds=seconds)
        del placed
    out["whole_bytes"] = sum(t.numel() * t.element_size()
                             for t in whole.values())
    del params, state, whole
    torch.cuda.empty_cache()
    return out


def _ep_model(dev):
    """(config, seeded full-width parameters on the card, batch) of the
    expert-parallel check: EP_ARCH cut to EP_LAYERS layers, the pipeline's
    batch at EP_BATCH x EP_SEQ (seed 1); the same in every process."""
    cfg = dataclasses.replace(registry.get_config(EP_ARCH),
                              num_layers=EP_LAYERS)
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    return cfg, params, _full_batch(cfg, dev, seed=1)


def _ep_run(cfg, params: dict, batch: dict, mesh=None) -> dict:
    """The forward's logits and the gradients of the loss with respect to
    every moe layer's parameters (``use_mesh(mesh)`` when given); per moe
    layer of the forward, its block's input, output and output cotangent,
    the experts each token picked (sorted) and the (token, expert)
    assignments dropped for capacity (read around ``moe.moe_block`` and
    ``moe._slot_tables``; the forward's calls come first, the remat
    recompute's follow); and the collectives the forward logged."""
    n_moe = cfg.num_layers - cfg.first_dense_layers
    moe = params["moe_layers"]
    leaves = [p.detach().requires_grad_(True) for p in tree.flatten(moe)]
    p = dict(params, moe_layers=tree.unflatten(moe, leaves))
    calls, blocks = [], []
    tables, block = moe_lib._slot_tables, moe_lib.moe_block

    def counted(E, k, capacity, gate_w, gate_idx, T):
        got = tables(E, k, capacity, gate_w, gate_idx, T)
        calls.append((torch.sort(gate_idx, dim=-1).values,
                      got[2].eq(E * capacity).sum()))
        return got

    def traced(cfg_, p_, x):
        y = block(cfg_, p_, x)
        if len(blocks) < n_moe:
            blocks.append(dict(x=x.detach().clone(), y=y.detach().clone()))
            if y.requires_grad:
                y.register_hook(lambda g, rec=blocks[-1]: rec.__setitem__(
                    "cot", g.detach().clone()))
        return y

    ctx = rules_lib.use_mesh(mesh) if mesh is not None else \
        contextlib.nullcontext()
    with mock.patch.object(moe_lib, "_slot_tables", counted), \
            mock.patch.object(moe_lib, "moe_block", traced), ctx:
        logits = model_lib.forward(cfg, p, batch)
        records = list(dreduce.merge_log or [])
        grads = torch.autograd.grad(_ce(logits, batch["labels"]), leaves)
    return dict(logits=logits.detach(), grads=tree.unflatten(moe, list(grads)),
                blocks=blocks, gates=[g for g, _ in calls[:n_moe]],
                drops=[int(n) for _, n in calls[:n_moe]],
                forward_records=records)


def _ep_block(cfg, params: dict, layer: int, x: torch.Tensor,
              cot: torch.Tensor) -> dict:
    """One moe layer's block (the single-process path) on ``x`` with the
    whole weights: its output, its dropped assignments, and the gradients
    of its parameters for the output cotangent ``cot``."""
    moe = {k: v for k, v in model_lib.layer(params["moe_layers"],
                                            layer)["moe"].items()}
    leaves = [t.detach().requires_grad_(True) for t in tree.flatten(moe)]
    drops, tables = [], moe_lib._slot_tables

    def counted(E, k, capacity, *rest):
        got = tables(E, k, capacity, *rest)
        drops.append(int(got[2].eq(E * capacity).sum()))
        return got

    with mock.patch.object(moe_lib, "_slot_tables", counted):
        y = moe_lib.moe_block(cfg, tree.unflatten(moe, leaves), x)
    grads = torch.autograd.grad(y, leaves, grad_outputs=cot)
    return dict(y=y.detach(), drops=drops[0],
                grads=dict(zip(rules_lib.tree_paths(moe), grads)))


def _mesh_expert_parallel(dev, rank: int, world: int) -> dict:
    """4d, third part: the expert-parallel forward and gradients (module
    docstring), this rank holding only its experts
    (``convert.expert_parallel_shard``); saves its expert gradients, the
    other moe-layer gradients and (rank 0) the logits and the experts each
    token picked for the parent."""
    mesh = mesh_lib.make_mesh(EP_MESH, ("data", "model"))
    cfg, params, batch = _ep_model(dev)
    params = convert.expert_parallel_shard(params, rank, world)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    dreduce.merge_log = []
    t0 = time.perf_counter()
    got = _ep_run(cfg, params, batch, mesh)
    torch.cuda.synchronize(dev)
    seconds, launches = time.perf_counter() - t0, _counts()
    records, dreduce.merge_log = dreduce.merge_log, None
    peak = torch.cuda.max_memory_allocated(dev)
    flat = dict(zip(rules_lib.tree_paths(got["grads"]), tree.flatten(got["grads"])))
    save = {"experts": {k: v for k, v in flat.items() if "experts" in k},
            "other": {k: v for k, v in flat.items() if "experts" not in k}}
    if rank == 0:
        save.update(logits=got["logits"], gates=got["gates"],
                    blocks=got["blocks"])
    torch.save(save, os.path.join(MESH_DIR, f"ep-{rank}.pt"))
    sums = [x for x in got["forward_records"] if x["kind"] == "sum"]
    return dict(ep_launches=launches, ep_peak=peak, ep_s=seconds,
                ep_drops=got["drops"],
                ep_logits_sha256=_digest([got["logits"]]),
                ep_gates_sha256=_digest(got["gates"]),
                ep_blocks_sha256=_digest(
                    [t for b in got["blocks"] for t in b.values()]),
                ep_other_sha256=_digest(save["other"].values()),
                ep_layer_sums=[dict(bytes=x["bytes"], ms=x["round_s"] * 1e3)
                               for x in sums],
                ep_collectives=len(records),
                ep_params=sum(p.numel() for p in tree.flatten(params)))


def _mesh_pipeline(dev, rank: int, world: int) -> dict:
    """4d, fourth part: ``gpipe_apply`` over the world, rank r holding
    layers [3 r, 3 r + 3) of full-width paper-lm-100m (bf16), on phase 4's
    batch 0 embedded, in PIPE_MICROBATCHES microbatches; forward and the
    backward of the mean square of the output.  The same 12 layers run on
    this rank one after the other on each microbatch (the pipeline's
    shapes) are the sequential stack: its output and its gradients of this
    rank's layers, in norm.  Times: the forward's ticks (M + n - 1), each
    with its exchange through host memory, and the backward."""
    from repro_torch.train import pipeline_parallel
    args = train_lib.parse_args(MAIN_PATH_ARGV + ["--device", str(dev)])
    run = train_lib.start(args)
    cfg, stack = run.cfg, run.params["layers"]
    with torch.no_grad():
        x = model_lib.embed_tokens(cfg, run.params, run.batch(0))
    B, S = x.shape[:2]
    pos = torch.arange(S, device=dev)[None].expand(B // PIPE_MICROBATCHES, S)
    block = lambda p, h: model_lib._dense_block(cfg, p, h, pos)
    n = cfg.num_layers // world
    mine = [leaf[rank * n:(rank + 1) * n].detach().clone().requires_grad_()
            for leaf in tree.flatten(stack)]
    _zero_counts()
    torch.cuda.synchronize(dev)
    dist.barrier()
    t0 = time.perf_counter()
    y = pipeline_parallel.gpipe_apply(dist.group.WORLD,
                                      tree.unflatten(stack, mine), block,
                                      x, PIPE_MICROBATCHES)
    torch.cuda.synchronize(dev)
    t1 = time.perf_counter()
    y.float().square().mean().backward()
    torch.cuda.synchronize(dev)
    t2 = time.perf_counter()
    launches = _counts()
    whole = [leaf.detach().clone().requires_grad_()
             for leaf in tree.flatten(stack)]
    layers = tree.unflatten(stack, whole)
    outs = []
    for xm in x.chunk(PIPE_MICROBATCHES):
        h = xm
        for i in range(cfg.num_layers):
            h = block(tree.unflatten(stack, [v[i] for v in whole]), h)
        outs.append(h)
    want = torch.cat(outs)
    want.float().square().mean().backward()
    grads = max(_rel(g.grad, w.grad[rank * n:(rank + 1) * n])
                for g, w in zip(mine, tree.flatten(layers)))
    ticks = PIPE_MICROBATCHES + world - 1
    y, want = y.detach(), want.detach()
    out = dict(y=_rel(y, want), y_equal=bool(torch.equal(y, want)),
               grads=grads, ticks=ticks, forward_s=t1 - t0,
               backward_s=t2 - t1, launches=launches,
               exchange_bytes=x.numel() // PIPE_MICROBATCHES
               * x.element_size())
    del run, x, y, want, mine, whole, layers, outs
    torch.cuda.empty_cache()
    return out


def mesh_rank(rank: str, world: str, rendezvous: str) -> int:
    """One rank of phase 4d, as ``python3 chip_smoke.py --mesh-rank RANK
    WORLD RENDEZVOUS``: joins a gloo group through the file
    ``RENDEZVOUS`` on the one card, runs the phase's four parts
    (``_mesh_compressed``, ``_mesh_remesh``, ``_mesh_expert_parallel``,
    ``_mesh_pipeline``) and writes its report to
    MESH_DIR/rank-<RANK>.json."""
    rank, world = int(rank), int(world)
    torch.set_num_threads(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world)
    try:
        t0 = time.perf_counter()
        report = dict(rank=rank)
        report.update(_mesh_compressed(dev, rank, world))
        report["compressed_done_s"] = time.perf_counter() - t0
        report.update(remesh=_mesh_remesh(dev, rank))
        report["remesh_done_s"] = time.perf_counter() - t0
        report.update(_mesh_expert_parallel(dev, rank, world))
        report["ep_done_s"] = time.perf_counter() - t0
        report.update(pipeline=_mesh_pipeline(dev, rank, world))
        report["pipeline_done_s"] = time.perf_counter() - t0
        dist.barrier()
        with open(os.path.join(MESH_DIR, f"rank-{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()
    return 0


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| in f32."""
    want = want.float()
    return float((got.float() - want).norm() / want.norm())


def phase_mesh(dev) -> dict:
    """Phase 4d: MESH_RANKS ranks of ``--mesh-rank`` (the compressed mean,
    the remesh, the expert-parallel run and the pipeline), then in this
    process the single-process expert check and the shrink merge.  Returns the
    launches of kernels 1 and 7 it counted."""
    torch.cuda.empty_cache()
    rdzv = os.path.join(MESH_DIR, "rendezvous")
    with contextlib.suppress(FileNotFoundError):
        os.remove(rdzv)
    t0 = time.perf_counter()
    cmds = [[sys.executable, os.path.abspath(__file__), "--mesh-rank",
             str(r), str(MESH_RANKS), rdzv] for r in range(MESH_RANKS)]
    for (rc, out), cmd in zip(_run_group(cmds, MESH_TIMEOUT_S), cmds):
        if rc != 0:
            fail(f"mesh rank {cmd[3]} exited {rc}:\n{out[-6000:]}")
    wall = time.perf_counter() - t0
    reps = [json.load(open(os.path.join(MESH_DIR, f"rank-{r}.json")))
            for r in range(MESH_RANKS)]
    for rep in reps:
        print(f"mesh rank {rep['rank']}: parts done at "
              f"{rep['compressed_done_s']:.1f} / {rep['remesh_done_s']:.1f} "
              f"/ {rep['ep_done_s']:.1f} / {rep['pipeline_done_s']:.1f} s "
              f"after joining the group")
    _check_compressed(reps)
    _check_remesh(reps)
    ep = _check_expert_parallel(dev, reps)
    _check_pipeline(reps)
    merge = phase_shrink_merge(dev)
    print(f"mesh: {MESH_RANKS} ranks on one card over gloo, {wall:.1f} s of "
          f"wall time for the ranks (their startup included)")
    shutil.rmtree(MESH_DIR, ignore_errors=True)
    return dict(ep, merge_grams=merge)


def _check_pipeline(reps: list) -> None:
    """Each rank's pipeline output and its layers' gradients within
    MODEL_RTOL[bf16] of the sequential stack in norm, every rank's output
    the same; kernel 7 launched once a layer a tick in the forward (every
    stage computes at every tick) and the plain version's recompute in the
    backward launches none."""
    rtol = MODEL_RTOL[torch.bfloat16]
    for rep in reps:
        p = rep["pipeline"]
        layers = 12 // MESH_RANKS
        if p["y"] > rtol or p["grads"] > rtol:
            fail(f"pipeline rank {rep['rank']}: output {p['y']:.3e}, "
                 f"gradients {p['grads']:.3e} from the sequential stack "
                 f"(tolerance {rtol})")
        if p["launches"]["flash_attention"] != p["ticks"] * layers:
            fail(f"pipeline rank {rep['rank']}: kernel 7 launched "
                 f"{p['launches']['flash_attention']} times, expected "
                 f"{p['ticks'] * layers}")
        print(f"pipeline rank {rep['rank']}: {p['ticks']} ticks of "
              f"{layers} layers, forward {p['forward_s'] * 1e3:.1f} ms "
              f"({p['forward_s'] / p['ticks'] * 1e3:.1f} ms a tick with its "
              f"exchange of {p['exchange_bytes']} B through host memory), "
              f"backward {p['backward_s'] * 1e3:.1f} ms; output "
              f"{p['y']:.3e} from the sequential stack in norm (equal bits: "
              f"{p['y_equal']}), its layers' gradients {p['grads']:.3e}")


def _check_compressed(reps: list) -> None:
    none = dict.fromkeys(COUNTERS, 0)
    for rep in reps:
        r = rep["rank"]
        if rep["grad_launches"] != dict(none, flash_attention=
                                        TRAIN_FLASH_PER_STEP):
            fail(f"compressed mean rank {r}: gradient launches "
                 f"{rep['grad_launches']}")
        if rep["step_launches"] != dict(
                none, batched_gram=8, batched_lowrank_apply=8,
                flash_attention=TRAIN_FLASH_PER_STEP):
            fail(f"compressed mean rank {r}: step launches "
                 f"{rep['step_launches']}")
        if not (rep["worst_rel"] < 0.02 and rep["worst_step"] <= 1.0):
            fail(f"compressed mean rank {r}: relative error "
                 f"{rep['worst_rel']:.3e}, {rep['worst_step']:.3f} steps")
        # 4 B an element (the int32 sum) and one f32 pmax a leaf
        if rep["comp_bytes"] != 4 * rep["elements"] + 4 * rep["leaves"]:
            fail(f"compressed mean rank {r}: {rep['comp_bytes']} B sent")
        print(f"compressed mean rank {r}: {rep['leaves']} {rep['dtype']} "
              f"leaves, {rep['elements']} elements; compressed "
              f"{rep['comp_s'] * 1e3:.1f} ms ({rep['comp_bytes']} B sent: "
              f"int32 sums and f32 pmaxes), exact pmean "
              f"{rep['exact_s'] * 1e3:.1f} ms ({rep['exact_bytes']} B, "
              f"f32), each with its host copies; largest error "
              f"{rep['worst_rel']:.3e} of a leaf's largest magnitude, "
              f"{rep['worst_step']:.3f} of the one-step bound; the rank's "
              f"Sketchy step {rep['step_s']:.2f} s")
    for key in ("comp_sha256", "exact_sha256"):
        if len({rep[key] for rep in reps}) != 1:
            fail(f"compressed mean: the ranks' {key} differ")


def _check_remesh(reps: list) -> None:
    for devices, *_ in MESH_PLANS:
        held = {}
        for rep in reps:
            got = rep["remesh"][str(devices)]
            if rep["rank"] >= devices:
                if got is not None:
                    fail(f"remesh {devices}: rank {rep['rank']} got a mesh")
                continue
            if got["wrong"]:
                fail(f"remesh {devices}: rank {rep['rank']} holds other "
                     f"blocks of {got['wrong']}")
            held[rep["rank"]] = got
        # every block of a stack once over the ranks that split it
        for name, (_, _, N) in held[0]["rows"].items():
            spans = sorted({tuple(h["rows"][name][:2])
                            for h in held.values()})
            if spans[0][0] != 0 or spans[-1][1] != N or any(
                    a[1] != b[0] for a, b in zip(spans, spans[1:])):
                fail(f"remesh {devices}: {name} blocks {spans} of {N}")
        shape = held[0]["shape"]
        groups = {k.split("::.pools::")[1].split("::")[0]: v[2]
                  for k, v in held[0]["rows"].items()}
        print(f"remesh_opt_state on the {shape[0]} x {shape[1]} mesh: "
              f"pooled bytes a rank "
              f"{[held[r]['bytes'] for r in sorted(held)]} of "
              f"{reps[0]['remesh']['whole_bytes']} whole; placed in "
              f"{max(h['seconds'] for h in held.values()) * 1e3:.1f} ms "
              f"(the slowest rank); blocks of each pool group "
              f"{groups} as rank r holds them: "
              f"{[held[r]['rows'][k][:2] for r in sorted(held) for k in held[r]['rows'] if k.endswith('.left::.rho')]}")


def _reassigned(a: torch.Tensor, b: torch.Tensor, E: int) -> int:
    """The (token, expert) assignments of ``a`` (T, k) that ``b`` lacks."""
    hot = lambda g: torch.zeros(g.shape[0], E, device=g.device).scatter_(
        1, g, 1.0)
    return int((hot(a) - hot(b)).clamp(min=0).sum())


def _check_expert_parallel(dev, reps: list) -> dict:
    """The ranks' expert-parallel run against the single process on the
    same weights (module docstring).  Each moe block, run whole in this
    process on the input the ranks' block took and pulled back with the
    cotangent their block's output got: its output, every rank's expert
    gradients (their slices), router and shared-expert gradients within
    MODEL_RTOL[bf16] in norm, and the same dropped assignments.  End to end
    (the single process's own forward and gradient): kernel 7's launches
    equal; the first moe layer, whose input has the same bits in both runs,
    routes every token alike and drops the same assignments; a later one
    drops within the assignments routed to another expert; the logits' and
    gradients' relative errors printed (bf16's rounding of the routed sums
    reroutes near-ties in the later layers, which moves them past the
    blocks' tolerance)."""
    cfg, params, batch = _ep_model(dev)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    t0 = time.perf_counter()
    single = _ep_run(cfg, params, batch)
    torch.cuda.synchronize(dev)
    seconds, launches = time.perf_counter() - t0, _counts()
    peak = torch.cuda.max_memory_allocated(dev)
    flat = dict(zip(rules_lib.tree_paths(single["grads"]),
                    tree.flatten(single["grads"])))
    rtol = MODEL_RTOL[torch.bfloat16]
    E_loc = cfg.num_experts // MESH_RANKS
    saved = [torch.load(os.path.join(MESH_DIR, f"ep-{r}.pt"),
                        map_location=dev) for r in range(MESH_RANKS)]
    blocks, worst, e2e, problems = saved[0]["blocks"], {}, {}, []
    for layer, rec in enumerate(blocks):
        want = _ep_block(cfg, params, layer, rec["x"], rec["cot"])
        worst["output"] = max(worst.get("output", 0.0),
                              _rel(rec["y"], want["y"]))
        if want["drops"] != reps[0]["ep_drops"][layer]:
            problems.append(f"moe layer {layer}: the ranks dropped "
                            f"{reps[0]['ep_drops'][layer]}, the block "
                            f"{want['drops']} on the same input")
        for r, got in enumerate(saved):
            for path, g in want["grads"].items():
                if path.startswith("experts/"):
                    mine = got["experts"][f"moe/{path}"][layer]
                    g = g[r * E_loc:(r + 1) * E_loc]
                else:
                    mine = got["other"][f"moe/{path}"][layer]
                key = path.split("/")[-1] if path.startswith("experts") \
                    else path
                worst[key] = max(worst.get(key, 0.0), _rel(mine, g))
    del blocks
    e2e["logits"] = _rel(saved[0]["logits"], single["logits"])
    for r, got in enumerate(saved):
        for part in ("experts", "other"):
            for path, g in got[part].items():
                want = flat[path]
                if part == "experts":      # (L, E, ...): rank r's experts
                    want = want[:, r * E_loc:(r + 1) * E_loc]
                e2e[path] = max(e2e.get(path, 0.0), _rel(g, want))
    flips = [_reassigned(a, b, cfg.num_experts)
             for a, b in zip(saved[0]["gates"], single["gates"])]
    del saved, params
    drops = single["drops"]
    for rep in reps:
        got = rep["ep_drops"]
        if got[0] != drops[0] or flips[0] != 0 or any(
                abs(a - b) > f for a, b, f in zip(got, drops, flips)):
            problems.append(f"end to end, rank {rep['rank']} dropped {got} "
                            f"a layer, the single process {drops}, "
                            f"reassigned {flips}")
        if rep["ep_launches"] != launches or launches["flash_attention"] == 0:
            problems.append(f"rank {rep['rank']} launches "
                            f"{rep['ep_launches']}, single process "
                            f"{launches}")
    for key in ("ep_logits_sha256", "ep_gates_sha256", "ep_other_sha256",
                "ep_blocks_sha256"):
        if len({rep[key] for rep in reps}) != 1:
            problems.append(f"the ranks' {key} differ")
    bad = {k: v for k, v in worst.items() if not v <= rtol}
    if bad:
        problems.append(f"blocks' relative errors {bad} over {rtol}")
    fmt = lambda d: ", ".join(f"{k} {v:.2e}" for k, v in d.items())
    print(f"expert parallel ({EP_ARCH}, {EP_LAYERS} layers, B {EP_BATCH}, "
          f"S {EP_SEQ}, {E_loc} experts a rank), each moe block against "
          f"the single-process block on its input (largest over the layers "
          f"and ranks): {fmt(worst)}")
    print(f"expert parallel end to end against the single process: "
          f"{fmt(e2e)}; assignments dropped a moe layer "
          f"{reps[0]['ep_drops']}, single process {drops}, of "
          f"{EP_BATCH * EP_SEQ * cfg.experts_per_token}; assignments "
          f"routed to another expert {flips}; kernel 7 "
          f"{launches['flash_attention']} launches a rank and in the single "
          f"process")
    for rep in reps:
        print(f"expert parallel rank {rep['rank']}: {rep['ep_params']} "
              f"parameters held, peak {rep['ep_peak']} B (single process "
              f"{peak} B), forward and gradient {rep['ep_s']:.2f} s (single "
              f"process {seconds:.2f} s), each moe layer's sum "
              f"{[round(x['ms'], 2) for x in rep['ep_layer_sums']]} ms of "
              f"{rep['ep_layer_sums'][0]['bytes']} B, "
              f"{rep['ep_collectives']} collectives in all")
    if problems:
        fail("expert parallel against the single process: "
             + "; ".join(problems))
    del single, flat
    torch.cuda.empty_cache()
    return dict(flash_attention=launches["flash_attention"])


def _cov(st) -> torch.Tensor:
    U = st.eigvecs.double()
    return torch.einsum("nde,ne,nfe->ndf", U, st.eigvals.double(), U)


def _close_scaled(label: str, got, want, scale=None) -> float:
    """tests/torch_parity.py's ``assert_close_scaled``: rtol 1e-4 plus 1e-5
    of ``scale`` (default: the largest magnitude of ``want``); returns the
    largest difference over that slack."""
    got, want = got.double(), want.double().to(got.device)
    scale = float(want.abs().max()) if scale is None else scale
    share = float(((got - want).abs() / (1e-4 * want.abs() + 1e-5 * scale))
                  .max())
    if not share <= 1:
        fail(f"{label}: card and CPU merges differ ({share:.2f} of the "
             f"tolerance)")
    return share


def phase_shrink_merge(dev) -> int:
    """``merge_sketches_on_shrink`` of the four ranks' own full-width pools
    (saved by ``_mesh_compressed``, each of its own quarter of the batch) on
    the card, timed, with kernel 1's launches counted (one a merge of a
    stack: 3 a stack of the 8), against the same merge on the CPU by
    covariance, ladder and rho (tests/test_torch_distributed.py's
    tolerance).  Returns kernel 1's launches."""
    pools = [torch.load(os.path.join(MESH_DIR, f"pools-{r}.pt"),
                        map_location=dev, weights_only=False)
             for r in range(MESH_RANKS)]
    stacks = sum(2 for _ in pools[0])
    _zero_counts()
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    merged = elastic.merge_sketches_on_shrink(pools)
    torch.cuda.synchronize(dev)
    seconds, launches = time.perf_counter() - t0, _counts()
    expected = dict(dict.fromkeys(COUNTERS, 0),
                    batched_gram=(MESH_RANKS - 1) * stacks)
    if launches != expected:
        fail(f"shrink merge: launches {launches}, expected {expected}")
    cpu = [{k: type(v)(*(type(s)(*(t.cpu() for t in s)) for s in v))
            for k, v in p.items()} for p in pools]
    t0 = time.perf_counter()
    want = elastic.merge_sketches_on_shrink(cpu)
    cpu_s = time.perf_counter() - t0
    worst = 0.0
    for key in merged:
        for side in ("left", "right"):
            got, ref = getattr(merged[key], side), getattr(want[key], side)
            ladder = max(float(ref.eigvals.abs().max()),
                         float(ref.rho.abs().max()))
            label = f"shrink merge {key} {side}"
            worst = max(worst,
                        _close_scaled(label, _cov(got), _cov(ref).to(dev)),
                        _close_scaled(label, got.eigvals, ref.eigvals),
                        _close_scaled(label, got.rho, ref.rho, ladder))
    print(f"shrink merge of {MESH_RANKS} ranks' full-width pools "
          f"({stacks} stacks, kernel 1 {launches['batched_gram']} launches "
          f"at (N, d, 2 ell)): card {seconds * 1e3:.1f} ms, CPU "
          f"{cpu_s * 1e3:.1f} ms; largest difference {worst:.3f} of the "
          f"tolerance")
    return launches["batched_gram"]


# the tune phase: kernels 2, 2' and 6 at the main path's shapes, each
# candidate against the plain version, timed; the winners into a cache
# under build/ (the committed fixture is kernels/tune_cache.json)
TUNE_CACHE = os.path.join(ROOT, "build", "tune", "tune_cache.json")


def tune_specs() -> list:
    """(kernel, shape, dtype, calls a step) of kernels 2 (f32 U), 2' (int8
    U) and 6 at the main path's shapes: the apply's (N, d, ell, n) and the
    write-back's (N, d, ell, r, ell), each distinct shape once with the
    number of the main path's calls a step or refresh that take it."""
    refresh, apply = main_path_shapes()
    out = {}
    for dtype in ("float32", "int8"):
        for shape in apply:
            key = ("batched_lowrank_apply", shape, dtype)
            out[key] = out.get(key, 0) + 1
    for N, d, ell, r in refresh:
        key = ("batched_project_quantize", (N, d, ell, r, ell), "int8")
        out[key] = out.get(key, 0) + 1
    return [k + (n,) for k, n in out.items()]


def phase_tune(dev, smi: str) -> dict:
    """Every candidate of ``tune_specs`` against the plain version on the
    same operands (the apply at the f32 tolerance, the write-back's values
    within one step where the plain U_new / scale is within 1e-3 of a .5
    boundary, ``project_quantize_differences``), whether the candidates
    give the same bits, each timed (``autotune.time_config``); the
    measured search then tunes each shape into TUNE_CACHE, and ``auto``
    mode on the committed fixture must pick what the fixture records.
    Prints, per kernel, a step's default and tuned sums.  Returns
    {kernel row: (default ms, tuned ms)}."""
    from repro_torch.kernels import autotune
    name = {("batched_lowrank_apply", "float32"): "2",
            ("batched_lowrank_apply", "int8"): "2'",
            ("batched_project_quantize", "int8"): "6"}
    sums = {}
    for kernel, shape, dtype, calls in tune_specs():
        ops = autotune._operands(kernel, shape, dtype, dev)
        plain = autotune._plain(kernel)(*ops)
        cands = autotune.candidates(kernel, shape, dtype)
        outs, times = [], []
        for cand in cands:
            got = autotune._runner(kernel)(cand, *ops)
            if kernel == "batched_project_quantize":
                lowrank_ref.project_quantize_differences(got, *ops)
                err = 0.0
            else:
                err = check(f"tune {kernel} {shape} {dtype} {cand}", got,
                            plain, shape[1])
            outs.append(got)
            times.append(autotune.time_config(kernel, cand, ops) * 1e3)
            print(f"tune: kernel {name[kernel, dtype]} {shape} {dtype} "
                  f"{dict(cand._asdict())}: {times[-1]:.4f} ms, max abs "
                  f"diff {err:.3e}")
        same = all(all(torch.equal(a, b) for a, b in zip(
            o if isinstance(o, tuple) else (o,),
            outs[0] if isinstance(outs[0], tuple) else (outs[0],)))
            for o in outs[1:])
        best = min(range(len(cands)), key=lambda i: (times[i], i))
        row = sums.setdefault(name[kernel, dtype], [0.0, 0.0])
        row[0] += calls * times[0]
        row[1] += calls * times[best]
        print(f"tune: kernel {name[kernel, dtype]} {shape} {dtype} x "
              f"{calls}: {len(cands)} candidates, equal bits {same}; "
              f"fastest {dict(cands[best]._asdict())} {times[best]:.4f} ms "
              f"against the default's {times[0]:.4f} ms")
    with contextlib.suppress(FileNotFoundError):
        os.remove(TUNE_CACHE)
    autotune.reload(path=TUNE_CACHE, mode="force")
    found = autotune.tune_into_cache(
        [s[:3] for s in tune_specs()], path=TUNE_CACHE)
    for key, cfg in sorted(found.items()):
        print(f"tune: {key} -> {dict(cfg._asdict())}")
    autotune.reload(path=autotune.DEFAULT_CACHE_PATH, mode="auto")
    fixture = json.load(open(autotune.DEFAULT_CACHE_PATH))["entries"]
    mine = {k: v for k, v in fixture.items()
            if autotune.parse_key(k)[0] == autotune.device_name()}
    for key, v in mine.items():
        _, kernel, shape, dtype = autotune.parse_key(key)
        if autotune.get_config(kernel, shape, dtype) != \
                autotune.TileConfig(**v):
            fail(f"tune: auto mode does not pick the fixture's {key}")
    agree = sum(found.get(k) == autotune.TileConfig(**v)
                for k, v in mine.items())
    print(f"tune: the committed fixture holds {len(mine)} entries for this "
          f"card, picked in auto mode; {agree} equal this run's winners")
    for row, (default, tuned) in sorted(sums.items()):
        print(f"tune: kernel {row}, a step's calls at the main path's "
              f"shapes: default {default:.4f} ms, tuned {tuned:.4f} ms "
              f"({smi})")
    return {row: tuple(v) for row, v in sums.items()}


MICROBATCHES = 4


def phase_microbatch(dev) -> None:
    """Full-width paper-lm-100m, Sketchy at MAIN_PATH_ARGV (phase 4's batch
    8 x 128), two steps (a refresh at step 0) through ``launch.train``'s
    run, once whole and once with ``make_train_step(microbatches=4)``, from
    the same weights: the losses and every parameter within
    MODEL_RTOL[bf16] in norm, and the launches of kernels 1 and 2 equal
    (8 Grams, 8 applies a step) while kernel 7 launches 4 times as often
    (every microbatch's forward and recompute)."""
    from repro_torch.train import trainer
    argv = MAIN_PATH_ARGV + ["--device", str(dev)]
    runs = {}
    for m in (None, MICROBATCHES):
        make = functools.partial(trainer.make_train_step, microbatches=m)
        with mock.patch.object(train_lib, "make_train_step", make):
            run = train_lib.start(train_lib.parse_args(argv))
        _zero_counts()
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        losses = [float(run.step(i)["loss"]) for i in range(2)]
        torch.cuda.synchronize(dev)
        runs[m] = dict(losses=losses, launches=_counts(),
                       s=time.perf_counter() - t0,
                       params=[p.detach() for p in tree.flatten(run.params)])
        del run
    whole, micro = runs[None], runs[MICROBATCHES]
    rtol = MODEL_RTOL[torch.bfloat16]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(micro["losses"],
                                                        whole["losses"]))
    param_rel = max(_rel(a, b) for a, b in zip(micro["params"],
                                               whole["params"]))
    if loss_rel > rtol or param_rel > rtol:
        fail(f"microbatch: losses {loss_rel:.3e}, parameters "
             f"{param_rel:.3e} from the whole batch (tolerance {rtol})")
    flash = whole["launches"]["flash_attention"]
    want = dict(whole["launches"], flash_attention=MICROBATCHES * flash)
    if micro["launches"] != want or whole["launches"]["batched_gram"] != 8 \
            or whole["launches"]["batched_lowrank_apply"] != 16:
        fail(f"microbatch: launches {micro['launches']}, whole batch "
             f"{whole['launches']}")
    print(f"microbatch: {MICROBATCHES} microbatches against the whole "
          f"batch, 2 steps: losses {micro['losses']} / {whole['losses']} "
          f"({loss_rel:.3e}), parameters {param_rel:.3e} in norm; "
          f"{micro['s']:.3f} s / {whole['s']:.3f} s; launches "
          f"{micro['launches']}")


# the dry run: the production plan of one cell on a fake 16 x 16 mesh (the
# CLI), and on one rank at phase 4's shape the plan against the card; the
# card's temporary bytes of one refresh step over the plan's, stated before
# the first call (PERF.md)
DRYRUN_DIR = os.path.join(ROOT, "build", "dryrun")
DRYRUN_TIMEOUT_S = 300
PEAK_BAND = (0.8, 1.25)


def phase_dryrun(dev) -> None:
    """``python -m repro_torch.launch.dryrun --arch paper-lm-100m --shape
    train_4k`` (a fake group of 256 ranks, the production mesh, the
    probes): its plan printed.  Then in this process, on a fake group of
    one rank, the plan of full-width paper-lm-100m at phase 4's shape (8 x
    128) with MAIN_PATH_ARGV's optimizer, against ``launch.train``'s real
    state after ``init`` on the card: the plan's parameter and state bytes
    (``alias_bytes`` and the unread ``unused_bytes``) equal the real ones
    exactly, and the card's bytes allocated above its arguments during
    step 0 (a refresh) over the plan's ``temp_bytes`` lies in PEAK_BAND;
    the step's time beside the plan's ``bound_s`` at its shape."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from repro_torch.launch import dryrun_lib
    os.makedirs(DRYRUN_DIR, exist_ok=True)
    out = os.path.join(DRYRUN_DIR, "train_4k.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "paper-lm-100m", "--shape", "train_4k", "--out", out],
        capture_output=True, text=True, timeout=DRYRUN_TIMEOUT_S,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")),
        cwd=ROOT)
    if proc.returncode != 0:
        fail(f"dry run exited {proc.returncode}:\n{proc.stdout[-3000:]}"
             f"\n{proc.stderr[-3000:]}")
    plan = json.load(open(out))
    full = plan["full"]
    print(f"dry run paper-lm-100m train_4k on {plan['mesh']} "
          f"({plan['chips']} ranks, {time.perf_counter() - t0:.1f} s): "
          f"argument {full['argument_bytes']} B, temp {full['temp_bytes']} "
          f"B, peak {full['peak_bytes_per_device']} B a rank; cost a rank "
          f"{plan['cost']}; roofline {plan['roofline']}; useful flops "
          f"{plan['useful_flops_ratio']:.3f}, roofline fraction "
          f"{plan['roofline_fraction']:.3e}")

    args = train_lib.parse_args(MAIN_PATH_ARGV + ["--device", str(dev)])
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=1)
    try:
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"),
                                  device_type="cpu")
        report = dryrun_lib.run_cell(
            "paper-lm-100m", "train_4k", mesh=mesh,
            shape=registry.ShapeCfg("train_4k", args.seq, args.batch,
                                    "train"),
            opt_overrides=dict(learning_rate=args.lr, rank=args.rank,
                               block_size=args.block_size,
                               update_every=args.update_every,
                               total_steps=args.steps, weight_decay=1e-4))
    finally:
        dist.destroy_process_group()
    full = report["full"]
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    run = train_lib.start(args)
    batch = run.batch(0)
    real = sum(4 if isinstance(x, int) else x.numel() * x.element_size()
               for x in tree.flatten(run.params)
               + [leaf.value for leaf in ckpt_lib.leaves(run.opt_state)])
    predicted = full["alias_bytes"] + full["unused_bytes"]
    if predicted != real:
        fail(f"dry run: the plan's parameter and state bytes {predicted}, "
             f"the card's {real}")
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    before = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    run.params, run.opt_state, _ = run.step_fn(run.params, run.opt_state,
                                               batch)
    torch.cuda.synchronize(dev)
    step_s = time.perf_counter() - t0
    temp = torch.cuda.max_memory_allocated(dev) - before
    share = temp / full["temp_bytes"]
    print(f"dry run on one rank at phase 4's shape: parameters and state "
          f"{predicted} B planned, {real} B on the card (arguments "
          f"{full['argument_bytes']} B with the int32 batch, {before - base} "
          f"B allocated with the int64 one); step 0 (a refresh) allocated "
          f"{temp} B above its arguments, the plan {full['temp_bytes']} B "
          f"({share:.3f}; band {PEAK_BAND}); the step {step_s:.3f} s, the "
          f"plan's bound {report['roofline']['bound_s']:.3e} s "
          f"({report['roofline']['dominant']}), {report['cost']}")
    if not PEAK_BAND[0] <= share <= PEAK_BAND[1]:
        fail(f"dry run: the card's temporary bytes {temp} are {share:.3f} "
             f"of the plan's {full['temp_bytes']}, outside {PEAK_BAND}")
    del run, batch
    torch.cuda.empty_cache()
    shutil.rmtree(DRYRUN_DIR, ignore_errors=True)


def check_budget(opt_state) -> None:
    """BUDGET_ARGV's active ranks after the reallocation at step 10: the
    budget held and every block within [min_k, max_k]; prints per group
    the min, median and max rank and how many blocks moved from the
    uniform allocation (7104 / 222 = 32 each)."""
    alloc = api.rank_allocation(opt_state)
    ks = np.concatenate([g["k"] for g in alloc["groups"].values()])
    if int(ks.sum()) != BUDGET_TOTAL or alloc["total"] != BUDGET_TOTAL:
        fail(f"rank budget: sum(k) = {int(ks.sum())}, expected "
             f"{BUDGET_TOTAL}")
    if not ((ks >= BUDGET_MIN_K) & (ks <= BUDGET_MAX_K)).all():
        fail(f"rank budget: k outside [{BUDGET_MIN_K}, {BUDGET_MAX_K}]: "
             f"{ks.min()}..{ks.max()}")
    uniform = BUDGET_TOTAL // len(ks)
    for key, g in alloc["groups"].items():
        k = g["k"]
        print(f"rank budget after step 10, group {key} ({len(k)} blocks): "
              f"k min {k.min()} median {np.median(k):g} max {k.max()}, "
              f"{int((k != uniform).sum())} blocks moved from {uniform}")


def _device_intervals(prof, labels: tuple) -> list:
    """(start, end) of every device event of ``prof`` but the device-side
    copies of the caller's ranges ``labels``, in us."""
    from torch.autograd import DeviceType
    return sorted((e.time_range.start, e.time_range.end)
                  for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and e.name not in labels)


def _busy_us(intervals: list, lo: float = float("-inf"),
             hi: float = float("inf")) -> float:
    """The union's length of sorted ``intervals`` clipped to [lo, hi]."""
    busy, end = 0.0, lo
    for a, b in intervals:
        b = min(b, hi)
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


def _profiled(fn, title: str, labels: tuple = (), groups: dict = None):
    """Run ``fn()`` under ``torch.profiler``; print its wall time, the
    device's busy time and idle share over it, and the device time by
    kernel (``labels``: the caller's own ranges, left out of both);
    ``groups``: name -> substrings of kernel names whose device time and
    launches are also printed summed.  Returns the profile."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device busy time: the union of the device events' intervals
    busy_ms = _busy_us(_device_intervals(prof, labels)) / 1e3
    print(f"profile of {title}: wall {wall_ms:.3f} ms (profiled), "
          f"device busy {busy_ms:.3f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}")
    rows = [r for r in prof.key_averages() if r.key not in labels]
    dev_us = lambda r: getattr(r, "self_device_time_total",
                               getattr(r, "self_cuda_time_total", 0.0))
    for r in sorted(rows, key=dev_us, reverse=True)[:12]:
        print(f"  {dev_us(r) / 1e3:9.3f} ms  x{r.count:<5d} {r.key[:90]}")
    for r in prof.key_averages():
        if r.key in labels:
            print(f"  {r.key}: host {r.cpu_time_total / 1e3:.3f} ms")
    for name, parts in (groups or {}).items():
        hits = [r for r in rows if any(p in r.key for p in parts)]
        print(f"  {name}: device {sum(map(dev_us, hits)) / 1e3:.3f} ms over "
              f"{sum(r.count for r in hits)} launches")
    return prof


def phase_profile(dev, argv: list) -> None:
    """Device time by kernel of one plain (non-refresh) step of the main
    path's configuration ``argv``, and the device's idle share of that
    step."""
    print(f"profile of {' '.join(argv)}")
    run = train_lib.start(train_lib.parse_args(argv))
    run.step(0)                                    # the refresh step
    _profiled(lambda: run.step(1), "a plain step",
              ("train/forward_backward", "train/optimizer"))


def phase_serve_profile(dev) -> None:
    """Device time by kernel of one full-width monitor observation and one
    adaptation step (SERVE_ARGV's monitor and adapter, the seeded weights,
    a feedback batch), each after one warm-up call."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.serve import (AdaptConfig, GradientMonitor,
                                   MonitorConfig, OnlineAdapter)
    cfg = registry.get_config("paper-lm-100m")
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    adapter = OnlineAdapter(cfg, params, AdaptConfig(lr=0.1, beta2=0.95))
    monitor = GradientMonitor(adapter.d, MonitorConfig(window=4, ell=8))
    data = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                  global_batch=4, seed=1))
    _, g = adapter.grad(params, data.batch(0))
    monitor.observe(g)
    _profiled(lambda: monitor.observe(g), "a full-width monitor observe")
    params, _ = adapter.step(params, data.batch(0))
    _profiled(lambda: adapter.step(params, data.batch(1)),
              "a full-width adaptation step")


# csrc/ssd.cu's kernels, as the profiler names them
SSD_KERNELS = ("chunk_out_kernel", "chunk_state_kernel", "state_pass_kernel")


def phase_zamba_gradient_profile(dev, params: dict) -> None:
    """Device time by kernel of one full-width zamba2-7b feedback gradient
    (the adapter's gradient through the tied embed, ``params`` the served
    weights, one SyntheticLM feedback batch), after one warm-up call."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.serve import OnlineAdapter
    cfg = registry.get_config("zamba2-7b")
    adapter = OnlineAdapter(cfg, params)
    batch = SyntheticLM(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                   global_batch=4, seed=1)).batch(0)
    adapter.grad(params, batch)
    _profiled(lambda: adapter.grad(params, batch),
              "a full-width zamba2-7b feedback gradient",
              groups={"kernel 8 (csrc/ssd.cu)": SSD_KERNELS})


# the reduced model's budget at half its capacity, as benchmarks/run.py
# :253-265 computes it for its reduced rank_budget row: rank 8 over its 144
# blocks of block 32, total max(144 * 8 // 2, 144 * 2) = 576, min_k 2
REDUCED_BUDGET_ARGV = ["--rank-budget",
                       "total=576,min_k=2,max_k=8,policy=rho_greedy"]


REFERENCE_ARGV = ["--reduced", "--steps", "4", "--seq", "32", "--batch", "4",
                  "--rank", "4", "--block-size", "32", "--update-every", "2"]


def phase_reference(dev, storage: str, optimizer: str = "sketchy",
                    extra: tuple = (), resume_from: str = None) -> None:
    """Reduced model, same weights: card (kernels) vs CPU (plain), with
    ``optimizer``, ``storage`` second-moment storage and the flags
    ``extra``; under a rank budget both reach the same active ranks.  With
    ``resume_from`` (a checkpoint directory), each device resumes from a
    copy of it."""
    argv = REFERENCE_ARGV + ["--second-moment-dtype", storage,
                             "--optimizer", optimizer, *extra]
    storage = " ".join([optimizer, storage, *extra]
                       + (["resumed"] if resume_from else []))
    cfg = registry.get_reduced("paper-lm-100m")
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0))
    losses, ranks = {}, {}
    for device in (dev, torch.device("cpu")):
        start = tree.unflatten(params, [p.to(device)
                                        for p in tree.flatten(params)])
        resume = []
        if resume_from:
            resume = ["--checkpoint-dir", _fresh_dir(device.type),
                      "--resume"]
            shutil.copytree(resume_from, resume[1], dirs_exist_ok=True)
        _zero_counts()
        run, log = train_lib.train(
            train_lib.parse_args(argv + ["--device", str(device), *resume]),
            start)
        losses[device.type] = [r["loss"] for r in log]
        if resume_from and log[0]["step"] != \
                ckpt_lib.latest_step(resume_from):
            fail(f"reference ({storage}): did not resume, ran steps "
                 f"{[r['step'] for r in log]}")
        if "--rank-budget" in extra:
            ranks[device.type] = np.concatenate([
                g["k"] for g in api.rank_allocation(
                    run.opt_state)["groups"].values()])
        del run
        if device.type == "cuda":
            # no remat in the reduced config: each layer's attention once
            # per step
            flash = _counts()["flash_attention"]
            if flash != len(log) * cfg.num_layers:
                fail(f"reference ({storage}): {flash} flash_attention "
                     f"launches, expected {len(log) * cfg.num_layers}")
    worst = max(abs(a - b) / abs(b)
                for a, b in zip(losses["cuda"], losses["cpu"]))
    print(f"reference ({storage}): card losses {losses['cuda']}, CPU losses "
          f"{losses['cpu']}, max rel diff {worst:.2e}")
    # different eigh and summation orders on the two devices, over 4 steps;
    # under int8 also different stochastic-rounding draws (per-device
    # generators) of the diagonal accumulators, which move these losses by
    # ~6e-6 relative on the CPU
    if worst > 1e-3:
        fail(f"card and CPU runs of the reduced model disagree ({storage})")
    if ranks:
        moved = int((ranks["cpu"] != ranks["cpu"][0]).sum())
        print(f"reference ({storage}): active ranks sum {ranks['cpu'].sum()}"
              f", {moved} of {len(ranks['cpu'])} blocks off block 0's")
        if not np.array_equal(ranks["cuda"], ranks["cpu"]):
            fail(f"card and CPU reach different active ranks ({storage}): "
                 f"{np.flatnonzero(ranks['cuda'] != ranks['cpu'])}")


def phase_async_equality(dev) -> None:
    """The reduced model's Sketchy with int8 storage and the staggered
    schedule (the fused path: kernels 5, 6 and 2'), inline and async, over
    the same seeded gradients on the card: after each of 6 steps the async
    state's committed pools equal the inline pools bit for bit."""
    from repro_torch.core import sketchy as sketchy_lib
    cfg = registry.get_reduced("paper-lm-100m")
    params = [p.to(dev) for p in tree.flatten(model_lib.init_params(
        cfg, torch.Generator().manual_seed(0)))]
    txs = {mode: sketchy_lib.sketchy(sketchy_lib.SketchyConfig(
        rank_budget=sketchy_lib.RankBudget(min_k=4, max_k=4), block_size=32,
        update_every=2, refresh_schedule="staggered", refresh_mode=mode,
        second_moment_dtype="int8")) for mode in ("inline", "async")}
    states = {mode: tx.init(params) for mode, tx in txs.items()}
    gen = torch.Generator(device=dev).manual_seed(5)
    _zero_counts()
    for t in range(6):
        grads = [torch.randn(p.shape, generator=gen, device=dev)
                 for p in params]
        for mode, tx in txs.items():
            _, states[mode] = tx.update(grads, states[mode], params)
        committed = api.committed_pools(states["async"])
        for key, live in states["inline"].pools.items():
            pairs = zip(quantize.second_moment_tensors(committed[key]),
                        quantize.second_moment_tensors(live))
            if not all(torch.equal(a, b) for a, b in pairs):
                fail(f"async on the card: committed pools of group {key} "
                     f"differ from the inline pools after step {t}")
    launches = {k: v for k, v in _counts().items() if v}
    print(f"async on the card: committed pools equal the inline pools bit "
          f"for bit after each of 6 steps (int8, staggered; launches "
          f"{launches})")
    if not launches.get("batched_project_quantize"):
        fail("async on the card: the fused int8 kernels never ran")


# the checkpoint phase: full-width round trips of a mid-run save (after
# step CKPT_STEP, so optimizer count CKPT_STEP + 1) in five configurations,
# each followed by step CKPT_STEP + 1 from the live and the restored state
CKPT_STEP = 5
CKPT_RUNS = {"sketchy fp32": [], "sketchy int8": INT8_ARGV,
             "sketchy async int8": ASYNC_INT8_ARGV,
             "sketchy rho_greedy": BUDGET_ARGV, "shampoo fp32": SHAMPOO_ARGV}
CKPT_ROOT = os.path.join(ROOT, "build", "checkpoints")


def _fresh_dir(name: str) -> str:
    d = os.path.join(CKPT_ROOT, name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    return d


def _leaf_bytes(value) -> int:
    """A leaf's bytes: a tensor's storage, a Python int as the int32 it is
    written as, a bool as one byte."""
    if isinstance(value, torch.Tensor):
        return value.numel() * value.element_size()
    return 1 if isinstance(value, bool) else 4


def _disk(path: str) -> tuple[int, int, int]:
    """(data bytes of the leaf files, bytes of every file, leaf count) of
    one checkpoint step."""
    with open(os.path.join(path, "manifest.json")) as f:
        recs = json.load(f)["leaves"]
    data = sum(np.load(os.path.join(path, r["file"]), mmap_mode="r").nbytes
               for r in recs)
    files = sum(os.path.getsize(os.path.join(path, f))
                for f in os.listdir(path))
    return data, files, len(recs)


def _copy_state(state):
    """A copy of a state with tensors of its own, the pending slot reset
    as a restore rebuilds it (zeros, ``valid=False``)."""
    def one(leaf):
        if leaf.transient:
            return torch.zeros_like(leaf.value) \
                if isinstance(leaf.value, torch.Tensor) \
                else type(leaf.value)(0)
        if isinstance(leaf.value, torch.Tensor):
            return leaf.value.detach().clone()
        return leaf.value
    return ckpt_lib.map_leaves(one, state)


def _state_diff(a, b) -> tuple[bool, float]:
    """(bit for bit equal, largest absolute difference) of two states of
    one structure, transient leaves included."""
    la, lb = ckpt_lib.leaves(a), ckpt_lib.leaves(b)
    if [x.name for x in la] != [x.name for x in lb]:
        fail("checkpoint: states of different structure compared")
    same, worst = True, 0.0
    for x, y in zip(la, lb):
        if not isinstance(x.value, torch.Tensor):
            same &= x.value == y.value
            continue
        if x.value.dtype != y.value.dtype or x.value.shape != y.value.shape:
            fail(f"checkpoint: {x.name} changed dtype or shape")
        if not torch.equal(x.value, y.value):
            same = False
            worst = max(worst, float((x.value.double()
                                      - y.value.double()).abs().max()))
    return same, worst


def _step_from(run, state, step: int):
    """Train step ``step`` of ``run`` from ``state`` (consumed: the
    parameters are updated in place); the state after it."""
    run.params, run.opt_state = state
    run.step(step)
    torch.cuda.synchronize()
    return run.params, run.opt_state


def _round_trip(label: str, extra: list) -> None:
    """One configuration's full-width round trip: train steps 0..CKPT_STEP,
    save, restore into a fresh ``start()`` template, and compare every leaf
    bit for bit (the pending slot rebuilt empty); the disk bytes against
    the state's bytes less the pending slot's; then step CKPT_STEP + 1 from
    the restored state against the same step from the live state, after a
    witness of that step run twice from the live state."""
    args = train_lib.parse_args(MAIN_PATH_ARGV + extra)
    run = train_lib.start(args)
    for i in range(CKPT_STEP + 1):
        run.step(i)
    torch.cuda.synchronize()
    live = (run.params, run.opt_state)
    d = _fresh_dir("round_trip")
    t0 = time.perf_counter()
    path = ckpt_lib.save(d, CKPT_STEP, live)
    save_s = time.perf_counter() - t0
    data, files, n = _disk(path)
    fresh = train_lib.start(args)
    template = (fresh.params, fresh.opt_state)
    del fresh
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored, step, _ = ckpt_lib.restore(d, template)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del template
    if step != CKPT_STEP:
        fail(f"checkpoint ({label}): restored step {step}")
    kept = [leaf for leaf in ckpt_lib.leaves(live) if not leaf.transient]
    total = sum(_leaf_bytes(leaf.value) for leaf in ckpt_lib.leaves(live))
    pending = total - sum(_leaf_bytes(leaf.value) for leaf in kept)
    same, worst = _state_diff(restored, _copy_state(live))
    if not same:
        fail(f"checkpoint ({label}): the restored state differs from the "
             f"saved one (largest difference {worst:g})")
    if n != len(kept) or data != total - pending:
        fail(f"checkpoint ({label}): {n} leaves and {data} B on disk, the "
             f"state holds {len(kept)} leaves and {total} B, of which "
             f"{pending} B pending")
    counts = [leaf.value for leaf in ckpt_lib.leaves(restored)
              if leaf.name.endswith(".count")]
    if counts != [CKPT_STEP + 1] * 2 or \
            not all(type(c) is int for c in counts):
        fail(f"checkpoint ({label}): restored counts {counts}")
    print(f"checkpoint ({label}): step {CKPT_STEP} of full-width "
          f"paper-lm-100m: {n} leaves, {data} B of leaf data on disk "
          f"({files} B in files) = the state's {total} B less {pending} B "
          f"of pending slot; save {save_s:.3f} s, restore {restore_s:.3f} "
          f"s; every leaf restored bit for bit with its dtype and shape "
          f"(counts {counts}, Python ints)")

    a = _step_from(run, _copy_state(live), CKPT_STEP + 1)
    b = _step_from(run, _copy_state(live), CKPT_STEP + 1)
    del live
    witness_same, witness = _state_diff(a, b)
    del b
    r = _step_from(run, restored, CKPT_STEP + 1)
    cont_same, cont = _state_diff(r, a)
    text = {True: "bit for bit", False: "largest difference {:g}"}
    print(f"checkpoint ({label}): step {CKPT_STEP + 1} from the restored "
          f"state against the live one: {text[cont_same].format(cont)}; "
          f"the same step twice from the live state (witness): "
          f"{text[witness_same].format(witness)}")
    if not (cont_same or (not witness_same and cont <= witness)):
        fail(f"checkpoint ({label}): the continuation differs by {cont:g}, "
             f"the witness by {witness:g}")
    shutil.rmtree(d)


def phase_checkpoint(dev, smi: str) -> None:
    """Checkpoint and resume at full width (train/checkpoint.py and the
    launcher's flags): the round trips of CKPT_RUNS; then the launcher
    itself, ``python -m repro_torch.launch.train`` with MAIN_PATH_ARGV,
    a checkpoint every 5 steps, which must leave step-5, step-10 and
    step-12 and no tmp-; then a resume from a copy of step-5 alone, which
    runs batches 5-11 (batch 5 a second time, as the reference resumes)
    with the launch counts of those 7 steps at optimizer counts 6-12 (one
    refresh, at count 10); then a reduced resumed run on the card against
    the CPU (phase_reference)."""
    for label, extra in CKPT_RUNS.items():
        _round_trip(label, extra)
        torch.cuda.empty_cache()

    d = _fresh_dir("launcher")
    argv = MAIN_PATH_ARGV + ["--checkpoint-dir", d, "--checkpoint-every", "5"]
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", *argv],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    if out.returncode != 0:
        fail(f"checkpoint: the launcher failed:\n{out.stdout}{out.stderr}")
    listing = sorted(os.listdir(d))
    print(f"checkpoint: python -m repro_torch.launch.train {' '.join(argv)}"
          f" ran in {time.perf_counter() - t0:.1f} s and left {listing}")
    if listing != ["step-10", "step-12", "step-5"]:
        fail(f"checkpoint: the launcher left {listing}")
    resume = _fresh_dir("resume")
    shutil.copytree(os.path.join(d, "step-5"), os.path.join(resume, "step-5"))
    shutil.rmtree(d)
    with open(os.path.join(resume, "step-5", "manifest.json")) as f:
        rec = next(r for r in json.load(f)["leaves"]
                   if r["name"] == "1::.inner::precond::.count")
    count = int(np.load(os.path.join(resume, "step-5", rec["file"])))
    steps = 12 - 5
    refreshes = sum(1 for c in range(count, count + steps) if c % 10 == 0)
    expected = dict(dict.fromkeys(COUNTERS, 0), batched_gram=8 * refreshes,
                    batched_lowrank_apply=8 * steps,
                    flash_attention=TRAIN_FLASH_PER_STEP * steps)
    buf = io.StringIO()
    _zero_counts()
    with contextlib.redirect_stdout(buf):
        log = train_lib.main(MAIN_PATH_ARGV + [
            "--checkpoint-dir", resume, "--checkpoint-every", "5",
            "--resume"])
    launches = _counts()
    printed = buf.getvalue()
    print(printed, end="")
    losses = [r["loss"] for r in log]
    print(f"checkpoint: resumed from step-5 (optimizer count {count}): "
          f"batches {[r['step'] for r in log]}, losses {losses}, launches "
          f"{launches}")
    if "resumed from step 5" not in printed:
        fail("checkpoint: the resumed launcher did not print 'resumed from "
             "step 5'")
    if count != 6 or [r["step"] for r in log] != list(range(5, 12)):
        fail(f"checkpoint: resumed at count {count} over batches "
             f"{[r['step'] for r in log]}")
    if not all(math.isfinite(x) for x in losses):
        fail(f"checkpoint: non-finite resumed loss: {losses}")
    if launches != expected:
        fail(f"checkpoint: resumed launches {launches}, expected {expected}")
    if sorted(os.listdir(resume)) != ["step-10", "step-12", "step-5"]:
        fail(f"checkpoint: the resumed launcher left "
             f"{sorted(os.listdir(resume))}")
    shutil.rmtree(resume)

    # a reduced checkpoint from the CPU, resumed on the card and the CPU
    reduced = _fresh_dir("reduced")
    train_lib.train(train_lib.parse_args(REFERENCE_ARGV + [
        "--second-moment-dtype", "fp32", "--device", "cpu",
        "--checkpoint-dir", reduced, "--checkpoint-every", "2"]))
    shutil.rmtree(os.path.join(reduced, "step-4"))
    phase_reference(dev, "fp32", resume_from=reduced)
    shutil.rmtree(CKPT_ROOT)
    print(f"checkpoint phase on: {smi}")


# the engine's spans (EngineConfig.profile_annotations)
SPANS = ("precond/update_stats", "precond/refresh", "precond/precondition",
         "precond/commit", "precond/refresh_launch")


def phase_span_profile(dev) -> None:
    """The async int8 run with ``--profile-annotations``: device and host
    time per engine span, in a plain step (1) and the refresh-launch step
    (10).  A span's device time is the device's busy time inside the
    device-side copy of its range (the profiler's user annotation, from its
    first kernel's start to its last's end: one stream, so no other range's
    kernels run there)."""
    from torch.autograd import DeviceType
    argv = MAIN_PATH_ARGV + ASYNC_INT8_ARGV + ["--profile-annotations"]
    run = train_lib.start(train_lib.parse_args(argv))
    labels = ("train/forward_backward", "train/optimizer") + SPANS
    for step in range(12):
        if step not in (1, 10):
            run.step(step)
            continue
        prof = _profiled(lambda: run.step(step),
                         f"async int8 step {step} with spans", labels)
        kernels = _device_intervals(prof, labels)
        for name in SPANS:
            host = [e for e in prof.events() if e.name == name
                    and e.device_type == DeviceType.CPU]
            windows = [e.time_range for e in prof.events() if e.name == name
                       and e.device_type == DeviceType.CUDA]
            dev_us = sum(_busy_us(kernels, w.start, w.end) for w in windows)
            print(f"  span {name}: device {dev_us / 1e3:.3f} ms over "
                  f"{len(windows)} device ranges, host "
                  f"{sum(e.cpu_time_total for e in host) / 1e3:.3f} ms over "
                  f"{len(host)} ranges")
    del run


# Tbl. 3's learners that sketch: each launches the single-block Gram
# (kernel 3) and apply (kernel 4) once a step, at each point of its grid
CONVEX_FD_LEARNERS = ("s-adagrad", "ada-fd", "fd-son", "rfd-son")


def phase_convex(dev) -> dict:
    """``repro_torch.launch.convex`` (Tbl. 3's streams and grid) on the card
    with every launch count set to 0 just before and read just after, then
    on the CPU: the 12 average losses agree within the CPU test's tolerance
    (tests/test_torch_oco.py: 1e-4, and FD-SON on the low-rank stream,
    chaotic, within a factor of 2), with the same ranks; kernels 3 and 4
    launch once per FD step and no other kernel launches."""
    from repro_torch.launch import convex
    args = convex.parse_args([])
    _zero_counts()
    t0 = time.perf_counter()
    card = convex.run(args)
    card_s = time.perf_counter() - t0
    launches = _counts()
    t0 = time.perf_counter()
    cpu = convex.run(convex.parse_args(["--device", "cpu"]))
    cpu_s = time.perf_counter() - t0
    steps = sum(card["steps"][name] for name in CONVEX_FD_LEARNERS)
    if steps < len(convex.KINDS) * args.T:
        fail(f"convex: only {steps} steps of the sketching learners")
    expected = dict(dict.fromkeys(COUNTERS, 0), gram=steps,
                    lowrank_apply=steps)
    if launches != expected:
        fail(f"convex: launches {launches}, expected {expected}")
    worst = 0.0
    for name, (value, rank) in ((k, v) for k, v in cpu.items()
                                if k not in ("launches", "steps")):
        got, got_rank = card[name]
        print(f"convex {name}: card {got!r} (rank {got_rank}), CPU {value!r}"
              f" (rank {rank})")
        if got_rank != rank:
            fail(f"convex {name}: card rank {got_rank}, CPU rank {rank}")
        if name == "tbl3_convex_lowrank_fd-son":
            if not value / 2 < got < value * 2:
                fail(f"convex {name}: card {got}, CPU {value}")
            continue
        worst = max(worst, abs(got - value))
        if not abs(got - value) <= 1e-4:
            fail(f"convex {name}: card {got}, CPU {value}")
    print(f"convex: card {card_s:.1f} s, CPU {cpu_s:.1f} s; launches "
          f"{launches}; steps {card['steps']} (CPU {cpu['steps']}); largest difference of the 11 held rows {worst:.2e}")
    return launches


def phase_serve(dev, argv: list) -> tuple[dict, dict]:
    """Serve with ``argv`` with every launch count set to 0 just before and
    read just after; returns (launches, the launcher's report)."""
    label = " ".join(argv)
    args = serve_lib.parse_args(argv)
    cfg = registry.get_reduced(args.arch) if args.reduced \
        else registry.get_config(args.arch)
    torch.cuda.reset_peak_memory_stats(dev)
    _zero_counts()
    t0 = time.perf_counter()
    report = serve_lib.serve(args)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts()
    peak = torch.cuda.max_memory_allocated(dev)
    handles = report["handles"]
    if not handles or not all(h.done and len(h.tokens)
                              == h.request.max_new_tokens for h in handles):
        fail(f"serve ({label}): not every request was served in full")
    head = report["params"][report["leaf"]]
    if not bool(torch.isfinite(head).all()):
        fail(f"serve ({label}): the adapted {report['leaf']} is not finite")
    steps = report["adapt_steps"]
    expected = dict(dict.fromkeys(COUNTERS, 0),
                    gram=len(report["observe_s"]) + steps,
                    lowrank_apply=steps,
                    **{k: report["gradients"] * v
                       for k, v in per_gradient(cfg).items()})
    if launches != expected:
        fail(f"serve ({label}): launches {launches}, expected {expected}")
    observe = sorted(report["observe_s"])
    adapt = sorted(report["adapt_step_s"])
    tokens = sum(len(h.tokens) for h in handles)
    print(f"serve ({label}): {len(handles)} requests, {tokens} tokens, "
          f"{steps} adaptation steps, {report['gradients']} feedback "
          f"gradients through {report['leaf']} (d = {head.numel()}), peak "
          f"memory allocated {peak} bytes, {wall:.1f} s")
    for what, times in (("monitor observe", observe),
                        ("adaptation step", adapt)):
        if times:
            print(f"serve {what} (s): median {times[len(times) // 2]:.6f}, "
                  f"min {times[0]:.6f}, max {times[-1]:.6f}, "
                  f"{len(times)} calls")
    lat = report["latencies_s"]
    print(f"serve inter-token latency (ms): p50 "
          f"{float(np.percentile(lat, 50)) * 1e3:.3f}, p99 "
          f"{float(np.percentile(lat, 99)) * 1e3:.3f} over {len(lat)} gaps")
    print(f"serve launches: {launches}")
    return launches, report


def phase_serve_reference(dev, arch: str = "paper-lm-100m") -> None:
    """Reduced serve run of ``arch`` with monitor and adaptation, same
    weights: card (kernels) vs CPU (plain)."""
    cfg = registry.get_reduced(arch)
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0))
    runs = {}
    for device in (dev, torch.device("cpu")):
        start = tree.unflatten(params, [p.to(device)
                                        for p in tree.flatten(params)])
        runs[device.type] = serve_lib.serve(serve_lib.parse_args(
            REDUCED_SERVE_ARGV + ["--arch", arch, "--device", str(device)]),
            start)
    card, cpu = runs["cuda"], runs["cpu"]
    steps = card["adapt_steps"]
    expected = dict(gram=len(card["observe_s"]) + steps,
                    lowrank_apply=steps,
                    **{k: card["gradients"] * v
                       for k, v in per_gradient(cfg).items()})
    if steps == 0 or card["launches"] != expected:
        fail(f"serve reference ({arch}): the card run launched "
             f"{card['launches']}, expected {expected} with at least one "
             f"adaptation step")
    if [h.tokens for h in card["handles"]] != \
            [h.tokens for h in cpu["handles"]]:
        fail(f"serve reference ({arch}): card and CPU greedy tokens differ")
    decisions = [[r.decision for r in run["readings"]]
                 for run in (card, cpu)]
    if decisions[0] != decisions[1]:
        fail(f"serve reference ({arch}): monitor decisions differ: "
             f"{decisions}")
    leaf = card["leaf"]
    got = card["params"][leaf].cpu()
    want = cpu["params"][leaf]
    worst = float(((got - want).abs() / want.abs().max()).max())
    print(f"serve reference ({arch}): {card['adapt_steps']} adaptation "
          f"steps, launches {card['launches']}, decisions {decisions[0]}, "
          f"{leaf} max diff {worst:.2e} of its largest magnitude")
    if not torch.allclose(got, want, rtol=SERVE_HEAD_RTOL,
                          atol=SERVE_HEAD_RTOL * float(want.abs().max())):
        fail(f"serve reference ({arch}): card and CPU adapted {leaf} "
             f"disagree")


def phase_moe_serve(dev) -> dict:
    """Phase 7c: MOE_SERVE_ARGV at full width through ``phase_serve``
    (deepseek-moe-16b: 28 flash attentions per feedback gradient, the
    untied head's gradient stopping at the head; the single-block Gram once
    an observation or adaptation step, the apply once an adaptation step;
    kernels 3, 4 and 7 each at least once), then the (token, expert)
    assignments that the moe layers dropped for capacity over the run's
    calls (decode: 4 lanes, capacity int(1.25 * 4 * 6 / 64) + 1 = 1; the
    feedback gradients' 64 tokens, capacity 8; counted around
    ``moe._slot_tables``), and the peak allocated and reserved beside the
    card's memory.  Returns the launch counts."""
    drops, slot_tables = [], moe_lib._slot_tables

    def counted(E, k, capacity, gate_w, gate_idx, T):
        out = slot_tables(E, k, capacity, gate_w, gate_idx, T)
        drops.append(T * k - (out[0] < T).sum())
        return out

    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated(dev)
    with mock.patch.object(moe_lib, "_slot_tables", counted):
        launches, report = phase_serve(dev, MOE_SERVE_ARGV)
    peak = torch.cuda.max_memory_allocated(dev)
    reserved = torch.cuda.max_memory_reserved(dev)
    total = torch.cuda.get_device_properties(dev).total_memory
    print(f"serve (deepseek-moe-16b): peak allocated {peak} B, peak "
          f"reserved {reserved} B, of the card's {total} B: headroom "
          f"{total - reserved} B beyond the peak reserved")
    dropped = int(sum(drops))
    for name in ("gram", "lowrank_apply", "flash_attention"):
        if launches[name] == 0:
            fail(f"serve (deepseek-moe-16b): {name} was never launched")
    print(f"serve (deepseek-moe-16b): {held} bytes allocated before the "
          f"phase (in its peak); {dropped} (token, expert) "
          f"assignments dropped for capacity over the run's moe calls; "
          f"kernel 3 (gram) {launches['gram']}, kernel 4 (lowrank_apply) "
          f"{launches['lowrank_apply']}, kernel 7 (flash_attention) "
          f"{launches['flash_attention']} launches")
    del report
    torch.cuda.empty_cache()
    return launches


def phase_dense_full(dev, arch: str, layers) -> dict:
    """Phase 7d: ``arch`` at full width (``layers`` of its layers when not
    None, the rest cut), bf16, seeded weights: the serving engine's
    one-shot demo (4 requests of 8-token prompts, 8 new tokens each, as
    ``launch.serve`` without traffic), then one feedback gradient of the
    loss with respect to the head leaf (``lm_head``, or the tied ``embed``)
    at B 4, S 512, after one call that warms up, DENSE_FULL_CALLS calls
    timed with CUDA events (median, min, max), with the flash kernel's
    launches counted over them (``per_gradient`` each) and no other kernel.
    Every token, logit and gradient value must be finite and the loss
    near log(V) (random weights).  Returns the launch counts."""
    from repro_torch.serve import Engine, Request, ServeConfig
    cfg = registry.get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    label = f"{arch}" + (f", {layers} of its layers" if layers else "")
    torch.cuda.reset_peak_memory_stats(dev)
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = sum(p.numel() for p in tree.flatten(params))
    engine = Engine(cfg, params, ServeConfig(batch=4, max_seq=64, seed=0))
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    handles = [engine.submit(Request(
        prompt=rng.integers(0, cfg.vocab_size, size=(8,), dtype=np.int32),
        max_new_tokens=8)) for _ in range(4)]
    engine.drain()
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    if not all(h.done and len(h.tokens) == 8 for h in handles):
        fail(f"dense full width ({label}): not every request was served")
    del engine
    batch = _full_batch(cfg, dev, seed=1)
    report, launches = _head_gradients(f"dense full width ({label})", cfg,
                                       params, batch)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"dense full width ({label}; hd {cfg.head_dim}, {n_params} bf16 "
          f"parameters): 4 requests x 8 tokens in {serve_s:.2f} s; "
          f"{report}; peak memory allocated {peak} bytes")
    del params
    torch.cuda.empty_cache()
    return launches


def _full_batch(cfg, dev, seed: int) -> dict:
    """The pipeline's batch 0 at DENSE_FULL_BATCH x DENSE_FULL_SEQ on the
    card: tokens (B, S) or (B, S, K), or the vlm's f32 embeddings, as
    launch.train draws them."""
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    data = SyntheticLM(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=DENSE_FULL_SEQ,
        global_batch=DENSE_FULL_BATCH, seed=seed,
        num_codebooks=cfg.num_codebooks,
        embed_dim=0 if cfg.embed_inputs else cfg.d_model))
    return {k: torch.from_numpy(v).to(dev, torch.float32 if v.dtype.kind
                                      == "f" else torch.long)
            for k, v in data.batch(0).items()}


def _head_gradients(label: str, cfg, params: dict, batch: dict
                    ) -> tuple[str, dict]:
    """Feedback gradients of the loss with respect to the head leaf
    (``lm_head``, or the tied ``embed``) on ``batch``: one call that warms
    up, then DENSE_FULL_CALLS timed with CUDA events, with every kernel's
    launches counted over them (``per_gradient`` each of kernels 7 and 8,
    no other).  Fails unless the loss is finite and near log(V) (random
    weights) and the gradient finite.  Returns a report line and the
    launch counts."""
    leaf = "lm_head" if "lm_head" in params else "embed"
    times = []
    for i in range(1 + DENSE_FULL_CALLS):   # the first call warms up
        if i == 1:
            _zero_counts()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        head = params[leaf].detach().requires_grad_(True)
        loss = model_lib.loss_fn(cfg, dict(params, **{leaf: head}), batch)
        (g,) = torch.autograd.grad(loss, [head])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    launches = _counts()
    expected = dict(dict.fromkeys(COUNTERS, 0), **{
        k: DENSE_FULL_CALLS * v for k, v in per_gradient(cfg).items()})
    if launches != expected:
        fail(f"{label}: launches {launches}, expected {expected}")
    loss = float(loss.detach())
    finite = bool(torch.isfinite(g).all())
    if not (math.isfinite(loss) and finite
            and abs(loss - math.log(cfg.vocab_size)) < 3.0):
        fail(f"{label}: loss {loss}, gradient finite {finite}")
    return (f"feedback gradient through {leaf} at B {DENSE_FULL_BATCH}, S "
            f"{DENSE_FULL_SEQ}: median {statistics.median(times[1:]):.1f} "
            f"ms over {DENSE_FULL_CALLS} calls (CUDA events; min "
            f"{min(times[1:]):.1f}, max {max(times[1:]):.1f}; first call "
            f"{times[0]:.1f} ms), loss {loss:.4f}, flash_attention "
            f"{launches['flash_attention']} launches in the "
            f"{DENSE_FULL_CALLS} calls"), launches


# a forward batch's input key -> the decode step's (models/cache.py)
DECODE_KEY = {"tokens": "token", "embeds": "embed"}


def _model_inputs(cfg, rng, B: int, S: int) -> tuple[str, torch.Tensor]:
    """Inputs for ``cfg``'s own family, with their forward batch key:
    tokens (B, S), tokens (B, S, K) with K codebooks, or f32 embeddings
    (B, S, D) without ``embed_inputs``."""
    if not cfg.embed_inputs:
        return "embeds", torch.from_numpy(
            (rng.normal(size=(B, S, cfg.d_model)) * 0.1).astype(np.float32))
    shape = (B, S, cfg.num_codebooks) if cfg.num_codebooks else (B, S)
    return "tokens", torch.from_numpy(
        rng.integers(0, cfg.vocab_size, size=shape))


def phase_new_arch_reference(dev, arch: str) -> None:
    """Phase 8c: the reduced ``arch`` (each of NEW_ARCHS) on the card
    (kernels) and on the CPU (plain versions) from the same weights, on
    its family's own inputs (``_model_inputs``): the forward's logits and a
    teacher-forced decode within 1e-4 (f32), the card's decode within 1e-4
    of its forward, and one Sketchy step through ``launch.train``
    (NEW_ARCH_ARGV: rank 8, block 32, a refresh at the step): the same
    loss (relative 1e-4) and parameters (1e-3 relative, 1e-4 absolute).
    The card's forward launches kernel 7 once a layer."""
    cfg = registry.get_reduced(arch)
    params = model_lib.init_params(cfg, torch.Generator().manual_seed(0))
    key, inputs = _model_inputs(cfg, np.random.default_rng(1), 2, 10)
    out = {}
    for device in (dev, torch.device("cpu")):
        p = tree.unflatten(params, [x.to(device)
                                    for x in tree.flatten(params)])
        _zero_counts()
        with torch.no_grad():
            logits = model_lib.forward(cfg, p, {key: inputs.to(device)})
        flash = _counts()["flash_attention"]
        if device.type == "cuda" and flash != cfg.num_layers:
            fail(f"new arch reference ({arch}): {flash} flash launches in "
                 f"the forward, expected {cfg.num_layers}")
        c = cache_lib.init_cache(cfg, 2, 16, device=device)
        steps = [cache_lib.decode_step(cfg, p, c, {
            DECODE_KEY[key]: inputs[:, t:t + 1].to(device)}, t)[0]
            for t in range(inputs.shape[1])]
        run, log = train_lib.train(train_lib.parse_args(
            NEW_ARCH_ARGV + ["--arch", arch, "--device", str(device)]), p)
        out[device.type] = (logits.cpu(), torch.cat(steps, 1).cpu(),
                            log[0]["loss"], [x.detach().cpu() for x in
                                             tree.flatten(run.params)])
        del run
    (lc, dc, loss_c, pc), (l0, d0, loss_0, p0) = out["cuda"], out["cpu"]
    diffs = [float((a - b).abs().max()) for a, b in ((lc, l0), (dc, d0),
                                                     (dc, lc))]
    worst = max(float(((a - b).abs() - 1e-3 * b.abs()).max())
                for a, b in zip(pc, p0))
    print(f"new arch reference ({arch}): logits card - CPU {diffs[0]:.2e}, "
          f"decode card - CPU {diffs[1]:.2e}, card decode - forward "
          f"{diffs[2]:.2e}; Sketchy step loss {loss_c:.6f} / {loss_0:.6f}, "
          f"parameters over 1e-3 relative by at most {worst:.2e}")
    for (a, b), name in zip(((lc, l0), (dc, d0), (dc, lc)),
                            ("logits", "decode", "card decode vs forward")):
        if not torch.allclose(a, b, rtol=1e-4, atol=1e-4):
            fail(f"new arch reference ({arch}): {name} disagree")
    if abs(loss_c - loss_0) > 1e-4 * abs(loss_0) or worst > 1e-4:
        fail(f"new arch reference ({arch}): the Sketchy step disagrees")


@contextlib.contextmanager
def _cut_depth(layers: int):
    """``registry.get_config`` returning configs cut to ``layers`` layers,
    their widths kept: how phase 9a cuts the depth of what
    ``launch.train`` builds, which has no depth flag (nor has the
    reference's)."""
    get = registry.get_config
    with mock.patch.object(registry, "get_config", lambda name: dataclasses
                           .replace(get(name), num_layers=layers)):
        yield


@contextlib.contextmanager
def _expandable_segments():
    """The caching allocator with expandable segments for phase 9a only:
    qwen2-vl-72b's refresh frees (2,032, 1088, 1088) f32 stacks of 9.6 GB,
    the grafting then asks for 5 GB tensors, and with whole segments 15.7
    GiB stayed reserved but unusable and the step ran out of memory (PERF.md
    §6).  The cached segments are released on the way in and out, so the
    phases before and after run on the allocator's defaults."""
    torch.cuda.empty_cache()
    torch.cuda.memory._set_allocator_settings("expandable_segments:True")
    try:
        yield
    finally:
        torch.cuda.empty_cache()
        torch.cuda.memory._set_allocator_settings("expandable_segments:False")


def phase_train_full(dev, arch: str, layers: int, groups: int,
                     second_moment_bytes: int) -> dict:
    """Phase 9a: ``arch`` trained at full width with ``layers`` of its
    layers through ``repro_torch.launch.train`` (TRAIN_FULL_ARGV: Sketchy
    at the launcher's defaults, 3 steps, the peak lr of TRAIN_FULL_LR),
    under ``_expandable_segments``, every launch count set to 0 just before
    and read just after: the refresh at count 0 launches kernel 1 once a
    side of each of the ``groups`` pool groups, kernel 2 twice a group
    every step, kernel 7 twice a layer every step (the forward and the
    remat recompute); no other kernel.  Each ``eigh`` call is timed on the
    host clock between two synchronizations.  Fails unless every loss is
    finite and near log(V) (random weights; musicgen's averages its 4
    codebooks), the last step's loss is below the first's, every weight
    matrix moved and no leaf by more than the grafted step allows, the loss
    of batch 0 under the trained weights is below step 0's (the same batch
    before any update), and the second-moment bytes are the reference's.
    Prints the step times, ``eigh``'s, the peak memory allocated and
    reserved, the losses, the updates' sizes and the bytes; returns the
    launch counts with the peaks."""
    label = f"train full width ({arch}, {layers} of its layers)"
    args = train_lib.parse_args(TRAIN_FULL_ARGV + [
        "--arch", arch, "--lr", TRAIN_FULL_LR[arch]])
    cfg = dataclasses.replace(registry.get_config(arch), num_layers=layers)
    eigh, eighs = fd_lib._eigh, []

    def timed_eigh(C):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = eigh(C)
        torch.cuda.synchronize(dev)
        eighs.append((C.shape[0], time.perf_counter() - t0))
        return out

    with _expandable_segments():
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_counts()
        with _cut_depth(layers), mock.patch.object(fd_lib, "_eigh",
                                                   timed_eigh):
            run, log = train_lib.train(args)
        launches = _counts()
        peak = torch.cuda.max_memory_allocated(dev)
        reserved = torch.cuda.max_memory_reserved(dev)
        nbytes = api.second_moment_bytes(run.opt_state)
        run.opt_state = None
        with torch.no_grad():
            trained_loss = float(model_lib.loss_fn(cfg, run.params,
                                                   run.batch(0)))
        # the seeded initialization again, leaf by leaf against the
        # trained weights: the RMS of each leaf's update over 3 steps, and
        # which leaves are weight matrices (two dims a layer or more)
        init = model_lib.init_params(cfg, torch.Generator(
            device=dev).manual_seed(args.seed), device=dev)
        leaves = tree.flatten(run.params)
        stacked = {id(p) for p in tree.flatten(run.params["layers"])}
        matrix = [p.dim() - (id(p) in stacked) >= 2 for p in leaves]
        updates = [float(torch.linalg.vector_norm((a - b).detach().float()))
                   / math.sqrt(a.numel())
                   for a, b in zip(leaves, tree.flatten(init))]
        n_params = sum(p.numel() for p in leaves)
        del run, init, leaves
    steps = TRAIN_FULL_STEPS
    expected = dict(dict.fromkeys(COUNTERS, 0), batched_gram=2 * groups,
                    batched_lowrank_apply=2 * groups * steps,
                    flash_attention=2 * layers * steps)
    losses = [r["loss"] for r in log]
    log_v = math.log(cfg.vocab_size)
    print(f"{label}: {n_params} bf16 parameters, lr {args.lr}; step times "
          f"(s) {[r['time_s'] for r in log]} (refresh at step 0); eigh "
          f"{[f'{n} matrices in {t:.3f} s' for n, t in eighs]}; losses "
          f"{losses} (log V {log_v:.4f}); batch 0 after the run "
          f"{trained_loss} (step 0: {losses[0]}); update RMS per leaf "
          f"{min(updates):.3e}-{max(updates):.3e}, {updates.count(0.0)} of "
          f"{len(updates)} leaves unmoved ({sum(matrix)} weight matrices, "
          f"all moved); peak memory allocated "
          f"{peak} B, reserved {reserved} B of "
          f"{torch.cuda.get_device_properties(dev).total_memory} B; "
          f"second-moment bytes {nbytes}; launches {launches}")
    if not all(math.isfinite(x) and abs(x - log_v) < 3.0 for x in losses):
        fail(f"{label}: losses {losses}, log V {log_v}")
    if not losses[-1] < losses[0]:
        fail(f"{label}: the loss did not fall, {losses}")
    # a vector leaf may stay: in bf16 an update under half the spacing of
    # its entries rounds away (the stacked norm scales and biases are drawn
    # at unit scale, as the reference draws them), and the key bias has no
    # gradient (the softmax ignores a shift shared by every key)
    if not all(u > 0.0 for u, m in zip(updates, matrix) if m):
        fail(f"{label}: a weight matrix never moved, {updates}")
    # each block's direction has the norm of its grafted RMSProp direction,
    # whose entries are at most 1/sqrt(1 - beta2) in size; the EMA momentum
    # at step t keeps 1 - beta1^t of that; weight decay (1e-4 of weights
    # near 1 at most) adds under 1 %.  A larger RMS means the
    # initialization drawn again is not the run's.
    opt = OptimizerConfig()
    most = 1.01 * args.lr * sum(1 - opt.beta1 ** t for t in range(
        1, steps + 1)) / math.sqrt(1 - opt.beta2)
    if not max(updates) < most:
        fail(f"{label}: an update's RMS {max(updates)} is over {most}")
    if not trained_loss < losses[0]:
        fail(f"{label}: batch 0's loss {trained_loss} after the run, "
             f"{losses[0]} before")
    if launches != expected:
        fail(f"{label}: launches {launches}, expected {expected}")
    if nbytes != second_moment_bytes:
        fail(f"{label}: second-moment bytes {nbytes}, expected "
             f"{second_moment_bytes}")
    return dict(launches, peak=peak, reserved=reserved)


def phase_vlm_audio_full(dev, arch: str, layers) -> dict:
    """Phase 9b: ``arch`` at full width (``layers`` of its layers when not
    None), bf16, seeded weights, through ``model_lib`` and ``cache_lib``
    (the serving engine refuses these archs, as the reference's does): a
    forward at DENSE_FULL_BATCH x DENSE_FULL_SEQ on the pipeline's inputs
    (``_full_batch``: the vlm's embeddings, musicgen's (B, S, 4) tokens;
    the launcher's seed, so the vlm's 4.98 GB embeddings table drawn in
    phase 9a is drawn once), finite; a teacher-forced decode of its first
    VLM_AUDIO_DECODE positions against the forward's logits within
    DECODE_BF16_RTOL of their norm; then the feedback gradients of phase 7d
    (``_head_gradients``).  Returns the gradients' launch counts."""
    cfg = registry.get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    label = f"vlm/audio full width ({arch}" + (
        f", {layers} of its layers)" if layers else ")")
    torch.cuda.reset_peak_memory_stats(dev)
    params = model_lib.init_params(
        cfg, torch.Generator(device=dev).manual_seed(0), device=dev)
    n_params = sum(p.numel() for p in tree.flatten(params))
    batch = _full_batch(cfg, dev, seed=train_lib.parse_args([]).seed)
    key = "embeds" if "embeds" in batch else "tokens"
    _zero_counts()
    with torch.no_grad():
        logits = model_lib.forward(cfg, params, batch)
    torch.cuda.synchronize()
    flash = _counts()["flash_attention"]
    B, S = batch["labels"].shape[:2]
    if tuple(logits.shape) != tuple(batch["labels"].shape) + (
            cfg.vocab_size,) or not bool(torch.isfinite(logits).all()) \
            or flash != cfg.num_layers:
        fail(f"{label}: forward logits {tuple(logits.shape)}, finite "
             f"{bool(torch.isfinite(logits).all())}, flash launches {flash}")
    n = VLM_AUDIO_DECODE
    want = logits[:, :n].float()
    del logits
    cache = cache_lib.init_cache(cfg, B, n, device=dev)
    t0 = time.perf_counter()
    got = torch.cat([cache_lib.decode_step(
        cfg, params, cache, {DECODE_KEY[key]: batch[key][:, t:t + 1]}, t)[0]
        for t in range(n)], 1).float()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    del cache
    err = got - want
    rel = float(err.norm() / want.norm())
    same_top = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"{label}: teacher-forced decode of {n} positions vs the forward "
          f"at B {B}, S {S}: relative error {rel:.3e} (tolerance "
          f"{DECODE_BF16_RTOL}), max abs diff {float(err.abs().max()):.3e} "
          f"of logits up to {float(want.abs().max()):.3e}, same argmax "
          f"{same_top:.4f}; {n} steps in {decode_s:.2f} s")
    if not rel <= DECODE_BF16_RTOL:
        fail(f"{label}: decode disagrees with the forward")
    del got, want, err
    report, launches = _head_gradients(label, cfg, params, batch)
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"{label} ({n_params} bf16 parameters; hd {cfg.head_dim}): "
          f"{report}; peak memory allocated {peak} bytes")
    del params, batch
    torch.cuda.empty_cache()
    return launches


def start_table_draws() -> list:
    """Start drawing the embeddings table of every TRAIN_FULL arch that
    takes embeddings (qwen2-vl-72b's 1.25 G normals, tens of seconds on
    the host) in a thread, to run beside the kernel build, before any phase
    is timed; ``data.pipeline.embedding_table`` keeps it for phases 9a and
    9b.  Returns the threads."""
    from repro_torch.data import pipeline as data_lib
    seed = train_lib.parse_args([]).seed
    draws = []
    for arch, *_ in TRAIN_FULL:
        cfg = registry.get_config(arch)
        if not cfg.embed_inputs:
            draws.append(threading.Thread(
                target=data_lib.embedding_table,
                args=(seed, cfg.vocab_size, cfg.d_model),
                name=f"{arch}'s embeddings table ({cfg.vocab_size} x "
                     f"{cfg.d_model} f32)"))
            draws[-1].start()
    return draws


def lap(t0: float):
    """``done(phase)`` prints the seconds since ``t0`` as ``phase`` ends:
    where the script's time goes."""
    def done(phase: str) -> None:
        print(f"[{time.perf_counter() - t0:.1f} s] phase {phase} done")
    return done


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    draws = start_table_draws()
    build.build_all()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for draw in draws:
        draw.join()
        print(f"{draw.name} drawn beside the build, on the host: ready "
              f"{time.perf_counter() - t0:.1f} s after the build started")
    # kernels 1, 5, 7, 6, 8, 2 and 2'
    for lib in ("gram", "flash", "project_quantize", "ssd", "lowrank"):
        for fn, regs, smem, spill_st, spill_ld in build.resources(lib):
            print(f"{lib}: {fn}: {regs} registers, {smem} B static shared "
                  f"memory, spills {spill_st} B stored / {spill_ld} B "
                  f"loaded")
    done = lap(t0)
    done("1")

    kernels = phase_kernels(dev)
    phase_shampoo_grams(dev, torch.Generator(device=dev).manual_seed(3))
    phase_merge_grams(dev, torch.Generator(device=dev).manual_seed(4))
    phase_merge_grams(dev, torch.Generator(device=dev).manual_seed(5),
                      shrink_merge_gram_shapes(), "shrink merge")
    phase_eigh(dev)
    phase_shampoo_eigh(dev)
    done("2, 3")
    tuned = phase_tune(dev, smi)
    done("2t")
    none = dict.fromkeys(COUNTERS, 0)
    flash = dict(flash_attention=12 * TRAIN_FLASH_PER_STEP)
    fp32 = phase_main_path(dev, MAIN_PATH_ARGV, dict(
        none, batched_gram=16, batched_lowrank_apply=96, **flash),
        save_to=MESH_STATE)
    int8 = phase_main_path(dev, MAIN_PATH_ARGV + INT8_ARGV, dict(
        none, batched_gram_mixed=16, batched_project_quantize=16,
        batched_lowrank_apply_int8=96, **flash), INT8_SECOND_MOMENT_BYTES)
    # Shampoo's L and R: kernel 1 on 4 groups x 2 sides every step
    shampoo = phase_main_path(dev, MAIN_PATH_ARGV + SHAMPOO_ARGV, dict(
        none, batched_gram=12 * 8, **flash), SHAMPOO_SECOND_MOMENT_BYTES)
    phase_main_path(dev, MAIN_PATH_ARGV + ADAM_ARGV, dict(none, **flash),
                    ADAM_SECOND_MOMENT_BYTES)
    # the refresh schedules, modes and the rank budget: staggered, the Grams
    # at count 0 for all 4 groups (8), then 2 for each group with a due
    # block at counts 1-11 (3 groups x 11 + the 12x768 group at counts 9
    # and 10: 70); the applies as ever
    phase_main_path(dev, MAIN_PATH_ARGV + STAGGERED_ARGV, dict(
        none, batched_gram=78, batched_lowrank_apply=96, **flash),
        FP32_SECOND_MOMENT_BYTES)
    async_int8 = phase_main_path(dev, MAIN_PATH_ARGV + ASYNC_INT8_ARGV, dict(
        none, batched_gram_mixed=16, batched_project_quantize=16,
        batched_lowrank_apply_int8=96, **flash), INT8_SECOND_MOMENT_BYTES)
    print(f"peak memory allocated, int8 storage: async {async_int8['peak']} "
          f"B, inline {int8['peak']} B")
    phase_main_path(dev, MAIN_PATH_ARGV + BUDGET_ARGV, dict(
        none, batched_gram_mixed=78, batched_project_quantize=78,
        batched_lowrank_apply_int8=96, **flash), INT8_SECOND_MOMENT_BYTES,
        check_budget)
    # Shampoo's L and R every step whatever the schedule
    phase_main_path(dev, MAIN_PATH_ARGV + SHAMPOO_STAGGERED_ASYNC_ARGV, dict(
        none, batched_gram=12 * 8, **flash), SHAMPOO_SECOND_MOMENT_BYTES)
    print(f"Shampoo's main path: kernel 1 (batched_gram) launched "
          f"{shampoo['batched_gram']} times over 12 steps (8 a step), "
          f"flash attention {shampoo['flash_attention']}")
    done("4")
    phase_microbatch(dev)
    done("4m")
    phase_sharded(dev)
    phase_sharded_reference(dev)
    done("4s")
    mesh = phase_mesh(dev)
    done("4d")
    for argv in (MAIN_PATH_ARGV, MAIN_PATH_ARGV + INT8_ARGV,
                 MAIN_PATH_ARGV + SHAMPOO_ARGV, MAIN_PATH_ARGV + ADAM_ARGV):
        phase_profile(dev, argv)
    phase_span_profile(dev)
    done("5")
    phase_reference(dev, "fp32")
    phase_reference(dev, "int8")
    phase_reference(dev, "fp32", "shampoo")
    phase_reference(dev, "int8", "shampoo")
    phase_reference(dev, "fp32", "adam")
    phase_reference(dev, "fp32", extra=STAGGERED_ARGV)
    phase_reference(dev, "int8", extra=("--refresh-mode", "async"))
    phase_reference(dev, "fp32", extra=REDUCED_BUDGET_ARGV)
    phase_reference(dev, "fp32", "shampoo",
                    SHAMPOO_STAGGERED_ASYNC_ARGV[len(SHAMPOO_ARGV):])
    phase_async_equality(dev)
    done("6")
    phase_checkpoint(dev, smi)
    done("6a")
    phase_convex(dev)
    done("6b")
    served = phase_serve(dev, SERVE_ARGV)[0]
    adapted = phase_serve(dev, ADAPT_ARGV)[0]
    if served["gram"] == 0:
        fail("serve: the monitored run launched no single-block Gram")
    if adapted["lowrank_apply"] == 0:
        fail("serve: the adapting run launched no single-block apply")
    phase_serve_profile(dev)
    phase_serve_reference(dev)
    done("7, 8")
    zamba, report = phase_serve(dev, ZAMBA_SERVE_ARGV)
    for name in ("gram", "lowrank_apply", "flash_attention", "ssd_scan"):
        if zamba[name] == 0:
            fail(f"serve (zamba2-7b): {name} was never launched")
    params = report["params"]
    del report
    phase_zamba_gradient_profile(dev, params)
    del params
    torch.cuda.empty_cache()
    phase_serve_reference(dev, "zamba2-7b")
    phase_serve_reference(dev, "mamba2-370m")
    done("7b, 8b")
    moe = phase_moe_serve(dev)
    done("7c")
    dense = {arch: phase_dense_full(dev, arch, layers)
             for arch, layers in DENSE_FULL}
    done("7d")
    for arch in NEW_ARCHS:
        phase_new_arch_reference(dev, arch)
    done("8c")
    trained = {arch: phase_train_full(dev, arch, *rest)
               for arch, *rest in TRAIN_FULL}
    done("9a")
    vlm_audio = {arch: phase_vlm_audio_full(dev, arch, layers)
                 for arch, layers in VLM_AUDIO_FULL}
    done("9b")
    phase_dryrun(dev)
    done("10")

    hd256 = kernels.pop("flash_attention_hd256")
    for name in kernels:
        kernels[name]["launches"] = fp32[name] or int8[name]
    kernels["gram"]["launches"] = served["gram"]
    kernels["lowrank_apply"]["launches"] = adapted["lowrank_apply"]
    kernels["flash_attention"]["launches"] = zamba["flash_attention"]
    kernels["ssd_scan"]["launches"] = zamba["ssd_scan"]
    kernels["flash_attention_hd256"] = dict(
        hd256, launches=dense["gemma-2b"]["flash_attention"])
    print(f"phase 4d: kernel 1 (batched_gram) {mesh['merge_grams']} "
          f"launches in the shrink merge; kernel 7 (flash_attention) "
          f"{mesh['flash_attention']} a rank in the expert-parallel run")
    print(f"deepseek-moe-16b serving: flash_attention "
          f"{moe['flash_attention']}, gram {moe['gram']} launches")
    for arch in trained:
        print(f"{arch} trained at full width: {trained[arch]}; its "
              f"feedback gradients: flash_attention "
              f"{vlm_audio[arch]['flash_attention']}")
    for row, (default, best) in sorted(tuned.items()):
        print(f"kernel {row} at the main path's shapes, a step's calls: "
              f"default {default:.4f} ms, tuned {best:.4f} ms")
    print(smi)
    print(json.dumps({"kernels": list(kernels.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--reduced-rank"]:
        sys.exit(reduced_rank(*sys.argv[2:]))
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(*sys.argv[2:]))
    sys.exit(main())
