#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py [--seed N] [--nccl-only]

(``--nccl-only``, on two or more cards: the build and phase 10 alone.)

1. environment: the card's name and power limit, torch and CUDA
   versions; every kernel is built from the sources in this checkout
   (``nvcc``, one process per source, all started together);
2. kernel phase: each hand-written kernel against its plain PyTorch
   version on the card, at its path's shapes and a few more, with the
   stated tolerances, and timed (CUDA events, L2 flushed before each
   launch, median) beside the least time the card could take (H100 SXM
   data-sheet rates; the SMs' exponential rate for the scans); the paged
   kernel at the serving shape and at two long-context decode shapes
   (``minicpm-2b`` and ``yi-34b``, rows of 253 ... 4096 tokens) and a
   GQA 32/8 shape, with its split plan, registers, blocks per SM, waves
   and a ``torch.sum`` over the same K and V bytes; its bf16 output is
   held element by element to the float32 plain output, a check shown
   to reject three deliberate faults of the split and merge;
   ``matmul_tiled`` and ``flash_attention`` show which variant each case
   ran (the TMA + wgmma one for bf16 at aligned shapes / D 64 and 128),
   and the earlier kernel is timed beside the new one at the main shape;
3. serve phase: ``minicpm-2b`` at its published width (40 layers, bf16,
   random weights from ``--seed``) through ``ContinuousBatchingServer``:
   16 requests over 4 shared system prompts, 64 greedy tokens each.  The
   launch counts show the decode path went through the kernels, and one
   mid-run decode step (its state copied during the run, replayed after
   it) is held against the plain attention path and profiled;
4. train phase: ``falcon-mamba-7b`` at its published width with 8 of its
   64 layers (bf16, random weights from ``--seed``), 5 steps of batch
   2 x 4096 tokens through ``make_train_step`` on the scan kernels: loss
   per step, step time, tokens/s, peak memory, launch counts, and one
   step profiled;
5. route check: one train step of a float32 2-layer falcon-mamba-7b at
   full width (S = 1024) through the scan kernels and through the plain
   chunked scan, from the same weights and batch;
6. prefill + decode: prompts through ``prefill`` (the forward-only scan
   kernel), 8 greedy decode steps, each step's logits held against the
   teacher-forced forward;
7. collective phase: the CollectiveEngine on P = 8 ``LocalComm`` ranks
   (threads) on the one card: every algorithm the engine knows for
   reduce, allreduce, reduce_scatter, allgather, broadcast and
   all_to_all, and ``"auto"``, at 4 KB, 256 KB, 4 MB and 64 MB per rank;
   float32 integer-valued inputs bitwise equal to the sum over ranks,
   bfloat16 within 5e-2 of it.  ``auto``'s decisions are printed with
   their prices on the reference's TPU fabric model;
8. 2D collective phase: the same 8 ranks as the reference's multi-device
   grids, 2 x 4 over (pod, data) and 2 x 2 x 2 over (pod, data) and
   (pod, data, model): ``allreduce_multi`` (the paper's X-Y and Snake
   AllReduces among the plan shapes), ``reduce_scatter_multi``,
   ``allgather_multi`` and ``all_to_all_multi`` under every plan shape
   the planner offers there and ``auto``, at 4 KB, 256 KB and 16 MB per
   rank; float32 integer-valued inputs bitwise equal to the exact
   result, bf16 bitwise equal to the same op on CPU ranks up to 256 KB
   and within one bf16 ulp per add at 16 MB; ``auto``'s plans with their
   TPU-model prices, the engine's plan hits and misses, host walls;
9. fused ring phase: ``fused_matmul_reduce_scatter`` for the TP-8
   down-projection of ``yi-34b`` at its published widths (d_ff 20480,
   d_model 7168, batch 2 x 4096 tokens, bf16) on 8 local ranks: 64
   ``matmul_tiled`` launches, all of the wgmma variant, each rank's block
   against the gathered
   path and a sampled slice against a float64 product, and one backward
   through ``matmul_tiled``;
10. NCCL phase, only with two or more cards: one ``ProcessGroupComm``
   rank per card repeats the float32 collective checks and the fused
   ring, and with four or more ``allreduce_multi`` over a 2 x (cards /
   2) ``ProcessGroupGrid`` as 2d_xy, 2d_snake and hierarchical; then the
   DP trainer under ``torch.distributed.run`` on two cards (run last);
11. dense train phase: ``minicpm-2b`` at its published width and depth
   (40 layers, bf16, random weights from ``--seed``), 5 WSD steps of
   batch 2 x 4096 tokens through ``make_train_step``, every layer's
   attention (forward and remat recompute) in the flash kernel's wgmma
   variant: loss per step, step time, tokens/s, peak memory, launch
   counts, one step profiled;
12. dense route checks: one float32 train step of a 2-layer minicpm-2b at
   full width (1 x 4096 tokens) through the flash kernel and through the
   plain chunked attention, from the same weights and batch; then the
   same for phi3-mini-3.8b (head dim 96) and mistral-nemo-12b (160);
13. dense prefill + decode: 2 x 4096-token prompts through ``prefill`` at
   full depth (one wgmma flash launch per layer), the cache padded by 8
   positions, 8 greedy ``decode_step``s, each step's logits held against
   the teacher-forced forward;
14. data-parallel train phase: ``minicpm-2b`` at its published width
   with 2 of its 40 layers on a 2 x 2 (pod, data) grid of rank threads,
   1 x 4096 tokens a rank, 3 bf16 steps of ``make_train_step(grad_sync=
   GradSyncConfig(...))`` in each sync mode (bucketed allreduce, fsdp,
   fsdp fused): the memory reckoned first, then the loss, step wall,
   tokens/s, peak memory, the per-bucket plans, the engine's plan hits
   and misses and the flash launches (2 a layer a rank a step, wgmma);
   then two float32 steps at 1 layer of each mode held to the plain
   single-rank steps on the same global batches: each step's loss and
   grad_norm, and every parameter after the second step;
15. tensor-parallel decode phase: ``minicpm-2b`` at full width, 2
   layers, on 8 model-rank threads with ``set_fused_tp(True)``: 2 x 4096
   prompts through the fused down-projection (8 wgmma ``matmul_tiled``
   launches a rank a layer), the cache cut into sequence blocks, 8 greedy
   steps through ``flash_decode``: the tokens identical to the
   single-rank route and the logits within 2 bf16 ulps;
16. MoE serve phase: ``olmoe-1b-7b`` at its published width and depth
   (16 layers, 64 experts, top 8, bf16, random weights from ``--seed``)
   through the server with the serve phase's 16 requests: tok/s, TTFT,
   16 paged launches a decode step, a mid-run decode step held to the
   plain path and repeated bitwise, profiled beside the step's bound
   (every expert's weights read once);
17. MoE train phase: ``olmoe-1b-7b`` at full width with 8 of its 16
   layers, 2 x 4096 tokens, remat, 5 AdamW steps (loss, aux, step wall,
   tok/s, peak memory against the reckoning, 16 wgmma flash launches a
   step, one step profiled); then ``dense_route_phase`` at
   ``olmoe-1b-7b`` (float32, 2 layers, 1 x 4096, kernel vs plain);
18. EP forward phase: ``moe_ffn_ep`` at ``olmoe-1b-7b``'s full width, 2
   layers' MoE FFNs, 8 x 1024 tokens on 8 rank threads as 2 x 4 over
   (data, model) and over (pod, data), algorithm lax / auto /
   hierarchical / flat, float32 and bf16, against the single-rank
   ``moe_ffn`` (forward only: ROADMAP C15): the all-to-all plans, the
   engine's plan hits and misses, 16 or 8 experts a rank;
19. DP serve phase: ``minicpm-2b`` at full width, 4 of its 40 layers,
   on a ("data",) grid of 4 rank threads sharing one copy of the
   weights, the serve phase's requests: every rank's greedy streams
   identical to one server's on the same model, the token assembly's
   ``assembly_decision``;
20. calibration and observability phase (``repro_torch.obs``), tracing
   on and measuring: (a) the six ops under every algorithm on the 8
   rank threads and the four multi-axis ops (auto and a phased shape) on
   a 2 x 4 (pod, data) grid at 64 KB - 16 MB, float32 exact, the spans
   held to the trace contract (decided, measured, planned, phases
   nested, the Chrome trace round-trips); (b) ``calibrate_launch`` from
   rank 0's spans: ``t_launch`` and the seconds per model cycle; (c)
   ``calibrate(grid=)`` on the 2 x 4 thread grid at 64 KB - 2 GB in a
   cache directory of its own: each axis's fitted Fabric, auto's
   allreduce picks at 4 KB - 64 MB stock and fitted, the topology
   persisted and restored there, and not under
   ``REPRO_TORCH_RESTORE_TOPOLOGY=0``; (d) the model-error tables; (e)
   one traced fsdp DP step and a short traced DP serve run at the
   earlier phases' configurations: span counts, the model-error table,
   the serve telemetry and engine stats through a metrics registry.
   Thread walls on one card are not a fabric; the predictions are the
   TPU model's.  At the end ``get_engine()`` under the usual cache still
   prices with the stock constants;
21. hybrid phase (run after phase 13): ``recurrentgemma-9b`` at its
   published width (RG-LRU blocks and MQA 16/1 local attention at head
   dim 256, window 2048; bf16, random weights from ``--seed``): a 2 x
   4096 prompt through ``prefill`` at full depth (38 layers, one
   ``mma_sync`` flash launch per local layer), 16 greedy decode steps
   over the ring caches (no launch), the prefill's and the first step's
   logits held against the teacher-forced forward; 5 AdamW steps at 5
   layers (1 pattern cycle and the tail), 2 x 4096, remat per cycle
   (loss, step wall, tok/s, peak memory against the tree's reckoning, 2
   flash launches a step, one step profiled); a float32 route check of
   5 layers (1 x 4096, kernel vs plain).  The flash kernel at the local
   layer's shape is among phase 2's cases;
22. encoder-decoder phase (run after phase 21): ``whisper-medium`` at its
   published width and depth (24 + 24 layers, 16/16 heads x 64, 1.012 B
   parameters, bf16, random weights from ``--seed``): 2 x 4096 stub
   audio frames and a 448-token prompt through ``prefill`` (one wgmma
   flash launch, non-causal, per encoder layer), the self cache padded by
   16, 16 greedy decode steps, each step's logits held against the
   teacher-forced forward; 5 AdamW steps of 2 x 4096 tokens over 2 x 4096
   frames, remat (loss, step wall, decoder tok/s, peak memory against the
   reckoning, 144 wgmma flash launches a step: the encoder's, the
   decoder's and the cross-attention's, forward and recompute; one step
   profiled); a float32 route check of 2 + 2 layers (1 x 4096, kernel vs
   plain).  The flash kernel at its layer (non-causal, no window) is
   among phase 2's cases, with the plain backward timed there;
23. vision phase: ``llava-next-34b`` at its published width and depth
   (60 layers, 56/8 heads x 128, 34.389 B parameters, bf16), the memory
   reckoned first, through the server with the serve phase's 16 requests,
   each carrying 576 soft tokens from ``vision_patches`` (seeded by the
   request id), 32 greedy tokens each: tok/s, TTFT, one paged launch a
   layer a decode step, the mid-run decode step held to the plain path
   and profiled; no prefix is cached (vision requests never are); then
   ``dense_route_phase`` at ``llava-next-34b`` (float32, 2 layers, 576
   soft tokens and 3520 tokens);
24. checkpoint phase (after every earlier phase): ``minicpm-2b`` at its
   published width with 4 of its 40 layers (0.81 B parameters, bf16
   weights and float32 moments: ~8.1 GB a step directory; the free space
   at ``tempfile.gettempdir()`` printed first), 2 x 4096 tokens a step
   through ``launch.train.run`` with ``--ckpt-dir``: an uninterrupted
   run of 5 WSD steps with a checkpoint every 2 commits steps 2, 4 and 5
   and ``keep`` leaves 4 and 5, its asynchronous save of step 4 (followed
   at once by the next step, in place) holding the state from before
   that step; a run that a real SIGTERM reaches during its third step
   commits step 3 alone and returns (ROADMAP.md C29), the restored step
   equals the saved state bitwise, and the resume runs steps 3-4 with
   the uninterrupted run's losses; each save's and restore's wall and
   GB/s, the time the loop was blocked by each save, the flash launches
   (8 a step) and the peak memory;
25. fleet phase: (a) ``minicpm-2b`` at full width and depth through
   ``serving.fleet.FleetServer``: 2 replicas of 8 slots sharing one set
   of weights (the same tensors) behind ``prefix_affinity``, the serve
   phase's 16 requests on bursty arrivals, 32 greedy tokens each: every
   stream bitwise the first 32 tokens of the serve phase's, peak memory
   one set of weights and two page pools; tok/s against the serve
   phase's, waves, routing, the cached prefix fraction, TTFT per
   replica, 40 paged launches a decode step; (b) at 4 layers, replicas of
   2 slots: every router policy on 3 replicas gives one replica's
   streams, ``prefix_affinity`` caches at least as much as
   ``round_robin``, and a capped bursty trace (queue cap 4, tenant rate
   64) rejects only at the cap, each rejection with a retry-after hint,
   every admitted request with all its tokens.

Phase 10 (NCCL, two or more cards) also times neighbour shifts over
NCCL and runs ``calibrate(grid=)`` one process a card (the NVLink
constants, persisted in a cache directory of the phase's own), and ends
with the trainer under torchrun with ``--arch olmoe-1b-7b --reduced
--dp --moe-ep`` (EP with a backward), the loss equal on both ranks.

It exits non-zero, printing no result, without a GPU or outside a
checkout of the repository.  The last lines are a JSON line of per-kernel
numbers, the card's name and power limit as ``nvidia-smi`` gives them,
and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

# the float32 DP check runs within a few GB of the card's memory, where
# the caching allocator's fragmentation decides whether it fits (on an
# H100 80GB it once ran out with 8.25 GiB reserved and unallocated);
# set before torch loads
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

import torch  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.collectives import (CollectiveEngine,  # noqa: E402
                                     ProcessGroupComm, ProcessGroupGrid,
                                     get_engine, planner, run_local,
                                     run_local_grid)
from repro_torch.collectives import api as collectives_api  # noqa: E402
from repro_torch.collectives.engine import (  # noqa: E402
    ICI_ELEMENT_BYTES, find_calibrated_topology, fit_launch,
    measure_ppermute)
from repro_torch.collectives.overlap import (  # noqa: E402
    bucket_algorithm_plan)
from repro_torch.core import patterns as pat  # noqa: E402
from repro_torch.core import selector  # noqa: E402
from repro_torch.core.model import (FabricTopology,  # noqa: E402
                                    TPU_V5E_AXIS)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import with_layer_units  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLMDataset  # noqa: E402
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.collectives import shardmap_impl as impl  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import selective_scan as ss  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_cuda, flash_variant)
from repro_torch.kernels.matmul_tiled import (  # noqa: E402
    matmul_tiled_cuda, matmul_variant)
from repro_torch.kernels.ref import (FLASH_CHUNK,  # noqa: E402
                                     flash_attention_bwd_ref,
                                     flash_attention_ref, matmul_tiled_ref,
                                     multi_add_ref, paged_attention_ref,
                                     selective_scan_ref)
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.launch import train as train_launch  # noqa: E402
from repro_torch.launch.train import (build_batch,  # noqa: E402
                                      step_generator)
from repro_torch.models import (decode_step_paged, forward_train,  # noqa
                                init_params)
from repro_torch.models.frontend import (audio_frames,  # noqa: E402
                                         vision_patches)
from repro_torch.models.layers import ambient_grid, set_fused_tp  # noqa
from repro_torch.models.transformer import shard_decode_cache  # noqa: E402
from repro_torch.obs import model_error as obs_model_error  # noqa: E402
from repro_torch.obs import registry as obs_registry  # noqa: E402
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.serving import ContinuousBatchingServer, Request  # noqa
from repro_torch.serving.fleet import (AdmissionConfig,  # noqa: E402
                                       FleetServer, ROUTER_POLICIES,
                                       arrival_waves)
from repro_torch.serving.telemetry import export_to_registry  # noqa: E402
from repro_torch.train.state import init_train_state  # noqa: E402
from repro_torch.train.step import (GradSyncConfig,  # noqa: E402
                                    make_decode_step, make_prefill_step,
                                    make_train_step, value_and_grad)
from repro_torch.tree import tree_leaves  # noqa: E402

#: NVIDIA H100 SXM data sheet: device memory rate, dense peak rates by the
#: inputs' type (bf16 on the tensor cores, float32 outside them)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {torch.bfloat16: 5e-2, torch.float32: 2e-5}
L2_FLUSH_BYTES = 128 << 20          # twice the 50 MB L2
SPIN_CYCLES = 5_000_000             # a few ms of device spin per launch

#: exponentials per SM per clock on the special-function units (CUDA C++
#: Programming Guide, arithmetic instruction throughput, compute
#: capability 9.0)
SFU_PER_SM_PER_CLOCK = 16
#: the checkpoint interval of the function the checkpointing scan computes
#: (``DEFAULT_CHUNK`` of src/repro/kernels/selective_scan.py): the scan
#: bound counts hck's bytes at it, not at the kernel's own chunk, so that
#: the bound does not move with the design it judges
SCAN_REF_CHUNK = 128

SERVE_ARCH = "minicpm-2b"
SERVE = dict(batch=8, requests=16, system_prompts=4, system_len=80,
             suffix=(16, 240), new_tokens=64, block_size=16,
             prefill_chunk=128)

TRAIN_ARCH = "falcon-mamba-7b"
#: falcon-mamba-7b at full width, 8 of 64 layers (AdamW state for all 64
#: would not fit one card); train_4k's sequence with the batch cut to 2;
#: a learning rate of Mamba's own recipes' order, so that five steps of
#: the cosine schedule show the loss fall above the batch-to-batch noise
TRAIN = dict(layers=8, batch=2, seq=4096, steps=5, lr=1e-3)
#: kernel vs plain route: float32, 2 layers, S = 1024 (the plain route's
#: [B, S, d_inner, N] state expansion has to fit)
ROUTE = dict(layers=2, batch=2, seq=1024, lr=3e-4)
DECODE = dict(batch=2, prompt=64, new_tokens=8)
#: the scan kernels' timing shape: one layer of the train phase
SCAN_TIMING = (2, 4096, 8192, 16)

DENSE_ARCH = "minicpm-2b"
#: minicpm-2b at its published width and depth, train_4k's sequence with
#: the batch cut to 2, 5 steps of the WSD schedule launch/train.py picks
#: for it, at the train CLI's default learning rate (at 1e-3, the SSM
#: phase's, the loss rises over five steps on the plain attention route
#: as on the kernel route: see ``--lr-witness``)
DENSE_TRAIN = dict(layers=40, batch=2, seq=4096, steps=5, lr=3e-4)
#: ``--lr-witness``: DENSE_TRAIN at the SSM phase's learning rate through
#: the kernel route and the plain chunked route, from the same weights and
#: batches
WITNESS_LR = 1e-3
#: kernel vs plain attention route: float32, 2 layers, one 4096 sequence
DENSE_ROUTE = dict(layers=2, batch=1, seq=4096, lr=3e-4)
#: prefill at full depth, then greedy decode into 8 positions of headroom
DENSE_DECODE = dict(batch=2, prompt=4096, new_tokens=8, headroom=8)
#: the configs whose head dims (96, 160) take the mma_sync / simt_f32
#: variants: the same float32 route check as DENSE_ROUTE for each
C12_ARCHS = ("phi3-mini-3.8b", "mistral-nemo-12b")
HYBRID_ARCH = "recurrentgemma-9b"
#: the hybrid's prefill + decode at its published width and depth (38
#: layers, ~11.4 GB of bf16 weights): a 4096-token prompt, a multiple of
#: the 2048 window (where the reference's cache agrees with the port's,
#: ROADMAP C25), then 16 greedy steps over the ring
HYBRID_DECODE = dict(batch=2, prompt=4096, new_tokens=16)
#: its training at 1 of its 12 pattern cycles plus the 2-block tail (5
#: layers; all 38 layers, 5.70 B parameters, would hold ~68 GB at 12
#: bytes a parameter, too much beside the 256000-word logits and their
#: gradients on one 80 GB card; 14 layers, then 8, kept the script past
#: its time: the profile of a step processes ~117 k eager kernels at 14),
#: train_4k's sequence with the batch cut to 2, the train CLI's learning
#: rate and its cosine schedule
HYBRID_TRAIN = dict(units=1, batch=2, seq=4096, steps=5, lr=3e-4)
#: kernel vs plain route: float32, one pattern cycle plus the tail (5
#: layers, 2.5 B float32 parameters), one 4096 sequence
HYBRID_ROUTE_UNITS = 1
ENCDEC_ARCH = "whisper-medium"
#: whisper-medium at its published width and depth (24 encoder and 24
#: decoder layers, 1.012 B parameters): 2 x 4096 frames, Whisper's
#: 448-token decoder prompt (repro/launch/specs.py:26), the self cache
#: padded by 16, then 16 greedy steps
ENCDEC_DECODE = dict(batch=2, frames=4096, prompt=448, new_tokens=16,
                     headroom=16)
#: its training: 2 x 4096 tokens over 2 x 4096 frames (train_4k's
#: sequence, the batch cut to 2), remat, 5 steps of the cosine schedule
#: at the train CLI's learning rate; the route check is dense_route_phase's
#: (float32, 2 encoder + 2 decoder layers, 1 x 4096)
ENCDEC_TRAIN = dict(batch=2, seq=4096, steps=5, lr=3e-4)
#: the FLASH_CASES label of its layer (its plain backward is timed there)
ENCDEC_FLASH = "whisper-medium layer (non-causal)"
VISION_ARCH = "llava-next-34b"
#: llava-next-34b served at its published width and depth: 60 layers,
#: 34.389 B parameters, 68.78 GB in bf16; with the page pool for 8 slots
#: of ~1000 positions (245760 bytes a position), the decode check's three
#: copies of it and the activations, ~78 GB of the card's 85.0 (reckoned
#: again in serve_phase before the weights are made); 32 greedy tokens a
#: request after its 576 soft tokens
VISION_SERVE = dict(layers=60, new_tokens=32)
#: flash_attention's shapes (b, h, hkv, s, d, causal, window): the train
#: phase's layer first (its timing shape); a synthetic GQA 32/8 shape at
#: D 128 (no config has it: yi-34b, 56/8 at D 128, is the nearest); the
#: full-width heads of phi3-mini-3.8b (MHA 32/32, D 96) and
#: mistral-nemo-12b (GQA 32/8, D 160, as the repo's config resolves it);
#: the local-attention window of recurrentgemma-9b (local_window's
#: default, 2048) at minicpm-2b's heads; the DP rank's layer;
#: olmoe-1b-7b's train layer (MHA 16/16, D 128); recurrentgemma-9b's
#: local layer itself (MQA 16/1 at D 256, window 2048); and whisper-
#: medium's layer (MHA 16/16, D 64, non-causal: its encoder and its
#: cross-attention)
FLASH_CASES = (("minicpm-2b train layer", 2, 36, 36, 4096, 64, True, None),
               ("synthetic GQA 32/8 D 128 (nearest config: yi-34b 56/8)",
                1, 32, 8, 4096, 128, True, None),
               ("phi3-mini-3.8b MHA 32/32", 1, 32, 32, 4096, 96, True,
                None),
               ("mistral-nemo-12b GQA 32/8", 1, 32, 8, 4096, 160, True,
                None),
               ("sliding window 2048", 2, 36, 36, 4096, 64, True, 2048),
               ("minicpm-2b DP rank layer (1 x 4096)", 1, 36, 36, 4096, 64,
                True, None),
               ("olmoe-1b-7b train layer", 2, 16, 16, 4096, 128, True,
                None),
               ("recurrentgemma-9b local layer", 2, 16, 1, 4096, 256, True,
                2048),
               (ENCDEC_FLASH, 2, 16, 16, 4096, 64, False, None))
#: kernel vs plain lse (float32 sums of up to 4096 terms in other
#: orders, lse of magnitude ~10): 1e-4 absolute
LSE_TOL = 1e-4
#: the bf16 gradient check through the wgmma forward: 4 bf16 ulps of the
#: largest gradient
BF16_GRAD_TOL = 2.0 ** -6
#: the bf16 kernel's output, element by element, against the plain
#: version's float32 output: within one bf16 ulp of that output (rounding
#: to bf16 takes half an ulp; the other half covers a value that crosses
#: a power of two) plus O_FLOOR, which covers the float32 difference of
#: the two sums (~1e-6) where the output is near 0
O_FLOOR = 1e-5
#: the FLASH_CASES at which the bf16 check must reject FLASH_FAULTS
FAULT_CASES = ("minicpm-2b train layer", "recurrentgemma-9b local layer",
               ENCDEC_FLASH)
#: deliberate faults the bf16 check must reject
FLASH_FAULTS = ("P rounded to bf16 before P V",
                "key i dropped from row i (the diagonal: a causal mask off "
                "by one)",
                "first KV tile dropped for rows >= S/2")
#: deliberate faults the paged kernel's bf16 check must reject, at the
#: long-context shapes (``paged_faulty``)
PAGED_FAULTS = ("P rounded to bf16 before P V",
                "last live split of each row left out of the merge",
                "splits merged with weight 1, not exp(m_s - m)")

#: collective phase: ranks on the one card, bytes per rank (the latency
#: regime, 256 KB, the trainer's default bucket_bytes, 64 MB), and every
#: algorithm the engine knows for each op, then the model's pick
CKPT_ARCH = "minicpm-2b"
#: minicpm-2b at full width with 4 of its 40 layers (0.81 B parameters by
#: ``param_count``: 2 B of bf16 weight and 8 B of float32 moments each, ~8.1
#: GB a step directory), 2 x 4096 tokens a step through
#: ``launch.train.run``: an uninterrupted run of 5 WSD steps with a
#: checkpoint every 2, one preempted by SIGTERM during its third step and
#: resumed (those two with no periodic checkpoint: five saves, ~41 GB
#: written in all)
CKPT = dict(layers=4, batch=2, seq=4096, steps=5, every=2, preempt=3,
            lr=3e-4)
#: the fleet: (a) minicpm-2b at full width and depth, 2 replicas of the
#: serve phase's batch behind prefix_affinity, the serve phase's 16
#: requests on bursty arrivals, 32 greedy tokens each; (b) at 4 layers,
#: replicas of 2 slots (so that requests queue and later ones find their
#: prefix cached): every router policy on 3 replicas (fixed arrivals, 16
#: tokens) against one replica, and a capped bursty trace on 3 replicas
FLEET = dict(replicas=2, router="prefix_affinity", new_tokens=32, rate=2.0)
FLEET_POLICIES = dict(layers=4, replicas=3, batch=2, new_tokens=16,
                      queue_cap=4, tenant_rate=64.0)
COLLECTIVE_RANKS = 8
COLLECTIVE_BYTES = (4 << 10, 256 << 10, 4 << 20, 64 << 20)
ALGORITHMS = {
    "reduce": ("chain", "tree", "two_phase", "star", "autogen",
               "autogen_pipelined", "auto"),
    "allreduce": ("psum", "oneshot", "chain", "tree", "two_phase", "star",
                  "ring", "autogen", "autogen_pipelined", "auto"),
    "reduce_scatter": ("psum_scatter", "ring", "autogen", "auto"),
    "allgather": ("all_gather", "oneshot", "ring", "doubling", "autogen",
                  "auto"),
    "broadcast": ("doubling", "chain", "autogen", "auto"),
    "all_to_all": ("lax", "oneshot", "ring", "halving", "auto"),
}
BROADCAST_ROOT = 3
#: 2D collective phase: the 8 ranks as the reference's multi-device
#: grids, (shape, axis names, the axis subsets the ops run over); bytes
#: per rank straddling the planner's latency and bandwidth regimes; bf16
#: held bitwise to CPU ranks up to BF16_CPU_BYTES
GRIDS_2D = (((2, 4), ("pod", "data"), (("pod", "data"),)),
            ((2, 2, 2), ("pod", "data", "model"),
             (("pod", "data"), ("pod", "data", "model"))))
COLLECTIVE_2D_BYTES = (4 << 10, 256 << 10, 16 << 20)
BF16_CPU_BYTES = 256 << 10
#: what the NCCL phase runs over a (2, cards / 2) ProcessGroupGrid
NCCL_2D_SHAPES = ("2d_xy", "2d_snake", "hierarchical")
#: fused ring: the TP-8 down-projection of yi-34b (d_ff 20480 -> d_model
#: 7168) over 2 x 4096 tokens, bf16
FUSED_ARCH = "yi-34b"
FUSED = dict(tp=8, batch=2, seq=4096)
#: each rank's block of the ring vs the gathered path, and a sampled slice
#: vs float64: both sides round to bf16 at each of the 8 hops (the block
#: GEMM's output and the sum), at most 16 roundings of half a bf16 ulp
#: (2^-8) of the largest partial, relative to the result's max-abs
FUSED_TOL = 16 * 2.0 ** -8
#: the shapes of multi_add (one 4 MB bucket from 8 ranks,
#: K = 2, 32, bf16, ragged N) and of matmul_tiled (one ring step first)
MULTI_ADD_CASES = (("one 4 MB fp32 bucket from 8 ranks", 8, 1 << 20,
                    torch.float32),
                   ("K = 2", 2, 1 << 20, torch.float32),
                   ("K = 32", 32, 1 << 20, torch.float32),
                   ("bf16", 8, 1 << 20, torch.bfloat16),
                   ("ragged N", 8, 1_000_003, torch.float32))
MATMUL_CASES = (("one ring step of the fused phase", 1024, 2560, 7168,
                 torch.bfloat16),
                ("the same in float32", 1024, 2560, 7168, torch.float32),
                ("ragged M, N (16-byte rows)", 1000, 2560, 7000,
                 torch.bfloat16),
                ("ragged K, N (element loads)", 1000, 2555, 7001,
                 torch.bfloat16),
                ("one ring step of the TP decode phase's prefill "
                 "(minicpm-2b, TP 8)", 1024, 720, 2304, torch.bfloat16))
#: data-parallel training: minicpm-2b at full width with 2 of its 40
#: layers on a 2 x 2 (pod, data) grid of rank threads on the one card,
#: 1 x 4096 tokens a rank, 3 bf16 steps per sync mode; the float32 check
#: is one step at 1 layer of each mode against the plain single-rank step
#: on the same global batch (microbatches = the ranks)
DP_ARCH = "minicpm-2b"
DP_TRAIN = dict(grid=(2, 2), layers=2, rows=1, seq=4096, steps=3, lr=3e-4,
                check_layers=1, check_steps=2)
DP_MODES = (("allreduce", False), ("fsdp", False), ("fsdp", True))
#: the DP check's bounds on every parameter (tests/test_engine.py:431)
DP_RTOL, DP_ATOL = 1e-4, 1e-5
#: the DP check's bound on grad_norm, relative (AdamW's step is blind to
#: a uniform scale of the gradient: a sync that sums where it should
#: average shows only in the norm)
DP_GNORM_RTOL = 1e-4
#: tensor-parallel decode: minicpm-2b at full width, 2 layers, on 8
#: model-rank threads with the fused TP down-projection; 2 x 4096
#: prompts, the cache padded by 8 (4104 = 8 x 513: sequence-sharded, as
#: 36 kv heads do not divide 8), 8 greedy steps through flash_decode
TP_DECODE = dict(tp=8, layers=2, batch=2, prompt=4096, new_tokens=8,
                 headroom=8)
#: matmul_tiled vs its plain version, relative to the plain product's
#: max-abs: float32 adds in another order over K = 2560; bf16 rounds the
#: float32 sum once, at most one bf16 ulp (2^-7 of the value) apart
MM_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}

MOE_ARCH = "olmoe-1b-7b"
#: olmoe-1b-7b at full width, 8 of its 16 layers (AdamW for all 16 needs
#: ~83 GB before activations), train_4k's sequence with the batch cut to
#: 2, 5 steps of the cosine schedule, remat; its route check is
#: dense_route_phase's (float32, 2 layers, 1 x 4096)
MOE_TRAIN = dict(layers=8, batch=2, seq=4096, steps=5, lr=3e-4)
#: expert parallelism, forward only (ROADMAP C15): full width, 2 layers'
#: MoE FFNs, 8 rows of 1024 tokens on 8 rank threads
MOE_EP = dict(layers=2, rows=8, seq=1024,
              grids=(((2, 4), ("data", "model")), ((2, 4), ("pod", "data"))),
              algorithms=("lax", "auto", "hierarchical", "flat"))
#: data-parallel serving: the serve phase's requests on a ("data",) grid
#: of 4 rank threads, at full width with 4 of minicpm-2b's 40 layers
#: (at 40 layers the 4 threads took 191.5 s on one H100, most of it the
#: threads taking turns on the interpreter lock between eager calls),
#: against one server of the same model
DP_SERVE = dict(ranks=4, layers=4)
#: calibration and observability phase: the traced collectives' bytes per
#: rank and repeats (calibrate_launch takes each signature's best), the
#: shift sizes and repeats of calibrate(grid=), the sizes auto's picks are
#: printed at, and the short traced DP serve run.  The shifts go to 2 GB a
#: rank: on 8 threads of one H100 the 'data' axis's fit up to 64 MB was
#: refused as noise-dominated (the barriers' jitter, 1-3.6 ms a shift,
#: hid the copies; 1 GB a rank added 3.3 ms over it)
OBS_BYTES = (64 << 10, 256 << 10, 1 << 20, 4 << 20, 16 << 20)
OBS_REPEATS = 2
OBS_MULTI = {"allreduce": "hierarchical", "reduce_scatter": "cascade",
             "allgather": "cascade", "all_to_all": "hierarchical"}
CALIBRATE_BYTES = (64 << 10, 1 << 20, 16 << 20, 256 << 20, 1 << 30,
                   2 << 30)
CALIBRATE_REPEATS = 5          # calibrate()'s own best-of
AUTO_BYTES = (4 << 10, 64 << 10, 1 << 20, 16 << 20, 64 << 20)
OBS_SERVE = dict(requests=8, new_tokens=16)


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ----------------------------- timing -------------------------------- #
def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of ``fn`` in ms.  Before every launch the L2
    cache is flushed (the serving path finds its KV pool cold: the other
    39 layers pass through L2 between two calls of one layer) and the
    card spins for a few ms, so that the host has enqueued all of ``fn``
    before the start event fires: the time is the device's, not the
    Python wrapper's."""
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def profile_step(fn) -> str:
    """One call of ``fn`` under ``torch.profiler``: host wall time, the
    device kernels it ran, their busy time (union of their intervals)
    and the idle share of the device span, and the top kernels by
    device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return f"host wall {wall_ms:.2f} ms; the profiler saw no device time"
    busy, cur_s, cur_e, by_name = 0.0, spans[0][0], spans[0][1], {}
    for s0, e0, name in spans:
        by_name[name] = by_name.get(name, 0.0) + (e0 - s0)
        if s0 > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s0, e0
        else:
            cur_e = max(cur_e, e0)
    busy += cur_e - cur_s
    span = max(e for _, e, _ in spans) - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    tops = "; ".join(f"{n[:60]} {t / 1e3:.3f} ms" for n, t in top)
    return (f"host wall {wall_ms:.2f} ms (profiled) | {len(spans)} device "
            f"kernels | device busy {busy / 1e3:.3f} ms of a "
            f"{span / 1e3:.3f} ms span (idle share {1 - busy / span:.1%}) "
            f"| top: {tops}")


# -------------------------- kernel phase ----------------------------- #
def paged_case(b, h, hkv, d, bs, n_blocks, lengths, dtype, seed):
    """Inputs of one paged-attention case on the card.  Each row's table
    holds its own blocks, then one more block of live data past its
    length (a stale block the kernel must not read)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    shape = (n_blocks, bs, hkv, d)
    q = torch.randn((b, h, d), generator=gen, device="cuda").to(dtype)
    kp = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    vp = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    need = [math.ceil(n / bs) for n in lengths]
    m = max(need) + 1
    assert sum(need) + b < n_blocks, "pool too small for the case"
    ids = (torch.randperm(n_blocks - 1, generator=gen, device="cuda")
           + 1).tolist()
    tables = np.zeros((b, m), np.int32)
    for row, k in enumerate(need):
        tables[row, :k + 1] = [ids.pop() for _ in range(k + 1)]
    bt = torch.from_numpy(tables).cuda()
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, kp, vp, bt, lens


def paged_bound(q, kp, bt, lens):
    """(least ms, "bytes" | "operations") of one call: the K and V rows
    of the tokens this run attends over, the queries, the output and the
    tables moved once; 4*H*D operations per token at the inputs' type."""
    b, h, d = q.shape
    hkv = kp.shape[2]
    esize = q.element_size()
    tokens = int(lens.clamp(min=0).sum())
    nbytes = (2 * tokens * hkv * d * esize + 2 * q.numel() * esize
              + 4 * bt.numel() + 4 * lens.numel())
    ops_ = 4 * tokens * h * d
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops_ / PEAK_OPS_PER_S[q.dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def gather_sdpa(q, kp, vp, bt, lens):
    """Context only: a gather of the pages, then one
    ``scaled_dot_product_attention`` call (two calls; GQA through
    ``enable_gqa``)."""
    n, bs, hkv, d = kp.shape
    b, m = bt.shape
    idx = (bt.long()[:, :, None] * bs
           + torch.arange(bs, device="cuda")).reshape(b, m * bs)
    k = kp.view(n * bs, hkv, d)[idx].transpose(1, 2)
    v = vp.view(n * bs, hkv, d)[idx].transpose(1, 2)
    mask = (torch.arange(m * bs, device="cuda")[None, None, None, :]
            < lens[:, None, None, None])
    return torch.nn.functional.scaled_dot_product_attention(
        q[:, :, None], k, v, attn_mask=mask, enable_gqa=q.shape[1] != hkv)


def paged_faulty(q, kp, vp, bt, lens, split_blocks, fault):
    """The paged kernel's function in float32, split as the kernel splits
    it (``split_blocks`` blocks a split, partials merged in split order),
    with one deliberate fault of ``PAGED_FAULTS``; the output rounded to
    q's dtype, a length-0 row zeros."""
    n, bs, hkv, d = kp.shape
    b, h, _ = q.shape
    span = split_blocks * bs
    out = torch.zeros((b, hkv, h // hkv, d), device=q.device)
    qf = q.float().view(b, hkv, h // hkv, d) / d ** 0.5
    for row, length in enumerate(lens.tolist()):
        if length <= 0:
            continue
        blocks = bt[row, :-(-length // bs)].long()
        k = kp[blocks].reshape(-1, hkv, d)[:length].float()
        v = vp[blocks].reshape(-1, hkv, d)[:length].float()
        parts = []
        for t0 in range(0, length, span):
            s = torch.einsum("kgd,tkd->kgt", qf[row], k[t0:t0 + span])
            m_s = s.amax(-1, keepdim=True)
            p = torch.exp(s - m_s)
            if fault == PAGED_FAULTS[0]:
                p = p.to(torch.bfloat16).float()
            parts.append((m_s, p.sum(-1, keepdim=True),
                          torch.einsum("kgt,tkd->kgd", p, v[t0:t0 + span])))
        if fault == PAGED_FAULTS[1] and len(parts) > 1:
            parts = parts[:-1]
        m_all = torch.stack([m_s for m_s, _, _ in parts]).amax(0)
        num, den = torch.zeros_like(out[row]), torch.zeros_like(m_all)
        for m_s, l_s, acc in parts:
            wt = (torch.ones_like(m_s) if fault == PAGED_FAULTS[2]
                  else torch.exp(m_s - m_all))
            num, den = num + acc * wt, den + l_s * wt
        out[row] = num / den
    return out.view(b, h, d).to(q.dtype)


def stream_floor_ms(nbytes: int) -> float:
    """``torch.sum`` over a bf16 tensor of ``nbytes`` under ``time_ms``
    (same L2 flush): the time one library call takes to stream the bytes
    the paged kernel must read, a floor nearer than the data sheet's."""
    x = torch.ones(nbytes // 2, dtype=torch.bfloat16, device="cuda")
    ms = time_ms(lambda: torch.sum(x, dtype=torch.float32))
    del x
    return ms


#: rows of 253 ... 4096 tokens (256 k - 3 (k mod 4), k = 1 .. 16): the
#: long-context decode cases, where every step re-reads the whole cache
PAGED_LONG = [256 * k - 3 * (k % 4) for k in range(1, 17)]
#: (label, b, h, hkv, d, bs, n_blocks, lengths, dtype, timed)
PAGED_CASES = (
    ("minicpm-2b decode (serving shape)", 8, 36, 36, 64, 16, 201,
     [1, 0, 37, 100, 157, 211, 290, 383], torch.bfloat16, True),
    ("minicpm-2b long-context decode", 16, 36, 36, 64, 16, 2400,
     PAGED_LONG, torch.bfloat16, True),
    ("yi-34b GQA 56/8 long-context decode", 16, 56, 8, 128, 16, 2400,
     PAGED_LONG, torch.bfloat16, True),
    ("GQA 32/8, head dim 128", 8, 32, 8, 128, 16, 201,
     [5, 64, 1, 0, 129, 250, 311, 384], torch.bfloat16, True),
    ("minicpm-2b shape, float32", 8, 36, 36, 64, 16, 201,
     [1, 0, 37, 100, 157, 211, 290, 383], torch.float32, False),
    ("olmoe-1b-7b decode (serving shape)", 8, 16, 16, 128, 16, 201,
     [1, 0, 37, 100, 157, 211, 290, 383], torch.bfloat16, True),
    ("llava-next-34b decode (serving shape, 576 soft positions a row)", 8,
     56, 8, 128, 16, 480, [577, 650, 700, 733, 820, 871, 900, 944],
     torch.bfloat16, True),
)


def kernel_phase(seed: int) -> dict:
    """The paged kernel at each of ``PAGED_CASES`` against its plain
    version (tolerance; bf16 also element by element, within one bf16 ulp
    of the float32 plain output, a check that must reject
    ``PAGED_FAULTS`` at the long-context shapes; zeros for length-0 rows,
    bitwise equal on a second call, stale-safe), then timed at the timed
    cases; the first case, the serving shape, is the JSON row's."""
    max_err = 0.0
    timed = []
    for i, (label, b, h, hkv, d, bs, nb, lengths, dtype, time_it) in \
            enumerate(PAGED_CASES):
        q, kp, vp, bt, lens = paged_case(b, h, hkv, d, bs, nb, lengths,
                                         dtype, seed + i)
        got = ops.paged_attention(q, kp, vp, bt, lens)
        torch.cuda.synchronize()
        want = paged_attention_ref(q, kp, vp, bt, lens)
        torch.cuda.synchronize()
        live = lens > 0
        assert torch.all(got[~live] == 0), "length-0 rows must give zeros"
        err = float((got[live].float() - want[live].float()).abs().max())
        assert err <= TOL[dtype], (label, err, TOL[dtype])
        del want
        check = f"max_abs_err={err:.3e} (tol {TOL[dtype]:.0e})"
        if dtype == torch.bfloat16:
            # float32 inputs hold the same values: the plain output before
            # its cast to q's dtype
            want_f = paged_attention_ref(q.float(), kp.float(), vp.float(),
                                         bt, lens)
            ratio = bf16_ratio(got[live], want_f[live])
            assert ratio <= 1.0, (label, ratio)
            check += (f" | max |err| / (1 bf16 ulp of the float32 plain "
                      f"output + {O_FLOOR:.0e}) {ratio:.4f} (tol 1)")
            if "long-context" in label:
                split_blocks = pa.describe(q, kp, bt)["split_blocks"]
                faults = {f: bf16_ratio(paged_faulty(
                    q, kp, vp, bt, lens, split_blocks, f)[live], want_f[live])
                    for f in PAGED_FAULTS}
                assert min(faults.values()) > 1.0, (label, faults)
                check += (" | deliberate faults: " + " | ".join(
                    f"{f} {r:.1f}" for f, r in faults.items())
                    + " (each must exceed 1)")
            del want_f
        assert torch.equal(got, ops.paged_attention(q, kp, vp, bt, lens)), \
            f"{label}: two calls differ"
        # clobber every slot past each row's length (the stale block and
        # the tail of the last partial block): the output must not move
        kp2, vp2 = kp.clone(), vp.clone()
        for row, n in enumerate(lengths):
            for j, blk in enumerate(bt[row].tolist()):
                lo = max(n - j * bs, 0)
                if lo < bs:
                    kp2[blk, lo:] = 1e4
                    vp2[blk, lo:] = -1e4
        again = ops.paged_attention(q, kp2, vp2, bt, lens)
        torch.cuda.synchronize()
        assert torch.equal(got, again), f"{label}: read past a length"
        del kp2, vp2, again
        max_err = max(max_err, err)
        log(f"kernel paged_attention {label}: B={b} H={h} Hkv={hkv} D={d} "
            f"bs={bs} {str(dtype).split('.')[-1]} lengths={lengths} "
            f"{check} | deterministic, stale-safe")
        if time_it:
            timed.append((label, q, kp, vp, bt, lens, lengths))
    rows = []
    for label, q, kp, vp, bt, lens, lengths in timed:
        ms = time_ms(lambda: ops.paged_attention(q, kp, vp, bt, lens))
        plain_ms = time_ms(lambda: paged_attention_ref(q, kp, vp, bt, lens))
        sdpa_ms = time_ms(lambda: gather_sdpa(q, kp, vp, bt, lens))
        bound_ms, bound_by = paged_bound(q, kp, bt, lens)
        floor_ms = stream_floor_ms(2 * sum(lengths) * kp.shape[2]
                                   * kp.shape[3] * kp.element_size())
        info = pa.describe(q, kp, bt)
        bs, hkv = kp.shape[1], kp.shape[2]
        live = info["query_chunks"] * hkv * sum(
            -(-math.ceil(n / bs) // info["split_blocks"]) for n in lengths)
        waves = live / (info["blocks_per_sm"] * info["sms"])
        log(f"kernel paged_attention timing, {label}: kernel {ms:.4f} ms | "
            f"plain {plain_ms:.4f} ms | bound {bound_ms:.4f} ms ({bound_by}; "
            f"{HBM_BYTES_PER_S / 1e12} TB/s H100 SXM data sheet) | "
            f"{bound_ms / ms:.1%} of bound | streaming floor, torch.sum "
            f"over the K and V bytes: {floor_ms:.4f} ms | context only, "
            f"page gather + scaled_dot_product_attention (two calls): "
            f"{sdpa_ms:.4f} ms")
        log(f"kernel paged_attention launch, {label}: {info['kernel']}, "
            f"{info['split_blocks']} blocks a split x {info['n_split']} "
            f"splits, {info['registers']} registers a thread, "
            f"{info['spill_bytes']} bytes spilled, {info['threads']} threads "
            f"and {info['smem_bytes']} bytes of shared memory a block "
            f"({info['query_rows']} query heads, {info['stage_tokens']} "
            f"tokens a stage), {info['blocks_per_sm']} blocks per SM | "
            f"{info['grid_blocks']} blocks, {live} of them hold tokens (the "
            f"rest start past a length and exit at once), on {info['sms']} "
            f"SMs = {waves:.3f} waves")
        rows.append((ms, plain_ms, bound_ms, bound_by))
    log("library_ms: null -- no single PyTorch call computes paged "
        "attention (the page gather + SDPA above is two calls)")
    ms, plain_ms, bound_ms, bound_by = rows[0]
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:121",
            "launches": 0, "max_abs_err": max_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None}


# ---------------------- selective-scan kernels ------------------------ #
def max_sm_clock_hz() -> float:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def scan_case(b, s, d, n, dtype, seed):
    """Scan inputs on the card: dt = softplus(normal), x, B, C, h0
    normal, A = -exp(0.5 normal) (the reference's kernel tests)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    f = lambda *shape: torch.randn(shape, generator=gen, device="cuda")
    dt = torch.nn.functional.softplus(f(b, s, d))
    ins = [t.to(dtype) for t in (dt, f(b, s, d), f(b, s, n), f(b, s, n))]
    return ins + [-torch.exp(0.5 * f(d, n)), f(b, d, n)]


def scan_bound(kind, b, s, d, n, esize):
    """(least ms, "bytes" | "operations") of one scan call: each input
    read once and each output written once at 3.35 TB/s; one exponential
    per (batch, step, channel, state) on the SFUs (16 per SM per clock at
    the card's maximum SM clock).  hck is counted at the reference's
    checkpoint interval, SCAN_REF_CHUNK."""
    bsd, bsn, dn, bdn = b * s * d, b * s * n, d * n, b * d * n
    hck = b * -(-s // SCAN_REF_CHUNK) * d * n
    if kind == "bwd":       # dt, x, dy, B, C, A, hck, dh_final -> grads
        nbytes = 4 * (3 * bsd + 2 * bsn + dn + hck + bdn
                      + 2 * bsd + 2 * bsn + dn + bdn)
    else:                   # dt, x, B, C, A, h0 -> y, h_final (+ hck)
        nbytes = (esize * (3 * bsd + 2 * bsn) + 4 * (dn + 2 * bdn)
                  + (4 * hck if kind == "ckpt" else 0))
    props = torch.cuda.get_device_properties(0)
    exp_rate = (props.multi_processor_count * SFU_PER_SM_PER_CLOCK
                * max_sm_clock_hz())
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = b * s * d * n / exp_rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def grad_errors(args, w, v):
    """Gradients of sum(y * w) + sum(h_final * v) through the kernel pair
    and through autograd of the plain recurrence: (max abs error, max of
    abs error over the reference's max abs, per input)."""
    grads = {}
    for route in ("kernel", "plain"):
        leaves = [t.detach().clone().requires_grad_() for t in args]
        fn = (ss.selective_scan_trainable if route == "kernel"
              else selective_scan_ref)
        y, hf = fn(*leaves)
        grads[route] = torch.autograd.grad((y * w).sum() + (hf * v).sum(),
                                           leaves)
        del y, hf, leaves
    torch.cuda.synchronize()
    abs_err = rel_err = 0.0
    for k, r in zip(grads["kernel"], grads["plain"]):
        e = float((k - r).abs().max())
        abs_err = max(abs_err, e)
        rel_err = max(rel_err, e / (float(r.abs().max()) + 1e-9))
    return abs_err, rel_err


def scan_kernel_phase(seed: int) -> list:
    """Rows 5-7 of the kernel table: the forward (no checkpoints), the
    checkpointing forward and the backward, against the plain recurrence
    on the card, then held to it again and timed at one layer of the
    train phase."""
    tol = {torch.float32: 1e-4, torch.bfloat16: 5e-2}
    cases = [
        # (label, b, s, d, n, dtype, gradients, absolute check)
        ("training layer width, S 1024", 2, 1024, 8192, 16, torch.float32,
         True, True),
        ("ragged: S 100, D 48", 2, 100, 48, 16, torch.float32, True, True),
        ("bf16 inputs", 2, 512, 1024, 16, torch.bfloat16, False, True),
        # |y| reaches 16-32 here, where one bf16 ulp is 0.125: held element
        # by element to the float32 plain output (bf16_ratio), not to 5e-2
        ("bf16 inputs, training layer width, S 1024", 2, 1024, 8192, 16,
         torch.bfloat16, False, False),
        ("ragged: S 77, D 200, N 4", 2, 77, 200, 4, torch.float32, True,
         True),
        ("rows not 16-byte aligned: S 50, D 45, N 1", 2, 50, 45, 1,
         torch.float32, True, True),
    ]
    err = {"fwd": 0.0, "ckpt": 0.0, "bwd": 0.0}
    for i, (label, b, s, d, n, dtype, grads, absolute) in enumerate(cases):
        args = scan_case(b, s, d, n, dtype, seed + 100 + i)
        y5, h5 = ss.selective_scan(*args)
        y6, h6, hck = ss.selective_scan_fwd_ckpt(*args)
        torch.cuda.synchronize()
        y_r, h_r = selective_scan_ref(*args)
        # bf16: the plain version on float32 copies of the same values, its
        # output before the cast (each kernel y within one bf16 ulp of it)
        y_f = (selective_scan_ref(*[t.float() for t in args])[0]
               if dtype == torch.bfloat16 else None)
        torch.cuda.synchronize()
        msg = []
        for kind, y, h in (("fwd", y5, h5), ("ckpt", y6, h6)):
            e = max(float((y.float() - y_r.float()).abs().max()),
                    float((h - h_r).abs().max()))
            assert not absolute or e <= tol[dtype], (label, kind, e)
            assert float((h - h_r).abs().max()) <= tol[dtype], (label, kind)
            err[kind] = max(err[kind], e)
            msg.append(f"{kind} max_abs_err {e:.3e}")
            if y_f is not None:
                ratio = bf16_ratio(y, y_f)
                assert ratio <= 1.0, (label, kind, ratio)
                msg.append(f"{kind} y max |err| / (1 bf16 ulp of the float32 "
                           f"plain output + {O_FLOOR:.0e}) {ratio:.4f} "
                           f"(tol 1)")
        assert torch.equal(hck[:, 0], args[5]), "hck[:, 0] must be h0"
        if grads:
            gen = torch.Generator(device="cuda")
            gen.manual_seed(seed + 200 + i)
            w = torch.randn(y_r.shape, generator=gen, device="cuda")
            v = torch.randn(h_r.shape, generator=gen, device="cuda")
            abs_e, rel_e = grad_errors(args, w, v)
            assert rel_e < 1e-4, (label, "gradients", rel_e)
            err["bwd"] = max(err["bwd"], abs_e)
            msg.append(f"bwd max_abs_err {abs_e:.3e} (max over inputs of "
                       f"err / max|ref| {rel_e:.3e}, tol 1e-4)")
        log(f"kernel selective_scan {label}: B={b} S={s} D={d} N={n} "
            f"{str(dtype).split('.')[-1]} | " + " | ".join(msg)
            + f" ({'' if absolute else 'h_final '}tol {tol[dtype]:.0e})")
        del args, y5, h5, y6, h6, hck, y_r, h_r, y_f
    torch.cuda.empty_cache()

    # the main path's shape: the kernels' outputs are held against the
    # plain forward and backward that the timing below runs anyway, before
    # any kernel is timed
    b, s, d, n = SCAN_TIMING
    args = scan_case(b, s, d, n, torch.float32, seed)
    y5, h5 = ss.selective_scan(*args)
    y6, h6, hck = ss.selective_scan_fwd_ckpt(*args)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 300)
    dy = torch.randn((b, s, d), generator=gen, device="cuda")
    dhf = torch.randn((b, d, n), generator=gen, device="cuda")
    g_kernel = ss.selective_scan_bwd(*args[:5], hck, dy, dhf)
    leaves = [t.clone().requires_grad_() for t in args]
    y, hf = selective_scan_ref(*leaves)
    torch.cuda.synchronize()
    msg = []
    for kind, yk, hk in (("fwd", y5, h5), ("ckpt", y6, h6)):
        e = max(float((yk - y.detach()).abs().max()),
                float((hk - hf.detach()).abs().max()))
        assert e <= tol[torch.float32], ("SCAN_TIMING", kind, e)
        err[kind] = max(err[kind], e)
        msg.append(f"{kind} max_abs_err {e:.3e}")
    assert torch.equal(hck[:, 0], args[5]), "hck[:, 0] must be h0"
    del y5, h5, y6, h6
    # the plain backward's timed call keeps its gradients: 1 rep (~5 s)
    g_plain = []
    plain_bwd = time_ms(lambda: g_plain.append(torch.autograd.grad(
        (y, hf), leaves, (dy, dhf), retain_graph=True)),
        reps=1, warmup=1)
    abs_e = rel_e = 0.0
    for k, r in zip(g_kernel, g_plain[-1]):
        e = float((k - r).abs().max())
        abs_e = max(abs_e, e)
        rel_e = max(rel_e, e / (float(r.abs().max()) + 1e-9))
    assert rel_e < 1e-4, ("SCAN_TIMING", "gradients", rel_e)
    err["bwd"] = max(err["bwd"], abs_e)
    msg.append(f"bwd max_abs_err {abs_e:.3e} (max over inputs of err / "
               f"max|ref| {rel_e:.3e}, tol 1e-4)")
    log(f"kernel selective_scan main path's shape: B={b} S={s} D={d} N={n} "
        f"float32 | " + " | ".join(msg) + " | hck[:, 0] == h0 (tol 1e-04)")
    del y, hf, leaves, g_kernel, g_plain
    torch.cuda.empty_cache()
    ms = {"fwd": time_ms(lambda: ss.selective_scan(*args), reps=20),
          "ckpt": time_ms(lambda: ss.selective_scan_fwd_ckpt(*args),
                          reps=20),
          "bwd": time_ms(lambda: ss.selective_scan_bwd(
              *args[:5], hck, dy, dhf), reps=20)}
    # the plain versions are yardsticks of arithmetic, not of speed, and
    # the slow part of the run: 3 forward reps, 1 backward rep (above)
    plain_reps = {"fwd": 3, "bwd": 1}
    with torch.no_grad():
        plain_fwd = time_ms(lambda: selective_scan_ref(*args),
                            reps=plain_reps["fwd"], warmup=1)
    plain = {"fwd": plain_fwd, "ckpt": plain_fwd, "bwd": plain_bwd}
    rows = {}
    names = {"fwd": ("selective_scan", 84), "ckpt":
             ("selective_scan_fwd_ckpt", 221),
             "bwd": ("selective_scan_bwd", 257)}
    plain_note = {"fwd": "", "ckpt": ", forward only, shared with row 5",
                  "bwd": ", autograd backward of the recurrence"}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for kind, (name, line) in names.items():
        bound_ms, bound_by = scan_bound(kind, b, s, d, n, 4)
        reps = plain_reps["bwd" if kind == "bwd" else "fwd"]
        info = ss.describe(kind, torch.float32, n)
        blocks = -(-d // info["channels"]) * b
        waves = blocks / (info["blocks_per_sm"] * sms)
        log(f"kernel {name} timing at one train-phase layer (B={b} S={s} "
            f"D={d} N={n} float32): kernel {ms[kind]:.4f} ms (median of "
            f"20) | plain {plain[kind]:.4f} ms (median of {reps}"
            f"{plain_note[kind]}) | bound {bound_ms:.4f} ms ({bound_by}) | "
            f"{bound_ms / ms[kind]:.1%} of bound")
        log(f"kernel {name} launch at that shape: {info['registers']} "
            f"registers a thread, {info['spill_bytes']} bytes spilled, "
            f"{info['threads']} threads and {info['smem_bytes']} bytes of "
            f"shared memory a block ({info['channels']} channels), "
            f"{info['blocks_per_sm']} blocks per SM | {blocks} blocks on "
            f"{sms} SMs = {waves:.3f} waves")
        rows[kind] = {"name": name, "route": "cuda",
                      "source": "src/repro_torch/kernels/csrc/"
                                "selective_scan.cu",
                      "replaces": f"src/repro/kernels/selective_scan.py:"
                                  f"{line}",
                      "launches": 0, "max_abs_err": err[kind],
                      "ms": ms[kind], "plain_ms": plain[kind],
                      "bound_ms": bound_ms, "bound_by": bound_by,
                      "library_ms": None}
    log("library_ms: null for the three scan kernels -- no single PyTorch "
        "call computes a selective scan (torch has no associative scan "
        "operator; the plain route is a loop of elementwise kernels)")
    return [rows["fwd"], rows["ckpt"], rows["bwd"]]


# --------------------------- serve phase ----------------------------- #
def make_requests(cfg, seed: int, new_tokens: int = SERVE["new_tokens"]):
    """The serve phase's requests; a vision config's each carry
    ``frontend_tokens`` soft tokens from ``vision_patches``, drawn from a
    generator seeded with the request id (as the serve CLI draws them)."""
    rng = np.random.default_rng(seed)
    system = [rng.integers(0, cfg.vocab_size, SERVE["system_len"])
              for _ in range(SERVE["system_prompts"])]
    reqs = []
    for rid in range(SERVE["requests"]):
        sfx = rng.integers(0, cfg.vocab_size,
                           int(rng.integers(*SERVE["suffix"], endpoint=True)))
        prompt = np.concatenate([system[rid % len(system)], sfx])
        soft = None
        if cfg.frontend == "vision":
            gen = torch.Generator(device="cuda")
            gen.manual_seed(rid)
            soft = vision_patches(gen, cfg, 1, "cuda")
        reqs.append(Request(rid=rid, prompt=prompt.astype(np.int32),
                            max_new_tokens=new_tokens, soft_emb=soft))
    return reqs


def snapshot_decode(server) -> dict:
    """The next decode step's inputs for the running rows that have room
    for their next token, and a copy of the live KV pool: the mid-run
    state ``decode_check`` replays once the run is over, so the check
    does not stall the requests being served."""
    rows = [r for _, r in server.scheduler.running()
            if len(r.table.blocks) * server.block_size > r.ctx_len]
    assert rows, "no running request to check"
    bt = np.zeros((len(rows), server.max_blocks_per_seq), np.int32)
    for i, r in enumerate(rows):
        bt[i, :len(r.table.blocks)] = r.table.blocks
    return {"batch": {"tokens": torch.tensor([[r.out[-1]] for r in rows],
                                             dtype=torch.int32).cuda()},
            "block_tables": torch.from_numpy(bt).cuda(),
            "ctx_lens": torch.tensor([r.ctx_len for r in rows],
                                     dtype=torch.int32).cuda(),
            "pages": {k: v.clone() for k, v in server.pages.items()}}


def decode_check(server, snap: dict) -> float:
    """The snapshot's decode step through the kernel and through the
    plain gathered attention, each on its own copy of the pool; returns
    the largest logit difference.  Also runs the kernel-path step a
    second time (bitwise equal: no atomics anywhere in the step, the MoE
    combine included), times it and profiles it."""
    def step(use_kernel):
        pages = {k: v.clone() for k, v in snap["pages"].items()}
        torch.cuda.synchronize()
        return lambda: decode_step_paged(
            server.params, server.cfg, pages, snap["batch"],
            snap["block_tables"], snap["ctx_lens"],
            use_kernel=use_kernel)[0]

    rows = snap["ctx_lens"].shape[0]
    logits = {}
    for use_kernel in (True, False):
        run = step(use_kernel)
        t0 = time.perf_counter()
        lg = run()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        assert torch.isfinite(lg).all(), "non-finite decode logits"
        logits[use_kernel] = lg
        log(f"decode step of {rows} rows, "
            f"{'kernel' if use_kernel else 'plain'} attention: host wall "
            f"{ms:.2f} ms")
    again = step(True)()
    assert torch.equal(again, logits[True]), \
        "two identical decode steps differ"
    log(f"decode step of {rows} rows ({server.cfg.name}): a second call "
        f"on a fresh copy of the pool is bitwise equal")
    log(f"profile of one decode step (kernel path): "
        f"{profile_step(step(True))}")
    return float((logits[True] - logits[False]).abs().max())


def serve_reckoning(cfg, max_len: int) -> float:
    """GB the serve phase holds at its peak: the bf16 weights, the page
    pool of SERVE['batch'] slots and its three copies (the mid-run
    snapshot and the decode check's two), and 1 GB of activations."""
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(
        init_params(cfg, device="meta")))
    blocks = SERVE["batch"] * -(-max_len // SERVE["block_size"]) + 1
    pool = (2 * cfg.num_layers * blocks * SERVE["block_size"]
            * cfg.num_kv_heads * cfg.resolved_head_dim * 2)
    return (weights + 4 * pool) / 1e9 + 1.0


def serve_phase(seed: int, kernel_row, arch: str = SERVE_ARCH) -> dict:
    """``arch`` at its published width through the server (at
    VISION_SERVE's depth and tokens for the vision config, whose requests
    carry their soft tokens), reckoned against the card's memory first.
    The launch count adds to ``kernel_row`` when one is given (the MoE
    serve phase passes none).  Returns the greedy streams, the tok/s and
    the cached prefix fraction (the fleet phase holds its own to them)."""
    cfg = get_config(arch)
    new_tokens = SERVE["new_tokens"]
    if cfg.frontend == "vision":
        cfg = with_layer_units(cfg, VISION_SERVE["layers"])
        new_tokens = VISION_SERVE["new_tokens"]
    max_len = (SERVE["system_len"] + SERVE["suffix"][1] + new_tokens
               + cfg.frontend_tokens + SERVE["block_size"])
    total_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    reckoned = serve_reckoning(cfg, max_len)
    assert reckoned < total_gb, (reckoned, total_gb)
    t0 = time.perf_counter()
    params = init_params(cfg, seed=seed, device="cuda")
    torch.cuda.synchronize()
    log(f"serve {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads x "
        f"{cfg.resolved_head_dim}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, {cfg.dtype}; {cfg.param_count() / 1e9:.3f}"
        f"B params, random weights (seed {seed}) in "
        f"{time.perf_counter() - t0:.1f} s; {cfg.frontend_tokens} soft "
        f"tokens a request | reckoned peak {reckoned:.2f} GB (weights, the "
        f"page pool and its three copies, 1 GB of activations) of the "
        f"card's {total_gb:.3f} GB")
    kw = dict(block_size=SERVE["block_size"],
              prefill_chunk=SERVE["prefill_chunk"], device="cuda")
    # warm-up on a throwaway server: cuBLAS handles, allocator, kernel
    # library load -- set-up, not serving time
    warm = ContinuousBatchingServer(cfg, params, 1, max_len=64, **kw)
    warm.submit(Request(rid=0, prompt=np.arange(20, dtype=np.int32),
                        max_new_tokens=3))
    warm.run()
    del warm
    server = ContinuousBatchingServer(cfg, params, SERVE["batch"],
                                      max_len=max_len, seed=seed, **kw)
    pool_gb = sum(p.numel() * p.element_size()
                  for p in server.pages.values()) / 1e9
    log(f"KV pool: {server.allocator.num_blocks} blocks of "
        f"{SERVE['block_size']} tokens, {pool_gb:.3f} GB")
    reqs = make_requests(cfg, seed, new_tokens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for req in reqs:
        server.submit(req)
    results = server.run(max_steps=40)
    t_probe = time.perf_counter()
    probe = snapshot_decode(server)
    t_probe = time.perf_counter() - t_probe
    results.update(server.run())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    err = decode_check(server, probe)   # launches here do not count
    del probe

    snap = server.snapshot()
    assert sorted(results) == list(range(SERVE["requests"]))
    for rid, toks in results.items():
        assert len(toks) == new_tokens, (rid, len(toks))
        assert all(0 <= t < cfg.vocab_size for t in toks), rid
    assert err <= TOL[torch.bfloat16], \
        f"mid-run decode logits kernel vs plain differ by {err}"
    if cfg.frontend == "vision":
        # the reference's rule: a vision request's prefix is not its
        # tokens, so it is never cached
        assert snap.cached_prefix_tokens == 0, snap.cached_prefix_tokens
        log("serve: cached prefix tokens 0, as expected: vision requests "
            "are never prefix-cached (the reference's rule)")
    else:
        assert snap.cached_prefix_tokens > 0, "prefix cache never hit"
    want = snap.decode_steps * cfg.num_layers
    assert counts["paged_attention"] == want, (counts, want)
    if kernel_row is not None:
        kernel_row["launches"] += counts["paged_attention"]
    tokens = sum(len(v) for v in results.values())
    log(f"serve: {len(results)} requests x {new_tokens} tokens, "
        f"{tokens} tokens in {wall:.3f} s = {tokens / (wall - t_probe):.1f} "
        f"tok/s (excluding {t_probe:.3f} s to copy the mid-run state)")
    log(f"serve: ttft p50 {snap.ttft_p50_ms:.1f} ms p99 "
        f"{snap.ttft_p99_ms:.1f} ms | decode steps {snap.decode_steps} | "
        f"prefill chunks {snap.prefill_chunks} | preemptions "
        f"{snap.preemptions} | prefill tokens computed "
        f"{snap.prefill_tokens_computed} | cached prefix tokens "
        f"{snap.cached_prefix_tokens} | peak kv occupancy "
        f"{snap.kv_peak_occupancy:.3f}")
    log(f"serve: paged_attention launches {counts['paged_attention']} = "
        f"{snap.decode_steps} decode steps x {cfg.num_layers} layers | "
        f"mid-run decode logits kernel vs plain max_abs_err {err:.3e} "
        f"(tol 5e-2) | max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB (reckoned "
        f"{reckoned:.2f})")
    if cfg.family == "moe":
        # every decode step's expert products read every expert's weights
        nbytes = (cfg.num_layers * 3 * cfg.num_experts * cfg.d_model
                  * cfg.d_ff * 2)
        log(f"serve: a decode step's expert einsums read all "
            f"{cfg.num_experts} experts of {cfg.num_layers} layers, "
            f"{nbytes / 1e9:.2f} GB: bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.3f} ms a step at 3.35 TB/s "
            f"(the profiled step above: device busy vs this bound) | "
            f"the MoE FFN launches no kernel of the port: plain einsums, "
            f"as in the reference")
    return {"streams": results, "tok_s": tokens / (wall - t_probe),
            "cached_fraction": snap.cached_token_fraction}


# --------------------------- train phase ----------------------------- #
def lm_batch(cfg, batch: int, seq: int, step: int, seed: int = 0) -> dict:
    """``seq`` positions a row on the card through
    ``launch.train.build_batch``: the pipeline's tokens and labels, with
    the encoder-decoder's frames [B, seq, D], or a vision config's
    ``frontend_tokens`` soft tokens in front of seq - frontend_tokens
    tokens (the chunked attention needs the positions, not the tokens, to
    fill its 1024-key chunks); the frontend draws seeded from (seed,
    step)."""
    n = seq - cfg.frontend_tokens if cfg.frontend == "vision" else seq
    data = SyntheticLMDataset(DataConfig(cfg.vocab_size, n, batch))
    return build_batch(cfg, data.batch(step),
                       step_generator(seed, step, "cuda"), "cuda")


def timed_step(step_fn, state, batch):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, metrics = step_fn(state, batch)
    loss = float(metrics["loss"])           # waits for the device
    torch.cuda.synchronize()
    return state, metrics, loss, time.perf_counter() - t0


def train_phase(seed: int, rows: dict) -> None:
    cfg = with_layer_units(get_config(TRAIN_ARCH), TRAIN["layers"])
    t0 = time.perf_counter()
    state = init_train_state(init_params(cfg, seed=seed, device="cuda"))
    torch.cuda.synchronize()
    log(f"train {cfg.name}: {cfg.num_layers} of 64 layers, d_model "
        f"{cfg.d_model}, d_inner {cfg.d_inner}, ssm_state {cfg.ssm_state}, "
        f"dt_rank {cfg.dt_rank}, conv {cfg.ssm_conv}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}; {cfg.param_count() / 1e9:.3f}B "
        f"params, random weights (seed {seed}) and AdamW state in "
        f"{time.perf_counter() - t0:.1f} s")
    steps = TRAIN["steps"]
    opt_cfg = AdamWConfig(lr=TRAIN["lr"], warmup_steps=max(steps // 20, 1),
                          total_steps=steps, schedule="cosine")
    step_fn = make_train_step(cfg, opt_cfg)
    batches = [lm_batch(cfg, TRAIN["batch"], TRAIN["seq"], i)
               for i in range(steps + 1)]
    tokens = TRAIN["batch"] * TRAIN["seq"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    losses, walls = [], []
    for i in range(steps):
        state, metrics, loss, wall = timed_step(step_fn, state, batches[i])
        losses.append(loss)
        walls.append(wall)
        log(f"train step {i}: loss {loss:.4f} | grad_norm "
            f"{float(metrics['grad_norm']):.3f} | lr {metrics['lr']:.2e} | "
            f"wall {wall * 1e3:.1f} ms | {tokens / wall:.1f} tok/s")
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    want = dict.fromkeys(ops.WRAPPERS, 0)
    want.update(selective_scan_fwd_ckpt=2 * cfg.num_layers * steps,
                selective_scan_bwd=cfg.num_layers * steps)
    assert counts == want, (counts, want)
    rows["selective_scan_fwd_ckpt"]["launches"] = counts[
        "selective_scan_fwd_ckpt"]
    rows["selective_scan_bwd"]["launches"] = counts["selective_scan_bwd"]
    steady = float(np.median(walls[1:]))
    log(f"train: {steps} steps of {TRAIN['batch']} x {TRAIN['seq']} "
        f"tokens, loss {losses[0]:.4f} -> {losses[-1]:.4f} | step wall "
        f"median of steps 1-{steps - 1} {steady * 1e3:.1f} ms (step 0 "
        f"{walls[0] * 1e3:.1f} ms) = {tokens / steady:.1f} tok/s | "
        f"max_memory_allocated {peak_gb:.3f} GB")
    log(f"train: launches per step: selective_scan_fwd_ckpt "
        f"{counts['selective_scan_fwd_ckpt'] // steps} (2 x "
        f"{cfg.num_layers} layers: forward and remat) | selective_scan_bwd "
        f"{counts['selective_scan_bwd'] // steps} (one per layer)")
    holder = {"state": state}

    def one_step():
        holder["state"], _ = step_fn(holder["state"], batches[steps])
    log(f"profile of one train step (kernel route): "
        f"{profile_step(one_step)}")


# ------------------------- route check phase ------------------------- #
def route_phase(seed: int) -> None:
    """One train step of a float32 2-layer falcon-mamba-7b at full width
    through the scan kernels and through the plain chunked scan, from the
    same weights and batch; first the gradients themselves (Adam's first
    update follows the gradient's sign, not its size)."""
    cfg = dataclasses.replace(
        with_layer_units(get_config(TRAIN_ARCH), ROUTE["layers"]),
        dtype="float32")
    opt_cfg = AdamWConfig(lr=ROUTE["lr"], warmup_steps=1, total_steps=5)
    batch = lm_batch(cfg, ROUTE["batch"], ROUTE["seq"], 0)
    out = {}
    for use_kernel in (True, False):
        state = init_train_state(init_params(cfg, seed=seed, device="cuda"))
        _, _, grads = value_and_grad(state.params, cfg, batch,
                                     use_kernel=use_kernel)
        step_fn = make_train_step(cfg, opt_cfg, use_kernel=use_kernel)
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        state, metrics, loss, wall = timed_step(step_fn, state, batch)
        counts = ops.launch_counts()
        if use_kernel:
            assert counts["selective_scan_bwd"] == cfg.num_layers, counts
        else:
            assert not any(counts.values()), counts
        out[use_kernel] = (loss, float(metrics["grad_norm"]),
                           tree_leaves(grads), tree_leaves(state.params))
        log(f"route {'kernel' if use_kernel else 'plain '}: loss "
            f"{loss:.6f} | grad_norm {out[use_kernel][1]:.6f} | step wall "
            f"{wall * 1e3:.1f} ms | max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        del state, step_fn, grads
        torch.cuda.empty_cache()
    (lk, nk, gk, pk), (lp, n_p, gp, pp) = out[True], out[False]
    d_loss = abs(lk - lp) / abs(lp)
    d_gnorm = abs(nk - n_p) / abs(n_p)
    d_grad = max(float((a - b).abs().max() / (b.abs().max() + 1e-30))
                 for a, b in zip(gk, gp))
    d_param = max(float((a - b).abs().max()) for a, b in zip(pk, pp))
    # float32 throughout: the two scans add in other orders (sequential
    # recurrence vs doubling prefix), ~1e-6 relative per element; each
    # gradient is held to the reference's bound for the scan's (max-abs
    # error below 1e-4 of its max-abs); Adam's eps (1e-8) bounds what the
    # noise can do to one update
    assert d_loss < 1e-4 and d_gnorm < 1e-4 and d_grad < 1e-4 \
        and d_param < 1e-5, (d_loss, d_gnorm, d_grad, d_param)
    log(f"route kernel vs plain ({cfg.num_layers} layers, float32, "
        f"{ROUTE['batch']} x {ROUTE['seq']}): loss rel diff {d_loss:.3e} "
        f"(tol 1e-4) | grad_norm rel diff {d_gnorm:.3e} (tol 1e-4) | "
        f"gradients, max over leaves of err / max|plain| {d_grad:.3e} (tol "
        f"1e-4) | params after the update max abs diff {d_param:.3e} (tol "
        f"1e-5)")


# ------------------------ prefill + decode --------------------------- #
def decode_phase(seed: int, rows: dict) -> None:
    """Prompts through ``prefill`` (forward-only scan kernel), then greedy
    decode steps, each held against the teacher-forced forward."""
    cfg = dataclasses.replace(
        with_layer_units(get_config(TRAIN_ARCH), ROUTE["layers"]),
        dtype="float32")
    params = init_params(cfg, seed=seed, device="cuda")
    prompt = lm_batch(cfg, DECODE["batch"], DECODE["prompt"], 1)["tokens"]
    prefill_step = make_prefill_step(cfg)
    decode_step = make_decode_step(cfg)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, {"tokens": prompt})
    steps = [logits]
    toks = []
    for _ in range(DECODE["new_tokens"]):
        nxt = steps[-1][:, -1].argmax(-1, keepdim=True).to(torch.int32)
        toks.append(nxt)
        logits, cache = decode_step(params, cache, {"tokens": nxt})
        steps.append(logits)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = dict.fromkeys(ops.WRAPPERS, 0)
    want.update(selective_scan=cfg.num_layers)
    assert counts == want, (counts, want)
    rows["selective_scan"]["launches"] = counts["selective_scan"]
    seq = torch.cat([prompt] + toks, dim=1)
    with torch.no_grad():
        full, _ = forward_train(params, cfg, {"tokens": seq},
                                use_kernel=True)
    got = torch.cat(steps, dim=1)
    want_logits = full[:, DECODE["prompt"] - 1:]
    err = float((got - want_logits).abs().max())
    # float32: the same arithmetic in other GEMM shapes (M = 2 per decode
    # step vs M = 2 x 72) and summation orders
    assert torch.isfinite(got).all() and err < 1e-3, err
    assert int(cache["pos"]) == DECODE["prompt"] + DECODE["new_tokens"]
    log(f"prefill + decode ({cfg.num_layers} layers, float32): prompts "
        f"{DECODE['batch']} x {DECODE['prompt']}, {DECODE['new_tokens']} "
        f"greedy tokens in {wall * 1e3:.1f} ms | selective_scan launches "
        f"{counts['selective_scan']} (prefill, one per layer) | logits vs "
        f"teacher-forced forward max_abs_err {err:.3e} (tol 1e-3)")


# ------------------------- flash attention ---------------------------- #
def flash_case(b, h, hkv, s, d, dtype, seed):
    """Normal q [b, h, s, d] and k, v [b, hkv, s, d] on the card."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for shape in ((b, h, s, d), (b, hkv, s, d), (b, hkv, s, d))]


def kept_pairs(s: int, causal: bool, window) -> int:
    """(query, key) pairs of one head that the mask keeps."""
    q = np.arange(s)
    lo = np.zeros(s, np.int64) if window is None else \
        np.maximum(q - window + 1, 0)
    hi = q + 1 if causal else np.full(s, s)
    return int(np.maximum(hi - lo, 0).sum())


def flash_bound(q, k, causal, window):
    """(least ms, "bytes" | "operations") of one call: 4 D operations per
    kept (query, key) pair and query head (Q K^T and P V) at the inputs'
    type's peak; q, k, v read once, o and lse written once."""
    b, h, s, d = q.shape
    ops_ = 4 * d * kept_pairs(s, causal, window) * b * h
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size() + 4 * b * h * s
    t_ops = ops_ / PEAK_OPS_PER_S[q.dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def sdpa(q, k, v, causal, window):
    """Context only: one ``scaled_dot_product_attention`` call (GQA by
    ``enable_gqa``; a window as a boolean mask)."""
    mask = None
    if window is not None:
        s = q.shape[2]
        i = torch.arange(s, device="cuda")
        mask = (i[None, :] > i[:, None] - window)
        if causal:
            mask &= i[None, :] <= i[:, None]
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=mask, is_causal=causal and mask is None,
        enable_gqa=k.shape[1] != q.shape[1])


def bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at the magnitude of each element (8 significant
    bits)."""
    e = torch.floor(torch.log2(x.abs().float().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def bf16_ratio(o: torch.Tensor, o_ref: torch.Tensor) -> float:
    """The bf16 check: the largest |o - o_ref| / (bf16_ulp(o_ref) +
    O_FLOOR) over the elements; it passes at 1 or less."""
    return float(((o.float() - o_ref).abs()
                  / (bf16_ulp(o_ref) + O_FLOOR)).max())


def flash_faulty(q, k, v, fault: str, causal: bool = True,
                 window=None) -> torch.Tensor:
    """Attention (causal or not, with ``window``, if given) of q's heads
    over k's and v's, which have as many heads or one (MQA, broadcast), as
    the plain version computes it in float32, with one deliberate fault of
    FLASH_FAULTS; the output rounded to q's dtype."""
    s = q.shape[2]
    qf, kf, vf = q.float() / q.shape[3] ** 0.5, k.float(), v.float()
    keys = torch.arange(s, device=q.device)[None, :]
    outs = []
    for q0 in range(0, s, FLASH_CHUNK):
        rows = torch.arange(q0, q0 + FLASH_CHUNK, device=q.device)[:, None]
        keep = keys <= rows if causal else (keys >= 0) & (rows >= 0)
        if fault == FLASH_FAULTS[1]:
            # row 0 keeps its key: a causal row 0 has no other
            keep = keep & ((keys != rows) | (keys + rows == 0))
        elif fault == FLASH_FAULTS[2]:
            keep &= (rows < s // 2) | (keys >= 64)
        if window is not None:
            keep &= keys > rows - window
        logits = qf[:, :, q0:q0 + FLASH_CHUNK] @ kf.transpose(-1, -2)
        p = torch.softmax(logits.masked_fill(~keep, float("-inf")), dim=-1)
        if fault == FLASH_FAULTS[0]:
            p = p.to(torch.bfloat16).float()
        outs.append(p @ vf)
    return torch.cat(outs, dim=2).to(q.dtype)


def flash_kernel_phase(seed: int) -> dict:
    """Row 4 of the kernel table: the flash kernel against its plain
    version on the card (output and lse) at FLASH_CASES (the train, GQA,
    window and non-causal shapes) in bf16 and float32, timed beside its
    bound and one PyTorch call; the bf16 check shown to reject deliberate
    faults; the gradient of FlashAttentionFn against autograd through the
    plain version in float32, and in bf16 (the wgmma forward) against the
    plain backward; the plain backward timed at the train shape and at
    whisper-medium's layer."""
    err, main = 0.0, None
    for i, (label, b, h, hkv, s, d, causal, window) in enumerate(
            FLASH_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = flash_case(b, h, hkv, s, d, dtype, seed + 500 + i)
            variant = flash_variant(dtype, d)
            ops.reset_launch_counts()
            o, lse = flash_attention_cuda(q, k, v, causal, window)
            torch.cuda.synchronize()
            variants = ops.variant_launch_counts()["flash_attention"]
            assert variants == {**dict.fromkeys(variants, 0), variant: 1}, \
                (label, variant, variants)
            # float32 inputs hold the same values: the plain output before
            # its cast to q's dtype
            o_ref, lse_ref = flash_attention_ref(q.float(), k.float(),
                                                 v.float(), causal, window)
            torch.cuda.synchronize()
            e_o = float((o.float() - o_ref).abs().max())
            e_l = float((lse - lse_ref).abs().max())
            if dtype == torch.bfloat16:
                ratio = bf16_ratio(o, o_ref)
                check = (f"o max |err| / (1 bf16 ulp of the float32 plain "
                         f"output + {O_FLOOR:.0e}) {ratio:.4f} (tol 1) | o "
                         f"max_abs_err {e_o:.3e}")
                assert ratio <= 1.0 and e_l <= LSE_TOL, (label, dtype,
                                                         ratio, e_l)
            else:
                check = f"o max_abs_err {e_o:.3e} (tol {TOL[dtype]:.0e})"
                assert e_o <= TOL[dtype] and e_l <= LSE_TOL, (label, dtype,
                                                              e_o, e_l)
            if label in FAULT_CASES and dtype == torch.bfloat16:
                faults = {f: bf16_ratio(flash_faulty(q, k, v, f, causal,
                                                     window), o_ref)
                          for f in FLASH_FAULTS}
                assert min(faults.values()) > 1.0, faults
                log(f"kernel flash_attention bf16 check vs deliberate "
                    f"faults at the {label} shape: sound kernel {ratio:.4f}"
                    f" | " + " | ".join(f"{f} {r:.1f}"
                                        for f, r in faults.items())
                    + " (each must exceed 1)")
            del o, lse, o_ref, lse_ref
            ms = time_ms(lambda: flash_attention_cuda(q, k, v, causal,
                                                      window), reps=20)
            lib_ms = time_ms(lambda: sdpa(q, k, v, causal, window), reps=20)
            bound_ms, bound_by = flash_bound(q, k, causal, window)
            err = max(err, e_o)
            if label == ENCDEC_FLASH and dtype == torch.bfloat16:
                # whisper's train step runs the plain backward 72 times
                o, lse = flash_attention_cuda(q, k, v, causal, window)
                do = torch.randn(q.shape, device="cuda").to(q.dtype)
                bwd_ms = time_ms(lambda: flash_attention_bwd_ref(
                    q, k, v, o, lse, do, causal, window), reps=3, warmup=1)
                log(f"kernel flash_attention {label}: plain backward "
                    f"(flash_attention_bwd_ref, the train step's) "
                    f"{bwd_ms:.4f} ms")
                del o, lse, do
            log(f"kernel flash_attention {label}: B={b} H={h} Hkv={hkv} "
                f"S={s} D={d} causal={causal} window={window} "
                f"{str(dtype).split('.')[-1]}, variant {variant} "
                f"(variant_launches {variants}) | {check} "
                f"| lse max_abs_err "
                f"{e_l:.3e} (tol {LSE_TOL:.0e}) | kernel {ms:.4f} ms | "
                f"bound {bound_ms:.4f} ms ({bound_by}) | "
                f"{bound_ms / ms:.1%} of bound | sdpa "
                f"{lib_ms:.4f} ms"
                + (" (float32, TF32 off)" if dtype == torch.float32
                   else ""))
            if main is None:
                main = (q, k, v, causal, window, ms, lib_ms, bound_ms,
                        bound_by)
            else:
                del q, k, v
            torch.cuda.empty_cache()
    q, k, v, causal, window, ms, lib_ms, bound_ms, bound_by = main
    plain_ms = time_ms(lambda: flash_attention_ref(q, k, v, causal, window),
                       reps=5, warmup=1)
    # the earlier kernel (mma.sync, 64-row tiles) at the same shape
    old_ms = time_ms(lambda: flash_attention_cuda(q, k, v, causal, window,
                                                  variant="mma_sync"),
                     reps=20)
    o, lse = flash_attention_cuda(q, k, v, causal, window)
    do = torch.randn(q.shape, device="cuda").to(q.dtype)
    bwd_ms = time_ms(lambda: flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                     causal, window),
                     reps=3, warmup=1)
    log(f"kernel flash_attention timing ({FLASH_CASES[0][0]}, bf16): kernel "
        f"{ms:.4f} ms (wgmma variant) | the mma_sync variant (the earlier "
        f"kernel) {old_ms:.4f} ms | plain {plain_ms:.4f} ms (float32, query "
        f"chunks of 1024) | library {lib_ms:.4f} ms "
        f"(scaled_dot_product_attention, "
        f"is_causal) | bound {bound_ms:.4f} ms ({bound_by}; 989 TFLOP/s bf16 "
        f"H100 SXM data sheet) | plain backward (flash_attention_bwd_ref, "
        f"the train step's) {bwd_ms:.4f} ms")
    del q, k, v, o, lse, do, main
    torch.cuda.empty_cache()

    # gradient: kernel forward + plain backward vs autograd of the plain
    ins = flash_case(2, 8, 2, 512, 64, torch.float32, seed + 600)
    g_out = torch.randn(ins[0].shape, device="cuda")
    grads = {}
    for route in ("kernel", "plain"):
        leaves = [t.clone().requires_grad_() for t in ins]
        out = (ops.flash_attention(*leaves, causal=True, window=None)
               if route == "kernel"
               else flash_attention_ref(*leaves, True, None)[0])
        grads[route] = torch.autograd.grad(out, leaves, g_out)
    g_err = max(_rel_err(a, b) for a, b in zip(grads["kernel"],
                                               grads["plain"]))
    assert g_err < 1e-4, g_err
    log(f"flash_attention gradient (FlashAttentionFn: kernel forward, plain "
        f"backward) vs autograd of the plain version, B=2 H=8 Hkv=2 S=512 "
        f"D=64 float32: max over q, k, v of err / max|plain| {g_err:.3e} "
        f"(tol 1e-4)")

    # the same in bf16 through the wgmma forward, which the bf16 train step
    # runs: FlashAttentionFn against the plain backward fed the plain
    # forward's o and lse.  The routes differ only in o (each element within
    # 1.5 bf16 ulps) and lse (LSE_TOL), and each rounds its gradients to
    # bf16: 4 bf16 ulps of the largest gradient
    ins = flash_case(2, 8, 2, 512, 64, torch.bfloat16, seed + 601)
    g_out = torch.randn(ins[0].shape, device="cuda").to(torch.bfloat16)
    leaves = [t.clone().requires_grad_() for t in ins]
    ops.reset_launch_counts()
    got = torch.autograd.grad(
        ops.flash_attention(*leaves, causal=True, window=None), leaves, g_out)
    assert ops.variant_launch_counts()["flash_attention"] == {
        "simt_f32": 0, "mma_sync": 0, "wgmma": 1}
    o_ref, lse_ref = flash_attention_ref(*ins, True, None)
    want = flash_attention_bwd_ref(*ins, o_ref, lse_ref, g_out, True, None)
    g16_err = max(_rel_err(a, b.to(torch.bfloat16))
                  for a, b in zip(got, want))
    assert g16_err <= BF16_GRAD_TOL, g16_err
    log(f"flash_attention gradient in bf16 (FlashAttentionFn: wgmma forward, "
        f"plain backward) vs the plain backward from the plain forward's o "
        f"and lse, B=2 H=8 Hkv=2 S=512 D=64: max over q, k, v of err / "
        f"max|plain| {g16_err:.3e} (tol {BF16_GRAD_TOL:.3e}: 4 bf16 ulps)")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:116",
            "variant": "wgmma", "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


# ------------------------- dense train phase --------------------------- #
def dense_train_phase(seed: int, rows: dict) -> None:
    cfg = with_layer_units(get_config(DENSE_ARCH), DENSE_TRAIN["layers"])
    t0 = time.perf_counter()
    state = init_train_state(init_params(cfg, seed=seed, device="cuda"))
    torch.cuda.synchronize()
    log(f"dense train {cfg.name}: {cfg.num_layers} of 40 layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads} heads x {cfg.resolved_head_dim}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, {cfg.dtype}; "
        f"{cfg.param_count() / 1e9:.3f}B params, random weights (seed "
        f"{seed}) and AdamW state in {time.perf_counter() - t0:.1f} s")
    steps = DENSE_TRAIN["steps"]
    opt_cfg = AdamWConfig(lr=DENSE_TRAIN["lr"],
                          warmup_steps=max(steps // 20, 1),
                          total_steps=steps, schedule="wsd")
    step_fn = make_train_step(cfg, opt_cfg)
    batches = [lm_batch(cfg, DENSE_TRAIN["batch"], DENSE_TRAIN["seq"], i)
               for i in range(steps + 1)]
    tokens = DENSE_TRAIN["batch"] * DENSE_TRAIN["seq"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    ops.reset_launch_counts()
    losses, walls = [], []
    for i in range(steps):
        state, metrics, loss, wall = timed_step(step_fn, state, batches[i])
        losses.append(loss)
        walls.append(wall)
        log(f"dense train step {i}: loss {loss:.4f} | grad_norm "
            f"{float(metrics['grad_norm']):.3f} | lr {metrics['lr']:.2e} | "
            f"wall {wall * 1e3:.1f} ms | {tokens / wall:.1f} tok/s")
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    want = dict.fromkeys(ops.WRAPPERS, 0)
    want["flash_attention"] = 2 * cfg.num_layers * steps
    assert counts == want, (counts, want)
    variants = ops.variant_launch_counts()["flash_attention"]
    assert variants == {"simt_f32": 0, "mma_sync": 0,
                        "wgmma": want["flash_attention"]}, variants
    rows["flash_attention"]["launches"] = counts["flash_attention"]
    steady = float(np.median(walls[1:]))
    log(f"dense train: {steps} steps of {DENSE_TRAIN['batch']} x "
        f"{DENSE_TRAIN['seq']} tokens, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} | step wall median of steps 1-{steps - 1} "
        f"{steady * 1e3:.1f} ms (step 0 {walls[0] * 1e3:.1f} ms) = "
        f"{tokens / steady:.1f} tok/s | max_memory_allocated {peak_gb:.3f} GB")
    log(f"dense train: flash_attention launches per step "
        f"{counts['flash_attention'] // steps} (2 x {cfg.num_layers} layers: "
        f"forward and remat), every one the wgmma variant")
    holder = {"state": state}

    def one_step():
        holder["state"], _ = step_fn(holder["state"], batches[steps])
    log(f"profile of one dense train step (kernel route): "
        f"{profile_step(one_step)}")


def dense_lr_witness(seed: int) -> None:
    """Whether the dense train phase's loss rise at a learning rate of
    WITNESS_LR comes from the flash kernel: the same steps through the
    kernel route and through the plain chunked route (use_kernel=False:
    no kernel at all), from the same weights and batches."""
    cfg = with_layer_units(get_config(DENSE_ARCH), DENSE_TRAIN["layers"])
    steps = DENSE_TRAIN["steps"]
    opt_cfg = AdamWConfig(lr=WITNESS_LR, warmup_steps=max(steps // 20, 1),
                          total_steps=steps, schedule="wsd")
    batches = [lm_batch(cfg, DENSE_TRAIN["batch"], DENSE_TRAIN["seq"], i)
               for i in range(steps)]
    for use_kernel in (True, False):
        state = init_train_state(init_params(cfg, seed=seed, device="cuda"))
        step_fn = make_train_step(cfg, opt_cfg, use_kernel=use_kernel)
        torch.cuda.reset_peak_memory_stats()
        losses, norms, walls = [], [], []
        for batch in batches:
            state, metrics, loss, wall = timed_step(step_fn, state, batch)
            losses.append(loss)
            norms.append(float(metrics["grad_norm"]))
            walls.append(wall)
        log(f"lr witness, {'kernel' if use_kernel else 'plain'} route, "
            f"{cfg.num_layers} layers, lr {WITNESS_LR:.0e} (wsd): loss "
            + " ".join(f"{x:.4f}" for x in losses) + " | grad_norm "
            + " ".join(f"{x:.3f}" for x in norms) + f" | step wall median "
            f"{float(np.median(walls)) * 1e3:.1f} ms | max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        del state, step_fn
        torch.cuda.empty_cache()


def attention_layers(cfg) -> int:
    """The attention calls of one forward of ``cfg``: the hybrid's local
    blocks; the encoder-decoder's encoder layers and each decoder layer's
    two (self and cross); every layer of the other families."""
    if cfg.family == "encdec":
        return cfg.encoder_layers + 2 * cfg.num_layers
    if cfg.family != "hybrid":
        return cfg.num_layers
    pattern = cfg.block_pattern
    return sum(pattern[i % len(pattern)] == "local"
               for i in range(cfg.num_layers))


def dense_route_phase(seed: int, arch: str = DENSE_ARCH) -> None:
    """One train step of a float32 ``arch`` at full width (DENSE_ROUTE's
    layers; the hybrid's HYBRID_ROUTE_UNITS pattern cycles and its tail)
    through the flash kernel (the simt_f32 variant: float32) and through
    the plain chunked attention, from the same weights and batch; first
    the gradients themselves.  The kernel route's gradients and updated
    params wait on the host, each leaf brought back to be compared; the
    plain route's are compared as they come and then freed (the
    hybrid's 5 layers hold 2.5 B float32 params: the two routes' states
    would not fit the card together)."""
    units = (HYBRID_ROUTE_UNITS if arch == HYBRID_ARCH
             else DENSE_ROUTE["layers"])
    cfg = dataclasses.replace(with_layer_units(get_config(arch), units),
                              dtype="float32")
    opt_cfg = AdamWConfig(lr=DENSE_ROUTE["lr"], warmup_steps=1,
                          total_steps=5, schedule="wsd")
    batch = lm_batch(cfg, DENSE_ROUTE["batch"], DENSE_ROUTE["seq"], 0, seed)
    out, launches = {}, {}
    for use_kernel in (True, False):
        state = init_train_state(init_params(cfg, seed=seed, device="cuda"))
        _, _, grads = value_and_grad(state.params, cfg, batch,
                                     use_kernel=use_kernel)
        grads = tree_leaves(grads)
        if use_kernel:
            kept = [t.cpu() for t in grads]
        else:
            d_grad = max(_rel_err(a.cuda(), b) for a, b in zip(kept, grads))
            del kept
        del grads
        step_fn = make_train_step(cfg, opt_cfg, use_kernel=use_kernel)
        ops.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        state, metrics, loss, wall = timed_step(step_fn, state, batch)
        counts = ops.launch_counts()
        variants = ops.variant_launch_counts()["flash_attention"]
        want = dict.fromkeys(ops.WRAPPERS, 0)
        want_variants = dict.fromkeys(variants, 0)
        if use_kernel:
            want["flash_attention"] = 2 * attention_layers(cfg)
            want_variants["simt_f32"] = 2 * attention_layers(cfg)
            launches = variants
        assert counts == want, (arch, counts, want)
        assert variants == want_variants, (arch, variants, want_variants)
        params = tree_leaves(state.params)
        if use_kernel:
            kept_params = [t.cpu() for t in params]
        else:
            d_param = max(float((a.cuda() - b).abs().max())
                          for a, b in zip(kept_params, params))
        out[use_kernel] = (loss, float(metrics["grad_norm"]))
        log(f"dense route {arch} {'kernel' if use_kernel else 'plain '}: "
            f"loss {loss:.6f} | grad_norm {out[use_kernel][1]:.6f} | step "
            f"wall {wall * 1e3:.1f} ms | max_memory_allocated "
            f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
        del state, step_fn, params, metrics
        torch.cuda.empty_cache()
    del kept_params
    torch.cuda.empty_cache()
    (lk, nk), (lp, n_p) = out[True], out[False]
    d_loss = abs(lk - lp) / abs(lp)
    d_gnorm = abs(nk - n_p) / abs(n_p)
    # float32 throughout: the kernel and the chunked path sum the softmax
    # in other orders (and the backward is the flash recomputation vs
    # autograd of the chunk steps), ~1e-6 relative; the same bounds as
    # the scan's route check
    assert d_loss < 1e-4 and d_gnorm < 1e-4 and d_grad < 1e-4 \
        and d_param < 1e-5, (arch, d_loss, d_gnorm, d_grad, d_param)
    log(f"dense route {arch} kernel vs plain ({cfg.num_layers} layers"
        + (f" + {cfg.encoder_layers} encoder layers" if cfg.encoder_layers
           else "")
        + f", {cfg.num_heads}/{cfg.num_kv_heads} heads x "
        f"{cfg.resolved_head_dim}, float32, {DENSE_ROUTE['batch']} x "
        f"{DENSE_ROUTE['seq']} positions"
        + (f" ({cfg.frontend_tokens} of them soft tokens)"
           if cfg.frontend_tokens else "")
        + f"): flash_attention launches in the kernel "
        f"step {launches} | loss rel diff {d_loss:.3e} (tol 1e-4) | "
        f"grad_norm rel diff {d_gnorm:.3e} (tol 1e-4) | gradients, max over "
        f"leaves of err / max|plain| {d_grad:.3e} (tol 1e-4) | params "
        f"after the update max abs diff {d_param:.3e} (tol 1e-5)")


def dense_decode_phase(seed: int) -> None:
    """Prompts through ``prefill`` at full depth (the flash kernel in every
    layer), the cache padded by 8 positions, then greedy decode steps,
    each held against the teacher-forced forward."""
    cfg = get_config(DENSE_ARCH)
    params = init_params(cfg, seed=seed, device="cuda")
    b, n_prompt = DENSE_DECODE["batch"], DENSE_DECODE["prompt"]
    prompt = lm_batch(cfg, b, n_prompt, 1)["tokens"]
    prefill_step = make_prefill_step(cfg)
    decode_step = make_decode_step(cfg)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, {"tokens": prompt})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = dict.fromkeys(ops.WRAPPERS, 0)
    want["flash_attention"] = cfg.num_layers
    assert counts == want, (counts, want)
    variants = ops.variant_launch_counts()["flash_attention"]
    assert variants == {"simt_f32": 0, "mma_sync": 0,
                        "wgmma": cfg.num_layers}, variants
    pad = (0, 0, 0, 0, 0, DENSE_DECODE["headroom"])
    cache = dict(cache, k=torch.nn.functional.pad(cache["k"], pad),
                 v=torch.nn.functional.pad(cache["v"], pad))
    steps, toks = [logits], []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(DENSE_DECODE["new_tokens"]):
        nxt = steps[-1][:, -1].argmax(-1, keepdim=True).to(torch.int32)
        toks.append(nxt)
        logits, cache = decode_step(params, cache, {"tokens": nxt})
        steps.append(logits)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    assert not any(ops.launch_counts().values()), ops.launch_counts()
    del cache
    # teacher forcing over prompt + generated tokens, filled up to a whole
    # KV chunk (the chunked branch needs S % 1024 == 0); causal, so the
    # filler changes no position before it
    seq = torch.cat([prompt] + toks, dim=1)
    fill = -seq.shape[1] % 1024
    seq = torch.nn.functional.pad(seq, (0, fill))
    with torch.no_grad():
        full, _ = forward_train(params, cfg, {"tokens": seq})
    got = torch.cat(steps, dim=1)
    want_logits = full[:, n_prompt - 1:n_prompt + DENSE_DECODE["new_tokens"]]
    del full
    err = float((got - want_logits).abs().max())
    # bf16 model: both sides round every GEMM output and the logits to
    # bf16, in GEMMs of other shapes (M = 2 per decode step vs 2 x 5120);
    # held to two bf16 ulps of the largest logit (ROADMAP C5's floor is
    # one)
    tol = 2 * float(bf16_ulp(want_logits.abs().max()))
    assert torch.isfinite(got).all() and err <= tol, (err, tol)
    log(f"dense prefill + decode ({cfg.num_layers} layers, {cfg.dtype}): "
        f"prefill {b} x {n_prompt} tokens in {t_prefill * 1e3:.1f} ms "
        f"(flash_attention launches {counts['flash_attention']}, one per "
        f"layer, all wgmma) | cache padded by {DENSE_DECODE['headroom']} | "
        f"{DENSE_DECODE['new_tokens']} greedy decode steps in "
        f"{t_decode * 1e3:.1f} ms (no kernel: direct attention over the "
        f"cache, as in the reference) | logits vs teacher-forced forward "
        f"max_abs_err {err:.3e} (tol {tol:.3e}: 2 bf16 ulps of the largest "
        f"logit)")


# ---------------------------- hybrid phase ---------------------------- #
def hybrid_decode_phase(seed: int, rows: dict) -> None:
    """recurrentgemma-9b at full width and depth: a 2 x 4096 prompt
    through ``prefill`` (one flash launch, ``mma_sync`` at D 256, for each
    of the 12 local layers), then greedy steps over the ring caches (no
    launch: direct attention over the window, the RG-LRU's single step);
    the prefill's and the first step's logits held against the
    teacher-forced forward, every step's error logged."""
    cfg = get_config(HYBRID_ARCH)
    params = init_params(cfg, seed=seed, device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    n_local = attention_layers(cfg)
    b, n_prompt = HYBRID_DECODE["batch"], HYBRID_DECODE["prompt"]
    new = HYBRID_DECODE["new_tokens"]
    prompt = lm_batch(cfg, b, n_prompt, 1)["tokens"]
    prefill_step = make_prefill_step(cfg)
    decode_step = make_decode_step(cfg)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, {"tokens": prompt})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = dict.fromkeys(ops.WRAPPERS, 0)
    want["flash_attention"] = n_local
    assert counts == want, (counts, want)
    variants = ops.variant_launch_counts()["flash_attention"]
    assert variants == {"simt_f32": 0, "mma_sync": n_local,
                        "wgmma": 0}, variants
    rows["flash_attention"]["launches"] += counts["flash_attention"]
    assert tuple(cache["k"].shape) == (
        n_local, b, cfg.local_window, 1, cfg.resolved_head_dim), \
        cache["k"].shape
    steps, toks = [logits], []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(new):
        nxt = steps[-1][:, -1].argmax(-1, keepdim=True).to(torch.int32)
        toks.append(nxt)
        logits, cache = decode_step(params, cache, {"tokens": nxt})
        steps.append(logits)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    assert not any(ops.launch_counts().values()), ops.launch_counts()
    assert int(cache["pos"]) == n_prompt + new
    del cache
    # teacher forcing over prompt + generated tokens, filled up to a whole
    # KV chunk (the chunked branch needs S % 1024 == 0); causal, so the
    # filler changes no position before it
    seq = torch.cat([prompt] + toks, dim=1)
    seq = torch.nn.functional.pad(seq, (0, -seq.shape[1] % 1024))
    with torch.no_grad():
        full, _ = forward_train(params, cfg, {"tokens": seq})
    got = torch.cat(steps, dim=1)
    want_logits = full[:, n_prompt - 1:n_prompt + new]
    del full
    errs = (got - want_logits).abs().amax(dim=(0, 2))
    # bf16 model: both sides round every GEMM output and the logits to
    # bf16, in GEMMs of other shapes (M = 2 per decode step vs 2 x 5120),
    # and the RG-LRU state comes from the sequential step vs the chunked
    # doubling scan; the dense decode check's bound, 2 bf16 ulps of the
    # largest logit, on the prefill's and the first step's logits
    tol = 2 * float(bf16_ulp(want_logits.abs().max()))
    assert torch.isfinite(got).all() and float(errs[:2].max()) <= tol, \
        (errs.tolist(), tol)
    log(f"hybrid prefill + decode ({cfg.num_layers} layers: {n_local} "
        f"local MQA {cfg.num_heads}/{cfg.num_kv_heads} x "
        f"{cfg.resolved_head_dim}, window {cfg.local_window}, "
        f"{cfg.num_layers - n_local} RG-LRU; {n_params / 1e9:.3f}B params "
        f"in the tree, {cfg.dtype}): prefill {b} x {n_prompt} tokens in "
        f"{t_prefill * 1e3:.1f} ms (flash_attention launches "
        f"{counts['flash_attention']}, one per local layer, all mma_sync) | "
        f"{new} greedy decode steps in {t_decode * 1e3:.1f} ms = "
        f"{t_decode / new * 1e3:.1f} ms a step (no kernel: direct attention "
        f"over the ring of {cfg.local_window}, the RG-LRU's single step) | "
        f"logits vs teacher-forced forward max_abs_err: prefill "
        f"{float(errs[0]):.3e}, first step {float(errs[1]):.3e} (tol "
        f"{tol:.3e}: 2 bf16 ulps of the largest logit), all {new} steps "
        f"{float(errs[1:].max()):.3e} (not held)")


def hybrid_train_phase(seed: int, rows: dict) -> None:
    """recurrentgemma-9b at full width, HYBRID_TRAIN['units'] pattern
    cycles plus the tail, bf16, remat per cycle: the memory reckoned from
    the tree first (``param_count`` counts an MLP in every RG-LRU layer
    that the tree does not hold, ROADMAP C26), then 5 AdamW steps (loss,
    step wall, tok/s, peak memory), every local layer's attention in the
    flash kernel (forward and the cycle's recompute), one step
    profiled."""
    cfg = with_layer_units(get_config(HYBRID_ARCH), HYBRID_TRAIN["units"])
    p = sum(t.numel() for t in tree_leaves(init_params(cfg, device="meta")))
    reckoned = (2 * p + 2 * p + 8 * p) / 1e9
    n_local = attention_layers(cfg)
    t0 = time.perf_counter()
    state = init_train_state(init_params(cfg, seed=seed, device="cuda"))
    torch.cuda.synchronize()
    log(f"hybrid train {cfg.name}: {cfg.num_layers} of 38 layers "
        f"({HYBRID_TRAIN['units']} of 12 (rglru, rglru, local) cycles + the "
        f"2-block RG-LRU tail) at full width (d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} x {cfg.resolved_head_dim} "
        f"heads, window {cfg.local_window}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}), {cfg.dtype}; {p / 1e9:.3f}B params in the tree "
        f"(param_count() says {cfg.param_count() / 1e9:.3f}B, C26); "
        f"reckoned before activations: params + grads (bf16) + AdamW "
        f"moments (float32) = {reckoned:.2f} GB; random weights (seed "
        f"{seed}) and AdamW state in {time.perf_counter() - t0:.1f} s")
    steps = HYBRID_TRAIN["steps"]
    opt_cfg = AdamWConfig(lr=HYBRID_TRAIN["lr"],
                          warmup_steps=max(steps // 20, 1),
                          total_steps=steps, schedule="cosine")
    step_fn = make_train_step(cfg, opt_cfg)
    batches = [lm_batch(cfg, HYBRID_TRAIN["batch"], HYBRID_TRAIN["seq"], i)
               for i in range(steps + 1)]
    tokens = HYBRID_TRAIN["batch"] * HYBRID_TRAIN["seq"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, walls = [], []
    for i in range(steps):
        state, metrics, loss, wall = timed_step(step_fn, state, batches[i])
        losses.append(loss)
        walls.append(wall)
        log(f"hybrid train step {i}: loss {loss:.4f} | grad_norm "
            f"{float(metrics['grad_norm']):.3f} | lr {metrics['lr']:.2e} | "
            f"wall {wall * 1e3:.1f} ms | {tokens / wall:.1f} tok/s")
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    want = dict.fromkeys(ops.WRAPPERS, 0)
    want["flash_attention"] = 2 * n_local * steps
    assert counts == want, (counts, want)
    variants = ops.variant_launch_counts()["flash_attention"]
    assert variants == {"simt_f32": 0, "mma_sync": want["flash_attention"],
                        "wgmma": 0}, variants
    rows["flash_attention"]["launches"] += counts["flash_attention"]
    steady = float(np.median(walls[1:]))
    log(f"hybrid train: {steps} steps of {HYBRID_TRAIN['batch']} x "
        f"{HYBRID_TRAIN['seq']} tokens, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} | step wall median of steps 1-{steps - 1} "
        f"{steady * 1e3:.1f} ms (step 0 {walls[0] * 1e3:.1f} ms) = "
        f"{tokens / steady:.1f} tok/s | max_memory_allocated {peak_gb:.3f} GB "
        f"(reckoned {reckoned:.2f} GB before activations; "
        f"max_memory_reserved {torch.cuda.max_memory_reserved() / 1e9:.3f} "
        f"GB of {torch.cuda.get_device_properties(0).total_memory / 1e9:.3f}"
        f") | flash_attention "
        f"launches per step {counts['flash_attention'] // steps} (2 x "
        f"{n_local} local layers: forward and the cycle's remat), every one "
        f"mma_sync at D {cfg.resolved_head_dim}")
    holder = {"state": state}

    def one_step():
        holder["state"], _ = step_fn(holder["state"], batches[steps])
    log(f"profile of one hybrid train step (kernel route): "
        f"{profile_step(one_step)}")


def hybrid_phase(seed: int, rows: dict) -> None:
    """The hybrid family's main path: prefill + decode at full depth,
    training at 5 layers, and the float32 kernel-vs-plain route check
    (the flash kernel at D 256 is in the kernel phase's FLASH_CASES)."""
    walls = []
    for part in (lambda: hybrid_decode_phase(seed, rows),
                 lambda: hybrid_train_phase(seed, rows),
                 lambda: dense_route_phase(seed, HYBRID_ARCH)):
        t0 = time.perf_counter()
        part()
        torch.cuda.empty_cache()
        walls.append(time.perf_counter() - t0)
    log(f"hybrid phase: {sum(walls):.1f} s (prefill + decode "
        f"{walls[0]:.1f} s, train {walls[1]:.1f} s, float32 route check "
        f"{walls[2]:.1f} s)")


# ------------------------ encoder-decoder phase ------------------------ #
def encdec_decode_phase(seed: int, rows: dict) -> None:
    """whisper-medium at full width and depth: 2 x 4096 frames and a
    448-token prompt through ``prefill`` (one wgmma flash launch,
    non-causal, for each of the 24 encoder layers; the decoder's
    attentions over 448 queries take the direct path), the self cache
    padded by 16, 16 greedy decode steps (no launch), every step's logits
    held against the teacher-forced forward over the same frames."""
    cfg = get_config(ENCDEC_ARCH)
    params = init_params(cfg, seed=seed, device="cuda")
    n_params = sum(t.numel() for t in tree_leaves(params))
    b, new = ENCDEC_DECODE["batch"], ENCDEC_DECODE["new_tokens"]
    n_prompt = ENCDEC_DECODE["prompt"]
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    frames = audio_frames(gen, cfg, b, ENCDEC_DECODE["frames"], "cuda")
    prompt = lm_batch(cfg, b, n_prompt, 1)["tokens"]
    prefill_step = make_prefill_step(cfg)
    decode_step = make_decode_step(cfg)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = prefill_step(params, {"frames": frames,
                                          "tokens": prompt})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    counts = ops.launch_counts()
    want = dict.fromkeys(ops.WRAPPERS, 0)
    want["flash_attention"] = cfg.encoder_layers
    assert counts == want, (counts, want)
    variants = ops.variant_launch_counts()["flash_attention"]
    assert variants == {"simt_f32": 0, "mma_sync": 0,
                        "wgmma": cfg.encoder_layers}, variants
    rows["flash_attention"]["launches"] += counts["flash_attention"]
    assert tuple(cache["enc_k"].shape) == (
        cfg.num_layers, b, ENCDEC_DECODE["frames"], cfg.num_kv_heads,
        cfg.resolved_head_dim), cache["enc_k"].shape
    # C10: the self cache is exactly the prompt's length; the cross cache
    # is never padded
    pad = (0, 0, 0, 0, 0, ENCDEC_DECODE["headroom"])
    cache = dict(cache, k=torch.nn.functional.pad(cache["k"], pad),
                 v=torch.nn.functional.pad(cache["v"], pad))
    steps, toks = [logits], []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(new):
        nxt = steps[-1][:, -1].argmax(-1, keepdim=True).to(torch.int32)
        toks.append(nxt)
        logits, cache = decode_step(params, cache, {"tokens": nxt})
        steps.append(logits)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t0
    assert not any(ops.launch_counts().values()), ops.launch_counts()
    assert int(cache["pos"]) == n_prompt + new
    del cache
    seq = torch.cat([prompt] + toks, dim=1)
    with torch.no_grad():
        full, _ = forward_train(params, cfg, {"frames": frames,
                                              "tokens": seq})
    got = torch.cat(steps, dim=1)
    want_logits = full[:, n_prompt - 1:n_prompt + new]
    del full
    errs = (got - want_logits).abs().amax(dim=(0, 2))
    # bf16 model: both sides round every GEMM output and the logits to
    # bf16, in GEMMs of other shapes (M = 2 per decode step vs 2 x 464):
    # the dense decode check's bound, 2 bf16 ulps of the largest logit
    tol = 2 * float(bf16_ulp(want_logits.abs().max()))
    assert torch.isfinite(got).all() and float(errs.max()) <= tol, \
        (errs.tolist(), tol)
    log(f"encdec prefill + decode ({cfg.encoder_layers} + "
        f"{cfg.num_layers} layers, {cfg.num_heads}/{cfg.num_kv_heads} x "
        f"{cfg.resolved_head_dim}, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab_size}; {n_params / 1e9:.3f}B params, param_count() "
        f"{cfg.param_count() / 1e9:.3f}B, {cfg.dtype}): prefill {b} x "
        f"{ENCDEC_DECODE['frames']} frames + {b} x {n_prompt} tokens in "
        f"{t_prefill * 1e3:.1f} ms (flash_attention launches "
        f"{counts['flash_attention']}, one per encoder layer, all wgmma, "
        f"non-causal) | self cache padded by {ENCDEC_DECODE['headroom']} | "
        f"{new} greedy decode steps in {t_decode * 1e3:.1f} ms = "
        f"{t_decode / new * 1e3:.1f} ms a step (no kernel: direct "
        f"attention over the self and the cross cache) | logits vs "
        f"teacher-forced forward max_abs_err: prefill {float(errs[0]):.3e}, "
        f"steps {float(errs[1:].max()):.3e} (tol {tol:.3e}: 2 bf16 ulps of "
        f"the largest logit)")


def encdec_train_phase(seed: int, rows: dict) -> None:
    """whisper-medium at full width and depth, bf16, remat: the memory
    reckoned first, then ENCDEC_TRAIN's AdamW steps (loss, step wall,
    decoder tok/s, peak memory), every attention in the flash kernel
    (the encoder's and the cross-attention's non-causal; forward and
    recompute), one step profiled."""
    cfg = get_config(ENCDEC_ARCH)
    p = sum(t.numel() for t in tree_leaves(init_params(cfg, device="meta")))
    b, seq = ENCDEC_TRAIN["batch"], ENCDEC_TRAIN["seq"]
    # params + grads (bf16) + AdamW moments (float32), then the float32
    # logits and their gradient
    state_gb = 12 * p / 1e9
    logits_gb = 2 * b * seq * cfg.vocab_size * 4 / 1e9
    t0 = time.perf_counter()
    state = init_train_state(init_params(cfg, seed=seed, device="cuda"))
    torch.cuda.synchronize()
    log(f"encdec train {cfg.name}: {cfg.encoder_layers} + "
        f"{cfg.num_layers} layers at full width, {cfg.dtype}; "
        f"{p / 1e9:.3f}B params; reckoned: params + grads (bf16) + AdamW "
        f"moments (float32) {state_gb:.2f} GB + float32 logits and their "
        f"gradient {logits_gb:.2f} GB = {state_gb + logits_gb:.2f} GB "
        f"before the other activations and the plain backward's tiles; "
        f"random weights (seed {seed}) and AdamW state in "
        f"{time.perf_counter() - t0:.1f} s")
    steps = ENCDEC_TRAIN["steps"]
    opt_cfg = AdamWConfig(lr=ENCDEC_TRAIN["lr"],
                          warmup_steps=max(steps // 20, 1),
                          total_steps=steps, schedule="cosine")
    step_fn = make_train_step(cfg, opt_cfg)
    batches = [lm_batch(cfg, b, seq, i, seed) for i in range(steps + 1)]
    tokens = b * seq
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, walls = [], []
    for i in range(steps):
        state, metrics, loss, wall = timed_step(step_fn, state, batches[i])
        losses.append(loss)
        walls.append(wall)
        log(f"encdec train step {i}: loss {loss:.4f} | grad_norm "
            f"{float(metrics['grad_norm']):.3f} | lr {metrics['lr']:.2e} | "
            f"wall {wall * 1e3:.1f} ms | {tokens / wall:.1f} decoder tok/s")
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    per_step = 2 * attention_layers(cfg)
    want = dict.fromkeys(ops.WRAPPERS, 0)
    want["flash_attention"] = per_step * steps
    assert counts == want, (counts, want)
    variants = ops.variant_launch_counts()["flash_attention"]
    assert variants == {"simt_f32": 0, "mma_sync": 0,
                        "wgmma": want["flash_attention"]}, variants
    rows["flash_attention"]["launches"] += counts["flash_attention"]
    steady = float(np.median(walls[1:]))
    log(f"encdec train: {steps} steps of {b} x {seq} tokens over {b} x "
        f"{seq} frames, loss {losses[0]:.4f} -> {losses[-1]:.4f} | step "
        f"wall median of steps 1-{steps - 1} {steady * 1e3:.1f} ms (step 0 "
        f"{walls[0] * 1e3:.1f} ms) = {tokens / steady:.1f} decoder tok/s | "
        f"max_memory_allocated {peak_gb:.3f} GB (reckoned "
        f"{state_gb + logits_gb:.2f} GB before the other activations; "
        f"max_memory_reserved {torch.cuda.max_memory_reserved() / 1e9:.3f} "
        f"GB) | flash_attention launches per step "
        f"{counts['flash_attention'] // steps} = 2 x ({cfg.encoder_layers} "
        f"encoder + {cfg.num_layers} decoder self + {cfg.num_layers} cross): "
        f"forward and remat recompute, all wgmma, "
        f"{2 * (cfg.encoder_layers + cfg.num_layers)} of them non-causal")
    holder = {"state": state}

    def one_step():
        holder["state"], _ = step_fn(holder["state"], batches[steps])
    log(f"profile of one encdec train step (kernel route): "
        f"{profile_step(one_step)}")


def encdec_phase(seed: int, rows: dict) -> None:
    """The encoder-decoder family's main path: prefill + decode and
    training at full width and depth, and the float32 kernel-vs-plain
    route check (the flash kernel at its layer is in the kernel phase's
    FLASH_CASES)."""
    walls = []
    for part in (lambda: encdec_decode_phase(seed, rows),
                 lambda: encdec_train_phase(seed, rows),
                 lambda: dense_route_phase(seed, ENCDEC_ARCH)):
        t0 = time.perf_counter()
        part()
        torch.cuda.empty_cache()
        walls.append(time.perf_counter() - t0)
    log(f"encdec phase: {sum(walls):.1f} s (prefill + decode "
        f"{walls[0]:.1f} s, train {walls[1]:.1f} s, float32 route check "
        f"{walls[2]:.1f} s)")


def vision_phase(seed: int, rows: dict) -> None:
    """The vision config's main path: llava-next-34b served with its soft
    tokens, then the float32 kernel-vs-plain route check with 576 soft
    tokens in front of 3520 tokens."""
    walls = []
    for part in (lambda: serve_phase(seed, rows["paged_attention"],
                                     VISION_ARCH),
                 lambda: dense_route_phase(seed, VISION_ARCH)):
        t0 = time.perf_counter()
        part()
        torch.cuda.empty_cache()
        walls.append(time.perf_counter() - t0)
    log(f"vision phase: {sum(walls):.1f} s (serve {walls[0]:.1f} s, float32 "
        f"route check {walls[1]:.1f} s)")


# ------------------------ checkpoint phase ---------------------------- #
def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits as integers (bitwise comparison: -0.0 and NaN
    included)."""
    ints = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    return t.view(ints[t.element_size()])


def states_bitwise_equal(a, b) -> bool:
    """Two trees (or their lists of leaves) hold the same bits."""
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(_bits(x), _bits(y)) if torch.is_tensor(x) else x == y
        for x, y in zip(la, lb))


def ckpt_phase(seed: int, rows: dict) -> None:
    """Checkpoints through ``launch.train.run`` at minicpm-2b's full width
    (CKPT): (1) an uninterrupted run with a checkpoint every 2 steps
    commits steps 2, 4 and 5, ``keep`` leaves 4 and 5; (2) a run that a
    real SIGTERM reaches during its third step commits step 3 alone and
    returns (ROADMAP.md C29), and its resume runs steps 3-4 with the
    uninterrupted run's losses; (3) the resume's restored step 3 equals
    the state the preempted run saved, bitwise; (4) the loop's asynchronous save of step 4, followed at
    once by the next step in place, holds the state from before that
    step.  Five saves of ~8.1 GB, ~41 GB written in all.  The weights
    are ``launch.train``'s, from seed 0."""
    cfg = with_layer_units(get_config(CKPT_ARCH), CKPT["layers"])
    n_params = cfg.param_count()
    step_gb = n_params * (2 + 4 + 4) / 1e9
    tmp = tempfile.gettempdir()
    free_gb = shutil.disk_usage(tmp).free / 1e9
    log(f"ckpt {cfg.name}: {cfg.num_layers} of 40 layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab_size}, {cfg.dtype}; "
        f"{n_params / 1e9:.3f}B params by param_count: {step_gb:.2f} GB a "
        f"step directory reckoned (bf16 weights, float32 moments), keep 2 "
        f"| {free_gb:.1f} GB free at {tmp}")
    # two committed steps and the one being written
    assert free_gb > 3 * step_gb, (free_gb, 3 * step_gb)
    steps, preempt, every = CKPT["steps"], CKPT["preempt"], CKPT["every"]
    managers, captured = [], {}
    plain_make = train_launch.make_train_step

    class Recorded(CheckpointManager):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            managers.append(self)

    def recording(sigterm_at=None, clone_at=None, first=None):
        """The train step, which sends this process a SIGTERM as its
        ``sigterm_at``-th call starts, keeps the state each call returns
        and a copy of the one its ``clone_at``-th call returns; with
        ``first``, it holds the state its first call is given (a resumed
        run's restored state) to those leaves, bitwise."""
        def make(*args, **kwargs):
            step_fn, calls = plain_make(*args, **kwargs), [0]

            def step(state, batch):
                calls[0] += 1
                if calls[0] == 1 and first is not None:
                    captured["restored_equal"] = states_bitwise_equal(
                        state, first)
                if calls[0] == sigterm_at:
                    os.kill(os.getpid(), signal.SIGTERM)
                state, metrics = step_fn(state, batch)
                captured["state"] = state
                if calls[0] == clone_at:
                    captured["copy"] = [t.clone() if torch.is_tensor(t)
                                        else t for t in tree_leaves(state)]
                return state, metrics
            return step
        return make

    def train(d, make, ckpt_every):
        train_launch.make_train_step = make
        train_launch.CheckpointManager = Recorded
        try:
            t0 = time.perf_counter()
            losses = train_launch.run(
                cfg, steps, CKPT["batch"], CKPT["seq"], ckpt_dir=d,
                ckpt_every=ckpt_every, lr=CKPT["lr"], log_every=1,
                device="cuda")
            torch.cuda.synchronize()
            return losses, managers[-1], time.perf_counter() - t0
        finally:
            train_launch.make_train_step = plain_make
            train_launch.CheckpointManager = CheckpointManager

    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        whole_dir = os.path.join(root, "whole")
        whole, mgr_w, wall_w = train(whole_dir, recording(clone_at=4), every)
        saved_w = [h["step"] for h in mgr_w.history if h["op"] == "save"]
        assert saved_w == [2, 4, 5], saved_w
        assert mgr_w.committed_steps() == [4, 5], mgr_w.committed_steps()
        log(f"ckpt (1): {steps} steps in {wall_w:.2f} s, losses "
            + " ".join(f"{x:.6f}" for x in whole) + f" | saved {saved_w}, "
            f"committed after keep 2: {mgr_w.committed_steps()}")
        final, at_4 = captured.pop("state"), captured.pop("copy")
        _, written, _ = CheckpointManager(whole_dir).restore(final, step=4)
        assert states_bitwise_equal(written, at_4), \
            "the asynchronous save of step 4 wrote state from a later step"
        assert not states_bitwise_equal(final, at_4), \
            "the step after the save left the state as it was"
        log("ckpt (4): the loop's asynchronous save of step 4, followed at "
            "once by the next step in place, holds the state from before "
            "that step, bitwise")
        del final, at_4, written
        shutil.rmtree(whole_dir)

        cut_dir = os.path.join(root, "cut")
        cut, mgr_c, wall_c = train(cut_dir, recording(sigterm_at=preempt),
                                   steps + 1)
        committed_c = mgr_c.committed_steps()
        assert len(cut) == preempt, cut
        assert committed_c == [preempt], committed_c   # not steps: C29
        saved = captured.pop("state")
        rest, mgr_r, wall_r = train(cut_dir, recording(first=saved),
                                    steps + 1)
        assert captured.pop("restored_equal"), \
            "the restored state differs from the saved one"
        log(f"ckpt (3): the resume's restored step {preempt} is bitwise the "
            f"state the preempted run saved ({len(tree_leaves(saved))} "
            f"leaves)")
        del saved
        assert len(rest) == steps - preempt, rest
        resumed = cut + rest
        rel = max(abs(a - b) / abs(b) for a, b in zip(resumed, whole))
        bitwise = resumed == whole
        log(f"ckpt (2): SIGTERM during step {preempt}: {len(cut)} steps in "
            f"{wall_c:.2f} s, committed {committed_c} (not step {steps}: "
            f"C29); the resume ran steps {preempt}-{steps - 1} in "
            f"{wall_r:.2f} s and committed {mgr_r.committed_steps()}: "
            f"losses " + " ".join(f"{x:.6f}" for x in resumed)
            + f" | {'bitwise equal to' if bitwise else 'differ from'} the "
            f"uninterrupted run's (max relative {rel:.3e}): the step is "
            f"{'' if bitwise else 'not '}deterministic on the card")
        assert rel <= 1e-6, (resumed, whole)
        counts = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
    finally:
        shutil.rmtree(root, ignore_errors=True)
    n_steps = steps + preempt + (steps - preempt)
    want = dict.fromkeys(ops.WRAPPERS, 0)
    want["flash_attention"] = 2 * cfg.num_layers * n_steps
    assert counts == want, (counts, want)
    rows["flash_attention"]["launches"] += counts["flash_attention"]
    for mgr, what in ((mgr_w, "uninterrupted"), (mgr_c, "preempted"),
                      (mgr_r, "resumed")):
        for h in mgr.history:
            gb = h["bytes"] / 1e9
            if h["op"] == "restore":
                log(f"ckpt {what}: restore step {h['step']}: {gb:.3f} GB "
                    f"in {h['read_s']:.3f} s = {gb / h['read_s']:.2f} GB/s "
                    f"(file to the card)")
            else:
                log(f"ckpt {what}: save step {h['step']}: {gb:.3f} GB, the "
                    f"loop blocked {h['blocked_s']:.3f} s (the copy to the "
                    f"host, then the end of the write in flight), written "
                    f"in {h['write_s']:.3f} s = {gb / h['write_s']:.2f} "
                    f"GB/s")
    log(f"ckpt: flash_attention launches {counts['flash_attention']} = "
        f"{n_steps} steps x 2 x {cfg.num_layers} layers | "
        f"max_memory_allocated {peak_gb:.3f} GB | directory removed, "
        f"{shutil.disk_usage(tmp).free / 1e9:.1f} GB free at {tmp}")


# ---------------------------- fleet phase ----------------------------- #
def fleet_phase(seed: int, rows: dict, serve_out: dict) -> None:
    """The serving fleet (FLEET, FLEET_POLICIES).  (a) minicpm-2b at full
    width and depth: 2 replicas sharing one set of weights behind
    ``prefix_affinity``, the serve phase's requests on bursty arrivals;
    every stream bitwise the first tokens of the serve phase's, peak
    memory one set of weights and two page pools.  (b) at 4 layers:
    every policy on 3 replicas gives one replica's streams; a capped
    bursty trace sheds only at the cap, with retry-after hints."""
    cfg = get_config(SERVE_ARCH)
    n_new = FLEET["new_tokens"]
    # the serve phase's page-table width: the paged kernel's split plan
    # reads it, so each row is computed as the serve phase computed it
    max_len = (SERVE["system_len"] + SERVE["suffix"][1] + SERVE["new_tokens"]
               + SERVE["block_size"])
    kw = dict(block_size=SERVE["block_size"],
              prefill_chunk=SERVE["prefill_chunk"], device="cuda")
    tenant = lambda r: f"tenant-{r.rid % SERVE['system_prompts']}"
    params = init_params(cfg, seed=seed, device="cuda")
    weights_gb = sum(t.numel() * t.element_size()
                     for t in tree_leaves(params)) / 1e9
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    fleet = FleetServer(cfg, params, FLEET["replicas"], SERVE["batch"],
                        max_len, router=FLEET["router"], seed=seed, **kw)
    servers = [rep.server for rep in fleet.replicas]
    ptrs = [t.data_ptr() for t in tree_leaves(params)]
    assert all(srv.params is params and [t.data_ptr() for t in tree_leaves(
        srv.params)] == ptrs for srv in servers), "a replica copied weights"
    pools_gb = sum(p.numel() * p.element_size() for srv in servers
                   for p in srv.pages.values()) / 1e9
    reckoned = weights_gb + pools_gb + 1.0
    reqs = make_requests(cfg, seed, n_new)
    waves = arrival_waves(len(reqs), "bursty", rng=np.random.default_rng(1),
                          rate=FLEET["rate"])
    t0 = time.perf_counter()
    results, rejections = fleet.run_trace(
        [(w, tenant(r), r) for w, r in zip(waves, reqs)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    snap = fleet.snapshot()
    decode_a = sum(r.decode_steps for r in snap.replicas)
    want_streams = {rid: toks[:n_new]
                    for rid, toks in serve_out["streams"].items()}
    # each differing request's first differing position
    differ = {rid: next((i for i, (a, b) in enumerate(zip(
        results.get(rid, []), want)) if a != b), len(results.get(rid, [])))
        for rid, want in want_streams.items() if results.get(rid) != want}
    tokens = sum(len(v) for v in results.values())
    log(f"fleet (a) {cfg.name}, {cfg.num_layers} layers: {FLEET['replicas']}"
        f" replicas x batch {SERVE['batch']} behind {FLEET['router']}, "
        f"bursty arrivals over waves {waves[0]}-{waves[-1]}: "
        f"{len(results)} requests, {tokens} tokens in {wall:.3f} s = "
        f"{tokens / wall:.1f} tok/s (one server, serve phase: "
        f"{serve_out['tok_s']:.1f}) | waves {snap.waves} | routed "
        f"{list(snap.routed)} | rejected {snap.rejected}")
    log(f"fleet (a): cached prefix tokens {snap.cached_prefix_tokens} of "
        f"{snap.cached_prefix_tokens + snap.prefill_tokens_computed} "
        f"({snap.cached_token_fraction:.3f}; one server "
        f"{serve_out['cached_fraction']:.3f}) | "
        + " | ".join(f"replica {i}: ttft p50 {r.ttft_p50_ms:.1f} p99 "
                     f"{r.ttft_p99_ms:.1f} ms, {r.decode_steps} decode steps"
                     for i, r in enumerate(snap.replicas)))
    log(f"fleet (a): streams bitwise the serve phase's first {n_new} tokens: "
        f"{len(want_streams) - len(differ)} of {len(want_streams)}"
        + (f"; first differing position by request {differ}"
           if differ else ""))
    log(f"fleet (a): one weight set ({weights_gb:.3f} GB, every replica's "
        f"leaves at the same data_ptr) + {FLEET['replicas']} page pools "
        f"({pools_gb:.3f} GB) | max_memory_allocated {peak_gb:.3f} GB "
        f"(reckoned {reckoned:.3f}: the weights, the pools, 1 GB of "
        f"activations)")
    assert rejections == [] and sorted(results) == sorted(want_streams)
    assert not differ, differ
    assert weights_gb + pools_gb <= peak_gb <= reckoned, (peak_gb, reckoned)
    del fleet, servers, params
    torch.cuda.empty_cache()

    cfg4 = with_layer_units(cfg, FLEET_POLICIES["layers"])
    params4 = init_params(cfg4, seed=seed, device="cuda")
    n4 = FLEET_POLICIES["new_tokens"]

    def serve(n, policy, arrive, admission=None):
        fl = FleetServer(cfg4, params4, n, FLEET_POLICIES["batch"], max_len,
                         router=policy, admission=admission, seed=seed, **kw)
        t = time.perf_counter()
        out, rej = fl.run_trace([(arrive(i), tenant(r), r) for i, r in
                                 enumerate(make_requests(cfg4, seed, n4))])
        torch.cuda.synchronize()
        return fl.snapshot(), out, rej, time.perf_counter() - t

    snaps = []
    one, want4, _, wall1 = serve(1, "round_robin", lambda i: 0)
    snaps.append(one)
    cached = {}
    for policy in ROUTER_POLICIES:
        snap4, got, _, wall4 = serve(FLEET_POLICIES["replicas"], policy,
                                     lambda i: 0)
        snaps.append(snap4)
        cached[policy] = snap4.cached_token_fraction
        same = got == want4
        log(f"fleet (b) {cfg4.num_layers} layers, {policy}: "
            f"{FLEET_POLICIES['replicas']} replicas x "
            f"{FLEET_POLICIES['batch']} slots in {wall4:.3f} s (one "
            f"replica {wall1:.3f} s), routed {list(snap4.routed)}, waves "
            f"{snap4.waves}, cached fraction {cached[policy]:.3f} | streams "
            f"{'bitwise' if same else 'NOT'} equal to one replica's")
        assert same, policy
    assert cached["prefix_affinity"] >= cached["round_robin"], cached
    waves4 = arrival_waves(SERVE["requests"], "bursty",
                           rng=np.random.default_rng(1), rate=FLEET["rate"])
    admission = AdmissionConfig(queue_cap=FLEET_POLICIES["queue_cap"],
                                tenant_rate=FLEET_POLICIES["tenant_rate"])
    capped, got, rej, wall_c = serve(
        FLEET_POLICIES["replicas"], "prefix_affinity", waves4.__getitem__,
        admission=admission)
    snaps.append(capped)
    admitted = set(want4) - {r.rid for r in rej}
    log(f"fleet (b) capped bursty trace: {FLEET_POLICIES['replicas']} "
        f"replicas x {FLEET_POLICIES['batch']} slots, queue cap "
        f"{admission.queue_cap}, tenant rate {admission.tenant_rate:g} "
        f"(burst {admission.burst():g}): admitted {capped.admitted}, "
        f"rejected {capped.rejected} {dict(capped.rejected_by_reason)}, "
        f"below the cap {capped.rejected_below_cap}, retry-after "
        f"{sorted({r.retry_after_waves for r in rej})} waves, in "
        f"{wall_c:.3f} s")
    assert rej and capped.rejected_below_cap == 0, capped
    assert all(r.retry_after_waves >= 1 for r in rej), rej
    assert set(got) == admitted and all(
        got[rid] == want4[rid] for rid in admitted)
    counts = ops.launch_counts()
    decode_b = sum(r.decode_steps for s in snaps for r in s.replicas)
    want = dict.fromkeys(ops.WRAPPERS, 0)
    want["paged_attention"] = (cfg.num_layers * decode_a
                               + cfg4.num_layers * decode_b)
    assert counts == want, (counts, want)
    rows["paged_attention"]["launches"] += counts["paged_attention"]
    log(f"fleet: paged_attention launches {counts['paged_attention']} = "
        f"{cfg.num_layers} x {decode_a} decode steps (a) + "
        f"{cfg4.num_layers} x {decode_b} (b)")


# ---------------------- multi_add and matmul_tiled --------------------- #
def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / (want.float().abs().max() + 1e-30))


def collective_kernel_phase(seed: int) -> list:
    """Rows 2-3 of the kernel table: ``multi_add`` and ``matmul_tiled``
    against their plain versions on the card, then timed at their first
    shape beside the bound, the plain version and one PyTorch call."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 400)
    ma_err, ma_main = 0.0, None
    for label, k, n, dtype in MULTI_ADD_CASES:
        x = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
        got = ops.multi_add(x)
        torch.cuda.synchronize()
        want = multi_add_ref(x)
        # the kernel adds rows 0..K-1 in order in float32, as the plain
        # version does, and rounds once: bitwise equal
        assert torch.equal(got, want), (label, _rel_err(got, want))
        ma_err = max(ma_err, float((got.float() - want.float()).abs().max()))
        ms = time_ms(lambda: ops.multi_add(x))
        bound_ms = (k + 1) * n * x.element_size() / HBM_BYTES_PER_S * 1e3
        log(f"kernel multi_add {label}: K={k} N={n} "
            f"{str(dtype).split('.')[-1]} | bitwise equal to the plain "
            f"version | kernel {ms:.4f} ms | bound {bound_ms:.4f} ms "
            f"(bytes) | {bound_ms / ms:.1%} of bound")
        if ma_main is None:
            ma_main = (x, ms, bound_ms)
    x, ms, bound_ms = ma_main
    ma_row = {"name": "multi_add", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/multi_add.cu",
              "replaces": "src/repro/kernels/multi_add.py:44",
              "launches": None, "max_abs_err": ma_err, "ms": ms,
              "plain_ms": time_ms(lambda: multi_add_ref(x)),
              "bound_ms": bound_ms, "bound_by": "bytes",
              "library_ms": time_ms(lambda: torch.sum(
                  x, 0, dtype=torch.float32).to(x.dtype))}
    log(f"kernel multi_add timing ({MULTI_ADD_CASES[0][0]}): kernel {ms:.4f} "
        f"ms | plain {ma_row['plain_ms']:.4f} ms (K-1 elementwise adds) | "
        f"library {ma_row['library_ms']:.4f} ms (torch.sum over K in "
        f"float32, cast back) | bound {bound_ms:.4f} ms")
    del x, ma_main

    mm_err, mm_main = 0.0, None
    for label, m, k, n, dtype in MATMUL_CASES:
        x = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        w = (torch.randn((k, n), generator=gen, device="cuda")
             / math.sqrt(k)).to(dtype)
        variant = matmul_variant(dtype, k, n, x.data_ptr(), w.data_ptr())
        ops.reset_launch_counts()
        got = ops.matmul_tiled(x, w)
        torch.cuda.synchronize()
        assert ops.variant_launch_counts()["matmul_tiled"][variant] == 1, \
            (label, variant)
        want = matmul_tiled_ref(x, w)
        err = _rel_err(got, want)
        assert err <= MM_TOL[dtype], (label, err)
        mm_err = max(mm_err, float((got.float() - want.float()).abs().max()))
        ms = time_ms(lambda: ops.matmul_tiled(x, w), reps=20)
        t_ops = 2 * m * n * k / PEAK_OPS_PER_S[dtype]
        t_bytes = (m * k + k * n + m * n) * x.element_size() / \
            HBM_BYTES_PER_S
        bound_ms = max(t_ops, t_bytes) * 1e3
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        log(f"kernel matmul_tiled {label}: [{m}, {k}] @ [{k}, {n}] "
            f"{str(dtype).split('.')[-1]}, variant {variant} | err / "
            f"max|plain| {err:.3e} (tol "
            f"{MM_TOL[dtype]:.0e}) | kernel {ms:.4f} ms | bound "
            f"{bound_ms:.4f} ms ({bound_by}) | {bound_ms / ms:.1%} of bound "
            f"| {2 * m * n * k / ms / 1e9:.1f} TFLOP/s")
        log(f"kernel matmul_tiled {label}: library "
            f"{time_ms(lambda: torch.matmul(x, w), reps=20):.4f} ms "
            f"(torch.matmul, cuBLAS"
            + (", float32 with TF32 off)" if dtype == torch.float32
               else ")"))
        if mm_main is None:
            mm_main = (x, w, ms, bound_ms, bound_by)
    x, w, ms, bound_ms, bound_by = mm_main
    # the earlier kernel (WMMA, cp.async) at the same shape
    ms_wmma = time_ms(lambda: matmul_tiled_cuda(x, w, variant="wmma_masked"),
                      reps=20)
    mm_row = {"name": "matmul_tiled", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/matmul_tiled.cu",
              "replaces": "src/repro/kernels/fused_matmul_rs.py:72",
              "variant": "wgmma", "launches": 0, "max_abs_err": mm_err,
              "ms": ms,
              "plain_ms": time_ms(lambda: matmul_tiled_ref(x, w), reps=20),
              "bound_ms": bound_ms, "bound_by": bound_by,
              "library_ms": time_ms(lambda: torch.matmul(x, w), reps=20)}
    log(f"kernel matmul_tiled timing ({MATMUL_CASES[0][0]}): kernel {ms:.4f} "
        f"ms (wgmma variant, 128 x 256 tiles) | the wmma_masked variant (the "
        f"earlier kernel) "
        f"{ms_wmma:.4f} ms | plain {mm_row['plain_ms']:.4f} ms (float32 "
        f"product, cast) | library {mm_row['library_ms']:.4f} ms (torch.matmul in bf16, "
        f"cuBLAS) | bound {bound_ms:.4f} ms ({bound_by})")
    return [ma_row, mm_row]


# -------------------------- collective phase ---------------------------- #
def collective_inputs(p: int, nbytes: int, dtype, seed: int):
    """Each rank's 1-D input of ``nbytes``: integer-valued float32 in
    [-8, 8] (every order of adds is exact), or normal bfloat16."""
    n = nbytes // torch.tensor([], dtype=dtype).element_size()
    n -= n % p                  # reduce_scatter and all_to_all split by P
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    if dtype == torch.float32:
        return [torch.randint(-8, 9, (n,), generator=gen, device="cuda",
                              dtype=torch.int32).float() for _ in range(p)]
    return [torch.randn((n,), generator=gen, device="cuda").to(dtype)
            for _ in range(p)]


def collective_expected(op: str, xs, rank: int, root: int = BROADCAST_ROOT):
    """What ``rank`` must hold after ``op`` (None: nothing to check, a
    reduce's non-root ranks keep partials)."""
    p = len(xs)
    if op in ("reduce", "allreduce", "reduce_scatter"):
        if op == "reduce" and rank:
            return None
        total = torch.stack([x.float() for x in xs]).sum(0)
        return total.chunk(p)[rank] if op == "reduce_scatter" else total
    if op == "allgather":
        return torch.cat(xs)
    if op == "broadcast":
        return xs[root]
    return torch.cat([x.chunk(p)[rank] for x in xs])


def check_collective(op: str, got, want) -> float:
    """Bitwise equality for float32 (and for every op that only moves
    bf16 values); for a bf16 sum, its error relative to the exact sum's
    max-abs, which must stay within 5e-2 (one hop's bf16 rounding per add,
    ROADMAP C4)."""
    if got.dtype == torch.float32 or op in ("allgather", "broadcast",
                                            "all_to_all"):
        assert torch.equal(got.float(), want.float()), op
        return 0.0
    err = _rel_err(got, want)
    assert err <= 5e-2, (op, err)
    return err


def run_collective(eng, op: str, alg: str, xs, comm):
    fn = getattr(eng, op + "_inside")
    if op == "broadcast":
        return fn(xs[comm.rank], comm, BROADCAST_ROOT, alg)
    return fn(xs[comm.rank], comm, alg)


def collective_phase(seed: int) -> None:
    eng = get_engine()
    p = COLLECTIVE_RANKS
    t0 = time.perf_counter()
    runs, bf16_err = 0, 0.0
    for nbytes in COLLECTIVE_BYTES:
        for dtype in (torch.float32, torch.bfloat16):
            xs = collective_inputs(p, nbytes, dtype, seed + nbytes)
            for op, algs in ALGORITHMS.items():
                wants = [collective_expected(op, xs, r) for r in range(p)]
                for alg in algs:
                    outs = run_local(
                        lambda c: run_collective(eng, op, alg, xs, c), p)
                    torch.cuda.synchronize()
                    for r in range(p):
                        if wants[r] is not None:
                            bf16_err = max(bf16_err, check_collective(
                                op, outs[r], wants[r]))
                    runs += 1
                    del outs
                del wants
            del xs
            torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    log(f"collectives: {runs} runs (6 ops x every algorithm + auto x "
        f"{len(COLLECTIVE_BYTES)} sizes x float32/bf16) on {p} LocalComm "
        f"ranks: float32 bitwise equal to the sum over ranks on every "
        f"checked rank; bf16 sums within {bf16_err:.3e} of the exact sum's "
        f"max-abs (tol 5e-2); {wall:.1f} s of host wall (threads, barriers "
        f"and device copies on one card, not a fabric time)")
    for op in ALGORITHMS:
        for nbytes in COLLECTIVE_BYTES:
            model_bytes = nbytes * p if op == "allgather" else nbytes
            d = eng.select(op, model_bytes, p)
            log(f"auto {op} {nbytes >> 10} KB/rank, P={p}: {d.algorithm}, "
                f"predicted {d.predicted:.1f} model cycles (priced on the "
                f"reference's TPU v5e ICI fabric model, TPU_V5E_AXIS; not an "
                f"H100 number)")
    log(f"engine stats: {eng.stats_snapshot()} (ranks share the engine: "
        f"one miss and {p - 1} hits per auto call)")
    xs = collective_inputs(p, 4 << 20, torch.float32, seed)
    prof = profile_step(lambda: run_local(
        lambda c: eng.allreduce_inside(xs[c.rank], c), p))
    log(f"profile of one auto allreduce of 4 MB/rank on {p} local ranks: "
        f"{prof}")


# ------------------------ 2D collective phase --------------------------- #
def shapes_2d(op: str, n_axes: int) -> list:
    """``auto`` and every plan shape the planner offers for ``op`` over
    ``n_axes`` effective axes (the 2D ones on two axes only, ``latency``
    not for reduce_scatter)."""
    if op == "allreduce":
        shapes = [s for s in planner.ALLREDUCE_SHAPES
                  if n_axes == 2 or not s.startswith("2d_")]
    elif op == "all_to_all":
        shapes = list(planner.ALL_TO_ALL_SHAPES)
    else:
        shapes = [s for s in planner.SHARDED_SHAPES
                  if op == "allgather" or s != "latency"]
    return ["auto"] + shapes


def inputs_2d(op: str, nbytes: int, dtype, seed: int):
    """Each of the 8 ranks' 1-D input of about ``nbytes``: an odd length
    where the op allows it (reduce_scatter and all_to_all split by the
    group); integer-valued float32 in [-8, 8] (every order of adds is
    exact) or normal bfloat16."""
    n = nbytes // torch.tensor([], dtype=dtype).element_size()
    if op in ("reduce_scatter", "all_to_all"):
        n -= n % COLLECTIVE_RANKS
    else:
        n -= 1 - n % 2
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    if dtype == torch.float32:
        return [torch.randint(-8, 9, (n,), generator=gen, device="cuda",
                              dtype=torch.int32).float()
                for _ in range(COLLECTIVE_RANKS)]
    return [torch.randn((n,), generator=gen, device="cuda").to(dtype)
            for _ in range(COLLECTIVE_RANKS)]


def expected_2d(op: str, group, me: int):
    """What sub-rank ``me`` of a group holding ``group`` must hold, in
    float32, and the float32 sum of the inputs' magnitudes (for the bf16
    bound; None for the ops that only move values)."""
    p = len(group)
    if op in ("allreduce", "reduce_scatter"):
        total = torch.stack([x.float() for x in group]).sum(0)
        mag = torch.stack([x.float().abs() for x in group]).sum(0)
        if op == "reduce_scatter":
            return total.chunk(p)[me], mag.chunk(p)[me]
        return total, mag
    if op == "allgather":
        return torch.cat(group).float(), None
    return torch.cat([x.chunk(p)[me] for x in group]).float(), None


def check_2d(op: str, out, xs, members, rank: int, cpu_out) -> float:
    """float32: bitwise equal to the exact result.  bf16: bitwise equal to
    the CPU ranks' result where there is one; else the moved values
    bitwise, and each element of a sum within one bf16 ulp (of the sum
    of the inputs' magnitudes, which bounds every partial) per add of
    the group, P - 1 adds.  Returns that ratio (0 where bitwise)."""
    group = [xs[m] for m in members]
    want, mag = expected_2d(op, group, members.index(rank))
    if out.dtype == torch.float32 or mag is None:
        assert torch.equal(out.float(), want), (op, rank)
        return 0.0
    if cpu_out is not None:
        assert torch.equal(out.cpu(), cpu_out), (op, rank)
        return 0.0
    bound = (len(group) - 1) * bf16_ulp(mag)
    ratio = float(((out.float() - want).abs() / bound).max())
    assert ratio <= 1.0, (op, rank, ratio)
    return ratio


def collective_2d_phase(seed: int) -> None:
    """The paper's 2D and multi-axis collectives on 8 LocalComm ranks of
    the card arranged as the reference's grids: every plan shape and
    ``auto`` of the four multi-axis ops, at three sizes, float32 exact
    and bf16 held to the same plan on CPU ranks (and to one bf16 ulp per
    add at the largest size)."""
    eng = get_engine()
    cpu_eng = CollectiveEngine(persist=False, device="cpu")
    t0 = time.perf_counter()
    runs, worst = 0, 0.0
    autos = []
    for shape, names, subsets in GRIDS_2D:
        for axes in subsets:
            grid_label = (f"{' x '.join(map(str, shape))} grid over "
                          f"({', '.join(axes)})")
            for op in ("allreduce", "reduce_scatter", "allgather",
                       "all_to_all"):
                fn = getattr(eng, op + "_multi")
                cpu_fn = getattr(cpu_eng, op + "_multi")
                for nbytes in COLLECTIVE_2D_BYTES:
                    for dtype in (torch.float32, torch.bfloat16):
                        xs = inputs_2d(op, nbytes, dtype, seed + nbytes)
                        on_cpu = (dtype == torch.bfloat16
                                  and nbytes <= BF16_CPU_BYTES)
                        xs_cpu = [x.cpu() for x in xs] if on_cpu else None
                        for alg in shapes_2d(op, len(axes)):
                            t1 = time.perf_counter()
                            outs = run_local_grid(
                                lambda g: (fn(xs[g.rank], g, axes, alg),
                                           g.members(axes)), shape, names)
                            torch.cuda.synchronize()
                            wall = time.perf_counter() - t1
                            cpu_outs = (run_local_grid(
                                lambda g: cpu_fn(xs_cpu[g.rank], g, axes,
                                                 alg), shape, names, "cpu")
                                if on_cpu else [None] * len(outs))
                            for r, (out, members) in enumerate(outs):
                                worst = max(worst, check_2d(
                                    op, out, xs, members, r, cpu_outs[r]))
                            runs += 1
                            if alg == "auto" and dtype == torch.float32:
                                autos.append((grid_label, op, nbytes,
                                              wall, len(xs[0]), axes,
                                              [shape[names.index(a)]
                                               for a in axes]))
                            del outs, cpu_outs
                        del xs, xs_cpu
                torch.cuda.empty_cache()
    wall = time.perf_counter() - t0
    stats = eng.stats_snapshot()
    for grid_label, op, nbytes, t_auto, n, axes, sizes in autos:
        model_bytes = n * 4 * (math.prod(sizes) if op == "allgather" else 1)
        plan = eng.plan_multi(op, axes, sizes, model_bytes)
        log(f"2D auto {op} {nbytes >> 10} KB/rank on the {grid_label}: "
            f"{plan.describe()}, n_chunks {plan.n_chunks}, predicted "
            f"{plan.predicted:.1f} model cycles (TPU v5e ICI model, not an "
            f"H100 number); host wall {t_auto * 1e3:.1f} ms (threads on one "
            f"card, not a fabric time)")
    log(f"2D collectives: {runs} runs (allreduce_multi, reduce_scatter_multi,"
        f" allgather_multi, all_to_all_multi x every plan shape + auto x "
        f"{len(COLLECTIVE_2D_BYTES)} sizes x float32/bf16) on "
        f"{COLLECTIVE_RANKS} LocalComm ranks as a 2 x 4 and a 2 x 2 x 2 grid:"
        f" float32 bitwise equal to the exact result on every rank; bf16 "
        f"bitwise equal to CPU ranks at <= {BF16_CPU_BYTES >> 10} KB, at "
        f"{COLLECTIVE_2D_BYTES[-1] >> 10} KB within {worst:.3f} of one bf16 "
        f"ulp per add (bound 1); engine plan_hits {stats['plan_hits']}, "
        f"plan_misses {stats['plan_misses']} (the ranks share the engine: "
        f"a new plan is one miss, every later lookup on any rank a hit); "
        f"{wall:.1f} s of host wall (threads on one card, not a fabric "
        f"time)")


# -------------------------- fused ring phase ---------------------------- #
def fused_inputs(cfg, seed: int):
    """Each TP rank's activations [tokens, d_ff / TP] (normal) and weight
    shard [d_ff / TP, d_model] (normal / sqrt(d_ff)), bf16."""
    tp = FUSED["tp"]
    tokens = FUSED["batch"] * FUSED["seq"]
    k_loc = cfg.d_ff // tp
    xs, ws = [], []
    for r in range(tp):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(seed * 1000 + r)
        xs.append(torch.randn((tokens, k_loc), generator=gen,
                              device="cuda").to(torch.bfloat16))
        ws.append((torch.randn((k_loc, cfg.d_model), generator=gen,
                               device="cuda") / math.sqrt(cfg.d_ff))
                  .to(torch.bfloat16))
    return xs, ws


def fused_phase(seed: int, rows: dict) -> None:
    cfg = get_config(FUSED_ARCH)
    tp = FUSED["tp"]
    xs, ws = fused_inputs(cfg, seed)
    m, k_loc = xs[0].shape
    n = ws[0].shape[1]
    gb = sum(t.numel() * t.element_size() for t in xs + ws) / 1e9
    eng = get_engine()
    price = eng.price_fused_matmul_rs(m, k_loc, n, tp, dtype_bytes=2)
    log(f"fused {cfg.name} TP-{tp} down-projection: per rank x [{m}, "
        f"{k_loc}] @ w [{k_loc}, {n}] bf16 -> [{m // tp}, {n}]; {gb:.3f} GB "
        f"of operands | auto would take the "
        f"{'fused ring' if price['saved'] > 0 else 'gathered path'} (model "
        f"on the reference's TPU fabric: fused {price['fused']:.0f}, serial "
        f"{price['serial']:.0f} cycles)")
    run_local(lambda c: eng.fused_matmul_reduce_scatter(   # warm-up
        xs[c.rank][:tp * 16], ws[c.rank], c, algorithm="fused"), tp)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    got = run_local(lambda c: eng.fused_matmul_reduce_scatter(
        xs[c.rank], ws[c.rank], c, algorithm="fused"), tp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    want_counts = dict.fromkeys(ops.WRAPPERS, 0)
    want_counts["matmul_tiled"] = tp * tp
    assert counts == want_counts, (counts, want_counts)
    variants = ops.variant_launch_counts()["matmul_tiled"]
    assert variants == {"simt_f32": 0, "wmma_masked": 0,
                        "wgmma": tp * tp}, variants
    rows["matmul_tiled"]["launches"] = counts["matmul_tiled"]
    # multi_add is on no path of the port, as on none of the reference's
    # (only repro/kernels/ops.py and its tests call it): its row reads 0
    rows["multi_add"]["launches"] = counts["multi_add"]

    gathered = run_local(
        lambda c: impl.matmul_then_rs(xs[c.rank], ws[c.rank], c), tp)
    torch.cuda.synchronize()
    errs = []
    for r in range(tp):
        assert got[r].shape == (m // tp, n) and got[r].dtype == torch.bfloat16
        assert torch.isfinite(got[r].float()).all()
        errs.append(_rel_err(got[r], gathered[r]))
    rows_s = slice(0, min(64, m // tp))     # rank 0's block: its first rows
    exact = sum(xs[r][rows_s].double() @ ws[r].double() for r in range(tp))
    err64 = _rel_err(got[0][rows_s], exact)
    assert max(errs) <= FUSED_TOL and err64 <= FUSED_TOL, (errs, err64)
    log(f"fused ring on {tp} LocalComm ranks: {counts['matmul_tiled']} "
        f"matmul_tiled launches ({tp} per rank, all wgmma) | per-rank block "
        f"vs the "
        f"gathered path (float32 GEMM + reduce-scatter), err / max-abs: max "
        f"{max(errs):.3e} | rank 0 rows 0-{rows_s.stop - 1} vs float64: "
        f"{err64:.3e} (tol "
        f"{FUSED_TOL:.4f}: 16 bf16 roundings) | host wall {wall * 1e3:.1f} ms "
        f"(threads on one card, not a fabric time)")
    del gathered, got
    prof = profile_step(lambda: run_local(
        lambda c: eng.fused_matmul_reduce_scatter(
            xs[c.rank], ws[c.rank], c, algorithm="fused"), tp))
    log(f"profile of one fused ring call on {tp} local ranks: {prof}")

    # one backward through the kernel at one ring step's shape
    x = xs[0][: m // tp].clone().requires_grad_()
    w = ws[0].clone().requires_grad_()
    g = torch.randn((m // tp, n), device="cuda").to(torch.bfloat16)
    out = ops.matmul_tiled(x, w)
    out.backward(g)
    torch.cuda.synchronize()
    dx = torch.matmul(g.float(), ws[0].float().t()).to(torch.bfloat16)
    dw = torch.matmul(xs[0][: m // tp].float().t(), g.float()).to(
        torch.bfloat16)
    fwd_err = _rel_err(out.detach(), matmul_tiled_ref(x.detach(), w.detach()))
    assert fwd_err <= MM_TOL[torch.bfloat16], fwd_err
    assert torch.equal(x.grad, dx) and torch.equal(w.grad, dw)
    log(f"matmul_tiled backward at one ring step ([{m // tp}, {k_loc}] @ "
        f"[{k_loc}, {n}] bf16): forward err / max|plain| {fwd_err:.3e}; dx, "
        f"dw bitwise equal to torch.matmul in float32 (the reference's dense "
        f"backward)")


# ------------------------ data-parallel train phase --------------------- #
def dp_rank_batch(cfg, rows: int, seq: int, step: int, rank: int,
                  n: int) -> dict:
    """Rank ``rank``'s rows of the global batch of ``n`` ranks (folded
    (pod, data) order), on the card."""
    data = SyntheticLMDataset(DataConfig(cfg.vocab_size, seq, rows * n))
    return {k: torch.from_numpy(v[rank * rows:(rank + 1) * rows]).cuda()
            for k, v in data.batch(step).items()}


def dp_memory_gb(cfg, rows: int, seq: int, esize: int) -> float:
    """What one DP rank holds at its peak, reckoned before the run: the
    parameters and their gradient (``esize`` bytes each), AdamW's two
    float32 moments (whole trees at step 0 in either mode: fsdp cuts them
    into 1/P flat shards during that step), the float32 flat vector of
    the sync and its cast back, and the logits with their float32 copy
    and gradient."""
    p = cfg.param_count()
    flat = 4 * p + esize * p
    logits = rows * seq * cfg.vocab_size * (esize + 4 + 4)
    return (2 * esize * p + 8 * p + flat + logits) / 1e9


def dp_run(cfg, mode: str, fused: bool, steps: int, lr: float,
           timed: bool, seed: int):
    """``steps`` DP steps on the grid's rank threads, from the weights of
    ``seed``: every rank's (losses, grad norms, walls, rank 0's params on
    the host when not ``timed``)."""
    shape = DP_TRAIN["grid"]
    n = math.prod(shape)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=1, total_steps=10,
                          schedule="wsd")

    def fn(grid):
        state = init_train_state(init_params(cfg, seed=seed,
                                             device=grid.device))
        gs = GradSyncConfig(grid=grid, axes=("pod", "data"), mode=mode,
                            fused=fused)
        step_fn = make_train_step(cfg, opt_cfg, grad_sync=gs)
        batches = [dp_rank_batch(cfg, DP_TRAIN["rows"], DP_TRAIN["seq"], i,
                                 grid.rank, n) for i in range(steps)]
        losses, gnorms, walls = [], [], []
        for batch in batches:
            with ambient_grid(grid):
                state, metrics, loss, wall = timed_step(step_fn, state,
                                                        batch)
            losses.append(loss)
            gnorms.append(float(metrics["grad_norm"]))
            walls.append(wall)
        params = None
        if not timed and grid.rank == 0:
            params = [p.cpu() for p in tree_leaves(state.params)]
        del state
        return losses, gnorms, walls, params

    return run_local_grid(fn, shape, ("pod", "data"), "cuda")


def dp_train_phase(seed: int) -> None:
    n = math.prod(DP_TRAIN["grid"])
    cfg = with_layer_units(get_config(DP_ARCH), DP_TRAIN["layers"])
    tokens = n * DP_TRAIN["rows"] * DP_TRAIN["seq"]
    eng = get_engine()
    log(f"dp train {cfg.name}: {cfg.num_layers} of 40 layers at full width "
        f"(d_model {cfg.d_model}, {cfg.num_heads} x "
        f"{cfg.resolved_head_dim} heads, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}), {cfg.param_count() / 1e9:.3f}B params, "
        f"{cfg.dtype}; a {DP_TRAIN['grid'][0]} x {DP_TRAIN['grid'][1]} "
        f"(pod, data) grid of rank threads on one card, "
        f"{DP_TRAIN['rows']} x {DP_TRAIN['seq']} tokens a rank; reckoned "
        f"peak a rank, every mode: "
        f"{dp_memory_gb(cfg, DP_TRAIN['rows'], DP_TRAIN['seq'], 2):.1f} GB"
        f" (x {n} ranks; the card has "
        f"{torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB)")
    plans = bucket_algorithm_plan(
        init_params(cfg, device="meta"), (("pod", "data"),
                                           DP_TRAIN["grid"]),
        axes=("pod", "data"), bucket_bytes=GradSyncConfig(None).bucket_bytes,
        engine=eng)
    summary = {}
    for nbytes, plan in plans:
        summary.setdefault(plan, [0, 0])
        summary[plan][0] += 1
        summary[plan][1] += nbytes
    log(f"dp train: allreduce mode's {len(plans)} buckets of "
        f"{GradSyncConfig(None).bucket_bytes >> 20} MB, by the planner's "
        f"plan (TPU fabric model): " + "; ".join(
            f"{plan} x {k} ({b / 1e9:.3f} GB)"
            for plan, (k, b) in summary.items()))
    for mode, fused in DP_MODES:
        label = mode + (" fused" if fused else "")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        before = eng.stats_snapshot()
        ops.reset_launch_counts()
        out = dp_run(cfg, mode, fused, DP_TRAIN["steps"], DP_TRAIN["lr"],
                     timed=True, seed=seed)
        counts = ops.launch_counts()
        after = eng.stats_snapshot()
        peak = torch.cuda.max_memory_allocated() / 1e9
        losses, gnorms, walls, _ = out[0]
        assert all(o[:2] == (losses, gnorms) for o in out), \
            [o[:2] for o in out]
        assert all(math.isfinite(x) for x in losses + gnorms), (losses,
                                                                gnorms)
        want = dict.fromkeys(ops.WRAPPERS, 0)
        want["flash_attention"] = 2 * cfg.num_layers * n * DP_TRAIN["steps"]
        assert counts == want, (label, counts, want)
        variants = ops.variant_launch_counts()["flash_attention"]
        assert variants["wgmma"] == want["flash_attention"], variants
        steady = float(np.median(walls[1:]))
        log(f"dp train {label}: loss " + " ".join(f"{x:.4f}" for x in losses)
            + " | grad_norm " + " ".join(f"{x:.4f}" for x in gnorms)
            + f" (the global batch's, equal on every rank) | step wall "
            f"median of steps 1-{len(walls) - 1} {steady * 1e3:.1f} ms (step "
            f"0 {walls[0] * 1e3:.1f} ms) = {tokens / steady:.1f} tok/s over "
            f"{n} rank threads on one card (host walls of threads sharing "
            f"one card, not a fabric time) | max_memory_allocated "
            f"{peak:.3f} GB (all ranks) | engine plan hits "
            f"{after['plan_hits'] - before['plan_hits']}, misses "
            f"{after['plan_misses'] - before['plan_misses']}, selector hits "
            f"{after['hits'] - before['hits']}, misses "
            f"{after['misses'] - before['misses']} | flash_attention "
            f"launches {counts['flash_attention']} (2 a layer a rank a step, "
            f"all wgmma; the kernels line keeps the dense train phase's count)")
        del out
    dp_check(seed)


def dp_check(seed: int) -> None:
    """DP_TRAIN['check_steps'] float32 steps of each mode at
    DP_TRAIN['check_layers'] layers, held to the plain single-rank steps
    on the same global batches (microbatches = the ranks, so each sees
    the rank's rows): every step's loss and grad_norm, and every
    parameter after the last step."""
    n = math.prod(DP_TRAIN["grid"])
    cfg = dataclasses.replace(
        with_layer_units(get_config(DP_ARCH), DP_TRAIN["check_layers"]),
        dtype="float32")
    opt_cfg = AdamWConfig(lr=DP_TRAIN["lr"], warmup_steps=1, total_steps=10,
                          schedule="wsd")
    steps = DP_TRAIN["check_steps"]
    state = init_train_state(init_params(cfg, seed=seed, device="cuda"))
    data = SyntheticLMDataset(DataConfig(cfg.vocab_size, DP_TRAIN["seq"],
                                         DP_TRAIN["rows"] * n))
    step_fn = make_train_step(cfg, opt_cfg, microbatches=n)
    losses, gnorms, walls = [], [], []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).cuda()
                 for k, v in data.batch(i).items()}
        state, metrics, loss, wall = timed_step(step_fn, state, batch)
        losses.append(loss)
        gnorms.append(float(metrics["grad_norm"]))
        walls.append(wall)
    plain = [p.cpu() for p in tree_leaves(state.params)]
    del state, step_fn, batch, metrics
    torch.cuda.empty_cache()
    log(f"dp check: {steps} plain single-rank steps, {cfg.num_layers} layer "
        f"float32, {n} x {DP_TRAIN['rows']} x {DP_TRAIN['seq']} tokens in {n} "
        f"microbatches: loss " + " ".join(f"{x:.6f}" for x in losses)
        + " | grad_norm " + " ".join(f"{x:.6f}" for x in gnorms)
        + " | walls " + " ".join(f"{x * 1e3:.1f}" for x in walls) + " ms")
    for mode, fused in DP_MODES:
        label = mode + (" fused" if fused else "")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        out = dp_run(cfg, mode, fused, steps, DP_TRAIN["lr"], timed=False,
                     seed=seed)
        dp_losses, dp_gnorms, _, params = out[0]
        peak = torch.cuda.max_memory_allocated() / 1e9
        assert all(o[:2] == (dp_losses, dp_gnorms) for o in out), \
            (label, [o[:2] for o in out])
        worst, worst_abs = 0.0, 0.0
        for a, b in zip(params, plain):
            excess = (a - b).abs() - (DP_ATOL + DP_RTOL * b.abs())
            worst = max(worst, float(excess.max()))
            worst_abs = max(worst_abs, float((a - b).abs().max()))
        d_loss = max(abs(a - b) / abs(b) for a, b in zip(dp_losses, losses))
        d_gnorm = max(abs(a - b) / b for a, b in zip(dp_gnorms, gnorms))
        assert (worst <= 0.0 and d_loss < 1e-5
                and d_gnorm < DP_GNORM_RTOL), (label, worst, d_loss, d_gnorm)
        log(f"dp check {label}: loss " + " ".join(
            f"{x:.6f}" for x in dp_losses) + f" (max rel diff {d_loss:.2e}, "
            f"tol 1e-5) | grad_norm " + " ".join(
                f"{x:.6f}" for x in dp_gnorms) + f" (max rel diff "
            f"{d_gnorm:.2e}, tol {DP_GNORM_RTOL}) | every parameter after "
            f"step {steps - 1} within rtol {DP_RTOL} / atol {DP_ATOL} of the "
            f"plain steps (max abs diff {worst_abs:.3e}) | "
            f"max_memory_allocated {peak:.3f} GB")
        del out, params
    del plain
    torch.cuda.empty_cache()


# ------------------------ tensor-parallel decode ------------------------- #
def tp_greedy(params, cfg, prompt, grid):
    """Prefill, pad the cache, (on a grid: keep this rank's sequence
    block), then greedy decode steps; (tokens, logits of every step)."""
    with ambient_grid(grid):
        logits, cache = make_prefill_step(cfg)(params, {"tokens": prompt})
    torch.cuda.synchronize()
    counts = ops.launch_counts() if grid is None else None
    pad = (0, 0, 0, 0, 0, TP_DECODE["headroom"])
    cache = dict(cache, k=torch.nn.functional.pad(cache["k"], pad),
                 v=torch.nn.functional.pad(cache["v"], pad))
    if grid is not None:
        cache = shard_decode_cache(cfg, cache, grid)
        assert cache["smax"] == TP_DECODE["prompt"] + TP_DECODE["headroom"]
    decode = make_decode_step(cfg)
    steps, toks = [logits], []
    for _ in range(TP_DECODE["new_tokens"]):
        nxt = steps[-1][:, -1].argmax(-1, keepdim=True).to(torch.int32)
        toks.append(nxt)
        with ambient_grid(grid):
            logits, cache = decode(params, cache, {"tokens": nxt})
        steps.append(logits)
    torch.cuda.synchronize()
    return torch.cat(toks, 1), torch.cat(steps, 1), counts


def tp_decode_phase(seed: int) -> None:
    tp = TP_DECODE["tp"]
    cfg = with_layer_units(get_config(DP_ARCH), TP_DECODE["layers"])
    # the weights are replicated over "model": the rank threads share one
    # copy, which none of them writes
    params = init_params(cfg, seed=seed, device="cuda")
    b, s = TP_DECODE["batch"], TP_DECODE["prompt"]
    prompt = lm_batch(cfg, b, s, 2)["tokens"]
    act = 2 * b * s * (cfg.d_model + cfg.d_ff) * 2 / 1e9
    cache_gb = (2 * cfg.num_layers * b * (s + TP_DECODE["headroom"])
                * cfg.num_kv_heads * cfg.resolved_head_dim * 2) / 1e9
    log(f"tp decode {cfg.name}: {cfg.num_layers} layers at full width, "
        f"{cfg.dtype}, {cfg.param_count() / 1e9:.3f}B params shared by "
        f"{tp} model-rank threads; reckoned: weights "
        f"{cfg.param_count() * 2 / 1e9:.2f} GB once, a rank's prefill "
        f"activations ~{act:.2f} GB and its whole cache {cache_gb:.2f} GB "
        f"before it keeps its 1/{tp} block")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    want_toks, want_logits, single_counts = tp_greedy(params, cfg, prompt,
                                                      None)
    t_single = time.perf_counter() - t0
    set_fused_tp(True)
    try:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = run_local_grid(lambda g: tp_greedy(params, cfg, prompt, g),
                             (tp,), ("model",), "cuda")
        t_tp = time.perf_counter() - t0
    finally:
        set_fused_tp(False)
    counts = ops.launch_counts()
    want = dict.fromkeys(ops.WRAPPERS, 0)
    want["matmul_tiled"] = tp * tp * cfg.num_layers
    want["flash_attention"] = tp * cfg.num_layers
    assert counts == want, (counts, want)
    variants = ops.variant_launch_counts()["matmul_tiled"]
    assert variants == {"simt_f32": 0, "wmma_masked": 0,
                        "wgmma": want["matmul_tiled"]}, variants
    tol = 2 * float(bf16_ulp(want_logits.float().abs().max()))
    errs = []
    for toks, logits, _ in out:
        assert torch.equal(toks, want_toks), (toks, want_toks)
        assert torch.isfinite(logits).all()
        errs.append(float((logits.float() - want_logits.float()).abs()
                          .max()))
    assert max(errs) <= tol, (errs, tol)
    log(f"tp decode: single-rank route (prefill {b} x {s}, "
        f"{TP_DECODE['new_tokens']} greedy steps) {t_single * 1e3:.1f} ms, "
        f"launches {single_counts['flash_attention']} flash, "
        f"{single_counts['matmul_tiled']} matmul_tiled | TP-{tp} route on "
        f"{tp} rank threads {t_tp * 1e3:.1f} ms (host wall of threads on "
        f"one card, not a fabric time): matmul_tiled launches "
        f"{counts['matmul_tiled']} ({tp} a rank a layer in the prefill's "
        f"fused ring, all wgmma; decode rows {b} do not split over {tp}: "
        f"the unfused product, as in the reference), flash_attention "
        f"{counts['flash_attention']} (prefill; the kernels line keeps the "
        f"fused and dense train phases' counts) | decode through "
        f"flash_decode over a cache of {s + TP_DECODE['headroom']} "
        f"positions in blocks of {(s + TP_DECODE['headroom']) // tp} | "
        f"greedy tokens identical on every rank | logits vs the single "
        f"rank max_abs_err {max(errs):.3e} (tol {tol:.3e}: 2 bf16 ulps of "
        f"the largest logit)")


# ------------------------------ MoE phases ------------------------------ #
def moe_train_phase(seed: int) -> None:
    """olmoe-1b-7b at full width, MOE_TRAIN['layers'] layers, bf16, remat:
    the memory reckoned first, then 5 AdamW steps (loss, aux, step wall,
    tok/s, peak memory), every attention in the flash kernel's wgmma
    variant, one step profiled."""
    cfg = with_layer_units(get_config(MOE_ARCH), MOE_TRAIN["layers"])
    p = cfg.param_count()
    reckoned = (2 * p + 2 * p + 8 * p) / 1e9
    t0 = time.perf_counter()
    state = init_train_state(init_params(cfg, seed=seed, device="cuda"))
    torch.cuda.synchronize()
    log(f"moe train {cfg.name}: {cfg.num_layers} of 16 layers at full width "
        f"(d_model {cfg.d_model}, {cfg.num_heads} x "
        f"{cfg.resolved_head_dim} heads, {cfg.num_experts} experts of d_ff "
        f"{cfg.d_ff}, top {cfg.experts_per_token}, vocab {cfg.vocab_size}), "
        f"{cfg.dtype}; {p / 1e9:.3f}B params; reckoned before activations: "
        f"params + grads (bf16) + AdamW moments (float32) = "
        f"{reckoned:.2f} GB; random weights (seed {seed}) and AdamW state "
        f"in {time.perf_counter() - t0:.1f} s")
    steps = MOE_TRAIN["steps"]
    opt_cfg = AdamWConfig(lr=MOE_TRAIN["lr"], warmup_steps=max(steps // 20, 1),
                          total_steps=steps, schedule="cosine")
    step_fn = make_train_step(cfg, opt_cfg)
    batches = [lm_batch(cfg, MOE_TRAIN["batch"], MOE_TRAIN["seq"], i)
               for i in range(steps + 1)]
    tokens = MOE_TRAIN["batch"] * MOE_TRAIN["seq"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    losses, auxes, walls = [], [], []
    for i in range(steps):
        state, metrics, loss, wall = timed_step(step_fn, state, batches[i])
        losses.append(loss)
        auxes.append(float(metrics["aux"]))
        walls.append(wall)
        log(f"moe train step {i}: loss {loss:.4f} (ce "
            f"{float(metrics['ce']):.4f}, aux {auxes[-1]:.4f}) | grad_norm "
            f"{float(metrics['grad_norm']):.3f} | wall {wall * 1e3:.1f} ms | "
            f"{tokens / wall:.1f} tok/s")
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    assert all(math.isfinite(x) for x in losses + auxes), (losses, auxes)
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    want = dict.fromkeys(ops.WRAPPERS, 0)
    want["flash_attention"] = 2 * cfg.num_layers * steps
    assert counts == want, (counts, want)
    variants = ops.variant_launch_counts()["flash_attention"]
    assert variants == {"simt_f32": 0, "mma_sync": 0,
                        "wgmma": want["flash_attention"]}, variants
    steady = float(np.median(walls[1:]))
    log(f"moe train: {steps} steps of {MOE_TRAIN['batch']} x "
        f"{MOE_TRAIN['seq']} tokens, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}, aux {auxes[0]:.4f} -> {auxes[-1]:.4f} | step "
        f"wall median of steps 1-{steps - 1} {steady * 1e3:.1f} ms (step 0 "
        f"{walls[0] * 1e3:.1f} ms) = {tokens / steady:.1f} tok/s | "
        f"max_memory_allocated {peak_gb:.3f} GB (reckoned {reckoned:.2f} GB "
        f"before activations) | flash_attention launches per step "
        f"{counts['flash_attention'] // steps} (2 x {cfg.num_layers} "
        f"layers: forward and remat), every one the wgmma variant; the "
        f"kernels line keeps the dense train phase's count")
    holder = {"state": state}

    def one_step():
        holder["state"], _ = step_fn(holder["state"], batches[steps])
    log(f"profile of one moe train step (kernel route): "
        f"{profile_step(one_step)}")


def ep_forward_phase(seed: int) -> None:
    """moe_ffn_ep at olmoe-1b-7b's full width on 8 rank threads, forward
    only: each of MOE_EP['layers'] layers' MoE FFNs on the input the
    single-rank route gives it (so a route's rounding never reroutes a
    later layer's tokens), for every grid and algorithm, float32 and bf16,
    against that layer's single-rank ``moe_ffn`` at the same grouping
    (one call a row, as each EP rank routes one row)."""
    from repro_torch.models import moe, moe_ep
    from repro_torch.models import transformer as tf
    from repro_torch.models.layers import rms_norm
    from repro_torch.sharding.rules import for_grid

    base = with_layer_units(get_config(MOE_ARCH), MOE_EP["layers"])
    eng = get_engine()
    kw = dict(top_k=base.experts_per_token,
              capacity_factor=base.capacity_factor)
    b, s = MOE_EP["rows"], MOE_EP["seq"]
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, dtype=dtype)
        params = init_params(cfg, seed=seed, device="cuda")
        tokens = lm_batch(cfg, b, s, 3)["tokens"]
        inputs, want, want32, err_plain = [], [], [], []
        with torch.no_grad():
            x = tf._embed(params, cfg, tokens)
            for lp in params["layers"]:
                a, _ = tf._attention_sublayer(
                    cfg, rms_norm(x, lp["ln1"], cfg.norm_eps), lp)
                x = x + a
                h = rms_norm(x, lp["ln2"], cfg.norm_eps)
                ws = (lp["router"], lp["eg"], lp["eu"], lp["ed"])
                out = torch.cat([moe.moe_ffn(h[i:i + 1], *ws, **kw)[0]
                                 for i in range(b)])
                inputs.append(h)
                want.append(out)
                if dtype == "bfloat16":
                    w32 = [w.float() for w in ws]
                    out32 = torch.cat([moe.moe_ffn(h[i:i + 1].float(), *w32,
                                                   **kw)[0]
                                       for i in range(b)])
                    want32.append(out32)
                    err_plain.append(float((out.float() - out32).abs()
                                           .max()))
                x = x + out
        for shape, names in MOE_EP["grids"]:
            for alg in MOE_EP["algorithms"]:
                def rank(grid):
                    dp = for_grid(grid).data_axes
                    per = b // math.prod(grid.axis_size(a) for a in dp)
                    rows = slice(grid.axes_index(dp) * per,
                                 (grid.axes_index(dp) + 1) * per)
                    ep_axes = moe_ep._ep_axes_for(grid)
                    spec = ep_axes if len(ep_axes) > 1 else ep_axes[0]
                    fsdp = ("data" if "data" in names
                            and "data" not in ep_axes else None)
                    lp = params["layers"][0]
                    held = moe.expert_weights(grid, lp["eg"], lp["eu"],
                                              lp["ed"], spec, fsdp)
                    outs = []
                    with torch.no_grad(), ambient_grid(grid):
                        for h, lp in zip(inputs, params["layers"]):
                            outs.append(moe_ep.moe_ffn_ep(
                                h[rows], lp["router"], lp["eg"], lp["eu"],
                                lp["ed"], algorithm=alg, engine=eng,
                                **kw)[0])
                    torch.cuda.synchronize()
                    return rows, outs, [w.shape[0] for w in held], ep_axes

                before = eng.stats_snapshot()
                t0 = time.perf_counter()
                res = run_local_grid(rank, shape, names, "cuda")
                wall = time.perf_counter() - t0
                after = eng.stats_snapshot()
                ep_axes = res[0][3]
                n_ep = math.prod(shape[names.index(a)] for a in ep_axes)
                errs = []
                for rows, outs, held, _ in res:
                    assert held == [base.num_experts // n_ep] * 3, held
                    for l, out in enumerate(outs):
                        assert torch.isfinite(out).all()
                        if dtype == "float32":
                            torch.testing.assert_close(
                                out, want[l][rows], rtol=1e-4, atol=1e-4)
                            errs.append(float((out - want[l][rows]).abs()
                                              .max()))
                        else:
                            # several bf16 roundings (h, u, the hidden,
                            # y, each weighted add): held, as the bf16
                            # single-rank route is, to the float32 route;
                            # its error may exceed that route's own by
                            # one bf16 ulp of the largest output
                            ref = want32[l][rows]
                            err = float((out.float() - ref).abs().max())
                            bound = err_plain[l] + float(bf16_ulp(
                                want32[l].abs().max()))
                            assert err <= bound, (alg, names, l, err, bound)
                            errs.append(err)
                # a rank's exchange: its rows' [G_l, E, Cap, D] buffer
                nbytes = (b // math.prod(shape)) \
                    * base.num_experts * moe.moe_capacity(
                        s, base.num_experts, base.experts_per_token,
                        base.capacity_factor) * base.d_model * (
                            4 if dtype == "float32" else 2)
                if len(ep_axes) > 1:
                    plan = (eng.plan_multi(
                        "all_to_all", ep_axes,
                        [shape[names.index(a)] for a in ep_axes], nbytes,
                        shape=None if alg in ("auto", "lax") else alg)
                            .describe() if alg != "lax" else "native")
                else:
                    plan = ("native" if alg == "lax" else "all_to_all["
                            + eng.select("all_to_all", nbytes, n_ep)
                            .algorithm + "] (one axis: the plan shape "
                            "collapses to the 1D selector)")
                what = ("max abs err vs the single-rank route "
                        f"{max(errs):.3e} (tol 1e-4)" if dtype == "float32"
                        else f"max abs err vs the float32 single-rank route "
                        f"{max(errs):.3e} (the bf16 single-rank route's own "
                        f"{max(err_plain):.3e}; tol: that + 1 bf16 ulp of "
                        f"the largest output)")
                log(f"ep forward {dtype} {shape[0]}x{shape[1]} "
                    f"{'/'.join(names)} algorithm={alg}: EP axes {ep_axes} "
                    f"({n_ep} ranks, {base.num_experts // n_ep} experts a "
                    f"rank), exchange {nbytes / 1e6:.1f} MB a rank x 2 a "
                    f"layer, plan {plan} | {what} | plan hits "
                    f"{after['plan_hits'] - before['plan_hits']}, misses "
                    f"{after['plan_misses'] - before['plan_misses']}, "
                    f"selector hits {after['hits'] - before['hits']}, misses "
                    f"{after['misses'] - before['misses']} | host wall "
                    f"{wall * 1e3:.1f} ms ({MOE_EP['layers']} layers, 8 "
                    f"threads on one card, not a fabric time)")
        del params, inputs, want, want32
        torch.cuda.empty_cache()


def row_invariance(cfg, params, seed: int) -> str:
    """Why a DP rank's decode call keeps the whole slot shape (ROADMAP
    C20): a mid-run decode step of one server's 8 rows, run again as
    calls of 1, 2 and 4 rows (each on a fresh copy of the pool), compared
    row by row with the 8-row call; and each 2-D weight of layer 0 and
    the unembedding as GEMMs of M 1, 2 and 4 rows against M 8.  Reports;
    asserts nothing (the DP streams check is the assertion)."""
    server = ContinuousBatchingServer(
        cfg, params, SERVE["batch"], max_len=SERVE["system_len"]
        + SERVE["suffix"][1] + SERVE["new_tokens"] + SERVE["block_size"],
        block_size=SERVE["block_size"], prefill_chunk=SERVE["prefill_chunk"],
        device="cuda")
    for req in make_requests(cfg, seed)[:SERVE["batch"]]:
        server.submit(req)
    server.run(max_steps=12)
    snap = snapshot_decode(server)
    n = snap["ctx_lens"].shape[0]

    def decode(rows):
        pages = {k: v.clone() for k, v in snap["pages"].items()}
        return decode_step_paged(
            params, cfg, pages, {"tokens": snap["batch"]["tokens"][rows]},
            snap["block_tables"][rows], snap["ctx_lens"][rows],
            use_kernel=True)[0]

    with torch.no_grad():
        full = decode(slice(0, n))
        calls = {w: all(torch.equal(decode(slice(i, i + w)), full[i:i + w])
                        for i in range(0, n - w + 1, w)) for w in (1, 2, 4)}
        x = params["embed"][snap["batch"]["tokens"][:, 0].long()]
        gemms = {}
        for name, w in [*params["layers"][0].items(),
                        ("head", params["head"])]:
            if w.dim() != 2 or w.shape[0] != x.shape[1]:
                continue
            y = x @ w
            gemms[f"{name} {tuple(w.shape)}"] = [
                m for m in (1, 2, 4) if not torch.equal(x[:m] @ w, y[:m])]
    differ = [f"{k} at M {v}" for k, v in gemms.items() if v]
    return (f"decode calls of 1 / 2 / 4 of the {n} rows bitwise equal to "
            f"the {n}-row call: {calls[1]} / {calls[2]} / {calls[4]} | "
            f"GEMMs on the residual stream whose rows differ from M {n}: "
            f"{', '.join(differ) or 'none'} | the others agree: "
            + ", ".join(k for k, v in gemms.items() if not v))


def dp_serve_phase(seed: int) -> None:
    """The serve phase's requests through one server and through
    ContinuousBatchingServer(grid=) on a ("data",) grid of DP_SERVE
    ['ranks'] rank threads sharing one copy of the weights (minicpm-2b
    at full width, DP_SERVE['layers'] layers): every rank's greedy
    streams equal the one server's."""
    cfg = with_layer_units(get_config(SERVE_ARCH), DP_SERVE["layers"])
    params = init_params(cfg, seed=seed, device="cuda")
    max_len = (SERVE["system_len"] + SERVE["suffix"][1] + SERVE["new_tokens"]
               + SERVE["block_size"])
    eng = get_engine()
    n = DP_SERVE["ranks"]

    def serve(grid):
        server = ContinuousBatchingServer(
            cfg, params, SERVE["batch"], max_len=max_len, seed=seed,
            grid=grid, engine=eng, block_size=SERVE["block_size"],
            prefill_chunk=SERVE["prefill_chunk"], device="cuda")
        for req in make_requests(cfg, seed):
            server.submit(req)
        results = server.run()
        torch.cuda.synchronize()
        return results, server.snapshot(), server.assembly_decision, \
            server.assembly_regime

    log(f"dp serve: row invariance (ROADMAP C20): "
        f"{row_invariance(cfg, params, seed)}")
    t0 = time.perf_counter()
    want, want_snap, _, _ = serve(None)
    t_one = time.perf_counter() - t0
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = run_local_grid(serve, (n,), ("data",), "cuda")
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    results, snap, dec, regime = out[0]
    for r, (res, _, _, _) in enumerate(out):
        diff = [rid for rid in want if res.get(rid) != want[rid]]
        assert not diff, f"dp rank {r}: streams of {diff} differ"
    assert snap.decode_steps == want_snap.decode_steps
    want_launches = n * snap.decode_steps * cfg.num_layers
    assert counts["paged_attention"] == want_launches, (counts,
                                                        want_launches)
    tokens = sum(len(v) for v in results.values())
    log(f"dp serve {cfg.name}: {cfg.num_layers} of 40 layers at full width; "
        f"one server {tokens} tokens in {t_one:.3f} s = {tokens / t_one:.1f} "
        f"tok/s | {n} rank threads on a ('data',) grid, "
        f"{SERVE['batch'] // n} slot rows a rank, one copy of the weights: "
        f"{tokens} tokens in {wall:.3f} s = {tokens / wall:.1f} tok/s (host "
        f"wall of threads on one card, not a fabric time; every rank runs "
        f"every prefill) | greedy streams of every rank identical to the "
        f"one server's | assembly_decision allgather[{dec.algorithm}] for "
        f"{dec.nbytes} bytes over {dec.p} ranks, predicted "
        f"{dec.predicted:.1f} (TPU model), {regime} regime | decode steps "
        f"{snap.decode_steps} | paged_attention launches "
        f"{counts['paged_attention']} (one a rank a layer a step, each over "
        f"the whole slot array with the other ranks' rows idle: ROADMAP "
        f"C20)")


# ---------------------- calibration and observability -------------------- #
THREADS_NOTE = "threads on one card, not a fabric"


def top_spans(spans) -> list:
    return [s for s in spans if s.cat == obs_trace.CAT_COLLECTIVE
            and s.parent_id is None]


def check_spans(spans, multi_names) -> str:
    """The trace contract of phase (a): ``validate_spans`` clean; every
    top-level collective span decided (a prediction unless forced, cache
    hit / miss / forced) and measured; every multi-axis span planned;
    every phase span nested under a collective span of its thread; the
    Chrome trace round-trips."""
    problems = obs_trace.validate_spans(spans)
    assert problems == [], problems[:5]
    by_id = {s.span_id: s for s in spans}
    tops = top_spans(spans)
    for s in tops:
        a = s.args
        assert a["predicted"] is not None or a.get("algorithm_forced"), a
        assert a["cache"] in ("hit", "miss", "forced"), a
        assert a["measured_s"] is not None and a["measured_s"] > 0, a
        if s.name in multi_names:
            assert a["plan"] is not None and a["n_chunks"] >= 1, a
    phases = [s for s in spans if s.cat == obs_trace.CAT_PHASE]
    assert phases
    for ph in phases:
        parent = by_id[ph.parent_id]
        assert parent.cat == obs_trace.CAT_COLLECTIVE, ph
        assert parent.tid == ph.tid, ph
    path = Path(build.BUILD_DIR) / f"obs_trace_{os.getpid()}.json"
    tracer = obs_trace.get_tracer()
    n = tracer.export_chrome(str(path))
    loaded = obs_trace.load_chrome_trace(str(path))
    path.unlink()
    want = sorted(spans, key=lambda s: (s.t0, s.span_id))
    assert n == len(spans)
    assert [(s.span_id, s.parent_id, s.name) for s in loaded] == [
        (s.span_id, s.parent_id, s.name) for s in want]
    assert obs_trace.validate_spans(loaded) == []
    return (f"{len(spans)} spans ({len(tops)} top-level collective spans "
            f"over every rank, {len(phases)} phase spans): validate_spans "
            f"clean, every top-level span decided and measured, every "
            f"multi-axis span planned, phases nested, the Chrome trace "
            f"round-trips")


def launch_samples(spans) -> list:
    """calibrate_launch's samples from rank 0's single-axis spans: the
    best measured wall of each (op, P, bytes, algorithm) whose algorithm
    has a closed form."""
    best = {}
    for s in top_spans(spans):
        a = s.args
        if a["rank"] != 0 or s.name.endswith("_multi"):
            continue
        p = math.prod(a["axis_sizes"])
        b = max(1, a["bytes"] // ICI_ELEMENT_BYTES)
        if a["algorithm"] not in selector.predict_collective(
                a["op"], p, b, TPU_V5E_AXIS, include_autogen=False):
            continue
        key = (a["op"], p, a["bytes"], a["algorithm"])
        best[key] = min(best.get(key, math.inf), a["measured_s"])
    return [k + (t,) for k, t in sorted(best.items())]


def span_counts(spans) -> str:
    counts = {}
    for s in top_spans(spans):
        counts[s.name] = counts.get(s.name, 0) + 1
    return ", ".join(f"{k} {v}" for k, v in sorted(counts.items()))


def traced_collectives(seed: int) -> list:
    """Phase (a): the six single-axis ops under every algorithm on the
    collective phase's 8 rank threads (axis "data"), and the four
    multi-axis ops (auto and one phased shape) on a 2 x 4 (pod, data)
    grid, at OBS_BYTES, OBS_REPEATS times, with tracing on and
    measuring; float32 results held exact as in the collective phase.
    Returns the spans."""
    p = COLLECTIVE_RANKS
    eng = CollectiveEngine(device="cuda", persist=False)
    tracer = obs_trace.get_tracer()
    tracer.clear()
    for _ in range(OBS_REPEATS):
        for nbytes in OBS_BYTES:
            xs = collective_inputs(p, nbytes, torch.float32, seed + nbytes)
            for op, algs in ALGORITHMS.items():
                wants = [collective_expected(op, xs, r) for r in range(p)]
                for alg in algs:
                    outs = run_local(
                        lambda c: run_collective(eng, op, alg, xs, c), p,
                        axis="data")
                    for r in range(p):
                        if wants[r] is not None:
                            check_collective(op, outs[r], wants[r])
            for op, shape in OBS_MULTI.items():
                xs2 = inputs_2d(op, nbytes, torch.float32, seed + nbytes)
                for alg in ("auto", shape):
                    outs = run_local_grid(
                        lambda g: (getattr(eng, op + "_multi")(
                            xs2[g.rank], g, ("pod", "data"), alg),
                            g.members(("pod", "data"))),
                        (2, 4), ("pod", "data"))
                    for r, (out, members) in enumerate(outs):
                        check_2d(op, out, xs2, members, r, None)
            del xs, xs2
            torch.cuda.empty_cache()
    return tracer.spans


def calibrated_error_table(samples, fabric, s_per_cycle: float) -> str:
    """The model-error table of the launch-calibrated model on the
    samples it was fitted to: each sample re-priced on ``fabric`` (with
    its fitted ``t_launch``) and scored at ``s_per_cycle``."""
    mon = obs_model_error.ModelErrorMonitor(seconds_per_cycle=s_per_cycle)
    for op, p, nbytes, alg, secs in samples:
        pred = selector.predict_collective(
            op, p, max(1, nbytes // ICI_ELEMENT_BYTES), fabric,
            include_autogen=False)
        mon.observe(op, str(p), nbytes, pred[alg], secs)
    return mon.render_table()


def calibrate_grid_phase() -> None:
    """Phase (c), in a cache directory of its own: calibrate(grid=) on a
    2 x 4 (pod, data) thread grid, auto's allreduce picks under the
    fitted constants beside the stock ones, the topology persisted and
    restored there, and not under REPRO_TORCH_RESTORE_TOPOLOGY=0."""
    usual = os.environ.get("REPRO_TORCH_CACHE_DIR")
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="obs_cache_", dir=build.BUILD_DIR)
    os.environ["REPRO_TORCH_CACHE_DIR"] = tmp
    try:
        cal = CollectiveEngine(device="cuda")
        t0 = time.perf_counter()
        out = run_local_grid(
            lambda g: (measure_ppermute(g.sub("data"), CALIBRATE_BYTES,
                                        CALIBRATE_REPEATS),
                       cal.calibrate(grid=g, sizes_bytes=CALIBRATE_BYTES)),
            (2, 4), ("pod", "data"))
        shifts, topo = out[0]
        assert all(t == topo for _, t in out) and cal.topology == topo
        log(f"obs (c) measure_ppermute on a 'data' row (4 rank threads; "
            f"the slowest rank's best of {CALIBRATE_REPEATS}): " + ", ".join(
                f"{nb >> 10} KB {t * 1e6:.1f} us" for nb, t in shifts)
            + f" ({THREADS_NOTE})")
        for axis, fab in topo.axis_fabrics:
            log(f"obs (c) calibrate(grid=) axis {axis!r}: Fabric("
                f"name={fab.name!r}, t_r={fab.t_r:.6g}, link_bw="
                f"{fab.link_bw:.6g}, store_cost={fab.store_cost:g}, "
                f"multicast={fab.multicast}) from shifts of "
                f"{CALIBRATE_BYTES[0] >> 10} KB - {CALIBRATE_BYTES[-1] >> 20}"
                f" MB a rank, best of {CALIBRATE_REPEATS}, the slowest rank's "
                f"({THREADS_NOTE}); {time.perf_counter() - t0:.1f} s")
        stock = CollectiveEngine(device="cuda", persist=False)
        fab = topo.for_axis("data")
        for nbytes in AUTO_BYTES:
            d0 = stock.select("allreduce", nbytes, COLLECTIVE_RANKS)
            d1 = cal.select("allreduce", nbytes, COLLECTIVE_RANKS,
                            fabric=fab)
            p0 = stock.plan_multi("allreduce", ("pod", "data"), (2, 4),
                                  nbytes)
            p1 = cal.plan_multi("allreduce", ("pod", "data"), (2, 4),
                                nbytes)
            log(f"obs (c) auto allreduce {nbytes >> 10} KB, P "
                f"{COLLECTIVE_RANKS}: stock {d0.algorithm} | fitted "
                f"('data' axis) {d1.algorithm}; 2 x 4 (pod, data): stock "
                f"{p0.describe()} | fitted {p1.describe()}")
        cal.flush()
        assert find_calibrated_topology() == topo
        os.environ["REPRO_TORCH_RESTORE_TOPOLOGY"] = "0"
        try:
            assert find_calibrated_topology() is None
        finally:
            del os.environ["REPRO_TORCH_RESTORE_TOPOLOGY"]
        log(f"obs (c) the calibrated topology {topo.name!r} persisted in "
            f"the phase's own cache directory "
            f"({os.path.basename(cal._cache_path())}) and restores there; "
            f"not under REPRO_TORCH_RESTORE_TOPOLOGY=0")
    finally:
        if usual is None:
            os.environ.pop("REPRO_TORCH_CACHE_DIR", None)
        else:
            os.environ["REPRO_TORCH_CACHE_DIR"] = usual
        shutil.rmtree(tmp, ignore_errors=True)


def obs_phase(seed: int) -> None:
    """Calibration and observability on one card (ROADMAP A.2.b, A.7 (a)):
    (a) traced collectives, (b) calibrate_launch from their spans, (c)
    calibrate(grid=) on a 2 x 4 thread grid in a cache directory of its
    own, and auto's picks under the fitted constants beside the stock
    ones, (d) the model-error report, (e) a traced fsdp DP step and a
    short traced DP serve run with their registry export.  At the end
    the script's usual cache still gives the stock constants."""
    t_phase = time.perf_counter()
    tracer = obs_trace.enable_tracing(measure=True)
    try:
        # (a) traced collectives
        t0 = time.perf_counter()
        spans = traced_collectives(seed)
        multi = {op + "_multi" for op in OBS_MULTI}
        log(f"obs (a) traced collectives: 6 ops x every algorithm on "
            f"{COLLECTIVE_RANKS} LocalComm ranks and 4 multi-axis ops x "
            f"(auto, {', '.join(sorted(set(OBS_MULTI.values())))}) on a "
            f"2 x 4 (pod, data) grid, {len(OBS_BYTES)} sizes "
            f"{OBS_BYTES[0] >> 10} KB - {OBS_BYTES[-1] >> 20} MB a rank, "
            f"{OBS_REPEATS} repeats, float32 exact, tracing on and "
            f"measuring: {check_spans(spans, multi)}; "
            f"{time.perf_counter() - t0:.1f} s ({THREADS_NOTE})")
        # (b) calibrate_launch from the spans
        samples = launch_samples(spans)
        launches = sorted({pat.launch_count(op, alg, p)
                           for op, p, _, alg, _ in samples})
        s_per_cycle, _ = fit_launch(samples)
        launch_eng = CollectiveEngine(device="cuda", persist=False)
        t_launch = launch_eng.calibrate_launch(samples)
        log(f"obs (b) calibrate_launch: {len(samples)} samples (rank 0's "
            f"best wall of each op x algorithm x size with a closed form; "
            f"launch counts {launches[0]:g} - {launches[-1]:g}): t_launch "
            f"{t_launch:.6g} model cycles, {s_per_cycle:.6e} s a model "
            f"cycle, i.e. {t_launch * s_per_cycle * 1e6:.3f} us a launch "
            f"({THREADS_NOTE}; the model cycles are the TPU model's)")
        # (c) calibrate(grid=) on the 2 x 4 thread grid
        calibrate_grid_phase()
        # (d) the model-error reports
        mon = obs_model_error.ModelErrorMonitor(
            seconds_per_cycle=s_per_cycle)
        fed = mon.observe_spans(spans)
        log(f"obs (d) model error over (a)'s spans (rank 0's model-selected"
            f" ones: {fed}; their predictions are the stock TPU v5e model's,"
            f" scored at (b)'s {s_per_cycle:.6e} s a cycle; "
            f"{THREADS_NOTE}):\n" + mon.render_table())
        log(f"obs (d) model error of the launch-calibrated model (t_launch "
            f"{t_launch:.6g}) on (b)'s {len(samples)} samples, in sample "
            f"({THREADS_NOTE}):\n" + calibrated_error_table(
                samples, launch_eng.fabric, s_per_cycle))
        # (e) a traced fsdp DP step and a short traced DP serve run
        tracer.clear()
        obs_dp_and_serve(seed)
    finally:
        obs_trace.disable_tracing()
        obs_trace.get_tracer().clear()
    stock_topo = FabricTopology.uniform(TPU_V5E_AXIS)
    assert find_calibrated_topology() is None
    assert get_engine().topology == stock_topo
    saved = dict(collectives_api._ENGINES)
    collectives_api._ENGINES.clear()
    try:
        assert get_engine().topology == stock_topo
    finally:
        collectives_api._ENGINES.clear()
        collectives_api._ENGINES.update(saved)
    log(f"obs phase: {time.perf_counter() - t_phase:.1f} s; the script's "
        f"usual cache still gives get_engine() the stock TPU_V5E_AXIS "
        f"constants")


def obs_dp_and_serve(seed: int) -> None:
    """Phase (e): one fsdp step of the DP phase's configuration and a
    short DP serve run of the DP serve phase's, traced; the span counts,
    the model-error table, and the serve telemetry with the engine stats
    through a registry."""
    tracer = obs_trace.get_tracer()
    cfg = with_layer_units(get_config(DP_ARCH), DP_TRAIN["layers"])
    t0 = time.perf_counter()
    out = dp_run(cfg, "fsdp", False, 1, DP_TRAIN["lr"], timed=True,
                 seed=seed)
    assert all(math.isfinite(o[0][0]) for o in out), out
    dp_wall = time.perf_counter() - t0
    dp_spans = tracer.spans
    log(f"obs (e) traced fsdp DP step ({cfg.name}, {cfg.num_layers} layers, "
        f"{DP_TRAIN['grid'][0]} x {DP_TRAIN['grid'][1]} rank threads): loss "
        f"{out[0][0][0]:.4f}, {dp_wall:.1f} s with set-up; collective "
        f"spans (every rank): {span_counts(dp_spans)}")
    tracer.clear()
    scfg = with_layer_units(get_config(SERVE_ARCH), DP_SERVE["layers"])
    params = init_params(scfg, seed=seed, device="cuda")
    max_len = (SERVE["system_len"] + SERVE["suffix"][1]
               + OBS_SERVE["new_tokens"] + SERVE["block_size"])
    def serve(grid):
        server = ContinuousBatchingServer(
            scfg, params, SERVE["batch"], max_len=max_len, seed=seed,
            grid=grid, block_size=SERVE["block_size"],
            prefill_chunk=SERVE["prefill_chunk"], device="cuda")
        for req in make_requests(scfg, seed)[:OBS_SERVE["requests"]]:
            server.submit(dataclasses.replace(
                req, max_new_tokens=OBS_SERVE["new_tokens"]))
        results = server.run()
        torch.cuda.synchronize()
        return results, server.snapshot()

    t0 = time.perf_counter()
    out = run_local_grid(serve, (DP_SERVE["ranks"],), ("data",))
    serve_wall = time.perf_counter() - t0
    assert all(o[0] == out[0][0] for o in out)
    serve_spans = tracer.spans
    log(f"obs (e) traced DP serve ({scfg.name}, {scfg.num_layers} layers, "
        f"{DP_SERVE['ranks']} rank threads, {OBS_SERVE['requests']} "
        f"requests x "
        f"{OBS_SERVE['new_tokens']} tokens): {serve_wall:.1f} s; collective "
        f"spans (every rank): {span_counts(serve_spans)}")
    spans = dp_spans + serve_spans
    assert obs_trace.validate_spans(spans) == []
    mon = obs_model_error.ModelErrorMonitor()
    fed = mon.observe_spans(spans)
    log(f"obs (e) model error over the DP step's and the serve run's spans "
        f"(rank 0's model-selected ones: {fed}; each bin anchors on its "
        f"first {mon.min_samples}; TPU-model predictions, {THREADS_NOTE}):"
        f"\n" + mon.render_table())
    reg = obs_registry.MetricsRegistry()
    export_to_registry(out[0][1], reg)
    obs_registry.export_engine_stats(get_engine(), reg)
    blob = reg.export_json()
    assert obs_registry.validate_export(blob) == [], blob
    gauges = blob["gauges"]
    log(f"obs (e) registry: {len(gauges)} gauges, validate_export clean; "
        f"serve_decode_steps {gauges['serve_decode_steps']:g}, "
        f"serve_tokens_out {gauges['serve_tokens_out']:g}, engine "
        + ", ".join(f"{k.split('{')[0]} {v:g}" for k, v in gauges.items()
                    if k.startswith("engine_")))


# ------------------------------ NCCL phase ------------------------------ #
def nccl_worker(rank: int, world: int, init: str, seed: int) -> int:
    """One rank of the NCCL phase, on card ``rank``: the float32
    collective checks and one fused ring at the fused phase's shape."""
    torch.distributed.init_process_group("nccl", init_method=init,
                                         rank=rank, world_size=world)
    comm = ProcessGroupComm(device=f"cuda:{rank}")
    eng = CollectiveEngine(device=comm.device, persist=False)
    checks = 0
    for nbytes in COLLECTIVE_BYTES:
        with torch.cuda.device(comm.device):
            xs = collective_inputs(world, nbytes, torch.float32,
                                   seed + nbytes)
        for op, algs in ALGORITHMS.items():
            want = collective_expected(op, xs, rank)
            for alg in algs:
                if alg in ("tree", "doubling") and world & (world - 1):
                    continue
                got = run_collective(eng, op, alg, xs, comm)
                if want is not None:
                    check_collective(op, got, want)
                    checks += 1
    cfg = get_config(FUSED_ARCH)
    with torch.cuda.device(comm.device):
        xs, ws = fused_inputs(cfg, seed)
    got = impl.fused_matmul_rs(xs[rank], ws[rank], comm)
    gathered = impl.matmul_then_rs(xs[rank], ws[rank], comm)
    err = _rel_err(got, gathered)
    assert err <= FUSED_TOL, err
    grid_note = "no grid (fewer than 4 cards)"
    grid = None
    if world >= 4:
        shape = (2, world // 2)
        grid = ProcessGroupGrid(shape, ("pod", "data"), device=comm.device)
        with torch.cuda.device(comm.device):
            xs = inputs_2d("allreduce", 4 << 20, torch.float32, seed)[:world]
        total = torch.stack(xs).sum(0)
        for alg in NCCL_2D_SHAPES:
            out = eng.allreduce_multi(xs[rank], grid, ("pod", "data"), alg)
            assert torch.equal(out, total), alg
        grid_note = (f"allreduce_multi over a {shape[0]}x{shape[1]} "
                     f"ProcessGroupGrid as {', '.join(NCCL_2D_SHAPES)}: "
                     f"exact")
    nccl_calibrate(rank, world, comm, grid)
    torch.cuda.synchronize(comm.device)
    torch.distributed.destroy_process_group()
    print(f"nccl rank {rank}/{world}: {checks} float32 collective checks "
          f"exact; fused ring vs gathered path err / max-abs {err:.3e}; "
          f"{grid_note}", flush=True)
    return 0


def nccl_calibrate(rank: int, world: int, comm, grid) -> None:
    """The NVLink half of the calibration: neighbour shifts over the
    whole NCCL world (``measure_ppermute``), then ``calibrate(grid=)``
    over every axis of the grid (a ("data",) grid of the world below 4
    cards), persisted in the phase's cache (``REPRO_TORCH_CACHE_DIR``,
    set by :func:`nccl_phase`); rank 0 prints the shifts, the fitted
    constants and auto's allreduce picks, stock and fitted."""
    shifts = measure_ppermute(comm, CALIBRATE_BYTES, CALIBRATE_REPEATS)
    if grid is None:
        grid = ProcessGroupGrid((world,), ("data",), device=comm.device)
    cal = CollectiveEngine(device=comm.device)
    topo = cal.calibrate(grid=grid, sizes_bytes=CALIBRATE_BYTES)
    stock = CollectiveEngine(device=comm.device, persist=False)
    fab = topo.for_axis(grid.axis_names[-1])
    picks = [f"{nb >> 10} KB {stock.select('allreduce', nb, world).algorithm}"
             f" -> {cal.select('allreduce', nb, world, fabric=fab).algorithm}"
             for nb in AUTO_BYTES]
    cal.flush()
    if rank == 0:
        print(f"nccl calibrate: {world} ProcessGroupComm ranks, one a card: "
              f"neighbour shifts (the slowest rank's best of "
              f"{CALIBRATE_REPEATS}) " + ", ".join(
                  f"{nb >> 10} KB {t * 1e6:.2f} us" for nb, t in shifts)
              + " | fitted " + "; ".join(
                  f"{a!r}: t_r {f.t_r:.6g}, link_bw {f.link_bw:.6g}"
                  for a, f in topo.axis_fabrics)
              + f" ({topo.name}, NVLink through NCCL) | auto allreduce P "
              f"{world}, stock -> fitted: " + ", ".join(picks), flush=True)


def nccl_phase(seed: int) -> None:
    cards = torch.cuda.device_count()
    if cards < 2:
        log(f"nccl phase: not run ({cards} card); nor the 2D allreduce_multi "
            f"over a 2x2 ProcessGroupGrid (needs 4 cards), nor the DP "
            f"and MoE EP trainers under torchrun (need 2); the NVLink half "
            f"of the calibration (measure_ppermute and calibrate(grid=) "
            f"over NCCL, one process a card) was not run")
        return
    world = 1 << (cards.bit_length() - 1)   # a power of two (tree, doubling)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    init = build.BUILD_DIR / f"nccl_rendezvous_{os.getpid()}"
    init.unlink(missing_ok=True)
    cal_dir = tempfile.mkdtemp(prefix="nccl_cache_", dir=build.BUILD_DIR)
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--seed", str(seed), "--nccl-worker",
         str(r), str(world), f"file://{init}"],
        env=dict(os.environ, REPRO_TORCH_CACHE_DIR=cal_dir),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    t0 = time.perf_counter()
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        init.unlink(missing_ok=True)
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"nccl rank {r} failed:\n{out[-4000:]}"
        for line in out.splitlines():
            if line.startswith(("nccl rank", "nccl calibrate")):
                log(line)
    usual = os.environ.get("REPRO_TORCH_CACHE_DIR")
    os.environ["REPRO_TORCH_CACHE_DIR"] = cal_dir
    try:
        persisted = find_calibrated_topology()
    finally:
        if usual is None:
            os.environ.pop("REPRO_TORCH_CACHE_DIR", None)
        else:
            os.environ["REPRO_TORCH_CACHE_DIR"] = usual
        shutil.rmtree(cal_dir, ignore_errors=True)
    assert persisted is not None
    log(f"nccl calibrate: the NVLink topology persisted in the phase's "
        f"cache and restores: {persisted.describe()}")
    log(f"nccl phase: {world} ProcessGroupComm ranks, one per card, passed "
        f"in {time.perf_counter() - t0:.1f} s of host wall")
    # the DP trainer as users start it: one process a card under torchrun
    root = Path(__file__).resolve().parent
    env = dict(os.environ, PYTHONPATH=str(root / "src"))
    t0 = time.perf_counter()
    # a session of its own, so that a timeout stops torchrun's workers too
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", "minicpm-2b", "--reduced", "--dp", "--grad-sync", "fsdp",
         "--steps", "2", "--batch", "4", "--seq", "64", "--log-every", "1"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=root, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    for line in out.splitlines():
        if line.startswith("[train]"):
            log(f"nccl torchrun: {line}")
    log(f"nccl phase: torchrun --nproc-per-node 2 repro_torch.launch.train "
        f"--dp --grad-sync fsdp (NCCL, one card a process) passed in "
        f"{time.perf_counter() - t0:.1f} s")
    # expert parallelism with a backward: one process a card, the
    # dispatch and combine through the engine's all-to-all over NCCL
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "repro_torch.launch.train",
         "--arch", MOE_ARCH, "--reduced", "--dp", "--moe-ep", "--steps",
         "2", "--batch", "4", "--seq", "64", "--log-every", "1"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=root, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=600)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, err[-4000:]
    assert "[moe_ep] WARNING" not in out, out[-4000:]
    per_rank = {}
    for line in out.splitlines():
        if line.startswith("[train]") or line.startswith("[moe_ep]"):
            log(f"nccl torchrun moe-ep: {line}")
        if line.startswith("[train] rank "):
            rank, _, losses = line[len("[train] rank "):].partition(
                " losses ")
            per_rank[int(rank)] = losses
    assert len(per_rank) == 2 and len(set(per_rank.values())) == 1, per_rank
    log(f"nccl phase: torchrun --nproc-per-node 2 repro_torch.launch.train "
        f"--arch {MOE_ARCH} --reduced --dp --moe-ep (EP with a backward, "
        f"NCCL) passed in {time.perf_counter() - t0:.1f} s; the loss equal "
        f"on both ranks")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--nccl-worker", nargs=3, metavar=("RANK", "WORLD",
                                                       "INIT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--lr-witness", action="store_true",
                    help="run only the dense train steps at lr 1e-3 "
                    "through the kernel and the plain attention route")
    ap.add_argument("--nccl-only", action="store_true",
                    help="run only the NCCL phase (needs 2 or more cards): "
                    "the paths that exist only across cards")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # float32 is float32
    torch.backends.cudnn.allow_tf32 = False
    if args.nccl_worker:
        rank, world, init = args.nccl_worker
        return nccl_worker(int(rank), int(world), init, args.seed)
    card = nvidia_smi()
    log(f"gpu: {card} | torch {torch.__version__} | CUDA "
        f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    built = build.build_all()
    log(f"built {sorted(built)} in {time.perf_counter() - t0:.1f} s")
    if args.lr_witness:
        dense_lr_witness(args.seed)
        return 0
    if args.nccl_only:
        if torch.cuda.device_count() < 2:
            raise SystemExit("--nccl-only needs 2 or more cards")
        nccl_phase(args.seed)
        return 0
    for res in built.values():
        entry = "?"
        for line in res.log.splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1]
            elif "registers" in line or "spill" in line:
                log(f"ptxas {res.name} {entry}: {line.strip()}")
    walls = []

    def run(name, fn, *fn_args):
        """One phase, then the card's cache emptied; its wall kept for the
        closing breakdown (the script's time limit is the whole's)."""
        t = time.perf_counter()
        out = fn(*fn_args)
        torch.cuda.empty_cache()
        walls.append((name, time.perf_counter() - t))
        return out

    seed = args.seed
    rows = {r["name"]: r for r in run(
        "kernels", lambda: [kernel_phase(seed),
                            *collective_kernel_phase(seed),
                            flash_kernel_phase(seed),
                            *scan_kernel_phase(seed)])}
    serve_out = run("serve", serve_phase, seed, rows["paged_attention"])
    run("ssm train", train_phase, seed, rows)
    run("ssm route + decode",
        lambda: (route_phase(seed), decode_phase(seed, rows)))
    run("dense train", dense_train_phase, seed, rows)
    for arch in (DENSE_ARCH, *C12_ARCHS):
        run(f"route {arch}", dense_route_phase, seed, arch)
    run("dense decode", dense_decode_phase, seed)
    run("hybrid", hybrid_phase, seed, rows)
    run("encdec", encdec_phase, seed, rows)
    run("vision", vision_phase, seed, rows)
    run("collectives", collective_phase, seed)
    run("2D collectives", collective_2d_phase, seed)
    run("fused ring", fused_phase, seed, rows)
    run("dp train", dp_train_phase, seed)
    run("tp decode", tp_decode_phase, seed)
    run("moe serve", serve_phase, seed, None, MOE_ARCH)
    run("moe train", moe_train_phase, seed)
    run(f"route {MOE_ARCH}", dense_route_phase, seed, MOE_ARCH)
    run("ep forward", ep_forward_phase, seed)
    run("dp serve", dp_serve_phase, seed)
    run("obs", obs_phase, seed)
    run("nccl", nccl_phase, seed)
    run("ckpt", ckpt_phase, seed, rows)
    run("fleet", fleet_phase, seed, rows, serve_out)
    log("phase walls: " + " | ".join(f"{name} {wall:.1f} s"
                                     for name, wall in walls))
    for r in rows.values():
        assert r["launches"] > 0 or r["name"] == "multi_add", \
            f"{r['name']} never ran on its path"
    print(json.dumps({"kernels": list(rows.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
