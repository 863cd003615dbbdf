#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py

Twenty main paths are driven: serving PromptIR (`promptir`, each block
alone, and `promptir_chained`, its level stacks chained through tail_stats
with `fused_ffn=True`), the X-Restormer family's PromptXRestormer
(`promptxrestormerir`) and PromptXRestormerEff (`promptxrestormereffir`),
both in the reference's training config, the attention-free family's
EasyPromptXRestormer (`easypromptxrestormer`), NAFNet (`nafnet`) and
NAFNetLocal (`nafnetlocal`), and the Uformer family's PromptUformerIR
(`promptuformerir`) and CAPromptUformerIR (`capromptuformerir`, CAMixer v1
routing), and the CAMixer X-Restormers in the reference's training config
(`capromptxrestormereff`, CAMixer v1; `capromptxrestormereffv2`, CAMixer
v2; `catapromptxrestormer`, CAMixer v2 and per-image hard/easy branches),
serving PromptIR through the overlap-blend tiler (`tiled`),
training PromptIR, PromptXRestormer, PromptXRestormerEff,
EasyPromptXRestormer, NAFNet, both Uformers and the three CAMixer
X-Restormers (`train`), the evaluation
entry points (`eval`: all-in-one evaluation, demo, HTTP server), the
training entry point over the all-in-one corpora through the native loader
(`train_cli`), PromptIR's data-parallel training step (`dp_train`) and its
exact H-sharded forward (`spatial`), the stochastic CAMixer models'
data-parallel training steps (`dp_train_stochastic`) and the exact
H-sharded forwards of the other eleven models (`spatial_families`). No
kernel lies on the attention-free and Uformer families'
paths: their launches are gated at 0, and their card forwards are held
against the CPU's.
Phases, each printed with the seconds since start:
  1. the card's name and power limit (nvidia-smi);
  2. the build of every kernel source (one nvcc per source, all started
     together), with ptxas register and shared memory use, and the
     tensor-core instructions (HMMA/HGMMA) of each kernel in the built
     library (cuobjdump): the bf16 tail, stats, Gram, LN+GDFN and apply
     kernels must hold some, the Gram kernel HGMMA (wgmma, WGMMA_KERNELS);
  3. each kernel against its plain PyTorch version on the card, in float32
     (TF32 off) and bfloat16: at every shape a batch-4 forward of either
     model at the serving run's 256x256 and 256x192 buckets gives it, at
     every shape of the training step (batch 6 at 128x128), and at every
     shape of phase 10's forwards (eval_forwards: B1 at the test sets'
     padded sizes for promptir and the default promptxrestormerir, the
     demo's B1 and B8 tiles, the server's B4); mdta_stats
     twice at each (the two launches bit-identical), the Gram kernel at
     every wide-route shape (in bf16 launched twice, bit-identical);
     ln_gdfn and the apply (ln_mdta) launched twice at each in bf16 (the
     two outputs bit-identical), and also at ragged shapes (B2 37x53:
     ln_gdfn at C = 96 and 704, the apply at C = 192 with 4 heads, the Gram
     at C = 160 with one head and 704 with 4); the seam bit-exact; the stats pass's scratch at
     four sizes; and the merged tail + stats kernel (tail_stats) at every
     block pair of the promptir stacks at both serving buckets and at the
     tiler's B8 128x128, against its plain version and against the
     two-kernel sequence (block_tail then mdta_stats), whose x3 it must
     equal bit for bit; LnBlock (the --fused training block) at every block
     shape of the training step in float32 and bf16: its output and its
     gradients through the kernels against the same Function on the plain
     versions;
  4. the reference's own 64 px outputs reproduced in float32 through the
     kernels: full-depth PromptIR (tests/goldens/promptir_full.npz) block
     by block and with fused_ffn=True (through tail_stats), and
     one-block-a-level PromptXRestormer (prompt_xrestormer_small.npz) and
     embed-8 one-block-a-stage PromptUformerIR without prompts
     (uformer_small.npz, no launch), with TF32 off (as the engine and trainer run float32) and, printed
     only, with PyTorch's defaults; then full-depth PromptIR's bf16 B4
     256x256 forward through the kernels against the same forward through
     the plain versions (FORWARD_TOL_BF16);
  5. each serving path at full width (random weights from a seed, bf16)
     serving eight requests through the port's engine, with the kernels'
     launch counts set to 0 just before each run and read just after;
     promptxrestormereffir's fp32 forward (TF32 off) through the kernels
     against the plain versions (GOLDEN_TOL); the attention-free family's
     reduced fp32 forwards (TF32 off) on the card against the same forwards
     on the CPU (GOLDEN_TOL; NAFNetLocal with windows smaller than its
     maps), and so the Uformer family's (embed 8, one block a stage,
     prompts on; CAPromptUformerIR at ratio 1, where its routing is
     exact), its forward at ratio 0.5 keeping max(1, round(N / 2))
     windows an image in each mixer; the Uformers served at pad base 128
     (a 250x190 request padded to 256x256), with a profiler window each
     as the attention-free family's; NAFNetLocal on NAFNet's weights:
     bit-equal to it at 256x256, not at 512x768, one 512x768 request
     served and timed; the CAMixer X-Restormers served at pad base 64 with
     a profiler window each, their reduced fp32 forwards through the
     kernels (ratio and hard ratio 1, where routing is exact) against the
     CPU's through the plain versions (GOLDEN_TOL), and reduced CATA at
     ratio and hard ratio 0.5 keeping max(1, round(N / 2)) windows an image
     in each v2 mixer and 2 of 4 images in each branch selector; then
     full-depth PromptIR serving two 1024x768 photographs through the
     engine's tiled path (128 px tiles, overlap 32, 8 a chunk: 88 tiles in
     11 forwards an image), in float32 against the same run through the
     plain versions, and in bf16 for its latency and throughput;
  6. a reduced PromptIR's training gradients through the kernels against
     the same step through the plain versions, on the card;
  7. full-depth PromptIR training: AdamW steps on one fixed batch of six
     128x128 synthetic patches in float32 (TF32 off) and in bf16 compute
     with float32 weights; launches per step, the loss, step time and peak
     memory; then the bf16-computing model served through the engine, its
     GDFN weights packed in the first forward only; then full-depth
     promptxrestormerir in its training config, bf16 compute, the same
     steps (its loss must fall too), promptxrestormereffir in the same
     config, the default easypromptxrestormer, nafnet,
     promptuformerir and capromptuformerir (no launch; the last with its
     Gumbel routing, its ratio term and mean decision printed), and the
     three CAMixer X-Restormers in the training config (their kernel
     launches a step gated, their ratio and hard-ratio terms printed), the
     same steps; and the JAX trainer's modes (TRAIN_MODES): promptir with
     fused_ffn (LnBlock a block), remat and remat_levels (1, 2), and
     promptxrestormerir with fused_ffn, bf16, exact launches a step, each
     second step's loss held to its default route's (GRAD_TOL; a stale
     bf16 copy of a weight would leave it at the first step's), step ms and
     peak memory beside the default's; then CAMixer v1
     (capromptxrestormereff, check_ca_v1): the bf16 weight gradient of its
     dilated depthwise conv_sptial.1 against the fp32 one at each level's
     B6 size (DILATED_TOL), and its bf16 step twice from one seed under the
     default algorithms and twice under torch.use_deterministic_algorithms
     (warn_only): whether each pair is bit-equal, which gradients differ,
     and the ops PyTorch warns about;
  8. the training demo (promptir_tpu_torch/cli/train_demo.py) at reduced
     depth for 3 epochs on 48 images: the held-out PSNR must rise;
  9. each kernel timed with CUDA events beside its plain version, the one
     PyTorch call that computes the same function where there is one, and
     its bound, at every shape of a 256x256 serving forward of each model
     (promptxrestormereffir's shapes are promptxrestormerir's: their
     times are read again, not retaken), of the training forward and of the
     tiled path's chunk; ln_gdfn and the
     apply per shape with their plans and, beside the wrappers' CUDA-event
     time, their device time from a short torch.profiler window over the
     same launches; mdta_stats per
     shape with its route and tile, block_tail per shape with its tile, the
     Gram kernel at the wide shapes beside one torch.matmul of the same q
     and k, each also as a profiler window's device time, its tiles,
     slices and clusters, and whether its time a forward of each path is
     at most the matmul's; tail_stats at every block pair of the
     promptir stacks at B4 256x256 and B8 128x128, with its tile, beside
     the two-kernel sequence it replaces, and the chained route's decision
     (CHAIN_RATIO, CHAIN_FORWARD_MS); block_tail also at the --fused
     training forward's shapes (B6 128x128), with its bound;
 10. the user-facing inference surface on a synthetic PNG corpus at the
     all-in-one test sets' sizes (BSD68 481x321 and 321x481, Rain100L,
     SOTS outdoor 550x413; the targets written by the port's save_image,
     the rest with every PNG row filter, each read back bit for bit by the
     C++ reader and the plain one, both timed), with seed-0 full-depth promptir
     weights saved as a Lightning .ckpt: cli/test.py --mode 3 in fp32
     through the kernels (10 forwards, exact launches), cli/psnr.py on its
     dumped sigma-15 PNGs, the same run in bf16 timed, --mode 1 with
     promptxrestormerir (ln_gdfn on the path), --mode 1 bf16 with
     easypromptxrestormer, nafnet, promptuformerir and capromptuformerir
     (no launch; the Uformers with --pad_base 128: 384x512), --mode 1 bf16
     with the three CAMixer X-Restormers (default config, pad base 64,
     their launches a forward counted from the model), NIQE on the host
     (cli/fit_niqe.py on clean PNGs; a clean image scored below its
     sigma = 50 copy; compute_niqe of the restored images, timed),
     cli/demo.py plain and tiled,
     and cli/serve.py's HTTP server answering two PNG requests; each run
     held against the same run through the plain route (forward by
     forward, or on the uint8 images it writes);
 11. the training entry point (promptir_tpu_torch/cli/train.py) over a
     corpus of the five tasks in the reference's layout: two denoise images
     at 481x321 (a PNG of every row filter, a BMP), one rain pair as such
     PNGs, the committed 550x413 JPEG haze pair (139 samples, 23 steps of
     B6 128x128), through the native loader (the default: the C++ PNG
     reader and the fused crop, dihedral and noise); full-depth promptir in
     bf16 for one epoch with the
     epoch-end evaluation (a two-image BSD68-like and a one-pair
     Rain100L-like set) and the profiler window, then `--epochs 2 --resume
     latest`; exact launches per step, finite losses, a checkpoint an
     epoch, the evaluation's metrics logged; the step's ms and images/s
     beside the images/s end to end, the host's wait between steps and the
     profiler's trace export, the loader alone over an epoch (samples/s,
     split by task), each sample's time in the loader's threads during
     training and alone (and alone on the numpy path), and whether the
     loader keeps up; the host's decode of a JPEG and a BMP; every
     committed JPEG fixture decoded bit for bit as the PIL decode stored
     beside it, every PNG of the corpus by the C++ reader as by the plain
     one, and the native samples' crops and dihedrals as numpy's; then
     cli/train.py --synthetic for one epoch with --fused and with --remat
     --remat_levels 1 2 (TRAIN_CLI_MODES), exact launches a step;
 12. the instruments (promptir_tpu_torch/tools/, cli/summary.py,
     cli/convert.py), each run in this process, its JSON lines printed
     indented: cli.summary of promptir at B1 256x256 (35,592,263
     parameters, 16 times the 64x64 FLOP count, a peak memory), kbench of
     each kernel at one main-path shape (KBENCH), profile_forward (the
     B4 256x256 bf16 forward by module; its ranges must hold SPLIT_SHARE of
     the device time, the kernels' launches attributed by correlation id),
     profile_train in the default and the --fused mode (the bf16 B6 128x128
     step split into the forward's kernels and other ops, the backward, the
     optimizer and the idle card; the ranges must hold SPLIT_SHARE of the
     device time and the forward SPLIT_SHARE of the kernels'), tbench at B6
     128x128 (the loss must fall), sbench for 10 s (no request shed or
     timed out), shape_sweep over its grid (every kernel call within TOL of
     its plain version, the seam bit-exact, each forward within the plain
     route's gates), cli.convert of the seed-0 .ckpt (its .npz read back bit
     for bit), and OPTION_CHECKS: promptir with use_bias and the
     X-Restormer with use_bias and scale 2 on the card against the CPU, no
     launch;
 13. the port's parallel code (promptir_tpu_torch/parallel/) on the one
     card, in spawned ranks (parallel/mesh.py:launch; the kernels built by
     this process first): (a) a world of one over NCCL, the data-parallel
     step of full-depth promptir (bf16, B6 128x128, DP_STEPS steps) bit-equal
     to the same steps without a group, 47/0/47/1/47/0/2 launches a step;
     (b) two ranks sharing cuda:0 over gloo (NCCL refuses two ranks on one
     card; all_reduce and broadcast are the collectives gloo takes on CUDA
     tensors, and the port's all go through them): a broadcast from rank 0,
     the fp32 DP step (B3 a rank) against the one-process B6 step
     (GRAD_TOL), the exact H-sharded fp32 forward of full-depth promptir at
     SPATIAL_HW against the unsharded forward through the kernels
     (GOLDEN_TOL of max |ref|; the block kernels off, the seam once), two
     TILED_HW photographs through the tiler with the group against the
     one-process tiler (GOLDEN_TOL), and tensor-parallel GDFN and MDTA
     (TP_CASES) against their modules (GOLDEN_TOL); the steps' ms, the
     forward's ms and its all_reduce bytes, and the backend of each;
     (c) on the two ranks, the exact H-sharded fp32 forward of each of the
     other eleven models (SPATIAL_FAMILIES: full width and depth, B1
     SPATIAL_HW) against its unsharded card forward (GOLDEN_TOL of max
     |ref|), no launch, the windows each CAMixer call keeps and the images
     each selector call picks equal to the unsharded forward's; (d) the
     stochastic CAMixer models in their training config (STOCHASTIC): in
     the NCCL world of one, bf16 B6 128x128, DP_STEPS steps bit-equal to the
     steps without a group under torch.use_deterministic_algorithms, phase
     7's launches a step; on the two ranks the fp32 step, B3 a rank,
     against the one-process B6 step on the one-process step's side of
     every kink (tools/parity.py:Kinks): each tensor's gradient within
     GRAD_TOL of its own max (parity.grad_errors), the whole gradient
     within GRAD_TOL, relative, and the gradient at each mask and each
     selector's labels within GRAD_TOL (parity.tap_errors); the same step
     without the forcing beside it, every element it puts on another side
     of a kink lying within KINK_NEAR of the kink, and a tensor past
     GRAD_TOL there only with such an element (deterministic algorithms,
     so that each run repeats the last's); the windows and images routed
     equal, CATA's selectors picking one image of the global batch each,
     over both ranks.
     Two ranks on one card measure the collective code's cost, not scaling.
It ends with one JSON line of kernel records and, as the last line, the
device record. Any failure raises and exits non-zero before those lines.

    python3 chip_smoke.py --bf16-forward

builds the kernels and runs phase 4's bf16 forward check only, and takes
the port from the script's own directory: copied into a checkout of an
earlier commit, it reads that commit's kernels against its plain versions
(phases 3, 5, 6, 9 and 12 import promptir_tpu_torch/tools/ where they run).
Imports torch, numpy, the standard library and promptir_tpu_torch only.
"""

from __future__ import annotations

import contextlib
import ctypes
import gc
import json
import math
import os
import pathlib
import re
import shutil
import struct
import subprocess
import sys
import time
import zlib
from types import SimpleNamespace
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

ROOT = pathlib.Path(__file__).resolve().parent
T0 = time.perf_counter()

BUCKETS = [(256, 256), (256, 192)]  # the serving run's padded sizes


def block_shapes(h, w):
    """(H, W, C, heads) of the 47 TransformerBlocks of an h x w forward,
    with how many blocks run at each."""
    return [
        ((h, w, 48, 1), 4),                  # encoder_level1
        ((h // 2, w // 2, 96, 2), 12),       # encoder_level2, decoder_level2
        ((h // 4, w // 4, 192, 4), 12),      # encoder_level3, decoder_level3
        ((h // 8, w // 8, 384, 8), 8),       # latent
        ((h // 8, w // 8, 704, 4), 1),       # noise_level3
        ((h // 4, w // 4, 320, 4), 1),       # noise_level2
        ((h // 2, w // 2, 160, 4), 1),       # noise_level1
        ((h, w, 96, 1), 8),                  # decoder_level1, refinement
    ]


def xr_block_shapes(h, w):
    """(H, W, C, heads) of the 31 X-blocks of an h x w promptxrestormerir
    forward (training config: one channel head, so d = C), with how many
    blocks run at each; each X-block runs mdta_stats, block_tail and
    ln_gdfn once."""
    return [
        ((h, w, 48, 1), 2),                  # encoder_level1
        ((h // 2, w // 2, 96, 1), 8),        # encoder_level2, decoder_level2
        ((h // 4, w // 4, 192, 1), 8),       # encoder_level3, decoder_level3
        ((h // 8, w // 8, 384, 1), 4),       # latent
        ((h // 8, w // 8, 704, 1), 1),       # prompt3
        ((h // 4, w // 4, 320, 1), 1),       # prompt2
        ((h // 2, w // 2, 160, 1), 1),       # prompt1
        ((h, w, 96, 1), 6),                  # decoder_level1, refinement
    ]


def xr_eval_block_shapes(h, w):
    """(H, W, C, heads) of the 47 X-blocks of an h x w forward of the
    default promptxrestormerir (the CLIs' config: num_blocks (4, 6, 6, 8),
    4 refinement blocks, channel heads (1, 2, 4, 8), the prompt blocks one
    head), with how many blocks run at each."""
    return [
        ((h, w, 48, 1), 4),                  # encoder_level1
        ((h // 2, w // 2, 96, 2), 12),       # encoder_level2, decoder_level2
        ((h // 4, w // 4, 192, 4), 12),      # encoder_level3, decoder_level3
        ((h // 8, w // 8, 384, 8), 8),       # latent
        ((h // 8, w // 8, 704, 1), 1),       # prompt3
        ((h // 4, w // 4, 320, 1), 1),       # prompt2
        ((h // 2, w // 2, 160, 1), 1),       # prompt1
        ((h, w, 96, 1), 8),                  # decoder_level1, refinement
    ]


def eff_block_shapes(h, w):
    """(H, W, C, heads) of the 31 blocks of an h x w promptxrestormereffir
    forward (training config), with how many blocks run at each and the
    kernels each runs: the 28 X-blocks mdta_stats, block_tail and ln_gdfn
    (their spatial FFN), the 3 channel blocks of the prompt interaction
    (704, 320 and 160 channels, one head) mdta_stats and block_tail."""
    xblock = ("mdta_stats", "block_tail", "ln_gdfn")
    return [(s, n, xblock) for s, n in xr_block_shapes(h, w)
            if s[2] not in (704, 320, 160)] + [
        (s, n, xblock[:2]) for s, n in xr_block_shapes(h, w)
        if s[2] in (704, 320, 160)]


# the reference's training config of promptxrestormerir and
# promptxrestormereffir (tests/goldens/sd_keys_promptxrestormerir.json,
# sd_keys_promptxrestormereffir.json)
XR_TRAIN = dict(num_blocks=(2, 4, 4, 4), num_refinement_blocks=4,
                channel_heads=(1, 1, 1, 1), spatial_heads=(1, 2, 4, 8))
EFF = "promptxrestormereffir"
KERNELS = ("mdta_stats", "block_tail", "ln_gdfn", "seam", "ln_mdta",
           "tail_stats", "mdta_gram")
LAUNCH_NAMES = "/".join(KERNELS)
PATHS = {
    # name: (model, its kwargs, launches of each of KERNELS per serving
    # forward):
    # promptir's 47 blocks each run mdta_stats then block_tail, the Gram
    # kernel at the two wide noise_level widths (C 704 and 320, 4 heads);
    # with fused_ffn=True its 44 stacked blocks run chained (8 stacks: 8
    # mdta_stats, 36 tail_stats, 8 block_tail), its 3 noise_level blocks
    # alone; promptxrestormerir's one-head widths from 160 take the Gram
    # kernel (15 of its 31 blocks); promptxrestormereffir's 28 X-blocks run
    # ln_gdfn too, its 3 channel blocks not, at the same widths (15 wide;
    # tests/test_torch_prompt_xrestormer_eff.py counts them on the CPU)
    "promptir": ("promptir", {}, [47, 47, 0, 1, 0, 0, 2]),
    "promptxrestormerir": ("promptxrestormerir", XR_TRAIN,
                           [31, 31, 31, 0, 0, 0, 15]),
    EFF: (EFF, XR_TRAIN, [31, 31, 28, 0, 0, 0, 15]),
    "promptir_chained": ("promptir", dict(fused_ffn=True),
                         [11, 11, 0, 1, 0, 36, 2]),
    # the attention-free family's default configs: no kernel on their path
    # (convolutions, LayerNorms, gates and means; tests/test_torch_easy.py
    # and test_torch_nafnet.py show no wrapper runs on the CPU)
    "easypromptxrestormer": ("easypromptxrestormer", {}, [0] * 7),
    "nafnet": ("nafnet", {}, [0] * 7),
    # the Uformer family's default configs: window attention and CAMixer v1
    # in plain PyTorch (tests/test_torch_uformer.py shows no wrapper runs)
    "promptuformerir": ("promptuformerir", {}, [0] * 7),
    "capromptuformerir": ("capromptuformerir", {}, [0] * 7),
    # the CAMixer X-Restormers in the reference's training config: v1's and
    # v2's 28 CA blocks run mdta_stats, block_tail and ln_gdfn (the spatial
    # FFN), their 3 channel prompt blocks mdta_stats and block_tail, 15 on
    # the wide route, Eff's pattern; CATA's 28 hard branches run for every
    # image, its Easy prompt blocks no kernel (12 wide). The mixers and the
    # Easy branch are plain PyTorch (tests/test_torch_ca_xrestormer.py and
    # test_torch_cata.py count the launches on the CPU)
    "capromptxrestormereff": ("capromptxrestormereff", XR_TRAIN,
                              [31, 31, 28, 0, 0, 0, 15]),
    "capromptxrestormereffv2": ("capromptxrestormereffv2", XR_TRAIN,
                                [31, 31, 28, 0, 0, 0, 15]),
    "catapromptxrestormer": ("catapromptxrestormer", XR_TRAIN,
                             [28, 28, 28, 0, 0, 0, 12]),
}
ATTENTION_FREE = ("easypromptxrestormer", "nafnet")
UFORMER = ("promptuformerir", "capromptuformerir")
NO_KERNEL = ATTENTION_FREE + UFORMER
CA_XR = ("capromptxrestormereff", "capromptxrestormereffv2",
         "catapromptxrestormer")
# calls in a forward_breakdown window: the profiler's processing of its
# records takes most of a window's time, ~20 s for 10 calls of the CA model
# (~15,300 kernels a call; PERF.md)
BREAKDOWN_REPS = {"promptuformerir": 5, "capromptuformerir": 3,
                  **{name: 3 for name in CA_XR}}
# the Uformer family cut to embed 8 and one block a stage (prompts on)
UFORMER_REDUCED = dict(embed_dim=8, depths=(1,) * 9)
# NAFNetLocal's default TLC windows (384 px at level 0) cover a 256x256
# map at every level, so there it equals NAFNet bit for bit; a 512x768
# photograph takes the local pool
TLC_SAME_HW, TLC_LOCAL_HW = (256, 256), (512, 768)
GOLDENS = [
    # (file, model, kwargs, launches per forward)
    ("promptir_full.npz", "promptir", {}, [47, 47, 0, 1, 0, 0, 2]),
    ("promptir_full.npz", "promptir", dict(fused_ffn=True),
     [11, 11, 0, 1, 0, 36, 2]),
    ("prompt_xrestormer_small.npz", "promptxrestormerir",
     dict(num_blocks=(1, 1, 1, 1), num_refinement_blocks=1),
     [11, 11, 11, 0, 0, 0, 3]),
    ("uformer_small.npz", "promptuformerir",
     dict(prompt=False, modulator=True, **UFORMER_REDUCED), [0] * 7),
]
# the engine's tiled path: 1024x768 photographs in 128 px tiles overlapping
# by 32, 8 tiles a forward: 11 x 8 = 88 tiles, 11 forwards an image
TILED_HW = (1024, 768)
TILE, TILE_OVERLAP, TILE_CHUNK = 128, 32, 8
TILED_FORWARDS = 11
BATCH = 4
# the training step: the reference's per-GPU batch and patch size
# (promptir_tpu/config.py: TrainConfig.batch_size, DataConfig.patch_size)
TRAIN_BATCH, TRAIN_HW = 6, (128, 128)
TRAIN_PER_STEP = [47, 0, 47, 1, 47, 0, 2]  # launches of one step's forward
# promptxrestormerir's 31 X-blocks under autograd: LnMdta (stats, apply) and
# the channel FFN's LnGdfn, then the spatial FFN's LnGdfn; 15 on the wide
# route (PATHS)
XR_TRAIN_PER_STEP = [31, 0, 62, 0, 31, 0, 15]
# promptxrestormereffir's 28 X-blocks as above, its 3 channel blocks LnMdta
# and one LnGdfn each; so the CAMixer v1 and v2 models; CATA's 28 hard
# branches LnGdfn, LnMdta and LnGdfn, its Easy prompt blocks nothing
EFF_TRAIN_PER_STEP = [31, 0, 59, 0, 31, 0, 15]
# the JAX trainer's --fused and --remat modes (promptir_tpu/cli/train.py):
# (label, model, kwargs, launches a step, the default run it is held to).
# fused_ffn trains each block as one LnBlock: mdta_stats and block_tail
# forward, no kernel in its backward (promptir 47 blocks; promptxrestormerir
# 31 channel halves, its 31 spatial FFNs LnGdfn); remat checkpoints each
# block, whose LnMdta and LnGdfn run again in the backward (94 = 2 x 47);
# remat_levels (1, 2) only the 25 blocks at widths d and 2d (72 = 47 + 25;
# the Gram kernel's two wide noise blocks are levels 4 and 3). The modes
# count from the model on the CPU as tests/test_torch_fused_train.py does.
TRAIN_MODES = [
    ("fused", "promptir", dict(fused_ffn=True), [47, 47, 0, 1, 0, 0, 2],
     "promptir"),
    ("remat", "promptir", dict(remat=True), [94, 0, 94, 1, 94, 0, 4],
     "promptir"),
    ("remat_levels 1 2", "promptir", dict(remat=True, remat_levels=(1, 2)),
     [72, 0, 72, 1, 72, 0, 2], "promptir"),
    ("fused", "promptxrestormerir", dict(XR_TRAIN, fused_ffn=True),
     [31, 31, 31, 0, 0, 0, 15], "promptxrestormerir"),
]
CA_TRAIN_PER_STEP = {"capromptxrestormereff": EFF_TRAIN_PER_STEP,
                     "capromptxrestormereffv2": EFF_TRAIN_PER_STEP,
                     "catapromptxrestormer": [28, 0, 56, 0, 28, 0, 12]}
# per run; the warm-up steps are untimed. Four steps are too few for the
# loss to fall: AdamW's first steps overshoot (promptxrestormereffir's
# loss went 0.33861, 0.39534, 0.33852, 0.34022 on an H100; PERF.md)
TRAIN_STEPS, TRAIN_WARMUP = 6, 2
REDUCED = dict(num_blocks=(1, 1, 1, 1), num_refinement_blocks=1)
# the attention-free family's card forwards against the CPU's, fp32 (TF32
# off), one block a stage, beta and gamma seeded away from their init's 0:
# name: (kwargs, input shape); nafnetlocal with TLC windows smaller than
# its maps (tlc_train_size 32: 48, 24, 12, 6 and 3 px a level)
NAF_REDUCED = dict(middle_blk_num=1, enc_blk_nums=(1, 1, 1, 1),
                   dec_blk_nums=(1, 1, 1, 1))
CPU_CHECKS = {
    "easypromptxrestormer": (REDUCED, (2, 3, 64, 96)),
    "nafnet": (NAF_REDUCED, (2, 3, 72, 100)),
    "nafnetlocal": (dict(tlc_train_size=(32, 32), **NAF_REDUCED),
                    (2, 3, 72, 100)),
    "promptuformerir": (UFORMER_REDUCED, (2, 3, 128, 256)),
    "capromptuformerir": (dict(ratio=1.0, **UFORMER_REDUCED), (2, 3, 128, 256)),
}
# the CAMixer X-Restormers' card forwards (through the kernels) against the
# CPU's (the plain versions), fp32 (TF32 off): the training config's heads,
# one block a level, prompts on, at ratio and hard ratio 1, where routing is
# exact: (input shape, launches per forward); CATA's hard branches at 8
# blocks, the 3 one-head widths from 192 on the wide route
CA_REDUCED = dict(XR_TRAIN, **REDUCED)
CA_CHECKS = {"capromptxrestormereff": ((2, 3, 64, 128), [11, 11, 8, 0, 0, 0, 6]),
             "capromptxrestormereffv2": ((2, 3, 64, 128),
                                         [11, 11, 8, 0, 0, 0, 6]),
             "catapromptxrestormer": ((2, 3, 64, 128), [8, 8, 8, 0, 0, 0, 3])}
DEMO = dict(epochs=3, n_train=48, batch=4, patch=128)  # TRAIN_DEMO.md's short run
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # max |kernel - plain| / max |plain|
GOLDEN_TOL = 2e-4
# full-depth promptir B4 256x256 bf16 through the kernels against the same
# forward through the plain versions: max |difference| of the output. Twice
# the 7.8125e-3 that the kernels gave before their bf16 products moved to
# the tensor cores (`--bf16-forward` on that commit; PERF.md, section 6)
FORWARD_TOL_BF16 = 1.5625e-2
# the bf16 kernels that must hold tensor-core instructions (HMMA or HGMMA):
# tail_stats's three kernels (tail_a's, the merged one), block_tail's two,
# mdta_stats' stats pass and its Gram kernel, ln_gdfn's one pass and the
# apply's
TENSOR_CORE_KERNELS = ("tail_a_tc_kernel", "tail_stats_tc_kernel",
                       "gdfn_out_tc_kernel", "stats_tc_kernel", "gram_tc_kernel",
                       "ln_gdfn_tc_kernel", "mdta_apply_tc_kernel")
# the kernels whose tensor-core instructions must include wgmma's (HGMMA):
# the wide route's bf16 Gram (csrc/mdta_gram.cu)
WGMMA_KERNELS = ("gram_tc_kernel",)
# phase 3's ragged shapes (H and W multiples of no tile), batch 2: (shape,
# kernel checked beside mdta_stats); the Gram's at the one-head C = 160
# (d = 160) and at C = 704 over 4 heads (d = 176)
RAGGED = [((37, 53, 96, 1), "ln_gdfn"), ((37, 53, 704, 1), "ln_gdfn"),
          ((37, 53, 192, 4), "ln_mdta"), ((37, 53, 160, 1), "mdta_gram"),
          ((37, 53, 704, 4), "mdta_gram")]
# kernels launched twice at every bf16 check, the two outputs bit-identical
TWICE = ("ln_gdfn", "ln_mdta")
# the chained route (PromptIR's fused_ffn) stays off by default unless
# tail_stats takes at most CHAIN_RATIO of block_tail + mdta_stats at every
# chain shape and at most CHAIN_FORWARD_MS a bf16 promptir B4 256x256 forward
# (ROADMAP.md, Redesign order, item 1)
CHAIN_RATIO, CHAIN_FORWARD_MS = 0.9, 32.0
# kernel-route gradients against plain-route gradients, float32 (TF32 off):
# max |difference| over max |plain| of each parameter's gradient
GRAD_TOL = 1e-3
# phase 10's corpus, (H, W): BSD68's landscape and portrait (Rain100L's
# pairs take the landscape) and SOTS outdoor; mode 3 runs 3 sigmas x 2 + 2
# derain + 2 dehaze forwards
EVAL_BSD = [(321, 481), (481, 321)]
EVAL_SOTS = (413, 550)
EVAL_FORWARDS = 10
# phase 11's corpus: two denoise images and one rain pair at BSD68's size,
# the committed 550x413 JPEG haze pair: 2 x 9 + 120 + 1 samples, 23 steps
# of B6 an epoch
TRAIN_CLI_HW = (321, 481)
TRAIN_CLI_SAMPLES = 2 * 9 + 120 + 1
TRAIN_CLI_STEPS = TRAIN_CLI_SAMPLES // TRAIN_BATCH
# phase 11's runs of the JAX trainer's memory flags: (label, flags,
# launches a step), the counts of TRAIN_MODES
TRAIN_CLI_MODES = [("fused", ["--fused"], [47, 47, 0, 1, 0, 0, 2]),
                   ("remat_levels 1 2", ["--remat", "--remat_levels", "1", "2"],
                    [72, 0, 72, 1, 72, 0, 2])]
JPEG_FIXTURES = ROOT / "tests" / "torch_fixtures" / "jpeg"
# phase 12's reduced option models on the card against the CPU (GOLDEN_TOL),
# no launch: label: (model, kwargs, input shape); the X-Restormer's 32x64
# input upscaled x2 to 64x128 (its windows tile the 1/8 level)
OPTION_CHECKS = {
    "promptir use_bias": ("promptir", dict(REDUCED, use_bias=True),
                          (2, 3, 64, 96)),
    "xrestormerir use_bias scale 2": (
        "xrestormerir", dict(XR_TRAIN, **REDUCED, use_bias=True, scale=2),
        (2, 3, 32, 64)),
}
# phase 12's kbench runs: (op, B H W C, heads), each at a shape of a main
# path: promptir's level 1 at B4 256x256 (stats, tail, seam, the chain), its
# noise_level3 (the Gram stage), the X-Restormer's level 2 (ln_gdfn), the
# training forward's level 1 (the apply)
KBENCH = [("mdta_stats", (4, 256, 256, 48), 1),
          ("block_tail", (4, 256, 256, 48), 1),
          ("seam", (4, 256, 256, 48), 1), ("tail_stats", (4, 256, 256, 48), 1),
          ("mdta_gram", (4, 32, 32, 704), 4), ("ln_gdfn", (4, 128, 128, 96), 1),
          ("ln_mdta", (6, 128, 128, 48), 1)]
# the split's gates: the step's ranges hold this share of its device time,
# and its forward this share of the port's kernels' time
SPLIT_SHARE = 0.98
PROMPTIR_PARAMS = 35_592_263
# every image's PSNR (dB) and SSIM through the kernels against the plain
# route, fp32; the offline PSNR of the dumped (truncated uint8) PNGs against
# the runner's float PSNR
EVAL_PSNR_TOL, EVAL_SSIM_TOL, EVAL_OFFLINE_TOL = 1e-3, 1e-5, 0.05
# each forward of the evaluation runs through the kernels against the same
# run through the plain route: fp32 max |difference| over max |plain| as the
# goldens (GOLDEN_TOL); bf16 max |difference| FORWARD_TOL_BF16, which on the
# uint8 images that the demo writes (truncated) and the server returns
# (rounded) allows ceil(FORWARD_TOL_BF16 * 255) steps
EVAL_STEPS_BF16 = math.ceil(FORWARD_TOL_BF16 * 255)
# a bf16 evaluation through the kernels and the same evaluation through the
# plain route, each against the fp32 evaluation of the same images through
# the kernels: the kernels' max and mean |difference| at most these
# multiples of the plain route's (the kernels no less exact than the plain
# bf16 composition). FORWARD_TOL_BF16 holds PromptIR's two bf16 routes
# together; the default promptxrestormerir's 47 X-blocks (OCAB in plain
# bf16 between the kernels) leave them ~2e-2 apart while each lies ~3e-2
# from fp32 with equal means
BF16_MAX_RATIO, BF16_MEAN_RATIO = 1.25, 1.05


def say(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f}s] {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: {msg}")


# ------------------------------------------------------------------ setup

def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def import_port():
    sys.path.insert(0, str(ROOT))
    import promptir_tpu_torch

    if pathlib.Path(promptir_tpu_torch.__file__).resolve().parent.parent != ROOT:
        fail("promptir_tpu_torch does not come from this checkout")
    from promptir_tpu_torch.ops.cuda import (
        block,
        build,
        gdfn,
        mdta,
        megablock,
        seam,
    )

    return promptir_tpu_torch, build, mdta, block, gdfn, seam, megablock


def rel_err(a, b) -> tuple[float, float]:
    """(max |a - b|, that over max |b|)."""
    a, b = a.float(), b.float()
    err = (a - b).abs().max().item()
    return err, err / max(b.abs().max().item(), 1e-30)


def run_two_kernels(mdta, block, a, a2, v, attn):
    """The sequence that tail_stats replaces: block_tail, then mdta_stats on
    its output."""
    from promptir_tpu_torch.tools.kbench import run_tail
    x3 = run_tail(block.block_tail, a, v, attn)
    return (x3, *mdta.mdta_stats(x3, a2["ln1w"], a2["ln1b"], a2["wqkv"],
                                 a2["wdw"], a2["heads"]))


def chain_shapes():
    """(shape, batch, pairs a forward) of tail_stats: the block pairs of
    the promptir stacks at every serving bucket (B4 256x256 and 256x192)
    and at the tiler's B8 128x128 tile batch."""
    return ([(s, BATCH, n) for hw in BUCKETS for s, n in chain_pairs(*hw)]
            + [(s, TILE_CHUNK, n) for s, n in chain_pairs(TILE, TILE)])


def up_to(n, base):
    return -(-n // base) * base


def eval_forwards():
    """(batch, H, W, models) of phase 10's forwards: mode 3 at the crop-16
    sizes flip-padded to 64 (promptxrestormerir's mode 1 runs at Rain100L's;
    checked at all three), the demo at promptir's pad base 8 and in chunks
    of TILE_CHUNK tiles, the server's batches of BATCH (its max_batch) at
    the uncropped BSD68 sizes padded to 8."""
    crops = [(h // 16 * 16, w // 16 * 16) for h, w in EVAL_BSD + [EVAL_SOTS]]
    both = ("promptir", "promptxrestormerir")
    return ([(1, up_to(h, 64), up_to(w, 64), both) for h, w in crops]
            + [(1, up_to(h, 8), up_to(w, 8), both[:1]) for h, w in crops[:2]]
            + [(TILE_CHUNK, TILE, TILE, both[:1])]
            + [(BATCH, up_to(h, 8), up_to(w, 8), both[:1]) for h, w in EVAL_BSD])


def checked_shapes():
    """(dtype, shapes, seam size) of the kernel checks in the order their
    inputs are drawn: the serving buckets first, in the order of earlier
    runs (so their inputs repeat), then the training step's shapes, then
    phase 10's. A shape is (shape, batch, kernels checked); the training
    step's are promptir's and the X-Restormer family's (both X-Restormer
    models train at the same widths)."""
    out = []
    serving = ("mdta_stats", "block_tail")
    for dtype in (torch.float32, torch.bfloat16):
        for bh, bw in BUCKETS:
            shapes = [(s, BATCH, serving + ("ln_mdta",))
                      for s, _ in block_shapes(bh, bw)]
            shapes += [(s, BATCH, serving + ("ln_gdfn",))
                       for s, _ in xr_block_shapes(bh, bw)]
            out.append((dtype, shapes, (bh, bw, BATCH)))
    for dtype in (torch.float32, torch.bfloat16):
        shapes = [(s, TRAIN_BATCH, ("mdta_stats", "ln_mdta", "ln_gdfn"))
                  for s, _ in block_shapes(*TRAIN_HW) + xr_block_shapes(*TRAIN_HW)]
        shapes += [(s, 2, ("mdta_stats", k)) for s, k in RAGGED]
        out.append((dtype, shapes, (*TRAIN_HW, TRAIN_BATCH)))
    for dtype in (torch.float32, torch.bfloat16):
        for b, h, w, models in eval_forwards():
            shapes = [(s, b, serving) for s, _ in block_shapes(h, w)]
            if "promptxrestormerir" in models:
                shapes += [(s, b, serving + ("ln_gdfn",))
                           for s, _ in xr_eval_block_shapes(h, w)]
            out.append((dtype, shapes, (h, w, b)))
    return out


def kernel_id(mangled: str) -> str:
    """The kernel's identifier in a mangled name: the first length-prefixed
    name ending in `_kernel` (the length is the tail of a run of digits)."""
    for m in re.finditer(r"\d+", mangled):
        digits, end = m.group(), m.end()
        for i in range(len(digits)):
            n = int(digits[i:])
            if mangled[end:end + n].endswith("_kernel") and end + n <= len(mangled):
                return mangled[end:end + n]
    return mangled


def tensor_core_sass(so) -> dict:
    """Tensor-core instructions of each kernel of the built library, summed
    over its instantiations and source files, from `cuobjdump --dump-sass`:
    {kernel name: {"HMMA": count, "HGMMA": count}} (mma.sync and wgmma)."""
    cu = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([cu, "--dump-sass", str(so)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_id(m.group(1))
            counts.setdefault(name, {"HMMA": 0, "HGMMA": 0})
            continue
        m = re.search(r"\b(HG?MMA)\b", line) if name else None
        if m:
            counts[name][m.group(1)] += 1
    return counts


# ------------------------------------------------------------ phase 3

def check_kernels(mdta, block, gdfn, seam, megablock):
    from promptir_tpu_torch.tools.kbench import (
        block_inputs,
        run_apply,
        run_ln_gdfn,
        run_stats,
        run_tail,
        seam_inputs,
    )
    gen = torch.Generator(device="cuda").manual_seed(0)
    # per kernel and dtype: [max |kernel - plain|, that over max |plain|]
    worst = {k: {torch.float32: [0.0, 0.0], torch.bfloat16: [0.0, 0.0]}
             for k in KERNELS}

    def record(name, dtype, shape, e, r):
        if r > TOL[dtype]:
            fail(f"{name} disagrees with its plain version at {shape} "
                 f"{dtype}: {r:.2e} > {TOL[dtype]} of max |plain|")
        w = worst[name][dtype]
        w[0], w[1] = max(w[0], e), max(w[1], r)

    for dtype, shapes, (sh, sw, sb) in checked_shapes():
        for shape, batch, kinds in shapes:
            a = block_inputs(shape, dtype, gen, batch)
            v, st = run_stats(mdta.mdta_stats, a)
            v1, st1 = run_stats(mdta.mdta_stats, a)  # a second launch
            v0, st0 = run_stats(mdta.mdta_stats_plain, a)
            torch.cuda.synchronize()
            if not (torch.equal(st, st1) and torch.equal(v, v1)):
                fail(f"two mdta_stats launches differ at {shape} {dtype}")
            ev, rv = rel_err(v, v0)
            es, rs = rel_err(st, st0)
            record("mdta_stats", dtype, shape, ev, rv)
            record("mdta_stats", dtype, shape, es, rs)
            plan = mdta.stats_plan(batch, *shape, dtype)
            msg = (f"check {str(dtype)[6:]:8s} B{batch} {shape}: mdta_stats "
                   f"({plan.route}, tile {plan.tile[0]}x{plan.tile[1]}) v "
                   f"{ev:.2e} (rel {rv:.2e}) stats {es:.2e} (rel {rs:.2e}), "
                   "two launches bit-identical")
            if plan.route == "wide":
                # the Gram kernel alone on the stats pass's q and k (bf16:
                # launched twice, the two outputs bit-identical)
                _, q, k, _ = mdta.stats_pass_plain(
                    a["x"], a["ln1w"], a["ln1b"], a["wqkv"], a["wdw"], a["heads"])
                g = mdta.mdta_gram(q, k, a["heads"])
                g0 = mdta.mdta_gram_plain(q, k, a["heads"])
                torch.cuda.synchronize()
                e, r = rel_err(g, g0)
                record("mdta_gram", dtype, shape, e, r)
                msg += f"; mdta_gram {e:.2e} (rel {r:.2e})"
                if dtype == torch.bfloat16:
                    g1 = mdta.mdta_gram(q, k, a["heads"])
                    torch.cuda.synchronize()
                    if not torch.equal(g, g1):
                        fail(f"two mdta_gram launches differ at {shape} {dtype}")
                    p = mdta.gram_plan(batch, *shape)
                    msg += (f" ({p.tiles_m}x{p.tiles_n} tiles of {mdta.GRAM_ROWS}"
                            f"x{p.cols}, {p.slices} slices of {p.span} px, "
                            f"{p.clusters} clusters), two launches bit-identical")
            attn = mdta.attn_from_stats(st0, a["temp"])
            outs = [v]
            pairs = {  # (kernel, plain version)
                "block_tail": (lambda: run_tail(block.block_tail, a, v0, attn),
                               lambda: run_tail(block.block_tail_plain, a, v0, attn)),
                "ln_mdta": (lambda: run_apply(mdta.mdta_apply, a, v0, attn),
                            lambda: run_apply(mdta.mdta_apply_plain, a, v0, attn)),
                "ln_gdfn": (lambda: run_ln_gdfn(gdfn.ln_gdfn, a),
                            lambda: run_ln_gdfn(gdfn.ln_gdfn_plain, a)),
            }
            for k in kinds[1:]:
                if k == "mdta_gram":  # checked above, on the wide route
                    continue
                out, out0 = pairs[k][0](), pairs[k][1]()
                torch.cuda.synchronize()
                e, r = rel_err(out, out0)
                record(k, dtype, shape, e, r)
                msg += f"; {k} {e:.2e} (rel {r:.2e})"
                if dtype == torch.bfloat16 and k in TWICE:
                    out1 = pairs[k][0]()  # a second launch
                    torch.cuda.synchronize()
                    if not torch.equal(out, out1):
                        fail(f"two {k} launches differ at {shape} {dtype}")
                    msg += ", two launches bit-identical"
                outs.append(out)
            say(msg)
            if not all(torch.isfinite(t).all() for t in outs):
                fail(f"non-finite kernel output at {shape} {dtype}")
        y, skip = seam_inputs(sh, sw, dtype, gen, sb)
        out = seam.seam(y, skip)
        torch.cuda.synchronize()
        if not torch.equal(out, seam.seam_plain(y, skip)):
            fail(f"seam is not bit-exact in {dtype}")
        say(f"check {str(dtype)[6:]:8s} seam {tuple(y.shape)} + "
            f"{tuple(skip.shape)}: bit-exact")
    # the stats pass's scratch: one slot a block (and the wide route's Gram
    # slices, beside its q and k), where one partial Gram a tile went before
    for b, h, w, c, heads in [(4, 32, 32, 704, 1), (4, 128, 128, 704, 4),
                              (4, 128, 128, 704, 1), (4, 256, 256, 96, 1)]:
        d = c // heads
        plan = mdta.stats_plan(b, h, w, c, heads, torch.bfloat16)
        th, tw = plan.tile
        per_tile = 4 * b * heads * -(-h // th) * -(-w // tw) * (d * d + 2 * d)
        qk = 2 * 2 * b * h * w * c if plan.route == "wide" else 0
        say(f"mdta_stats scratch at B{b} ({h}, {w}, {c}, {heads}) bf16, "
            f"{plan.route}, tile {th}x{tw}: "
            f"{mdta.stats_partial_bytes(b, h, w, c, heads, torch.bfloat16)} "
            f"bytes of slots ({plan.nslots} an image) and Gram slices "
            f"({plan.slices}), q and k {qk} bytes (one partial Gram a tile: "
            f"{per_tile} bytes)")
    check_tail_stats(mdta, block, megablock, record)
    return worst


def check_tail_stats(mdta, block, megablock, record):
    """tail_stats against its plain version (x3, v2 and block n+1's attn
    from the stats, each gated by TOL) and against the two-kernel sequence
    on the same inputs: x3 bit for bit, the worst v2 and attn differences
    printed."""
    from promptir_tpu_torch.tools.kbench import (
        block_inputs,
        run_stats,
        run_tail_stats,
    )
    gen = torch.Generator(device="cuda").manual_seed(3)
    two = {torch.float32: [0.0, 0.0], torch.bfloat16: [0.0, 0.0]}
    for dtype in (torch.float32, torch.bfloat16):
        for shape, batch, _ in chain_shapes():
            a = block_inputs(shape, dtype, gen, batch)
            a2 = block_inputs(shape, dtype, gen, 1)  # block n+1's weights
            v, st = run_stats(mdta.mdta_stats_plain, a)
            attn = mdta.attn_from_stats(st, a["temp"])
            x3, v2, s2 = run_tail_stats(megablock.tail_stats, a, a2, v, attn)
            x30, v20, s20 = run_tail_stats(megablock.tail_stats_plain, a, a2,
                                           v, attn)
            x3b, v2b, s2b = run_two_kernels(mdta, block, a, a2, v, attn)
            torch.cuda.synchronize()
            at2, at20, at2b = (mdta.attn_from_stats(t, a2["temp"])
                               for t in (s2, s20, s2b))
            msg = f"check {str(dtype)[6:]:8s} B{batch} {shape}: tail_stats"
            for what, out, ref in [("x3", x3, x30), ("v2", v2, v20),
                                   ("attn", at2, at20)]:
                e, r = rel_err(out, ref)
                record("tail_stats", dtype, shape, e, r)
                msg += f" {what} {e:.2e} (rel {r:.2e})"
            if not torch.equal(x3, x3b):
                fail(f"tail_stats's x3 differs from block_tail's at {shape} "
                     f"{dtype}: {rel_err(x3, x3b)[0]:.2e}")
            ev, ea = rel_err(v2, v2b)[0], rel_err(at2, at2b)[0]
            w = two[dtype]
            w[0], w[1] = max(w[0], ev), max(w[1], ea)
            say(f"{msg}; against block_tail + mdta_stats: x3 bit-exact, v2 "
                f"{ev:.2e}, attn {ea:.2e}")
            if not all(torch.isfinite(t).all() for t in (x3, v2, s2)):
                fail(f"non-finite tail_stats output at {shape} {dtype}")
    for dtype, (ev, ea) in two.items():
        say(f"tail_stats against block_tail + mdta_stats, {str(dtype)[6:]}, "
            f"{len(chain_shapes())} shapes: x3 bit-exact, worst |v2 "
            f"difference| {ev:.2e}, worst |attn difference| {ea:.2e}")


# ------------------------------------------------------------ phase 4

def check_golden(port, counters, file, name, kwargs, want):
    from promptir_tpu_torch.precision import exact_float32

    data = np.load(ROOT / "tests" / "goldens" / file)
    sd = {k[4:]: torch.from_numpy(data[k].astype(np.float32))
          for k in data.files if k.startswith("sd::")}
    model = port.create_model(name, device="cuda", **kwargs)
    model.load_state_dict(sd, strict=True)
    x = torch.from_numpy(data["x"]).cuda()
    ref = torch.from_numpy(data["y"])
    before = counters()
    with torch.inference_mode(), exact_float32(torch.float32):
        y = model(x)
    torch.cuda.synchronize()
    ran = [a - b for a, b in zip(counters(), before)]
    err = (y.cpu() - ref).abs().max().item()
    # the same forward with PyTorch's defaults (cuDNN's float32 convolutions
    # in TF32): printed, not gated; the engine and trainer turn TF32 off
    with torch.inference_mode():
        err_tf32 = (model(x).cpu() - ref).abs().max().item()
    say(f"golden {file} ({name} {kwargs or ''}, {len(sd)} tensors, "
        f"{tuple(x.shape)}, fp32, "
        f"TF32 off): max |err| {err:.3e} (tolerance {GOLDEN_TOL}); launches "
        f"{LAUNCH_NAMES} {ran}; with PyTorch's TF32 defaults "
        f"(cudnn.allow_tf32 {torch.backends.cudnn.allow_tf32}) max |err| "
        f"{err_tf32:.3e}")
    if ran != want:
        fail(f"golden forward did not run through the kernels: {ran} != {want}")
    if not err <= GOLDEN_TOL:
        fail(f"golden output off by {err:.3e} > {GOLDEN_TOL}")
    del model
    return err


def check_bf16_forward(port, counters, reset):
    """Full-depth promptir (random weights from seed 0), B4 256x256 bf16:
    the served forward through the kernels against the same forward through
    the plain versions (plain_route), gated by FORWARD_TOL_BF16."""
    torch.manual_seed(0)
    model = port.create_model("promptir", device="cuda", dtype=torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(4)
    x = torch.rand(BATCH, 3, *BUCKETS[0], generator=gen, device="cuda")
    reset()
    with torch.inference_mode():
        y = model(x)
        ran = counters()
        with plain_route():
            y0 = model(x)
    torch.cuda.synchronize()
    reset()  # a comparison, not the main path
    e = (y.float() - y0.float()).abs()
    err = e.max().item()
    say(f"bf16 forward: full-depth promptir B{BATCH} {BUCKETS[0][0]}x"
        f"{BUCKETS[0][1]} through the kernels against the plain versions: max "
        f"|difference| {err:.4e} (tolerance {FORWARD_TOL_BF16}), mean "
        f"{e.mean().item():.4e}, max |plain| {y0.float().abs().max().item():.4f};"
        f" launches {LAUNCH_NAMES} {ran}")
    if ran != PATHS["promptir"][2]:
        fail(f"the bf16 forward launched {ran} != {PATHS['promptir'][2]}")
    if not torch.isfinite(y).all() or not err <= FORWARD_TOL_BF16:
        fail(f"the bf16 forward through the kernels is off by {err:.4e}")
    del model
    return err


# ------------------------------------------------------------ phase 5

def serve(port, counters, reset, card, path):
    from promptir_tpu_torch.eval.padding import pad_bases
    from promptir_tpu_torch.serve.engine import InferenceEngine
    from promptir_tpu_torch.tools.trace import (
        forward_breakdown,
        module_shares,
        time_ms,
    )

    name, kwargs, per_forward = PATHS[path]
    torch.manual_seed(0)
    model = port.create_model(name, device="cuda", dtype=torch.bfloat16,
                              **kwargs)
    n_params = sum(p.numel() for p in model.parameters())
    base = pad_bases(name)[0]
    rng = np.random.default_rng(0)
    sizes = [(256, 256)] * 6 + [(250, 190)] * 2
    imgs = [rng.random((h, w, 3), dtype=np.float32) for h, w in sizes]
    eng = InferenceEngine(model, max_batch=4, pad_base=base,
                          batch_timeout_ms=50)
    try:
        # warm-up: one forward per bucket (cuDNN plans, allocator)
        for f in [eng.submit(imgs[0]), eng.submit(imgs[-1])]:
            f.result(timeout=600)
        batches0 = eng.stats()["batches"]
        reset()
        done = {}
        t_start = time.perf_counter()
        futs = []
        for i, im in enumerate(imgs):
            f = eng.submit(im)
            f.add_done_callback(
                lambda _, i=i: done.__setitem__(i, time.perf_counter()))
            futs.append((f, time.perf_counter()))
        outs = [f.result(timeout=600) for f, _ in futs]
        t_end = max(done.values())
        ran = counters()
        batches = eng.stats()["batches"] - batches0
    finally:
        eng.close(join_timeout_s=60)
    for im, out in zip(imgs, outs):
        if out.shape != im.shape or not np.isfinite(out).all():
            fail(f"bad reply {out.shape} for a {im.shape} request")
        if out.min() < 0.0 or out.max() > 1.0:
            fail("reply outside [0, 1]")
    lat = sorted(done[i] - t for i, (_, t) in enumerate(futs))
    p50 = float(np.median(lat))
    ips = len(imgs) / (t_end - t_start)
    say(f"serve: full-width {path} ({n_params} params) bf16, pad_base {base}, "
        f"8 requests (6x 256x256, 2x 250x190) in {batches} batches of max 4; "
        f"p50 latency {p50 * 1e3:.1f} ms, {ips:.2f} images/s on {card}; "
        f"launches {LAUNCH_NAMES} {ran}")
    want = [n * batches for n in per_forward]
    if ran != want:
        fail(f"serving launches {ran} != {per_forward} per forward x {batches}")
    # one forward of a full 256x256 batch alone, against which phase 6's
    # per-forward kernel sums are read
    x = torch.from_numpy(np.stack(imgs[:4])).cuda().permute(0, 3, 1, 2)
    with torch.inference_mode():
        fwd = time_ms(lambda: model(x), reps=5, warmup=1)
    reset()  # the timing launches are not the main path's
    say(f"forward: {path} bf16 B4 256x256 alone {fwd:.1f} ms (CUDA events, "
        "median of 5)")
    if path in NO_KERNEL + CA_XR:
        with torch.inference_mode():
            say(f"forward: {path} " + forward_breakdown(
                lambda: model(x), BREAKDOWN_REPS.get(path, 10)))
            if path == "promptuformerir":
                from promptir_tpu_torch.ops import window_attention as wa

                say(f"forward: {path} " + module_shares(lambda: model(x), {
                    "window_attention": (wa.WindowAttention, "forward"),
                    "leff": (wa.LeFF, "forward"),
                    "layernorm": (wa.TorchLayerNorm, "forward")}))
        reset()
    del model, eng
    torch.cuda.empty_cache()
    return ran


def check_forward_fp32(port, counters, reset, path):
    """Full-width `path` (seed-0 weights) in float32 with TF32 off, B4
    256x256: the forward through the kernels against the same forward
    through the plain versions (plain_route), max |difference| within
    GOLDEN_TOL; the launches of one forward."""
    from promptir_tpu_torch.precision import exact_float32

    name, kwargs, per_forward = PATHS[path]
    torch.manual_seed(0)
    model = port.create_model(name, device="cuda", **kwargs)
    gen = torch.Generator(device="cuda").manual_seed(5)
    x = torch.rand(BATCH, 3, *BUCKETS[0], generator=gen, device="cuda")
    reset()
    with torch.inference_mode(), exact_float32(torch.float32):
        y = model(x)
        ran = counters()
        with plain_route():
            y0 = model(x)
    torch.cuda.synchronize()
    reset()  # a comparison, not the main path
    err = (y - y0).abs().max().item()
    say(f"fp32 forward: full-width {path} B{BATCH} {BUCKETS[0][0]}x"
        f"{BUCKETS[0][1]} (TF32 off) through the kernels against the plain "
        f"versions: max |difference| {err:.3e} (tolerance {GOLDEN_TOL}); "
        f"launches {LAUNCH_NAMES} {ran}")
    if ran != per_forward:
        fail(f"the fp32 {path} forward launched {ran} != {per_forward}")
    if not torch.isfinite(y).all() or not err <= GOLDEN_TOL:
        fail(f"the fp32 {path} forward through the kernels is off by {err:.3e}")
    del model
    torch.cuda.empty_cache()
    return err


def seeded_scales(model, seed):
    """NAFBlock's beta and gamma drawn from N(0, 0.3) (their init's 0 makes
    every block an identity), on the CPU from `seed`."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith((".beta", ".gamma")):
                p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    return model


def check_against_cpu(port, counters, reset, name, kwargs, shape):
    """The attention-free and Uformer families have no kernel on their
    paths (nor a model built with `use_bias`), so the card is held against
    the CPU: the reduced model (CPU_CHECKS, OPTION_CHECKS) from seed 0 in
    float32 with TF32 off, the same forward on the card and on the CPU, max
    |difference| within GOLDEN_TOL of max |CPU|; no launch."""
    from promptir_tpu_torch.precision import exact_float32

    torch.manual_seed(0)
    cpu = seeded_scales(port.create_model(name, device="cpu", **kwargs), 1)
    model = port.create_model(name, device="cuda", **kwargs)
    model.load_state_dict(cpu.state_dict(), strict=True)
    x = torch.rand(shape, generator=torch.Generator().manual_seed(6))
    reset()
    with torch.inference_mode(), exact_float32(torch.float32):
        y = model(x.cuda()).cpu()
        ran = counters()
        y0 = cpu(x)
    err, rel = rel_err(y, y0)
    say(f"card against CPU: reduced {name} {kwargs} fp32 (TF32 off) "
        f"B{shape[0]} {shape[2]}x{shape[3]}: max |difference| {err:.3e} (rel "
        f"{rel:.3e}, tolerance {GOLDEN_TOL}); launches {LAUNCH_NAMES} {ran}")
    if ran != [0] * len(KERNELS):
        fail(f"{name} launched {ran}: no kernel is on its path")
    if not torch.isfinite(y).all() or not rel <= GOLDEN_TOL:
        fail(f"{name}'s card forward is {rel:.3e} of max |CPU| from the CPU's")
    return rel


def kept_counts(kept, ratio, what):
    """[windows (or images) kept] of each row of each (scores, mask) pair in
    `kept`; fails unless a row keeps max(1, round(N * ratio)) of its N,
    more only where scores tie at the threshold."""
    from promptir_tpu_torch.ops.camixer import keep_count

    counts = []
    for scores, mask in kept:
        n = scores.shape[1]
        k = keep_count(n, ratio)
        for sc, m in zip(scores, mask):
            got = int(m.sum())
            counts.append(got)
            thresh = sc.sort().values[n - k]
            if got < k or (got > k and not (sc == thresh).sum() > 1):
                fail(f"{what} kept {got} of {n}, not {k}")
    return counts


def check_window_counts(port, counters, reset):
    """Reduced capromptuformerir at its ratio 0.5 (seed 0, fp32, TF32 off),
    B2 128x256 on the card: each of its 9 mixers keeps max(1, round(N / 2))
    windows of each image, more only where scores tie at the threshold; the
    same forward on the CPU printed beside it (a near tie may route a
    window differently there, so it is not gated). No launch."""
    from promptir_tpu_torch.ops import camixer
    from promptir_tpu_torch.precision import exact_float32

    kept, real = [], camixer.route_mask

    def spy(scores, ratio, deterministic, u=None):
        mask = real(scores, ratio, deterministic, u)
        kept.append((scores[:, :, 0].float().cpu(), mask[..., 0].cpu()))
        return mask

    torch.manual_seed(0)
    cpu = port.create_model("capromptuformerir", device="cpu", **UFORMER_REDUCED)
    model = port.create_model("capromptuformerir", device="cuda",
                              **UFORMER_REDUCED)
    model.load_state_dict(cpu.state_dict(), strict=True)
    x = torch.rand(2, 3, 128, 256, generator=torch.Generator().manual_seed(9))
    reset()
    with torch.inference_mode(), exact_float32(torch.float32):
        with mock.patch.object(camixer, "route_mask", spy):
            y = model(x.cuda()).cpu()
        ran = counters()
        y0 = cpu(x)
    counts = kept_counts(kept, model.ratio, "a mixer")
    err, rel = rel_err(y, y0)
    say(f"card routing: reduced capromptuformerir ratio {model.ratio} fp32 "
        f"B2 128x256, {len(kept)} mixers keep {counts} windows an image "
        f"(max(1, round(N / 2)) each); against the CPU's forward max "
        f"|difference| {err:.3e} (rel {rel:.3e}, not gated); launches "
        f"{LAUNCH_NAMES} {ran}")
    if len(kept) != 9 or ran != [0] * len(KERNELS):
        fail(f"the routing check ran {len(kept)} mixers and launched {ran}")
    if not torch.isfinite(y).all():
        fail("the ratio-0.5 forward is not finite")


def check_ca_against_cpu(port, counters, reset, name):
    """A CAMixer X-Restormer (CA_CHECKS: reduced, seed 0, ratio and hard
    ratio 1) in float32 with TF32 off: the card's forward through the kernels
    against the same forward on the CPU through the plain versions, max
    |difference| within GOLDEN_TOL of max |CPU|; the launches of one
    forward."""
    from promptir_tpu_torch.precision import exact_float32

    shape, per_forward = CA_CHECKS[name]
    kwargs = dict(CA_REDUCED, ratio=1.0, hard_ratio=1.0)
    torch.manual_seed(0)
    cpu = port.create_model(name, device="cpu", **kwargs)
    model = port.create_model(name, device="cuda", **kwargs)
    model.load_state_dict(cpu.state_dict(), strict=True)
    x = torch.rand(shape, generator=torch.Generator().manual_seed(6))
    reset()
    with torch.inference_mode(), exact_float32(torch.float32):
        y = model(x.cuda()).cpu()
        ran = counters()
        y0 = cpu(x)
    reset()  # a comparison, not the main path
    err, rel = rel_err(y, y0)
    say(f"card against CPU: reduced {name} (ratio and hard ratio 1) fp32 "
        f"(TF32 off) B{shape[0]} {shape[2]}x{shape[3]}, the card through the "
        f"kernels: max |difference| {err:.3e} (rel {rel:.3e}, tolerance "
        f"{GOLDEN_TOL}); launches {LAUNCH_NAMES} {ran}")
    if ran != per_forward:
        fail(f"the reduced {name} forward launched {ran} != {per_forward}")
    if not torch.isfinite(y).all() or not rel <= GOLDEN_TOL:
        fail(f"{name}'s card forward is {rel:.3e} of max |CPU| from the CPU's")
    return rel


def check_ca_routing(port, counters, reset):
    """Reduced catapromptxrestormer (CA_REDUCED, seed 0) at ratio and hard
    ratio 0.5, fp32 (TF32 off), B4 64x128 on the card: each of its 8 CAMixer
    v2 mixers keeps max(1, round(N / 2)) windows of each image and each of
    its 8 branch selectors round(B / 2) = 2 of the 4 images, more only where
    scores tie at the threshold; the same forward on the CPU printed beside
    it (a near tie may route differently there, so it is not gated)."""
    from promptir_tpu_torch.ops import camixer
    from promptir_tpu_torch.precision import exact_float32

    windows, images = [], []
    real_route, real_topk = camixer.route_mask, camixer.topk_window_mask

    def route_spy(scores, ratio, deterministic, u=None):
        mask = real_route(scores, ratio, deterministic, u)
        windows.append((scores[:, :, 0].float().cpu(), mask[..., 0].cpu()))
        return mask

    def topk_spy(scores, k):
        mask = real_topk(scores, k)
        if scores.shape[0] == 1:  # the selector's (1, B) labels
            images.append((scores.cpu(), mask.cpu()))
        return mask

    name = "catapromptxrestormer"
    torch.manual_seed(0)
    cpu = port.create_model(name, device="cpu", **CA_REDUCED)
    model = port.create_model(name, device="cuda", **CA_REDUCED)
    model.load_state_dict(cpu.state_dict(), strict=True)
    x = torch.rand(4, 3, 64, 128, generator=torch.Generator().manual_seed(9))
    reset()
    with torch.inference_mode(), exact_float32(torch.float32):
        with mock.patch.object(camixer, "route_mask", route_spy), \
                mock.patch.object(camixer, "topk_window_mask", topk_spy):
            y = model(x.cuda()).cpu()
        ran = counters()
        y0 = cpu(x)
    reset()  # a check, not the main path
    kept_w = kept_counts(windows, model.ratio, "a v2 mixer")
    kept_i = kept_counts(images, model.hard_ratio, "a branch selector")
    err, rel = rel_err(y, y0)
    say(f"card routing: reduced {name} ratio {model.ratio} hard ratio "
        f"{model.hard_ratio} fp32 B4 64x128, {len(windows)} v2 mixers keep "
        f"{kept_w} windows an image (max(1, round(N / 2)) each), "
        f"{len(images)} branch selectors keep {kept_i} of 4 images; against "
        f"the CPU's forward max |difference| {err:.3e} (rel {rel:.3e}, not "
        f"gated); launches {LAUNCH_NAMES} {ran}")
    if len(windows) != 8 or len(images) != 8:
        fail(f"the routing check ran {len(windows)} mixers and {len(images)} "
             f"selectors, not 8 and 8")
    if ran != CA_CHECKS[name][1] or not torch.isfinite(y).all():
        fail(f"the ratio-0.5 {name} forward launched {ran} or is not finite")


def serve_tlc(port, counters, reset, card):
    """NAFNetLocal (the default TLC windows) with full-width NAFNet's
    seed-0 weights, beta and gamma seeded, bf16: at 256x256 bit-equal to
    NAFNet (its windows cover every map), at 512x768 not; one 512x768
    request through the engine, timed after a warm-up request. No launch.
    Returns the launches."""
    from promptir_tpu_torch.eval.padding import pad_bases
    from promptir_tpu_torch.serve.engine import InferenceEngine

    torch.manual_seed(0)
    base = seeded_scales(port.create_model("nafnet", device="cpu"), 2)
    nets = {}
    for name in ("nafnet", "nafnetlocal"):
        m = port.create_model(name, device="cuda", dtype=torch.bfloat16)
        m.load_state_dict(base.state_dict(), strict=True)
        nets[name] = m
    reset()
    gen = torch.Generator().manual_seed(7)
    same = {}
    with torch.inference_mode():
        for hw in (TLC_SAME_HW, TLC_LOCAL_HW):
            x = torch.rand(1, 3, *hw, generator=gen).cuda()
            y, y_local = (nets[n](x) for n in ("nafnet", "nafnetlocal"))
            if not torch.isfinite(y_local).all():
                fail(f"nafnetlocal's {hw} output is not finite")
            same[hw] = (torch.equal(y, y_local),
                        (y - y_local).abs().max().item())
    img = np.random.default_rng(8).random((*TLC_LOCAL_HW, 3), dtype=np.float32)
    eng = InferenceEngine(nets["nafnetlocal"], max_batch=1,
                          pad_base=pad_bases("nafnetlocal")[0],
                          batch_timeout_ms=1)
    try:
        eng.submit(img).result(timeout=600)
        t0 = time.perf_counter()
        out = eng.submit(img).result(timeout=600)
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        eng.close(join_timeout_s=60)
    ran = counters()
    say(f"serve: nafnetlocal (NAFNet's weights, beta and gamma seeded, bf16) "
        f"against nafnet: {TLC_SAME_HW[0]}x{TLC_SAME_HW[1]} bit-equal "
        f"{same[TLC_SAME_HW][0]}, {TLC_LOCAL_HW[0]}x{TLC_LOCAL_HW[1]} "
        f"bit-equal {same[TLC_LOCAL_HW][0]} (max |difference| "
        f"{same[TLC_LOCAL_HW][1]:.3e}); one {TLC_LOCAL_HW[0]}x"
        f"{TLC_LOCAL_HW[1]} request through the engine {ms:.1f} ms after a "
        f"warm-up on {card}; launches {LAUNCH_NAMES} {ran}")
    if not same[TLC_SAME_HW][0] or same[TLC_LOCAL_HW][0]:
        fail("nafnetlocal must equal nafnet at 256x256 and differ at 512x768")
    if out.shape != img.shape or not np.isfinite(out).all():
        fail(f"bad nafnetlocal reply {out.shape}")
    if ran != [0] * len(KERNELS):
        fail(f"nafnetlocal launched {ran}: no kernel is on its path")
    del nets, eng
    torch.cuda.empty_cache()
    return ran


def run_tiled(model, imgs):
    """The photographs through a tiled engine, submitted together: (replies,
    seconds from each submit to its reply, seconds for all, engine stats)."""
    from promptir_tpu_torch.serve.engine import InferenceEngine

    eng = InferenceEngine(model, max_batch=4, pad_base=8, batch_timeout_ms=0,
                          tile_threshold_px=256 * 256, tile_size=TILE,
                          tile_overlap=TILE_OVERLAP, tile_chunk=TILE_CHUNK)
    try:
        done = {}
        t_start = time.perf_counter()
        futs = []
        for i, im in enumerate(imgs):
            f = eng.submit(im)
            f.add_done_callback(
                lambda _, i=i: done.__setitem__(i, time.perf_counter()))
            futs.append((f, time.perf_counter()))
        outs = [f.result(timeout=600) for f, _ in futs]
        stats = eng.stats()
    finally:
        eng.close(join_timeout_s=60)
    lat = [done[i] - t for i, (_, t) in enumerate(futs)]
    return outs, lat, max(done.values()) - t_start, stats


def serve_tiled(port, counters, reset, card):
    """Full-depth promptir (random weights from seed 0) serving two 1024x768
    photographs through the engine's tiled path: float32 through the
    kernels against float32 through the plain versions, then bf16 timed.
    Returns the launches of the timed bf16 run."""
    from promptir_tpu_torch.tools.trace import time_ms
    per_image = [n * TILED_FORWARDS for n in PATHS["promptir"][2]]
    rng = np.random.default_rng(0)
    imgs = [rng.random((*TILED_HW, 3), dtype=np.float32) for _ in range(2)]
    torch.manual_seed(0)
    model = port.create_model("promptir", device="cuda")
    reset()
    outs, _, secs, st = run_tiled(model, imgs)
    ran = counters()
    with plain_route():
        ref, _, secs_p, _ = run_tiled(model, imgs)
    if counters() != ran:
        fail("the plain route launched kernels")
    err = max(float(np.abs(o - r).max()) for o, r in zip(outs, ref))
    say(f"tiled: full-depth promptir fp32 (TF32 off), 2 requests {TILED_HW[0]}x"
        f"{TILED_HW[1]} through the engine's tiled path (tile {TILE}, overlap "
        f"{TILE_OVERLAP}, chunk {TILE_CHUNK}): {st['tiled_requests']} tiled "
        f"requests, max |kernels - plain| {err:.3e} (tolerance {GOLDEN_TOL}); "
        f"{secs:.2f} s through the kernels, {secs_p:.2f} s plain; launches "
        f"{LAUNCH_NAMES} {ran}")
    if st["tiled_requests"] != 2 or ran != [2 * n for n in per_image]:
        fail(f"tiled serving launched {ran} != 2 x {per_image} "
             f"({st['tiled_requests']} tiled requests)")
    for im, out in zip(imgs, outs):
        if out.shape != im.shape or not np.isfinite(out).all():
            fail(f"bad tiled reply {out.shape} for a {im.shape} request")
        if out.min() < 0.0 or out.max() > 1.0:
            fail("tiled reply outside [0, 1]")
    if not err <= GOLDEN_TOL:
        fail(f"tiled output through the kernels off by {err:.3e} > {GOLDEN_TOL}")
    del model
    torch.manual_seed(0)
    model = port.create_model("promptir", device="cuda", dtype=torch.bfloat16)
    run_tiled(model, imgs[:1])  # warm-up: cuDNN plans, allocator
    reset()
    outs, lat, secs, _ = run_tiled(model, imgs)
    ran = counters()
    say(f"tiled: full-depth promptir bf16, 2 requests {TILED_HW[0]}x"
        f"{TILED_HW[1]} submitted together: p50 latency "
        f"{float(np.median(lat)) * 1e3:.1f} ms, "
        f"{len(imgs) / secs:.3f} images/s on {card}; launches {LAUNCH_NAMES} "
        f"{ran}")
    if ran != [2 * n for n in per_image]:
        fail(f"tiled bf16 serving launched {ran} != 2 x {per_image}")
    if not all(np.isfinite(o).all() for o in outs):
        fail("non-finite bf16 tiled reply")
    # one forward of a tile batch alone, against which phase 9's per-forward
    # kernel sums of the tiled path are read
    x = torch.rand(TILE_CHUNK, 3, TILE, TILE, device="cuda")
    with torch.inference_mode():
        fwd = time_ms(lambda: model(x), reps=5, warmup=1)
    reset()  # the timing launches are not the main path's
    say(f"forward: promptir bf16 B{TILE_CHUNK} {TILE}x{TILE} (one chunk of "
        f"tiles) alone {fwd:.1f} ms (CUDA events, median of 5)")
    del model
    torch.cuda.empty_cache()
    return ran


# ------------------------------------------------------------ phase 6

@contextlib.contextmanager
def plain_route():
    """The forwards with every kernel swapped for its plain version: each
    autograd Function of the training route for its plain composition
    (ops/autodiff.py), and each wrapper of the serving route (the chained
    stacks included) for its plain version. The reference route of the
    gradient check and of the tiled serving check. Restored on exit."""
    from promptir_tpu_torch.models import blocks
    from promptir_tpu_torch.models import promptir as promptir_model
    from promptir_tpu_torch.ops import autodiff
    from promptir_tpu_torch.ops.cuda import block, gdfn, mdta, megablock
    from promptir_tpu_torch.ops.cuda.seam import seam_plain

    swaps = [
        (blocks, "LnMdta", SimpleNamespace(apply=autodiff.plain_ln_mdta)),
        (blocks, "LnGdfn", SimpleNamespace(apply=autodiff.plain_ln_gdfn)),
        (blocks, "LnBlock", SimpleNamespace(apply=autodiff.plain_ln_block)),
        (blocks, "mdta_stats", mdta.mdta_stats_plain),
        (blocks, "block_tail", block.block_tail_plain),
        (blocks, "tail_stats", megablock.tail_stats_plain),
        (blocks, "ln_gdfn", gdfn.ln_gdfn_plain),
        (promptir_model, "Seam", SimpleNamespace(apply=seam_plain)),
    ]
    with contextlib.ExitStack() as stack:
        for mod, name, fn in swaps:
            stack.enter_context(mock.patch.object(mod, name, fn))
        yield


def check_ln_block_grads(counters, reset):
    """LnBlock (the --fused training route's block) at every block shape of
    the training step (B6 128x128), in float32 (TF32 off) and bf16: its
    output and the gradient of 0.5 |out|^2 for x and every weight, through
    the kernels (mdta_stats, block_tail) against the same Function with the
    kernels swapped for their plain versions. The backward is the plain
    composition either way, so the gradients differ only through the
    forward's output. Returns {dtype: (worst output error, worst gradient
    error)}, each over max |plain|."""
    from promptir_tpu_torch.ops import autodiff
    from promptir_tpu_torch.ops.cuda import block, mdta
    from promptir_tpu_torch.tools.kbench import block_inputs

    gen = torch.Generator(device="cuda").manual_seed(5)
    names = ("ln1w", "ln1b", "wqkv", "wdw", "wproj", "temp", "ln2w", "ln2b",
             "w1", "wdwf", "w2")
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        worst[dtype] = [0.0, 0.0]
        for shape, _ in block_shapes(*TRAIN_HW):
            a = block_inputs(shape, dtype, gen, TRAIN_BATCH)
            ins = [a["x"]] + [a[k] for k in names]

            def run(plain):
                leaves = [t.detach().clone().requires_grad_() for t in ins]
                swaps = ([mock.patch.object(autodiff, "mdta_stats",
                                            mdta.mdta_stats_plain),
                          mock.patch.object(autodiff, "block_tail",
                                            block.block_tail_plain)]
                         if plain else [])
                with contextlib.ExitStack() as stack:
                    for sw in swaps:
                        stack.enter_context(sw)
                    out = autodiff.LnBlock.apply(*leaves, a["heads"], False,
                                                 1e-5)
                    (0.5 * out.float().square().sum()).backward()
                torch.cuda.synchronize()
                return out.detach(), [t.grad for t in leaves]

            before = counters()
            out_k, g_k = run(False)
            ran = [x - y for x, y in zip(counters(), before)]
            out_p, g_p = run(True)
            if ran[:2] != [1, 1] or any(ran[2:-1]):
                fail(f"LnBlock at {shape} {dtype} launched {ran}")
            _, ro = rel_err(out_k, out_p)
            rg = max(rel_err(a_, b_)[1] for a_, b_ in zip(g_k, g_p))
            if not all(torch.isfinite(g).all() for g in g_k):
                fail(f"LnBlock's gradient is not finite at {shape} {dtype}")
            worst[dtype] = [max(worst[dtype][0], ro), max(worst[dtype][1], rg)]
        tol = TOL[dtype]
        say(f"check LnBlock {str(dtype)[6:]}: the {len(block_shapes(*TRAIN_HW))} "
            f"block shapes of B{TRAIN_BATCH} {TRAIN_HW[0]}x{TRAIN_HW[1]}: "
            f"output through the kernels off the plain versions' by at most "
            f"{worst[dtype][0]:.2e} of max |plain|, the gradients of x and "
            f"every weight by {worst[dtype][1]:.2e} (tolerance {tol})")
        if not (worst[dtype][0] <= tol and worst[dtype][1] <= tol):
            fail(f"LnBlock through the kernels is off its plain version in "
                 f"{dtype}: {worst[dtype]}")
    reset()  # a comparison, not the main path
    return worst


def check_grads(port, counters, reset):
    """One reduced PromptIR step's gradients through the kernels against the
    same step through the plain versions, float32 with TF32 off."""
    from promptir_tpu_torch.precision import exact_float32
    from promptir_tpu_torch.train.losses import l1_loss

    torch.manual_seed(0)
    model = port.create_model("promptir", device="cuda", train=True, **REDUCED)
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.rand(2, 3, 64, 96, generator=gen, device="cuda")
    y = torch.rand(2, 3, 64, 96, generator=gen, device="cuda")

    def grads():
        model.zero_grad(set_to_none=True)
        before = counters()
        with exact_float32(torch.float32):
            loss = l1_loss(model(x), y)
            loss.backward()
        torch.cuda.synchronize()
        ran = [a - b for a, b in zip(counters(), before)]
        return loss.item(), {n: p.grad for n, p in model.named_parameters()
                             if p.grad is not None}, ran

    loss_k, g_k, ran_k = grads()
    with plain_route():
        loss_p, g_p, ran_p = grads()
    reset()  # a comparison, not the main path
    if sorted(g_k) != sorted(g_p):
        fail("the two routes give gradients to different parameters")
    worst = max(((g_k[n] - g_p[n]).abs().max().item()
                 / max(g_p[n].abs().max().item(), 1e-30), n) for n in g_p)
    say(f"gradients: reduced promptir (2, 3, 64, 96) fp32 TF32 off, {len(g_p)} "
        f"parameters: loss {loss_k:.7f} through the kernels, {loss_p:.7f} "
        f"plain; worst gradient |kernel - plain| / max |plain| {worst[0]:.2e} "
        f"({worst[1]}; tolerance {GRAD_TOL}); launches "
        f"{LAUNCH_NAMES} {ran_k} and plain {ran_p}")
    if ran_k != [11, 0, 11, 1, 11, 0, 2] or any(ran_p):
        fail(f"the gradient check's routes launched {ran_k} and {ran_p}")
    if not worst[0] <= GRAD_TOL:
        fail(f"kernel-route gradient of {worst[1]} off by {worst[0]:.2e}")


# ------------------------------------------------------------ phase 7

def train(port, counters, reset, card):
    """Full-depth PromptIR: AdamW steps on one fixed batch of six 128x128
    synthetic patches, float32 (TF32 off) and bf16 compute with float32
    weights, and bf16 in each of TRAIN_MODES' promptir modes; then
    full-depth promptxrestormerir (and its fused_ffn mode) and
    promptxrestormereffir in their training config, and the attention-free family's default
    easypromptxrestormer and nafnet (NAFNet starting as an identity: beta
    and gamma 0) and the Uformer family's default promptuformerir and
    capromptuformerir (its routing sampled, its mean decision printed),
    bf16 compute, no launch. Returns the launches over the whole run."""
    from promptir_tpu_torch.data.loader import TrainLoader
    from promptir_tpu_torch.data.synthetic import SyntheticTrainDataset
    from promptir_tpu_torch.train.state import TrainState, make_optimizer
    from promptir_tpu_torch.train.step import make_train_step

    ds = SyntheticTrainDataset(n=TRAIN_BATCH, patch_size=TRAIN_HW[0])
    batch = next(TrainLoader(ds, batch_size=TRAIN_BATCH, shuffle=False,
                             num_workers=2, pin_memory=True).epoch(0))
    reset()
    total = [0] * len(KERNELS)
    served = [0] * len(KERNELS)
    # (name, kwargs, dtype, launches a step, mode label, default run held to)
    modes = {ref: [(label, name, kw, per_step, ref)
                   for label, name, kw, per_step, r in TRAIN_MODES if r == ref]
             for ref in ("promptir", "promptxrestormerir")}
    runs = [("promptir", {}, torch.float32, TRAIN_PER_STEP, None, None),
            ("promptir", {}, torch.bfloat16, TRAIN_PER_STEP, None, None)] + [
            (name, kw, torch.bfloat16, per_step, label, ref)
            for label, name, kw, per_step, ref in modes["promptir"]] + [
            ("promptxrestormerir", XR_TRAIN, torch.bfloat16, XR_TRAIN_PER_STEP,
             None, None)] + [
            (name, kw, torch.bfloat16, per_step, label, ref)
            for label, name, kw, per_step, ref in modes["promptxrestormerir"]] + [
            (EFF, XR_TRAIN, torch.bfloat16, EFF_TRAIN_PER_STEP, None, None)] + [
            (name, {}, torch.bfloat16, [0] * len(KERNELS), None, None)
            for name in NO_KERNEL] + [
            (name, XR_TRAIN, torch.bfloat16, CA_TRAIN_PER_STEP[name], None, None)
            for name in CA_XR]
    default_bf16 = {}  # name: (losses, step ms, peak bytes) of its default run
    for name, kw, dtype, per_step, label, ref in runs:
        torch.manual_seed(0)
        model = port.create_model(name, device="cuda", dtype=dtype,
                                  train=True, **kw)
        n_params = sum(p.numel() for p in model.parameters())
        st = TrainState(model, make_optimizer(model.parameters()))
        step = make_train_step(model)
        losses, times, aux = [], [], []
        # a stochastic model's extra outputs, each step's: v1's mean routing
        # decision, v2's ratio loss, CATA's ratio and hard-ratio losses
        hook = model.register_forward_hook(
            lambda m, a, out: aux.append([t.detach() for t in out[1:]])
            if isinstance(out, tuple) else None)
        for i in range(TRAIN_STEPS):
            if i == TRAIN_WARMUP:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            before = counters()
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            metrics = step(st, batch)
            t1.record()
            torch.cuda.synchronize()
            ran = [a - b for a, b in zip(counters(), before)]
            if ran != per_step:
                fail(f"{name} training step {i} ({dtype}) launched {ran} != "
                     f"{per_step}")
            total = [a + b for a, b in zip(total, ran)]
            losses.append(metrics["train_loss"].item())
            if i >= TRAIN_WARMUP:
                times.append(t0.elapsed_time(t1))
        hook.remove()
        peak = torch.cuda.max_memory_allocated()
        ms = float(np.median(times))
        say(f"train: full-depth {name}"
            + (f" --{label}" if label else "")
            + f" ({n_params} params, fp32 weights) "
            f"{str(dtype)[6:]} compute, AdamW lr 2e-4, B{TRAIN_BATCH} "
            f"{TRAIN_HW[0]}x{TRAIN_HW[1]} on one fixed batch: loss "
            f"{', '.join(f'{v:.5f}' for v in losses)}; step {ms:.1f} ms "
            f"(median of {len(times)} after {TRAIN_WARMUP} warm-up, CUDA "
            f"events), {TRAIN_BATCH * 1e3 / ms:.2f} images/s, peak memory "
            f"{peak / 2**30:.2f} GiB on {card}; launches "
            f"{LAUNCH_NAMES} per step {per_step}")
        variant = getattr(model, "variant", None)
        if variant == "v1":
            from promptir_tpu_torch.train.losses import ratio_loss

            d = [float(v[0]) for v in aux]
            say(f"train: {name} Gumbel routing, mean decision a step "
                f"{', '.join(f'{v:.4f}' for v in d)}; ratio term "
                f"{', '.join(f'{float(ratio_loss(torch.tensor(v), model.ratio)):.6f}' for v in d)}"
                f" (in the loss above)")
            if len(d) != TRAIN_STEPS or not all(0.0 <= v <= 1.0 for v in d):
                fail(f"{name}'s steps gave decisions {d}")
        elif variant in ("v2", "cata"):
            terms = [[float(t) for t in v] for v in aux]
            names = ["ratio term", "hard-ratio term"][:len(terms[0])]
            say(f"train: {name} Gumbel routing (CAMixer v2"
                + (", branch selector" if variant == "cata" else "") + "), "
                + "; ".join(f"{n} a step "
                            + ", ".join(f"{t[j]:.6f}" for t in terms)
                            for j, n in enumerate(names))
                + " (in the loss above)")
            # 2 r (mean - 1/2)^2 with r = 1/2 lies in [0, 1/4]
            if len(terms) != TRAIN_STEPS or not all(
                    0.0 <= v <= 0.25 for t in terms for v in t):
                fail(f"{name}'s steps gave routing terms {terms}")
        if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
            fail(f"{name} {label or ''} training loss did not fall on a fixed "
                 f"batch: {losses}")
        if label is None and dtype == torch.bfloat16:
            default_bf16[name] = (losses, ms, peak)
        if label is not None:
            # the second step's loss is the first update's: a stale bf16
            # copy of a weight would leave it at the first step's
            d_losses, d_ms, d_peak = default_bf16[ref]
            gap = abs(losses[1] - d_losses[1]) / d_losses[1]
            say(f"train: {name} --{label} against the default route: second "
                f"step's loss {losses[1]:.6f} vs {d_losses[1]:.6f} (first "
                f"{losses[0]:.6f} vs {d_losses[0]:.6f}), {gap:.2e} apart "
                f"(gate {GRAD_TOL}); step {ms:.1f} vs {d_ms:.1f} ms "
                f"({ms / d_ms:.2f}x), peak memory {peak / 2**30:.2f} vs "
                f"{d_peak / 2**30:.2f} GiB ({peak / d_peak:.2f}x) on {card}")
            if not gap <= GRAD_TOL:
                fail(f"{name} --{label}'s second step's loss is {gap:.2e} "
                     f"from the default route's")
        if name == "promptir" and dtype == torch.bfloat16 and label is None:
            served = serve_trained(model, counters, card)
        del model, st, step
        torch.cuda.empty_cache()
    if [a + b for a, b in zip(total, served)] != counters():
        fail(f"launches outside the training steps and the serving of the "
             f"trained model: {counters()} != {total} + {served}")
    return total


# CAMixer v1's dilated depthwise conv (conv_sptial.1): its bf16 weight
# gradient against its float32 one (TF32 off), over max |fp32 grad|; the CPU
# test's bound (tests/test_torch_faults.py:DILATED_TOL)
DILATED_TOL = 2e-2
# (stage of CAPromptXRestormerEff, level) whose first block's conv_sptial.1
# phase 7's B6 128x128 step runs at each width and size
CA_V1_CONVS = (("encoder_level1", 0), ("encoder_level2", 1),
               ("encoder_level3", 2), ("latent", 3), ("decoder_level1", 0))


def check_ca_v1(port, card):
    """ROADMAP Queue 3 items 2 and 3 on the card, CAMixer v1
    (capromptxrestormereff, training config, bf16 compute). (a) Each
    CA_V1_CONVS conv_sptial.1 on a B6 input of its level's size through
    conv_nhwc (channels-last memory, cuDNN): the bf16 weight gradient within
    DILATED_TOL of the fp32 one (the CPU's was 1.3-1.5 off before
    ops/conv.py's contiguous copy, which the card does not take). (b) Phase
    7's step twice from the same seed under PyTorch's default algorithms,
    then twice under torch.use_deterministic_algorithms(True,
    warn_only=True): whether the two give the same bits, which gradients
    differ, and the ops PyTorch warns about."""
    import warnings

    from promptir_tpu_torch.ops.window_attention import conv_nhwc
    from promptir_tpu_torch.precision import exact_float32
    from promptir_tpu_torch.tools.parity import named_grads
    from promptir_tpu_torch.train.state import TrainState, make_optimizer
    from promptir_tpu_torch.train.step import make_train_step

    name = "capromptxrestormereff"
    torch.manual_seed(0)
    model = port.create_model(name, device="cuda", dtype=torch.bfloat16,
                              train=True, **XR_TRAIN)
    gen = torch.Generator(device="cuda").manual_seed(7)
    for stage, level in CA_V1_CONVS:
        conv = getattr(model, stage).layer[0].spatial_attn.conv_sptial[1]
        c, h, w = conv.in_channels, TRAIN_HW[0] >> level, TRAIN_HW[1] >> level
        x = torch.randn(TRAIN_BATCH, h, w, c, generator=gen, device="cuda")
        go = torch.randn(TRAIN_BATCH, h, w, c, generator=gen, device="cuda")
        grads = {}
        for dt in (torch.float32, torch.bfloat16):
            conv.zero_grad(set_to_none=True)
            with exact_float32(dt):
                conv_nhwc(x.to(dt), conv).backward(go.to(dt))
            grads[dt] = (conv.weight.grad.clone(), conv.bias.grad.clone())
        torch.cuda.synchronize()
        (ew, rw), (eb, rb) = (rel_err(g16, g32) for g16, g32 in
                              zip(grads[torch.bfloat16], grads[torch.float32]))
        say(f"{name} {stage}.layer.0.spatial_attn.conv_sptial.1 (dilation 2, "
            f"depthwise, C {c}) at B{TRAIN_BATCH} {h}x{w}, channels-last: bf16 "
            f"weight gradient {rw:.3e} of max |fp32 grad| (bias {rb:.3e}; "
            f"gate {DILATED_TOL}) on {card}")
        if not max(rw, rb) <= DILATED_TOL:
            fail(f"{stage}'s conv_sptial.1 bf16 gradient is {max(rw, rb):.3e} "
                 f"from its fp32 gradient")
    del model
    batch = train_batch()

    def step():
        torch.manual_seed(0)
        m = port.create_model(name, device="cuda", dtype=torch.bfloat16,
                              train=True, **XR_TRAIN)
        st = TrainState(m, make_optimizer(m.parameters()))
        grads = grad_capture(st, m)
        loss = make_train_step(m)(st, batch)["train_loss"].item()
        torch.cuda.synchronize()
        return loss, named_grads(m, grads[0])

    def compare(label):
        (l0, g0), (l1, g1) = step(), step()
        apart = [k for k in g0 if not np.array_equal(g0[k], g1[k])]
        say(f"{name} bf16 B{TRAIN_BATCH} step twice from seed 0, {label}: "
            f"losses {l0!r} and {l1!r}; {len(apart)} of {len(g0)} gradients "
            f"differ in some bit" + (f", the last in the model's order: "
                                     f"{', '.join(apart[-3:])}" if apart else ""))
        return l0 == l1 and not apart

    same_default = compare("PyTorch's default algorithms")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            same_det = compare("torch.use_deterministic_algorithms(True, "
                               "warn_only=True)")
        finally:
            torch.use_deterministic_algorithms(False)
    ops = sorted({str(w.message).splitlines()[0][:240] for w in caught
                  if "determinis" in str(w.message)})
    say(f"{name}: ops PyTorch warns about under deterministic algorithms "
        f"(warn_only): {len(ops)}" + "".join(f"\n    {o}" for o in ops))
    say(f"{name}: two steps bit-equal under the default algorithms: "
        f"{same_default}; under the deterministic ones: {same_det}")
    torch.cuda.empty_cache()


def serve_trained(model, counters, card):
    """The bf16-computing model with float32 weights that train() stepped,
    served through the engine (under torch.inference_mode) for eight
    256x256 requests in two rounds: the launches of a served forward, every
    GDFN's packed weights made in the first round only, replies finite and
    in [0, 1]. Returns the launches."""
    from promptir_tpu_torch.models.blocks import TransformerBlock
    from promptir_tpu_torch.ops.cuda import packed
    from promptir_tpu_torch.serve.engine import InferenceEngine

    n_blocks = sum(isinstance(m, TransformerBlock) for m in model.modules())
    rng = np.random.default_rng(1)
    imgs = [rng.random((256, 256, 3), dtype=np.float32) for _ in range(8)]
    made, real = [], packed._pack
    before = counters()
    with mock.patch.object(packed, "_pack",
                           lambda *w: made.append(1) or real(*w)):
        eng = InferenceEngine(model, max_batch=4, pad_base=8,
                              batch_timeout_ms=50)
        try:
            outs = [f.result(timeout=600)
                    for f in [eng.submit(im) for im in imgs[:4]]]
            first = len(made)
            outs += [f.result(timeout=600)
                     for f in [eng.submit(im) for im in imgs[4:]]]
            batches = eng.stats()["batches"]
        finally:
            eng.close(join_timeout_s=60)
    ran = [a - b for a, b in zip(counters(), before)]
    say(f"serve the trained model: full-depth promptir, fp32 weights, bf16 "
        f"compute, 8 requests 256x256 in {batches} batches on {card}; packed "
        f"GDFN weights made {first} times in the first round ({n_blocks} "
        f"blocks), {len(made) - first} in the second; launches "
        f"{LAUNCH_NAMES} {ran}")
    if first != n_blocks or len(made) != first:
        fail(f"the trained model's GDFN weights were packed {first} + "
             f"{len(made) - first} times, not {n_blocks} + 0")
    if ran != [n * batches for n in PATHS["promptir"][2]]:
        fail(f"serving the trained model launched {ran} != "
             f"{PATHS['promptir'][2]} per forward x {batches}")
    for out in outs:
        if (out.shape != (256, 256, 3) or not np.isfinite(out).all()
                or out.min() < 0.0 or out.max() > 1.0):
            fail("bad reply from the trained model")
    return ran


# ------------------------------------------------------------ phase 8

def demo():
    """cli/train_demo.py at reduced depth, bf16."""
    from promptir_tpu_torch.cli import train_demo

    out = ROOT / "logs" / "chip_smoke_demo"
    shutil.rmtree(out, ignore_errors=True)
    args = [f"--{k}={v}" for k, v in DEMO.items()]
    try:
        res = train_demo.main(args + ["--dtype=bfloat16", f"--ckpt_dir={out / 'ckpt'}",
                                      f"--log_dir={out}"])
    finally:
        shutil.rmtree(out, ignore_errors=True)
    say(f"demo: reduced promptir (2, 3, 3, 4) + 2 refinement, bf16, {' '.join(args)}: "
        f"held-out sigma=25 PSNR "
        f"{res['psnr_before']:.2f} -> {res['psnr_after']:.2f} dB (noisy input "
        f"{res['psnr_noisy']:.2f} dB) in {res['seconds']:.1f} s")
    if not res["psnr_after"] > res["psnr_before"]:
        fail("the demo's held-out PSNR did not rise")
    return res


# ------------------------------------------------------------ phase 9

def plan_text(mdta, gdfn, k, shape, batch) -> str:
    """The bf16 plan of ln_gdfn or the apply at one shape."""
    h, w, c, heads = shape
    if k == "ln_gdfn":
        p = gdfn.ln_gdfn_plan(batch, h, w, c, int(c * 2.66))
        return f"tile {p.tile[0]}x{p.tile[1]}, split {p.split}"
    p = mdta.apply_plan(batch, h, w, c, heads)
    return (f"{p.pixels} px x {p.cols} cols, attn {p.heads_staged} heads x "
            f"{p.attn_rows} rows, {p.slots} blocks an image, W_proj "
            + ("resident" if p.resident else "streamed"))


def chain_pairs(h, w):
    """(H, W, C, heads) of the consecutive block pairs inside the block
    stacks of an h x w promptir forward, with how many: the pairs that the
    chained route runs through tail_stats."""
    return [
        ((h, w, 48, 1), 3),                  # encoder_level1
        ((h // 2, w // 2, 96, 2), 10),       # encoder_level2, decoder_level2
        ((h // 4, w // 4, 192, 4), 10),      # encoder_level3, decoder_level3
        ((h // 8, w // 8, 384, 8), 7),       # latent
        ((h, w, 96, 1), 6),                  # decoder_level1, refinement
    ]


def megablock_bound(shapes, batch, dtype=torch.bfloat16):
    """The bound of tail_stats (megablock.py:165 fused_tail_stats_padded)
    over the block pairs of one promptir forward."""
    from promptir_tpu_torch.tools.kbench import (
        bound_ms,
        pair_work,
    )
    ops = nbytes = pairs = 0
    for shape, n in shapes:
        o, b = pair_work(shape, 2, batch)
        ops += n * o
        nbytes += n * b
        pairs += n
    b, by = bound_ms(ops, nbytes, dtype)
    say(f"bound of tail_stats (megablock.py:165) over the {pairs} block pairs "
        f"of a promptir B{batch} {shapes[0][0][0]}x{shapes[0][0][1]} bf16 "
        f"forward: {b:.4f} ms by {by} ({ops / 1e12:.3f} T operations, "
        f"{nbytes / 1e9:.3f} GB)")
    return b


def time_tail_stats(mdta, block, megablock, gen, tot):
    """tail_stats per launch at every block pair of the promptir stacks,
    beside its plain version and the two-kernel sequence it replaces, summed
    per chained forward of the serving path (B4 256x256) and of the tiled
    path (the tiler's B8 128x128 chunk); then the chained route's decision
    (CHAIN_RATIO at every shape, CHAIN_FORWARD_MS a serving forward)."""
    from promptir_tpu_torch.tools.kbench import (
        block_inputs,
        bound_ms,
        pair_work,
        run_stats,
        run_tail_stats,
    )
    from promptir_tpu_torch.tools.trace import time_ms
    dtype = torch.bfloat16
    ratios, per_forward = [], {}
    for path, hw, batch in [("promptir_chained", BUCKETS[0], BATCH),
                            ("tiled_chained", (TILE, TILE), TILE_CHUNK)]:
        t = tot[path]["tail_stats"] = dict(ms=0.0, plain_ms=0.0, ops=0,
                                           bytes=0, library_ms=None)
        two_sum = 0.0
        for shape, n in chain_pairs(*hw):
            a = block_inputs(shape, dtype, gen, batch)
            a2 = block_inputs(shape, dtype, gen, 1)
            v, st = run_stats(mdta.mdta_stats, a)
            attn = mdta.attn_from_stats(st, a["temp"])
            ms = time_ms(lambda: run_tail_stats(megablock.tail_stats, a, a2,
                                                v, attn))
            pms = time_ms(lambda: run_tail_stats(megablock.tail_stats_plain,
                                                 a, a2, v, attn))
            two = time_ms(lambda: run_two_kernels(mdta, block, a, a2, v, attn))
            work = pair_work(shape, 2, batch)
            b, by = bound_ms(*work, dtype)
            tile = megablock.tail_stats_tile(shape[2], shape[3], dtype)
            ratios.append((ms / two, batch, shape))
            say(f"time tail_stats B{batch} {shape} bf16, tile {tile[0]}x"
                f"{tile[1]}: {ms:.3f} ms (block_tail + mdta_stats {two:.3f} "
                f"ms, ratio {ms / two:.3f}; plain {pms:.3f} ms, bound {b:.4f} "
                f"ms by {by}) x{n} per {path} forward")
            t["ms"] += n * ms
            t["plain_ms"] += n * pms
            t["ops"] += n * work[0]
            t["bytes"] += n * work[1]
            two_sum += n * two
        megablock_bound(chain_pairs(*hw), batch)
        per_forward[path] = t["ms"]
        say(f"time tail_stats per {path} forward (B{batch} {hw[0]}x{hw[1]} "
            f"bf16): {t['ms']:.3f} ms, the two-kernel sequence "
            f"{two_sum:.3f} ms, plain {t['plain_ms']:.3f} ms")
    worst = max(ratios)
    keep = worst[0] <= CHAIN_RATIO and per_forward[
        "promptir_chained"] <= CHAIN_FORWARD_MS
    say(f"chained route: tail_stats over block_tail + mdta_stats at most "
        f"{worst[0]:.3f} (B{worst[1]} {worst[2]}; limit {CHAIN_RATIO}), at "
        f"most {CHAIN_RATIO} at {sum(r <= CHAIN_RATIO for r, *_ in ratios)} of "
        f"{len(ratios)} shapes; {per_forward['promptir_chained']:.3f} ms a "
        f"promptir B{BATCH} forward (limit {CHAIN_FORWARD_MS}): "
        + ("both hold, the chain could be the default" if keep else
           "the chain stays off by default (fused_ffn=False)"))


def time_gram(mdta, q, k, heads, batch, shape, dtype):
    """The Gram kernel at one wide shape: (ms, plain ms, library ms, ops,
    bytes, device ms, library device ms); the library call is one cuBLAS
    batched product of the same q and k (torch.matmul, output in their
    dtype), the work tools/kbench.py:gram_work's, each device ms a profiler
    window's (the kernels alone, without the callers' host time)."""
    from promptir_tpu_torch.tools.kbench import gram_work
    from promptir_tpu_torch.tools.trace import profiled_ms, time_ms
    h, w, c, _ = shape
    d, px = c // heads, h * w
    qh = q.reshape(batch, px, heads, d).permute(0, 2, 3, 1)
    kh = k.reshape(batch, px, heads, d).permute(0, 2, 1, 3)
    ms = time_ms(lambda: mdta.mdta_gram(q, k, heads))
    pms = time_ms(lambda: mdta.mdta_gram_plain(q, k, heads))
    lib = time_ms(lambda: torch.matmul(qh, kh))
    dev = max(profiled_ms(lambda: mdta.mdta_gram(q, k, heads)) for _ in range(2))
    lib_dev = max(profiled_ms(lambda: torch.matmul(qh, kh)) for _ in range(2))
    ops, nbytes = gram_work(shape, 2 if dtype == torch.bfloat16 else 4, batch)
    return ms, pms, lib, ops, nbytes, dev, lib_dev


def time_kernels(mdta, block, gdfn, seam, megablock, reset):
    """Per path and kernel, the time of one bf16 forward of the path, summed
    over its launches at each shape: serving promptir, promptxrestormerir
    and promptxrestormereffir (batch 4, 256x256), the training forward
    (batch 6, 128x128) and the tiled path's forward of one chunk of tiles
    (batch 8, 128x128); with mdta_stats' per-shape line (route, tile) and
    the Gram kernel's at the wide shapes. A kernel at a shape and batch that
    an earlier path timed keeps that time (promptxrestormereffir's shapes
    are promptxrestormerir's; the --fused training forward's mdta_stats is
    the training forward's)."""
    from promptir_tpu_torch.tools.kbench import (
        HBM_BYTES_PER_S,
        apply_work,
        block_inputs,
        block_work,
        bound_ms,
        gdfn_work,
        run_apply,
        run_ln_gdfn,
        run_stats,
        run_tail,
        seam_inputs,
    )
    from promptir_tpu_torch.tools.trace import (
        profiled_ms,
        time_ms,
    )
    dtype = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(1)
    paths = {
        # path: (shapes with their block counts, batch, kernels timed)
        "promptir": (block_shapes(*BUCKETS[0]), BATCH, ("mdta_stats", "block_tail")),
        "promptxrestormerir": (xr_block_shapes(*BUCKETS[0]), BATCH,
                               ("mdta_stats", "block_tail", "ln_gdfn")),
        EFF: (eff_block_shapes(*BUCKETS[0]), BATCH, ()),
        "train": (block_shapes(*TRAIN_HW), TRAIN_BATCH,
                  ("mdta_stats", "ln_mdta", "ln_gdfn")),
        # --fused training: each block's LnBlock forward (its mdta_stats
        # timed above, at the same shapes)
        "train_fused": (block_shapes(*TRAIN_HW), TRAIN_BATCH,
                        ("mdta_stats", "block_tail")),
        "tiled": (block_shapes(TILE, TILE), TILE_CHUNK,
                  ("mdta_stats", "block_tail")),
    }
    tot = {path: {} for path in [*paths, "promptir_chained", "tiled_chained"]}
    tails, stats_rows = [], []  # per shape: (path, shape, batch, count, ...)
    timed = {}  # (kernel, shape, batch) -> (ms, plain ms, device ms)
    for path, (shapes, batch, kernels) in paths.items():
        for shape, n, *own in shapes:
            ks = own[0] if own else kernels
            wide = mdta.stats_route(shape[2], shape[3]) == "wide"
            fresh = [k for k in ks if (k, shape, batch) not in timed]
            if wide and ("mdta_gram", shape, batch) not in timed:
                fresh.append("mdta_gram")
            if fresh:
                a = block_inputs(shape, dtype, gen, batch)
                v, st = run_stats(mdta.mdta_stats, a)
                attn = mdta.attn_from_stats(st, a["temp"])
                fns = {
                    "mdta_stats": (lambda: run_stats(mdta.mdta_stats, a),
                                   lambda: run_stats(mdta.mdta_stats_plain, a)),
                    "block_tail": (lambda: run_tail(block.block_tail, a, v, attn),
                                   lambda: run_tail(block.block_tail_plain, a, v,
                                                    attn)),
                    "ln_mdta": (lambda: run_apply(mdta.mdta_apply, a, v, attn),
                                lambda: run_apply(mdta.mdta_apply_plain, a, v,
                                                  attn)),
                    "ln_gdfn": (lambda: run_ln_gdfn(gdfn.ln_gdfn, a),
                                lambda: run_ln_gdfn(gdfn.ln_gdfn_plain, a)),
                }
            stats_w, tail_w = block_work(shape, 2, batch)
            work = {"mdta_stats": stats_w, "block_tail": tail_w,
                    "ln_mdta": apply_work(shape, 2, batch),
                    "ln_gdfn": gdfn_work(shape, 2, batch)}
            for k in ks:
                again = k not in fresh
                if not again:
                    dms = profiled_ms(fns[k][0]) if k in TWICE else None
                    timed[k, shape, batch] = (time_ms(fns[k][0]),
                                              time_ms(fns[k][1]), dms)
                ms, pms, dms = timed[k, shape, batch]
                b, by = bound_ms(*work[k], dtype)
                dev = ""
                if k in TWICE:
                    dev = (f", device {dms:.4f} ms, "
                           f"{plan_text(mdta, gdfn, k, shape, batch)}")
                say(f"time {k:10s} B{batch} {shape} bf16: {ms:.3f} ms (plain "
                    f"{pms:.3f} ms, bound {b:.4f} ms by {by}{dev}) x{n} per "
                    f"{path} forward" + (" (timed above)" if again else ""))
                if k == "block_tail":
                    tails.append((path, shape, batch, n, ms, b, by))
                if k == "mdta_stats":
                    stats_rows.append((path, shape, batch, n, ms, pms, b, by))
                t = tot[path].setdefault(k, dict(ms=0.0, plain_ms=0.0, ops=0,
                                                 bytes=0, library_ms=None))
                if k in TWICE:
                    t["device_ms"] = t.get("device_ms", 0.0) + n * dms
                t["ms"] += n * ms
                t["plain_ms"] += n * pms
                t["ops"] += n * work[k][0]
                t["bytes"] += n * work[k][1]
            if wide:
                heads = shape[3]
                again = "mdta_gram" not in fresh
                if not again:
                    _, q, k, _ = mdta.stats_pass_plain(
                        a["x"], a["ln1w"], a["ln1b"], a["wqkv"], a["wdw"], heads)
                    timed["mdta_gram", shape, batch] = time_gram(
                        mdta, q, k, heads, batch, shape, dtype)
                ms, pms, lib, ops, nbytes, dms, ldms = timed[
                    "mdta_gram", shape, batch]
                b, by = bound_ms(ops, nbytes, dtype)
                p = mdta.gram_plan(batch, *shape)
                say(f"time mdta_gram  B{batch} {shape} bf16: {ms:.4f} ms "
                    f"(device {dms:.4f} ms; torch.matmul {lib:.4f} ms, device "
                    f"{ldms:.4f} ms: {'at most' if ms <= lib else 'ABOVE'} "
                    f"it, device {'at most' if dms <= ldms else 'ABOVE'}; plain "
                    f"{pms:.3f} ms, bound {b:.4f} ms by {by}; {p.tiles_m}x"
                    f"{p.tiles_n} tiles of {mdta.GRAM_ROWS}x{p.cols}, "
                    f"{p.slices} slices of {p.span} px, {p.clusters} "
                    f"clusters) x{n} per {path} forward"
                    + (" (timed above)" if again else ""))
                t = tot[path].setdefault("mdta_gram", dict(
                    ms=0.0, plain_ms=0.0, ops=0, bytes=0, library_ms=0.0,
                    device_ms=0.0, library_device_ms=0.0))
                t["ms"] += n * ms
                t["device_ms"] += n * dms
                t["library_device_ms"] += n * ldms
                t["plain_ms"] += n * pms
                t["library_ms"] += n * lib
                t["ops"] += n * ops
                t["bytes"] += n * nbytes
        if path in ("train", "train_fused"):
            continue
        # the split tails (block_tail's and tail_stats's) write the hidden
        # tensor and x2 and read them back: traffic the one-pass TPU kernels
        # do not have
        split = 0
        for (h, w, c, _), n, *own in shapes:
            px, f2 = batch * h * w, 2 * int(c * 2.66)
            split += n * px * 2 * (f2 + c) * 2
            if "ln_gdfn" in (own[0] if own else kernels):
                split += n * px * 2 * f2 * 2
        say(f"{path}: the split tails write and read back {split / 1e9:.2f} GB "
            f"per forward ({split / HBM_BYTES_PER_S * 1e3:.2f} ms at 3.35 TB/s)")
    for path, batch, hw in [("promptir", BATCH, BUCKETS[0]),
                            ("train", TRAIN_BATCH, TRAIN_HW),
                            ("tiled", TILE_CHUNK, (TILE, TILE))]:
        y, skip = seam_inputs(*hw, dtype, gen, batch)
        yc = y.permute(0, 3, 1, 2)  # NCHW views (channels_last) for the library call
        sc = skip.permute(0, 3, 1, 2)
        tot[path]["seam"] = dict(
            ms=time_ms(lambda: seam.seam(y, skip)),
            plain_ms=time_ms(lambda: seam.seam_plain(y, skip)),
            library_ms=time_ms(lambda: torch.cat([F.pixel_shuffle(yc, 2), sc], 1)),
            ops=0, bytes=2 * (y.numel() + skip.numel() + 2 * skip.numel()),
        )
    for path in ("promptir", "tiled", "train_fused"):
        rows = [r for r in tails if r[0] == path]
        say(f"time block_tail per shape of the {path} path's "
            f"{sum(r[3] for r in rows)} blocks (bf16; tail_a on 64 "
            "pixels, then gdfn_out on its tile): " + "; ".join(
                f"B{bt} {sh} x{n} tile {'x'.join(map(str, block.gdfn_out_tile(sh[2])[0]))}"
                f" {ms:.3f} ms (bound {b:.4f} by {by})"
                for _, sh, bt, n, ms, b, by in rows))
    for path in paths:
        rows = [r for r in stats_rows if r[0] == path]
        say(f"time mdta_stats per shape of the {path} path (bf16; route, "
            "tile, slots an image): " + "; ".join(
                f"B{bt} {sh} x{n} {p.route} {p.tile[0]}x{p.tile[1]} "
                f"{p.nslots} {ms:.3f} ms (plain {pms:.3f}, bound {b:.4f} by {by})"
                for _, sh, bt, n, ms, pms, b, by in rows
                for p in [mdta.stats_plan(bt, *sh, dtype)]))
    time_tail_stats(mdta, block, megablock, gen, tot)
    reset()  # the timing launches are not the main path's
    recs = {}
    for k in KERNELS:
        by_path = {}
        for path in tot:
            t = tot[path].get(k)
            if t is None:
                continue
            b, by = bound_ms(t["ops"], t["bytes"], dtype)
            by_path[path] = dict(ms=t["ms"], plain_ms=t["plain_ms"],
                                 bound_ms=b, bound_by=by,
                                 library_ms=t["library_ms"])
            lib = t["library_ms"]
            dev = ""
            if "device_ms" in t:
                by_path[path]["device_ms"] = t["device_ms"]
                dev = f" (device {t['device_ms']:.3f} ms)"
            say(f"time {k:10s} per {path} forward (bf16): "
                f"{t['ms']:.3f} ms{dev}, plain {t['plain_ms']:.3f} ms, library "
                f"{'n/a' if lib is None else f'{lib:.3f} ms'}, bound {b:.4f} "
                f"ms by {by}")
            if k == "mdta_gram":
                # the Gram stage's goal: its launches a forward take no
                # longer than one torch.matmul each of the same q and k
                ld = t["library_device_ms"]
                by_path[path]["library_device_ms"] = ld
                say(f"mdta_gram per {path} forward: {t['ms']:.4f} ms against "
                    f"torch.matmul's {lib:.4f} ms: "
                    + ("at most" if t["ms"] <= lib else "ABOVE") + " it; "
                    f"device {t['device_ms']:.4f} ms against {ld:.4f} ms: "
                    + ("at most" if t["device_ms"] <= ld else "ABOVE") + " it")
        ops = sum(tot[p][k]["ops"] for p in by_path)
        nbytes = sum(tot[p][k]["bytes"] for p in by_path)
        b, by = bound_ms(ops, nbytes, dtype)
        libs = [r["library_ms"] for r in by_path.values()]
        recs[k] = dict(
            ms=sum(r["ms"] for r in by_path.values()),
            plain_ms=sum(r["plain_ms"] for r in by_path.values()),
            bound_ms=b, bound_by=by,
            library_ms=None if None in libs else sum(libs), by_path=by_path)
    return recs


# ----------------------------------------------------------- phase 10

def scene01(hw, seed):
    """A synthetic gradient plus noise (tests/test_cli_eval.py), HWC in
    [0, 1]."""
    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.meshgrid(np.linspace(0, 200, h), np.linspace(0, 200, w),
                         indexing="ij")
    img = np.stack([xx, yy, (xx + yy) / 2], -1) + rng.normal(0, 12, (h, w, 3))
    return (img.clip(0, 255) / 255.0).astype(np.float32)


def png_mixed_filters(rgb):
    """PNG bytes of HWC uint8 RGB with row y under filter y % 5 (None, Sub,
    Up, Average, Paeth in turn), as adaptive encoders (libpng, PIL) mix
    them: what the reader meets in real test sets. The port's own writer
    uses None only."""
    h, w, _ = rgb.shape
    x = rgb.astype(np.int16).reshape(h, 3 * w)
    a, b, c = (np.zeros_like(x) for _ in range(3))
    a[:, 3:], b[1:], c[1:, 3:] = x[:, :-3], x[:-1], x[:-1, :-3]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    f = np.arange(h) % 5
    pred = np.choose(f[:, None], [np.zeros_like(x), a, b, (a + b) >> 1, paeth])
    rows = np.concatenate([f[:, None], (x - pred) & 0xFF], 1).astype(np.uint8)

    def chunk(kind, payload):
        return (struct.pack(">I", len(payload)) + kind + payload
                + struct.pack(">I", zlib.crc32(kind + payload)))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def write_corpus(root):
    """The all-in-one test sets' shapes (H x W) as PNG: BSD68's landscape
    and portrait, two Rain100L pairs, two SOTS-outdoor pairs. After crop-16
    and the flip pad to 64 the forwards run at 320x512, 512x320 and
    448x576. The targets go through the port's save_image (None rows); the
    clean BSD68 images and the degraded inputs are written with every row
    filter (png_mixed_filters) and must read back bit for bit, through
    the C++ reader and its plain version alike. Returns the host's
    milliseconds to read a 481x321 file of each kind (median of 5), through
    the C++ reader and the plain one."""
    from promptir_tpu_torch.utils.image_io import save_image, to_uint8
    from promptir_tpu_torch.utils.png import (
        decode_png,
        decode_png_plain,
        read_png,
    )

    files = [("bsd68/1.png", EVAL_BSD[0], 0), ("bsd68/2.png", EVAL_BSD[1], 1)]
    for i in range(2):
        files += [(f"rain100l/input/rain-{i + 1}.png", EVAL_BSD[0], 10 + i),
                  (f"rain100l/target/rain-{i + 1}.png", EVAL_BSD[0], 20 + i),
                  (f"sots/input/{i + 1:04d}_0.9_0.2.png", EVAL_SOTS, 30 + i),
                  (f"sots/target/{i + 1:04d}.png", EVAL_SOTS, 40 + i)]
    for rel, hw, seed in files:
        path = root / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        if "/target/" in rel:
            save_image(str(path), scene01(hw, seed))
            continue
        u8 = to_uint8(scene01(hw, seed))
        path.write_bytes(png_mixed_filters(u8))
        if not (np.array_equal(read_png(str(path)), u8)
                and np.array_equal(decode_png_plain(path.read_bytes()), u8)):
            fail(f"{rel}: the PNG reader misreads rows of mixed filters")
    ms = {}
    for kind, rel in [("every filter", "bsd68/1.png"),
                      ("save_image's", "rain100l/target/rain-1.png")]:
        data = (root / rel).read_bytes()
        for reader, fn in [("C++", lambda: decode_png(data)),
                           ("plain", lambda: decode_png_plain(data))]:
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t0)
            ms[f"{kind} rows, {reader}"] = sorted(ts)[2] * 1e3
    return ms


@contextlib.contextmanager
def forward_spy():
    """Record each forward of the evaluation runner (eval/runner.py's
    forward_nhwc): its output, copied to the host, and its seconds (the
    card synchronised around it)."""
    from promptir_tpu_torch.eval import runner

    rec = SimpleNamespace(outputs=[], seconds=0.0)
    real = runner.forward_nhwc

    def forward(model, x):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y = real(model, x)
        torch.cuda.synchronize()
        rec.seconds += time.perf_counter() - t0
        rec.outputs.append(y.cpu())
        return y

    with mock.patch.object(runner, "forward_nhwc", forward):
        yield rec


def outputs_apart(rec, rec_p, what):
    """Max |kernel - plain| over the pairs of forwards two evaluation runs
    recorded, and max |plain|."""
    if len(rec.outputs) != len(rec_p.outputs) or not rec.outputs:
        fail(f"{what}: {len(rec.outputs)} forwards through the kernels, "
             f"{len(rec_p.outputs)} plain")
    if not all(torch.isfinite(y).all() for y in rec.outputs):
        fail(f"{what}: non-finite output")
    err = max((y - y0).abs().max().item()
              for y, y0 in zip(rec.outputs, rec_p.outputs))
    return err, max(y0.abs().max().item() for y0 in rec_p.outputs)


def bf16_parity(rec, rec_p, rec32, what):
    """The bf16 runs through the kernels (rec) and the plain route (rec_p)
    against the fp32 run (rec32) through the kernels, forward by forward:
    a line to print; fails unless the kernels' max and mean |difference|
    stay within BF16_MAX_RATIO and BF16_MEAN_RATIO of the plain route's."""
    stats = []
    for r in (rec, rec_p):
        d = [(a - b).abs() for a, b in zip(r.outputs, rec32.outputs)]
        if len(d) != len(rec32.outputs):
            fail(f"{what}: {len(d)} bf16 forwards, {len(rec32.outputs)} fp32")
        stats.append((max(x.max().item() for x in d),
                      sum(x.sum().item() for x in d) / sum(x.numel() for x in d)))
    (mk, ak), (mp, ap) = stats
    if not (mk <= BF16_MAX_RATIO * mp and ak <= BF16_MEAN_RATIO * ap):
        fail(f"{what}: the kernels' bf16 forwards are {mk:.4e} (max) / "
             f"{ak:.4e} (mean) from fp32, the plain route's {mp:.4e} / "
             f"{ap:.4e}")
    return (f"against the fp32 run, max / mean |difference| through the "
            f"kernels {mk:.4e} / {ak:.4e}, through the plain route {mp:.4e} / "
            f"{ap:.4e} (ratios at most {BF16_MAX_RATIO} / {BF16_MEAN_RATIO})")


def per_image(res):
    """[(PSNR, SSIM)] of every image of a cli.test result, set by set."""
    return [m for r in res.values() for m in r["images"].values()]


def xr_per_forward(port, mdta):
    """Launches of KERNELS per forward of the default promptxrestormerir
    (the CLI's config): each X-block runs mdta_stats, block_tail and ln_gdfn
    once, and the Gram kernel where its width and heads take the wide
    route."""
    from promptir_tpu_torch.models.xrestormer import XTransformerBlock

    model = port.create_model("promptxrestormerir", device="cpu")
    blocks = [m for m in model.modules() if isinstance(m, XTransformerBlock)]
    got = sorted((b.norm1.body.weight.numel(), b.channel_attn.num_heads)
                 for b in blocks)
    if got != sorted(s[2:] for s, n in xr_eval_block_shapes(64, 64)
                     for _ in range(n)):
        fail(f"xr_eval_block_shapes is not the default promptxrestormerir's "
             f"(C, heads): {got}")
    wide = sum(mdta.stats_route(b.norm1.body.weight.numel(),
                                b.channel_attn.num_heads) == "wide"
               for b in blocks)
    n = len(blocks)
    return [n, n, n, 0, 0, 0, wide], n


def ca_per_forward(port, mdta, name):
    """Launches of KERNELS per forward of `name`'s default config (the
    CLI's, the JAX defaults): each CA block's channel half mdta_stats and
    block_tail and its spatial FFN ln_gdfn (CATA's hard branch: GDFN, MDTA,
    GDFN), v1's and v2's channel prompt blocks mdta_stats and block_tail,
    the Gram kernel where a width and its heads take the wide route."""
    from promptir_tpu_torch.models.camixer_models import (
        CATABlock,
        CATransformerBlock,
    )
    from promptir_tpu_torch.models.prompt_xrestormer_eff import (
        ChannelTransformerBlock,
    )

    with torch.device("meta"):
        model = port.create_model(name, device="meta")
    ca, channel = [], []
    for m in model.modules():
        if isinstance(m, CATABlock):
            ca.append((m.norm1.body.weight.numel(),
                       m.hard_channel_attn.num_heads))
        elif isinstance(m, (CATransformerBlock, ChannelTransformerBlock)):
            (ca if isinstance(m, CATransformerBlock) else channel).append(
                (m.norm1.body.weight.numel(), m.channel_attn.num_heads))
    wide = sum(mdta.stats_route(c, h) == "wide" for c, h in ca + channel)
    n = len(ca) + len(channel)
    return [n, n, len(ca), 0, 0, 0, wide]


def demo_forwards(hw_list, tile, overlap, chunk):
    """Forwards of the demo's tiled path over images of (H, W) after crop-16
    (eval/tiling.py: the image reflect-padded to 64, tiles in chunks)."""
    from promptir_tpu_torch.eval.padding import target_size
    from promptir_tpu_torch.eval.tiling import tile_positions

    n = 0
    for h, w in hw_list:
        ph, pw = target_size(h, w, 64)
        if h <= tile and w <= tile:
            n += 1
            continue
        tiles = (len(tile_positions(ph, tile, tile - overlap))
                 * len(tile_positions(pw, tile, tile - overlap)))
        n += -(-tiles // chunk)
    return n


def post_png(url, body):
    """POST PNG bytes; (reply bytes, seconds)."""
    import urllib.request

    t0 = time.perf_counter()
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers={"Content-Type": "image/png"})
    with urllib.request.urlopen(req, timeout=600) as r:
        data = r.read()
    return data, time.perf_counter() - t0


def serve_http(root, counters, reset, card):
    """cli/serve.py's server on port 0 in a thread (bf16, max_batch 4): two
    PNG requests (BSD68's two orientations), each reply decoded to its
    input's size, within one uint8 step of engine.restore on the same image
    and within EVAL_STEPS_BF16 of engine.restore through the plain route;
    /stats' compiled_shapes. Returns the launches of the requests."""
    import threading
    import urllib.request

    from promptir_tpu_torch.cli import serve as serve_cli
    from promptir_tpu_torch.utils.png import decode_png, encode_png, read_png

    args = serve_cli.build_parser().parse_args(
        ["--port", "0", "--max_batch", "4", "--dtype", "bfloat16",
         "--device", "cuda", "--ckpt_name", str(root / "promptir.ckpt")])
    httpd, engine = serve_cli.make_server(args)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"

    def restored_u8(im):
        y = engine.restore(im.astype(np.float32) / 255.0)
        return (np.clip(y, 0.0, 1.0) * 255.0).round().astype(int)

    try:
        imgs = [read_png(str(root / "bsd68" / n)) for n in ("1.png", "2.png")]
        batches0 = engine.stats()["batches"]
        reset()
        replies, secs = [], []
        for im in imgs:
            data, s = post_png(url + "/restore", encode_png(im))
            replies.append(decode_png(data, name="reply"))
            secs.append(s)
        ran = counters()
        batches = engine.stats()["batches"] - batches0
        with urllib.request.urlopen(url + "/stats", timeout=60) as r:
            stats = json.loads(r.read())
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            health = json.loads(r.read())
        for im, out in zip(imgs, replies):
            if out.shape != im.shape:
                fail(f"the server replied {out.shape} to a {im.shape} image")
        steps = max(int(np.abs(restored_u8(im) - out).max())
                    for im, out in zip(imgs, replies))
        with plain_route():
            steps_plain = max(int(np.abs(restored_u8(im) - out).max())
                              for im, out in zip(imgs, replies))
    finally:
        httpd.shutdown()
        httpd.server_close()
        engine.close()
        th.join(timeout=60)
    reset()  # the engine.restore comparisons are not the main path
    say(f"eval: serve.py on port 0 (bf16, max_batch 4, {health['backend']}, "
        f"pad_base {health['pad_base']}): POST /restore "
        f"{'x'.join(map(str, imgs[0].shape[:2]))} {secs[0] * 1e3:.1f} ms, "
        f"{'x'.join(map(str, imgs[1].shape[:2]))} {secs[1] * 1e3:.1f} ms "
        f"(round trips, PNG both ways) on {card}; replies at most {steps} uint8 "
        f"step from engine.restore and {steps_plain} from engine.restore "
        f"through the plain route (tolerance {EVAL_STEPS_BF16}); "
        f"compiled_shapes {stats['compiled_shapes']}; launches {LAUNCH_NAMES} "
        f"{ran}")
    if th.is_alive():
        fail("the server thread did not stop")
    if steps > 1 or steps_plain > EVAL_STEPS_BF16 or stats["compiled_shapes"] < 1:
        fail(f"the server's replies are {steps} steps from engine.restore, "
             f"{steps_plain} from the plain route's, compiled_shapes "
             f"{stats['compiled_shapes']}")
    if ran != [n * batches for n in PATHS["promptir"][2]]:
        fail(f"the server launched {ran} != {PATHS['promptir'][2]} x {batches}")
    return ran


def check_niqe(root, restored_dir):
    """NIQE on the host: cli/fit_niqe.py fits the pristine model on six
    clean synthetic 192x192 PNGs written into the corpus; the model scores a
    held-out clean image below its sigma = 50 copy (tests/test_eval.py:163);
    compute_niqe, pointed at the model by PROMPTIR_NIQE_MODEL, scores the
    restored images that cli/test.py dumped, timed."""
    from promptir_tpu_torch.cli import fit_niqe
    from promptir_tpu_torch.data.synthetic import synth_clean_image
    from promptir_tpu_torch.eval import niqe
    from promptir_tpu_torch.eval.metrics import compute_niqe
    from promptir_tpu_torch.utils.png import read_png, write_png

    pristine, path = root / "pristine", root / "niqe_model.npz"
    pristine.mkdir()
    for seed in range(6):
        write_png(str(pristine / f"{seed}.png"), synth_clean_image(seed, 192, 192))
    t0 = time.perf_counter()
    fit_niqe.main([str(pristine), "--out", str(path)])
    fit_s = time.perf_counter() - t0
    model = niqe.load_niqe_model(str(path))
    clean = synth_clean_image(99, 192, 192).astype(np.float64) / 255.0
    noise = np.random.default_rng(1).normal(0, 50 / 255.0, clean.shape)
    s_clean = niqe.niqe(clean, model)
    s_noisy = niqe.niqe(np.clip(clean + noise, 0, 1), model)
    restored = sorted(restored_dir.glob("*.png"))
    with mock.patch.dict(os.environ, {"PROMPTIR_NIQE_MODEL": str(path)}):
        t0 = time.perf_counter()
        scores = [compute_niqe(read_png(str(p)) / 255.0) for p in restored]
        score_s = time.perf_counter() - t0
    shapes = [read_png(str(p)).shape[:2] for p in restored]
    say(f"eval: NIQE: cli.fit_niqe on 6 clean 192x192 PNGs in {fit_s:.2f} s; "
        f"a held-out clean image {s_clean:.4f}, its sigma=50 copy "
        f"{s_noisy:.4f}; compute_niqe of the {len(restored)} restored "
        f"denoise_15 images {shapes}: "
        + ", ".join(f"{v:.4f}" for v in scores)
        + f" in {score_s:.2f} s on the host ({score_s / len(scores):.2f} s an "
        "image)")
    if not (np.isfinite(s_clean) and s_noisy > s_clean):
        fail(f"NIQE does not order the clean image ({s_clean}) below its "
             f"noisy copy ({s_noisy})")
    if len(scores) != 2 or not np.isfinite(scores).all():
        fail(f"compute_niqe of the restored images gave {scores}")


def evaluate(port, mdta, counters, reset, card):
    """Phase 10: the user-facing inference surface on the card, on a
    synthetic corpus at the test sets' sizes with seed-0 full-depth promptir
    weights in the Lightning layout. Every run through the kernels is held
    against the same run through the plain route, forward by forward.
    Returns the launches of its main path: the fp32 and bf16 all-in-one
    runs, the X-Restormer run, the demo and the server."""
    from promptir_tpu_torch.cli import demo as demo_cli
    from promptir_tpu_torch.cli import psnr as psnr_cli
    from promptir_tpu_torch.cli import test as test_cli
    from promptir_tpu_torch.eval.padding import pad_bases
    from promptir_tpu_torch.utils.png import read_png

    t_phase = time.perf_counter()
    root = ROOT / "logs" / "chip_smoke_eval"
    shutil.rmtree(root, ignore_errors=True)
    try:
        read_ms = write_corpus(root)
        say("eval: corpus written, every PNG read bit for bit by the C++ "
            "reader and the plain one; reading a 481x321 PNG on the host: "
            + ", ".join(f"{k} {v:.2f} ms" for k, v in read_ms.items())
            + " (median of 5)")
        seed0_ckpt(port, root / "promptir.ckpt")
        paths = ["--denoise_path", str(root / "bsd68"),
                 "--derain_path", str(root / "rain100l"),
                 "--dehaze_path", str(root / "sots"),
                 "--ckpt_name", str(root / "promptir.ckpt"), "--device", "cuda"]
        total = [0] * len(KERNELS)

        def run(argv, out, plain=False):
            before = counters()
            with forward_spy() as rec, (plain_route() if plain
                                        else contextlib.nullcontext()):
                res = test_cli.main([*argv, "--output_path", str(root / out)])
            torch.cuda.synchronize()
            if plain and counters() != before:
                fail("the plain route launched kernels")
            return res, rec

        # fp32 through the kernels, then the same run through the plain route
        want = [EVAL_FORWARDS * n for n in PATHS["promptir"][2]]
        fp32 = ["--mode", "3", "--dtype", "float32", *paths]
        reset()
        res, rec32 = run(fp32, "out_fp32")
        ran = counters()
        if ran != want:
            fail(f"mode-3 fp32 evaluation launched {ran} != {want}")
        total = [a + b for a, b in zip(total, ran)]
        res_p, rec_p = run(fp32, "out_plain", plain=True)
        m, m_p = per_image(res), per_image(res_p)
        if len(m) != EVAL_FORWARDS or len(m_p) != EVAL_FORWARDS:
            fail(f"mode 3 evaluated {len(m)} and {len(m_p)} images, not "
                 f"{EVAL_FORWARDS}")
        dp = max(abs(a[0] - b[0]) for a, b in zip(m, m_p))
        ds = max(abs(a[1] - b[1]) for a, b in zip(m, m_p))
        err, top = outputs_apart(rec32, rec_p, "mode-3 fp32")
        say("eval: cli.test --mode 3 fp32 (TF32 off), full-depth promptir "
            f"seed-0 weights from a Lightning .ckpt, {EVAL_FORWARDS} images "
            "(forwards at 320x512, 512x320, 448x576): "
            + ", ".join(f"{k} {v['psnr']:.4f} dB / {v['ssim']:.5f}"
                        for k, v in res.items())
            + f"; {sum(r['seconds'] for r in res.values()):.2f} s through the "
            f"kernels, {sum(r['seconds'] for r in res_p.values()):.2f} s plain; "
            f"against the plain route forward by forward: max |difference| "
            f"{err:.3e} (rel {err / top:.3e}, tolerance {GOLDEN_TOL}), image by "
            f"image: max |PSNR difference| {dp:.3e} dB (tolerance "
            f"{EVAL_PSNR_TOL}), max |SSIM difference| {ds:.3e} "
            f"({EVAL_SSIM_TOL}); launches {LAUNCH_NAMES} {ran}")
        if not np.isfinite(m).all():
            fail("non-finite PSNR or SSIM")
        if not (err <= GOLDEN_TOL * top and dp <= EVAL_PSNR_TOL
                and ds <= EVAL_SSIM_TOL):
            fail(f"the kernels' evaluation is off the plain route's by {err:.3e} "
                 f"(max |plain| {top:.3e}), {dp:.3e} dB PSNR, {ds:.3e} SSIM")
        for sub, name, hw in [("denoise_15", "1", EVAL_BSD[0]),
                              ("denoise_15", "2", EVAL_BSD[1]),
                              ("dehaze", "0001_0.9_0.2", EVAL_SOTS)]:
            got = read_png(str(root / "out_fp32" / sub / f"{name}.png")).shape[:2]
            if got != tuple(s // 16 * 16 for s in hw):
                fail(f"{sub}/{name}.png is {got}, not the crop-16 size of {hw}")

        # the offline PSNR of the dumped sigma-15 images against the clean set
        off = psnr_cli.main(["--restored", str(root / "out_fp32" / "denoise_15"),
                             "--gt", str(root / "bsd68"), "--device", "cuda"])
        gap = abs(off["psnr"] - res["denoise_15"]["psnr"])
        say(f"eval: cli.psnr on the dumped denoise_15 PNGs: {off['psnr']:.4f} dB "
            f"/ {off['ssim']:.5f} against the runner's "
            f"{res['denoise_15']['psnr']:.4f} dB: {gap:.4f} dB apart (PNG "
            f"quantization; tolerance {EVAL_OFFLINE_TOL})")
        if not gap <= EVAL_OFFLINE_TOL:
            fail(f"offline PSNR {gap:.4f} dB from the runner's")
        check_niqe(root, root / "out_fp32" / "denoise_15")

        # bf16: a warm-up run of the same images, the timed run, then the
        # same run through the plain route
        bf16 = ["--mode", "3", "--dtype", "bfloat16", *paths]
        run(bf16, "out_bf16")
        reset()
        res, rec = run(bf16, "out_bf16")
        ran = counters()
        if ran != want:
            fail(f"mode-3 bf16 evaluation launched {ran} != {want}")
        total = [a + b for a, b in zip(total, ran)]
        secs = sum(r["seconds"] for r in res.values())
        _, rec_p = run(bf16, "out_bf16_plain", plain=True)
        err, top = outputs_apart(rec, rec_p, "mode-3 bf16")
        parity = bf16_parity(rec, rec_p, rec32, "mode-3 bf16")
        say("eval: cli.test --mode 3 bf16: "
            + ", ".join(f"{k} {v['psnr']:.4f} dB / {v['ssim']:.5f}"
                        for k, v in res.items())
            + f"; {EVAL_FORWARDS} images in {secs:.3f} s after a warm-up run, "
            f"{EVAL_FORWARDS / secs:.2f} images/s (PNG loads and dumps "
            f"included; the forwards {rec.seconds:.3f} s) on {card}; against "
            f"the plain route forward by forward: max |difference| {err:.4e} "
            f"(tolerance {FORWARD_TOL_BF16}, max |plain| {top:.4f}); {parity}; "
            f"launches {LAUNCH_NAMES} {ran}")
        if not err <= FORWARD_TOL_BF16:
            fail(f"the bf16 evaluation is off the plain route's by {err:.4e}")

        # the X-Restormer family: mode 1 (Rain100L), default config, random
        # weights from seed 0: fp32 through the kernels against the plain
        # route (the reference of the bf16 runs), then the bf16 run (the main
        # path) and the same through the plain route
        per_fwd, n_blocks = xr_per_forward(port, mdta)
        xr = ["--mode", "1", "--model", "promptxrestormerir", "--derain_path",
              str(root / "rain100l"), "--device", "cuda"]
        _, rec32 = run([*xr, "--dtype", "float32"], "out_xr_fp32")
        _, rec32_p = run([*xr, "--dtype", "float32"], "out_xr_fp32_plain",
                         plain=True)
        err32, top32 = outputs_apart(rec32, rec32_p, "promptxrestormerir fp32")
        reset()
        res, rec = run([*xr, "--dtype", "bfloat16"], "out_xr")
        ran = counters()
        n = len(rec.outputs)
        _, rec_p = run([*xr, "--dtype", "bfloat16"], "out_xr_plain", plain=True)
        err, top = outputs_apart(rec, rec_p, "promptxrestormerir mode 1")
        parity = bf16_parity(rec, rec_p, rec32, "promptxrestormerir mode 1")
        say(f"eval: cli.test --mode 1 --model promptxrestormerir (default "
            f"config, random weights from seed 0): fp32 through the kernels "
            f"against the plain route forward by forward: max |difference| "
            f"{err32:.3e} (rel {err32 / top32:.3e}, tolerance {GOLDEN_TOL}); bf16 "
            f"derain {res['derain']['psnr']:.4f} dB / "
            f"{res['derain']['ssim']:.5f}, {n} forwards in "
            f"{res['derain']['seconds']:.3f} s, against the plain route: max "
            f"|difference| {err:.4e} (max |plain| {top:.4f}), {parity}; "
            f"{n_blocks} X-blocks, each mdta_stats, block_tail and ln_gdfn "
            f"once, {per_fwd[-1]} on the wide route: {per_fwd} per forward; "
            f"launches {LAUNCH_NAMES} {ran}")
        if n != 2 or ran != [n * k for k in per_fwd]:
            fail(f"the X-Restormer evaluation launched {ran} != {n} x {per_fwd}")
        if not err32 <= GOLDEN_TOL * top32:
            fail(f"the X-Restormer fp32 evaluation is off the plain route's by "
                 f"{err32:.3e} (max |plain| {top32:.3e})")
        total = [a + b for a, b in zip(total, ran)]

        # the attention-free and Uformer families: mode 1 (Rain100L),
        # default config, random weights from seed 0, bf16, a warm-up run
        # then the timed one; no kernel on the path (phase 5 holds their
        # card forwards against the CPU's)
        for name in NO_KERNEL:
            argv = ["--mode", "1", "--model", name, "--derain_path",
                    str(root / "rain100l"), "--device", "cuda", "--dtype",
                    "bfloat16"]
            if name in UFORMER:  # 320x480 (crop-16) to 384x512, not 320x512
                argv += ["--pad_base", str(pad_bases(name)[0])]
            run(argv, f"out_{name}")
            reset()
            res, rec = run(argv, f"out_{name}")
            ran = counters()
            r = res["derain"]
            say(f"eval: cli.test --mode 1 --model {name} bf16 (default config, "
                f"random weights from seed 0): derain {r['psnr']:.4f} dB / "
                f"{r['ssim']:.5f}, {len(rec.outputs)} forwards in "
                f"{r['seconds']:.3f} s after a warm-up run "
                f"({len(rec.outputs) / r['seconds']:.2f} images/s, PNG loads "
                f"and dumps included; the forwards {rec.seconds:.3f} s) on "
                f"{card}; launches {LAUNCH_NAMES} {ran}")
            if len(rec.outputs) != 2 or ran != [0] * len(KERNELS):
                fail(f"the {name} evaluation ran {len(rec.outputs)} forwards "
                     f"and launched {ran}, not 2 and none")
            if not (all(torch.isfinite(y).all() for y in rec.outputs)
                    and np.isfinite(per_image(res)).all()):
                fail(f"the {name} evaluation is not finite")

        # the CAMixer X-Restormers: mode 1 (Rain100L), default config (the
        # JAX defaults, as the CLI builds it), random weights from seed 0,
        # bf16, a warm-up run then the timed one, through the kernels
        for name in CA_XR:
            per_fwd = ca_per_forward(port, mdta, name)
            argv = ["--mode", "1", "--model", name, "--derain_path",
                    str(root / "rain100l"), "--device", "cuda", "--dtype",
                    "bfloat16"]
            run(argv, f"out_{name}")
            reset()
            res, rec = run(argv, f"out_{name}")
            ran = counters()
            r = res["derain"]
            shapes = sorted({tuple(y.shape[1:3]) for y in rec.outputs})
            say(f"eval: cli.test --mode 1 --model {name} bf16 (default config, "
                f"random weights from seed 0, padded to {shapes}): derain "
                f"{r['psnr']:.4f} dB / {r['ssim']:.5f}, {len(rec.outputs)} "
                f"forwards in {r['seconds']:.3f} s after a warm-up run "
                f"({len(rec.outputs) / r['seconds']:.2f} images/s, PNG loads "
                f"and dumps included; the forwards {rec.seconds:.3f} s) on "
                f"{card}; {per_fwd} per forward; launches {LAUNCH_NAMES} {ran}")
            if len(rec.outputs) != 2 or ran != [2 * k for k in per_fwd]:
                fail(f"the {name} evaluation ran {len(rec.outputs)} forwards "
                     f"and launched {ran}, not 2 x {per_fwd}")
            if not (all(torch.isfinite(y).all() for y in rec.outputs)
                    and np.isfinite(per_image(res)).all()):
                fail(f"the {name} evaluation is not finite")
            total = [a + b for a, b in zip(total, ran)]

        # the demo, plain and tiled, bf16, each against the same demo through
        # the plain route
        crops = [tuple(s // 16 * 16 for s in hw) for hw in EVAL_BSD]
        names = ("1.png", "2.png")
        for extra, forwards in [
                ([], len(crops)),
                (["--tile", "--tile_size", str(TILE), "--tile_overlap",
                  str(TILE_OVERLAP)], demo_forwards(crops, TILE, TILE_OVERLAP, 8))]:
            out = root / ("demo_tiled" if extra else "demo")
            argv = ["--test_path", str(root / "bsd68"), "--dtype", "bfloat16",
                    "--ckpt_name", str(root / "promptir.ckpt"), "--device",
                    "cuda", *extra]
            reset()
            t0 = time.perf_counter()
            demo_cli.main([*argv, "--output_path", str(out)])
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            ran = counters()
            with plain_route():
                demo_cli.main([*argv, "--output_path", f"{out}_plain"])
            if counters() != ran:
                fail("the plain route launched kernels")
            imgs = [read_png(str(out / k)) for k in names]
            steps = max(int(np.abs(a.astype(int) - read_png(
                f"{out}_plain/{k}")).max()) for a, k in zip(imgs, names))
            sizes = [a.shape[:2] for a in imgs]
            say(f"eval: cli.demo {' '.join(extra) or 'plain'} bf16 on the two "
                f"BSD68-shaped images: outputs {sizes} in {secs:.2f} s (model "
                f"load included), at most {steps} uint8 steps from the plain "
                f"route's (tolerance {EVAL_STEPS_BF16}); {forwards} forwards, "
                f"launches {LAUNCH_NAMES} {ran}")
            if sizes != crops:
                fail(f"the demo wrote {sizes}, not {crops}")
            if steps > EVAL_STEPS_BF16:
                fail(f"the demo's images are {steps} steps from the plain "
                     "route's")
            if ran != [forwards * k for k in PATHS["promptir"][2]]:
                fail(f"the demo launched {ran} != {forwards} x "
                     f"{PATHS['promptir'][2]}")
            total = [a + b for a, b in zip(total, ran)]

        total = [a + b for a, b in zip(
            total, serve_http(root, counters, reset, card))]
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say(f"eval: phase 10 took {time.perf_counter() - t_phase:.1f} s; launches "
        f"{LAUNCH_NAMES} {total}")
    return total


# ----------------------------------------------------------- phase 11

def bmp_bytes(rgb):
    """A 24-bit bottom-up BI_RGB BMP of HWC uint8 RGB, rows padded to 4
    bytes, as image tools write them."""
    h, w, _ = rgb.shape
    stride = (3 * w + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :3 * w] = rgb[::-1, :, ::-1].reshape(h, 3 * w)
    info = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, stride * h, 2835,
                       2835, 0, 0)
    return (b"BM" + struct.pack("<IHHI", 54 + stride * h, 0, 0, 54) + info
            + rows.tobytes())


def check_jpeg_fixtures():
    """Decode every committed JPEG fixture on the host with the port's
    decoder and hold it bit for bit against PIL's decode stored beside it
    (tests/torch_fixtures/jpeg/decodes.npz: the array, or for the 550x413
    haze pair its SHA-256). Returns the files checked."""
    import hashlib

    from promptir_tpu_torch.utils.jpeg import read_jpeg

    with np.load(JPEG_FIXTURES / "decodes.npz") as z:
        want = {k: z[k] for k in z.files}
    names = sorted(k.split(":", 1)[-1] for k in want if not k.startswith("shape:"))
    for rel in names:
        got = read_jpeg(str(JPEG_FIXTURES / rel))
        if rel in want:
            same = np.array_equal(got, want[rel])
        else:
            same = (list(got.shape) == list(want["shape:" + rel]) and
                    hashlib.sha256(got.tobytes()).hexdigest()
                    == str(want["sha256:" + rel]))
        if not same:
            fail(f"the JPEG decoder disagrees with PIL's decode of {rel}")
    return names


def write_train_corpus(root):
    """The reference's training layout (tests/test_data_pipeline.py:36-61)
    at BSD68's size: two denoise images (a PNG with every row filter, a
    BMP), one rain pair as PNG with every row filter, the committed 550x413
    JPEG haze pair; a two-image BSD68-like and a one-pair Rain100L-like set
    for the epoch-end evaluation. 2 x 9 + 120 + 1 samples."""
    from promptir_tpu_torch.utils.image_io import to_uint8

    lists = {"noisy/denoise.txt": "a.png\nb.bmp\n",
             "rainy/rainTrain.txt": "rainy/rain-1.png\n",
             "hazy/hazy_outside.txt": "synthetic/0001_0.8_0.2.jpg\n"}
    for rel, text in lists.items():
        (root / "data_dir" / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / "data_dir" / rel).write_text(text)
    u8 = lambda seed: to_uint8(scene01(TRAIN_CLI_HW, seed))  # noqa: E731
    files = {"denoise/a.png": png_mixed_filters(u8(50)),
             "denoise/b.bmp": bmp_bytes(u8(51)),
             "derain/rainy/rain-1.png": png_mixed_filters(u8(52)),
             "derain/gt/norain-1.png": png_mixed_filters(u8(53)),
             "bsd/1.png": png_mixed_filters(u8(54)),
             "bsd/2.png": png_mixed_filters(u8(55)),
             "rain100l/input/rain-1.png": png_mixed_filters(u8(56)),
             "rain100l/target/rain-1.png": png_mixed_filters(u8(57))}
    for rel, data in files.items():
        (root / rel).parent.mkdir(parents=True, exist_ok=True)
        (root / rel).write_bytes(data)
    shutil.copytree(JPEG_FIXTURES / "dehaze", root / "dehaze")


@contextlib.contextmanager
def step_spy(counters):
    """Record each train step that cli/train.py's Trainer runs: the
    launches, the CUDA-event ms, the loss, the host clock at its start and
    end (the card synchronised after each step) and the host seconds until
    the step had been enqueued; each sample's `get` in the loader's threads
    ({de_type: [ms]}); and the seconds of the profiler window's close (its
    trace export)."""
    from promptir_tpu_torch.data.datasets import PromptTrainDataset
    from promptir_tpu_torch.train import trainer as trainer_mod

    rec = SimpleNamespace(ran=[], ms=[], loss=[], start=[], end=[], host=[],
                          get={}, export_s=[])
    real = trainer_mod.make_train_step
    real_get = PromptTrainDataset.get
    real_close = trainer_mod.ProfilerWindow.close

    def make(model, *args, **kwargs):
        fn = real(model, *args, **kwargs)

        def step(state, batch):
            rec.start.append(time.perf_counter())
            before = counters()
            t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0.record()
            metrics = fn(state, batch)
            t1.record()
            rec.host.append(time.perf_counter() - rec.start[-1])
            torch.cuda.synchronize()
            rec.ran.append([a - b for a, b in zip(counters(), before)])
            rec.ms.append(t0.elapsed_time(t1))
            rec.loss.append(metrics["train_loss"].item())
            rec.end.append(time.perf_counter())
            return metrics

        return step

    def get(self, idx, rng):
        t0 = time.perf_counter()
        out = real_get(self, idx, rng)
        rec.get.setdefault(out[0], []).append((time.perf_counter() - t0) * 1e3)
        return out

    def close(self):
        t0, had = time.perf_counter(), self.prof is not None
        real_close(self)
        if had:
            rec.export_s.append(time.perf_counter() - t0)

    with mock.patch.object(trainer_mod, "make_train_step", make), \
            mock.patch.object(PromptTrainDataset, "get", get), \
            mock.patch.object(trainer_mod.ProfilerWindow, "close", close):
        yield rec


def per_task_alone(dataset, n=3):
    """{de_type: ms of one sample alone, median of up to n, no other thread
    running}."""
    alone = {}
    for i, smp in enumerate(dataset.samples):
        if len(alone.setdefault(smp.de_type, [])) < n:
            t0 = time.perf_counter()
            dataset.get(i, np.random.default_rng(i))
            alone[smp.de_type].append((time.perf_counter() - t0) * 1e3)
    return {k: float(np.median(v)) for k, v in alone.items()}


def loader_epoch(dataset):
    """The training loader with no model (its default four threads) over
    a whole epoch of the corpus. Returns (seconds, samples, {de_type: [ms
    of each sample's get in its thread]}, {de_type: ms of one sample
    alone})."""
    from promptir_tpu_torch.data.loader import TrainLoader

    per_task = {}
    alone = per_task_alone(dataset)
    real = dataset.get

    def get(i, rng):
        t0 = time.perf_counter()
        out = real(i, rng)
        per_task.setdefault(out[0], []).append((time.perf_counter() - t0) * 1e3)
        return out

    loader = TrainLoader(dataset, batch_size=TRAIN_BATCH, seed=0,
                         pin_memory=True)
    with mock.patch.object(dataset, "get", get):
        t0 = time.perf_counter()
        n = sum(1 for _ in loader.epoch(0)) * TRAIN_BATCH
        dt = time.perf_counter() - t0
    if n != len(dataset) // TRAIN_BATCH * TRAIN_BATCH:
        fail(f"the loader made {n} of {len(dataset)} samples")
    return dt, n, per_task, alone


def check_native_loader(root):
    """The corpus through the native library on the host: every PNG
    decoded by the C++ reader equals the plain decoder's; each paired
    sample (the rain and haze pairs) equals the numpy crop and dihedral,
    and each denoise sample's clean patch too, at every mode. Returns the
    files and samples checked."""
    from promptir_tpu_torch.data import native
    from promptir_tpu_torch.data.augment import crop_to_multiple, dihedral
    from promptir_tpu_torch.utils.image_io import read_image
    from promptir_tpu_torch.utils.png import decode_png, decode_png_plain

    pngs = sorted(root.rglob("*.png"))
    for path in pngs:
        data = path.read_bytes()
        if not np.array_equal(decode_png(data), decode_png_plain(data)):
            fail(f"{path.relative_to(root)}: the C++ PNG reader disagrees "
                 "with the plain one")
    p = TRAIN_HW[0]
    rng = np.random.default_rng(0)
    pairs = [("derain/rainy/rain-1.png", "derain/gt/norain-1.png"),
             ("dehaze/synthetic/0001_0.8_0.2.jpg", "dehaze/original/0001.jpg")]
    checked = 0
    for mode in range(8):
        for d, c in pairs:
            di, ci = (crop_to_multiple(read_image(str(root / f)), 16)
                      for f in (d, c))
            i = int(rng.integers(0, di.shape[0] - p + 1))
            j = int(rng.integers(0, di.shape[1] - p + 1))
            got = native.prepare_paired_sample(di, ci, i, j, p, mode)
            for g, img in zip(got, (di, ci)):
                want = dihedral(img[i:i + p, j:j + p], mode)
                if not np.array_equal(g, want.astype(np.float32) / 255.0):
                    fail(f"prepare_paired_sample differs from the numpy crop "
                         f"and dihedral ({d}, mode {mode})")
            checked += 1
        for f in ("denoise/a.png", "denoise/b.bmp"):
            img = crop_to_multiple(read_image(str(root / f)), 16)
            i = int(rng.integers(0, img.shape[0] - p + 1))
            j = int(rng.integers(0, img.shape[1] - p + 1))
            _, clean = native.prepare_denoise_sample(img, i, j, p, mode, 25.0,
                                                     int(rng.integers(2**62)))
            want = dihedral(img[i:i + p, j:j + p], mode)
            if not np.array_equal(clean, want.astype(np.float32) / 255.0):
                fail(f"prepare_denoise_sample's clean patch differs from the "
                     f"numpy crop and dihedral ({f}, mode {mode})")
            checked += 1
    return len(pngs), checked


def train_cli(counters, reset, card):
    """Phase 11: cli/train.py on the card over a corpus of the five tasks
    in the reference's layout (PNG, BMP and JPEG), full-depth promptir, bf16
    compute, B6 128x128: one epoch with the epoch-end evaluation and the
    profiler window, then `--epochs 2 --resume latest`. Returns the
    launches of both runs."""
    import json as json_mod

    from promptir_tpu_torch.cli import train as train_cli_mod
    from promptir_tpu_torch.data.datasets import PromptTrainDataset
    from promptir_tpu_torch.train.trainer import PROFILE_STEPS
    from promptir_tpu_torch.utils.bmp import read_bmp
    from promptir_tpu_torch.utils.jpeg import read_jpeg

    t_phase = time.perf_counter()
    names = check_jpeg_fixtures()
    root = ROOT / "logs" / "chip_smoke_train"
    shutil.rmtree(root, ignore_errors=True)
    try:
        write_train_corpus(root)
        jpg = root / "dehaze" / "synthetic" / "0001_0.8_0.2.jpg"
        ms = {}
        for kind, fn, path in [("JPEG 550x413", read_jpeg, jpg),
                               ("BMP 481x321", read_bmp, root / "denoise" / "b.bmp")]:
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn(str(path))
                ts.append(time.perf_counter() - t0)
            ms[kind] = sorted(ts)[2] * 1e3
        say(f"train_cli: {len(names)} committed JPEG fixtures (the corpus' "
            "haze pair among them) decode bit for bit as PIL's stored decode; "
            "decode on the host " + ", ".join(
                f"{k} {v:.2f} ms" for k, v in ms.items()) + " (median of 5)")
        n_png, n_samples = check_native_loader(root)
        say(f"train_cli: the native library on the host: the corpus' {n_png} "
            "PNGs read by the C++ reader bit for bit as by the plain one; "
            f"{n_samples} samples (the rain and haze pairs, the PNG and BMP "
            "denoise images, 8 modes) equal the numpy crop and dihedral")
        argv = ["--dtype", "bfloat16", "--batch_size", str(TRAIN_BATCH),
                "--patch_size", str(TRAIN_HW[0]),
                "--data_file_dir", f"{root}/data_dir/",
                "--denoise_dir", f"{root}/denoise/",
                "--derain_dir", f"{root}/derain/",
                "--dehaze_dir", f"{root}/dehaze/",
                "--eval_denoise_path", str(root / "bsd"),
                "--eval_derain_path", str(root / "rain100l"),
                "--ckpt_dir", str(root / "ckpt"), "--log_dir", str(root / "logs")]
        # eval: 2 BSD68-like images at sigma 15 and 1 Rain100L-like pair,
        # B1 forwards at 320x512 after crop-16 and the flip pad to 64
        eval_launches = [3 * n for n in PATHS["promptir"][2]]
        total = [0] * len(KERNELS)
        runs = []
        for extra in (["--epochs", "1", "--profile_dir", str(root / "prof")],
                      ["--epochs", "2", "--resume", "latest"]):
            reset()
            t0 = time.perf_counter()
            with step_spy(counters) as rec:
                trainer = train_cli_mod.main(argv + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ran = counters()
            runs.append((trainer, rec, wall))
            if len(trainer.dataset) != TRAIN_CLI_SAMPLES:
                fail(f"the corpus gave {len(trainer.dataset)} samples, not "
                     f"{TRAIN_CLI_SAMPLES}")
            if len(rec.ran) != TRAIN_CLI_STEPS:
                fail(f"an epoch ran {len(rec.ran)} steps, not {TRAIN_CLI_STEPS}")
            for i, r in enumerate(rec.ran):
                if r != TRAIN_PER_STEP:
                    fail(f"cli/train.py step {i} launched {r} != {TRAIN_PER_STEP}")
            want = [TRAIN_CLI_STEPS * a + b
                    for a, b in zip(TRAIN_PER_STEP, eval_launches)]
            if ran != want:
                fail(f"cli/train.py launched {ran} != {want} (steps and the "
                     "epoch-end evaluation)")
            if not all(np.isfinite(rec.loss)):
                fail(f"cli/train.py gave a loss that is not finite: {rec.loss}")
            total = [a + b for a, b in zip(total, ran)]
        (first, rec1, wall1), (second, rec2, wall2) = runs
        if second.start_epoch != 1 or second.global_step != 2 * TRAIN_CLI_STEPS:
            fail(f"the resumed run started at epoch {second.start_epoch}, "
                 f"step {second.global_step - TRAIN_CLI_STEPS}")
        if second.ckpt.all_epochs() != [0, 1]:
            fail(f"checkpoints {second.ckpt.all_epochs()}, not [0, 1]")
        trace = root / "prof" / "train_steps_2-7.pt.trace.json"
        if not trace.exists():
            fail("the profiler window wrote no trace")
        with open(root / "logs" / "metrics.jsonl") as f:
            recs = [json_mod.loads(line) for line in f]
        evals = [r for r in recs if "eval_psnr_denoise15" in r]
        keys = ("eval_psnr_denoise15", "eval_ssim_denoise15",
                "eval_psnr_derain", "eval_ssim_derain")
        if len(evals) != 2 or not all(np.isfinite(r[k]) for r in evals
                                      for k in keys):
            fail(f"metrics.jsonl holds {len(evals)} evaluations, not 2 with "
                 f"{keys}")
        # steps kept: the first run's after the profiler window (its steps
        # [2, 7) run under torch.profiler), the resumed run's after 2 warm-up
        lo, hi = PROFILE_STEPS
        kept = [(rec1, hi), (rec2, lo)]
        step_ms = float(np.median([m for r, k in kept for m in r.ms[k:]]))
        # the host waits between the end of a step and the start of the next
        # for the loader and the trainer's own work (after step hi - 1 of the
        # first run: the profiler's trace export, timed); within a step, it
        # enqueues the work (host) while the loader's threads hold the GIL
        gap_export = rec1.start[hi] - rec1.end[hi - 1]
        gaps = [b - a for r in (rec1, rec2) for a, b in zip(r.end, r.start[1:])]
        gaps.remove(gap_export)
        epoch_s = [r.end[-1] - r.start[0] for r in (rec1, rec2)]
        wall_ms = [(b - a) * 1e3 for r, k in kept
                   for a, b in list(zip(r.start, r.end))[k:]]
        host_ms = [h * 1e3 for r, k in kept for h in r.host[k:]]
        quart = lambda v: "/".join(  # noqa: E731
            f"{x:.1f}" for x in np.percentile(v, [25, 50, 75, 100]))
        say(f"train_cli: cli/train.py, full-depth promptir bf16, "
            f"{TRAIN_CLI_SAMPLES} samples (2 x 9 denoise over PNG and BMP, "
            f"120 rain PNG pairs, 1 JPEG haze pair) in {TRAIN_CLI_STEPS} "
            f"steps of B{TRAIN_BATCH} {TRAIN_HW[0]}x{TRAIN_HW[1]} an epoch: "
            f"losses {rec1.loss[0]:.5f} .. {rec2.loss[-1]:.5f}, all finite; "
            f"step {step_ms:.1f} ms (median of CUDA events over "
            f"{len(wall_ms)} steps: the first run's profiled steps [{lo}, {hi}) "
            f"and its warm-up, the resumed run's {lo} warm-up left out), "
            f"{TRAIN_BATCH * 1e3 / step_ms:.2f} images/s; a step's host wall "
            f"p25/p50/p75/max {quart(wall_ms)} ms, until enqueued "
            f"{quart(host_ms)} ms; an epoch's steps {epoch_s[0]:.2f} / "
            f"{epoch_s[1]:.2f} s (first / resumed run), "
            f"{TRAIN_CLI_STEPS * TRAIN_BATCH / epoch_s[1]:.2f} images/s end to "
            f"end; the profiler's trace export {rec1.export_s[0]:.2f} s of the "
            f"{gap_export:.2f} s gap after step {hi - 1}; the host waited "
            f"between the other steps {sum(gaps):.2f} s in all (median "
            f"{np.median(gaps) * 1e3:.1f} ms, max {max(gaps) * 1e3:.1f}); runs "
            f"{wall1:.1f} / {wall2:.1f} s with model build and evaluation; eval "
            f"PSNR denoise15 / derain {evals[-1]['eval_psnr_denoise15']:.4f} / "
            f"{evals[-1]['eval_psnr_derain']:.4f} dB; checkpoints "
            f"{second.ckpt.all_epochs()}, resumed at epoch {second.start_epoch}"
            f"; trace {trace.stat().st_size} bytes; on {card}")
        kw = dict(data_file_dir=f"{root}/data_dir/",
                  denoise_dir=f"{root}/denoise/", derain_dir=f"{root}/derain/",
                  dehaze_dir=f"{root}/dehaze/", patch_size=TRAIN_HW[0])
        dt, n, per_task, alone = loader_epoch(PromptTrainDataset(**kw))
        alone_numpy = per_task_alone(PromptTrainDataset(use_native=False, **kw))
        rate = n / dt
        end_to_end = TRAIN_CLI_STEPS * TRAIN_BATCH / epoch_s[1]
        in_training = {}
        for r in (rec1, rec2):
            for k, v in r.get.items():
                in_training.setdefault(k, []).extend(v)
        got = [m for v in in_training.values() for m in v]
        capacity = 4 * 1e3 * len(got) / sum(got)
        tasks = {0: "denoise_15 (PNG, BMP)", 1: "denoise_25", 2: "denoise_50",
                 3: "derain (2 PNG)", 4: "dehaze (2 JPEG)"}
        need = TRAIN_BATCH * 1e3 / step_ms
        med = lambda d: ", ".join(  # noqa: E731
            f"{tasks[k]} {np.median(v):.1f} ({len(v)})" for k, v in sorted(d.items()))
        say(f"train_cli: the native loader alone (4 threads, no model) over "
            f"an epoch: {n} samples in {dt:.2f} s, {rate:.1f} samples/s against "
            f"the step's {need:.1f} images/s: "
            + ("keeps up" if rate >= need else
               f"starves the card ({need / rate:.2f}x too slow)")
            + f"; per sample in its thread, median ms (count): {med(per_task)}"
            + "; one sample alone on one thread, median ms: " + ", ".join(
                f"{tasks[k]} {v:.1f}" for k, v in sorted(alone.items()))
            + "; the numpy path (use_native=False) alone: " + ", ".join(
                f"{tasks[k]} {v:.1f}" for k, v in sorted(alone_numpy.items()))
            + f"; during the two training runs, per sample in its thread: "
            f"{med(in_training)}, so 4 threads make {capacity:.1f} samples/s "
            f"(4 x 1000 / the mean ms); on {card}")
        say(f"train_cli: end to end {end_to_end:.2f} images/s (the resumed "
            f"run's epoch) against {need:.2f} at the step's median: "
            f"{end_to_end / need:.2f} of it (0.8 or more wanted: the loader "
            f"then no longer starves the card)")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    say(f"train_cli: phase 11 took {time.perf_counter() - t_phase:.1f} s; "
        f"launches {LAUNCH_NAMES} {total}")
    return total


def train_cli_mode(counters, card, label, flags, per_step):
    """cli/train.py --synthetic for one epoch with the JAX trainer's memory
    flags: full-depth promptir, bf16, B6 128x128 (64 synthetic patches, 10
    steps, the short last batch dropped); exact launches a step, finite
    losses.
    Returns the launches."""
    from promptir_tpu_torch.cli import train as train_cli_mod

    root = ROOT / "logs" / "chip_smoke_train_mode"
    shutil.rmtree(root, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        with step_spy(counters) as rec:
            trainer = train_cli_mod.main(
                ["--synthetic", "--epochs", "1", "--dtype", "bfloat16",
                 "--batch_size", str(TRAIN_BATCH), "--patch_size",
                 str(TRAIN_HW[0]), "--ckpt_dir", str(root / "ckpt"),
                 "--log_dir", str(root / "logs"), *flags])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        shutil.rmtree(root, ignore_errors=True)
    ran = counters()
    steps = len(trainer.dataset) // TRAIN_BATCH
    step_ms = float(np.median(rec.ms[TRAIN_WARMUP:]))
    say(f"train_cli {' '.join(flags)}: cli/train.py --synthetic, full-depth "
        f"promptir bf16, {len(trainer.dataset)} patches in {len(rec.ran)} steps "
        f"of B{TRAIN_BATCH} {TRAIN_HW[0]}x{TRAIN_HW[1]}: losses "
        f"{rec.loss[0]:.5f} .. {rec.loss[-1]:.5f}; step {step_ms:.1f} ms "
        f"(median of CUDA events, {TRAIN_WARMUP} warm-up left out), "
        f"{TRAIN_BATCH * 1e3 / step_ms:.2f} images/s; run "
        f"{wall:.1f} s with model build; launches {LAUNCH_NAMES} a step "
        f"{per_step}, {ran} in all on {card}")
    if len(rec.ran) != steps or not all(r == per_step for r in rec.ran):
        fail(f"cli/train.py {' '.join(flags)} launched {rec.ran}, not "
             f"{steps} x {per_step}")
    if ran != [steps * n for n in per_step]:
        fail(f"cli/train.py {' '.join(flags)} launched {ran} in all")
    if not all(np.isfinite(rec.loss)):
        fail(f"cli/train.py {' '.join(flags)} gave losses {rec.loss}")
    return ran


# ----------------------------------------------------------- phase 12

def seed0_ckpt(port, path):
    """Full-depth promptir's seed-0 weights on the card, saved as a
    Lightning .ckpt (`net.` keys); returns its state dict on the CPU."""
    torch.manual_seed(0)
    model = port.create_model("promptir", device="cuda")
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    torch.save({"state_dict": {"net." + k: v for k, v in sd.items()}}, path)
    return sd


def run_tool(label, main, argv):
    """A tool's main(argv) with its printed lines said, indented (a bare
    JSON line of the smoke is only its last two); returns its result."""
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            out = main(argv)
    except SystemExit as e:
        fail(f"{label} exited {e.code}")
    finally:
        for line in buf.getvalue().splitlines():
            print("    " + line, flush=True)
    say(f"tools: {label} done")
    return out


def check_split(label, line):
    """profile_train's gates: the step's ranges hold SPLIT_SHARE of its
    device time; its forward SPLIT_SHARE of the port's kernels' time."""
    parts, held = line["parts_ms"], line["kernels_in_forward"] or 0.0
    say(f"tools: {label} split ms a step ({line['dtype']} B{line['batch']} "
        f"{line['size']}x{line['size']}, window {line['window_ms_per_step']:.2f}"
        f" ms, device {line['device_ms_per_step']:.2f} ms, idle "
        f"{line['idle']:.1%}): " + ", ".join(
            f"{k} {v:.2f}" for k, v in parts.items())
        + f"; ranges hold {line['in_ranges']:.2%} of the device time, the "
        f"forward {held:.2%} of the kernels'")
    if line["in_ranges"] < SPLIT_SHARE:
        fail(f"{label}: the step's ranges hold {line['in_ranges']:.2%} of its "
             f"device time (< {SPLIT_SHARE:.0%})")
    if held < SPLIT_SHARE:
        fail(f"{label}: the forward holds {held:.2%} of the kernels' device "
             "time")


def tools_phase(port, counters, reset):
    """Phase 12: the instruments on the card. cli.summary of promptir at B1
    256x256, kbench at KBENCH, profile_forward, profile_train (default and
    --fused, SPLIT_SHARE gated), tbench at B6 128x128, sbench for 10 s,
    shape_sweep over its grid (its gates), cli.convert of the seed-0 .ckpt
    (read back bit for bit), and OPTION_CHECKS against the CPU."""
    from promptir_tpu_torch.cli import convert, summary
    from promptir_tpu_torch.compat.jax_params import (
        load_params_npz,
        state_dict_from_flax,
    )
    from promptir_tpu_torch.tools import (
        kbench,
        profile_forward,
        profile_train,
        sbench,
        shape_sweep,
        tbench,
    )

    t_phase = time.perf_counter()
    cost = run_tool("cli.summary", summary.main,
                    ["--model", "promptir", "--size", "256"])
    ratio = cost["flops"] / (16 * 21_592_952_384)
    say(f"tools: promptir B1 256x256 {cost['params']} params, "
        f"{cost['flops']} FLOPs ({ratio:.5f} of 16 x the 64x64 count), "
        f"{cost['bytes_accessed']} bytes, peak {cost['peak_memory_mb']} MB")
    if (cost["params"] != PROMPTIR_PARAMS or abs(ratio - 1) > 1e-3
            or not cost["peak_memory_mb"]):
        fail(f"cli.summary gave {cost}")
    for op, shape, heads in KBENCH:
        line = run_tool(f"kbench {op}", kbench.main, [
            "--op", op, "--shape", *map(str, shape), "--heads", str(heads),
            "--reps", "20"])
        if not (line["ms"] > 0 and line["bound_ms"] > 0):
            fail(f"kbench {op}: {line}")
    line = run_tool("profile_forward", profile_forward.main, ["--iters", "3"])
    say(f"tools: promptir B4 256x256 bf16 forward {line['forward_ms']:.2f} ms, "
        f"device {line['device_ms']:.2f} ms ({line['kernels_ms']:.2f} in the "
        f"kernels), idle {line['idle']:.1%}; ranges hold "
        f"{line['in_ranges']:.2%}; by group: " + ", ".join(
            f"{k} {v:.2f}" for k, v in line["groups_ms"].items()))
    if line["in_ranges"] < SPLIT_SHARE or not line["kernels_ms"] > 0:
        fail(f"profile_forward: ranges {line['in_ranges']}, kernels "
             f"{line['kernels_ms']} ms")
    for flags in ([], ["--fused"]):
        label = " ".join(["profile_train", *flags])
        check_split(label, run_tool(label, profile_train.main,
                                    ["--iters", "2", *flags]))
    line = run_tool("tbench", tbench.main, ["--steps", "5", "--warmup", "2"])
    if not line["loss_last"] < line["loss_first"]:
        fail(f"tbench: the loss did not fall: {line}")
    line = run_tool("sbench", sbench.main, ["--seconds", "10"])
    if line["errors"] or line["rejected"] or line["timed_out"]:
        fail(f"sbench: {line}")
    run_tool("shape_sweep", shape_sweep.main, [])
    root = ROOT / "logs" / "chip_smoke_tools"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    try:
        sd = seed0_ckpt(port, root / "promptir.ckpt")
        run_tool("cli.convert", convert.main, [str(root / "promptir.ckpt"),
                                               str(root / "promptir.npz")])
        with torch.device("meta"):
            meta = port.create_model("promptir", device="meta")
        back = state_dict_from_flax(load_params_npz(str(root / "promptir.npz")),
                                    meta)
        if sorted(back) != sorted(sd) or not all(
                torch.equal(back[k], sd[k]) for k in sd):
            fail("cli.convert's .npz does not read back as the .ckpt")
        say(f"tools: cli.convert wrote {len(back)} tensors, read back bit for "
            "bit")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for label, (name, kwargs, shape) in OPTION_CHECKS.items():
        say(f"tools: {label}")
        check_against_cpu(port, counters, reset, name, kwargs, shape)
    reset()  # the tools' launches are not a main path's
    say(f"tools: phase 12 took {time.perf_counter() - t_phase:.1f} s")


# ----------------------------------------------------------- phase 13

# phase 13's sharded forward and TP shapes: promptir fp32 B1 256x256 split
# in two stripes; GDFN at promptir's level-1 and latent widths, MDTA at its
# level-2 width (level 1 has one head, which two ranks cannot split) and at
# the latent's, each at the rows of a 256x256 image's level
SPATIAL_HW = (256, 256)
TP_CASES = {  # label: (module, constructor arguments, input NCHW shape)
    "gdfn 48 (level 1)": ("gdfn", (48,), (1, 48, 256, 256)),
    "gdfn 384 (latent)": ("gdfn", (384,), (1, 384, 32, 32)),
    "mdta 96, 2 heads (level 2)": ("mdta", (96, 2), (1, 96, 128, 128)),
    "mdta 384, 8 heads (latent)": ("mdta", (384, 8), (1, 384, 32, 32)),
}
DP_STEPS = 3  # the NCCL world of one: steps with and without the group
RANK_TIMEOUT_S = 600
# (c): the sharded forwards of the other eleven models, full width and
# depth at their JAX defaults, the X-Restormers and CAMixer X-Restormers in
# the training config (PATHS'), the CA models at ratio and hard ratio 0.5;
# NAFBlock's beta and gamma seeded (seeded_scales), or NAFNet is the
# identity
SPATIAL_FAMILIES = {
    "xrestormerir": XR_TRAIN, "promptxrestormerir": XR_TRAIN, EFF: XR_TRAIN,
    "easypromptxrestormer": {}, "nafnet": {}, "nafnetlocal": {},
    "promptuformerir": {}, "capromptuformerir": {},
    **{name: XR_TRAIN for name in CA_XR}}
# (d): the stochastic models' DP steps in their training config, and their
# launches a step (phase 7's)
STOCHASTIC = ("capromptuformerir",) + CA_XR
STOCHASTIC_KW = {"capromptuformerir": {}, **{n: XR_TRAIN for n in CA_XR}}
STOCHASTIC_PER_STEP = {"capromptuformerir": [0] * len(KERNELS),
                       **CA_TRAIN_PER_STEP}


def rank_kernels():
    """The kernel wrappers in KERNELS' order, imported in a rank."""
    from promptir_tpu_torch.ops.cuda import block, gdfn, mdta, megablock, seam

    return (mdta.mdta_stats, block.block_tail, gdfn.ln_gdfn, seam.seam,
            mdta.ln_mdta, megablock.tail_stats, mdta.mdta_gram)


def rank_counts():
    return [k.launches for k in rank_kernels()]


def train_batch(rows=slice(None)):
    """Phase 7's fixed batch (B6 128x128 synthetic), its `rows`, on the card."""
    from promptir_tpu_torch.data.loader import TrainLoader
    from promptir_tpu_torch.data.synthetic import SyntheticTrainDataset

    ds = SyntheticTrainDataset(n=TRAIN_BATCH, patch_size=TRAIN_HW[0])
    batch = next(TrainLoader(ds, batch_size=TRAIN_BATCH, shuffle=False,
                             num_workers=2).epoch(0))
    return {k: v[rows].cuda() for k, v in batch.items()}


def grad_capture(st, model):
    """A list that each optimizer step appends its flat gradient to."""
    grads = []
    st.optimizer.register_step_pre_hook(lambda *a: grads.append(torch.cat(
        [p.grad.reshape(-1) for p in model.parameters()]).clone()))
    return grads


def timed(fn):
    """(fn(), ms by CUDA events)."""
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    out = fn()
    t1.record()
    torch.cuda.synchronize()
    return out, t0.elapsed_time(t1)


def dp_world_of_one_rank():
    """One rank over NCCL: DP_STEPS steps of full-depth promptir (bf16
    compute) with the world as its data group, each beside the same step of
    an identical model without a group. Returns the launches, losses and
    ms of each, whether the weights stayed bit-equal, and the traffic."""
    import torch.distributed as dist

    import promptir_tpu_torch as port
    from promptir_tpu_torch.parallel.mesh import all_reduce_sum
    from promptir_tpu_torch.train.state import TrainState, make_optimizer
    from promptir_tpu_torch.train.step import make_train_step

    # cuBLAS's deterministic workspace, set before this rank's first product
    # (stochastic_world_of_one runs under torch.use_deterministic_algorithms)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    batch = train_batch()
    runs = {}
    for tag, group in (("group", dist.group.WORLD), ("alone", None)):
        torch.manual_seed(0)
        model = port.create_model("promptir", device="cuda",
                                  dtype=torch.bfloat16, train=True)
        st = TrainState(model, make_optimizer(model.parameters()))
        runs[tag] = (model, st, make_train_step(model, group=group))
    out = {t: dict(launches=[], losses=[], ms=[]) for t in runs}
    calls, nbytes = all_reduce_sum.calls, all_reduce_sum.bytes
    for i in range(DP_STEPS):
        for tag, (model, st, step) in runs.items():
            before = rank_counts()
            metrics, ms = timed(lambda: step(st, batch))
            out[tag]["launches"].append(
                [a - b for a, b in zip(rank_counts(), before)])
            out[tag]["losses"].append(metrics["train_loss"].item())
            out[tag]["ms"].append(ms)
    pa = [p.detach() for p in runs["group"][0].parameters()]
    pb = [p.detach() for p in runs["alone"][0].parameters()]
    out["bit_equal"] = all(torch.equal(a, b) for a, b in zip(pa, pb))
    out["traffic"] = (all_reduce_sum.calls - calls, all_reduce_sum.bytes - nbytes)
    out["backend"] = dist.get_backend()
    del runs
    torch.cuda.empty_cache()
    out["stochastic"] = {name: stochastic_world_of_one(name, batch)
                         for name in STOCHASTIC}
    return out


def stochastic_world_of_one(name, batch):
    """(d) in the world of one: DP_STEPS bf16 steps of `name` in its
    training config with the world as its data group, each beside the same
    step without a group: their launches, losses and ms, whether the
    weights stayed bit-equal, and the traffic of the group's steps. Under
    torch.use_deterministic_algorithms: in the default mode two steps of a
    CAMixer X-Restormer without a group already differ in the last bits of
    the gradient, so only the deterministic mode can show that the group
    adds nothing."""
    import torch.distributed as dist

    import promptir_tpu_torch as port
    from promptir_tpu_torch.parallel.mesh import all_reduce_sum
    from promptir_tpu_torch.train.state import TrainState, make_optimizer
    from promptir_tpu_torch.train.step import make_train_step

    torch.use_deterministic_algorithms(True)
    runs = {}
    for tag, group in (("group", dist.group.WORLD), ("alone", None)):
        torch.manual_seed(0)
        model = port.create_model(name, device="cuda", dtype=torch.bfloat16,
                                  train=True, **STOCHASTIC_KW[name])
        st = TrainState(model, make_optimizer(model.parameters()))
        runs[tag] = (model, st, make_train_step(model, group=group))
    out = {t: dict(launches=[], losses=[], ms=[], traffic=[0, 0])
           for t in runs}
    for _ in range(DP_STEPS):
        for tag, (model, st, step) in runs.items():
            before = rank_counts()
            calls, nbytes = all_reduce_sum.calls, all_reduce_sum.bytes
            metrics, ms = timed(lambda: step(st, batch))
            out[tag]["launches"].append(
                [a - b for a, b in zip(rank_counts(), before)])
            out[tag]["losses"].append(metrics["train_loss"].item())
            out[tag]["ms"].append(ms)
            out[tag]["traffic"][0] += all_reduce_sum.calls - calls
            out[tag]["traffic"][1] += all_reduce_sum.bytes - nbytes
    torch.use_deterministic_algorithms(False)
    pa = [p.detach() for p in runs["group"][0].parameters()]
    pb = [p.detach() for p in runs["alone"][0].parameters()]
    out["bit_equal"] = all(torch.equal(a, b) for a, b in zip(pa, pb))
    del runs, pa, pb
    torch.cuda.empty_cache()
    return out


def sharded_families(g, r):
    """(c) on the two ranks: each of SPATIAL_FAMILIES' sharded fp32 B1
    SPATIAL_HW forward (a warm-up, then one timed), its launches, traffic
    and routing; on rank 0 also the unsharded card forward's error and
    routing."""
    import promptir_tpu_torch as port
    from promptir_tpu_torch.parallel.mesh import all_reduce_sum
    from promptir_tpu_torch.parallel.spatial import spatial_sharded_apply
    from promptir_tpu_torch.precision import exact_float32
    from promptir_tpu_torch.tools.parity import Routes

    x = torch.rand((1, *SPATIAL_HW, 3),
                   generator=torch.Generator().manual_seed(11)).cuda()
    out = {}
    for name, kw in SPATIAL_FAMILIES.items():
        torch.manual_seed(0)
        model = seeded_scales(port.create_model(name, device="cuda", **kw), 1)
        with torch.inference_mode(), exact_float32(torch.float32):
            spatial_sharded_apply(model, x, g)  # warm-up
            torch.cuda.synchronize()
            before = rank_counts()
            calls, nbytes = all_reduce_sum.calls, all_reduce_sum.bytes
            with Routes() as routes:
                y, t = timed(lambda: spatial_sharded_apply(model, x, g))
            res = dict(
                ms=t, launches=[a - c for a, c in zip(rank_counts(), before)],
                traffic=(all_reduce_sum.calls - calls,
                         all_reduce_sum.bytes - nbytes),
                finite=bool(torch.isfinite(y).all()), shape=tuple(y.shape),
                windows=routes.windows, images=routes.images)
            if r == 0:
                with Routes() as ref_routes:
                    ref, ref_ms = timed(lambda: model(
                        x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
                res.update(err=((y - ref).abs().max()
                                / ref.abs().max()).item(), ref_ms=ref_ms,
                           ref_windows=ref_routes.windows,
                           ref_images=ref_routes.images)
        out[name] = res
        del model, y
        torch.cuda.empty_cache()
    return out


def dp_stochastic(g, r, n):
    """(d) on the two ranks, for each of STOCHASTIC in its training config:
    the one-process fp32 step on phase 7's whole batch (B6), recording the
    side of every kink (tools/parity.py:Kinks), then two DP steps on this
    rank's rows (B3) from the same weights: the first counts the elements
    that lie on the other side of a kink than in the one-process step
    ("raw"), the second also takes the one-process step's sides
    ("forced"). Each step's ms, traffic, routing, and the gradient reaching
    each mixer's mask and each selector's labels (parity.Routes); the
    gradients' errors against the one-process step's (parity.grad_errors,
    tap_errors). Under torch.use_deterministic_algorithms, so that a run
    repeats the last's errors."""
    import promptir_tpu_torch as port
    from promptir_tpu_torch.parallel.mesh import all_reduce_sum
    from promptir_tpu_torch.tools.parity import (
        Kinks,
        Routes,
        grad_errors,
        named_grads,
        tap_errors,
    )
    from promptir_tpu_torch.train.state import TrainState, make_optimizer
    from promptir_tpu_torch.train.step import make_train_step

    b = TRAIN_BATCH // n
    mine, whole = train_batch(slice(r * b, (r + 1) * b)), train_batch()
    out = {}
    torch.use_deterministic_algorithms(True)

    def one_step(name, group, batch, kinks):
        torch.manual_seed(0)
        model = port.create_model(name, device="cuda", train=True,
                                  **STOCHASTIC_KW[name])
        st = TrainState(model, make_optimizer(model.parameters()))
        grads = grad_capture(st, model)
        step = make_train_step(model, group=group)
        calls, nbytes = all_reduce_sum.calls, all_reduce_sum.bytes
        with Routes() as routes, kinks:
            metrics, ms = timed(lambda: step(st, batch))
        flat = grads[0]
        res = dict(loss=metrics["train_loss"].item(), ms=ms,
                   traffic=(all_reduce_sum.calls - calls,
                            all_reduce_sum.bytes - nbytes),
                   windows=routes.windows, images=routes.images,
                   mask_grads=routes.mask_grads,
                   label_grads=routes.label_grads,
                   flips=sum(kinks.flips),
                   near=max(kinks.near, default=0.0))
        named = named_grads(model, flat)
        del model, st, step
        return res, flat, named

    for name in STOCHASTIC:
        rec = Kinks()
        # the one-process B6 steps one rank after the other: two at once,
        # beside the smoke's process, do not fit on the card
        for turn in range(n):
            if turn == r:
                ref, ref_flat, ref_named = one_step(name, None, whole, rec)
                torch.cuda.empty_cache()
            all_reduce_sum(torch.zeros(1, device="cuda"), g)
        for tag, apply in (("raw", False), ("forced", True)):
            res, flat, named = one_step(
                name, g, mine, Kinks(rec.sides, (r, n), apply=apply))
            errs = grad_errors(named, ref_named)
            worst = max(errs, key=errs.get)
            res.update(
                whole=((flat - ref_flat).norm() / ref_flat.norm()).item(),
                err=errs[worst], worst=worst,
                taps=max(tap_errors(res.pop(k), ref[k], r, n)
                         for k in ("mask_grads", "label_grads")))
            out.setdefault(name, {})[tag] = res
            del flat, named
        for k in ("mask_grads", "label_grads"):
            ref.pop(k)
        out[name]["ref"] = ref
        del rec, ref_flat, ref_named
        torch.cuda.empty_cache()
    torch.use_deterministic_algorithms(False)
    return out


def shared_card_rank(tile_seed):
    """One of two gloo ranks on cuda:0: the fp32 DP step (B3 a rank) beside
    the one-process B6 step (rank 0), the sharded fp32 forward of
    full-depth promptir at SPATIAL_HW beside the unsharded forward through
    the kernels (rank 0), two TILED_HW photographs through the tiler with
    the group beside the one-process tiler (rank 0), and TP_CASES beside
    their modules. Returns the numbers phase 13 prints and gates."""
    import torch.distributed as dist

    import promptir_tpu_torch as port
    from promptir_tpu_torch.eval.tiling import tiled_inference
    from promptir_tpu_torch.ops.attention import MDTA
    from promptir_tpu_torch.ops.gdfn import GDFN
    from promptir_tpu_torch.parallel import tp
    from promptir_tpu_torch.parallel.mesh import all_reduce_sum, broadcast
    from promptir_tpu_torch.parallel.spatial import spatial_sharded_apply
    from promptir_tpu_torch.precision import exact_float32
    from promptir_tpu_torch.train.state import TrainState, make_optimizer
    from promptir_tpu_torch.train.step import make_train_step

    # cuBLAS's deterministic workspace, set before this rank's first product
    # (dp_stochastic runs under torch.use_deterministic_algorithms)
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    g = dist.group.WORLD
    r, n = dist.get_rank(), dist.get_world_size()
    out = {"backend": dist.get_backend(g)}
    b = TRAIN_BATCH // n
    # broadcast, the trainer's start (rank 0's weights to every rank)
    t = torch.full((1024,), float(r + 1), device="cuda")
    broadcast([t], g)
    out["broadcast"] = bool((t == 1.0).all())

    def fresh(train):
        torch.manual_seed(0)
        return port.create_model("promptir", device="cuda", train=train)

    # the DP step, fp32 (TF32 off inside the step)
    model = fresh(True)
    st = TrainState(model, make_optimizer(model.parameters()))
    grads = grad_capture(st, model)
    step = make_train_step(model, group=g)
    mine = train_batch(slice(r * b, (r + 1) * b))
    calls, nbytes = all_reduce_sum.calls, all_reduce_sum.bytes
    losses, ms = [], []
    for _ in range(2):
        metrics, t = timed(lambda: step(st, mine))
        losses.append(metrics["train_loss"].item())
        ms.append(t)
    out["dp"] = dict(losses=losses, ms=ms, traffic=(
        all_reduce_sum.calls - calls, all_reduce_sum.bytes - nbytes))
    if r == 0:
        ref = fresh(True)
        st_ref = TrainState(ref, make_optimizer(ref.parameters()))
        grads_ref = grad_capture(st_ref, ref)
        step_ref = make_train_step(ref)
        whole = train_batch()
        ref_losses, ref_ms = [], []
        for _ in range(2):
            metrics, t = timed(lambda: step_ref(st_ref, whole))
            ref_losses.append(metrics["train_loss"].item())
            ref_ms.append(t)
        worst, i = 0.0, 0
        for p in model.parameters():
            a = grads[0][i:i + p.numel()]
            w = grads_ref[0][i:i + p.numel()]
            i += p.numel()
            worst = max(worst, ((a - w).abs().max()
                                / w.abs().max().clamp_min(1e-30)).item())
        out["dp"].update(ref_losses=ref_losses, ref_ms=ref_ms, grad_err=worst)
        del ref, st_ref, step_ref, grads_ref
    del model, st, step, grads
    torch.cuda.empty_cache()

    # the sharded forward, fp32, and the tiler with the group
    model = fresh(False)
    gen = torch.Generator().manual_seed(tile_seed)
    x = torch.rand((1, *SPATIAL_HW, 3), generator=gen).cuda()
    imgs = [torch.rand((1, *TILED_HW, 3), generator=gen).cuda()
            for _ in range(2)]
    with torch.inference_mode(), exact_float32(torch.float32):
        spatial_sharded_apply(model, x, g)  # warm-up
        torch.cuda.synchronize()
        before = rank_counts()
        calls, nbytes = all_reduce_sum.calls, all_reduce_sum.bytes
        y, t = timed(lambda: spatial_sharded_apply(model, x, g))
        out["spatial"] = dict(
            ms=t, launches=[a - c for a, c in zip(rank_counts(), before)],
            traffic=(all_reduce_sum.calls - calls,
                     all_reduce_sum.bytes - nbytes),
            finite=bool(torch.isfinite(y).all()), shape=tuple(y.shape))
        tiled = []
        for im in imgs:
            o, t = timed(lambda: tiled_inference(
                model, im, tile=TILE, overlap=TILE_OVERLAP, chunk=TILE_CHUNK,
                group=g))
            tiled.append((o, t))
        out["tiled"] = dict(ms=[t for _, t in tiled])
        if r == 0:
            ref = model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            out["spatial"]["err"] = ((y - ref).abs().max()
                                     / ref.abs().max()).item()
            errs, ref_ms = [], []
            for im, (o, _) in zip(imgs, tiled):
                want, t = timed(lambda: tiled_inference(
                    model, im, tile=TILE, overlap=TILE_OVERLAP,
                    chunk=TILE_CHUNK))
                errs.append((o - want).abs().max().item())
                ref_ms.append(t)
            out["tiled"].update(err=max(errs), ref_ms=ref_ms)
        # TP: each module's plain forward beside its tensor-parallel apply
        out["tp"] = {}
        for label, (kind, args, shape) in TP_CASES.items():
            torch.manual_seed(1)
            mod = (GDFN if kind == "gdfn" else MDTA)(*args).cuda()
            xt = torch.randn(shape, generator=gen).cuda()
            apply = tp.tp_gdfn_apply if kind == "gdfn" else tp.tp_mdta_apply
            got, t = timed(lambda: apply(mod, xt, g))
            want = mod(xt)
            out["tp"][label] = dict(ms=t, err=((got - want).abs().max()
                                               / want.abs().max()).item())
    del model
    torch.cuda.empty_cache()
    out["families"] = sharded_families(g, r)
    out["dp_stochastic"] = dp_stochastic(g, r, n)
    return out


def parallel_phase(card):
    """Phase 13: the port's parallel code on one card. (a) A world of one
    over NCCL: the DP step of full-depth promptir, bf16, B6 128x128, bit-equal
    to the same steps without a group, TRAIN_PER_STEP launches a step. (b)
    Two ranks sharing cuda:0 over gloo (NCCL refuses two ranks on one card;
    all_reduce and broadcast are what gloo takes on CUDA tensors, and every
    collective of the port goes through them): the fp32 DP step, B3 a rank,
    against the one-process B6 step (GRAD_TOL), the sharded fp32 forward at
    SPATIAL_HW against the unsharded card forward (GOLDEN_TOL of max |ref|;
    the block kernels gated off, the seam on), the tiler with the group
    against the one-process tiler, and TP_CASES against their modules. The
    kernels are built by this process before the ranks start. Then (c)
    and (d) (the module's docstring). Returns the launches of the paths
    `dp_train`, `spatial`, `dp_train_stochastic` and `spatial_families`."""
    from promptir_tpu_torch.parallel.mesh import launch

    (a,) = launch(dp_world_of_one_rank, 1, "cuda", timeout_s=RANK_TIMEOUT_S)
    g, al = a["group"], a["alone"]
    say(f"parallel: a world of one over {a['backend']} (torch.distributed "
        f"all_reduce on CUDA tensors): full-depth promptir bf16 B{TRAIN_BATCH} "
        f"{TRAIN_HW[0]}x{TRAIN_HW[1]} DP step with the group "
        f"{', '.join(f'{v:.1f}' for v in g['ms'])} ms, without "
        f"{', '.join(f'{v:.1f}' for v in al['ms'])} ms (CUDA events, the first "
        f"a warm-up) on {card}; losses {g['losses']} vs {al['losses']}; "
        f"weights bit-equal {a['bit_equal']}; {a['traffic'][0]} all_reduces, "
        f"{a['traffic'][1]} bytes; launches {LAUNCH_NAMES} a step "
        f"{g['launches']}")
    if not a["bit_equal"] or g["losses"] != al["losses"]:
        fail("the NCCL world of one is not bit-equal to the step without a "
             "group")
    for ran in g["launches"] + al["launches"]:
        if ran != TRAIN_PER_STEP:
            fail(f"a DP step launched {ran} != {TRAIN_PER_STEP}")

    gc.collect()
    torch.cuda.empty_cache()  # the earlier phases' blocks, for the two ranks
    res = launch(shared_card_rank, 2, "cuda", backend="gloo", share_card=True,
                 args=(0,), timeout_s=RANK_TIMEOUT_S)
    b0, dp, sp, tl = res[0], res[0]["dp"], res[0]["spatial"], res[0]["tiled"]
    if not all(r["broadcast"] for r in res):
        fail("gloo's broadcast of a CUDA tensor did not reach every rank")
    say(f"parallel: two ranks on cuda:0 over {b0['backend']} (all_reduce and "
        f"broadcast on CUDA tensors): full-depth promptir fp32 (TF32 off) DP step B"
        f"{TRAIN_BATCH // 2} a rank {', '.join(f'{v:.1f}' for v in dp['ms'])} "
        f"ms (rank 1 {', '.join(f'{v:.1f}' for v in res[1]['dp']['ms'])}), "
        f"the one-process B{TRAIN_BATCH} step "
        f"{', '.join(f'{v:.1f}' for v in dp['ref_ms'])} ms (the first of each "
        f"a warm-up) on {card}; losses {dp['losses']} vs {dp['ref_losses']}; "
        f"max |grad - one-process grad| / max over tensors "
        f"{dp['grad_err']:.3e} (gate {GRAD_TOL}); {dp['traffic'][0]} "
        f"all_reduces, {dp['traffic'][1]} bytes a rank")
    if not dp["grad_err"] <= GRAD_TOL or not all(
            np.isfinite(dp["losses"] + dp["ref_losses"])):
        fail(f"the two-rank DP step's gradient is {dp['grad_err']:.3e} from "
             "the one-process step's")
    if abs(dp["losses"][0] - dp["ref_losses"][0]) > GRAD_TOL * dp["ref_losses"][0]:
        fail(f"the two-rank loss {dp['losses'][0]} is not the one-process "
             f"loss {dp['ref_losses'][0]}")
    say(f"parallel: sharded forward of full-depth promptir fp32 B1 "
        f"{SPATIAL_HW[0]}x{SPATIAL_HW[1]} over two ranks: {sp['ms']:.1f} ms "
        f"(rank 1 {res[1]['spatial']['ms']:.1f}) on {card}; "
        f"{sp['traffic'][0]} all_reduces, {sp['traffic'][1]} bytes a rank; "
        f"max |sharded - unsharded through the kernels| / max "
        f"{sp['err']:.3e} (gate {GOLDEN_TOL}); launches {LAUNCH_NAMES} "
        f"{sp['launches']} (the block kernels off, the seam on the stripe)")
    spatial_launches = [0, 0, 0, 1, 0, 0, 0]
    if not sp["err"] <= GOLDEN_TOL or not sp["finite"] or sp["shape"] != (
            1, *SPATIAL_HW, 3):
        fail(f"the sharded forward is {sp['err']:.3e} from the unsharded one")
    for r in res:
        if r["spatial"]["launches"] != spatial_launches:
            fail(f"the sharded forward launched {r['spatial']['launches']} != "
                 f"{spatial_launches}")
    say(f"parallel: tiler with the group, full-depth promptir fp32, two "
        f"{TILED_HW[0]}x{TILED_HW[1]} photographs (tile {TILE}, overlap "
        f"{TILE_OVERLAP}, chunk {TILE_CHUNK}: {TILE_CHUNK // 2} tiles a rank "
        f"a forward): {', '.join(f'{v:.1f}' for v in tl['ms'])} ms, one "
        f"process {', '.join(f'{v:.1f}' for v in tl['ref_ms'])} ms on {card}; "
        f"max |sharded - one-process| {tl['err']:.3e} (gate {GOLDEN_TOL})")
    if not tl["err"] <= GOLDEN_TOL:
        fail(f"the sharded tiler is {tl['err']:.3e} from the one-process tiler")
    for label, v in res[0]["tp"].items():
        worst = max(r["tp"][label]["err"] for r in res)
        say(f"parallel: TP {label} over two ranks: {v['ms']:.2f} ms; max |TP "
            f"- module| / max {worst:.3e} (gate {GOLDEN_TOL})")
        if not worst <= GOLDEN_TOL:
            fail(f"TP {label} is {worst:.3e} from its module")
    stochastic_launches = world_of_one_stochastic(a["stochastic"], card)
    family_launches = check_families(res, card)
    check_dp_stochastic(res, card)
    return {"dp_train": [sum(c) for c in zip(*g["launches"])],
            "spatial": sp["launches"],
            "dp_train_stochastic": stochastic_launches,
            "spatial_families": family_launches}


def world_of_one_stochastic(results, card):
    """(d)'s NCCL world of one: print and gate each stochastic model's
    steps; returns the launches of the group's steps."""
    total = [0] * len(KERNELS)
    for name, v in results.items():
        g, al = v["group"], v["alone"]
        say(f"parallel: a world of one over NCCL: full-depth {name} "
            f"({STOCHASTIC_KW[name] or 'default'}) bf16 B{TRAIN_BATCH} "
            f"{TRAIN_HW[0]}x{TRAIN_HW[1]} DP step (deterministic algorithms) "
            f"with the group {', '.join(f'{t:.1f}' for t in g['ms'])} ms, without "
            f"{', '.join(f'{t:.1f}' for t in al['ms'])} ms (CUDA events, the "
            f"first a warm-up) on {card}; losses {g['losses']} vs "
            f"{al['losses']}; weights bit-equal {v['bit_equal']}; "
            f"{g['traffic'][0]} all_reduces, {g['traffic'][1]} bytes in "
            f"{DP_STEPS} steps; launches {LAUNCH_NAMES} a step "
            f"{g['launches']}")
        if not v["bit_equal"] or g["losses"] != al["losses"]:
            fail(f"{name}'s NCCL world of one is not bit-equal to its steps "
                 "without a group")
        for ran in g["launches"] + al["launches"]:
            if ran != STOCHASTIC_PER_STEP[name]:
                fail(f"a {name} DP step launched {ran} != "
                     f"{STOCHASTIC_PER_STEP[name]}")
        total = [t + sum(c) for t, c in zip(total, zip(*g["launches"]))]
    return total


def check_families(res, card):
    """(c): print and gate each model's sharded forward over the two ranks;
    returns the launches of rank 0's sharded forwards."""
    total = [0] * len(KERNELS)
    for name, f0 in res[0]["families"].items():
        f1 = res[1]["families"][name]
        routing = ""
        if f0["ref_windows"]:
            routing = (f"; {len(f0['windows'])} mixer calls keep "
                       f"{sum(f0['windows'])} windows (unsharded "
                       f"{sum(f0['ref_windows'])})")
        if f0["ref_images"]:
            routing += (f", {len(f0['images'])} selector calls pick "
                        f"{sum(map(sum, f0['images']))} images (unsharded "
                        f"{sum(map(sum, f0['ref_images']))})")
        say(f"parallel: sharded forward of full-depth {name} "
            f"({SPATIAL_FAMILIES[name] or 'default'}) fp32 B1 "
            f"{SPATIAL_HW[0]}x{SPATIAL_HW[1]} over two ranks: {f0['ms']:.1f} "
            f"ms (rank 1 {f1['ms']:.1f}; unsharded {f0['ref_ms']:.1f}, one "
            f"call each after a warm-up) on {card}; {f0['traffic'][0]} "
            f"all_reduces, {f0['traffic'][1]} bytes a rank; max |sharded - "
            f"unsharded| / max {f0['err']:.3e} (gate {GOLDEN_TOL}); launches "
            f"{LAUNCH_NAMES} {f0['launches']}{routing}")
        if not f0["err"] <= GOLDEN_TOL or not f0["finite"] or f0["shape"] != (
                1, *SPATIAL_HW, 3):
            fail(f"{name}'s sharded forward is {f0['err']:.3e} from the "
                 "unsharded one")
        for f in (f0, f1):
            if f["launches"] != [0] * len(KERNELS):
                fail(f"{name}'s sharded forward launched {f['launches']}: "
                     "its blocks run plain under the sharded forward")
            if (f["windows"], f["images"]) != (f0["ref_windows"],
                                               f0["ref_images"]):
                fail(f"{name}'s sharded forward routed windows or images "
                     "other than the unsharded forward's")
        total = [t + c for t, c in zip(total, f0["launches"])]
    return total


def check_dp_stochastic(res, card):
    """(d) over the two ranks: print and gate each stochastic model's fp32
    DP steps against the one-process step. The forced step (the
    one-process step's side of every kink, tools/parity.py:Kinks): each
    tensor's gradient error (parity.grad_errors: of its own max, of 1% of
    the median tensor's below that) and the whole gradient's relative
    error within GRAD_TOL, and the gradient at each mask and each
    selector's labels (parity.tap_errors) within GRAD_TOL. Both steps:
    every element whose side of a kink differs from the one-process step's
    within KINK_NEAR of it, the loss, the windows each mixer call keeps and
    the images each selector call picks, one image a CATA selector over
    the two ranks. The raw step's errors are printed beside the forced
    step's, and a raw tensor past GRAD_TOL with no element on another side
    of a kink fails: a summation order that moves an input within rounding
    of a kink across it moves a weight's gradient by that element's term,
    which is the gradient's discontinuity, not an error of the DP step."""
    from promptir_tpu_torch.tools.parity import KINK_NEAR

    for name, v0 in res[0]["dp_stochastic"].items():
        v1, ref = res[1]["dp_stochastic"][name], v0["ref"]
        for tag in ("raw", "forced"):
            d0, d1 = v0[tag], v1[tag]
            flips = d0["flips"] + d1["flips"]
            near = max(d0["near"], d1["near"])
            windows = [a + b for a, b in zip(d0["windows"], d1["windows"])]
            images = [a + b for a, b in zip(d0["images"], d1["images"])]
            taps = max(d0["taps"], d1["taps"])
            say(f"parallel: two ranks on cuda:0 over gloo: full-depth {name} "
                f"fp32 (TF32 off) DP step ({tag}) B{TRAIN_BATCH // 2} a rank "
                f"{d0['ms']:.1f} ms (rank 1 {d1['ms']:.1f}), the one-process "
                f"B{TRAIN_BATCH} step {ref['ms']:.1f} ms (one each; "
                f"deterministic algorithms) on {card}; loss {d0['loss']:.6f} "
                f"vs {ref['loss']:.6f}; ||grad - one-process grad|| / "
                f"||one-process grad|| {d0['whole']:.3e}, max over tensors of "
                f"max |difference| / max(its max, 1% of the median tensor's) "
                f"{d0['err']:.3e} at {d0['worst']}, at the masks and labels "
                f"{taps:.3e} (gate {GRAD_TOL} on the forced step); "
                f"{flips} elements on another side of a kink than one "
                f"process, the farthest {near:.3e} from it (gate "
                f"{KINK_NEAR}); {d0['traffic'][0]} all_reduces, "
                f"{d0['traffic'][1]} bytes a rank; windows kept a mixer call "
                f"equal {windows == ref['windows']}"
                + (f"; images a selector call over both ranks "
                   f"{[sum(p) for p in images]}" if ref["images"] else ""))
            if not np.isfinite([d0["loss"], ref["loss"]]).all() or abs(
                    d0["loss"] - ref["loss"]) > GRAD_TOL * ref["loss"]:
                fail(f"{name}'s two-rank loss {d0['loss']} is not the "
                     f"one-process loss {ref['loss']}")
            if not near <= KINK_NEAR:
                fail(f"{name}'s two-rank step put an element {near:.3e} from "
                     "its kink on another side than one process")
            if windows != ref["windows"] or images != ref["images"]:
                fail(f"{name}'s two-rank step routed windows or images other "
                     "than the one-process step's")
            if ref["images"] and not all(sum(p) == 1 for p in images):
                fail(f"{name}'s selectors picked {images} over the two ranks, "
                     "not one image of the global batch each")
        raw, forced = v0["raw"], v0["forced"]
        if not raw["err"] <= GRAD_TOL and not (
                raw["flips"] + v1["raw"]["flips"]):
            fail(f"{name}'s two-rank DP gradient is {raw['err']:.3e} from the "
                 f"one-process step's at {raw['worst']}, with no kink crossed")
        if not (forced["err"] <= GRAD_TOL and forced["whole"] <= GRAD_TOL
                and max(forced["taps"], v1["forced"]["taps"]) <= GRAD_TOL):
            fail(f"{name}'s two-rank DP gradient on the one-process step's "
                 f"kink sides is {forced['err']:.3e} from its own at "
                 f"{forced['worst']} ({forced['whole']:.3e} whole, the masks "
                 f"and labels {forced['taps']:.3e})")


# ------------------------------------------------------------------ main

def main() -> None:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        raise SystemExit(3)
    only_forward = sys.argv[1:] == ["--bf16-forward"]
    if sys.argv[1:] and not only_forward:
        fail(f"unknown arguments {sys.argv[1:]}: takes none, or --bf16-forward")
    port, build, mdta, block, gdfn, seam, megablock = import_port()
    from promptir_tpu_torch.precision import exact_float32

    # in KERNELS' order
    kernels = (mdta.mdta_stats, block.block_tail, gdfn.ln_gdfn, seam.seam,
               mdta.ln_mdta, megablock.tail_stats, mdta.mdta_gram)

    def counters():
        return [k.launches for k in kernels]

    def reset():
        for k in kernels:
            k.launches = 0

    card = card_line()
    print(card, flush=True)
    say(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    from promptir_tpu_torch.utils import tracing

    build.lib()
    so = build.library_path()
    loaded = tracing.spans("setup.library")[-1]
    say(f"build: {so.name} {'built' if loaded.attrs['built'] else 'loaded'} "
        f"in {loaded.seconds:.1f} s (one nvcc per csrc/*.cu, side by side, "
        "then one link)")
    for line in (build.build_log or "").splitlines():
        if re.search(r"Compiling entry|registers|spill", line):
            print("    " + line.strip(), flush=True)
    if only_forward:
        check_bf16_forward(port, counters, reset)
        say(f"done in {time.perf_counter() - T0:.1f} s")
        return
    for file, *_ in GOLDENS:
        if not (ROOT / "tests" / "goldens" / file).exists():
            fail(f"tests/goldens/{file} is missing")
    sass = tensor_core_sass(so)
    say("tensor-core instructions (HMMA/HGMMA) per kernel in the SASS: "
        + ", ".join(f"{k} {n['HMMA']}/{n['HGMMA']}"
                    for k, n in sorted(sass.items())))
    for k in TENSOR_CORE_KERNELS:
        if not sum(sass.get(k, {}).values()):
            fail(f"{k} holds no tensor-core instruction")
    for k in WGMMA_KERNELS:
        if not sass.get(k, {}).get("HGMMA"):
            fail(f"{k} holds no HGMMA (wgmma) instruction")
    # the bf16 Gram's plan assumes the clusters an H100 SXM holds at once
    held = {n: build.function("mdta_gram_tc_max_clusters", [ctypes.c_int])(n)
            for n in mdta.GRAM_CLUSTERS}
    say(f"Gram clusters of 1/2/4/8/16 blocks this card holds at once: "
        f"{held} (gram_plan assumes {mdta.GRAM_CLUSTERS}"
        + ("" if all(held[n] >= v for n, v in mdta.GRAM_CLUSTERS.items())
           else "; fewer here: a Gram grid can run in two waves") + ")")

    with exact_float32(torch.float32):
        worst = check_kernels(mdta, block, gdfn, seam, megablock)
        check_ln_block_grads(counters, reset)
    for golden in GOLDENS:
        check_golden(port, counters, *golden)
    check_bf16_forward(port, counters, reset)
    launches = {}
    for path in PATHS:
        reset()
        launches[path] = serve(port, counters, reset, card, path)
    check_forward_fp32(port, counters, reset, EFF)
    for name, (kwargs, shape) in CPU_CHECKS.items():
        check_against_cpu(port, counters, reset, name, kwargs, shape)
    check_window_counts(port, counters, reset)
    for name in CA_CHECKS:
        check_ca_against_cpu(port, counters, reset, name)
    check_ca_routing(port, counters, reset)
    reset()
    launches["nafnetlocal"] = serve_tlc(port, counters, reset, card)
    reset()
    launches["tiled"] = serve_tiled(port, counters, reset, card)
    check_grads(port, counters, reset)
    launches["train"] = train(port, counters, reset, card)
    check_ca_v1(port, card)
    demo()
    reset()
    recs = time_kernels(mdta, block, gdfn, seam, megablock, reset)
    reset()
    launches["eval"] = evaluate(port, mdta, counters, reset, card)
    reset()
    launches["train_cli"] = train_cli(counters, reset, card)
    for label, flags, per_step in TRAIN_CLI_MODES:
        reset()
        launches[f"train_cli {label}"] = train_cli_mode(
            counters, card, label, flags, per_step)
    tools_phase(port, counters, reset)
    launches.update(parallel_phase(card))

    replaces = {
        "mdta_stats": ("promptir_tpu_torch/csrc/mdta_stats.cu",
                       "promptir_tpu/ops/pallas/mdta.py:317"),
        "block_tail": ("promptir_tpu_torch/csrc/block_tail.cu",
                       "promptir_tpu/ops/pallas/block.py:158"),
        "ln_gdfn": ("promptir_tpu_torch/csrc/ln_gdfn.cu",
                    "promptir_tpu/ops/pallas/gdfn.py:536"),
        "seam": ("promptir_tpu_torch/csrc/seam.cu",
                 "promptir_tpu/ops/pallas/seam.py:222"),
        "ln_mdta": ("promptir_tpu_torch/csrc/ln_mdta.cu",
                    "promptir_tpu/ops/pallas/mdta.py:252"),
        "tail_stats": ("promptir_tpu_torch/csrc/tail_stats.cu",
                       "promptir_tpu/ops/pallas/megablock.py:165"),
        # the Gram of the wide route, a stage of the same TPU kernel (its
        # body's Gram, mdta.py:102-116); bf16 on wgmma, float32
        # mdta_stats.cu:gram_kernel
        "mdta_gram": ("promptir_tpu_torch/csrc/mdta_gram.cu",
                      "promptir_tpu/ops/pallas/mdta.py:317"),
    }
    out = []
    for i, name in enumerate(KERNELS):
        src, rep = replaces[name]
        r = recs[name]
        by_path = {p: dict(r["by_path"].get(p, {}), launches=launches[p][i])
                   for p in launches}
        out.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=sum(launches[p][i] for p in launches),
            max_abs_err=worst[name][torch.float32][0],
            max_rel_err=worst[name][torch.float32][1],
            max_abs_err_bf16=worst[name][torch.bfloat16][0],
            max_rel_err_bf16=worst[name][torch.bfloat16][1],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            by_path=by_path,
        ))
        if out[-1]["launches"] == 0:
            fail(f"{name} was launched no time on the main paths")
    say(f"done in {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": out}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
