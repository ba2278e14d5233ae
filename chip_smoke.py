"""Smoke test of the PyTorch port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Builds the port's CUDA kernels from achelous_tpu_torch/csrc, holds each
against its plain PyTorch version at the shapes the serving paths give it
(K1 fused RadarConv, K2 deformable sampling, K3 fused bias attention, K4
farthest point sampling), then serves 8 requests through the port's entry
point on each of three paths (320x320, bf16, batch 1):

    EN-GDF-PN-S0   K1 x4, K2 x4 a request
    EN-GDF-PN2-S0  K1 x4, K2 x4, K4 x4
    EF-GDF-PN-S0   K1 x4, K2 x4, K3 x4

and checks them against the same weights run in float32 through the plain
versions on the CPU.  Then it trains EN-GDF-PN-S0 (320x320, float32
parameters), in three phases:

    T1  K1's and K2's autograd Functions (kernel forward, the plain
        version's autograd backward) against torch.autograd of the plain
        versions, at the training shapes (batch 32) and the serving ones;
        every RadarConv parameter of a model gets a gradient
    T2  one float32 step on the card against the same step on the CPU,
        each tensor's change held to float32's own spread, read on the CPU
        with the batch scaled by 1 +- 1e-6 and reversed (batch 8; logged
        at batch 2, where PointNet's gradients are chaotic in float32)
    T3  6 steps at batch 32 in bf16 with the default TrainConfig (K1 x4,
        K2 x4 a step), one MGDA and one CAGrad step, and a step on a
        batch with a NaN, which must change nothing but the step count
    T4  K3's autograd Function against torch.autograd of its plain
        version at EF's training shapes (batch 32) and the serving ones;
        every Attention4D parameter of an EF-GDF-PN-S0 training model gets
        a gradient
    T5  EF-GDF-PN-S0 (K3 x4 a step) and EN-GDF-PN2-S0 (K4 x4 a step) at
        batch 32 in bf16, a few timed steps each, every kernel held against
        its plain version on the inputs of the first step's launches; K4's
        indices at batch 32 with a valid mask and without; one float32 step
        of EF-GDF-PN-S0 at batch 8 on the card against the CPU
    T6  EN-GDF-PN-S1, -S2, EN-GDF-PN-S0 with SPPF and with the base-256
        head, MV-GDF-PN-S1, EN-CDF-PN2-S2 (K4 x4), EV-, PF-GDF-PN-S0 and
        EF-GDF-PN-L (K1 x1, K2 x7, K3 x12) at batch 32 in bf16: a warm-up
        and a timed step each, launches a step held, every launch of the
        first step held against the plain version; one float32 step of
        MV-GDF-PN-S1 at batch 8 on the card against the CPU
    T7  the reparameterizable RV-GDF-PN-S0, MO-RDF-PN-S0 and FV-RDF-PN-S0
        in their train form as T6 trains them; each trained EMA folded
        in float32 on the card and held against the train form's eval
        output (TF32 off, DEPLOY_TOL of each output's scale) and
        against itself in float32 on the CPU, then served at batch 1 in
        bf16 through entry() and decode + NMS in both forms (kernels a
        frame and ms a frame of each; the outputs before decode against
        float32 plain on the CPU, held on RV and FV, logged beside their
        bf16 spread on MO; every deploy launch held against the plain
        version); one float32 step
        of MO-RDF-PN-S0 at batch 8 on the card against the CPU (with
        float32's spread where 1e-3 does not hold); `train.cli.main` for
        one epoch of MO-RDF-PN-S0 on a tree like F1's, then
        `predict_cli.main --ckpt <its last checkpoint> --deploy` on one
        of its frames

and runs the trainer's entry point:

    F1  `fit` for EN-GDF-PN-S0 at 320x320 on a small WaterScenes-layout
        tree with raw radar CSVs (no pre-rasterized maps), so every
        batch's radar map is splatted on the card: 2 epochs with the
        online evaluation at the end, then a resume from the epoch-1
        checkpoint; the card's splat equals the CPU's on the same points
        (Pillow writes and decodes the tree's images); K1 and K2 held
        against their plain versions on the inputs of fit's launches at
        its batch 8, in training and in evaluation
and then the predictor, its export and the other configurations of
BENCH_SWEEP.json (320x320, bf16, batch 1):

    P1  `AchelousPredictor` for EN-GDF-PN-S0 on seeded weights (offset
        convs drawn) written by `weights.save_weights` and read by
        `from_weights`, on 1920x1080 frames (WaterScenes' camera) with a
        400-point radar CSV splatted on the card or an npz map: unstamped
        (K1 x4, K2 x4 a frame) and stamped torch-transplant (band None,
        K2 x8); each also in float32 on the card against the CPU, TF32
        off (prepared inputs equal, detections paired, unletterboxed
        probabilities within 1e-4), and in bf16 within the serving gate;
        `detect_heatmap`, the CLI's predict mode (json, masks, rendered
        jpg) and its fps probe (50 detections, seconds/image)
    X1  `export_program` of that predictor, reloaded with
        `torch.export.load`: K1 x4 and K2 x4 as operator nodes of its
        graph, launched (and counted) when it runs, its outputs against
        the eager request function's
    C1  EN-GDF-PN-S1, EN-GDF-PN-S2, EN-GDF-PN-S0 with SPPF, MV-GDF-PN-S1
        and EN-CDF-PN2-S2 (K4 x4 too), each served C1_REQUESTS requests
        as the paths above, every launch's inputs held against the plain
        version, and timed

and the configurations of the JAX package that no phase above builds:

    C2  EV-GDF-PN-S0, RV-GDF-PN-S0, PF-GDF-PN-S0 (K1 x4, K2 x4 a
        request), MO-RDF-PN-S0 and FV-RDF-PN-S0 (the same) each in its
        train form and its deploy form (every reparameterizable block
        folded into one conv), and EF-GDF-PN-L (K1 x1, K2 x7, K3 x12),
        each served 8 requests through entry() at 320x320, bf16, batch
        1, on seeded weights whose offset convs and layer scales are
        drawn (C2_LAYER_SCALE) and, in RV, MO and FV, whose backbone
        BatchNorms' statistics and affine are drawn (C2_NORM_SCALE; at
        init MobileOne's six summed branches a block grow its maps to
        ~1e11);
        every launch's inputs held against the plain version, the outputs
        against float32 plain on the CPU, kernels a frame and ms a frame
        logged; then each deploy form in float32 on the card (TF32 off)
        against its own train form, within DEPLOY_TOL, their kernels a
        frame side by side

and then the port across ranks and devices, and the 3-task model:

    D1  two ranks of the EN-GDF-PN-S0 train step (`parallel.dist`,
        spawned by tests/torch_port_ranks.py's `run_ranks`; NCCL with a
        GPU a rank where the machine shows two, else both ranks on
        cuda:0 over gloo): `gather_rows` (grad_accum's row exchange) on
        the card's tensors; (a) float32, TF32 off, global batch
        STEP_BATCH, against the single-process step on the card from
        the same weights under T2's gate (the spread read from the
        single process's step on the batch reversed), both ranks'
        states equal; (b) bf16 at global batch
        TRAIN_BATCH, D1_STEPS steps: each rank's ms a step, the same rows
        stepped without the group (the collectives' share), peak memory,
        K1 x4 and K2 x4 a step, the first step's launches held against
        the plain versions
    D2  `fit` across the same two ranks on a tree like F1's (global batch
        FIT_BATCH): FIT_EPOCHS epochs, rank 0 writing the history and the
        checkpoints, then a resume from rank 0's epoch-1 checkpoint;
        both ranks' states equal after each run; rank 0's launches held
        against the plain versions (D1 and D2 run in one spawn)
    P2  `AchelousPredictor.sharded_infer` at batch P2_BATCH over two
        shards (cuda:0 twice on one GPU) for EN-GDF-PN-S0 (K1, K2) and
        EF-GDF-PN2-S0 (K1-K4): float32 against the single request on the
        whole batch (survivors equal, floats within P2_TOL), bf16 maps
        within the serving gate; every launch held against the plain
        version; both timed
    C3  one request of the 3-task Achelous3T (`entry(..., with_pc=False)`)
        at 320x320, bf16, batch 1, K1 x4 and K2 x4, against float32 plain
        on the CPU within the serving gate

  K2 is also held against its plain version on the
exact route (band None) at C = 3, 320^2, and K4 at batch 3; K2's and K4's
launch plans are logged.  K1 is timed as its single launch on weights packed
once (the pack, which DeformableConv2d caches, is timed once beside it);
each path logs its kernel launches a request and its kernels/frame under
torch.profiler.  Any failure raises; the last line of a passing run is

    {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}

The line before it lists each kernel with its launches on every phase's
main path, its worst float32 error against the plain version, its device time
and the plain version's over one frame's calls, and the least time the
card could take for the same work.  Imports nothing of JAX.  Exits non-zero
without a result where no GPU is visible.
"""
from __future__ import annotations

import contextlib
import copy
import json
import os
import subprocess
import time

import numpy as np
import torch

from achelous_tpu_torch.kernels.timing import cuda_ms, device_ms

REQUESTS = 8
BAND = 4
# Kernel vs plain, same inputs on the card.  float32: the two sum in other
# orders (and the conv inside K1 is not cuDNN's), ~1e-6 relative per value,
# so 1e-4 leaves margin.  bf16: both compute in float32 and round the output
# once to bf16 (2^-8 relative), so results differ by at most one bf16 step.
# K4's indices must be equal.
TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (1e-2, 1e-2)}  # rtol, atol
# Serving path in bf16 on the card vs float32 plain on the CPU, same (bf16-
# representable) weights: max |bf16 - f32| / max(1, max |f32|) per output.
# bf16 keeps 8 bits; errors compound over ~60 layers.
MAIN_PATH_TOL = 5e-2
# (block, C, H) of the RadarConvs on the serving path at batch 1
K1_SHAPES = ((0, 3, 320), (1, 8, 160), (2, 8, 80), (3, 8, 80))
K2_SHAPES = ((4, 12, 40), (5, 12, 40), (6, 24, 20), (7, 24, 20))
# offset regimes: zero, |o| < 1, |o| about 3, beyond the band
K1_OFFSETS = ((0.0, 0.0), (0.05, 0.3), (0.3, 3.0), (2.0, 8.0))
K2_OFFSETS = (0.0, 0.7, 3.0, 9.0)
# K3 at EfficientFormerV2-S0's Attention4D: stage-2 blocks 4-5 (after the
# stride-2 conv) and stage-3 blocks 2-3, all N = 10^2 at 320x320
K3_CALLS = ("stage2.4", "stage2.5", "stage3.2", "stage3.3")
K3_HEADS, K3_DK, K3_DV, K3_N = 8, 32, 128, 100
# K4 at PointNet++'s four set-abstraction levels: (N, npoint)
K4_SHAPES = ((512, 128), (128, 32), (32, 8), (8, 4))
# Training (T1-T3): the reference's batch, 6 timed steps; K1/K2 launches
# a training step (forward only: the backward is the plain versions')
TRAIN_RES = 320
TRAIN_BATCH = 32
TRAIN_STEPS = 6
TRAIN_LAUNCHES = {"fused_radarconv": 4, "deform_samples": 4}
# T2, the card's float32 step against the CPU's, at batch STEP_BATCH:
# losses and grad_norm within STEP_LOSS_RTOL relative; the largest
# difference of any parameter's change over the step within STEP_REL of
# the largest change; and each parameter tensor's change within STEP_REL
# of its own (L2) plus STEP_FLOOR times the CPU's own spread for that
# tensor: the most its CPU change moves when the batch is scaled by
# 1 +- STEP_NUDGE or taken in reverse order (which changes every sum over
# the batch, as the card's other summation orders do).  That spread is
# float32's conditioning, read in the same run: PointNet's max-pools and
# batch-normalised fully connected layers carry rounding a long way.  A
# wrong gradient moves a tensor by its own size, far past both terms.
# Biases whose output goes straight into a train-mode BatchNorm have an
# exact gradient of 0, so their change is rounding noise on both sides,
# and neither term bounds noise against noise: they are held by the
# largest-change bound alone.
STEP_LOSS_RTOL = 1e-3
STEP_REL = 1e-2
STEP_FLOOR = 2.0
STEP_NUDGE = 1e-6
# T2's batch.  At batch 2, PointNet's fully connected BatchNorms normalise
# [B, C] over 2 samples whose features nearly coincide, and its float32
# gradients are chaotic: the nudge alone moves grad_norm by percents.  T2
# logs that reading at batch 2 and holds the step at batch 8.
STEP_BATCH = 8
STEP_BATCHES = (2, STEP_BATCH)
# T4: K3 at EF's training shapes (batch 32, the 4 Attention4D calls of a
# step, all N = 100 at 320^2) and the serving ones
K3_GRAD_CASES = ((TRAIN_BATCH, K3_N), (1, K3_N))
# The Attention4D parameters whose gradient reaches them only through K3,
# less those whose exact gradient is 0 (q.0's and k.0's biases in front of
# a train-mode BatchNorm; k.1's bias and th1's bias, which shift a whole
# row of logits that the softmax then removes): T4 and the tests hold
# these nonzero
K3_GRADIENT = ("q.0.weight", "q.1.weight", "q.1.bias", "k.0.weight",
               "k.1.weight", "attention_biases", "talking_head1.weight",
               "talking_head2.weight", "talking_head2.bias")
# T5: the EF and PN2 training paths, their kernels' launches a step, and
# their steps (the first a warm-up)
TRAIN_PATHS = (
    ("EF-GDF-PN-S0", "ef", "pn",
     {"fused_radarconv": 4, "deform_samples": 4, "fused_bias_attention": 4}),
    ("EN-GDF-PN2-S0", "en", "pn2",
     {"fused_radarconv": 4, "deform_samples": 4, "farthest_point_sample": 4}),
)
PATH_STEPS = 4
# T6: the configurations whose step the CPU tests hold against JAX's
# beyond T3's and T5's: (label, AchelousConfig fields, launches a step),
# a warm-up and a timed step each
T6_PATHS = (
    ("EN-GDF-PN-S1", dict(phi="S1"), TRAIN_LAUNCHES),
    ("EN-GDF-PN-S2", dict(phi="S2"), TRAIN_LAUNCHES),
    ("EN-GDF-PN-S0 SPPF", dict(use_spp=False), TRAIN_LAUNCHES),
    ("EN-GDF-PN-S0 base head", dict(nano_head=False), TRAIN_LAUNCHES),
    ("MV-GDF-PN-S1", dict(backbone="mv", phi="S1"), TRAIN_LAUNCHES),
    ("EN-CDF-PN2-S2", dict(phi="S2", neck="cdf", pc_model="pn2"),
     dict(TRAIN_LAUNCHES, farthest_point_sample=4)),
    ("EV-GDF-PN-S0", dict(backbone="ev"), TRAIN_LAUNCHES),
    ("PF-GDF-PN-S0", dict(backbone="pf"), TRAIN_LAUNCHES),
    # RCNet at L: K1 on block 0 alone, K2 on the other seven
    ("EF-GDF-PN-L", dict(backbone="ef", phi="L"),
     {"fused_radarconv": 1, "deform_samples": 7, "fused_bias_attention": 12}),
)
T6_STEPS = 2
# T7: the reparameterizable configurations, trained in their train form
# as T6 trains, then each trained EMA folded and served in its deploy
# form: (label, AchelousConfig fields, launches a step, whether the served
# bf16 outputs are held within MAIN_PATH_TOL of float32 plain).  A few
# steps leave MobileOne-S0's running statistics near (0, 1): its
# eval-mode maps grow ~2x a block to ~1e8, where bf16 keeps few of their
# digits, and its bf16 outputs move with the EMA (which the card's
# non-deterministic backward changes from run to run) from 0.025 to 0.451
# of det2's scale.  Its bf16 outputs are logged beside their spread;
# every form is held in float32 instead (FLOAT32_PATH_TOL).
T7_PATHS = (
    ("RV-GDF-PN-S0", dict(backbone="rv"), TRAIN_LAUNCHES, True),
    ("MO-RDF-PN-S0", dict(backbone="mo", neck="rdf"), TRAIN_LAUNCHES,
     False),
    ("FV-RDF-PN-S0", dict(backbone="fv", neck="rdf"), TRAIN_LAUNCHES, True),
)
OUTPUT_NAMES = ("det0", "det1", "det2", "sem", "lane", "pc")
# one bf16 step: the requests scaled by 1 +- BF16_NUDGE read how far a
# state amplifies bf16's rounding
BF16_NUDGE = 2.0 ** -8
# T7: a trained EMA's deploy form in float32 on the card (TF32 off)
# against itself in float32 on the CPU (the plain versions), relative to
# each output's scale: both float32, summed in other orders
FLOAT32_PATH_TOL = 1e-3
# F1: the tree (frames of 480x270, a quarter of WaterScenes' 1920x1080
# camera), its batch, epochs
FIT_TRAIN, FIT_VAL, FIT_SIZE, FIT_BATCH, FIT_EPOCHS = 16, 8, (480, 270), 8, 2
# (name, backbone, pc_model, launches a request of each kernel)
PATHS = (
    ("EN-GDF-PN-S0", "en", "pn",
     {"fused_radarconv": 4, "deform_samples": 4}),
    ("EN-GDF-PN2-S0", "en", "pn2",
     {"fused_radarconv": 4, "deform_samples": 4, "farthest_point_sample": 4}),
    ("EF-GDF-PN-S0", "ef", "pn",
     {"fused_radarconv": 4, "deform_samples": 4, "fused_bias_attention": 4}),
)
# C1: the other configurations of BENCH_SWEEP.json, each served like the
# paths above: (label, entry() arguments, launches a request)
SWEEP_LAUNCHES = {"fused_radarconv": 4, "deform_samples": 4}
SWEEP = (
    ("EN-GDF-PN-S1", dict(phi="S1"), SWEEP_LAUNCHES),
    ("EN-GDF-PN-S2", dict(phi="S2"), SWEEP_LAUNCHES),
    ("EN-GDF-PN-S0 SPPF", dict(use_spp=False), SWEEP_LAUNCHES),
    ("MV-GDF-PN-S1", dict(backbone="mv", phi="S1"), SWEEP_LAUNCHES),
    ("EN-CDF-PN2-S2", dict(phi="S2", neck="cdf", pc_model="pn2"),
     dict(SWEEP_LAUNCHES, farthest_point_sample=4)),
)
# C1 serves fewer requests than the main paths to leave C2 its time
C1_REQUESTS = 4
# C2: (label, entry() arguments, launches a request); the deploy forms'
# labels end in "deploy"
C2_LAUNCHES = {"fused_radarconv": 4, "deform_samples": 4}
C2 = (
    ("EV-GDF-PN-S0", dict(backbone="ev"), C2_LAUNCHES),
    ("RV-GDF-PN-S0", dict(backbone="rv"), C2_LAUNCHES),
    ("PF-GDF-PN-S0", dict(backbone="pf"), C2_LAUNCHES),
    ("MO-RDF-PN-S0", dict(backbone="mo", neck="rdf"), C2_LAUNCHES),
    ("MO-RDF-PN-S0 deploy", dict(backbone="mo", neck="rdf", deploy=True),
     C2_LAUNCHES),
    ("FV-RDF-PN-S0", dict(backbone="fv", neck="rdf"), C2_LAUNCHES),
    ("FV-RDF-PN-S0 deploy", dict(backbone="fv", neck="rdf", deploy=True),
     C2_LAUNCHES),
    # RCNet at L is 10-96 channels wide: only block 0 (3 -> 3 in its
    # RadarConv) is within K1's 8, the other seven take K2
    ("EF-GDF-PN-L", dict(backbone="ef", phi="L"),
     {"fused_radarconv": 1, "deform_samples": 7, "fused_bias_attention": 12}),
)
# C2's deploy form against its train form, both float32 on the card with
# TF32 off: max |deploy - train| / max(1, max |train|) per output.  The
# fold sums the branches' kernels before the conv instead of after: float32
# rounding, ~1e-6 relative
DEPLOY_TOL = 1e-4
DEPLOY_REQUESTS = 2
# C2's reparameterizable backbones: their BatchNorms' statistics and
# affine drawn (c2_weights), the affine at about 1/sqrt(the branches a
# block sums), so that a block keeps its input's scale as a trained one
# does: MobileOne-S0 sums up to six (4 convs, the 1x1 scale branch, the
# skip BN), RepViT's RepVGGDW and FastViT's MobileOne stem and embeddings
# three.  At scale 1 MobileOne's maps grow by ~1e11 over the backbone; at
# 0.5 the bf16 rounding its branches amplify reached 0.078 of the lane
# map's scale on the card against float32
C2_NORM_SCALE = {"rv": 0.5, "mo": 0.4, "fv": 0.6}
# EfficientFormerV2-L has 6 attention blocks in each of stages 2-3 where
# S0 has 2: its layer scales at a third of S0's 0.05 keep the attention
# branches' sum at S0's scale (at 0.05 its maps grow to ~50 and bf16 drifts
# to 0.073 of det2's scale on the card); zeroing K3's output still moves
# every output by most of its range
C2_LAYER_SCALE = {"L": 0.05 * 2 / 6}
# P1, the predictor: WaterScenes' camera frames (width, height), radar
# points a CSV, the fps probe's detections; each frame's launches on the
# banded route (K1 on blocks 0-3, K2 on 4-7) and at band None (K2 on all
# eight, as torch-transplant weights are served)
P1_FRAME = (1920, 1080)
P1_FRAMES = 2
P1_RADAR_POINTS = 400
FPS_INTERVAL = 50
P1_LAUNCHES = {"banded": {"fused_radarconv": 4, "deform_samples": 4},
               "band None": {"deform_samples": 8}}
# P1 card vs CPU, both float32 with TF32 off: detections equal in count
# and class but where a score lies within P1_SCORE_EDGE of the threshold;
# boxes within P1_BOX_REL of the frame's width (in frame pixels);
# unletterboxed probabilities within P1_PROB_TOL.  Random weights put the
# frame's scores in a narrow band, which the default 0.35 may cut at
# either end (no detection, or max_det of them), so the comparison's
# threshold is taken from the CPU's scores: in the widest gap between
# consecutive scores of ranks P1_RANKS
P1_RANKS = (20, 60)
P1_SCORE_EDGE = 1e-4
P1_BOX_REL = 1e-3
P1_PROB_TOL = 1e-4
# X1: the exported program's kernel nodes
X1_NODES = {"fused_radarconv": 4, "deform_samples": 4}
# The least time of a call: the larger of its bytes (each input read once,
# each output written once) over the HBM rate and its operations over the
# peak rate for the inputs' type (NVIDIA's H100 SXM data sheet at 700 W:
# 3.35 TB/s; 989 TFLOP/s bf16 dense, 67 TFLOP/s float32 outside the tensor
# cores).
# D1/D2: ranks of the data-parallel runs; D1's timed bf16 steps (the
# first a warm-up) and its steps of the same rows without the group
DIST_WORLD = 2
D1_STEPS = 5
D1_LOCAL_STEPS = 3
# P2: sharded_infer's batch, its paths, float32 sharded vs single request
# (|diff| / (|ref| + 1): the shards' convolutions may pick other
# algorithms than the whole batch's, ~1e-6 apart)
P2_BATCH, P2_RES = 8, 320
P2_PATHS = (
    ("EN-GDF-PN-S0", "en", "pn", {"fused_radarconv": 4, "deform_samples": 4}),
    ("EF-GDF-PN2-S0", "ef", "pn2",
     {"fused_radarconv": 4, "deform_samples": 4, "fused_bias_attention": 4,
      "farthest_point_sample": 4}))
P2_TOL = 1e-5
P2_CONF = 0.05          # low enough that random weights leave detections
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}


def log(*a):
    print(*a, flush=True)


def device_line() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device visible; this test "
                         "runs only on a GPU")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def wrappers():
    """Kernel name -> its wrapper, which counts launches in `launches`."""
    from achelous_tpu_torch.ops import (hopper_attention, hopper_deform,
                                        hopper_pointops)
    return {"fused_radarconv": hopper_deform.fused_radarconv,
            "deform_samples": hopper_deform.deform_samples,
            "fused_bias_attention": hopper_attention.fused_bias_attention,
            "farthest_point_sample": hopper_pointops.farthest_point_sample}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(nb: int, flops: float, dtype) -> tuple[float, float]:
    """(ms to move `nb` bytes, ms to do `flops` operations) on an H100."""
    return nb / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3


def k1_case(rng, c, h, ow, ob, dev):
    """Raw input and RadarConv weights (port layout) for one K1 call."""
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    return (t(rng.rand(1, c, h, h)), t(rng.randn(18, c, 3, 3) * ow),
            t(rng.randn(18) * ob), t(rng.randn(9, c, 3, 3) * 0.3),
            t(rng.randn(9) * 0.3), t(rng.randn(c, c, 3, 3) * 0.2))


def k1_flops(args) -> float:
    """Per pixel: 3x3 pool (10 a channel), offset and modulator conv
    (27 x 9C MACs), tap weights and the sigmoid (~126), modulated bilinear
    samples (9 taps x 9 a channel), projection (9C x Cout MACs)."""
    _, c, h, w = args[0].shape
    cout = args[5].shape[0]
    return h * w * (10 * c + 486 * c + 126 + 81 * c + 18 * c * cout)


def k2_case(rng, c, h, scale, dev):
    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    return (t(rng.rand(1, c, h, h)), t((rng.rand(1, 18, h, h) * 2 - 1) * scale),
            t(rng.rand(1, 9, h, h) * 2))


def k2_flops(args) -> float:
    """Per tap and pixel: bilinear weights (~10), then 4 MACs and the mask
    product per channel."""
    b, c, h, w = args[0].shape
    return b * 9 * h * w * (10 + 9 * c)


def k3_case(rng, b, n, dev):
    """q, k, v, bias, th1_w, th1_b, th2_w, th2_b, float32, non-symmetric
    head mixes."""
    h = K3_HEADS
    shapes = ((b, h, n, K3_DK), (b, h, n, K3_DK), (b, h, n, K3_DV), (h, n, n),
              (h, h), (h,), (h, h), (h,))
    return [torch.from_numpy((rng.randn(*s) * 0.5).astype(np.float32)).to(dev)
            for s in shapes]


def k3_flops(args) -> float:
    """q.k^T, scale and bias, two head mixes with their biases, softmax
    (~5 a logit), P.v."""
    b, h, n, dk = args[0].shape
    dv = args[2].shape[-1]
    logits = b * h * n * n
    return logits * (2 * dk + 2 + 2 * (2 * h + 1) + 5 + 2 * dv)


def k4_flops(n: int, npoint: int) -> float:
    """Per step and point: 3 subtractions, 3 products, 2 sums, the min and
    the argmax comparison."""
    return npoint * n * 10


def check(name, got, want, dtype, top):
    """Max abs error of the kernel's output against the plain version's;
    raises outside TOL.  `top[dtype]` keeps the largest |output| seen, the
    scale a bf16 step is read against."""
    rtol, atol = TOL[dtype]
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item()
    if not torch.allclose(g, w, rtol=rtol, atol=atol):
        raise AssertionError(f"{name}: kernel disagrees with plain version, "
                             f"max abs err {err} (rtol {rtol}, atol {atol})")
    top[dtype] = max(top[dtype], w.abs().max().item())
    return err


def timed(name, label, kernel, plain, plain_iters=5):
    """Device and as-issued ms of one call, kernel and plain; logged."""
    t_k, t_p = device_ms(kernel), device_ms(plain, plain_iters)
    h_k, h_p = cuda_ms(kernel), cuda_ms(plain)
    log(f"kernel {name} {label}: device {t_k:.4f} ms (plain {t_p:.4f} ms); "
        f"as issued {h_k:.4f} ms (plain {h_p:.4f} ms)")
    return t_k, t_p


def result(worst, ms, plain_ms, t_bytes, t_ops):
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                bound_ms=sum(max(b, o) for b, o in zip(t_bytes, t_ops)),
                bound_by="bytes" if sum(t_bytes) >= sum(t_ops)
                else "operations",
                # no single PyTorch call computes these functions: the
                # RadarConv and its banded sampling have none, the head mix
                # sits inside the softmax, FPS is sequential
                library_ms=None)


def check_deform_kernels(dev, rng):
    """K1 and K2 against their plain versions at the serving shapes,
    float32 (TF32 off) and bf16."""
    from achelous_tpu_torch.ops import deform, hopper_deform
    w = wrappers()
    results = {}

    def k1_bind(a):
        """K1 on one case: the weights packed once, outside any timing, as
        DeformableConv2d caches them; the call is the kernel's one launch."""
        packed = hopper_deform.pack_radarconv_weights(*a[1:])
        return lambda: w["fused_radarconv"](a[0], *packed, BAND)

    specs = (
        ("fused_radarconv", deform.fused_radarconv_reference, K1_SHAPES,
         K1_OFFSETS, lambda c, h, o: k1_case(rng, c, h, *o, dev), k1_flops,
         k1_bind),
        ("deform_samples", deform.banded_deform_samples, K2_SHAPES,
         K2_OFFSETS, lambda c, h, o: k2_case(rng, c, h, o, dev), k2_flops,
         lambda a: lambda: w["deform_samples"](*a, BAND)),
    )
    for name, plain, shapes, offsets, make, flops, bind in specs:
        worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
        top = dict(worst)
        ms = plain_ms = 0.0
        t_bytes, t_ops = [], []
        for block, c, h in shapes:
            for off in offsets:
                args = make(c, h, off)
                for dt in (torch.float32, torch.bfloat16):
                    a = [x.to(dt) for x in args]
                    got = bind(a)()
                    want = plain(*a, BAND)
                    torch.cuda.synchronize()
                    worst[dt] = max(worst[dt], check(
                        f"{name} block {block} {dt} offsets {off}", got,
                        want, dt, top))
            # time the serving dtype at the largest-offset regime: device
            # time per call, and the rate the host issues calls at
            a = [x.to(torch.bfloat16) for x in args]
            if name == "deform_samples":
                plan = hopper_deform.deform_samples_plan(
                    1, c, h, h, hopper_deform.sm_count(dev))
                log(f"kernel deform_samples block {block} C={c} {h}x{h} "
                    f"bf16: plan {plan}")
            kernel = bind(a)
            t_k, t_p = timed(name, f"block {block} C={c} {h}x{h} bf16",
                             kernel, lambda: plain(*a, BAND))
            if name == "fused_radarconv" and block == 0:
                def pack():
                    return hopper_deform.pack_radarconv_weights(*a[1:])
                log(f"kernel fused_radarconv: weight pack (once a module, "
                    f"cached) device {device_ms(pack):.4f} ms, as issued "
                    f"{cuda_ms(pack):.4f} ms")
            ms += t_k
            plain_ms += t_p
            out = kernel()
            tb, to = bound(nbytes(*a, out), flops(a), torch.bfloat16)
            t_bytes.append(tb)
            t_ops.append(to)
        if name == "deform_samples":
            worst = check_exact_samples(dev, rng, worst, top)
        log(f"kernel {name}: max abs err f32 {worst[torch.float32]:.3g}, "
            f"bf16 {worst[torch.bfloat16]:.3g} (max |out| "
            f"{top[torch.bfloat16]:.3g})")
        results[name] = result(worst[torch.float32], ms, plain_ms, t_bytes,
                               t_ops)
    return results


def check_exact_samples(dev, rng, worst, top):
    """K2 on the exact route (band None), which a reference checkpoint
    takes at every RCNet block: block 0's shape, C = 3 at 320^2, offsets
    past the band.  Timed and logged; not part of a serving frame."""
    from achelous_tpu_torch.ops import deform, hopper_deform
    kernel = wrappers()["deform_samples"]
    args = k2_case(rng, 3, 320, 9.0, dev)
    for dt in (torch.float32, torch.bfloat16):
        a = [x.to(dt) for x in args]
        got = kernel(*a, None)
        want = deform.banded_deform_samples(*a, None)
        torch.cuda.synchronize()
        worst[dt] = max(worst[dt], check(
            f"deform_samples band None C=3 320x320 {dt}", got, want, dt, top))
    plan = hopper_deform.deform_samples_plan(1, 3, 320, 320,
                                             hopper_deform.sm_count(dev))
    log(f"kernel deform_samples band None C=3 320x320 bf16: plan {plan}")
    timed("deform_samples", "band None C=3 320x320 bf16",
          lambda: kernel(*a, None),
          lambda: deform.banded_deform_samples(*a, None))
    return worst


def check_attention_kernel(dev, rng):
    """K3 against its plain version at the serving shape (batch 1, N = 100)
    and at N = 16, batch 2, float32 (TF32 off) and bf16."""
    from achelous_tpu_torch.ops.attention import reference_bias_attention
    kernel = wrappers()["fused_bias_attention"]
    scale = K3_DK ** -0.5
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    top = dict(worst)
    for b, n in ((1, K3_N), (2, 16)):
        args = k3_case(rng, b, n, dev)
        for dt in (torch.float32, torch.bfloat16):
            a = [x.to(dt) for x in args]
            got = kernel(*a, scale)
            want = reference_bias_attention(*a, scale)
            torch.cuda.synchronize()
            worst[dt] = max(worst[dt], check(
                f"fused_bias_attention B={b} N={n} {dt}", got, want, dt,
                top))
    ms = plain_ms = 0.0
    t_bytes, t_ops = [], []
    for call in K3_CALLS:
        a = [x.to(torch.bfloat16) for x in k3_case(rng, 1, K3_N, dev)]
        t_k, t_p = timed("fused_bias_attention", f"{call} N={K3_N} bf16",
                         lambda: kernel(*a, scale),
                         lambda: reference_bias_attention(*a, scale))
        ms += t_k
        plain_ms += t_p
        tb, to = bound(nbytes(*a, kernel(*a, scale)), k3_flops(a),
                       torch.bfloat16)
        t_bytes.append(tb)
        t_ops.append(to)
    log(f"kernel fused_bias_attention: max abs err f32 "
        f"{worst[torch.float32]:.3g}, bf16 {worst[torch.bfloat16]:.3g} "
        f"(max |out| {top[torch.bfloat16]:.3g})")
    return result(worst[torch.float32], ms, plain_ms, t_bytes, t_ops)


def k4_cases(rng):
    """(label, xyz [B,N,3] float32 numpy, npoint, valid or None)."""
    cases = [(f"random {n}->{s}", rng.rand(1, n, 3), s, None)
             for n, s in K4_SHAPES]
    # the data loader resamples 512 points with replacement: duplicates,
    # and coarse coordinates make equal distances common
    base = np.round(rng.rand(60, 3) * 16) / 16
    for n, s in K4_SHAPES:
        cases.append((f"resampled {n}->{s}",
                      base[rng.randint(0, 60, (1, n))], s, None))
        cases.append((f"valid {n}->{s}", rng.randn(1, n, 3), s,
                      rng.rand(1, n) > 0.3))
        cases.append((f"identical {n}->{s}", np.ones((1, n, 3)), s, None))
    # batch 3: a block a batch element
    cases.append(("random B=3 512->128", rng.rand(3, 512, 3), 128, None))
    cases.append(("valid B=3 512->128", rng.randn(3, 512, 3), 128,
                  rng.rand(3, 512) > 0.3))
    return [(lbl, x.astype(np.float32), s, v) for lbl, x, s, v in cases]


def check_fps_kernel(dev, rng):
    """K4's indices equal its plain version's on the card, at the four
    set-abstraction shapes, on random points, resampled duplicates, a valid
    mask and identical points."""
    from achelous_tpu_torch.ops.hopper_pointops import fps_plan
    from achelous_tpu_torch.ops.pointops import farthest_point_sample as plain
    kernel = wrappers()["farthest_point_sample"]
    log("kernel farthest_point_sample plans (threads, points a thread): "
        + ", ".join(f"N={n} {fps_plan(n)}" for n, _ in K4_SHAPES)
        + "; cross-warp winner by compare tree up to 4 warps")
    cases = k4_cases(rng)
    for label, xyz, npoint, valid in cases:
        x = torch.from_numpy(xyz).to(dev)
        v = None if valid is None else torch.from_numpy(valid).to(dev)
        got, want = kernel(x, npoint, v), plain(x, npoint, v)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            bad = int((got != want).sum())
            raise AssertionError(f"farthest_point_sample {label}: {bad} "
                                 f"indices differ from the plain version")
    ms = plain_ms = 0.0
    t_bytes, t_ops = [], []
    for n, npoint in K4_SHAPES:
        x = torch.from_numpy(rng.rand(1, n, 3).astype(np.float32)).to(dev)
        t_k, t_p = timed("farthest_point_sample", f"{n}->{npoint} f32",
                         lambda: kernel(x, npoint), lambda: plain(x, npoint),
                         plain_iters=1)
        ms += t_k
        plain_ms += t_p
        tb, to = bound(nbytes(x, kernel(x, npoint)), k4_flops(n, npoint),
                       torch.float32)
        t_bytes.append(tb)
        t_ops.append(to)
    log(f"kernel farthest_point_sample: indices equal on {len(cases)} "
        f"cases")
    return result(0.0, ms, plain_ms, t_bytes, t_ops)


def check_kernels(dev):
    """Phase 3: every kernel against its plain version; per-kernel
    results."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)
    results = check_deform_kernels(dev, rng)
    results["fused_bias_attention"] = check_attention_kernel(dev, rng)
    results["farthest_point_sample"] = check_fps_kernel(dev, rng)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    return results


def requests(cfg, n: int, seed: int = 100):
    """n distinct seeded requests, made in bulk: (image, radar, points)."""
    rng = np.random.RandomState(seed)
    r = cfg.resolution
    img = rng.rand(n, 1, 3, r, r).astype(np.float32)
    rad = rng.rand(n, 1, 3, r, r).astype(np.float32)
    pts = rng.rand(n, 1, cfg.pc_points, cfg.pc_channels).astype(np.float32)
    return [tuple(torch.from_numpy(a[i]) for a in (img, rad, pts))
            for i in range(n)]


def record_set_abstraction(model):
    """Per set-abstraction level, a list that collects (xyz in, centres
    out) of every forward, and the hooks' handles."""
    records, handles = [], []
    for i in range(1, 5):
        rec = []
        handles.append(getattr(model.pc_seg_model, f"sa{i}")
                       .register_forward_hook(
                           lambda m, inp, out, rec=rec:
                           rec.append((inp[0], out[0]))))
        records.append(rec)
    return records, handles


def check_fps_on_path(npoints, card_records, ref_records, n):
    """The PN2 path's FPS on the card picked exactly the plain version's
    indices on the same bf16-rounded points, at every level of each of
    the `n` requests."""
    from achelous_tpu_torch.ops.pointops import farthest_point_sample as plain
    kernel = wrappers()["farthest_point_sample"]
    for lvl, (card, ref) in enumerate(zip(card_records, ref_records)):
        if len(card) != n or len(ref) != n:
            raise AssertionError(f"sa{lvl + 1}: {len(card)} card and "
                                 f"{len(ref)} reference records")
        for i, ((xyz, centres), (rxyz, rcentres)) in enumerate(zip(card, ref)):
            if not (torch.equal(xyz.cpu(), rxyz)
                    and torch.equal(centres.cpu(), rcentres)):
                raise AssertionError(f"sa{lvl + 1} request {i}: FPS centres "
                                     f"on the card differ from plain")
            got = kernel(xyz.contiguous(), npoints[lvl]).cpu()
            if not torch.equal(got, plain(rxyz, npoints[lvl])):
                raise AssertionError(f"sa{lvl + 1} request {i}: FPS indices "
                                     f"on the card differ from plain")


@contextlib.contextmanager
def on_path_inputs(records):
    """While open, each kernel's launch site keeps a copy of the inputs of
    every launch in `records`, as (name, args); the launches and their
    counts are the main path's own."""
    from achelous_tpu_torch.ops import (hopper_attention, hopper_deform,
                                        hopper_pointops)
    sites = ((hopper_deform, "_fused_forward", "fused_radarconv"),
             (hopper_deform, "_samples_forward", "deform_samples"),
             (hopper_attention, "_attention_forward", "fused_bias_attention"),
             (hopper_pointops, "launch_fps", "farthest_point_sample"))

    def recorder(launch, name):
        def record(*args):
            records.append((name, [a.detach().clone() if torch.is_tensor(a)
                                   else a for a in args]))
            return launch(*args)
        return record
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in sites]
    try:
        for (mod, attr, name), (_, _, launch) in zip(sites, saved):
            setattr(mod, attr, recorder(launch, name))
        yield records
    finally:
        for mod, attr, launch in saved:
            setattr(mod, attr, launch)


def check_on_path(label, records):
    """Each recorded launch against the plain version on the same inputs:
    in the path's dtype (TOL) and, for K1-K3, again with the inputs of
    that dtype taken to float32, TF32 off; K4's indices equal, with its
    valid mask and without."""
    from achelous_tpu_torch.ops import (hopper_attention, hopper_deform,
                                        hopper_pointops)
    from achelous_tpu_torch.ops.attention import reference_bias_attention
    from achelous_tpu_torch.ops.deform import banded_deform_samples
    from achelous_tpu_torch.ops.pointops import farthest_point_sample
    kernels = {"fused_radarconv": hopper_deform._fused_forward,
               "deform_samples": hopper_deform._samples_forward,
               "fused_bias_attention": hopper_attention._attention_forward,
               "farthest_point_sample": hopper_pointops.launch_fps}
    # the launch's last argument: K1's and K2's band, K3's scale
    plains = {
        "fused_radarconv": lambda x, *w, last:
            hopper_deform._plain_radarconv(last)(x, *w),
        "deform_samples": lambda *a, last: banded_deform_samples(*a, last),
        "fused_bias_attention": lambda *a, last:
            reference_bias_attention(*a, last)}
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst, seen = {}, {}
    with torch.no_grad():
        for name, args in records:
            kernel = kernels[name]
            if name == "farthest_point_sample":
                xyz, npoint, valid = args[:3]
                cases = [(valid, "")] + ([(None, " no mask")]
                                         if valid is not None else [])
                for v, tag in cases:
                    got = kernel(xyz, npoint, v, None)
                    if not torch.equal(got, farthest_point_sample(xyz, npoint,
                                                                  v)):
                        raise AssertionError(
                            f"{label} {name} {tuple(xyz.shape)}{tag}: "
                            f"indices differ from the plain version")
                key = f"{name} {tuple(xyz.shape)}"
                seen[key] = seen.get(key, 0) + 1
                continue
            *ts, last = args
            dtypes = [ts[0].dtype] + ([torch.float32] if ts[0].dtype !=
                                      torch.float32 else [])
            for dt in dtypes:
                # K1's packed weights stay float32 whatever x's dtype
                a = [t.to(dt) if t.dtype == ts[0].dtype else t for t in ts]
                err = check(f"{label} {name} {tuple(ts[0].shape)} {dt}",
                            kernel(*a, last), plains[name](*a, last=last),
                            dt, {dt: 0.0})
                worst[(name, dt)] = max(worst.get((name, dt), 0.0), err)
            key = (f"{name} {tuple(ts[0].shape)} "
                   f"{str(ts[0].dtype).split('.')[-1]}")
            seen[key] = seen.get(key, 0) + 1
    torch.cuda.synchronize()
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    log(f"{label}: {len(records)} on-path launches held against the plain "
        f"version ({'; '.join(f'{k} x{n}' for k, n in seen.items())}); "
        f"max abs err " + ", ".join(
            f"{n} {str(d).split('.')[-1]} {e:.3g}"
            for (n, d), e in sorted(worst.items(), key=str)))


def serve_path(dev, label, want_rose, records=None, n=REQUESTS, held=True,
               **path):
    """Phase 4, C1, C2 and T7: serve `n` requests through entry(**path) on
    one path (its config's name leads `label`), with the launch counts
    set to 0 just before and read just after; check the outputs against
    float32 plain on the CPU (unless `held` is false, then only log
    them).  With `records`, the kernels' launch sites keep the
    inputs of every launch there (`on_path_inputs`).  Without a
    `state_dict` in `path`, the seed-0 weights get their offset convs and
    layer scales drawn (`perturb_deform_convs`, `perturb_attention`)."""
    from achelous_tpu_torch.entry import (entry, perturb_attention,
                                          perturb_deform_convs)
    from achelous_tpu_torch.models.achelous import cast_compute

    fn, _ = entry(dev, torch.Generator().manual_seed(0), **path)
    model, cfg = fn.model, fn.cfg
    if cfg.name != label.split()[0]:
        raise AssertionError(f"entry built {cfg.name}, want {label}")
    if path.get("deploy", False) != model.deploy:
        raise AssertionError(f"{label}: deploy form {model.deploy}")
    if path.get("state_dict") is None:
        perturb_deform_convs(model)
        perturb_attention(model)
    # the same (bf16) weights in float32 on the CPU: the plain versions
    ref_model = cast_compute(copy.deepcopy(model).cpu(), torch.float32)
    pn2 = cfg.pc_model == "pn2"

    reqs = requests(cfg, n)
    dev_reqs = [tuple(t.to(dev, cfg.dtype) for t in q) for q in reqs]
    fn(*dev_reqs[0])                                   # warm-up
    torch.cuda.synchronize()
    if pn2:
        card_sa, hooks = record_set_abstraction(model)
        ref_sa, ref_hooks = record_set_abstraction(ref_model)

    w = wrappers()
    want_rose = {n: want_rose.get(n, 0) for n in w}
    for f in w.values():
        f.launches = 0
    outs = []
    with (contextlib.nullcontext() if records is None
          else on_path_inputs(records)):
        for i, q in enumerate(dev_reqs):
            before = {n: f.launches for n, f in w.items()}
            outs.append(fn(*q))
            rose = {n: f.launches - before[n] for n, f in w.items()}
            if rose != want_rose:
                raise AssertionError(f"{label} request {i}: kernel launches "
                                     f"{rose}, want {want_rose}")
    torch.cuda.synchronize()
    counts = {k: f.launches for k, f in w.items()}
    log(f"main path {label}: launches over {n} requests {counts}; "
        f"a request {want_rose}")

    r, k = cfg.resolution, cfg.num_det
    worst = {}
    with torch.inference_mode():
        for q, dq, (dets, sem, lane, *pc) in zip(reqs, dev_reqs, outs):
            det = model.det_head(model.image_radar_encoder(*dq[:2])[0])
            # the reference sees the same bf16-rounded inputs
            want_det, want_sem, want_lane, *want_pc = ref_model(
                *(t.to(cfg.dtype).float() for t in q))
            got = {"det": det, "sem": sem, "lane": lane}
            want = {"det": want_det, "sem": want_sem, "lane": want_lane}
            shapes = {"sem": (1, cfg.num_seg, r, r), "lane": (1, 2, r, r)}
            if model.with_pc:         # Achelous3T (C3) has no point cloud
                got["pc"], want["pc"] = pc[0], want_pc[0]
                shapes["pc"] = (1, cfg.pc_points, cfg.pc_classes)
            for name, s in shapes.items():
                if tuple(got[name].shape) != s:
                    raise AssertionError(f"{name} shape {tuple(got[name].shape)}"
                                         f", want {s}")
            for lvl, (g, stride) in enumerate(zip(det, (8, 16, 32))):
                s = (1, 5 + k, r // stride, r // stride)
                if tuple(g.shape) != s:
                    raise AssertionError(f"det[{lvl}] shape {tuple(g.shape)},"
                                         f" want {s}")
            if dets.boxes.shape != (1, 100, 4) or not bool(
                    torch.isfinite(dets.boxes).all()):
                raise AssertionError("detections: bad shape or non-finite")
            pairs = [(name, got[name], want[name]) for name in shapes]
            pairs += [(f"det{i}", g, w) for i, (g, w) in
                      enumerate(zip(got["det"], want["det"]))]
            for name, g, w in pairs:
                g = g.float().cpu()
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"{name}: non-finite output")
                e = ((g - w).abs().max() / max(1.0, w.abs().max().item())
                     ).item()
                worst[name] = max(worst.get(name, 0.0), e)
    log(f"main path {label} vs float32 plain (max err / max(1, max|ref|)): "
        + ", ".join(f"{n} {e:.3g}" for n, e in worst.items()))
    bad = {n: e for n, e in worst.items() if e > MAIN_PATH_TOL}
    if held and bad:
        raise AssertionError(f"{label} outside {MAIN_PATH_TOL}: {bad}")
    if pn2:
        for h in hooks + ref_hooks:
            h.remove()
        check_fps_on_path([getattr(model.pc_seg_model, f"sa{i}").npoint
                           for i in range(1, 5)], card_sa, ref_sa, n)
        log(f"main path {label}: FPS indices on the card equal plain at "
            f"every level of every request")
    return counts, model, fn


def time_path(label, model, fn, dev_req):
    from achelous_tpu_torch.trace_serving import profile_frames
    ms_full = cuda_ms(lambda: fn(*dev_req), iters=50)
    with torch.inference_mode():
        ms_fwd = cuda_ms(lambda: model(*dev_req), iters=50)
    log(f"main path {label} bf16 bs1 320x320: fwd+decode+NMS {ms_full:.3f} "
        f"ms/frame, fwd only {ms_fwd:.3f} ms/frame")
    wall, busy, kernels, _ = profile_frames(fn, dev_req, frames=5)
    log(f"main path {label} under torch.profiler, 5 frames: kernels/frame "
        f"{kernels:.0f}, device busy {busy:.3f} ms/frame of {wall:.3f} ms "
        f"wall")
    return ms_full, kernels


# ---------------------------------------------------------------------------
# training: T1 gradients of K1 and K2, T2 one step against the CPU, T3 the
# slice at batch 32
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def phase(label):
    """Logs a phase's seconds when it ends; raises what it raised."""
    t0, ok = time.perf_counter(), False
    try:
        yield
        ok = True
    finally:
        torch.cuda.synchronize()
        log(f"{label}: {time.perf_counter() - t0:.1f} s"
            + ("" if ok else " (failed)"))


def grads_of(fn, leaves, g):
    """fn's output on fresh leaves and its gradients w.r.t. them, computed
    with torch's deterministic algorithms.  A Function's backward is the
    plain version's autograd on the same inputs, so the two sides of a
    comparison run one computation twice; without this, the atomics of
    its gather backward (a scatter-add) and of cuDNN's weight-gradient
    convs sum in another order each time, and a batch-32 weight gradient
    of K1 differs by float32 noise (6.5e-4 on a value below 5.5)."""
    ins = [t.detach().clone().requires_grad_(True) for t in leaves]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        out = fn(*ins)
        return out, torch.autograd.grad(out, ins, g)
    finally:
        torch.use_deterministic_algorithms(False)


def check_grads(name, got, want, dtype):
    worst = 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        worst = max(worst, check(f"{name} grad {i}", a, b, dtype,
                                 {dtype: 0.0}))
    return worst


def k1_grad_case(rng, b, c, h, dev, dtype):
    """(inputs, kernel fn, plain fn, output channels): K1 through the pack,
    so the gradients reach the module-layout weights, against the plain
    version on those weights."""
    from achelous_tpu_torch.ops import deform, hopper_deform
    x, *w = (a.to(dtype) for a in k1_case(rng, c, h, 0.3, 3.0, dev))
    x = x.expand(b, -1, -1, -1).contiguous() + torch.rand(
        b, c, h, h, device=dev).to(dtype) * 0.1

    def kernel(x, *w):
        out = wrappers()["fused_radarconv"](
            x, *hopper_deform.pack_radarconv_weights(*w), BAND)
        if type(out.grad_fn).__name__ != "FusedRadarConvBackward":
            raise AssertionError("fused_radarconv: output has no grad_fn of "
                                 "its Function")
        return out

    def plain(x, *w):
        return deform.fused_radarconv_reference(x, *w, BAND)
    return [x, *w], kernel, plain, c


def k2_grad_case(rng, b, c, h, dev, dtype):
    from achelous_tpu_torch.ops import deform
    args = [a.to(dtype) for a in k2_case(rng, c, h, 3.0, dev)]
    args = [a.expand(b, -1, -1, -1).contiguous() for a in args]
    args[0] = args[0] + torch.rand_like(args[0]) * 0.1

    def kernel(*a):
        out = wrappers()["deform_samples"](*a, BAND)
        if type(out.grad_fn).__name__ != "DeformSamplesBackward":
            raise AssertionError("deform_samples: output has no grad_fn of "
                                 "its Function")
        return out

    def plain(*a):
        return deform.banded_deform_samples(*a, BAND)
    return args, kernel, plain, 9 * c


def check_kernel_gradients(dev):
    """T1: K1's and K2's Functions against plain autograd on the card, at
    the training shapes (batch 32) and the serving shapes (batch 1),
    float32 (TF32 off) and bf16; the training shapes timed in bf16."""
    rng = np.random.RandomState(1)
    for name, shapes, make in (("fused_radarconv", K1_SHAPES, k1_grad_case),
                               ("deform_samples", K2_SHAPES, k2_grad_case)):
        worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
        fwd = plain_fwd = bwd = 0.0
        for b in (TRAIN_BATCH, 1):
            for block, c, h in shapes:
                for dt in (torch.float32, torch.bfloat16):
                    args, kernel, plain, cout = make(rng, b, c, h, dev, dt)
                    g = torch.randn(b, cout, h, h, device=dev).to(dt)
                    got_out, got = grads_of(kernel, args, g)
                    want_out, want = grads_of(plain, args, g)
                    torch.cuda.synchronize()
                    label = f"{name} block {block} B={b} {dt}"
                    check(label, got_out, want_out, dt, {dt: 0.0})
                    worst[dt] = max(worst[dt], check_grads(label, got, want,
                                                           dt))
                if b != TRAIN_BATCH:
                    continue
                # args and g are bf16 here: the step's dtype
                leaves = [a.detach().requires_grad_(True) for a in args]
                out = kernel(*leaves)
                with torch.no_grad():
                    t_k = device_ms(lambda: kernel_nograd(name, args))
                    t_p = device_ms(lambda: plain(*args), 3)
                t_b = cuda_ms(lambda: torch.autograd.grad(
                    out, leaves, g, retain_graph=True), iters=3, warmup=1)
                log(f"T1 {name} block {block} C={c} {h}x{h} B={b} bf16: "
                    f"kernel forward {t_k:.4f} ms (plain {t_p:.4f} ms), "
                    f"backward (plain recompute + autograd) {t_b:.4f} ms")
                fwd, plain_fwd, bwd = fwd + t_k, plain_fwd + t_p, bwd + t_b
        log(f"T1 {name}: Function gradients vs plain autograd, max abs err "
            f"f32 {worst[torch.float32]:.3g}, bf16 "
            f"{worst[torch.bfloat16]:.3g}; a training step's 4 calls at "
            f"B={TRAIN_BATCH} bf16: forward {fwd:.4f} ms (plain "
            f"{plain_fwd:.4f} ms), backward {bwd:.4f} ms")


def kernel_nograd(name, args):
    from achelous_tpu_torch.ops import hopper_deform
    w = wrappers()[name]
    if name == "fused_radarconv":
        return w(args[0], *hopper_deform.pack_radarconv_weights(*args[1:]),
                 BAND)
    return w(*args, BAND)


def train_model(cfg, dev, seed=0):
    """A training-form model on `dev` with the RadarConvs' offset and
    modulator convs drawn, so sampling leaves the zero-offset regime."""
    from achelous_tpu_torch.entry import perturb_deform_convs
    from achelous_tpu_torch.models.achelous import create_model
    model = create_model(cfg, dev, torch.Generator().manual_seed(seed),
                         train=True)
    perturb_deform_convs(model)
    return model


def check_radarconv_gradients(dev):
    """T1: one backward of a bf16 model gives every RadarConv parameter a
    non-zero gradient, through 4 K1 and 4 K2 launches."""
    from achelous_tpu_torch.core.config import AchelousConfig
    from achelous_tpu_torch.data.synthetic import synthetic_batch
    from achelous_tpu_torch.models.achelous import forward_compute
    cfg = AchelousConfig(resolution=TRAIN_RES, dtype=torch.bfloat16)
    model = train_model(cfg, dev)
    batch = synthetic_batch(cfg, 2, 8, seed=3, device=dev)
    w = wrappers()
    for f in w.values():
        f.launches = 0
    det, sem, lane, pc = forward_compute(model, batch["image"],
                                         batch["radar"], batch["pc"])
    counts = {n: f.launches for n, f in w.items() if f.launches}
    if counts != TRAIN_LAUNCHES:
        raise AssertionError(f"forward launches {counts}, want "
                             f"{TRAIN_LAUNCHES}")
    loss = sum(t.float().square().mean() for t in (*det, sem, lane)) \
        + pc.float().mean()
    loss.backward()
    params = {n: p for n, p in model.named_parameters()
              if ".radar_conv." in n}
    dead = [n for n, p in params.items()
            if p.grad is None or not bool(p.grad.abs().sum() > 0)]
    if len(params) != 8 * 5 or dead:
        raise AssertionError(f"RadarConv parameters without a gradient: "
                             f"{dead} (of {len(params)})")
    log(f"T1: all {len(params)} RadarConv parameters got a non-zero "
        f"gradient from one backward (forward launches {counts})")


def one_step(model, cfg, tcfg, arrays, dev, scale=1.0, reverse=False):
    """One step from `model`'s state on `dev`, the batch's image, radar map
    and points scaled by `scale`, its samples in reverse order if
    `reverse`: (name -> the change of each parameter, on the CPU; the
    metrics; the K1/K2 launches)."""
    from achelous_tpu_torch.data.synthetic import to_batch
    from achelous_tpu_torch.train.train_state import (create_train_state,
                                                      make_train_step)
    arrays = {k: v * np.float32(scale) if k in ("image", "radar", "pc")
              else v for k, v in arrays.items()}
    if reverse:
        arrays = {k: np.ascontiguousarray(v[::-1]) for k, v in arrays.items()}
    state = create_train_state(copy.deepcopy(model).to(dev), cfg, tcfg)
    w = wrappers()
    for f in w.values():
        f.launches = 0
    state, m = make_train_step(cfg, tcfg)(state, to_batch(arrays, dev), 0.01)
    before = dict(model.named_parameters())
    changes = {n: p.detach().cpu() - before[n].detach()
               for n, p in state.model.named_parameters()}
    return (changes, {k: float(v) for k, v in m.items()},
            {n: f.launches for n, f in w.items() if f.launches})


def zero_gradient_biases(model, batch):
    """Names of the biases of convs and linear layers whose output goes
    straight into a train-mode BatchNorm, found by one forward."""
    from achelous_tpu_torch.ops.norm import BatchNorm
    last, found, hooks = [None, None], set(), []

    def made(mod, inputs, out, name):
        last[:] = name, out

    def normed(mod, inputs):
        if mod.training and inputs[0] is last[1]:
            found.add(f"{last[0]}.bias")

    for name, m in model.named_modules():
        if isinstance(m, (torch.nn.Conv1d, torch.nn.Conv2d, torch.nn.Linear)
                      ) and m.bias is not None:
            hooks.append(m.register_forward_hook(
                lambda mod, i, o, name=name: made(mod, i, o, name)))
        elif isinstance(m, BatchNorm):
            hooks.append(m.register_forward_pre_hook(normed))
    with torch.no_grad():
        model(batch["image"], batch["radar"], batch["pc"])
    for h in hooks:
        h.remove()
    return found


def step_against_cpu(dev):
    """T2: one float32 step (TF32 off) of EN-GDF-PN-S0 at 320^2 on the card
    through K1/K2, on the CPU through the plain versions, and on the CPU
    with the batch scaled by 1 +- STEP_NUDGE and reversed, from the same
    state and batch; logged at each of STEP_BATCHES, held at STEP_BATCH."""
    from achelous_tpu_torch.core.config import AchelousConfig
    from achelous_tpu_torch.data.synthetic import synthetic_arrays, to_batch
    from achelous_tpu_torch.train.train_state import TrainConfig
    cfg = AchelousConfig(resolution=TRAIN_RES)
    tcfg = TrainConfig()
    model = train_model(cfg, "cpu")
    cpu = torch.device("cpu")
    zero = zero_gradient_biases(
        model, to_batch(synthetic_arrays(cfg, 2, tcfg.max_gt, seed=7), cpu))
    metrics = ("loss", "loss_det", "loss_seg", "loss_wl", "loss_pc",
               "grad_norm")
    for batch in STEP_BATCHES:
        arrays = synthetic_arrays(cfg, batch, tcfg.max_gt, seed=7)
        got, gm, counts = one_step(model, cfg, tcfg, arrays, dev)
        if counts != TRAIN_LAUNCHES:
            raise AssertionError(f"T2 launches {counts}")
        want, wm, _ = one_step(model, cfg, tcfg, arrays, cpu)
        nudged = [one_step(model, cfg, tcfg, arrays, cpu, 1 + s)
                  for s in (STEP_NUDGE, -STEP_NUDGE)]
        nudged.append(one_step(model, cfg, tcfg, arrays, cpu, reverse=True))
        rel = {k: abs(gm[k] - wm[k]) / abs(wm[k]) for k in metrics}
        gap = max(abs(m["grad_norm"] - wm["grad_norm"]) / wm["grad_norm"]
                  for _, m, _ in nudged)
        log(f"T2 batch {batch} card vs CPU, float32, relative: "
            + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
            + f"; CPU vs CPU with the batch scaled by 1 +- {STEP_NUDGE:g} "
            f"or reversed: grad_norm up to {gap:.3g}")
        # per tensor: (|card - CPU|, |CPU|, max |spread CPU - CPU|), L2
        rows = {n: (float((got[n] - dw).norm()), float(dw.norm()),
                    max(float((c[n] - dw).norm()) for c, _, _ in nudged))
                for n, dw in want.items()}

        def worst(key, k=4):
            top = sorted(rows, key=key, reverse=True)[:k]
            return ", ".join(f"{n} {key(n):.3g}" for n in top)

        def own(i):
            return lambda n: rows[n][i] / rows[n][1] if rows[n][1] else 0.0

        def against_bound(n):
            e, c, f = rows[n]
            bound = STEP_REL * c + STEP_FLOOR * f
            return e / bound if bound else (float("inf") if e else 0.0)
        rc = [n for n in rows if ".radar_conv." in n]
        log(f"T2 batch {batch} updates, L2 per tensor against the CPU's "
            f"change: card vs CPU worst {worst(own(0))}; the CPU's spread "
            f"worst {worst(own(2))}; RadarConvs ({len(rc)} tensors) worst "
            f"card vs CPU {max(own(0)(n) for n in rc):.3g}, spread "
            f"{max(own(2)(n) for n in rc):.3g}")
        if batch != STEP_BATCH:
            continue
        if gm["skipped_nonfinite"] or wm["skipped_nonfinite"] or max(
                rel.values()) > STEP_LOSS_RTOL:
            raise AssertionError(f"T2 losses/grad_norm outside "
                                 f"{STEP_LOSS_RTOL}")
        top = max(float(d.abs().max()) for d in want.values())
        diff, name = max((float((got[n] - d).abs().max()), n)
                         for n, d in want.items())
        log(f"T2: the largest change of any parameter {top:.4g}; the "
            f"largest card-CPU difference {diff:.4g} ({name}), "
            f"{diff / top:.3g} of it (bound {STEP_REL})")
        held = sorted((n for n in rows if n not in zero),
                      key=against_bound, reverse=True)
        log(f"T2: {len(zero)} biases in front of a train-mode BatchNorm "
            f"held by the largest change alone (worst card vs CPU "
            f"{max(own(0)(n) for n in zero):.3g} of its own change, the "
            f"CPU's spread {max(own(2)(n) for n in zero):.3g}); the other "
            f"{len(held)} against {STEP_REL} of their own change + "
            f"{STEP_FLOOR} x the CPU's spread, worst (ratio to the bound, "
            f"card vs CPU and spread of the own change): " + ", ".join(
                f"{n} {against_bound(n):.3g} ({own(0)(n):.3g}, "
                f"{own(2)(n):.3g})" for n in held[:4]))
        if diff > STEP_REL * top:
            raise AssertionError(f"T2 update of {name} outside {STEP_REL} "
                                 f"of the largest change")
        over = [n for n in held if against_bound(n) > 1.0]
        if over:
            raise AssertionError(f"T2 updates outside their bound: {over}")


def snapshot(state):
    return {"params": {n: p.detach().clone()
                       for n, p in state.model.named_parameters()},
            "stats": {n: t.clone() for n, t in state.batch_stats().items()},
            "trace": {n: t.clone()
                      for n, t in state.opt_state["trace"].items()},
            "ema": {n: t.clone() for n, t in
                    {**state.ema_params, **state.ema_batch_stats}.items()}}


def train_slice(dev):
    """T3: EN-GDF-PN-S0 at 320^2, batch 32, bf16 compute on float32
    parameters, the default TrainConfig: 6 steps on seeded synthetic
    batches, K1 x4 and K2 x4 a step; then one MGDA and one CAGrad step and
    a step on a batch with a NaN.  Returns the K1/K2 launches of the 6
    steps."""
    from achelous_tpu_torch.core.config import AchelousConfig
    from achelous_tpu_torch.data.synthetic import synthetic_batch
    from achelous_tpu_torch.train.train_state import (TrainConfig,
                                                      create_train_state,
                                                      make_train_step)
    cfg = AchelousConfig(resolution=TRAIN_RES, dtype=torch.bfloat16)
    tcfg = TrainConfig(batch_size=TRAIN_BATCH)
    lr = train_lr(tcfg)
    batches = [synthetic_batch(cfg, tcfg.batch_size, tcfg.max_gt,
                               seed=100 + i, device=dev)
               for i in range(TRAIN_STEPS)]
    state = create_train_state(train_model(cfg, dev), cfg, tcfg)
    step = make_train_step(cfg, tcfg)
    start = snapshot(state)
    w = wrappers()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times, totals = [], {n: 0 for n in TRAIN_LAUNCHES}
    for i, batch in enumerate(batches):
        for f in w.values():
            f.launches = 0
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0.record()
        state, m = step(state, batch, lr)
        t1.record()
        torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
        counts = {n: f.launches for n, f in w.items() if f.launches}
        if counts != TRAIN_LAUNCHES:
            raise AssertionError(f"T3 step {i}: launches {counts}, want "
                                 f"{TRAIN_LAUNCHES}")
        for n, c in counts.items():
            totals[n] += c
        vals = {k: float(v) for k, v in m.items()}
        if m["skipped_nonfinite"] or not all(np.isfinite(list(vals.values()))):
            raise AssertionError(f"T3 step {i}: metrics {vals}")
        log(f"T3 step {i}: {times[-1]:.1f} ms, " + ", ".join(
            f"{k} {v:.4g}" for k, v in vals.items()))
    peak = torch.cuda.max_memory_allocated(dev)
    ms = float(np.median(times[1:]))
    moved = sum(float((p.detach() - start["params"][n]).abs().sum())
                for n, p in state.model.named_parameters())
    lag = sum(float((state.ema_params[n] - start["params"][n]).abs().sum())
              for n in start["params"])
    if not 0 < lag < moved:
        raise AssertionError(f"T3: params moved {moved}, EMA {lag}")
    log(f"T3 EN-GDF-PN-S0 train bf16 bs{tcfg.batch_size} 320x320: "
        f"{ms:.2f} ms/step (median of steps 2-{TRAIN_STEPS}, CUDA events), "
        f"{tcfg.batch_size / ms * 1e3:.1f} images/s, peak memory "
        f"{peak / 2**30:.2f} GiB (max_memory_allocated); launches "
        f"{totals}; params moved {moved:.4g}, EMA {lag:.4g}")

    bad = dict(batches[0])
    bad["image"] = bad["image"].clone()
    bad["image"][0, 0, 0, 0] = float("nan")
    before = snapshot(state)
    state, m = step(state, bad, lr)
    after = snapshot(state)
    same = all(torch.equal(a, after[k][n]) for k, d in before.items()
               for n, a in d.items())
    if m["skipped_nonfinite"] != 1.0 or not same or state.step != \
            TRAIN_STEPS + 1:
        raise AssertionError(f"T3 NaN batch: skipped "
                             f"{m['skipped_nonfinite']}, state unchanged "
                             f"{same}, step {state.step}")
    log("T3 NaN batch: skipped_nonfinite 1, params, optimizer state, BN "
        "statistics and EMA unchanged, step counter moved")
    del state, step, start, before, after

    for mtl in ("mgda", "cagrad"):
        mcfg = TrainConfig(batch_size=TRAIN_BATCH, mtl=mtl)
        mstate = create_train_state(train_model(cfg, dev), cfg, mcfg)
        t0 = time.perf_counter()
        mstate, m = make_train_step(cfg, mcfg)(mstate, batches[0], lr)
        torch.cuda.synchronize()
        vals = {k: float(v) for k, v in m.items()}
        if m["skipped_nonfinite"] or not all(np.isfinite(list(vals.values()))):
            raise AssertionError(f"T3 {mtl}: metrics {vals}")
        log(f"T3 {mtl} step bs{tcfg.batch_size}: "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms, " + ", ".join(
                f"{k} {v:.4g}" for k, v in vals.items()))
        del mstate
    return totals


def train_phases(dev):
    """T1-T3; returns the K1/K2 launches of the training slice's run."""
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with phase("T1 gradients of K1 and K2"):
        check_kernel_gradients(dev)
        check_radarconv_gradients(dev)
    with phase("T2 one float32 step against the CPU"):
        step_against_cpu(dev)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    torch.cuda.empty_cache()
    with phase("T3 the training slice"):
        return train_slice(dev)


# ---------------------------------------------------------------------------
# T4 gradients of K3, T5 the EF and PN2 training paths, F1 `fit`
# ---------------------------------------------------------------------------


def check_attention_gradients(dev):
    """T4: K3's Function against plain autograd on the card, float32 (TF32
    off) and bf16, at K3_GRAD_CASES; the training shape timed in bf16."""
    from achelous_tpu_torch.ops.attention import reference_bias_attention
    kernel = wrappers()["fused_bias_attention"]
    scale = K3_DK ** -0.5
    rng = np.random.RandomState(2)

    def through_function(*a):
        out = kernel(*a, scale)
        if type(out.grad_fn).__name__ != "FusedBiasAttentionBackward":
            raise AssertionError("fused_bias_attention: output has no "
                                 "grad_fn of its Function")
        return out

    def plain(*a):
        return reference_bias_attention(*a, scale)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for b, n in K3_GRAD_CASES:
        args = k3_case(rng, b, n, dev)
        for dt in (torch.float32, torch.bfloat16):
            a = [x.to(dt) for x in args]
            g = torch.randn(b, K3_HEADS, n, K3_DV, device=dev).to(dt)
            got_out, got = grads_of(through_function, a, g)
            want_out, want = grads_of(plain, a, g)
            torch.cuda.synchronize()
            label = f"fused_bias_attention B={b} N={n} {dt}"
            check(label, got_out, want_out, dt, {dt: 0.0})
            worst[dt] = max(worst[dt], check_grads(label, got, want, dt))
        if b != TRAIN_BATCH:
            continue
        leaves = [x.detach().requires_grad_(True) for x in a]  # bf16
        out = through_function(*leaves)
        with torch.no_grad():
            t_k = device_ms(lambda: kernel(*a, scale))
            t_p = device_ms(lambda: plain(*a), 3)
        t_b = cuda_ms(lambda: torch.autograd.grad(out, leaves, g,
                                                  retain_graph=True),
                      iters=3, warmup=1)
        calls = len(K3_CALLS)
        log(f"T4 fused_bias_attention B={b} N={n} bf16, one call: kernel "
            f"forward {t_k:.4f} ms (plain {t_p:.4f} ms), backward (plain "
            f"recompute + autograd) {t_b:.4f} ms as issued; a training "
            f"step's {calls} calls: forward {calls * t_k:.4f} ms, backward "
            f"{calls * t_b:.4f} ms")
    log(f"T4 fused_bias_attention: Function gradients vs plain autograd, "
        f"max abs err f32 {worst[torch.float32]:.3g}, bf16 "
        f"{worst[torch.bfloat16]:.3g}")


def check_attention4d_gradients(dev):
    """T4: one backward of a bf16 EF-GDF-PN-S0 training model gives every
    parameter of every Attention4D a gradient, through 4 K3 launches;
    nonzero for those it reaches only through K3, which got none while
    K3's output had no grad_fn (less those whose exact gradient is 0)."""
    from achelous_tpu_torch.core.config import AchelousConfig
    from achelous_tpu_torch.data.synthetic import synthetic_batch
    from achelous_tpu_torch.entry import perturb_attention
    from achelous_tpu_torch.models.achelous import forward_compute
    cfg = AchelousConfig(resolution=TRAIN_RES, backbone="ef",
                         dtype=torch.bfloat16)
    model = train_model(cfg, dev)
    perturb_attention(model)
    batch = synthetic_batch(cfg, 2, 8, seed=3, device=dev)
    w = wrappers()
    for f in w.values():
        f.launches = 0
    det, sem, lane, pc = forward_compute(model, batch["image"],
                                         batch["radar"], batch["pc"])
    counts = {n: f.launches for n, f in w.items() if f.launches}
    if counts != TRAIN_PATHS[0][3]:
        raise AssertionError(f"T4 forward launches {counts}, want "
                             f"{TRAIN_PATHS[0][3]}")
    loss = sum(t.float().square().mean() for t in (*det, sem, lane)) \
        + pc.float().mean()
    loss.backward()
    params = {n: p for n, p in model.named_parameters()
              if ".token_mixer." in n}
    missing = [n for n, p in params.items() if p.grad is None]
    through = [n for n in params if n.endswith(K3_GRADIENT)]
    dead = [n for n in through if not bool(params[n].grad.abs().sum() > 0)]
    if len(params) != 2 * 25 + 2 * 29 or missing or dead:
        raise AssertionError(f"Attention4D parameters without a gradient: "
                             f"{missing}, with a zero one: {dead} (of "
                             f"{len(params)})")
    log(f"T4: all {len(params)} Attention4D parameters got a gradient from "
        f"one backward, nonzero for the {len(through)} it reaches only "
        f"through K3 (forward launches {counts})")


def train_lr(tcfg):
    """The learning rate of epoch 1 of `tcfg`'s schedule."""
    from achelous_tpu_torch.train.schedule import get_lr_scheduler, scale_lr
    init_lr, min_lr = scale_lr(tcfg.lr_init, tcfg.batch_size, tcfg.optimizer)
    return get_lr_scheduler(tcfg.lr_decay, init_lr, min_lr, tcfg.epochs)(1)


def train_path(dev, tag, label, cfg, want, steps, batch=TRAIN_BATCH,
               ema=None):
    """`steps` steps of `cfg` at `batch` with the default TrainConfig on
    seeded synthetic batches (the first a warm-up), from a training model
    whose offset convs and layer scales are drawn: each kernel's launches
    a step held to `want`, the metrics finite and no step skipped, every
    launch of the first step held against the plain version on its own
    inputs.  Logs ms a step (the median after the first, CUDA events),
    images/s and peak memory; returns (ms, the launches over the
    steps).  A dict `ema` receives the EMA's parameters and statistics
    after the steps, on the CPU, by the train form's keys."""
    from achelous_tpu_torch.data.synthetic import synthetic_batch
    from achelous_tpu_torch.entry import perturb_attention
    from achelous_tpu_torch.train.train_state import (TrainConfig,
                                                      create_train_state,
                                                      make_train_step)
    totals = {}
    tcfg = TrainConfig(batch_size=batch)
    lr = train_lr(tcfg)
    w = wrappers()
    batches = [synthetic_batch(cfg, batch, tcfg.max_gt, seed=200 + i,
                               device=dev) for i in range(steps)]
    model = train_model(cfg, dev)
    perturb_attention(model, layer_scale=C2_LAYER_SCALE.get(cfg.phi, 0.05))
    state = create_train_state(model, cfg, tcfg)
    step = make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times, records = [], []
    for i, b in enumerate(batches):
        for f in w.values():
            f.launches = 0
        t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with (on_path_inputs(records) if i == 0
              else contextlib.nullcontext()):
            t0.record()
            state, m = step(state, b, lr)
            t1.record()
            torch.cuda.synchronize()
        times.append(t0.elapsed_time(t1))
        counts = {n: f.launches for n, f in w.items() if f.launches}
        if counts != want:
            raise AssertionError(f"{tag} {label} step {i}: launches "
                                 f"{counts}, want {want}")
        add_counts(totals, counts)
        vals = {k: float(v) for k, v in m.items()}
        if m["skipped_nonfinite"] or not all(
                np.isfinite(list(vals.values()))):
            raise AssertionError(f"{tag} {label} step {i}: metrics {vals}")
        log(f"{tag} {label} step {i}: {times[-1]:.1f} ms, " + ", ".join(
            f"{k} {v:.4g}" for k, v in vals.items()))
    peak = torch.cuda.max_memory_allocated(dev)
    ms = float(np.median(times[1:] or times))
    log(f"{tag} {label} train bf16 bs{batch} {cfg.resolution}x"
        f"{cfg.resolution}: {ms:.2f} ms/step (median of steps 2-{steps}, "
        f"CUDA events), {batch / ms * 1e3:.1f} images/s, peak memory "
        f"{peak / 2**30:.2f} GiB (max_memory_allocated); launches a step "
        f"{want}")
    check_on_path(f"{tag} {label} step 0", records)
    if ema is not None:
        ema.update({k: v.detach().cpu().clone() for k, v in
                    {**state.ema_params, **state.ema_batch_stats}.items()})
    del state, step, model, batches, records
    torch.cuda.empty_cache()
    return ms, totals


def float32_step_against_cpu(dev, tag, cfg, want, spread=False):
    """One float32 step (TF32 off) of `cfg` at batch STEP_BATCH on the card
    (its kernels' launches held to `want`) and on the CPU from the same
    weights and batch: losses and grad_norm within STEP_LOSS_RTOL.  With
    `spread`, where that fails, each is held to STEP_LOSS_RTOL plus
    STEP_FLOOR times its float32 spread, read as T2 reads it: the most the
    CPU's step moves it with the batch scaled by 1 +- STEP_NUDGE or
    reversed."""
    from achelous_tpu_torch.data.synthetic import synthetic_arrays
    from achelous_tpu_torch.entry import perturb_attention
    from achelous_tpu_torch.train.train_state import TrainConfig
    tcfg = TrainConfig()
    model = train_model(cfg, "cpu")
    perturb_attention(model)
    arrays = synthetic_arrays(cfg, STEP_BATCH, tcfg.max_gt, seed=7)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, gm, counts = one_step(model, cfg, tcfg, arrays, dev)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    if counts != want:
        raise AssertionError(f"{tag} float32 step launches {counts}")
    cpu = torch.device("cpu")
    _, wm, _ = one_step(model, cfg, tcfg, arrays, cpu)
    keys = ("loss", "loss_det", "loss_seg", "loss_wl", "loss_pc",
            "grad_norm")
    rel = {k: abs(gm[k] - wm[k]) / abs(wm[k]) for k in keys}
    log(f"{tag} {cfg.name} float32 step batch {STEP_BATCH} card vs CPU, "
        "relative: " + ", ".join(f"{k} {v:.3g}" for k, v in rel.items()))
    bound = {k: STEP_LOSS_RTOL for k in keys}
    if spread and max(rel.values()) > STEP_LOSS_RTOL:
        nudged = [one_step(model, cfg, tcfg, arrays, cpu, 1 + s)[1]
                  for s in (STEP_NUDGE, -STEP_NUDGE)]
        nudged.append(one_step(model, cfg, tcfg, arrays, cpu,
                               reverse=True)[1])
        own = {k: max(abs(m[k] - wm[k]) / abs(wm[k]) for m in nudged)
               for k in keys}
        bound = {k: STEP_LOSS_RTOL + STEP_FLOOR * own[k] for k in keys}
        log(f"{tag} {cfg.name} float32 CPU vs CPU with the batch scaled by "
            f"1 +- {STEP_NUDGE:g} or reversed, relative: " + ", ".join(
                f"{k} {v:.3g}" for k, v in own.items()))
    if gm["skipped_nonfinite"] or wm["skipped_nonfinite"] or any(
            rel[k] > bound[k] for k in keys):
        raise AssertionError(f"{tag} losses/grad_norm outside "
                             f"{STEP_LOSS_RTOL}" + (" and their spread" if
                                                    spread else ""))


def train_paths(dev):
    """T5: EF-GDF-PN-S0 and EN-GDF-PN2-S0 at 320^2, batch 32, bf16 compute
    on float32 parameters, the default TrainConfig: PATH_STEPS steps each
    (the first a warm-up), each kernel's launches a step held; then one
    float32 step (TF32 off) of EF-GDF-PN-S0 at batch STEP_BATCH on the card
    and on the CPU.  Returns the kernels' launches."""
    from achelous_tpu_torch.core.config import AchelousConfig
    totals = {}
    for label, backbone, pc_model, want in TRAIN_PATHS:
        cfg = AchelousConfig(resolution=TRAIN_RES, backbone=backbone,
                             pc_model=pc_model, dtype=torch.bfloat16)
        add_counts(totals, train_path(dev, "T5", label, cfg, want,
                                      PATH_STEPS)[1])
    time_fps_at_batch(dev)
    float32_step_against_cpu(dev, "T5", AchelousConfig(
        resolution=TRAIN_RES, backbone="ef"), TRAIN_PATHS[0][3])
    return totals


def train_configs(dev):
    """T6: every configuration of T6_PATHS at 320^2, batch 32, bf16
    compute on float32 parameters, the default TrainConfig: a warm-up and
    a timed step each, each kernel's launches a step held, every launch of
    the first step held against the plain version; then one float32 step
    (TF32 off) of MV-GDF-PN-S1 at batch STEP_BATCH on the card and on the
    CPU.  Returns the kernels' launches."""
    from achelous_tpu_torch.core.config import AchelousConfig
    totals, ms = {}, {}
    for label, fields, want in T6_PATHS:
        cfg = AchelousConfig(resolution=TRAIN_RES, dtype=torch.bfloat16,
                             **fields)
        ms[label], counts = train_path(dev, "T6", label, cfg, want,
                                       T6_STEPS)
        add_counts(totals, counts)
    log("T6 ms a step at bs 32: " + ", ".join(
        f"{k} {v:.2f}" for k, v in ms.items()))
    float32_step_against_cpu(dev, "T6", AchelousConfig(
        resolution=TRAIN_RES, backbone="mv", phi="S1"), TRAIN_LAUNCHES)
    return totals


def train_reparameterizable(dev):
    """T7: RV-GDF-PN-S0, MO-RDF-PN-S0 and FV-RDF-PN-S0 trained in their
    train form as T6 trains (`train_path`: a warm-up and a timed step at
    batch 32, bf16), each trained EMA then folded in float32 on the card
    and held against the train form's eval output and against itself on
    the CPU (`deploy_against_train`), and served in both forms
    (`serve_trained`); one float32 step of
    MO-RDF-PN-S0 at batch STEP_BATCH on the card against the CPU; the
    entry path once (`cli_path`).  Returns the kernels' launches."""
    from achelous_tpu_torch.core.config import AchelousConfig
    totals, ms = {}, {}
    for label, fields, want, held in T7_PATHS:
        cfg = AchelousConfig(resolution=TRAIN_RES, dtype=torch.bfloat16,
                             **fields)
        ema = {}
        ms[label], counts = train_path(dev, "T7", label, cfg, want,
                                       T6_STEPS, ema=ema)
        add_counts(totals, counts)
        deploy_against_train(dev, f"T7 {label} trained EMA", cfg, ema,
                             cpu_tol=FLOAT32_PATH_TOL)
        add_counts(totals, serve_trained(dev, label, fields, want, ema,
                                         held))
        torch.cuda.empty_cache()
    log("T7 ms a step at bs 32: " + ", ".join(
        f"{k} {v:.2f}" for k, v in ms.items()))
    float32_step_against_cpu(dev, "T7", AchelousConfig(
        resolution=TRAIN_RES, backbone="mo", neck="rdf"), TRAIN_LAUNCHES,
        spread=True)
    add_counts(totals, cli_path(dev))
    return totals


def bf16_spread(model, cfg, dev):
    """name -> the most each output of `model` moves, relative to its
    scale, when the requests of `serve_path` (DEPLOY_REQUESTS of them) are
    scaled by 1 +- BF16_NUDGE, one bf16 step: the rounding that the
    model's state amplifies in bf16."""
    spread = {}
    with torch.inference_mode():
        for q in requests(cfg, DEPLOY_REQUESTS):
            base = None
            for s in (1.0, 1 + BF16_NUDGE, 1 - BF16_NUDGE):
                det, sem, lane, pc = model(*(t.to(dev).mul(s).to(cfg.dtype)
                                             for t in q))
                outs = dict(zip(OUTPUT_NAMES, (*det, sem, lane, pc)))
                if base is None:
                    base = outs
                    continue
                for n, o in outs.items():
                    b = base[n].float()
                    e = ((o.float() - b).abs().max()
                         / max(1.0, b.abs().max().item())).item()
                    spread[n] = max(spread.get(n, 0.0), e)
    return spread


def serve_trained(dev, label, fields, want, ema, held):
    """T7: a trained EMA served through entry() at batch 1, bf16, through
    decode + NMS, in its train form and in its deploy form:
    DEPLOY_REQUESTS requests each, each one's launches held to `want` and
    (deploy form) every launch's inputs against the plain version, the
    outputs before decode against float32 plain on the CPU relative to
    their scale, held within MAIN_PATH_TOL where `held` (`serve_path`);
    the deploy form's bf16 spread logged (`bf16_spread`).  Then ms and
    kernels a frame of both forms.  Returns the deploy form's
    launches."""
    _, model, fn = serve_path(dev, f"{label} train form", want,
                              n=DEPLOY_REQUESTS, held=held, state_dict=ema,
                              **fields)
    q = tuple(torch.rand(s, device=dev).to(fn.cfg.dtype) for s in
              ((1, 3, 320, 320), (1, 3, 320, 320), (1, 512, 5)))
    forms = {"train": time_path(f"T7 {label} train form", model, fn, q)}
    del model, fn
    records = []
    counts, model, fn = serve_path(dev, f"{label} deploy", want, records,
                                   n=DEPLOY_REQUESTS, held=held,
                                   state_dict=ema, deploy=True, **fields)
    check_on_path(f"T7 {label} deploy", records)
    spread = bf16_spread(model, fn.cfg, dev)
    log(f"T7 {label} deploy bf16 against itself on the requests scaled by "
        f"1 +- {BF16_NUDGE:g}: " + ", ".join(f"{n} {e:.3g}"
                                            for n, e in spread.items()))
    forms["deploy"] = time_path(f"T7 {label} deploy", model, fn, q)
    log(f"T7 {label} trained EMA served bf16 bs1: train form "
        f"{forms['train'][1]:.0f} kernels/frame, {forms['train'][0]:.3f} "
        f"ms/frame; deploy form {forms['deploy'][1]:.0f}, "
        f"{forms['deploy'][0]:.3f}")
    return counts


def cli_path(dev):
    """T7: the entry path of MO-RDF-PN-S0: `train.cli.main` for one epoch
    at 320^2, bf16, batch FIT_BATCH on a tree like F1's, its launches
    held against the plain version; then `predict_cli.main` in predict
    mode with `--ckpt <the last checkpoint> --deploy` on one of its
    frames (K1 x4, K2 x4).  The launches of each are counted from 0 just
    before it to just after.  Returns them."""
    import tempfile
    from achelous_tpu_torch import predict_cli
    from achelous_tpu_torch.data.example import write_tree
    from achelous_tpu_torch.train import cli
    totals, records = {}, []
    argv = ["--backbone", "mo", "--neck", "rdf", "--resolution",
            str(TRAIN_RES)]
    with tempfile.TemporaryDirectory() as root:
        write_tree(root, FIT_TRAIN + FIT_VAL, FIT_SIZE, points=400,
                   val=FIT_VAL)
        log_dir = os.path.join(root, "logs")
        t0 = time.perf_counter()
        with on_path_inputs(records):
            state, counts = counted(lambda: cli.main(argv + [
                "--data_root", root, "--bs", str(FIT_BATCH), "--epoch", "1",
                "--eval_period", "5", "--save_period", "1", "--log_dir",
                log_dir]))
        hist = [json.loads(line) for line in
                open(os.path.join(log_dir, "history.jsonl"))]
        if state.epoch != 1 or state.step != FIT_TRAIN // FIT_BATCH or \
                not np.isfinite(hist[-1]["loss"]) or not \
                {"fused_radarconv", "deform_samples"} <= set(counts):
            raise AssertionError(f"T7 train.cli: epoch {state.epoch}, step "
                                 f"{state.step}, history {hist}, launches "
                                 f"{counts}")
        log(f"T7 train.cli MO-RDF-PN-S0 one epoch of {FIT_TRAIN} frames at "
            f"bs {FIT_BATCH}: {time.perf_counter() - t0:.1f} s, loss "
            f"{hist[-1]['loss']:.4g}, val_loss "
            f"{hist[-1].get('val_loss', float('nan')):.4g}, launches "
            f"{counts}")
        add_counts(totals, counts)
        check_on_path("T7 train.cli", records)
        out = os.path.join(root, "predicted")
        frame = os.path.join(root, "images", "frame000.jpg")
        t0 = time.perf_counter()
        summary, counts = counted(lambda: predict_cli.main(argv + [
            "--ckpt", os.path.join(log_dir, "ckpt", "last_epoch_weights"),
            "--deploy", "--image", frame, "--radar_csv",
            os.path.join(root, "radar", "frame000.csv"), "--out", out]))
        if counts != TRAIN_LAUNCHES or not all(
                os.path.exists(os.path.join(out, "frame000" + suffix))
                for suffix in (".json", "_masks.npz", "_vis.jpg")):
            raise AssertionError(f"T7 predict_cli --ckpt --deploy: launches "
                                 f"{counts}, wrote {os.listdir(out)}")
        log(f"T7 predict_cli --ckpt last_epoch_weights --deploy: "
            f"{time.perf_counter() - t0:.1f} s, {summary['num_detections']} "
            f"detections, launches {counts}")
        add_counts(totals, counts)
    return totals


def time_fps_at_batch(dev):
    """T5: K4 at PointNet++'s four levels for a batch-32 step: its indices
    equal the plain version's on random points, with a valid mask and
    without, and its device time against the plain version's."""
    from achelous_tpu_torch.ops.pointops import farthest_point_sample as plain
    kernel = wrappers()["farthest_point_sample"]
    rng = np.random.RandomState(3)
    t_k = t_p = 0.0
    for n, npoint in K4_SHAPES:
        x = torch.from_numpy(rng.rand(TRAIN_BATCH, n, 3).astype(
            np.float32)).to(dev)
        valid = torch.from_numpy(rng.rand(TRAIN_BATCH, n) > 0.3).to(dev)
        for v in (None, valid):
            if not torch.equal(kernel(x, npoint, v), plain(x, npoint, v)):
                raise AssertionError(
                    f"T5 farthest_point_sample B={TRAIN_BATCH} {n}->{npoint}"
                    f" {'with' if v is not None else 'without'} a mask: "
                    f"indices differ from the plain version")
        t_k += device_ms(lambda: kernel(x, npoint))
        t_p += device_ms(lambda: plain(x, npoint), 1)
    log(f"T5 farthest_point_sample B={TRAIN_BATCH}, a step's 4 levels: "
        f"indices equal with and without a mask; device {t_k:.4f} ms "
        f"(plain {t_p:.4f} ms)")


def fit_on_the_card(dev):
    """F1: `fit` for EN-GDF-PN-S0 at 320^2, bf16, on a WaterScenes-layout
    tree written to a temporary directory (raw radar CSVs, no npz): the
    card's splat of a batch against the CPU's, FIT_EPOCHS epochs with the
    online evaluation at the last, history.jsonl, and a resume from the
    epoch-1 checkpoint.  Returns the kernels' launches in the two runs."""
    import tempfile
    from achelous_tpu_torch.core.config import AchelousConfig
    from achelous_tpu_torch.data.example import write_tree
    from achelous_tpu_torch.data.waterscenes import (WaterScenesDataset,
                                                     WaterScenesPaths)
    from achelous_tpu_torch.models.achelous import create_model
    from achelous_tpu_torch.ops.radar_splat import splat_radar_fast
    from achelous_tpu_torch.train.checkpoints import CheckpointManager
    from achelous_tpu_torch.train.loop import batches_from, device_batch, fit
    from achelous_tpu_torch.train.train_state import (TrainConfig,
                                                      create_train_state)
    cfg = AchelousConfig(resolution=TRAIN_RES, dtype=torch.bfloat16)
    tcfg = TrainConfig(batch_size=FIT_BATCH, epochs=FIT_EPOCHS)
    w = wrappers()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        write_tree(root, FIT_TRAIN + FIT_VAL, FIT_SIZE, points=400,
                   val=FIT_VAL)
        train_ds = WaterScenesDataset(cfg, WaterScenesPaths.under(root))
        val_ds = WaterScenesDataset(cfg,
                                    WaterScenesPaths.under(root, "val.txt"))
        log(f"F1: a WaterScenes tree of {FIT_TRAIN} + {FIT_VAL} frames of "
            f"{FIT_SIZE[0]}x{FIT_SIZE[1]} with radar CSVs written in "
            f"{time.perf_counter() - t0:.1f} s")

        batch = next(batches_from(train_ds, cfg, FIT_BATCH, tcfg.max_gt,
                                  False, np.random.RandomState(0)))
        card = device_batch(batch, cfg, dev)["radar"]
        want = splat_radar_fast(torch.from_numpy(batch["radar_points"]),
                                torch.from_numpy(batch["radar_points_valid"]),
                                cfg.resolution)
        if card.shape != (FIT_BATCH, 3, TRAIN_RES, TRAIN_RES) or not \
                torch.equal(card.cpu(), want):
            raise AssertionError("F1: the card's radar splat differs from "
                                 "the CPU's")
        log(f"F1: the card's splat of a batch equals the CPU's "
            f"({int((want[:, 0] != 0).sum())} cells set of "
            f"{int(batch['radar_points_valid'].sum())} points)")

        counts, records = {}, []
        for name, state, epochs in (("fit", None, FIT_EPOCHS),
                                    ("resume", "ckpt", FIT_EPOCHS)):
            log_dir = os.path.join(root, name)
            if state is not None:
                ckpt = CheckpointManager(os.path.join(root, "fit", "ckpt"))
                first = ckpt.periodic()[0]
                state = create_train_state(create_model(cfg, dev, train=True),
                                           cfg, tcfg)
                state = ckpt.restore(first, state)
                if state.epoch != 1:
                    raise AssertionError(f"F1: {first} reads epoch "
                                         f"{state.epoch}")
            for f in w.values():
                f.launches = 0
            msgs = []
            t0 = time.perf_counter()
            with (on_path_inputs(records) if name == "fit"
                  else contextlib.nullcontext()):
                state = fit(cfg, tcfg, train_ds, val_ds, log_dir=log_dir,
                            epochs=epochs, save_period=1, state=state,
                            device=dev, progress=msgs.append)
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            for n, f in w.items():
                if f.launches:
                    counts[n] = counts.get(n, 0) + f.launches
            hist = [json.loads(line) for line in
                    open(os.path.join(log_dir, "history.jsonl"))]
            want_epochs = list(range(FIT_EPOCHS - len(hist), FIT_EPOCHS))
            if state.epoch != FIT_EPOCHS or [h["epoch"] for h in hist] != \
                    want_epochs or "mAP50" not in hist[-1] or not all(
                    np.isfinite(h["loss"]) for h in hist):
                raise AssertionError(f"F1 {name}: epoch {state.epoch}, "
                                     f"history {hist}")
            log(f"F1 {name}: {secs:.1f} s; " + "; ".join(msgs))
            last = hist[-1]
            log(f"F1 {name}: epochs {[h['epoch'] for h in hist]} in "
                f"history.jsonl, state at epoch {state.epoch}; last: "
                + ", ".join(f"{k} {last[k]:.4g}" for k in
                            ("loss", "val_loss", "mAP50", "miou_sem",
                             "miou_wl", "miou_pc", "n_images")))
    if not {"fused_radarconv", "deform_samples"} <= set(counts):
        raise AssertionError(f"F1 launches {counts}")
    log(f"F1 launches in both runs {counts}")
    check_on_path("F1 fit", records)
    return counts


# ---------------------------------------------------------------------------
# P1 the predictor, X1 its export, C1 the sweep configurations
# ---------------------------------------------------------------------------


def counted(fn):
    """(fn(), each kernel's launches in it): the counts set to 0 just
    before and read just after."""
    w = wrappers()
    for f in w.values():
        f.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {n: f.launches for n, f in w.items() if f.launches}


def add_counts(total, counts):
    for n, c in counts.items():
        total[n] = total.get(n, 0) + c


def p1_files(root):
    """Under root: P1_FRAMES seeded frames of WaterScenes' camera size,
    one radar CSV of P1_RADAR_POINTS points in data/example.py's columns,
    one npz map, and the weight file of EN-GDF-PN-S0's seeded bf16 weights
    (offset and modulator convs drawn), unstamped and stamped
    torch-transplant."""
    from PIL import Image
    from achelous_tpu_torch.data.example import write_radar_csv
    from achelous_tpu_torch.entry import perturb_deform_convs, serving_config
    from achelous_tpu_torch.models.achelous import create_model
    from achelous_tpu_torch.predict import TRANSPLANT
    from achelous_tpu_torch.weights import save_weights
    rng = np.random.RandomState(7)
    w, h = P1_FRAME
    frames = []
    for i in range(P1_FRAMES):
        path = os.path.join(root, f"frame{i}.jpg")
        # sky over water, with noise: a frame the letterbox resamples
        img = np.concatenate([np.full((h // 2, w, 3), (150, 180, 210)),
                              np.full((h - h // 2, w, 3), (20, 60, 90))])
        img = np.clip(img + rng.randint(-40, 40, img.shape), 0, 255)
        Image.fromarray(img.astype(np.uint8)).save(path, quality=95)
        frames.append(path)
    csv = write_radar_csv(os.path.join(root, "radar.csv"), P1_RADAR_POINTS,
                          rng)
    npz = os.path.join(root, "radar.npz")
    np.savez(npz, arr_0=(rng.rand(3, 320, 320) * 4).astype(np.float32))
    model = create_model(serving_config(), "cpu",
                         torch.Generator().manual_seed(0))
    perturb_deform_convs(model)
    sd = model.state_dict()             # bf16 parameters, float32 norms
    weights = save_weights(os.path.join(root, "weights.pt"), sd)
    stamped = save_weights(os.path.join(root, "transplant.pt"), sd,
                           {"provenance": TRANSPLANT})
    return frames, csv, npz, weights, stamped


def match_detections(label, got, want, conf, frame_w):
    """Pair `detect` results by class and box (frame pixels, within
    P1_BOX_REL of the frame's width); a detection left unpaired must score
    within P1_SCORE_EDGE of `conf`, and is logged.  Returns the largest
    box difference of a pair, in pixels."""
    tol = P1_BOX_REL * frame_w
    free = list(range(len(got["boxes"])))
    worst, edge = 0.0, []
    for i, (box, cls) in enumerate(zip(want["boxes"], want["classes"])):
        diffs = [(float(np.abs(got["boxes"][j] - box).max()), j) for j in free
                 if got["classes"][j] == cls]
        d, j = min(diffs, default=(np.inf, None))
        if d <= tol:
            free.remove(j)
            worst = max(worst, d)
        else:
            edge.append(("CPU", i, float(want["scores"][i])))
    edge += [("card", j, float(got["scores"][j])) for j in free]
    for side, i, score in edge:
        if abs(score - conf) > P1_SCORE_EDGE:
            raise AssertionError(f"{label}: {side} detection {i} (score "
                                 f"{score}) has no partner on the other side")
        log(f"{label}: {side} detection {i} at score {score}, within "
            f"{P1_SCORE_EDGE} of the threshold {conf}, unpaired")
    return worst


def comparison_threshold(pred, args):
    """A confidence threshold in the widest gap between consecutive
    scores of ranks P1_RANKS of `pred`'s detections on `args` (NMS keeps
    a box by the boxes above it alone, so the detections above it are the
    same at any lower threshold)."""
    keep = pred.request.confidence
    pred.request.confidence = 0.0
    try:
        dets = pred.infer(*args)[0]
    finally:
        pred.request.confidence = keep
    scores = (dets.obj_conf[0] * dets.cls_conf[0])[dets.valid[0]]
    scores = scores.sort(descending=True)[0].tolist()
    lo, hi = P1_RANKS
    if len(scores) <= hi:
        raise AssertionError(f"P1: {len(scores)} detections, fewer than "
                             f"{hi + 1}")
    k = max(range(lo, hi), key=lambda i: scores[i] - scores[i + 1])
    return (scores[k] + scores[k + 1]) / 2


def serving_error(got, want):
    """max |got - want| / max(1, max |want|) of two tensors."""
    g, w = got.float().cpu(), want.float().cpu()
    if not bool(torch.isfinite(g).all()):
        raise AssertionError("non-finite output")
    return ((g - w).abs().max() / max(1.0, w.abs().max().item())).item()


def predictor_route(dev, label, weights, frames, csv, npz, want_launches):
    """One weight route of P1: the bf16 predictor on the card serving each
    frame (the counts read a frame at a time); the same predictor in
    float32 on the card against one on the CPU, TF32 off; the bf16
    outputs against the CPU's within MAIN_PATH_TOL.  Returns (the bf16
    predictor, its launches, a frame's prepared inputs)."""
    from PIL import Image
    from achelous_tpu_torch.entry import serving_config
    from achelous_tpu_torch.predict import AchelousPredictor

    pred = AchelousPredictor.from_weights(serving_config(), weights,
                                          device=dev)
    pils = [Image.open(f).convert("RGB") for f in frames]
    pred.detect(pils[0], radar_csv=csv)                       # warm-up
    torch.cuda.synchronize()
    launches = {}
    for i, pil in enumerate(pils):
        kw = dict(radar_csv=csv) if i % 2 == 0 else dict(radar_npz=npz)
        r, counts = counted(lambda: pred.detect(pil, **kw))
        if counts != want_launches:
            raise AssertionError(f"P1 {label} frame {i}: launches {counts}, "
                                 f"want {want_launches}")
        add_counts(launches, counts)
        log(f"P1 {label} frame {i} ({'csv' if 'radar_csv' in kw else 'npz'}"
            f"): {len(r['boxes'])} detections, semantic "
            f"{r['semantic'].shape}, launches {counts}")

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg32 = serving_config(torch.float32)
    card = AchelousPredictor.from_weights(cfg32, weights, device=dev)
    cpu = AchelousPredictor.from_weights(cfg32, weights, device="cpu")
    if card.cfg.deform_band != pred.cfg.deform_band:
        raise AssertionError("P1: the float32 predictor took another band")
    pil = pils[0]
    h, w = pil.size[1], pil.size[0]
    args_card = card.prepare(pil, None, csv)
    args_cpu = cpu.prepare(pil, None, csv)
    for name, a, b in zip(("image", "radar (splat)", "points"), args_card,
                          args_cpu):
        if not torch.equal(a.cpu(), b):
            raise AssertionError(f"P1 {label}: prepared {name} differs "
                                 f"between the card and the CPU")
    out_card, out_cpu = card.infer(*args_card), cpu.infer(*args_cpu)
    probs = {}
    for name, i in (("semantic", 1), ("waterline", 2)):
        probs[name] = (card._unletterbox_mask(out_card[i][0], (h, w)).cpu()
                       - cpu._unletterbox_mask(out_cpu[i][0], (h, w))
                       ).abs().max().item()
    if max(probs.values()) > P1_PROB_TOL:
        raise AssertionError(f"P1 {label}: unletterboxed probabilities "
                             f"card vs CPU {probs} > {P1_PROB_TOL}")
    conf = comparison_threshold(cpu, args_cpu)
    for p in (card, cpu):
        p.confidence = p.request.confidence = conf
    got, want = card.detect(pil, radar_csv=csv), cpu.detect(pil, radar_csv=csv)
    box_px = match_detections(f"P1 {label}", got, want, conf, w)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    log(f"P1 {label} float32 card vs CPU at {w}x{h}: {len(got['boxes'])} / "
        f"{len(want['boxes'])} detections at confidence {conf:.6f}, "
        f"boxes within {box_px:.3g} px, "
        f"unletterboxed probabilities within "
        + ", ".join(f"{k} {v:.3g}" for k, v in probs.items()))
    del card

    args = pred.prepare(pil, None, csv)
    got = pred.infer(*args)
    ref = cpu.infer(*(a.float().cpu() for a in args))
    names = ["sem_prob", "lane_prob", "pc", "det0", "det1", "det2"]
    errs = {n: serving_error(g, r) for n, g, r in
            zip(names, [*got[1:4], *got[4]], [*ref[1:4], *ref[4]])}
    log(f"P1 {label} bf16 card vs float32 CPU (max err / max(1, max|ref|)): "
        + ", ".join(f"{n} {e:.3g}" for n, e in errs.items()))
    bad = {n: e for n, e in errs.items() if e > MAIN_PATH_TOL}
    if bad:
        raise AssertionError(f"P1 {label} outside {MAIN_PATH_TOL}: {bad}")
    return pred, launches, args


def predictor_phase(dev, root):
    """P1: the predictor at full width on both weight routes, then the
    heatmap, the CLI's predict mode and its fps probe.  Returns (the
    unstamped bf16 predictor, a frame's prepared inputs, the launches of
    every served frame)."""
    from PIL import Image
    from achelous_tpu_torch import predict_cli

    frames, csv, npz, weights, stamped = p1_files(root)
    launches = {}
    routes = {}
    for label, path, key in (("unstamped", weights, "banded"),
                             ("torch-transplant", stamped, "band None")):
        pred, counts, args = predictor_route(dev, label, path, frames, csv,
                                             npz, P1_LAUNCHES[key])
        want_band = None if key == "band None" else BAND
        if pred.cfg.deform_band != want_band:
            raise AssertionError(f"P1 {label}: band {pred.cfg.deform_band}")
        add_counts(launches, counts)
        routes[key] = (pred, args)
    pred, args = routes["banded"]
    per_frame = P1_LAUNCHES["banded"]

    hm, counts = counted(lambda: pred.detect_heatmap(
        Image.open(frames[0]), radar_csv=csv))
    if hm.shape != (320, 320) or not (0.0 <= hm.min() <= hm.max() <= 1.0):
        raise AssertionError(f"P1 heatmap: shape {hm.shape}, range "
                             f"{hm.min()}..{hm.max()}")
    if counts != per_frame:
        raise AssertionError(f"P1 heatmap launches {counts}")
    add_counts(launches, counts)
    log(f"P1 detect_heatmap: {hm.shape}, max {hm.max():.4f}")

    out = os.path.join(root, "cli")
    common = ["--weights", weights, "--radar_csv", csv, "--image", frames[0],
              "--device", str(dev)]
    summary, counts = counted(lambda: predict_cli.main(
        ["--mode", "predict", "--out", out] + common))
    stem = os.path.splitext(os.path.basename(frames[0]))[0]
    made = sorted(os.listdir(out))
    if made != sorted(stem + s for s in (".json", "_masks.npz", "_vis.jpg")):
        raise AssertionError(f"P1 CLI predict wrote {made}")
    masks = np.load(os.path.join(out, stem + "_masks.npz"))
    if masks["semantic"].shape != P1_FRAME[::-1]:
        raise AssertionError(f"P1 CLI masks {masks['semantic'].shape}")
    if counts != per_frame:
        raise AssertionError(f"P1 CLI predict launches {counts}")
    add_counts(launches, counts)
    log(f"P1 CLI predict: {made}, {summary['num_detections']} detections")

    res, counts = counted(lambda: predict_cli.main(
        ["--mode", "fps", "--test_interval", str(FPS_INTERVAL)] + common))
    if counts != {k: v * (FPS_INTERVAL + 1)                 # with a warm-up
                  for k, v in per_frame.items()}:
        raise AssertionError(f"P1 fps launches {counts}")
    add_counts(launches, counts)
    log(f"P1 fps probe (preprocess + forward + NMS + unmap, bf16, "
        f"{P1_FRAME[0]}x{P1_FRAME[1]} frame, {FPS_INTERVAL} detections): "
        f"{res['seconds_per_image']:.6f} s/image, {res['fps']:.3f} fps")
    pred_none, _ = routes["band None"]
    args_fps = predict_cli.build_parser().parse_args(
        ["--test_interval", str(FPS_INTERVAL)] + common)
    res, counts = counted(lambda: predict_cli.run_fps_probe(pred_none,
                                                            args_fps))
    add_counts(launches, counts)
    log(f"P1 fps probe at band None (torch-transplant weights): "
        f"{res['seconds_per_image']:.6f} s/image, {res['fps']:.3f} fps")
    log(f"P1 launches {launches}")
    return pred, args, launches


def export_phase(pred, args, root):
    """X1: `export_program` of the bf16 predictor at batch 1, reloaded with
    `torch.export.load`: the graph's kernel nodes, their launches when the
    program runs, and its outputs against the eager request function's
    (bit-equal expected; each within one bf16 step, detections equal)."""
    from achelous_tpu_torch import predict

    t0 = time.perf_counter()
    path = predict.export_program(pred, os.path.join(root, "x1.pt2"))
    t_export = time.perf_counter() - t0
    nodes = predict.kernel_nodes(path)
    if nodes != X1_NODES:
        raise AssertionError(f"X1: kernel nodes {nodes}, want {X1_NODES}")
    t0 = time.perf_counter()
    program = predict.load_program(path)
    t_load = time.perf_counter() - t0
    want = torch.utils._pytree.tree_leaves(pred.infer(*args))
    with torch.inference_mode():
        flat, counts = counted(lambda: program(*args))
    if counts != X1_NODES:
        raise AssertionError(f"X1: launches {counts}, want {X1_NODES}")
    got = torch.utils._pytree.tree_leaves(predict.unpack(flat))
    unequal = 0
    for g, w in zip(got, want):
        if g.dtype != w.dtype or g.shape != w.shape:
            raise AssertionError(f"X1: {g.dtype}{tuple(g.shape)} against "
                                 f"{w.dtype}{tuple(w.shape)}")
        if torch.equal(g, w):
            continue
        unequal += 1
        if not g.is_floating_point() or not torch.allclose(
                g.float(), w.float(), rtol=2 ** -7, atol=0):
            raise AssertionError(f"X1: an output {tuple(w.shape)} differs "
                                 f"from eager by more than one bf16 step")
    from achelous_tpu_torch.trace_serving import profile_frames
    with torch.inference_mode():
        ms_program = cuda_ms(lambda: program(*args), iters=20)
        ms_eager = cuda_ms(lambda: pred.request(*args), iters=20)
        profiles = {name: profile_frames(f, args)[:3] for name, f in
                    (("exported", program), ("eager", pred.request))}
    log(f"X1 export: {t_export:.1f} s to export, {t_load:.1f} s to load, "
        f"{os.path.getsize(path)} bytes; kernel nodes {nodes}; launches "
        f"{counts}; {len(want) - unequal} of {len(want)} outputs bit-equal "
        f"to eager (the rest within one bf16 step); request "
        f"{ms_program:.3f} ms exported, {ms_eager:.3f} ms eager; under "
        f"torch.profiler (wall / device busy ms, kernels a frame) "
        + "; ".join(f"{n} {w:.3f} / {b:.3f}, {k:.0f}"
                    for n, (w, b, k) in profiles.items()))
    return counts


def sweep_phase(dev):
    """C1: each configuration of SWEEP served as the paths of phase 4,
    its kernels held against their plain versions on the inputs of the
    requests' own launches, and timed."""
    launches = {}
    for label, kw, want in SWEEP:
        records = []
        with phase(f"C1 {label}"):
            counts, model, fn = serve_path(dev, label, want, records,
                                           n=C1_REQUESTS, **kw)
            check_on_path(f"C1 {label}", records)
            q = tuple(torch.rand(s, device=dev).to(fn.cfg.dtype) for s in
                      ((1, 3, 320, 320), (1, 3, 320, 320), (1, 512, 5)))
            time_path(label, model, fn, q)
        add_counts(launches, counts)
        del model, fn, records
        torch.cuda.empty_cache()
    return launches


def c2_weights(cfg):
    """Train-form float32 weights of `cfg`'s path, on the CPU: seed 0, the
    offset convs and layer scales drawn (`perturb_deform_convs`,
    `perturb_attention`, the layer scales at `C2_LAYER_SCALE`'s where it
    names the size) and, for the reparameterizable backbones
    (`C2_NORM_SCALE`), each backbone BatchNorm's statistics and affine
    drawn from a numpy seed, so that the folds fold more than identity
    statistics."""
    from achelous_tpu_torch.entry import (perturb_attention,
                                          perturb_deform_convs)
    from achelous_tpu_torch.models.achelous import create_model
    from achelous_tpu_torch.ops.norm import BatchNorm

    model = create_model(cfg.replace(dtype=torch.float32), "cpu",
                         torch.Generator().manual_seed(0))
    perturb_deform_convs(model)
    perturb_attention(model, layer_scale=C2_LAYER_SCALE.get(cfg.phi, 0.05))
    scale = C2_NORM_SCALE.get(cfg.backbone)
    rng = np.random.RandomState(5)
    with torch.no_grad():
        for m in model.image_radar_encoder.fpn.backbone.modules():
            if scale is None or not isinstance(m, BatchNorm):
                continue
            c = m.weight.numel()
            for t, v in ((m.weight, scale * (1 + 0.1 * rng.randn(c))),
                         (m.bias, scale * 0.1 * rng.randn(c)),
                         (m.running_mean, 0.1 * rng.randn(c)),
                         (m.running_var, 0.5 + rng.rand(c))):
                t.copy_(torch.from_numpy(v.astype(np.float32)))
    return {k: v.clone() for k, v in model.state_dict().items()}


def deploy_against_train(dev, label, cfg, weights, cpu_tol=None):
    """The deploy form against its own train form on the same weights,
    both float32 on the card with TF32 off: DEPLOY_REQUESTS requests, each
    output within DEPLOY_TOL of the train form's scale; their kernel
    launches a request equal; kernels a frame of each under the
    profiler.  With `cpu_tol`, the deploy form's outputs on the card also
    within `cpu_tol` of its float32 outputs on the CPU (the plain
    versions)."""
    from achelous_tpu_torch.entry import make_fn
    from achelous_tpu_torch.models.achelous import create_model
    from achelous_tpu_torch.trace_serving import profile_frames

    cfg32 = cfg.replace(dtype=torch.float32)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fns = {form: make_fn(create_model(cfg32, dev, state_dict=weights,
                                      deploy=form == "deploy"), cfg32)
           for form in ("train", "deploy")}
    reqs = [tuple(t.to(dev) for t in q)
            for q in requests(cfg32, DEPLOY_REQUESTS, seed=200)]
    worst, counts, kernels, on_cpu = {}, {}, {}, {}
    cpu_model = (None if cpu_tol is None else
                 copy.deepcopy(fns["deploy"].model).cpu())
    with torch.inference_mode():
        for q in reqs:
            outs = {}
            for form, fn in fns.items():
                m = fn.model
                outs[form], counts[form] = counted(
                    lambda: m(*q))
            (tdet, *trest), (ddet, *drest) = outs["train"], outs["deploy"]
            for name, t, d in zip(OUTPUT_NAMES, (*tdet, *trest),
                                  (*ddet, *drest)):
                e = ((d - t).abs().max() / max(1.0, t.abs().max().item())
                     ).item()
                worst[name] = max(worst.get(name, 0.0), e)
            if cpu_model is None:
                continue
            cdet, *crest = cpu_model(*(t.cpu() for t in q))
            for name, c, d in zip(OUTPUT_NAMES, (*cdet, *crest),
                                  (*ddet, *drest)):
                e = ((d.cpu() - c).abs().max()
                     / max(1.0, c.abs().max().item())).item()
                on_cpu[name] = max(on_cpu.get(name, 0.0), e)
    for form, fn in fns.items():
        kernels[form] = profile_frames(fn, reqs[0], frames=3)[2]
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    log(f"{label} float32 deploy vs train form on the card (max err / "
        f"max(1, max|train|)): " + ", ".join(f"{n} {e:.3g}"
                                             for n, e in worst.items()))
    log(f"{label} kernels/frame under torch.profiler, float32: train form "
        f"{kernels['train']:.0f}, deploy form {kernels['deploy']:.0f}; "
        f"kernel launches a forward {counts['train']} / {counts['deploy']}")
    if counts["train"] != counts["deploy"]:
        raise AssertionError(f"{label}: launches differ between the forms")
    bad = {n: e for n, e in worst.items() if e > DEPLOY_TOL}
    if bad:
        raise AssertionError(f"{label} deploy form outside {DEPLOY_TOL}: "
                             f"{bad}")
    if cpu_model is not None:
        log(f"{label} float32 deploy form on the card vs the CPU (max err /"
            f" max(1, max|CPU|)): " + ", ".join(f"{n} {e:.3g}"
                                                for n, e in on_cpu.items()))
        bad = {n: e for n, e in on_cpu.items() if e > cpu_tol}
        if bad:
            raise AssertionError(f"{label} deploy form on the card outside "
                                 f"{cpu_tol} of the CPU: {bad}")


def c2_phase(dev):
    """C2: each configuration of C2 served as the paths of C1 on the
    weights of `c2_weights`; each deploy form then held against its train
    form in float32 (`deploy_against_train`)."""
    from achelous_tpu_torch.entry import serving_config

    launches, ms, kernels = {}, {}, {}
    for label, kw, want in C2:
        records = []
        with phase(f"C2 {label}"):
            cfg = serving_config(**{k: v for k, v in kw.items()
                                    if k != "deploy"})
            weights = c2_weights(cfg)
            counts, model, fn = serve_path(dev, label, want, records,
                                           state_dict=weights, **kw)
            check_on_path(f"C2 {label}", records)
            q = tuple(torch.rand(s, device=dev).to(fn.cfg.dtype) for s in
                      ((1, 3, 320, 320), (1, 3, 320, 320), (1, 512, 5)))
            ms[label], kernels[label] = time_path(label, model, fn, q)
            del model, fn, records
            torch.cuda.empty_cache()
            if kw.get("deploy"):
                deploy_against_train(dev, label.split()[0], cfg, weights)
        add_counts(launches, counts)
        torch.cuda.empty_cache()
    for label, _, _ in C2:
        if label.endswith("deploy"):
            base = label.split()[0]
            log(f"C2 {base} bf16 bs1: train form {kernels[base]:.0f} "
                f"kernels/frame, {ms[base]:.3f} ms/frame; deploy form "
                f"{kernels[label]:.0f}, {ms[label]:.3f}")
    return launches


# ---------------------------------------------------------------------------
# D1 the train step across two ranks, D2 `fit` across two ranks, P2
# sharded_infer, C3 the 3-task Achelous3T
# ---------------------------------------------------------------------------


def dist_layout():
    """(backend, each rank's device): NCCL with a GPU a rank where the
    machine shows two, else both ranks on cuda:0 over gloo (NCCL refuses
    two ranks on one device)."""
    if torch.cuda.device_count() >= DIST_WORLD:
        return "nccl", [f"cuda:{r}" for r in range(DIST_WORLD)]
    return "gloo", ["cuda:0"] * DIST_WORLD


def rank_rows(arrays, rank, world):
    """This rank's rows of a global batch (rank 0's first, then rank 1's)."""
    lb = len(arrays["image"]) // world
    return {k: v[rank * lb:(rank + 1) * lb] for k, v in arrays.items()}


def same_on_every_rank(tensors, group) -> bool:
    """Whether every rank holds rank 0's values of `tensors`."""
    import torch.distributed as dist
    flat = torch.cat([t.detach().float().reshape(-1) for t in tensors])
    ref = flat.clone()
    dist.broadcast(ref, src=0, group=group)
    same = torch.tensor([float(torch.equal(flat, ref))], device=flat.device)
    dist.all_reduce(same, group=group)
    return int(same.item()) == dist.get_world_size(group)


def d1_rank(rank, world, devices):
    """One rank of D1: (a) one float32 step (TF32 off) of EN-GDF-PN-S0 on
    its rows of the global batch of STEP_BATCH; (b) D1_STEPS bf16 steps on
    its rows of global batches of TRAIN_BATCH (the first step's launches
    held against the plain versions), then D1_LOCAL_STEPS steps of the
    same rows without the group, the step's compute without its
    collectives.  Returns the metrics, rank 0's parameter changes of (a),
    whether both ranks' states are equal, the times and the launches."""
    import torch.distributed as dist
    from achelous_tpu_torch.core.config import AchelousConfig
    from achelous_tpu_torch.data.synthetic import synthetic_arrays, to_batch
    from achelous_tpu_torch.parallel.dist import gather_rows
    from achelous_tpu_torch.train.train_state import (TrainConfig,
                                                      create_train_state,
                                                      make_train_step,
                                                      state_tensors)
    dev = torch.device(devices[rank])
    torch.cuda.set_device(dev)
    group = dist.group.WORLD
    w = wrappers()
    out = {}

    cfg = AchelousConfig(resolution=TRAIN_RES)
    tcfg = TrainConfig()
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = create_train_state(train_model(cfg, dev), cfg, tcfg)
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    arrays = synthetic_arrays(cfg, STEP_BATCH, tcfg.max_gt, seed=7)
    state, m = make_train_step(cfg, tcfg, group)(
        state, to_batch(rank_rows(arrays, rank, world), dev), 0.01)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    out["f32_metrics"] = {k: float(v) for k, v in m.items()}
    out["f32_same"] = same_on_every_rank(state_tensors(state), group)
    # grad_accum's row exchange, on the backend's device tensors
    mine = {"f": torch.arange(6.0, device=dev).view(3, 2) + 6 * rank,
            "b": torch.arange(3, device=dev) % world == rank}
    got = gather_rows(mine, group)
    if not (torch.equal(got["f"].flatten().cpu(), torch.arange(6.0 * world))
            and got["b"].tolist() == [i % world == r for r in range(world)
                                      for i in range(3)]):
        raise AssertionError(f"D1 rank {rank}: gather_rows gave {got}")
    if rank == 0:
        out["f32_changes"] = {
            n: (p.detach() - before[n]).cpu().numpy()
            for n, p in state.model.named_parameters()}
    del state, before

    cfg = AchelousConfig(resolution=TRAIN_RES, dtype=torch.bfloat16)
    tcfg = TrainConfig(batch_size=TRAIN_BATCH)
    batches = [to_batch(rank_rows(synthetic_arrays(
        cfg, TRAIN_BATCH, tcfg.max_gt, seed=100 + i), rank, world), dev)
        for i in range(D1_STEPS)]
    state = create_train_state(train_model(cfg, dev), cfg, tcfg)
    steps = {"group": make_train_step(cfg, tcfg, group),
             "alone": make_train_step(cfg, tcfg)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    times, records, totals = {"group": [], "alone": []}, [], {}
    for kind, n in (("group", D1_STEPS), ("alone", D1_LOCAL_STEPS)):
        dist.barrier(group)
        for i in range(n):
            for f in w.values():
                f.launches = 0
            t0, t1 = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
            with (on_path_inputs(records) if kind == "group" and i == 0
                  else contextlib.nullcontext()):
                t0.record()
                state, m = steps[kind](state, batches[i], 0.01)
                t1.record()
                torch.cuda.synchronize()
            times[kind].append(t0.elapsed_time(t1))
            counts = {n_: f.launches for n_, f in w.items() if f.launches}
            if counts != TRAIN_LAUNCHES:
                raise AssertionError(f"D1 rank {rank} {kind} step {i}: "
                                     f"launches {counts}")
            if kind == "group":
                add_counts(totals, counts)
            vals = {k: float(v) for k, v in m.items()}
            if m["skipped_nonfinite"] or not all(
                    np.isfinite(list(vals.values()))):
                raise AssertionError(f"D1 rank {rank} step {i}: {vals}")
        if kind == "group":
            out["bf16_same"] = same_on_every_rank(state_tensors(state), group)
    out["peak"] = torch.cuda.max_memory_allocated(dev)
    out["ms"] = float(np.median(times["group"][1:]))
    out["alone_ms"] = float(np.median(times["alone"]))
    out["launches"] = totals
    out["bf16_metrics"] = {k: float(v) for k, v in m.items()}
    check_on_path(f"D1 rank {rank} bf16 step 0", records)
    return out


def d1_check(dev, ranks):
    """D1 from the ranks' results (`d1_rank`): (a) the float32 step at
    global batch STEP_BATCH against the single-process step on the card
    from the same weights, under T2's gate (the single process's own
    spread read from its step on the batch reversed); (b) each rank's
    bf16 step at global batch TRAIN_BATCH, logged.  Returns the ranks'
    K1/K2 launches in (b)."""
    from achelous_tpu_torch.core.config import AchelousConfig
    from achelous_tpu_torch.data.synthetic import synthetic_arrays, to_batch
    from achelous_tpu_torch.train.train_state import TrainConfig
    cfg = AchelousConfig(resolution=TRAIN_RES)
    tcfg = TrainConfig()
    model = train_model(cfg, "cpu")
    arrays = synthetic_arrays(cfg, STEP_BATCH, tcfg.max_gt, seed=7)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    want, wm, _ = one_step(model, cfg, tcfg, arrays, dev)
    rev, _, _ = one_step(model, cfg, tcfg, arrays, dev, reverse=True)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    zero = zero_gradient_biases(model.to(dev), to_batch(
        synthetic_arrays(cfg, 2, tcfg.max_gt, seed=7), dev))
    got, gm = ranks[0]["f32_changes"], ranks[0]["f32_metrics"]
    if not all(r["f32_same"] and r["bf16_same"] for r in ranks) or \
            ranks[1]["f32_metrics"] != gm:
        raise AssertionError("D1: the ranks' states or metrics differ")
    rel = {k: abs(gm[k] - wm[k]) / abs(wm[k]) for k in
           ("loss", "loss_det", "loss_seg", "loss_wl", "loss_pc",
            "grad_norm")}
    rows = {n: (float((torch.from_numpy(got[n]) - d).norm()),
                float(d.norm()), float((rev[n] - d).norm()))
            for n, d in want.items()}

    def ratio(n):
        e, c, f = rows[n]
        bound = STEP_REL * c + STEP_FLOOR * f
        return e / bound if bound else (float("inf") if e else 0.0)
    top = max(float(d.abs().max()) for d in want.values())
    diff, name = max((float((torch.from_numpy(got[n]) - d).abs().max()), n)
                     for n, d in want.items())
    held = sorted((n for n in rows if n not in zero), key=ratio,
                  reverse=True)
    log(f"D1 (a) float32 global batch {STEP_BATCH}, two ranks vs one "
        f"process on the card, relative: " + ", ".join(
            f"{k} {v:.3g}" for k, v in rel.items()) + f"; the largest "
        f"parameter difference {diff:.4g} ({name}), {diff / top:.3g} of "
        f"the largest change (bound {STEP_REL}); worst of the other "
        f"{len(held)} tensors against {STEP_REL} of their own change + "
        f"{STEP_FLOOR} x the single process's spread (batch reversed): "
        + ", ".join(f"{n} {ratio(n):.3g}" for n in held[:3])
        + "; both ranks' states equal")
    if gm["skipped_nonfinite"] or max(rel.values()) > STEP_LOSS_RTOL or \
            diff > STEP_REL * top or ratio(held[0]) > 1.0:
        raise AssertionError("D1 (a): the two-rank step is outside T2's "
                             "gate")
    launches = {}
    for r, res in enumerate(ranks):
        add_counts(launches, res["launches"])
        log(f"D1 (b) rank {r} bf16 global batch {TRAIN_BATCH} "
            f"({TRAIN_BATCH // DIST_WORLD} a rank) {TRAIN_RES}x{TRAIN_RES}: "
            f"{res['ms']:.2f} ms/step "
            f"(median of steps 2-{D1_STEPS}, CUDA events), the same rows "
            f"without the group {res['alone_ms']:.2f} ms/step, so the "
            f"collectives and waits take "
            f"{1 - res['alone_ms'] / res['ms']:.3f} of the step; peak "
            f"memory {res['peak'] / 2**30:.2f} GiB; launches over "
            f"{D1_STEPS} steps {res['launches']} ({TRAIN_LAUNCHES} a step)")
    return launches


def d2_rank(rank, world, devices, root):
    """One rank of D2: `fit` across the group on the tree at `root` for
    FIT_EPOCHS epochs into <root>/d2, rank 0 writing; then a resume from
    rank 0's epoch-1 checkpoint into <root>/d2_resume.  Rank 0 holds
    the kernels' launches of the first run against the plain versions."""
    import torch.distributed as dist
    from achelous_tpu_torch.core.config import AchelousConfig
    from achelous_tpu_torch.data.waterscenes import (WaterScenesDataset,
                                                     WaterScenesPaths)
    from achelous_tpu_torch.models.achelous import create_model
    from achelous_tpu_torch.train.checkpoints import CheckpointManager
    from achelous_tpu_torch.train.loop import fit
    from achelous_tpu_torch.train.train_state import (TrainConfig,
                                                      create_train_state,
                                                      state_tensors)
    dev = torch.device(devices[rank])
    torch.cuda.set_device(dev)
    group = dist.group.WORLD
    cfg = AchelousConfig(resolution=TRAIN_RES, dtype=torch.bfloat16)
    tcfg = TrainConfig(batch_size=FIT_BATCH, epochs=FIT_EPOCHS)
    w = wrappers()
    out = {"counts": {}, "msgs": {}, "secs": {}}
    records = []
    for name in ("d2", "d2_resume"):
        train_ds = WaterScenesDataset(cfg, WaterScenesPaths.under(root))
        val_ds = WaterScenesDataset(cfg,
                                    WaterScenesPaths.under(root, "val.txt"))
        state = None
        if name == "d2_resume":
            ckpt = CheckpointManager(os.path.join(root, "d2", "ckpt"))
            state = create_train_state(create_model(cfg, dev, train=True),
                                       cfg, tcfg)
            state = ckpt.restore(ckpt.periodic()[0], state)
            if state.epoch != 1 or len(state.data_rng["ranks"]) != world:
                raise AssertionError(f"D2 rank {rank}: resumed epoch "
                                     f"{state.epoch}")
        msgs = []
        for f in w.values():
            f.launches = 0
        dist.barrier(group)
        t0 = time.perf_counter()
        with (on_path_inputs(records) if name == "d2" and rank == 0
              else contextlib.nullcontext()):
            state = fit(cfg, tcfg, train_ds, val_ds,
                        log_dir=os.path.join(root, name), save_period=1,
                        state=state, device=dev, progress=msgs.append,
                        group=group)
            torch.cuda.synchronize()
        out["secs"][name] = time.perf_counter() - t0
        add_counts(out["counts"], {n: f.launches for n, f in w.items()
                                   if f.launches})
        out["msgs"][name] = msgs
        if state.epoch != FIT_EPOCHS or not same_on_every_rank(
                state_tensors(state), group):
            raise AssertionError(f"D2 rank {rank} {name}: epoch "
                                 f"{state.epoch}, or the ranks' states "
                                 f"differ")
    if rank == 0:
        check_on_path("D2 fit rank 0", records)
    return out


def d2_check(root, ranks, backend):
    """D2 from the ranks' results (`d2_rank`) and rank 0's files under
    `root`: the histories of the run and of the resume, the checkpoints.
    Returns the ranks' kernel launches."""
    hist = {name: [json.loads(line) for line in
                   open(os.path.join(root, name, "history.jsonl"))]
            for name in ("d2", "d2_resume")}
    ckpts = sorted(os.listdir(os.path.join(root, "d2", "ckpt")))
    if [h["epoch"] for h in hist["d2"]] != list(range(FIT_EPOCHS)) or \
            [h["epoch"] for h in hist["d2_resume"]] != [FIT_EPOCHS - 1] or \
            any("mAP50" not in h[-1] for h in hist.values()) or not all(
                np.isfinite(x["loss"]) for h in hist.values() for x in h):
        raise AssertionError(f"D2 histories {hist}")
    launches = {}
    for r, res in enumerate(ranks):
        add_counts(launches, res["counts"])
        log(f"D2 rank {r}: fit {res['secs']['d2']:.1f} s, resume "
            f"{res['secs']['d2_resume']:.1f} s; "
            + "; ".join(res["msgs"]["d2"] + res["msgs"]["d2_resume"])
            + f"; launches {res['counts']}")
    last = hist["d2"][-1]
    log(f"D2 over {backend}: history.jsonl of rank 0 epochs "
        f"{[h['epoch'] for h in hist['d2']]}, resumed "
        f"{[h['epoch'] for h in hist['d2_resume']]}; checkpoints {ckpts}; "
        f"both ranks' states equal after each run; last: " + ", ".join(
            f"{k} {last[k]:.4g}" for k in ("loss", "val_loss", "mAP50",
                                           "miou_sem", "n_images")))
    return launches


def dist_rank(rank, world, devices, root):
    """One rank of D1 then D2, in one process (one spawn, one warm-up)."""
    return {"d1": d1_rank(rank, world, devices),
            "d2": d2_rank(rank, world, devices, root)}


def dist_phases(dev):
    """D1 and D2: two ranks on the card (`dist_layout`), spawned once;
    D2's tree written first, like F1's.  Returns the ranks' launches."""
    import tempfile
    from achelous_tpu_torch.data.example import write_tree
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from torch_port_ranks import run_ranks     # the CPU tests' launcher
    backend, devices = dist_layout()
    log(f"D1/D2: {DIST_WORLD} ranks over {backend} on {devices} "
        f"({torch.cuda.device_count()} GPU visible)")
    with tempfile.TemporaryDirectory() as root:
        write_tree(root, FIT_TRAIN + FIT_VAL, FIT_SIZE, points=400,
                   val=FIT_VAL)
        t0 = time.perf_counter()
        ranks = run_ranks(dist_rank, DIST_WORLD, devices, root,
                          backend=backend)
        log(f"D1/D2: the ranks ran in {time.perf_counter() - t0:.1f} s "
            f"(spawn, imports and the first step's set-up included)")
        launches = d1_check(dev, [r["d1"] for r in ranks])
        add_counts(launches, d2_check(root, [r["d2"] for r in ranks],
                                      backend))
    return launches


def p2_phase(dev):
    """P2: `AchelousPredictor.sharded_infer` over two shards on the card
    ([cuda:0, cuda:0] on one GPU, else the first two), batch P2_BATCH, on
    EN-GDF-PN-S0 and EF-GDF-PN2-S0 (K1-K4): float32 (TF32 off) against the
    single request on the whole batch, discrete outputs equal and floats
    within P2_TOL; bf16 within the serving gate; every launch held against
    the plain version; both timed.  Returns the sharded calls' launches."""
    from achelous_tpu_torch.entry import (perturb_attention,
                                          perturb_deform_convs,
                                          serving_config)
    from achelous_tpu_torch.predict import AchelousPredictor
    shards = [dev] * DIST_WORLD
    if torch.cuda.device_count() >= DIST_WORLD:
        shards = [torch.device("cuda", i) for i in range(DIST_WORLD)]
    launches = {}
    rng = np.random.RandomState(300)
    arrays = [rng.rand(P2_BATCH, 3, P2_RES, P2_RES),
              rng.rand(P2_BATCH, 3, P2_RES, P2_RES), rng.rand(P2_BATCH, 512, 5)]
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    for label, backbone, pc_model, want in P2_PATHS:
        records = []
        for dtype in (torch.float32, torch.bfloat16):
            cfg = serving_config(dtype, P2_RES, backbone, pc_model)
            pred = AchelousPredictor(cfg, confidence=P2_CONF, nms_iou=0.5,
                                     device=dev)
            perturb_deform_convs(pred.model)
            perturb_attention(pred.model)
            args = [torch.from_numpy(a.astype(np.float32)).to(dev, dtype)
                    for a in arrays]
            fp32 = dtype == torch.float32
            if fp32:
                torch.backends.cuda.matmul.allow_tf32 = False
                torch.backends.cudnn.allow_tf32 = False
            sharded = pred.sharded_infer(shards)
            single = pred.infer(*args)
            got, counts = counted(lambda: sharded(*args))
            with on_path_inputs(records):
                sharded(*args)
            rose = {n: c // DIST_WORLD for n, c in counts.items()}
            if rose != want:
                raise AssertionError(f"P2 {label}: launches a shard {rose}, "
                                     f"want {want}")
            add_counts(launches, counts)
            # bf16: the maps (probabilities, point classes, head maps);
            # a survivor near the threshold may flip, so the detections'
            # padded tensors are compared in float32 only
            g_flat = [*got[1:4], *got[4]]
            w_flat = [*single[1:4], *single[4]]
            if fp32:
                g_flat, w_flat = [*got[0], *g_flat], [*single[0], *w_flat]
            floats = [(g, w_) for g, w_ in zip(g_flat, w_flat)
                      if g.is_floating_point()]
            if fp32:
                exact = all(torch.equal(g, w_) for g, w_ in
                            zip(g_flat, w_flat) if not g.is_floating_point())
                err = max(float(((g - w_).abs() / (w_.abs() + 1)).max())
                          for g, w_ in floats)
                if not exact or err > P2_TOL:
                    raise AssertionError(f"P2 {label} float32: discrete "
                                         f"equal {exact}, float err {err}")
            else:
                err = max(serving_error(g, w_) for g, w_ in floats)
                if err > MAIN_PATH_TOL:
                    raise AssertionError(f"P2 {label} bf16: {err}")
            ms_sharded = cuda_ms(lambda: sharded(*args), iters=5, warmup=2)
            ms_single = cuda_ms(lambda: pred.infer(*args), iters=5, warmup=2)
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = tf32
            log(f"P2 {label} {str(dtype).split('.')[-1]} batch {P2_BATCH} "
                f"over {[str(d) for d in shards]}: sharded vs the single "
                f"request, " + (f"discrete outputs equal, floats within "
                                f"{err:.3g} (|diff| / (|ref| + 1))" if fp32
                                else f"maps within {err:.3g} by the "
                                f"serving gate's measure") + f"; "
                f"{int(got[0].valid.sum())} detections sharded, "
                f"{int(single[0].valid.sum())} single, "
                f"{int((got[0].valid == single[0].valid).all(-1).sum())} of "
                f"{P2_BATCH} images with the same survivors; launches "
                f"{counts}; {ms_sharded:.3f} ms a "
                f"sharded batch, {ms_single:.3f} ms a single request")
            del pred, sharded, single, got
            torch.cuda.empty_cache()
        check_on_path(f"P2 {label}", records)
    return launches


def c3_phase(dev):
    """C3: one Achelous3T (the 3-task model, `entry(..., with_pc=False)`)
    request at 320^2, bf16, batch 1, through K1 x4 and K2 x4, against
    float32 plain on the CPU within the serving gate; its launches held
    against the plain version.  Returns its launches."""
    records = []
    counts, model, fn = serve_path(
        dev, "EN-GDF-PN-S0 Achelous3T", TRAIN_LAUNCHES, records, n=1,
        with_pc=False)
    if model.with_pc or hasattr(model, "pc_seg_model"):
        raise AssertionError("C3 built the point-cloud branch")
    check_on_path("C3 Achelous3T", records)
    return counts


def main():
    # cuBLAS reads this when it starts; grads_of's deterministic mode
    # needs it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    log(device_line())
    dev = torch.device("cuda", 0)
    from achelous_tpu_torch.kernels import build
    secs = build.build()
    log(f"build: {secs:.2f} s ({build.library_path().name})")
    kernels = check_kernels(dev)
    launches = {n: 0 for n in kernels}
    for label, backbone, pc_model, want_rose in PATHS:
        counts, model, fn = serve_path(dev, label, want_rose,
                                       backbone=backbone, pc_model=pc_model)
        for n, c in counts.items():
            launches[n] += c
        q = tuple(torch.rand(s, device=dev).to(fn.cfg.dtype) for s in
                  ((1, 3, 320, 320), (1, 3, 320, 320), (1, 512, 5)))
        time_path(label, model, fn, q)
        del model, fn
    for name, count in train_phases(dev).items():
        launches[name] += count
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with phase("T4 gradients of K3"):
        check_attention_gradients(dev)
        check_attention4d_gradients(dev)
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = tf32
    torch.cuda.empty_cache()
    with phase("T5 training EF-GDF-PN-S0 and EN-GDF-PN2-S0"):
        for name, count in train_paths(dev).items():
            launches[name] += count
    torch.cuda.empty_cache()
    with phase("T6 training the other held configurations"):
        add_counts(launches, train_configs(dev))
    torch.cuda.empty_cache()
    with phase("T7 training the reparameterizable configurations"):
        add_counts(launches, train_reparameterizable(dev))
    torch.cuda.empty_cache()
    with phase("F1 fit on a WaterScenes tree"):
        for name, count in fit_on_the_card(dev).items():
            launches[name] += count
    import tempfile
    with tempfile.TemporaryDirectory() as root:
        with phase("P1 the predictor"):
            pred, args, counts = predictor_phase(dev, root)
            add_counts(launches, counts)
        with phase("X1 export on the card"):
            add_counts(launches, export_phase(pred, args, root))
        del pred, args
    torch.cuda.empty_cache()
    add_counts(launches, sweep_phase(dev))
    torch.cuda.empty_cache()
    add_counts(launches, c2_phase(dev))
    torch.cuda.empty_cache()
    with phase("D1 and D2 across two ranks"):
        add_counts(launches, dist_phases(dev))
    with phase("P2 sharded_infer"):
        add_counts(launches, p2_phase(dev))
    torch.cuda.empty_cache()
    with phase("C3 Achelous3T"):
        add_counts(launches, c3_phase(dev))
    rows = []
    for name, source, replaces in (
            ("fused_radarconv", "achelous_tpu_torch/csrc/deform.cu",
             "achelous_tpu/ops/pallas_deform.py:445"),
            ("deform_samples", "achelous_tpu_torch/csrc/deform.cu",
             "achelous_tpu/ops/pallas_deform.py:219"),
            ("fused_bias_attention", "achelous_tpu_torch/csrc/attention.cu",
             "achelous_tpu/ops/pallas_attention.py:69"),
            ("farthest_point_sample", "achelous_tpu_torch/csrc/pointops.cu",
             "achelous_tpu/ops/pallas_pointops.py:58")):
        if launches[name] == 0:
            raise AssertionError(f"{name}: no launch on the main paths")
        k = kernels[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
                     "bound_by": k["bound_by"],
                     "library_ms": k["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
