#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``bayestpu_torch``) on one NVIDIA card.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device and the CUDA toolkit (``nvcc``); it imports nothing of JAX and
nothing of the JAX package. Each phase prints one JSON line; any failure
ends the run with a nonzero exit and no result line.

1. card    — ``nvidia-smi`` name and power limit, torch and CUDA versions.
2. build   — compiles every kernel of ``bayestpu_torch/csrc`` with nvcc;
   then the ``tensor_cores`` line: registers, stack frame and spills
   (``-Xptxas -v``) of the redesigned kernels and the HMMA/IMMA
   instructions that ``cuobjdump -sass`` shows in them (fails if a
   tensor-core kernel has none, or if any of them spills).
3. kernels — each CUDA kernel against its plain PyTorch version on the
   card: the vgg11_me head shape and a ragged one, bf16 and f32 (int8 for
   the int8 kernels, bit for bit); exact mask readouts (the backward's mask
   and the int8 kernels' mask are the forward's); per-sample bit identity;
   negative seeds; times (each kernel in three rounds that alternate it
   with its library call; rows 2 and 3 in bf16 and f32). The MC heads on
   an x that carries the sample axis (one ``dropout_matmul_xs`` or
   ``dropout_matmul_int8_xs`` launch, sample s bit-equal to the single
   launch on x[s]). ``dropout_matmul_samples`` in bf16 at the heads that
   the analysis phase alone gives it (batch 250: S = 10 and 49, 10 and 100
   classes), sample s bit-equal to the single launch. The four Masksembles
   bank kernels at the Masksembles head shape (S = 4), a ragged one and one
   whose K is odd, their indices wrapping and including a negative one:
   float rows on a {0, 1} bank and on one with 2.0 entries, int8 rows bit
   for bit, per-sample bit identity, both heads on an x that carries the
   sample axis (``bank_matmul_xs``, ``bank_matmul_int8_xs``), times (each
   in three rounds that alternate it with its library call; row 8 with
   bf16 and f32 x). The
   masked convs of ``masked_conv.cu`` (rows 10-11) at the block-1 site
   shape and ragged geometries (stride 2 with asymmetric SAME, VALID,
   explicit padding, 1x1 stride 2, F not a multiple of 8): bf16 and f32
   against the plain versions, every int8 epilogue bit for bit, the exact
   mask readout, per-sample identity, negative seeds, wrapping and
   negative bank indices, x carrying the sample axis (one _xs launch of
   the MC and of the bank convs, sample s bit-equal to the single launch
   on x[s]); times at the four block-site shapes (the bank convs in
   three rounds that alternate them with cuDNN). The same checks at the
   three deferred block sites of resnet18 at batch 128 (3x3 stride 2
   padded ((1, 1), (1, 1)) and the 1x1 stride-2 projection), the readout
   showing that the two convs of a block apply one mask, and the times of
   the samples and _xs launches there and of the 3x3 ones at ImageNet
   shapes (``RESNET18_IMAGENET_SITES``, row 10I); ``conv_int8_fused`` at every
   geometry of the int8 resnet18_me's and vgg11_me's deterministic convs
   (batch 128, f32 and int8 store, bit for bit); the 7x7 stride-2 window (x
   8x32x32x64 -> 64, the smaller tile of ``make_mma_geom``) in every
   routine, timed; row 10's f32 route (three TF32 products) at block site
   1 in f32 and both mixed types (bf16 x with f32 w, f32 x with bf16 w),
   checked and timed beside cuDNN f32. The one-pass bf16 epilogue of the
   convs without a mask (``epilogue``: ``bf16_epilogue_kernel``) at the
   resnet50 block-site model's ten epilogue shapes, bit for bit against
   its plain version, timed beside its bound and the plain op chain; also
   ``--only epilogue``. Every head check again at the
   resnet18_me head (N = 100), the lenet_me head (M = 256, K = 100, N =
   10) and lenet's fc_1 (K = 80, N = 100), rows 3 and 5 timed in bf16 at
   the first two.
   ``dropout_apply`` (row 1) at the head and at the conv backward's
   (N·H·W, C) views of vgg11's block site 1 and resnet18's stage-1
   boundary, in f32 and bf16 x, timed beside ``torch.mul``; bit-equal to
   its plain version there, at the other block-site views, at a ragged K,
   and on an x that is not 16-byte aligned.
4. backward — autograd through ``dropout_matmul`` against
   ``dropout_matmul_vjp_plain`` at the head shape, and through
   ``dropout_conv`` against ``dropout_conv_vjp_plain`` at the block-1 site
   shape.
5. slice   — vgg11_me at full width, bf16, batch 128, S=10, rate 0.25,
   seeded weights, through ``BayesEngine(device="cuda")``: spatial and
   temporal predictive and a host loop of one-sample predicts, with launch
   counts, agreement checks, a CPU reference on 8 rows, and times.
6. profile — device time by kernel over spatial predicts (torch.profiler).
7. train   — vgg11_me at full width, bf16, batch 128, rate 0.25 on 10,000
   hard synthetic CIFAR-10 images: 12 epochs (936 steps, as ``bench.py``
   trains the flagship) of ``create_state`` + ``make_train_step`` (SGD 0.9,
   cosine LR 0.05, clip 10) with launch counts, step times, throughput and
   profiled steps, one epoch of ``train_loop``
   with validation on a fresh model, then the trained weights served
   through ``BayesEngine`` (acc, ECE, NLL, aPE and aPE_ood on 2,000 test
   images).
8. qat, int8 — the int8 operating point as ``bench.py`` builds it: 6 epochs
   of QAT (``QuantConfig(8, 0)``, cosine LR 0.01) from the trained float
   weights, BatchNorm re-estimated, then the weights served on the int8
   model (five ``dropout_matmul_int8_samples`` and 11 ``conv_int8_fused``
   launches per spatial predict) and on the fake-quant model: acc, ECE,
   NLL, aPE, aPE_ood, the bench's gate against the bf16 point, launch
   counts, spatial against temporal, the card against the CPU on 8 rows
   (every int8 model's CPU twin takes the card's conv route,
   ``_card_route``), the int8 and bf16 spatial
   p50 in turns, and the int8 predict profiled by kernel group.
9. analysis — the paper's analysis battery and the rest of int8
   (``phase_analysis``): ``FullAnalysis`` on the trained bf16 vgg11_me
   (2,000 test images, batch 250, 10 passes: per-exit and ensemble acc,
   KDE-ECE, hist-ECE, overthinking; the 1-49 pass sweep; the early-exit
   table over ``REFERENCE_THRESHOLDS``, max and margin rules), profiled;
   ``early_exit_select`` on the card equal to the CPU's; the sweep's first
   rows against the CPU; the native KDE-ECE against numpy; the FLOPs table
   of vgg19_me (seeded weights, 500 images), its first rows' early exits
   and FLOPs, with planted confident rows, equal to the CPU model's; the
   int8 vgg11_me with ``mixed_head`` and
   with the quantize-late overrides on the QAT weights, served and held
   against the CPU, with their residency dtypes; the native library built
   from the port's copies, ``augment_gather`` against numpy and one
   ``BatchPipeline`` epoch, on the host and through ``PrefetchIterator`` to
   the card.
10. mask    — the Masksembles vgg11_me of ``bench.py:723-739``
   (``BayesConfig(kind=MASK, num_masks=4, scale=2.0)``, bf16, batch 128,
   S = 4): the trained float weights with the model's own banks,
   fine-tuned for 2 epochs under the batch split (no port kernel a step),
   then served through ``BayesEngine(device="cuda")``: five
   ``bank_matmul_samples`` launches per spatial predict, 20 ``bank_matmul``
   per temporal one, ``predict(sample_idx=i)`` equal to sample i, spatial
   against temporal, the card against the CPU on 8 rows, acc (≥ 0.5), ECE,
   NLL, aPE, aPE_ood, times and a profiled predict; and the same weights
   on the int8 model under ``INT8_Q`` (no QAT): five
   ``bank_matmul_int8_samples`` and 11 ``conv_int8_fused`` launches per
   spatial predict, 20
   ``bank_matmul_int8`` per temporal one, spatial and temporal
   bit-identical, the card against the CPU, acc and ECE, the int8 and bf16
   spatial p50 in turns.
11. block   — ``vgg11`` with fused block sites (``dropout="block"``), bf16,
   batch 128: seeded MC serving (S = 10) with exact launch counts (1
   ``dropout_conv_samples``, 3 ``dropout_conv_xs``, 1 ``dropout_matmul_xs``
   a spatial predict; its Masksembles twin 1 ``bank_conv_samples``, 3
   ``bank_conv_xs``, 1 ``bank_matmul_xs``), a
   3-epoch MC fine-tune of the train phase's weights served on 2,000 test
   images, its Masksembles twin (S = 4) fine-tuned under the batch split
   and served, and the int8 models (also with ``int8_conv_min_ch=32``);
   spatial against temporal, the card against the CPU (``phase_block``).
12. resnet  — ResNet-18 on CIFAR-100 shapes (``phase_resnet``): the int8
   resnet18_me of the JAX bench's BASELINE config 5 and its bf16 twin,
   the block-site resnet18 (MC and Masksembles, bf16) served with exact
   launch counts, spatial against temporal and the card against the CPU,
   two profiled predicts, the int8 resnet18_me in f32 compute served and
   held bit for bit against the CPU port on the card's conv route (every
   deterministic int8 conv on ``conv_int8_fused``, none through im2col),
   short bf16 fine-tunes of resnet18_me and the
   block-site resnet18 (launches per step; the loss falls), and one
   resnet18_me training step at batch 8 against the CPU.
13. lenet   — the LeNet family on MNIST shapes (``phase_lenet``): the
   threefry masks of ``core.threefry`` on the card against the CPU bit for
   bit at lenet's site-0 shape with S = 10 keys; ``lenet_me`` at the JAX
   bench's config (batch 256, fused, bf16, S = 10) served with exact
   launch counts and profiled, trained 3 epochs with the ``"lenet"``
   recipe on synthetic MNIST and served in bf16 and int8; and the
   materialized routes (threefry sites) of ``lenet(num_bayes_layers=3)``,
   the unfused ``vgg11_me`` and ``resnet18(dropout="layer")`` at batch 8
   against the CPU.
14. convert  — the NN→BNN converter and the rest of the engine
   (``phase_convert``): vgg19_me at full width on CIFAR-100 shapes (bf16,
   batch 128, S = 10; 5 ``dropout_matmul_samples`` a spatial predict),
   ``BayesEngine.compile`` (a CUDA graph; its replayed predictive equal
   to the eager one bit for bit), eager and replayed p50s, ``benchmark``
   and ``cost_analysis``; vgg16 and vgg19 one predict each; the
   ``cli/sweep.py`` lenet_specs sweep (n = 1-4 sites, batch 32, S = 4)
   and a Masksembles point with ``_measure``'s keys; ``MCDropoutModel``
   and ``MasksemblesModel`` against the CPU; AlexNet at its published
   widths (224x224x3, 1000 classes, f32, batch 32, S = 10, n = 3 and 4:
   row 3 at fc6, 3x at fc7, row 10's f32 samples launch at conv5),
   compiled as vgg19_me; those three launches also held against their
   plain versions at those shapes and timed beside the library call.
15. step_vs_cpu — one training step at batch 8 on the card and on the CPU
   from one seeded init and the same seeds, in f32 and bf16.
16. shard — sample-axis and data-parallel sharding (``engine.sharding``,
   ``engine.distributed``): two gloo ranks on the one card (NCCL refuses
   two ranks on one device; gloo runs ``all_reduce`` and ``broadcast`` on
   CUDA tensors) serve the seeded ``vgg11_me`` bf16 at batch 128, S = 10:
   the sharded predictive on the (1, 2) mesh against rank 0's local
   spatial predict (each sample's logits bit-equal, the mean within
   1e-6), on the (2, 1) mesh within CPU_REF_RTOL, with exactly 5
   ``dropout_matmul_samples`` launches a sharded predict on each rank;
   ``distributed_evaluate``; two f32 data-parallel steps at global batch
   128 against rank 0's one-process steps (SHARD_STEP_RTOL of each
   update's norm);
   three bf16 steps whose replicas stay bit-identical. Then a one-rank
   NCCL world runs the same predictive checks and the f32 steps. Also
   ``--only shard``.
17. tools — the tooling (``phase_tools``): row 3's ``utils.profiler.
   roofline`` at the head shape (its bound PERF.md's within 1%) and
   ``bench.kernels`` at the head shape; then, counted, ``utils.timing.
   scan_time_s`` of the flagship predict (a CUDA graph of k and 2k
   predicts) between 0.95x the profiler's device time and the eager p50,
   a 2-epoch ``lenet_me`` run stopped after epoch 0 and resumed from its
   checkpoint bit-identical to the whole run, and ``cli.train`` →
   ``cli.predict`` → ``cli.build`` on the card (their output in
   ``build/chip_smoke_tools/cli.log``). Also ``--only tools``.

Then the ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. ``--only kernels,conv,convert`` runs
the card and build phases and then only the named phases (a quick check
of a kernel change, or of the convert phase), and prints no result line.
The kernels' launches are those of the main paths: the slice's
predicts, the 936 training steps, the int8 phase (QAT, BN re-estimation
and int8 serving), the analysis phase, the mask phase (fine-tune and
serving, bf16 and int8), the block phases, the resnet phase, the lenet
phase, the convert phase, the shard phase and the tools phase's counted
part (a replayed CUDA graph relaunches the
kernels it captured without passing through their wrappers, so only the
capture counts); the fake-quant evaluates are attribution and not
counted. The one-pass bf16 epilogue (``bias_act_bf16``) is counted with
the masked kernels: every exact launch dict of a bf16 float model at
inference lists its launches, one for each conv without a site
(VGG11_ME_CONVS and the constants beside it) in every forward.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

from bayestpu_torch.utils.profiler import PEAKS, device_events

# the H100 SXM's data-sheet rates (``utils.profiler.PEAKS``): HBM3 bytes/s,
# dense tensor-core bf16, tf32 and int8 (TOP/s), f32 outside the tensor cores
MEM_BYTES_PER_S = PEAKS["h100"]["hbm"]
PEAK_FLOPS = {"bfloat16": PEAKS["h100"]["bf16"],
              "tfloat32": PEAKS["h100"]["tf32"],
              "float32": PEAKS["h100"]["f32"],
              "int8": PEAKS["h100"]["int8"]}
SOURCE = "bayestpu_torch/csrc/masked_matmul.cu"
REPLACES = {"dropout_matmul": "bayestpu/kernels/masked_matmul.py:113",
            "dropout_matmul_samples": "bayestpu/kernels/masked_matmul.py:286",
            "dropout_apply": "bayestpu/kernels/masked_matmul.py:135",
            "dropout_matmul_int8": "bayestpu/kernels/masked_matmul.py:444",
            "dropout_matmul_int8_samples":
                "bayestpu/kernels/masked_matmul.py:519",
            "dropout_matmul_int8_xs": "bayestpu/kernels/masked_matmul.py:444",
            "dropout_matmul_xs": "bayestpu/kernels/masked_matmul.py:113",
            "bank_matmul_int8_samples":
                "bayestpu/kernels/masked_matmul.py:640",
            "bank_matmul_int8_xs": "bayestpu/kernels/masked_matmul.py:763",
            "bank_matmul_int8": "bayestpu/kernels/masked_matmul.py:763",
            "bank_matmul_samples": "bayestpu/kernels/masked_matmul.py:863",
            "bank_matmul_xs": "bayestpu/kernels/masked_matmul.py:843",
            "bank_matmul": "bayestpu/kernels/masked_matmul.py:843"}
HEAD = dict(M=128, K=512, N=10, S=10)     # each vgg11_me exit head
RAGGED = dict(M=300, K=700, N=130, S=3)
# each resnet18_me exit head on CIFAR-100: w 512x100, ragged against the
# float heads' 16-column tiles (rows 2-5 at S = 10, rows 6-9 at NUM_MASKS)
RESNET_HEAD = dict(M=128, K=512, N=100, S=10)
# each lenet_me exit head at the JAX bench's batch (bench.py:706-709): x
# 256x100, w 100x10; and lenet's fc_1 after a site, x 256x80, w 80x100: K a
# multiple of neither 16 nor 32
LENET_HEAD = dict(M=256, K=100, N=10, S=10)
LENET_FC1 = dict(M=256, K=80, N=100, S=10)
HEAD_LABELS = ("head", "resnet_head", "lenet_head")   # indices 0 … S-1
# the kernels timed at the resnet18_me and lenet_me heads (bf16 x for the
# float one): the samples heads that their spatial predicts launch, rows 3
# and 5
SAMPLES_TIMED = ("dropout_matmul_samples", "dropout_matmul_int8_samples")
# dropout_apply (row 1) where the backward runs it: (M, K) of the vgg11_me
# head, and the (N·H·W, C) view of a conv site's input at batch 128 at
# vgg11's block site 1 (16x16x64) and resnet18's stage-1 boundary (32x32x64)
APPLY_SHAPES = {"head": (128, 512), "vgg11_site1": (32768, 64),
                "resnet18_stage1": (131072, 64)}
# K a multiple of neither 4 nor 8, and K below a warp: its scalar path
APPLY_RAGGED = {"ragged": (300, 70), "narrow": (97, 13)}
# the other views of a block-site input that the backward masks at batch
# 128, each with a block shape of its own (threads along a row: the least
# power of two that covers K / 4): resnet18's sites 2 and 3 (16x16x128,
# 8x8x256) and vgg11's block sites 2 and 3 (8x8x128, 4x4x256); checked,
# not timed
APPLY_VIEWS = {"resnet18_site2": (32768, 128), "resnet18_site3": (8192, 256),
               "vgg11_site2": (8192, 128), "vgg11_site3": (2048, 256)}
RATE = 0.25
BATCH, SAMPLES = 128, 10
# f32 accumulation runs in another order in the kernel and in torch.matmul;
# the products are exact on both sides (bf16 x bf16 fits f32), so the
# difference is a few ulps of the partial sums: relative to max|ref|
KERNEL_RTOL = 1e-5
# spatial vs temporal per-sample logits: the heads are bit-identical per
# sample; cuDNN may pick another conv algorithm from one call to the next
SPATIAL_TEMPORAL_ATOL = 1e-3
# card vs CPU on rows 0-7: bf16 convs round at other points in cuDNN and
# oneDNN (the port and JAX differ by ~0.005 on CPU logits of magnitude ~1.4)
CPU_REF_RTOL = 0.03
# backward on the card against its plain version on the same tensors: the
# f32 products are the same torch.matmul calls on both sides; under bf16 dx
# and dw are rounded to bf16 at the end, so allow one bf16 ulp (2^-7
# relative) should a sum round the other way
BWD_RTOL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
TRAIN_EPOCHS, TRAIN_LR, TRAIN_CLIP = 12, 0.05, 10.0    # bench.py:54,68,106
# one training step, card against CPU, from one init and one set of seeds.
# f32 (TF32 off): cuDNN and oneDNN sum in other orders, and BatchNorm over a
# batch of 8 amplifies a rounding difference several hundredfold (the CPU
# port and JAX differ by ~6e-5 relative in f32 gradients at batch 4), so
# each parameter update (new - old) must agree to 1% of its norm, the loss
# to 1e-4 and the BN running statistics to 1e-4 of their norm. bf16: the
# convs round to bf16 at other points, which BN amplifies to tens of
# percent in some gradients (JAX's own bf16 gradients differ from its f32
# ones by up to 60% of their norm at batch 4): the loss to 1%, the BN
# statistics to 5%, the head updates to 50% of their norm.
STEP_TOL = {"float32": dict(loss=1e-4, stats=1e-4, update=1e-2),
            "bfloat16": dict(loss=1e-2, stats=5e-2, update=0.5)}
# the int8 operating point as bench.py builds it: QAT fine-tune from the
# float weights (bench.py:673-675), BN re-estimation (bench.py:145-151)
QAT_EPOCHS, QAT_LR, BN_PASSES = 6, 0.01, 3
# bench.py's int8 gate against the bf16 point (bench.py:690-700)
INT8_GATE = {"acc_gap_max": 0.01, "ece_ratio_max": 2.0, "ape_ratio_min": 0.5}
# the int8 model, card against CPU on rows 0-7: the int8 convs and heads sum
# exactly in int32 on both, but three convs take the float branch (the
# entry conv on the raw image, block1's 64->128 conv at 16x16 and
# exit1.convbn1) and run bf16 in cuDNN and oneDNN, which round at other
# points: that can move an activation by one grid step (2^-7). A head's
# logit then moves by at most |delta|_2 * |w_col|_2 / (1 - rate) for the
# change delta of its int8 input; allow a few grid steps there,
# |delta|_2 <= INT8_CPU_STEPS * 2^-7, against the widest column of the five
# heads' quantized kernels (measured: bit-identical)
INT8_CPU_STEPS = 4
# the deterministic int8 convs that a forward of each int8 model runs
# through conv_int8_fused on the card (those a fused kernel takes: stride 1
# or 2, at least 32 input channels): vgg11_me's (MC or Masksembles, any
# head) 11, the block-site vgg11's 3, resnet18_me's 25 (19 in the
# backbone, 6 in the exit cascades); lenet_me has none
VGG11_ME_INT8_CONVS, BLOCK_INT8_CONVS, RESNET_INT8_CONVS = 11, 3, 25
# the convs whose epilogue a forward of each bf16 float model at inference
# runs as one bias_act_bf16 launch (every conv without a site or a quant
# config): vgg11_me's 14 (8 in the backbone, 6 in the exit cascades), 2
# under QUANTIZE_LATE (block0's and block1's), the block-site vgg11's 4,
# vgg19_me's 22 (16 and 6), resnet18_me's 26 (20 and 6), resnet18's 14
# with block or layer sites (its 6 site convs run the masked kernels),
# lenet's 1 at 3 Bayesian layers
VGG11_ME_CONVS, QUANTIZE_LATE_CONVS, BLOCK_CONVS = 14, 2, 4
VGG19_ME_CONVS, RESNET18_ME_CONVS, RESNET18_SITE_CONVS = 22, 26, 14
LENET_NB3_CONVS = 1
# Masksembles (bench.py:723-739): vgg11_me with BayesConfig(kind=MASK,
# num_masks=4, scale=2.0); S = num_masks. Its heads at batch 128, and a
# ragged shape whose indices wrap and include a negative one.
NUM_MASKS, MASK_SCALE = 4, 2.0
# alternating rounds in which each head kernel and its library call are
# timed (their spread is the precision a ratio of the two can claim)
TIMING_ROUNDS = 3
MASK_HEAD = dict(M=128, K=512, N=10, S=NUM_MASKS)
MASK_RAGGED = dict(M=300, K=700, N=130, S=6)
MASK_RAGGED_IDXS = [2, -1, 5, 0, 7, 3]
# K odd: no vector load of x or of a bank row anywhere (the same indices)
MASK_ODD_K = dict(M=37, K=45, N=19, S=6)
# the short fine-tune of the float-trained weights under the batch split
MASK_EPOCHS, MASK_LR = 2, 0.01
# rows 10 and 11 of the kernel table: the masked convs of masked_conv.cu
CONV_SOURCE = "bayestpu_torch/csrc/masked_conv.cu"
# the one-pass bf16 epilogue replaces no TPU kernel: XLA fuses it there
EPILOGUE_SOURCE = "bayestpu_torch/csrc/epilogue.cu"
EPILOGUE_REPLACES = {"bias_act_bf16": "none (XLA's fusion of "
                                      "bayestpu/nn/fused.py:465-474)"}
CONV_REPLACES = {
    name: f"bayestpu/kernels/masked_conv.py:{line}"
    for names, line in (
        (("dropout_conv", "dropout_conv_samples", "dropout_conv_xs",
          "dropout_conv_int8", "dropout_conv_int8_samples",
          "dropout_conv_int8_xs"), 371),               # _masked_conv_kernel
        (("bank_conv", "bank_conv_samples", "bank_conv_xs",
          "bank_conv_int8", "bank_conv_int8_samples",
          "bank_conv_int8_xs"), 430))                  # _bank_conv_kernel
    for name in names}
# the four fused block sites of vgg11 (dropout="block"), each the first conv
# of blocks 1-4 at batch 128: (H = W, C, F), 3x3, SAME, stride 1
CONV_SITES = [(16, 64, 128), (8, 128, 256), (4, 256, 512), (2, 512, 512)]
# the deferred block sites of resnet18 (dropout="block", fused=True), each
# the input of the first block of stages 2-4 at batch 128: (H = W, C, F);
# its convbn1 (3x3, stride 2, padded ((1, 1), (1, 1)) as torch's padding=1)
# and its downsample (1x1, stride 2) mask the input with one site's seeds
RESNET_SITES = [(32, 64, 128), (16, 128, 256), (8, 256, 512)]
# the same sites at ImageNet shapes (``stem="imagenet"``: 224 -> 56 after
# the stem and its pool), as the block-site resnet18 of the benchmark
# launches them at batch 128: row 10I
RESNET18_IMAGENET_SITES = [(56, 64, 128), (28, 128, 256), (14, 256, 512)]
RESNET_P3 = ((1, 1), (1, 1))
# (kernel size, padding, epilogue activation) of a site's convs: vgg11's
# 3x3 SAME conv with relu; resnet18's convbn1 with relu and its downsample
# with none
VGG_CONVS = {"3x3": (3, "SAME", "relu")}
RESNET_CONVS = {"3x3": (3, RESNET_P3, "relu"), "1x1": (1, "SAME", None)}
# resnet50's block sites at ImageNet shapes (``stem="imagenet"``), as the
# bf16 model launches them at batch 128: (H = W of the input, C, F, stride,
# activation, whether x carries the sample axis). The first block of
# stages 2-4: its 1x1 convbn1 (stride 1, relu) and its 1x1 downsample
# (stride 2, no activation) read one masked input; stage 2's is the
# samples launch, stages 3 and 4 take an x that carries S (_xs)
RESNET50_SITE_CONVS = [
    (56, 256, 128, 1, "relu", False), (56, 256, 512, 2, None, False),
    (28, 512, 256, 1, "relu", True), (28, 512, 1024, 2, None, True),
    (14, 1024, 512, 1, "relu", True), (14, 1024, 2048, 2, None, True)]
# the epilogues of the resnet50 block-site model's 47 convs that cuDNN
# runs, at batch 128 and S = 10 (stages 2-4 on 1,280 rows): (rows, H = W,
# C, activation, whether the residual joins, convs of a forward at the
# shape). The stem; stage 1's convbn1 and convbn2, its convbn3, the first
# block's downsample; then in stages 2-4 the relu convs (all but the first
# block's masked convbn1) and the blocks' last convs
RESNET50_EPILOGUES = [
    (128, 112, 64, "relu", False, 1), (128, 56, 64, "relu", False, 6),
    (128, 56, 256, None, True, 3), (128, 56, 256, None, False, 1),
    (1280, 28, 128, "relu", False, 7), (1280, 28, 512, None, True, 4),
    (1280, 14, 256, "relu", False, 11), (1280, 14, 1024, None, True, 6),
    (1280, 7, 512, "relu", False, 5), (1280, 7, 2048, None, True, 3)]
# every geometry at which the int8 models' deterministic convs run
# conv_int8_fused on the card, at batch 128: (H = W, C, F, kernel, stride,
# padding). resnet18_me's blocks (3x3 at stride 1 and 2, the 1x1 stride-2
# projection) and exit cascades (3x3 at stride 2); vgg11_me's backbone
# from block 2 on (SAME) and its exit cascades (stride 2)
INT8_MODEL_CONVS = {
    "resnet18_me": [
        (32, 64, 64, 3, 1, RESNET_P3), (16, 128, 128, 3, 1, RESNET_P3),
        (8, 256, 256, 3, 1, RESNET_P3), (4, 512, 512, 3, 1, RESNET_P3),
        (32, 64, 128, 3, 2, RESNET_P3), (16, 128, 256, 3, 2, RESNET_P3),
        (8, 256, 512, 3, 2, RESNET_P3), (32, 64, 128, 1, 2, "SAME"),
        (16, 128, 256, 1, 2, "SAME"), (8, 256, 512, 1, 2, "SAME")],
    "vgg11_me": [
        (8, 128, 256, 3, 1, "SAME"), (8, 256, 256, 3, 1, "SAME"),
        (4, 256, 512, 3, 1, "SAME"), (4, 512, 512, 3, 1, "SAME"),
        (2, 512, 512, 3, 1, "SAME"), (8, 128, 256, 3, 2, RESNET_P3),
        (4, 256, 512, 3, 2, RESNET_P3)]}
# the site whose time the kernels line reports: the first at which the main
# path launches the kernel (on the int8 model block 1's site runs the float
# kernel, so the int8 single kernels start at block 2; the _xs launches,
# whose x carries the sample axis, start at block 2 too)
CONV_SUMMARY_SITE = {"dropout_conv_int8": 1, "bank_conv_int8": 1,
                     "dropout_conv_xs": 1, "dropout_conv_int8_xs": 1,
                     "bank_conv_xs": 1, "bank_conv_int8_xs": 1}
# the kernels redesigned for the tensor cores, whose registers, spills and
# SASS tensor-core instructions the build phase reports (the int8 template
# once for each mask policy and K split: rows 5 and 6 at split 1, rows 4
# and 7 at 4; the conv template once for each type of x, staged type and
# mask policy: the bank convs' three, bf16 and f32 x as tf32 and int8, and
# row 10's eight, HashMask and NoMask each in bf16, int8 and on the f32
# route with bf16 and f32 x; the 1x1 routine's and the window routine's
# one each, counted apart)
MMA_KERNELS = ("conv_mma_kernel", "int8_samples_mma_kernel")
# kernels redesigned on the CUDA cores, whose registers and spills the
# build phase reports beside them (the chain template once for each
# staging policy: rows 2 and 3 share one kernel and its chain, and so do
# rows 8 and 9; row 1 once for each type of x; the one-pass bf16 epilogue
# once for each of bias, relu and residual)
FMA_KERNELS = ("chain_samples_kernel", "dropout_apply_kernel",
               "bf16_epilogue_kernel")
# every kernel of bayestpu_torch/csrc, as the profiler names it
PORT_KERNELS = ("dropout_apply_kernel", "chain_samples_kernel",
                "int8_samples_mma_kernel", "::conv_mma_kernel<",
                "::conv_mma_kernel_1x1<", "bf16_epilogue_kernel")
# ragged geometries: x NHWC, kernel size, F (not a multiple of 8), padding,
# stride. SAME at stride 2 is asymmetric (16 -> 8 pads (0, 1)).
CONV_RAGGED = {"same_s2": ((3, 15, 16, 40), 3, 20, "SAME", 2),
               "valid": ((2, 9, 7, 33), 3, 13, "VALID", 1),
               "explicit_s2": ((2, 9, 7, 35), 3, 11, ((2, 1), (0, 2)), 2),
               "1x1_s2": ((3, 6, 6, 36), 1, 10, "SAME", 2)}
CONV_S = 3                                  # samples of the checks
CONV_RAGGED_IDXS = [2, -1, 5]               # bank indices: wrap, negative
# the conv kernels' f32 sums against cuDNN's (TF32 off), relative to
# max|ref|: the products are exact on both sides (to about 2^-22 of each
# in the float bank kernels, three TF32 products), the sums run in other
# orders over up to 9 * 512 = 4,608 terms, 9x the head's K, and a sum's
# rounding error grows as the square root of its length: 3x KERNEL_RTOL
CONV_RTOL = 3 * KERNEL_RTOL
# the f32 MC conv's mask readout value (the f32 scale times 1) against the
# scale: three TF32 products keep about 22 bits of an f32 product
READOUT_F32_RTOL = 2.0 ** -22
# a bf16 store: an f32 value a few ulps off may round to the neighbouring
# bf16 value, one bf16 ulp (at most 2^-7 of the value)
BF16_OUT_RTOL = 2.0 ** -7
# the block-site vgg11: the MC fine-tune of the train phase's weights (SGD
# 0.9, cosine LR from BLOCK_LR, clip 10), then the Masksembles one
BLOCK_EPOCHS, BLOCK_MASK_EPOCHS, BLOCK_LR = 3, 2, 0.01
# the resnet phase: CIFAR-100 shapes; its short fine-tunes from seeded
# weights run RESNET_EPOCHS epochs over RESNET_BATCHES batches of synthetic
# CIFAR-100 (SGD 0.9, cosine LR from RESNET_LR, clip 10)
RESNET_CLASSES = 100
RESNET_BATCHES, RESNET_EPOCHS, RESNET_LR = 4, 3, 0.05
# the lenet phase: lenet_me at the JAX bench's batch, trained LENET_EPOCHS
# epochs; the materialized routes at batch LENET_SMALL; the threefry masks
# checked at lenet's site-0 shape (N, H, W, C) with SAMPLES keys
LENET_BATCH, LENET_EPOCHS, LENET_SMALL = 256, 3, 8
THREEFRY_SITE = (256, 14, 14, 20)
# the convert phase: vgg19_me on CIFAR-100 shapes (bf16, batch BATCH, S =
# SAMPLES); the converter sweep of cli/sweep.py (lenet_specs on MNIST
# shapes, fused, batch 32, S = 4, n = 1-4 sites, DEFAULT strategy:
# sweep.py:70-76,105-113); AlexNet at its published widths (224x224x3,
# 1000 classes, f32 as the sweep's Sequential runs, batch 32, S =
# SAMPLES, n = 3 and 4), its card-vs-CPU check on ALEX_CPU_ROWS rows
SWEEP_BATCH, SWEEP_SAMPLES, SWEEP_N = 32, 4, (1, 2, 3, 4)
ALEX_SHAPE, ALEX_CLASSES, ALEX_BATCH, ALEX_CPU_ROWS = (224, 224, 3), 1000, \
    32, 2
# AlexNet's fused sites at batch 32: fc6 (row 3, x 32x6400 shared by the
# samples), fc7 (row 3x, x (S, 32, 4096)) and, at n = 4, conv5 (row 10's
# f32 samples launch, three TF32 products: 12x12x384 -> 256, 3x3 SAME, the
# conv bias, no activation, f32 out): (H = W, C, F)
ALEX_FC6 = dict(M=ALEX_BATCH, K=6400, N=4096, S=SAMPLES)
ALEX_FC7 = dict(M=ALEX_BATCH, K=4096, N=4096, S=SAMPLES)
ALEX_CONV5 = (12, 384, 256)
# the sweep's fused head, lenet_specs' fc (x 32x80, w 80x100): row 3 at n =
# 2, row 3x at n = 3 and 4, row 2 in their temporal predicts, rows 8 and 9
# at the Masksembles point (S = NUM_MASKS there)
SWEEP_FC1 = dict(M=SWEEP_BATCH, K=80, N=100, S=SWEEP_SAMPLES)
# the convert phase's f32 heads, each held against its plain version in
# the kernels phase in f32 (its models' one dtype), and the kernels timed
# there (AlexNet's launch at each; the lenet_specs head is checked, not
# timed)
CONVERT_SHAPES = (("sweep_fc1", SWEEP_FC1), ("alexnet_fc6", ALEX_FC6),
                  ("alexnet_fc7", ALEX_FC7))
F32_TIMED = {"alexnet_fc6": ("dropout_matmul_samples",),
             "alexnet_fc7": ("dropout_matmul_xs",)}
# card vs CPU for the f32 models of the convert phase (TF32 off on both):
# cuBLAS/cuDNN and oneDNN/MKL sum in other orders, a few ulps a layer that
# compound over depth, relative to max|logit|. Measured on an NVIDIA H100
# 80GB HBM3 at 700 W: at most 2.1e-6 (AlexNet, 8 layers), 7.2e-7 (the
# lenet_specs sweep), 8.9e-8 absolute on the wrappers' probabilities; the
# limit is CONV_RTOL, over 10x the largest. A bf16 or TF32 route would miss
# it by orders of magnitude (bf16's unit roundoff is 2^-8).
F32_CPU_RTOL = CONV_RTOL
# calls a timing window of row 10 at conv5 (12.7 ms each on the CUDA cores
# on an NVIDIA H100 80GB HBM3 at 700 W, before the f32 route moved to the
# tensor cores), and the least
# seconds of a ``benchmark`` window in the convert phase (with the
# engine's default, 0.3 s, the phase ran 72 s on that card)
CONV5_CALLS, COMPILED_WINDOW_S = 100, 0.1
# row 10's f32 route before it moved to the tensor cores (the CUDA-core
# conv_kernel; NVIDIA H100 80GB HBM3, 700 W, PERF.md's table): 10g at
# block site 1 and 10A at conv5
EARLIER_MS = {"site1": 0.446, "alexnet_conv5": 12.70}
# the 7x7 window at stride 2 (x NHWC, F): its 8x8 tile's 21x21 patch is
# past the 384 rows a block stages, so make_mma_geom takes a smaller tile
CONV_WINDOW7 = ((8, 32, 32, 64), 64)
# the shapes at which rows 2-5 are held against their plain versions: the
# vgg11_me head, a ragged one, the resnet18_me and lenet heads, and the
# lenet heads at batch LENET_SMALL, where the materialized lenet route
# launches them (the whole of x inside one partial row tile)
MATMUL_SHAPES = (("head", HEAD), ("ragged", RAGGED),
                 ("resnet_head", RESNET_HEAD), ("lenet_head", LENET_HEAD),
                 ("lenet_fc1", LENET_FC1),
                 ("lenet_small_head", {**LENET_HEAD, "M": LENET_SMALL}),
                 ("lenet_small_fc1", {**LENET_FC1, "M": LENET_SMALL}))


# row0 (one rank's rows of a data-sharded batch): rows [ROW0, ROW0 +
# ROW0_ROWS) of the head shape's 128, off every tile edge of the heads (8
# and 16 rows); ROW0_WRAP, a row0 whose rows run past 2^32 and wrap
ROW0, ROW0_ROWS, ROW0_WRAP = 40, 56, 2 ** 32 - 24
# images [ROW0_IMAGE, ROW0_IMAGE + ROW0_IMAGES) of a conv batch of
# ROW0_BATCH, at row0 = b0·H·W
ROW0_BATCH, ROW0_IMAGE, ROW0_IMAGES = 8, 3, 4


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def launch_counts() -> dict:
    """The launch counters of every kernel wrapper: matmul, conv and the
    one-pass bf16 epilogue."""
    from bayestpu_torch.kernels import epilogue as ep
    from bayestpu_torch.kernels import masked_conv as mc
    from bayestpu_torch.kernels import masked_matmul as mm
    return {**mm.launch_counts, **mc.launch_counts, **ep.launch_counts}


def reset_counts() -> None:
    from bayestpu_torch.kernels import epilogue as ep
    from bayestpu_torch.kernels import masked_conv as mc
    from bayestpu_torch.kernels import masked_matmul as mm
    mm.reset_launch_counts()
    mc.reset_launch_counts()
    ep.reset_launch_counts()


def counts(**nonzero: int) -> dict:
    """Every kernel's launch count: those named, 0 for the others."""
    names = launch_counts()
    unknown = set(nonzero) - set(names)
    check(not unknown, f"no such kernel {unknown}")
    return {name: nonzero.get(name, 0) for name in names}


def cuda_ms(fn, iters: int, windows: int = 5) -> float:
    """Median over ``windows`` of the CUDA-event time of ``iters`` calls,
    per call, after a warm-up."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        per.append(a.elapsed_time(b) / iters)
    return statistics.median(per)


def device_ms(fn, iters: int, windows: int = 3, seen: list | None = None
              ) -> float:
    """Device time per call of ``fn``: the summed time of the CUDA kernels
    it launches, from torch.profiler over ``iters`` calls after a warm-up.
    Unlike ``cuda_ms`` it does not count the host's dispatch between
    launches. A port wrapper launches one kernel of PORT_KERNELS a call;
    its time is the window's over the calls whose port kernel the
    profiler recorded: on the H100 it misses the first few launches of a
    window as a rule (1-3 of 200, the same number window after window),
    now and then a quarter (which, divided by all the calls, read 25-30%
    low) or all of them. A window that records fewer than half of the
    calls' port kernels is reported and taken again, up to ``windows`` in
    all. A library or plain call is timed over ``iters``. ``seen``, if
    given, gets the number of calls the time is over."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for window in range(windows):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = device_events(prof)
        us = sum(ev.self_device_time_total for ev in evs)
        records = sum(ev.count for ev in evs
                      if any(k in ev.key for k in PORT_KERNELS))
        calls = records or iters
        if us > 0 and 2 * calls >= iters:
            if seen is not None:
                seen.append(calls)
            return us / calls / 1e3
        emit({"phase": "profiler", "window": window + 1, "iters": iters,
              "records": records})
    check(False, f"the profiler lost device records in {windows} windows")


def _rounds(fns: dict, rounds: int, iters: int = 200) -> dict:
    """``device_ms`` of each of ``fns`` (key -> fn) taken ``rounds`` times,
    the functions in turn in every round, so that what drifts over a call
    falls on all of them alike: ``key`` is the median, ``key_rounds`` the
    readings in order (their spread is what a ratio of two of them can
    claim) and ``key_calls`` the calls each reading is over. A window of
    100 calls of a head kernel lost every record on the H100, three windows
    running: ``iters`` stays 200."""
    got = {key: ([], []) for key in fns}
    for _ in range(rounds):
        for key, fn in fns.items():
            got[key][0].append(device_ms(fn, iters, seen=got[key][1]))
    out = {}
    for key, (readings, calls) in got.items():
        out.update({key: statistics.median(readings),
                    f"{key}_rounds": readings, f"{key}_calls": calls})
    return out


def host_ms(fn, reps: int) -> float:
    """Median host-clock time of ``fn`` ending in a synchronise."""
    import torch
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(ts)


def phase_card() -> str:
    import numpy as np
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    emit({"phase": "card", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "numpy": np.__version__})
    return smi


def _mma_report(rep: dict) -> dict:
    """For each redesigned kernel (MMA_KERNELS and FMA_KERNELS), by mangled
    name: its registers and spill bytes from ``-Xptxas -v``, and the
    tensor-core instructions (HMMA, IMMA, HGMMA, IGMMA) that ``cuobjdump
    -sass`` of the built library shows in it, where ``cuobjdump`` is on the
    machine."""
    import re
    import shutil
    from bayestpu_torch.kernels import _build
    fns: dict[str, dict] = {}
    for log in rep["ptxas"].values():
        cur = None
        for ln in log.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?(\w+)'?", ln)
            if m:
                cur = m.group(1)
                continue
            if cur is None or not any(k in cur for k in
                                      MMA_KERNELS + FMA_KERNELS):
                continue
            d = fns.setdefault(cur, {})
            m = re.search(r"Used (\d+) registers", ln)
            if m:
                d["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", ln)
            if m:
                (d["stack_frame"], d["spill_stores"],
                 d["spill_loads"]) = map(int, m.groups())
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass_seen = False
    for name in _build.sources():
        try:
            sass = subprocess.run([tool, "-sass", str(_build._lib_path(name))],
                                  capture_output=True, text=True, check=True,
                                  timeout=120).stdout
        except (OSError, subprocess.SubprocessError):
            continue
        sass_seen = True
        for part in sass.split("Function : ")[1:]:
            fn = part.split(None, 1)[0]
            if not any(k in fn for k in MMA_KERNELS + FMA_KERNELS):
                continue
            fns.setdefault(fn, {})["sass_tensor_core_ops"] = {
                op: len(re.findall(rf"\b{op}\b", part))
                for op in ("HMMA", "IMMA", "HGMMA", "IGMMA")}
    return {"cuobjdump": sass_seen, "kernels": dict(sorted(fns.items()))}


def phase_build() -> None:
    import re
    from bayestpu_torch.kernels import _build
    rep = _build.build_all()
    # the ptxas report comes only from this build: a library that an earlier
    # process built (the card tests, a benchmark run) leaves it without one
    check(rep["built"] == sorted(_build.sources()),
          f"libraries built before this run, so ptxas reports none for them: "
          f"{sorted(set(_build.sources()) - set(rep['built']))}; remove "
          f"{_build.BUILD_DIR} and run chip_smoke.py first")
    regs = {name: [ln.strip() for ln in log.splitlines()
                   if "registers" in ln or "spill" in ln]
            for name, log in rep["ptxas"].items()}
    emit({"phase": "build", "seconds": rep["seconds"], "built": rep["built"],
          "ptxas": regs})
    report = _mma_report(rep)
    emit({"phase": "tensor_cores", **report})
    for k in MMA_KERNELS + FMA_KERNELS:
        check(any(k in name for name in report["kernels"]),
              f"{k}: not in the ptxas report")
    for name, d in report["kernels"].items():
        ops = d.get("sass_tensor_core_ops")
        check(ops is None or sum(ops.values()) > 0
              or not any(k in name for k in MMA_KERNELS),
              f"{name}: no tensor-core instruction in its SASS")
        check("spill_stores" in d and "spill_loads" in d,
              f"{name}: ptxas gave no spill counts ({d})")
        check(d.get("spill_stores") == 0 and d.get("spill_loads") == 0,
              f"{name}: spills registers ({d})")
    # the bank convs' three instantiations of the conv routine: bf16 and
    # f32 x on the tf32 tensor cores (HMMA), int8 on the s8 ones (IMMA)
    bank = {n: d for n, d in report["kernels"].items()
            if "conv_mma_kernel" in n and "BankMask" in n}
    check(len(bank) == 3 and all(d.get("stack_frame") == 0
                                 for d in bank.values()),
          f"bank conv_mma_kernel instantiations {bank}")
    # row 10's eight (HashMask and NoMask: bf16, int8, and the f32 route
    # with f32 x and with bf16 x), the f32 route's six with the bank's two
    # (mangled <float, float, ...> and <__nv_bfloat16, float, ...>); the
    # 1x1 routine's one (HashMask), on wgmma (HGMMA); and the window
    # routine's one (window::conv_mma_kernel<HashMask>, mangled in the
    # namespace "window"), on wgmma, with no stack frame
    window = {n: d for n, d in report["kernels"].items()
              if "window15conv_mma_kernelI" in n}
    mc = {n: d for n, d in report["kernels"].items()
          if "conv_mma_kernelI" in n and "BankMask" not in n
          and n not in window}
    pointwise = {n: d for n, d in report["kernels"].items()
                 if "conv_mma_kernel_1x1" in n}
    check(len(pointwise) == 1, f"conv_mma_kernel_1x1 instantiations "
          f"{sorted(pointwise)}")
    check(len(window) == 1 and all(d.get("stack_frame") == 0
                                   for d in window.values()),
          f"window::conv_mma_kernel instantiations {window}")
    f32_route = sorted(n for n in report["kernels"] if re.search(
        r"conv_mma_kernelI(?:f|[0-9]+__nv_bfloat16)f", n))
    emit({"phase": "conv_f32_route", "kernels": {
        n: {k: report["kernels"][n].get(k) for k in (
            "registers", "stack_frame", "spill_stores", "spill_loads",
            "sass_tensor_core_ops")} for n in f32_route}})
    check(len(mc) == 8 and len(f32_route) == 6
          and all(d.get("stack_frame") == 0 for d in mc.values()),
          f"MC conv_mma_kernel instantiations {sorted(mc)}, f32 route "
          f"{f32_route}")
    if report["cuobjdump"]:
        def kind(d):
            ops = d["sass_tensor_core_ops"]
            return "IMMA" if ops["IMMA"] else "HMMA" if ops["HMMA"] else \
                "none"
        kinds = sorted(kind(d) for d in bank.values())
        check(kinds == ["HMMA", "HMMA", "IMMA"],
              f"bank conv_mma_kernel tensor-core instructions {kinds}")
        kinds = sorted(kind(d) for d in mc.values())
        check(kinds == ["HMMA"] * 6 + ["IMMA"] * 2,
              f"MC conv_mma_kernel tensor-core instructions {kinds}")
        check(all(d["sass_tensor_core_ops"]["HGMMA"] > 0
                  for d in pointwise.values()),
              f"conv_mma_kernel_1x1 without HGMMA: {pointwise}")
        check(all(d["sass_tensor_core_ops"]["HGMMA"] > 0
                  and d["sass_tensor_core_ops"]["HMMA"] == 0
                  for d in window.values()),
              f"window::conv_mma_kernel not on HGMMA alone: {window}")


def _inputs(shape: dict, dtype, gen):
    import torch
    m, k, n, s = shape["M"], shape["K"], shape["N"], shape["S"]
    x = torch.randn(m, k, generator=gen).to(dtype).cuda()
    w = (torch.randn(k, n, generator=gen) / k ** 0.5).to(dtype).cuda()
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (s, 2), generator=gen,
                          dtype=torch.int64).to(torch.int32)
    seeds[0] = torch.tensor([-123456789, -7], dtype=torch.int32)  # negative
    return x, w, seeds.cuda()


def _bound(name: str, shape: dict, dtype) -> tuple[float, str]:
    """Least time for the kernel's work on an H100: each input byte read
    once and each output byte written once over the HBM rate, or the
    operations over the peak for their type, whichever is larger. The
    matmuls do 2·S·M·N·K operations in the dtype (int8 for the int8 rows),
    an _xs launch reading S·M·K elements of x; dropout_apply reads x and
    the seeds, writes (M, K) f32 and does M·K f32 multiplies."""
    m, k, n = shape["M"], shape["K"], shape["N"]
    esize = {"bfloat16": 2, "float32": 4, "int8": 1}[
        str(dtype).split(".")[-1]]
    if name == "dropout_apply":
        t_bytes = (esize * m * k + 4 * 2 + 4 * m * k) / MEM_BYTES_PER_S
        t_ops = m * k / PEAK_FLOPS["float32"]
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                           else "operations")
    s = shape["S"] if name.endswith(("_samples", "_xs")) else 1
    xs = s if name.endswith("_xs") else 1
    nbytes = esize * (xs * m * k + k * n) + 4 * 2 * s + 4 * s * m * n
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = 2 * s * m * n * k / PEAK_FLOPS[str(dtype).split(".")[-1]]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _bank_bound(name: str, shape: dict, esize: int, rows: int
                ) -> tuple[float, str]:
    """The bank kernels read x (esize bytes an element; S·M·K of them in an
    _xs launch), w (f32, or int8 for the int8 rows), the ``rows`` distinct
    f32 bank rows this run's indices need and, in a samples kernel, S int32
    indices; they write S·M·N f32.
    Their 2·S·M·N·K operations are f32 for the float rows (the product of
    x and the bank's value is f32, which TF32 would round: the 67 TFLOP/s
    outside the tensor cores) and int8 for the int8 rows."""
    m, k, n = shape["M"], shape["K"], shape["N"]
    samples = name.endswith(("_samples", "_xs"))
    s = shape["S"] if samples else 1
    int8 = "int8" in name
    xs = s if name.endswith("_xs") else 1
    nbytes = (esize * xs * m * k + (1 if int8 else 4) * k * n + 4 * k * rows
              + (4 * s if samples else 0) + 4 * s * m * n)
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = 2 * s * m * n * k / PEAK_FLOPS["int8" if int8 else "float32"]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _check_bank(mm, shape: dict, label: str, gen, summary: dict) -> None:
    """The bank kernels (rows 6-9) on the card against their plain
    versions: the float rows with x in bf16 and f32, on the generated
    {0, 1} bank and on one with 2.0 and 0.25 entries (the float kernels
    multiply by the value, the int8 ones keep where it exceeds 0.5), to
    KERNEL_RTOL of max|ref|; the int8 rows bit for bit; sample s of each
    samples kernel bit-equal to its single
    kernel at idxs[s]; both heads on an x (S, M, K) that carries the
    sample axis (one ``bank_matmul_xs`` or ``bank_matmul_int8_xs`` launch)
    against the plain version and, sample s, bit-equal to the single launch
    on x[s] at idxs[s]; the int8 readout (ones @ eye) exactly out_scale
    where the row keeps. The indices are a model's, 0 … NUM_MASKS-1, at S
    = NUM_MASKS, else MASK_RAGGED_IDXS (which wrap and include a negative
    one). At the head shape, their times."""
    import torch
    from bayestpu_torch.kernels.mask_bank import generation_wrapper
    m, k, n, s = shape["M"], shape["K"], shape["N"], shape["S"]
    idx_list = list(range(s)) if s == NUM_MASKS else MASK_RAGGED_IDXS
    idxs = torch.tensor(idx_list, dtype=torch.int32, device="cuda")
    _, bank = generation_wrapper(k, NUM_MASKS, MASK_SCALE, rng=0)
    bank = torch.from_numpy(bank).cuda().contiguous()   # numpy's is F-order
    odd = bank.clone()
    odd[0, ::7] = 2.0
    odd[1, 1::5] = 0.25
    xs_, ws_ = 2.0 ** -7, 2.0 ** -7
    line = {"phase": "kernels", "shape": label, **shape, "idxs": idx_list,
            "num_masks": NUM_MASKS}
    same_per_sample = True
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(m, k, generator=gen).to(dtype).cuda()
        w = (torch.randn(k, n, generator=gen) / k ** 0.5).cuda()
        x3 = torch.randn(s, m, k, generator=gen).to(dtype).cuda()
        for bname, b in (("bank", bank), ("bank_with_2.0", odd)):
            ys = mm.bank_matmul_samples(x, w, b, idxs)
            singles = [mm.bank_matmul(x, w, b, i) for i in idx_list]
            yx = mm.bank_matmul_inference(x3, w, b, idxs)
            singles_x = [mm.bank_matmul(x3[i], w, b, idx_list[i])
                         for i in range(s)]
            torch.cuda.synchronize()
            rs = mm.bank_matmul_samples_plain(x, w, b, idxs)
            rx = torch.stack([mm.bank_matmul_plain(x3[i], w, b, idx_list[i])
                              for i in range(s)])
            for name, got, want in (
                    ("bank_matmul_samples", ys, rs),
                    ("bank_matmul", torch.stack(singles), rs),
                    ("bank_matmul_xs", yx, rx)):
                err = (got - want).abs().max().item()
                tol = KERNEL_RTOL * max(1.0, want.abs().max().item())
                check(err <= tol, f"{name} {label} {dtype} {bname}: {err} > "
                      f"{tol}")
                summary[name]["max_abs_err"] = max(
                    summary[name]["max_abs_err"], err)
                line[f"{name}_{str(dtype).split('.')[-1]}_{bname}_err"] = err
            same_per_sample &= all(torch.equal(ys[i], singles[i])
                                   for i in range(s))
            same_per_sample &= all(torch.equal(yx[i], singles_x[i])
                                   for i in range(s))
    xq = torch.randint(-128, 128, (m, k), generator=gen,
                       dtype=torch.int8).cuda()
    wq = torch.randint(-128, 128, (k, n), generator=gen,
                       dtype=torch.int8).cuda()
    xq3 = torch.randint(-128, 128, (s, m, k), generator=gen,
                        dtype=torch.int8).cuda()
    int8_equal = True
    for b in (bank, odd):
        for i in idx_list:   # row 7 against its own plain version
            int8_equal &= torch.equal(
                mm.bank_matmul_int8(xq, wq, b, i, xs_, ws_),
                mm.bank_matmul_int8_plain(xq, wq, b, i, xs_, ws_))
        ys = mm.bank_matmul_int8_samples(xq, wq, b, idxs, xs_, ws_)
        singles = [mm.bank_matmul_int8(xq, wq, b, i, xs_, ws_)
                   for i in idx_list]
        yx = mm.bank_matmul_int8_inference(xq3, wq, b, idxs, xs_, ws_)
        singles_x = [mm.bank_matmul_int8(xq3[i], wq, b, idx_list[i], xs_, ws_)
                     for i in range(s)]
        torch.cuda.synchronize()
        rs = mm.bank_matmul_int8_samples_plain(xq, wq, b, idxs, xs_, ws_)
        rx = torch.stack([mm.bank_matmul_int8_plain(
            xq3[i], wq, b, idx_list[i], xs_, ws_) for i in range(s)])
        for name, got, want in (
                ("bank_matmul_int8_samples", ys, rs),
                ("bank_matmul_int8", torch.stack(singles), rs),
                ("bank_matmul_int8_xs", yx, rx)):
            summary[name]["max_abs_err"] = max(
                summary[name]["max_abs_err"],
                (got - want).abs().max().item())
            int8_equal &= torch.equal(got, want)
        same_per_sample &= all(torch.equal(ys[i], singles[i])
                               for i in range(s))
        same_per_sample &= all(torch.equal(yx[i], singles_x[i])
                               for i in range(s))
    ones = torch.ones(m, k, dtype=torch.int8, device="cuda")
    eye = torch.eye(k, dtype=torch.int8, device="cuda")
    readout = mm.bank_matmul_int8_samples(ones, eye, odd, idxs, xs_, ws_)
    rows = torch.remainder(idxs, NUM_MASKS).long()
    want = torch.where(odd[rows] > 0.5, mm.bank_out_scale(xs_, ws_), 0.0)
    exact = torch.equal(readout, want[:, None, :].expand(s, m, k))
    check(int8_equal and same_per_sample and exact,
          f"bank kernels {label}: int8 bit-equal {int8_equal}, per sample "
          f"{same_per_sample}, int8 readout {exact}")
    line.update({"int8_bit_equal_plain": int8_equal,
                 "samples_equal_single_bitwise": same_per_sample,
                 "int8_readout_exact": exact,
                 "out_scale": mm.bank_out_scale(xs_, ws_)})
    if label == "head":
        _time_bank(mm, shape, idxs, bank, xq, wq, xq3, gen, line, summary)
    emit(line)


def _time_bank(mm, shape, idxs, bank, xq, wq, xq3, gen, line, summary
               ) -> None:
    """Times of the bank kernels at the Masksembles head shape: bf16 x (the
    main path's dtype) for the float rows, int8 for the int8 rows, and row
    8 also with f32 x (``bank_matmul_samples_float32``, in the line only:
    one of the five row-8 launches of a vgg11_me spatial predict takes f32
    x). ``ms`` counts every kernel the wrapper launches, as for rows 1-5;
    that is the bank kernel alone, which takes the index remainder itself.
    The library call is one PyTorch product on a pre-masked x that the
    port never calls: ``torch.matmul`` of the (S, M, K) masked f32 x, or
    ``torch._int_mm`` with N padded to 16 (for the _xs launches, of the
    masked x3 that carries S samples). Each kernel and its library call
    are timed in TIMING_ROUNDS alternating rounds (``_rounds``): ``ms``
    and ``library_ms`` are the medians, their readings listed beside
    them."""
    import torch
    m, k, n, s = shape["M"], shape["K"], shape["N"], shape["S"]
    xs_ = ws_ = 2.0 ** -7
    x = torch.randn(m, k, generator=gen).to(torch.bfloat16).cuda()
    w = (torch.randn(k, n, generator=gen) / k ** 0.5).cuda()
    x3 = torch.randn(s, m, k, generator=gen).to(torch.bfloat16).cuda()
    xf = torch.randn(m, k, generator=gen).cuda()
    rows = bank[idxs.long()]
    xm = x.float()[None] * rows[:, None, :]
    xmf = xf[None] * rows[:, None, :]
    xm3 = x3.float() * rows[:, None, :]
    xm8 = torch.where(rows[:, None, :] > 0.5, xq[None],
                      torch.zeros((), dtype=torch.int8, device="cuda"))
    xm83 = torch.where(rows[:, None, :] > 0.5, xq3,
                       torch.zeros((), dtype=torch.int8, device="cuda"))
    idx_list = idxs.tolist()
    wpad = torch.nn.functional.pad(wq, (0, (-n) % 8)).t().contiguous().t()
    timings = {
        "bank_matmul": (
            lambda: mm.bank_matmul(x, w, bank, 0),
            lambda: mm.bank_matmul_plain(x, w, bank, 0),
            lambda: torch.matmul(xm[0], w), torch.bfloat16, 1),
        "bank_matmul_samples": (
            lambda: mm.bank_matmul_samples(x, w, bank, idxs),
            lambda: mm.bank_matmul_samples_plain(x, w, bank, idxs),
            lambda: torch.matmul(xm, w), torch.bfloat16, s),
        "bank_matmul_samples_float32": (
            lambda: mm.bank_matmul_samples(xf, w, bank, idxs),
            lambda: mm.bank_matmul_samples_plain(xf, w, bank, idxs),
            lambda: torch.matmul(xmf, w), torch.float32, s),
        "bank_matmul_xs": (
            lambda: mm.bank_matmul_inference(x3, w, bank, idxs),
            lambda: torch.stack([mm.bank_matmul_plain(
                x3[i], w, bank, idx_list[i]) for i in range(s)]),
            lambda: torch.matmul(xm3, w), torch.bfloat16, s),
        "bank_matmul_int8": (
            lambda: mm.bank_matmul_int8(xq, wq, bank, 0, xs_, ws_),
            lambda: mm.bank_matmul_int8_plain(xq, wq, bank, 0, xs_, ws_),
            lambda: torch._int_mm(xm8[0], wpad), torch.int8, 1),
        "bank_matmul_int8_samples": (
            lambda: mm.bank_matmul_int8_samples(xq, wq, bank, idxs, xs_,
                                                ws_),
            lambda: mm.bank_matmul_int8_samples_plain(xq, wq, bank, idxs,
                                                      xs_, ws_),
            lambda: torch._int_mm(xm8.reshape(s * m, k), wpad), torch.int8,
            s),
        "bank_matmul_int8_xs": (
            lambda: mm.bank_matmul_int8_inference(xq3, wq, bank, idxs, xs_,
                                                  ws_),
            lambda: torch.stack([mm.bank_matmul_int8_plain(
                xq3[i], wq, bank, idx_list[i], xs_, ws_) for i in range(s)]),
            lambda: torch._int_mm(xm83.reshape(s * m, k), wpad), torch.int8,
            s),
    }
    for name, (kern, plain, lib, dtype, nrows) in timings.items():
        t = {**_rounds({"ms": kern, "library_ms": lib}, TIMING_ROUNDS),
             "plain_ms": device_ms(plain, 20),
             "events_ms": cuda_ms(kern, 200)}
        esize = {torch.bfloat16: 2, torch.int8: 1, torch.float32: 4}[dtype]
        t["bound_ms"], t["bound_by"] = _bank_bound(
            name.removesuffix("_float32"), shape, esize, nrows)
        line[name] = t
        if name in summary:
            summary[name].update(t)


def phase_kernels() -> dict:
    import torch
    from bayestpu_torch.kernels import masked_matmul as mm

    gen = torch.Generator().manual_seed(1234)
    summary = {name: {"max_abs_err": 0.0} for name in REPLACES}
    for dtype in (torch.bfloat16, torch.float32):
        # the convert phase's Sequential models run f32 alone
        for label, shape in MATMUL_SHAPES + (
                CONVERT_SHAPES if dtype == torch.float32 else ()):
            x, w, seeds = _inputs(shape, dtype, gen)
            line = {"phase": "kernels", "shape": label, **shape,
                    "dtype": str(dtype).split(".")[-1], "rate": RATE}
            # values against the plain versions on the same card tensors
            y1 = mm.dropout_matmul(x, w, seeds[0], RATE)
            r1 = mm.dropout_matmul_plain(x, w, seeds[0], RATE)
            ys = mm.dropout_matmul_samples(x, w, seeds, RATE)
            rs = mm.dropout_matmul_samples_plain(x, w, seeds, RATE)
            torch.cuda.synchronize()
            for name, y, r in (("dropout_matmul", y1, r1),
                               ("dropout_matmul_samples", ys, rs)):
                err = (y - r).abs().max().item()
                tol = KERNEL_RTOL * max(1.0, r.abs().max().item())
                check(err <= tol, f"{name} {label} {dtype}: {err} > {tol}")
                summary[name]["max_abs_err"] = max(
                    summary[name]["max_abs_err"], err)
                line[f"{name}_max_abs_err"] = err
                line[f"{name}_tol"] = tol
            # sample s of the samples kernel == single kernel with seeds[s]
            same = all(torch.equal(ys[s], mm.dropout_matmul(
                x, w, seeds[s].contiguous(), RATE))
                for s in range(shape["S"]))
            check(same, f"samples vs single bit identity {label} {dtype}")
            line["samples_equal_single_bitwise"] = same
            line["negative_seed_sample0"] = seeds[0].tolist()
            # x carrying the sample axis: one _xs launch, sample s of x3
            # under seeds[s] (on its own coordinates) equal to the plain
            # version and, bit for bit, to the single launch on x3[s]
            x3 = torch.randn(shape["S"], shape["M"], shape["K"],
                             generator=gen).to(dtype).cuda()
            yx = mm.dropout_matmul_inference(x3, w, seeds, RATE)
            torch.cuda.synchronize()
            rx = torch.stack([mm.dropout_matmul_plain(x3[s], w, seeds[s],
                                                      RATE)
                              for s in range(shape["S"])])
            err = (yx - rx).abs().max().item()
            tol = KERNEL_RTOL * max(1.0, rx.abs().max().item())
            check(err <= tol, f"dropout_matmul_xs {label} {dtype}: {err} > "
                  f"{tol}")
            summary["dropout_matmul_xs"]["max_abs_err"] = max(
                summary["dropout_matmul_xs"]["max_abs_err"], err)
            line["dropout_matmul_xs_max_abs_err"] = err
            same_xs = all(torch.equal(yx[s], mm.dropout_matmul(
                x3[s], w, seeds[s].contiguous(), RATE))
                for s in range(shape["S"]))
            check(same_xs, f"_xs vs single bit identity {label} {dtype}")
            line["xs_equal_single_bitwise"] = same_xs
            # exact mask readout: ones @ eye(K) gives 0 or the dtype's 1/keep
            ones = torch.ones(shape["M"], shape["K"], dtype=dtype,
                              device="cuda")
            eye = torch.eye(shape["K"], dtype=dtype, device="cuda")
            a1 = mm.dropout_matmul(ones, eye, seeds[0], RATE)
            as_ = mm.dropout_matmul_samples(ones, eye, seeds, RATE)
            ax = mm.dropout_matmul_inference(
                ones.expand(shape["S"], -1, -1).contiguous(), eye, seeds, RATE)
            exact = (torch.equal(a1, mm.dropout_matmul_plain(
                ones, eye, seeds[0], RATE)) and torch.equal(
                as_, mm.dropout_matmul_samples_plain(ones, eye, seeds, RATE))
                and torch.equal(ax, as_))
            vals = sorted(set(as_.unique().tolist()))
            check(exact and vals == [0.0, mm.scale_of(RATE, dtype)],
                  f"mask readout {label} {dtype}: exact={exact} values={vals}")
            line["readout_bit_exact"] = exact
            line["readout_keep_fraction"] = (as_ != 0).float().mean().item()
            _check_apply(mm, x, seeds, ones, a1, dtype, label, line, summary)
            if label == "head":
                _time_kernels(mm, x, x3, w, seeds, shape, dtype, line,
                              summary)
            elif label in HEAD_LABELS and dtype == torch.bfloat16:
                _time_kernels(mm, x, x3, w, seeds, shape, dtype, line, None,
                              SAMPLES_TIMED)
            elif label in F32_TIMED and dtype == torch.float32:
                _time_kernels(mm, x, x3, w, seeds, shape, dtype, line, None,
                              F32_TIMED[label])
            emit(line)
    for label, shape in ANALYSIS_SHAPES:
        x, w, seeds = _inputs(shape, torch.bfloat16, gen)
        ys = mm.dropout_matmul_samples(x, w, seeds, RATE)
        rs = mm.dropout_matmul_samples_plain(x, w, seeds, RATE)
        torch.cuda.synchronize()
        err = (ys - rs).abs().max().item()
        tol = KERNEL_RTOL * max(1.0, rs.abs().max().item())
        check(err <= tol, f"dropout_matmul_samples {label}: {err} > {tol}")
        summary["dropout_matmul_samples"]["max_abs_err"] = max(
            summary["dropout_matmul_samples"]["max_abs_err"], err)
        same = all(torch.equal(ys[s], mm.dropout_matmul(
            x, w, seeds[s].contiguous(), RATE)) for s in range(shape["S"]))
        check(same, f"samples vs single bit identity {label}")
        emit({"phase": "kernels", "shape": label, **shape,
              "dtype": "bfloat16", "rate": RATE,
              "dropout_matmul_samples_max_abs_err": err,
              "dropout_matmul_samples_tol": tol,
              "samples_equal_single_bitwise": same})
    for label, shape in MATMUL_SHAPES:
        _check_int8(mm, shape, label, gen, summary)
    for label, shape in (("head", MASK_HEAD), ("ragged", MASK_RAGGED),
                         ("odd_k", MASK_ODD_K),
                         ("resnet_head", {**RESNET_HEAD, "S": NUM_MASKS}),
                         ("lenet_head", {**LENET_HEAD, "S": NUM_MASKS}),
                         ("lenet_fc1", {**LENET_FC1,
                                        "S": len(MASK_RAGGED_IDXS)}),
                         ("sweep_fc1", {**SWEEP_FC1, "S": NUM_MASKS})):
        _check_bank(mm, shape, label, gen, summary)
    _apply_shapes(mm, gen)
    _row0_checks(mm, gen, summary)
    return summary


def _row0_checks(mm, gen, summary: dict) -> None:
    """Rows 1-5 (3x and 5x too) at ``row0`` > 0, as one rank of a
    data-sharded batch runs them: the mask readout (x of ones, w = eye) of
    rows [ROW0, ROW0 + ROW0_ROWS) of the head shape at row0 = ROW0
    bit-equal to those rows of the launch on the whole tensor, and on
    random x at row0 = ROW0 and ROW0_WRAP (rows past 2^32) against the
    plain versions at the same row0 (float to KERNEL_RTOL of max|ref|,
    int8 and ``dropout_apply`` bit for bit)."""
    import torch
    m_all, k, s = HEAD["M"], HEAD["K"], HEAD["S"]
    part = slice(ROW0, ROW0 + ROW0_ROWS)
    _, _, seeds = _inputs(HEAD, torch.float32, gen)
    s0 = seeds[0].contiguous()
    line = {"phase": "kernels", "check": "row0", **HEAD,
            "rows": [ROW0, ROW0 + ROW0_ROWS], "wrap_row0": ROW0_WRAP}
    for dtype in (torch.bfloat16, torch.float32, torch.int8):
        i8 = dtype == torch.int8
        ones = torch.ones(m_all, k, dtype=dtype, device="cuda")
        eye = torch.eye(k, dtype=dtype, device="cuda")
        ones3 = ones.expand(s, -1, -1).contiguous()
        steps = (2.0 ** -7, 2.0 ** -7)
        if i8:
            runs = {
                "dropout_matmul_int8": lambda x, r: mm.dropout_matmul_int8(
                    x, eye, s0, RATE, *steps, r),
                "dropout_matmul_int8_samples":
                    lambda x, r: mm.dropout_matmul_int8_samples(
                        x, eye, seeds, RATE, *steps, r),
                "dropout_matmul_int8_xs":
                    lambda x, r: mm.dropout_matmul_int8_inference(
                        x, eye, seeds, RATE, *steps, r)}
        else:
            runs = {
                "dropout_apply": lambda x, r: mm.dropout_apply(x, s0, RATE,
                                                               r),
                "dropout_matmul": lambda x, r: mm.dropout_matmul(
                    x, eye, s0, RATE, r),
                "dropout_matmul_samples": lambda x, r:
                    mm.dropout_matmul_samples(x, eye, seeds, RATE, r),
                "dropout_matmul_xs": lambda x, r:
                    mm.dropout_matmul_inference(x, eye, seeds, RATE, r)}
        same = {}
        for name, run in runs.items():
            xs = ones3 if name.endswith("_xs") else ones
            whole = run(xs, 0)
            got = run(xs[..., part, :].contiguous(), ROW0)
            same[name] = torch.equal(got, whole[..., part, :])
        check(all(same.values()), f"row0 readout {dtype}: {same}")
        # values on random x at row0 against the plain versions
        if i8:
            x = torch.randint(-128, 128, (ROW0_ROWS, k), generator=gen,
                              dtype=torch.int8).cuda()
            w = torch.randint(-128, 128, (k, HEAD["N"]), generator=gen,
                              dtype=torch.int8).cuda()
            x3 = torch.randint(-128, 128, (s, ROW0_ROWS, k), generator=gen,
                               dtype=torch.int8).cuda()
        else:
            x, w, _ = _inputs({**HEAD, "M": ROW0_ROWS}, dtype, gen)
            x3 = torch.randn(s, ROW0_ROWS, k, generator=gen).to(dtype).cuda()
        errs = {}
        for r0 in (ROW0, ROW0_WRAP):
            if i8:
                pairs = {
                    "dropout_matmul_int8": (
                        mm.dropout_matmul_int8(x, w, s0, RATE, *steps, r0),
                        mm.dropout_matmul_int8_plain(x, w, s0, RATE, *steps,
                                                     r0)),
                    "dropout_matmul_int8_samples": (
                        mm.dropout_matmul_int8_samples(x, w, seeds, RATE,
                                                       *steps, r0),
                        mm.dropout_matmul_int8_samples_plain(
                            x, w, seeds, RATE, *steps, r0)),
                    "dropout_matmul_int8_xs": (
                        mm.dropout_matmul_int8_inference(x3, w, seeds, RATE,
                                                         *steps, r0),
                        torch.stack([mm.dropout_matmul_int8_plain(
                            x3[i], w, seeds[i], RATE, *steps, r0)
                            for i in range(s)]))}
            else:
                pairs = {
                    "dropout_apply": (mm.dropout_apply(x, s0, RATE, r0),
                                      mm.dropout_apply_plain(x, s0, RATE,
                                                             r0)),
                    "dropout_matmul": (
                        mm.dropout_matmul(x, w, s0, RATE, r0),
                        mm.dropout_matmul_plain(x, w, s0, RATE, r0)),
                    "dropout_matmul_samples": (
                        mm.dropout_matmul_samples(x, w, seeds, RATE, r0),
                        mm.dropout_matmul_samples_plain(x, w, seeds, RATE,
                                                        r0)),
                    "dropout_matmul_xs": (
                        mm.dropout_matmul_inference(x3, w, seeds, RATE, r0),
                        torch.stack([mm.dropout_matmul_plain(
                            x3[i], w, seeds[i], RATE, r0)
                            for i in range(s)]))}
            for name, (got, want) in pairs.items():
                err = (got - want).abs().max().item()
                exact = i8 or name == "dropout_apply"
                tol = 0.0 if exact else KERNEL_RTOL * max(
                    1.0, want.abs().max().item())
                check(err <= tol, f"{name} at row0 {r0} {dtype}: {err} > "
                      f"{tol}")
                errs[f"{name}@{r0}"] = err
                summary[name]["max_abs_err"] = max(
                    summary[name]["max_abs_err"], err)
        line[str(dtype).split(".")[-1]] = {"readout_equal_whole": same,
                                           "max_abs_err_vs_plain": errs}
    emit(line)


def _check_int8(mm, shape: dict, label: str, gen, summary: dict) -> None:
    """The int8 kernels (rows 4 and 5) on the card: bit-equal to their plain
    versions (the int32 sums are exact, then one f32 multiply), sample s
    bit-equal to the single kernel with seeds[s], the first seed pair
    negative, the launch on an x (S, M, K) that carries the sample axis
    (one ``dropout_matmul_int8_xs``) bit-equal to the plain version and,
    sample s, to the single launch on x[s] with seeds[s], and the mask
    readout (x_q = ones, w_q = eye) nonzero exactly where the float
    kernel's is; at the head shape, their times (at the resnet18_me and
    lenet_me heads, row 5's)."""
    import torch
    m, k, n, s = shape["M"], shape["K"], shape["N"], shape["S"]
    xs = ws = 2.0 ** -7                          # the flagship's int8 steps
    xq = torch.randint(-128, 128, (m, k), generator=gen,
                       dtype=torch.int8).cuda()
    wq = torch.randint(-128, 128, (k, n), generator=gen,
                       dtype=torch.int8).cuda()
    xq3 = torch.randint(-128, 128, (s, m, k), generator=gen,
                        dtype=torch.int8).cuda()
    _, _, seeds = _inputs(shape, torch.float32, gen)
    s0 = seeds[0].contiguous()
    y1 = mm.dropout_matmul_int8(xq, wq, s0, RATE, xs, ws)
    ys = mm.dropout_matmul_int8_samples(xq, wq, seeds, RATE, xs, ws)
    yx = mm.dropout_matmul_int8_inference(xq3, wq, seeds, RATE, xs, ws)
    torch.cuda.synchronize()
    p1 = mm.dropout_matmul_int8_plain(xq, wq, s0, RATE, xs, ws)
    ps = mm.dropout_matmul_int8_samples_plain(xq, wq, seeds, RATE, xs, ws)
    px = torch.stack([mm.dropout_matmul_int8_plain(xq3[i], wq, seeds[i],
                                                   RATE, xs, ws)
                      for i in range(s)])
    same1, sames = torch.equal(y1, p1), torch.equal(ys, ps)
    samex = torch.equal(yx, px)
    for name, got, want in (("dropout_matmul_int8", y1, p1),
                            ("dropout_matmul_int8_samples", ys, ps),
                            ("dropout_matmul_int8_xs", yx, px)):
        summary[name]["max_abs_err"] = max(
            summary[name]["max_abs_err"], (got - want).abs().max().item())
    per_sample = all(torch.equal(ys[i], mm.dropout_matmul_int8(
        xq, wq, seeds[i].contiguous(), RATE, xs, ws)) for i in range(s))
    per_sample_x = all(torch.equal(yx[i], mm.dropout_matmul_int8(
        xq3[i], wq, seeds[i].contiguous(), RATE, xs, ws)) for i in range(s))
    check(same1 and sames and samex and per_sample and per_sample_x,
          f"int8 kernels {label}: single {same1}, samples {sames}, _xs "
          f"{samex}, per sample {per_sample}, _xs per sample "
          f"{per_sample_x}")
    ones = torch.ones(m, k, dtype=torch.int8, device="cuda")
    eye = torch.eye(k, dtype=torch.int8, device="cuda")
    r8 = mm.dropout_matmul_int8_samples(ones, eye, seeds, RATE, xs, ws)
    rf = mm.dropout_matmul_samples(ones.float(), eye.float(), seeds, RATE)
    vals = sorted(set(r8.unique().tolist()))
    same_mask = torch.equal(r8 != 0, rf != 0)
    check(same_mask and vals == [0.0, mm.int8_out_scale(xs, ws, RATE)],
          f"int8 mask readout {label}: float mask {same_mask}, values {vals}")
    line = {"phase": "kernels", "shape": label, **shape, "dtype": "int8",
            "rate": RATE, "x_step": xs, "w_step": ws,
            "out_scale": mm.int8_out_scale(xs, ws, RATE),
            "int8_bit_equal_plain": same1 and sames and samex,
            "int8_samples_equal_single_bitwise": per_sample,
            "int8_xs_equal_single_bitwise": per_sample_x,
            "int8_mask_equals_float_kernel": same_mask,
            "int8_readout_values": vals,
            "negative_seed_sample0": seeds[0].tolist()}
    if label in HEAD_LABELS:
        keep = torch.stack([mm.keep_mask(seeds[i], m, k, RATE)
                            for i in range(s)])
        xm = torch.where(keep, xq, torch.zeros((), dtype=torch.int8,
                                               device="cuda"))
        xm3 = torch.where(keep, xq3, torch.zeros((), dtype=torch.int8,
                                                 device="cuda"))
        # torch._int_mm takes K and N in multiples of 8: zeros pad them
        # (lenet's K = 100 -> 104), which leaves the product unchanged
        kpad = (-k) % 8
        xm = torch.nn.functional.pad(xm, (0, kpad))
        xm3 = torch.nn.functional.pad(xm3, (0, kpad))
        wpad = torch.nn.functional.pad(wq, (0, (-n) % 8, 0, kpad)
                                       ).t().contiguous().t()
        timings = {
            "dropout_matmul_int8": (
                lambda: mm.dropout_matmul_int8(xq, wq, s0, RATE, xs, ws),
                lambda: mm.dropout_matmul_int8_plain(xq, wq, s0, RATE, xs,
                                                     ws),
                lambda: torch._int_mm(xm[0], wpad)),
            "dropout_matmul_int8_samples": (
                lambda: mm.dropout_matmul_int8_samples(xq, wq, seeds, RATE,
                                                       xs, ws),
                lambda: mm.dropout_matmul_int8_samples_plain(
                    xq, wq, seeds, RATE, xs, ws),
                lambda: torch._int_mm(xm.reshape(s * m, k + kpad), wpad)),
            "dropout_matmul_int8_xs": (
                lambda: mm.dropout_matmul_int8_inference(xq3, wq, seeds,
                                                         RATE, xs, ws),
                lambda: torch.stack([mm.dropout_matmul_int8_plain(
                    xq3[i], wq, seeds[i], RATE, xs, ws) for i in range(s)]),
                lambda: torch._int_mm(xm3.reshape(s * m, k + kpad),
                                      wpad)),
        }
        for name, (kern, plain, lib) in timings.items():
            if label != "head" and name not in SAMPLES_TIMED:
                continue
            # library: one cuBLASLt s8 GEMM on the pre-masked x, N padded
            # to 16 as torch._int_mm needs (all S samples in one call);
            # the kernel and it in TIMING_ROUNDS alternating rounds
            t = {**_rounds({"ms": kern, "library_ms": lib}, TIMING_ROUNDS),
                 "plain_ms": device_ms(plain, 20),
                 "events_ms": cuda_ms(kern, 200)}
            t["bound_ms"], t["bound_by"] = _bound(name, shape, torch.int8)
            line[name] = t
            if label == "head":
                summary[name].update(t)
    emit(line)


def _check_apply(mm, x, seeds, ones, fwd_readout, dtype, label, line,
                 summary) -> None:
    """dropout_apply (the backward's mask) on the card: bit-equal to its
    plain version with each seed pair (the first negative), its readout of
    ones exactly {0, f32(1/(1-rate))}, and the readout's nonzero pattern
    equal to the forward kernel's ``ones @ eye``."""
    import torch
    same, err = True, 0.0
    for s in range(seeds.shape[0]):
        sd = seeds[s].contiguous()
        got = mm.dropout_apply(x, sd, RATE)
        want = mm.dropout_apply_plain(x, sd, RATE)
        same &= torch.equal(got, want)
        err = max(err, (got.float() - want.float()).abs().max().item())
    check(same, f"dropout_apply vs plain {label} {dtype}")
    r = mm.dropout_apply(ones, seeds[0].contiguous(), RATE)
    vals = sorted(set(r.unique().tolist()))
    same_mask = torch.equal(r != 0, fwd_readout != 0)
    check(vals == [0.0, mm.apply_scale(RATE)] and same_mask,
          f"dropout_apply readout {label} {dtype}: values {vals}, "
          f"forward mask {same_mask}")
    line["dropout_apply_bit_equal_plain"] = same
    line["dropout_apply_mask_equals_forward"] = same_mask
    line["dropout_apply_readout_values"] = vals
    summary["dropout_apply"]["max_abs_err"] = max(
        summary["dropout_apply"]["max_abs_err"], err)


def _apply_shapes(mm, gen) -> None:
    """dropout_apply (row 1) where the backward runs it, in f32 and bf16 x:
    bit-equal to its plain version with each of three seed pairs (the
    first negative) on a contiguous x and on an x whose first element sits
    one element past a 16-byte boundary (the kernel's scalar path), at the
    APPLY_SHAPES, where it is timed in TIMING_ROUNDS rounds that alternate
    it with ``torch.mul`` of x by a pre-made f32 mask, and at the
    APPLY_RAGGED and APPLY_VIEWS ones."""
    import torch
    seeds = _inputs(dict(M=1, K=1, N=1, S=3), torch.float32, gen)[2]
    s0 = seeds[0].contiguous()
    for dtype in (torch.float32, torch.bfloat16):
        for label, (m, k) in {**APPLY_SHAPES, **APPLY_RAGGED,
                              **APPLY_VIEWS}.items():
            buf = torch.randn(m * k + 1, generator=gen).to(dtype).cuda()
            x, x_off = buf[:-1].view(m, k), buf[1:].view(m, k)
            same = all(torch.equal(mm.dropout_apply(xx, sd, RATE),
                                   mm.dropout_apply_plain(xx, sd, RATE))
                       for xx in (x, x_off)
                       for sd in (seeds[i].contiguous() for i in range(3)))
            check(same, f"dropout_apply {label} {dtype}: not bit-equal to "
                  "its plain version")
            line = {"phase": "kernels", "kernel": "dropout_apply",
                    "shape": label, "M": m, "K": k,
                    "dtype": str(dtype).split(".")[-1], "rate": RATE,
                    "bit_equal_plain": same, "offset_x_checked": True}
            if label in APPLY_SHAPES:
                mask_scaled = (mm.keep_mask(s0, m, k, RATE).float()
                               * mm.apply_scale(RATE))
                t = {**_rounds({"ms": lambda: mm.dropout_apply(x, s0, RATE),
                                "library_ms": lambda: torch.mul(
                                    x, mask_scaled)}, TIMING_ROUNDS),
                     "plain_ms": device_ms(
                         lambda: mm.dropout_apply_plain(x, s0, RATE), 20),
                     "events_ms": cuda_ms(
                         lambda: mm.dropout_apply(x, s0, RATE), 200)}
                t["bound_ms"], t["bound_by"] = _bound(
                    "dropout_apply", dict(M=m, K=k, N=0, S=1), dtype)
                line.update(t, ms_over_library=t["ms"] / t["library_ms"],
                            ms_over_bound=t["ms"] / t["bound_ms"])
            emit(line)


def _time_kernels(mm, x, x3, w, seeds, shape, dtype, line, summary,
                  names=None) -> None:
    """Times at a head shape, of every float MC kernel or of ``names``;
    the bf16 ones (the main path's dtype) go into ``summary`` unless it is
    None. x3 carries the sample axis (the _xs launch). Each
    kernel and its library call are timed in TIMING_ROUNDS alternating
    rounds (``_rounds``): ``ms`` and ``library_ms`` are the medians, their
    readings listed beside them."""
    import torch
    s0 = seeds[0].contiguous()
    keep = mm.keep_mask(s0, shape["M"], shape["K"], RATE)
    scale = torch.tensor(mm.scale_of(RATE, dtype), dtype=dtype, device="cuda")
    xm1 = torch.where(keep, x * scale, torch.zeros((), dtype=dtype,
                                                   device="cuda"))
    xms = torch.stack([xm1] * shape["S"])
    xm3 = torch.stack([torch.where(
        mm.keep_mask(seeds[s], shape["M"], shape["K"], RATE), x3[s] * scale,
        torch.zeros((), dtype=dtype, device="cuda"))
        for s in range(shape["S"])])
    # the yardstick of dropout_apply: one elementwise product with a
    # pre-made f32 mask (bf16 x promotes to f32 inside the one kernel)
    mask_scaled = keep.float() * mm.apply_scale(RATE)
    timings = {
        "dropout_matmul": (
            lambda: mm.dropout_matmul(x, w, s0, RATE),
            lambda: mm.dropout_matmul_plain(x, w, s0, RATE),
            lambda: torch.matmul(xm1, w)),
        "dropout_matmul_samples": (
            lambda: mm.dropout_matmul_samples(x, w, seeds, RATE),
            lambda: mm.dropout_matmul_samples_plain(x, w, seeds, RATE),
            lambda: torch.matmul(xms, w)),
        "dropout_matmul_xs": (
            lambda: mm.dropout_matmul_inference(x3, w, seeds, RATE),
            lambda: torch.stack([mm.dropout_matmul_plain(
                x3[s], w, seeds[s], RATE) for s in range(shape["S"])]),
            lambda: torch.matmul(xm3, w)),
        "dropout_apply": (
            lambda: mm.dropout_apply(x, s0, RATE),
            lambda: mm.dropout_apply_plain(x, s0, RATE),
            lambda: torch.mul(x, mask_scaled)),
    }
    for name, (kern, plain, lib) in timings.items():
        if names is not None and name not in names:
            continue
        # ms, plain_ms, library_ms: device time per call; events_ms: CUDA
        # events over back-to-back wrapper calls, host dispatch included
        t = {**_rounds({"ms": kern, "library_ms": lib}, TIMING_ROUNDS),
             "plain_ms": device_ms(plain, 20),
             "events_ms": cuda_ms(kern, 200)}
        t["bound_ms"], t["bound_by"] = _bound(name, shape, dtype)
        line[name] = t
        if dtype == torch.bfloat16 and summary is not None:
            summary[name].update(t)


def _conv_bound(name: str, x, w, s: int, out_bytes: int, padding="SAME",
                stride: int = 1, mask_bytes: int = 0, kind: str | None = None
                ) -> tuple[float, str]:
    """Least time of a masked conv on an H100: x and w read once, the mask
    operands (seeds, or bank rows and indices) and the (2, F) affine read
    once, S outputs written once, against 2 operations for each product
    that reads an input element (taps on the zero padding excluded) per
    sample, at the peak for the products' type (or ``kind``): bf16 or int8
    tensor cores for bf16 or int8 operands; an f32 operand's f32 products
    (f32 and mixed-type MC convs, every float bank conv) as the three TF32
    products they run, at the tf32 tensor cores' peak; ``kind="float32"``
    gives the bound of f32 multiply-adds outside the tensor cores."""
    import torch
    from bayestpu_torch.kernels import masked_conv as mc
    n, c, h, wd = x.shape[-4:]          # x (S, N, C, H, W) carries S
    f, _, kh, kw = w.shape
    g = mc.geometry(h, wd, kh, kw, padding, stride)
    macs = mc.conv_macs(n, c, f, h, wd, kh, kw, g, stride)
    nbytes = (x.numel() * x.element_size() + w.numel() * w.element_size()
              + 2 * f * 4 + mask_bytes + s * n * g.ho * g.wo * f * out_bytes)
    if kind is None:
        kind = ("int8" if x.dtype == torch.int8 else
                "bfloat16" if "bank" not in name
                and x.dtype == w.dtype == torch.bfloat16 else "tfloat32")
    passes = 3 if kind == "tfloat32" else 1
    t_bytes = nbytes / MEM_BYTES_PER_S
    t_ops = 2 * passes * s * macs / PEAK_FLOPS[kind]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _cl(t):
    import torch
    return t.contiguous(memory_format=torch.channels_last)


def _conv_data(xshape, k: int, f: int, dtype, gen):
    """x (NCHW, channels_last) and w (OIHW) on the card from an NHWC shape,
    the (2, F) affine, and int8 twins of x and w."""
    import torch
    n, h, wd, c = xshape
    x = _cl(torch.randn(n, c, h, wd, generator=gen).to(dtype).cuda())
    w = (torch.randn(f, c, k, k, generator=gen) / (k * k * c) ** 0.5).to(
        dtype).cuda()
    aff = torch.stack([torch.rand(f, generator=gen) + 0.5,
                       0.3 * torch.randn(f, generator=gen)]).cuda()
    xq = _cl(torch.randint(-128, 128, (n, c, h, wd), generator=gen,
                           dtype=torch.int8).cuda())
    wq = torch.randint(-128, 128, (f, c, k, k), generator=gen,
                       dtype=torch.int8).cuda()
    return x, w, aff, xq, wq


def _x5(xshape, dtype, gen):
    """CONV_S inputs of NHWC shape ``xshape`` as x carrying the sample axis:
    (S, N, C, H, W), each sample in channels_last memory, samples
    outermost (``stack_samples``'s layout, which the _xs kernels read)."""
    import torch
    from bayestpu_torch.kernels import masked_conv as mc
    n, h, wd, c = xshape
    if dtype == torch.int8:
        xs = [torch.randint(-128, 128, (n, c, h, wd), generator=gen,
                            dtype=torch.int8) for _ in range(CONV_S)]
    else:
        xs = [torch.randn(n, c, h, wd, generator=gen).to(dtype)
              for _ in range(CONV_S)]
    return mc.stack_samples([_cl(t.cuda()) for t in xs])


def _conv_banks(c: int):
    """The generated (4, C) bank and one with 2.0, 0.25 and negative
    entries (the float kernels multiply by the value and, as JAX selects
    the row by a max over a where, read a negative one as 0)."""
    import torch
    from bayestpu_torch.kernels.mask_bank import generation_wrapper
    _, bank = generation_wrapper(c, NUM_MASKS, MASK_SCALE, rng=0)
    bank = torch.from_numpy(bank).cuda().contiguous()
    odd = bank.clone()
    odd[0, ::7] = 2.0
    odd[1, 1::5] = 0.25
    odd[1, :5] = -1.5
    return bank, odd


def _conv_checks(label: str, xshape, k: int, f: int, padding, stride: int,
                 gen, summary: dict) -> None:
    """Rows 10 and 11 on the card against their plain versions at one
    geometry: every float entry in bf16 and f32 (the (2, F) affine and
    relu, f32 and bf16 stores; the bank convs on both banks, with the f32
    folded kernel and with w in x's dtype) to CONV_RTOL; every int8 entry
    with every epilogue bit for bit; sample s of each samples and _xs
    kernel bit-equal to its single kernel; the first seed pair negative;
    bank indices that wrap and a negative one; the mask-free conv_fused and
    conv_int8_fused."""
    import torch
    from bayestpu_torch.kernels import masked_conv as mc
    seeds = _inputs(dict(M=1, K=1, N=1, S=CONV_S), torch.float32, gen)[2]
    idxs = torch.tensor(CONV_RAGGED_IDXS, dtype=torch.int32, device="cuda")
    kw = dict(stride=stride)
    line = {"phase": "kernels", "kernel": "masked_conv", "shape": label,
            "x_nhwc": list(xshape), "k": k, "F": f, "padding": padding,
            "stride": stride, "rate": RATE, "samples": CONV_S,
            "idxs": CONV_RAGGED_IDXS}
    per_sample = True

    def close(name, got, want, rtol, tag):
        err = (got.float() - want.float()).abs().max().item()
        tol = rtol * max(1.0, want.float().abs().max().item())
        check(err <= tol, f"{name} {label} {tag}: {err} > {tol}")
        if name in summary and not tag.endswith("bf16out"):
            summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"],
                                               err)
        line[f"{name}_{tag}_err"] = err

    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).split(".")[-1]
        x, w, aff, _, _ = _conv_data(xshape, k, f, dtype, gen)
        epi = dict(bias=aff, act="relu", **kw)
        ys = mc.dropout_conv_samples(x, w, seeds, RATE, padding, **epi)
        rs = mc.stack_samples([mc.dropout_conv_plain(
            x, w, seeds[s], RATE, padding, stride, aff, "relu")
            for s in range(CONV_S)])
        close("dropout_conv_samples", ys, rs, CONV_RTOL, tag)
        y16 = mc.dropout_conv_samples(x, w, seeds, RATE, padding,
                                      out_dtype=torch.bfloat16, **epi)
        r16 = mc.stack_samples([mc.dropout_conv_plain(
            x, w, seeds[s], RATE, padding, stride, aff, "relu",
            torch.bfloat16) for s in range(CONV_S)])
        check(y16.dtype == torch.bfloat16, "bf16 store")
        close("dropout_conv_samples", y16, r16, BF16_OUT_RTOL,
              tag + "_bf16out")
        singles = [mc.dropout_conv_inference(x, w, seeds[s].contiguous(),
                                             RATE, padding, **epi)
                   for s in range(CONV_S)]
        per_sample &= all(torch.equal(ys[s], singles[s])
                          for s in range(CONV_S))
        close("dropout_conv", mc.dropout_conv(x, w, seeds[0].contiguous(),
                                              RATE, padding, stride),
              mc.dropout_conv_plain(x, w, seeds[0], RATE, padding, stride),
              CONV_RTOL, tag)
        close("conv_fused", mc.conv_fused(x, w, padding=padding, **epi),
              mc.conv_fused_plain(x, w, aff, "relu", padding=padding,
                                  stride=stride), CONV_RTOL, tag)
        # x carrying the sample axis: one _xs launch, sample s of x5 under
        # seeds[s] equal to the single launch on x5[s] bit for bit
        x5 = _x5(xshape, dtype, gen)
        yx = mc.dropout_conv_inference(x5, w, seeds, RATE, padding, **epi)
        rx = mc.stack_samples([mc.dropout_conv_plain(
            x5[s], w, seeds[s], RATE, padding, stride, aff, "relu")
            for s in range(CONV_S)])
        close("dropout_conv_xs", yx, rx, CONV_RTOL, tag)
        per_sample &= all(torch.equal(yx[s], mc.dropout_conv_inference(
            x5[s], w, seeds[s].contiguous(), RATE, padding, **epi))
            for s in range(CONV_S))
        # Masksembles: the f32 folded kernel whatever x's dtype
        wf = w.float()
        for bname, bank in zip(("bank", "bank_odd"), _conv_banks(xshape[3])):
            epi_b = dict(bias=aff[1], act="relu", **kw)
            yb = mc.bank_conv_samples(x, wf, bank, idxs, padding, **epi_b)
            rb = mc.stack_samples([mc.bank_conv_plain(
                x, wf, bank, i, padding, stride, aff[1], "relu")
                for i in CONV_RAGGED_IDXS])
            close("bank_conv_samples", yb, rb, CONV_RTOL, f"{tag}_{bname}")
            sb = [mc.bank_conv(x, wf, bank, i, padding, **epi_b)
                  for i in CONV_RAGGED_IDXS]
            close("bank_conv", torch.stack(sb), torch.stack(list(rb)),
                  CONV_RTOL, f"{tag}_{bname}")
            per_sample &= all(torch.equal(yb[s], sb[s])
                              for s in range(len(sb)))
            # x carrying the sample axis: one bank_conv_xs launch
            yx = mc.bank_conv_inference(x5, wf, bank, idxs, padding, **epi_b)
            rx = mc.stack_samples([mc.bank_conv_plain(
                x5[s], wf, bank, i, padding, stride, aff[1], "relu")
                for s, i in enumerate(CONV_RAGGED_IDXS)])
            close("bank_conv_xs", yx, rx, CONV_RTOL, f"{tag}_{bname}")
            per_sample &= all(torch.equal(yx[s], mc.bank_conv(
                x5[s], wf, bank, i, padding, **epi_b))
                for s, i in enumerate(CONV_RAGGED_IDXS))
        # w in x's dtype (bf16 widened exactly by the wrapper)
        close("bank_conv", mc.bank_conv(x, w, bank, 2, padding, **epi_b),
              mc.bank_conv_plain(x, w, bank, 2, padding, stride, aff[1],
                                 "relu"), CONV_RTOL, f"{tag}_w_{tag}")
    # int8, every epilogue, bit for bit
    _, _, aff, xq, wq = _conv_data(xshape, k, f, torch.float32, gen)
    xq5 = _x5(xshape, torch.int8, gen)
    steps = (2.0 ** -7, 2.0 ** -7)
    int8_equal = True
    _, odd = _conv_banks(xshape[3])
    for ename, epi in (("f32", {}),
                       ("affine_relu_int8", dict(bias=aff, act="relu",
                                                 out_step=2.0 ** -7)),
                       ("bias_int8", dict(bias=aff[1], out_step=2.0 ** -6)),
                       ("affine_f32", dict(bias=aff))):
        ys = mc.dropout_conv_int8_samples(xq, wq, seeds, RATE, *steps,
                                          padding, stride=stride, **epi)
        rs = mc.stack_samples([mc.dropout_conv_int8_plain(
            xq, wq, seeds[s], RATE, *steps, padding, stride, **epi)
            for s in range(CONV_S)])
        singles = [mc.dropout_conv_int8(xq, wq, seeds[s].contiguous(), RATE,
                                        *steps, padding, stride=stride, **epi)
                   for s in range(CONV_S)]
        yb = mc.bank_conv_int8_samples(xq, wq, odd, idxs, *steps, padding,
                                       stride=stride, **epi)
        rb = mc.stack_samples([mc.bank_conv_int8_plain(
            xq, wq, odd, i, *steps, padding, stride, **epi)
            for i in CONV_RAGGED_IDXS])
        sb = [mc.bank_conv_int8(xq, wq, odd, i, *steps, padding,
                                stride=stride, **epi)
              for i in CONV_RAGGED_IDXS]
        yxb = mc.bank_conv_int8_inference(xq5, wq, odd, idxs, *steps,
                                          padding, stride=stride, **epi)
        rxb = mc.stack_samples([mc.bank_conv_int8_plain(
            xq5[s], wq, odd, i, *steps, padding, stride, **epi)
            for s, i in enumerate(CONV_RAGGED_IDXS)])
        per_sample &= all(torch.equal(yxb[s], mc.bank_conv_int8(
            xq5[s], wq, odd, i, *steps, padding, stride=stride, **epi))
            for s, i in enumerate(CONV_RAGGED_IDXS))
        fused = mc.conv_int8_fused(xq, wq, *steps, padding=padding,
                                   stride=stride, **epi)
        rf = mc.dropout_conv_int8_plain(xq, wq, None, 0.0, *steps, padding,
                                        stride, **epi)
        yx = mc.dropout_conv_int8_inference(xq5, wq, seeds, RATE, *steps,
                                            padding, stride=stride, **epi)
        rx = mc.stack_samples([mc.dropout_conv_int8_plain(
            xq5[s], wq, seeds[s], RATE, *steps, padding, stride, **epi)
            for s in range(CONV_S)])
        per_sample &= all(torch.equal(yx[s], mc.dropout_conv_int8_inference(
            xq5[s], wq, seeds[s].contiguous(), RATE, *steps, padding,
            stride=stride, **epi)) for s in range(CONV_S))
        for name, got, want in (
                ("dropout_conv_int8_samples", ys, rs),
                ("dropout_conv_int8", torch.stack(singles), rs),
                ("dropout_conv_int8_xs", yx, rx),
                ("bank_conv_int8_samples", yb, rb),
                ("bank_conv_int8", torch.stack(sb), rb),
                ("bank_conv_int8_xs", yxb, rxb),
                ("conv_int8_fused", fused, rf)):
            same = torch.equal(got, want)
            int8_equal &= same
            err = (got.float() - want.float()).abs().max().item()
            if name in summary:
                summary[name]["max_abs_err"] = max(
                    summary[name]["max_abs_err"], err)
            line[f"{name}_{ename}_bit_equal"] = same
        per_sample &= all(torch.equal(ys[s], singles[s])
                          for s in range(CONV_S))
        per_sample &= all(torch.equal(yb[s], sb[s]) for s in range(len(sb)))
    check(int8_equal and per_sample,
          f"conv kernels {label}: int8 bit-equal {int8_equal}, per sample "
          f"{per_sample}")
    line.update({"int8_bit_equal_plain": int8_equal,
                 "samples_equal_single_bitwise": per_sample,
                 "negative_seed_sample0": seeds[0].tolist()})
    emit(line)


def _conv_readout(gen) -> None:
    """The exact mask readout: x = ones, w = a 1x1 identity (VALID), so
    sample s is the mask of seeds[s] times the dtype's scale; its nonzero
    pattern that of the plain version, of ``dropout_apply`` (the
    backward's mask) and of the int8 kernel. In bf16 (exact products on
    the tensor cores) it equals the plain version bit for bit; the f32
    route's three TF32 products keep about 22 bits of each f32 product, so
    its kept value, the f32 scale times 1, reads within READOUT_F32_RTOL
    of the scale (1.3333334 reads 1.3333335, one ulp)."""
    import torch
    from bayestpu_torch.kernels import masked_conv as mc
    from bayestpu_torch.kernels import masked_matmul as mm
    n, h, wd, c = 2, 5, 4, 40
    seeds = _inputs(dict(M=1, K=1, N=1, S=CONV_S), torch.float32, gen)[2]
    line = {"phase": "kernels", "kernel": "masked_conv", "shape": "readout",
            "x_nhwc": [n, h, wd, c]}
    r8 = mc.dropout_conv_int8_samples(
        _cl(torch.ones(n, c, h, wd, dtype=torch.int8, device="cuda")),
        torch.eye(c, dtype=torch.int8, device="cuda")[:, :, None, None],
        seeds, RATE, 1.0, 1.0, "VALID")
    for dtype in (torch.bfloat16, torch.float32):
        ones = _cl(torch.ones(n, c, h, wd, dtype=dtype, device="cuda"))
        eye = torch.eye(c, dtype=dtype, device="cuda")[:, :, None, None]
        got = mc.dropout_conv_samples(ones, eye, seeds, RATE, "VALID")
        want = mc.stack_samples([mc.dropout_conv_plain(
            ones, eye, seeds[s], RATE, "VALID") for s in range(CONV_S)])
        applied = torch.stack([mc.mask_apply_nhwc(ones, seeds[s].contiguous(),
                                                  RATE)
                               for s in range(CONV_S)])
        vals = sorted(set(got.unique().tolist()))
        scale = mm.scale_of(RATE, dtype)
        exact = torch.equal(got, want) and vals == [0.0, scale]
        if dtype == torch.bfloat16:
            values_ok = exact
        else:
            values_ok = (len(vals) == 2 and vals[0] == 0.0 and abs(
                vals[1] - scale) <= READOUT_F32_RTOL * scale)
        ok = (values_ok and torch.equal(got != 0, want != 0)
              and torch.equal(got != 0, applied != 0)
              and torch.equal(got != 0, r8 != 0))
        check(ok, f"conv mask readout {dtype}: values {vals}")
        line[str(dtype).split(".")[-1]] = {
            "readout_bit_exact": exact, "values": vals,
            "equals_plain_mask": True,
            "equals_dropout_apply_mask": True, "equals_int8_mask": True,
            "keep_fraction": (got != 0).float().mean().item()}
    emit(line)


def _conv_row0(gen, summary: dict) -> None:
    """Row 10 at ``row0`` = b0·H·W, as one rank of a data-sharded batch
    runs it: the mask readout (x of ones, a 1x1 identity, VALID) of images
    [b0, b0 + n) of a batch of ROW0_BATCH at block site 1 (16x16x64) at
    that row0 bit-equal to those images of the launch on the whole batch,
    for 10a (one sample, bf16, and f32 on the three-TF32 route), 10b
    (samples), 10c (int8, one and S samples), 10e (x carrying
    the sample axis) and ``mask_apply_nhwc``; then block site 1's conv (3x3
    SAME, the fold affine and relu) on random x at that row0 and at a
    wrapping one against the plain versions (bf16 and f32 to CONV_RTOL of
    max|ref|, int8 bit for bit)."""
    import torch
    from bayestpu_torch.kernels import masked_conv as mc
    hw, c, f = CONV_SITES[0]
    seeds = _inputs(dict(M=1, K=1, N=1, S=CONV_S), torch.float32, gen)[2]
    s0 = seeds[0].contiguous()
    part = slice(ROW0_IMAGE, ROW0_IMAGE + ROW0_IMAGES)
    r0 = mc.image_row0(ROW0_IMAGE, hw, hw)
    line = {"phase": "kernels", "kernel": "masked_conv", "check": "row0",
            "x_nhwc": [ROW0_BATCH, hw, hw, c],
            "images": [part.start, part.stop], "row0": r0}
    same = {}
    for dtype in (torch.bfloat16, torch.float32, torch.int8):
        ones = _cl(torch.ones(ROW0_BATCH, c, hw, hw, dtype=dtype,
                              device="cuda"))
        eye = torch.eye(c, dtype=dtype, device="cuda")[:, :, None, None]
        tag = str(dtype).split(".")[-1]
        if dtype == torch.int8:
            runs = {"10c": lambda x, r: mc.dropout_conv_int8(
                        x, eye, s0, RATE, 1.0, 1.0, "VALID", row0=r),
                    "10c_samples": lambda x, r: mc.dropout_conv_int8_samples(
                        x, eye, seeds, RATE, 1.0, 1.0, "VALID", row0=r)}
        else:
            runs = {"10a": lambda x, r: mc.dropout_conv(
                        x, eye, s0, RATE, "VALID", row0=r),
                    "10b": lambda x, r: mc.dropout_conv_samples(
                        x, eye, seeds, RATE, "VALID", row0=r),
                    "10e": lambda x, r: mc.dropout_conv_inference(
                        mc.stack_samples([x] * CONV_S), eye, seeds, RATE,
                        "VALID", row0=r),
                    "mask_apply": lambda x, r: mc.mask_apply_nhwc(
                        x, s0, RATE, row0=r)}
        for name, run in runs.items():
            whole = run(ones, 0)
            got = run(ones[part], r0)
            same[f"{name}_{tag}"] = torch.equal(
                got, whole[..., part, :, :, :])
    check(all(same.values()), f"conv row0 readout: {same}")
    line["readout_equal_whole"] = same
    errs = {}
    for dtype in (torch.bfloat16, torch.float32, torch.int8):
        tag = str(dtype).split(".")[-1]
        if dtype == torch.int8:
            x = _cl(torch.randint(-128, 128, (ROW0_IMAGES, c, hw, hw),
                                  generator=gen, dtype=torch.int8).cuda())
            w = torch.randint(-128, 128, (f, c, 3, 3), generator=gen,
                              dtype=torch.int8).cuda()
        else:
            x = _cl(torch.randn(ROW0_IMAGES, c, hw, hw,
                                generator=gen).to(dtype).cuda())
            w = (torch.randn(f, c, 3, 3, generator=gen)
                 / (9 * c) ** 0.5).to(dtype).cuda()
        affine = torch.stack([torch.rand(f, generator=gen) + 0.5,
                              torch.randn(f, generator=gen)]).cuda()
        epi = dict(bias=affine, act="relu")
        for rr in (r0, ROW0_WRAP):
            if dtype == torch.int8:
                got = mc.dropout_conv_int8_samples(
                    x, w, seeds, RATE, 2.0 ** -7, 2.0 ** -7, "SAME", **epi,
                    row0=rr)
                want = mc.stack_samples([mc.dropout_conv_int8_plain(
                    x, w, seeds[i], RATE, 2.0 ** -7, 2.0 ** -7, "SAME",
                    **epi, row0=rr) for i in range(CONV_S)])
                name, tol = "dropout_conv_int8_samples", 0.0
            else:
                got = mc.dropout_conv_samples(x, w, seeds, RATE, "SAME",
                                              **epi, row0=rr)
                want = mc.stack_samples([mc.dropout_conv_plain(
                    x, w, seeds[i], RATE, "SAME", **epi, row0=rr)
                    for i in range(CONV_S)])
                name = "dropout_conv_samples"
                tol = CONV_RTOL * max(1.0, want.abs().max().item())
            err = (got.float() - want.float()).abs().max().item()
            check(err <= tol, f"{name} at row0 {rr} {tag}: {err} > {tol}")
            errs[f"{name}_{tag}@{rr}"] = err
            summary[name]["max_abs_err"] = max(summary[name]["max_abs_err"],
                                               err)
    line["max_abs_err_vs_plain"] = errs
    emit(line)


def _conv_times(gen, summary: dict | None, sites=CONV_SITES,
                convs=VGG_CONVS, stride: int = 1, label: str = "site",
                names=None, n: int = BATCH) -> None:
    """Times of rows 10 and 11 at the block-site shapes of a main path
    (batch ``n``, 128; vgg11's by default, 3x3, SAME, stride 1; each of
    ``convs`` at each of ``sites``), in the dtypes and with the epilogues
    the block-site models give them: the MC float kernels on bf16 x and w
    with the fold bias, the conv's activation and a bf16 store; the float
    bank kernels on bf16 x and the f32 folded kernel with an f32 store;
    the int8 kernels with the (2, F) BN affine, the activation and an int8
    store; of every kernel, or of ``names``. The samples kernels at the
    first site (S = 10 MC, 4 Masksembles), where the spatial mapping
    launches them; the _xs launches (x carrying S = 10 MC or 4
    Masksembles samples) at the others, each sample also bit-equal to the
    single launch on its x, with cuDNN at batch S·N beside them. At every
    site each kernel's output is held against its plain version on the
    same inputs first: int8 bit for bit, an f32 store to CONV_RTOL, a bf16
    store to BF16_OUT_RTOL, and the MC single kernel also with an f32
    store. ``ms`` is the device time per call from the profiler (the bank
    convs: the median of TIMING_ROUNDS rounds that alternate the kernel and
    its library call, ``_rounds``), ``events_ms`` CUDA events over
    back-to-back calls; ``library_ms`` one cuDNN ``F.conv2d`` of the
    pre-masked channels_last x (all samples in its batch; f32 with TF32
    off for the bank rows), which the port never calls; there is no
    PyTorch int8 conv, so none for the int8 rows; cuDNN pads k // 2 on each
    side, as torch's convs do, which at stride 2 shifts a SAME window by
    one and times the same work. The float bank rows also give
    ``bound_f32_fma_ms``, their bound at the f32 peak outside the tensor
    cores. The times at CONV_SUMMARY_SITE go into ``summary`` unless it is
    None."""
    import torch
    import torch.nn.functional as F
    from bayestpu_torch.kernels import masked_conv as mc
    steps = (2.0 ** -7, 2.0 ** -7)
    for si, (hw, c, f), (kname, (k, padding, act)) in (
            (si, site, conv) for si, site in enumerate(sites)
            for conv in convs.items()):
        pad = k // 2                       # torch's padding of the convs
        geo = dict(padding=padding, stride=stride)
        x, w, aff, xq, wq = _conv_data((n, hw, hw, c), k, f, torch.bfloat16,
                                       gen)
        wf = w.float()
        bank, _ = _conv_banks(c)
        seeds = _inputs(dict(M=1, K=1, N=1, S=SAMPLES), torch.float32,
                        gen)[2]
        s0 = seeds[0].contiguous()
        idxs = torch.arange(NUM_MASKS, dtype=torch.int32, device="cuda")
        b, bf16 = aff[1], torch.bfloat16
        xm = torch.cat([mc._hash_masked(x, seeds[s], RATE)
                        for s in range(SAMPLES)])
        xb = torch.cat([x.float() * bank[i].view(1, -1, 1, 1)
                        for i in range(NUM_MASKS)])
        xm, xb = _cl(xm), _cl(xb)
        runs = {
            "dropout_conv": (
                lambda: mc.dropout_conv_inference(
                    x, w, s0, RATE, bias=b, act=act, **geo, out_dtype=bf16),
                lambda: mc.dropout_conv_plain(x, w, s0, RATE, padding,
                                              stride, b, act, bf16),
                lambda: F.conv2d(xm[:n], w, stride=stride, padding=pad), 1,
                2, 8),
            "bank_conv": (
                lambda: mc.bank_conv(x, wf, bank, 0, bias=b, act=act, **geo),
                lambda: mc.bank_conv_plain(x, wf, bank, 0, padding, stride,
                                           b, act),
                lambda: F.conv2d(xb[:n], wf, stride=stride, padding=pad), 1,
                4, 4 * c),
            "dropout_conv_int8": (
                lambda: mc.dropout_conv_int8(xq, wq, s0, RATE, *steps,
                                             bias=aff, act=act, **geo,
                                             out_step=steps[0]),
                lambda: mc.dropout_conv_int8_plain(
                    xq, wq, s0, RATE, *steps, padding, stride, aff, act,
                    steps[0]), None, 1, 1, 8),
            "bank_conv_int8": (
                lambda: mc.bank_conv_int8(xq, wq, bank, 0, *steps, bias=aff,
                                          act=act, **geo, out_step=steps[0]),
                lambda: mc.bank_conv_int8_plain(
                    xq, wq, bank, 0, *steps, padding, stride, aff, act,
                    steps[0]), None, 1, 1, 4 * c),
        }
        if si == 0:
            runs.update({
                "dropout_conv_samples": (
                    lambda: mc.dropout_conv_samples(
                        x, w, seeds, RATE, bias=b, act=act, **geo,
                        out_dtype=bf16),
                    lambda: mc.stack_samples([mc.dropout_conv_plain(
                        x, w, seeds[s], RATE, padding, stride, b, act, bf16)
                        for s in range(SAMPLES)]),
                    lambda: F.conv2d(xm, w, stride=stride, padding=pad),
                    SAMPLES, 2, 8 * SAMPLES),
                "bank_conv_samples": (
                    lambda: mc.bank_conv_samples(x, wf, bank, idxs, bias=b,
                                                 act=act, **geo),
                    lambda: mc.stack_samples([mc.bank_conv_plain(
                        x, wf, bank, i, padding, stride, b, act)
                        for i in range(NUM_MASKS)]),
                    lambda: F.conv2d(xb, wf, stride=stride, padding=pad),
                    NUM_MASKS, 4, 4 * NUM_MASKS * (c + 1)),
                "dropout_conv_int8_samples": (
                    lambda: mc.dropout_conv_int8_samples(
                        xq, wq, seeds, RATE, *steps, bias=aff, act=act, **geo,
                        out_step=steps[0]),
                    lambda: mc.stack_samples([mc.dropout_conv_int8_plain(
                        xq, wq, seeds[s], RATE, *steps, padding, stride, aff,
                        act, steps[0]) for s in range(SAMPLES)]),
                    None, SAMPLES, 1, 8 * SAMPLES),
                "bank_conv_int8_samples": (
                    lambda: mc.bank_conv_int8_samples(
                        xq, wq, bank, idxs, *steps, bias=aff, act=act, **geo,
                        out_step=steps[0]),
                    lambda: mc.stack_samples([mc.bank_conv_int8_plain(
                        xq, wq, bank, i, *steps, padding, stride, aff, act,
                        steps[0]) for i in range(NUM_MASKS)]),
                    None, NUM_MASKS, 1, 4 * NUM_MASKS * (c + 1)),
            })
        if si > 0:
            # x carrying the sample axis, as blocks 2-4 get it: one _xs
            # launch for the S samples; cuDNN's conv of the pre-masked x
            # at batch S·N
            x5 = mc.stack_samples([_cl(torch.randn(
                n, c, hw, hw, generator=gen).to(bf16).cuda())
                for _ in range(SAMPLES)])
            xq5 = mc.stack_samples([_cl(torch.randint(
                -128, 128, (n, c, hw, hw), generator=gen,
                dtype=torch.int8).cuda()) for _ in range(SAMPLES)])
            xm5 = _cl(torch.cat([mc._hash_masked(x5[s], seeds[s], RATE)
                                 for s in range(SAMPLES)]))
            # the Masksembles sites' x carries S = NUM_MASKS samples, sample
            # s under index s
            xb5, xqb5 = x5[:NUM_MASKS], xq5[:NUM_MASKS]
            xbm5 = _cl(torch.cat([xb5[i].float() * bank[i].view(1, -1, 1, 1)
                                  for i in range(NUM_MASKS)]))
            runs.update({
                "dropout_conv_xs": (
                    lambda: mc.dropout_conv_inference(
                        x5, w, seeds, RATE, bias=b, act=act, **geo,
                        out_dtype=bf16),
                    lambda: mc.stack_samples([mc.dropout_conv_plain(
                        x5[s], w, seeds[s], RATE, padding, stride, b, act,
                        bf16) for s in range(SAMPLES)]),
                    lambda: F.conv2d(xm5, w, stride=stride, padding=pad),
                    SAMPLES, 2, 8 * SAMPLES),
                "dropout_conv_int8_xs": (
                    lambda: mc.dropout_conv_int8_inference(
                        xq5, wq, seeds, RATE, *steps, bias=aff, act=act, **geo,
                        out_step=steps[0]),
                    lambda: mc.stack_samples([mc.dropout_conv_int8_plain(
                        xq5[s], wq, seeds[s], RATE, *steps, padding, stride,
                        aff, act, steps[0]) for s in range(SAMPLES)]),
                    None, SAMPLES, 1, 8 * SAMPLES),
                "bank_conv_xs": (
                    lambda: mc.bank_conv_inference(xb5, wf, bank, idxs,
                                                   bias=b, act=act, **geo),
                    lambda: mc.stack_samples([mc.bank_conv_plain(
                        xb5[i], wf, bank, i, padding, stride, b, act)
                        for i in range(NUM_MASKS)]),
                    lambda: F.conv2d(xbm5, wf, stride=stride, padding=pad),
                    NUM_MASKS, 4, 4 * NUM_MASKS * (c + 1)),
                "bank_conv_int8_xs": (
                    lambda: mc.bank_conv_int8_inference(
                        xqb5, wq, bank, idxs, *steps, bias=aff, act=act, **geo,
                        out_step=steps[0]),
                    lambda: mc.stack_samples([mc.bank_conv_int8_plain(
                        xqb5[i], wq, bank, i, *steps, padding, stride, aff,
                        act, steps[0]) for i in range(NUM_MASKS)]),
                    None, NUM_MASKS, 1, 4 * NUM_MASKS * (c + 1)),
            })
            singles = {
                "dropout_conv_xs": lambda s: mc.dropout_conv_inference(
                    x5[s], w, seeds[s].contiguous(), RATE, bias=b,
                    act=act, **geo, out_dtype=bf16),
                "dropout_conv_int8_xs": lambda s: mc.dropout_conv_int8(
                    xq5[s], wq, seeds[s].contiguous(), RATE, *steps,
                    bias=aff, act=act, **geo, out_step=steps[0]),
                "bank_conv_xs": lambda s: mc.bank_conv(
                    xb5[s], wf, bank, s, bias=b, act=act, **geo),
                "bank_conv_int8_xs": lambda s: mc.bank_conv_int8(
                    xqb5[s], wq, bank, s, *steps, bias=aff, act=act, **geo,
                    out_step=steps[0])}
            bound_x = {"dropout_conv_xs": x5, "dropout_conv_int8_xs": xq5,
                       "bank_conv_xs": xb5, "bank_conv_int8_xs": xqb5}
        else:
            singles = {}
        if names is not None:
            runs = {name: run for name, run in runs.items() if name in names}
        where = f"{label}{si + 1}" + (f"_{kname}" if len(convs) > 1 else "")
        line = {"phase": "kernels", "kernel": "masked_conv", "shape": where,
                "x_nhwc": [n, hw, hw, c], "F": f, "k": k,
                "padding": padding, "stride": stride}
        for name, one in singles.items():
            if name not in runs:
                continue
            got = runs[name][0]()
            same = all(torch.equal(got[s], one(s))
                       for s in range(got.shape[0]))
            check(same, f"{name} {where}: sample s differs from the single "
                  "launch on x[s]")
            line[f"{name}_equals_single_bitwise"] = same
        checks = [(name, run[0], run[1]) for name, run in runs.items()]
        if "dropout_conv" in runs:
            checks.append(("dropout_conv", lambda: mc.dropout_conv_inference(
                x, w, s0, RATE, bias=b, act=act, **geo),
                lambda: mc.dropout_conv_plain(x, w, s0, RATE, padding,
                                              stride, b, act)))
        for name, kern, plain in checks:
            got, want = kern(), plain()
            err = (got.float() - want.float()).abs().max().item()
            if got.dtype == torch.int8:
                check(torch.equal(got, want),
                      f"{name} {where}: int8 not bit-equal, {err}")
                tag = "int8"
            else:
                bf16_out = got.dtype == torch.bfloat16
                tol = ((BF16_OUT_RTOL if bf16_out else CONV_RTOL)
                       * max(1.0, want.float().abs().max().item()))
                check(err <= tol, f"{name} {where}: {err} > {tol}")
                tag = "bf16out" if bf16_out else "f32"
            if tag != "bf16out" and summary is not None:
                summary[name]["max_abs_err"] = max(
                    summary[name]["max_abs_err"], err)
            line[f"{name}_{tag}_err"] = err
        for name, (kern, plain, lib, s, out_bytes, mask_bytes) in \
                runs.items():
            xx = (bound_x[name] if name.endswith("_xs") else
                  xq if "int8" in name else x)
            ww = wq if "int8" in name else (wf if "bank" in name else w)
            if name.startswith("bank"):
                t = _rounds({"ms": kern} if lib is None else
                            {"ms": kern, "library_ms": lib}, TIMING_ROUNDS,
                            20)
                t.setdefault("library_ms", None)
            else:
                t = {"ms": device_ms(kern, 20),
                     "library_ms": (device_ms(lib, 20) if lib is not None
                                    else None)}
            t.update(plain_ms=device_ms(plain, 3),
                     events_ms=cuda_ms(kern, 20, 3))
            t["bound_ms"], t["bound_by"] = _conv_bound(
                name, xx, ww, s, out_bytes, padding, stride, mask_bytes)
            if name.startswith("bank") and "int8" not in name:
                t["bound_f32_fma_ms"] = _conv_bound(
                    name, xx, ww, s, out_bytes, padding, stride, mask_bytes,
                    kind="float32")[0]
            line[name] = t
            if summary is not None and si == CONV_SUMMARY_SITE.get(name, 0):
                summary[name].update(t, shape=where)
        emit(line)


def phase_conv_kernels() -> dict:
    """Rows 10 and 11 (``csrc/masked_conv.cu``) on the card: the checks of
    ``_conv_checks`` at the block-1 site shape and the ragged geometries,
    the mask readout, and at the four site shapes the main path's epilogues
    against the plain versions, then the times; then the same checks at
    resnet18's three deferred sites (both convs, batch 128), the readout
    of their shared mask, ``conv_int8_fused`` at the int8 models' conv
    geometries (``_int8_model_convs``), the bf16 MC launches of resnet50's
    six ImageNet block-site convs (``_resnet50_site_convs``), the counters
    of one forward of each ImageNet block-site model
    (``_blocks_forward_counters``), the MC launches of resnet18's
    ``dropout="layer"`` route at batch LENET_SMALL
    (``_resnet_small_checks``), and the times of the
    launches its block-site spatial predict makes there and of its 3x3
    launches at ImageNet shapes (row 10I); row 10's f32
    samples launch at AlexNet's conv5 (``_alex_conv5``); the 7x7 window at
    stride 2 (CONV_WINDOW7) checked in every routine and timed; row 10's
    f32 route at block site 1 in f32 and both mixed types, checked and
    timed (``_conv_f32_route``)."""
    import torch
    from bayestpu_torch.utils import profiler
    gen = torch.Generator().manual_seed(4321)
    summary = {name: {"max_abs_err": 0.0} for name in CONV_REPLACES}
    hw, c, f = CONV_SITES[0]
    _conv_checks("site1", (BATCH, hw, hw, c), 3, f, "SAME", 1, gen, summary)
    for label, (xshape, k, ff, padding, stride) in CONV_RAGGED.items():
        _conv_checks(label, xshape, k, ff, padding, stride, gen, summary)
    (n7, hw7, _, c7), f7 = CONV_WINDOW7
    _conv_checks("window7_s2", CONV_WINDOW7[0], 7, f7, "SAME", 2, gen,
                 summary)
    _conv_readout(gen)
    _conv_row0(gen, summary)
    _conv_times(gen, summary)
    for hw, c, f in RESNET_SITES:
        for kname, (k, padding, _) in RESNET_CONVS.items():
            _conv_checks(f"resnet_{hw}x{hw}x{c}_{kname}_s2",
                         (BATCH, hw, hw, c), k, f, padding, 2, gen, summary)
    _resnet_readout(gen)
    _int8_model_convs(gen)
    _resnet50_site_convs(gen)
    _pointwise_times(gen)
    for model in BLOCKS_FORWARD:
        _blocks_forward_counters(gen, model)
    _resnet_small_checks(gen)
    # as the block-site resnet18's spatial predict launches them (row
    # 10r), and its 3x3 site convs at ImageNet shapes (row 10I): the bf16
    # MC 3x3 launches on the window routine
    mc_names = ("dropout_conv_samples", "dropout_conv_xs")
    for sites, convs, label, names in (
            (RESNET_SITES, RESNET_CONVS, "resnet_site",
             mc_names + ("bank_conv_samples", "bank_conv_xs")),
            (RESNET18_IMAGENET_SITES, {"3x3": RESNET_CONVS["3x3"]},
             "resnet18_imagenet_site", mc_names)):
        before = profiler.counters().get("conv.window_launches", 0)
        _conv_times(gen, None, sites, convs, 2, label, names)
        window = profiler.counters().get("conv.window_launches", 0) - before
        emit({"phase": "conv", "kernel": "window::conv_mma_kernel",
              "shapes": label, "window_launches": window})
        check(window > 0, f"{label}: no launch on the window routine")
    _conv_times(gen, None, [(hw7, c7, f7)], {"7x7": (7, "SAME", "relu")},
                2, "window7_s2_site",
                ("dropout_conv", "dropout_conv_samples", "dropout_conv_int8",
                 "bank_conv", "bank_conv_int8"), n7)
    f32, bf16 = torch.float32, torch.bfloat16
    hw1, c1, f1 = CONV_SITES[0]
    _conv_f32_route(gen, "site1", (BATCH, hw1, hw1, c1), 3, f1, "SAME", 1,
                    ((f32, f32), (bf16, f32), (f32, bf16)))
    _conv_f32_route(gen, "window7_s2", CONV_WINDOW7[0], 7, f7, "SAME", 2,
                    ((f32, f32),))
    _alex_conv5(gen, summary)
    return summary


def _int8_model_convs(gen) -> None:
    """``conv_int8_fused`` at every geometry of INT8_MODEL_CONVS, batch
    BATCH, against ``dropout_conv_int8_plain`` (rate 0) on the same card
    inputs bit for bit: the BatchNorm affine with an f32 store (a block's
    last conv, the projection) and with relu and the int8 store (every
    other conv of a block, the exit cascades)."""
    import torch
    from bayestpu_torch.kernels import masked_conv as mc
    steps = (2.0 ** -7, 2.0 ** -7)
    for model, shapes in INT8_MODEL_CONVS.items():
        for hw, c, f, k, stride, padding in shapes:
            _, _, aff, xq, wq = _conv_data((BATCH, hw, hw, c), k, f,
                                           torch.float32, gen)
            where = f"{model}_{hw}x{hw}x{c}_to_{f}_k{k}_s{stride}"
            line = {"phase": "conv", "kernel": "conv_int8_fused",
                    "shape": where, "N": BATCH, "H": hw, "C": c, "F": f,
                    "kernel_size": k, "stride": stride,
                    "padding": str(padding)}
            for out, dtype, epi in (
                    ("f32", torch.float32, dict(bias=aff)),
                    ("int8", torch.int8, dict(bias=aff, act="relu",
                                              out_step=steps[0]))):
                got = mc.conv_int8_fused(xq, wq, *steps, padding=padding,
                                         stride=stride, **epi)
                want = mc.dropout_conv_int8_plain(xq, wq, None, 0.0, *steps,
                                                  padding, stride, **epi)
                same = got.dtype == want.dtype == dtype and torch.equal(
                    got, want)
                check(same, f"conv_int8_fused {where} {out} out: not "
                      f"bit-equal to its plain version")
                line[f"{out}_out_bit_equal"] = same
            emit(line)


def _resnet50_site_convs(gen) -> None:
    """``dropout_conv_samples`` and ``dropout_conv_xs`` in bf16 at the six
    RESNET50_SITE_CONVS geometries, batch BATCH, CONV_S samples, with the
    served model's epilogue (the folded BatchNorm's (F,) bias, relu on
    convbn1, a bf16 store) and with an f32 store, against the plain
    versions on the same card inputs (BF16_OUT_RTOL and CONV_RTOL), and
    sample s bit-equal to the single launch on seeds[s] (and x[s])."""
    import torch
    from bayestpu_torch.kernels import masked_conv as mc
    bf16 = torch.bfloat16
    seeds = _inputs(dict(M=1, K=1, N=1, S=CONV_S), torch.float32, gen)[2]
    for hw, c, f, stride, act, carries in RESNET50_SITE_CONVS:
        xshape = (BATCH, hw, hw, c)
        x, w, aff, _, _ = _conv_data(xshape, 1, f, bf16, gen)
        if carries:
            x = _x5(xshape, bf16, gen)
        xs = list(x) if carries else [x] * CONV_S
        name = "dropout_conv_xs" if carries else "dropout_conv_samples"
        where = f"resnet50_{hw}x{hw}x{c}_to_{f}_s{stride}"
        line = {"phase": "conv", "kernel": name, "shape": where, "N": BATCH,
                "H": hw, "C": c, "F": f, "stride": stride, "act": act,
                "samples": CONV_S}
        same = True
        for out, rtol in ((bf16, BF16_OUT_RTOL), (None, CONV_RTOL)):
            epi = dict(bias=aff[1], act=act, out_dtype=out, stride=stride)
            got = mc.dropout_conv_inference(x, w, seeds, RATE, "SAME", **epi)
            want = mc.stack_samples([mc.dropout_conv_plain(
                xs[s], w, seeds[s], RATE, "SAME", row0=0, **epi)
                for s in range(CONV_S)])
            err = (got.float() - want.float()).abs().max().item()
            tol = rtol * max(1.0, want.float().abs().max().item())
            tag = "bf16" if out is not None else "f32"
            check(got.dtype == (out or torch.float32) and err <= tol,
                  f"{name} {where} {tag} out: {err} > {tol}")
            line[f"{tag}_out_err"] = err
            same &= all(torch.equal(got[s], mc.dropout_conv_inference(
                xs[s], w, seeds[s].contiguous(), RATE, "SAME", **epi))
                for s in range(CONV_S))
        check(same, f"{name} {where}: a sample differs from its single "
              "launch")
        line["samples_equal_single_bitwise"] = same
        emit(line)


def _pointwise_times(gen) -> None:
    """The 1x1 routine (``conv_mma_kernel_1x1``) timed by CUDA events
    over back-to-back calls (``events_ms``; below ~0.5 ms a call they time
    the host's dispatch) and by the profiler's device time (``ms``): row
    10R, the six RESNET50_SITE_CONVS launches as the resnet50 blocks
    predict makes them (batch BATCH, SAMPLES samples; stage 2's a samples
    launch, stages 3 and 4 on an x that carries the samples; the folded
    BatchNorm's (F,) bias, relu on convbn1, a bf16 store), and row 10r's
    three 1x1 stride-2 launches at RESNET_SITES (samples at site 1, _xs at
    sites 2 and 3, no activation); each beside its bound (the larger of
    its operations at the bf16 peak and its bytes, the pixels it reads
    once, the S outputs written once, at the HBM rate), cuDNN on the
    pre-masked input
    at batch S·N (which the port never calls) and the mask evaluations
    its launch implies (``mask_hashes``)."""
    import torch
    import torch.nn.functional as F
    from bayestpu_torch.kernels import masked_conv as mc
    from bayestpu_torch.utils import profiler
    bf16 = torch.bfloat16
    seeds = _inputs(dict(M=1, K=1, N=1, S=SAMPLES), torch.float32, gen)[2]
    convs = [("resnet50", hw, c, f, stride, act, carries)
             for hw, c, f, stride, act, carries in RESNET50_SITE_CONVS]
    convs += [("resnet18", hw, c, f, 2, None, i > 0)
              for i, (hw, c, f) in enumerate(RESNET_SITES)]
    total = 0.0
    for model, hw, c, f, stride, act, carries in convs:
        x, w, aff, _, _ = _conv_data((BATCH, hw, hw, c), 1, f, bf16, gen)
        if carries:
            x = torch.randn(SAMPLES, BATCH, hw, hw, c, generator=gen).to(
                bf16).cuda().permute(0, 1, 4, 2, 3)
        epi = dict(bias=aff[1], act=act, out_dtype=bf16, stride=stride)
        before = dict(profiler.counters())
        mc.dropout_conv_inference(x, w, seeds, RATE, "SAME", **epi)
        after = profiler.counters()
        launched = {k: after.get(k, 0) - before.get(k, 0)
                    for k in ("conv.pointwise_launches", "conv.mask_hashes")}
        check(launched["conv.pointwise_launches"] == 1,
              f"{model} {hw}x{hw}x{c} -> {f}: not on the 1x1 routine")
        run = lambda: mc.dropout_conv_inference(  # noqa: E731
            x, w, seeds, RATE, "SAME", **epi)
        ms, dev = cuda_ms(run, 10), device_ms(run, 20)
        xm = _cl(torch.cat([mc._hash_masked(x[s] if carries else x,
                                            seeds[s], RATE)
                            for s in range(SAMPLES)]))
        lib = cuda_ms(lambda: F.conv2d(xm, w, stride=stride), 10)
        ho = (hw - 1) // stride + 1
        ops = 2 * SAMPLES * BATCH * ho * ho * c * f
        # the input pixels the conv reads (one in four at stride 2), the
        # S outputs and w, each once
        nbytes = 2 * (BATCH * ho * ho * c * (SAMPLES if carries else 1)
                      + SAMPLES * BATCH * ho * ho * f + f * c)
        bound = max(ops / PEAK_FLOPS["bfloat16"],
                    nbytes / MEM_BYTES_PER_S) * 1e3
        if model == "resnet50":
            total += ms
        emit({"phase": "conv", "kernel": "conv_mma_kernel_1x1",
              "model": model, "shape": f"{hw}x{hw}x{c}_to_{f}_s{stride}",
              "launch": "dropout_conv_xs" if carries else
              "dropout_conv_samples", "events_ms": ms, "ms": dev,
              "bound_ms": bound,
              "tflops": ops / ms / 1e9, "library_ms": lib,
              "mask_hashes": launched["conv.mask_hashes"]})
        del xm
    emit({"phase": "conv", "kernel": "conv_mma_kernel_1x1",
          "resnet50_six_events_ms": total})


# the block-site models of the benchmark at ImageNet shapes: the counters
# of one forward (``_blocks_forward_counters``): fused masked convs, those
# on the 1x1 routine and on the window routine, the mask evaluations, the
# one-pass bf16 epilogues and those with a residual
BLOCKS_FORWARD = {
    "resnet50": {"sites.conv_launches": 6, "conv.pointwise_launches": 6,
                 "conv.window_launches": 0,
                 "conv.mask_hashes": 2_247_884_800,
                 "epilogue.launches": 47, "epilogue.residual_launches": 16},
    "resnet18": {"sites.conv_launches": 6, "conv.pointwise_launches": 3,
                 "conv.window_launches": 3,
                 "conv.mask_hashes": 606_699_520,
                 "epilogue.launches": 14, "epilogue.residual_launches": 8}}


def _blocks_forward_counters(gen, name: str) -> None:
    """One eager spatial predict of a BLOCKS_FORWARD model (ImageNet stem,
    block sites, MC before the classifier, bf16, batch BATCH, SAMPLES
    samples; the model's own initial weights) on the card, and the
    program's counters of it against BLOCKS_FORWARD: the fused masked
    convs, those on the 1x1 routine (resnet50: all six; resnet18: its
    three projections) and on the window routine (resnet18's three 3x3
    convbn1s), the mask evaluations their launches imply, and the one-pass
    bf16 epilogue's launches (``launch_counts``) and passes, those with the
    residual (a counter no launch moved reads 0)."""
    import torch
    from bayestpu_torch.core.config import BayesConfig
    from bayestpu_torch.engine.engine import BayesEngine
    from bayestpu_torch.nn.zoo import get_model
    from bayestpu_torch.utils import profiler
    expect = BLOCKS_FORWARD[name]
    model = get_model(name, bayes=BayesConfig(rate=RATE), fused=True,
                      dtype=torch.bfloat16, num_classes=1000,
                      input_shape=(224, 224, 3), n_exits=1, stem="imagenet",
                      dropout="block", dropout_exit=True).cuda().eval()
    engine = BayesEngine(model, model.bayes, device="cuda")
    engine.ready = True
    x = torch.randn(BATCH, 224, 224, 3, generator=gen).cuda()
    profiler.reset_spans()
    reset_counts()
    engine.predict(x, seed=7, num_samples=SAMPLES).probs.cpu()
    epilogues = launch_counts()["bias_act_bf16"]
    counts = {k: v for k, v in profiler.counters().items()
              if k.startswith(("conv.", "sites.", "epilogue."))}
    emit({"phase": "conv", "model": f"{name}_blocks", "batch": BATCH,
          "samples": SAMPLES, "counters": counts,
          "bias_act_bf16_launches": epilogues})
    check(all(counts.get(k, 0) == v for k, v in expect.items())
          and epilogues == expect["epilogue.launches"],
          f"{name} blocks forward counters {counts}, "
          f"{epilogues} bias_act_bf16 launches")
    del engine, model
    torch.cuda.empty_cache()


def phase_epilogue() -> dict:
    """The one-pass bf16 epilogue (``kernels.epilogue.bias_act_bf16``,
    ``bf16_epilogue_kernel``) at each RESNET50_EPILOGUES shape with its
    activation and residual: bit-equal to its plain version on the same
    card inputs; its time by CUDA events over back-to-back calls
    (``events_ms``) and by the profiler's device time (``ms``) beside its
    bound (4 bytes an element, 6 with the residual, at the HBM rate) and
    the plain version's time, which is the PyTorch op chain the kernel
    replaced (widen, bias, relu, round, and the residual's add and relu;
    no one PyTorch call computes the epilogue); then their sums over the
    47 convs of one forward, which it returns as the kernel's summary (the
    ``kernels`` line). Also ``--only epilogue``."""
    import torch
    from bayestpu_torch.kernels import epilogue as ep
    gen = torch.Generator(device="cuda").manual_seed(2025)
    bf16 = torch.bfloat16
    total = dict.fromkeys(("ms", "events_ms", "plain_ms", "bound_ms"), 0.0)
    for rows, hw, c, act, with_res, convs in RESNET50_EPILOGUES:
        def nhwc():
            return torch.randn(rows, hw, hw, c, generator=gen,
                               device="cuda").to(bf16).permute(0, 3, 1, 2)
        y = nhwc()
        res = nhwc() if with_res else None
        bias = torch.randn(c, generator=gen, device="cuda") * 0.5
        before = ep.launch_counts["bias_act_bf16"]
        same = torch.equal(ep.bias_act_bf16(y, bias, act, res),
                           ep.bias_act_bf16_plain(y, bias, act, res))
        where = f"{rows}x{hw}x{hw}x{c}"
        check(same and ep.launch_counts["bias_act_bf16"] == before + 1,
              f"bias_act_bf16 {where}: not bit-equal to its plain version")
        fn = lambda: ep.bias_act_bf16(y, bias, act, res)  # noqa: E731
        plain = lambda: ep.bias_act_bf16_plain(  # noqa: E731
            y, bias, act, res)
        line = {"events_ms": cuda_ms(fn, 20), "ms": device_ms(fn, 50),
                "plain_ms": cuda_ms(plain, 5),
                "bound_ms": y.numel() * (6 if with_res else 4)
                / MEM_BYTES_PER_S * 1e3}
        for k in total:
            total[k] += convs * line[k]
        emit({"phase": "epilogue", "kernel": "bf16_epilogue_kernel",
              "shape": where, "act": act, "residual": with_res,
              "convs": convs, "bit_equal": same, **line,
              "tb_per_s": y.numel() * (6 if with_res else 4)
              / line["ms"] / 1e9})
        del y, res
    emit({"phase": "epilogue", "kernel": "bf16_epilogue_kernel",
          "resnet50_forward": total})
    torch.cuda.empty_cache()
    # bit-equal at every shape (checked above); no one library call
    # computes the epilogue, so plain_ms is the op chain it replaced
    return {"bias_act_bf16": {**total, "max_abs_err": 0.0,
                              "bound_by": "bytes", "library_ms": None,
                              "shape": "resnet50_blocks forward, 47 convs"}}


def _conv_f32_route(gen, label: str, xshape, k: int, f: int, padding,
                    stride: int, mixes) -> None:
    """Row 10's f32 route (``conv_mma_kernel<TX, float, HashMask or
    NoMask>``: the masked x and w staged in f32, three TF32 products a k
    step) at one geometry, for each (x dtype, w dtype) of ``mixes``: the
    samples launch (CONV_S seeds, the (2, F) affine and relu), the single
    one without an epilogue, the _xs launch on x carrying CONV_S samples
    and ``conv_fused`` against their plain versions to CONV_RTOL, sample s
    of the samples and _xs launches bit-equal to the single launch; then
    the single launch as the f32 block site runs it (the (F,) bias and
    relu, f32 store) timed in TIMING_ROUNDS rounds that alternate it with
    cuDNN f32 (TF32 off) on the pre-masked x widened to f32, beside its
    plain version, its bound at the tf32 tensor cores' peak and at the f32
    one outside them, and (at block site 1 in f32) its time on the
    CUDA-core routine before (EARLIER_MS)."""
    import torch
    import torch.nn.functional as F
    from bayestpu_torch.kernels import masked_conv as mc
    n, hw, _, c = xshape
    seeds = _inputs(dict(M=1, K=1, N=1, S=CONV_S), torch.float32, gen)[2]
    s0 = seeds[0].contiguous()
    for xdt, wdt in mixes:
        x, _, aff, _, _ = _conv_data(xshape, k, f, xdt, gen)
        w = (torch.randn(f, c, k, k, generator=gen) / (k * k * c) ** 0.5
             ).to(wdt).cuda()
        x5 = _x5(xshape, xdt, gen)
        b, geo = aff[1], dict(padding=padding, stride=stride)
        mix = "_".join(str(d).split(".")[-1] for d in (xdt, wdt))
        line = {"phase": "kernels", "kernel": "dropout_conv", "route":
                "conv_mma_kernel f32 staging, three TF32 products",
                "shape": label, "x_nhwc": list(xshape), "k": k, "F": f,
                "padding": padding, "stride": stride, "mix": mix}
        ys = mc.dropout_conv_samples(x, w, seeds, RATE, bias=aff,
                                     act="relu", **geo)
        rs = mc.stack_samples([mc.dropout_conv_plain(
            x, w, seeds[s], RATE, padding, stride, aff, "relu")
            for s in range(CONV_S)])
        yx = mc.dropout_conv_inference(x5, w, seeds, RATE, bias=aff,
                                       act="relu", **geo)
        rx = mc.stack_samples([mc.dropout_conv_plain(
            x5[s], w, seeds[s], RATE, padding, stride, aff, "relu")
            for s in range(CONV_S)])
        same = all(torch.equal(ys[s], mc.dropout_conv_inference(
            x, w, seeds[s].contiguous(), RATE, bias=aff, act="relu", **geo))
            and torch.equal(yx[s], mc.dropout_conv_inference(
                x5[s], w, seeds[s].contiguous(), RATE, bias=aff,
                act="relu", **geo)) for s in range(CONV_S))
        check(same, f"f32 route {label} {mix}: sample s differs from the "
              "single launch")
        line["samples_equal_single_bitwise"] = same
        for name, got, want in (
                ("dropout_conv_samples", ys, rs),
                ("dropout_conv_xs", yx, rx),
                ("dropout_conv", mc.dropout_conv(x, w, s0, RATE, padding,
                                                 stride),
                 mc.dropout_conv_plain(x, w, s0, RATE, padding, stride)),
                ("conv_fused", mc.conv_fused(x, w, aff, "relu", **geo),
                 mc.conv_fused_plain(x, w, aff, "relu", **geo))):
            err = (got - want).abs().max().item()
            tol = CONV_RTOL * max(1.0, want.abs().max().item())
            check(got.dtype == torch.float32 and err <= tol,
                  f"{name} {label} {mix}: {err} > {tol}")
            line[f"{name}_err"] = err

        def kern():
            return mc.dropout_conv_inference(x, w, s0, RATE, bias=b,
                                             act="relu", **geo)

        xm = _cl(mc._hash_masked(x, s0, RATE).float())
        wf = w.float()
        t = _rounds({"ms": kern, "library_ms": lambda: F.conv2d(
            xm, wf, stride=stride, padding=k // 2)}, TIMING_ROUNDS, 100)
        t["plain_ms"] = device_ms(lambda: mc.dropout_conv_plain(
            x, w, s0, RATE, padding, stride, b, "relu"), 10)
        t["bound_ms"], t["bound_by"] = _conv_bound("dropout_conv", x, w, 1,
                                                   4, padding, stride)
        t["bound_f32_fma_ms"] = _conv_bound("dropout_conv", x, w, 1, 4,
                                            padding, stride,
                                            kind="float32")[0]
        if mix == "float32_float32" and label in EARLIER_MS:
            t["earlier_ms"] = EARLIER_MS[label]
        line.update(t, ms_over_library=t["ms"] / t["library_ms"],
                    ms_over_bound=t["ms"] / t["bound_ms"])
        emit(line)


def _alex_conv5(gen, summary: dict) -> None:
    """Row 10's f32 samples launch as AlexNet's conv5 site makes it at n
    = 4 (the f32 route, three TF32 products; batch ALEX_BATCH, S =
    SAMPLES, 12x12x384 -> 256, 3x3 SAME, the conv bias, no activation, f32
    store): against its plain version to CONV_RTOL, sample s bit-equal to
    the single launch, then timed in TIMING_ROUNDS rounds that alternate
    it with cuDNN f32 (TF32 off) on the S pre-masked inputs folded into
    the batch, beside its plain version, its bound at the tf32 tensor
    cores' peak and at the f32 one outside them, and its time on the
    CUDA-core routine before (EARLIER_MS)."""
    import torch
    import torch.nn.functional as F
    from bayestpu_torch.kernels import masked_conv as mc
    f32 = torch.float32
    hw, c, f = ALEX_CONV5
    x, w, aff, _, _ = _conv_data((ALEX_BATCH, hw, hw, c), 3, f, f32, gen)
    seeds = _inputs(dict(M=1, K=1, N=1, S=SAMPLES), f32, gen)[2]
    b = aff[1]

    def kern():
        return mc.dropout_conv_inference(x, w, seeds, RATE, bias=b)

    def plain():
        return mc.stack_samples([mc.dropout_conv_plain(
            x, w, seeds[s], RATE, "SAME", 1, b) for s in range(SAMPLES)])

    got, want = kern(), plain()
    ones = [mc.dropout_conv_inference(x, w, seeds[s].contiguous(), RATE,
                                      bias=b) for s in range(SAMPLES)]
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    tol = CONV_RTOL * max(1.0, want.abs().max().item())
    same = all(torch.equal(got[s], ones[s]) for s in range(SAMPLES))
    summary["dropout_conv_samples"]["max_abs_err"] = max(
        summary["dropout_conv_samples"]["max_abs_err"], err)
    check(got.dtype == f32 and err <= tol and same,
          f"f32 dropout_conv_samples at conv5: {err} > {tol} or samples vs "
          f"single bit identity {same}")
    # cuDNN's one call: the S pre-masked inputs folded into the batch
    xm = _cl(torch.cat([mc._hash_masked(x, seeds[s], RATE)
                        for s in range(SAMPLES)]))
    bound, by = _conv_bound("dropout_conv_samples", x, w, SAMPLES, 4)
    t = {**_rounds({"ms": kern, "library_ms": lambda: F.conv2d(
        xm, w, b, padding=1)}, TIMING_ROUNDS, CONV5_CALLS),
         "plain_ms": device_ms(plain, 3), "bound_ms": bound, "bound_by": by,
         "bound_f32_fma_ms": _conv_bound("dropout_conv_samples", x, w,
                                         SAMPLES, 4, kind="float32")[0],
         "earlier_ms": EARLIER_MS["alexnet_conv5"]}
    emit({"phase": "kernels", "kernel": "dropout_conv_samples",
          "route": "conv_mma_kernel f32 staging, three TF32 products",
          "shape": "alexnet_conv5",
          "dtype": "float32", "N": ALEX_BATCH, "H": hw, "C": c, "F": f,
          "S": SAMPLES, "max_abs_err": err, "tol": tol,
          "samples_equal_single_bitwise": same, **t,
          "ms_over_library": t["ms"] / t["library_ms"],
          "ms_over_bound": t["ms"] / t["bound_ms"]})


def _resnet_small_checks(gen) -> None:
    """Row 10's bf16 MC convs at resnet18's three deferred stage sites
    (convbn1 with relu and downsample with none, stride 2) at batch
    LENET_SMALL, as the lenet phase's ``resnet18(dropout="layer")`` route
    launches them: the _xs launch on x carrying SAMPLES samples (its
    spatial predict) and the single launch (its temporal one), each with
    the fold bias and a bf16 store, against its plain version to
    BF16_OUT_RTOL; sample s of the _xs launch bit-equal to the single
    launch on x[s] with seeds[s]. Checked, not timed."""
    import torch
    from bayestpu_torch.kernels import masked_conv as mc
    n, bf16 = LENET_SMALL, torch.bfloat16
    for hw, c, f in RESNET_SITES:
        for kname, (k, padding, act) in RESNET_CONVS.items():
            where = f"resnet_small_{hw}x{hw}x{c}_{kname}_s2"
            x, w, aff, _, _ = _conv_data((n, hw, hw, c), k, f, bf16, gen)
            b = aff[1]
            seeds = _inputs(dict(M=1, K=1, N=1, S=SAMPLES), torch.float32,
                            gen)[2]
            x5 = mc.stack_samples([_cl(torch.randn(
                n, c, hw, hw, generator=gen).to(bf16).cuda())
                for _ in range(SAMPLES)])
            epi = dict(bias=b, act=act, stride=2, out_dtype=bf16)
            line = {"phase": "kernels", "kernel": "masked_conv",
                    "shape": where, "x_nhwc": [n, hw, hw, c], "F": f, "k": k,
                    "padding": padding, "stride": 2, "samples": SAMPLES}
            yx = mc.dropout_conv_inference(x5, w, seeds, RATE, padding,
                                           **epi)
            singles = [mc.dropout_conv_inference(
                x5[s], w, seeds[s].contiguous(), RATE, padding, **epi)
                for s in range(SAMPLES)]
            same = all(torch.equal(yx[s], singles[s])
                       for s in range(SAMPLES))
            check(same, f"dropout_conv_xs {where}: sample s differs from "
                  "the single launch on x[s]")
            line["dropout_conv_xs_equals_single_bitwise"] = same
            for name, got, want in (
                    ("dropout_conv_xs", yx, mc.stack_samples([
                        mc.dropout_conv_plain(x5[s], w, seeds[s], RATE,
                                              padding, 2, b, act, bf16)
                        for s in range(SAMPLES)])),
                    ("dropout_conv", mc.dropout_conv_inference(
                        x, w, seeds[0].contiguous(), RATE, padding, **epi),
                     mc.dropout_conv_plain(x, w, seeds[0], RATE, padding, 2,
                                           b, act, bf16))):
                check(got.dtype == bf16, f"{name} {where}: bf16 store")
                err = (got.float() - want.float()).abs().max().item()
                tol = BF16_OUT_RTOL * max(1.0,
                                          want.float().abs().max().item())
                check(err <= tol, f"{name} {where}: {err} > {tol}")
                line[f"{name}_bf16out_err"] = err
            emit(line)


def _resnet_readout(gen) -> None:
    """One site, two convs: a deferred block's convbn1 (3x3, stride 2,
    RESNET_P3) and downsample (1x1, stride 2) read the same masked input.
    x = ones, w = the identity at the 3x3 kernel's centre tap and the 1x1
    identity: sample s of both is the mask at the even positions times the
    scale, bit for bit equal, and its nonzero pattern that of
    ``mask_apply_nhwc`` (the backward's mask) there; likewise the int8
    kernels, and the bank kernels on one bank row."""
    import torch
    from bayestpu_torch.kernels import masked_conv as mc
    n, h, wd, c = 2, 32, 32, 64
    seeds = _inputs(dict(M=1, K=1, N=1, S=CONV_S), torch.float32, gen)[2]
    idxs = torch.tensor(CONV_RAGGED_IDXS, dtype=torch.int32, device="cuda")
    bank, _ = _conv_banks(c)
    line = {"phase": "kernels", "kernel": "masked_conv",
            "shape": "resnet_shared_mask_readout", "x_nhwc": [n, h, wd, c]}
    for dtype in (torch.int8, torch.bfloat16, torch.float32):
        ones = _cl(torch.ones(n, c, h, wd, dtype=dtype, device="cuda"))
        eye1 = torch.eye(c, dtype=dtype, device="cuda")[:, :, None, None]
        eye3 = torch.nn.functional.pad(eye1, (1, 1, 1, 1))
        kw = dict(stride=2)
        if dtype == torch.int8:
            a, b = (mc.dropout_conv_int8_samples(ones, w, seeds, RATE, 1.0,
                                                 1.0, pad, **kw)
                    for w, pad in ((eye3, RESNET_P3), (eye1, "SAME")))
        else:
            a, b = (mc.dropout_conv_samples(ones, w, seeds, RATE, pad, **kw)
                    for w, pad in ((eye3, RESNET_P3), (eye1, "SAME")))
            ba, bb = (mc.bank_conv_samples(ones, w.float(), bank, idxs, pad,
                                           **kw)
                      for w, pad in ((eye3, RESNET_P3), (eye1, "SAME")))
            check(torch.equal(ba, bb), f"bank convbn1 vs downsample {dtype}")
        applied = torch.stack([mc.mask_apply_nhwc(
            ones.float(), seeds[s].contiguous(), RATE)[..., ::2, ::2]
            for s in range(CONV_S)])
        vals = sorted(set(a.float().unique().tolist()))
        ok = torch.equal(a, b) and torch.equal(a != 0, applied != 0)
        check(ok and len(vals) == 2, f"resnet shared mask readout {dtype}: "
              f"equal {torch.equal(a, b)}, values {vals}")
        line[str(dtype).split(".")[-1]] = {
            "convbn1_equals_downsample": True, "values": vals,
            "equals_dropout_apply_mask": True,
            "keep_fraction": (a != 0).float().mean().item()}
    emit(line)


def phase_slice() -> dict:
    import torch
    from bayestpu_torch.core.config import (BayesConfig, EngineConfig,
                                            SamplingMode)
    from bayestpu_torch.engine import sampler
    from bayestpu_torch.engine.engine import BayesEngine
    from bayestpu_torch.nn.zoo import get_model

    def build(mode: SamplingMode, device: str) -> BayesEngine:
        model = get_model("vgg11_me", bayes=BayesConfig(rate=RATE),
                          fused=True, dtype=torch.bfloat16)
        return BayesEngine(model, config=EngineConfig(mode=mode),
                           device=device).init(0, x_cpu[:1])

    gen = torch.Generator().manual_seed(7)
    x_cpu = torch.randn(BATCH, 32, 32, 3, generator=gen)
    x = x_cpu.cuda()
    sp = build(SamplingMode.SPATIAL, "cuda")
    tm = build(SamplingMode.TEMPORAL, "cuda")
    seed = 11

    def host_loop():
        return sum(sp.predict(x, seed, sample_idx=i)
                   for i in range(SAMPLES)) / SAMPLES

    sp.predict(x, seed, SAMPLES)      # warm-up: cuDNN plans, allocator
    tm.predict(x, seed, SAMPLES)
    torch.cuda.synchronize()

    # ---- the main path, counted: spatial, temporal, host loop
    reset_counts()
    p_sp = sp.predict(x, seed, SAMPLES)
    torch.cuda.synchronize()
    after_sp = launch_counts()
    p_tm = tm.predict(x, seed, SAMPLES)
    torch.cuda.synchronize()
    after_tm = launch_counts()
    p_loop = host_loop()
    torch.cuda.synchronize()
    launches = launch_counts()
    n_heads = sp.model.num_sites
    check(n_heads == 5, f"vgg11_me has {n_heads} MC sites")
    check(after_sp == counts(dropout_matmul_samples=5,
                             bias_act_bf16=VGG11_ME_CONVS),
          f"spatial predict launches {after_sp}")
    check(after_tm == counts(dropout_matmul=5 * SAMPLES,
                             dropout_matmul_samples=5,
                             bias_act_bf16=(1 + SAMPLES) * VGG11_ME_CONVS),
          f"temporal predict launches {after_tm}")
    check(launches == counts(dropout_matmul=10 * SAMPLES,
                             dropout_matmul_samples=5,
                             bias_act_bf16=(1 + 2 * SAMPLES)
                             * VGG11_ME_CONVS),
          f"host loop launches {launches}")

    for name, p in (("spatial", p_sp.probs), ("temporal", p_tm.probs),
                    ("host_loop", p_loop)):
        check(p.shape == (5, BATCH, 10), f"{name} probs shape {p.shape}")
        check(bool(torch.isfinite(p).all()), f"{name} probs finite")
        dev = (p.sum(-1) - 1).abs().max().item()
        check(dev < 1e-5, f"{name} probs sum to 1 (off by {dev})")
    d_tm = (p_sp.probs - p_tm.probs).abs().max().item()
    d_loop = (p_sp.probs - p_loop).abs().max().item()
    check(d_tm < 1e-5 and d_loop < 1e-5,
          f"predictive probs: spatial vs temporal {d_tm}, host loop {d_loop}")

    # ---- per-sample logits: spatial vs temporal, and rows 0-7 vs the CPU
    with torch.inference_mode():
        seeds = sp.seeds(seed, SAMPLES)
        l_sp = sampler.mc_logits(sp.model, x, seeds, SamplingMode.SPATIAL)
        l_tm = sampler.mc_logits(sp.model, x, seeds, SamplingMode.TEMPORAL)
        cpu = build(SamplingMode.SPATIAL, "cpu")
        l_cpu = sampler.mc_logits(cpu.model, x_cpu[:8], seeds.cpu(),
                                  SamplingMode.SPATIAL)
    d_st = (l_sp - l_tm).abs().max().item()
    check(d_st <= SPATIAL_TEMPORAL_ATOL,
          f"spatial vs temporal logits {d_st} > {SPATIAL_TEMPORAL_ATOL}")
    d_cpu = (l_sp[:, :, :8].cpu() - l_cpu).abs().max().item()
    cpu_tol = CPU_REF_RTOL * max(1.0, l_cpu.abs().max().item())
    check(d_cpu <= cpu_tol, f"card vs CPU rows 0-7: {d_cpu} > {cpu_tol}")

    # ---- times
    spatial_ms = host_ms(lambda: sp.predict(x, seed, SAMPLES), 30)
    temporal_ms = host_ms(lambda: tm.predict(x, seed, SAMPLES), 10)
    loop_ms = host_ms(host_loop, 10)
    emit({"phase": "slice", "model": "vgg11_me", "dtype": "bfloat16",
          "batch": BATCH, "samples": SAMPLES, "rate": RATE,
          "launches_main_path": launches,
          "launches_spatial_predict": after_sp,
          "spatial_vs_temporal_logits_max_abs": d_st,
          "spatial_temporal_bit_identical": bool(torch.equal(l_sp, l_tm)),
          "spatial_vs_temporal_probs_max_abs": d_tm,
          "spatial_vs_host_loop_probs_max_abs": d_loop,
          "card_vs_cpu_rows0_7_logits_max_abs": d_cpu,
          "card_vs_cpu_tol": cpu_tol,
          "spatial_p50_ms": spatial_ms,
          "mc_samples_per_s": BATCH * SAMPLES / (spatial_ms / 1e3),
          "temporal_p50_ms": temporal_ms,
          "host_loop_p50_ms": loop_ms,
          "final_exit_mean_max_prob":
              p_sp.probs[-1].max(-1).values.mean().item()})
    return {"launches": launches, "engine": sp, "x": x, "seed": seed}


def _profile_rows(prof, reps: int) -> list:
    """(ms per rep, launches per rep, kernel name) of every CUDA kernel
    seen by the profiler (not the CPU ops, nor the device ranges of the
    program's spans: ``device_events``), largest first."""
    rows = [(ev.self_device_time_total / reps / 1e3, ev.count // reps, ev.key)
            for ev in device_events(prof)]
    return sorted(rows, reverse=True)


def _by_group(rows: list) -> dict:
    """Device ms and launches by kind of kernel: the port's own, cuDNN
    convolutions (forward, data and weight gradients), cuBLAS matmuls,
    PyTorch reductions, PyTorch elementwise and copy kernels, the rest."""
    groups: dict[str, dict] = {}
    for ms, calls, key in rows:
        k = key.lower()
        port = any(name in k for name in PORT_KERNELS)
        group = ("port kernels" if port else
                 "convolutions" if any(w in k for w in (
                     "fprop", "dgrad", "wgrad", "conv")) else
                 "matmuls" if "gemm" in k or "cutlass" in k else
                 "reductions" if "reduce_kernel" in k else
                 "elementwise" if "elementwise" in k or "copy" in k else
                 "other")
        g = groups.setdefault(group, {"ms": 0.0, "launches": 0})
        g["ms"] += ms
        g["launches"] += calls
    return groups


def phase_profile(sl: dict) -> None:
    """Device time by kernel over spatial predicts, beside the host clock."""
    emit({"phase": "profile", "what": "spatial predict, profiled",
          **_profile_predict(sl["engine"], sl["x"], sl["seed"])})


def _profile_predict(eng, x, seed: int, reps: int = 10,
                     samples: int = SAMPLES) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            eng.predict(x, seed, samples)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    rows = _profile_rows(prof, reps)
    dev_ms = sum(r[0] for r in rows)
    return {"wall_ms_per_predict": wall_ms,
            "device_ms_per_predict": dev_ms if rows else "not measured",
            "device_busy_share": dev_ms / wall_ms if rows else "not measured",
            "kernel_launches_per_predict": sum(r[1] for r in rows),
            "by_group": _by_group(rows),
            "top": [{"ms": r[0], "calls": r[1], "kernel": r[2][:90]}
                    for r in rows[:12]]}


def phase_backward() -> None:
    """torch.autograd through dropout_matmul on the card against
    dropout_matmul_vjp_plain on the same card tensors, at the head shape:
    one forward launch and two dropout_apply launches per backward, dx
    exactly 0 wherever the mask drops."""
    import torch
    from bayestpu_torch.kernels import masked_matmul as mm
    gen = torch.Generator().manual_seed(99)
    m, k, n = HEAD["M"], HEAD["K"], HEAD["N"]
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        x, w, seeds = _inputs(HEAD, dtype, gen)
        s0 = seeds[0].contiguous()                   # negative seeds
        g = torch.randn(m, n, generator=gen).cuda()
        xr = x.clone().requires_grad_(True)
        wr = w.clone().requires_grad_(True)
        before = launch_counts()
        dx, dw = torch.autograd.grad(mm.dropout_matmul(xr, wr, s0, RATE),
                                     (xr, wr), g)
        torch.cuda.synchronize()
        launched = {kk: launch_counts()[kk] - before[kk] for kk in before}
        px, pw = mm.dropout_matmul_vjp_plain(x, w, s0, RATE, g)
        line = {"phase": "backward", "shape": "head", **HEAD,
                "dtype": name, "rate": RATE, "launches": launched}
        for what, got, ref in (("dx", dx, px), ("dw", dw, pw)):
            err = (got.float() - ref.float()).abs().max().item()
            tol = BWD_RTOL[name] * ref.float().abs().max().item()
            check(got.dtype == ref.dtype == dtype and err <= tol,
                  f"backward {what} {name}: {err} > {tol}")
            line[f"{what}_max_abs_err"] = err
            line[f"{what}_tol"] = tol
        keep = mm.keep_mask(s0, m, k, RATE)
        dropped_zero = bool((dx[~keep] == 0).all())
        check(dropped_zero, f"backward dx nonzero where dropped {name}")
        check(launched == counts(dropout_matmul=1, dropout_apply=2),
              f"backward launches {launched}")
        line["dx_zero_where_dropped"] = dropped_zero
        emit(line)
    _conv_backward(gen)


def _conv_backward(gen) -> None:
    """torch.autograd through dropout_conv at the block-1 site shape
    against dropout_conv_vjp_plain on the same card tensors: one forward
    launch and two dropout_apply launches (the regenerated mask of x and of
    dxm) per backward, dx exactly 0 wherever the mask drops."""
    import torch
    from bayestpu_torch.kernels import masked_conv as mc
    hw, c, f = CONV_SITES[0]
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype).split(".")[-1]
        x, w, _, _, _ = _conv_data((BATCH, hw, hw, c), 3, f, dtype, gen)
        s0 = _inputs(dict(M=1, K=1, N=1, S=1), torch.float32, gen)[2][0]
        g = _cl(torch.randn(BATCH, f, hw, hw, generator=gen).cuda())
        xr = x.clone().requires_grad_(True)
        wr = w.clone().requires_grad_(True)
        before = launch_counts()
        dx, dw = torch.autograd.grad(mc.dropout_conv(xr, wr, s0, RATE),
                                     (xr, wr), g)
        torch.cuda.synchronize()
        launched = {kk: launch_counts()[kk] - before[kk] for kk in before}
        px, pw = mc.dropout_conv_vjp_plain(x, w, s0, RATE, g)
        line = {"phase": "backward", "shape": "site1",
                "x_nhwc": [BATCH, hw, hw, c], "F": f, "dtype": name,
                "rate": RATE, "launches": {k: v for k, v in launched.items()
                                           if v}}
        for what, got, ref in (("dx", dx, px), ("dw", dw, pw)):
            err = (got.float() - ref.float()).abs().max().item()
            tol = BWD_RTOL[name] * ref.float().abs().max().item()
            check(got.dtype == ref.dtype == dtype and err <= tol,
                  f"conv backward {what} {name}: {err} > {tol}")
            line[f"{what}_max_abs_err"] = err
            line[f"{what}_tol"] = tol
        keep = mc.keep_mask_nchw(s0, x, RATE)
        dropped_zero = bool((dx[~keep] == 0).all())
        check(dropped_zero, f"conv backward dx nonzero where dropped {name}")
        check(launched == counts(dropout_conv=1, dropout_apply=2),
              f"conv backward launches {launched}")
        line["dx_zero_where_dropped"] = dropped_zero
        emit(line)




def phase_train() -> dict:
    """The training slice: vgg11_me at full width, bf16, batch 128, rate
    0.25, the flagship recipe of ``bench.py:106-108`` (SGD 0.9, cosine LR
    from 0.05 over the run, clip 10), on 10,000 hard synthetic CIFAR-10
    images, every epoch in the same batch order, as the JAX bench."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from bayestpu_torch.core.config import BayesConfig
    from bayestpu_torch.core.rng import step_seeds
    from bayestpu_torch.data.datasets import get_dataset, iterate_batches
    from bayestpu_torch.engine.engine import BayesEngine
    from bayestpu_torch.nn.zoo import get_model
    from bayestpu_torch.train import optim
    from bayestpu_torch.train.loop import (create_state, make_train_step,
                                           train_loop)

    def build():
        return get_model("vgg11_me", bayes=BayesConfig(rate=RATE),
                         fused=True, dtype=torch.bfloat16)

    def flagship_tx(total_steps: int):
        return optim.chain(optim.clip_by_global_norm(TRAIN_CLIP), optim.sgd(
            optim.cosine_decay_schedule(TRAIN_LR, total_steps), 0.9))

    t0 = time.perf_counter()
    ds = get_dataset("cifar10", synth_difficulty="hard")
    data_s = time.perf_counter() - t0
    nb = len(ds.x_train) // BATCH
    steps = TRAIN_EPOCHS * nb
    xs = torch.from_numpy(ds.x_train[:nb * BATCH]).cuda().reshape(
        (nb, BATCH) + ds.x_train.shape[1:])
    ys = torch.from_numpy(ds.y_train[:nb * BATCH]).long().cuda().reshape(
        nb, BATCH)
    seed = 0
    model = build()
    tx = flagship_tx(steps)
    state = create_state(model, tx, seed, ds.x_train[:BATCH])
    step = make_train_step(model, tx)
    seeds = step_seeds(seed, range(steps), model.num_sites).cuda()
    losses, step_ms, first_step = [], [], {}

    def run(idx, timed: bool) -> None:
        for i in idx:
            t = time.perf_counter()
            losses.append(step(state, xs[i % nb], ys[i % nb],
                               seeds[i])["loss"])
            if i == 0:
                first_step.update(launch_counts())
            if timed:
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t) * 1e3)

    # ---- the main path, counted: 2 epochs of make_train_step
    # epoch 1 untimed; epoch 2 timed step by step (host clock ending in a
    # synchronise), but for three profiled steps a little way in; epochs
    # 3.. run free and give the throughput
    prof_steps, p0 = 3, nb + min(20, nb // 2)
    reset_counts()
    t_train = time.perf_counter()
    run(range(0, nb), False)
    run(range(nb, p0), True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run(range(p0, p0 + prof_steps), False)
        torch.cuda.synchronize()
        prof_wall_ms = (time.perf_counter() - t) * 1e3 / prof_steps
    run(range(p0 + prof_steps, 2 * nb), True)
    torch.cuda.synchronize()
    t = time.perf_counter()
    run(range(2 * nb, steps), False)
    torch.cuda.synchronize()
    free_s = time.perf_counter() - t
    train_s = time.perf_counter() - t_train
    launches = launch_counts()
    check(first_step == counts(dropout_matmul=5, dropout_apply=10),
          f"launches of one training step {first_step}")
    check(launches == counts(dropout_matmul=5 * steps,
                             dropout_apply=10 * steps),
          f"training launches {launches} over {steps} steps")
    loss = torch.stack(losses).float().cpu().numpy()
    check(bool(np.isfinite(loss).all()), "training loss finite")
    first10, last10 = float(loss[:10].mean()), float(loss[-10:].mean())
    check(last10 < first10, f"training loss fell: {first10} -> {last10}")
    rows = _profile_rows(prof, prof_steps)
    dev_ms = sum(r[0] for r in rows)
    check(dev_ms > 0, "the profiler saw no device time in a training step")
    p50 = statistics.median(step_ms)
    emit({"phase": "train", "model": "vgg11_me", "dtype": "bfloat16",
          "batch": BATCH, "rate": RATE, "epochs": TRAIN_EPOCHS,
          "steps": steps, "lr": TRAIN_LR, "clip": TRAIN_CLIP,
          "data": "cifar10 synthetic hard" if ds.meta["synthetic"]
          else "cifar10 files", "data_seconds": data_s,
          "launches_main_path": launches,
          "launches_per_step": {kk: v / steps for kk, v in launches.items()},
          "train_seconds": train_s,
          "train_step_p50_ms": p50,
          "train_step_min_ms": min(step_ms), "timed_steps": len(step_ms),
          "train_images_per_s": (steps - 2 * nb) * BATCH / free_s,
          "train_images_per_s_of_p50": BATCH / (p50 / 1e3),
          "profiled_step_wall_ms": prof_wall_ms,
          "device_ms_per_step": dev_ms,
          "device_busy_share": dev_ms / prof_wall_ms,
          "device_busy_share_of_p50": dev_ms / p50,
          "kernel_launches_per_step": sum(r[1] for r in rows),
          "by_group": _by_group(rows),
          "top": [{"ms": r[0], "calls": r[1], "kernel": r[2][:90]}
                  for r in rows[:12]],
          "first_loss": float(loss[0]), "final_loss": float(loss[-1]),
          "first10_mean_loss": first10, "last10_mean_loss": last10,
          "epoch_mean_loss": loss.reshape(TRAIN_EPOCHS, nb).mean(1).tolist()})

    # ---- train_loop, as the CLI trains: one epoch with validation on a
    # fresh model, reshuffled, counted on its own
    model2 = build()
    tx2 = flagship_tx(nb)
    state2 = create_state(model2, tx2, 1, ds.x_train[:BATCH])
    hist: dict = {}
    n_val = 4
    reset_counts()
    t = time.perf_counter()
    train_loop(model2, state2, tx2,
               lambda: iterate_batches(ds.x_train, ds.y_train, BATCH, seed=1),
               1, 1, val_batches=lambda: iterate_batches(
                   ds.x_test[:250 * n_val], ds.y_test[:250 * n_val], 250,
                   shuffle=False),
               reshuffle=True, history=hist, log_fn=lambda msg: None)
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t
    loop_launches = launch_counts()
    check(loop_launches == counts(dropout_matmul=5 * (nb + n_val),
                                  dropout_apply=10 * nb,
                                  bias_act_bf16=VGG11_ME_CONVS * n_val),
          f"train_loop launches {loop_launches}")
    check(state2.step == nb and len(hist["train_loss"]) == 1
          and np.isfinite(hist["train_loss"][0]),
          f"train_loop history {hist}")
    emit({"phase": "train_loop", "epochs": 1, "steps": state2.step,
          "val_batches": n_val, "seconds": loop_s,
          "launches": loop_launches, "history": hist})

    # ---- the trained weights, served
    eng = BayesEngine(build(), device="cuda").attach(state.variables())
    x_te, y_te = ds.x_test[:2000], ds.y_test[:2000]
    t = time.perf_counter()
    mets = eng.evaluate(x_te, y_te, seed=0, num_samples=SAMPLES,
                        ood_check=True, dataset="cifar10")
    eval_s = time.perf_counter() - t
    check(all(np.isfinite(v) for v in mets.values()),
          f"trained metrics finite {mets}")
    reset_counts()
    pred = eng.predict(x_te[:BATCH], 0, SAMPLES)
    torch.cuda.synchronize()
    serve_launches = launch_counts()
    check(serve_launches == counts(dropout_matmul_samples=5,
                                   bias_act_bf16=VGG11_ME_CONVS),
          f"spatial predict of the trained weights {serve_launches}")
    check(pred.probs.shape == (5, BATCH, 10)
          and bool(torch.isfinite(pred.probs).all()), "trained predictive")
    emit({"phase": "trained_eval", "test_images": len(x_te),
          "samples": SAMPLES, "seconds": eval_s, **mets,
          "spatial_predict_launches": serve_launches,
          "final_exit_mean_max_prob":
              pred.probs[-1].max(-1).values.mean().item()})
    return {"launches": launches, "variables": state.variables(),
            "mets": mets, "engine": eng, "ds": ds, "xs": xs, "ys": ys}


def _launched(fn):
    """``fn()`` and the launches of each kernel during it."""
    import torch
    before = launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, {k: launch_counts()[k] - before[k] for k in before}


def phase_int8(tr: dict) -> dict:
    """The int8 operating point as ``bench.py`` builds it (``:664-715``):
    QAT fine-tune of the trained float weights with ``QuantConfig(8, 0)``
    (6 epochs, SGD 0.9, cosine LR from 0.01, clip 10, batch 128, bf16,
    rate 0.25, fresh optimizer state), BatchNorm re-estimated with frozen
    parameters, then served through ``BayesEngine`` on the int8 model (its
    five MC heads on the int8 kernels) and, for attribution, on the
    fake-quant model, and gated against the bf16 point."""
    import numpy as np
    import torch
    from bayestpu_torch.core.config import (BayesConfig, EngineConfig,
                                            QuantConfig, SamplingMode)
    from bayestpu_torch.core.quant import fake_quant
    from bayestpu_torch.core.rng import step_seeds
    from bayestpu_torch.engine import sampler
    from bayestpu_torch.engine.engine import BayesEngine
    from bayestpu_torch.interop.from_flax import load_flax_variables
    from bayestpu_torch.nn.fused import BayesDense
    from bayestpu_torch.nn.zoo import get_model
    from bayestpu_torch.train import optim
    from bayestpu_torch.train.loop import (TrainState, bn_reestimate,
                                           make_train_step)

    qat_q = QuantConfig(8, 0)
    int8_q = QuantConfig(8, 0, int8_infer=True)

    def build(quant):
        return get_model("vgg11_me", bayes=BayesConfig(rate=RATE),
                         fused=True, dtype=torch.bfloat16, quant=quant)

    ds, xs, ys = tr["ds"], tr["xs"], tr["ys"]
    nb = xs.shape[0]
    steps = QAT_EPOCHS * nb
    seed = 0
    # ---- the main path, counted: QAT, BN re-estimation, serving
    reset_counts()
    # warm start (bench.py:113-121): the float parameters and BN
    # statistics, a fresh optimizer state
    model = load_flax_variables(build(qat_q), tr["variables"]).cuda().train()
    tx = optim.chain(optim.clip_by_global_norm(TRAIN_CLIP), optim.sgd(
        optim.cosine_decay_schedule(QAT_LR, steps), 0.9))
    state = TrainState(model, tx.init(dict(model.named_parameters())))
    step = make_train_step(model, tx)
    seeds = step_seeds(seed, range(steps), model.num_sites).cuda()
    losses, step_ms = [], []
    t_qat = time.perf_counter()
    for i in range(steps):
        # epoch 1 untimed, epoch 2 step by step (host clock ending in a
        # synchronise), the rest free-running for the throughput
        t = time.perf_counter()
        losses.append(step(state, xs[i % nb], ys[i % nb], seeds[i])["loss"])
        if nb <= i < 2 * nb:
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
            t_free = time.perf_counter()
    torch.cuda.synchronize()
    free_s = time.perf_counter() - t_free
    qat_s = time.perf_counter() - t_qat
    qat_launches = launch_counts()
    check(qat_launches == counts(dropout_matmul=5 * steps,
                                 dropout_apply=10 * steps),
          f"QAT launches {qat_launches} over {steps} steps")
    loss = torch.stack(losses).float().cpu().numpy()
    check(bool(np.isfinite(loss).all()), "QAT loss finite")
    t = time.perf_counter()
    _, bn_launches = _launched(lambda: bn_reestimate(
        model, list(xs), seeds[0], passes=BN_PASSES))
    bn_s = time.perf_counter() - t
    check(bn_launches == counts(dropout_matmul=5 * BN_PASSES * nb),
          f"BN re-estimation launches {bn_launches}")
    variables = state.variables()
    p50 = statistics.median(step_ms)
    emit({"phase": "qat", "model": "vgg11_me", "quant": "QuantConfig(8, 0)",
          "dtype": "bfloat16", "batch": BATCH, "rate": RATE,
          "epochs": QAT_EPOCHS, "steps": steps, "lr": QAT_LR,
          "clip": TRAIN_CLIP, "warm_start": "trained float weights",
          "launches": qat_launches, "qat_seconds": qat_s,
          "qat_step_p50_ms": p50, "qat_step_min_ms": min(step_ms),
          "qat_images_per_s": (steps - 2 * nb) * BATCH / free_s,
          "qat_images_per_s_of_p50": BATCH / (p50 / 1e3),
          "first_loss": float(loss[0]), "final_loss": float(loss[-1]),
          "epoch_mean_loss": loss.reshape(QAT_EPOCHS, nb).mean(1).tolist(),
          "bn_reestimate_passes": BN_PASSES, "bn_reestimate_seconds": bn_s,
          "bn_reestimate_launches": bn_launches})

    i8 = BayesEngine(build(int8_q), device="cuda").attach(variables)
    i8_tm = BayesEngine(build(int8_q), config=EngineConfig(
        mode=SamplingMode.TEMPORAL), device="cuda").attach(variables)
    fq = BayesEngine(build(qat_q), device="cuda").attach(variables)
    x_te, y_te = ds.x_test[:2000], ds.y_test[:2000]
    served, side = {}, {}
    for name, eng, want in (
            ("int8", i8, counts(dropout_matmul_int8_samples=10,
                                conv_int8_fused=2 * VGG11_ME_INT8_CONVS)),
            ("fake_quant", fq, counts(dropout_matmul_samples=10))):
        t = time.perf_counter()
        mets, launched = _launched(lambda: eng.evaluate(
            x_te, y_te, seed=0, num_samples=SAMPLES, ood_check=True,
            dataset="cifar10"))
        check(launched == want, f"{name} evaluate launches {launched}")
        check(all(np.isfinite(v) for v in mets.values()),
              f"{name} metrics finite {mets}")
        served[name] = {**mets, "seconds": time.perf_counter() - t}
        if name == "fake_quant":
            side = launched
    # the int8 model predicts far above chance: folding BN into the
    # quantized kernel made the JAX package's QAT model collapse to 0.15
    # in eval mode (fused.py:279-290)
    check(served["int8"]["acc"] >= 0.5, f"int8 accuracy {served['int8']}")
    x = xs[0]
    p_sp, sp_launches = _launched(lambda: i8.predict(x, seed, SAMPLES))
    p_tm, tm_launches = _launched(lambda: i8_tm.predict(x, seed, SAMPLES))
    check(sp_launches == counts(dropout_matmul_int8_samples=5,
                                conv_int8_fused=VGG11_ME_INT8_CONVS),
          f"int8 spatial predict launches {sp_launches}")
    check(tm_launches == counts(
        dropout_matmul_int8=5 * SAMPLES,
        conv_int8_fused=VGG11_ME_INT8_CONVS * SAMPLES),
          f"int8 temporal predict launches {tm_launches}")
    for name, p in (("spatial", p_sp.probs), ("temporal", p_tm.probs)):
        check(p.shape == (5, BATCH, 10) and bool(torch.isfinite(p).all()),
              f"int8 {name} probs")
        check((p.sum(-1) - 1).abs().max().item() < 1e-5,
              f"int8 {name} probs sum to 1")
    d_probs = (p_sp.probs - p_tm.probs).abs().max().item()
    check(d_probs < 1e-5, f"int8 spatial vs temporal probs {d_probs}")
    with torch.inference_mode():
        sd = i8.seeds(seed, SAMPLES)
        l_sp = sampler.mc_logits(i8.model, x, sd, SamplingMode.SPATIAL)
        l_tm = sampler.mc_logits(i8.model, x, sd, SamplingMode.TEMPORAL)
        cpu = BayesEngine(_card_route(build(int8_q)),
                          device="cpu").attach(variables)
        l_cpu = sampler.mc_logits(cpu.model, x[:8].cpu(), sd.cpu(),
                                  SamplingMode.SPATIAL)
    # the main path: QAT, BN re-estimation and int8 serving; the fake-quant
    # evaluate is attribution, not serving
    launches = {k: v - side[k] for k, v in launch_counts().items()}
    d_st = (l_sp - l_tm).abs().max().item()
    check(d_st <= SPATIAL_TEMPORAL_ATOL,
          f"int8 spatial vs temporal logits {d_st}")
    d_rows = (l_sp[:, :, :8].cpu() - l_cpu).abs()
    d_cpu = d_rows.max().item()
    cpu_tol = INT8_CPU_STEPS * 2.0 ** -7 * max(
        torch.linalg.vector_norm(fake_quant(h.kernel, int8_q), dim=0).max()
        .item() for h in cpu.model.modules()
        if isinstance(h, BayesDense)) / (1.0 - RATE)
    check(d_cpu <= cpu_tol, f"int8 card vs CPU rows 0-7: {d_cpu} > {cpu_tol}")

    bf = tr["mets"]
    i8m = served["int8"]
    gate = {"acc_gap": bf["acc"] - i8m["acc"],
            "ece_ratio": i8m["ece_hist"] / max(bf["ece_hist"], 1e-9),
            "ape_ratio": i8m["aPE_ood"] / max(bf["aPE_ood"], 1e-9),
            "gates": INT8_GATE}
    gate["pass"] = bool(gate["acc_gap"] <= INT8_GATE["acc_gap_max"]
                        and gate["ece_ratio"] <= INT8_GATE["ece_ratio_max"]
                        and gate["ape_ratio"] >= INT8_GATE["ape_ratio_min"])

    # ---- times: the int8 and bf16 spatial predicts of the trained
    # weights, in turns (bf16, int8, int8, bf16) in this one call
    bf16_eng = tr["engine"]
    order = [("bf16", bf16_eng), ("int8", i8), ("int8", i8), ("bf16", bf16_eng)]
    p50s: dict = {"bf16": [], "int8": []}
    for name, eng in order:
        p50s[name].append(host_ms(lambda: eng.predict(x, seed, SAMPLES), 15))
    int8_ms, bf16_ms = statistics.mean(p50s["int8"]), statistics.mean(
        p50s["bf16"])
    emit({"phase": "int8", "model": "vgg11_me", "quant": "INT8_Q = "
          "QuantConfig(8, 0, int8_infer=True)", "dtype": "bfloat16",
          "batch": BATCH, "samples": SAMPLES, "rate": RATE,
          "test_images": len(x_te), "served": served, "bf16": bf,
          "gate_vs_bf16": gate, "launches_main_path": launches,
          "launches_spatial_predict": sp_launches,
          "launches_temporal_predict": tm_launches,
          "spatial_vs_temporal_probs_max_abs": d_probs,
          "spatial_vs_temporal_logits_max_abs": d_st,
          "spatial_temporal_bit_identical": bool(torch.equal(l_sp, l_tm)),
          "card_vs_cpu_rows0_7_logits_max_abs": d_cpu,
          "card_vs_cpu_tol": cpu_tol,
          "card_vs_cpu_rows_differing": int(
              (d_rows.amax(dim=(0, 1, 3)) > 0).sum()),
          "int8_spatial_p50_ms": int8_ms, "bf16_spatial_p50_ms": bf16_ms,
          "int8_over_bf16": int8_ms / bf16_ms, "p50_ms_by_turn": p50s,
          "int8_mc_samples_per_s": BATCH * SAMPLES / (int8_ms / 1e3)})
    emit({"phase": "int8_profile", "what": "int8 spatial predict, profiled",
          **_profile_predict(i8, x, seed)})
    return {"launches": launches, "variables": variables,
            "mets": served["int8"]}


ANALYSIS_BATCH = 250       # FullAnalysis's batch (analysis.py:94)
ANALYSIS_TEST = 2000       # the flagship's test images
ANALYSIS_PASSES = range(1, 50)                 # results_analyzer.py:73-92
FLOPS_IMAGES = 500         # the vgg19_me FLOPs table's seeded images
KDE_RTOL = 1e-9            # native KDE-ECE against numpy (test_native.py)
QUANTIZE_LATE = {"block0": None, "block1": None}   # exp_quantize_late.py
# the shapes at which the analysis phase alone launches row 3, held in the
# kernels phase against the plain version in bf16 (the models' dtype), each
# sample bit-equal to the single launch, not timed: the flagship's heads at
# FullAnalysis's batch in run() (S = SAMPLES) and in the 1-49 pass sweep
# (S = 49), and vgg19_me's CIFAR-100 heads there
ANALYSIS_SHAPES = (
    ("analysis_head", {**HEAD, "M": ANALYSIS_BATCH}),
    ("analysis_sweep_head", {**HEAD, "M": ANALYSIS_BATCH,
                             "S": max(ANALYSIS_PASSES)}),
    ("analysis_vgg19_head", {**RESNET_HEAD, "M": ANALYSIS_BATCH}))
# rows of each analysed model held against the same model on the CPU, and
# the vgg19_me table's planted rows: row r is confident at exit e with
# confidence c, (e, c) = PLANTED[r], and the model's own near-uniform before
# it, so that rows leave at each exit the table may take (1-3; exit 0 is not
# taken, first_exit = 1) and the FLOPs differ between thresholds (at seeded
# weights every row of the 100 classes leaves at the last exit); each
# confidence lies 0.02 or more from every threshold of REFERENCE_THRESHOLDS
ANALYSIS_CPU_ROWS = 8
PLANTED = ((1, 0.3), (2, 0.65), (3, 0.85), (1, 0.97))


def _analysis_cpu_rows(fa, card_probs):
    """The first ANALYSIS_CPU_ROWS rows of ``card_probs`` (``fa``'s
    ``collect``, (E, N, C), or ``collect_samples``, (S, E, N, C), on the
    card) against the same model on the CPU with batch 0's seeds: (max abs
    difference, tolerance, the CPU's (S, E, rows, C) softmax). Softmax moves
    no probability by more than half the largest change of a logit, so the
    tolerance is half the logits' CPU_REF_RTOL rule of the other phases."""
    import copy

    import numpy as np
    import torch
    from bayestpu_torch.engine import sampler
    s = card_probs.shape[0] if card_probs.ndim == 4 else fa.mc_passes
    cpu = copy.deepcopy(fa.model).cpu()
    with torch.inference_mode():
        l_cpu = sampler.mc_logits(
            cpu, torch.as_tensor(fa.x[:ANALYSIS_CPU_ROWS]),
            fa._batch_seeds(0, s))
        p_cpu = torch.softmax(l_cpu, dim=-1).numpy()
    mine = p_cpu if card_probs.ndim == 4 else p_cpu.mean(0)
    d = float(np.abs(card_probs[..., :ANALYSIS_CPU_ROWS, :] - mine).max())
    return d, 0.5 * CPU_REF_RTOL * max(1.0, l_cpu.abs().max().item()), p_cpu


def phase_analysis(tr: dict, i8: dict, smi: str) -> dict:
    """The paper's analysis battery and the rest of int8 (``phase_analysis``):

    (a) ``FullAnalysis`` on the trained bf16 vgg11_me (MC 0.25, fused, the
        2,000 test images, batch 250, 10 passes): ``run``, the 1-49 pass
        sweep (one ``collect_samples(49)``) and ``confidence_exiting_table``
        over ``REFERENCE_THRESHOLDS`` with the ``max`` and ``margin`` rules,
        profiled for its device time; ``early_exit_select`` on the card
        equal to the same call on the CPU copies (exit indices equal, the
        selected probabilities bit-equal); the sweep's first
        ANALYSIS_CPU_ROWS rows against the same model on the CPU; each
        exit's native KDE-ECE within KDE_RTOL of numpy's.
    (b) the paper's FLOPs table: vgg19_me (CIFAR-100 shapes, bf16, fused,
        S = SAMPLES, seeded init weights), ``FullAnalysis(model_type=
        "vgg19")`` on FLOPS_IMAGES seeded images; the first
        ANALYSIS_CPU_ROWS rows against the same model on the CPU, and, with
        PLANTED confident rows in both, their exit indices, ``flops`` and
        ``flops_ensembled`` at every threshold equal to the CPU's.
    (c) the int8 vgg11_me with ``mixed_head`` and with the quantize-late
        overrides, on the int8 phase's QAT weights, served through
        ``BayesEngine`` at batch BATCH, S = SAMPLES: exact launches, spatial
        against temporal, the card against the CPU as the int8 phase holds
        its model, the residency dtypes (quantize-late: block 1 out of int8,
        block 2 in; the mixed head's ``fc_relu_0`` f32), acc/ECE on the
        test images beside the int8 point's (no gate: post-training
        variants of the QAT weights).
    (d) the native library built from the port's copies on this machine:
        ``augment_gather`` bit-equal to ``augment_gather_ref``, one epoch
        of ``BatchPipeline`` over the synthetic CIFAR-10 train set (images/s
        on the host), and the same epoch through ``PrefetchIterator`` to the
        card equal to it."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from bayestpu_torch import native
    from bayestpu_torch.core.config import BayesConfig, QuantConfig
    from bayestpu_torch.data.datasets import DATASET_STATS, get_dataset
    from bayestpu_torch.data.pipeline import (BatchPipeline,
                                              PrefetchIterator,
                                              augment_gather,
                                              augment_gather_ref)
    from bayestpu_torch.engine.engine import BayesEngine
    from bayestpu_torch.engine.inference import (REFERENCE_THRESHOLDS,
                                                 early_exit_select)
    from bayestpu_torch.interop.from_flax import load_flax_variables
    from bayestpu_torch.metrics.analysis import FullAnalysis
    from bayestpu_torch.metrics.flops import (TABLES, flops_ensembled,
                                              flops_standard)
    from bayestpu_torch.metrics.kde import ece_kde
    from bayestpu_torch.nn.zoo import get_model

    mc_cfg = BayesConfig(rate=RATE)
    ds = tr["ds"]
    x_te, y_te = ds.x_test[:ANALYSIS_TEST], ds.y_test[:ANALYSIS_TEST]

    # (d) first: the native library, built from the port's copies here
    lib_path = native.lib_path()
    t = time.perf_counter()
    native.load()
    build_s = time.perf_counter() - t

    # ---- the main path, counted: (a)-(c)
    reset_counts()
    t_phase = time.perf_counter()
    # (a) the flagship, analysed
    model = load_flax_variables(get_model(
        "vgg11_me", bayes=mc_cfg, fused=True, dtype=torch.bfloat16),
        tr["variables"])
    fa = FullAnalysis(model, x_te, y_te, mc_passes=SAMPLES,
                      batch_size=ANALYSIS_BATCH, seed=0, device="cuda")
    # torch.profiler's summary costs about half a millisecond of host time
    # a recorded op (27 s for 60,000 CPU ops), and the whole battery makes
    # ~59,000 launches: only the first run() is profiled
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        rep = fa.run()
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
    rows = _profile_rows(prof, 1)
    dev_ms = sum(r[0] for r in rows)
    t = time.perf_counter()
    mp = fa.multipass_experiment(ANALYSIS_PASSES)
    multipass_s = time.perf_counter() - t
    t = time.perf_counter()
    tables = {rule: fa.confidence_exiting_table(rule=rule)
              for rule in ("max", "margin")}
    tables_s = time.perf_counter() - t
    # one run() of its own and one a table, then one collect_samples
    n_runs = 1 + len(tables) + 1
    n_batches = -(-ANALYSIS_TEST // ANALYSIS_BATCH)
    flagship_launches = launch_counts()
    check(flagship_launches == counts(
        dropout_matmul_samples=5 * n_batches * n_runs,
        bias_act_bf16=VGG11_ME_CONVS * n_batches * n_runs),
        f"analysis launches {flagship_launches} over {n_runs} collections")
    check(rep.preds.shape == (5, ANALYSIS_TEST, 10)
          and bool(np.isfinite(rep.preds).all()), "analysis predictions")
    # the 1-49 pass sweep's first rows (its own S = 49 launches) against
    # the same model on the CPU
    sweep = fa.collect_samples(max(ANALYSIS_PASSES))
    d_sweep, tol_sweep, _ = _analysis_cpu_rows(fa, sweep)
    check(d_sweep <= tol_sweep, f"analysis sweep card vs CPU rows: "
          f"{d_sweep} > {tol_sweep}")
    # early exit on the card against the same call on the CPU copies
    p_card = torch.as_tensor(rep.preds).cuda()
    p_cpu = torch.as_tensor(rep.preds)
    for rule in ("max", "margin"):
        for th in REFERENCE_THRESHOLDS:
            a = early_exit_select(p_card, th, rule)
            b = early_exit_select(p_cpu, th, rule)
            check(torch.equal(a.exit_idx.cpu(), b.exit_idx)
                  and torch.equal(a.probs.cpu(), b.probs),
                  f"early exit card vs CPU at {rule} {th}")
    kde_rel = 0.0
    for e, r in enumerate(rep.exits):
        py = ece_kde(rep.preds[e], y_te, native=False)
        kde_rel = max(kde_rel, abs(r.ece_kde - py) / max(abs(py), 1e-300))
    check(kde_rel <= KDE_RTOL, f"native KDE-ECE vs numpy: rel {kde_rel}")
    at9 = {rule: next(r for r in rows_ if r["threshold"] == 0.9)
           for rule, rows_ in tables.items()}
    emit({"phase": "analysis", "config": "vgg11_me_bf16_trained",
          "card": smi, "test_images": ANALYSIS_TEST,
          "batch": ANALYSIS_BATCH, "mc_passes": SAMPLES,
          "exits": [{"exit": e, "acc": r.acc, "ece_kde": r.ece_kde,
                     "ece_hist": r.ece_hist, "nll": r.nll,
                     "overthinking": r.destructive_overthinking,
                     "unique_correct": r.unique_correct}
                    for e, r in enumerate(rep.exits)],
          "ensemble_acc": [r.acc for r in rep.ensemble],
          "ensemble_ece_kde": [r.ece_kde for r in rep.ensemble],
          "passes": {p: {"acc": mp["acc"][p - 1], "ece": mp["ece"][p - 1],
                         "ens_acc": mp["ens_acc"][p - 1]}
                     for p in (1, 10, 49)},
          "early_exit_t0.9": {rule: {k: r[k] for k in ("acc", "ece_hist",
                                                       "mean_exit")}
                              for rule, r in at9.items()},
          "early_exit_card_equals_cpu": True,
          f"sweep_card_vs_cpu_rows0_{ANALYSIS_CPU_ROWS - 1}_probs_max_abs":
              d_sweep, "sweep_card_vs_cpu_tol": tol_sweep,
          "native_kde_vs_numpy_max_rel": kde_rel,
          "launches": {k: v for k, v in flagship_launches.items() if v},
          "run_wall_s": run_s, "run_device_ms": dev_ms,
          "run_device_busy_share": dev_ms / (run_s * 1e3),
          "run_kernel_launches": sum(r[1] for r in rows),
          "run_by_group": _by_group(rows), "multipass_wall_s": multipass_s,
          "tables_wall_s": tables_s,
          "seconds": time.perf_counter() - t_phase})

    # (b) the paper's FLOPs table on vgg19_me
    t_b = time.perf_counter()
    before = launch_counts()
    cifar = get_dataset("cifar100")
    m19 = BayesEngine(get_model("vgg19_me", bayes=mc_cfg, fused=True,
                                dtype=torch.bfloat16),
                      device="cuda").init(0, cifar.x_test[:1]).model
    fa19 = FullAnalysis(m19, cifar.x_test[:FLOPS_IMAGES],
                        cifar.y_test[:FLOPS_IMAGES], mc_passes=SAMPLES,
                        batch_size=ANALYSIS_BATCH, seed=1,
                        model_type="vgg19", device="cuda")
    t = time.perf_counter()
    table = fa19.confidence_exiting_table()
    flops_s = time.perf_counter() - t
    check(launch_counts()["dropout_matmul_samples"]
          - before["dropout_matmul_samples"]
          == 5 * -(-FLOPS_IMAGES // ANALYSIS_BATCH),
          "vgg19_me analysis launches")
    # the early exits and FLOPs of the card's first rows against those of
    # the same model's rows on the CPU, both with PLANTED rows, so that the
    # forward pass and the early exits at every exit are compared
    preds19 = fa19.collect()
    d19, tol19, p_cpu = _analysis_cpu_rows(fa19, preds19)
    check(d19 <= tol19, f"vgg19_me card vs CPU rows: {d19} > {tol19}")
    y19 = fa19.y[:ANALYSIS_CPU_ROWS]
    t19 = TABLES["vgg19"]
    planted = {}
    for side, p in (("card", preds19[:, :ANALYSIS_CPU_ROWS]),
                    ("cpu", p_cpu.mean(0))):
        p = p.copy()
        for r, (e, c) in enumerate(PLANTED):
            p[e, r] = (1.0 - c) / (p.shape[-1] - 1)
            p[e, r, y19[r]] = c
        probs = torch.as_tensor(p, device="cuda" if side == "card" else "cpu")
        planted[side] = []
        for th in REFERENCE_THRESHOLDS:
            e_idx = early_exit_select(probs, th).exit_idx.cpu().numpy()
            planted[side].append({
                "threshold": th, "exit_idx": e_idx.tolist(),
                "flops": flops_standard(e_idx, t19, SAMPLES),
                "flops_ensembled": flops_ensembled(e_idx, t19, SAMPLES)})
    check(planted["card"] == planted["cpu"],
          f"vgg19_me planted early exits and FLOPs: card {planted['card']} "
          f"vs CPU {planted['cpu']}")
    exits_seen = {e for r in planted["card"] for e in r["exit_idx"]}
    check(exits_seen == {1, 2, 3, 4}, f"planted rows leave at {exits_seen}")
    emit({"phase": "analysis_flops", "config": "vgg19_me_bf16_seeded",
          "card": smi, "images": FLOPS_IMAGES, "mc_passes": SAMPLES,
          "baseline_flops_per_image": t19.baseline, "table_s": flops_s,
          "rows": [{k: r[k] for k in ("threshold", "acc", "mean_exit",
                                      "flops", "flops_ensembled",
                                      "flops_vs_baseline")}
                   for r in table],
          f"card_vs_cpu_rows0_{ANALYSIS_CPU_ROWS - 1}_probs_max_abs": d19,
          "card_vs_cpu_tol": tol19,
          "planted_rows_card_equals_cpu": [
              {**r, "flops_vs_baseline": r["flops"] / (
                  t19.baseline * ANALYSIS_CPU_ROWS)}
              for r in planted["card"]],
          "seconds": time.perf_counter() - t_b})

    # (c) the rest of int8, served
    int8_q = QuantConfig(8, 0, int8_infer=True)
    x = torch.from_numpy(x_te[:BATCH]).cuda()
    served = {}
    for name, kw in (("mixed_head", dict(mixed_head=True)),
                     ("quantize_late", dict(quant_overrides=QUANTIZE_LATE))):
        t_c = time.perf_counter()
        def build(kw=kw):
            return get_model("vgg11_me", bayes=mc_cfg, fused=True,
                             dtype=torch.bfloat16, quant=int8_q, **kw)
        floats = QUANTIZE_LATE_CONVS if name == "quantize_late" else 0
        out = _block_serve(
            f"int8_{name}", build, i8["variables"],
            dict(dropout_matmul_int8_samples=5,
                 conv_int8_fused=VGG11_ME_INT8_CONVS, bias_act_bf16=floats),
            dict(dropout_matmul_int8=5 * SAMPLES,
                 conv_int8_fused=VGG11_ME_INT8_CONVS * SAMPLES,
                 bias_act_bf16=floats * SAMPLES), x,
            SPATIAL_TEMPORAL_ATOL,
            _int8_cpu_tol(int8_q, 1.0 / (1.0 - RATE)), SAMPLES, False, 5)
        eng = out.pop("engine")
        seen = {}
        hooks = [getattr(eng.model, n).register_forward_hook(
            lambda m, a, o, n=n: seen.__setitem__(n, str(o.dtype)))
            for n in ("block1", "block2", "fc_relu_0")]
        eng.predict(x, 0, SAMPLES)
        for h in hooks:
            h.remove()
        if name == "quantize_late":
            check(seen["block1"] != "torch.int8"
                  and seen["block2"] == "torch.int8",
                  f"quantize-late residency {seen}")
        else:
            check(seen["block1"] == seen["block2"] == "torch.int8"
                  and seen["fc_relu_0"] == "torch.float32",
                  f"mixed-head residency {seen}")
        mets, launched = _launched(lambda: eng.evaluate(
            x_te, y_te, seed=0, num_samples=SAMPLES))
        check(launched == counts(dropout_matmul_int8_samples=5,
                                 conv_int8_fused=VGG11_ME_INT8_CONVS,
                                 bias_act_bf16=floats),
              f"int8 {name} evaluate launches {launched}")
        check(all(np.isfinite(v) for v in mets.values()),
              f"int8 {name} metrics {mets}")
        served[name] = {**{k: mets[k] for k in ("acc", "ece_hist", "nll")},
                        "residency": seen, **out}
        emit({"phase": "analysis_int8", "variant": name, "card": smi,
              "quant": "QuantConfig(8, 0, int8_infer=True)",
              "dtype": "bfloat16", "batch": BATCH, "samples": SAMPLES,
              "test_images": ANALYSIS_TEST, **served[name],
              "int8_point": {k: i8["mets"][k]
                             for k in ("acc", "ece_hist", "nll")},
              "seconds": time.perf_counter() - t_c})
    launches = launch_counts()
    main_s = time.perf_counter() - t_phase

    # (d) the native batch pipeline on this machine (host work, no kernel)
    rng = np.random.default_rng(0)
    mean, std = (np.asarray(v, np.float32)
                 for v in DATASET_STATS["cifar10"])
    idx = rng.integers(0, len(ds.x_train), BATCH)
    for train in (True, False):
        check(np.array_equal(
            augment_gather(ds.x_train, idx, mean, std, 4, 7, train),
            augment_gather_ref(ds.x_train, idx, mean, std, 4, 7, train)),
            f"native augment_gather vs numpy (train={train})")
    pipe = BatchPipeline(ds.x_train, ds.y_train, BATCH, mean, std, seed=0)
    t = time.perf_counter()
    host = list(pipe)
    epoch_s = time.perf_counter() - t
    n_img = sum(len(xb) for xb, _ in host)
    # the same epoch again through the prefetcher to the card: pinned
    # memory, a copy that does not block, the same batches
    pipe.seek(0)
    t = time.perf_counter()
    on_card = list(PrefetchIterator(iter(pipe), device="cuda"))
    torch.cuda.synchronize()
    prefetch_s = time.perf_counter() - t
    check(len(on_card) == len(host) and all(
        xd.is_cuda and torch.equal(xd.cpu(), torch.from_numpy(xh))
        and torch.equal(yd.cpu(), torch.from_numpy(yh))
        for (xd, yd), (xh, yh) in zip(on_card, host)),
        "PrefetchIterator to the card vs BatchPipeline on the host")
    emit({"phase": "analysis_native", "card": smi,
          "library": lib_path.name, "built": build_s,
          "augment_gather_native_equals_numpy": True,
          "pipeline_epoch_images": n_img, "pipeline_epoch_s": epoch_s,
          "pipeline_images_per_s_host": n_img / epoch_s,
          "prefetch_to_card_epoch_s": prefetch_s,
          "prefetch_to_card_equals_host": True,
          "main_path_seconds": main_s,
          "phase_seconds": time.perf_counter() - t_phase})
    return {"launches": launches}


def phase_mask(tr: dict) -> dict:
    """The Masksembles configuration that ``bench.py:723-739`` serves:
    vgg11_me with ``BayesConfig(kind=MASK, num_masks=4, scale=2.0)``, bf16,
    batch 128, fused, S = num_masks = 4. The float-trained weights of the
    train phase with this model's own banks under ``masks`` are fine-tuned
    for MASK_EPOCHS epochs under the batch split (SGD 0.9, cosine LR from
    MASK_LR, clip 10), then served through ``BayesEngine(device="cuda")``
    in bf16 and, as the bench serves its int8 twin (no QAT), under
    ``INT8_Q``."""
    import numpy as np
    import torch
    from bayestpu_torch.core.config import (BayesConfig, DropoutKind,
                                            EngineConfig, QuantConfig,
                                            SamplingMode)
    from bayestpu_torch.core.quant import fake_quant
    from bayestpu_torch.core.rng import step_seeds
    from bayestpu_torch.engine import sampler
    from bayestpu_torch.engine.engine import BayesEngine
    from bayestpu_torch.interop.from_flax import (load_flax_variables,
                                                  to_flax_variables)
    from bayestpu_torch.nn.fused import BayesDense
    from bayestpu_torch.nn.zoo import get_model
    from bayestpu_torch.train import optim
    from bayestpu_torch.train.loop import TrainState, make_train_step

    cfg = BayesConfig(kind=DropoutKind.MASK, num_masks=NUM_MASKS,
                      scale=MASK_SCALE)
    int8_q = QuantConfig(8, 0, int8_infer=True)
    s_mask = NUM_MASKS

    def build(quant=None):
        return get_model("vgg11_me", bayes=cfg, fused=True,
                         dtype=torch.bfloat16, quant=quant)

    def engine(quant=None, mode=SamplingMode.SPATIAL, device="cuda"):
        model = build(quant)
        return BayesEngine(model if device == "cuda" else _card_route(model),
                           config=EngineConfig(mode=mode),
                           device=device).attach(variables)

    ds, xs, ys = tr["ds"], tr["xs"], tr["ys"]
    nb = xs.shape[0]
    steps = MASK_EPOCHS * nb
    # ---- the main path, counted: the fine-tune, then serving
    reset_counts()
    model = build()
    check(model.num_sites == 0 and model.masked, "a Masksembles vgg11_me")
    load_flax_variables(model, {**tr["variables"],
                                "masks": to_flax_variables(model)["masks"]})
    model.cuda().train()
    tx = optim.chain(optim.clip_by_global_norm(TRAIN_CLIP), optim.sgd(
        optim.cosine_decay_schedule(MASK_LR, steps), 0.9))
    state = TrainState(model, tx.init(dict(model.named_parameters())))
    step = make_train_step(model, tx)
    seeds = step_seeds(0, 0, model.num_sites).cuda()      # (0, 2)
    losses, step_ms = [], []
    t_ft = time.perf_counter()
    for i in range(steps):
        # epoch 1 free-running (throughput), epoch 2 step by step (p50)
        t = time.perf_counter()
        losses.append(step(state, xs[i % nb], ys[i % nb], seeds)["loss"])
        if i == nb - 1:
            torch.cuda.synchronize()
            epoch1_s = time.perf_counter() - t_ft
        elif i >= nb:
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
    ft_s = time.perf_counter() - t_ft
    ft_launches = launch_counts()
    check(ft_launches == counts(),
          f"the batch-split fine-tune launched port kernels {ft_launches}")
    loss = torch.stack(losses).float().cpu().numpy()
    check(bool(np.isfinite(loss).all()), "Masksembles fine-tune loss finite")
    variables = state.variables()
    p50 = statistics.median(step_ms)
    emit({"phase": "mask_train", "model": "vgg11_me",
          "bayes": "BayesConfig(kind=MASK, num_masks=4, scale=2.0)",
          "dtype": "bfloat16", "batch": BATCH, "epochs": MASK_EPOCHS,
          "steps": steps, "lr": MASK_LR, "clip": TRAIN_CLIP,
          "warm_start": "the train phase's float weights, own banks",
          "launches_per_step": {kk: v / steps
                                for kk, v in ft_launches.items()},
          "seconds": ft_s, "step_p50_ms": p50, "step_min_ms": min(step_ms),
          "images_per_s": nb * BATCH / epoch1_s,
          "images_per_s_of_p50": BATCH / (p50 / 1e3),
          "first_loss": float(loss[0]), "final_loss": float(loss[-1]),
          "epoch_mean_loss": loss.reshape(MASK_EPOCHS, nb).mean(1).tolist()})

    sp, tm = engine(), engine(mode=SamplingMode.TEMPORAL)
    x = torch.from_numpy(ds.x_test[:BATCH]).cuda()
    seed = 0
    sp.predict(x, seed)                 # warm-up: cuDNN plans, allocator
    tm.predict(x, seed)
    torch.cuda.synchronize()
    p_sp, sp_launches = _launched(lambda: sp.predict(x, seed))
    p_tm, tm_launches = _launched(lambda: tm.predict(x, seed))
    ones, one_launches = _launched(lambda: [
        sp.predict(x, seed, sample_idx=i) for i in range(s_mask)])
    check(p_sp.num_samples == s_mask, f"S {p_sp.num_samples} != num_masks")
    check(sp_launches == counts(bank_matmul_samples=5,
                                bias_act_bf16=VGG11_ME_CONVS),
          f"Masksembles spatial predict launches {sp_launches}")
    check(tm_launches == counts(bank_matmul=5 * s_mask,
                                bias_act_bf16=VGG11_ME_CONVS * s_mask),
          f"Masksembles temporal predict launches {tm_launches}")
    check(one_launches == counts(bank_matmul=5 * s_mask,
                                 bias_act_bf16=VGG11_ME_CONVS * s_mask),
          f"Masksembles one-mask predicts launches {one_launches}")
    for name, p in (("spatial", p_sp.probs), ("temporal", p_tm.probs)):
        check(p.shape == (5, BATCH, 10) and bool(torch.isfinite(p).all()),
              f"Masksembles {name} probs")
        check((p.sum(-1) - 1).abs().max().item() < 1e-5,
              f"Masksembles {name} probs sum to 1")
    d_probs = (p_sp.probs - p_tm.probs).abs().max().item()
    check(d_probs < 1e-5, f"Masksembles spatial vs temporal probs {d_probs}")
    with torch.inference_mode():
        sd = sp.seeds(seed, s_mask)
        l_sp = sampler.mc_logits(sp.model, x, sd, SamplingMode.SPATIAL)
        l_tm = sampler.mc_logits(sp.model, x, sd, SamplingMode.TEMPORAL)
        cpu = engine(device="cpu")
        l_cpu = sampler.mc_logits(cpu.model, x[:8].cpu(), sd.cpu(),
                                  SamplingMode.SPATIAL)
    d_st = (l_sp - l_tm).abs().max().item()
    check(d_st <= SPATIAL_TEMPORAL_ATOL,
          f"Masksembles spatial vs temporal logits {d_st}")
    d_one = max((ones[i] - torch.softmax(l_sp[i], -1)).abs().max().item()
                for i in range(s_mask))
    check(d_one <= SPATIAL_TEMPORAL_ATOL,
          f"predict(sample_idx=i) vs sample i of the spatial logits {d_one}")
    d_cpu = (l_sp[:, :, :8].cpu() - l_cpu).abs().max().item()
    cpu_tol = CPU_REF_RTOL * max(1.0, l_cpu.abs().max().item())
    check(d_cpu <= cpu_tol,
          f"Masksembles card vs CPU rows 0-7: {d_cpu} > {cpu_tol}")
    x_te, y_te = ds.x_test[:2000], ds.y_test[:2000]
    t = time.perf_counter()
    mets, ev_launches = _launched(lambda: sp.evaluate(
        x_te, y_te, seed=0, ood_check=True, dataset="cifar10"))
    eval_s = time.perf_counter() - t
    check(ev_launches == counts(bank_matmul_samples=10,
                                bias_act_bf16=2 * VGG11_ME_CONVS),
          f"Masksembles evaluate launches {ev_launches}")
    check(all(np.isfinite(v) for v in mets.values()),
          f"Masksembles metrics finite {mets}")
    check(mets["acc"] >= 0.5, f"Masksembles accuracy {mets}")

    # ---- int8: the same weights on the int8 model, no QAT; for
    # attribution, on the fake-quant model too (the same ap_fixed<8,0>
    # grid in float arithmetic, through the float bank kernels)
    i8, i8_tm = engine(int8_q), engine(int8_q, SamplingMode.TEMPORAL)
    t = time.perf_counter()
    mets8, ev8_launches = _launched(lambda: i8.evaluate(
        x_te, y_te, seed=0, ood_check=True, dataset="cifar10"))
    eval8_s = time.perf_counter() - t
    check(ev8_launches == counts(bank_matmul_int8_samples=10,
                                 conv_int8_fused=2 * VGG11_ME_INT8_CONVS),
          f"int8 Masksembles evaluate launches {ev8_launches}")
    p8_sp, sp8_launches = _launched(lambda: i8.predict(x, seed))
    p8_tm, tm8_launches = _launched(lambda: i8_tm.predict(x, seed))
    check(sp8_launches == counts(bank_matmul_int8_samples=5,
                                 conv_int8_fused=VGG11_ME_INT8_CONVS),
          f"int8 Masksembles spatial predict launches {sp8_launches}")
    check(tm8_launches == counts(bank_matmul_int8=5 * s_mask,
                                 conv_int8_fused=VGG11_ME_INT8_CONVS
                                 * s_mask),
          f"int8 Masksembles temporal predict launches {tm8_launches}")
    with torch.inference_mode():
        l8_sp = sampler.mc_logits(i8.model, x, sd, SamplingMode.SPATIAL)
        l8_tm = sampler.mc_logits(i8.model, x, sd, SamplingMode.TEMPORAL)
        cpu8 = engine(int8_q, device="cpu")
        l8_cpu = sampler.mc_logits(cpu8.model, x[:8].cpu(), sd.cpu(),
                                   SamplingMode.SPATIAL)
    # the main path ends here: fine-tune, bf16 and int8 serving
    launches = launch_counts()
    fq = engine(QuantConfig(8, 0))
    mets_fq, fq_launches = _launched(lambda: fq.evaluate(
        x_te, y_te, seed=0, ood_check=True, dataset="cifar10"))
    check(fq_launches == counts(bank_matmul_samples=10),
          f"fake-quant Masksembles evaluate launches {fq_launches}")
    check(all(np.isfinite(v) for v in [*mets8.values(), *mets_fq.values()]),
          f"int8 Masksembles metrics finite {mets8} {mets_fq}")
    check(torch.equal(l8_sp, l8_tm),
          "int8 Masksembles spatial and temporal logits differ")
    check(bool(torch.isfinite(p8_sp.probs).all())
          and (p8_sp.probs - p8_tm.probs).abs().max().item() < 1e-5,
          "int8 Masksembles probs")
    d8_rows = (l8_sp[:, :, :8].cpu() - l8_cpu).abs()
    d8_cpu = d8_rows.max().item()
    # INT8_CPU_STEPS grid steps of a head's int8 input through the widest
    # column of its quantized kernel (the bank only zeroes inputs; no
    # dropout rescale)
    cpu8_tol = INT8_CPU_STEPS * 2.0 ** -7 * max(
        torch.linalg.vector_norm(fake_quant(h.kernel, int8_q), dim=0).max()
        .item() for h in cpu8.model.modules() if isinstance(h, BayesDense))
    check(d8_cpu <= cpu8_tol,
          f"int8 Masksembles card vs CPU rows 0-7: {d8_cpu} > {cpu8_tol}")

    # ---- times
    spatial_ms = host_ms(lambda: sp.predict(x, seed), 30)
    temporal_ms = host_ms(lambda: tm.predict(x, seed), 10)
    loop_ms = host_ms(lambda: [sp.predict(x, seed, sample_idx=i)
                               for i in range(s_mask)], 10)
    order = [("bf16", sp), ("int8", i8), ("int8", i8), ("bf16", sp)]
    p50s: dict = {"bf16": [], "int8": []}
    for name, eng in order:
        p50s[name].append(host_ms(lambda: eng.predict(x, seed), 15))
    int8_ms = statistics.mean(p50s["int8"])
    bf16_ms = statistics.mean(p50s["bf16"])
    emit({"phase": "mask", "model": "vgg11_me",
          "bayes": "BayesConfig(kind=MASK, num_masks=4, scale=2.0)",
          "dtype": "bfloat16", "batch": BATCH, "samples": s_mask,
          "test_images": len(x_te), "eval_seconds": eval_s, **mets,
          "launches_main_path": launches,
          "launches_spatial_predict": sp_launches,
          "launches_temporal_predict": tm_launches,
          "launches_one_mask_predicts": one_launches,
          "spatial_vs_temporal_probs_max_abs": d_probs,
          "spatial_vs_temporal_logits_max_abs": d_st,
          "spatial_temporal_bit_identical": bool(torch.equal(l_sp, l_tm)),
          "sample_idx_vs_spatial_probs_max_abs": d_one,
          "card_vs_cpu_rows0_7_logits_max_abs": d_cpu,
          "card_vs_cpu_tol": cpu_tol,
          "spatial_p50_ms": spatial_ms,
          "mc_samples_per_s": BATCH * s_mask / (spatial_ms / 1e3),
          "temporal_p50_ms": temporal_ms, "host_loop_p50_ms": loop_ms})
    emit({"phase": "mask_int8", "model": "vgg11_me",
          "quant": "INT8_Q = QuantConfig(8, 0, int8_infer=True), no QAT",
          "batch": BATCH, "samples": s_mask, "test_images": len(x_te),
          "eval_seconds": eval8_s, **mets8, "fake_quant": mets_fq,
          "launches_spatial_predict": sp8_launches,
          "launches_temporal_predict": tm8_launches,
          "spatial_temporal_bit_identical": True,
          "card_vs_cpu_rows0_7_logits_max_abs": d8_cpu,
          "card_vs_cpu_tol": cpu8_tol,
          "card_vs_cpu_rows_differing": int(
              (d8_rows.amax(dim=(0, 1, 3)) > 0).sum()),
          "int8_spatial_p50_ms": int8_ms, "bf16_spatial_p50_ms": bf16_ms,
          "int8_over_bf16": int8_ms / bf16_ms, "p50_ms_by_turn": p50s,
          "int8_mc_samples_per_s": BATCH * s_mask / (int8_ms / 1e3)})
    emit({"phase": "mask_profile",
          "what": "Masksembles bf16 spatial predict, profiled",
          **_profile_predict(sp, x, seed)})
    return {"launches": launches}


def _block_serve(name: str, build, variables, want_sp: dict, want_tm: dict,
                 x, st_tol, cpu_tol_fn, samples: int, mask: bool,
                 exits: int = 1, classes: int = 10, cpu_rows: int = 8
                 ) -> dict:
    """Serve one model through ``BayesEngine(device="cuda")``: exact launch
    counts of a spatial and a temporal predict, every probability (of
    ``exits`` exits over ``classes`` classes) finite and summing to 1, the
    per-sample logits of the two mappings within ``st_tol``, for
    Masksembles ``predict(sample_idx=i)`` equal to sample i, and the first
    ``cpu_rows`` rows against the same model on the CPU (its int8 convs on
    the card's route, ``_card_route``) within ``cpu_tol_fn(cpu_model,
    cpu_logits)``."""
    import torch
    from bayestpu_torch.core.config import EngineConfig, SamplingMode
    from bayestpu_torch.engine import sampler
    from bayestpu_torch.engine.engine import BayesEngine

    def engine(mode, device="cuda"):
        model = build() if device == "cuda" else _card_route(build())
        eng = BayesEngine(model, config=EngineConfig(mode=mode),
                          device=device)
        return (eng.attach(variables) if variables is not None
                else eng.init(0, x[:1].cpu()))

    sp, tm = engine(SamplingMode.SPATIAL), engine(SamplingMode.TEMPORAL)
    seed = 11
    sp.predict(x, seed, samples)           # warm-up: cuDNN plans, allocator
    tm.predict(x, seed, samples)
    p_sp, sp_launches = _launched(lambda: sp.predict(x, seed, samples))
    p_tm, tm_launches = _launched(lambda: tm.predict(x, seed, samples))
    check(sp_launches == counts(**want_sp),
          f"block {name} spatial predict launches {sp_launches}")
    check(tm_launches == counts(**want_tm),
          f"block {name} temporal predict launches {tm_launches}")
    for mode, p in (("spatial", p_sp.probs), ("temporal", p_tm.probs)):
        check(p.shape == (exits, x.shape[0], classes)
              and bool(torch.isfinite(p).all())
              and (p.sum(-1) - 1).abs().max().item() < 1e-5,
              f"block {name} {mode} probs")
    with torch.inference_mode():
        sd = sp.seeds(seed, samples)
        l_sp = sampler.mc_logits(sp.model, x, sd, SamplingMode.SPATIAL)
        l_tm = sampler.mc_logits(sp.model, x, sd, SamplingMode.TEMPORAL)
        cpu = engine(SamplingMode.SPATIAL, "cpu")
        l_cpu = sampler.mc_logits(cpu.model, x[:cpu_rows].cpu(), sd.cpu(),
                                  SamplingMode.SPATIAL)
    d_st = (l_sp - l_tm).abs().max().item()
    tol = st_tol * max(1.0, l_tm.abs().max().item())
    check(d_st <= tol, f"block {name} spatial vs temporal logits {d_st} > "
          f"{tol}")
    d_rows = (l_sp[:, :, :cpu_rows].cpu() - l_cpu).abs()
    cpu_tol = cpu_tol_fn(cpu.model, l_cpu)
    check(d_rows.max().item() <= cpu_tol,
          f"block {name} card vs CPU rows 0-{cpu_rows - 1}: "
          f"{d_rows.max().item()} > {cpu_tol}")
    out = {"launches_spatial_predict": {k: v for k, v in
                                        sp_launches.items() if v},
           "launches_temporal_predict": {k: v for k, v in
                                         tm_launches.items() if v},
           "spatial_vs_temporal_logits_max_abs": d_st,
           "spatial_vs_temporal_tol": tol,
           "spatial_temporal_bit_identical": bool(torch.equal(l_sp, l_tm)),
           f"card_vs_cpu_rows0_{cpu_rows - 1}_logits_max_abs":
               d_rows.max().item(),
           "card_vs_cpu_tol": cpu_tol,
           "card_vs_cpu_rows_differing": int(
               (d_rows.amax(dim=(0, 1, 3)) > 0).sum()),
           "spatial_p50_ms": host_ms(lambda: sp.predict(x, seed, samples),
                                     10),
           "temporal_p50_ms": host_ms(lambda: tm.predict(x, seed, samples),
                                      5)}
    out["mc_samples_per_s"] = x.shape[0] * samples / (
        out["spatial_p50_ms"] / 1e3)
    if mask:
        ones, one_launches = _launched(lambda: [
            sp.predict(x, seed, sample_idx=i) for i in range(samples)])
        check(one_launches == counts(**want_tm),
              f"block {name} one-mask predicts launches {one_launches}")
        d_one = max((ones[i] - torch.softmax(l_sp[i], -1)).abs().max().item()
                    for i in range(samples))
        check(d_one <= st_tol, f"block {name} predict(sample_idx=i) vs "
              f"sample i {d_one}")
        out["sample_idx_vs_spatial_probs_max_abs"] = d_one
    out["engine"] = sp
    return out


def _int8_cpu_tol(quant, rescale: float):
    """INT8_CPU_STEPS grid steps of a head's int8 input through the widest
    column of its quantized kernel (times ``rescale``, the MC heads'
    1/(1-rate)), as the int8 phase: card against CPU for an int8 model."""
    import torch
    from bayestpu_torch.core.quant import fake_quant
    from bayestpu_torch.nn.fused import BayesDense
    return lambda model, l_cpu: INT8_CPU_STEPS * 2.0 ** -7 * max(
        torch.linalg.vector_norm(fake_quant(h.kernel, quant), dim=0)
        .max().item() for h in model.modules()
        if isinstance(h, BayesDense)) * rescale


def _card_route(model):
    """``model`` with ``int8_det_pallas`` in every layer's quantization: on
    the CPU each deterministic int8 conv that the card runs through
    ``conv_int8_fused`` takes that route too (its plain version), so the
    card's int8 model is held against the same arithmetic."""
    import dataclasses
    from bayestpu_torch.core.config import QuantConfig
    for m in model.modules():
        q = getattr(m, "quant", None)
        if isinstance(q, QuantConfig) and q.int8_infer:
            m.quant = dataclasses.replace(q, int8_det_pallas=True)
    return model


def _block_finetune(model, xs, ys, epochs: int, lr: float, want: dict,
                    tx=None) -> tuple[dict, dict]:
    """Fine-tune ``model`` (on the card, train mode) for ``epochs`` epochs
    of the batches ``xs``/``ys`` with SGD 0.9, cosine LR from ``lr``, clip
    10 (the bench recipe's optimizer), or with the optimizer ``tx``: the
    first step's launches must be ``want``; epoch 1 runs free for the
    throughput, epoch 2 step by step (host clock ending in a synchronise)
    for the p50."""
    import numpy as np
    import torch
    from bayestpu_torch.core.rng import step_seeds
    from bayestpu_torch.train import optim
    from bayestpu_torch.train.loop import TrainState, make_train_step
    nb = xs.shape[0]
    steps = epochs * nb
    if tx is None:
        tx = optim.chain(optim.clip_by_global_norm(TRAIN_CLIP), optim.sgd(
            optim.cosine_decay_schedule(lr, steps), 0.9))
    state = TrainState(model, tx.init(dict(model.named_parameters())))
    step = make_train_step(model, tx)
    seeds = step_seeds(0, range(steps), model.num_sites).cuda()
    losses, step_ms, first = [], [], {}
    t0 = time.perf_counter()
    for i in range(steps):
        t = time.perf_counter()
        before = launch_counts() if i == 0 else None
        losses.append(step(state, xs[i % nb], ys[i % nb], seeds[i])["loss"])
        if i == 0:
            first = {k: launch_counts()[k] - before[k] for k in before}
        if i == nb - 1:
            torch.cuda.synchronize()
            epoch1_s = time.perf_counter() - t0
        elif nb <= i < 2 * nb:
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    check(first == counts(**want), f"launches of one training step {first}")
    loss = torch.stack(losses).float().cpu().numpy()
    check(bool(np.isfinite(loss).all()), "training loss finite")
    p50 = statistics.median(step_ms)
    return state.variables(), {
        "epochs": epochs, "steps": steps, "batch": xs.shape[1], "lr": lr,
        "clip": TRAIN_CLIP,
        "seconds": time.perf_counter() - t0,
        "launches_per_step": {k: v for k, v in first.items() if v},
        "step_p50_ms": p50, "step_min_ms": min(step_ms),
        "images_per_s": nb * xs.shape[1] / epoch1_s,
        "images_per_s_of_p50": xs.shape[1] / (p50 / 1e3),
        "first_loss": float(loss[0]), "final_loss": float(loss[-1]),
        "epoch_mean_loss": loss.reshape(epochs, nb).mean(1).tolist()}


def phase_block(tr: dict) -> dict:
    """``vgg11`` with fused block sites (``dropout="block"``, ``fused=True``:
    a site on the input of blocks 1-4, fused into the first conv, plus the
    MC classifier head), bf16, batch 128, full width, as the deeper MC
    placement of ``scripts/exp_ood_entropy.py:29-40``:

    (a) MC, rate 0.25, S = 10, seeded weights: per spatial predict one
        ``dropout_conv_samples`` launch (block 1's site, where x is shared),
        3 ``dropout_conv_xs`` (blocks 2-4: the activations carry the sample
        axis, one launch for all S) and 1 ``dropout_matmul_xs`` (the head,
        likewise); per temporal predict 40 ``dropout_conv`` and 10
        ``dropout_matmul``; spatial against temporal; card against CPU.
    (b) MC training: the train phase's vgg11_me weights (vgg11 shares every
        name but ``exit*``) fine-tuned BLOCK_EPOCHS epochs; a step launches
        4 ``dropout_conv``, 1 ``dropout_matmul`` and 10 ``dropout_apply``;
        served on 2,000 test images (acc >= 0.5, ECE, NLL, aPE, aPE_ood).
    (c) Masksembles (num_masks 4, scale 2.0, S = 4): (b)'s weights with the
        model's own banks, BLOCK_MASK_EPOCHS epochs under the batch split
        (no port kernel), served: 1 ``bank_conv_samples``, 3
        ``bank_conv_xs`` and 1 ``bank_matmul_xs`` a spatial predict (the
        activations of blocks 2-4 and the head's x carry the sample axis),
        16 ``bank_conv`` and 4 ``bank_matmul`` a temporal one,
        ``predict(sample_idx=i)`` equal to sample i, card against CPU,
        quality.
    (d) The int8 models on (b)'s and (c)'s weights under INT8_Q, no QAT:
        block 1's site runs the float kernel with an int8 store (64 input
        channels at 16x16 are not int8-executed), blocks 2-4 and the head
        the int8 kernels (3 ``dropout_conv_int8_xs`` and 1
        ``dropout_matmul_int8_xs`` a spatial MC predict; 3
        ``bank_conv_int8_xs`` and 1 ``bank_matmul_int8_xs`` a Masksembles
        one); with
        ``int8_conv_min_ch=32`` block 1's site int8-executes too, through
        the int8 samples kernels. Card against CPU within a few grid steps;
        acc and ECE."""
    import numpy as np
    import torch
    from bayestpu_torch.core.config import (BayesConfig, DropoutKind,
                                            QuantConfig)
    from bayestpu_torch.engine.engine import BayesEngine
    from bayestpu_torch.interop.from_flax import (load_flax_variables,
                                                  to_flax_variables)
    from bayestpu_torch.nn.zoo import get_model

    cfg_mc = BayesConfig(rate=RATE)
    cfg_mask = BayesConfig(kind=DropoutKind.MASK, num_masks=NUM_MASKS,
                           scale=MASK_SCALE)
    int8_q = QuantConfig(8, 0, int8_infer=True)
    int8_q32 = QuantConfig(8, 0, int8_infer=True, int8_conv_min_ch=32)

    def model_fn(bayes, quant=None):
        return lambda: get_model("vgg11", bayes=bayes, fused=True,
                                 dropout="block", dtype=torch.bfloat16,
                                 quant=quant)

    def float_tol(model, l_cpu):
        return CPU_REF_RTOL * max(1.0, l_cpu.abs().max().item())

    def int8_tol(rescale):
        return _int8_cpu_tol(int8_q, rescale)

    ds, xs, ys = tr["ds"], tr["xs"], tr["ys"]
    x = torch.from_numpy(ds.x_test[:BATCH]).cuda()
    x_te, y_te = ds.x_test[:2000], ds.y_test[:2000]
    s_mc, s_mask = SAMPLES, NUM_MASKS
    check(model_fn(cfg_mc)().num_sites == 5 and
          model_fn(cfg_mask)().num_sites == 0, "block-site vgg11 sites")
    mc_sp = dict(dropout_conv_samples=1, dropout_conv_xs=3,
                 dropout_matmul_xs=1, bias_act_bf16=BLOCK_CONVS)
    mc_tm = dict(dropout_conv=4 * s_mc, dropout_matmul=s_mc,
                 bias_act_bf16=BLOCK_CONVS * s_mc)
    mask_sp = dict(bank_conv_samples=1, bank_conv_xs=3, bank_matmul_xs=1,
                   bias_act_bf16=BLOCK_CONVS)
    mask_tm = dict(bank_conv=4 * s_mask, bank_matmul=s_mask,
                   bias_act_bf16=BLOCK_CONVS * s_mask)
    # ---- the main path, counted: (a)-(d)
    reset_counts()
    t0 = time.perf_counter()
    a = _block_serve("mc", model_fn(cfg_mc), None, mc_sp, mc_tm, x,
                     CPU_REF_RTOL, float_tol, s_mc, False)
    a.pop("engine")
    emit({"phase": "block_mc", "model": "vgg11", "dropout": "block",
          "weights": "seeded init", "dtype": "bfloat16", "batch": BATCH,
          "samples": s_mc, "rate": RATE, **a,
          "seconds": time.perf_counter() - t0})

    # (b) MC training from the train phase's weights, without the exits
    warm = {coll: {k: v for k, v in tree.items() if not k.startswith("exit")}
            for coll, tree in tr["variables"].items()}
    t0 = time.perf_counter()
    model = load_flax_variables(model_fn(cfg_mc)(), warm).cuda().train()
    v_mc, fit = _block_finetune(model, xs, ys, BLOCK_EPOCHS, BLOCK_LR,
                                dict(dropout_conv=4, dropout_matmul=1,
                                     dropout_apply=10))
    eng = BayesEngine(model_fn(cfg_mc)(), device="cuda").attach(v_mc)
    mets, ev_launches = _launched(lambda: eng.evaluate(
        x_te, y_te, seed=0, num_samples=s_mc, ood_check=True,
        dataset="cifar10"))
    check(ev_launches == counts(**{k: 2 * v for k, v in mc_sp.items()}),
          f"block MC evaluate launches {ev_launches}")
    check(all(np.isfinite(v) for v in mets.values()) and mets["acc"] >= 0.5,
          f"block MC trained metrics {mets}")
    emit({"phase": "block_train", "model": "vgg11", "dropout": "block",
          "dtype": "bfloat16", "batch": BATCH, "rate": RATE,
          "warm_start": "the train phase's vgg11_me weights, exits dropped",
          **fit, "test_images": len(x_te), "samples": s_mc, **mets,
          "seconds": time.perf_counter() - t0})
    emit({"phase": "block_profile",
          "what": "block-site MC spatial predict of the trained weights, "
                  "profiled",
          **_profile_predict(eng, x, 11, reps=5)})

    # (c) Masksembles: (b)'s weights with the model's own banks
    t0 = time.perf_counter()
    model = model_fn(cfg_mask)()
    load_flax_variables(model, {**v_mc,
                                "masks": to_flax_variables(model)["masks"]})
    v_mask, fit_m = _block_finetune(model.cuda().train(), xs, ys,
                                    BLOCK_MASK_EPOCHS, BLOCK_LR, {})
    c = _block_serve("mask", model_fn(cfg_mask), v_mask, mask_sp, mask_tm, x,
                     CPU_REF_RTOL, float_tol, s_mask, True)
    eng_m = c.pop("engine")
    prof_m = _profile_predict(eng_m, x, 11, reps=5, samples=s_mask)
    mets_m, evm_launches = _launched(lambda: eng_m.evaluate(
        x_te, y_te, seed=0, ood_check=True, dataset="cifar10"))
    check(evm_launches == counts(**{k: 2 * v for k, v in mask_sp.items()}),
          f"block Masksembles evaluate launches {evm_launches}")
    check(all(np.isfinite(v) for v in mets_m.values()),
          f"block Masksembles metrics {mets_m}")
    emit({"phase": "block_mask", "model": "vgg11", "dropout": "block",
          "bayes": "BayesConfig(kind=MASK, num_masks=4, scale=2.0)",
          "dtype": "bfloat16", "batch": BATCH, "samples": s_mask,
          "finetune": fit_m, **c, "test_images": len(x_te), **mets_m,
          "seconds": time.perf_counter() - t0})
    emit({"phase": "block_mask_profile",
          "what": "block-site Masksembles bf16 spatial predict of the "
                  "fine-tuned weights, profiled",
          **prof_m})

    # (d) the int8 models, no QAT
    for name, cfg, variables, quant, samples, want_sp, want_tm, rescale in (
            ("mc_int8", cfg_mc, v_mc, int8_q, s_mc,
             dict(dropout_conv_samples=1, dropout_conv_int8_xs=3,
                  dropout_matmul_int8_xs=1, conv_int8_fused=BLOCK_INT8_CONVS),
             dict(dropout_conv=s_mc, dropout_conv_int8=3 * s_mc,
                  dropout_matmul_int8=s_mc,
                  conv_int8_fused=BLOCK_INT8_CONVS * s_mc),
             1.0 / (1.0 - RATE)),
            ("mask_int8", cfg_mask, v_mask, int8_q, s_mask,
             dict(bank_conv_samples=1, bank_conv_int8_xs=3,
                  bank_matmul_int8_xs=1, conv_int8_fused=BLOCK_INT8_CONVS),
             dict(bank_conv=s_mask, bank_conv_int8=3 * s_mask,
                  bank_matmul_int8=s_mask,
                  conv_int8_fused=BLOCK_INT8_CONVS * s_mask), 1.0),
            ("mc_int8_min_ch32", cfg_mc, v_mc, int8_q32, s_mc,
             dict(dropout_conv_int8_samples=1, dropout_conv_int8_xs=3,
                  dropout_matmul_int8_xs=1, conv_int8_fused=BLOCK_INT8_CONVS),
             dict(dropout_conv_int8=4 * s_mc, dropout_matmul_int8=s_mc,
                  conv_int8_fused=BLOCK_INT8_CONVS * s_mc),
             1.0 / (1.0 - RATE)),
            ("mask_int8_min_ch32", cfg_mask, v_mask, int8_q32, s_mask,
             dict(bank_conv_int8_samples=1, bank_conv_int8_xs=3,
                  bank_matmul_int8_xs=1, conv_int8_fused=BLOCK_INT8_CONVS),
             dict(bank_conv_int8=4 * s_mask, bank_matmul_int8=s_mask,
                  conv_int8_fused=BLOCK_INT8_CONVS * s_mask), 1.0)):
        t0 = time.perf_counter()
        d = _block_serve(name, model_fn(cfg, quant), variables, want_sp,
                         want_tm, x, CPU_REF_RTOL, int8_tol(rescale),
                         samples, False)
        eng8 = d.pop("engine")
        prof8 = (_profile_predict(eng8, x, 11, reps=5, samples=samples)
                 if name == "mask_int8" else None)
        mets8 = eng8.evaluate(x_te, y_te, seed=0, num_samples=samples)
        check(all(np.isfinite(v) for v in mets8.values()),
              f"block {name} metrics {mets8}")
        emit({"phase": "block_int8", "model": "vgg11", "dropout": "block",
              "config": name, "quant": repr(quant), "dtype": "bfloat16",
              "batch": BATCH, "samples": samples, **d,
              "test_images": len(x_te), "acc": mets8["acc"],
              "ece_hist": mets8["ece_hist"], "nll": mets8["nll"],
              "seconds": time.perf_counter() - t0})
        if prof8 is not None:
            emit({"phase": "block_int8_profile", "config": name,
                  "what": "block-site int8 Masksembles spatial predict, "
                          "profiled", **prof8})
    return {"launches": launch_counts()}


def phase_resnet(smi: str) -> dict:
    """ResNet-18 at full width on CIFAR-100 shapes (100 classes), batch
    128, through the entry points a user calls (``get_model``,
    ``BayesEngine(device="cuda")``, ``make_train_step``), seeded weights:

    (a) int8 ``resnet18_me``, the JAX bench's BASELINE config 5
        (``bench.py:741-748``: fused, MC rate 0.25, S = 10, bf16 compute,
        ``int8_infer``): 4 ``dropout_matmul_int8_samples`` and 25
        ``conv_int8_fused`` launches a spatial predict (the four exit
        heads, every deterministic int8 conv; the backbone runs once), 40
        ``dropout_matmul_int8`` and 250 ``conv_int8_fused`` a temporal one;
        spatial against temporal,
        the card against the CPU on rows 0-7 within INT8_CPU_STEPS grid
        steps; p50s and samples/s; a profiled predict by kernel group.
    (b) its bf16 twin: 4 ``dropout_matmul_samples`` / 40
        ``dropout_matmul``.
    (c) ``resnet18(fused=True, dropout="block")``, MC bf16: the stage
        boundary sites deferred into layer2_0, layer3_0 and layer4_0, whose
        convbn1 (3x3, stride 2) and downsample (1x1, stride 2) share one
        seed pair: 2 ``dropout_conv_samples`` (the first site, where x is
        shared) and 4 ``dropout_conv_xs`` (the activations carry S) a
        spatial predict, 60 ``dropout_conv`` a temporal one (the head is
        deterministic: ``dropout_exit=False``); profiled.
    (d) its Masksembles twin (num_masks 4, scale 2.0, S = 4): 2
        ``bank_conv_samples`` + 4 ``bank_conv_xs``, 24 ``bank_conv``;
        ``predict(sample_idx=i)`` equal to sample i.
    (e) bf16 training from seeded weights, RESNET_EPOCHS epochs of
        RESNET_BATCHES batches: ``resnet18_me`` (a step launches 4
        ``dropout_matmul`` and 8 ``dropout_apply``) and the block-site
        ``resnet18`` (6 ``dropout_conv`` and 12 ``dropout_apply``: row 1 on
        the (N·H·W, C) views of the deferred sites, 131072 x 64 at the
        stage-1 boundary); the loss falls in both.
    (f) one ``resnet18_me`` training step at batch 8, card against CPU
        (``_step_vs_cpu``), after the launches are read.
    (g) the int8 ``resnet18_me`` in f32 compute, served, bit for bit
        against the CPU port on the card's route (``_resnet_int8_exact``)."""
    import torch
    from bayestpu_torch.core.config import (BayesConfig, DropoutKind,
                                            QuantConfig)
    from bayestpu_torch.data.datasets import get_dataset
    from bayestpu_torch.nn.zoo import get_model

    mc_cfg = BayesConfig(rate=RATE)
    mask_cfg = BayesConfig(kind=DropoutKind.MASK, num_masks=NUM_MASKS,
                           scale=MASK_SCALE)
    int8_q = QuantConfig(8, 0, int8_infer=True)

    def model_fn(name, bayes, quant=None, **kw):
        return lambda: get_model(name, bayes=bayes, fused=True,
                                 dtype=torch.bfloat16, quant=quant,
                                 num_classes=RESNET_CLASSES, **kw)

    def float_tol(model, l_cpu):
        return CPU_REF_RTOL * max(1.0, l_cpu.abs().max().item())

    ds = get_dataset("cifar100")
    x = torch.from_numpy(ds.x_test[:BATCH]).cuda()
    nb = RESNET_BATCHES
    xs = torch.from_numpy(ds.x_train[:nb * BATCH]).cuda().reshape(
        (nb, BATCH) + ds.x_train.shape[1:])
    ys = torch.from_numpy(ds.y_train[:nb * BATCH]).long().cuda().reshape(
        nb, BATCH)
    s_mc, s_mask = SAMPLES, NUM_MASKS
    block = dict(dropout="block")
    serving = (
        ("resnet18_me_int8", model_fn("resnet18_me", mc_cfg, int8_q),
         dict(dropout_matmul_int8_samples=4,
              conv_int8_fused=RESNET_INT8_CONVS),
         dict(dropout_matmul_int8=4 * s_mc,
              conv_int8_fused=RESNET_INT8_CONVS * s_mc), _int8_cpu_tol(
             int8_q, 1.0 / (1.0 - RATE)), s_mc, False, 4, True),
        ("resnet18_me_bf16", model_fn("resnet18_me", mc_cfg),
         dict(dropout_matmul_samples=4, bias_act_bf16=RESNET18_ME_CONVS),
         dict(dropout_matmul=4 * s_mc,
              bias_act_bf16=RESNET18_ME_CONVS * s_mc),
         float_tol, s_mc, False, 4, False),
        ("resnet18_block_mc", model_fn("resnet18", mc_cfg, **block),
         dict(dropout_conv_samples=2, dropout_conv_xs=4,
              bias_act_bf16=RESNET18_SITE_CONVS),
         dict(dropout_conv=6 * s_mc,
              bias_act_bf16=RESNET18_SITE_CONVS * s_mc),
         float_tol, s_mc, False, 1, True),
        ("resnet18_block_mask", model_fn("resnet18", mask_cfg, **block),
         dict(bank_conv_samples=2, bank_conv_xs=4,
              bias_act_bf16=RESNET18_SITE_CONVS),
         dict(bank_conv=6 * s_mask,
              bias_act_bf16=RESNET18_SITE_CONVS * s_mask),
         float_tol, s_mask, True, 1, False))
    # ---- the main path, counted: (a)-(e)
    reset_counts()
    for (name, build, want_sp, want_tm, cpu_tol, samples, mask, exits,
         profiled) in serving:
        t0 = time.perf_counter()
        out = _block_serve(name, build, None, want_sp, want_tm, x,
                           CPU_REF_RTOL, cpu_tol, samples, mask, exits,
                           RESNET_CLASSES)
        eng = out.pop("engine")
        emit({"phase": "resnet", "config": name, "card": smi,
              "weights": "seeded init", "quant": repr(eng.model.quant),
              "dtype": "bfloat16", "batch": BATCH, "classes":
              RESNET_CLASSES, "samples": samples, **out,
              "seconds": time.perf_counter() - t0})
        if profiled:
            emit({"phase": "resnet_profile", "config": name, "card": smi,
                  "what": "spatial predict, profiled",
                  **_profile_predict(eng, x, 11, reps=5, samples=samples)})
    emit({"phase": "resnet_int8_exact", "card": smi,
          **_resnet_int8_exact()})
    for name, build, want in (
            ("resnet18_me", model_fn("resnet18_me", mc_cfg),
             dict(dropout_matmul=4, dropout_apply=8)),
            ("resnet18_block_mc", model_fn("resnet18", mc_cfg, **block),
             dict(dropout_conv=6, dropout_apply=12))):
        t0 = time.perf_counter()
        model = build()
        model.reset_parameters(torch.Generator().manual_seed(0))
        _, fit = _block_finetune(model.cuda().train(), xs, ys,
                                 RESNET_EPOCHS, RESNET_LR, want)
        losses = fit["epoch_mean_loss"]
        check(losses[-1] < losses[0], f"{name} training loss does not "
              f"fall: {losses}")
        emit({"phase": "resnet_train", "config": name, "card": smi,
              "dtype": "bfloat16", "batch": BATCH, "rate": RATE,
              "data": "synthetic CIFAR-100", **fit,
              "seconds": time.perf_counter() - t0})
    launches = launch_counts()
    _step_vs_cpu("resnet18_me", RESNET_CLASSES,
                 ["exit1.linear.kernel", "exit2.linear.kernel",
                  "exit3.linear.kernel", "linear.kernel"])
    return {"launches": launches}


def _resnet_int8_exact() -> dict:
    """(g) The int8 ``resnet18_me`` served in f32 compute
    (``BayesEngine.compile``, a CUDA graph) at batch BATCH, S = SAMPLES,
    seeded weights and BatchNorm statistics: RESNET_INT8_CONVS
    ``conv_int8_fused`` launches and ``quant.conv_kernel`` counts a
    forward, ``quant.conv_im2col`` none; the replayed predict equal to the
    eager one; the MC logits equal to the CPU port's on the card's route
    (``_card_route``) bit for bit. Two
    float steps ahead of the int8 arithmetic would round differently on
    the two devices and are made exact: x on a grid of 1/16 within ±4, so
    that the stem's sums of grid products are exact in f32 in any order,
    and every BatchNorm variance set so that ``var + epsilon`` is 1 (its
    ``rsqrt`` is not correctly rounded on the card)."""
    import copy

    import torch
    from bayestpu_torch.core.config import BayesConfig, QuantConfig
    from bayestpu_torch.engine import sampler
    from bayestpu_torch.engine.engine import BayesEngine
    from bayestpu_torch.nn.layers import BatchNorm
    from bayestpu_torch.nn.zoo import get_model
    from bayestpu_torch.utils import profiler
    gen = torch.Generator().manual_seed(2 ** 31 + 977)
    x = (torch.randn(BATCH, 32, 32, 3, generator=gen) * 16).round().clamp(
        -64, 64) / 16
    model = get_model("resnet18_me", bayes=BayesConfig(rate=RATE),
                      fused=True, dtype=torch.float32,
                      quant=QuantConfig(8, 0, int8_infer=True),
                      num_classes=RESNET_CLASSES)
    model.reset_parameters(torch.Generator().manual_seed(21))
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, BatchNorm):
                f = m.var.shape[0]
                m.scale.copy_(torch.rand(f, generator=gen) + 0.5)
                m.bias.copy_(0.2 * torch.randn(f, generator=gen))
                m.mean.copy_(0.2 * torch.randn(f, generator=gen))
                m.var.fill_(1.0 - torch.tensor(m.epsilon).item())
                check(bool((m.var + m.epsilon == 1.0).all()),
                      "BatchNorm var + epsilon is not 1 in f32")
    cpu_model = _card_route(copy.deepcopy(model)).eval()
    eng = BayesEngine(model, device="cuda")
    eng.ready = True
    xc = x.cuda()
    profiler.reset_spans()
    _, compiled = _launched(lambda: eng.compile(xc, SAMPLES))
    n = compiled["conv_int8_fused"]
    check(n > 0 and n % RESNET_INT8_CONVS == 0
          and profiler.counters().get("quant.conv_kernel") == n
          and "quant.conv_im2col" not in profiler.counters(),
          f"resnet18_me int8 f32 compile: {n} conv_int8_fused launches, "
          f"counters {profiler.counters()}")
    seed = 11
    seeds = eng.seeds(seed, SAMPLES)
    p = eng.predict(xc, seed, SAMPLES)
    profiler.reset_spans()
    with torch.inference_mode():
        (logits, eager), eager_launches = _launched(lambda: (
            sampler.mc_logits(model, xc, seeds),
            sampler.predictive(model, xc, seeds)))
    check(eager_launches["conv_int8_fused"] == 2 * RESNET_INT8_CONVS
          and profiler.counters().get("quant.conv_kernel")
          == 2 * RESNET_INT8_CONVS,
          f"resnet18_me int8 f32 eager forwards: {eager_launches}, "
          f"counters {profiler.counters()}")
    with torch.inference_mode():
        want = sampler.mc_logits(cpu_model, x, seeds.cpu())
    replay_equal = torch.equal(p.probs, eager.probs)
    got = logits.cpu()
    cpu_equal = torch.equal(got, want)
    check(replay_equal and cpu_equal and not torch.equal(want[0], want[1]),
          f"resnet18_me int8 f32: replay equal to eager {replay_equal}, "
          f"card equal to CPU {cpu_equal} (max abs "
          f"{(got - want).abs().max().item()})")
    return {"config": "resnet18_me_int8_f32", "batch": BATCH,
            "samples": SAMPLES, "compile_conv_int8_fused": n,
            "forward_conv_int8_fused": RESNET_INT8_CONVS,
            "replay_equal_eager": replay_equal, "logits_equal_cpu": cpu_equal}


def _check_threefry(smi: str) -> None:
    """``core.threefry`` (the materialized sites' masks, plain PyTorch on
    the card) against the same functions on the CPU, bit for bit: the
    bits and the keep mask at lenet's site-0 shape (256, 14, 14, 20) for
    SAMPLES seed pairs (the first negative) in one pass, and the keep
    mask's device time there (all of its launches, summed by the
    profiler)."""
    import torch
    from bayestpu_torch.core import threefry
    gen = torch.Generator().manual_seed(99)
    seeds = _inputs(dict(M=1, K=1, N=1, S=SAMPLES), torch.float32, gen)[2]
    bits = threefry.random_bits(seeds, THREEFRY_SITE)
    keep = threefry.bernoulli(seeds, 1.0 - RATE, THREEFRY_SITE)
    torch.cuda.synchronize()
    # the CPU's bits once; its keep mask from them, as bernoulli forms it
    cpu_bits = threefry.random_bits(seeds.cpu(), THREEFRY_SITE)
    same_bits = torch.equal(bits.cpu(), cpu_bits)
    same_keep = torch.equal(keep.cpu(), (cpu_bits >> 9) < (
        threefry.keep_threshold(1.0 - RATE)))
    check(same_bits and same_keep, f"threefry card vs CPU: bits "
          f"{same_bits}, keep {same_keep}")
    elements = SAMPLES * THREEFRY_SITE[0] * 14 * 14 * 20
    emit({"phase": "lenet_threefry", "card": smi, "shape":
          [SAMPLES, *THREEFRY_SITE], "bits_equal_cpu": same_bits,
          "keep_equal_cpu": same_keep,
          "keep_fraction": keep.float().mean().item(),
          "bernoulli_device_ms": device_ms(
              lambda: threefry.bernoulli(seeds, 1.0 - RATE, THREEFRY_SITE),
              5),
          "bernoulli_events_ms": cuda_ms(
              lambda: threefry.bernoulli(seeds, 1.0 - RATE, THREEFRY_SITE),
              5, 3),
          "bernoulli_mask_bytes_bound_ms": elements / MEM_BYTES_PER_S * 1e3})


def phase_lenet(smi: str) -> dict:
    """The LeNet family on MNIST shapes (28x28x1) through the entry points
    a user calls (``get_model``, ``BayesEngine(device="cuda")``,
    ``make_train_step`` with ``get_optimizer(get_recipe("lenet"))``):

    (a) ``lenet_me`` at the JAX bench's config (``bench.py:706-709``:
        batch 256, fused, bf16, MC rate 0.25, S = 10, seeded weights): 2
        ``dropout_matmul_samples`` a spatial predict (the two heads, K =
        100; the backbone runs once), 20 ``dropout_matmul`` a temporal one;
        spatial against temporal, the card against the CPU on rows 0-7,
        p50s and samples/s, and a profiled predict by kernel group.
    (b) ``lenet_me`` trained from seeded weights for LENET_EPOCHS epochs
        of 10,000 synthetic MNIST images with the ``"lenet"`` recipe (Adam
        1e-3, constant, clip 10, batch 128), bf16: a step launches 2
        ``dropout_matmul`` and 4 ``dropout_apply``; the loss falls; the
        weights served on 2,000 test images (acc of each exit > 0.5, ECE,
        aPE, aPE_ood), then on the int8 ``lenet_me`` (``int8_infer``, bf16
        compute: 2 ``dropout_matmul_int8_samples`` a spatial predict, 20
        ``dropout_matmul_int8`` a temporal one; the card against the CPU
        within INT8_CPU_STEPS grid steps, bit-equality reported).
    (c) the materialized routes at batch LENET_SMALL, bf16, seeded
        weights, spatial against temporal and the card against the CPU:
        ``lenet(num_bayes_layers=3, fused=True)`` (the threefry site 0
        inside conv2d_2, then the activations carry S: fc_1 and fc_2 one
        ``dropout_matmul_xs`` each, K = 80 and 100), ``vgg11_me`` with the
        JAX default ``fused=False`` (five materialized heads: no port
        kernel) and ``resnet18(dropout="layer", fused=True)`` on CIFAR-100
        shapes (four materialized in-stage sites, the first of them before
        any conv site, then 6 ``dropout_conv_xs`` at the deferred stage
        boundaries).

    The threefry masks are checked against the CPU first, uncounted."""
    import torch
    from bayestpu_torch.core.config import BayesConfig, QuantConfig
    from bayestpu_torch.data.datasets import get_dataset
    from bayestpu_torch.engine.engine import BayesEngine
    from bayestpu_torch.nn.zoo import get_model
    from bayestpu_torch.train.optim import get_optimizer, get_recipe

    _check_threefry(smi)
    mc_cfg = BayesConfig(rate=RATE)
    int8_q = QuantConfig(8, 0, int8_infer=True)

    def model_fn(name, quant=None, bayes=mc_cfg, fused=True, **kw):
        return lambda: get_model(name, bayes=bayes, fused=fused,
                                 dtype=torch.bfloat16, quant=quant, **kw)

    def float_tol(model, l_cpu):
        return CPU_REF_RTOL * max(1.0, l_cpu.abs().max().item())

    ds = get_dataset("mnist")
    x = torch.from_numpy(ds.x_test[:LENET_BATCH]).cuda()
    recipe = get_recipe("lenet")
    nb = len(ds.x_train) // recipe.batch_size
    xs = torch.from_numpy(ds.x_train[:nb * recipe.batch_size]).cuda(
        ).reshape((nb, recipe.batch_size) + ds.x_train.shape[1:])
    ys = torch.from_numpy(ds.y_train[:nb * recipe.batch_size]).long(
        ).cuda().reshape(nb, recipe.batch_size)
    x_eval = ds.x_test[:2000]
    y_eval = torch.from_numpy(ds.y_test[:2000]).long().cuda()
    # ---- the main path, counted: (a)-(c)
    reset_counts()
    t0 = time.perf_counter()
    out = _block_serve("lenet_me", model_fn("lenet_me"), None,
                       dict(dropout_matmul_samples=2),
                       dict(dropout_matmul=2 * SAMPLES), x,
                       SPATIAL_TEMPORAL_ATOL, float_tol, SAMPLES, False, 2)
    eng = out.pop("engine")
    emit({"phase": "lenet", "config": "lenet_me_bf16_b256", "card": smi,
          "weights": "seeded init", "dtype": "bfloat16", "batch":
          LENET_BATCH, "samples": SAMPLES, "rate": RATE, **out,
          "seconds": time.perf_counter() - t0})
    emit({"phase": "lenet_profile", "config": "lenet_me_bf16_b256",
          "card": smi, "what": "spatial predict, profiled",
          **_profile_predict(eng, x, 11, reps=5)})
    t0 = time.perf_counter()
    model = model_fn("lenet_me")()
    model.reset_parameters(torch.Generator().manual_seed(0))
    variables, fit = _block_finetune(
        model.cuda().train(), xs, ys, LENET_EPOCHS, recipe.lr,
        dict(dropout_matmul=2, dropout_apply=4),
        tx=get_optimizer(recipe, nb))
    losses = fit["epoch_mean_loss"]
    check(losses[-1] < losses[0], f"lenet_me training loss does not fall: "
          f"{losses}")
    served = {}
    for name, quant in (("bf16", None), ("int8", int8_q)):
        eng = BayesEngine(model_fn("lenet_me", quant)(),
                          device="cuda").attach(variables)
        mets = eng.evaluate(x_eval, ds.y_test[:2000], seed=3,
                            num_samples=SAMPLES, ood_check=True,
                            dataset="mnist")
        probs = eng.predict(x_eval, 3, SAMPLES).probs
        accs = (probs.argmax(-1) == y_eval).float().mean(-1).tolist()
        check(min(accs) > 0.5, f"lenet_me {name} exit accuracies {accs}")
        served[name] = {**mets, "exit_acc": accs}
    emit({"phase": "lenet_train", "config": "lenet_me", "card": smi,
          "dtype": "bfloat16", "rate": RATE, "recipe": "lenet (Adam 1e-3, "
          "constant, clip 10)", "data": "synthetic MNIST", **fit,
          "served_2000": served, "seconds": time.perf_counter() - t0})
    t0 = time.perf_counter()
    out = _block_serve("lenet_me_int8", model_fn("lenet_me", int8_q),
                       variables, dict(dropout_matmul_int8_samples=2),
                       dict(dropout_matmul_int8=2 * SAMPLES), x,
                       SPATIAL_TEMPORAL_ATOL,
                       _int8_cpu_tol(int8_q, 1.0 / (1.0 - RATE)), SAMPLES,
                       False, 2)
    out.pop("engine")
    emit({"phase": "lenet", "config": "lenet_me_int8_b256", "card": smi,
          "weights": "trained (b)", "quant": repr(int8_q), "dtype":
          "bfloat16", "batch": LENET_BATCH, "samples": SAMPLES, **out,
          "seconds": time.perf_counter() - t0})
    cifar = get_dataset("cifar100")
    routes = (
        ("lenet_nb3_fused", model_fn("lenet", bayes=BayesConfig(
            rate=RATE, num_bayes_layers=3)), x[:LENET_SMALL],
         dict(dropout_matmul_xs=2, bias_act_bf16=LENET_NB3_CONVS),
         dict(dropout_matmul=2 * SAMPLES,
              bias_act_bf16=LENET_NB3_CONVS * SAMPLES), 1,
         10, SPATIAL_TEMPORAL_ATOL),
        ("vgg11_me_unfused", model_fn("vgg11_me", fused=False),
         torch.from_numpy(cifar.x_test[:LENET_SMALL]).cuda(),
         dict(bias_act_bf16=VGG11_ME_CONVS),
         dict(bias_act_bf16=VGG11_ME_CONVS * SAMPLES), 5, 10,
         SPATIAL_TEMPORAL_ATOL),
        # spatial vs temporal to the resnet phase's tolerance: resnet18
        # runs its convs after the first site at batch S·N in the spatial
        # mapping and N in the temporal one, and cuDNN rounds a bf16 conv
        # by its batch (ROADMAP known differences 11)
        ("resnet18_layer_fused", model_fn("resnet18", dropout="layer",
                                          num_classes=RESNET_CLASSES),
         torch.from_numpy(cifar.x_test[:LENET_SMALL]).cuda(),
         dict(dropout_conv_xs=6, bias_act_bf16=RESNET18_SITE_CONVS),
         dict(dropout_conv=6 * SAMPLES,
              bias_act_bf16=RESNET18_SITE_CONVS * SAMPLES), 1,
         RESNET_CLASSES, CPU_REF_RTOL))
    for name, build, xr, want_sp, want_tm, exits, classes, st_tol in routes:
        t0 = time.perf_counter()
        out = _block_serve(name, build, None, want_sp, want_tm, xr, st_tol,
                           float_tol, SAMPLES, False, exits, classes)
        out.pop("engine")
        emit({"phase": "lenet_materialized", "config": name, "card": smi,
              "weights": "seeded init", "dtype": "bfloat16",
              "batch": LENET_SMALL, "samples": SAMPLES, **out,
              "seconds": time.perf_counter() - t0})
    return {"launches": launch_counts()}


def _compiled(eng, x, seed: int, samples: int, mc: bool = True) -> dict:
    """``BayesEngine.compile`` (a CUDA graph of one predict at x's shape
    and ``samples``): the replayed predictive equal to the eager one bit
    for bit (and, for MC, moved by another seed; after ``init`` draws new
    weights, equal to the eager predict on them), the eager and replayed
    p50s in one call, and the engine's ``benchmark`` and
    ``cost_analysis`` of the compiled engine."""
    import torch

    def same(a, b) -> bool:
        return all(torch.equal(u, v) for u, v in zip(a[:3], b[:3]))

    eager = eng.predict(x, seed, samples)
    eager_p50 = host_ms(lambda: eng.predict(x, seed, samples), 10)
    rep = eng.compile(x, samples)
    replayed = eng.predict(x, seed, samples)
    other = eng.predict(x, seed + 1, samples)
    torch.cuda.synchronize()
    check(same(eager, replayed), f"compiled predict differs from the eager "
          f"one: {(eager.probs - replayed.probs).abs().max().item()}")
    check(not mc or not torch.equal(other.probs, replayed.probs),
          "a replay at another seed gave the same predictive")
    eng.init(1, x[:1].cpu())
    fresh = eng._predict_fn()(x, eng.seeds(seed, samples))
    check(same(fresh, eng.predict(x, seed, samples))
          and not torch.equal(fresh.probs, replayed.probs),
          "a replay after init does not see the new weights")
    return {"compile": rep, "replay_bit_equal_eager": True,
            "eager_p50_ms": eager_p50,
            "replayed_p50_ms": host_ms(lambda: eng.predict(x, seed,
                                                           samples), 10),
            "benchmark": eng.benchmark(x, num_samples=samples,
                                       min_diff_s=COMPILED_WINDOW_S),
            "cost_analysis": eng.cost_analysis(x, samples)}


def phase_convert(smi: str) -> dict:
    """The NN→BNN converter and the rest of the engine (``phase_convert``),
    through ``get_model``, ``Sequential``, ``MCDropoutModel``/
    ``MasksemblesModel`` and ``BayesEngine(device="cuda")``:

    (a) ``vgg19_me`` at full width on CIFAR-100 shapes (fused, bf16, MC
        rate 0.25, batch BATCH, S = SAMPLES, seeded weights): 5
        ``dropout_matmul_samples`` a spatial predict (x 128x512, w
        512x100), 50 ``dropout_matmul`` a temporal one, spatial against
        temporal, the card against the CPU on rows 0-7; a profiled eager
        predict; then ``compile`` (the replayed predictive bit-equal to the
        eager one), the eager and replayed p50s, ``benchmark`` and
        ``cost_analysis``, and a profiled replayed predict. ``vgg16`` and
        ``vgg19`` from the registry, one predict each.
    (b) the converter sweep as ``cli/sweep.py dropouts`` runs it
        (``Sequential(convert_to_bayesian(lenet_specs(), MC 0.25, n),
        fused=True)``, n = 1-4, batch 32, MNIST shapes, S = 4): exact
        launches (n = 2 one ``dropout_matmul_samples`` at fc K = 80, N =
        100; n = 3, 4 one ``dropout_matmul_xs`` after the threefry site),
        spatial against temporal, the card against the CPU, then
        ``_measure``'s keys (``compile_s``, ``latency_ms``,
        ``samples_per_s``, ``flops``, ``bytes_accessed``, ``code_bytes``);
        one Masksembles point (4 masks, scale 2) with two sites, so that
        the first fuses (the ``masks`` sweep's one site sits before the
        last Dense, which never fuses): one ``bank_matmul_samples`` a
        spatial predict; and ``MCDropoutModel``/``MasksemblesModel``
        ``predict`` and ``evaluate`` on the card against the CPU.
    (c) AlexNet at its published widths (224x224x3, 1000 classes, f32,
        batch 32, S = SAMPLES, fused, seeded weights and inputs), n = 3
        (fc6 row 3, fc7 row 3x, a threefry site before fc8) and n = 4
        (conv5's f32 samples launch first, then fc6 and fc7 row 3x):
        exact launches, spatial against temporal, the card against the
        CPU on ALEX_CPU_ROWS rows, then compile as in (a).

    The card-vs-CPU checks of the f32 models hold them to F32_CPU_RTOL,
    vgg19_me's (bf16) to CPU_REF_RTOL. The kernels of (a)-(c) are held
    against their plain versions at these shapes in the kernels phase
    (CONVERT_SHAPES, rows 8-9 at ``sweep_fc1``) and the conv phase
    (``_alex_conv5``)."""
    import torch
    from bayestpu_torch.core.config import BayesConfig, DropoutKind
    from bayestpu_torch.data.datasets import get_dataset
    from bayestpu_torch.engine.engine import BayesEngine
    from bayestpu_torch.interop.from_flax import to_flax_variables
    from bayestpu_torch.nn.convert import (MasksemblesModel, MCDropoutModel,
                                           Sequential, convert_to_bayesian,
                                           lenet_specs)
    from bayestpu_torch.nn.zoo import get_model
    from bayestpu_torch.nn.zoo.autobayes import alexnet_specs

    gen = torch.Generator().manual_seed(4321)
    mc_cfg = BayesConfig(rate=RATE)

    def float_tol(model, l_cpu):          # vgg19_me, bf16
        return CPU_REF_RTOL * max(1.0, l_cpu.abs().max().item())

    def f32_tol(model, l_cpu):            # the f32 Sequential models
        return F32_CPU_RTOL * max(1.0, l_cpu.abs().max().item())

    cifar = get_dataset("cifar100")
    x = torch.from_numpy(cifar.x_test[:BATCH]).cuda()
    mnist = get_dataset("mnist")
    xs = torch.from_numpy(mnist.x_test[:SWEEP_BATCH]).cuda()
    ys = mnist.y_test[:SWEEP_BATCH]
    xa = torch.randn((ALEX_BATCH,) + ALEX_SHAPE, generator=gen).cuda()
    # ---- the main path, counted: (a)-(c)
    reset_counts()
    t0 = time.perf_counter()
    out = _block_serve(
        "vgg19_me", lambda: get_model("vgg19_me", bayes=mc_cfg, fused=True,
                                      dtype=torch.bfloat16),
        None, dict(dropout_matmul_samples=5, bias_act_bf16=VGG19_ME_CONVS),
        dict(dropout_matmul=5 * SAMPLES,
             bias_act_bf16=VGG19_ME_CONVS * SAMPLES), x,
        SPATIAL_TEMPORAL_ATOL, float_tol, SAMPLES, False, 5, RESNET_CLASSES)
    eng = out.pop("engine")
    eager_prof = _profile_predict(eng, x, 11, reps=5)
    out.update(_compiled(eng, x, 11, SAMPLES))
    emit({"phase": "convert", "config": "vgg19_me_bf16_b128", "card": smi,
          "weights": "seeded init", "dtype": "bfloat16", "batch": BATCH,
          "samples": SAMPLES, "rate": RATE, **out,
          "seconds": time.perf_counter() - t0})
    emit({"phase": "convert_profile", "config": "vgg19_me_bf16_b128",
          "card": smi, "what": "spatial predict, eager", **eager_prof})
    emit({"phase": "convert_profile", "config": "vgg19_me_bf16_b128",
          "card": smi, "what": "spatial predict, replayed CUDA graph",
          **_profile_predict(eng, x, 11, reps=5)})
    for name in ("vgg16", "vgg19"):
        e = BayesEngine(get_model(name, bayes=mc_cfg, fused=True,
                                  dtype=torch.bfloat16),
                        device="cuda").init(0, x[:1].cpu())
        p = e.predict(x, 3, SAMPLES).probs
        check(p.shape == (1, BATCH, RESNET_CLASSES)
              and bool(torch.isfinite(p).all()), f"{name} predict")
        emit({"phase": "convert", "config": f"{name}_bf16_b128",
              "card": smi, "probs_shape": list(p.shape),
              "spatial_p50_ms": host_ms(lambda: e.predict(x, 3, SAMPLES),
                                        5)})
    # (b) the converter sweep
    sweep = [(n, BayesConfig(rate=RATE, num_bayes_layers=n,
                             num_samples=SWEEP_SAMPLES),
              {2: dict(dropout_matmul_samples=1)}.get(
                  n, dict(dropout_matmul_xs=1) if n > 2 else {}),
              dict(dropout_matmul=SWEEP_SAMPLES) if n > 1 else {})
             for n in SWEEP_N]
    sweep.append(("mask", BayesConfig(kind=DropoutKind.MASK,
                                      num_masks=NUM_MASKS, scale=MASK_SCALE,
                                      num_bayes_layers=2),
                  dict(bank_matmul_samples=1), dict(bank_matmul=NUM_MASKS)))
    for n, cfg, want_sp, want_tm in sweep:
        t0 = time.perf_counter()
        mask = cfg.kind is DropoutKind.MASK
        samples = NUM_MASKS if mask else SWEEP_SAMPLES
        out = _block_serve(
            f"sweep_{n}", lambda: Sequential(convert_to_bayesian(
                lenet_specs(), cfg), (28, 28, 1), fused=True),
            None, want_sp, want_tm, xs, SPATIAL_TEMPORAL_ATOL, f32_tol,
            samples, mask)
        eng = out.pop("engine")
        comp = _compiled(eng, xs, 11, samples, not mask)
        bench, cost = comp["benchmark"], comp["cost_analysis"]
        emit({"phase": "convert_sweep", "card": smi,
              "sweep": "masks" if mask else "dropouts",
              "n_bayes_layers": cfg.num_bayes_layers, "batch": SWEEP_BATCH,
              "samples": samples, "fused": True,
              "compile_s": comp["compile"]["compile_seconds"],
              "latency_ms": bench["latency_s"] * 1e3,
              "samples_per_s": bench["samples_per_s"],
              "flops": cost["flops"],
              "bytes_accessed": cost["bytes_accessed"],
              "code_bytes": cost["generated_code_size_in_bytes"],
              **out, **comp, "seconds": time.perf_counter() - t0})
    for cls, kw in ((MCDropoutModel, dict(num_samples=SWEEP_SAMPLES,
                                          rate=RATE, num=2)),
                    (MasksemblesModel, dict(num_masks=NUM_MASKS,
                                            scale=MASK_SCALE, num=2))):
        card = cls(lenet_specs(), **kw)
        card.init(0, xs[:1].cpu())
        cpu = cls(lenet_specs(), input_shape=(28, 28, 1), device="cpu", **kw)
        cpu.attach(to_flax_variables(card.model))
        p, p_cpu = card.predict(xs, 3).cpu(), cpu.predict(xs.cpu(), 3)
        d = (p - p_cpu).abs().max().item()
        m, m_cpu = card.evaluate(xs, ys, 3), cpu.evaluate(xs.cpu(), ys, 3)
        check(d <= F32_CPU_RTOL and abs(m["acc"] - m_cpu["acc"]) <= 1 / 16,
              f"{cls.__name__} card vs CPU: probs {d}, acc {m} {m_cpu}")
        emit({"phase": "convert_wrapper", "wrapper": cls.__name__,
              "card": smi, **kw, "batch": SWEEP_BATCH,
              "card_vs_cpu_probs_max_abs": d, "evaluate": m,
              "evaluate_cpu": m_cpu})
    # (c) AlexNet at full width
    for n in (3, 4):
        t0 = time.perf_counter()
        cfg = BayesConfig(rate=RATE, num_bayes_layers=n)
        want_sp = (dict(dropout_matmul_samples=1, dropout_matmul_xs=1)
                   if n == 3 else dict(dropout_conv_samples=1,
                                       dropout_matmul_xs=2))
        want_tm = dict(dropout_matmul=2 * SAMPLES, **(
            {} if n == 3 else dict(dropout_conv=SAMPLES)))
        out = _block_serve(
            f"alexnet_n{n}", lambda: Sequential(convert_to_bayesian(
                alexnet_specs(ALEX_CLASSES), cfg), ALEX_SHAPE, fused=True),
            None, want_sp, want_tm, xa, SPATIAL_TEMPORAL_ATOL, f32_tol,
            SAMPLES, False, 1, ALEX_CLASSES, ALEX_CPU_ROWS)
        eng = out.pop("engine")
        out.update(_compiled(eng, xa, 11, SAMPLES))
        emit({"phase": "convert", "config": f"alexnet_n{n}_f32_b32",
              "card": smi, "weights": "seeded init", "dtype": "float32",
              "batch": ALEX_BATCH, "samples": SAMPLES, "rate": RATE, **out,
              "profile": _profile_predict(eng, xa, 11, reps=3),
              "seconds": time.perf_counter() - t0})
    return {"launches": launch_counts()}


# the shard phase: the seed of its model, data and MC seeds, the longest a
# world may take, the f32 steps against one process, and the bf16 replica
# steps; its worlds meet in a directory of the checkout
SHARD_SEED, SHARD_TIMEOUT_S, SHARD_F32_STEPS, SHARD_BF16_STEPS = 15, 180, 2, 3
# each parameter's update after the f32 steps within SHARD_STEP_RTOL of its
# norm plus SHARD_STEP_ATOL. The f32 vgg11_me step at batch 128 is
# ill-conditioned in BatchNorm's backward (E[x²] − E[x]² and its
# gradient cancel): on the CPU (vgg11, rate 0, batch 128) the one-process
# f32 step's gradients lie up to 1.4e-3 of a norm from the float64 step,
# the data-parallel f32 step 6.4e-3 from the one-process one while both
# float64 steps agree to 3e-7, and two steps' updates 1.7e-2 apart; so
# 5e-2, which a wrong mask row, a missing division by the data axis or a
# BatchNorm on local statistics misses by far (the CPU tests hold the
# data-parallel step to the float64 step within 3e-4 at batch 8). ATOL:
# the CPU tests' gradient floor (1e-5, for a bias that feeds a BatchNorm
# and has a gradient of rounding noise alone) carried through SGD with
# momentum 0.9 at LR 0.01 over two steps (at most 2.9 LR a gradient)
SHARD_STEP_RTOL, SHARD_STEP_ATOL = 5e-2, 2.9 * 0.01 * 1e-5
SHARD_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_shard"


def _shard_rank(rank: int, world: int, workdir: str, backend: str) -> None:
    """One rank of a shard-phase world on cuda:0; its results go to
    ``workdir/rank<r>.json``. Rank 0's weights reach every rank by
    ``replicate`` (each rank draws its own first)."""
    import copy
    import torch
    torch.cuda.set_device(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from bayestpu_torch.core.config import BayesConfig
    from bayestpu_torch.core.rng import sample_seeds, step_seeds
    from bayestpu_torch.engine import distributed, sampler, sharding
    from bayestpu_torch.nn.zoo import get_model
    from bayestpu_torch.train.loop import TrainState, make_train_step
    from bayestpu_torch.train.optim import get_optimizer, get_recipe

    distributed.initialize(f"file://{workdir}/rendezvous", world, rank,
                           backend)
    out: dict = {"rank": rank, "backend": backend}
    gen = torch.Generator().manual_seed(SHARD_SEED)
    x = torch.randn(BATCH, 32, 32, 3, generator=gen).cuda()
    y = torch.randint(0, 10, (BATCH,), generator=gen).cuda()
    meshes = {m: sharding.make_mesh(*m) for m in dict.fromkeys(
        [(1, world), (world, 1)])}
    sample_mesh, data_mesh = meshes[(1, world)], meshes[(world, 1)]

    def model_of(dtype, seed):
        m = get_model("vgg11_me", bayes=BayesConfig(rate=RATE), fused=True,
                      dtype=dtype)
        m.reset_parameters(torch.Generator().manual_seed(seed + rank))
        return sharding.replicate(m.cuda(), sample_mesh)

    model = model_of(torch.bfloat16, SHARD_SEED).eval()
    seeds = sample_seeds(SHARD_SEED, SAMPLES, model.num_sites).cuda()
    reset_counts()
    with torch.inference_mode():
        local = model(x, seeds).logits.float()
        lp = torch.softmax(local, dim=-1)
        lmean = lp.mean(0)
        for (d, s), mesh in meshes.items():
            before = launch_counts()
            got = sharding.sharded_predictive(model, x, seeds, mesh)
            torch.cuda.synchronize()
            after = launch_counts()
            blk, a, row0 = sharding.shard_logits(model, x, seeds, mesh)
            ref = local[a:a + blk.shape[0], :, row0:row0 + blk.shape[-2]]
            out[f"mesh_{d}x{s}"] = {
                "logits_bit_equal_local": torch.equal(blk.float(), ref),
                "logits_max_abs_err": (blk.float() - ref).abs().max().item(),
                "max_abs_logit": ref.abs().max().item(),
                "mean_max_abs_err": (got.probs - lmean).abs().max().item(),
                "var_max_abs_err": (got.var - lp.var(0, correction=0)
                                    ).abs().max().item(),
                "num_samples": got.num_samples,
                "launches": {k: after[k] - before[k] for k in after
                             if after[k] != before[k]},
                "p50_ms": host_ms(lambda m=mesh: sharding.sharded_predictive(
                    model, x, seeds, m), 10)}
        out["local_p50_ms"] = host_ms(
            lambda: sampler.predictive(model, x, seeds), 10)
        parts = distributed.eval_step_metrics(lmean[-1], y)
        out["evaluate_local"] = {k: v.item() for k, v in
                                 distributed.finalize_metrics(parts).items()}
    out["evaluate"] = distributed.distributed_evaluate(
        model, x, y, SAMPLES, sample_mesh, seed=SHARD_SEED)

    # f32 data-parallel steps at global batch 128 against one process
    xs = torch.randn(SHARD_F32_STEPS, BATCH, 32, 32, 3, generator=gen).cuda()
    ys = torch.randint(0, 10, (SHARD_F32_STEPS, BATCH), generator=gen).cuda()
    f32 = model_of(torch.float32, SHARD_SEED + 1)
    one = copy.deepcopy(f32)
    start = {k: p.detach().clone() for k, p in f32.named_parameters()}
    tx = get_optimizer(get_recipe("vgg19", lr=0.01), 10)
    for mdl, mesh in ((f32, data_mesh), (one, None)):
        if mesh is None and rank != 0:
            break
        mdl.train()
        state = TrainState(mdl, tx.init(dict(mdl.named_parameters())))
        step = make_train_step(mdl, tx, mesh=mesh)
        for i in range(SHARD_F32_STEPS):
            step(state, xs[i], ys[i], step_seeds(SHARD_SEED, i,
                                                 mdl.num_sites).cuda())
    if rank == 0:
        errs = {}
        for (k, p), q in zip(f32.named_parameters(), one.parameters()):
            du, dv = p.detach() - start[k], q.detach() - start[k]
            errs[k] = ((du - dv).norm().item(), dv.norm().item())
        share = {k: e / (SHARD_STEP_RTOL * n + SHARD_STEP_ATOL)
                 for k, (e, n) in errs.items()}
        worst = max(share, key=share.get)
        rel = max((e / n, k) for k, (e, n) in errs.items()
                  if SHARD_STEP_RTOL * n > SHARD_STEP_ATOL)
        out["f32_steps"] = {"worst_param": worst,
                            "worst_err_over_bound": share[worst],
                            "worst_update_err": errs[worst][0],
                            "worst_update_norm": errs[worst][1],
                            "worst_rel_err_above_atol": rel[0],
                            "worst_rel_err_param": rel[1]}
    # bf16 steps: the replicas stay bit-identical
    bf = model_of(torch.bfloat16, SHARD_SEED + 2).train()
    state = TrainState(bf, tx.init(dict(bf.named_parameters())))
    step = make_train_step(bf, tx, mesh=data_mesh)
    for i in range(SHARD_BF16_STEPS):
        step(state, xs[i % SHARD_F32_STEPS], ys[i % SHARD_F32_STEPS],
             step_seeds(SHARD_SEED + 2, i, bf.num_sites).cuda())
    flat = torch.cat([p.detach().reshape(-1) for p in bf.parameters()])
    every = flat.new_zeros(world, flat.numel())
    every[rank] = flat
    sharding.all_reduce(every, torch.distributed.group.WORLD)
    out["bf16_replicas_bit_identical"] = all(
        torch.equal(every[r], every[0]) for r in range(world))
    torch.cuda.synchronize()
    out["launches"] = launch_counts()
    torch.distributed.destroy_process_group()
    with open(Path(workdir) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)


def _shard_world(world: int, backend: str) -> list:
    """Run a ``world``-rank ``backend`` world of ``_shard_rank`` on the one
    card; every rank's results. A rank that fails or a world that outlasts
    SHARD_TIMEOUT_S fails the phase (its processes are ended)."""
    import multiprocessing as mp
    workdir = SHARD_DIR / backend
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_shard_rank,
                         args=(r, world, str(workdir), backend))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + SHARD_TIMEOUT_S
    for p in procs:
        p.join(max(deadline - time.monotonic(), 1.0))
    late = [p for p in procs if p.is_alive()]
    for p in late:
        p.kill()
        p.join()
    check(not late, f"the {backend} world outlasted {SHARD_TIMEOUT_S} s")
    codes = [p.exitcode for p in procs]
    check(codes == [0] * world, f"the {backend} world's ranks exited {codes}")
    outs = []
    for r in range(world):
        with open(workdir / f"rank{r}.json") as f:
            outs.append(json.load(f))
    return outs


def phase_shard(smi: str) -> dict:
    """The shard phase (16 in the list above). Returns ``launches``: rank 0
    of the gloo world's launch counts, every launch of its sharded
    predicts, evaluate and steps."""
    launches = None
    for world, backend in ((2, "gloo"), (1, "nccl")):
        outs = _shard_world(world, backend)
        r0 = outs[0]
        for key in [k for k in r0 if k.startswith("mesh_")]:
            d = int(key.split("_")[1].split("x")[0])
            for o in outs:
                got = o[key]
                check(got["num_samples"] == SAMPLES,
                      f"{backend} {key}: {got['num_samples']} samples")
                check(got["launches"] == {"dropout_matmul_samples": 5,
                                          "bias_act_bf16": VGG11_ME_CONVS},
                      f"{backend} {key} launches {got['launches']}")
                if d == 1:
                    check(got["logits_bit_equal_local"]
                          and got["mean_max_abs_err"] <= 1e-6
                          and got["var_max_abs_err"] <= 1e-6,
                          f"{backend} {key} against the local predict: "
                          f"{got}")
                else:
                    check(got["logits_max_abs_err"]
                          <= CPU_REF_RTOL * max(1.0, got["max_abs_logit"])
                          and got["mean_max_abs_err"] <= CPU_REF_RTOL,
                          f"{backend} {key} against the local predict: "
                          f"{got}")
        ev, ev_local = r0["evaluate"], r0["evaluate_local"]
        check(all(o["evaluate"] == ev for o in outs)
              and abs(ev["acc"] - ev_local["acc"]) <= 1.0 / BATCH
              and abs(ev["nll"] - ev_local["nll"]) <= 1e-4 * max(
                  1.0, ev_local["nll"])
              and abs(ev["ece"] - ev_local["ece"]) <= 1e-4
              and ev["n"] == BATCH,
              f"{backend} distributed_evaluate {ev} against {ev_local}")
        check(r0["f32_steps"]["worst_err_over_bound"] <= 1.0,
              f"{backend} f32 data-parallel steps: {r0['f32_steps']}")
        check(all(o["bf16_replicas_bit_identical"] for o in outs),
              f"{backend} bf16 replicas differ")
        line = {"phase": "shard", "backend": backend, "world": world,
                "nvidia_smi": smi,
                **{k: r0[k] for k in r0 if k.startswith("mesh_")},
                "local_p50_ms": r0["local_p50_ms"],
                "evaluate": ev, "evaluate_local": ev_local,
                "f32_steps": r0["f32_steps"],
                "bf16_replicas_bit_identical": True}
        if backend == "gloo":
            launches = r0["launches"]
            line["p50_note"] = ("two ranks share one card: mechanics, not "
                                "scaling")
        emit(line)
    return {"launches": launches}


# the tools phase: row 3's bound at the head shape in PERF.md's kernel
# table (ms), the share of it the roofline may miss, the least share of
# the profiler's device time the graph timer may read, and its work files
ROW3_BOUND_MS, ROW3_BOUND_RTOL, SCAN_DEVICE_FLOOR = 0.0000575, 0.01, 0.95
TOOLS_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_tools"


def _tools_scan(smi: str) -> dict:
    """``scan_time_s`` of the flagship's spatial predict (vgg11_me bf16,
    batch 128, S = 10, seeded weights), beside the profiler's device time
    of one predict and the eager p50: the graph timer must read at least
    SCAN_DEVICE_FLOOR of the device time (it replays every kernel, plus
    the carry's add and the output's sums) and at most the eager p50 (it
    takes the host's dispatch out)."""
    import torch
    from bayestpu_torch.core.config import BayesConfig
    from bayestpu_torch.engine.engine import BayesEngine
    from bayestpu_torch.nn.zoo import get_model
    from bayestpu_torch.utils.timing import scan_time_s
    gen = torch.Generator().manual_seed(7)
    x = torch.randn(BATCH, 32, 32, 3, generator=gen).cuda()
    eng = BayesEngine(get_model("vgg11_me", bayes=BayesConfig(rate=RATE),
                                fused=True, dtype=torch.bfloat16),
                      device="cuda").init(0, x[:1].cpu())
    seed = 11
    fn, seeds = eng._predict_fn(), eng.seeds(seed, SAMPLES)
    eng.predict(x, seed, SAMPLES)
    eager_ms = host_ms(lambda: eng.predict(x, seed, SAMPLES), 30)
    prof = _profile_predict(eng, x, seed, reps=10)
    device = prof["device_ms_per_predict"]
    check(isinstance(device, float), "the profiler saw no device time")
    t0 = time.perf_counter()
    scan = scan_time_s(lambda c: fn(x + c, seeds), torch.device("cuda"),
                       min_diff_s=0.1)
    scan_s = time.perf_counter() - t0
    scan_ms = scan.median_s * 1e3
    check(not scan.rtt_fallback, f"scan windows not positive: {scan}")
    check(SCAN_DEVICE_FLOOR * device <= scan_ms <= eager_ms,
          f"scan {scan_ms} ms outside [{SCAN_DEVICE_FLOOR} x device "
          f"{device} ms, eager p50 {eager_ms} ms]")
    return {"config": "vgg11_me_bf16_b128_s10", "scan_ms": scan_ms,
            "scan_windows_ms": [w * 1e3 for w in scan.windows],
            "scan_k": scan.k, "scan_seconds": scan_s,
            "profiler_device_ms": device,
            "profiler_launches": prof["kernel_launches_per_predict"],
            "eager_p50_ms": eager_ms,
            "scan_over_device": scan_ms / device}


def _tools_resume(smi: str) -> dict:
    """A 2-epoch ``lenet_me`` run on the card (bf16, the ``"lenet"``
    recipe, 4,096 synthetic MNIST images at batch 128, validation,
    reshuffle and ``random_crop_flip``), and the same run stopped after
    epoch 0, restored from its checkpoint into a model of another init and
    continued: parameters, buffers, optimizer state and step bit-identical
    (cuDNN in its deterministic mode for both)."""
    import torch
    from bayestpu_torch.core.config import BayesConfig
    from bayestpu_torch.data.augment import random_crop_flip
    from bayestpu_torch.data.datasets import get_dataset, iterate_batches
    from bayestpu_torch.nn.zoo import get_model
    from bayestpu_torch.train.checkpoint import restore_checkpoint
    from bayestpu_torch.train.loop import (_tensors_of, create_state,
                                           train_loop)
    from bayestpu_torch.train.optim import get_optimizer, get_recipe
    ds = get_dataset("mnist", str(TOOLS_DIR / "no_data"), n_synth_train=4096,
                     n_synth_test=512)
    recipe = get_recipe("lenet")

    def setup(seed):
        model = get_model("lenet_me", bayes=BayesConfig(rate=RATE),
                          fused=True, dtype=torch.bfloat16)
        tx = get_optimizer(recipe, 4096 // recipe.batch_size)
        return model, tx, create_state(model, tx, seed, ds.x_train[:8])

    def run(model, state, tx, epochs, ckpt, **kw):
        train_loop(model, state, tx, lambda: iterate_batches(
            ds.x_train, ds.y_train, recipe.batch_size, seed=1), 5, epochs,
            val_batches=lambda: iterate_batches(ds.x_test, ds.y_test, 256,
                                                shuffle=False),
            augment_fn=lambda s, xb, i: random_crop_flip(s, xb, 4, i),
            reshuffle=True, checkpoint_dir=str(ckpt), log_fn=lambda m: None,
            **kw)

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        t0 = time.perf_counter()
        model, tx, state = setup(0)
        run(model, state, tx, 2, TOOLS_DIR / "whole")
        m1, tx1, s1 = setup(0)
        run(m1, s1, tx1, 1, TOOLS_DIR / "part")
        m2, tx2, template = setup(3)
        s2, seed, aux = restore_checkpoint(str(TOOLS_DIR / "part"),
                                           template, with_aux=True)
        run(m2, s2, tx2, 2, TOOLS_DIR / "rest", start_epoch=aux["epoch"] + 1,
            best0=(aux["best_metric"], aux["best_params"],
                   aux["since_best"]))
        seconds = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.deterministic = det
    check(seed == 5 and s2.step == state.step == 2 * 4096 // 128,
          f"resumed steps {s2.step} vs {state.step}")
    worst = 0.0
    pairs = (list(zip(model.parameters(), m2.parameters()))
             + list(zip(model.buffers(), m2.buffers()))
             + list(zip(_tensors_of(state.opt_state),
                        _tensors_of(s2.opt_state))))
    for a, b in pairs:
        worst = max(worst, (a.float() - b.float()).abs().max().item())
    check(worst == 0.0, f"resumed run differs from the whole run by {worst}")
    check(next(model.parameters()).is_cuda, "the resume ran off the card")
    return {"config": "lenet_me_bf16_b128_2_epochs", "steps": state.step,
            "compared_tensors": len(pairs), "max_abs_diff": worst,
            "seconds": seconds}


def _tools_cli(smi: str) -> dict:
    """``cli.train`` (``lenet_me``, ``--fused``, 1 epoch at batch 64 of
    synthetic MNIST) → ``cli.predict`` → ``cli.build`` in this process, on
    the card by default (no ``--device``); their own output goes to
    ``TOOLS_DIR/cli.log``."""
    import contextlib
    import math
    from bayestpu_torch.cli import build, predict, train
    common = ["--model", "lenet_me", "--dataset", "mnist", "--dropout_type",
              "mc", "--mc_samples", "3", "--fused", "--data_dir",
              str(TOOLS_DIR / "no_data")]
    out = str(TOOLS_DIR / "ckpt")
    t0 = time.perf_counter()
    with open(TOOLS_DIR / "cli.log", "w") as log, \
            contextlib.redirect_stdout(log):
        tr = train.main(common + ["--epochs", "1", "--batch_size", "64",
                                  "--out", out])
        pr = predict.main(common + ["--load_model", out])
        bd = build.main(common + ["--load_model", out, "--output_dir",
                                  str(TOOLS_DIR / "build_prj")])
    seconds = time.perf_counter() - t0
    check(Path(out + "_last").is_dir(), "cli.train wrote no <out>_last")
    for name, rep in (("train", tr), ("temporal", pr["temporal"]),
                      ("spatial", pr["spatial"])):
        check(all(math.isfinite(v) for v in rep.values()
                  if isinstance(v, float)), f"cli {name}: {rep}")
        check(0.0 <= rep["acc"] <= 1.0, f"cli {name} acc {rep['acc']}")
    check(bd["strategy_mode"] == "spatial" and bd["flops"] > 0
          and bd["temp_size_in_bytes"] > 0 and bd["launches"] > 0,
          f"cli build report {bd}")
    return {"train_acc": tr["acc"], "train_ece_hist": tr["ece_hist"],
            "predict_spatial_acc": pr["spatial"]["acc"],
            "predict_temporal_acc": pr["temporal"]["acc"],
            "build_compile_seconds": bd["compile_seconds"],
            "build_device_ms": bd["device_ms"],
            "build_launches": bd["launches"], "build_flops": bd["flops"],
            "build_temp_bytes": bd["temp_size_in_bytes"],
            "seconds": seconds}


def phase_tools(smi: str) -> dict:
    """The tooling (ROADMAP Queue 1 item 14) on the card: row 3's roofline
    at the head shape (its bound PERF.md's ROW3_BOUND_MS within
    ROW3_BOUND_RTOL, its work 2·S·M·N·K from the wrapper's count) and
    ``bench.kernels`` at the head shape, uncounted (kernel benches); then,
    counted, the graph timer on the flagship predict (``_tools_scan``), a
    resumed ``lenet_me`` run (``_tools_resume``) and the CLIs
    (``_tools_cli``). Also ``--only tools``."""
    import math
    import torch
    from bayestpu_torch.bench.kernels import bench_shape
    from bayestpu_torch.kernels import masked_matmul as mm
    from bayestpu_torch.utils.profiler import roofline
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    TOOLS_DIR.mkdir(parents=True)
    gen = torch.Generator().manual_seed(3)
    m, k, n = 128, 512, 10
    x = torch.randn(m, k, generator=gen).bfloat16().cuda()
    w = (torch.randn(k, n, generator=gen) / k ** 0.5).bfloat16().cuda()
    seeds = torch.randint(-2 ** 31, 2 ** 31 - 1, (SAMPLES, 2), generator=gen,
                          dtype=torch.int64).to(torch.int32).cuda()
    t0 = time.perf_counter()
    roof = roofline(lambda a, b, s: mm.dropout_matmul_samples(a, b, s, RATE),
                    x, w, seeds, mxu_dtype="bf16")
    roof_s = time.perf_counter() - t0
    bound_ms = roof["speed_of_light_s"] * 1e3
    check(roof["chip"] == "h100" and roof["bound"] == "memory",
          f"row 3 roofline {roof}")
    check(abs(bound_ms - ROW3_BOUND_MS) <= ROW3_BOUND_RTOL * ROW3_BOUND_MS,
          f"row 3 bound {bound_ms} ms, PERF.md {ROW3_BOUND_MS}")
    flops = roof["achieved_tflops"] * 1e12 * roof["seconds"]
    check(abs(flops - 2 * SAMPLES * m * n * k) <= 1e-6 * flops,
          f"row 3 work {flops} != 2·S·M·N·K")
    emit({"phase": "tools_roofline", "card": smi, "kernel":
          "dropout_matmul_samples", "shape": [SAMPLES, m, k, n], **roof,
          "bound_ms": bound_ms, "perf_md_bound_ms": ROW3_BOUND_MS,
          "wall_seconds": roof_s})
    t0 = time.perf_counter()
    bench = bench_shape(m, k, n, "cuda", min_diff_s=0.02)
    check(all(math.isfinite(v) and v > 0 for key, v in bench.items()
              if key.endswith("_ms")), f"bench.kernels {bench}")
    emit({"phase": "tools_bench_kernels", "card": smi, **bench,
          "wall_seconds": time.perf_counter() - t0})
    reset_counts()
    emit({"phase": "tools_scan", "card": smi, **_tools_scan(smi)})
    emit({"phase": "tools_resume", "card": smi, **_tools_resume(smi)})
    emit({"phase": "tools_cli", "card": smi, **_tools_cli(smi)})
    launches = launch_counts()
    emit({"phase": "tools", "card": smi, "launches": launches})
    return {"launches": launches}


def phase_step_vs_cpu() -> None:
    """One training step of vgg11_me at batch 8 on the card and on the
    CPU (``_step_vs_cpu``)."""
    _step_vs_cpu("vgg11_me", 10, [f"exit{i}.linear.kernel"
                                  for i in range(1, 5)]
                 + ["classifier.kernel"])


def _step_vs_cpu(model_name: str, classes: int, heads: list[str]) -> None:
    """One training step at batch 8 on the card and on the CPU, from one
    seeded init and the same step seeds, f32 and bf16 (STEP_TOL has the
    tolerances; in bf16 only the ``heads`` updates are gated)."""
    import numpy as np
    import torch
    from bayestpu_torch.core.config import BayesConfig
    from bayestpu_torch.core.rng import step_seeds
    from bayestpu_torch.nn.zoo import get_model
    from bayestpu_torch.train import optim
    from bayestpu_torch.train.loop import create_state, make_train_step

    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.random((8, 32, 32, 3), dtype=np.float32))
    y = torch.from_numpy(rng.integers(0, classes, size=8))
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        res = {}
        for dev in ("cuda", "cpu"):
            model = get_model(model_name, bayes=BayesConfig(rate=RATE),
                              fused=True, dtype=dtype, num_classes=classes)
            tx = optim.chain(optim.clip_by_global_norm(TRAIN_CLIP), optim.sgd(
                optim.cosine_decay_schedule(TRAIN_LR, 10), 0.9))
            state = create_state(model, tx, 3, x, device=dev)
            before = {kk: p.detach().cpu().clone()
                      for kk, p in model.named_parameters()}
            m = make_train_step(model, tx)(
                state, x.to(dev), y.to(dev),
                step_seeds(3, 0, model.num_sites).to(dev))
            res[dev] = (float(m["loss"]), float(m["grad_norm"]),
                        {kk: p.detach().cpu() - before[kk]
                         for kk, p in model.named_parameters()},
                        {kk: b.detach().cpu()
                         for kk, b in model.named_buffers()})
        (lc, nc, uc, bc), (lr, nr, ur, br) = res["cuda"], res["cpu"]
        tol = STEP_TOL[name]
        total = torch.sqrt(sum((u * u).sum() for u in ur.values())).item()

        def rel(a, b, floor=0.0):
            return (a - b).norm().item() / (b.norm().item() + floor)

        loss_rel = abs(lc - lr) / abs(lr)
        stats_rel = max(rel(bc[kk], br[kk]) for kk in br)
        upd = {kk: rel(uc[kk], ur[kk], 1e-3 * total) for kk in ur}
        gated = upd if name == "float32" else {kk: upd[kk] for kk in heads}
        worst = max(gated, key=gated.get)
        check(loss_rel <= tol["loss"] and stats_rel <= tol["stats"]
              and gated[worst] <= tol["update"],
              f"card vs CPU step {name}: loss {loss_rel}, stats {stats_rel},"
              f" update {worst} {gated[worst]} (tolerances {tol})")
        emit({"phase": "step_vs_cpu", "model": model_name, "dtype": name,
              "batch": 8,
              "loss_card": lc, "loss_cpu": lr, "loss_rel": loss_rel,
              "grad_norm_card": nc, "grad_norm_cpu": nr,
              "bn_stats_max_rel": stats_rel,
              "head_update_rel": {kk: upd[kk] for kk in heads},
              "worst_update_rel": [worst, gated[worst]],
              "worst_any_update_rel": max(upd.values()), "tol": tol})


def main(argv: list[str]) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs only on a machine with an NVIDIA card", file=sys.stderr)
        return 1
    import bayestpu_torch  # noqa: F401  (fails outside a checkout)

    partial = {"kernels": phase_kernels, "conv": phase_conv_kernels,
               "epilogue": phase_epilogue,
               "convert": lambda: phase_convert(smi),
               "shard": lambda: phase_shard(smi),
               "tools": lambda: phase_tools(smi)}
    only = None
    if argv:
        check(len(argv) == 2 and argv[0] == "--only"
              and set(argv[1].split(",")) <= set(partial),
              f"usage: chip_smoke.py [--only {','.join(partial)}]; got "
              f"{argv}")
        only = argv[1].split(",")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = phase_card()
    phase_build()
    seconds = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        seconds[name] = time.perf_counter() - t0
        print(f"chip_smoke: phase {name} took {seconds[name]:.1f} s",
              file=sys.stderr, flush=True)
        return out

    if only is not None:
        for name in only:
            timed(name, partial[name])
        emit({"partial": only})
        return 0

    summary = timed("kernels", phase_kernels)
    summary.update(timed("conv", phase_conv_kernels))
    summary.update(timed("epilogue", phase_epilogue))
    timed("backward", phase_backward)
    sl = timed("slice", phase_slice)
    timed("profile", phase_profile, sl)
    tr = timed("train", phase_train)
    i8 = timed("int8", phase_int8, tr)
    an = timed("analysis", phase_analysis, tr, i8, smi)
    mk = timed("mask", phase_mask, tr)
    bl = timed("block", phase_block, tr)
    rn = timed("resnet", phase_resnet, smi)
    ln = timed("lenet", phase_lenet, smi)
    cv = timed("convert", phase_convert, smi)
    timed("step_vs_cpu", phase_step_vs_cpu)
    sh = timed("shard", phase_shard, smi)
    tl = timed("tools", phase_tools, smi)
    emit({"phase": "seconds", **seconds})
    kernels = []
    for name, stats in summary.items():
        launches = sum(ph["launches"][name]
                       for ph in (sl, tr, i8, an, mk, bl, rn, ln, cv, sh, tl))
        check(launches > 0, f"{name} was never launched on the main paths")
        source, replaces = (
            (CONV_SOURCE, CONV_REPLACES) if name in CONV_REPLACES else
            (EPILOGUE_SOURCE, EPILOGUE_REPLACES)
            if name in EPILOGUE_REPLACES else (SOURCE, REPLACES))
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces[name],
                        "launches": launches,
                        "max_abs_err": stats["max_abs_err"],
                        "ms": stats["ms"], "plain_ms": stats["plain_ms"],
                        "bound_ms": stats["bound_ms"],
                        "bound_by": stats["bound_by"],
                        "library_ms": stats["library_ms"]})
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
