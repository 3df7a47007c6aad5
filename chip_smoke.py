#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (mmnn_sts_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--phases kernel_phase,cli_phase,...]

Phases; any failure is an uncaught exception and a nonzero exit:

1. Device: requires CUDA; prints the card's name and power limit.
2. Build: compiles every CUDA kernel of the port from the sources in this
   checkout (one nvcc per source, all at once) and, beside them, the host
   C++ library of the cohort build (native/mmnn_native.cpp, g++), and
   prints the seconds taken.
3. Kernel: calls fused_bn_relu_matmul on the card at every (M, Cin) shape of
   DenseNet121's 58 bottlenecks at 64^3, for every batch bucket of the
   servable (1, 2, 4, 8, 16, 32), in float32 (fused_bn_relu_matmul.cu, the
   CUDA cores) and bfloat16 (fused_bn_relu_matmul_bf16.cu, the tensor
   cores), and holds each
   result against the plain PyTorch version on the same inputs: max
   |kernel - plain| / max |plain| <= 1e-4 in float32 (sums in another
   order) and 2e-2 in bfloat16 (output rounded to bfloat16). Each shape
   also must give the same bits in two calls, and with a NaN in x the
   kernel's NaN rows must be the plain version's. Prints each shape's
   launch plan (tile, K-split, CTAs). Times the kernel, the plain version
   and torch.matmul of the product alone (a yardstick, not the same
   function) with CUDA events, inputs warm in L2: device time (calls
   queued behind a sleeping kernel), paced time (no sleep: the host's
   launch cost shows where it exceeds the device's) and the host's time
   to enqueue a call, beside the least time the card could take, and
   each block's share of that bound. Then times every launch plan each
   kernel takes at every shape of bucket 8 (the training microbatch),
   each checked against the plain version, beside the plan launch_plan picks
   (plan_sweep.jsonl in the output directory). Then the same checks at every
   bottleneck shape of densenet169, densenet201 and densenet264 at batch 8
   (82, 98 and 130 calls, K up to 2,656), in both dtypes; densenet264's 130
   timed per block beside the plain version, the product alone and the
   bound.
4. Serve: the flagship model at full width (DenseNet121-3D at 64^3 x 2ch +
   the 11-feature clinical MLP, blend heads), with weights drawn with numpy
   from --seed in the JAX package's flat key layout (unfused names) and
   carried across with convert.py, exported with export_forward and served
   by ModelServer on the card on an ephemeral port. npz requests of batch 1,
   3 and 8 (six rounds; the first warms up). Each answer must be (B, 2) and
   finite, each served forward must launch the kernel exactly 58 times, and
   the answers must match the same servable run with the plain op in place
   of the kernel on the same card (max |diff| <= 1e-3 * max(1, max |plain|):
   only the bottleneck differs, the convolutions run in cuDNN's default
   TF32 on both sides) and, for batch 1, the same servable on the CPU
   (<= 1e-2 * max(1, max |cpu|): TF32 convolutions against float32 ones).
   Then one batch-8 forward of the servable (no HTTP) is timed on the host
   clock, the host time of the fused op's calls in it is read, and it is
   traced with torch.profiler: CUDA kernel time by name, and the device's
   busy share of the forward.
5. Backward: the fused op under autograd (FusedBnReluMatmul: the kernel
   forward, then the JAX package's _bwd in plain PyTorch) at DenseNet121's
   58 bottleneck shapes at microbatch 8, each with a NaN row in x: dx, da,
   db and dw against torch autograd through the plain version, NaN at the
   same places and the rest within 1e-4 x max |plain|; its device time
   beside the plain version's backward, the two products alone and the
   bound.
6. Train: the flagship survival superstep (8 microbatches of 8 at 64^3,
   float32, blend heads, augment off), weights as in the serve phase,
   synthetic MRI-like volumes, clinical rows and events with tied
   durations. With cuDNN's TF32 off, one superstep with the kernel and one
   with the plain op patched in, from the same state with dropout 0: the
   kernel must launch exactly 58 x 8 = 464 times, and the losses, the
   predictions, every summed gradient and every running statistic must
   agree within 1e-2 x max(1, max |plain|); a third superstep with the
   plain op's product summed in another order shows how far roundoff
   alone moves them. One
   superstep with a ragged-tail mask: a finite loss and finite gradients.
   Then, with cuDNN's TF32 on (PyTorch's
   default) and dropout 0.2 as configured: a warm-up and 2 timed
   supersteps (CUDA events; volumes/s, peak memory), two validation steps
   with their C-indices and two blend updates. The first and the last
   superstep draw the same dropout masks (the generator is rewound), and
   the last one's loss on the fixed batch must be below the first's. Then
   the same superstep with the training augmentation on (augment=True, as
   the run trains): a warm-up and 2 timed supersteps (volumes/s, peak
   memory) and one profiled superstep (device busy share, kernel time by
   kind, the fused kernel's and the backward's shares, the augmentation's
   device ms and launches: its calls run inside a profiler range).
7. Train in bfloat16: the same flagship model with TPU.compute_dtype
   bfloat16 (float32 parameters, compute in bfloat16 at the JAX package's
   cast points), the augmented superstep 8 x 8 at 64^3 with dropout 0.2.
   One superstep from the same state and draws with the kernel, one with
   the plain op and one with the plain op's product summed in two halves
   of K (the control): the kernel must launch 464 times, every call with
   bfloat16 x and w, and the update (new - old over all parameters) with
   the kernel must lie within BF16_CONTROL_FACTOR x the control's relative
   L2 distance of the plain op's. Then a warm-up and 2 timed supersteps
   (volumes/s, peak memory); the graphed bf16 superstep is profiled in
   phase 10.
8. Families: every other image model the registry builds (tinycnn,
   monaidensenet, densenet169, densenet201, densenet264, seresnet50,
   r3d_18), image-only at full width (Config() defaults, 64^3 x 2ch,
   random weights from --seed) with cuDNN's TF32 off: an eval forward of
   8 (finite (8, 2); the kernel launched 58 / 58 / 82 / 98 / 130 times for
   the DenseNets, 0 for the others), one augmented survival superstep of
   1 x 8 with the kernel and one with the plain op patched in from the
   same state and draws (loss, predictions, every summed gradient and
   running statistic within 1e-2 x max(1, |plain|); launches the
   forward's; the peak memory), a timed superstep, and a bfloat16 eval
   forward (finite, every kernel call with bfloat16 x and w).
9. Remat: the flagship superstep (8 x 8, dropout 0.2, augment off, TF32
   off) with TPU.remat off and on from the same weights and generator:
   loss, predictions, summed gradients and running statistics within
   1e-2 x max(1, |off|); launches 464 and 920 (every wrapped bottleneck's
   forward runs again in the backward; the Grad-CAM target layer is not
   wrapped); both peak memories and superstep times.
10. Fused epochs (TPU.fused_epoch): the flagship superstep (8 x 8 at 64^3,
   dropout 0.2, the augmentation on, cuDNN's TF32 off and its
   deterministic algorithms on) from a resident split of 128 volumes,
   float32, bfloat16 and float32 with remat. One eager superstep alone
   (its reserved memory). Then 3 supersteps through survival_train_epoch
   (graphed: the first is the warm-up, the second is captured and
   replayed, the third a replay), each beside the same superstep run
   eagerly (CUDA events: the eager volumes/s; in float32 + aug twice),
   all set to the graphed state first: the losses, predictions,
   parameters, running statistics and momentum bit-equal to the first
   eager run, or within 1e-5 x max(1, |eager|), the generator's state and
   the step equal (in float32 + aug the second eager run, the control, is
   printed beside it); the
   kernel launched 464 times while the superstep is captured (920 with
   remat), the body bound once. Then 3 replays timed (volumes/s,
   reserved memory), the capture's seconds, and one replay profiled (busy
   share, the kernel's device time).
11. CLI: the survival run as a user starts it, at full width. A synthetic
   cohort written without pandas (the csv module and the port's
   save_nifti): CLI_PATIENTS patients, T1 and T2 NIfTI volumes of
   CLI_VOLUME voxels (squared normals x 500, a mask inside), a clinical CSV
   with the real column names and types (dates, categoricals, % necrosis),
   a patient key, and a JSON config (densenet121, t1t2, 64^3 x 2ch). Then
   mmnn_sts_torch.cli.main in this process: --images --preop --survival
   --blend --split --epochs 3 --blend_update_interval 1 --checkpoint_dir.
   The cohort build goes through the C++ pool (data/native.py, built from
   native/mmnn_native.cpp with g++): one pool call a modality, each
   decoding all CLI_PATIENTS patients, no patient handed to the numpy path;
   then build_image_cohort once with the pool and once on the plain numpy
   path (use_native=False), both timed, the two cohorts within
   COHORT_TOLERANCE x (1 + |plain|) of each other.
   Checked: rc 0, the uid files, 3 survival_epoch rows with finite losses
   and C-indices in [0, 1], blend weights that moved and sum to 1, a
   best_surv_model.npz that loads strictly into a fresh port model, and
   kernel launches = supersteps x 464 + validation forwards x 58. Then
   --resume for a 4th epoch (the step counter must carry on, and the blend
   history keeps the first run's rows), then
   python3 -m mmnn_sts_torch --export_path as a subprocess with the best
   weights, and ServingModel on the card answers a batch-3 request with a
   finite (3, 2). Prints the cohort build's seconds, each epoch's seconds
   and samples/s, the best save's host stall and the artifacts written.
12. Inference and classification, on the CLI phase's cohort and best
   weights, through mmnn_sts_torch.cli.main at full width: --inference
   --survival --blend with Grad-CAM on the 15 test patients (rc 0, a
   finite survival_model_predictions.csv row a patient, one
   _patient_{uid}/ directory a patient with four 64^3 NIfTI volumes, each
   att_map in [0, 1] with its max above 0.5, kernel launches = 58 x (eval
   steps + 2 x patients)); one patient's maps with the kernel against the
   plain op on the card (<= 1e-3, cuDNN TF32 off) and against the CPU
   (<= 1e-2); --bootstrap --no_gradcam (50 resamples, means and stds in
   [0, 1], the resamples' C-indices on the card against the CPU <= 1e-6,
   and their device time); --classification --split --epochs 2 in a run
   directory of its own (2 classification_epoch rows, F1s in [0, 1] or
   NaN, blend weights that moved and sum to 1, a model.npz that loads
   strictly, launches = (steps + validation forwards) x 58); then
   --inference --classification on that model.npz with Grad-CAM (the
   directory names' bits agree with model_probabilities.csv, launches =
   58 x (eval steps + patients)). Prints each run's seconds, the Grad-CAM
   export's seconds a patient and attention_maps' CUDA-event ms, the
   classification epochs' seconds and samples/s.
13. Fused epochs and streaming through the CLI, on the CLI phase's cohort:
   the CLI phase's eager run once more on volumes scaled by 1 + 2^-22 (the
   control: how far roundoff alone moves a 3-epoch run), then with "TPU":
   {"fused_epoch": true} 3 epochs (each superstep, tail and validation
   forward a replay after epoch 1's warm-ups and epoch 2's captures; the
   kernel launched 2 x an eager epoch's launches; the losses within
   max(1e-5, 4 x the control's distance) of the eager run's, the
   C-indices' distance printed); 2 such epochs with "compute_dtype":
   "bfloat16" and "remat": true (finite losses, 920 launches per capture
   of the superstep and the tail); --resume from the float32 run's
   checkpoint of epoch 2 (epoch 3's dropped; it ends as the uninterrupted
   run does); its export served; 2 classification epochs against the infer phase's (the
   losses, against a one-ulp control of their own); the same 2
   classification epochs with "device_resident_dataset": false (the
   resident run's losses) and --inference --survival over the host test
   split in chunks of 8 (the resident inference's predictions within
   1e-3). Prints each run's seconds an epoch beside the eager run's.
14. The CLI in bfloat16, on the CLI phase's cohort: a JSON config with
   TPU.compute_dtype bfloat16, 2 epochs (rc 0, finite losses, launches =
   supersteps x 464 + validation forwards x 58, every kernel call with
   bfloat16 x and w, the best .npz loading strictly), the export (in
   process) served on the card (the spec records bfloat16; a batch-3
   request answers a finite float32 (3, 2) in 58 bfloat16 launches), then
   --inference --survival with Grad-CAM on its test patients (att maps in
   [0, 1] with a max above 0.5, launches = 58 x (eval steps + 2 x
   patients)).
15. The slice's CLI paths, on the CLI phase's cohort: --images --survival
   --split with densenet201 for 1 epoch (rc 0, finite losses, launches =
   supersteps x 8 x 98 + validation forwards x 98, the best .npz loading
   strictly), its --export_path served on the card (98 launches, a finite
   (3, 2)); --images --preop --survival --blend with tinycnn for 1 epoch
   (0 launches) and its --inference with Grad-CAM (every att map in
   [0, 1]); --lr_finder --images --preop --survival with the flagship
   config (100 steps, 5,800 launches, lrs[0] = 1e-7 in float32, a finite
   min-loss rate, lr_finder.png only where matplotlib is installed).
16. The flagship run from a DICOM cohort (Data.image_format: dicom), at
   full width: DICOM_PATIENTS of the CLI phase's patients (its key and
   clinical table) written by this script as DICOM trees, per modality
   and patient an image/ series of CLI_VOLUME[0] single-frame .dcm slices
   (12-bit samples, with geometry) and a mask/ multiframe .dcm on the
   same grid; all
   explicit VR little endian but for four patients, one each in RLE,
   JPEG Lossless SV1, JPEG-LS and JPEG 2000 (T1 only), encoded by the
   port's encoders in worker processes. --images --preop --survival
   --blend --split --epochs 1: rc 0, finite losses, C-indices in [0, 1],
   launches = supersteps x 464 + validation forwards x 58, the best .npz
   loading strictly; the C++ decoders' frame counts equal the JPEG-LS,
   JPEG-Lossless and J2K series' slices, with no frame handed to Python;
   each compressed series as the C++ decoders read it equal to the port's
   pure-Python decode, bit for bit. Then --inference --survival --blend
   --no_gradcam on its test split (finite predictions, 58 launches an eval
   step). Prints the writer's, the cohort build's and each epoch's seconds.
17. The flagship run from s3:// paths: boto3 replaced by a stub backed by
   a local directory (FakeS3; boto3 is not installed there), the CLI
   phase's NIfTI cohort and uid lists copied into its bucket, Data.bucket
   set: 1 epoch from the uid lists (rc 0, finite losses, launches as
   above), the uploaded keys equal to train_artifact_names' under
   Preprocessing.output_dir for the artifacts written, the uploaded
   model.npz equal to the best .npz; then build_manifest_dicom_s3 over a
   copy of S3_DICOM_PATIENTS patients of phase 16's T1 tree gives
   build_manifest_dicom's records of the same patients (anon ids, uids,
   every fetched file's bytes).
18. The segmentation cohort builder, inside phase 11: build_segmentation_cohort
   on the CLI cohort's T1 tree at 64^3 (96 uids equal to the image
   cohort's, images and masks (96, 64, 64, 64, 1), masks in {0, 1}).
19. Planar (ImageModel.spatial_dims 2), at Config() widths with random
   weights from --seed and cuDNN's TF32 off: the flagship blend model
   (DenseNet121, 12 features, the 11-input clinical MLP), tinycnn,
   monaidensenet, densenet169/201/264 and seresnet50 on (8, 64, 64, 2):
   the eval forward on the card against the CPU (within 1e-2 x max(1,
   |CPU|); launches 58 / 58 / 82 / 98 / 130 per DenseNet forward, 0 for the
   others), a train superstep of one microbatch (the Cox loss's backward
   and one SGD step) with the kernel against the plain op, a bfloat16 eval
   forward and superstep (every kernel call bfloat16); DenseNet121's 2D
   forward at (8, 256, 256, 2) (block 1 at M = 32,768) against the plain
   op (1e-3); the kernel against the plain version at every (M, K, dtype)
   those runs called it with (check_call), and DenseNet121's 58 2D calls
   at (8, 64, 64) timed in both dtypes beside the plain version, the
   product alone and the bound; the flagship's 2D Grad-CAM maps on the
   card against the CPU (1e-2), in [0, 1].
20. Mesh (TPU.mesh_shape's data axis), the flagship augmented superstep 8 x
   8 at 64^3 with TF32 off and cuDNN deterministic: (a) one rank over NCCL
   in this process (a FileStore), eager and graphed (survival_train_epoch:
   warm-up, capture and replay, replay), each bit-equal to the run without
   a process group in every tensor of the state (that run, and the
   one-process runs (b) is held against, on the plain BatchNorm path, as
   a mesh's ranks take it: ops/batch_norm.plain_only); the collectives a
   superstep and the capture's launches (464); (b) two ranks sharing the
   card over gloo (this script with --mesh-rank, spawned twice; gloo
   stages CUDA tensors through the host, checked with all_gather,
   all_reduce and broadcast), one eager superstep at microbatch 8, four
   rows a rank: the ranks bit-equal to each other; against one process on
   the card, the superstep's losses and predictions (before any update)
   within 1e-5 in relative L2 and the update within 4 x its one-ulp
   control; 464 launches a rank a superstep; (c) python -m
   torch.distributed.run --nproc_per_node 2 -m mmnn_sts_torch --images
   --preop --survival --blend on the CLI phase's cohort, its split's first
   16 training patients (one masked superstep) and its validation
   patients, for 1 epoch over gloo on the card: rc 0, both ranks logged
   gloo, one metrics row (rank 0 alone writes), finite losses, C-indices
   in [0, 1], the .npz loads strictly.
   (b) and (c) run in their own processes beside (a).
21. Space (TPU.mesh_shape's space axis: each volume's depth sharded over
   ranks, halo exchanges around every convolution and pool), the same
   superstep and settings: (a) one NCCL rank, TPU.mesh_shape [1, 1] over
   [data, space], eager and graphed, bit-equal to the run without a
   process group in every tensor; (b) two ranks sharing the card over
   gloo (--space-rank, spawned twice), [1, 2] over [data, space], each
   holding 32 of the resident split's 64 planes, one eager superstep: the
   ranks bit-equal to each other; the first superstep's losses and
   predictions within 1e-5 of one process's and the update within 4 x
   its one-ulp control; 464 launches a rank; each rank's peak memory
   below 0.75 x one process's; the kernel against the plain version at
   every (M, K) the ranks called it with; the superstep's seconds, its
   all-reduces, all-gathers and halo exchanges, each rank's peak memory
   and resident bytes; (c) python -m torch.distributed.run
   --nproc_per_node 2 -m mmnn_sts_torch with TPU.mesh_shape [1, 2] over
   [data, space] on the CLI phase's cohort (16 training patients, 1
   epoch): rc 0, one metrics row, the mesh logged over [data, space];
   beside it --inference with Grad-CAM of the first 8 patients of its
   test split on the CLI phase's best weights over two ranks (this
   script's --space-cli: cli.main with TF32 off and cuDNN
   deterministic), against the same inference in one process: every
   attention map within 1e-3 and the predictions within 1e-5. (b) and
   (c) run in their own processes beside (a) and one process's
   inference.
22. Stamps (utils/tracing.py, kernels/csrc/span_stamp.cu): (a) the stamp
   kernel alone on card tensors at the flagship superstep's row width
   (stamp_width(8) = 29), rows between two guard rows of -1: slots 0, 3
   and 1 each fill their whole row, nondecreasing, and leave every other
   cell as it was; slots -1, 4 and 2^40 (outside the rows) write nothing;
   a mark past the row is refused; span_stamp.launches, set to 0 first,
   counts each launch; 1,000 stamps captured in one CUDA graph, its
   replay timed, give the device time of one. (b) The flagship superstep
   (8 x 8 at 64^3, blend, augmentation on) graphed through
   survival_train_epoch in float32 and bfloat16, two supersteps an
   epoch: 28 stamps at the warm-up and 28 at the capture, none at the
   replays; 5 replays, each queued behind a sleep, between CUDA events,
   the stamp buffer set to -1 before each:
   the replay writes row slot[0], cells 0..27, nondecreasing, and nothing
   else; the stamped span (last stamp - first) within 1 % of the events'
   time. Prints the phases of the last replay.
23. BatchNorm (ops/batch_norm.py, kernels/csrc/batch_norm.cu): (a) the
   BatchNorm calls of one DenseNet121 microbatch (8 x 64^3: norm0, the
   58 bottleneck statistics and 58 norm2, the transitions, norm5) and
   the clinical MLP's six, in float32 and bfloat16, forward and backward
   once eagerly: 2 launches a bottleneck's statistics and 4 a layer (392),
   no plain call; then captured in one CUDA graph, forward alone and
   forward with backward, each replay timed with CUDA events behind a
   sleep (median of 5), the kernels against the plain path (the same
   calls inside ops/batch_norm.plain_only) and the least bytes the
   kernels can move at 3.35 TB/s. (b) Every one of those calls, in both
   dtypes, unmasked and with the last 3 of 8 samples masked, on the
   kernels and on the plain path against the same call in float64
   (tests/bn_witness.py; each path's backward under its own ReLU mask):
   the output or the folded a, b, the gradients of x, weight and bias,
   and the running statistics each within 3 x the plain path's error +
   1e-5 x the float64 values' largest magnitude (dx under a ReLU away
   from its 0). (c) The flagship superstep graphed through
   survival_train_epoch in both dtypes: 8 x 392 launches at the warm-up
   and at the capture each, no plain call.
24. Prints the kernels' JSON line, the card's line, and last
   {"ok": true, "device": {...}}.

``--phases a,b`` runs only the named phases and the phases they need
(PHASES); without it every phase runs.

Per-shape kernel results go to chiprun_out/chip_smoke_kernels.jsonl, the
backward's to chiprun_out/chip_smoke_backward.jsonl.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import urllib.request
from pathlib import Path
from unittest import mock

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, and operations/s by type:
# float32 on the CUDA cores, bfloat16 dense on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"float32": 67e12, "bfloat16": 989e12}
TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}
BOTTLENECK_OUT = 128  # bn_size 4 x growth 32
MEASURED_ROUNDS = 5  # timed repeats after one warm-up
SLEEP_CYCLES = 10_000_000  # ~6 ms at 1.75 GHz: longer than queuing 20 calls
# the buckets whose DenseNet121 shapes the plan sweep times (of the six;
# the kernel phase checks all six): the training microbatch's, to keep the
# script's time in hand
SWEEP_BUCKETS = (8,)
# how kernel_kinds sorts kernel names into kinds (first match wins)
PROFILE_KINDS = (
    ("fused_bn_relu_matmul kernel", ("fused_bn_relu_matmul",)),
    ("host<->device copies", ("Memcpy", "Memset")),
    ("cuDNN convolutions", ("xmma", "cudnn", "conv", "implicit_gemm",
                            "wgrad", "dgrad")),
    ("GEMMs", ("gemm", "cutlass", "cublas")),
    ("copies, concat", ("copy", "Cat")),
)
# the flagship superstep: A microbatches of B volumes (SUPER_BATCH_SIZE 64)
TRAIN_MICRO, TRAIN_BATCH = 8, 8
TRAIN_TIMED = 2  # timed supersteps after one warm-up
TRAIN_LR = 1e-2  # OneCycle peak over the short run
# kernel vs plain-op superstep, x max(1, |plain|) per tensor: roundoff
# alone exceeds 1e-3 (train_phase's control, the plain op with its product
# summed in another order, moves conv0's weight gradient by 4e-3 of it)
TRAIN_TOLERANCE = 1e-2
VAL_SIZE = 16  # volumes of the synthetic validation split
# augmentation on the card vs the CPU, x max(1, |cpu|): float32 einsums
# (TF32 off) and elementwise passes in another order; the sharpening
# multiplies a difference of two blurs by up to 30
AUGMENT_TOLERANCE = 1e-4
# the bfloat16 superstep's update with the kernel vs the plain op, relative
# L2: at most this many times the control's (the plain op with its product
# summed in another order), as the CPU tests hold the port against JAX
BF16_CONTROL_FACTOR = 4.0
# the CLI phase's synthetic cohort: about 67 train patients (2 supersteps
# an epoch, the second ragged), each volume MRI-like in size
CLI_PATIENTS, CLI_VOLUME, CLI_EPOCHS = 96, (80, 72, 48), 3
CLI_MODEL, CLI_SIDE, CLI_DEVICE = "densenet121", 64, "cuda"
# the cohort through the C++ pool against the plain numpy path, per voxel:
# |pool - plain| <= this x (1 + |plain|) (the resize's float32 sums in
# another order)
COHORT_TOLERANCE = 1e-5
# the DICOM cohort: the CLI phase's patients written as DICOM series
# (slices along CLI_VOLUME's first axis, 12-bit samples in 16-bit words),
# all explicit VR little endian but for one patient a compressed syntax
# (J2K in T1 only: its pure-Python encoder is the slowest); epochs of its
# CLI run; the s3:// run's epochs and bucket names
DICOM_COMPRESSED = (("rle", ("t1", "t2")), ("jpeg_lossless", ("t1", "t2")),
                    ("jpeg_ls", ("t1", "t2")), ("j2k", ("t1",)))
DICOM_EPOCHS, S3_EPOCHS = 1, 1
# the DICOM tree holds the first DICOM_PATIENTS of the CLI phase's patients
DICOM_PATIENTS = 32
S3_BUCKET, S3_ARTIFACTS, S3_PREFIX = "cohorts", "artifacts", "models/smoke"
# patients of the T1 DICOM tree in the s3 manifest's check (each fetched
# file's bytes are compared)
S3_DICOM_PATIENTS = 16
# the wider DenseNets whose bottleneck shapes the kernel is checked at
WIDE_MODELS = ("densenet169", "densenet201", "densenet264")
# every image model name beyond the flagship's, each driven at full width:
# an eval forward, an augmented superstep of FAMILY_MICRO x TRAIN_BATCH with
# the kernel and with the plain op, a bfloat16 eval forward
FAMILIES = ("tinycnn", "monaidensenet", "densenet169", "densenet201",
            "densenet264", "seresnet50", "r3d_18")
FAMILY_MICRO = 1
# the image-only CLI run of the widest-path slice, and the LR range test's
# default number of steps
WIDE_CLI_MODEL, WIDE_CLI_EPOCHS, LR_SWEEP_STEPS = "densenet201", 1, 100
# TPU.fused_epoch: supersteps held graphed against eager, epochs of that
# many replays timed after them, the resident split's volumes; (name,
# compute dtype, remat, augment) of each run;
# graphed vs eager x max(1, |eager|) per tensor
FUSED_STEPS, FUSED_TIMED_EPOCHS = 3, 1
# eager runs of each compared superstep of the first run (the first held
# against, the second the control; the other runs take the first), each
# timed
FUSED_EAGER = 2
FUSED_SPLIT = 128
FUSED_RUNS = (("fp32 + aug", "float32", False, True),
              ("bf16 + aug", "bfloat16", False, True),
              ("fp32 remat", "float32", True, True))
FUSED_TOLERANCE = 1e-5
# the stamp kernel's own check: rows of the stamp buffer, the slots stamped
# (inside, then outside the rows); the graphed flagship supersteps' replays
# timed against CUDA events, and the stamped span's limit (relative)
STAMP_ROWS = 4
STAMP_SLOTS = (0, STAMP_ROWS - 1, 1, -1, STAMP_ROWS, 1 << 40)
STAMP_REPLAYS, STAMP_TOLERANCE = 5, 0.01
STAMP_TIMED = 1000  # stamps timed back to back in one graph
# ~29 ms at 1.75 GHz: longer than the host takes to load a step's indices
# and launch its replay, so the events time the device
STAMP_SLEEP_CYCLES = 50_000_000
# the CLI's fused and streamed runs against its eager ones: within this
# many times the distance of an eager run on inputs one ulp off (the loop
# amplifies roundoff over epochs), as the bf16 phase holds its update
FUSED_CONTROL_FACTOR = 4.0
# the streaming --inference's chunk: the 15 test patients in two chunks
FUSED_CHUNK = 8


def bound_ms(m: int, k: int, n: int, dtype: str) -> tuple[float, str]:
    """Least time the card could take: each input read once, the output
    written once, the operations at the type's peak."""
    size = 4 if dtype == "float32" else 2
    moved = (m * k + k * n + m * n) * size + 2 * k * 4
    ops = 2 * m * k * n + 3 * m * k
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def time_calls(fn, iters: int = 20) -> tuple[float, float, float]:
    """Three readings of one call of ``fn``, in ms:

    device: CUDA events around ``iters`` calls enqueued behind a sleeping
        kernel, so that the host has queued them all before the first
        starts (the host's launch cost is not in it);
    host: the host's time to check and enqueue one call, from that loop;
    paced: the same events around ``iters`` back-to-back calls with no
        sleep, so that the host paces them where it is the slower side
        (how the kernel was timed before the sleep was added)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    host = (time.perf_counter() - t0) * 1e3 / iters
    end.record()
    end.synchronize()
    device = start.elapsed_time(end) / iters
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return device, host, start.elapsed_time(end) / iters


def operands(gen, m: int, k: int, dtype):
    """x, a, b, w of one (M, K) x (K, 128) bottleneck call, drawn from
    ``gen`` on the card: x normal, a in [0.5, 1.5), b normal, w at He
    scale."""
    n = BOTTLENECK_OUT
    x = torch.randn(m, k, device="cuda", generator=gen).to(dtype)
    a = torch.rand(k, device="cuda", generator=gen) + 0.5
    b = torch.randn(k, device="cuda", generator=gen)
    w = (torch.randn(k, n, device="cuda", generator=gen)
         * (2.0 / k) ** 0.5).to(dtype)
    return x, a, b, w


def check_call(fd, x, a, b, w, tol: float, where: str):
    """The kernel against the plain version on (x, a, b, w), plus the
    properties the plain version does not show: two calls give the same
    bits, and a NaN entry of x gives a NaN output row where the plain
    version's is. Raises on a failure; returns the max abs error and the
    error relative to the largest output."""
    got = fd.fused_bn_relu_matmul(x, a, b, w)
    again = fd.fused_bn_relu_matmul(x, a, b, w)
    want = fd.fused_bn_relu_matmul_reference(x, a, b, w)
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs().max().item()
    rel = diff / max(want.float().abs().max().item(), 1e-30)
    if got.dtype != x.dtype or got.shape != want.shape or not rel <= tol:
        raise AssertionError(f"kernel disagrees at {where}: max abs "
                             f"{diff:.3e}, rel {rel:.3e}")
    if not torch.equal(got, again):
        raise AssertionError(f"two calls differ at {where}")
    row = min(3, x.shape[0] - 1)
    x_nan = x.clone()
    x_nan[row, 0] = float("nan")
    got_n = fd.fused_bn_relu_matmul(x_nan, a, b, w).float()
    want_n = fd.fused_bn_relu_matmul_reference(x_nan, a, b, w).float()
    nan_rows = want_n.isnan().any(1)
    ok = bool(nan_rows[row]) and torch.equal(got_n.isnan().any(1), nan_rows)
    if ok and not nan_rows.all():
        g, wn = got_n[~nan_rows], want_n[~nan_rows]
        ok = (g - wn).abs().max().item() <= tol * max(
            wn.abs().max().item(), 1e-30)
    if not ok:
        raise AssertionError(f"with a NaN in x row {row}, the kernel's NaN "
                             f"rows or other rows differ from the plain "
                             f"version's at {where}")
    return diff, rel


def kernel_phase(fd, seed: int, out_dir: Path):
    """Every (M, Cin) of DenseNet121's bottlenecks at every batch bucket of
    the servable, in float32 and bfloat16: checked (check_call) and timed
    (time_calls), with the launch plan and the bound. Returns the rows."""
    from mmnn_sts_torch.infer.export import BATCH_SIZES
    from mmnn_sts_torch.models.densenet import bottleneck_shapes, densenet121

    model, n = densenet121(), BOTTLENECK_OUT
    sms = fd.sm_count(torch.cuda.current_device())
    rows = []
    gen = torch.Generator(device="cuda").manual_seed(seed)
    for batch in BATCH_SIZES:
        for dtype_name, dtype in (("float32", torch.float32),
                                  ("bfloat16", torch.bfloat16)):
            for block, m, k in bottleneck_shapes(model, batch):
                x, a, b, w = operands(gen, m, k, dtype)
                diff, rel = check_call(
                    fd, x, a, b, w, TOLERANCE[dtype_name],
                    f"B={batch} M={m} Cin={k} {dtype_name}")
                h = torch.relu(x.float() * a + b).to(dtype)
                bm, bn, split_k = fd.launch_plan(m, k, n, sms, dtype)
                ms, host_ms, paced_ms = time_calls(
                    lambda: fd.fused_bn_relu_matmul(x, a, b, w))
                plain_ms, plain_host_ms, plain_paced_ms = time_calls(
                    lambda: fd.fused_bn_relu_matmul_reference(x, a, b, w))
                bound, bound_by = bound_ms(m, k, n, dtype_name)
                rows.append(dict(
                    model="densenet121", batch=batch, dtype=dtype_name,
                    block=block, m=m, cin=k, cout=n, bm=bm, bn=bn,
                    split_k=split_k,
                    ctas=fd.plan_ctas(m, n, bm, bn, split_k),
                    max_abs_err=diff, max_rel_err=rel, bit_equal=True,
                    nan_rows_match=True, ms=ms, paced_ms=paced_ms,
                    host_us=host_ms * 1e3, plain_ms=plain_ms,
                    plain_paced_ms=plain_paced_ms,
                    plain_host_us=plain_host_ms * 1e3,
                    # the product alone, not the same function: a yardstick
                    gemm_ms=time_calls(lambda: torch.matmul(h, w))[0],
                    bound_ms=bound, bound_by=bound_by,
                ))
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "chip_smoke_kernels.jsonl", "w") as f:
        for r in rows:
            f.write(json.dumps(r) + "\n")
    print("kernel fused_bn_relu_matmul vs plain, per block (float32: "
          "fused_bn_relu_matmul.cu on the CUDA cores; bfloat16: "
          "fused_bn_relu_matmul_bf16.cu on the tensor cores; sums over the "
          "block's calls: device ms, calls queued behind a sleep; paced ms, "
          "no sleep; host us to enqueue; max_rel_err limit "
          f"{TOLERANCE['float32']:.0e} float32, {TOLERANCE['bfloat16']:.0e} "
          "bfloat16; every shape also bit-equal over two calls and NaN rows "
          "as the plain version's; gemm_ms: torch.matmul(h, w) on a "
          "precomputed h, the product alone, not the same function; "
          "of_bound: bound_ms / kernel_ms):")
    groups = {}
    for r in rows:
        groups.setdefault((r["batch"], r["dtype"], r["block"]), []).append(r)
    for (batch, dtype, block), rs in groups.items():
        tot = {key: sum(r[key] for r in rs) for key in (
            "ms", "paced_ms", "host_us", "plain_ms", "plain_paced_ms",
            "plain_host_us", "gemm_ms", "bound_ms")}
        print(f"  B={batch} {dtype:8s} block{block} M={rs[0]['m']:6d} "
              f"Cin={rs[0]['cin']}..{rs[-1]['cin']} n={len(rs):2d} "
              f"max_abs_err={max(r['max_abs_err'] for r in rs):.2e} "
              f"max_rel_err={max(r['max_rel_err'] for r in rs):.2e} "
              f"kernel_ms={tot['ms']:.4f} paced {tot['paced_ms']:.4f} "
              f"host_us {tot['host_us']:.1f} "
              f"plain_ms={tot['plain_ms']:.4f} paced "
              f"{tot['plain_paced_ms']:.4f} host_us "
              f"{tot['plain_host_us']:.1f} gemm_ms={tot['gemm_ms']:.4f} "
              f"bound_ms={tot['bound_ms']:.4f} ({rs[0]['bound_by']}) "
              f"of_bound {tot['bound_ms'] / tot['ms']:.1%} "
              f"host_us/call {tot['host_us'] / len(rs):.1f}")
        print("    plan Cin:BMxBN/split(CTAs) " + " ".join(
            f"{r['cin']}:{r['bm']}x{r['bn']}/{r['split_k']}({r['ctas']})"
            for r in rs))
    for batch in BATCH_SIZES:
        for dtype in ("float32", "bfloat16"):
            rs = [r for r in rows
                  if r["batch"] == batch and r["dtype"] == dtype]
            tot = {key: sum(r[key] for r in rs) for key in (
                "ms", "paced_ms", "plain_ms", "plain_paced_ms", "gemm_ms",
                "bound_ms", "host_us")}
            print(f"  B={batch} {dtype}, {len(rs)} calls: kernel_ms "
                  f"{tot['ms']:.4f} paced {tot['paced_ms']:.4f} plain_ms "
                  f"{tot['plain_ms']:.4f} paced {tot['plain_paced_ms']:.4f} "
                  f"gemm_ms {tot['gemm_ms']:.4f} bound_ms "
                  f"{tot['bound_ms']:.4f} of_bound "
                  f"{tot['bound_ms'] / tot['ms']:.1%} host_us/call "
                  f"{tot['host_us'] / len(rs):.1f}")
    return rows


def sweep_rows(fd, gen, shapes) -> list:
    """Every launch plan each kernel takes (each tile of
    ``fd.plan_tiles(dtype)`` with every K-split ``fd.max_split`` admits) at
    each (batch, block, M, Cin) of ``shapes``, in float32 and bfloat16: each
    result held against the plain version, and its device time."""
    n, rows = BOTTLENECK_OUT, []
    sms = fd.sm_count(torch.cuda.current_device())
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        for batch, block, m, k in shapes:
            x, a, b, w = operands(gen, m, k, dtype)
            want = fd.fused_bn_relu_matmul_reference(x, a, b, w).float()
            chosen = fd.launch_plan(m, k, n, sms, dtype)
            splits = range(1, fd.max_split(k, dtype) + 1)
            for plan in ((bm, bn, split) for bm, bn in fd.plan_tiles(dtype)
                         for split in splits):
                got = fd._launch(x, a, b, w, plan).float()
                rel = ((got - want).abs().max() / want.abs().max()).item()
                if not rel <= TOLERANCE[dtype_name]:
                    raise AssertionError(
                        f"{dtype_name} plan {plan} at M={m} Cin={k}: "
                        f"rel err {rel:.2e}")
                rows.append(dict(
                    dtype=dtype_name, batch=batch, block=block, m=m,
                    cin=k, bm=plan[0], bn=plan[1], split_k=plan[2],
                    ctas=fd.plan_ctas(m, n, *plan), chosen=plan == chosen,
                    ms=time_calls(
                        lambda: fd._launch(x, a, b, w, plan))[0]))
    return rows


def print_sweep(rows, what: str):
    print(f"sweep, {what}: per dtype and block, sum of device ms over its "
          "calls with launch_plan's plans and with each shape's fastest plan "
          "(every plan checked against the plain version)")
    blocks = {}
    for r in rows:
        blocks.setdefault((r["dtype"], r["batch"], r["block"]), {}).setdefault(
            r["cin"], []).append(r)
    for (dtype, batch, block), shapes in blocks.items():
        chosen = sum(r["ms"] for rs in shapes.values() for r in rs
                     if r["chosen"])
        best = [min(rs, key=lambda r: r["ms"]) for rs in shapes.values()]
        print(f"  {dtype} B={batch} block{block}: chosen {chosen:.4f} ms, "
              f"fastest {sum(r['ms'] for r in best):.4f} ms; fastest plans "
              + " ".join(f"{r['cin']}:{r['bm']}x{r['bn']}/{r['split_k']}"
                         f"({r['ctas']})" for r in best))


def sweep_phase(fd, seed: int, out_dir: Path):
    """sweep_rows at every (M, Cin) of DenseNet121's bottlenecks at the
    batch buckets SWEEP_BUCKETS; prints, per dtype and block, the sum of
    ``launch_plan``'s plans beside the sum of each shape's fastest plan;
    every timing goes to ``out_dir``'s plan_sweep.jsonl."""
    from mmnn_sts_torch.models.densenet import bottleneck_shapes, densenet121

    model = densenet121()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = sweep_rows(fd, gen, [(batch, block, m, k)
                                for batch in SWEEP_BUCKETS
                                for block, m, k in bottleneck_shapes(model,
                                                                     batch)])
    with open(out_dir / "plan_sweep.jsonl", "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    print_sweep(rows, f"DenseNet121's shapes at batch buckets "
                f"{SWEEP_BUCKETS}")


def wide_kernel_phase(fd, seed: int, out_dir: Path) -> dict:
    """The kernel at every bottleneck shape of the wider DenseNets
    (WIDE_MODELS) at batch TRAIN_BATCH, in float32 and bfloat16: each
    checked as kernel_phase checks its shapes (check_call), densenet264's
    130 also timed beside the plain version, cuBLAS's product alone and the
    bound. The rows go to ``out_dir``'s chip_smoke_kernels.jsonl with their
    model's name. Returns densenet264's sums by dtype."""
    from mmnn_sts_torch.models import densenet

    n = BOTTLENECK_OUT
    sms = fd.sm_count(torch.cuda.current_device())
    gen = torch.Generator(device="cuda").manual_seed(seed + 7)
    rows = []
    for name in WIDE_MODELS:
        with torch.device("meta"):
            shapes = densenet.bottleneck_shapes(getattr(densenet, name)(),
                                                TRAIN_BATCH)
        timed = name == WIDE_MODELS[-1]
        for dtype_name, dtype in (("float32", torch.float32),
                                  ("bfloat16", torch.bfloat16)):
            for block, m, k in shapes:
                x, a, b, w = operands(gen, m, k, dtype)
                diff, rel = check_call(
                    fd, x, a, b, w, TOLERANCE[dtype_name],
                    f"{name} B={TRAIN_BATCH} M={m} Cin={k} {dtype_name}")
                row = dict(model=name, batch=TRAIN_BATCH, dtype=dtype_name,
                           block=block, m=m, cin=k, cout=n, max_abs_err=diff,
                           max_rel_err=rel, bit_equal=True,
                           nan_rows_match=True)
                if timed:
                    h = torch.relu(x.float() * a + b).to(dtype)
                    bound, bound_by = bound_ms(m, k, n, dtype_name)
                    row.update(
                        plan=fd.launch_plan(m, k, n, sms, dtype),
                        ms=time_calls(
                            lambda: fd.fused_bn_relu_matmul(x, a, b, w))[0],
                        plain_ms=time_calls(
                            lambda: fd.fused_bn_relu_matmul_reference(
                                x, a, b, w))[0],
                        gemm_ms=time_calls(lambda: torch.matmul(h, w))[0],
                        bound_ms=bound, bound_by=bound_by)
                rows.append(row)
    with open(out_dir / "chip_smoke_kernels.jsonl", "a") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    print(f"kernel at the wider DenseNets' bottleneck shapes, B={TRAIN_BATCH}"
          " (check_call: vs plain within the TOLERANCE, bit-equal twice, NaN "
          "rows as the plain version's):")
    for name in WIDE_MODELS:
        for dtype in ("float32", "bfloat16"):
            rs = [r for r in rows if r["model"] == name
                  and r["dtype"] == dtype]
            print(f"  {name} {dtype}: {len(rs)} calls, Cin up to "
                  f"{max(r['cin'] for r in rs)}, max_abs_err "
                  f"{max(r['max_abs_err'] for r in rs):.2e} max_rel_err "
                  f"{max(r['max_rel_err'] for r in rs):.2e}")
    timed = {}
    for dtype in ("float32", "bfloat16"):
        rs = [r for r in rows if r["model"] == WIDE_MODELS[-1]
              and r["dtype"] == dtype]
        for blk in sorted({r["block"] for r in rs}) + [None]:
            part = [r for r in rs if blk is None or r["block"] == blk]
            tot = {key: sum(r[key] for r in part) for key in (
                "ms", "plain_ms", "gemm_ms", "bound_ms")}
            where = f"block{blk} M={part[0]['m']:6d}" if blk else "all"
            print(f"  {WIDE_MODELS[-1]} {dtype} {where} n={len(part):3d}: "
                  f"kernel_ms {tot['ms']:.4f} plain_ms {tot['plain_ms']:.4f} "
                  f"gemm_ms {tot['gemm_ms']:.4f} bound_ms "
                  f"{tot['bound_ms']:.4f} of_bound "
                  f"{tot['bound_ms'] / tot['ms']:.1%}")
        timed[dtype] = dict(tot, calls=len(rs), bound_by=max(
            ("bytes", "operations"), key=lambda by: sum(
                r["bound_ms"] for r in rs if r["bound_by"] == by)))
    return timed


def random_flat_weights(model, seed: int, to_jax_flat) -> dict:
    """Weights for every parameter of ``model``, drawn with numpy, in the
    JAX package's flat key layout with the unfused bottleneck names."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, v in to_jax_flat(model.state_dict(), layout="unfused").items():
        leaf = key.rsplit("/", 1)[-1]
        if leaf == "kernel":  # conv (k,k,[k,]I,O) or dense (I,O): fan-in
            fan_in = int(np.prod(v.shape[:-1]))
            gain = 2.0 if v.ndim >= 4 else 1.0
            v = rng.normal(0.0, (gain / fan_in) ** 0.5, v.shape)
        elif leaf in ("scale", "var"):
            v = rng.uniform(0.8, 1.2, v.shape)
        elif leaf in ("bias", "mean"):
            v = rng.normal(0.0, 0.1, v.shape)
        flat[key] = np.asarray(v, np.float32)
    return flat


def post_npz(port: int, arrays: dict) -> np.ndarray:
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/invocations", data=buf.getvalue(),
        headers={"Content-Type": "application/x-npz"})
    with urllib.request.urlopen(req, timeout=300) as r:
        if r.status != 200:
            raise AssertionError(f"/invocations answered {r.status}")
        with np.load(io.BytesIO(r.read())) as data:
            return np.asarray(data["predictions"])


def serve_phase(fd, seed: int, workdir: Path):
    from mmnn_sts_torch.config import Config
    from mmnn_sts_torch.convert import load_jax_npz, to_jax_flat
    from mmnn_sts_torch.infer.export import (
        ServingModel, export_forward, model_spec)
    from mmnn_sts_torch.infer.server import ModelServer
    from mmnn_sts_torch.models import build_model

    cfg = Config()  # densenet121, 64^3 x 2ch, 12 features, 2 classes, 11 preop
    flags = dict(images=True, preop=True, postop=False, blend=True)
    model = build_model(cfg, **flags)
    load_jax_npz(model, random_flat_weights(model, seed, to_jax_flat))
    artifact = str(workdir / "model.pt")
    spec = model_spec(cfg, **flags)
    export_forward(model, spec, artifact)

    rng = np.random.default_rng(seed + 1)
    image = tuple(cfg.image_model.spatial_size) + (cfg.image_model.in_channels,)
    requests = {
        b: {"image": (rng.normal(size=(b,) + image) ** 2 * 500
                      ).astype(np.float32),
            "clinical": rng.normal(size=(b, spec["num_tabular_inputs"])
                                   ).astype(np.float32)}
        for b in (1, 3, 8)
    }
    srv = ModelServer(artifact, host="127.0.0.1", port=0, device="cuda")
    srv.start_background()
    answers, latencies = {}, {b: [] for b in requests}
    try:
        fd.fused_bn_relu_matmul.launches = 0
        for _ in range(1 + MEASURED_ROUNDS):  # the first round warms up
            for b, arrays in requests.items():
                before = fd.fused_bn_relu_matmul.launches
                t0 = time.perf_counter()
                preds = post_npz(srv.port, arrays)
                latencies[b].append((time.perf_counter() - t0) * 1e3)
                launched = fd.fused_bn_relu_matmul.launches - before
                if launched != 58:
                    raise AssertionError(
                        f"a served B={b} forward launched the kernel "
                        f"{launched} times, not 58")
                if preds.shape != (b, 2) or not np.all(np.isfinite(preds)):
                    raise AssertionError(
                        f"bad answer for B={b}: shape {preds.shape}, "
                        f"finite={np.isfinite(preds).all()}")
                answers[b] = preds
        launches = fd.fused_bn_relu_matmul.launches
    finally:
        srv.shutdown()
    for b, ms in latencies.items():
        print(f"serve request B={b} (bucket {srv.model._bucket(b)}): first "
              f"{ms[0]:.1f} ms, then median {np.median(ms[1:]):.1f} ms, max "
              f"{max(ms[1:]):.1f} ms of {MEASURED_ROUNDS} (host clock, npz "
              "over HTTP on localhost)")

    # the same servable with the plain op in place of the kernel
    with mock.patch.object(fd, "fused_bn_relu_matmul",
                           fd.fused_bn_relu_matmul_reference):
        plain = ServingModel(artifact, device="cuda")
        for b, arrays in requests.items():
            want = plain(arrays)
            diff = float(np.abs(answers[b] - want).max())
            limit = 1e-3 * max(1.0, float(np.abs(want).max()))
            print(f"serve B={b}: kernel vs plain op max|diff| {diff:.3e} "
                  f"(limit {limit:.1e})")
            if not diff <= limit:
                raise AssertionError(f"served B={b} disagrees with the plain op")
    want = ServingModel(artifact, device="cpu")(requests[1])
    diff = float(np.abs(answers[1] - want).max())
    limit = 1e-2 * max(1.0, float(np.abs(want).max()))
    print(f"serve B=1: card vs CPU max|diff| {diff:.3e} (limit {limit:.1e}); "
          f"answer {answers[1].tolist()}")
    if not diff <= limit:
        raise AssertionError("served B=1 disagrees with the CPU forward")
    time_payload(requests[8])
    profile_forward(ServingModel(artifact, device="cuda"), requests[8])
    return launches


def time_payload(arrays):
    """Host time of the request body's npz encoding (the client's side) and
    of the server's decoding of it, outside HTTP."""
    from mmnn_sts_torch.infer.server import NPZ, _decode_request

    enc, dec = [], []
    for _ in range(MEASURED_ROUNDS):
        t0 = time.perf_counter()
        buf = io.BytesIO()
        np.savez(buf, **arrays)
        body = buf.getvalue()
        t1 = time.perf_counter()
        _decode_request(body, NPZ)
        enc.append((t1 - t0) * 1e3)
        dec.append((time.perf_counter() - t1) * 1e3)
    print(f"payload B={len(arrays['image'])}: {len(body) / 1e6:.1f} MB npz, "
          f"encode median {np.median(enc):.2f} ms, decode median "
          f"{np.median(dec):.2f} ms of {MEASURED_ROUNDS} (host clock)")


def profile_forward(model, arrays, top: int = 12):
    """Where one served forward's time goes (a ServingModel call, without
    HTTP): its wall time without the profiler, and torch.profiler's CUDA
    kernel times by name. One stream, so the kernels do not overlap and
    their sum over the wall time is the device's busy share."""
    from torch.profiler import ProfilerActivity, profile

    walls = []
    for _ in range(1 + MEASURED_ROUNDS):
        t0 = time.perf_counter()
        model(arrays)  # ends in a device -> host copy of the answer
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = float(np.median(walls[1:]))
    print_host_calls(model, arrays, wall)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        model(arrays)
    kernel_kinds(prof, wall, f"served forward B="
                 f"{len(next(iter(arrays.values())))}, wall median of "
                 f"{MEASURED_ROUNDS} (no profiler)", top)


def kernel_kinds(prof, wall: float, what: str, top: int = 12) -> dict:
    """Print a torch.profiler trace's CUDA kernel time against ``wall`` ms
    (one stream, so kernels do not overlap and their sum over the wall is
    the device's busy share), by kind (PROFILE_KINDS) and for the ``top``
    kernels. Returns kind -> ms, with the total under "busy". Ranges that
    the trace also keeps on the device's timeline (user annotations, such
    as the optimizer's step) are not kernels and are left out."""
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    busy = sum(e.device_time_total for e in kernels) / 1e3
    print(f"profile {what}: wall {wall:.2f} ms; CUDA kernels {busy:.2f} ms "
          f"in {sum(e.count for e in kernels)} launches = device busy "
          f"{busy / wall:.1%}")
    kinds = {}
    for e in kernels:
        kind = next((k for k, marks in PROFILE_KINDS if any(
            m in e.key for m in marks)), "other PyTorch kernels")
        ms, n = kinds.get(kind, (0.0, 0))
        kinds[kind] = (ms + e.device_time_total / 1e3, n + e.count)
    for kind, (ms, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0]):
        print(f"  {ms:9.3f} ms {n:6d}x [{kind}]")
    for e in sorted(kernels, key=lambda e: -e.device_time_total)[:top]:
        print(f"  {e.device_time_total / 1e3:9.3f} ms {e.count:6d}x "
              f"{e.key[:110]}")
    return {"busy": busy, **{k: ms for k, (ms, _) in kinds.items()}}


def print_host_calls(model, arrays, wall: float):
    """Host time of the fused op's calls in one served forward (a
    ServingModel call): each call of the wrapper
    ``fused_dense.fused_bn_relu_matmul`` (checks, plan, ctypes launch) and
    of the op ``densenet.bn_relu_conv1x1`` (the BN fold, then the wrapper)
    timed on the host clock. Nothing waits for the device there, so this
    is the time to check and enqueue, against the forward's ``wall`` ms."""
    from mmnn_sts_torch.models import densenet
    from mmnn_sts_torch.ops import fused_dense

    spent = {}

    def timed(module, name):
        orig = getattr(module, name)
        spent[name] = []

        @functools.wraps(orig)  # carries a wrapper's launch count along
        def call(*args, **kw):
            t0 = time.perf_counter()
            try:
                return orig(*args, **kw)
            finally:
                spent[name].append(time.perf_counter() - t0)

        return mock.patch.object(module, name, call)

    with timed(fused_dense, "fused_bn_relu_matmul"), \
            timed(densenet, "bn_relu_conv1x1"):
        model(arrays)
    for name, ts in spent.items():
        print(f"host time in the served forward: {name} {len(ts)} calls, "
              f"mean {np.mean(ts) * 1e6:.1f} us, sum {sum(ts) * 1e3:.3f} ms "
              f"({sum(ts) * 1e3 / wall:.1%} of the {wall:.2f} ms wall)")


def backward_bound_ms(m: int, k: int, n: int) -> tuple[float, str]:
    """Least time of the float32 backward: x, g, w, a, b read once, dx, da,
    db, dw written once; the two products (4 M K N) and about 8 M K
    elementwise operations at the float32 peak."""
    moved = (2 * m * k + m * n + 2 * k * n + 4 * k) * 4
    ops = 4 * m * k * n + 8 * m * k
    t_bytes, t_ops = moved / HBM_BYTES_PER_S, ops / PEAK_OPS_PER_S["float32"]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def nan_aware_rel_err(got, want, where: str) -> float:
    """The largest |got - want| over the finite entries, relative to the
    largest finite |want|; raises unless NaN sits at the same places."""
    if not torch.equal(got.isnan(), want.isnan()):
        raise AssertionError(f"NaN entries differ at {where}")
    fin = ~want.isnan()
    if not fin.any():
        return 0.0
    scale = max(want[fin].abs().max().item(), 1e-30)
    return (got[fin] - want[fin]).abs().max().item() / scale


def backward_phase(fd, seed: int, out_dir: Path):
    """The fused op under autograd at DenseNet121's 58 bottleneck shapes at
    microbatch 8 in float32, a NaN in one row of x: the Function's dx, da,
    db and dw (kernel forward, then fused_bn_relu_matmul_backward) against
    torch autograd through the plain version (TOLERANCE, relative to the
    largest finite entry). Times the backward, the plain version's
    backward and the two products alone (device ms, time_calls). Returns
    the rows."""
    from mmnn_sts_torch.models.densenet import bottleneck_shapes, densenet121

    n, tol = BOTTLENECK_OUT, TOLERANCE["float32"]
    gen = torch.Generator(device="cuda").manual_seed(seed + 2)
    rows = []
    for block, m, k in bottleneck_shapes(densenet121(), TRAIN_BATCH):
        x, a, b, w = operands(gen, m, k, torch.float32)
        x[min(3, m - 1), 0] = float("nan")
        g = torch.randn(m, n, device="cuda", generator=gen)
        leaves = [t.clone().requires_grad_() for t in (x, a, b, w)]
        fd.FusedBnReluMatmul.apply(*leaves).backward(g)
        plain = [t.clone().requires_grad_() for t in (x, a, b, w)]
        out = fd.fused_bn_relu_matmul_reference(*plain)
        out.backward(g, retain_graph=True)
        torch.cuda.synchronize()
        errs = {name: nan_aware_rel_err(t.grad, p.grad, f"{name} M={m} "
                                        f"Cin={k}")
                for name, t, p in zip(("dx", "da", "db", "dw"), leaves, plain)}
        if not max(errs.values()) <= tol:
            raise AssertionError(f"backward disagrees at M={m} Cin={k}: "
                                 f"{errs}")
        bound, bound_by = backward_bound_ms(m, k, n)
        rows.append(dict(
            block=block, m=m, cin=k, max_rel_err=max(errs.values()),
            ms=time_calls(lambda: fd.fused_bn_relu_matmul_backward(
                x, a, b, w, g))[0],
            plain_ms=time_calls(lambda: torch.autograd.grad(
                out, plain, g, retain_graph=True))[0],
            mm_ms=time_calls(lambda: (torch.matmul(g, w.T),
                                      torch.matmul(x.T, g)))[0],
            bound_ms=bound, bound_by=bound_by))
    with open(out_dir / "chip_smoke_backward.jsonl", "w") as f:
        f.writelines(json.dumps(r) + "\n" for r in rows)
    print(f"backward of the fused op (kernel forward + _bwd) vs autograd of "
          f"the plain version, B={TRAIN_BATCH} float32, a NaN row per shape, "
          f"max_rel_err limit {tol:.0e}; device ms summed per block (mm_ms: "
          "the two products alone):")
    for blk in sorted({r["block"] for r in rows}):
        rs = [r for r in rows if r["block"] == blk]
        print(f"  block{blk} M={rs[0]['m']:6d} n={len(rs):2d} max_rel_err="
              f"{max(r['max_rel_err'] for r in rs):.2e} " + " ".join(
                  f"{key}={sum(r[key] for r in rs):.4f}"
                  for key in ("ms", "plain_ms", "mm_ms", "bound_ms")))
    print(f"  {len(rows)} calls: " + " ".join(
        f"{key}={sum(r[key] for r in rows):.4f}"
        for key in ("ms", "plain_ms", "mm_ms", "bound_ms")))
    return rows


def synthetic_split(rng, lead: tuple, spec: dict, device):
    """MRI-like volumes (squared normals x 500), clinical rows, events and
    integer durations in 1..24 (many ties), with leading shape ``lead``."""
    image = tuple(spec["image_model"]["spatial_size"]) \
        + (spec["image_model"]["in_channels"],)
    inputs = {
        "image": torch.from_numpy((rng.normal(size=lead + image) ** 2 * 500
                                   ).astype(np.float32)).to(device),
        "clinical": torch.from_numpy(rng.normal(
            size=lead + (spec["num_tabular_inputs"],)).astype(np.float32)
        ).to(device)}
    events = torch.from_numpy(
        (rng.random(lead + (2,)) < 0.7).astype(np.float32)).to(device)
    durations = torch.from_numpy(
        rng.integers(1, 25, lead + (2,)).astype(np.float32)).to(device)
    return inputs, events, durations


def reassociated_reference(x, a, b, w):
    """The plain version with its product summed as two halves of K, in
    float32, rounded once to x's dtype: the same function, its sums in
    another order (a control for how far roundoff alone moves a
    superstep)."""
    from mmnn_sts_torch.ops.fused_dense import fused_bn_relu_matmul_reference

    k = x.shape[1] // 2
    return (fused_bn_relu_matmul_reference(x[:, :k].float(), a[:k], b[:k],
                                           w[:k])
            + fused_bn_relu_matmul_reference(x[:, k:].float(), a[k:], b[k:],
                                             w[k:])).to(x.dtype)


def train_phase(fd, seed: int):
    """The flagship survival superstep on the card (see the module
    docstring, phase 6). Returns the kernel's launches in one superstep."""
    from mmnn_sts_torch.config import Config
    from mmnn_sts_torch.convert import load_jax_npz, to_jax_flat
    from mmnn_sts_torch.infer.export import model_spec
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.models.common import Dropout
    from mmnn_sts_torch.ops.blending import blend_update, surv_head_losses
    from mmnn_sts_torch.ops.metrics import c_indices_per_class
    from mmnn_sts_torch.train.schedule import make_optimizer
    from mmnn_sts_torch.ops import augment
    from mmnn_sts_torch.train import steps
    from mmnn_sts_torch.train.state import create_train_state
    from mmnn_sts_torch.train.steps import (
        survival_eval_step, survival_train_superstep)
    from torch.profiler import ProfilerActivity, profile

    cfg = Config()  # densenet121, 64^3 x 2ch, dropout 0.2, 11 preop
    flags = dict(images=True, preop=True, postop=False, blend=True)
    spec = model_spec(cfg, **flags)
    weights = random_flat_weights(build_model(cfg, **flags), seed,
                                  to_jax_flat)

    def new_state(dropout: bool, total_steps: int):
        model = build_model(cfg, **flags)
        load_jax_npz(model, weights)
        if not dropout:
            for mod in model.modules():
                if isinstance(mod, Dropout):
                    mod.p = 0.0
        model.cuda()
        return create_train_state(model, *make_optimizer(
            model.parameters(), TRAIN_LR, total_steps, 1), seed=seed)

    def superstep(state, mask=None):
        return survival_train_superstep(
            state, inputs, events, durations, blend=True, augment=False,
            mask=mask)

    rng = np.random.default_rng(seed + 3)
    inputs, events, durations = synthetic_split(
        rng, (TRAIN_MICRO, TRAIN_BATCH), spec, "cuda")
    vals = synthetic_split(rng, (VAL_SIZE,), spec, "cuda")
    volumes = TRAIN_MICRO * TRAIN_BATCH

    # the kernel against the plain op, one superstep each from one state
    torch.backends.cudnn.allow_tf32 = False
    print(f"train: {TRAIN_MICRO} x {TRAIN_BATCH} volumes of "
          f"{tuple(inputs['image'].shape[2:])} float32 per superstep; "
          f"kernel vs plain op with cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32} matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}, dropout 0")

    def run_with(op):
        """A superstep from the initial state with ``op`` in place of the
        kernel's wrapper: its superstep_tensors."""
        state = new_state(False, 4)
        with mock.patch.object(fd, "fused_bn_relu_matmul", op):
            return superstep_tensors(superstep(state), state.model)

    kernel_state = new_state(False, 4)
    fd.fused_bn_relu_matmul.launches = 0
    got = superstep(kernel_state)
    torch.cuda.synchronize()
    launched = fd.fused_bn_relu_matmul.launches
    if launched != 58 * TRAIN_MICRO:
        raise AssertionError(f"a superstep launched the kernel {launched} "
                             f"times, not {58 * TRAIN_MICRO}")
    want = run_with(fd.fused_bn_relu_matmul_reference)
    kernel_dev = deviations(superstep_tensors(got, kernel_state.model), want)
    bad = [(r, n) for r, n in kernel_dev if not r <= 1.0]
    if bad:
        raise AssertionError(f"superstep, kernel vs plain op beyond "
                             f"{TRAIN_TOLERANCE:.0e} x max(1, |plain|): {bad}")
    # the control: the plain op with its product summed in another order
    control_dev = deviations(run_with(reassociated_reference), want)
    print(f"train superstep: {launched} kernel launches; loss kernel "
          f"{got['loss'].item():.6f} plain {want['loss'].item():.6f}; preds "
          f"{tuple(got['preds'].shape)}; loss, preds and "
          f"{len(kernel_dev) - 2} summed gradients and running statistics "
          f"within {TRAIN_TOLERANCE:.0e}"
          f" x max(1, |plain|): largest {max(kernel_dev)[0]:.1%} of it "
          f"({max(kernel_dev)[1]}); the plain op with its product summed in "
          f"two halves of K, against the plain op: largest "
          f"{max(control_dev)[0]:.1%} ({max(control_dev)[1]})")
    del want

    mask = torch.ones(TRAIN_MICRO, TRAIN_BATCH, device="cuda")
    mask[-1, TRAIN_BATCH // 2:] = 0  # a ragged tail: 60 of 64 valid
    masked = superstep(kernel_state, mask)
    grads = [p.grad for p in kernel_state.model.parameters()]
    if not (torch.isfinite(masked["loss"]) and all(
            torch.isfinite(g).all() for g in grads)):
        raise AssertionError("the masked superstep's loss or gradients are "
                             "not finite")
    print(f"train masked superstep ({int(mask.sum())} of {volumes} valid): "
          f"loss {masked['loss'].item():.6f}, all gradients finite")
    del kernel_state, got, masked, grads

    # a short run as configured: TF32 convolutions, dropout 0.2
    torch.backends.cudnn.allow_tf32 = True
    state = new_state(True, 2 + TRAIN_TIMED)
    print(f"train run: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}, "
          f"dropout {cfg.image_model.dropout_prob}, OneCycle peak "
          f"{TRAIN_LR} over {2 + TRAIN_TIMED} steps")
    val_before = survival_eval_step(state, *vals, blend=True)
    rewind = state.generator.get_state()
    out = {}

    def step_and_keep():
        out["last"] = superstep(state)
        out.setdefault("first", out["last"])
        return out["last"]

    # the last timed superstep draws the warm-up's dropout masks
    timed_supersteps(step_and_keep, volumes, "train superstep",
                     before_last=lambda: state.generator.set_state(rewind))
    first, last = out["first"], out["last"]
    loss0, loss1 = first["loss"].item(), last["loss"].item()
    print(f"train loss on the fixed batch, same dropout masks: first "
          f"superstep {loss0:.6f}, last {loss1:.6f}")
    if not loss1 < loss0:
        raise AssertionError("the loss on the fixed batch did not fall")

    val_after = survival_eval_step(state, *vals, blend=True)
    c_index = c_indices_per_class(val_after["preds"][0].cpu().numpy(),
                                  vals[1].cpu().numpy(), vals[2].cpu().numpy())

    def train_head_losses(aux):
        return sum(surv_head_losses(aux["preds"][i], events[i], durations[i])
                   for i in range(TRAIN_MICRO))

    blend = blend_update(state.blend, train_head_losses(first),
                         surv_head_losses(val_before["preds"], *vals[1:]),
                         survival=True)
    blend = blend_update(blend, train_head_losses(last),
                         surv_head_losses(val_after["preds"], *vals[1:]),
                         survival=True)
    total = blend.weights.sum().item()
    if not (abs(total - 1.0) <= 1e-5 and torch.isfinite(blend.weights).all()
            and all(0.0 <= c <= 1.0 for c in c_index)):
        raise AssertionError(f"blend weights {blend.weights.tolist()} or "
                             f"C-indices {c_index} out of range")
    state.blend = blend
    print(f"train validation ({VAL_SIZE} volumes): loss "
          f"{val_after['loss'].item():.6f}, selection loss "
          f"{val_after['selection_loss'].item():.6f}, C-indices {c_index}; "
          f"blend weights after two updates {blend.weights.tolist()} "
          f"(sum {total:.6f})")

    # the superstep as the run trains it: the random augmentation on
    def augmented():
        aux = survival_train_superstep(state, inputs, events, durations,
                                       blend=True, augment=True)
        if not torch.isfinite(aux["loss"]):
            raise AssertionError("an augmented superstep's loss is not finite")
        return aux

    # the deterministic transform on the card against the same on the CPU,
    # from one microbatch's draws
    params = augment.draw_augment_params(
        TRAIN_BATCH, state.generator, "cuda", tuple(inputs["image"].shape[2:]))
    on_card = augment.apply_train_augment(inputs["image"][0], params)
    on_cpu = augment.apply_train_augment(
        inputs["image"][0].cpu(), {k: v.cpu() for k, v in params.items()})
    diff = (on_card.cpu() - on_cpu).abs().max().item()
    print(f"train augmentation, microbatch of {TRAIN_BATCH}: card vs CPU "
          f"max|diff| {diff:.3e} (limit {AUGMENT_TOLERANCE:.0e} x max(1, "
          f"|cpu|) = {AUGMENT_TOLERANCE * max(1.0, on_cpu.abs().max().item()):.1e})")
    if not diff <= AUGMENT_TOLERANCE * max(1.0, on_cpu.abs().max().item()):
        raise AssertionError("the augmentation on the card disagrees with "
                             "the CPU")
    aug_ms = timed_supersteps(augmented, volumes,
                              "train superstep with augmentation")
    ranged = profiler_range(steps.train_augment_batch, "train_augment")
    with mock.patch.object(steps, "train_augment_batch", ranged), \
            profile(activities=[ProfilerActivity.CPU,
                                ProfilerActivity.CUDA]) as prof:
        augmented()
        torch.cuda.synchronize()
    kinds = kernel_kinds(prof, float(np.median(aug_ms)),
                         "augmented train superstep, wall the timed median",
                         top=15)
    aug_dev, aug_launches, aug_calls = range_totals(prof, "train_augment")
    if aug_calls != TRAIN_MICRO:
        raise AssertionError(f"the trace holds {aug_calls} augmentation "
                             f"calls, not {TRAIN_MICRO}")
    bwd, bwd_mm, bwd_calls = 0.0, 0.0, 0
    for e in prof.events():  # the Function's backward nodes and their mms
        if e.name == "FusedBnReluMatmulBackward":
            bwd_calls += 1
            bwd += e.device_time_total / 1e3
            stack = list(e.cpu_children)
            while stack:
                c = stack.pop()
                if c.name == "aten::mm":
                    bwd_mm += c.device_time_total / 1e3
                else:
                    stack.extend(c.cpu_children)
    if bwd_calls != launched:
        raise AssertionError(f"the trace holds {bwd_calls} backward calls of "
                             f"the fused op, not {launched}")
    busy = kinds["busy"]
    fused = kinds.get("fused_bn_relu_matmul kernel", 0.0)
    print(f"train superstep device time: fused kernel {fused:.3f} ms "
          f"({fused / busy:.1%}); the fused op's backward {bwd:.3f} ms "
          f"({bwd / busy:.1%}): its two products {bwd_mm:.3f} ms, its "
          f"elementwise and column-sum pass {bwd - bwd_mm:.3f} ms "
          f"({(bwd - bwd_mm) / busy:.1%})")
    print(f"train augmentation in one superstep: {aug_calls} calls (one a "
          f"microbatch of {TRAIN_BATCH}), {aug_launches} kernel launches, "
          f"{aug_dev:.3f} ms device time ({aug_dev / kinds['busy']:.1%} of "
          f"the superstep's kernels)")
    return launched


def timed_supersteps(step, volumes: int, what: str, before_last=None):
    """A warm-up call of ``step`` and TRAIN_TIMED timed ones (CUDA events
    around each); prints volumes/s (median, min, max), the host wall and
    the peak memory, and returns the timed ms. ``before_last`` runs just
    before the last timed call."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step()  # warm-up
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_TIMED)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(TRAIN_TIMED)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TRAIN_TIMED):
        if i == TRAIN_TIMED - 1 and before_last is not None:
            before_last()
        starts[i].record()
        step()
        ends[i].record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / TRAIN_TIMED
    ms = np.array([s.elapsed_time(e) for s, e in zip(starts, ends)])
    rate = volumes * 1e3 / ms
    peak = torch.cuda.max_memory_allocated()
    print(f"{what} timing ({TRAIN_TIMED} after a warm-up, CUDA "
          f"events): median {np.median(ms):.1f} ms (min {ms.min():.1f}, max "
          f"{ms.max():.1f}; host wall {wall:.1f} ms a superstep) = "
          f"{np.median(rate):.1f} volumes/s (min {rate.min():.1f}, max "
          f"{rate.max():.1f}); max_memory_allocated {peak / 2**30:.2f} GiB")
    return ms


def profiler_range(fn, name: str):
    """``fn`` with each call inside a torch.profiler range ``name``."""
    @functools.wraps(fn)
    def call(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)

    return call


def range_totals(prof, name: str) -> tuple[float, int, int]:
    """(device ms, kernel launches, calls) of the profiler ranges ``name``
    in a trace, their child ops' kernels included."""
    ms, launches, calls = 0.0, 0, 0
    for e in prof.events():
        if e.name != name or e.device_type != torch.autograd.DeviceType.CPU:
            continue
        calls += 1
        ms += e.device_time_total / 1e3
        stack = [e]
        while stack:
            c = stack.pop()
            launches += len(c.kernels)
            stack.extend(c.cpu_children)
    return ms, launches, calls


# the clinical CSV's columns, as the cohort's export names them
CLINICAL_COLUMNS = (
    "MRN", "Sex", "Age", "Location3", "Diagnosis", "Chemo (Neoadjuvant)",
    "TumorSize", "TumorVolume (cm^3)",
    "TumorDepth (1 = deep to fascia, 0 = superficial) ", "TumorGrade",
    "Metsatpresentation", "RT Type (0 = preop, 1 = postop",
    "Margin (negative==0, microscopically positive==1, grossly positive==2)",
    "Necrosis % (information not known prior to operation)", "LengthOR",
    "VitalStatus", "Distant metastasis", "FUtime", "Date of Distant Mets",
    "Surgery_Date")


def write_cohort(root: Path, n: int, seed: int) -> dict:
    """A synthetic cohort on disk without pandas: clinical.csv (survival
    times drawn from a hazard of grade, volume and age; ISO dates, string
    categoricals, '%' necrosis with gaps), key.csv ('Anon MRN' -> MRN) and
    t1/ t2/ trees of one folder per patient with scan_*.nii.gz and
    mask_*.nii.gz (CLI_VOLUME voxels, squared normals x 500, the mask a box
    inside)."""
    import csv
    import datetime

    from mmnn_sts_torch.data.nifti import save_nifti

    rng = np.random.default_rng(seed)
    root.mkdir(parents=True, exist_ok=True)
    uids = 1000 + np.arange(n)
    grade = rng.integers(1, 4, n)
    volume = rng.uniform(10, 2000, n).round(1)
    age = rng.integers(20, 90, n)
    risk = (0.8 * (grade - 2) + 1.2 * (np.log(volume) - np.log(300))
            + 0.02 * (age - 55))
    t_event = rng.exponential(scale=900 * np.exp(-risk))
    futime = np.minimum(t_event, rng.uniform(500, 3000, n)).astype(int) + 1
    vital = (t_event <= futime).astype(int)
    dm = rng.random(n) < 1 / (1 + np.exp(-risk))
    met_days = np.maximum((t_event * rng.uniform(0.3, 0.9, n)).astype(int), 10)
    surgery = datetime.date(2015, 1, 1)
    columns = [
        uids, rng.choice(["M", "F"], n), age,
        rng.choice(["Thigh", "Pelvis", "Arm"], n),
        rng.choice(["MFH", "Liposarcoma", "Synovial"], n),
        rng.choice(["Yes", "No"], n), rng.uniform(1, 25, n).round(1), volume,
        rng.integers(0, 2, n), grade, rng.integers(0, 2, n),
        rng.integers(0, 2, n), rng.integers(0, 3, n),
        [f"{v}%" if keep else "" for v, keep in
         zip(rng.integers(0, 100, n), rng.random(n) < 0.8)],
        rng.integers(60, 400, n), vital, dm.astype(int), futime,
        [(surgery + datetime.timedelta(days=int(d))).isoformat() if e else ""
         for d, e in zip(met_days, dm)],
        [surgery.isoformat()] * n]
    paths = {"clinical": root / "clinical.csv", "key": root / "key.csv",
             "root": root}
    with open(paths["clinical"], "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(CLINICAL_COLUMNS)
        out.writerows(zip(*columns))
    anon = [f"STS-{i:03d}" for i in range(n)]
    with open(paths["key"], "w", newline="") as f:
        out = csv.writer(f)
        out.writerow(["Anon MRN", "MRN"])
        out.writerows(zip(anon, uids))
    mask = np.zeros(CLI_VOLUME, np.float32)
    mask[8:-8, 8:-8, 6:-6] = 1.0
    for modality in ("t1", "t2"):
        for a in anon:
            pdir = root / modality / a
            pdir.mkdir(parents=True)
            image = (rng.normal(size=CLI_VOLUME) ** 2 * 500).astype(np.float32)
            save_nifti(str(pdir / f"scan_{a}.nii.gz"), image)
            save_nifti(str(pdir / f"mask_{a}.nii.gz"), mask)
    return paths


def counted(fn, counts: dict, name: str):
    """``fn``, adding one to ``counts[name]`` and the host seconds of each
    call to ``counts[name + '_s']``."""
    @functools.wraps(fn)
    def call(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            counts[name] = counts.get(name, 0) + 1
            counts.setdefault(name + "_s", []).append(
                time.perf_counter() - t0)

    return call


def cli_phase(fd, seed: int, workdir: Path) -> dict:
    """The survival run through the port's CLI at full width (see the
    module docstring, phase 11). Returns its kernel launches and counts."""
    from mmnn_sts_torch import cli, pipeline
    from mmnn_sts_torch.config import parse_config
    from mmnn_sts_torch.data import images, native
    from mmnn_sts_torch.infer.export import ServingModel
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.train import checkpoint, evaluate, loop
    from mmnn_sts_torch.train.checkpoint import CheckpointManager

    t0 = time.perf_counter()
    paths = write_cohort(workdir / "cohort", CLI_PATIENTS, seed + 4)
    print(f"cli cohort written (csv + save_nifti, {CLI_PATIENTS} patients, "
          f"T1/T2 {CLI_VOLUME}): {time.perf_counter() - t0:.1f} s")
    config = {"Data": {"data_loc": str(paths["clinical"]),
                       "image_loc": str(paths["root"]),
                       "key_loc": str(paths["key"])},
              "ImageModel": {"name": CLI_MODEL, "modality": "t1t2",
                             "in_channels": 2,
                             "spatial_size": [CLI_SIDE] * 3},
              "Hyperparameters": {"train_batch_size": TRAIN_BATCH,
                                  "seed": seed}}
    config_path = workdir / "config.json"
    config_path.write_text(json.dumps(config))
    run_dir, out, ck = workdir / "run", workdir / "run" / "out", \
        workdir / "run" / "ck"
    run_dir.mkdir()
    args = ["--images", "--preop", "--survival", "--blend", "--split",
            "--config", str(config_path), "--blend_update_interval", "1",
            "--output_path", str(out), "--checkpoint_dir", str(ck),
            "--device", CLI_DEVICE]

    counts, pool_calls = {}, []
    patches = [
        mock.patch.object(pipeline, "load_cohort",
                          counted(pipeline.load_cohort, counts, "cohort")),
        mock.patch.object(native, "preprocess_cohort_native",
                          recorded(native.preprocess_cohort_native,
                                   pool_calls)),
        mock.patch.object(loop, "survival_train_superstep",
                          counted(loop.survival_train_superstep, counts,
                                  "supersteps")),
        mock.patch.object(evaluate, "survival_eval_step",
                          counted(evaluate.survival_eval_step, counts,
                                  "val_forwards")),
        mock.patch.object(checkpoint.AsyncNpzSaver, "submit",
                          counted(checkpoint.AsyncNpzSaver.submit, counts,
                                  "best_saves")),
        mock.patch.object(checkpoint.CheckpointManager, "save",
                          counted(checkpoint.CheckpointManager.save, counts,
                                  "checkpoints")),
    ]

    def run(extra):
        cwd = Path.cwd()
        os.chdir(run_dir)  # --split writes the uid files here
        try:
            for p in patches:
                p.start()
            return cli.main(args + extra)
        finally:
            for p in patches:
                p.stop()
            os.chdir(cwd)

    native.reset_counts()
    fd.fused_bn_relu_matmul.launches = 0
    t0 = time.perf_counter()
    rc = run(["--epochs", str(CLI_EPOCHS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = fd.fused_bn_relu_matmul.launches
    if rc != 0:
        raise AssertionError(f"the CLI returned {rc}")
    # the cohort build went through the C++ pool: one call a modality, every
    # patient decoded there, none handed to the numpy path
    pooled = [int(np.count_nonzero(out[1] == 0)) for _, _, out in pool_calls]
    if pooled != [CLI_PATIENTS, CLI_PATIENTS] \
            or native.counts["patient_fallbacks"] != 0:
        raise AssertionError(f"the cohort pool decoded {pooled} patients of "
                             f"{CLI_PATIENTS} a modality; counts "
                             f"{native.counts}")
    dirs = [str(paths["root"] / m) for m in ("t1", "t2")]
    t0 = time.perf_counter()
    plain = images.build_image_cohort(dirs, str(paths["key"]),
                                      (CLI_SIDE,) * 3, "fill",
                                      use_native=False)
    plain_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pool = images.build_image_cohort(dirs, str(paths["key"]),
                                     (CLI_SIDE,) * 3, "fill")
    pool_s = time.perf_counter() - t0
    excess = np.abs(pool.volumes - plain.volumes) / (
        COHORT_TOLERANCE * (1.0 + np.abs(plain.volumes)))
    if not np.array_equal(pool.uids, plain.uids) or excess.max() > 1.0:
        raise AssertionError(f"the pool's cohort lies {excess.max():.3g} x "
                             f"the tolerance from the plain path's")
    print(f"cli cohort build ({CLI_PATIENTS} patients x 2 modalities, "
          f"{CLI_VOLUME} -> {CLI_SIDE}^3): C++ pool {pool_s:.2f} s, plain "
          f"numpy path {plain_s:.2f} s (build_image_cohort, the same call); "
          f"pool {pooled} patients a modality, 0 fallbacks; max |pool - "
          f"plain| {np.abs(pool.volumes - plain.volumes).max():.3g} "
          f"(<= {COHORT_TOLERANCE:g} x (1 + |plain|))")
    # the segmentation cohort builder on the same patients (host only)
    t0 = time.perf_counter()
    seg_images, seg_masks = images.build_segmentation_cohort(
        dirs[0], str(paths["key"]), (CLI_SIDE,) * 3)
    seg_s = time.perf_counter() - t0
    shape = (CLI_PATIENTS,) + (CLI_SIDE,) * 3 + (1,)
    if not (np.array_equal(seg_images.uids, pool.uids)
            and np.array_equal(seg_masks.uids, pool.uids)
            and seg_images.volumes.shape == seg_masks.volumes.shape == shape
            and set(np.unique(seg_masks.volumes)) <= {0.0, 1.0}):
        raise AssertionError(
            f"build_segmentation_cohort: {seg_images.volumes.shape}, "
            f"{seg_masks.volumes.shape}, mask values "
            f"{np.unique(seg_masks.volumes)[:5]}, uids equal "
            f"{np.array_equal(seg_images.uids, pool.uids)}")
    print(f"cli segmentation cohort (build_segmentation_cohort, T1): "
          f"{len(seg_images.uids)} uids equal to the image cohort's, images "
          f"and masks {shape}, masks in {{0, 1}}, {seg_s:.2f} s")
    uid_lists = {name: (run_dir / f"{name}_uids.txt").read_text().split()
                 for name in ("train", "val", "test")}
    if sum(len(v) for v in uid_lists.values()) != CLI_PATIENTS:
        raise AssertionError(f"uid files {uid_lists}")
    rows = [json.loads(x) for x in (out / "metrics.jsonl").read_text()
            .splitlines()]
    if [r["epoch"] for r in rows] != list(range(1, CLI_EPOCHS + 1)) or not all(
            np.isfinite([r["train_loss"], r["val_loss"]]).all()
            and 0.0 <= r["train_c"] <= 1.0 and 0.0 <= r["val_c"] <= 1.0
            for r in rows):
        raise AssertionError(f"metrics rows {rows}")
    blend = np.loadtxt(out / "gblend_weights_history.csv", delimiter=",")
    if not (blend.shape == (CLI_EPOCHS + 1, 3)
            and np.allclose(blend.sum(1), 1.0, atol=1e-5)
            and not np.allclose(blend[-1], blend[0])):
        raise AssertionError(f"blend history {blend.tolist()}")
    fresh = build_model(parse_config(str(config_path)), True, True, False,
                        True)
    checkpoint.load_params_npz(str(out / "best_surv_model.npz"), fresh)
    per_forward = sum(fresh.image_model.block_config)  # 58 in DenseNet121
    expected = (counts["supersteps"] * TRAIN_MICRO
                + counts["val_forwards"]) * per_forward
    if launches != expected:
        raise AssertionError(
            f"the CLI run launched the kernel {launches} times, not "
            f"{counts['supersteps']} supersteps x {per_forward * TRAIN_MICRO}"
            f" + {counts['val_forwards']} validation forwards x "
            f"{per_forward} = {expected}")
    spe = counts["supersteps"] // CLI_EPOCHS
    run_counts = {"launches": launches, "per_epoch": launches // CLI_EPOCHS,
                  "supersteps": counts["supersteps"],
                  "val_forwards": counts["val_forwards"],
                  "pool_s": pool_s, "plain_s": plain_s}
    print(f"cli run: rc {rc}, {wall:.1f} s; train/val/test "
          f"{len(uid_lists['train'])}/{len(uid_lists['val'])}/"
          f"{len(uid_lists['test'])} patients; cohort build (load_cohort) "
          f"{counts['cohort_s'][0]:.1f} s; {counts['supersteps']} supersteps "
          f"({spe} an epoch), {counts['val_forwards']} validation forwards; "
          f"kernel launches {launches} = {expected} expected "
          f"({launches // CLI_EPOCHS} an epoch)")
    for r in rows:
        print(f"  epoch {r['epoch']}: {r['epoch_seconds']:.2f} s, "
              f"{r['samples_per_sec']:.1f} samples/s (host clock; samples "
              f"include the wrap pad), train loss {r['train_loss']:.4f}, "
              f"val loss {r['val_loss']:.4f}, train C {r['train_c']:.3f}, "
              f"val C {r['val_c']:.3f}")
    epoch_s = sum(r["epoch_seconds"] for r in rows)
    parts = {name: sum(counts[name + "_s"]) for name in (
        "supersteps", "val_forwards", "checkpoints")}
    print(f"  host seconds over the {CLI_EPOCHS} epochs, of the run's "
          f"{wall:.1f} s: the epochs' training ({epoch_s:.2f} s, the "
          f"epoch_seconds of metrics.jsonl) with the supersteps' calls "
          f"{parts['supersteps']:.2f} s (the host sets the pace, so a call "
          f"returns about when its work is done); after it, validation "
          f"forwards {parts['val_forwards']:.2f} s and checkpoints "
          f"{parts['checkpoints']:.2f} s")
    print(f"  best saves {counts.get('best_saves', 0)}, host stall of each "
          f"(snapshot + queue): " + ", ".join(
              f"{t * 1e3:.2f} ms" for t in counts.get("best_saves_s", [])))
    print(f"  blend weights {blend[-1].tolist()}; artifacts "
          f"{sorted(os.listdir(out))}; checkpoints "
          f"{sorted(os.listdir(ck))}")

    step_before = torch.load(ck / f"ckpt_{CLI_EPOCHS:08d}.pt",
                             weights_only=True)["step"]
    rc = run(["--epochs", str(CLI_EPOCHS + 1), "--resume"])
    manager = CheckpointManager(str(ck))
    step_after = torch.load(ck / f"ckpt_{CLI_EPOCHS + 1:08d}.pt",
                            weights_only=True)["step"]
    # the resumed run rewrites the blend history whole
    resumed = np.loadtxt(out / "gblend_weights_history.csv", delimiter=",")
    if rc != 0 or manager.latest_step() != CLI_EPOCHS + 1 \
            or step_after != step_before + spe \
            or resumed.shape != (CLI_EPOCHS + 2, 3) \
            or not np.array_equal(resumed[:-1], blend):
        raise AssertionError(f"resume: rc {rc}, latest checkpoint "
                             f"{manager.latest_step()}, step {step_before} "
                             f"-> {step_after}, blend history "
                             f"{resumed.tolist()}")
    print(f"cli --resume: epoch {CLI_EPOCHS + 1} ran, step {step_before} -> "
          f"{step_after}; blend history {len(resumed)} rows")

    config["Hyperparameters"]["model_weights"] = str(
        out / "best_surv_model.npz")
    trained = workdir / "trained.json"
    trained.write_text(json.dumps(config))
    artifact = workdir / "model.pt"
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "mmnn_sts_torch", "--images", "--preop",
         "--survival", "--blend", "--split", "--config", str(trained),
         "--output_path", str(out), "--export_path", str(artifact),
         "--device", CLI_DEVICE],
        cwd=run_dir, env={**os.environ, "PYTHONPATH": str(REPO)},
        capture_output=True, text=True, timeout=600)
    if res.returncode != 0:
        raise AssertionError(f"python3 -m mmnn_sts_torch --export_path "
                             f"failed: {res.stderr[-3000:]}")
    rng = np.random.default_rng(seed + 5)
    answer = ServingModel(str(artifact), device=CLI_DEVICE)({
        "image": (rng.normal(size=(3,) + (CLI_SIDE,) * 3 + (2,)) ** 2 * 500
                  ).astype(np.float32),
        "clinical": rng.normal(size=(3, 11)).astype(np.float32)})
    if answer.shape != (3, 2) or not np.isfinite(answer).all():
        raise AssertionError(f"served answer {answer}")
    print(f"cli export (python3 -m mmnn_sts_torch --export_path, a "
          f"subprocess): {time.perf_counter() - t0:.1f} s; ServingModel on "
          f"the card, batch 3: {answer.tolist()}")
    return run_counts


def recorded(fn, calls: list):
    """``fn``, appending each call's (args, kwargs, result) to ``calls``."""
    @functools.wraps(fn)
    def call(*args, **kw):
        out = fn(*args, **kw)
        calls.append((args, kw, out))
        return out

    return call


def event_ms(fn, iters: int = 3) -> float:
    """Median CUDA-event time of ``fn`` over ``iters`` calls after a
    warm-up: the device timeline between two markers, so where the host
    paces the work its gaps are in it."""
    fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def kernel_time(fn) -> tuple[float, int]:
    """(ms, launches) of the CUDA kernels of one call of ``fn`` after a
    warm-up, from torch.profiler: the device's busy time, without the
    host's gaps between kernels."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    return (sum(e.device_time_total for e in kernels) / 1e3,
            sum(e.count for e in kernels))


def read_csv_rows(path: Path) -> tuple[str, np.ndarray]:
    lines = path.read_text().splitlines()
    return lines[0], np.array([[float(v) for v in line.split(",")]
                               for line in lines[1:]])


def run_cli(fd, args, where: Path, patches) -> tuple[int, float, int]:
    """``cli.main(args)`` on CLI_DEVICE in ``where`` with ``patches``
    started (in order): (rc, seconds, the kernel's launches)."""
    from mmnn_sts_torch import cli

    cwd = Path.cwd()
    os.chdir(where)
    try:
        for p in patches:
            p.start()
        fd.fused_bn_relu_matmul.launches = 0
        t0 = time.perf_counter()
        rc = cli.main(args + ["--device", CLI_DEVICE])
        torch.cuda.synchronize()
        return rc, time.perf_counter() - t0, fd.fused_bn_relu_matmul.launches
    finally:
        for p in reversed(patches):
            p.stop()
        os.chdir(cwd)


def infer_phase(fd, seed: int, workdir: Path) -> dict:
    """Inference and classification through the port's CLI at full width,
    on the CLI phase's cohort and best weights (see the module docstring,
    phase 12). Returns the kernel launches of its runs."""
    from mmnn_sts_torch.config import parse_config
    from mmnn_sts_torch.data.nifti import load_nifti
    from mmnn_sts_torch.infer import run as infer_run
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.train import checkpoint, evaluate, loop

    run_dir = workdir / "run"
    config = json.loads((workdir / "trained.json").read_text())
    config["Preprocessing"] = {f"{s}_uid_location": str(run_dir /
                                                        f"{s}_uids.txt")
                               for s in ("train", "val", "test")}
    infer_config = workdir / "infer.json"
    infer_config.write_text(json.dumps(config))
    test_uids = (run_dir / "test_uids.txt").read_text().split()
    per_forward = sum(build_model(parse_config(str(infer_config)), True, True,
                                  False, True).image_model.block_config)

    run = functools.partial(run_cli, fd)

    # 1. survival inference with the attention maps
    counts, maps_calls, survival_calls = {}, [], []
    out = workdir / "infer_survival"
    rc, wall, launches = run(
        ["--inference", "--images", "--preop", "--survival", "--blend",
         "--config", str(infer_config), "--output_path", str(out)], run_dir, [
            mock.patch.object(evaluate, "survival_eval_step", counted(
                evaluate.survival_eval_step, counts, "eval_steps")),
            mock.patch.object(infer_run, "export_attention_maps", counted(
                infer_run.export_attention_maps, counts, "export")),
            mock.patch.object(infer_run, "attention_maps", recorded(
                infer_run.attention_maps, maps_calls)),
            mock.patch.object(infer_run, "inference_survival", recorded(
                infer_run.inference_survival, survival_calls))])
    n = len(test_uids)
    expected = per_forward * (counts["eval_steps"] + 2 * n)
    if rc != 0 or launches != expected:
        raise AssertionError(
            f"survival inference: rc {rc}, {launches} kernel launches, not "
            f"{per_forward} x ({counts['eval_steps']} eval steps + 2 x {n} "
            f"patients) = {expected}")
    header, rows = read_csv_rows(out / "survival_model_predictions.csv")
    if header != ("MRN,VS_pred,DM_pred,VS_event,DM_event,VS_duration,"
                  "DM_duration") or rows.shape != (n, 7) \
            or not np.isfinite(rows).all() \
            or sorted(rows[:, 0].astype(int)) != sorted(map(int, test_uids)):
        raise AssertionError(f"survival_model_predictions.csv: {header}, "
                             f"{rows.shape}")
    dirs = sorted(os.listdir(out / "attention_maps"))
    if dirs != sorted(f"_patient_{u}" for u in test_uids):
        raise AssertionError(f"attention map directories {dirs}")
    peaks = []
    for d in dirs:
        for name in ("t1image", "t2image", "att_map", "att_map_cls1"):
            vol = load_nifti(str(out / "attention_maps" / d / f"{name}.nii.gz"))
            if vol.shape != (CLI_SIDE,) * 3:
                raise AssertionError(f"{d}/{name}: shape {vol.shape}")
            if name.startswith("att_map"):
                if not (vol.min() >= 0.0 and vol.max() <= 1.0
                        and vol.max() > 0.5):
                    raise AssertionError(f"{d}/{name}: range [{vol.min()}, "
                                         f"{vol.max()}]")
                peaks.append(vol.max())
    export_s = counts["export_s"][0]
    args, kw, _ = maps_calls[0]  # the first patient's call
    model, inputs = args[:2]
    maps_ms = event_ms(lambda: infer_run.attention_maps(*args, **kw))
    maps_busy, maps_kernels = kernel_time(
        lambda: infer_run.attention_maps(*args, **kw))
    c_indices = survival_calls[0][2]["c_indices"]
    print(f"infer survival: rc {rc}, {wall:.1f} s for {n} test patients; "
          f"kernel launches {launches} = {per_forward} x "
          f"({counts['eval_steps']} eval step + 2 x {n}); C-indices "
          f"{c_indices}; Grad-CAM export {export_s:.2f} s = "
          f"{export_s / n * 1e3:.1f} ms a patient (its forward, maps and "
          f"four NIfTI writes); attention_maps alone, one patient: "
          f"{maps_ms:.2f} ms (CUDA events, median of 3), of which CUDA "
          f"kernels {maps_busy:.2f} ms in {maps_kernels} launches "
          f"(torch.profiler); att_map peaks {min(peaks):.3f}.."
          f"{max(peaks):.3f}")

    # 2. Grad-CAM on the card: the kernel against the plain op, and the CPU
    torch.backends.cudnn.allow_tf32 = False
    try:
        got = infer_run.attention_maps(*args, **kw)
        with mock.patch.object(fd, "fused_bn_relu_matmul",
                               fd.fused_bn_relu_matmul_reference):
            plain = infer_run.attention_maps(*args, **kw)
        with mock.patch.object(fd, "fused_bn_relu_matmul",
                               reassociated_reference):
            control = infer_run.attention_maps(*args, **kw)
    finally:
        torch.backends.cudnn.allow_tf32 = True
    cpu_model = copy.deepcopy(model).cpu()
    cpu_maps = infer_run.attention_maps(
        cpu_model, {k: v.cpu() for k, v in inputs.items()}, *args[2:], **kw)
    vs_plain = (got - plain).abs().max().item()
    vs_control = (control - plain).abs().max().item()
    vs_cpu = (got.cpu() - cpu_maps).abs().max().item()
    print(f"infer Grad-CAM, patient {test_uids[0]}, cudnn.allow_tf32 False: "
          f"kernel vs plain op max|diff| {vs_plain:.3e} (limit 1e-3); the "
          f"plain op with its product summed in two halves of K vs plain "
          f"{vs_control:.3e}; card vs CPU {vs_cpu:.3e} (limit 1e-2)")
    if not (vs_plain <= 1e-3 and vs_cpu <= 1e-2):
        raise AssertionError("the attention maps on the card disagree with "
                             "the plain op's or the CPU's")
    del cpu_model, cpu_maps

    # 3. the bootstrap
    boot_calls, survival_calls = [], []
    out = workdir / "infer_bootstrap"
    rc, boot_wall, boot_launches = run(
        ["--inference", "--images", "--preop", "--survival", "--blend",
         "--bootstrap", "--no_gradcam", "--config", str(infer_config),
         "--output_path", str(out)], run_dir, [
            mock.patch.object(infer_run, "bootstrap_cindices", recorded(
                infer_run.bootstrap_cindices, boot_calls)),
            mock.patch.object(infer_run, "inference_survival", recorded(
                infer_run.inference_survival, survival_calls))])
    res = survival_calls[0][2]
    (preds, events, durations, resamples), _, (cs, _) = boot_calls[0]
    if rc != 0 or resamples.shape[0] != 50 or len(res["resample_c"]) < 1 \
            or not all(np.isfinite(res[k]).all() and (res[k] >= 0).all()
                       and (res[k] <= 1).all() for k in ("mean_c", "std_c")):
        raise AssertionError(f"bootstrap: rc {rc}, {resamples.shape[0]} "
                             f"resamples, means {res['mean_c']}, stds "
                             f"{res['std_c']}")
    cpu_cs, _ = infer_run.bootstrap_cindices(
        preds.cpu(), events.cpu(), durations.cpu(), resamples.cpu())
    vs_cpu = np.nanmax(np.abs(cs.cpu().numpy() - cpu_cs.numpy()))
    if not (vs_cpu <= 1e-6 and torch.equal(cs.isnan().cpu(), cpu_cs.isnan())):
        raise AssertionError(f"bootstrap C-indices, card vs CPU {vs_cpu}")
    boot_ms, boot_host_ms, _ = time_calls(lambda: infer_run.bootstrap_cindices(
        preds, events, durations, resamples))
    boot_busy, boot_kernels = kernel_time(lambda: infer_run.bootstrap_cindices(
        preds, events, durations, resamples))
    print(f"infer bootstrap: rc {rc}, {boot_wall:.1f} s; {resamples.shape[0]}"
          f" resamples of {n}, {len(res['resample_c'])} kept; mean C "
          f"{res['mean_c'].tolist()}, std {res['std_c'].tolist()}; card vs "
          f"CPU max|diff| {vs_cpu:.1e} (limit 1e-6); the batched C-index "
          f"(2 classes x {resamples.shape[0]} resamples): CUDA kernels "
          f"{boot_busy:.4f} ms in {boot_kernels} launches (torch.profiler), "
          f"{boot_ms:.4f} ms a call queued behind a sleep, {boot_host_ms:.4f}"
          f" ms of host time a call; the run's kernel launches "
          f"{boot_launches}")

    # 4. classification training, in a run directory of its own
    class_dir = workdir / "run_class"
    class_dir.mkdir()
    counts = {}
    out = class_dir / "out"
    epochs = 2
    rc, wall, class_launches = run(
        ["--images", "--preop", "--classification", "--blend", "--split",
         "--config", str(workdir / "config.json"), "--epochs", str(epochs),
         "--blend_update_interval", "1", "--output_path", str(out),
         "--checkpoint_dir", str(class_dir / "ck")], class_dir, [
            mock.patch.object(loop, "classification_train_step", counted(
                loop.classification_train_step, counts, "steps")),
            mock.patch.object(evaluate, "classification_eval_step", counted(
                evaluate.classification_eval_step, counts, "val_forwards"))])
    rows = [json.loads(x) for x in (out / "metrics.jsonl").read_text()
            .splitlines()]
    blend = np.loadtxt(out / "gblend_weights_history.csv", delimiter=",")
    if rc != 0 or [r["kind"] for r in rows] != ["classification_epoch"] * \
            epochs or not all(
                np.isfinite([r["train_loss"], r["val_loss"]]).all()
                and all(np.isnan(r[k]) or 0.0 <= r[k] <= 1.0
                        for k in ("train_f1", "val_f1")) for r in rows) \
            or not (blend.shape == (epochs + 1, 3)
                    and np.allclose(blend.sum(1), 1.0, atol=1e-5)
                    and not np.allclose(blend[-1], blend[0])):
        raise AssertionError(f"classification: rc {rc}, rows {rows}, blend "
                             f"{blend.tolist()}")
    fresh = build_model(parse_config(str(workdir / "config.json")), True,
                        True, False, True)
    checkpoint.load_params_npz(str(out / "model.npz"), fresh)
    expected = (counts["steps"] + counts["val_forwards"]) * per_forward
    if class_launches != expected:
        raise AssertionError(
            f"classification launched the kernel {class_launches} times, not"
            f" ({counts['steps']} steps + {counts['val_forwards']} validation"
            f" forwards) x {per_forward} = {expected}")
    print(f"infer classification training: rc {rc}, {wall:.1f} s; "
          f"{counts['steps']} steps of {TRAIN_BATCH} ({counts['steps'] // epochs}"
          f" an epoch), {counts['val_forwards']} validation forwards; kernel "
          f"launches {class_launches} = {expected} expected; blend weights "
          f"{blend[-1].tolist()}")
    for r in rows:
        print(f"  epoch {r['epoch']}: {r['epoch_seconds']:.2f} s, "
              f"{r['samples_per_sec']:.1f} samples/s (host clock), train loss"
              f" {r['train_loss']:.4f}, val loss {r['val_loss']:.4f}, train "
              f"F1 {r['train_f1']:.3f}, val F1 {r['val_f1']:.3f}")

    # 5. classification inference on the weights it trained
    config = json.loads((workdir / "config.json").read_text())
    config["Hyperparameters"]["model_weights"] = str(out / "model.npz")
    config["Preprocessing"] = {f"{s}_uid_location": str(class_dir /
                                                        f"{s}_uids.txt")
                               for s in ("train", "val", "test")}
    class_config = workdir / "infer_class.json"
    class_config.write_text(json.dumps(config))
    class_test = (class_dir / "test_uids.txt").read_text().split()
    counts = {}
    out = workdir / "infer_classification"
    rc, wall, infer_launches = run(
        ["--inference", "--images", "--preop", "--classification", "--blend",
         "--config", str(class_config), "--output_path", str(out)],
        class_dir, [mock.patch.object(evaluate, "classification_eval_step",
                                      counted(evaluate.classification_eval_step,
                                              counts, "eval_steps"))])
    header, rows = read_csv_rows(out / "model_probabilities.csv")
    dirs = set(os.listdir(out / "attention_maps"))
    want_dirs = set()
    for row in rows:
        labels = "".join(str(int(v)) for v in row[3:5])
        preds = "".join(str(int(v > 0.5)) for v in row[1:3])
        correct = "".join("1" if a == b else "0" for a, b in zip(labels, preds))
        want_dirs.add(f"{correct}_{labels}_{preds}__patient_{int(row[0])}")
    expected = per_forward * (counts["eval_steps"] + len(class_test))
    if rc != 0 or header != "0,1,2,3,4" or rows.shape != (len(class_test), 5) \
            or not ((rows[:, 1:3] >= 0) & (rows[:, 1:3] <= 1)).all() \
            or dirs != want_dirs or infer_launches != expected:
        raise AssertionError(
            f"classification inference: rc {rc}, {header}, {rows.shape}, "
            f"directories {sorted(dirs)} vs {sorted(want_dirs)}, launches "
            f"{infer_launches} vs {expected}")
    print(f"infer classification: rc {rc}, {wall:.1f} s for "
          f"{len(class_test)} test patients; kernel launches {infer_launches}"
          f" = {per_forward} x ({counts['eval_steps']} eval step + "
          f"{len(class_test)} patients); directories agree with "
          f"model_probabilities.csv")
    return {"survival": launches, "classification": infer_launches,
            "per_classification_epoch": class_launches // epochs}


def kernel_dtypes(fd, seen: set):
    """A patch of the kernel's wrapper that adds each call's (x dtype, w
    dtype) to ``seen``. While it is active, read the launches from
    ``fd.fused_bn_relu_matmul.launches`` (the wrapper counts on the name it
    finds in its module)."""
    orig = fd.fused_bn_relu_matmul

    @functools.wraps(orig)
    def call(x, a, b, w):
        seen.add((x.dtype, w.dtype))
        return orig(x, a, b, w)

    return mock.patch.object(fd, "fused_bn_relu_matmul", call)


def check_bf16_calls(seen: set, where: str):
    if seen != {(torch.bfloat16, torch.bfloat16)}:
        raise AssertionError(f"{where}: the kernel's calls had x and w of "
                             f"{sorted(map(str, seen))}, not bfloat16 only")


def flat_update(params, before) -> torch.Tensor:
    return torch.cat([(p.detach() - b).flatten().float()
                      for p, b in zip(params, before)])


def bf16_train_phase(fd, seed: int) -> dict:
    """The flagship superstep with TPU.compute_dtype bfloat16 (see the module
    docstring, phase 7). Returns its launches and device times."""
    from mmnn_sts_torch.config import Config
    from mmnn_sts_torch.convert import load_jax_npz, to_jax_flat
    from mmnn_sts_torch.infer.export import model_spec
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.train.schedule import make_optimizer
    from mmnn_sts_torch.train.state import create_train_state
    from mmnn_sts_torch.train.steps import survival_train_superstep

    cfg = Config()
    cfg.image_model.name = CLI_MODEL
    cfg.image_model.spatial_size = [CLI_SIDE] * 3
    cfg.tpu.compute_dtype = "bfloat16"
    flags = dict(images=True, preop=True, postop=False, blend=True)
    spec = model_spec(cfg, **flags)
    model = build_model(cfg, **flags)
    per_forward = sum(model.image_model.block_config)  # 58 in DenseNet121
    weights = random_flat_weights(model, seed, to_jax_flat)
    rng = np.random.default_rng(seed + 3)
    inputs, events, durations = synthetic_split(
        rng, (TRAIN_MICRO, TRAIN_BATCH), spec, CLI_DEVICE)
    volumes = TRAIN_MICRO * TRAIN_BATCH

    def new_state(total_steps: int):
        model = build_model(cfg, **flags)
        load_jax_npz(model, weights)
        model.to(CLI_DEVICE)
        return create_train_state(model, *make_optimizer(
            model.parameters(), TRAIN_LR, total_steps, 1), seed=seed)

    def superstep(state):
        aux = survival_train_superstep(state, inputs, events, durations,
                                       blend=True, augment=True)
        if not torch.isfinite(aux["loss"]):
            raise AssertionError("a bfloat16 superstep's loss is not finite")
        return aux

    def update_with(patch):
        """One augmented superstep from the initial state (the same draws
        every time) under ``patch``: (its output, its update, the kernel's
        launches)."""
        state = new_state(4)
        params = list(state.model.parameters())
        before = [p.detach().clone() for p in params]
        with patch:
            aux = superstep(state)
            torch.cuda.synchronize()
            launched = getattr(fd.fused_bn_relu_matmul, "launches", None)
        update = flat_update(params, before)
        if not torch.isfinite(update).all():
            raise AssertionError("a bfloat16 superstep's update is not finite")
        return aux, update, launched

    def rel(got, want):
        return ((got.float() - want.float()).norm()
                / want.float().norm()).item()

    seen = set()
    fd.fused_bn_relu_matmul.launches = 0
    got_aux, got, launched = update_with(kernel_dtypes(fd, seen))
    check_bf16_calls(seen, "bf16 superstep")
    if launched != per_forward * TRAIN_MICRO:
        raise AssertionError(f"a bfloat16 superstep launched the kernel "
                             f"{launched} times, not "
                             f"{per_forward * TRAIN_MICRO}")
    want_aux, want, _ = update_with(mock.patch.object(
        fd, "fused_bn_relu_matmul", fd.fused_bn_relu_matmul_reference))
    ctrl_aux, control, _ = update_with(mock.patch.object(
        fd, "fused_bn_relu_matmul", reassociated_reference))
    dists = {"update": (rel(got, want), rel(control, want)),
             "predictions": (rel(got_aux["preds"], want_aux["preds"]),
                             rel(ctrl_aux["preds"], want_aux["preds"]))}
    print(f"bf16 train: {TRAIN_MICRO} x {TRAIN_BATCH} volumes of "
          f"{tuple(inputs['image'].shape[2:])}, compute_dtype bfloat16, "
          f"augmentation on, dropout {cfg.image_model.dropout_prob}; "
          f"{launched} kernel launches, every call with bfloat16 x and w; "
          f"loss kernel {got_aux['loss'].item():.6f} plain "
          f"{want_aux['loss'].item():.6f} control "
          f"{ctrl_aux['loss'].item():.6f}; relative L2 to the plain op's, "
          f"kernel / control (the plain op with its product summed in two "
          f"halves of K), limit {BF16_CONTROL_FACTOR:g} x the control's: "
          + ", ".join(f"{k} {d:.3e} / {c:.3e}" for k, (d, c) in dists.items())
          + f"; update norm kernel / plain {got.norm() / want.norm():.4f}")
    bad = [k for k, (d, c) in dists.items() if not d <= BF16_CONTROL_FACTOR * c]
    if bad:
        raise AssertionError(f"the bfloat16 superstep with the kernel "
                             f"disagrees with the plain op's: {bad}")
    dist, ctrl = dists["update"]

    state = new_state(2 + TRAIN_TIMED)
    timed_supersteps(lambda: superstep(state), volumes,
                     "bf16 train superstep with augmentation")
    # the graphed bf16 superstep is profiled in fused_epoch_phase
    return {"launches": launched, "update_rel_l2": dist,
            "control_rel_l2": ctrl}


def deviations(got: dict, want: dict) -> list:
    """(|got - want| / (TRAIN_TOLERANCE x max(1, |want|)), name) of each
    tensor of two same-keyed dicts; inf where ``got`` is not finite."""
    out = []
    for name, w in want.items():
        g = got[name].float()
        limit = TRAIN_TOLERANCE * max(1.0, w.float().abs().max().item())
        ratio = (g - w.float()).abs().max().item() / limit
        out.append((ratio if torch.isfinite(g).all() else float("inf"),
                    name))
    return out


def superstep_tensors(aux, model) -> dict:
    """The loss, the predictions, every summed gradient and every running
    statistic after a superstep, by name."""
    out = {"loss": aux["loss"], "preds": aux["preds"]}
    out.update({f"grad {n}": p.grad for n, p in model.named_parameters()})
    out.update({f"buffer {n}": b for n, b in model.named_buffers()})
    return out


def families_phase(fd, seed: int) -> dict:
    """Every image model name beyond the flagship's (FAMILIES), image-only
    at full width (see the module docstring, phase 8). Returns, by name,
    the kernel's launches per forward and per superstep, the peak memory
    and the times."""
    from mmnn_sts_torch.config import Config
    from mmnn_sts_torch.convert import load_jax_npz, to_jax_flat
    from mmnn_sts_torch.infer.export import model_spec
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.ops.augment import eval_transform_batch
    from mmnn_sts_torch.train.schedule import make_optimizer
    from mmnn_sts_torch.train.state import create_train_state
    from mmnn_sts_torch.train.steps import survival_train_superstep

    flags = dict(images=True, preop=False, postop=False, blend=False)
    rng = np.random.default_rng(seed + 8)
    tf32, torch.backends.cudnn.allow_tf32 = \
        torch.backends.cudnn.allow_tf32, False
    print(f"families: image-only, {CLI_SIDE}^3 x 2ch, Config() defaults, "
          f"random weights; eval forward of {TRAIN_BATCH}; augmented "
          f"survival superstep of {FAMILY_MICRO} x {TRAIN_BATCH} with the "
          f"kernel and with the plain op (cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}), loss, predictions, summed "
          f"gradients and running statistics within {TRAIN_TOLERANCE:.0e} x "
          "max(1, |plain|); bfloat16 eval forward")
    results = {}
    for name in FAMILIES:
        cfg = Config()
        cfg.image_model.name = name
        cfg.image_model.spatial_size = [CLI_SIDE] * 3
        spec = model_spec(cfg, **flags)
        base = build_model(cfg, **flags)
        per_forward = sum(getattr(base, "block_config", ()))
        weights = random_flat_weights(base, seed, to_jax_flat)
        load_jax_npz(base, weights)
        inputs, events, durations = synthetic_split(
            rng, (FAMILY_MICRO, TRAIN_BATCH), spec, CLI_DEVICE)
        image = inputs["image"]
        vols = eval_transform_batch(image[0])

        def new_state():
            model = copy.deepcopy(base).to(CLI_DEVICE)
            return create_train_state(model, *make_optimizer(
                model.parameters(), TRAIN_LR, 4, 1), seed=seed)

        def superstep(state):
            return survival_train_superstep(state, image, events, durations,
                                            augment=True)

        state = new_state()
        model = state.model.eval()
        fd.fused_bn_relu_matmul.launches = 0
        with torch.no_grad():
            out = model(vols)
        torch.cuda.synchronize()
        launched = fd.fused_bn_relu_matmul.launches
        if out.shape != (TRAIN_BATCH, 2) or not torch.isfinite(out).all() \
                or launched != per_forward:
            raise AssertionError(f"{name} eval forward: {tuple(out.shape)}, "
                                 f"finite {bool(torch.isfinite(out).all())},"
                                 f" {launched} launches, not {per_forward}")
        with torch.no_grad():
            forward_ms = event_ms(lambda: model(vols))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fd.fused_bn_relu_matmul.launches = 0
        got = superstep(state)
        torch.cuda.synchronize()
        step_launches = fd.fused_bn_relu_matmul.launches
        peak = torch.cuda.max_memory_allocated()
        got = superstep_tensors(got, state.model)
        if step_launches != FAMILY_MICRO * per_forward:
            raise AssertionError(f"{name} superstep: {step_launches} "
                                 f"launches, not {FAMILY_MICRO * per_forward}")
        plain = new_state()
        with mock.patch.object(fd, "fused_bn_relu_matmul",
                               fd.fused_bn_relu_matmul_reference):
            want = superstep_tensors(superstep(plain), plain.model)
        dev = deviations(got, want)
        bad = [(r, n) for r, n in dev if not r <= 1.0]
        if bad:
            raise AssertionError(f"{name} superstep, kernel vs plain op: "
                                 f"{sorted(bad)[-5:]}")
        del plain, want, got
        step_ms = event_ms(lambda: superstep(state), iters=1)

        cfg.tpu.compute_dtype = "bfloat16"
        model16 = build_model(cfg, **flags)
        load_jax_npz(model16, weights)
        model16.to(CLI_DEVICE).eval()
        seen = set()
        with kernel_dtypes(fd, seen), torch.no_grad():
            fd.fused_bn_relu_matmul.launches = 0
            out16 = model16(vols)
            torch.cuda.synchronize()
            launched16 = fd.fused_bn_relu_matmul.launches
        if per_forward:
            check_bf16_calls(seen, f"{name} bf16 eval forward")
        if out16.dtype != torch.bfloat16 or out16.shape != (TRAIN_BATCH, 2) \
                or not torch.isfinite(out16.float()).all() \
                or launched16 != per_forward:
            raise AssertionError(f"{name} bf16 eval forward: {out16!r}, "
                                 f"{launched16} launches")
        results[name] = dict(per_forward=launched, superstep=step_launches,
                             peak_gib=peak / 2**30, forward_ms=forward_ms,
                             superstep_ms=step_ms)
        worst = max(dev)
        print(f"  {name}: eval forward ({TRAIN_BATCH}, 2) finite, {launched} "
              f"launches, {forward_ms:.2f} ms (CUDA events); superstep "
              f"{step_launches} launches, {len(dev) - 2} gradients and "
              f"statistics, largest {worst[0]:.1%} of the limit "
              f"({worst[1]}), {step_ms:.1f} ms = "
              f"{FAMILY_MICRO * TRAIN_BATCH * 1e3 / step_ms:.1f} volumes/s "
              f"(TF32 off), max_memory_allocated {peak / 2**30:.2f} GiB; "
              f"bf16 forward {launched16} launches"
              + (", every call bf16" if per_forward else "")
              + f", max|bf16 - fp32| {(out16.float() - out).abs().max():.3e}")
        del state, model, model16, base
        torch.cuda.empty_cache()
    torch.backends.cudnn.allow_tf32 = tf32
    return results


def remat_phase(fd, seed: int) -> dict:
    """The flagship superstep with TPU.remat off and on (see the module
    docstring, phase 9). Returns the launches, peaks and times of each."""
    from mmnn_sts_torch.config import Config
    from mmnn_sts_torch.convert import load_jax_npz, to_jax_flat
    from mmnn_sts_torch.infer.export import model_spec
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.train.schedule import make_optimizer
    from mmnn_sts_torch.train.state import create_train_state
    from mmnn_sts_torch.train.steps import survival_train_superstep

    flags = dict(images=True, preop=True, postop=False, blend=True)
    cfg = Config()
    cfg.image_model.spatial_size = [CLI_SIDE] * 3
    spec = model_spec(cfg, **flags)
    weights = random_flat_weights(build_model(cfg, **flags), seed,
                                  to_jax_flat)
    rng = np.random.default_rng(seed + 3)
    inputs, events, durations = synthetic_split(
        rng, (TRAIN_MICRO, TRAIN_BATCH), spec, CLI_DEVICE)
    tf32, torch.backends.cudnn.allow_tf32 = \
        torch.backends.cudnn.allow_tf32, False
    runs = {}
    for remat in (False, True):
        cfg.tpu.remat = remat
        model = build_model(cfg, **flags)
        load_jax_npz(model, weights)
        model.to(CLI_DEVICE)
        state = create_train_state(model, *make_optimizer(
            model.parameters(), TRAIN_LR, 4, 1), seed=seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        fd.fused_bn_relu_matmul.launches = 0
        start.record()
        aux = survival_train_superstep(state, inputs, events, durations,
                                       blend=True, augment=False)
        end.record()
        torch.cuda.synchronize()
        runs[remat] = dict(
            tensors=superstep_tensors(aux, model),
            launches=fd.fused_bn_relu_matmul.launches,
            peak=torch.cuda.max_memory_allocated(),
            ms=start.elapsed_time(end))
        del state, model
    torch.backends.cudnn.allow_tf32 = tf32
    per_forward = sum(build_model(cfg, **flags).image_model.block_config)
    expected = {False: TRAIN_MICRO * per_forward,
                True: TRAIN_MICRO * (2 * per_forward - 1)}
    dev = deviations(runs[True]["tensors"], runs[False]["tensors"])
    bad = [(r, n) for r, n in dev if not r <= 1.0]
    launches = {k: v["launches"] for k, v in runs.items()}
    if bad or launches != expected:
        raise AssertionError(f"remat superstep: launches {launches} vs "
                             f"{expected}; beyond the limit {bad[-5:]}")
    worst = max(dev)
    print(f"remat: flagship superstep {TRAIN_MICRO} x {TRAIN_BATCH} at "
          f"{CLI_SIDE}^3, dropout {cfg.image_model.dropout_prob}, TF32 off: "
          f"TPU.remat on vs off, loss, predictions, {len(dev) - 2} summed "
          f"gradients and running statistics within {TRAIN_TOLERANCE:.0e} x "
          f"max(1, |off|): largest {worst[0]:.1%} ({worst[1]}); launches "
          f"{launches[True]} vs {launches[False]}; max_memory_allocated "
          f"{runs[True]['peak'] / 2**30:.2f} vs "
          f"{runs[False]['peak'] / 2**30:.2f} GiB; one superstep "
          f"{runs[True]['ms']:.1f} vs {runs[False]['ms']:.1f} ms (CUDA "
          "events, the first of each)")
    return {"launches": launches[True], "launches_off": launches[False],
            "peak_gib": runs[True]["peak"] / 2**30,
            "peak_gib_off": runs[False]["peak"] / 2**30}


def bf16_cli_phase(fd, seed: int, workdir: Path) -> dict:
    """The survival run, its export and --inference with TPU.compute_dtype
    bfloat16 on the CLI phase's cohort (see the module docstring, phase
    14). Returns the kernel launches of its runs."""
    from mmnn_sts_torch.config import parse_config
    from mmnn_sts_torch.data.nifti import load_nifti
    from mmnn_sts_torch.infer import run as infer_run
    from mmnn_sts_torch.infer.export import ServingModel
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.train import checkpoint, evaluate, loop

    config = json.loads((workdir / "config.json").read_text())
    config["TPU"] = {"compute_dtype": "bfloat16"}
    config_path = workdir / "config_bf16.json"
    config_path.write_text(json.dumps(config))
    run_dir = workdir / "run_bf16"
    run_dir.mkdir()
    out = run_dir / "out"
    per_forward = sum(build_model(parse_config(str(config_path)), True, True,
                                  False, True).image_model.block_config)

    def run(args, patches):
        """run_cli in run_dir, the kernel's calls checked for bfloat16."""
        seen = set()
        out = run_cli(fd, args, run_dir, [kernel_dtypes(fd, seen), *patches])
        check_bf16_calls(seen, f"bf16 {args[0]}")
        return out

    # 1. training, 2 epochs
    epochs, counts = 2, {}
    rc, wall, launches = run(
        ["--images", "--preop", "--survival", "--blend", "--split",
         "--config", str(config_path), "--epochs", str(epochs),
         "--blend_update_interval", "1", "--output_path", str(out)], [
            mock.patch.object(loop, "survival_train_superstep", counted(
                loop.survival_train_superstep, counts, "supersteps")),
            mock.patch.object(evaluate, "survival_eval_step", counted(
                evaluate.survival_eval_step, counts, "val_forwards"))])
    rows = [json.loads(x) for x in (out / "metrics.jsonl").read_text()
            .splitlines()]
    expected = (counts["supersteps"] * TRAIN_MICRO
                + counts["val_forwards"]) * per_forward
    if rc != 0 or [r["epoch"] for r in rows] != list(range(1, epochs + 1)) \
            or not all(np.isfinite([r["train_loss"], r["val_loss"]]).all()
                       for r in rows) or launches != expected:
        raise AssertionError(f"bf16 CLI run: rc {rc}, rows {rows}, launches "
                             f"{launches} vs {expected}")
    fresh = build_model(parse_config(str(config_path)), True, True, False,
                        True)
    checkpoint.load_params_npz(str(out / "best_surv_model.npz"), fresh)
    print(f"bf16 cli run: rc {rc}, {wall:.1f} s, {epochs} epochs; "
          f"{counts['supersteps']} supersteps, {counts['val_forwards']} "
          f"validation forwards; kernel launches {launches} = {expected} "
          f"({launches // epochs} an epoch), every call with bfloat16 x and "
          f"w; best_surv_model.npz loads strictly into a fresh model")
    for r in rows:
        print(f"  epoch {r['epoch']}: {r['epoch_seconds']:.2f} s, "
              f"{r['samples_per_sec']:.1f} samples/s (host clock), train "
              f"loss {r['train_loss']:.4f}, val loss {r['val_loss']:.4f}, "
              f"train C {r['train_c']:.3f}, val C {r['val_c']:.3f}")

    # 2. the export, served on the card
    config["Hyperparameters"]["model_weights"] = str(
        out / "best_surv_model.npz")
    config["Preprocessing"] = {f"{s}_uid_location": str(run_dir /
                                                        f"{s}_uids.txt")
                               for s in ("train", "val", "test")}
    trained = workdir / "trained_bf16.json"
    trained.write_text(json.dumps(config))
    artifact = workdir / "model_bf16.pt"
    # in process (cli_phase runs the export as a subprocess)
    rc, export_s, _ = run_cli(fd, [
        "--images", "--preop", "--survival", "--blend", "--config",
        str(trained), "--output_path", str(out), "--export_path",
        str(artifact)], run_dir, [])
    if rc != 0:
        raise AssertionError(f"bf16 --export_path returned {rc}")
    served = ServingModel(str(artifact), device=CLI_DEVICE)
    rng = np.random.default_rng(seed + 6)
    seen = set()
    with kernel_dtypes(fd, seen):
        fd.fused_bn_relu_matmul.launches = 0
        answer = served({
            "image": (rng.normal(size=(3,) + (CLI_SIDE,) * 3 + (2,)) ** 2
                      * 500).astype(np.float32),
            "clinical": rng.normal(size=(3, 11)).astype(np.float32)})
        served_launches = fd.fused_bn_relu_matmul.launches
    check_bf16_calls(seen, "bf16 served forward")
    if served.spec["compute_dtype"] != "bfloat16" \
            or answer.dtype != np.float32 or answer.shape != (3, 2) \
            or not np.isfinite(answer).all() or served_launches != per_forward:
        raise AssertionError(f"bf16 servable: spec {served.spec}, answer "
                             f"{answer!r}, launches {served_launches}")
    print(f"bf16 export (cli.main --export_path, in process): "
          f"{export_s:.1f} s; spec compute_dtype "
          f"{served.spec['compute_dtype']}; ServingModel on the card, batch 3,"
          f" {served_launches} launches with bfloat16 x and w: float32 "
          f"{answer.tolist()}")
    del served

    # 3. --inference --survival with Grad-CAM on the test patients
    test_uids = (run_dir / "test_uids.txt").read_text().split()
    counts = {}
    infer_out = workdir / "infer_bf16"
    rc, wall, infer_launches = run(
        ["--inference", "--images", "--preop", "--survival", "--blend",
         "--config", str(trained), "--output_path", str(infer_out)], [
            mock.patch.object(evaluate, "survival_eval_step", counted(
                evaluate.survival_eval_step, counts, "eval_steps")),
            mock.patch.object(infer_run, "export_attention_maps", counted(
                infer_run.export_attention_maps, counts, "export"))])
    n = len(test_uids)
    expected = per_forward * (counts["eval_steps"] + 2 * n)
    dirs = sorted(os.listdir(infer_out / "attention_maps"))
    if rc != 0 or infer_launches != expected \
            or dirs != sorted(f"_patient_{u}" for u in test_uids):
        raise AssertionError(f"bf16 inference: rc {rc}, launches "
                             f"{infer_launches} vs {expected}, {dirs}")
    peaks = []
    for d in dirs:
        for name in ("att_map", "att_map_cls1"):
            vol = load_nifti(str(infer_out / "attention_maps" / d /
                                 f"{name}.nii.gz"))
            if not (vol.shape == (CLI_SIDE,) * 3 and vol.min() >= 0.0
                    and vol.max() <= 1.0 and vol.max() > 0.5):
                raise AssertionError(f"bf16 {d}/{name}: {vol.shape}, range "
                                     f"[{vol.min()}, {vol.max()}]")
            peaks.append(vol.max())
    print(f"bf16 infer survival: rc {rc}, {wall:.1f} s for {n} test "
          f"patients; kernel launches {infer_launches} = {per_forward} x "
          f"({counts['eval_steps']} eval step + 2 x {n}), every call with "
          f"bfloat16 x and w; Grad-CAM export {counts['export_s'][0]:.2f} s;"
          f" att_map peaks {min(peaks):.3f}..{max(peaks):.3f}")
    return {"per_epoch": launches // epochs, "served": served_launches,
            "inference": infer_launches}


def wide_cli_phase(fd, seed: int, workdir: Path) -> dict:
    """The slice's paths through the CLI on the CLI phase's cohort (see the
    module docstring, phase 15). Returns the kernel launches of its runs."""
    import importlib.util

    from mmnn_sts_torch.config import parse_config
    from mmnn_sts_torch.data.nifti import load_nifti
    from mmnn_sts_torch.infer import run as infer_run
    from mmnn_sts_torch.infer.export import ServingModel
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.train import checkpoint, evaluate, loop, lr_finder

    base = json.loads((workdir / "config.json").read_text())

    def config(name: str, model: str, **hyper) -> Path:
        cfg = copy.deepcopy(base)
        cfg["ImageModel"]["name"] = model
        cfg["Hyperparameters"].update(hyper)
        path = workdir / f"{name}.json"
        path.write_text(json.dumps(cfg))
        return path

    def uid_files(cfg_path: Path, run_dir: Path, weights: Path) -> Path:
        cfg = json.loads(cfg_path.read_text())
        cfg["Hyperparameters"]["model_weights"] = str(weights)
        cfg["Preprocessing"] = {f"{s}_uid_location": str(run_dir /
                                                        f"{s}_uids.txt")
                                for s in ("train", "val", "test")}
        path = cfg_path.with_name(cfg_path.stem + "_trained.json")
        path.write_text(json.dumps(cfg))
        return path

    # 1. the image-only survival run of densenet201, its export served
    cfg_path = config("wide", WIDE_CLI_MODEL)
    run_dir = workdir / "run_wide"
    run_dir.mkdir()
    out = run_dir / "out"
    per_forward = sum(build_model(parse_config(str(cfg_path)), True, False,
                                  False, False).block_config)
    counts = {}
    rc, wall, launches = run_cli(fd, [
        "--images", "--survival", "--split", "--config", str(cfg_path),
        "--epochs", str(WIDE_CLI_EPOCHS), "--output_path", str(out)],
        run_dir, [
            mock.patch.object(loop, "survival_train_superstep", counted(
                loop.survival_train_superstep, counts, "supersteps")),
            mock.patch.object(evaluate, "survival_eval_step", counted(
                evaluate.survival_eval_step, counts, "val_forwards"))])
    rows = [json.loads(x) for x in (out / "metrics.jsonl").read_text()
            .splitlines()]
    expected = (counts["supersteps"] * TRAIN_MICRO
                + counts["val_forwards"]) * per_forward
    if rc != 0 or [r["epoch"] for r in rows] != list(
            range(1, WIDE_CLI_EPOCHS + 1)) or not all(
            np.isfinite([r["train_loss"], r["val_loss"]]).all()
            for r in rows) or launches != expected:
        raise AssertionError(f"{WIDE_CLI_MODEL} CLI run: rc {rc}, rows "
                             f"{rows}, launches {launches} vs {expected}")
    best = out / "best_surv_model.npz"
    checkpoint.load_params_npz(str(best), build_model(
        parse_config(str(cfg_path)), True, False, False, False))
    wide_launches = launches
    print(f"wide cli --images --survival --split, {WIDE_CLI_MODEL}: rc {rc}, "
          f"{wall:.1f} s, {WIDE_CLI_EPOCHS} epochs; {counts['supersteps']} "
          f"supersteps, {counts['val_forwards']} validation forwards; kernel "
          f"launches {launches} = {expected} ({per_forward} a forward); "
          f"best_surv_model.npz loads strictly")
    for r in rows:
        print(f"  epoch {r['epoch']}: {r['epoch_seconds']:.2f} s, "
              f"{r['samples_per_sec']:.1f} samples/s (host clock), train "
              f"loss {r['train_loss']:.4f}, val loss {r['val_loss']:.4f}, "
              f"train C {r['train_c']:.3f}, val C {r['val_c']:.3f}")
    trained = uid_files(cfg_path, run_dir, best)
    artifact = workdir / "model_wide.pt"
    rc, export_s, _ = run_cli(fd, [
        "--images", "--survival", "--config", str(trained), "--output_path",
        str(out), "--export_path", str(artifact)], run_dir, [])
    served = ServingModel(str(artifact), device=CLI_DEVICE)
    rng = np.random.default_rng(seed + 9)
    fd.fused_bn_relu_matmul.launches = 0
    answer = served((rng.normal(size=(3,) + (CLI_SIDE,) * 3 + (2,)) ** 2
                     * 500).astype(np.float32))
    served_launches = fd.fused_bn_relu_matmul.launches
    if rc != 0 or answer.shape != (3, 2) or not np.isfinite(answer).all() \
            or served_launches != per_forward:
        raise AssertionError(f"{WIDE_CLI_MODEL} export: rc {rc}, answer "
                             f"{answer!r}, launches {served_launches}")
    print(f"wide cli --export_path (in process): {export_s:.1f} s; "
          f"ServingModel on the card, batch 3, {served_launches} launches: "
          f"{answer.tolist()}")
    del served

    # 2. tinycnn inside the multimodal blend model, then --inference with
    # Grad-CAM (conv5 is its target; it has no bottleneck)
    cfg_path = config("tinycnn", "tinycnn")
    run_dir = workdir / "run_tinycnn"
    run_dir.mkdir()
    out = run_dir / "out"
    rc, wall, launches = run_cli(fd, [
        "--images", "--preop", "--survival", "--blend", "--split",
        "--config", str(cfg_path), "--epochs", "1", "--output_path",
        str(out)], run_dir, [])
    if rc != 0 or launches != 0:
        raise AssertionError(f"tinycnn CLI run: rc {rc}, {launches} "
                             "launches")
    trained = uid_files(cfg_path, run_dir, out / "best_surv_model.npz")
    test_uids = (run_dir / "test_uids.txt").read_text().split()
    infer_out = workdir / "infer_tinycnn"
    counts = {}
    rc, infer_wall, _ = run_cli(fd, [
        "--inference", "--images", "--preop", "--survival", "--blend",
        "--config", str(trained), "--output_path", str(infer_out)], run_dir,
        [mock.patch.object(infer_run, "export_attention_maps", counted(
            infer_run.export_attention_maps, counts, "export"))])
    dirs = sorted(os.listdir(infer_out / "attention_maps"))
    if rc != 0 or dirs != sorted(f"_patient_{u}" for u in test_uids):
        raise AssertionError(f"tinycnn inference: rc {rc}, {dirs}")
    peaks = []
    for d in dirs:
        for name in ("att_map", "att_map_cls1"):
            vol = load_nifti(str(infer_out / "attention_maps" / d /
                                 f"{name}.nii.gz"))
            if not (vol.shape == (CLI_SIDE,) * 3 and vol.min() >= 0.0
                    and vol.max() <= 1.0):
                raise AssertionError(f"tinycnn {d}/{name}: {vol.shape}, "
                                     f"range [{vol.min()}, {vol.max()}]")
            peaks.append(vol.max())
    print(f"tinycnn cli --images --preop --survival --blend, 1 epoch: "
          f"{wall:.1f} s, 0 launches; --inference with Grad-CAM on "
          f"{len(test_uids)} test patients: {infer_wall:.1f} s (export "
          f"{counts['export_s'][0]:.2f} s), att_map peaks "
          f"{min(peaks):.3f}..{max(peaks):.3f}")

    # 3. the LR range test on the flagship model
    run_dir = workdir / "run_lr"
    run_dir.mkdir()
    sweeps = []
    rc, wall, launches = run_cli(fd, [
        "--lr_finder", "--images", "--preop", "--survival", "--split",
        "--config", str(workdir / "config.json"), "--output_path",
        str(run_dir / "out")], run_dir,
        [mock.patch.object(lr_finder, "find_lr", recorded(lr_finder.find_lr,
                                                          sweeps))])
    lrs, losses = sweeps[0][2]
    flagship = sum(build_model(parse_config(str(workdir / "config.json")),
                               True, True, False, False)
                   .image_model.block_config)
    best_lr = lrs[int(np.nanargmin(losses))]
    png = (run_dir / "lr_finder.png").exists()
    if rc != 0 or len(lrs) != LR_SWEEP_STEPS or len(losses) != LR_SWEEP_STEPS \
            or np.float32(lrs[0]) != np.float32(1e-7) \
            or not np.isfinite(best_lr) \
            or launches != LR_SWEEP_STEPS * flagship \
            or png != bool(importlib.util.find_spec("matplotlib")):
        raise AssertionError(f"--lr_finder: rc {rc}, {len(lrs)} rates from "
                             f"{lrs[:1]}, {len(losses)} losses, min-loss lr "
                             f"{best_lr}, {launches} launches, png {png}")
    finite = int(np.isfinite(losses).sum())
    print(f"cli --lr_finder --images --preop --survival ({CLI_MODEL}): rc "
          f"{rc}, {wall:.1f} s; {len(lrs)} steps from lr {lrs[0]:.3e} to "
          f"{lrs[-1]:.3e}, {launches} launches ({flagship} a step); "
          f"{finite} finite smoothed losses, min-loss lr {best_lr:.3e}; "
          f"lr_finder.png written: {png}")
    return {"launches": wide_launches, "per_forward": per_forward,
            "served": served_launches, "lr_finder": launches}



def dicom_element(group: int, element: int, vr: bytes, value: bytes) -> bytes:
    """One explicit VR little endian data element (even length)."""
    import struct

    if len(value) % 2:
        value += b"\x00" if vr in (b"OB", b"UI") else b" "
    if vr in (b"OB", b"OW", b"UN", b"SQ"):
        return struct.pack("<HH2sHI", group, element, vr, 0, len(value)) \
            + value
    return struct.pack("<HH2sH", group, element, vr, len(value)) + value


def write_dicom(path: Path, syntax: str, pixels: np.ndarray, z: float,
                instance: int = 1, streams=None, grid_offsets=None):
    """A .dcm file of ``pixels`` ((rows, cols), or (frames, rows, cols) for
    a multiframe file) as unsigned 12-bit samples in 16-bit words, with its
    geometry (position (0, 0, z), axis-aligned orientation, 1 x 1 mm
    pixels, 2 mm between slices or ``grid_offsets``): uncompressed in
    explicit VR little endian, or ``streams`` (one compressed frame each)
    encapsulated under the transfer syntax ``syntax``."""
    import struct

    frames = pixels.shape[0] if pixels.ndim == 3 else 1
    rows, cols = pixels.shape[-2:]
    ts = syntax.encode()
    parts = [b"\x00" * 128, b"DICM",
             dicom_element(0x0002, 0x0010, b"UI", ts)]
    us = lambda v: struct.pack("<H", v)  # noqa: E731
    parts += [
        dicom_element(0x0018, 0x0088, b"DS", b"2.0"),
        dicom_element(0x0020, 0x0013, b"IS", str(instance).encode()),
        dicom_element(0x0020, 0x0032, b"DS", f"0\\0\\{z}".encode()),
        dicom_element(0x0020, 0x0037, b"DS", b"1\\0\\0\\0\\1\\0"),
        dicom_element(0x0028, 0x0002, b"US", us(1)),
    ]
    if frames > 1:
        parts.append(dicom_element(0x0028, 0x0008, b"IS",
                                   str(frames).encode()))
    parts += [
        dicom_element(0x0028, 0x0010, b"US", us(rows)),
        dicom_element(0x0028, 0x0011, b"US", us(cols)),
        dicom_element(0x0028, 0x0030, b"DS", b"1.0\\1.0"),
        dicom_element(0x0028, 0x0100, b"US", us(16)),
        dicom_element(0x0028, 0x0101, b"US", us(12)),
        dicom_element(0x0028, 0x0103, b"US", us(0)),
    ]
    if grid_offsets is not None:
        parts.append(dicom_element(0x3004, 0x000C, b"DS", "\\".join(
            f"{o:g}" for o in grid_offsets).encode()))
    if streams is None:
        parts.append(dicom_element(0x7FE0, 0x0010, b"OW",
                                   pixels.astype("<u2").tobytes()))
    else:
        parts.append(struct.pack("<HH2sHI", 0x7FE0, 0x0010, b"OB", 0,
                                 0xFFFFFFFF))
        parts.append(struct.pack("<HHI", 0xFFFE, 0xE000, 0))  # empty BOT
        for st in streams:
            st += b"\x00" if len(st) % 2 else b""
            parts.append(struct.pack("<HHI", 0xFFFE, 0xE000, len(st)) + st)
        parts.append(struct.pack("<HHI", 0xFFFE, 0xE0DD, 0))
    path.write_bytes(b"".join(parts))


def encode_frame(kind: str, frame: np.ndarray) -> bytes:
    """One 12-bit frame through the port's encoder of ``kind`` (run in the
    writer's worker processes)."""
    from mmnn_sts_torch.data import (dicom_rle, jpeg2000, jpeg_lossless,
                                     jpeg_ls)

    if kind == "rle":
        return dicom_rle.encode_rle_frame(frame.astype(np.uint16), 16)
    if kind == "jpeg_lossless":
        return jpeg_lossless.encode_jpeg_lossless_sv1(frame, 16)
    if kind == "jpeg_ls":
        return jpeg_ls.encode_jpeg_ls(frame, 12)
    return jpeg2000.encode_j2k(frame, 12)


def python_decoded(path: str) -> np.ndarray:
    """A .dcm file's pixels decoded with the C++ frame decoders patched out,
    so that every frame goes through the port's pure-Python codec (run in
    the writer's worker processes)."""
    from mmnn_sts_torch.data import dicom, native

    with mock.patch.object(native, "jpeg_ls_decode_native",
                           lambda *a: None), \
            mock.patch.object(native, "jpeg_lossless_decode_native",
                              lambda *a: None), \
            mock.patch.object(native, "j2k_decode_native", lambda *a: None):
        return dicom.load_dicom_series(path)


def process_pool():
    """Worker processes for the pure-Python codecs (spawned: the parent
    holds the card), one a core up to 8."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    return ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                               mp_context=multiprocessing.get_context("spawn"))


def write_dicom_cohort(root: Path, cohort: Path, seed: int) -> dict:
    """The CLI phase's first DICOM_PATIENTS patients (its key and clinical
    table) as a DICOM tree: root/{t1,t2}/<anon>/image/s###.dcm (one slice
    each of a CLI_VOLUME volume: squared normals x 500 as 12-bit samples) and
    root/{t1,t2}/<anon>/mask/mask.dcm (a multiframe 0/255 box on the same
    grid). The first patients of the key take DICOM_COMPRESSED's syntaxes,
    one each, in the modalities listed; their frames are encoded by the
    port's encoders in worker processes. Returns {(kind, modality): image
    directory} of the compressed series."""
    import csv

    from mmnn_sts_torch.data import dicom

    syntaxes = {"rle": dicom.RLE_LOSSLESS,
                "jpeg_lossless": dicom.JPEG_LOSSLESS_SV1,
                "jpeg_ls": dicom.JPEG_LS_LOSSLESS, "j2k": dicom.J2K_LOSSLESS}
    with open(cohort / "key.csv", newline="") as f:
        anon = [row[0] for row in list(csv.reader(f))[1:]][:DICOM_PATIENTS]
    rng = np.random.default_rng(seed)
    mask = np.zeros(CLI_VOLUME, np.uint16)
    mask[8:-8, 8:-8, 6:-6] = 255
    offsets = [2.0 * k for k in range(CLI_VOLUME[0])]
    compressed = {(kind, m): anon[i]
                  for i, (kind, modalities) in enumerate(DICOM_COMPRESSED)
                  for m in modalities}
    jobs, out = [], {}
    with process_pool() as pool:
        for modality in ("t1", "t2"):
            for a in anon:
                image_dir = root / modality / a / "image"
                image_dir.mkdir(parents=True)
                (root / modality / a / "mask").mkdir()
                vol = np.clip(rng.normal(size=CLI_VOLUME) ** 2 * 500, 0,
                              4095).astype(np.uint16)
                write_dicom(root / modality / a / "mask" / "mask.dcm",
                            dicom.EXPLICIT_LE, mask, 0.0,
                            grid_offsets=offsets)
                kind = next((k for (k, m), who in compressed.items()
                             if m == modality and who == a), None)
                if kind is not None:
                    out[(kind, modality)] = image_dir
                for k in range(CLI_VOLUME[0]):
                    path = image_dir / f"s{k:03d}.dcm"
                    if kind is None:
                        write_dicom(path, dicom.EXPLICIT_LE, vol[k], 2.0 * k,
                                    k + 1)
                    else:
                        jobs.append((path, syntaxes[kind], vol[k], 2.0 * k,
                                     k + 1, pool.submit(encode_frame, kind,
                                                        vol[k])))
        for path, syntax, frame, z, instance, job in jobs:
            write_dicom(path, syntax, frame, z, instance,
                        streams=[job.result()])
    return out


def dicom_cli_phase(fd, seed: int, workdir: Path) -> dict:
    """The flagship survival run through the CLI from a DICOM cohort at full
    width, then its --inference (see the module docstring, phase 16).
    Returns its launches and seconds."""
    from mmnn_sts_torch import pipeline
    from mmnn_sts_torch.config import parse_config
    from mmnn_sts_torch.data import dicom, native
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.train import checkpoint, evaluate, loop

    cohort = workdir / "cohort"
    root = workdir / "dicom_cohort"
    t0 = time.perf_counter()
    series = write_dicom_cohort(root, cohort, seed + 10)
    write_s = time.perf_counter() - t0
    print(f"dicom cohort written ({DICOM_PATIENTS} patients x 2 modalities, "
          f"{CLI_VOLUME[0]} slices of {CLI_VOLUME[1:]} each and a multiframe "
          f"mask; compressed: {sorted(series)}): {write_s:.1f} s")
    base = json.loads((workdir / "config.json").read_text())
    base["Data"].update(image_loc=str(root), image_format="dicom")
    config_path = workdir / "dicom.json"
    config_path.write_text(json.dumps(base))
    run_dir, out = workdir / "dicom_run", workdir / "dicom_run" / "out"
    run_dir.mkdir()
    per_forward = sum(build_model(parse_config(str(config_path)), True, True,
                                  False, True).image_model.block_config)

    counts = {}
    native.reset_counts()
    rc, wall, launches = run_cli(fd, [
        "--images", "--preop", "--survival", "--blend", "--split",
        "--config", str(config_path), "--epochs", str(DICOM_EPOCHS),
        "--blend_update_interval", "1", "--output_path", str(out)], run_dir, [
            mock.patch.object(pipeline, "load_cohort", counted(
                pipeline.load_cohort, counts, "cohort")),
            mock.patch.object(loop, "survival_train_superstep", counted(
                loop.survival_train_superstep, counts, "supersteps")),
            mock.patch.object(evaluate, "survival_eval_step", counted(
                evaluate.survival_eval_step, counts, "val_forwards"))])
    frames = dict(native.counts)
    cohort_s = counts.get("cohort_s", [float("nan")])[0]
    rows = [json.loads(x) for x in (out / "metrics.jsonl").read_text()
            .splitlines()] if rc == 0 else []
    expected = (counts.get("supersteps", 0) * TRAIN_MICRO
                + counts.get("val_forwards", 0)) * per_forward
    if rc != 0 or launches != expected or len(rows) != DICOM_EPOCHS \
            or not all(np.isfinite([r["train_loss"], r["val_loss"]]).all()
                       and 0.0 <= r["train_c"] <= 1.0
                       and 0.0 <= r["val_c"] <= 1.0 for r in rows):
        raise AssertionError(f"dicom CLI run: rc {rc}, {launches} launches "
                             f"(expected {expected}), rows {rows}")
    fresh = build_model(parse_config(str(config_path)), True, True, False,
                        True)
    checkpoint.load_params_npz(str(out / "best_surv_model.npz"), fresh)
    want = {f"{kind}_frames": CLI_VOLUME[0] * sum(
        1 for k, _ in series if k == kind)
        for kind in ("jpeg_ls", "jpeg_lossless", "j2k")}
    if any(frames[k] != v for k, v in want.items()) \
            or frames["frame_fallbacks"] != 0:
        raise AssertionError(f"C++ frame decoders: {frames}, expected "
                             f"{want} and no fallback")
    # each compressed series through the C++ decoders (as the cohort build
    # read it) against the port's pure-Python decoders, bit for bit
    t0 = time.perf_counter()
    with process_pool() as pool:
        checks = {key: pool.map(python_decoded, sorted(
            str(p) for p in image_dir.iterdir()))
            for key, image_dir in series.items()}
        for key, slices in checks.items():
            fast = dicom.load_dicom_series(str(series[key]))
            slow = np.concatenate(list(slices))
            if fast.dtype != slow.dtype or not np.array_equal(fast, slow):
                raise AssertionError(f"{key}: the C++ decode differs from "
                                     f"the Python decode")
    check_s = time.perf_counter() - t0
    print(f"dicom cli run (image_format dicom): rc {rc}, {wall:.1f} s; "
          f"cohort build (load_cohort) {cohort_s:.1f} s; "
          f"{counts['supersteps']} supersteps, {counts['val_forwards']} "
          f"validation forwards; kernel launches {launches} = {expected} "
          f"expected; C++ frames {want} and 0 fallbacks; the compressed "
          f"series equal their pure-Python decodes bit for bit "
          f"({check_s:.1f} s in worker processes)")
    for r in rows:
        print(f"  epoch {r['epoch']}: {r['epoch_seconds']:.2f} s, "
              f"{r['samples_per_sec']:.1f} samples/s, train loss "
              f"{r['train_loss']:.4f}, val loss {r['val_loss']:.4f}, train C "
              f"{r['train_c']:.3f}, val C {r['val_c']:.3f}")

    base["Hyperparameters"]["model_weights"] = str(
        out / "best_surv_model.npz")
    base["Preprocessing"] = {f"{s}_uid_location": str(run_dir /
                                                      f"{s}_uids.txt")
                             for s in ("train", "val", "test")}
    infer_config = workdir / "dicom_infer.json"
    infer_config.write_text(json.dumps(base))
    infer_out = workdir / "dicom_infer"
    counts = {}
    rc, infer_wall, infer_launches = run_cli(fd, [
        "--inference", "--images", "--preop", "--survival", "--blend",
        "--no_gradcam", "--config", str(infer_config), "--output_path",
        str(infer_out)], run_dir, [
            mock.patch.object(evaluate, "survival_eval_step", counted(
                evaluate.survival_eval_step, counts, "eval_steps"))])
    test_uids = (run_dir / "test_uids.txt").read_text().split()
    header, preds = (read_csv_rows(infer_out / "survival_model_predictions.csv")
                     if rc == 0 else ("", np.zeros((0, 7))))
    if rc != 0 or infer_launches != per_forward * counts.get("eval_steps", 0) \
            or preds.shape != (len(test_uids), 7) \
            or not np.isfinite(preds).all():
        raise AssertionError(f"dicom --inference: rc {rc}, {infer_launches} "
                             f"launches, predictions {preds.shape}")
    print(f"dicom cli --inference --survival --no_gradcam: rc {rc}, "
          f"{infer_wall:.1f} s for {len(test_uids)} test patients, "
          f"{infer_launches} launches")
    return {"launches": launches, "write_s": write_s, "cohort_s": cohort_s,
            "root": root}



class FakeS3:
    """A stand-in for boto3 (not installed on the card's machine), backed by
    a local directory: ``resource("s3").Bucket(b)`` is ``root/b``, with the
    calls utils/store.py makes (``Object(key).download_fileobj``,
    ``download_file``, ``objects.filter(Prefix=)``, ``upload_file``, whose
    keys are logged in ``uploads``). A stub for this script, not a
    feature."""

    class _Object:
        def __init__(self, path: Path, key: str):
            self.path, self.key = path, key

        def download_fileobj(self, f):
            f.write(self.path.read_bytes())

    class _Bucket:
        def __init__(self, fake, name: str):
            self.root, self.name, self.fake = fake.root / name, name, fake
            self.objects = self

        def Object(self, key):  # noqa: N802 (boto3's name)
            return FakeS3._Object(self.root / key, key)

        def filter(self, Prefix=""):  # noqa: N803
            keys = sorted(p.relative_to(self.root).as_posix()
                          for p in self.root.rglob("*") if p.is_file())
            return [FakeS3._Object(self.root / k, k) for k in keys
                    if k.startswith(Prefix)]

        def download_file(self, key, path):
            shutil.copyfile(self.root / key, path)

        def upload_file(self, local, key):
            (self.root / key).parent.mkdir(parents=True, exist_ok=True)
            shutil.copyfile(local, self.root / key)
            self.fake.uploads.append((self.name, key))

    def __init__(self, root: Path):
        self.root, self.uploads = root, []

    def resource(self, kind):
        assert kind == "s3"
        return self

    def Bucket(self, name):  # noqa: N802
        return FakeS3._Bucket(self, name)


def s3_cli_phase(fd, seed: int, workdir: Path, dicom_root: Path) -> dict:
    """The flagship survival run from s3:// paths through a stubbed boto3,
    its artifacts uploaded, and the s3:// DICOM manifest against the local
    one (see the module docstring, phase 17)."""
    from mmnn_sts_torch import pipeline
    from mmnn_sts_torch.config import parse_config
    from mmnn_sts_torch.data import images
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.train import checkpoint, evaluate, loop
    from mmnn_sts_torch.utils import store

    fake = FakeS3(workdir / "s3")
    bucket = fake.root / S3_BUCKET
    # the bucket's objects are hard links to the local trees (a fetch
    # copies them, as a download writes a new file)
    t0 = time.perf_counter()
    shutil.copytree(workdir / "cohort", bucket / "cohort",
                    copy_function=os.link)
    (bucket / "splits").mkdir()
    for name in ("train", "val", "test"):
        shutil.copyfile(workdir / "run" / f"{name}_uids.txt",
                        bucket / "splits" / f"{name}.txt")
    # the DICOM manifest's check takes S3_DICOM_PATIENTS of the T1 tree's
    # patients, in the bucket and in a local tree of the same patients
    subset = workdir / "dicom_subset" / "t1"
    for patient in sorted(p.name for p in (dicom_root / "t1").iterdir())[
            :S3_DICOM_PATIENTS]:
        for tree in (bucket / "dicom" / "t1", subset):
            shutil.copytree(dicom_root / "t1" / patient, tree / patient,
                            copy_function=os.link)
    copy_s = time.perf_counter() - t0
    base = json.loads((workdir / "config.json").read_text())
    uri = f"s3://{S3_BUCKET}"
    base["Data"] = {"data_loc": f"{uri}/cohort/clinical.csv",
                    "key_loc": f"{uri}/cohort/key.csv",
                    "image_loc": f"{uri}/cohort", "bucket": S3_ARTIFACTS}
    base["Preprocessing"] = {"output_dir": S3_PREFIX, **{
        f"{s}_uid_location": f"{uri}/splits/{s}.txt"
        for s in ("train", "val", "test")}}
    config_path = workdir / "s3.json"
    config_path.write_text(json.dumps(base))
    run_dir, out = workdir / "s3_run", workdir / "s3_run" / "out"
    run_dir.mkdir()
    per_forward = sum(build_model(parse_config(str(config_path)), True, True,
                                  False, True).image_model.block_config)

    def stub():
        """boto3 replaced by the stub, in sys.modules and in the store."""
        return [mock.patch.dict(sys.modules, {"boto3": fake}),
                mock.patch.object(store, "boto3", fake),
                mock.patch.object(store, "HAVE_BOTO3", True)]

    counts = {}
    rc, wall, launches = run_cli(fd, [
        "--images", "--preop", "--survival", "--blend", "--config",
        str(config_path), "--epochs", str(S3_EPOCHS), "--output_path",
        str(out)], run_dir, stub() + [
            mock.patch.object(pipeline, "load_cohort", counted(
                pipeline.load_cohort, counts, "cohort")),
            mock.patch.object(loop, "survival_train_superstep", counted(
                loop.survival_train_superstep, counts, "supersteps")),
            mock.patch.object(evaluate, "survival_eval_step", counted(
                evaluate.survival_eval_step, counts, "val_forwards"))])
    expected = (counts.get("supersteps", 0) * TRAIN_MICRO
                + counts.get("val_forwards", 0)) * per_forward
    rows = [json.loads(x) for x in (out / "metrics.jsonl").read_text()
            .splitlines()] if rc == 0 else []
    uploaded = [k for b, k in fake.uploads if b == S3_ARTIFACTS]
    want = [f"{S3_PREFIX}/{dest}" for local, dest in
            store.train_artifact_names(True, True) if (out / local).exists()]
    if rc != 0 or launches != expected or len(rows) != S3_EPOCHS \
            or not np.isfinite([rows[0]["train_loss"],
                                rows[0]["val_loss"]]).all() \
            or uploaded != want or f"{S3_PREFIX}/model.npz" not in uploaded:
        raise AssertionError(f"s3:// CLI run: rc {rc}, {launches} launches "
                             f"(expected {expected}), rows {rows}, uploaded "
                             f"{uploaded}, expected {want}")
    blob = fake.root / S3_ARTIFACTS / S3_PREFIX / "model.npz"
    if blob.read_bytes() != (out / "best_surv_model.npz").read_bytes():
        raise AssertionError("the uploaded model.npz differs")
    print(f"s3 cli run (every path s3://, boto3 stubbed): rc {rc}, "
          f"{wall:.1f} s ({copy_s:.1f} s linking the cohorts into the "
          f"stub's bucket before it); cohort build (load_cohort, fetching "
          f"every object) {counts['cohort_s'][0]:.1f} s; "
          f"{counts['supersteps']} supersteps, {launches} launches = "
          f"{expected} expected; uploaded {uploaded}")

    key = str(workdir / "cohort" / "key.csv")
    t0 = time.perf_counter()
    patches = stub()
    for p in patches:
        p.start()
    try:
        remote = images.build_manifest_dicom_s3(f"{uri}/dicom/t1/", key)
    finally:
        for p in reversed(patches):
            p.stop()
    manifest_s = time.perf_counter() - t0
    local = images.build_manifest_dicom(str(subset), key)
    same = [(r.anon_id, r.uid, r.format) for r in remote] \
        == [(r.anon_id, r.uid, r.format) for r in local]
    for r, want_r in zip(remote, local):
        for part in ("image_path", "mask_path"):
            a, b = Path(getattr(r, part)), Path(getattr(want_r, part))
            names = sorted(os.listdir(a))
            same = same and names == sorted(os.listdir(b)) and all(
                (a / n).read_bytes() == (b / n).read_bytes() for n in names)
    if not same or len(remote) != S3_DICOM_PATIENTS:
        raise AssertionError(f"build_manifest_dicom_s3 gave {len(remote)} "
                             "records unlike the local manifest's")
    shutil.rmtree(Path(remote[0].image_path).parents[1], ignore_errors=True)
    print(f"s3 dicom manifest (build_manifest_dicom_s3 over a copy of "
          f"{S3_DICOM_PATIENTS} patients of the T1 tree): {len(remote)} "
          f"records equal to build_manifest_dicom's "
          f"(anon ids, uids, every fetched file's bytes), {manifest_s:.1f} s")
    return {"launches": launches, "uploaded": uploaded}


def group_diffs(got: dict, want: dict) -> tuple[int, dict]:
    """(bit-equal tensors, {group: the largest |got - want| / max(1,
    |want|)}) of two same-keyed dicts; a group is a key's first word
    (losses, preds, param, buffer, momentum, generator, step)."""
    equal, worst = 0, {}
    for name, w in want.items():
        group = name.split()[0]
        g = got[name]
        worst.setdefault(group, 0.0)
        if torch.equal(g, w):
            equal += 1
            continue
        rel = ((g.float() - w.float()).abs().max().item()
               / max(1.0, w.float().abs().max().item()))
        worst[group] = max(worst[group], rel if rel == rel else np.inf)
    return equal, worst


def beyond_tolerance(got: dict, want: dict) -> list:
    """The tensors of two ``state_tensors`` dicts further apart than
    FUSED_TOLERANCE x max(1, |want|), the worst first, with their
    distances; the generator's state and the step must be equal."""
    bad = []
    for name, w in want.items():
        g = got[name]
        if torch.equal(g, w):
            continue
        d = group_diffs({name: g}, {name: w})[1][name.split()[0]]
        if not d <= (0.0 if name in ("generator", "step")
                     else FUSED_TOLERANCE):
            bad.append((d, name))
    return sorted(bad, reverse=True)


def state_tensors(state, losses, preds) -> dict:
    """What a training run leaves: its losses and predictions, every
    parameter, running statistic and momentum buffer, the generator's
    state and the step."""
    out = {"losses": losses, "preds": preds,
           "generator": state.generator.get_state(),
           "step": torch.tensor(state.step)}
    out.update({f"param {n}": p.detach() for n, p in
                state.model.named_parameters()})
    out.update({f"buffer {n}": b for n, b in state.model.named_buffers()})
    out.update({f"momentum {i}": b for i, b in
                enumerate(state.momentum_buffers())})
    return out


def fused_epoch_phase(fd, seed: int) -> dict:
    """TPU.fused_epoch's supersteps on the card (see the module docstring,
    phase 10): graphed against eager from the same state, in float32 and
    bfloat16 with the augmentation and with remat. Returns the launches
    per capture, volumes/s and the rest by run."""
    import gc

    from mmnn_sts_torch.config import Config
    from mmnn_sts_torch.convert import load_jax_npz, to_jax_flat
    from mmnn_sts_torch.data.loader import DeviceDataset, gather_superbatch
    from mmnn_sts_torch.infer.export import model_spec
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.train import graphs
    from mmnn_sts_torch.train.schedule import make_optimizer
    from mmnn_sts_torch.train.state import create_train_state
    from mmnn_sts_torch.train.steps import (
        survival_train_epoch, survival_train_superstep)
    from torch.profiler import ProfilerActivity, profile

    flags = dict(images=True, preop=True, postop=False, blend=True)
    base = Config()  # densenet121, 64^3 x 2ch, dropout 0.2, 11 preop
    base.image_model.name = CLI_MODEL
    base.image_model.spatial_size = [CLI_SIDE] * 3
    spec = model_spec(base, **flags)
    model = build_model(base, **flags)
    per_forward = sum(model.image_model.block_config)  # 58 in DenseNet121
    weights = random_flat_weights(model, seed, to_jax_flat)
    rng = np.random.default_rng(seed + 6)
    inputs, events, durations = synthetic_split(rng, (FUSED_SPLIT,), spec,
                                                CLI_DEVICE)
    ds = DeviceDataset(uids=np.arange(FUSED_SPLIT), inputs=inputs,
                       events=events, durations=durations)
    timed = FUSED_STEPS * FUSED_TIMED_EPOCHS
    rows = FUSED_STEPS + timed + 1  # compared, timed, profiled
    idx = np.stack([rng.permutation(FUSED_SPLIT)[:TRAIN_MICRO * TRAIN_BATCH]
                    .reshape(TRAIN_MICRO, TRAIN_BATCH) for _ in range(rows)])
    volumes = TRAIN_MICRO * TRAIN_BATCH
    # cuDNN's default weight gradients add with atomics: two eager runs of
    # one superstep would differ in their last bits
    cudnn = torch.backends.cudnn
    tf32, deterministic = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32, cudnn.deterministic = False, True
    print(f"fused epoch: superstep {TRAIN_MICRO} x {TRAIN_BATCH} at "
          f"{base.image_model.spatial_size[0]}^3 from a resident split of "
          f"{FUSED_SPLIT} volumes, dropout {base.image_model.dropout_prob}, "
          f"cudnn.allow_tf32={cudnn.allow_tf32} "
          f"cudnn.deterministic={cudnn.deterministic}; graphed "
          f"(survival_train_epoch, one superstep a call) against eager "
          f"(survival_train_superstep) run {FUSED_EAGER} times in "
          f"{FUSED_RUNS[0][0]} (the first held against, the second the "
          f"control) and once in the others, each set to the graphed state "
          f"before each superstep")

    def new_state(cfg):
        model = build_model(cfg, **flags)
        load_jax_npz(model, weights)
        model.to(CLI_DEVICE)
        state = create_train_state(model, *make_optimizer(
            model.parameters(), TRAIN_LR, rows, 1), seed=seed)
        # every superstep's rate: a grown table is bound again
        state.ensure_rates(rows)
        return state

    def set_to(dst, src):
        """``dst`` takes ``src``'s weights, statistics, momentum,
        generator state and step, in place."""
        dst.model.load_state_dict(src.model.state_dict())
        for a, b in zip(dst.momentum_buffers(), src.momentum_buffers()):
            a.copy_(b)
        dst.generator.set_state(src.generator.get_state())
        dst.step = src.step

    def eager_step(state, s, augment):
        batch = gather_superbatch(ds, idx[s])
        return survival_train_superstep(
            state, batch["inputs"], batch["events"], batch["durations"],
            blend=True, augment=augment)

    replays = []
    real_run = graphs.BoundBody.run

    def timed_run(self):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_run(self)
        end.record()
        if self.last == "replay":
            replays.append((start, end))
        return out

    def rate(pairs):
        torch.cuda.synchronize()
        ms = np.array([a.elapsed_time(b) for a, b in pairs])
        return float(np.median(volumes * 1e3 / ms)), float(np.median(ms))

    def epoch(state, s, augment):
        return survival_train_epoch(state, ds, idx[s:s + 1], blend=True,
                                    augment=augment)

    results = {}
    for name, dtype, remat, augment in FUSED_RUNS:
        cfg = copy.deepcopy(base)
        cfg.tpu.compute_dtype = dtype
        cfg.tpu.remat = remat
        # eager alone: one superstep, the peak of the caching allocator's
        # reserved memory (a graph's private pool is reserved, and not
        # allocated between replays)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        eager = new_state(cfg)
        eager_step(eager, 0, augment)
        torch.cuda.synchronize()
        eager_peak = torch.cuda.max_memory_reserved()
        del eager
        gc.collect()
        torch.cuda.empty_cache()

        # graphed against eager, superstep by superstep from one state: the
        # first superstep is the warm-up, the second is captured and
        # replayed, the rest are replays
        # eager[0] is held against; eager[1] is the control
        # the control runs with the first configuration only
        n_eager = FUSED_EAGER if name == FUSED_RUNS[0][0] else 1
        graphed, *eager = (new_state(cfg) for _ in range(1 + n_eager))
        worst, noise, bad, equal, total, pairs = {}, {}, [], 0, 0, []
        fd.fused_bn_relu_matmul.launches = 0
        with mock.patch.object(graphs.BoundBody, "run", timed_run):
            for s in range(FUSED_STEPS):
                for other in eager:
                    set_to(other, graphed)
                out = epoch(graphed, s, augment)
                runs = []
                for st in eager:
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    aux = eager_step(st, s, augment)
                    end.record()
                    pairs.append((start, end))
                    runs.append(state_tensors(st, aux["loss"][None],
                                              aux["preds"][None]))
                got = state_tensors(graphed, out["loss"], out["preds"])
                same, diffs = group_diffs(got, runs[0])
                equal, total = equal + same, total + len(got)
                worst = {g: max(worst.get(g, 0.0), d)
                         for g, d in diffs.items()}
                bad += [(d, f"superstep {s} {n}")
                        for d, n in beyond_tolerance(got, runs[0])]
                for run in runs[1:]:
                    noise = {g: max(noise.get(g, 0.0), d)
                             for g, d in group_diffs(run, runs[0])[1].items()}
            del eager, runs, got, out
            eager_rate = rate(pairs)
            gc.collect()
            torch.cuda.empty_cache()
            (steps,) = (v for v in graphed.graphs.values()
                        if isinstance(v, graphs.EpochSteps))
            step = steps.graphs["step"]
            per_capture = step.launches_per_capture
            # remat runs each wrapped bottleneck's forward again, all but
            # the Grad-CAM target's
            expected = TRAIN_MICRO * (2 * per_forward - 1 if remat
                                      else per_forward)
            if CLI_DEVICE != "cuda":  # nothing is captured on the CPU
                per_capture = expected
            if bad or per_capture != expected or step.binds != 1:
                raise AssertionError(
                    f"fused epoch {name}: graphed vs eager {worst}, eager vs "
                    f"eager {noise}; {len(bad)} tensors beyond "
                    f"{FUSED_TOLERANCE:.0e} x max(1, |eager|), the worst "
                    f"{bad[:12]}; {per_capture} launches per capture "
                    f"({expected} expected); bound {step.binds} times "
                    f"(once expected)")
            # the replays alone: timed, the reserved memory, one profiled
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            del replays[:]
            for s in range(FUSED_STEPS, FUSED_STEPS + timed):
                epoch(graphed, s, augment)
            graph_rate = rate(replays)
            graph_peak = torch.cuda.max_memory_reserved()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                epoch(graphed, rows - 1, augment)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
        kinds = kernel_kinds(prof, wall, f"fused epoch {name}: one graphed "
                             f"superstep", top=5)
        results[name] = {
            "launches_per_capture": per_capture,
            "replays": step.replays, "binds": step.binds,
            "capture_s": step.capture_seconds,
            "eager_volumes_s": eager_rate[0], "eager_ms": eager_rate[1],
            "graphed_volumes_s": graph_rate[0], "graphed_ms": graph_rate[1],
            "eager_peak_gib": eager_peak / 2**30,
            "graphed_peak_gib": graph_peak / 2**30,
            "busy": kinds["busy"] / wall, "max_rel_diff": max(worst.values()),
            "fused_kernel_ms": kinds.get("fused_bn_relu_matmul kernel", 0.0),
            "control_max_rel_diff": max(noise.values(), default=None)}
        r = results[name]
        print(f"fused epoch {name}: {FUSED_STEPS} supersteps (the warm-up, "
              f"the capture, a replay), each from the graphed state: "
              f"{equal} of {total} tensors (losses, predictions, parameters, "
              f"running statistics, momentum, the generator's state, the "
              f"step) bit-equal to the first eager run; the largest "
              f"|graphed - eager| / max(1, |eager|) by group "
              + ", ".join(f"{g} {d:.2e}" for g, d in worst.items())
              + "; the control (the second eager run vs the first) "
              + (", ".join(f"{g} {d:.2e}" for g, d in noise.items())
                 or "not run for this configuration")
              + f" (limit {FUSED_TOLERANCE:.0e}, the generator and step "
              f"equal); fused kernel launches {per_capture} per capture of "
              f"the superstep, {step.replays} replays; capture "
              f"{r['capture_s']:.2f} s; eager {r['eager_volumes_s']:.1f} "
              f"volumes/s ({r['eager_ms']:.1f} ms, median of {len(pairs)} "
              f"eager supersteps above), "
              f"graphed {r['graphed_volumes_s']:.1f} volumes/s "
              f"({r['graphed_ms']:.1f} ms, median of {timed} replays); "
              f"max_memory_reserved eager {r['eager_peak_gib']:.2f} GiB, "
              f"graphed {r['graphed_peak_gib']:.2f} GiB (the state, the split "
              f"and the graph's pool); graphed busy "
              f"{r['busy']:.1%}")
        del graphed, steps, step, prof
        gc.collect()
        torch.cuda.empty_cache()
    cudnn.allow_tf32, cudnn.deterministic = tf32, deterministic
    return results


def stamp_phase(fd, seed: int) -> dict:
    """The device phase stamps on the card (see the module docstring, phase
    22): the stamp kernel alone at the flagship's row width, then graphed
    flagship supersteps in float32 and bfloat16, each replay's stamped span
    against CUDA events. Returns the launches and the largest gaps."""
    import gc

    from mmnn_sts_torch.config import Config
    from mmnn_sts_torch.convert import load_jax_npz, to_jax_flat
    from mmnn_sts_torch.data.loader import DeviceDataset
    from mmnn_sts_torch.infer.export import model_spec
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.train import graphs
    from mmnn_sts_torch.train.schedule import make_optimizer
    from mmnn_sts_torch.train.state import create_train_state
    from mmnn_sts_torch.train.steps import stamp_width, survival_train_epoch
    from mmnn_sts_torch.utils import tracing

    width = stamp_width(TRAIN_MICRO)
    marks = width - 1  # no collective without a mesh: 4 + 3A stamps
    # (a) the kernel alone: STAMP_ROWS rows between two guard rows, every
    # cell -1; each slot stamps all `width` marks of its row
    guarded = torch.full((STAMP_ROWS + 2, width), -1, dtype=torch.int64,
                         device=CLI_DEVICE)
    buf = guarded[1:-1]
    tracing.span_stamp.launches = 0
    for row in STAMP_SLOTS:
        guarded.fill_(-1)
        slot = torch.tensor([row], dtype=torch.int64, device=CLI_DEVICE)
        for mark in range(width):
            tracing.span_stamp(slot, buf, mark)
        host = guarded.cpu().numpy()
        want = np.full_like(host, -1)
        if 0 <= row < STAMP_ROWS:
            written = host[row + 1]
            if not ((written > 0).all() and (np.diff(written) >= 0).all()):
                raise AssertionError(f"stamp kernel: slot {row} wrote "
                                     f"{written.tolist()}")
            want[row + 1] = written
        if not (host == want).all():
            changed = np.argwhere(host != want).tolist()
            raise AssertionError(f"stamp kernel: slot {row} of {STAMP_ROWS} "
                                 f"rows changed cells (guarded row, mark) "
                                 f"{changed[:8]} outside its row")
    try:
        tracing.span_stamp(slot, buf, width)
    except ValueError:
        pass
    else:
        raise AssertionError("stamp kernel: mark == width was launched")
    direct = tracing.span_stamp.launches
    if direct != len(STAMP_SLOTS) * width:
        raise AssertionError(f"stamp kernel: {direct} launches counted, "
                             f"{len(STAMP_SLOTS) * width} made")
    # device time a stamp: STAMP_TIMED stamps captured in a CUDA graph (as
    # in a training step's), the replay between events behind a sleep
    slot = torch.zeros(1, dtype=torch.int64, device=CLI_DEVICE)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # the first launch loads the module
        tracing.span_stamp(slot, buf, 0)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for k in range(STAMP_TIMED):
            tracing.span_stamp(slot, buf, k % width)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    graph.replay()
    torch.cuda.synchronize()
    torch.cuda._sleep(STAMP_SLEEP_CYCLES)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    stamp_us = start.elapsed_time(end) * 1e3 / STAMP_TIMED
    del graph
    tracing.span_stamp.launches = direct
    print(f"stamp kernel: rows of {width} stamps (the flagship superstep's "
          f"{TRAIN_MICRO} microbatches), {STAMP_ROWS} rows between guard "
          f"rows: slots {list(STAMP_SLOTS)} x {width} marks, {direct} "
          f"launches; each slot inside wrote its whole row, nondecreasing, "
          f"and nothing else; slots outside wrote nothing; mark {width} "
          f"refused; {stamp_us:.2f} us of device time a stamp (the mean of "
          f"{STAMP_TIMED} in one CUDA graph's replay)")

    # (b) graphed flagship supersteps, two an epoch: the first epoch warms
    # up and captures, then single replays at each slot
    flags = dict(images=True, preop=True, postop=False, blend=True)
    base = Config()
    base.image_model.name = CLI_MODEL
    base.image_model.spatial_size = [CLI_SIDE] * 3
    spec = model_spec(base, **flags)
    weights = random_flat_weights(build_model(base, **flags), seed,
                                  to_jax_flat)
    rng = np.random.default_rng(seed + 22)
    inputs, events, durations = synthetic_split(rng, (FUSED_SPLIT,), spec,
                                                CLI_DEVICE)
    ds = DeviceDataset(uids=np.arange(FUSED_SPLIT), inputs=inputs,
                       events=events, durations=durations)
    idx = rng.permutation(FUSED_SPLIT)[:2 * TRAIN_MICRO * TRAIN_BATCH] \
        .reshape(2, TRAIN_MICRO, TRAIN_BATCH)
    results = {"launches_direct": direct, "marks": marks,
               "stamp_ms": stamp_us * 1e-3}
    for dtype in ("float32", "bfloat16"):
        cfg = copy.deepcopy(base)
        cfg.tpu.compute_dtype = dtype
        model = build_model(cfg, **flags)
        load_jax_npz(model, weights)
        model.to(CLI_DEVICE)
        state = create_train_state(model, *make_optimizer(
            model.parameters(), TRAIN_LR, 2 + STAMP_REPLAYS, 1), seed=seed)
        state.ensure_rates(2 + STAMP_REPLAYS)
        tracing.span_stamp.launches = 0
        survival_train_epoch(state, ds, idx, blend=True, augment=True)
        torch.cuda.synchronize()
        captured = tracing.span_stamp.launches
        (steps,) = (v for v in state.graphs.values()
                    if isinstance(v, graphs.EpochSteps))
        step = steps.graphs["step"]
        stamper = steps.stampers["step"]
        if not step.settled or captured != 2 * marks \
                or len(stamper.phases) + 1 != marks:
            raise AssertionError(
                f"stamps {dtype}: settled {step.settled}, {captured} "
                f"launches at the warm-up and the capture ({2 * marks} "
                f"expected), {len(stamper.phases) + 1} marks a row")
        start, end = (torch.cuda.Event(enable_timing=True)
                      for _ in range(2))
        gaps, spans = [], []
        for r in range(STAMP_REPLAYS):
            slot = r % 2
            steps.rows.buf.fill_(-1)
            state.begin_step()
            torch.cuda.synchronize()
            # queued behind a sleep: the events time the device, not the
            # host's launch of the replay
            torch.cuda._sleep(STAMP_SLEEP_CYCLES)
            start.record()
            steps.run("step", idx[slot], slot)
            end.record()
            torch.cuda.synchronize()
            state.step += 1
            host = steps.rows.buf.cpu().numpy()
            row = host[slot, :marks]
            rest = np.delete(host, slot, axis=0)
            if step.last != "replay" or not (row > 0).all() \
                    or not (np.diff(row) >= 0).all() \
                    or not (host[slot, marks:] == -1).all() \
                    or not (rest == -1).all():
                raise AssertionError(
                    f"stamps {dtype}: replay {r} ({step.last}) at slot "
                    f"{slot} wrote row {host[slot].tolist()}, other rows "
                    f"{rest.tolist()}")
            stamped_ms = (row[-1] - row[0]) * 1e-6
            event_ms = start.elapsed_time(end)
            spans.append(stamped_ms)
            gaps.append(abs(stamped_ms - event_ms) / event_ms)
        replayed = tracing.span_stamp.launches - captured
        if max(gaps) > STAMP_TOLERANCE or replayed:
            raise AssertionError(
                f"stamps {dtype}: |stamped - events| / events {gaps} (limit "
                f"{STAMP_TOLERANCE}); {replayed} launches by the replays")
        phase_ms = {}
        for name, dt in zip(stamper.phases, np.diff(row) * 1e-6):
            phase_ms[name] = phase_ms.get(name, 0.0) + float(dt)
        results[dtype] = {"launches_per_capture": captured // 2,
                          "replay_launches": replayed,
                          "max_rel_gap": max(gaps),
                          "superstep_ms": float(np.median(spans)),
                          "phase_ms": phase_ms}
        print(f"stamps {dtype}: the flagship superstep ({TRAIN_MICRO} x "
              f"{TRAIN_BATCH} at {CLI_SIDE}^3) graphed, {marks} stamps a "
              f"row ({captured} launches at the warm-up and the capture, "
              f"{replayed} by {STAMP_REPLAYS} replays); each replay wrote "
              f"its own row and nothing else; stamped span "
              f"{np.median(spans):.3f} ms, |stamped - events| / events at "
              f"most {max(gaps):.2e} (limit {STAMP_TOLERANCE}); last "
              f"replay by phase (ms) "
              + ", ".join(f"{k} {v:.2f}" for k, v in phase_ms.items()))
        del state, steps, step, stamper, model
        gc.collect()
        torch.cuda.empty_cache()
    return results


def bn_inventory(batch: int = TRAIN_BATCH, side: int = CLI_SIDE) -> list:
    """(kind, shape (N, C, *spatial), relu) of the BatchNorm calls of one
    DenseNet121 microbatch's forward in call order (norm0, each dense
    layer's bottleneck statistics and norm2, the transitions, norm5), then
    the clinical MLP's six: kind "fold" (``ops/batch_norm.bottleneck_fold``)
    or "norm" (a ``BatchNorm`` layer, the ReLU fused where ``relu``)."""
    calls = [("norm", (batch, 64) + (side // 2,) * 3, True)]
    ch, s = 64, side // 4
    for i, layers in enumerate((6, 12, 24, 16)):
        for j in range(layers):
            calls += [("fold", (batch, ch + 32 * j) + (s,) * 3, False),
                      ("norm", (batch, BOTTLENECK_OUT) + (s,) * 3, True)]
        ch += 32 * layers
        calls.append(("norm", (batch, ch) + (s,) * 3, i < 3))
        ch, s = ch // 2, s // 2
    return calls + [("norm", (batch, w), False)
                    for w in (32, 16, 8, 8, 8, 12)]


def bn_bytes(calls: list, size: int) -> tuple[int, int]:
    """The least bytes the BatchNorm kernels move for ``calls`` (forward,
    backward), each operand read once a pass and each output written
    once: a layer's statistics read x, its normalise x and writes y, its
    backward sums g and x, its dx g and x and writes dx (a ReLU's mask
    follows from x and the fold, so y need not be read; the kernels read
    it, 2 more of a layer's bytes under a ReLU); a bottleneck's statistics
    x, their dx x and dx."""
    fwd = bwd = 0
    for kind, shape, _ in calls:
        n = int(np.prod(shape)) * size
        if kind == "fold":
            fwd, bwd = fwd + n, bwd + 2 * n
        else:
            fwd, bwd = fwd + 3 * n, bwd + 5 * n
    return fwd, bwd


BN_KERNELS = ("bn_stats_kernel", "bn_normalize_kernel",
              "bn_backward_sums_kernel", "bn_backward_dx_kernel")


def batch_norm_check(inventory: list, dt, seed: int) -> dict:
    """Each call of ``inventory`` in ``dt``, unmasked and with the last 3
    samples masked, on the kernels and on the plain path against the same
    call in float64 (tests/bn_witness.py; random parameters and running
    statistics; each path's backward under its own ReLU mask): every value
    within its limit (3 x the plain path's error + 1e-5 x the float64
    values' largest magnitude). Returns the kernels' largest error and the
    largest share of a limit; raises past one."""
    from mmnn_sts_torch.models import common
    from mmnn_sts_torch.models.densenet import FusedBottleneck
    from mmnn_sts_torch.ops import batch_norm

    if str(REPO / "tests") not in sys.path:  # not a package: by its path
        sys.path.insert(0, str(REPO / "tests"))
    import bn_witness as bw

    gen = torch.Generator(device="cuda").manual_seed(seed + 2323)
    worst = {"max_abs_err": 0.0, "max_share_of_limit": 0.0, "at": None}
    for masked in (False, True):
        for i, (kind, shape, relu) in enumerate(inventory):
            fmt = {5: torch.channels_last_3d}.get(len(shape),
                                                  torch.contiguous_format)
            x = (3.0 + 2.0 * torch.randn(shape, device="cuda", generator=gen)
                 ).to(dt).contiguous(memory_format=fmt)
            mask = (torch.tensor([1.0] * (shape[0] - 3) + [0.0] * 3,
                                 device="cuda") if masked else None)
            if kind == "fold":
                module = FusedBottleneck(shape[1], BOTTLENECK_OUT, dt)
                ra, rb = (torch.randn(shape[1], device="cuda", generator=gen)
                          for _ in range(2))
                args, names = (x, ra, rb, mask), bw.FOLD_VALUES
                run = bw.run_fold
            else:
                module = common.BatchNorm(shape[1], dt)
                up = (torch.randn(shape, device="cuda", generator=gen)
                      .to(dt).contiguous(memory_format=fmt))
                args, names = (x, up, mask, relu), bw.BN_VALUES
                run = bw.run_bn
            module = module.cuda().train()
            bw.randomise(module, seed + i)
            kernel = run(copy.deepcopy(module), *args)
            with batch_norm.plain_only():
                plain = run(copy.deepcopy(module), *args)
            if kind == "fold":
                def witness(out):
                    return bw.exact_fold(module, *args)
            else:
                def witness(out):  # under the path's own ReLU mask
                    return bw.exact_bn(module, *args,
                                       passed=out[0] > 0 if relu else None)
            for name, err, limit in bw.errors(kernel, plain, witness, names,
                                              relu):
                share = err / limit if limit > 0 else (0.0 if err == 0
                                                       else np.inf)
                at = f"{name} {kind} {shape} masked={masked}"
                if not share <= 1.0:
                    raise AssertionError(
                        f"batch_norm {dt}: {at}: kernels' error {err:.3e} "
                        f"past its limit {limit:.3e} (float64 witness)")
                worst["max_abs_err"] = max(worst["max_abs_err"], err)
                if share > worst["max_share_of_limit"]:
                    worst["max_share_of_limit"], worst["at"] = share, at
    return worst


def batch_norm_phase(fd, seed: int) -> dict:
    """The BatchNorm kernels on the card (see the module docstring, phase
    23): one DenseNet121 microbatch's BatchNorm calls timed, kernels
    against the plain path, each call's values held to float64, then the
    flagship superstep's launches at its capture."""
    import gc

    from mmnn_sts_torch.config import Config
    from mmnn_sts_torch.convert import load_jax_npz, to_jax_flat
    from mmnn_sts_torch.data.loader import DeviceDataset
    from mmnn_sts_torch.infer.export import model_spec
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.models import common
    from mmnn_sts_torch.models.densenet import FusedBottleneck
    from mmnn_sts_torch.ops import batch_norm
    from mmnn_sts_torch.train.schedule import make_optimizer
    from mmnn_sts_torch.train.state import create_train_state
    from mmnn_sts_torch.train.steps import survival_train_epoch

    inventory = bn_inventory()
    results = {}
    gen = torch.Generator(device="cuda").manual_seed(seed + 23)
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        calls = []
        for kind, shape, relu in inventory:
            fmt = {5: torch.channels_last_3d}.get(len(shape),
                                                  torch.contiguous_format)
            x = (3.0 + 2.0 * torch.randn(shape, device="cuda", generator=gen)
                 ).to(dt).contiguous(memory_format=fmt).requires_grad_()
            c = shape[1]
            if kind == "fold":
                module = FusedBottleneck(c, BOTTLENECK_OUT, dt)
                up = tuple(torch.randn(c, device="cuda", generator=gen)
                           for _ in range(2))
            else:
                module = common.BatchNorm(c, dt)
                up = (torch.randn(shape, device="cuda", generator=gen)
                      .to(dt).contiguous(memory_format=fmt),)
            calls.append((kind, module.cuda().train(), x, up, relu))

        def step(backward: bool):
            outs, grads = [], []
            for kind, module, x, up, relu in calls:
                out = (module.fold(x) if kind == "fold"
                       else (module(x, relu=relu),))
                outs += out
                grads += up
            if backward:
                torch.autograd.backward(outs, grads)

        def graphed_ms(backward: bool) -> float:
            for _, module, x, _, _ in calls:
                x.grad = None
                module.zero_grad(set_to_none=True)
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                step(backward)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side):
                step(backward)
            graph.replay()
            times = []
            for _ in range(MEASURED_ROUNDS):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                torch.cuda.synchronize()
                torch.cuda._sleep(SLEEP_CYCLES)
                start.record()
                graph.replay()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end))
            del graph
            return float(np.median(times))

        counts = batch_norm.launches, batch_norm.plain_calls
        step(True)
        torch.cuda.synchronize()
        launches = batch_norm.launches - counts[0]
        plain_calls = batch_norm.plain_calls - counts[1]
        folds = sum(k == "fold" for k, _, _ in inventory)
        want = 2 * folds + 4 * (len(inventory) - folds)
        if (launches, plain_calls) != (want, 0):
            raise AssertionError(f"batch_norm {dtype}: {launches} launches "
                                 f"and {plain_calls} plain calls for one "
                                 f"microbatch's forward and backward, not "
                                 f"{want} and 0")
        # device time a launch of each kernel, from one eager step's trace
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(True)
            torch.cuda.synchronize()
        per_kernel = {}
        for e in prof.key_averages():
            kind = next((k for k in BN_KERNELS if k in e.key), None)
            if kind and e.device_type == torch.autograd.DeviceType.CUDA:
                n, us = per_kernel.get(kind, (0, 0.0))
                per_kernel[kind] = (n + e.count, us + e.device_time_total)
        ms = {}
        for path, ctx in (("kernels", contextlib.nullcontext()),
                          ("plain", batch_norm.plain_only())):
            with ctx:
                forward = graphed_ms(False)
                ms[path] = (forward, graphed_ms(True) - forward)
        fwd_bytes, bwd_bytes = bn_bytes(inventory, 2 if dtype == "bfloat16"
                                        else 4)
        bound = (fwd_bytes / HBM_BYTES_PER_S * 1e3,
                 bwd_bytes / HBM_BYTES_PER_S * 1e3)
        results[dtype] = {
            "launches": launches, "ms": sum(ms["kernels"]),
            "forward_ms": ms["kernels"][0], "backward_ms": ms["kernels"][1],
            "plain_ms": sum(ms["plain"]), "plain_forward_ms": ms["plain"][0],
            "plain_backward_ms": ms["plain"][1], "bound_ms": sum(bound),
            "bound_forward_ms": bound[0], "bound_backward_ms": bound[1],
            "us_a_launch": {k: us / n for k, (n, us) in per_kernel.items()}}
        print(f"batch_norm {dtype}: one DenseNet121 microbatch's "
              f"{len(inventory) - folds} BatchNorm layers and {folds} "
              f"bottleneck statistics ({TRAIN_BATCH} x {CLI_SIDE}^3, with "
              f"the MLP's 6), forward and backward in one CUDA graph: "
              f"{launches} launches; kernels {ms['kernels'][0]:.3f} + "
              f"{ms['kernels'][1]:.3f} ms, plain path {ms['plain'][0]:.3f} "
              f"+ {ms['plain'][1]:.3f} ms, bytes bound {bound[0]:.3f} + "
              f"{bound[1]:.3f} ms (forward + backward, median of "
              f"{MEASURED_ROUNDS} replays); device us a launch (eager, "
              f"profiled): " + ", ".join(
                  f"{k} {n} x {us / n:.2f}" for k, (n, us) in
                  per_kernel.items()))
        del calls
        gc.collect()
        torch.cuda.empty_cache()
        check = batch_norm_check(inventory, dt, seed)
        results[dtype].update(check)
        print(f"batch_norm {dtype}: the {len(inventory)} calls unmasked and "
              f"with 3 of {TRAIN_BATCH} samples masked, kernels and plain "
              f"path against float64: the kernels' largest error "
              f"{check['max_abs_err']:.3e}, at most "
              f"{check['max_share_of_limit']:.1%} of its limit "
              f"({check['at']}; 3 x the plain path's error + 1e-5 x the "
              f"largest magnitude)")
        gc.collect()
        torch.cuda.empty_cache()

    # the flagship superstep graphed: launches at the warm-up and the
    # capture, no plain call
    flags = dict(images=True, preop=True, postop=False, blend=True)
    base = Config()
    base.image_model.name = CLI_MODEL
    base.image_model.spatial_size = [CLI_SIDE] * 3
    spec = model_spec(base, **flags)
    weights = random_flat_weights(build_model(base, **flags), seed,
                                  to_jax_flat)
    rng = np.random.default_rng(seed + 23)
    inputs, events, durations = synthetic_split(rng, (FUSED_SPLIT,), spec,
                                                CLI_DEVICE)
    ds = DeviceDataset(uids=np.arange(FUSED_SPLIT), inputs=inputs,
                       events=events, durations=durations)
    idx = rng.permutation(FUSED_SPLIT)[:2 * TRAIN_MICRO * TRAIN_BATCH] \
        .reshape(2, TRAIN_MICRO, TRAIN_BATCH)
    for dtype in ("float32", "bfloat16"):
        cfg = copy.deepcopy(base)
        cfg.tpu.compute_dtype = dtype
        model = build_model(cfg, **flags)
        load_jax_npz(model, weights)
        model.to(CLI_DEVICE)
        state = create_train_state(model, *make_optimizer(
            model.parameters(), TRAIN_LR, 2, 1), seed=seed)
        state.ensure_rates(2)
        counts = batch_norm.launches, batch_norm.plain_calls
        survival_train_epoch(state, ds, idx, blend=True, augment=True)
        torch.cuda.synchronize()
        per_capture = (batch_norm.launches - counts[0]) // 2
        plain_calls = batch_norm.plain_calls - counts[1]
        if plain_calls or per_capture != TRAIN_MICRO * results[dtype][
                "launches"]:
            raise AssertionError(
                f"batch_norm {dtype}: the flagship superstep launched "
                f"{per_capture} a capture ({TRAIN_MICRO} x "
                f"{results[dtype]['launches']} expected) with "
                f"{plain_calls} plain calls")
        results[dtype]["launches_per_capture"] = per_capture
        print(f"batch_norm {dtype}: the flagship superstep ({TRAIN_MICRO} x "
              f"{TRAIN_BATCH} at {CLI_SIDE}^3) graphed: {per_capture} "
              f"launches at its capture ({per_capture // TRAIN_MICRO} a "
              f"microbatch), {plain_calls} plain calls")
        del state, model
        gc.collect()
        torch.cuda.empty_cache()
    return results


def rows_diff(got: list, want: list, keys) -> float:
    """The largest |got - want| / max(1, |want|) over ``keys`` of two runs'
    metrics.jsonl rows (inf where their epochs differ)."""
    if [r["epoch"] for r in got] != [r["epoch"] for r in want]:
        return np.inf
    worst = 0.0
    for g, w in zip(got, want):
        for k in keys:
            if g[k] != w[k]:
                worst = max(worst, abs(g[k] - w[k]) / max(1.0, abs(w[k])))
    return worst if worst == worst else np.inf


def check_rows(got: list, want: list, keys, control: float,
               what: str) -> float:
    """``rows_diff`` of two runs, raised beyond max(FUSED_TOLERANCE,
    FUSED_CONTROL_FACTOR x ``control``), the distance of two eager runs."""
    worst = rows_diff(got, want, keys)
    limit = max(FUSED_TOLERANCE, FUSED_CONTROL_FACTOR * control)
    if not worst <= limit:
        raise AssertionError(f"{what}: {worst:.3e} beyond {limit:.3e}; "
                             f"{got} vs {want}")
    return worst


def fused_cli_phase(fd, seed: int, workdir: Path, per_epoch: int) -> dict:
    """TPU.fused_epoch and TPU.device_resident_dataset: false through the
    CLI on the CLI phase's cohort (see the module docstring, phase 13),
    held against the CLI and infer phases' eager runs. ``per_epoch``: the
    eager run's launches an epoch."""
    from mmnn_sts_torch import pipeline
    from mmnn_sts_torch.infer.export import ServingModel
    from mmnn_sts_torch.train import checkpoint, graphs

    base = json.loads((workdir / "config.json").read_text())

    def config(name, tpu, extra=None):
        cfg = copy.deepcopy(extra or base)
        cfg["TPU"] = {**cfg.get("TPU", {}), **tpu}
        path = workdir / name
        path.write_text(json.dumps(cfg))
        return path

    def rows(out: Path) -> list:
        return [json.loads(x) for x in (out / "metrics.jsonl").read_text()
                .splitlines()]

    fused = config("fused.json", {"fused_epoch": True})
    surv = ["--images", "--preop", "--survival", "--blend", "--split",
            "--blend_update_interval", "1", "--epochs", str(CLI_EPOCHS)]
    # the losses are held; the C-indices (a pair's order flips at
    # roundoff) are printed
    keys = ("train_loss", "val_loss", "selection_loss")
    eager_rows = rows(workdir / "run" / "out")[:CLI_EPOCHS]
    bodies = []
    real_run = graphs.BoundBody.run

    def spy(self):
        out = real_run(self)
        bodies.append((self.name, self.last, self.launches_per_capture))
        return out

    # 0. the control: the CLI phase's eager run with every volume scaled by
    # 1 + 2^-22 (one ulp): how far roundoff alone moves a 3-epoch run. The
    # graphs may round differently from eager kernels (each superstep
    # alone is held in fused_epoch_phase), and the loop amplifies any
    # difference (ROADMAP.md Queue 3, roundoff amplification)
    real_build = pipeline.build_device_dataset

    def one_ulp(uids, device, image_volumes=None, **kw):
        return real_build(uids, device, image_volumes=None
                          if image_volumes is None else image_volumes
                          * np.float32(1 + 2**-22), **kw)

    def control(name, args, want):
        where = workdir / name
        where.mkdir()
        rc, _, _ = run_cli(fd, args + ["--config", str(workdir /
                                                      "config.json"),
                                       "--output_path", str(where / "out")],
                           where, [mock.patch.object(
                               pipeline, "build_device_dataset", one_ulp)])
        if rc != 0:
            raise AssertionError(f"the control run {name} returned {rc}")
        return rows(where / "out")

    noise = rows_diff(control("eager_ulp", surv, eager_rows), eager_rows,
                      keys)
    print(f"fused cli control: the eager CLI run on volumes x (1 + 2^-22), "
          f"metrics vs the CLI phase's: largest |Δ| / max(1, |x|) "
          f"{noise:.3e} (cudnn.allow_tf32={torch.backends.cudnn.allow_tf32})")

    # 1. the survival run, each superstep a graph replay after the first
    # epoch's warm-ups and the second's captures
    run_dir = workdir / "fused"
    run_dir.mkdir()
    rc, wall, launches = run_cli(
        fd, surv + ["--config", str(fused), "--output_path",
                    str(run_dir / "out"), "--checkpoint_dir",
                    str(run_dir / "ck")], run_dir,
        [mock.patch.object(graphs.BoundBody, "run", spy)])
    got = rows(run_dir / "out")
    worst = check_rows(got, eager_rows, keys, noise, "fused CLI vs eager")
    seen = {}
    for name, last, per_capture in bodies:
        seen.setdefault(name, []).append((last, per_capture))
    # on the card: warm-ups and captures launch through the wrapper,
    # replays do not (a CPU rehearsal runs every body eagerly)
    card = CLI_DEVICE == "cuda"
    first, later = ("warm-up", "replay") if card else ("eager", "eager")
    runs = {k: [x[0] for x in v] for k, v in seen.items()}
    if rc != 0 or any(v != [first] + [later] * (len(v) - 1)
                      for v in runs.values()) \
            or len(runs.get("tail step", [])) != CLI_EPOCHS \
            or len(runs.get("validation forward", [])) != CLI_EPOCHS \
            or launches != (2 if card else CLI_EPOCHS) * per_epoch:
        raise AssertionError(f"fused CLI: rc {rc}, bodies {seen}, launches "
                             f"{launches} (2 x {per_epoch} expected)")
    captures = {k: v[-1][1] for k, v in seen.items()}
    print(f"fused cli: rc {rc}, {wall:.1f} s; every superstep one replay "
          f"after epoch 1 (warm-ups) and epoch 2 (captures, then replays): "
          f"{ {k: len(v) for k, v in seen.items()} } runs, fused kernel "
          f"launches per capture {captures}; {launches} launches in the run "
          f"(eager: {CLI_EPOCHS} x {per_epoch}); losses vs the eager CLI "
          f"run: largest |Δ| / max(1, |eager|) {worst:.3e} (limit max("
          f"{FUSED_TOLERANCE:.0e}, {FUSED_CONTROL_FACTOR:g} x control)); "
          f"C-indices {rows_diff(got, eager_rows, ('train_c', 'val_c')):.3e}")
    for g, w in zip(got, eager_rows):
        print(f"  epoch {g['epoch']}: fused {g['epoch_seconds']:.2f} s, "
              f"eager {w['epoch_seconds']:.2f} s (host clock); train loss "
              f"{g['train_loss']:.6f} vs {w['train_loss']:.6f}")

    # 1b. the same in bfloat16 with TPU.remat, 2 epochs: the bf16 kernel
    # and the remat recompute inside the CLI's graphs
    both = config("fused_bf16_remat.json", {
        "fused_epoch": True, "compute_dtype": "bfloat16", "remat": True})
    both_dir = workdir / "fused_bf16_remat"
    both_dir.mkdir()
    del bodies[:]
    args = [a if a != str(CLI_EPOCHS) else "2" for a in surv]
    rc, wall, both_launches = run_cli(
        fd, args + ["--config", str(both), "--output_path",
                    str(both_dir / "out")], both_dir,
        [mock.patch.object(graphs.BoundBody, "run", spy)])
    both_rows = rows(both_dir / "out")
    both_capture = {name: per_capture for name, _, per_capture in bodies
                    if per_capture is not None}
    want = {"step step": TRAIN_MICRO * 115, "tail step": TRAIN_MICRO * 115,
            "validation forward": 58} if card else {}
    if rc != 0 or len(both_rows) != 2 or not all(
            np.isfinite([r[k] for k in keys]).all() for r in both_rows) \
            or both_capture != want:
        raise AssertionError(f"fused bf16 remat CLI: rc {rc}, rows "
                             f"{both_rows}, launches per capture "
                             f"{both_capture}")
    print(f"fused cli, bfloat16 with remat: rc {rc}, {wall:.1f} s, "
          f"{both_launches} launches, per capture {both_capture}; "
          + "; ".join(f"epoch {r['epoch']} {r['epoch_seconds']:.2f} s, "
                      f"train loss {r['train_loss']:.6f}"
                      for r in both_rows))

    # 2. --resume from run 1's checkpoint of epoch 2 (its epoch 3 dropped,
    # as if the run had stopped there): ends as run 1 does
    resume_dir = workdir / "fused_resume"
    shutil.copytree(run_dir / "ck", resume_dir / "ck")
    index_path = resume_dir / "ck" / "index.json"
    index = json.loads(index_path.read_text())
    del index[str(CLI_EPOCHS)]
    index_path.write_text(json.dumps(index))
    last = f"ckpt_{CLI_EPOCHS:08d}.pt"
    (resume_dir / "ck" / last).unlink()
    rc, _, _ = run_cli(fd, surv + ["--config", str(fused), "--output_path",
                                   str(resume_dir / "out"),
                                   "--checkpoint_dir", str(resume_dir / "ck"),
                                   "--resume"], resume_dir, [])
    resumed = rows(resume_dir / "out")
    worst_resume = check_rows(resumed, got[-1:], keys, noise, "fused resume")
    a = torch.load(run_dir / "ck" / last, weights_only=True)["model"]
    b = torch.load(resume_dir / "ck" / last, weights_only=True)["model"]
    equal = sum(torch.equal(a[k], b[k]) for k in a)
    if rc != 0:
        raise AssertionError(f"fused resume: rc {rc}")
    print(f"fused cli --resume from epoch {CLI_EPOCHS - 1}'s checkpoint: "
          f"epoch {CLI_EPOCHS} ends as the uninterrupted run does (losses "
          f"within {worst_resume:.1e}; {equal} of {len(a)} tensors of the "
          f"last checkpoint bit-equal)")

    # 3. its export, served
    trained = copy.deepcopy(base)
    trained["Hyperparameters"]["model_weights"] = str(
        run_dir / "out" / "best_surv_model.npz")
    trained = config("fused_trained.json", {"fused_epoch": True}, trained)
    artifact = workdir / "fused_model.pt"
    rc, wall, _ = run_cli(fd, ["--images", "--preop", "--survival",
                               "--blend", "--split", "--config", str(trained),
                               "--export_path", str(artifact)], run_dir, [])
    rng = np.random.default_rng(seed + 7)
    answer = ServingModel(str(artifact), device=CLI_DEVICE)({
        "image": (rng.normal(size=(3,) + (CLI_SIDE,) * 3 + (2,)) ** 2 * 500
                  ).astype(np.float32),
        "clinical": rng.normal(size=(3, 11)).astype(np.float32)})
    if rc != 0 or answer.shape != (3, 2) or not np.isfinite(answer).all():
        raise AssertionError(f"fused export: rc {rc}, answer {answer}")
    print(f"fused cli export: {wall:.1f} s in process; served batch 3: "
          f"{answer.tolist()}")

    # 4. classification, 2 epochs, against the infer phase's eager run and
    # its one-ulp control; the F1s are thresholds of the logits, so the
    # losses are held
    class_args = ["--images", "--preop", "--classification", "--blend",
                  "--split", "--epochs", "2", "--blend_update_interval", "1"]
    eager_class = rows(workdir / "run_class" / "out")
    class_keys = ("train_loss", "val_loss")
    class_noise = rows_diff(control("eager_class_ulp", class_args,
                                    eager_class), eager_class, class_keys)
    class_dir = workdir / "fused_class"
    class_dir.mkdir()
    rc, wall, launches = run_cli(
        fd, class_args + ["--config", str(fused), "--output_path",
                          str(class_dir / "out")], class_dir, [])
    if rc != 0:
        raise AssertionError(f"fused classification: rc {rc}")
    class_rows = rows(class_dir / "out")
    worst_class = check_rows(class_rows, eager_class, class_keys,
                             class_noise, "fused classification vs eager")
    print(f"fused cli classification: rc {rc}, {wall:.1f} s, {launches} "
          f"launches; losses vs the eager run within {worst_class:.3e} "
          f"(the one-ulp control {class_noise:.3e}); "
          + "; ".join(f"epoch {r['epoch']} {r['epoch_seconds']:.2f} s"
                      for r in class_rows))

    # 5. streaming from the host: 2 classification epochs, the eager run's
    # losses
    stream = config("stream.json", {"device_resident_dataset": False})
    stream_dir = workdir / "stream"
    stream_dir.mkdir()
    rc, wall, launches = run_cli(
        fd, class_args + ["--config", str(stream), "--output_path",
                          str(stream_dir / "out")], stream_dir, [])
    stream_rows = rows(stream_dir / "out")
    worst_stream = check_rows(stream_rows, eager_class, class_keys,
                              class_noise, "streaming CLI vs resident")
    if rc != 0:
        raise AssertionError(f"streaming CLI: rc {rc}")
    print(f"stream cli (device_resident_dataset false), --classification: "
          f"rc {rc}, {wall:.1f} s, {launches} launches; losses vs the "
          f"resident run within {worst_stream:.3e}; "
          + "; ".join(f"epoch {r['epoch']} {r['epoch_seconds']:.2f} s "
                      f"(resident {w['epoch_seconds']:.2f})"
                      for r, w in zip(stream_rows, eager_class)))

    # 6. --inference over the host test split in chunks
    infer_cfg = json.loads((workdir / "infer.json").read_text())
    infer_stream = config("infer_stream.json", {
        "device_resident_dataset": False, "eval_chunk_size": FUSED_CHUNK},
        infer_cfg)
    out = workdir / "infer_stream"
    rc, wall, launches = run_cli(
        fd, ["--inference", "--images", "--preop", "--survival", "--blend",
             "--config", str(infer_stream), "--output_path", str(out)],
        workdir / "run", [])
    _, got_preds = read_csv_rows(out / "survival_model_predictions.csv")
    _, want_preds = read_csv_rows(workdir / "infer_survival" /
                                  "survival_model_predictions.csv")
    diff = np.abs(got_preds - want_preds).max() / max(
        1.0, np.abs(want_preds).max())
    if rc != 0 or got_preds.shape != want_preds.shape or not diff <= 1e-3:
        raise AssertionError(f"streaming inference: rc {rc}, "
                             f"{got_preds.shape}, max rel diff {diff}")
    print(f"stream cli --inference: rc {rc}, {wall:.1f} s, {launches} "
          f"launches, chunks of {FUSED_CHUNK} from the host; predictions vs "
          f"the resident inference (whole split, cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}): max |Δ| / max(1, |x|) "
          f"{diff:.2e} (limit 1e-3)")
    return {"per_capture": captures,
            "epoch_s": [r["epoch_seconds"] for r in got],
            "eager_epoch_s": [r["epoch_seconds"] for r in eager_rows],
            "stream_epoch_s": [r["epoch_seconds"] for r in stream_rows]}


PLANAR_FAMILIES = ("densenet121", "tinycnn", "monaidensenet", "densenet169",
                   "densenet201", "densenet264", "seresnet50")
PLANAR_SIDE, PLANAR_LARGE = 64, 256  # the flagship's in-plane size; large M
PLANAR_MAP_TOLERANCE = 1e-2


def kernel_shapes(fd, seen: set):
    """A patch of the kernel's wrapper that adds each call's (M, K, x
    dtype) to ``seen`` (read the launches as ``kernel_dtypes`` says)."""
    orig = fd.fused_bn_relu_matmul

    @functools.wraps(orig)
    def call(x, a, b, w):
        seen.add((x.shape[0], x.shape[1], x.dtype))
        return orig(x, a, b, w)

    return mock.patch.object(fd, "fused_bn_relu_matmul", call)


def planar_phase(fd, seed: int) -> dict:
    """ImageModel.spatial_dims 2 at Config() widths (see the module
    docstring, phase 19). Returns, by family, the launches per forward and
    the eval forward's ms."""
    from mmnn_sts_torch.config import Config
    from mmnn_sts_torch.convert import load_jax_npz, to_jax_flat
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.ops.augment import eval_transform_batch
    from mmnn_sts_torch.ops.gradcam import attention_maps
    from mmnn_sts_torch.train.schedule import make_optimizer
    from mmnn_sts_torch.train.state import create_train_state
    from mmnn_sts_torch.train.steps import survival_train_superstep

    rng = np.random.default_rng(seed + 19)
    tf32, torch.backends.cudnn.allow_tf32 = \
        torch.backends.cudnn.allow_tf32, False
    print(f"planar: spatial_dims 2, Config() widths, inputs ({TRAIN_BATCH}, "
          f"{PLANAR_SIDE}, {PLANAR_SIDE}, 2), random weights, cudnn."
          f"allow_tf32={torch.backends.cudnn.allow_tf32}: eval forward on "
          f"the card against the CPU and a train superstep (Cox loss "
          f"backward, one SGD step) with the kernel against the plain op, "
          f"within {TRAIN_TOLERANCE:.0e} x max(1, |reference|); bfloat16 "
          f"eval and train forward")

    def image_batch(batch, side):
        vols = (rng.normal(size=(batch, side, side, 2)) ** 2 * 500).astype(
            np.float32)
        return eval_transform_batch(torch.from_numpy(vols))

    def check(got, want, where, tol=TRAIN_TOLERANCE):
        got, want = got.float().cpu(), want.float().cpu()
        err = (got - want).abs().max().item()
        limit = tol * max(1.0, want.abs().max().item())
        if got.shape != want.shape or not err <= limit:
            raise AssertionError(f"planar {where}: max |Δ| {err:.3e} > "
                                 f"{limit:.3e}")
        return err

    shapes, results = set(), {}
    for name in PLANAR_FAMILIES:
        multimodal = name == "densenet121"  # the flagship blend model
        flags = dict(images=True, preop=multimodal, postop=False,
                     blend=multimodal)
        cfg = Config()
        cfg.image_model.name = name
        cfg.image_model.spatial_dims = 2
        cfg.image_model.spatial_size = [PLANAR_SIDE] * 2
        base = build_model(cfg, **flags)
        encoder = base.image_model if multimodal else base
        per_forward = sum(getattr(encoder, "block_config", ()))
        weights = random_flat_weights(base, seed, to_jax_flat)
        load_jax_npz(base, weights)
        image = image_batch(TRAIN_BATCH, PLANAR_SIDE)
        inputs = ({"image": image, "clinical": torch.from_numpy(rng.normal(
            size=(TRAIN_BATCH, 11)).astype(np.float32))}
            if multimodal else image)

        def on(x, device):
            return ({k: v.to(device) for k, v in x.items()}
                    if isinstance(x, dict) else x.to(device))

        model = copy.deepcopy(base).to("cuda").eval()
        fd.fused_bn_relu_matmul.launches = 0
        with kernel_shapes(fd, shapes), torch.no_grad():
            out = model(on(inputs, "cuda"))
            torch.cuda.synchronize()
            launched = fd.fused_bn_relu_matmul.launches
        with torch.no_grad():
            cpu = base.eval()(inputs)
        if launched != per_forward or not torch.isfinite(out).all():
            raise AssertionError(f"planar {name} eval forward: {launched} "
                                 f"launches, not {per_forward}")
        err = check(out, cpu, f"{name} eval, card vs CPU")
        with torch.no_grad():
            forward_ms = event_ms(lambda: model(on(inputs, "cuda")))

        def superstep(state):
            lead = {k: v[None] for k, v in on(inputs, "cuda").items()} \
                if multimodal else on(inputs, "cuda")[None]
            events = torch.from_numpy((rng_events < 0.7).astype(
                np.float32)).cuda()
            durations = torch.from_numpy(rng_durations).cuda()
            return survival_train_superstep(state, lead, events, durations,
                                            blend=multimodal, augment=False)

        rng_events = rng.random((1, TRAIN_BATCH, 2))
        rng_durations = rng.integers(1, 25, (1, TRAIN_BATCH, 2)).astype(
            np.float32)

        def new_state(cfg_):
            m = build_model(cfg_, **flags)
            load_jax_npz(m, weights)
            m.to("cuda")
            return create_train_state(m, *make_optimizer(
                m.parameters(), TRAIN_LR, 4, 1), seed=seed)

        state = new_state(cfg)
        fd.fused_bn_relu_matmul.launches = 0
        with kernel_shapes(fd, shapes):
            got = superstep_tensors(superstep(state), state.model)
            step_launches = fd.fused_bn_relu_matmul.launches
        plain = new_state(cfg)
        with mock.patch.object(fd, "fused_bn_relu_matmul",
                               fd.fused_bn_relu_matmul_reference):
            want = superstep_tensors(superstep(plain), plain.model)
        dev = deviations(got, want)
        bad = [(r, n) for r, n in dev if not r <= 1.0]
        if bad or step_launches != per_forward:
            raise AssertionError(f"planar {name} superstep, kernel vs plain "
                                 f"op: {sorted(bad)[-5:]}; {step_launches} "
                                 f"launches")
        del plain, want, got

        cfg16 = copy.deepcopy(cfg)
        cfg16.tpu.compute_dtype = "bfloat16"
        state16 = new_state(cfg16)
        seen = set()
        with kernel_dtypes(fd, seen), kernel_shapes(fd, shapes):
            with torch.no_grad():
                out16 = state16.model.eval()(on(inputs, "cuda"))
            aux16 = superstep(state16)
        if per_forward:
            check_bf16_calls(seen, f"planar {name} bf16")
        if not (torch.isfinite(out16.float()).all()
                and torch.isfinite(aux16["loss"])):
            raise AssertionError(f"planar {name} bf16: not finite")
        results[name] = {"per_forward": launched, "forward_ms": forward_ms}
        print(f"  {name}: eval forward {tuple(out.shape)} in {launched} "
              f"launches, {forward_ms:.2f} ms (CUDA events), card vs CPU "
              f"max |Δ| {err:.2e}; superstep {step_launches} launches, "
              f"kernel vs plain largest {max(dev)[0]:.1%} of the limit; "
              f"bf16 eval and superstep finite"
              + (", every call bf16" if per_forward else ""))
        del state, state16, model
        torch.cuda.empty_cache()

    # large M: block 1's bottlenecks at M = 8 x 64^2
    cfg = Config()
    cfg.image_model.spatial_dims = 2
    base = build_model(cfg, images=True, preop=False, postop=False,
                       blend=False)
    load_jax_npz(base, random_flat_weights(base, seed, to_jax_flat))
    model = base.to("cuda").eval()
    image = image_batch(TRAIN_BATCH, PLANAR_LARGE).cuda()
    fd.fused_bn_relu_matmul.launches = 0
    with kernel_shapes(fd, shapes), torch.no_grad():
        out = model(image)
        torch.cuda.synchronize()
        launched = fd.fused_bn_relu_matmul.launches
    with torch.no_grad(), mock.patch.object(
            fd, "fused_bn_relu_matmul", fd.fused_bn_relu_matmul_reference):
        want = model(image)
    large_err = check(out, want, "densenet121 at 256^2, kernel vs plain",
                      1e-3)
    with torch.no_grad():
        large_ms = event_ms(lambda: model(image))
    if launched != 58:
        raise AssertionError(f"planar 256^2 forward: {launched} launches")
    print(f"  densenet121 at ({TRAIN_BATCH}, {PLANAR_LARGE}, {PLANAR_LARGE}, "
          f"2): 58 launches (block 1 M = "
          f"{TRAIN_BATCH * (PLANAR_LARGE // 4) ** 2}), kernel vs plain max "
          f"|Δ| {large_err:.2e}, {large_ms:.2f} ms (CUDA events)")
    del model, base

    # the kernel against the plain version at every 2D shape it was called
    gen = torch.Generator(device="cuda").manual_seed(seed + 19)
    # DenseNet121's 58 2D bottlenecks at (8, 64, 64) timed as kernel_phase
    # times the 3D ones (sums over the calls)
    from mmnn_sts_torch.models.densenet import bottleneck_shapes, densenet121

    timed = {}
    for dtype_name, dtype in (("float32", torch.float32),
                              ("bfloat16", torch.bfloat16)):
        tot = dict(ms=0.0, plain_ms=0.0, gemm_ms=0.0, bound_ms=0.0)
        for _, m, k in bottleneck_shapes(densenet121(spatial_dims=2),
                                         TRAIN_BATCH, PLANAR_SIDE):
            x, a, b, w = operands(gen, m, k, dtype)
            h = torch.relu(x.float() * a + b).to(dtype)
            tot["ms"] += time_calls(
                lambda: fd.fused_bn_relu_matmul(x, a, b, w))[0]
            tot["plain_ms"] += time_calls(
                lambda: fd.fused_bn_relu_matmul_reference(x, a, b, w))[0]
            tot["gemm_ms"] += time_calls(lambda: torch.matmul(h, w))[0]
            tot["bound_ms"] += bound_ms(m, k, BOTTLENECK_OUT, dtype_name)[0]
        timed[dtype_name] = tot
        print(f"  2D kernel {dtype_name}, DenseNet121's 58 calls at "
              f"({TRAIN_BATCH}, {PLANAR_SIDE}, {PLANAR_SIDE}) (M 2,048 .. 32;"
              f" device ms, calls queued behind a sleep): kernel "
              f"{tot['ms']:.4f}, plain {tot['plain_ms']:.4f}, the product "
              f"alone {tot['gemm_ms']:.4f}, bound {tot['bound_ms']:.4f}")
    worst = {}
    for m, k, dtype in sorted(shapes, key=str):
        x, a, b, w = operands(gen, m, k, dtype)
        diff, rel = check_call(fd, x, a, b, w, TOLERANCE[str(dtype)[6:]],
                               f"2D M={m} K={k} {dtype}")
        worst[dtype] = max(worst.get(dtype, 0.0), diff)
    print(f"planar kernel checks: {len(shapes)} (M, K, dtype) shapes of the "
          f"2D forwards and supersteps against the plain version, max abs "
          f"err " + ", ".join(f"{str(d)[6:]} {e:.2e}"
                              for d, e in worst.items()))

    # 2D Grad-CAM of the flagship on one patient: the card against the CPU
    cfg = Config()
    cfg.image_model.spatial_dims = 2
    flags = dict(images=True, preop=True, postop=False, blend=True)
    base = build_model(cfg, **flags)
    load_jax_npz(base, random_flat_weights(base, seed, to_jax_flat))
    inputs = {"image": image_batch(1, PLANAR_SIDE),
              "clinical": torch.from_numpy(rng.normal(size=(1, 11)).astype(
                  np.float32))}
    cpu_maps = attention_maps(base.eval(), inputs, 2, blend=True)
    model = copy.deepcopy(base).to("cuda").eval()
    maps = attention_maps(model, {k: v.cuda() for k, v in inputs.items()},
                          2, blend=True)
    map_err = check(maps, cpu_maps, "Grad-CAM, card vs CPU",
                    PLANAR_MAP_TOLERANCE)
    if maps.shape != (2, PLANAR_SIDE, PLANAR_SIDE) or maps.min() < 0 \
            or maps.max() > 1:
        raise AssertionError(f"planar Grad-CAM maps {tuple(maps.shape)} in "
                             f"[{maps.min():.3g}, {maps.max():.3g}]")
    print(f"  2D Grad-CAM (flagship blend model, one {PLANAR_SIDE}^2 "
          f"patient): maps {tuple(maps.shape)} in [0, 1], card vs CPU max "
          f"|Δ| {map_err:.2e} (limit {PLANAR_MAP_TOLERANCE:g})")
    torch.backends.cudnn.allow_tf32 = tf32
    results["large_m_ms"] = large_ms
    results["shapes"] = len(shapes)
    results["kernel_58"] = timed
    return results


MESH_STEPS = 3  # the warm-up, the capture (and its replay), a replay
MESH_RANK_STEPS = 1  # eager supersteps of the two ranks sharing the card
MESH_CONTROL_FACTOR = 4.0
# relative L2 of the two ranks' first losses and predictions from one
# process's: before any update, only the reduction order differs
MESH_FIRST_LIMIT = 1e-5
MESH_CLI_PATIENTS = 16  # training patients of the two-rank CLI run
MESH_TIMEOUT = 600


def mesh_setup(seed: int, rows: int):
    """The flagship blend model's weights, a resident split of 64 volumes
    and ``rows`` supersteps' indices, the same in every process."""
    from mmnn_sts_torch.config import Config
    from mmnn_sts_torch.convert import to_jax_flat
    from mmnn_sts_torch.data.loader import DeviceDataset
    from mmnn_sts_torch.infer.export import model_spec
    from mmnn_sts_torch.models import build_model

    flags = dict(images=True, preop=True, postop=False, blend=True)
    cfg = Config()
    cfg.image_model.spatial_size = [CLI_SIDE] * 3
    spec = model_spec(cfg, **flags)
    weights = random_flat_weights(build_model(cfg, **flags), seed,
                                  to_jax_flat)
    rng = np.random.default_rng(seed + 20)
    n = TRAIN_MICRO * TRAIN_BATCH
    inputs, events, durations = synthetic_split(rng, (n,), spec, "cuda")
    ds = DeviceDataset(uids=np.arange(n), inputs=inputs, events=events,
                       durations=durations)
    idx = np.stack([rng.permutation(n).reshape(TRAIN_MICRO, TRAIN_BATCH)
                    for _ in range(rows)])
    return cfg, flags, weights, ds, idx


def mesh_state(cfg, flags, weights, seed, ranks=None):
    from mmnn_sts_torch.convert import load_jax_npz
    from mmnn_sts_torch.models import build_model
    from mmnn_sts_torch.train.schedule import make_optimizer
    from mmnn_sts_torch.train.state import create_train_state

    model = build_model(cfg, **flags)
    load_jax_npz(model, weights)
    model.to("cuda")
    state = create_train_state(model, *make_optimizer(
        model.parameters(), TRAIN_LR, 4, 1), seed=seed, mesh=ranks)
    state.ensure_rates(MESH_STEPS)
    return state


def mesh_supersteps(state, ds, idx, steps: int, graphed: bool):
    """``steps`` flagship supersteps (augmented), eager or through
    ``survival_train_epoch``; returns each superstep's ``state_tensors``
    (copies: its loss and predictions, then the state it left) and its
    host seconds (``"seconds"``, synchronised)."""
    from mmnn_sts_torch.data.loader import gather_superbatch
    from mmnn_sts_torch.train.steps import (
        survival_train_epoch, survival_train_superstep)

    trace = []
    for s in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if graphed:
            out = survival_train_epoch(state, ds, idx[s:s + 1], blend=True)
            loss, preds = out["loss"][:1], out["preds"][:1]
        else:
            batch = gather_superbatch(ds, idx[s])
            aux = survival_train_superstep(
                state, batch["inputs"], batch["events"], batch["durations"],
                blend=True)
            loss, preds = aux["loss"][None], aux["preds"][None]
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        trace.append({k: v.clone() for k, v in
                      state_tensors(state, loss, preds).items()})
        trace[-1]["seconds"] = seconds
    return trace


def mesh_rank(workdir: str, seed: int) -> int:
    """One of mesh_phase's two ranks sharing the card over gloo (started by
    ``--mesh-rank``): the flagship's eager supersteps on this rank's rows;
    rank 0 saves the state's tensors."""
    sys.path.insert(0, str(REPO))
    from mmnn_sts_torch.ops import fused_dense as fd
    from mmnn_sts_torch.parallel import mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    if not mesh.maybe_initialize_distributed("cuda"):
        raise SystemExit("mesh rank: no torch.distributed environment")
    ranks = mesh.make_mesh([-1], ("data",))
    cfg, flags, weights, ds, idx = mesh_setup(seed, MESH_RANK_STEPS)
    state = mesh_state(cfg, flags, weights, seed, ranks)
    # gloo takes CUDA tensors through the host: check it moves them
    probe = torch.full((4,), float(ranks.rank + 1), device="cuda")
    parts = [torch.empty_like(probe) for _ in range(ranks.shape[0])]
    torch.distributed.all_gather(parts, probe)
    torch.distributed.all_reduce(probe)
    torch.distributed.broadcast(probe, 0)
    if probe.device.type != "cuda" or probe[0].item() != 3.0 \
            or [p[0].item() for p in parts] != [1.0, 2.0]:
        raise AssertionError(f"gloo on the card: {probe}, {parts}")
    fd.fused_bn_relu_matmul.launches = 0
    mesh.reset_counts()
    t0 = time.perf_counter()
    trace = mesh_supersteps(state, ds, idx, MESH_RANK_STEPS, False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out = mesh_host(trace)
    out["launches"] = np.asarray(fd.fused_bn_relu_matmul.launches)
    out["collectives"] = np.asarray([mesh.counts["all_reduce"],
                                     mesh.counts["all_gather"]])
    out["seconds"] = np.asarray(wall)
    np.savez(Path(workdir) / f"mesh_rank{ranks.rank}.npz", **out)
    torch.distributed.destroy_process_group()
    return 0


def mesh_host(trace: list) -> dict:
    """A run's last state and every superstep's loss and predictions, on
    the host as float32 arrays (the generator's state left out)."""
    out = {k: v.detach().float().cpu().numpy()
           for k, v in trace[-1].items() if k not in ("generator", "seconds")}
    out["losses"] = np.concatenate([t["losses"].float().cpu().numpy()
                                    for t in trace])
    out["preds"] = np.concatenate([t["preds"].float().cpu().numpy()
                                   for t in trace])
    return out


def fmt_seconds(values) -> str:
    return " / ".join(f"{v:.3f}" for v in values)


def rel_l2(got: dict, want: dict, keys) -> float:
    """Relative L2 distance of the concatenated tensors ``keys``."""
    g = np.concatenate([np.asarray(got[k], np.float64).ravel() for k in keys])
    w = np.concatenate([np.asarray(want[k], np.float64).ravel()
                        for k in keys])
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_mesh_ranks(seed: int, rank_dir: Path) -> list:
    """(b)'s two ranks sharing the card over gloo: this script with
    ``--mesh-rank``, each writing its log beside its results."""
    rank_dir.mkdir()
    port = free_port()
    procs = []
    for r in range(2):
        with open(rank_dir / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--seed",
                 str(seed), "--mesh-rank", str(rank_dir)],
                env={**os.environ, "RANK": str(r), "WORLD_SIZE": "2",
                     "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": "2",
                     "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
                     "OMP_NUM_THREADS": "1"},
                stdout=log, stderr=subprocess.STDOUT))
    return procs


def start_mesh_cli(workdir: Path):
    """(c): the survival CLI under torch.distributed.run, two ranks over
    gloo on the card, 1 epoch on the CLI phase's cohort with its split's
    first MESH_CLI_PATIENTS training patients. Returns the process and
    its directory."""
    run_dir = workdir / "mesh_cli"
    run_dir.mkdir()
    splits = {}
    for split in ("train", "val", "test"):
        uids = (workdir / "run" / f"{split}_uids.txt").read_text().split()
        if split == "train":
            uids = uids[:MESH_CLI_PATIENTS]
        path = run_dir / f"{split}_uids.txt"
        path.write_text("\n".join(uids) + "\n")
        splits[f"{split}_uid_location"] = str(path)
    base = json.loads((workdir / "config.json").read_text())
    base["Preprocessing"] = splits
    config = run_dir / "config.json"
    config.write_text(json.dumps(base))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc_per_node", "2", "--master_addr", "localhost",
           "--master_port", str(free_port()), "-m", "mmnn_sts_torch",
           "--images", "--preop", "--survival", "--blend", "--epochs", "1",
           "--config", str(config), "--output_path", "out"]
    with open(run_dir / "stdout.log", "w") as out, \
            open(run_dir / "stderr.log", "w") as err:
        proc = subprocess.Popen(cmd, cwd=run_dir, stdout=out, stderr=err,
                                env={**os.environ, "PYTHONPATH": str(REPO)})
    return proc, run_dir


def wait_all(procs: list, timeout: float) -> list:
    """Each process's return code, waiting at most ``timeout`` seconds in
    all; a process still running then is killed."""
    end = time.perf_counter() + timeout
    try:
        return [p.wait(timeout=max(end - time.perf_counter(), 0.1))
                for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def mesh_phase(fd, seed: int, workdir: Path) -> dict:
    """The data axis of TPU.mesh_shape on the card (see the module
    docstring, phase 20): (b)'s ranks and (c)'s run start first and run
    beside (a). Returns the launches and collectives."""
    cudnn = torch.backends.cudnn
    tf32, deterministic = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32, cudnn.deterministic = False, True
    cfg, flags, weights, ds, idx = mesh_setup(seed, MESH_STEPS)
    print(f"mesh: the flagship superstep {TRAIN_MICRO} x {TRAIN_BATCH} at "
          f"{CLI_SIDE}^3 (augmented, dropout {cfg.image_model.dropout_prob}),"
          f" cudnn.allow_tf32={cudnn.allow_tf32} cudnn.deterministic="
          f"{cudnn.deterministic}; (b) and (c) in their own processes beside "
          f"(a)")
    t0 = time.perf_counter()
    rank_dir = workdir / "mesh_ranks"
    procs = start_mesh_ranks(seed, rank_dir)
    try:
        cli_proc, run_dir = start_mesh_cli(workdir)
        procs.append(cli_proc)
        results, want = mesh_one_rank(fd, cfg, flags, weights, ds, idx, seed,
                                      workdir)
        rcs = wait_all(procs, MESH_TIMEOUT)
    finally:
        wait_all(procs, 0.0)
    wall = time.perf_counter() - t0
    for r, rc in enumerate(rcs[:2]):
        if rc != 0:
            raise AssertionError(
                f"mesh (b) rank {r} returned {rc}:\n"
                f"{(rank_dir / f'rank{r}.log').read_text()[-3000:]}")
    results.update(mesh_two_ranks(cfg, flags, weights, ds, idx, seed, want,
                                  rank_dir, wall))
    mesh_cli_check(rcs[2], run_dir, flags, wall)
    cudnn.allow_tf32, cudnn.deterministic = tf32, deterministic
    return results


def mesh_one_rank(fd, cfg, flags, weights, ds, idx, seed, workdir,
                  shape=(-1,), axes=("data",), what="mesh", base=0):
    """(a): one NCCL rank in this process, eager and graphed, on the mesh
    ``shape`` over ``axes``, against the run without a process group.
    Returns its results (with the run without a process group's peak
    memory above ``base``, the bytes allocated before its phase's split,
    and ``base``) and that run."""
    from mmnn_sts_torch.ops import batch_norm
    from mmnn_sts_torch.parallel import mesh
    from mmnn_sts_torch.train import graphs

    alone = mesh_state(cfg, flags, weights, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # a mesh's ranks take the plain BatchNorm path: so does what they are
    # held against
    with batch_norm.plain_only():
        want = mesh_supersteps(alone, ds, idx, MESH_STEPS, False)
    results = {"alone_peak_bytes": torch.cuda.max_memory_allocated() - base,
               "alone_base_bytes": base}
    del alone
    env = {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0",
           "LOCAL_WORLD_SIZE": "1"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        if not mesh.maybe_initialize_distributed(
                "cuda", init_method=f"file://{workdir}/{what}_nccl_store"):
            raise AssertionError("no process group")
        ranks = mesh.make_mesh(list(shape), axes)
        if ranks.backend != "nccl":
            raise AssertionError(f"one rank on the card took {ranks.backend}")
        eager = mesh_state(cfg, flags, weights, seed, ranks)
        mesh.reset_counts()
        fd.fused_bn_relu_matmul.launches = 0
        eager_got = mesh_supersteps(eager, ds, idx, MESH_STEPS, False)
        per_step = {k: v // MESH_STEPS for k, v in mesh.counts.items()}
        eager_launches = fd.fused_bn_relu_matmul.launches // MESH_STEPS
        del eager
        graphed = mesh_state(cfg, flags, weights, seed, ranks)
        fd.fused_bn_relu_matmul.launches = 0
        t0 = time.perf_counter()
        graphed_got = mesh_supersteps(graphed, ds, idx, MESH_STEPS, True)
        torch.cuda.synchronize()
        graphed_s = time.perf_counter() - t0
        (steps,) = (v for v in graphed.graphs.values()
                    if isinstance(v, graphs.EpochSteps))
        step = steps.graphs["step"]
        del graphed
    finally:
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    results.update({"nccl_collectives_per_superstep": per_step,
                    "nccl_launches_per_capture": step.launches_per_capture,
                    "nccl_eager_launches_per_superstep": eager_launches})
    seconds = {what: [t.pop("seconds") for t in trace if "seconds" in t]
               for what, trace in (("alone", want), ("eager", eager_got),
                                   ("graphed", graphed_got))}
    total = sum(len(t) for t in want)
    label = what
    for what, got in (("eager", eager_got), ("graphed", graphed_got)):
        equal, worst = 0, {}
        for g, w in zip(got, want):
            same, diffs = group_diffs(g, w)
            equal += same
            worst = {k: max(worst.get(k, 0.0), d) for k, d in diffs.items()}
        if equal != total:
            raise AssertionError(
                f"{label} (a) one NCCL rank, {what}: {equal} of {total} "
                f"tensors bit-equal to the run without a process group; "
                f"largest differences {worst}")
    del eager_got, graphed_got
    if step.launches_per_capture != TRAIN_MICRO * 58 or step.replays < 1 \
            or eager_launches != TRAIN_MICRO * 58:
        raise AssertionError(f"{label} (a): {step.launches_per_capture} "
                             f"launches per capture, {step.replays} replays,"
                             f" {eager_launches} eager")
    print(f"{label} (a) one rank over NCCL (FileStore), TPU.mesh_shape "
          f"{list(shape)} over {list(axes)}: "
          f"eager and graphed (survival_train_epoch, {MESH_STEPS} "
          f"supersteps: warm-up, capture + replay, replay) each bit-equal "
          f"to the run without a process group in all {total} tensors "
          f"({MESH_STEPS} supersteps' states); "
          f"collectives a superstep {per_step} (one all-reduce a train-mode "
          f"BatchNorm forward and backward, one gather a microbatch, one "
          f"gradient sum); {step.launches_per_capture} launches per capture, "
          f"{step.replays} replays; graphed {graphed_s:.1f} s")
    alone = (f"no process group eager {fmt_seconds(seconds['alone'])}; "
             if seconds["alone"] else "")
    print(f"{label} (a) superstep seconds (host clock, synchronised; TF32 "
          f"off, cuDNN deterministic; other ranks running beside): {alone}"
          f"one NCCL rank eager {fmt_seconds(seconds['eager'])}; one NCCL "
          f"rank graphed (warm-up, capture + replay, replay) "
          f"{fmt_seconds(seconds['graphed'])}")
    results["superstep_seconds"] = seconds
    return results, want


_controls = {}


def one_ulp_control(cfg, flags, weights, ds, idx, seed):
    """The first superstep on volumes scaled by 1 + 2^-22 (``mesh_host``)
    and the parameters before it, on the host; computed once a seed, as
    mesh_phase's and space_phase's (b) hold their ranks against the same
    control."""
    from mmnn_sts_torch.ops import batch_norm

    if seed not in _controls:
        scaled = copy.copy(ds)
        scaled.inputs = {**ds.inputs, "image": ds.inputs["image"]
                         * (1 + 2**-22)}
        with batch_norm.plain_only():  # as a mesh's ranks take it
            control = mesh_host(mesh_supersteps(
                mesh_state(cfg, flags, weights, seed), scaled, idx,
                MESH_RANK_STEPS, False))
        before = {k: v.detach().float().cpu().numpy() for k, v in
                  state_tensors(mesh_state(cfg, flags, weights, seed),
                                torch.zeros(1), torch.zeros(1)).items()
                  if k.startswith("param ")}
        _controls[seed] = control, before
    return _controls[seed]


def mesh_two_ranks(cfg, flags, weights, ds, idx, seed, want, rank_dir,
                   wall) -> dict:
    """(b): the two gloo ranks' results against one process: (a)'s run
    without a process group, whose first supersteps are the ranks' (the
    same data and indices); the control, the same on volumes scaled by
    1 + 2^-22. The first superstep's losses and predictions come before
    any update, so only the reduction order differs: they are held at
    MESH_FIRST_LIMIT; the update after it at 4 x its control."""
    ranks_out = []
    for r in range(2):
        with np.load(rank_dir / f"mesh_rank{r}.npz") as data:
            ranks_out.append({k: data[k] for k in data.files})
    single = mesh_host(want[:MESH_RANK_STEPS])
    control, before = one_ulp_control(cfg, flags, weights, ds, idx, seed)
    params = [k for k in single if k.startswith("param ")]

    def update_dist(got):
        upd = {k: got[k] - before[k] for k in params}
        ref = {k: single[k] - before[k] for k in params}
        return rel_l2(upd, ref, params)

    def first(got):  # the first superstep's losses and predictions
        return {"losses": got["losses"][:1],
                "preds": got["preds"][:len(got["preds"]) // MESH_RANK_STEPS]}

    dist_two, dist_ctl = update_dist(ranks_out[0]), update_dist(control)
    first_two = rel_l2(first(ranks_out[0]), first(single),
                       ["losses", "preds"])
    first_ctl = rel_l2(first(control), first(single), ["losses", "preds"])
    same = all(np.array_equal(ranks_out[0][k], ranks_out[1][k])
               for k in single)
    per_rank = int(ranks_out[0]["launches"]) // MESH_RANK_STEPS
    if not (same and first_two <= MESH_FIRST_LIMIT
            and dist_two <= max(1e-5, MESH_CONTROL_FACTOR * dist_ctl)
            and per_rank == TRAIN_MICRO * 58):
        raise AssertionError(
            f"mesh (b): ranks agree {same}; first losses and predictions "
            f"rel L2 {first_two:.3e} (limit {MESH_FIRST_LIMIT:g}, one-ulp "
            f"control {first_ctl:.3e}); update rel L2 {dist_two:.3e} (control "
            f"{dist_ctl:.3e}); {per_rank} launches a rank a superstep")
    print(f"mesh (b) two ranks sharing the card over gloo (CUDA tensors "
          f"staged through the host: all_gather, all_reduce and broadcast "
          f"checked), {MESH_RANK_STEPS} eager superstep(s) at microbatch "
          f"{TRAIN_BATCH} ({TRAIN_BATCH // 2} rows a rank): {per_rank} "
          f"launches a rank a superstep, collectives a rank "
          f"{ranks_out[0]['collectives'].tolist()} (all-reduce, gather); the "
          f"ranks bit-equal to each other; against one process on the card: "
          f"the first superstep's losses and predictions rel L2 "
          f"{first_two:.3e} (limit {MESH_FIRST_LIMIT:g}; the one-ulp "
          f"control's {first_ctl:.3e}), the update rel L2 {dist_two:.3e} beside the "
          f"one-ulp control's {dist_ctl:.3e} (limit {MESH_CONTROL_FACTOR:g} "
          f"x); the ranks' supersteps {float(ranks_out[0]['seconds']):.1f} s "
          f"(beside (a) and (c)); the mesh phase's processes {wall:.1f} s")
    return {"gloo_launches_per_rank_superstep": per_rank,
            "gloo_rank_seconds": float(ranks_out[0]["seconds"])}


def mesh_cli_check(rc: int, run_dir: Path, flags: dict, wall: float,
                   what: str = "mesh", stdout_log: str = "stdout.log",
                   stderr_log: str = "stderr.log"):
    """(c)'s checks: rc 0, both ranks over gloo, one metrics row with
    finite losses and C-indices in [0, 1], the .npz loads strictly; for
    the space phase, the mesh logged over [data, space] and not
    replicated over 'space'."""
    from mmnn_sts_torch.config import parse_config
    from mmnn_sts_torch.convert import load_jax_npz
    from mmnn_sts_torch.models import build_model

    out = run_dir / "out"
    stdout = (run_dir / stdout_log).read_text()
    rows = ([json.loads(x) for x in (out / "metrics.jsonl").read_text()
             .splitlines()] if (out / "metrics.jsonl").exists() else [])
    if rc != 0 or len(rows) != 1 or not (
            np.isfinite([rows[0]["train_loss"], rows[0]["val_loss"]]).all()
            and 0.0 <= rows[0]["val_c"] <= 1.0
            and 0.0 <= rows[0]["train_c"] <= 1.0):
        raise AssertionError(
            f"{what} (c) torch.distributed.run: rc {rc}, rows {rows}\n"
            f"{stdout[-2000:]}\n"
            f"{(run_dir / stderr_log).read_text()[-3000:]}")
    load_jax_npz(build_model(parse_config(str(run_dir / "config.json")),
                             **flags), str(out / "best_surv_model.npz"))
    logged = [line for line in stdout.splitlines()
              if line.startswith("distributed:")]
    if len(logged) != 2 or not all("backend gloo" in x for x in logged):
        raise AssertionError(f"{what} (c): {logged}")
    meshes = [line.split("; ", 1)[1] for line in stdout.splitlines()
              if line.startswith("device:")]
    if what == "space" and (
            len(meshes) != 2 or "replicated over 'space'" in stdout
            or not all("over ['data', 'space']" in x for x in meshes)):
        raise AssertionError(f"space (c): {meshes}")
    counts = [line for line in stdout.splitlines()
              if line.startswith("Training count")]
    print(f"{what} (c) python -m torch.distributed.run --nproc_per_node 2 -m "
          f"mmnn_sts_torch --images --preop --survival --blend, 1 epoch on "
          f"the CLI phase's cohort, {MESH_CLI_PATIENTS} of its training "
          f"patients: rc 0 (within the {what} phase's {wall:.1f} s); "
          f"{meshes if what == 'space' else ''} "
          f"{counts[:1]}; {logged}; one metrics row (rank 0 alone writes: "
          f"two writers would append two), train loss "
          f"{rows[0]['train_loss']:.4f}, val C {rows[0]['val_c']:.3f}; the "
          f".npz loads strictly; written: "
          f"{sorted(p.name for p in out.iterdir())}")


SPACE_SHAPE = [1, 2]  # (b) and (c): [data, space] over two ranks
SPACE_MEMORY_LIMIT = 0.75  # a rank's peak memory against one process's
SPACE_MAP_TOLERANCE = 1e-3  # (c)'s Grad-CAM maps against one process's
SPACE_INFER_PATIENTS = 8  # (c)'s inference: the first of the test split


def space_rank(workdir: str, seed: int) -> int:
    """One of space_phase's (b) ranks sharing the card over gloo (started
    by ``--space-rank``): the flagship's eager superstep on this rank's
    depth slab of the resident split; saves the state's tensors, the
    launches, collectives and kernel shapes, the superstep's seconds, the
    peak memory and the slab's bytes."""
    sys.path.insert(0, str(REPO))
    from mmnn_sts_torch.data.loader import DeviceDataset
    from mmnn_sts_torch.ops import fused_dense as fd
    from mmnn_sts_torch.parallel import mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    if not mesh.maybe_initialize_distributed("cuda"):
        raise SystemExit("space rank: no torch.distributed environment")
    ranks = mesh.make_mesh(SPACE_SHAPE, ("data", "space"))
    cfg, flags, weights, ds, idx = mesh_setup(seed, MESH_RANK_STEPS)
    image = ds.inputs["image"]
    a, b = mesh.input_planes(ranks, image.shape[1])
    slab = DeviceDataset(uids=ds.uids, inputs={
        **ds.inputs, "image": image[:, a:b].contiguous()},
        events=ds.events, durations=ds.durations)
    del ds, image
    state = mesh_state(cfg, flags, weights, seed, ranks)
    shapes = set()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mesh.reset_counts()
    with kernel_shapes(fd, shapes):
        fd.fused_bn_relu_matmul.launches = 0
        t0 = time.perf_counter()
        trace = mesh_supersteps(state, slab, idx, MESH_RANK_STEPS, False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = fd.fused_bn_relu_matmul.launches
    out = mesh_host(trace)
    out["launches"] = np.asarray(launches)
    out["collectives"] = np.asarray([mesh.counts["all_reduce"],
                                     mesh.counts["all_gather"],
                                     mesh.space_counts["halo"]])
    out["shapes"] = np.asarray(sorted((m, k) for m, k, _ in shapes))
    out["seconds"] = np.asarray(wall)
    out["peak"] = np.asarray(torch.cuda.max_memory_allocated())
    out["slab_bytes"] = np.asarray(slab.inputs["image"].numel() * 4)
    out["planes"] = np.asarray([a, b])
    np.savez(Path(workdir) / f"space_rank{ranks.rank}.npz", **out)
    torch.distributed.destroy_process_group()
    return 0


def space_cli(args: list) -> int:
    """``mmnn_sts_torch.cli.main(args)`` with cuDNN's TF32 off and its
    deterministic algorithms on, as this script's phases compare: (c)'s
    inference ranks under torch.distributed.run (``--space-cli``)."""
    sys.path.insert(0, str(REPO))
    from mmnn_sts_torch.cli import main as cli_main

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    return cli_main(args)


def start_space_ranks(seed: int, rank_dir: Path) -> list:
    """(b)'s two ranks sharing the card over gloo: this script with
    ``--space-rank``."""
    rank_dir.mkdir()
    port = free_port()
    procs = []
    for r in range(2):
        with open(rank_dir / f"rank{r}.log", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, str(REPO / "chip_smoke.py"), "--seed",
                 str(seed), "--space-rank", str(rank_dir)],
                env={**os.environ, "RANK": str(r), "WORLD_SIZE": "2",
                     "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": "2",
                     "MASTER_ADDR": "localhost", "MASTER_PORT": str(port),
                     "OMP_NUM_THREADS": "1"},
                stdout=log, stderr=subprocess.STDOUT))
    return procs


def run_distributed(run_dir: Path, args: list, tag: str, entry: list):
    """``python -m torch.distributed.run`` of ``entry`` + ``args`` over two
    ranks in ``run_dir``, its output in ``<tag>.{stdout,stderr}.log``."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
           "--nproc_per_node", "2", "--master_addr", "localhost",
           "--master_port", str(free_port())] + entry + args
    with open(run_dir / f"{tag}.stdout.log", "w") as out, \
            open(run_dir / f"{tag}.stderr.log", "w") as err:
        return subprocess.Popen(cmd, cwd=run_dir, stdout=out, stderr=err,
                                env={**os.environ, "PYTHONPATH": str(REPO)})


INFER_ARGS = ["--inference", "--images", "--preop", "--survival", "--blend"]


def start_space_cli(workdir: Path):
    """(c): the survival CLI under torch.distributed.run, two ranks over
    gloo on the card, TPU.mesh_shape [1, 2] over [data, space], 1 epoch on
    the CLI phase's cohort with its split's first MESH_CLI_PATIENTS
    training patients; beside it, the same ranks' --inference with
    Grad-CAM of the split's first SPACE_INFER_PATIENTS test patients on
    the CLI phase's best weights (this script's --space-cli). Returns the
    two processes and their directory."""
    run_dir = workdir / "space_cli"
    run_dir.mkdir()
    splits = {}
    for split, cut in (("train", MESH_CLI_PATIENTS), ("val", None),
                       ("test", SPACE_INFER_PATIENTS)):
        uids = (workdir / "run" / f"{split}_uids.txt").read_text().split()
        path = run_dir / f"{split}_uids.txt"
        path.write_text("\n".join(uids[:cut]) + "\n")
        splits[f"{split}_uid_location"] = str(path)
    mesh_tpu = {"mesh_axes": ["data", "space"], "mesh_shape": SPACE_SHAPE}
    for name, source in (("config", "config"), ("infer_one_config",
                                                  "trained")):
        config = json.loads((workdir / f"{source}.json").read_text())
        config["Preprocessing"] = splits
        (run_dir / f"{name}.json").write_text(json.dumps(config))
        if name == "infer_one_config":
            config.setdefault("TPU", {}).update(mesh_tpu)
            (run_dir / "infer_config.json").write_text(json.dumps(config))
    config = json.loads((run_dir / "config.json").read_text())
    config.setdefault("TPU", {}).update(mesh_tpu)
    (run_dir / "config.json").write_text(json.dumps(config))
    train = run_distributed(run_dir, [
        "--images", "--preop", "--survival", "--blend", "--epochs", "1",
        "--config", "config.json", "--output_path", "out"], "train",
        ["-m", "mmnn_sts_torch"])
    infer = run_distributed(run_dir, INFER_ARGS + [
        "--config", "infer_config.json", "--output_path", "infer"],
        "infer", [str(REPO / "chip_smoke.py"), "--space-cli"])
    return [train, infer], run_dir


def space_phase(fd, seed: int, workdir: Path) -> dict:
    """The space axis of TPU.mesh_shape on the card (see the module
    docstring, phase 21): (b)'s ranks and (c)'s training and inference
    start first and run beside (a) and one process's inference. Returns
    the launches, collectives and peaks."""
    from mmnn_sts_torch.cli import main as cli_main

    cudnn = torch.backends.cudnn
    tf32, deterministic = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32, cudnn.deterministic = False, True
    base = torch.cuda.memory_allocated()
    cfg, flags, weights, ds, idx = mesh_setup(seed, MESH_STEPS)
    print(f"space: the flagship superstep {TRAIN_MICRO} x {TRAIN_BATCH} at "
          f"{CLI_SIDE}^3 (augmented, dropout {cfg.image_model.dropout_prob}),"
          f" cudnn.allow_tf32={cudnn.allow_tf32} cudnn.deterministic="
          f"{cudnn.deterministic}; (b) and (c) in their own processes beside "
          f"(a)")
    t0 = time.perf_counter()
    rank_dir = workdir / "space_ranks"
    procs = start_space_ranks(seed, rank_dir)
    try:
        cli_procs, run_dir = start_space_cli(workdir)
        procs += cli_procs
        results, want = mesh_one_rank(
            fd, cfg, flags, weights, ds, idx, seed, workdir, shape=(1, 1),
            axes=("data", "space"), what="space", base=base)
        t_one = time.perf_counter()
        cwd = os.getcwd()
        os.chdir(run_dir)
        try:
            rc_one = cli_main(INFER_ARGS + [
                "--config", "infer_one_config.json", "--output_path",
                "infer_one"])
        finally:
            os.chdir(cwd)
        one_s = time.perf_counter() - t_one
        rcs = wait_all(procs, MESH_TIMEOUT)
    finally:
        wait_all(procs, 0.0)
    wall = time.perf_counter() - t0
    for r, rc in enumerate(rcs[:2]):
        if rc != 0:
            raise AssertionError(
                f"space (b) rank {r} returned {rc}:\n"
                f"{(rank_dir / f'rank{r}.log').read_text()[-3000:]}")
    results.update(space_two_ranks(fd, cfg, flags, weights, ds, idx, seed,
                                   want, rank_dir, results))
    mesh_cli_check(rcs[2], run_dir, flags, wall, what="space",
                   stdout_log="train.stdout.log",
                   stderr_log="train.stderr.log")
    results.update(space_infer_check(rcs[3], rc_one, run_dir, one_s))
    print(f"space phase: its processes {wall:.1f} s")
    cudnn.allow_tf32, cudnn.deterministic = tf32, deterministic
    return results


def space_two_ranks(fd, cfg, flags, weights, ds, idx, seed, want, rank_dir,
                    alone: dict) -> dict:
    """(b): the two gloo ranks' results against one process (as mesh_phase's
    (b): the first superstep's losses and predictions at MESH_FIRST_LIMIT,
    the update at 4 x its one-ulp control), each rank's peak memory
    below SPACE_MEMORY_LIMIT x one process's, 464 launches a rank, and
    the kernel against the plain version at every (M, K) the ranks
    called it with. One process's peak is ``alone``'s: the bytes its
    superstep peaked at above those allocated before its phase's split,
    since a rank's process holds no earlier phase's tensors."""
    alone_peak, base = alone["alone_peak_bytes"], alone["alone_base_bytes"]
    ranks_out = []
    for r in range(2):
        with np.load(rank_dir / f"space_rank{r}.npz") as data:
            ranks_out.append({k: data[k] for k in data.files})
    single = mesh_host(want[:MESH_RANK_STEPS])
    control, before = one_ulp_control(cfg, flags, weights, ds, idx, seed)
    params = [k for k in single if k.startswith("param ")]

    def update_dist(got):
        return rel_l2({k: got[k] - before[k] for k in params},
                      {k: single[k] - before[k] for k in params}, params)

    def first(got):
        return {"losses": got["losses"][:1],
                "preds": got["preds"][:len(got["preds"]) // MESH_RANK_STEPS]}

    dist_two, dist_ctl = update_dist(ranks_out[0]), update_dist(control)
    first_two = rel_l2(first(ranks_out[0]), first(single),
                       ["losses", "preds"])
    first_ctl = rel_l2(first(control), first(single), ["losses", "preds"])
    same = all(np.array_equal(ranks_out[0][k], ranks_out[1][k])
               for k in single)
    per_rank = [int(r["launches"]) // MESH_RANK_STEPS for r in ranks_out]
    peaks = [int(r["peak"]) for r in ranks_out]
    slab = [int(r["slab_bytes"]) for r in ranks_out]
    whole = ds.inputs["image"].numel() * 4
    shapes = sorted({tuple(int(v) for v in row) for r in ranks_out
                     for row in r["shapes"]})
    gen = torch.Generator(device="cuda").manual_seed(seed + 31)
    worst = 0.0
    for m, k in shapes:
        x, a, b, w = operands(gen, m, k, torch.float32)
        worst = max(worst, check_call(fd, x, a, b, w, TOLERANCE["float32"],
                                      f"space rank M={m} K={k}")[0])
    ok = (same and first_two <= MESH_FIRST_LIMIT
          and dist_two <= max(1e-5, MESH_CONTROL_FACTOR * dist_ctl)
          and per_rank == [TRAIN_MICRO * 58] * 2
          and all(p < SPACE_MEMORY_LIMIT * alone_peak for p in peaks))
    if not ok:
        raise AssertionError(
            f"space (b): ranks agree {same}; first losses and predictions "
            f"rel L2 {first_two:.3e} (limit {MESH_FIRST_LIMIT:g}, one-ulp "
            f"control {first_ctl:.3e}); update rel L2 {dist_two:.3e} "
            f"(control {dist_ctl:.3e}); launches a rank {per_rank}; peaks "
            f"{peaks} against one process's {alone_peak}")
    counts = ranks_out[0]["collectives"].tolist()
    gib = 2.0 ** 30
    print(f"space (b) two ranks sharing the card over gloo, TPU.mesh_shape "
          f"{SPACE_SHAPE} over ['data', 'space'] (planes "
          f"{ranks_out[0]['planes'].tolist()} and "
          f"{ranks_out[1]['planes'].tolist()} of {CLI_SIDE}), "
          f"{MESH_RANK_STEPS} eager superstep(s) of {TRAIN_MICRO} x "
          f"{TRAIN_BATCH}: {per_rank[0]} launches a rank a superstep; a "
          f"superstep's collectives a rank {counts[0]} all-reduces, "
          f"{counts[1]} all-gathers, of which {counts[2]} halo exchanges; "
          f"the ranks bit-equal to each other; against one process on the "
          f"card: the first superstep's losses and predictions rel L2 "
          f"{first_two:.3e} (limit {MESH_FIRST_LIMIT:g}; the one-ulp "
          f"control's {first_ctl:.3e}), the update rel L2 {dist_two:.3e} "
          f"beside the one-ulp control's {dist_ctl:.3e} (limit "
          f"{MESH_CONTROL_FACTOR:g} x); superstep seconds a rank "
          f"{fmt_seconds([float(r['seconds']) for r in ranks_out])}; peak "
          f"memory a rank {peaks[0] / gib:.2f} / {peaks[1] / gib:.2f} GiB "
          f"against one process's {alone_peak / gib:.2f} GiB (ratio "
          f"{max(peaks) / alone_peak:.3f}, limit {SPACE_MEMORY_LIMIT:g}; "
          f"its peak above the {base / gib:.2f} GiB allocated before its "
          f"split, {(alone_peak + base) / gib:.2f} GiB in all); "
          f"the resident split's images a rank {slab[0] / 2**20:.1f} MiB "
          f"against {whole / 2**20:.1f} MiB; the kernel against the plain "
          f"version at the ranks' {len(shapes)} (M, K) shapes (M "
          f"{min(m for m, _ in shapes)} .. {max(m for m, _ in shapes)}), "
          f"max abs err {worst:.2e}")
    return {"gloo_space_launches_per_rank_superstep": per_rank[0],
            "gloo_space_collectives": counts,
            "gloo_space_rank_seconds": float(ranks_out[0]["seconds"]),
            "space_peak_ratio": max(peaks) / alone_peak,
            "space_shapes": len(shapes)}


def space_infer_check(rc_infer: int, rc_one: int, run_dir: Path,
                      one_s: float) -> dict:
    """(c)'s inference: rc 0 both, one prediction CSV and one
    attention_maps tree (rank 0 alone writes), every map within
    SPACE_MAP_TOLERANCE of one process's, the predictions within 1e-5."""
    from mmnn_sts_torch.data.nifti import load_nifti

    two, one = run_dir / "infer", run_dir / "infer_one"
    err = (run_dir / "infer.stderr.log").read_text()
    if rc_infer != 0 or rc_one != 0:
        raise AssertionError(f"space (c) inference: rc {rc_infer} (two "
                             f"ranks), {rc_one} (one process)\n{err[-3000:]}")
    maps = sorted(p.relative_to(two) for p in two.rglob("att_map*.nii*"))
    want = sorted(p.relative_to(one) for p in one.rglob("att_map*.nii*"))
    if not maps or maps != want:
        raise AssertionError(f"space (c): maps {len(maps)} against one "
                             f"process's {len(want)}")
    worst = max(float(np.abs(load_nifti(str(two / p))
                             - load_nifti(str(one / p))).max())
                for p in maps)
    _, got = read_csv_rows(two / "survival_model_predictions.csv")
    _, ref = read_csv_rows(one / "survival_model_predictions.csv")
    pred_err = float(np.abs(got - ref).max())
    if worst > SPACE_MAP_TOLERANCE or pred_err > 1e-5:
        raise AssertionError(f"space (c): maps {worst:.3e} from one "
                             f"process's (limit {SPACE_MAP_TOLERANCE:g}), "
                             f"predictions {pred_err:.3e}")
    print(f"space (c) --inference --survival --blend with Grad-CAM under "
          f"torch.distributed.run over {SPACE_SHAPE} [data, space] (2 gloo "
          f"ranks, TF32 off, cuDNN deterministic; rank 0 writes) on the "
          f"test split's first {SPACE_INFER_PATIENTS} patients, the CLI "
          f"phase's best weights: {len(maps)} maps, "
          f"max |two ranks - one process| {worst:.2e} (limit "
          f"{SPACE_MAP_TOLERANCE:g}), predictions {pred_err:.2e}; one "
          f"process's inference {one_s:.1f} s")
    return {"space_map_err": worst}


# every phase in the order it runs, with the phases whose results or
# files it reads
PHASES = {
    "kernel_phase": (),
    "sweep_phase": (),
    "wide_kernel_phase": (),
    "serve_phase": (),
    "backward_phase": (),
    "train_phase": (),
    "bf16_train_phase": (),
    "families_phase": (),
    "remat_phase": (),
    "fused_epoch_phase": (),
    "planar_phase": (),
    "stamp_phase": (),
    "batch_norm_phase": (),
    "cli_phase": (),
    "infer_phase": ("cli_phase",),
    "fused_cli_phase": ("cli_phase", "infer_phase"),
    "bf16_cli_phase": ("cli_phase",),
    "wide_cli_phase": ("cli_phase",),
    "dicom_cli_phase": ("cli_phase",),
    "s3_cli_phase": ("cli_phase", "dicom_cli_phase"),
    "mesh_phase": ("cli_phase",),
    "space_phase": ("cli_phase",),
}


def selected_phases(arg: str) -> set:
    """The phases ``--phases`` names, with every phase they need; all of
    them when it names none. An unknown name raises."""
    names = [n.strip() for n in arg.split(",") if n.strip()]
    unknown = [n for n in names if n not in PHASES]
    if unknown:
        raise SystemExit(f"chip_smoke: unknown phases {unknown}; "
                         f"known: {', '.join(PHASES)}")
    if not names:
        return set(PHASES)
    run, todo = set(), list(names)
    while todo:
        name = todo.pop()
        if name not in run:
            run.add(name)
            todo.extend(PHASES[name])
    return run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="",
                    help="comma-separated phases to run (with the phases "
                         "they need); default: every phase")
    ap.add_argument("--mesh-rank", default="", help=argparse.SUPPRESS)
    ap.add_argument("--space-rank", default="", help=argparse.SUPPRESS)
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--space-cli"]:  # space_phase's inference ranks
        return space_cli(argv[1:])
    args = ap.parse_args(argv)
    if args.mesh_rank:  # one of mesh_phase's ranks, started by it
        return mesh_rank(args.mesh_rank, args.seed)
    if args.space_rank:  # one of space_phase's (b) ranks
        return space_rank(args.space_rank, args.seed)
    run = selected_phases(args.phases)

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available")
    sys.path.insert(0, str(REPO))
    from mmnn_sts_torch.kernels import build
    from mmnn_sts_torch.ops import fused_dense as fd

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"device: {name} x{torch.cuda.device_count()}; torch "
          f"{torch.__version__} CUDA {torch.version.cuda}")
    print(smi)
    # float32 matmuls in full float32 (the plain op's reference product);
    # cuDNN convolutions keep PyTorch's default (TF32 allowed)
    torch.backends.cuda.matmul.allow_tf32 = False
    import importlib.util

    print("host packages: " + json.dumps({
        m: bool(importlib.util.find_spec(m))
        for m in ("pandas", "matplotlib", "yaml")}))
    print(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as ex:
        # the host library of the cohort build (g++) beside the kernels
        host = ex.submit(build.build_host, "mmnn_native")
        libs = build.build_all()
        host_lib = host.result()
    print(f"build: {len(libs)} kernel libraries and the host library "
          f"{host_lib.name} in {time.perf_counter() - t0:.1f} s")
    for lib in libs.values():
        log = lib.with_suffix(".log")
        if log.exists():
            print(log.read_text().strip())

    last = [time.perf_counter()]

    def lap(name: str):
        """Print the host seconds since the previous lap."""
        now = time.perf_counter()
        print(f"{name}: {now - last[0]:.1f} s")
        last[0] = now

    res = {}
    out_dir = REPO / "chiprun_out"
    alone = {
        "kernel_phase": lambda: kernel_phase(fd, args.seed, out_dir),
        "sweep_phase": lambda: sweep_phase(fd, args.seed, out_dir),
        "wide_kernel_phase": lambda: wide_kernel_phase(fd, args.seed,
                                                       out_dir),
        "backward_phase": lambda: backward_phase(fd, args.seed, out_dir),
        "train_phase": lambda: train_phase(fd, args.seed),
        "bf16_train_phase": lambda: bf16_train_phase(fd, args.seed),
        "families_phase": lambda: families_phase(fd, args.seed),
        "remat_phase": lambda: remat_phase(fd, args.seed),
        "fused_epoch_phase": lambda: fused_epoch_phase(fd, args.seed),
        "planar_phase": lambda: planar_phase(fd, args.seed),
        "stamp_phase": lambda: stamp_phase(fd, args.seed),
        "batch_norm_phase": lambda: batch_norm_phase(fd, args.seed),
    }
    for phase in PHASES:
        if phase == "serve_phase" and phase in run:
            with tempfile.TemporaryDirectory() as tmp:
                res[phase] = serve_phase(fd, args.seed, Path(tmp))
            lap(phase)
        elif phase in alone and phase in run:
            res[phase] = alone[phase]()
            lap(phase)
    with tempfile.TemporaryDirectory() as tmp:
        work = Path(tmp)
        in_dir = {
            "cli_phase": lambda: cli_phase(fd, args.seed, work),
            "infer_phase": lambda: infer_phase(fd, args.seed, work),
            "fused_cli_phase": lambda: fused_cli_phase(
                fd, args.seed, work, res["cli_phase"]["per_epoch"]),
            "bf16_cli_phase": lambda: bf16_cli_phase(fd, args.seed, work),
            "wide_cli_phase": lambda: wide_cli_phase(fd, args.seed, work),
            "dicom_cli_phase": lambda: dicom_cli_phase(fd, args.seed, work),
            "s3_cli_phase": lambda: s3_cli_phase(
                fd, args.seed, work, res["dicom_cli_phase"]["root"]),
            "mesh_phase": lambda: mesh_phase(fd, args.seed, work),
            "space_phase": lambda: space_phase(fd, args.seed, work),
        }
        for phase in PHASES:
            if phase in in_dir and phase in run:
                res[phase] = in_dir[phase]()
                lap(phase)
    print(json.dumps({"kernels": kernels_line(res)}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


def kernels_line(res: dict) -> list:
    """The kernels' entries from the phases that ran (None where the
    phase that measures a number did not run)."""
    def get(phase, *keys):
        value = res.get(phase)
        for key in keys:
            if value is None:
                return None
            value = value[key]
        return value

    def total(values):
        """The sum of ``values``; None where there are none (its phase
        did not run)."""
        values = list(values)
        return sum(values) if values else None

    def mean(values):
        values = list(values)
        return sum(values) / len(values) if values else None

    def bound_by(path):
        if not path:
            return None
        return max(("bytes", "operations"), key=lambda by: sum(
            r["bound_ms"] for r in path if r["bound_by"] == by))

    rows = res.get("kernel_phase") or []
    backward = res.get("backward_phase") or []
    main_path = [r for r in rows if r["batch"] == 8 and r["dtype"] == "float32"]
    bf16_path = [r for r in rows
                 if r["batch"] == 8 and r["dtype"] == "bfloat16"]
    entry = {
        "name": "fused_bn_relu_matmul",
        "route": "cuda",
        "source": "mmnn_sts_torch/kernels/csrc/fused_bn_relu_matmul.cu",
        "replaces": "mmnn_sts_tpu/ops/pallas/fused_dense.py:58",
        "launches": res.get("serve_phase"),
        # one served batch-8 forward: the sum over its 58 calls
        "max_abs_err": max((r["max_abs_err"] for r in rows
                            if r["dtype"] == "float32"), default=None),
        "ms": total(r["ms"] for r in main_path),
        "plain_ms": total(r["plain_ms"] for r in main_path),
        "bound_ms": total(r["bound_ms"] for r in main_path),
        "bound_by": bound_by(main_path),
        "library_ms": None,  # no single PyTorch call computes this function
        # torch.matmul(h, w) on a precomputed h: the product alone
        "gemm_ms": total(r["gemm_ms"] for r in main_path),
        "host_us_per_call": mean(r["host_us"] for r in main_path),
        # the flagship training superstep: 58 calls per microbatch x 8
        "launches_per_superstep": res.get("train_phase"),
        # the CLI run: 3 epochs of 2 supersteps (464 each) and one
        # validation forward (58)
        "launches_cli_run": get("cli_phase", "launches"),
        "launches_per_cli_epoch": get("cli_phase", "per_epoch"),
        # --inference of the 15 test patients: 58 x (1 eval step + 2 x 15:
        # each patient's Grad-CAM forward and its own forward); the same
        # for classification with one forward a patient; a classification
        # epoch: (9 steps + 1 validation forward) x 58
        "launches_inference_survival": get("infer_phase", "survival"),
        "launches_inference_classification": get("infer_phase",
                                                     "classification"),
        "launches_per_classification_epoch": get(
            "infer_phase", "per_classification_epoch"),
        # its backward (the JAX package's _bwd in plain PyTorch), the sum
        # over the 58 shapes of one microbatch of 8
        "backward_ms": total(r["ms"] for r in backward),
        "backward_plain_ms": total(r["plain_ms"] for r in backward),
        "backward_bound_ms": total(r["bound_ms"] for r in backward),
        "backward_max_rel_err": max((r["max_rel_err"] for r in backward),
                                    default=None),
        # the kernel's launches in one eval forward of each image model
        # (the families phase; 0 where the model has no bottleneck)
        "launches_per_forward_by_model": None if "families_phase" not in res
        else {"densenet121": res["train_phase"] // TRAIN_MICRO
              if "train_phase" in res else None,
              **{k: v["per_forward"]
                 for k, v in res["families_phase"].items()}},
        # TPU.remat: the flagship superstep, each wrapped bottleneck's
        # forward run again in the backward (8 x (58 + 57))
        "launches_remat_superstep": get("remat_phase", "launches"),
        # --lr_finder on the flagship: 100 one-microbatch supersteps x 58
        "launches_lr_finder": get("wide_cli_phase", "lr_finder"),
        # the image-only densenet201 CLI run: 1 epoch of 2 supersteps
        # (8 x 98) and one validation forward (98) each
        "launches_densenet201_cli_run": get("wide_cli_phase", "launches"),
        # densenet264's 130 calls at batch 8: the sums as for DenseNet121's
        "densenet264_ms": get("wide_kernel_phase", "float32", "ms"),
        "densenet264_plain_ms": get("wide_kernel_phase", "float32",
                                    "plain_ms"),
        "densenet264_bound_ms": get("wide_kernel_phase", "float32",
                                    "bound_ms"),
        "densenet264_gemm_ms": get("wide_kernel_phase", "float32",
                                   "gemm_ms"),
        # TPU.fused_epoch: the launches the wrapper counts while a CUDA
        # graph of the flagship superstep is captured (its replays launch
        # the same kernels without the wrapper), with augmentation and
        # with remat, and the replays timed; the fused CLI run's step,
        # tail and validation graphs
        "launches_per_capture_superstep": get(
            "fused_epoch_phase", "fp32 + aug", "launches_per_capture"),
        "launches_per_capture_remat_superstep": get(
            "fused_epoch_phase", "fp32 remat", "launches_per_capture"),
        "replays_timed_superstep": get("fused_epoch_phase", "fp32 + aug",
                                       "replays"),
        "launches_per_capture_cli": get("fused_cli_phase", "per_capture"),
        # spatial_dims 2: the kernel's launches in one eval forward of each
        # 2D family at (8, 64, 64, 2) (0 where there is no bottleneck)
        "launches_planar_forward_by_model": None
        if "planar_phase" not in res else {
            k: v["per_forward"] for k, v in res["planar_phase"].items()
            if isinstance(v, dict) and "per_forward" in v},
        # the data axis: the flagship superstep captured over one NCCL rank
        # (its collectives a superstep), and one of two ranks sharing the
        # card over gloo (4 rows a microbatch)
        "launches_per_capture_nccl_rank": get("mesh_phase",
                                              "nccl_launches_per_capture"),
        "collectives_per_superstep_nccl_rank": get(
            "mesh_phase", "nccl_collectives_per_superstep"),
        "launches_per_superstep_gloo_rank": get(
            "mesh_phase", "gloo_launches_per_rank_superstep"),
        # the space axis: one of two ranks sharing the card over gloo, each
        # holding half of every volume's depth planes (M halved, the shapes
        # of batch 4); its collectives a superstep (all-reduces,
        # all-gathers, of which halo exchanges) and peak memory against
        # one process's
        "launches_per_superstep_gloo_space_rank": get(
            "space_phase", "gloo_space_launches_per_rank_superstep"),
        "collectives_per_superstep_gloo_space_rank": get(
            "space_phase", "gloo_space_collectives"),
        "peak_memory_ratio_space_rank": get("space_phase",
                                            "space_peak_ratio"),
        # the 58 calls at the 2D flagship's (8, 64, 64) and at one of two
        # ranks' 4 rows of a 3D microbatch (batch 4 of kernel_phase)
        "planar_ms": get("planar_phase", "kernel_58", "float32", "ms"),
        "planar_plain_ms": get("planar_phase", "kernel_58", "float32",
                               "plain_ms"),
        "planar_bound_ms": get("planar_phase", "kernel_58", "float32",
                               "bound_ms"),
        "per_rank_of_two_ms": total(r["ms"] for r in rows if r["batch"] == 4
                                  and r["dtype"] == "float32"),
    }
    # TPU.compute_dtype bfloat16: the tensor-core kernel. Its 58 calls of one
    # batch-8 forward against the plain op, cuBLAS's product alone and the
    # bound; its launches in the bfloat16 served forward (every call of the
    # bfloat16 phases is checked to have bfloat16 x and w), the bfloat16
    # superstep (58 x 8), a bfloat16 CLI epoch (2 supersteps and one
    # validation forward) and its --inference with Grad-CAM
    # (58 x (1 + 2 x 15 patients))
    bf16_entry = {
        "name": "fused_bn_relu_matmul_bf16",
        "route": "cuda",
        "source": "mmnn_sts_torch/kernels/csrc/fused_bn_relu_matmul_bf16.cu",
        "replaces": "mmnn_sts_tpu/ops/pallas/fused_dense.py:58",
        "launches": get("bf16_cli_phase", "served"),
        "max_abs_err": max((r["max_abs_err"] for r in rows
                            if r["dtype"] == "bfloat16"), default=None),
        "ms": total(r["ms"] for r in bf16_path),
        "plain_ms": total(r["plain_ms"] for r in bf16_path),
        "bound_ms": total(r["bound_ms"] for r in bf16_path),
        "bound_by": bound_by(bf16_path),
        "library_ms": None,  # no single PyTorch call computes this function
        # torch.matmul(h, w) on a precomputed h: the product alone
        "gemm_ms": total(r["gemm_ms"] for r in bf16_path),
        "host_us_per_call": mean(r["host_us"] for r in bf16_path),
        "ms_batch32": total(r["ms"] for r in rows if r["batch"] == 32
                          and r["dtype"] == "bfloat16"),
        "launches_per_superstep": get("bf16_train_phase", "launches"),
        "launches_per_cli_epoch": get("bf16_cli_phase", "per_epoch"),
        "launches_inference_survival": get("bf16_cli_phase", "inference"),
        # the kernel's 464 calls in one graphed bf16 superstep
        "superstep_fused_ms": get("fused_epoch_phase", "bf16 + aug",
                                  "fused_kernel_ms"),
        "densenet264_ms": get("wide_kernel_phase", "bfloat16", "ms"),
        "densenet264_plain_ms": get("wide_kernel_phase", "bfloat16",
                                    "plain_ms"),
        "densenet264_bound_ms": get("wide_kernel_phase", "bfloat16",
                                    "bound_ms"),
        "densenet264_gemm_ms": get("wide_kernel_phase", "bfloat16",
                                   "gemm_ms"),
        "launches_per_capture_superstep": get(
            "fused_epoch_phase", "bf16 + aug", "launches_per_capture"),
        "replays_timed_superstep": get("fused_epoch_phase", "bf16 + aug",
                                       "replays"),
        "planar_ms": get("planar_phase", "kernel_58", "bfloat16", "ms"),
        "planar_plain_ms": get("planar_phase", "kernel_58", "bfloat16",
                               "plain_ms"),
        "planar_bound_ms": get("planar_phase", "kernel_58", "bfloat16",
                               "bound_ms"),
        "per_rank_of_two_ms": total(r["ms"] for r in rows if r["batch"] == 4
                                  and r["dtype"] == "bfloat16"),
    }
    # the device phase stamps: one thread writes the global timer into the
    # row a device slot names; launches of the kernel's own check, and per
    # graphed flagship superstep (the capture's; replays launch nothing)
    stamp_entry = {
        "name": "span_stamp",
        "route": "cuda",
        "source": "mmnn_sts_torch/kernels/csrc/span_stamp.cu",
        "replaces": None,  # no TPU kernel: a CUDA graph hides host ranges
        "launches": get("stamp_phase", "launches_direct"),
        # a timer write has no plain version, product or byte bound
        "max_abs_err": None, "ms": get("stamp_phase", "stamp_ms"),
        "plain_ms": None, "bound_ms": None, "bound_by": None,
        "library_ms": None,
        "launches_per_capture_superstep": get("stamp_phase", "float32",
                                              "launches_per_capture"),
        "launches_per_replay": get("stamp_phase", "float32",
                                   "replay_launches"),
        "max_rel_gap_to_events": max(
            (get("stamp_phase", d, "max_rel_gap")
             for d in ("float32", "bfloat16")), default=None)
        if "stamp_phase" in res else None,
    }
    # the BatchNorm kernels: one DenseNet121 microbatch's calls, forward
    # and backward (bf16; the fp32 figures in the phase's lines)
    bn_entry = {
        "name": "batch_norm",
        "route": "cuda",
        "source": "mmnn_sts_torch/kernels/csrc/batch_norm.cu",
        "replaces": None,  # no TPU kernel: XLA fuses BatchNorm there
        "launches": get("batch_norm_phase", "bfloat16", "launches"),
        # against float64, both dtypes
        "max_abs_err": max((get("batch_norm_phase", d, "max_abs_err")
                            for d in ("float32", "bfloat16")), default=None)
        if "batch_norm_phase" in res else None,
        "ms": get("batch_norm_phase", "bfloat16", "ms"),
        "plain_ms": get("batch_norm_phase", "bfloat16", "plain_ms"),
        "bound_ms": get("batch_norm_phase", "bfloat16", "bound_ms"),
        "bound_by": "bytes" if "batch_norm_phase" in res else None,
        "library_ms": None,
        "float32_ms": get("batch_norm_phase", "float32", "ms"),
        "float32_plain_ms": get("batch_norm_phase", "float32", "plain_ms"),
        "launches_per_capture_superstep": get(
            "batch_norm_phase", "bfloat16", "launches_per_capture"),
    }
    return [entry, bf16_entry, stamp_entry, bn_entry]


if __name__ == "__main__":
    raise SystemExit(main())
