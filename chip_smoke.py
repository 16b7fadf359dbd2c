"""Drive the PyTorch/CUDA port on one GPU and check every kernel.

    python3 chip_smoke.py
    python3 chip_smoke.py --dispatch-ab
    python3 chip_smoke.py --modes
    python3 chip_smoke.py --tf32-shapes
    python3 chip_smoke.py --tf32-tiles
    python3 chip_smoke.py --ieee-gram-shapes
    python3 chip_smoke.py --spatial
    python3 chip_smoke.py --spatial-cards
    python3 chip_smoke.py --batch-mesh
    python3 chip_smoke.py --batch-cards
    python3 chip_smoke.py --lbfgs-ring

The third form builds the kernels and runs only the kernel-mode check
(phase 4b below) and what ``mixed`` moves to IEEE fp32 (the end of
phase 5b). The fourth builds and prints only the TF32 kernels' line per
512x512 shape (the end of phase 4b), with nothing but the wrappers'
public calls, so that an older tree's kernels can be timed by the same
lines. The fifth times the TF32 conv's two tile candidates, 128- and
256-pixel tiles, at every 512x512 shape read through descriptors. The
sixth builds and prints only the IEEE Gram's line per 512x512 tap,
alone and at S = 4 in one launch (kernel ms against ``torch.mm`` /
``torch.bmm`` fp32 and the fp32 bound), with the wrappers' public
calls alone, so that an older tree's kernel is timed by the same
lines. The seventh builds and runs only the spatial phase and its
kernel check (12f, 12g below); the eighth only the phase, with NCCL
ranks one card each (it needs 4 cards). The ninth builds and runs only
the batch-over-cards phase and its kernel check (12h, 12i below); the
tenth only the phase, with NCCL ranks one card each (it needs 4
cards), with 10-step runs for the rates. The eleventh builds and runs
only the L-BFGS ring kernels' check (17b below) and prints their JSON
entries. The second form runs two graphed A/Bs
alone, rounds interleaved, and checks nothing else:
``steps_per_dispatch`` 1 against 0 (one dispatch of 25) on the
512x512 main path through the runner and on the S = 4 batch with a
CSV row a step; and the regional phase's run with a CSV row every
step against every 20 (40 steps), with its device ms per
step from ``torch.profiler`` (a 40-step run less a 20-step run).

Phases, one line each, in order; any failure raises and the script
exits non-zero:

1. card: name and power limit from ``nvidia-smi``;
2. build: the five CUDA sources under
   ``style_transfer_visualizer_tpu_torch/csrc/`` with ``nvcc`` for
   ``sm_90a``, with each library's count of ``HGMMA`` instructions
   (``wgmma`` on the tensor cores) from ``cuobjdump -sass`` where the
   toolkit has it (none in ``conv3x3_ieee``, on the CUDA cores: no
   ``HGMMA`` or ``HMMA`` there, and no spills in its ptxas report); the
   TF32 kernels (``conv3x3_tf32``, ``gram``'s ``gram_tf32_kernel``)
   with ``HGMMA``, their registers, and no spills; ``gram``'s IEEE
   kernel (``gram_ieee_kernel``) with its registers, no spills, and no
   ``HGMMA`` or ``HMMA`` in its own SASS; ``lbfgs_ring``'s two kernels
   with their registers and no spills, the products kernel with
   ``HMMA`` (``mma.sync``);
3. conv check: the conv kernel against its plain PyTorch version at
   every conv shape of the 512x512 main path, of the objective phase's
   1024x1024 steps and of the batch phase's 512x512 steps at N = 4
   (forward fused and unfused, the fused-mask input gradient against
   the plain masked version, the autograd input gradient against
   cuDNN's), max-abs error relative to the reference's largest
   magnitude <= 1e-4, with times; at N > 1 each image's output and
   input gradient bit-equal to its launch alone; checked only: a batch
   of 2, and VGG19's stack at a 528x960 coarse level (a 1080x1920
   content's; widths that are not powers of two). VGG16's 512x512 shapes are
   confirmed to be among the checked ones;
4. Gram check: the same at the five Gram shapes of each size (P up to
   1,048,576 at 1024x1024), forward and backward, with and without an
   active clamp; then the batched launch (one launch for S images):
   S = 4 at the five 512x512 shapes (timed against ``torch.bmm``) and
   at the 528x960 coarse level's, where P is not a multiple of the
   kernel's 32-row slot, each image against its plain Gram and
   bit-equal to the single launch on that image, and S = 1 too;
4b. mode check: each kernel's two other modes (``ops/precision.py``),
   IEEE fp32 and TF32, against that mode's plain version (the fp32
   conv or product; that of tf32-rounded operands) at every shape set
   the script drives (conv: 512, 1024, N = 4, the 2048 level's first
   two, 1280x720, forward with and without ReLU and the masked input
   gradient; Gram: 512, 1024, S = 4 in one launch, the 2048 level's
   first tap, 1280x720, with and without an active clamp, each batched
   image bit-equal to the mode's single launch), within 1e-4; timed
   beside the plain version and cuDNN / ``torch.mm`` (fp32 for IEEE,
   TF32 on for TF32), two graph-timed calls a timing. Both conv modes
   also: at N = 4 and through VGG19's stack at a 528x960 batch of 2
   (checked only), each image's output and masked input gradient
   bit-equal to its launch alone; the IEEE conv one line per 512x512
   shape, forward and input gradient, kernel ms against the fp32 bound
   and cuDNN; then the TF32 conv's and the five TF32 Grams' line per
   512x512 shape (forward, and the input gradient as the main path runs
   it), kernel ms against the TF32 bound and cuDNN / ``torch.mm`` with
   TF32 on, and the five IEEE Grams' line per tap, alone and at S = 4,
   against the fp32 bound and ``torch.mm`` / ``torch.bmm`` fp32, from
   graphs of 5 calls replayed twice;
5. main path: ``run_style_transfer`` at 512x512 on full-width VGG19
   (seeded weights, shipped defaults) for 20 L-BFGS steps through the
   port's runner (no progress bar), with the launch counts set to 0
   just before and read just after;
5b. precision: the main path at each tier (``highest``, ``mixed``,
   ``high``, ``default``, through ``config.hardware.precision``): losses
   decreasing, launches by kernel and mode on the device equal to what
   the tier's policy implies (``_policy_launches``), graphed ms/step,
   the device's busy share (the profiler's device ms of 5 graphed steps
   over it), the run's own peak; at ``default`` and ``highest`` the
   graphed run bit-equal to the eager loop; then Adam at 64x64, 20
   steps, lr 0.05 (the JAX package's certified Adam curve), card
   against CPU at each tier, every step within 1e-3 at ``highest``,
   ``mixed`` and ``high`` (``default`` printed), beside the control
   (the CPU run against itself from a content perturbed by 1e-7, at lr
   0.05 and 0.1); then the
   device ms of what ``mixed`` moves to IEEE fp32 in each mode;
6. timelapse: the port's runner on the main path's configuration with
   ``save_every=1`` into an in-memory frame sink (20 frames through the
   pinned-buffer frame stream), launch counts again 0 just before and
   read just after; the frames in step order, (512, 512, 3) uint8, the
   last one bit-equal to the packed final image; the largest difference
   from the same run with synchronous frames; ms/step with frames off,
   at ``save_every=20`` and at ``save_every=1``, the spread of the last
   over the first round by round, and each mode's mean interval
   between steps 3 to 20. Where ``ffmpeg`` is on
   PATH and Pillow imports, also ``main.style_transfer`` at the shipped
   video defaults (realtime MP4, intro, outro) with ``save_every=2`` on
   512x512 PNGs, with the MP4's size and frame count; otherwise the
   line says which is missing;
7. objective: ``run_style_transfer`` at 1024x1024 on full-width VGG19,
   two styles blended 0.7/0.3, TV and Laplacian terms, per-layer style
   weights, ``preserve_color="luminance"``, 20 L-BFGS steps with the
   auto warm start (4 steps at 512x512 first): the warm start ran (its
   log lines), finite and decreasing losses, launch counts equal to
   those worked out from the code (``_launches_wanted``), the output's
   chrominance equal to the content's where nothing is clipped;
   ms/step at full size and the peak memory;
8. Adam on full-width VGG16 at 512x512, 20 steps: launches, a loss
   that decreases, finite output, ms/step;
9. batch: ``main.prepare_multi_style`` and ``main.run_multi_style_loop``
   (the multi-style batch) at 512x512 on full-width VGG19, S = 4 styles
   (numpy seeds 2-5, the last 384x640), the shipped L-BFGS from the
   content, 20 steps, ``log_every=10``, ``save_every=5``, GIF and MP4
   into in-memory sinks: launches as worked out (a step's do not grow
   with S), each style's losses finite and decreasing, 4 frames per
   style and sink in step order, the last bit-equal to the style's
   packed final image, each style's 20-step curve within 1e-3 relative
   per step of a single run of that style (the final images' largest
   difference beside it, and, for scale, a single run against itself
   with its content perturbed by 1e-7); then frames off at S = 1, 4
   and 8 and a single run, rounds interleaved: ms per step (the mean
   step interval over steps 3-20), style-steps/s, the device-busy share
   (``torch.profiler``'s device time of 3 graphed steps over the step
   interval) and the peak memory;
10. resume: the single run through ``cli.main`` with a TOML given by
   ``--config`` at 512x512 (the shipped L-BFGS, frames off, a CSV row
   every step): two whole 20-step runs compared bit for bit, then 10
   steps with ``--checkpoint-every 10`` and ``--steps 20
   --resume-from`` that checkpoint, whose step-20 checkpoint (image and
   every optimizer state leaf) must be bit-equal to the whole run's,
   with equal CSV rows (if the card did not repeat a run bit for bit,
   the resumed curve is held against a run with its content perturbed
   by 1e-7 instead, and the line says so); launches of the resumed run;
   the checkpoint's bytes, the save's seconds, and ms/step with
   ``checkpoint_every=10`` against off (rounds interleaved);
11. resume batch: the same at S = 4 through ``prepare_multi_style`` and
   ``run_multi_style_loop``, the gate for every style;
12. warm start at 4 MP: seeded 4096x4096 content, the auto warm start
   of a 15-step run (3 steps at 2048x2048, 4,194,304 px) through
   ``engine.coarse.coarse_init``: its launches, the level's peak memory
   and ms per coarse step; then both kernels at the level's first two
   conv shapes and at the first tap's Gram (P = 4,194,304, C = 64)
   against their plain versions, timed (``level_2048_first``);
12b. band kernels (before the main path, beside the other kernel
   checks): both kernels at the 4K band's first window (880x3840: the
   convs 3 -> 64 and 64 -> 64; the raw Gram of the first tap's 720 band
   rows, P = 2,764,800, C = 64, clamp ``inf`` and norm 1 as
   ``ops.gram.gram_raw`` launches it, G bit-equal to raw, its gradient
   through ``gram_raw``) in all three modes against their plain
   versions within 1e-4, timed (``band_4k_first``);
12c. banded 4K: 3840x2160 content, a 512x512 style, shipped defaults,
   no warm start, ``tile_rows=720`` (3 bands) against the whole-image
   run: step 0's loss (1e-5) and gradient (1e-4 of its largest
   magnitude), the 3-step L-BFGS curve within ``max(control, 1e-3)``
   (the control: the whole run against itself from content perturbed
   by 1e-7), a 5-step Adam curve (lr 0.05) within 1e-3 a step, the
   banded run graphed bit-equal to eager with its own peak within 10%
   of eager's, launches worked out (per band and step: every conv's
   forward, the checkpoint's recompute and its input gradient; two
   Grams a style tap), each run's own peak and ms/step;
12d. banded 8K: 7680x4320 content through ``run_style_transfer`` at
   the shipped defaults (``tile_rows`` auto, the auto warm start):
   the log line of the band height the H100 thresholds give, 3 L-BFGS
   steps with finite, decreasing losses, the peak, ms/step and bands;
12e. remat: a 2048x2048 graphed L-BFGS run and the S = 4 batch at
   512x512 with ``remat=True`` bit-equal to ``remat=False`` in image
   and losses (one more forward of every conv a step), own peaks and
   ms/step;
12f. spatial: row-sharded evaluation (``parallel/spatial.py``) with
   every rank on this one card and gloo between them
   (``parallel.mesh.launch(share_card=True)``, the kernels built here
   first): 2 ranks at 2048x2048, then 4 at 1024x1024 (ranks 1 and 2
   interior), full-width VGG19 at ``mixed``. Step 0's loss and
   gradient against the whole image's (1e-5, 1e-4 of its largest
   magnitude); 3 L-BFGS steps of ``run_style_transfer`` on the ranks
   against the whole run within ``max(control, 1e-3)`` (the control:
   the whole run from content perturbed by 1e-7); each rank's launches
   by kernel and mode, its counts set to 0 just before its run and
   read just after, equal to the policy's count (``_policy_launches``);
   each rank's own peak and ms/step (a correctness run, not a rate);
12g. spatial kernels: both kernels at each rank's shapes of 12f in
   every mode against their plain versions within 1e-4: the conv on
   the halo'd shard (rows + 2), forward without ReLU and the input
   gradient without mask, the raw Gram of each style tap's shard rows
   and its gradient; timed (``spatial_2x2048``, ``spatial_4x1024``);
12h. batch cards: the multi-style batch over a style x space mesh
   (``main.prepare_multi_style`` and ``main.run_multi_style_loop``
   with each rank's mesh; ``parallel.spatial.build_dp_sp_update`` on a
   style row of several ranks), every rank on this one card with gloo
   between them: S = 4 styles (the batch phase's) at 1024x1024 on a
   2 (style) x 2 (space) mesh, then at 512x512 on a 4 x 1 mesh,
   shipped defaults. Against the single-card S = 4 batch on
   ``cuda:0``: each style's step-0 loss (1e-5) and gradient (1e-4 of
   its largest magnitude), each style's 3 L-BFGS steps within
   ``max(control, 1e-3)`` (the control: the largest error of the
   batch from content perturbed by 1e-7, four perturbations); each
   rank's launches by kernel and mode, its
   counts set to 0 just before its run and read just after, equal to
   the policy's for a batch of its S_local styles
   (``_batch_policy_launches``); at 4 x 1, 5 Adam steps at lr 0.05
   each style's image bit-equal to the single-card batch's; each
   rank's own peak and ms/step (a correctness run, not a rate);
12i. batch cards kernels: both kernels at a 2 x 2 rank's shapes at
   1024x1024 in every mode against their plain versions within 1e-4:
   the conv on the halo'd shard of its 2 styles, ``(2, 514, 1024,
   C)`` and the deeper stages, forward and input gradient; the
   batched raw Gram ``(2, P_shard, C)`` of each style tap in one
   launch and its gradient; timed (``batch_2x2_1024``);
13. sweep: ``blend_sweep.stylize_blend_sweep`` at 512x512 on
   full-width VGG19, 3 styles, 5 frames, the shipped L-BFGS with 20
   steps for frame 0 and 10 for each later frame (60 steps): launches
   as worked out, finite frame losses, frame 0 bit-equal to
   ``run_style_transfer`` of style 0 alone (PNG pixels and final loss),
   frame 2's blended targets bit-equal to style 1's; ms per sweep step
   beside the main path's. The sweep's GIF is written where imageio
   imports, else an in-memory stand-in takes the frames and the line
   says so;
14. regional: ``regional.stylize_regional`` at 512x512, 2 styles split
   left/right by a 32-pixel feathered seam, the shipped L-BFGS for 20
   steps, frames off, a CSV row a step: launches as worked out (a
   masked Gram per style and tap), a finite, decreasing loss, the file
   ``regional_content_x_s0+s1.png``; ms/step; then ``masked_gram`` at
   the 5 taps of 512x512 against its plain version within 1e-4, forward
   and backward, and an all-ones mask bit-equal to the stock Gram;
15. sequence: ``sequence_cli.main`` (``style-sequence-torch``) on 4
   PNG frames of 1280x720 (a drifting gradient plus seeded noise), one
   512x512 style, the shipped L-BFGS, 10 steps a frame,
   ``--output-video`` GIF where imageio imports: 4 PNGs at 1280x720,
   launches as worked out, no warm start, frame 0 bit-equal to
   ``run_style_transfer`` on frame 0; frames/min, steps/s, the peak
   memory, and frames 1-3's final losses beside frame 0's;
16. dispatch: every step of every phase above is a replay of a CUDA
   graph of the step (``engine.step.GraphedChunk``); each kernel counts
   its own runs on the device, replays included, and those counts are
   every phase's launches. This phase holds the graphs against
   the eager step (``GraphedChunk.loop``, ``update_fn`` in a Python
   loop, patched in for the reference run) bit for bit: the 512x512
   main path at ``steps_per_dispatch`` 0, 1 and 5 (final image, every
   step's losses, launches as worked out; the eager run's device counts
   equal to its wrappers' host counts), the S = 4 batch with a GIF
   and an MP4 every 10 steps (images, frames, a CSV row a step), sweep
   and sequence frames 0-1 at 64x64 (PNGs, frame losses, one capture
   per pipeline), and a chunk-5 run resumed at step 7 (off the grid);
   then 101 steps in one dispatch and the arrival counters all 0;
   time to the first step and the captures' seconds (512, and the
   1024x1024 objective with its warm start), graphed against eager,
   with each run's own peak memory; ms/step graphed against eager,
   rounds interleaved, at 512, 1024 (objective), 1280x720 and S = 4
   through the runner or the batch loop, with each mode's device ms
   per step from ``torch.profiler`` (the kernels inside replays
   included; the profiler's count of each port kernel's runs printed
   beside the kernels' device counts) and its busy share (that over
   the mode's ms/step), achieved TFLOP/s and its share of 495 TF32
   (``utils/flops.py``); the sweep's and the regional run's steps and
   the 1280x720 sequence's frames/min through their entry points,
   graphed against eager;
17. both kernels at the sequence's shapes: the conv at VGG19's five
   stage shapes at 1280x720 (720x1280 to 45x80) and the Gram at its
   five taps (P = 921,600 to 3,600) against their plain versions,
   timed (``at_720p``);
17b. the L-BFGS ring's two kernels (``csrc/lbfgs_ring.cu``) on a full
   bf16 ring of m = 100 wrapped past ``hist_pos``: at 512x512 (n =
   786,432), at 512x512 with S = 4 (each style's views of the batched
   ring) and at a 2 x 2 mesh rank's 1024x1024 shapes (2 styles of n =
   1,572,864): each style's four products against the plain upcast
   ones and the combination, given the same coefficients, against the
   plain one, within 1e-4; timed beside the plain version and one
   cuBLAS bf16 call on the same operands (``torch.mm`` of ``[S; Y]``
   and ``[Y; g]``, ``torch.mv`` of ``[S; Y]^T``; bf16 outputs, the
   concatenations not timed), against the bf16 bound (989 TFLOP/s or
   3.35 TB/s); then the 512x512 graphed L-BFGS step under the profiler:
   one run of each kernel a step (the profiler's count and the
   kernels' own), and no cuBLAS sgemm in one direction alone;
18. a 64x64 run held against the same run on the CPU (plain versions),
   then the same for Adam with every term above and a 2-step warm
   start at 32x32, then the same for a batch of 2 styles, then Adam
   from the content through a 2-frame sweep, a regional run of 2
   styles and a 2-frame sequence, each per-step curve within 1e-3.

A phase's ms/step (main path, objective, Adam, regional, resume) is
read off its own counted run by CUDA events that each dispatch records
after its last step (``engine.step.recording``): from the end of the
run's first dispatch (the warm-up step and the capture) to the end of
its last, over the steps between; what the run does after its last
step is left out. The line before the kernels' JSON record gives each
phase's seconds.

The line before the card line is the kernels' JSON record (each
kernel's launches in each driven path, and its times summed over a
step at 512x512, under ``at_1024`` at 1024x1024, and for the batch
phase's step at S = 4 under ``n4_512`` (conv) and ``batched_s4_512``
(Gram), for the 2048x2048 level's first shapes under
``level_2048_first``, for a 1280x720 frame's step under
``at_720p``, for a 4K band's first window under
``band_4k_first``, for one rank's step of 12f under
``spatial_2x2048`` and ``spatial_4x1024``, and for one rank's step of
12h's 2 x 2 mesh under ``batch_2x2_1024``). The conv and Gram entries
are their 3xTF32 kernels;
``conv3x3_ieee``, ``conv3x3_tf32``, ``gram_ieee`` and ``gram_tf32``
the other modes, with the same keys; each entry's ``launches`` is its
mode's count on the main path at ``mixed`` or, where ``mixed`` runs
none, at the tier that runs it everywhere (``launches_tier``), with
every tier's in ``launches_by_tier``; ``bound_ms`` counts each mode's
operations at its own rate (IEEE at 67 TFLOP/s, TF32 at 495, 3xTF32
at 495/3). The last line is the run's JSON verdict. Times
come from CUDA events around replays of CUDA graphs of back-to-back
calls on this run's card (device time; host launch overhead excluded
for every version alike). The
3xTF32 entries' ``bound_ms`` is the larger of three TF32 products per
operation at the H100 SXM's 495 TFLOP/s and the bytes at 3.35 TB/s;
``fp32_bound_ms`` keeps the fp32 figure (67 TFLOP/s outside the tensor
cores).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import logging
import math
import re
import shutil
import statistics
import subprocess
import sys
import time
from functools import cache, partial
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F  # noqa: N812

from style_transfer_visualizer_tpu_torch import (
    blend_sweep,
    cli,
    image_io,
    regional,
    sequence,
    sequence_cli,
)
from style_transfer_visualizer_tpu_torch.config import (
    HardwareConfig,
    OptimizationConfig,
    OutputConfig,
    StyleTransferConfig,
    VideoConfig,
)
from style_transfer_visualizer_tpu_torch.constants import (
    AUTO_TILE_PIXEL_THRESHOLD,
    MAX_BAND_PIXELS,
)
from style_transfer_visualizer_tpu_torch.constants import (
    GRAM_MATRIX_CLAMP_MAX as CLAMP,
)
from style_transfer_visualizer_tpu_torch.engine.coarse import (
    coarse_init,
    plan_pyramid,
    resize_image,
    resolve_coarse_steps,
)
from style_transfer_visualizer_tpu_torch.engine import optimizers, step
from style_transfer_visualizer_tpu_torch.engine.runner import (
    OptimizationCallbacks,
    OptimizationRunner,
    SilentProgress,
)
from style_transfer_visualizer_tpu_torch.main import (
    _auto_remat_batched,
    prepare_model_and_input,
    prepare_multi_style,
    resolve_single_remat,
    run_multi_style_loop,
    run_style_transfer,
    style_transfer,
)
from style_transfer_visualizer_tpu_torch.media import encode, segments
from style_transfer_visualizer_tpu_torch.models.arch import VGG16, VGG19
from style_transfer_visualizer_tpu_torch.models.features import (
    Targets,
    batched_total_loss,
    blend_targets,
    compute_targets,
)
from style_transfer_visualizer_tpu_torch.models.vgg19 import (
    flip_stencil,
    load_pretrained_params,
    pack_stencil,
)
from style_transfer_visualizer_tpu_torch.native import build
from style_transfer_visualizer_tpu_torch.ops.color import RGB_TO_YIQ
from style_transfer_visualizer_tpu_torch.ops import (
    conv3x3,
    gram,
    lbfgs_ring,
    tiled,
)
from style_transfer_visualizer_tpu_torch.ops.precision import (
    MODES,
    PRECISION_NAMES,
    conv_bwd_precision,
    conv_precision,
    gram_precision,
    kernel_mode,
    resolve_precision,
)
from style_transfer_visualizer_tpu_torch.ops.tf32 import round_tf32
from style_transfer_visualizer_tpu_torch.parallel import spatial
from style_transfer_visualizer_tpu_torch.parallel.mesh import launch
from style_transfer_visualizer_tpu_torch.parallel.multistyle import (
    multi_style_targets,
)
from style_transfer_visualizer_tpu_torch.runtime.checkpoint import (
    load_checkpoint,
    save_checkpoint,
)
from style_transfer_visualizer_tpu_torch.type_defs import InputPaths
from style_transfer_visualizer_tpu_torch.utils import flops
from style_transfer_visualizer_tpu_torch.utils.logging import logger

PACKAGE = "style_transfer_visualizer_tpu_torch"
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
TF32X3_FLOPS = TF32_FLOPS / 3
HBM_BYTES = 3.35e12
CUOBJDUMP = "/usr/local/cuda/bin/cuobjdump"
TOL = 1e-4
# YIQ chrominance of a luminance-restored output against the content's,
# where no channel is clipped: float32 matrices, float64 check.
CHROMA_TOL = 1e-5
STEPS = 20
LOG_EVERY = 10
TIMELAPSE_ROUNDS = 2
SIZE = 512
# (H = W, C_in, C_out, convs of this shape up to layer 28, of which
# fused with their ReLU) at 512x512. A tap (layers 0, 5, 10, 19, 21,
# 28) is not fused, so its backward takes no mask.
CONV_SHAPES = [
    (512, 3, 64, 1, 0), (512, 64, 64, 1, 1),
    (256, 64, 128, 1, 0), (256, 128, 128, 1, 1),
    (128, 128, 256, 1, 0), (128, 256, 256, 3, 3),
    (64, 256, 512, 1, 0), (64, 512, 512, 3, 2),
    (32, 512, 512, 1, 0),
]
# (P, C) of the five style taps at 512x512.
GRAM_SHAPES = [
    (262144, 64), (65536, 128), (16384, 256), (4096, 512), (1024, 512),
]
# The objective phase: 1024x1024 content, whose auto warm start runs a
# 512x512 level first (the main path's shapes); then the same taps at
# twice the side. VGG16's stack at 512x512 has the main path's width
# pairs (fewer repeats), checked by ``_vgg16_shapes_covered``. A
# 1080x1920 content's coarse level, 528x960 (a width that is not a
# power of two), is checked through the whole VGG19 stack.
OBJECTIVE_SIZE = 1024
NON_SQUARE = (528, 960)
# The batch phase: S = 4 styles (numpy seeds 2-5; seed 5's is 384x640,
# the others 512x512), timed at S = 1, 4 and 8 (seeds 2-9).
BATCH_STYLES = 4
BATCH_SAVE_EVERY = 5
BATCH_TIMED = (1, 4, 8)
BATCH_ROUNDS = 1
ODD_STYLE = (5, (384, 640))
# The targets-as-argument pipelines: a 5-frame sweep over 3 styles (20
# steps for frame 0, 10 for each later frame), a regional run of 2
# styles split left/right by a 32-pixel feathered seam, and a 4-frame
# 1280x720 sequence of 10 steps a frame.
SWEEP_STYLES = 3
SWEEP_FRAMES = 5
SWEEP_STEPS = 10
SEAM = 32
SEQ_HW = (720, 1280)
SEQ_FRAMES = 4
SEQ_STEPS = 10
# The main path's ms/step, for the sweep's line.
MAIN_MS_STEP: list[float] = []
# The dispatch phase: graphed against eager, rounds interleaved, each
# of so many steps through the runner.
DISPATCH_ROUNDS = 3
DISPATCH_STEPS = 6
# The A/Bs within graphed runs (steps_per_dispatch, the regional CSV).
AB_ROUNDS = 3
# The precision tiers (ops/precision.py) and the kernels' modes: each
# mode's operations at its peak on the H100 SXM (IEEE fp32 outside the
# tensor cores; one TF32 product; three).
TIERS = PRECISION_NAMES
NEW_MODES = ("ieee", "tf32")
BF16_FLOPS = 989e12
MODE_RATE = {
    "ieee": FP32_FLOPS, "tf32x3": TF32X3_FLOPS, "tf32": TF32_FLOPS,
    "bf16": BF16_FLOPS,
}
# Graph-timed calls a mode's timing replays (the IEEE convs take up to
# tens of ms a call at 1024x1024 and N = 4).
MODE_REPS = 2
# The curve gate of the tiers: Adam at 64x64 on the card against the
# CPU, every step within 1e-3 relative at every tier but "default", at
# the learning rate of the JAX package's certified Adam curve
# (bench.py, benchmarks/curve_parity_bench.py). A control gives the
# curve's own sensitivity: the CPU run against itself with the content
# perturbed by 1e-7 relative, at that rate and at 0.1.
GATE_STEPS = 20
GATE_TOL = 1e-3
GATE_LR = 0.05
CONTROL_LRS = (GATE_LR, 0.1)
# Launches per tier on the 512 main path, by kernel and mode.
TIER_LAUNCHES: dict[str, dict[str, dict[str, int]]] = {}


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",  # noqa: S607
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


@cache
def _timing_stream() -> torch.cuda.Stream:
    """The one side stream every timing capture runs on.

    PyTorch keeps a cuBLAS workspace for each stream that has run a
    cuBLAS call, for the life of the process; a fresh stream per timing
    would leave one behind for every timed product.
    """
    return torch.cuda.Stream()


def _time_ms(fn, reps: int = 5, replays: int = 2) -> float:
    """Device ms of one call of ``fn``, from a CUDA graph of ``reps`` calls.

    Replaying captured calls times the device work alone: the host's
    launch overhead (Python, ctypes, PyTorch's dispatcher) is left out
    of the kernel, the plain version and the library call alike. The
    wrappers' host time is measured apart (tools/wrapper_host_time.py).
    """
    stream = _timing_stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    graph.reset()
    return start.elapsed_time(end) / (reps * replays)


def _times(*fns) -> tuple[float, ...]:
    return tuple(_time_ms(fn) for fn in fns)


def _rel_err(ours, ref) -> tuple[float, float]:
    """(max abs error, that over the reference's largest magnitude)."""
    err = float((ours - ref).abs().max())
    return err, err / max(float(ref.abs().max()), 1e-30)


def _sass(library) -> str | None:
    """A library's SASS from ``cuobjdump``; None without the tool."""
    tool = shutil.which("cuobjdump") or CUOBJDUMP
    if not Path(tool).exists():
        return None
    return subprocess.run(
        [tool, "-sass", str(library)],
        capture_output=True, text=True, check=True, timeout=120,
    ).stdout


def _ptxas_functions(log: str) -> dict[str, dict[str, int]]:
    """Per entry function of a ptxas ``-v`` report: its registers and
    spill bytes (stores plus loads)."""
    out: dict[str, dict[str, int]] = {}
    name = None
    for line in log.splitlines():
        if m := re.search(r"(?:entry function|Function properties for) '?"
                          r"([\w$]+)", line):
            name = m.group(1)
            out.setdefault(name, {"registers": 0, "spill": 0})
        elif name and (m := re.search(
                r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)):
            out[name]["spill"] += int(m.group(1)) + int(m.group(2))
        elif name and (m := re.search(r"Used (\d+) registers", line)):
            out[name]["registers"] = int(m.group(1))
    return out


def _check_tf32_build(kernel: build.BuiltKernel, hgmma: int | None) -> None:
    """The TF32 kernels (all of ``conv3x3_tf32``, ``gram``'s
    ``gram_tf32_kernel``) hold ``wgmma`` and spill nothing; prints each
    one's registers."""
    funcs = {
        name: v for name, v in _ptxas_functions(kernel.ptxas_log).items()
        if kernel.name == "conv3x3_tf32" or "gram_tf32" in name
    }
    if not funcs:
        msg = f"{kernel.name}: no TF32 kernel in the ptxas report"
        raise AssertionError(msg)
    if hgmma == 0:
        msg = f"{kernel.name}: no wgmma (HGMMA) in the built library"
        raise AssertionError(msg)
    for name, v in sorted(funcs.items()):
        print(
            f"  {kernel.name} TF32 {name}: {v['registers']} registers, "
            f"{v['spill']} bytes spilled",
        )
    spilled = [name for name, v in funcs.items() if v["spill"]]
    if spilled:
        msg = f"{kernel.name}: TF32 kernels spill: {spilled}"
        raise AssertionError(msg)


def _check_ieee_build(kernel: build.BuiltKernel, sass: str | None) -> None:
    """The IEEE conv stays on the CUDA cores (no ``HGMMA`` or ``HMMA``
    in its SASS) and keeps its accumulators in registers (no spills in
    ``-Xptxas -v``'s report)."""
    if sass is not None and re.search(r"\bH(G)?MMA", sass):
        msg = "conv3x3_ieee: tensor-core instructions in its SASS"
        raise AssertionError(msg)
    spills = [
        int(n) for n in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", kernel.ptxas_log,
        )
    ]
    if not spills or any(spills):
        msg = f"conv3x3_ieee: spills in the ptxas report: {spills}"
        raise AssertionError(msg)


def _check_lbfgs_ring_build(
    kernel: build.BuiltKernel, sass: str | None,
) -> None:
    """``lbfgs_ring``'s two kernels spill nothing, and the products
    kernel runs ``mma.sync`` (``HMMA``) on the tensor cores; prints
    each one's registers."""
    funcs = _ptxas_functions(kernel.ptxas_log)
    if not any("products" in name for name in funcs):
        msg = "lbfgs_ring: no products kernel in the ptxas report"
        raise AssertionError(msg)
    for name, v in sorted(funcs.items()):
        print(
            f"  lbfgs_ring {name}: {v['registers']} registers, "
            f"{v['spill']} bytes spilled",
        )
    spilled = [name for name, v in funcs.items() if v["spill"]]
    if spilled:
        msg = f"lbfgs_ring: kernels spill: {spilled}"
        raise AssertionError(msg)
    if sass is None:
        return
    products = [
        text for name, text in _sass_functions(sass).items()
        if "products" in name
    ]
    if not products or not all(re.search(r"\bHMMA", t) for t in products):
        msg = "lbfgs_ring: no HMMA in the products kernel's SASS"
        raise AssertionError(msg)


def _sass_functions(sass: str) -> dict[str, str]:
    """Each function's SASS in ``cuobjdump -sass`` output, by name."""
    parts = re.split(r"Function : (\S+)", sass)
    return dict(zip(parts[1::2], parts[2::2], strict=True))


def _check_ieee_gram_build(kernel: build.BuiltKernel, sass: str | None):
    """``gram``'s IEEE kernel (``gram_ieee_kernel``) stays on the CUDA
    cores (no ``HGMMA`` or ``HMMA`` in its SASS) and spills nothing;
    prints its registers."""
    funcs = {
        name: v for name, v in _ptxas_functions(kernel.ptxas_log).items()
        if "gram_ieee_kernel" in name
    }
    if not funcs:
        msg = "gram: no IEEE kernel in the ptxas report"
        raise AssertionError(msg)
    for name, v in sorted(funcs.items()):
        print(
            f"  gram IEEE {name}: {v['registers']} registers, "
            f"{v['spill']} bytes spilled",
        )
    spilled = [name for name, v in funcs.items() if v["spill"]]
    if spilled:
        msg = f"gram: the IEEE kernel spills: {spilled}"
        raise AssertionError(msg)
    if sass is None:
        return
    ieee = {
        name: text for name, text in _sass_functions(sass).items()
        if "gram_ieee_kernel" in name
    }
    if len(ieee) != len(funcs):
        msg = f"gram: IEEE kernel in the SASS: {sorted(ieee)}"
        raise AssertionError(msg)
    mma = [name for name, text in ieee.items() if re.search(r"\bH(G)?MMA",
                                                           text)]
    if mma:
        msg = f"gram: tensor-core instructions in the IEEE kernel: {mma}"
        raise AssertionError(msg)


class Record:
    """One kernel's line of the JSON record, summed over a step."""

    def __init__(
        self, name: str, source: str, replaces: str,
        mode: str = "tf32x3",
    ) -> None:
        """Start an empty record of ``mode``'s kernel, whose operations
        run at ``MODE_RATE[mode]``."""
        self.entry = {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "mode": mode, "launches": 0,
            "max_abs_err": 0.0, "max_rel_err": 0.0,
            "ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0,
        }
        self.rate = MODE_RATE[mode]
        self.ops_s = 0.0     # operation time at the mode's rate, summed
        self.bytes_s = 0.0
        self.bound_s = 0.0
        self.fp32_bound_s = 0.0

    def err(self, ours, ref, what: str) -> None:
        """Check one comparison against the tolerance and keep its error."""
        err, rel = _rel_err(ours, ref)
        if not rel <= TOL:
            msg = f"{self.entry['name']} {what}: rel err {rel:.3g} > {TOL}"
            raise AssertionError(msg)
        self.entry["max_abs_err"] = max(self.entry["max_abs_err"], err)
        self.entry["max_rel_err"] = max(self.entry["max_rel_err"], rel)

    def add(self, count: int, ms, plain_ms, library_ms, flops, nbytes):
        """Add ``count`` launches per step of one shape to the sums."""
        ops_s = flops / self.rate
        mem_s = nbytes / HBM_BYTES
        self.ops_s += count * ops_s
        self.bytes_s += count * mem_s
        self.bound_s += count * max(ops_s, mem_s)
        self.fp32_bound_s += count * max(flops / FP32_FLOPS, mem_s)
        self.entry["ms"] += count * ms
        self.entry["plain_ms"] += count * plain_ms
        self.entry["library_ms"] += count * library_ms

    def finish(
        self, launches: dict[str, int], extras: dict[str, Record],
    ) -> dict:
        """The JSON entry: the main path's launches and per-step sums.

        ``launches`` maps each driven path to its launch count; the
        main path's is the entry's ``launches``. Each of ``extras``
        holds the same sums over a step of another configuration (the
        objective phase at full size, the batch phase at S = 4).
        """
        out = dict(
            self.entry, launches=launches["main path"],
            launches_by_phase=launches,
        )
        out.update(self._bounds())
        for key, rec in extras.items():
            out[key] = {
                k: rec.entry[k]
                for k in ("ms", "plain_ms", "library_ms", "max_rel_err")
            } | rec._bounds()  # noqa: SLF001 - same class
        return out

    def _bounds(self) -> dict:
        return {
            "bound_ms": self.bound_s * 1e3,
            "bound_by": (
                "operations" if self.ops_s >= self.bytes_s else "bytes"
            ),
            "fp32_bound_ms": self.fp32_bound_s * 1e3,
        }


def _bound_ms(
    flops: float, nbytes: float, rate: float = TF32X3_FLOPS,
) -> float:
    return max(flops / rate, nbytes / HBM_BYTES) * 1e3


def _conv_cases(rec: Record, rec_1024: Record, rec_n4: Record):
    """``(n, h, w, C_in, C_out, per step, of which fused, record)``.

    The main path's shapes, twice their side (the objective phase at
    full size) and the same at N = 4 (the batch phase's step at S = 4)
    are timed into ``rec``, ``rec_1024`` and ``rec_n4``; a batch of 2
    and the 528x960 coarse level's stack are checked only.
    """
    cases = [
        (1, hw, hw, ci, co, n, f, rec) for hw, ci, co, n, f in CONV_SHAPES
    ]
    cases += [
        (1, 2 * hw, 2 * hw, ci, co, n, f, rec_1024)
        for hw, ci, co, n, f in CONV_SHAPES
    ]
    cases += [
        (BATCH_STYLES, hw, hw, ci, co, n, f, rec_n4)
        for hw, ci, co, n, f in CONV_SHAPES
    ]
    cases.append((2, 64, 64, 128, 128, 0, 0, None))
    h, w = NON_SQUARE
    for hw, ci, co, _, _ in CONV_SHAPES:
        scale = SIZE // hw
        cases.append((1, h // scale, w // scale, ci, co, 0, 0, None))
    return cases


def _vgg16_shapes_covered() -> None:
    """VGG16's conv shapes at 512x512 are among the checked ones."""
    table = VGG16.layer_table
    last = max(VGG16.default_style_layers + VGG16.default_content_layers)
    pools = 0
    shapes = set()
    for idx in range(last + 1):
        kind, ci, co = table[idx]
        if kind == "pool":
            pools += 1
        elif kind == "conv":
            shapes.add((SIZE >> pools, ci, co))
    checked = {(hw, ci, co) for hw, ci, co, _, _ in CONV_SHAPES}
    if not shapes <= checked:
        msg = f"VGG16 conv shapes not checked: {sorted(shapes - checked)}"
        raise AssertionError(msg)
    print(f"conv vgg16 {SIZE}x{SIZE}: its {len(shapes)} shapes are checked")


def _check_conv(rec: Record, cases) -> None:
    """Each ``_conv_cases``-style case against its plain version; timed
    into its record when it runs ``count`` times a step."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    for n, h, w, ci, co, count, fused, into in cases:
        def rand(*shape, scale=1.0):
            return torch.randn(
                shape, generator=gen, device="cuda",
            ) * scale

        x = rand(n, h, w, ci)
        w9 = rand(9, ci, co, scale=(2.0 / (9 * ci)) ** 0.5)
        b = rand(co, scale=0.1)
        g = rand(n, h, w, co)
        w9f = flip_stencil(w9)
        wk, wkf = pack_stencil(w9), pack_stencil(w9f)
        w_oihw = w9.reshape(3, 3, ci, co).permute(3, 2, 0, 1).contiguous()
        label = f"{n}x{h}x{w} {ci}->{co}"
        for relu in (True, False):
            rec.err(
                conv3x3.conv3x3_kernel(x, wk, b, relu),
                conv3x3.conv3x3_plain(x, w9, b, relu),
                f"{label} forward relu={relu}",
            )
        # The fused-mask input gradient: the kernel zeroes g where the
        # forward's output is not positive as it loads it.
        out = conv3x3.conv3x3_kernel(x, wk, b, True)
        rec.err(
            conv3x3.conv3x3_kernel(g, wkf, None, False, out),
            conv3x3.conv3x3_plain(g, w9f, None, False, out),
            f"{label} fused-mask input gradient",
        )
        # Through autograd, against cuDNN's own conv backward on g
        # masked by the kernel's output, so both sides use one mask.
        xk = x.clone().requires_grad_(True)
        out = conv3x3.conv3x3_bias_relu(xk, w9, w9f, b, True, wk, wkf)
        out.backward(g)
        xr = x.clone().requires_grad_(True)
        ref = F.conv2d(xr.permute(0, 3, 1, 2), w_oihw, b, padding=1)
        ref.backward((g * (out.detach() > 0)).permute(0, 3, 1, 2))
        rec.err(xk.grad, xr.grad, f"{label} input gradient")
        if n > 1:
            _check_batch_invariant(x, g, wk, wkf, b, label)
        if not count:
            print(f"conv {label}: ok (check only)")
            continue
        out = out.detach()
        x_nchw = x.permute(0, 3, 1, 2)
        gm_nchw = torch.where(out > 0, g, 0.0).permute(0, 3, 1, 2)
        wf_oihw = w9f.reshape(3, 3, co, ci).permute(3, 2, 0, 1).contiguous()
        fwd = _times(
            partial(conv3x3.conv3x3_kernel, x, wk, b, True),
            partial(conv3x3.conv3x3_plain, x, w9, b, True),
            partial(F.conv2d, x_nchw, w_oihw, b, padding=1),
        )
        pix = n * h * w
        flops = 2.0 * 9 * pix * ci * co
        nbytes = 4.0 * (pix * (ci + co) + 9 * ci * co)
        into.add(count, *fwd, flops, nbytes + 4.0 * co)
        line = (
            f"conv {label} x{count}: fwd kernel_ms {fwd[0]:.4f} plain_ms "
            f"{fwd[1]:.4f} library_ms {fwd[2]:.4f} "
            f"bound_ms {_bound_ms(flops, nbytes):.4f}"
        )
        # The backward as the main path runs it: masked for a conv fused
        # with its ReLU (it also reads the mask), plain otherwise. The
        # library yardstick is cuDNN's conv of the already masked g: one
        # call, the mask not counted.
        for n_bwd, mask, g_nchw, extra in (
            (fused, out, gm_nchw, 4.0 * pix * co),
            (count - fused, None, g.permute(0, 3, 1, 2), 0.0),
        ):
            if not n_bwd:
                continue
            bwd = _times(
                partial(conv3x3.conv3x3_kernel, g, wkf, None, False, mask),
                partial(conv3x3.conv3x3_plain, g, w9f, None, False, mask),
                partial(F.conv2d, g_nchw, wf_oihw, None, padding=1),
            )
            into.add(n_bwd, *bwd, flops, nbytes + extra)
            line += (
                f" | bwd x{n_bwd} mask={mask is not None} kernel_ms "
                f"{bwd[0]:.4f} plain_ms {bwd[1]:.4f} library_ms "
                f"{bwd[2]:.4f} bound_ms {_bound_ms(flops, nbytes + extra):.4f}"
            )
        print(line)


def _check_batch_invariant(
    x, g, wk, wkf, b, label: str, mode: str = "tf32x3",
) -> None:
    """Each image of a batch gets, bit for bit, its output alone.

    The forward (fused ReLU) and the fused-mask input gradient in
    ``mode``; the launch plan picks the split over K per image, not per
    batch.
    """
    kern = partial(conv3x3.conv3x3_kernel, mode=mode)
    out = kern(x, wk, b, True)
    back = kern(g, wkf, None, False, out)
    for i in range(x.shape[0]):
        one = kern(x[i:i + 1].contiguous(), wk, b, True)
        one_back = kern(g[i:i + 1].contiguous(), wkf, None, False, one)
        if not (torch.equal(out[i], one[0])
                and torch.equal(back[i], one_back[0])):
            msg = (
                f"conv {label} {mode}: image {i} differs from its launch "
                "alone"
            )
            raise AssertionError(msg)


def _check_gram(rec: Record, rec_1024: Record, rec_b4: Record) -> None:
    """The main path's Gram shapes, the objective phase's (P x 4), then
    the batched launch (:func:`_check_gram_batched`)."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [(p, c, rec) for p, c in GRAM_SHAPES]
    cases += [(4 * p, c, rec_1024) for p, c in GRAM_SHAPES]
    _check_gram_cases(rec, cases, gen)
    _check_gram_batched(rec, rec_b4, gen)


def _check_gram_cases(rec: Record, cases, gen: torch.Generator) -> None:
    """Each ``(P, C, record)`` against the plain Gram, forward and
    backward, with and without an active clamp; timed into the record."""
    for p, c, into in cases:
        # Scale 1 leaves the clamp idle; the second scale puts the
        # diagonal near 1e6, above the 5e5 clamp.
        for scale in (1.0, (1e6 / p) ** 0.5):
            f = torch.randn((p, c), generator=gen, device="cuda") * scale
            dg = torch.randn((c, c), generator=gen, device="cuda")
            raw_k, g_k = gram.gram_kernel(f, CLAMP, float(p * c))
            raw_p, g_p = gram.gram_plain(f, CLAMP, float(p * c))
            active = bool((raw_p > CLAMP).any())
            label = f"({p},{c}) clamp_active={active}"
            rec.err(raw_k, raw_p, f"{label} raw")
            rec.err(g_k, g_p, f"{label} forward")
            if not torch.equal(raw_k, raw_k.T):
                msg = f"gram {label}: raw Gram is not symmetric"
                raise AssertionError(msg)
            feats = f.reshape(1, 1, p, c)
            fk = feats.clone().requires_grad_(True)
            gram.gram_matrix(fk).backward(dg)
            fr = feats.clone().requires_grad_(True)
            raw = fr.reshape(p, c).T @ fr.reshape(p, c)
            (torch.clamp(raw, max=CLAMP) / (p * c)).backward(dg)
            rec.err(fk.grad, fr.grad, f"{label} backward")
        times = _times(
            partial(gram.gram_kernel, f, CLAMP, float(p * c)),
            partial(gram.gram_plain, f, CLAMP, float(p * c)),
            partial(torch.mm, f.T, f),
        )
        # G is symmetric: c(c+1)/2 distinct entries, 2p flops each.
        flops = float(p * c * (c + 1))
        nbytes = 4.0 * (p * c + 2 * c * c)
        into.add(1, *times, flops, nbytes)
        print(
            f"gram ({p},{c}): kernel_ms {times[0]:.4f} plain_ms "
            f"{times[1]:.4f} library_ms {times[2]:.4f} bound_ms "
            f"{_bound_ms(flops, nbytes):.4f}",
        )


def _check_gram_batched(
    rec: Record, rec_b4: Record, gen: torch.Generator,
) -> None:
    """One launch for S images, each against its plain Gram.

    S = 4 at the 512x512 shapes (timed into ``rec_b4``, against
    ``torch.bmm`` fp32 on the same ``(S, C, P) . (S, P, C)``) and at
    the 528x960 coarse level's, whose two deepest taps (P = 7920 and
    1980) are not multiples of the kernel's 32-row slot: image s's last
    slab must not read image s+1's rows, so each image is scaled
    differently. At S = 1 the raw Gram is the single launch's, bit for
    bit.
    """
    s = BATCH_STYLES
    h, w = NON_SQUARE
    cases = [(p, c, True) for p, c in GRAM_SHAPES]
    cases += [
        ((h >> k) * (w >> k), c, False)
        for k, (_, c) in enumerate(GRAM_SHAPES)
    ]
    spread = 1.0 + torch.arange(s, device="cuda")[:, None, None] / s
    for p, c, timed in cases:
        norm = float(p * c)
        for scale in (1.0, (1e6 / p) ** 0.5):
            f = torch.randn(
                (s, p, c), generator=gen, device="cuda",
            ) * (scale * spread)
            dg = torch.randn((s, c, c), generator=gen, device="cuda")
            raw_k, g_k = gram.gram_kernel_batched(f, CLAMP, norm)
            raw_p, g_p = gram.gram_plain_batched(f, CLAMP, norm)
            active = bool((raw_p > CLAMP).any())
            label = f"S={s} ({p},{c}) clamp_active={active}"
            for i in range(s):
                rec.err(raw_k[i], raw_p[i], f"{label} image {i} raw")
                rec.err(g_k[i], g_p[i], f"{label} image {i} forward")
                if not torch.equal(raw_k[i], raw_k[i].T):
                    msg = f"gram {label}: raw Gram {i} is not symmetric"
                    raise AssertionError(msg)
            fk = f.reshape(s, 1, p, c).clone().requires_grad_(True)
            gram.gram_matrix_batched(fk).backward(dg)
            fr = f.clone().requires_grad_(True)
            (torch.clamp(fr.mT @ fr, max=CLAMP) / norm).backward(dg)
            for i in range(s):
                rec.err(
                    fk.grad[i, 0], fr.grad[i], f"{label} image {i} backward",
                )
            one, _ = gram.gram_kernel_batched(f[:1].contiguous(), CLAMP, norm)
            for i in range(s):
                single, _ = gram.gram_kernel(f[i].contiguous(), CLAMP, norm)
                if not torch.equal(raw_k[i], single) or (
                    i == 0 and not torch.equal(one[0], single)
                ):
                    msg = (
                        f"gram ({p},{c}): image {i} differs from the "
                        "single launch"
                    )
                    raise AssertionError(msg)
        if not timed:
            print(
                f"gram {label}: ok, each image and S = 1 bit-equal to the "
                "single launch (check only)",
            )
            continue
        times = _times(
            partial(gram.gram_kernel_batched, f, CLAMP, norm),
            partial(gram.gram_plain_batched, f, CLAMP, norm),
            partial(torch.bmm, f.mT, f),
        )
        flops = float(s * p * c * (c + 1))
        nbytes = 4.0 * s * (p * c + 2 * c * c)
        rec_b4.add(1, *times, flops, nbytes)
        print(
            f"gram S={s} ({p},{c}) one launch: kernel_ms {times[0]:.4f} "
            f"plain_ms {times[1]:.4f} library_ms (torch.bmm) "
            f"{times[2]:.4f} bound_ms {_bound_ms(flops, nbytes):.4f}; "
            f"each image and S = 1 bit-equal to the single launch",
        )


def _config(steps: int, device: str, **opt):
    """A shipped-defaults config with seeded weights."""
    return StyleTransferConfig(
        output=OutputConfig(log_every=LOG_EVERY),
        optimization=OptimizationConfig(
            steps=steps, allow_random_weights=True, **opt,
        ),
        hardware=HardwareConfig(device=device),
    )


def _images(size: int, seed: int):
    rng = np.random.default_rng(seed)
    return tuple(
        rng.uniform(size=(1, size, size, 3)).astype(np.float32)
        for _ in range(2)
    )


def _launched() -> tuple[int, int]:
    """The conv's and the Gram's runs as their device counters hold
    them (each kernel adds one per run, graph replays included)."""
    return conv3x3.launches.launched(), gram.launches.launched()


def _wrapper_calls() -> tuple[int, int]:
    """The conv's and the Gram's launches as their wrappers counted
    them on the host (a replay calls no wrapper)."""
    return conv3x3.launches.count, gram.launches.count


def _counted_run(run):
    """``run()`` with the launch counts set to 0 just before and read
    just after; returns its result, its seconds and the counts the
    kernels made on the device."""
    conv3x3.launches.reset()
    gram.launches.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    return out, seconds, _launched()


def _check_run(label: str, image, losses, launches, want, size: int):
    """Finite, decreasing losses, one a step; the launches worked out."""
    if len(losses) != STEPS or not all(map(_finite, losses)):
        msg = f"{label}: non-finite or missing losses {losses}"
        raise AssertionError(msg)
    if not losses[-1] < losses[0]:
        msg = f"{label}: loss did not decrease: {losses}"
        raise AssertionError(msg)
    if tuple(image.shape) != (1, size, size, 3) or not bool(
        torch.isfinite(image).all(),
    ):
        msg = f"{label}: bad output image {tuple(image.shape)}"
        raise AssertionError(msg)
    if launches != want:
        msg = f"{label}: launches conv/gram {launches}, expected {want}"
        raise AssertionError(msg)


def _fresh_peak() -> int:
    """Free the checks' tensors and graph pools; reset the peak.

    Returns the bytes still allocated, so a phase's own peak is the
    peak less these.
    """
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _main_path() -> tuple[int, int]:
    """20 steps at 512x512; returns the conv and Gram launch counts."""
    content, style = _images(SIZE, 0)
    config = _config(STEPS, "cuda")
    before = _fresh_peak()
    with _dispatch_log() as log:
        (image, history), t_long, launches = _counted_run(
            lambda: run_style_transfer(content, style, config),
        )
    peak = torch.cuda.max_memory_allocated()
    losses = history["total_loss"]
    _check_run(
        "main path", image, losses, launches,
        _launches_wanted(VGG19, config.optimization, SIZE, 1), SIZE,
    )
    logged = [losses[i - 1] for i in range(LOG_EVERY, STEPS + 1, LOG_EVERY)]
    if not logged[-1] < logged[0]:
        msg = f"main path: logged loss did not decrease: {logged}"
        raise AssertionError(msg)
    ms_step = log.ms_per_step()
    MAIN_MS_STEP.append(ms_step)
    print(
        f"main path {SIZE}x{SIZE} vgg19 L-BFGS {STEPS} steps: "
        f"loss {losses[0]:.6g} -> {losses[-1]:.6g}, logged {logged}, "
        f"ms/step {ms_step:.3f}, run s {t_long:.3f}, "
        f"max_memory_allocated {peak}, of which allocated before the run "
        f"{before} (the run's own {peak - before}), "
        f"launches conv {launches[0]} gram {launches[1]}",
    )
    return launches


def _finite(v: float) -> bool:
    return v == v and abs(v) != float("inf")


class _FrameSink:
    """An in-memory frame sink: keeps every delivered array."""

    def __init__(self) -> None:
        """Start empty."""
        self.frames: list[np.ndarray] = []
        self._size = None

    def append_data(self, frame: np.ndarray) -> None:
        """Keep one frame."""
        self.frames.append(frame)

    def close(self) -> None:
        """Nothing to release."""


class _Progress:
    """The script's own progress reporter: counts steps, prints nothing."""

    def __init__(self) -> None:
        """Start at step 0."""
        self.steps = 0

    def update(self, n: int = 1) -> None:
        """Count ``n`` steps."""
        self.steps += n

    def set_postfix(self, *args, **kwargs) -> None:
        """Ignore the loss display."""
        del args, kwargs

    def close(self) -> None:
        """Nothing to release."""


def _timelapse_run(
    content, style, params, steps: int, save_every: int | None, *,
    async_frames: bool = True,
):
    """The runner on the main path's configuration, frames in memory.

    Returns the final working image, the loss history, the frames, the
    step of each frame, the runner's wall seconds (device synced
    before and after) and the host clock at the end of each step.
    ``save_every=None`` attaches no sink.
    """
    config = _config(steps, "cuda")
    config.video.save_every = save_every or steps + 1
    bundle, input_img = prepare_model_and_input(
        content, style, config, params=params,
    )
    sink = _FrameSink() if save_every else None
    frame_steps: list[int] = []
    step_ends: list[float] = []
    progress = _Progress()
    runner = OptimizationRunner(
        bundle.update_fn, bundle.opt_state, input_img, config,
        progress_bar=progress,
        # The step-end callback makes every mode run single steps.
        callbacks=OptimizationCallbacks(
            on_step_end=lambda _m: step_ends.append(time.perf_counter()),
            on_video_frame=lambda _f, step: frame_steps.append(step),
        ),
        video_writer=sink,
        async_frames=async_frames,
        chunked_update_fn=bundle.chunked_update_fn,
    )
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    image, history, _ = runner.run()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    if progress.steps != steps:
        msg = f"progress saw {progress.steps} steps, expected {steps}"
        raise AssertionError(msg)
    frames = sink.frames if sink else []
    return image, history, frames, frame_steps, seconds, step_ends


def _timelapse() -> tuple[int, int]:
    """20 frames through the frame stream; ms/step with and without."""
    content, style = _images(SIZE, 0)
    params = load_pretrained_params(
        torch.device("cuda"), allow_random=True, seed=0,
    )
    conv3x3.launches.reset()
    gram.launches.reset()
    image, history, frames, steps_seen, _, _ = _timelapse_run(
        content, style, params, STEPS, 1,
    )
    conv_n, gram_n = _launched()
    want = _launches_wanted(
        VGG19, _config(STEPS, "cuda").optimization, SIZE, 1,
    )
    if (conv_n, gram_n) != want:
        msg = f"timelapse launches conv/gram {conv_n}/{gram_n}, want {want}"
        raise AssertionError(msg)
    if steps_seen != list(range(1, STEPS + 1)) or len(frames) != STEPS:
        msg = f"frames at steps {steps_seen}, {len(frames)} delivered"
        raise AssertionError(msg)
    for frame in frames:
        if frame.shape != (SIZE, SIZE, 3) or frame.dtype != np.uint8:
            msg = f"bad frame {frame.shape} {frame.dtype}"
            raise AssertionError(msg)
    final = image_io.pack_uint8_frame(
        image_io.prepare_image_for_output(image, normalize=True),
    ).cpu().numpy()
    if not np.array_equal(frames[-1], final):
        msg = "last frame differs from the packed final image"
        raise AssertionError(msg)
    if len({id(f) for f in frames}) != STEPS or not all(
        map(_finite, history["total_loss"]),
    ):
        msg = "frames share memory or losses are not finite"
        raise AssertionError(msg)
    _, _, sync_frames, _, _, _ = _timelapse_run(
        content, style, params, STEPS, 1, async_frames=False,
    )
    sync_diff = max(
        int(np.abs(a.astype(np.int16) - b.astype(np.int16)).max())
        for a, b in zip(frames, sync_frames, strict=True)
    )

    # ms/step per mode: the difference of a 20-step and a 10-step run of
    # the runner, the least of TIMELAPSE_ROUNDS rounds, modes
    # interleaved (the host's noise is of the order of the frames'
    # cost). The spread of the same ratio taken round by round shows
    # that noise. The mean interval between steps 3 to 20 of the same
    # runs is a second reading, free of each run's start and end.
    modes = {"frames off": None, "save_every=20": 20, "save_every=1": 1}
    rounds: dict[tuple[str, int], list[float]] = {
        (name, steps): []
        for name in modes for steps in (STEPS // 2, STEPS)
    }
    gaps: dict[str, list[float]] = {name: [] for name in modes}
    for _ in range(TIMELAPSE_ROUNDS):
        for name, every in modes.items():
            for steps in (STEPS // 2, STEPS):
                run = _timelapse_run(content, style, params, steps, every)
                rounds[name, steps].append(run[4])
                if steps == STEPS:
                    gaps[name].extend(np.diff(run[5][2:]) * 1e3)
    gap_ms = {name: float(np.mean(v)) for name, v in gaps.items()}

    def per_step_ms(name: str, pick) -> float:
        return (
            pick(rounds[name, STEPS]) - pick(rounds[name, STEPS // 2])
        ) / (STEPS // 2) * 1e3

    ms = {name: per_step_ms(name, min) for name in modes}
    ratio = ms["save_every=1"] / ms["frames off"]
    per_round = sorted(
        per_step_ms("save_every=1", lambda v, i=i: v[i])
        / per_step_ms("frames off", lambda v, i=i: v[i])
        for i in range(TIMELAPSE_ROUNDS)
    )
    print(
        f"timelapse {SIZE}x{SIZE} {STEPS} steps save_every=1: "
        f"{len(frames)} frames in step order, last frame equal to the "
        f"final image, async vs sync frames max abs diff {sync_diff}, "
        f"launches conv {conv_n} gram {gram_n}; ms/step "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f", save_every=1 over frames off {ratio:.4f}; the same ratio "
        f"round by round: median {statistics.median(per_round):.4f}, "
        f"least {per_round[0]:.4f}, greatest {per_round[-1]:.4f}; mean "
        f"step interval ms "
        + ", ".join(f"{k} {v:.3f}" for k, v in gap_ms.items())
        + f", save_every=1 over frames off "
        f"{gap_ms['save_every=1'] / gap_ms['frames off']:.4f}",
    )
    _full_timelapse()
    return conv_n, gram_n


def _mp4_frames(path: Path) -> int:
    """Frames in an MP4's video stream, counted by ffmpeg."""
    out = subprocess.run(
        ["ffmpeg", "-hide_banner", "-i", str(path), "-map", "0:v:0",  # noqa: S607
         "-c", "copy", "-f", "null", "-"],
        capture_output=True, text=True, check=True, timeout=120,
    )
    counts = re.findall(r"frame=\s*(\d+)", out.stderr)
    if not counts:
        msg = f"no frame count from ffmpeg: {out.stderr[-300:]}"
        raise AssertionError(msg)
    return int(counts[-1])


def _full_timelapse() -> None:
    """``main.style_transfer`` at the shipped video defaults, if it can."""
    missing = []
    if shutil.which("ffmpeg") is None:
        missing.append("ffmpeg not on PATH")
    if importlib.util.find_spec("PIL") is None:
        missing.append("Pillow not importable")
    if missing:
        print(f"timelapse full run: not run: {'; '.join(missing)}")
        return
    from PIL import Image  # noqa: PLC0415 - optional on this machine

    root = Path(__file__).resolve().parent / PACKAGE / "build" / "timelapse"
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    paths = []
    for name, arr in zip(("content", "style"), _images(SIZE, 3)):
        path = root / f"{name}.png"
        Image.fromarray(np.round(arr[0] * 255).astype(np.uint8)).save(path)
        paths.append(str(path))
    steps, every = STEPS, 2
    config = StyleTransferConfig(
        output=OutputConfig(output=str(root / "out"), log_every=LOG_EVERY),
        optimization=OptimizationConfig(
            steps=steps, allow_random_weights=True,
        ),
        video=VideoConfig(save_every=every),
        hardware=HardwareConfig(device="cuda"),
    )
    video = config.video
    t0 = time.perf_counter()
    style_transfer(
        InputPaths(*paths), config, progress_bar=_Progress(),
    )
    seconds = time.perf_counter() - t0
    mp4 = root / "out" / "timelapse_content_x_style.mp4"
    if not mp4.is_file() or mp4.stat().st_size == 0:
        msg = f"no MP4 at {mp4}"
        raise AssertionError(msg)
    fps = video.fps
    expected = (
        max(1, min(round(fps * segments.INTRO_FADE_IN_SECONDS),
                   segments.INTRO_MAX_FADE_FRAMES))
        + round(fps * video.intro_duration_seconds)
        + max(1, min(round(fps * segments.INTRO_CROSSFADE_SECONDS),
                     segments.INTRO_MAX_CROSSFADE_FRAMES))
        + steps // every
        + max(segments.FINAL_TIMELAPSE_MIN_FRAMES,
              round(fps * segments.FINAL_TIMELAPSE_HOLD_SECONDS))
        + max(1, min(round(fps * segments.OUTRO_CROSSFADE_SECONDS),
                     segments.OUTRO_MAX_CROSSFADE_FRAMES))
        + max(segments.FINAL_COMPARISON_MIN_FRAMES,
              round(fps * video.outro_duration_seconds))
    )
    frames = _mp4_frames(mp4)
    if frames != expected:
        msg = f"MP4 has {frames} frames, expected {expected}"
        raise AssertionError(msg)
    written = sorted(p.name for p in (root / "out").iterdir())
    print(
        f"timelapse full run: style_transfer {SIZE}x{SIZE} {steps} steps "
        f"save_every={every}, realtime MP4 with intro and outro: "
        f"{mp4.stat().st_size} bytes, {frames} frames (expected "
        f"{expected}), {seconds:.2f} s; wrote {written}",
    )


def _small_reference() -> None:
    """A 64x64, 3-step run on the card against the same run on the CPU.

    Both start from the content image: the two devices' generators
    draw different random starting images from one seed.
    """
    content, style = _images(64, 1)
    runs = {
        d: run_style_transfer(
            content, style, _config(3, d, init_method="content"),
        )
        for d in ("cuda", "cpu")
    }
    gpu, cpu = (runs[d][1]["total_loss"] for d in ("cuda", "cpu"))
    np.testing.assert_allclose(gpu, cpu, rtol=1e-3)
    img_err = float(
        (runs["cuda"][0].cpu() - runs["cpu"][0]).abs().max(),
    )
    print(f"small reference 64x64 3 steps: cuda {gpu} cpu {cpu} "
          f"image max abs diff {img_err:.3g}")
    # The whole objective: Adam with the TV and Laplacian terms, style
    # weights, a two-style blend, luminance color preservation, and a
    # 2-step warm start at 32x32.
    extra = _images(64, 5)[0]
    runs = {
        d: run_style_transfer(
            content, style,
            _config(
                3, d, init_method="content", optimizer="adam", lr=0.1,
                tv_w=1e-2, lap_w=1e2, coarse_steps=2,
                style_layer_weights=[1, 1, 0.5, 0.25, 0.25],
                preserve_color="luminance",
            ),
            style_blend=[(style, 0.7), (extra, 0.3)],
        )
        for d in ("cuda", "cpu")
    }
    gpu, cpu = (runs[d][1]["total_loss"] for d in ("cuda", "cpu"))
    np.testing.assert_allclose(gpu, cpu, rtol=1e-3)
    img_err = float(
        (runs["cuda"][0].cpu() - runs["cpu"][0]).abs().max(),
    )
    print(f"small reference 64x64 whole objective, Adam, 2 coarse steps "
          f"at 32x32, 3 steps: cuda {gpu} cpu {cpu} image max abs diff "
          f"{img_err:.3g}")


class _LogLines(logging.Handler):
    """Keeps the port logger's messages while a phase runs."""

    def __init__(self) -> None:
        """Start empty."""
        super().__init__()
        self.lines: list[str] = []

    def emit(self, record: logging.LogRecord) -> None:
        """Keep one message."""
        self.lines.append(record.getMessage())


def _convs_through(arch, last: int) -> int:
    return sum(1 for i in arch.conv_indices if i <= last)


def _launches_wanted(
    arch, opt, size: int, styles: int, *, steps: int | None = None,
    content_sweeps: int = 1, grams_per_tap: int = 1,
) -> tuple[int, int]:
    """Conv and Gram launches of a run, worked out from the code.

    ``opt`` is the run's optimization config as the run left it (its
    ``coarse_steps`` resolved), ``size`` the content's side and
    ``styles`` the number of styles whose targets are made.

    Targets: each style's sweep to the deepest style tap (one Gram per
    style tap) and one content sweep to the deepest content tap
    (``targets_maybe_blended``: the content layers ride with the first
    style only), at full size and again at each coarse level. A step
    with one evaluation (L-BFGS ``max_iter=1`` or Adam): the sweep to
    the deepest tap, every conv's input gradient (the image is the
    leaf), and ``grams_per_tap`` Grams per style tap. ``steps``
    (default ``opt.steps``) counts the full-size steps of every frame
    of a sweep or a sequence; ``content_sweeps`` the content targets
    made (a sequence makes each frame's); the regional run takes one
    masked Gram per style and tap (``grams_per_tap``).
    """
    plan = plan_pyramid(size, size, opt.coarse_steps, opt.pyramid_levels)
    style_convs = _convs_through(arch, max(opt.style_layers))
    content_convs = _convs_through(arch, max(opt.content_layers))
    step_convs = 2 * _convs_through(
        arch, max(opt.style_layers + opt.content_layers),
    )
    n_style = len(opt.style_layers)
    resolutions = 1 + len(plan)
    total_steps = (
        (opt.steps if steps is None else steps)
        + sum(level[2] for level in plan)
    )
    conv = (
        resolutions * (styles * style_convs + content_sweeps * content_convs)
        + step_convs * total_steps
    )
    gram = (
        resolutions * styles * n_style
        + grams_per_tap * n_style * total_steps
    )
    return conv, gram


def _chroma_error(image: torch.Tensor, content: np.ndarray) -> float:
    """Largest YIQ chrominance difference where no channel is clipped."""
    out = image[0].double().cpu().numpy()
    unclipped = ((out > 1e-6) & (out < 1 - 1e-6)).all(axis=-1)
    if unclipped.mean() < 0.5:  # noqa: PLR2004
        msg = f"only {unclipped.mean():.3f} of the pixels are unclipped"
        raise AssertionError(msg)
    to_iq = RGB_TO_YIQ[1:].T
    diff = np.abs(out @ to_iq - content[0].astype(np.float64) @ to_iq)
    return float(diff[unclipped].max())


def _objective() -> tuple[int, int]:
    """The whole objective at 1024x1024 through ``run_style_transfer``.

    Full-width VGG19 (seeded), two 1024x1024 styles (numpy seeds 2 and
    3) blended 0.7/0.3, TV and Laplacian terms, per-layer style
    weights, luminance color preservation, the shipped L-BFGS for 20
    steps with the warm start left at auto: 4 steps at 512x512 first.
    """
    size = OBJECTIVE_SIZE
    content = _images(size, 1)[0]
    styles = [_images(size, seed)[0] for seed in (2, 3)]
    blend = list(zip(styles, (0.7, 0.3), strict=True))

    before = _fresh_peak()
    logs = _LogLines()
    logger.addHandler(logs)
    counted = _config(
        STEPS, "cuda", tv_w=1e-2, lap_w=1e2,
        style_layer_weights=[1, 1, 0.5, 0.25, 0.25],
        preserve_color="luminance",
    )
    try:
        with _dispatch_log() as log:
            (image, history), run_s, launches = _counted_run(
                lambda: run_style_transfer(
                    content, styles[0], counted, style_blend=blend,
                ),
            )
    finally:
        logger.removeHandler(logs)
    peak = torch.cuda.max_memory_allocated()

    coarse_steps = counted.optimization.coarse_steps
    half = size // 2
    started = f"Coarse warm start: {coarse_steps} steps at {half}x{half}"
    done = f"Coarse level {half}x{half} done"
    if coarse_steps != STEPS // 5 or not all(
        any(line.startswith(want) for line in logs.lines)
        for want in (started, done)
    ):
        msg = f"coarse warm start did not run: {logs.lines}"
        raise AssertionError(msg)
    losses = history["total_loss"]
    want = _launches_wanted(
        VGG19, counted.optimization, size, len(blend),
    )
    _check_run("objective", image, losses, launches, want, size)
    chroma = _chroma_error(image, content)
    if not chroma <= CHROMA_TOL:
        msg = f"objective: chrominance off by {chroma:.3g} > {CHROMA_TOL}"
        raise AssertionError(msg)
    # The full-size steps alone: the warm start's level is another
    # chunk.
    ms_step = log.ms_per_step()
    print(
        f"objective {size}x{size} vgg19 L-BFGS {STEPS} steps, blend "
        f"0.7/0.3, tv_w 1e-2, lap_w 1e2, style weights 1,1,0.5,0.25,0.25,"
        f" luminance: coarse warm start {coarse_steps} steps at "
        f"{half}x{half} ran; loss {losses[0]:.6g} -> {losses[-1]:.6g}; "
        f"launches conv {launches[0]} gram {launches[1]} (expected "
        f"{want}); chrominance max abs diff {chroma:.3g} (tol "
        f"{CHROMA_TOL}); ms/step at {size}x{size} {ms_step:.3f}; run s "
        f"{run_s:.3f}; max_memory_allocated {peak}, of which allocated "
        f"before the run {before} (the run's own {peak - before})",
    )
    return launches


def _adam_vgg16() -> tuple[int, int]:
    """Adam on full-width VGG16 (seeded) at 512x512, 20 steps.

    ``lr`` 0.1, the rate the golden corpus runs Adam at (the shipped
    1.0 is L-BFGS's step scale).
    """
    content, style = _images(SIZE, 4)
    counted = _config(
        STEPS, "cuda", model="vgg16", optimizer="adam", lr=0.1,
    )
    with _dispatch_log() as log:
        (image, history), run_s, launches = _counted_run(
            lambda: run_style_transfer(content, style, counted),
        )
    losses = history["total_loss"]
    want = _launches_wanted(VGG16, counted.optimization, SIZE, 1)
    _check_run("adam vgg16", image, losses, launches, want, SIZE)
    ms_step = log.ms_per_step()
    print(
        f"adam vgg16 {SIZE}x{SIZE} {STEPS} steps lr 0.1: loss "
        f"{losses[0]:.6g} -> {losses[-1]:.6g}; launches conv "
        f"{launches[0]} gram {launches[1]} (expected {want}); ms/step "
        f"{ms_step:.3f}; run s {run_s:.3f}",
    )
    return launches

def _style_arrays(n: int) -> list[np.ndarray]:
    """``n`` style images: numpy seeds 2, 3, ...; seed 5's is 384x640."""
    out = []
    for seed in range(2, 2 + n):
        h, w = ODD_STYLE[1] if seed == ODD_STYLE[0] else (SIZE, SIZE)
        rng = np.random.default_rng(seed)
        out.append(rng.uniform(size=(1, h, w, 3)).astype(np.float32))
    return out


def _batch_config(steps: int, *, media: bool, **opt):
    """The batch phase's config: shipped defaults from the content."""
    config = _config(steps, "cuda", init_method="content", **opt)
    config.output.plot_losses = False
    config.video.save_every = BATCH_SAVE_EVERY
    config.video.create_gif = media
    config.video.create_video = media
    return config


def _batch_run(content, styles, config, params=None, *, sinks=None,
               capture=None):
    """``prepare_multi_style`` then ``run_multi_style_loop``.

    Returns the final stacked images, the last state, the bundle, the
    ``(steps, S)`` losses (kept on the device until the end), the host
    clock at the end of each step and the conv and Gram launches of the
    step loop alone. ``sinks`` (a dict) collects in-memory sinks by
    file name; ``capture(step, images)`` sees every step.
    """
    bundle, images = prepare_multi_style(
        content, styles, config, params=params,
    )
    prepared = _launched()
    losses: list[torch.Tensor] = []
    step_ends: list[float] = []

    def on_step_end(step, imgs, aux):
        losses.append(aux.loss)
        step_ends.append(time.perf_counter())
        if capture is not None:
            capture(step, imgs)

    def make_sink(kind, name):
        del kind
        sinks[name] = _FrameSink()
        return sinks[name]

    images, state, errors = run_multi_style_loop(
        bundle, images, config,
        Path(__file__).resolve().parent / PACKAGE / "build" / "batch",
        [f"s{i}" for i in range(len(styles))],
        progress_bar=_Progress(),
        make_sink=make_sink if sinks is not None else None,
        on_step_end=on_step_end,
    )
    if errors:
        raise errors[0]
    loop_launches = tuple(
        n - m for n, m in zip(_launched(), prepared, strict=True)
    )
    return (
        images, state, bundle, torch.stack(losses), step_ends,
        loop_launches,
    )


def _packed(images: torch.Tensor) -> torch.Tensor:
    return image_io.pack_uint8_frames_batch(
        image_io.prepare_image_for_output(images, normalize=True),
    )


def _batch() -> tuple[int, int]:
    """The multi-style batch at 512x512: S = 4, then S = 1, 4 and 8."""
    content = _images(SIZE, 1)[0]
    styles = _style_arrays(max(BATCH_TIMED))
    params = load_pretrained_params(
        torch.device("cuda"), allow_random=True, seed=0,
    )
    config = _batch_config(STEPS, media=True)
    sinks: dict[str, _FrameSink] = {}
    cadence: list[torch.Tensor] = []

    def capture(step, imgs):
        if step % BATCH_SAVE_EVERY == 0:
            cadence.append(_packed(imgs))

    before = _fresh_peak()
    (images, _, _, losses, _, _), run_s, launches = _counted_run(
        lambda: _batch_run(
            content, styles[:BATCH_STYLES], config, params, sinks=sinks,
            capture=capture,
        ),
    )
    peak = torch.cuda.max_memory_allocated()
    want = _launches_wanted(
        VGG19, config.optimization, SIZE, BATCH_STYLES,
    )
    if launches != want:
        msg = f"batch: launches conv/gram {launches}, expected {want}"
        raise AssertionError(msg)
    curves = losses.cpu().numpy()
    if curves.shape != (STEPS, BATCH_STYLES) or not np.isfinite(
        curves,
    ).all() or not (curves[-1] < curves[0]).all():
        msg = f"batch: losses not finite and decreasing: {curves}"
        raise AssertionError(msg)
    final = _packed(images).cpu().numpy()
    expected = [c.cpu().numpy() for c in cadence]
    if len(sinks) != 2 * BATCH_STYLES:
        msg = f"batch: sinks {sorted(sinks)}"
        raise AssertionError(msg)
    for name, sink in sinks.items():
        i = int(name.rsplit("_s", 1)[1].split(".")[0])
        frames = sink.frames
        if len(frames) != STEPS // BATCH_SAVE_EVERY or any(
            f.shape != (SIZE, SIZE, 3) or f.dtype != np.uint8
            for f in frames
        ):
            msg = f"batch {name}: {len(frames)} frames"
            raise AssertionError(msg)
        if not all(
            np.array_equal(f, e[i]) for f, e in zip(frames, expected,
                                                    strict=True)
        ):
            msg = f"batch {name}: frames out of step order"
            raise AssertionError(msg)
        if not np.array_equal(frames[-1], final[i]):
            msg = f"batch {name}: last frame is not the final image"
            raise AssertionError(msg)
    # Each style's curve against a single run of that style, and the
    # same single run with its content perturbed by 1e-7 relative: the
    # shipped fixed-step L-BFGS grows such a difference past 1e-3, so
    # the batch keeps each style's arithmetic the single run's.
    single_err, image_err = [], []
    for i in range(BATCH_STYLES):
        single_image, history = run_style_transfer(
            content, styles[i], _config(STEPS, "cuda", init_method="content"),
        )
        single = np.asarray(history["total_loss"])
        rel = np.abs(curves[:, i] - single) / np.abs(single)
        if not rel.max() <= 1e-3:  # noqa: PLR2004
            msg = (
                f"batch style {i}: curve off its single run by "
                f"{rel.max():.3g}: {curves[:, i]} vs {single}"
            )
            raise AssertionError(msg)
        single_err.append(float(rel.max()))
        batch_image = image_io.prepare_image_for_output(
            images[i], normalize=True,
        )
        image_err.append(float((batch_image - single_image).abs().max()))
    rng = np.random.default_rng(9)
    nudged = content * (1 + 1e-7 * rng.standard_normal(content.shape))
    _, history = run_style_transfer(
        nudged.astype(np.float32), styles[0],
        _config(STEPS, "cuda", init_method="content"),
    )
    _, base = run_style_transfer(
        content, styles[0], _config(STEPS, "cuda", init_method="content"),
    )
    nudge_err = float(np.max(
        np.abs(np.asarray(history["total_loss"]) - base["total_loss"])
        / np.abs(base["total_loss"]),
    ))
    print(
        f"batch {SIZE}x{SIZE} vgg19 L-BFGS S={BATCH_STYLES} (styles "
        f"{[tuple(x.shape[1:3]) for x in styles[:BATCH_STYLES]]}) {STEPS} "
        f"steps save_every={BATCH_SAVE_EVERY} GIF+MP4 in memory: losses "
        f"{curves[0].tolist()} -> {curves[-1].tolist()}; launches conv "
        f"{launches[0]} gram {launches[1]} (expected {want}); "
        f"{STEPS // BATCH_SAVE_EVERY} frames per style and sink in step "
        f"order, the last equal to the final image; each style's curve "
        f"within {max(single_err):.3g} relative of its single run "
        f"(per style {[f'{e:.3g}' for e in single_err]}), final images "
        f"max abs diff {image_err} (a single run against itself with its "
        f"content perturbed by 1e-7 relative: {nudge_err:.3g}); run s "
        f"{run_s:.3f}; max_memory_allocated {peak}, of which allocated "
        f"before the run {before} (the run's own {peak - before})",
    )
    _batch_speed(content, styles, params)
    return launches


def _batch_speed(content, styles, params) -> None:
    """Frames off: S = 1, 4, 8 and the single run, rounds interleaved."""
    gaps: dict[str, list[float]] = {"single": []}
    gaps |= {f"S={n}": [] for n in BATCH_TIMED}
    peaks: dict[str, int] = {}
    steps_launches: dict[str, tuple[int, int]] = {}
    last = {}
    for _ in range(BATCH_ROUNDS):
        run = _timelapse_run(content, styles[0], params, STEPS, None)
        gaps["single"].append(float(np.mean(np.diff(run[5][2:]))) * 1e3)
        for n in BATCH_TIMED:
            config = _batch_config(STEPS, media=False)
            before = _fresh_peak()
            out, _, counts = _counted_run(
                lambda n=n, config=config: _batch_run(
                    content, styles[:n], config, params,
                ),
            )
            key = f"S={n}"
            peaks[key] = torch.cuda.max_memory_allocated() - before
            want = _launches_wanted(VGG19, config.optimization, SIZE, n)
            if counts != want:
                msg = f"batch {key}: launches {counts}, expected {want}"
                raise AssertionError(msg)
            steps_launches[key] = tuple(c / STEPS for c in out[5])
            gaps[key].append(float(np.mean(np.diff(out[4][2:]))) * 1e3)
            last[key] = out
    ms = {k: statistics.median(v) for k, v in gaps.items()}
    busy = {}
    for n in BATCH_TIMED:
        key = f"S={n}"
        images, state, bundle, _, _, _ = last.pop(key)
        busy[key] = _profiled_steps(
            bundle, {"image": images, "state": state}, "graphed", 3,
        )[0] / ms[key]
        del images, state, bundle
    if len(set(steps_launches.values())) != 1:
        msg = f"batch: a step's launches grow with S: {steps_launches}"
        raise AssertionError(msg)
    print(
        f"batch speed {SIZE}x{SIZE} frames off, {BATCH_ROUNDS} rounds "
        f"interleaved, median of the mean step interval over steps 3-{STEPS}:"
        + "".join(
            f" {k} {v:.3f} ms/step"
            + (f" {int(k[2:]) * 1e3 / v:.2f} style-steps/s" if k != "single"
               else f" {1e3 / v:.2f} steps/s")
            for k, v in ms.items()
        )
        + f"; rounds {gaps}; device busy share (the profiler's device ms "
        f"of 3 graphed steps, over the step interval) "
        + ", ".join(f"{k} {v:.3f}" for k, v in busy.items())
        + f"; launches per step conv/gram {steps_launches['S=1']} at every "
        f"S; the run's own peak memory "
        + ", ".join(f"{k} {v}" for k, v in peaks.items()),
    )


def _small_batch_reference() -> None:
    """A 64x64 batch of 2 on the card against the same on the CPU.

    As the single run's whole-objective reference: Adam with every term
    (TV, Laplacian, per-layer style weights, luminance) and a 2-step
    warm start at 32x32; both start from the content image. (The
    shipped fixed-step L-BFGS grows the card's and the CPU's rounding
    differences past 1e-3 within a few steps; the batch phase holds the
    batched L-BFGS to the single one on the card, and the first
    reference holds that to the CPU.)
    """
    content = _images(64, 1)[0]
    styles = [_images(64, 5)[0], _images(64, 6)[0]]
    runs = {}
    for device in ("cuda", "cpu"):
        config = _config(
            3, device, init_method="content", optimizer="adam", lr=0.1,
            tv_w=1e-2, lap_w=1e2, coarse_steps=2,
            style_layer_weights=[1, 1, 0.5, 0.25, 0.25],
            preserve_color="luminance",
        )
        config.output.plot_losses = False
        config.video.create_video = False
        bundle, images = prepare_multi_style(content, styles, config)
        losses = []
        images, _, _ = run_multi_style_loop(
            bundle, images, config, Path("unused"), ["a", "b"],
            progress_bar=_Progress(),
            on_step_end=lambda _s, _i, aux, out=losses: out.append(aux.loss),
        )
        runs[device] = (torch.stack(losses).cpu().numpy(), images.cpu())
    gpu, cpu = runs["cuda"][0], runs["cpu"][0]
    np.testing.assert_allclose(gpu, cpu, rtol=1e-3)
    img_err = float((runs["cuda"][1] - runs["cpu"][1]).abs().max())
    print(
        f"small reference 64x64 batch of 2, whole objective, Adam, 2 "
        f"coarse steps at 32x32, 3 steps: cuda {gpu.tolist()} cpu "
        f"{cpu.tolist()} image max abs diff {img_err:.3g}",
    )


# ---- checkpoints and resume; the warm start at 4 MP


def _work_dir(name: str) -> Path:
    """An empty scratch directory under the package's ignored build/."""
    path = Path(__file__).resolve().parent / PACKAGE / "build" / name
    shutil.rmtree(path, ignore_errors=True)
    path.mkdir(parents=True)
    return path


def _same_npz(a: Path, b: Path) -> list[str]:
    """The keys of two ``.npz`` files whose arrays differ (dtype or bits)."""
    with np.load(a) as x, np.load(b) as y:
        if x.files != y.files:
            return ["<keys>"]
        return [
            k for k in x.files
            if x[k].dtype != y[k].dtype or not np.array_equal(x[k], y[k])
        ]


def _csv_rows(path: Path) -> list[list[str]]:
    with path.open(encoding="utf-8") as fh:
        return [line.rstrip("\n").split(",") for line in fh]


def _curve(path: Path) -> np.ndarray:
    return np.array(
        [float(row[3]) for row in _csv_rows(path)[1:]], dtype=np.float64,
    )


def _nudged_control(content, style) -> float:
    """A single run against itself with its content perturbed by 1e-7
    relative: the largest relative curve difference over 20 steps."""
    curves = []
    for image in (content, content * (1 + 1e-7 * np.random.default_rng(9)
                                      .standard_normal(content.shape))):
        _, history = run_style_transfer(
            image.astype(np.float32), style, _config(STEPS, "cuda"),
        )
        curves.append(np.asarray(history["total_loss"]))
    return float(np.max(np.abs(curves[1] - curves[0]) / np.abs(curves[0])))


def _resume_gate(label, differ_whole, differ_resumed, rows_equal,
                 curve_err, control) -> str:
    """Bit-equal resume when the card repeats a run bit for bit; else
    the resumed curve within the perturbed-content control."""
    if not rows_equal and not differ_whole:
        msg = f"{label}: the resumed CSV rows differ from the whole run's"
        raise AssertionError(msg)
    if not differ_whole:
        if differ_resumed:
            msg = f"{label}: resumed run differs in {differ_resumed}"
            raise AssertionError(msg)
        return "bit-equal (image and every state leaf), CSV rows equal"
    if control is None or not curve_err <= max(control, 1e-3):
        msg = (
            f"{label}: the card does not repeat a run ({differ_whole}) and "
            f"the resumed curve is off by {curve_err:.3g} (control "
            f"{control})"
        )
        raise AssertionError(msg)
    return (
        f"NOT deterministic on this card ({differ_whole} differ between "
        f"two whole runs); resumed curve within {curve_err:.3g} relative, "
        f"perturbed-content control {control:.3g}"
    )


def _save_seconds(path: Path, like_state, reps: int = 2) -> list[float]:
    """Seconds of ``save_checkpoint`` of the checkpoint at ``path``."""
    ckpt = load_checkpoint(path, like_state, "cuda")
    out = []
    for i in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(path.with_name(f"timed{i}.npz"), ckpt.step,
                        ckpt.image, ckpt.opt_state)
        out.append(time.perf_counter() - t0)
    return out


def _resume_single() -> tuple[int, int]:
    """The single run resumed through ``cli.main`` and a TOML, 512x512.

    The shipped L-BFGS, frames off, a CSV row every step. Two whole
    20-step runs first (does the card repeat a run bit for bit?), then
    10 steps with ``--checkpoint-every 10`` and ``--steps 20
    --resume-from`` that checkpoint: the resumed run's checkpoint at
    step 20 against the whole run's, the CSVs' rows, the PNGs. Then
    ms/step with ``checkpoint_every=10`` against off (the dispatch
    window of a 20-step run, which holds the step-10 save; the step-20
    save follows the last dispatch; rounds interleaved), the
    checkpoint's bytes and the save's seconds.
    """
    work = _work_dir("resume")
    content, style = _images(SIZE, 0)
    for name, array in (("c", content), ("s", style)):
        image_io.save_array_as_image(
            torch.from_numpy(array), work / f"{name}.png",
        )
    toml = work / "run.toml"
    toml.write_text(
        f"[optimization]\nsteps = {STEPS}\nallow_random_weights = true\n"
        '[hardware]\ndevice = "cuda"\n[video]\nfinal_only = true\n'
        f"[output]\nlog_every = 1\ncheckpoint_every = {STEPS // 2}\n",
    )

    def cli_run(name: str, *extra: str) -> Path:
        out = work / name
        argv = [
            "--content", str(work / "c.png"), "--style", str(work / "s.png"),
            "--config", str(toml), "--output", str(out),
            "--log-loss", str(out / "l.csv"),
            "--checkpoint-path", str(out / "ck.npz"), *extra,
        ]
        if cli.main(argv) != 0:
            msg = f"resume: cli.main({argv}) failed"
            raise AssertionError(msg)
        return out

    whole, again = cli_run("whole"), cli_run("again")
    part = cli_run("part", "--steps", str(STEPS // 2))
    shutil.copy(part / "ck.npz", part / "at10.npz")
    _, run_s, launches = _counted_run(
        lambda: cli_run("part", "--resume-from", str(part / "at10.npz")),
    )
    differ_whole = _same_npz(whole / "ck.npz", again / "ck.npz")
    differ = _same_npz(whole / "ck.npz", part / "ck.npz")
    rows_equal = _csv_rows(whole / "l.csv") == _csv_rows(part / "l.csv")
    if len(_csv_rows(whole / "l.csv")) != STEPS + 1:
        msg = "resume: the whole run's CSV has the wrong row count"
        raise AssertionError(msg)
    png = "stylized_c_x_s.png"
    png_equal = (work / "whole" / png).read_bytes() == (
        part / png
    ).read_bytes()
    curve_err = float(np.max(
        np.abs(_curve(part / "l.csv") - _curve(whole / "l.csv"))
        / np.abs(_curve(whole / "l.csv")),
    ))
    verdict = _resume_gate(
        "resume", differ_whole, differ, rows_equal, curve_err,
        _nudged_control(content, style) if differ_whole else None,
    )
    opt = _config(STEPS // 2, "cuda").optimization
    want = _launches_wanted(VGG19, opt, SIZE, 1)
    if launches != want:
        msg = f"resume: launches conv/gram {launches}, expected {want}"
        raise AssertionError(msg)
    ckpt_bytes = (part / "at10.npz").stat().st_size
    like = prepare_model_and_input(
        content, style, _config(STEPS, "cuda"),
    )[0].opt_state
    save_s = _save_seconds(part / "at10.npz", like)
    del like
    ms = {"off": [], "every 10": []}
    for key, every in (("off", 0), ("every 10", STEPS // 2)):
        config = _config(STEPS, "cuda")
        config.output.checkpoint_every = every
        config.output.checkpoint_path = str(work / "timed.npz")
        with _dispatch_log() as log:
            run_style_transfer(content, style, config)
        ms[key].append(log.ms_per_step())
    shutil.rmtree(work, ignore_errors=True)
    print(
        f"resume {SIZE}x{SIZE} vgg19 L-BFGS (cli.main --config TOML, "
        f"frames off, CSV every step): two whole {STEPS}-step runs "
        f"bit-equal: {not differ_whole}; {STEPS // 2} steps + "
        f"--resume-from to {STEPS}: {verdict}; final PNGs equal "
        f"{png_equal}; resumed curve max rel diff {curve_err:.3g}; "
        f"launches of the resumed run conv {launches[0]} gram "
        f"{launches[1]} (expected {want}); run s {run_s:.3f}; checkpoint "
        f"bytes {ckpt_bytes}; save s {[round(t, 4) for t in save_s]}; "
        f"ms/step checkpoint_every=10 (steps 2-20, the step-10 save "
        f"within) {[round(v, 3) for v in ms['every 10']]} (median "
        f"{statistics.median(ms['every 10']):.3f}) vs off "
        f"{[round(v, 3) for v in ms['off']]} (median "
        f"{statistics.median(ms['off']):.3f})",
    )
    return launches


def _resume_batch() -> tuple[int, int]:
    """The batch resumed: S = 4 through ``prepare_multi_style`` and
    ``run_multi_style_loop``, the same gate for every style."""
    work = _work_dir("resume_batch")
    content = _images(SIZE, 1)[0]
    styles = _style_arrays(BATCH_STYLES)
    params = load_pretrained_params(
        torch.device("cuda"), allow_random=True, seed=0,
    )
    names = [f"s{i}" for i in range(BATCH_STYLES)]

    def run(name: str, steps: int, resume: Path | None = None,
            every: int = STEPS // 2):
        out = work / name
        config = _batch_config(steps, media=False)
        config.output.log_every = 1
        config.output.log_loss = str(out / "l.csv")
        config.output.checkpoint_every = every
        config.output.checkpoint_path = str(out / "ck.npz")
        if resume is not None:
            config.output.resume_from = str(resume)
        bundle, images = prepare_multi_style(
            content, styles, config, params=params,
        )
        images, state, errors = run_multi_style_loop(
            bundle, images, config, out, names, progress_bar=_Progress(),
        )
        if errors:
            raise errors[0]
        return images, state

    # The whole runs save at step 20 only (chunks of 20, against the
    # resumed run's 10: graphed steps are the same whatever the chunk).
    whole, _ = run("whole", STEPS, every=STEPS)
    again, _ = run("again", STEPS, every=STEPS)
    run("part", STEPS // 2)
    part = work / "part"
    shutil.copy(part / "ck.npz", part / "at10.npz")
    (resumed, state), run_s, launches = _counted_run(
        lambda: run("part", STEPS, part / "at10.npz"),
    )
    differ_whole = _same_npz(work / "whole" / "ck.npz",
                             work / "again" / "ck.npz")
    differ = _same_npz(work / "whole" / "ck.npz", part / "ck.npz")
    images_equal = [bool(torch.equal(whole[i], resumed[i]))
                    for i in range(BATCH_STYLES)]
    if not differ_whole and not all(images_equal):
        differ.append("images")
    rows_equal = all(
        _csv_rows(work / "whole" / f"l_{n}.csv")
        == _csv_rows(part / f"l_{n}.csv")
        for n in names
    )
    curve_err = max(
        float(np.max(
            np.abs(_curve(part / f"l_{n}.csv")
                   - _curve(work / "whole" / f"l_{n}.csv"))
            / np.abs(_curve(work / "whole" / f"l_{n}.csv")),
        ))
        for n in names
    )
    verdict = _resume_gate(
        "resume batch", differ_whole, differ, rows_equal, curve_err,
        _nudged_control(content, styles[0]) if differ_whole else None,
    )
    want = _launches_wanted(
        VGG19, _batch_config(STEPS // 2, media=False).optimization, SIZE,
        BATCH_STYLES,
    )
    if launches != want:
        msg = f"resume batch: launches conv/gram {launches}, expected {want}"
        raise AssertionError(msg)
    ckpt_bytes = (part / "at10.npz").stat().st_size
    save_s = _save_seconds(part / "at10.npz", state)
    del whole, again, resumed, state, params
    shutil.rmtree(work, ignore_errors=True)
    print(
        f"resume batch {SIZE}x{SIZE} vgg19 L-BFGS S={BATCH_STYLES} "
        f"(prepare_multi_style + run_multi_style_loop, frames off, CSVs "
        f"every step): two whole {STEPS}-step runs bit-equal: "
        f"{not differ_whole}; {STEPS // 2} steps + resume to {STEPS}: "
        f"{verdict}; each style's final image bit-equal {images_equal}; "
        f"resumed curves max rel diff {curve_err:.3g}; launches of the "
        f"resumed run conv {launches[0]} gram {launches[1]} (expected "
        f"{want}); run s {run_s:.3f}; checkpoint bytes {ckpt_bytes}; save "
        f"s {[round(t, 4) for t in save_s]}",
    )
    return launches


WARM_SIDE = 4096
WARM_STEPS = 15  # auto coarse budget steps // 5 = 3 steps at 2048x2048


def _warm_start_4mp() -> tuple[int, int]:
    """The auto warm start of 4096x4096 content: a 2048x2048 level.

    Seeded 4096x4096 content and a 512x512 style, ``coarse_steps`` left
    at auto for a 15-step run: 3 steps at 2048x2048 through
    ``engine.coarse.coarse_init``. The level's peak memory, and its ms
    per coarse step as the difference of a 6-step and a 3-step level
    over 3.
    """
    rng = np.random.default_rng(11)
    content = rng.uniform(size=(1, WARM_SIDE, WARM_SIDE, 3)).astype(
        np.float32,
    )
    style = _images(SIZE, 12)[0]
    params = load_pretrained_params(
        torch.device("cuda"), allow_random=True, seed=0,
    )
    config = _config(WARM_STEPS, "cuda")
    content_img = image_io.host_array_to_device(content, "cuda",
                                                normalize=True)
    style_img = image_io.host_array_to_device(style, "cuda", normalize=True)
    del content
    coarse_steps = resolve_coarse_steps(-1, WARM_SIDE, WARM_SIDE, WARM_STEPS)
    plan = plan_pyramid(WARM_SIDE, WARM_SIDE, coarse_steps, 2)
    if plan != [(WARM_SIDE // 2, WARM_SIDE // 2, 3)]:
        msg = f"warm start: schedule {plan}, expected one 2048x2048 level"
        raise AssertionError(msg)

    def level(steps: int) -> torch.Tensor:
        config.optimization.coarse_steps = steps
        return coarse_init(
            params, content_img, style_img, config,
            torch.Generator(device="cuda").manual_seed(0),
        )

    before = _fresh_peak()
    logs = _LogLines()
    logger.addHandler(logs)
    try:
        warm, run_s, launches = _counted_run(lambda: level(coarse_steps))
    finally:
        logger.removeHandler(logs)
    peak = torch.cuda.max_memory_allocated()
    if tuple(warm.shape) != (1, WARM_SIDE, WARM_SIDE, 3) or not bool(
        torch.isfinite(warm).all(),
    ):
        msg = f"warm start: bad image {tuple(warm.shape)}"
        raise AssertionError(msg)
    done = [line for line in logs.lines if line.startswith("Coarse level")]
    opt = config.optimization
    style_convs = _convs_through(VGG19, max(opt.style_layers))
    content_convs = _convs_through(VGG19, max(opt.content_layers))
    step_convs = 2 * _convs_through(
        VGG19, max(opt.style_layers + opt.content_layers),
    )
    n_style = len(opt.style_layers)
    want = (
        style_convs + content_convs + step_convs * coarse_steps,
        n_style * (1 + coarse_steps),
    )
    if launches != want or len(done) != 1:
        msg = f"warm start: launches {launches} (expected {want}), {done}"
        raise AssertionError(msg)
    del warm
    seconds = {}
    for steps in (coarse_steps, 2 * coarse_steps, coarse_steps,
                  2 * coarse_steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        level(steps)
        torch.cuda.synchronize()
        seconds.setdefault(steps, []).append(time.perf_counter() - t0)
    ms_step = (
        (min(seconds[2 * coarse_steps]) - min(seconds[coarse_steps]))
        / coarse_steps * 1e3
    )
    del content_img, style_img, params
    print(
        f"warm start 4 MP: content {WARM_SIDE}x{WARM_SIDE}, auto "
        f"coarse_steps {coarse_steps} at {WARM_SIDE // 2}x"
        f"{WARM_SIDE // 2} ({(WARM_SIDE // 2) ** 2} px) through "
        f"coarse_init: ran ({done[0]}); launches conv {launches[0]} gram "
        f"{launches[1]} (expected {want}); max_memory_allocated {peak}, of "
        f"which allocated before {before} (the level's own "
        f"{peak - before}); ms per coarse step {ms_step:.3f} (6-step minus "
        f"3-step level over 3, least of 2 rounds: {seconds}); run s "
        f"{run_s:.3f}",
    )
    return launches


def _check_level_kernels(conv_rec, conv_level, gram_rec, gram_level):
    """Both kernels at the 2048x2048 level's first shapes.

    The first two convs (3 -> 64 and 64 -> 64 at 2048x2048) and the
    first tap's Gram (P = 4,194,304, C = 64), each within 1e-4 of its
    plain version and timed (``level_2048_first`` in the JSON record).
    """
    side = WARM_SIDE // 2
    _check_conv(conv_rec, [
        (1, side, side, ci, co, n, f, conv_level)
        for _, ci, co, n, f in CONV_SHAPES[:2]
    ])
    _check_gram_cases(
        gram_rec, [(side * side, GRAM_SHAPES[0][1], gram_level)],
        torch.Generator(device="cuda").manual_seed(3),
    )
    gc.collect()
    torch.cuda.empty_cache()


# ---- banded evaluation and remat

# The 4K band: 3840x2160 content in 3 bands of 720 rows, each window
# 720 + 2 x 80 rows (VGG19's margin to layer 28); 8K UHD through the
# entry point at the H100 thresholds; remat at 2048x2048 and S = 4.
BAND_HW = (2160, 3840)
BAND_ROWS = 720
BAND_STEPS = 3
BAND_ADAM_STEPS = 5
BAND_8K_HW = (4320, 7680)
REMAT_SIDE = 2048
# Step 0, whole against banded (each from its own targets): the loss
# and the gradient's largest difference over its largest magnitude, as
# the CPU tests hold the banded loss against the JAX package's.
BAND_LOSS_TOL = 1e-5
BAND_GRAD_TOL = 1e-4
# A graphed run's own peak against the eager run's (PERF.md section 2).
PEAK_RATIO = 1.10
# The shipped taps (VGG19 style 0, 5, 10, 19, 28; content 21).
SHIPPED_TAPS = (0, 5, 10, 19, 21, 28)


def _band_window() -> int:
    """Rows of the 4K band's window: 720 + 2 x the shipped margin."""
    return BAND_ROWS + 2 * tiled.receptive_margin(SHIPPED_TAPS)[0]


def _check_band_kernels(recs: dict[str, tuple[Record, Record]]) -> None:
    """Both kernels at the 4K band's first window, in every mode.

    The convs 3 -> 64 and 64 -> 64 at 880x3840 (forward with and without
    its ReLU, the masked input gradient) and the raw Gram of the first
    tap's band rows (P = 720 x 3840 = 2,764,800, C = 64) launched as
    ``ops.gram.gram_raw`` launches it (clamp ``inf``, norm 1: G bit-equal
    to raw), and its gradient through ``gram_raw`` against the plain
    ``F (dG + dG^T)``: each within 1e-4 of the mode's plain version.
    Timed as a band's step runs them: 2 forwards (the forward and the
    checkpoint's recompute) and 1 input gradient a conv, 2 Grams.
    ``recs[mode]`` is the mode's (conv, Gram) record of the shape set
    ``band_4k_first``.
    """
    gen = torch.Generator(device="cuda").manual_seed(23)
    rows, width = _band_window(), BAND_HW[1]
    for mode in MODES:
        conv_rec, gram_rec = recs[mode]
        kern = partial(conv3x3.conv3x3_kernel, mode=mode)
        plain = partial(conv3x3.conv3x3_plain, mode=mode)
        for ci, co, fused in ((3, 64, False), (64, 64, True)):
            x = torch.randn((1, rows, width, ci), generator=gen,
                            device="cuda")
            w9 = torch.randn((9, ci, co), generator=gen, device="cuda") * (
                (2.0 / (9 * ci)) ** 0.5
            )
            b = 0.1 * torch.randn((co,), generator=gen, device="cuda")
            g = torch.randn((1, rows, width, co), generator=gen,
                            device="cuda")
            w9f = flip_stencil(w9)
            st = conv3x3.mode_stencil(mode, w9, pack_stencil(w9))
            stf = conv3x3.mode_stencil(mode, w9f, pack_stencil(w9f))
            label = f"band 1x{rows}x{width} {ci}->{co} {mode}"
            for relu in (True, False):
                conv_rec.err(kern(x, st, b, relu), plain(x, w9, b, relu),
                             f"{label} forward relu={relu}")
            out = kern(x, st, b, True)
            mask = out if fused else None
            conv_rec.err(kern(g, stf, None, False, mask),
                         plain(g, w9f, None, False, mask),
                         f"{label} input gradient mask={fused}")
            w_oihw, wf_oihw = (
                s.reshape(3, 3, *s.shape[1:]).permute(3, 2, 0, 1)
                .contiguous() for s in (w9, w9f)
            )
            g_lib = g if mask is None else torch.where(mask > 0, g, 0.0)
            fwd = tuple(map(_few_ms, (
                partial(kern, x, st, b, True),
                partial(plain, x, w9, b, True),
                _library(mode, partial(
                    F.conv2d, x.permute(0, 3, 1, 2), w_oihw, b, padding=1,
                )),
            )))
            bwd = tuple(map(_few_ms, (
                partial(kern, g, stf, None, False, mask),
                partial(plain, g, w9f, None, False, mask),
                _library(mode, partial(
                    F.conv2d, g_lib.permute(0, 3, 1, 2), wf_oihw, None,
                    padding=1,
                )),
            )))
            pix = rows * width
            flops = 2.0 * 9 * pix * ci * co
            nbytes = 4.0 * (pix * (ci + co) + 9 * ci * co)
            conv_rec.add(2, *fwd, flops, nbytes + 4.0 * co)
            conv_rec.add(1, *bwd, flops,
                         nbytes + (4.0 * pix * co if fused else 0.0))
            print(
                f"conv {label}: fwd kernel_ms {fwd[0]:.4f} plain_ms "
                f"{fwd[1]:.4f} library_ms {fwd[2]:.4f} | bwd kernel_ms "
                f"{bwd[0]:.4f} plain_ms {bwd[1]:.4f} library_ms "
                f"{bwd[2]:.4f}",
            )
            del x, g, out, mask, g_lib
        p, c = BAND_ROWS * width, 64
        f = torch.randn((1, BAND_ROWS, width, c), generator=gen,
                        device="cuda")
        flat = f.view(p, c)
        raw_k, g_k = gram.gram_kernel(flat, math.inf, 1.0, mode)
        raw_p, _ = gram.gram_plain(flat, math.inf, 1.0, mode)
        gram_rec.err(raw_k, raw_p, f"band raw gram ({p},{c}) {mode}")
        if not (torch.equal(g_k, raw_k) and torch.equal(raw_k, raw_k.T)):
            msg = f"band raw gram {mode}: G is not raw, or not symmetric"
            raise AssertionError(msg)
        dg = torch.randn((c, c), generator=gen, device="cuda")
        fk = f.clone().requires_grad_(True)
        level = {"ieee": "highest", "tf32x3": "high", "tf32": "default"}
        gram.gram_raw(fk, resolve_precision(level[mode])).backward(dg)
        ref = flat @ (dg + dg.T) if mode != "tf32" else (
            round_tf32(flat) @ round_tf32(dg + dg.T)
        )
        gram_rec.err(fk.grad.view(p, c), ref,
                     f"band raw gram ({p},{c}) {mode} backward")
        times = tuple(map(_few_ms, (
            partial(gram.gram_kernel, flat, math.inf, 1.0, mode),
            partial(gram.gram_plain, flat, math.inf, 1.0, mode),
            _library(mode, partial(torch.mm, flat.T, flat)),
        )))
        gram_rec.add(2, *times, float(p * c * (c + 1)),
                     4.0 * (p * c + 2 * c * c))
        print(
            f"gram band raw ({p},{c}) {mode}: kernel_ms {times[0]:.4f} "
            f"plain_ms {times[1]:.4f} library_ms {times[2]:.4f}; G "
            f"bit-equal to raw",
        )
        del f, flat, fk, raw_k, raw_p, g_k
        gc.collect()
        torch.cuda.empty_cache()


def _band_config(steps: int, tile_rows: int, **opt):
    """Shipped defaults, no warm start, a CSV row (and so a dispatch)
    every step, ``tile_rows`` forced."""
    config = _config(steps, "cuda", coarse_steps=0, tile_rows=tile_rows,
                     **opt)
    config.output.log_every = 1
    return config


def _curve_err(a, b) -> float:
    """Largest relative difference of curve ``a`` from curve ``b``."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


def _banded_step0(params, content, style) -> str:
    """Step 0's loss and gradient, whole against banded, each from its
    own targets (the banded run bands the content targets too)."""
    precision = resolve_precision("mixed")
    opt = _config(1, "cuda").optimization
    sl, cl = tuple(opt.style_layers), tuple(opt.content_layers)
    content_img = image_io.host_array_to_device(content, "cuda",
                                                normalize=True)
    style_img = image_io.host_array_to_device(style, "cuda", normalize=True)
    gen = torch.Generator(device="cuda").manual_seed(5)
    start = content_img + 0.1 * torch.randn(
        content_img.shape, generator=gen, device="cuda",
    )
    evals = {}
    for rows in (0, BAND_ROWS):
        targets = tiled.compute_tiled_targets(
            params, style_img, content_img, sl, cl,
            tile_rows_content=rows or None, precision=precision,
        )
        loss_fn = step.make_objective(
            style_w=opt.style_w, content_w=opt.content_w, style_layers=sl,
            content_layers=cl, precision=precision, tile_rows=rows,
        )
        x = start.clone().requires_grad_(True)
        total, _ = loss_fn(params, x, targets)
        (grad,) = torch.autograd.grad(total, x)
        evals[rows] = (float(total), grad)
        del targets, x, total
    (loss_w, grad_w), (loss_b, grad_b) = evals[0], evals[BAND_ROWS]
    loss_err = abs(loss_b - loss_w) / abs(loss_w)
    grad_err = float((grad_b - grad_w).abs().max() / grad_w.abs().max())
    if not (loss_err <= BAND_LOSS_TOL and grad_err <= BAND_GRAD_TOL):
        msg = (
            f"banded 4K step 0: loss rel err {loss_err:.3g} (bound "
            f"{BAND_LOSS_TOL}), gradient {grad_err:.3g} (bound "
            f"{BAND_GRAD_TOL})"
        )
        raise AssertionError(msg)
    return (
        f"step 0 loss whole {loss_w:.8g} banded {loss_b:.8g} rel err "
        f"{loss_err:.3g} (bound {BAND_LOSS_TOL}), gradient max err over "
        f"max {grad_err:.3g} (bound {BAND_GRAD_TOL})"
    )


def _band_run(content, style, config):
    """``run_style_transfer`` with its dispatches logged and its own
    peak: ``(image, losses, ms/step, own peak bytes)``."""
    with _dispatch_log() as log:
        (image, history), peak = _own_peak(
            lambda: run_style_transfer(content, style, config),
        )
    losses = history["total_loss"]
    return image, losses, log.ms_per_step(), peak


def _banded_4k() -> tuple[int, int]:
    """3840x2160 in 3 bands of 720 against the whole-image run.

    Shipped defaults, a 512x512 style, no warm start. Step 0's loss and
    gradient; the 3-step L-BFGS curve within ``max(control, 1e-3)``,
    the control the whole run against itself from content perturbed by
    1e-7 relative (``_nudged_control``'s); a 5-step Adam curve (lr 0.05)
    within 1e-3 a step; the banded run graphed bit-equal to the banded
    run eager, its own peak within 10% of eager's; launches on the
    device equal to those worked out (targets: the style's sweep and the
    content's, band by band; a step: per band the forward, the
    checkpoint's recompute and the input gradient of every conv, and
    two Grams a style tap); each run's own peak and ms/step.
    """
    h, w = BAND_HW
    rng = np.random.default_rng(13)
    content = rng.uniform(size=(1, h, w, 3)).astype(np.float32)
    style = _images(SIZE, 14)[0]
    params = load_pretrained_params(
        torch.device("cuda"), allow_random=True, seed=0,
    )
    step0 = _banded_step0(params, content, style)
    del params
    runs = {}
    for name, rows, image in (
        ("whole", 0, content),
        ("banded", BAND_ROWS, content),
        ("nudged", 0, (content * (1 + 1e-7 * np.random.default_rng(9)
                                  .standard_normal(content.shape)))
         .astype(np.float32)),
    ):
        runs[name] = _band_run(image, style, _band_config(BAND_STEPS, rows))
    control = _curve_err(runs["nudged"][1], runs["whole"][1])
    err = _curve_err(runs["banded"][1], runs["whole"][1])
    bound = max(control, GATE_TOL)
    if not err <= bound:
        msg = (
            f"banded 4K L-BFGS curve: rel err {err:.3g} > max(control "
            f"{control:.3g}, {GATE_TOL})"
        )
        raise AssertionError(msg)
    adam = {
        rows: _band_run(content, style, _band_config(
            BAND_ADAM_STEPS, rows, optimizer="adam", lr=GATE_LR,
        ))[1]
        for rows in (0, BAND_ROWS)
    }
    adam_err = _curve_err(adam[BAND_ROWS], adam[0])
    if not adam_err <= GATE_TOL:
        msg = f"banded 4K Adam curve: rel err {adam_err:.3g} > {GATE_TOL}"
        raise AssertionError(msg)
    with _eager_dispatch():
        eager = _band_run(content, style, _band_config(BAND_STEPS, BAND_ROWS))
    _same_tensor("banded 4K", runs["banded"][0], eager[0])
    if runs["banded"][1] != eager[1]:
        msg = f"banded 4K: losses graphed {runs['banded'][1]} eager {eager[1]}"
        raise AssertionError(msg)
    if not runs["banded"][3] <= PEAK_RATIO * eager[3]:
        msg = (
            f"banded 4K: graphed own peak {runs['banded'][3]} over "
            f"{PEAK_RATIO} x eager's {eager[3]}"
        )
        raise AssertionError(msg)
    _fresh_peak()
    _, _, launches = _counted_run(lambda: run_style_transfer(
        content, style, _band_config(BAND_STEPS, BAND_ROWS),
    ))
    bands = h // BAND_ROWS
    n_style = len(SHIPPED_TAPS) - 1
    convs = _convs_through(VGG19, max(SHIPPED_TAPS))
    want = (
        convs + bands * _convs_through(VGG19, 21)
        + BAND_STEPS * bands * 3 * convs,
        n_style + BAND_STEPS * bands * 2 * n_style,
    )
    if launches != want:
        msg = f"banded 4K: launches {launches}, expected {want}"
        raise AssertionError(msg)
    print(
        f"banded 4K {w}x{h}, {bands} bands of {BAND_ROWS} rows (windows "
        f"{_band_window()}): {step0}; L-BFGS {BAND_STEPS} steps whole "
        f"{runs['whole'][1]} banded {runs['banded'][1]}: rel err "
        f"{err:.3g} (control {control:.3g}, bound {bound:.3g}); Adam "
        f"lr {GATE_LR} {BAND_ADAM_STEPS} steps rel err {adam_err:.3g} "
        f"(bound {GATE_TOL}); graphed bit-equal to eager, own peak "
        f"graphed {runs['banded'][3]} eager {eager[3]}; ms/step whole "
        f"{runs['whole'][2]:.3f} banded {runs['banded'][2]:.3f} "
        f"(x{runs['banded'][2] / runs['whole'][2]:.3f}); own peak whole "
        f"{runs['whole'][3]} banded {runs['banded'][3]}; launches conv "
        f"{launches[0]} gram {launches[1]} (expected {want})",
    )
    return launches


def _banded_8k() -> tuple[int, int]:
    """7680x4320 content through ``run_style_transfer`` at the shipped
    defaults (``tile_rows`` auto, the auto warm start): it resolves to
    bands at the H100 thresholds (the log line and its band height),
    and 3 L-BFGS steps give finite, decreasing losses. The run's peak,
    ms/step and band count."""
    h, w = BAND_8K_HW
    rng = np.random.default_rng(15)
    content = rng.uniform(size=(1, h, w, 3)).astype(np.float32)
    style = _images(SIZE, 16)[0]
    config = _config(BAND_STEPS, "cuda")
    config.output.log_every = 1
    rows = tiled.auto_tile_rows(
        h, w, SHIPPED_TAPS, max_band_pixels=MAX_BAND_PIXELS,
    )
    if h * w < AUTO_TILE_PIXEL_THRESHOLD or not rows:
        msg = f"banded 8K: {w}x{h} does not resolve to bands ({rows})"
        raise AssertionError(msg)
    want_line = (
        f"Auto-enabling banded loss evaluation (tile_rows={rows}) for "
        f"{w}x{h} input."
    )
    logs = _LogLines()
    logger.addHandler(logs)
    before = _fresh_peak()
    try:
        with _dispatch_log() as log:
            (image, history), run_s, launches = _counted_run(
                lambda: run_style_transfer(content, style, config),
            )
    finally:
        logger.removeHandler(logs)
    peak = torch.cuda.max_memory_allocated()
    losses = history["total_loss"]
    if want_line not in logs.lines:
        msg = f"banded 8K: no {want_line!r} in {logs.lines}"
        raise AssertionError(msg)
    if len(losses) != BAND_STEPS or not all(map(_finite, losses)) or not (
        losses[-1] < losses[0]
    ):
        msg = f"banded 8K: losses {losses}"
        raise AssertionError(msg)
    if tuple(image.shape) != (1, h, w, 3) or not bool(
        torch.isfinite(image).all(),
    ):
        msg = f"banded 8K: bad image {tuple(image.shape)}"
        raise AssertionError(msg)
    warm = [line for line in logs.lines if line.startswith(("Coarse", "Auto"))]
    print(
        f"banded 8K {w}x{h} ({h * w} px) through run_style_transfer: "
        f"{h // rows} bands of {rows} rows (windows "
        f"{rows + 2 * tiled.receptive_margin(SHIPPED_TAPS)[0]} rows); "
        f"losses {losses}; ms/step {log.ms_per_step():.3f}; "
        f"max_memory_allocated {peak} (the run's own {peak - before}); "
        f"run s {run_s:.3f}; launches conv {launches[0]} gram "
        f"{launches[1]}; log {warm}",
    )
    return launches


def _remat() -> tuple[int, int]:
    """Remat against none: a 2048x2048 graphed L-BFGS run and the S = 4
    batch at 512x512, each bit-equal in image and losses (the same
    kernels recompute the same values); own peaks and ms/step."""
    if resolve_single_remat(REMAT_SIDE, REMAT_SIDE, 0, False) or (
        _auto_remat_batched(SIZE * SIZE, BATCH_STYLES)
    ):
        msg = "remat: the sizes compared turn remat on by themselves"
        raise AssertionError(msg)
    content, _ = _images(REMAT_SIDE, 17)
    style = _images(SIZE, 18)[0]
    single = {}
    for remat in (False, True):
        config = _band_config(BAND_STEPS, 0, remat=remat)
        _fresh_peak()
        single[remat] = _counted_run(
            lambda config=config: _band_run(content, style, config),
        )
    (img0, loss0, ms0, peak0), _, launches = single[False]
    (img1, loss1, ms1, peak1), _, launches1 = single[True]
    _same_tensor("remat 2048", img0, img1)
    if loss0 != loss1:
        msg = f"remat 2048: losses {loss0} vs {loss1}"
        raise AssertionError(msg)
    convs = _convs_through(VGG19, max(SHIPPED_TAPS))
    if (launches1[0] - launches[0], launches1[1] - launches[1]) != (
        BAND_STEPS * convs, 0,
    ):
        msg = f"remat 2048: launches {launches1} against {launches}"
        raise AssertionError(msg)
    b_content, _ = _images(SIZE, 19)
    styles = _style_arrays(BATCH_STYLES)
    batch = {}
    for remat in (False, True):
        config = _batch_config(BAND_STEPS, media=False, remat=remat)
        config.output.log_every = 1
        with _dispatch_log() as log:
            out, peak = _own_peak(
                lambda config=config: _batch_run(b_content, styles, config),
            )
        batch[remat] = (out[0], out[3], log.ms_per_step(), peak)
    _same_tensor("remat batch", batch[False][0], batch[True][0])
    _same_tensor("remat batch losses", batch[False][1], batch[True][1])
    print(
        f"remat: {REMAT_SIDE}x{REMAT_SIDE} L-BFGS {BAND_STEPS} steps "
        f"bit-equal with and without (launches conv {launches[0]} -> "
        f"{launches1[0]}, gram {launches[1]} -> {launches1[1]}); own peak "
        f"{peak0} -> {peak1}, ms/step {ms0:.3f} -> {ms1:.3f}; S = "
        f"{BATCH_STYLES} at {SIZE}x{SIZE} bit-equal, own peak "
        f"{batch[False][3]} -> {batch[True][3]}, ms/step "
        f"{batch[False][2]:.3f} -> {batch[True][2]:.3f}",
    )
    return launches1


# ---- row-sharded evaluation: gloo ranks sharing the one card


#: (ranks, side): 2 ranks at 2048x2048, then 4 at 1024x1024 so that
#: ranks 1 and 2 are interior (halos on both sides).
SPATIAL_RUNS = ((2, 2048), (4, 1024))
SPATIAL_KEYS = tuple(f"spatial_{r}x{side}" for r, side in SPATIAL_RUNS)
SPATIAL_STEPS = 3
SPATIAL_TIMEOUT = 600.0


def _spatial_inputs(side: int):
    """Seeded ``side`` x ``side`` content, a 512x512 style and the
    step-0 start's noise (the content plus 0.1 of it, normalized),
    made alike in the script and in every rank."""
    rng = np.random.default_rng(21)
    content = rng.uniform(size=(1, side, side, 3)).astype(np.float32)
    noise = np.random.default_rng(5).standard_normal(
        content.shape,
    ).astype(np.float32)
    return content, _images(SIZE, 22)[0], noise


def _spatial_config(shards: int):
    """Shipped defaults (``mixed``, L-BFGS, compact direction, bf16
    ring), no warm start, ``SPATIAL_STEPS`` steps."""
    config = _band_config(SPATIAL_STEPS, 0)
    config.hardware.spatial_shards = shards
    return config


def _spatial_step0(params, content, style, noise, mesh=None):
    """Step 0's loss and gradient at the content plus noise: the
    whole-image objective, or with ``mesh`` the sharded one (Grams
    whole, content targets in rows), its gradient gathered."""
    precision = resolve_precision("mixed")
    opt = _spatial_config(1).optimization
    sl, cl = tuple(opt.style_layers), tuple(opt.content_layers)
    device = params[0]["w9"].device
    content_img = image_io.host_array_to_device(content, device,
                                                normalize=True)
    style_img = image_io.host_array_to_device(style, device, normalize=True)
    start = content_img + 0.1 * torch.from_numpy(noise).to(device)
    if mesh is None:
        targets = compute_targets(
            params, style_img, content_img, sl, cl, precision,
        )
        loss_fn = step.make_objective(
            style_w=opt.style_w, content_w=opt.content_w, style_layers=sl,
            content_layers=cl, precision=precision,
        )
        x = start.requires_grad_(True)
    else:
        rows = mesh.shard(content_img)
        targets = Targets(
            style_grams=compute_targets(
                params, style_img, content_img, sl, (), precision,
            ).style_grams,
            content_feats=spatial.compute_sharded_targets(
                mesh, params, rows, rows, (), cl, precision=precision,
            ).content_feats,
        )
        loss_fn = spatial.make_spatial_loss(
            mesh, tuple(content_img.shape), style_w=opt.style_w,
            content_w=opt.content_w, style_layers=sl, content_layers=cl,
            precision=precision,
        )
        x = mesh.shard(start).requires_grad_(True)
    total, _ = loss_fn(params, x, targets)
    (grad,) = torch.autograd.grad(total, x)
    if mesh is not None:
        grad = mesh.gather(grad)
    return float(total), grad


def _spatial_rank(side: int, *, mesh) -> dict:
    """One rank of the spatial phase (spawned by ``parallel.mesh.launch``
    on ``cuda:0``): the sharded step 0, then ``run_style_transfer`` of
    ``SPATIAL_STEPS`` steps with this rank's launch counts set to 0
    just before and read just after, its dispatches logged and its own
    peak. Rank 0 returns every rank's counts, peak and ms/step."""
    content, style, noise = _spatial_inputs(side)
    params = load_pretrained_params(mesh.device, allow_random=True, seed=0)
    loss0, grad0 = _spatial_step0(params, content, style, noise, mesh)
    grad0 = grad0.cpu()
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    conv3x3.launches.reset()
    gram.launches.reset()
    torch.cuda.synchronize()
    with _dispatch_log() as log:
        image, history = run_style_transfer(
            content, style, _spatial_config(mesh.size), mesh=mesh,
        )
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    counts = [
        float(v) for counter in (conv3x3.launches, gram.launches)
        for v in counter.launched_by_mode().values()
    ]
    mine = torch.tensor(
        [[*counts, float(peak), log.ms_per_step()]], dtype=torch.float64,
        device=mesh.device,
    )
    return {
        "loss0": loss0, "grad0": grad0, "curve": history["total_loss"],
        "finite": bool(torch.isfinite(image).all()),
        "shape": tuple(image.shape),
        "per_rank": mesh.gather(mine, dim=0).cpu().numpy(),
    }


def _spatial(share_card: bool = True) -> tuple[int, int]:
    """Row-sharded evaluation through ``parallel/spatial.py``.

    For 2 ranks at 2048x2048 and 4 ranks at 1024x1024, every rank on
    this one card with gloo between them (``launch(share_card=True)``),
    or with ``share_card=False`` NCCL ranks, rank r on ``cuda:r``:
    step 0's loss and gradient against the whole image's (1e-5, 1e-4 of
    its largest magnitude); 3 L-BFGS steps through ``run_style_transfer``
    against the whole run within ``max(control, 1e-3)``, the control
    the whole run from content perturbed by 1e-7 relative; each rank's
    launches by kernel and mode equal to the policy's count of a
    single run (``_policy_launches``: the style Grams whole, the
    content targets and every step in rows); each rank's own peak and
    ms/step. Returns rank 0's conv and Gram launches at 2 ranks.
    """
    lines = []
    launches = None
    for ranks, side in SPATIAL_RUNS:
        content, style, noise = _spatial_inputs(side)
        params = load_pretrained_params(
            torch.device("cuda"), allow_random=True, seed=0,
        )
        loss_w, grad_w = _spatial_step0(params, content, style, noise)
        grad_w = grad_w.cpu()
        del params
        curves = {}
        for name, image in (
            ("whole", content),
            ("nudged", (content * (1 + 1e-7 * np.random.default_rng(9)
                                   .standard_normal(content.shape)))
             .astype(np.float32)),
        ):
            before = _fresh_peak()
            with _dispatch_log() as log:
                curves[name] = run_style_transfer(
                    image, style, _spatial_config(1),
                )[1]["total_loss"]
            if name == "whole":
                whole_ms = log.ms_per_step()
                whole_peak = torch.cuda.max_memory_allocated() - before
        _fresh_peak()
        out = launch(
            _spatial_rank, (side,), ranks, "cuda", share_card=share_card,
            timeout=SPATIAL_TIMEOUT,
        )
        label = f"spatial {ranks} ranks {side}x{side}"
        loss_err = abs(out["loss0"] - loss_w) / abs(loss_w)
        grad_err = float(
            (out["grad0"] - grad_w).abs().max() / grad_w.abs().max(),
        )
        if not (loss_err <= BAND_LOSS_TOL and grad_err <= BAND_GRAD_TOL):
            msg = (
                f"{label} step 0: loss rel err {loss_err:.3g} (bound "
                f"{BAND_LOSS_TOL}), gradient {grad_err:.3g} (bound "
                f"{BAND_GRAD_TOL})"
            )
            raise AssertionError(msg)
        control = _curve_err(curves["nudged"], curves["whole"])
        err = _curve_err(out["curve"], curves["whole"])
        bound = max(control, GATE_TOL)
        if not (err <= bound and out["finite"]
                and out["shape"] == (1, side, side, 3)):
            msg = (
                f"{label} L-BFGS: curve {out['curve']} against "
                f"{curves['whole']}: rel err {err:.3g} > {bound:.3g}, or "
                f"output {out['shape']} finite {out['finite']}"
            )
            raise AssertionError(msg)
        want = _policy_launches(VGG19, _spatial_config(ranks).optimization,
                                "mixed")
        want_row = [
            want[name][mode] for name in ("conv3x3", "gram") for mode in MODES
        ]
        per_rank = out["per_rank"]
        for r, row in enumerate(per_rank):
            if [int(v) for v in row[:6]] != want_row:
                msg = (
                    f"{label}: rank {r} launches by kernel and mode "
                    f"{[int(v) for v in row[:6]]}, expected {want_row} "
                    f"({MODES} for conv3x3, then gram)"
                )
                raise AssertionError(msg)
        if launches is None:
            row = per_rank[0]
            launches = (int(sum(row[:3])), int(sum(row[3:6])))
        where = (
            "gloo through the host, every rank on this card" if share_card
            else "NCCL, one card a rank"
        )
        lines.append(
            f"{label} ({where}): "
            f"step 0 loss whole {loss_w:.8g} sharded {out['loss0']:.8g} "
            f"rel err {loss_err:.3g}, gradient {grad_err:.3g}; L-BFGS "
            f"{SPATIAL_STEPS} steps whole {curves['whole']} sharded "
            f"{out['curve']}: rel err {err:.3g} (control {control:.3g}, "
            f"bound {bound:.3g}); per rank launches {want_row} (conv "
            f"then gram, {MODES}) as worked out; own peak "
            f"{[int(v) for v in per_rank[:, 6]]} (the whole run's own "
            f"{whole_peak}); ms/step "
            f"{[round(float(v), 3) for v in per_rank[:, 7]]} ("
            + (
                f"{ranks} ranks on one card, gloo through the host: a "
                "correctness run, not a rate" if share_card
                else f"{ranks} cards, eager steps"
            )
            + f"; the whole run graphed {whole_ms:.3f})",
        )
    for line in lines:
        print(line)
    return launches


def _spatial_conv_shapes(ranks: int, side: int):
    """``(halo'd rows, width, C_in, C_out, convs of the shape a step)``
    of a rank's convs at ``ranks`` x ``side``: its rows plus one halo
    row on each side, at each stage of the stack."""
    out = []
    for hw, ci, co, n, _ in CONV_SHAPES:
        scale = SIZE // hw
        out.append((side // ranks // scale + 2, side // scale, ci, co, n))
    return out


def _check_halo_convs(
    conv_rec: Record, mode: str, n: int, ranks: int, side: int,
    gen: torch.Generator, what: str,
) -> None:
    """The conv in ``mode`` at each halo'd shard shape of ``ranks`` x
    ``side`` (``_spatial_conv_shapes``) at a batch of ``n``: forward
    (conv + bias, no ReLU: the sharded path applies it after the crop)
    and input gradient (no mask), each within 1e-4 of the plain
    version, timed beside it and cuDNN, and summed over a rank's step
    (each conv forward and backward) into ``conv_rec``."""
    kern = partial(conv3x3.conv3x3_kernel, mode=mode)
    plain = partial(conv3x3.conv3x3_plain, mode=mode)
    for rows, width, ci, co, count in _spatial_conv_shapes(ranks, side):
        x = torch.randn((n, rows, width, ci), generator=gen, device="cuda")
        w9 = torch.randn((9, ci, co), generator=gen,
                         device="cuda") * ((2.0 / (9 * ci)) ** 0.5)
        b = 0.1 * torch.randn((co,), generator=gen, device="cuda")
        g = torch.randn((n, rows, width, co), generator=gen, device="cuda")
        w9f = flip_stencil(w9)
        st = conv3x3.mode_stencil(mode, w9, pack_stencil(w9))
        stf = conv3x3.mode_stencil(mode, w9f, pack_stencil(w9f))
        label = f"{what} {n}x{rows}x{width} {ci}->{co} {mode}"
        conv_rec.err(kern(x, st, b, False), plain(x, w9, b, False),
                     f"{label} forward")
        conv_rec.err(kern(g, stf, None, False), plain(g, w9f, None, False),
                     f"{label} input gradient")
        w_oihw, wf_oihw = (
            s.reshape(3, 3, *s.shape[1:]).permute(3, 2, 0, 1).contiguous()
            for s in (w9, w9f)
        )
        fwd = tuple(map(_few_ms, (
            partial(kern, x, st, b, False),
            partial(plain, x, w9, b, False),
            _library(mode, partial(
                F.conv2d, x.permute(0, 3, 1, 2), w_oihw, b, padding=1,
            )),
        )))
        bwd = tuple(map(_few_ms, (
            partial(kern, g, stf, None, False),
            partial(plain, g, w9f, None, False),
            _library(mode, partial(
                F.conv2d, g.permute(0, 3, 1, 2), wf_oihw, None, padding=1,
            )),
        )))
        pix = n * rows * width
        flops = 2.0 * 9 * pix * ci * co
        nbytes = 4.0 * (pix * (ci + co) + 9 * ci * co)
        conv_rec.add(count, *fwd, flops, nbytes + 4.0 * co)
        conv_rec.add(count, *bwd, flops, nbytes)
        del x, g


def _check_spatial_kernels(recs: dict[str, dict[str, Record]]) -> None:
    """Both kernels at a rank's shapes of ``SPATIAL_RUNS``, every mode.

    The conv at each halo'd shard shape, forward (conv + bias, no
    ReLU: the sharded path applies it after the crop) and input
    gradient (no mask), and the raw Gram of each style tap's shard
    rows as ``ops.gram.gram_raw`` launches it (clamp ``inf``, norm 1)
    with its gradient: each within 1e-4 of the mode's plain version,
    timed beside it and cuDNN / ``torch.mm``, and summed over a
    rank's step (each conv forward and backward, one Gram a tap) into
    ``recs[mode]["conv3x3" or "gram"]`` of the run's shape set.
    """
    gen = torch.Generator(device="cuda").manual_seed(29)
    level = {"ieee": "highest", "tf32x3": "high", "tf32": "default"}
    for ranks, side in SPATIAL_RUNS:
        key = f"{ranks}x{side}"
        for mode in MODES:
            conv_rec, gram_rec = recs[mode][key]
            _check_halo_convs(
                conv_rec, mode, 1, ranks, side, gen, f"spatial {key}",
            )
            for p512, c in GRAM_SHAPES:
                p = p512 * (side // SIZE) ** 2 // ranks
                f = torch.randn((1, p, 1, c), generator=gen, device="cuda")
                flat = f.view(p, c)
                raw_k, g_k = gram.gram_kernel(flat, math.inf, 1.0, mode)
                raw_p, _ = gram.gram_plain(flat, math.inf, 1.0, mode)
                gram_rec.err(raw_k, raw_p, f"spatial {key} raw gram "
                             f"({p},{c}) {mode}")
                if not torch.equal(g_k, raw_k):
                    msg = f"spatial raw gram {mode}: G is not raw"
                    raise AssertionError(msg)
                dg = torch.randn((c, c), generator=gen, device="cuda")
                fk = f.clone().requires_grad_(True)
                gram.gram_raw(fk, resolve_precision(level[mode])).backward(dg)
                ref = flat @ (dg + dg.T) if mode != "tf32" else (
                    round_tf32(flat) @ round_tf32(dg + dg.T)
                )
                gram_rec.err(fk.grad.view(p, c), ref,
                             f"spatial {key} raw gram ({p},{c}) {mode} "
                             "backward")
                times = tuple(map(_few_ms, (
                    partial(gram.gram_kernel, flat, math.inf, 1.0, mode),
                    partial(gram.gram_plain, flat, math.inf, 1.0, mode),
                    _library(mode, partial(torch.mm, flat.T, flat)),
                )))
                gram_rec.add(1, *times, float(p * c * (c + 1)),
                             4.0 * (p * c + 2 * c * c))
                del f, flat, fk
            gc.collect()
            torch.cuda.empty_cache()
        print(
            f"spatial kernels {key}: each rank's halo'd conv shapes "
            f"{[s[:4] for s in _spatial_conv_shapes(ranks, side)]} and "
            f"shard Gram taps, forward and backward, in {MODES}, within "
            f"{TOL} of their plain versions",
        )


#: The batch over cards: (style rows, space ranks, side), S = 4 each.
BATCH_CARD_RUNS = ((2, 2, 1024), (4, 1, 512))
#: The kernel shapes of one rank of the 2 x 2 mesh at 1024x1024.
BATCH_CARD_KEY = "batch_2x2_1024"
BATCH_CARD_STYLES = 4
BATCH_CARD_STEPS = 3
BATCH_CARD_ADAM_STEPS = 5
#: The perturbed-content runs whose largest curve error is the control:
#: at S = 4 on noise styles the shipped L-BFGS's third step reads a
#: curvature pair from two nearly equal gradients, so one perturbation
#: samples its spread too thinly.
BATCH_CARD_CONTROL_SEEDS = (9, 10, 11, 12)
#: Steps of the timed runs of ``--batch-cards`` (NCCL, one card a rank).
BATCH_CARD_TIMED_STEPS = 10


def _batch_card_inputs(side: int):
    """Seeded ``side`` x ``side`` content, the batch phase's 4 styles
    (one 384x640) and step 0's noise, made alike in the script and in
    every rank."""
    content = np.random.default_rng(21).uniform(
        size=(1, side, side, 3),
    ).astype(np.float32)
    noise = np.random.default_rng(6).standard_normal(
        (BATCH_CARD_STYLES, 1, side, side, 3),
    ).astype(np.float32)
    return content, _style_arrays(BATCH_CARD_STYLES), noise


def _batch_card_config(steps: int, shards: int, device: str = "cuda",
                       **opt):
    """Shipped defaults (``mixed``, L-BFGS, compact, bf16 ring), no
    warm start, no media; ``device`` ``cuda:0`` keeps a batch on the
    first card whatever the machine holds."""
    config = _band_config(steps, 0, **opt)
    config.hardware.device = device
    config.hardware.spatial_shards = shards
    config.output.plot_losses = False
    config.video.create_gif = config.video.create_video = False
    return config


def _batch_step0(params, content, styles, noise, mesh=None):
    """Each style's step-0 loss and whole gradient at the content plus
    0.1 of its own noise (normalized): the single-card batch's
    objective, or a rank's: a style axis alone runs the batch's
    objective on its styles; a style row of several ranks the dp x sp
    one (Grams whole, content targets in rows). Gathered whole."""
    precision = resolve_precision("mixed")
    opt = _batch_card_config(1, 1).optimization
    sl, cl = tuple(opt.style_layers), tuple(opt.content_layers)
    device = params[0]["w9"].device
    content_img = image_io.host_array_to_device(content, device,
                                                normalize=True)
    start = content_img[None] + 0.1 * torch.from_numpy(noise).to(device)
    lo, hi = (0, len(styles)) if mesh is None else mesh.styles(len(styles))
    style_imgs = [
        image_io.host_array_to_device(s, device, normalize=True)
        for s in styles[lo:hi]
    ]
    if mesh is None or mesh.size == 1:
        targets = multi_style_targets(
            params, content_img, style_imgs, sl, cl, precision,
        )
        x = start[lo:hi].contiguous().requires_grad_(True)
        total, _ = batched_total_loss(
            params, x.flatten(0, 1), targets, opt.style_w, opt.content_w,
            sl, cl, None, precision,
        )
    else:
        rows = mesh.shard(content_img)
        feats = spatial.compute_sharded_targets(
            mesh, params, rows, rows, (), cl, precision=precision,
        ).content_feats
        targets = Targets(
            style_grams=multi_style_targets(
                params, content_img, style_imgs, sl, (), precision,
            ).style_grams,
            content_feats={
                k: f.expand(hi - lo, *f.shape) for k, f in feats.items()
            },
        )
        loss_fn = spatial.make_spatial_loss(
            mesh, tuple(content_img.shape), style_w=opt.style_w,
            content_w=opt.content_w, style_layers=sl, content_layers=cl,
            precision=precision, per_image=True,
        )
        x = mesh.shard(start[lo:hi], 2).requires_grad_(True)
        total, _ = loss_fn(params, x.flatten(0, 1), targets)
    (grad,) = torch.autograd.grad(total.sum(), x)
    total = total.detach()
    if mesh is not None:
        grad = mesh.gather_styles(mesh.gather(grad.contiguous(), 2))
        total = mesh.gather_styles(total)
    return total.cpu(), grad.cpu()


def _batch_card_run(content, styles, config, mesh=None):
    """``prepare_multi_style`` and ``run_multi_style_loop`` (with
    ``mesh``: this rank's part): the ``(steps, S)`` losses and the
    whole final images."""
    bundle, images = prepare_multi_style(content, styles, config, mesh=mesh)
    losses: list[torch.Tensor] = []
    images, _, errors = run_multi_style_loop(
        bundle, images, config,
        Path(__file__).resolve().parent / PACKAGE / "build" / "batch_cards",
        [f"s{i}" for i in range(len(styles))],
        progress_bar=_Progress(),
        on_step_end=lambda _s, _i, aux: losses.append(aux.loss),
        mesh=mesh,
    )
    if errors:
        raise errors[0]
    curve = torch.stack(losses)
    if mesh is not None:
        curve = mesh.gather_styles(curve, dim=1)
    return curve.cpu().numpy(), images


def _batch_card_rank(side: int, timed: bool, *, mesh) -> dict:
    """One rank of the batch-over-cards phase (spawned by
    ``parallel.mesh.launch``): step 0, then ``BATCH_CARD_STEPS``
    L-BFGS steps with this rank's launch counts set to 0 just before
    and read just after, its own peak and ms/step; on a style axis
    alone also ``BATCH_CARD_ADAM_STEPS`` Adam steps; with ``timed`` a
    ``BATCH_CARD_TIMED_STEPS`` run for the rate. World rank 0 returns
    every rank's counts, peak and ms/step."""
    content, styles, noise = _batch_card_inputs(side)
    params = load_pretrained_params(mesh.device, allow_random=True, seed=0)
    loss0, grad0 = _batch_step0(params, content, styles, noise, mesh)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    conv3x3.launches.reset()
    gram.launches.reset()
    torch.cuda.synchronize()
    with _dispatch_log() as log:
        curve, images = _batch_card_run(
            content, styles, _batch_card_config(BATCH_CARD_STEPS, mesh.size),
            mesh,
        )
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    counts = [
        float(v) for counter in (conv3x3.launches, gram.launches)
        for v in counter.launched_by_mode().values()
    ]
    ms = log.ms_per_step()
    if timed:
        with _dispatch_log() as log:
            _batch_card_run(content, styles, _batch_card_config(
                BATCH_CARD_TIMED_STEPS, mesh.size,
            ), mesh)
        ms = log.ms_per_step()
    mine = torch.tensor(
        [[[*counts, float(peak), ms]]], dtype=torch.float64,
        device=mesh.device,
    )
    out = {
        "loss0": loss0, "grad0": grad0, "curve": curve,
        "finite": bool(torch.isfinite(images).all()),
        "shape": tuple(images.shape),
        "per_rank": mesh.gather_styles(mesh.gather(mine, 1))
        .reshape(-1, mine.shape[-1]).cpu().numpy(),
    }
    if mesh.size == 1:
        _, adam = _batch_card_run(content, styles, _batch_card_config(
            BATCH_CARD_ADAM_STEPS, 1, optimizer="adam", lr=GATE_LR,
        ), mesh)
        out["adam"] = adam.cpu()
    return out


def _batch_policy_launches(opt, tier: str, n_styles: int):
    """``_policy_launches`` of a batch of ``n_styles`` on one rank: a
    style sweep per style (one Gram a style tap each), the content sweep
    once, and each step's convs and Grams once for the whole batch."""
    want = _policy_launches(VGG19, opt, tier)
    prec = resolve_precision(tier)
    last_style = max(opt.style_layers)
    for idx in VGG19.conv_indices:
        if idx <= last_style:
            mode = kernel_mode(conv_precision(prec, idx))
            want["conv3x3"][mode] += n_styles - 1
    want["gram"][kernel_mode(gram_precision(prec))] += (
        len(opt.style_layers) * (n_styles - 1)
    )
    return want


def _batch_cards(share_card: bool = True) -> tuple[int, int]:
    """The multi-style batch over a style x space mesh.

    S = 4 styles, shipped defaults: at 1024x1024 on a 2 (style) x 2
    (space) mesh and at 512x512 on a 4 x 1 mesh, every rank on this one
    card with gloo between them (``launch(share_card=True)``), or with
    ``share_card=False`` NCCL ranks, one card a rank. Against the
    single-card S = 4 batch on ``cuda:0``: each style's step-0 loss
    (1e-5) and gradient (1e-4 of its largest magnitude); 3 L-BFGS steps
    per style within ``max(control, 1e-3)``, the control the largest
    error of the batch from content perturbed by 1e-7 relative
    (``BATCH_CARD_CONTROL_SEEDS``); each rank's launches by kernel
    and mode, its counts set to 0 just before its run and read just
    after, equal to the policy's for its S_local
    (``_batch_policy_launches``; at 2 x 2 the halo'd shapes); at 4 x 1
    5 Adam steps (lr 0.05) each style's image bit-equal to the
    single-card batch's (the kernels are per image); each rank's own
    peak and ms/step. With NCCL, a 10-step run of each for the rate.
    Returns world rank 0's conv and Gram launches at 2 x 2.
    """
    lines = []
    failures: list[str] = []
    launches = None
    timed = not share_card
    for n_style, n_space, side in BATCH_CARD_RUNS:
        label = f"batch cards {n_style}x{n_space} {side}x{side}"
        content, styles, noise = _batch_card_inputs(side)
        params = load_pretrained_params(
            torch.device("cuda", 0), allow_random=True, seed=0,
        )
        loss_w, grad_w = _batch_step0(params, content, styles, noise)
        del params
        curves = {}
        runs = [("whole", content)] + [
            (f"nudged {seed}", (content * (
                1 + 1e-7 * np.random.default_rng(seed)
                .standard_normal(content.shape)
            )).astype(np.float32))
            for seed in BATCH_CARD_CONTROL_SEEDS
        ]
        for name, image in runs:
            before = _fresh_peak()
            with _dispatch_log() as log:
                curves[name], _ = _batch_card_run(
                    image, styles, _batch_card_config(
                        BATCH_CARD_STEPS, 1, "cuda:0",
                    ),
                )
            if name == "whole":
                whole_ms = log.ms_per_step()
                whole_peak = torch.cuda.max_memory_allocated() - before
        if timed:
            with _dispatch_log() as log:
                _batch_card_run(content, styles, _batch_card_config(
                    BATCH_CARD_TIMED_STEPS, 1, "cuda:0",
                ))
            whole_ms = log.ms_per_step()
        adam_whole = None
        if n_space == 1:
            adam_whole = _batch_card_run(content, styles, _batch_card_config(
                BATCH_CARD_ADAM_STEPS, 1, "cuda:0", optimizer="adam",
                lr=GATE_LR,
            ))[1].cpu()
        _fresh_peak()
        out = launch(
            _batch_card_rank, (side, timed), n_space, "cuda",
            n_style=n_style, share_card=share_card, timeout=SPATIAL_TIMEOUT,
        )
        loss_err = float(((out["loss0"] - loss_w).abs() / loss_w.abs()).max())
        grad_err = max(
            float((out["grad0"][s] - grad_w[s]).abs().max()
                  / grad_w[s].abs().max())
            for s in range(BATCH_CARD_STYLES)
        )
        if not (loss_err <= BAND_LOSS_TOL and grad_err <= BAND_GRAD_TOL):
            failures.append(
                f"{label} step 0: per-style loss rel err {loss_err:.3g} "
                f"(bound {BAND_LOSS_TOL}), gradient {grad_err:.3g} (bound "
                f"{BAND_GRAD_TOL})",
            )
        control = max(
            _curve_err(curves[name], curves["whole"])
            for name, _ in runs[1:]
        )
        bound = max(control, GATE_TOL)
        errs = [
            _curve_err(out["curve"][:, s], curves["whole"][:, s])
            for s in range(BATCH_CARD_STYLES)
        ]
        if not (max(errs) <= bound and out["finite"] and out["shape"] == (
            BATCH_CARD_STYLES, 1, side, side, 3,
        )):
            failures.append(
                f"{label} L-BFGS: per-style curve rel errs {errs} > "
                f"{bound:.3g}, or output {out['shape']} finite "
                f"{out['finite']}",
            )
        print(
            f"{label} curves by step (rows) and style: "
            + ", ".join(f"{k} {v.tolist()}" for k, v in curves.items())
            + f", mesh {out['curve'].tolist()}",
        )
        s_local = BATCH_CARD_STYLES // n_style
        want = _batch_policy_launches(
            _batch_card_config(BATCH_CARD_STEPS, n_space).optimization,
            "mixed", s_local,
        )
        want_row = [
            want[name][mode] for name in ("conv3x3", "gram") for mode in MODES
        ]
        per_rank = out["per_rank"]
        for r, row in enumerate(per_rank):
            if [int(v) for v in row[:6]] != want_row:
                failures.append(
                    f"{label}: rank {r} launches by kernel and mode "
                    f"{[int(v) for v in row[:6]]}, expected {want_row} "
                    f"({MODES} for conv3x3, then gram; S_local {s_local})",
                )
        adam_note = ""
        if adam_whole is not None:
            differ = [
                s for s in range(BATCH_CARD_STYLES)
                if not torch.equal(out["adam"][s], adam_whole[s])
            ]
            if differ:
                failures.append(
                    f"{label} Adam: styles {differ} not bit-equal to the "
                    "single-card batch after "
                    f"{BATCH_CARD_ADAM_STEPS} steps (largest difference "
                    f"{float((out['adam'] - adam_whole).abs().max()):.3g})",
                )
            adam_note = (
                f"; Adam {BATCH_CARD_ADAM_STEPS} steps every style "
                "bit-equal to the single-card batch"
            )
        if launches is None:
            row = per_rank[0]
            launches = (int(sum(row[:3])), int(sum(row[3:6])))
        rank_ms = [round(float(v), 3) for v in per_rank[:, 7]]
        rate = BATCH_CARD_STYLES / (max(rank_ms) / 1e3)
        where = (
            "gloo through the host, every rank on this card" if share_card
            else "NCCL, one card a rank"
        )
        lines.append(
            f"{label} ({where}): step 0 per-style loss rel err "
            f"{loss_err:.3g}, gradient {grad_err:.3g}; L-BFGS "
            f"{BATCH_CARD_STEPS} steps per-style curve rel errs "
            f"{[f'{e:.3g}' for e in errs]} (control {control:.3g}, bound "
            f"{bound:.3g}){adam_note}; per rank launches {want_row} (conv "
            f"then gram, {MODES}, S_local {s_local}) as worked out; own "
            f"peak {[int(v) for v in per_rank[:, 6]]} (the single-card "
            f"batch's own {whole_peak}); ms/step {rank_ms}, style-steps/s "
            f"{rate:.2f} ("
            + (
                f"{n_style * n_space} ranks on one card, gloo through the "
                "host: a correctness run, not a rate" if share_card
                else f"{n_style * n_space} cards, "
                f"{BATCH_CARD_TIMED_STEPS}-step runs"
            )
            + f"; the single-card S = {BATCH_CARD_STYLES} batch graphed "
            f"{whole_ms:.3f} ms/step, "
            f"{BATCH_CARD_STYLES / (whole_ms / 1e3):.2f} style-steps/s)",
        )
    for line in lines:
        print(line)
    if failures:
        raise AssertionError("; ".join(failures))
    return launches


def _check_batch_card_kernels(recs: dict[str, tuple[Record, Record]]) -> None:
    """Both kernels at a 2 x 2 rank's shapes at 1024x1024 (S_local 2),
    every mode, against their plain versions within 1e-4: the conv on
    the halo'd shard of both styles, ``(2, rows + 2, W, C)``, forward
    without ReLU and input gradient without mask; the batched raw Gram
    of each style tap's shard rows, ``(2, P_shard, C)`` in one launch
    at clamp ``inf`` and norm 1 as ``ops.gram.gram_raw_batched``
    launches it, and its gradient. Timed beside cuDNN / ``torch.bmm``
    and summed over a rank's step into ``recs[mode]``."""
    gen = torch.Generator(device="cuda").manual_seed(31)
    level = {"ieee": "highest", "tf32x3": "high", "tf32": "default"}
    n_style, n_space, side = BATCH_CARD_RUNS[0]
    s_local = BATCH_CARD_STYLES // n_style
    for mode in MODES:
        conv_rec, gram_rec = recs[mode]
        _check_halo_convs(
            conv_rec, mode, s_local, n_space, side, gen, BATCH_CARD_KEY,
        )
        for p512, c in GRAM_SHAPES:
            p = p512 * (side // SIZE) ** 2 // n_space
            f = torch.randn((s_local, p, 1, c), generator=gen, device="cuda")
            flat = f.view(s_local, p, c)
            raw_k, g_k = gram.gram_kernel_batched(flat, math.inf, 1.0, mode)
            raw_p, _ = gram.gram_plain_batched(flat, math.inf, 1.0, mode)
            gram_rec.err(raw_k, raw_p, f"{BATCH_CARD_KEY} raw gram "
                         f"({s_local},{p},{c}) {mode}")
            if not torch.equal(g_k, raw_k):
                msg = f"{BATCH_CARD_KEY} raw gram {mode}: G is not raw"
                raise AssertionError(msg)
            dg = torch.randn((s_local, c, c), generator=gen, device="cuda")
            fk = f.clone().requires_grad_(True)
            gram.gram_raw_batched(
                fk, resolve_precision(level[mode]),
            ).backward(dg)
            sym = dg + dg.mT
            ref = flat @ sym if mode != "tf32" else (
                round_tf32(flat) @ round_tf32(sym)
            )
            gram_rec.err(fk.grad.view(s_local, p, c), ref,
                         f"{BATCH_CARD_KEY} raw gram ({s_local},{p},{c}) "
                         f"{mode} backward")
            times = tuple(map(_few_ms, (
                partial(gram.gram_kernel_batched, flat, math.inf, 1.0, mode),
                partial(gram.gram_plain_batched, flat, math.inf, 1.0, mode),
                _library(mode, partial(torch.bmm, flat.mT, flat)),
            )))
            gram_rec.add(1, *times, float(s_local * p * c * (c + 1)),
                         4.0 * (s_local * p * c + 2 * s_local * c * c))
            del f, flat, fk
        gc.collect()
        torch.cuda.empty_cache()
    print(
        f"batch cards kernels {BATCH_CARD_KEY}: each 2 x 2 rank's halo'd "
        f"conv shapes at N = {s_local} "
        f"{[s[:4] for s in _spatial_conv_shapes(n_space, side)]} and "
        f"batched raw Gram taps ({s_local}, P_shard, C), forward and "
        f"backward, in {MODES}, within {TOL} of their plain versions",
    )


# ---- the targets-as-argument pipelines: sweep, regional, sequence


def _save_png(path: Path, arr: np.ndarray) -> Path:
    """Save a (1, H, W, 3) [0, 1] array or an (H, W[, 3]) uint8 one."""
    from PIL import Image  # noqa: PLC0415 - file I/O only

    if arr.dtype != np.uint8:
        arr = np.round(arr[0] * 255).astype(np.uint8)
    Image.fromarray(arr).save(path)
    return path


def _load_png(path: Path) -> np.ndarray:
    from PIL import Image  # noqa: PLC0415 - file I/O only

    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def _gif_in_memory(_path: Path, _fps: float) -> _FrameSink:
    """Stands in for the GIF encoder where imageio is absent: keeps the
    frames, writes nothing."""
    return _FrameSink()


def _gif_encoder_note() -> str | None:
    """None where the GIF encoder imports, else which import is missing."""
    if importlib.util.find_spec("imageio") is None:
        return "imageio not importable"
    return None


def _same_as_single(
    label: str, png_path: Path, loss: float, content, style, steps: int,
) -> None:
    """A pipeline's first frame is ``run_style_transfer``'s, bit for bit.

    The same inputs (read back from the same PNGs), the shipped
    defaults, the same seed: the PNG's pixels equal the single run's
    packed image and the frame's final loss equals the single run's.
    """
    image, history = run_style_transfer(
        content, style, _config(steps, "cuda"),
    )
    single = image_io.pack_uint8_frame(image).cpu().numpy()
    ours = _load_png(png_path)
    last = history["total_loss"][-1]
    if not np.array_equal(ours, single) or loss != last:
        diff = int(np.abs(ours.astype(np.int16) - single).max())
        msg = (
            f"{label}: frame 0 differs from the single run (pixels up to "
            f"{diff}, loss {loss!r} vs {last!r})"
        )
        raise AssertionError(msg)


def _sweep() -> tuple[int, int]:
    """``stylize_blend_sweep`` at 512x512: 3 styles, 5 frames, 60 steps.

    The shipped L-BFGS, 20 steps for frame 0 and 10 for each later
    frame. Gates: the launches worked out from the code, finite frame
    losses, frame 0 bit-equal to ``run_style_transfer`` of style 0
    alone, frame 2's blended targets bit-equal to style 1's.
    """
    root = _work_dir("sweep")
    content_path = _save_png(root / "content.png", _images(SIZE, 20)[0])
    style_paths = [
        _save_png(root / f"s{i}.png", _images(SIZE, 21 + i)[0])
        for i in range(SWEEP_STYLES)
    ]
    config = _config(STEPS, "cuda")
    config.output.output = str(root / "out")
    note = _gif_encoder_note()
    real_gif = encode.GifFrameCollector
    if note is not None:
        encode.GifFrameCollector = _gif_in_memory
    try:
        result, run_s, launches = _counted_run(
            lambda: blend_sweep.stylize_blend_sweep(
                content_path, style_paths, config,
                n_frames=SWEEP_FRAMES, sweep_steps=SWEEP_STEPS,
            ),
        )
    finally:
        encode.GifFrameCollector = real_gif
    total = STEPS + (SWEEP_FRAMES - 1) * SWEEP_STEPS
    want = _launches_wanted(
        VGG19, config.optimization, SIZE, SWEEP_STYLES, steps=total,
    )
    losses = list(result.frame_losses)
    if launches != want or result.total_steps != total:
        msg = f"sweep: launches {launches}, expected {want}"
        raise AssertionError(msg)
    if len(losses) != SWEEP_FRAMES or not all(map(_finite, losses)):
        msg = f"sweep: frame losses {losses}"
        raise AssertionError(msg)
    content = image_io.load_image_to_host_array(content_path)
    styles = [image_io.load_image_to_host_array(p) for p in style_paths]
    _same_as_single(
        "sweep", result.frame_paths[0], losses[0], content, styles[0], STEPS,
    )
    params = load_pretrained_params(
        torch.device("cuda"), allow_random=True, seed=0,
    )

    def dev(host):
        return image_io.host_array_to_device(host, "cuda", normalize=True)

    opt = config.optimization
    per_style = [
        compute_targets(
            params, dev(s), dev(content), tuple(opt.style_layers),
            tuple(opt.content_layers) if i == 0 else (),
        )
        for i, s in enumerate(styles)
    ]
    row = blend_sweep.sweep_weights(SWEEP_STYLES, SWEEP_FRAMES)[2]
    mixed = blend_targets(per_style, row)
    if row != [0.0, 1.0, 0.0] or not all(
        torch.equal(mixed.style_grams[i], g)
        for i, g in per_style[1].style_grams.items()
    ):
        msg = f"sweep: frame 2's targets ({row}) are not style 1's"
        raise AssertionError(msg)
    later_ms = statistics.mean(result.frame_seconds[1:]) / SWEEP_STEPS * 1e3
    gif = (
        result.video_path.name if note is None
        else f"in-memory GIF stand-in ({note})"
    )
    print(
        f"sweep {SIZE}x{SIZE} vgg19 L-BFGS: {SWEEP_STYLES} styles, "
        f"{SWEEP_FRAMES} frames, {STEPS} + {SWEEP_FRAMES - 1} x "
        f"{SWEEP_STEPS} = {total} steps; launches conv {launches[0]} gram "
        f"{launches[1]} (expected {want}); frame losses {losses}; frame 0 "
        f"bit-equal to run_style_transfer of style 0; frame 2's targets "
        f"bit-equal to style 1's; frame seconds "
        f"{[round(t, 4) for t in result.frame_seconds]}; ms per sweep step "
        f"(frames 1-{SWEEP_FRAMES - 1}, PNG save included) {later_ms:.3f} "
        f"beside the main path's {MAIN_MS_STEP[0]:.3f}; run s {run_s:.3f}; "
        f"{gif}",
    )
    return launches


def _seam_masks(side: int) -> tuple[np.ndarray, np.ndarray]:
    """Left/right uint8 masks with a ``SEAM``-pixel linear seam."""
    cols = np.arange(side, dtype=np.float64)[None, :].repeat(side, axis=0)
    left = np.clip((side / 2 + SEAM / 2 - cols) / SEAM, 0.0, 1.0)
    left = np.round(left * 255).astype(np.uint8)
    return left, 255 - left


def _masked_gram_plain(features: torch.Tensor, mask: torch.Tensor):
    """``regional.masked_gram`` with the plain Gram (``F.T @ F``)."""
    b, h, w, c = features.shape
    mask_l = resize_image(mask[None, :, :, None], h, w)[0, :, :, 0]
    mask_l = torch.clamp(mask_l, min=0.0)
    mass = torch.clamp(torch.sum(mask_l), min=1e-6)
    flat = (features * torch.sqrt(mask_l * (b * h * w / mass))[
        None, :, :, None
    ]).reshape(b * h * w, c)
    return torch.clamp(flat.T @ flat, max=CLAMP) / (b * h * w * c)


def _check_masked_gram(rec: Record, mask: torch.Tensor) -> None:
    """``masked_gram`` at the 5 tap shapes of 512x512 against its plain
    version (forward and the features' gradient), and an all-ones mask
    against the stock Gram kernel, bit for bit."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    ones = torch.ones_like(mask)
    for p, c in GRAM_SHAPES:
        side = int(p ** 0.5)
        f = torch.randn((1, side, side, c), generator=gen, device="cuda")
        dg = torch.randn((c, c), generator=gen, device="cuda")
        fk = f.clone().requires_grad_(True)
        g_k = regional.masked_gram(fk, mask)
        g_k.backward(dg)
        fr = f.clone().requires_grad_(True)
        g_r = _masked_gram_plain(fr, mask)
        g_r.backward(dg)
        label = f"masked ({p},{c})"
        rec.err(g_k.detach(), g_r.detach(), f"{label} forward")
        rec.err(fk.grad, fr.grad, f"{label} backward")
        if not torch.equal(regional.masked_gram(f, ones), gram.gram_matrix(f)):
            msg = f"gram {label}: an all-ones mask is not the stock Gram"
            raise AssertionError(msg)
    print(
        "gram masked_gram at the 5 taps of 512x512, feathered mask: forward "
        "and backward within 1e-4 of the plain version; all-ones mask "
        "bit-equal to the stock Gram kernel",
    )


def _regional(gram_rec: Record) -> tuple[int, int]:
    """``stylize_regional`` at 512x512: 2 styles, feathered masks.

    The shipped L-BFGS, 20 steps, frames off, a CSV row a step. Gates:
    launches (a masked Gram per style and tap), a finite, decreasing
    loss, the file name; then ``masked_gram`` at the taps.
    """
    root = _work_dir("regional")
    content_path = _save_png(root / "content.png", _images(SIZE, 30)[0])
    style_paths = [
        _save_png(root / f"s{i}.png", _images(SIZE, 31 + i)[0])
        for i in range(2)
    ]
    mask_paths = [
        _save_png(root / f"m{i}.png", m)
        for i, m in enumerate(_seam_masks(SIZE))
    ]

    counted = _config(STEPS, "cuda")
    counted.video.final_only = True
    counted.output.plot_losses = False
    counted.output.output = str(root / "out")
    counted.output.log_every = 1
    counted.output.log_loss = str(root / "out.csv")
    with _dispatch_log() as log:
        result, run_s, launches = _counted_run(
            lambda: regional.stylize_regional(
                content_path, style_paths, mask_paths, counted,
            ),
        )
    want = _launches_wanted(
        VGG19, counted.optimization, SIZE, 2, grams_per_tap=2,
    )
    losses = _curve(root / "out.csv").tolist()
    name = "regional_content_x_s0+s1.png"
    if launches != want:
        msg = f"regional: launches {launches}, expected {want}"
        raise AssertionError(msg)
    if len(losses) != STEPS or not all(map(_finite, losses)) or not (
        losses[-1] < losses[0]
    ):
        msg = f"regional: losses {losses}"
        raise AssertionError(msg)
    if result.output_path.name != name or not result.output_path.is_file():
        msg = f"regional: output {result.output_path}"
        raise AssertionError(msg)
    ms_step = log.ms_per_step()
    masks = regional.load_region_masks(mask_paths, SIZE, SIZE)
    _check_masked_gram(gram_rec, torch.as_tensor(masks[0], device="cuda"))
    print(
        f"regional {SIZE}x{SIZE} vgg19 L-BFGS {STEPS} steps, 2 styles, "
        f"{SEAM}-px feathered seam: loss {losses[0]:.6g} -> "
        f"{losses[-1]:.6g}; launches conv {launches[0]} gram {launches[1]} "
        f"(expected {want}); wrote {name}; ms/step {ms_step:.3f} (a CSV "
        f"row a step) beside the main path's {MAIN_MS_STEP[0]:.3f}; run s "
        f"{run_s:.3f}",
    )
    return launches


def _drifting_frames(root: Path) -> Path:
    """``SEQ_FRAMES`` 1280x720 PNGs: a drifting gradient plus seeded
    noise (the gradient of ``benchmarks/sequence_bench.py``)."""
    frames = root / "frames"
    frames.mkdir()
    h, w = SEQ_HW
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy, xx = yy / h, xx / w
    rng = np.random.default_rng(40)
    for i in range(SEQ_FRAMES):
        shift = i / SEQ_FRAMES
        img = np.stack(
            [(xx + shift) % 1.0, (yy + 0.5 * shift) % 1.0,
             0.5 * np.ones_like(xx)],
            axis=-1,
        )
        img = np.clip(img + rng.normal(0.0, 0.05, img.shape), 0.0, 1.0)
        _save_png(frames / f"frame_{i:04d}.png", (img * 255).astype(np.uint8))
    return frames


def _sequence() -> tuple[int, int]:
    """``style-sequence-torch`` on 4 frames of 1280x720, 10 steps each.

    Through ``sequence_cli.main`` with the shipped L-BFGS, one 512x512
    style and ``--output-video`` GIF where the encoder imports. Gates: 4
    PNGs at 1280x720, launches, no warm start (921,600 px is under the
    auto threshold), frame 0 bit-equal to ``run_style_transfer`` on
    frame 0.
    """
    root = _work_dir("sequence")
    frames = _drifting_frames(root)
    style_path = _save_png(root / "style.png", _images(SIZE, 41)[0])
    out = root / "out"
    note = _gif_encoder_note()
    argv = [
        "--frames", str(frames), "--style", str(style_path),
        "--steps", str(SEQ_STEPS), "--output", str(out),
        "--allow-random-weights",
    ]
    if note is None:
        argv += ["--output-video", "sequence.gif"]
    results = []
    original = sequence_cli.stylize_sequence

    def recorded(*args, **kwargs):
        results.append(original(*args, **kwargs))
        return results[-1]

    before = _fresh_peak()
    logs = _LogLines()
    logger.addHandler(logs)
    sequence_cli.stylize_sequence = recorded
    try:
        rc, run_s, launches = _counted_run(lambda: sequence_cli.main(argv))
    finally:
        sequence_cli.stylize_sequence = original
        logger.removeHandler(logs)
    peak = torch.cuda.max_memory_allocated()
    (result,) = results
    h, w = SEQ_HW
    opt = _config(SEQ_STEPS, "cuda").optimization
    want = _launches_wanted(
        VGG19, opt, h, 1, steps=SEQ_FRAMES * SEQ_STEPS,
        content_sweeps=SEQ_FRAMES,
    )
    pngs = sorted(p.name for p in out.glob("stylized_*.png"))
    shapes = {_load_png(out / n).shape for n in pngs}
    if rc != 0 or len(pngs) != SEQ_FRAMES or shapes != {(h, w, 3)}:
        msg = f"sequence: rc {rc}, wrote {pngs} of shapes {shapes}"
        raise AssertionError(msg)
    if launches != want:
        msg = f"sequence: launches {launches}, expected {want}"
        raise AssertionError(msg)
    if any("Coarse" in line for line in logs.lines):
        msg = "sequence: a warm start ran at 921,600 px"
        raise AssertionError(msg)
    losses = list(result.frame_losses)
    if not all(map(_finite, losses)):
        msg = f"sequence: frame losses {losses}"
        raise AssertionError(msg)
    if note is None and not (out / "sequence.gif").is_file():
        msg = "sequence: no sequence.gif"
        raise AssertionError(msg)
    first = sorted(frames.iterdir())[0]
    _same_as_single(
        "sequence", result.frame_paths[0], losses[0],
        image_io.load_image_to_host_array(first),
        image_io.load_image_to_host_array(style_path), SEQ_STEPS,
    )
    steady = result.frame_seconds[1:]
    frames_min = 60.0 / statistics.mean(steady)
    steps_s = SEQ_STEPS / statistics.mean(steady)
    video = "sequence.gif" if note is None else f"no GIF ({note})"
    print(
        f"sequence {w}x{h} vgg19 L-BFGS, {SEQ_FRAMES} frames x "
        f"{SEQ_STEPS} steps through sequence_cli.main: wrote {pngs} and "
        f"{video}; launches conv {launches[0]} gram {launches[1]} "
        f"(expected {want}); no warm start; frame 0 bit-equal to "
        f"run_style_transfer on frame 0; frame seconds "
        f"{[round(t, 4) for t in result.frame_seconds]}; frames 1-3: "
        f"{frames_min:.2f} frames/min, {steps_s:.2f} steps/s; final loss "
        f"frame 0 {losses[0]:.6g}, frames 1-3 "
        f"{[float(f'{v:.6g}') for v in losses[1:]]}; max_memory_allocated "
        f"{peak}, of which allocated before {before} (the run's own "
        f"{peak - before}); run s {run_s:.3f}",
    )
    return launches


def _check_720p_kernels(conv_rec, conv_720, gram_rec, gram_720) -> None:
    """Both kernels at the sequence's 1280x720 shapes (``at_720p``).

    The conv at VGG19's five stage shapes through layer 28 (720x1280 to
    45x80, the odd 45-row level included), each as often per step as at
    512x512, and the Gram at the five style taps (P = 921,600 down to
    3,600): within 1e-4 of the plain versions, timed.
    """
    h, w = SEQ_HW
    _check_conv(conv_rec, [
        (1, h * hw // SIZE, w * hw // SIZE, ci, co, n, f, conv_720)
        for hw, ci, co, n, f in CONV_SHAPES
    ])
    _check_gram_cases(
        gram_rec,
        [
            ((h >> k) * (w >> k), c, gram_720)
            for k, (_, c) in enumerate(GRAM_SHAPES)
        ],
        torch.Generator(device="cuda").manual_seed(5),
    )
    gc.collect()
    torch.cuda.empty_cache()


# The L-BFGS ring's kernels (17b): (key, n, styles a step), m = 100.
RING_M = 100
RING_CASES = (
    ("at_512", 3 * SIZE * SIZE, 1),
    ("s4_512_per_style", 3 * SIZE * SIZE, BATCH_STYLES),
    (BATCH_CARD_KEY + "_rank", 3 * OBJECTIVE_SIZE * OBJECTIVE_SIZE // 2, 2),
)
RING_SOURCE = f"{PACKAGE}/csrc/lbfgs_ring.cu"
RING_REPLACES = (
    "none: XLA's dot_general of the bf16 ring, "
    "style_transfer_visualizer_tpu/engine/optimizers.py _compact_direction"
)


def _ring_batch(n: int, styles: int, gen: torch.Generator):
    """A batched L-BFGS state of ``styles`` full bf16 rings of m = 100
    wrapped past ``hist_pos`` (``y = s + 0.1 noise``) and their
    gradients, on the card."""
    state = optimizers.lbfgs_init_batched(
        styles, n, RING_M, "cuda", torch.bfloat16,
    )
    for ring, extra in ((state.s_hist, None), (state.y_hist, state.s_hist)):
        for i in range(styles):
            noise = torch.randn(
                (RING_M, n), generator=gen, device="cuda",
            )
            ring[i].copy_(noise if extra is None else extra[i] + 0.1 * noise)
    state.hist_len.fill_(RING_M)
    state.hist_pos.fill_(37)
    state.h_diag.fill_(0.5)
    grad = torch.randn((styles, n), generator=gen, device="cuda")
    return state, grad


def _check_lbfgs_ring() -> list[dict]:
    """17b: both ring kernels against their plain versions at the
    ``RING_CASES``, timed; returns their two JSON entries (``at_512``
    the main record, the others under their keys)."""
    gen = torch.Generator(device="cuda").manual_seed(19)
    recs = {
        name: {
            key: Record(name, RING_SOURCE, RING_REPLACES, "bf16")
            for key, _, _ in RING_CASES
        }
        for name in ("lbfgs_ring_products", "lbfgs_ring_combine")
    }
    m = RING_M
    # The main path's runs of each kernel a step, counted in the graphed
    # 512 step; the other cases' counts follow from their shapes.
    main_key = RING_CASES[0][0]
    main_runs = _ring_in_the_step()
    for key, n, styles in RING_CASES:
        state, grads = _ring_batch(n, styles, gen)
        prod_rec = recs["lbfgs_ring_products"][key]
        comb_rec = recs["lbfgs_ring_combine"][key]
        for i in range(styles):
            st = optimizers._style(state, i)  # noqa: SLF001
            ring = (st.s_hist, st.y_hist, grads[i])
            sums = lbfgs_ring.products_kernel(*ring)
            for name, ours, ref in zip(
                ("sy", "yy", "p", "q"), sums,
                lbfgs_ring.products_plain(*ring), strict=True,
            ):
                prod_rec.err(ours, ref, f"{key} style {i} {name}")
            coeff = optimizers._compact_coefficients(  # noqa: SLF001
                sums, st,
            )
            comb_rec.err(
                lbfgs_ring.combine_kernel(*ring, *coeff, st.h_diag),
                lbfgs_ring.combine_plain(*ring, *coeff, st.h_diag),
                f"{key} style {i} combination",
            )
        st = optimizers._style(state, 0)  # noqa: SLF001
        ring = (st.s_hist, st.y_hist, grads[0])
        coeff = optimizers._compact_coefficients(  # noqa: SLF001
            lbfgs_ring.products_kernel(*ring), st,
        )
        # One cuBLAS bf16 call on the same operands, bf16 out.
        a16 = torch.cat([st.s_hist, st.y_hist])
        b16 = torch.cat([st.y_hist, grads[0].to(torch.bfloat16)[None]])
        c16 = torch.cat([coeff[0], -0.5 * coeff[1]]).to(torch.bfloat16)
        per_style = (
            main_runs if key == main_key
            else 1 if key == "s4_512_per_style" else styles
        )
        prod = _times(
            partial(lbfgs_ring.products_kernel, *ring),
            partial(lbfgs_ring.products_plain, *ring),
            partial(torch.mm, a16, b16.T),
        )
        prod_flops = 2.0 * 2 * m * (m + 1) * n
        prod_bytes = 2.0 * 2 * m * n + 4.0 * n + 4.0 * (2 * m * m + 2 * m)
        prod_rec.add(per_style, *prod, prod_flops, prod_bytes)
        comb = _times(
            partial(lbfgs_ring.combine_kernel, *ring, *coeff, st.h_diag),
            partial(lbfgs_ring.combine_plain, *ring, *coeff, st.h_diag),
            partial(torch.mv, a16.T, c16),
        )
        comb_flops = 2.0 * 2 * m * n
        comb_bytes = 2.0 * 2 * m * n + 8.0 * n + 8.0 * m
        comb_rec.add(per_style, *comb, comb_flops, comb_bytes)
        print(
            f"lbfgs ring {key} (n {n}, m {m}, {styles} styles, x"
            f"{per_style} a step): products kernel_ms {prod[0]:.4f} "
            f"plain_ms {prod[1]:.4f} library_ms {prod[2]:.4f} bound_ms "
            f"{_bound_ms(prod_flops, prod_bytes, BF16_FLOPS):.4f} | "
            f"combine kernel_ms {comb[0]:.4f} plain_ms {comb[1]:.4f} "
            f"library_ms {comb[2]:.4f} bound_ms "
            f"{_bound_ms(comb_flops, comb_bytes, BF16_FLOPS):.4f}",
        )
        del state, grads, a16, b16
        torch.cuda.empty_cache()
    return [
        by_key[main_key].finish(
            {"main path": main_runs},
            {k: r for k, r in by_key.items() if k != main_key},
        )
        for by_key in recs.values()
    ]


def _ring_device_ops(run) -> dict[str, int]:
    """The device kernels of ``run()`` under ``torch.profiler``: runs by
    name."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA],
    ) as prof:
        run()
        torch.cuda.synchronize()
    return {
        e.key: e.count for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    }


def _ring_in_the_step(steps: int = 5) -> int:
    """The ring kernels in the 512x512 graphed L-BFGS step, under the
    profiler: one run of each a step (the profiler's count and the
    kernels' own), and in one direction alone no cuBLAS sgemm, no gemv
    of the ring and no copy of it. Returns each kernel's runs a step,
    as the profiler counted them."""
    content, style = _images(SIZE, 0)
    bundle, image = prepare_model_and_input(
        content, style, _config(steps, "cuda"),
    )
    state = bundle.opt_state
    # The eager warm-up step and the capture, then replays only.
    image, state, _ = bundle.chunked_update_fn(image, state, 2)
    lbfgs_ring.launches.reset()
    holder = {}

    def replays():
        holder["out"] = bundle.chunked_update_fn(image, state, steps)

    ops = _ring_device_ops(replays)

    def runs(part: str) -> int:
        return sum(c for name, c in ops.items() if part in name)

    seen = (runs("lbfgs_ring_products_kernel"),
            runs("lbfgs_ring_combine_kernel"))
    own = lbfgs_ring.launches.launched()
    per_step = seen[0] // steps
    if (seen != (per_step * steps,) * 2 or own != 2 * seen[0]
            or per_step != 1):
        msg = (
            f"lbfgs ring in the step: profiler {seen}, kernels' own {own} "
            f"over {steps} replayed steps"
        )
        raise AssertionError(msg)
    state = holder["out"][1]
    grad = state.prev_grad.detach().clone()
    direction = _ring_device_ops(
        lambda: optimizers._compact_direction(grad, state),  # noqa: SLF001
    )
    ring_ops = {
        name: c for name, c in direction.items()
        if re.search(r"sgemm|gemm|direct_copy|gemv", name)
    }
    big = [name for name in ring_ops if "sgemm" in name]
    if big:
        msg = f"lbfgs ring: a cuBLAS sgemm in the direction: {big}"
        raise AssertionError(msg)
    print(
        f"lbfgs ring in the 512 graphed step: {seen[0]} products and "
        f"{seen[1]} combine runs in {steps} replayed steps (profiler), "
        f"{own} counted by the kernels; one direction's device ops "
        f"{sum(direction.values())}, of which cuBLAS and copies "
        f"{ring_ops} (the m x m stage's)",
    )
    return per_step


def _lbfgs_ring_only(card: str) -> int:
    """``--lbfgs-ring``: build, and 17b alone, with its JSON entries."""
    print(f"card: {card}")
    _build_phase()
    t0 = time.perf_counter()
    entries = _check_lbfgs_ring()
    print(f"phase seconds: lbfgs ring kernels {time.perf_counter() - t0:.1f}")
    print(json.dumps({"kernels": entries}))
    print(f"card: {card}")
    return 0


def _small_pipeline_reference() -> None:
    """The three pipelines at 64x64 on the card against the CPU.

    Adam from the content: a 2-frame sweep of 2 styles, a regional run
    of 2 styles (halves), a 2-frame sequence; each per-step loss curve
    within 1e-3 relative of the CPU's.
    """
    root = _work_dir("small_pipelines")
    content = _save_png(root / "content.png", _images(64, 50)[0])
    styles = [
        _save_png(root / f"s{i}.png", _images(64, 51 + i)[0])
        for i in range(2)
    ]
    masks = [
        _save_png(root / f"m{i}.png", m) for i, m in enumerate(_seam_masks(64))
    ]
    frames = root / "frames"
    frames.mkdir()
    for i in range(2):
        _save_png(frames / f"f{i}.png", _images(64, 53 + i)[0])

    def config(device: str, name: str):
        cfg = _config(
            3, device, init_method="content", optimizer="adam", lr=0.1,
        )
        cfg.video.final_only = True
        cfg.output.plot_losses = False
        cfg.output.output = str(root / name)
        return cfg

    def traced(module, run):
        curves = []
        original = module.drive_chunked

        def drive(*args):
            image, state, auxes = original(*args)
            curves.append(auxes.loss.cpu().numpy())
            return image, state, auxes

        module.drive_chunked = drive
        try:
            run()
        finally:
            module.drive_chunked = original
        return np.concatenate(curves)

    real_gif = encode.GifFrameCollector
    encode.GifFrameCollector = _gif_in_memory
    try:
        for label, module, run in (
            ("sweep", blend_sweep, lambda d: blend_sweep.stylize_blend_sweep(
                content, styles, config(d, f"sw_{d}"), n_frames=2,
                sweep_steps=2,
            )),
            ("sequence", sequence, lambda d: sequence.stylize_sequence(
                frames, styles[0], config(d, f"sq_{d}"), root / f"sq_{d}",
            )),
        ):
            curves = {d: traced(module, partial(run, d)) for d in ("cuda",
                                                                   "cpu")}
            np.testing.assert_allclose(
                curves["cuda"], curves["cpu"], rtol=1e-3,
            )
            print(
                f"small reference 64x64 {label}, Adam, 2 frames: cuda "
                f"{curves['cuda'].tolist()} cpu {curves['cpu'].tolist()}",
            )
    finally:
        encode.GifFrameCollector = real_gif
    curves = {}
    for device in ("cuda", "cpu"):
        cfg = config(device, f"rg_{device}")
        cfg.output.log_every = 1
        cfg.output.log_loss = str(root / f"rg_{device}.csv")
        regional.stylize_regional(content, styles, masks, cfg)
        curves[device] = _curve(root / f"rg_{device}.csv")
    np.testing.assert_allclose(curves["cuda"], curves["cpu"], rtol=1e-3)
    print(
        f"small reference 64x64 regional, Adam, 2 styles, 3 steps: cuda "
        f"{curves['cuda'].tolist()} cpu {curves['cpu'].tolist()}",
    )


# --- the dispatch phase: every step a CUDA-graph replay -----------------


@contextlib.contextmanager
def _eager_dispatch():
    """Every ``GraphedChunk`` dispatch as ``update_fn`` in a Python loop
    (``GraphedChunk.loop``): the eager run a graphed run is held to.
    Each dispatch is noted as a graphed one is (``GraphedChunk.note``),
    so both modes' step times come from the same events."""
    graphed = step.GraphedChunk.__call__

    def eager(self, image, state, *rest):
        out = self.loop(image, state, *rest)
        self.note(rest[-1])
        return out

    step.GraphedChunk.__call__ = eager
    try:
        yield
    finally:
        step.GraphedChunk.__call__ = graphed


def _mode(mode: str):
    """``_eager_dispatch()`` for ``"eager"``; nothing for any other."""
    return _eager_dispatch() if mode == "eager" else contextlib.nullcontext()


class _DispatchLog:
    """The dispatches ``engine.step.recording`` kept in a block: each
    one's chunk, ``k``, the event after its last step and the seconds
    of the capture it made."""

    def __init__(self, records: list[step.Dispatch]) -> None:
        """Read ``records`` (filled while the block runs)."""
        self.records = records

    @property
    def ks(self) -> list[int]:
        """``k`` of every dispatch, in order."""
        return [d.k for d in self.records]

    @property
    def captures(self) -> list[float]:
        """The seconds of every capture, in order."""
        return [
            d.capture_seconds for d in self.records
            if d.capture_seconds is not None
        ]

    def ms_per_step(self) -> float:
        """ms/step of the last chunk's steps after its first dispatch.

        Device time from the end of that dispatch (a warm-up step and
        the capture, or an eager step) to the end of the chunk's last
        dispatch, over the steps dispatched in between: set-up,
        targets, a warm start's levels, the capture and all the run
        does after its last step (the PNG, the summary) are left out;
        host work between two dispatches (a CSV row, a checkpoint)
        stays in.
        """
        last = self.records[-1].chunk
        mine = [d for d in self.records if d.chunk == last]
        steps = sum(d.k for d in mine[1:])
        torch.cuda.synchronize()
        return mine[0].done.elapsed_time(mine[-1].done) / steps


@contextlib.contextmanager
def _dispatch_log():
    """A ``_DispatchLog`` of the dispatches made in the block."""
    with step.recording() as records:
        yield _DispatchLog(records)


def _own_peak(run):
    """``run()``'s result and its own peak device bytes."""
    before = _fresh_peak()
    out = run()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - before


def _same_history(label: str, a: dict, b: dict) -> None:
    for key in ("style_loss", "content_loss", "total_loss"):
        if a[key] != b[key]:
            msg = f"{label}: {key} differs: {a[key]} vs {b[key]}"
            raise AssertionError(msg)


def _same_tensor(label: str, a: torch.Tensor, b: torch.Tensor) -> None:
    if not torch.equal(a, b):
        diff = float((a.double() - b.double()).abs().max())
        msg = f"{label}: graphed and eager differ by up to {diff:.3g}"
        raise AssertionError(msg)


def _dispatch_main_path() -> tuple[tuple[int, int], dict]:
    """The 512 main path graphed at steps_per_dispatch 0, 1 and 5 against
    the eager loop: images, every step's losses, launches, own peaks."""
    content, style = _images(SIZE, 0)
    want = _launches_wanted(
        VGG19, _config(STEPS, "cuda").optimization, SIZE, 1,
    )
    with _eager_dispatch():
        ((image, history), peak), _, launches = _counted_run(
            lambda: _own_peak(
                lambda: run_style_transfer(
                    content, style, _config(STEPS, "cuda"),
                ),
            ),
        )
    # With no graph, the kernels' own counts and the wrappers' agree.
    if launches != want or _wrapper_calls() != launches:
        msg = (
            f"dispatch eager: launches {launches} on the device, "
            f"{_wrapper_calls()} by the wrappers, expected {want}"
        )
        raise AssertionError(msg)
    peaks = {"eager": peak}
    counted = {}
    calls = {}
    chunks = {0: [1] * STEPS, 1: [1] * STEPS, 5: [5] * (STEPS // 5)}
    captures = []
    for per_dispatch, want_ks in chunks.items():
        config = _config(STEPS, "cuda")
        config.hardware.steps_per_dispatch = per_dispatch
        with _dispatch_log() as log:
            ((g_image, g_history), peak), _, g_launches = _counted_run(
                lambda config=config: _own_peak(
                    lambda: run_style_transfer(content, style, config),
                ),
            )
        ks = log.ks
        label = f"dispatch 512 steps_per_dispatch={per_dispatch}"
        _same_tensor(label, g_image, image)
        _same_history(label, g_history, history)
        if g_launches != want or ks != want_ks:
            msg = (
                f"{label}: launches {g_launches} (expected {want}), "
                f"dispatches {ks} (expected {want_ks})"
            )
            raise AssertionError(msg)
        captures += log.captures
        peaks[f"graphed {per_dispatch}"] = peak
        counted[per_dispatch] = g_launches
        calls[per_dispatch] = _wrapper_calls()
    print(
        f"dispatch: {SIZE}x{SIZE} main path, shipped L-BFGS, {STEPS} steps at "
        f"steps_per_dispatch 0, 1, 5 (dispatches of 1, 1, 5 steps): final "
        f"image and every step's style, content and total loss bit-equal "
        f"to the eager loop; launches conv/gram counted by the kernels on "
        f"the device, replays included, {counted} (eager {launches}, as "
        f"worked out {want}); the wrappers' host calls (the warm-up step "
        f"and the capture's recording) {calls}; captures s "
        f"{[round(s, 4) for s in captures]}; the run's own peak bytes "
        + ", ".join(f"{k} {v}" for k, v in peaks.items()),
    )
    return counted[5], peaks


def _dispatch_batch() -> dict:
    """S = 4 with a GIF and an MP4 every 10 steps (chunks of 10), the
    CSV rows read off the chunks' interiors, graphed against eager."""
    content = _images(SIZE, 1)[0]
    styles = _style_arrays(BATCH_STYLES)
    params = load_pretrained_params(
        torch.device("cuda"), allow_random=True, seed=0,
    )
    out = {}
    for mode in ("eager", "graphed"):
        root = _work_dir(f"dispatch_batch_{mode}")
        config = _batch_config(STEPS, media=True)
        config.video.save_every = 2 * BATCH_SAVE_EVERY
        config.output.log_every = 1
        config.output.log_loss = str(root / "l.csv")
        sinks: dict[str, _FrameSink] = {}

        def make_sink(kind, name, sinks=sinks):
            del kind
            sinks[name] = _FrameSink()
            return sinks[name]

        def run(config=config, root=root, make_sink=make_sink):
            bundle, images = prepare_multi_style(
                content, styles, config, params=params,
            )
            images, _, errors = run_multi_style_loop(
                bundle, images, config, root, [f"s{i}" for i in range(4)],
                progress_bar=_Progress(), make_sink=make_sink,
            )
            if errors:
                raise errors[0]
            return images

        with _mode(mode), _dispatch_log() as log:
            images, peak = _own_peak(run)
        out[mode] = (
            images, {n: _csv_rows(root / f"l_s{i}.csv")
                     for i, n in enumerate("abcd")},
            {k: v.frames for k, v in sinks.items()}, peak, log.ks,
        )
    (e_img, e_rows, e_frames, e_peak, _), (g_img, g_rows, g_frames,
                                           g_peak, g_ks) = (
        out["eager"], out["graphed"],
    )
    _same_tensor("dispatch batch", g_img, e_img)
    if g_rows != e_rows or any(len(r) != STEPS + 1 for r in g_rows.values()):
        msg = "dispatch batch: CSV rows differ from the eager run's"
        raise AssertionError(msg)
    if sorted(g_frames) != sorted(e_frames) or not all(
        len(g_frames[k]) == STEPS // 10 and all(
            np.array_equal(a, b)
            for a, b in zip(g_frames[k], e_frames[k], strict=True)
        )
        for k in g_frames
    ):
        msg = "dispatch batch: frames differ from the eager run's"
        raise AssertionError(msg)
    if g_ks != [10] * (STEPS // 10):
        msg = f"dispatch batch: dispatches {g_ks}, expected chunks of 10"
        raise AssertionError(msg)
    print(
        f"dispatch: batch S={BATCH_STYLES} {SIZE}x{SIZE} {STEPS} steps, GIF "
        f"and MP4 every 10 steps (dispatches {g_ks}), a CSV row a step: "
        f"final images, {len(g_frames)} sinks' frames and every CSV row "
        f"bit-equal to the eager loop; the run's own peak bytes eager "
        f"{e_peak}, graphed {g_peak}",
    )
    return {"eager": e_peak, "graphed": g_peak}


def _dispatch_pipelines() -> None:
    """Sweep frames 0-1 and sequence frames 0-1 at 64x64, graphed
    against eager: PNG pixels and frame losses bit-equal."""
    root = _work_dir("dispatch_pipelines")
    content = _save_png(root / "content.png", _images(64, 60)[0])
    styles = [
        _save_png(root / f"s{i}.png", _images(64, 61 + i)[0])
        for i in range(2)
    ]
    frames = root / "frames"
    frames.mkdir()
    for i in range(2):
        _save_png(frames / f"f{i}.png", _images(64, 63 + i)[0])

    def config(name: str):
        cfg = _config(SEQ_STEPS, "cuda")
        cfg.video.final_only = True
        cfg.output.output = str(root / name)
        return cfg

    results = {}
    real_gif = encode.GifFrameCollector
    encode.GifFrameCollector = _gif_in_memory
    try:
        for mode in ("eager", "graphed"):
            with _mode(mode), _dispatch_log() as log:
                sweep = blend_sweep.stylize_blend_sweep(
                    content, styles, config(f"sw_{mode}"), n_frames=2,
                    sweep_steps=SEQ_STEPS // 2,
                )
                seq = sequence.stylize_sequence(
                    frames, styles[0], config(f"sq_{mode}"),
                    root / f"sq_{mode}",
                )
            results[mode] = (
                [_load_png(p) for p in sweep.frame_paths], sweep.frame_losses,
                [_load_png(p) for p in seq.frame_paths], seq.frame_losses,
                log.ks, log.captures,
            )
    finally:
        encode.GifFrameCollector = real_gif
    eager, graphed = results["eager"], results["graphed"]
    for i, what in enumerate(("sweep frames", "sweep losses",
                              "sequence frames", "sequence losses")):
        same = all(
            np.array_equal(a, b)
            for a, b in zip(eager[i], graphed[i], strict=True)
        ) if "frames" in what else eager[i] == graphed[i]
        if not same:
            msg = f"dispatch 64x64 {what}: graphed differs from eager"
            raise AssertionError(msg)
    want_ks = [SEQ_STEPS, SEQ_STEPS // 2, SEQ_STEPS, SEQ_STEPS]
    if graphed[4] != want_ks or len(graphed[5]) != 2:
        msg = (
            f"dispatch 64x64: dispatches {graphed[4]} (expected {want_ks}),"
            f" captures {graphed[5]} (one per pipeline)"
        )
        raise AssertionError(msg)
    print(
        f"dispatch: 64x64 sweep frames 0-1 and sequence frames 0-1, "
        f"shipped L-BFGS, {SEQ_STEPS} steps a frame ({SEQ_STEPS // 2} for "
        f"sweep frame 1): dispatches {graphed[4]}, one capture per "
        f"pipeline (the second frame's targets and state copied into the "
        f"captured ones); PNG pixels and frame losses bit-equal to the "
        f"eager loop (sweep {list(graphed[1])}, sequence "
        f"{list(graphed[3])})",
    )


def _dispatch_resume() -> None:
    """A chunk-5 run resumed at step 7 (off the grid) against the whole
    eager run: steps 8-10 single, then chunks of 5; bit-equal."""
    root = _work_dir("dispatch_resume")
    content, style = _images(SIZE, 0)

    def config(steps: int, name: str, **out):
        cfg = _config(steps, "cuda")
        cfg.hardware.steps_per_dispatch = 5
        cfg.output.output = str(root / name)
        for key, value in out.items():
            setattr(cfg.output, key, value)
        return cfg

    with _eager_dispatch():
        whole_image, whole = run_style_transfer(
            content, style, config(STEPS, "whole"),
        )
    run_style_transfer(content, style, config(7, "part", checkpoint_every=7))
    with _dispatch_log() as log:
        image, resumed = run_style_transfer(
            content, style, config(
                STEPS, "part",
                resume_from=str(root / "part" / "checkpoint.npz"),
            ),
        )
    ks = log.ks
    _same_tensor("dispatch resume", image, whole_image)
    _same_history(
        "dispatch resume", resumed,
        {k: v[7:] for k, v in whole.items()},
    )
    # Steps 8-10 alone, back on the grid at 10, then chunks of 5.
    want_ks = [1, 1, 1] + [5] * ((STEPS - 10) // 5)
    if ks != want_ks:
        msg = f"dispatch resume: dispatches {ks}, expected {want_ks}"
        raise AssertionError(msg)
    print(
        f"dispatch: {SIZE}x{SIZE} steps_per_dispatch 5 resumed at step 7 (off "
        f"the chunk grid): dispatches {ks}; final image and the losses of "
        f"steps 8-{STEPS} bit-equal to the whole eager run",
    )


def _dispatch_counters() -> None:
    """100 replays in one dispatch; the arrival counters read all 0."""
    content, style = _images(SIZE, 0)
    bundle, image = prepare_model_and_input(
        content, style, _config(STEPS, "cuda"),
    )
    _, _, aux = bundle.chunked_update_fn(image, bundle.opt_state, 101)
    torch.cuda.synchronize()
    counters = build.counter_buffer(torch.device("cuda"))
    nonzero = int(counters.count_nonzero())
    if nonzero or not bool(torch.isfinite(aux.loss).all()):
        msg = f"dispatch: {nonzero} arrival counters not 0 after replays"
        raise AssertionError(msg)
    print(
        f"dispatch: 101 steps at {SIZE}x{SIZE} in one dispatch (a warm-up, a "
        f"capture, 100 replays): all {counters.numel()} arrival counters "
        f"0; losses finite",
    )
    bundle.chunked_update_fn.release()


def _interleaved(
    label: str, timed, rounds: int = DISPATCH_ROUNDS,
    modes: tuple[str, str] = ("eager", "graphed"),
):
    """``timed(mode)`` for both modes, ``rounds`` times, order swapped
    each round (``"eager"`` under ``_eager_dispatch``); the median and
    the rounds per mode."""
    got: dict[str, list[float]] = {m: [] for m in modes}
    for i in range(rounds):
        for mode in modes if i % 2 == 0 else modes[::-1]:
            with _mode(mode):
                got[mode].append(timed(mode))
    if not all(_finite(v) for vals in got.values() for v in vals):
        msg = f"{label}: timings {got}"
        raise AssertionError(msg)
    return {m: statistics.median(v) for m, v in got.items()}, got


def _runner_ms(bundle, holder: dict, config, steps: int) -> float:
    """ms/step of ``steps`` through the runner on a prepared bundle."""
    config.optimization.steps = steps
    runner = OptimizationRunner(
        bundle.update_fn, holder["state"], holder["image"], config,
        progress_bar=SilentProgress(),
        chunked_update_fn=bundle.chunked_update_fn,
    )
    image, _, seconds = runner.run()
    holder["image"], holder["state"] = image, runner.opt_state
    return seconds / steps * 1e3


# The conv's and the Gram's device kernels, every mode.
_PORT_KERNELS = (
    ("conv3x3_tc_kernel", "conv3x3_tf32_kernel", "conv3x3_ieee_kernel"),
    ("gram_tc_kernel", "gram_tf32_kernel", "gram_ieee_kernel"),
)


def _profiled(run, steps: int) -> tuple[float, tuple[int, int]]:
    """Device ms per step of ``run()`` (``steps`` steps) as
    ``torch.profiler`` sees it: the time of every kernel, copy and set
    on the device, the kernels inside graph replays included; and each
    port kernel's runs the profiler saw, to print beside the kernels'
    own device counts (the launch counts are set to 0 just before).

    Only the device is traced: the host's events would cost seconds to
    gather for an eager step's thousands of operators.
    """
    conv3x3.launches.reset()
    gram.launches.reset()
    torch.cuda.synchronize()
    with torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA],
    ) as prof:
        run()
        torch.cuda.synchronize()
    on_device = [
        e for e in prof.key_averages()
        if e.device_type == torch.autograd.DeviceType.CUDA
    ]
    busy_us = sum(e.self_device_time_total for e in on_device)
    if busy_us <= 0:
        msg = "profiler: no device time"
        raise AssertionError(msg)
    seen = tuple(
        sum(e.count for e in on_device if any(n in e.key for n in names))
        for names in _PORT_KERNELS
    )
    return busy_us / steps / 1e3, seen


def _profiled_steps(bundle, holder: dict, mode: str, steps: int = 5):
    """:func:`_profiled` over ``steps`` steps of a prepared bundle (one
    graphed dispatch, or the eager loop): the device ms per step, and
    the port kernels' runs the profiler saw and the ones they counted
    on the device."""
    chunk = bundle.chunked_update_fn
    dispatch = chunk if mode == "graphed" else chunk.loop

    def run():
        holder["image"], holder["state"], _ = dispatch(
            holder["image"], holder["state"], steps,
        )

    ms, seen = _profiled(run, steps)
    return ms, seen, _launched()


def _flops_line(label: str, height: int, width: int, ms: float,
                styles: int = 1) -> str:
    fields = flops.audit_fields(
        VGG19.layer_table, height, width, VGG19.default_style_layers,
        VGG19.default_content_layers, styles * 1e3 / ms,
    )
    return (
        f"{label} {fields['achieved_tflops']} TFLOP/s, mfu_pct "
        f"{fields['mfu_pct']} of 495 TF32 ({fields['flops_per_step']} "
        f"FLOPs a step{f' x {styles} styles' if styles > 1 else ''})"
    )


def _dispatch_steady() -> list[str]:
    """ms/step graphed against eager through the runner or the batch
    loop on prepared steps (rounds interleaved), the profiler's device
    ms per step in each mode, and each one's busy share."""
    lines = []
    content, style = _images(SIZE, 0)
    big = _images(OBJECTIVE_SIZE, 1)[0]
    blend = [(_images(OBJECTIVE_SIZE, s)[0], w) for s, w in ((2, 0.7),
                                                             (3, 0.3))]

    def objective(n):
        return _config(
            n, "cuda", tv_w=1e-2, lap_w=1e2,
            style_layer_weights=[1, 1, 0.5, 0.25, 0.25],
            preserve_color="luminance",
        )

    frame = np.random.default_rng(43).uniform(
        size=(1, *SEQ_HW, 3),
    ).astype(np.float32)
    single = {
        "512 main path": (
            lambda: prepare_model_and_input(
                content, style, _config(STEPS, "cuda"),
            ),
            lambda: _config(STEPS, "cuda"), (SIZE, SIZE),
        ),
        "1024 objective": (
            lambda: prepare_model_and_input(
                big, blend[0][0], objective(STEPS), style_blend=blend,
            ),
            lambda: objective(STEPS), (OBJECTIVE_SIZE, OBJECTIVE_SIZE),
        ),
        "1280x720 (a sequence frame's step)": (
            lambda: prepare_model_and_input(
                frame, style, _config(SEQ_STEPS, "cuda"),
            ),
            lambda: _config(SEQ_STEPS, "cuda"), SEQ_HW,
        ),
    }
    results = {}
    for label, (prepare, make_config, hw) in single.items():
        holders = {}
        for mode in ("eager", "graphed"):
            with _mode(mode):
                bundle, image = prepare()
            holders[mode] = (bundle, {"image": image,
                                      "state": bundle.opt_state})
        # The capture, before the timed rounds.
        g_bundle, g_holder = holders["graphed"]
        _runner_ms(g_bundle, g_holder, make_config(), 1)
        medians, rounds = _interleaved(
            label, lambda mode: _runner_ms(
                holders[mode][0], holders[mode][1], make_config(),
                DISPATCH_STEPS,
            ),
        )
        device_ms = {
            mode: _profiled_steps(*holders[mode], mode)
            for mode in ("eager", "graphed")
        }
        results[label] = (medians, rounds, device_ms, hw)
        del holders, g_bundle, g_holder
        gc.collect()
    params = load_pretrained_params(
        torch.device("cuda"), allow_random=True, seed=0,
    )
    styles = _style_arrays(BATCH_STYLES)
    holders = {}
    for mode in ("eager", "graphed"):
        config = _batch_config(STEPS, media=False)
        bundle, images = prepare_multi_style(
            content, styles, config, params=params,
        )
        holders[mode] = (bundle, {"image": images,
                                  "state": bundle.opt_state})

    def batch_ms(mode, steps=DISPATCH_STEPS):
        bundle, holder = holders[mode]
        config = _batch_config(steps, media=False)
        config.output.plot_losses = False
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # The loop starts at step 0 each time: its dispatches are the
        # run's.
        holder["image"], holder["state"], _ = run_multi_style_loop(
            dataclasses.replace(bundle, opt_state=holder["state"]),
            holder["image"], config, _work_dir("dispatch_s4"),
            [f"s{i}" for i in range(BATCH_STYLES)],
            progress_bar=_Progress(),
        )
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / steps * 1e3

    batch_ms("graphed", 1)
    medians, rounds = _interleaved("S=4", batch_ms)
    results["512 batch S=4"] = (
        medians, rounds, {
            mode: _profiled_steps(*holders[mode], mode)
            for mode in ("eager", "graphed")
        }, (SIZE, SIZE),
    )
    del holders
    gc.collect()
    for label, (medians, rounds, device_ms, hw) in results.items():
        n = BATCH_STYLES if "S=4" in label else 1
        lines.append(
            f"dispatch steady {label}: ms/step eager "
            f"{medians['eager']:.3f}, graphed {medians['graphed']:.3f} "
            f"(median of {DISPATCH_ROUNDS} rounds of {DISPATCH_STEPS} steps, "
            f"interleaved; rounds {rounds}); device ms/step (the "
            f"profiler's, over 5 steps; kernels in replays included) eager "
            f"{device_ms['eager'][0]:.3f}, graphed "
            f"{device_ms['graphed'][0]:.3f}; device busy share eager "
            f"{device_ms['eager'][0] / medians['eager']:.3f}, graphed "
            f"{device_ms['graphed'][0] / medians['graphed']:.3f}; conv/gram "
            f"runs in those 5 steps seen by the profiler eager "
            f"{device_ms['eager'][1]}, graphed {device_ms['graphed'][1]}, "
            f"counted by the kernels eager {device_ms['eager'][2]}, "
            f"graphed {device_ms['graphed'][2]}; "
            + _flops_line("graphed", *hw, medians["graphed"], n),
        )
    return lines


def _dispatch_chunking() -> str:
    """ms/step at ``steps_per_dispatch`` 1 against 0 (auto: with no
    cadence, one dispatch of 25), graphed, rounds interleaved: the 512
    main path through the runner, and the S = 4 batch with a CSV row a
    step (a host read a step at 1, one for the whole chunk at 0)."""
    steps = 25
    content, style = _images(SIZE, 0)

    def config(mode: str, *, batch: bool = False):
        cfg = (
            _batch_config(steps, media=False) if batch
            else _config(steps, "cuda")
        )
        cfg.hardware.steps_per_dispatch = int(mode)
        return cfg

    def checked(mode: str, log) -> None:
        want = [1] * steps if mode == "1" else [steps]
        if log.ks != want:
            msg = f"dispatch chunking: dispatches {log.ks}, expected {want}"
            raise AssertionError(msg)

    bundle, image = prepare_model_and_input(content, style, config("1"))
    holder = {"image": image, "state": bundle.opt_state}
    _runner_ms(bundle, holder, config("1"), 1)  # the capture

    def single_ms(mode: str) -> float:
        with _dispatch_log() as log:
            ms = _runner_ms(bundle, holder, config(mode), steps)
        checked(mode, log)
        return ms

    single, single_rounds = _interleaved(
        "chunking 512", single_ms, rounds=AB_ROUNDS, modes=("1", "0"),
    )
    del bundle, holder, image
    gc.collect()
    params = load_pretrained_params(
        torch.device("cuda"), allow_random=True, seed=0,
    )
    root = _work_dir("dispatch_chunking")
    names = [f"s{i}" for i in range(BATCH_STYLES)]
    bundle, images = prepare_multi_style(
        content, _style_arrays(BATCH_STYLES), config("1", batch=True),
        params=params,
    )
    holder = {"image": images, "state": bundle.opt_state}

    def batch_ms(mode: str) -> float:
        cfg = config(mode, batch=True)
        cfg.output.log_every = 1
        cfg.output.log_loss = str(root / f"l{mode}.csv")
        with _dispatch_log() as log:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            holder["image"], holder["state"], _ = run_multi_style_loop(
                dataclasses.replace(bundle, opt_state=holder["state"]),
                holder["image"], cfg, root, names, progress_bar=_Progress(),
            )
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) / steps * 1e3
        checked(mode, log)
        return ms

    batch_ms("1")  # the capture
    batch, batch_rounds = _interleaved(
        "chunking S=4", batch_ms, rounds=AB_ROUNDS, modes=("1", "0"),
    )
    del bundle, holder, images
    gc.collect()
    return (
        f"dispatch chunking, graphed, {steps} steps a round (median of "
        f"{AB_ROUNDS} rounds, interleaved): {SIZE}x{SIZE} main path "
        f"through the runner ms/step at steps_per_dispatch 1 ({steps} "
        f"dispatches of 1) {single['1']:.3f}, 0 (one of {steps}) "
        f"{single['0']:.3f} (rounds {single_rounds}); S={BATCH_STYLES} batch "
        f"with a CSV row a step, whole loop ms/step at 1 (a host read a "
        f"step) {batch['1']:.3f}, 0 (one read for the chunk) "
        f"{batch['0']:.3f} (rounds {batch_rounds})"
    )


def _regional_attribution() -> str:
    """The regional run's step, graphed: ms/step with a CSV row every
    step against every 20 (chunks of 20), 40 steps, rounds interleaved;
    and its device ms per step from the profiler (a 40-step run less a
    20-step run, over 20). The run is the regional phase's."""
    root = _work_dir("regional_attribution")
    content_path = _save_png(root / "content.png", _images(SIZE, 30)[0])
    style_paths = [
        _save_png(root / f"s{i}.png", _images(SIZE, 31 + i)[0])
        for i in range(2)
    ]
    mask_paths = [
        _save_png(root / f"m{i}.png", m)
        for i, m in enumerate(_seam_masks(SIZE))
    ]

    def run(steps: int, log_every: int, name: str) -> _DispatchLog:
        cfg = _config(steps, "cuda")
        cfg.video.final_only = True
        cfg.output.plot_losses = False
        cfg.output.output = str(root / name)
        cfg.output.log_every = log_every
        cfg.output.log_loss = str(root / f"{name}.csv")
        with _dispatch_log() as log:
            regional.stylize_regional(
                content_path, style_paths, mask_paths, cfg,
            )
        return log

    medians, rounds = _interleaved(
        "regional log_every",
        lambda mode: run(40, int(mode), f"ab{mode}").ms_per_step(),
        rounds=AB_ROUNDS, modes=("1", "20"),
    )
    whole = {
        n: _profiled(lambda n=n: run(n, 20, f"p{n}"), 1)[0]
        for n in (20, 40)
    }
    device = (whole[40] - whole[20]) / 20
    return (
        f"dispatch regional step, graphed, 40 steps: ms/step with a CSV "
        f"row every step {medians['1']:.3f}, every 20 steps (dispatches of "
        f"20) {medians['20']:.3f} (median of {AB_ROUNDS} rounds, "
        f"interleaved; rounds {rounds}); device ms/step from the profiler "
        f"{device:.3f} (a 40-step run's {whole[40]:.3f} ms less a 20-step "
        f"run's {whole[20]:.3f}, over 20)"
    )


def _dispatch_pipelines_timed() -> list[str]:
    """The sweep's and the regional run's steps and the 1280x720
    sequence's frames/min, graphed against eager, rounds interleaved."""
    lines = []
    root = _work_dir("dispatch_timed")
    content_path = _save_png(root / "content.png", _images(SIZE, 20)[0])
    style_paths = [
        _save_png(root / f"s{i}.png", _images(SIZE, 21 + i)[0])
        for i in range(2)
    ]
    mask_paths = [
        _save_png(root / f"m{i}.png", m)
        for i, m in enumerate(_seam_masks(SIZE))
    ]

    def sweep_ms(mode):
        cfg = _config(STEPS, "cuda")
        cfg.output.output = str(root / f"sw_{mode}")
        result = blend_sweep.stylize_blend_sweep(
            content_path, style_paths, cfg, n_frames=3,
            sweep_steps=SWEEP_STEPS,
        )
        return statistics.mean(result.frame_seconds[1:]) / SWEEP_STEPS * 1e3

    def regional_ms(mode):
        cfg = _config(STEPS, "cuda")
        cfg.video.final_only = True
        cfg.output.plot_losses = False
        cfg.output.output = str(root / f"rg_{mode}")
        cfg.output.log_every = 1
        cfg.output.log_loss = str(root / f"rg_{mode}.csv")
        with _dispatch_log() as log:
            regional.stylize_regional(
                content_path, style_paths, mask_paths, cfg,
            )
        return log.ms_per_step()

    frames = root / "frames"
    frames.mkdir()
    h, w = SEQ_HW
    rng = np.random.default_rng(42)
    for i in range(2):
        _save_png(frames / f"f{i}.png",
                  rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
    params = load_pretrained_params(
        torch.device("cuda"), allow_random=True, seed=0,
    )
    seq_peaks: dict[str, int] = {}

    def frames_min(mode):
        cfg = _config(SEQ_STEPS, "cuda")
        before = None if mode in seq_peaks else _fresh_peak()
        result = sequence.stylize_sequence(
            frames, style_paths[0], cfg, root / f"sq_{mode}", params=params,
        )
        if before is not None:
            seq_peaks[mode] = torch.cuda.max_memory_allocated() - before
        return 60.0 / result.frame_seconds[1]

    real_gif = encode.GifFrameCollector
    encode.GifFrameCollector = _gif_in_memory
    try:
        for label, timed, unit in (
            ("sweep step (frames 1-2, a PNG each)", sweep_ms, "ms/step"),
            ("regional step (a CSV row a step)", regional_ms, "ms/step"),
            ("1280x720 sequence (frame 1 of 2, 10 steps)", frames_min,
             "frames/min"),
        ):
            medians, rounds = _interleaved(label, timed)
            extra = ""
            if unit == "ms/step":
                extra = "; " + _flops_line(
                    "graphed", SIZE, SIZE, medians["graphed"],
                )
            else:
                ms = 60e3 / medians["graphed"] / SEQ_STEPS
                extra = (
                    f"; the run's own peak bytes (first round) eager "
                    f"{seq_peaks['eager']}, graphed {seq_peaks['graphed']}; "
                    + _flops_line("graphed", h, w, ms)
                )
            lines.append(
                f"dispatch {label}: {unit} eager {medians['eager']:.3f}, "
                f"graphed {medians['graphed']:.3f} (median of "
                f"{DISPATCH_ROUNDS} rounds, interleaved; rounds {rounds})"
                + extra,
            )
    finally:
        encode.GifFrameCollector = real_gif
    return lines


def _dispatch_setup() -> str:
    """Time to the first step (a 1-step run, all set-up included) and
    the captures, graphed against eager, at 512 and for the 1024
    objective with its warm start (a capture per level)."""
    content, style = _images(SIZE, 0)
    big = _images(OBJECTIVE_SIZE, 1)[0]
    blend = [(_images(OBJECTIVE_SIZE, s)[0], w) for s, w in ((2, 0.7),
                                                             (3, 0.3))]
    runs = {
        "512": lambda: run_style_transfer(content, style, _config(1, "cuda")),
        "1024 objective": lambda: run_style_transfer(
            big, blend[0][0], _config(
                1, "cuda", tv_w=1e-2, lap_w=1e2,
                style_layer_weights=[1, 1, 0.5, 0.25, 0.25],
                preserve_color="luminance", coarse_steps=4,
            ), style_blend=blend,
        ),
    }
    parts = []
    for label, run in runs.items():
        got = {}
        for mode in ("eager", "graphed"):
            with _mode(mode), _dispatch_log() as log:
                (_, peak), seconds, _ = _counted_run(
                    lambda run=run: _own_peak(run),
                )
            got.setdefault(mode, []).append((
                seconds, peak, [round(s, 4) for s in log.captures],
            ))
        parts.append(
            f"{label}: time to first step s eager "
            f"{[round(g[0], 4) for g in got['eager']]}, graphed "
            f"{[round(g[0], 4) for g in got['graphed']]}; captures s "
            f"{[g[2] for g in got['graphed']]}; the run's own peak bytes "
            f"eager {got['eager'][-1][1]}, graphed {got['graphed'][-1][1]}",
        )
    return "dispatch set-up (a 1-step run of each): " + "; ".join(parts)


def _dispatch() -> tuple[int, int]:
    """The new dispatch phase: bit-equality, counters, times, set-up."""
    t0 = time.perf_counter()
    launches, _ = _dispatch_main_path()
    _dispatch_batch()
    _dispatch_pipelines()
    _dispatch_resume()
    _dispatch_counters()
    print(_dispatch_setup())
    for line in _dispatch_steady() + _dispatch_pipelines_timed():
        print(line)
    print(f"dispatch phase: {time.perf_counter() - t0:.1f} s")
    return launches


def _dispatch_ab(card: str) -> int:
    """``--dispatch-ab``: the two graphed A/Bs alone, then the card."""
    build.build_all()
    print(_dispatch_chunking())
    print(_regional_attribution())
    print(f"card: {card}")
    return 0


# ---- the precision tiers: the kernels' IEEE and TF32 modes, and the
# main path at each tier


def _few_ms(fn) -> float:
    """``_time_ms`` over ``MODE_REPS`` calls and one replay."""
    return _time_ms(fn, reps=MODE_REPS, replays=1)


def _tf32_on(fn):
    """``fn`` run with cuDNN's and cuBLAS's TF32 on (the library
    yardstick of the TF32 mode), the flags restored after each call."""
    def call():
        prev = (
            torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
        )
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return fn()
        finally:
            (
                torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32,
            ) = prev

    return call


def _library(mode: str, fn):
    return _tf32_on(fn) if mode == "tf32" else fn


def _mode_conv_sets() -> dict[str, list]:
    """Every conv shape set the script drives, by record key:
    ``(n, h, w, C_in, C_out, per step, of which fused)``."""
    h7, w7 = SEQ_HW
    side = WARM_SIDE // 2
    return {
        "512": [(1, hw, hw, ci, co, n, f) for hw, ci, co, n, f in CONV_SHAPES],
        "at_1024": [
            (1, 2 * hw, 2 * hw, ci, co, n, f)
            for hw, ci, co, n, f in CONV_SHAPES
        ],
        "n4_512": [
            (BATCH_STYLES, hw, hw, ci, co, n, f)
            for hw, ci, co, n, f in CONV_SHAPES
        ],
        "level_2048_first": [
            (1, side, side, ci, co, n, f)
            for _, ci, co, n, f in CONV_SHAPES[:2]
        ],
        "at_720p": [
            (1, h7 * hw // SIZE, w7 * hw // SIZE, ci, co, n, f)
            for hw, ci, co, n, f in CONV_SHAPES
        ],
    }


def _mode_gram_sets() -> dict[str, list]:
    """Every Gram shape set the script drives, by record key: ``(S, P,
    C)``; S > 1 is one batched launch."""
    h7, w7 = SEQ_HW
    side = WARM_SIDE // 2
    return {
        "512": [(1, p, c) for p, c in GRAM_SHAPES],
        "at_1024": [(1, 4 * p, c) for p, c in GRAM_SHAPES],
        "batched_s4_512": [(BATCH_STYLES, p, c) for p, c in GRAM_SHAPES],
        "level_2048_first": [(1, side * side, GRAM_SHAPES[0][1])],
        "at_720p": [
            (1, (h7 >> k) * (w7 >> k), c)
            for k, (_, c) in enumerate(GRAM_SHAPES)
        ],
    }


def _check_conv_modes(recs: dict) -> None:
    """The conv's IEEE and TF32 modes at every driven shape.

    Each kernel against its mode's plain version (``conv3x3_plain``:
    the fp32 conv; the fp32 conv of tf32-rounded operands): the forward
    with and without its ReLU and the masked input gradient, within
    1e-4 of the reference's largest magnitude; timed as the main path
    runs it (``count`` forwards, ``fused`` masked and the rest unmasked
    backwards a step) into ``recs[mode][key]``, beside the plain version
    and cuDNN (fp32; with TF32 on for the TF32 mode). The IEEE kernel
    also: at N > 1 each image's output and masked input gradient
    bit-equal to its launch alone, one line per 512x512 shape (forward
    and input gradient against the bound and cuDNN), and VGG19's stack
    at a 528x960 batch of 2 (check only, :func:`_check_ieee_528x960`).
    """
    gen = torch.Generator(device="cuda").manual_seed(21)
    for key, cases in _mode_conv_sets().items():
        for n, h, w, ci, co, count, fused in cases:
            def rand(*shape, scale=1.0):
                return torch.randn(shape, generator=gen, device="cuda") * scale

            x = rand(n, h, w, ci)
            w9 = rand(9, ci, co, scale=(2.0 / (9 * ci)) ** 0.5)
            b = rand(co, scale=0.1)
            g = rand(n, h, w, co)
            w9f = flip_stencil(w9)
            wk, wkf = pack_stencil(w9), pack_stencil(w9f)
            w_oihw, wf_oihw = (
                s.reshape(3, 3, *s.shape[1:]).permute(3, 2, 0, 1).contiguous()
                for s in (w9, w9f)
            )
            label = f"{key} {n}x{h}x{w} {ci}->{co}"
            pix = n * h * w
            flops = 2.0 * 9 * pix * ci * co
            nbytes = 4.0 * (pix * (ci + co) + 9 * ci * co)
            for mode in NEW_MODES:
                rec = recs[mode][key]
                st = conv3x3.mode_stencil(mode, w9, wk)
                stf = conv3x3.mode_stencil(mode, w9f, wkf)
                kern = partial(conv3x3.conv3x3_kernel, mode=mode)
                plain = partial(conv3x3.conv3x3_plain, mode=mode)
                for relu in (True, False):
                    rec.err(
                        kern(x, st, b, relu), plain(x, w9, b, relu),
                        f"{label} {mode} forward relu={relu}",
                    )
                out = kern(x, st, b, True)
                rec.err(
                    kern(g, stf, None, False, out),
                    plain(g, w9f, None, False, out),
                    f"{label} {mode} masked input gradient",
                )
                if n > 1:
                    _check_batch_invariant(x, g, st, stf, b, label, mode)
                fwd = tuple(map(_few_ms, (
                    partial(kern, x, st, b, True),
                    partial(plain, x, w9, b, True),
                    _library(mode, partial(
                        F.conv2d, x.permute(0, 3, 1, 2), w_oihw, b,
                        padding=1,
                    )),
                )))
                rec.add(count, *fwd, flops, nbytes + 4.0 * co)
                line = ""
                for n_bwd, mask, extra in (
                    (fused, out, 4.0 * pix * co), (count - fused, None, 0.0),
                ):
                    if not n_bwd:
                        continue
                    g_nchw = (
                        g if mask is None else torch.where(mask > 0, g, 0.0)
                    ).permute(0, 3, 1, 2)
                    bwd = tuple(map(_few_ms, (
                        partial(kern, g, stf, None, False, mask),
                        partial(plain, g, w9f, None, False, mask),
                        _library(mode, partial(
                            F.conv2d, g_nchw, wf_oihw, None, padding=1,
                        )),
                    )))
                    rec.add(n_bwd, *bwd, flops, nbytes + extra)
                    if mode == "ieee" and key == "512":
                        bound = _bound_ms(flops, nbytes + extra, FP32_FLOPS)
                        line += (
                            f" | bwd x{n_bwd} mask={mask is not None} "
                            f"kernel_ms {bwd[0]:.4f} cudnn_ms {bwd[2]:.4f} "
                            f"bound_ms {bound:.4f} ({bwd[0] / bound:.2f}x "
                            f"bound, {bwd[0] / bwd[2]:.2f}x cudnn)"
                        )
                if mode == "ieee" and key == "512":
                    bound = _bound_ms(flops, nbytes, FP32_FLOPS)
                    print(
                        f"conv ieee {label} x{count}: fwd kernel_ms "
                        f"{fwd[0]:.4f} cudnn_ms {fwd[2]:.4f} bound_ms "
                        f"{bound:.4f} ({fwd[0] / bound:.2f}x bound, "
                        f"{fwd[0] / fwd[2]:.2f}x cudnn){line}",
                    )
            del x, g, out, w9, w9f, wk, wkf
        gc.collect()
        torch.cuda.empty_cache()
    for mode in NEW_MODES:
        _check_528x960(recs[mode]["512"], gen, mode)


def _check_528x960(rec: Record, gen: torch.Generator, mode: str) -> None:
    """``mode``'s conv through VGG19's stack at a 528x960 coarse level
    (widths that are not powers of two), a batch of 2: against the
    mode's plain version and each image bit-equal to its launch
    alone."""
    h, w = NON_SQUARE
    kern = partial(conv3x3.conv3x3_kernel, mode=mode)
    plain = partial(conv3x3.conv3x3_plain, mode=mode)
    for hw, ci, co, _, _ in CONV_SHAPES:
        scale = SIZE // hw
        shape = (2, h // scale, w // scale)
        x = torch.randn((*shape, ci), generator=gen, device="cuda")
        g = torch.randn((*shape, co), generator=gen, device="cuda")
        w9 = torch.randn((9, ci, co), generator=gen, device="cuda") * (
            2.0 / (9 * ci)
        ) ** 0.5
        b = torch.randn((co,), generator=gen, device="cuda") * 0.1
        w9f = flip_stencil(w9)
        st = conv3x3.mode_stencil(mode, w9, pack_stencil(w9))
        stf = conv3x3.mode_stencil(mode, w9f, pack_stencil(w9f))
        label = f"528x960 batch {'x'.join(map(str, shape))} {ci}->{co}"
        for relu in (True, False):
            rec.err(
                kern(x, st, b, relu), plain(x, w9, b, relu),
                f"{label} {mode} forward relu={relu}",
            )
        out = kern(x, st, b, True)
        rec.err(
            kern(g, stf, None, False, out), plain(g, w9f, None, False, out),
            f"{label} {mode} masked input gradient",
        )
        _check_batch_invariant(x, g, st, stf, b, label, mode)
    print(
        f"conv {mode} 528x960 batch of 2, VGG19's stack: ok against the "
        "plain version, each image bit-equal to its launch alone",
    )


def _check_gram_modes(recs: dict) -> None:
    """The Gram's IEEE and TF32 modes at every driven shape.

    Raw and clamped Grams against the mode's plain version
    (``gram_plain``: the fp32 product; that of tf32-rounded operands),
    with and without an active clamp, the raw Gram bit-symmetric; a
    batched launch's images each against the plain Gram and bit-equal
    to the mode's single launch. Timed into ``recs[mode][key]`` beside
    the plain version and ``torch.mm`` / ``torch.bmm`` (fp32; TF32 on
    for the TF32 mode).
    """
    gen = torch.Generator(device="cuda").manual_seed(22)
    for key, cases in _mode_gram_sets().items():
        for s, p, c in cases:
            norm = float(p * c)
            spread = 1.0 + torch.arange(s, device="cuda")[:, None, None] / s
            for mode in NEW_MODES:
                rec = recs[mode][key]
                for scale in (1.0, (1e6 / p) ** 0.5):
                    f = torch.randn(
                        (s, p, c), generator=gen, device="cuda",
                    ) * (scale * spread)
                    raw_k, g_k = gram.gram_kernel_batched(f, CLAMP, norm, mode)
                    raw_p, g_p = gram.gram_plain_batched(f, CLAMP, norm, mode)
                    label = f"{key} S={s} ({p},{c}) {mode} scale {scale:.3g}"
                    for i in range(s):
                        rec.err(raw_k[i], raw_p[i], f"{label} image {i} raw")
                        rec.err(g_k[i], g_p[i], f"{label} image {i} G")
                        single, _ = gram.gram_kernel(
                            f[i].contiguous(), CLAMP, norm, mode,
                        )
                        if not (torch.equal(raw_k[i], raw_k[i].T)
                                and torch.equal(raw_k[i], single)):
                            msg = (
                                f"gram {label}: image {i} not symmetric or "
                                "not the single launch's"
                            )
                            raise AssertionError(msg)
                flat = f[0] if s == 1 else f
                if s == 1:
                    times = tuple(map(_few_ms, (
                        partial(gram.gram_kernel, flat, CLAMP, norm, mode),
                        partial(gram.gram_plain, flat, CLAMP, norm, mode),
                        _library(mode, partial(torch.mm, flat.T, flat)),
                    )))
                else:
                    times = tuple(map(_few_ms, (
                        partial(
                            gram.gram_kernel_batched, f, CLAMP, norm, mode,
                        ),
                        partial(
                            gram.gram_plain_batched, f, CLAMP, norm, mode,
                        ),
                        _library(mode, partial(torch.bmm, f.mT, f)),
                    )))
                rec.add(
                    1, *times, float(s * p * c * (c + 1)),
                    4.0 * s * (p * c + 2 * c * c),
                )
            del f
        gc.collect()
        torch.cuda.empty_cache()


def _mode_records() -> dict[str, dict[str, tuple[Record, dict]]]:
    """``{kernel: {mode: (512 record, {key: record})}}`` of the new
    modes' JSON entries."""
    out: dict[str, dict] = {"conv3x3": {}, "gram": {}}
    for name, replaces in (
        ("conv3x3", "ops/pallas_conv.py:63"),
        ("gram", "ops/pallas_gram.py:40"),
    ):
        for mode in NEW_MODES:
            source = (
                f"csrc/conv3x3_{mode}.cu" if name == "conv3x3"
                else f"csrc/{name}.cu"
            )
            keys = (
                _mode_conv_sets() if name == "conv3x3" else _mode_gram_sets()
            )
            main_rec, *extra = (
                Record(
                    f"{name}_{mode}", f"{PACKAGE}/{source}",
                    f"style_transfer_visualizer_tpu/{replaces}", mode,
                )
                for _ in keys
            )
            out[name][mode] = (main_rec, dict(zip(
                list(keys)[1:], extra, strict=True,
            )))
    return out


def _by_key(recs: dict, name: str, mode: str) -> dict[str, Record]:
    main_rec, extras = recs[name][mode]
    return {"512": main_rec, **extras}


def _check_modes(recs: dict) -> None:
    """Both kernels' new modes at every driven shape, with one line per
    kernel, mode and shape set; then the TF32 kernels' line per 512x512
    shape (:func:`_tf32_shape_lines`) and the IEEE Gram's per 512x512
    tap (:func:`_ieee_gram_shape_lines`)."""
    conv_recs = {m: _by_key(recs, "conv3x3", m) for m in NEW_MODES}
    gram_recs = {m: _by_key(recs, "gram", m) for m in NEW_MODES}
    for name, check, sets, by_mode in (
        ("conv3x3", _check_conv_modes, _mode_conv_sets(), conv_recs),
        ("gram", _check_gram_modes, _mode_gram_sets(), gram_recs),
    ):
        check(by_mode)
        for mode in NEW_MODES:
            for key in sets:
                e = by_mode[mode][key]
                print(
                    f"{name} {mode} {key}: ok against the mode's plain "
                    f"version, worst rel err {e.entry['max_rel_err']:.3g} "
                    f"(abs {e.entry['max_abs_err']:.3g}); ms/step kernel "
                    f"{e.entry['ms']:.4f} plain {e.entry['plain_ms']:.4f} "
                    f"library {e.entry['library_ms']:.4f} bound "
                    f"{e.bound_s * 1e3:.4f}",
                )
    for line in _tf32_shape_lines() + _ieee_gram_shape_lines():
        print(line)


def _tf32_shape_lines() -> list[str]:
    """One line per 512x512 shape of the TF32 conv (the forward, and the
    input gradient as the main path runs it: masked for a conv fused with
    its ReLU) and of the five TF32 Grams, alone and at S = 4 in one
    launch: kernel ms against the TF32 bound and cuDNN / ``torch.mm``
    (``torch.bmm``) with TF32 on, each from a graph of 5 calls replayed
    twice. Uses only the wrappers' public calls, so the
    same lines can be taken on an older tree (``--tf32-shapes``)."""
    gen = torch.Generator(device="cuda").manual_seed(24)
    kern = partial(conv3x3.conv3x3_kernel, mode="tf32")

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device="cuda") * scale

    lines = []
    for hw, ci, co, count, fused in CONV_SHAPES:
        x = rand(1, hw, hw, ci)
        w9 = rand(9, ci, co, scale=(2.0 / (9 * ci)) ** 0.5)
        b = rand(co, scale=0.1)
        g = rand(1, hw, hw, co)
        w9f = flip_stencil(w9)
        st = conv3x3.mode_stencil("tf32", w9, pack_stencil(w9))
        stf = conv3x3.mode_stencil("tf32", w9f, pack_stencil(w9f))
        w_oihw, wf_oihw = (
            t.reshape(3, 3, *t.shape[1:]).permute(3, 2, 0, 1).contiguous()
            for t in (w9, w9f)
        )
        out = kern(x, st, b, True)
        pix = hw * hw
        flops = 2.0 * 9 * pix * ci * co
        nbytes = 4.0 * (pix * (ci + co) + 9 * ci * co)
        runs = [(
            f"fwd x{count}", partial(kern, x, st, b, True),
            partial(F.conv2d, x.permute(0, 3, 1, 2), w_oihw, b, padding=1),
            4.0 * co,
        )]
        for n_bwd, mask, extra in (
            (fused, out, 4.0 * pix * co), (count - fused, None, 0.0),
        ):
            if n_bwd:
                gl = g if mask is None else torch.where(mask > 0, g, 0.0)
                runs.append((
                    f"bwd x{n_bwd} mask={mask is not None}",
                    partial(kern, g, stf, None, False, mask),
                    partial(F.conv2d, gl.permute(0, 3, 1, 2), wf_oihw, None,
                            padding=1),
                    extra,
                ))
        parts = []
        for what, fn, lib, extra in runs:
            k_ms, lib_ms = _time_ms(fn), _time_ms(_tf32_on(lib))
            bound = _bound_ms(flops, nbytes + extra, TF32_FLOPS)
            parts.append(
                f"{what} kernel_ms {k_ms:.4f} cudnn_ms {lib_ms:.4f} "
                f"bound_ms {bound:.4f} ({k_ms / bound:.2f}x bound, "
                f"{k_ms / lib_ms:.2f}x cudnn)",
            )
        lines.append(
            f"tf32 shape conv {SIZE} {hw}x{hw} {ci}->{co}: "
            + " | ".join(parts),
        )
    for p, c in GRAM_SHAPES:
        f = rand(p, c)
        k_ms = _time_ms(partial(gram.gram_kernel, f, CLAMP, float(p * c),
                                "tf32"))
        lib_ms = _time_ms(_tf32_on(partial(torch.mm, f.T, f)))
        bound = _bound_ms(
            float(p * c * (c + 1)), 4.0 * (p * c + 2 * c * c), TF32_FLOPS,
        )
        lines.append(
            f"tf32 shape gram {SIZE} ({p},{c}): kernel_ms {k_ms:.4f} "
            f"torch_mm_ms {lib_ms:.4f} bound_ms {bound:.4f} "
            f"({k_ms / bound:.2f}x bound, {k_ms / lib_ms:.2f}x torch.mm)",
        )
        f = rand(BATCH_STYLES, p, c)
        k_ms = _time_ms(partial(gram.gram_kernel_batched, f, CLAMP,
                                float(p * c), "tf32"))
        lib_ms = _time_ms(_tf32_on(partial(torch.bmm, f.mT, f)))
        lines.append(
            f"tf32 shape gram S={BATCH_STYLES} ({p},{c}): kernel_ms "
            f"{k_ms:.4f} torch_bmm_ms {lib_ms:.4f} bound_ms "
            f"{BATCH_STYLES * bound:.4f}",
        )
    return lines


def _tf32_tile_lines() -> list[str]:
    """The TF32 conv's two tile candidates at every 512x512 shape read
    through descriptors: 128-pixel tiles (``wm`` 1) against 256-pixel
    ones (``wm`` 2, each B box serving twice the pixels), forward and
    input gradient as the main path runs them, each forced through
    ``tf32_plan``'s ``wm``; kernel ms a step, graphs of 5 calls."""
    gen = torch.Generator(device="cuda").manual_seed(25)
    kern = partial(conv3x3.conv3x3_kernel, mode="tf32")
    chosen = conv3x3.tf32_plan
    lines = []
    totals = {1: 0.0, 2: 0.0, "plan": 0.0}
    for hw, ci, co, count, fused in CONV_SHAPES:
        x = torch.randn((1, hw, hw, ci), generator=gen, device="cuda")
        g = torch.randn((1, hw, hw, co), generator=gen, device="cuda")
        w9 = torch.randn((9, ci, co), generator=gen, device="cuda") * (
            2.0 / (9 * ci)
        ) ** 0.5
        b = torch.zeros(co, device="cuda")
        st = (pack_stencil(w9)[0],)
        stf = (pack_stencil(flip_stencil(w9))[0],)
        out = kern(x, st, b, True)
        calls = [(count, partial(kern, x, st, b, True), ci, co, False)]
        calls += [
            (n_bwd, partial(kern, g, stf, None, False, mask), co, ci,
             mask is not None)
            for n_bwd, mask in ((fused, out), (count - fused, None)) if n_bwd
        ]
        parts = []
        for wm in (1, 2, "plan"):
            ms = 0.0
            for n_call, fn, c_in, c_out, masked in calls:
                plan = chosen(1, hw, hw, c_in, c_out, masked,
                              build.sm_count(0))
                # Register fragments (the 32-wide layer) take 128 only.
                forced = wm != "plan" and plan.ss
                conv3x3.tf32_plan = (
                    partial(chosen, wm=wm) if forced else chosen
                )
                try:
                    ms += n_call * _time_ms(fn)
                finally:
                    conv3x3.tf32_plan = chosen
            totals[wm] += ms
            parts.append(f"{wm if wm == 'plan' else 128 * wm} {ms:.4f}")
        lines.append(
            f"tf32 tiles conv {SIZE} {hw}x{hw} {ci}->{co} ms/step by tile "
            "pixels: " + ", ".join(parts),
        )
    lines.append(
        "tf32 tiles conv 512 step: 128-pixel tiles "
        f"{totals[1]:.4f}, 256-pixel {totals[2]:.4f}, as planned "
        f"{totals['plan']:.4f} ms",
    )
    return lines


def _ieee_gram_shape_lines() -> list[str]:
    """One line per 512x512 Gram tap of the IEEE Gram, alone and at S =
    4 in one launch: kernel ms against ``torch.mm`` / ``torch.bmm`` in
    fp32 and the bound (the symmetric product's operations at the fp32
    rate, or the bytes), each from a graph of 5 calls replayed twice;
    then the sums over the five taps. Uses only the wrappers' public
    calls, so the same lines can be taken on an older tree
    (``--ieee-gram-shapes``)."""
    gen = torch.Generator(device="cuda").manual_seed(26)
    lines = []
    totals = {1: [0.0, 0.0, 0.0], BATCH_STYLES: [0.0, 0.0, 0.0]}
    for p, c in GRAM_SHAPES:
        for s in (1, BATCH_STYLES):
            f = torch.randn((s, p, c), generator=gen, device="cuda")
            norm = float(p * c)
            if s == 1:
                kern = partial(gram.gram_kernel, f[0], CLAMP, norm, "ieee")
                lib = partial(torch.mm, f[0].T, f[0])
                lib_name = "torch_mm_ms"
            else:
                kern = partial(gram.gram_kernel_batched, f, CLAMP, norm,
                               "ieee")
                lib = partial(torch.bmm, f.mT, f)
                lib_name = "torch_bmm_ms"
            k_ms, lib_ms = _time_ms(kern), _time_ms(lib)
            bound = _bound_ms(
                float(s * p * c * (c + 1)), 4.0 * s * (p * c + 2 * c * c),
                FP32_FLOPS,
            )
            for i, v in enumerate((k_ms, lib_ms, bound)):
                totals[s][i] += v
            lines.append(
                f"ieee shape gram S={s} ({p},{c}): kernel_ms {k_ms:.4f} "
                f"{lib_name} {lib_ms:.4f} bound_ms {bound:.4f} "
                f"({k_ms / bound:.2f}x bound, {k_ms / lib_ms:.2f}x library)",
            )
            del f
    for s, (k_ms, lib_ms, bound) in totals.items():
        lines.append(
            f"ieee shape gram S={s} five {SIZE} taps: kernel_ms {k_ms:.4f} "
            f"library_ms {lib_ms:.4f} bound_ms {bound:.4f} "
            f"({k_ms / bound:.2f}x bound, {k_ms / lib_ms:.2f}x library)",
        )
    return lines


def _ieee_gram_shapes_only(card: str) -> int:
    """``--ieee-gram-shapes``: build, then :func:`_ieee_gram_shape_lines`
    alone (a measurement, no check)."""
    print(f"card: {card}")
    build.build_all()
    for line in _ieee_gram_shape_lines():
        print(line)
    print(f"card: {card}")
    return 0


def _tf32_shapes_only(card: str) -> int:
    """``--tf32-shapes``: build, then :func:`_tf32_shape_lines` alone (a
    measurement, no check)."""
    print(f"card: {card}")
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {len(built)} kernels in {time.perf_counter() - t0:.1f} s")
    for line in _tf32_shape_lines():
        print(line)
    print(f"card: {card}")
    return 0


def _tf32_tiles_only(card: str) -> int:
    """``--tf32-tiles``: build, then :func:`_tf32_tile_lines` alone."""
    print(f"card: {card}")
    build.build_all()
    for line in _tf32_tile_lines():
        print(line)
    print(f"card: {card}")
    return 0


def _mixed_split() -> str:
    """What ``mixed`` moves to IEEE fp32 at 512x512, in each mode: the
    four forward convs of the first two blocks (indices 0, 2, 5, 7)
    and the five Grams' forwards, device ms of one step's calls."""
    gen = torch.Generator(device="cuda").manual_seed(23)
    ms = dict.fromkeys(MODES, 0.0)
    gram_ms = dict.fromkeys(MODES, 0.0)
    for hw, ci, co, _, fused in CONV_SHAPES[:4]:
        x = torch.randn((1, hw, hw, ci), generator=gen, device="cuda")
        w9 = torch.randn((9, ci, co), generator=gen, device="cuda") * (
            2.0 / (9 * ci)
        ) ** 0.5
        b = torch.zeros(co, device="cuda")
        wk = pack_stencil(w9)
        for mode in MODES:
            ms[mode] += _few_ms(partial(
                conv3x3.conv3x3_kernel, x,
                conv3x3.mode_stencil(mode, w9, wk), b, bool(fused),
                mode=mode,
            ))
    for p, c in GRAM_SHAPES:
        f = torch.randn((p, c), generator=gen, device="cuda")
        for mode in MODES:
            gram_ms[mode] += _few_ms(
                partial(gram.gram_kernel, f, CLAMP, float(p * c), mode),
            )
    cost = ms["ieee"] - ms["tf32x3"] + gram_ms["ieee"] - gram_ms["tf32x3"]
    return (
        f"mixed's IEEE share at {SIZE}x{SIZE} (device ms of a step's "
        f"calls): forward convs 0, 2, 5, 7 ieee {ms['ieee']:.4f} tf32x3 "
        f"{ms['tf32x3']:.4f} tf32 {ms['tf32']:.4f}; the five Grams ieee "
        f"{gram_ms['ieee']:.4f} tf32x3 {gram_ms['tf32x3']:.4f} tf32 "
        f"{gram_ms['tf32']:.4f}; mixed over high by these alone "
        f"{cost:+.4f} ms/step"
    )


def _policy_launches(arch, opt, tier: str) -> dict[str, dict[str, int]]:
    """Each kernel's launches by mode of a single-style run with no warm
    start (the main path), from the tier's policy.

    The style targets' sweep to the deepest style tap and the content
    sweep to the deepest content tap run each conv's forward at its
    level; every step runs each conv to the deepest tap forward and
    backward at their levels, and the five Grams' forwards at the
    Gram's (its backward is a product outside the kernel).
    """
    prec = resolve_precision(tier)
    conv = dict.fromkeys(MODES, 0)
    gram_n = dict.fromkeys(MODES, 0)
    last_style = max(opt.style_layers)
    last_content = max(opt.content_layers)
    last = max(last_style, last_content)
    for idx in arch.conv_indices:
        fwd = kernel_mode(conv_precision(prec, idx))
        conv[fwd] += (idx <= last_style) + (idx <= last_content)
        if idx <= last:
            conv[fwd] += opt.steps
            conv[kernel_mode(conv_bwd_precision(prec, idx))] += opt.steps
    gram_n[kernel_mode(gram_precision(prec))] += (
        len(opt.style_layers) * (1 + opt.steps)
    )
    return {"conv3x3": conv, "gram": gram_n}


def _tier_config(tier: str, steps: int = STEPS, device: str = "cuda",
                 **opt):
    config = _config(steps, device, **opt)
    config.hardware.precision = tier
    return config


def _tiers() -> list[str]:
    """The 512x512 main path at each tier through ``run_style_transfer``.

    Per tier: losses finite and decreasing, launches by kernel and mode
    counted on the device equal to what the tier's policy implies,
    graphed ms/step (the run's dispatch events), the device's busy
    share (the profiler's device ms of 5 graphed steps of the same
    step, prepared, over that), the run's own peak memory. At
    ``default`` and ``highest`` the graphed run is also held bit-equal
    to the eager loop (image and every step's losses).
    """
    content, style = _images(SIZE, 0)
    lines = []
    for tier in TIERS:
        config = _tier_config(tier)
        before = _fresh_peak()
        with _dispatch_log() as log:
            (image, history), t_run, launches = _counted_run(
                lambda config=config: run_style_transfer(
                    content, style, config,
                ),
            )
        peak = torch.cuda.max_memory_allocated() - before
        by_mode = {
            "conv3x3": conv3x3.launches.launched_by_mode(),
            "gram": gram.launches.launched_by_mode(),
        }
        TIER_LAUNCHES[tier] = by_mode
        losses = history["total_loss"]
        _check_run(
            f"tier {tier}", image, losses, launches,
            _launches_wanted(VGG19, config.optimization, SIZE, 1), SIZE,
        )
        want = _policy_launches(VGG19, config.optimization, tier)
        if by_mode != want:
            msg = f"tier {tier}: launches by mode {by_mode}, policy {want}"
            raise AssertionError(msg)
        ms_step = log.ms_per_step()
        bundle, start = prepare_model_and_input(
            content, style, _tier_config(tier),
        )
        holder = {"image": start, "state": bundle.opt_state}
        _runner_ms(bundle, holder, _tier_config(tier), 1)
        device_ms, _, _ = _profiled_steps(bundle, holder, "graphed")
        del bundle, holder
        equal = ""
        if tier in ("default", "highest"):
            with _eager_dispatch():
                e_image, e_history = run_style_transfer(
                    content, style, _tier_config(tier),
                )
            _same_tensor(f"tier {tier} graphed vs eager", image, e_image)
            _same_history(f"tier {tier} graphed vs eager", history, e_history)
            equal = "; graphed bit-equal to eager (image, every step's losses)"
        lines.append(
            f"tier {tier} {SIZE}x{SIZE} main path {STEPS} steps: loss "
            f"{losses[0]:.6g} -> {losses[-1]:.6g}; graphed ms/step "
            f"{ms_step:.3f}; device ms/step {device_ms:.3f}, busy share "
            f"{device_ms / ms_step:.3f}; the run's own peak {peak}; run s "
            f"{t_run:.3f}; launches by mode on the device {by_mode}, as "
            f"the policy implies{equal}",
        )
        gc.collect()
    return lines


def _tier_curves() -> list[str]:
    """Adam (lr 0.05) at 64x64 from the content, 20 steps, at each tier
    on the card against the CPU (fp32 at every tier): every step's loss
    within 1e-3 relative at ``highest``, ``mixed`` and ``high``; at
    ``default`` (TF32) the deviation is printed, not gated. First the
    control: the CPU run against the CPU run from the content perturbed
    by 1e-7 relative, at lr 0.05 and 0.1 (printed)."""
    content, style = _images(64, 1)
    perturbed = (content * (
        1 + 1e-7 * np.random.default_rng(9).standard_normal(content.shape)
    )).astype(np.float32)

    def curve(device: str, tier: str, lr: float = GATE_LR,
              start: np.ndarray = content) -> np.ndarray:
        config = _tier_config(
            tier, GATE_STEPS, device, init_method="content",
            optimizer="adam", lr=lr,
        )
        return np.asarray(run_style_transfer(start, style, config)[1][
            "total_loss"
        ])

    def worst(a: np.ndarray, ref: np.ndarray) -> float:
        return float((np.abs(a - ref) / np.abs(ref)).max())

    cpu = curve("cpu", "mixed")
    controls = {
        lr: worst(
            curve("cpu", "mixed", lr, perturbed),
            cpu if lr == GATE_LR else curve("cpu", "mixed", lr),
        )
        for lr in CONTROL_LRS
    }
    lines = [
        f"curve gate control: Adam 64x64 {GATE_STEPS} steps on the CPU "
        "against the same from the content perturbed by 1e-7 relative, "
        "worst rel diff "
        + ", ".join(f"lr {lr} {v:.3g}" for lr, v in controls.items()),
    ]
    for tier in TIERS:
        rel = np.abs(curve("cuda", tier) - cpu) / np.abs(cpu)
        gated = tier != "default"
        if gated and not float(rel.max()) <= GATE_TOL:
            msg = (
                f"tier {tier}: Adam curve off the CPU's by {rel.max():.3g} "
                f"> {GATE_TOL} at step {int(rel.argmax()) + 1}"
            )
            raise AssertionError(msg)
        lines.append(
            f"curve gate tier {tier}: Adam lr {GATE_LR} 64x64 {GATE_STEPS} "
            f"steps, card vs CPU worst rel diff {rel.max():.3g} at step "
            f"{int(rel.argmax()) + 1}"
            + (f" (gate {GATE_TOL})" if gated else " (printed, not gated)"),
        )
    return lines


def _precision() -> tuple[int, int]:
    """The tiers' phase: the main path at each tier, the curve gate,
    and what ``mixed`` moves to IEEE; returns the launches at the
    shipped tier (``mixed``, the main path's)."""
    for line in (*_tiers(), *_tier_curves(), _mixed_split()):
        print(line)
    mixed = TIER_LAUNCHES["mixed"]
    return (sum(mixed["conv3x3"].values()), sum(mixed["gram"].values()))


def _mode_key_records(
    mode: str, conv_extra: dict, gram_extra: dict, mode_recs: dict, key: str,
) -> tuple[Record, Record]:
    """The conv's and the Gram's record of shape set ``key`` in
    ``mode``: the 3xTF32 entries' own, else a new one among the mode's
    entry's extras."""
    if mode == "tf32x3":
        return conv_extra[key], gram_extra[key]
    return tuple(
        mode_recs[name][mode][1].setdefault(key, Record(
            f"{name}_{mode}", mode_recs[name][mode][0].entry["source"],
            mode_recs[name][mode][0].entry["replaces"], mode,
        ))
        for name in ("conv3x3", "gram")
    )


def _mode_entries(recs: dict) -> list[dict]:
    """The new modes' JSON entries. ``launches``: the mode's count on
    the main path at the shipped tier (``mixed``), or, for a mode that
    tier does not run, at the tier that runs it everywhere;
    ``launches_by_tier`` every tier's."""
    uniform = {"ieee": "highest", "tf32": "default"}
    out = []
    for name in ("conv3x3", "gram"):
        for mode in NEW_MODES:
            main_rec, extras = recs[name][mode]
            by_tier = {t: TIER_LAUNCHES[t][name][mode] for t in TIERS}
            tier = "mixed" if by_tier["mixed"] else uniform[mode]
            entry = main_rec.finish({"main path": by_tier[tier]}, extras)
            entry["launches_tier"] = tier
            entry["launches_by_tier"] = by_tier
            del entry["launches_by_phase"]
            out.append(entry)
    return out


def _build_phase() -> None:
    """Build every kernel (one nvcc each, in parallel) and print, per
    library, its ``HGMMA`` count and ptxas's registers and spills; the
    tensor-core libraries must hold ``wgmma``, the IEEE conv and the
    IEEE Gram kernel none (nor ``HMMA``), and neither the IEEE kernels
    nor the TF32 kernels spill (:func:`_check_ieee_build`,
    :func:`_check_ieee_gram_build`, :func:`_check_tf32_build`); the
    ring's kernels spill nothing and its products run ``mma.sync``
    (:func:`_check_lbfgs_ring_build`)."""
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"build: {len(built)} kernels in {time.perf_counter() - t0:.1f} s")
    for kernel in built:
        sass = _sass(kernel.library)
        hgmma = None if sass is None else sass.count("HGMMA")
        print(f"  {kernel.name}: HGMMA instructions in SASS: {hgmma}")
        # The IEEE conv runs on the CUDA cores; the ring's products use
        # mma.sync; the other libraries hold wgmma kernels.
        if kernel.name == "conv3x3_ieee":
            _check_ieee_build(kernel, sass)
        elif kernel.name == "lbfgs_ring":
            _check_lbfgs_ring_build(kernel, sass)
        elif hgmma == 0:
            msg = f"{kernel.name}: no wgmma (HGMMA) in the built library"
            raise AssertionError(msg)
        if kernel.name in ("conv3x3_tf32", "gram"):
            _check_tf32_build(kernel, hgmma)
        if kernel.name == "gram":
            _check_ieee_gram_build(kernel, sass)
        for line in kernel.ptxas_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {kernel.name}: {line.strip()}")


def _modes_only(card: str) -> int:
    """``--modes``: build, both kernels' new modes at every driven
    shape against their plain versions, and what ``mixed`` moves to
    IEEE fp32 (a check and a measurement, nothing else)."""
    print(f"card: {card}")
    _build_phase()
    recs = _mode_records()
    _check_modes(recs)
    print(_mixed_split())
    print(f"card: {card}")
    return 0


def _spatial_only(card: str, *, share_card: bool = True) -> int:
    """``--spatial``: build, the spatial phase and its kernel check;
    ``--spatial-cards`` the phase with NCCL, one card a rank (a machine
    with 4 cards)."""
    print(f"card: {card}")
    _build_phase()
    t0 = time.perf_counter()
    _spatial(share_card)
    if not share_card:
        print(f"phase seconds: spatial {time.perf_counter() - t0:.1f}")
        print(f"card: {card}")
        return 0
    recs = {
        mode: {
            key.removeprefix("spatial_"): tuple(
                Record(name, "", "", mode) for name in ("conv3x3", "gram")
            )
            for key in SPATIAL_KEYS
        }
        for mode in MODES
    }
    t1 = time.perf_counter()
    _check_spatial_kernels(recs)
    print(
        f"phase seconds: spatial {t1 - t0:.1f}, spatial kernels "
        f"{time.perf_counter() - t1:.1f}",
    )
    for mode, by_key in recs.items():
        for key, (conv_rec, gram_rec) in by_key.items():
            for rec in (conv_rec, gram_rec):
                entry = rec.finish({"main path": 0}, {})
                print(
                    f"spatial {key} {entry['name']} {mode}: ms "
                    f"{entry['ms']:.4f} plain_ms {entry['plain_ms']:.4f} "
                    f"library_ms {entry['library_ms']:.4f} bound_ms "
                    f"{entry['bound_ms']:.4f} ({entry['bound_by']}) "
                    f"max_rel_err {entry['max_rel_err']:.3g}",
                )
    print(f"card: {card}")
    return 0


def _batch_cards_only(card: str, *, share_card: bool = True) -> int:
    """``--batch-mesh``: build, the batch-over-cards phase on this one
    card and its kernel check; ``--batch-cards`` the phase with NCCL,
    one card a rank (a machine with 4 cards), and its rates."""
    print(f"card: {card}")
    _build_phase()
    t0 = time.perf_counter()
    _batch_cards(share_card)
    if not share_card:
        print(f"phase seconds: batch cards {time.perf_counter() - t0:.1f}")
        print(f"card: {card}")
        return 0
    recs = {
        mode: tuple(
            Record(name, "", "", mode) for name in ("conv3x3", "gram")
        )
        for mode in MODES
    }
    t1 = time.perf_counter()
    _check_batch_card_kernels(recs)
    print(
        f"phase seconds: batch cards {t1 - t0:.1f}, batch cards kernels "
        f"{time.perf_counter() - t1:.1f}",
    )
    for mode, (conv_rec, gram_rec) in recs.items():
        for rec in (conv_rec, gram_rec):
            entry = rec.finish({"main path": 0}, {})
            print(
                f"{BATCH_CARD_KEY} {entry['name']} {mode}: ms "
                f"{entry['ms']:.4f} plain_ms {entry['plain_ms']:.4f} "
                f"library_ms {entry['library_ms']:.4f} bound_ms "
                f"{entry['bound_ms']:.4f} ({entry['bound_by']}) "
                f"max_rel_err {entry['max_rel_err']:.3g}",
            )
    print(f"card: {card}")
    return 0


def main(argv: list[str] | None = None) -> int:
    """Run every phase; return 0 when all pass (failures raise).

    ``--dispatch-ab`` runs only ``steps_per_dispatch`` 1 against 0 and
    the regional CSV A/B (a measurement, not a check).
    """
    if not torch.cuda.is_available():
        print("no CUDA device: chip_smoke.py needs a GPU", file=sys.stderr)
        return 2
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    card = _card()
    args = argv if argv is not None else sys.argv[1:]
    if args == ["--dispatch-ab"]:
        return _dispatch_ab(card)
    if args == ["--modes"]:
        return _modes_only(card)
    if args == ["--tf32-shapes"]:
        return _tf32_shapes_only(card)
    if args == ["--tf32-tiles"]:
        return _tf32_tiles_only(card)
    if args == ["--ieee-gram-shapes"]:
        return _ieee_gram_shapes_only(card)
    if args == ["--spatial"]:
        return _spatial_only(card)
    if args == ["--spatial-cards"]:
        return _spatial_only(card, share_card=False)
    if args == ["--batch-mesh"]:
        return _batch_cards_only(card)
    if args == ["--batch-cards"]:
        return _batch_cards_only(card, share_card=False)
    if args == ["--lbfgs-ring"]:
        return _lbfgs_ring_only(card)
    print(f"card: {card}")
    start = time.perf_counter()
    seconds: dict[str, float] = {}

    def timed(name: str, phase, *args):
        t = time.perf_counter()
        out = phase(*args)
        seconds[name] = round(time.perf_counter() - t, 1)
        return out

    _build_phase()

    records = {}
    for name, source, replaces, batch_key in (
        ("conv3x3", "csrc/conv3x3.cu", "ops/pallas_conv.py:63", "n4_512"),
        ("gram", "csrc/gram.cu", "ops/pallas_gram.py:40", "batched_s4_512"),
    ):
        main_rec, *extra = (
            Record(
                name, f"{PACKAGE}/{source}",
                f"style_transfer_visualizer_tpu/{replaces}",
            )
            for _ in range(9)
        )
        records[name] = (main_rec, dict(zip(
            ("at_1024", batch_key, "level_2048_first", "at_720p",
             "band_4k_first", *SPATIAL_KEYS, BATCH_CARD_KEY), extra,
            strict=True,
        )))
    conv_rec, conv_extra = records["conv3x3"]
    gram_rec, gram_extra = records["gram"]
    timed("kernel checks", _check_conv, conv_rec, _conv_cases(
        conv_rec, conv_extra["at_1024"], conv_extra["n4_512"],
    ))
    _vgg16_shapes_covered()
    timed(
        "gram checks", _check_gram,
        gram_rec, gram_extra["at_1024"], gram_extra["batched_s4_512"],
    )
    mode_recs = _mode_records()
    timed("mode checks", _check_modes, mode_recs)
    band_recs = {"tf32x3": (
        conv_extra["band_4k_first"], gram_extra["band_4k_first"],
    )}
    for mode in NEW_MODES:
        band_recs[mode] = tuple(
            mode_recs[name][mode][1].setdefault("band_4k_first", Record(
                f"{name}_{mode}", mode_recs[name][mode][0].entry["source"],
                mode_recs[name][mode][0].entry["replaces"], mode,
            ))
            for name in ("conv3x3", "gram")
        )
    timed("band kernels", _check_band_kernels, band_recs)
    spatial_recs = {
        mode: {
            key.removeprefix("spatial_"): tuple(
                (conv_extra, gram_extra)[i][key] if mode == "tf32x3"
                else mode_recs[name][mode][1].setdefault(key, Record(
                    f"{name}_{mode}",
                    mode_recs[name][mode][0].entry["source"],
                    mode_recs[name][mode][0].entry["replaces"], mode,
                ))
                for i, name in enumerate(("conv3x3", "gram"))
            )
            for key in SPATIAL_KEYS
        }
        for mode in MODES
    }
    batch_card_recs = {
        mode: _mode_key_records(
            mode, conv_extra, gram_extra, mode_recs, BATCH_CARD_KEY,
        )
        for mode in MODES
    }
    phases = {}
    for name, phase, *args in (
        ("main path", _main_path),
        ("precision", _precision),
        ("timelapse", _timelapse),
        ("objective", _objective),
        ("adam vgg16", _adam_vgg16),
        ("batch", _batch),
        ("resume", _resume_single),
        ("resume batch", _resume_batch),
        ("warm start 4 MP", _warm_start_4mp),
        ("banded 4K", _banded_4k),
        ("banded 8K", _banded_8k),
        ("remat", _remat),
        ("spatial", _spatial),
        ("batch cards", _batch_cards),
        ("sweep", _sweep),
        ("regional", _regional, gram_rec),
        ("sequence", _sequence),
        ("dispatch", _dispatch),
    ):
        phases[name] = timed(name, phase, *args)
        if name == "spatial":
            timed("spatial kernels", _check_spatial_kernels, spatial_recs)
        if name == "batch cards":
            timed(
                "batch cards kernels", _check_batch_card_kernels,
                batch_card_recs,
            )
        if name == "warm start 4 MP":
            timed(
                "level kernels", _check_level_kernels,
                conv_rec, conv_extra["level_2048_first"],
                gram_rec, gram_extra["level_2048_first"],
            )
    timed(
        "720p kernels", _check_720p_kernels,
        conv_rec, conv_extra["at_720p"], gram_rec, gram_extra["at_720p"],
    )
    ring_entries = timed("lbfgs ring kernels", _check_lbfgs_ring)
    timed("small references", lambda: (
        _small_reference(), _small_batch_reference(),
        _small_pipeline_reference(),
    ))
    print(
        "phase seconds: "
        + ", ".join(f"{k} {v}" for k, v in seconds.items())
        + f"; whole script after the card query "
        f"{time.perf_counter() - start:.1f} s",
    )

    kernels = [
        rec.finish({k: v[i] for k, v in phases.items()}, extras)
        for i, (rec, extras) in enumerate(records.values())
    ]
    # The 3xTF32 entries' launches: that mode's on the main path at the
    # shipped tier, or at "high" where "mixed" runs none (the Gram).
    for name, entry in zip(records, kernels, strict=True):
        by_tier = {t: TIER_LAUNCHES[t][name]["tf32x3"] for t in TIERS}
        entry["launches_tier"] = "mixed" if by_tier["mixed"] else "high"
        entry["launches"] = by_tier[entry["launches_tier"]]
        entry["launches_by_tier"] = by_tier
    kernels += _mode_entries(mode_recs)
    kernels += ring_entries
    print(json.dumps({"kernels": kernels}))
    print(f"card: {card}")
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
